"""The port's SSD intra-chunk block (``kernels/ref.py::ssd_chunk``, the
plain version of the B7 kernel, and ``ops.SSDChunk`` around it) against
the JAX package: its Pallas kernel ``ssd_chunk_pallas`` in interpret mode
(in the kernel's folded ``(BC, H, q, .)`` layout) and its jnp
``models/mamba2.py::ssd_chunked`` plus the skip term, forward and
``jax.vjp``.  Inputs come from numpy seeds.

Tolerances, fp32: outputs within 1e-5 of the largest entry (the same
products summed in other orders); gradients within 1e-5 of each one's
largest entry on inputs where the JAX gradient is finite.  A float64
``gradcheck`` holds the plain backward to finite differences on inputs
whose decay ``exp(cums_i - cums_j)`` overflows fp32 above the diagonal,
where the JAX formula's backward gives NaN.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_chunk import ssd_chunk_pallas
from repro.models import mamba2 as JM
from repro_torch.kernels import ops, ref
from repro_torch.models import mamba2 as TM
from test_torch_attention import _share_of_bound

BT, S, H, P, N = 2, 32, 4, 8, 16


def _inputs(seed, groups):
    """xs (Bt, S, H, P), b / c (Bt, S, G, N), dt (Bt, S, H), a (H,) < 0,
    d_skip (H,), as numpy fp32: dt = softplus(normal), a = -exp(linspace(
    -1, 1)), the JAX kernel test's draws."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    dt = np.logaddexp(f(BT, S, H), 0).astype(np.float32)
    a = -np.exp(np.linspace(-1, 1, H)).astype(np.float32)
    return dict(xs=f(BT, S, H, P), b=f(BT, S, groups, N) * 0.5,
                c=f(BT, S, groups, N) * 0.5, dt=dt, a=a,
                d_skip=1.0 + 0.1 * f(H))


def _jax_y(xs, b, c, dt, a, d_skip, chunk):
    """The JAX model's path: groups expanded to heads, ssd_chunked, skip."""
    h = xs.shape[2]
    y, _ = JM.ssd_chunked(xs, JM._expand_groups(b, h, b.shape[2]),
                          JM._expand_groups(c, h, c.shape[2]), dt, a, chunk)
    return y + d_skip[None, None, :, None] * xs


def _cums_and_states(xs, b, c, dt, a, chunk):
    """cums (Bt, S, H) and h_in (Bt, nc, H, N, P) as the JAX model forms
    them (its cumsum, per-chunk states and lax.scan), numpy."""
    bt, s, h, p = xs.shape
    n = b.shape[-1]
    nc = s // chunk
    bh = JM._expand_groups(jnp.asarray(b), h, b.shape[2])
    r = lambda t, *tail: jnp.reshape(t, (bt, nc, chunk) + tail)
    cums = jnp.cumsum(r(dt * a[None, None, :], h), axis=2)
    bx = r(bh, h, n) * r(dt, h)[..., None]
    s_chunk = jnp.einsum("zcqh,zcqhn,zcqhp->zchnp",
                         jnp.exp(cums[:, :, -1:, :] - cums), bx, r(xs, h, p))

    def body(state, inp):
        s_c, dec = inp
        return state * dec[:, :, None, None] + s_c, state

    _, h_in = jax.lax.scan(body, jnp.zeros((bt, h, n, p)),
                           (jnp.moveaxis(s_chunk, 1, 0),
                            jnp.moveaxis(jnp.exp(cums[:, :, -1, :]), 1, 0)))
    return (np.asarray(cums.reshape(bt, s, h)),
            np.asarray(jnp.moveaxis(h_in, 0, 1)))


def _close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("groups", [1, 2])
def test_ref_ssd_chunk_matches_pallas_interpret(chunk, groups):
    """ref.ssd_chunk against ssd_chunk_pallas (interpret mode) on the same
    cums and h_in, folded to the kernel's (BC, H, q, .) layout with the
    groups expanded to heads."""
    d = _inputs(chunk + groups, groups)
    cums, h_in = _cums_and_states(d["xs"], d["b"], d["c"], d["dt"], d["a"],
                                  chunk)
    got = ref.ssd_chunk(*(torch.tensor(v) for v in (
        d["xs"], d["b"], d["c"], d["dt"], cums, h_in, d["d_skip"])))
    nc = S // chunk
    fold = lambda t, tail: np.moveaxis(
        t.reshape((BT, nc, chunk, H) + tail), 3, 2).reshape(
        (BT * nc, H, chunk) + tail)
    heads = lambda t: np.repeat(t, H // groups, axis=2)
    y = ssd_chunk_pallas(fold(d["xs"], (P,)), fold(heads(d["b"]), (N,)),
                         fold(heads(d["c"]), (N,)), fold(d["dt"], ()),
                         fold(cums, ()), h_in.reshape(BT * nc, H, N, P),
                         d["d_skip"], interpret=True)
    want = np.moveaxis(np.asarray(y).reshape(BT, nc, H, chunk, P), 2,
                       3).reshape(BT, S, H, P)
    _close(got.numpy(), want, 1e-5, "ref.ssd_chunk vs ssd_chunk_pallas")


@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_chunked_and_grads_match_jax(chunk, groups):
    """The port's ssd_chunked (cumsum, states and scan in torch, the block
    through ops.SSDChunk) against JAX's ssd_chunked plus the skip: y, the
    final state (Bt, H, P, N) that serving caches, and the gradients of
    <y, dY> in all six inputs against jax.vjp."""
    d = _inputs(10 + chunk + groups, groups)
    dy = np.random.default_rng(99).standard_normal(
        (BT, S, H, P)).astype(np.float32)
    names = ("xs", "b", "c", "dt", "a", "d_skip")
    want, vjp = jax.vjp(jax.jit(lambda *t: _jax_y(*t, chunk)),
                        *(jnp.asarray(d[k]) for k in names))
    jgrads = vjp(jnp.asarray(dy))
    ins = [torch.tensor(d[k], requires_grad=True) for k in names]
    got, state = TM.ssd_chunked(*ins[:5], ins[5], chunk)
    _close(got.detach().numpy(), want, 1e-5, "ssd_chunked y")
    h = d["xs"].shape[2]
    _, jstate = JM.ssd_chunked(
        *(jnp.asarray(d[k]) for k in ("xs",)),
        JM._expand_groups(jnp.asarray(d["b"]), h, groups),
        JM._expand_groups(jnp.asarray(d["c"]), h, groups),
        jnp.asarray(d["dt"]), jnp.asarray(d["a"]), chunk)
    _close(state.detach().numpy(), jstate, 1e-5, "ssd_chunked final state")
    grads = torch.autograd.grad(got, ins, torch.tensor(dy))
    for k, g, jg in zip(names, grads, jgrads):
        assert np.isfinite(np.asarray(jg)).all(), k
        _close(g.numpy(), jg, 1e-5, f"d{k}")


def _overflowing_inputs(dtype, groups=2):
    """Tiny inputs whose exp(cums_i - cums_j) above the diagonal exceeds
    the fp32 range (differences up to ~600; below fp64's 709)."""
    rng = np.random.default_rng(7)
    bt, s, h, p, n, q = 1, 8, 2, 3, 2, 4
    t = lambda *sh: torch.tensor(rng.standard_normal(sh), dtype=dtype)
    dt = torch.nn.functional.softplus(t(bt, s, h)) + 1.0
    a = -torch.tensor([60.0, 80.0], dtype=dtype)
    cums = torch.cumsum((dt * a).reshape(bt, s // q, q, h), 2)
    return [t(bt, s, h, p), t(bt, s, groups, n), t(bt, s, groups, n), dt,
            cums.reshape(bt, s, h), t(bt, s // q, h, n, p) * 0.1,
            t(h)]


def test_ssd_chunk_gradcheck_where_the_decay_overflows():
    """float64 gradcheck of ops.SSDChunk on the CPU (the plain forward and
    backward) at inputs whose masked-away decays overflow fp32; its fp32
    gradients stay finite, where a copy of the JAX formula (exp, then
    where) gives NaN."""
    ins = [x.requires_grad_(True) for x in _overflowing_inputs(torch.float64)]
    diff = ins[4].detach().reshape(1, 2, 4, 2)
    assert float((diff[:, :, None, :, :] - diff[:, :, :, None, :]).max()) \
        > 88.8  # log of the fp32 max
    assert torch.autograd.gradcheck(ops.SSDChunk.apply, ins, eps=1e-6,
                                    atol=1e-6, rtol=1e-5)
    ins32 = [x.float().requires_grad_(True)
             for x in _overflowing_inputs(torch.float64)]
    y = ops.SSDChunk.apply(*ins32)
    grads = torch.autograd.grad(y.sum(), ins32)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    # the JAX formula in fp32: exp of every difference, then the mask
    cums = ins32[4].reshape(1, 2, 4, 2)
    diff = cums[:, :, :, None, :] - cums[:, :, None, :, :]
    tri = torch.tril(torch.ones(4, 4, dtype=torch.bool))[None, None, :, :,
                                                         None]
    ldec = torch.where(tri, torch.exp(diff), torch.zeros(()))
    (g_cums,) = torch.autograd.grad(ldec.sum(), ins32[4])
    assert not bool(torch.isfinite(g_cums).all())


def test_ssd_chunk_refuses_bad_shapes_and_devices():
    ins = _overflowing_inputs(torch.float32)
    with pytest.raises(ValueError, match="expected x"):
        ref.ssd_chunk(ins[0][:, :7], *ins[1:])
    with pytest.raises(ValueError, match="device"):
        ops.ssd_chunk_fwd(*(t.to("meta") for t in ins))


def _hl(t: torch.Tensor):
    """fp32 ``t`` as hi = bf16(t) and lo = bf16(t - hi), both fp32."""
    hi = t.bfloat16().float()
    return hi, (t - hi).bfloat16().float()


def _prod(eq, a, b, split_a, split_b):
    """einsum(eq, a, b) as the bf16 kernels run it: each operand split into
    hi + lo where ``split_*`` (else it enters as bf16, which the caller
    makes exact), the products hi.hi + hi.lo + lo.hi (lo.lo dropped), each
    summed in fp32.  A lo that is all zero adds nothing, as the kernels
    skip it."""
    ah, al = _hl(a) if split_a else (a, None)
    bh, bl = _hl(b) if split_b else (b, None)
    out = torch.einsum(eq, ah, bh)
    if bl is not None:
        out = out + torch.einsum(eq, ah, bl)
    if al is not None:
        out = out + torch.einsum(eq, al, bh)
    return out


def _emulated_bf16_ssd(x, b, c, dt, cums, h_in, d_skip, dy, split=True):
    """The arithmetic of ``csrc/ssd_chunk.cu``'s bf16 (wgmma) kernels, in
    torch on the CPU: C B^T as fp32 sums of exact bf16 products with dt
    applied after, and every product with an fp32 operand (M, h_in,
    dS dt, dS, exp(cums) dY, and dY itself) taken on its hi + lo split
    (``split``), or with that operand rounded to bf16.  Returns ``y,
    (dx, db, dc, ddt, dcums, dh_in, dd_skip)`` in the plain versions'
    dtypes."""
    bt, s, h, p = x.shape
    g, n = b.shape[2:]
    xc, bc, cc, dtc, cm, ldec, _, _ = ref._ssd_chunks(x, b, c, dt, cums,
                                                      h_in)
    e = torch.exp(cm)
    dj = dtc[:, :, None, :, :]                       # dt_j, (z, c, 1, j, h)
    cb = torch.einsum("zcihn,zcjhn->zcijh", cc, bc) * dj
    m = cb * ldec
    sp = lambda t: t if split else t.bfloat16().float()
    hin = h_in.float()
    y = (e[..., None] * _prod("zcihn,zchnp->zcihp", cc, sp(hin), False,
                              split)
         + _prod("zcijh,zcjhp->zcihp", sp(m), xc, split, False)
         + d_skip[:, None] * xc)
    dyc = dy.float().reshape(xc.shape)
    dm = _prod("zcihp,zcjhp->zcijh", dyc, xc, split, False)
    ds = dm * ldec
    t = ds * cb
    z = _prod("zcihp,zchnp->zcihn", dyc, sp(hin), split, split)
    dc = e[..., None] * z + _prod("zcijh,zcjhn->zcihn", sp(ds * dj), bc,
                                  split, False)
    dx = (_prod("zcijh,zcihp->zcjhp", sp(m), dyc, split, split)
          + d_skip[:, None] * dyc)
    dbx = _prod("zcijh,zcihn->zcjhn", sp(ds), cc, split, False)
    dh = _prod("zcihp,zcihn->zchpn", sp(e[..., None] * dyc), cc, split,
               False).transpose(-1, -2)
    dcums = t.sum(3) - t.sum(2) + e * (cc * z).sum(-1)
    grouped = lambda t_: t_.reshape(bt, s, g, h // g, n).sum(3)
    return y.reshape(x.shape), (
        dx.reshape(x.shape).to(x.dtype),
        grouped(dbx * dtc[..., None]).to(b.dtype), grouped(dc).to(c.dtype),
        (dbx * bc).sum(-1).reshape(bt, s, h), dcums.reshape(bt, s, h),
        dh, (dyc * xc).sum((0, 1, 2, 4)))


def _bf16_block_inputs(shape, dy_bf16, seed=19):
    """The SSD block's inputs as ``chip_smoke.ssd_inputs`` draws them (dt =
    softplus(N(0, 1) - 2), a = -(1..H), cums the within-chunk cumsum of dt
    a, so the decay overflows above the diagonal), from a numpy seed; x,
    b, c in bf16; dY bf16-valued (the gradient of y.to(bf16), as the model
    feeds it) or fp32."""
    bt, s, h, g, p, n, chunk = shape
    q = min(chunk, s)
    rng = np.random.default_rng(seed)
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32))
    x, b, c = f(bt, s, h, p), f(bt, s, g, n) * 0.5, f(bt, s, g, n) * 0.5
    dt = torch.nn.functional.softplus(f(bt, s, h) - 2.0)
    a = -torch.arange(1, h + 1, dtype=torch.float32)
    cums = torch.cumsum((dt * a).reshape(bt, s // q, q, h), 2).reshape(
        bt, s, h)
    h_in, d_skip = f(bt, s // q, h, n, p) * 0.1, 1.0 + f(h) * 0.1
    dy = f(bt, s, h, p)
    if dy_bf16:
        dy = dy.bfloat16().float()
    return (x.bfloat16(), b.bfloat16(), c.bfloat16(), dt, cums, h_in,
            d_skip), dy


@pytest.mark.parametrize("split,dy_bf16", [(True, True), (True, False),
                                           (False, True)])
@pytest.mark.parametrize("shape", [(1, 256, 2, 1, 64, 128, 256),
                                   (1, 200, 4, 2, 48, 80, 256)])
def test_bf16_kernel_arithmetic_holds_the_ssd_tolerance(shape, split,
                                                        dy_bf16):
    """The tolerance decision of the bf16 SSD kernels, at one Mamba2-370m
    chunk (P 64, N 128) and the ragged shape of ``chip_smoke.py`` (S 200,
    G 2, P 48, N 80): their arithmetic, emulated, holds ``chip_smoke.py``'s
    rule (TOL_SSD for y, TOL_SSD_GRAD for the gradients, bf16 outputs
    within one bf16 ulp of themselves plus that share of the largest
    entry) against the fp32 plain versions with every fp32 operand split
    into bf16 hi + lo, for dY bf16-valued and not; with those operands
    rounded to bf16 instead, some output misses it."""
    from chip_smoke import TOL_SSD, TOL_SSD_GRAD
    ins, dy = _bf16_block_inputs(shape, dy_bf16)
    y, grads = _emulated_bf16_ssd(*ins, dy, split=split)
    want_y = ref.ssd_chunk(*ins)
    want = ref.ssd_chunk_bwd(*ins, dy)
    assert all(bool(torch.isfinite(t).all()) for t in (y, *grads))
    shares = [_share_of_bound(y, want_y, TOL_SSD)]
    shares += [_share_of_bound(gt, w, TOL_SSD_GRAD)
               for gt, w in zip(grads, want)]
    if split:
        assert max(shares) <= 1.0, shares
    else:
        assert max(shares) > 1.0, shares
