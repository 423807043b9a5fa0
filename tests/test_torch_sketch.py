"""The port's count-min sketch and dense Adam against the JAX package's.

Hashing is integer arithmetic on the host, so the bucket indices must be
equal, not close.  ``repro_torch.kernels.ref.sketch_update`` (the plain
version the CUDA kernels are held against on the card) is compared with
the JAX oracle and with the JAX Pallas kernel in interpret mode.  Inputs
come from numpy seeds.

Tolerances, with their reasons: the sketch scatter sums the squares of the
rows that share a bucket, in another order in the Pallas kernel (a one-hot
matmul) than in the port's ``index_add_``, so tables and queries are held
to 1e-6 of their largest entry; the transforms over 5 steps likewise
(1e-6 of each leaf's largest entry); the float32 bias corrections are
equal to XLA's (``adamw.bias_corrections``).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import sketch_state_from_numpy
from repro_torch.kernels import ops, ref

# repro.core re-exports functions named ``adamw`` and ``sketch`` over the
# modules
JW = importlib.import_module("repro.core.adamw")
JS = importlib.import_module("repro.core.sketch")
TW = importlib.import_module("repro_torch.core.adamw")
TS = importlib.import_module("repro_torch.core.sketch")

TOL = 1e-6


def _close(a, b, what=""):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=0, err_msg=what,
                               atol=TOL * max(float(np.max(np.abs(b))),
                                              1e-30))


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("seed,leaf,depth,rows,width", [
    (0, 0, 4, 50257, 2048), (0, 1, 4, 1024, 2048), (7, 3, 2, 512, 256),
    (123456789, 11, 5, 1000, 130)])
def test_hashing_equals_jax(seed, leaf, depth, rows, width):
    seeds = TS._leaf_seeds(seed, leaf, depth)
    assert seeds == JS._leaf_seeds(seed, leaf, depth)
    got = TS.bucket_indices(rows, width, seeds)
    np.testing.assert_array_equal(got, JS.bucket_indices(rows, width, seeds))
    assert got.dtype == np.int32 and got.min() >= 0 and got.max() < width


def _sketch_inputs(rows, width, depth, inner, seed=0):
    rng = np.random.default_rng(seed)
    table = np.abs(rng.standard_normal((depth, width, inner))).astype(
        np.float32)
    g = rng.standard_normal((rows, inner)).astype(np.float32)
    idx = JS.bucket_indices(rows, width, JS._leaf_seeds(seed, 0, depth))
    return table, g, idx


# (rows, width, depth, inner): aligned, ragged, unaligned, degenerate
SHAPES = [(256, 128, 4, 256), (37, 5, 3, 16), (1000, 130, 2, 100),
          (8, 3, 1, 4)]


@pytest.mark.parametrize("rows,width,depth,inner", SHAPES)
def test_ref_sketch_update_matches_jax_ref(rows, width, depth, inner):
    table, g, idx = _sketch_inputs(rows, width, depth, inner)
    new, vhat = ref.sketch_update(_t(table), _t(g), _t(idx), 0.999)
    want_new, want_vhat = jref.sketch_update(jnp.asarray(table),
                                             jnp.asarray(g),
                                             jnp.asarray(idx), 0.999)
    _close(new, want_new, "table")
    _close(vhat, want_vhat, "vhat")


@pytest.mark.parametrize("rows,width,depth,inner", SHAPES)
def test_ops_sketch_update_matches_pallas_interpret(rows, width, depth,
                                                    inner):
    """The JAX dispatch in pallas mode pads and runs sketch_update_pallas
    with interpret=True; the port's dispatch on CPU tensors takes the plain
    version."""
    table, g, idx = _sketch_inputs(rows, width, depth, inner, seed=1)
    jops.set_mode("pallas")
    try:
        want_new, want_vhat = jops.sketch_update(
            jnp.asarray(table), jnp.asarray(g), jnp.asarray(idx), 0.999)
    finally:
        jops.set_mode("auto")
    new, vhat = ops.sketch_update(_t(table), _t(g), _t(idx), 0.999)
    _close(new, want_new, "table")
    _close(vhat, want_vhat, "vhat")


def test_bucket_order_lists_each_bucket_in_row_order():
    """The CUDA scatter's index buffers: bucket b of depth j is
    order[j, offsets[j, b]:offsets[j, b + 1]], rows ascending."""
    _, _, idx = _sketch_inputs(1000, 130, 3, 4)
    order, offsets = ops.bucket_order(_t(idx), 130)
    assert order.dtype == offsets.dtype == torch.int32
    assert offsets.shape == (3, 131)
    for j in range(3):
        for b in (0, 1, 57, 129):
            rows = order[j, offsets[j, b]:offsets[j, b + 1]].numpy()
            np.testing.assert_array_equal(rows, np.flatnonzero(idx[j] == b))
        assert int(offsets[j, -1]) == 1000


def _params(rng):
    return {"b": rng.standard_normal((5,)).astype(np.float32),
            "e": rng.standard_normal((64, 8)).astype(np.float32),
            "w": rng.standard_normal((40, 3, 2)).astype(np.float32),
            "x": rng.standard_normal((8, 4)).astype(np.float32)}


@pytest.mark.parametrize("b1", [0.9, 0.0])
def test_scale_by_sketch_matches_jax(b1):
    """5 steps on fixed grads: directions, tables and first moments.  "e"
    and "w" (3-D, inner dims flattened) are sketched, "b" and "x" run the
    dense fallback."""
    kw = dict(b1=b1, b2=0.999, eps=1e-8, depth=3, width=16, min_rows=32,
              seed=5)
    rng = np.random.default_rng(0)
    params = _params(rng)
    jopt, topt = JS.scale_by_sketch(JS.SketchConfig(**kw)), \
        TS.scale_by_sketch(TS.SketchConfig(**kw))
    jst = jopt.init({k: jnp.asarray(v) for k, v in params.items()})
    tst = topt.init({k: _t(v) for k, v in params.items()})
    jupdate = jax.jit(jopt.update)
    for t in range(1, 6):
        g = {k: (rng.standard_normal(v.shape) * 1e-2).astype(np.float32)
             for k, v in params.items()}
        ju, jst = jupdate({k: jnp.asarray(v) for k, v in g.items()}, jst,
                          None)
        tu, tst = topt.update({k: _t(v) for k, v in g.items()}, tst, None)
        for k in params:
            _close(tu[k], ju[k], f"direction {k} t={t}")
    assert tst.step == int(jst.step) == 5
    for k, jl, tl in zip(params, jax.device_get(jst.leaves), tst.leaves):
        if isinstance(tl, TS.SketchLeaf):
            assert tl.seeds == jl.seeds and tl.shape == jl.shape
            _close(tl.table, jl.table, f"table {k}")
            assert (tl.m is None) == (jl.m is None) == (b1 == 0)
            if tl.m is not None:
                _close(tl.m, jl.m, f"m {k}")
        else:
            _close(tl.m, jl.m, f"m {k}")
            _close(tl.v, jl.v, f"v {k}")


def test_sketch_state_from_numpy_continues_jax_run():
    """convert.sketch_state_from_numpy: the port picks up a JAX sketch
    state after 3 steps and its 4th direction matches JAX's."""
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, depth=2, width=8, min_rows=32)
    rng = np.random.default_rng(3)
    params = _params(rng)
    jopt = JS.scale_by_sketch(JS.SketchConfig(**kw))
    jupdate = jax.jit(jopt.update)
    jst = jopt.init({k: jnp.asarray(v) for k, v in params.items()})
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(4)]
    for g in grads[:3]:
        _, jst = jupdate({k: jnp.asarray(v) for k, v in g.items()}, jst,
                         None)
    tst = sketch_state_from_numpy(int(jst.step), jax.device_get(jst.leaves))
    ju, _ = jupdate({k: jnp.asarray(v) for k, v in grads[3].items()}, jst,
                    None)
    tu, _ = TS.scale_by_sketch(TS.SketchConfig(**kw)).update(
        {k: _t(v) for k, v in grads[3].items()}, tst, None)
    for k in params:
        _close(tu[k], ju[k], k)


def test_dense_fallback_bitwise_matches_scale_by_adam():
    """Leaves below min_rows run exact dense Adam, bit for bit the port's
    own scale_by_adam (the JAX package's contract, test_sketch.py)."""
    params = {"b": torch.full((5,), -0.2), "w": torch.full((8, 4), 0.3)}
    sk = TS.scale_by_sketch(TS.SketchConfig(min_rows=1024))
    ad = TW.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)
    s_sk, s_ad = sk.init(params), ad.init(params)
    gen = torch.Generator().manual_seed(1)
    for _ in range(3):
        g = {k: torch.randn(p.shape, generator=gen)
             for k, p in params.items()}
        u_sk, s_sk = sk.update(g, s_sk, params)
        u_ad, s_ad = ad.update(g, s_ad, params)
        for k in params:
            assert torch.equal(u_sk[k], u_ad[k]), k


def test_no_underestimate_through_transform():
    """The implied vhat never drops below the exact dense-Adam vhat
    (collisions only add mass): port of the JAX package's test."""
    cfg = TS.SketchConfig(b1=0.0, b2=0.9, eps=0.0, depth=2, width=16,
                          min_rows=8)
    params = {"e": torch.zeros((64, 4))}
    opt = TS.scale_by_sketch(cfg)
    state = opt.init(params)
    exact_v = np.zeros((64, 4), np.float32)
    rng = np.random.default_rng(0)
    for t in range(1, 5):
        g = rng.standard_normal((64, 4)).astype(np.float32)
        upd, state = opt.update({"e": _t(g)}, state, params)
        exact_v = 0.9 * exact_v + 0.1 * np.square(g)
        bound = np.abs(g) / np.sqrt(exact_v / (1.0 - 0.9 ** t))
        assert np.all(np.abs(upd["e"].numpy()) <= bound * (1 + 1e-5))


@pytest.mark.parametrize("b1", [0.9, 0.0])
def test_scale_by_adam_matches_jax(b1):
    rng = np.random.default_rng(2)
    params = _params(rng)
    jopt, topt = JW.scale_by_adam(b1, 0.999, 1e-8), \
        TW.scale_by_adam(b1, 0.999, 1e-8)
    jst = jopt.init({k: jnp.asarray(v) for k, v in params.items()})
    tst = topt.init({k: _t(v) for k, v in params.items()})
    for t in range(1, 6):
        g = {k: (rng.standard_normal(v.shape) * 1e-2).astype(np.float32)
             for k, v in params.items()}
        ju, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jst,
                              None)
        tu, tst = topt.update({k: _t(v) for k, v in g.items()}, tst, None)
        for k in params:
            _close(tu[k], ju[k], f"direction {k} t={t}")
    for k in params:
        _close(tst.m[k], jst.m[k], f"m {k}")
        _close(tst.v[k], jst.v[k], f"v {k}")


def test_adamw_chain_matches_jax():
    """The full AdamW chain (decay, cosine schedule, sign) over 5 steps."""
    from repro.core.types import Schedule as JSchedule
    from repro_torch.core.types import Schedule
    rng = np.random.default_rng(4)
    params = _params(rng)
    sched = dict(peak_lr=3e-3, warmup_steps=2, total_steps=5, min_lr=5e-4)
    jopt = JW.adamw(JW.AdamWConfig(lr=JSchedule(**sched), weight_decay=0.1))
    topt = TW.adamw(TW.AdamWConfig(lr=Schedule(**sched), weight_decay=0.1))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: _t(v) for k, v in params.items()}
    jst, tst = jopt.init(jp), topt.init(tp)
    for t in range(1, 6):
        g = {k: (rng.standard_normal(v.shape) * 1e-2).astype(np.float32)
             for k, v in params.items()}
        ju, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jst,
                              jp)
        tu, tst = topt.update({k: _t(v) for k, v in g.items()}, tst, tp)
        for k in params:
            _close(tu[k], ju[k], f"update {k} t={t}")


def test_sketch_kernel_wrapper_refuses_cpu_and_other_devices():
    """The CUDA wrapper checks before it builds or launches anything, and
    the dispatch raises for a device that is neither the CPU nor CUDA."""
    from repro_torch.kernels import sketch_update as SK
    table, g, idx = (_t(x) for x in _sketch_inputs(37, 5, 3, 16))
    order, offsets = ops.bucket_order(idx, 5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        SK.sketch_update(table, g, idx, order, offsets, 0.999)
    assert SK.LAUNCHES == {"sketch_scatter": 0, "sketch_query": 0}
    with pytest.raises(ValueError, match="device"):
        ops.sketch_update(table.to("meta"), g.to("meta"), idx.to("meta"),
                          0.999)


@pytest.mark.parametrize("d", [768, 1024, 50280, 100, 1001])
def test_column_slices_cover_every_column(d):
    """The sketch kernels' column slices (GPT-2's d, Mamba2's d and its
    lm_head's vocab, ragged d) cover every column exactly once, in order,
    each at most ``SLICE`` wide and starting on a 4-column boundary (one
    16-byte load a lane when d % 4 == 0)."""
    from repro_torch.kernels import sketch_update as SK
    slices = SK.column_slices(d)
    cols = [c for start, stop in slices for c in range(start, stop)]
    assert cols == list(range(d))
    assert len(slices) == -(-d // SK.SLICE)
    assert all(0 < stop - start <= SK.SLICE and start % 4 == 0
               for start, stop in slices)
