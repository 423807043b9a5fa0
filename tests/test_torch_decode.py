"""The port's serving paths (caches, prefill and decode) against the JAX
package, at smoke size.

Each cache op of ``models/attention.py`` (``attn_prefill``,
``attn_decode``, ``attn_decode_paged``, ``attn_prefill_paged``) and
``models/mamba2.py`` (``mamba_decode``, and ``mamba_apply`` with a cache)
on random inputs; then every family's ``init_cache`` / ``prefill`` / six
``decode_step``s: gpt2-117m (learned positions, tied head), qwen3-14b
(qk-norm, RoPE, GQA), olmoe-1b-7b (the MoE block, whose capacity follows
the token count), llava-next-mistral-7b (``embeds`` before the prompt),
mamba2-370m, zamba2-2.7b (Mamba caches and one KV cache per shared-block
application) and whisper-large-v3 (the cross K / V at prefill); the paged
trio (``init_paged_cache``, ``prefill_paged`` in chunks, ``decode_paged``
with a parked row); and the clamps JAX applies where a serving path runs
past a table: learned positions past ``max_seq_len`` (dense and paged
decode) and the dense decode's write past ``cache_len``.

Both packages start from the JAX init and cache (``repro_torch.convert``);
decode feeds both the JAX stream's greedy tokens.  Everything runs in fp32
compute (MoE too: in bf16 the frameworks route near-tied tokens apart,
``test_torch_moe.py``), where the frameworks differ in summation order
only, so logits and caches agree within 1e-4 of each tensor's largest
entry (``TOL``).  The null block of a paged pool holds garbage by design
(parked rows write there with duplicate indices) and is never compared.
Each JAX reference runs once per module, and torch runs on one intra-op
thread.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as JA
from repro.models import build_model as jax_build_model
from repro.models import mamba2 as JM
from repro_torch.configs.archs import get_smoke_config
from repro_torch.convert import (cache_from_numpy, params_from_numpy,
                                 pool_from_numpy)
from repro_torch.models import attention as TA
from repro_torch.models import mamba2 as TM
from repro_torch.models.model_zoo import build_model
from test_torch_model import _close_rel
from _torch_threads import one_thread  # noqa: F401 (autouse fixture)

TOL = 1e-4
STEPS = 6


def _cfgs(arch, **over):
    return tuple(dataclasses.replace(f(arch), dtype="float32", **over)
                 for f in (jax_smoke_config, get_smoke_config))


def _np_tree(x):
    """A cache (dicts and NamedTuples of arrays or tensors) as a flat dict
    of float64 numpy arrays, ``pos`` as an int, dict keys sorted (a jitted
    JAX function returns them so)."""
    out = {}

    def walk(prefix, v):
        if isinstance(v, dict):
            for k, w in sorted(v.items()):
                walk(f"{prefix}/{k}", w)
        elif hasattr(v, "_fields"):
            for k in v._fields:
                walk(f"{prefix}/{k}", getattr(v, k))
        elif isinstance(v, torch.Tensor):
            out[prefix] = v.detach().float().numpy().astype(np.float64)
        elif isinstance(v, int):
            out[prefix] = v
        else:
            a = np.asarray(v)
            out[prefix] = int(a) if a.ndim == 0 and a.dtype.kind == "i" \
                else a.astype(np.float64)
    walk("", x)
    return out


def _close_caches(got, want, what):
    got, want = _np_tree(got), _np_tree(want)
    assert list(got) == list(want), (list(got), list(want))
    for k in want:
        if isinstance(want[k], int):
            assert got[k] == want[k], (what, k)
        else:
            assert got[k].shape == want[k].shape, (what, k)
            _close_rel(got[k], want[k], TOL, f"{what} {k}")


# ---------------------------------------------------------------------------
# the cache ops
# ---------------------------------------------------------------------------

def _attn_case(arch="qwen3-14b"):
    cfg_j, cfg_t = _cfgs(arch)
    p = jax.device_get(JA.attn_init(jax.random.PRNGKey(3), cfg_j, 64))
    return cfg_j, cfg_t, p, params_from_numpy(p)


@pytest.mark.parametrize("arch", ["gpt2-117m", "qwen3-14b"])
def test_attn_prefill_and_decode_match_jax(arch):
    """Prefill a (2, 16) prompt into a 24-row cache, then three decode
    steps at 16, 17, 18: outputs and caches."""
    cfg_j, cfg_t, pj, pt = _attn_case(arch)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    jc = JA.init_kv_cache(2, 24, cfg_j, jnp.float32)
    jo, jc = JA.attn_prefill(cfg_j, pj, jnp.asarray(x), jc)
    tc = TA.init_kv_cache(2, 24, cfg_t, torch.float32)
    with torch.inference_mode():
        to, tc = TA.attn_prefill(cfg_t, pt, torch.from_numpy(x), tc)
    _close_rel(to.numpy(), np.asarray(jo), TOL, "prefill out")
    _close_caches(tc, jc, "prefill cache")
    for pos in (16, 17, 18):
        xd = rng.standard_normal((2, 1, 64)).astype(np.float32)
        jo, jc = JA.attn_decode(cfg_j, pj, jnp.asarray(xd), jc,
                                jnp.asarray(pos, jnp.int32))
        with torch.inference_mode():
            to, tc = TA.attn_decode(cfg_t, pt, torch.from_numpy(xd), tc, pos)
        _close_rel(to.numpy(), np.asarray(jo), TOL, f"decode {pos}")
        _close_caches(tc, jc, f"decode cache {pos}")


def _pool_case(rng, nb=9, bs=4, kv=2, dh=16):
    pool = rng.standard_normal((2, nb, bs, kv, dh)).astype(np.float32)
    return pool[0], pool[1]


def test_attn_decode_paged_matches_jax():
    """Three rows, one parked on the null block, at positions 5, 0 and 10
    of 3-block tables (block size 4): the outputs of the live rows and
    every pool block but the null one."""
    cfg_j, cfg_t, pj, pt = _attn_case()
    rng = np.random.default_rng(1)
    pk, pv = _pool_case(rng)
    tables = np.array([[3, 7, 1], [0, 0, 0], [2, 5, 8]], np.int32)
    positions = np.array([5, 0, 10], np.int32)
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    jo, jk, jv = JA.attn_decode_paged(cfg_j, pj, jnp.asarray(x),
                                      jnp.asarray(pk), jnp.asarray(pv),
                                      jnp.asarray(tables),
                                      jnp.asarray(positions))
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    with torch.inference_mode():
        to, tk, tv = TA.attn_decode_paged(
            cfg_t, pt, torch.from_numpy(x), tk, tv,
            torch.from_numpy(tables).long(),
            torch.from_numpy(positions).long())
    _close_rel(to.numpy()[[0, 2]], np.asarray(jo)[[0, 2]], TOL, "out")
    _close_rel(tk.numpy()[1:], np.asarray(jk)[1:], TOL, "pool k")
    _close_rel(tv.numpy()[1:], np.asarray(jv)[1:], TOL, "pool v")


def test_attn_prefill_paged_matches_jax():
    """Two chunks of 8 (the second bucket-padded past the prompt's 13
    tokens) through a 4-block table of block size 4."""
    cfg_j, cfg_t, pj, pt = _attn_case()
    rng = np.random.default_rng(2)
    pk, pv = _pool_case(rng)
    table = np.array([4, 2, 6, 1], np.int32)
    jk, jv = jnp.asarray(pk), jnp.asarray(pv)
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    for p0 in (0, 8):
        x = rng.standard_normal((1, 8, 64)).astype(np.float32)
        jo, jk, jv = JA.attn_prefill_paged(cfg_j, pj, jnp.asarray(x), jk, jv,
                                           jnp.asarray(table),
                                           jnp.asarray(p0, jnp.int32))
        with torch.inference_mode():
            to, tk, tv = TA.attn_prefill_paged(
                cfg_t, pt, torch.from_numpy(x), tk, tv,
                torch.from_numpy(table).long(), p0)
        _close_rel(to.numpy(), np.asarray(jo), TOL, f"out p0 {p0}")
        _close_rel(tk.numpy()[1:], np.asarray(jk)[1:], TOL, "pool k")
        _close_rel(tv.numpy()[1:], np.asarray(jv)[1:], TOL, "pool v")


def test_mamba_cache_paths_match_jax():
    """``mamba_apply`` with a cache over a (2, 32) prompt (two chunks of
    16): the output and the cache (the pre-conv tail, the final state);
    then ``mamba_decode`` three steps from it."""
    cfg_j, cfg_t = _cfgs("mamba2-370m")
    p = jax.device_get(JM.mamba_init(jax.random.PRNGKey(5), cfg_j))
    pt = params_from_numpy(p)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, 64)).astype(np.float32)
    jo, jc = JM.mamba_apply(cfg_j, p, jnp.asarray(x),
                            JM.init_mamba_cache(2, cfg_j, jnp.float32))
    with torch.inference_mode():
        to, tc = TM.mamba_apply(cfg_t, pt, torch.from_numpy(x),
                                TM.init_mamba_cache(2, cfg_t, torch.float32))
    _close_rel(to.numpy(), np.asarray(jo), TOL, "apply out")
    _close_caches(tc, jc, "apply cache")
    for step in range(3):
        xd = rng.standard_normal((2, 1, 64)).astype(np.float32)
        jo, jc = JM.mamba_decode(cfg_j, p, jnp.asarray(xd), jc)
        with torch.inference_mode():
            to, tc = TM.mamba_decode(cfg_t, pt, torch.from_numpy(xd), tc)
        _close_rel(to.numpy(), np.asarray(jo), TOL, f"decode {step}")
        _close_caches(tc, jc, f"decode cache {step}")


# ---------------------------------------------------------------------------
# every family: init_cache / prefill / decode_step
# ---------------------------------------------------------------------------

# (arch, prompt length, frontend embeddings: None, or the number of rows)
FAMILIES = [("gpt2-117m", 32, None), ("qwen3-14b", 32, None),
            ("olmoe-1b-7b", 32, None), ("llava-next-mistral-7b", 24, 8),
            ("mamba2-370m", 32, None), ("zamba2-2.7b", 32, None),
            ("whisper-large-v3", 12, "enc_seq")]
CACHE_LEN = 48


def _clone(cache):
    if isinstance(cache, dict):
        return {k: _clone(v) for k, v in cache.items()}
    if hasattr(cache, "_fields"):
        return type(cache)(*(_clone(v) for v in cache))
    return cache.clone() if isinstance(cache, torch.Tensor) else cache


def _family_run(arch, plen, front, cache_len=CACHE_LEN, steps=STEPS,
                seed=0, **over):
    """JAX and the port from the JAX init and cache: the prefill's logits
    and cache, then each decode step's (the port fed JAX's greedy
    tokens), as numpy."""
    cfg_j, cfg_t = _cfgs(arch, **over)
    jm, tm = jax_build_model(cfg_j), build_model(cfg_t)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    tp = params_from_numpy(params)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg_j.vocab, (2, plen)).astype(np.int32)
    rows = cfg_j.enc_seq if front == "enc_seq" else front
    embeds = (None if rows is None else
              rng.standard_normal((2, rows, 64)).astype(np.float32))
    jcache = jm.init_cache(2, cache_len)
    tcache = cache_from_numpy(jax.device_get(jcache))
    kw_j = {} if embeds is None else {"embeds": jnp.asarray(embeds)}
    kw_t = {} if embeds is None else {"embeds": torch.from_numpy(embeds)}
    jl, jcache = jax.jit(jm.prefill)(params, jnp.asarray(tokens), jcache,
                                     **kw_j)
    tl, tcache = tm.prefill(tp, torch.from_numpy(tokens).long(), tcache,
                            **kw_t)
    out = {"prefill": (tl.numpy(), np.asarray(jl)),
           "prefill_cache": (_clone(tcache), jax.device_get(jcache))}
    dec = jax.jit(jm.decode_step)
    for i in range(steps):
        tok = np.asarray(jnp.argmax(jl[:, -1, :], axis=-1)).astype(
            np.int32)[:, None]
        jl, jcache = dec(params, jcache, jnp.asarray(tok))
        tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok).long())
        out[f"decode {i}"] = (tl.numpy(), np.asarray(jl))
    out["cache"] = (tcache, jax.device_get(jcache))
    return out


@pytest.fixture(scope="module")
def family_runs():
    return {arch: _family_run(arch, plen, front)
            for arch, plen, front in FAMILIES}


@pytest.mark.parametrize("arch", [a for a, _, _ in FAMILIES])
def test_family_prefill_and_decode_match_jax(family_runs, arch):
    """Logits after the prefill and after each of six decode steps, and
    the whole cache after the prefill and after the last step (the
    position included), within ``TOL``."""
    run = family_runs[arch]
    for what, (got, want) in run.items():
        if what.endswith("cache"):
            _close_caches(got, want, f"{arch} {what}")
        else:
            assert got.shape == want.shape, (arch, what)
            assert np.isfinite(got).all(), (arch, what)
            _close_rel(got, want, TOL, f"{arch} {what}")


def test_family_cache_structure(family_runs):
    """The keys and shapes of each family's cache are JAX's: zamba2 has one
    KV cache per shared-block application (4 layers / every 2), whisper
    the cross K / V per decoder layer."""
    want = {"gpt2-117m": ["/kv/k", "/kv/v", "/pos"],
            "mamba2-370m": ["/mamba/conv", "/mamba/ssm", "/pos"],
            "zamba2-2.7b": ["/kv/k", "/kv/v", "/mamba/conv", "/mamba/ssm",
                            "/pos"],
            "whisper-large-v3": ["/cross", "/kv/k", "/kv/v", "/pos"]}
    for arch, keys in want.items():
        got = _np_tree(family_runs[arch]["cache"][0])
        assert list(got) == keys, (arch, list(got))
    assert _np_tree(family_runs["zamba2-2.7b"]["cache"][0])["/kv/k"].shape[
        0] == 2
    assert _np_tree(family_runs["whisper-large-v3"]["cache"][0])[
        "/cross"].shape == (2, 2, 2, 32, 2, 16)


# ---------------------------------------------------------------------------
# the paged trio
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gpt2-117m", "olmoe-1b-7b"])
def test_paged_prefill_in_chunks_and_decode_match_jax(arch):
    """Slot 0's 21-token prompt prefilled in chunks of 16 and 8 (the
    second bucket-padded), slot 1's 9-token prompt in one of 16, through
    block tables of a 13-block pool (block size 8, 6 columns); then six
    ``decode_paged`` steps of three rows, the third parked on the null
    block.  Logits of the real rows, and the pool but its null block."""
    cfg_j, cfg_t = _cfgs(arch)
    jm, tm = jax_build_model(cfg_j), build_model(cfg_t)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    tp = params_from_numpy(params)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 512, 21), rng.integers(0, 512, 9)]
    # slot 0 decodes to position 26: its 4th block (3) holds 24 on, as the
    # engine grows a table before the step that reaches it (a null column
    # there would be read unmasked, after the parked row's writes)
    tables = np.array([[5, 2, 9, 3, 0, 0], [7, 1, 12, 0, 0, 0],
                       [0] * 6], np.int32)
    jpool = jm.init_paged_cache(13, 8)
    tpool = pool_from_numpy(jax.device_get(jpool))
    jpre = jax.jit(jm.prefill_paged)
    first = []
    for slot, chunks in ((0, ((0, 16, 16), (16, 5, 8))), (1, ((0, 9, 16),))):
        for p0, real, padded in chunks:
            chunk = np.zeros((1, padded), np.int32)
            chunk[0, :real] = prompts[slot][p0:p0 + real]
            jl, jpool = jpre(params, jpool, jnp.asarray(chunk),
                             jnp.asarray(tables[slot]),
                             jnp.asarray(p0, jnp.int32),
                             jnp.asarray(real - 1, jnp.int32))
            tl, tpool = tm.prefill_paged(
                tp, tpool, torch.from_numpy(chunk).long(),
                torch.from_numpy(tables[slot]).long(), p0, real - 1)
            _close_rel(tl.numpy(), np.asarray(jl), TOL,
                       f"prefill slot {slot} p0 {p0}")
        first.append(int(jnp.argmax(jl[0, -1])))
    for name in ("k", "v"):
        _close_rel(tpool[name].numpy()[:, 1:],
                   np.asarray(jpool[name])[:, 1:], TOL, f"pool {name}")
    positions = np.array([21, 9, 0], np.int32)
    toks = np.array([[first[0]], [first[1]], [0]], np.int32)
    jdec = jax.jit(jm.decode_paged)
    for step in range(STEPS):
        jl, jpool = jdec(params, jpool, jnp.asarray(toks),
                         jnp.asarray(tables), jnp.asarray(positions))
        tl, tpool = tm.decode_paged(tp, tpool, torch.from_numpy(toks).long(),
                                    torch.from_numpy(tables).long(),
                                    torch.from_numpy(positions).long())
        _close_rel(tl.numpy()[:2], np.asarray(jl)[:2], TOL, f"step {step}")
        toks[:2, 0] = np.asarray(jnp.argmax(jl[:2, -1], axis=-1))
        positions[:2] += 1
    for name in ("k", "v"):
        _close_rel(tpool[name].numpy()[:, 1:],
                   np.asarray(jpool[name])[:, 1:], TOL, f"pool {name}")


# ---------------------------------------------------------------------------
# clamps
# ---------------------------------------------------------------------------

def test_learned_positions_clamp_past_the_table_as_jax():
    """GPT-2's smoke table has 256 rows; a 250-token prompt in a 272-row
    cache decodes to positions 250 .. 259, where JAX's ``dynamic_slice``
    (dense) and jitted gather (paged) clamp the row to 255.  Dense and paged
    logits against JAX's at every step."""
    run = _family_run("gpt2-117m", 250, None, cache_len=272, steps=10,
                      seed=5)
    for what, (got, want) in run.items():
        if what.endswith("cache"):
            _close_caches(got, want, what)
        else:
            _close_rel(got, want, TOL, what)
    cfg_j, cfg_t = _cfgs("gpt2-117m")
    jm, tm = jax_build_model(cfg_j), build_model(cfg_t)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    tp = params_from_numpy(params)
    tables = np.arange(1, 35, dtype=np.int32).reshape(2, 17)
    jpool = jm.init_paged_cache(35, 16)
    tpool = pool_from_numpy(jax.device_get(jpool))
    toks = np.array([[7], [11]], np.int32)
    jdec = jax.jit(jm.decode_paged)      # the engine's: jitted, clamping
    for pos in range(254, 260):
        positions = np.full((2,), pos, np.int32)
        jl, jpool = jdec(params, jpool, jnp.asarray(toks),
                                    jnp.asarray(tables),
                                    jnp.asarray(positions))
        tl, tpool = tm.decode_paged(tp, tpool, torch.from_numpy(toks).long(),
                                    torch.from_numpy(tables).long(),
                                    torch.from_numpy(positions).long())
        _close_rel(tl.numpy(), np.asarray(jl), TOL, f"paged pos {pos}")


def test_dense_decode_write_clamps_past_the_cache_as_jax():
    """A 30-token prompt in a 32-row cache, then four decode steps: at
    positions 32 and 33 JAX's ``dynamic_update_slice`` writes row 31, and
    the mask then admits every row.  qwen3 (RoPE at the true position)."""
    run = _family_run("qwen3-14b", 30, None, cache_len=32, steps=4, seed=6)
    for what, (got, want) in run.items():
        if what.endswith("cache"):
            _close_caches(got, want, what)
        else:
            _close_rel(got, want, TOL, what)
