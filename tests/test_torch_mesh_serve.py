"""Serving on a mesh: the transformer families' ``prefill`` and
``decode_step`` on each rank's parameter blocks and its block of the KV
cache (``distributed.sharding.serving_view``), on 8 gloo ranks on the CPU
(``_torch_serve_ranks.py``, one spawn), against the same model served on
one device by the port and by the JAX package.

Each of the smoke Qwen2 (GQA, qkv bias, RoPE), GPT-2 (learned positions,
tied embedding), Qwen3 (qk-norm), LLaVA (``embeds`` before the prompt)
and OLMoE (the MoE block: ``moe_apply_sharded`` in the prefill,
``moe_apply_ep_tp`` in decode) prefills a batch of 4 prompts of 10
positions into a 24-row cache and takes 16 decode steps (positions 10 ..
25: across a block edge of the cache's sequence on every mesh, and two
writes past ``cache_len``, which clamp to its last row), fed the JAX
stream's greedy tokens, on the meshes (data, model) (4, 2) (every head,
hidden unit and vocabulary row a block), (2, 4) (the kv leaves on the
"slice" route, gathered whole) and (1, 8) (q heads misaligned too, half
the ranks without one).  Everything runs in fp32 compute, where the runs
differ in summation order only (the ranks' log-sum-exp combine, the
split products' sums), so the logits after the prefill and after each
step are held within ``TOL`` = 1e-4 of their largest entry to the port's
single-device run and to JAX's ``prefill`` / ``decode_step`` from the
same parameters, and each rank's cache block to its rows of the
single-device cache.  OLMoE runs dropless (capacity factor 4 = experts /
top-k): its capacity follows the token count a routing call sees, which
is the rank's batch block in the prefill's expert-parallel path, so with
drops the mesh and one device would drop different pairs by design (as
JAX's mesh path does).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as MR
import _torch_serve_ranks as R
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro_torch.configs.archs import get_smoke_config
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.models.model_zoo import build_model
from _torch_threads import one_thread  # noqa: F401 (autouse fixture)

TOL = 1e-4
BATCH, PROMPT = 4, 10
# arch -> (frontend rows before the prompt, capacity factor override)
ARCHS = {"qwen2-7b": (0, None), "gpt2-117m": (0, None),
         "qwen3-14b": (0, None), "llava-next-mistral-7b": (8, None),
         "olmoe-1b-7b": (0, 4.0)}
MESHES = ["x".join(map(str, s)) for s in MR.TP_MESHES]
# a cache of 25 rows: its sequence does not split over model 2, so every
# rank holds every row, the heads still split
WHOLE_SEQ, WHOLE_SEQ_LEN = "qwen2-7b whole sequence", 25


def _cfgs(arch: str, capacity):
    out = []
    for f in (jax_smoke_config, get_smoke_config):
        cfg = f(arch, dtype="float32")
        if capacity:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=capacity))
        out.append(cfg)
    return out


def _np(cache) -> dict:
    kv = cache["kv"]
    return {"k": np.array(kv.k, np.float32), "v": np.array(kv.v,
                                                               np.float32)}


def _reference(arch: str, seed: int, cache_len: int = R.CACHE_LEN,
               meshes=MR.TP_MESHES) -> tuple:
    """JAX's and the port's single-device runs from the JAX init: the
    ranks' inputs and the logits of both."""
    front, capacity = ARCHS[arch]
    cfg_j, cfg_t = _cfgs(arch, capacity)
    jm, tm = jax_build_model(cfg_j), build_model(cfg_t)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    tp = params_from_numpy(params)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg_j.vocab, (BATCH, PROMPT - front)).astype(
        np.int32)
    embeds = (rng.standard_normal((BATCH, front, cfg_j.d_model)).astype(
        np.float32) if front else None)
    jcache = jm.init_cache(BATCH, cache_len)
    tcache = cache_from_numpy(jax.device_get(jcache))
    kw_j = {} if embeds is None else {"embeds": jnp.asarray(embeds)}
    kw_t = {} if embeds is None else {"embeds": torch.from_numpy(embeds)}
    jl, jcache = jax.jit(jm.prefill)(params, jnp.asarray(tokens), jcache,
                                     **kw_j)
    tl, tcache = tm.prefill(tp, torch.from_numpy(tokens).long(), tcache,
                            **kw_t)
    logits = {"prefill": (tl.numpy(), np.asarray(jl))}
    case = dict(arch=arch, cache_len=cache_len, meshes=list(meshes),
                params=params, tokens=tokens, embeds=embeds,
                capacity_factor=capacity, cache_prefill=_np(tcache),
                decode_tokens=[])
    dec = jax.jit(jm.decode_step)
    for i in range(R.STEPS):
        tok = np.asarray(jnp.argmax(jl[:, -1, :], axis=-1)).astype(
            np.int32)[:, None]
        case["decode_tokens"].append(tok)
        jl, jcache = dec(params, jcache, jnp.asarray(tok))
        tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok).long())
        logits[f"decode {i}"] = (tl.numpy(), np.asarray(jl))
    case["cache_final"] = _np(tcache)
    assert tcache["pos"] == PROMPT + R.STEPS
    return case, logits


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    torch.set_num_threads(1)
    cases, refs = {}, {}
    for i, arch in enumerate(ARCHS):
        cases[arch], refs[arch] = _reference(arch, i)
    cases[WHOLE_SEQ], refs[WHOLE_SEQ] = _reference(
        "qwen2-7b", 0, WHOLE_SEQ_LEN, [(4, 2)])
    out = tmp_path_factory.mktemp("serve")
    MR.spawn(cases, str(out), target=R.worker)
    return dict(res=json.loads((out / "results.json").read_text()),
                arrs=dict(np.load(out / "arrays.npz")), refs=refs)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_mesh_serving_logits_match_one_device_and_jax(served, arch, mesh):
    """The logits after the prefill and after each of 16 decode steps, the
    same on every rank of a model group, within ``TOL`` of their largest
    entry of the port's single-device run and of JAX's."""
    tag = f"{arch} {mesh}"
    rec = served["res"][tag]
    worst = {"port": 0.0, "jax": 0.0}
    for what, (port, jax_) in served["refs"][arch].items():
        got = served["arrs"][f"{tag} {what}"]
        assert got.shape == port.shape and np.isfinite(got).all(), what
        worst["port"] = max(worst["port"], _rel(got, port))
        worst["jax"] = max(worst["jax"], _rel(got, jax_))
    print(f"{tag}: largest logit difference over the largest logit "
          f"{worst['port']:.3e} vs one device, {worst['jax']:.3e} vs JAX; "
          f"spread over the model group {rec['spread']}")
    assert rec["spread"] == 0.0
    assert worst["port"] <= TOL and worst["jax"] <= TOL, worst


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_mesh_serving_cache_blocks_match_one_device(served, arch, mesh):
    """Each rank's block of the cache (its batch rows, its sequence rows
    of every kv head) after the prefill and after the last step within
    ``TOL`` of the largest entry of the single-device cache's rows; the
    cache's sequence is split over ``model`` and the position advanced
    past ``cache_len``."""
    rec = served["res"][f"{arch} {mesh}"]
    print(arch, mesh, rec["cache_err"])
    assert rec["seq_split"] and rec["cache_pos"] == PROMPT + R.STEPS
    assert max(rec["cache_err"].values()) <= TOL, rec["cache_err"]


def test_mesh_serving_with_the_sequence_whole(served):
    """A cache whose length does not divide by the model ranks (25 rows
    on (4, 2)) keeps every row on every rank: the heads split as before,
    each rank writes every prompt row of every kv head (its kv heads
    all-gathered) and decode attends over all rows alone; the logits and
    the cache within ``TOL``, nothing but the gathers of the split
    route."""
    rec = served["res"][f"{WHOLE_SEQ} 4x2"]
    worst = 0.0
    for what, (port, jax_) in served["refs"][WHOLE_SEQ].items():
        got = served["arrs"][f"{WHOLE_SEQ} 4x2 {what}"]
        worst = max(worst, _rel(got, port), _rel(got, jax_))
    print(f"whole sequence: {worst:.3e}, cache {rec['cache_err']}")
    assert not rec["seq_split"] and rec["spread"] == 0.0
    assert rec["cache_pos"] == PROMPT + R.STEPS
    assert worst <= TOL and max(rec["cache_err"].values()) <= TOL
    assert rec["moved_blocks"] == [] and rec["whole_route"] == 0
    assert rec["routes"]["decode"]["blocks/attn/wk"] == "block"


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_serving_gathers_no_block_and_no_cache(served, mesh):
    """The spy: no leaf on the "block" route reaches the model other than
    as its stored block, no collective reads a cache block, and the whole
    route's gathers never run, for every model; on (4, 2) every
    attention, MLP and vocabulary leaf of the dense models is a block and
    each rank's prefill attention sees 2 q heads over 1 kv head, on (2,
    4) and (1, 8) one over one (the ranks without a head on (1, 8) run no
    attention kernel)."""
    for arch in ARCHS:
        rec = served["res"][f"{arch} {mesh}"]
        assert rec["moved_blocks"] == [], (arch, rec["moved_blocks"])
        assert rec["cache_collectives"] == 0 and rec["whole_route"] == 0
        routes = rec["routes"]["decode"]
        if arch != "olmoe-1b-7b":
            mlp = {k: r for k, r in routes.items() if "/mlp/w_" in k}
            assert set(mlp.values()) == {"block"}, mlp
        kv = routes["blocks/attn/wk"]
        assert kv == ("block" if mesh == "4x2" else "slice"), (arch, kv)
    heads = {tuple(h) for h in served["res"][f"qwen2-7b {mesh}"]["heads"]}
    want = {"4x2": {(2, 1)}, "2x4": {(1, 1)}, "1x8": {(1, 1)}}
    assert heads == want[mesh], heads
