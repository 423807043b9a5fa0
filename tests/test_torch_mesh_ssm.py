"""The ssm and hybrid families on a model axis: Mamba2's heads split over
``model`` (``models/mamba2.py``: ``in_proj``, the conv, the gated norm,
``out_proj``, the Mamba states) and Zamba2's shared attention + MLP
through the transformer's split, in the mesh step and in serving, on 8
gloo ranks on the CPU (``_torch_ssm_ranks.py``, one spawn), against the
gather design (every leaf whole), the single-device port and the JAX
package from the same init.

Cases: the smoke Mamba2-370m (8 SSM heads of 16) and Zamba2-2.7B (8 SSM
heads; shared attention of 4 q / 2 kv heads) on the meshes (data, model)
(4, 2), (2, 4) and (1, 8) (at (1, 8) half the ranks hold no attention
head), and the smoke Mamba2 at SSM head_dim 32 on (1, 8): 4 heads over 8
ranks, so half the ranks hold no SSM head, the ssm state is stored whole
(each rank's heads concatenated over the axis) and ``in_proj``'s columns
do not split. In fp32 compute, where the routes differ in summation
order only (the gated norm's and ``out_proj``'s sums over ``model``):

  * training: one step's gradient blocks within ``TRAIN_TOL`` = 1e-3 of
    each leaf's largest entry of the gather design's, ``a_log`` /
    ``d_skip`` / ``dt_bias`` and the shared block included, under remat
    none (and full on (1, 8)); 2 Adapprox steps' losses (a refresh, then
    a fold) within rtol 1e-3 of the gather design's, of the run without
    a mesh and (the first) of JAX's loss, the parameters after them
    within 1e-3;
  * serving: a prefill of 4 x 32 tokens into a 48-row cache and 8 decode
    steps fed seeded tokens, the logits within ``SERVE_TOL`` = 1e-4
    of their largest entry of the single-device port's and JAX's, the
    same on every rank of a model group, and each rank's block of every
    cache leaf within 1e-4 of its block of the single-device cache;
  * the routes: no leaf on the "block" route is gathered over ``model``;
    the Mamba2 decode step gathers no Mamba weight over it.

Besides, without a spawn: the KV caches' sequence axis read from the
``kv`` leaves only (the Mamba ssm state is 5-d too), and the groups a
rank's heads read handed to B7.
"""
import dataclasses
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as MR
import _torch_ssm_ranks as R
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro_torch.checkpoint.serialization import leaves_with_paths
from repro_torch.convert import params_from_numpy
from repro_torch.distributed import sharding as SH
from repro_torch.models import mamba2 as M
from repro_torch.models.layers import ModelSplit
from repro_torch.models.model_zoo import build_model
from _torch_threads import one_thread  # noqa: F401 (autouse fixture)

TRAIN_TOL, SERVE_TOL, RTOL = 1e-3, 1e-4, 1e-3
PROMPT, SERVE_BATCH = 32, 4
# name -> (arch, SSM head_dim override, meshes)
CASES = {"mamba2": ("mamba2-370m", None, MR.TP_MESHES),
         "zamba2": ("zamba2-2.7b", None, MR.TP_MESHES),
         "mamba2 hd32": ("mamba2-370m", 32, [(1, 8)])}
RUNS = [(name, "x".join(map(str, s))) for name, (_, _, meshes)
        in CASES.items() for s in meshes]
RUN_IDS = [f"{n}-{m}" for n, m in RUNS]


def _cache_np(cache) -> dict:
    return {p: np.array(t, np.float32) for p, t in leaves_with_paths(cache)
            if isinstance(t, torch.Tensor)}


def _inputs(name: str, seed: int) -> tuple:
    """The case's inputs for the ranks (the JAX init, seeded batches,
    prompt and decode tokens, the single-device port's caches) and the
    single-device port's serving logits."""
    arch, hd, meshes = CASES[name]
    cfg_j = R.with_ssm_head_dim(jax_smoke_config(arch, dtype="float32"), hd)
    tm = build_model(R.make_config(arch, hd))
    params = jax.device_get(jax_build_model(cfg_j).init(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    case = dict(arch=arch, ssm_head_dim=hd, meshes=list(meshes),
                params=params,
                batches=rng.integers(0, cfg_j.vocab, (
                    R.TRAIN_STEPS, R.BATCH, R.SEQ)).astype(np.int32),
                tokens=rng.integers(0, cfg_j.vocab, (
                    SERVE_BATCH, PROMPT)).astype(np.int32),
                decode_tokens=list(rng.integers(0, cfg_j.vocab, (
                    R.DECODE, SERVE_BATCH, 1)).astype(np.int32)))
    tp = params_from_numpy(params)
    with torch.inference_mode():
        tl, tcache = tm.prefill(tp, torch.from_numpy(case["tokens"]).long(),
                                tm.init_cache(SERVE_BATCH, R.CACHE_LEN))
        case["cache_prefill"] = _cache_np(tcache)
        port = {"prefill": tl.numpy()}
        for i, tok in enumerate(case["decode_tokens"]):
            tl, tcache = tm.decode_step(tp, tcache,
                                        torch.from_numpy(tok).long())
            port[f"decode {i}"] = tl.numpy()
    case["cache_final"] = _cache_np(tcache)
    return case, port


def _jax_reference(case: dict) -> tuple:
    """JAX's first loss and serving logits on the case's inputs."""
    cfg_j = R.with_ssm_head_dim(jax_smoke_config(case["arch"],
                                                 dtype="float32"),
                                case["ssm_head_dim"])
    jm = jax_build_model(cfg_j)
    jp = jax.tree.map(jnp.asarray, case["params"])
    loss = float(jax.jit(jm.loss)(jp, {"tokens": jnp.asarray(
        case["batches"][0])})[0])
    jl, jcache = jax.jit(jm.prefill)(jp, jnp.asarray(case["tokens"]),
                                     jm.init_cache(SERVE_BATCH, R.CACHE_LEN))
    logits = {"prefill": np.asarray(jl)}
    dec = jax.jit(jm.decode_step)
    for i, tok in enumerate(case["decode_tokens"]):
        jl, jcache = dec(jp, jcache, jnp.asarray(tok))
        logits[f"decode {i}"] = np.asarray(jl)
    return logits, loss


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks' results, the single-device port's and JAX's references;
    JAX's are computed while the ranks run."""
    torch.set_num_threads(1)
    cases, port = {}, {}
    for i, name in enumerate(CASES):
        cases[name], port[name] = _inputs(name, i)
    out = tmp_path_factory.mktemp("ssm")
    failed = []

    def run_ranks():
        try:
            MR.spawn(cases, str(out), target=R.worker)
        except BaseException as e:  # noqa: BLE001 -- raised below
            failed.append(e)

    ranks_run = threading.Thread(target=run_ranks)
    ranks_run.start()
    try:
        jax_refs = {name: _jax_reference(case)
                    for name, case in cases.items()}
    finally:
        ranks_run.join()
    if failed:
        raise failed[0]
    refs = {name: {what: (port[name][what], jax_refs[name][0][what])
                   for what in port[name]} for name in cases}
    return dict(res=json.loads((out / "results.json").read_text()),
                arrs=dict(np.load(out / "arrays.npz")), refs=refs,
                jax_loss={name: jax_refs[name][1] for name in cases})


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _mamba_leaves(name: str) -> set:
    keys = {"in_proj", "conv_w", "conv_b", "a_log", "d_skip", "dt_bias",
            "norm_w", "out_proj"}
    return {f"layers/mamba/{k}" for k in keys}


@pytest.mark.parametrize("name,mesh", RUNS, ids=RUN_IDS)
def test_split_gradients_match_gather_design(ranks, name, mesh):
    """Every gradient block of one step on the split route within
    ``TRAIN_TOL`` of its largest entry of the gather design's: the Mamba
    leaves (``a_log``, ``d_skip`` and ``dt_bias`` summed over ``model``
    though each rank uses its heads' part), Zamba2's shared attention and
    MLP (their blocks added over the application points), the vocabulary
    and the rest; under remat full too on (1, 8)."""
    rec = ranks["res"][f"{name} {mesh} train"]
    for remat in ("none", "full") if mesh == "1x8" else ("none",):
        errs = rec[f"grads_{remat}"]
        print(name, mesh, remat, f"worst {max(errs.values()):.3e}")
        assert _mamba_leaves(name) <= set(errs)
        if name == "zamba2":
            assert {"shared/attn/wq", "shared/attn/wk", "shared/mlp/w_up",
                    "shared/mlp/w_down"} <= set(errs)
        assert max(errs.values()) <= TRAIN_TOL, errs


@pytest.mark.parametrize("name,mesh", RUNS, ids=RUN_IDS)
def test_split_training_matches_gather_one_device_and_jax(ranks, name, mesh):
    """Two Adapprox steps on the split route (a refresh, then a fold):
    the losses within rtol 1e-3 of the gather design's on the same mesh,
    of the run without a mesh and (the first) of JAX's loss; the
    parameter blocks after them within 1e-3 of the gather design's."""
    rec = ranks["res"][f"{name} {mesh} train"]
    ref = ranks["res"][f"{name} no mesh"]
    got = np.array(rec["losses"])
    print(name, mesh, got, rec["gather_losses"], ref,
          ranks["jax_loss"][name], f"params {rec['params_err']:.3e}")
    np.testing.assert_allclose(got, rec["gather_losses"], rtol=RTOL)
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    np.testing.assert_allclose(got[0], ranks["jax_loss"][name], rtol=RTOL)
    assert rec["params_err"] <= TRAIN_TOL


@pytest.mark.parametrize("name,mesh", RUNS, ids=RUN_IDS)
def test_split_routes_move_no_aligned_block(ranks, name, mesh):
    """Each Mamba leaf's route: ``norm_w`` / ``out_proj`` "block" where
    the rank's heads are its stored block, ``in_proj`` and the conv
    "slice" (gathered whole: their blocks are not a rank's heads), the
    replicated per-head leaves "slice" (their gradient summed over
    ``model``).  In training and in the prefill no "block" leaf is
    gathered over ``model``; in decode ``in_proj`` and the conv never
    are, and no Mamba leaf is where the heads align with the blocks (at
    SSM head_dim 32 on (1, 8) ``norm_w`` and ``out_proj`` are "slice"
    leaves, gathered whole as in the prefill)."""
    train = ranks["res"][f"{name} {mesh} train"]
    serve = ranks["res"][f"{name} {mesh} serve"]
    aligned = CASES[name][1] is None
    for routes, moved in ((train["routes"], train["moved"]),
                          (serve["routes"]["prefill"],
                           serve["moved"]["prefill"])):
        for k in ("in_proj", "conv_w", "conv_b", "a_log", "d_skip",
                  "dt_bias"):
            assert routes[f"layers/mamba/{k}"] == "slice", k
        for k in ("norm_w", "out_proj"):
            assert routes[f"layers/mamba/{k}"] == (
                "block" if aligned else "slice"), k
        blocks = {k for k, r in routes.items() if r == "block"}
        assert not blocks & set(moved), sorted(blocks & set(moved))
        assert set(moved) <= {k for k, r in routes.items()
                              if r in ("slice", "gather")}
    decode = {k for k in serve["moved"]["decode"]
              if k.startswith("layers/mamba/")}
    assert not decode & {f"layers/mamba/{k}" for k in M.STORED}, decode
    if aligned:
        assert not decode, decode
    if name == "zamba2":
        assert train["routes"]["shared/mlp/w_up"] == "block"
        assert train["routes"]["embed"] == "block"


@pytest.mark.parametrize("name,mesh", RUNS, ids=RUN_IDS)
def test_split_serving_logits_match_one_device_and_jax(ranks, name, mesh):
    """The logits after the prefill and after each of 8 decode steps, the
    same on every rank of a model group, within ``SERVE_TOL`` of their
    largest entry of the single-device port's and of JAX's."""
    tag = f"{name} {mesh}"
    rec = ranks["res"][f"{tag} serve"]
    worst = {"port": 0.0, "jax": 0.0}
    for what, (port, jax_) in ranks["refs"][name].items():
        got = ranks["arrs"][f"{tag} {what}"]
        assert got.shape == port.shape and np.isfinite(got).all(), what
        worst["port"] = max(worst["port"], _rel(got, port))
        worst["jax"] = max(worst["jax"], _rel(got, jax_))
    print(f"{tag}: {worst}, spread {rec['spread']}")
    assert rec["spread"] == 0.0
    assert worst["port"] <= SERVE_TOL and worst["jax"] <= SERVE_TOL, worst


@pytest.mark.parametrize("name,mesh", RUNS, ids=RUN_IDS)
def test_split_serving_cache_blocks_match_one_device(ranks, name, mesh):
    """Each rank's block of every cache leaf (the Mamba conv state's
    channels, the ssm state's heads, the KV cache's rows of every kv head)
    after the prefill and after the last step within ``SERVE_TOL`` of its
    block of the single-device cache; Zamba2's KV sequence split over
    ``model``."""
    rec = ranks["res"][f"{name} {mesh} serve"]
    print(name, mesh, rec["cache_err"])
    assert rec["cache_pos"] == PROMPT + R.DECODE
    assert rec["seq_split"] == (name == "zamba2")
    assert {"prefill ['mamba'].ssm", "final ['mamba'].conv"} <= set(
        rec["cache_err"])
    assert max(rec["cache_err"].values()) <= SERVE_TOL, rec["cache_err"]


def test_cache_seq_axis_reads_the_kv_leaves_only():
    """The KV caches' sequence axis comes from the ``kv`` leaves alone: the
    Mamba ssm state (L, B, H, P, N) is 5-d, its axis 2 heads.  Zamba2's
    ``long_500k`` cache (sequence over (data, model), state heads over
    ``model``) reads (data, model), where reading every 5-d leaf raised;
    Zamba2's 32k caches read
    ``model``; Mamba2's (no KV cache) read ()."""
    mesh = {"data": 2, "model": 4}
    for arch, long_context, want in (("zamba2-2.7b", True, ("data", "model")),
                                     ("zamba2-2.7b", False, ("model",)),
                                     ("mamba2-370m", True, ()),
                                     ("mamba2-370m", False, ())):
        model = build_model(R.make_config(arch))
        cache = model.init_cache(4, 32)
        specs = SH.cache_pspecs(model.cfg, mesh, cache, long_context)
        assert SH._cache_seq_axis(SH.bind(specs, None)) == want, arch


@pytest.mark.parametrize("nh,groups,m", [(8, 1, 2), (8, 2, 8), (8, 4, 8),
                                         (12, 4, 8), (6, 3, 4), (4, 1, 8)])
def test_rank_groups_read_what_each_head_reads(nh, groups, m):
    """The B / C groups each rank's heads read, handed to B7: with its
    own mapping (local head i reads local group i // (H_r / G_r)) where
    the heads cover the groups evenly, else expanded per head; either way
    every head reads group h // (H / G), as on one device."""
    cfg = dataclasses.replace(R.make_config("mamba2-370m"), d_model=nh * 8)
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, head_dim=16, n_groups=groups))
    assert M._dims(cfg)[1] == nh
    for r in range(m):
        h0, h1 = ModelSplit(None, r, m).span(nh)
        g0, g1, sel = M._rank_groups(cfg, h0, h1)
        hl = h1 - h0
        if sel is None:
            local = [i // (hl // (g1 - g0)) for i in range(hl)] if hl else []
        else:
            local = sel
        assert [g0 + i for i in local] == [h // (nh // groups)
                                           for h in range(h0, h1)]
