"""Whisper on a model axis and Zamba2's ``long_500k`` layout: the encoder's
attention, the decoder's self and cross attention, both MLPs and the tied
vocabulary split over ``model`` (``models/whisper.py``,
``attention.cross_attn_split``) in the mesh step and in serving, and the
KV cache's sequence split over (data, model) with decode combined over
both, on 8 gloo ranks on the CPU (``_torch_whisper_ranks.py``, one
spawn), against the gather design (every leaf whole), the single-device
port and the JAX package from the same init.

Cases: the smoke Whisper (4 q / 2 kv heads, ``enc_seq`` 32, vocab 512)
on the meshes (data, model) (4, 2), (2, 4) and (1, 8) (at (1, 8) half the
ranks hold no head); a variant with ``enc_seq`` 20 and vocab 510 on (1,
8), neither dividing by 8, so the cross cache is stored whole on every
rank and ``embed`` is not split, as Whisper-large-v3's 1500 frames and
51,866 rows are over 16 ranks; and the smoke Zamba2 with the
``long_500k`` cache specs (B = 1, the KV sequence over (data, model)) on
(2, 4) and (4, 2): a prompt of ``LONG_PROMPT`` tokens ending inside the
block of rank 3 (the last of the first model group at (2, 4), of the
second at (4, 2)), then 8 decode steps that cross into the next data
group's block.  In fp32 compute, where the routes differ in summation
order only:

  * Whisper training: one step's gradient blocks within ``TRAIN_TOL`` =
    1e-3 of each leaf's largest entry of the gather design's, the
    encoder's and the cross attention's included, under remat none (and
    full on (1, 8)); 2 Adapprox steps' losses within rtol 1e-3 of the
    gather design's, of the run without a mesh and (the first) of JAX's
    loss, the parameters after them within 1e-3;
  * serving: Whisper a prefill of 4 x 32 tokens (and 4 x ``enc_seq``
    frames) into a 48-row cache and 8 decode steps, Zamba2 1 x
    ``LONG_PROMPT`` into ``LONG_CACHE`` rows and 8 steps: the logits within
    ``SERVE_TOL`` = 1e-4 of their largest entry of the single-device
    port's and JAX's, the same on every rank of a model group, and each
    rank's block of every cache leaf (``kv``, ``cross``, the Mamba
    states) within 1e-4 of its block of the single-device cache;
  * the routes: no leaf on the "block" route is gathered over ``model``;
    no collective reads a cache's storage (no KV or cross row moves), and
    nothing takes the whole route.
"""
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as MR
import _torch_whisper_ranks as R
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro_torch.checkpoint.serialization import leaves_with_paths
from repro_torch.convert import params_from_numpy
from repro_torch.models.model_zoo import build_model
from _torch_threads import one_thread  # noqa: F401 (autouse fixture)

TRAIN_TOL, SERVE_TOL, RTOL = 1e-3, 1e-4, 1e-3
DECODE = 8
# Zamba2's long context: 9 rows a rank of 72; the prompt (a multiple of
# the SSD chunk, 16) ends in the block of rows [27, 36), decode writes
# rows 32 .. 39, past the second data group's first row, 36 (of either
# mesh)
LONG_PROMPT, LONG_CACHE = 32, 72
# name -> (arch, config overrides, meshes, trained, long context)
CASES = {"whisper": ("whisper-large-v3", {}, MR.TP_MESHES, True, False),
         "whisper enc20": ("whisper-large-v3", {"enc_seq": 20,
                                                "vocab": 510},
                           [(1, 8)], True, False),
         "zamba2 long": ("zamba2-2.7b", {}, [(2, 4), (4, 2)], False, True)}
RUNS = [(name, "x".join(map(str, s))) for name, (_, _, meshes, _, _)
        in CASES.items() for s in meshes]
RUN_IDS = [f"{n}-{m}" for n, m in RUNS]
TRAIN_RUNS = [r for r in RUNS if CASES[r[0]][3]]
TRAIN_IDS = [f"{n}-{m}" for n, m in TRAIN_RUNS]
WHISPER_RUNS = [r for r in RUNS if not CASES[r[0]][4]]
WHISPER_IDS = [f"{n}-{m}" for n, m in WHISPER_RUNS]


def _cache_np(cache) -> dict:
    return {p: np.array(t, np.float32) for p, t in leaves_with_paths(cache)
            if isinstance(t, torch.Tensor)}


def _inputs(name: str, seed: int) -> tuple:
    """The case's inputs for the ranks (the JAX init, seeded batches and
    frames, prompt and decode tokens, the single-device port's caches)
    and the single-device port's serving logits."""
    arch, over, meshes, trained, long_context = CASES[name]
    cfg_j = jax_smoke_config(arch, dtype="float32", **over)
    params = jax.device_get(jax_build_model(cfg_j).init(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    b, s = (1, LONG_PROMPT) if long_context else (4, 32)
    frames = lambda *lead: rng.standard_normal(  # noqa: E731
        lead + (cfg_j.enc_seq, cfg_j.d_model)).astype(np.float32)
    case = dict(arch=arch, over=over, meshes=list(meshes),
                params=params, long_context=long_context,
                cache_len=LONG_CACHE if long_context else 48,
                batches=rng.integers(0, cfg_j.vocab, (
                    R.TRAIN_STEPS, R.BATCH, R.SEQ)).astype(np.int32)
                if trained else None,
                embeds=frames(R.TRAIN_STEPS, R.BATCH) if trained else None,
                tokens=rng.integers(0, cfg_j.vocab, (b, s)).astype(np.int32),
                serve_embeds=None if long_context else frames(b),
                decode_tokens=list(rng.integers(0, cfg_j.vocab, (
                    DECODE, b, 1)).astype(np.int32)))
    tm = build_model(R.make_config(case))
    tp = params_from_numpy(params)
    kw = ({} if long_context else
          {"embeds": torch.from_numpy(case["serve_embeds"])})
    with torch.inference_mode():
        tl, tcache = tm.prefill(tp, torch.from_numpy(case["tokens"]).long(),
                                tm.init_cache(b, case["cache_len"]), **kw)
        case["cache_prefill"] = _cache_np(tcache)
        port = {"prefill": tl.numpy()}
        for i, tok in enumerate(case["decode_tokens"]):
            tl, tcache = tm.decode_step(tp, tcache,
                                        torch.from_numpy(tok).long())
            port[f"decode {i}"] = tl.numpy()
    case["cache_final"] = _cache_np(tcache)
    return case, port


def _jax_reference(case: dict) -> tuple:
    """JAX's first loss (None for an untrained case) and serving logits on
    the case's inputs."""
    cfg_j = jax_smoke_config(case["arch"], dtype="float32", **case["over"])
    jm = jax_build_model(cfg_j)
    jp = jax.tree.map(jnp.asarray, case["params"])
    loss = None
    if case["batches"] is not None:
        loss = float(jax.jit(jm.loss)(jp, {
            "tokens": jnp.asarray(case["batches"][0]),
            "embeds": jnp.asarray(case["embeds"][0])})[0])
    tokens = jnp.asarray(case["tokens"])
    cache = jm.init_cache(tokens.shape[0], case["cache_len"])
    if case["serve_embeds"] is None:
        jl, jcache = jax.jit(jm.prefill)(jp, tokens, cache)
    else:
        jl, jcache = jax.jit(jm.prefill)(jp, tokens, cache,
                                         jnp.asarray(case["serve_embeds"]))
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
    out = tmp_path_factory.mktemp("whisper")
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


@pytest.mark.parametrize("name,mesh", TRAIN_RUNS, ids=TRAIN_IDS)
def test_split_gradients_match_gather_design(ranks, name, mesh):
    """Every gradient block of one step on the split route within
    ``TRAIN_TOL`` of its largest entry of the gather design's: the
    encoder's attention and MLP, the decoder's self and cross attention
    (the encoder's output reaching each layer's cross attention through
    ``copy_to``) and MLP, the tied embedding and the rest; under remat
    full too on (1, 8)."""
    rec = ranks["res"][f"{name} {mesh} train"]
    for remat in ("none", "full") if mesh == "1x8" else ("none",):
        errs = rec[f"grads_{remat}"]
        print(name, mesh, remat, f"worst {max(errs.values()):.3e}")
        assert {"enc_blocks/attn/wq", "enc_blocks/mlp/w_up",
                "dec_blocks/cross_attn/wk", "dec_blocks/cross_attn/wo",
                "dec_blocks/self_attn/wv", "embed", "enc_pos"} <= set(errs)
        assert max(errs.values()) <= TRAIN_TOL, errs


@pytest.mark.parametrize("name,mesh", TRAIN_RUNS, ids=TRAIN_IDS)
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


@pytest.mark.parametrize("name,mesh", WHISPER_RUNS, ids=WHISPER_IDS)
def test_split_routes_move_no_block(ranks, name, mesh):
    """Each Whisper leaf's route: the MLPs "block" on every mesh, the
    attention leaves "block" where the rank's heads are its stored block
    ((4, 2); q and the output at (2, 4)) and "slice" (gathered whole)
    where they are not (kv at (2, 4), every attention leaf at (1, 8)),
    ``embed`` "block" where the vocabulary divides, else not a split
    product.  In training, the prefill and decode no "block" leaf is
    gathered over ``model``."""
    train = ranks["res"][f"{name} {mesh} train"]
    serve = ranks["res"][f"{name} {mesh} serve"]
    m = int(mesh.split("x")[1])
    q_block, kv_block = 4 % m == 0, 2 % m == 0
    for routes in (train["routes"], serve["routes"]["prefill"]):
        for path in ("enc_blocks/attn", "dec_blocks/self_attn",
                     "dec_blocks/cross_attn"):
            for k, aligned in (("wq", q_block), ("wo", q_block),
                               ("wk", kv_block), ("wv", kv_block)):
                assert routes[f"{path}/{k}"] == (
                    "block" if aligned else "slice"), (path, k)
        for path in ("enc_blocks/mlp", "dec_blocks/mlp"):
            assert routes[f"{path}/w_up"] == "block"
            assert routes[f"{path}/w_down"] == "block"
        assert routes["embed"] == ("block" if name == "whisper" else
                                   "whole")
    for routes, moved in ((train["routes"], train["moved"]),
                          (serve["routes"]["prefill"],
                           serve["moved"]["prefill"]),
                          (serve["routes"]["decode"],
                           serve["moved"]["decode"])):
        blocks = {k for k, r in routes.items() if r == "block"}
        assert not blocks & set(moved), sorted(blocks & set(moved))
    assert not {k for k in serve["moved"]["decode"]
                if k.startswith("dec_blocks/cross_attn/w")
                and k[-2:] in ("wk", "wv")}


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
    """Each rank's block of every cache leaf after the prefill and after
    the last step within ``SERVE_TOL`` of its block of the single-device
    cache: the KV cache's rows of every kv head (its sequence over
    ``model``, or over (data, model) for Zamba2's long context), the
    cross cache's encoder rows over ``model`` (or every row where 20 does
    not divide by 8), the Mamba states' heads."""
    rec = ranks["res"][f"{name} {mesh} serve"]
    print(name, mesh, rec["cache_err"])
    prompt = LONG_PROMPT if CASES[name][4] else 32
    assert rec["cache_pos"] == prompt + DECODE
    want = {"prefill ['kv'].k", "final ['kv'].v"}
    want |= ({"final ['mamba'].ssm"} if CASES[name][4]
             else {"prefill ['cross']", "final ['cross']"})
    assert want <= set(rec["cache_err"])
    assert max(rec["cache_err"].values()) <= SERVE_TOL, rec["cache_err"]


@pytest.mark.parametrize("name,mesh", RUNS, ids=RUN_IDS)
def test_split_serving_moves_no_cache_row(ranks, name, mesh):
    """No collective reads a cache's storage, in the prefill or in decode
    (no KV or cross row moves), and nothing takes the whole route.  The
    KV sequence's group: ``model`` for Whisper; for Zamba2's long context
    all 8 ranks, rank r (data index r // M, model index r % M) holding
    rows ``[9 r, 9 r + 9)`` of the 72."""
    rec = ranks["res"][f"{name} {mesh} serve"]
    assert rec["cache_collectives"] == {"prefill": 0, "decode": 0}
    assert rec["whole_route"] == 0
    if CASES[name][4]:
        assert rec["seq_size"] == 8
        assert rec["seq_rows"] == [[9 * r, 9] for r in range(8)]
    else:
        m = int(mesh.split("x")[1])
        assert rec["seq_size"] == m
        assert rec["seq_rows"] == [[48 // m * (r % m), 48 // m]
                                   for r in range(8)]
