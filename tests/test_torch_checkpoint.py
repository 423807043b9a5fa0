"""The port's checkpointing and corpus source against the JAX package's.

  * ``CorpusLM`` / ``DataIterator``: batches byte-identical to JAX's, with
    wrap-around, host slices and a fast-forwarded start.
  * Format: a port checkpoint lists the JAX package's leaves under its key
    paths, shapes and dtypes, passes its deep verify, and its meta reads
    back the same; a bf16 leaf's file is the bytes numpy writes for an
    ml_dtypes bfloat16 array.
  * JAX -> port: a JAX smoke run's step-6 checkpoint restores in the port
    (``convert.train_state_from_checkpoint``), and the port's steps 7-10
    (fold steps: refresh_every 5) track JAX's own.  Tolerance: the
    parameters' change over the four steps within 1e-4 of each leaf's
    largest change, in fp32 compute (the parity tests' update tolerance),
    ranks and guard counters exactly.
  * Resume: a run preempted by SIGTERM at step 6 and restarted equals the
    straight run bitwise on the CPU, fp32 and bf16 parameters, in process
    (the signal handed on to a Python handler) and in a subprocess (the
    signal re-raised by default).
  * One counterpart for each checkpoint test of ``tests/test_resilience.py``,
    the JAX package's functions reading the port's directories alike.
"""
import dataclasses
import glob
import importlib
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointConfig as JCheckpointConfig
from repro.checkpoint import serialization as JSER
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import build_optimizer as jax_build_optimizer
from repro.data import DataConfig as JDataConfig
from repro.data import DataIterator as JDataIterator
from repro.data.pipeline import CorpusLM as JCorpusLM
from repro.launch.train import optimizer_config as jax_optimizer_config
from repro.models import build_model as jax_build_model
from repro.train import LoopConfig as JLoopConfig
from repro.train import TrainState as JTrainState
from repro.train import train as jax_train
from repro_torch import tree
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.checkpoint import serialization as SER
from repro_torch.configs.archs import get_smoke_config
from repro_torch.convert import train_state_from_checkpoint
from repro_torch.core.adapprox import adapprox_state
from repro_torch.core.build import build_optimizer
from repro_torch.core.factored import FactoredLeaf
from repro_torch.data.pipeline import CorpusLM, DataConfig, DataIterator
from repro_torch.launch import train as launcher
from repro_torch.launch.train import optimizer_config
from repro_torch.models.model_zoo import build_model
from repro_torch.resilience import corrupt_latest_checkpoint, flip_bit
from repro_torch.train.steps import TrainState
from repro_torch.train.train_loop import LoopConfig, train
from _torch_threads import one_thread  # noqa: F401 (autouse fixture)

JA = importlib.import_module("repro.core.adapprox")
ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SMALL = dict(embedding_min_rows=256, sketch_width=256, sketch_depth=2)
SMOKE_ARGV = ["--smoke", "--device", "cpu", "--fused-update",
              "--refresh-every", "5", "--guards", "--max-demotions", "1",
              "--embedding-min-rows", "256", "--sketch-width", "256",
              "--sketch-depth", "2", "--log-every", "1"]


# ---------------------------------------------------------------------------
# corpus source
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("host_slice", [(0, 1), (1, 2)])
def test_corpus_batches_match_jax(tmp_path, host_slice):
    """10 windows of 16 tokens at batch 4: steps 0-5 wrap around the
    corpus; the iterator starts at step 3, as a resumed run does."""
    path = tmp_path / "corpus.npy"
    np.save(path, np.random.default_rng(0).integers(
        0, 1000, size=161, dtype=np.int32))
    kw = dict(vocab=1000, seq_len=16, global_batch=4, kind="corpus",
              corpus_path=str(path))
    src, jsrc = CorpusLM(DataConfig(**kw)), JCorpusLM(JDataConfig(**kw))
    assert src.n_windows == jsrc.n_windows == 10
    for step in range(6):
        a, b = src.batch_at(step)["tokens"], jsrc.batch_at(step)["tokens"]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    it = DataIterator(DataConfig(**kw), start_step=3, host_slice=host_slice)
    jit_ = JDataIterator(JDataConfig(**kw), start_step=3,
                         host_slice=host_slice)
    try:
        for _ in range(3):
            a, b = next(it), next(jit_)
            assert a["step"] == b["step"]
            assert a["tokens"].tobytes() == b["tokens"].tobytes()
            assert a["tokens"].shape == (4 // host_slice[1], 16)
    finally:
        it.close()
        jit_.close()


# ---------------------------------------------------------------------------
# format against the JAX package
# ---------------------------------------------------------------------------

def _jax_paths(jcfg_kw):
    """The key paths, shapes and dtypes of the JAX TrainState of the
    launcher's smoke run (built, not trained)."""
    model = jax_build_model(jax_smoke_config("gpt2-117m", max_seq_len=128))
    st = JTrainState.create(model.init(jax.random.PRNGKey(0)),
                            jax_build_optimizer(jax_optimizer_config(
                                "adapprox", 2, 3e-3, **jcfg_kw)))
    return [(jax.tree_util.keystr(kp), list(np.shape(x)), str(x.dtype))
            for kp, x in jax.tree_util.tree_flatten_with_path(st)[0]]


def test_port_checkpoint_passes_jax_deep_verify(tmp_path):
    """The launcher's smoke run with --guards --max-demotions 1 --ckpt-dir:
    every leaf of its checkpoint under the JAX state's key path, shape and
    dtype; JAX's deep verify passes and its read_meta reads the port's
    meta back."""
    launcher.main(SMOKE_ARGV + ["--steps", "2", "--ckpt-dir",
                                str(tmp_path), "--ckpt-every", "2"])
    (step_dir,) = SER.list_checkpoints(tmp_path)
    manifest = json.loads((step_dir / "manifest.json").read_text())
    assert manifest["format"] == "sharded-v2" and manifest["step"] == 2
    assert manifest["mesh_axes"] == {}
    assert set(manifest) == {"step", "treedef", "paths", "leaves", "meta",
                             "mesh_axes", "format"}
    ours = [(p, leaf["shape"], leaf["dtype"])
            for p, leaf in zip(manifest["paths"], manifest["leaves"])]
    assert ours == _jax_paths(dict(refresh_every=5, fused_update=True,
                                   mixed_groups=True, guards=True,
                                   max_demotions=1, **SMALL))
    assert all(leaf["spec"] is None for leaf in manifest["leaves"])
    assert JSER.verify_checkpoint(step_dir, deep=True)
    assert JSER.checkpoint_step(step_dir) == 2

    mgr = CheckpointManager(CheckpointConfig(directory=str(tmp_path / "m"),
                                             async_save=False))
    meta = {"preempted": True, "note": "x", "n": 3}
    mgr.save({"w": torch.ones(3), "step": 3}, 3, extra_meta=meta)
    (m_dir,) = SER.list_checkpoints(tmp_path / "m")
    assert JSER.read_meta(m_dir) == SER.read_meta(m_dir) == meta
    assert JSER.verify_checkpoint(m_dir, deep=True)


def test_bf16_leaves_are_the_bytes_numpy_writes(tmp_path):
    """A bf16 tensor is written as numpy writes the ml_dtypes bfloat16
    array (descr '<V2', manifest dtype "bfloat16"), without ml_dtypes, and
    a bf16 / int8 / int / fp32 tree restores bitwise."""
    vals = np.random.default_rng(1).standard_normal(37).astype(
        ml_dtypes.bfloat16)
    t = torch.from_numpy(vals.view(np.int16).copy()).view(torch.bfloat16)
    tree_ = {"bf": t, "i8": torch.arange(-4, 4, dtype=torch.int8),
             "f": torch.linspace(0, 1, 5), "n": 7}
    step_dir = SER.save_pytree(tree_, tmp_path, 1)
    manifest = json.loads((step_dir / "manifest.json").read_text())
    by_path = dict(zip(manifest["paths"], manifest["leaves"]))
    entry = by_path["['bf']"]
    assert entry["dtype"] == "bfloat16"
    np.save(tmp_path / "ref.npy", vals)
    assert ((step_dir / entry["file"]).read_bytes()
            == (tmp_path / "ref.npy").read_bytes())
    assert JSER.verify_checkpoint(step_dir, deep=True)
    back = SER.restore_pytree(step_dir, tree_)
    for k in ("bf", "i8", "f"):
        assert back[k].dtype == tree_[k].dtype
        assert torch.equal(back[k], tree_[k])
    assert back["n"] == 7
    # the JAX package's own bf16 leaf (ml_dtypes on its side) loads too
    jdir = JSER.save_pytree({"bf": jax.numpy.asarray(vals)}, tmp_path / "j",
                            1)
    assert torch.equal(SER.restore_pytree(jdir, {"bf": t})["bf"], t)


def _smoke_fp32():
    cfg = jax_smoke_config("gpt2-117m", max_seq_len=128)
    return dataclasses.replace(cfg, dtype="float32")


def test_jax_checkpoint_restores_and_continues(tmp_path):
    """JAX trains 10 steps (mixed groups, fused update, refresh_every 5,
    guards) saving at step 6; the port restores that checkpoint and runs
    steps 7-10, fold steps only, and tracks JAX's own steps 7-10."""
    jcfg = _smoke_fp32()
    jmodel = jax_build_model(jcfg)
    kw = dict(refresh_every=5, fused_update=True, mixed_groups=True,
              guards=True, **SMALL)
    data = dict(vocab=jcfg.vocab, seq_len=128, global_batch=4)
    jstate, _ = jax_train(
        jmodel, jax_build_optimizer(jax_optimizer_config("adapprox", 10,
                                                         3e-3, **kw)),
        JDataConfig(**data),
        JLoopConfig(total_steps=10, log_every=1, ckpt=JCheckpointConfig(
            directory=str(tmp_path), save_every=6, async_save=False)))
    step6 = tmp_path / "step_000000006"
    assert JSER.verify_checkpoint(step6, deep=True)

    model = build_model(dataclasses.replace(get_smoke_config(
        "gpt2-117m", max_seq_len=128), dtype="float32"))
    opt = build_optimizer(optimizer_config("adapprox", 10, 3e-3, **kw))
    like = TrainState.create(model.init(torch.Generator().manual_seed(1)),
                             opt)
    state = train_state_from_checkpoint(step6, like)
    assert state.step == 6 and adapprox_state(state.opt_state).step == 6
    at6 = {k: p.detach().clone() for k, p in state.params.items()}
    state, _ = train(model, opt, DataConfig(**data),
                     LoopConfig(total_steps=10, log_every=1), device=CPU,
                     state=state)
    assert state.step == 10
    jflat = tree.flatten(jax.device_get(jstate.params))
    for k, p in state.params.items():
        want = jflat[k] - at6[k].numpy()
        got = (p.detach() - at6[k]).numpy()
        np.testing.assert_allclose(
            got, want, rtol=0, err_msg=k,
            atol=1e-4 * max(float(np.abs(want).max()), 1e-30))
    ta = adapprox_state(state.opt_state)
    ja = jax.device_get(JA.adapprox_state(jstate.opt_state))
    assert [leaf.k.tolist() for leaf in ta.leaves
            if isinstance(leaf, FactoredLeaf)] == [
        np.asarray(leaf.k).tolist() for leaf in ja.leaves
        if hasattr(leaf, "q")]
    for f in ("trips", "force_refresh", "demoted", "trip_total",
              "demotions"):
        assert getattr(ta.guards, f).tolist() == np.asarray(
            getattr(ja.guards, f)).tolist(), f
    assert (state.opt_state.steps, state.opt_state.skipped) == (
        int(jstate.opt_state.steps), int(jstate.opt_state.skipped))


# ---------------------------------------------------------------------------
# resume, bitwise on the CPU
# ---------------------------------------------------------------------------

class _Killed(Exception):
    pass


def _resume_setup(param_dtype):
    cfg = dataclasses.replace(get_smoke_config("gpt2-117m", vocab=64,
                                               max_seq_len=32),
                              param_dtype=param_dtype)
    opt_cfg = optimizer_config("adapprox", 10, 3e-3, refresh_every=5,
                               fused_update=True, mixed_groups=True,
                               guards=True, embedding_min_rows=32,
                               sketch_width=64, sketch_depth=2)
    data = DataConfig(vocab=64, seq_len=32, global_batch=4)
    return (lambda: build_model(cfg)), (lambda: build_optimizer(opt_cfg)), \
        data


def _assert_states_equal(a, b):
    ha, hb = SER.host_leaves(a), SER.host_leaves(b)
    assert [p for p, _, _ in ha] == [p for p, _, _ in hb]
    for (p, x, dx), (_, y, dy) in zip(ha, hb):
        assert dx == dy and x.tobytes() == y.tobytes(), p


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_preempted_run_resumes_bitwise(tmp_path, param_dtype):
    """SIGTERM at step 6 of 10: the handler records it, the loop writes the
    step-6 preemption checkpoint at the boundary and hands the signal on
    to the Python handler installed before it (here one that raises); the
    restarted run restores step 6 and ends equal to the straight run, every
    parameter and state tensor bitwise, and the handler is gone."""
    make_model, make_opt, data = _resume_setup(param_dtype)
    ref, _ = train(make_model(), make_opt(), data,
                   LoopConfig(total_steps=10, log_every=5), device=CPU)

    def raise_killed(signum, frame):
        raise _Killed()

    def hook(step, m):
        if step == 6:
            os.kill(os.getpid(), signal.SIGTERM)

    ck = CheckpointConfig(directory=str(tmp_path), save_every=4)
    prev = signal.signal(signal.SIGTERM, raise_killed)
    try:
        with pytest.raises(_Killed):
            train(make_model(), make_opt(), data,
                  LoopConfig(total_steps=10, log_every=1, ckpt=ck),
                  device=CPU, metric_hook=hook, install_signal_handler=True)
        assert signal.getsignal(signal.SIGTERM) is raise_killed
    finally:
        signal.signal(signal.SIGTERM, prev)
    mgr = CheckpointManager(ck)
    assert mgr.latest_step() == 6
    assert mgr.read_meta(6) == {"preempted": True}
    assert mgr.read_meta(4) == {}
    resumed, hist = train(make_model(), make_opt(), data,
                          LoopConfig(total_steps=10, log_every=1, ckpt=ck),
                          device=CPU)
    assert [h["step"] for h in hist] == [7, 8, 9, 10]
    _assert_states_equal(ref, resumed)
    assert next(iter(resumed.params.values())).dtype == getattr(
        torch, param_dtype)


def test_sigterm_kills_and_the_relaunch_resumes_bitwise(tmp_path):
    """The same through the launcher in a subprocess: SIGTERM at step 3 is
    re-raised with the default disposition after the preemption
    checkpoint, so the process dies of it; the relaunched command resumes
    at step 3 and ends equal to a straight launcher run."""
    argv = SMOKE_ARGV + ["--steps", "5", "--seq", "32", "--batch", "2",
                         "--ckpt-dir", str(tmp_path), "--ckpt-every", "100"]
    code = ("import os, signal\n"
            "from repro_torch.launch import train as launcher\n"
            "from repro_torch.train import train_loop\n"
            "real = train_loop.train\n"
            "def hook(step, m):\n"
            "    if step == 3:\n"
            "        os.kill(os.getpid(), signal.SIGTERM)\n"
            "train_loop.train = lambda *a, **k: real(*a, metric_hook=hook, "
            "**k)\n"
            "launcher.train = train_loop.train\n"
            f"launcher.main({argv!r})\n"
            "raise SystemExit('unreachable: SIGTERM should have killed it')\n")
    # one intra-op thread, as in this process (``one_thread``)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == -signal.SIGTERM, proc.stderr[-2000:]
    mgr = CheckpointManager(CheckpointConfig(directory=str(tmp_path)))
    assert mgr.latest_step() == 3 and mgr.read_meta(3)["preempted"] is True
    resumed, _ = launcher.main(argv)
    straight, _ = launcher.main(argv[:-4])
    _assert_states_equal(straight, resumed)


# ---------------------------------------------------------------------------
# checkpoint hardening: counterparts of tests/test_resilience.py
# ---------------------------------------------------------------------------

def save_tree(directory, step, scale=1.0):
    tree_ = {"w": torch.full((8, 8), scale), "step": step}
    return SER.save_pytree(tree_, directory, step), tree_


def test_list_checkpoints_skips_broken_dirs(tmp_path):
    good1, _ = save_tree(tmp_path, 1)
    good2, _ = save_tree(tmp_path, 2)
    (tmp_path / "step_000000090").mkdir()       # uncommitted
    half = tmp_path / "step_000000091"          # marker, no manifest
    half.mkdir()
    (half / SER.COMMIT_MARKER).touch()
    trunc, _ = save_tree(tmp_path, 92)          # a leaf lost bytes
    leaf = trunc / "leaf_00001.npy"
    leaf.write_bytes(leaf.read_bytes()[: leaf.stat().st_size // 2])
    assert SER.list_checkpoints(tmp_path) == [good1, good2] == \
        JSER.list_checkpoints(tmp_path)
    assert SER.latest_checkpoint(tmp_path) == good2
    mgr = CheckpointManager(CheckpointConfig(directory=str(tmp_path)))
    assert mgr.latest_step() == 2


def test_deep_verify_catches_bitflip(tmp_path):
    ckpt, tree_ = save_tree(tmp_path, 5)
    target = ckpt / "leaf_00001.npy"
    flip_bit(str(target), target.stat().st_size - 1, bit=3)
    assert SER.verify_checkpoint(ckpt) and JSER.verify_checkpoint(ckpt)
    assert not SER.verify_checkpoint(ckpt, deep=True)
    assert not JSER.verify_checkpoint(ckpt, deep=True)
    with pytest.raises(SER.CheckpointCorruptError):
        SER.restore_pytree(ckpt, tree_)
    SER.restore_pytree(ckpt, tree_, verify=False)


def test_manager_restore_falls_back_past_corrupt_latest(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(directory=str(tmp_path),
                                             async_save=False))
    _, tree1 = save_tree(tmp_path, 1, scale=1.0)
    save_tree(tmp_path, 2, scale=2.0)
    corrupt_latest_checkpoint(str(tmp_path), kind="bitflip")
    restored, step = mgr.restore(like=tree1)
    assert step == 1 and restored["step"] == 1
    assert torch.equal(restored["w"], torch.full((8, 8), 1.0))
    with pytest.raises(SER.CheckpointCorruptError):
        mgr.restore(like=tree1, step=2)


def test_manager_restore_raises_when_all_corrupt(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(directory=str(tmp_path),
                                             async_save=False))
    _, tree_ = save_tree(tmp_path, 1)
    corrupt_latest_checkpoint(str(tmp_path), kind="bitflip")
    with pytest.raises(SER.CheckpointCorruptError):
        mgr.restore(like=tree_)


def test_truncated_latest_is_invisible_even_to_latest_step(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(directory=str(tmp_path),
                                             async_save=False))
    save_tree(tmp_path, 1)
    save_tree(tmp_path, 2)
    corrupt_latest_checkpoint(str(tmp_path), kind="truncate")
    assert mgr.latest_step() == 1
    assert [JSER.checkpoint_step(p)
            for p in JSER.list_checkpoints(tmp_path)] == [1]


def test_manifest_corruption_hides_checkpoint(tmp_path):
    save_tree(tmp_path, 1)
    save_tree(tmp_path, 2)
    corrupt_latest_checkpoint(str(tmp_path), kind="manifest")
    assert [SER.checkpoint_step(p)
            for p in SER.list_checkpoints(tmp_path)] == [1]


def test_retry_policy(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(
        directory=str(tmp_path), io_retries=2, retry_backoff_s=0.001))
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    assert mgr._with_retries(flaky, "test") == "ok"
    assert calls["n"] == 3
    calls["n"] = 0

    def always_bad():
        calls["n"] += 1
        raise OSError("down")

    with pytest.raises(OSError):
        mgr._with_retries(always_bad, "test")
    assert calls["n"] == 3          # first attempt + io_retries
    calls["n"] = 0

    def wrong():
        calls["n"] += 1
        raise ValueError("bug")

    with pytest.raises(ValueError):
        mgr._with_retries(wrong, "test")
    assert calls["n"] == 1


def test_async_save_error_surfaces_on_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(CheckpointConfig(
        directory=str(tmp_path), async_save=True, io_retries=0))
    monkeypatch.setattr(SER, "write_checkpoint",
                        lambda *a, **k: (_ for _ in ()).throw(
                            OSError("disk gone")))
    mgr.save({"w": torch.zeros(2)}, 1)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        mgr.wait()
    mgr.wait()                      # the error is consumed


def test_preemption_handler_install_is_idempotent(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(directory=str(tmp_path)))
    before = signal.getsignal(signal.SIGTERM)
    get_state = lambda: ({"w": torch.zeros(2)}, 0)
    mgr.install_preemption_handler(get_state)
    first = signal.getsignal(signal.SIGTERM)
    assert first is not before
    mgr.install_preemption_handler(get_state)
    assert mgr._prev_handlers[signal.SIGTERM] is before
    mgr.uninstall_preemption_handler()
    assert signal.getsignal(signal.SIGTERM) is before
    mgr.uninstall_preemption_handler()
    assert signal.getsignal(signal.SIGTERM) is before
    assert not glob.glob(str(tmp_path / "step_*"))
