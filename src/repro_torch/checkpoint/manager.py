"""CheckpointManager: async save, retention, preemption handling, restore;
the port of the JAX package's ``checkpoint/manager.py``.

Fault-tolerance contract, as there:

  * saves are atomic (``serialization.write_checkpoint``): a job killed
    mid-save never corrupts the latest checkpoint;
  * saves are asynchronous: the device-to-host copy into numpy is the
    synchronous part, and it is finished before ``save`` returns, so the
    next step may update the parameters and the first moment in place;
    a background thread writes the files, and a failure there raises at
    the next ``wait()``;
  * retention keeps the last ``keep`` checkpoints (and every
    ``keep_every``-th for good);
  * transient I/O errors (``OSError`` only) are retried with doubling
    backoff; corruption and programming errors propagate at once;
  * ``restore`` falls back past a truncated or bit-flipped latest
    checkpoint to the newest good one.

Preemption.  The JAX handler saves a pre-step snapshot of immutable
arrays from inside the signal handler.  In the port a Python signal
handler runs between any two bytecodes, possibly with half the parameters
updated, so a snapshot taken there could be torn.  The port's handler
only records the signal; the train loop calls :meth:`at_step_boundary`
between steps, which writes the preemption checkpoint (``meta.preempted``)
of the state at that boundary, blocking, and then hands the signal on,
chained as in JAX: to a Python handler installed before, honouring
``SIG_IGN``, or by restoring the default disposition and raising it
again.  Install is idempotent and uninstall restores the outside
handlers.

The timings of the last save and restore are kept for measurement:
``last_gather_s`` (the host copy), ``last_write_s`` (the files, on the
writer thread) and ``last_restore_s``.  With a ``tracer`` (the train loop
sets its own) they are spans too, as in JAX: ``ckpt_gather`` (the
synchronous host copy), ``ckpt_write`` (the files, on the writer thread,
which starts a trace of its own) and ``ckpt_restore``.
"""
from __future__ import annotations

import dataclasses
import logging
import shutil
import signal
import threading
import time
from pathlib import Path
from typing import Any, Callable, Optional

from repro_torch.checkpoint import serialization as SER
from repro_torch.telemetry.trace import NULL_TRACER

log = logging.getLogger(__name__)


def _world() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist
    dist.barrier()


@dataclasses.dataclass
class CheckpointConfig:
    directory: str
    save_every: int = 500
    keep: int = 3
    keep_every: int = 0          # 0 = disabled
    async_save: bool = True
    # Transient-I/O retry policy: io_retries is the number of re-tries
    # after the first attempt; the backoff doubles per attempt from
    # retry_backoff_s, no jitter.
    io_retries: int = 2
    retry_backoff_s: float = 0.05


class CheckpointManager:
    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        self.directory = Path(cfg.directory)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._prev_handlers: Optional[dict] = None
        self._get_state: Optional[Callable] = None
        self._signal = None              # (signum, frame) once received
        self.last_gather_s = self.last_write_s = self.last_restore_s = 0.0
        self.tracer = None               # optional telemetry Tracer
        # the placement of the states saved and restored (a tree of
        # distributed.sharding.NamedSharding; the train loop sets its
        # own), the default of save's and restore's ``shardings``
        self.shardings = None

    def _with_retries(self, fn, what: str):
        """Run ``fn``, retrying OSErrors with exponential backoff; any
        other exception propagates at once."""
        delay = self.cfg.retry_backoff_s
        for attempt in range(self.cfg.io_retries + 1):
            try:
                return fn()
            except OSError as e:
                if attempt == self.cfg.io_retries:
                    raise
                log.warning("%s failed (%s); retry %d/%d in %.2fs",
                            what, e, attempt + 1, self.cfg.io_retries, delay)
                time.sleep(delay)
                delay *= 2

    # -- save ------------------------------------------------------------
    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.cfg.save_every == 0

    def save(self, tree: Any, step: int, blocking: bool = False,
             extra_meta: Optional[dict] = None,
             shardings: Any = None) -> None:
        """Save ``tree`` as step ``step``.  Under a mesh (``shardings``, a
        tree of ``NamedSharding`` mirroring ``tree``) every rank calls it:
        the gather of the DTensor leaves is a collective, rank 0 writes,
        and a blocking save ends in a barrier, so no rank reads before
        the files are committed."""
        tr = self.tracer if self.tracer is not None else NULL_TRACER
        if shardings is None:
            shardings = self.shardings
        with tr.span("ckpt_gather", step=step):
            self.wait()                  # one in-flight save at a time
            t0 = time.perf_counter()
            host = SER.host_leaves(tree)  # synchronous: a consistent copy
            treedef = SER.describe(tree)
            specs, axes = (SER.leaf_spec_meta(shardings)
                           if shardings is not None else (None, None))
            self.last_gather_s = time.perf_counter() - t0
        multi = _world() > 1
        if multi and _rank() != 0:
            if blocking:
                _barrier()
            return

        def work():
            try:
                # the writer thread has its own span stack: this span
                # starts a trace rather than nesting under the caller's
                with tr.span("ckpt_write", step=step):
                    t1 = time.perf_counter()
                    self._with_retries(
                        lambda: SER.write_checkpoint(
                            host, self.directory, step, extra_meta,
                            treedef, specs, axes),
                        what=f"checkpoint save step {step}")
                    self.last_write_s = time.perf_counter() - t1
                    self._retain()
            except BaseException as e:  # noqa: BLE001 -- surfaced on wait()
                self._error = e

        if self.cfg.async_save and not blocking:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            if multi:
                _barrier()
            self._raise_if_failed()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from err

    def _retain(self):
        cks = SER.list_checkpoints(self.directory)
        if self.cfg.keep <= 0 or len(cks) <= self.cfg.keep:
            return
        for p in cks[:-self.cfg.keep]:
            step = SER.checkpoint_step(p)
            if self.cfg.keep_every and step % self.cfg.keep_every == 0:
                continue
            shutil.rmtree(p, ignore_errors=True)

    # -- restore -----------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        p = SER.latest_checkpoint(self.directory)
        return SER.checkpoint_step(p) if p else None

    def read_meta(self, step: Optional[int] = None) -> dict:
        """The ``extra_meta`` dict a checkpoint was saved with (empty when
        none, or when no such checkpoint exists)."""
        if step is None:
            p = SER.latest_checkpoint(self.directory)
        else:
            p = self.directory / f"step_{step:09d}"
            if not (p / "manifest.json").exists():
                p = None
        return SER.read_meta(p) if p is not None else {}

    def restore(self, like: Any, step: Optional[int] = None,
                shardings: Any = None) -> tuple[Any, int]:
        """Restore into the structure of ``like`` (see
        ``serialization.restore_pytree``), placed under ``shardings``
        (any mesh's, e.g. ``train_shardings``') when given, else whole on
        ``like``'s devices.  With no explicit ``step`` the checkpoints
        are tried newest first with full checksum verification, and a
        corrupt one is skipped with a warning; an explicit ``step`` is a
        user decision, and corruption there raises
        :class:`CheckpointCorruptError`."""
        tr = self.tracer if self.tracer is not None else NULL_TRACER
        if shardings is None:
            shardings = self.shardings
        with tr.span("ckpt_restore"):
            t0 = time.perf_counter()
            tree, got = self._restore(like, step)
            if shardings is not None:
                from repro_torch.distributed.sharding import place_tree
                tree = place_tree(tree, shardings)
            self.last_restore_s = time.perf_counter() - t0
        return tree, got

    def _restore(self, like: Any, step: Optional[int]) -> tuple[Any, int]:
        if step is not None:
            p = self.directory / f"step_{step:09d}"
            tree = self._with_retries(
                lambda: SER.restore_pytree(p, like),
                what=f"checkpoint restore step {step}")
            return tree, SER.checkpoint_step(p)
        candidates = SER.list_checkpoints(self.directory)
        if not candidates:
            raise FileNotFoundError(
                f"no committed checkpoint under {self.directory}")
        last_err: Optional[Exception] = None
        for p in reversed(candidates):
            try:
                tree = self._with_retries(
                    lambda p=p: SER.restore_pytree(p, like),
                    what=f"checkpoint restore {p.name}")
                return tree, SER.checkpoint_step(p)
            except SER.CheckpointCorruptError as e:
                log.warning("skipping corrupt checkpoint %s: %s", p.name, e)
                last_err = e
        raise SER.CheckpointCorruptError(
            f"all {len(candidates)} checkpoints under {self.directory} "
            f"failed verification") from last_err

    # -- preemption --------------------------------------------------------
    def install_preemption_handler(self, get_state: Callable[[], tuple]):
        """``get_state() -> (tree, step)`` or ``(tree, step, extra_meta)``,
        called at the step boundary after a SIGTERM / SIGINT (see the
        module docstring).  Re-installing tears the previous installation
        down first, so the chained handlers are always those from outside
        this manager."""
        if self._prev_handlers is not None:
            self.uninstall_preemption_handler()
        self._get_state = get_state
        self._signal = None

        def handler(signum, frame):
            log.warning("signal %s: preemption checkpoint at the next step "
                        "boundary", signum)
            self._signal = (signum, frame)

        prev = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev[sig] = signal.signal(sig, handler)
        self._prev_handlers = prev

    @property
    def preempted(self) -> bool:
        """Whether a signal is waiting for :meth:`at_step_boundary`."""
        return self._signal is not None

    def at_step_boundary(self) -> None:
        """Between steps: if a preemption signal arrived, write the blocking
        preemption checkpoint of ``get_state()`` with ``meta.preempted``,
        then put the outside handlers back and hand the signal on.  A
        failed save still hands it on."""
        if self._signal is None:
            return
        (signum, frame), prev = self._signal, self._prev_handlers
        self._signal = None
        try:
            res = self._get_state()
            tree, step = res[0], res[1]
            extra = dict(res[2]) if len(res) > 2 and res[2] else {}
            extra["preempted"] = True
            self.save(tree, step, blocking=True, extra_meta=extra)
        finally:
            self.uninstall_preemption_handler()
            chained = (prev or {}).get(signum)
            if callable(chained):
                chained(signum, frame)
            elif chained != signal.SIG_IGN:
                signal.signal(signum, signal.SIG_DFL)
                signal.raise_signal(signum)

    def uninstall_preemption_handler(self) -> None:
        """Put back the SIGTERM / SIGINT handlers from before
        :meth:`install_preemption_handler` (no-op if none is active)."""
        prev = self._prev_handlers
        if not prev:
            return
        self._prev_handlers = None
        for sig, old in prev.items():
            # None: a handler set outside Python; leave the default
            signal.signal(sig, old if old is not None else signal.SIG_DFL)

