"""Serving engines: lock-step wave batching and continuous batching, the
port of the JAX package's ``serve/engine.py``.

Two schedulers, one ``Request`` contract (greedy decode, per-request
``max_new_tokens`` budget, optional EOS):

``Engine`` (wave)
    The seed scheduler, kept as the baseline and dense-cache fallback:
    up to ``slots`` requests are admitted per wave, prompts
    right-aligned/padded to a common width, prefilled as ONE batch, then
    decoded in lock-step until every sequence finishes.  One slow
    sequence drains the whole batch — head-of-line blocking is the
    behaviour the JAX package's ``benchmarks/bench_serve.py`` quantifies.
    Note the right-aligned pad tokens are attended to (a single scalar
    cache position forces common alignment), so a request's logits depend
    on its wave-mates' lengths; equal-length prompts are unaffected.

``ContinuousEngine`` (continuous batching + paged KV cache)
    Per-slot cache positions and slot recycling: the step any row
    finishes, its blocks return to the pool and the slot re-admits from
    the queue — no wave drain.  The KV cache is the block pool of
    ``serve/kv_cache.py``: per-slot block tables instead of a
    ``cache_len`` worst-case dense reservation per slot.  Prompts
    prefill in bucketed CHUNKS interleaved with decode (one chunk per
    engine step), so admission never stalls token emission.  Admission
    is gated on pool occupancy (``occupancy_watermark``) and the whole
    loop streams ``kind="serve"`` events (queue depth, TTFT, tokens/s,
    block occupancy) through the telemetry sink.

    The decode step sees fixed shapes (``slots`` rows, ``cache_len //
    block_size`` table columns) with block tables and positions as data,
    and prefill chunk lengths are bucketed to powers of two, as in JAX,
    where this keeps request churn from recompiling.  Eager torch has no
    compile cache to protect, but the bucketed plan stays exactly JAX's:
    it sets each request's reservation and so the pool's occupancy.

Where JAX jits ``prefill`` / ``decode_step`` and donates the pool, the
port calls the model under ``torch.inference_mode`` and the model writes
the cache or pool in place.  Tokens come back to the host once a step (the
greedy argmax), as in JAX.

Cache contract (models/attention.py, models/transformer.py): the paged
read gathers the pool through the block table into the logical dense
layout and runs the same ``_sdpa`` as the dense cache, masking at or
beyond each row's position to exactly-zero softmax weight — with equal
logical lengths, paged decode is BITWISE identical to the dense path.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.serve.kv_cache import NULL_BLOCK, BlockAllocator, SlotTable
from repro_torch.telemetry.trace import NULL_TRACER, ROOT_SPAN

log = logging.getLogger(__name__)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: "np.ndarray"          # (S,) int32
    max_new_tokens: int
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    rejected: bool = False        # load-shed by a bounded admission queue
    # engine-relative timestamps (seconds since run() start)
    arrival_s: float = 0.0
    first_token_s: Optional[float] = None
    done_s: Optional[float] = None
    # span-waterfall identity (set by an engine running under a tracer;
    # stamped into this request's kind="serve" events as the join key)
    trace: Optional[str] = None
    admit_s: Optional[float] = None


def _tr(req: Request) -> dict:
    """``trace`` field for a per-request serve event (empty if untraced)."""
    return {"trace": req.trace} if req.trace else {}


@dataclasses.dataclass
class ServeConfig:
    slots: int = 4                # decode batch per wave
    cache_len: int = 512
    eos_id: Optional[int] = None
    pad_id: int = 0


def _now(t0: float) -> float:
    return time.monotonic() - t0


def _device(params: dict) -> torch.device:
    """The device of the parameters (the first leaf's)."""
    for v in params.values():
        return _device(v) if isinstance(v, dict) else v.device
    raise ValueError("empty parameter tree")


def _argmax(logits: torch.Tensor) -> np.ndarray:
    """Greedy tokens of the last position, on the host (the first of tied
    maxima, as ``jnp.argmax``)."""
    return torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy()


class Engine:
    """Wave scheduler (see module docstring)."""

    def __init__(self, model, params, cfg: ServeConfig, sink=None,
                 tracer=None):
        self.model = model
        self.params = params
        self.cfg = cfg
        self.sink = sink
        self.device = _device(params)
        self._prefill = model.prefill
        self._decode = model.decode_step
        self.waves = 0
        self.tokens_emitted = 0
        self.set_tracer(tracer)

    def set_tracer(self, tracer) -> None:
        """Attach (or with ``None`` detach) a ``repro_torch.telemetry`` Tracer:
        each request gets a span waterfall (queued / prefill / decode
        under a per-request root) joined to its serve events by trace
        id, and waves become spans on a per-engine trace."""
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._tracing = tracer is not None
        self._engine_trace = (self.tracer.new_trace("wave")
                              if self._tracing else "")
        self._toff = 0.0     # engine-relative -> tracer-clock offset
        self.metrics_every = 0   # waves between registry snapshots

    def _maybe_snapshot(self, now: float, step: int) -> None:
        reg = self.tracer.registry
        if (self.metrics_every > 0 and reg is not None
                and self.sink is not None
                and step % self.metrics_every == 0):
            self.sink.emit(reg.snapshot(t_s=now, step=step))

    def _emit(self, event: str, t_s: float, **fields) -> None:
        if self.sink is not None:
            self.sink.emit({"kind": "serve", "event": event, "t_s": t_s,
                            "scheduler": "wave", **fields})

    def _pad_prompts(self, reqs) -> torch.Tensor:
        width = max(len(r.prompt) for r in reqs)
        batch = np.full((self.cfg.slots, width), self.cfg.pad_id, np.int64)
        for i, r in enumerate(reqs):
            batch[i, width - len(r.prompt):] = r.prompt   # right-aligned
        return torch.from_numpy(batch).to(self.device)

    def run_wave(self, reqs: list[Request], t0: Optional[float] = None):
        assert len(reqs) <= self.cfg.slots
        t0 = time.monotonic() if t0 is None else t0
        if self._tracing:
            # map engine-relative seconds onto the tracer's clock and
            # stamp a trace id on requests admitted outside run()
            self._toff = self.tracer.now() - _now(t0)
            for r in reqs:
                if r.trace is None:
                    r.trace = self.tracer.new_trace("req")
        with self.tracer.span("wave", trace=self._engine_trace) as wsp:
            wsp.set(wave=self.waves, n=len(reqs))
            self._run_wave(reqs, t0)
        self.waves += 1

    def _run_wave(self, reqs: list[Request], t0: float) -> None:
        wave_s = _now(t0)
        if self._tracing:
            for r in reqs:
                r.admit_s = wave_s
                self.tracer.record(
                    "queued", r.arrival_s + self._toff,
                    max(wave_s - r.arrival_s, 0.0), r.trace,
                    parent=ROOT_SPAN, attrs={"uid": r.uid})
        tokens = self._pad_prompts(reqs)
        cache = self.model.init_cache(self.cfg.slots, self.cfg.cache_len,
                                      device=self.device)
        pf0 = _now(t0)
        logits, cache = self._prefill(self.params, tokens, cache)
        toks = _argmax(logits)
        if self._tracing:
            pf1 = _now(t0)
            for r in reqs:
                self.tracer.record(
                    "prefill", pf0 + self._toff, pf1 - pf0, r.trace,
                    parent=ROOT_SPAN,
                    attrs={"uid": r.uid, "tokens": len(r.prompt)})
        budget = np.zeros((self.cfg.slots,), np.int64)
        for i, r in enumerate(reqs):
            if r.max_new_tokens <= 0:
                # a zero budget emits nothing — not even the
                # prefill-computed token
                r.done = True
                continue
            tok = int(toks[i])
            r.out_tokens.append(tok)
            r.first_token_s = _now(t0)
            self.tokens_emitted += 1
            self._emit("first_token", r.first_token_s, uid=r.uid,
                       ttft_s=r.first_token_s - r.arrival_s, **_tr(r))
            if ((self.cfg.eos_id is not None and tok == self.cfg.eos_id)
                    or r.max_new_tokens == 1):
                # EOS straight out of prefill ends the sequence here —
                # the budget may not keep a finished row decoding
                r.done = True
            else:
                budget[i] = r.max_new_tokens - 1

        live = np.array([not r.done for r in reqs]
                        + [False] * (self.cfg.slots - len(reqs)))
        live &= budget > 0
        for i, r in enumerate(reqs):
            if r.done and r.done_s is None:
                self._finish(r, _now(t0))
        last = torch.from_numpy(toks[:, None]).to(self.device)
        while live.any():
            logits, cache = self._decode(self.params, cache, last)
            toks = _argmax(logits)
            for i, r in enumerate(reqs):
                if not live[i]:
                    continue
                tok = int(toks[i])
                r.out_tokens.append(tok)
                self.tokens_emitted += 1
                budget[i] -= 1
                if budget[i] <= 0 or (self.cfg.eos_id is not None
                                      and tok == self.cfg.eos_id):
                    live[i] = False
                    self._finish(r, _now(t0))
            last = torch.from_numpy(toks[:, None]).to(self.device)
        for r in reqs:
            if not r.done:
                self._finish(r, _now(t0))

    def _finish(self, r: Request, t_s: float) -> None:
        r.done = True
        r.done_s = t_s
        self._emit("finish", t_s, uid=r.uid, tokens=len(r.out_tokens),
                   latency_s=t_s - r.arrival_s, **_tr(r))
        if self._tracing and r.trace:
            if len(r.out_tokens) > 1 and r.first_token_s is not None:
                self.tracer.record(
                    "decode", r.first_token_s + self._toff,
                    max(t_s - r.first_token_s, 0.0), r.trace,
                    parent=ROOT_SPAN, attrs={"uid": r.uid})
            self.tracer.record(
                "request", r.arrival_s + self._toff,
                max(t_s - r.arrival_s, 0.0), r.trace, span=ROOT_SPAN,
                attrs={"uid": r.uid, "tokens": len(r.out_tokens)})

    def run(self, requests: list[Request],
            arrivals: Optional[list[float]] = None) -> list[Request]:
        """Serve ``requests``; ``arrivals[i]`` (seconds from start) makes
        the load open-loop — a wave only admits arrived requests, and an
        idle engine sleeps until the next arrival."""
        t0 = time.monotonic()
        if arrivals is None:
            arrivals = [0.0] * len(requests)
        order = sorted(range(len(requests)), key=lambda i: arrivals[i])
        pending = deque((arrivals[i], requests[i]) for i in order)
        for a, r in pending:
            r.arrival_s = a
        while pending:
            now = _now(t0)
            if pending[0][0] > now:
                time.sleep(pending[0][0] - now)
                continue
            wave = []
            while pending and len(wave) < self.cfg.slots \
                    and pending[0][0] <= _now(t0):
                wave.append(pending.popleft()[1])
            self.run_wave(wave, t0=t0)
            self._emit("stats", _now(t0), queue_depth=len(pending),
                       tokens=self.tokens_emitted, slots_active=0)
            self._maybe_snapshot(_now(t0), self.waves)
        return requests


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------

_MIN_BUCKET = 8


def _bucket(n: int, cap: int) -> int:
    """Smallest power-of-two >= n (floor _MIN_BUCKET, ceiling cap)."""
    c = _MIN_BUCKET
    while c < n:
        c *= 2
    return min(c, cap)


@dataclasses.dataclass
class ContinuousConfig:
    slots: int = 4                 # concurrent sequences (decode batch)
    cache_len: int = 512           # logical per-slot maximum (tokens)
    block_size: int = 16           # tokens per KV block
    num_blocks: Optional[int] = None   # pool size; None = slots full span
    prefill_chunk: int = 64        # max prompt tokens per engine step
    eos_id: Optional[int] = None
    pad_id: int = 0
    max_queue: int = 0             # >0: load-shed arrivals past this depth
    occupancy_watermark: float = 0.95  # admission backs off above this
    stats_every: int = 32          # engine steps between stats events


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    phase: str = "idle"            # idle | prefill | decode
    table: Optional[SlotTable] = None
    length: int = 0                # tokens currently in the logical cache
    prompt_done: int = 0           # prompt tokens prefilled so far
    budget: int = 0                # generated tokens still allowed
    last_token: int = 0            # next decode input
    reserved_left: int = 0         # admission reservation not yet drawn


class ContinuousEngine:
    """Continuous-batching scheduler over the paged KV cache."""

    def __init__(self, model, params, cfg: ContinuousConfig, sink=None,
                 tracer=None):
        if not hasattr(model, "decode_paged"):
            raise TypeError(f"{type(model).__name__} has no paged decode "
                            f"path; ContinuousEngine needs a KV-cache "
                            f"model (dense/moe/vlm transformer)")
        if cfg.cache_len % cfg.block_size:
            raise ValueError("cache_len must be a multiple of block_size")
        if cfg.prefill_chunk & (cfg.prefill_chunk - 1):
            raise ValueError("prefill_chunk must be a power of two")
        self.model = model
        self.params = params
        self.cfg = cfg
        self.sink = sink
        self.device = _device(params)
        self.nbt = cfg.cache_len // cfg.block_size  # table width (blocks)
        num_blocks = cfg.num_blocks
        if num_blocks is None:
            num_blocks = cfg.slots * self.nbt + 1   # +1: the null block
        self.alloc = BlockAllocator(num_blocks, cfg.block_size)
        self.pool = model.init_paged_cache(num_blocks, cfg.block_size,
                                           device=self.device)
        self.slots = [_Slot() for _ in range(cfg.slots)]
        self.steps = 0
        self.tokens_emitted = 0
        self.completed = 0
        self._ready: "deque[Request]" = deque()
        self._rr = 0                                # prefill round-robin
        self._above_watermark = False
        self.set_tracer(tracer)

    # the model writes the pool in place (JAX donates it to a jitted call)
    def _decode_fn(self, tokens, tables, positions):
        """Greedy tokens (slots,) on the host, from host arrays."""
        dev = self.device
        logits, self.pool = self.model.decode_paged(
            self.params, self.pool, torch.from_numpy(tokens).to(dev),
            torch.from_numpy(tables).to(dev),
            torch.from_numpy(positions).to(dev))
        return _argmax(logits)

    def _prefill_fn(self, chunk, table, p0: int, last_idx: int) -> int:
        """The greedy token after chunk index ``last_idx``."""
        dev = self.device
        logits, self.pool = self.model.prefill_paged(
            self.params, self.pool, torch.from_numpy(chunk).to(dev),
            torch.from_numpy(table).to(dev), p0, last_idx)
        return int(_argmax(logits)[0])

    # -- telemetry ---------------------------------------------------------
    def set_tracer(self, tracer) -> None:
        """Attach (or with ``None`` detach) a ``repro_torch.telemetry`` Tracer:
        every request gets a span waterfall (queued / admitted /
        prefill_chunk / decode under a per-request root span) joined to
        its serve events by trace id, engine steps become spans on a
        per-engine trace, and — when the tracer carries a registry —
        request/token counters and a latency histogram are kept."""
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._tracing = tracer is not None
        self._engine_trace = (self.tracer.new_trace("engine")
                              if self._tracing else "")
        self._toff = 0.0     # engine-relative -> tracer-clock offset
        self.metrics_every = 0   # engine steps between registry snapshots

    def _maybe_snapshot(self, now: float, step: int) -> None:
        reg = self.tracer.registry
        if (self.metrics_every > 0 and reg is not None
                and self.sink is not None
                and step % self.metrics_every == 0):
            self.sink.emit(reg.snapshot(t_s=now, step=step))

    def _emit(self, event: str, t_s: float, **fields) -> None:
        if self.sink is not None:
            self.sink.emit({"kind": "serve", "event": event, "t_s": t_s,
                            "scheduler": "continuous", **fields})

    # -- admission ---------------------------------------------------------
    def _chunk_plan(self, n: int) -> list[tuple[int, int, int]]:
        """(p0, real, padded) prefill chunks covering an n-token prompt."""
        plan, p0 = [], 0
        while p0 < n:
            real = min(self.cfg.prefill_chunk, n - p0)
            plan.append((p0, real, _bucket(real, self.cfg.prefill_chunk)))
            p0 += real
        return plan

    def _span(self, req: Request) -> int:
        """Worst-case logical span a request can touch: the bucket-padded
        prefill frontier or prompt + generation budget, whichever is
        larger (chunk padding writes throwaway k/v past the prompt)."""
        plan = self._chunk_plan(len(req.prompt))
        padded_end = plan[-1][0] + plan[-1][2]
        return max(padded_end, len(req.prompt) + req.max_new_tokens)

    def _validate(self, req: Request) -> None:
        if len(req.prompt) < 1:
            raise ValueError(f"req {req.uid}: empty prompt")
        span = self._span(req)
        if span > self.cfg.cache_len:
            raise ValueError(
                f"req {req.uid}: span {span} (prompt {len(req.prompt)} + "
                f"budget {req.max_new_tokens}, chunk-padded) exceeds "
                f"cache_len {self.cfg.cache_len}")
        if self.alloc.blocks_for(span) > self.alloc.usable:
            raise ValueError(f"req {req.uid}: needs "
                             f"{self.alloc.blocks_for(span)} blocks; pool "
                             f"has {self.alloc.usable}")

    def _admit(self, now: float) -> None:
        while self._ready:
            occ = self.alloc.occupancy()
            if occ >= self.cfg.occupancy_watermark:
                if not self._above_watermark:   # once per crossing
                    self._above_watermark = True
                    self._emit("backoff", now, occupancy=occ,
                               queue_depth=len(self._ready),
                               reason="occupancy_watermark")
                return
            self._above_watermark = False
            try:
                slot = next(s for s in self.slots if s.phase == "idle")
            except StopIteration:
                return
            req = self._ready[0]
            need = self.alloc.blocks_for(self._span(req))
            if not self.alloc.reserve(need):
                self._emit("backoff", now, occupancy=occ,
                           queue_depth=len(self._ready),
                           reason="reservation")
                return
            self._ready.popleft()
            slot.req = req
            slot.phase = "prefill"
            slot.table = SlotTable()
            slot.length = 0
            slot.prompt_done = 0
            slot.budget = req.max_new_tokens
            slot.reserved_left = need
            if self._tracing and req.trace:
                req.admit_s = now
                self.tracer.record(
                    "queued", req.arrival_s + self._toff,
                    max(now - req.arrival_s, 0.0), req.trace,
                    parent=ROOT_SPAN, attrs={"uid": req.uid})
            self._emit("admit", now, uid=req.uid,
                       queue_depth=len(self._ready), occupancy=occ,
                       **_tr(req))

    def _grow(self, slot: _Slot, upto_tokens: int) -> None:
        need = self.alloc.blocks_for(upto_tokens) - len(slot.table.blocks)
        if need > 0:
            n = min(need, slot.reserved_left)
            ids = self.alloc.alloc(n, reserved=True)
            if need > n:                 # past the reservation (shouldn't
                ids += self.alloc.alloc(need - n)   # happen; be safe)
            slot.reserved_left -= n
            slot.table.blocks.extend(ids)

    # -- prefill -----------------------------------------------------------
    def _prefill_one(self, now: float) -> bool:
        """Run ONE bucketed prompt chunk for the next prefilling slot
        (round-robin) — chunked prefill interleaves with decode instead
        of stalling it."""
        n = len(self.slots)
        for off in range(n):
            slot = self.slots[(self._rr + off) % n]
            if slot.phase == "prefill":
                self._rr = (self._rr + off + 1) % n
                break
        else:
            return False
        req = slot.req
        p0 = slot.prompt_done
        traced = self._tracing and req.trace
        if traced and p0 == 0 and req.admit_s is not None:
            # admission-to-first-prefill gap (slot wait + scheduling)
            self.tracer.record(
                "admitted", req.admit_s + self._toff,
                max(now - req.admit_s, 0.0), req.trace,
                parent=ROOT_SPAN, attrs={"uid": req.uid})
        real = min(self.cfg.prefill_chunk, len(req.prompt) - p0)
        padded = _bucket(real, self.cfg.prefill_chunk)
        self._grow(slot, p0 + padded)
        chunk = np.full((1, padded), self.cfg.pad_id, np.int64)
        chunk[0, :real] = req.prompt[p0:p0 + real]
        tw0 = time.monotonic()
        tok = self._prefill_fn(chunk, slot.table.padded(self.nbt).astype(
            np.int64), p0, real - 1)
        if traced:
            dur = time.monotonic() - tw0   # the chunk's wall time
            self.tracer.record(
                "prefill_chunk", self.tracer.now() - dur, dur, req.trace,
                parent=ROOT_SPAN,
                attrs={"uid": req.uid, "p0": p0, "tokens": real})
        slot.prompt_done += real
        if slot.prompt_done < len(req.prompt):
            return True
        # prompt complete: the chunk's last real logits give the first
        # generated token
        slot.length = len(req.prompt)
        if req.max_new_tokens <= 0:
            self._finish(slot, now)     # zero budget emits nothing
            return True
        req.out_tokens.append(tok)
        req.first_token_s = now
        self.tokens_emitted += 1
        self._emit("first_token", now, uid=req.uid,
                   ttft_s=now - req.arrival_s, **_tr(req))
        if ((self.cfg.eos_id is not None and tok == self.cfg.eos_id)
                or req.max_new_tokens == 1):
            self._finish(slot, now)
        else:
            slot.phase = "decode"
            slot.last_token = tok
            slot.budget = req.max_new_tokens - 1
        return True

    # -- decode ------------------------------------------------------------
    def _decode_all(self, now: float) -> bool:
        """One token for every decoding slot; idle/prefilling rows are
        parked on the null block and their outputs dropped."""
        rows = [i for i, s in enumerate(self.slots) if s.phase == "decode"]
        if not rows:
            return False
        n = self.cfg.slots
        tokens = np.zeros((n, 1), np.int64)
        tables = np.full((n, self.nbt), NULL_BLOCK, np.int64)
        positions = np.zeros((n,), np.int64)
        for i in rows:
            slot = self.slots[i]
            self._grow(slot, slot.length + 1)
            tokens[i, 0] = slot.last_token
            tables[i] = slot.table.padded(self.nbt)
            positions[i] = slot.length
        toks = self._decode_fn(tokens, tables, positions)
        for i in rows:
            slot = self.slots[i]
            tok = int(toks[i])
            slot.req.out_tokens.append(tok)
            self.tokens_emitted += 1
            slot.length += 1
            slot.budget -= 1
            slot.last_token = tok
            if slot.budget <= 0 or (self.cfg.eos_id is not None
                                    and tok == self.cfg.eos_id):
                self._finish(slot, now)
        return True

    # -- lifecycle ---------------------------------------------------------
    def _record_waterfall(self, req: Request, now: float) -> None:
        """The per-request root span (+ decode phase) at end of life —
        earlier phases (queued/admitted/prefill_chunk) were recorded as
        they happened under the same trace id."""
        if len(req.out_tokens) > 1 and req.first_token_s is not None:
            self.tracer.record(
                "decode", req.first_token_s + self._toff,
                max(now - req.first_token_s, 0.0), req.trace,
                parent=ROOT_SPAN, attrs={"uid": req.uid})
        attrs = {"uid": req.uid, "tokens": len(req.out_tokens)}
        if req.rejected:
            attrs["rejected"] = True
        self.tracer.record(
            "request", req.arrival_s + self._toff,
            max(now - req.arrival_s, 0.0), req.trace, span=ROOT_SPAN,
            attrs=attrs)
        reg = self.tracer.registry
        if reg is not None:
            labels = {"scheduler": "continuous"}
            reg.counter("serve_requests_total",
                        help="finished requests (incl. rejected)").inc(
                            1, **labels)
            reg.counter("serve_tokens_total",
                        help="generated tokens").inc(
                            len(req.out_tokens), **labels)
            reg.histogram("serve_request_latency_seconds",
                          help="arrival-to-finish latency").observe(
                              max(now - req.arrival_s, 0.0), **labels)

    def _finish(self, slot: _Slot, now: float) -> None:
        req = slot.req
        req.done = True
        req.done_s = now
        self.completed += 1
        self._emit("finish", now, uid=req.uid, tokens=len(req.out_tokens),
                   latency_s=now - req.arrival_s,
                   occupancy=self.alloc.occupancy(), **_tr(req))
        if self._tracing and req.trace:
            self._record_waterfall(req, now)
        if slot.table.blocks:
            self.alloc.free(slot.table.blocks)
        if slot.reserved_left:
            self.alloc.release(slot.reserved_left)
        slot.req = None
        slot.phase = "idle"
        slot.table = None
        slot.length = slot.prompt_done = slot.budget = 0
        slot.reserved_left = slot.last_token = 0

    def step(self, now: float) -> bool:
        """One scheduler step: admit, one prefill chunk, one decode step
        for every live row.  Returns whether any work ran."""
        with self.tracer.span("engine_step",
                              trace=self._engine_trace) as sp:
            self._admit(now)
            did = self._prefill_one(now)
            did = self._decode_all(now) or did
            sp.set(step=self.steps + 1)
        self.steps += 1
        if self.sink is not None and self.steps % self.cfg.stats_every == 0:
            self._emit("stats", now, step=self.steps,
                       queue_depth=len(self._ready),
                       occupancy=self.alloc.occupancy(),
                       slots_active=sum(s.phase != "idle"
                                        for s in self.slots),
                       tokens=self.tokens_emitted,
                       tok_per_s=self.tokens_emitted / max(now, 1e-9))
        self._maybe_snapshot(now, self.steps)
        return did

    def run(self, requests: list[Request],
            arrivals: Optional[list[float]] = None) -> list[Request]:
        """Serve ``requests`` to completion.  ``arrivals[i]`` (seconds
        from start) drives an open-loop load; requests arriving onto a
        full bounded queue (``max_queue``) are load-shed (``rejected``)."""
        for r in requests:
            self._validate(r)
        t0 = time.monotonic()
        if self._tracing:
            self._toff = self.tracer.now() - _now(t0)
        if arrivals is None:
            arrivals = [0.0] * len(requests)
        order = sorted(range(len(requests)), key=lambda i: arrivals[i])
        pending = deque((arrivals[i], requests[i]) for i in order)
        for a, r in pending:
            r.arrival_s = a
        while pending or self._ready \
                or any(s.phase != "idle" for s in self.slots):
            now = _now(t0)
            while pending and pending[0][0] <= now:
                _, req = pending.popleft()
                if self._tracing and req.trace is None:
                    req.trace = self.tracer.new_trace("req")
                if 0 < self.cfg.max_queue <= len(self._ready):
                    req.rejected = True
                    req.done = True
                    req.done_s = now
                    self._emit("reject", now, uid=req.uid,
                               queue_depth=len(self._ready), **_tr(req))
                    if self._tracing and req.trace:
                        self.tracer.record(
                            "queued", req.arrival_s + self._toff,
                            max(now - req.arrival_s, 0.0), req.trace,
                            parent=ROOT_SPAN, attrs={"uid": req.uid})
                        self._record_waterfall(req, now)
                    continue
                self._ready.append(req)
            if not self.step(now) and not self._ready:
                if pending:
                    time.sleep(max(pending[0][0] - _now(t0), 0.0))
        return requests
