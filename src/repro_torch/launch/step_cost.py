"""What one step costs, counted while it runs: the dry run's counterpart of
the JAX package's ``launch/hlo_cost.py``.

JAX's dry run reads its costs from the compiled HLO and has to multiply a
loop body by its trip count.  The port has no HLO: it runs the step
eagerly (on fake tensors in the dry run, see ``launch/dryrun.py``), so
every iteration of every loop dispatches its own ops and each is counted
as it happens.  :class:`StepCost` is a ``TorchDispatchMode`` that counts,
for every op dispatched while it is active:

  * FLOPs, by ``torch.utils.flop_counter.FlopCounterMode`` (products,
    convolutions and attention; elementwise ops count none);
  * bytes accessed: each tensor operand's and output's bytes, an upper
    proxy for memory traffic like JAX's walker (view ops, ``detach``,
    ``empty`` and the ``prim`` metadata queries such as ``t.device`` move
    nothing and count nothing), also summed per site: the
    aten op and its first output's dtype and shape (``"mm
    float32[4096, 768]"``), JAX's ``by_site`` keyed by the fusion or dot
    and its type (:meth:`StepCost.top_sites`);
  * collectives per kind, with their count and link bytes by JAX's
    formulas (:func:`link_bytes`): the functional collectives DTensor
    calls and the ``torch.distributed`` calls of ``distributed/comm.py``
    alike, both being ops of the ``c10d`` namespaces; and the most bytes
    one collective of each kind wrote (an all-gather: the whole it
    made);
  * the live bytes of tensor storage and their peak: the storages of
    :meth:`StepCost.track`'s tensors (what the step is handed) and of
    every op's outputs, each until it is freed.  On fake tensors this is
    the step's peak as the port runs it, with no allocator rounding.

Counts are per rank (this process's), for the work this process
dispatches.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# op name (either c10d namespace) -> kind, JAX's names
_KIND = {
    **dict.fromkeys(("allgather_", "_allgather_base_", "allgather_coalesced_",
                     "allgather_into_tensor_coalesced_",
                     "all_gather_into_tensor",
                     "all_gather_into_tensor_coalesced",
                     "all_gather_into_tensor_out"), "all-gather"),
    **dict.fromkeys(("allreduce_", "allreduce_coalesced_", "all_reduce",
                     "all_reduce_coalesced"), "all-reduce"),
    **dict.fromkeys(("reduce_scatter_", "_reduce_scatter_base_",
                     "reduce_scatter_tensor_coalesced_",
                     "reduce_scatter_tensor",
                     "reduce_scatter_tensor_coalesced"), "reduce-scatter"),
    **dict.fromkeys(("alltoall_", "alltoall_base_", "all_to_all_single"),
                    "all-to-all"),
    **dict.fromkeys(("send", "recv_", "recv_any_source_"),
                    "collective-permute"),
}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")
_NO_TRAFFIC = ("detach", "empty", "empty_like", "empty_strided", "lift_fresh",
               "wait_tensor", "barrier", "monitored_barrier")


def link_bytes(kind: str, out_bytes: int, group_size: int) -> int:
    """A collective's bytes over the links of one rank, JAX's formulas
    (``launch/dryrun.py::parse_collectives``): an all-gather receives its
    output, a ring all-reduce moves twice its bytes, a ring reduce-scatter
    its output times (group - 1), an all-to-all and a permute their
    output."""
    if kind == "all-reduce":
        return 2 * out_bytes
    if kind == "reduce-scatter":
        return out_bytes * max(group_size - 1, 1)
    return out_bytes


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local block; any other tensor itself."""
    return getattr(t, "_local_tensor", t)


def _tensors(tree) -> list:
    """The tensors (DTensors by their local blocks) of an op's arguments
    or outputs, or of a state: dataclasses, dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return [_local(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _site(name: str, out) -> str:
    """An op's site key: its name and its first output's dtype and shape,
    cut to JAX's 48 characters of type string."""
    outs = _tensors(out)
    if not outs:
        return name
    t = outs[0]
    dtype = str(t.dtype).removeprefix("torch.")
    return f"{name} {(dtype + str(list(t.shape)))[:48]}"


def _group_size(args, kwargs) -> int:
    """The group size a collective names: an int ``group_size``, a
    process group, or a group name."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    flat = tree_flatten((args, kwargs))[0]
    for a in flat:
        if isinstance(a, dist.ProcessGroup):
            return a.size()
    sized = [a for a in flat if isinstance(a, int) and not isinstance(a, bool)]
    for a in flat:
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (KeyError, RuntimeError, ValueError):
                continue
    return sized[0] if sized else 1


class StepCost(TorchDispatchMode):
    """Counts a step's FLOPs, bytes accessed, collectives and peak live
    storage (see the module docstring).  Use as a context manager::

        cost = StepCost()
        cost.track(state, batch)
        with cost:
            step(state, batch)
        cost.flops, cost.bytes_accessed, cost.collectives, cost.peak_bytes
    """

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self._flop_mode = FlopCounterMode(display=False)
        self.bytes_accessed = 0
        self.by_site: dict = collections.defaultdict(int)
        self.collectives: dict = collections.defaultdict(
            lambda: {"count": 0, "bytes": 0})
        # kind -> the most bytes one collective of the kind wrote
        self.largest: dict = collections.defaultdict(int)
        self.live_bytes = 0
        self.peak_bytes = 0
        self.peak_op = None         # the op whose output set the peak
        self._op = None
        self._live: dict = {}       # id(storage) -> its weakref.finalize

    # -- live storage ------------------------------------------------------
    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live and self._live[key].alive:
            return
        n = st.nbytes()
        self._live[key] = weakref.finalize(st, self._free, key, n)
        self.live_bytes += n
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes, self.peak_op = self.live_bytes, self._op

    def _free(self, key: int, n: int) -> None:
        self._live.pop(key, None)
        self.live_bytes -= n

    def track(self, *trees) -> None:
        """Count the storage of every tensor in ``trees`` (DTensors by
        their local blocks) as live from now until it is freed."""
        for t in _tensors(trees):
            self._hold(t)

    # -- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name.split("::")[-1]
        self._op = name
        if func.namespace in _COLLECTIVE_NAMESPACES:
            if name in _NO_TRAFFIC:
                return out
            # the legacy c10d ops write their first argument in place;
            # the functional ones return their output
            written = out if func.namespace != "c10d" else args[0]
            nbytes = sum(_nbytes(t) for t in _tensors(written))
            kind = _KIND.get(name, name)
            rec = self.collectives[kind]
            rec["count"] += 1
            rec["bytes"] += link_bytes(kind, nbytes,
                                       _group_size(args, kwargs))
            self.largest[kind] = max(self.largest[kind], nbytes)
        elif not (func.is_view or name in _NO_TRAFFIC
                  or func.namespace == "prim"):
            nbytes = sum(_nbytes(t) for t in _tensors((args, kwargs, out)))
            self.bytes_accessed += nbytes
            self.by_site[_site(name, out)] += nbytes
        for t in _tensors(out):
            self._hold(t)
        return out

    def __enter__(self):
        self._flop_mode.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._flop_mode.__exit__(*exc)

    @property
    def flops(self) -> int:
        return self._flop_mode.get_total_flops()

    @property
    def collective_bytes(self) -> int:
        return sum(v["bytes"] for v in self.collectives.values())

    def top_sites(self, n: int = 12) -> list:
        """The ``n`` sites with the most bytes accessed, as ``(site,
        bytes)`` pairs, most first (JAX's ``HloCost.top_sites``)."""
        return sorted(self.by_site.items(), key=lambda kv: -kv[1])[:n]

    def summary(self) -> dict:
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed,
                "top_sites": self.top_sites(10),
                "collectives": {k: dict(v) for k, v in
                                self.collectives.items()},
                "collective_bytes": self.collective_bytes,
                "largest_collective": dict(self.largest),
                "peak_bytes": self.peak_bytes, "peak_op": self.peak_op}
