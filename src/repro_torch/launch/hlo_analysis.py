"""Collective traffic and op statistics of a traced step.

Kept under the JAX module's name so the two packages map one to one, but
PyTorch has no HLO: the port reads the step's dispatch trace instead.
:func:`record` runs a function under a ``TorchDispatchMode`` that lets
DTensor desugar each op first (it returns ``NotImplemented`` for DTensor
arguments, as ``CommDebugMode`` does), so it sees what one rank runs: local
aten ops on local shards, and the ``_c10d_functional`` collectives DTensor
and ``parallel.collectives`` emit, with their per-rank output shapes, as
the JAX package reads per-device shapes from post-SPMD HLO.  Each op's
FLOPs come from ``torch.utils.flop_counter``'s formulas on those local
shapes, and its bytes are its inputs and outputs.  DTensor's own shape
inference, which runs ops on fake tensors of the global shapes, is left
out.  (``FlopCounterMode``
itself counts a DTensor op once, on its global shapes, and misses the local
ops DTensor runs inside it, so a step that mixes DTensor ops and local
products would be counted partly global and partly per rank.)

The same pass follows the step's memory: each storage an op allocates is
live from that op until its last tensor dies, so the peak of live bytes is
the eager sequence's own (:class:`Memory`).  It is not XLA's buffer
assignment: another schedule's temporaries for the same step.

The JAX module's ``while_trip_counts`` has no counterpart: the port's layer
stack is a Python loop, so a trace holds every layer's ops and nothing is
hidden in a loop body to scale.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# ``_c10d_functional`` op -> the collective's name in the JAX package's
# reports (and roofline's wire factors)
COLLECTIVE_OPS = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}


# ops that move no data: metadata queries, allocation without a fill, the
# wait on a collective (its bytes are the collective's)
_NO_DATA = {"prim.device", "aten.empty", "aten.empty_strided",
            "aten.empty_like", "aten.new_empty", "aten.new_empty_strided",
            "aten.detach", "aten.lift_fresh", "aten.alias",
            "aten._local_scalar_dense", "_c10d_functional.wait_tensor"}
# fills: they write their output and read nothing (a tensor argument only
# names the dtype and device)
_OUT_ONLY = {"aten.zeros", "aten.ones", "aten.full", "aten.zeros_like",
             "aten.ones_like", "aten.full_like", "aten.new_zeros",
             "aten.new_ones", "aten.new_full", "aten.arange",
             "aten.scalar_tensor"}

# ops whose result is their input's buffer: a new storage they return (fake
# tensors give ``wait_tensor`` one) is the input's allocation, not another
_SAME_BUFFER = {"_c10d_functional.wait_tensor",
                "_c10d_functional._wrap_tensor_autograd"}


@dataclass
class TracedOp:
    op: str              # "aten.mm", "_c10d_functional.all_reduce", ...
    out_bytes: int       # bytes of the op's tensor outputs on this rank
    flops: int           # this rank's FLOPs (0 outside the FLOP formulas)
    in_bytes: int = 0    # bytes of its tensor inputs


def shape_bytes(shape, dtype: torch.dtype) -> int:
    """Bytes of a tensor of ``shape`` and ``dtype``."""
    n = 1
    for d in shape:
        n *= int(d)
    return n * dtype.itemsize


def _bytes(tree) -> int:
    return sum(shape_bytes(t.shape, t.dtype) for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def storage_ids(tree) -> set:
    """Ids of the storages under ``tree``'s tensors (a DTensor's local
    shard's)."""
    return {id(_local(t).untyped_storage()) for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)}


@dataclass
class Memory:
    """One rank's live storage bytes over a recorded run: ``peak`` is the
    most that the storages its ops allocated held at once (the bytes that
    existed before the run, such as its arguments, not included).
    ``log`` holds each allocation (+bytes) and free (-bytes) in order, by
    allocation number, so that :meth:`peak_without` can leave some
    storages out afterwards."""
    live: int = 0
    peak: int = 0
    counted: dict = field(default_factory=dict)  # live storage id -> number
    log: list = field(default_factory=list)      # (number, +-bytes)

    def alloc(self, storage) -> None:
        key, n, num = id(storage), storage.nbytes(), len(self.log)
        self.counted[key] = num
        self.log.append((num, n))
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self.free, key, n, num)

    def free(self, key: int, n: int, num: int) -> None:
        self.counted.pop(key, None)
        self.log.append((num, -n))
        self.live -= n

    def peak_without(self, ids: set) -> int:
        """The peak of the live bytes with the live storages whose ids are
        in ``ids`` (say, a step's outputs) left out of the whole run."""
        skip = {self.counted[k] for k in ids if k in self.counted}
        live = peak = 0
        for num, n in self.log:
            if num not in skip:
                live += n
                peak = max(peak, live)
        return peak


class _Recorder(TorchDispatchMode):
    def __init__(self, trace: List[TracedOp], memory: Memory):
        super().__init__()
        self.trace = trace
        self.memory = memory
        self.held: dict = {}           # id -> the storage it stands for
        self.paused = 0

    def _track(self, name: str, args, out) -> None:
        """Count each storage that ``out`` holds and that neither an
        input of the op (a view, an in-place op) nor an earlier op gave it:
        one storage is one allocation, whatever views share it."""
        seen = None
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self.memory.counted or key in self.held:
                continue
            if seen is None:
                seen = storage_ids(args)
            if key in seen:
                continue
            if name in _SAME_BUFFER:
                # the input's allocation lives as long as this result
                src = [a for a in tree_leaves(args)
                       if isinstance(a, torch.Tensor)][0]
                self.held[key] = src.untyped_storage()
                weakref.finalize(st, self.held.pop, key)
                continue
            self.memory.alloc(st)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # let DTensor run the local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused:
            return out
        packet = func._overloadpacket
        name = str(packet)
        self._track(name, (args, kwargs), out)
        flops = 0
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        moves = not (func.is_view or name in _NO_DATA)
        self.trace.append(TracedOp(
            name, _bytes(out) if moves else 0, flops,
            _bytes((args, kwargs)) if moves and name not in _OUT_ONLY
            else 0))
        return out


@contextlib.contextmanager
def _pause_during_propagation(rec: _Recorder):
    """DTensor infers an op's output shape by running the op on fake
    tensors of the global shapes (its sharding propagator, on a cache
    miss); those calls are not work a rank runs, so the recorder pauses
    inside them."""
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    name = "_propagate_tensor_meta_non_cached"
    inner = getattr(prop, name)

    def paused(*a, **k):
        rec.paused += 1
        try:
            return inner(*a, **k)
        finally:
            rec.paused -= 1

    setattr(prop, name, paused)
    try:
        yield
    finally:
        delattr(prop, name)       # the class's method again


def record_with_memory(fn: Callable, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` -> (its result, the list of
    :class:`TracedOp` one rank ran, its :class:`Memory`)."""
    trace: List[TracedOp] = []
    memory = Memory()
    rec = _Recorder(trace, memory)
    with _pause_during_propagation(rec), rec:
        out = fn(*args, **kwargs)
    return out, trace, memory


def record(fn: Callable, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` -> (its result, the list of
    :class:`TracedOp` one rank ran)."""
    return record_with_memory(fn, *args, **kwargs)[:2]


def _collective(op: str):
    ns, _, name = op.partition(".")
    if ns in ("_c10d_functional", "c10d_functional"):
        return COLLECTIVE_OPS.get(name)
    return None


def collective_bytes(trace: List[TracedOp]) -> Dict:
    """Per-collective-type bytes (this rank's outputs) and op counts."""
    out: Dict[str, int] = defaultdict(int)
    counts: Dict[str, int] = defaultdict(int)
    for t in trace:
        kind = _collective(t.op)
        if kind:
            out[kind] += t.out_bytes
            counts[kind] += 1
    return {"bytes": dict(out), "counts": dict(counts),
            "total_bytes": sum(out.values())}


def flops(trace: List[TracedOp]) -> int:
    """This rank's FLOPs over the trace."""
    return sum(t.flops for t in trace)


def bytes_accessed(trace: List[TracedOp]) -> int:
    """This rank's bytes read and written, each op's inputs and outputs
    counted once: eager PyTorch runs every op as its own kernel, so nothing
    is fused away.  Views, metadata queries, unfilled allocations and
    collective waits count 0; fills count their output only."""
    return sum(t.in_bytes + t.out_bytes for t in trace)


def op_histogram(trace: List[TracedOp], top: int = 15) -> Dict[str, int]:
    """Op-name histogram of the trace (spots remat recompute and
    redistribution)."""
    hist: Dict[str, int] = defaultdict(int)
    for t in trace:
        hist[t.op] += 1
    return dict(sorted(hist.items(), key=lambda kv: -kv[1])[:top])
