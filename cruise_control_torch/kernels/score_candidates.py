"""K3: masked scores of candidate actions under one goal of the default stack.

Replaces cruise_control_tpu/analyzer/acceptance.py score_batch (:330) fed by
actions.build_selected (:189). The CUDA kernel is csrc/score_candidates.cu,
its per-candidate body (a source half, a destination half and their
combine) in csrc/score_goal.cuh (shared with K9); `score_candidates_plain`
(= build_selected + acceptance.score_batch) is the PyTorch version.

A launch reads the round's tensors through a `ScoreContext`: the addresses
of the model, the aggregates, the tables and the goal's limit and window,
packed once into a C struct laid out as `struct ScoreCtx`. The round
functions build one where their `gs` and `tables` are fixed and pass it to
every call of the round (`agg` is updated in place, so its addresses hold).
"""

from __future__ import annotations

import collections
import ctypes

import torch

from cruise_control_torch.analyzer.acceptance import score_batch
from cruise_control_torch.analyzer.actions import build_selected
from cruise_control_torch.kernels import build

#: the pointer fields of `struct ScoreCtx` (csrc/score_goal.cuh), in order,
#: then its four ints
CTX_POINTERS = (
    "assignment", "part_load", "topic_id", "capacity", "broker_rack", "broker_host", "dead",
    "replica_dst_ok", "leadership_dst_ok", "movable", "host_cpu_cap_limit", "broker_load",
    "replica_count", "leader_count", "potential", "leader_nw_in", "rack_count", "topic_count",
    "host_cpu", "hi_load", "lo_load", "band_hi", "band_lo", "band_on", "hi_rep", "lo_rep",
    "hi_lead", "lo_lead", "hi_pnw", "hi_lnw", "waive_dead", "hi_topic", "lo_topic", "hi_host_cpu",
    "rack_enabled", "limit", "max_replicas", "w_lower", "w_upper", "w_active", "only_immigrants",
    "capacity_limit",
)
CTX_INTS = ("R", "NR", "B", "goal")
#: the [*, 4] tables the kernels read a row of as one 16-byte load, and the
#: part_load rows they read as 8-byte loads: byte alignment each needs
CTX_ALIGN = {"capacity": 16, "broker_load": 16, "hi_load": 16, "lo_load": 16, "band_hi": 16,
             "band_lo": 16, "capacity_limit": 16, "part_load": 8}


class ScoreCtxStruct(ctypes.Structure):
    """`struct ScoreCtx` of csrc/score_goal.cuh."""

    _fields_ = [(n, ctypes.c_void_p) for n in CTX_POINTERS] + [(n, ctypes.c_int) for n in CTX_INTS]


def score_candidates_plain(static, agg, tables, goal, gs, p, kind, slot, dst):
    """f32[broadcast shape]: the score of each (p, kind, slot, dst) action,
    -inf where it is not acceptable."""
    act = build_selected(static.part_load, agg.assignment, p, kind, slot, dst)
    return score_batch(static, agg, act, goal, gs, tables)


#: per device: the read-only True that stands for a window's `active` flag
#: where the goal has no window, made once (not a fill launch a context)
_ALWAYS_ACTIVE = {}


def _always_active(dev) -> torch.Tensor:
    t = _ALWAYS_ACTIVE.get(dev)
    if t is None:
        t = _ALWAYS_ACTIVE[dev] = torch.ones((), dtype=torch.bool, device=dev)
    return t


def _context_tensors(static, agg, tables, goal, gs):
    """The tensors of `struct ScoreCtx`, in its order."""
    dev = agg.assignment.device
    # the capacity goals' usable capacity, PotentialNwOutGoal's limit, and
    # the soft goals' window (per topic for the topic goal); unused
    # arguments get a placeholder (K5's contexts have no goal)
    if goal is not None and hasattr(goal, "limit"):
        limit = goal.limit(static).contiguous()
    elif gs is not None and hasattr(gs, "limit"):
        limit = gs.limit
    else:
        limit = static.host_cpu_capacity_limit
    has_window = gs is not None and hasattr(gs, "upper")
    w_lower = gs.lower.contiguous() if has_window else limit
    w_upper = gs.upper.contiguous() if has_window else limit
    w_active = getattr(gs, "active", None)
    if w_active is None:
        w_active = _always_active(dev)
    return (
        agg.assignment, static.part_load, static.topic_id, static.broker_capacity,
        static.broker_rack, static.broker_host, static.dead, static.replica_dst_ok,
        static.leadership_dst_ok, static.movable_partition, static.host_cpu_capacity_limit,
        agg.broker_load, agg.replica_count, agg.leader_count, agg.potential_nw_out,
        agg.leader_nw_in, agg.rack_replica_count, agg.topic_replica_count, agg.host_cpu_load,
        *tables, limit, static.max_replicas_per_broker, w_lower, w_upper, w_active,
        static.only_move_immigrants, static.capacity_limit,
    )


class ScoreContext:
    """What every K3 / K9 launch of one goal's round reads: strong references
    to the round's `static`, `agg`, `tables`, `goal` and `gs` and, packed at
    the first launch, their tensors' addresses in a `ScoreCtxStruct`. K5
    reads the same struct from a context built with `goal` None.

    `bind` checks by identity that the context was built from the objects a
    call passes; on a mismatch it rebuilds (counted in `rebuilds`), so a
    launch never reads a stale address. The inputs are NamedTuples, so the
    same object always holds the same tensors."""

    #: contexts packed, and rebuilt on a mismatch, in this process
    packs = 0
    rebuilds = 0

    __slots__ = ("static", "agg", "tables", "goal", "gs", "tensors", "struct", "address")

    def __init__(self, static, agg, tables, goal, gs):
        self._hold(static, agg, tables, goal, gs)

    def _hold(self, static, agg, tables, goal, gs):
        self.static, self.agg, self.tables, self.goal, self.gs = static, agg, tables, goal, gs
        self.tensors = self.struct = self.address = None

    def bind(self, static, agg, tables, goal, gs) -> "ScoreContext":
        if not (static is self.static and agg is self.agg and tables is self.tables
                and goal is self.goal and gs is self.gs):
            self._hold(static, agg, tables, goal, gs)
            ScoreContext.rebuilds += 1
        return self

    def pack(self, what: str) -> int:
        """The address of the packed struct, packing it the first time:
        every tensor checked once for its device and contiguity."""
        if self.address is None:
            goal, agg = self.goal, self.agg
            if goal is not None and goal.kernel_id is None:
                raise NotImplementedError(f"{what}: no kernel case for {goal.name}")
            tensors = _context_tensors(self.static, agg, self.tables, goal, self.gs)
            dev = agg.assignment.device
            for t, name in zip(tensors, CTX_POINTERS):
                if t.device != dev or not t.is_contiguous():
                    raise ValueError(f"{what}: context tensors must be contiguous and on {dev}")
                if t.data_ptr() % CTX_ALIGN.get(name, 1):
                    raise ValueError(f"{what}: {name} must be {CTX_ALIGN[name]}-byte aligned")
            self.tensors = tensors
            self.struct = ScoreCtxStruct(
                *(t.data_ptr() for t in tensors), agg.assignment.shape[1],
                agg.rack_replica_count.shape[1], agg.broker_load.shape[0],
                -1 if goal is None else goal.kernel_id)
            self.address = ctypes.addressof(self.struct)
            ScoreContext.packs += 1
        return self.address


def bound_context(ctx, static, agg, tables, goal, gs) -> ScoreContext:
    """`ctx` bound to these inputs, or a new context where there is none."""
    if ctx is None:
        return ScoreContext(static, agg, tables, goal, gs)
    return ctx.bind(static, agg, tables, goal, gs)


#: K3's paths (csrc/score_candidates.cu ScorePath)
PATH_GENERAL, PATH_FACTORED, PATH_PROMOTION = 0, 1, 2
PATH_NAMES = ("general", "factored", "promotion")
#: the fewest cells for which the factored tiles beat a thread a cell: on
#: an H100 the tiles take ~7.5 us up to 65,536 cells, where a thread a cell
#: takes 4.6-5.7 us, and win from 131,072 cells (PERF.md, PR 10)
FACTORED_MIN_CELLS = 1 << 17


def layout(*idx):
    """(shape, shape3, strides): the broadcast shape of the index tensors, the
    same padded to rank 3 in front, and each tensor's three element strides
    at that shape (p, kind, slot, dst in turn; 0 along broadcast axes)."""
    rank = max(t.dim() for t in idx)
    if rank > 3:
        raise ValueError(f"score_candidates: rank {rank} > 3")
    dims = [1, 1, 1]
    for t in idx:
        # cclint: disable=cuda-python-loop -- loops over a tensor's rank (at most 5 dims), not a model axis
        for i, n in enumerate(t.shape, 3 - t.dim()):
            if n != 1:
                if dims[i] == 1:
                    dims[i] = n
                elif dims[i] != n:
                    raise ValueError(f"score_candidates: shapes {[tuple(x.shape) for x in idx]} "
                                     "do not broadcast")
    strides = []
    for t in idx:
        s3 = [0, 0, 0]
        # cclint: disable=cuda-python-loop -- loops over a tensor's rank (at most 5 dims), not a model axis
        for i, (n, s) in enumerate(zip(t.shape, t.stride()), 3 - t.dim()):
            if n != 1:
                s3[i] = s
        strides += s3
    return tuple(dims[3 - rank:]), tuple(dims), strides


def choose_path(shape3, strides, r: int) -> int:
    """The kernel path for a grid of `shape3` read through `strides`
    (`layout`), for assignment rows of `r` slots. Where p, kind and slot are
    constant along the last axis and dst along the first two (a grid of
    rows by destinations): factored from FACTORED_MIN_CELLS cells, else
    promotion (a thread a cell), which also takes the layouts whose dst
    depends on the first axis (the pair drain's per-row lists: tiles of a
    few rows). Promotion where p and kind are constant along a last axis of
    at most r - 1 cells. Else general."""
    sp, sk, ss, sd = strides[0:3], strides[3:6], strides[6:9], strides[9:12]
    if shape3[2] > 1 and sp[2] == sk[2] == ss[2] == 0 and sd[1] == 0:
        big = shape3[0] * shape3[1] * shape3[2] >= FACTORED_MIN_CELLS
        per_row = sd[0] != 0 and shape3[0] > 1
        return PATH_FACTORED if big and not per_row else PATH_PROMOTION
    if shape3[2] <= r - 1 and sp[2] == sk[2] == 0:
        return PATH_PROMOTION
    return PATH_GENERAL


_ARGTYPES = (build.PTR,) * 8
#: (R, device, dtypes, shapes and strides of the index tensors) -> _Layout:
#: a round calls K3 on a few layouts, over and over
_LAYOUTS = {}
_LAYOUTS_MAX = 4096


class _Layout:
    """A launch layout: the output's shape, the path, and the C entry's
    `layout` argument (d0, d1, d2, the twelve strides, the path) packed once."""

    __slots__ = ("shape", "path", "name", "packed", "address")

    def __init__(self, shape, shape3, strides, path):
        self.shape, self.path, self.name = shape, path, PATH_NAMES[path]
        self.packed = (ctypes.c_longlong * 16)(*shape3, *strides, path)
        self.address = ctypes.addressof(self.packed)


def _launch_layout(idx, a):
    """The _Layout of index tensors `idx` against the assignment `a`, checked
    (int32 tensors on a's device) the first time it is seen."""
    key = (a.shape[1], a.get_device(), *(t.dtype for t in idx), *(t.get_device() for t in idx),
           *(t.shape for t in idx), *(t.stride() for t in idx))
    hit = _LAYOUTS.get(key)
    if hit is None:
        for t, name in zip(idx, ("p", "kind", "slot", "dst")):
            if t.dtype != torch.int32 or t.device != a.device:
                raise TypeError(f"score_candidates: {name} must be int32 on {a.device}")
        shape, shape3, strides = layout(*idx)
        if len(_LAYOUTS) >= _LAYOUTS_MAX:
            _LAYOUTS.clear()
        hit = _LAYOUTS[key] = _Layout(shape, shape3, strides,
                                      choose_path(shape3, strides, a.shape[1]))
    return hit


def score_candidates(static, agg, tables, goal, gs, p, kind, slot, dst, ctx=None):
    """`score_candidates_plain` for CPU tensors, the CUDA kernel for CUDA
    tensors. The index tensors broadcast to a common shape of rank <= 3 and
    may be strided views; the kernel reads them through their strides. `ctx`
    is the round's ScoreContext (one is built when none is given)."""
    a = agg.assignment
    if not a.is_cuda:
        if a.device.type != "cpu":
            raise ValueError(f"score_candidates: expected a CPU or CUDA tensor, got {a.device}")
        kind = torch.as_tensor(kind, dtype=torch.int32, device=a.device)
        return score_candidates_plain(static, agg, tables, goal, gs, p, kind, slot, dst)
    if not isinstance(kind, torch.Tensor):
        kind = torch.tensor(kind, dtype=torch.int32, device=a.device)
    lay = _launch_layout((p, kind, slot, dst), a)
    # the context lives through the call: the C entry reads its struct
    ctx = bound_context(ctx, static, agg, tables, goal, gs)
    address = ctx.pack("score_candidates")
    out = a.new_empty(lay.shape, dtype=torch.float32)
    code = build.entry("score_candidates", _ARGTYPES)(
        address, out.data_ptr(), p.data_ptr(), kind.data_ptr(), slot.data_ptr(), dst.data_ptr(),
        lay.address, build.raw_stream(a.get_device()))
    if code:
        build.check(build.load("score_candidates"), code, "score_candidates")
    score_candidates.launches += 1
    score_candidates.cases[goal.kernel_id] += 1
    score_candidates.paths[lay.name] += 1
    return out


score_candidates.launches = 0
#: the launches by goal case (goal.kernel_id)
score_candidates.cases = collections.Counter()
#: the launches by path ("factored", "promotion", "general")
score_candidates.paths = collections.Counter()
