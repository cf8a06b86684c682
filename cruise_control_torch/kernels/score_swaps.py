"""K5: validation and improvement of coupled two-leg actions.

Replaces the JAX package's swap validations, all built on
acceptance.swap_tables_acceptance (:234):
  REPLICA_SWAP      swaps.make_swap_round, the round-start grid (:98-194)
                    and each wave's re-validation (:255-282)
  TOPIC_SWAP        drain.make_topic_swap_round.validate (:485)
  LEADERSHIP_RELAY  drain.make_leadership_relay_round.validate (:692)
Each cell is (p1, s1, b, p2, s2, d): replica (p1, s1) of broker b against
(p2, s2) of broker d for the swaps; for a relay, leadership of p1 moves
b -> d through its slot s1 and leadership of p2 moves d -> the broker in
its slot s2. The six index tensors broadcast to one shape of rank <= 5 and
are read through their strides. The result is the cell's improvement, -inf
where it is not ok; a negative p1, p2, b or d masks the cell.

The CUDA kernel is csrc/score_swaps.cu; the plain versions are
swaps.replica_swap_grid / replica_swap_revalidate and drain.topic_swap_validate
/ relay_validate.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from cruise_control_torch.kernels import build
from cruise_control_torch.kernels.score_candidates import ScoreContext

REPLICA_SWAP = 0
TOPIC_SWAP = 1
LEADERSHIP_RELAY = 2


def score_swaps_plain(kind: int, static, agg, tables, gs, p1, s1, b, p2, s2, d,
                      resource: int = 0, wave: bool = False):
    """f32[broadcast shape]: the improvement of each cell, -inf where not ok."""
    from cruise_control_torch.analyzer import drain, swaps

    if kind == REPLICA_SWAP:
        fn = swaps.replica_swap_revalidate if wave else swaps.replica_swap_grid
        return fn(static, agg, tables, gs, resource, p1, s1, b, p2, s2, d)
    fn = drain.topic_swap_validate if kind == TOPIC_SWAP else drain.relay_validate
    return fn(static, agg, tables, gs, p1, s1, b, p2, s2, d)


#: K5's paths (csrc/score_swaps.cu SwapPath)
PATH_CELLS, PATH_STAGED = 0, 1
PATH_NAMES = ("cells", "staged")
#: the fewest cells for which the replica-swap grid takes the staged path:
#: on an H100 a thread a cell won up to 65,536 cells ([32, 32, 8, 8]: 9.8
#: against 13.8 us) and the staged path from 102,400 ([40, 40, 8, 8]: 13.8
#: against 16.7 us; scripts/kernel_variants.py, PERF.md)
STAGED_MIN_CELLS = 81_920


def layout(*idx):
    """(shape, shape5, strides): the broadcast shape of the six index tensors,
    the same padded to rank 5 in front, and each tensor's five element
    strides at that shape (0 along broadcast axes)."""
    rank = max(t.dim() for t in idx)
    if rank > 5:
        raise ValueError(f"score_swaps: rank {rank} > 5")
    dims = [1] * 5
    for t in idx:
        for i, n in enumerate(t.shape, 5 - t.dim()):
            if n != 1:
                if dims[i] == 1:
                    dims[i] = n
                elif dims[i] != n:
                    raise ValueError(f"score_swaps: shapes {[tuple(x.shape) for x in idx]} "
                                     "do not broadcast")
    strides = []
    for t in idx:
        s5 = [0] * 5
        for i, (n, s) in enumerate(zip(t.shape, t.stride()), 5 - t.dim()):
            if n != 1:
                s5[i] = s
        strides += s5
    return tuple(dims[5 - rank:]), tuple(dims), strides


def choose_path(kind: int, wave: bool, shape5, strides) -> int:
    """The kernel path for a grid of `shape5` read through `strides`
    (`layout`): staged for the replica-swap grid [1, I hot, J cold, A, B]
    (p1 and s1 constant along J and B, the hot broker along J, A and B; p2
    and s2 along I and A, the cold broker along I, A and B) from
    STAGED_MIN_CELLS cells; a thread a cell for everything else."""
    if kind != REPLICA_SWAP or wave or shape5[0] != 1:
        return PATH_CELLS
    st = [tuple(strides[5 * k:5 * k + 5]) for k in range(6)]
    row_side = all(st[k][2] == st[k][4] == 0 for k in (0, 1)) and st[2][2:] == (0, 0, 0)
    col_side = all(st[k][1] == st[k][3] == 0 for k in (3, 4)) and (
        st[5][1] == st[5][3] == st[5][4] == 0)
    cells = shape5[1] * shape5[2] * shape5[3] * shape5[4]
    return PATH_STAGED if row_side and col_side and cells >= STAGED_MIN_CELLS else PATH_CELLS


_ARGTYPES = (build.PTR,) * 10
#: (kind, resource, wave, R, device, dtypes, shapes and strides of the index
#: tensors) -> _Layout: a round calls K5 on a few layouts, over and over
_LAYOUTS = {}
_LAYOUTS_MAX = 4096


class _Layout:
    """A launch layout: the output's shape, the path, and the C entry's
    `layout` argument (d0..d4, the thirty strides, kind, resource, wave,
    path) packed once."""

    __slots__ = ("shape", "path", "name", "packed", "address")

    def __init__(self, shape, shape5, strides, kind, resource, wave, path):
        self.shape, self.path, self.name = shape, path, PATH_NAMES[path]
        self.packed = (ctypes.c_longlong * 39)(*shape5, *strides, kind, resource, int(wave), path)
        self.address = ctypes.addressof(self.packed)


def _launch_layout(kind, resource, wave, idx, a):
    """The _Layout of index tensors `idx` against the assignment `a`, checked
    (int32 tensors on a's device) the first time it is seen."""
    key = (kind, resource, wave, a.shape[1], a.get_device(), *(t.dtype for t in idx),
           *(t.get_device() for t in idx), *(t.shape for t in idx), *(t.stride() for t in idx))
    hit = _LAYOUTS.get(key)
    if hit is None:
        if kind not in (REPLICA_SWAP, TOPIC_SWAP, LEADERSHIP_RELAY):
            raise ValueError(f"score_swaps: unknown kind {kind}")
        if not 0 <= resource < 4:
            raise ValueError(f"score_swaps: unknown resource {resource}")
        for t, name in zip(idx, ("p1", "s1", "b", "p2", "s2", "d")):
            if t.dtype != torch.int32 or t.device != a.device:
                raise TypeError(f"score_swaps: {name} must be int32 on {a.device}")
        shape, shape5, strides = layout(*idx)
        if len(_LAYOUTS) >= _LAYOUTS_MAX:
            _LAYOUTS.clear()
        hit = _LAYOUTS[key] = _Layout(shape, shape5, strides, kind, resource, wave,
                                      choose_path(kind, wave, shape5, strides))
    return hit


def swap_context(ctx, static, agg, tables, gs) -> ScoreContext:
    """`ctx` bound to these inputs (K5 reads no goal: the context keeps its
    own), or a new goal-less context where there is none."""
    if ctx is None:
        return ScoreContext(static, agg, tables, None, gs)
    return ctx.bind(static, agg, tables, ctx.goal, gs)


def score_swaps(kind: int, static, agg, tables, gs, p1, s1, b, p2, s2, d, resource: int = 0,
                wave: bool = False, ctx=None):
    """`score_swaps_plain` for CPU tensors, the CUDA kernel for CUDA tensors.
    `kind` is REPLICA_SWAP, TOPIC_SWAP or LEADERSHIP_RELAY, a Python int (a
    tensor would cost a read of the device); `wave` selects REPLICA_SWAP's
    re-validation form. On the card the index tensors are int32, read in
    place through their strides. `ctx` is the round's ScoreContext (`swap_context`
    builds one when none is given): K5 reads the model, the aggregates, the
    tables and the window from it. On CUDA tensors the replica-swap grid
    takes the staged path, everything else a thread a cell (`choose_path`)."""
    if isinstance(kind, torch.Tensor):
        raise TypeError("score_swaps: kind must be a Python int")
    a = agg.assignment
    idx = (p1, s1, b, p2, s2, d)
    if not a.is_cuda:
        if a.device.type != "cpu":
            raise ValueError(f"score_swaps: expected a CPU or CUDA tensor, got {a.device}")
        return score_swaps_plain(kind, static, agg, tables, gs,
                                 *(t.to(torch.int32) for t in idx), resource=resource, wave=wave)
    lay = _launch_layout(kind, resource, wave, idx, a)
    # the context lives through the call: the C entry reads its struct
    ctx = swap_context(ctx, static, agg, tables, gs)
    address = ctx.pack("score_swaps")
    out = a.new_empty(lay.shape, dtype=torch.float32)
    code = build.entry("score_swaps", _ARGTYPES)(
        address, out.data_ptr(), idx[0].data_ptr(), idx[1].data_ptr(), idx[2].data_ptr(),
        idx[3].data_ptr(), idx[4].data_ptr(), idx[5].data_ptr(), lay.address,
        build.raw_stream(a.get_device()))
    if code:
        build.check(build.load("score_swaps"), code, "score_swaps")
    score_swaps.launches += 1
    score_swaps.paths[lay.name] += 1
    return out


score_swaps.launches = 0
#: the launches by path ("cells", "staged")
score_swaps.paths = collections.Counter()
