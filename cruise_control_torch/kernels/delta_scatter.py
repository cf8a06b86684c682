"""K10: scatter a delta batch into a copy of the static context.

Replaces cruise_control_tpu/analyzer/incremental.py apply_delta_batch
(:162), the incremental lane's scatter: broker states, partition load rows
and partition-add topic ids are written from a NOOP-padded batch, the
partition count grows by the adds, and the state-derived broker masks are
recomputed with build_static_ctx's expressions. The CUDA kernel is
csrc/delta_scatter.cu; `delta_scatter_plain` is the PyTorch version.

Writes follow the reference's jitted `.at[].set(mode="drop")` on XLA:CPU: a
row of another kind writes nowhere, a negative index counts from the end, an
index still outside the axis is dropped, and of two rows naming one target
the later one lands. Both versions return fresh tensors: the input context
belongs to the optimizer's prep cache and stays as it was.
"""

from __future__ import annotations

import torch

from cruise_control_torch.common.resources import BrokerState
from cruise_control_torch.kernels import build

#: the batch's kind codes (incremental.py:81-84)
KIND_NOOP = 0
KIND_STATE = 1
KIND_LOAD = 2
KIND_PART_ADD = 3
#: partition rows (and brokers) a block of the kernel owns
#: (csrc/delta_scatter.cu DS_TILE)
TILE = 512


def _landing(kind_ok: torch.Tensor, idx: torch.Tensor, n: int):
    """(targets, keep): the batch rows whose write lands (`keep`, bool[D])
    and their targets in [0, n), one per target: a later landing row to the
    same target shadows an earlier one."""
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    ok = kind_ok & (idx >= 0) & (idx < n)
    d = idx.shape[0]
    later = torch.ones(d, d, dtype=torch.bool, device=idx.device).triu(1)
    shadowed = torch.any((idx[:, None] == idx[None, :]) & ok[None, :] & later, dim=1)
    keep = ok & ~shadowed
    return idx[keep], keep


def delta_scatter_plain(static, batch, base_replica_dst: torch.Tensor,
                        base_leadership_dst: torch.Tensor):
    """The StaticCtx after `batch` (a DeltaBatch: kind, broker, state, row,
    topic i32[D], load f32[D, M]); `base_*_dst` are the state-independent
    factors of the destination masks, bool[B]."""
    b, p = static.broker_state.shape[0], static.part_load.shape[0]
    kind = batch.kind
    b_idx, b_keep = _landing(kind == KIND_STATE, batch.broker, b)
    state = static.broker_state.clone()
    state[b_idx] = batch.state[b_keep]
    valid = static.broker_valid
    alive = (state != BrokerState.DEAD) & valid
    demoted = (state == BrokerState.DEMOTED) & valid
    r_idx, r_keep = _landing((kind == KIND_LOAD) | (kind == KIND_PART_ADD), batch.row, p)
    part_load = static.part_load.clone()
    part_load[r_idx] = batch.load[r_keep]
    t_idx, t_keep = _landing(kind == KIND_PART_ADD, batch.row, p)
    topic_id = static.topic_id.clone()
    topic_id[t_idx] = batch.topic[t_keep]
    adds = torch.sum(kind == KIND_PART_ADD).to(torch.float32)
    return static._replace(
        broker_state=state,
        alive=alive,
        dead=(state == BrokerState.DEAD) & valid,
        new=(state == BrokerState.NEW) & valid,
        demoted=demoted,
        replica_dst_ok=alive & base_replica_dst,
        leadership_dst_ok=alive & ~demoted & base_leadership_dst,
        part_load=part_load,
        topic_id=topic_id,
        num_valid_partitions=static.num_valid_partitions + adds,
    )


def _refuse(static, batch, base_replica_dst, base_leadership_dst):
    """Raise the first reason the kernel does not take these inputs."""
    dev = static.part_load.device
    p, m = static.part_load.shape if static.part_load.dim() == 2 else (0, 0)
    b = static.broker_state.shape[0] if static.broker_state.dim() else 0
    d = batch.kind.shape[0] if batch.kind.dim() else 0
    for name, t in (("kind", batch.kind), ("broker", batch.broker), ("state", batch.state),
                    ("row", batch.row), ("topic", batch.topic)):
        build.require(t, torch.int32, 1, f"batch.{name}", dev)
        if t.shape[0] != d:
            raise ValueError(f"delta_scatter: batch.{name} has {t.shape[0]} rows, expected {d}")
    build.require(batch.load, torch.float32, 2, "batch.load", dev)
    if tuple(batch.load.shape) != (d, m):
        raise ValueError(f"delta_scatter: batch.load has shape {tuple(batch.load.shape)}, "
                         f"expected {(d, m)}")
    for name, t, dtype, shape in (("broker_state", static.broker_state, torch.int32, (b,)),
                                  ("broker_valid", static.broker_valid, torch.bool, (b,)),
                                  ("base_replica_dst", base_replica_dst, torch.bool, (b,)),
                                  ("base_leadership_dst", base_leadership_dst, torch.bool, (b,)),
                                  ("part_load", static.part_load, torch.float32, (p, m)),
                                  ("topic_id", static.topic_id, torch.int32, (p,)),
                                  ("num_valid_partitions", static.num_valid_partitions,
                                   torch.float32, ())):
        build.require(t, dtype, len(shape), name, dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"delta_scatter: {name} has shape {tuple(t.shape)}, expected {shape}")
    raise ValueError("delta_scatter: the inputs disagree")


_ARGTYPES = (build.PTR,) * 18 + (build.INT,) * 4 + (build.PTR,)
_I32, _F32, _BOOL = torch.int32, torch.float32, torch.bool


def delta_scatter(static, batch, base_replica_dst: torch.Tensor,
                  base_leadership_dst: torch.Tensor):
    """`delta_scatter_plain` for a context on the CPU, the CUDA kernel for
    one on the card (one launch, for a batch of any size). The six broker
    masks are the rows of one [6, B] tensor."""
    pl = static.part_load
    if pl.device.type == "cpu":
        return delta_scatter_plain(static, batch, base_replica_dst, base_leadership_dst)
    kind, brk, stt, row, top, load = batch
    state_in, valid, topic_in, nvp_in = (static.broker_state, static.broker_valid,
                                         static.topic_id, static.num_valid_partitions)
    rep, lead = base_replica_dst, base_leadership_dst
    idx = pl.get_device()
    d, b = kind.shape[0], state_in.shape[0]
    # cclint: disable=cuda-shape-branch -- a guard that refuses what the kernel does not take; it picks no launch sequence
    if not (idx >= 0 and pl.dtype is _F32 and load.dtype is _F32 and nvp_in.dtype is _F32
            and kind.dtype is _I32 and brk.dtype is _I32 and stt.dtype is _I32
            and row.dtype is _I32 and top.dtype is _I32 and state_in.dtype is _I32
            and topic_in.dtype is _I32 and valid.dtype is _BOOL and rep.dtype is _BOOL
            and lead.dtype is _BOOL and pl.dim() == 2 and kind.dim() == 1
            and state_in.dim() == 1 and brk.shape == (d,)
            and stt.shape == (d,) and row.shape == (d,) and top.shape == (d,)
            and load.shape == (d, pl.shape[1]) and valid.shape == (b,) and rep.shape == (b,)
            and lead.shape == (b,) and topic_in.shape == (pl.shape[0],) and nvp_in.dim() == 0
            and kind.get_device() == idx and brk.get_device() == idx
            and stt.get_device() == idx and row.get_device() == idx
            and top.get_device() == idx and load.get_device() == idx
            and state_in.get_device() == idx and valid.get_device() == idx
            and rep.get_device() == idx and lead.get_device() == idx
            and topic_in.get_device() == idx and nvp_in.get_device() == idx
            and kind.is_contiguous() and brk.is_contiguous() and stt.is_contiguous()
            and row.is_contiguous() and top.is_contiguous() and load.is_contiguous()
            and state_in.is_contiguous() and valid.is_contiguous() and rep.is_contiguous()
            and lead.is_contiguous() and pl.is_contiguous() and topic_in.is_contiguous()):
        _refuse(static, batch, base_replica_dst, base_leadership_dst)
    p, m = pl.shape
    state = state_in.new_empty(b)
    masks = valid.new_empty((6, b))
    part_load = pl.new_empty((p, m))
    topic_id = topic_in.new_empty(p)
    nvp = nvp_in.new_empty(())
    code = build.entry("delta_scatter", _ARGTYPES)(
        kind.data_ptr(), brk.data_ptr(), stt.data_ptr(), row.data_ptr(), top.data_ptr(),
        load.data_ptr(), state_in.data_ptr(), valid.data_ptr(), rep.data_ptr(),
        lead.data_ptr(), pl.data_ptr(), topic_in.data_ptr(), nvp_in.data_ptr(),
        state.data_ptr(), masks.data_ptr(), part_load.data_ptr(), topic_id.data_ptr(),
        nvp.data_ptr(), d, m, b, p, build.raw_stream(idx))
    if code:
        build.check(build.load("delta_scatter"), code, "delta_scatter")
    delta_scatter.launches += 1
    alive, dead, new, demoted, replica_dst_ok, leadership_dst_ok = masks.unbind(0)
    return static._replace(
        broker_state=state, alive=alive, dead=dead, new=new, demoted=demoted,
        replica_dst_ok=replica_dst_ok, leadership_dst_ok=leadership_dst_ok,
        part_load=part_load, topic_id=topic_id, num_valid_partitions=nvp,
    )


delta_scatter.launches = 0
