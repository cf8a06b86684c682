"""K12: the partition-axis mesh's merge of the shards' shortlist records.

Replaces the global offset and the merge of
cruise_control_tpu/parallel/spmd.py make_grid_shortlist (:170-171,
:185-189): each shard's [k_loc] winner records (score, local partition,
kind, slot, dst) get their shard's row offset, then after the all-gather
they are ordered by `jnp.lexsort((g_p, -g_score))` and the first k_sel
kept, which reproduces `lax.top_k`'s order over the whole partition axis:
score descending, ties to the lowest global index. Scores compare as floats
(-0.0 ties +0.0, as JAX's sort treats them); a NaN score ranks after every
other, ties among NaNs by index (JAX's sort puts NaN last). A shard whose
every score is -inf still competes by index, so a round with no finite cell
picks global row 0.

The records arrive as the shards wrote them, record j from shard j // k_loc
with its local row; the global partition is (j // k_loc) * p_local + local
in int32 arithmetic that wraps as JAX's does. The CUDA kernel is
csrc/shard_merge.cu: it forms the global partition itself (no launch
between the shards' K9 and it) and ranks each record against all, in one
warp's registers up to 32 records, in shared memory up to 4,096, in device
memory beyond; the record is written at its rank when that is below k_sel.
`shard_merge_plain` is the PyTorch version: the offsets added, then two
stable argsorts.
"""

from __future__ import annotations

import torch

from cruise_control_torch.kernels import build

_ARGTYPES = (build.PTR,) * 4 + (build.INT,) * 4 + (build.PTR,)


def global_records(rec: torch.Tensor, k_loc: int, p_local: int) -> torch.Tensor:
    """i32[n, 4]: `rec` with each record's local partition made global, record
    j from shard j // k_loc: (j // k_loc) * p_local + local, wrapped to int32
    as JAX's int32 arithmetic wraps."""
    n = rec.shape[0]
    shard = torch.arange(n, dtype=torch.int64, device=rec.device) // k_loc
    g = shard * p_local + rec[:, 0].long()
    out = rec.clone()
    out[:, 0] = (((g + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)
    return out


def shard_merge_plain(score: torch.Tensor, rec: torch.Tensor, k_sel: int, k_loc: int,
                      p_local: int):
    """(score f32[k], rec i32[4, k]) with k = min(k_sel, n): the first k of
    the n records `score` f32[n], `rec` i32[n, 4] (local partition, kind,
    slot, dst; record j from shard j // k_loc of p_local rows) in lexsort
    order (global partition, then -score), their partitions global."""
    rec = global_records(rec, k_loc, p_local)
    by_p = torch.argsort(rec[:, 0], stable=True)
    # -0.0 ties +0.0; torch's sort puts NaN last, as JAX's does
    key = torch.where(score == 0, torch.zeros_like(score), -score)[by_p]
    sel = by_p[torch.argsort(key, stable=True)][:k_sel]
    return score[sel], rec[sel].t().contiguous()


def shard_merge(score: torch.Tensor, rec: torch.Tensor, k_sel: int, k_loc: int, p_local: int):
    """`shard_merge_plain` for CPU tensors, the CUDA kernel for CUDA tensors
    (fresh outputs each call)."""
    if score.device.type == "cpu":
        return shard_merge_plain(score, rec, k_sel, k_loc, p_local)
    dev = score.device
    n = score.shape[0] if score.dim() == 1 else -1
    if not (n >= 1 and k_sel >= 1 and 1 <= k_loc < 2**31 and 0 <= p_local < 2**31):
        raise ValueError(f"shard_merge: need n >= 1 records, k_sel >= 1, 1 <= k_loc < 2**31 "
                         f"and 0 <= p_local < 2**31, got {tuple(score.shape)}, {k_sel}, {k_loc} "
                         f"and {p_local}")
    build.require(score, torch.float32, 1, "score", dev)
    build.require(rec, torch.int32, 2, "rec", dev)
    if tuple(rec.shape) != (n, 4):
        raise ValueError(f"shard_merge: rec has shape {tuple(rec.shape)}, expected ({n}, 4)")
    k = min(k_sel, n)
    out_score = torch.empty(k, dtype=torch.float32, device=dev)
    out_rec = torch.empty((4, k), dtype=torch.int32, device=dev)
    code = build.entry("shard_merge", _ARGTYPES)(
        score.data_ptr(), rec.data_ptr(), out_score.data_ptr(), out_rec.data_ptr(), n, k,
        k_loc, p_local, build.raw_stream(dev.index))
    if code:
        build.check(build.load("shard_merge"), code, "shard_merge")
    shard_merge.launches += 1
    return out_score, out_rec


shard_merge.launches = 0
