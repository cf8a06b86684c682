"""K12: the partition-axis mesh's merge of the shards' shortlist records.

Replaces the merge of cruise_control_tpu/parallel/spmd.py
make_grid_shortlist (:183-190): after the all-gather, every shard's [k_loc]
winner records (score, global partition, kind, slot, dst) are ordered by
`jnp.lexsort((g_p, -g_score))` and the first k_sel kept, which reproduces
`lax.top_k`'s order over the whole partition axis: score descending, ties
to the lowest global index. Scores compare as floats (-0.0 ties +0.0, as
JAX's sort treats them); a NaN score ranks after every other, ties among
NaNs by index (JAX's sort puts NaN last). A shard whose every score is -inf
still competes by index, so a round with no finite cell picks global row 0.

The CUDA kernel is csrc/shard_merge.cu: one block, each record's rank the
count of records that beat it, the record written at its rank when that is
below k_sel. `shard_merge_plain` is the PyTorch version: two stable
argsorts.
"""

from __future__ import annotations

import torch

from cruise_control_torch.kernels import build

_ARGTYPES = (build.PTR,) * 4 + (build.INT,) * 2 + (build.PTR,)


def shard_merge_plain(score: torch.Tensor, rec: torch.Tensor, k_sel: int):
    """(score f32[k], rec i32[4, k]) with k = min(k_sel, n): the first k of
    the n records `score` f32[n], `rec` i32[n, 4] (global partition, kind,
    slot, dst) in lexsort order (global partition, then -score)."""
    by_p = torch.argsort(rec[:, 0], stable=True)
    # -0.0 ties +0.0; torch's sort puts NaN last, as JAX's does
    key = torch.where(score == 0, torch.zeros_like(score), -score)[by_p]
    sel = by_p[torch.argsort(key, stable=True)][:k_sel]
    return score[sel], rec[sel].t().contiguous()


def shard_merge(score: torch.Tensor, rec: torch.Tensor, k_sel: int):
    """`shard_merge_plain` for CPU tensors, the CUDA kernel for CUDA tensors
    (fresh outputs each call)."""
    if score.device.type == "cpu":
        return shard_merge_plain(score, rec, k_sel)
    dev = score.device
    n = score.shape[0] if score.dim() == 1 else -1
    if not (n >= 1 and k_sel >= 1):
        raise ValueError(f"shard_merge: need n >= 1 records and k_sel >= 1, got "
                         f"{tuple(score.shape)} and {k_sel}")
    build.require(score, torch.float32, 1, "score", dev)
    build.require(rec, torch.int32, 2, "rec", dev)
    if tuple(rec.shape) != (n, 4):
        raise ValueError(f"shard_merge: rec has shape {tuple(rec.shape)}, expected ({n}, 4)")
    k = min(k_sel, n)
    out_score = torch.empty(k, dtype=torch.float32, device=dev)
    out_rec = torch.empty((4, k), dtype=torch.int32, device=dev)
    code = build.entry("shard_merge", _ARGTYPES)(
        score.data_ptr(), rec.data_ptr(), out_score.data_ptr(), out_rec.data_ptr(), n, k,
        build.raw_stream(dev.index))
    if code:
        build.check(build.load("shard_merge"), code, "shard_merge")
    shard_merge.launches += 1
    return out_score, out_rec


shard_merge.launches = 0
