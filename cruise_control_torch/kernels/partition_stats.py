"""K13: a shard's exact coverage counts on the partition-axis mesh.

Replaces the per-shard body of cruise_control_tpu/parallel/spmd.py
make_partition_stats (:218-227): the count of movable partitions, the count
of populated assignment slots (`assignment >= 0`) and the row count, as
int32. parallel/spmd.py sums them over the shards. The CUDA kernel is
csrc/partition_stats.cu (one launch: block counts, one atomic a block and
count, the last block writes the totals); `partition_stats_plain` is the
PyTorch version, an integer `torch.sum` of the same counts.
"""

from __future__ import annotations

import ctypes

import torch

from cruise_control_torch.kernels import build

#: per device: the kernel's scratch (two accumulators and a ticket, 0
#: between launches) and its address
_SCRATCH = {}
_ARGTYPES = (build.PTR,) * 4 + (build.INT,) * 2 + (build.PTR,)


def partition_stats_plain(movable: torch.Tensor, assignment: torch.Tensor) -> torch.Tensor:
    """i32[3]: (movable rows, slots with assignment >= 0, rows)."""
    n = assignment.shape[0]
    return torch.stack([torch.sum(movable), torch.sum(assignment >= 0),
                        torch.tensor(n, device=assignment.device)]).to(torch.int32)


def _scratch(idx: int) -> int:
    ws = _SCRATCH.get(idx)
    if ws is None:
        lib = build.load("partition_stats")
        lib.partition_stats_scratch_words.restype = ctypes.c_longlong
        t = torch.zeros(int(lib.partition_stats_scratch_words()), dtype=torch.int32,
                        device=torch.device("cuda", idx))
        ws = _SCRATCH[idx] = (t, t.data_ptr())
    return ws[1]


def partition_stats(movable: torch.Tensor, assignment: torch.Tensor, out=None) -> torch.Tensor:
    """`partition_stats_plain` for CPU tensors, the CUDA kernel for CUDA
    tensors. `out`, an i32[3] on the same device, takes the counts in place
    of a fresh tensor (the mesh gathers the shards' counts so)."""
    if assignment.device.type == "cpu":
        counts = partition_stats_plain(movable, assignment)
        return counts if out is None else out.copy_(counts)
    dev = assignment.device
    build.require(assignment, torch.int32, 2, "assignment", dev)
    build.require(movable, torch.bool, 1, "movable", dev)
    n = assignment.shape[0]
    if movable.shape[0] != n:
        raise ValueError(f"partition_stats: {movable.shape[0]} movable flags for {n} rows")
    if out is None:
        out = torch.empty(3, dtype=torch.int32, device=dev)
    else:
        build.require(out, torch.int32, 1, "out", dev)
        if out.shape[0] != 3:
            raise ValueError(f"partition_stats: out has shape {tuple(out.shape)}, expected (3,)")
    code = build.entry("partition_stats", _ARGTYPES)(
        movable.data_ptr(), assignment.data_ptr(), out.data_ptr(), _scratch(dev.index), n,
        assignment.shape[1], build.raw_stream(dev.index))
    if code:
        build.check(build.load("partition_stats"), code, "partition_stats")
    partition_stats.launches += 1
    return out


partition_stats.launches = 0
