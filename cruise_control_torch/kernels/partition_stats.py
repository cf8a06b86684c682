"""K13: a shard's exact coverage counts on the partition-axis mesh.

Replaces the per-shard body of cruise_control_tpu/parallel/spmd.py
make_partition_stats (:218-227): the count of movable partitions, the count
of populated assignment slots (`assignment >= 0`) and the row count, as
int32. parallel/spmd.py sums them over the shards. The CUDA kernel is
csrc/partition_stats.cu (one launch over a grid sized to the card: 16-byte
vector loads of the flags and the slots at any alignment, block counts
written to the scratch, the last block adds them and writes the totals);
`partition_stats_plain` is the PyTorch version, an integer `torch.sum` of
the same counts.
"""

from __future__ import annotations

import ctypes

import torch

from cruise_control_torch.kernels import build

#: per device: the kernel's scratch (two counts a block and a ticket, 0
#: between launches), its address and the most blocks a launch takes there
#: (the card's SM count times the blocks an SM holds), read once
_SCRATCH = {}
_ARGTYPES = (build.PTR,) * 4 + (build.INT,) * 3 + (build.PTR,)


def partition_stats_plain(movable: torch.Tensor, assignment: torch.Tensor) -> torch.Tensor:
    """i32[3]: (movable rows, slots with assignment >= 0, rows)."""
    n = assignment.shape[0]
    return torch.stack([torch.sum(movable), torch.sum(assignment >= 0),
                        torch.tensor(n, device=assignment.device)]).to(torch.int32)


def _scratch(idx: int):
    """(scratch, its address, the grid's most blocks) of device `idx`."""
    ws = _SCRATCH.get(idx)
    if ws is None:
        lib = build.load("partition_stats")
        for fn in (lib.partition_stats_grid, lib.partition_stats_scratch_words):
            fn.argtypes, fn.restype = [ctypes.c_longlong], ctypes.c_longlong
        with torch.cuda.device(idx):
            grid = lib.partition_stats_grid(idx)
        if grid < 1:
            raise RuntimeError(f"partition_stats: cuda:{idx} reports no SM count or occupancy")
        # cclint: disable=cuda-host-sync -- a ctypes call's host integer (the kernel library's scratch size), no tensor
        t = torch.zeros(int(lib.partition_stats_scratch_words(grid)), dtype=torch.int32,
                        device=torch.device("cuda", idx))
        ws = _SCRATCH[idx] = (t, t.data_ptr(), grid)
    return ws


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
    _, scratch, grid = _scratch(dev.index)
    code = build.entry("partition_stats", _ARGTYPES)(
        movable.data_ptr(), assignment.data_ptr(), out.data_ptr(), scratch, n,
        assignment.shape[1], grid, build.raw_stream(dev.index))
    if code:
        build.check(build.load("partition_stats"), code, "partition_stats")
    partition_stats.launches += 1
    return out


partition_stats.launches = 0
