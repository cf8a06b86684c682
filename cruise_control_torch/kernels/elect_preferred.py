"""K11: preferred-leader election off demoted and dead brokers.

Replaces cruise_control_tpu/analyzer/goals/preferred.py
elect_preferred_leaders (:22): for each partition whose slot-0 broker is
demoted or dead, slot 0 is exchanged with the first slot on an alive,
non-demoted broker; partitions with no such replica keep their row. The
CUDA kernel is csrc/elect_preferred.cu; `elect_preferred_plain` is the
PyTorch version. Both write a fresh [P, R] output.
"""

from __future__ import annotations

import ctypes

import torch

from cruise_control_torch.kernels import build

#: the C entry's `flags` codes (csrc/elect_preferred.cu FlagMode): 0 chooses
#: the layout by the broker count, the others force one
FLAGS = {"auto": 0, "bytes": 1, "global": 2}
#: past this many brokers (EP_BYTE_FLAGS) or slots a row (EP_TILE_WORDS / 4)
#: the kernel reads its flags from the bits workspace
BYTE_FLAGS, TILE_SLOTS = 49_152, 3_072


def elect_preferred_plain(assignment: torch.Tensor, demoted: torch.Tensor,
                          dead: torch.Tensor) -> torch.Tensor:
    """i32[P, R]: the assignment with leadership moved off demoted and dead
    brokers. Empty (-1) slots read broker 0's flags, masked by validity."""
    p, _ = assignment.shape
    valid = assignment >= 0
    holder = torch.where(valid, assignment, 0).long()
    ineligible = demoted | dead
    slot_ok = valid & ~ineligible[holder]
    leader_bad = ineligible[holder[:, 0]] & valid[:, 0]
    # the first eligible slot (argmax over bool: the lowest index of a max)
    best = torch.argmax(slot_ok.to(torch.int8), dim=1)
    swap = leader_bad & torch.any(slot_ok, dim=1) & (best != 0)
    rows = torch.arange(p, device=assignment.device)
    old_leader = assignment[:, 0]
    new_leader = assignment[rows, best]
    out = assignment.clone()
    out[:, 0] = torch.where(swap, new_leader, old_leader)
    out[rows, best] = torch.where(swap, old_leader, new_leader)
    return out


def _refuse(assignment, demoted, dead):
    """Raise the first reason the kernel does not take these inputs."""
    dev = assignment.device
    build.require(assignment, torch.int32, 2, "assignment", dev)
    b = demoted.shape[0] if demoted.dim() else 0
    for name, t in (("demoted", demoted), ("dead", dead)):
        build.require(t, torch.bool, 1, name, dev)
        if t.shape[0] != b:
            raise ValueError(f"elect_preferred: {name} has {t.shape[0]} brokers, expected {b}")
    raise ValueError("elect_preferred: the inputs disagree")


_ARGTYPES = (build.PTR,) * 5 + (build.INT,) * 4 + (build.PTR,)
#: per device: the kernel's bits workspace (a bit a broker, grown as needed),
#: made on the first call that needs it, and its address
_WORKSPACE = {}


def workspace_words(b: int) -> int:
    """The u32 words of the bits workspace for `b` brokers."""
    fn = build.load("elect_preferred").elect_preferred_workspace_words
    fn.restype, fn.argtypes = ctypes.c_longlong, [ctypes.c_longlong]
    # cclint: disable=cuda-host-sync -- a ctypes call's host integer (the kernel library's scratch size), no tensor
    return int(fn(b))


def _workspace(idx: int, b: int) -> int:
    """The address of device `idx`'s bits workspace, at least `b` brokers'."""
    ws = _WORKSPACE.get(idx)
    if ws is None or ws[0] < b:
        t = torch.empty(workspace_words(b), dtype=torch.int32, device=torch.device("cuda", idx))
        ws = _WORKSPACE[idx] = (b, t, t.data_ptr())
    return ws[2]


def elect_preferred(assignment: torch.Tensor, demoted: torch.Tensor,
                    dead: torch.Tensor) -> torch.Tensor:
    """`elect_preferred_plain` for CPU tensors, the CUDA kernel for CUDA
    ones."""
    if assignment.device.type == "cpu":
        return elect_preferred_plain(assignment, demoted, dead)
    idx = assignment.get_device()
    # cclint: disable=cuda-shape-branch -- a guard that refuses what the kernel does not take; it picks no launch sequence
    if not (idx >= 0 and assignment.dtype is torch.int32 and assignment.dim() == 2
            and demoted.dtype is torch.bool and dead.dtype is torch.bool and demoted.dim() == 1
            and demoted.shape == dead.shape and demoted.get_device() == idx
            and dead.get_device() == idx and assignment.is_contiguous()
            and demoted.is_contiguous() and dead.is_contiguous()):
        _refuse(assignment, demoted, dead)
    p, r = assignment.shape
    b = demoted.shape[0]
    out = assignment.new_empty((p, r))
    bits = _workspace(idx, b) if b > BYTE_FLAGS or r > TILE_SLOTS else None
    code = build.entry("elect_preferred", _ARGTYPES)(
        assignment.data_ptr(), demoted.data_ptr(), dead.data_ptr(), out.data_ptr(), bits, p, r,
        b, 0, build.raw_stream(idx))
    if code:
        build.check(build.load("elect_preferred"), code, "elect_preferred")
    elect_preferred.launches += 1
    return out


elect_preferred.launches = 0
