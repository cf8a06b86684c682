"""K7: the position-weighted uint32 hash of the per-broker aggregates.

Replaces cruise_control_tpu/analyzer/optimizer.py _state_fingerprint
(:1199): the goal machine's StackMetrics.state_fp, evaluated at every goal
pause or exit. The CUDA kernel is csrc/state_fingerprint.cu;
`state_fingerprint_plain` is the PyTorch version, in int64 arithmetic masked
to 32 bits (uint32 wraparound).
"""

from __future__ import annotations

import ctypes

import torch

from cruise_control_torch.kernels import build

_MASK = 0xFFFFFFFF
#: (array, salt) in the reference's order
_SALTS = ("broker_load", 0x9E3779B9), ("leader_nw_in", 0x85EBCA6B), \
    ("leader_count", 0xC2B2AE35), ("replica_count", 0x27D4EB2F)


#: per device: the kernel's u32 scratch (its ticket, 0 between launches, and
#: one partial sum a block) and its address
_SCRATCH = {}
_ARGTYPES = (build.PTR,) * 6 + (build.INT, build.PTR)
_F32, _I32 = torch.float32, torch.int32


def _mix(x: torch.Tensor, salt: int, start: int = 0) -> torch.Tensor:
    """i64[]: sum of bits(x_i) * (((i + 1) * 2654435761 + salt) | 1) mod 2^32,
    i counted from `start` (the flat position of x's first element)."""
    bits = x.contiguous().view(torch.int32).reshape(-1).to(torch.int64) & _MASK
    i = torch.arange(start + 1, start + bits.shape[0] + 1, dtype=torch.int64, device=x.device)
    w = ((i * 2654435761 + salt) & _MASK) | 1
    # bits * w mod 2^32 without overflowing int64: split bits into 16-bit halves
    prod = ((bits & 0xFFFF) * w + ((((bits >> 16) * w) & 0xFFFF) << 16)) & _MASK
    return torch.sum(prod) & _MASK


def state_fingerprint_plain(agg) -> torch.Tensor:
    """i64[]: the fingerprint of `agg` (an Aggregates), in [0, 2^32)."""
    fp = sum(_mix(getattr(agg, name), salt) for name, salt in _SALTS)
    return fp & _MASK


def _refuse(agg):
    """Raise the first reason the kernel does not take these aggregates."""
    dev = agg.broker_load.device
    b = agg.broker_load.shape[0]
    for name, dtype, shape in (("broker_load", torch.float32, (b, 4)),
                               ("leader_nw_in", torch.float32, (b,)),
                               ("leader_count", torch.int32, (b,)),
                               ("replica_count", torch.int32, (b,))):
        t = getattr(agg, name)
        build.require(t, dtype, len(shape), name, dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"state_fingerprint: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    raise ValueError("state_fingerprint: the aggregates disagree")


def scratch_words(lib) -> int:
    """The u32 words of the scratch that kernel library `lib` needs."""
    lib.state_fingerprint_scratch_words.restype = ctypes.c_longlong
    return int(lib.state_fingerprint_scratch_words())


def _scratch(idx: int) -> int:
    """The address of device `idx`'s scratch (allocated at its first call)."""
    ws = _SCRATCH.get(idx)
    if ws is None:
        t = torch.zeros(scratch_words(build.load("state_fingerprint")), dtype=torch.int32,
                        device=torch.device("cuda", idx))
        ws = _SCRATCH[idx] = (t, t.data_ptr())
    return ws[1]


def state_fingerprint(agg) -> torch.Tensor:
    """`state_fingerprint_plain` for CPU aggregates, the CUDA kernel for CUDA
    ones: an i64[] on the aggregates' device, a fresh tensor each call. The
    kernel takes any B and views that are not 16-byte aligned."""
    load, lnw, lc, rc = agg.broker_load, agg.leader_nw_in, agg.leader_count, agg.replica_count
    if load.device.type == "cpu":
        return state_fingerprint_plain(agg)
    idx = load.get_device()
    b = load.shape[0]
    if not (idx >= 0 and load.dtype is _F32 and lnw.dtype is _F32 and lc.dtype is _I32
            and rc.dtype is _I32 and load.shape == (b, 4) and lnw.shape == (b,)
            and lc.shape == (b,) and rc.shape == (b,) and lnw.get_device() == idx
            and lc.get_device() == idx and rc.get_device() == idx and load.is_contiguous()
            and lnw.is_contiguous() and lc.is_contiguous() and rc.is_contiguous()):
        _refuse(agg)
    out = load.new_empty((), dtype=torch.int64)
    code = build.entry("state_fingerprint", _ARGTYPES)(
        load.data_ptr(), lnw.data_ptr(), lc.data_ptr(), rc.data_ptr(), out.data_ptr(),
        _scratch(idx), b, build.raw_stream(idx))
    if code:
        build.check(build.load("state_fingerprint"), code, "state_fingerprint")
    state_fingerprint.launches += 1
    return out


state_fingerprint.launches = 0
