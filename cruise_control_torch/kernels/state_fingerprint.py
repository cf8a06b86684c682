"""K7: the position-weighted uint32 hash of the per-broker aggregates.

Replaces cruise_control_tpu/analyzer/optimizer.py _state_fingerprint
(:1199): the goal machine's StackMetrics.state_fp, evaluated at every goal
pause or exit. The CUDA kernel is csrc/state_fingerprint.cu;
`state_fingerprint_plain` is the PyTorch version, in int64 arithmetic masked
to 32 bits (uint32 wraparound).
"""

from __future__ import annotations

import torch

from cruise_control_torch.kernels import build

_MASK = 0xFFFFFFFF
#: (array, salt) in the reference's order
_SALTS = ("broker_load", 0x9E3779B9), ("leader_nw_in", 0x85EBCA6B), \
    ("leader_count", 0xC2B2AE35), ("replica_count", 0x27D4EB2F)


def _mix(x: torch.Tensor, salt: int) -> torch.Tensor:
    """i64[]: sum of bits(x_i) * (((i + 1) * 2654435761 + salt) | 1) mod 2^32."""
    bits = x.contiguous().view(torch.int32).reshape(-1).to(torch.int64) & _MASK
    i = torch.arange(1, bits.shape[0] + 1, dtype=torch.int64, device=x.device)
    w = ((i * 2654435761 + salt) & _MASK) | 1
    # bits * w mod 2^32 without overflowing int64: split bits into 16-bit halves
    prod = ((bits & 0xFFFF) * w + ((((bits >> 16) * w) & 0xFFFF) << 16)) & _MASK
    return torch.sum(prod) & _MASK


def state_fingerprint_plain(agg) -> torch.Tensor:
    """i64[]: the fingerprint of `agg` (an Aggregates), in [0, 2^32)."""
    fp = sum(_mix(getattr(agg, name), salt) for name, salt in _SALTS)
    return fp & _MASK


def state_fingerprint(agg) -> torch.Tensor:
    """`state_fingerprint_plain` for CPU aggregates, the CUDA kernel for CUDA
    ones: an i64[] on the aggregates' device."""
    if agg.broker_load.device.type == "cpu":
        return state_fingerprint_plain(agg)
    dev = agg.broker_load.device
    b = agg.broker_load.shape[0]
    for name, dtype, shape in (("broker_load", torch.float32, (b, 4)),
                               ("leader_nw_in", torch.float32, (b,)),
                               ("leader_count", torch.int32, (b,)),
                               ("replica_count", torch.int32, (b,))):
        t = getattr(agg, name)
        build.require(t, dtype, len(shape), name, dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"state_fingerprint: {name} has shape {tuple(t.shape)}, expected {shape}")
    out = torch.empty(1, dtype=torch.int64, device=dev)
    lib = build.load("state_fingerprint")
    code = lib.state_fingerprint(
        build.ptrs(agg.broker_load, agg.leader_nw_in, agg.leader_count, agg.replica_count, out),
        build.ints(b), build.stream())
    build.check(lib, code, "state_fingerprint")
    state_fingerprint.launches += 1
    return out[0]


state_fingerprint.launches = 0
