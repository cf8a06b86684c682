"""Float32 arithmetic as XLA:CPU does it, for the plain versions.

The JAX package's scores are computed by XLA on the CPU, which rounds in two
places differently from a chain of separate PyTorch ops:

- it fuses `a * b + c` into one fused multiply-add, rounded once. `fma`
  reproduces that: the float32 product is exact in float64, so the sum is
  taken there and rounded once to float32. The CUDA kernels call `fmaf`.
- its float32 `tanh` is a rational approximation (XLA's elemental emitter:
  a clamp, then two polynomials in x² by Horner's rule with a fused
  multiply-add at each step, then one divide). `xla_tanh` computes the same;
  `torch.tanh` and CUDA's `tanhf` differ from it by a few ulp. The CUDA
  kernels call `xla_tanhf` (csrc/common.cuh), the same steps in `fmaf`.

Use `fma` exactly where the JAX expression is a multiply feeding an add,
and `xla_tanh` for every `tanh`; nowhere else.
"""

from __future__ import annotations

import torch

#: |x| above this clamps; tanh is then +-1 to float32 precision
TANH_CLAMP = 7.90531110763549805
#: below this |x|, tanh(x) is taken as x
TANH_LINEAR = 0.0004
TANH_NUMERATOR = (
    -2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
    5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
    4.89352455891786e-03,
)
TANH_DENOMINATOR = (
    1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
    4.89352518554385e-03,
)


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def fma(a, b, c) -> torch.Tensor:
    """f32: a * b + c rounded once (each operand a float32 tensor or a Python
    number, taken as its float32 value)."""
    like = next(t for t in (a, b, c) if isinstance(t, torch.Tensor))
    a, b, c = (_f32(x, like).double() for x in (a, b, c))
    return (a * b + c).to(torch.float32)


def xla_tanh(x: torch.Tensor) -> torch.Tensor:
    """f32 tanh, bit-equal to XLA:CPU's for |x| below the clamp."""
    c = _f32(TANH_CLAMP, x)
    xc = torch.minimum(torch.maximum(x, -c), c)
    x2 = xc * xc
    num = torch.full_like(x2, TANH_NUMERATOR[0])
    for coef in TANH_NUMERATOR[1:]:
        num = fma(x2, num, coef)
    num = xc * num
    den = torch.full_like(x2, TANH_DENOMINATOR[0])
    for coef in TANH_DENOMINATOR[1:]:
        den = fma(x2, den, coef)
    return torch.where(torch.abs(x) < _f32(TANH_LINEAR, x), x, num / den)
