"""The port's float32 helpers against XLA:CPU (CPU): `xla_tanh` and `fma`
bit-equal to jitted `jnp.tanh` and `a * b + c`, and `window_sum` equal to
jitted `jnp.sum`, in index order up to 32 terms and in XLA:CPU's windows of
32 beyond."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_torch.common.xla_math import fma, xla_tanh
from cruise_control_torch.kernels.window_sum import window_sum, window_sum_plain


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


def test_xla_tanh_is_bit_equal_to_jnp_tanh():
    rng = np.random.default_rng(0)
    x = rng.uniform(-7.9, 7.9, 1_000_000).astype(np.float32)
    # the linear branch, its edge and both signs of zero
    x[:1000] = rng.uniform(-1e-3, 1e-3, 1000).astype(np.float32)
    x[1000:1004] = [0.0004, -0.0004, 0.0, -0.0]
    want = np.asarray(jax.jit(jnp.tanh)(x))
    got = xla_tanh(torch.from_numpy(x)).numpy()
    assert np.array_equal(_bits(want), _bits(got))
    # and it is not torch.tanh, which differs on most inputs
    assert not np.array_equal(_bits(want), _bits(torch.tanh(torch.from_numpy(x)).numpy()))


def test_fma_is_bit_equal_to_a_jitted_multiply_add():
    rng = np.random.default_rng(1)
    a, b, c = (rng.standard_normal(1_000_000).astype(np.float32) for _ in range(3))
    want = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    got = fma(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    assert np.array_equal(_bits(want), _bits(got))
    # Python constants enter as their float32 values, as in XLA
    want = np.asarray(jax.jit(lambda t, r: r + 1e-3 * t)(a, c))
    got = fma(1e-3, torch.from_numpy(a), torch.from_numpy(c)).numpy()
    assert np.array_equal(_bits(want), _bits(got))


@pytest.mark.parametrize("n", [1, 2, 7, 24, 31, 32])
def test_window_sum_equals_jnp_sum_up_to_32_terms(n):
    rng = np.random.default_rng(n)
    jsum = jax.jit(jnp.sum)
    for _ in range(40):
        x = (rng.standard_normal(n) * rng.choice([1e-3, 1.0, 1e4])).astype(np.float32)
        assert _bits(jsum(x)) == _bits(window_sum(torch.from_numpy(x)).numpy())


def test_window_sum_is_sequential_beyond_32_terms():
    # beyond 32 terms the order is XLA:CPU's: sequential within each window
    # of 32, then the window sums (tests/test_torch_window_order.py)
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2600, 4)) * 1e3).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v: jnp.sum(v, axis=0))(x))
    assert np.array_equal(_bits(ref), _bits(window_sum_plain(torch.from_numpy(x)).numpy()))
    assert np.array_equal(_bits(ref[0]), _bits(window_sum(torch.from_numpy(x[:, 0].copy()))))
