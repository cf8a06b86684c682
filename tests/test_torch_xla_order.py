"""`window_sum.xla_order_sum`, the PyTorch form of XLA:CPU's summation order
that the plain versions of window_sum and K8 use, against the numpy spec
`window_sum.xla_sum`: bit-equal at every length that
tests/test_torch_window_order.py holds to jitted `jnp.sum`, over a vector
and over the first axis of an [n, 4] matrix with a column of -0.0 and
columns with infinities and a NaN."""

import numpy as np
import pytest
import torch
from test_torch_window_order import BOUNDARIES, LENGTHS

from cruise_control_torch.kernels.window_sum import (
    EXCESS_COST,
    UTILIZATION_COST,
    xla_order_sum,
    xla_sum,
)


@pytest.mark.parametrize("cols", (None, 4), ids=["vector", "n-by-4"])
@pytest.mark.parametrize("n", sorted(set(LENGTHS + BOUNDARIES)))
def test_xla_order_sum_equals_the_numpy_spec(n, cols):
    rng = np.random.default_rng(n)
    shape = n if cols is None else (n, cols)
    x = (rng.pareto(1.5, shape) * rng.choice([-1.0, 1.0], shape)).astype(np.float32)
    if cols is not None:
        x[:, 0] = -0.0
        x[n // 2, 1], x[n - 1, 1] = np.inf, -np.inf
        x[0, 2] = np.inf
        x[n // 3, 3] = np.nan
    want = np.asarray(xla_sum(x), dtype=np.float32)
    got = xla_order_sum(torch.from_numpy(x)).numpy()
    assert want.shape == got.shape
    assert np.array_equal(np.isnan(want), np.isnan(got))
    ok = ~np.isnan(want)
    assert np.array_equal(want[ok].view(np.int32), got[ok].view(np.int32))


@pytest.mark.parametrize("cols", (None, 4), ids=["vector", "n-by-4"])
@pytest.mark.parametrize("order", (UTILIZATION_COST, EXCESS_COST), ids=["utilization", "excess"])
def test_fused_orders_equal_the_numpy_spec(order, cols):
    """A fused cost's vectorized order (fault F4), PyTorch against numpy, at
    every length up to 40: the lanes from `order.min_terms` to 32 terms."""
    for n in range(1, 41):
        rng = np.random.default_rng(n)
        x = rng.uniform(0, 10, n if cols is None else (n, cols)).astype(np.float32)
        want = np.asarray(xla_sum(x, order), dtype=np.float32)
        got = xla_order_sum(torch.from_numpy(x), order).numpy()
        assert np.array_equal(want.view(np.int32), got.view(np.int32)), n
