"""The goals' costs whose sum XLA fuses with its producers (fault F4): the
port's `cost` against the jitted JAX goal's, bit for bit, on random loads
made from a seed with numpy. Up to 32 brokers XLA:CPU's loop vectorizer
takes some of these sums in 8 lanes (kernels/window_sum.py `FusedOrder`);
past 32 they are windowed. The four usage-distribution goals at every broker
count from 1 to 256 and at 2,600; the capacity goals and the potential
outbound goal (the other fused sites that differed) from 1 to 40 brokers and
at 100 and 2,600. The JAX goals read the same arrays through a namespace,
inside one jitted function a goal and a broker count."""

import types

import jax
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer.goals import hard as jhard
from cruise_control_tpu.analyzer.goals import soft as jsoft
from cruise_control_torch.analyzer.goals import hard as thard
from cruise_control_torch.analyzer.goals import soft as tsoft
from cruise_control_torch.common.resources import Resource

F = np.float32
USAGE_BROKERS = list(range(1, 257)) + [2600]
EXCESS_BROKERS = list(range(1, 41)) + [100, 2600]
SEEDS = 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors, several test processes: one intra-op thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arrays(b: int, seed: int) -> dict:
    """Loads, capacities and limits of b brokers (about a tenth dead, half
    as many hosts), and a window that leaves some brokers in and some out."""
    r = np.random.default_rng(seed)
    h = max(1, b // 2)
    return dict(
        alive=r.random(b) > 0.1,
        broker_capacity=r.uniform(50, 200, (b, 4)).astype(F),
        broker_load=r.uniform(0, 100, (b, 4)).astype(F),
        capacity_limit=r.uniform(20, 120, (b, 4)).astype(F),
        potential_nw_out=r.uniform(0, 150, b).astype(F),
        host_cpu_load=r.uniform(0, 150, h).astype(F),
        host_cpu_capacity_limit=r.uniform(20, 120, h).astype(F),
        limit=r.uniform(20, 120, b).astype(F),
        lower=F(r.uniform(0.2, 0.4)), upper=F(r.uniform(0.5, 0.7)), active=np.bool_(True),
    )


def _torch(arrays: dict) -> types.SimpleNamespace:
    return types.SimpleNamespace(**{k: torch.from_numpy(np.asarray(v))
                                    for k, v in arrays.items()})


def _check(jgoal, tgoal, b: int):
    """The jitted JAX cost and the port's, bit for bit, on SEEDS inputs."""
    jcost = jax.jit(lambda d: jgoal.cost(*(types.SimpleNamespace(**d),) * 3))
    for seed in range(SEEDS):
        arrays = _arrays(b, seed * 7919 + b)
        want = np.asarray(jcost(arrays), dtype=F)
        t = _torch(arrays)
        got = tgoal.cost(t, t, t).numpy().astype(F)
        assert want.view(np.int32) == got.view(np.int32), (tgoal.name, b, seed, want, got)


@pytest.mark.parametrize("b", USAGE_BROKERS)
def test_usage_distribution_costs_equal_jitted_jax(b):
    for res in Resource:
        _check(jsoft.ResourceDistributionGoal(res), tsoft.ResourceDistributionGoal(res), b)


@pytest.mark.parametrize("b", EXCESS_BROKERS)
def test_capacity_and_potential_outbound_costs_equal_jitted_jax(b):
    for res in Resource:
        _check(jhard.CapacityGoal(res), thard.CapacityGoal(res), b)
    _check(jsoft.PotentialNwOutGoal(), tsoft.PotentialNwOutGoal(), b)
