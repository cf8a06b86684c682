"""`window_sum` sums in XLA:CPU's order: bit-equal to jitted `jnp.sum` at
every length the port sums (one broker to the 199,518 partitions of the
smoke model), along both axes of a matrix, for -0.0 and for masked means;
every soft goal's window and cost equal the JAX package's, jitted, on a
100-broker cluster (BASELINE config 2 with pareto load and 2 dead brokers),
where the sums run past XLA's 32-term window; and the whole 15-goal stack
on that cluster equals the JAX fused run: final assignment, touch tags,
moves, per-goal rows and the decision digest.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import context as jctx
from cruise_control_tpu.analyzer.goals import goals_by_priority as jgoals
from cruise_control_tpu.config.balancing import BalancingConstraint as JConstraint
from cruise_control_tpu.models import generators as jgen
from cruise_control_torch.analyzer import context as tctx
from cruise_control_torch.analyzer.goals import SOFT_GOAL_NAMES
from cruise_control_torch.analyzer.goals import goals_by_priority as tgoals
from cruise_control_torch.config.balancing import BalancingConstraint as TConstraint
from cruise_control_torch.kernels.window_sum import window_sum, window_sum_plain, xla_sum
from cruise_control_torch.models.flat_model import from_numpy


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU path runs on small tensors, where torch's intra-op
    threads buy nothing, and the suite runs in several worker processes at
    once: threads that outnumber the cores wait on each other (six 8-thread
    processes on 8 cores ran a solve 30x slower than single-thread ones)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LENGTHS = (1, 31, 32, 33, 63, 65, 100, 766, 1025, 2600, 199518)
MODEL_100 = dataclasses.replace(jgen.BASELINE_CONFIGS[2], num_dead_brokers=2,
                                load_distribution="pareto", mean_utilization=0.5)

_jsum = jax.jit(jnp.sum)
_jsum0 = jax.jit(lambda v: jnp.sum(v, axis=0))
_jsum1 = jax.jit(lambda v: jnp.sum(v, axis=1))


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


def _pareto(rng, shape):
    """Heavy-tailed values of both signs: sums whose rounding depends on order."""
    return (rng.pareto(1.5, shape) * rng.choice([-1.0, 1.0], shape)).astype(np.float32)


@pytest.mark.parametrize("n", LENGTHS)
def test_window_sum_is_bit_equal_to_jitted_jnp_sum(n):
    rng = np.random.default_rng(n)
    for _ in range(3):
        x = _pareto(rng, n)
        assert _bits(window_sum(torch.from_numpy(x))) == _bits(_jsum(x))


@pytest.mark.parametrize("n", (33, 100, 2600))
def test_both_axes_of_a_matrix(n):
    rng = np.random.default_rng(7 + n)
    x = _pareto(rng, (n, 4))
    assert np.array_equal(_bits(window_sum_plain(torch.from_numpy(x))), _bits(_jsum0(x)))
    y = np.ascontiguousarray(x.T)
    assert np.array_equal(_bits(xla_sum(y.T)), _bits(_jsum1(y)))


#: the lengths where the tree gains a level or a window: the card tests
#: hold the kernel to the plain version at these too
BOUNDARIES = (1, 31, 32, 33, 1023, 1024, 1025, 32767, 32768, 32769)


@pytest.mark.parametrize("cols", (None, 4), ids=["vector", "n-by-4"])
@pytest.mark.parametrize("n", BOUNDARIES)
def test_level_boundaries_are_bit_equal_to_jitted_jnp_sum(n, cols):
    """At each boundary, over a column of -0.0 and over NaN and infinities
    (column 1: +inf and -inf, so NaN; column 2: +inf; column 3: a NaN)."""
    rng = np.random.default_rng(n)
    x = _pareto(rng, n if cols is None else (n, cols))
    want = _jsum(x) if cols is None else _jsum0(x)
    assert np.array_equal(_bits(window_sum_plain(torch.from_numpy(x))), _bits(want))
    if cols is None:
        return
    x[:, 0] = -0.0
    x[n // 2, 1], x[n - 1, 1] = np.inf, -np.inf
    x[0, 2] = np.inf
    x[n // 3, 3] = np.nan
    got = window_sum_plain(torch.from_numpy(x)).numpy()
    assert np.array_equal(_bits(got), _bits(_jsum0(x)))
    assert np.isposinf(got[2]) and np.isnan(got[3]) and (n == 1 or np.isnan(got[1]))


@pytest.mark.parametrize("n", (1, 2, 33, 100))
def test_negative_zeros(n):
    # the padding and the start value are +0.0: XLA's sum of -0.0s is +0.0,
    # except for a single term, which it returns as it is
    z = np.full(n, -0.0, dtype=np.float32)
    assert _bits(window_sum(torch.from_numpy(z))) == _bits(_jsum(z))


def test_the_padding_splits_low_half_first():
    # 33 terms pad to 64: 15 zeros in front, 16 behind. A huge term at index
    # 16 sits in the first window and absorbs the small terms before it; the
    # other split would put it in the second window.
    x = np.full(33, 1.0, dtype=np.float32)
    x[16] = 2.0 ** 25
    assert _bits(window_sum(torch.from_numpy(x))) == _bits(_jsum(x))


@pytest.mark.parametrize("n", (20, 100, 2600))
def test_masked_mean(n):
    rng = np.random.default_rng(11 + n)
    v = _pareto(rng, n)
    m = rng.random(n) < 0.9
    jmean = jax.jit(lambda v, m: jnp.sum(jnp.where(m, v, 0.0))
                    / jnp.maximum(jnp.sum(m.astype(jnp.float32)), 1.0))(v, m)
    tv = torch.from_numpy(v)
    tmean = window_sum(torch.where(torch.from_numpy(m), tv, torch.zeros(()))) / max(int(m.sum()), 1)
    assert _bits(tmean) == _bits(jmean)


@pytest.fixture(scope="module")
def ctx100():
    m = jgen.random_cluster(42, MODEL_100)
    jd = jctx.dims_of(m)
    js = jctx.build_static_ctx(m, JConstraint.default(), jd)
    ja = jax.jit(jctx.compute_aggregates, static_argnums=2)(js, m.assignment, jd)
    tm = from_numpy({k: np.asarray(v) for k, v in m._asdict().items()})
    td = tctx.dims_of(tm)
    ts = tctx.build_static_ctx(tm, TConstraint.default(), td)
    ta = tctx.compute_aggregates(ts, tm.assignment, td)
    assert td.num_brokers == 100
    return dict(jd=jd, js=js, ja=ja, td=td, ts=ts, ta=ta)


@pytest.mark.parametrize("name", SOFT_GOAL_NAMES)
def test_soft_goal_windows_and_costs_equal_jitted_jax_at_100_brokers(ctx100, name):
    jg = next(g for g in jgoals(None) if g.name == name)
    tg = next(g for g in tgoals(None) if g.name == name)
    jd = ctx100["jd"]

    @jax.jit
    def jax_side(js, ja):
        gs = jg.prepare(js, ja, jd)
        return gs, jg.cost(js, gs, ja)

    jgs, jcost = jax_side(ctx100["js"], ctx100["ja"])
    tgs = tg.prepare(ctx100["ts"], ctx100["ta"], ctx100["td"])
    for f in jgs._fields:
        assert np.array_equal(_bits(getattr(jgs, f)) if np.asarray(getattr(jgs, f)).dtype == np.float32
                              else np.asarray(getattr(jgs, f)),
                              _bits(getattr(tgs, f).numpy()) if getattr(tgs, f).dtype == torch.float32
                              else getattr(tgs, f).numpy()), f
    assert _bits(tg.cost(ctx100["ts"], tgs, ctx100["ta"])) == _bits(jcost)


#: the JAX side of STACK_SETTINGS with the ledger on
JAX_STACK = dict(batch_k=16, max_rounds_per_goal=64, drain_src=512, drain_per_broker=8,
                 drain_dst=64, apply_waves=8, bulk_waves=16, bulk_min_brokers=32,
                 num_swap_pairs=8, swap_candidates=8, swaps_per_broker=4, polish_rounds=0,
                 chunk_rounds=0, bucket_partitions=False, bucket_brokers=False, ledger=True,
                 num_dst_candidates=8)


@pytest.fixture(scope="module")
def stack100():
    """The 15-goal stack on the 100-broker cluster: (jax result, jax touch
    tags, port result). The JAX stack program compiles once."""
    from cruise_control_tpu.analyzer import optimizer as jopt
    from cruise_control_torch.analyzer import optimizer as topt

    model = jgen.random_cluster(42, MODEL_100)
    settings = jopt.OptimizerSettings(**JAX_STACK)
    jo = jopt.GoalOptimizer(settings=settings)
    jres = jo.optimizations(model, None, raise_on_hard_failure=False)
    goals, _, _, dims, static, agg, _ = jo._prepare(model, None, jopt.OptimizationOptions())
    step = jopt._stack_executable(tuple(g.name for g in goals), dims, settings, None, static, agg)
    jtouch = np.asarray(jax.device_get(step(static, agg)[0].touch_tag))
    tmodel = from_numpy({k: np.asarray(v) for k, v in model._asdict().items()})
    tres = topt.GoalOptimizer(settings=dataclasses.replace(topt.STACK_SETTINGS, ledger=True),
                              device="cpu").optimizations(tmodel, None, raise_on_hard_failure=False)
    return jres, jtouch, tres


def test_full_stack_at_100_brokers_equals_jax(stack100):
    jres, jtouch, tres = stack100
    assert np.array_equal(np.asarray(jres.final_assignment), tres.final_assignment)
    assert np.array_equal(jtouch, tres.touch_tag)
    assert (tres.num_replica_moves, tres.num_leadership_moves) == (
        jres.num_replica_moves, jres.num_leadership_moves)


def test_full_stack_at_100_brokers_goal_rows_equal_jax(stack100):
    jres, _, tres = stack100

    def rows(res):
        return [(g.name, g.violated_brokers_before, g.violated_brokers_after, g.rounds,
                 g.converged) for g in res.goal_results]

    assert rows(tres) == rows(jres)
    names = [g.name for g in tres.goal_results]
    assert tres.provenance.digest(goals=names) == jres.provenance.digest(goals=names)
