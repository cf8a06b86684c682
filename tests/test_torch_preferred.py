"""The preferred-leader election (goals/preferred.py elect_preferred_leaders,
K11's plain version on the CPU) against the jitted JAX function: on a
seeded 70-broker cluster with demoted and dead leaders, on hand-made rows
(a leader on a demoted broker, on a dead one, a partition with no eligible
replica, -1 slots, an eligible leader), and on random rows with -1 slots
and random masks. Outputs are compared exactly, and the input is left as
it was.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import context as jctx
from cruise_control_tpu.analyzer.goals.preferred import elect_preferred_leaders as jelect
from cruise_control_tpu.config.balancing import BalancingConstraint as JConstraint
from cruise_control_tpu.models import generators as jgen
from cruise_control_tpu.models.flat_model import FlatClusterModel as JModel
from cruise_control_torch.analyzer import context as tctx
from cruise_control_torch.analyzer.goals import elect_preferred_leaders
from cruise_control_torch.config.balancing import BalancingConstraint as TConstraint
from cruise_control_torch.kernels.elect_preferred import elect_preferred, elect_preferred_plain
from cruise_control_torch.models.flat_model import from_numpy

_jit_elect = jax.jit(jelect)


def _statics(fields):
    jm, tm = JModel(**fields), from_numpy(fields)
    js = jctx.build_static_ctx(jm, JConstraint.default(), jctx.dims_of(jm))
    ts = tctx.build_static_ctx(tm, TConstraint.default(), tctx.dims_of(tm))
    return js, ts


def _both(fields, assignment):
    js, ts = _statics(fields)
    want = np.asarray(_jit_elect(js, jnp.asarray(assignment)))
    given = torch.from_numpy(assignment.copy())
    got = elect_preferred_leaders(ts, given)
    assert torch.equal(given, torch.from_numpy(assignment)), "the input changed"
    return want, got.numpy()


def _cluster(seed=3):
    prop = jgen.ClusterProperty(num_racks=7, num_brokers=70, num_topics=20,
                                mean_partitions_per_topic=10.0, replication_factor=3,
                                num_dead_brokers=4)
    f = {k: np.asarray(v).copy() for k, v in jgen.random_cluster(seed, prop)._asdict().items()}
    alive = np.nonzero(f["broker_state"] != 3)[0]
    f["broker_state"][np.random.default_rng(seed).choice(alive, 8, replace=False)] = 2
    return f


@pytest.mark.parametrize("seed", [3, 4])
def test_elect_preferred_leaders_equals_jax_on_a_cluster(seed):
    f = _cluster(seed)
    want, got = _both(f, f["assignment"])
    assert np.array_equal(want, got)
    ineligible = np.isin(f["assignment"][:, 0], np.nonzero(f["broker_state"] >= 2)[0])
    assert ineligible.any() and (got[:, 0] != f["assignment"][:, 0]).any()
    # every row keeps its replicas; only leaders on ineligible brokers moved
    assert all(sorted(x) == sorted(y) for x, y in zip(got, f["assignment"]))
    assert np.array_equal(got[~ineligible], f["assignment"][~ineligible])


def test_elect_preferred_leaders_equals_jax_on_hand_made_rows():
    f = _cluster()
    b = f["broker_state"].shape[0]
    demoted = int(np.nonzero(f["broker_state"] == 2)[0][0])
    dead = int(np.nonzero(f["broker_state"] == 3)[0][0])
    alive = np.nonzero(f["broker_state"] == 0)[0]
    ok1, ok2 = int(alive[0]), int(alive[1])
    rows = np.array([
        [demoted, ok1, ok2],   # demoted leader: slot 1 promoted
        [dead, -1, ok2],       # dead leader, an empty slot before the eligible one
        [demoted, dead, -1],   # no eligible replica: unchanged
        [-1, ok1, ok2],        # an empty leader slot: unchanged
        [ok1, demoted, dead],  # an eligible leader: unchanged
        [dead, demoted, ok1],  # the first eligible slot is the last
        [0, -1, -1],           # broker 0 with empty slots beside it
    ], dtype=np.int32)
    p = rows.shape[0]
    fields = dict(f, assignment=rows, part_load=f["part_load"][:p], topic_id=f["topic_id"][:p])
    want, got = _both(fields, rows)
    assert np.array_equal(want, got)
    assert got[0].tolist() == [ok1, demoted, ok2] and got[1].tolist() == [ok2, -1, dead]
    assert np.array_equal(got[2:5], rows[2:5]) and got[5].tolist() == [ok1, demoted, dead]
    assert b == 70


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_elect_preferred_plain_equals_jax_on_random_rows(seed):
    """K11's plain version on random rows, -1 slots anywhere, and random
    demoted / dead masks (padded brokers neither alive nor dead)."""
    rng = np.random.default_rng(seed)
    p, r, b = 500, 4, 40
    a = rng.integers(0, b, (p, r)).astype(np.int32)
    a[rng.random((p, r)) < 0.2] = -1
    demoted, dead = rng.random(b) < 0.3, rng.random(b) < 0.2
    fields = dict(assignment=a, part_load=np.ones((p, 8), np.float32),
                  topic_id=np.zeros(p, np.int32), broker_capacity=np.ones((b, 4), np.float32),
                  broker_rack=np.zeros(b, np.int32), broker_host=np.arange(b, dtype=np.int32),
                  broker_state=np.where(dead, 3, np.where(demoted, 2, 0)).astype(np.int32))
    js, _ = _statics(fields)
    want = np.asarray(_jit_elect(js, jnp.asarray(a)))
    got = elect_preferred_plain(torch.from_numpy(a), torch.from_numpy(demoted & ~dead),
                                torch.from_numpy(dead))
    assert np.array_equal(want, got.numpy())
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(elect_preferred(torch.from_numpy(a), torch.from_numpy(demoted & ~dead),
                                       torch.from_numpy(dead)), got)
    assert (want != a).any()
