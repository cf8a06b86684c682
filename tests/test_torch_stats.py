"""The cluster statistics and the state fingerprint against the JAX package
(CPU): the segment helpers (models/flat_model.py :96-246) exactly, K8's plain
version through `compute_stats` bit-equal to the jitted `compute_stats`, and
K7's plain version equal to the jitted `_state_fingerprint`, on fixture C
(32 brokers, 80 topics) and on a 100-broker cluster (BASELINE config 2 with
pareto load and 2 dead brokers, 500 topics), where every float sum runs past
XLA's 32-term window.
"""

import collections
import dataclasses

import jax
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer.optimizer import _state_fingerprint
from cruise_control_tpu.analyzer.stats import compute_stats as jstats
from cruise_control_tpu.analyzer.stats import stats_to_dict as jstats_to_dict
from cruise_control_tpu.models import flat_model as jfm
from cruise_control_tpu.models import generators as jgen
from cruise_control_torch.analyzer.stats import compute_stats, stats_to_dict, stats_to_host
from cruise_control_torch.kernels.cluster_stats import cluster_stats_plain
from cruise_control_torch.kernels.state_fingerprint import state_fingerprint
from cruise_control_torch.models import flat_model as tfm

FIXTURE_C = jgen.ClusterProperty(num_racks=4, num_brokers=32, num_topics=80,
                                 mean_partitions_per_topic=10, replication_factor=3,
                                 num_dead_brokers=2, load_distribution="pareto",
                                 mean_utilization=0.5)
MODEL_100 = dataclasses.replace(jgen.BASELINE_CONFIGS[2], num_dead_brokers=2,
                                load_distribution="pareto", mean_utilization=0.5)
MODELS = {"fixture_c": FIXTURE_C, "brokers_100": MODEL_100}
HELPERS = ("valid_slot_mask", "alive_broker_mask", "_segment_ids", "broker_loads",
           "replica_counts", "leader_counts", "potential_nw_out", "topic_replica_counts")

_jit_stats = jax.jit(jstats, static_argnums=1)
_jit_fp = jax.jit(_state_fingerprint)
_FpAgg = collections.namedtuple("_FpAgg", "broker_load leader_nw_in leader_count replica_count")


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32 and b.dtype == np.float32:
        return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))
    return a.shape == b.shape and np.array_equal(a, b)


@pytest.fixture(scope="module", params=list(MODELS))
def models(request):
    m = jgen.random_cluster(42, MODELS[request.param])
    tm = tfm.from_numpy({k: np.asarray(v) for k, v in m._asdict().items()})
    return m, tm, int(np.asarray(m.topic_id).max()) + 1


@pytest.mark.parametrize("helper", HELPERS)
def test_segment_helpers_equal_jax(models, helper):
    m, tm, t = models
    args = (t,) if helper == "topic_replica_counts" else ()
    j = jax.jit(getattr(jfm, helper), static_argnums=(1,) if args else ())(m, *args)
    assert _same(j, getattr(tfm, helper)(tm, *args).numpy())


def test_compute_stats_equals_jitted_jax(models):
    m, tm, t = models
    j = jax.device_get(_jit_stats(m, t))
    p = stats_to_host(compute_stats(tm, t))
    for field in j._fields:
        assert _same(getattr(j, field), getattr(p, field)), field
    assert stats_to_dict(p) == jstats_to_dict(j)


def test_compute_stats_of_a_moved_assignment(models):
    # stats_after's input: the same model with leaders swapped and followers
    # moved to random brokers
    m, tm, t = models
    rng = np.random.default_rng(3)
    a = np.asarray(m.assignment).copy()
    rows = rng.choice(a.shape[0], a.shape[0] // 2, replace=False)
    a[rows[::2]] = a[rows[::2]][:, ::-1]
    a[rows[1::2], 1] = rng.integers(0, m.num_brokers, rows[1::2].shape[0])
    m2 = m._replace(assignment=a)
    j = jax.device_get(_jit_stats(m2, t))
    p = stats_to_host(compute_stats(tm._replace(assignment=torch.from_numpy(a)), t))
    for field in j._fields:
        assert _same(getattr(j, field), getattr(p, field)), field


def test_cluster_stats_with_every_broker_dead_and_an_empty_topic():
    rng = np.random.default_rng(5)
    b, t = 40, 6
    load = rng.pareto(1.5, (b, 4)).astype(np.float32)
    cap = np.full((b, 4), 100.0, dtype=np.float32)
    counts = rng.integers(0, 4, (t, b)).astype(np.int32)
    counts[2] = 0
    reps = counts.sum(0).astype(np.int32)
    out, out_i = cluster_stats_plain(*(torch.from_numpy(x) for x in (
        load, cap, np.zeros(b, bool), reps, reps // 2, load[:, 2].copy(), counts)))
    assert out_i.tolist() == [0, int(reps.sum()), int((reps // 2).sum())]
    # no alive broker: means 0 over max(0, 1), min +inf, max -inf
    assert out[0].item() == 0.0 and out[8].item() == np.inf and out[12].item() == -np.inf
    assert out[20].item() == 0.0  # topic spread: no alive broker, std 0


def _fp_inputs(rng, b):
    return dict(broker_load=(rng.pareto(1.5, (b, 4)) * rng.choice([-1, 1], (b, 4))).astype(np.float32),
                leader_nw_in=rng.pareto(1.5, b).astype(np.float32),
                leader_count=rng.integers(-5, 2 ** 31 - 1, b).astype(np.int32),
                replica_count=rng.integers(0, 300, b).astype(np.int32))


def _port_fp(a):
    return int(state_fingerprint(_FpAgg(**{k: torch.from_numpy(v) for k, v in a.items()})))


@pytest.mark.parametrize("b", (1, 32, 100, 2600))
def test_state_fingerprint_equals_jax(b):
    a = _fp_inputs(np.random.default_rng(b), b)
    a["broker_load"][0, 1] = -0.0
    assert _port_fp(a) == int(_jit_fp(_FpAgg(**a)))


def test_state_fingerprint_sees_a_sign_flip():
    a = _fp_inputs(np.random.default_rng(9), 100)
    a["broker_load"][3, 2] = 0.0
    b = {k: v.copy() for k, v in a.items()}
    b["broker_load"][3, 2] = -0.0
    fa, fb = _port_fp(a), _port_fp(b)
    assert fa != fb
    assert (fa, fb) == (int(_jit_fp(_FpAgg(**a))), int(_jit_fp(_FpAgg(**b))))
