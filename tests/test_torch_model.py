"""The port's model and generators against the JAX package's."""

import dataclasses

import numpy as np
import pytest
import torch

from cruise_control_tpu.models import generators as jgen
from cruise_control_torch.models import generators as tgen
from cruise_control_torch.models.flat_model import from_numpy, sanity_check, to_numpy

FIELDS = ("assignment", "part_load", "topic_id", "broker_capacity", "broker_rack",
          "broker_host", "broker_state")


def _assert_same(jax_model, torch_model):
    for f in FIELDS:
        a = np.asarray(getattr(jax_model, f))
        b = getattr(torch_model, f).numpy()
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b), f


@pytest.mark.parametrize("cfg", [1, 2, 3, 4, 5])
def test_random_cluster_equals_jax_generator(cfg):
    _assert_same(jgen.random_cluster(42, jgen.BASELINE_CONFIGS[cfg]),
                 tgen.random_cluster(42, tgen.BASELINE_CONFIGS[cfg]))


def test_smoke_model_recipe_equals_jax_generator():
    """The smoke model's recipe (config 5's cluster, pareto load, dead brokers)
    at a reduced size: the dead-broker draw and the pareto path agree."""
    def prop(mod):
        return dataclasses.replace(mod.BASELINE_CONFIGS[5], num_brokers=260, num_racks=26,
                                   num_topics=200, num_dead_brokers=26,
                                   load_distribution="pareto", mean_utilization=0.5)

    _assert_same(jgen.random_cluster(42, prop(jgen)), tgen.random_cluster(42, prop(tgen)))


@pytest.mark.parametrize("name", ["unbalanced", "rack_aware_violated", "capacity_violated",
                                  "dead_broker_model"])
def test_deterministic_fixtures_equal_jax(name):
    _assert_same(getattr(jgen, name)(), getattr(tgen, name)())


def test_from_numpy_round_trips():
    m = jgen.random_cluster(7, jgen.BASELINE_CONFIGS[1])
    arrays = {k: np.asarray(v) for k, v in m._asdict().items()}
    tm = from_numpy(arrays)
    back = to_numpy(tm)
    for f in FIELDS:
        assert back[f].dtype == arrays[f].dtype and np.array_equal(back[f], arrays[f]), f
    assert tm.num_partitions == m.num_partitions
    assert tm.num_brokers == m.num_brokers
    assert tm.num_topics == m.num_topics
    assert tm.max_replication_factor == m.max_replication_factor


def test_sanity_check_passes_and_catches_duplicates():
    tm = tgen.random_cluster(3, tgen.BASELINE_CONFIGS[2])
    sanity_check(tm)
    bad = tm.assignment.clone()
    bad[0, 1] = bad[0, 0]
    with pytest.raises(ValueError, match="same broker"):
        sanity_check(tm._replace(assignment=bad))
    holes = tm.assignment.clone()
    holes[1, 1] = -1
    with pytest.raises(ValueError, match="left-packed"):
        sanity_check(tm._replace(assignment=holes))


def test_model_to_moves_every_field():
    tm = tgen.unbalanced().to("cpu")
    assert all(t.device == torch.device("cpu") for t in tm)


# -- the single-action edits and the naming metadata (JAX flat_model.py :71,
# :271-312; generators.py :262) ------------------------------------------------

EDIT_CASES = {
    # tests/test_flat_model.py :80 and :95 on the 3-broker fixture, a
    # slot-0 move, a no-op leadership swap and a follower swap
    "unbalanced": {"relocate_replica": [(0, 1, 2), (3, 0, 1)],
                   "relocate_leadership": [(0, 1), (2, 0)],
                   "swap_replicas": [(0, 1, 2, 1)]},
    # :125's 8-broker cluster, and one partition's two slots swapped
    "random": {"relocate_replica": [(3, 0, 5), (7, 1, 0)],
               "relocate_leadership": [(5, 1), (9, 0)],
               "swap_replicas": [(0, 1, 6, 1), (4, 0, 4, 1)]},
}


@pytest.mark.parametrize("edit", list(EDIT_CASES["random"]))
@pytest.mark.parametrize("fixture", ["unbalanced", "random"])
def test_single_action_edits_equal_jitted_jax(edit, fixture):
    """Each edit, on the port's model and jitted on the JAX model, gives the
    same model and the same broker loads; the port's input is unchanged."""
    import jax

    from cruise_control_tpu.models import flat_model as jfm
    from cruise_control_torch.models import flat_model as tfm

    if fixture == "unbalanced":
        jm, tm = jgen.unbalanced(), tgen.unbalanced()
    else:
        def prop(mod):
            return mod.ClusterProperty(num_brokers=8, num_racks=4, num_topics=4,
                                       rack_aware_placement=False)

        jm, tm = jgen.random_cluster(3, prop(jgen)), tgen.random_cluster(3, prop(tgen))
    before = tm.assignment.clone()
    for args in EDIT_CASES[fixture][edit]:
        j = jax.jit(getattr(jfm, edit))(jm, *args)
        t = getattr(tfm, edit)(tm, *args)
        _assert_same(j, t)
        assert np.array_equal(np.asarray(jax.jit(jfm.broker_loads)(j)),
                              tfm.broker_loads(t).numpy()), args
        assert torch.equal(tm.assignment, before)


def test_metadata_for_equals_jax():
    """`metadata_for` names a generated model's topics, partitions and
    brokers as the JAX generator does; `topic_partition` renders alike."""
    from cruise_control_tpu.models.flat_model import ClusterMetadata as JMeta
    from cruise_control_torch.models.flat_model import ClusterMetadata as TMeta

    prop = dataclasses.replace(jgen.BASELINE_CONFIGS[1], num_dead_brokers=1)
    jmeta = jgen.metadata_for(jgen.random_cluster(5, prop))
    tmeta = tgen.metadata_for(tgen.random_cluster(5, dataclasses.replace(
        tgen.BASELINE_CONFIGS[1], num_dead_brokers=1)))
    assert [f.name for f in dataclasses.fields(JMeta)] == \
        [f.name for f in dataclasses.fields(TMeta)]
    for f in dataclasses.fields(JMeta):
        a, b = getattr(jmeta, f.name), getattr(tmeta, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    assert [jmeta.topic_partition(p) for p in range(0, 900, 37)] == \
        [tmeta.topic_partition(p) for p in range(0, 900, 37)]
