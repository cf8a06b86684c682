"""The model and analyzer API of the port against the JAX package's, on the
CPU: the flat model's eight helpers (`replication_factor`, the new and dead
broker masks, the leader and follower contributions, `host_loads`,
`host_capacity`, `utilization_matrix`) against `jax.jit` of the JAX
functions, exactly, floats included; `BalancingAction`; `gather_actions`
with indices in range and past either end (JAX clamps, torch would raise);
and export parity: every public name that an `__init__.py` of the JAX
package exports is importable from the port's counterpart.

The models: `unbalanced()`, a small `random_cluster`, one with dead and new
brokers, one with several brokers a host (some hosts empty, the host ids
shuffled), and one with many empty slots (partitions cut to RF 1 or 2, and
padded rows with no replica at all). Inputs are made with numpy from a seed
and handed to both packages.
"""

import ast
import dataclasses
import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import actions as jact
from cruise_control_tpu.models import flat_model as jfm
from cruise_control_tpu.models import generators as jgen
from cruise_control_torch.analyzer import actions as tact
from cruise_control_torch.common.resources import Resource
from cruise_control_torch.models import flat_model as tfm

ROOT = pathlib.Path(__file__).resolve().parent.parent

SMALL = jgen.ClusterProperty(num_racks=4, num_brokers=12, num_topics=10,
                             mean_partitions_per_topic=6.0, replication_factor=3,
                             load_distribution="pareto", mean_utilization=0.5)


def _fields(model) -> dict:
    return {k: np.asarray(v) for k, v in model._asdict().items()}


def _several_a_host(f: dict, rng) -> dict:
    b = f["broker_host"].shape[0]
    f["broker_host"] = rng.permutation(np.repeat(np.arange(0, 2 * b, 3), 3)[:b]).astype(np.int32)
    return f


def _many_empty_slots(f: dict, rng) -> dict:
    a = f["assignment"].copy()
    rf = rng.integers(1, a.shape[1] + 1, a.shape[0])
    a[np.arange(a.shape[1])[None, :] >= rf[:, None]] = -1
    pad = np.full((9, a.shape[1]), -1, np.int32)
    f["assignment"] = np.concatenate([a, pad])
    f["part_load"] = np.concatenate([f["part_load"], np.zeros((9, f["part_load"].shape[1]),
                                                              np.float32)])
    f["topic_id"] = np.concatenate([f["topic_id"], np.zeros(9, np.int32)])
    return f


def _dead_and_new(f: dict, rng) -> dict:
    state = f["broker_state"].copy()
    state[rng.choice(state.shape[0], 3, replace=False)] = 1
    f["broker_state"] = state
    return f


def _random(seed: int, prop=SMALL) -> dict:
    return _fields(jgen.random_cluster(seed, prop))


#: each model's numpy fields, from a generator seeded by the model's index
MODELS = {
    "unbalanced": lambda rng: _fields(jgen.unbalanced()),
    "random": lambda rng: _random(3),
    "dead and new brokers": lambda rng: _dead_and_new(_random(5, dataclasses.replace(
        SMALL, num_dead_brokers=2, num_new_brokers=2)), rng),
    "several brokers a host": lambda rng: _several_a_host(_random(3), rng),
    "many empty slots": lambda rng: _many_empty_slots(_random(3), rng),
}


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    """(name, the JAX model, the port's model) on the same numpy fields."""
    f = MODELS[request.param](np.random.default_rng(list(MODELS).index(request.param)))
    return (request.param, jfm.FlatClusterModel(**{k: jnp.asarray(v) for k, v in f.items()}),
            tfm.from_numpy(f))


def _same(want, got: torch.Tensor, what=""):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, got.shape,
                                                                 want.shape)
    assert got.tobytes() == want.tobytes(), (what, want, got)


def _num_hosts(jm) -> tuple:
    """Host counts to sum into: exactly the ids, one more (an empty host),
    and one fewer (the last host's brokers dropped, as XLA's scatter drops
    them)."""
    h = int(np.asarray(jm.broker_host).max()) + 1
    return (h, h + 1, max(h - 1, 1))


def test_masks_and_replication_factor_equal_jax(pair):
    name, jm, tm = pair
    for fn in ("replication_factor", "new_broker_mask", "dead_broker_mask", "valid_slot_mask",
               "alive_broker_mask"):
        _same(jax.jit(getattr(jfm, fn))(jm), getattr(tfm, fn)(tm), fn)
    if name == "dead and new brokers":
        assert tfm.new_broker_mask(tm).any() and tfm.dead_broker_mask(tm).any()


def test_contributions_equal_jax(pair):
    _, jm, tm = pair
    for fn in ("leader_contribution", "follower_contribution"):
        _same(jax.jit(getattr(jfm, fn))(jm.part_load), getattr(tfm, fn)(tm.part_load))


def test_host_loads_and_capacity_equal_jax(pair):
    name, jm, tm = pair
    for h in _num_hosts(jm):
        for fn in ("host_loads", "host_capacity"):
            _same(jax.jit(getattr(jfm, fn), static_argnums=1)(jm, h), getattr(tfm, fn)(tm, h),
                  (fn, h))
    if name == "several brokers a host":
        assert int(torch.bincount(tm.broker_host).max()) == 3


def test_host_loads_cpu_column_is_k1s_host_cpu_load(pair):
    """The CPU column of `host_loads` is K1's `host_cpu_load` bit for bit:
    both add a host's brokers' CPU loads in broker order from +0.0."""
    _, jm, tm = pair
    k1_host_cpu = tfm.segment_sums(tm, tm.num_topics)[7]
    h = k1_host_cpu.shape[0]
    assert tfm.host_loads(tm, h)[:, Resource.CPU].numpy().tobytes() == \
        k1_host_cpu.numpy().tobytes()


def test_utilization_matrix_equal_jax(pair):
    _, jm, tm = pair
    want = jax.jit(jfm.utilization_matrix)(jm)
    got = tfm.utilization_matrix(tm)
    for row in range(7):
        _same(np.asarray(want)[row], got[row], row)
    _same(want, got)


def test_balancing_action_fields():
    """The fields, `action_type` and frozenness of the JAX class."""
    jf = [f.name for f in dataclasses.fields(jact.BalancingAction)]
    assert [f.name for f in dataclasses.fields(tact.BalancingAction)] == jf
    for kind in (tact.KIND_MOVE, tact.KIND_LEADERSHIP):
        args = (7, 1, 3, 9, kind)
        t, j = tact.BalancingAction(*args), jact.BalancingAction(*args)
        assert t.action_type == j.action_type
        assert dataclasses.astuple(t) == dataclasses.astuple(j)
        with pytest.raises(dataclasses.FrozenInstanceError):
            t.partition = 8
    assert tact.BalancingAction(0, 0, 1, 2, tact.KIND_MOVE).action_type == \
        "INTER_BROKER_REPLICA_MOVEMENT"
    assert tact.BalancingAction(0, 1, 1, 2, tact.KIND_LEADERSHIP).action_type == \
        "LEADERSHIP_MOVEMENT"


def _torch_batch(jb) -> tact.ActionBatch:
    return tact.ActionBatch(*(torch.from_numpy(np.array(x)) for x in jb))


@pytest.mark.parametrize("where", ["in range", "past the end", "before the start"])
def test_gather_actions_equal_jax(pair, where):
    """`gather_actions` on the [P, R-1] leadership grid and on a [P, R, K]
    move grid against JAX's, jitted, field for field."""
    _, jm, tm = pair
    p, r = jm.assignment.shape
    rng = np.random.default_rng(["in range", "past the end", "before the start"].index(where))
    cands = jnp.asarray(rng.choice(jm.num_brokers, min(4, jm.num_brokers), replace=False)
                        .astype(np.int32))
    grids = [(jact.make_move_batch(jm.part_load, jm.assignment, cands), (p, r, cands.shape[0]))]
    if r >= 2:
        grids.append((jact.make_leadership_batch(jm.part_load, jm.assignment), (p, r - 1)))
    for jb, shape in grids:
        n = 16
        if where == "in range":
            idx = [rng.integers(0, s, n) for s in shape]
        elif where == "past the end":
            idx = [rng.integers(s, s + 5, n) if a == 0 else rng.integers(0, s + 3, n)
                   for a, s in enumerate(shape)]
        else:
            idx = [rng.integers(-2 * s - 3, 0, n) for s in shape]
        idx = [i.astype(np.int32) for i in idx]
        want = jax.jit(jact.gather_actions)(jb, *(jnp.asarray(i) for i in idx))
        got = tact.gather_actions(_torch_batch(jb), *(torch.from_numpy(i) for i in idx))
        for fname, w, g in zip(tact.ActionBatch._fields, want, got):
            _same(w, g, (fname, shape))


def _jax_exports(path: pathlib.Path) -> list:
    """The public names a JAX package `__init__.py` binds: its imports (but
    `__future__` and `typing`), definitions and assignments."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.module not in ("__future__", "typing"):
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
    return sorted({n for n in names if not n.startswith("_")})


JAX_INITS = sorted(p.relative_to(ROOT / "cruise_control_tpu").parent.as_posix()
                   for p in (ROOT / "cruise_control_tpu").rglob("__init__.py"))


@pytest.mark.parametrize("package", JAX_INITS)
def test_exports_match_jax(package):
    """Every public name of the JAX package's `__init__.py` imports from the
    port's counterpart."""
    rel = "" if package == "." else "." + package.replace("/", ".")
    names = _jax_exports(ROOT / "cruise_control_tpu" / package / "__init__.py")
    port = importlib.import_module("cruise_control_torch" + rel)
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, f"cruise_control_torch{rel} lacks {missing}"


def test_chip_smoke_model_api_recipe_equal_jax():
    """chip_smoke's phase 25 recipe (`model_api_outputs`: the eight helpers,
    the host sums also three brokers a host, gather_actions on the
    leadership grid with picks past either end) on a small model: the port's
    outputs hash as the JAX package's do (scripts/model_api_references.py's
    jitted API), as phase 25 holds them at full size."""
    import importlib.util
    import sys

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    spec = importlib.util.spec_from_file_location(
        "model_api_references", ROOT / "scripts" / "model_api_references.py")
    refs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(refs)
    f = _fields(jgen.random_cluster(9, dataclasses.replace(SMALL, num_dead_brokers=1)))
    g = dict(f, broker_host=np.arange(f["broker_host"].shape[0], dtype=np.int32) //
             chip_smoke.MODEL_API_HOST_GROUP)
    jm, jg = (jfm.FlatClusterModel(**{k: jnp.asarray(v) for k, v in x.items()}) for x in (f, g))
    want = chip_smoke.outputs_sha256(chip_smoke.model_api_outputs(refs.jax_api(), jm, jg),
                                     np.asarray)
    got = chip_smoke.outputs_sha256(
        chip_smoke.model_api_outputs(chip_smoke.port_model_api(), tfm.from_numpy(f),
                                     tfm.from_numpy(g)), lambda x: x.numpy())
    assert set(got) == set(chip_smoke.JAX_CPU_MODEL_API)
    assert got == want
