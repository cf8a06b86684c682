"""The port's configuration against the JAX package's: the same keys with the
same types, defaults, importances and documentation, the same values from
the repo's properties file and from crafted ones, the same ConfigException
cases, and the same ExecutorConfig and RetryPolicy mapped from them. A
class-name default is compared after swapping the package prefix, and the
port's name the port's classes. Tolerance: exact (strings, integers and
host floats parsed the same way); nothing reads a clock.
"""

import importlib
import pathlib

import pytest

from cruise_control_torch.config import configdef as tdef
from cruise_control_torch.config import cruise_config as tcfg
from cruise_control_tpu.config import configdef as jdef
from cruise_control_tpu.config import cruise_config as jcfg

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX, PORT = "cruise_control_tpu.", "cruise_control_torch."


def _swap(value):
    """A JAX value as the port states it: class paths under the port's prefix."""
    if isinstance(value, str):
        return value.replace(JAX, PORT)
    if isinstance(value, (list, tuple)):
        return type(value)(_swap(v) for v in value)
    return value


def test_keys_types_defaults_and_docs_equal_jax():
    jkeys, tkeys = jcfg._DEF.keys(), tcfg._DEF.keys()
    assert list(tkeys) == list(jkeys)
    for name, jk in jkeys.items():
        tk = tkeys[name]
        assert (tk.type.name, tk.importance.name, tk.doc) == \
            (jk.type.name, jk.importance.name, jk.doc), name
        assert tk.has_default == jk.has_default, name
        if jk.has_default:
            assert tk.default == _swap(jk.default), name
    assert any(name.startswith("tpu.") for name in tkeys)
    assert (tcfg.DEFAULT_GOALS, tcfg.HARD_GOALS, tcfg.ANOMALY_DETECTION_GOALS) == \
        (jcfg.DEFAULT_GOALS, jcfg.HARD_GOALS, jcfg.ANOMALY_DETECTION_GOALS)


def test_defaults_equal_jax_value_for_value():
    j, t = jcfg.CruiseControlConfig({}), tcfg.CruiseControlConfig({})
    assert list(t._values) == list(j._values)
    for name, v in j._values.items():
        assert t._values[name] == _swap(v), name
    assert t.goal_names() == j.goal_names()
    assert t.goal_names("hard.goals") == j.goal_names("hard.goals")


def test_class_path_defaults_name_the_port():
    paths = []
    for name, key in tcfg._DEF.keys().items():
        for v in (key.default if isinstance(key.default, (list, tuple)) else [key.default]):
            if isinstance(v, str) and v.startswith("cruise_control"):
                paths.append((name, v))
    assert len(paths) == 13
    for name, v in paths:
        assert v.startswith(PORT), (name, v)


#: class-name keys whose default the port resolves, and the detector's two
#: (the notifier's resolves; the metric anomaly finder's names a module that
#: the JAX package has no more than the port)
RESOLVED = ("metric.sampler.class", "sample.store.class",
            "broker.capacity.config.resolver.class", "executor.notifier.class",
            "metric.sampler.partition.assignor.class", "network.client.provider.class")
DETECTOR_KEYS = ("anomaly.notifier.class", "metric.anomaly.finder.class")


@pytest.mark.parametrize("key", RESOLVED + ("replica.movement.strategies",))
def test_class_defaults_resolve_in_the_port(key):
    t = tcfg.CruiseControlConfig({})
    for path in t.get_list(key) if key == "replica.movement.strategies" else [t.get(key)]:
        cls = tdef.resolve_class(path)
        jcls = jdef.resolve_class(path.replace(PORT, JAX))
        assert cls.__module__ == jcls.__module__.replace(JAX, PORT)
        assert cls.__qualname__ == jcls.__qualname__


@pytest.mark.parametrize("key", DETECTOR_KEYS)
def test_detector_class_defaults_wait_for_the_detector(key):
    """The notifier's default instantiates the port's NoopNotifier, as the
    JAX default does the JAX class; the finder's raises in both packages."""
    t, j = tcfg.CruiseControlConfig({}), jcfg.CruiseControlConfig({})
    assert t.get(key).startswith(PORT + "detector.")
    if key == "metric.anomaly.finder.class":
        for config, defs in ((t, tdef), (j, jdef)):
            with pytest.raises(defs.ConfigException, match="Could not load class"):
                defs.resolve_class(config.get(key))
        return
    from cruise_control_torch.detector.notifier import AnomalyNotifier as TNotifier
    from cruise_control_tpu.detector.notifier import AnomalyNotifier as JNotifier

    tn = t.get_configured_instance(key, TNotifier)
    jn = j.get_configured_instance(key, JNotifier)
    assert type(tn).__module__ == type(jn).__module__.replace(JAX, PORT)
    assert type(tn).__qualname__ == type(jn).__qualname__ == "NoopNotifier"


def test_pluggable_defaults_instantiate_as_in_jax():
    from cruise_control_torch.executor.notifier import ExecutorNotifier
    from cruise_control_torch.monitor.fetcher import MetricSamplerPartitionAssignor
    from cruise_control_torch.monitor.sample_store import SampleStore
    from cruise_control_torch.monitor.sampler import MetricSampler

    t = tcfg.CruiseControlConfig({})
    for key, base in (("metric.sampler.class", MetricSampler),
                      ("sample.store.class", SampleStore),
                      ("executor.notifier.class", ExecutorNotifier),
                      ("metric.sampler.partition.assignor.class",
                       MetricSamplerPartitionAssignor)):
        inst = t.get_configured_instance(key, base)
        assert type(inst).__module__.startswith(PORT), key
    with pytest.raises(tdef.ConfigException, match="not a subclass"):
        t.get_configured_instance("sample.store.class", MetricSampler)


def test_repo_properties_file_equal_jax(tmp_path):
    """config/cruisecontrol.properties with every key line uncommented (it
    states each default): both packages read the same strings into the same
    values, class paths included (the file names the JAX package's)."""
    lines = (ROOT / "config" / "cruisecontrol.properties").read_text().splitlines()
    path = tmp_path / "cruisecontrol.properties"
    path.write_text("\n".join(ln[1:] if ln[:2].strip("#").islower() else ln for ln in lines))
    props = tdef.load_properties(str(path))
    assert props == jdef.load_properties(str(path)) and len(props) >= 100
    j, t = jcfg.CruiseControlConfig.from_properties_file(str(path)), \
        tcfg.CruiseControlConfig.from_properties_file(str(path))
    assert t._values == j._values
    assert t.unused() == j.unused()


CRAFTED = """\
# a comment
! another comment
num.concurrent.partition.movements.per.broker = 3
num.concurrent.leader.movements: 250
execution.progress.check.interval.ms=25
executor.task.deadline.s=1.5
executor.proposal.revalidate=false
executor.proposal.max.generation.skew=17
removed.broker.history.retention.ms=60000
default.goals=com.linkedin.kafka.cruisecontrol.analyzer.goals.RackAwareGoal,\\
    DiskCapacityGoal
tpu.mesh.devices=4
executor.retry.attempts=6
executor.retry.backoff.s=0.25
executor.retry.max.backoff.s=3
some\\=odd\\:key=value
an.unknown.key=kept
key.without.value
"""


def test_crafted_properties_file_equal_jax(tmp_path):
    path = tmp_path / "cc.properties"
    path.write_text(CRAFTED)
    props = tdef.load_properties(str(path))
    assert props == jdef.load_properties(str(path))
    assert props["num.concurrent.leader.movements"] == "250"
    j, t = jcfg.CruiseControlConfig(props), tcfg.CruiseControlConfig(props)
    for name, v in j._values.items():
        assert t._values[name] == _swap(v), name
    assert t.goal_names() == j.goal_names() == ["RackAwareGoal", "DiskCapacityGoal"]
    assert t.originals() == j.originals()
    assert t.get_int("tpu.mesh.devices") == 4


BAD = [
    {"cpu.capacity.threshold": "1.5"},
    {"num.cached.recent.anomaly.states": "0"},
    {"metric.sampling.interval.ms": "not-a-number"},
    {"executor.proposal.max.generation.skew": "-1"},
    {"executor.proposal.revalidate": "maybe"},
    {"execution.progress.check.interval.ms": "1.5"},
]


@pytest.mark.parametrize("props", BAD, ids=lambda p: next(iter(p)))
def test_config_exceptions_equal_jax(props):
    with pytest.raises(jdef.ConfigException) as je:
        jcfg.CruiseControlConfig(props)
    with pytest.raises(tdef.ConfigException) as te:
        tcfg.CruiseControlConfig(props)
    assert str(te.value) == str(je.value)


def test_unknown_key_and_bad_class_path_raise_as_in_jax():
    for pkg, d, c in ((JAX, jdef, jcfg), (PORT, tdef, tcfg)):
        cfg = c.CruiseControlConfig({})
        with pytest.raises(d.ConfigException, match="Unknown configuration"):
            cfg.get("no.such.key")
        with pytest.raises(d.ConfigException, match="Invalid class path"):
            d.resolve_class("NoModule")
        with pytest.raises(d.ConfigException, match="Could not load class"):
            d.resolve_class(pkg + "executor.strategy.NoSuchStrategy")


PROPS = [{}, {"num.concurrent.partition.movements.per.broker": "3",
              "num.concurrent.leader.movements": "250",
              "execution.progress.check.interval.ms": "25",
              "removed.broker.history.retention.ms": "60000",
              "executor.task.deadline.s": "1.5", "executor.proposal.revalidate": "false",
              "executor.proposal.max.generation.skew": "17"}]


@pytest.mark.parametrize("props", PROPS, ids=("defaults", "set"))
def test_executor_config_from_config_equal_jax(props):
    from cruise_control_torch.executor import ExecutorConfig as TConfig
    from cruise_control_tpu.executor import ExecutorConfig as JConfig

    jc = JConfig.from_config(jcfg.CruiseControlConfig(props))
    tc = TConfig.from_config(tcfg.CruiseControlConfig(props))
    assert tc.__dict__ == jc.__dict__
    assert TConfig().__dict__ == JConfig().__dict__


@pytest.mark.parametrize("props", [{}, {"executor.retry.attempts": "6",
                                        "executor.retry.backoff.s": "0.25",
                                        "executor.retry.max.backoff.s": "3"}],
                         ids=("defaults", "set"))
def test_retry_policy_from_config_equal_jax(props):
    jp = importlib.import_module(JAX + "common.retry").RetryPolicy.from_config(
        jcfg.CruiseControlConfig(props))
    tp = importlib.import_module(PORT + "common.retry").RetryPolicy.from_config(
        tcfg.CruiseControlConfig(props))
    assert (tp.max_attempts, tp.backoff_s, tp.max_backoff_s, tp.deadline_s) == \
        (jp.max_attempts, jp.backoff_s, jp.max_backoff_s, jp.deadline_s)
    assert [tp.backoff_for(a) for a in range(8)] == [jp.backoff_for(a) for a in range(8)]


@pytest.mark.parametrize("props", [{}, {
    "optimizer.batch.actions.per.round": "32", "optimizer.max.rounds.per.goal": "48",
    "optimizer.candidate.replicas.per.broker": "5", "optimizer.swap.broker.pairs": "12",
    "optimizer.swap.candidate.replicas": "6", "optimizer.chunk.rounds": "0",
    "optimizer.apply.waves": "4", "optimizer.drain.source.brokers": "256",
    "optimizer.drain.candidates.per.broker": "4", "optimizer.drain.destination.brokers": "32",
    "optimizer.bulk.count.waves": "0", "optimizer.bulk.min.brokers": "64",
    "optimizer.polish.rounds": "24", "optimizer.bucket.partitions": "false",
    "optimizer.bucket.brokers": "false", "optimizer.bucket.ratio": "1.5",
    "optimizer.bucket.floor": "128", "optimizer.provenance.ledger": "false",
    "optimizer.incremental.enabled": "false", "optimizer.incremental.max.deltas": "16",
    "optimizer.incremental.fallback.full": "false"}], ids=("defaults", "set"))
def test_optimizer_and_incremental_settings_from_config_equal_jax(props):
    """OptimizerSettings and IncrementalConfig read from the same keys equal
    the JAX classes' field for field."""
    import dataclasses

    from cruise_control_torch.analyzer.incremental import IncrementalConfig as TInc
    from cruise_control_torch.analyzer.optimizer import OptimizerSettings as TSettings
    from cruise_control_tpu.analyzer.incremental import IncrementalConfig as JInc
    from cruise_control_tpu.analyzer.optimizer import OptimizerSettings as JSettings

    jc, tc = jcfg.CruiseControlConfig(props), tcfg.CruiseControlConfig(props)
    for jcls, tcls in ((JSettings, TSettings), (JInc, TInc)):
        want, got = jcls.from_config(jc), tcls.from_config(tc)
        assert [f.name for f in dataclasses.fields(got)] == \
            [f.name for f in dataclasses.fields(want)]
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        if props:
            assert got != tcls(), "every crafted key moves a field off its default"
