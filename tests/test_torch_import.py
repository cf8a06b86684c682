"""The PyTorch port stands alone: it imports without JAX (and the Kafka
agent without the `kafka` client, which only its admin adapter imports when
it is made), and no file of it (nor chip_smoke.py) imports JAX or the JAX
package."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "cruise_control_torch"
PORT_FILES = sorted(p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")) + ["chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "cruise_control_tpu")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_port_has_files():
    assert len(PORT_FILES) > 10


@pytest.mark.parametrize("rel", PORT_FILES)
def test_no_jax_import(rel):
    roots = set(_imported_roots(ROOT / rel))
    assert not roots & set(FORBIDDEN), f"{rel} imports {sorted(roots & set(FORBIDDEN))}"


#: the load monitor's path: the modules it ported from the JAX package, each
#: imported below with JAX and the JAX package made unimportable
MONITOR_PATH = tuple(f"cruise_control_torch.{m}" for m in (
    "common.sensors", "common.tracing", "models.model_utils", "reporter", "reporter.metrics",
    "reporter.transport", "reporter.reporter", "monitor", "monitor.metricdef",
    "monitor.samples", "monitor.metadata", "monitor.processor", "monitor.sampler",
    "monitor.aggregator", "monitor.completeness", "monitor.sample_store",
    "monitor.load_monitor", "monitor.fetcher", "monitor.task_runner", "testing",
    "testing.simulator"))
#: the executor's path: the executor, the configuration, retry, oplog and
#: history modules it needs, and the chaos harness
EXECUTOR_PATH = tuple(f"cruise_control_torch.{m}" for m in (
    "common.oplog", "common.retry", "common.history", "config", "config.configdef",
    "config.cruise_config", "executor", "executor.task", "executor.strategy",
    "executor.planner", "executor.tracker", "executor.manager", "executor.driver",
    "executor.validation", "executor.notifier", "executor.executor", "testing.chaos"))
#: the self-healing loop: the detector, the facade, the async operations and
#: the cluster agent's wire
SELF_HEALING_PATH = tuple(f"cruise_control_torch.{m}" for m in (
    "detector", "detector.anomalies", "detector.notifier", "detector.detectors",
    "detector.anomaly_detector", "facade", "async_ops", "common.lineserver", "testing.faults",
    "executor.tcp_driver", "testing.fake_agent", "executor.kafka_agent"))
#: the service's front door: the CUDA probe, device telemetry, the
#: kernel-build cache, the REST servlet, the CLI client and the entry point
FRONT_DOOR_PATH = tuple(f"cruise_control_torch.{m}" for m in (
    "platform_probe", "common.telemetry", "compile_cache", "servlet", "servlet.purgatory",
    "servlet.user_tasks", "servlet.responses", "servlet.server", "client", "client.endpoint",
    "client.display", "client.cccli", "main"))
#: the partition-axis mesh: its placement, its SPMD kernels and their K12
#: and K13 kernels
MESH_PATH = tuple(f"cruise_control_torch.{m}" for m in (
    "parallel", "parallel.sharding", "parallel.spmd", "kernels.shard_merge",
    "kernels.partition_stats"))


def test_every_module_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'cruise_control_tpu', 'kafka'):\n"
        "    sys.modules[name] = None\n"
        "import cruise_control_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(cruise_control_torch.__path__,"
        " 'cruise_control_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        f"assert set({MONITOR_PATH!r}) <= set(names), sorted(set({MONITOR_PATH!r}) - set(names))\n"
        f"assert set({EXECUTOR_PATH!r}) <= set(names), \\\n"
        f"    sorted(set({EXECUTOR_PATH!r}) - set(names))\n"
        f"assert set({SELF_HEALING_PATH!r}) <= set(names), \\\n"
        f"    sorted(set({SELF_HEALING_PATH!r}) - set(names))\n"
        f"assert set({FRONT_DOOR_PATH!r}) <= set(names), \\\n"
        f"    sorted(set({FRONT_DOOR_PATH!r}) - set(names))\n"
        f"assert set({MESH_PATH!r}) <= set(names), sorted(set({MESH_PATH!r}) - set(names))\n"
        "assert 'aiohttp' not in sys.modules, 'the port serves on the standard library'\n"
        "from cruise_control_torch.config import CruiseControlConfig\n"
        "from cruise_control_torch.detector import AnomalyNotifier, NoopNotifier\n"
        "n = CruiseControlConfig({}).get_configured_instance('anomaly.notifier.class',\n"
        "                                                    AnomalyNotifier)\n"
        "assert type(n) is NoopNotifier\n"
        "import chip_smoke\n"
        "assert 'jax' not in {k.split('.')[0] for k, v in sys.modules.items() if v is not None}\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 15


def test_executor_path_imports_without_jax_and_configures_the_port():
    """The executor's path with JAX and the JAX package made unimportable:
    every class-name default of the port's configuration names a class of
    the port, and those the port has resolve and instantiate."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'cruise_control_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import cruise_control_torch.executor, cruise_control_torch.common.history\n"
        "import cruise_control_torch.testing.chaos\n"
        "from cruise_control_torch.config import configdef, cruise_config\n"
        "from cruise_control_torch.executor import ExecutorConfig\n"
        "from cruise_control_torch.executor.notifier import ExecutorNotifier\n"
        "c = cruise_config.CruiseControlConfig({})\n"
        "paths = [v for k in cruise_config._DEF.keys().values() for v in\n"
        "         (k.default if isinstance(k.default, (list, tuple)) else [k.default])\n"
        "         if isinstance(v, str) and 'cruise_control' in v]\n"
        "assert paths and all(p.startswith('cruise_control_torch.') for p in paths), paths\n"
        "for p in paths:\n"
        "    if '.detector.' not in p:\n"
        "        configdef.resolve_class(p)\n"
        "c.get_configured_instance('executor.notifier.class', ExecutorNotifier)\n"
        "print(ExecutorConfig.from_config(c).max_generation_skew, len(paths))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["8", "13"]
