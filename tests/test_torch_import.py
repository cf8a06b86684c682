"""The PyTorch port stands alone: it imports without JAX, and no file of it
(nor chip_smoke.py) imports JAX or the JAX package."""

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


def test_every_module_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'cruise_control_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import cruise_control_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(cruise_control_torch.__path__,"
        " 'cruise_control_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        f"assert set({MONITOR_PATH!r}) <= set(names), sorted(set({MONITOR_PATH!r}) - set(names))\n"
        "import chip_smoke\n"
        "assert 'jax' not in {k.split('.')[0] for k, v in sys.modules.items() if v is not None}\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 15
