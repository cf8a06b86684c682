"""The port's device telemetry and kernel-build cache against the JAX
package's on the CPU: the fingerprint and its schema keys (torch and CUDA in
place of jax and jaxlib, the probe flag never set: the port does not fall
back), the CUDA probe's refusal of a missing card, the disabled collector,
the transfer meters, the memory watermark on the CPU (RSS, flagged), the
gauges on /metrics, the kernel-library records in place of XLA programs,
and the build cache's contract (the four cases of tests/test_compile_cache
.py). No kernel is built: the build cache's directory is checked, and the
records are made by hand. No JAX program is compiled."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cruise_control_torch import compile_cache, platform_probe
from cruise_control_torch.common.telemetry import TELEMETRY, DeviceTelemetry, tree_nbytes
from cruise_control_torch.kernels import build

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors, several test processes: one intra-op thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_fingerprint_correct_on_cpu():
    from cruise_control_tpu.common.telemetry import TELEMETRY as JTELEMETRY

    t = DeviceTelemetry(device="cpu")
    fp = t.fingerprint()
    assert set(fp) - {"torch", "cuda"} == set(JTELEMETRY.fingerprint()) - {"jax", "jaxlib"}
    assert fp["platform"] == "cpu" and fp["deviceKind"] == "cpu" and fp["deviceCount"] == 1
    assert fp["torch"] == torch.__version__ and fp["cuda"] == torch.version.cuda
    assert fp["gitSha"] and len(fp["gitSha"]) >= 7
    int(fp["gitSha"][:7], 16)
    assert fp["probeFallback"] is False


def test_fingerprint_probe_fallback_override_and_record():
    t = DeviceTelemetry()
    t._fingerprint_base = {"platform": "cpu"}  # skip device probing
    assert t.fingerprint()["probeFallback"] is False
    assert t.fingerprint(probe_fallback=True)["probeFallback"] is True
    t.set_probe_fallback(True)
    assert t.fingerprint()["probeFallback"] is True
    assert t.fingerprint(probe_fallback=False)["probeFallback"] is False


def test_probe_refuses_a_missing_card_and_records_the_cpu(monkeypatch):
    """No card here: asking for one raises an error naming it, and nothing
    is pinned to the CPU; asking for the CPU is not probed."""
    monkeypatch.setattr(platform_probe, "_record", lambda result, device: result)
    logs = []
    with pytest.raises(platform_probe.DeviceUnavailableError, match=r"cuda:0") as err:
        platform_probe.ensure_live_backend(timeout_s=120, log=logs.append)
    assert "does not fall back" in str(err.value) and "is_available" in str(err.value)
    assert platform_probe.ensure_live_backend(device="cpu", log=logs.append) == \
        platform_probe.ProbeResult("cpu", False, 0)
    with pytest.raises(ValueError):
        platform_probe.ensure_live_backend(device="tpu", log=logs.append)


def test_record_program_is_a_kernel_library_build():
    t = DeviceTelemetry()
    rec = t.record_program("kernel library window_sum", "P8-B8-T1-RF1",
                           build.BuildRecord("window_sum", 1.5, True))
    assert rec["costAvailable"] is False and "flops" not in rec
    assert (rec["library"], rec["buildSeconds"], rec["built"]) == ("window_sum", 1.5, True)
    assert rec["collectiveOps"] == 0 and rec["collectivesPerRound"]["ops"] == 0
    [row] = t.programs()
    assert row["bucket"] == "P8-B8-T1-RF1"
    cost = t._bucket_cost("P8-B8-T1-RF1")
    assert cost["programs"] == 1 and cost["buildSeconds"] == 1.5 and cost["flops"] == 0.0
    assert t.overhead_s > 0.0


def test_tree_nbytes_and_transfer_meters():
    from cruise_control_tpu.common.telemetry import tree_nbytes as jtree_nbytes

    t = DeviceTelemetry()
    tree = {"a": np.zeros((10, 10), np.float32), "b": [np.zeros(5, np.int64)]}
    assert tree_nbytes(tree) == jtree_nbytes(tree) == 400 + 40
    assert tree_nbytes((torch.zeros(3, 4), (torch.zeros(2, dtype=torch.int64), 7))) == 48 + 16
    before = t.transfer_totals()
    t.record_transfer("h2d", 1000)
    t.record_transfer("d2h", 500)
    after = t.transfer_totals()
    assert after["hostToDeviceBytes"] - before["hostToDeviceBytes"] == 1000
    assert after["hostToDeviceTransfers"] - before["hostToDeviceTransfers"] == 1
    assert after["deviceToHostBytes"] - before["deviceToHostBytes"] == 500


def test_memory_watermark_cpu_fallback_and_monotone_peak():
    t = DeviceTelemetry(device="cpu")
    m1 = t.update_memory()
    assert m1["fallback"] == 1 and m1["bytesInUse"] > 0
    assert m1["peakBytesInUse"] >= m1["bytesInUse"]
    m2 = t.update_memory()
    assert m2["peakBytesInUse"] >= m1["peakBytesInUse"]


def test_disabled_telemetry_collects_nothing():
    t = DeviceTelemetry(enabled=False)
    t.record_transfer("h2d", 10**9)
    assert t.update_memory() == {}
    assert t.record_program("p", "B", object()) is None
    assert t.programs() == []


def test_new_gauges_render_on_metrics():
    import cruise_control_torch.analyzer.optimizer  # noqa: F401 - registers the cache gauge
    from cruise_control_torch.common.sensors import REGISTRY

    TELEMETRY.update_memory()
    text = REGISTRY.prometheus_text()
    assert 'sensor="DeviceTelemetry.device-memory",field="bytesInUse"' in text
    assert 'sensor="DeviceTelemetry.overhead-seconds"' in text
    assert 'sensor="GoalOptimizer.program-cache-size"' in text


def test_optimizer_meters_transfers_and_memory_on_the_cpu():
    """A CPU solve marks the prep cache's upload and the result's read-back
    and polls memory at the boundary; it looks up no kernel library."""
    from cruise_control_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_torch.common.sensors import REGISTRY
    from cruise_control_torch.models import generators

    m = generators.random_cluster(3, generators.ClusterProperty(
        num_racks=2, num_brokers=4, num_topics=3, replication_factor=2))
    hits = REGISTRY.meter("GoalOptimizer.program-cache-hits").snapshot()["count"]
    before = TELEMETRY.transfer_totals()
    TELEMETRY.reset()
    GoalOptimizer(device="cpu").optimizations(m, ["RackAwareGoal"], raise_on_hard_failure=False)
    after = TELEMETRY.transfer_totals()
    assert after["hostToDeviceTransfers"] == before["hostToDeviceTransfers"] + 1
    assert after["deviceToHostTransfers"] == before["deviceToHostTransfers"] + 1
    assert after["deviceToHostBytes"] - before["deviceToHostBytes"] >= 2 * m.assignment.numel() * 4
    assert TELEMETRY.memory()["bytesInUse"] > 0
    assert REGISTRY.meter("GoalOptimizer.program-cache-hits").snapshot()["count"] == hits


# -- the build cache (test_compile_cache.py's cases) -----------------------------


@pytest.fixture
def _fresh_cache(monkeypatch):
    """Clean module state; the build directory restored after."""
    monkeypatch.delenv("CRUISE_CONTROL_KERNEL_CACHE", raising=False)
    monkeypatch.setattr(compile_cache, "_enabled", None)
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)


def test_default_dir_is_the_checkouts_build_dir(_fresh_cache):
    got = compile_cache.enable_persistent_cache()
    assert got == os.path.abspath(REPO / "build" / "cruise_control_torch")
    assert build.BUILD_DIR == Path(got)


def test_enables_and_second_call_is_noop(_fresh_cache, tmp_path):
    target = str(tmp_path / "kernel_cache")
    got = compile_cache.enable_persistent_cache(target)
    assert got == os.path.abspath(target) and os.path.isdir(got)
    assert build.BUILD_DIR == Path(got)
    assert build._lib_path("window_sum").parent == Path(got)
    other = str(tmp_path / "other")
    assert compile_cache.enable_persistent_cache(other) == got
    assert not os.path.exists(other)


def test_env_dir_is_honored(_fresh_cache, tmp_path, monkeypatch):
    target = str(tmp_path / "env_cache")
    monkeypatch.setenv("CRUISE_CONTROL_KERNEL_CACHE", target)
    assert compile_cache.enable_persistent_cache() == os.path.abspath(target)


def test_unwritable_dir_returns_none(_fresh_cache, tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    before = build.BUILD_DIR
    assert compile_cache.enable_persistent_cache(str(blocker / "sub")) is None
    assert compile_cache._enabled is None and build.BUILD_DIR == before


def test_cache_needs_no_jax():
    code = ("import sys\n"
            "for n in ('jax', 'jaxlib', 'cruise_control_tpu'):\n"
            "    sys.modules[n] = None\n"
            "from cruise_control_torch import compile_cache, platform_probe\n"
            "from cruise_control_torch.common.telemetry import TELEMETRY\n"
            "print(platform_probe.ensure_live_backend(device='cpu', log=lambda m: None))\n"
            "print(TELEMETRY.fingerprint()['platform'], TELEMETRY.device)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[1] == "cpu cpu"
