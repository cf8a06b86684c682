"""The port's entry point against the JAX package's: `build_simulated_service`
on the CPU gives the parts the JAX one gives, the `--config` keys reach the
tracer, the history store, the telemetry collector and the provenance
ledger (tests/test_observability.py's config cases), a multi-device mesh is
refused, and `main` without a card exits non-zero naming it and serves
nothing: there is no CPU fallback. `--device cpu` serves, and SIGINT stops
it. No optimization runs; no JAX program is compiled."""

import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _listening(port: int) -> bool:
    with socket.socket() as s:
        return s.connect_ex(("127.0.0.1", port)) == 0


def test_build_simulated_service_gives_the_jax_parts():
    from cruise_control_torch.main import build_simulated_service
    from cruise_control_tpu.main import build_simulated_service as jbuild

    app, parts = build_simulated_service(num_brokers=4, num_racks=2, num_topics=3, device="cpu")
    japp, jparts = jbuild(num_brokers=4, num_racks=2, num_topics=3)
    try:
        assert set(parts) == set(jparts)
        for k in parts:
            if k != "reporters":
                assert type(parts[k]).__name__ == type(jparts[k]).__name__, k
        assert len(parts["reporters"]) == len(jparts["reporters"]) == 4
        assert type(app).__name__ == type(japp).__name__
        assert str(parts["facade"]._optimizer._device) == "cpu"
        assert parts["sim"].fetch_topology().assignment.tolist() == \
            jparts["sim"].fetch_topology().assignment.tolist()
    finally:
        parts["acc"].shutdown()
        jparts["acc"].shutdown()


def test_observability_config_keys_reach_tracer(tmp_path):
    from cruise_control_torch.common.tracing import TRACER
    from cruise_control_torch.config.cruise_config import CruiseControlConfig
    from cruise_control_torch.main import build_simulated_service

    cfg = CruiseControlConfig({})
    assert cfg.get_int("observability.trace.ring.size") == 4096
    jsonl = tmp_path / "trace.jsonl"
    props = tmp_path / "cc.properties"
    props.write_text("observability.trace.ring.size=128\n"
                     f"observability.trace.jsonl.path={jsonl}\n")
    old_ring, old_path = TRACER.ring_size, TRACER._jsonl_path
    try:
        _, parts = build_simulated_service(num_brokers=4, num_racks=2, num_topics=3,
                                           config_path=str(props), device="cpu")
        parts["acc"].shutdown()
        assert TRACER.ring_size == 128
        with TRACER.span("cfg-roundtrip"):
            pass
        assert any(json.loads(line)["name"] == "cfg-roundtrip"
                   for line in jsonl.read_text().splitlines())
    finally:
        TRACER.configure(ring_size=old_ring, jsonl_path=old_path)


def test_history_telemetry_and_ledger_config_keys_reach_stores(tmp_path):
    from cruise_control_torch.analyzer.provenance import LEDGER
    from cruise_control_torch.common.history import HISTORY
    from cruise_control_torch.common.telemetry import TELEMETRY
    from cruise_control_torch.main import build_simulated_service

    jsonl = tmp_path / "history.jsonl"
    props = tmp_path / "cc.properties"
    props.write_text("observability.history.ring.size=64\n"
                     f"observability.history.jsonl.path={jsonl}\n"
                     "telemetry.enabled=false\n"
                     "observability.ledger.runs=3\n"
                     "optimizer.batch.actions.per.round=8\n")
    old_state, old_enabled = HISTORY.state(), TELEMETRY.enabled
    old_runs = LEDGER.state()
    try:
        _, parts = build_simulated_service(num_brokers=4, num_racks=2, num_topics=3,
                                           config_path=str(props), device="cpu")
        parts["acc"].shutdown()
        assert HISTORY.state()["capacity"] == 64
        assert TELEMETRY.enabled is False
        assert LEDGER.state()["capacity"] == 3
        assert parts["facade"]._optimizer._settings.batch_k == 8
        HISTORY.snapshot_now("cfg-roundtrip")
        assert any(json.loads(line)["reason"] == "cfg-roundtrip"
                   for line in jsonl.read_text().splitlines())
        assert not HISTORY.sampler_running
    finally:
        HISTORY.configure(ring_size=old_state["capacity"],
                          jsonl_path=old_state["jsonlPath"] or "",
                          interval_s=old_state["intervalS"])
        TELEMETRY.configure(enabled=old_enabled)
        LEDGER.configure(max_runs=old_runs["capacity"])


def test_mesh_of_two_devices_is_refused(tmp_path):
    """A mesh larger than the visible cards is refused with the JAX
    package's message (parallel/sharding.make_mesh): here there is no card."""
    from cruise_control_torch.main import build_simulated_service, main
    from cruise_control_torch.parallel.sharding import visible_devices

    props = tmp_path / "cc.properties"
    props.write_text("tpu.mesh.devices=2\n")
    with pytest.raises(ValueError, match=f"need 2 devices, have {len(visible_devices())}"):
        build_simulated_service(num_brokers=4, num_racks=2, num_topics=3,
                                config_path=str(props), device="cpu")
    assert main(["--device", "cpu", "--config", str(props), "--port", "0"]) == 1


def test_mesh_of_one_device_is_no_mesh(tmp_path):
    """`tpu.mesh.devices=1` turns the mesh off, as in the JAX package: the
    service builds and its optimizer solves on `device` alone."""
    from cruise_control_torch.main import build_simulated_service

    props = tmp_path / "cc.properties"
    props.write_text("tpu.mesh.devices=1\ntpu.mesh.axis.name=shards\n")
    _, parts = build_simulated_service(num_brokers=4, num_racks=2, num_topics=3,
                                       config_path=str(props), device="cpu")
    optimizer = parts["facade"]._optimizer
    assert optimizer._mesh is None and str(optimizer._device) == "cpu"


def test_main_without_a_card_exits_naming_it_and_serves_nothing():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the probe would pass")
    port = _free_port()
    out = subprocess.run([sys.executable, "-m", "cruise_control_torch.main", "--port", str(port)],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "cuda:0" in out.stderr and "does not fall back" in out.stderr
    assert "serving" not in out.stdout and not _listening(port)


def test_main_on_the_cpu_serves_and_stops_on_sigint():
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-m", "cruise_control_torch.main", "--port",
                             str(port), "--device", "cpu", "--simulate-brokers", "4"],
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env)
    try:
        deadline = time.monotonic() + 240
        while not _listening(port):
            assert proc.poll() is None, proc.communicate()[1]
            assert time.monotonic() < deadline, "the service never listened"
            time.sleep(0.2)
        cli = subprocess.run([sys.executable, "-m", "cruise_control_torch.client.cccli", "-a",
                              f"http://127.0.0.1:{port}", "--json", "state", "--substates",
                              "analyzer"], cwd=REPO, capture_output=True, text=True, timeout=120)
        assert cli.returncode == 0, cli.stderr
        assert "AnalyzerState" in json.loads(cli.stdout)
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
