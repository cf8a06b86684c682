"""Device telemetry: what the card did, not just how long it took.

The JAX package's common/telemetry.py, on torch. It records:

  * **Kernel-library builds** in place of XLA programs. XLA cost analysis
    (flops, bytes accessed per compiled program) has no torch analog: the
    port's device code is hand-written kernels in shared libraries. A
    program record keeps the JAX schema's keys with `costAvailable: False`
    and adds what the port does have: the kernel library's name, the
    seconds its build or load took and whether it was built or found in the
    build cache (kernels/build.py), keyed by the shape bucket of the solve
    that needed it.
  * **Collectives** of the partition-axis mesh (parallel/spmd.py), counted
    as they happen rather than read from lowered HLO: each gather of the
    shards' shortlist records an `all-gather`, each integer sum of their
    counts an `all-reduce`, on a program record named after the entry point
    (`spmd-grid-shortlist`, `spmd-partition-stats`) in the JAX schema's
    collective fields (`collectiveOps`, `collectiveBytes`, `collectives`,
    `collectivesPerRound` for the shortlist's, which a round makes).
    `collective_totals()` and `snapshot()["collectives"]` sum them, as the
    JAX package's do.
  * **Device memory watermarks**: `torch.cuda.memory_stats` and
    `max_memory_allocated` when the service runs on the card; on the CPU
    process RSS stands in (flagged `fallback: 1`), as on the JAX CPU path.
  * **Host<->device transfer meters**, byte and call counts recorded where
    the optimizer moves data (the prep cache's miss path up, the result's
    read-back down).
  * **An environment fingerprint**: the platform, the card's name and count,
    the torch and CUDA versions, the git sha and the probe's fallback flag
    (always False in the port: platform_probe.py never falls back).

Everything surfaces through the process sensor registry and `GET /perf`
joins it with the build timers. Collection is gated by `telemetry.enabled`
and measures its own overhead (`DeviceTelemetry.overhead-seconds`).
"""

from __future__ import annotations

import copy
import os
import pathlib
import subprocess
import threading
import time
from typing import Dict, List, Optional

from cruise_control_torch.common.sensors import REGISTRY


def tree_nbytes(tree) -> int:
    """Total bytes of the tensors and arrays in a nest of tuples, lists and
    dicts (other leaves count 0)."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tree_nbytes(v) for v in tree)
    numel = getattr(tree, "numel", None)
    if callable(numel) and hasattr(tree, "element_size"):
        return int(numel()) * int(tree.element_size())
    return int(getattr(tree, "nbytes", 0) or 0)


def _read_rss_bytes() -> Optional[int]:
    """Process resident set size (the CPU memory fallback)."""
    try:
        with open("/proc/self/statm") as f:
            fields = f.read().split()
        return int(fields[1]) * os.sysconf("SC_PAGESIZE")
    except (OSError, ValueError, IndexError):
        return None


def _git_sha() -> Optional[str]:
    """HEAD commit of the repo this package lives in (provenance, not vcs)."""
    root = pathlib.Path(__file__).resolve().parents[2]
    try:
        out = subprocess.run(
            ["git", "-C", str(root), "rev-parse", "HEAD"],
            capture_output=True, text=True, timeout=10,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and len(sha) >= 7 else None


def _default_device() -> str:
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


class DeviceTelemetry:
    """Process-wide device-telemetry collector (one instance: `TELEMETRY`)."""

    def __init__(self, enabled: bool = True, device: Optional[str] = None):
        self._lock = threading.Lock()
        self._enabled = enabled  #: guarded_by(_lock)
        #: the device the service runs on; None: the card when torch has one
        self._device = device  #: guarded_by(_lock)
        #: (bucket, program tag) -> build record; guarded_by(_lock)
        self._programs: Dict = {}
        self._bucket_gauges: set = set()  #: guarded_by(_lock)
        self._memory: Dict = {}  #: guarded_by(_lock)
        self._fingerprint_base: Optional[Dict] = None  #: guarded_by(_lock)
        self._probe_fallback: Optional[bool] = None  #: guarded_by(_lock)
        self._overhead_s = 0.0  #: guarded_by(_lock)

    # -- configuration ---------------------------------------------------------

    def configure(self, enabled: Optional[bool] = None, device: Optional[str] = None) -> None:
        with self._lock:
            if enabled is not None:
                self._enabled = bool(enabled)
            if device is not None and device != self._device:
                self._device = device
                self._fingerprint_base = None

    @property
    def enabled(self) -> bool:
        with self._lock:
            return self._enabled

    @property
    def device(self) -> str:
        with self._lock:
            device = self._device
        return device or _default_device()

    @property
    def overhead_s(self) -> float:
        """Cumulative seconds spent inside telemetry collection."""
        with self._lock:
            return self._overhead_s

    def set_probe_fallback(self, fallback: bool) -> None:
        """Record the platform probe's outcome (platform_probe calls this)."""
        with self._lock:
            self._probe_fallback = bool(fallback)

    def _charge_locked(self, seconds: float) -> None:
        self._overhead_s += seconds

    # -- environment fingerprint -----------------------------------------------

    def fingerprint(self, probe_fallback: Optional[bool] = None) -> Dict:
        """The provenance block: platform, the card's name and count, the
        torch and CUDA versions, git sha, probe-fallback flag. Device facts
        are cached after first use; `probe_fallback` overrides the recorded
        probe outcome for this call."""
        import torch

        t0 = time.monotonic()
        with self._lock:
            base = self._fingerprint_base
            recorded = self._probe_fallback
        if base is None:
            dev = torch.device(self.device)
            on_card = dev.type == "cuda"
            base = {
                "platform": "gpu" if on_card else "cpu",
                "deviceKind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                "deviceCount": torch.cuda.device_count() if on_card else 1,
                "torch": torch.__version__,
                "cuda": torch.version.cuda,
                "gitSha": _git_sha(),
            }
            with self._lock:
                self._fingerprint_base = base
        fp = dict(base)
        if probe_fallback is None:
            probe_fallback = recorded
        fp["probeFallback"] = bool(probe_fallback) if probe_fallback is not None else False
        with self._lock:
            self._charge_locked(time.monotonic() - t0)
        return fp

    # -- kernel-library builds (the JAX package's per-program records) --------

    def record_program(self, tag: str, bucket: str, build) -> Optional[Dict]:
        """Record a kernel library's build or load (`build`: a
        kernels.build.BuildRecord) under the shape bucket of the solve that
        needed it. There is no cost analysis: `costAvailable` is False and
        the collective account is zero."""
        if not self.enabled:
            return None
        t0 = time.monotonic()
        record: Dict = {
            "program": tag,
            "bucket": bucket,
            "costAvailable": False,
            "collectiveOps": 0,
            "collectiveBytes": 0,
            "collectives": {},
            "collectivesPerRound": {"ops": 0, "bytes": 0, "byOp": {}},
            "library": getattr(build, "name", None),
            "buildSeconds": getattr(build, "seconds", None),
            "built": getattr(build, "built", None),
        }
        with self._lock:
            self._programs[(bucket, tag)] = record
            register_gauge = (
                bucket not in self._bucket_gauges
                and globals().get("TELEMETRY") is self  # scratch instances
                # (tests/harnesses) must not shadow the process collector
            )
            if register_gauge:
                self._bucket_gauges.add(bucket)
            self._charge_locked(time.monotonic() - t0)
        if register_gauge:
            REGISTRY.gauge(
                f"DeviceTelemetry.program-cost.{bucket}",
                lambda b=bucket: self._bucket_cost(b),
            )
        return record

    def _bucket_cost(self, bucket: str) -> Dict:
        """Flat numeric summary of one bucket's programs (the /metrics
        gauge); flops and bytes stay 0 with no cost analysis."""
        with self._lock:
            records = [r for (b, _), r in self._programs.items() if b == bucket]
        return {
            "programs": len(records), "flops": 0.0, "bytesAccessed": 0.0,
            "collectiveOps": sum(r.get("collectiveOps", 0) for r in records),
            "collectiveBytes": sum(r.get("collectiveBytes", 0) for r in records),
            "buildSeconds": sum(r.get("buildSeconds") or 0.0 for r in records),
        }

    def programs(self) -> List[Dict]:
        """All recorded program records (the /perf payload rows)."""
        with self._lock:
            return [copy.deepcopy(r) for r in self._programs.values()]

    # -- the mesh's collectives --------------------------------------------------

    def record_collective(self, op: str, nbytes: int, bucket: str, tag: str,
                          per_round: bool) -> None:
        """One collective of the mesh as it happens: `op` ("all-gather" or
        "all-reduce") of `nbytes` landing on the mesh's first device, counted
        on the program record (`bucket`, `tag`), and in its per-round account
        when a round makes it."""
        if not self.enabled:
            return
        t0 = time.monotonic()
        with self._lock:
            record = self._programs.get((bucket, tag))
            if record is None:
                record = self._programs[(bucket, tag)] = {
                    "program": tag, "bucket": bucket, "costAvailable": False,
                    "collectiveOps": 0, "collectiveBytes": 0, "collectives": {},
                    "collectivesPerRound": {"ops": 0, "bytes": 0, "byOp": {}},
                    "library": None, "buildSeconds": None, "built": None,
                }
            accounts = [(record, "collectiveOps", "collectiveBytes", record["collectives"])]
            if per_round:
                rnd = record["collectivesPerRound"]
                accounts.append((rnd, "ops", "bytes", rnd["byOp"]))
            for acc, ops, nb, by_op in accounts:
                acc[ops] += 1
                acc[nb] += int(nbytes)
                slot = by_op.setdefault(op, {"count": 0, "bytes": 0})
                slot["count"] += 1
                slot["bytes"] += int(nbytes)
            self._charge_locked(time.monotonic() - t0)

    def collective_totals(self) -> Dict:
        """Collective-traffic totals across all program records (the JAX
        package's keys: ops, bytes, perRoundOps, perRoundBytes, byOp)."""
        records = self.programs()
        out: Dict = {"ops": 0, "bytes": 0, "perRoundOps": 0, "perRoundBytes": 0, "byOp": {}}
        for r in records:
            out["ops"] += r.get("collectiveOps", 0)
            out["bytes"] += r.get("collectiveBytes", 0)
            per_round = r.get("collectivesPerRound") or {}
            out["perRoundOps"] += per_round.get("ops", 0)
            out["perRoundBytes"] += per_round.get("bytes", 0)
            for op, slot in (r.get("collectives") or {}).items():
                agg = out["byOp"].setdefault(op, {"count": 0, "bytes": 0})
                agg["count"] += slot["count"]
                agg["bytes"] += slot["bytes"]
        return out

    # -- host<->device transfer meters -----------------------------------------

    def record_transfer(self, direction: str, nbytes: int) -> None:
        """One host<->device transfer of `nbytes` (`direction`: h2d | d2h)."""
        if not self.enabled or nbytes is None:
            return
        t0 = time.monotonic()
        if direction == "h2d":
            REGISTRY.meter("DeviceTelemetry.host-to-device-bytes").mark(int(nbytes))
            REGISTRY.meter("DeviceTelemetry.host-to-device-transfers").mark()
        else:
            REGISTRY.meter("DeviceTelemetry.device-to-host-bytes").mark(int(nbytes))
            REGISTRY.meter("DeviceTelemetry.device-to-host-transfers").mark()
        with self._lock:
            self._charge_locked(time.monotonic() - t0)

    def transfer_totals(self) -> Dict:
        return {
            "hostToDeviceBytes": REGISTRY.meter(
                "DeviceTelemetry.host-to-device-bytes").snapshot()["count"],
            "hostToDeviceTransfers": REGISTRY.meter(
                "DeviceTelemetry.host-to-device-transfers").snapshot()["count"],
            "deviceToHostBytes": REGISTRY.meter(
                "DeviceTelemetry.device-to-host-bytes").snapshot()["count"],
            "deviceToHostTransfers": REGISTRY.meter(
                "DeviceTelemetry.device-to-host-transfers").snapshot()["count"],
        }

    # -- device memory watermarks ----------------------------------------------

    def _card_stats(self) -> Optional[Dict]:
        """The card's allocator numbers, or None on the CPU or before the
        card is initialised in this process."""
        import torch

        dev = torch.device(self.device)
        if dev.type != "cuda" or not torch.cuda.is_initialized():
            return None
        stats = torch.cuda.memory_stats(dev)
        if not stats:
            return None
        return {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(dev)),
            "bytes_limit": int(torch.cuda.get_device_properties(dev).total_memory),
        }

    def update_memory(self) -> Dict:
        """Poll the card's memory and advance the peak watermark. On the CPU
        process RSS stands in (fallback: 1)."""
        if not self.enabled:
            return self.memory()
        t0 = time.monotonic()
        try:
            stats = self._card_stats()
        except Exception:  # a dead card must not poison the caller
            stats = None
        with self._lock:
            if stats:
                self._memory["bytesInUse"] = stats["bytes_in_use"]
                self._memory["peakBytesInUse"] = max(
                    self._memory.get("peakBytesInUse", 0), stats["peak_bytes_in_use"]
                )
                self._memory["bytesLimit"] = stats["bytes_limit"]
                self._memory["fallback"] = 0
            else:
                rss = _read_rss_bytes()
                if rss is not None:
                    self._memory["bytesInUse"] = rss
                    self._memory["peakBytesInUse"] = max(
                        self._memory.get("peakBytesInUse", 0), rss
                    )
                    self._memory["fallback"] = 1
            self._charge_locked(time.monotonic() - t0)
            return dict(self._memory)

    def memory(self) -> Dict:
        """Last observed memory picture (never polls; the /metrics gauge)."""
        with self._lock:
            return dict(self._memory)

    # -- aggregate views -------------------------------------------------------

    def snapshot(self) -> Dict:
        """One joined record: programs, memory, transfers, collectives and
        overhead."""
        return {
            "programs": self.programs(),
            "memory": self.memory(),
            "transfers": self.transfer_totals(),
            "collectives": self.collective_totals(),
            "overheadS": round(self.overhead_s, 6),
        }

    def reset(self) -> None:
        """Drop per-process program/memory records (tests isolation);
        registry meters are monotonic by contract and stay."""
        with self._lock:
            self._programs.clear()
            self._memory.clear()
            self._overhead_s = 0.0


#: the process-wide collector (the optimizer seams, GET /perf)
TELEMETRY = DeviceTelemetry(
    enabled=os.environ.get("CRUISE_CONTROL_TELEMETRY", "1") != "0"
)


def _register_telemetry_gauges() -> None:
    # registered for the singleton only: a scratch DeviceTelemetry (tests,
    # harnesses) must not shadow the process collector's /metrics rows
    REGISTRY.gauge("DeviceTelemetry.device-memory", TELEMETRY.memory)
    REGISTRY.gauge("DeviceTelemetry.overhead-seconds",
                   lambda: round(TELEMETRY.overhead_s, 6))


_register_telemetry_gauges()
