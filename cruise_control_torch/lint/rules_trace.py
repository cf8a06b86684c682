"""Trace-tier rules (family `trace`): dispatch-level contracts the token
rules cannot see.

The token tier reads source text; these rules read what the entry points
DO. Every module declaring a `CCLINT_TRACE_ENTRYPOINTS` registry
(lint/entrypoints.py registers the port's fused stack, chunked goal
machine, bulk/drain/swap rounds, the mesh's dispatch surfaces and the
lane's delta apply) is handed to a worker subprocess
(lint/trace_worker.py) that runs each entry on `--device` under a PyTorch
dispatch recorder (on the card also under the CUDA sync-debug mode) and
reports violations of five contracts:

  trace-host-sync            no scalar read, data-dependent output size,
                             device-to-host copy or (on the card) sync-debug
                             warning inside an entry
  trace-mutation-integrity   every declared mutates_argnums argument is
                             written in place, and no other argument is
  trace-carry-stability      carried tensors keep dtype/shape/device across
                             two runs, and no op yields float64
  trace-constant-bloat       no large tensor held by the entry's closure
  trace-sharding-collectives mesh entries stay inside their all-gather /
                             all-reduce budget a call
  trace-entry-error          the registry itself is well-formed and runs

JAX id -> port id: trace-host-callback -> trace-host-sync,
trace-donation-integrity -> trace-mutation-integrity,
trace-sharding-lowering -> trace-sharding-collectives; the other three keep
their ids.

Cost model: the worker pays a torch import and the entries' runs, so
results are cached on disk keyed by the CONTENT HASH of the linted sources
plus the torch version, the worker schema and the device — a repeat run
with unchanged sources never spawns the worker. The cache lives in
`.cclint_torch_cache/` at the repo root (not committed), or where
CCLINT_TORCH_TRACE_CACHE points.

This module itself imports no torch: the version string comes from package
metadata, and everything that runs an entry happens in the worker.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import pathlib
import subprocess
import sys
from typing import Dict, Iterator, List

from cruise_control_torch.lint.core import (
    DeviceUnavailable,
    Finding,
    LintContext,
    Rule,
    SourceFile,
    register,
)
from cruise_control_torch.lint.trace_worker import EXIT_NO_DEVICE, WORKER_SCHEMA

#: cache directory: env override (tests point it at tmp), else a dot-dir at
#: the repo root; a name of its own, so the JAX linter's CCLINT_TRACE_CACHE
#: cannot cross into it
CACHE_ENV = "CCLINT_TORCH_TRACE_CACHE"
#: worker wall-clock ceiling (seconds)
TIMEOUT_ENV = "CCLINT_TORCH_TRACE_TIMEOUT"
DEFAULT_TIMEOUT_S = 540.0

#: process-lifetime cache counters, reset-able by tests
CACHE_STATS = {"hits": 0, "misses": 0}

_REGISTRY_NAME = "CCLINT_TRACE_ENTRYPOINTS"
_REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]


def cache_dir() -> pathlib.Path:
    env = os.environ.get(CACHE_ENV)
    return pathlib.Path(env) if env else _REPO_ROOT / ".cclint_torch_cache"


def entry_modules(ctx: LintContext) -> List[SourceFile]:
    """Files whose module level assigns CCLINT_TRACE_ENTRYPOINTS (AST, not
    text — a docstring mentioning the name must not opt a module in)."""
    out = []
    for src in ctx.parsed_files:
        for node in src.tree.body:
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign):
                targets = [node.target]
            if any(
                isinstance(t, ast.Name) and t.id == _REGISTRY_NAME
                for t in targets
            ):
                out.append(src)
                break
    return out


def _versions() -> str:
    """The torch version WITHOUT importing it (metadata only): part of the
    cache key, since a toolchain bump can change every verdict."""
    from importlib import metadata

    parts = []
    for pkg in ("torch",):
        try:
            parts.append(f"{pkg}={metadata.version(pkg)}")
        except metadata.PackageNotFoundError:
            parts.append(f"{pkg}=absent")
    return ";".join(parts)


def content_key(ctx: LintContext) -> str:
    """sha256 over every linted source (rel path + bytes), the torch
    version, the worker schema and the device. Conservative by design: ANY
    source edit in the linted set invalidates — a dependency-graph hash
    would miss transitive kernel imports."""
    h = hashlib.sha256()
    h.update(f"schema={WORKER_SCHEMA};{_versions()};device={ctx.device}".encode())
    for src in sorted(ctx.files, key=lambda s: s.rel):
        h.update(b"\x00")
        h.update(src.rel.encode())
        h.update(b"\x00")
        h.update(src.text.encode())
    return h.hexdigest()


def _cache_load(key: str):
    path = cache_dir() / f"trace-{key[:32]}.json"
    try:
        doc = json.loads(path.read_text())
    except (OSError, ValueError):
        return None
    if doc.get("key") != key or doc.get("version") != WORKER_SCHEMA:
        return None
    return doc


def _cache_store(key: str, payload: Dict) -> None:
    d = cache_dir()
    try:
        d.mkdir(parents=True, exist_ok=True)
        tmp = d / f".trace-{key[:32]}.tmp.{os.getpid()}"
        tmp.write_text(json.dumps(
            {"key": key, "version": WORKER_SCHEMA, **payload}, indent=2,
            sort_keys=True,
        ))
        tmp.replace(d / f"trace-{key[:32]}.json")
    except OSError:
        pass  # a read-only checkout still lints, it just re-traces


def _spawn_worker(ctx: LintContext, mods: List[SourceFile]) -> Dict:
    cmd = [
        sys.executable, "-m", "cruise_control_torch.lint.trace_worker",
        "--root", str(ctx.root), "--device", ctx.device,
    ] + [m.rel for m in mods]
    env = dict(os.environ)
    env["PYTHONPATH"] = (
        str(_REPO_ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    ).rstrip(os.pathsep)
    timeout = float(os.environ.get(TIMEOUT_ENV, DEFAULT_TIMEOUT_S))
    try:
        proc = subprocess.run(
            cmd, cwd=_REPO_ROOT, env=env, capture_output=True, text=True,
            timeout=timeout,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return {"findings": [
            {
                "rule": "trace-entry-error", "path": m.rel, "line": 1,
                "message": f"trace worker did not run: {type(e).__name__}: "
                           f"{str(e)[:200]}",
            }
            for m in mods
        ], "stats": {"workerError": str(e)[:200]}}
    if proc.returncode == EXIT_NO_DEVICE:
        raise DeviceUnavailable((proc.stderr or "").strip().splitlines()[-1])
    if proc.returncode != 0:
        tail = (proc.stderr or proc.stdout or "").strip().splitlines()[-6:]
        return {"findings": [
            {
                "rule": "trace-entry-error", "path": m.rel, "line": 1,
                "message": f"trace worker exited {proc.returncode}: "
                           + " | ".join(tail)[:300],
            }
            for m in mods
        ], "stats": {"workerError": f"rc={proc.returncode}"}}
    try:
        doc = json.loads(proc.stdout)
    except ValueError:
        return {"findings": [
            {
                "rule": "trace-entry-error", "path": m.rel, "line": 1,
                "message": "trace worker produced unparseable output: "
                           + proc.stdout[:200],
            }
            for m in mods
        ], "stats": {"workerError": "bad-json"}}
    return {"findings": doc.get("findings", []), "stats": doc.get("stats", {})}


def trace_payload(ctx: LintContext) -> Dict:
    """The shared per-context trace verdict: computed once, memoized in
    ctx.cache for the run and on disk (content-hash keyed) across runs."""
    cached = ctx.cache.get("trace-payload")
    if cached is not None:
        return cached
    mods = entry_modules(ctx)
    if not mods:
        payload = {"findings": [], "stats": {"entryPoints": 0, "modules": 0},
                   "cacheHit": False, "skipped": True}
        ctx.cache["trace-payload"] = payload
        ctx.cache["trace-stats"] = _public_stats(payload)
        return payload
    key = content_key(ctx)
    doc = _cache_load(key)
    if doc is not None:
        CACHE_STATS["hits"] += 1
        payload = {"findings": doc["findings"], "stats": doc.get("stats", {}),
                   "cacheHit": True, "skipped": False}
    else:
        CACHE_STATS["misses"] += 1
        fresh = _spawn_worker(ctx, mods)
        if "workerError" not in fresh.get("stats", {}):
            _cache_store(key, fresh)
        payload = {**fresh, "cacheHit": False, "skipped": False}
    ctx.cache["trace-payload"] = payload
    ctx.cache["trace-stats"] = _public_stats(payload)
    return payload


def _public_stats(payload: Dict) -> Dict:
    """The `trace` block of the --json schema."""
    stats = payload.get("stats", {})
    return {
        "cacheHit": payload.get("cacheHit", False),
        "skipped": payload.get("skipped", False),
        "entryPoints": stats.get("entryPoints", 0),
        "modules": stats.get("modules", 0),
        "workerWallS": stats.get("wallS", 0.0),
    }


class TraceRule(Rule):
    """Shared base: each rule yields its slice of the worker's findings.
    The first trace rule to run pays (or cache-loads) the shared payload."""

    family = "trace"
    tier = "trace"

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        for f in trace_payload(ctx)["findings"]:
            if f["rule"] == self.id:
                yield Finding(
                    rule=self.id, path=f["path"], line=int(f["line"]),
                    message=f["message"],
                )


@register
class HostSyncRule(TraceRule):
    id = "trace-host-sync"
    rationale = (
        "a scalar read, a data-dependent output size, a device-to-host copy "
        "or (on the card) a synchronizing CUDA call inside an entry stalls "
        "the launch queue and breaks CUDA-graph capture of the round — "
        "invisible to token rules when buried in a helper"
    )


@register
class MutationIntegrityRule(TraceRule):
    id = "trace-mutation-integrity"
    rationale = (
        "an entry writes exactly the arguments its call site declares in "
        "mutates_argnums: a declared argument nothing writes is a stale "
        "contract, an undeclared write corrupts state the caller still "
        "reads (the static context is shared by the optimizer's prep cache)"
    )


@register
class CarryStabilityRule(TraceRule):
    id = "trace-carry-stability"
    rationale = (
        "a round entry's carried tensors must keep dtype, shape and device "
        "when fed back, and no op may compute float64 (the reference runs "
        "without x64), or a captured round cannot replay"
    )


@register
class ConstantBloatRule(TraceRule):
    id = "trace-constant-bloat"
    rationale = (
        "a large tensor held by an entry's closure pins device memory for "
        "the closure's life and is baked into any captured graph; big "
        "operands must arrive as arguments"
    )


@register
class ShardingCollectivesRule(TraceRule):
    id = "trace-sharding-collectives"
    rationale = (
        "mesh entries may gather and sum only as their design says (one "
        "all-gather a shortlist, one integer all-reduce a coverage "
        "certificate, none where the work runs whole on the first device); "
        "a collective past the budget moves a sharded axis whole"
    )


@register
class EntryErrorRule(TraceRule):
    id = "trace-entry-error"
    rationale = (
        "an entry-point registry that fails to import, build, or run is "
        "a kernel surface no trace rule certifies — equivalent to "
        "lint-parse-error one tier up"
    )
