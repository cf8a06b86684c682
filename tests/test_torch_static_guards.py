"""The port's static gate: the port's linter, both tiers, over the whole
`cruise_control_torch` package with zero unsuppressed findings — the token
tier's CUDA, concurrency and registry families, and the dispatch tier
running the ten registered kernel entry points on the CPU (the card runs
them in chip_smoke's phase 24). Every waiver carries its reason and is
live; a repeat run is served from the trace cache (counted, not timed).
The counterpart of tests/test_static_guards.py, which gates the JAX
package."""

from __future__ import annotations

import ast
import pathlib
import re

import pytest

from cruise_control_torch.lint import (
    RULES,
    build_context,
    render_human,
    run_rules,
    unsuppressed,
)
from cruise_control_torch.lint import rules_trace
from cruise_control_torch.lint.rules_trace import CACHE_STATS

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "cruise_control_torch"
ENTRY_POINTS = 10


@pytest.fixture(scope="module")
def package(tmp_path_factory):
    """One cold run of both tiers over the package on the CPU (the worker
    runs the entries on one intra-op thread), its trace verdict cached in a
    directory of the module's own."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(rules_trace.CACHE_ENV, str(tmp_path_factory.mktemp("trace-cache")))
        ctx = build_context(ROOT, device="cpu")
        findings = run_rules(ctx)
        before = dict(CACHE_STATS)
        again = build_context(ROOT, device="cpu")
        repeat = run_rules(again)
        delta = {k: CACHE_STATS[k] - before[k] for k in CACHE_STATS}
        yield ctx, findings, again, repeat, delta


def _fail_message(findings):
    return "cclint found unsuppressed violations:\n" + render_human(
        findings, num_files=0, num_rules=0)


def _site_line(path: pathlib.Path, needle: str) -> int:
    """The 1-based line of `needle` in `path` (exactly one)."""
    hits = [i for i, line in enumerate(path.read_text().splitlines(), 1) if needle in line]
    assert len(hits) == 1, (path, needle, hits)
    return hits[0]


def test_port_lint_clean(package):
    ctx, findings, _, _, _ = package
    assert ctx.files and all(f.rel.startswith("cruise_control_torch/") for f in ctx.files)
    open_findings = unsuppressed(findings)
    assert not open_findings, _fail_message(open_findings)


def test_trace_tier_certifies_the_ten_entry_points(package):
    ctx, findings, _, _, _ = package
    payload = ctx.cache["trace-payload"]
    assert payload["skipped"] is False and payload["cacheHit"] is False
    stats = payload["stats"]
    assert stats["entryPoints"] == ENTRY_POINTS and stats["device"] == "cpu", stats
    assert not [f for f in findings if f.rule == "trace-entry-error"]
    from cruise_control_torch.lint import entrypoints

    assert [e["name"] for e in stats["entries"]] == [
        e["name"] for e in entrypoints.CCLINT_TRACE_ENTRYPOINTS]
    mesh = {e["name"]: e["collectivesPerCall"] for e in stats["entries"]
            if "collectivesPerCall" in e}
    assert mesh["spmd-grid-shortlist"].get("all-gather") == 1
    assert mesh["spmd-partition-stats"].get("all-reduce") == 1
    assert not any(mesh["sharded-compute-aggregates"].values())
    assert not any(mesh["sharded-compute-stats"].values())


def test_every_suppression_carries_a_reason_and_is_live(package):
    ctx, findings, _, _, _ = package
    bad = [f for f in findings
           if f.rule in ("lint-malformed-suppression", "lint-unused-suppression")]
    assert not bad, _fail_message(bad)
    n = 0
    for src in ctx.files:
        for sup in src.suppressions.values():
            assert sup.reason, f"{src.rel}:{sup.comment_line} has no reason"
            n += 1
    assert n > 0


def test_repeat_run_is_a_cache_hit(package):
    _, findings, again, repeat, delta = package
    assert delta == {"hits": 1, "misses": 0}
    assert again.cache["trace-payload"]["cacheHit"] is True
    key = lambda fs: sorted((f.rule, f.path, f.line, f.suppressed) for f in fs)  # noqa: E731
    assert key(repeat) == key(findings)


def test_the_round_reads_are_found_where_they_are(package):
    """The dispatch tier finds the host reads of the round loops (waived
    until the rounds are captured as CUDA graphs): goal_loop's flags and
    engine's applied flag under the stack, the polish phases' converged
    reads under the machine, the bulk planner's two reads under its round."""
    _, findings, _, _, _ = package
    messages = {}
    for f in findings:
        if f.rule == "trace-host-sync":
            name = re.search(r"entry `([^`]+)`", f.message).group(1)
            messages[name] = f.message
    opt = PORT / "analyzer" / "optimizer.py"
    bulk = PORT / "analyzer" / "bulk.py"
    loop_reads = [_site_line(opt, "satisfied, applied = (bool(x) for x in state.cpu())"),
                  _site_line(opt, "if fallback is None or bool(applied):")]
    for line in loop_reads:
        assert f"analyzer/optimizer.py:{line} scalar read" in messages["fused-stack-step"]
        assert f"analyzer/optimizer.py:{line} scalar read" in messages["chunked-goal-machine"]
    for needle in ("skip = _polish_skip(agg, bool(metrics.converged[g])",
                   "stalled = bool(metrics.converged[g]) if skip"):
        line = _site_line(opt, needle)
        assert f"analyzer/optimizer.py:{line} scalar read" in messages["chunked-goal-machine"]
    for needle in ("max_surplus = float(torch.max(", "n_applied, n_valid = (int(x) for x"):
        line = _site_line(bulk, needle)
        assert f"analyzer/bulk.py:{line} scalar read" in messages["bulk-count-round"]
    for f in findings:
        if f.rule.startswith("trace-"):
            assert f.suppressed and f.path == "cruise_control_torch/lint/entrypoints.py"


def test_no_bare_except_in_the_port(package):
    ctx = package[0]
    findings = unsuppressed(run_rules(ctx, rules=[RULES["conc-bare-except"]],
                                      check_unused=False))
    assert not findings, _fail_message(findings)


def test_no_unbounded_while_true_in_the_port(package):
    ctx = package[0]
    findings = unsuppressed(run_rules(ctx, rules=[RULES["conc-unbounded-loop"]],
                                      check_unused=False))
    assert not findings, _fail_message(findings)


def test_lock_discipline_annotations_present(package):
    from cruise_control_torch.lint.rules_concurrency import _guarded_attrs

    ctx = package[0]
    annotated = {}
    for src in ctx.parsed_files:
        for node in ast.walk(src.tree):
            if isinstance(node, ast.ClassDef):
                attrs = _guarded_attrs(src, node)
                if attrs:
                    annotated[f"{src.rel}:{node.name}"] = set(attrs)
    assert "_ring" in annotated.get("cruise_control_torch/common/tracing.py:Tracer", set())
    assert "_timers" in annotated.get(
        "cruise_control_torch/common/sensors.py:SensorRegistry", set())
    assert "_latest" in annotated.get(
        "cruise_control_torch/executor/tracker.py:ExecutionTaskTracker", set())
    assert "_state" in annotated.get("cruise_control_torch/common/retry.py:CircuitBreaker",
                                     set())
