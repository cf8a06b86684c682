"""The port's linter (cruise_control_torch/lint): per-rule fixtures, the
rule catalog and its tiers, the CLI's exit codes, the dispatch tier's
cache and checks, and the linter held against the JAX package's on the CPU.

Every port rule ships a flagging and a clean fixture under
tests/lint_fixtures_torch/<rule-id>/{flag,clean}/; the families the two
linters share (concurrency, registry, lint) run the JAX package's fixtures
under tests/lint_fixtures/, where both linters must give the same findings.
The trace fixtures declare their own registries and each costs one worker
subprocess (a torch import); the package-scale run is
tests/test_torch_static_guards.py's."""

from __future__ import annotations

import ast
import json
import pathlib
import subprocess
import sys

import pytest
import torch

from cruise_control_torch.lint import (
    EXIT_CLEAN,
    EXIT_ERROR,
    EXIT_FINDINGS,
    RULES,
    all_rules,
    build_context,
    render_json,
    run_rules,
    tier_rules,
    unsuppressed,
)
from cruise_control_torch.lint import rules_trace
from cruise_control_torch.lint.cli import main as cclint_main
from cruise_control_torch.lint.rules_trace import CACHE_STATS, content_key, trace_payload
from cruise_control_torch.lint.trace_worker import (
    SiteFinder,
    check_carry,
    held_tensors,
    make_recorder,
    sync_census,
)
from cruise_control_tpu.lint import all_rules as jax_all_rules
from cruise_control_tpu.lint import build_context as jax_build_context
from cruise_control_tpu.lint import render_json as jax_render_json
from cruise_control_tpu.lint import run_rules as jax_run_rules

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FIXTURES = ROOT / "tests" / "lint_fixtures_torch"
JAX_FIXTURES = ROOT / "tests" / "lint_fixtures"
PORT_RULE_IDS = sorted(r.id for r in all_rules())
SHARED_FAMILIES = ("concurrency", "registry", "lint")
SHARED_IDS = sorted(r.id for r in all_rules() if r.family in SHARED_FAMILIES)
#: the JAX package's `tpu` rules and their port counterparts
TPU_TO_CUDA = {
    "tpu-host-sync": "cuda-host-sync",
    "tpu-python-loop": "cuda-python-loop",
    "tpu-shape-branch": "cuda-shape-branch",
    "tpu-donated-reuse": "cuda-stale-alias",
    "tpu-padding-denominator": "cuda-padding-denominator",
}
TRACE_TO_PORT = {
    "trace-host-callback": "trace-host-sync",
    "trace-donation-integrity": "trace-mutation-integrity",
    "trace-carry-stability": "trace-carry-stability",
    "trace-constant-bloat": "trace-constant-bloat",
    "trace-sharding-lowering": "trace-sharding-collectives",
    "trace-entry-error": "trace-entry-error",
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def trace_cache(tmp_path, monkeypatch):
    """Each test's trace verdicts live in its own cache directory."""
    cache = tmp_path / "trace-cache"
    monkeypatch.setenv(rules_trace.CACHE_ENV, str(cache))
    return cache


def _fixture_dir(rule_id: str, kind: str) -> pathlib.Path:
    port = PORT_FIXTURES / rule_id / kind
    return port if port.is_dir() else JAX_FIXTURES / rule_id / kind


def _stats_delta(fn):
    before = dict(CACHE_STATS)
    out = fn()
    return out, {k: CACHE_STATS[k] - before[k] for k in CACHE_STATS}


def _keyset(findings):
    return sorted({(f.rule, f.path, f.line, f.suppressed) for f in findings})


class TestRuleCatalog:
    def test_five_families_shipped(self):
        assert {r.family for r in all_rules()} == {"cuda", "concurrency", "registry", "trace",
                                                   "lint"}

    def test_every_rule_has_id_family_tier_rationale(self):
        for r in all_rules():
            assert r.id and r.family and r.rationale, r
            assert r.tier in ("token", "trace"), r.id

    def test_tier_selection_partitions_the_registry(self):
        token = {r.id for r in tier_rules("token")}
        trace = {r.id for r in tier_rules("trace")}
        assert token and trace and not (token & trace)
        assert token | trace == {r.id for r in tier_rules("all")}
        assert all(rid.startswith("trace-") for rid in trace)
        assert {r.id for r in all_rules() if r.family == "cuda"} <= token

    def test_port_ids_map_every_jax_id(self):
        jax_ids = {r.id for r in jax_all_rules()}
        port_ids = set(PORT_RULE_IDS)
        mapping = {**TPU_TO_CUDA, **TRACE_TO_PORT}
        assert set(mapping) == {i for i in jax_ids if i.startswith(("tpu-", "trace-"))}
        assert set(mapping.values()) == {i for i in port_ids if i.startswith(("cuda-", "trace-"))}
        shared_jax = {r.id for r in jax_all_rules() if r.family in SHARED_FAMILIES}
        assert shared_jax == set(SHARED_IDS)

    def test_rules_cuda_docstring_carries_the_id_table(self):
        from cruise_control_torch.lint import rules_cuda

        for jax_id, port_id in TPU_TO_CUDA.items():
            assert any(jax_id in line and port_id in line
                       for line in rules_cuda.__doc__.splitlines()), jax_id


@pytest.mark.parametrize("rule_id", PORT_RULE_IDS)
class TestRuleFixtures:
    def test_flag_fixture_flags(self, rule_id):
        d = _fixture_dir(rule_id, "flag")
        findings = run_rules(build_context(d, device="cpu"))
        hits = [f for f in unsuppressed(findings) if f.rule == rule_id]
        assert hits, (rule_id, [(f.rule, f.path, f.line) for f in findings])
        for f in hits:
            assert f.path and f.line >= 1 and f.message

    def test_clean_fixture_is_clean(self, rule_id):
        d = _fixture_dir(rule_id, "clean")
        findings = run_rules(build_context(d, device="cpu"))
        assert not [f for f in unsuppressed(findings) if f.rule == rule_id], findings


def test_every_port_only_rule_has_its_own_fixtures():
    for r in all_rules():
        if r.family not in SHARED_FAMILIES:
            for kind in ("flag", "clean"):
                d = PORT_FIXTURES / r.id / kind
                assert d.is_dir() and list(d.glob("*.py")), d
    # pytest must collect none of them
    assert not list(PORT_FIXTURES.rglob("test_*.py"))


class TestHeldAgainstJax:
    """The families both linters ship give the same findings: on the JAX
    package's fixtures, and over the port's own sources."""

    @pytest.mark.parametrize("rule_id", SHARED_IDS)
    @pytest.mark.parametrize("kind", ["flag", "clean"])
    def test_shared_rule_fixtures_agree(self, rule_id, kind):
        d = JAX_FIXTURES / rule_id / kind
        port_rules = [r for r in all_rules() if r.family in SHARED_FAMILIES]
        jax_rules = [r for r in jax_all_rules() if r.family in SHARED_FAMILIES]
        port = run_rules(build_context(d, device="cpu"), rules=port_rules)
        jax = jax_run_rules(jax_build_context(d), rules=jax_rules)
        assert _keyset(port) == _keyset(jax)

    def test_concurrency_and_registry_over_the_port_agree(self):
        paths = [ROOT / "cruise_control_torch"]
        families = ("concurrency", "registry")
        port = run_rules(build_context(ROOT, py_paths=paths, device="cpu"),
                         rules=[r for r in all_rules() if r.family in families])
        jax = jax_run_rules(jax_build_context(ROOT, py_paths=paths),
                            rules=[r for r in jax_all_rules() if r.family in families])
        ids = {r.id for r in all_rules() if r.family in families}
        port = [f for f in port if f.rule in ids]
        jax = [f for f in jax if f.rule in ids]
        assert _keyset(port) == _keyset(jax)
        assert not unsuppressed(port)
        assert [(f.rule, f.path) for f in port] == [
            ("reg-config-key-reachable", "cruise_control_torch/config/cruise_config.py")]

    def test_json_v2_keys_agree(self, tmp_path):
        (tmp_path / "mod.py").write_text("def f(g):\n    while True:\n        g()\n")
        rule = [RULES["conc-unbounded-loop"]]
        port = json.loads(render_json(run_rules(build_context(tmp_path, device="cpu"),
                                                rules=tier_rules("all")), 1, rule,
                                      timings={}, trace_stats=rules_trace._public_stats({})))
        from cruise_control_tpu.lint import RULES as JAX_RULES
        from cruise_control_tpu.lint.rules_trace import _public_stats as jax_public_stats

        jax = json.loads(jax_render_json(
            jax_run_rules(jax_build_context(tmp_path)), 1, [JAX_RULES["conc-unbounded-loop"]],
            timings={}, trace_stats=jax_public_stats({})))

        def keys(doc, prefix=""):
            out = set()
            for k, v in doc.items():
                out.add(prefix + k)
                if isinstance(v, dict) and k not in ("byRule",):
                    out |= keys(v, prefix + k + ".")
                if isinstance(v, list) and v and isinstance(v[0], dict):
                    out |= keys(v[0], prefix + k + "[].")
            return out

        assert keys(port) == keys(jax)
        assert port["version"] == jax["version"] == 2

    def test_entry_names_equal_the_jax_registry(self):
        def names(path):
            tree = ast.parse(path.read_text())
            for node in tree.body:
                if isinstance(node, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == "CCLINT_TRACE_ENTRYPOINTS"
                        for t in node.targets):
                    return [kw.value.value for call in node.value.elts
                            for kw in call.keywords if kw.arg == "name"]
            return None

        port = names(ROOT / "cruise_control_torch" / "lint" / "entrypoints.py")
        jax = names(ROOT / "cruise_control_tpu" / "lint" / "entrypoints.py")
        assert port == jax and len(port) == 10


class TestSuppressions:
    def test_trace_waiver_at_the_entry_line_is_live(self, tmp_path):
        body = (PORT_FIXTURES / "trace-host-sync" / "flag" / "mod.py").read_text().replace(
            'dict(name="scalar-read-kernel", build=_build),',
            'dict(name="scalar-read-kernel", build=_build),  '
            '# cclint: disable=trace-host-sync -- fixture waiver')
        (tmp_path / "mod.py").write_text(body)
        findings = run_rules(build_context(tmp_path, device="cpu"))
        hits = [f for f in findings if f.rule == "trace-host-sync"]
        assert hits and all(f.suppressed for f in hits)
        assert not [f for f in findings if f.rule == "lint-unused-suppression"]
        # a token-only run cannot judge it, and spawns no worker
        tok, delta = _stats_delta(lambda: run_rules(build_context(tmp_path, device="cpu"),
                                                    rules=tier_rules("token")))
        assert not [f for f in tok if f.rule == "lint-unused-suppression"]
        assert delta == {"hits": 0, "misses": 0}

    def test_port_id_suppression_is_stale_for_a_removed_finding(self, tmp_path):
        (tmp_path / "kernel.py").write_text(
            "# cclint: kernel-module\n"
            "def f(x):\n"
            "    # cclint: disable=cuda-host-sync -- stale: the read went away\n"
            "    return x + 1\n")
        findings = run_rules(build_context(tmp_path, device="cpu"), rules=tier_rules("token"))
        assert [f.rule for f in unsuppressed(findings)] == ["lint-unused-suppression"]


class TestCache:
    def test_cache_lifecycle(self, tmp_path, trace_cache):
        src = (PORT_FIXTURES / "trace-entry-error" / "clean" / "mod.py").read_text()
        (tmp_path / "mod.py").write_text(src)
        _, d1 = _stats_delta(lambda: trace_payload(build_context(tmp_path, device="cpu")))
        assert d1 == {"hits": 0, "misses": 1}
        p2, d2 = _stats_delta(lambda: trace_payload(build_context(tmp_path, device="cpu")))
        assert d2 == {"hits": 1, "misses": 0} and p2["cacheHit"] and p2["findings"] == []
        (tmp_path / "mod.py").write_text(src.replace("x + 1", "x + 2"))
        p3, d3 = _stats_delta(lambda: trace_payload(build_context(tmp_path, device="cpu")))
        assert d3 == {"hits": 0, "misses": 1} and not p3["cacheHit"]
        for p in trace_cache.glob("trace-*.json"):
            p.write_text("{not json")
        _, d4 = _stats_delta(lambda: trace_payload(build_context(tmp_path, device="cpu")))
        assert d4 == {"hits": 0, "misses": 1}

    def test_key_covers_sources_and_device(self, tmp_path):
        (tmp_path / "mod.py").write_text("X = 1\n")
        cpu = content_key(build_context(tmp_path, device="cpu"))
        assert cpu != content_key(build_context(tmp_path, device="cuda"))
        (tmp_path / "mod.py").write_text("X = 2\n")
        assert cpu != content_key(build_context(tmp_path, device="cpu"))

    def test_cache_dir_is_the_ports_own(self, monkeypatch):
        monkeypatch.delenv(rules_trace.CACHE_ENV)
        monkeypatch.setenv("CCLINT_TRACE_CACHE", "/nonexistent/jax-cache")
        assert rules_trace.cache_dir() == ROOT / ".cclint_torch_cache"


class TestWorkerChecks:
    """The worker's checks, driven in-process on the CPU."""

    def test_recorder_sees_scalar_reads_shapes_and_host_data(self):
        sites = SiteFinder(ROOT)
        rec = make_recorder(sites, {}, torch.device("cpu"))
        x = torch.arange(6.0)
        with rec:
            float(x.sum())
            torch.nonzero(x > 2)
            x[x > 2]
            torch.tensor(1.0)
        kinds = {what for (_, what) in rec.syncs}
        assert kinds == {"scalar read", "nonzero", "boolean index", "host data"}
        assert all(site.startswith("tests/test_torch_lint.py:") for site, _ in rec.syncs)

    def test_plain_versions_are_the_kernels(self):
        from cruise_control_torch.kernels.partition_stats import partition_stats

        movable = torch.ones(8, dtype=torch.bool)
        assignment = torch.zeros((8, 2), dtype=torch.int32)
        _, counts = sync_census(lambda: partition_stats(movable, assignment), ROOT,
                                torch.device("cpu"))
        assert counts["plain"] and not counts["recorder"]

    def test_census_records_host_copies_on_the_cpu(self):
        x = torch.arange(4)
        _, counts = sync_census(lambda: (x.cpu(), x.tolist()), ROOT, torch.device("cpu"))
        assert sum(counts["recorder"].values()) == 2
        assert {what for _, what in counts["recorder"]} == {"device-to-host copy"}

    def test_carry_check_names_the_drift(self):
        x = torch.zeros(4)
        ok = check_carry("e", (x,), x + 1, ((0, 0),), "m.py", 3, 1)
        bad = check_carry("e", (x,), torch.cat([x, x]).double(), ((0, 0),), "m.py", 3, 1)
        assert ok == [] and [f["rule"] for f in bad] == ["trace-carry-stability"]
        assert "float32[4]@cpu -> float64[8]@cpu" in bad[0]["message"]

    def test_held_tensors_walk_closures_partials_and_bound_state(self):
        import functools

        a, b, c = torch.zeros(3), torch.zeros(5), torch.zeros(7)

        class Holder:
            def __init__(self):
                self.t = c

            def run(self, x):
                return x

        def inner(x):
            return x + a

        def outer(x):
            return inner(x)

        fn = functools.partial(lambda f, y, x: f(x) + y, outer, b)
        assert {t.numel() for t in held_tensors(fn)} == {3, 5}
        assert {t.numel() for t in held_tensors(Holder().run)} == {7}


def _spawn(args):
    return subprocess.run([sys.executable, "-m", "cruise_control_torch.lint", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


class TestCli:
    def test_exit_codes_and_python_m_equal_main(self, tmp_path):
        (tmp_path / "bad.py").write_text("def f(g):\n    while True:\n        g()\n")
        cases = [
            (["--root", str(tmp_path), "--tier", "token"], EXIT_FINDINGS),
            (["--root", str(tmp_path), "--tier", "trace"], EXIT_CLEAN),  # no entries
            (["--rule", "no-such-rule"], EXIT_ERROR),
        ]
        for args, rc in cases:
            assert _spawn(args).returncode == cclint_main(args) == rc, args

    def test_no_card_stops_the_trace_tier(self, tmp_path, capsys):
        if torch.cuda.is_available():
            pytest.skip("this machine has a card: the cuda trace tier runs")
        (tmp_path / "mod.py").write_text(
            (PORT_FIXTURES / "trace-entry-error" / "clean" / "mod.py").read_text())
        args = ["--root", str(tmp_path), "--tier", "trace"]
        assert cclint_main(args) == EXIT_ERROR
        assert "no CUDA card" in capsys.readouterr().err
        proc = _spawn(args)
        assert proc.returncode == EXIT_ERROR and "cuda:0" in proc.stderr
        assert cclint_main(args + ["--device", "cpu"]) == EXIT_CLEAN

    def test_list_rules_names_the_port_ids(self, capsys):
        assert cclint_main(["--list-rules"]) == EXIT_CLEAN
        out = capsys.readouterr().out
        for rid in ("cuda-host-sync", "cuda-stale-alias", "trace-mutation-integrity",
                    "conc-guarded-by", "reg-config-key-declared"):
            assert rid in out

    def test_tier_token_json(self, tmp_path, capsys):
        (tmp_path / "ok.py").write_text("X = 1\n")
        assert cclint_main(["--root", str(tmp_path), "--tier", "token", "--json"]) == EXIT_CLEAN
        doc = json.loads(capsys.readouterr().out)
        assert {r["tier"] for r in doc["rules"]} == {"token"}

    def test_kernel_scoping_covers_the_round_modules(self):
        ctx = build_context(ROOT, device="cpu")
        kernels = {f.rel for f in ctx.kernel_files}
        for rel in ("analyzer/bulk.py", "analyzer/drain.py", "analyzer/swaps.py",
                    "analyzer/acceptance.py", "analyzer/actions.py", "analyzer/context.py",
                    "models/flat_model.py", "parallel/spmd.py", "kernels/apply_wave.py",
                    "analyzer/goals/hard.py"):
            assert "cruise_control_torch/" + rel in kernels, rel
        assert "cruise_control_torch/analyzer/optimizer.py" not in kernels
