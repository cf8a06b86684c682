"""cclint core: rule registry, suppression handling, runner, output.

The JAX package's linter core for the PyTorch port: the same rule
registry, suppression syntax, runner and renderers. Every rule is an AST
(or cross-file inventory) check with a stable id, per-rule fixtures under
tests/lint_fixtures_torch/ (the concurrency, registry and lint families
share the JAX package's tests/lint_fixtures/), and a suppression syntax that
*requires* a written justification:

    something_hairy()  # cclint: disable=rule-id -- why this one is safe

A suppression with no `-- reason` is itself a finding
(`lint-malformed-suppression`); a suppression that stops matching anything
is too (`lint-unused-suppression`, judged per selected rule, so partial
runs — `--rule`, `--tier`, `--changed-only` — still retire stale debt for
the rules they ran), so the escape hatch cannot silently rot.

Rules come in two TIERS. The `token` tier is pure `ast` + text — no torch
import, no kernel build — and stays tier-1 cheap on every run. The `trace`
tier (rules_trace.py) runs the REAL kernel entry points declared in
lint/entrypoints.py under a PyTorch dispatch recorder in one worker
subprocess per linted file set, memoized on disk keyed by the sources'
content hash, the torch version and the device, so repeat runs do not pay
it again (tests/test_torch_static_guards.py).

Entry points: `python -m cruise_control_torch.lint` (CLI, JSON or human
output, stable exit codes) and `run_rules()` (the tier-1 gate drives it
directly).
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import io
import json
import pathlib
import re
import time
import tokenize
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

#: exit codes of the CLI (stable; CI scripts may match on them)
EXIT_CLEAN = 0
EXIT_FINDINGS = 1
EXIT_ERROR = 2


class DeviceUnavailable(RuntimeError):
    """The trace tier was asked for a device this machine does not have
    (the CLI exits EXIT_ERROR; nothing falls back to the CPU)."""

_SUPPRESS_RE = re.compile(
    r"#\s*cclint:\s*disable=([A-Za-z0-9_,\- ]+?)\s*(?:--\s*(\S.*))?$"
)

#: modules whose code runs inside a round (or is a kernel's wrapper): the
#: `cuda` family applies here. The JAX package's three patterns, the round
#: engines, the SPMD kernels and the kernel wrappers. Matched on
#: repo-relative posix paths; a module can also opt in with a
#: `# cclint: kernel-module` marker in its first lines (fixtures do).
KERNEL_PATH_PATTERNS: Tuple[str, ...] = (
    "*/analyzer/goals/*.py",
    "*/analyzer/bulk.py",
    "*/models/flat_model.py",
    "*/analyzer/drain.py",
    "*/analyzer/swaps.py",
    "*/analyzer/acceptance.py",
    "*/analyzer/actions.py",
    "*/analyzer/context.py",
    "*/parallel/spmd.py",
    "*/kernels/*.py",
)
KERNEL_MARKER_RE = re.compile(r"^#\s*cclint:\s*kernel-module\s*$")


@dataclasses.dataclass
class Suppression:
    """One `# cclint: disable=...` comment, keyed to the line it covers."""

    comment_line: int
    target_line: int
    rules: Tuple[str, ...]
    reason: str
    malformed: bool
    used: set = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class Finding:
    rule: str
    path: str  # repo-relative posix path
    line: int
    message: str
    suppressed: bool = False
    suppress_reason: Optional[str] = None

    def to_dict(self) -> Dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "suppressed": self.suppressed,
            "suppressReason": self.suppress_reason,
        }


class SourceFile:
    """One parsed python file: AST, raw lines, suppressions, kernel flag."""

    def __init__(self, path: pathlib.Path, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.parse_error: Optional[str] = None
        try:
            self.tree: Optional[ast.AST] = ast.parse(text, filename=rel)
        except SyntaxError as e:
            self.tree = None
            self.parse_error = f"{e.msg} (line {e.lineno})"
        #: real comment tokens only (tokenize): a docstring showing the
        #: suppression syntax as an example must not register one
        self.comments: Dict[int, str] = self._comment_map()
        self.suppressions: Dict[int, Suppression] = {}
        self._parse_suppressions()
        self.is_kernel = any(
            KERNEL_MARKER_RE.match(line.strip()) for line in self.lines[:5]
        ) or any(fnmatch.fnmatch("/" + rel, pat) for pat in KERNEL_PATH_PATTERNS)

    def _comment_map(self) -> Dict[int, str]:
        out: Dict[int, str] = {}
        try:
            for tok in tokenize.generate_tokens(io.StringIO(self.text).readline):
                if tok.type == tokenize.COMMENT:
                    out[tok.start[0]] = tok.string
        except (tokenize.TokenError, IndentationError, SyntaxError):
            pass  # unparseable files already carry a lint-parse-error finding
        return out

    def _parse_suppressions(self) -> None:
        for i, comment in sorted(self.comments.items()):
            m = _SUPPRESS_RE.search(comment)
            if m is None:
                continue
            line = self.lines[i - 1]
            rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
            reason = (m.group(2) or "").strip()
            # a standalone comment covers the NEXT line; a trailing comment
            # covers its own line
            standalone = line.strip().startswith("#")
            target = i + 1 if standalone else i
            self.suppressions[target] = Suppression(
                comment_line=i,
                target_line=target,
                rules=rules,
                reason=reason,
                malformed=not rules or not reason,
            )


class LintContext:
    """Everything the rules see: parsed sources, doc texts, a shared cache.

    Registry-family rules reconcile cross-file inventories (config keys,
    sensor names, span kinds) and memoize their extractions in `cache`.
    """

    def __init__(self, root: pathlib.Path, files: List[SourceFile],
                 docs: Dict[str, str], device: str = "cuda"):
        self.root = root
        self.files = files
        self.docs = docs
        #: the device the trace tier's worker runs the entry points on
        self.device = device
        self.cache: Dict[str, object] = {}

    @property
    def kernel_files(self) -> List[SourceFile]:
        return [f for f in self.files if f.is_kernel and f.tree is not None]

    @property
    def parsed_files(self) -> List[SourceFile]:
        return [f for f in self.files if f.tree is not None]

    def files_named(self, basename: str) -> List[SourceFile]:
        return [f for f in self.files if pathlib.PurePosixPath(f.rel).name == basename]

    def doc_corpus(self) -> str:
        return "\n".join(self.docs.values())


_EXCLUDED_DIR_PARTS = {"__pycache__", "lint_fixtures", "lint_fixtures_torch", ".git"}


def _collect(root: pathlib.Path, paths: Iterable[pathlib.Path], suffix: str) -> List[pathlib.Path]:
    out = []
    for p in paths:
        if p.is_dir():
            # exclusion is relative to the scanned base, so linting a
            # fixture directory itself (tests do) still sees its files
            out.extend(
                q for q in sorted(p.rglob(f"*{suffix}"))
                if not (_EXCLUDED_DIR_PARTS & set(q.relative_to(p).parts))
            )
        elif p.suffix == suffix:
            out.append(p)
    return out


def build_context(
    root: pathlib.Path,
    py_paths: Optional[Sequence[pathlib.Path]] = None,
    doc_paths: Optional[Sequence[pathlib.Path]] = None,
    device: str = "cuda",
) -> LintContext:
    """Build a context for `root` (the repo checkout or a fixture dir).

    Defaults: lint the `cruise_control_torch` package (or, absent one — the
    fixture case — every .py under root) against README.md + docs/*.md (or
    every .md under root). `device` is where the trace tier runs the
    entry points: `cuda` (the default, as main.py's) or `cpu`.
    """
    root = pathlib.Path(root).resolve()
    if py_paths is None:
        pkg = root / "cruise_control_torch"
        py_paths = [pkg] if pkg.is_dir() else [root]
    if doc_paths is None:
        doc_paths = [p for p in (root / "README.md", root / "docs") if p.exists()]
        if not doc_paths:
            doc_paths = [root]
    files = []
    for p in _collect(root, py_paths, ".py"):
        rel = p.resolve().relative_to(root).as_posix() if p.resolve().is_relative_to(root) else p.name
        files.append(SourceFile(p, rel, p.read_text()))
    docs = {}
    for p in _collect(root, doc_paths, ".md"):
        rel = p.resolve().relative_to(root).as_posix() if p.resolve().is_relative_to(root) else p.name
        docs[rel] = p.read_text()
    return LintContext(root, files, docs, device)


# -- rule registry -------------------------------------------------------------


#: the two analysis tiers (CLI `--tier`): `token` rules read source text
#: and ASTs; `trace` rules run the registered kernel entry points under a
#: dispatch recorder (rules_trace.py)
TIERS = ("token", "trace")


class Rule:
    """Base class: subclass, set the class attributes, implement check()."""

    id: str = ""
    family: str = ""  # "cuda" | "concurrency" | "registry" | "trace" | "lint"
    tier: str = "token"  # "token" (ast/text) | "trace" (dispatch-level)
    rationale: str = ""

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, src: SourceFile, line: int, message: str) -> Finding:
        return Finding(rule=self.id, path=src.rel, line=line, message=message)


RULES: Dict[str, Rule] = {}


def register(cls):
    """Class decorator: instantiate and add to the global registry."""
    inst = cls()
    if not inst.id or not inst.family or not inst.rationale:
        raise ValueError(f"rule {cls.__name__} must declare id/family/rationale")
    if inst.id in RULES:
        raise ValueError(f"duplicate rule id {inst.id}")
    RULES[inst.id] = inst
    return cls


def all_rules() -> List[Rule]:
    # importing the rule modules populates RULES exactly once
    from cruise_control_torch.lint import (  # noqa: F401
        rules_concurrency,
        rules_cuda,
        rules_registry,
        rules_trace,
    )

    return sorted(RULES.values(), key=lambda r: (r.family, r.id))


def tier_rules(tier: str) -> List[Rule]:
    """The rule subset for a CLI `--tier` selection (`token`/`trace`/`all`)."""
    rules = all_rules()
    if tier == "all":
        return rules
    if tier not in TIERS:
        raise ValueError(f"unknown tier {tier!r}; expected one of {TIERS + ('all',)}")
    return [r for r in rules if r.tier == tier]


# -- meta rules (emitted by the runner, registered so they are cataloged) ------


@register
class ParseErrorRule(Rule):
    id = "lint-parse-error"
    family = "lint"
    rationale = "a file the linter cannot parse is a file no rule protects"

    def check(self, ctx):  # runner-emitted
        return iter(())


@register
class MalformedSuppressionRule(Rule):
    id = "lint-malformed-suppression"
    family = "lint"
    rationale = "every suppression must name its rules AND carry a `-- reason`"

    def check(self, ctx):  # runner-emitted
        return iter(())


@register
class UnusedSuppressionRule(Rule):
    id = "lint-unused-suppression"
    family = "lint"
    rationale = "a suppression that no longer matches a finding is stale debt"

    def check(self, ctx):  # runner-emitted
        return iter(())


_META_RULES = {"lint-parse-error", "lint-malformed-suppression", "lint-unused-suppression"}


# -- runner --------------------------------------------------------------------


def run_rules(
    ctx: LintContext,
    rules: Optional[Sequence[Rule]] = None,
    check_unused: Optional[bool] = None,
    timings: Optional[Dict[str, float]] = None,
) -> List[Finding]:
    """Run `rules` (default: all registered) over the context.

    Suppression semantics: a finding on line N is suppressed by a
    well-formed `# cclint: disable=<rule>[,<rule>...] -- reason` comment on
    line N, or standalone on line N-1. Staleness is judged PER SELECTED
    RULE: a suppression naming a rule that ran and matched nothing is flagged
    even on partial (`--rule`/`--tier`/`--changed-only`) runs — only rules
    that did not run are off the table (a partial run cannot judge them).
    A suppression naming a rule id that does not exist at all is always
    stale. `check_unused=False` disables the staleness pass entirely.

    `timings`, when given, is filled with per-rule wall seconds (the
    `--json` schema's wallMs; a trace rule's first check carries the shared
    dispatch-recording payload for its tier, cache permitting).
    """
    selected = list(rules) if rules is not None else all_rules()
    if check_unused is None:
        check_unused = True
    findings: List[Finding] = []
    for src in ctx.files:
        if src.parse_error is not None:
            findings.append(Finding(
                rule="lint-parse-error", path=src.rel, line=1,
                message=f"cannot parse: {src.parse_error}",
            ))
        for sup in src.suppressions.values():
            if sup.malformed:
                findings.append(Finding(
                    rule="lint-malformed-suppression", path=src.rel,
                    line=sup.comment_line,
                    message="suppression must be `# cclint: disable=<rule-id>"
                            " -- <justification>` (reason is mandatory)",
                ))
    for rule in selected:
        t0 = time.monotonic()
        findings.extend(rule.check(ctx))
        if timings is not None:
            timings[rule.id] = timings.get(rule.id, 0.0) + (time.monotonic() - t0)
    by_rel = {src.rel: src for src in ctx.files}
    for f in findings:
        src = by_rel.get(f.path)
        if src is None or f.rule in _META_RULES:
            continue
        sup = src.suppressions.get(f.line)
        if sup is not None and not sup.malformed and f.rule in sup.rules:
            f.suppressed = True
            f.suppress_reason = sup.reason
            sup.used.add(f.rule)
    if check_unused:
        # per-rule-scoped staleness: only rules that actually ran (or ids
        # that exist in no registry — typos) are judged, so a `--tier token`
        # or `--rule X` run cannot false-flag a live trace-rule suppression
        selected_ids = {r.id for r in selected}
        known_ids = {r.id for r in all_rules()}
        for src in ctx.files:
            for sup in src.suppressions.values():
                if sup.malformed:
                    continue
                stale = [
                    r for r in sup.rules
                    if (r in selected_ids or r not in known_ids)
                    and r not in sup.used
                ]
                for r in stale:
                    findings.append(Finding(
                        rule="lint-unused-suppression", path=src.rel,
                        line=sup.comment_line,
                        message=f"suppression for `{r}` matches no finding —"
                                " delete it or fix the rule id",
                    ))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def unsuppressed(findings: Iterable[Finding]) -> List[Finding]:
    return [f for f in findings if not f.suppressed]


# -- output --------------------------------------------------------------------


def render_human(findings: Sequence[Finding], num_files: int,
                 num_rules: int, show_suppressed: bool = False) -> str:
    lines = []
    for f in findings:
        if f.suppressed and not show_suppressed:
            continue
        mark = " (suppressed: %s)" % f.suppress_reason if f.suppressed else ""
        lines.append(f"{f.path}:{f.line}: {f.rule}  {f.message}{mark}")
    open_count = len(unsuppressed(findings))
    sup_count = len(findings) - open_count
    lines.append(
        f"{open_count} finding(s), {sup_count} suppressed — "
        f"{num_rules} rule(s) over {num_files} file(s)"
    )
    return "\n".join(lines)


def render_json(findings: Sequence[Finding], num_files: int,
                rules: Sequence[Rule],
                timings: Optional[Dict[str, float]] = None,
                trace_stats: Optional[Dict] = None) -> str:
    """Schema v2: every rule row carries its family, tier, and wall-time
    (CI archives this artifact next to the tier-1 log — scripts/ci.sh)."""
    by_rule: Dict[str, int] = {}
    for f in findings:
        if not f.suppressed:
            by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    timings = timings or {}
    doc = {
        "version": 2,
        "rules": [
            {
                "id": r.id,
                "family": r.family,
                "tier": r.tier,
                "wallMs": round(timings.get(r.id, 0.0) * 1000.0, 3),
            }
            for r in rules
        ],
        "numFiles": num_files,
        "findings": [f.to_dict() for f in findings],
        "summary": {
            "total": len(findings),
            "unsuppressed": len(unsuppressed(findings)),
            "suppressed": len(findings) - len(unsuppressed(findings)),
            "byRule": dict(sorted(by_rule.items())),
        },
    }
    if trace_stats is not None:
        doc["trace"] = trace_stats
    return json.dumps(doc, indent=2)


# -- shared AST helpers --------------------------------------------------------


def node_names(node: ast.AST) -> set:
    """Every identifier mentioned in an expression (Name ids + Attribute attrs)."""
    out = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            out.add(n.attr)
    return out


def literal_or_fstring_pattern(node: ast.AST) -> Optional[str]:
    """A string literal as itself; an f-string as an fnmatch pattern with
    `*` standing in for each interpolation; anything else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(v.value)
            else:
                parts.append("*")
        return "".join(parts)
    return None


def patterns_intersect(a: str, b: str) -> bool:
    """Loose intersection test for two fnmatch-style patterns: does either,
    read as a plain string, satisfy the other read as a pattern? Exact for
    literal-vs-pattern; conservative (may over-match) for pattern-vs-pattern,
    which is the right failure mode for an inventory check."""
    return fnmatch.fnmatchcase(a, b) or fnmatch.fnmatchcase(b, a)
