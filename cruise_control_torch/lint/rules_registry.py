"""Registry-consistency rules (family `reg`), the JAX package's, with the
same ids and checks, over the port's config/cruise_config.py, sensors,
spans and servlet/server.py. The port keeps the JAX names of every key,
sensor and endpoint, so the doc corpus stays README.md + docs/*.md.

Config keys (`optimizer.*`, `executor.*`, `observability.*`,
`selfhealing.*`), sensor names, and span kinds are wired by hand across
code, `config/cruise_config.py`, `main --config`, `/metrics`, and the docs.
These rules reconcile the inventories so drift between them fails tier-1
instead of surfacing as a dead knob or an undocumented metric:

  * every config key READ (`config.get_int("...")` etc.) must be DECLARED
    in cruise_config.py and DOCUMENTED in README/docs;
  * every native key DECLARED must be READ somewhere (reachable via
    `main --config` plumbing) — reference-parity keys are exempt, they are
    accepted-but-unused by design;
  * every sensor name emitted through the process REGISTRY must appear in
    the docs/OBSERVABILITY.md inventory, and one name may not be reused
    across sensor types (REGISTRY.snapshot() merges by name — a meter and
    a gauge sharing a name silently shadow each other);
  * every span kind passed to the TRACER must be a documented kind;
  * every REST endpoint the servlet registers must have a row in
    docs/ENDPOINTS.md (an undocumented endpoint is API surface operators
    cannot discover).

F-string names (`f"Retry.{name}.retries"`) become fnmatch patterns
(`Retry.*.retries`) and match the docs' placeholder spellings
(`Retry.<name>.retries`, `...bucket.P…-B…-T…-RF…`).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Set, Tuple

from cruise_control_torch.lint.core import (
    Finding,
    LintContext,
    Rule,
    literal_or_fstring_pattern,
    patterns_intersect,
    register,
)

#: config accessor methods whose literal first argument is a key read
_READ_METHODS = {
    "get_boolean", "get_int", "get_long", "get_double", "get_string",
    "get_list", "get_password", "get_configured_instance",
    "get_configured_instances",
}

#: native key namespaces: declared keys here must be reachable (read);
#: reference-parity Kafka keys are allowed to be accepted-but-unused
_NATIVE_NAMESPACES = ("optimizer.", "executor.", "observability.",
                      "selfhealing.", "tpu.")

#: the file declaring the config universe and the doc carrying the
#: sensor/span inventory (matched by basename so fixtures can ship stubs)
_CONFIG_BASENAME = "cruise_config.py"
_SENSOR_DOC_BASENAME = "OBSERVABILITY.md"


def _config_reads(ctx: LintContext):
    """[(src, lineno, pattern)] for every literal/f-string config key read."""
    if "config_reads" in ctx.cache:
        return ctx.cache["config_reads"]
    out = []
    for src in ctx.parsed_files:
        for node in ast.walk(src.tree):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            fn = node.func
            if not (isinstance(fn, ast.Attribute) and fn.attr in _READ_METHODS):
                continue
            pattern = literal_or_fstring_pattern(node.args[0])
            # config keys are dotted; a dotless literal is some other API
            if pattern is None or "." not in pattern:
                continue
            out.append((src, node.lineno, pattern))
    ctx.cache["config_reads"] = out
    return out


def _declared_keys(ctx: LintContext):
    """[(src, lineno, pattern)] for every `*.define("key", ...)` declaration."""
    if "declared_keys" in ctx.cache:
        return ctx.cache["declared_keys"]
    out = []
    for src in ctx.files_named(_CONFIG_BASENAME):
        if src.tree is None:
            continue
        for node in ast.walk(src.tree):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            fn = node.func
            if not (isinstance(fn, ast.Attribute) and fn.attr == "define"):
                continue
            pattern = literal_or_fstring_pattern(node.args[0])
            if pattern is not None:
                out.append((src, node.lineno, pattern))
    ctx.cache["declared_keys"] = out
    return out


@register
class ConfigKeyDeclaredRule(Rule):
    id = "reg-config-key-declared"
    family = "registry"
    rationale = (
        "a key read anywhere must be declared in config/cruise_config.py — "
        "an undeclared read raises at runtime only on the config path that "
        "exercises it"
    )

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        declared = [p for _, _, p in _declared_keys(ctx)]
        if not declared:
            return  # no config universe in this context: nothing to judge
        for src, lineno, pattern in _config_reads(ctx):
            if not any(patterns_intersect(pattern, d) for d in declared):
                yield self.finding(
                    src, lineno,
                    f"config key `{pattern}` is read but never declared in "
                    f"{_CONFIG_BASENAME} (ConfigDef.define)",
                )


@register
class ConfigKeyDocumentedRule(Rule):
    id = "reg-config-key-documented"
    family = "registry"
    rationale = (
        "a key an operator can set must be documented — every key read by "
        "the code has to appear in README.md or docs/*.md"
    )

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        if not ctx.docs:
            return
        corpus = ctx.doc_corpus()
        for src, lineno, pattern in _config_reads(ctx):
            # for f-string reads, require the longest literal fragment
            fragments = [f for f in pattern.split("*") if len(f) >= 4]
            if not fragments:
                continue
            probe = max(fragments, key=len)
            if probe not in corpus:
                yield self.finding(
                    src, lineno,
                    f"config key `{pattern}` is read but appears nowhere in "
                    "README.md/docs — add a row to the relevant key table",
                )


@register
class ConfigKeyReachableRule(Rule):
    id = "reg-config-key-reachable"
    family = "registry"
    rationale = (
        "a native key declared but never read is a dead knob: operators "
        "set it via `main --config` and nothing changes; wire it through a "
        "from_config path or drop it"
    )

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        reads = [p for _, _, p in _config_reads(ctx)]
        for src, lineno, pattern in _declared_keys(ctx):
            if not pattern.startswith(_NATIVE_NAMESPACES):
                continue
            if not any(patterns_intersect(pattern, r) for r in reads):
                yield self.finding(
                    src, lineno,
                    f"native key `{pattern}` is declared but never read "
                    "via a config accessor — unreachable from `main --config`",
                )


# -- sensors and spans ---------------------------------------------------------

_BACKTICK_RE = re.compile(r"`([^`]+)`")
#: docs placeholder spellings that mean "anything here"
_PLACEHOLDER_RE = re.compile(r"<[^<>`]*>|…|\{[^{}`]*\}")
_SENSOR_METHODS = {"meter", "timer", "histogram", "gauge"}


def _doc_name_patterns(ctx: LintContext) -> List[str]:
    """All backtick code spans in the sensor doc (fixtures: every doc), as
    fnmatch patterns. Compound rows like `` `X.cache-hits` / `-misses` `` or
    `` `CircuitBreaker.<name>.open` / `.half_open` `` contribute the joined
    spellings too (previous span's prefix + the continuation)."""
    if "doc_name_patterns" in ctx.cache:
        return ctx.cache["doc_name_patterns"]
    texts = [
        t for rel, t in ctx.docs.items()
        if rel.endswith(_SENSOR_DOC_BASENAME)
    ] or list(ctx.docs.values())
    spans: List[str] = []
    for text in texts:
        spans.extend(_BACKTICK_RE.findall(text))
    names: List[str] = []
    prev = None
    for span in spans:
        span = span.strip()
        if span.startswith(("-", ".")) and prev:
            sep = span[0]
            cut = prev.rfind(sep)
            if cut > 0:
                names.append(prev[:cut] + span)
            names.append(prev + span)
        else:
            names.append(span)
            prev = span
    patterns = []
    for n in names:
        p = _PLACEHOLDER_RE.sub("*", n)
        # a placeholder-only span (`…`) would become `*` and match the
        # world; require some literal substance
        if re.search(r"[A-Za-z0-9_]{2,}", p):
            patterns.append(p)
    ctx.cache["doc_name_patterns"] = patterns
    return patterns


def _sensor_emits(ctx: LintContext):
    """[(src, lineno, method, pattern)] for REGISTRY.<method>("name", ...)."""
    if "sensor_emits" in ctx.cache:
        return ctx.cache["sensor_emits"]
    out = []
    for src in ctx.parsed_files:
        for node in ast.walk(src.tree):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            fn = node.func
            if not (
                isinstance(fn, ast.Attribute)
                and fn.attr in _SENSOR_METHODS
                and isinstance(fn.value, ast.Name)
                and "REGISTRY" in fn.value.id
            ):
                continue
            pattern = literal_or_fstring_pattern(node.args[0])
            if pattern is not None:
                out.append((src, node.lineno, fn.attr, pattern))
    ctx.cache["sensor_emits"] = out
    return out


@register
class SensorDocumentedRule(Rule):
    id = "reg-sensor-documented"
    family = "registry"
    rationale = (
        "every sensor on /metrics must have a row in the "
        "docs/OBSERVABILITY.md inventory — an undocumented sensor is "
        "invisible drift between code and the operator's dashboard"
    )

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        if not ctx.docs:
            return
        doc_patterns = _doc_name_patterns(ctx)
        for src, lineno, method, pattern in _sensor_emits(ctx):
            if not any(patterns_intersect(pattern, d) for d in doc_patterns):
                yield self.finding(
                    src, lineno,
                    f"sensor `{pattern}` ({method}) is emitted but absent "
                    f"from the {_SENSOR_DOC_BASENAME} sensor table",
                )


@register
class SensorCollisionRule(Rule):
    id = "reg-sensor-collision"
    family = "registry"
    rationale = (
        "REGISTRY.snapshot() merges all sensor types into one dict by name; "
        "the same name emitted as two different types silently shadows one "
        "of them on /state and /metrics"
    )

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        by_name: Dict[str, Set[str]] = {}
        sites: Dict[str, List[Tuple]] = {}
        for src, lineno, method, pattern in _sensor_emits(ctx):
            if "*" in pattern:
                continue  # patterns can collide spuriously
            by_name.setdefault(pattern, set()).add(method)
            sites.setdefault(pattern, []).append((src, lineno, method))
        for name, methods in sorted(by_name.items()):
            if len(methods) < 2:
                continue
            for src, lineno, method in sites[name]:
                yield self.finding(
                    src, lineno,
                    f"sensor name `{name}` is registered as {method} here "
                    f"but also as {', '.join(sorted(methods - {method}))} "
                    "elsewhere — one will shadow the other in snapshots",
                )


#: the servlet wiring file and the doc carrying the endpoint inventory
_SERVER_BASENAME = "server.py"
_ENDPOINT_DOC_BASENAME = "ENDPOINTS.md"


def _endpoint_registrations(ctx: LintContext):
    """[(src, lineno, endpoint)] for every endpoint the servlet wires up:
    `("name", self.handler)` tuples in the build_app endpoint lists, plus
    literal route paths on `router.add_get/add_post` (the root scrape
    aliases). Dynamic path segments (`{tail:...}`) and "/" are skipped."""
    if "endpoint_registrations" in ctx.cache:
        return ctx.cache["endpoint_registrations"]
    out = []
    for src in ctx.files_named(_SERVER_BASENAME):
        if src.tree is None:
            continue
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Tuple) and len(node.elts) == 2:
                first, second = node.elts
                if (
                    isinstance(first, ast.Constant)
                    and isinstance(first.value, str)
                    and first.value.isidentifier()
                    and isinstance(second, ast.Attribute)
                    and isinstance(second.value, ast.Name)
                    and second.value.id == "self"
                ):
                    out.append((src, node.lineno, first.value))
            elif isinstance(node, ast.Call):
                fn = node.func
                if (
                    isinstance(fn, ast.Attribute)
                    and fn.attr in ("add_get", "add_post")
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                ):
                    seg = node.args[0].value.rstrip("/").rsplit("/", 1)[-1]
                    if seg and "{" not in seg:
                        out.append((src, node.lineno, seg))
    ctx.cache["endpoint_registrations"] = out
    return out


@register
class EndpointDocumentedRule(Rule):
    id = "reg-endpoint-documented"
    family = "registry"
    rationale = (
        "every REST endpoint the servlet serves must have a row in "
        "docs/ENDPOINTS.md — an undocumented endpoint is API surface "
        "operators cannot discover and clients cannot validate against"
    )

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        if not ctx.docs:
            return
        texts = [
            t for rel, t in ctx.docs.items()
            if rel.endswith(_ENDPOINT_DOC_BASENAME)
        ] or list(ctx.docs.values())
        corpus = "\n".join(texts)
        seen: Set[Tuple[str, str]] = set()
        for src, lineno, name in _endpoint_registrations(ctx):
            if (src.rel, name) in seen:  # root aliases duplicate the row
                continue
            seen.add((src.rel, name))
            if f"`{name}`" not in corpus:
                yield self.finding(
                    src, lineno,
                    f"endpoint `{name}` is registered but has no row in "
                    f"{_ENDPOINT_DOC_BASENAME} — document its parameters "
                    "and response shape",
                )


@register
class SpanKindRule(Rule):
    id = "reg-span-kind"
    family = "registry"
    rationale = (
        "span kinds are the /trace grouping axis and the per-kind latency "
        "table's key; an undocumented kind means dashboards and "
        "docs/OBSERVABILITY.md disagree about the pipeline's stages"
    )

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        if not ctx.docs:
            return
        doc_patterns = _doc_name_patterns(ctx)
        for src in ctx.parsed_files:
            for node in ast.walk(src.tree):
                if not isinstance(node, ast.Call):
                    continue
                fn = node.func
                if not (
                    isinstance(fn, ast.Attribute)
                    and fn.attr in ("span", "record_span")
                    and isinstance(fn.value, ast.Name)
                    and "TRACER" in fn.value.id
                ):
                    continue
                for kw in node.keywords:
                    if kw.arg != "kind":
                        continue
                    kind = literal_or_fstring_pattern(kw.value)
                    if kind is None:
                        continue
                    if not any(patterns_intersect(kind, d) for d in doc_patterns):
                        yield self.finding(
                            src, node.lineno,
                            f"span kind `{kind}` is not in the documented "
                            f"kind inventory ({_SENSOR_DOC_BASENAME})",
                        )
