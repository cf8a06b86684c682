"""Concurrency and resilience rules (family `conc`), the JAX package's,
with the same ids and checks, over the port's sources.

The never-raise executor contract (docs/RESILIENCE.md) rests on
mechanical properties every unattended loop in this package must hold:
errors keep their class (no bare `except:`), every loop bounds itself
(deadline or poll cap), state shared across threads is touched only under
its lock, nothing sleeps while holding a lock, and background threads never
pin the interpreter at shutdown. The first two generalize the original
tests/test_static_guards.py checks from four directories to the whole
package; the lock-discipline rule turns the `#: guarded_by(_lock)`
annotation (tracer ring, sensor registry, executor tracker, breaker state)
into an enforced contract.

Lock-discipline conventions:
  * annotate the owning assignment:  `self._ring = ...  #: guarded_by(_lock)`
    (or put the comment on its own line directly above);
  * methods named `__init__` or ending in `_locked` are exempt (construction
    is single-threaded; `*_locked` helpers document that the caller holds
    the lock);
  * a nested def/lambda does NOT inherit an enclosing `with self._lock` —
    it runs later, when the lock may be free.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Set, Tuple

from cruise_control_torch.lint.core import (
    Finding,
    LintContext,
    Rule,
    register,
)

_GUARD_RE = re.compile(r"#:\s*guarded_by\((\w+)\)")
#: the annotated owner: `self.X = ...` in a method, or a class-level
#: (dataclass-style) field declaration `X: T = ...`
_SELF_ATTR_RE = re.compile(r"self\.(\w+)\s*(?::[^=]+)?=[^=]")
_CLASS_FIELD_RE = re.compile(r"^\s*(\w+)\s*:[^=]+(?:=|$)")


@register
class BareExceptRule(Rule):
    id = "conc-bare-except"
    family = "concurrency"
    rationale = (
        "bare `except:` swallows KeyboardInterrupt/SystemExit and erases the "
        "error class the retry layer's retryable classification needs"
    )

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        for src in ctx.parsed_files:
            for node in ast.walk(src.tree):
                if isinstance(node, ast.ExceptHandler) and node.type is None:
                    yield self.finding(
                        src, node.lineno,
                        "bare `except:` — catch `Exception` (or narrower) so "
                        "interrupts propagate and the error class survives",
                    )


def _has_escape(loop: ast.While) -> bool:
    """A break/return lexically inside the loop body that can exit THIS loop
    (not one bound to a nested loop or belonging to a nested function)."""

    def walk(nodes, inside_nested_loop):
        for node in nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue  # its returns/breaks don't exit our loop
            if isinstance(node, ast.Return):
                return True
            if isinstance(node, ast.Break) and not inside_nested_loop:
                return True
            nested = inside_nested_loop or isinstance(node, (ast.While, ast.For))
            if walk(ast.iter_child_nodes(node), nested):
                return True
        return False

    return walk(loop.body, False)


@register
class UnboundedLoopRule(Rule):
    id = "conc-unbounded-loop"
    family = "concurrency"
    rationale = (
        "`while True` with no reachable break/return is an unbounded loop "
        "with no deadline or poll cap — the exact shape of a wedged "
        "controller (docs/RESILIENCE.md requires every poll loop to bound "
        "itself)"
    )

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        for src in ctx.parsed_files:
            for node in ast.walk(src.tree):
                if not isinstance(node, ast.While):
                    continue
                test = node.test
                if (
                    isinstance(test, ast.Constant)
                    and test.value is True
                    and not _has_escape(node)
                ):
                    yield self.finding(
                        src, node.lineno,
                        "`while True` without break/return — add a deadline "
                        "or poll cap (resilience contract)",
                    )


def _with_lock_names(node: ast.With) -> Set[str]:
    """Lock attribute names entered by `with self.<name>[, ...]`."""
    out = set()
    for item in node.items:
        e = item.context_expr
        if (
            isinstance(e, ast.Attribute)
            and isinstance(e.value, ast.Name)
            and e.value.id == "self"
        ):
            out.add(e.attr)
    return out


def _guarded_attrs(src, cls: ast.ClassDef) -> Dict[str, str]:
    """attr -> lock name, from `#: guarded_by(<lock>)` annotations in the
    class's source range (same line as the `self.X = ...`, or the line
    directly above it)."""
    end = getattr(cls, "end_lineno", None) or len(src.lines)
    out: Dict[str, str] = {}
    for i in range(cls.lineno, min(end, len(src.lines)) + 1):
        comment = src.comments.get(i)
        if comment is None:
            continue
        m = _GUARD_RE.search(comment)
        if m is None:
            continue
        line = src.lines[i - 1]
        lock = m.group(1)
        target = _SELF_ATTR_RE.search(line) or _CLASS_FIELD_RE.match(
            line.split("#")[0]
        )
        if target is None and i < len(src.lines):  # standalone: next line
            nxt = src.lines[i]
            target = _SELF_ATTR_RE.search(nxt) or _CLASS_FIELD_RE.match(
                nxt.split("#")[0]
            )
        if target is not None:
            out[target.group(1)] = lock
    return out


@register
class GuardedByRule(Rule):
    id = "conc-guarded-by"
    family = "concurrency"
    rationale = (
        "attributes annotated `#: guarded_by(<lock>)` may only be touched "
        "inside `with self.<lock>` (or from __init__ / *_locked helpers) — "
        "the tracer ring, sensor registry, executor tracker, and breaker "
        "state are all read by server threads while loops mutate them"
    )

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        for src in ctx.parsed_files:
            for node in ast.walk(src.tree):
                if isinstance(node, ast.ClassDef):
                    guarded = _guarded_attrs(src, node)
                    if guarded:
                        yield from self._check_class(src, node, guarded)

    def _check_class(self, src, cls, guarded) -> Iterator[Finding]:
        for stmt in cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if stmt.name == "__init__" or stmt.name.endswith("_locked"):
                    continue
                yield from self._visit(src, stmt.body, guarded, held=set())

    def _visit(self, src, nodes, guarded, held) -> Iterator[Finding]:
        for node in nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                # a nested callable runs later: the enclosing lock is NOT held
                body = node.body if isinstance(node.body, list) else [node.body]
                yield from self._visit(src, body, guarded, held=set())
                continue
            if isinstance(node, ast.With):
                now_held = held | _with_lock_names(node)
                for item in node.items:
                    yield from self._visit(
                        src, [item.context_expr], guarded, held
                    )
                yield from self._visit(src, node.body, guarded, now_held)
                continue
            if (
                isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
                and node.attr in guarded
                and guarded[node.attr] not in held
            ):
                yield self.finding(
                    src, node.lineno,
                    f"`self.{node.attr}` is `#: guarded_by({guarded[node.attr]})` "
                    f"but accessed outside `with self.{guarded[node.attr]}` — "
                    "take the lock, or rename the helper `*_locked`",
                )
            yield from self._visit(src, ast.iter_child_nodes(node), guarded, held)


@register
class SleepUnderLockRule(Rule):
    id = "conc-sleep-under-lock"
    family = "concurrency"
    rationale = (
        "sleeping while holding a lock serializes every other thread behind "
        "the sleeper — poll pauses belong outside critical sections"
    )

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        for src in ctx.parsed_files:
            yield from self._visit(src, [src.tree], held=False)

    def _visit(self, src, nodes, held) -> Iterator[Finding]:
        for node in nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                body = node.body if isinstance(node.body, list) else [node.body]
                yield from self._visit(src, body, held=False)
                continue
            if isinstance(node, ast.With):
                lockish = any(
                    "lock" in name.lower() for name in _with_lock_names(node)
                )
                yield from self._visit(src, node.body, held or lockish)
                continue
            if isinstance(node, ast.Call):
                fn = node.func
                is_sleep = (
                    isinstance(fn, ast.Attribute) and fn.attr == "sleep"
                ) or (isinstance(fn, ast.Name) and fn.id == "sleep")
                if is_sleep and held:
                    yield self.finding(
                        src, node.lineno,
                        "sleep while holding a lock — release the lock "
                        "around the pause",
                    )
            yield from self._visit(src, ast.iter_child_nodes(node), held)


@register
class DaemonThreadRule(Rule):
    id = "conc-daemon-thread"
    family = "concurrency"
    rationale = (
        "a non-daemon background thread pins the interpreter at shutdown; "
        "every loop thread must be `daemon=True` (or set `.daemon = True` "
        "before start) so operators can stop the service"
    )

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        for src in ctx.parsed_files:
            for scope in ast.walk(src.tree):
                if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module)):
                    yield from self._check_scope(src, scope)

    def _check_scope(self, src, scope) -> Iterator[Finding]:
        def own(nodes):  # this scope's nodes, nested defs excluded
            for node in nodes:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                    continue  # handled by its own _check_scope call
                yield node
                yield from own(ast.iter_child_nodes(node))

        # `x.daemon = True` anywhere in the scope clears the whole scope:
        # the common pattern constructs then flips the flag on the next line
        for n in own(scope.body):
            if (
                isinstance(n, ast.Assign)
                and any(
                    isinstance(t, ast.Attribute) and t.attr == "daemon"
                    for t in n.targets
                )
                and isinstance(n.value, ast.Constant)
                and n.value.value is True
            ):
                return
        for n in own(scope.body):
            if not isinstance(n, ast.Call):
                continue
            fn = n.func
            if not (
                isinstance(fn, ast.Attribute)
                and fn.attr in ("Thread", "Timer")
                and isinstance(fn.value, ast.Name)
                and fn.value.id == "threading"
            ):
                continue
            daemon_kw = any(
                kw.arg == "daemon"
                and isinstance(kw.value, ast.Constant)
                and kw.value.value is True
                for kw in n.keywords
            )
            if not daemon_kw:
                yield self.finding(
                    src, n.lineno,
                    f"threading.{fn.attr} without daemon=True — a "
                    "non-daemon background thread blocks shutdown",
                )
