"""PyTorch/CUDA hygiene rules (family `cuda`), the counterpart of the JAX
package's `tpu` family.

The port runs each round as host code that launches hand kernels and
PyTorch ops on the card. The next step on its wall time is capturing the
rounds as CUDA graphs, which holds only while round code (a) never syncs
the card back to the host mid-round, (b) never launches once per element
of a model axis, (c) never picks a launch sequence by a concrete size,
(d) never reads a local alias of a tensor that a later call in the same
scope wrote in place as if it still held the old value, and (e) never
denominates a mean by a padded axis length where a valid-count mask
exists.

Scope: "kernel modules" — core.KERNEL_PATH_PATTERNS (the JAX package's
three patterns, the round engines, the SPMD kernels and the kernel
wrappers) plus any module carrying a `# cclint: kernel-module` marker. The
stale-alias rule runs package-wide: the in-place writers are called from
the optimizer and the lane too.

JAX id -> port id:

  ======================== ============================================
  JAX package (`tpu`)      port (`cuda`)
  ======================== ============================================
  tpu-host-sync            cuda-host-sync
  tpu-python-loop          cuda-python-loop
  tpu-shape-branch         cuda-shape-branch
  tpu-donated-reuse        cuda-stale-alias (PyTorch has no donation)
  tpu-padding-denominator  cuda-padding-denominator
  ======================== ============================================
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from cruise_control_torch.lint.core import (
    Finding,
    LintContext,
    Rule,
    node_names,
    register,
)

#: identifiers that name a partition/broker/topic axis extent; looping or
#: dividing by one of these inside a kernel is a launch-per-element or
#: padding hazard (the JAX package's AXIS_NAMES)
AXIS_NAMES = {
    "num_partitions", "num_brokers", "num_topics", "num_racks", "num_hosts",
    "p_count", "b_count", "t_count", "max_rf",
}

#: tensor methods that copy the tensor to the host
_HOST_COPY_METHODS = {"item", "cpu", "tolist", "numpy"}
#: ops whose output size depends on the data: on CUDA they read the size back
_DATA_SHAPE_OPS = {"nonzero", "argwhere", "masked_select", "unique", "unique_consecutive"}
#: names that make a cast's argument a size, not a tensor's value
_SIZE_NAMES = {"shape", "numel", "dim", "ndim", "len", "size"}
#: calls that write their tensor arguments in place
_INPLACE_FUNCTIONS = {"apply_wave", "apply_actions_batch", "delta_scatter"}
#: tensor methods that write their receiver in place
_INPLACE_METHODS = {
    "index_add_", "index_copy_", "index_put_", "copy_", "scatter_", "scatter_add_",
    "scatter_reduce_", "masked_fill_", "masked_scatter_", "fill_", "zero_",
}
#: attributes that read a tensor's metadata, not its values
_META_ATTRS = {"device", "dtype", "shape", "ndim", "is_cuda", "dim", "size", "numel",
               "get_device", "stride", "is_contiguous"}
_LITERALS = (ast.Constant, ast.List, ast.Tuple, ast.Dict, ast.Set, ast.ListComp,
             ast.GeneratorExp)


def _is_numpy(node: ast.AST) -> bool:
    return isinstance(node, ast.Name) and node.id in ("np", "numpy")


@register
class HostSyncRule(Rule):
    id = "cuda-host-sync"
    family = "cuda"
    rationale = (
        "`.item()`, `.cpu()`, `.tolist()`, `.numpy()`, `np.asarray` of a "
        "tensor, `int()/float()/bool()` of a computed value, "
        "`torch.cuda.synchronize` and data-dependent-shape ops "
        "(`nonzero`, `masked_select`, `unique`) wait for the card; inside a "
        "round they stall the launch queue and break CUDA-graph capture"
    )

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        for src in ctx.kernel_files:
            for node in ast.walk(src.tree):
                if isinstance(node, ast.Call):
                    msg = self._message(node)
                    if msg is not None:
                        yield self.finding(src, node.lineno, msg)

    @staticmethod
    def _message(node: ast.Call) -> Optional[str]:
        fn = node.func
        if isinstance(fn, ast.Attribute):
            if fn.attr in _HOST_COPY_METHODS and not node.args and not node.keywords:
                return (f"`.{fn.attr}()` copies a tensor to the host and waits for "
                        "the card; keep the value on the device or move this "
                        "off the round path")
            if fn.attr in ("asarray", "array") and _is_numpy(fn.value) and node.args \
                    and not isinstance(node.args[0], _LITERALS):
                return (f"`np.{fn.attr}` of a tensor copies it to the host; keep "
                        "it a tensor or hoist to the host-side shell")
            if fn.attr == "synchronize" and "cuda" in node_names(fn.value):
                return "`torch.cuda.synchronize` waits for the card; rounds must stay async"
            if fn.attr in _DATA_SHAPE_OPS:
                return (f"`{fn.attr}` has a data-dependent output size: on CUDA it "
                        "reads the size back to the host; use a mask or a "
                        "fixed-size top-k")
            if fn.attr == "where" and len(node.args) == 1 and not node.keywords:
                return ("one-argument `where` is `nonzero`: a data-dependent "
                        "output size read back to the host")
        elif (
            isinstance(fn, ast.Name)
            and fn.id in ("float", "int", "bool")
            and node.args
            and not isinstance(node.args[0], (ast.Name, ast.Constant))
            and not (_SIZE_NAMES & node_names(node.args[0]))
            and node_names(node.args[0])  # a constant expression is no tensor
        ):
            return (f"`{fn.id}(...)` of a computed value waits for the card if it "
                    "is a tensor; keep the decision on the device or hoist it")
        return None


@register
class PythonLoopRule(Rule):
    id = "cuda-python-loop"
    family = "cuda"
    rationale = (
        "a Python `for` over a partition/broker axis launches once per "
        "element; vectorize it into one launch"
    )

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        for src in ctx.kernel_files:
            for node in ast.walk(src.tree):
                iters = []
                if isinstance(node, ast.For):
                    iters.append(node.iter)
                elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                       ast.GeneratorExp)):
                    iters.extend(g.iter for g in node.generators)
                for it in iters:
                    names = node_names(it)
                    hits = (AXIS_NAMES & names) | ({"shape"} & names)
                    if hits:
                        yield self.finding(
                            src, node.lineno,
                            f"Python loop over a model axis ({', '.join(sorted(hits))}); "
                            "one launch per element — vectorize or move off the "
                            "round path",
                        )
                        break


def _tests_a_size(test: ast.AST) -> bool:
    """Whether a branch condition reads a concrete size: `.shape`, a
    `.numel()`/`.size()` call, or `len()` of a field or element."""
    for n in ast.walk(test):
        if isinstance(n, ast.Attribute) and n.attr == "shape":
            return True
        if isinstance(n, ast.Call):
            f = n.func
            if isinstance(f, ast.Attribute) and f.attr in ("numel", "size"):
                return True
            if (isinstance(f, ast.Name) and f.id == "len" and n.args
                    and isinstance(n.args[0], (ast.Attribute, ast.Subscript))):
                return True
    return False


def _only_raises(body) -> bool:
    return bool(body) and all(isinstance(s, ast.Raise) for s in body)


@register
class ShapeBranchRule(Rule):
    id = "cuda-shape-branch"
    family = "cuda"
    rationale = (
        "branching on `.shape`, `.numel()` or `len(tensor)` lets a concrete "
        "size pick a different launch sequence, which a captured CUDA graph "
        "cannot follow; thread the size through Dims or branch with "
        "torch.where (a guard that only raises picks nothing)"
    )

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        for src in ctx.kernel_files:
            for node in ast.walk(src.tree):
                if not isinstance(node, (ast.If, ast.IfExp, ast.While)):
                    continue
                if isinstance(node, ast.If) and not node.orelse and _only_raises(node.body):
                    continue
                if _tests_a_size(node.test):
                    yield self.finding(
                        src, node.lineno,
                        "branch tests a concrete tensor size — each size picks its "
                        "own launch sequence; thread the dim through Dims instead",
                    )


def _root_name(node: ast.AST) -> Optional[str]:
    """`agg` of `agg`, `agg.broker_load`, `agg.broker_load[0]`."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _written_roots(call: ast.Call):
    """The root names a call writes in place."""
    fn = call.func
    if isinstance(fn, ast.Name) and fn.id in _INPLACE_FUNCTIONS:
        for a in list(call.args) + [k.value for k in call.keywords]:
            root = _root_name(a)
            if root is not None:
                yield root
    elif isinstance(fn, ast.Attribute) and fn.attr in _INPLACE_METHODS:
        root = _root_name(fn.value)
        if root is not None:
            yield root
    for kw in call.keywords:
        if kw.arg == "out":
            for e in (kw.value.elts if isinstance(kw.value, ast.Tuple) else [kw.value]):
                root = _root_name(e)
                if root is not None:
                    yield root


@register
class StaleAliasRule(Rule):
    id = "cuda-stale-alias"
    family = "cuda"
    rationale = (
        "a local bound to an argument or one of its fields before a call "
        "that writes that argument in place (apply_wave, "
        "apply_actions_batch, delta_scatter, index_add_/copy_/scatter_, "
        "out=) holds the NEW values afterwards; reading it as the old state "
        "is the in-place counterpart of reading a donated buffer"
    )

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        for src in ctx.parsed_files:
            for scope in ast.walk(src.tree):
                if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield from self._check_scope(src, scope)

    def _check_scope(self, src, fn) -> Iterator[Finding]:
        params = {a.arg for a in fn.args.args + fn.args.kwonlyargs + fn.args.posonlyargs}
        # pass 1: aliases of a parameter or its fields (alias -> parameter)
        aliases, binds = {}, set()
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            pairs = []
            for t in node.targets:
                if isinstance(t, ast.Tuple) and isinstance(node.value, ast.Tuple) \
                        and len(t.elts) == len(node.value.elts):
                    pairs.extend(zip(t.elts, node.value.elts))
                else:
                    pairs.append((t, node.value))
            for tgt, val in pairs:
                # the argument itself or one of its fields
                if isinstance(tgt, ast.Name) and (
                        isinstance(val, ast.Name) or (isinstance(val, ast.Attribute)
                                                      and isinstance(val.value, ast.Name))):
                    root = _root_name(val)
                    if root in params and tgt.id != root:
                        aliases[tgt.id] = root
                        binds.add((tgt.lineno, tgt.id))
        if not aliases:
            return
        # pass 2: lexical events, as the JAX package's donated-reuse rule
        # orders them (loads on a line before its call writes, stores after)
        prio = {"load": 0, "write": 1, "store": 2}
        meta = {id(n.value) for n in ast.walk(fn)
                if isinstance(n, ast.Attribute) and n.attr in _META_ATTRS}
        events = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                for root in _written_roots(node):
                    events.append((node.lineno, prio["write"], "write", root))
            elif isinstance(node, ast.Name) and node.id in aliases and id(node) not in meta:
                kind = "store" if isinstance(node.ctx, (ast.Store, ast.Del)) else "load"
                events.append((node.lineno, prio[kind], kind, node.id))
        events.sort(key=lambda e: (e[0], e[1]))
        live, written_at = set(), {}
        for lineno, _, kind, name in events:
            if kind == "store":
                # an alias binding makes the name live; any other store ends it
                (live.add if (lineno, name) in binds else live.discard)(name)
                written_at.pop(name, None)
            elif kind == "write":
                for alias, root in aliases.items():
                    if root == name and alias in live:
                        written_at.setdefault(alias, lineno)
            elif name in written_at and lineno > written_at[name]:
                yield self.finding(
                    src, lineno,
                    f"`{name}` aliases `{aliases[name]}`, which a call on line "
                    f"{written_at[name]} wrote in place — it now holds the new "
                    "values; clone it before the call or re-read the field",
                )
                written_at.pop(name)  # one report per write


@register
class PaddingDenominatorRule(Rule):
    id = "cuda-padding-denominator"
    family = "cuda"
    rationale = (
        "dividing by a raw axis extent (num_partitions/num_brokers) makes "
        "means drift with the shape bucket's padding; denominate by the "
        "valid-count masks (StaticCtx.num_valid_partitions, broker_valid "
        "sums) so bucketed runs stay result-identical"
    )

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        for src in ctx.kernel_files:
            for scope in ast.walk(src.tree):
                if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield from self._check_fn(src, scope)

    def _check_fn(self, src, fn) -> Iterator[Finding]:
        aliases = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Attribute):
                if node.value.attr in AXIS_NAMES:
                    aliases.update(t.id for t in node.targets if isinstance(t, ast.Name))
            # tuple unpack: p_count, r = dims.num_partitions, dims.max_rf
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Tuple):
                for t in node.targets:
                    if isinstance(t, ast.Tuple) and len(t.elts) == len(node.value.elts):
                        for tgt, val in zip(t.elts, node.value.elts):
                            if (
                                isinstance(tgt, ast.Name)
                                and isinstance(val, ast.Attribute)
                                and val.attr in AXIS_NAMES
                            ):
                                aliases.add(tgt.id)
        for node in ast.walk(fn):
            if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.Div, ast.FloorDiv)):
                d = node.right
                hit = None
                if isinstance(d, ast.Attribute) and d.attr in AXIS_NAMES:
                    hit = d.attr
                elif isinstance(d, ast.Name) and (d.id in AXIS_NAMES or d.id in aliases):
                    hit = d.id
                if hit is not None:
                    yield self.finding(
                        src, node.lineno,
                        f"division by raw axis extent `{hit}` — under shape "
                        "bucketing this denominator includes padding; use the "
                        "num_valid_* masks",
                    )
