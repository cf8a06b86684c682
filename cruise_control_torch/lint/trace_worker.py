"""cclint trace-tier worker for the port: the registered kernel entry points
run under a PyTorch dispatch recorder, in a SUBPROCESS so the parent linter
never imports torch.

The token rules see source tokens and ASTs. What they cannot see — a host
read three calls under a round, an argument written in place that its
call site does not declare, a carried tensor whose dtype drifts, a large
tensor held by the entry's closure — shows when the entry really runs.
This worker loads every module that declares a `CCLINT_TRACE_ENTRYPOINTS`
registry (lint/entrypoints.py for the package; trace-rule fixtures declare
their own), builds each entry on the worker's device, and runs it under a
`TorchDispatchMode` recorder; on CUDA also under
`torch.cuda.set_sync_debug_mode("warn")`, whose warnings it captures with
the Python stack at the warning. A CUDA kernel called through its C entry
is invisible to the recorder (it is not an aten op), so every site is
attributed by Python frame: the innermost frame inside the checkout.

Findings are attributed to the LINE of the entry's `name="..."` declaration
in the registry module, so the normal suppression syntax works there:

    dict(name="noisy-entry", build=_b),  # cclint: disable=trace-host-sync -- reason

Protocol: `python -m cruise_control_torch.lint.trace_worker --root R
--device D rel.py...` prints one JSON document: {"version", "findings":
[{rule, path, line, message}], "stats": {...}}. rules_trace.py caches that
document keyed by the content hash of the linted sources, the torch
version, WORKER_SCHEMA and the device. With `--device cuda` and no card it
prints the reason on stderr and exits EXIT_NO_DEVICE.

Entry registry protocol (plain dicts — fixtures need no package imports):

    CCLINT_TRACE_ENTRYPOINTS = [
        dict(name="my-kernel", build=_build),   # one entry per line
    ]

where `build(device)` returns a dict with keys:
    fn                callable
    args              tuple of example arguments (small tensors on `device`,
                      or NamedTuples / tuples / dicts of them)
    mutates_argnums   optional tuple — positions the real call site writes
                      in place (each must be written; no other may be)
    carry             optional ((output index, argument position), ...) — a
                      round entry: it runs twice, each output fed back as
                      its argument, and every carried tensor keeps its
                      dtype, shape and device
    collectives       optional {op: count} — the entry runs on a mesh: its
                      "all-gather" / "all-reduce" counts a call, from
                      DeviceTelemetry.collective_totals(), may not exceed
                      these (an op absent from the dict allows none)

A tensor the entry's callable holds (closure, partial, bound object) may
not exceed CONST_BYTES_LIMIT, the JAX package's constant budget.
"""

from __future__ import annotations

import argparse
import collections
import functools
import hashlib
import importlib.util
import json
import pathlib
import re
import sys
import time
import traceback
import types
import warnings
from typing import Dict, List, Optional, Tuple

#: bump when the check semantics change: the content-hash cache key
#: includes this, so stale cached verdicts cannot survive a worker upgrade
WORKER_SCHEMA = 1

#: exit code of a worker asked for a device this machine does not have
EXIT_NO_DEVICE = 3

CONST_BYTES_LIMIT = 1 << 16

#: aten ops whose output size depends on the data (on CUDA they read the
#: size back to the host); `index.Tensor` counts only with a boolean index
DATA_SHAPE_OPS = frozenset({
    "aten.nonzero.default", "aten.masked_select.default", "aten._unique2.default",
    "aten.unique_dim.default", "aten.unique_consecutive.default",
    "aten.repeat_interleave.Tensor",
})
SCALAR_READ_OP = "aten._local_scalar_dense.default"
#: a tensor built from host data (`torch.tensor`, `torch.as_tensor` of a
#: Python value): on the card an upload that waits for the copy
HOST_DATA_OP = "aten.lift_fresh.default"
#: the kernels that write an argument in place (by design: K4 applies a wave
#: to the Aggregates), as (module, function, position of the written
#: argument); on the card their writes are no aten op, so a call counts
INPLACE_KERNELS = (
    ("cruise_control_torch.kernels.apply_wave", "apply_wave", 1),
    ("cruise_control_torch.kernels.apply_wave", "apply_actions_batch", 1),
)
#: tensor methods that copy to the host: on the CPU they dispatch nothing,
#: so the worker records the calls themselves
HOST_COPY_METHODS = ("cpu", "tolist")
COPY_OPS = frozenset({"aten._to_copy.default", "aten.copy_.default"})
#: the sync-debug mode's warning text (c10/cuda/CUDAFunctions.cpp)
_SYNC_WARNING_RE = re.compile(r"called a synchronizing CUDA operation")

_THIS_FILE = pathlib.Path(__file__).resolve()


def _finding(rule: str, path: str, line: int, message: str) -> Dict:
    return {"rule": rule, "path": path, "line": line, "message": message}


def _entry_line(source_lines: List[str], name: str) -> int:
    """The 1-based line declaring `name="<name>"` — the suppression anchor."""
    pat = re.compile(r"""name\s*=\s*['"]""" + re.escape(name) + r"""['"]""")
    for i, line in enumerate(source_lines, start=1):
        if pat.search(line):
            return i
    return 1


class SiteFinder:
    """Where an op ran: the innermost Python frame inside the checkout (the
    worker's own frames excluded), as `rel/path.py:line`, and whether it ran
    inside a kernel's plain version (a `*_plain` function of a module under
    `cruise_control_torch/kernels/`). On the CPU a wrapper runs its plain
    version only because its tensors are on the CPU; on the card the same
    call is one launch the recorder cannot see into. So what a plain version
    does is the kernel's, and the rules judge only the code around it, the
    same on either device."""

    def __init__(self, root: pathlib.Path):
        self.root = str(root.resolve()) + "/"
        self._rel: Dict[str, Optional[str]] = {}
        self._plain: Dict[object, bool] = {}

    def _relative(self, filename: str) -> Optional[str]:
        hit = self._rel.get(filename, "")
        if hit == "":
            full = str(pathlib.Path(filename).resolve())
            hit = (full[len(self.root):] if full.startswith(self.root)
                   and pathlib.Path(full) != _THIS_FILE else None)
            self._rel[filename] = hit
        return hit

    def _is_plain(self, code) -> bool:
        hit = self._plain.get(code)
        if hit is None:
            rel = self._relative(code.co_filename) or ""
            hit = self._plain[code] = (code.co_name.endswith("_plain")
                                       and rel.startswith("cruise_control_torch/kernels/"))
        return hit

    def site(self) -> Tuple[str, bool]:
        """(site, inside a plain version)."""
        frame, site = sys._getframe(1), None
        while frame is not None:
            if site is None:
                rel = self._relative(frame.f_code.co_filename)
                if rel is not None:
                    site = f"{rel}:{frame.f_lineno}"
            if self._is_plain(frame.f_code):
                return site or "<outside the checkout>", True
            frame = frame.f_back
        return site or "<outside the checkout>", False


def tensor_leaves(tree):
    """The tensors of an argument: a tensor, or NamedTuples / tuples / lists
    / dicts of them (other leaves are skipped)."""
    import torch

    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from tensor_leaves(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from tensor_leaves(x)


def _storage_key(t) -> Optional[int]:
    try:
        storage = t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None
    return storage.data_ptr() if storage.nbytes() else None


def _written_tensors(func, args, kwargs):
    """The tensors an op's schema marks as written (`out=` included)."""
    import torch

    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is None or not a.alias_info.is_write:
            continue
        v = args[i] if i < len(args) else kwargs.get(a.name)
        for t in (v if isinstance(v, (list, tuple)) else [v]):
            if isinstance(t, torch.Tensor):
                yield t


def make_recorder(sites: SiteFinder, arg_storages: Dict[int, int], device):
    """A TorchDispatchMode that records, with their sites: host syncs
    (scalar reads, data-dependent output sizes, device-to-host copies,
    tensors built from host data), writes to the entry's arguments (by
    storage) and float64 outputs. A scalar read or a tensor built from host
    data counts where its tensor is on the run's `device`: on the card a
    host copy's scalar or a CPU constant waits for nothing."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.syncs: collections.Counter = collections.Counter()
            #: what the kernels' plain versions did (reported, not judged)
            self.plain: collections.Counter = collections.Counter()
            self.writes: Dict[int, collections.Counter] = collections.defaultdict(
                collections.Counter)
            self.float64: collections.Counter = collections.Counter()
            self.ops = 0
            self._names: Dict[object, Tuple[str, bool]] = {}

        def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
            kwargs = kwargs or {}
            self.ops += 1
            hit = self._names.get(func)
            if hit is None:
                hit = self._names[func] = (str(func), func._schema.is_mutable)
            name, mutable = hit
            out = func(*args, **kwargs)
            sync = None
            if name in (SCALAR_READ_OP, HOST_DATA_OP) and args[0].device.type != device.type:
                pass
            elif name == SCALAR_READ_OP:
                sync = "scalar read"
            elif name in DATA_SHAPE_OPS:
                sync = name.split(".")[1]
            elif name == "aten.index.Tensor" and any(
                    isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
                    for i in (args[1] if len(args) > 1 else ())):
                sync = "boolean index"
            elif name in COPY_OPS:
                src = args[1] if name == "aten.copy_.default" else args[0]
                dst = args[0] if name == "aten.copy_.default" else out
                if (isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor)
                        and src.device.type != "cpu" and dst.device.type == "cpu"):
                    sync = "device-to-host copy"
            elif name == HOST_DATA_OP:
                sync = "host data"
            if sync is not None:
                self.record(sync)
            if mutable and arg_storages:
                for t in _written_tensors(func, args, kwargs):
                    pos = arg_storages.get(_storage_key(t))
                    if pos is not None:
                        site, plain = sites.site()
                        if not plain:
                            self.writes[pos][(site, name.split(".")[1])] += 1
            for t in (out if isinstance(out, (tuple, list)) else [out]):
                if isinstance(t, torch.Tensor) and t.dtype == torch.float64:
                    site, plain = sites.site()
                    if not plain:
                        self.float64[(site, name.split(".")[1])] += 1
                    break
            return out

        def record(self, what: str) -> None:
            site, plain = sites.site()
            (self.plain if plain else self.syncs)[(site, what)] += 1

    return Recorder()


class SyncWarnings:
    """`torch.cuda.set_sync_debug_mode("warn")` for the block, its warnings
    counted by the site of the Python call that synced (nothing on the CPU)."""

    def __init__(self, sites: SiteFinder, device):
        self.sites = sites
        self.on = device.type == "cuda"
        self.counts: collections.Counter = collections.Counter()

    def __enter__(self):
        if not self.on:
            return self
        import torch

        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.simplefilter("always")

        def show(message, category, filename, lineno, file=None, line=None):
            if _SYNC_WARNING_RE.search(str(message)):
                site, plain = self.sites.site()
                if not plain:
                    self.counts[(site, "sync-debug warning")] += 1

        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        if self.on:
            import torch

            torch.cuda.set_sync_debug_mode("default")
            self._catch.__exit__(*exc)
        return False


class InplaceKernelCalls:
    """For the block, every call of an INPLACE_KERNELS wrapper records the
    entry arguments its written operand shares storage with: the kernel
    writes them, on the card through its C entry, on the CPU through its
    plain version. Each module of the package that imported the wrapper by
    name is patched; its own module is not (the wrapper counts its launches
    on itself, by that name)."""

    def __init__(self, recorder, sites: "SiteFinder", arg_storages: Dict[int, int]):
        self.recorder, self.sites, self.arg_storages = recorder, sites, arg_storages
        self._patched: List[Tuple[object, str, object]] = []

    def __enter__(self):
        import importlib

        for modname, fname, pos in INPLACE_KERNELS:
            orig = getattr(importlib.import_module(modname), fname)
            wrapped = self._wrap(orig, fname, pos)
            for mod in list(sys.modules.values()):
                if getattr(mod, "__name__", "").startswith("cruise_control_torch") and \
                        mod.__name__ != modname and getattr(mod, fname, None) is orig:
                    self._patched.append((mod, fname, orig))
                    setattr(mod, fname, wrapped)
        return self

    def _wrap(self, orig, fname: str, pos: int):
        def call(*args, **kwargs):
            if pos < len(args):
                for t in tensor_leaves(args[pos]):
                    hit = self.arg_storages.get(_storage_key(t))
                    if hit is not None:
                        self.recorder.writes[hit][(self.sites.site()[0], fname)] += 1
            return orig(*args, **kwargs)

        return functools.wraps(orig)(call)

    def __exit__(self, *exc):
        for mod, fname, orig in self._patched:
            setattr(mod, fname, orig)
        self._patched.clear()
        return False


class HostCopyCalls:
    """On the CPU, `.cpu()` and `.tolist()` dispatch nothing: for the block,
    the recorder records the calls themselves as the device-to-host copies
    they are on the card (on the card the dispatcher sees the copy)."""

    def __init__(self, recorder, device):
        self.recorder = recorder
        self.on = device.type == "cpu"

    def __enter__(self):
        if self.on:
            import torch

            self._saved = {m: getattr(torch.Tensor, m) for m in HOST_COPY_METHODS}
            for m, orig in self._saved.items():
                setattr(torch.Tensor, m, self._wrap(orig))
        return self

    def _wrap(self, orig):
        recorder = self.recorder

        @functools.wraps(orig)
        def call(t, *args, **kwargs):
            recorder.record("device-to-host copy")
            return orig(t, *args, **kwargs)

        return call

    def __exit__(self, *exc):
        if self.on:
            import torch

            for m, orig in self._saved.items():
                setattr(torch.Tensor, m, orig)
        return False


def _site_list(counter: collections.Counter) -> str:
    """Every (site, op) of `counter` with its count, the most frequent first."""
    items = sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))
    return "; ".join(f"{site} {op} x{n}" for (site, op), n in items)


def held_tensors(fn, limit_depth: int = 6):
    """The tensors an entry's callable holds: its closure cells (through
    nested functions), `functools.partial` args and keywords, a bound
    method's object state, and what those hold in turn."""
    import torch

    seen = set()
    stack = [(fn, 0)]
    while stack:
        obj, depth = stack.pop()
        if id(obj) in seen or depth > limit_depth:
            continue
        seen.add(id(obj))
        if isinstance(obj, torch.Tensor):
            yield obj
            continue
        if isinstance(obj, (types.ModuleType, type, str, bytes, int, float, bool)) or obj is None:
            continue
        children = []
        if isinstance(obj, functools.partial):
            children = [obj.func, *obj.args, *obj.keywords.values()]
        elif isinstance(obj, types.MethodType):
            children = [obj.__func__, obj.__self__]
        elif isinstance(obj, types.FunctionType):
            children = [c.cell_contents for c in (obj.__closure__ or ())
                        if _cell_filled(c)] + list(obj.__defaults__ or ())
            children += list(vars(obj).values())
        elif isinstance(obj, (list, tuple, set, frozenset)):
            children = list(obj)
        elif isinstance(obj, dict):
            children = list(obj.values())
        elif hasattr(obj, "__dict__"):
            children = list(vars(obj).values())
        stack.extend((c, depth + 1) for c in children)


def _cell_filled(cell) -> bool:
    try:
        cell.cell_contents
    except ValueError:
        return False
    return True


def _leaf_sig(t) -> str:
    return f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}@{t.device.type}"


def check_carry(entry_name: str, args: tuple, out, carry, path: str, line: int,
                run: int) -> List[Dict]:
    """Each carried output keeps the argument's structure and every tensor
    leaf's dtype, shape and device."""
    findings = []
    outs = out if isinstance(out, (tuple, list)) else (out,)
    for oi, ai in carry:
        if oi >= len(outs) or ai >= len(args):
            findings.append(_finding(
                "trace-carry-stability", path, line,
                f"entry `{entry_name}` declares carry ({oi}, {ai}) but returns "
                f"{len(outs)} output(s) for {len(args)} argument(s)"))
            continue
        before = [_leaf_sig(t) for t in tensor_leaves(args[ai])]
        after = [_leaf_sig(t) for t in tensor_leaves(outs[oi])]
        if before != after:
            diff = [f"{b} -> {a}" for b, a in zip(before, after) if a != b]
            if len(before) != len(after):
                diff.append(f"{len(before)} tensors -> {len(after)}")
            findings.append(_finding(
                "trace-carry-stability", path, line,
                f"entry `{entry_name}`: run {run}'s output {oi}, carried into "
                f"argument {ai}, changed: {', '.join(diff[:6])} — a carried "
                "tensor must keep its dtype, shape and device or a captured "
                "round cannot replay"))
    return findings


def analyze_entry(entry: Dict, path: str, line: int, device, sites: SiteFinder
                  ) -> Tuple[List[Dict], Dict]:
    """All checks for one entry. Returns (findings, stats)."""
    import torch

    name = entry["name"]
    subject = entry["build"](device)
    fn = subject["fn"]
    args = tuple(subject.get("args", ()))
    mutates = tuple(subject.get("mutates_argnums", ()))
    carry = tuple(tuple(c) for c in subject.get("carry", ()))
    budget = subject.get("collectives")
    findings: List[Dict] = []
    stats = {"name": name, "runS": 0.0}

    held, seen_storage = [], set()
    for t in held_tensors(fn):
        key = _storage_key(t)
        if key is not None and key not in seen_storage:
            seen_storage.add(key)
            nbytes = t.untyped_storage().nbytes()
            if nbytes > CONST_BYTES_LIMIT:
                held.append(f"{_leaf_sig(t)} ({nbytes} bytes)")
    if held:
        findings.append(_finding(
            "trace-constant-bloat", path, line,
            f"entry `{name}` holds {len(held)} tensor(s) over {CONST_BYTES_LIMIT} bytes "
            f"in its closure: {', '.join(held)} — a held tensor pins device "
            "memory and is baked into any captured graph; pass it as an "
            "argument"))

    for i in mutates:
        if i >= len(args):
            findings.append(_finding(
                "trace-mutation-integrity", path, line,
                f"entry `{name}` declares mutates_argnums position {i} but has "
                f"{len(args)} argument(s)"))
    arg_storages: Dict[int, int] = {}
    before: Dict[int, list] = {}
    for pos, a in enumerate(args):
        leaves = list(tensor_leaves(a))
        before[pos] = [t.clone() for t in leaves]
        for t in leaves:
            key = _storage_key(t)
            if key is not None:
                arg_storages.setdefault(key, pos)

    recorder = make_recorder(sites, arg_storages, device)
    warns = SyncWarnings(sites, device)
    copies = HostCopyCalls(recorder, device)
    writers = InplaceKernelCalls(recorder, sites, arg_storages)
    # the kernels' launch counters and the mesh's collectives, where the
    # entry's build brought them in (fixtures need neither)
    kernels = sys.modules.get("cruise_control_torch.kernels")
    if kernels is not None:
        kernels.reset_launches()
    if budget is not None:
        from cruise_control_torch.common.telemetry import TELEMETRY

        gathers0 = TELEMETRY.collective_totals()["byOp"]
    runs = 2 if carry else 1
    t0 = time.monotonic()
    run_args = args
    with warns, copies, writers, recorder:
        out = fn(*run_args)
    changed = {pos for pos, a in enumerate(args)
               if any(not torch.equal(x, y) for x, y in zip(before[pos], tensor_leaves(a)))}
    if carry:
        findings.extend(check_carry(name, run_args, out, carry, path, line, 1))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        nxt = list(run_args)
        for oi, ai in carry:
            if oi < len(outs) and ai < len(nxt):
                nxt[ai] = outs[oi]
        run_args = tuple(nxt)
        with warns, copies, writers, recorder:
            out = fn(*run_args)
        findings.extend(check_carry(name, run_args, out, carry, path, line, 2))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stats["runS"] = round(time.monotonic() - t0, 3)

    syncs = recorder.syncs + warns.counts
    stats.update(ops=recorder.ops, runs=runs, recorderSyncs=sum(recorder.syncs.values()),
                 syncDebugWarnings=sum(warns.counts.values()),
                 plainVersionSyncs=sum(recorder.plain.values()),
                 launches={k: n for k, n in kernels.launches().items() if n} if kernels else {},
                 syncSites=[[site, op, n] for (site, op), n in sorted(
                     syncs.items(), key=lambda kv: (-kv[1], kv[0]))])
    if syncs:
        findings.append(_finding(
            "trace-host-sync", path, line,
            f"entry `{name}` syncs with the host {sum(syncs.values())} time(s) in "
            f"{runs} run(s) at {len(syncs)} site(s): {_site_list(syncs)}"))

    for pos in mutates:
        if pos < len(args) and pos not in recorder.writes and pos not in changed:
            findings.append(_finding(
                "trace-mutation-integrity", path, line,
                f"entry `{name}` declares argument {pos} written in place, but no "
                "op wrote its storage and its values did not change — drop it "
                "from mutates_argnums"))
    for pos in sorted(set(recorder.writes) | changed):
        if pos in mutates:
            continue
        where = _site_list(recorder.writes.get(pos, collections.Counter())) or \
            "its values changed (a kernel's C entry wrote it)"
        findings.append(_finding(
            "trace-mutation-integrity", path, line,
            f"entry `{name}` writes argument {pos} in place, which its call site "
            f"does not declare: {where} — declare it in mutates_argnums, or "
            "write a copy (a tensor of the shared static context is never to "
            "be written)"))

    if recorder.float64:
        findings.append(_finding(
            "trace-carry-stability", path, line,
            f"entry `{name}` computes float64 at {len(recorder.float64)} site(s): "
            f"{_site_list(recorder.float64)} — the reference runs in float32 "
            "(JAX without x64)"))

    if budget is not None:
        after = TELEMETRY.collective_totals()["byOp"]
        counts = {op: (after.get(op, {}).get("count", 0)
                       - gathers0.get(op, {}).get("count", 0)) / runs
                  for op in set(after) | set(gathers0) | set(budget)}
        stats["collectivesPerCall"] = counts
        over = {op: n for op, n in counts.items() if n > budget.get(op, 0)}
        if over:
            findings.append(_finding(
                "trace-sharding-collectives", path, line,
                f"entry `{name}` makes {', '.join(f'{n:g} {op}' for op, n in sorted(over.items()))}"
                f" a call on its mesh (budget {budget or 'none'}) — a collective "
                "past the budget moves a sharded axis whole"))
    return findings, stats


def sync_census(fn, root: pathlib.Path, device):
    """Run `fn()` once under the recorder and, on the card, the sync-debug
    mode, as the worker runs an entry: (its result, {"recorder": Counter,
    "syncDebug": Counter, "plain": Counter, "ops": int}), each Counter keyed
    by (site, what). chip_smoke's census of the main path reads it."""
    sites = SiteFinder(root)
    recorder = make_recorder(sites, {}, device)
    warns = SyncWarnings(sites, device)
    with warns, HostCopyCalls(recorder, device), recorder:
        out = fn()
    return out, {"recorder": recorder.syncs, "syncDebug": warns.counts,
                 "plain": recorder.plain, "ops": recorder.ops}


def load_entry_modules(root: pathlib.Path, rels: List[str]):
    """Import each registry module by file path; yield (rel, module_or_error)."""
    for rel in rels:
        full = root / rel
        modname = "cclint_torch_trace_" + hashlib.sha1(rel.encode()).hexdigest()[:10]
        try:
            spec = importlib.util.spec_from_file_location(modname, full)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[modname] = mod  # entries may self-reference on import
            spec.loader.exec_module(mod)
            yield rel, mod, None
        except Exception as e:  # the import failure is the finding
            yield rel, None, f"{type(e).__name__}: {str(e)[:300]}"


def run(root: pathlib.Path, rels: List[str], device) -> Dict:
    t_start = time.monotonic()
    sites = SiteFinder(root)
    findings: List[Dict] = []
    entry_stats: List[Dict] = []
    for rel, mod, err in load_entry_modules(root, rels):
        if err is not None:
            findings.append(_finding(
                "trace-entry-error", rel, 1,
                f"entry-point module failed to import: {err}",
            ))
            continue
        entries = getattr(mod, "CCLINT_TRACE_ENTRYPOINTS", None)
        if not isinstance(entries, (list, tuple)):
            findings.append(_finding(
                "trace-entry-error", rel, 1,
                "CCLINT_TRACE_ENTRYPOINTS must be a list of "
                "dict(name=..., build=...) entries",
            ))
            continue
        lines = (root / rel).read_text().splitlines()
        for entry in entries:
            name = entry.get("name") if isinstance(entry, dict) else None
            if not name or not callable(entry.get("build")):
                findings.append(_finding(
                    "trace-entry-error", rel, 1,
                    f"malformed registry entry {entry!r}: needs a `name` "
                    "string and a callable `build`",
                ))
                continue
            line = _entry_line(lines, name)
            try:
                fs, st = analyze_entry(entry, rel, line, device, sites)
            except Exception as e:  # an entry that cannot run is the finding
                tb = traceback.extract_tb(e.__traceback__)
                where = f" at {tb[-1].filename.rsplit('/', 1)[-1]}:{tb[-1].lineno}" if tb else ""
                fs = [_finding(
                    "trace-entry-error", rel, line,
                    f"entry `{name}` failed to build or run{where}: "
                    f"{type(e).__name__}: {str(e)[:300]}",
                )]
                st = {"name": name, "runS": 0.0}
            findings.extend(fs)
            entry_stats.append(st)
    return {
        "version": WORKER_SCHEMA,
        "findings": findings,
        "stats": {
            "modules": len(rels),
            "entryPoints": len(entry_stats),
            "device": str(device),
            "entries": entry_stats,
            "wallS": round(time.monotonic() - t_start, 3),
        },
    }


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="cclint-torch-trace-worker")
    parser.add_argument("--root", type=pathlib.Path, required=True)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("rels", nargs="+")
    args = parser.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA card: torch.cuda.is_available() is false, so the trace "
                  "tier cannot run the entry points on cuda:0 (pass --device cpu "
                  "to run them on the CPU)", file=sys.stderr)
            return EXIT_NO_DEVICE
        device = torch.device("cuda", torch.cuda.current_device())
        from cruise_control_torch.kernels import build

        build.build_all()  # one nvcc a source, in parallel, before any entry
    else:
        device = torch.device("cpu")
    doc = run(args.root.resolve(), list(args.rels), device)
    json.dump(doc, sys.stdout)
    sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
