"""K3's and K9's score context and K3's path chooser, on the CPU.

The context packs the round's tensors into a C struct laid out as `struct
ScoreCtx` (csrc/score_goal.cuh); the kernel reads it by address, so its
field order is checked against the header. K3's launch path (factored,
promotion, general) is chosen on the host from the index tensors' strides:
each call site of the rounds must get the path its layout was designed for.
A context called with other inputs than it was built from is rebuilt, never
launched on stale addresses. And the CPU wrapper, context passed, still
equals jitted JAX on every path's layout.
"""

from __future__ import annotations

import ctypes
import dataclasses
import pathlib
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import acceptance as jacc
from cruise_control_tpu.analyzer import actions as jact
from cruise_control_tpu.analyzer import context as jctx
from cruise_control_tpu.analyzer.goals import goals_by_priority as jgoals
from cruise_control_tpu.config.balancing import BalancingConstraint as JConstraint
from cruise_control_tpu.models import generators as jgen
from cruise_control_tpu.models.flat_model import FlatClusterModel as JModel
from cruise_control_torch.analyzer import acceptance as tacc
from cruise_control_torch.analyzer import bulk, drain
from cruise_control_torch.analyzer import context as tctx
from cruise_control_torch.analyzer import optimizer as opt
from cruise_control_torch.analyzer.actions import (
    KIND_LEADERSHIP,
    KIND_MOVE,
    leadership_grid,
    make_move_batch,
)
from cruise_control_torch.analyzer.goals import goals_by_priority as tgoals
from cruise_control_torch.config.balancing import BalancingConstraint as TConstraint
from cruise_control_torch.kernels import score_candidates as k3
from cruise_control_torch.models import generators
from cruise_control_torch.models.flat_model import from_numpy

ROOT = pathlib.Path(__file__).resolve().parent.parent
HEADER = ROOT / "cruise_control_torch" / "csrc" / "score_goal.cuh"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors and several worker processes: one intra-op thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def struct_fields(text: str, name: str):
    """[(field, is_pointer)] of `struct name` in C source `text`."""
    text = re.sub(r"//[^\n]*", "", text)
    body = re.search(r"struct\s+%s\s*\{(.*?)\};" % name, text, re.S).group(1)
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        m = re.match(r"((?:const\s+)?(?:unsigned\s+)?\w+)\s*(.*)$", decl, re.S)
        for token in m.group(2).split(","):
            fields.append((token.replace("*", "").strip(), "*" in token))
    return fields


def test_the_packed_struct_follows_the_header():
    fields = struct_fields(HEADER.read_text(), "ScoreCtx")
    assert [f for f, _ in fields] == list(k3.CTX_POINTERS + k3.CTX_INTS)
    assert [f for f, ptr in fields if ptr] == list(k3.CTX_POINTERS)
    names = [n for n, _ in k3.ScoreCtxStruct._fields_]
    assert names == [f for f, _ in fields]
    # the C layout: 8-byte pointers, then 4-byte ints, no padding between
    assert ctypes.sizeof(k3.ScoreCtxStruct) == 8 * len(k3.CTX_POINTERS) + 4 * len(k3.CTX_INTS)
    assert k3.ScoreCtxStruct.R.offset == 8 * len(k3.CTX_POINTERS)


# -- a small model on both sides ------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    """A small rack-aware pareto cluster with 2 dead brokers, two brokers per
    host and some partitions at RF 2; both packages get the same arrays."""
    prop = jgen.ClusterProperty(num_racks=4, num_brokers=24, num_topics=60,
                                mean_partitions_per_topic=10.0, replication_factor=3,
                                num_dead_brokers=2, load_distribution="pareto",
                                mean_utilization=0.5)
    arrays = {k: np.asarray(v).copy() for k, v in jgen.random_cluster(42, prop)._asdict().items()}
    rng = np.random.default_rng(0)
    arrays["assignment"][rng.random(arrays["assignment"].shape[0]) < 0.1, 2] = -1
    arrays["broker_host"] = (np.arange(24) // 2).astype(np.int32)
    jm, tm = JModel(**arrays), from_numpy(arrays)
    jd, td = jctx.dims_of(jm), tctx.dims_of(tm)
    js = jctx.build_static_ctx(jm, JConstraint.default(), jd)
    ts = tctx.build_static_ctx(tm, TConstraint.default(), td)
    ja = jctx.compute_aggregates(js, jnp.asarray(arrays["assignment"]), jd)
    ta = tctx.compute_aggregates(ts, tm.assignment, td)
    return dict(arrays=arrays, jd=jd, td=td, js=js, ts=ts, ja=ja, ta=ta)


def _torch_side(model, gi, n_priors=None):
    goals = tgoals(None)
    g = goals[gi]
    tables = tacc.build_tables(goals[:gi if n_priors is None else n_priors], model["ts"],
                               model["ta"], model["td"])
    return g, tables, g.prepare(model["ts"], model["ta"], model["td"])


# -- the context ---------------------------------------------------------------------


def test_a_packed_context_holds_the_round_tensors(model):
    g, tables, gs = _torch_side(model, 2)
    ctx = k3.ScoreContext(model["ts"], model["ta"], tables, g, gs)
    packs = k3.ScoreContext.packs
    address = ctx.pack("test")
    assert address == ctx.pack("test") and k3.ScoreContext.packs == packs + 1
    assert [getattr(ctx.struct, n) for n in k3.CTX_POINTERS] == [
        t.data_ptr() for t in ctx.tensors]
    a, st = model["ta"], model["ts"]
    # the model's, the aggregates' and the tables' own tensors, not copies
    held = (a.assignment, st.part_load, st.topic_id, st.broker_capacity, st.broker_rack,
            st.broker_host, st.dead, st.replica_dst_ok, st.leadership_dst_ok,
            st.movable_partition, st.host_cpu_capacity_limit, a.broker_load, a.replica_count,
            a.leader_count, a.potential_nw_out, a.leader_nw_in, a.rack_replica_count,
            a.topic_replica_count, a.host_cpu_load, *tables)
    assert all(x is y for x, y in zip(ctx.tensors, held))
    assert (ctx.struct.R, ctx.struct.NR, ctx.struct.B, ctx.struct.goal) == (
        a.assignment.shape[1], a.rack_replica_count.shape[1], a.broker_load.shape[0], g.kernel_id)


def _other(model, which, static, agg, tables, gs, g):
    """The same round with `which` input replaced by another object."""
    if which == "agg":
        return static, type(agg)(*(t.clone() for t in agg)), tables, gs
    if which == "gs":
        return static, agg, tables, g.prepare(static, agg, model["td"])
    if which == "tables":
        return static, agg, type(tables)(*tables), gs
    return static._replace(), agg, tables, gs


@pytest.mark.parametrize("which", ["agg", "gs", "tables", "static"])
def test_a_context_rebuilds_when_an_input_is_another_object(model, which):
    g, tables, gs = _torch_side(model, 8)
    static, agg = model["ts"], model["ta"]
    ctx = k3.ScoreContext(static, agg, tables, g, gs)
    ctx.pack("test")
    rebuilds = k3.ScoreContext.rebuilds
    assert ctx.bind(static, agg, tables, g, gs) is ctx
    assert k3.ScoreContext.rebuilds == rebuilds and ctx.address is not None
    static2, agg2, tables2, gs2 = _other(model, which, static, agg, tables, gs, g)
    assert ctx.bind(static2, agg2, tables2, g, gs2) is ctx
    assert k3.ScoreContext.rebuilds == rebuilds + 1
    assert ctx.address is None, "a rebuilt context must not keep the stale addresses"
    assert (ctx.static, ctx.agg, ctx.tables, ctx.gs) == (static2, agg2, tables2, gs2)
    ctx.pack("test")
    assert ctx.struct.assignment == agg2.assignment.data_ptr()
    assert ctx.bind(static2, agg2, tables2, g, gs2) is ctx
    assert k3.ScoreContext.rebuilds == rebuilds + 1


def test_a_context_refuses_a_misaligned_table(model):
    """The kernels read a [*, 4] table's row as one 16-byte load."""
    g, tables, gs = _torch_side(model, 2)
    a = model["ta"]
    shifted = torch.zeros(a.broker_load.numel() + 1)[1:].view_as(a.broker_load)
    ctx = k3.ScoreContext(model["ts"], a._replace(broker_load=shifted), tables, g, gs)
    with pytest.raises(ValueError, match="broker_load must be 16-byte aligned"):
        ctx.pack("test")


def test_a_context_rebuilds_for_another_goal(model):
    g, tables, gs = _torch_side(model, 2)
    g2 = tgoals(None)[3]
    ctx = k3.ScoreContext(model["ts"], model["ta"], tables, g, gs)
    rebuilds = k3.ScoreContext.rebuilds
    ctx.bind(model["ts"], model["ta"], tables, g2, gs)
    assert k3.ScoreContext.rebuilds == rebuilds + 1
    assert ctx.pack("test") and ctx.struct.goal == g2.kernel_id


# -- the path chooser -----------------------------------------------------------------


def _kind(shape=()):
    return torch.full(shape, KIND_MOVE, dtype=torch.int32)


def _layouts(agg, r):
    """name -> (index tensors, path): each call site's layout at the sizes
    the rounds build it (drain.py, bulk.py, optimizer.py; the service's
    512 sources, 8 replicas each, 64 destinations, 3,072 bucketed brokers),
    and the same grids smaller. Only shapes and strides matter."""
    i32 = dict(dtype=torch.int32)
    v, k, c, b = 512, 8, 64, 3072
    cand = torch.zeros((v, k), **i32)
    lead_k = torch.full((), KIND_LEADERSHIP, **i32)
    slots = torch.arange(1, r, **i32)[None, None, :]
    p3 = torch.zeros((agg.broker_load.shape[0], 4, 1), **i32)
    sel = torch.zeros(16, **i32)
    out = {
        "drain move grid": ((cand[:, :, None], _kind(), cand[:, :, None],
                             torch.zeros(c, **i32)[None, None, :]), k3.PATH_FACTORED),
        "drain move grid of 32 destinations": ((cand[:, :, None], _kind(), cand[:, :, None],
                                                torch.zeros(32, **i32)[None, None, :]),
                                               k3.PATH_FACTORED),
        "drain move grid of 16 destinations": ((cand[:, :, None], _kind(), cand[:, :, None],
                                                torch.zeros(16, **i32)[None, None, :]),
                                               k3.PATH_PROMOTION),
        "drain move grid of 6 sources": ((cand[:6, :, None], _kind(), cand[:6, :, None],
                                          torch.zeros(c, **i32)[None, None, :]),
                                         k3.PATH_PROMOTION),
        "pair drain grid": ((cand[:, :4, None], _kind(), cand[:, :4, None],
                             torch.zeros((v, c), **i32)[:, None, :]), k3.PATH_PROMOTION),
        "all-broker re-score": ((sel[:, None], sel[:, None], sel[:, None],
                                 torch.arange(b, **i32)[None, :]), k3.PATH_PROMOTION),
        "all-broker re-score of 64": ((sel.repeat(4)[:, None], sel.repeat(4)[:, None],
                                       sel.repeat(4)[:, None], torch.arange(b, **i32)[None, :]),
                                      k3.PATH_FACTORED),
        "greedy all-broker re-score": ((sel[:1, None], sel[:1, None], sel[:1, None],
                                        torch.arange(b, **i32)[None, :]), k3.PATH_PROMOTION),
        "move batch": (make_move_batch(agg.assignment, torch.arange(4, **i32)),
                       k3.PATH_PROMOTION),
        "move batch of 200,000 partitions": (make_move_batch(
            torch.zeros((200_000, r), **i32), torch.arange(16, **i32)), k3.PATH_FACTORED),
        "promotion grid": (leadership_grid(agg.assignment), k3.PATH_PROMOTION),
        "bulk promotions": ((p3, lead_k, slots, agg.assignment[p3.long(), slots.long()]),
                            k3.PATH_PROMOTION),
        "bulk moves": ((cand, _kind(), cand, torch.zeros(v, **i32)[:, None]), k3.PATH_GENERAL),
        "drain wave": ((sel, _kind((16,)), sel, sel), k3.PATH_GENERAL),
        "grid wave": ((sel, sel, sel, sel), k3.PATH_GENERAL),
    }
    return out


@pytest.mark.parametrize("r", [2, 3, 4])
def test_the_path_of_each_call_site_layout(r):
    m = generators.random_cluster(5, generators.ClusterProperty(
        num_racks=4, num_brokers=12, num_topics=10, mean_partitions_per_topic=4.0,
        replication_factor=r))
    dims = tctx.dims_of(m)
    static = tctx.build_static_ctx(m, TConstraint.default(), dims)
    agg = tctx.compute_aggregates(static, m.assignment, dims)
    for name, (idx, path) in _layouts(agg, r).items():
        _, shape3, strides = k3.layout(*idx)
        assert k3.choose_path(shape3, strides, r) == path, name


def test_layout_reads_broadcast_strides():
    a = torch.zeros((7, 3), dtype=torch.int32)
    p, kind, slot, dst = leadership_grid(a)
    shape, shape3, strides = k3.layout(p, kind, slot, dst)
    assert shape == (7, 2) and shape3 == (1, 7, 2)
    assert strides == [0, 1, 0, 0, 0, 0, 0, 0, 1, 0, 3, 1]
    with pytest.raises(ValueError):
        k3.layout(torch.zeros((2, 3), dtype=torch.int32), torch.zeros(4, dtype=torch.int32))


def test_a_launch_layout_is_checked_packed_and_cached():
    a = torch.zeros((7, 3), dtype=torch.int32)
    idx = leadership_grid(a)
    lay = k3._launch_layout(idx, a)
    assert lay is k3._launch_layout(leadership_grid(a), a)
    assert (lay.shape, lay.path, lay.name) == ((7, 2), k3.PATH_PROMOTION, "promotion")
    assert list(lay.packed) == [1, 7, 2, 0, 1, 0, 0, 0, 0, 0, 0, 1, 0, 3, 1, k3.PATH_PROMOTION]
    assert ctypes.addressof(lay.packed) == lay.address
    with pytest.raises(TypeError):
        k3._launch_layout((idx[0].long(), *idx[1:]), a)


def _recording(paths):
    """A score_candidates that records (round function, path) and runs the
    plain version."""
    inner = k3.score_candidates

    def call(static, agg, tables, goal, gs, p, kind, slot, dst, ctx=None):
        idx = [torch.as_tensor(x, dtype=torch.int32) for x in (p, kind, slot, dst)]
        _, shape3, strides = k3.layout(*idx)
        path = k3.choose_path(shape3, strides, agg.assignment.shape[1])
        paths.add((sys._getframe(1).f_code.co_name, k3.PATH_NAMES[path]))
        assert ctx is not None and ctx.bind(static, agg, tables, goal, gs) is ctx
        return inner(static, agg, tables, goal, gs, p, kind, slot, dst, ctx=ctx)

    return call


@pytest.mark.parametrize("settings", ["service", "greedy"])
def test_the_rounds_take_each_path(settings, monkeypatch):
    """A small bucketed service solve, with the factored path's size floor
    at 0 (its grids are far below it), sends the drain grids down the
    factored path, the pair drain's per-row lists and the promotion grids
    down the promotion path and the waves and the bulk planner's moves down
    the general path; the greedy solve's grid rounds send the all-broker
    re-score down the factored path. Every call carries its round's
    context."""
    monkeypatch.setattr(k3, "FACTORED_MIN_CELLS", 0)
    paths = set()
    rec = _recording(paths)
    for mod in (drain, bulk, opt):
        monkeypatch.setattr(mod, "score_candidates", rec)
    m = generators.random_cluster(7, generators.ClusterProperty(
        num_racks=7, num_brokers=40, num_topics=20, mean_partitions_per_topic=10.0,
        replication_factor=3, num_dead_brokers=1))
    s = opt.SERVICE_SETTINGS if settings == "service" else opt.GREEDY_SETTINGS
    s = dataclasses.replace(s, max_rounds_per_goal=6, cost_scaled_rounds=0.0)
    rebuilds = k3.ScoreContext.rebuilds
    opt.GoalOptimizer(device="cpu", settings=s).optimizations(m, None, raise_on_hard_failure=False)
    assert k3.ScoreContext.rebuilds == rebuilds
    want = {("drain_round", "factored"), ("drain_round", "general")}
    if settings == "service":
        want |= {("drain_round", "promotion"), ("pair_round", "promotion"),
                 ("pair_round", "general"), ("bulk_round", "general"),
                 ("bulk_round", "promotion")}
    else:
        # the greedy grid's k = 1: its wave re-scores one cell, a row of one
        want |= {("wave_with_dst", "promotion"), ("one_round", "factored")}
    assert want <= paths, sorted(paths)
    assert {p for _, p in paths} == {"factored", "promotion", "general"}


# -- the plain version, context passed, against jitted JAX ------------------------------


def _jax_layouts(model, rng):
    """(name, numpy index arrays, broadcast shape) of the three paths'
    layouts on the model: the drain grid, the pair drain's per-row lists, the
    all-broker re-score, the promotion grid and a wave of single cells."""
    a = model["arrays"]["assignment"]
    p_count, r = a.shape
    p = rng.integers(0, p_count, (6, 4, 1)).astype(np.int32)
    s = rng.integers(0, r, (6, 4, 1)).astype(np.int32)
    move = np.int32(KIND_MOVE)
    yield "drain", (p, move, s, rng.permutation(24)[:10].astype(np.int32)[None, None, :])
    yield "pair drain", (p, move, s, rng.integers(0, 24, (6, 1, 10)).astype(np.int32))
    ks = rng.integers(0, p_count, (3, 1)).astype(np.int32)
    yield "all brokers", (ks, np.full((3, 1), KIND_MOVE, np.int32),
                          rng.integers(0, r, (3, 1)).astype(np.int32),
                          np.arange(24, dtype=np.int32)[None, :])
    yield "promotions", (np.arange(p_count, dtype=np.int32)[:, None], np.int32(KIND_LEADERSHIP),
                         np.arange(1, r, dtype=np.int32)[None, :], a[:, 1:].copy())
    wp = rng.integers(0, p_count, 40).astype(np.int32)
    wk = (rng.random(40) < 0.3).astype(np.int32)
    ws = np.where(wk == KIND_LEADERSHIP, rng.integers(1, r, 40), rng.integers(0, r, 40))
    wd = np.where(wk == KIND_LEADERSHIP, a[wp, ws], rng.integers(0, 24, 40)).astype(np.int32)
    yield "wave", (wp, wk, ws.astype(np.int32), wd)


JAX_GOALS = [0, 1, 2, 5, 6, 7, 9, 11, 12, 13, 14]


@pytest.mark.parametrize("gi", JAX_GOALS, ids=[tgoals(None)[i].name for i in JAX_GOALS])
def test_the_wrapper_with_a_context_equals_jitted_jax(model, gi):
    jgoal = jgoals(None)[gi]
    tgoal, tt, tgs = _torch_side(model, gi, n_priors=15)
    jt = jacc.build_tables(jgoals(None)[:15], model["js"], model["ja"], model["jd"])
    jgs = jgoal.prepare(model["js"], model["ja"], model["jd"])
    score = jax.jit(lambda act, gs, t: jacc.score_batch(model["js"], model["ja"], act, jgoal,
                                                        gs, t))
    ctx = k3.ScoreContext(model["ts"], model["ta"], tt, tgoal, tgs)
    finite = 0
    for name, idx in _jax_layouts(model, np.random.default_rng(gi)):
        shape = np.broadcast_shapes(*(np.shape(x) for x in idx))
        act = jact.build_selected(model["js"].part_load, model["ja"].assignment,
                                  *(jnp.asarray(x) for x in idx))
        want = np.asarray(jnp.broadcast_to(score(act, jgs, jt), shape))
        got = k3.score_candidates(model["ts"], model["ta"], tt, tgoal, tgs,
                                  *(torch.as_tensor(x) for x in idx), ctx=ctx).numpy()
        fin = np.isfinite(want)
        assert got.shape == want.shape, name
        assert np.array_equal(fin, np.isfinite(got)), name
        assert np.array_equal(want[fin].view(np.int32), got[fin].view(np.int32)), name
        finite += int(fin.sum())
    assert finite > 0


# -- K5 on the same context ------------------------------------------------------------


def test_a_swap_context_packs_without_a_goal(model):
    """K5 reads the ScoreCtx struct from a context with no goal (its goal
    field -1), capacity_limit included; a round's K3 context serves K5 as
    it is, without a rebuild for the goal K5 never reads."""
    from cruise_control_torch.kernels import score_swaps as k5

    g, tables, gs = _torch_side(model, 8)
    ctx = k5.swap_context(None, model["ts"], model["ta"], tables, gs)
    assert ctx.goal is None and ctx.pack("test")
    assert ctx.struct.goal == -1
    assert ctx.struct.capacity_limit == model["ts"].capacity_limit.data_ptr()
    assert ctx.struct.w_lower == gs.lower.data_ptr()
    k3ctx = k3.ScoreContext(model["ts"], model["ta"], tables, g, gs)
    rebuilds = k3.ScoreContext.rebuilds
    assert k5.swap_context(k3ctx, model["ts"], model["ta"], tables, gs) is k3ctx
    assert k3.ScoreContext.rebuilds == rebuilds and k3ctx.goal is g


def _swap_layouts(model):
    """name -> (kind, wave, index tensors, path): each K5 call site's layout
    on the small model, built by the rounds' own grid functions."""
    from cruise_control_torch.analyzer import drain, swaps
    from cruise_control_torch.kernels import score_swaps as k5

    st, agg, td = model["ts"], model["ta"], model["td"]
    goals = tgoals(None)
    disk, topic, lbi = goals[8], goals[12], goals[14]
    gs = disk.prepare(st, agg, td)
    grid = swaps.swap_grid(st, agg, disk.resource, disk.drain_contrib(st, gs, agg).contiguous(),
                           8, 4, td.num_brokers)[-1]
    tables = tacc.build_tables(goals[:12], st, agg, td)
    tgrid = drain.topic_swap_grid(st, agg, tables, topic.prepare(st, agg, td), 0, 8, 4, 4,
                                  td.num_topics, td.num_brokers)[-1]
    rgrid = drain.relay_grid(st, agg, lbi.prepare(st, agg, td), lbi, 0, 8, 4, 8,
                             td.num_brokers)[-1]
    wave = tuple(torch.zeros(8, dtype=torch.int32) for _ in range(6))
    return {
        "replica-swap grid": (k5.REPLICA_SWAP, False, grid, k5.PATH_STAGED),
        "replica-swap wave": (k5.REPLICA_SWAP, True, wave, k5.PATH_CELLS),
        "topic-swap grid": (k5.TOPIC_SWAP, False, tgrid, k5.PATH_CELLS),
        "topic-swap wave": (k5.TOPIC_SWAP, False, wave, k5.PATH_CELLS),
        "relay grid": (k5.LEADERSHIP_RELAY, False, rgrid, k5.PATH_CELLS),
    }


def test_the_swap_path_of_each_call_site(model, monkeypatch):
    """The replica-swap grid [N, N, K, K] takes K5's staged path (from
    STAGED_MIN_CELLS cells: the small model's grid is below it, so the floor
    is set to 0 here), every other call site a thread a cell; below the
    floor the grid does too."""
    from cruise_control_torch.kernels import score_swaps as k5

    monkeypatch.setattr(k5, "STAGED_MIN_CELLS", 0)
    layouts = _swap_layouts(model)
    for name, (kind, wave, idx, path) in layouts.items():
        shape, shape5, strides = k5.layout(*idx)
        assert shape == torch.broadcast_shapes(*(t.shape for t in idx)), name
        assert k5.choose_path(kind, wave, shape5, strides) == path, name
    kind, wave, idx, _ = layouts["replica-swap grid"]
    _, shape5, strides = k5.layout(*idx)
    monkeypatch.setattr(k5, "STAGED_MIN_CELLS", int(np.prod(shape5)) + 1)
    assert k5.choose_path(kind, wave, shape5, strides) == k5.PATH_CELLS


def test_a_swap_launch_layout_is_checked_packed_and_cached(model):
    """The C entry's layout: the five dims, the thirty strides, kind,
    resource, wave and path, packed once per layout; index tensors of
    another type are refused (the kernel reads int32 in place)."""
    from cruise_control_torch.kernels import score_swaps as k5

    a = model["ta"].assignment
    kind, wave, idx, _ = _swap_layouts(model)["replica-swap grid"]
    path = k5.choose_path(kind, wave, *k5.layout(*idx)[1:])
    lay = k5._launch_layout(kind, 3, wave, idx, a)
    assert lay is k5._launch_layout(kind, 3, wave, idx, a)
    shape, shape5, strides = k5.layout(*idx)
    assert list(lay.packed) == [*shape5, *strides, kind, 3, 0, path]
    assert lay.shape == shape and ctypes.addressof(lay.packed) == lay.address
    with pytest.raises(TypeError):
        k5._launch_layout(kind, 3, wave, tuple(t.long() for t in idx), a)
    with pytest.raises(ValueError):
        k5._launch_layout(7, 0, False, idx, a)
