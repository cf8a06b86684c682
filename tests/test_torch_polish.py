"""The polish pass: after the stack, every goal runs once more under the full
merged tables (skipped where the goal converged and the state is still its
exit state), through the port's chunked machine and its fused stack,
against the JAX package's chunked polish run, on fixture C (32 brokers,
766 partitions, 2 dead brokers).

- `BENCH_SETTINGS` (48 polish rounds) through the machine at chunk budgets
  32 and 3 (goals and polish phases pause and resume), and
  a two-goal request whose polish phases skip, equal the JAX chunked run
  (one JAX program: it ignores the budget): the final assignment, touch
  tags, proposals, the StackMetrics integers with the state fingerprints
  and the re-measured after-rows, the 2G ledger phases with their "main" /
  "polish" labels, the decision digest.
- With polish_rounds = 8 the port's fused polish run equals its chunked run
  (on fixture C no polish phase needs more than 5 rounds).
- The JAX package's fused polish program traces every goal twice; its
  comparison is in the slow lane.
- check_supported still refuses shape bucketing and options, and no longer
  refuses the grid or the polish pass.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import optimizer as jopt
from cruise_control_torch.analyzer import optimizer as topt
from cruise_control_torch.analyzer.context import OptimizationOptions
from test_torch_grid import INT_METRICS, _model, jax_run, port_run


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU path runs on small tensors, where torch's intra-op
    threads buy nothing, and the suite runs in several worker processes at
    once: threads that outnumber the cores wait on each other (six 8-thread
    processes on 8 cores ran a solve 30x slower than single-thread ones)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


#: the JAX side of BENCH_SETTINGS (bench.py:215-227 at its defaults, no
#: bucketing)
JAX_BENCH = dict(batch_k=1024, max_rounds_per_goal=128, num_dst_candidates=16, num_swap_pairs=16,
                 swap_candidates=16, swaps_per_broker=4, chunk_rounds=16, polish_rounds=48,
                 bucket_partitions=False, bucket_brokers=False)
CHUNKS = (32, 3)
#: a request whose second goal moves nothing: both polish phases find the
#: state of the goal's exit and skip
SUBSET = ("RackAwareGoal", "ReplicaCapacityGoal")
CASES = CHUNKS + ("subset",)


def _polish8(chunk):
    return dataclasses.replace(topt.BENCH_SETTINGS, polish_rounds=8, chunk_rounds=chunk)


@pytest.fixture(scope="module")
def runs():
    """{chunk: (jax result, jax metrics, jax touch tags, port result, port
    metrics)} under BENCH_SETTINGS at each chunk budget, "subset" the SUBSET
    request at 32, "fused" / "chunked" the port's runs with 8 polish rounds
    at chunk budgets 0 and 32, and "main" the port's run at 32 without the
    polish pass."""
    model = _model()
    out = {}
    for chunk in CHUNKS:
        j = jax_run(jopt.OptimizerSettings(**dict(JAX_BENCH, chunk_rounds=chunk)), model)
        out[chunk] = j + port_run(dataclasses.replace(topt.BENCH_SETTINGS, chunk_rounds=chunk),
                                  model)
    out["subset"] = jax_run(jopt.OptimizerSettings(**dict(JAX_BENCH, chunk_rounds=32)), model,
                            SUBSET) + port_run(dataclasses.replace(topt.BENCH_SETTINGS,
                                                                   chunk_rounds=32), model, SUBSET)
    out["fused"] = port_run(_polish8(0), model)
    out["chunked"] = port_run(_polish8(32), model)
    out["main"] = port_run(dataclasses.replace(topt.BENCH_SETTINGS, chunk_rounds=32,
                                               polish_rounds=0), model)
    return out


def test_bench_settings_are_the_bench_batched_pass():
    s = topt.BENCH_SETTINGS
    j = jopt.OptimizerSettings(**JAX_BENCH)
    for f in dataclasses.fields(s):
        assert getattr(s, f.name) == getattr(j, f.name), f.name


@pytest.mark.parametrize("chunk", CASES)
def test_polish_final_assignment_touch_tags_and_proposals_equal_jax(runs, chunk):
    jres, _, jtouch, tres, _ = runs[chunk]
    assert np.array_equal(np.asarray(jres.final_assignment), tres.final_assignment)
    assert np.array_equal(jtouch, tres.touch_tag)

    def key(prs):
        return [(p.partition, p.old_replicas, p.new_replicas, p.data_to_move_mb) for p in prs]

    assert key(jres.proposals) == key(tres.proposals)


@pytest.mark.parametrize("chunk", CASES)
def test_polish_stack_metrics_equal_jax(runs, chunk):
    jres, jm, _, tres, tm = runs[chunk]
    for field in INT_METRICS:
        assert np.array_equal(np.asarray(getattr(jm, field)).astype(np.int64),
                              np.asarray(getattr(tm, field)).astype(np.int64)), field
    # the after-rows are the final state's, measured after the pass
    np.testing.assert_allclose(tm.cost_after, np.asarray(jm.cost_after), rtol=1e-5)
    assert [(g.violated_brokers_after, g.rounds, g.converged) for g in tres.goal_results] == [
        (g.violated_brokers_after, g.rounds, g.converged) for g in jres.goal_results]


@pytest.mark.parametrize("chunk", CASES)
def test_polish_ledger_phases_and_digest_equal_jax(runs, chunk):
    jres, _, _, tres, _ = runs[chunk]
    names = [g.name for g in tres.goal_results]
    segs = tres.provenance.segments
    assert len(segs) == 2 * len(names)
    assert [s.phase for s in segs] == ["main"] * len(names) + ["polish"] * len(names)
    assert all(s.engine.endswith("+polish") for s in segs)

    def key(ss):
        return [(s.goal, s.phase, s.index, s.num_moves, s.num_leadership, s.rounds) for s in ss]

    assert key(segs) == key(jres.provenance.segments)
    assert tres.provenance.digest(goals=names) == jres.provenance.digest(goals=names)


@pytest.mark.parametrize("case", [32, "subset"])
def test_the_polish_pass_ran_or_skipped(runs, case):
    """Against the same stack without the polish pass (the subset request's
    two goals run first in it too, from the same state): on the full stack
    every polish phase runs (a later goal moved something after each goal's
    exit) and adds its rounds; in the subset request both skip and add none.
    The main pass is the same."""
    _, _, _, tres, tm = runs[case]
    main = runs["main"][1]
    extra = np.asarray(tm.rounds, dtype=np.int64) - np.asarray(main.rounds, dtype=np.int64)
    if case == "subset":
        extra, conv = extra[:len(SUBSET)], np.asarray(tm.converged)[:len(SUBSET)]
        assert (extra == 0).all()
        assert np.array_equal(conv, np.asarray(main.converged)[:len(SUBSET)])
        assert tres.num_replica_moves > 0
        assert [g.rounds for g in tres.goal_results] == list(np.asarray(tm.rounds)[:len(SUBSET)])
    else:
        assert (extra > 0).all()
        assert np.array_equal(np.asarray(main.violated_before), np.asarray(tm.violated_before))
        assert [g.rounds for g in tres.goal_results] == list(np.asarray(tm.rounds))


def test_fused_polish_run_equals_chunked_run(runs):
    chunked, fused = runs["chunked"][0], runs["fused"][0]
    assert np.array_equal(chunked.final_assignment, fused.final_assignment)
    assert np.array_equal(chunked.touch_tag, fused.touch_tag)
    names = [g.name for g in fused.goal_results]
    assert chunked.provenance.digest(goals=names) == fused.provenance.digest(goals=names)
    row = [(g.name, g.violated_brokers_before, g.violated_brokers_after, g.rounds, g.converged,
            g.cost_after) for g in fused.goal_results]
    assert row == [(g.name, g.violated_brokers_before, g.violated_brokers_after, g.rounds,
                    g.converged, g.cost_after) for g in chunked.goal_results]
    assert np.array_equal(runs["fused"][1].state_fp, runs["chunked"][1].state_fp)
    # the cap of 8 does not bind here: the same decisions as BENCH_SETTINGS' 48
    assert np.array_equal(chunked.final_assignment, runs[32][3].final_assignment)
    assert np.array_equal(chunked.touch_tag, runs[32][3].touch_tag)


@pytest.mark.slow
def test_fused_polish_run_equals_jax_fused_run():
    model = _model()
    jres, jm, jtouch = jax_run(jopt.OptimizerSettings(**dict(JAX_BENCH, polish_rounds=8,
                                                             chunk_rounds=0)), model)
    tres, tm = port_run(_polish8(0), model)
    assert np.array_equal(np.asarray(jres.final_assignment), tres.final_assignment)
    assert np.array_equal(jtouch, tres.touch_tag)
    for field in INT_METRICS:
        assert np.array_equal(np.asarray(getattr(jm, field)).astype(np.int64),
                              np.asarray(getattr(tm, field)).astype(np.int64)), field
    names = [g.name for g in tres.goal_results]
    assert tres.provenance.digest(goals=names) == jres.provenance.digest(goals=names)


@pytest.mark.parametrize("settings", [
    dict(bucket_partitions=True), dict(bucket_brokers=True),
])
def test_bucketing_is_still_refused(settings):
    with pytest.raises(NotImplementedError, match="bucketing"):
        topt.check_supported([], dataclasses.replace(topt.BENCH_SETTINGS, **settings),
                             OptimizationOptions())


def test_options_are_still_refused():
    field = dataclasses.fields(OptimizationOptions)[0].name
    options = dataclasses.replace(OptimizationOptions(), **{field: True})
    with pytest.raises(NotImplementedError, match=field):
        topt.check_supported([], topt.GREEDY_SETTINGS, options)


@pytest.mark.parametrize("settings", ["GREEDY_SETTINGS", "BENCH_SETTINGS"])
def test_the_grid_and_the_polish_pass_are_accepted(settings):
    topt.check_supported(topt.goals_by_priority(None), getattr(topt, settings),
                         OptimizationOptions())
