"""Decision provenance: the per-move attribution ledger (host-only).

A copy of the JAX package's analyzer/provenance.py, which the port may not
import: the apply kernels stamp a packed (round, wave) tag beside every
assignment write (`Aggregates.touch_tag`), the optimizer snapshots the
assignment and the tags once per goal phase, and `build_run_ledger` diffs
consecutive snapshots into attributed `MoveRecord`s. The JSON schema is the
JAX package's, so its unchanged `scripts/diff_runs.py` and
`scripts/perf_gate.py` read the port's ledgers.

Left out: the JAX package's meter, histogram and gauge calls on its process
sensor registry (`MoveLedger.build-timer`, `runs-recorded`, `moves-recorded`,
`runs-retained`). They come with the host service's sensors, ROADMAP.md
Queue 1 item 7.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import threading
import time
import uuid
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np


#: touch-tag packing width — mirrors context.TAG_WAVE_BASE (kept literal so
#: recorded ledger JSON stays decodable without importing the kernels)
TAG_WAVE_BASE = 1024


def decode_tag(tag: int) -> tuple:
    """(round, wave) from a packed touch tag; (-1, -1) = untagged."""
    tag = int(tag)
    if tag == -1:
        return -1, -1
    rnd, wave = divmod(tag, TAG_WAVE_BASE)
    return rnd, wave


class MoveRecord(NamedTuple):
    """One accepted assignment-cell change, fully attributed.

    A NamedTuple, not a dataclass: ledger builds construct one record per
    accepted move and a frozen dataclass pays object.__setattr__ per field —
    measured 2-3x the whole build budget at bench scale."""

    partition: int
    slot: int
    kind: str  # "move" | "leadership"
    src: int
    dst: int
    goal: str
    engine: str
    phase: str  # "main" | "polish"
    goal_index: int  # phase index in the run's phase order
    round: int  # within-goal round of the last accepted touch (-1 = unknown)
    wave: int  # apply-wave index inside that round (-1 = unknown)

    def key(self) -> tuple:
        """Canonical alignment key (diff_runs pairs moves on this)."""
        return (self.goal_index, self.round, self.wave, self.partition, self.slot)

    def decision(self) -> tuple:
        """The decision itself, engine label excluded: two runs under
        different settings legitimately label the same goal's engine
        differently (`drain` vs `drain+polish`) — that is presentation, not
        a divergent decision. Digests and diff_runs compare on this."""
        return (
            self.goal_index, self.round, self.wave, self.partition, self.slot,
            self.kind, self.src, self.dst, self.goal, self.phase,
        )

    def to_dict(self) -> Dict:
        return {
            "partition": self.partition,
            "slot": self.slot,
            "kind": self.kind,
            "src": self.src,
            "dst": self.dst,
            "goal": self.goal,
            "engine": self.engine,
            "phase": self.phase,
            "goalIndex": self.goal_index,
            "round": self.round,
            "wave": self.wave,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "MoveRecord":
        return cls(
            partition=int(d["partition"]), slot=int(d["slot"]),
            kind=str(d["kind"]), src=int(d["src"]), dst=int(d["dst"]),
            goal=str(d["goal"]), engine=str(d.get("engine", "")),
            phase=str(d.get("phase", "main")),
            goal_index=int(d.get("goalIndex", -1)),
            round=int(d.get("round", -1)), wave=int(d.get("wave", -1)),
        )


@dataclasses.dataclass(frozen=True)
class GoalSegment:
    """One goal phase of a run: the per-goal acceptance outcome the moves of
    that phase were admitted under."""

    goal: str
    engine: str
    phase: str  # "main" | "polish"
    index: int  # phase index in the run's phase order
    cost_before: float
    cost_after: float
    violated_before: int
    violated_after: int
    rounds: int
    converged: bool
    num_moves: int
    num_leadership: int

    @property
    def cost_delta(self) -> float:
        return self.cost_after - self.cost_before

    def to_dict(self) -> Dict:
        return {
            "goal": self.goal, "engine": self.engine, "phase": self.phase,
            "index": self.index,
            "costBefore": round(self.cost_before, 6),
            "costAfter": round(self.cost_after, 6),
            "costDelta": round(self.cost_delta, 6),
            "violatedBefore": self.violated_before,
            "violatedAfter": self.violated_after,
            "rounds": self.rounds, "converged": self.converged,
            "numMoves": self.num_moves, "numLeadership": self.num_leadership,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "GoalSegment":
        return cls(
            goal=str(d["goal"]), engine=str(d.get("engine", "")),
            phase=str(d.get("phase", "main")), index=int(d.get("index", -1)),
            cost_before=float(d.get("costBefore", 0.0)),
            cost_after=float(d.get("costAfter", 0.0)),
            violated_before=int(d.get("violatedBefore", 0)),
            violated_after=int(d.get("violatedAfter", 0)),
            rounds=int(d.get("rounds", 0)),
            converged=bool(d.get("converged", False)),
            num_moves=int(d.get("numMoves", 0)),
            num_leadership=int(d.get("numLeadership", 0)),
        )


class RunLedger:
    """All attribution of one optimization run (immutable once built)."""

    def __init__(
        self,
        run_id: str,
        segments: Sequence[GoalSegment],
        moves: Sequence[MoveRecord],
        meta: Optional[Dict] = None,
        created_at: Optional[float] = None,
    ):
        self.run_id = run_id
        self.segments: List[GoalSegment] = list(segments)
        self.moves: List[MoveRecord] = list(moves)
        self.meta: Dict = dict(meta or {})
        self.created_at = time.time() if created_at is None else created_at

    # -- queries ---------------------------------------------------------------

    def query(
        self,
        partition: Optional[int] = None,
        broker: Optional[int] = None,
        goal: Optional[str] = None,
        round: Optional[int] = None,
        kind: Optional[str] = None,
        phase: Optional[str] = None,
        limit: Optional[int] = None,
    ) -> List[MoveRecord]:
        """Move-level view: records filtered by any combination of axes
        (`broker` matches either endpoint)."""
        out = []
        for m in self.moves:
            if partition is not None and m.partition != partition:
                continue
            if broker is not None and m.src != broker and m.dst != broker:
                continue
            if goal is not None and m.goal != goal:
                continue
            if round is not None and m.round != round:
                continue
            if kind is not None and m.kind != kind:
                continue
            if phase is not None and m.phase != phase:
                continue
            out.append(m)
            if limit is not None and len(out) >= limit:
                break
        return out

    def proposal_view(self, partition: Optional[int] = None) -> List[Dict]:
        """Proposal-level view: moves grouped by partition — the answer to
        'why does partition p appear in this OptimizerResult'."""
        groups: "OrderedDict[int, List[MoveRecord]]" = OrderedDict()
        for m in self.moves:
            if partition is not None and m.partition != partition:
                continue
            groups.setdefault(m.partition, []).append(m)
        return [
            {
                "partition": p,
                "provenanceId": f"{self.run_id}/p{p}",
                "goals": sorted({m.goal for m in ms}),
                "moves": [m.to_dict() for m in ms],
            }
            for p, ms in groups.items()
        ]

    # -- digests ---------------------------------------------------------------

    def digest(self, goals: Optional[Sequence[str]] = None) -> Dict:
        """Per-goal move counts + cost-delta checksum, plus a short hash of
        the full canonical move list — two runs with equal digests made the
        same decisions; a mismatch at equal parity is silent decision drift
        (scripts/perf_gate.py's distinct exit path).

        `goals`: restrict the digest to moves ON these goals (the
        incremental lane's unaffected-goal contract, analyzer/incremental.py:
        an incremental re-solve and a from-scratch solve must agree on every
        goal the sensitivity map marks unaffected). A goal-scoped digest
        hashes move decisions only — per-goal cost deltas are EXCLUDED,
        because a goal-scoped run never measures goals outside its subset
        and the comparison must not depend on what one side didn't run."""
        if goals is not None:
            keep = set(goals)
            moves = [m for m in self.moves if m.goal in keep]
        else:
            moves = self.moves
        by_goal: Dict[str, int] = {}
        for m in moves:
            by_goal[m.goal] = by_goal.get(m.goal, 0) + 1
        cost_delta = {
            s.goal: round(s.cost_delta, 6)
            for s in self.segments
            if s.phase == "main"
        } if goals is None else {}
        h = hashlib.sha256()
        for m in sorted(moves, key=MoveRecord.key):
            h.update("|".join(map(str, m.decision())).encode())
        for g in sorted(cost_delta):
            h.update(f"{g}={cost_delta[g]}".encode())
        return {
            "moves": len(moves),
            "byGoal": by_goal,
            **({"costDelta": cost_delta} if goals is None else {"goals": sorted(keep)}),
            "checksum": h.hexdigest()[:16],
        }

    def summary(self) -> Dict:
        moves = sum(1 for m in self.moves if m.kind == "move")
        return {
            "runId": self.run_id,
            "createdAt": self.created_at,
            "numMoves": moves,
            "numLeadership": len(self.moves) - moves,
            "segments": [s.to_dict() for s in self.segments],
            "digest": self.digest(),
            **({"meta": self.meta} if self.meta else {}),
        }

    # -- persistence (scripts/diff_runs.py reads these files) ------------------

    def to_dict(self, include_moves: bool = True) -> Dict:
        out = {
            "runId": self.run_id,
            "createdAt": self.created_at,
            "meta": self.meta,
            "digest": self.digest(),
            "segments": [s.to_dict() for s in self.segments],
        }
        if include_moves:
            out["moves"] = [m.to_dict() for m in self.moves]
        return out

    @classmethod
    def from_dict(cls, d: Dict) -> "RunLedger":
        return cls(
            run_id=str(d.get("runId", "?")),
            segments=[GoalSegment.from_dict(s) for s in d.get("segments", [])],
            moves=[MoveRecord.from_dict(m) for m in d.get("moves", [])],
            meta=d.get("meta") or {},
            created_at=d.get("createdAt"),
        )


# -- host-side builder ---------------------------------------------------------


def build_run_ledger(
    run_id: str,
    phases: Sequence[Dict],
    init_assignment: np.ndarray,
    snap_assignment: np.ndarray,
    snap_tag: np.ndarray,
    valid_partitions: Optional[int] = None,
    meta: Optional[Dict] = None,
) -> RunLedger:
    """Diff consecutive phase snapshots into an attributed RunLedger.

    `phases[i]` describes snapshot row i: {goal, engine, phase, costBefore,
    costAfter, violatedBefore, violatedAfter, rounds, converged}. Arrays are
    host numpy: init [P, R], snapshots [n_phases, P, R] (assignment + packed
    touch tags). `valid_partitions` drops shape-bucket padding rows. The
    diff touches only changed cells (np.nonzero prefilter), so build cost
    scales with moves made, not partitions examined.
    """
    init = np.asarray(init_assignment)
    snaps = np.asarray(snap_assignment)
    tags = np.asarray(snap_tag)
    if valid_partitions is not None:
        init = init[:valid_partitions]
        snaps = snaps[:, :valid_partitions]
        tags = tags[:, :valid_partitions]
    segments: List[GoalSegment] = []
    moves: List[MoveRecord] = []
    prev = init
    for i, ph in enumerate(phases):
        cur = snaps[i]
        tag = tags[i]
        p_idx, s_idx = np.nonzero(prev != cur)
        n_moves = 0
        n_lead = 0
        if p_idx.size:
            src_v = prev[p_idx, s_idx]
            dst_v = cur[p_idx, s_idx]
            # a leadership change re-homes an existing replica between slots
            # (apply semantics: slot 0 and slot s swap); a move introduces a
            # broker absent from the row before
            is_lead = (prev[p_idx] == dst_v[:, None]).any(axis=1)
            tag_v = tag[p_idx, s_idx].astype(np.int64)
            # exact -1 is the untagged sentinel; -1 % base would read 1023
            rnd_v = np.where(tag_v == -1, -1, tag_v // TAG_WAVE_BASE)
            wave_v = np.where(tag_v == -1, -1, tag_v % TAG_WAVE_BASE)
            goal = str(ph["goal"])
            engine = str(ph.get("engine", ""))
            phase = str(ph.get("phase", "main"))
            n_lead = int(is_lead.sum())
            n_moves = int(p_idx.size) - n_lead
            moves.extend(
                MoveRecord(
                    partition=int(p), slot=int(s),
                    kind="leadership" if lead else "move",
                    src=int(sv), dst=int(dv),
                    goal=goal, engine=engine, phase=phase, goal_index=i,
                    round=int(rv), wave=int(wv),
                )
                for p, s, sv, dv, lead, rv, wv in zip(
                    p_idx, s_idx, src_v, dst_v, is_lead, rnd_v, wave_v
                )
            )
        segments.append(
            GoalSegment(
                goal=str(ph["goal"]), engine=str(ph.get("engine", "")),
                phase=str(ph.get("phase", "main")), index=i,
                cost_before=float(ph.get("costBefore", 0.0)),
                cost_after=float(ph.get("costAfter", 0.0)),
                violated_before=int(ph.get("violatedBefore", 0)),
                violated_after=int(ph.get("violatedAfter", 0)),
                rounds=int(ph.get("rounds", 0)),
                converged=bool(ph.get("converged", False)),
                num_moves=n_moves, num_leadership=n_lead,
            )
        )
        prev = cur
    return RunLedger(run_id, segments, moves, meta=meta)


# -- the bounded process registry ----------------------------------------------

_run_counter = itertools.count(1)


def new_run_id() -> str:
    """Process-unique, time-ordered run id (joins proposals, executor tasks,
    and ledger rows: provenance id = `<run_id>/p<partition>`)."""
    return f"run-{next(_run_counter)}-{uuid.uuid4().hex[:8]}"


class MoveLedger:
    """Bounded, thread-safe registry of recent RunLedgers.

    The optimizer records every ledger-enabled run here; GET `/explain` and
    `scripts/dump_metrics.py` read it. Bounds: `max_runs` retained runs
    (oldest evicted) and `max_moves_per_run` move rows per run (excess rows
    drop with a `truncatedMoves` marker — counts and digests are computed
    before truncation, so nothing is silently lost)."""

    def __init__(self, max_runs: int = 8, max_moves_per_run: int = 500_000):
        self._lock = threading.Lock()
        self._runs: "OrderedDict[str, RunLedger]" = OrderedDict()  #: guarded_by(_lock)
        self._max_runs = max_runs  #: guarded_by(_lock)
        self._max_moves = max_moves_per_run  #: guarded_by(_lock)
        self._total_recorded = 0  #: guarded_by(_lock)

    def configure(self, max_runs: Optional[int] = None,
                  max_moves_per_run: Optional[int] = None) -> None:
        with self._lock:
            if max_runs is not None:
                self._max_runs = max(1, int(max_runs))
            if max_moves_per_run is not None:
                self._max_moves = max(1, int(max_moves_per_run))
            while len(self._runs) > self._max_runs:
                self._runs.popitem(last=False)

    def record(self, ledger: RunLedger) -> None:
        n_moves = len(ledger.moves)
        with self._lock:
            if n_moves > self._max_moves:
                # digest/summary were computed over the full list by callers;
                # mark the truncation visibly rather than dropping silently
                ledger.meta["truncatedMoves"] = n_moves - self._max_moves
                ledger.moves = ledger.moves[: self._max_moves]
            self._runs[ledger.run_id] = ledger
            self._runs.move_to_end(ledger.run_id)
            self._total_recorded += 1
            while len(self._runs) > self._max_runs:
                self._runs.popitem(last=False)

    def get(self, run_id: str) -> Optional[RunLedger]:
        with self._lock:
            return self._runs.get(run_id)

    def latest(self) -> Optional[RunLedger]:
        with self._lock:
            if not self._runs:
                return None
            return next(reversed(self._runs.values()))

    def run_ids(self) -> List[str]:
        with self._lock:
            return list(self._runs)

    def state(self) -> Dict:
        with self._lock:
            runs = list(self._runs.values())
            total = self._total_recorded
            cap = self._max_runs
        return {
            "runs": [
                {
                    "runId": l.run_id,
                    "createdAt": l.created_at,
                    "numMoves": len(l.moves),
                    "numSegments": len(l.segments),
                }
                for l in runs
            ],
            "totalRecorded": total,
            "capacity": cap,
        }

    def clear(self) -> None:
        with self._lock:
            self._runs.clear()


#: process-wide ledger registry (the /explain surface)
LEDGER = MoveLedger()


# -- run-pair diffing (scripts/diff_runs.py core) ------------------------------


def diff_ledgers(a: RunLedger, b: RunLedger) -> Dict:
    """Align two recorded ledgers and report the FIRST divergent move with
    both sides' attribution — the tool that turns 'config 3's parity
    knife-edges by Δ0.193' from prose into a pinpointed decision.

    Moves are compared in canonical (goal_index, round, wave, partition,
    slot) order; the first position where the sequences disagree (different
    cell, different destination, or one side exhausted) is the divergence
    point. Segment-level deltas are reported for every goal so the reader
    sees where costs split even when the move streams stay aligned longer.
    """
    sa = sorted(a.moves, key=MoveRecord.key)
    sb = sorted(b.moves, key=MoveRecord.key)
    seg_deltas = []
    by_goal_b = {(s.goal, s.phase): s for s in b.segments}
    for s in a.segments:
        t = by_goal_b.get((s.goal, s.phase))
        if t is None:
            continue
        seg_deltas.append(
            {
                "goal": s.goal,
                "phase": s.phase,
                "movesA": s.num_moves + s.num_leadership,
                "movesB": t.num_moves + t.num_leadership,
                "costAfterA": round(s.cost_after, 6),
                "costAfterB": round(t.cost_after, 6),
                "costAfterDelta": round(s.cost_after - t.cost_after, 6),
            }
        )
    first = None
    index = None
    for i, (ma, mb) in enumerate(zip(sa, sb)):
        if ma.decision() != mb.decision():
            first, index = (ma, mb), i
            break
    if first is None and len(sa) != len(sb):
        i = min(len(sa), len(sb))
        first = (sa[i] if i < len(sa) else None, sb[i] if i < len(sb) else None)
        index = i
    diverged = first is not None
    out = {
        "runA": a.run_id,
        "runB": b.run_id,
        "movesA": len(sa),
        "movesB": len(sb),
        "digestA": a.digest(),
        "digestB": b.digest(),
        "identical": not diverged,
        "segments": seg_deltas,
    }
    if diverged:
        ma, mb = first
        out["firstDivergence"] = {
            "index": index,
            "a": ma.to_dict() if ma is not None else None,
            "b": mb.to_dict() if mb is not None else None,
        }
        # the human-readable one-liner reports the earliest attributable
        # decision split; a one-sided record means one run simply kept going
        who = ma or mb
        out["firstDivergenceGoal"] = who.goal
        out["firstDivergencePhase"] = who.phase
    return out
