"""Windowed metric aggregation as dense ring-buffer arrays.

The dense-array re-expression of the core aggregation engine (host numpy,
as in the JAX package):
`MetricSampleAggregator` (core/monitor/sampling/aggregator/
MetricSampleAggregator.java:84 — samples to fixed-width windows per entity,
completeness accounting, generation counters) and `RawMetricValues`
(.../RawMetricValues.java:29 — per-entity ring buffer with extrapolation).

Instead of one ring-buffer object per entity, the whole aggregator is three
arrays over (entity, window, metric):

  sum    f32[E, W, M]   running sum per window (AVG strategy)
  peak   f32[E, W, M]   running max per window (MAX strategy)
  latest f32[E, W, M]   last-by-time value per window (LATEST strategy)
  count  i32[E, W]      samples per window per entity

`add_samples` is one vectorized scatter; `aggregate` applies the reference's
exact extrapolation ladder (RawMetricValues.aggregate:263-345) as masked
array selects:

  count >= min_samples          -> value, NONE
  count >= max(1, min//2)       -> value, AVG_AVAILABLE
  interior & both neighbors full-> 3-window average, AVG_ADJACENT
  count > 0                     -> value, FORCED_INSUFFICIENT
  else                          -> 0, NO_VALID_EXTRAPOLATION

Window indexing matches the reference: window index = time_ms // window_ms;
the aggregator keeps the newest `num_windows` *completed* windows plus the
in-flight current window; adding a sample to a completed window bumps the
generation (cache invalidation for the proposal precompute loop).
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cruise_control_torch.monitor.metricdef import AggregationFunction


class Extrapolation(enum.IntEnum):
    """Same ladder as core/monitor/sampling/aggregator/Extrapolation.java:32."""

    NONE = 0
    AVG_AVAILABLE = 1
    AVG_ADJACENT = 2
    FORCED_INSUFFICIENT = 3
    NO_VALID_EXTRAPOLATION = 4


class Granularity(enum.IntEnum):
    """AggregationOptions.Granularity: how strict completeness is."""

    ENTITY = 0  # an entity must be valid in EVERY window
    ENTITY_GROUP = 1  # an invalid entity invalidates its whole group


@dataclasses.dataclass(frozen=True)
class AggregationOptions:
    """Analog of core AggregationOptions: completeness requirements."""

    min_valid_entity_ratio: float = 0.5
    min_valid_entity_group_ratio: float = 0.0
    min_valid_windows: int = 1
    granularity: Granularity = Granularity.ENTITY


@dataclasses.dataclass
class CompletenessSummary:
    """MetricSampleCompleteness analog."""

    valid_entity_ratio: float
    valid_entity_group_ratio: float
    valid_windows: List[int]
    generation: int


class AggregationResult(dict):
    """aggregate() output bundle (MetricSampleAggregationResult analog)."""

    def __init__(self, values, extrapolations, valid_entities, windows, completeness):
        super().__init__()
        self.values: np.ndarray = values  # f32[E, Wq, M]
        self.extrapolations: np.ndarray = extrapolations  # i8[E, Wq]
        self.valid_entities: np.ndarray = valid_entities  # bool[E]
        self.windows: List[int] = windows
        self.completeness: CompletenessSummary = completeness


class WindowedAggregator:
    """Thread-safe dense aggregator over a fixed entity universe.

    Entities are dense ints [0, E). Callers that track dynamic universes
    (partition churn) map external ids -> dense ids and `resize` on growth.
    """

    def __init__(
        self,
        num_entities: int,
        num_metrics: int,
        aggregation_functions: Sequence[AggregationFunction],
        window_ms: int = 60_000,
        num_windows: int = 5,
        min_samples_per_window: int = 3,
        entity_group: Optional[np.ndarray] = None,
    ):
        if len(aggregation_functions) != num_metrics:
            raise ValueError("need one aggregation function per metric")
        self._window_ms = int(window_ms)
        self._num_windows = int(num_windows)
        self._min_samples = int(min_samples_per_window)
        self._half_min = max(1, self._min_samples // 2)
        self._agg_fn = np.asarray(aggregation_functions, dtype=np.int8)
        self._lock = threading.RLock()
        self._generation = 0
        # ring storage: slot w stores window index (oldest + w); rebased on roll
        self._oldest_window: Optional[int] = None  # oldest *retained* window index
        self._first_window: Optional[int] = None  # first window ever observed
        e, w, m = num_entities, self._num_windows + 1, num_metrics
        self._sum = np.zeros((e, w, m), dtype=np.float64)
        self._peak = np.zeros((e, w, m), dtype=np.float32)
        self._latest = np.zeros((e, w, m), dtype=np.float32)
        self._latest_time = np.full((e, w), -1, dtype=np.int64)
        self._count = np.zeros((e, w), dtype=np.int32)
        self._group = (
            np.asarray(entity_group, dtype=np.int64)
            if entity_group is not None
            else np.zeros(e, dtype=np.int64)
        )

    # -- properties ------------------------------------------------------------

    @property
    def num_entities(self) -> int:
        return self._sum.shape[0]

    @property
    def num_metrics(self) -> int:
        return self._sum.shape[2]

    @property
    def window_ms(self) -> int:
        return self._window_ms

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    def current_window(self) -> Optional[int]:
        with self._lock:
            if self._oldest_window is None:
                return None
            return self._oldest_window + self._num_windows

    def completed_windows(self) -> List[int]:
        """Newest-first completed window indices (allWindows analog).

        Windows predating the first observed sample are not reported — early
        in an aggregator's life the completed-window set grows from zero, as
        in the reference, rather than including phantom pre-history."""
        with self._lock:
            if self._oldest_window is None:
                return []
            lo = max(self._oldest_window, self._first_window)
            return list(range(self._oldest_window + self._num_windows - 1, lo - 1, -1))

    # -- ingestion -------------------------------------------------------------

    def resize(self, num_entities: int, entity_group: Optional[np.ndarray] = None) -> None:
        """Grow the entity universe (cluster expansion); keeps history."""
        with self._lock:
            e_old = self.num_entities
            if num_entities < e_old:
                raise ValueError("aggregator cannot shrink")
            if num_entities == e_old:
                return
            pad = num_entities - e_old
            w, m = self._sum.shape[1], self._sum.shape[2]
            self._sum = np.concatenate([self._sum, np.zeros((pad, w, m))], axis=0)
            self._peak = np.concatenate([self._peak, np.zeros((pad, w, m), np.float32)], axis=0)
            self._latest = np.concatenate([self._latest, np.zeros((pad, w, m), np.float32)], axis=0)
            self._latest_time = np.concatenate(
                [self._latest_time, np.full((pad, w), -1, np.int64)], axis=0
            )
            self._count = np.concatenate([self._count, np.zeros((pad, w), np.int32)], axis=0)
            if entity_group is not None:
                self._group = np.asarray(entity_group, dtype=np.int64)
            else:
                self._group = np.concatenate([self._group, np.zeros(pad, np.int64)])
            self._generation += 1

    def _roll_to(self, window_index: int) -> None:
        """Advance the ring so `window_index` is the current (in-flight) window."""
        cur = self._oldest_window
        if cur is None:
            self._oldest_window = window_index - self._num_windows
            self._first_window = window_index
            return
        shift = window_index - (cur + self._num_windows)
        if shift <= 0:
            return
        w = self._sum.shape[1]
        if shift >= w:
            self._sum[:] = 0.0
            self._peak[:] = 0.0
            self._latest[:] = 0.0
            self._latest_time[:] = -1
            self._count[:] = 0
        else:
            self._sum = np.roll(self._sum, -shift, axis=1)
            self._peak = np.roll(self._peak, -shift, axis=1)
            self._latest = np.roll(self._latest, -shift, axis=1)
            self._latest_time = np.roll(self._latest_time, -shift, axis=1)
            self._count = np.roll(self._count, -shift, axis=1)
            self._sum[:, -shift:] = 0.0
            self._peak[:, -shift:] = 0.0
            self._latest[:, -shift:] = 0.0
            self._latest_time[:, -shift:] = -1
            self._count[:, -shift:] = 0
        self._oldest_window = cur + shift
        self._generation += 1  # completed-window set changed

    def add_samples(
        self,
        entity_ids: np.ndarray,
        times_ms: np.ndarray,
        values: np.ndarray,  # f32[N, M]
    ) -> int:
        """Vectorized RawMetricValues.addSample (:121). Returns accepted count.

        Samples older than the retained span are dropped (the reference
        rejects samples outside the window range)."""
        entity_ids = np.asarray(entity_ids, dtype=np.int64)
        times_ms = np.asarray(times_ms, dtype=np.int64)
        values = np.asarray(values, dtype=np.float32)
        if entity_ids.size == 0:
            return 0
        with self._lock:
            win = times_ms // self._window_ms
            self._roll_to(int(win.max()))
            # a batch (e.g. a sample-store replay) may span windows older than
            # its max; the first-observed watermark must cover them
            self._first_window = min(self._first_window, int(win.min()))
            slot = win - self._oldest_window
            ok = (slot >= 0) & (slot < self._sum.shape[1]) & (entity_ids >= 0) & (
                entity_ids < self.num_entities
            )
            if not ok.any():
                return 0
            e, s, t, v = entity_ids[ok], slot[ok].astype(np.int64), times_ms[ok], values[ok]
            np.add.at(self._sum, (e, s), v.astype(np.float64))
            np.maximum.at(self._peak, (e, s), v)
            # LATEST: keep the value with the greatest timestamp per (e, s).
            order = np.argsort(t, kind="stable")
            eo, so, to, vo = e[order], s[order], t[order], v[order]
            newer = to >= self._latest_time[eo, so]
            # later duplicates win because assignment happens in time order
            self._latest[eo[newer], so[newer]] = vo[newer]
            self._latest_time[eo[newer], so[newer]] = to[newer]
            np.add.at(self._count, (e, s), 1)
            # bumping a completed (non-current) window invalidates caches
            if (s < self._num_windows).any():
                self._generation += 1
            return int(ok.sum())

    # -- aggregation -----------------------------------------------------------

    def _values_by_strategy(self) -> np.ndarray:
        """f32[E, W, M]: per-strategy window value (sum/avg handled later)."""
        cnt = np.maximum(self._count[:, :, None], 1)
        avg = (self._sum / cnt).astype(np.float32)
        per_metric = np.where(
            self._agg_fn[None, None, :] == AggregationFunction.AVG,
            avg,
            np.where(self._agg_fn[None, None, :] == AggregationFunction.MAX, self._peak, self._latest),
        )
        return per_metric

    def aggregate(
        self,
        windows: Optional[Sequence[int]] = None,
        options: AggregationOptions = AggregationOptions(),
        include_current: bool = False,
    ) -> AggregationResult:
        """Windowed values + extrapolations + completeness, oldest window first.

        The vectorized equivalent of MetricSampleAggregator.aggregate (:193)
        over RawMetricValues.aggregate (:263-345)."""
        with self._lock:
            if self._oldest_window is None:
                raise ValueError("no samples added yet")
            if windows is None:
                lo = max(self._oldest_window, self._first_window)
                hi = self._oldest_window + self._num_windows + (1 if include_current else 0)
                windows = list(range(lo, hi))
            windows = sorted(int(w) for w in windows)
            if not windows:
                raise ValueError("no completed windows yet")
            slots = np.asarray([w - self._oldest_window for w in windows], dtype=np.int64)
            if (slots < 0).any() or (slots >= self._sum.shape[1]).any():
                raise ValueError(f"window out of retained range: {windows}")

            vals_all = self._values_by_strategy()  # [E, W, M], computed once
            vals = vals_all[:, slots]  # [E, Wq, M]
            cnt = self._count[:, slots]  # [E, Wq]

            # AVG_ADJACENT inputs: neighbors in *retained ring* space
            w_total = self._sum.shape[1]
            prev_s = np.clip(slots - 1, 0, w_total - 1)
            next_s = np.clip(slots + 1, 0, w_total - 1)
            interior = (slots > 0) & (slots < w_total - 1)
            prev_cnt = self._count[:, prev_s]
            next_cnt = self._count[:, next_s]
            neighbors_full = (
                interior[None, :]
                & (prev_cnt >= self._min_samples)
                & (next_cnt >= self._min_samples)
            )
            # adjacent value: AVG -> total sum / total count; MAX/LATEST ->
            # mean of the 2-3 retained window values (RawMetricValues:316-330)
            sum3 = self._sum[:, prev_s] + self._sum[:, slots] + self._sum[:, next_s]
            cnt3 = np.maximum((prev_cnt + cnt + next_cnt)[:, :, None], 1)
            adj_avg = (sum3 / cnt3).astype(np.float32)
            vals_prev = vals_all[:, prev_s]
            vals_next = vals_all[:, next_s]
            three = np.where((cnt > 0)[:, :, None], 3.0, 2.0)
            adj_other = (vals_prev + np.where((cnt > 0)[:, :, None], vals, 0.0) + vals_next) / three
            adj = np.where(
                self._agg_fn[None, None, :] == AggregationFunction.AVG, adj_avg, adj_other
            )

            sufficient = cnt >= self._min_samples
            available = cnt >= self._half_min
            some = cnt > 0

            extrap = np.full(cnt.shape, Extrapolation.NO_VALID_EXTRAPOLATION, dtype=np.int8)
            out = np.zeros(vals.shape, dtype=np.float32)
            # ladder, highest priority last so earlier writes win via masking
            use_forced = some & ~available & ~neighbors_full
            out[use_forced] = vals[use_forced]
            extrap[use_forced] = Extrapolation.FORCED_INSUFFICIENT
            use_adj = ~available & neighbors_full
            out[use_adj] = adj[use_adj]
            extrap[use_adj] = Extrapolation.AVG_ADJACENT
            use_avail = available & ~sufficient
            out[use_avail] = vals[use_avail]
            extrap[use_avail] = Extrapolation.AVG_AVAILABLE
            out[sufficient] = vals[sufficient]
            extrap[sufficient] = Extrapolation.NONE

            valid_window = extrap < Extrapolation.FORCED_INSUFFICIENT  # [E, Wq]
            valid_entity = valid_window.all(axis=1)  # [E]
            # a window counts as valid only when enough entities are valid in
            # it (MetricSampleCompleteness' per-window valid-entity-ratio)
            window_ratio = valid_window.mean(axis=0) if valid_window.size else np.zeros(len(windows))
            valid_window_list = [
                int(w)
                for w, r in zip(windows, window_ratio)
                if r >= options.min_valid_entity_ratio
            ]

            # completeness over entity groups
            groups = self._group
            num_groups = int(groups.max()) + 1 if groups.size else 0
            if num_groups:
                group_valid = np.ones(num_groups, dtype=bool)
                np.logical_and.at(group_valid, groups, valid_entity)
                valid_group_ratio = float(group_valid.mean())
            else:
                valid_group_ratio = 0.0
            valid_ratio = float(valid_entity.mean()) if valid_entity.size else 0.0

            if options.granularity == Granularity.ENTITY_GROUP and num_groups:
                valid_entity = valid_entity & group_valid[groups]
                valid_ratio = float(valid_entity.mean())

            completeness = CompletenessSummary(
                valid_entity_ratio=valid_ratio,
                valid_entity_group_ratio=valid_group_ratio,
                valid_windows=valid_window_list,
                generation=self._generation,
            )
            return AggregationResult(out, extrap, valid_entity, list(windows), completeness)

    def meets(self, options: AggregationOptions) -> bool:
        """meetCompletenessRequirements analog."""
        try:
            result = self.aggregate(options=options)
        except ValueError:
            return False
        c = result.completeness
        if c.valid_entity_ratio < options.min_valid_entity_ratio:
            return False
        if c.valid_entity_group_ratio < options.min_valid_entity_group_ratio:
            return False
        return len(c.valid_windows) >= options.min_valid_windows
