"""CPU attribution model: fixed coefficients + optional trained regression.

Analog of ModelUtils (cc/model/ModelUtils.java:14) and
LinearRegressionModelParameters (cc/model/LinearRegressionModelParameters.java:26).
The fixed-coefficient path splits a broker's measured CPU across its leader /
follower byte rates with the reference's default weights (ModelParameters:
leader-bytes-in 0.7, leader-bytes-out 0.15, follower-bytes-in 0.15); the
trained path fits per-rate CPU coefficients by least squares over CPU-util
bucketed observations so heavy brokers don't drown out light ones.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np

#: ModelParameters defaults (cc/model/ModelParameters.java:21-29)
CPU_WEIGHT_OF_LEADER_BYTES_IN_RATE = 0.7
CPU_WEIGHT_OF_LEADER_BYTES_OUT_RATE = 0.15
CPU_WEIGHT_OF_FOLLOWER_BYTES_IN_RATE = 0.15

#: ModelUtils guards (cc/model/ModelUtils.java:30-31)
ALLOWED_METRIC_ERROR_FACTOR = 1.05
UNSTABLE_METRIC_THROUGHPUT_THRESHOLD = 10.0


def estimate_leader_cpu_util(
    broker_cpu_util,
    broker_leader_bytes_in,
    broker_leader_bytes_out,
    broker_follower_bytes_in,
    partition_bytes_in,
    partition_bytes_out,
):
    """Vectorized ModelUtils.estimateLeaderCpuUtil (cc/model/ModelUtils.java:60).

    All args broadcast; partition_* may be [P]-shaped against scalar broker
    rates. Inconsistent samples (partition rate exceeding its broker's rate
    beyond the allowed error on a stable broker) yield NaN — callers drop
    those samples, the vector analog of the reference's IllegalArgumentException.
    """
    b_cpu = np.asarray(broker_cpu_util, dtype=np.float64)
    l_in = np.asarray(broker_leader_bytes_in, dtype=np.float64)
    l_out = np.asarray(broker_leader_bytes_out, dtype=np.float64)
    f_in = np.asarray(broker_follower_bytes_in, dtype=np.float64)
    p_in = np.asarray(partition_bytes_in, dtype=np.float64)
    p_out = np.asarray(partition_bytes_out, dtype=np.float64)

    lin_c = CPU_WEIGHT_OF_LEADER_BYTES_IN_RATE * l_in
    lout_c = CPU_WEIGHT_OF_LEADER_BYTES_OUT_RATE * l_out
    fin_c = CPU_WEIGHT_OF_FOLLOWER_BYTES_IN_RATE * f_in
    total = lin_c + lout_c + fin_c
    safe_total = np.where(total > 0, total, 1.0)
    in_contrib = b_cpu * lin_c / safe_total
    out_contrib = b_cpu * lout_c / safe_total

    est = in_contrib * np.minimum(1.0, p_in / np.where(l_in > 0, l_in, 1.0)) + out_contrib * np.minimum(
        1.0, p_out / np.where(l_out > 0, l_out, 1.0)
    )
    est = np.where((l_in == 0) | (l_out == 0), 0.0, est)

    bad_in = (l_in * ALLOWED_METRIC_ERROR_FACTOR < p_in) & (l_in > UNSTABLE_METRIC_THROUGHPUT_THRESHOLD)
    bad_out = (l_out * ALLOWED_METRIC_ERROR_FACTOR < p_out) & (l_out > UNSTABLE_METRIC_THROUGHPUT_THRESHOLD)
    return np.where(bad_in | bad_out, np.nan, est)


def follower_cpu_util_from_leader_load(leader_bytes_in, leader_bytes_out, leader_cpu_util):
    """Vectorized ModelUtils.getFollowerCpuUtilFromLeaderLoad (:42)."""
    l_in = np.asarray(leader_bytes_in, dtype=np.float64)
    l_out = np.asarray(leader_bytes_out, dtype=np.float64)
    cpu = np.asarray(leader_cpu_util, dtype=np.float64)
    denom = (
        CPU_WEIGHT_OF_LEADER_BYTES_IN_RATE * l_in + CPU_WEIGHT_OF_LEADER_BYTES_OUT_RATE * l_out
    )
    out = cpu * (CPU_WEIGHT_OF_FOLLOWER_BYTES_IN_RATE * l_in) / np.where(denom > 0, denom, 1.0)
    return np.where((l_in == 0.0) & (l_out == 0.0), 0.0, out)


# -- trained linear regression -------------------------------------------------


@dataclasses.dataclass
class LinearRegressionModelParameters:
    """CPU-util-bucketed observation store + least-squares coefficients.

    Observations (leader_bytes_in, leader_bytes_out, follower_bytes_in) ->
    broker CPU are binned by CPU utilization percent so training covers the
    utilization spectrum (LinearRegressionModelParameters' bucketed matrix);
    `train` solves for the three per-rate coefficients.
    """

    num_buckets: int = 20
    max_observations_per_bucket: int = 500

    def __post_init__(self):
        self._obs = [[] for _ in range(self.num_buckets)]
        self._coefficients: Optional[np.ndarray] = None
        self._lock = threading.Lock()

    def add_observation(self, cpu_util_fraction: float, leader_in: float, leader_out: float, follower_in: float) -> None:
        b = min(self.num_buckets - 1, max(0, int(cpu_util_fraction * self.num_buckets)))
        with self._lock:
            bucket = self._obs[b]
            if len(bucket) < self.max_observations_per_bucket:
                bucket.append((leader_in, leader_out, follower_in, cpu_util_fraction))

    @property
    def num_observations(self) -> int:
        with self._lock:
            return sum(len(b) for b in self._obs)

    def train(self) -> Optional[np.ndarray]:
        """Least squares over all buckets; returns [in, out, follower_in] or
        None with insufficient data (needs >= 3 observations spanning >= 2 buckets)."""
        with self._lock:
            rows = [o for b in self._obs for o in b]
            occupied = sum(1 for b in self._obs if b)
        if len(rows) < 3 or occupied < 2:
            return None
        a = np.asarray([(r[0], r[1], r[2]) for r in rows], dtype=np.float64)
        y = np.asarray([r[3] for r in rows], dtype=np.float64)
        coef, *_ = np.linalg.lstsq(a, y, rcond=None)
        coef = np.maximum(coef, 0.0)  # negative CPU cost is unphysical
        with self._lock:
            self._coefficients = coef
        return coef

    @property
    def coefficients(self) -> Optional[np.ndarray]:
        with self._lock:
            return None if self._coefficients is None else self._coefficients.copy()

    def estimate_leader_cpu_util(self, partition_bytes_in, partition_bytes_out):
        """ModelUtils.estimateLeaderCpuUtilUsingLinearRegressionModel (:94)."""
        coef = self.coefficients
        if coef is None:
            raise ValueError("linear regression model not trained")
        p_in = np.asarray(partition_bytes_in, dtype=np.float64)
        p_out = np.asarray(partition_bytes_out, dtype=np.float64)
        return coef[0] * p_in + coef[1] * p_out
