"""Monitor subsystem: samples -> windows -> FlatClusterModel.

The analog of cc/monitor/ + the core aggregation engine
(core/monitor/sampling/aggregator/): a windowed metric aggregator re-expressed
as dense ring-buffer arrays over (entity, window, metric), pluggable samplers
and sample stores, the metric processor that derives per-partition CPU from
broker CPU and byte rates, and the LoadMonitor that assembles the flattened
cluster model the analyzer consumes.
"""

from cruise_control_torch.monitor.aggregator import (
    AggregationOptions,
    Extrapolation,
    Granularity,
    WindowedAggregator,
)
from cruise_control_torch.monitor.completeness import ModelCompletenessRequirements
from cruise_control_torch.monitor.load_monitor import LoadMonitor, LoadMonitorConfig
from cruise_control_torch.monitor.metricdef import AggregationFunction, KafkaMetricDef

__all__ = [
    "AggregationFunction",
    "AggregationOptions",
    "Extrapolation",
    "Granularity",
    "KafkaMetricDef",
    "LoadMonitor",
    "LoadMonitorConfig",
    "ModelCompletenessRequirements",
    "WindowedAggregator",
]
