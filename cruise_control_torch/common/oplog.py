"""Operation audit log.

The reference writes human-auditable operation lines to a dedicated
`operationLogger` (the OPERATION_LOG logger in cc/executor/Executor.java and
cc/detector/AnomalyDetector.java, routed to its own appender by
config/log4j.properties). Same contract here: one logger, one line per
externally-visible operation — execution started/stopped/finished, anomaly
decisions, self-healing fixes — so an operator can reconstruct what the
service DID without wading through debug logs. Route it to a file with
standard logging config (`logging.getLogger("operationLogger")`).
"""

from __future__ import annotations

import logging

OPERATION_LOG = logging.getLogger("operationLogger")


def op_log(fmt: str, *args) -> None:
    """Log one operation line; when the calling thread is inside a tracer
    span, the trace id is appended so the audit trail joins against `/trace`
    spans and JSONL sinks (common/tracing.py)."""
    from cruise_control_torch.common.tracing import TRACER

    trace_id = TRACER.current_trace_id()
    if trace_id:
        OPERATION_LOG.info(fmt + " [trace=%s]", *args, trace_id)
    else:
        OPERATION_LOG.info(fmt, *args)
