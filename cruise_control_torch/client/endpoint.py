"""Typed endpoint parameters for the CLI.

Analog of cruise-control-client's Endpoint.py `CCParameter` hierarchy
(cruisecontrolclient/client/Endpoint.py): every endpoint declares its
parameters with a type, and values are validated CLIENT-side at parse time —
a bad flag fails fast with a message instead of a server round-trip.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence


class CCParameter:
    """One request parameter: name + validation to its canonical wire form."""

    def __init__(self, name: str, doc: str = ""):
        self.name = name
        self.doc = doc

    def validate(self, value: str) -> str:
        """Return the canonical string value or raise ValueError."""
        return value


class BooleanParameter(CCParameter):
    _TRUE = {"true", "t", "yes", "1"}
    _FALSE = {"false", "f", "no", "0"}

    def validate(self, value: str) -> str:
        v = str(value).strip().lower()
        if v in self._TRUE:
            return "true"
        if v in self._FALSE:
            return "false"
        raise ValueError(f"{self.name}: expected a boolean, got {value!r}")


class NonNegativeIntegerParameter(CCParameter):
    def validate(self, value: str) -> str:
        try:
            i = int(value)
        except (TypeError, ValueError):
            raise ValueError(f"{self.name}: expected an integer, got {value!r}")
        if i < 0:
            raise ValueError(f"{self.name}: must be >= 0, got {i}")
        return str(i)


class TimestampParameter(NonNegativeIntegerParameter):
    """Epoch milliseconds (the reference also accepts ISO dates; ms only here)."""


class RegexParameter(CCParameter):
    def validate(self, value: str) -> str:
        try:
            re.compile(value)
        except re.error as e:
            raise ValueError(f"{self.name}: invalid regular expression: {e}")
        return value


class SetOfChoicesParameter(CCParameter):
    def __init__(self, name: str, choices: Sequence[str], doc: str = ""):
        super().__init__(name, doc)
        self.choices = set(choices)

    def validate(self, value: str) -> str:
        parts = [p.strip() for p in str(value).split(",") if p.strip()]
        bad = [p for p in parts if p not in self.choices]
        if bad:
            raise ValueError(
                f"{self.name}: invalid value(s) {bad}; choices: {sorted(self.choices)}"
            )
        return ",".join(parts)


class SingleChoiceParameter(CCParameter):
    """Exactly one value from a choice set, canonicalized to upper case."""

    def __init__(self, name: str, choices: Sequence[str], doc: str = ""):
        super().__init__(name, doc)
        self.choices = {c.upper() for c in choices}

    def validate(self, value: str) -> str:
        v = str(value).strip().upper()
        if v not in self.choices:
            raise ValueError(
                f"{self.name}: invalid value {value!r}; choices: {sorted(self.choices)}"
            )
        return v


class CSVIntListParameter(CCParameter):
    def validate(self, value: str) -> str:
        try:
            ids = [int(p) for p in str(value).split(",") if p.strip()]
        except ValueError:
            raise ValueError(f"{self.name}: expected comma-separated broker ids, got {value!r}")
        if not ids:
            raise ValueError(f"{self.name}: at least one broker id is required")
        return ",".join(str(i) for i in ids)


_RESOURCES = ("CPU", "NW_IN", "NW_OUT", "DISK")
_ANOMALY_TYPES = ("goal_violation", "broker_failure", "metric_anomaly")

#: endpoint -> {wire parameter name: CCParameter}
ENDPOINT_PARAMETERS: Dict[str, Dict[str, CCParameter]] = {
    "partition_load": {
        # the server resolves ONE Resource per request
        "resource": SingleChoiceParameter("resource", _RESOURCES),
        "entries": NonNegativeIntegerParameter("entries"),
    },
    "state": {"substates": CCParameter("substates")},
    "proposals": {
        "goals": CCParameter("goals"),
        "ignore_proposal_cache": BooleanParameter("ignore_proposal_cache"),
        "excluded_topics": RegexParameter("excluded_topics"),
        "destination_broker_ids": CSVIntListParameter("destination_broker_ids"),
    },
    "kafka_cluster_state": {"verbose": BooleanParameter("verbose")},
    "bootstrap": {
        "start": TimestampParameter("start"),
        "end": TimestampParameter("end"),
    },
    "train": {
        "start": TimestampParameter("start"),
        "end": TimestampParameter("end"),
    },
    "rebalance": {
        "goals": CCParameter("goals"),
        "dryrun": BooleanParameter("dryrun"),
        "skip_hard_goal_check": BooleanParameter("skip_hard_goal_check"),
        "excluded_topics": RegexParameter("excluded_topics"),
        "destination_broker_ids": CSVIntListParameter("destination_broker_ids"),
        "review_id": NonNegativeIntegerParameter("review_id"),
        "ignore_proposal_cache": BooleanParameter("ignore_proposal_cache"),
    },
    "add_broker": {
        "brokerid": CSVIntListParameter("brokerid"),
        "dryrun": BooleanParameter("dryrun"),
        "review_id": NonNegativeIntegerParameter("review_id"),
    },
    "remove_broker": {
        "brokerid": CSVIntListParameter("brokerid"),
        "dryrun": BooleanParameter("dryrun"),
        "excluded_topics": RegexParameter("excluded_topics"),
        "destination_broker_ids": CSVIntListParameter("destination_broker_ids"),
        "review_id": NonNegativeIntegerParameter("review_id"),
    },
    "demote_broker": {
        "brokerid": CSVIntListParameter("brokerid"),
        "dryrun": BooleanParameter("dryrun"),
        "review_id": NonNegativeIntegerParameter("review_id"),
    },
    "pause_sampling": {"reason": CCParameter("reason")},
    "topic_configuration": {
        "topic": RegexParameter("topic"),
        "replication_factor": NonNegativeIntegerParameter("replication_factor"),
        "dryrun": BooleanParameter("dryrun"),
        "review_id": NonNegativeIntegerParameter("review_id"),
    },
    "admin": {
        "concurrent_partition_movements_per_broker": NonNegativeIntegerParameter(
            "concurrent_partition_movements_per_broker"
        ),
        "concurrent_leader_movements": NonNegativeIntegerParameter(
            "concurrent_leader_movements"
        ),
        "enable_self_healing_for": SetOfChoicesParameter(
            "enable_self_healing_for", _ANOMALY_TYPES
        ),
        "disable_self_healing_for": SetOfChoicesParameter(
            "disable_self_healing_for", _ANOMALY_TYPES
        ),
    },
    "review": {
        # the server accepts CSV lists of review ids (server.py review handler)
        "approve": CSVIntListParameter("approve"),
        "discard": CSVIntListParameter("discard"),
        "reason": CCParameter("reason"),
    },
}


def validate_params(endpoint: str, params: Dict[str, str]) -> Dict[str, str]:
    """Canonicalize/validate; raises ValueError on any bad name or value."""
    spec: Optional[Dict[str, CCParameter]] = ENDPOINT_PARAMETERS.get(endpoint)
    out = {}
    for name, value in params.items():
        if spec is None or name not in spec:
            known = sorted(spec) if spec else []
            raise ValueError(
                f"{endpoint}: unknown parameter {name!r}"
                + (f"; known: {known}" if known else " (endpoint takes no parameters)")
            )
        out[name] = spec[name].validate(value)
    return out
