"""2-step verification purgatory.

Analog of cc/servlet/purgatory/Purgatory.java:37: when 2-step verification is
enabled, POST requests park here (addRequest :76) until a reviewer approves
or discards them via /review; approved requests execute exactly once
(submit :109, applyReview :174). Reviewed state renders through /review_board."""

from __future__ import annotations

import enum
import threading
import time
from typing import Callable, Dict, List, Optional


class ReviewStatus(enum.IntEnum):
    PENDING_REVIEW = 0
    APPROVED = 1
    SUBMITTED = 2
    DISCARDED = 3


class Purgatory:
    def __init__(self, retention_s: float = 86_400.0, clock: Callable[[], float] = time.time):
        self._retention_s = retention_s
        self._clock = clock
        # RLock: apply_review renders the board while still holding the lock
        self._lock = threading.RLock()
        self._next_id = 0
        self._requests: Dict[int, Dict] = {}

    def add_request(self, endpoint: str, params: Dict) -> int:
        """Park a request; returns its review id."""
        with self._lock:
            self._gc()
            rid = self._next_id
            self._next_id += 1
            self._requests[rid] = {
                "endpoint": endpoint,
                "params": params,
                "status": ReviewStatus.PENDING_REVIEW,
                "submitted_at": self._clock(),
                "reason": "",
            }
            return rid

    def apply_review(self, approve_ids: List[int], discard_ids: List[int], reason: str = "") -> Dict:
        with self._lock:
            for rid in approve_ids:
                r = self._must_get(rid)
                if r["status"] != ReviewStatus.PENDING_REVIEW:
                    raise ValueError(f"request {rid} is {r['status'].name}, not reviewable")
                r["status"] = ReviewStatus.APPROVED
                r["reason"] = reason
            for rid in discard_ids:
                r = self._must_get(rid)
                if r["status"] not in (ReviewStatus.PENDING_REVIEW, ReviewStatus.APPROVED):
                    raise ValueError(f"request {rid} is {r['status'].name}, not discardable")
                r["status"] = ReviewStatus.DISCARDED
                r["reason"] = reason
            return self.review_board()

    def submit(self, rid: int) -> Dict:
        """Claim an APPROVED request for execution (exactly once)."""
        with self._lock:
            r = self._must_get(rid)
            if r["status"] != ReviewStatus.APPROVED:
                raise ValueError(f"request {rid} is {r['status'].name}, not APPROVED")
            r["status"] = ReviewStatus.SUBMITTED
            return dict(r)

    def review_board(self) -> Dict:
        with self._lock:
            self._gc()
            return {
                "RequestInfo": [
                    {
                        "Id": rid,
                        "EndPoint": r["endpoint"],
                        "Status": r["status"].name,
                        "Reason": r["reason"],
                        "SubmitTimeMs": int(r["submitted_at"] * 1000),
                    }
                    for rid, r in sorted(self._requests.items())
                ]
            }

    def _must_get(self, rid: int) -> Dict:
        r = self._requests.get(rid)
        if r is None:
            raise KeyError(f"unknown review id {rid}")
        return r

    def _gc(self) -> None:
        cutoff = self._clock() - self._retention_s
        for rid in [r for r, v in self._requests.items() if v["submitted_at"] < cutoff]:
            del self._requests[rid]
