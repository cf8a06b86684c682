"""Async operation framework.

Analog of cc/async/ (AsyncKafkaCruiseControl.java:60 + progress/): long
operations run on worker threads and return an OperationFuture carrying
progress steps (OperationProgress: GeneratingClusterModel,
OptimizationForGoal...); the REST layer polls futures by User-Task-ID. Also
hosts the background proposal-precompute loop (GoalOptimizer.run :129-179)
that keeps the facade's proposal cache warm.
"""

from __future__ import annotations

import threading
import time
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional


class OperationProgress:
    """Step log for one async operation (cc/async/progress/OperationProgress.java)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._steps: List[Dict] = []

    def add_step(self, description: str) -> None:
        with self._lock:
            now = time.time()
            if self._steps:
                self._steps[-1].setdefault("endMs", now * 1000)
            self._steps.append({"step": description, "startMs": now * 1000})

    def to_list(self) -> List[Dict]:
        with self._lock:
            return [dict(s) for s in self._steps]


class OperationFuture:
    """A Future with progress + a stable operation name."""

    def __init__(self, operation: str):
        self.operation = operation
        self.progress = OperationProgress()
        self._future: Future = Future()

    def set_result(self, value) -> None:
        self._future.set_result(value)

    def set_exception(self, exc: BaseException) -> None:
        self._future.set_exception(exc)

    def done(self) -> bool:
        return self._future.done()

    def result(self, timeout: Optional[float] = None):
        return self._future.result(timeout)

    def exception(self, timeout: Optional[float] = 0):
        if not self._future.done():
            return None
        return self._future.exception(timeout)

    def describe(self) -> Dict:
        out = {"operation": self.operation, "done": self.done(),
               "progress": self.progress.to_list()}
        if self.done() and self._future.exception() is not None:
            out["error"] = str(self._future.exception())
        return out


class AsyncCruiseControl:
    """Submits facade operations to a session pool, returning OperationFutures.

    The analog of AsyncKafkaCruiseControl's session executor; one pool for
    user ops, one thread for proposal precompute."""

    def __init__(self, facade, max_workers: int = 4):
        self.facade = facade
        self._pool = ThreadPoolExecutor(max_workers=max_workers, thread_name_prefix="cc-op")
        self._precompute_stop = threading.Event()
        self._precompute_thread: Optional[threading.Thread] = None

    def submit(self, operation: str, fn: Callable, *args, **kwargs) -> OperationFuture:
        of = OperationFuture(operation)
        of.progress.add_step(f"Queued {operation}")

        import inspect

        try:
            takes_progress = "progress" in inspect.signature(fn).parameters
        except (TypeError, ValueError):
            takes_progress = False

        def run():
            of.progress.add_step(f"Running {operation}")
            try:
                if takes_progress:
                    of.set_result(fn(*args, progress=of.progress, **kwargs))
                else:
                    of.set_result(fn(*args, **kwargs))
            except BaseException as e:  # surface any failure through the future
                of.set_exception(e)

        self._pool.submit(run)
        return of

    # convenience wrappers mirroring AsyncKafkaCruiseControl's op methods
    def rebalance(self, **kwargs) -> OperationFuture:
        return self.submit("REBALANCE", self.facade.rebalance, **kwargs)

    def decommission_brokers(self, broker_indices, **kwargs) -> OperationFuture:
        return self.submit("REMOVE_BROKER", self.facade.decommission_brokers, broker_indices, **kwargs)

    def add_brokers(self, broker_indices, **kwargs) -> OperationFuture:
        return self.submit("ADD_BROKER", self.facade.add_brokers, broker_indices, **kwargs)

    def demote_brokers(self, broker_indices, **kwargs) -> OperationFuture:
        return self.submit("DEMOTE_BROKER", self.facade.demote_brokers, broker_indices, **kwargs)

    def get_proposals(self, **kwargs) -> OperationFuture:
        return self.submit("PROPOSALS", self.facade.get_proposals, **kwargs)

    # -- proposal precompute (GoalOptimizer.run :129) --------------------------

    def start_proposal_precompute(self, interval_s: float = 30.0) -> None:
        if self._precompute_thread is not None:
            return
        self._precompute_stop.clear()

        def loop():
            while not self._precompute_stop.wait(interval_s):
                try:
                    self.facade.get_proposals()
                except Exception:
                    pass  # cache stays cold; next tick retries

        self._precompute_thread = threading.Thread(
            target=loop, name="proposal-precompute", daemon=True
        )
        self._precompute_thread.start()

    def shutdown(self) -> None:
        self._precompute_stop.set()
        if self._precompute_thread is not None:
            self._precompute_thread.join(timeout=5)
            self._precompute_thread = None
        self._pool.shutdown(wait=False)
