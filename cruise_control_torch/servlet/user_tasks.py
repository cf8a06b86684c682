"""User task management.

Analog of UserTaskManager (cc/servlet/UserTaskManager.java:60): long requests
get a UUID (returned as the User-Task-ID header); re-requesting with the same
id (or same session + endpoint) returns the in-flight/completed future
instead of starting a duplicate. Completed tasks are retained for a bounded
time and count."""

from __future__ import annotations

import threading
import time
import uuid as uuid_mod
import weakref
from typing import Callable, Dict, List, Optional, Tuple

from cruise_control_torch.async_ops import OperationFuture


class SessionManager:
    """Session-reuse layer (cc/servlet/SessionManager.java, 309 LoC): binds a
    client's session (X-Session header or remote address) + endpoint to its
    in-flight request's task id, so a polling client re-attaches without
    echoing the User-Task-ID. Sessions expire after `session_expiry_s` of no
    touch and total concurrent sessions are capped; the active count is a
    gauge in the sensor registry (`SessionManager.active-sessions`)."""

    #: all live managers (weak): the registry gauge reports their sum, so
    #: multiple apps in one process don't clobber each other's count and the
    #: registry never pins a closed manager alive
    _instances: "weakref.WeakSet" = None  # initialized below
    _instances_lock = threading.Lock()

    def __init__(
        self,
        max_sessions: int = 100,
        session_expiry_s: float = 300.0,
        clock: Callable[[], float] = time.time,
    ):
        self._max = max_sessions
        self._expiry_s = session_expiry_s
        self._clock = clock
        self._lock = threading.Lock()
        #: (session, endpoint) -> {"task": id, "touched": ts}
        self._sessions: Dict[Tuple[str, str], Dict] = {}
        #: probe for "is this task still running?" (wired by UserTaskManager):
        #: idle expiry must never drop the binding of an in-flight task, or a
        #: reconnecting client would duplicate a long optimization
        self._task_alive: Callable[[str], bool] = lambda tid: False
        with SessionManager._instances_lock:
            SessionManager._instances.add(self)

    def set_task_alive_probe(self, probe: Callable[[str], bool]) -> None:
        self._task_alive = probe

    def active_sessions(self) -> int:
        with self._lock:
            return len(self._sessions)

    def _expire(self) -> None:
        now = self._clock()
        for key in [
            k
            for k, s in self._sessions.items()
            if now - s["touched"] > self._expiry_s and not self._task_alive(s["task"])
        ]:
            del self._sessions[key]

    def task_for(self, session_key: str, endpoint: str) -> Optional[str]:
        with self._lock:
            self._expire()
            entry = self._sessions.get((session_key, endpoint))
            if entry is None:
                return None
            entry["touched"] = self._clock()
            return entry["task"]

    def check_capacity(self, session_key: str, endpoint: str) -> None:
        """Raises RuntimeError when a NEW session cannot be created
        (SessionManager.createSession's too-many-sessions guard). Called
        BEFORE the operation is launched so a rejected request starts no
        work."""
        with self._lock:
            self._expire()
            key = (session_key, endpoint)
            if key not in self._sessions and len(self._sessions) >= self._max:
                raise RuntimeError("too many active sessions")

    def bind(self, session_key: str, endpoint: str, task_id: str) -> None:
        with self._lock:
            self._expire()
            self._sessions[(session_key, endpoint)] = {
                "task": task_id, "touched": self._clock()
            }

    def unbind_task(self, task_id: str) -> None:
        with self._lock:
            for key in [k for k, s in self._sessions.items() if s["task"] == task_id]:
                del self._sessions[key]


SessionManager._instances = weakref.WeakSet()

from cruise_control_torch.common.sensors import REGISTRY as _REGISTRY  # noqa: E402

def _active_sessions_total() -> int:
    with SessionManager._instances_lock:  # snapshot: WeakSet mutates on ctor/GC
        managers = list(SessionManager._instances)
    return sum(m.active_sessions() for m in managers)


_REGISTRY.gauge("SessionManager.active-sessions", _active_sessions_total)


class UserTaskManager:
    def __init__(
        self,
        max_active_tasks: int = 25,
        completed_retention_s: float = 86_400.0,
        max_retained_tasks: int = 500,
        clock: Callable[[], float] = time.time,
        uuid_factory: Callable[[], str] = lambda: str(uuid_mod.uuid4()),
        session_manager: Optional[SessionManager] = None,
    ):
        self._max_active = max_active_tasks
        self._retention_s = completed_retention_s
        self._max_retained = max_retained_tasks
        self._clock = clock
        self._uuid = uuid_factory
        self._lock = threading.Lock()
        self._tasks: Dict[str, Dict] = {}  # id -> {future, endpoint, created, session}
        self._sessions = session_manager or SessionManager(clock=clock)
        self._sessions.set_task_alive_probe(
            lambda tid: tid in self._tasks and not self._tasks[tid]["future"].done()
        )

    def _gc(self) -> None:
        now = self._clock()
        done = [
            (tid, t) for tid, t in self._tasks.items() if t["future"].done()
        ]
        for tid, t in done:
            if now - t["created"] > self._retention_s:
                self._drop(tid)
        # cap total retained
        if len(self._tasks) > self._max_retained:
            for tid, _ in sorted(
                ((tid, t) for tid, t in self._tasks.items() if t["future"].done()),
                key=lambda x: x[1]["created"],
            )[: len(self._tasks) - self._max_retained]:
                self._drop(tid)

    def _drop(self, tid: str) -> None:
        t = self._tasks.pop(tid, None)
        if t and t.get("session"):
            self._sessions.unbind_task(tid)

    def get_or_create_task(
        self,
        endpoint: str,
        factory: Callable[[], OperationFuture],
        user_task_id: Optional[str] = None,
        session_key: Optional[str] = None,
    ) -> Tuple[str, OperationFuture]:
        """Return (task_id, future); reuses an existing task when the caller
        provides its id or repeats the same session+endpoint."""
        with self._lock:
            self._gc()
            if user_task_id:
                t = self._tasks.get(user_task_id)
                if t is None:
                    raise KeyError(f"unknown User-Task-ID {user_task_id}")
                return user_task_id, t["future"]
            if session_key:
                tid = self._sessions.task_for(session_key, endpoint)
                # session reuse only attaches to an IN-FLIGHT request (its
                # purpose is polling); a finished task must be fetched by
                # explicit User-Task-ID, else a new request with different
                # parameters would silently get stale results
                if tid is not None and tid in self._tasks and not self._tasks[tid]["future"].done():
                    return tid, self._tasks[tid]["future"]
            active = sum(1 for t in self._tasks.values() if not t["future"].done())
            if active >= self._max_active:
                raise RuntimeError("too many active user tasks")
            if session_key:
                # capacity check BEFORE launching: a rejected request must
                # start no work
                self._sessions.check_capacity(session_key, endpoint)
            tid = self._uuid()
            future = factory()
            self._tasks[tid] = {
                "future": future,
                "endpoint": endpoint,
                "created": self._clock(),
                "session": session_key,
            }
            if session_key:
                self._sessions.bind(session_key, endpoint, tid)
            return tid, future

    def get(self, user_task_id: str) -> Optional[OperationFuture]:
        with self._lock:
            t = self._tasks.get(user_task_id)
            return t["future"] if t else None

    def describe_all(self) -> List[Dict]:
        """UserTaskState.java field names (UserTaskId/RequestURL/Status/
        StartMs/ClientIdentity)."""
        with self._lock:
            self._gc()
            return [
                {
                    "UserTaskId": tid,
                    "RequestURL": t["endpoint"],
                    "Status": "Completed" if t["future"].done() else "Active",
                    "StartMs": int(t["created"] * 1000),
                    "ClientIdentity": t.get("session") or "",
                }
                for tid, t in self._tasks.items()
            ]

    def mark_task_execution_began(self, user_task_id: str) -> None:
        """Bridge to the executor (markTaskExecutionBegan :383): keeps the
        task alive while its proposals execute."""
        with self._lock:
            t = self._tasks.get(user_task_id)
            if t is not None:
                t["created"] = self._clock()
