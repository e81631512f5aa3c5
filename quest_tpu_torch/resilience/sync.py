"""Named, instrumented lock and condition primitives for the serving layer
(``quest_tpu/resilience/sync.py``, without its lock-order graph).

Every lock of the serving stack (the Engine's queue condition, the fault
and sentinel plans, the admission buckets) is a :class:`Lock`,
:class:`RLock` or :class:`Condition` of this module instead of the raw
``threading`` primitive. With ``QUEST_CONCHECK`` unset or 0 (the default)
each operation is a pass-through costing one module boolean. With
``QUEST_CONCHECK=1`` (or :func:`configure`) the module keeps a per-thread
stack of the instrumented locks held (:func:`held_locks`), counts
``lock_acquisitions_total{lock}`` and observes ``lock_hold_ms{lock}``, and
checks the QT602 family at the declared blocking boundaries:
:func:`guard_blocking` (a device dispatch or sync), :func:`resolve_future`
(resolving a future runs its done callbacks, which must not run under a
lock), :func:`join_thread`, and a condition wait while holding a
*different* instrumented lock. A QT602 finding is counted
(``analysis_findings_total``) and kept (:func:`blocking_findings`).

Lock names are role strings (``engine.cv``), so the metrics' cardinality is
the number of roles, not of instances.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional

__all__ = ["ENV", "Lock", "RLock", "Condition", "checking", "configure",
           "reset", "held_locks", "guard_blocking", "resolve_future",
           "join_thread", "blocking_findings", "reset_findings"]

ENV = "QUEST_CONCHECK"

#: cap on retained QT602 findings (telemetry counts every one)
_MAX_FINDINGS = 256

_env_read = False
_active = False
_warned: set = set()
_tls = threading.local()
_qt602_list: list = []


def _load_env() -> None:
    global _env_read, _active
    if _env_read:
        return
    _env_read = True
    from .findings import env_int
    _active = env_int(ENV, 0, minimum=0, code="QT605", warned=_warned,
                      noun="concheck mode") >= 1


def checking() -> bool:
    """True when the instrumented paths record (``QUEST_CONCHECK`` >= 1 or
    :func:`configure`)."""
    if not _env_read:
        _load_env()
    return _active


def configure(on: bool) -> None:
    """Turn checking on or off in-process, over ``QUEST_CONCHECK``. Toggle
    only where no instrumented lock is held."""
    global _env_read, _active
    _env_read = True
    _active = bool(on)


def reset() -> None:
    """Drop the :func:`configure` override and the cached env read."""
    global _env_read, _active
    _env_read = False
    _active = False


class _Held:
    __slots__ = ("lock", "t0", "depth")

    def __init__(self, lock: "Lock", t0: float) -> None:
        self.lock = lock
        self.t0 = t0
        self.depth = 1


def _held_stack() -> list:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


def held_locks() -> tuple:
    """Names of the instrumented locks the current thread holds, outermost
    first (empty when checking is off)."""
    return tuple(h.lock.name for h in _held_stack())


def _qt602(site: str, held: tuple, what: str) -> None:
    from .findings import finding
    f = finding("QT602", f"{what} at {site!r} while holding instrumented "
                f"lock(s) {', '.join(held)}", f"sync.guard[{site}]")
    if len(_qt602_list) < _MAX_FINDINGS:
        _qt602_list.append(f)


def guard_blocking(site: str) -> None:
    """Declare a blocking boundary (device dispatch, device sync, thread
    join): records QT602 when the current thread holds any instrumented
    lock. One boolean when checking is off."""
    if not _env_read:
        _load_env()
    if not _active:
        return
    held = held_locks()
    if held:
        _qt602(site, held, "blocking boundary crossed")


def resolve_future(fut: Any, *, result: Any = None,
                   exception: BaseException | None = None,
                   site: str = "") -> bool:
    """Resolve ``fut`` (with ``exception`` when given, else ``result``)
    unless it is done already, and record QT602 when the resolving thread
    holds an instrumented lock (the done callbacks would run under it).
    Returns True when this call resolved the future."""
    if not _env_read:
        _load_env()
    if _active:
        held = held_locks()
        if held:
            _qt602(site, held, "future resolved")
    if fut.done():
        return False
    if exception is not None:
        fut.set_exception(exception)
    else:
        fut.set_result(result)
    return True


def blocking_findings() -> list:
    """The QT602 findings recorded since :func:`reset_findings` (at most
    256)."""
    return list(_qt602_list)


def reset_findings() -> None:
    del _qt602_list[:]


def join_thread(t: threading.Thread, timeout: Optional[float] = None) -> None:
    """``t.join(timeout)`` behind a QT602 blocking-boundary guard."""
    guard_blocking(f"join:{t.name}")
    t.join(timeout)


def _acquire_checked(lock: "Lock", blocking: bool, timeout: float) -> bool:
    held = _held_stack()
    if lock.reentrant:
        for h in held:
            if h.lock is lock:
                h.depth += 1
                return lock._real.acquire(blocking, timeout)
    ok = lock._real.acquire(blocking, timeout)
    if ok:
        held.append(_Held(lock, time.perf_counter()))
        if lock.record:
            from .. import telemetry
            telemetry.inc("lock_acquisitions_total", lock=lock.name)
    return ok


def _release_checked(lock: "Lock") -> None:
    held = _held_stack()
    for i in range(len(held) - 1, -1, -1):
        h = held[i]
        if h.lock is lock:
            if h.depth > 1:
                h.depth -= 1
                lock._real.release()
                return
            del held[i]
            lock._real.release()
            if lock.record:
                from .. import telemetry
                telemetry.observe("lock_hold_ms", (time.perf_counter() - h.t0) * 1e3,
                                  lock=lock.name)
            return
    lock._real.release()  # acquired before checking was turned on


class Lock:
    """Named wrapper over ``threading.Lock`` (see the module docstring).
    ``record=False`` keeps the lock on the held stack and the guards but
    out of the lock metrics."""

    __slots__ = ("name", "record", "_real")

    reentrant = False

    def __init__(self, name: str = "lock", *, record: bool = True) -> None:
        self.name = name
        self.record = record
        self._real = self._make_real()

    @staticmethod
    def _make_real():
        return threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not _env_read:
            _load_env()
        if not _active:
            return self._real.acquire(blocking, timeout)
        return _acquire_checked(self, blocking, timeout)

    def release(self) -> None:
        if not _active:
            self._real.release()
            return
        _release_checked(self)

    def locked(self) -> bool:
        return self._real.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False

    def __repr__(self) -> str:
        return f"<sync.{type(self).__name__} {self.name!r}>"


class RLock(Lock):
    """Named wrapper over ``threading.RLock``: a re-entrant acquisition
    deepens the held entry."""

    __slots__ = ()

    reentrant = True

    @staticmethod
    def _make_real():
        return threading.RLock()


class Condition:
    """Named wrapper over ``threading.Condition`` on an instrumented
    :class:`Lock` (``lock=`` shares an existing one). ``wait`` mirrors the
    release and re-acquire on the held stack; waiting without holding the
    lock raises, and waiting while holding a different instrumented lock
    records QT602."""

    __slots__ = ("name", "_lock", "_real")

    def __init__(self, name: str = "cond", *, lock: Optional[Lock] = None,
                 record: bool = True) -> None:
        if lock is None:
            lock = Lock(name, record=record)
        self._lock = lock
        self.name = lock.name
        self._real = threading.Condition(lock._real)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        return self._lock.acquire(blocking, timeout)

    def release(self) -> None:
        self._lock.release()

    def __enter__(self) -> "Condition":
        self._lock.acquire()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._lock.release()
        return False

    def wait(self, timeout: Optional[float] = None) -> bool:
        if not _env_read:
            _load_env()
        if not _active:
            return self._real.wait(timeout)
        held = _held_stack()
        ent = next((h for h in held if h.lock is self._lock), None)
        if ent is None:
            raise RuntimeError(f"cannot wait on un-acquired instrumented lock {self.name!r}")
        others = tuple(h.lock.name for h in held if h.lock is not self._lock)
        if others:
            _qt602(f"cond:{self.name}.wait", others, "condition wait on a different lock")
        held.remove(ent)
        try:
            return self._real.wait(timeout)
        finally:
            ent.t0 = time.perf_counter()
            ent.depth = 1
            held.append(ent)

    def wait_for(self, predicate: Callable[[], Any],
                 timeout: Optional[float] = None) -> Any:
        endtime = None
        waittime = timeout
        result = predicate()
        while not result:
            if waittime is not None:
                if endtime is None:
                    endtime = time.monotonic() + waittime
                else:
                    waittime = endtime - time.monotonic()
                    if waittime <= 0:
                        break
            self.wait(waittime)
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        self._real.notify(n)

    def notify_all(self) -> None:
        self._real.notify_all()

    def __repr__(self) -> str:
        return f"<sync.Condition {self.name!r}>"
