"""Deadline enforcement around an engine dispatch and a device sync
(``quest_tpu/resilience/watchdog.py``).

With ``QUEST_WATCHDOG_MS`` set, :func:`watched` runs the call on a worker
thread and waits at most the deadline; on expiry it raises a typed
:class:`~quest_tpu_torch.resilience.errors.QuESTHangError` (a QT405
finding, counted ``watchdog_timeouts_total{site}``) instead of blocking
for ever. The worker is a daemon thread: a wedged launch cannot be
cancelled, so the watchdog frees the caller (who quarantines), it does not
unwedge the card. Unset or 0 runs the call inline. A malformed value
disables it with a QT303 finding.

An injected hang (``engine.dispatch:hang:nth``) makes the worker sleep past
the deadline first, so the proof fires deterministically; with no
watchdog armed it is a bounded stall of :data:`HANG_SLEEP_S`.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Callable, Iterator, TypeVar

from .. import telemetry
from . import sync as _sync
from .errors import QuESTHangError

__all__ = ["ENV_MS", "HANG_SLEEP_S", "deadline_s", "configure", "reset",
           "watchdog_deadline", "watched"]

T = TypeVar("T")

ENV_MS = "QUEST_WATCHDOG_MS"

#: the bounded stand-in for an injected hang when no watchdog is armed
HANG_SLEEP_S = 0.1

_UNSET = object()
_override: object = _UNSET
_env_cache: object = _UNSET
_lock = _sync.Lock("watchdog.env")


def deadline_s() -> float | None:
    """The deadline in seconds, or None when the watchdog is off.
    ``QUEST_WATCHDOG_MS`` is read once; :func:`configure` wins over it."""
    global _env_cache
    if _override is not _UNSET:
        return _override  # type: ignore[return-value]
    if _env_cache is _UNSET:
        with _lock:
            if _env_cache is _UNSET:
                raw = os.environ.get(ENV_MS, "").strip()
                try:
                    ms = float(raw) if raw else 0.0
                except ValueError:
                    from .findings import finding
                    finding("QT303", f"{ENV_MS}={raw!r} is not numeric; watchdog "
                            "disabled", "resilience.watchdog")
                    ms = 0.0
                _env_cache = ms / 1e3 if ms > 0 else None
    return _env_cache  # type: ignore[return-value]


def configure(ms: float | None) -> None:
    """Set the deadline (milliseconds; None or 0 disables) over the env."""
    global _override
    _override = None if not ms else ms / 1e3


def reset() -> None:
    """Drop the :func:`configure` override and the cached env read."""
    global _override, _env_cache
    _override = _UNSET
    _env_cache = _UNSET


@contextlib.contextmanager
def watchdog_deadline(ms: float | None) -> Iterator[None]:
    """Arm the watchdog at ``ms`` for the block."""
    global _override
    prev = _override
    configure(ms)
    try:
        yield
    finally:
        _override = prev


def watched(fn: Callable[[], T], *, site: str, deadline: float | None = None,
            hang: bool = False) -> T:
    """Run ``fn`` under the watchdog (``deadline`` seconds, by default
    :func:`deadline_s`; None runs it inline). ``hang`` marks an injected
    hang: the worker sleeps past the deadline first."""
    dl = deadline if deadline is not None else deadline_s()
    if dl is None:
        if hang:
            time.sleep(HANG_SLEEP_S)
        return fn()

    box: dict = {}
    done = threading.Event()

    def worker() -> None:
        try:
            if hang:
                time.sleep(max(4 * dl, HANG_SLEEP_S))
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 -- relayed to the caller
            box["err"] = e
        finally:
            done.set()

    t = threading.Thread(target=worker, daemon=True, name=f"quest-watchdog[{site}]")
    t.start()
    if not done.wait(dl):
        telemetry.inc("watchdog_timeouts_total", site=site)
        telemetry.event("resilience.watchdog_timeout", site=site, deadline_ms=dl * 1e3)
        from .findings import finding
        finding("QT405", f"guarded call at site {site!r} exceeded the "
                f"{dl * 1e3:.0f}ms watchdog deadline", f"resilience.watchdog[{site}]")
        raise QuESTHangError(
            f"call at site {site!r} exceeded the {dl * 1e3:.0f}ms watchdog deadline "
            "[QT405]", "watchdog.watched", site=site, deadline_ms=dl * 1e3)
    if "err" in box:
        raise box["err"]
    return box["out"]
