"""Deadline-aware exponential backoff with deterministic jitter
(``quest_tpu/resilience/retry.py``).

Backoff is the standard capped-exponential-with-full-jitter shape, but the
jitter stream is seeded (``random.Random(seed)``), so a retry schedule --
like the fault plan it answers -- replays identically run over run. The
``EnginePool``'s hedged dispatch retries through it (site ``pool.hedge``).

Every attempt counts ``retry_attempts_total{site,outcome}``:

- ``ok``        -- the attempt succeeded after at least one failure
                   (first-try successes are NOT counted, so the series
                   stays silent on healthy traffic),
- ``retried``   -- the attempt failed and another follows,
- ``exhausted`` -- the attempt failed and the budget (attempts or
                   deadline) is spent; the last error propagates.

Env knobs (read at each :func:`default_policy`; a malformed value falls
back to the default with a QT303 finding): ``QUEST_RETRY_MAX`` (attempts,
default 3), ``QUEST_RETRY_BASE_MS`` (first backoff, default 5),
``QUEST_RETRY_DEADLINE_MS`` (total budget, default unset = attempts only).
"""

from __future__ import annotations

import os
import random
import time
import warnings
from dataclasses import dataclass
from typing import Callable, TypeVar

from .. import telemetry
from .errors import TransientFault

__all__ = ["RetryPolicy", "call_with_retry", "default_policy"]

T = TypeVar("T")

_DEF_ATTEMPTS = 3
_DEF_BASE_MS = 5.0
_DEF_MULTIPLIER = 2.0
_DEF_MAX_DELAY_MS = 100.0

_ENV_WARNED: set = set()


def _env_float(name: str, default: float | None) -> float | None:
    """The numeric knob ``name``; a malformed value is ``default`` with a
    QT303 warning finding (once per knob and raw value)."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        if (name, raw) not in _ENV_WARNED:
            _ENV_WARNED.add((name, raw))
            from .findings import finding
            f = finding("QT303", f"{name}={raw!r} is not numeric; using the default",
                        "resilience.retry")
            warnings.warn(str(f), RuntimeWarning, stacklevel=3)
        return default


@dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with seeded full jitter and an optional
    wall-clock deadline over the whole retry span."""

    max_attempts: int = _DEF_ATTEMPTS
    base_delay_s: float = _DEF_BASE_MS / 1e3
    multiplier: float = _DEF_MULTIPLIER
    max_delay_s: float = _DEF_MAX_DELAY_MS / 1e3
    deadline_s: float | None = None
    seed: int = 0

    def delays(self):
        """The deterministic backoff schedule: one delay per retry, drawn
        uniformly in ``[base * mult^i / 2, base * mult^i]`` (capped)."""
        rng = random.Random(self.seed)
        d = self.base_delay_s
        for _ in range(max(0, self.max_attempts - 1)):
            cap = min(d, self.max_delay_s)
            yield rng.uniform(cap / 2, cap)
            d *= self.multiplier


def default_policy(seed: int = 0) -> RetryPolicy:
    """The env-configured policy (see the module docstring for the knobs)."""
    attempts = _env_float("QUEST_RETRY_MAX", float(_DEF_ATTEMPTS))
    base_ms = _env_float("QUEST_RETRY_BASE_MS", _DEF_BASE_MS)
    deadline_ms = _env_float("QUEST_RETRY_DEADLINE_MS", None)
    if attempts is None or attempts < 1:
        attempts = float(_DEF_ATTEMPTS)
    return RetryPolicy(
        max_attempts=int(attempts),
        base_delay_s=float(base_ms or _DEF_BASE_MS) / 1e3,
        deadline_s=None if deadline_ms is None else deadline_ms / 1e3,
        seed=seed)


def call_with_retry(fn: Callable[[], T], *, site: str,
                    policy: RetryPolicy | None = None,
                    retryable: tuple = (TransientFault,),
                    sleep: Callable[[float], None] = time.sleep) -> T:
    """Run ``fn`` under ``policy``; retry on ``retryable`` with backoff,
    re-raise the last error once attempts or the deadline are spent.
    Non-retryable exceptions propagate at once (attempt 1 included)."""
    pol = policy if policy is not None else default_policy()
    t0 = time.monotonic()
    failed = False
    delays = pol.delays()
    for attempt in range(1, pol.max_attempts + 1):
        try:
            out = fn()
        except retryable as e:
            over_deadline = (pol.deadline_s is not None
                             and time.monotonic() - t0 >= pol.deadline_s)
            if attempt >= pol.max_attempts or over_deadline:
                telemetry.inc("retry_attempts_total", site=site, outcome="exhausted")
                telemetry.event("resilience.retry_exhausted", site=site, attempts=attempt,
                                deadline=bool(over_deadline), error=type(e).__name__)
                raise
            failed = True
            telemetry.inc("retry_attempts_total", site=site, outcome="retried")
            delay = next(delays, pol.base_delay_s)
            if pol.deadline_s is not None:
                delay = min(delay, max(0.0, pol.deadline_s - (time.monotonic() - t0)))
            sleep(delay)
        else:
            if failed:
                telemetry.inc("retry_attempts_total", site=site, outcome="ok")
            return out
    raise AssertionError("unreachable")  # pragma: no cover
