"""Per-tenant admission control (``quest_tpu/engine/admission.py``): the
front door a replica pool puts before its engines.

- :class:`TokenBucket` -- ``rate`` tokens a second up to ``burst``,
  refilled on read, whose bottom ``reserve_frac`` is reserved for
  ``high``-priority requests: a ``normal`` take must leave the reserve, so
  no volume of normal traffic starves the next high request.
- :class:`AdmissionController` -- one bucket per tenant (made at first use
  from a default QPS or a per-tenant ``quotas`` map), the
  ``admission_{admitted,rejected,queued}_total{tenant,priority}``
  counters, and the typed rejection
  :class:`~quest_tpu_torch.resilience.QuESTBackpressureError` with
  ``reason="quota"`` (also counted as ``engine_backpressure_total{reason=
  quota}``).

The default quota is ``QUEST_TENANT_QPS`` (requests a second per tenant; 0
or unset: unlimited; a malformed value warns once with QT307). Time is
injectable (``clock``), so the tests run on a fake clock.
"""

from __future__ import annotations

import time

from .. import telemetry
from ..resilience import sync as _sync
from ..resilience.errors import QuESTBackpressureError

__all__ = ["PRIORITIES", "TokenBucket", "AdmissionController"]

#: admission priority classes, most urgent first
PRIORITIES = ("high", "normal")

_QPS_WARNED: set = set()


def _env_tenant_qps() -> int:
    from ..resilience.findings import env_int
    return env_int("QUEST_TENANT_QPS", 0, minimum=0, code="QT307", warned=_QPS_WARNED,
                   noun="tenant QPS quota")


class TokenBucket:
    """Thread-safe token bucket with a high-priority reserve.

    ``rate`` tokens accrue a second up to ``burst`` (default ``max(rate,
    1)``). :meth:`take` refills from ``clock`` and admits ``n`` tokens'
    worth: ``high`` needs ``n`` tokens, ``normal`` must also leave
    ``reserve_frac * burst`` behind. The bucket starts full."""

    def __init__(self, rate: float, burst: float | None = None, *,
                 reserve_frac: float = 0.25, clock=time.monotonic):
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        if not 0.0 <= reserve_frac < 1.0:
            raise ValueError(f"reserve_frac must be in [0, 1), got {reserve_frac}")
        self.rate = float(rate)
        self.burst = float(burst) if burst is not None else max(rate, 1.0)
        if self.burst < 1.0:
            raise ValueError(f"burst must be >= 1, got {self.burst}")
        #: tokens a ``normal`` take must leave (the high reserve)
        self.reserve = reserve_frac * self.burst
        self._clock = clock
        self._tokens = self.burst
        self._last = clock()
        self._lock = _sync.Lock("admission.bucket")

    def _refill_locked(self) -> None:
        now = self._clock()
        if now > self._last:
            self._tokens = min(self.burst, self._tokens + (now - self._last) * self.rate)
        self._last = now

    def tokens(self) -> float:
        """The token count now (refilled first)."""
        with self._lock:
            self._refill_locked()
            return self._tokens

    def take(self, n: int = 1, *, priority: str = "normal") -> bool:
        """Take ``n`` tokens, or return False taking none."""
        if priority not in PRIORITIES:
            raise ValueError(f"priority must be one of {PRIORITIES}, got {priority!r}")
        with self._lock:
            self._refill_locked()
            floor = 0.0 if priority == "high" else self.reserve
            if self._tokens - n < floor - 1e-9:
                return False
            self._tokens -= n
            return True


class AdmissionController:
    """Per-tenant quotas before a pool of engines. ``default_qps`` (None:
    ``QUEST_TENANT_QPS``; 0: unlimited) seeds a tenant's bucket at first
    use; ``quotas`` maps tenants to their own QPS (0: no quota).
    :meth:`admit` counts the admission or raises the quota rejection; it
    never blocks."""

    def __init__(self, default_qps: int | None = None, *, burst: float | None = None,
                 quotas: dict | None = None, reserve_frac: float = 0.25,
                 clock=time.monotonic):
        if default_qps is None:
            default_qps = _env_tenant_qps()
        if default_qps < 0:
            raise ValueError(f"default_qps must be >= 0, got {default_qps}")
        self.default_qps = int(default_qps)
        self.burst = burst
        self.reserve_frac = float(reserve_frac)
        self.quotas = dict(quotas or {})
        self._clock = clock
        self._buckets: dict[str, TokenBucket | None] = {}
        self._lock = _sync.Lock("admission.controller")

    def bucket(self, tenant: str) -> TokenBucket | None:
        """The tenant's bucket (made at first use); None: unlimited."""
        with self._lock:
            if tenant not in self._buckets:
                qps = self.quotas.get(tenant, self.default_qps)
                self._buckets[tenant] = None if not qps else TokenBucket(
                    qps, self.burst, reserve_frac=self.reserve_frac, clock=self._clock)
            return self._buckets[tenant]

    def admit(self, tenant: str, priority: str = "normal", n: int = 1) -> None:
        """Admit ``n`` requests of ``tenant`` or raise QuESTBackpressureError
        with ``reason="quota"``."""
        if priority not in PRIORITIES:
            raise ValueError(f"priority must be one of {PRIORITIES}, got {priority!r}")
        b = self.bucket(tenant)
        if b is not None and not b.take(n, priority=priority):
            telemetry.inc("admission_rejected_total", n, tenant=tenant, priority=priority)
            telemetry.inc("engine_backpressure_total", reason="quota")
            raise QuESTBackpressureError(
                f"tenant {tenant!r} is over its admission quota ({b.rate:g} req/s, "
                f"burst {b.burst:g}): rejecting {n} {priority}-priority request(s)",
                "EnginePool.submit", reason="quota")
        telemetry.inc("admission_admitted_total", n, tenant=tenant, priority=priority)

    def note_queued(self, tenant: str, priority: str, n: int = 1) -> None:
        """Count requests admitted but parked (no engine could take them yet)."""
        telemetry.inc("admission_queued_total", n, tenant=tenant, priority=priority)
