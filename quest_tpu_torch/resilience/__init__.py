"""The resilience layer the serving Engine stands on
(``quest_tpu/resilience``, for the parts the Engine calls):

- :mod:`.errors` -- the typed failures (``QuESTTimeoutError``,
  ``QuESTBackpressureError`` with ``reason``, ``QuESTCancelledError``,
  ``QuESTIntegrityError``, ``QuESTHangError``, ``QuESTRetryError``) and the
  injected faults (``InjectedFault``, ``TransientFault``,
  ``KernelCompileFault``, ``PoisonedRequestFault``);
- :mod:`.retry` -- seeded, deadline-aware exponential backoff
  (``RetryPolicy``, ``default_policy``, ``call_with_retry``), counted
  ``retry_attempts_total{site,outcome}``;
- :mod:`.sync` -- named, instrumented locks and conditions, the
  ``resolve_future`` / ``join_thread`` / ``guard_blocking`` helpers and
  their QT602 checks (``QUEST_CONCHECK=1``);
- :mod:`.faultinject` -- seeded fault plans (``QUEST_FAULTS``) at the
  sites ``engine.request``, ``engine.dispatch``, ``pool.replica`` and
  ``state.corrupt``;
- :mod:`.watchdog` -- deadlines around a dispatch (``QUEST_WATCHDOG_MS``);
- :mod:`.sentinel` -- norm, shard-checksum and trace checks on a result
  (``QUEST_SENTINEL``), as torch reductions on its device;
- :mod:`.guard` -- ``corrupt_amps``;
- :mod:`.findings` -- the QT diagnostics they emit.

The rest of the JAX package's layer (segmented execution and
checkpoints, the lock-order graph, collective guards) is not ported yet.
"""

from .errors import (  # noqa: F401
    InjectedFault, KernelCompileFault, PoisonedRequestFault, QuESTBackpressureError,
    QuESTCancelledError, QuESTHangError, QuESTIntegrityError, QuESTRetryError,
    QuESTTimeoutError, TransientFault,
)
from . import faultinject, guard, retry, sentinel, sync, watchdog  # noqa: F401
from .retry import RetryPolicy, call_with_retry, default_policy  # noqa: F401
from .faultinject import (  # noqa: F401
    SITES, FaultPlan, FaultSpec, active_plan, clear, enabled, fault_plan,
    fire, install,
)
from .sentinel import SentinelPolicy, SentinelSpec, sentinel_policy  # noqa: F401
from .sync import (  # noqa: F401
    checking, guard_blocking, held_locks, join_thread, resolve_future,
)
from .watchdog import watchdog_deadline  # noqa: F401

__all__ = [
    "QuESTTimeoutError", "QuESTBackpressureError", "QuESTCancelledError",
    "QuESTIntegrityError", "QuESTHangError", "QuESTRetryError",
    "InjectedFault", "TransientFault", "KernelCompileFault", "PoisonedRequestFault",
    "retry", "RetryPolicy", "default_policy", "call_with_retry",
    "SITES", "FaultPlan", "FaultSpec", "enabled", "active_plan", "install",
    "clear", "fault_plan", "fire",
    "sentinel", "SentinelPolicy", "SentinelSpec", "sentinel_policy",
    "watchdog", "watchdog_deadline", "guard",
    "sync", "checking", "held_locks", "guard_blocking", "resolve_future",
    "join_thread",
]
