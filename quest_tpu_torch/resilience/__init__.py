"""The resilience layer (``quest_tpu/resilience``): what the serving
Engine, checkpoints and segmented execution stand on.

- :mod:`.errors` -- the typed failures (``QuESTTimeoutError``,
  ``QuESTBackpressureError`` with ``reason``, ``QuESTCancelledError``,
  ``QuESTPreemptionError`` with the resume cursor, ``QuESTIntegrityError``,
  ``QuESTHangError``, ``QuESTRetryError``, ``QuESTChecksumError`` with the
  shard and both CRCs) and the injected faults (``InjectedFault``,
  ``TransientFault``, ``KernelCompileFault``, ``PoisonedRequestFault``);
- :mod:`.retry` -- seeded, deadline-aware exponential backoff
  (``RetryPolicy``, ``default_policy``, ``call_with_retry``), counted
  ``retry_attempts_total{site,outcome}``;
- :mod:`.sync` -- named, instrumented locks and conditions, the
  ``resolve_future`` / ``join_thread`` / ``guard_blocking`` helpers and
  their QT602 checks (``QUEST_CONCHECK=1``);
- :mod:`.faultinject` -- seeded fault plans (``QUEST_FAULTS``) at the
  sites ``engine.request``, ``engine.dispatch``, ``pool.replica``,
  ``checkpoint.write``, ``segment.boundary`` and ``state.corrupt``;
- :mod:`.watchdog` -- deadlines around a dispatch (``QUEST_WATCHDOG_MS``);
- :mod:`.sentinel` -- norm, shard-checksum and trace checks on a result
  (``QUEST_SENTINEL``), as torch reductions on its device;
- :mod:`.guard` -- ``checkpoint_write``, ``segment_boundary``,
  ``corrupt_amps`` and the self-healing lattice ``sentinel_replay``;
- :mod:`.segmented` -- ``Circuit.run_segmented`` / :func:`resume_segmented`:
  checkpointed execution at frame-identity boundaries, resumed from the
  newest CRC-verified generation, with sentinel rollback and replay;
- :mod:`.findings` -- the QT diagnostics they emit.

The rest of the JAX package's layer (the lock-order graph, the
``pallas.dispatch``, ``exchange.collective`` and ``engine.retire`` guards)
is not ported yet.
"""

from .errors import (  # noqa: F401
    InjectedFault, KernelCompileFault, PoisonedRequestFault, QuESTBackpressureError,
    QuESTCancelledError, QuESTChecksumError, QuESTHangError, QuESTIntegrityError,
    QuESTPreemptionError, QuESTRetryError, QuESTTimeoutError, TransientFault,
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
from . import segmented  # noqa: F401
from .segmented import resume_segmented, run_segmented, segment_plan  # noqa: F401

__all__ = [
    "QuESTTimeoutError", "QuESTBackpressureError", "QuESTCancelledError",
    "QuESTPreemptionError", "QuESTIntegrityError", "QuESTHangError", "QuESTRetryError",
    "QuESTChecksumError", "InjectedFault", "TransientFault", "KernelCompileFault",
    "PoisonedRequestFault",
    "retry", "RetryPolicy", "default_policy", "call_with_retry",
    "SITES", "FaultPlan", "FaultSpec", "enabled", "active_plan", "install",
    "clear", "fault_plan", "fire",
    "sentinel", "SentinelPolicy", "SentinelSpec", "sentinel_policy",
    "watchdog", "watchdog_deadline", "guard",
    "sync", "checking", "held_locks", "guard_blocking", "resolve_future",
    "join_thread", "segmented", "segment_plan", "run_segmented", "resume_segmented",
]
