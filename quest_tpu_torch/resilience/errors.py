"""Typed failures of the serving layer (``quest_tpu/resilience/errors.py``).

Each failure mode carries its own type, so that a caller -- and the
Engine's batcher -- can route it: isolate a :class:`PoisonedRequestFault`
to its request, shed load on :class:`QuESTBackpressureError`, report a
deadline as :class:`QuESTTimeoutError`, quarantine on
:class:`QuESTHangError` or :class:`QuESTIntegrityError`, resume after
:class:`QuESTPreemptionError`, fall back to an older checkpoint generation
after :class:`QuESTChecksumError`.

Injected faults (raised by :mod:`.faultinject` at named sites) derive from
:class:`InjectedFault`; the terminal errors derive from the port's
:class:`~quest_tpu_torch.validation.QuESTError`, so an ``except
QuESTError`` handler keeps working.
"""

from __future__ import annotations

from typing import Iterable

from ..validation import QuESTError

__all__ = [
    "QuESTTimeoutError", "QuESTBackpressureError", "QuESTCancelledError",
    "QuESTPreemptionError", "QuESTIntegrityError", "QuESTHangError", "QuESTRetryError",
    "QuESTChecksumError", "InjectedFault", "TransientFault", "KernelCompileFault",
    "PoisonedRequestFault",
]


class QuESTTimeoutError(QuESTError):
    """A request's deadline expired before the engine dispatched it."""


class QuESTBackpressureError(QuESTError):
    """The submit was rejected rather than growing a queue without bound:
    the engine queue is at ``queue_max``, the engine is quarantined, or a
    tenant's admission quota is spent. ``reason`` is the
    ``engine_backpressure_total{reason}`` label (``"queue"``,
    ``"quarantined"``, ``"quota"``)."""

    def __init__(self, message: str, func: str = "",
                 reason: str | None = None) -> None:
        super().__init__(message, func)
        self.reason = reason


class QuESTCancelledError(QuESTError):
    """The request was dropped by ``Engine.close(drain=False)`` before
    dispatch; its future resolves with this instead of dangling."""


class QuESTPreemptionError(QuESTError):
    """Execution was preempted between segments of a segmented run.
    Carries ``cursor`` (the tape index of the last durable checkpoint) and
    ``checkpoint_dir``, which a caller hands straight to
    :func:`~quest_tpu_torch.resilience.segmented.resume_segmented`."""

    def __init__(self, message: str, func: str = "",
                 cursor: int | None = None,
                 checkpoint_dir: str | None = None) -> None:
        super().__init__(message, func)
        self.cursor = cursor
        self.checkpoint_dir = checkpoint_dir


class QuESTRetryError(QuESTError):
    """A retryable site stayed faulty past the retry policy's attempt or
    deadline budget and has no degradation path (fail closed): an
    ``EnginePool`` request that failed over more often than the pool has
    replicas to try settles with it."""


class QuESTIntegrityError(QuESTError):
    """An integrity sentinel (:mod:`.sentinel`) found a corrupt result:
    norm or trace outside the precision band, or a shard whose checksum
    is not finite or out of range. Carries the sentinel ``findings``."""

    def __init__(self, message: str, func: str = "",
                 findings: Iterable[object] = ()) -> None:
        super().__init__(message, func)
        self.findings = list(findings)


class QuESTHangError(QuESTError):
    """A watchdog deadline (``QUEST_WATCHDOG_MS``) expired around an engine
    dispatch or a device sync: the caller gets this typed error instead of
    blocking forever. Carries ``site`` and the ``deadline_ms`` enforced."""

    def __init__(self, message: str, func: str = "",
                 site: str | None = None,
                 deadline_ms: float | None = None) -> None:
        super().__init__(message, func)
        self.site = site
        self.deadline_ms = deadline_ms


class QuESTChecksumError(QuESTError):
    """A stored payload failed CRC32 verification: the bytes on disk are not
    the bytes indexed at write time. Carries the ``shard`` file name, the
    ``expected_crc`` (the index's) and the ``actual_crc`` (the payload's),
    so a fall-back path (segmented resume, QT305) can report both."""

    def __init__(self, message: str, func: str = "",
                 shard: str | None = None,
                 expected_crc: int | None = None,
                 actual_crc: int | None = None) -> None:
        super().__init__(message, func)
        self.shard = shard
        self.expected_crc = expected_crc
        self.actual_crc = actual_crc


class InjectedFault(RuntimeError):
    """Base of the faults :mod:`.faultinject` raises at a named site
    (never raised when no fault plan is installed)."""

    def __init__(self, site: str, kind: str) -> None:
        super().__init__(f"injected {kind} fault at site {site!r}")
        self.site = site
        self.kind = kind


class TransientFault(InjectedFault):
    """A fault a retry is expected to clear; at ``engine.dispatch`` it
    fails one batch, which the batcher then bisects."""


class KernelCompileFault(InjectedFault):
    """A permanent kernel-route failure (a build error): retrying cannot
    help, so :mod:`.retry` never retries it."""


class PoisonedRequestFault(InjectedFault):
    """One poisoned request inside an engine batch: the batcher isolates
    it to its own future and does not fail its neighbours."""
