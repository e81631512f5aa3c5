"""Diagnostic findings of the resilience layer: a catalog code, where it
was found and what is wrong, counted on the telemetry registry as
``analysis_findings_total{code,severity}`` (the JAX package's
``analysis.diagnostics.make_finding`` / ``emit_findings``, for the codes
the serving layer raises).

- QT302 a malformed ``QUEST_FAULTS`` entry, QT303 a malformed numeric
  knob (``QUEST_WATCHDOG_MS``, ``QUEST_ENGINE_QUEUE_MAX``, the
  ``QUEST_RETRY_*`` knobs), QT605 a
  malformed ``QUEST_CONCHECK``, QT307 a malformed ``QUEST_TENANT_QPS``,
  ``QUEST_POOL_REPLICAS`` or ``QUEST_HEDGE_MS``,
  QT403 a malformed ``QUEST_SENTINEL`` entry, QT801 a malformed
  ``QUEST_SHOTS`` (``sampling.request``), QT501 a malformed
  ``QUEST_TRAJECTORIES`` (``trajectories.ensemble``), QT305 a checkpoint
  generation that failed verification (``resilience.segmented``, which
  falls back to an older one): warnings;
- QT304 a segmented-execution misconfiguration (``every_n_items`` or
  ``keep`` below 1, a tape that does not end at the identity frame),
  QT401 / QT402 / QT404 a sentinel breach (norm, shard checksum, density
  trace), QT405 a watchdog deadline, QT602 a blocking boundary crossed
  while holding an instrumented lock: errors.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass

from .. import telemetry

#: severity of each code this package emits
SEVERITY = {"QT302": "warning", "QT303": "warning", "QT305": "warning", "QT307": "warning",
            "QT403": "warning", "QT501": "warning", "QT605": "warning", "QT801": "warning",
            "QT304": "error", "QT401": "error",
            "QT402": "error", "QT404": "error", "QT405": "error",
            "QT602": "error"}


@dataclass(frozen=True)
class Finding:
    """One diagnostic."""
    code: str
    severity: str
    message: str
    location: str

    def __str__(self) -> str:
        return f"{self.code} [{self.severity}] {self.location}: {self.message}"


def finding(code: str, message: str, location: str) -> Finding:
    """Make the finding ``code`` and count it."""
    f = Finding(code, SEVERITY[code], message, location)
    telemetry.inc("analysis_findings_total", code=f.code, severity=f.severity)
    return f


def env_int(env: str, default: int, *, minimum: int, code: str, warned: set,
            noun: str = "value") -> int:
    """The integer knob ``env``: ``default`` when unset; a malformed value
    falls back to ``default`` with a warning finding ``code``, a value
    below ``minimum`` is clamped to it (warned once per raw value)."""
    raw = os.environ.get(env, "").strip()
    if not raw:
        return default
    try:
        v = int(raw)
    except ValueError:
        v, why = default, f"is not an integer; using {default}"
    else:
        if v >= minimum:
            return v
        v, why = minimum, f"is below {minimum}; using {minimum}"
    if raw not in warned:
        warned.add(raw)
        f = finding(code, f"{env}={raw!r} {why} ({noun})", env)
        warnings.warn(str(f), RuntimeWarning, stacklevel=3)
    return v
