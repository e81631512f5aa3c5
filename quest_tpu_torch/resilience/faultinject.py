"""Seeded, deterministic fault injection at the serving layer's named
sites (``quest_tpu/resilience/faultinject.py``, for the sites the Engine,
the EnginePool, checkpoints and segmented execution visit).

Each site calls :func:`fire` (or :func:`check`) once per visit; with no
plan installed the call returns None after one module boolean. A plan
(``QUEST_FAULTS`` or an explicit :class:`FaultPlan`) names which visit of
which site fails, and how::

    QUEST_FAULTS=site:kind:nth[,site:kind:nth...]

``nth`` is the 1-based visit at which the fault fires (``3``: the third
visit only; ``3+``: every visit from the third on). Visits are counted,
not sampled, so a plan replays identically run over run.

==================== =================== =================================
site                 kinds               effect
==================== =================== =================================
``engine.request``   ``poison``          PoisonedRequestFault pinned to one
                                         request at submit
``engine.dispatch``  ``hang, transient`` a hang inside one dispatch (the
                                         watchdog quarantines the engine)
                                         / TransientFault failing the batch
``pool.replica``     ``kill, hang``      one ``EnginePool`` dispatch attempt
                                         finds its replica dead: the pool
                                         quarantines it and fails the
                                         request over to a peer
``checkpoint.write`` ``torn, corrupt,``  a shard write: ``io`` fails it
                     ``io``              (TransientFault, retried);
                                         ``torn`` truncates the written
                                         file, ``corrupt`` flips one byte
                                         of its amplitude payload, for
                                         verification to catch
``segment.boundary`` ``preempt``         QuESTPreemptionError between two
                                         segments of a segmented run, after
                                         the checkpoint is durable
``state.corrupt``    ``bitflip[<N>]``    one bit of an amplitude flipped on
                                         shard N (default 0) by
                                         ``guard.corrupt_amps``, for the
                                         sentinels to catch
==================== =================== =================================

Every fired fault counts ``fault_injected_total{site,kind}``. A malformed
or unknown ``QUEST_FAULTS`` entry is skipped with a QT302 finding.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, NamedTuple

from .. import telemetry
from ..validation import QuESTError
from . import sync as _sync
from .errors import (InjectedFault, PoisonedRequestFault, QuESTPreemptionError,
                     TransientFault)

__all__ = ["SITES", "FaultSpec", "FaultPlan", "enabled", "active_plan",
           "install", "clear", "fault_plan", "fire", "check", "corrupt_file"]

ENV_VAR = "QUEST_FAULTS"

#: site -> the kinds a plan may inject there
SITES: dict[str, tuple[str, ...]] = {
    "engine.request": ("poison",),
    "engine.dispatch": ("hang", "transient"),
    "pool.replica": ("kill", "hang"),
    "checkpoint.write": ("torn", "corrupt", "io"),
    "segment.boundary": ("preempt",),
    "state.corrupt": ("bitflip",),
}

_EXC: dict[str, type[InjectedFault]] = {
    "transient": TransientFault,
    "io": TransientFault,
    "poison": PoisonedRequestFault,
}


def _kind_ok(site: str, kind: str) -> bool:
    """Catalog membership, plus ``bitflip<N>`` (N the shard) at
    ``state.corrupt``."""
    if kind in SITES[site]:
        return True
    return (site == "state.corrupt" and kind.startswith("bitflip")
            and kind[len("bitflip"):].isdigit())


class FaultSpec(NamedTuple):
    """One ``site:kind:nth`` entry; ``from_nth_on`` is the ``nth+`` form."""
    site: str
    kind: str
    nth: int
    from_nth_on: bool = False

    def matches(self, visit: int) -> bool:
        return visit >= self.nth if self.from_nth_on else visit == self.nth


class FaultPlan:
    """A parsed plan: its specs and per-site visit counters (a fresh plan
    restarts the numbering)."""

    def __init__(self, specs=()) -> None:
        self.specs: tuple[FaultSpec, ...] = tuple(specs)
        self._visits: dict[str, int] = {}
        self._lock = _sync.Lock("faultinject.plan")

    @classmethod
    def parse(cls, text: str, strict: bool = False) -> "FaultPlan":
        """Parse ``site:kind:nth[,...]``; a bad entry is skipped with a QT302
        finding, or raises with ``strict``."""
        specs = []
        for entry in filter(None, (e.strip() for e in text.split(","))):
            parts = entry.split(":")
            why = None
            if len(parts) != 3:
                why = "expected site:kind:nth"
            else:
                site, kind, nth_s = parts
                if site not in SITES:
                    why = f"unknown site (one of {sorted(SITES)})"
                elif not _kind_ok(site, kind):
                    why = f"kind not valid for site (one of {SITES[site]})"
                elif not nth_s.rstrip("+").isdigit() or int(nth_s.rstrip("+")) < 1:
                    why = "nth must be a positive integer (optionally 'N+')"
            if why is not None:
                if strict:
                    raise QuESTError(f"bad QUEST_FAULTS entry {entry!r}: {why} [QT302]",
                                     "FaultPlan.parse")
                from .findings import finding
                finding("QT302", f"QUEST_FAULTS entry {entry!r} ignored: {why}",
                        "resilience.faultinject")
                continue
            specs.append(FaultSpec(site, kind, int(nth_s.rstrip("+")), nth_s.endswith("+")))
        return cls(specs)

    def visits(self, site: str) -> int:
        """How many times ``site`` has been visited."""
        with self._lock:
            return self._visits.get(site, 0)

    def fire(self, site: str) -> str | None:
        """Record one visit of ``site``; the kind to inject now, or None."""
        with self._lock:
            visit = self._visits.get(site, 0) + 1
            self._visits[site] = visit
        for spec in self.specs:
            if spec.site == site and spec.matches(visit):
                telemetry.inc("fault_injected_total", site=site, kind=spec.kind)
                telemetry.event("resilience.fault", site=site, kind=spec.kind,
                                visit=visit)
                return spec.kind
        return None


_active: FaultPlan | None = None
_env_read = False
_state_lock = _sync.Lock("faultinject.state")


def _load_env() -> None:
    global _active, _env_read
    with _state_lock:
        if _env_read:
            return
        _env_read = True
        text = os.environ.get(ENV_VAR, "").strip()
        if text:
            plan = FaultPlan.parse(text)
            if plan.specs:
                _active = plan


def enabled() -> bool:
    """True when a plan is installed (``QUEST_FAULTS`` is read once)."""
    if not _env_read:
        _load_env()
    return _active is not None


def active_plan() -> FaultPlan | None:
    if not _env_read:
        _load_env()
    return _active


def install(plan: FaultPlan | str | None) -> None:
    """Install ``plan`` (a :class:`FaultPlan`, a spec string, or None to
    disable)."""
    global _active, _env_read
    with _state_lock:
        _env_read = True
        _active = FaultPlan.parse(plan, strict=True) if isinstance(plan, str) else plan


def clear() -> None:
    install(None)


@contextlib.contextmanager
def fault_plan(plan: FaultPlan | str) -> Iterator[FaultPlan | None]:
    """Install ``plan`` for the block; the previous plan and its visit
    counters come back on exit."""
    global _active, _env_read
    prev, prev_read = _active, _env_read
    install(plan)
    try:
        yield active_plan()
    finally:
        with _state_lock:
            _active, _env_read = prev, prev_read


def fire(site: str) -> str | None:
    """The injection site: None when disabled, else the plan's verdict for
    this visit."""
    if _active is None and _env_read:
        return None
    if not enabled():
        return None
    plan = _active
    return plan.fire(site) if plan is not None else None


def check(site: str) -> None:
    """Visit ``site`` and raise its typed fault if the plan says so."""
    kind = fire(site)
    if kind is None:
        return
    exc = _EXC.get(kind)
    if exc is not None:
        raise exc(site, kind)
    if kind == "preempt":
        raise QuESTPreemptionError(f"injected preemption at site {site!r}", site)
    raise QuESTError(f"fault kind {kind!r} at {site!r} needs its own handler "
                     "(corrupt_file, guard.corrupt_amps, watchdog.watched)",
                     "faultinject.check")


def corrupt_file(site: str, path: str) -> str | None:
    """Visit ``site`` and apply a file-level fault to ``path``: ``torn``
    truncates its tail half, ``corrupt`` flips the byte in its middle; a
    raisable kind raises. Returns the kind applied, or None."""
    kind = fire(site)
    if kind is None:
        return None
    if kind in ("torn", "corrupt"):
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            if kind == "torn":
                f.truncate(max(1, size // 2))
            else:
                f.seek(size // 2)
                b = f.read(1)
                f.seek(size // 2)
                f.write(bytes([(b[0] ^ 0xFF) if b else 0xFF]))
        return kind
    exc = _EXC.get(kind)
    if exc is not None:
        raise exc(site, kind)
    return kind
