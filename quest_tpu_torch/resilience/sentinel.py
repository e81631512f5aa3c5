"""Online integrity sentinels: cheap invariants on a result state that
catch silent data corruption before it is served
(``quest_tpu/resilience/sentinel.py``), as torch reductions on the
state's own device.

Three kinds (:data:`KINDS`):

- ``norm`` -- the total probability stays 1 within a band for the dtype
  (:func:`tolerance`); on a density register Re tr(rho). QT401 (QT404 on
  a density register) on a breach.
- ``checksum`` -- each shard's partial sum of |amp|^2 must be finite and
  in [0, 1] within the band, and so must their total; the QT402 finding
  names the shard at fault. An unsharded state is one shard.
- ``trace`` -- density registers: Re tr(rho) and hermiticity (max |rho -
  rho^H|) within the band, QT404 on a breach; ``outcome=skipped`` on a
  state vector.

Configuration (``QUEST_SENTINEL``, read once, or a :class:`SentinelPolicy`)::

    QUEST_SENTINEL=norm:every_2,checksum:segment
    QUEST_SENTINEL=default          # norm + checksum, every opportunity

Each entry is ``kind[:cadence]``: ``segment`` (every opportunity, the
default), ``every_N`` or ``N``. A malformed entry is skipped with a QT403
finding. Every check run counts ``sentinel_checks_total{kind,outcome}``
(``ok``, ``breach``, ``skipped``); with no policy armed a probe point is
one module boolean.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Iterable, Iterator, NamedTuple

import torch

from .. import telemetry
from ..validation import QuESTError
from . import sync as _sync

__all__ = ["KINDS", "ENV_VAR", "DEFAULT_SPEC", "SentinelSpec", "SentinelPolicy",
           "enabled", "active_policy", "install", "clear", "sentinel_policy",
           "tolerance", "check_amps", "check_qureg"]

ENV_VAR = "QUEST_SENTINEL"

KINDS: tuple[str, ...] = ("norm", "checksum", "trace")

#: what ``QUEST_SENTINEL=default`` (or ``1``, ``on``) arms
DEFAULT_SPEC = "norm:segment,checksum:segment"

#: the drift band |total - 1| must stay inside, by real dtype
_TOL = {torch.float32: 1e-4, torch.float64: 1e-9}


def tolerance(dtype) -> float:
    """The band for a register of real ``dtype`` (f32's for any other)."""
    return _TOL.get(dtype, 1e-4)


class SentinelSpec(NamedTuple):
    """One armed sentinel and its cadence, in check opportunities (the
    Engine's dispatches)."""
    kind: str
    cadence: int = 1

    def due(self, tick: int) -> bool:
        return tick % self.cadence == 0


class SentinelPolicy:
    """A parsed policy: which kinds run, at what cadence."""

    def __init__(self, specs: Iterable[SentinelSpec] = ()) -> None:
        self.specs: tuple[SentinelSpec, ...] = tuple(specs)

    @classmethod
    def parse(cls, text: str, strict: bool = False) -> "SentinelPolicy":
        """Parse ``kind[:cadence][,...]``; ``default``/``on``/``1`` arm
        :data:`DEFAULT_SPEC`, ``off``/``0`` nothing. A bad entry is skipped
        with a QT403 finding, or raises with ``strict``."""
        low = text.strip().lower()
        if low in ("", "off", "0", "none"):
            return cls(())
        if low in ("default", "on", "1"):
            text = DEFAULT_SPEC
        specs = []
        for entry in filter(None, (e.strip() for e in text.split(","))):
            parts = entry.split(":")
            kind, cad = parts[0], (parts[1] if len(parts) == 2 else "segment")
            why, cadence = None, 1
            if len(parts) > 2:
                why = "expected kind[:cadence]"
            elif kind not in KINDS:
                why = f"unknown kind (one of {KINDS})"
            else:
                c = cad[len("every_"):] if cad.startswith("every_") else cad
                if c == "segment":
                    cadence = 1
                elif c.isdigit() and int(c) >= 1:
                    cadence = int(c)
                else:
                    why = "cadence must be 'segment', 'every_N' or a positive integer"
            if why is not None:
                if strict:
                    raise QuESTError(f"bad {ENV_VAR} entry {entry!r}: {why} [QT403]",
                                     "SentinelPolicy.parse")
                from .findings import finding
                finding("QT403", f"{ENV_VAR} entry {entry!r} ignored: {why}",
                        "resilience.sentinel")
                continue
            specs.append(SentinelSpec(kind, cadence))
        return cls(specs)

    def due_kinds(self, tick: int) -> tuple[str, ...]:
        """The kinds due at 1-based opportunity ``tick``, deduplicated."""
        seen: list[str] = []
        for s in self.specs:
            if s.due(tick) and s.kind not in seen:
                seen.append(s.kind)
        return tuple(seen)


_active: SentinelPolicy | None = None
_env_read = False
_state_lock = _sync.Lock("sentinel.state")


def _load_env() -> None:
    global _active, _env_read
    with _state_lock:
        if _env_read:
            return
        _env_read = True
        text = os.environ.get(ENV_VAR, "").strip()
        if text:
            pol = SentinelPolicy.parse(text)
            if pol.specs:
                _active = pol


def enabled() -> bool:
    """True when a policy is armed (``QUEST_SENTINEL`` is read once)."""
    if not _env_read:
        _load_env()
    return _active is not None


def active_policy() -> SentinelPolicy | None:
    if not _env_read:
        _load_env()
    return _active


def install(policy: SentinelPolicy | str | None) -> None:
    """Arm ``policy`` (a :class:`SentinelPolicy`, a spec string, or None)."""
    global _active, _env_read
    with _state_lock:
        _env_read = True
        if isinstance(policy, str):
            policy = SentinelPolicy.parse(policy, strict=True)
        _active = policy if (policy is None or policy.specs) else None


def clear() -> None:
    install(None)


@contextlib.contextmanager
def sentinel_policy(policy: SentinelPolicy | str) -> Iterator[SentinelPolicy | None]:
    """Arm ``policy`` for the block; the previous one comes back on exit."""
    global _active, _env_read
    prev, prev_read = _active, _env_read
    install(policy)
    try:
        yield active_policy()
    finally:
        with _state_lock:
            _active, _env_read = prev, prev_read


def _finding(code: str, message: str, where: str):
    from .findings import finding
    return finding(code, message, where or "resilience.sentinel")


def _shards(amps) -> list:
    return list(amps) if isinstance(amps, (list, tuple)) else [amps]


def _norm_total(amps, density: bool, n: int) -> float:
    from ..ops import reduce as R
    if isinstance(amps, (list, tuple)):
        return float(R.total_prob_shards(list(amps)))
    if density:
        return float(R.total_prob_density(amps, n=n))
    return float(R.total_prob_statevec(amps))


def _check_norm(amps, density, n, tol, where):
    total = _norm_total(amps, density, n)
    code, what = ("QT404", "Re tr(rho)") if density else ("QT401", "total probability")
    drift = abs(total - 1.0)
    if math.isfinite(total) and drift <= tol:
        return None
    return _finding(code, f"{what} {total!r} drifted |delta|={drift:.3e} beyond the "
                    f"{tol:.1e} band for dtype {_shards(amps)[0].dtype}", where)


def _check_checksum(amps, tol, where):
    from ..ops import reduce as R
    partials = [float(R.total_prob_statevec(s)) for s in _shards(amps)]
    total = math.fsum(partials)
    bad = [i for i, p in enumerate(partials)
           if not math.isfinite(p) or p < -tol or p > 1.0 + tol]
    if not bad and math.isfinite(total) and -tol <= total <= 1.0 + tol:
        return None
    shard = bad[0] if bad else 0
    return _finding("QT402", f"per-shard checksum divergence: shard {shard} partial "
                    f"|amps|^2 = {partials[shard]!r} (total {total!r}, band {tol:.1e}, "
                    f"{len(partials)} shard(s))", where)


def _check_trace(amps, density, n, tol, where):
    if not density:
        return "skipped"
    from ..ops import reduce as R
    total = float(R.total_prob_density(amps, n=n))
    dim = 1 << n
    re, im = amps[0].reshape(dim, dim), amps[1].reshape(dim, dim)
    asym = max(float((re - re.T).abs().max()), float((im + im.T).abs().max()))
    drift = abs(total - 1.0)
    if math.isfinite(total) and drift <= tol and math.isfinite(asym) and asym <= tol:
        return None
    return _finding("QT404", f"density register breached trace/hermiticity: Re tr(rho) "
                    f"= {total!r} (|delta|={drift:.3e}), max |rho - rho^H| = "
                    f"{asym:.3e}, band {tol:.1e}", where)


def check_amps(amps, *, density: bool = False, n: int | None = None,
               policy: SentinelPolicy | None = None, tick: int = 1,
               where: str = "") -> list:
    """Run every armed sentinel due at opportunity ``tick`` on a planar
    state (a tensor, or a sharded state's list of shards); returns the
    breach findings (empty: clean). ``n`` is the represented qubit count
    (a density register's trace needs it)."""
    pol = policy if policy is not None else active_policy()
    if pol is None or not pol.specs:
        return []
    first = _shards(amps)[0]
    if n is None:
        nsv = int(sum(s.shape[-1] for s in _shards(amps))).bit_length() - 1
        n = nsv // (2 if density else 1)
    tol = tolerance(first.dtype)
    findings = []
    for kind in pol.due_kinds(tick):
        if kind == "norm":
            out = _check_norm(amps, density, n, tol, where)
        elif kind == "checksum":
            out = _check_checksum(amps, tol, where)
        else:
            out = _check_trace(amps, density, n, tol, where)
        outcome = "skipped" if out == "skipped" else "ok" if out is None else "breach"
        telemetry.inc("sentinel_checks_total", kind=kind, outcome=outcome)
        if outcome == "breach":
            telemetry.event("resilience.sentinel_breach", kind=kind, code=out.code,
                            where=where)
            findings.append(out)
    return findings


def check_qureg(qureg, *, policy: SentinelPolicy | None = None, tick: int = 1,
                where: str = "") -> list:
    """:func:`check_amps` over a live register: its state tensor, or its
    list of shards when it is sharded."""
    amps = qureg.amps if qureg.shards is None else list(qureg.shards)
    return check_amps(amps, density=qureg.is_density_matrix,
                      n=qureg.num_qubits_represented, policy=policy, tick=tick,
                      where=where)
