"""Site guards (``quest_tpu/resilience/guard.py``): where fault injection,
retry and the self-healing lattice meet. With no fault plan installed each
guard is a direct call after one module boolean.

- ``checkpoint.write`` (:func:`checkpoint_write`) -- ``io`` faults are
  retried; ``torn`` and ``corrupt`` mutate the written shard file, for
  verification (the index CRC) to catch;
- ``segment.boundary`` (:func:`segment_boundary`) -- a ``preempt`` fault
  raises :class:`~.errors.QuESTPreemptionError` with the resume cursor;
- ``state.corrupt`` (:func:`corrupt_amps`) -- on a ``bitflip[<N>]`` fire
  the top exponent bit of one real-plane amplitude in the middle of shard
  N is flipped, in a copy, for the sentinels to catch;
- a sentinel breach (:func:`sentinel_replay`) -- retry the span from the
  last verified state, then degrade, then fail closed with
  :class:`~.errors.QuESTIntegrityError`.

The JAX package's ``pallas.dispatch``, ``exchange.collective`` and
``engine.retire`` guards are not ported yet (ROADMAP A).
"""

from __future__ import annotations

import os
from typing import Callable, TypeVar

import torch

from .. import telemetry
from . import faultinject, retry
from .errors import QuESTIntegrityError, QuESTPreemptionError, TransientFault

__all__ = ["checkpoint_write", "segment_boundary", "corrupt_amps", "sentinel_replay"]

T = TypeVar("T")


def checkpoint_write(write: Callable[[], str], *, site: str = "checkpoint.write") -> str:
    """Run a shard ``write`` (it returns the final path): retry injected
    ``io`` faults, then apply a ``torn`` (the file's tail half cut off) or
    ``corrupt`` (:func:`_flip_payload`) fault to the written file."""
    if not faultinject.enabled():
        return write()

    def guarded() -> str:
        kind = faultinject.fire(site)
        if kind == "io":
            raise TransientFault(site, kind)
        path = write()
        if kind == "torn":
            with open(path, "r+b") as f:
                f.truncate(max(1, os.path.getsize(path) // 2))
        elif kind == "corrupt":
            _flip_payload(path)
        return path

    return retry.call_with_retry(guarded, site=site)


def _flip_payload(path: str) -> None:
    """Flip one byte in the middle of the shard's amplitude payload and
    write the file again as a valid npz: a readable shard whose payload is
    not what was indexed, which only the index CRC can catch (a raw byte
    flip could land in the zip framing or in ``start`` / ``stop``)."""
    import numpy as np
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    amps = np.ascontiguousarray(data["amps"])
    raw = bytearray(amps.tobytes())
    raw[len(raw) // 2] ^= 0xFF
    data["amps"] = np.frombuffer(bytes(raw), dtype=amps.dtype).reshape(amps.shape)
    with open(path, "wb") as f:
        np.savez_compressed(f, **data)


def segment_boundary(cursor: int, checkpoint_dir: str) -> None:
    """Visit the preemption site between two segments; a ``preempt`` fire
    raises :class:`QuESTPreemptionError` carrying the resume cursor."""
    if not faultinject.enabled():
        return
    if faultinject.fire("segment.boundary") == "preempt":
        raise QuESTPreemptionError(
            f"injected preemption after checkpoint at tape cursor {cursor} (resume "
            f"from {checkpoint_dir!r})", "run_segmented", cursor=cursor,
            checkpoint_dir=checkpoint_dir)


def corrupt_amps(amps, *, site: str = "state.corrupt"):
    """Visit the corruption site over a planar state (a tensor, or a list
    of shards): on a ``bitflip[<N>]`` fire return a copy with the top
    exponent bit of the real amplitude in the middle of shard N flipped (an
    exactly zero amplitude becomes 2.0, so the norm leaves every band);
    otherwise ``amps`` itself. The live buffer is never changed."""
    if not faultinject.enabled():
        return amps
    kind = faultinject.fire(site)
    if kind is None or not kind.startswith("bitflip"):
        return amps
    sharded = isinstance(amps, (list, tuple))
    pieces = [s.clone() for s in amps] if sharded else None
    shard = int(kind[len("bitflip"):] or 0)
    target = pieces[shard % len(pieces)] if sharded else amps.clone()
    idx = target.shape[-1] // 2
    if target.dtype == torch.float64:
        view, bit = target[0].view(torch.int64), 62
    else:
        view, bit = target[0].view(torch.int32), 30
    view[idx] ^= 1 << bit
    telemetry.event("resilience.sdc_injected", site=site, shard=shard, index=int(idx),
                    dtype=str(target.dtype))
    return pieces if sharded else target


def sentinel_replay(replay: Callable[[], T], degrade: Callable[[], T] | None = None,
                    *, site: str = "segment.sentinel") -> T:
    """The self-healing lattice after an integrity breach. ``replay`` rolls
    the register back to the last verified state, runs the span again on
    the same route and checks the sentinels, raising
    :class:`QuESTIntegrityError` on a new breach; it is retried under the
    :mod:`.retry` policy (a one-off flip heals at the first replay). Then
    ``degrade`` (a replay on another route from the same state) runs once;
    if it breaches too, the error propagates: fail closed. Outcomes count
    ``segmented_rollbacks_total{outcome=replayed|degraded|failed}``, a
    degrade ``engine_fallback_total{reason=sentinel_degraded}``."""
    try:
        out = retry.call_with_retry(replay, site=site, retryable=(QuESTIntegrityError,))
        telemetry.inc("segmented_rollbacks_total", outcome="replayed")
        return out
    except QuESTIntegrityError as e:
        if degrade is None:
            telemetry.inc("segmented_rollbacks_total", outcome="failed")
            raise
        telemetry.inc("engine_fallback_total", reason="sentinel_degraded")
        telemetry.event("resilience.sentinel_degrade", site=site,
                        findings=len(getattr(e, "findings", ())))
        try:
            out = degrade()
        except QuESTIntegrityError:
            telemetry.inc("segmented_rollbacks_total", outcome="failed")
            raise
        telemetry.inc("segmented_rollbacks_total", outcome="degraded")
        return out
