"""The guard the serving Engine calls (``quest_tpu/resilience/guard.py``'s
``corrupt_amps``): the ``state.corrupt`` injection site. On a
``bitflip[<N>]`` fire it flips the top exponent bit of one real-plane
amplitude in the middle of shard N, in a copy, for the sentinels to catch.
"""

from __future__ import annotations

import torch

from .. import telemetry
from . import faultinject

__all__ = ["corrupt_amps"]


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
