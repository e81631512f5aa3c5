"""Executable cache: structure fingerprints and a bounded, counted LRU
(``quest_tpu/engine/cache.py``).

1. :func:`structure_fingerprint` -- a content hash of a tape's STRUCTURE
   (gate names, targets/controls, value-slot kinds, baked operand bytes --
   never the lifted values), so "same ansatz, different angles" keys to
   the same executable.
2. :class:`LRUCache` -- the bounded, thread-safe LRU every compiled replay
   routes through, with the ``plan_cache_{hit,miss,evict}_total{cache}``
   counters and the ``plan_cache_size`` gauge. Evicting an entry closes it
   (``close()``): a captured executable frees its CUDA graphs, their
   private memory pool and its staged constants (``_capture.Replay``), not
   just its key.

Capacity defaults to ``QUEST_PLAN_CACHE_SIZE`` (128). The JAX package's
``enable_persistent_cache`` has no counterpart: the port traces nothing
that a restart would compile again, and its kernels already persist,
built once into ``quest_tpu_torch/_build/``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
from collections import OrderedDict

import numpy as np
import torch

from .. import telemetry

__all__ = ["LRUCache", "executables", "structure_fingerprint"]


def _close(value) -> None:
    close = getattr(value, "close", None)
    if callable(close):
        close()


class LRUCache:
    """Bounded thread-safe LRU with hit/miss/evict counters.

    ``get_or_create(key, factory)`` is the entry point the executable
    paths use: a hit refreshes recency and counts
    ``plan_cache_hit_total{cache=name}``; a miss runs ``factory()`` under
    the lock (factories build cheap host wrappers: a capture happens at a
    later call), stores, counts a miss, and evicts least-recently-used
    entries past ``capacity`` (counted per eviction, each closed)."""

    def __init__(self, capacity: int = 128, name: str = "exec"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.name = name
        # re-entrant: a factory may route nested executables through the
        # same cache (compiled_blocks builds its per-block replays)
        self._lock = threading.RLock()
        self._od: OrderedDict = OrderedDict()

    def __len__(self) -> int:
        with self._lock:
            return len(self._od)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._od

    def peek(self, key, default=None):
        """Non-mutating probe: no recency refresh, no counters."""
        with self._lock:
            return self._od.get(key, default)

    def get(self, key, default=None):
        """Counted lookup (hit/miss counted, recency refreshed)."""
        with self._lock:
            if key in self._od:
                self._od.move_to_end(key)
                telemetry.inc("plan_cache_hit_total", cache=self.name)
                return self._od[key]
        telemetry.inc("plan_cache_miss_total", cache=self.name)
        return default

    def put(self, key, value) -> None:
        with self._lock:
            old = self._od.get(key)
            self._od[key] = value
            self._od.move_to_end(key)
            self._evict_locked()
        if old is not None and old is not value:
            _close(old)
        telemetry.set_gauge("plan_cache_size", len(self), cache=self.name)

    def get_or_create(self, key, factory):
        with self._lock:
            if key in self._od:
                self._od.move_to_end(key)
                telemetry.inc("plan_cache_hit_total", cache=self.name)
                return self._od[key]
            telemetry.inc("plan_cache_miss_total", cache=self.name)
            value = factory()
            self._od[key] = value
            self._evict_locked()
        telemetry.set_gauge("plan_cache_size", len(self), cache=self.name)
        return value

    def _evict_locked(self) -> None:
        while len(self._od) > self.capacity:
            _close(self._od.popitem(last=False)[1])
            telemetry.inc("plan_cache_evict_total", cache=self.name)

    def discard(self, match) -> int:
        """Close and drop every entry whose key satisfies ``match(key)``
        (a retired tape revision's executables); not counted as evictions.
        Returns how many went."""
        with self._lock:
            gone = [self._od.pop(k) for k in [k for k in self._od if match(k)]]
        for v in gone:
            _close(v)
        if gone:
            telemetry.set_gauge("plan_cache_size", len(self), cache=self.name)
        return len(gone)

    def clear(self) -> None:
        with self._lock:
            values = list(self._od.values())
            self._od.clear()
        for v in values:
            _close(v)
        telemetry.set_gauge("plan_cache_size", 0, cache=self.name)

    def keys(self) -> list:
        with self._lock:
            return list(self._od)


#: the process-global executable cache every compiled Circuit replay
#: routes through (compiled, compiled_blocks, the segment and request
#: chains, parameterized); bounded so a long-lived process running many
#: circuit structures cannot grow it, and its graphs, without limit
_EXECUTABLES = LRUCache(
    int(os.environ.get("QUEST_PLAN_CACHE_SIZE", "128")), name="executable")


def executables() -> LRUCache:
    """The process-global compiled-replay LRU."""
    return _EXECUTABLES


# ---------------------------------------------------------------------------
# structure fingerprint
# ---------------------------------------------------------------------------

def _canon(x):
    """Canonical hashable form of one tape operand: value slots collapse to
    their kind, baked operands hash by content, unknown objects by identity
    (unique: never wrongly shared). A 0-d tensor is a value slot; any other
    tensor hashes by content."""
    from .params import Param, _SlotRef

    if isinstance(x, _SlotRef):
        return ("slot",)
    if isinstance(x, Param):  # an un-lifted tape: still a value slot
        return ("slot",)
    if isinstance(x, torch.Tensor):
        if x.dim() == 0:
            return ("slot",)
        a = x.detach().cpu().contiguous()
        return ("a", tuple(a.shape), str(a.dtype),
                hashlib.sha1(a.numpy().tobytes()).hexdigest())
    if x is None or isinstance(x, (str, bytes)):
        return x
    if isinstance(x, bool) or isinstance(x, (int, np.integer)):
        return ("i", int(x))
    if isinstance(x, (float, np.floating)):
        return ("f", repr(float(x)))
    if isinstance(x, (complex, np.complexfloating)):
        return ("c", repr(complex(x)))
    if isinstance(x, np.ndarray):
        a = np.ascontiguousarray(x)
        return ("a", a.shape, a.dtype.str, hashlib.sha1(a.tobytes()).hexdigest())
    if type(x).__name__ == "HashableMatrix":  # kernel op payloads
        return ("hm",) + _canon(np.asarray(x.arr))[1:]
    if isinstance(x, (tuple, list)):
        return ("t", tuple(_canon(e) for e in x))
    if callable(x):
        return ("fn", getattr(x, "__module__", ""),
                getattr(x, "__qualname__", repr(x)))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return ("dc", type(x).__name__,
                tuple(_canon(getattr(x, f.name)) for f in dataclasses.fields(x)
                      if f.compare))
    # opaque object: identity-keyed so distinct operands never collide
    return ("obj", type(x).__name__, id(x))


def structure_fingerprint(tape, num_qubits: int, is_density: bool,
                          extra=()) -> str:
    """Content hash of a tape's structure. Lifted value slots (angles,
    Complex scalars, see :mod:`.params`) contribute only their existence,
    so two tapes differing in those values collide (by design: they share
    one executable); anything else differing -- gate names, targets,
    controls, baked matrices, channel probabilities -- changes the hash."""
    from .params import lift_tape

    lifted = lift_tape(tuple(tape))
    tokens = [("hdr", int(num_qubits), bool(is_density), _canon(tuple(extra)))]
    for fn, args, kwargs in lifted.entries:
        tokens.append((_canon(fn), _canon(args),
                       tuple(sorted((k, _canon(v)) for k, v in kwargs.items()))))
    return hashlib.sha256(repr(tokens).encode()).hexdigest()
