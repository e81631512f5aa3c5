"""Parameterized replay and the executable cache (``quest_tpu.engine``
without its serving layer).

- :mod:`.params` -- :class:`Param` placeholders (alias ``P``) making gate
  angles/Complex scalars *runtime values* of one captured replay, plus the
  constant-lifting canonicalisation behind structure fingerprints.
- :mod:`.cache` -- the structure fingerprint and the bounded, counted LRU
  every compiled replay routes through.

The JAX package's serving ``Engine``, ``EnginePool``, admission control
and ``enable_persistent_cache`` are not here: the first three are the
next slice of the port, and the last has no counterpart (see
:mod:`.cache`).
"""

from .cache import LRUCache, executables, structure_fingerprint  # noqa: F401
from .params import (  # noqa: F401
    BoundValues, LiftedTape, P, Param, ParamExecutable, Slot, bind, lift_tape,
)

__all__ = [
    "Param", "P", "ParamExecutable", "LiftedTape", "Slot", "lift_tape",
    "bind", "BoundValues", "LRUCache", "executables", "structure_fingerprint",
]
