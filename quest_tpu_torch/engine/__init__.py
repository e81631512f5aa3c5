"""The serving layer: parameterized replay, the executable cache, the
micro-batching Engine and admission control (``quest_tpu.engine``).

- :mod:`.params` -- :class:`Param` placeholders (alias ``P``) making gate
  angles/Complex scalars *runtime values* of one captured replay, plus the
  constant-lifting canonicalisation behind structure fingerprints, and the
  stacked values of a batch of lanes.
- :mod:`.cache` -- the structure fingerprint and the bounded, counted LRU
  every compiled replay routes through.
- :mod:`.engine` -- :class:`Engine`: ``submit(params) -> Future`` with a
  micro-batcher coalescing requests into one lane-batched replay (one
  device) or a sequential replay (a sharded env).
- :mod:`.admission` -- per-tenant token-bucket quotas with a
  high-priority reserve (``QuESTBackpressureError`` with
  ``reason="quota"``).
- :mod:`.pool` -- :class:`EnginePool`: N replicas of Engines on one env
  behind health-aware, structure-affine routing, with quarantine
  failover, warm replacements, parked requests, hedging and
  ``submit_grad``.

Quickstart::

    import quest_tpu_torch as qt
    from quest_tpu_torch.engine import Engine, P

    c = qt.Circuit(20)
    for q in range(20):
        c.rotateZ(q, P(f"theta{q}"))
    ...
    with Engine(c, qt.createQuESTEnv(), max_batch=8) as eng:
        futs = eng.submit_many([{f"theta{q}": v for q, v in enumerate(vec)}
                                for vec in sweep])
        states = [f.result() for f in futs]

The JAX package's ``enable_persistent_cache`` has no counterpart (see
:mod:`.cache`).
"""

from .admission import PRIORITIES, AdmissionController, TokenBucket  # noqa: F401
from .cache import LRUCache, executables, structure_fingerprint  # noqa: F401
from .engine import Engine  # noqa: F401
from . import pool  # noqa: F401
from .pool import EnginePool  # noqa: F401
from .params import (  # noqa: F401
    BoundValues, LiftedTape, P, Param, ParamExecutable, Slot, bind, lift_tape,
)

__all__ = [
    "Param", "P", "ParamExecutable", "LiftedTape", "Slot", "lift_tape",
    "bind", "BoundValues", "LRUCache", "executables", "structure_fingerprint",
    "Engine", "EnginePool", "pool", "AdmissionController", "TokenBucket", "PRIORITIES",
]
