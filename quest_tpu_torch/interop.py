"""Carry states, kernel ops and circuits across from ``quest_tpu``.

The tests use these to feed identical inputs to both packages. Nothing
here imports ``quest_tpu`` or JAX: the JAX side's objects arrive as numpy
arrays, tuples, and matrices that expose their ndarray as ``.arr``.
"""

from __future__ import annotations

import numpy as np
import torch

from .circuits import Circuit
from .ops.fused_gates import HashableMatrix


def state_from_numpy(planar, device) -> torch.Tensor:
    """A planar (2, 2^n) float array -> a new tensor on ``device``, same
    dtype (a copy: the port updates states in place)."""
    a = np.asarray(planar)
    if a.ndim != 2 or a.shape[0] != 2 or a.shape[1] & (a.shape[1] - 1):
        raise ValueError(f"expected a planar (2, 2^n) array, got {a.shape}")
    return torch.tensor(a, device=device)


def state_to_numpy(qureg) -> np.ndarray:
    """A register's (or a tensor's) planar state -> numpy (2, 2^n)."""
    amps = getattr(qureg, "amps", qureg)
    return amps.detach().cpu().numpy()


def ops_from_reference(ops) -> tuple:
    """A ``quest_tpu`` kernel-op tuple -> the port's: every matrix (an
    object with an ``.arr`` ndarray, kraus terms' K included) becomes the
    port's HashableMatrix, every other field is kept."""
    def conv(x):
        if hasattr(x, "arr"):
            return HashableMatrix(np.asarray(x.arr))
        if isinstance(x, tuple):
            return tuple(conv(y) for y in x)
        return x

    return tuple(conv(op) for op in ops)


def circuit_from_tape(entries, n: int, is_density_matrix: bool = False) -> Circuit:
    """Rebuild a port Circuit from a ``quest_tpu`` ``Circuit._tape``: each
    entry ``(fn, args, kwargs)`` (gates, initialisers and mix* channels) is
    recorded again by ``fn.__name__``."""
    c = Circuit(n, is_density_matrix)
    for fn, args, kwargs in entries:
        getattr(c, fn.__name__)(*args, **kwargs)
    return c
