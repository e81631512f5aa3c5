"""Carry states, kernel ops, API arguments and circuits across from
``quest_tpu``.

The tests use these to feed identical inputs to both packages. Nothing
here imports ``quest_tpu`` or JAX: the JAX side's objects arrive as numpy
arrays, tuples, matrices that expose their ndarray as ``.arr``, and the
data structures ``Vector``, ``SubDiagonalOp`` and ``PauliHamil``,
recognised by name.
"""

from __future__ import annotations

import numpy as np
import torch

from .circuits import Circuit
from .datatypes import PauliHamil, SubDiagonalOp, Vector
from .ops.fused_gates import HashableMatrix


def state_from_numpy(planar, device) -> torch.Tensor:
    """A planar (2, 2^n) float array -> a new tensor on ``device``, same
    dtype (a copy: the port updates states in place)."""
    a = np.asarray(planar)
    if a.ndim != 2 or a.shape[0] != 2 or a.shape[1] & (a.shape[1] - 1):
        raise ValueError(f"expected a planar (2, 2^n) array, got {a.shape}")
    return torch.tensor(a, device=device)


def state_to_numpy(qureg) -> np.ndarray:
    """A register's (or a tensor's) planar state -> numpy (2, 2^n); a
    sharded register's shards are gathered here."""
    shards = getattr(qureg, "shards", None)
    if shards is not None:
        return np.concatenate(shard_arrays(qureg), axis=1)
    amps = getattr(qureg, "amps", qureg)
    return amps.detach().cpu().numpy()


def shard_arrays(qureg) -> list:
    """A sharded register's shards as numpy planar (2, C) arrays, in shard
    order: the pieces of a sharded ``quest_tpu`` array of the same state."""
    return [s.detach().cpu().numpy() for s in qureg.shards]


def load_state(qureg, amps) -> None:
    """Overwrite ``qureg``'s state with a planar (2, 2^n) state: a numpy
    array, or a sharded ``quest_tpu`` array (anything with
    ``addressable_shards``, each piece's ``.data`` and ``.index``), carried
    piece by piece into the shards it covers, never gathered whole."""
    pieces = ([(np.asarray(p.data), p.index[1]) for p in amps.addressable_shards]
              if hasattr(amps, "addressable_shards")
              else [(np.asarray(amps), slice(None))])
    N = qureg.num_amps_total
    shards = qureg.shards if qureg.shards is not None else [qureg.amps]
    c = N // len(shards)
    for data, cols in pieces:
        a, b, _ = cols.indices(N)
        for r, shard in enumerate(shards):
            lo, hi = max(a, r * c), min(b, (r + 1) * c)
            if lo < hi:
                shard[:, lo - r * c:hi - r * c] = torch.tensor(
                    data[:, lo - a:hi - a], dtype=shard.dtype, device=shard.device)


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


def arg_from_reference(x):
    """One ``quest_tpu`` API argument -> the port's: a ``Vector``, a
    ``SubDiagonalOp`` or a ``PauliHamil`` becomes the port's own, a matrix
    (a ComplexMatrixN array, a bound matrix, a jax array) a numpy copy, a
    ``Param`` the port's ``Param`` of the same name (so a parameterized
    tape carries across); lists and tuples convert element by element,
    every other value is kept."""
    name = type(x).__name__
    if name == "Param":
        from .engine.params import Param
        return Param(str(x.name))
    if name == "Vector":
        return Vector(float(x.x), float(x.y), float(x.z))
    if name == "SubDiagonalOp":
        return SubDiagonalOp(int(x.num_qubits), np.array(x.elems, dtype=complex))
    if name == "PauliHamil":
        return PauliHamil(int(x.num_qubits), int(x.num_sum_terms),
                          np.array(x.pauli_codes), np.array(x.term_coeffs))
    if isinstance(x, (list, tuple)):
        return type(x)(arg_from_reference(y) for y in x)
    if hasattr(x, "__array__") and not isinstance(x, np.generic):
        return np.array(x)
    return x


def circuit_from_tape(entries, n: int, is_density_matrix: bool = False) -> Circuit:
    """Rebuild a port Circuit from a ``quest_tpu`` ``Circuit._tape``: each
    entry ``(fn, args, kwargs)`` (gates, operators, initialisers and mix*
    channels) is recorded again by ``fn.__name__``, its arguments carried
    across by :func:`arg_from_reference`."""
    c = Circuit(n, is_density_matrix)
    for fn, args, kwargs in entries:
        getattr(c, fn.__name__)(*arg_from_reference(tuple(args)),
                                **{k: arg_from_reference(v) for k, v in kwargs.items()})
    return c
