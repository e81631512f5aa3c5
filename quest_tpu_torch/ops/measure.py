"""Outcome probabilities and collapse (``quest_tpu/ops/measure.py``).

Reference: statevec_collapseToKnownProbOutcome and
densmatr_collapseToKnownProbOutcome (``QuEST_cpu.c:3695-3848``). Row bits
of a density matrix are the low n, column bits the high n of the
2n-qubit flattening (see ``ops.density``). Each collapse returns a new
tensor.
"""

from __future__ import annotations

import math

import torch

from ..parallel.mesh import local_qubit_count
from .layout import grouped_axes
from .reduce import _csum


def density_prob_of_outcome(amps: torch.Tensor, *, n: int, target: int,
                            outcome: int) -> torch.Tensor:
    """Tr(rho P_outcome): the sum of the diagonal elements whose bit
    ``target`` equals ``outcome`` (densmatr_calcProbOfOutcome)."""
    shape, axis_of = grouped_axes(n, (target,))
    d = torch.diagonal(amps[0].reshape(1 << n, 1 << n)).reshape(shape)
    return _csum(d.select(axis_of[target], outcome))


def _keep_mask(n: int, qubits, outcome: int, dtype, device):
    """A 0/1 tensor broadcastable over the grouped view of ``qubits``: 1
    where every one of their bits equals ``outcome``."""
    shape, axis_of = grouped_axes(n, qubits)
    keep = torch.zeros(2, dtype=dtype, device=device)
    keep[outcome] = 1
    mask = None
    for q in qubits:
        s = [1] * len(shape)
        s[axis_of[q]] = 2
        v = keep.reshape(s)
        mask = v if mask is None else mask * v
    return mask, shape


def collapse_statevec(amps: torch.Tensor, prob: float, *, n: int, target: int,
                      outcome: int) -> torch.Tensor:
    """Project ``target`` to ``outcome`` and renormalise by 1/sqrt(prob)."""
    mask, shape = _keep_mask(n, (target,), outcome, amps.dtype, amps.device)
    scale = 1.0 / math.sqrt(prob)
    return (amps.reshape((2,) + shape) * mask * scale).reshape(2, -1)


def density_collapse(amps: torch.Tensor, prob: float, *, n: int, target: int,
                     outcome: int, renorm: bool = True) -> torch.Tensor:
    """Zero every element whose row bit or column bit of ``target`` differs
    from ``outcome``, then scale by 1/prob."""
    mask, shape = _keep_mask(2 * n, (target, target + n), outcome, amps.dtype,
                             amps.device)
    out = amps.reshape((2,) + shape) * mask
    if renorm:
        out = out * (1.0 / prob)
    return out.reshape(2, -1)


def collapse_shards(shards, prob: float, *, n: int, target: int,
                    outcome: int) -> list:
    """:func:`collapse_statevec` over the shards: per shard on a local
    target; on a sharded one, the shards whose index has the other bit
    value are zeroed and the rest scaled, with no communication."""
    nl = local_qubit_count(n, shards)
    if target < nl:
        return [collapse_statevec(s, prob, n=nl, target=target, outcome=outcome)
                for s in shards]
    scale = 1.0 / math.sqrt(prob)
    return [s * scale if (r >> (target - nl)) & 1 == outcome else torch.zeros_like(s)
            for r, s in enumerate(shards)]
