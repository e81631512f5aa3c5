"""Outcome probabilities of density matrices (the density slice's part of
``quest_tpu/ops/measure.py``; row bits are the low n, column bits the high
n of the 2n-qubit flattening, see ``ops.density``)."""

from __future__ import annotations

import torch

from .layout import grouped_axes
from .reduce import _csum


def density_prob_of_outcome(amps: torch.Tensor, *, n: int, target: int,
                            outcome: int) -> torch.Tensor:
    """Tr(rho P_outcome): the sum of the diagonal elements whose bit
    ``target`` equals ``outcome`` (densmatr_calcProbOfOutcome)."""
    shape, axis_of = grouped_axes(n, (target,))
    d = torch.diagonal(amps[0].reshape(1 << n, 1 << n)).reshape(shape)
    return _csum(d.select(axis_of[target], outcome))
