"""Outcome probabilities, outcome distributions, collapse and projection
(``quest_tpu/ops/measure.py``).

Reference: statevec_collapseToKnownProbOutcome and
densmatr_collapseToKnownProbOutcome (``QuEST_cpu.c:3695-3848``). Row bits
of a density matrix are the low n, column bits the high n of the
2n-qubit flattening (see ``ops.density``). Each collapse and projection
returns a new tensor.
"""

from __future__ import annotations

import math

import torch

from ..parallel.mesh import local_qubit_count
from .layout import grouped_axes
from .reduce import _csum, csum_rows, total_prob_statevec


def _group_outcome_probs(p: torch.Tensor, n: int, targets) -> torch.Tensor:
    """Reorder a real 2^n tensor so that the target bits lead (targets[0]
    the least significant: the target axes go most significant first), then
    sum the rest of each group by the compensated rowwise cascade
    (``csum_rows``); returns (2^t,)."""
    t = len(targets)
    shape, axis_of = grouped_axes(n, targets)
    p = p.reshape(shape)
    targ_axes = [axis_of[q] for q in reversed(targets)]  # MSB first
    rest = [ax for ax in range(len(shape)) if ax not in targ_axes]
    p = p.permute(targ_axes + rest)
    return csum_rows(p.reshape(1 << t, -1))


def prob_of_all_outcomes(amps: torch.Tensor, *, n: int, targets) -> torch.Tensor:
    """2^t vector of outcome probabilities; outcome index o has targets[0] as
    its least-significant bit (calcProbOfAllOutcomes, QuEST.h:3633;
    calcProbOfAllOutcomesLocal, QuEST_cpu.c:3477)."""
    return _group_outcome_probs(amps[0] * amps[0] + amps[1] * amps[1], n, tuple(targets))


def density_prob_of_all_outcomes(amps: torch.Tensor, *, n: int, targets,
                                 diag: torch.Tensor | None = None) -> torch.Tensor:
    """The outcome distribution of a density matrix: its diagonal's real
    parts grouped as :func:`prob_of_all_outcomes` groups |amp|^2. A sharded
    one passes its gathered diagonal's real part as ``diag`` (``amps``
    None)."""
    if diag is None:
        diag = torch.diagonal(amps[0].reshape(1 << n, 1 << n))
    return _group_outcome_probs(diag, n, tuple(targets))


def prob_of_all_outcomes_shards(shards, *, n: int, targets) -> torch.Tensor:
    """:func:`prob_of_all_outcomes` of a sharded state vector. Each shard
    groups its local targets (a per-shard marginal, on its device); its
    index gives the bits of the sharded targets, as in
    ``ops.reduce.prob_of_outcome_shards``. Each shard's marginal is placed
    at the outcomes its index selects, and the D vectors are cascaded in
    shard order. Returns (2^t,) on the first shard's device."""
    nl = local_qubit_count(n, shards)
    targets = tuple(targets)
    local = [(k, q) for k, q in enumerate(targets) if q < nl]
    dev = shards[0].device
    # outcome index of each local outcome, before the sharded targets' bits
    ol = torch.arange(1 << len(local), device=dev)
    base = torch.zeros_like(ol)
    for j, (k, _) in enumerate(local):
        base |= ((ol >> j) & 1) << k
    full = []
    for r, s in enumerate(shards):
        if local:
            m = prob_of_all_outcomes(s, n=nl, targets=tuple(q for _, q in local))
        else:
            m = total_prob_statevec(s).reshape(1)
        hi = sum(((r >> (q - nl)) & 1) << k for k, q in enumerate(targets) if q >= nl)
        full.append(torch.zeros(1 << len(targets), dtype=m.dtype, device=dev)
                    .index_copy(0, base | hi, m.to(dev)))
    return csum_rows(torch.stack(full).T.contiguous())


def density_prob_of_outcome(amps: torch.Tensor, *, n: int, target: int,
                            outcome: int, diag: torch.Tensor | None = None) -> torch.Tensor:
    """Tr(rho P_outcome): the sum of the diagonal elements whose bit
    ``target`` equals ``outcome`` (densmatr_calcProbOfOutcome). A sharded
    register passes its gathered diagonal's real part as ``diag``."""
    shape, axis_of = grouped_axes(n, (target,))
    if diag is None:
        diag = torch.diagonal(amps[0].reshape(1 << n, 1 << n))
    return _csum(diag.reshape(shape).select(axis_of[target], outcome))


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


def density_collapse_shards(shards, prob: float, *, n: int, target: int,
                            outcome: int) -> list:
    """:func:`density_collapse` of a sharded density matrix: the row qubit
    ``target`` and the column qubit ``target + n`` projected as
    :func:`project_shards` projects (a sharded one zeroes whole shards),
    then the shards scaled by 1/prob; no communication."""
    out = project_shards(shards, n=2 * n, target=target, outcome=outcome)
    out = project_shards(out, n=2 * n, target=target + n, outcome=outcome)
    scale = 1.0 / prob
    return [s * scale for s in out]


def project_statevec(amps: torch.Tensor, *, n: int, target: int,
                     outcome: int) -> torch.Tensor:
    """Unnormalised projection of ``target`` on ``outcome`` (applyProjector,
    QuEST.h:7421): a new tensor."""
    mask, shape = _keep_mask(n, (target,), outcome, amps.dtype, amps.device)
    return (amps.reshape((2,) + shape) * mask).reshape(2, -1)


def project_shards(shards, *, n: int, target: int, outcome: int) -> list:
    """:func:`project_statevec` over the shards: per shard on a local
    target; on a sharded one, the shards whose index has the other bit
    value are zeroed whole and the rest kept, with no communication."""
    nl = local_qubit_count(n, shards)
    if target < nl:
        return [project_statevec(s, n=nl, target=target, outcome=outcome) for s in shards]
    return [s if (r >> (target - nl)) & 1 == outcome else torch.zeros_like(s)
            for r, s in enumerate(shards)]
