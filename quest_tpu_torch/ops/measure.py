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

from .._spy import spy_point
from ..parallel.mesh import local_qubit_count
from .layout import grouped_axes
from . import reduce as _reduce
from .reduce import _csum, csum_rows, density_diagonal_parts, total_prob_chunked


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


def _sq(a: torch.Tensor) -> torch.Tensor:
    """|amp|^2 of a planar (2, ...) tensor."""
    return a[0] * a[0] + a[1] * a[1]


def _local_marginal(x: torch.Tensor, nl: int, targets: tuple, planar: bool) -> torch.Tensor:
    """One shard's outcome marginal over ``targets`` (all local), on its
    device: (2^t,). ``x`` is the shard's planar amplitudes (``planar``) or
    its real probabilities. A planar shard of more than 2^CHUNK_BITS
    amplitudes is reduced a piece at a time: the pieces fix its highest
    non-target qubits, each piece is grouped and summed alone, and the
    piece sums cascade in order. Those qubits are the most significant
    bits of the grouped rest, so in f32 the bits are those of
    :func:`prob_of_all_outcomes` on the whole shard, and no temporary is
    larger than a piece."""
    if not targets:
        return (total_prob_chunked(x) if planar else _csum(x)).reshape(1)
    if not planar:
        return _group_outcome_probs(x, nl, targets)
    rest = sorted((q for q in range(nl) if q not in targets), reverse=True)
    c = min(max(nl - _reduce.CHUNK_BITS, 0), len(rest))
    if c == 0:
        return prob_of_all_outcomes(x, n=nl, targets=targets)
    top = rest[:c]  # the chunk qubits, highest first
    shape, axis_of = grouped_axes(nl, tuple(targets) + tuple(top))
    view = x.reshape((2,) + shape)
    fixed = {axis_of[q] for q in top}
    keep = {a: i for i, a in enumerate(a for a in range(len(shape)) if a not in fixed)}
    targ_axes = [keep[axis_of[q]] for q in reversed(targets)]  # MSB first
    rest_axes = [i for i in range(len(keep)) if i not in targ_axes]
    pieces = []
    for v in range(1 << c):
        idx = [slice(None)] * len(shape)
        for j, q in enumerate(top):
            idx[axis_of[q]] = (v >> (c - 1 - j)) & 1
        p = _sq(view[(slice(None),) + tuple(idx)])
        pieces.append(csum_rows(p.permute(targ_axes + rest_axes).reshape(1 << len(targets), -1)))
    return csum_rows(torch.stack(pieces, dim=1))


def prob_sources(shards, *, n: int, density: bool = False):
    """``(sources, nl, planar)``: what each shard's outcome probabilities
    come from, as a sharded vector of nl local qubits. A state vector's
    shards themselves (|amp|^2 taken as needed); a density matrix's
    diagonal entries (``ops.reduce.density_diagonal_parts``), each shard's
    on its own device (a sharded diagonal of n - d local qubits), or one
    source of n local qubits for a register of less than a column a
    shard."""
    if not density:
        return list(shards), local_qubit_count(n, shards), True
    parts = density_diagonal_parts(shards, n=n)
    return [p[0] for p in parts], n - (len(parts) - 1).bit_length(), False


def marginal_groups(sources, *, nl: int, targets, planar: bool) -> list:
    """The outcome marginal over ``targets`` of a sharded probability vector,
    kept on the shards: one part for each value g of the sharded targets'
    bits (bit j of g the j-th sharded target in ``targets`` order), the
    (2^l,) marginal over the l local targets (in ``targets`` order) of the
    shards whose index has those bits, summed on the first of them in shard
    order. With no sharded target it is one part, the whole marginal, on
    the first shard's device. In f32 the parts hold the bits of the
    one-device marginal: the shards a part sums differ in the top bits of
    the grouped rest, which the one-device cascade adds last, in order."""
    targets = tuple(int(q) for q in targets)
    local = tuple(q for q in targets if q < nl)
    sharded = [q for q in targets if q >= nl]
    members: dict = {}
    for r in range(len(sources)):
        g = sum(((r >> (q - nl)) & 1) << j for j, q in enumerate(sharded))
        members.setdefault(g, []).append(r)
    parts = []
    for g in range(1 << len(sharded)):
        ms = [_local_marginal(sources[r], nl, local, planar) for r in members[g]]
        if len(ms) == 1:
            parts.append(ms[0])
        else:
            dev = ms[0].device
            parts.append(csum_rows(torch.stack([m.to(dev) for m in ms], dim=1)))
    return parts


def assemble_marginal(parts, *, nl: int, targets) -> torch.Tensor:
    """:func:`marginal_groups`' parts as the (2^t,) marginal on the first
    part's device: each part's entries placed at the outcomes its local
    targets and its sharded bits select."""
    targets = tuple(int(q) for q in targets)
    if len(parts) == 1:
        return parts[0]
    dev = parts[0].device
    local = [k for k, q in enumerate(targets) if q < nl]
    sharded = [k for k, q in enumerate(targets) if q >= nl]
    ol = torch.arange(1 << len(local), device=dev)
    base = torch.zeros_like(ol)
    for j, k in enumerate(local):
        base |= ((ol >> j) & 1) << k
    full = torch.zeros(1 << len(targets), dtype=parts[0].dtype, device=dev)
    for g, part in enumerate(parts):
        hi = sum(((g >> j) & 1) << k for j, k in enumerate(sharded))
        full.index_copy_(0, base | hi, part.to(dev))
    return full


def prob_of_all_outcomes_shards(shards, *, n: int, targets) -> torch.Tensor:
    """:func:`prob_of_all_outcomes` of a sharded state vector, on the first
    shard's device: :func:`marginal_groups` (each shard groups its local
    targets on its device; the sharded targets' bits come from the shard
    index), the parts placed at their outcomes. With every target local it
    is the D per-shard marginals cascaded in shard order."""
    nl = local_qubit_count(n, shards)
    parts = marginal_groups(list(shards), nl=nl, targets=targets, planar=True)
    return assemble_marginal(parts, nl=nl, targets=targets)


def density_prob_of_all_outcomes_shards(shards, *, n: int, targets) -> torch.Tensor:
    """:func:`density_prob_of_all_outcomes` of a sharded density matrix: the
    marginal of its diagonal, each shard's entries grouped on its device
    (:func:`prob_sources`), on the first shard's device."""
    sources, nl, _ = prob_sources(shards, n=n, density=True)
    parts = marginal_groups(sources, nl=nl, targets=targets, planar=False)
    return assemble_marginal(parts, nl=nl, targets=targets)


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


@spy_point
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
