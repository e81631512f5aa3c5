"""Scalar reductions over planar states.

The reference protects its norm accumulations with Kahan summation
(statevec_calcTotalProb, QuEST_cpu_distributed.c:62-119) because low
precision drifts over 2^N terms. As in ``quest_tpu/ops/reduce.py``: f64
states accumulate in f64; f32 states sum by the adjacent-pair cascade,
whose rounding error grows O(log N) instead of O(N).

A sharded state (a list of shards, shard r the amplitudes [r C, (r+1) C))
reduces per shard, each on its device, and the D partial sums then
cascade in shard order: for power-of-two shards the same pairing as the
whole state's cascade.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import local_qubit_count


def _pairwise_sum_rows(x: torch.Tensor) -> torch.Tensor:
    """Rowwise pairwise (cascade) summation over the LAST axis of a 2-D
    tensor, pairing adjacent elements (2i, 2i+1)."""
    m = x.shape[-1]
    while m > 1 and m % 2 == 0:
        x = x.reshape(x.shape[0], -1, 2).sum(dim=-1)
        m //= 2
    return x.sum(dim=-1)


def csum_rows(x: torch.Tensor) -> torch.Tensor:
    """Compensated rowwise reduction of a 2-D tensor over its last axis:
    f64 accumulation for f64 input, the adjacent-pair cascade for f32."""
    if x.dtype == torch.float64:
        return x.sum(dim=-1)
    return _pairwise_sum_rows(x)


def _csum(x: torch.Tensor) -> torch.Tensor:
    return csum_rows(x.reshape(1, -1))[0]


def total_prob_statevec(amps: torch.Tensor) -> torch.Tensor:
    """sum |amp|^2 (statevec_calcTotalProb, Kahan in the reference)."""
    return _csum(amps[0] * amps[0] + amps[1] * amps[1])


def total_prob_density(amps: torch.Tensor, *, n: int) -> torch.Tensor:
    """Re(trace(rho)) (densmatr_calcTotalProb)."""
    dim = 1 << n
    return _csum(torch.diagonal(amps[0].reshape(dim, dim)))


def purity_density(amps: torch.Tensor) -> torch.Tensor:
    """Tr(rho^2) = sum |rho_ij|^2 for Hermitian rho (densmatr_calcPurityLocal,
    QuEST_cpu.c:878)."""
    return _csum(amps[0] * amps[0] + amps[1] * amps[1])


def prob_of_outcome(amps: torch.Tensor, *, n: int, target: int,
                    outcome: int) -> torch.Tensor:
    """P(measuring ``outcome`` on ``target``) of a state-vector
    (statevec_findProbabilityOfZeroLocal, ``QuEST_cpu.c:3385``)."""
    sub = amps.reshape(2, 1 << (n - 1 - target), 2, 1 << target)[:, :, outcome, :]
    return _csum(sub[0] * sub[0] + sub[1] * sub[1])


def _csum_parts(parts) -> torch.Tensor:
    """The per-shard partial sums (0-d tensors), cascaded in shard order on
    the first shard's device."""
    return _csum(torch.stack([p.to(parts[0].device) for p in parts]))


def total_prob_shards(shards) -> torch.Tensor:
    """sum |amp|^2 of a sharded state vector."""
    return _csum_parts([total_prob_statevec(s) for s in shards])


def prob_of_outcome_shards(shards, *, n: int, target: int,
                           outcome: int) -> torch.Tensor:
    """P(``outcome`` on ``target``) of a sharded state vector: per shard on a
    local target; on a sharded one, the whole shards whose index has that
    bit (their sum; 0 if none)."""
    nl = local_qubit_count(n, shards)
    if target < nl:
        return _csum_parts([prob_of_outcome(s, n=nl, target=target, outcome=outcome)
                            for s in shards])
    parts = [total_prob_statevec(s) for r, s in enumerate(shards)
             if (r >> (target - nl)) & 1 == outcome]
    return _csum_parts(parts)
