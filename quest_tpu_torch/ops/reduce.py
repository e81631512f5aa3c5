"""Scalar reductions over planar states: norms, purity, outcome
probabilities, inner products, fidelity, distances and the expectation
of a full diagonal operator.

The reference protects its norm accumulations with Kahan summation
(statevec_calcTotalProb, QuEST_cpu_distributed.c:62-119) because low
precision drifts over 2^N terms. As in ``quest_tpu/ops/reduce.py``: f64
states accumulate in f64; f32 states sum by the adjacent-pair cascade,
whose rounding error grows O(log N) instead of O(N).

A sharded state (a list of shards, shard r the amplitudes [r C, (r+1) C))
reduces per shard, each on its device, and the D partial sums then
cascade in shard order: for power-of-two shards the same pairing as the
whole state's cascade. A sharded density matrix's diagonal (its 2^n
entries, spread over the shards) is read where each shard holds it
(:func:`density_diagonal_parts`): its trace so, the readouts that need
the whole diagonal on the first shard's device
(:func:`density_diagonal_shards`), where the one-device reductions of the
diagonal run in their own order.
"""

from __future__ import annotations

import contextlib

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


def inner_product(bra: torch.Tensor, ket: torch.Tensor):
    """<bra|ket> with bra conjugated (statevec_calcInnerProduct); returns a
    (re, im) pair of 0-d tensors."""
    re = _csum(bra[0] * ket[0] + bra[1] * ket[1])
    im = _csum(bra[0] * ket[1] - bra[1] * ket[0])
    return re, im


def density_inner_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Re(Tr(a^dagger b)) = sum Re(conj(a_i) b_i)
    (densmatr_calcInnerProductLocal, QuEST_cpu.c:975-1003)."""
    return _csum(a[0] * b[0] + a[1] * b[1])


def hilbert_schmidt_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sqrt(sum |a_ij - b_ij|^2) (densmatr_calcHilbertSchmidtDistance)."""
    d = a - b
    return torch.sqrt(_csum(d[0] * d[0] + d[1] * d[1]))


@contextlib.contextmanager
def _full_fp32_matmul():
    """Float32 products in full FP32 for the block, never TF32, whatever the
    process-wide flag says; the flag is restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def density_fidelity(rho_amps: torch.Tensor, pure_amps: torch.Tensor, *,
                     n: int) -> torch.Tensor:
    """<psi| rho |psi>, real part (densmatr_calcFidelityLocal, QuEST_cpu.c:1007).

    The flat layout is [col, row], so as a matrix mat[c, r] = rho(r, c) and
    <psi|rho|psi> = sum_r conj(psi_r) (mat^T psi)_r. The products run in
    full FP32 (f32) or FP64, as the JAX package's at Precision.HIGHEST.
    """
    dim = 1 << n
    m = rho_amps.reshape(2, dim, dim)
    mr, mi = m[0].T, m[1].T
    pr, pi = pure_amps[0], pure_amps[1]
    with _full_fp32_matmul():
        vr = mr @ pr - mi @ pi
        vi = mr @ pi + mi @ pr
    return _csum(pr * vr + pi * vi)


def _csum_parts(parts) -> torch.Tensor:
    """The per-shard partial sums (0-d tensors), cascaded in shard order on
    the first shard's device."""
    return _csum(torch.stack([p.to(parts[0].device) for p in parts]))


#: the amplitudes a shard's norm and marginal reductions, and the sharded
#: sampler's row scans, take at a time: beyond it a shard is reduced in
#: contiguous pieces, whose partial sums cascade as the whole shard's
#: would, so no temporary grows with the shard. 2^21: on the H100 a 26q
#: shot stage over 4 shards replays 30% faster than at 2^20 and no faster
#: at 2^22, and its temporaries (~28 bytes an entry) stay within one
#: f32 shard's bytes beside 2^20 shots
CHUNK_BITS = 21


def total_prob_chunked(amps: torch.Tensor) -> torch.Tensor:
    """:func:`total_prob_statevec` of one planar tensor, taken in pieces of
    2^CHUNK_BITS amplitudes (the top index bits select the piece) whose
    sums cascade in order: the adjacent-pair cascade's bits in f32, and no
    temporary larger than a piece."""
    m = amps.shape[-1]
    if m <= 1 << CHUNK_BITS:
        return total_prob_statevec(amps)
    w = 1 << CHUNK_BITS
    return _csum(torch.stack([total_prob_statevec(amps[:, i:i + w])
                              for i in range(0, m, w)]))


def total_prob_shards(shards) -> torch.Tensor:
    """sum |amp|^2 of a sharded state vector: each shard's sum on its device
    (:func:`total_prob_chunked`), cascaded in shard order on the first
    shard's device; a 0-d tensor, read by nobody until the caller does."""
    return _csum_parts([total_prob_chunked(s) for s in shards])


def inner_product_shards(bra_shards, ket_shards):
    """<bra|ket> of two sharded state vectors of one layout: each shard
    pair's partial (re, im) on its device, cascaded in shard order."""
    parts = [inner_product(b, k) for b, k in zip(bra_shards, ket_shards)]
    return _csum_parts([p[0] for p in parts]), _csum_parts([p[1] for p in parts])


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


def expec_diag_op_statevec(amps: torch.Tensor, elems: torch.Tensor):
    """sum |amp_i|^2 d_i as a (re, im) pair of 0-d tensors
    (statevec_calcExpecDiagonalOp, QuEST_cpu_distributed.c:1612-1647);
    ``elems`` in the state's dtype."""
    p = amps[0] * amps[0] + amps[1] * amps[1]
    return _csum(p * elems[0]), _csum(p * elems[1])


def expec_diag_op_density(amps: torch.Tensor, elems: torch.Tensor, *, n: int,
                          diag: torch.Tensor | None = None):
    """Tr(rho D) = sum_r rho[r,r] d_r, (re, im) (densmatr_calcExpecDiagonalOp).
    A sharded register passes its gathered (2, 2^n) diagonal as ``diag``."""
    dim = 1 << n
    if diag is None:
        t = amps.reshape(2, dim, dim)
        diag = torch.stack([torch.diagonal(t[0]), torch.diagonal(t[1])])
    dr, di = diag[0], diag[1]
    er, ei = elems[0], elems[1]
    return _csum(dr * er - di * ei), _csum(dr * ei + di * er)


def expec_diag_op_shards(shards, elem_shards):
    """:func:`expec_diag_op_statevec` of a sharded state vector, the
    operator cut as the state: each shard's partial (re, im) on its
    device, cascaded in shard order."""
    parts = [expec_diag_op_statevec(s, e) for s, e in zip(shards, elem_shards)]
    return _csum_parts([p[0] for p in parts]), _csum_parts([p[1] for p in parts])


def density_diagonal_parts(shards, *, n: int) -> list:
    """Each shard's entries of the diagonal rho[i, i] (flat index i (2^n +
    1)) of a sharded n-qubit density matrix, as (2, k) tensors on the
    shard's own device, in shard order. While the mesh has at most 2^n
    devices a shard holds whole columns, and its entries are the diagonal
    of one square block of its (columns, rows) view: shard r holds the
    diagonal's [r m, (r+1) m), a sharded diagonal of n - d local qubits.
    A register of less than a column a shard gives one part, its whole
    diagonal on the first shard's device: a diagonal of n local qubits."""
    dim, c = 1 << n, shards[0].shape[-1]
    if c % dim == 0:
        m = c // dim
        return [torch.diagonal(s.reshape(2, m, dim)[:, :, r * m:(r + 1) * m], dim1=1, dim2=2)
                for r, s in enumerate(shards)]
    dev = shards[0].device
    parts = []
    for r, s in enumerate(shards):
        lo, hi = r * c, (r + 1) * c
        idx = [i * (dim + 1) - lo for i in range(dim) if lo <= i * (dim + 1) < hi]
        parts.append(s[:, idx].to(dev))
    return [torch.cat(parts, dim=1)]


def density_diagonal_shards(shards, *, n: int) -> torch.Tensor:
    """The (2, 2^n) diagonal of a sharded n-qubit density matrix on the first
    shard's device: :func:`density_diagonal_parts` joined in order."""
    dev = shards[0].device
    return torch.cat([p.to(dev) for p in density_diagonal_parts(shards, n=n)], dim=1)


def total_prob_density_shards(shards, *, n: int) -> torch.Tensor:
    """Re(trace(rho)) of a sharded density matrix: each shard's diagonal
    entries summed on its device, the partial sums cascaded in shard order
    (the diagonal never gathered; in f32 the bits of the whole diagonal's
    cascade)."""
    return _csum_parts([_csum(p[0]) for p in density_diagonal_parts(shards, n=n)])


def hilbert_schmidt_distance_shards(a_shards, b_shards) -> torch.Tensor:
    """:func:`hilbert_schmidt_distance` of two sharded density matrices of
    one layout: each shard pair's sum on its device, cascaded in order."""
    parts = []
    for a, b in zip(a_shards, b_shards):
        d = a - b
        parts.append(_csum(d[0] * d[0] + d[1] * d[1]))
    return torch.sqrt(_csum_parts(parts))


def density_inner_product_shards(a_shards, b_shards) -> torch.Tensor:
    """:func:`density_inner_product` of two sharded density matrices of one
    layout, each shard pair's partial cascaded in shard order."""
    return _csum_parts([density_inner_product(a, b) for a, b in zip(a_shards, b_shards)])


def density_fidelity_shards(shards, pure: torch.Tensor, *, n: int) -> torch.Tensor:
    """:func:`density_fidelity` of a sharded density matrix: shard r holds
    whole columns c of rho (the mesh at most 2^n devices), so it adds
    rho[:, c] psi_c over its columns into a partial (rho psi) on its
    device; the partials are summed in shard order on the first shard's
    device. ``pure`` is the whole (2, 2^n) state vector. A tiny register
    with less than a column a shard is gathered whole."""
    dim = 1 << n
    m = shards[0].shape[-1] // dim
    dev = shards[0].device
    if shards[0].shape[-1] % dim:
        whole = torch.cat([s.to(dev) for s in shards], dim=1)
        return density_fidelity(whole, pure.to(dev), n=n)
    vr = vi = None
    for r, s in enumerate(shards):
        p = pure.to(s.device)
        cols = p[:, r * m:(r + 1) * m]
        t = s.reshape(2, m, dim)
        with _full_fp32_matmul():
            pr = (t[0].T @ cols[0] - t[1].T @ cols[1]).to(dev)
            pi = (t[0].T @ cols[1] + t[1].T @ cols[0]).to(dev)
        vr = pr if vr is None else vr + pr
        vi = pi if vi is None else vi + pi
    p = pure.to(dev)
    return _csum(p[0] * vr + p[1] * vi)
