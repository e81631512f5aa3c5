"""Calculations: probabilities, inner products, fidelities, distances,
Pauli expectation values and amplitude reads of state-vector and density
registers (reference QuEST.h:2404-2516, 3544-3799, 4247-4917; reductions in
ops.reduce and ops.measure), sharded state vectors included.

Where two registers take part and one is sharded while the other lies on
one device, the second is re-cut into the first's layout by
device-to-device copies (``state_init._in_layout``) before the reduction,
as the JAX package's arrays meet whatever their shardings. A sharded
density matrix reduces per shard where the one-device reduction runs over
all amplitudes (purity, inner products, distances); its trace, outcome
probabilities and diagonal expectation values read its diagonal, gathered
onto the first shard's device (``ops.reduce.density_diagonal_shards``)
and then summed in the one-device order.
"""

from __future__ import annotations

import numpy as np
import torch

from . import matrices, validation as V
from ._capture import to_device
from .datatypes import PauliHamil
from .ops import apply as K, cplx, diagonal as D, measure as M, reduce as R
from .parallel.scheduler import engine
from .registers import Qureg
from .state_init import _in_layout, _pieces, _whole

__all__ = [
    "calcTotalProb", "calcProbOfOutcome", "calcProbOfAllOutcomes",
    "calcInnerProduct", "calcDensityInnerProduct", "calcPurity", "calcFidelity",
    "calcHilbertSchmidtDistance", "calcExpecPauliProd", "calcExpecPauliSum",
    "calcExpecPauliHamil", "calcGradExpecPauliSum", "getAmp", "getRealAmp", "getImagAmp",
    "getProbAmp", "getDensityAmp",
]


def _pieces_like(first: Qureg, second: Qureg) -> list:
    """``second``'s amplitude tensors in ``first``'s layout: its own where
    the two share one, else a copy re-cut into it."""
    a, b = _pieces(first), _pieces(second)
    if len(a) == len(b) and all(x.device == y.device for x, y in zip(a, b)):
        return b
    return _in_layout(second, a, second.dtype)


def _inner(bra: list, ket: list):
    """<bra|ket> of two states given as pieces of one layout, (re, im)."""
    if len(bra) == 1:
        return R.inner_product(bra[0], ket[0])
    return R.inner_product_shards(bra, ket)


def _trace(pieces: list, n: int) -> torch.Tensor:
    """Re tr(rho) of an n-qubit density matrix given as its pieces."""
    if len(pieces) == 1:
        return R.total_prob_density(pieces[0], n=n)
    return R.total_prob_density_shards(pieces, n=n)


def calcTotalProb(qureg: Qureg) -> float:
    """sum |amp|^2 (state-vector) or Re tr(rho) (density) (QuEST.h:2516)."""
    if qureg.is_density_matrix:
        return float(_trace(_pieces(qureg), qureg.num_qubits_represented))
    if qureg.shards is not None:
        return float(R.total_prob_shards(qureg.shards))
    return float(R.total_prob_statevec(qureg.amps))


def calcProbOfOutcome(qureg: Qureg, target: int, outcome: int) -> float:
    """Probability of measuring ``outcome`` on ``target`` (QuEST.h:276)."""
    func = "calcProbOfOutcome"
    V.validate_target(qureg, target, func)
    V.validate_outcome(outcome, func)
    if qureg.shards is not None and qureg.is_density_matrix:
        n = qureg.num_qubits_represented
        return float(M.density_prob_of_outcome(
            None, n=n, target=target, outcome=outcome,
            diag=R.density_diagonal_shards(qureg.shards, n=n)[0]))
    if qureg.shards is not None:
        return float(R.prob_of_outcome_shards(qureg.shards, n=qureg.num_qubits_in_state_vec,
                                              target=target, outcome=outcome))
    if qureg.is_density_matrix:
        return float(M.density_prob_of_outcome(
            qureg.amps, n=qureg.num_qubits_represented, target=target, outcome=outcome))
    return float(R.prob_of_outcome(qureg.amps, n=qureg.num_qubits_in_state_vec,
                                   target=target, outcome=outcome))


def calcProbOfAllOutcomes(qureg: Qureg, targets) -> np.ndarray:
    """2^t outcome distribution; targets[0] is the outcome's least-significant
    bit (QuEST.h:3633)."""
    func = "calcProbOfAllOutcomes"
    V.validate_multi_targets(qureg, targets, func)
    targets = tuple(int(t) for t in targets)
    if qureg.shards is not None and qureg.is_density_matrix:
        p = M.density_prob_of_all_outcomes_shards(qureg.shards, n=qureg.num_qubits_represented,
                                                  targets=targets)
    elif qureg.shards is not None:
        p = M.prob_of_all_outcomes_shards(qureg.shards, n=qureg.num_qubits_in_state_vec,
                                          targets=targets)
    elif qureg.is_density_matrix:
        p = M.density_prob_of_all_outcomes(qureg.amps, n=qureg.num_qubits_represented,
                                           targets=targets)
    else:
        p = M.prob_of_all_outcomes(qureg.amps, n=qureg.num_qubits_in_state_vec,
                                   targets=targets)
    return p.cpu().numpy()


def calcInnerProduct(bra: Qureg, ket: Qureg) -> complex:
    """<bra|ket> (QuEST.h:3746)."""
    func = "calcInnerProduct"
    V.validate_state_vec(bra, func)
    V.validate_state_vec(ket, func)
    V.validate_matching_qureg_dims(bra, ket, func)
    re, im = _inner(_pieces(bra), _pieces_like(bra, ket))
    return complex(float(re), float(im))


def calcDensityInnerProduct(rho1: Qureg, rho2: Qureg) -> float:
    """Re Tr(rho1^dag rho2) (QuEST.h:3799)."""
    func = "calcDensityInnerProduct"
    V.validate_density_matr(rho1, func)
    V.validate_density_matr(rho2, func)
    V.validate_matching_qureg_dims(rho1, rho2, func)
    a, b = _pieces(rho1), _pieces_like(rho1, rho2)
    if len(a) == 1:
        return float(R.density_inner_product(a[0], b[0]))
    return float(R.density_inner_product_shards(a, b))


def calcPurity(qureg: Qureg) -> float:
    """Tr(rho^2) (QuEST.h:4247)."""
    V.validate_density_matr(qureg, "calcPurity")
    if qureg.shards is not None:
        return float(R.total_prob_shards(qureg.shards))
    return float(R.purity_density(qureg.amps))


def calcFidelity(qureg: Qureg, pure_state: Qureg) -> float:
    """|<psi|phi>|^2 or <psi|rho|psi> (QuEST.h:4283)."""
    func = "calcFidelity"
    V.validate_second_qureg_state_vec(pure_state, func)
    V.validate_matching_qureg_dims(qureg, pure_state, func)
    if qureg.is_density_matrix:
        n = qureg.num_qubits_represented
        whole = _whole(pure_state, qureg.device, qureg.dtype)
        if qureg.shards is not None:
            return float(R.density_fidelity_shards(qureg.shards, whole, n=n))
        return float(R.density_fidelity(qureg.amps, whole, n=n))
    pure = _pieces_like(qureg, pure_state)
    re, im = _inner(_pieces(qureg), pure)
    return float(re) ** 2 + float(im) ** 2


def calcHilbertSchmidtDistance(a: Qureg, b: Qureg) -> float:
    """sqrt(sum |a-b|^2) (QuEST.h:5663)."""
    func = "calcHilbertSchmidtDistance"
    V.validate_density_matr(a, func)
    V.validate_density_matr(b, func)
    V.validate_matching_qureg_dims(a, b, func)
    x, y = _pieces(a), _pieces_like(a, b)
    if len(x) == 1:
        return float(R.hilbert_schmidt_distance(x[0], y[0]))
    return float(R.hilbert_schmidt_distance_shards(x, y))


# ---------------------------------------------------------------------------
# Pauli expectation values (logic: QuEST_common.c:491-555)
# ---------------------------------------------------------------------------

def _pauli_prod(pieces: list, targets, codes, *, nsv: int, eng=None) -> list:
    """P|state> for the product of Pauli ``codes`` on ``targets``, gate by
    gate through the per-gate engine (X as ``apply_x_class``, Y as
    ``apply_matrix`` of PAULI_Y_M, Z as ``apply_diagonal``): on the state's
    one tensor, or on its shards through ``eng``, the register's engine over
    shards. A density matrix is a plain 2N-qubit vector here (no shadow op),
    as the reference's clone-based scheme (QuEST_common.c:505-518). Returns
    new tensors; the input is left as it was."""
    dt, dev = pieces[0].dtype, pieces[0].device
    y = cplx.from_complex(matrices.PAULI_Y_M, dt, dev)
    z = cplx.from_complex(np.array([1.0, -1.0]), dt, dev)
    for t, c in zip(targets, codes):
        t, c = (int(t),), int(c)
        if c == 0:
            continue
        if eng is not None:
            pieces = (eng.apply_x(pieces, n=nsv, targets=t) if c == 1 else
                      eng.apply_matrix(pieces, y, n=nsv, targets=t) if c == 2 else
                      eng.apply_diagonal(pieces, z, n=nsv, targets=t))
        else:
            a = pieces[0]
            pieces = [K.apply_x_class(a, n=nsv, targets=t) if c == 1 else
                      K.apply_matrix(a, y, n=nsv, targets=t) if c == 2 else
                      D.apply_diagonal(a, z, n=nsv, targets=t)]
    return pieces


def calcExpecPauliProd(qureg: Qureg, targets, paulis, workspace: Qureg) -> float:
    """<qureg| P |qureg>, or Re Tr(P rho) for a density matrix (QuEST.h:4777).
    The workspace is left holding P|qureg> (P applied to the flattened
    density matrix as a plain 2N-qubit vector), the reference's contract."""
    func = "calcExpecPauliProd"
    V.validate_multi_targets(qureg, targets, func)
    V.validate_num_pauli_codes(paulis, len(targets), func)
    V.validate_matching_qureg_types(qureg, workspace, func)
    V.validate_matching_qureg_dims(qureg, workspace, func)
    work = _in_layout(qureg, _pieces(workspace), qureg.dtype)
    eng = engine(workspace, scheduled=False) if workspace.shards is not None else None
    work = _pauli_prod(work, targets, paulis, nsv=qureg.num_qubits_in_state_vec, eng=eng)
    if workspace.shards is not None:
        workspace.put_shards(work)
    else:
        workspace.put(work[0])
    if qureg.is_density_matrix:
        # Tr(P rho): the reference takes densmatr_calcTotalProb of P.rho
        return float(_trace(_pieces(workspace), qureg.num_qubits_represented))
    return float(_inner(_pieces(qureg), _pieces_like(qureg, workspace))[0])


def _expec_pauli_sum(pieces: list, coeffs, *, codes, n: int, density: bool,
                     eng=None) -> torch.Tensor:
    """sum_t c_t <P_t> over a state given as its one tensor or its shards
    (through ``eng``), as a 0-d tensor of the state's dtype on its first
    device; nothing is read back to the host until the caller does."""
    nsv = (2 if density else 1) * n
    # staged: inside a compiled replay (a request's terminal reduce) the
    # coefficients are copied to the device once
    coeffs = to_device(np.asarray(coeffs, dtype=np.float64), pieces[0].dtype,
                       pieces[0].device)
    total = torch.zeros((), dtype=pieces[0].dtype, device=pieces[0].device)
    for t, term in enumerate(codes):
        work = _pauli_prod(pieces, range(len(term)), term, nsv=nsv, eng=eng)
        if density:
            val = _trace(work, n)
        else:
            val = _inner(pieces, work)[0]
        total = total + coeffs[t] * val.to(total.device)
    return total


def expec_pauli_sum_amps(amps, coeffs, *, codes, n: int, density: bool) -> torch.Tensor:
    """sum_t c_t <P_t> of the planar ``amps`` (one tensor, or a sharded
    state's list of shards: each term through the engine over shards), the
    body of :func:`calcExpecPauliSum` as a function of a state: ``codes``
    is a sequence of code tuples (codes[t][q] on qubit q), ``coeffs`` their
    weights; a 0-d tensor of the state's dtype on its (first) device. The
    JAX package's ``expec_pauli_sum_amps``, which sampling and gradients
    reuse."""
    if isinstance(amps, (list, tuple)):
        from .parallel.scheduler import DistributedScheduler
        return _expec_pauli_sum(list(amps), coeffs, codes=codes, n=n, density=density,
                                eng=DistributedScheduler(tuple(a.device for a in amps),
                                                         allow_defer=False))
    return _expec_pauli_sum([amps], coeffs, codes=codes, n=n, density=density)


def calcExpecPauliSum(qureg: Qureg, all_pauli_codes, term_coeffs, workspace: Qureg) -> float:
    """sum_t c_t <P_t> (QuEST.h:4832). The workspace is validated and left as
    it was: every term's P|qureg> is a temporary, as in the JAX package's
    fused route."""
    func = "calcExpecPauliSum"
    codes = np.asarray(all_pauli_codes, dtype=np.int32).reshape(len(term_coeffs), -1)
    V._assert(codes.size == len(term_coeffs) * qureg.num_qubits_represented,
              "Invalid number of Pauli codes. The number of codes must equal numQubits * numSumTerms.",
              func)
    V.validate_pauli_codes(codes.ravel(), func)
    V.validate_matching_qureg_types(qureg, workspace, func)
    V.validate_matching_qureg_dims(qureg, workspace, func)
    eng = engine(qureg, scheduled=False) if qureg.shards is not None else None
    total = _expec_pauli_sum(_pieces(qureg), term_coeffs,
                             codes=[tuple(int(c) for c in row) for row in codes],
                             n=qureg.num_qubits_represented,
                             density=qureg.is_density_matrix, eng=eng)
    return float(total)


def calcExpecPauliHamil(qureg: Qureg, hamil: PauliHamil, workspace: Qureg) -> float:
    """(QuEST.h:4873)."""
    func = "calcExpecPauliHamil"
    V.validate_pauli_hamil(hamil, func)
    V.validate_hamil_matches_qureg(qureg, hamil, func)
    return calcExpecPauliSum(qureg, hamil.pauli_codes, hamil.term_coeffs, workspace)


def calcGradExpecPauliSum(qureg: Qureg, circuit, all_pauli_codes, term_coeffs,
                          params=None):
    """The value and the parameter gradients of ``sum_t c_t <P_t>`` after
    ``circuit`` acts on ``qureg``'s current state, by the adjoint-state
    method (:mod:`.gradients`): one forward sweep, one application of the
    Hamiltonian, one backward sweep, in one compiled program. ``qureg`` is
    read, never written. Returns ``(value, grads)``, ``grads`` a name ->
    float dict over the circuit's named Params. The serving route is
    ``Engine.submit_grad`` over the same program."""
    from .gradients import gradient_executable

    func = "calcGradExpecPauliSum"
    V._assert(not qureg.is_density_matrix,
              "calcGradExpecPauliSum needs a state-vector register (the adjoint sweep "
              "differentiates pure states).", func)
    amps = qureg.amps if qureg.shards is None else list(qureg.shards)
    out = gradient_executable(circuit, (all_pauli_codes, term_coeffs),
                              donate=False)(amps, params)
    return float(out["value"]), {k: float(v) for k, v in out["grads"].items()}


# ---------------------------------------------------------------------------
# amplitude getters (QuEST.h:2404-2489)
# ---------------------------------------------------------------------------

def getAmp(qureg: Qureg, index: int) -> complex:
    """One statevector amplitude as a complex (QuEST.h:286)."""
    func = "getAmp"
    V.validate_state_vec(qureg, func)
    V.validate_amp_index(qureg, index, func)
    if qureg.shards is not None:  # index -> (shard, offset)
        c = qureg.num_amps_total // len(qureg.shards)
        re, im = qureg.shards[index // c][:, index % c].tolist()
    else:
        re, im = qureg.amps[:, index].tolist()
    return complex(re, im)


def getRealAmp(qureg: Qureg, index: int) -> float:
    """Real part of one statevector amplitude (QuEST.h:287)."""
    return getAmp(qureg, index).real


def getImagAmp(qureg: Qureg, index: int) -> float:
    """Imaginary part of one statevector amplitude (QuEST.h:288)."""
    return getAmp(qureg, index).imag


def getProbAmp(qureg: Qureg, index: int) -> float:
    """|amp|^2 of one statevector amplitude (QuEST.h:289)."""
    a = getAmp(qureg, index)
    return a.real * a.real + a.imag * a.imag


def getDensityAmp(qureg: Qureg, row: int, col: int) -> complex:
    """rho[row, col] (QuEST.h:2489); flat index col * 2^n + row."""
    func = "getDensityAmp"
    V.validate_density_matr(qureg, func)
    dim = 1 << qureg.num_qubits_represented
    V._assert(0 <= row < dim and 0 <= col < dim,
              "Invalid amplitude index. Note amplitudes are zero indexed.", func)
    index = col * dim + row
    if qureg.shards is not None:  # index -> (shard, offset)
        c = qureg.num_amps_total // len(qureg.shards)
        re, im = qureg.shards[index // c][:, index % c].tolist()
    else:
        re, im = qureg.amps[:, index].tolist()
    return complex(re, im)
