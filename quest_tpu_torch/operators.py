"""Operators: possibly non-unitary applications and structured operators
(reference QuEST.h:5688-7421 and the DiagonalOp family QuEST.h:1033-1513),
every function of ``quest_tpu/operators.py``.

``applyMatrix2``/``applyMatrix4``/``applyMatrixN``/
``applyMultiControlledMatrixN`` LEFT-multiply a density register (M rho,
no conj-shadow); the Gate variants apply M rho M^dagger. Neither asks for
unitarity. Pauli sums apply each term through the per-gate engine
(``calculations._pauli_prod``); ``applyTrotterCircuit``, ``applyFullQFT``
and ``applyQFT`` go through the gate functions, so that a Circuit tape
captures them into fused gate runs (``fusion.capture``). Phase functions
(``ops.phasefunc``), projectors, ``DiagonalOp`` and sub-diagonal
operators apply their own torch ops and stay fusion barriers, as in the
JAX package. A ``DiagonalOp`` holds its elements in the global
precision's dtype, cast to the register's at apply time.

On a sharded register everything runs shard by shard or through the
per-gate engine over shards, a density register's shadow on the qubits
q + n too; phase functions, projectors and diagonals need no
communication. ``setQuregToPauliHamil`` builds the operator on the first
shard's device and cuts it into the shards.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import precision, validation as V
from .datatypes import DiagonalOp, PauliHamil, SubDiagonalOp
from .ops import apply as K, cplx, diagonal as D, init as I, measure as M
from .ops import phasefunc as PF, reduce as R
from .registers import Qureg, sharded_over

__all__ = [
    "applyMatrix2", "applyMatrix4", "applyMatrixN", "applyGateMatrixN",
    "applyMultiControlledMatrixN", "applyMultiControlledGateMatrixN",
    "applyPauliSum", "applyPauliHamil", "applyTrotterCircuit",
    "applyFullQFT", "applyQFT", "applyProjector",
    "applyPhaseFunc", "applyPhaseFuncOverrides",
    "applyMultiVarPhaseFunc", "applyMultiVarPhaseFuncOverrides",
    "applyNamedPhaseFunc", "applyNamedPhaseFuncOverrides",
    "applyParamNamedPhaseFunc", "applyParamNamedPhaseFuncOverrides",
    "createDiagonalOp", "destroyDiagonalOp", "syncDiagonalOp",
    "initDiagonalOp", "setDiagonalOpElems", "initDiagonalOpFromPauliHamil",
    "createDiagonalOpFromPauliHamilFile", "applyDiagonalOp",
    "calcExpecDiagonalOp", "applySubDiagonalOp", "applyGateSubDiagonalOp",
    "setQuregToPauliHamil",
]


def _record(qureg, text):
    if qureg.qasm_log is not None:
        qureg.qasm_log.record_comment(text)


def _apply_matrix_left(qureg: Qureg, matrix, targets, controls=()):
    """M|psi> or M.rho (left multiplication only)."""
    m = cplx.from_complex(matrix, qureg.dtype, qureg.device)
    if qureg.shards is not None:
        _apply_sharded(qureg, m, targets, controls)
        return
    qureg.put(K.apply_matrix(qureg.amps, m, n=qureg.num_qubits_in_state_vec,
                             targets=tuple(targets), controls=tuple(controls)))


def _apply_matrix_gate(qureg: Qureg, matrix, targets, controls=()):
    """M|psi> or M.rho.M^dagger (the Gate variants). Not through
    ``gates._apply_gate_matrix``: ``fusion.capture`` patches that, and an
    operator entry stays a fusion barrier, as in the JAX package."""
    n, nsv = qureg.num_qubits_represented, qureg.num_qubits_in_state_vec
    m = cplx.from_complex(matrix, qureg.dtype, qureg.device)
    if qureg.shards is not None:
        _apply_sharded(qureg, m, targets, controls)
        if qureg.is_density_matrix:
            _apply_sharded(qureg, m, tuple(q + n for q in targets),
                           tuple(c + n for c in controls), conj=True)
        return
    amps = K.apply_matrix(qureg.amps, m, n=nsv, targets=tuple(targets),
                          controls=tuple(controls))
    if qureg.is_density_matrix:
        amps = K.apply_matrix(amps, m, n=nsv,
                              targets=tuple(q + n for q in targets),
                              controls=tuple(c + n for c in controls), conj=True)
    qureg.put(amps)


def _apply_sharded(qureg: Qureg, m, targets, controls, conj: bool = False) -> None:
    """M (``conj``: its conjugate) on the flattened qubits ``targets`` of a
    sharded register, through the per-gate engine over shards
    (``parallel.scheduler``)."""
    from .parallel.scheduler import engine

    qureg.put_shards(engine(qureg).apply_matrix(
        qureg.shards, m, n=qureg.num_qubits_in_state_vec, targets=tuple(targets),
        controls=tuple(controls), conj=conj))


def applyMatrix2(qureg: Qureg, target: int, u) -> None:
    """(QuEST.h:5892)."""
    func = "applyMatrix2"
    V.validate_target(qureg, target, func)
    V.validate_matrix_size(u, 1, func)
    _apply_matrix_left(qureg, u, (target,))
    _record(qureg, "applyMatrix2")


def applyMatrix4(qureg: Qureg, t1: int, t2: int, u) -> None:
    """Left-multiply a general 4x4 matrix, not necessarily unitary (QuEST.h:298)."""
    func = "applyMatrix4"
    V.validate_multi_targets(qureg, (t1, t2), func)
    V.validate_matrix_size(u, 2, func)
    _apply_matrix_left(qureg, u, (t1, t2))
    _record(qureg, "applyMatrix4")


def applyMatrixN(qureg: Qureg, targets, u) -> None:
    """Left-multiply a general 2^N x 2^N matrix, not necessarily unitary (QuEST.h:299)."""
    func = "applyMatrixN"
    V.validate_multi_targets(qureg, targets, func)
    V.validate_matrix_init(u, func)
    V.validate_matrix_size(u, len(targets), func)
    _apply_matrix_left(qureg, u, tuple(targets))
    _record(qureg, "applyMatrixN")


def applyGateMatrixN(qureg: Qureg, targets, u) -> None:
    """Applies M (and M^dagger on the bra side of a density matrix) without
    requiring unitarity (QuEST.h:6043)."""
    func = "applyGateMatrixN"
    V.validate_multi_targets(qureg, targets, func)
    V.validate_matrix_init(u, func)
    V.validate_matrix_size(u, len(targets), func)
    _apply_matrix_gate(qureg, u, tuple(targets))
    _record(qureg, "applyGateMatrixN")


def applyMultiControlledMatrixN(qureg: Qureg, controls, targets, u) -> None:
    """Left-multiply a controlled general matrix, not necessarily unitary (QuEST.h:301)."""
    func = "applyMultiControlledMatrixN"
    V.validate_multi_controls_multi_targets(qureg, controls, targets, func)
    V.validate_matrix_init(u, func)
    V.validate_matrix_size(u, len(targets), func)
    _apply_matrix_left(qureg, u, tuple(targets), tuple(controls))
    _record(qureg, "applyMultiControlledMatrixN")


def applyMultiControlledGateMatrixN(qureg: Qureg, controls, targets, u) -> None:
    """(QuEST.h:6094)."""
    func = "applyMultiControlledGateMatrixN"
    V.validate_multi_controls_multi_targets(qureg, controls, targets, func)
    V.validate_matrix_init(u, func)
    V.validate_matrix_size(u, len(targets), func)
    _apply_matrix_gate(qureg, u, tuple(targets), tuple(controls))
    _record(qureg, "applyMultiControlledGateMatrixN")


# ---------------------------------------------------------------------------
# Pauli sums and Hamiltonians (statevec_applyPauliSum, QuEST_common.c:534-555)
# ---------------------------------------------------------------------------

def applyPauliSum(in_qureg: Qureg, all_pauli_codes, term_coeffs, out_qureg: Qureg) -> None:
    """out = sum_t c_t P_t |in> (QuEST.h:5747). ``in_qureg`` is left as it
    was (the reference's apply-undo loop restores it)."""
    func = "applyPauliSum"
    codes = np.asarray(all_pauli_codes, dtype=np.int32).reshape(len(term_coeffs), -1)
    V._assert(codes.size == len(term_coeffs) * in_qureg.num_qubits_represented,
              "Invalid number of Pauli codes. The number of codes must equal numQubits * numSumTerms.",
              func)
    V.validate_pauli_codes(codes.ravel(), func)
    V.validate_matching_qureg_types(in_qureg, out_qureg, func)
    V.validate_matching_qureg_dims(in_qureg, out_qureg, func)
    _apply_pauli_sum(in_qureg, codes, term_coeffs, out_qureg)
    _record(out_qureg, "applyPauliSum")


def applyPauliHamil(in_qureg: Qureg, hamil: PauliHamil, out_qureg: Qureg) -> None:
    """(QuEST.h:5791)."""
    func = "applyPauliHamil"
    V.validate_pauli_hamil(hamil, func)
    V.validate_hamil_matches_qureg(in_qureg, hamil, func)
    V.validate_matching_qureg_types(in_qureg, out_qureg, func)
    V.validate_matching_qureg_dims(in_qureg, out_qureg, func)
    _apply_pauli_sum(in_qureg, hamil.pauli_codes, hamil.term_coeffs, out_qureg)
    _record(out_qureg, "applyPauliHamil")


def _apply_pauli_sum(in_qureg, codes, coeffs, out_qureg):
    """Accumulate c_t P_t |in> in term order, in ``in_qureg``'s layout and
    dtype (each P_t |in> a temporary of ``calculations._pauli_prod``; a
    density matrix is a plain 2N-qubit vector there, so the terms
    left-multiply it), then bind the sum to ``out_qureg``, re-cut into its
    layout where the two registers are cut differently."""
    from .calculations import _pauli_prod
    from .parallel.scheduler import engine
    from .state_init import _pieces, _put_pieces, _recut

    n = in_qureg.num_qubits_represented
    pieces = _pieces(in_qureg)
    eng = engine(in_qureg) if in_qureg.shards is not None else None
    out = [torch.zeros_like(p) for p in pieces]
    for t in range(codes.shape[0]):
        work = _pauli_prod(pieces, range(n), codes[t],
                           nsv=in_qureg.num_qubits_in_state_vec, eng=eng)
        c = float(coeffs[t])
        out = [o + c * w for o, w in zip(out, work)]
    like = _pieces(out_qureg)
    if len(like) != len(out) or any(a.device != b.device for a, b in zip(like, out)):
        out = _recut(out, like, out[0].dtype)
    _put_pieces(out_qureg, out)


def applyTrotterCircuit(qureg: Qureg, hamil: PauliHamil, time: float,
                        order: int, reps: int) -> None:
    """Symmetrised Trotter-Suzuki evolution e^{-iHt}
    (agnostic_applyTrotterCircuit, QuEST_common.c:762-844), through
    ``multiRotatePauli``; its gates record no QASM of their own."""
    func = "applyTrotterCircuit"
    V.validate_pauli_hamil(hamil, func)
    V.validate_hamil_matches_qureg(qureg, hamil, func)
    V.validate_trotter_params(order, reps, func)
    was_recording = qureg.qasm_log.recording if qureg.qasm_log else False
    if qureg.qasm_log:
        qureg.qasm_log.recording = False
    for _ in range(reps):
        _trotter_cycle(qureg, hamil, time / reps, order)
    if qureg.qasm_log:
        qureg.qasm_log.recording = was_recording
    _record(qureg, f"applyTrotterCircuit(t={time:g}, order={order}, reps={reps})")


def _first_order_trotter(qureg, hamil, time, reverse):
    from .gates import multiRotatePauli
    terms = range(hamil.num_sum_terms)
    if reverse:
        terms = reversed(list(terms))
    targets = list(range(hamil.num_qubits))
    for t in terms:
        angle = 2 * float(hamil.term_coeffs[t]) * time
        multiRotatePauli(qureg, targets, hamil.pauli_codes[t], angle)


def _trotter_cycle(qureg, hamil, time, order):
    # recursion of agnostic_applyTrotterCircuit (QuEST_common.c:800-844)
    if order == 1:
        _first_order_trotter(qureg, hamil, time, False)
    elif order == 2:
        _first_order_trotter(qureg, hamil, time / 2, False)
        _first_order_trotter(qureg, hamil, time / 2, True)
    else:
        p = 1.0 / (4 - 4 ** (1.0 / (order - 1)))
        _trotter_cycle(qureg, hamil, p * time, order - 2)
        _trotter_cycle(qureg, hamil, p * time, order - 2)
        _trotter_cycle(qureg, hamil, (1 - 4 * p) * time, order - 2)
        _trotter_cycle(qureg, hamil, p * time, order - 2)
        _trotter_cycle(qureg, hamil, p * time, order - 2)


def setQuregToPauliHamil(qureg: Qureg, hamil: PauliHamil) -> None:
    """rho = H as a dense operator (QuEST.h:1854; densmatr_setQuregToPauliHamil),
    built on the register's device (``ops.init.density_from_pauli_hamil``)."""
    func = "setQuregToPauliHamil"
    V.validate_density_matr(qureg, func)
    V.validate_pauli_hamil(hamil, func)
    V.validate_hamil_matches_qureg(qureg, hamil, func)
    rho = I.density_from_pauli_hamil(
        hamil.pauli_codes, hamil.term_coeffs, n=qureg.num_qubits_represented,
        dtype=qureg.dtype, device=qureg.device)
    if qureg.shards is not None:
        from .state_init import _recut
        qureg.put_shards(_recut([rho], qureg.shards, qureg.dtype))
    else:
        qureg.put(rho)


# ---------------------------------------------------------------------------
# QFT (agnostic_applyQFT, QuEST_common.c:846-908)
# ---------------------------------------------------------------------------

def _qft_on(qureg: Qureg, qubits) -> None:
    from .gates import controlledPhaseShift, hadamard, swapGate
    m = len(qubits)
    # textbook QFT: H + controlled phases, then qubit-order reversal
    for j in reversed(range(m)):
        hadamard(qureg, qubits[j])
        for k in range(j):
            angle = math.pi / (1 << (j - k))
            controlledPhaseShift(qureg, qubits[k], qubits[j], angle)
    for j in range(m // 2):
        swapGate(qureg, qubits[j], qubits[m - 1 - j])


def applyFullQFT(qureg: Qureg) -> None:
    """QFT on every qubit (QuEST.h:7277)."""
    was = qureg.qasm_log.recording if qureg.qasm_log else False
    if qureg.qasm_log:
        qureg.qasm_log.recording = False
    _qft_on(qureg, list(range(qureg.num_qubits_represented)))
    if qureg.qasm_log:
        qureg.qasm_log.recording = was
    _record(qureg, "applyFullQFT")


def applyQFT(qureg: Qureg, qubits) -> None:
    """QFT on a qubit subset (QuEST.h:7397)."""
    func = "applyQFT"
    V.validate_multi_targets(qureg, qubits, func)
    was = qureg.qasm_log.recording if qureg.qasm_log else False
    if qureg.qasm_log:
        qureg.qasm_log.recording = False
    _qft_on(qureg, list(qubits))
    if qureg.qasm_log:
        qureg.qasm_log.recording = was
    _record(qureg, f"applyQFT on {list(qubits)}")


def applyProjector(qureg: Qureg, target: int, outcome: int) -> None:
    """Unnormalised projection |outcome><outcome| on target (QuEST.h:7421);
    on a sharded target, whole shards are zeroed."""
    func = "applyProjector"
    V.validate_target(qureg, target, func)
    V.validate_outcome(outcome, func)
    n, nsv = qureg.num_qubits_represented, qureg.num_qubits_in_state_vec
    if qureg.shards is not None:
        shards = M.project_shards(qureg.shards, n=nsv, target=target, outcome=outcome)
        if qureg.is_density_matrix:
            shards = M.project_shards(shards, n=nsv, target=target + n, outcome=outcome)
        qureg.put_shards(shards)
    else:
        amps = M.project_statevec(qureg.amps, n=nsv, target=target, outcome=outcome)
        if qureg.is_density_matrix:
            amps = M.project_statevec(amps, n=nsv, target=target + n, outcome=outcome)
        qureg.put(amps)
    _record(qureg, f"applyProjector({outcome}) on q[{target}]")


# ---------------------------------------------------------------------------
# phase functions (QuEST.h:6407-7179; kernels in ops.phasefunc)
# ---------------------------------------------------------------------------

def _apply_phase(qureg, apply, qubits_flat, *args, **kwargs) -> None:
    """``apply`` (an ``ops.phasefunc`` function) on the register: shard by
    shard, or on its one tensor and, for a density matrix, again on the
    column qubits q + n with the phase negated."""
    nsv = qureg.num_qubits_in_state_vec
    row = tuple(int(q) for q in qubits_flat)
    if qureg.shards is not None:
        shards = PF.apply_phase_shards(apply, qureg.shards, *args, n=nsv, qubits=row,
                                       conj=False, **kwargs)
        if qureg.is_density_matrix:
            shifted = tuple(q + qureg.num_qubits_represented for q in row)
            shards = PF.apply_phase_shards(apply, shards, *args, n=nsv, qubits=shifted,
                                           conj=True, **kwargs)
        qureg.put_shards(shards)
        return
    amps = apply(qureg.amps, *args, n=nsv, qubits=row, conj=False, **kwargs)
    if qureg.is_density_matrix:
        shifted = tuple(q + qureg.num_qubits_represented for q in row)
        amps = apply(amps, *args, n=nsv, qubits=shifted, conj=True, **kwargs)
    qureg.put(amps)


def _phase_func_apply(qureg, qubits_flat, reg_sizes, encoding, coeffs, exponents,
                      terms_per_reg, override_inds, override_phases, func,
                      multi_var=False):
    V.validate_num_subregisters(len(reg_sizes), func)
    V.validate_multi_reg_bit_encoding(reg_sizes, encoding, func)
    for m, off in zip(reg_sizes, np.cumsum([0] + list(reg_sizes))[:-1]):
        V.validate_multi_targets(qureg, qubits_flat[off:off + m], func)
    n_ovr = len(override_phases)
    V.validate_num_phase_func_overrides(
        sum(reg_sizes), n_ovr, single_var=len(reg_sizes) == 1, func=func)
    V.validate_phase_func_overrides(reg_sizes, encoding, override_inds, n_ovr, func)
    _apply_phase(qureg, PF.apply_poly_phase, qubits_flat, list(coeffs),
                 list(override_inds), list(override_phases),
                 reg_sizes=tuple(int(m) for m in reg_sizes), encoding=int(encoding),
                 exponents=tuple(float(e) for e in exponents),
                 num_terms_per_reg=tuple(int(t) for t in terms_per_reg))
    if qureg.qasm_log is not None:
        if not multi_var:
            qureg.qasm_log.record_phase_func(
                list(qubits_flat), encoding, list(coeffs), list(exponents),
                list(override_inds), list(override_phases))
        else:
            qureg.qasm_log.record_multi_var_phase_func(
                list(qubits_flat), list(reg_sizes), encoding, list(coeffs),
                list(exponents), list(terms_per_reg), list(override_inds),
                list(override_phases))


def applyPhaseFunc(qureg: Qureg, qubits, encoding, coeffs, exponents) -> None:
    """phase(r) = sum_t coeffs[t] r^exponents[t] on the sub-register value r
    (QuEST.h:6407)."""
    applyPhaseFuncOverrides(qureg, qubits, encoding, coeffs, exponents, [], [])


def applyPhaseFuncOverrides(qureg: Qureg, qubits, encoding, coeffs, exponents,
                            override_inds, override_phases) -> None:
    """(QuEST.h:6518)."""
    func = "applyPhaseFuncOverrides"
    V.validate_phase_func_terms(len(qubits), encoding, coeffs, exponents,
                                list(override_inds), len(override_phases), func)
    _phase_func_apply(qureg, list(qubits), [len(qubits)], encoding, coeffs,
                      exponents, [len(coeffs)], override_inds, override_phases, func)


def applyMultiVarPhaseFunc(qureg: Qureg, qubits_flat, num_qubits_per_reg, encoding,
                           coeffs, exponents, num_terms_per_reg) -> None:
    """(QuEST.h:6679)."""
    applyMultiVarPhaseFuncOverrides(qureg, qubits_flat, num_qubits_per_reg, encoding,
                                    coeffs, exponents, num_terms_per_reg, [], [])


def applyMultiVarPhaseFuncOverrides(qureg: Qureg, qubits_flat, num_qubits_per_reg,
                                    encoding, coeffs, exponents, num_terms_per_reg,
                                    override_inds, override_phases) -> None:
    """(QuEST.h:6761)."""
    func = "applyMultiVarPhaseFuncOverrides"
    V.validate_num_subregisters(len(num_qubits_per_reg), func)
    V._assert(sum(num_terms_per_reg) == len(coeffs) == len(exponents)
              and all(t > 0 for t in num_terms_per_reg),
              "Invalid number of terms in the phase function specified. Must be >0.",
              func)
    V.validate_multi_var_phase_func_terms(encoding, exponents, func)
    _phase_func_apply(qureg, list(qubits_flat), list(num_qubits_per_reg), encoding,
                      coeffs, exponents, list(num_terms_per_reg),
                      override_inds, override_phases, func, multi_var=True)


def applyNamedPhaseFunc(qureg: Qureg, qubits_flat, num_qubits_per_reg, encoding,
                        func_name) -> None:
    """(QuEST.h:6901)."""
    applyParamNamedPhaseFuncOverrides(qureg, qubits_flat, num_qubits_per_reg,
                                      encoding, func_name, [], [], [])


def applyNamedPhaseFuncOverrides(qureg: Qureg, qubits_flat, num_qubits_per_reg,
                                 encoding, func_name, override_inds,
                                 override_phases) -> None:
    """(QuEST.h:6974)."""
    applyParamNamedPhaseFuncOverrides(qureg, qubits_flat, num_qubits_per_reg,
                                      encoding, func_name, [],
                                      override_inds, override_phases)


def applyParamNamedPhaseFunc(qureg: Qureg, qubits_flat, num_qubits_per_reg,
                             encoding, func_name, params) -> None:
    """(QuEST.h:7104)."""
    applyParamNamedPhaseFuncOverrides(qureg, qubits_flat, num_qubits_per_reg,
                                      encoding, func_name, params, [], [])


def applyParamNamedPhaseFuncOverrides(qureg: Qureg, qubits_flat, num_qubits_per_reg,
                                      encoding, func_name, params,
                                      override_inds, override_phases) -> None:
    """(QuEST.h:7179)."""
    func = "applyParamNamedPhaseFuncOverrides"
    reg_sizes = [int(m) for m in num_qubits_per_reg]
    V.validate_num_subregisters(len(reg_sizes), func)
    V.validate_phase_func_name(int(func_name), func)
    V.validate_num_regs_distance_phase_func(int(func_name), len(reg_sizes), func)
    V.validate_multi_reg_bit_encoding(reg_sizes, encoding, func)
    V.validate_num_named_phase_func_params(int(func_name), len(reg_sizes),
                                           len(params or []), func)
    n_ovr = len(override_phases)
    V.validate_num_phase_func_overrides(
        sum(reg_sizes), n_ovr, single_var=len(reg_sizes) == 1, func=func)
    V.validate_phase_func_overrides(reg_sizes, encoding, override_inds, n_ovr, func)
    for m, off in zip(reg_sizes, np.cumsum([0] + reg_sizes)[:-1]):
        V.validate_multi_targets(qureg, list(qubits_flat)[off:off + m], func)
    # pad params so indexed accesses (params[2+r] etc.) are always in range
    padded = list(map(float, params)) + [0.0] * (2 + 2 * len(reg_sizes))
    _apply_phase(qureg, PF.apply_named_phase, qubits_flat, padded,
                 list(override_inds), list(override_phases), reg_sizes=tuple(reg_sizes),
                 encoding=int(encoding), func_name=int(func_name))
    if qureg.qasm_log is not None:
        qureg.qasm_log.record_named_phase_func(
            list(qubits_flat), reg_sizes, encoding, int(func_name),
            list(params) if params else [], list(override_inds),
            list(override_phases))


# ---------------------------------------------------------------------------
# DiagonalOp (QuEST.h:1033-1314) -- full 2^N diagonal, cut like a Qureg
# ---------------------------------------------------------------------------

def createDiagonalOp(num_qubits: int, env) -> DiagonalOp:
    """Allocate an all-zero 2^N diagonal operator in the env (QuEST.h:175):
    on its device, or over its mesh as a state-vector register of N qubits
    is cut (one that has fewer elements than the mesh has devices stays on
    the first device, as the JAX package's single-host mesh keeps it)."""
    func = "createDiagonalOp"
    V.validate_num_qubits(num_qubits, func)
    V.validate_num_amps_fit_type(num_qubits, False, func)
    dt = precision.real_dtype(None)
    num = 1 << num_qubits

    def alloc():
        if sharded_over(env, num):
            return DiagonalOp(num_qubits, shards=[
                torch.zeros((2, num // env.num_ranks), dtype=dt, device=d)
                for d in env.devices])
        return DiagonalOp(num_qubits, torch.zeros((2, num), dtype=dt, device=env.device))

    return V.validate_diag_op_allocation(alloc, func)


def destroyDiagonalOp(op: DiagonalOp, env=None) -> None:
    """Release a DiagonalOp's device buffers (QuEST.h:176)."""
    op.elems = None
    op.shards = None


def syncDiagonalOp(op: DiagonalOp) -> None:
    """No-op: the elements already live on the device (the reference copies
    host->GPU, QuEST_gpu_common.cu:508-640)."""


def _put_elems(op: DiagonalOp, fill) -> None:
    """Rebind the op's element tensors to new ones of its dtype and
    devices; ``fill(offset, size, device)`` gives each one's values."""
    pieces = op.pieces
    c = pieces[0].shape[1]
    new = [fill(r * c, c, p.device).to(p.dtype).reshape(2, c)
           for r, p in enumerate(pieces)]
    if op.shards is None:
        op.elems = new[0]
    else:
        op.shards = new


def initDiagonalOp(op: DiagonalOp, reals, imags) -> None:
    """Overwrite a DiagonalOp's elements from real/imag arrays (QuEST.h:178)."""
    func = "initDiagonalOp"
    V.validate_diag_op_init(op, func)
    reals = np.asarray(reals).reshape(-1)
    imags = np.asarray(imags).reshape(-1)
    V._assert(reals.size == (1 << op.num_qubits) and imags.size == (1 << op.num_qubits),
              "Invalid number of elements.", func)
    vals = np.stack([reals, imags])
    dt = op.pieces[0].dtype
    _put_elems(op, lambda off, c, dev: torch.tensor(vals[:, off:off + c], dtype=dt,
                                                    device=dev))


def setDiagonalOpElems(op: DiagonalOp, start_ind: int, reals, imags, num_elems: int) -> None:
    """Overwrite a slice of a DiagonalOp's elements, in place (QuEST.h:181);
    the slice may cross a shard boundary."""
    func = "setDiagonalOpElems"
    V.validate_diag_op_init(op, func)
    V.validate_num_elems(op, start_ind, num_elems, func)
    vals = np.stack([np.asarray(reals).reshape(-1)[:num_elems],
                     np.asarray(imags).reshape(-1)[:num_elems]])
    pieces = op.pieces
    c = pieces[0].shape[1]
    for r, p in enumerate(pieces):
        lo, hi = max(start_ind, r * c), min(start_ind + num_elems, (r + 1) * c)
        if lo < hi:
            p[:, lo - r * c:hi - r * c] = torch.tensor(
                vals[:, lo - start_ind:hi - start_ind], dtype=p.dtype, device=p.device)


def initDiagonalOpFromPauliHamil(op: DiagonalOp, hamil: PauliHamil) -> None:
    """Hamil of only I/Z terms -> diagonal elements (QuEST.h:1158), built on
    the op's devices (``ops.diagonal.pauli_z_diagonal``)."""
    func = "initDiagonalOpFromPauliHamil"
    V.validate_pauli_hamil(hamil, func)
    V.validate_diag_op_init(op, func)
    V.validate_hamil_matches_diag_op(hamil, op, func)
    V.validate_diag_pauli_hamil(hamil, func)

    def fill(off, c, dev):
        re = D.pauli_z_diagonal(hamil.pauli_codes, hamil.term_coeffs, offset=off,
                                size=c, device=dev)
        return torch.stack([re, torch.zeros_like(re)])

    _put_elems(op, fill)


def createDiagonalOpFromPauliHamilFile(path: str, env) -> DiagonalOp:
    """(QuEST.h:1201)."""
    from .datatypes import createPauliHamilFromFile
    hamil = createPauliHamilFromFile(path)
    op = createDiagonalOp(hamil.num_qubits, env)
    initDiagonalOpFromPauliHamil(op, hamil)
    return op


def _elems_for(qureg: Qureg, op: DiagonalOp) -> list:
    """The op's elements where the register needs them: cut as its state
    vector (re-cut by device-to-device copies where the two are cut
    differently), or whole on a density register's device."""
    from .state_init import _pieces, _recut

    src = op.pieces
    if qureg.is_density_matrix:
        return [torch.cat([p.to(qureg.device) for p in src], dim=1)]
    like = _pieces(qureg)
    if len(like) == len(src) and all(a.device == b.device for a, b in zip(like, src)):
        return src
    return _recut(src, like, src[0].dtype)


def applyDiagonalOp(qureg: Qureg, op: DiagonalOp) -> None:
    """|psi> -> D|psi>; rho -> D rho (QuEST.h:1282)."""
    func = "applyDiagonalOp"
    V.validate_diag_op_init(op, func)
    V.validate_diag_op_matches_qureg(qureg, op, func)
    elems = [e.to(qureg.dtype) for e in _elems_for(qureg, op)]
    if qureg.shards is not None and qureg.is_density_matrix:
        qureg.put_shards(D.apply_full_diagonal_to_density_shards(
            qureg.shards, elems[0], n=qureg.num_qubits_represented))
    elif qureg.shards is not None:
        qureg.put_shards([D.apply_full_diagonal(s, e) for s, e in zip(qureg.shards, elems)])
    elif qureg.is_density_matrix:
        qureg.put(D.apply_full_diagonal_to_density(
            qureg.amps, elems[0], n=qureg.num_qubits_represented))
    else:
        qureg.put(D.apply_full_diagonal(qureg.amps, elems[0]))
    _record(qureg, "applyDiagonalOp")


def calcExpecDiagonalOp(qureg: Qureg, op: DiagonalOp) -> complex:
    """(QuEST.h:1314)."""
    func = "calcExpecDiagonalOp"
    V.validate_diag_op_init(op, func)
    V.validate_diag_op_matches_qureg(qureg, op, func)
    elems = [e.to(qureg.dtype) for e in _elems_for(qureg, op)]
    if qureg.shards is not None and qureg.is_density_matrix:
        n = qureg.num_qubits_represented
        re, im = R.expec_diag_op_density(None, elems[0], n=n,
                                         diag=R.density_diagonal_shards(qureg.shards, n=n))
    elif qureg.shards is not None:
        re, im = R.expec_diag_op_shards(qureg.shards, elems)
    elif qureg.is_density_matrix:
        re, im = R.expec_diag_op_density(qureg.amps, elems[0],
                                         n=qureg.num_qubits_represented)
    else:
        re, im = R.expec_diag_op_statevec(qureg.amps, elems[0])
    return complex(float(re), float(im))


def _apply_sub_diag(qureg: Qureg, targets, op: SubDiagonalOp, func: str,
                    shadow: bool) -> None:
    """D on ``targets`` through ``ops.diagonal.apply_diagonal`` (never the
    gate primitives: a sub-diagonal entry stays a fusion barrier), and with
    ``shadow`` its conjugate on the column qubits of a density matrix."""
    from .parallel.scheduler import engine

    V.validate_multi_targets(qureg, targets, func)
    V._assert(op.num_qubits == len(targets),
              "The diagonal operator must act upon the same number of qubits as specified.",
              func)
    targets = tuple(int(t) for t in targets)
    nsv = qureg.num_qubits_in_state_vec
    d = cplx.from_complex(np.asarray(op.elems), qureg.dtype, qureg.device)
    if qureg.shards is not None:
        eng = engine(qureg)
        shards = eng.apply_diagonal(qureg.shards, d, n=nsv, targets=targets)
        if shadow and qureg.is_density_matrix:
            n = qureg.num_qubits_represented
            shards = eng.apply_diagonal(shards, d, n=nsv,
                                        targets=tuple(q + n for q in targets), conj=True)
        qureg.put_shards(shards)
        return
    amps = D.apply_diagonal(qureg.amps, d, n=nsv, targets=targets)
    if shadow and qureg.is_density_matrix:
        n = qureg.num_qubits_represented
        amps = D.apply_diagonal(amps, d, n=nsv, targets=tuple(q + n for q in targets),
                                conj=True)
    qureg.put(amps)


def applySubDiagonalOp(qureg: Qureg, targets, op: SubDiagonalOp) -> None:
    """D on a qubit subset, without unitarity checks and without the bra-side
    shadow (QuEST.h:1513)."""
    _apply_sub_diag(qureg, targets, op, "applySubDiagonalOp", shadow=False)
    _record(qureg, "applySubDiagonalOp")


def applyGateSubDiagonalOp(qureg: Qureg, targets, op: SubDiagonalOp) -> None:
    """D with the conjugated bra-side shadow on density matrices (QuEST.h:1473)."""
    _apply_sub_diag(qureg, targets, op, "applyGateSubDiagonalOp", shadow=True)
    _record(qureg, "applyGateSubDiagonalOp")
