"""Operators: general, possibly non-unitary matrices (reference
QuEST.h:5892-6147), the ``applyMatrix*`` part of ``quest_tpu/operators.py``.

``applyMatrix2``/``applyMatrix4``/``applyMatrixN``/
``applyMultiControlledMatrixN`` LEFT-multiply a density register (M rho,
no conj-shadow); the Gate variants apply M rho M^dagger. Neither asks for
unitarity. On a sharded state vector they run through the per-gate
engine over shards. Pauli sums, Trotter circuits, the QFT, phase
functions and diagonal operators wait for the operators slice.
"""

from __future__ import annotations

from . import validation as V
from .ops import apply as K, cplx
from .registers import Qureg

__all__ = [
    "applyMatrix2", "applyMatrix4", "applyMatrixN", "applyGateMatrixN",
    "applyMultiControlledMatrixN", "applyMultiControlledGateMatrixN",
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
    if qureg.shards is not None:  # a state vector: M|psi>
        _apply_sharded(qureg, m, targets, controls)
        return
    amps = K.apply_matrix(qureg.amps, m, n=nsv, targets=tuple(targets),
                          controls=tuple(controls))
    if qureg.is_density_matrix:
        amps = K.apply_matrix(amps, m, n=nsv,
                              targets=tuple(q + n for q in targets),
                              controls=tuple(c + n for c in controls), conj=True)
    qureg.put(amps)


def _apply_sharded(qureg: Qureg, m, targets, controls) -> None:
    """M|psi> on a sharded state vector, through the per-gate engine over
    shards (``parallel.scheduler``)."""
    from .parallel.scheduler import engine

    qureg.put_shards(engine(qureg).apply_matrix(
        qureg.shards, m, n=qureg.num_qubits_in_state_vec, targets=tuple(targets),
        controls=tuple(controls)))


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
