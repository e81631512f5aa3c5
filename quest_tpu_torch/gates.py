"""Unitaries of the ported slice: the reference's L5 gate API
(``QuEST/src/QuEST.c``; declarations QuEST.h:1916-4760).

Every function follows the reference's structure (QuEST.c:5-6): validate,
apply the state-vector op, then on a density register the conjugated
shadow op on the shifted qubits q + n (QuEST.c:184-193), and record QASM.
They apply through four primitives
(``_apply_gate_matrix``/``_diag``/``_x``/``_parity_phase``) and
``ops.apply.apply_swap``: the points that ``fusion.capture`` patches to
record a gate instead of applying it.
"""

from __future__ import annotations

import math

import numpy as np

from . import matrices, validation as V
from .ops import apply as K, cplx, diagonal as D
from .registers import Qureg

__all__ = [
    "hadamard", "tGate", "rotateZ", "rotateX", "controlledNot",
    "controlledPhaseFlip", "unitary", "multiRotateZ", "swapGate",
    "multiStateControlledUnitary", "pauliX",
]


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def _shift(qs, n):
    return tuple(q + n for q in qs)


def _apply_gate_matrix(qureg: Qureg, matrix, targets, controls=(), states=()):
    """U on a state-vector; U . U^dagger on a density matrix via the
    conj-shadow (QuEST.c:184-193)."""
    n, nsv = qureg.num_qubits_represented, qureg.num_qubits_in_state_vec
    targets, controls, states = tuple(targets), tuple(controls), tuple(states)
    m = cplx.from_complex(matrix, qureg.dtype, qureg.device)
    amps = K.apply_matrix(qureg.amps, m, n=nsv, targets=targets,
                          controls=controls, control_states=states)
    if qureg.is_density_matrix:
        amps = K.apply_matrix(amps, m, n=nsv, targets=_shift(targets, n),
                              controls=_shift(controls, n),
                              control_states=states, conj=True)
    qureg.put(amps)


def _apply_gate_diag(qureg: Qureg, diag, targets, controls=()):
    n, nsv = qureg.num_qubits_represented, qureg.num_qubits_in_state_vec
    targets, controls = tuple(targets), tuple(controls)
    d = cplx.from_complex(np.asarray(diag).reshape(-1), qureg.dtype, qureg.device)
    amps = D.apply_diagonal(qureg.amps, d, n=nsv, targets=targets,
                            controls=controls)
    if qureg.is_density_matrix:
        amps = D.apply_diagonal(amps, d, n=nsv, targets=_shift(targets, n),
                                controls=_shift(controls, n), conj=True)
    qureg.put(amps)


def _apply_gate_x(qureg: Qureg, targets, controls=(), states=()):
    n, nsv = qureg.num_qubits_represented, qureg.num_qubits_in_state_vec
    targets, controls, states = tuple(targets), tuple(controls), tuple(states)
    amps = K.apply_x_class(qureg.amps, n=nsv, targets=targets,
                           controls=controls, control_states=states)
    if qureg.is_density_matrix:
        amps = K.apply_x_class(amps, n=nsv, targets=_shift(targets, n),
                               controls=_shift(controls, n),
                               control_states=states)
    qureg.put(amps)


def _apply_gate_parity_phase(qureg: Qureg, theta, qubits, controls=()):
    n, nsv = qureg.num_qubits_represented, qureg.num_qubits_in_state_vec
    qubits, controls = tuple(qubits), tuple(controls)
    amps = D.apply_parity_phase(qureg.amps, theta, n=nsv, qubits=qubits,
                                controls=controls)
    if qureg.is_density_matrix:
        amps = D.apply_parity_phase(amps, theta, n=nsv, qubits=_shift(qubits, n),
                                    controls=_shift(controls, n), conj=True)
    qureg.put(amps)


def _log(qureg):
    """The register's QASM logger, or None (spy registers carry none)."""
    return qureg.qasm_log


# ---------------------------------------------------------------------------
# the gates
# ---------------------------------------------------------------------------

def controlledPhaseFlip(qureg: Qureg, q1: int, q2: int) -> None:
    """Controlled-Z: phase -1 on the |11> subspace (QuEST.h:211)."""
    V.validate_control_target(qureg, q1, q2, "controlledPhaseFlip")
    _apply_gate_diag(qureg, np.array([1.0, -1.0]), (q2,), (q1,))
    if _log(qureg): _log(qureg).record_controlled_gate("sigmaZ", q1, q2)


def tGate(qureg: Qureg, target: int) -> None:
    """T gate diag(1, exp(i pi/4)) (QuEST.h:214)."""
    V.validate_target(qureg, target, "tGate")
    _apply_gate_diag(qureg, np.array([1.0, np.exp(0.25j * math.pi)]), (target,))
    if _log(qureg): _log(qureg).record_gate("tGate", target)


def rotateZ(qureg: Qureg, target: int, angle: float) -> None:
    """exp(-i angle/2 Z) (QuEST.h:219)."""
    V.validate_target(qureg, target, "rotateZ")
    _apply_gate_diag(qureg, matrices.rz_diag(angle), (target,))
    if _log(qureg): _log(qureg).record_param_gate("rotateZ", target, angle)


def multiRotateZ(qureg: Qureg, qubits, angle: float) -> None:
    """exp(-i angle/2 Z x...x Z) (QuEST.h:4483)."""
    V.validate_multi_targets(qureg, qubits, "multiRotateZ")
    _apply_gate_parity_phase(qureg, angle, tuple(qubits))
    if _log(qureg):
        _log(qureg).record_comment(
            f"Here a {len(qubits)}-qubit multiRotateZ of angle "
            f"{_log(qureg).fmt_real(angle)} was performed (QASM not yet implemented)")


def pauliX(qureg: Qureg, target: int) -> None:
    """sigma-X (QuEST.h:229)."""
    V.validate_target(qureg, target, "pauliX")
    _apply_gate_x(qureg, (target,))
    if _log(qureg): _log(qureg).record_gate("sigmaX", target)


def controlledNot(qureg: Qureg, control: int, target: int) -> None:
    """CNOT (QuEST.h:233)."""
    V.validate_control_target(qureg, control, target, "controlledNot")
    _apply_gate_x(qureg, (target,), (control,))
    if _log(qureg): _log(qureg).record_controlled_gate("sigmaX", control, target)


def hadamard(qureg: Qureg, target: int) -> None:
    """Hadamard gate (QuEST.h:232)."""
    V.validate_target(qureg, target, "hadamard")
    _apply_gate_matrix(qureg, matrices.HADAMARD, (target,))
    if _log(qureg): _log(qureg).record_gate("hadamard", target)


def unitary(qureg: Qureg, target: int, u) -> None:
    """General single-qubit unitary, unitarity-validated (QuEST.h:216)."""
    func = "unitary"
    V.validate_target(qureg, target, func)
    V.validate_unitary_matrix(u, 1, qureg.eps, func)
    _apply_gate_matrix(qureg, u, (target,))
    if _log(qureg): _log(qureg).record_unitary(np.asarray(u), target)


def multiStateControlledUnitary(qureg: Qureg, controls, states, target: int, u) -> None:
    """Controls conditioned on given bit values (QuEST.h:4448)."""
    func = "multiStateControlledUnitary"
    V.validate_multi_controls_multi_targets(qureg, controls, (target,), func)
    V.validate_control_state(states, len(controls), func)
    V.validate_unitary_matrix(u, 1, qureg.eps, func)
    _apply_gate_matrix(qureg, u, (target,), tuple(controls), tuple(int(s) for s in states))
    if _log(qureg):
        _log(qureg).record_multi_state_controlled_unitary(
            np.asarray(u), tuple(controls), tuple(int(s) for s in states), target)


def rotateX(qureg: Qureg, target: int, angle: float) -> None:
    """exp(-i angle/2 X) (QuEST.h:217)."""
    V.validate_target(qureg, target, "rotateX")
    _apply_gate_matrix(qureg, matrices.rx_matrix(angle), (target,))
    if _log(qureg): _log(qureg).record_param_gate("rotateX", target, angle)


def swapGate(qureg: Qureg, qb1: int, qb2: int) -> None:
    """(QuEST.h:4331); axis transposition, see ops.apply.apply_swap."""
    V.validate_unique_targets(qureg, qb1, qb2, "swapGate")
    n, nsv = qureg.num_qubits_represented, qureg.num_qubits_in_state_vec
    amps = K.apply_swap(qureg.amps, n=nsv, qb1=qb1, qb2=qb2)
    if qureg.is_density_matrix:
        amps = K.apply_swap(amps, n=nsv, qb1=qb1 + n, qb2=qb2 + n)
    qureg.put(amps)
    if _log(qureg): _log(qureg).record_controlled_gate("swap", qb1, qb2)
