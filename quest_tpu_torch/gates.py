"""Unitaries, measurement and collapse: the reference's L5 gate API
(``QuEST/src/QuEST.c``; declarations QuEST.h:1916-4760), every function
of ``quest_tpu/gates.py`` under its name.

Every function follows the reference's structure (QuEST.c:5-6): validate,
apply the state-vector op, then on a density register the conjugated
shadow op on the shifted qubits q + n (QuEST.c:184-193), and record QASM.
The unitaries apply through four primitives
(``_apply_gate_matrix``/``_diag``/``_x``/``_parity_phase``) and
``ops.apply.apply_swap``: the points that ``fusion.capture`` patches to
record a gate instead of applying it. On a sharded register the
primitives (and ``swapGate``) route through the register's per-gate
engine over shards (``parallel.scheduler``), a density register's shadow
op too: its qubits q + n are the sharded zone, reached by pair exchanges
and relocations, and sharded controls are shard-index predicates.
Measurement draws from the env's host Mersenne Twister as the reference
does, sharded or not.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import matrices, validation as V
from .datatypes import SubDiagonalOp, Vector
from .ops import apply as K, cplx, diagonal as D, measure as M, reduce as R
from .parallel.scheduler import engine as _engine
from .registers import Qureg

__all__ = [
    "phaseShift", "controlledPhaseShift", "multiControlledPhaseShift",
    "controlledPhaseFlip", "multiControlledPhaseFlip", "sGate", "tGate",
    "compactUnitary", "unitary", "rotateX", "rotateY", "rotateZ",
    "rotateAroundAxis", "controlledRotateX", "controlledRotateY",
    "controlledRotateZ", "controlledRotateAroundAxis",
    "controlledCompactUnitary", "controlledUnitary", "multiControlledUnitary",
    "multiStateControlledUnitary", "pauliX", "pauliY", "pauliZ", "hadamard",
    "controlledNot", "multiQubitNot", "multiControlledMultiQubitNot",
    "controlledPauliY", "swapGate", "sqrtSwapGate", "multiRotateZ",
    "multiRotatePauli", "multiControlledMultiRotateZ",
    "multiControlledMultiRotatePauli", "twoQubitUnitary",
    "controlledTwoQubitUnitary", "multiControlledTwoQubitUnitary",
    "multiQubitUnitary", "controlledMultiQubitUnitary",
    "multiControlledMultiQubitUnitary", "diagonalUnitary",
    "measure", "measureWithStats", "collapseToOutcome",
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
    m = cplx.as_planar(matrix, 3, qureg.dtype, qureg.device)
    if qureg.shards is not None:
        eng = _engine(qureg)
        shards = eng.apply_matrix(qureg.shards, m, n=nsv, targets=targets,
                                  controls=controls, control_states=states)
        if qureg.is_density_matrix:
            shards = eng.apply_matrix(shards, m, n=nsv, targets=_shift(targets, n),
                                      controls=_shift(controls, n), control_states=states,
                                      conj=True)
        qureg.put_shards(shards)
        return
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
    d = (cplx.as_planar(diag, 2, qureg.dtype, qureg.device) if cplx.is_planar(diag, 2)
         else cplx.from_complex(np.asarray(diag).reshape(-1), qureg.dtype, qureg.device))
    if qureg.shards is not None:
        eng = _engine(qureg)
        shards = eng.apply_diagonal(qureg.shards, d, n=nsv, targets=targets,
                                    controls=controls)
        if qureg.is_density_matrix:
            shards = eng.apply_diagonal(shards, d, n=nsv, targets=_shift(targets, n),
                                        controls=_shift(controls, n), conj=True)
        qureg.put_shards(shards)
        return
    amps = D.apply_diagonal(qureg.amps, d, n=nsv, targets=targets,
                            controls=controls)
    if qureg.is_density_matrix:
        amps = D.apply_diagonal(amps, d, n=nsv, targets=_shift(targets, n),
                                controls=_shift(controls, n), conj=True)
    qureg.put(amps)


def _apply_gate_x(qureg: Qureg, targets, controls=(), states=()):
    n, nsv = qureg.num_qubits_represented, qureg.num_qubits_in_state_vec
    targets, controls, states = tuple(targets), tuple(controls), tuple(states)
    if qureg.shards is not None:
        eng = _engine(qureg)
        shards = eng.apply_x(qureg.shards, n=nsv, targets=targets, controls=controls,
                             control_states=states)
        if qureg.is_density_matrix:
            shards = eng.apply_x(shards, n=nsv, targets=_shift(targets, n),
                                 controls=_shift(controls, n), control_states=states)
        qureg.put_shards(shards)
        return
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
    if qureg.shards is not None:
        eng = _engine(qureg)
        shards = eng.apply_parity_phase(qureg.shards, theta, n=nsv, qubits=qubits,
                                        controls=controls)
        if qureg.is_density_matrix:
            shards = eng.apply_parity_phase(shards, theta, n=nsv, qubits=_shift(qubits, n),
                                            controls=_shift(controls, n), conj=True)
        qureg.put_shards(shards)
        return
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
# phase gates (diagonal family)
# ---------------------------------------------------------------------------

def phaseShift(qureg: Qureg, target: int, angle: float) -> None:
    """diag(1, e^{i angle}) on target (QuEST.h:1916)."""
    V.validate_target(qureg, target, "phaseShift")
    _apply_gate_diag(qureg, matrices.phase_shift_diag(angle), (target,))
    if _log(qureg): _log(qureg).record_param_gate("phaseShift", target, angle)


def controlledPhaseShift(qureg: Qureg, q1: int, q2: int, angle: float) -> None:
    """Symmetric two-qubit phase (QuEST.h:1965)."""
    V.validate_control_target(qureg, q1, q2, "controlledPhaseShift")
    _apply_gate_diag(qureg, matrices.phase_shift_diag(angle), (q2,), (q1,))
    if _log(qureg): _log(qureg).record_controlled_param_gate("phaseShift", q1, q2, angle)


def multiControlledPhaseShift(qureg: Qureg, qubits, angle: float) -> None:
    """Phase on the all-ones subspace of ``qubits`` (QuEST.h:2012)."""
    V.validate_multi_targets(qureg, qubits, "multiControlledPhaseShift")
    _apply_gate_diag(qureg, matrices.phase_shift_diag(angle), (qubits[0],), tuple(qubits[1:]))
    if _log(qureg):
        _log(qureg).record_multi_controlled_param_gate(
            "phaseShift", tuple(qubits[:-1]), qubits[-1], angle)


def controlledPhaseFlip(qureg: Qureg, q1: int, q2: int) -> None:
    """Controlled-Z: phase -1 on the |11> subspace (QuEST.h:211)."""
    V.validate_control_target(qureg, q1, q2, "controlledPhaseFlip")
    _apply_gate_diag(qureg, np.array([1.0, -1.0]), (q2,), (q1,))
    if _log(qureg): _log(qureg).record_controlled_gate("sigmaZ", q1, q2)


def multiControlledPhaseFlip(qureg: Qureg, qubits) -> None:
    """Phase -1 on the all-ones subspace of ``qubits`` (QuEST.h:212)."""
    V.validate_multi_targets(qureg, qubits, "multiControlledPhaseFlip")
    _apply_gate_diag(qureg, np.array([1.0, -1.0]), (qubits[0],), tuple(qubits[1:]))
    if _log(qureg):
        _log(qureg).record_multi_controlled_gate("sigmaZ", tuple(qubits[:-1]), qubits[-1])


def sGate(qureg: Qureg, target: int) -> None:
    """Phase gate diag(1, i) (QuEST.h:213)."""
    V.validate_target(qureg, target, "sGate")
    _apply_gate_diag(qureg, np.array([1.0, 1.0j]), (target,))
    if _log(qureg): _log(qureg).record_gate("sGate", target)


def tGate(qureg: Qureg, target: int) -> None:
    """T gate diag(1, exp(i pi/4)) (QuEST.h:214)."""
    V.validate_target(qureg, target, "tGate")
    _apply_gate_diag(qureg, np.array([1.0, np.exp(0.25j * math.pi)]), (target,))
    if _log(qureg): _log(qureg).record_gate("tGate", target)


def pauliZ(qureg: Qureg, target: int) -> None:
    """sigma-Z (QuEST.h:231)."""
    V.validate_target(qureg, target, "pauliZ")
    _apply_gate_diag(qureg, np.array([1.0, -1.0]), (target,))
    if _log(qureg): _log(qureg).record_gate("sigmaZ", target)


def rotateZ(qureg: Qureg, target: int, angle: float) -> None:
    """exp(-i angle/2 Z) (QuEST.h:219)."""
    V.validate_target(qureg, target, "rotateZ")
    _apply_gate_diag(qureg, matrices.rz_diag(angle), (target,))
    if _log(qureg): _log(qureg).record_param_gate("rotateZ", target, angle)


def controlledRotateZ(qureg: Qureg, control: int, target: int, angle: float) -> None:
    """Controlled exp(-i angle/2 Z) (QuEST.h:223)."""
    V.validate_control_target(qureg, control, target, "controlledRotateZ")
    _apply_gate_diag(qureg, matrices.rz_diag(angle), (target,), (control,))
    if _log(qureg): _log(qureg).record_controlled_param_gate("rotateZ", control, target, angle)


def multiRotateZ(qureg: Qureg, qubits, angle: float) -> None:
    """exp(-i angle/2 Z x...x Z) (QuEST.h:4483)."""
    V.validate_multi_targets(qureg, qubits, "multiRotateZ")
    _apply_gate_parity_phase(qureg, angle, tuple(qubits))
    if _log(qureg):
        _log(qureg).record_comment(
            f"Here a {len(qubits)}-qubit multiRotateZ of angle "
            f"{_log(qureg).fmt_real(angle)} was performed (QASM not yet implemented)")


def multiControlledMultiRotateZ(qureg: Qureg, controls, targets, angle: float) -> None:
    """(QuEST.h:4616)."""
    V.validate_multi_controls_multi_targets(qureg, controls, targets, "multiControlledMultiRotateZ")
    _apply_gate_parity_phase(qureg, angle, tuple(targets), tuple(controls))
    if _log(qureg):
        _log(qureg).record_comment(
            f"Here a {len(controls)}-control {len(targets)}-target "
            f"multiControlledMultiRotateZ of angle {_log(qureg).fmt_real(angle)} "
            "was performed (QASM not yet implemented)")


def diagonalUnitary(qureg: Qureg, targets, op: SubDiagonalOp) -> None:
    """Apply a SubDiagonalOp as a unitary (diagonalUnitary, QuEST.h:1444)."""
    func = "diagonalUnitary"
    V.validate_multi_targets(qureg, targets, func)
    V.validate_sub_diag_op_targets(op, len(targets), func)
    V.validate_unitary_sub_diag_op(op, qureg.eps, func)
    _apply_gate_diag(qureg, np.asarray(op.elems), tuple(targets))
    if _log(qureg):
        _log(qureg).record_comment(
            "Here, the register was modified by an undisclosed diagonal unitary (via diagonalUnitary).")


# ---------------------------------------------------------------------------
# X-class (amplitude permutation) gates
# ---------------------------------------------------------------------------

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


def multiQubitNot(qureg: Qureg, targets) -> None:
    """(QuEST.h:3464)."""
    V.validate_multi_targets(qureg, targets, "multiQubitNot")
    _apply_gate_x(qureg, tuple(targets))
    if _log(qureg):
        _log(qureg).record_multi_controlled_multi_qubit_not((), tuple(targets))


def multiControlledMultiQubitNot(qureg: Qureg, controls, targets) -> None:
    """(QuEST.h:3403)."""
    V.validate_multi_controls_multi_targets(qureg, controls, targets,
                                            "multiControlledMultiQubitNot")
    _apply_gate_x(qureg, tuple(targets), tuple(controls))
    if _log(qureg):
        _log(qureg).record_multi_controlled_multi_qubit_not(tuple(controls), tuple(targets))


# ---------------------------------------------------------------------------
# dense 1-qubit gates
# ---------------------------------------------------------------------------

def hadamard(qureg: Qureg, target: int) -> None:
    """Hadamard gate (QuEST.h:232)."""
    V.validate_target(qureg, target, "hadamard")
    _apply_gate_matrix(qureg, matrices.HADAMARD, (target,))
    if _log(qureg): _log(qureg).record_gate("hadamard", target)


def pauliY(qureg: Qureg, target: int) -> None:
    """sigma-Y (QuEST.h:230)."""
    V.validate_target(qureg, target, "pauliY")
    _apply_gate_matrix(qureg, matrices.PAULI_Y_M, (target,))
    if _log(qureg): _log(qureg).record_gate("sigmaY", target)


def controlledPauliY(qureg: Qureg, control: int, target: int) -> None:
    """Controlled sigma-Y (QuEST.h:236)."""
    V.validate_control_target(qureg, control, target, "controlledPauliY")
    _apply_gate_matrix(qureg, matrices.PAULI_Y_M, (target,), (control,))
    if _log(qureg): _log(qureg).record_controlled_gate("sigmaY", control, target)


def compactUnitary(qureg: Qureg, target: int, alpha: complex, beta: complex) -> None:
    """[[alpha, -conj(beta)], [beta, conj(alpha)]] (QuEST.h:2562)."""
    func = "compactUnitary"
    V.validate_target(qureg, target, func)
    V.validate_unitary_complex_pair(alpha, beta, qureg.eps, func)
    _apply_gate_matrix(qureg, matrices.compact_unitary_matrix(alpha, beta), (target,))
    if _log(qureg): _log(qureg).record_compact_unitary(alpha, beta, target)


def controlledCompactUnitary(qureg: Qureg, control: int, target: int,
                             alpha: complex, beta: complex) -> None:
    """Controlled [[alpha, -conj(beta)], [beta, conj(alpha)]] (QuEST.h:225)."""
    func = "controlledCompactUnitary"
    V.validate_control_target(qureg, control, target, func)
    V.validate_unitary_complex_pair(alpha, beta, qureg.eps, func)
    _apply_gate_matrix(qureg, matrices.compact_unitary_matrix(alpha, beta),
                       (target,), (control,))
    if _log(qureg): _log(qureg).record_controlled_compact_unitary(alpha, beta, control, target)


def unitary(qureg: Qureg, target: int, u) -> None:
    """General single-qubit unitary, unitarity-validated (QuEST.h:216)."""
    func = "unitary"
    V.validate_target(qureg, target, func)
    V.validate_unitary_matrix(u, 1, qureg.eps, func)
    _apply_gate_matrix(qureg, u, (target,))
    if _log(qureg): _log(qureg).record_unitary(np.asarray(u), target)


def controlledUnitary(qureg: Qureg, control: int, target: int, u) -> None:
    """Controlled general single-qubit unitary (QuEST.h:226)."""
    func = "controlledUnitary"
    V.validate_control_target(qureg, control, target, func)
    V.validate_unitary_matrix(u, 1, qureg.eps, func)
    _apply_gate_matrix(qureg, u, (target,), (control,))
    if _log(qureg): _log(qureg).record_controlled_unitary(np.asarray(u), control, target)


def multiControlledUnitary(qureg: Qureg, controls, target: int, u) -> None:
    """Multi-control general single-qubit unitary (QuEST.h:227)."""
    func = "multiControlledUnitary"
    V.validate_multi_controls_multi_targets(qureg, controls, (target,), func)
    V.validate_unitary_matrix(u, 1, qureg.eps, func)
    _apply_gate_matrix(qureg, u, (target,), tuple(controls))
    if _log(qureg): _log(qureg).record_multi_controlled_unitary(np.asarray(u), tuple(controls), target)


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


# ---------------------------------------------------------------------------
# rotations
# ---------------------------------------------------------------------------

def rotateX(qureg: Qureg, target: int, angle: float) -> None:
    """exp(-i angle/2 X) (QuEST.h:217)."""
    V.validate_target(qureg, target, "rotateX")
    _apply_gate_matrix(qureg, matrices.rx_matrix(angle), (target,))
    if _log(qureg): _log(qureg).record_param_gate("rotateX", target, angle)


def rotateY(qureg: Qureg, target: int, angle: float) -> None:
    """exp(-i angle/2 Y) (QuEST.h:218)."""
    V.validate_target(qureg, target, "rotateY")
    _apply_gate_matrix(qureg, matrices.ry_matrix(angle), (target,))
    if _log(qureg): _log(qureg).record_param_gate("rotateY", target, angle)


def rotateAroundAxis(qureg: Qureg, target: int, angle: float, axis: Vector) -> None:
    """exp(-i angle/2 n.sigma) about a Bloch-sphere axis (QuEST.h:220)."""
    func = "rotateAroundAxis"
    V.validate_target(qureg, target, func)
    V.validate_vector(axis, func)
    _apply_gate_matrix(qureg, matrices.rotation_matrix(angle, axis), (target,))
    if _log(qureg): _log(qureg).record_axis_rotation(angle, axis, target)


def controlledRotateX(qureg: Qureg, control: int, target: int, angle: float) -> None:
    """Controlled exp(-i angle/2 X) (QuEST.h:221)."""
    V.validate_control_target(qureg, control, target, "controlledRotateX")
    _apply_gate_matrix(qureg, matrices.rx_matrix(angle), (target,), (control,))
    if _log(qureg): _log(qureg).record_controlled_param_gate("rotateX", control, target, angle)


def controlledRotateY(qureg: Qureg, control: int, target: int, angle: float) -> None:
    """Controlled exp(-i angle/2 Y) (QuEST.h:222)."""
    V.validate_control_target(qureg, control, target, "controlledRotateY")
    _apply_gate_matrix(qureg, matrices.ry_matrix(angle), (target,), (control,))
    if _log(qureg): _log(qureg).record_controlled_param_gate("rotateY", control, target, angle)


def controlledRotateAroundAxis(qureg: Qureg, control: int, target: int,
                               angle: float, axis: Vector) -> None:
    """Controlled rotation about an arbitrary Bloch axis (QuEST.h:224)."""
    func = "controlledRotateAroundAxis"
    V.validate_control_target(qureg, control, target, func)
    V.validate_vector(axis, func)
    _apply_gate_matrix(qureg, matrices.rotation_matrix(angle, axis), (target,), (control,))
    if _log(qureg): _log(qureg).record_controlled_axis_rotation(angle, axis, control, target)


def multiRotatePauli(qureg: Qureg, targets, paulis, angle: float) -> None:
    """exp(-i angle/2 P1 x P2 x ...) via basis rotation to Z then multiRotateZ
    (statevec_multiRotatePauli, QuEST_common.c:410-488)."""
    _multi_rotate_pauli(qureg, (), targets, paulis, angle, "multiRotatePauli")


def multiControlledMultiRotatePauli(qureg: Qureg, controls, targets, paulis,
                                    angle: float) -> None:
    """(QuEST.h:4726)."""
    _multi_rotate_pauli(qureg, tuple(controls), targets, paulis, angle,
                        "multiControlledMultiRotatePauli")


def _multi_rotate_pauli(qureg, controls, targets, paulis, angle, func):
    V.validate_multi_controls_multi_targets(qureg, controls, targets, func)
    V.validate_num_pauli_codes(paulis, len(targets), func)
    codes = [int(p) for p in paulis]
    # identity Paulis drop out of the Z-product (reference behaviour)
    active = [(t, c) for t, c in zip(targets, codes) if c != 0]
    if not active:
        # a global phase exp(-i angle/2) on the controlled subspace
        if matrices.is_traced(angle):
            # a runtime angle: the phase is assembled on its device
            c, s = torch.cos(angle / 2), -torch.sin(angle / 2)
            if controls:
                diag = matrices.planar(torch.stack([torch.ones_like(c), c]),
                                       torch.stack([torch.zeros_like(s), s]))
                _apply_gate_diag(qureg, diag, (controls[0],), tuple(controls[1:]))
            else:
                diag = matrices.planar(torch.stack([c, c]), torch.stack([s, s]))
                _apply_gate_diag(qureg, diag, (targets[0],))
            return
        if controls:
            _apply_gate_diag(qureg, np.array([1.0, np.exp(-0.5j * angle)]),
                             (controls[0],), tuple(controls[1:]))
        else:
            _apply_gate_diag(qureg, np.full(2, np.exp(-0.5j * angle)), (targets[0],))
        return
    for t, c in active:
        if c in matrices.BASIS_TO_Z:
            _apply_gate_matrix(qureg, matrices.BASIS_TO_Z[c], (t,))
    _apply_gate_parity_phase(qureg, angle, tuple(t for t, _ in active), tuple(controls))
    for t, c in active:
        if c in matrices.BASIS_TO_Z:
            _apply_gate_matrix(qureg, np.conj(matrices.BASIS_TO_Z[c]).T, (t,))
    if _log(qureg):
        if controls:
            _log(qureg).record_comment(
                f"Here a {len(controls)}-control {len(targets)}-target "
                f"multiControlledMultiRotatePauli of angle {_log(qureg).fmt_real(angle)} "
                "was performed (QASM not yet implemented)")
        else:
            _log(qureg).record_comment(
                f"Here a {len(targets)}-qubit multiRotatePauli of angle "
                f"{_log(qureg).fmt_real(angle)} was performed (QASM not yet implemented)")


# ---------------------------------------------------------------------------
# swaps and multi-qubit unitaries
# ---------------------------------------------------------------------------

def swapGate(qureg: Qureg, qb1: int, qb2: int) -> None:
    """(QuEST.h:4331); axis transposition, see ops.apply.apply_swap."""
    V.validate_unique_targets(qureg, qb1, qb2, "swapGate")
    n, nsv = qureg.num_qubits_represented, qureg.num_qubits_in_state_vec
    if qureg.shards is not None:
        eng = _engine(qureg)
        shards = eng.apply_swap(qureg.shards, n=nsv, qb1=qb1, qb2=qb2)
        if qureg.is_density_matrix:
            shards = eng.apply_swap(shards, n=nsv, qb1=qb1 + n, qb2=qb2 + n)
        qureg.put_shards(shards)
    else:
        amps = K.apply_swap(qureg.amps, n=nsv, qb1=qb1, qb2=qb2)
        if qureg.is_density_matrix:
            amps = K.apply_swap(amps, n=nsv, qb1=qb1 + n, qb2=qb2 + n)
        qureg.put(amps)
    if _log(qureg): _log(qureg).record_controlled_gate("swap", qb1, qb2)


def sqrtSwapGate(qureg: Qureg, qb1: int, qb2: int) -> None:
    """Square root of SWAP (QuEST.h:238)."""
    V.validate_unique_targets(qureg, qb1, qb2, "sqrtSwapGate")
    _apply_gate_matrix(qureg, matrices.SQRT_SWAP, (qb1, qb2))
    if _log(qureg): _log(qureg).record_controlled_gate("sqrtSwap", qb1, qb2)


def twoQubitUnitary(qureg: Qureg, t1: int, t2: int, u) -> None:
    """(QuEST.h:4945). Matrix rows ordered with t1 as the least-significant bit."""
    func = "twoQubitUnitary"
    V.validate_multi_targets(qureg, (t1, t2), func)
    V.validate_unitary_matrix(u, 2, qureg.eps, func)
    _apply_gate_matrix(qureg, u, (t1, t2))
    if _log(qureg):
        _log(qureg).record_comment("Here, an undisclosed 2-qubit unitary was applied.")


def controlledTwoQubitUnitary(qureg: Qureg, control: int, t1: int, t2: int, u) -> None:
    """Single-control dense two-target unitary (QuEST.h:244)."""
    func = "controlledTwoQubitUnitary"
    V.validate_multi_controls_multi_targets(qureg, (control,), (t1, t2), func)
    V.validate_unitary_matrix(u, 2, qureg.eps, func)
    _apply_gate_matrix(qureg, u, (t1, t2), (control,))
    if _log(qureg):
        _log(qureg).record_comment("Here, an undisclosed controlled 2-qubit unitary was applied.")


def multiControlledTwoQubitUnitary(qureg: Qureg, controls, t1: int, t2: int, u) -> None:
    """Multi-control dense two-target unitary (QuEST.h:245)."""
    func = "multiControlledTwoQubitUnitary"
    V.validate_multi_controls_multi_targets(qureg, controls, (t1, t2), func)
    V.validate_unitary_matrix(u, 2, qureg.eps, func)
    _apply_gate_matrix(qureg, u, (t1, t2), tuple(controls))
    if _log(qureg):
        _log(qureg).record_comment("Here, an undisclosed multi-controlled 2-qubit unitary was applied.")


def multiQubitUnitary(qureg: Qureg, targets, u) -> None:
    """General dense unitary (QuEST.h:5193)."""
    func = "multiQubitUnitary"
    V.validate_multi_targets(qureg, targets, func)
    V.validate_matrix_init(u, func)
    V.validate_unitary_matrix(u, len(targets), qureg.eps, func)
    _apply_gate_matrix(qureg, u, tuple(targets))
    if _log(qureg):
        _log(qureg).record_comment("Here, an undisclosed multi-qubit unitary was applied.")


def controlledMultiQubitUnitary(qureg: Qureg, control: int, targets, u) -> None:
    """Single-control dense multi-target unitary (QuEST.h:247)."""
    func = "controlledMultiQubitUnitary"
    V.validate_multi_controls_multi_targets(qureg, (control,), targets, func)
    V.validate_matrix_init(u, func)
    V.validate_unitary_matrix(u, len(targets), qureg.eps, func)
    _apply_gate_matrix(qureg, u, tuple(targets), (control,))
    if _log(qureg):
        _log(qureg).record_comment("Here, an undisclosed controlled multi-qubit unitary was applied.")


def multiControlledMultiQubitUnitary(qureg: Qureg, controls, targets, u) -> None:
    """(QuEST.h:5366; reference dispatch QuEST_cpu_distributed.c:1526-1568)."""
    func = "multiControlledMultiQubitUnitary"
    V.validate_multi_controls_multi_targets(qureg, controls, targets, func)
    V.validate_matrix_init(u, func)
    V.validate_unitary_matrix(u, len(targets), qureg.eps, func)
    _apply_gate_matrix(qureg, u, tuple(targets), tuple(controls))
    if _log(qureg):
        _log(qureg).record_comment("Here, an undisclosed multi-controlled multi-qubit unitary was applied.")


# ---------------------------------------------------------------------------
# measurement (QuEST.h:3544-3719; logic QuEST_common.c:360-366)
# ---------------------------------------------------------------------------

def _prob_of_outcome(qureg: Qureg, target: int, outcome: int) -> float:
    if qureg.shards is not None and qureg.is_density_matrix:
        n = qureg.num_qubits_represented
        return float(M.density_prob_of_outcome(
            None, n=n, target=target, outcome=outcome,
            diag=R.density_diagonal_shards(qureg.shards, n=n)[0]))
    if qureg.shards is not None:
        return float(R.prob_of_outcome_shards(qureg.shards, n=qureg.num_qubits_in_state_vec,
                                              target=target, outcome=outcome))
    if qureg.is_density_matrix:
        p = M.density_prob_of_outcome(qureg.amps, n=qureg.num_qubits_represented,
                                      target=target, outcome=outcome)
    else:
        p = R.prob_of_outcome(qureg.amps, n=qureg.num_qubits_in_state_vec,
                              target=target, outcome=outcome)
    return float(p)


def _collapse(qureg: Qureg, target: int, outcome: int, prob: float) -> None:
    if qureg.shards is not None and qureg.is_density_matrix:
        qureg.put_shards(M.density_collapse_shards(
            qureg.shards, prob, n=qureg.num_qubits_represented, target=target,
            outcome=outcome))
        return
    if qureg.shards is not None:
        qureg.put_shards(M.collapse_shards(qureg.shards, prob,
                                           n=qureg.num_qubits_in_state_vec,
                                           target=target, outcome=outcome))
        return
    if qureg.is_density_matrix:
        amps = M.density_collapse(qureg.amps, prob, n=qureg.num_qubits_represented,
                                  target=target, outcome=outcome)
    else:
        amps = M.collapse_statevec(qureg.amps, prob, n=qureg.num_qubits_in_state_vec,
                                   target=target, outcome=outcome)
    qureg.put(amps)


def collapseToOutcome(qureg: Qureg, target: int, outcome: int) -> float:
    """Force a measurement outcome; returns its probability (QuEST.h:3668)."""
    func = "collapseToOutcome"
    V.validate_target(qureg, target, func)
    V.validate_outcome(outcome, func)
    prob = _prob_of_outcome(qureg, target, outcome)
    V.validate_measurement_prob(prob, qureg.eps, func)
    _collapse(qureg, target, outcome, prob)
    if qureg.qasm_log is not None:
        qureg.qasm_log.record_comment(
            f"Here, qubit {target} was un-physically projected into outcome {outcome}")
    return prob


def measureWithStats(qureg: Qureg, target: int):
    """Random measurement; returns (outcome, its probability) (QuEST.h:3719).

    The draw comes from the env's host Mersenne Twister, so outcomes are
    reproducible under seedQuEST (generateMeasurementOutcome,
    QuEST_common.c:168-183): the cutoffs are REAL_EPS-scaled, and the RNG
    is consumed only when the outcome is genuinely random, which keeps the
    stream aligned with the reference's across deterministic measurements.
    """
    V.validate_target(qureg, target, "measureWithStats")
    zero_prob = _prob_of_outcome(qureg, target, 0)
    eps = qureg.eps
    if zero_prob < eps:
        outcome = 1
    elif 1 - zero_prob < eps:
        outcome = 0
    else:
        draw = (qureg.env.rng.random_sample() if qureg.env.rng is not None
                else np.random.random())
        outcome = int(draw > zero_prob)
    prob = zero_prob if outcome == 0 else 1 - zero_prob
    _collapse(qureg, target, outcome, prob)
    if qureg.qasm_log is not None:
        qureg.qasm_log.record_measurement(target)
    return outcome, prob


def measure(qureg: Qureg, target: int) -> int:
    """(QuEST.h:3693)."""
    V.validate_target(qureg, target, "measure")
    outcome, _ = measureWithStats(qureg, target)
    return outcome
