"""State initialisation API (reference QuEST.h:1619-1876, QuEST.c init
family): the initialisers of the ported slices, for state-vector and
density registers."""

from __future__ import annotations

from . import validation as V
from .ops import init as I
from .registers import Qureg

__all__ = ["initBlankState", "initZeroState", "initPlusState",
           "initClassicalState", "initPureState", "initDebugState"]


def initBlankState(qureg: Qureg) -> None:
    """All-zero amplitudes (unnormalised) (QuEST.h:1619)."""
    qureg.put(I.init_blank(qureg.num_amps_total, qureg.dtype, qureg.device))
    if qureg.qasm_log:
        qureg.qasm_log.record_comment(
            "Here, the register was initialised to an unphysical all-zero-amplitudes 'state'.")


def initZeroState(qureg: Qureg) -> None:
    """Set the register to |0...0> (QuEST.h:194)."""
    if qureg.is_density_matrix:
        amps = I.density_init_classical(qureg.num_amps_total, qureg.dtype,
                                        qureg.device, 0)
    else:
        amps = I.init_classical(qureg.num_amps_total, qureg.dtype, qureg.device, 0)
    qureg.put(amps)
    if qureg.qasm_log:
        qureg.qasm_log.record_init_zero()


def initPlusState(qureg: Qureg) -> None:
    """Set the register to |+>^n, every amplitude equal (QuEST.h:195)."""
    if qureg.is_density_matrix:
        amps = I.density_init_plus(qureg.num_amps_total, qureg.dtype, qureg.device)
    else:
        amps = I.init_plus(qureg.num_amps_total, qureg.dtype, qureg.device)
    qureg.put(amps)
    if qureg.qasm_log:
        qureg.qasm_log.record_init_plus()


def initClassicalState(qureg: Qureg, state_index: int) -> None:
    """Set the register to computational basis state |stateInd> (QuEST.h:196)."""
    V.validate_state_index(qureg, state_index, "initClassicalState")
    if qureg.is_density_matrix:
        amps = I.density_init_classical(qureg.num_amps_total, qureg.dtype,
                                        qureg.device, state_index)
    else:
        amps = I.init_classical(qureg.num_amps_total, qureg.dtype, qureg.device,
                                state_index)
    qureg.put(amps)
    if qureg.qasm_log:
        qureg.qasm_log.record_init_classical(state_index)


def initPureState(qureg: Qureg, pure: Qureg) -> None:
    """Copy a pure state in; density targets get rho = |psi><psi|
    (QuEST.h:1689; densmatr_initPureState)."""
    func = "initPureState"
    V.validate_second_qureg_state_vec(pure, func)
    V.validate_matching_qureg_dims(qureg, pure, func)
    if qureg.is_density_matrix:
        amps = I.density_from_pure(pure.amps.to(qureg.dtype))
    else:
        amps = pure.amps.to(qureg.dtype, copy=True)
    qureg.put(amps)
    if qureg.qasm_log:
        qureg.qasm_log.record_comment(
            "Here, the register was initialised to an undisclosed given pure state.")


def initDebugState(qureg: Qureg) -> None:
    """amp_i = (2i + (2i+1) i)/10: the deterministic test fixture (QuEST.h:1721)."""
    qureg.put(I.init_debug(qureg.num_amps_total, qureg.dtype, qureg.device))
    if qureg.qasm_log:
        qureg.qasm_log.record_comment("initDebugState")
