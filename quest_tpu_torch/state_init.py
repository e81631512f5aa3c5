"""State initialisation API (reference QuEST.h:1619-1876, QuEST.c init
family): the initialisers of the ported slice, state-vector registers."""

from __future__ import annotations

from . import validation as V
from .ops import init as I
from .registers import Qureg

__all__ = ["initBlankState", "initZeroState", "initPlusState",
           "initClassicalState", "initDebugState"]


def initBlankState(qureg: Qureg) -> None:
    """All-zero amplitudes (unnormalised) (QuEST.h:1619)."""
    qureg.put(I.init_blank(qureg.num_amps_total, qureg.dtype, qureg.device))
    if qureg.qasm_log:
        qureg.qasm_log.record_comment(
            "Here, the register was initialised to an unphysical all-zero-amplitudes 'state'.")


def initZeroState(qureg: Qureg) -> None:
    """Set the register to |0...0> (QuEST.h:194)."""
    qureg.put(I.init_classical(qureg.num_amps_total, qureg.dtype, qureg.device, 0))
    if qureg.qasm_log:
        qureg.qasm_log.record_init_zero()


def initPlusState(qureg: Qureg) -> None:
    """Set the register to |+>^n, every amplitude equal (QuEST.h:195)."""
    qureg.put(I.init_plus(qureg.num_amps_total, qureg.dtype, qureg.device))
    if qureg.qasm_log:
        qureg.qasm_log.record_init_plus()


def initClassicalState(qureg: Qureg, state_index: int) -> None:
    """Set the register to computational basis state |stateInd> (QuEST.h:196)."""
    V.validate_state_index(qureg, state_index, "initClassicalState")
    qureg.put(I.init_classical(qureg.num_amps_total, qureg.dtype, qureg.device,
                               state_index))
    if qureg.qasm_log:
        qureg.qasm_log.record_init_classical(state_index)


def initDebugState(qureg: Qureg) -> None:
    """amp_i = (2i + (2i+1) i)/10: the deterministic test fixture (QuEST.h:1721)."""
    qureg.put(I.init_debug(qureg.num_amps_total, qureg.dtype, qureg.device))
    if qureg.qasm_log:
        qureg.qasm_log.record_comment("initDebugState")
