"""Calculations of the ported slice: total probability, outcome
probabilities and amplitude reads of state-vector registers (reference
QuEST.h:2516, 276, 286-288; kernels in ops.reduce)."""

from __future__ import annotations

from . import validation as V
from .ops import reduce as R
from .registers import Qureg

__all__ = ["calcTotalProb", "calcProbOfOutcome", "getAmp", "getRealAmp",
           "getImagAmp"]


def calcTotalProb(qureg: Qureg) -> float:
    """sum |amp|^2 of a state-vector (QuEST.h:2516)."""
    V.validate_state_vec(qureg, "calcTotalProb")
    return float(R.total_prob_statevec(qureg.amps))


def calcProbOfOutcome(qureg: Qureg, target: int, outcome: int) -> float:
    """Probability of measuring ``outcome`` on ``target`` (QuEST.h:276)."""
    func = "calcProbOfOutcome"
    V.validate_target(qureg, target, func)
    V.validate_outcome(outcome, func)
    V.validate_state_vec(qureg, func)
    return float(R.prob_of_outcome(qureg.amps, n=qureg.num_qubits_in_state_vec,
                                   target=target, outcome=outcome))


def getAmp(qureg: Qureg, index: int) -> complex:
    """One statevector amplitude as a complex (QuEST.h:286)."""
    func = "getAmp"
    V.validate_state_vec(qureg, func)
    V.validate_amp_index(qureg, index, func)
    re, im = qureg.amps[:, index].tolist()
    return complex(re, im)


def getRealAmp(qureg: Qureg, index: int) -> float:
    """Real part of one statevector amplitude (QuEST.h:287)."""
    return getAmp(qureg, index).real


def getImagAmp(qureg: Qureg, index: int) -> float:
    """Imaginary part of one statevector amplitude (QuEST.h:288)."""
    return getAmp(qureg, index).imag
