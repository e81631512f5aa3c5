"""Calculations of the ported slices: total probability, outcome
probabilities, purity and amplitude reads of state-vector and density
registers (reference QuEST.h:2516, 276, 4247, 286-288, 2489; kernels in
ops.reduce and ops.measure), sharded state vectors included."""

from __future__ import annotations

from . import validation as V
from .ops import measure as M, reduce as R
from .registers import Qureg

__all__ = ["calcTotalProb", "calcProbOfOutcome", "calcPurity", "getAmp",
           "getRealAmp", "getImagAmp", "getDensityAmp"]


def calcTotalProb(qureg: Qureg) -> float:
    """sum |amp|^2 (state-vector) or Re tr(rho) (density) (QuEST.h:2516)."""
    if qureg.shards is not None:
        return float(R.total_prob_shards(qureg.shards))
    if qureg.is_density_matrix:
        return float(R.total_prob_density(qureg.amps, n=qureg.num_qubits_represented))
    return float(R.total_prob_statevec(qureg.amps))


def calcProbOfOutcome(qureg: Qureg, target: int, outcome: int) -> float:
    """Probability of measuring ``outcome`` on ``target`` (QuEST.h:276)."""
    func = "calcProbOfOutcome"
    V.validate_target(qureg, target, func)
    V.validate_outcome(outcome, func)
    if qureg.shards is not None:
        return float(R.prob_of_outcome_shards(qureg.shards, n=qureg.num_qubits_in_state_vec,
                                              target=target, outcome=outcome))
    if qureg.is_density_matrix:
        return float(M.density_prob_of_outcome(
            qureg.amps, n=qureg.num_qubits_represented, target=target, outcome=outcome))
    return float(R.prob_of_outcome(qureg.amps, n=qureg.num_qubits_in_state_vec,
                                   target=target, outcome=outcome))


def calcPurity(qureg: Qureg) -> float:
    """Tr(rho^2) (QuEST.h:4247)."""
    V.validate_density_matr(qureg, "calcPurity")
    return float(R.purity_density(qureg.amps))


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


def getDensityAmp(qureg: Qureg, row: int, col: int) -> complex:
    """rho[row, col] (QuEST.h:2489); flat index col * 2^n + row."""
    func = "getDensityAmp"
    V.validate_density_matr(qureg, func)
    dim = 1 << qureg.num_qubits_represented
    V._assert(0 <= row < dim and 0 <= col < dim,
              "Invalid amplitude index. Note amplitudes are zero indexed.", func)
    re, im = qureg.amps[:, col * dim + row].tolist()
    return complex(re, im)
