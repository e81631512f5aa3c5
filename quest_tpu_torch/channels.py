"""Canonical table of the built-in decoherence channels.

A copy of ``quest_tpu/channels.py``: the Kraus operators that the density
route (``decoherence.py`` mix* -> ``ops/density.py``) builds its
superoperators ``sum_k conj(K) (x) K`` from, or, for the purely diagonal
dephasing family, the equivalent factor diagonals (the reference's
dedicated dephase kernels, QuEST_cpu.c:60-135).

Operator conventions: 2^t x 2^t complex128 numpy arrays, ``targets[0]`` =
least-significant bit of the matrix index (the ``ops/apply.apply_matrix``
convention), CPTP by construction (``sum_k K_k^dagger K_k = I``) for every
in-range probability.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

__all__ = [
    "PAULI_MATRICES", "ChannelSpec", "CHANNELS", "MIX_CHANNELS", "kraus_ops",
    "dephasing_kraus", "two_qubit_dephasing_kraus",
    "depolarising_kraus", "two_qubit_depolarising_kraus",
    "damping_kraus", "pauli_kraus",
]

#: I, X, Y, Z by pauliOpType code (QuEST.h:96)
PAULI_MATRICES = (
    np.eye(2, dtype=np.complex128),
    np.array([[0, 1], [1, 0]], dtype=np.complex128),
    np.array([[0, -1j], [1j, 0]], dtype=np.complex128),
    np.array([[1, 0], [0, -1]], dtype=np.complex128),
)


def dephasing_kraus(prob: float):
    """mixDephasing as a 2-operator Kraus map: rho -> (1-p) rho + p Z r Z
    (QuEST.h:4011). The density route applies it as the equivalent
    off-diagonal factor diagonal (ops/density.dephase_factors_1q)."""
    return [
        np.sqrt(1 - prob) * PAULI_MATRICES[0],
        np.sqrt(prob) * PAULI_MATRICES[3],
    ]


def two_qubit_dephasing_kraus(prob: float):
    """mixTwoQubitDephasing: rho -> (1-p) rho + p/3 (Z1 r Z1 + Z2 r Z2 +
    Z1Z2 r Z1Z2) (QuEST.h:4031; density diagonal: dephase_factors_2q).
    qubit1 is the low matrix bit, matching the superoperator target order."""
    i2, z = PAULI_MATRICES[0], PAULI_MATRICES[3]
    return [
        np.sqrt(1 - prob) * np.kron(i2, i2),
        np.sqrt(prob / 3) * np.kron(i2, z),      # Z on qubit1 (low bit)
        np.sqrt(prob / 3) * np.kron(z, i2),      # Z on qubit2
        np.sqrt(prob / 3) * np.kron(z, z),
    ]


def depolarising_kraus(prob: float):
    """(1-p) rho + p/3 (X r X + Y r Y + Z r Z) (mixDepolarising, QuEST.h:4051)."""
    return [
        np.sqrt(1 - prob) * PAULI_MATRICES[0],
        np.sqrt(prob / 3) * PAULI_MATRICES[1],
        np.sqrt(prob / 3) * PAULI_MATRICES[2],
        np.sqrt(prob / 3) * PAULI_MATRICES[3],
    ]


def two_qubit_depolarising_kraus(prob: float):
    """rho -> (1-p) rho + p/15 sum_{(A,B) != (I,I)} (A x B) rho (A x B)
    (mixTwoQubitDepolarising, QuEST.h:4156). qubit1 is the low matrix bit."""
    ops = []
    for a in range(4):
        for b in range(4):
            m = np.kron(PAULI_MATRICES[b], PAULI_MATRICES[a])  # qubit1 low bit
            if a == 0 and b == 0:
                ops.append(np.sqrt(1 - prob) * m)
            else:
                ops.append(np.sqrt(prob / 15) * m)
    return ops


def damping_kraus(prob: float):
    """Amplitude damping (mixDamping, QuEST.h:4089)."""
    k0 = np.array([[1, 0], [0, np.sqrt(1 - prob)]], dtype=np.complex128)
    k1 = np.array([[0, np.sqrt(prob)], [0, 0]], dtype=np.complex128)
    return [k0, k1]


def pauli_kraus(px: float, py: float, pz: float):
    """mixPauli as a 4-operator Kraus map (QuEST_common.c:740-760)."""
    return [
        np.sqrt(1 - px - py - pz) * PAULI_MATRICES[0],
        np.sqrt(px) * PAULI_MATRICES[1],
        np.sqrt(py) * PAULI_MATRICES[2],
        np.sqrt(pz) * PAULI_MATRICES[3],
    ]


@dataclass(frozen=True)
class ChannelSpec:
    """One built-in channel: ``kraus(*probs)`` returns its operator list.

    ``num_targets`` is the channel arity (1 or 2 qubits), ``num_probs`` the
    probability-argument count, and ``diagonal`` marks the dephasing family
    whose density-route application skips the superoperator for the factor
    diagonal."""
    name: str
    num_targets: int
    num_probs: int
    kraus: Callable[..., list]
    diagonal: bool = False


#: the canonical table, keyed by channel name.
CHANNELS = {
    "dephasing": ChannelSpec("dephasing", 1, 1, dephasing_kraus,
                             diagonal=True),
    "two_qubit_dephasing": ChannelSpec("two_qubit_dephasing", 2, 1,
                                       two_qubit_dephasing_kraus,
                                       diagonal=True),
    "depolarising": ChannelSpec("depolarising", 1, 1, depolarising_kraus),
    "two_qubit_depolarising": ChannelSpec("two_qubit_depolarising", 2, 1,
                                          two_qubit_depolarising_kraus),
    "damping": ChannelSpec("damping", 1, 1, damping_kraus),
    "pauli": ChannelSpec("pauli", 1, 3, pauli_kraus),
}

#: decoherence.py API name -> table key
MIX_CHANNELS = {
    "mixDephasing": "dephasing",
    "mixTwoQubitDephasing": "two_qubit_dephasing",
    "mixDepolarising": "depolarising",
    "mixTwoQubitDepolarising": "two_qubit_depolarising",
    "mixDamping": "damping",
    "mixPauli": "pauli",
}


def kraus_ops(name: str, *probs) -> list:
    """The canonical Kraus operators of built-in channel ``name`` at the
    given probability argument(s)."""
    spec = CHANNELS[name]
    if len(probs) != spec.num_probs:
        raise ValueError(
            f"channel '{name}' takes {spec.num_probs} probability "
            f"argument(s), got {len(probs)}")
    return spec.kraus(*probs)
