"""Standard gate matrices and rotation decompositions, host-side numpy.

A copy of ``quest_tpu/matrices.py`` without its traced branches (the port
has no tracers; runtime gate parameters wait for the Param lift): the
reference's algebra (QuEST_common.c:120-139,310-324), where axis
rotations reduce to a "compact unitary" (alpha, beta) pair, the 2x2
matrix [[alpha, -conj(beta)], [beta, conj(alpha)]].
"""

from __future__ import annotations

import math

import numpy as np

SQRT2_INV = 1.0 / math.sqrt(2.0)

HADAMARD = np.array([[SQRT2_INV, SQRT2_INV], [SQRT2_INV, -SQRT2_INV]], dtype=np.complex128)
PAULI_X_M = np.array([[0, 1], [1, 0]], dtype=np.complex128)
PAULI_Y_M = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
PAULI_Z_M = np.array([[1, 0], [0, -1]], dtype=np.complex128)
S_GATE = np.array([[1, 0], [0, 1j]], dtype=np.complex128)
T_GATE = np.array([[1, 0], [0, np.exp(1j * math.pi / 4)]], dtype=np.complex128)

SQRT_SWAP = np.array(
    [[1, 0, 0, 0],
     [0, 0.5 + 0.5j, 0.5 - 0.5j, 0],
     [0, 0.5 - 0.5j, 0.5 + 0.5j, 0],
     [0, 0, 0, 1]], dtype=np.complex128)


def compact_unitary_matrix(alpha: complex, beta: complex) -> np.ndarray:
    """[[alpha, -conj(beta)], [beta, conj(alpha)]] (compactUnitary, QuEST.h:2562)."""
    return np.array([[alpha, -np.conj(beta)], [beta, np.conj(alpha)]], dtype=np.complex128)


def rotation_around_axis_pair(angle: float, axis) -> tuple[complex, complex]:
    """(alpha, beta) for exp(-i angle/2 (n . sigma)) about unit axis n
    (getComplexPairFromRotation, QuEST_common.c:120-127)."""
    x, y, z = axis[0], axis[1], axis[2]
    mag = math.sqrt(x * x + y * y + z * z)
    x, y, z = x / mag, y / mag, z / mag
    c, s = math.cos(angle / 2), math.sin(angle / 2)
    return complex(c, -s * z), complex(s * y, -s * x)


def rotation_matrix(angle: float, axis) -> np.ndarray:
    return compact_unitary_matrix(*rotation_around_axis_pair(angle, axis))


def rx_matrix(theta: float) -> np.ndarray:
    return rotation_matrix(theta, (1.0, 0.0, 0.0))


def ry_matrix(theta: float) -> np.ndarray:
    return rotation_matrix(theta, (0.0, 1.0, 0.0))


def rz_diag(theta: float) -> np.ndarray:
    """Diagonal of Rz(theta) = exp(-i theta/2 Z)."""
    return np.array([np.exp(-0.5j * theta), np.exp(0.5j * theta)], dtype=np.complex128)


def phase_shift_diag(theta: float) -> np.ndarray:
    """diag(1, e^{i theta}) (phaseShift, QuEST.h:1916)."""
    return np.array([1.0, np.exp(1j * theta)], dtype=np.complex128)


#: basis-change matrices sending Pauli P to Z: P = U^dagger Z U
#: X = H Z H; Y = (H S^dagger)^dagger Z (H S^dagger)
BASIS_TO_Z = {
    1: HADAMARD,
    2: HADAMARD @ np.conj(S_GATE).T,
}
