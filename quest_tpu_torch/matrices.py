"""Standard gate matrices and rotation decompositions, host-side numpy.

A copy of the part of ``quest_tpu/matrices.py`` that the ported gates use
(the reference's algebra, QuEST_common.c:120-139,310-324): axis rotations
reduce to a "compact unitary" (alpha, beta) pair, the 2x2 matrix
[[alpha, -conj(beta)], [beta, conj(alpha)]].
"""

from __future__ import annotations

import math

import numpy as np

SQRT2_INV = 1.0 / math.sqrt(2.0)

HADAMARD = np.array([[SQRT2_INV, SQRT2_INV], [SQRT2_INV, -SQRT2_INV]], dtype=np.complex128)


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


def rx_matrix(theta: float) -> np.ndarray:
    return compact_unitary_matrix(*rotation_around_axis_pair(theta, (1.0, 0.0, 0.0)))


def rz_diag(theta: float) -> np.ndarray:
    """Diagonal of Rz(theta) = exp(-i theta/2 Z)."""
    return np.array([np.exp(-0.5j * theta), np.exp(0.5j * theta)], dtype=np.complex128)
