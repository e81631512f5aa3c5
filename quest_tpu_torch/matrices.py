"""Standard gate matrices and rotation decompositions.

A copy of ``quest_tpu/matrices.py``: the reference's algebra
(QuEST_common.c:120-139,310-324), where axis rotations reduce to a
"compact unitary" (alpha, beta) pair, the 2x2 matrix
[[alpha, -conj(beta)], [beta, conj(alpha)]].

Host-side numpy by default. The parameterized replay
(:mod:`.engine.params`) instead hands in 0-d tensors, views of the bound
values on the register's device, and every angle-taking function then
assembles the same matrix on that device as a PLANAR (2, ...) real tensor
(real plane, imaginary plane): entrywise from real ``torch.cos`` /
``torch.sin`` components, never a complex transcendental, as the JAX
package's traced branches do. Nothing then leaves the device, so a CUDA
graph holds the assembly.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def is_traced(*xs) -> bool:
    """True when any argument is a ``torch.Tensor`` (a runtime value): the
    matrix is then assembled on its device (the JAX package's counterpart
    asks for a jax array or tracer)."""
    return any(isinstance(x, torch.Tensor) for x in xs)


def _parts(x):
    """(real, imaginary) of a scalar tensor, as real tensors."""
    if x.is_complex():
        return x.real, x.imag
    return x, torch.zeros_like(x)


def planar(re, im) -> torch.Tensor:
    """The planar (2, ...) tensor of equal-shaped real and imaginary parts."""
    return torch.stack([re, im])

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
    if is_traced(alpha, beta):
        (ar, ai), (br, bi) = _parts(alpha), _parts(beta)
        re = torch.stack([torch.stack([ar, -br]), torch.stack([br, ar])])
        im = torch.stack([torch.stack([ai, bi]), torch.stack([bi, -ai])])
        return planar(re, im)
    return np.array([[alpha, -np.conj(beta)], [beta, np.conj(alpha)]], dtype=np.complex128)


def rotation_around_axis_pair(angle: float, axis) -> tuple[complex, complex]:
    """(alpha, beta) for exp(-i angle/2 (n . sigma)) about unit axis n
    (getComplexPairFromRotation, QuEST_common.c:120-127)."""
    x, y, z = axis[0], axis[1], axis[2]
    mag = math.sqrt(x * x + y * y + z * z)
    x, y, z = x / mag, y / mag, z / mag
    if is_traced(angle):
        c, s = torch.cos(angle / 2), torch.sin(angle / 2)
        return torch.complex(c, -s * z), torch.complex(s * y, -s * x)
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
    if is_traced(theta):
        c, s = torch.cos(theta / 2), torch.sin(theta / 2)
        return planar(torch.stack([c, c]), torch.stack([-s, s]))
    return np.array([np.exp(-0.5j * theta), np.exp(0.5j * theta)], dtype=np.complex128)


def phase_shift_diag(theta: float) -> np.ndarray:
    """diag(1, e^{i theta}) (phaseShift, QuEST.h:1916)."""
    if is_traced(theta):
        c, s = torch.cos(theta), torch.sin(theta)
        return planar(torch.stack([torch.ones_like(c), c]),
                      torch.stack([torch.zeros_like(s), s]))
    return np.array([1.0, np.exp(1j * theta)], dtype=np.complex128)


#: basis-change matrices sending Pauli P to Z: P = U^dagger Z U
#: X = H Z H; Y = (H S^dagger)^dagger Z (H S^dagger)
BASIS_TO_Z = {
    1: HADAMARD,
    2: HADAMARD @ np.conj(S_GATE).T,
}
