"""User-facing data structures (reference: ``QuEST/include/QuEST.h``).

A copy of the part of ``quest_tpu/datatypes.py`` that the dense-gate
surface takes: gate matrices stay host-side numpy (complex, any
(2^n, 2^n) array-like), cast to the register's type and device at apply
time.

  - pauliOpType enum            (QuEST.h:262-270)
  - ComplexMatrixN helpers      (QuEST.h:154-208; create/destroy keep the
                                 reference's names, Python collects)
  - Vector                      (QuEST.h:215-218)
  - SubDiagonalOp               (QuEST.h:340-351), a small diagonal on <= N
                                 targets

``PauliHamil`` and ``DiagonalOp`` wait for the operators slice.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

from . import validation

__all__ = [
    "pauliOpType", "PAULI_I", "PAULI_X", "PAULI_Y", "PAULI_Z", "Vector",
    "createComplexMatrixN", "destroyComplexMatrixN", "initComplexMatrixN",
    "bindArraysToStackComplexMatrixN", "getStaticComplexMatrixN",
    "SubDiagonalOp", "createSubDiagonalOp", "destroySubDiagonalOp",
]


class pauliOpType(enum.IntEnum):
    """Pauli operator codes, as the reference enum (QuEST.h:262-270)."""

    PAULI_I = 0
    PAULI_X = 1
    PAULI_Y = 2
    PAULI_Z = 3


PAULI_I = pauliOpType.PAULI_I
PAULI_X = pauliOpType.PAULI_X
PAULI_Y = pauliOpType.PAULI_Y
PAULI_Z = pauliOpType.PAULI_Z


@dataclass
class Vector:
    """A 3-vector, used for Bloch-axis rotations (QuEST.h:215-218)."""

    x: float
    y: float
    z: float

    def __getitem__(self, i):
        return (self.x, self.y, self.z)[i]


# ---------------------------------------------------------------------------
# gate matrices
# ---------------------------------------------------------------------------

def createComplexMatrixN(num_qubits: int) -> np.ndarray:
    """Zeroed 2^n x 2^n gate matrix (createComplexMatrixN, QuEST.c:775-819)."""
    validation.validate_num_qubits(num_qubits, "createComplexMatrixN")
    dim = 2 ** num_qubits
    return np.zeros((dim, dim), dtype=np.complex128)


def destroyComplexMatrixN(matrix) -> None:
    """Nothing to free (Python collects); kept for API parity."""


def initComplexMatrixN(matrix: np.ndarray, real, imag) -> None:
    """Overwrite a matrix from real/imag nested lists (initComplexMatrixN, QuEST.c)."""
    func = "initComplexMatrixN"
    validation.validate_matrix_init(matrix, func)
    validation.validate_matrix_init_dims(matrix, real, imag, func)
    matrix[...] = np.asarray(real) + 1j * np.asarray(imag)


class BoundComplexMatrixN:
    """A ComplexMatrixN aliasing caller-owned real/imag storage
    (bindArraysToStackComplexMatrixN, QuEST.h:6232, QuEST_common.c:649-677):
    later edits to the planes are seen by later gate applications, since
    every consumer reads the matrix through ``np.asarray``."""

    def __init__(self, real: np.ndarray, imag: np.ndarray):
        self.real = real
        self.imag = imag
        self.shape = real.shape
        self.ndim = 2

    def __array__(self, dtype=None, copy=None):
        m = self.real + 1j * self.imag
        return m.astype(dtype) if dtype is not None else m

    def __getitem__(self, idx):
        return (self.real + 1j * self.imag)[idx]

    def __repr__(self):
        return f"BoundComplexMatrixN({self.real + 1j * self.imag!r})"


def bindArraysToStackComplexMatrixN(num_qubits: int, real, imag,
                                    re_storage=None, im_storage=None) -> BoundComplexMatrixN:
    """Bind a 2^n x 2^n matrix over caller-provided planar arrays without
    copying; ``re_storage``/``im_storage`` are accepted for signature
    parity and ignored (numpy arrays own their storage)."""
    func = "bindArraysToStackComplexMatrixN"
    dim = 1 << num_qubits
    real = np.asarray(real, dtype=float)
    imag = np.asarray(imag, dtype=float)
    validation._assert(real.shape == (dim, dim) and imag.shape == (dim, dim),
                       "Invalid matrix dimensions. The real and imaginary components must each be 2^numQubits x 2^numQubits.",
                       func)
    return BoundComplexMatrixN(real, imag)


def getStaticComplexMatrixN(real, imag=None, _imag=None) -> np.ndarray:
    """A matrix from nested lists (the reference macro
    getStaticComplexMatrixN, QuEST.h:6232), called as (re, im) or as the
    reference's (numQubits, re, im)."""
    func = "getStaticComplexMatrixN"
    if np.ndim(real) == 0:  # (numQubits, re, im)
        num_qubits, real, imag = int(real), imag, _imag
        validation._assert(imag is not None,
                           "Both real and imaginary matrix components must be given.", func)
        m = np.asarray(real) + 1j * np.asarray(imag)
        validation._assert(m.shape == (1 << num_qubits, 1 << num_qubits),
                           "Invalid matrix dimensions for the given number of qubits.", func)
        return m
    validation._assert(_imag is None and imag is not None,
                       "Both real and imaginary matrix components must be given.", func)
    return np.asarray(real) + 1j * np.asarray(imag)


# ---------------------------------------------------------------------------
# SubDiagonalOp
# ---------------------------------------------------------------------------

@dataclass
class SubDiagonalOp:
    """Diagonal operator on a subset of <= N qubits (QuEST.h:340-351);
    small, kept on the host."""

    num_qubits: int
    elems: np.ndarray

    @property
    def num_elems(self) -> int:
        return 2 ** self.num_qubits


def createSubDiagonalOp(num_qubits: int) -> SubDiagonalOp:
    """Allocate a diagonal operator over a qubit subset (QuEST.h:185)."""
    validation.validate_num_qubits(num_qubits, "createSubDiagonalOp")
    return SubDiagonalOp(num_qubits, np.zeros(2 ** num_qubits, dtype=np.complex128))


def destroySubDiagonalOp(op: SubDiagonalOp) -> None:
    """Nothing to free (Python collects); kept for API parity."""
