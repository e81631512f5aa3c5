"""User-facing data structures (reference: ``QuEST/include/QuEST.h``).

A copy of the part of ``quest_tpu/datatypes.py`` that the dense-gate
surface takes: gate matrices stay host-side numpy (complex, any
(2^n, 2^n) array-like), cast to the register's type and device at apply
time.

  - pauliOpType enum            (QuEST.h:262-270)
  - ComplexMatrixN helpers      (QuEST.h:154-208; create/destroy keep the
                                 reference's names, Python collects)
  - Vector                      (QuEST.h:215-218)
  - PauliHamil                  (QuEST.h:296-307, createPauliHamilFromFile
                                 QuEST.h:914), host-side numpy codes and
                                 coefficients
  - phaseFunc / bitEncoding     (QuEST.h enums of the phase-function family)
  - DiagonalOp                  (QuEST.h:316-332), a full 2^N diagonal on
                                 the env's device, or cut over its mesh
                                 as a Qureg is
  - SubDiagonalOp               (QuEST.h:340-351), a small diagonal on <= N
                                 targets
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from . import validation

__all__ = [
    "pauliOpType", "PAULI_I", "PAULI_X", "PAULI_Y", "PAULI_Z", "bitEncoding",
    "phaseFunc", "Vector", "DiagonalOp",
    "createComplexMatrixN", "destroyComplexMatrixN", "initComplexMatrixN",
    "bindArraysToStackComplexMatrixN", "getStaticComplexMatrixN",
    "SubDiagonalOp", "createSubDiagonalOp", "destroySubDiagonalOp",
    "PauliHamil", "createPauliHamil", "destroyPauliHamil", "initPauliHamil",
    "createPauliHamilFromFile",
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

class bitEncoding(enum.IntEnum):
    """Sub-register value encodings for phase functions (QuEST.h enum bitEncoding)."""

    UNSIGNED = 0
    TWOS_COMPLEMENT = 1


class phaseFunc(enum.IntEnum):
    """Named phase functions (QuEST.h enum phaseFunc)."""

    NORM = 0
    SCALED_NORM = 1
    INVERSE_NORM = 2
    SCALED_INVERSE_NORM = 3
    SCALED_INVERSE_SHIFTED_NORM = 4
    PRODUCT = 5
    SCALED_PRODUCT = 6
    INVERSE_PRODUCT = 7
    SCALED_INVERSE_PRODUCT = 8
    DISTANCE = 9
    SCALED_DISTANCE = 10
    INVERSE_DISTANCE = 11
    SCALED_INVERSE_DISTANCE = 12
    SCALED_INVERSE_SHIFTED_DISTANCE = 13
    SCALED_INVERSE_SHIFTED_WEIGHTED_DISTANCE = 14


#: the Pauli matrices by code
PAULI_MATRICES = {
    0: np.eye(2, dtype=np.complex128),
    1: np.array([[0, 1], [1, 0]], dtype=np.complex128),
    2: np.array([[0, -1j], [1j, 0]], dtype=np.complex128),
    3: np.array([[1, 0], [0, -1]], dtype=np.complex128),
}


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
# PauliHamil
# ---------------------------------------------------------------------------

@dataclass
class PauliHamil:
    """Real-weighted sum of Pauli products (QuEST.h:296-307).

    ``pauli_codes`` has shape (num_sum_terms, num_qubits): codes[t, q] is the
    Pauli acting on qubit q in term t (the reference flattens this to a single
    array of length numSumTerms*numQubits with the same ordering).
    """

    num_qubits: int
    num_sum_terms: int
    pauli_codes: np.ndarray = field(default=None)
    term_coeffs: np.ndarray = field(default=None)

    def __post_init__(self):
        if self.pauli_codes is None:
            self.pauli_codes = np.zeros((self.num_sum_terms, self.num_qubits), dtype=np.int32)
        else:
            self.pauli_codes = np.asarray(self.pauli_codes, dtype=np.int32).reshape(
                self.num_sum_terms, self.num_qubits)
        if self.term_coeffs is None:
            self.term_coeffs = np.zeros((self.num_sum_terms,), dtype=np.float64)
        else:
            self.term_coeffs = np.asarray(self.term_coeffs, dtype=np.float64).reshape(
                self.num_sum_terms)


def createPauliHamil(num_qubits: int, num_sum_terms: int) -> PauliHamil:
    """Blank Hamiltonian (createPauliHamil, QuEST.h:858)."""
    func = "createPauliHamil"
    validation.validate_num_qubits(num_qubits, func)
    validation._assert(num_sum_terms > 0, "Invalid number of terms in the PauliHamil. The number of terms must be strictly positive.", func)
    return PauliHamil(num_qubits, num_sum_terms)


def destroyPauliHamil(hamil: PauliHamil) -> None:
    """Nothing to free (Python collects); kept for API parity."""


def initPauliHamil(hamil: PauliHamil, coeffs, codes) -> None:
    """Overwrite a Hamiltonian in place (initPauliHamil, QuEST.h:953)."""
    func = "initPauliHamil"
    codes = np.asarray(codes, dtype=np.int32).reshape(hamil.num_sum_terms, hamil.num_qubits)
    validation.validate_pauli_codes(codes.ravel(), func)
    hamil.term_coeffs[...] = np.asarray(coeffs, dtype=np.float64)
    hamil.pauli_codes[...] = codes


def createPauliHamilFromFile(path: str) -> PauliHamil:
    """Parse the reference's Hamiltonian file format (createPauliHamilFromFile,
    QuEST.h:914): each line is ``coeff code code ... code`` with one code per
    qubit; the qubit count is inferred from the first line."""
    func = "createPauliHamilFromFile"
    try:
        f = open(path)
    except OSError:
        validation.validate_file_opened(False, path, func)
    coeffs, codes = [], []
    with f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            try:
                coeffs.append(float(parts[0]))
            except ValueError:
                validation.validate_hamil_file_coeff_parsed(False, path, func)
            row = []
            for c in parts[1:]:
                try:
                    v = float(c)
                except ValueError:
                    validation.validate_hamil_file_pauli_parsed(False, path, func)
                validation._assert(v == int(v), "Failed to parse the next "
                                   f"expected Pauli code in PauliHamil file ({path}).",
                                   func)
                validation.validate_hamil_file_pauli_code(int(v), path, func)
                row.append(int(v))
            codes.append(row)
    num_qubits = len(codes[0]) if codes else 0
    validation.validate_hamil_file_params(num_qubits, len(coeffs), path, func)
    validation._assert(all(len(c) == num_qubits for c in codes),
                       "Failed to parse the next expected Pauli code in "
                       f"PauliHamil file ({path}).", func)
    hamil = PauliHamil(num_qubits, len(coeffs), np.asarray(codes), np.asarray(coeffs))
    validation.validate_pauli_hamil(hamil, func)
    return hamil


def pauli_term_matrix(codes_row) -> np.ndarray:
    """Dense 2^N matrix of one Pauli product term; qubit 0 = least-significant
    index bit, so it is the *last* factor of the Kronecker product."""
    m = np.eye(1, dtype=np.complex128)
    for code in reversed(list(codes_row)):
        m = np.kron(m, PAULI_MATRICES[int(code)])
    return m


# ---------------------------------------------------------------------------
# DiagonalOp / SubDiagonalOp
# ---------------------------------------------------------------------------

@dataclass
class DiagonalOp:
    """Full-Hilbert 2^N diagonal operator (QuEST.h:316-332).

    ``elems`` is the planar (2, 2^N) tensor of its elements on the env's
    device, in the global precision's dtype; on an env whose mesh holds
    D > 1 devices it is None and ``shards`` holds D tensors (2, 2^N / D),
    cut as a state-vector Qureg of N qubits is (``registers``). The
    reference's host copy is the pair of views ``real`` and ``imag``."""

    num_qubits: int
    elems: Optional[object] = None
    shards: Optional[list] = None

    @property
    def pieces(self) -> list:
        """The element tensors: its shards, or its one tensor."""
        return [self.elems] if self.shards is None else list(self.shards)

    def _host(self) -> np.ndarray:
        return np.concatenate([p.detach().cpu().numpy() for p in self.pieces], axis=1)

    @property
    def real(self) -> np.ndarray:
        return self._host()[0]

    @property
    def imag(self) -> np.ndarray:
        return self._host()[1]


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
