"""Input validation: the validators the ported slices call.

They cover targets and controls, unitarity of 2x2, 4x4 and N-qubit
matrices and of compact pairs, Pauli codes, outcomes and measurement
probabilities, amplitude ranges, matching registers, Kraus maps and the
channel probabilities, Pauli Hamiltonians and their files.

A copy of the matching functions of ``quest_tpu/validation.py`` (itself the
counterpart of the reference's ``QuEST_validation.c``), with the messages
verbatim so that ``pytest.raises(match=...)`` cases carry over. A failure
goes through one overridable hook, as the reference's user-overridable
``invalidQuESTInputError`` (QuEST.h:6160-6188): by default it raises
:class:`QuESTError`; :func:`set_input_error_handler` replaces it, and so
does rebinding ``invalidQuESTInputError`` in this module.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np


class QuESTError(Exception):
    """Raised when API input validation fails."""

    def __init__(self, message: str, func: str = ""):
        self.message = message
        self.func = func
        super().__init__(message if not func else f"{func}: {message}")


def _default_handler(err_msg: str, err_func: str) -> None:
    raise QuESTError(err_msg, err_func)


#: the overridable hook, mirroring invalidQuESTInputError (QuEST.h:6160-6188)
invalid_quest_input_error: Callable[[str, str], None] = _default_handler


def invalidQuESTInputError(errMsg: str, errFunc: str) -> None:
    """Reference-named error hook (invalidQuESTInputError, QuEST.h:6160-6188):
    dispatches through the current handler, so :func:`set_input_error_handler`
    overrides it as redefining the C symbol overrides the reference's weak
    default."""
    invalid_quest_input_error(errMsg, errFunc)


def set_input_error_handler(handler: Callable[[str, str], None] | None) -> None:
    """Override the validation failure hook (None restores the default)."""
    global invalid_quest_input_error
    invalid_quest_input_error = handler if handler is not None else _default_handler


def _fail(msg: str, func: str) -> None:
    # through the module's reference-named symbol, so that both ways of
    # overriding work: set_input_error_handler and rebinding the symbol
    invalidQuESTInputError(msg, func)
    # a hook that returns must not let invalid input through (the reference
    # documents returning as undefined behaviour)
    raise QuESTError(msg, func)


def _assert(cond: bool, msg: str, func: str) -> None:
    if not cond:
        _fail(msg, func)


def validate_num_qubits(num_qubits: int, func: str) -> None:
    _assert(num_qubits > 0, "Invalid number of qubits. Must create >0.", func)
    _assert(num_qubits < 63, "Invalid number of qubits. The given number of qubits cannot be stored.", func)


def validate_target(qureg, target: int, func: str) -> None:
    _assert(
        0 <= target < qureg.num_qubits_represented,
        "Invalid target qubit. Note qubits are zero indexed.",
        func,
    )


def validate_control(qureg, control: int, func: str) -> None:
    _assert(
        0 <= control < qureg.num_qubits_represented,
        "Invalid control qubit. Note qubits are zero indexed.",
        func,
    )


def validate_control_target(qureg, control: int, target: int, func: str) -> None:
    validate_target(qureg, target, func)
    validate_control(qureg, control, func)
    _assert(control != target, "Control qubit cannot equal target qubit.", func)


def validate_unique_targets(qureg, q1: int, q2: int, func: str) -> None:
    validate_target(qureg, q1, func)
    validate_target(qureg, q2, func)
    _assert(q1 != q2, "Qubits must be unique.", func)


def validate_multi_targets(qureg, targets: Sequence[int], func: str) -> None:
    _assert(
        0 < len(targets) <= qureg.num_qubits_represented,
        "Invalid number of target qubits.",
        func,
    )
    for t in targets:
        validate_target(qureg, t, func)
    _assert(len(set(targets)) == len(targets), "The target qubits must be unique.", func)


def validate_multi_controls(qureg, controls: Sequence[int], func: str) -> None:
    _assert(
        0 <= len(controls) < qureg.num_qubits_represented,
        "Invalid number of control qubits.",
        func,
    )
    for c in controls:
        validate_control(qureg, c, func)
    _assert(len(set(controls)) == len(controls), "The control qubits must be unique.", func)


def validate_multi_controls_multi_targets(qureg, controls, targets, func: str) -> None:
    validate_multi_controls(qureg, controls, func)
    validate_multi_targets(qureg, targets, func)
    _assert(
        not (set(controls) & set(targets)),
        "Control and target qubits must be disjoint.",
        func,
    )


def validate_control_state(control_state: Sequence[int], num_controls: int, func: str) -> None:
    _assert(
        len(control_state) == num_controls and all(s in (0, 1) for s in control_state),
        "Invalid control-state. Each qubit state must be 0 or 1.",
        func,
    )


def validate_outcome(outcome: int, func: str) -> None:
    _assert(outcome in (0, 1), "Invalid measurement outcome -- must be either 0 or 1.", func)


def validate_matrix_size(matrix, num_targets: int, func: str) -> None:
    m = np.asarray(matrix)
    dim = 2 ** num_targets
    _assert(
        m.ndim == 2 and m.shape == (dim, dim),
        "Matrix size does not match the number of target qubits.",
        func,
    )


def is_unitary(matrix, eps: float) -> bool:
    m = np.asarray(matrix)
    ident = np.eye(m.shape[0])
    return bool(np.allclose(m @ m.conj().T, ident, atol=eps * m.shape[0]))


def validate_unitary_matrix(matrix, num_targets: int, eps: float, func: str) -> None:
    validate_matrix_size(matrix, num_targets, func)
    _assert(is_unitary(matrix, eps), "Matrix is not unitary.", func)


def validate_unitary_complex_pair(alpha: complex, beta: complex, eps: float, func: str) -> None:
    _assert(
        abs(abs(alpha) ** 2 + abs(beta) ** 2 - 1) < eps,
        "Compact unitary formed by complex alpha and beta is not unitary.",
        func,
    )


def validate_vector(v, func: str) -> None:
    _assert(
        math.sqrt(v[0] ** 2 + v[1] ** 2 + v[2] ** 2) > 1e-15,
        "Invalid axis vector. Must be non-zero.",
        func,
    )


def validate_matrix_init(matrix, func: str) -> None:
    """A destroyed or never-created ComplexMatrixN has no storage (None
    itself, or a bound matrix whose ``real`` plane is gone)."""
    storage = (matrix if isinstance(matrix, np.ndarray)
               else getattr(matrix, "real", matrix))
    _assert(storage is not None,
            "The ComplexMatrixN was not successfully created (possibly "
            "insufficient memory available).", func)


def validate_matrix_init_dims(matrix, real, imag, func: str) -> None:
    m = np.asarray(matrix)
    _assert(np.asarray(real).shape == m.shape and np.asarray(imag).shape == m.shape,
            "The real/imag components must match the dimension of the "
            "created matrix.", func)


def validate_sub_diag_op_targets(op, num_targets: int, func: str) -> None:
    _assert(op.num_qubits == num_targets,
            "The given SubDiagonalOp has an incompatible dimension with the "
            "given number of target qubits.", func)


def validate_unitary_sub_diag_op(op, eps: float, func: str) -> None:
    elems = np.asarray(op.elems)
    _assert(bool(np.all(np.abs(np.abs(elems) - 1) < 100 * eps)),
            "Diagonal operator is not unitary.", func)


def validate_pauli_codes(codes, func: str) -> None:
    for c in codes:
        _assert(
            int(c) in (0, 1, 2, 3),
            "Invalid Pauli code. Codes must be 0 (or PAULI_I), 1 (PAULI_X), 2 (PAULI_Y) or 3 (PAULI_Z).",
            func,
        )


def validate_num_pauli_codes(codes, expected: int, func: str) -> None:
    _assert(len(codes) == expected,
            "Invalid number of Pauli codes. The number of codes must match the number of target qubits.",
            func)
    validate_pauli_codes(codes, func)


def validate_pauli_hamil(hamil, func: str) -> None:
    _assert(
        hamil.num_qubits > 0 and hamil.num_sum_terms > 0,
        "Invalid PauliHamil parameters. The number of qubits and terms must be strictly positive.",
        func,
    )
    validate_pauli_codes(hamil.pauli_codes.ravel(), func)


def validate_hamil_matches_qureg(qureg, hamil, func: str) -> None:
    _assert(
        hamil.num_qubits == qureg.num_qubits_represented,
        "The PauliHamil must act on the same number of qubits as the register.",
        func,
    )


def validate_file_opened(opened: bool, path: str, func: str) -> None:
    _assert(opened, f"Could not open file ({path}).", func)


def validate_hamil_file_params(num_qubits: int, num_terms: int, path: str,
                               func: str) -> None:
    _assert(num_qubits > 0 and num_terms > 0,
            f"The number of qubits and terms in the PauliHamil file ({path}) "
            "must be strictly positive.", func)


def validate_hamil_file_coeff_parsed(parsed: bool, path: str, func: str) -> None:
    _assert(parsed,
            "Failed to parse the next expected term coefficient in PauliHamil "
            f"file ({path}).", func)


def validate_hamil_file_pauli_parsed(parsed: bool, path: str, func: str) -> None:
    _assert(parsed,
            "Failed to parse the next expected Pauli code in PauliHamil "
            f"file ({path}).", func)


def validate_hamil_file_pauli_code(code: int, path: str, func: str) -> None:
    _assert(int(code) in (0, 1, 2, 3),
            f"The PauliHamil file ({path}) contained an invalid pauli code "
            f"({int(code)}). Codes must be 0 (or PAULI_I), 1 (PAULI_X), "
            "2 (PAULI_Y) or 3 (PAULI_Z) to indicate the identity, X, Y and Z "
            "operators respectively.", func)


def validate_measurement_prob(prob: float, eps: float, func: str) -> None:
    """The outcome to collapse to must have probability above REAL_EPS."""
    _assert(prob > eps, "Can't collapse to state with zero probability.", func)


def validate_kraus_ops(ops, num_targets: int, eps: float, func: str, check_cptp: bool = True) -> None:
    dim = 2 ** num_targets
    _assert(len(ops) > 0, "Invalid number of operators.", func)
    _assert(
        len(ops) <= dim * dim,
        "Invalid number of operators. Must be >0 and <= 4^numTargets.",
        func,
    )
    for op in ops:
        validate_matrix_size(op, num_targets, func)
    if check_cptp:
        acc = np.zeros((dim, dim), dtype=np.complex128)
        for op in ops:
            m = np.asarray(op).astype(np.complex128)
            acc += m.conj().T @ m
        _assert(
            np.allclose(acc, np.eye(dim), atol=eps * dim),
            "The specified Kraus map is not completely positive and trace preserving (CPTP).",
            func,
        )


def validate_probability(prob: float, max_prob: float, func: str) -> None:
    _assert(0 <= prob <= max_prob + 1e-30, "Probabilities must be in [0, 1].", func)


def validate_one_qubit_dephase_prob(prob: float, func: str) -> None:
    _assert(0 <= prob <= 1 / 2, "The probability of a single-qubit dephase error cannot exceed 1/2.", func)


def validate_two_qubit_dephase_prob(prob: float, func: str) -> None:
    _assert(0 <= prob <= 3 / 4, "The probability of a two-qubit dephase error cannot exceed 3/4.", func)


def validate_one_qubit_depol_prob(prob: float, func: str) -> None:
    _assert(0 <= prob <= 3 / 4, "The probability of a single-qubit depolarising error cannot exceed 3/4.", func)


def validate_two_qubit_depol_prob(prob: float, func: str) -> None:
    _assert(0 <= prob <= 15 / 16, "The probability of a two-qubit depolarising error cannot exceed 15/16.", func)


def validate_one_qubit_damping_prob(prob: float, func: str) -> None:
    _assert(0 <= prob <= 1, "The probability of a single-qubit damping error cannot exceed 1.", func)


def validate_pauli_probs(px: float, py: float, pz: float, func: str) -> None:
    for p in (px, py, pz):
        _assert(p >= 0, "Probabilities must be in [0, 1].", func)
    _assert(
        px + py + pz <= 1,
        "The probabilities of any of the single-qubit Pauli errors cannot exceed the probability of no error.",
        func,
    )


def validate_density_matr(qureg, func: str) -> None:
    _assert(qureg.is_density_matrix, "Operation valid only for density matrices.", func)


def validate_state_vec(qureg, func: str) -> None:
    _assert(not qureg.is_density_matrix, "Operation valid only for state-vectors.", func)


def validate_matching_qureg_types(a, b, func: str) -> None:
    _assert(
        a.is_density_matrix == b.is_density_matrix,
        "Registers must both be state-vectors or both be density matrices.",
        func,
    )


def validate_second_qureg_state_vec(qureg2, func: str) -> None:
    _assert(not qureg2.is_density_matrix, "Second argument must be a state-vector.", func)


def validate_matching_qureg_dims(a, b, func: str) -> None:
    _assert(
        a.num_qubits_represented == b.num_qubits_represented,
        "Dimensions of the qubit registers don't match.",
        func,
    )


def validate_amp_index(qureg, index: int, func: str) -> None:
    _assert(
        0 <= index < qureg.num_amps_total,
        "Invalid amplitude index. Note amplitudes are zero indexed.",
        func,
    )


def validate_num_amps(qureg, start: int, num: int, func: str) -> None:
    validate_amp_index(qureg, start, func)
    _assert(
        num >= 0 and start + num <= qureg.num_amps_total,
        "Invalid number of amplitudes. Must be >=0 and fit within the register.",
        func,
    )


def validate_state_index(qureg, state_index: int, func: str) -> None:
    _assert(
        0 <= state_index < 2 ** qureg.num_qubits_represented,
        "Invalid state index. Note states are zero indexed.",
        func,
    )


def validate_num_seeds(seeds, func: str) -> None:
    _assert(len(seeds) > 0,
            "Invalid number of seeds. Must use at least 1 seed.", func)


def validate_num_ranks(num_ranks: int, func: str) -> None:
    """A power-of-2 device count, as validateNumRanks (QuEST_validation.c:354-366)."""
    _assert(num_ranks >= 1 and (num_ranks & (num_ranks - 1)) == 0,
            "Invalid number of devices. Must be a power of 2.", func)


def validate_matrix_fits_in_node(local_qubit_count: int, num_targets: int,
                                 func: str) -> None:
    """validateMultiQubitMatrixFitsInNode (QuEST_validation.c:522-524)."""
    _assert(local_qubit_count >= num_targets,
            "The specified matrix targets too many qubits; the batches of "
            "amplitudes to modify cannot all fit in a single distributed "
            "node's memory allocation.", func)


def validate_num_amps_fit_type(num_qubits: int, is_density: bool, func: str) -> None:
    bits = (2 if is_density else 1) * num_qubits
    _assert(bits < 63,
            "Too many qubits (max of log2(SIZE_MAX)). Cannot store the "
            "number of amplitudes per-node in the size_t type.", func)


def validate_qureg_allocation(alloc_fn, func: str):
    """Run ``alloc_fn``, turning an allocator failure into a QuESTError
    (validateQuregAllocation, QuEST_cpu.c:1318)."""
    import torch

    try:
        return alloc_fn()
    except (MemoryError, torch.OutOfMemoryError):
        _fail("Could not allocate memory for Qureg. Possibly insufficient "
              "memory.", func)
