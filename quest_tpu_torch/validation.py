"""Input validation: the validators the ported slices call.

They cover targets and controls, unitarity of 2x2, 4x4 and N-qubit
matrices and of compact pairs, Pauli codes, outcomes and measurement
probabilities, amplitude ranges, matching registers, Kraus maps and the
channel probabilities, Pauli Hamiltonians and their files, Trotter
parameters, DiagonalOps and the phase-function family.

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


class QuESTNotPortedError(QuESTError, NotImplementedError):
    """Raised by an entry that refuses an input a later slice of the port
    takes (a register sharded over several devices where the entry runs
    on one): a QuESTError that is also a NotImplementedError."""


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
    from . import matrices
    if matrices.is_traced(alpha, beta):
        # runtime values (engine.params) live on the device: unitarity is
        # the caller's contract, and a host check would sync the device
        return
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
    return _validate_allocation(alloc_fn, "Qureg", func)


def validate_diag_op_allocation(alloc_fn, func: str):
    return _validate_allocation(alloc_fn, "DiagonalOp", func)


def _validate_allocation(alloc_fn, what: str, func: str):
    """Run ``alloc_fn``, turning an allocator failure into a QuESTError
    (validateQuregAllocation, QuEST_cpu.c:1318; DiagonalOp variant)."""
    import torch

    try:
        return alloc_fn()
    except (MemoryError, torch.OutOfMemoryError):
        _fail(f"Could not allocate memory for {what}. Possibly insufficient "
              "memory.", func)


# ---------------------------------------------------------------------------
# the operators slice: Trotter parameters, DiagonalOp, phase functions
# ---------------------------------------------------------------------------

def validate_trotter_params(order: int, reps: int, func: str) -> None:
    _assert(
        order > 0 and (order == 1 or order % 2 == 0),
        "Invalid Trotter-Suzuki order. Must be 1, or an even number.",
        func,
    )
    _assert(reps > 0, "Invalid number of Trotter repetitions. Must be >=1.", func)


def validate_diag_op_fits_devices(num_qubits: int, num_devices: int,
                                  func: str) -> None:
    _assert((1 << num_qubits) >= num_devices,
            "Too few qubits. The created DiagonalOp must contain at least "
            "one element per node used in distributed simulation.", func)


def validate_diag_op_init(op, func: str) -> None:
    # a DiagonalOp holds its elements as one tensor or as shards
    _assert(getattr(op, "elems", None) is not None
            or getattr(op, "shards", None) is not None,
            "The diagonal operator has not been initialised through "
            "createDiagonalOperator().", func)


def validate_diag_op_matches_qureg(qureg, op, func: str) -> None:
    _assert(
        op.num_qubits == qureg.num_qubits_represented,
        "The DiagonalOp must act on the same number of qubits as the register.",
        func,
    )


def validate_hamil_matches_diag_op(hamil, op, func: str) -> None:
    _assert(hamil.num_qubits == op.num_qubits,
            "The Pauli Hamiltonian and diagonal operator have different, "
            "incompatible dimensions.", func)


def validate_diag_pauli_hamil(hamil, func: str) -> None:
    """validateDiagPauliHamil (E_PAULI_HAMIL_NOT_DIAGONAL): only I and Z
    terms are expressible as a diagonal operator."""
    codes = np.asarray(hamil.pauli_codes).ravel()
    _assert(bool(np.all((codes == 0) | (codes == 3))),
            "The Pauli Hamiltonian contained operators other than PAULI_Z "
            "and PAULI_I, and hence cannot be expressed as a diagonal matrix.",
            func)


def validate_num_elems(op, start: int, num: int, func: str) -> None:
    total = 2 ** op.num_qubits
    _assert(0 <= start < total, "Invalid element index.", func)
    _assert(num >= 0 and start + num <= total, "Invalid number of elements.", func)


#: parameter count accepted by each named phase function (enum phaseFunc);
#: negative: depends on the number of sub-registers
#: (validate_num_named_phase_func_params)
_PHASE_FUNC_NUM_PARAMS = {
    0: 0, 1: 1, 2: 1, 3: 2,           # NORM, SCALED_NORM, INVERSE_NORM, SCALED_INVERSE_NORM
    4: -1,                            # SCALED_INVERSE_SHIFTED_NORM
    5: 0, 6: 1, 7: 1, 8: 2,           # PRODUCT family
    9: 0, 10: 1, 11: 1, 12: 2,        # DISTANCE family
    13: -2,                           # SCALED_INVERSE_SHIFTED_DISTANCE
    14: -3,                           # SCALED_INVERSE_SHIFTED_WEIGHTED_DISTANCE
}
_DISTANCE_FUNCS = frozenset((9, 10, 11, 12, 13, 14))


def encoded_range(num_qubits: int, encoding) -> tuple[int, int]:
    """Representable value range of a sub-register under an encoding
    (0 = UNSIGNED, 1 = TWOS_COMPLEMENT, as enum bitEncoding)."""
    if int(encoding) == 0:
        return 0, 2 ** num_qubits - 1
    return -(2 ** (num_qubits - 1)), 2 ** (num_qubits - 1) - 1


def validate_num_subregisters(num_regs: int, func: str) -> None:
    _assert(0 < num_regs <= 100,
            "Invalid number of qubit subregisters, which must be >0 and <=100.",
            func)


def validate_bit_encoding(encoding, func: str) -> None:
    _assert(int(encoding) in (0, 1),
            "Invalid bit encoding. Must be one of {UNSIGNED, TWOS_COMPLEMENT}.",
            func)


def validate_multi_reg_bit_encoding(reg_sizes, encoding, func: str) -> None:
    validate_bit_encoding(encoding, func)
    if int(encoding) == 1:
        for m in reg_sizes:
            _assert(m > 1,
                    "A sub-register contained too few qubits to employ "
                    "TWOS_COMPLEMENT encoding. Must use >1 qubits "
                    "(allocating one for the sign).", func)


def validate_phase_func_terms(num_qubits: int, encoding, coeffs, exponents,
                              override_inds, num_overrides, func: str) -> None:
    """validatePhaseFuncTerms: single-variable exponent guards -- negative
    exponents diverge at index 0 unless overridden; fractional exponents in
    TWOS_COMPLEMENT produce complex phases at negative indices unless every
    negative index is overridden."""
    _assert(len(coeffs) > 0 and len(coeffs) == len(exponents),
            "Invalid number of terms in the phase function specified. Must be >0.",
            func)
    has_neg = any(e < 0 for e in exponents)
    has_frac = any(float(e) != int(e) for e in exponents)
    if has_neg:
        zero_overridden = any(int(i) == 0 for i in override_inds[:num_overrides])
        _assert(zero_overridden,
                "The phase function contained a negative exponent which would "
                "diverge at zero, but the zero index was not overriden.", func)
    if has_frac and int(encoding) == 1:
        lo, _hi = encoded_range(num_qubits, encoding)
        overridden = {int(i) for i in override_inds[:num_overrides]}
        _assert(all(v in overridden for v in range(lo, 0)),
                "The phase function contained a fractional exponent, which in "
                "TWOS_COMPLEMENT encoding, requires all negative indices are "
                "overriden. However, one or more negative indices were not "
                "overriden.", func)


def validate_multi_var_phase_func_terms(encoding, exponents, func: str) -> None:
    """validateMultiVarPhaseFuncTerms: multi-variable functions reject
    negative and (under TWOS_COMPLEMENT) fractional exponents outright."""
    _assert(not any(e < 0 for e in exponents),
            "The phase function contained an illegal negative exponent. One "
            "must instead call applyPhaseFuncOverrides() once for each "
            "register, so that the zero index of each register is overriden, "
            "independent of the indices of all other registers.", func)
    if int(encoding) == 1:
        _assert(not any(float(e) != int(e) for e in exponents),
                "The phase function contained a fractional exponent, which is "
                "illegal in TWOS_COMPLEMENT encoding, since it cannot be "
                "(efficiently) checked that all negative indices were "
                "overriden. One must instead call applyPhaseFuncOverrides() "
                "once for each register, so that each register's negative "
                "indices can be overriden, independent of the indices of all "
                "other registers.", func)


def validate_num_phase_func_overrides(num_qubits: int, num_overrides: int,
                                      single_var: bool, func: str) -> None:
    limit = (1 << num_qubits) if single_var else None
    ok = num_overrides >= 0 and (limit is None or num_overrides <= limit)
    _assert(ok,
            "Invalid number of phase function overrides specified. Must be "
            ">=0, and for single-variable phase functions, <=2^numQubits "
            "(the maximum unique binary values of the sub-register). Note "
            "that uniqueness of overriding indices is not checked.", func)


def validate_phase_func_overrides(reg_sizes, encoding, override_inds, num_overrides,
                                  func: str) -> None:
    """Override indices are stored flat, one per register per override
    (QuEST_cpu.c:4330-4341); each must be representable by its register."""
    n_regs = len(reg_sizes)
    _assert(len(override_inds) == num_overrides * n_regs,
            "Invalid number of override indices.", func)
    for r, m in enumerate(reg_sizes):
        lo, hi = encoded_range(m, encoding)
        for i in range(num_overrides):
            _assert(lo <= int(override_inds[i * n_regs + r]) <= hi,
                    "Invalid phase function override index, not representable by the qubit sub-register.",
                    func)


def validate_phase_func_name(code, func: str) -> None:
    _assert(int(code) in _PHASE_FUNC_NUM_PARAMS,
            "Invalid named phase function, which must be one of {NORM, "
            "SCALED_NORM, INVERSE_NORM, SCALED_INVERSE_NORM, "
            "SCALED_INVERSE_SHIFTED_NORM, PRODUCT, SCALED_PRODUCT, "
            "INVERSE_PRODUCT, SCALED_INVERSE_PRODUCT, DISTANCE, "
            "SCALED_DISTANCE, INVERSE_DISTANCE, SCALED_INVERSE_DISTANCE, "
            "SCALED_INVERSE_SHIFTED_DISTANCE, "
            "SCALED_INVERSE_SHIFTED_WEIGHTED_DISTANCE}.", func)


def validate_num_regs_distance_phase_func(code, num_regs: int, func: str) -> None:
    if int(code) in _DISTANCE_FUNCS:
        _assert(num_regs % 2 == 0,
                "Phase functions DISTANCE, INVERSE_DISTANCE, SCALED_DISTANCE, "
                "SCALED_INVERSE_DISTANCE, SCALED_INVERSE_SHIFTED_DISTANCE and "
                "SCALED_INVERSE_SHIFTED_WEIGHTED_DISTANCE require a strictly "
                "even number of sub-registers.", func)


def validate_num_named_phase_func_params(code, num_regs: int, num_params: int,
                                         func: str) -> None:
    expect = _PHASE_FUNC_NUM_PARAMS[int(code)]
    if expect == -1:
        expect = 2 + num_regs
    elif expect == -2:
        expect = 2 + num_regs // 2
    elif expect == -3:
        expect = 2 + num_regs
    _assert(num_params == expect,
            "Invalid number of parameters passed for the given named phase "
            "function.", func)
