"""Pauli-sum Hamiltonians for the adjoint gradient (``quest_tpu/gradients/expectation.py``).

The adjoint sweep (:mod:`.adjoint`) needs the Hamiltonian in two forms:

- a static ``(codes, coeffs)`` description that keys executable caches
  (``calcExpecPauliSum``'s layout: per-qubit Pauli ids 0..3, real
  coefficients), and
- the application lambda = H|psi>, the costate the backward walk drags
  through the daggered tape: each Pauli factor through the gate
  primitives on a shell register (the per-gate engine).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import gates as G
from .. import matrices as M
from ..registers import Qureg
from ..validation import QuESTError

__all__ = ["hamiltonian_terms", "apply_hamiltonian", "expectation_value"]


def hamiltonian_terms(hamiltonian, num_qubits: int):
    """A Hamiltonian spec as static ``(codes, coeffs)`` tuples.

    Accepts a :class:`~quest_tpu_torch.PauliHamil` or a ``(pauli_codes,
    term_coeffs)`` pair in ``calcExpecPauliSum``'s layout (codes flat or
    (terms, qubits)-shaped, ids 0..3). Rows narrower than the register are
    padded with identities on the high qubits. The result is hashable: it
    keys the cached gradient reduce beside the tape's structure."""
    from ..datatypes import PauliHamil

    if isinstance(hamiltonian, PauliHamil):
        codes, coeffs = hamiltonian.pauli_codes, hamiltonian.term_coeffs
    else:
        try:
            codes, coeffs = hamiltonian
        except (TypeError, ValueError):
            raise QuESTError("hamiltonian must be a PauliHamil or a (pauli_codes, "
                             "term_coeffs) pair", "gradient") from None
    coeffs = np.asarray(coeffs, dtype=np.float64).reshape(-1)
    if coeffs.size == 0:
        raise QuESTError("hamiltonian has no terms", "gradient")
    if not np.all(np.isfinite(coeffs)):
        raise QuESTError("hamiltonian coefficients must be finite reals", "gradient")
    codes = np.asarray(codes, dtype=np.int64).reshape(coeffs.size, -1)
    if codes.shape[1] > num_qubits:
        raise QuESTError(f"hamiltonian acts on {codes.shape[1]} qubits but the register "
                         f"has {num_qubits}", "gradient")
    if codes.shape[1] < num_qubits:
        pad = np.zeros((coeffs.size, num_qubits - codes.shape[1]), np.int64)
        codes = np.concatenate([codes, pad], axis=1)
    if codes.min() < 0 or codes.max() > 3:
        raise QuESTError("Pauli codes must be in 0..3", "gradient")
    return (tuple(tuple(int(c) for c in row) for row in codes),
            tuple(float(c) for c in coeffs))


def _apply_pauli_term(shell: Qureg, term) -> None:
    """One Pauli string (per-qubit ids) through the gate primitives."""
    for t, p in enumerate(term):
        if p == 1:
            G._apply_gate_x(shell, (t,))
        elif p == 2:
            G._apply_gate_matrix(shell, M.PAULI_Y_M, (t,))
        elif p == 3:
            G._apply_gate_diag(shell, np.array([1.0, -1.0]), (t,))


def apply_hamiltonian(amps: torch.Tensor, *, codes, coeffs, num_qubits: int) -> torch.Tensor:
    """lambda = H|psi> for a Pauli sum H: the accumulator plus one term's
    state at a time, the O(1)-state property the adjoint method exists for
    (parameter shifts replay the circuit 2P times instead)."""
    acc = None
    for term, c in zip(codes, coeffs):
        if any(term):
            shell = Qureg(num_qubits, False, amps, env=None)
            _apply_pauli_term(shell, term)
            contrib = shell.amps
        else:
            contrib = amps
        acc = contrib * c if acc is None else acc + contrib * c
    return acc


def expectation_value(amps: torch.Tensor, lam: torch.Tensor, chunks: int = 64) -> torch.Tensor:
    """Re<psi|lambda>: the forward value E = <psi|H|psi> when ``lam`` is
    :func:`apply_hamiltonian`'s costate.

    The order of sums is FIXED whatever the layout: ``chunks`` partial
    sums of contiguous pieces (boundaries that align with any power-of-two
    shard layout), then folded in order, one add at a time, as the JAX
    package's scan folds them."""
    prod = amps[0] * lam[0] + amps[1] * lam[1]
    m = prod.shape[-1]
    k = min(chunks, m)
    part = prod.reshape(k, m // k).sum(dim=1)
    total = torch.zeros((), dtype=prod.dtype, device=prod.device)
    for i in range(k):
        total = total + part[i]
    return total
