"""Pauli-sum Hamiltonians for the adjoint gradient (``quest_tpu/gradients/expectation.py``).

The adjoint sweep (:mod:`.adjoint`) needs the Hamiltonian in two forms:

- a static ``(codes, coeffs)`` description that keys executable caches
  (``calcExpecPauliSum``'s layout: per-qubit Pauli ids 0..3, real
  coefficients), and
- the application lambda = H|psi>, the costate the backward walk drags
  through the daggered tape: each Pauli factor through the gate
  primitives on a shell register (the per-gate engine; on a sharded
  state's list of shards, the engine over shards, as the forward gates).

A sharded state is a list of shard tensors here and in :mod:`.adjoint`:
the costate is a list of the same layout.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import gates as G
from .. import matrices as M
from ..registers import Qureg
from ..validation import QuESTError

__all__ = ["hamiltonian_terms", "apply_hamiltonian", "expectation_value", "shell_of",
           "state_of"]


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


def shell_of(amps, num_qubits: int) -> Qureg:
    """A bare state-vector register around a state tensor, or around a
    sharded state's list of shards (its gates then go through the engine
    over shards)."""
    if isinstance(amps, (list, tuple)):
        return Qureg(num_qubits, False, None, env=None, shards=list(amps))
    return Qureg(num_qubits, False, amps, env=None)


def state_of(shell: Qureg):
    """The shell's state: its tensor, or its list of shards."""
    return shell.amps if shell.shards is None else list(shell.shards)


def apply_hamiltonian(amps, *, codes, coeffs, num_qubits: int):
    """lambda = H|psi> for a Pauli sum H: the accumulator plus one term's
    state at a time, the O(1)-state property the adjoint method exists for
    (parameter shifts replay the circuit 2P times instead). ``amps`` is a
    state tensor or a list of shards (the result then too: each shard's
    accumulation is the one-device accumulation of its amplitudes)."""
    sharded = isinstance(amps, (list, tuple))
    pieces = list(amps) if sharded else [amps]
    acc = None
    for term, c in zip(codes, coeffs):
        if any(term):
            shell = shell_of(amps, num_qubits)
            _apply_pauli_term(shell, term)
            contrib = shell.shards if sharded else [shell.amps]
        else:
            contrib = pieces
        acc = ([x * c for x in contrib] if acc is None else
               [a + x * c for a, x in zip(acc, contrib)])
    return acc if sharded else acc[0]


def expectation_value(amps, lam, chunks: int = 64) -> torch.Tensor:
    """Re<psi|lambda>: the forward value E = <psi|H|psi> when ``lam`` is
    :func:`apply_hamiltonian`'s costate.

    The order of sums is FIXED whatever the layout: ``chunks`` partial
    sums of contiguous pieces, each one sum of its own (boundaries that
    align with any power-of-two shard layout), then folded in order, one
    add at a time, as the JAX package's scan folds them. A sharded state
    (lists of shards) takes each shard's pieces on its device and folds
    them on the first: the same bits as the state on one device, where its
    shards hold the same amplitudes."""
    pieces = list(zip(amps, lam)) if isinstance(amps, (list, tuple)) else [(amps, lam)]
    m = sum(a.shape[-1] for a, _ in pieces)
    k = min(chunks, m)
    w = m // k
    dev = pieces[0][0].device
    parts = []
    for a, l in pieces:
        if a.shape[-1] % w:  # a tiny register: fewer amplitudes a shard than a chunk
            a = torch.cat([x.to(dev) for x, _ in pieces], dim=-1)
            l = torch.cat([y.to(dev) for _, y in pieces], dim=-1)
            return expectation_value(a, l, chunks)
        prod = a[0] * l[0] + a[1] * l[1]
        parts.extend(prod[i:i + w].sum().to(dev) for i in range(0, prod.shape[-1], w))
    total = torch.zeros((), dtype=parts[0].dtype, device=dev)
    for p in parts:
        total = total + p
    return total
