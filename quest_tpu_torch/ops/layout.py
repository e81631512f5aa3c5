"""Amplitude-index layout algebra.

Convention (identical to the reference): qubit q is bit q of the flat
amplitude index, qubit 0 the least-significant bit
(``QuEST_cpu_internal.h:26-53``).

For an operation touching qubits Q = {q1 > q2 > ... > qk}, the flat state is
viewed at rank <= 2k+1: each touched qubit is its own 2-sized axis and the
untouched index segments between them stay fused::

    shape = (2^(n-1-q1), 2, 2^(q1-1-q2), 2, ..., 2, 2^qk)
"""

from __future__ import annotations

from typing import Sequence


def grouped_shape(n: int, qubits_desc: Sequence[int]) -> tuple[int, ...]:
    """Shape with one 2-sized axis per qubit in ``qubits_desc`` (strictly
    descending) and fused segments elsewhere. Product is always 2^n."""
    dims = []
    prev = n
    for q in qubits_desc:
        dims.append(1 << (prev - 1 - q))
        dims.append(2)
        prev = q
    dims.append(1 << prev)
    return tuple(dims)


def grouped_axes(n: int, qubits: Sequence[int]) -> tuple[tuple[int, ...], dict[int, int]]:
    """(shape, {qubit: axis}) for the grouped view over ``qubits`` (any order)."""
    qs = sorted(set(qubits), reverse=True)
    shape = grouped_shape(n, qs)
    axis_of = {q: 2 * i + 1 for i, q in enumerate(qs)}
    return shape, axis_of


def inverse_permutation(perm: Sequence[int]) -> tuple[int, ...]:
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return tuple(inv)
