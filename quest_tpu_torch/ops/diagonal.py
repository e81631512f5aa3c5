"""Diagonal and phase-only kernels: no data movement, one elementwise pass.
The full 2^n diagonal of a ``DiagonalOp`` multiplies elementwise.

The per-amplitude factor is computed from flat-index bits and gathered from
the 2^t-entry diagonal table or, for parity phases, from a 2-entry phase
table indexed by the XOR of the member bits (the reference's mask-parity
kernels, ``QuEST_cpu.c:3113,3235-3285``; the same formulation as
``quest_tpu/ops/diagonal.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._capture import to_device


def _index(num: int, device) -> torch.Tensor:
    return torch.arange(num, device=device)


def _ctrl_ok(idx: torch.Tensor, controls) -> torch.Tensor | None:
    sel = None
    for c in controls:
        b = (idx >> c) & 1
        sel = b if sel is None else sel & b
    return sel


def _apply_factor(amps, fr, fi, ok):
    if ok is not None:
        okf = ok.to(amps.dtype)
        fr = 1 + okf * (fr - 1)
        fi = okf * fi
    re = amps[0] * fr - amps[1] * fi
    im = amps[0] * fi + amps[1] * fr
    return torch.stack([re, im])


def apply_diagonal(amps: torch.Tensor, diag: torch.Tensor, *, n: int,
                   targets: tuple, controls: tuple = (),
                   conj: bool = False) -> torch.Tensor:
    """Multiply by a planar (2, 2^t) diagonal on ``targets`` (controls gate
    it to the all-1 subspace); targets[0] is the least-significant bit of
    the diagonal's index."""
    del n
    idx = _index(amps.shape[-1], amps.device)
    sel = torch.zeros_like(idx)
    for k, q in enumerate(targets):
        sel |= ((idx >> q) & 1) << k
    d = diag.to(amps.dtype)
    fr = d[0][sel]
    fi = d[1][sel]
    if conj:
        fi = -fi
    return _apply_factor(amps, fr, fi, _ctrl_ok(idx, controls))


def apply_parity_phase(amps: torch.Tensor, theta: float, *, n: int,
                       qubits: tuple, controls: tuple = (),
                       conj: bool = False) -> torch.Tensor:
    """exp(-i theta/2 * Z x Z x ... x Z) on ``qubits``: the factor is
    cos(theta/2) - i sin(theta/2) (-1)^{parity of the member bits}, gathered
    from a 2-entry table. ``conj`` negates theta. A tensor theta (a
    runtime value, ``engine.params``) builds the table on its device; a
    number's table is staged (``_capture.to_device``)."""
    del n
    idx = _index(amps.shape[-1], amps.device)
    par = torch.zeros_like(idx)
    for q in qubits:
        par ^= (idx >> q) & 1
    if isinstance(theta, torch.Tensor):
        theta = -theta if conj else theta
        c, s = torch.cos(theta / 2), torch.sin(theta / 2)
        tab = torch.stack([torch.stack([c, c]), torch.stack([-s, s])]).to(
            device=amps.device, dtype=amps.dtype)
    else:
        theta = -float(theta) if conj else float(theta)
        c, s = math.cos(theta / 2), math.sin(theta / 2)
        tab = to_device(np.array([[c, c], [-s, s]]), amps.dtype, amps.device)
    tr, ti = tab[0], tab[1]
    return _apply_factor(amps, tr[par], ti[par], _ctrl_ok(idx, controls))


def apply_full_diagonal(amps: torch.Tensor, elems: torch.Tensor) -> torch.Tensor:
    """Elementwise multiply by a full planar diagonal operator of the same
    length (applyDiagonalOp; reference kernel ``QuEST_cpu.c:3975-4030``):
    on one device, or shard by shard with ``elems`` cut as ``amps``."""
    er, ei = elems[0].to(amps.dtype), elems[1].to(amps.dtype)
    re = amps[0] * er - amps[1] * ei
    im = amps[0] * ei + amps[1] * er
    return torch.stack([re, im])


def apply_full_diagonal_to_density(amps: torch.Tensor, elems: torch.Tensor, *,
                                   n: int) -> torch.Tensor:
    """applyDiagonalOp on a density matrix: rho -> D rho (left-multiply
    only, per the reference's densmatr_applyDiagonalOp). Row bits are the
    low n bits of the 2n-qubit flattening, so D broadcasts along the
    column axis."""
    dim = 1 << n
    t = amps.reshape(2, dim, dim)  # [plane, col, row]
    er, ei = elems[0].to(amps.dtype)[None, :], elems[1].to(amps.dtype)[None, :]
    re = t[0] * er - t[1] * ei
    im = t[0] * ei + t[1] * er
    return torch.stack([re, im]).reshape(2, -1)


def apply_full_diagonal_to_density_shards(shards, elems: torch.Tensor, *, n: int) -> list:
    """:func:`apply_full_diagonal_to_density` shard by shard: ``elems``
    (2, 2^n) indexed by the row bits, the low n of the flat index, so a
    shard holding whole columns takes every row's factor once a column;
    a tiny register with less than a column a shard takes the factors of
    its rows."""
    dim, c = 1 << n, shards[0].shape[-1]
    out = []
    for r, s in enumerate(shards):
        e = elems.to(device=s.device, dtype=s.dtype)
        if c % dim == 0:
            out.append(_rows_times(s.reshape(2, c // dim, dim), e).reshape(2, -1))
        else:
            rows = torch.arange(r * c, (r + 1) * c, device=s.device) % dim
            out.append(apply_full_diagonal(s, e[:, rows]))
    return out


def _rows_times(t: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """(2, cols, rows) planar ``t`` times the row factors ``e`` (2, rows)."""
    er, ei = e[0][None, :], e[1][None, :]
    return torch.stack([t[0] * er - t[1] * ei, t[0] * ei + t[1] * er])


def pauli_z_diagonal(codes, coeffs, *, offset: int, size: int, device) -> torch.Tensor:
    """Elements [offset, offset + size) of the diagonal of sum_t c_t P_t, a
    Hamiltonian of I and Z terms only, in float64 on ``device``
    (initDiagonalOpFromPauliHamil): each term adds c_t (-1)^(parity of
    the index's Z bits), in term order, as the JAX package adds them on
    the host."""
    idx = torch.arange(offset, offset + size, device=device)
    diag = torch.zeros(size, dtype=torch.float64, device=device)
    for row_codes, coeff in zip(codes, coeffs):
        sign = torch.ones(size, dtype=torch.float64, device=device)
        for q, code in enumerate(row_codes):
            if int(code) == 3:
                sign *= 1.0 - 2.0 * ((idx >> q) & 1)
        diag += float(coeff) * sign
    return diag
