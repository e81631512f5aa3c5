"""Diagonal and phase-only kernels: no data movement, one elementwise pass.

The per-amplitude factor is computed from flat-index bits and gathered from
the 2^t-entry diagonal table or, for parity phases, from a 2-entry phase
table indexed by the XOR of the member bits (the reference's mask-parity
kernels, ``QuEST_cpu.c:3113,3235-3285``; the same formulation as
``quest_tpu/ops/diagonal.py``).
"""

from __future__ import annotations

import math

import torch


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
    from a 2-entry table. ``conj`` negates theta."""
    del n
    theta = -float(theta) if conj else float(theta)
    idx = _index(amps.shape[-1], amps.device)
    par = torch.zeros_like(idx)
    for q in qubits:
        par ^= (idx >> q) & 1
    c, s = math.cos(theta / 2), math.sin(theta / 2)
    tr = torch.tensor([c, c], dtype=amps.dtype, device=amps.device)
    ti = torch.tensor([-s, s], dtype=amps.dtype, device=amps.device)
    return _apply_factor(amps, tr[par], ti[par], _ctrl_ok(idx, controls))
