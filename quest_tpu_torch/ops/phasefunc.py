"""The phase-function family (``quest_tpu/ops/phasefunc.py``; reference
``QuEST_cpu.c:4196-4541``: applyPhaseFunc / MultiVar / Named /
ParamNamed, each with overrides and two's-complement encoding).

As in the JAX package, the flat 2^n index is viewed as a (2^h, 2^l) grid
(l = n // 2, h = n - l): every sub-register value is a separable sum of
per-qubit bit contributions, a 2^h vector over the rows plus a 2^l vector
over the columns, and the phase is built on the grid by broadcasting
them. Every intermediate is in the amplitude dtype, with the same split,
term order and branches as the JAX package, so the two agree to rounding
(in f32, register values past 2^24 round in the sum ``hi + lo`` in both).

A piece of the state (a shard, ``offset`` its first flat index) takes the
rows of the grid it covers (one row's columns when it is shorter than a
row): its phases are the one-device grid's, element for element. The
``conj`` flag (the density conj-shadow) negates the phase.
"""

from __future__ import annotations

import numpy as np
import torch

from .._capture import to_device
from ..datatypes import phaseFunc

#: sentinel divergence parameters match the reference kernel defaults
REAL_EPS_F32 = 1e-5
REAL_EPS_F64 = 1e-13


def _split(n: int) -> tuple[int, int]:
    l = n // 2
    return n - l, l


def _reg_ind_vectors(n: int, reg_qubits, encoding: int, rdtype, device):
    """(hi_vec, lo_vec) whose broadcast sum is the register's encoded value at
    every amplitude index. reg_qubits[0] is the least-significant bit; under
    TWOS_COMPLEMENT the last qubit contributes -2^(m-1) (QuEST_cpu.c:4236-4243)."""
    h, l = _split(n)
    hi = torch.arange(1 << h, device=device)
    lo = torch.arange(1 << l, device=device)
    hi_v = torch.zeros(1 << h, dtype=rdtype, device=device)
    lo_v = torch.zeros(1 << l, dtype=rdtype, device=device)
    m = len(reg_qubits)
    for j, q in enumerate(reg_qubits):
        weight = float(1 << j)
        if encoding == 1 and j == m - 1:
            weight = -float(1 << (m - 1))
        if q < l:
            lo_v = lo_v + ((lo >> q) & 1).to(rdtype) * weight
        else:
            hi_v = hi_v + ((hi >> (q - l)) & 1).to(rdtype) * weight
    return hi_v, lo_v


def _piece_grid(n: int, offset: int, size: int) -> tuple[slice, slice]:
    """(rows, columns) of the (2^h, 2^l) grid that the flat indices
    [offset, offset + size) cover: whole rows, or part of one row."""
    _, l = _split(n)
    if size >= 1 << l:
        return slice(offset >> l, (offset + size) >> l), slice(None)
    col = offset & ((1 << l) - 1)
    return slice(offset >> l, (offset >> l) + 1), slice(col, col + size)


def _reg_inds(amps, n, offset, qubits, reg_sizes, encoding):
    """Each register's (hi, lo) vectors, cut to the piece's rows and columns."""
    rows, cols = _piece_grid(n, offset, amps.shape[-1])
    out, off = [], 0
    for m in reg_sizes:
        hi_v, lo_v = _reg_ind_vectors(n, qubits[off:off + m], encoding, amps.dtype,
                                      amps.device)
        out.append((hi_v[rows], lo_v[cols]))
        off += m
    return out


def _values(x, amps) -> torch.Tensor:
    """A host sequence as a tensor of the amplitude dtype on their device
    (staged: ``_capture.to_device``)."""
    return to_device(np.asarray(x, dtype=np.float64).reshape(-1), amps.dtype, amps.device)


def _phase_to_factor(amps, phase2d):
    """amps (2, R L) planar times e^{i phase} over the piece's (R, L) grid."""
    fr = torch.cos(phase2d)
    fi = torch.sin(phase2d)
    t = amps.reshape(2, phase2d.shape[0], phase2d.shape[1])
    re = t[0] * fr - t[1] * fi
    im = t[0] * fi + t[1] * fr
    return torch.stack([re, im]).reshape(2, -1)


def _apply_overrides(phase, reg_inds, override_inds, override_phases):
    """First-match-wins override semantics (QuEST_cpu.c:4245-4254): iterate in
    reverse so earlier entries overwrite later ones."""
    num_regs = len(reg_inds)
    for i in reversed(range(override_phases.shape[0])):
        match = None
        for r in range(num_regs):
            hi_v, lo_v = reg_inds[r]
            cond = (hi_v[:, None] + lo_v[None, :]) == override_inds[i * num_regs + r]
            match = cond if match is None else (match & cond)
        phase = torch.where(match, override_phases[i], phase)
    return phase


def apply_poly_phase(amps, coeffs, override_inds, override_phases, *,
                     n: int, reg_sizes: tuple, qubits: tuple, encoding: int,
                     exponents: tuple, num_terms_per_reg: tuple,
                     conj: bool, offset: int = 0) -> torch.Tensor:
    """applyPhaseFunc / applyMultiVarPhaseFunc (+Overrides): phase(i) =
    sum_r sum_t coeff[r,t] * ind_r(i)^exp[r,t] (QuEST_cpu.c:4196-4372), on
    the planar piece ``amps`` of an n-qubit state whose first flat index
    is ``offset``. ``qubits`` is the flat concatenation of the registers'
    qubits (``reg_sizes`` the partition); ``coeffs``, ``override_inds`` and
    ``override_phases`` are host sequences, cast to the amplitude dtype.
    Returns a new tensor."""
    reg_inds = _reg_inds(amps, n, offset, qubits, reg_sizes, int(encoding))
    coeffs = _values(coeffs, amps)
    hi0, lo0 = reg_inds[0]
    phase = torch.zeros((hi0.shape[0], lo0.shape[0]), dtype=amps.dtype, device=amps.device)
    flat = 0
    for r in range(len(reg_sizes)):
        hi_v, lo_v = reg_inds[r]
        ind = hi_v[:, None] + lo_v[None, :]
        for _ in range(num_terms_per_reg[r]):
            e = exponents[flat]
            c = coeffs[flat]
            if e == 0.0:
                term = c * torch.ones_like(ind)
            elif float(e).is_integer() and 0 < e <= 8:
                p = ind
                for _k in range(int(e) - 1):
                    p = p * ind
                term = c * p
            else:
                term = c * torch.pow(ind, to_device(np.asarray(e, dtype=np.float64),
                                                    amps.dtype, amps.device))
            phase = phase + term
            flat += 1
    if len(override_phases):
        phase = _apply_overrides(phase, reg_inds, _values(override_inds, amps),
                                 _values(override_phases, amps))
    if conj:
        phase = -phase
    return _phase_to_factor(amps, phase)


def apply_named_phase(amps, params, override_inds, override_phases, *,
                      n: int, reg_sizes: tuple, qubits: tuple, encoding: int,
                      func_name: int, conj: bool, offset: int = 0) -> torch.Tensor:
    """applyNamedPhaseFunc / applyParamNamedPhaseFunc (+Overrides)
    (QuEST_cpu.c:4374-4541) on the piece ``amps`` (as
    :func:`apply_poly_phase`); ``params`` padded by the caller so that
    every indexed read is in range. Semantics mirrored exactly, the
    divergence parameters and the shifted/weighted variants included."""
    rdtype = amps.dtype
    eps = REAL_EPS_F64 if rdtype == torch.float64 else REAL_EPS_F32
    fn = phaseFunc(func_name)
    reg_inds = _reg_inds(amps, n, offset, qubits, reg_sizes, int(encoding))
    num_regs = len(reg_sizes)
    params = _values(params, amps)
    shape = (reg_inds[0][0].shape[0], reg_inds[0][1].shape[0])

    def ind(r):
        hi_v, lo_v = reg_inds[r]
        return hi_v[:, None] + lo_v[None, :]

    def param(i):
        return params[i]

    def where_nonzero(x, zero_val, num, at_zero):
        """``zero_val`` where ``at_zero``, else num / x (x taken as 1 there)."""
        return torch.where(at_zero, zero_val, num / torch.where(at_zero, torch.ones_like(x), x))

    P = phaseFunc
    if fn in (P.NORM, P.INVERSE_NORM, P.SCALED_NORM, P.SCALED_INVERSE_NORM,
              P.SCALED_INVERSE_SHIFTED_NORM):
        norm2 = torch.zeros(shape, dtype=rdtype, device=amps.device)
        for r in range(num_regs):
            x = ind(r)
            if fn == P.SCALED_INVERSE_SHIFTED_NORM:
                x = x - param(2 + r)
            norm2 = norm2 + x * x
        norm = torch.sqrt(norm2)
        if fn == P.NORM:
            phase = norm
        elif fn == P.INVERSE_NORM:
            phase = where_nonzero(norm, param(0), 1, norm == 0)
        elif fn == P.SCALED_NORM:
            phase = param(0) * norm
        else:  # SCALED_INVERSE_NORM, SCALED_INVERSE_SHIFTED_NORM
            phase = where_nonzero(norm, param(1), param(0), norm <= eps)
    elif fn in (P.PRODUCT, P.INVERSE_PRODUCT, P.SCALED_PRODUCT, P.SCALED_INVERSE_PRODUCT):
        prod = torch.ones(shape, dtype=rdtype, device=amps.device)
        for r in range(num_regs):
            prod = prod * ind(r)
        if fn == P.PRODUCT:
            phase = prod
        elif fn == P.INVERSE_PRODUCT:
            phase = where_nonzero(prod, param(0), 1, prod == 0)
        elif fn == P.SCALED_PRODUCT:
            phase = param(0) * prod
        else:
            phase = where_nonzero(prod, param(1), param(0), prod == 0)
    else:  # distance family; registers paired (r, r+1)
        dist2 = torch.zeros(shape, dtype=rdtype, device=amps.device)
        for r in range(0, num_regs, 2):
            if fn == P.SCALED_INVERSE_SHIFTED_DISTANCE:
                d = ind(r) - ind(r + 1) - param(2 + r // 2)
            elif fn == P.SCALED_INVERSE_SHIFTED_WEIGHTED_DISTANCE:
                d = ind(r) - ind(r + 1) - param(2 + r + 1)
                dist2 = dist2 + param(2 + r) * d * d
                continue
            else:
                d = ind(r + 1) - ind(r)
            dist2 = dist2 + d * d
        dist2 = torch.clamp_min(dist2, 0)  # reference clamps negative (weighted case)
        dist = torch.sqrt(dist2)
        if fn == P.DISTANCE:
            phase = dist
        elif fn == P.INVERSE_DISTANCE:
            phase = where_nonzero(dist, param(0), 1, dist == 0)
        elif fn == P.SCALED_DISTANCE:
            phase = param(0) * dist
        else:  # SCALED_INVERSE_(SHIFTED_(WEIGHTED_))DISTANCE
            phase = where_nonzero(dist, param(1), param(0), dist <= eps)

    if len(override_phases):
        phase = _apply_overrides(phase, reg_inds, _values(override_inds, amps),
                                 _values(override_phases, amps))
    if conj:
        phase = -phase
    return _phase_to_factor(amps, phase)


def apply_phase_shards(apply, shards, *args, **kwargs) -> list:
    """``apply`` (:func:`apply_poly_phase` or :func:`apply_named_phase`) on
    each shard of a sharded state vector, on its device, with its offset:
    no communication, whatever the qubits."""
    c = shards[0].shape[-1]
    return [apply(s, *args, offset=r * c, **kwargs) for r, s in enumerate(shards)]
