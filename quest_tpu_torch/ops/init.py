"""State initialisation (reference: ``QuEST_cpu.c:1416-1680`` init family)
and the weighted sum of registers.

Each ``init_*`` function returns a fresh planar (2, num_amps) tensor on
``device``; each ``shards_*`` function the shards of the same state over
``devices`` (shard r, the amplitudes [r C, (r+1) C), C = num_amps / D,
built on devices[r]: no full state is built anywhere).
"""

from __future__ import annotations

import math

import torch


def init_blank(num_amps: int, dtype: torch.dtype, device) -> torch.Tensor:
    """All-zero (unnormalised) state -- initBlankState."""
    return torch.zeros((2, num_amps), dtype=dtype, device=device)


def init_classical(num_amps: int, dtype: torch.dtype, device,
                   index: int = 0) -> torch.Tensor:
    """|index> one-hot -- initClassicalState / initZeroState (index=0)."""
    amps = torch.zeros((2, num_amps), dtype=dtype, device=device)
    amps[0, index] = 1
    return amps


def init_plus(num_amps: int, dtype: torch.dtype, device) -> torch.Tensor:
    """Uniform superposition -- initPlusState."""
    amps = torch.zeros((2, num_amps), dtype=dtype, device=device)
    amps[0].fill_(1.0 / math.sqrt(num_amps))
    return amps


def init_debug(num_amps: int, dtype: torch.dtype, device) -> torch.Tensor:
    """amp_i = (2i + (2i+1) j)/10 -- initDebugState, the test fixture
    (statevec_initDebugState, QuEST_cpu.c:1649-1680)."""
    i = torch.arange(num_amps, dtype=dtype, device=device)
    return torch.stack([(2 * i) / 10, (2 * i + 1) / 10])


def shards_blank(num_amps: int, dtype: torch.dtype, devices) -> list:
    """All-zero shards -- initBlankState."""
    c = num_amps // len(devices)
    return [torch.zeros((2, c), dtype=dtype, device=d) for d in devices]


def shards_classical(num_amps: int, dtype: torch.dtype, devices,
                     index: int = 0) -> list:
    """|index> over the shards: a one in shard index // C."""
    out = shards_blank(num_amps, dtype, devices)
    c = num_amps // len(devices)
    out[index // c][0, index % c] = 1
    return out


def shards_plus(num_amps: int, dtype: torch.dtype, devices) -> list:
    """Uniform superposition over the shards -- initPlusState."""
    out = shards_blank(num_amps, dtype, devices)
    for s in out:
        s[0].fill_(1.0 / math.sqrt(num_amps))
    return out


def shards_debug(num_amps: int, dtype: torch.dtype, devices) -> list:
    """initDebugState over the shards: shard r computes its own indices."""
    c = num_amps // len(devices)
    out = []
    for r, d in enumerate(devices):
        i = torch.arange(r * c, (r + 1) * c, dtype=dtype, device=d)
        out.append(torch.stack([(2 * i) / 10, (2 * i + 1) / 10]))
    return out


def density_from_pure(pure_amps: torch.Tensor) -> torch.Tensor:
    """rho = |psi><psi| flattened with row bits low (initPureState;
    densmatr_initPureState, QuEST_cpu_distributed.c:387-429). Flat index =
    col * 2^n + row, element = psi_row * conj(psi_col)."""
    pr, pi = pure_amps[0], pure_amps[1]
    # out[c, r] = psi_r * conj(psi_c)
    re = pr[:, None] * pr[None, :] + pi[:, None] * pi[None, :]
    im = pr[:, None] * pi[None, :] - pi[:, None] * pr[None, :]
    return torch.stack([re, im]).reshape(2, -1)


def density_shards_from_pure(pure_amps: torch.Tensor, devices, dtype) -> list:
    """:func:`density_from_pure` cut into shards on ``devices``: shard r the
    flat indices [r C, (r+1) C). While the mesh has at most 2^n devices a
    shard is whole columns, built on its device from the whole state (the
    rows) and its columns' amplitudes, element for element as the
    one-device product; a tiny register is built whole and cut."""
    dim = pure_amps.shape[-1]
    c = dim * dim // len(devices)
    if c % dim:
        whole = density_from_pure(pure_amps.to(dtype))
        return [whole[:, r * c:(r + 1) * c].to(d) for r, d in enumerate(devices)]
    m = c // dim
    out = []
    for r, d in enumerate(devices):
        p = pure_amps.to(device=d, dtype=dtype)
        pr, pi = p[0], p[1]
        cr, ci = pr[r * m:(r + 1) * m], pi[r * m:(r + 1) * m]
        re = cr[:, None] * pr[None, :] + ci[:, None] * pi[None, :]
        im = cr[:, None] * pi[None, :] - ci[:, None] * pr[None, :]
        out.append(torch.stack([re, im]).reshape(2, -1))
    return out


def density_init_classical(num_amps: int, dtype: torch.dtype, device,
                           index: int) -> torch.Tensor:
    """rho = |s><s|: a single 1 at the diagonal flat index s * (2^n + 1)."""
    dim = math.isqrt(num_amps)
    amps = torch.zeros((2, num_amps), dtype=dtype, device=device)
    amps[0, index * (dim + 1)] = 1
    return amps


def density_init_plus(num_amps: int, dtype: torch.dtype, device) -> torch.Tensor:
    """rho = |+><+| on n qubits: every element 1/2^n."""
    amps = torch.zeros((2, num_amps), dtype=dtype, device=device)
    amps[0].fill_(1.0 / math.isqrt(num_amps))
    return amps


def weighted_sum(f1: complex, amps1: torch.Tensor, f2: complex, amps2: torch.Tensor,
                 fo: complex, amps_out: torch.Tensor) -> torch.Tensor:
    """f1*q1 + f2*q2 + fo*out with complex factors, planar in and out --
    setWeightedQureg (QuEST_cpu.c:3933)."""
    def term(f, a):
        f = complex(f)
        return torch.stack([f.real * a[0] - f.imag * a[1],
                            f.real * a[1] + f.imag * a[0]])
    return term(f1, amps1) + term(f2, amps2) + term(fo, amps_out)


def density_from_pauli_hamil(codes, coeffs, *, n: int, dtype: torch.dtype,
                             device) -> torch.Tensor:
    """rho = sum_t c_t P_t as a dense n-qubit density matrix, flattened
    [col, row] (element rho[r, c] at c 2^n + r), built on ``device``
    (setQuregToPauliHamil; densmatr_setQuregToPauliHamil).

    A Pauli string has one non-zero per column c, at row c ^ f (f the mask
    of its X and Y qubits), worth i^(number of Y) (-1)^(parity of c's Y and
    Z bits). Each term adds c_t times that value into the real or the
    imaginary plane of a float64 accumulator, in term order (the sum the
    JAX package forms in complex128 on the host: the same values, the same
    order), cast to ``dtype`` at the end."""
    dim = 1 << n
    acc = torch.zeros((2, dim * dim), dtype=torch.float64, device=device)
    col = torch.arange(dim, device=device)
    for row_codes, coeff in zip(codes, coeffs):
        f = par_mask = 0
        num_y = 0
        for q, code in enumerate(row_codes):
            code = int(code)
            if code in (1, 2):
                f |= 1 << q
            if code in (2, 3):
                par_mask |= 1 << q
            num_y += code == 2
        par = torch.zeros_like(col)
        for q in range(n):
            if (par_mask >> q) & 1:
                par ^= (col >> q) & 1
        sign = (1 - 2 * par).to(torch.float64)
        # i^num_y: 1, i, -1, -i
        plane, unit = ((0, 1.0), (1, 1.0), (0, -1.0), (1, -1.0))[num_y % 4]
        acc[plane].index_add_(0, col * dim + (col ^ f), float(coeff) * unit * sign)
    return acc.to(dtype)
