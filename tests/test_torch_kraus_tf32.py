"""The f32 krausn arm of the port's fused gate run (a channel on 3 row and 3
column qubits as its 64x64 superoperator, ``csrc/fused_gates.cu``:
``krausn_mma``, 3xTF32 ``mma.sync``) modelled in numpy, against the exact
superoperator product and the JAX package's Pallas kernel
(``quest_tpu/ops/pallas_gates.py``, the kraus arm of ``_ops_body``).

The kernel cannot run here. The model walks a tile as the kernel does,
fragment by fragment, reading the coefficient block that ``encode_ops``
writes (S^T split into TF32 hi and lo in the kernel's fragment order, after
S^T real and imaginary and the f64 kernel's table): the gathered A operand
at the deposits into the qubit mask, the masked groups of small tiles, the
sweeps of 64 groups, and the 3xTF32 arithmetic (hi*hi + hi*lo + lo*hi, lo
read as TF32, each ``mma.sync`` summed onto an FP32 accumulator). Limits:
1e-5 of the largest amplitude against the exact complex128 product (the
card check's limit in ``chip_smoke.py``); ``tests/helpers.py``'s f32
tolerance, 2e-4, against the JAX kernel in interpret mode.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from quest_tpu.ops import pallas_gates as PG
from quest_tpu_torch.interop import ops_from_reference
from quest_tpu_torch.ops import fused_gates as FG

from .helpers import assert_amps_close
from .test_torch_lane_u import mma_round, tf32x3_walk
from .test_torch_kraus_dmma import (G, _bench_krausn, _bits, _deposit, _exact,
                                    _group_bases, _kraus_terms, _masks)


def _split_block(table, coeffs, i=0):
    """(S^T, the TF32 split part) of the i-th op's kraus block."""
    off = int(table[i, 6])
    st = (coeffs[off:off + G * G].reshape(G, G)
          + 1j * coeffs[off + G * G:off + 2 * G * G].reshape(G, G))
    split = coeffs[off + 4 * G * G:off + 8 * G * G]
    return st, split.reshape(4, 2, 2, G, 4, 4)


def _tf32(v):
    """v as the tensor core reads a float32 operand: its low 13 bits cleared."""
    return (np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
            & np.uint32(0xffffe000)).view(np.float32)


#: n8 tiles a warp of the f32 kernel (``kKrausN8``): a sweep is 32 N8 groups
N8 = 2


def _krausn_tf32_model(x, mask, split, three=True):
    """The f32 kernel's walk on one tile (``krausn_mma``): x (2, tile)
    float32. Groups = tile / 64, group g's values at base(g) + dep(e). In
    sweep q (one per 32 N8 groups, at least one) warp w takes the m16 tile
    of groups 32 N8 q + 16 (w % 2 N8) (idle if it starts past the tile)
    and the N8 n8 tiles of columns 8 N8 (w // 2 N8) + 8 j; lane (g, t) =
    divmod(lane, 4). k step h of step kk gives the lane the values e = 16
    kk + 8 h + t (+ 4) of its groups g and g + 8 (0 past the tile), at
    offsets summed from single mask bits as the kernel sums them, split
    into TF32 hi and lo, and its split B values of column n = g of each
    n8 tile from the host's table. Each mma.sync
    m16n8k8 is its 8 exact products summed onto its FP32 accumulator and
    rounded toward zero, as the card's tensor cores round, in the kernel's
    order: xr Sr^T, xr Si^T, xi Sr^T, xi (-Si^T), each product in the
    kernel's accumulation walk (``test_torch_lane_u.tf32x3_walk``), in
    3xTF32 or hi*hi alone. The
    C fragments go to base(group) + dep(d) for the groups in the tile.
    Returns (out, how often each amplitude was written)."""
    tile = x.shape[1]
    groups = tile >> 6
    tb = tile.bit_length() - 1
    bit = [1 << q for q in _bits(mask)]
    base = _group_bases(groups, mask, tb)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    dt = np.where(t & 1, bit[0], 0) + np.where(t & 2, bit[1], 0)
    out = x.copy()
    written = np.zeros(tile, dtype=int)

    def mma(acc, a, b):
        return mma_round(acc.astype(np.float64) + a.astype(np.float64) @ b.astype(np.float64),
                         "truncate")

    def product(acc, a, b):
        return tf32x3_walk(acc, a, b, mma, three=three)

    sweep, wm = 32 * N8, 2 * N8
    for q, warp, j8 in itertools.product(range((groups + sweep - 1) // sweep), range(16),
                                         range(N8)):
        m0, n8 = sweep * q + 16 * (warp % wm), 8 * N8 * (warp // wm) + 8 * j8
        if m0 >= groups:
            continue
        row0, row1 = m0 + g, m0 + g + 8
        ok0, ok1 = row0 < groups, row1 < groups
        a0 = np.where(ok0, base[np.minimum(row0, groups - 1)], 0) + dt
        a1 = np.where(ok1, base[np.minimum(row1, groups - 1)], 0) + dt
        accr = np.zeros((16, 8), np.float32)
        acci = np.zeros((16, 8), np.float32)
        for kk in range(4):
            dk = (bit[4] if kk & 1 else 0) + (bit[5] if kk & 2 else 0)
            for h in range(2):
                e0 = dk + (bit[3] if h else 0)
                A, B = [], []
                for p, plane in enumerate(x):
                    # a[0] = A[g][t], a[1] = A[g + 8][t], a[2] = A[g][t + 4],
                    # a[3] = A[g + 8][t + 4]: e = 16 kk + 8 h + t (+ 4)
                    m = np.zeros((16, 8), np.float32)
                    for j, off in enumerate((e0, e0 + bit[2])):
                        m[g, t + 4 * j] = np.where(ok0, plane[np.where(ok0, a0 + off, 0)], 0)
                        m[g + 8, t + 4 * j] = np.where(ok1, plane[np.where(ok1, a1 + off, 0)], 0)
                    hi, lo = FG.tf32_split(m)
                    A.append((hi, _tf32(lo)))
                    # b[0] = B[t][g], b[1] = B[t + 4][g]: the table's
                    # hi e0, hi e0 + 4, lo e0, lo e0 + 4
                    frag = split[kk, h, p, n8 + g, t].astype(np.float32)  # (32, 4)
                    bh, bl = np.zeros((8, 8), np.float32), np.zeros((8, 8), np.float32)
                    for j in range(2):
                        bh[t + 4 * j, g] = frag[:, j]
                        bl[t + 4 * j, g] = frag[:, 2 + j]
                    B.append((bh, _tf32(bl)))
                neg = (-B[1][0], -B[1][1])
                accr = product(accr, A[0], B[0])
                acci = product(acci, A[0], B[1])
                acci = product(acci, A[1], B[0])
                accr = product(accr, A[1], neg)
        # c[0] = C[g][2t], c[1] = C[g][2t+1], c[2] = C[g+8][2t], c[3] = C[g+8][2t+1]
        for e in (0, 1):
            off = _deposit(n8 + 2 * t + e, _bits(mask))
            for a, ok, r in ((a0, ok0, g), (a1, ok1, g + 8)):
                addr = (a - dt + off)[ok]
                out[0, addr] = accr[r[ok], 2 * t[ok] + e]
                out[1, addr] = acci[r[ok], 2 * t[ok] + e]
                written[addr] += 1
    return out, written


def _tile_state32(tb, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 1 << tb)
    return (x / np.linalg.norm(x)).astype(np.float32)


@pytest.mark.parametrize("kind", ["sorted", "unsorted", "interleaved"])
def test_krausn_tf32_table_matches_encode_ops(kind):
    """The kraus block of a 3-qubit op ends with ``kraus_superop_tf32_table``
    of its S^T, 16-byte aligned in float32, where ``krausn_mma`` reads it
    (after S^T real and imaginary and the f64 table); entry [kk, h, plane,
    n, t, v] is hi (v < 2) or lo (v >= 2) of S^T[16 kk + 8 h + t + 4 (v %
    2)][n] of that plane: every (e, n, hi/lo) appears once, hi + lo equals
    float32(S^T) exactly, hi has its low 13 bits clear."""
    rng = np.random.RandomState(13)
    rows, cols = _masks(12)[kind]
    terms = _kraus_terms(rng)
    table, coeffs = FG.encode_ops((("krausn", rows, cols, terms),))
    st, split = _split_block(table, coeffs)
    off = int(table[0, 6]) + 4 * G * G
    assert off % 4 == 0 and coeffs.size == off + 4 * G * G
    np.testing.assert_array_equal(split, FG.kraus_superop_tf32_table(st))
    seen = np.zeros((2, G, G), dtype=int)
    for p, w in enumerate((st.real, st.imag)):
        w32 = w.astype(np.float32)
        hi = np.zeros((G, G), np.float32)
        lo = np.zeros((G, G), np.float32)
        for kk in range(4):
            for h in range(2):
                for t in range(4):
                    for v in range(4):
                        e = 16 * kk + 8 * h + t + 4 * (v % 2)
                        (hi if v < 2 else lo)[e] = split[kk, h, p, :, t, v]
                        seen[v // 2, e] += 1
        np.testing.assert_array_equal(hi + lo, w32)
        assert not (hi.view(np.uint32) & 0x1fff).any()
    assert (seen == 2).all()  # once a plane


@pytest.mark.parametrize("kind", ["sorted", "unsorted", "interleaved"])
@pytest.mark.parametrize("groups", [2, 8, 16, 64, 128])
def test_krausn_tf32_model_matches_exact_product(groups, kind):
    """The f32 kernel's walk on tiles of 2, 8, 16, 64 and 128 groups (2^7
    to 2^13 amplitudes: below one m16 tile, one, a full sweep, two), reading
    the block ``encode_ops`` writes, writes every amplitude of the tile
    once and lands within 1e-5 of the largest amplitude of X S^T in
    complex128."""
    tb = 6 + groups.bit_length() - 1
    rows, cols = _masks(tb)[kind]
    table, coeffs = FG.encode_ops((("krausn", rows, cols,
                                    _kraus_terms(np.random.RandomState(groups))),))
    mask = int(table[0, 5])
    st, split = _split_block(table, coeffs)
    x = _tile_state32(tb, 60 + groups)
    out, written = _krausn_tf32_model(x, mask, split)
    assert (written == 1).all()
    exact = _exact(x.astype(np.float64), st, mask)
    err = np.abs(out - exact).max()
    assert err <= 1e-5 * np.abs(exact).max(), err


def test_one_tf32_term_misses_the_limit():
    """hi*hi alone (one TF32 pass) does not meet 1e-5 of the largest
    amplitude on the same walk: why the kernel takes three."""
    tb = 13
    rows, cols = _masks(tb)["sorted"]
    table, coeffs = FG.encode_ops((("krausn", rows, cols,
                                    _kraus_terms(np.random.RandomState(4))),))
    mask = int(table[0, 5])
    st, split = _split_block(table, coeffs)
    x = _tile_state32(tb, 7)
    exact = _exact(x.astype(np.float64), st, mask)
    scale = np.abs(exact).max()
    err3 = np.abs(_krausn_tf32_model(x, mask, split)[0] - exact).max() / scale
    err1 = np.abs(_krausn_tf32_model(x, mask, split, three=False)[0] - exact).max() / scale
    assert err1 > 1e-5 > err3, (err1, err3)


@pytest.mark.parametrize("nq,rows", [(5, (2, 3, 4)), (6, (2, 3, 4)), (6, (4, 0, 3))],
                         ids=["5q", "6q", "6q-unsorted"])
def test_krausn_tf32_model_matches_reference_kernel(nq, rows):
    """The walk on the bench's channel (and the same map on unsorted
    qubits) on a 5- or 6-qubit density register's flattened state (10 or
    12 qubits, one f32 tile of 16 or 64 groups) against the JAX kernel in
    interpret mode in float32, at ``tests/helpers.py``'s f32 tolerance."""
    n = 2 * nq
    op = _bench_krausn(nq, rows)
    table, coeffs = FG.encode_ops(ops_from_reference((op,)))
    _, split = _split_block(table, coeffs)
    x = _tile_state32(n, 80 + nq)
    out, written = _krausn_tf32_model(x, int(table[0, 5]), split)
    assert (written == 1).all()
    ref = np.asarray(PG.fused_local_run(jnp.asarray(x), n=n, ops=(op,), interpret=True))
    assert ref.dtype == np.float32
    assert_amps_close(out, ref, tol=2e-4)


def test_lane_u_and_krausn_run_stages_both():
    """A run that holds a lane_u fold and a krausn op (the kernel's f32
    lane_u instantiation then runs ``krausn_mma`` too) asks the launch to
    stage both, and its plain pass agrees with the JAX kernel in interpret
    mode on a 6-qubit density register's flattened state in float32."""
    import torch

    from quest_tpu_torch.interop import state_from_numpy

    rng = np.random.RandomState(21)
    n = 12
    lane = tuple(("matrix", q % 7, (), (),
                  PG.HashableMatrix(np.linalg.qr(rng.randn(2, 2) + 1j * rng.randn(2, 2))[0]))
                 for q in range(9))
    ops = lane + (_bench_krausn(6),) + lane[::-1]
    pops = ops_from_reference(ops)
    prep = FG.PreparedRun(pops, FG.hopper_tile_bits(n, torch.float32))
    assert [o[0] for o in prep.ops] == ["lane_u", "krausn", "lane_u"]
    assert prep.staged == 3
    x = _tile_state32(n, 90)
    got = FG.fused_run(state_from_numpy(x, "cpu"), n=n, ops=pops, tile_bits=prep.tile_bits,
                       prepared=prep).numpy()
    ref = np.asarray(PG.fused_local_run(jnp.asarray(x), n=n, ops=ops, interpret=True))
    assert_amps_close(got, ref, tol=2e-4)
