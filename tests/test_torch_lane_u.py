"""The lane_u fold of the port's fused gate run (a dense 128x128 unitary on
qubits [0, 7), ``quest_tpu_torch/ops/fused_gates.py``) against the JAX
package's Pallas kernel (``quest_tpu/ops/pallas_gates.py``, the lane_u arm
of ``_ops_body``), and the tensor-core arithmetic of both kernel folds
modelled in numpy.

On the CPU the port's wrapper takes the kernel's plain PyTorch version and
the JAX kernel runs in the Pallas interpreter. Tolerances, as in
``test_torch_fused_gates.py``: 1e-10 in f64; 2e-4 in f32, where the JAX
zone dots are bf16x3 (~5e-6 per dot) and the port's plain FP32. The
kernel's folds (``csrc/fused_gates.cu``: ``lane_u_mma``, 3xTF32, and
``lane_u_dmma``, FP64 ``mma.sync``) cannot run here: numpy models of them,
reading the coefficient block that ``encode_ops`` writes in each fold's
fragment order, are held to the exact product within the limits the card
check (``chip_smoke.py``) applies to the kernel, 1e-5 of the largest
amplitude in f32 and (tighter than its 1e-12) 1e-13 in f64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quest_tpu.ops import pallas_gates as PG
from quest_tpu_torch.interop import ops_from_reference, state_from_numpy
from quest_tpu_torch.ops import fused_gates as FG

from .helpers import assert_amps_close

LANES = 128


def _haar(d, rng):
    q, r = np.linalg.qr(rng.randn(d, d) + 1j * rng.randn(d, d))
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _lane_ops(n):
    """21 random one-qubit unitaries on the lane qubits, which fold into
    one lane_u op, and a parity phase on a lane qubit and the top one."""
    rng = np.random.RandomState(n)
    ops = tuple(("matrix", q % 7, (), (), PG.HashableMatrix(_haar(2, rng)))
                for q in range(21))
    return ops + (("parity", (2, n - 1), (), 0.9),)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [8, 10, 11, 13])
def test_lane_fold_matches_reference_at_tile_sizes(n, dtype):
    """The plain lane_u fold at the port's tile (min(n, 13) in f32, min(n,
    12) in f64: 2 to 64 rows of 128 lanes, fewer than one m16 tile of the
    f32 kernel below n = 11) against the JAX kernel in interpret mode."""
    ops = _lane_ops(n)
    tb = FG.hopper_tile_bits(n, torch.float32 if dtype == np.float32 else torch.float64)
    pops = ops_from_reference(ops)
    assert [o[0] for o in FG._fold_zone_ops(pops, tb)] == ["lane_u", "parity"]
    rng = np.random.RandomState(100 + n)
    state = rng.randn(2, 1 << n).astype(dtype)
    state /= np.linalg.norm(state)
    ref = np.asarray(PG.fused_local_run(jnp.asarray(state), n=n, ops=ops, interpret=True))
    got = FG.fused_run(state_from_numpy(state, "cpu"), n=n, ops=pops, tile_bits=tb).numpy()
    assert got.dtype == dtype
    tol = 2e-4 if dtype == np.float32 else 1e-10
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * max(np.abs(ref).max(), 1.0))


def _lane_block(table, coeffs, i=0):
    """(U^T real, U^T imaginary, split block) of the i-th op of an encoded
    run, as the kernel reads them."""
    off = int(table[i, 6])
    wr = coeffs[off:off + LANES * LANES].reshape(LANES, LANES)
    wi = coeffs[off + LANES * LANES:off + 2 * LANES * LANES].reshape(LANES, LANES)
    split = coeffs[off + 2 * LANES * LANES:off + 6 * LANES * LANES]
    return wr, wi, split.reshape(2, LANES, 8, 2, 4, 4)


def test_lane_u_split_table_matches_encode_ops():
    """The coefficient block of a lane_u op: U^T real and imaginary (what
    the plain version reads), then their TF32 split in the f32 kernel's
    fragment order, each entry where ``lane_u_mma`` reads it: hi + lo is
    the float32 value, hi has its low 13 bits clear and is within half a
    TF32 unit of it."""
    u = _haar(LANES, np.random.RandomState(5))
    W = np.stack([u.real.T, u.imag.T, u.real.T + u.imag.T])
    table, coeffs = FG.encode_ops((("lane_u", FG.HashableMatrix(W)),))
    wr, wi, split = _lane_block(table, coeffs)
    np.testing.assert_array_equal(wr, W[0])
    np.testing.assert_array_equal(wi, W[1])
    np.testing.assert_array_equal(split, FG.lane_u_split_table(W[0], W[1]))
    assert coeffs.size % 4 == 0  # blocks stay 16-byte aligned in f32
    c = np.arange(LANES)
    j, t, h, e = c // 16, (c % 16) // 4, (c % 4) // 2, c % 2
    for p, w in enumerate((W[0], W[1])):
        w32 = w.astype(np.float32)
        # split[p, n, j, h, t, s] for U^T[c][n]: rows c, columns n
        hi = split[p][:, j, h, t, e].T.astype(np.float32)
        lo = split[p][:, j, h, t, 2 + e].T.astype(np.float32)
        np.testing.assert_array_equal(hi + lo, w32)
        assert not (hi.view(np.uint32) & 0x1fff).any()
        assert (np.abs(lo) <= 2.0 ** -11 * np.abs(w32)).all()
    # the same split as the kernel makes of its A operand
    x = np.random.RandomState(6).randn(1000).astype(np.float32)
    hi, lo = FG.tf32_split(x)
    assert not (hi.view(np.uint32) & 0x1fff).any()
    np.testing.assert_array_equal(hi + lo, x)


def _tf32(v):
    """v as the tensor core reads a float32 operand: its low 13 bits cleared."""
    return (np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
            & np.uint32(0xffffe000)).view(np.float32)


def mma_round(v, mode):
    """float64 sums ``v`` to float32 as an FP32 accumulator holds them:
    ``"truncate"`` rounds toward zero, as the tensor cores' ``mma.sync``
    does; ``"nearest"``, as an FP32 add does."""
    f = np.asarray(v).astype(np.float32)
    if mode == "truncate":
        over = np.abs(f.astype(np.float64)) > np.abs(v)
        f[over] = np.nextafter(f[over], np.float32(0))
    return f


def tf32x3_walk(acc, a, b, mma, *, walk="apart", three=True):
    """``acc`` + a b for split operands a = (hi, lo), b = (hi, lo) in the
    accumulation walk of ``quest_mma::mma_3xtf32`` (``csrc/mma.cuh``), each
    ``mma(c, x, y)`` one mma.sync (c + x y, rounded as the accumulator
    rounds). ``"apart"``, the kernel's: lo*hi, hi*lo, hi*hi each into a
    zeroed fragment, added to acc by an FP32 add. ``"chained"``, the walk
    before: the same products onto acc itself. ``three=False`` drops the
    small products."""
    (ah, al), (bh, bl) = a, b
    small = ((al, bh), (ah, bl)) if three else ()
    for x, y in small + ((ah, bh),):
        acc = mma(acc, x, y) if walk == "chained" else acc + mma(np.zeros_like(acc), x, y)
    return acc


def _kernel_model(xr, xi, split, three=True, walk="apart", mode="truncate"):
    """The f32 kernel's lane_u arithmetic on rows (xr, xi) of a tile: the
    k steps in its order (chunk j of 16 columns, then h), each step's A
    fragment from columns 16 j + 4 t + 2 h (+1) split as the kernel splits
    it, the B fragments from the host's split block, each mma.sync m16n8k8
    as 8 exact products summed onto its FP32 accumulator and rounded once
    (``mode``: toward zero, as the card does, or to nearest), in the
    kernel's order: out_r += xr Ur^T + xi (-Ui^T), out_i += xr Ui^T + xi
    Ur^T, each product in the accumulation ``walk`` of
    :func:`tf32x3_walk`, in 3xTF32 or hi*hi alone."""
    rows = xr.shape[0]
    acc = {"r": np.zeros((rows, LANES), np.float32), "i": np.zeros((rows, LANES), np.float32)}

    def mma(c, a, b):
        return mma_round(c.astype(np.float64) + a.astype(np.float64) @ b.astype(np.float64),
                         mode)

    def product(key, a, b):
        acc[key] = tf32x3_walk(acc[key], a, b, mma, walk=walk, three=three)

    for j in range(8):
        for h in range(2):
            cols = [16 * j + 4 * t + 2 * h + e for e in (0, 1) for t in range(4)]
            sa = {}
            for name, x in (("r", xr), ("i", xi)):
                hi, lo = FG.tf32_split(x[:, cols])
                sa[name] = (hi, _tf32(lo))
            sb = {}
            for p, name in enumerate("ri"):
                blk = split[p][:, j, h]  # (n, t, 4): hi e0, hi e1, lo e0, lo e1
                hi = np.concatenate([blk[:, :, 0].T, blk[:, :, 1].T]).astype(np.float32)
                lo = np.concatenate([blk[:, :, 2].T, blk[:, :, 3].T]).astype(np.float32)
                sb[name] = (hi, _tf32(lo))
            sb["-i"] = (-sb["i"][0], -sb["i"][1])
            product("r", sa["r"], sb["r"])
            product("r", sa["i"], sb["-i"])
            product("i", sa["r"], sb["i"])
            product("i", sa["i"], sb["r"])
    return acc["r"], acc["i"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tf32x3_model_within_card_limit(seed):
    """The model of the f32 kernel on a Haar 128x128 unitary (the form
    ``_fold_zone_ops`` and ``fusion.lane_u_run`` give the encoder) and a
    normalised 64-row tile lands within 1e-5 of the largest amplitude of
    the exact product; one TF32 pass alone does not, which is why the
    kernel takes three."""
    rng = np.random.RandomState(seed)
    u = _haar(LANES, rng)
    W = np.stack([u.real.T, u.imag.T, u.real.T + u.imag.T])
    table, coeffs = FG.encode_ops((("lane_u", FG.HashableMatrix(W)),))
    _, _, split = _lane_block(table, coeffs)
    x = rng.randn(2, 64, LANES).astype(np.float32)
    x /= np.linalg.norm(x)
    exact = (x[0].astype(np.float64) + 1j * x[1]) @ (W[0] + 1j * W[1])
    scale = np.abs(exact).max()
    out_r, out_i = _kernel_model(x[0], x[1], split)
    err = max(np.abs(out_r - exact.real).max(), np.abs(out_i - exact.imag).max()) / scale
    assert err < 1e-5, err
    one_r, one_i = _kernel_model(x[0], x[1], split, three=False)
    err1 = max(np.abs(one_r - exact.real).max(), np.abs(one_i - exact.imag).max()) / scale
    assert err1 > 1e-5 > err, (err1, err)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fold", ["lane_u", "window"])
def test_chained_walk_loses_norm_under_truncation(fold, seed):
    """With each mma.sync rounded toward zero, as the card's tensor cores
    round, the 3xTF32 walk that chains every product onto one running sum
    loses norm on every f32 tile (one sign) and, over the tiles, ten times
    or more what the FP32 product rounded to nearest changes it: the fault
    the kernel's walk repairs. Rounded to nearest, the same
    walk shows nothing, which is why a model that rounds so never saw
    it."""
    from .test_torch_window_tf32 import fold_norm_changes

    ch = fold_norm_changes(fold, seed)
    assert all(d < 0 for d in ch["chained"]), ch
    assert -sum(ch["chained"]) >= 10 * np.abs(ch["plain"]).sum(), ch


# ---------------------------------------------------------------------------
# the f64 fold: FP64 mma.sync m16n8k8 (lane_u_dmma)
# ---------------------------------------------------------------------------

def _f64_block(table, coeffs, i=0):
    """The f64 kernel's part of the i-th op's lane_u block: U^T in its B
    fragment order, after U^T and the TF32 split, (2, 16, 2, 64, 4, 2)."""
    off = int(table[i, 6]) + 6 * LANES * LANES
    return coeffs[off:off + 2 * LANES * LANES].reshape(2, 16, 2, LANES // 2, 4, 2)


def test_lane_u_f64_table_matches_encode_ops():
    """The f64 fragment-order table at the end of a lane_u block: what
    ``lane_u_f64_table`` lays out, 16-byte aligned, each (sweep q, k step s
    = 2 j + h) one contiguous half panel whose entry [plane, n, t, e] is
    U^T[16 j + 4 t + 2 h + e][64 q + n] of that plane, exactly; every c once
    across a sweep's steps."""
    u = _haar(LANES, np.random.RandomState(7))
    W = np.stack([u.real.T, u.imag.T, u.real.T + u.imag.T])
    table, coeffs = FG.encode_ops((("lane_u", FG.HashableMatrix(W)),))
    steps = _f64_block(table, coeffs)
    np.testing.assert_array_equal(steps, FG.lane_u_f64_table(W[0], W[1]))
    assert (int(table[0, 6]) + 6 * LANES * LANES) % 2 == 0  # 16-byte loads in f64
    assert coeffs.size == int(table[0, 6]) + 8 * LANES * LANES
    for q in range(2):
        for s in range(16):
            j, h = divmod(s, 2)
            for t in range(4):
                for e in range(2):
                    c = 16 * j + 4 * t + 2 * h + e
                    for p in range(2):
                        np.testing.assert_array_equal(steps[q, s, p, :, t, e],
                                                      W[p][c, 64 * q:64 * q + 64])
    cs = sorted(16 * (s // 2) + 4 * t + 2 * (s % 2) + e
                for s in range(16) for t in range(4) for e in range(2))
    assert cs == list(range(LANES))


def _dmma_model(x, steps):
    """The f64 kernel's walk on one tile (``lane_u_dmma``): x (2, rows, 128)
    float64, rows <= 32. In sweep q, warp w takes the m16 tile of rows 16
    (w & 1) (idle if it starts past the tile) and the n8 tile of columns 64
    q + 8 (w >> 1); lane (g, t) = divmod(lane, 4). A chunk j (the table's
    k steps 2 j and 2 j + 1) is one m16n8k16 per product: the lane's A
    values from its rows g and g + 8 at columns 16 j + 4 t .. + 3 (0 where
    the row is past the tile; lanes of odd g load the two steps in the
    other order, which moves no value), its B fragments from the host's
    table, fragment by fragment. The operands are rebuilt from the
    fragments and the four real products added, A B in float64, in the
    kernel's order: xr Ur^T, xr Ui^T, xi Ur^T, xi (-Ui^T). The C fragments
    go to the rows that are in the tile. Returns (out, how often each
    output was written)."""
    rows = x.shape[1]
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    out = np.zeros_like(x)
    written = np.zeros(x.shape[1:], dtype=int)
    for q in range(2):
        for warp in range(16):
            m0, n8 = 16 * (warp & 1), 8 * (warp >> 1)
            if m0 >= rows:
                continue
            row0, row1 = m0 + g, m0 + g + 8
            ok0, ok1 = row0 < rows, row1 < rows
            acc = np.zeros((2, 16, 8))  # real, imaginary
            for j in range(8):
                A, B = [], []
                for p, plane in enumerate(x):
                    # the chunk's columns c0 .. c0 + 3 of rows g and g + 8 (0 past
                    # the tile), c0 = 16 j + 4 t: k steps 2 j and 2 j + 1
                    col = 16 * j + 4 * t
                    r0 = [np.where(ok0, plane[np.minimum(row0, rows - 1), col + e], 0.0)
                          for e in range(4)]
                    r1 = [np.where(ok1, plane[np.minimum(row1, rows - 1), col + e], 0.0)
                          for e in range(4)]
                    # a[i] = A[g + 8 (i & 1)][t + 4 (i >> 1)], k = t + 4 e <-> c0 + e
                    m = np.zeros((16, 16))
                    for e in range(4):
                        m[g, t + 4 * e], m[g + 8, t + 4 * e] = r0[e], r1[e]
                    A.append(m)
                    # b[i] = B[t + 4 i][g]: the k steps' fragments from the table
                    frag = np.concatenate([steps[q, 2 * j + h, p, n8 + g, t] for h in (0, 1)],
                                          axis=1)  # (32 lanes, 4)
                    m = np.zeros((16, 8))
                    for e in range(4):
                        m[t + 4 * e, g] = frag[:, e]
                    B.append(m)
                acc[0] += A[0] @ B[0]
                acc[1] += A[0] @ B[1]
                acc[1] += A[1] @ B[0]
                acc[0] += A[1] @ -B[1]
            for e in (0, 1):
                cols = 64 * q + n8 + 2 * t + e
                for r, ok, m in ((row0, ok0, g), (row1, ok1, g + 8)):
                    out[:, r[ok], cols[ok]] = acc[:, m[ok], 2 * t[ok] + e]
                    written[r[ok], cols[ok]] += 1
    return out, written


def _lane_state(rows, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, rows, LANES)
    return x / np.linalg.norm(x)


@pytest.mark.parametrize("rows", [2, 8, 16, 32])
def test_dmma_model_matches_exact_product(rows):
    """The f64 kernel's walk on tiles of 2, 8, 16 and 32 rows (2^8 to 2^12
    amplitudes: below one m16 tile, one, and two), reading the table
    ``encode_ops`` writes, writes every output of the tile once and lands
    within 1e-13 of the largest amplitude of X U^T in complex128."""
    u = _haar(LANES, np.random.RandomState(rows))
    W = np.stack([u.real.T, u.imag.T, u.real.T + u.imag.T])
    table, coeffs = FG.encode_ops((("lane_u", FG.HashableMatrix(W)),))
    x = _lane_state(rows, 40 + rows)
    out, written = _dmma_model(x, _f64_block(table, coeffs))
    assert (written == 1).all()
    exact = (x[0] + 1j * x[1]) @ (W[0] + 1j * W[1])
    err = max(np.abs(out[0] - exact.real).max(), np.abs(out[1] - exact.imag).max())
    assert err <= 1e-13 * np.abs(exact).max(), err


@pytest.mark.parametrize("rows", [2, 8, 16, 32])
def test_dmma_model_matches_reference_kernel(rows):
    """The same walk on the lane_u op that 21 one-qubit unitaries on the
    lane qubits fold into (``_fold_zone_ops`` at the f64 tile) against the
    JAX kernel on those gates in interpret mode, on an n-qubit state of
    that many rows (the whole state one tile), at ``tests/helpers.py``'s
    f64 tolerance."""
    n = 7 + rows.bit_length() - 1
    ops = _lane_ops(n)[:-1]
    tb = FG.hopper_tile_bits(n, torch.float64)
    assert 1 << (tb - 7) == rows
    folded = FG._fold_zone_ops(ops_from_reference(ops), tb)
    assert [o[0] for o in folded] == ["lane_u"]
    table, coeffs = FG.encode_ops(folded)
    x = _lane_state(rows, 60 + rows)
    out, _ = _dmma_model(x, _f64_block(table, coeffs))
    ref = np.asarray(PG.fused_local_run(jnp.asarray(x.reshape(2, -1)), n=n, ops=ops,
                                        interpret=True))
    assert_amps_close(out.reshape(2, -1), ref, tol=1e-10)
