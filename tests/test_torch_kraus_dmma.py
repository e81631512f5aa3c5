"""The f64 krausn arm of the port's fused gate run (a channel on 3 row and 3
column qubits as its 64x64 superoperator, ``csrc/fused_gates.cu``:
``krausn_dmma``, FP64 ``mma.sync``) modelled in numpy, against the exact
superoperator product and the JAX package's Pallas kernel
(``quest_tpu/ops/pallas_gates.py``, the kraus arm of ``_ops_body``).

The kernel cannot run here. The model walks a tile as the kernel does,
fragment by fragment, reading the coefficient block that ``encode_ops``
writes (S^T in the kernel's FP64 fragment order after S^T real and
imaginary): the gathered A operand at the deposits into the qubit mask,
the masked groups of small tiles, the two sweeps. Limits: 1e-13 of the
largest amplitude against the exact complex128 product (tighter than the
card check's 1e-12 in ``chip_smoke.py``); ``tests/helpers.py``'s f64
tolerance, 1e-10, against the JAX kernel in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from quest_tpu.ops import pallas_gates as PG
from quest_tpu_torch.interop import ops_from_reference
from quest_tpu_torch.ops import fused_gates as FG

from .helpers import assert_amps_close

G = 64  # S's side for 3 row qubits


def _kraus_terms(rng, scale=(0.3, 0.2)):
    """Two random (non-trace-preserving) 8x8 Kraus terms, one signed."""
    return tuple((s, FG.HashableMatrix(c * (rng.randn(8, 8) + 1j * rng.randn(8, 8))))
                 for s, c in zip((1.0, -1.0), scale))


def _masks(tb):
    """(rows, cols) of a 3-target channel on a tile of tb bits: the density
    path's form (rows low, columns at the top of the tile, each ascending),
    an unsorted one and one whose row and column qubits alternate."""
    return {"sorted": ((0, 1, 2), (tb - 3, tb - 2, tb - 1)),
            "unsorted": ((2, 0, 1), (tb - 1, tb - 3, tb - 2)),
            "interleaved": ((tb - 2, 0, tb // 2), (tb - 1, 1, tb // 2 + 1))}


def _block(table, coeffs, i=0):
    """(S^T, the f64 fragment-order part) of the i-th op's kraus block."""
    off = int(table[i, 6])
    st = (coeffs[off:off + G * G].reshape(G, G)
          + 1j * coeffs[off + G * G:off + 2 * G * G].reshape(G, G))
    return st, coeffs[off + 2 * G * G:off + 4 * G * G].reshape(4, 2, 2, G, 4, 2)


def _bits(mask):
    return [q for q in range(mask.bit_length()) if (mask >> q) & 1]


def _deposit(v, bits):
    """The low bits of v (an int array) deposited at the positions ``bits``."""
    return sum(((np.asarray(v) >> j) & 1) << q for j, q in enumerate(bits))


def _group_bases(groups, mask, tb):
    """insert_zeros(g, mask) for every group g of a tile of tb bits."""
    free = [q for q in range(tb) if not (mask >> q) & 1]
    return _deposit(np.arange(groups), free)


def _krausn_model(x, mask, steps):
    """The f64 kernel's walk on one tile (``krausn_dmma``): x (2, tile)
    float64. Groups = tile / 64, group g's values at base(g) + dep(e). In
    sweep q (one per 32 groups) warp w takes the m16 tile of groups 32 q +
    16 (w & 1) (idle if it starts past the tile) and the n8 tile of columns
    8 (w >> 1); lane (g, t) = divmod(lane, 4). Step kk gives the lane the values e = 16
    kk + t + 4 m of its groups g and g + 8 (0 past the tile), at offsets
    summed from single mask bits as the kernel sums them, and its B values
    of column n = g from the host's table, fragment by fragment. The four
    real products added, A B in float64, in the kernel's order: xr Sr^T, xr
    Si^T, xi Sr^T, xi (-Si^T). The C fragments go to base(group) + dep(d)
    for the groups in the tile. Returns (out, how often each amplitude was
    written)."""
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
    for q in range(2 if groups > 32 else 1):
        for warp in range(16):
            m0, n8 = 32 * q + 16 * (warp & 1), 8 * (warp >> 1)
            if m0 >= groups:
                continue
            row0, row1 = m0 + g, m0 + g + 8
            ok0, ok1 = row0 < groups, row1 < groups
            a0 = np.where(ok0, base[np.minimum(row0, groups - 1)], 0) + dt
            a1 = np.where(ok1, base[np.minimum(row1, groups - 1)], 0) + dt
            acc = np.zeros((2, 16, 8))  # real, imaginary
            for kk in range(4):
                dk = (bit[4] if kk & 1 else 0) + (bit[5] if kk & 2 else 0)
                o = [dk, dk + bit[2], dk + bit[3], dk + bit[2] + bit[3]]
                for h in range(2):
                    A, B = [], []
                    for p, plane in enumerate(x):
                        # a[0] = A[g][t], a[1] = A[g + 8][t], a[2] = A[g][t + 4],
                        # a[3] = A[g + 8][t + 4]: e = 16 kk + t + 8 h (+ 4)
                        m = np.zeros((16, 8))
                        for j in range(2):
                            off = o[2 * h + j]
                            m[g, t + 4 * j] = np.where(ok0, plane[np.where(ok0, a0 + off, 0)], 0.0)
                            m[g + 8, t + 4 * j] = np.where(ok1, plane[np.where(ok1, a1 + off, 0)], 0.0)
                        A.append(m)
                        # b[0] = B[t][g], b[1] = B[t + 4][g]: the table's pair
                        frag = steps[kk, h, p, n8 + g, t]  # (32 lanes, 2)
                        m = np.zeros((8, 8))
                        for j in range(2):
                            m[t + 4 * j, g] = frag[:, j]
                        B.append(m)
                    acc[0] += A[0] @ B[0]
                    acc[1] += A[0] @ B[1]
                    acc[1] += A[1] @ B[0]
                    acc[0] += A[1] @ -B[1]
            # c[0] = C[g][2t], c[1] = C[g][2t+1], c[2] = C[g+8][2t], c[3] = C[g+8][2t+1]
            for e in (0, 1):
                off = _deposit(n8 + 2 * t + e, _bits(mask))
                for a, ok, r in ((a0, ok0, g), (a1, ok1, g + 8)):
                    addr = (a - dt + off)[ok]
                    out[:, addr] = acc[:, r[ok], 2 * t[ok] + e]
                    written[addr] += 1
    return out, written


def _tile_state(tb, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 1 << tb)
    return x / np.linalg.norm(x)


def _exact(x, st, mask):
    """OUT[g] = X[g] S^T in complex128 on one tile, X[g][e] = x[base(g) +
    dep(e)], the amplitudes outside the groups' values untouched."""
    tb = x.shape[1].bit_length() - 1
    idx = (_group_bases(x.shape[1] >> 6, mask, tb)[:, None]
           + _deposit(np.arange(G), _bits(mask))[None, :])
    psi = x[0] + 1j * x[1]
    out = psi.copy()
    out[idx] = psi[idx] @ st
    return np.stack([out.real, out.imag])


@pytest.mark.parametrize("kind", ["sorted", "unsorted", "interleaved"])
def test_krausn_f64_table_matches_encode_ops(kind):
    """The kraus block of a 3-qubit op: S^T real and imaginary (the
    superoperator itself), then ``kraus_superop_f64_table`` of it, 16-byte
    aligned, then the f32 kernel's TF32 split (4 G^2 float32 entries,
    ``test_torch_kraus_tf32.py``); entry [kk, h, plane, n, t, e'] of the
    f64 table is S^T[16 kk + t + 4 (2 h + e')][n] of that plane, exactly,
    and every (e, d) appears once."""
    rng = np.random.RandomState(3)
    rows, cols = _masks(12)[kind]
    terms = _kraus_terms(rng)
    table, coeffs = FG.encode_ops((("krausn", rows, cols, terms),))
    st, steps = _block(table, coeffs)
    ks = [(s, np.asarray(K.arr)) for s, K in terms]
    np.testing.assert_array_equal(st, FG.kraus_superop_table(ks, rows + cols))
    np.testing.assert_array_equal(steps, FG.kraus_superop_f64_table(st))
    assert (int(table[0, 6]) + 2 * G * G) % 2 == 0  # 16-byte loads in f64
    assert coeffs.size == int(table[0, 6]) + 8 * G * G
    seen = np.zeros((G, G), dtype=int)
    for kk in range(4):
        for h in range(2):
            for t in range(4):
                for e in range(2):
                    row = 16 * kk + t + 4 * (2 * h + e)
                    np.testing.assert_array_equal(steps[kk, h, 0, :, t, e], st[row].real)
                    np.testing.assert_array_equal(steps[kk, h, 1, :, t, e], st[row].imag)
                    seen[row] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("kind", ["sorted", "unsorted", "interleaved"])
@pytest.mark.parametrize("groups", [2, 8, 16, 64])
def test_krausn_model_matches_exact_product(groups, kind):
    """The f64 kernel's walk on tiles of 2, 8, 16 and 64 groups (2^7 to
    2^12 amplitudes: below one m16 tile, one, four), reading the block
    ``encode_ops`` writes, writes every amplitude of the tile once and
    lands within 1e-13 of the largest amplitude of X S^T in complex128."""
    tb = 6 + groups.bit_length() - 1
    rows, cols = _masks(tb)[kind]
    table, coeffs = FG.encode_ops((("krausn", rows, cols,
                                    _kraus_terms(np.random.RandomState(groups))),))
    mask = int(table[0, 5])
    st, steps = _block(table, coeffs)
    x = _tile_state(tb, 50 + groups)
    out, written = _krausn_model(x, mask, steps)
    assert (written == 1).all()
    exact = _exact(x, st, mask)
    err = np.abs(out - exact).max()
    assert err <= 1e-13 * np.abs(exact).max(), err


def _bench_krausn(nq, rows=(2, 3, 4)):
    """The bench's 3-target Kraus map (``density_circuit``'s
    mixMultiQubitKrausMap on qubits 2-4) as the JAX kernel's krausn op on
    an nq-qubit density register's flattened state."""
    xxx = np.kron(np.kron([[0, 1], [1, 0]], [[0, 1], [1, 0]]), [[0, 1], [1, 0]])
    terms = ((1.0, PG.HashableMatrix(0.8 * xxx)), (1.0, PG.HashableMatrix(0.6j * np.eye(8))))
    return ("krausn", tuple(rows), tuple(q + nq for q in rows), terms)


@pytest.mark.parametrize("nq,rows", [(5, (2, 3, 4)), (6, (2, 3, 4)), (6, (4, 0, 3))],
                         ids=["5q", "6q", "6q-unsorted"])
def test_krausn_model_matches_reference_kernel(nq, rows):
    """The walk on the bench's channel (and the same map on unsorted
    qubits) on a 5- or 6-qubit density register's flattened state (10 or
    12 qubits, one f64 tile of 16 or 64 groups) against the JAX kernel in
    interpret mode, at ``tests/helpers.py``'s f64 tolerance."""
    n = 2 * nq
    op = _bench_krausn(nq, rows)
    table, coeffs = FG.encode_ops(ops_from_reference((op,)))
    _, steps = _block(table, coeffs)
    x = _tile_state(n, 70 + nq)
    out, written = _krausn_model(x, int(table[0, 5]), steps)
    assert (written == 1).all()
    ref = np.asarray(PG.fused_local_run(jnp.asarray(x), n=n, ops=(op,), interpret=True))
    assert_amps_close(out, ref, tol=1e-10)


@pytest.mark.parametrize("kind", ["kraus1", "kraus2", "krausn"])
def test_f32_kraus_block_unchanged(kind):
    """The first part of every kraus block is S^T real then imaginary, as
    before (the kernel's t = 1, 2 arms read it in both precisions); only a
    3-qubit op's block carries the fragment-order tables after it (FP64,
    then the TF32 split: 2 + 2 + 4 times G^2 entries), and only a run with
    one asks the launch to stage them."""
    rng = np.random.RandomState(9)
    t = {"kraus1": 1, "kraus2": 2, "krausn": 3}[kind]
    d = 1 << t
    terms = tuple((s, FG.HashableMatrix(0.4 * (rng.randn(d, d) + 1j * rng.randn(d, d))))
                  for s in (1.0, -1.0))
    rows, cols = tuple(range(t)), tuple(range(8, 8 + t))
    op = ((kind, rows[0], cols[0], terms) if t == 1 else
          (kind, *rows, *cols, terms) if t == 2 else (kind, rows, cols, terms))
    table, coeffs = FG.encode_ops((op,))
    g2 = (1 << (2 * t)) ** 2
    st = FG.kraus_superop_table([(s, np.asarray(K.arr)) for s, K in terms], rows + cols)
    off = int(table[0, 6])
    np.testing.assert_array_equal(coeffs[off:off + g2], st.real.reshape(-1))
    np.testing.assert_array_equal(coeffs[off + g2:off + 2 * g2], st.imag.reshape(-1))
    assert coeffs.size == off + (8 if t == 3 else 2) * g2
    prep = FG.PreparedRun((op,), 9)
    assert prep.staged == (2 if t == 3 else 0)
