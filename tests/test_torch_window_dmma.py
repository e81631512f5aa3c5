"""The f64 window fold of the port's fused gate run (a dense 2^span x 2^span
unitary on the zone [7, tile_bits), ``csrc/fused_gates.cu``:
``window_dmma``, FP64 ``mma.sync``) modelled in numpy, against the exact
complex product and the JAX package's Pallas kernel
(``quest_tpu/ops/pallas_gates.py``, the window arm of ``_ops_body``).

The kernel cannot run here. The model walks a tile as the kernel does,
fragment by fragment, reading the coefficient block that ``encode_ops``
writes (U in the kernel's FP64 A-fragment order after U real and
imaginary): warp w's n8 block of columns, the m16 tiles of U, the zero
rows of the one m16 tile at D = 8. Limits: 1e-13 of the largest amplitude
against the exact complex128 product (tighter than the card check's 1e-12
in ``chip_smoke.py``); ``tests/helpers.py``'s f64 tolerance, 1e-10,
against the JAX kernel in interpret mode. Also here: the launch's
``staged`` bit 2, and the f64 check that keeps every other window
geometry from the kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quest_tpu.ops import pallas_gates as PG
from quest_tpu_torch.interop import ops_from_reference
from quest_tpu_torch.ops import fused_gates as FG

from .helpers import assert_amps_close

LANES = 128


def _haar(d, rng):
    q, r = np.linalg.qr(rng.randn(d, d) + 1j * rng.randn(d, d))
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _window_op(span, rng, lo=7):
    """A window op of a Haar unitary, as ``_fold_zone_ops`` writes one."""
    u = _haar(1 << span, rng)
    return ("window", lo, span, FG.HashableMatrix(np.block([[u.real, -u.imag],
                                                            [u.imag, u.real]])))


def _block(table, coeffs, span, i=0):
    """(U, the f64 fragment-order part) of the i-th op's window block."""
    D = 1 << span
    off = int(table[i, 6])
    u = (coeffs[off:off + D * D].reshape(D, D)
         + 1j * coeffs[off + D * D:off + 2 * D * D].reshape(D, D))
    size = max(D // 16, 1) * D * 32
    frags = coeffs[off + 2 * D * D:off + 2 * D * D + size]
    return u, frags.reshape(max(D // 16, 1), D // 8, 2, 2, 32, 2)


def _window_model(x, frags, span):
    """The f64 kernel's walk on one tile (``window_dmma``): x (2, 128 D)
    float64, X[e][b] = x[(e << 7) | b]. Warp w takes the columns b = 8 w ..
    8 w + 7 and every m16 tile of U; lane (g, t) = divmod(lane, 4). k step
    ks gives the lane its B values X[8 ks + t][8 w + g] and X[8 ks + t +
    4][8 w + g], and its A values of each m16 tile mt from the host's
    table, fragment by fragment. The four real products added, A B in
    float64, in the kernel's order: Ur xr, Ur xi, Ui xr, Ui (-xi). The C
    fragments go to rows 16 mt + g (+ 8, below D) of the warp's columns.
    Returns (out, how often each amplitude was written)."""
    D = 1 << span
    assert x.shape[1] == D * LANES
    X = x.reshape(2, D, LANES)
    mtiles, ksteps = max(D // 16, 1), D // 8
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    out = x.copy()
    written = np.zeros(x.shape[1], dtype=int)
    for warp in range(16):
        cols = 8 * warp
        acc = np.zeros((mtiles, 2, 16, 8))  # per m16 tile: real, imaginary
        for ks in range(ksteps):
            # b[0] = B[t][g], b[1] = B[t + 4][g]
            B = np.zeros((2, 8, 8))
            for j in (0, 1):
                B[:, t + 4 * j, g] = X[:, 8 * ks + t + 4 * j, cols + g]
            for mt in range(mtiles):
                # a[0] = A[g][t], a[1] = A[g + 8][t], a[2] = A[g][t + 4],
                # a[3] = A[g + 8][t + 4]: half h holds a[2 h], a[2 h + 1]
                A = np.zeros((2, 16, 8))
                for h in (0, 1):
                    for j in (0, 1):
                        A[:, g + 8 * j, t + 4 * h] = frags[mt, ks, :, h, :, j]
                acc[mt, 0] += A[0] @ B[0]
                acc[mt, 1] += A[0] @ B[1]
                acc[mt, 1] += A[1] @ B[0]
                acc[mt, 0] += A[1] @ -B[1]
        # c[0] = C[g][2t], c[1] = C[g][2t+1], c[2] = C[g+8][2t], c[3] = C[g+8][2t+1]
        for mt in range(mtiles):
            for r in (0, 8):
                if 16 * mt + r >= D:
                    continue  # the zero rows of the m16 tile at D = 8
                for e in (0, 1):
                    addr = ((16 * mt + g + r) << 7) | (cols + 2 * t + e)
                    out[:, addr] = acc[mt][:, g + r, 2 * t + e]
                    written[addr] += 1
    return out, written


def _tile_state(tb, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 1 << tb)
    return x / np.linalg.norm(x)


def _exact(x, u):
    """OUT = U X in complex128 on one tile, X[e][b] = x[(e << 7) | b]."""
    xc = (x[0] + 1j * x[1]).reshape(u.shape[0], LANES)
    out = (u @ xc).reshape(-1)
    return np.stack([out.real, out.imag])


@pytest.mark.parametrize("span", [3, 4, 5])
def test_window_f64_table_matches_encode_ops(span):
    """The window block of a span 3-5 op: U real and imaginary (what the
    plain version and the f32 kernel read), then ``window_f64_table`` of
    it, 16-byte aligned; entry [mt, ks, plane, h, lane, j] is U[16 mt + g +
    8 j][8 ks + t + 4 h] of that plane, exactly (0 past D), and every (d,
    e) of U appears once a plane."""
    D = 1 << span
    op = _window_op(span, np.random.RandomState(span))
    table, coeffs = FG.encode_ops((op,))
    u, frags = _block(table, coeffs, span)
    W = np.asarray(op[3].arr).real
    np.testing.assert_array_equal(u, W[:D, :D] + 1j * W[D:, :D])
    np.testing.assert_array_equal(frags, FG.window_f64_table(W, span))
    assert (int(table[0, 6]) + 2 * D * D) % 2 == 0  # 16-byte copies in f64
    assert coeffs.size == int(table[0, 6]) + 2 * D * D + frags.size
    seen = np.zeros((2, D, D), dtype=int)
    for mt in range(max(D // 16, 1)):
        for ks in range(D // 8):
            for h in (0, 1):
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    for j in (0, 1):
                        d, e = 16 * mt + g + 8 * j, 8 * ks + t + 4 * h
                        got = frags[mt, ks, :, h, lane, j]
                        if d >= D:
                            np.testing.assert_array_equal(got, 0.0)
                            continue
                        np.testing.assert_array_equal(got, [u[d, e].real, u[d, e].imag])
                        seen[:, d, e] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("span", [1, 2, 3, 4, 5])
def test_window_block_starts_with_u(span):
    """Every window block starts with U real then imaginary, as before
    (what the plain version and the f32 kernel read, in either
    precision); spans 1 and 2 (the FMA arm, below an m16 tile) keep their
    old size, and only spans 3-5 carry the fragment table after it."""
    D = 1 << span
    op = _window_op(span, np.random.RandomState(10 + span))
    table, coeffs = FG.encode_ops((("parity", (0, 3), (), 0.4), op))
    off = int(table[1, 6])
    W = np.asarray(op[3].arr).real
    np.testing.assert_array_equal(coeffs[off:off + D * D], W[:D, :D].reshape(-1))
    np.testing.assert_array_equal(coeffs[off + D * D:off + 2 * D * D], W[D:, :D].reshape(-1))
    extra = max(D // 16, 1) * D * 32 if span >= 3 else 0
    assert coeffs.size == off + 2 * D * D + extra + (-2 * D * D) % 4


@pytest.mark.parametrize("span", [3, 4, 5])
def test_window_model_matches_exact_product(span):
    """The f64 kernel's walk on tiles of D = 8, 16 and 32 rows (one m16
    tile with zero rows, one, two), reading the block ``encode_ops``
    writes, writes every amplitude of the tile once and lands within
    1e-13 of the largest amplitude of U X in complex128."""
    table, coeffs = FG.encode_ops((_window_op(span, np.random.RandomState(20 + span)),))
    u, frags = _block(table, coeffs, span)
    x = _tile_state(7 + span, 30 + span)
    out, written = _window_model(x, frags, span)
    assert (written == 1).all()
    exact = _exact(x, u)
    err = np.abs(out - exact).max()
    assert err <= 1e-13 * np.abs(exact).max(), err


def _one_qubit_gates(lo, hi, count, rng):
    """Random one-qubit unitaries on qubits [lo, hi), round robin."""
    return tuple(("matrix", lo + q % (hi - lo), (), (), PG.HashableMatrix(_haar(2, rng)))
                 for q in range(count))


def _model_run(prep, x):
    """A prepared run on a one-tile state: window ops through the model of
    the kernel's walk, every other op through the plain version's arm."""
    n = x.shape[1].bit_length() - 1
    cf = torch.as_tensor(prep.coeffs)
    loc = torch.arange(1 << n)
    for i, (op, rec) in enumerate(zip(prep.ops, prep.table.tolist())):
        if op[0] == "window":
            x, written = _window_model(x, _block(prep.table, prep.coeffs, op[2], i)[1], op[2])
            assert (written == 1).all()
        else:
            x = FG._plain_op(torch.as_tensor(x), rec, cf, loc, loc).numpy()
    return x


@pytest.mark.parametrize("n", [10, 11, 12])
def test_window_model_matches_reference_kernel(n):
    """25 random one-qubit gates on [7, n), which both packages fold into
    one window op (span 3, 4, 5 at the one-tile f64 geometry), through the
    model of the kernel's walk against the JAX kernel in interpret mode,
    at ``tests/helpers.py``'s f64 tolerance."""
    ops = _one_qubit_gates(7, n, 25, np.random.RandomState(n))
    tb = FG.hopper_tile_bits(n, torch.float64)
    prep = FG.PreparedRun(ops_from_reference(ops), tb)
    assert [o[0] for o in prep.ops] == ["window"] and prep.ops[0][1:3] == (7, n - 7)
    x = _tile_state(n, 40 + n)
    ref = np.asarray(PG.fused_local_run(jnp.asarray(x), n=n, ops=ops, interpret=True))
    assert_amps_close(_model_run(prep, x), ref, tol=1e-10)


@pytest.mark.parametrize("order", ["lane_u, window", "window, matrix, lane_u"])
def test_window_lane_u_run_matches_reference_kernel(order):
    """A run that holds a lane_u fold and a window fold (in the kernel, the
    lane_u fold's chunk ring and then the window's stage, or the other way
    round with a controlled 2x2 between them) at 11 qubits: the model
    (lane_u and the matrix through the plain version) against the JAX
    kernel in interpret mode."""
    rng = np.random.RandomState(7)
    lane, window = _one_qubit_gates(0, 7, 21, rng), _one_qubit_gates(7, 11, 25, rng)
    if order == "lane_u, window":
        ops = lane + window
    else:
        ops = window + (("matrix", 3, (8,), (1,), PG.HashableMatrix(_haar(2, rng))),) + lane
    prep = FG.PreparedRun(ops_from_reference(ops), 11)
    assert ", ".join(o[0] for o in prep.ops) == order
    assert prep.staged == 5
    x = _tile_state(11, 60)
    ref = np.asarray(PG.fused_local_run(jnp.asarray(x), n=11, ops=ops, interpret=True))
    assert_amps_close(_model_run(prep, x), ref, tol=1e-10)


@pytest.mark.parametrize("span", [1, 2, 3, 4, 5])
def test_staged_bit_2_marks_spans_from_3(span):
    """``PreparedRun.staged`` gets bit 2 (the window's fragment table
    through the chunk buffer) for a window fold of span 3 or more, and not
    for spans 1 and 2; the lane_u bit beside it is unchanged."""
    rng = np.random.RandomState(span)
    ops = ops_from_reference(_one_qubit_gates(7, 7 + span, 25, rng))
    prep = FG.PreparedRun(ops, 7 + span)
    assert [o[0] for o in prep.ops] == ["window"]
    assert prep.staged == (4 if span >= 3 else 0)
    lane = ops_from_reference(_one_qubit_gates(0, 7, 21, rng))
    assert FG.PreparedRun(lane + ops, 7 + span).staged == (5 if span >= 3 else 1)


@pytest.mark.parametrize("lo,span", [(8, 3), (7, 3), (8, 4)], ids=["lo8", "short", "lo8-top"])
def test_f64_check_refuses_other_window_zones(lo, span):
    """A hand-built f64 window op off the zone [7, tile_bits) (the planner
    never makes one) is refused before any pass, at tile_bits 12: the
    kernel's f64 window arm takes lo = 7 and lo + span = tile_bits only.
    The same op in f32 (whose FMA arm takes any window) runs."""
    op = _window_op(span, np.random.RandomState(lo + span), lo=lo)
    x = torch.as_tensor(_tile_state(12, 5))
    with pytest.raises(ValueError, match="f64 window op"):
        FG.fused_run(x.clone(), n=12, ops=(op,), tile_bits=12)
    y = x.to(torch.float32)
    out = FG.fused_run(y.clone(), n=12, ops=(op,), tile_bits=12)
    ref = FG.fused_run_plain(y, FG.PreparedRun((op,), 12), n=12, tile_bits=12)
    torch.testing.assert_close(out, ref)


def test_f64_check_accepts_the_planned_windows():
    """The f64 check passes every window the planner folds: the f32 plan's
    two zones at the 2^13 tile ([7, 12) and [12, 13)) run unchanged in
    f32, and at the f64 tile (2^12) the same gates fold into the one zone
    [7, 12), which runs in f64."""
    rng = np.random.RandomState(2)
    ops = ops_from_reference(_one_qubit_gates(7, 12, 25, rng) + _one_qubit_gates(12, 13, 5, rng))
    x = torch.as_tensor(_tile_state(14, 8))
    p32 = FG.PreparedRun(ops, 13)
    assert [o[1:3] for o in p32.ops] == [(7, 5), (12, 1)]
    out = FG.fused_run(x.to(torch.float32), n=14, ops=ops, tile_bits=13, prepared=p32)
    torch.testing.assert_close(out, FG.fused_run_plain(x.to(torch.float32), p32, n=14,
                                                       tile_bits=13))
    ops64 = ops_from_reference(_one_qubit_gates(7, 12, 25, rng))
    p64 = FG.PreparedRun(ops64, 12)
    assert [o[1:3] for o in p64.ops] == [(7, 5)]
    out = FG.fused_run(x.clone(), n=14, ops=ops64, tile_bits=12, prepared=p64)
    torch.testing.assert_close(out, FG.fused_run_plain(x, p64, n=14, tile_bits=12))
