"""The f32 window fold of the port's fused gate run (a dense 2^span x 2^span
unitary on the index bits [lo, lo + span), spans 3-5, ``csrc/fused_gates.cu``:
``window_mma``, 3xTF32 ``mma.sync``) modelled in numpy, against the exact
complex product and the JAX package's Pallas kernel
(``quest_tpu/ops/pallas_gates.py``, the window arm of ``_ops_body``).

The kernel cannot run here. The model walks a tile as the kernel does: the
work items (one slab's n8 block of columns each) dealt to 16 warps in turn,
the m16 tiles of U (rows 8-15 of the one tile at D = 8 zero and not
stored), the k8 steps over e, and the 3xTF32 arithmetic (hi*hi + hi*lo +
lo*hi, lo read as TF32, each ``mma.sync`` summed onto an FP32
accumulator). It reads U from the table the kernel stages: U split into
TF32 hi and lo by the kernel's own index map (transcribed below), which
``chip_lane_u_breakdown.window_split_table`` builds on the host for the
breakdown's host-split variant. Limits: 2e-6 of the largest amplitude
against the exact complex128 product (the card check in ``chip_smoke.py``
takes 1e-5); ``tests/helpers.py``'s f32 tolerance, 2e-4, against the JAX
kernel in interpret mode.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_lane_u_breakdown import window_split_table
from quest_tpu.ops import pallas_gates as PG
from quest_tpu_torch.interop import ops_from_reference
from quest_tpu_torch.ops import fused_gates as FG

from .helpers import assert_amps_close
from .test_torch_kraus_tf32 import _tf32
from .test_torch_lane_u import _haar as _haar_lane, _kernel_model, _lane_block, mma_round, \
    tf32x3_walk
from .test_torch_window_dmma import _haar, _one_qubit_gates, _window_op

WARPS = 16


def _u_block(table, coeffs, span, i=0):
    """U real then imaginary (2 D^2 values) at the head of the i-th op's
    window block: what the f32 kernel reads, rounded to float32 as its
    device copy of the coefficients holds them."""
    D = 1 << span
    off = int(table[i, 6])
    return coeffs[off:off + 2 * D * D].astype(np.float32)


def _kernel_stage(u_block, span):
    """The kernel's staging loop, transcribed: thread item v = (mk, plane,
    lane), mk = mt * ksteps + ks, reads U[d0][e0], U[d0 + 8][e0], U[d0][e0 +
    4], U[d0 + 8][e0 + 4] (the rows d0 + 8 zero when past D) with d0 = 16
    mt + g, e0 = 8 ks + t, splits them, and writes hi at mk * 512 + plane *
    256 + 4 lane, lo 128 floats further. Returns the flat float32 table."""
    D = 1 << span
    ksteps, mtiles = D >> 3, 2 if D > 16 else 1
    u = np.asarray(u_block, dtype=np.float32)
    out = np.full(512 * mtiles * ksteps, np.nan, dtype=np.float32)
    for v in range(64 * mtiles * ksteps):
        lane, plane, mk = v & 31, (v >> 5) & 1, v >> 6
        d0 = 16 * (mk >> (span - 3)) + (lane >> 2)
        e0 = 8 * (mk & (ksteps - 1)) + (lane & 3)
        at = plane * D * D + d0 * D + e0
        pad = d0 + 8 >= D
        a = np.array([u[at], 0.0 if pad else u[at + 8 * D], u[at + 4],
                      0.0 if pad else u[at + 8 * D + 4]], dtype=np.float32)
        hi, lo = FG.tf32_split(a)
        p = mk * 512 + plane * 256 + 4 * lane
        out[p:p + 4], out[p + 128:p + 132] = hi, lo
    return out


def _window_tf32_model(x, table, lo, span, walk="apart", mode="truncate"):
    """The f32 kernel's walk on one tile (``window_mma``), in place: x (2,
    tile) float32; D = 2^span, a slab is the 2^(lo + span) amplitudes with
    the same bits above lo + span, X[a][e][b] = x[(a << (lo + span)) | (e <<
    lo) | b]. Item it = (slab, n8 block) = divmod(it, 2^(lo - 3)), warp w
    taking items w, w + 16, ...; lane (g, t) = divmod(lane, 4). k step ks
    gives the lane X[8 ks + t][b0 + g] and X[8 ks + t + 4][b0 + g] of both
    planes, split into TF32 hi and lo, and of each m16 tile mt its split A
    values from the staged table. Each mma.sync m16n8k8 is its 8 exact
    products summed onto its FP32 accumulator and rounded once (``mode``:
    toward zero, as the card does, or to nearest), in the kernel's order:
    Ur xr, Ur xi, Ui xr, Ui (-xi), each product in the accumulation
    ``walk`` of ``test_torch_lane_u.tf32x3_walk``. The C fragments go to
    rows 16 mt + g (+ 8, below D) of the item's columns. Returns (the
    tile, how often each amplitude was written, the items each warp
    took)."""
    D = 1 << span
    tile = x.shape[1]
    ksteps, mtiles = D >> 3, 2 if D > 16 else 1
    items = tile >> (span + 3)
    tab = np.asarray(table, dtype=np.float32).reshape(mtiles, ksteps, 2, 2, 32, 4)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    # the A operands of each (mt, ks, plane): a[i] = A[g + 8 (i & 1)][t + 4 (i >> 1)]
    A = np.zeros((mtiles, ksteps, 2, 2, 16, 8), dtype=np.float32)
    for i in range(4):
        A[..., g + 8 * (i & 1), t + 4 * (i >> 1)] = tab[..., i]
    A[:, :, :, 1] = _tf32(A[:, :, :, 1])  # lo, read as TF32

    def mma(acc, a, b):
        return mma_round(acc.astype(np.float64) + a.astype(np.float64) @ b.astype(np.float64),
                         mode)

    def product(acc, a, b):
        return tf32x3_walk(acc, a, b, mma, walk=walk)

    out = x.copy()
    written = np.zeros(tile, dtype=int)
    taken = [list(range(w, items, WARPS)) for w in range(WARPS)]
    for it in itertools.chain.from_iterable(taken):
        base = ((it >> (lo - 3)) << (lo + span)) | ((it & ((1 << (lo - 3)) - 1)) << 3)
        accr = np.zeros((mtiles, 16, 8), np.float32)
        acci = np.zeros((mtiles, 16, 8), np.float32)
        for ks in range(ksteps):
            B = []
            for p in (0, 1):
                # b[0] = B[t][g], b[1] = B[t + 4][g]
                b = np.zeros((8, 8), np.float32)
                for j in (0, 1):
                    b[t + 4 * j, g] = out[p, base + ((8 * ks + t + 4 * j) << lo) + g]
                hi, lo_ = FG.tf32_split(b)
                B.append((hi, _tf32(lo_)))
            neg = (-B[1][0], -B[1][1])
            for mt in range(mtiles):
                ur, ui = (tuple(A[mt, ks, p]) for p in (0, 1))
                accr[mt] = product(accr[mt], ur, B[0])
                acci[mt] = product(acci[mt], ur, B[1])
                acci[mt] = product(acci[mt], ui, B[0])
                accr[mt] = product(accr[mt], ui, neg)
        # c[0] = C[g][2t], c[1] = C[g][2t+1], c[2] = C[g+8][2t], c[3] = C[g+8][2t+1]
        for mt in range(mtiles):
            for r in (0, 8):
                if 16 * mt + r >= D:
                    continue  # the zero rows of the one m16 tile at D = 8
                for e in (0, 1):
                    addr = base + ((16 * mt + g + r) << lo) + 2 * t + e
                    out[0, addr] = accr[mt][g + r, 2 * t + e]
                    out[1, addr] = acci[mt][g + r, 2 * t + e]
                    written[addr] += 1
    return out, written, taken


def _exact(x, u, lo):
    """out[a][d][b] = sum_e U[d][e] x[a][e][b] in complex128 on one tile."""
    D = u.shape[0]
    xc = (x[0].astype(np.float64) + 1j * x[1]).reshape(-1, D, 1 << lo)
    out = np.einsum("de,aeb->adb", u, xc).reshape(-1)
    return np.stack([out.real, out.imag])


def _tile_state32(tb, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 1 << tb)
    return (x / np.linalg.norm(x)).astype(np.float32)


@pytest.mark.parametrize("span", [3, 4, 5])
def test_window_tf32_stage_splits_every_entry_once(span):
    """The table the kernel stages from a span 3-5 op's block (its staging
    loop transcribed) is ``window_split_table`` of U, entry for entry; every
    (d, e) of U appears once a plane in hi and once in lo, hi + lo equals
    float32(U) exactly, hi has its low 13 bits clear, and the padding rows
    of the one m16 tile at D = 8 are zero."""
    D = 1 << span
    op = _window_op(span, np.random.RandomState(50 + span))
    table, coeffs = FG.encode_ops((op,))
    ub = _u_block(table, coeffs, span)
    staged = _kernel_stage(ub, span)
    assert not np.isnan(staged).any()
    host = window_split_table(ub, span)
    np.testing.assert_array_equal(staged, host.reshape(-1))
    u32 = ub.reshape(2, D, D)
    seen = np.zeros((2, 2, D, D), dtype=int)
    hi, lo = np.zeros((2, D, D), np.float32), np.zeros((2, D, D), np.float32)
    for mt, ks, p, h, lane, i in itertools.product(range(max(D // 16, 1)), range(D // 8),
                                                   range(2), range(2), range(32), range(4)):
        g, t = divmod(lane, 4)
        d, e = 16 * mt + g + 8 * (i & 1), 8 * ks + t + 4 * (i >> 1)
        v = host[mt, ks, p, h, lane, i]
        if d >= D:
            assert v == 0.0
            continue
        (hi if h == 0 else lo)[p, d, e] = v
        seen[p, h, d, e] += 1
    assert (seen == 1).all()
    np.testing.assert_array_equal(hi + lo, u32)
    assert not (hi.view(np.uint32) & 0x1fff).any()


def _geometries():
    """(lo, span, slabs) of tiles the kernel takes (at most 2^13): spans 3-5,
    slab counts 1, 2 and 4, lo = 7 and 8."""
    return [(lo, span, a) for span, a, lo in itertools.product((3, 4, 5), (1, 2, 4), (7, 8))
            if lo + span + a.bit_length() - 1 <= 13]


@pytest.mark.parametrize("lo,span,slabs", _geometries())
def test_window_tf32_model_matches_exact_product(lo, span, slabs):
    """The f32 kernel's walk on tiles of D = 8, 16 and 32 rows, 1, 2 and 4
    slabs, 128 and 256 columns, reading the table the kernel stages from
    the block ``encode_ops`` writes: the 16 warps take the same number of
    items, every item once, every amplitude of the tile is written once,
    and the tile lands within 2e-6 of the largest amplitude of the exact
    product in complex128."""
    D = 1 << span
    tb = lo + span + slabs.bit_length() - 1
    table, coeffs = FG.encode_ops((_window_op(span, np.random.RandomState(tb + span), lo=lo),))
    ub = _u_block(table, coeffs, span)
    x = _tile_state32(tb, 100 + 10 * lo + span + slabs)
    out, written, taken = _window_tf32_model(x, _kernel_stage(ub, span), lo, span)
    assert len({len(w) for w in taken}) == 1
    assert sorted(itertools.chain.from_iterable(taken)) == list(range(slabs << (lo - 3)))
    assert (written == 1).all()
    off = int(table[0, 6])
    u = (coeffs[off:off + D * D] + 1j * coeffs[off + D * D:off + 2 * D * D]).reshape(D, D)
    exact = _exact(x, u, lo)
    err = np.abs(out - exact).max()
    assert err <= 2e-6 * np.abs(exact).max(), err


#: tiles a norm case sums over (random f32 states at the 2^13 tile)
NORM_TILES = 4
#: the model runs ``fold_norm_changes`` compares: name -> (walk, rounding)
WALKS = {"nearest": ("chained", "nearest"), "chained": ("chained", "truncate"),
         "kernel": ("apart", "truncate")}


def fold_norm_changes(fold, seed):
    """sum |amp|^2 of a fold's output less that of the exact product (the
    same float32 operands in float64), over NORM_TILES random normalised
    f32 tiles of 2^13 amplitudes, one list entry a tile, for: ``"plain"``,
    the FP32 product of the unsplit operands rounded to nearest (complex64,
    as the plain version on the card, FP32 FMA, sums it); and the kernel
    model (``"lane_u"``: a Haar 128 x 128 unitary on the lane qubits;
    ``"window"``: a Haar 32 x 32 one on [7, 12), two slabs) in the runs of
    ``WALKS``: the 3xTF32 products chained and rounded to nearest
    (``"nearest"``: the FP32 sum of the split operands' products), chained
    and truncated toward zero as the card's tensor cores round
    (``"chained"``, the walk before the repair), and the kernel's walk,
    truncated (``"kernel"``)."""
    rng = np.random.RandomState(seed)
    out = {"plain": [], **{k: [] for k in WALKS}}
    if fold == "lane_u":
        u = _haar_lane(128, rng)
        W = np.stack([u.real.T, u.imag.T, u.real.T + u.imag.T])
        table, coeffs = FG.encode_ops((("lane_u", FG.HashableMatrix(W)),))
        _, _, split = _lane_block(table, coeffs)
        u32 = W[0].astype(np.float32) + 1j * W[1].astype(np.float32)
    else:
        table, coeffs = FG.encode_ops((_window_op(5, rng, lo=7),))
        ub = _u_block(table, coeffs, 5)
        staged = _kernel_stage(ub, 5)
        u32 = (ub[:1024] + 1j * ub[1024:]).reshape(32, 32)
    for _ in range(NORM_TILES):
        x = rng.randn(2, 1 << 13)
        x = (x / np.linalg.norm(x)).astype(np.float32)
        if fold == "lane_u":
            xc = (x[0] + 1j * x[1]).reshape(64, 128)
            exact = xc.astype(np.complex128) @ u32.astype(np.complex128)
            plain = xc.astype(np.complex64) @ u32.astype(np.complex64)
            runs = {k: _kernel_model(x[0].reshape(64, 128), x[1].reshape(64, 128), split,
                                     walk=w, mode=m) for k, (w, m) in WALKS.items()}
            runs = {k: np.stack([r, i]) for k, (r, i) in runs.items()}
        else:
            ex = _exact(x, u32.astype(np.complex128), 7)
            exact = ex[0] + 1j * ex[1]
            xc = (x[0] + 1j * x[1]).astype(np.complex64).reshape(-1, 32, 128)
            plain = np.einsum("de,aeb->adb", u32.astype(np.complex64), xc)
            runs = {k: _window_tf32_model(x, staged, 7, 5, walk=w, mode=m)[0]
                    for k, (w, m) in WALKS.items()}
        e2 = np.sum(np.abs(exact) ** 2)
        out["plain"].append(float(np.sum(np.abs(plain.astype(np.complex128)) ** 2) - e2))
        for k, r in runs.items():
            out[k].append(float(np.sum(r.astype(np.float64) ** 2) - e2))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fold", ["lane_u", "window"])
def test_kernel_walk_loses_a_tenth_of_the_chained_walk(fold, seed):
    """Under truncating accumulation (the card's tensor cores) the kernel's
    accumulation walk (``mma_3xtf32``: each product into a zeroed fragment,
    FP32 adds onto the sum) loses, summed over f32 tiles, a tenth or less
    of what the chained walk loses: a fragment's truncation is a unit of
    one product, not of the running sum. It still loses with one sign,
    more than the FP32 product rounded to nearest changes one fold; held
    against the plain version over a whole circuit (its other ops' own
    rounding included), it is phase 15 of ``chip_smoke.py`` that decides,
    on the card, that it drifts at most twice the plain version's way."""
    ch = fold_norm_changes(fold, seed)
    kern = np.abs(ch["kernel"]).sum()
    assert all(d < 0 for d in ch["kernel"]), ch
    assert 10 * kern <= -sum(ch["chained"]), (kern, ch)


def _model_run(prep, x):
    """A prepared run on a one-tile float32 state: window ops of span 3 or
    more through the model of the kernel's walk, every other op through
    the plain version's arm."""
    n = x.shape[1].bit_length() - 1
    cf = torch.as_tensor(prep.coeffs.astype(np.float32))
    loc = torch.arange(1 << n)
    for i, (op, rec) in enumerate(zip(prep.ops, prep.table.tolist())):
        if op[0] == "window" and op[2] >= 3:
            staged = _kernel_stage(_u_block(prep.table, prep.coeffs, op[2], i), op[2])
            x, written, _ = _window_tf32_model(x, staged, op[1], op[2])
            assert (written == 1).all()
        else:
            x = FG._plain_op(torch.as_tensor(x), rec, cf, loc, loc).numpy()
    return x


@pytest.mark.parametrize("order", ["window", "lane_u, window", "window, matrix, lane_u"])
def test_window_tf32_model_matches_reference_kernel(order):
    """25 random one-qubit gates on [7, 12) at 13 qubits, which both
    packages fold into one window op on the zone [7, 12) (D = 32 over the
    two slabs of the 2^13 tile, the main path's shape): alone, after a
    lane_u fold (in the kernel, the lane_u instantiation), and before a 2x2
    controlled from the window's zone and a lane_u fold; the model (the
    lane_u fold and the matrix through the plain version) against the JAX
    kernel in interpret mode in float32."""
    n = 13
    rng = np.random.RandomState(17)
    lane, window = _one_qubit_gates(0, 7, 21, rng), _one_qubit_gates(7, 12, 25, rng)
    ops = {"window": window, "lane_u, window": lane + window,
           "window, matrix, lane_u": window + (
               ("matrix", 3, (8,), (1,), PG.HashableMatrix(_haar(2, rng))),) + lane}[order]
    prep = FG.PreparedRun(ops_from_reference(ops), FG.hopper_tile_bits(n, torch.float32))
    assert ", ".join(o[0] for o in prep.ops) == order
    assert [o[1:3] for o in prep.ops if o[0] == "window"] == [(7, 5)]
    assert prep.staged == (5 if "lane_u" in order else 4)
    x = _tile_state32(n, 70)
    ref = np.asarray(PG.fused_local_run(jnp.asarray(x), n=n, ops=ops, interpret=True))
    assert ref.dtype == np.float32
    assert_amps_close(_model_run(prep, x), ref, tol=2e-4)
