"""The fused-run kernel's 2x2 arm: the host grouping of 2x2 and swap
records into register sweeps (``quest_tpu_torch/ops/fused_gates.py``,
``group_sweeps`` and ``mark_sweeps``) that the kernel
(``csrc/fused_gates.cu``, ``reg_sweep``) reads from the op table, against
the records' own one-at-a-time action and the JAX package's fused run.

The grouping sits below the plan and below the diagonal merge:
``PreparedRun.ops`` stays the JAX fold and ``PreparedRun.records`` the
merged list; only fields of the table that the records' kinds leave free
change. A numpy model of the kernel's register walk (groups, register
bits, controls split between the block, the group and the register
index, a lone swap's quad read and written only where it moves) holds
each sweep against the per-record product within 1e-13 in complex128. Inputs are made with
numpy from a seed. Tolerances as tests/helpers.py's: 1e-10 in f64, 2e-4
in f32.
"""

import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quest_tpu as jq
from quest_tpu import fusion as JF
from quest_tpu.circuits import Circuit as JCircuit
from quest_tpu.ops import pallas_gates as PG
import quest_tpu_torch as tq
from quest_tpu_torch import fusion as F
from quest_tpu_torch.interop import (circuit_from_tape, ops_from_reference,
                                     state_from_numpy, state_to_numpy)
from quest_tpu_torch.ops import fused_gates as FG

from __graft_entry__ import _random_layers

from .test_torch_diag_merge import _diag_ops, _operator_circuit
from .test_torch_fusion import assert_plans_equal

TOLS = {np.float64: 1e-10, np.float32: 2e-4}
DTYPES = {np.float64: torch.float64, np.float32: torch.float32}
#: (state dtype, tile bits) of the CPU cases: f64 at 8, f32 at 9
GEOMS = [(np.float64, 8), (np.float32, 9)]
H = np.array([[1, 1], [1, -1]]) / np.sqrt(2)


def _below_fold(ops, tb):
    """A PreparedRun of ``ops`` as given: the zone fold, which would
    contract runs of 2x2s into lane_u and window ops, skipped."""
    with unittest.mock.patch.object(FG, "_fold_zone_ops", lambda o, t: tuple(o)):
        return FG.PreparedRun(ops, tb)


def _unitary(rng):
    return PG.HashableMatrix(np.linalg.qr(rng.randn(2, 2) + 1j * rng.randn(2, 2))[0])


def _controls(rng, n, exclude, most=3):
    """Up to ``most`` controls anywhere in the n qubits but ``exclude``,
    with random states (anti-controls among them)."""
    others = [c for c in range(n) if c not in exclude]
    ctrl = tuple(int(c) for c in rng.choice(others, rng.randint(most + 1), replace=False))
    return ctrl, tuple(int(s) for s in rng.randint(2, size=len(ctrl)))


def _dense_ops(rng, n, tb, count, span=None):
    """Random non-diagonal 2x2s (some controlled, anti-controls too) and
    swaps (some controlled) on in-tile qubits (``span``: the qubits they
    draw from, default all of the tile), with runs of 0-6 elementwise ops
    between them (``_diag_ops``: controlled phases, parity and diagw ops
    on any qubit, above the tile too)."""
    span = tuple(range(tb)) if span is None else span
    ops = []
    for _ in range(count):
        if rng.rand() < 0.25:
            q1, q2 = (int(q) for q in rng.choice(span, 2, replace=False))
            ctrl, st = _controls(rng, n, (q1, q2), 2)
            ops.append(("swap", q1, q2, ctrl, st))
        else:
            q = int(rng.choice(span))
            ctrl, st = _controls(rng, n, (q,))
            ops.append(("matrix", q, ctrl, st, _unitary(rng)))
        ops += list(_diag_ops(rng, n, rng.randint(7), wide=rng.rand() < 0.2))
    return tuple(ops)


def _breakers(rng, tb):
    """A lane_u fold, a window fold and a kraus1 op: records no sweep
    takes."""
    lane = FG._fold_zone_ops(tuple(("matrix", q % 7, (), (), _unitary(rng))
                                   for q in range(21)), tb)
    window = FG._fold_zone_ops(tuple(("matrix", 7 + q % min(tb - 7, 5), (), (), _unitary(rng))
                                     for q in range(20)), tb)
    K = np.linalg.qr(rng.randn(2, 2) + 1j * rng.randn(2, 2))[0]
    assert [o[0] for o in lane + window] == ["lane_u", "window"]
    return lane + window + (("kraus1", 1, 4, ((1.0, FG.HashableMatrix(K)),)),)


def _mixed(rng, n, tb, pieces=4, count=12):
    """Runs of ``_dense_ops`` split by the breakers."""
    out = ()
    for b in _breakers(rng, tb)[:pieces - 1] + ((),):
        out += ops_from_reference(_dense_ops(rng, n, tb, count)) + ((b,) if b else ())
    return out


def _check_grouping(recs, table, spans, dt, m, tb):
    """Every invariant of one precision's grouping."""
    assert FG.sweep_spans(table, dt) == spans
    covered = np.zeros(len(recs), dtype=int)
    for start, count, qmask in spans:
        members = recs[start:start + count]
        own = FG._mask(FG.op_dense_targets(members[0]))
        assert (bin(qmask).count("1") == m if count > 1 else qmask == own) and qmask < 1 << tb
        # it holds 2x2 and swap records only, and every partner qubit lies in Q
        for r in members:
            assert FG._opens_sweep(r)
            assert all(qmask >> q & 1 for q in FG.op_dense_targets(r))
        covered[start:start + count] += 1
        # it stops only where the next record is no 2x2 or swap, or cannot join it
        end = start + count
        if end < len(recs) and FG._opens_sweep(recs[end]):
            need = {q for r in members for q in FG.op_dense_targets(r)}
            assert len(need | set(FG.op_dense_targets(recs[end]))) > m
    # each 2x2 and swap record lies in exactly one sweep, nothing in two
    assert covered.max() <= 1
    assert all(covered[i] == 1 for i, r in enumerate(recs) if FG._opens_sweep(r))
    assert [s for s, _, _ in spans] == sorted(s for s, _, _ in spans)


@pytest.mark.parametrize("m", [2, 3, 4])
@pytest.mark.parametrize("n,tb", [(10, 8), (11, 9), (12, 9)])
def test_grouping_invariants(n, tb, m):
    """Random runs of 2x2s, swaps and elementwise ops (controls and
    anti-controls in Q, in the tile outside Q and above the tile), split by
    a lane_u fold, a window fold and a kraus op, grouped at width m (f32)
    beside m - 1 (f64) in one table: every sweep's Q holds m qubits with
    every member's partners, no sweep crosses a lane_u, window or kraus
    record, records keep their order, and the records, the table's rows
    and every field but the sweep fields stay as ``encode_ops`` wrote them.
    ``PreparedRun`` writes its grouping (``SWEEP_BITS``) the same way."""
    rng = np.random.RandomState(100 * n + 10 * tb + m)
    ops = _mixed(rng, n, tb)
    prep = _below_fold(ops, tb)
    assert prep.ops == ops and prep.records == FG.merge_diagonals(ops)
    recs = prep.records
    table, coeffs = FG.encode_ops(recs)
    assert prep.table.shape == table.shape and prep.table.shape[0] == len(recs)
    np.testing.assert_array_equal(prep.coeffs, coeffs)
    for dt in (torch.float32, torch.float64):
        assert prep.sweeps[dt] == FG.group_sweeps(recs, FG.SWEEP_BITS[dt], tb)
        assert FG.sweep_spans(prep.table, dt) == prep.sweeps[dt]
    sweeps = {torch.float32: FG.group_sweeps(recs, m, tb),
              torch.float64: FG.group_sweeps(recs, max(m - 1, 2), tb)}
    marked = table.copy()
    FG.mark_sweeps(marked, sweeps)
    heads = sorted({s for spans in sweeps.values() for s, _, _ in spans})
    rest = np.ones(table.shape, dtype=bool)
    rest[heads, 5] = rest[heads, 7] = False
    np.testing.assert_array_equal(marked[rest], table[rest])
    np.testing.assert_array_equal(marked[heads, 7] & 0xffff, table[heads, 7])
    assert (table[heads, 5] == 0).all()
    for dt, w in ((torch.float32, m), (torch.float64, max(m - 1, 2))):
        _check_grouping(recs, marked, sweeps[dt], dt, w, tb)
        # the breakers stand between sweeps
        kinds = [r[0] for r in recs]
        for b in ("lane_u", "window", "kraus1"):
            i = kinds.index(b)
            assert not any(s <= i < s + c for s, c, _ in sweeps[dt])
    # runs of 2x2s on more qubits than m: several sweeps
    assert len(sweeps[torch.float32]) > len(ops) // 20


def test_grouping_is_greedy_and_pads_q_above_bit_4():
    """A hand-made run: 2x2s on 7 and 8 (controlled from 3), a swap of 7 and
    9 (controlled from above the tile), a 2x2 on 10 (a fourth qubit), T,
    then a CNOT on 8 from 5: at the f32 width (m = 3) three sweeps, T
    between the second and the third; at the f64 width (m = 2) four (7 and
    8 fill Q); at m = 4 two. A sweep of several records has Q padded from
    qubit 5 up, a lone record keeps its own qubits (a pair or a quad)."""
    T = FG.HashableMatrix(np.diag([1, np.exp(0.25j * np.pi)]))
    X = FG.HashableMatrix(np.array([[0, 1], [1, 0]]))
    ops = (("matrix", 7, (), (), FG.HashableMatrix(H)),
           ("matrix", 8, (3,), (0,), FG.HashableMatrix(H)), ("swap", 7, 9, (12,), (1,)),
           ("matrix", 10, (), (), FG.HashableMatrix(H)), ("matrix", 5, (), (), T),
           ("matrix", 8, (5,), (1,), X), ("parity", (1, 2), (), 0.3))
    prep = _below_fold(ops, 12)
    assert [r[0] for r in prep.records] == ["matrix", "matrix", "swap", "matrix", "diagw",
                                            "matrix", "diagw"]
    assert prep.sweeps[torch.float32] == ((0, 3, 0b1110000000), (3, 1, 0b10000000000),
                                          (5, 1, 0b100000000))
    assert prep.sweeps[torch.float64] == ((0, 2, 0b110000000), (2, 1, 0b1010000000),
                                          (3, 1, 0b10000000000), (5, 1, 0b100000000))
    assert FG.group_sweeps(prep.records, 4, 12) == ((0, 4, 0b11110000000),
                                                    (5, 1, 0b100000000))
    # a sweep of several records: Q padded from qubit 5 up
    assert FG.group_sweeps(prep.records[:2], 3, 12) == ((0, 2, 0b110100000),)
    assert prep.table[0, 5] == 0b1110000000 | 0b110000000 << 16
    assert prep.table[0, 7] == 1 << 1 | 3 << 16 | 2 << 32  # H: the real form
    assert FG.sweep_spans(prep.table, torch.float64) == prep.sweeps[torch.float64]
    with pytest.raises(ValueError, match="2 to 4 qubits"):
        FG.group_sweeps(prep.records, 5, 12)


def test_matrix_forms():
    """``encode_ops`` marks each 2x2's arithmetic form for the 2x2 arm in
    r[7] bits 1-2 (X 3, real 1, any other 0: an Rx too), beside bit 0 (a
    diagonal matrix), which the plain version and the diagonal arm read."""
    th = 0.7
    rx = np.array([[np.cos(th), -1j * np.sin(th)], [-1j * np.sin(th), np.cos(th)]])
    mats = [(3, np.array([[0, 1], [1, 0]])), (1, H), (0, rx),
            (0, np.linalg.qr(np.random.RandomState(1).randn(2, 2) + 1j)[0])]
    for form, m in mats:
        t, _ = FG.encode_ops((("matrix", 7, (), (), FG.HashableMatrix(m)),))
        assert t[0, 7] == form << 1
    t, _ = FG.encode_ops((("matrix", 7, (), (), FG.HashableMatrix(np.diag([1, 1j]))),))
    assert t[0, 7] & 1 == 1


# ---------------------------------------------------------------------------
# a numpy model of the kernel's register sweep
# ---------------------------------------------------------------------------

def _bits(mask):
    return [q for q in range(mask.bit_length()) if mask >> q & 1]


def _kernel_sweep(x, table, cf, start, count, qmask, tb, shard_base=0):
    """One sweep as ``reg_sweep`` (or, for one record, ``reg_lone``) walks
    it, on the complex128 shard ``x`` (all of its tiles at once): a group
    per thread (its index with zeros inserted at Q's bits), register a at
    index bits ``qbit[j]`` for each set bit j of a, each record on the
    registers in turn. A lone swap reads and writes registers 1 and 2 of
    its quad only (the others hold NaN, so a record that acts on one
    shows)."""
    tile = 1 << tb
    qbit = [1 << q for q in _bits(qmask)]
    W = len(qbit)
    base = np.arange(tile >> W)
    for b in qbit:
        low = base & (b - 1)
        base = ((base - low) << 1) | low
    regs_at = [sum(qbit[j] for j in range(W) if a >> j & 1) for a in range(1 << W)]
    tiles = np.arange(x.size >> tb)[:, None]
    idx = (tiles << tb) | base[None, :]
    regs = 0b0110 if count == 1 and table[start, 0] == FG._KIND["swap"] else (1 << (1 << W)) - 1
    X = [x[idx | r] if regs >> a & 1 else np.full(idx.shape, np.nan)
         for a, r in enumerate(regs_at)]
    role = (shard_base | (tiles << tb)).astype(np.int64)
    above = ~(tile - 1)
    for rec in table[start:start + count]:
        kind, a_, b_, cmask, cval, pmask, off, flags = (int(v) for v in rec)
        assert kind in (FG._KIND["matrix"], FG._KIND["swap"]) and not flags & 1
        tile_ok = (role & cmask & above) == (cval & above)
        lmask, lval = cmask & (tile - 1), cval & (tile - 1)
        sel = tile_ok & ((base & lmask) == (lval & ~qmask))[None, :]
        cm = sum(1 << j for j in range(W) if lmask & qbit[j])
        cv = sum(1 << j for j in range(W) if lval & qbit[j])
        if kind == FG._KIND["matrix"]:
            j = bin(qmask & ((1 << a_) - 1)).count("1")
            m = cf[off:off + 8:2] + 1j * cf[off + 1:off + 8:2]
            for a in range(1 << W):
                if a >> j & 1 or (a & cm) != cv:
                    continue
                b = a | 1 << j
                x0, x1 = X[a], X[b]
                X[a] = np.where(sel, m[0] * x0 + m[1] * x1, x0)
                X[b] = np.where(sel, m[2] * x0 + m[3] * x1, x1)
        else:
            j1, j2 = sorted(bin(qmask & ((1 << q) - 1)).count("1") for q in (a_, b_))
            for a in range(1 << W):
                if not a >> j1 & 1 or a >> j2 & 1 or (a & cm) != cv:
                    continue
                b = a ^ (1 << j1) ^ (1 << j2)
                X[a], X[b] = np.where(sel, X[b], X[a]), np.where(sel, X[a], X[b])
    out = x.copy()
    for a, (r, v) in enumerate(zip(regs_at, X)):
        if regs >> a & 1:
            out[idx | r] = v
    return out


def _per_record(x, records, table, cf, start, count, n_local, shard_index=0):
    """The same records one at a time, as the plain version applies them
    (``_plain_op``), in float64 planes."""
    loc = torch.arange(1 << n_local)
    idx = loc | (shard_index << n_local)
    t = torch.tensor(np.stack([x.real, x.imag]))
    c = torch.tensor(cf)
    for rec in table[start:start + count].tolist():
        t = FG._plain_op(t, rec, c, idx, loc)
    return t[0].numpy() + 1j * t[1].numpy()


@pytest.mark.parametrize("m", [2, 3, 4])
@pytest.mark.parametrize("n,tb,shard", [(10, 8, 0), (11, 9, 0), (12, 9, 0), (10, 9, 5)])
def test_each_sweep_is_exact(n, tb, shard, m):
    """Each sweep's records, applied as the kernel applies them (the numpy
    model of ``reg_sweep`` and ``reg_lone``), equal the records applied one
    at a time within 1e-13 in complex128: 2x2s and swaps with controls in
    Q, in the tile outside Q and above the tile, lone ones among them; on
    one device and on one shard of a larger state (roles above the shard
    read its index)."""
    rng = np.random.RandomState(7 * n + tb + m + shard)
    ops = _mixed(rng, n + 3, tb, pieces=2, count=20)
    prep = _below_fold(ops, tb)
    x = rng.randn(1 << n) + 1j * rng.randn(1 << n)
    spans = FG.group_sweeps(prep.records, m, tb)
    assert sum(c for _, c, _ in spans) > 20
    kinds = {prep.records[i][0] for s, c, _ in spans for i in range(s, s + c)}
    assert kinds == {"matrix", "swap"}
    assert {c > 1 for _, c, _ in spans} == {True, False}
    for start, count, qmask in spans:
        got = _kernel_sweep(x, prep.table, prep.coeffs, start, count, qmask, tb,
                            shard_base=shard << n)
        want = _per_record(x, prep.records, prep.table, prep.coeffs, start, count, n, shard)
        assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()


# ---------------------------------------------------------------------------
# the plain version on the grouped encoding against the JAX package
# ---------------------------------------------------------------------------

def _reference_run(rng, n, tb):
    """A run the JAX kernel takes: 2x2s and swaps with controls on in-tile
    qubits among elementwise ops, one lane-zone stretch that folds."""
    lane = tuple(("matrix", q % 7, (), (), _unitary(rng)) for q in range(14))
    return (_dense_ops(rng, n, tb, 6) + lane + _dense_ops(rng, n, tb, 4, span=(0, 3, tb - 1))
            + (("matrix", 2, (n - 1,), (1,), PG.HashableMatrix(H)),))


@pytest.mark.parametrize("dtype,tb,n", [(np.float64, 8, 10), (np.float32, 9, 12)],
                         ids=["f64", "f32"])
def test_plain_on_grouped_encoding_matches_reference_kernel(dtype, tb, n):
    """fused_run_plain on the grouped encoding against the JAX kernel
    (fused_local_run, interpret mode) on one device, at the JAX geometry
    ``tb``."""
    ops = _reference_run(np.random.RandomState(n + tb), n, tb)
    sub = 1 << (tb - 7)
    assert PG.local_qubits(n, sublanes=sub) == tb
    state = np.random.default_rng(n).normal(size=(2, 1 << n)).astype(dtype)
    ref = np.asarray(PG.fused_local_run(jnp.asarray(state), n=n, ops=ops, sublanes=sub,
                                        interpret=True))
    prep = FG.PreparedRun(ops_from_reference(ops), tb)
    assert len(prep.sweeps[DTYPES[dtype]]) > 3
    got = FG.fused_run(state_from_numpy(state, "cpu"), n=n, ops=ops_from_reference(ops),
                       tile_bits=tb, prepared=prep).numpy()
    tol = TOLS[dtype]
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("dtype,d", [(np.float64, 2), (np.float32, 4), (np.float64, 8)],
                         ids=["f64-2", "f32-4", "f64-8"])
def test_plain_on_grouped_encoding_per_shard_matches_reference_kernel(dtype, d):
    """Each shard's pass of fused_run_plain on the grouped encoding (roles
    at and above local_n from the shard index) against the JAX per-shard
    kernel in interpret mode, over 2, 4 and 8 shards of 11 qubits."""
    n = 11
    nl = n - (d.bit_length() - 1)
    tb = PG.local_qubits(nl, sublanes=2)
    ops = _reference_run(np.random.RandomState(40 + d), n, tb)
    assert any(q >= nl for o in ops for q in FG._op_support(o) - set(FG.op_dense_targets(o)))
    state = np.random.default_rng(d).normal(size=(2, 1 << n)).astype(dtype)
    prep = FG.PreparedRun(ops_from_reference(ops), tb)
    tol = TOLS[dtype]
    for r, shard in enumerate(np.split(state, d, axis=1)):
        ref = np.asarray(PG.fused_local_run(jnp.asarray(shard), n=nl, ops=ops, sublanes=2,
                                            shard_index=r, interpret=True))
        got = FG.fused_run_plain(torch.tensor(shard), prep, n=n, tile_bits=tb, local_n=nl,
                                 shard_index=r)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=tol * max(np.abs(ref).max(), 1.0))


def _density_flat(rho):
    f = rho.T.reshape(-1)
    return np.stack([f.real, f.imag])


def test_density_run_matches_reference():
    """A 5-qubit density register: Hadamards, Rx, CNOTs, a swap and
    phases fused into runs whose 2x2s (and their conj shadows) group into
    sweeps, with a dephasing channel, against the JAX package's fused run."""
    n = 5
    jc = JCircuit(n, is_density_matrix=True)
    for q in range(n):
        jc.hadamard(q)
    jc.rotateX(1, 0.4)
    jc.controlledNot(0, 2)
    jc.tGate(2)
    jc.controlledNot(2, 3)
    jc.rotateZ(3, 0.7)
    jc.swapGate(1, 4)
    jc.mixDephasing(2, 0.2)
    jc.rotateX(4, -1.1)
    jc.controlledNot(4, 0)
    jc.sGate(1)
    jc.hadamard(3)
    tc = circuit_from_tape(jc._tape, n, True)
    tfz = tc.fused(max_qubits=4, pallas=True, dtype=torch.float64)
    runs = [a[0] for f, a, _ in tfz._tape if f is F._apply_pallas_run]
    assert any(c > 1 for r in runs for _, c, _ in r.prepare().sweeps[torch.float64])
    rng = np.random.RandomState(n)
    a = rng.randn(1 << n, 1 << n) + 1j * rng.randn(1 << n, 1 << n)
    rho0 = a @ a.conj().T
    rho0 /= np.trace(rho0)
    j = jq.createDensityQureg(n, jq.createQuESTEnv(jax.devices()[:1]))
    j.put(jnp.asarray(_density_flat(rho0)))
    jc.run(j)
    t = tq.createDensityQureg(n, tq.createQuESTEnv(device="cpu"), 2)
    t.put(state_from_numpy(_density_flat(rho0), "cpu"))
    tfz.run(t)
    ref = np.asarray(j.amps)
    np.testing.assert_allclose(state_to_numpy(t), ref, rtol=0,
                               atol=1e-10 * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("kind,n,tb", [("layers", 11, 9), ("trotter", 10, 8), ("qft", 11, 9)])
def test_circuits_fuse_and_group(kind, n, tb):
    """The main path's ``random_layers``, a ZZ-ring ``applyTrotterCircuit``
    and an ``applyFullQFT`` tape planned by ``Circuit.fused(pallas=True)``:
    the plan still equals the JAX plan, its runs' 2x2s group into sweeps,
    and the fused run matches the JAX package's run of its plan."""
    if kind == "layers":
        jc = JCircuit(n)
        _random_layers(jc, n, depth=2, seed=n)
    else:
        jc = _operator_circuit(kind, n)
    tc = circuit_from_tape(jc._tape, n)
    ref = JF._plan_pallas(tuple(jc._tape), n, np.float64, 5, tb)
    got = F._plan_pallas(tuple(tc._tape), n, torch.float64, 5, tb)
    assert_plans_equal(ref, got)
    runs = [i for i in got.items if isinstance(i, F.PallasRun)]
    for r in runs:
        p = r.prepare()
        assert p.records == FG.merge_diagonals(p.ops) and p.table.shape[0] == len(p.records)
    twos = sum(FG._opens_sweep(o) for r in runs for o in r.prepare().records)
    sweeps = sum(len(r.prepare().sweeps[torch.float64]) for r in runs)
    assert 0 < sweeps < twos
    v = np.random.RandomState(n).randn(1 << n) + 1j * np.random.RandomState(n + 1).randn(1 << n)
    v /= np.linalg.norm(v)
    jqr = jq.createQureg(n, jq.createQuESTEnv(jax.devices()[:1]), 2)
    jq.initStateFromAmps(jqr, v.real, v.imag)
    for f, a, kw in JF.as_tape(ref):
        f(jqr, *a, **kw)
    tqr = tq.createQureg(n, tq.createQuESTEnv(device="cpu"), 2)
    tq.initStateFromAmps(tqr, v.real, v.imag)
    tc.fused(max_qubits=5, pallas=True, dtype=torch.float64, tile_bits=tb).run(tqr)
    want = np.asarray(jqr.amps)
    np.testing.assert_allclose(state_to_numpy(tqr), want, rtol=0, atol=1e-10)


@pytest.mark.cuda
def test_two_by_two_arm_matches_plain_on_card():
    """The kernel's 2x2 arm against its plain version on the card: random
    runs of 2x2s, swaps and elementwise ops with controls everywhere, split
    by lane_u and window folds, at tiles of 2^7 to 2^13 (f32) and 2^12
    (f64); a run on qubits 0-4 (bank conflicts), and one shard of a
    sharded state; f32 and f64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = 16
    rng = np.random.RandomState(12)
    for dt, tbs, tol in ((torch.float32, (7, 9, 10, 13), 1e-5),
                         (torch.float64, (7, 8, 11, 12), 1e-12)):
        for tb in tbs:
            ops = ops_from_reference(_dense_ops(rng, n, tb, 40))
            if tb >= 9:
                ops = _mixed(rng, n, tb, pieces=3, count=15)
            prep = _below_fold(ops, tb)
            x = torch.as_tensor(rng.randn(2, 1 << n), dtype=dt, device="cuda")
            x /= x.norm()
            ref = FG.fused_run_plain(x, prep, n=n, tile_bits=tb)
            before = FG.fused_run.launches
            got = FG.fused_run(x, n=n, ops=ops, tile_bits=tb, out=torch.empty_like(x),
                               prepared=prep)
            torch.cuda.synchronize()
            assert FG.fused_run.launches == before + 1
            err = (got - ref).abs().max().item()
            assert err <= tol * ref.abs().max().item(), (dt, tb, err)
        tb = tbs[-1]
        low = ops_from_reference(_dense_ops(rng, n, tb, 30, span=(0, 1, 2, 3, 4)))
        prep = _below_fold(low, tb)
        x = torch.as_tensor(rng.randn(2, 1 << n), dtype=dt, device="cuda")
        ref = FG.fused_run_plain(x, prep, n=n, tile_bits=tb)
        got = FG.fused_run(x.clone(), n=n, ops=low, tile_bits=tb, prepared=prep)
        torch.cuda.synchronize()
        assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()
        ops = _mixed(rng, n + 2, tb, pieces=2)
        prep = _below_fold(ops, tb)
        x = torch.as_tensor(rng.randn(2, 1 << n), dtype=dt, device="cuda")
        ref = FG.fused_run_plain(x, prep, n=n + 2, tile_bits=tb, local_n=n, shard_index=3)
        got = FG.fused_run(x.clone(), n=n + 2, ops=ops, tile_bits=tb, prepared=prep,
                           local_n=n, shard_index=3)
        torch.cuda.synchronize()
        assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()
