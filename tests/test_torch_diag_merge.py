"""The fused-run kernel's diagonal arm: the host merge of each run of
diagonal ops into ``diagw`` tables (``quest_tpu_torch/ops/fused_gates.py``,
``merge_diagonals``) that the kernel (``csrc/fused_gates.cu``,
``diag_sweep``) and its plain version read, against the ops' own
definitions and the JAX package's fused run.

The merge sits below the plan: ``PreparedRun.ops`` stays the JAX fold, and
the plan stays equal to the JAX plan; only ``PreparedRun.records``, what
the kernel and ``fused_run_plain`` read, changes. Inputs are made with
numpy from a seed. Tolerances as tests/helpers.py's: 1e-10 in f64, 2e-4 in
f32; the merged tables against the per-op product within 1e-13 in
complex128 (each table is built in complex128 and rounded once).
"""

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

from .test_torch_fusion import assert_plans_equal

TOLS = {np.float64: 1e-10, np.float32: 2e-4}
#: (state dtype, tile bits) of the CPU cases: f64 at 8, f32 at 9
GEOMS = [(np.float64, 8), (np.float32, 9)]
H = np.array([[1, 1], [1, -1]]) / np.sqrt(2)


def _phase_diag(rng):
    return PG.HashableMatrix(np.diag(np.exp(1j * rng.uniform(-np.pi, np.pi, 2))))


def _diag_ops(rng, n, count, wide=True):
    """Random elementwise ops on n qubits (any qubit, above the tile too):
    diagonal 2x2s with controls and anti-controls, parity ops (some
    controlled), diagw ops (some controlled); with ``wide``, also ops whose
    qubits and controls exceed a table (a phase with 9 controls, a parity
    over 10 qubits), which stay as they are."""
    ops = []
    for _ in range(count):
        kind = rng.randint(4 if wide else 3)
        if kind == 0:
            q = int(rng.randint(n))
            others = [c for c in range(n) if c != q]
            ctrl = tuple(int(c) for c in rng.choice(others, rng.randint(4), replace=False))
            states = tuple(int(s) for s in rng.randint(2, size=len(ctrl)))
            ops.append(("matrix", q, ctrl, states, _phase_diag(rng)))
        elif kind == 1:
            qs = rng.choice(n, rng.randint(1, 5), replace=False)
            k = rng.randint(len(qs))
            ops.append(("parity", tuple(int(q) for q in qs[k:]), tuple(int(c) for c in qs[:k]),
                        float(rng.uniform(-3, 3))))
        elif kind == 2:
            qs = rng.choice(n, rng.randint(1, 6), replace=False)
            t = rng.randint(1, min(len(qs), 3) + 1)
            ops.append(("diagw", tuple(int(q) for q in qs[:t]), tuple(int(c) for c in qs[t:]),
                        PG.HashableMatrix(np.exp(1j * rng.uniform(-np.pi, np.pi, 1 << t)))))
        else:
            qs = [int(q) for q in rng.choice(n, 10, replace=False)]
            if rng.rand() < 0.5:
                ops.append(("matrix", qs[0], tuple(qs[1:]),
                            tuple(int(s) for s in rng.randint(2, size=9)), _phase_diag(rng)))
            else:
                ops.append(("parity", tuple(qs), (), float(rng.uniform(-3, 3))))
    return tuple(ops)


def _definition(op, n):
    """The diagonal of an elementwise op over the whole 2^n index, from its
    definition, complex128 (written apart from the merge's own code)."""
    idx = np.arange(1 << n)

    def bit(q):
        return (idx >> q) & 1

    if op[0] == "matrix":
        _, q, ctrl, states, m = op
        states = states or (1,) * len(ctrl)
        m = np.asarray(m.arr)
        d = np.where(bit(q) == 1, m[1, 1], m[0, 0])
    elif op[0] == "parity":
        _, qs, ctrl, theta = op
        states = (1,) * len(ctrl)
        z = np.ones(idx.size)
        for q in qs:
            z = z * (1 - 2 * bit(q))
        d = np.exp(-0.5j * theta * z)
    else:
        _, ts, ctrl, table = op
        states = (1,) * len(ctrl)
        d = np.asarray(table.arr).reshape(-1)[sum(bit(q) << j for j, q in enumerate(ts))]
    for c, s in zip(ctrl, states):
        d = np.where(bit(c) == s, d, 1.0)
    return d


def _product(ops, n):
    d = np.ones(1 << n, dtype=complex)
    for op in ops:
        d = d * _definition(op, n)
    return d


@pytest.mark.parametrize("n", [10, 11, 12])
@pytest.mark.parametrize("bits", [3, 5, 8])
def test_merge_is_exact(n, bits):
    """A run of 60 elementwise ops merges into fewer records whose product
    equals the per-op product within 1e-13 in complex128: every record a
    ``diagw`` table of at most ``bits`` qubits, controls as index bits,
    but the ops wider than a table, which stay as they are."""
    rng = np.random.RandomState(n * 10 + bits)
    ops = ops_from_reference(_diag_ops(rng, n, 60))
    records = FG.merge_diagonals(ops, bits)
    assert len(records) < len(ops)
    wide = [o for o in ops if len(FG._op_support(o)) > bits]
    assert wide and [r for r in records if len(FG._op_support(r)) > bits] == wide
    for r in records:
        if len(FG._op_support(r)) <= bits:
            assert r[0] == "diagw" and r[2] == () and list(r[1]) == sorted(r[1])
    err = np.abs(_product(records, n) - _product(ops, n)).max()
    assert err <= 1e-13, err


def test_merge_never_crosses_non_diagonal_ops():
    """Diagonal runs split by 2x2s, swaps and a folded window: the
    non-diagonal ops keep their order, and each run between two of them
    merges into records of that run alone."""
    n = 11
    rng = np.random.RandomState(4)
    breakers = [("matrix", 3, (), (), PG.HashableMatrix(H)), ("swap", 1, 6, (9,), (0,)),
                ("matrix", 8, (2,), (0,), PG.HashableMatrix(H))]
    ops, runs = [], []
    for b in breakers + [None]:
        run = _diag_ops(rng, n, 15)
        ops += list(run)
        runs.append(ops_from_reference(run))
        if b is not None:
            ops.append(b)
    ops = ops_from_reference(tuple(ops))
    records = FG.merge_diagonals(ops)
    cuts = [i for i, r in enumerate(records) if not FG._op_is_diag(r)]
    assert tuple(records[i] for i in cuts) == ops_from_reference(tuple(breakers))
    pieces = np.split(np.arange(len(records)), cuts)
    for run, piece in zip(runs, pieces):
        merged = [records[i] for i in piece if FG._op_is_diag(records[i])]
        assert len(merged) < len(run)
        assert np.abs(_product(merged, n) - _product(run, n)).max() <= 1e-13


def test_prepared_run_keeps_the_fold_and_stages_the_tables():
    """``PreparedRun.ops`` is the fold (the plan's work); ``records`` the
    merged list, one table row each; ``staged`` bit 3 marks a run with an
    elementwise record, and only such a run."""
    rng = np.random.RandomState(2)
    diag = ops_from_reference(_diag_ops(rng, 12, 30, wide=False))
    lane = tuple(("matrix", q % 7, (), (), FG.HashableMatrix(np.linalg.qr(
        rng.randn(2, 2) + 1j * rng.randn(2, 2))[0])) for q in range(21))
    prep = FG.PreparedRun(lane + diag, 9)
    assert prep.ops == FG._fold_zone_ops(lane + diag, 9)
    assert prep.records == FG.merge_diagonals(prep.ops)
    assert prep.table.shape[0] == len(prep.records) < len(prep.ops)
    assert prep.staged == 1 | 8
    assert FG.PreparedRun(lane, 9).staged == 1
    narrow = FG.PreparedRun(diag, 9, diag_bits=2)
    assert narrow.records == FG.merge_diagonals(narrow.ops, 2)
    assert max(len(r[1]) for r in narrow.records if r[0] == "diagw" and not r[2]) <= 2


def test_encode_takes_tables_of_up_to_8_qubits():
    table = PG.HashableMatrix(np.exp(1j * np.arange(256)))
    t, c = FG.encode_ops((("diagw", tuple(range(8)), (), table),))
    assert t[0, 1] == 8 and t[0, 2] == sum(q << (6 * q) for q in range(8))
    np.testing.assert_array_equal(c[:512].reshape(-1, 2),
                                  np.stack([table.arr.real, table.arr.imag], axis=1))
    with pytest.raises(ValueError, match="2\\^t <= 256"):
        FG.encode_ops((("diagw", tuple(range(9)), (), PG.HashableMatrix(np.ones(512))),))
    with pytest.raises(ValueError, match="0 to 8 qubits"):
        FG.merge_diagonals((), 9)


def _mixed_run(rng, n):
    """Diagonal runs (some ops wider than a table) between 2x2s on in-tile
    targets, lane-zone gates that fold, and a controlled swap."""
    lane = tuple(("matrix", q % 7, (), (), PG.HashableMatrix(np.linalg.qr(
        rng.randn(2, 2) + 1j * rng.randn(2, 2))[0])) for q in range(14))
    return (_diag_ops(rng, n, 25) + (("matrix", 7, (n - 1,), (1,), PG.HashableMatrix(H)),)
            + _diag_ops(rng, n, 25) + lane + _diag_ops(rng, n, 10)
            + (("swap", 2, 5, (), ()),) + _diag_ops(rng, n, 20))


@pytest.mark.parametrize("dtype,tb", GEOMS, ids=["f64", "f32"])
@pytest.mark.parametrize("n", [10, 12])
def test_plain_on_merged_records_matches_reference_kernel(dtype, tb, n):
    """fused_run_plain on the merged encoding against the JAX kernel
    (fused_local_run, interpret mode) on one device, at the JAX geometry
    ``tb``."""
    ops = _mixed_run(np.random.RandomState(n + tb), n)
    sub = 1 << (tb - 7)
    assert PG.local_qubits(n, sublanes=sub) == tb
    state = np.random.default_rng(n).normal(size=(2, 1 << n)).astype(dtype)
    ref = np.asarray(PG.fused_local_run(jnp.asarray(state), n=n, ops=ops, sublanes=sub,
                                        interpret=True))
    prep = FG.PreparedRun(ops_from_reference(ops), tb)
    assert len(prep.records) < len(prep.ops)
    got = FG.fused_run(state_from_numpy(state, "cpu"), n=n, ops=ops_from_reference(ops),
                       tile_bits=tb, prepared=prep).numpy()
    tol = TOLS[dtype]
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_plain_on_merged_records_per_shard_matches_reference_kernel(dtype, d):
    """Each shard's pass of fused_run_plain on the merged encoding (roles at
    and above local_n from the shard index) against the JAX per-shard
    kernel in interpret mode, over 2, 4 and 8 shards of 12 qubits."""
    n = 12
    nl = n - (d.bit_length() - 1)
    ops = _mixed_run(np.random.RandomState(30 + d), n)
    assert any(q >= nl for o in ops if FG._op_is_diag(o) for q in FG._op_support(o))
    state = np.random.default_rng(d).normal(size=(2, 1 << n)).astype(dtype)
    tb = PG.local_qubits(nl, sublanes=4)
    prep = FG.PreparedRun(ops_from_reference(ops), tb)
    tol = TOLS[dtype]
    for r, shard in enumerate(np.split(state, d, axis=1)):
        ref = np.asarray(PG.fused_local_run(jnp.asarray(shard), n=nl, ops=ops, sublanes=4,
                                            shard_index=r, interpret=True))
        got = FG.fused_run_plain(torch.tensor(shard), prep, n=n, tile_bits=tb, local_n=nl,
                                 shard_index=r)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=tol * max(np.abs(ref).max(), 1.0))


def _density_flat(rho):
    f = rho.T.reshape(-1)
    return np.stack([f.real, f.imag])


def test_density_dephasing_run_matches_reference():
    """A 5-qubit density register: diagonal gates, controlled phases and
    ``mixDephasing`` fused into runs whose diagonal ops merge, against the
    JAX package's fused run."""
    n = 5
    jc = JCircuit(n, is_density_matrix=True)
    for q in range(n):
        jc.hadamard(q)
    jc.tGate(0)
    jc.rotateZ(3, 0.7)
    jc.controlledPhaseShift(1, 4, 0.3)
    jc.mixDephasing(2, 0.2)
    jc.controlledPhaseFlip(0, 3)
    jc.mixDephasing(4, 0.1)
    jc.phaseShift(2, -0.9)
    jc.mixTwoQubitDephasing(0, 1, 0.15)
    jc.sGate(1)
    tc = circuit_from_tape(jc._tape, n, True)
    tfz = tc.fused(max_qubits=4, pallas=True, dtype=torch.float64)
    runs = [a[0] for f, a, _ in tfz._tape if f is F._apply_pallas_run]
    assert any(len(r.prepare().records) < len(r.prepare().ops) for r in runs)
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


def _operator_circuit(kind, n):
    jc = JCircuit(n)
    for q in range(n):
        jc.hadamard(q)
    if kind == "qft":
        jc.applyFullQFT()
    else:
        h = jq.createPauliHamil(n, n + 2)
        codes = [[3 if q in (i, (i + 1) % n) else 0 for q in range(n)] for i in range(n)]
        codes += [[1] * n, [2, 1] + [0] * (n - 3) + [3]]
        jq.initPauliHamil(h, list(np.linspace(-0.9, 0.8, n + 2)), codes)
        jc.applyTrotterCircuit(h, 0.4, 2, 2)
    return jc


@pytest.mark.parametrize("kind,n,tb", [("qft", 10, 8), ("qft", 12, 9), ("trotter", 10, 8),
                                       ("trotter", 11, 9)])
def test_operator_tapes_fuse_and_merge(kind, n, tb):
    """``applyFullQFT`` and a ZZ-ring ``applyTrotterCircuit`` tape planned by
    ``Circuit.fused(pallas=True)``: the plan still equals the JAX plan, its
    runs' controlled phases and parity ops merge into fewer records, and
    the fused run matches the JAX package's run of its plan."""
    jc = _operator_circuit(kind, n)
    tc = circuit_from_tape(jc._tape, n)
    ref = JF._plan_pallas(tuple(jc._tape), n, np.float64, 5, tb)
    got = F._plan_pallas(tuple(tc._tape), n, torch.float64, 5, tb)
    assert_plans_equal(ref, got)
    runs = [i for i in got.items if isinstance(i, F.PallasRun)]
    ops = sum(len(r.prepare().ops) for r in runs)
    records = sum(len(r.prepare().records) for r in runs)
    assert records < ops
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
def test_diagonal_arm_matches_plain_on_card():
    """The kernel's diagonal arm against its plain version on the card:
    random elementwise runs (some ops wider than a table) between 2x2s and
    lane_u folds, at tiles of 2^7 to 2^13 (f32) and 2^12 (f64), tables of
    2 to 8 qubits, a run longer than one staged chunk, and one shard of a
    sharded state, f32 and f64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = 16
    rng = np.random.RandomState(9)
    for dt, tbs, tol in ((torch.float32, (7, 9, 10, 13), 1e-5),
                         (torch.float64, (7, 8, 11, 12), 1e-12)):
        for tb in tbs:
            # the mixed run's 2x2 targets qubit 7: tiles of 2^8 and up
            cases = ((8, _mixed_run(rng, n)),) if tb > 7 else ()
            for bits, ops in cases + ((2, _diag_ops(rng, n, 150)),
                                      (8, _diag_ops(rng, n, 300, wide=False))):
                ops = ops_from_reference(ops)
                prep = FG.PreparedRun(ops, tb, diag_bits=bits)
                x = torch.as_tensor(rng.randn(2, 1 << n), dtype=dt, device="cuda")
                x /= x.norm()
                ref = FG.fused_run_plain(x, prep, n=n, tile_bits=tb)
                before = FG.fused_run.launches
                got = FG.fused_run(x, n=n, ops=ops, tile_bits=tb, out=torch.empty_like(x),
                                   prepared=prep)
                torch.cuda.synchronize()
                assert FG.fused_run.launches == before + 1
                assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()
        ops = ops_from_reference(_mixed_run(rng, n + 2))
        prep = FG.PreparedRun(ops, tbs[-1])
        x = torch.as_tensor(rng.randn(2, 1 << n), dtype=dt, device="cuda")
        ref = FG.fused_run_plain(x, prep, n=n + 2, tile_bits=tbs[-1], local_n=n, shard_index=3)
        got = FG.fused_run(x.clone(), n=n + 2, ops=ops, tile_bits=tbs[-1], prepared=prep,
                           local_n=n, shard_index=3)
        torch.cuda.synchronize()
        assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()
