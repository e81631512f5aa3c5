"""The sharded state vector of quest_tpu_torch against quest_tpu on the
emulated CPU mesh and the dense numpy oracle (tests/oracle.py).

Port registers live on ``createQuESTEnv(devices=["cpu"] * d)`` (d virtual
CPU shards); quest_tpu's on d of its 8 CPU devices. Inputs are made with
numpy from a seed and fed to both. Tolerances: 1e-10 in f64; 2e-4 in f32,
where the JAX kernel's zone dots are bf16x3 and the port's plain FP32.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _random_layers
from quest_tpu import fusion as JF
from quest_tpu.analysis import conformance as CF
from quest_tpu.circuits import Circuit as JCircuit
from quest_tpu.ops import pallas_gates as PG
import quest_tpu as jq
import quest_tpu_torch as tq
from quest_tpu_torch import fusion as F
from quest_tpu_torch import registers as TR
from quest_tpu_torch import telemetry
from quest_tpu_torch.interop import (arg_from_reference, circuit_from_tape, load_state,
                                     ops_from_reference, shard_arrays, state_to_numpy)
from quest_tpu_torch.ops import fused_gates as FG

from . import oracle
from .test_torch_fusion import assert_plans_equal

TOL = 1e-10
F32_TOL = 2e-4


def _envs(d):
    return jq.createQuESTEnv(jax.devices()[:d]), tq.createQuESTEnv(devices=["cpu"] * d)


def _close(tqr, ref, tol=TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(state_to_numpy(tqr), ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1.0))


def _pair(n, d, precision=2):
    jenv, tenv = _envs(d)
    return jq.createQureg(n, jenv, precision), tq.createQureg(n, tenv, precision)


def _both_circuits(n, build):
    jc = JCircuit(n)
    build(jc)
    return jc, circuit_from_tape(jc._tape, n)


def _port_plan(tape):
    """The plan items of a fused port Circuit's tape."""
    return F.FusePlan(items=[a[0] if f in (F._apply_pallas_run, F._apply_frame_swap)
                             else (f, a, kw) for f, a, kw in tape])


# ---------------------------------------------------------------------------
# environment and registers
# ---------------------------------------------------------------------------

def test_env_validation_matches_reference():
    with pytest.raises(jq.QuESTError) as jerr:
        jq.createQuESTEnv(jax.devices()[:3])
    with pytest.raises(tq.QuESTError) as terr:
        tq.createQuESTEnv(devices=["cpu"] * 3)
    assert terr.value.message == jerr.value.message
    env = tq.createQuESTEnv(devices=["cpu"] * 4)
    assert env.num_ranks == 4 and env.device == torch.device("cpu")
    assert tq.createQuESTEnv(device="cpu").num_ranks == 1
    with pytest.raises(tq.QuESTError):
        tq.createQuESTEnv(device="cpu", devices=["cpu"])


def test_cuda_mesh_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: a CUDA mesh is valid here")
    with pytest.raises(tq.QuESTError, match='device="cpu"'):
        tq.createQuESTEnv(devices=["cuda:0"] * 2)


@pytest.mark.parametrize("n", [2, 4])
def test_density_register_on_a_mesh_matches_reference_layout(n):
    """A density register on 4 shards is its flattened 2n-qubit state cut
    as quest_tpu cuts it: 4 shards of 4^n / 4 amplitudes, shard r the flat
    indices [r C, (r+1) C), in |0><0|; one device keeps it whole."""
    jenv, tenv = _envs(4)
    jqr, tqr = jq.createDensityQureg(n, jenv, 2), tq.createDensityQureg(n, tenv, 2)
    assert tqr.amps is None and len(tqr.shards) == 4
    assert len(jqr.amps.sharding.device_set) == 4
    c = (1 << (2 * n)) // 4
    assert all(s.shape == (2, c) for s in tqr.shards)
    for r, piece in enumerate(sorted(jqr.amps.addressable_shards,
                                     key=lambda p: p.index[1].start or 0)):
        assert (piece.index[1].start or 0) == r * c
        np.testing.assert_array_equal(np.asarray(piece.data), tqr.shards[r].numpy())
    assert tq.createDensityQureg(n, tq.createQuESTEnv(device="cpu"), 2).shards is None


@pytest.mark.parametrize("d", [4, 8])
def test_register_layout_and_inits_match_reference(d):
    n = 7
    jqr, tqr = _pair(n, d)
    assert tqr.amps is None and len(tqr.shards) == d
    assert all(s.shape == (2, 1 << (n - (d - 1).bit_length())) for s in tqr.shards)
    assert len(jqr.amps.sharding.device_set) == d
    rng = np.random.RandomState(d)
    re, im = rng.randn(1 << n), rng.randn(1 << n)
    for name, args in (("initBlankState", ()), ("initZeroState", ()), ("initPlusState", ()),
                       ("initClassicalState", ((1 << n) - 5,)), ("initDebugState", ()),
                       ("initStateFromAmps", (re, im)),
                       ("setAmps", (13, re, im, 90)), ("setAmps", (0, im, re, 1 << n))):
        getattr(jq, name)(jqr, *args)
        getattr(tq, name)(tqr, *args)
        _close(tqr, jqr.amps, 1e-15)
    # too few amplitudes to split: one device, as quest_tpu keeps it
    small = tq.createQureg(2, tq.createQuESTEnv(devices=["cpu"] * 8), 2)
    assert small.shards is None and small.amps.shape == (2, 4)


@pytest.mark.parametrize("d", [4, 8])
def test_interop_carries_sharded_states_both_ways(d):
    n = 8
    jqr, tqr = _pair(n, 8)  # quest_tpu on 8 devices
    _, tenv = _envs(d)
    tqr = tq.createQureg(n, tenv, 2)
    jq.initDebugState(jqr)
    load_state(tqr, jqr.amps)  # piece by piece, 8 pieces into d shards
    _close(tqr, jqr.amps, 0.0)
    back = shard_arrays(tqr)
    assert len(back) == d
    np.testing.assert_array_equal(np.concatenate(back, axis=1), np.asarray(jqr.amps))
    one = tq.createQureg(n, tq.createQuESTEnv(device="cpu"), 2)
    load_state(one, np.asarray(jqr.amps))
    _close(one, jqr.amps, 0.0)


def test_refused_calls_raise():
    _, tenv = _envs(4)
    q = tq.createQureg(6, tenv, 2)
    one = tq.createQuESTEnv(device="cpu")
    rho = tq.createDensityQureg(6, one, 2)
    tq.initDebugState(q)
    tq.initPureState(rho, q)  # a density matrix from a sharded state
    v = state_to_numpy(q)[0] + 1j * state_to_numpy(q)[1]
    np.testing.assert_allclose(state_to_numpy(rho)[0].reshape(64, 64).T
                               + 1j * state_to_numpy(rho)[1].reshape(64, 64).T,
                               np.outer(v, v.conj()), atol=TOL)
    with pytest.raises(tq.QuESTError):
        tq.calcPurity(q)
    with pytest.raises(tq.QuESTError):
        tq.mixDephasing(q, 0, 0.1)
    with pytest.raises(tq.QuESTError):
        q.put(torch.zeros(2, 64, dtype=torch.float64))
    with pytest.raises(tq.QuESTError, match="too many qubits"):
        # five targets against the four local qubits: the reference's only
        # refusal (validateMultiQubitMatrixFitsInNode)
        tq.multiQubitUnitary(q, [0, 1, 2, 4, 5], np.eye(32))
    q2 = tq.createQureg(6, tenv, 2)
    tq.initDebugState(q2)
    tq.cloneQureg(q, q2)
    np.testing.assert_array_equal(state_to_numpy(q), state_to_numpy(q2))


# ---------------------------------------------------------------------------
# the per-shard kernel: its plain version against the JAX kernel
# ---------------------------------------------------------------------------

H = np.array([[1, 1], [1, -1]]) / np.sqrt(2)


def _shard_ops():
    rng = np.random.RandomState(3)

    def ru():
        q, _ = np.linalg.qr(rng.randn(2, 2) + 1j * rng.randn(2, 2))
        return PG.HashableMatrix(q)

    # n = 12 over 4 shards: local_n 10, qubits 10 and 11 sharded
    return (("matrix", 0, (11,), (1,), ru()),
            ("matrix", 3, (10, 5), (0, 1), ru()),
            ("matrix", 8, (11, 10), (0, 0), ru()),
            ("matrix", 11, (2,), (1,), PG.HashableMatrix(np.diag([1j, -1]))),
            ("matrix", 10, (11,), (0,), PG.HashableMatrix(np.diag(np.exp([0.3j, -1.1j])))),
            ("parity", (0, 11, 9), (), 0.77),
            ("parity", (10, 4), (11,), -1.3),
            ("swap", 1, 6, (11,), (0,)),
            ("diagw", (1, 11, 7), (10,), PG.HashableMatrix(np.exp(1j * np.arange(8)))),
            ) + tuple(("matrix", q % 7, (), (), ru()) for q in range(16))


@pytest.mark.parametrize("dtype,tol", [(np.float64, TOL), (np.float32, F32_TOL)])
@pytest.mark.parametrize("swaps", [{}, {"load_swap_k": 1, "load_swap_hi": 9,
                                       "store_swap_k": 1}], ids=["no-swap", "swaps"])
def test_fused_run_plain_per_shard_matches_jax_kernel(dtype, tol, swaps):
    """Each shard's pass of fused_run_plain (local_n, shard_index) against
    the JAX per-shard kernel (fused_local_run with shard_index, the
    BlockSpec grid kernel _make_kernel with hi_ref) in interpret mode."""
    n, d = 12, 4
    nl = n - 2
    ops = _shard_ops()
    state = np.random.default_rng(7).normal(size=(2, 1 << n)).astype(dtype)
    tb = PG.local_qubits(nl, sublanes=4)
    prep = FG.PreparedRun(ops_from_reference(ops), tb)
    for r, shard in enumerate(np.split(state, d, axis=1)):
        ref = PG.fused_local_run(jnp.asarray(shard), n=nl, ops=ops, sublanes=4,
                                 shard_index=r, interpret=True, **swaps)
        got = FG.fused_run_plain(torch.tensor(shard), prep, n=n, tile_bits=tb,
                                 local_n=nl, shard_index=r, **swaps)
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=tol * max(np.abs(ref).max(), 1.0))
        out = torch.empty_like(torch.tensor(shard))
        FG.fused_run(torch.tensor(shard), n=n, ops=ops_from_reference(ops), tile_bits=tb,
                     local_n=nl, shard_index=r, out=out, **swaps)
        np.testing.assert_array_equal(out.numpy(), got.numpy())


@pytest.mark.cuda
def test_per_shard_kernel_matches_plain_on_card():
    """The CUDA kernel on each shard (local_n, shard_index) against its plain
    version with the same index, and a sharded fused circuit on four
    virtual shards of the card against the one-device run, f32 and f64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n, d = 16, 4
    nl = n - 2
    rng = np.random.RandomState(5)

    def ru():
        return FG.HashableMatrix(np.linalg.qr(rng.randn(2, 2) + 1j * rng.randn(2, 2))[0])

    ops = (("matrix", 0, (15,), (1,), ru()), ("matrix", 3, (14, 5), (0, 1), ru()),
           ("matrix", 15, (2,), (1,), FG.HashableMatrix(np.diag([1j, -1]))),
           ("parity", (0, 15, 9), (14,), 0.77), ("swap", 1, 6, (15,), (0,)),
           ("diagw", (1, 15, 7), (14,), FG.HashableMatrix(np.exp(1j * np.arange(8)))))
    for dt, tb, tol in ((torch.float32, 13, 1e-5), (torch.float64, 12, 1e-12)):
        x = torch.as_tensor(rng.randn(2, 1 << n), dtype=dt, device="cuda")
        x /= x.norm()
        prep = FG.PreparedRun(ops, tb)
        for r, shard in enumerate(x.chunk(d, dim=1)):
            shard = shard.contiguous()
            ref = FG.fused_run_plain(shard, prep, n=n, tile_bits=tb, local_n=nl,
                                     shard_index=r, load_swap_k=1, load_swap_hi=nl - 1)
            before = FG.fused_run.launches
            got = FG.fused_run(shard, n=n, ops=ops, tile_bits=tb, local_n=nl, shard_index=r,
                               load_swap_k=1, load_swap_hi=nl - 1,
                               out=torch.empty_like(shard), prepared=prep)
            torch.cuda.synchronize()
            assert FG.fused_run.launches == before + 1
            assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()
        c = tq.Circuit(n)
        tq.random_layers(c, n, 3)
        c.controlledPhaseShift(n - 1, 0, 0.37)
        q = tq.createQureg(n, tq.createQuESTEnv(devices=["cuda:0"] * d), 2 if dt is torch.float64 else 1)
        one = tq.createQureg(n, tq.createQuESTEnv(device="cuda:0"), 2 if dt is torch.float64 else 1)
        for reg in (q, one):
            tq.initPlusState(reg)
        before = FG.fused_run.launches
        c.fused(max_qubits=5, pallas=True, dtype=dt, shard_devices=d).run(q)
        assert FG.fused_run.launches > before
        c.fused(max_qubits=5, pallas=True, dtype=dt).run(one)
        ref = one.amps
        got = torch.cat(q.shards, dim=1)
        assert (got - ref).abs().max().item() <= (1e-5 if dt is torch.float32 else 1e-10) * \
            ref.abs().max().item()


def test_fused_run_checks_shard_geometry():
    ops = (("matrix", 0, (11,), (1,), FG.HashableMatrix(H)),)
    shard = torch.zeros(2, 1 << 10, dtype=torch.float64)
    out = torch.empty_like(shard)
    with pytest.raises(ValueError, match="shard"):
        FG.fused_run(shard, n=12, ops=ops, tile_bits=9, local_n=10, shard_index=4)
    with pytest.raises(ValueError, match="planar"):
        FG.fused_run(shard, n=12, ops=ops, tile_bits=9, local_n=11, shard_index=0)
    with pytest.raises(ValueError, match="bit-block swap"):
        FG.fused_run(shard, n=12, ops=ops, tile_bits=9, local_n=10, shard_index=1,
                     load_swap_k=1, load_swap_hi=10, out=out)
    with pytest.raises(ValueError, match="tile_bits"):
        FG.fused_run(shard, n=12, ops=ops, tile_bits=11, local_n=10, shard_index=1)


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,seed", [(10, 4, 0), (11, 4, 3), (12, 8, 0), (12, 4, 5),
                                      (13, 8, 1)])
def test_sharded_plan_equals_reference(n, d, seed):
    """At a pinned tile (sublanes=4, to force frames), the port's sharded
    plan equals quest_tpu's item for item, with equal transpose counts."""
    jc, tc = _both_circuits(n, lambda c: _random_layers(c, n, depth=3, seed=seed))
    n_local = n - (d - 1).bit_length()
    tb = PG.local_qubits(n_local, sublanes=4)
    ref = JF.plan_pallas_sharded(tuple(jc._tape), n, np.float64, 5, tb, n_local)
    got = F.plan_pallas_sharded(tuple(tc._tape), n, torch.float64, 5, tb, n_local)
    assert_plans_equal(ref, got)
    assert F.transpose_stats(got, n_local) == JF.transpose_stats(ref, n_local)


@pytest.mark.parametrize("tile_bits", [13, 19])
def test_bench_sharded_plan_equals_reference(tile_bits):
    """The slice's main-path circuit, 26 qubits depth 8 over 4 shards, at
    the card's f32 tile (13) and the JAX package's (19): plan only."""
    n, n_local = 26, 24
    jc, tc = _both_circuits(n, lambda c: _random_layers(c, n, depth=8, seed=2026))
    ref = JF.plan_pallas_sharded(tuple(jc._tape), n, np.float32, 5, tile_bits, n_local)
    got = F.plan_pallas_sharded(tuple(tc._tape), n, torch.float32, 5, tile_bits, n_local)
    assert_plans_equal(ref, got)
    stats = F.transpose_stats(got, n_local)
    assert stats == JF.transpose_stats(ref, n_local)
    if tile_bits == 13:
        fz = tc.fused(max_qubits=5, pallas=True, dtype=torch.float32, shard_devices=4)
        assert F.tape_transpose_stats(fz._tape, n_local) == stats


def test_boundary_frames_and_clipped_anchors_match_reference():
    """The shard-boundary frame tiling and the clipped synthesized frames."""
    for tb, k, nsv, b in ((9, 2, 14, 12), (9, 2, 13, 10), (13, 6, 26, 24)):
        jp = JF._FramePlanner(JF.FusePlan(), tb, k, nsv, boundary=b)
        tp = F._FramePlanner(F.FusePlan(), tb, k, nsv, boundary=b)
        assert tp.frames == jp.frames
        for targets in ((11, 12), (10, 13), (1, 11, 12), (12,)):
            jop = JF._POp("matrix", targets, (), (), None, False)
            top = F._POp("matrix", targets, (), (), None, False)
            assert tp._synth_frame(top) == jp._synth_frame(jop)


# ---------------------------------------------------------------------------
# running on sharded registers (mirrors of tests/test_pallas.py)
# ---------------------------------------------------------------------------

def test_sharded_register_falls_back_to_engine():
    """A plan made without shard_devices on a register whose shards are
    smaller than its tile (10q over 8 shards: 7 local qubits) replays its
    runs through the per-gate engine over the shards, each counted in
    engine_fallback_total (test_pallas.py:460)."""
    n = 10
    jc, tc = _both_circuits(n, lambda c: _random_layers(c, n, depth=2))
    jqr, tqr = _pair(n, 8)
    jq.initPlusState(jqr)
    tq.initPlusState(tqr)
    jc.fused(max_qubits=5, pallas=True).run(jqr)
    fz = tc.fused(max_qubits=5, pallas=True, dtype=torch.float64)
    runs = [a[0] for f, a, _ in fz._tape if f is F._apply_pallas_run]
    assert runs
    telemetry.reset()
    fz.run(tqr)
    assert telemetry.counter_value("engine_fallback_total",
                                   reason="shard_map_unsupported") == len(runs)
    assert abs(tq.calcTotalProb(tqr) - 1) < TOL
    _close(tqr, jqr.amps)
    one = tq.createQureg(n, tq.createQuESTEnv(device="cpu"), 2)
    tq.initPlusState(one)
    tc.run(one)
    _close(tqr, state_to_numpy(one))


def _extra_roles(n):
    def build(c):
        _random_layers(c, n, depth=2)
        c.controlledPhaseShift(n - 1, 0, 0.37)   # sharded control in the kernel
        c.multiRotateZ(list(range(n)), 0.21)     # parity across the shard bits
    return build


def test_sharded_pallas_runs_per_shard():
    """A plan built with shard_devices runs the kernel per shard (roles on
    sharded qubits resolve against the shard index) and equals quest_tpu's
    shard_map run (test_pallas.py:487)."""
    n, d = 12, 4
    jc, tc = _both_circuits(n, _extra_roles(n))
    jfz = jc.fused(max_qubits=5, pallas=True, shard_devices=d)
    tfz = tc.fused(max_qubits=5, pallas=True, shard_devices=d, dtype=torch.float64,
                   tile_bits=PG.local_qubits(n - 2))
    assert_plans_equal(JF.plan_from_tape(jfz._tape), _port_plan(tfz._tape))
    runs = [a[0] for f, a, _ in tfz._tape if f is F._apply_pallas_run]
    assert any(q >= n - 2 for r in runs for op in r.ops
               for q in (op[2] if op[0] in ("matrix", "parity", "diagw") else ()))
    jqr, tqr = _pair(n, d)
    jq.initPlusState(jqr)
    tq.initPlusState(tqr)
    jfz.run(jqr)
    telemetry.reset()
    tfz.run(tqr)
    assert telemetry.counter_value("pallas_pass_total", kind="fused_run") == len(runs) * d
    assert telemetry.counter_total("engine_fallback_total") == 0
    _close(tqr, jqr.amps)
    one = tq.createQureg(n, tq.createQuESTEnv(device="cpu"), 2)
    tq.initPlusState(one)
    tc.run(one)
    _close(tqr, state_to_numpy(one))


def test_sharded_multi_frame_collective_transposes():
    """A register wider than two frames runs fused runs per shard with each
    frame switch that reaches a sharded qubit one collective transpose
    (dist_permute_bits, counted as grouped_permute), 12q over 8 shards with
    frames (9, 2) and (11, 1) (test_pallas.py:558)."""
    n, d = 12, 8
    rng = np.random.RandomState(11)
    us = [np.linalg.qr(rng.randn(2, 2) + 1j * rng.randn(2, 2))[0] for _ in range(n)]

    def build(c):
        for q in range(n):
            c.unitary(q, us[q])
        c.controlledNot(11, 0)

    jc, tc = _both_circuits(n, build)
    jfz = jc.fused(max_qubits=5, pallas=True, shard_devices=d)
    tfz = tc.fused(max_qubits=5, pallas=True, shard_devices=d, dtype=torch.float64,
                   tile_bits=PG.local_qubits(n - 3))
    assert_plans_equal(JF.plan_from_tape(jfz._tape), _port_plan(tfz._tape))
    his = {a[0].load_swap_hi for f, a, _ in tfz._tape
           if f is F._apply_pallas_run and a[0].load_swap_k}
    assert {9, 11} <= his
    stats = F.tape_transpose_stats(tfz._tape, n - 3)
    assert stats == JF.tape_transpose_stats(jfz._tape, n - 3)
    assert stats["collective_transposes"] > 0
    jqr, tqr = _pair(n, d)
    jq.initPlusState(jqr)
    tq.initPlusState(tqr)
    jfz.run(jqr)
    telemetry.reset()
    tfz.run(tqr)
    assert telemetry.counter_value("exchange_calls_total", kind="grouped_permute") == \
        stats["collective_transposes"]
    assert telemetry.counter_total("engine_fallback_total") == 0
    _close(tqr, jqr.amps)


@pytest.mark.parametrize("precision,tol", [(2, TOL), (1, F32_TOL)])
def test_sharded_plan_runs_on_any_register(precision, tol):
    """Circuit.run on a sharded register: the same fused plan also runs on
    a one-device register, and both equal the per-gate replay and
    quest_tpu's sharded run (test_pallas.py:641)."""
    n, d = 12, 4
    jc, tc = _both_circuits(n, lambda c: _random_layers(c, n, depth=2))
    dt = torch.float64 if precision == 2 else torch.float32
    fz = tc.fused(max_qubits=5, pallas=True, shard_devices=d, dtype=dt)
    jqr, tqr = _pair(n, d, precision)
    one = tq.createQureg(n, tq.createQuESTEnv(device="cpu"), precision)
    ref = tq.createQureg(n, tq.createQuESTEnv(device="cpu"), precision)
    for q in (tqr, one, ref):
        tq.initPlusState(q)
    jq.initPlusState(jqr)
    jc.fused(max_qubits=5, pallas=True, shard_devices=d).run(jqr)
    fz.run(tqr)
    fz.run(one)
    tc.run(ref)
    _close(tqr, jqr.amps, tol)
    _close(one, state_to_numpy(ref), tol)
    _close(tqr, state_to_numpy(ref), tol)


def test_per_gate_replay_over_shards_matches_reference():
    """The unfused circuit on a sharded register: the per-gate engine over
    the shards (pair exchanges, x permutes, phases, relocations) against
    quest_tpu's sharded replay and the oracle."""
    n, d = 8, 4
    rng = np.random.RandomState(2)
    u3 = np.linalg.qr(rng.randn(8, 8) + 1j * rng.randn(8, 8))[0]

    def build(c):
        _random_layers(c, n, depth=2, seed=4)
        c.swapGate(1, n - 1)
        c.swapGate(n - 1, n - 2)
        c.multiQubitUnitary([0, n - 1, n - 2], u3)
        c.multiControlledMultiQubitNot([n - 1], [2, n - 2])

    jc, tc = _both_circuits(n, build)
    jqr, tqr = _pair(n, d)
    v = oracle.random_statevec(n, np.random.RandomState(3))
    jq.initStateFromAmps(jqr, v.real, v.imag)
    tq.initStateFromAmps(tqr, v.real, v.imag)
    jc.run(jqr)
    telemetry.reset()
    tc.run(tqr)
    kinds = {k: telemetry.counter_value("exchange_calls_total", kind=k)
             for k in ("pair_exchange", "x_permute", "swap_odd_parity", "swap_rank_permute")}
    assert all(v > 0 for v in kinds.values()), kinds
    _close(tqr, jqr.amps)
    stats = tqr.env.engine.stats
    assert stats["pair_exchanges"] and stats["relocation_swaps"] and stats["comm_free"]


# ---------------------------------------------------------------------------
# readouts, measurement and the gate surface
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [4, 8])
def test_readouts_and_seeded_measurement_match_reference(d):
    n = 8
    jqr, tqr = _pair(n, d)
    v = oracle.random_statevec(n, np.random.RandomState(d))
    jq.initStateFromAmps(jqr, v.real, v.imag)
    tq.initStateFromAmps(tqr, v.real, v.imag)
    assert abs(tq.calcTotalProb(tqr) - jq.calcTotalProb(jqr)) < TOL
    for q in range(n):
        for outcome in (0, 1):
            p = float(np.sum(np.abs(v[((np.arange(1 << n) >> q) & 1) == outcome]) ** 2))
            assert abs(tq.calcProbOfOutcome(tqr, q, outcome) - p) < TOL
            assert abs(tq.calcProbOfOutcome(tqr, q, outcome)
                       - jq.calcProbOfOutcome(jqr, q, outcome)) < TOL
    for index in (0, 37, (1 << n) - 1, (1 << n) - 70):
        assert abs(tq.getAmp(tqr, index) - v[index]) < TOL
        assert tq.getRealAmp(tqr, index) == tq.getAmp(tqr, index).real
    jq.seedQuEST(jqr.env, [7, 11])
    tq.seedQuEST(tqr.env, [7, 11])
    for q in (0, n - 1, 3, n - 2, n - 1):  # local and sharded qubits
        jo, jp = jq.measureWithStats(jqr, q)
        to, tp = tq.measureWithStats(tqr, q)
        assert to == jo and abs(tp - jp) < TOL
        _close(tqr, jqr.amps)
    tq.initStateFromAmps(tqr, v.real, v.imag)
    jq.initStateFromAmps(jqr, v.real, v.imag)
    assert abs(tq.collapseToOutcome(tqr, n - 1, 1) - jq.collapseToOutcome(jqr, n - 1, 1)) < TOL
    _close(tqr, jqr.amps)


SN = 7
SV_CASES = CF.conformance_cases(SN)[::3]


@pytest.mark.parametrize("case", SV_CASES, ids=lambda c: c.id)
def test_oracle_specs_on_a_sharded_register(case):
    """A slice of the ORACLE_SPECS gate cases on a 4-shard register, against
    the oracle and quest_tpu's sharded register."""
    jqr, tqr = _pair(SN, 4)
    v = oracle.random_statevec(SN, CF.case_rng("shard:" + case.id))
    jq.initStateFromAmps(jqr, v.real, v.imag)
    tq.initStateFromAmps(tqr, v.real, v.imag)
    getattr(jq, case.name)(jqr, *case.args)
    getattr(tq, case.name)(tqr, *arg_from_reference(case.args))
    ref = oracle.apply_to_statevec(v, SN, case.targets, case.matrix,
                                   controls=case.controls,
                                   control_states=case.control_states)
    got = tq.get_np(tqr)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, jq.get_np(jqr), rtol=0, atol=TOL)


ALL_CASES = CF.conformance_cases(SN)
#: the gate the sharded engine refused before a relocation could carry a
#: control: targets (6, 5, 4), controls (0, 1), four local qubits
C1_CASE = "multiControlledMultiQubitUnitary-1"


@pytest.mark.parametrize("case", ALL_CASES, ids=lambda c: c.id)
def test_every_oracle_spec_on_eight_shards(case):
    """Every conformance case on an 8-shard register (4 local qubits)
    against the oracle; the relocation case and every case with a target
    on a sharded qubit also against quest_tpu on 8 CPU devices."""
    d = 8
    nl = SN - 3
    v = oracle.random_statevec(SN, CF.case_rng("shard8:" + case.id))
    tqr = tq.createQureg(SN, tq.createQuESTEnv(devices=["cpu"] * d), 2)
    tq.initStateFromAmps(tqr, v.real, v.imag)
    getattr(tq, case.name)(tqr, *arg_from_reference(case.args))
    assert len(tqr.shards) == d
    ref = oracle.apply_to_statevec(v, SN, case.targets, case.matrix,
                                   controls=case.controls,
                                   control_states=case.control_states)
    got = tq.get_np(tqr)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    if case.id == C1_CASE or any(t >= nl for t in case.targets):
        jqr = jq.createQureg(SN, jq.createQuESTEnv(jax.devices()[:d]), 2)
        jq.initStateFromAmps(jqr, v.real, v.imag)
        getattr(jq, case.name)(jqr, *case.args)
        np.testing.assert_allclose(got, jq.get_np(jqr), rtol=0, atol=TOL)


@pytest.mark.parametrize("d", [4, 8])
def test_relocation_carries_a_control(d):
    """A dense gate whose sharded targets swap into slots held by controls
    (QuEST_cpu_distributed.c:1526-1568): the controls move with the swaps,
    resolve from the shard index, and every swap is undone after it."""
    nl = SN - (d - 1).bit_length()
    case = next(c for c in ALL_CASES if c.id == C1_CASE)
    v = oracle.random_statevec(SN, np.random.RandomState(d))
    tqr = tq.createQureg(SN, tq.createQuESTEnv(devices=["cpu"] * d), 2)
    tq.initStateFromAmps(tqr, v.real, v.imag)
    getattr(tq, case.name)(tqr, *arg_from_reference(case.args))
    sharded = [t for t in case.targets if t >= nl]
    assert tqr.env.engine.stats["relocation_swaps"] == 2 * len(sharded)
    ref = oracle.apply_to_statevec(v, SN, case.targets, case.matrix,
                                   controls=case.controls,
                                   control_states=case.control_states)
    np.testing.assert_allclose(tq.get_np(tqr), ref, rtol=0, atol=TOL)
    # two sharded targets swap into slots 0 and 1: one control there and
    # one on a sharded qubit (a local one where every sharded qubit is a
    # target); then controls on both slots
    targets = (SN - 1, nl)
    other = [q for q in range(nl, SN) if q not in targets][:1] or [2]
    u = oracle.random_unitary(2, np.random.RandomState(d))
    for controls in ((0, other[0]), (1, 0)):
        tq.initStateFromAmps(tqr, v.real, v.imag)
        tq.multiControlledMultiQubitUnitary(tqr, list(controls), list(targets), u)
        exp = oracle.apply_to_statevec(v, SN, targets, u, controls=controls)
        np.testing.assert_allclose(tq.get_np(tqr), exp, rtol=0, atol=TOL)


def _layout_pair(n, d, seed):
    """A quest_tpu and a port register on d devices (d = 1: one device),
    both holding the same random state."""
    jenv = jq.createQuESTEnv(jax.devices()[:d])
    tenv = tq.createQuESTEnv(devices=["cpu"] * d) if d > 1 else tq.createQuESTEnv(device="cpu")
    jqr, tqr = jq.createQureg(n, jenv, 2), tq.createQureg(n, tenv, 2)
    v = oracle.random_statevec(n, np.random.RandomState(seed))
    jq.initStateFromAmps(jqr, v.real, v.imag)
    tq.initStateFromAmps(tqr, v.real, v.imag)
    assert (tqr.shards is None) == (d == 1)
    return jqr, tqr


@contextlib.contextmanager
def _no_host_staging():
    """Fails a call that reads a register back to the host (``get_np``,
    ``Tensor.numpy``/``tolist``/``cpu``): layout changes copy between
    devices."""
    def refuse(*a, **k):
        raise AssertionError("a register went through host memory")

    with pytest.MonkeyPatch.context() as mp:
        for obj, name in ((TR, "get_np"), (torch.Tensor, "numpy"),
                          (torch.Tensor, "tolist"), (torch.Tensor, "cpu")):
            mp.setattr(obj, name, refuse)
        yield


@pytest.mark.parametrize("func", ["cloneQureg", "initPureState"])
@pytest.mark.parametrize("src,dst", [(4, 1), (1, 4), (4, 8), (8, 4), (4, 4)])
def test_copies_across_layouts_match_reference(func, src, dst):
    """cloneQureg and initPureState between a sharded and an unsharded
    state vector and between meshes of different sizes, against
    quest_tpu: the target keeps its layout and holds the source's state."""
    n = 7
    js, ts = _layout_pair(n, src, 1)
    jt, tt = _layout_pair(n, dst, 2)
    layout = None if tt.shards is None else [(s.shape, s.device) for s in tt.shards]
    getattr(jq, func)(jt, js)
    with _no_host_staging():
        getattr(tq, func)(tt, ts)
    assert layout == (None if tt.shards is None else [(s.shape, s.device) for s in tt.shards])
    assert all(x.data_ptr() != y.data_ptr() for x in (tt.shards or [tt.amps])
               for y in (ts.shards or [ts.amps]))
    np.testing.assert_array_equal(tq.get_np(tt), np.asarray(jq.get_np(jt)))
    np.testing.assert_array_equal(tq.get_np(tt), tq.get_np(ts))


@pytest.mark.parametrize("d1,d2,dout", [(4, 1, 1), (1, 1, 4), (1, 8, 4), (4, 4, 4)])
def test_weighted_sum_across_layouts_matches_reference(d1, d2, dout):
    """setWeightedQureg with inputs in any layout: each brought to out's,
    then summed per shard; against numpy, and against quest_tpu where it
    takes the layouts (at most one mesh besides single devices)."""
    n = 7
    (j1, t1), (j2, t2), (jo, to) = (_layout_pair(n, d, s)
                                    for s, d in enumerate((d1, d2, dout)))
    f1, f2, fo = 0.5 - 0.2j, 1j, -0.3
    exp = f1 * tq.get_np(t1) + f2 * tq.get_np(t2) + fo * tq.get_np(to)
    with _no_host_staging():
        tq.setWeightedQureg(f1, t1, f2, t2, fo, to)
    assert (to.shards is None) == (dout == 1)
    got = tq.get_np(to)
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-15)
    if len({d for d in (d1, d2, dout) if d > 1}) <= 1:
        jq.setWeightedQureg(f1, j1, f2, j2, fo, jo)
        np.testing.assert_allclose(got, np.asarray(jq.get_np(jo)), rtol=0, atol=TOL)
