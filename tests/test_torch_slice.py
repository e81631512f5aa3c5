"""The ported slice end to end against quest_tpu: the bench circuit
(random Clifford+T layers) recorded, planned into fused runs at a pinned
tile geometry, run on a register, and read out, in both packages, from the
debug state and from a seeded random state. f64 (the suite's precision):
amplitudes and readouts within 1e-10 at the state's scale."""

import numpy as np
import pytest
import torch

import quest_tpu as jq
from __graft_entry__ import _random_layers
from quest_tpu import fusion as JF
from quest_tpu.circuits import Circuit as JCircuit
from quest_tpu.ops import pallas_gates as PG
from quest_tpu.precision import real_dtype
import quest_tpu_torch as tq
from quest_tpu_torch import fusion as F, telemetry
from quest_tpu_torch.interop import circuit_from_tape, state_from_numpy, state_to_numpy
from quest_tpu_torch.ops import fused_gates as FG

TOL = 1e-10


@pytest.mark.parametrize("n,start", [(11, "debug"), (12, "random")])
def test_bench_circuit_fused_matches_reference(n, start):
    tb = PG.local_qubits(n, sublanes=4)
    jc = JCircuit(n)
    _random_layers(jc, n, depth=3, seed=n)
    p = JF.plan(tuple(jc._tape), n, real_dtype(), max_qubits=5,
                pallas_tile_bits=tb)
    jfz = JCircuit(n)
    jfz._tape = JF.as_tape(p)

    tc = circuit_from_tape(jc._tape, n)
    tfz = tc.fused(max_qubits=5, pallas=True, tile_bits=tb)
    runs = [a[0] for f, a, _ in tfz._tape if f is F._apply_pallas_run]
    assert len(runs) == len(tfz._tape) > 1
    assert any(r.load_swap_k or r.store_swap_k for r in runs)

    jenv = jq.createQuESTEnv()
    jqr = jq.createQureg(n, jenv)
    env = tq.createQuESTEnv(device="cpu")
    q = tq.createQureg(n, env, precision_code=2)
    if start == "debug":
        jq.initDebugState(jqr)
        tq.initDebugState(q)
    else:
        state = np.random.default_rng(7).normal(size=(2, 1 << n))
        state /= np.linalg.norm(state)
        jq.initStateFromAmps(jqr, state[0], state[1])
        q.put(state_from_numpy(state, "cpu"))
    jfz.run(jqr)

    telemetry.reset()
    launches = FG.fused_run.launches
    tfz.run(q)
    assert telemetry.counter_value("pallas_pass_total", kind="fused_run") == len(runs)
    assert telemetry.counter_total("engine_fallback_total") == 0
    assert FG.fused_run.launches == launches  # CPU tensors never launch

    ref = np.asarray(jqr.amps)
    got = state_to_numpy(q)
    scale = max(np.abs(ref).max(), 1.0)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL * scale)
    tot_scale = max(jq.calcTotalProb(jqr), 1.0)
    assert abs(tq.calcTotalProb(q) - jq.calcTotalProb(jqr)) <= TOL * tot_scale
    for target in (0, tb - 1, n - 1):
        for outcome in (0, 1):
            assert abs(tq.calcProbOfOutcome(q, target, outcome)
                       - jq.calcProbOfOutcome(jqr, target, outcome)) <= TOL * tot_scale
    for index in (0, 5, (1 << n) - 1):
        assert abs(tq.getAmp(q, index) - jq.getAmp(jqr, index)) <= TOL * scale
        assert tq.getRealAmp(q, index) == tq.getAmp(q, index).real
        assert tq.getImagAmp(q, index) == tq.getAmp(q, index).imag


def test_default_hopper_tile_replay_matches_unfused():
    """At the port's own tile (min(n, 12) bits in f64) the fused plan of a
    13-qubit bench circuit has frames, and replays to the unfused state."""
    n = 13
    tc = tq.Circuit(n)
    tq.random_layers(tc, n, depth=3)
    tfz = tc.fused(pallas=True, dtype=torch.float64)
    runs = [a[0] for f, a, _ in tfz._tape if f is F._apply_pallas_run]
    assert runs and all(r.tile_bits == 12 for r in runs)
    env = tq.createQuESTEnv(device="cpu")
    q, ref = tq.createQureg(n, env, 2), tq.createQureg(n, env, 2)
    tq.initPlusState(q)
    tq.initPlusState(ref)
    tfz.run(q)
    tc.run(ref)
    np.testing.assert_allclose(q.amps.numpy(), ref.amps.numpy(), rtol=TOL, atol=TOL)
    assert abs(tq.calcTotalProb(q) - 1) < TOL
