"""The port's serving Engine (quest_tpu_torch/engine/engine.py) and the
lane axis of the fused-run kernel's wrapper, against quest_tpu's Engine,
the oracle and its own loop of single requests.

- the same seeded sweeps through ``quest_tpu_torch.Engine`` and
  ``quest_tpu.engine.Engine``, on the JAX package's test ansatz (every
  liftable gate family) and on the bench's ``serving_ansatz(10, 2)``, raw
  and planned into fused runs (the JAX side's runs in interpret mode), f32
  and f64, on one device and over 4 CPU shards: each lane against the JAX
  package's lane (1e-10 f64, 2e-4 f32) and against the oracle;
- the JAX package's Engine contracts, as ported: the lane-batched batch
  equals a loop of ``run`` bit for bit; a warm submit builds nothing and
  hits the executable cache; a sharded env takes one sequential dispatch;
  close drains, ``close(drain=False)`` wakes a blocked waiter with the
  typed cancellation; value-free circuits, bad params, the telemetry
  series, deadlines, queue backpressure, poisoned-request bisection,
  transient dispatch faults, sentinel and watchdog health transitions and
  ``revive``, ``async_depth`` 0 and 2 (accepted, one synchronous path);
- the lane axis: ``fused_run_plain``, ``fused_run`` and ``swap_bit_blocks``
  on a (B, 2, 2^n) batch equal each lane run alone, with and without
  folded swaps, and ``torch.func.vmap`` of a fused run makes one batched
  call; on the card (``cuda``) a batched launch equals one-lane launches.

Every ``result()`` and join has a timeout, so a hang fails one test.
"""

import threading
import time
from concurrent.futures import Future

import jax
import numpy as np
import pytest
import torch

import quest_tpu as jq
from bench import serving_ansatz as j_serving_ansatz
from quest_tpu.circuits import Circuit as JCircuit
from quest_tpu.engine import Engine as JEngine
from quest_tpu.engine import P as JP
import quest_tpu_torch as tq
from quest_tpu_torch import fusion as F, telemetry
from quest_tpu_torch.circuits import serving_ansatz
from quest_tpu_torch.engine import Engine, P
from quest_tpu_torch.ops import fused_gates as FG
from quest_tpu_torch.resilience import (
    PoisonedRequestFault, QuESTBackpressureError, QuESTCancelledError,
    QuESTHangError, QuESTIntegrityError, QuESTTimeoutError, fault_plan,
    sentinel_policy, watchdog_deadline,
)
from quest_tpu_torch.validation import QuESTError

from . import oracle

F64_TOL, F32_TOL = 1e-10, 2e-4
DTYPES = {"f64": (torch.float64, 2, F64_TOL), "f32": (torch.float32, 1, F32_TOL)}
TENV = tq.createQuESTEnv(device="cpu")
TENV4 = tq.createQuESTEnv(devices=["cpu"] * 4)
JENV = jq.createQuESTEnv(jax.devices()[:1])
JENV4 = jq.createQuESTEnv(jax.devices()[:4])
WAIT = 60  # seconds any result() or join may take

VALS = (0.37, 1.234, -0.8, 2.2, 0.61, 1.9, -1.1)
NAMES = tuple(f"t{i}" for i in range(len(VALS)))


def _ansatz(circ, th, vec):
    """The JAX package's engine-test ansatz: every liftable gate family."""
    circ.hadamard(0)
    circ.rotateZ(1, th[0])
    circ.rotateX(2, th[1])
    circ.controlledNot(0, 2)
    circ.phaseShift(3, th[2])
    circ.controlledRotateY(1, 3, th[3])
    circ.multiRotateZ([0, 2, 4], th[4])
    circ.rotateAroundAxis(4, th[5], vec(1.0, 2.0, -0.5))
    circ.compactUnitary(2, complex(np.cos(0.3), 0.0), complex(0.0, np.sin(0.3)))
    circ.multiRotatePauli([0, 1], [1, 2], th[6])
    circ.controlledPhaseShift(0, 4, th[2])
    circ.tGate(4)


def _ansatz_pair(n):
    tc, jc = tq.Circuit(n), JCircuit(n)
    _ansatz(tc, [P(x) for x in NAMES], tq.Vector)
    _ansatz(jc, [JP(x) for x in NAMES], jq.Vector)
    return tc, jc


@pytest.fixture(autouse=True)
def _jax_kernel_signatures_left_as_found():
    """The JAX package records its first dispatch of each fused-run kernel
    signature in a process-wide set (``pallas_gates._SEEN_KERNEL_SIGS``)
    and times only that first dispatch. The JAX fused plans here dispatch
    9-qubit runs that ``tests/test_telemetry.py`` dispatches too and
    expects to be new; put the set back as each test found it, so that a
    file sharing this process sees no signature of ours."""
    from quest_tpu.ops import pallas_gates as PG
    seen = set(PG._SEEN_KERNEL_SIGS)
    yield
    PG._SEEN_KERNEL_SIGS.intersection_update(seen)


def _sweep(names, n_req, seed):
    rng = np.random.RandomState(seed)
    return [{k: float(v) for k, v in zip(names, rng.uniform(0, 6, len(names)))}
            for _ in range(n_req)]


# ---------------------------------------------------------------------------
# the oracle: the circuits' gates as dense matrices
# ---------------------------------------------------------------------------

_X = np.array([[0, 1], [1, 0]], dtype=complex)
_Y = np.array([[0, -1j], [1j, 0]])
_Z = np.diag([1.0 + 0j, -1.0])


def _rot(axis, theta):
    return np.cos(theta / 2) * np.eye(2) - 1j * np.sin(theta / 2) * axis


def _oracle_ansatz(n, p):
    th = [p[x] for x in NAMES]
    ax = np.array([1.0, 2.0, -0.5]) / np.linalg.norm([1.0, 2.0, -0.5])
    H = np.array([[1, 1], [1, -1]]) / np.sqrt(2)
    c, s = np.cos(0.3), np.sin(0.3)
    zzz = np.diag([np.exp(-0.5j * th[4] * (-1) ** bin(k).count("1")) for k in range(8)])
    steps = [
        ((0,), H, ()), ((1,), _rot(_Z, th[0]), ()), ((2,), _rot(_X, th[1]), ()),
        ((2,), _X, (0,)), ((3,), np.diag([1, np.exp(1j * th[2])]), ()),
        ((3,), _rot(_Y, th[3]), (1,)), ((0, 2, 4), zzz, ()),
        ((4,), _rot(ax[0] * _X + ax[1] * _Y + ax[2] * _Z, th[5]), ()),
        ((2,), np.array([[c, -(-1j * s)], [1j * s, c]]), ()),
    ]
    v = np.zeros(1 << n, dtype=complex)
    v[0] = 1
    for targets, m, ctrls in steps:
        v = oracle.full_operator(n, targets, m, controls=ctrls) @ v
    pauli = oracle.pauli_product_matrix(n, [0, 1], [1, 2])
    v = (np.cos(th[6] / 2) * np.eye(1 << n) - 1j * np.sin(th[6] / 2) * pauli) @ v
    v = oracle.full_operator(n, (4,), np.diag([1, np.exp(1j * th[2])]), controls=(0,)) @ v
    return oracle.full_operator(n, (4,), np.diag([1, np.exp(1j * np.pi / 4)])) @ v


def _oracle_serving(n, depth, p):
    v = np.zeros(1 << n, dtype=complex)
    v[0] = 1
    for layer in range(depth):
        for q in range(n):
            v = oracle.full_operator(n, (q,), _rot(_Z, p[f"a{layer}_{q}"])) @ v
            v = oracle.full_operator(n, (q,), _rot(_X, p[f"b{layer}_{q}"])) @ v
        for q in range(layer % 2, n - 1, 2):
            v = oracle.full_operator(n, (q + 1,), _X, controls=(q,)) @ v
        v = oracle.full_operator(n, (n - 1,), _Z, controls=(0,)) @ v
    return v


def _case(kind):
    """(port circuit, JAX circuit, oracle(params), n) of a comparison case."""
    if kind.startswith("ansatz"):
        n = 9
        tc, jc = _ansatz_pair(n)
        ref = lambda p: _oracle_ansatz(n, p)  # noqa: E731
    else:
        n = 10
        tc, jc = serving_ansatz(n, 2), j_serving_ansatz(n, 2)
        ref = lambda p: _oracle_serving(n, 2, p)  # noqa: E731
    return tc, jc, ref, n


def _complex(x) -> np.ndarray:
    if isinstance(x, (list, tuple)):
        return np.concatenate([_complex(s) for s in x])
    a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a[0] + 1j * a[1]


# ---------------------------------------------------------------------------
# against quest_tpu's Engine and the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("kind", ["ansatz", "ansatz_fused", "serving", "serving_fused"])
def test_engine_lanes_match_jax_engine_and_oracle(kind, dt):
    torch_dt, pc, tol = DTYPES[dt]
    tc, jc, ref, n = _case(kind)
    if kind.endswith("fused"):
        tb = 8 if kind.startswith("ansatz") else 9
        tc = tc.fused(max_qubits=5, pallas=True, tile_bits=tb, dtype=torch_dt)
        jc = jc.fused(max_qubits=5, pallas=True)
        assert any(f is F._apply_pallas_run for f, _a, _k in tc._tape)
    sweep = _sweep(tc.param_names, 3, seed=n + pc)
    with Engine(tc, TENV, precision_code=pc, max_batch=4, max_delay_ms=0.0) as eng:
        mine = [f.result(WAIT) for f in eng.submit_many(sweep)]
    with JEngine(jc, JENV, precision_code=pc, max_batch=4, max_delay_ms=0.0) as jeng:
        theirs = [f.result(WAIT) for f in jeng.submit_many(sweep)]
    for p, m, t in zip(sweep, mine, theirs):
        assert m.dtype == torch_dt and tuple(m.shape) == (2, 1 << n)
        np.testing.assert_allclose(_complex(m), _complex(t), atol=tol, rtol=0)
        np.testing.assert_allclose(_complex(m), ref(p), atol=tol, rtol=0)


def test_engine_sharded_matches_jax_engine_and_oracle():
    """Over 4 CPU shards both engines replay in sequence; the gathered lanes
    agree with the JAX package's and the oracle in f64."""
    n = 9
    tc, jc = _ansatz_pair(n)
    sweep = _sweep(NAMES, 3, seed=4)
    with Engine(tc, TENV4, precision_code=2, max_batch=4, max_delay_ms=0.0) as eng:
        assert eng.sharded
        mine = [f.result(WAIT) for f in eng.submit_many(sweep)]
    with JEngine(jc, JENV4, precision_code=2, max_batch=4, max_delay_ms=0.0) as jeng:
        theirs = [f.result(WAIT) for f in jeng.submit_many(sweep)]
    for p, m, t in zip(sweep, mine, theirs):
        assert isinstance(m, list) and len(m) == 4
        np.testing.assert_allclose(_complex(m), _complex(t), atol=F64_TOL, rtol=0)
        np.testing.assert_allclose(_complex(m), _oracle_ansatz(n, p), atol=F64_TOL, rtol=0)


# ---------------------------------------------------------------------------
# the JAX package's Engine contracts, as ported
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
def test_engine_vmap_batch_matches_loop_bit_identical(fused):
    tc, _ = _ansatz_pair(9)
    if fused:
        tc = tc.fused(max_qubits=5, pallas=True, tile_bits=8, dtype=torch.float64)
    with Engine(tc, TENV, precision_code=2, max_batch=8, max_delay_ms=0.0,
                initial="plus") as eng:
        eng.warmup(timeout=WAIT)
        sweep = _sweep(NAMES, 8, seed=11)
        traces = telemetry.counter_value("engine_trace_total", kind="param_replay")
        batched = [f.result(WAIT) for f in eng.submit_many(sweep)]
        looped = [eng.run(p, WAIT) for p in sweep]
        assert all(torch.equal(a, b) for a, b in zip(batched, looped))
        assert telemetry.counter_value("engine_trace_total", kind="param_replay") == traces


@pytest.mark.parametrize("fused", [False, True])
def test_engine_batch_body_is_capturable(fused):
    """The lane-batched body replays under ``_capture.rehearsal()`` (as the
    card captures it: staging frozen, host copies and syncs raise) to the
    same bits as its eager run."""
    from quest_tpu_torch import _capture
    from quest_tpu_torch.engine.engine import _BatchFn
    from quest_tpu_torch.engine.params import bind_host, stack_values

    tc = serving_ansatz(10, 2)
    if fused:
        tc = tc.fused(max_qubits=5, pallas=True, tile_bits=9, dtype=torch.float64)
    lifted = tc.lifted()
    fn = _BatchFn(tc, lifted, None)
    rows = [bind_host(lifted, p) for p in _sweep(tc.param_names, 3, seed=2)]
    vals = stack_values(lifted, rows, True, pad_to=4)
    assert vals.lanes == 4 and torch.equal(vals.tensors["real"][3], vals.tensors["real"][2])
    x = torch.zeros(2, 1 << 10, dtype=torch.float64)
    x[0, 0] = 1
    eager = fn(x, vals, 3)
    with _capture.rehearsal():
        again = fn(x, vals, 3)
    assert len(eager) == 3 and eager[0].shape == (2, 1 << 10)
    assert all(torch.equal(a, b) for a, b in zip(eager, again))
    assert x[0, 0] == 1 and x.abs().sum() == 1  # the initial state stays as it was
    fn.close()


def test_engine_fused_runs_one_batched_pass_per_run():
    """A served fused plan passes each run once for the whole batch (the
    pass counter moves by the plan's runs per dispatch, not runs x lanes),
    and the lanes are whole states."""
    tc = serving_ansatz(10, 2).fused(max_qubits=5, pallas=True, tile_bits=9,
                                     dtype=torch.float64)
    runs = sum(f is F._apply_pallas_run for f, _a, _k in tc._tape)
    assert runs > 0
    with Engine(tc, TENV, precision_code=2, max_batch=4, max_delay_ms=0.0) as eng:
        eng.warmup(timeout=WAIT)
        before = telemetry.counter_value("pallas_pass_total", kind="fused_run")
        outs = [f.result(WAIT) for f in eng.submit_many(_sweep(tc.param_names, 4, 7))]
        assert telemetry.counter_value("pallas_pass_total", kind="fused_run") == before + runs
    for o in outs:
        assert abs(float((o * o).sum()) - 1.0) < 1e-12


def test_engine_warm_submit_zero_retraces_cache_hits():
    tc, _ = _ansatz_pair(5)
    with Engine(tc, TENV, max_batch=4, max_delay_ms=0.0) as eng:
        eng.warmup(timeout=WAIT)
        traces = telemetry.counter_value("engine_trace_total", kind="param_replay")
        hits = telemetry.counter_value("plan_cache_hit_total", cache="executable")
        for p in _sweep(NAMES, 3, seed=5):
            eng.run(p, WAIT)
        assert telemetry.counter_value("engine_trace_total", kind="param_replay") == traces
        assert telemetry.counter_value("plan_cache_hit_total", cache="executable") >= hits + 3


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("max_batch", [4, 1])
def test_two_engines_over_one_structure_serve_their_own_lanes(max_batch, fused):
    """Two Engines over one structure share the batch executable (max_batch
    4) or the ``parameterized()`` one (max_batch 1, the sequential route):
    with different initial states and sweeps, submitted one by one from
    two threads while both batchers dispatch, every lane is its own
    engine's, held against the unbatched replay from that engine's
    initial state."""
    tc = serving_ansatz(8, 2)
    if fused:
        tc = tc.fused(max_qubits=5, pallas=True, tile_bits=8, dtype=torch.float64)
    sweeps = {"zero": _sweep(tc.param_names, 16, seed=21),
              "plus": _sweep(tc.param_names, 16, seed=22)}
    engines = {init: Engine(tc, TENV, precision_code=2, max_batch=max_batch,
                            max_delay_ms=0.0, initial=init) for init in sweeps}
    futs: dict = {}
    try:
        if max_batch > 1:
            assert engines["zero"]._execB() is engines["plus"]._execB()

        def client(init):
            futs[init] = [engines[init].submit(p) for p in sweeps[init]]

        threads = [threading.Thread(target=client, args=(init,)) for init in sweeps]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
            assert not t.is_alive()
        outs = {init: [f.result(WAIT) for f in fs] for init, fs in futs.items()}
    finally:
        for eng in engines.values():
            eng.close(timeout=WAIT)
    exe = tc.parameterized(donate=False)
    for init, got in outs.items():
        for p, o in zip(sweeps[init], got):
            want = exe(engines[init].initial_amps, p)
            assert float((o - want).abs().max()) < F64_TOL


def test_engine_sharded_sequential_one_dispatch():
    n = 8
    tc = tq.Circuit(n)
    _ansatz(tc, [P(x) for x in NAMES], tq.Vector)
    tc.rotateZ(n - 1, 0.25)
    with Engine(tc, TENV4, precision_code=2, max_batch=8, max_delay_ms=0.0) as eng:
        assert eng.sharded
        eng.warmup(timeout=WAIT)
        sweep = _sweep(NAMES, 8, seed=3)
        b0 = telemetry.counter_value("engine_batches_total", mode="sequential")
        traces = telemetry.counter_value("engine_trace_total", kind="param_replay")
        outs = [f.result(WAIT) for f in eng.submit_many(sweep)]
        assert telemetry.counter_value("engine_batches_total", mode="sequential") == b0 + 1
        assert telemetry.counter_value("engine_trace_total", kind="param_replay") == traces
        exe = tc.parameterized(donate=False)
        for p, o in zip(sweep, outs):
            assert len(o) == 4
            ref = exe([s.clone() for s in eng.initial_amps], p)
            assert all(torch.equal(a, b) for a, b in zip(ref, o))


def test_engine_close_drains_and_rejects():
    tc, _ = _ansatz_pair(5)
    eng = Engine(tc, TENV, max_batch=4, max_delay_ms=50.0)
    futs = eng.submit_many(_sweep(NAMES, 6, seed=1))
    eng.close(timeout=WAIT)
    assert all(f.done() for f in futs)
    assert {tuple(f.result(0).shape) for f in futs} == {(2, 32)}
    assert not eng.is_open()
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(dict(zip(NAMES, VALS)))


def test_engine_close_nodrain_resolves_blocked_waiters():
    tc, _ = _ansatz_pair(5)
    eng = Engine(tc, TENV, max_batch=1, max_delay_ms=0.0)
    gate = threading.Event()
    orig = eng._dispatch
    eng._dispatch = lambda b: (gate.wait(10), orig(b))
    futs = eng.submit_many(_sweep(NAMES, 4, seed=3))
    waited = {}

    def waiter():
        try:
            waited["out"] = futs[-1].result(timeout=WAIT)
        except BaseException as e:  # noqa: BLE001 - recorded for the assert
            waited["out"] = e

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.1)  # the loop is now blocked dispatching request 0
    threading.Timer(0.2, gate.set).start()
    eng.close(drain=False, timeout=WAIT)
    t.join(timeout=WAIT)
    assert not t.is_alive(), "waiter deadlocked on an unresolved future"
    assert all(f.done() for f in futs)
    assert isinstance(waited["out"], QuESTCancelledError)
    assert futs[0].exception(0) is None
    for f in futs[1:]:
        assert isinstance(f.exception(0), QuESTCancelledError)


def test_engine_value_free_circuit():
    c = tq.Circuit(3)
    c.hadamard(0)
    c.controlledNot(0, 1)
    c.pauliX(2)
    with Engine(c, TENV, precision_code=2, max_batch=4, max_delay_ms=0.0) as eng:
        outs = [f.result(WAIT) for f in eng.submit_many([None] * 4)]
    ref = tq.createQureg(3, TENV, 2)
    c.run(ref)
    assert all(torch.equal(o, ref.amps) for o in outs)


def test_engine_bad_params_raise_at_submit():
    tc, _ = _ansatz_pair(5)
    with Engine(tc, TENV, max_batch=2, max_delay_ms=0.0) as eng:
        with pytest.raises(QuESTError, match="missing values"):
            eng.submit({"nope": 1.0})
        with pytest.raises(ValueError, match="timeout"):
            eng.submit(dict(zip(NAMES, VALS)), timeout=-1)
    with pytest.raises(ValueError, match="max_batch"):
        Engine(tc, TENV, max_batch=0)


def test_engine_without_card_raises_like_create_env():
    """env=None is the card; without one the Engine raises as
    createQuESTEnv does, naming device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: env=None takes it")
    tc, _ = _ansatz_pair(5)
    with pytest.raises(QuESTError, match='device="cpu"'):
        Engine(tc)


def test_engine_telemetry_series():
    tc, _ = _ansatz_pair(5)
    r0 = telemetry.counter_value("engine_requests_total")
    with Engine(tc, TENV, max_batch=4, max_delay_ms=0.0) as eng:
        eng.warmup(timeout=WAIT)
        [f.result(WAIT) for f in eng.submit_many(_sweep(NAMES, 4, seed=9))]
    assert telemetry.counter_value("engine_requests_total") >= r0 + 4
    snap = telemetry.snapshot()
    assert any(k.startswith("engine_batch_size") for k in snap["histograms"])
    assert any(k.startswith("engine_request_latency_seconds") for k in snap["histograms"])
    assert snap["gauges"].get("engine_queue_depth") == 0
    assert snap["counters"]["engine_batches_total{mode=vmap}"] >= 2
    h = telemetry.histogram("engine_batch_size")
    assert h["count"] >= 2 and h["min"] >= 1
    assert any(e["name"] == "engine.start" for e in telemetry.events())


def _blocked(eng):
    """Hold the batcher in its next dispatch until the returned event is
    set."""
    gate = threading.Event()
    orig = eng._dispatch
    eng._dispatch = lambda b: (gate.wait(WAIT), orig(b))
    return gate


def test_engine_deadline_expires_queued_request():
    tc, _ = _ansatz_pair(5)
    with Engine(tc, TENV, max_batch=1, max_delay_ms=0.0) as eng:
        gate = _blocked(eng)
        first = eng.submit(dict(zip(NAMES, VALS)))
        time.sleep(0.05)
        t0 = telemetry.counter_value("engine_request_timeouts_total")
        late = eng.submit(dict(zip(NAMES, VALS)), timeout=0.01)
        time.sleep(0.05)
        gate.set()
        assert first.result(WAIT).shape == (2, 32)
        assert isinstance(late.exception(WAIT), QuESTTimeoutError)
        assert telemetry.counter_value("engine_request_timeouts_total") == t0 + 1


def test_engine_queue_backpressure():
    tc, _ = _ansatz_pair(5)
    with Engine(tc, TENV, max_batch=1, max_delay_ms=0.0, queue_max=2) as eng:
        gate = _blocked(eng)
        futs = [eng.submit(dict(zip(NAMES, VALS)))]
        time.sleep(0.05)  # the first is in dispatch; two may queue
        futs += eng.submit_many([dict(zip(NAMES, VALS))] * 2)
        b0 = telemetry.counter_value("engine_backpressure_total", reason="queue")
        with pytest.raises(QuESTBackpressureError) as info:
            eng.submit(dict(zip(NAMES, VALS)))
        assert info.value.reason == "queue"
        assert telemetry.counter_value("engine_backpressure_total", reason="queue") == b0 + 1
        gate.set()
        assert all(f.result(WAIT).shape == (2, 32) for f in futs)


@pytest.mark.parametrize("async_depth", [0, 2])
def test_engine_bisection_isolates_poisoned_request(async_depth):
    tc, _ = _ansatz_pair(5)
    sweep = _sweep(NAMES, 4, seed=21)
    with Engine(tc, TENV, max_batch=4, max_delay_ms=20.0, async_depth=async_depth) as eng:
        clean = [eng.run(p, WAIT) for p in sweep]
        b0 = telemetry.counter_value("engine_bisections_total")
        p0 = telemetry.counter_value("engine_poisoned_requests_total")
        with fault_plan("engine.request:poison:3"):
            futs = eng.submit_many(sweep)
            outs = [f.exception(WAIT) or f.result(0) for f in futs]
    assert isinstance(outs[2], PoisonedRequestFault)
    for i in (0, 1, 3):
        assert torch.equal(outs[i], clean[i])
    assert telemetry.counter_value("engine_bisections_total") > b0
    assert telemetry.counter_value("engine_poisoned_requests_total") == p0 + 1


def test_engine_transient_dispatch_fault_bisects_and_completes():
    tc, _ = _ansatz_pair(5)
    sweep = _sweep(NAMES, 4, seed=22)
    with Engine(tc, TENV, max_batch=4, max_delay_ms=20.0) as eng:
        clean = [eng.run(p, WAIT) for p in sweep]
        with fault_plan("engine.dispatch:transient:1"):
            outs = [f.result(WAIT) for f in eng.submit_many(sweep)]
    assert all(torch.equal(a, b) for a, b in zip(outs, clean))


def test_engine_sentinel_health_transitions_and_revive():
    """A corrupted result is never served: its future gets the integrity
    error and the engine degrades; three clean dispatches heal it; a second
    breach before healing quarantines it, which rejects submits until
    revive()."""
    tc, _ = _ansatz_pair(5)
    p = dict(zip(NAMES, VALS))
    with Engine(tc, TENV, max_batch=2, max_delay_ms=0.0) as eng, \
            sentinel_policy("norm,checksum"):
        assert eng.health() == "healthy"
        with fault_plan("state.corrupt:bitflip:1"):
            assert isinstance(eng.submit(p).exception(WAIT), QuESTIntegrityError)
            assert eng.health() == "degraded"
            for _ in range(3):
                eng.run(p, WAIT)
        assert eng.health() == "healthy"
        with fault_plan("state.corrupt:bitflip:1+"):
            for _ in range(2):
                assert isinstance(eng.submit(p).exception(WAIT), QuESTIntegrityError)
        assert eng.health() == "quarantined"
        with pytest.raises(QuESTBackpressureError) as info:
            eng.submit(p)
        assert info.value.reason == "quarantined"
        assert eng.revive() == "degraded"
        for _ in range(3):
            eng.run(p, WAIT)
        assert eng.health() == "healthy"
    assert telemetry.counter_value("sentinel_checks_total", kind="norm", outcome="breach") >= 3


def test_engine_watchdog_hang_quarantines():
    tc, _ = _ansatz_pair(5)
    p = dict(zip(NAMES, VALS))
    with Engine(tc, TENV, max_batch=2, max_delay_ms=0.0) as eng:
        eng.warmup(timeout=WAIT)
        with watchdog_deadline(50), fault_plan("engine.dispatch:hang:1"):
            err = eng.submit(p).exception(WAIT)
        assert isinstance(err, QuESTHangError) and err.site == "engine.dispatch"
        assert eng.health() == "quarantined"
        assert eng.revive() == "degraded"
        assert eng.run(p, WAIT).shape == (2, 32)


def test_engine_sync_and_ring_dispatch_same_bits():
    """``async_depth`` is accepted for the JAX package's signature; dispatch is
    synchronous whatever its value, so 0 and 2 serve the same bits."""
    tc = serving_ansatz(10, 2).fused(max_qubits=5, pallas=True, tile_bits=9,
                                     dtype=torch.float32)
    sweep = _sweep(tc.param_names, 6, seed=13)
    outs = {}
    for depth in (0, 2):
        with Engine(tc, TENV, max_batch=4, max_delay_ms=0.0, async_depth=depth) as eng:
            outs[depth] = [f.result(WAIT) for f in eng.submit_many(sweep)]
    assert all(torch.equal(a, b) for a, b in zip(outs[0], outs[2]))


@pytest.mark.parametrize("fused", [False, True])
def test_engine_finalize_serves_each_lanes_readout(fused):
    """A ``finalize`` composed into the batch program: each future resolves
    to the readout of its own lane, the same as the readout of the state
    the engine serves without it."""
    tc = serving_ansatz(10, 2)
    if fused:
        tc = tc.fused(max_qubits=5, pallas=True, tile_bits=9, dtype=torch.float64)

    def probs(amps):
        return (amps[0] ** 2 + amps[1] ** 2).reshape(4, -1).sum(1), amps[0].sum()

    sweep = _sweep(tc.param_names, 3, seed=17)
    with Engine(tc, TENV, precision_code=2, max_batch=4, max_delay_ms=0.0) as eng:
        states = [f.result(WAIT) for f in eng.submit_many(sweep)]
    with Engine(tc, TENV, precision_code=2, max_batch=4, max_delay_ms=0.0,
                finalize=probs) as eng:
        reads = [f.result(WAIT) for f in eng.submit_many(sweep)]
    for st, rd in zip(states, reads):
        want = probs(st)
        assert isinstance(rd, tuple) and rd[0].shape == (4,)
        assert torch.allclose(rd[0], want[0], atol=1e-14, rtol=0)
        assert torch.allclose(rd[1], want[1], atol=1e-14, rtol=0)


# ---------------------------------------------------------------------------
# the resilience layer under the Engine
# ---------------------------------------------------------------------------

def test_sync_qt602_checks_when_armed():
    from quest_tpu_torch.resilience import sync

    lock = sync.Lock("test.lock")
    cond = sync.Condition("test.cv")
    fut = Future()
    sync.reset_findings()
    sync.configure(True)
    try:
        with lock:
            assert sync.held_locks() == ("test.lock",)
            sync.guard_blocking("test.dispatch")
            assert sync.resolve_future(fut, result=1, site="test.resolve")
            assert not sync.resolve_future(fut, result=2, site="test.resolve")
            with cond:
                cond.wait(0.01)  # waits on one lock while holding another
        with pytest.raises(RuntimeError, match="un-acquired"):
            cond.wait(0.01)
        # the guard, both resolutions (the second finds it done) and the wait
        assert [f.code for f in sync.blocking_findings()] == ["QT602"] * 4
        assert telemetry.counter_value("lock_acquisitions_total", lock="test.lock") >= 1
    finally:
        sync.reset()
        sync.reset_findings()
    assert fut.result(0) == 1 and sync.held_locks() == ()


def test_fault_plans_parse_fire_and_check():
    from quest_tpu_torch.resilience import (FaultPlan, PoisonedRequestFault,
                                            TransientFault, faultinject)

    plan = FaultPlan.parse("engine.request:poison:2,bogus:x:1,engine.dispatch:transient:3+")
    assert [s.site for s in plan.specs] == ["engine.request", "engine.dispatch"]
    with pytest.raises(QuESTError, match="QT302"):
        FaultPlan.parse("engine.dispatch:poison:1", strict=True)
    with fault_plan(plan):
        assert faultinject.fire("engine.request") is None
        with pytest.raises(PoisonedRequestFault):
            faultinject.check("engine.request")
        faultinject.check("engine.dispatch")
        faultinject.check("engine.dispatch")
        for _ in range(2):
            with pytest.raises(TransientFault):
                faultinject.check("engine.dispatch")
        assert plan.visits("engine.dispatch") == 4
    assert not faultinject.enabled()


def test_sentinels_name_the_breach():
    from quest_tpu_torch.resilience import guard, sentinel

    rng = np.random.RandomState(3)
    v = oracle.random_statevec(6, rng)
    sv = torch.as_tensor(np.stack([v.real, v.imag]))
    rho = np.outer(v, v.conj()).T.reshape(-1)
    dm = torch.as_tensor(np.stack([rho.real, rho.imag]))
    pol = sentinel.SentinelPolicy.parse("norm,checksum,trace")
    assert sentinel.check_amps(sv, policy=pol) == []
    assert sentinel.check_amps(dm, density=True, policy=pol) == []
    shards = [c.clone() for c in sv.chunk(4, dim=1)]
    assert sentinel.check_amps(shards, policy=pol) == []
    with fault_plan("state.corrupt:bitflip2:1"):
        bad = guard.corrupt_amps(shards)
    assert torch.equal(torch.cat(shards, 1), sv)  # the live shards stay as they were
    codes = {f.code: f.message for f in sentinel.check_amps(bad, policy=pol)}
    assert set(codes) == {"QT401", "QT402"} and "shard 2" in codes["QT402"]
    with fault_plan("state.corrupt:bitflip:1"):
        bad_dm = guard.corrupt_amps(dm)
    assert {f.code for f in sentinel.check_amps(bad_dm, density=True, policy=pol)} == {
        "QT404", "QT402"}
    with pytest.raises(QuESTError, match="QT403"):
        sentinel.SentinelPolicy.parse("norm:every_0", strict=True)
    assert [s.cadence for s in sentinel.SentinelPolicy.parse("norm:every_3").specs] == [3]


# ---------------------------------------------------------------------------
# the lane axis of the fused-run wrapper
# ---------------------------------------------------------------------------

def _lane_batch(n, B, dt, seed):
    rng = np.random.RandomState(seed)
    x = torch.as_tensor(rng.randn(B, 2, 1 << n), dtype=dt)
    return x / x.flatten(1).norm(dim=1)[:, None, None]


def _run_ops(n, tb, seed):
    rng = np.random.RandomState(seed)
    u = oracle.random_unitary(1, rng)
    ops = (("matrix", 1, (), (), FG.HashableMatrix(u)),
           ("matrix", 3, (n - 1,), (1,), FG.HashableMatrix(oracle.random_unitary(1, rng))),
           ("parity", (0, 5, n - 2), (), 0.7),
           ("swap", 2, tb - 1, (), ()),
           ("diagw", (4, n - 1), (), FG.HashableMatrix(np.exp(1j * rng.uniform(0, 6, 4)))))
    return ops


@pytest.mark.parametrize("swaps", [(0, 0), (2, 0), (0, 2), (1, 1)])
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_lane_axis_plain_and_wrapper_equal_each_lane(swaps, dt):
    n, tb, B = 11, 9, 3
    lk, sk = swaps
    ops = _run_ops(n, tb, seed=lk + 2 * sk)
    prep = FG.PreparedRun(ops, tb)
    x = _lane_batch(n, B, dt, seed=5)
    kw = dict(n=n, tile_bits=tb, load_swap_k=lk, store_swap_k=sk)
    lanes = [FG.fused_run_plain(x[i], prep, **kw) for i in range(B)]
    assert torch.equal(FG.fused_run_plain(x, prep, **kw), torch.stack(lanes))
    out = torch.empty_like(x)
    got = FG.fused_run(x, ops=ops, prepared=prep, out=out, **kw)
    assert got is out and torch.equal(out, torch.stack(lanes))
    if not (lk or sk):
        y = x.clone()
        FG.fused_run(y, ops=ops, prepared=prep, **kw)
        assert torch.equal(y, torch.stack(lanes))


@pytest.mark.parametrize("blocks", [(3, 8, 1), (6, 9, 2), (0, 7, 3)])
def test_lane_axis_swap_bit_blocks_equal_each_lane(blocks):
    lo1, lo2, k = blocks
    n = 11
    x = _lane_batch(n, 4, torch.float64, seed=lo1)
    lanes = torch.stack([FG.swap_bit_blocks(a, n=n, lo1=lo1, lo2=lo2, k=k) for a in x])
    assert torch.equal(FG.swap_bit_blocks(x, n=n, lo1=lo1, lo2=lo2, k=k), lanes)
    out = torch.empty_like(x)
    FG.swap_bit_blocks(x, n=n, lo1=lo1, lo2=lo2, k=k, out=out)
    assert torch.equal(out, lanes)


def test_lane_axis_refuses_bad_batches():
    n, tb = 9, 8
    ops = _run_ops(n, tb, seed=1)
    with pytest.raises(ValueError, match="planar"):
        FG.fused_run(torch.zeros(2, 2, 2, 1 << n), n=n, ops=ops, tile_bits=tb)
    with pytest.raises(ValueError, match="lanes"):
        FG.fused_run(torch.zeros(0, 2, 1 << n), n=n, ops=ops, tile_bits=tb)


def test_vmap_of_a_fused_run_is_one_batched_call(monkeypatch):
    """``torch.func.vmap`` of the lane executor reaches ``fused_run`` once,
    with the whole (B, 2, 2^n) batch, and equals each lane alone."""
    n, tb, B = 10, 8, 5
    ops = _run_ops(n, tb, seed=3)
    prep = FG.PreparedRun(ops, tb)
    x = _lane_batch(n, B, torch.float64, seed=9)
    calls = []
    orig = FG.fused_run

    def spy(amps, **kw):
        calls.append(tuple(amps.shape))
        return orig(amps, **kw)

    monkeypatch.setattr(FG, "fused_run", spy)
    got = torch.func.vmap(lambda a: FG.fused_run_lanes(
        a, n=n, ops=ops, tile_bits=tb, store_swap_k=1, prepared=prep))(x)
    assert calls == [(B, 2, 1 << n)]
    want = torch.stack([FG.fused_run_plain(a, prep, n=n, tile_bits=tb, store_swap_k=1)
                        for a in x])
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_batched_launch_equals_one_lane_launches_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for dt, tb in ((torch.float32, 13), (torch.float64, 12)):
        n, B = 16, 4
        ops = _run_ops(n, tb, seed=2)
        prep = FG.PreparedRun(ops, tb)
        x = _lane_batch(n, B, dt, seed=1).cuda()
        out = torch.empty_like(x)
        launches = FG.fused_run.launches
        FG.fused_run(x, n=n, ops=ops, tile_bits=tb, prepared=prep, out=out, store_swap_k=2)
        assert FG.fused_run.launches == launches + 1
        for i in range(B):
            one = torch.empty_like(x[i])
            FG.fused_run(x[i].contiguous(), n=n, ops=ops, tile_bits=tb, prepared=prep,
                         out=one, store_swap_k=2)
            assert torch.equal(out[i], one)
