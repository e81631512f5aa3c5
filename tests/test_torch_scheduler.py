"""The explicit distributed scheduler of quest_tpu_torch
(``parallel.scheduler``: deferred layouts, batched relocations, collective
reconciliation, the journal, ``explicit_mesh`` / ``plan_circuit``) and the
comm pipeline of ``parallel.exchange``, against quest_tpu's on the emulated
CPU mesh and the dense numpy oracle (tests/oracle.py).

Port registers live on ``createQuESTEnv(devices=["cpu"] * d)`` (d virtual
CPU shards), quest_tpu's on d of its 8 CPU devices; both run the same
circuits, recorded on a ``quest_tpu`` tape and carried across
(``interop.circuit_from_tape``). Plans must agree key for key and record for
record, and quest_tpu's own verifier (``analysis.plancheck.check_schedule``)
must find nothing in the port's journals. States: 1e-10 in f64 (the
default precision here). The comm pipeline: every depth bit-identical to
depth 1.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _random_layers
import quest_tpu as jq
from quest_tpu import segments as JS
from quest_tpu.analysis.plancheck import check_schedule
from quest_tpu.circuits import Circuit as JCircuit
from quest_tpu.ops import pallas_df as PDF
from quest_tpu.ops.pallas_df import DF_SUBLANES
from quest_tpu.ops.pallas_gates import local_qubits
import quest_tpu_torch as tq
from quest_tpu_torch import fusion as F
from quest_tpu_torch import segments as TS
from quest_tpu_torch import telemetry
from quest_tpu_torch.interop import circuit_from_tape, state_to_numpy
from quest_tpu_torch.parallel import exchange as X
from quest_tpu_torch.parallel import scheduler as S
from quest_tpu_torch.validation import QuESTNotPortedError

from . import oracle
from .test_parallel import _build, _channel_suite

TOL = 1e-10


def _envs(d):
    return jq.createQuESTEnv(jax.devices()[:d]), tq.createQuESTEnv(devices=["cpu"] * d)


def _both(n, record, density=False):
    jc = JCircuit(n, density)
    record(jc)
    return jc, circuit_from_tape(jc._tape, n, density)


class _Eager:
    """Records by calling the package's API on a register."""

    def __init__(self, pkg, qureg):
        self.pkg, self.qureg = pkg, qureg

    def __getattr__(self, name):
        fn = getattr(self.pkg, name)
        return lambda *a, **k: fn(self.qureg, *a, **k)


def _records(journal) -> list:
    return [tuple(r) for r in journal]


def _assert_same_plan(jstats, tstats, jjournal, tjournal):
    assert set(jstats) == set(tstats)
    for k in jstats:
        assert tstats[k] == jstats[k], (k, jstats[k], tstats[k])
    assert _records(tjournal) == _records(jjournal)


# ---------------------------------------------------------------------------
# the oracle of _build (the dense operators of its gates)
# ---------------------------------------------------------------------------

_H = np.array([[1, 1], [1, -1]]) / np.sqrt(2)
_X = np.array([[0, 1], [1, 0]])
_SWAP = np.eye(4)[[0, 2, 1, 3]]


class _Oracle:
    """Records _build's gates as dense operators on a numpy state or
    density matrix (oracle.apply_to_statevec / apply_to_density)."""

    def __init__(self, n, state, density):
        self.n, self.state, self.density = n, state, density

    def _apply(self, targets, m, controls=()):
        f = oracle.apply_to_density if self.density else oracle.apply_to_statevec
        self.state = f(self.state, self.n, list(targets), m, list(controls))

    def hadamard(self, t):
        self._apply((t,), _H)

    def controlledNot(self, c, t):
        self._apply((t,), _X, (c,))

    def unitary(self, t, u):
        self._apply((t,), u)

    def controlledUnitary(self, c, t, u):
        self._apply((t,), u, (c,))

    def twoQubitUnitary(self, t1, t2, u):
        self._apply((t1, t2), u)

    def rotateZ(self, t, a):
        self._apply((t,), np.diag([np.exp(-0.5j * a), np.exp(0.5j * a)]))

    def multiControlledPhaseFlip(self, qs):
        self._apply((qs[-1],), np.diag([1, -1]), tuple(qs[:-1]))

    def multiRotateZ(self, qs, a):
        par = [bin(j).count("1") & 1 for j in range(1 << len(qs))]
        self._apply(tuple(qs), np.diag([np.exp(-0.5j * a * (1 - 2 * p)) for p in par]))

    def swapGate(self, a, b):
        self._apply((a, b), _SWAP)

    def multiQubitNot(self, qs):
        m = np.array([[1.0]])
        for _ in qs:
            m = np.kron(_X, m)
        self._apply(tuple(qs), m)


def _oracle_build(n, density, seed):
    N = 1 << n
    v = oracle.debug_statevec(N * N if density else N)
    state = v.reshape(N, N).T if density else v
    rec = _Oracle(n, state, density)
    _build(rec, n, np.random.RandomState(seed))
    out = rec.state.T.reshape(-1) if density else rec.state
    return np.stack([out.real, out.imag])


# ---------------------------------------------------------------------------
# states under explicit_mesh: the JAX package's explicit run and the oracle
# ---------------------------------------------------------------------------
# The JAX references run the tape compiled under explicit_mesh (its eager
# per-gate shard_map launches take minutes on the CPU mesh); the stats of
# an eager run are the plan of the immediate mode (no defer span), of a
# tape run the deferred plan.

def _jax_explicit_run(jc, n, density, d, init="debug"):
    jenv = jq.createQuESTEnv(jax.devices()[:d])
    q = (jq.createDensityQureg if density else jq.createQureg)(n, jenv)
    (jq.initDebugState if init == "debug" else jq.initPlusState)(q)
    with jq.explicit_mesh(jenv.mesh):
        jc.run(q)
    return np.asarray(q.amps)


@pytest.fixture(scope="module")
def build_refs():
    """(jax circuit, port circuit, the JAX explicit state, the oracle) of
    _build, state vector (5 qubits) and density (4)."""
    out = {}
    for density in (False, True):
        n = 4 if density else 5
        jc, tc = _both(n, lambda c: _build(c, n, np.random.RandomState(3)), density)
        out[density] = (jc, tc, _jax_explicit_run(jc, n, density, 8),
                        _oracle_build(n, density, 3))
    return out


@pytest.mark.parametrize("d", [4, 8])
@pytest.mark.parametrize("density", [False, True])
@pytest.mark.parametrize("route", ["eager", "tape"])
def test_build_under_explicit_mesh_matches_jax_and_oracle(build_refs, d, density, route):
    n = 4 if density else 5
    jc, tc, jref, oref = build_refs[density]
    jenv, tenv = _envs(d)
    tqr = (tq.createDensityQureg if density else tq.createQureg)(n, tenv)
    tq.initDebugState(tqr)
    with tq.explicit_mesh(tenv.devices) as ts:
        if route == "eager":
            _build(_Eager(tq, tqr), n, np.random.RandomState(3))
        else:
            tc.run(tqr)
    js = jq.parallel.plan_circuit(jc, jenv.mesh, defer=route == "tape")
    js.pop("comm_volume")
    assert ts.stats == js
    got = state_to_numpy(tqr)
    np.testing.assert_allclose(got, jref, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, oref, rtol=0, atol=TOL)
    assert len(tqr.shards) == d


@pytest.mark.parametrize("route", ["eager", "tape"])
def test_channels_under_explicit_mesh_match_jax(route):
    """Every mix* channel through the scheduler (the superoperator on the
    flattened qubits, relocated where sharded)."""
    n, d = 4, 8
    jc, tc = _both(n, lambda c: _channel_suite(c, n, np.random.RandomState(7)), True)
    jenv, tenv = _envs(d)
    tqr = tq.createDensityQureg(n, tenv)
    tq.initDebugState(tqr)
    with tq.explicit_mesh(tenv.devices) as ts:
        if route == "eager":
            _channel_suite(_Eager(tq, tqr), n, np.random.RandomState(7))
        else:
            tc.run(tqr)
    js = jq.parallel.plan_circuit(jc, jenv.mesh, defer=route == "tape")
    js.pop("comm_volume")
    assert ts.stats == js and ts.stats["channel_superops"] >= 10
    np.testing.assert_allclose(state_to_numpy(tqr), _jax_explicit_run(jc, n, True, d),
                               rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# plans: plan_circuit's stats and journal against the JAX package's
# ---------------------------------------------------------------------------

def _plan_both(jc, tc, d=8, **kw):
    jenv, tenv = _envs(d)
    jj, tj = [], []
    js = jq.parallel.plan_circuit(jc, jenv.mesh, journal=jj, **kw)
    ts = tq.plan_circuit(tc, tenv.devices, journal=tj, **kw)
    _assert_same_plan(js, ts, jj, tj)
    nsv = (2 if tc.is_density_matrix else 1) * tc.num_qubits
    assert check_schedule(tj, ts, nsv, jenv.mesh,
                          num_slices=kw.get("num_slices", 1)) == []
    return ts, tj


@pytest.fixture(scope="module")
def bench34():
    return _both(34, lambda c: _random_layers(c, 34, 8))


@pytest.mark.parametrize("kw", [{}, {"defer": False}, {"collective_reconcile": False},
                                {"batch_relocations": False}, {"num_slices": 2}],
                         ids=["deferred", "immediate", "chain", "unbatched", "two_slices"])
def test_bench_plan_matches_jax(bench34, kw):
    ts, tj = _plan_both(*bench34, **kw)
    assert tj[0][0] == "comm_pipeline"
    if kw.get("num_slices", 1) > 1:
        assert len(tj[0]) == 3 and ts["dcn_chunks"] > 0
    assert ts["ici_chunks"] + ts["dcn_chunks"] == pytest.approx(S.comm_chunks(ts))


@pytest.mark.parametrize("case", ["build", "build_two_slices", "density_channels",
                                  "mixed_operators"])
def test_plan_matches_jax(case):
    if case.startswith("build"):
        jc, tc = _both(5, lambda c: _build(c, 5, np.random.RandomState(3)))
        kw = {"num_slices": 2} if case == "build_two_slices" else {}
    elif case == "density_channels":
        jc, tc = _both(4, lambda c: _channel_suite(c, 4, np.random.RandomState(7)), True)
        kw = {}
    else:
        jc, tc = _both(34, _mixed_operator_tape)
        kw = {}
    ts, _ = _plan_both(jc, tc, **kw)
    if case == "mixed_operators":
        assert ts["comm_free"] >= 4


def _mixed_operator_tape(c, n=34):
    """tests/test_parallel.py:174's tape: QFT, phase functions, a
    projector and matrixN between random layers, all run under a live
    deferred layout."""
    from quest_tpu.datatypes import phaseFunc
    _random_layers(c, n, 3)
    c.applyQFT(list(range(n - 6, n)))
    _random_layers(c, n, 2)
    c.applyNamedPhaseFunc([0, 1, 2, n - 1], [4], 0, phaseFunc.NORM)
    c.applyPhaseFunc([2, n - 2], 0, [0.5], [2.0])
    c.applyProjector(n - 1, 0)
    c.applyMatrixN([0, 1], np.kron(np.eye(2), np.diag([1, 1j])))
    _random_layers(c, n, 3)


def test_segment_program_plans_match_jax():
    """A sliced replay per segment (each its own defer span, journaled as
    ("segment", lo)), against the JAX package's slice replays."""
    n, d = 20, 8
    jf, tf = _both(n, lambda c: _random_layers(c, n, 3))
    cuts = JS.segment_cuts(jf._tape, n, 12)
    assert cuts == TS.segment_cuts(tf._tape, n, 12) and len(cuts) > 2
    jenv, tenv = _envs(d)
    jj, tj = [], []
    with jq.explicit_mesh(jenv.mesh) as js:
        js.journal = jj
        for a, b in zip(cuts, cuts[1:]):
            jax.eval_shape(jf._replay_fn(None, lo=a, hi=b),
                           jax.ShapeDtypeStruct((2, 1 << n), np.float64))
    meta = [torch.empty((2, (1 << n) // d), dtype=torch.float64, device="meta")
            for _ in range(d)]
    with tq.explicit_mesh(tenv.devices) as ts:
        ts.journal = tj
        for a, b in zip(cuts, cuts[1:]):
            meta = tf._replay_fn(None, a, b)(meta)
    _assert_same_plan(js.stats, ts.stats, jj, tj)
    assert [r for r in tj if r[0] == "segment"] == [("segment", a) for a in cuts[:-1]]
    assert check_schedule(tj, ts.stats, n, jenv.mesh) == []


def test_segment_chain_under_explicit_mesh_matches_plain_run():
    """The compiled segment chain under explicit_mesh: each segment program
    a deferred span labelled with its cursor, the state equal to the
    JAX package's explicit run."""
    n, d = 10, 8
    jc, tc = _both(n, lambda c: _random_layers(c, n, 3))
    jenv, tenv = _envs(d)
    jqr, tqr = jq.createQureg(n, jenv), tq.createQureg(n, tenv)
    jq.initPlusState(jqr)
    tq.initPlusState(tqr)
    with jq.explicit_mesh(jenv.mesh):
        jc.run(jqr)
    with tq.explicit_mesh(tenv.devices) as ts:
        ts.journal = []
        chain = tc.compiled_segments(max_items=20)
        chain.run_register(tqr)
    assert chain.num_segments > 1
    segs = [r for r in ts.journal if r[0] == "segment"]
    assert len(segs) == chain.num_segments
    np.testing.assert_allclose(state_to_numpy(tqr), np.asarray(jqr.amps), rtol=0, atol=TOL)


def test_bench_circuit_chunk_units():
    """The 26q depth-8 bench circuit over 4 shards: the chunk units the
    JAX package's plan reads (raw tape: 13.0 deferred, 30.0 immediate, 16.5
    by the swap chain, 13.5 one swap at a time; the f64 fused plan 8
    collective frame transposes, 24.0 units)."""
    tenv = tq.createQuESTEnv(devices=["cpu"] * 4)
    c = tq.Circuit(26)
    tq.random_layers(c, 26, 8)
    units = {name: S.comm_chunks(tq.plan_circuit(c, tenv.devices, **kw))
             for name, kw in (("deferred", {}), ("immediate", {"defer": False}),
                              ("chain", {"collective_reconcile": False}),
                              ("unbatched", {"batch_relocations": False}))}
    assert units == {"deferred": 13.0, "immediate": 30.0, "chain": 16.5, "unbatched": 13.5}
    fz = c.fused(max_qubits=5, dtype=torch.float64, pallas=True, shard_devices=4)
    st = tq.plan_circuit(fz, tenv.devices, dtype=torch.float64)
    assert st["frame_transpose_collectives"] == 8
    assert st["frame_transpose_chunks"] == 24.0
    assert st["chunks_by_kind_link"] == {"frame_transpose/ici": 24.0}
    assert st["local"] == 0


def test_plan_circuit_34q_on_meta_in_seconds():
    """plan_circuit allocates nothing of size 2^n: 34 qubits over 8 meta
    shards (2 x 2^31 f64 amplitudes each, were they real)."""
    import time
    c = tq.Circuit(34)
    tq.random_layers(c, 34, 8)
    t0 = time.perf_counter()
    st = tq.plan_circuit(c, ("cpu",) * 8)
    assert time.perf_counter() - t0 < 5.0
    assert st["comm_volume"]["chunk_amps"] == 1 << 31 and st["pair_exchanges"] == 0


def test_plan_circuit_one_device_is_empty():
    c = tq.Circuit(3)
    c.hadamard(0)
    assert tq.plan_circuit(c, ("cpu",)) == {}


# ---------------------------------------------------------------------------
# the deferred layout
# ---------------------------------------------------------------------------

def test_deferred_swap_gate_is_virtual():
    jc, tc = _both(5, lambda c: (c.swapGate(0, 4), c.hadamard(4)))
    ts, tj = _plan_both(jc, tc)
    assert ts["virtual_swaps"] == 1 and ts["relocation_swaps"] == 0
    assert ts["reconcile_collectives"] >= 1 and ("virtual_swap", 0, 4) in tj


def test_deferred_falls_back_when_no_free_slot():
    """A sharded 1-qubit gate whose controls hold every local slot has no
    relocation room: the pair exchange, as in immediate mode."""
    n, d = 5, 8
    nl = 2
    jc, tc = _both(n, lambda c: c.multiControlledUnitary(list(range(nl)), n - 1,
                                                         oracle.random_unitary(1, np.random.RandomState(2))))
    ts, _ = _plan_both(jc, tc)
    assert ts["pair_exchanges"] == 1
    jenv, tenv = _envs(d)
    jqr, tqr = jq.createQureg(n, jenv), tq.createQureg(n, tenv)
    jq.initPlusState(jqr)
    tq.initPlusState(tqr)
    with jq.explicit_mesh(jenv.mesh), tq.explicit_mesh(tenv.devices):
        jc.run(jqr)
        tc.run(tqr)
    np.testing.assert_allclose(state_to_numpy(tqr), np.asarray(jqr.amps), rtol=0, atol=TOL)


def test_operator_entries_under_deferred_layout():
    """Phase functions, a projector, matrixN, a sub-diagonal op and QFT run
    on the permuted layout (tests/test_parallel.py:205): the same state as
    the JAX package's explicit run and the plain replay."""
    from quest_tpu.datatypes import createSubDiagonalOp, phaseFunc
    n, d = 5, 8
    nl = 2
    sub = createSubDiagonalOp(1)
    sub.elems[:] = [1.0, 1j]

    def rec(c):
        c.hadamard(n - 1)
        c.hadamard(nl)
        c.applyPhaseFunc([0, n - 1], 0, [0.3], [2.0])
        c.applyNamedPhaseFunc([1, n - 1], [2], 0, phaseFunc.NORM)
        c.applyQFT([0, 1, n - 1])
        c.applyMatrixN([n - 1], np.diag([1.0, 1j]))
        c.applySubDiagonalOp([n - 2], sub)
        c.applyProjector(n - 1, 0)
        c.hadamard(0)

    jc, tc = _both(n, rec)
    ts, _ = _plan_both(jc, tc)
    assert ts["relocation_swaps"] + ts["relocation_batch_qubits"] >= 1
    assert ts["comm_free"] >= 5
    jenv, tenv = _envs(d)
    jqr, tqr, plain = jq.createQureg(n, jenv), tq.createQureg(n, tenv), tq.createQureg(n, tenv)
    for q in (tqr, plain):
        tq.initPlusState(q)
    jq.initPlusState(jqr)
    with jq.explicit_mesh(jenv.mesh), tq.explicit_mesh(tenv.devices):
        jc.run(jqr)
        tc.run(tqr)
    tc.run(plain)
    got = state_to_numpy(tqr)
    np.testing.assert_allclose(got, np.asarray(jqr.amps), rtol=0, atol=TOL)
    np.testing.assert_allclose(got, state_to_numpy(plain), rtol=0, atol=TOL)


def test_measurement_under_explicit_mesh():
    tenv = tq.createQuESTEnv(devices=["cpu"] * 8)
    tq.seedQuEST(tenv, [5])
    q = tq.createQureg(5, tenv)
    tq.initZeroState(q)
    with tq.explicit_mesh(tenv.devices) as ts:
        tq.hadamard(q, 4)
        tq.controlledNot(q, 4, 0)
        outcome = tq.measure(q, 4)
        assert tq.measure(q, 0) == outcome
    assert ts.stats["pair_exchanges"] == 1
    assert abs(tq.calcTotalProb(q) - 1) < TOL


def test_abort_defer_after_an_exception():
    """An entry that raises inside a deferred replay leaves no stale layout:
    the next replay starts from the identity."""
    n, d = 5, 8
    tenv = tq.createQuESTEnv(devices=["cpu"] * d)

    def boom(qureg):
        raise RuntimeError("boom")

    c = tq.Circuit(n)
    c.hadamard(n - 1)
    c.append(boom)
    q = tq.createQureg(n, tenv)
    with tq.explicit_mesh(tenv.devices) as ts:
        with pytest.raises(RuntimeError, match="boom"):
            c.as_fn()(q.shards)
        assert not ts.deferring and ts._pos is None and ts._future is None
        ok = tq.Circuit(n)
        ok.hadamard(0)
        tq.initPlusState(q)
        ok.run(q)
    ref = tq.createQureg(n, tenv)
    tq.initPlusState(ref)
    ok.run(ref)
    np.testing.assert_allclose(state_to_numpy(q), state_to_numpy(ref), rtol=0, atol=TOL)


def test_trajectory_site_under_explicit_mesh():
    """A trajectory site on a sharded target is a barrier under the
    scheduler (the layout reconciles before it); the draw is the env
    engine's, the operator goes through the scheduler: the same state as
    outside the context."""
    n, d = 6, 8
    tenv = tq.createQuESTEnv(devices=["cpu"] * d)
    k = 1 / np.sqrt(2)
    ops = [np.array([[k, 0], [0, k]]), np.array([[0, k], [k, 0]])]
    c = tq.Circuit(n)
    for q in range(n):
        c.hadamard(q)
    c.rotateX(n - 1, 0.4)
    c.applyTrajectoryKraus([n - 1, 1], [np.kron(a, b) for a in ops for b in ops], 7, 0)
    c.hadamard(n - 2)
    q, ref = tq.createQureg(n, tenv), tq.createQureg(n, tenv)
    with tq.explicit_mesh(tenv.devices) as ts:
        c.run(q)
    c.run(ref)
    assert ts.stats["local"] > 0
    np.testing.assert_allclose(state_to_numpy(q), state_to_numpy(ref), rtol=0, atol=TOL)


def test_capture_in_one_thread_leaves_other_threads_gates_alone(monkeypatch):
    """The lookahead's capture (``fusion.capture(aux=True)``) diverts the
    primitives in its own thread only: a gate applied meanwhile in another
    thread (the Engine's batcher, a pool replica) computes."""
    import contextlib
    import threading

    inside, done, out = threading.Event(), threading.Event(), []
    orig = F._capture_ctx

    @contextlib.contextmanager
    def held(events):
        with orig(events):
            inside.set()
            done.wait(10)
            yield

    monkeypatch.setattr(F, "_capture_ctx", held)
    q = tq.createQureg(3, tq.createQuESTEnv(device="cpu"))
    tq.initZeroState(q)
    t = threading.Thread(target=lambda: out.append(
        F.capture(tq.multiQubitUnitary, ([0, 1], np.eye(4)), {}, 3,
                  torch.float64, aux=True)))
    t.start()
    assert inside.wait(10)
    tq.hadamard(q, 0)
    tq.applyPhaseFunc(q, [0], 0, [np.pi], [1.0])
    done.set()
    t.join(10)
    assert abs(tq.getProbAmp(q, 1) - 0.5) < 1e-6
    assert abs(tq.getImagAmp(q, 1)) < 1e-6 and tq.getRealAmp(q, 1) < -0.7
    assert out and out[0] is not None


def test_hierarchical_is_not_ported():
    with pytest.raises(QuESTNotPortedError, match="9.3"):
        with tq.explicit_mesh(("cpu",) * 8, hierarchical=True):
            pass
    with pytest.raises(QuESTNotPortedError, match="9.3"):
        tq.plan_circuit(tq.Circuit(5), ("cpu",) * 8, hierarchical=True)


def test_scheduler_binds_only_its_mesh():
    """Outside the context, or on a register of another mesh, the env's
    immediate engine runs the gates; an executable built under a mode
    pins it wherever it is called."""
    tenv = tq.createQuESTEnv(devices=["cpu"] * 4)
    q = tq.createQureg(5, tenv)
    with tq.explicit_mesh(("cpu",) * 8) as other:
        assert S.engine(q) is tenv.engine and not tenv.engine.allow_defer
    assert other.stats["local"] == 0
    c = tq.Circuit(5)
    c.hadamard(4)
    with tq.explicit_mesh(tenv.devices, defer=False) as ts:
        assert S.engine(q) is ts
        exe = c.compiled()
    assert tq.parallel.active() is None
    telemetry.reset()
    exe.run_register(q)  # pinned: a fresh immediate-mode scheduler
    assert telemetry.counter_value("comm_chunk_units_total", kind="pair_exchange",
                                   link="ici") == 2.0


# ---------------------------------------------------------------------------
# fused plans under the scheduler
# ---------------------------------------------------------------------------

def test_f64_fused_plan_runs_per_shard_under_scheduler(monkeypatch):
    """A sharded f64 register's fused runs under the scheduler: one
    per-shard pass of the fused-run kernel (its plain version here) a
    shard, joined by the counted frame transposes; the plan's stats equal
    the JAX package's (its df route, switched on by ``pallas_df._DF_ENV``:
    eval_shape only),
    the state the default sharded route's."""
    monkeypatch.setenv(PDF._DF_ENV, "1")
    assert PDF.df_wanted()
    n, d = 10, 4
    jc, tc = _both(n, lambda c: _random_layers(c, n, 3))
    jf = jc.fused(max_qubits=5, dtype=np.float64, pallas=True, shard_devices=d)
    tf = tc.fused(max_qubits=5, dtype=torch.float64, pallas=True, shard_devices=d,
                  tile_bits=local_qubits(n - 2, DF_SUBLANES))
    jenv, tenv = _envs(d)
    jj, tj = [], []
    js = jq.parallel.plan_circuit(jf, jenv.mesh, dtype=np.float64, journal=jj)
    ts = tq.plan_circuit(tf, tenv.devices, dtype=torch.float64, journal=tj)
    _assert_same_plan(js, ts, jj, tj)
    assert ts["frame_transpose_collectives"] == 8 and ts["local"] == 0
    runs = sum(1 for f, _a, _k in tf._tape if f is F._apply_pallas_run)
    q, ref = tq.createQureg(n, tenv), tq.createQureg(n, tenv)
    for r in (q, ref):
        tq.initPlusState(r)
    telemetry.reset()
    with tq.explicit_mesh(tenv.devices) as sched:
        tf.run(q)
    assert telemetry.counter_value("pallas_pass_total", kind="fused_run") == runs * d
    assert telemetry.counter_total("engine_fallback_total") == 0
    assert {k: sched.stats[k] for k in ("frame_transpose_collectives",
                                        "frame_transpose_chunks")} == \
        {"frame_transpose_collectives": 8, "frame_transpose_chunks": ts["frame_transpose_chunks"]}
    tf.run(ref)
    np.testing.assert_allclose(state_to_numpy(q), state_to_numpy(ref), rtol=0, atol=1e-12)


def test_f32_fused_plan_counts_explicit_scheduler_fallback():
    """An f32 register's runs take the per-shard kernel under the
    scheduler too (the JAX package replays them through its per-gate
    engine, counted as ``engine_fallback_total{reason=explicit_scheduler}``;
    the port does not): one pass a shard a run, no fallback, the frame
    transposes counted at the f32 scale (1x) as the meta plan counts them,
    the state the default sharded route's."""
    n, d = 10, 4
    tenv = tq.createQuESTEnv(devices=["cpu"] * d)
    c = tq.Circuit(n)
    tq.random_layers(c, n, 3)
    fz = c.fused(max_qubits=5, dtype=torch.float32, pallas=True, shard_devices=d)
    runs = sum(1 for f, _a, _k in fz._tape if f is F._apply_pallas_run)
    plan = tq.plan_circuit(fz, tenv.devices, dtype=torch.float32)
    assert plan["frame_transpose_collectives"] > 0
    assert plan["frame_transpose_chunks"] == plan["frame_transpose_planar_chunks"]
    q, ref = tq.createQureg(n, tenv, 1), tq.createQureg(n, tenv, 1)
    for r in (q, ref):
        tq.initPlusState(r)
    telemetry.reset()
    with tq.explicit_mesh(tenv.devices) as sched:
        fz.run(q)
    assert runs > 0
    assert telemetry.counter_value("pallas_pass_total", kind="fused_run") == runs * d
    assert telemetry.counter_total("engine_fallback_total") == 0
    keys = ("frame_transpose_collectives", "frame_transpose_chunks", "local")
    assert {k: sched.stats[k] for k in keys} == {k: plan[k] for k in keys}
    fz.run(ref)
    np.testing.assert_array_equal(state_to_numpy(q), state_to_numpy(ref))


# ---------------------------------------------------------------------------
# the comm pipeline
# ---------------------------------------------------------------------------

PN = 6  # nl = 3 on 8 shards: qubits 3..5 sharded, a shard is 8 columns


def _shards(planes=2, seed=0, d=8, dtype=torch.float64):
    rng = np.random.RandomState(seed)
    a = rng.normal(size=(planes, 1 << PN))
    return [torch.tensor(p, dtype=dtype) for p in np.split(a, d, axis=1)]


def _u1(seed=1):
    u = oracle.random_unitary(1, np.random.RandomState(seed))
    return torch.tensor(np.stack([u.real, u.imag]))


_D2 = torch.tensor(np.stack([np.cos(np.arange(4.0)), np.sin(np.arange(4.0))]))

#: every launch site, with local and sharded controls where it takes them
SITES = {
    "pair_exchange": lambda a, p: X.dist_apply_matrix1(
        a, _u1(), n=PN, target=5, controls=(1, 4), control_states=(1, 0), pipeline=p),
    "pair_exchange_conj": lambda a, p: X.dist_apply_matrix1(
        a, _u1(), n=PN, target=4, controls=(0,), control_states=(1,), conj=True,
        pipeline=p),
    "local_matrix": lambda a, p: X.dist_apply_local_matrix(
        a, _u1(), n=PN, targets=(1,), controls=(0, 5), control_states=(1, 1), pipeline=p),
    "x_permute": lambda a, p: X.dist_apply_x(
        a, n=PN, targets=(5, 4, 1, 2), controls=(0,), control_states=(1,), pipeline=p),
    "x_permute_sharded_only": lambda a, p: X.dist_apply_x(
        a, n=PN, targets=(3, 5), controls=(2,), control_states=(0,), pipeline=p),
    "grouped_permute": lambda a, p: X.dist_permute_bits(
        a, n=PN, source=(5, 1, 2, 4, 3, 0), pipeline=p),
    "diag_phase": lambda a, p: X.dist_apply_diag_phase(
        a, _D2, n=PN, targets=(5, 0), controls=(1,), control_states=(1,), pipeline=p),
    "diag_phase_conj": lambda a, p: X.dist_apply_diag_phase(
        a, _D2, n=PN, targets=(2, 4), conj=True, pipeline=p),
    "parity_phase": lambda a, p: X.dist_apply_parity_phase(
        a, 0.37, n=PN, qubits=(5, 1), controls=(0,), control_states=(1,), pipeline=p),
    "swap_local": lambda a, p: X.dist_swap(a, n=PN, qb1=0, qb2=2, pipeline=p),
    "swap_rank_permute": lambda a, p: X.dist_swap(a, n=PN, qb1=4, qb2=5, pipeline=p),
    "swap_odd_parity": lambda a, p: X.dist_swap(a, n=PN, qb1=0, qb2=5, pipeline=p),
    "swap_odd_parity_high": lambda a, p: X.dist_swap(a, n=PN, qb1=2, qb2=5, pipeline=p),
}


@pytest.mark.parametrize("depth", [2, 4, 8])
@pytest.mark.parametrize("site", sorted(SITES))
def test_pipelined_site_is_bit_identical(site, depth):
    a = _shards(seed=3)
    base = torch.cat(SITES[site](a, 1), dim=1)
    got = torch.cat(SITES[site](a, depth), dim=1)
    assert torch.equal(base, got), f"{site} diverged at depth {depth}"


@pytest.mark.parametrize("mover", ["grouped_permute", "swap_rank_permute",
                                   "swap_odd_parity", "x_permute_sharded_only"])
def test_data_movers_carry_four_planes(mover):
    a = _shards(planes=4, seed=5, dtype=torch.float32)
    base = torch.cat(SITES[mover](a, 1), dim=1)
    assert base.shape == (4, 1 << PN)
    for depth in (2, 4):
        assert torch.equal(base, torch.cat(SITES[mover](a, depth), dim=1))


def test_depth_eight_slice_width_one_edge():
    """Depth 8 on the 8-column shard: slice width 1, every local X target
    an XOR of the slice index."""
    a = _shards(seed=7)
    fn = lambda p: torch.cat(X.dist_apply_x(a, n=PN, targets=(5, 1, 2), pipeline=p), dim=1)  # noqa: E731
    assert torch.equal(fn(1), fn(8))
    assert X.effective_comm_pipeline(8, 1 << 3) == 8


def test_pipeline_schedule_order():
    """Transfer k+1 is issued before compute k; every transfer once."""
    log = []
    out = X._pipeline_schedule(4, lambda j: log.append(("t", j)) or j,
                               lambda k, got: log.append(("c", k)) or got,
                               src=lambda k: k ^ 1)
    assert out == [1, 0, 3, 2]
    assert log == [("t", 1), ("t", 0), ("c", 0), ("t", 3), ("c", 1), ("t", 2),
                   ("c", 2), ("c", 3)]


def test_effective_comm_pipeline_clamp():
    E = X.effective_comm_pipeline
    assert E(1, 4096) == 1
    assert E(3, 4096) == 2
    assert E(0, 8) == 1
    assert E(-2, 8) == 1
    assert E(64, 8) == 8
    assert E(8, 6) == 4
    assert E(8, 1) == 1


def _mix_circuit(n, density=False):
    """Every dispatch class: pair exchange, X permute, swaps in all three
    regimes, diagonal and parity phases, a relocation."""
    u2 = oracle.random_unitary(1, np.random.RandomState(7))
    c = JCircuit(n, density)
    c.hadamard(0)
    c.hadamard(n - 1)
    c.controlledNot(n - 1, 0)
    c.controlledNot(0, n - 1)
    c.unitary(n - 2, u2)
    c.rotateZ(n - 1, 0.31)
    c.multiRotateZ([0, n - 1], -0.7)
    c.swapGate(0, 1)
    c.swapGate(1, n - 1)
    c.swapGate(n - 2, n - 1)
    c.multiQubitNot([0, n - 1])
    c.tGate(n - 1)
    return c, circuit_from_tape(c._tape, n, density)


@pytest.mark.parametrize("defer", [True, False])
@pytest.mark.parametrize("density", [False, True])
def test_explicit_scheduler_depth_ab_bit_identical(density, defer):
    n = 3 if density else 5
    _jc, tc = _mix_circuit(n, density)
    tenv = tq.createQuESTEnv(devices=["cpu"] * 8)
    make = tq.createDensityQureg if density else tq.createQureg
    outs = {}
    for pipe in (1, 2, 4):
        q = make(n, tenv)
        tq.initDebugState(q)
        with tq.explicit_mesh(tenv.devices, comm_pipeline=pipe, defer=defer):
            tc.run(q)
        outs[pipe] = state_to_numpy(q)
    assert np.array_equal(outs[1], outs[2]) and np.array_equal(outs[1], outs[4])


def test_fused_plan_pipeline_stamp_and_depth_ab(monkeypatch):
    """``fused(comm_pipeline=)`` stamps every run and frame swap; the f64
    per-shard plan's frame transposes run at that depth, bit-identically."""
    n, d = 10, 4
    c = tq.Circuit(n)
    tq.random_layers(c, n, 3)
    tenv = tq.createQuESTEnv(devices=["cpu"] * d)
    outs = {}
    for pipe in (1, 4):
        fz = c.fused(max_qubits=5, dtype=torch.float64, pallas=True, shard_devices=d,
                     comm_pipeline=pipe, comm_pipeline_dcn=pipe)
        items = [a[0] for f, a, _k in fz._tape
                 if f in (F._apply_pallas_run, F._apply_frame_swap)]
        assert items and all(it.comm_pipeline == pipe == it.comm_pipeline_dcn
                             for it in items)
        q = tq.createQureg(n, tenv)
        tq.initPlusState(q)
        telemetry.reset()
        with tq.explicit_mesh(tenv.devices):
            fz.run(q)
        assert telemetry.gauge_value("comm_pipeline_depth") in (1, pipe)
        outs[pipe] = state_to_numpy(q)
    assert np.array_equal(outs[1], outs[4])


def test_journal_stamp_and_depth_invariant_pricing():
    jc, tc = _mix_circuit(5)
    tenv = tq.createQuESTEnv(devices=["cpu"] * 8)
    jenv = jq.createQuESTEnv(jax.devices()[:8])
    res = {}
    for pipe in (1, 4):
        tj = []
        st = tq.plan_circuit(tc, tenv.devices, journal=tj, comm_pipeline=pipe)
        assert tj[0] == ("comm_pipeline", pipe)
        assert check_schedule(tj, st, 5, jenv.mesh) == []
        res[pipe] = (st, tj)
    assert res[1][0] == res[4][0] and res[1][1][1:] == res[4][1][1:]
    jj = []
    jq.parallel.plan_circuit(jc, jenv.mesh, journal=jj, comm_pipeline=4)
    assert _records(jj) == _records(res[4][1])
    # the executed depth-4 replay counts exactly the modelled chunk units
    q = tq.createQureg(5, tenv)
    tq.initDebugState(q)
    telemetry.reset()
    with tq.explicit_mesh(tenv.devices, comm_pipeline=4):
        tc.run(q)
    ran = telemetry.counter_total("comm_chunk_units_total")
    assert ran == pytest.approx(S.comm_chunks(res[4][0]), abs=1e-9)


def test_two_slice_journal_stamps_dcn_depth(monkeypatch):
    monkeypatch.delenv("QUEST_COMM_PIPELINE_DCN", raising=False)
    _jc, tc = _mix_circuit(8)
    tj = []
    tq.plan_circuit(tc, ("cpu",) * 8, num_slices=2, journal=tj, comm_pipeline=2,
                    comm_pipeline_dcn=4)
    assert tj[0] == ("comm_pipeline", 2, 4)
    tj = []
    tq.plan_circuit(tc, ("cpu",) * 8, num_slices=2, journal=tj, comm_pipeline=2)
    assert tj[0] == ("comm_pipeline", 2, 2)


def test_slice_bits_and_links():
    from quest_tpu.parallel import mesh as JM
    jmesh = jq.createQuESTEnv(jax.devices()[:8]).mesh
    for ns in (1, 2, 4, 8):
        assert tq.parallel.slice_chip_bits(("cpu",) * 8, ns) == JM.slice_chip_bits(jmesh, ns)
        for q in range(10):
            assert (tq.parallel.shard_bit_link(10, ("cpu",) * 8, ns, q)
                    == JM.shard_bit_link(10, jmesh, ns, q))
    for bad in (3, 16):
        with pytest.raises(ValueError):
            tq.parallel.slice_chip_bits(("cpu",) * 8, bad)


@pytest.fixture
def pipe_env(monkeypatch):
    monkeypatch.setattr(X, "_PIPE_ENV_WARNED", set())
    monkeypatch.setattr(X, "_PIPE_DCN_ENV_WARNED", set())
    return monkeypatch


def test_pipe_env_non_integer_warns_once_and_defaults(pipe_env):
    pipe_env.setenv("QUEST_COMM_PIPELINE", "fast")
    telemetry.reset()
    with pytest.warns(RuntimeWarning, match="QT206.*not an integer; using 1"):
        assert X.comm_pipeline_default() == 1
    assert telemetry.counter_value("analysis_findings_total", code="QT206",
                                   severity="warning") == 1.0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert X.comm_pipeline_default() == 1


def test_pipe_env_below_minimum_clamps_to_monolithic(pipe_env):
    pipe_env.setenv("QUEST_COMM_PIPELINE", "0")
    with pytest.warns(RuntimeWarning, match="QT206.*below 1; using 1"):
        assert X.comm_pipeline_default() == 1


def test_pipe_dcn_env(pipe_env):
    pipe_env.delenv("QUEST_COMM_PIPELINE_DCN", raising=False)
    assert X.comm_pipeline_dcn_default() is None
    assert X.resolve_pipeline_dcn(None, 2) == 2
    pipe_env.setenv("QUEST_COMM_PIPELINE_DCN", "4")
    assert X.resolve_pipeline_dcn(None, 2) == 4
    assert X.resolve_pipeline_dcn(8, 2) == 8
    pipe_env.setenv("QUEST_COMM_PIPELINE_DCN", "x")
    with pytest.warns(RuntimeWarning, match="QT210"):
        assert X.comm_pipeline_dcn_default() == 1


def test_pipe_env_threads_to_launch_and_gauge(pipe_env):
    pipe_env.setenv("QUEST_COMM_PIPELINE", "2")
    a = _shards(seed=9)
    telemetry.reset()
    via_env = torch.cat(SITES["swap_rank_permute"](a, None), dim=1)
    assert telemetry.gauge_value("comm_pipeline_depth") == 2
    assert torch.equal(via_env, torch.cat(SITES["swap_rank_permute"](a, 2), dim=1))


def test_eager_launch_observes_collective_histogram():
    """An eager launch inside an explicit_mesh context is timed; one on the
    default sharded route, or with telemetry off, is not."""
    telemetry.reset()
    SITES["swap_rank_permute"](_shards(seed=11), 4)
    assert telemetry.histogram("comm_collective_ms", kind="swap_rank_permute",
                               pipeline=4) == {}
    with tq.explicit_mesh(("cpu",) * 8):
        SITES["swap_rank_permute"](_shards(seed=11), 4)
        assert telemetry.histogram("comm_collective_ms", kind="swap_rank_permute",
                                   pipeline=4)["count"] == 1
        with telemetry.disabled():
            SITES["swap_rank_permute"](_shards(seed=11), 4)
    assert telemetry.histogram("comm_collective_ms", kind="swap_rank_permute",
                               pipeline=4)["count"] == 1


def test_pending_observations_resolve_without_waiting(monkeypatch):
    """At the pending bound only the observations whose device work is done
    resolve; the rest wait (the oldest dropped past half the bound), so no
    launch waits for the device. Reading the histogram resolves them all."""
    monkeypatch.setattr(telemetry, "_MAX_PENDING", 8)
    telemetry.reset()
    done = [False]
    for i in range(7):
        telemetry.observe_later("h", lambda: 1.0, ready=lambda: done[0], kind="late")
    telemetry.observe_later("h", lambda: 2.0, ready=lambda: True, kind="now")
    assert len(telemetry._pending) == 4
    assert telemetry._hists[telemetry._key("h", {"kind": "now"})]["count"] == 1
    assert telemetry.histogram("h", kind="late")["count"] == 4
    assert telemetry._pending == []
