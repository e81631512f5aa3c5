"""The port's replica pool (quest_tpu_torch/engine/pool.py) and retry
policy (resilience/retry.py), the cases of tests/test_pool.py and
tests/test_resilience.py's retry tests, as ported:

- pool-served results equal a lone Engine over the same structure bit for
  bit (the replicas share its executable), and quest_tpu's EnginePool on
  the same sweep within 1e-10 (f64) / 2e-4 (f32);
- routing: health first (quarantined never routes), structure affinity,
  then load -- the health-transition matrix; mixed structures spread;
- a ``pool.replica:kill`` failover loses no request and serves the same
  bits (one device and 4 CPU shards); the replacement is warmed from the
  manifest and serves its first request with zero retraces;
- admission: quota exhaustion is typed (``reason="quota"``), the reserve
  admits high priority; parked requests drain high first, ``close``
  cancels them typed, ``revive`` serves them;
- hedging: the hedge completes a stalled degraded primary with the same
  bits; ``precompile`` ranks by request count over the LRU's ``peek``;
- the QT307 knobs; ``submit_grad`` through the pool against
  ``Engine.submit_grad``;
- ``call_with_retry``'s seeded schedule (equal to the JAX package's),
  outcomes, deadline and env knobs.

Every ``result()`` and join has a timeout, and every pool is closed in a
``finally`` (or a ``with``), so a hang fails one test.
"""

import threading
import time
import warnings

import jax
import numpy as np
import pytest
import torch

import quest_tpu as jq
from quest_tpu.circuits import Circuit as JCircuit
from quest_tpu.engine import EnginePool as JEnginePool
from quest_tpu.engine import P as JP
from quest_tpu.resilience.retry import RetryPolicy as JRetryPolicy
import quest_tpu_torch as tq
from quest_tpu_torch import telemetry
from quest_tpu_torch.engine import (AdmissionController, Engine, EnginePool, P,
                                    TokenBucket)
from quest_tpu_torch.engine import admission as _admission
from quest_tpu_torch.engine import pool as _pool
from quest_tpu_torch.resilience import faultinject
from quest_tpu_torch.resilience import retry as _retry
from quest_tpu_torch.resilience.errors import (KernelCompileFault, QuESTBackpressureError,
                                               QuESTCancelledError, QuESTRetryError,
                                               TransientFault)
from quest_tpu_torch.resilience.retry import RetryPolicy, call_with_retry, default_policy
from quest_tpu_torch.validation import QuESTError

ENV1 = tq.createQuESTEnv(device="cpu")
ENV4 = tq.createQuESTEnv(devices=["cpu"] * 4)
JENV = jq.createQuESTEnv(jax.devices()[:1])
WAIT = 60
F64_TOL, F32_TOL = 1e-10, 2e-4

_TRACE = dict(kind="param_replay")


def _ansatz(cls=tq.Circuit, PP=P, n=3):
    c = cls(n)
    for q in range(n):
        c.rotateY(q, PP(f"t{q}"))
    for q in range(n - 1):
        c.controlledNot(q, q + 1)
    for q in range(n):
        c.rotateZ(q, PP(f"p{q}"))
    return c


def _other(n=3):
    """A structurally DIFFERENT circuit (another fingerprint)."""
    c = tq.Circuit(n)
    c.hadamard(0)
    for q in range(n):
        c.rotateX(q, P(f"x{q}"))
    return c


def _params(c, seed):
    rng = np.random.default_rng(seed)
    return {name: float(v) for name, v in zip(c.lifted().param_names, rng.uniform(-2, 2, 64))}


def _block(eng):
    """Stall ``eng``'s dispatches behind an Event; returns the gate."""
    gate = threading.Event()
    orig = eng._dispatch_one

    def blocked(batch, mode, served):
        gate.wait(30)
        return orig(batch, mode, served)

    eng._dispatch_one = blocked
    return gate


def _np(x):
    if isinstance(x, (list, tuple)):
        return np.concatenate([_np(s) for s in x], axis=-1)
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _equal(a, b) -> bool:
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


# ---------------------------------------------------------------------------
# serving: bit identity, quest_tpu, affinity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec", [2, 1])
def test_pool_results_bit_identical_to_lone_engine_and_match_jax(prec):
    c = _ansatz()
    plist = [_params(c, s) for s in range(6)]
    with Engine(c, ENV1, precision_code=prec, max_batch=4, max_delay_ms=0.0) as eng:
        oracle = [f.result(WAIT) for f in [eng.submit(p) for p in plist]]
    pool = EnginePool(ENV1, replicas=2, precision_code=prec, max_batch=4, max_delay_ms=0.0)
    try:
        got = [f.result(WAIT) for f in pool.submit_many(c, plist)]
    finally:
        pool.close()
    for o, g in zip(oracle, got):
        assert torch.equal(o, g)
    jpool = JEnginePool(JENV, replicas=2, precision_code=prec, max_batch=4, max_delay_ms=0.0)
    try:
        theirs = [f.result(WAIT) for f in jpool.submit_many(_ansatz(JCircuit, JP), plist)]
    finally:
        jpool.close()
    tol = F64_TOL if prec == 2 else F32_TOL
    for g, t in zip(got, theirs):
        np.testing.assert_allclose(_np(g), np.asarray(t), atol=tol, rtol=0)


def test_structure_affinity_and_spread():
    a, b = _ansatz(), _other()
    pool = EnginePool(ENV1, replicas=2, max_batch=2, max_delay_ms=0.0)
    try:
        for s in range(3):
            pool.submit(a, _params(a, s)).result(WAIT)
        owners_a = [r.id for r in pool._replicas if a.fingerprint() in r.engines]
        assert len(owners_a) == 1  # same-structure traffic stays on one replica
        pool.submit(b, _params(b, 0)).result(WAIT)
        owners_b = [r.id for r in pool._replicas if b.fingerprint() in r.engines]
        assert len(owners_b) == 1 and owners_b != owners_a  # a new structure spreads
        assert pool.frequencies == {a.fingerprint(): 3, b.fingerprint(): 1}
        assert set(pool.manifest) == {a.fingerprint(), b.fingerprint()}
    finally:
        pool.close()


def test_health_transition_routing_matrix():
    pool = EnginePool(ENV1, replicas=3, spawn_replacements=False)
    try:
        r0, r1, r2 = pool._replicas
        fp = "fp-under-test"
        with pool._cv:
            assert pool._select_locked(fp) is r0  # all healthy, all cold: lowest id
        r0.state = "degraded"
        with pool._cv:
            assert pool._select_locked(fp) is r1  # healthy before degraded
            assert pool._select_locked(fp, allow_degraded=False) is r1
        r1.state = "quarantined"
        with pool._cv:
            assert pool._select_locked(fp) is r2  # quarantined never routes
        r2.state = "degraded"
        with pool._cv:
            assert pool._select_locked(fp) in (r0, r2)  # degraded still routes...
            assert pool._select_locked(fp, allow_degraded=False) is None  # ...not for hedges
        r1.state = "healthy"
        stub = type("EngStub", (), {"health": lambda self: "healthy"})()
        r1.engines[fp] = stub  # the affinity marker
        with pool._cv:
            assert pool._select_locked(fp) is r1  # healthy and affine wins
        del r1.engines[fp]
        assert set(pool.health()) == {0, 1, 2}
        assert pool.rotation() == [0, 1, 2]
    finally:
        pool.close()


# ---------------------------------------------------------------------------
# failover: zero lost, bit for bit, one device and 4 shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env", [ENV1, ENV4], ids=["vmap", "sharded4"])
def test_failover_drain_zero_lost_bit_identical(env):
    c = _ansatz()
    plist = [_params(c, s) for s in range(5)]
    with Engine(c, env, max_batch=4, max_delay_ms=0.0) as eng:
        oracle = [f.result(WAIT) for f in [eng.submit(p) for p in plist]]
    f0 = telemetry.counter_value("pool_failovers_total", reason="kill")
    q0 = telemetry.counter_value("pool_quarantines_total", reason="kill")
    pool = EnginePool(env, replicas=2, max_batch=4, max_delay_ms=0.0, spawn_replacements=False)
    try:
        with faultinject.fault_plan("pool.replica:kill:2"):
            futs = pool.submit_many(c, plist)
            got = [f.result(WAIT) for f in futs]  # ZERO lost
        assert all(f.done() and f.exception() is None for f in futs)
        assert telemetry.counter_value("pool_failovers_total", reason="kill") == f0 + 1
        assert telemetry.counter_value("pool_quarantines_total", reason="kill") == q0 + 1
        assert "quarantined" in pool.health().values() and len(pool.rotation()) == 1
    finally:
        pool.close()
    for o, g in zip(oracle, got):
        assert _equal(o, g)


def test_replacement_spawn_and_warm_zero_retrace():
    c = _ansatz()
    r0 = telemetry.counter_value("pool_replacements_total", reason="kill")
    pool = EnginePool(ENV1, replicas=2, max_batch=2, max_delay_ms=0.0)
    try:
        pool.submit(c, _params(c, 0)).result(WAIT)
        with faultinject.fault_plan("pool.replica:kill:1"):
            assert pool.submit(c, _params(c, 1)).result(WAIT) is not None
        pool.await_rotation(2, timeout=WAIT)  # the replacement warmed and joined
        assert telemetry.counter_value("pool_replacements_total", reason="kill") == r0 + 1
        new_rep = max(pool._replicas, key=lambda r: r.id)
        assert new_rep.id == 2 and new_rep.in_rotation and c.fingerprint() in new_rep.engines
        tr0 = telemetry.counter_value("engine_trace_total", **_TRACE)
        new_rep.engines[c.fingerprint()].submit(_params(c, 2)).result(WAIT)
        assert telemetry.counter_value("engine_trace_total", **_TRACE) == tr0
    finally:
        pool.close()


def test_warm_from_manifest_explicit_replica_zero_retrace():
    c = _ansatz()
    pool = EnginePool(ENV1, replicas=2, max_batch=2, max_delay_ms=0.0)
    try:
        pool.submit(c, _params(c, 0)).result(WAIT)
        cold = next(r for r in pool._replicas if c.fingerprint() not in r.engines)
        assert pool.warm_from_manifest(replica=cold.id) == [c.fingerprint()]
        tr0 = telemetry.counter_value("engine_trace_total", **_TRACE)
        res = cold.engines[c.fingerprint()].submit(_params(c, 3)).result(WAIT)
        assert telemetry.counter_value("engine_trace_total", **_TRACE) == tr0
        hot = next(r for r in pool._replicas if r is not cold)
        res2 = hot.engines[c.fingerprint()].submit(_params(c, 3)).result(WAIT)
        assert torch.equal(res, res2)
        with pytest.raises(ValueError, match="no replica"):
            pool.warm_from_manifest(replica=99)
    finally:
        pool.close()


def test_precompile_ranks_by_frequency_over_peek():
    a, b = _ansatz(), _other()
    pool = EnginePool(ENV1, replicas=1, max_batch=2, max_delay_ms=0.0)
    try:
        for s in range(3):
            pool.submit(a, _params(a, s)).result(WAIT)
        pool.submit(b, _params(b, 0)).result(WAIT)
        w0 = telemetry.counter_value("engine_precompile_total", outcome="warmed")
        c0 = telemetry.counter_value("engine_precompile_total", outcome="cached")
        assert pool.precompile() == [a.fingerprint(), b.fingerprint()]
        assert telemetry.counter_value("engine_precompile_total", outcome="cached") == c0 + 2
        assert telemetry.counter_value("engine_precompile_total", outcome="warmed") == w0
        assert pool.precompile(limit=1) == [a.fingerprint()]
    finally:
        pool.close()


def test_concurrent_submitters_with_a_kill_lose_nothing():
    """16 threads (more than the cores) submit through one pool at a short
    switch interval while a replica dies: every future resolves to the lone
    Engine's bits, and the request counter sees every request once."""
    import sys

    a, b = _ansatz(), _other()
    work = [((a, b)[i % 2], _params((a, b)[i % 2], i)) for i in range(64)]
    oracle = []
    for c in (a, b):
        with Engine(c, ENV1, max_batch=4, max_delay_ms=0.0) as eng:
            oracle.append([f.result(WAIT) for f in eng.submit_many(
                [p for cc, p in work if cc is c])])
    want = [oracle[i % 2][i // 2] for i in range(len(work))]
    r0 = telemetry.counter_value("pool_requests_total", tenant="stress", priority="normal")
    got = [None] * len(work)
    pool = EnginePool(ENV1, replicas=3, max_batch=4, max_delay_ms=0.5)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker(k):
            for i in range(k, len(work), 16):
                c, p = work[i]
                got[i] = pool.submit(c, p, tenant="stress").result(WAIT)

        with faultinject.fault_plan("pool.replica:kill:20"):
            threads = [threading.Thread(target=worker, args=(k,)) for k in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(WAIT)
        assert not any(t.is_alive() for t in threads)
        assert "quarantined" in pool.health().values()
    finally:
        sys.setswitchinterval(old)
        pool.close()
    assert telemetry.counter_value("pool_requests_total", tenant="stress",
                                   priority="normal") == r0 + len(work)
    assert all(g is not None and torch.equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# admission, parked requests, revive
# ---------------------------------------------------------------------------

def test_token_bucket_reserve_non_starvation():
    t = [0.0]
    b = TokenBucket(4, clock=lambda: t[0])  # burst 4, reserve 1
    assert [b.take(priority="normal") for _ in range(4)] == [True, True, True, False]
    assert b.take(priority="high")          # the reserve admits high
    assert not b.take(priority="high")      # empty rejects everyone
    t[0] += 0.5                             # 2 tokens back
    assert b.take(priority="normal")
    with pytest.raises(ValueError):
        b.take(priority="urgent")


def test_pool_quota_exhaustion_typed_and_counted():
    c = _ansatz()
    adm = AdmissionController(4, clock=lambda: 0.0)  # frozen: no refill
    names = [("admission_admitted_total", "acme", "normal"),
             ("admission_admitted_total", "acme", "high"),
             ("admission_rejected_total", "acme", "normal")]
    before = [telemetry.counter_value(n, tenant=t, priority=p) for n, t, p in names]
    q0 = telemetry.counter_value("engine_backpressure_total", reason="quota")
    pool = EnginePool(ENV1, replicas=1, max_batch=2, max_delay_ms=0.0, admission=adm)
    try:
        futs = [pool.submit(c, _params(c, s), tenant="acme") for s in range(3)]
        with pytest.raises(QuESTBackpressureError) as ei:
            pool.submit(c, _params(c, 9), tenant="acme")
        assert ei.value.reason == "quota"
        futs.append(pool.submit(c, _params(c, 4), tenant="acme", priority="high"))
        [f.result(WAIT) for f in futs]
        pool.submit(c, _params(c, 5), tenant="other").result(WAIT)  # its own bucket
    finally:
        pool.close()
    after = [telemetry.counter_value(n, tenant=t, priority=p) for n, t, p in names]
    assert [a - b for a, b in zip(after, before)] == [3.0, 1.0, 1.0]
    assert telemetry.counter_value("engine_backpressure_total", reason="quota") == q0 + 1


def test_parked_requests_drain_in_priority_order_and_close_cancels():
    c = _ansatz()
    q0 = telemetry.counter_value("admission_queued_total", tenant="default", priority="high")
    p0 = telemetry.counter_value("pool_routes_total", outcome="parked")
    pool = EnginePool(ENV1, replicas=1, max_batch=2, max_delay_ms=0.0,
                      spawn_replacements=False)
    try:
        pool.submit(c, _params(c, 0)).result(WAIT)
        pool._quarantine(pool._replicas[0], reason="test")
        fn = pool.submit(c, _params(c, 1))
        fh = pool.submit(c, _params(c, 2), priority="high")
        assert not fn.done() and not fh.done()  # parked, not rejected
        assert telemetry.counter_value("admission_queued_total", tenant="default",
                                       priority="high") == q0 + 1
        assert telemetry.counter_value("pool_routes_total", outcome="parked") == p0 + 2
        with pool._cv:
            assert len(pool._pending["high"]) == 1 and len(pool._pending["normal"]) == 1
    finally:
        pool.close()
    for f in (fn, fh):
        with pytest.raises(QuESTCancelledError):
            f.result(10)
    with pytest.raises(RuntimeError, match="closed"):
        pool.submit(c, _params(c, 3))


def test_parked_requests_serve_after_revive_high_first():
    c = _ansatz()
    pool = EnginePool(ENV1, replicas=1, max_batch=2, max_delay_ms=0.0,
                      spawn_replacements=False)
    try:
        pool.submit(c, _params(c, 0)).result(WAIT)
        pool._quarantine(pool._replicas[0], reason="test")
        order = []
        fn = pool.submit(c, _params(c, 1))
        fh = pool.submit(c, _params(c, 2), priority="high")
        fn.add_done_callback(lambda f: order.append("normal"))
        fh.add_done_callback(lambda f: order.append("high"))
        assert pool.revive(0) == "healthy"
        assert tuple(fn.result(WAIT).shape) == (2, 8) and fh.result(WAIT) is not None
        assert order[0] == "high"
        with pytest.raises(ValueError, match="no replica"):
            pool.revive(7)
    finally:
        pool.close()


# ---------------------------------------------------------------------------
# hedged dispatch
# ---------------------------------------------------------------------------

def test_hedged_dispatch_winner_determinism():
    c = _ansatz()
    p = _params(c, 7)
    with Engine(c, ENV1, max_batch=2, max_delay_ms=0.0) as eng:
        oracle = eng.submit(p).result(WAIT)
    i0 = telemetry.counter_value("pool_hedges_total", outcome="issued")
    w0 = telemetry.counter_value("pool_hedges_total", outcome="won_hedge")
    pool = EnginePool(ENV1, replicas=2, max_batch=2, max_delay_ms=0.0, hedge_ms=40)
    try:
        pool.submit(c, _params(c, 0)).result(WAIT)  # builds the affine engine
        rep = next(r for r in pool._replicas if r.engines)
        eng0 = rep.engines[c.fingerprint()]
        gate = _block(eng0)                          # the primary stalls...
        try:
            fut = pool.submit(c, p)
            eng0._note_breach(hang=False)            # ...and is degraded
            got = fut.result(WAIT)                   # the hedge completes it
        finally:
            gate.set()
        assert torch.equal(oracle, got)
        assert telemetry.counter_value("pool_hedges_total", outcome="issued") >= i0 + 1
        assert telemetry.counter_value("pool_hedges_total", outcome="won_hedge") >= w0 + 1
    finally:
        pool.close()


# ---------------------------------------------------------------------------
# QT307 env knobs
# ---------------------------------------------------------------------------

@pytest.fixture
def knob_env(monkeypatch):
    monkeypatch.setattr(_pool, "_REPLICAS_WARNED", set())
    monkeypatch.setattr(_pool, "_HEDGE_WARNED", set())
    monkeypatch.setattr(_admission, "_QPS_WARNED", set())
    return monkeypatch


@pytest.mark.parametrize("env_var,reader,default", [
    ("QUEST_POOL_REPLICAS", _pool._env_replicas, 2),
    ("QUEST_HEDGE_MS", _pool._env_hedge_ms, 0),
    ("QUEST_TENANT_QPS", _admission._env_tenant_qps, 0),
])
def test_qt307_warns_once_and_defaults(knob_env, env_var, reader, default):
    knob_env.setenv(env_var, "lots")
    f0 = telemetry.counter_value("analysis_findings_total", code="QT307", severity="warning")
    with pytest.warns(RuntimeWarning, match="QT307"):
        assert reader() == default
    assert telemetry.counter_value("analysis_findings_total", code="QT307",
                                   severity="warning") == f0 + 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the second call stays silent
        assert reader() == default


def test_qt307_below_minimum_clamps(knob_env):
    knob_env.setenv("QUEST_POOL_REPLICAS", "0")
    with pytest.warns(RuntimeWarning, match="QT307"):
        assert _pool._env_replicas() == 1
    knob_env.setenv("QUEST_HEDGE_MS", "-5")
    with pytest.warns(RuntimeWarning, match="QT307"):
        assert _pool._env_hedge_ms() == 0


def test_env_knobs_wellformed_values_apply(knob_env):
    knob_env.setenv("QUEST_POOL_REPLICAS", "3")
    knob_env.setenv("QUEST_HEDGE_MS", "25")
    knob_env.setenv("QUEST_TENANT_QPS", "7")
    pool = EnginePool(ENV1)
    try:
        assert len(pool._replicas) == 3
        assert pool.hedge_s == pytest.approx(0.025)
        assert pool.admission.default_qps == 7
    finally:
        pool.close()
    with pytest.raises(ValueError, match="replicas"):
        EnginePool(ENV1, replicas=0)
    with pytest.raises(ValueError, match="hedge_ms"):
        EnginePool(ENV1, replicas=1, hedge_ms=-1)


# ---------------------------------------------------------------------------
# gradients through the pool
# ---------------------------------------------------------------------------

def test_submit_grad_through_pool_matches_engine_submit_grad():
    c = _ansatz(n=4)
    r = np.random.RandomState(2)
    ham = (r.randint(0, 4, size=(3, 4)).astype(np.int32), r.normal(size=3))
    plist = [_params(c, s) for s in range(3)]
    eng = Engine(c, ENV1, precision_code=2, hamiltonian=ham, max_batch=4, max_delay_ms=0.0)
    try:
        want = [f.result(WAIT) for f in [eng.submit_grad(p) for p in plist]]
    finally:
        eng.close(timeout=WAIT)
    g0 = telemetry.counter_value("grad_requests_total")
    pool = EnginePool(ENV1, replicas=2, precision_code=2, max_batch=4, max_delay_ms=0.0)
    try:
        got = [f.result(WAIT) for f in pool.submit_grad_many(c, plist, hamiltonian=ham)]
        one = pool.submit_grad(c, plist[0], hamiltonian=ham).result(WAIT)
        gfp = next(fp for fp in pool.manifest if fp.startswith("grad:"))
        assert gfp.endswith(c.fingerprint())
        fresh = EnginePool(ENV1, replicas=1, precision_code=2)
        try:
            with pytest.raises(KeyError, match="submit_grad"):
                fresh.warm_from_manifest({gfp: c})
        finally:
            fresh.close()
    finally:
        pool.close()
    assert telemetry.counter_value("grad_requests_total") == g0 + 4
    for (v, g), (wv, wg) in zip(got + [one], want + want[:1]):
        assert torch.equal(v, wv)
        assert set(g) == set(wg) and all(torch.equal(g[k], wg[k]) for k in g)


# ---------------------------------------------------------------------------
# Engine.close(drain=True) on a quarantined engine, typed errors
# ---------------------------------------------------------------------------

def test_quarantined_engine_drain_close_cancels_queued_promptly():
    c = _ansatz()
    eng = Engine(c, ENV1, max_batch=1, max_delay_ms=0.0)
    eng.run(_params(c, 0), WAIT)
    gate = _block(eng)
    closer = None
    closed = threading.Event()
    try:
        f1 = eng.submit(_params(c, 1))            # picked up, then blocked
        deadline = time.monotonic() + 10
        while eng._q and time.monotonic() < deadline:
            time.sleep(0.005)
        f2 = eng.submit(_params(c, 2))            # still queued
        eng._note_breach(hang=True)
        assert eng.health() == "quarantined"
        closer = threading.Thread(target=lambda: (eng.close(drain=True), closed.set()))
        closer.start()
        with pytest.raises(QuESTCancelledError):
            f2.result(timeout=10)
        assert not closed.is_set()
    finally:
        gate.set()
    closer.join(30)
    assert closed.is_set()
    assert f1.done()


def test_typed_errors():
    e = QuESTBackpressureError("m", "f", reason="quota")
    assert e.reason == "quota" and QuESTBackpressureError("m", "f").reason is None
    assert issubclass(QuESTRetryError, QuESTError) and tq.QuESTRetryError is QuESTRetryError
    assert faultinject.SITES["pool.replica"] == ("kill", "hang")
    with pytest.raises(QuESTError, match="QT302"):
        faultinject.FaultPlan.parse("pool.replica:bitflip:1", strict=True)


# ---------------------------------------------------------------------------
# the retry policy
# ---------------------------------------------------------------------------

def test_retry_schedule_is_deterministic_capped_and_equal_to_jax():
    pol = RetryPolicy(max_attempts=5, base_delay_s=0.004, multiplier=2.0, max_delay_s=0.01,
                      seed=7)
    a, b = list(pol.delays()), list(pol.delays())
    assert a == b and len(a) == 4
    assert all(0.002 <= d <= 0.01 for d in a)
    assert list(RetryPolicy(max_attempts=5, seed=8).delays()) != \
        list(RetryPolicy(max_attempts=5, seed=7).delays())
    jpol = JRetryPolicy(max_attempts=5, base_delay_s=0.004, multiplier=2.0, max_delay_s=0.01,
                        seed=7)
    assert a == list(jpol.delays())


def test_call_with_retry_outcomes_and_exhaustion():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise TransientFault("x", "transient")
        return 42

    def count(site, outcome):
        return telemetry.counter_value("retry_attempts_total", site=site, outcome=outcome)

    r0, k0, e0 = count("tx", "retried"), count("tx", "ok"), count("ty", "exhausted")
    pol = RetryPolicy(max_attempts=3, base_delay_s=0.0)
    slept = []
    assert call_with_retry(flaky, site="tx", policy=pol, sleep=slept.append) == 42
    assert count("tx", "retried") == r0 + 2 and count("tx", "ok") == k0 + 1
    assert len(slept) == 2

    def always():
        raise TransientFault("y", "transient")

    with pytest.raises(TransientFault):
        call_with_retry(always, site="ty", policy=pol, sleep=lambda _d: None)
    assert count("ty", "exhausted") == e0 + 1

    def permanent():
        calls.append(1)
        raise KernelCompileFault("z", "compile")

    n = len(calls)
    with pytest.raises(KernelCompileFault):  # not retryable: one attempt
        call_with_retry(permanent, site="tz", policy=pol, sleep=lambda _d: None)
    assert len(calls) == n + 1
    assert call_with_retry(lambda: 5, site="tz", policy=pol) == 5  # first try: silent
    assert count("tz", "ok") == 0


def test_call_with_retry_deadline_stops_early(monkeypatch):
    t = {"now": 0.0}

    def always():
        t["now"] += 0.02
        raise TransientFault("d", "transient")

    monkeypatch.setattr(_retry.time, "monotonic", lambda: t["now"])
    pol = RetryPolicy(max_attempts=10, base_delay_s=0.001, deadline_s=0.05)
    e0 = telemetry.counter_value("retry_attempts_total", site="dl", outcome="exhausted")
    slept = []
    with pytest.raises(TransientFault):
        call_with_retry(always, site="dl", policy=pol, sleep=slept.append)
    assert len(slept) < 9  # the deadline, not the attempt budget, stopped it
    assert all(d <= 0.05 for d in slept)
    assert telemetry.counter_value("retry_attempts_total", site="dl",
                                   outcome="exhausted") == e0 + 1


def test_default_policy_env_knobs_and_qt303(monkeypatch):
    monkeypatch.setattr(_retry, "_ENV_WARNED", set())
    monkeypatch.setenv("QUEST_RETRY_MAX", "5")
    monkeypatch.setenv("QUEST_RETRY_BASE_MS", "2")
    monkeypatch.setenv("QUEST_RETRY_DEADLINE_MS", "250")
    pol = default_policy(seed=3)
    assert (pol.max_attempts, pol.base_delay_s, pol.deadline_s, pol.seed) == (5, 0.002, 0.25, 3)
    monkeypatch.setenv("QUEST_RETRY_MAX", "many")
    f0 = telemetry.counter_value("analysis_findings_total", code="QT303", severity="warning")
    with pytest.warns(RuntimeWarning, match="QT303"):
        assert default_policy().max_attempts == 3
    assert telemetry.counter_value("analysis_findings_total", code="QT303",
                                   severity="warning") == f0 + 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # once per knob and value
        assert default_policy().max_attempts == 3
    monkeypatch.delenv("QUEST_RETRY_MAX")
    monkeypatch.delenv("QUEST_RETRY_BASE_MS")
    monkeypatch.delenv("QUEST_RETRY_DEADLINE_MS")
    pol = default_policy()
    assert (pol.max_attempts, pol.base_delay_s, pol.deadline_s) == (3, 0.005, None)
