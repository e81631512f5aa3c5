"""The port's compiled execution model (quest_tpu_torch/_capture.py,
segments.py, engine/, Circuit.compiled*) against quest_tpu's and against
its own eager replay.

- the plan side against quest_tpu on the same tapes: identity
  boundaries, segment cuts (None / 1 / 3 / 24 items, with measurement
  seams) and the ``seg`` stamps; lifted slots and ``param_names``;
  which tape pairs share a structure fingerprint;
- ``parameterized(...)(amps, values)`` against quest_tpu's, f32 and f64,
  on one device, on 4 CPU shards and on a density register;
- every compiled route against ``as_fn`` bit for bit, under
  ``_capture.rehearsal()`` (the CPU replays as the card captures: staging
  frozen, host copies and syncs raise);
- the LRU's counters, ``device_dispatch_total`` per route, the
  segment-dispatch knobs and the refusals;
- the capture-parity guard: ``fusion.capture`` of the port and of
  quest_tpu agree on every conformance case and the mix* channels, on
  state-vector and density tapes (an exception in capture is a silent
  barrier, so a divergence would hide);
- two ``cuda`` tests on the card: the graph-replay contract, and the card
  memory of dropped circuits.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

import quest_tpu as jq
from __graft_entry__ import _random_layers
from bench import _density_circuit, serving_ansatz as j_serving_ansatz
from quest_tpu import fusion as JF
from quest_tpu import segments as JS
from quest_tpu.analysis import conformance as CF
from quest_tpu.circuits import Circuit as JCircuit
from quest_tpu.engine import P as JP
from quest_tpu.engine import cache as jcache
from quest_tpu.engine import params as jparams
import quest_tpu_torch as tq
from quest_tpu_torch import _capture, fusion as F, segments as S, telemetry
from quest_tpu_torch.engine import P, cache as tcache, params as tparams
from quest_tpu_torch.engine.cache import LRUCache
from quest_tpu_torch.interop import arg_from_reference, circuit_from_tape
from quest_tpu_torch.ops import fused_gates as FG
from quest_tpu_torch.validation import QuESTError

from .test_torch_fusion import assert_plans_equal

F64_TOL, F32_TOL = 1e-10, 2e-4
TENV = tq.createQuESTEnv(device="cpu")
JENV = jq.createQuESTEnv(jax.devices()[:1])
DTYPES = {"f64": (torch.float64, 2, F64_TOL), "f32": (torch.float32, 1, F32_TOL)}


def _site(qureg):
    """A measurement site: the segment seams fall before and after it."""


_site._measurement_site = True


# ---------------------------------------------------------------------------
# the plan side against quest_tpu
# ---------------------------------------------------------------------------

def _plans(kind):
    """(quest_tpu plan, port plan, nsv) of one tape, both stamped."""
    if kind.startswith("density"):
        n, tb = 5, 8
        jc = _density_circuit(n, True)
        _random_layers(jc, n, depth=2, seed=n)
        tc = circuit_from_tape(jc._tape, n, True)
        jp = JF._plan_pallas(tuple(jc._tape), n, np.float64, 4, tb, is_density=True)
        tp = F._plan_pallas(tuple(tc._tape), n, torch.float64, 4, tb, is_density=True)
        nsv = 2 * n
    else:
        n, tb = (9, 8) if kind == "sv9" else (11, 8)
        jc = JCircuit(n)
        _random_layers(jc, n, depth=4, seed=n)
        tc = circuit_from_tape(jc._tape, n)
        if kind == "sharded":
            jp = JF.plan_pallas_sharded(tuple(jc._tape), n, np.float64, 5, tb, n - 2)
            tp = F.plan_pallas_sharded(tuple(tc._tape), n, torch.float64, 5, tb, n - 2)
        else:
            jp = JF._plan_pallas(tuple(jc._tape), n, np.float64, 5, tb)
            tp = F._plan_pallas(tuple(tc._tape), n, torch.float64, 5, tb)
        nsv = n
    assert JS.stamp_plan(jp, nsv) == S.stamp_plan(tp, nsv)
    return jp, tp, nsv


PLAN_KINDS = ["sv9", "sv11", "sharded", "density"]


@pytest.mark.parametrize("kind", PLAN_KINDS)
def test_seg_stamps_and_boundaries_equal_reference(kind):
    jp, tp, nsv = _plans(kind)
    assert_plans_equal(jp, tp)
    assert any(isinstance(i, F.PallasRun) and i.seg for i in tp.items)
    jt, tt = JF.as_tape(jp), F.as_tape(tp)
    assert S.identity_boundaries(tt, nsv) == JS.identity_boundaries(jt, nsv)
    assert len(S.identity_boundaries(tt, nsv)) > 2


@pytest.mark.parametrize("seams", [False, True], ids=["plain", "seams"])
@pytest.mark.parametrize("cap", [None, 1, 3, 24])
@pytest.mark.parametrize("kind", PLAN_KINDS)
def test_segment_cuts_equal_reference(kind, cap, seams):
    jp, tp, nsv = _plans(kind)
    jt, tt = JF.as_tape(jp), F.as_tape(tp)
    if seams:  # measurement sites at two identity boundaries
        bounds = JS.identity_boundaries(jt, nsv)
        for b in sorted({bounds[1], bounds[len(bounds) // 2]}, reverse=True):
            jt.insert(b, (_site, (), {}))
            tt.insert(b, (_site, (), {}))
    assert S.measurement_seams(tt) == JS.measurement_seams(jt)
    assert S.segment_cuts(tt, nsv, cap) == JS.segment_cuts(jt, nsv, cap)


def test_segment_cuts_reject_zero_items():
    with pytest.raises(ValueError):
        S.segment_cuts([], 4, 0)
    with pytest.raises(ValueError):
        JS.segment_cuts([], 4, 0)


def _param_tapes():
    jc = JCircuit(5)
    jc.hadamard(0)
    jc.rotateZ(0, JP("a"))
    jc.rotateX(1, 0.25)
    jc.controlledPhaseShift(0, 1, JP("p"))
    jc.compactUnitary(2, JP("al"), 0.6j)
    jc.multiRotatePauli([1, 3], [1, 2], JP("m"))
    jc.controlledRotateY(4, 3, JP("a"))
    jc.rotateY(3, angle=0.5)
    jc.controlledNot(2, 4)
    return jc, circuit_from_tape(jc._tape, 5)


def test_lift_tape_slots_and_names_equal_reference():
    jc, tc = _param_tapes()
    js, ts = jc.lifted().slots, tc.lifted().slots
    assert [(s.index, s.kind, s.name, s.default) for s in ts] == \
        [(s.index, s.kind, s.name, s.default) for s in js]
    assert tc.param_names == jc.param_names == ("a", "p", "al", "m")
    assert tparams.lift_slot_census(tc._tape) == jparams.lift_slot_census(jc._tape)


def _fingerprint_variants():
    """quest_tpu tapes that differ in lifted values (they collide) or in
    structure (they miss), and the port's twins; then each package's
    dense-fusion plan of the first two (angles baked into blocks: miss)."""
    def make(angle=0.3, target=1, gate="rotateZ", u_scale=1.0, param=False):
        c = JCircuit(4)
        c.hadamard(0)
        getattr(c, gate)(target, JP("t") if param else angle)
        c.controlledNot(0, 1)
        c.unitary(2, np.array([[0, 1], [1, 0]]) * u_scale)
        return c

    jcs = [make(), make(angle=0.7), make(param=True), make(target=2),
           make(gate="phaseShift"), make(u_scale=-1.0)]
    tcs = [circuit_from_tape(c._tape, 4) for c in jcs]
    jcs += [c.fused(max_qubits=5) for c in jcs[:2]]
    tcs += [c.fused(max_qubits=5) for c in tcs[:2]]
    return jcs, tcs


def test_fingerprints_collide_exactly_as_reference():
    jcs, tcs = _fingerprint_variants()
    jfp = [c.fingerprint() for c in jcs]
    tfp = [c.fingerprint() for c in tcs]
    same_j = [[a == b for b in jfp] for a in jfp]
    same_t = [[a == b for b in tfp] for a in tfp]
    assert same_t == same_j
    assert same_j[0][1] and same_j[0][2] and not same_j[0][3] and not same_j[6][7]
    assert jcache.structure_fingerprint(jcs[0]._tape, 4, False) == jfp[0]
    assert tcache.structure_fingerprint(tcs[0]._tape, 4, False) == tfp[0]


# ---------------------------------------------------------------------------
# parameterized against quest_tpu
# ---------------------------------------------------------------------------

def _values(names, seed):
    rng = np.random.RandomState(seed)
    return {k: float(v) for k, v in zip(names, rng.uniform(0, 2 * np.pi, len(names)))}


def _density_param(n):
    jc = JCircuit(n, is_density_matrix=True)
    for q in range(n):
        jc.hadamard(q)
        jc.rotateY(q, JP(f"y{q}"))
    jc.controlledNot(0, 1)
    jc.mixDephasing(0, 0.1)
    jc.controlledRotateZ(1, 2, JP("z"))
    jc.mixDepolarising(2, 0.05)
    jc.multiRotateZ([0, 2], JP("y0"))
    return jc


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("where", ["one", "shards4", "density"])
def test_parameterized_matches_reference(where, dt):
    tdt, prec, tol = DTYPES[dt]
    if where == "density":
        n = 4
        jc = _density_param(n)
        tc = circuit_from_tape(jc._tape, n, True)
        jq_r = jq.createDensityQureg(n, JENV, prec)
        tq_r = tq.createDensityQureg(n, TENV, prec)
    else:
        n = 8
        jc = j_serving_ansatz(n, 2)
        tc = circuit_from_tape(jc._tape, n)
        assert tc.param_names == jc.param_names == tq.serving_ansatz(n, 2).param_names
        jenv = jq.createQuESTEnv(jax.devices()[:4]) if where == "shards4" else JENV
        tenv = tq.createQuESTEnv(devices=["cpu"] * 4) if where == "shards4" else TENV
        jq_r, tq_r = jq.createQureg(n, jenv, prec), tq.createQureg(n, tenv, prec)
        jq.initPlusState(jq_r)
        tq.initPlusState(tq_r)
    jexe, texe = jc.parameterized(donate=False), tc.parameterized(donate=False)
    state = tq_r.shards if tq_r.shards is not None else tq_r.amps
    for seed in (1, 2):
        vals = _values(jc.param_names, seed)
        want = np.asarray(jexe(jq_r.amps, vals))
        with _capture.rehearsal():
            got = texe(state, vals)
        got = torch.cat(got, dim=1) if isinstance(got, list) else got
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    # the input stays valid without donation
    assert abs(tq.calcTotalProb(tq_r) - 1) < tol


def test_parameterized_equals_concrete_twin_and_shares_cache():
    n = 6
    c = tq.serving_ansatz(n, 2)
    vals = _values(c.param_names, 3)
    twin = tq.serving_ansatz(n, 2, vals)
    amps = tq.createQureg(n, TENV, 2).amps
    telemetry.reset()
    exe = c.parameterized(donate=False)
    for _ in range(3):
        out = exe(amps, vals)
    np.testing.assert_allclose(out.numpy(), twin.as_fn()(amps.clone()).numpy(),
                               rtol=0, atol=1e-12)
    assert telemetry.counter_value("engine_trace_total", kind="param_replay") == 1
    # a structure-equal circuit (other recorded constants) shares the executable
    other = tq.serving_ansatz(n, 2)
    h0 = telemetry.counter_value("plan_cache_hit_total", cache="executable")
    exe2 = other.parameterized(donate=False)
    assert exe2._fn is exe._fn
    assert telemetry.counter_value("plan_cache_hit_total", cache="executable") == h0 + 1
    exe2(amps, _values(c.param_names, 4))
    assert telemetry.counter_value("engine_trace_total", kind="param_replay") == 1


def test_parameterized_fused_plan_matches_reference():
    """A fused plan keeps its Param entries as barriers between kernel runs
    (fusion._entry_has_params), in both packages."""
    n, tb = 9, 8
    jc = j_serving_ansatz(n, 2)
    tc = circuit_from_tape(jc._tape, n)
    jp = JF._plan_pallas(tuple(jc._tape), n, np.float64, 5, tb)
    tp = F._plan_pallas(tuple(tc._tape), n, torch.float64, 5, tb)

    def by_name(p):  # the two packages' Params compare by name
        for i, item in enumerate(p.items):
            if isinstance(item, tuple):
                f, a, kw = item
                p.items[i] = (f, tuple(x.name if type(x).__name__ == "Param" else x
                                       for x in a), kw)
        return p

    assert_plans_equal(by_name(jp), by_name(tp))
    assert tp.num_barriers == 2 * n * 2
    fz = tc.fused(max_qubits=5, pallas=True, dtype=torch.float64, tile_bits=tb)
    vals = _values(jc.param_names, 5)
    want = jc.parameterized(donate=False)(jq.createQureg(n, JENV, 2).amps, vals)
    with _capture.rehearsal():
        exe = fz.parameterized()
        a = tq.createQureg(n, TENV, 2).amps
        for _ in range(2):
            got = exe(a.clone(), vals)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F64_TOL)


def test_missing_param_and_unliftable_param_raise():
    c = tq.Circuit(3)
    c.rotateZ(0, P("a"))
    c.rotateX(1, P("b"))
    exe = c.parameterized(donate=False)
    amps = tq.createQureg(3, TENV, 2).amps
    with pytest.raises(QuESTError, match="missing values for Params \\['b'\\]"):
        exe(amps, {"a": 0.1})
    bad = tq.Circuit(3)
    bad.hadamard(P("q"))
    with pytest.raises(QuESTError, match="not supported at argument 0"):
        bad.parameterized()
    bad2 = tq.Circuit(3, is_density_matrix=True)
    bad2.mixDephasing(0, P("p"))
    with pytest.raises(QuESTError, match="not supported"):
        bad2.lifted()


# ---------------------------------------------------------------------------
# the compiled routes against the eager replay, bit for bit
# ---------------------------------------------------------------------------

def _fused(kind, tdt):
    if kind == "density":
        n = 5
        c = tq.density_circuit(n, True)
        tq.random_layers(c, n, 2, seed=n)
        return c.fused(max_qubits=4, pallas=True, dtype=tdt, tile_bits=8), n
    n = 9
    c = tq.Circuit(n)
    tq.random_layers(c, n, 4, seed=n)
    return c.fused(max_qubits=5, pallas=True, dtype=tdt, tile_bits=8), n


ROUTES = {
    "compiled": lambda c: c.compiled(),
    "compiled_keep": lambda c: c.compiled(donate=False),
    "blocks": lambda c: c.compiled_blocks(2),
    "segments_1": lambda c: c.compiled_segments(1),
    "segments_24": lambda c: c.compiled_segments(24),
    "segments_all": lambda c: c.compiled_segments(None),
    "request": lambda c: c.compiled_request(),
}


def _start(n, density, prec, seed):
    q = (tq.createDensityQureg if density else tq.createQureg)(n, TENV, prec)
    rng = np.random.RandomState(seed)
    v = rng.normal(size=(2, q.num_amps_total))
    q.amps.copy_(torch.as_tensor(v / np.linalg.norm(v)))
    return q


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("kind", ["sv", "density"])
@pytest.mark.parametrize("route", list(ROUTES) + ["run"])
def test_compiled_route_equals_eager_replay(route, kind, dt):
    tdt, prec, _ = DTYPES[dt]
    fz, n = _fused(kind, tdt)
    assert len(fz) > 2
    x = _start(n, kind == "density", prec, 11).amps
    eager = fz.as_fn()
    ref1 = eager(x.clone())
    ref2 = eager(ref1.clone())
    with _capture.rehearsal():
        if route == "run":
            q = _start(n, kind == "density", prec, 11)
            fz.run(q)
            assert torch.equal(q.amps, ref1)
            fz.run(q)
            assert torch.equal(q.amps, ref2)
            return
        fn = ROUTES[route](fz)
        keep = x.clone()
        a = fn(x.clone())
        assert torch.equal(a, ref1)
        a = fn(a)
        assert torch.equal(a, ref2)
        if route == "compiled_keep":  # input untouched, earlier results valid
            b = fn(keep)
            assert torch.equal(keep, x) and torch.equal(b, ref1)
            fn(b)
            assert torch.equal(b, ref1)


@pytest.mark.parametrize("route", ["compiled", "compiled_keep", "segments_1", "request",
                                   "run"])
def test_compiled_route_over_shards_equals_eager_replay(route):
    n, d = 12, 4
    c = tq.Circuit(n)
    tq.random_layers(c, n, 3, seed=1)
    fz = c.fused(max_qubits=5, pallas=True, dtype=torch.float64, tile_bits=8,
                 shard_devices=d)
    env = tq.createQuESTEnv(devices=["cpu"] * d)
    q = tq.createQureg(n, env, 2)
    tq.initDebugState(q)
    shards = [s.clone() for s in q.shards]
    ref = fz.as_fn()([s.clone() for s in shards])
    telemetry.reset()
    with _capture.rehearsal():
        if route == "run":
            fz.run(q)
            got = q.shards
        else:
            got = ROUTES[route](fz)([s.clone() for s in shards])
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert telemetry.counter_value("exchange_calls_total", kind="grouped_permute") > 0


def test_host_bound_entry_runs_as_item_between_pieces():
    c = tq.Circuit(4)
    c.hadamard(0)
    c.append(tq.collapseToOutcome, 0, 0)
    c.rotateX(1, 0.3)
    assert S.measurement_seams(c._tape) == {1, 2}
    assert S.segment_cuts(c._tape, 4) == [0, 1, 2, 3]
    q = tq.createQureg(4, TENV, 2)
    telemetry.reset()
    c.run(q)
    assert telemetry.counter_value("device_dispatch_total", route="item") == 1
    assert telemetry.counter_value("device_dispatch_total", route="circuit") == 1
    ref = tq.createQureg(4, TENV, 2)
    for f, a, kw in c._tape:
        f(ref, *a, **kw)
    assert torch.equal(q.amps, ref.amps)
    with pytest.raises(QuESTError, match="cannot be captured"):
        c.compiled_request()
    with pytest.raises(QuESTError, match="cannot be captured"):
        c.parameterized()


def test_rehearsal_catches_a_host_sync():
    def peek(qureg):
        qureg.amps[0, 0].item()

    c = tq.Circuit(3)
    c.append(tq.hadamard, 0)
    fn = c.compiled(donate=False)
    body = c._replay_body(None)

    def bad_body(shell):
        body(shell)
        peek(shell)

    fn.program.pieces[0].body = bad_body
    amps = tq.createQureg(3, TENV, 2).amps
    with _capture.rehearsal():
        fn(amps)  # the eager run is free to sync
        with pytest.raises(_capture.CaptureError, match=r"\.item\(\)"):
            fn(amps)


# ---------------------------------------------------------------------------
# the executable cache
# ---------------------------------------------------------------------------

def test_lru_scripted_hit_miss_evict_counters():
    cache = LRUCache(capacity=2, name="testlru")
    closed = []

    class Exe:
        def __init__(self, v):
            self.v = v

        def close(self):
            closed.append(self.v)

    def c(name):
        return telemetry.counter_value(f"plan_cache_{name}_total", cache="testlru")

    h0, m0, e0 = c("hit"), c("miss"), c("evict")
    assert cache.get("a") is None                                 # miss
    cache.put("a", Exe(1))
    assert cache.get("a").v == 1                                  # hit
    assert cache.get_or_create("b", lambda: Exe(2)).v == 2        # miss (create)
    assert cache.get_or_create("b", lambda: Exe(99)).v == 2       # hit
    cache.put("c", Exe(3))                                        # evicts "a"
    assert closed == [1]                                          # ... and closes it
    assert cache.get("a") is None                                 # miss
    assert cache.get("b").v == 2 and cache.get("c").v == 3        # 2 hits
    assert (c("hit") - h0, c("miss") - m0, c("evict") - e0) == (4, 3, 1)
    assert set(cache.keys()) == {"b", "c"}
    assert cache.peek("b").v == 2 and c("hit") - h0 == 4          # peek counts nothing
    assert telemetry.gauge_value("plan_cache_size", cache="testlru") == 2
    cache.clear()
    assert len(cache) == 0 and sorted(closed) == [1, 2, 3]


def test_circuit_compiled_routes_through_global_lru(monkeypatch):
    small = LRUCache(capacity=2, name="executable")
    monkeypatch.setattr(tcache, "_EXECUTABLES", small)
    c = tq.Circuit(3)
    c.hadamard(0)
    c.controlledNot(0, 1)
    m0 = telemetry.counter_value("plan_cache_miss_total", cache="executable")
    f1 = c.compiled()
    assert c.compiled() is f1
    c.tGate(2)  # an append invalidates the token
    f2 = c.compiled()
    assert f2 is not f1
    c.compiled_blocks(1)  # third key: evicts the oldest
    assert telemetry.counter_value("plan_cache_miss_total", cache="executable") - m0 == 3
    assert len(small) == 2


def test_a_revisions_executables_leave_the_cache_with_it(monkeypatch):
    """An append, or the Circuit's collection, closes and drops the
    executables keyed on its tape revision (no eviction counted); a
    structure-keyed parameterized executable stays; a closed executable
    warms again at its next call."""
    cache = LRUCache(capacity=8, name="executable")
    monkeypatch.setattr(tcache, "_EXECUTABLES", cache)
    c = tq.Circuit(3)
    c.hadamard(0)
    fn = c.compiled()
    c.compiled_blocks(1)
    c.compiled_segments(2)
    c.compiled_request()
    c.parameterized()
    e0 = telemetry.counter_value("plan_cache_evict_total", cache="executable")
    assert len(cache) == 5
    c.controlledNot(0, 1)
    assert len(cache) == 1 and next(iter(cache.keys()))[0] == "param"
    c.compiled()
    assert len(cache) == 2
    del c
    assert len(cache) == 1
    assert telemetry.counter_value("plan_cache_evict_total", cache="executable") == e0
    h = tq.Circuit(3)
    h.hadamard(0)
    x = _start(3, False, 2, 1).amps
    assert torch.equal(fn(x.clone()), h.as_fn()(x.clone()))


# ---------------------------------------------------------------------------
# dispatch accounting and the knobs
# ---------------------------------------------------------------------------

def _multi_item():
    fz, _ = _fused("sv", torch.float64)
    return fz


def test_run_slice_single_dispatch_per_segment():
    c = _multi_item()
    q = tq.createQureg(9, TENV, 2)
    telemetry.reset()
    with S.force_route("segment"):
        S.run_slice(c, q)
    assert telemetry.counter_value("device_dispatch_total", route="segment") == 1.0
    assert telemetry.counter_value("device_dispatch_total", route="item") == 0.0


def test_item_route_counts_every_entry():
    c = _multi_item()
    q = tq.createQureg(9, TENV, 2)
    ref = tq.createQureg(9, TENV, 2)
    telemetry.reset()
    with S.force_route("item"):
        S.run_slice(c, q)
    assert telemetry.counter_value("device_dispatch_total", route="item") == len(c._tape)
    assert telemetry.counter_value("device_dispatch_total", route="segment") == 0.0
    with S.force_route("segment"):
        S.run_slice(c, ref)
    assert torch.equal(q.amps, ref.amps)


def test_chain_counts_num_segments():
    c = _multi_item()
    fn = c.compiled_segments(max_items=2)
    assert c.compiled_segments().num_segments == 1
    assert fn.num_segments >= 2
    q = tq.createQureg(9, TENV, 2)
    telemetry.reset()
    q.put(fn(q.amps))
    assert telemetry.counter_value("device_dispatch_total", route="segment") == fn.num_segments


def test_circuit_request_and_block_routes_count():
    c = _multi_item()
    q = tq.createQureg(9, TENV, 2)
    telemetry.reset()
    c.run(q)
    assert telemetry.counter_value("device_dispatch_total", route="circuit") == 1.0
    req = c.compiled_request()
    assert req.num_dispatches == 1 and req.num_segments == len(
        S.identity_boundaries(c._tape, 9)) - 1
    blocks = c.compiled_blocks(2)
    telemetry.reset()
    q.put(req(q.amps))
    q.put(blocks(q.amps))
    assert telemetry.counter_value("device_dispatch_total", route="request") == 1.0
    assert telemetry.counter_value("device_dispatch_total", route="block") == \
        blocks.num_blocks == len(c.blocks(2))


def test_request_reduce_returns_the_readout():
    c = _multi_item()
    x = tq.createQureg(9, TENV, 2).amps

    def probs(amps):
        return (amps[0] ** 2 + amps[1] ** 2)

    ref = c.as_fn()(x.clone())
    got = c.compiled_request(donate=False, reduce=probs)(x)
    assert torch.equal(got, ref[0] ** 2 + ref[1] ** 2)
    assert torch.equal(x, tq.createQureg(9, TENV, 2).amps)


def test_wants_values_reduce_refused():
    def grad_reduce(amps, values):
        return amps

    grad_reduce.wants_values = True
    with pytest.raises(QuESTError, match="wants_values"):
        _multi_item().compiled_request(reduce=grad_reduce)


def test_segment_dispatch_env_knob(monkeypatch):
    monkeypatch.setattr(S, "_SEG_ENV_WARNED", set())
    monkeypatch.setenv("QUEST_SEGMENT_DISPATCH", "0")
    assert S.segment_dispatch_default() == 0 and not S.segment_dispatch_enabled()
    with S.force_route("segment"):
        assert S.segment_dispatch_enabled()
    c = _multi_item()
    q = tq.createQureg(9, TENV, 2)
    telemetry.reset()
    S.run_slice(c, q)
    assert telemetry.counter_value("device_dispatch_total", route="item") == len(c._tape)
    monkeypatch.setenv("QUEST_SEGMENT_DISPATCH", "bogus")
    with pytest.warns(RuntimeWarning, match="QUEST_SEGMENT_DISPATCH"):
        assert S.segment_dispatch_default() == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert S.segment_dispatch_default() == 1  # warned once
    with pytest.raises(ValueError):
        with S.force_route("bogus"):
            pass


# ---------------------------------------------------------------------------
# the capture-parity guard
# ---------------------------------------------------------------------------

K = 1 / np.sqrt(2)
MIX = [
    ("mixDephasing", (1, 0.1)),
    ("mixTwoQubitDephasing", (0, 2, 0.2)),
    ("mixDepolarising", (3, 0.05)),
    ("mixDamping", (2, 0.3)),
    ("mixKrausMap", (1, [np.eye(2) * K, np.array([[0, K], [K, 0]])])),
    ("mixMultiQubitKrausMap", ([0, 2, 4], [np.eye(8)])),
]
GUARD_N = 6
GUARD_CASES = [(c.name, c.args, c.id) for c in CF.conformance_cases(GUARD_N)] + \
    [(name, args, name) for name, args in MIX]


def _events_equal(tev, jev):
    assert (tev is None) == (jev is None)
    if tev is None:
        return
    assert [(e.kind, tuple(e.targets), tuple(e.controls), tuple(e.states), e.extended)
            for e in tev] == [(e.kind, tuple(e.targets), tuple(e.controls),
                               tuple(e.states), e.extended) for e in jev]
    for t, j in zip(tev, jev):
        for field in ("matrix", "diag", "superop"):
            a, b = getattr(t, field), getattr(j, field)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
        assert t.theta == pytest.approx(j.theta, abs=1e-12)


@pytest.mark.parametrize("density", [False, True], ids=["sv", "density"])
@pytest.mark.parametrize("case", GUARD_CASES, ids=lambda c: c[2])
def test_capture_parity_guard(case, density):
    name, args, _ = case
    jfn, tfn = getattr(jq, name), getattr(tq, name)
    jev = JF.capture(jfn, tuple(args), {}, GUARD_N, np.float64, is_density=density)
    tev = F.capture(tfn, arg_from_reference(tuple(args)), {}, GUARD_N, torch.float64,
                    is_density=density)
    if name.startswith("mix"):  # a channel needs a density register
        assert (jev is None) == (not density)
    _events_equal(tev, jev)


# ---------------------------------------------------------------------------
# capture safety of the tapeable surface (rehearsed on the CPU)
# ---------------------------------------------------------------------------

def test_surface_entries_are_capture_safe():
    """Every entry of the gate-surface tape, and the QFT/Trotter/phase
    function operators, replays under the rehearsal: nothing it runs copies
    host data or syncs once its eager run has staged its constants."""
    from chip_smoke import gate_surface_tape
    from quest_tpu_torch.circuits import _capture_safe
    n = 7
    c = tq.Circuit(n)
    gate_surface_tape(c, tq, n, seed=2)
    h = tq.createPauliHamil(n, 2)
    tq.initPauliHamil(h, [0.3, -0.2], [[3, 3] + [0] * (n - 2), [1] * n])
    c.applyTrotterCircuit(h, 0.3, 2, 1)
    c.applyFullQFT()
    c.applyPhaseFunc([0, 1, 2], 0, [0.5, -0.1], [1.0, 2.0])
    c.applyNamedPhaseFunc([0, 1, 2, 3], [2, 2], 0, tq.phaseFunc.DISTANCE)
    assert all(_capture_safe(f) for f, _, _ in c._tape)
    x = _start(n, False, 2, 4).amps
    ref = c.as_fn()(x.clone())
    with _capture.rehearsal():
        fn = c.compiled(donate=False)
        fn(x)
        got = fn(x)
    assert torch.equal(got, ref)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_graph_replay_contract_on_card():
    """A small fused circuit on the card: the first call is eager and
    captures nothing; the second and third capture the two buffer orders
    of donate=True; a replay then launches a graph of the plan's kernels,
    which the card's trace shows running (``chip_smoke``'s counters), adds
    nothing to the wrapper's launch count and the capture's passes to the
    telemetry, and ping-pongs two buffers with no allocation; donate=False
    leaves the input and earlier results valid."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = 14
    c = tq.Circuit(n)
    tq.random_layers(c, n, 4, seed=3)
    fz = c.fused(max_qubits=5, pallas=True, dtype=torch.float32, tile_bits=8)
    x = torch.zeros(2, 1 << n, device="cuda")
    x[0, 0] = 1
    refs = [x]
    for _ in range(5):
        refs.append(fz.as_fn()(refs[-1].clone()))
    runs = sum(f is F._apply_pallas_run for f, _, _ in fz._tape)
    fn = fz.compiled()
    FG.fused_run.launches = 0
    a = fn(x.clone())
    assert torch.equal(a, refs[1])
    assert FG.fused_run.launches == runs and fn.captures == []
    a = fn(fn(a))
    assert torch.equal(a, refs[3]) and 1 <= len(fn.captures) <= 2
    caps = len(fn.captures)
    FG.fused_run.launches = 0
    telemetry.reset()
    from chip_smoke import _card_runs, _graph_kernels
    traced, a = _card_runs(lambda: fn(a))
    assert _graph_kernels(fn) == runs and 0 < traced["fused_run"] <= runs
    assert torch.equal(a, refs[4])
    assert FG.fused_run.launches == 0
    assert telemetry.counter_value("pallas_pass_total", kind="fused_run") == runs
    ptrs = {a.data_ptr()}
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    a = fn(a)  # nothing but the replay between the two readings
    made = torch.cuda.memory_stats()["allocation.all.allocated"] - allocs
    ptrs.add(a.data_ptr())
    assert torch.equal(a, refs[5])
    assert made == 0
    assert len(fn.captures) == caps and len(ptrs) <= 2
    keep = fz.compiled(donate=False)
    b1 = keep(x)
    b2 = keep(b1)
    b3 = keep(b2)
    assert torch.equal(b1, refs[1]) and torch.equal(b2, refs[2]) and torch.equal(b3, refs[3])
    assert x[0, 0] == 1 and len(keep.captures) == 1


@pytest.mark.cuda
def test_dropped_circuits_hold_no_card_memory():
    """Distinct circuits with per-gate engine entries, each run through
    Circuit.run and dropped: a run made once captures nothing, a dropped
    circuit's executable leaves the cache (its graphs and pool freed), and
    the card's reserved memory stays within one state over them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = 16
    env = tq.createQuESTEnv(device="cuda")
    q = tq.createQureg(n, env, 1)
    tcache.executables().clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = []
    for i in range(10):
        c = tq.Circuit(n)
        tq.random_layers(c, n, 2, seed=100 + i)
        tq.initZeroState(q)
        c.run(q)
        assert c.compiled().captures == []
        c.run(q)
        c.run(q)
        assert c.compiled().captures and len(tcache.executables()) == 1
        del c
        assert len(tcache.executables()) == 0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved.append(torch.cuda.memory_reserved())
    assert max(reserved) - reserved[0] <= q.amps.numel() * q.amps.element_size()
