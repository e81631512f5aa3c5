"""The port's adjoint gradients (quest_tpu_torch/gradients) against
quest_tpu's ``gradient_executable``, the port's parameter shifts and
``torch.autograd``.

- ``Circuit.gradient`` for every derivative family (rotations, controlled
  rotations, phases, parity words, compact unitaries) on 6 qubits in f64,
  a shared-slot chain rule, a deep mixed 12-qubit tape and f32: value and
  every slot's gradient against ``quest_tpu.gradient_executable`` on the
  same state and values (1e-10 f64, 2e-4 f32);
- the raw tape against its plan by ``fused(max_qubits=3)``: the value bit
  for bit, the gradients within 1e-12;
- the second oracles: the port's ``parameter_shift`` (two- and four-term
  rules) and, in f64, ``torch.autograd`` through the port's raw per-gate
  replay for the rotation families, within 1e-10;
- refusals, each a typed ``QuESTError`` naming its site: a trajectory site
  and a measurement site anywhere on the tape, a density circuit, a
  density register in ``calcGradExpecPauliSum``, a slot-free tape, a
  fused-run plan entry, a ``wants_values`` reduce in ``request_executable``,
  a complex slot in ``parameter_shift``;
- the gradient Engine: ``submit_grad`` needs ``hamiltonian=``; a warm loop
  builds nothing (``engine_trace_total`` flat) and dispatches one
  ``route=grad_request`` program a batch; lanes equal ``run``-path
  requests bit for bit and the unbatched ``Circuit.gradient`` within
  tolerance, raw and fused, at ``max_batch`` 4 and 1;
- ``calcGradExpecPauliSum`` against quest_tpu's; the gradient program's body
  capturable (``_capture.rehearsal``).

Every ``result()`` has a timeout, so a hang fails one test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import quest_tpu as jq
from quest_tpu.circuits import Circuit as JCircuit
from quest_tpu.engine import P as JP
from quest_tpu.gradients import gradient_executable as j_gradient_executable
import quest_tpu_torch as tq
from quest_tpu_torch import _capture, telemetry
from quest_tpu_torch.circuits import Circuit
from quest_tpu_torch.engine import Engine, P
from quest_tpu_torch.gradients import (check_differentiable, grad_reduce,
                                       gradient_executable, parameter_shift)
from quest_tpu_torch.interop import circuit_from_tape
from quest_tpu_torch.segments import request_executable
from quest_tpu_torch.validation import QuESTError

TENV = tq.createQuESTEnv(device="cpu")
JENV = jq.createQuESTEnv(jax.devices()[:1])
F64_TOL, F32_TOL = 1e-10, 2e-4
WAIT = 60  # seconds any result() may take

#: a compact-unitary point: a generic (alpha, beta) on the unit sphere
_TH = 0.83
_AL = np.cos(_TH / 2) * np.exp(0.31j)
_BE = np.sin(_TH / 2) * np.exp(-0.74j)


def _ham(n, terms=4, seed=1):
    r = np.random.RandomState(seed)
    return r.randint(0, 4, size=(terms, n)).astype(np.int32), r.normal(size=terms)


def _state(n, seed=0) -> np.ndarray:
    """A generic normalised random state, planar (2, 2^n) float64."""
    r = np.random.RandomState(seed)
    v = r.normal(size=(1 << n,)) + 1j * r.normal(size=(1 << n,))
    v /= np.linalg.norm(v)
    return np.stack([v.real, v.imag])


def _prefix(c):
    """A generic single-qubit prefix (no vanishing gradient)."""
    for q in range(c.num_qubits):
        c.rotateY(q, 0.3 + 0.17 * q)


def _params(circ, params=None):
    params = dict(params or {})
    for i, name in enumerate(circ.param_names):
        params.setdefault(name, 0.37 + 0.41 * i)
    return params


def _pair(build, n):
    """The same tape in both packages: ``build(circuit, P, Vector)``."""
    tc, jc = Circuit(n), JCircuit(n)
    build(tc, P, tq.Vector)
    build(jc, JP, jq.Vector)
    return tc, jc


def _check_against_quest_tpu(tc, jc, params=None, dtype=torch.float64, seed=0,
                             ham=None):
    """Value and every slot gradient of the port against quest_tpu's
    gradient_executable on the same state and values; returns the port's
    output."""
    tol = F64_TOL if dtype == torch.float64 else F32_TOL
    codes, coeffs = ham if ham is not None else _ham(tc.num_qubits)
    params = _params(tc, params)
    st = _state(tc.num_qubits, seed)
    got = tc.gradient((codes, coeffs), donate=False, dtype=dtype)(
        torch.tensor(st, dtype=dtype), params)
    jdt = np.float64 if dtype == torch.float64 else np.float32
    want = j_gradient_executable(jc, (codes, coeffs), donate=False, dtype=jdt)(
        jnp.asarray(st, dtype=jdt), params)
    assert abs(float(got["value"]) - float(want["value"])) <= tol
    assert len(got["slot_grads"]) == len(want["slot_grads"])
    for g, w in zip(got["slot_grads"], want["slot_grads"]):
        assert abs(complex(g) - complex(np.asarray(w))) <= tol
    assert set(got["grads"]) == set(want["grads"])
    for k in got["grads"]:
        assert abs(float(got["grads"][k]) - float(want["grads"][k])) <= tol
    return got


# ---------------------------------------------------------------------------
# against quest_tpu: the family matrix (6 qubits, f64)
# ---------------------------------------------------------------------------

_FAMILIES = {
    "rotateX": lambda c, P, V: c.rotateX(0, P("a")),
    "rotateY_const": lambda c, P, V: c.rotateY(1, 0.37),
    "rotateZ": lambda c, P, V: c.rotateZ(2, P("a")),
    "phaseShift": lambda c, P, V: c.phaseShift(0, P("a")),
    "controlledPhaseShift": lambda c, P, V: c.controlledPhaseShift(0, 1, P("a")),
    "multiControlledPhaseShift": lambda c, P, V: c.multiControlledPhaseShift([0, 1, 2], P("a")),
    "controlledRotateX": lambda c, P, V: c.controlledRotateX(0, 1, P("a")),
    "controlledRotateY": lambda c, P, V: c.controlledRotateY(0, 2, P("a")),
    "controlledRotateZ": lambda c, P, V: c.controlledRotateZ(0, 1, P("a")),
    "rotateAroundAxis": lambda c, P, V: c.rotateAroundAxis(1, P("a"), V(0.3, -1.2, 0.5)),
    "controlledRotateAroundAxis":
        lambda c, P, V: c.controlledRotateAroundAxis(0, 1, P("a"), V(0.3, -1.2, 0.5)),
    "multiRotateZ": lambda c, P, V: c.multiRotateZ([0, 2], P("a")),
    "multiControlledMultiRotateZ":
        lambda c, P, V: c.multiControlledMultiRotateZ([0], [1, 2], P("a")),
    "multiRotatePauli": lambda c, P, V: c.multiRotatePauli([0, 1], [1, 2], P("a")),
    "multiRotatePauli_identity": lambda c, P, V: c.multiRotatePauli([0, 1], [0, 0], P("a")),
    "multiControlledMultiRotatePauli":
        lambda c, P, V: c.multiControlledMultiRotatePauli([0], [1, 2], [3, 1], P("a")),
    "compactUnitary": lambda c, P, V: c.compactUnitary(1, _AL, _BE),
    "controlledCompactUnitary": lambda c, P, V: c.controlledCompactUnitary(0, 1, _AL, _BE),
}


def _family(name):
    def build(c, P, V):
        _prefix(c)
        _FAMILIES[name](c, P, V)
        c.controlledNot(0, 3)
        c.rotateX(4, P("tail"))
    return build


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_adjoint_matches_quest_tpu_family(family):
    tc, jc = _pair(_family(family), 6)
    _check_against_quest_tpu(tc, jc)


def _chain(c, P, V):
    c.hadamard(0)
    c.rotateX(0, P("a"))
    c.controlledNot(0, 1)
    c.rotateZ(1, P("a"))
    c.tGate(2)
    c.rotateY(2, P("b"))
    c.swapGate(0, 2)
    c.sGate(1)


def test_adjoint_shared_slot_chain_rule():
    """One named Param feeding several gates: the slot gradients sum into
    the name (the chain rule), concrete gates between and after them
    crossed by the backward sweep."""
    tc, jc = _pair(_chain, 6)
    out = _check_against_quest_tpu(tc, jc, params={"a": 0.4, "b": -1.1})
    by_name: dict = {}
    for s, g in zip(tc.lifted().slots, out["slot_grads"]):
        if s.name is not None:
            by_name[s.name] = by_name.get(s.name, 0.0) + float(g)
    assert abs(float(out["grads"]["a"]) - by_name["a"]) <= 1e-14


def _deep(c, P, V):
    _prefix(c)
    c.rotateX(0, P("t0"))
    c.controlledRotateY(0, 5, P("t1"))
    c.multiRotateZ([1, 7], P("t2"))
    c.phaseShift(11, P("t3"))
    c.controlledNot(1, 2)
    c.compactUnitary(9, _AL, _BE)
    c.multiControlledMultiRotatePauli([0], [4, 11], [2, 3], P("t4"))
    c.controlledPhaseShift(2, 3, P("t5"))
    c.rotateAroundAxis(6, P("t6"), V(0.3, -1.2, 0.5))


def test_adjoint_deep_mixed_12q():
    tc, jc = _pair(_deep, 12)
    _check_against_quest_tpu(tc, jc, params={f"t{i}": 0.1 * (i + 1) * (-1) ** i
                                             for i in range(7)})


def _f32(c, P, V):
    _prefix(c)
    c.rotateX(0, P("a"))
    c.controlledRotateZ(0, 3, P("b"))
    c.multiRotatePauli([1, 4], [1, 3], P("c"))


def test_adjoint_f32():
    tc, jc = _pair(_f32, 6)
    out = _check_against_quest_tpu(tc, jc, dtype=torch.float32)
    assert out["value"].dtype == torch.float32


def _mixed(c, P, V):
    _prefix(c)
    c.rotateX(0, P("a"))
    c.controlledNot(0, 1)
    c.controlledRotateY(1, 2, P("b"))
    c.multiRotateZ([2, 3], P("a"))
    c.compactUnitary(4, np.cos(0.4) * np.exp(0.2j), np.sin(0.4) * np.exp(-0.5j))
    c.controlledPhaseShift(4, 5, P("c"))
    c.swapGate(0, 5)
    c.rotateZ(5, P("b"))
    c.hadamard(3)


_MIXED_HAM = (np.array([[3, 3, 0, 0, 0, 0], [1, 0, 2, 0, 0, 1],
                        [0, 0, 0, 3, 1, 0], [3, 0, 0, 0, 0, 3]], np.int32),
              [0.7, -0.4, 1.1, 0.25])
_MIXED_PARAMS = {"a": 0.31, "b": -0.9, "c": 1.7}


def _zero_amps(n, dtype=torch.float64):
    v = torch.zeros(2, 1 << n, dtype=dtype)
    v[0, 0] = 1.0
    return v


def test_adjoint_fused_circuit():
    """The gradient rides a plan of fused(max_qubits=3): its dense blocks
    are daggered through fusion.event_dagger, the value is the raw
    program's bit for bit and the gradients within 1e-12 (and both match
    quest_tpu's fused gradient)."""
    tc, jc = _pair(_mixed, 6)
    raw = tc.gradient(_MIXED_HAM, donate=False)(_zero_amps(6), _MIXED_PARAMS)
    fz = tc.fused(max_qubits=3)
    assert any(f.__name__ == "_apply_dense_block" for f, _, _ in fz._tape)
    out = fz.gradient(_MIXED_HAM, donate=False)(_zero_amps(6), _MIXED_PARAMS)
    assert float(out["value"]) == float(raw["value"])
    for k in raw["grads"]:
        assert abs(float(out["grads"][k]) - float(raw["grads"][k])) <= 1e-12
    want = jc.fused(max_qubits=3).gradient(_MIXED_HAM, donate=False)(
        jnp.asarray(_zero_amps(6).numpy()), _MIXED_PARAMS)
    assert abs(float(out["value"]) - float(want["value"])) <= F64_TOL
    for k in raw["grads"]:
        assert abs(float(out["grads"][k]) - float(want["grads"][k])) <= F64_TOL


def test_gradient_of_a_carried_tape_and_capture():
    """A quest_tpu tape carried across (``interop.circuit_from_tape``)
    differentiates like the port's own, and the gradient program's body
    runs as the card captures it (the staging frozen, the host guard on)."""
    _, jc = _pair(_mixed, 6)
    tc = circuit_from_tape(jc._tape, 6)
    gx = tc.gradient(_MIXED_HAM, donate=False)
    first = gx(_zero_amps(6), _MIXED_PARAMS)
    with _capture.rehearsal():
        again = gx(_zero_amps(6), _MIXED_PARAMS)
    assert float(again["value"]) == float(first["value"])
    for k in first["grads"]:
        assert float(again["grads"][k]) == float(first["grads"][k])
    want = j_gradient_executable(jc, _MIXED_HAM, donate=False)(
        jnp.asarray(_zero_amps(6).numpy()), _MIXED_PARAMS)
    assert abs(float(first["value"]) - float(want["value"])) <= F64_TOL


def test_gradient_counts_one_grad_request_dispatch():
    tc, _ = _pair(_mixed, 6)
    gx = tc.gradient(_MIXED_HAM, donate=False)
    before = telemetry.counter_value("device_dispatch_total", route="grad_request")
    slots = telemetry.counter_value("grad_slots_total")
    gx(_zero_amps(6), _MIXED_PARAMS)
    assert telemetry.counter_value("device_dispatch_total", route="grad_request") == before + 1
    assert telemetry.counter_value("grad_slots_total") == slots + gx.num_slots
    assert gx.num_slots == len(tc.lifted().slots) and gx.param_names == ("a", "b", "c")


# ---------------------------------------------------------------------------
# the other oracles: parameter shifts and torch.autograd
# ---------------------------------------------------------------------------

def test_parameter_shift_agrees_with_adjoint():
    """Two-term (rotation, phase) and four-term (controlled rotation) rules
    against the adjoint sweep, shared slots included."""
    c = Circuit(6)
    _prefix(c)
    c.rotateX(0, P("a"))
    c.controlledRotateY(0, 1, P("b"))
    c.multiRotateZ([2, 4], P("a"))
    c.phaseShift(5, P("c"))
    c.multiControlledMultiRotateZ([0], [3, 5], P("b"))
    ham = _ham(6)
    params = {"a": 0.4, "b": -1.1, "c": 0.9}
    amps = torch.tensor(_state(6))
    out = c.gradient(ham, donate=False)(amps, params)
    ps = parameter_shift(c, ham, amps, params)
    assert abs(float(out["value"]) - ps["value"]) <= 1e-12
    for k in out["grads"]:
        assert abs(float(out["grads"][k]) - ps["grads"][k]) <= 1e-10
    assert torch.equal(amps, torch.tensor(_state(6)))  # read, never written


def test_parameter_shift_rejects_complex_slots():
    c = Circuit(3)
    c.hadamard(0)
    c.compactUnitary(1, _AL, _BE)
    with pytest.raises(QuESTError, match="no shift rule"):
        parameter_shift(c, _ham(3), torch.tensor(_state(3)))


_ROTATIONS = ("rotateX", "rotateZ", "controlledRotateX", "controlledRotateY",
              "controlledRotateZ", "rotateAroundAxis", "controlledRotateAroundAxis",
              "multiRotateZ", "multiControlledMultiRotateZ", "multiRotatePauli",
              "multiControlledMultiRotatePauli", "phaseShift", "controlledPhaseShift",
              "multiControlledPhaseShift")


@pytest.mark.parametrize("family", _ROTATIONS)
def test_adjoint_matches_torch_autograd(family):
    """In f64, torch.autograd through the port's raw per-gate replay (the
    lifted values as leaf tensors) gives the same value and gradients
    within 1e-10: the oracle the JAX package takes from jax.grad."""
    from quest_tpu_torch.calculations import expec_pauli_sum_amps
    from quest_tpu_torch.engine.params import bind

    c = Circuit(6)
    _family(family)(c, P, tq.Vector)
    codes, coeffs = _ham(6)
    params = _params(c)
    st = torch.tensor(_state(6, seed=4))
    out = c.gradient((codes, coeffs), donate=False)(st, params)
    lifted = c.lifted()
    values = bind(lifted, params)
    leaf = values.tensors["real"].clone().requires_grad_(True)
    values.tensors["real"] = leaf
    psi = c._replay_fn(lifted)(st.clone(), values)
    e = expec_pauli_sum_amps(psi, tuple(float(x) for x in coeffs),
                             codes=[tuple(int(x) for x in row) for row in codes], n=6,
                             density=False)
    (grad,) = torch.autograd.grad(e, leaf)
    assert abs(float(out["value"]) - float(e.detach())) <= F64_TOL
    real = [i for i, s in enumerate(lifted.slots) if s.kind == "real"]
    for pos, i in enumerate(real):
        assert abs(float(out["slot_grads"][i]) - float(grad[pos])) <= F64_TOL


# ---------------------------------------------------------------------------
# refusals: typed errors naming the site
# ---------------------------------------------------------------------------

def applyTrajectoryKraus(qureg, target, ops, seed=0):
    """A stand-in of the JAX package's trajectory-noise entry (its seed is a
    liftable 'seed' slot), which the port's trajectories slice has not
    brought yet."""


def test_gradient_rejects_trajectory_site():
    c = Circuit(3)
    c.hadamard(0)
    c.rotateX(0, P("a"))
    c.append(applyTrajectoryKraus, 0, [np.eye(2)], 7)
    with pytest.raises(QuESTError, match=r"tape\[2\]:applyTrajectoryKraus.*trajectory"):
        check_differentiable(c)


def test_gradient_rejects_measurement_site():
    c = Circuit(3)
    c.hadamard(0)
    c.rotateX(0, P("a"))
    c.applyMidMeasurement(0, 5, site=0)
    with pytest.raises(QuESTError, match=r"tape\[2\]:applyMidMeasurement.*sample_request"):
        check_differentiable(c)
    d = Circuit(3)
    d.rotateX(0, P("a"))
    d.applyMidCollapse(1, 0)
    with pytest.raises(QuESTError, match=r"tape\[1\]:applyMidCollapse.*sample_request"):
        d.gradient(_ham(3))


def test_gradient_measurement_seed_rejected_anywhere():
    """A measurement carries a stochastic seed slot, so it is refused even
    in the prefix the backward walk never inverts."""
    c = Circuit(3)
    c.applyMidMeasurement(0, 5, site=0)
    c.hadamard(0)
    c.rotateX(0, P("a"))
    with pytest.raises(QuESTError, match="sample_request"):
        check_differentiable(c)


def test_gradient_rejects_density_circuit():
    c = Circuit(3, is_density_matrix=True)
    c.rotateX(0, P("a"))
    with pytest.raises(QuESTError, match="density"):
        check_differentiable(c)


def test_calc_grad_rejects_density_register():
    c = Circuit(3)
    c.rotateX(0, P("a"))
    rho = tq.createDensityQureg(3, TENV)
    with pytest.raises(QuESTError, match="state-vector"):
        tq.calcGradExpecPauliSum(rho, c, *_ham(3), {"a": 0.4})


def test_gradient_rejects_slot_free_tape():
    c = Circuit(3)
    c.hadamard(0)
    c.controlledNot(0, 1)
    with pytest.raises(QuESTError, match="no differentiable parameter"):
        check_differentiable(c)


def test_gradient_rejects_fused_run_plan_entry():
    c = Circuit(9)
    c.rotateX(0, P("a"))
    tq.random_layers(c, 9, 1)
    fz = c.fused(max_qubits=5, pallas=True, tile_bits=8)
    with pytest.raises(QuESTError, match=r"tape\[\d+\]:_apply_pallas_run.*fused-run"):
        check_differentiable(fz)


def test_request_executable_rejects_wants_values_reduce():
    c = Circuit(3)
    c.hadamard(0)
    c.rotateX(0, 0.4)
    with pytest.raises(QuESTError, match="wants_values.*Circuit.gradient"):
        request_executable(c, reduce=grad_reduce(c, _ham(3)))


def test_hamiltonian_validation():
    c = Circuit(3)
    c.rotateX(0, P("a"))
    for bad in ([[3, 0, 0]], ([[4, 0, 0]], [1.0]), ([[3, 0, 0, 0]], [1.0]),
                ([[3, 0, 0]], [np.nan]), ([], [])):
        with pytest.raises(QuESTError):
            gradient_executable(c, bad)
    # narrower rows pad with identities, a PauliHamil is taken as it is
    h = tq.createPauliHamil(3, 1)
    tq.initPauliHamil(h, [0.5], [3, 0, 0])
    g1 = c.gradient(h, donate=False)(_zero_amps(3), {"a": 0.3})
    g2 = c.gradient(([[3]], [0.5]), donate=False)(_zero_amps(3), {"a": 0.3})
    assert float(g1["value"]) == float(g2["value"]) == pytest.approx(0.5 * np.cos(0.3))


# ---------------------------------------------------------------------------
# serving: Engine.submit_grad, calcGradExpecPauliSum
# ---------------------------------------------------------------------------

def _vqe(mod, PP, n=5):
    c = mod.Circuit(n)
    _prefix(c)
    for q in range(n):
        c.rotateX(q, PP(f"x{q}"))
    for q in range(n - 1):
        c.controlledNot(q, q + 1)
    c.rotateZ(0, PP("z0"))
    return c


def _vqe_params(shift=0.0):
    p = {f"x{q}": 0.1 * (q + 1) + shift for q in range(5)}
    p["z0"] = -0.7 + shift
    return p


@pytest.mark.parametrize("max_batch", [4, 1])
@pytest.mark.parametrize("fused", [False, True])
def test_engine_submit_grad_warm_loop(fused, max_batch):
    """A warm submit_grad loop builds nothing and dispatches one
    grad_request program a step; a coalesced batch's lanes equal the same
    requests served alone bit for bit, and the unbatched Circuit.gradient
    within 1e-12."""
    c = _vqe(tq, P)
    if fused:
        c = c.fused(max_qubits=3)
    ham = _ham(5)
    eng = Engine(c, TENV, hamiltonian=ham, max_batch=max_batch, max_delay_ms=0.5)
    try:
        eng.warmup_grad(_vqe_params(), WAIT)
        traces = telemetry.counter_value("engine_trace_total", kind="param_replay")
        d0 = telemetry.counter_value("device_dispatch_total", route="grad_request")
        g0 = telemetry.counter_value("grad_requests_total")
        steps = [eng.submit_grad(_vqe_params(0.01 * k)).result(WAIT) for k in range(6)]
        assert telemetry.counter_value("engine_trace_total", kind="param_replay") == traces
        assert telemetry.counter_value("device_dispatch_total", route="grad_request") == d0 + 6
        assert telemetry.counter_value("grad_requests_total") == g0 + 6
        # coalesced lanes against single run-path requests, bit for bit
        sweep = [_vqe_params(0.05 * k) for k in range(max_batch)]
        lanes = [f.result(WAIT) for f in [eng.submit_grad(p) for p in sweep]]
        for p, (val, grads) in zip(sweep, lanes):
            one = eng.grad_engine().run(p, WAIT)
            assert torch.equal(val, one["value"])
            assert all(torch.equal(grads[k], one["grads"][k]) for k in grads)
        gx = c.gradient(ham, donate=False)
        for p, (val, grads) in [(_vqe_params(0.01 * k), s) for k, s in enumerate(steps)]:
            ref = gx(_zero_amps(5), p)
            assert abs(float(val) - float(ref["value"])) <= 1e-12
            for k in ref["grads"]:
                assert abs(float(grads[k]) - float(ref["grads"][k])) <= 1e-12
    finally:
        eng.close(timeout=WAIT)


def test_engine_submit_grad_requires_hamiltonian():
    eng = Engine(_vqe(tq, P), TENV, max_batch=2)
    try:
        with pytest.raises(QuESTError, match="hamiltonian"):
            eng.submit_grad({})
    finally:
        eng.close(timeout=WAIT)


def test_engine_submit_grad_against_quest_tpu_engine():
    """The port's gradient lanes against quest_tpu's Engine.submit_grad on
    the same sweep."""
    ham = _ham(5)
    sweep = [_vqe_params(0.1 * k) for k in range(3)]
    with Engine(_vqe(tq, P), TENV, hamiltonian=ham, max_batch=4, max_delay_ms=0.0) as eng:
        got = [f.result(WAIT) for f in [eng.submit_grad(p) for p in sweep]]
    jeng = jq.engine.Engine(_vqe(jq, JP), JENV, hamiltonian=ham, max_batch=4,
                            max_delay_ms=0.0)
    try:
        want = [f.result(WAIT) for f in [jeng.submit_grad(p) for p in sweep]]
    finally:
        jeng.close()
    for (gv, gg), (wv, wg) in zip(got, want):
        assert abs(float(gv) - float(wv)) <= F64_TOL
        for k in wg:
            assert abs(float(gg[k]) - float(wg[k])) <= F64_TOL


def test_calc_grad_expec_pauli_sum():
    codes, coeffs = _ham(5)
    params = _vqe_params()
    q = tq.createQureg(5, TENV)
    tq.initPlusState(q)
    before = q.amps.clone()
    val, grads = tq.calcGradExpecPauliSum(q, _vqe(tq, P), codes, coeffs, params)
    assert torch.equal(q.amps, before)  # read, never written
    jqq = jq.createQureg(5, JENV)
    jq.initPlusState(jqq)
    jval, jgrads = jq.calcGradExpecPauliSum(jqq, _vqe(jq, JP), codes, coeffs, params)
    assert abs(val - jval) <= F64_TOL
    assert grads.keys() == jgrads.keys()
    for k in grads:
        assert abs(grads[k] - jgrads[k]) <= F64_TOL
    ref = _vqe(tq, P).gradient((codes, coeffs), donate=False)(before.clone(), params)
    assert val == float(ref["value"])
    assert all(grads[k] == float(ref["grads"][k]) for k in grads)
