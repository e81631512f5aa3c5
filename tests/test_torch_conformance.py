"""The dense-gate surface of quest_tpu_torch against quest_tpu and the dense
numpy oracle (tests/oracle.py).

Every generated case of quest_tpu's conformance registry
(quest_tpu/analysis/conformance.py) is replayed through the port on CPU
registers, called by name as tests/test_conformance.py calls it: on a
state-vector at TOL (f64), a deterministic third on density registers
(applyMatrix* left-multiplying, LEFT_MULT_ON_DENSITY), and the route-matrix
set in f32 at 2e-4. Then the state-init rows, QASM text, validation
messages and seeded measurement sequences against quest_tpu.
"""

import jax
import numpy as np
import pytest
import torch

import quest_tpu as jq
from quest_tpu.analysis import conformance as CF
import quest_tpu_torch as tq
from quest_tpu_torch.interop import arg_from_reference, state_to_numpy

from . import oracle
from .helpers import NUM_QUBITS, TOL, get_density, get_statevec, set_density, set_statevec

N = NUM_QUBITS
F32_TOL = 2e-4
JENV = jq.createQuESTEnv(jax.devices()[:1])
TENV = tq.createQuESTEnv(device="cpu")

CASES = CF.conformance_cases(N)
DENSITY_CASES = [c for i, c in enumerate(CASES) if i % 3 == 0]


def test_port_exports_every_oracle_spec():
    missing = sorted(n for n in CF.ORACLE_SPECS
                     if n not in tq.__all__ or not callable(getattr(tq, n, None)))
    assert not missing
    assert len(CF.ORACLE_SPECS) == 47


def _statevec_pair(v, precision):
    jqr = jq.createQureg(N, JENV, precision)
    set_statevec(jqr, v)
    tqr = tq.createQureg(N, TENV, precision)
    tq.initStateFromAmps(tqr, v.real, v.imag)
    return jqr, tqr


def _call(case, jqr, tqr):
    getattr(jq, case.name)(jqr, *case.args)
    getattr(tq, case.name)(tqr, *arg_from_reference(case.args))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_statevec_replay(case):
    v = oracle.random_statevec(N, CF.case_rng("sv:" + case.id))
    jqr, tqr = _statevec_pair(v, 2)
    _call(case, jqr, tqr)
    ref = oracle.apply_to_statevec(v, N, case.targets, case.matrix,
                                   controls=case.controls,
                                   control_states=case.control_states)
    got = tq.get_np(tqr)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, get_statevec(jqr), rtol=0, atol=TOL)


@pytest.mark.parametrize("case", DENSITY_CASES, ids=lambda c: c.id)
def test_density_replay(case):
    rho = oracle.random_density(N, CF.case_rng("dn:" + case.id))
    jqr = jq.createDensityQureg(N, JENV, 2)
    set_density(jqr, rho)
    tqr = tq.createDensityQureg(N, TENV, 2)
    flat = rho.T.reshape(-1)
    tq.setDensityAmps(tqr, 0, 0, flat.real, flat.imag, flat.size)
    _call(case, jqr, tqr)
    if case.name in CF.LEFT_MULT_ON_DENSITY:
        F = oracle.full_operator(N, case.targets, case.matrix, case.controls,
                                 case.control_states)
        ref = F @ rho
    else:
        ref = oracle.apply_to_density(rho, N, case.targets, case.matrix,
                                      controls=case.controls,
                                      control_states=case.control_states)
    got = tq.get_np(tqr).reshape(1 << N, 1 << N).T
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, get_density(jqr), rtol=0, atol=TOL)


@pytest.mark.parametrize("case", CF.route_cases(N), ids=lambda c: c.name)
def test_route_matrix_f32(case):
    v = oracle.random_statevec(N, CF.case_rng(f"rt:{case.id}"))
    jqr, tqr = _statevec_pair(v, 1)
    assert tqr.dtype == torch.float32
    _call(case, jqr, tqr)
    ref = oracle.apply_to_statevec(v, N, case.targets, case.matrix,
                                   controls=case.controls,
                                   control_states=case.control_states)
    got = tq.get_np(tqr)
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(got, get_statevec(jqr), rtol=0, atol=F32_TOL)


# ---------------------------------------------------------------------------
# state initialisation
# ---------------------------------------------------------------------------

def _debug_pair(density=False, n=N):
    mk = ((jq.createDensityQureg, tq.createDensityQureg) if density
          else (jq.createQureg, tq.createQureg))
    jqr, tqr = mk[0](n, JENV, 2), mk[1](n, TENV, 2)
    jq.initDebugState(jqr)
    tq.initDebugState(tqr)
    return jqr, tqr


def _same(jqr, tqr, tol=1e-15):
    ref = np.asarray(jqr.amps)
    np.testing.assert_allclose(state_to_numpy(tqr), ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1.0))


_R = np.random.RandomState(5)
_RE, _IM = _R.randn(1 << N), _R.randn(1 << N)


@pytest.mark.parametrize("name,args,density", [
    ("initStateFromAmps", (_RE, _IM), False),
    ("initStateFromAmps", (np.tile(_RE, 32), np.tile(_IM, 32)), True),
    ("setAmps", (3, _RE, _IM, 11), False),
    ("setAmps", (0, _RE, _IM, 1 << N), False),
    ("setDensityAmps", (2, 5, _RE, _IM, 9), True),
    ("setDensityAmps", (0, 0, _RE, _IM, 1 << N), True),
], ids=["initStateFromAmps", "initStateFromAmps-density", "setAmps-slice",
        "setAmps-all", "setDensityAmps-slice", "setDensityAmps-all"])
def test_state_init_rows_match_reference(name, args, density):
    jqr, tqr = _debug_pair(density)
    getattr(jq, name)(jqr, *args)
    getattr(tq, name)(tqr, *args)
    _same(jqr, tqr)


@pytest.mark.parametrize("density", [False, True], ids=["statevec", "density"])
def test_clone_and_weighted_sum_match_reference(density):
    ja, ta = _debug_pair(density, 3)
    jb, tb = _debug_pair(density, 3)
    for mod, b in ((jq, jb), (tq, tb)):
        mod.hadamard(b, 1)
        mod.rotateY(b, 2, 0.3)
    jo, to = _debug_pair(density, 3)
    jq.setWeightedQureg(0.5 - 0.2j, ja, 1j, jb, -0.3, jo)
    tq.setWeightedQureg(0.5 - 0.2j, ta, 1j, tb, -0.3, to)
    _same(jo, to, 1e-14)
    jc = (jq.createDensityQureg if density else jq.createQureg)(3, JENV, 2)
    tc = (tq.createDensityQureg if density else tq.createQureg)(3, TENV, 2)
    jq.cloneQureg(jc, jb)
    tq.cloneQureg(tc, tb)
    _same(jc, tc, 1e-14)
    tq.hadamard(tc, 0)  # the clone is a copy
    _same(jb, tb, 1e-14)
    assert tq.getNumQubits(tc) == jq.getNumQubits(jc) == 3
    if not density:
        assert tq.getNumAmps(tc) == jq.getNumAmps(jc) == 8


def test_tape_records_what_the_reference_records():
    """The operators module is tapeable; measurement and the host-data
    initialisers are not, nor functions that take a second register."""
    from quest_tpu.circuits import Circuit as JCircuit

    for name in ("applyMatrix2", "applyMultiControlledGateMatrixN", "sqrtSwapGate",
                 "diagonalUnitary", "multiRotatePauli"):
        getattr(tq.Circuit(3), name)
        getattr(JCircuit(3), name)
    for name in ("measure", "measureWithStats", "collapseToOutcome", "setAmps",
                 "setDensityAmps", "initStateFromAmps", "cloneQureg",
                 "setWeightedQureg"):
        for circ in (tq.Circuit(3), JCircuit(3)):
            with pytest.raises(AttributeError):
                getattr(circ, name)


# ---------------------------------------------------------------------------
# QASM, validation, measurement
# ---------------------------------------------------------------------------

_U1 = oracle.random_unitary(1, np.random.RandomState(1))
_U2 = oracle.random_unitary(2, np.random.RandomState(2))
_U3 = oracle.random_unitary(3, np.random.RandomState(3))


def _gate_sequence(mod, q):
    op = mod.createSubDiagonalOp(2)
    op.elems[:] = np.exp(1j * np.array([0.1, 0.2, 0.3, 0.4]))
    mod.initPlusState(q)
    mod.phaseShift(q, 0, 0.3)
    mod.controlledPhaseShift(q, 0, 1, -0.4)
    mod.multiControlledPhaseShift(q, [0, 1, 2], 0.5)
    mod.multiControlledPhaseFlip(q, [1, 3])
    mod.sGate(q, 2)
    mod.pauliY(q, 3)
    mod.pauliZ(q, 4)
    mod.controlledPauliY(q, 1, 4)
    mod.rotateY(q, 0, 0.7)
    mod.rotateAroundAxis(q, 1, 0.9, mod.Vector(1.0, -2.0, 0.5))
    mod.controlledRotateX(q, 2, 3, 0.2)
    mod.controlledRotateY(q, 3, 2, -0.2)
    mod.controlledRotateZ(q, 4, 0, 1.1)
    mod.controlledRotateAroundAxis(q, 0, 4, 0.4, mod.Vector(0.0, 1.0, 1.0))
    mod.compactUnitary(q, 2, 0.6, 0.8j)
    mod.controlledCompactUnitary(q, 1, 2, 0.8j, -0.6)
    mod.controlledUnitary(q, 3, 1, _U1)
    mod.multiControlledUnitary(q, [0, 4], 2, _U1)
    mod.multiQubitNot(q, [0, 2])
    mod.multiControlledMultiQubitNot(q, [1], [3, 4])
    mod.multiRotatePauli(q, [0, 1, 2], [1, 2, 3], 0.3)
    mod.multiControlledMultiRotatePauli(q, [4], [0, 3], [2, 0], -0.6)
    mod.multiControlledMultiRotateZ(q, [3], [1, 2], 0.25)
    mod.diagonalUnitary(q, [1, 3], op)
    mod.sqrtSwapGate(q, 0, 3)
    mod.twoQubitUnitary(q, 4, 1, _U2)
    mod.controlledTwoQubitUnitary(q, 0, 2, 3, _U2)
    mod.multiControlledTwoQubitUnitary(q, [0, 1], 2, 4, _U2)
    mod.multiQubitUnitary(q, [3, 0, 4], _U3)
    mod.controlledMultiQubitUnitary(q, 2, [1, 0, 3], _U3)
    mod.multiControlledMultiQubitUnitary(q, [4, 2], [0, 1, 3], _U3)
    mod.applyMatrix2(q, 1, _U1)
    mod.applyMatrix4(q, 0, 2, _U2)
    mod.applyMatrixN(q, [2, 3, 4], _U3)
    mod.applyGateMatrixN(q, [4, 0], _U2)
    mod.applyMultiControlledMatrixN(q, [1], [0, 3], _U2)
    mod.applyMultiControlledGateMatrixN(q, [2, 3], [4], _U1)


def test_qasm_of_the_new_gates_matches_reference():
    jqr, tqr = jq.createQureg(N, JENV, 2), tq.createQureg(N, TENV, 2)
    for q in (jqr, tqr):
        q.qasm_log.start()
    _gate_sequence(jq, jqr)
    _gate_sequence(tq, tqr)
    jq.collapseToOutcome(jqr, 0, 1)
    tq.collapseToOutcome(tqr, 0, 1)
    jq.seedQuEST(jqr.env, [7])
    tq.seedQuEST(tqr.env, [7])
    assert tq.measure(tqr, 2) == jq.measure(jqr, 2)
    assert tqr.qasm_log.printed() == jqr.qasm_log.printed()
    _same(jqr, tqr, 1e-12)


@pytest.mark.parametrize("call,match", [
    (lambda m, q: m.twoQubitUnitary(q, 0, 1, np.ones((4, 4))), "Matrix is not unitary"),
    (lambda m, q: m.compactUnitary(q, 0, 1.0, 0.5), "is not unitary"),
    (lambda m, q: m.multiQubitUnitary(q, [1, 1], _U2), "target qubits must be unique"),
    (lambda m, q: m.controlledUnitary(q, 2, 2, _U1), "Control qubit cannot equal target"),
    (lambda m, q: m.multiControlledTwoQubitUnitary(q, [0, 3], 3, 1, _U2),
     "Control and target qubits must be disjoint"),
    (lambda m, q: m.multiRotatePauli(q, [0, 1], [1, 4], 0.3), "Invalid Pauli code"),
    (lambda m, q: m.multiRotatePauli(q, [0, 1], [1], 0.3), "Invalid number of Pauli codes"),
    (lambda m, q: m.collapseToOutcome(q, 0, 2), "Invalid measurement outcome"),
    (lambda m, q: m.collapseToOutcome(q, 1, 1), "zero probability"),
    (lambda m, q: m.rotateAroundAxis(q, 0, 0.2, m.Vector(0.0, 0.0, 0.0)),
     "Invalid axis vector"),
    (lambda m, q: m.applyMatrixN(q, [0, 1], _U1), "Matrix size does not match"),
    (lambda m, q: m.setAmps(q, 30, _RE, _IM, 5), "Invalid number of amplitudes"),
    (lambda m, q: m.initStateFromAmps(q, _RE[:3], _IM[:3]), "Invalid number of amplitudes"),
    (lambda m, q: m.setDensityAmps(q, 0, 0, _RE, _IM, 2), "valid only for density"),
    (lambda m, q: m.cloneQureg(q, m.createQureg(N - 1, q.env)),
     "Dimensions of the qubit registers don't match"),
])
def test_validation_messages_match_reference(call, match):
    jqr, tqr = jq.createQureg(N, JENV, 2), tq.createQureg(N, TENV, 2)
    with pytest.raises(jq.QuESTError, match=match):
        call(jq, jqr)
    with pytest.raises(tq.QuESTError, match=match):
        call(tq, tqr)
    _same(jqr, tqr)  # state unchanged


def test_diagonal_unitary_validation_matches_reference():
    for mod, env in ((jq, JENV), (tq, TENV)):
        q = mod.createQureg(N, env, 2)
        op = mod.createSubDiagonalOp(2)
        op.elems[:] = [1, 1, 1, 2]
        with pytest.raises(mod.QuESTError, match="Diagonal operator is not unitary"):
            mod.diagonalUnitary(q, [0, 1], op)
        with pytest.raises(mod.QuESTError, match="incompatible dimension"):
            mod.diagonalUnitary(q, [0, 1, 2], op)


@pytest.mark.parametrize("density", [False, True], ids=["statevec", "density"])
def test_measurement_sequences_match_reference(density):
    """Under the same seedQuEST keys, measureWithStats/measure draw the same
    outcomes as quest_tpu, leave the same collapsed states, and consume the
    RNG only for a genuinely random outcome (the deterministic qubit 4 in
    between keeps the streams aligned)."""
    n = 5
    mk = ((jq.createDensityQureg, tq.createDensityQureg) if density
          else (jq.createQureg, tq.createQureg))
    results = []
    for mod, env, create in ((jq, JENV, mk[0]), (tq, TENV, mk[1])):
        q = create(n, env, 2)
        mod.seedQuEST(env, [11, 2026])
        outcomes, probs = [], []
        for _ in range(6):
            mod.initZeroState(q)
            for t in range(4):
                mod.rotateY(q, t, 0.4 + 0.5 * t)
            mod.controlledNot(q, 0, 3)
            outcome, prob = mod.measureWithStats(q, 1)
            outcomes += [outcome, mod.measure(q, 4), mod.measure(q, 3)]
            probs += [prob, mod.collapseToOutcome(q, 2, 1)]
        results.append((outcomes, probs, np.asarray(q.amps.cpu() if mod is tq else q.amps)))
    (jout, jprob, jstate), (tout, tprob, tstate) = results
    assert tout == jout and len(set(tout[0::3])) == 2  # both outcomes drawn
    np.testing.assert_allclose(tprob, jprob, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tstate, jstate, rtol=0, atol=1e-12)
