"""The port's registers, initialisers and gates against quest_tpu and the
dense numpy oracle (tests/oracle.py), plane for plane, in f64 (1e-10)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quest_tpu as jq
import quest_tpu_torch as tq
from quest_tpu_torch.interop import state_to_numpy

from . import oracle

N = 5
TOL = 1e-10


@pytest.fixture
def envs():
    return jq.createQuESTEnv(), tq.createQuESTEnv(device="cpu")


def _pair(envs, n=N):
    jenv, tenv = envs
    return jq.createQureg(n, jenv), tq.createQureg(n, tenv, precision_code=2)


def _same(jqr, tqr, tol=0.0):
    ref = np.asarray(jqr.amps)
    got = state_to_numpy(tqr)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


def test_create_qureg_matches_reference(envs):
    jqr, tqr = _pair(envs)
    _same(jqr, tqr)
    assert tqr.num_amps_total == 1 << N and tqr.device.type == "cpu"
    assert tqr.dtype == torch.float64 and tqr.eps == 1e-13
    f32 = tq.createQureg(N, envs[1], 1)  # precision code 1: f32
    assert f32.dtype == torch.float32 and f32.eps == 1e-5


@pytest.mark.parametrize("init,args", [
    ("initZeroState", ()), ("initPlusState", ()), ("initBlankState", ()),
    ("initClassicalState", (19,)), ("initDebugState", ()),
])
def test_initialisers_match_reference(envs, init, args):
    jqr, tqr = _pair(envs)
    getattr(jq, init)(jqr, *args)
    getattr(tq, init)(tqr, *args)
    _same(jqr, tqr, tol=1e-15)


H = np.array([[1, 1], [1, -1]]) / math.sqrt(2)
X = np.array([[0, 1], [1, 0]])
SWAP = np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]])
_U = np.linalg.qr(np.random.RandomState(3).randn(2, 2)
                  + 1j * np.random.RandomState(4).randn(2, 2))[0]


def _rx(a):
    return np.array([[math.cos(a / 2), -1j * math.sin(a / 2)],
                     [-1j * math.sin(a / 2), math.cos(a / 2)]])


def _zz_phase(n, qubits, theta):
    d = np.array([np.exp(-0.5j * theta * (1 - 2 * (bin(i & sum(1 << q for q in qubits))
                                                     .count("1") & 1)))
                  for i in range(1 << n)])
    return np.diag(d)


# (gate, args, oracle operator on N qubits)
GATES = [
    ("hadamard", (2,), oracle.full_operator(N, [2], H)),
    ("tGate", (4,), oracle.full_operator(N, [4], np.diag([1, np.exp(0.25j * math.pi)]))),
    ("rotateZ", (1, 0.7), oracle.full_operator(N, [1], np.diag([np.exp(-0.35j), np.exp(0.35j)]))),
    ("rotateX", (3, 1.3), oracle.full_operator(N, [3], _rx(1.3))),
    ("controlledNot", (0, 4), oracle.full_operator(N, [4], X, [0])),
    ("controlledPhaseFlip", (3, 1), oracle.full_operator(N, [1], np.diag([1, -1]), [3])),
    ("unitary", (0, _U), oracle.full_operator(N, [0], _U)),
    ("multiRotateZ", ([0, 2, 4], 0.9), _zz_phase(N, [0, 2, 4], 0.9)),
    ("swapGate", (1, 3), oracle.full_operator(N, [1, 3], SWAP)),
    ("multiStateControlledUnitary", ([0, 4], [0, 1], 2, _U),
     oracle.full_operator(N, [2], _U, [0, 4], [0, 1])),
    ("pauliX", (2,), oracle.full_operator(N, [2], X)),
]


@pytest.mark.parametrize("gate,args,op", GATES, ids=[g[0] for g in GATES])
def test_gate_matches_reference_and_oracle(envs, gate, args, op):
    jqr, tqr = _pair(envs)
    jq.initDebugState(jqr)
    tq.initDebugState(tqr)
    getattr(jq, gate)(jqr, *args)
    getattr(tq, gate)(tqr, *args)
    _same(jqr, tqr, tol=TOL)
    psi = oracle.debug_statevec(1 << N)
    np.testing.assert_allclose(tq.get_np(tqr), op @ psi, rtol=0, atol=TOL)


def test_qasm_log_matches_reference(envs):
    jqr, tqr = _pair(envs)
    for q in (jqr, tqr):
        q.qasm_log.start()
    for mod, q in ((jq, jqr), (tq, tqr)):
        mod.initClassicalState(q, 3)
        mod.hadamard(q, 0)
        mod.rotateZ(q, 1, 0.25)
        mod.controlledNot(q, 0, 2)
        mod.unitary(q, 3, _U)
        mod.multiStateControlledUnitary(q, [1], [0], 4, _U)
        mod.multiRotateZ(q, [0, 1], 0.5)
        mod.swapGate(q, 2, 4)
    assert tqr.qasm_log.printed() == jqr.qasm_log.printed()


@pytest.mark.parametrize("call,match", [
    (lambda m, q: m.hadamard(q, N), "Invalid target qubit"),
    (lambda m, q: m.controlledNot(q, 1, 1), "Control qubit cannot equal target qubit"),
    (lambda m, q: m.unitary(q, 0, np.ones((2, 2))), "Matrix is not unitary"),
    (lambda m, q: m.swapGate(q, 2, 2), "Qubits must be unique"),
    (lambda m, q: m.multiStateControlledUnitary(q, [0], [2], 1, _U), "Invalid control-state"),
    (lambda m, q: m.calcProbOfOutcome(q, 0, 2), "Invalid measurement outcome"),
    (lambda m, q: m.getAmp(q, 1 << N), "Invalid amplitude index"),
    (lambda m, q: m.initClassicalState(q, -1), "Invalid state index"),
])
def test_validation_messages_match_reference(envs, call, match):
    jqr, tqr = _pair(envs)
    with pytest.raises(jq.QuESTError, match=match):
        call(jq, jqr)
    with pytest.raises(tq.QuESTError, match=match):
        call(tq, tqr)
    _same(jqr, tqr)  # state unchanged


def test_destroy_qureg_releases_buffers(envs):
    q = tq.createQureg(N, envs[1])
    q.spare_buffer()
    tq.destroyQureg(q)
    assert q.amps is None and q.spare is None


# ---------------------------------------------------------------------------
# density registers
# ---------------------------------------------------------------------------

ND = 3


def _density_pair(envs, n=ND):
    jenv, tenv = envs
    return jq.createDensityQureg(n, jenv), tq.createDensityQureg(n, tenv, 2)


def test_create_density_qureg_matches_reference(envs):
    jqr, tqr = _density_pair(envs)
    _same(jqr, tqr)
    assert tqr.is_density_matrix and tqr.num_qubits_in_state_vec == 2 * ND
    assert tqr.num_amps_total == 1 << (2 * ND) and tqr.dtype == torch.float64
    with pytest.raises(tq.QuESTError, match="Invalid number of qubits"):
        tq.createDensityQureg(0, envs[1])


@pytest.mark.parametrize("init,args", [
    ("initZeroState", ()), ("initPlusState", ()), ("initBlankState", ()),
    ("initClassicalState", (5,)), ("initDebugState", ()), ("initPureState", None),
])
def test_density_initialisers_match_reference(envs, init, args):
    jqr, tqr = _density_pair(envs)
    if args is None:  # rho = |psi><psi| of a debug-state vector
        jp, tp = _pair(envs, ND)
        jq.initDebugState(jp)
        tq.initDebugState(tp)
        jq.initPureState(jqr, jp)
        tq.initPureState(tqr, tp)
        psi = oracle.debug_statevec(1 << ND)
        np.testing.assert_allclose(tq.get_np(tqr).reshape(1 << ND, 1 << ND).T,
                                   np.outer(psi, psi.conj()), rtol=0, atol=TOL)
    else:
        getattr(jq, init)(jqr, *args)
        getattr(tq, init)(tqr, *args)
    _same(jqr, tqr, tol=1e-15 * max(np.abs(np.asarray(jqr.amps)).max(), 1.0))


@pytest.mark.parametrize("gate,args", [(g[0], g[1]) for g in GATES],
                         ids=[g[0] for g in GATES])
def test_gate_on_density_matches_reference_and_oracle(envs, gate, args):
    """The slice's gates on a density register: U on the rows, conj(U) on
    the columns (the conj-shadow), plane for plane against quest_tpu and as
    U rho U^dagger against the oracle (on 5-qubit registers, as GATES)."""
    jqr, tqr = _density_pair(envs, N)
    rho = oracle.random_density(N, np.random.RandomState(9))
    flat = rho.T.reshape(-1)
    planar = np.stack([flat.real, flat.imag])
    jqr.put(jnp.asarray(planar))
    tqr.put(torch.as_tensor(planar))
    getattr(jq, gate)(jqr, *args)
    getattr(tq, gate)(tqr, *args)
    _same(jqr, tqr, tol=TOL)
    op = dict((g[0], g[2]) for g in GATES)[gate]
    got = tq.get_np(tqr).reshape(1 << N, 1 << N).T
    np.testing.assert_allclose(got, op @ rho @ op.conj().T, rtol=0, atol=TOL)


@pytest.mark.parametrize("targets,controls", [((N - 1,), ()), ((N - 2, N - 1), ()),
                                              ((N - 1,), (N - 2,)), ((0, N - 1), ())])
def test_engine_leaves_its_input_as_it_was(targets, controls):
    """apply_matrix / apply_x_class return a new tensor even where the
    grouped view is already contiguous (targets on the top qubits)."""
    from quest_tpu_torch.ops import apply as K

    x = torch.as_tensor(np.random.RandomState(1).randn(2, 1 << N))
    x0 = x.clone()
    m = torch.as_tensor(np.stack([_U.real, _U.imag]) if len(targets) == 1 else
                        np.stack([np.kron(_U, _U).real, np.kron(_U, _U).imag]))
    y = K.apply_matrix(x, m, n=N, targets=targets, controls=controls)
    z = K.apply_x_class(x, n=N, targets=targets, controls=controls)
    assert torch.equal(x, x0)
    assert y.data_ptr() != x.data_ptr() and z.data_ptr() != x.data_ptr()
    assert not torch.equal(y, x0) and not torch.equal(z, x0)
