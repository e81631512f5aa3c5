"""The port's operators slice against quest_tpu and the numpy oracle
(tests/oracle.py; the oracles of tests/test_operators.py): Pauli sums and
Hamiltonians, Trotter circuits, setQuregToPauliHamil, the QFT, projectors,
DiagonalOp (create / init / set / from a Hamiltonian or its file / apply /
expectation / destroy), sub-diagonal operators, and the host mirror with
the four copyState*GPU rows; their QASM text and validation messages; and
QFT and Trotter tapes planned into fused gate runs by the port's
``Circuit.fused(pallas=True)`` against the JAX package's plan, its fused
run in interpret mode and the per-gate replay. The phase-function rows are
in tests/test_torch_phasefunc.py.

Inputs are made with numpy from a seed and loaded into both packages.
State vectors run on one device and over 4 and 8 shards (port: virtual CPU
shards; quest_tpu: 4 or 8 of its emulated CPU devices) and on registers of
mixed layouts; density registers on one device. Tolerances as
tests/helpers.py's TOL: 2e-4 in f32, 1e-10 in f64.
"""

import math

import jax
import numpy as np
import pytest
import torch

import quest_tpu as jq
import quest_tpu_torch as tq
from quest_tpu import fusion as JF
from quest_tpu.circuits import Circuit as JCircuit
from quest_tpu_torch import fusion as F
from quest_tpu_torch.interop import circuit_from_tape, state_to_numpy

from . import oracle
from .test_torch_fusion import assert_plans_equal

N = 7
ND = 3
TOLS = {1: 2e-4, 2: 1e-10}
#: (precision, devices): f32 and f64 on one device, f64 over 4 shards (the
#: top 2 of 7 qubits sharded), f32 over 8 (the top 3)
CASES = [(1, 1), (2, 1), (2, 4), (1, 8)]


def _envs(d):
    tenv = (tq.createQuESTEnv(device="cpu") if d == 1
            else tq.createQuESTEnv(devices=["cpu"] * d))
    return jq.createQuESTEnv(jax.devices()[:d]), tenv


def _pair(envs, n, prec, rng, density=False):
    """One register in each package holding the same random state; returns
    (jax register, port register, the state as a vector or matrix)."""
    jenv, tenv = envs
    if density:
        state = oracle.random_density(n, rng)
        flat = state.T.reshape(-1)
        jqr, tqr = jq.createDensityQureg(n, jenv, prec), tq.createDensityQureg(n, tenv, prec)
    else:
        state = flat = oracle.random_statevec(n, rng)
        jqr, tqr = jq.createQureg(n, jenv, prec), tq.createQureg(n, tenv, prec)
    for mod, q in ((jq, jqr), (tq, tqr)):
        mod.initStateFromAmps(q, flat.real, flat.imag)
    return jqr, tqr, state


def _vec(q):
    """A register's state as a complex vector, or a density matrix as its
    matrix (the flat layout is [col, row])."""
    a = state_to_numpy(q) if isinstance(q, tq.Qureg) else np.asarray(q.amps)
    v = a[0] + 1j * a[1]
    if q.is_density_matrix:
        dim = 1 << q.num_qubits_represented
        return v.reshape(dim, dim).T
    return v


def _check(jqr, tqr, expected, tol):
    np.testing.assert_allclose(_vec(tqr), expected, rtol=0, atol=tol)
    if jqr is not None:
        np.testing.assert_allclose(_vec(tqr), _vec(jqr), rtol=0, atol=tol)


def _both(call, jqr, tqr):
    call(jq, jqr)
    call(tq, tqr)


def _pauli_sum_matrix(n, codes, coeffs):
    return sum(c * oracle.pauli_product_matrix(n, range(n), row)
               for c, row in zip(coeffs, codes))


def _hamil(mod, n, coeffs, codes):
    h = mod.createPauliHamil(n, len(coeffs))
    mod.initPauliHamil(h, coeffs, codes)
    return h


CODES = [[1, 0, 0, 0, 0, 2, 3], [0, 2, 3, 0, 0, 0, 1], [3, 3, 0, 1, 2, 0, 0],
         [0, 0, 0, 0, 0, 0, 0]]
COEFFS = [0.3, -1.1, 0.5, 0.25]


# ---------------------------------------------------------------------------
# Pauli sums and Hamiltonians
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec,d", CASES)
def test_apply_pauli_sum(prec, d):
    tol = TOLS[prec]
    envs = _envs(d)
    jin, tin, v = _pair(envs, N, prec, np.random.RandomState(prec + d))
    jout, tout, _ = _pair(envs, N, prec, np.random.RandomState(99))
    _both(lambda m, q: m.applyPauliSum(q[0], np.ravel(CODES), COEFFS, q[1]),
          (jin, jout), (tin, tout))
    _check(jout, tout, _pauli_sum_matrix(N, CODES, COEFFS) @ v, tol)
    _check(jin, tin, v, tol)  # in_qureg left as it was
    assert (tout.shards is None) == (d == 1)
    h = _hamil(tq, N, COEFFS[:2], CODES[:2])
    tq.applyPauliHamil(tin, h, tout)
    _check(None, tout, _pauli_sum_matrix(N, CODES[:2], COEFFS[:2]) @ v, tol)


@pytest.mark.parametrize("layouts", [(4, 1), (1, 8), (8, 4)])
def test_apply_pauli_sum_mixed_layouts(layouts):
    """in_qureg and out_qureg cut differently: the sum is re-cut into
    out_qureg's layout."""
    (_, tin_env), (_, tout_env) = _envs(layouts[0]), _envs(layouts[1])
    rng = np.random.RandomState(sum(layouts))
    v = oracle.random_statevec(N, rng)
    tin, tout = tq.createQureg(N, tin_env, 2), tq.createQureg(N, tout_env, 2)
    tq.initStateFromAmps(tin, v.real, v.imag)
    h = _hamil(tq, N, COEFFS, CODES)
    tq.applyPauliHamil(tin, h, tout)
    assert (tout.shards is None) == (layouts[1] == 1)
    _check(None, tout, _pauli_sum_matrix(N, CODES, COEFFS) @ v, 1e-10)
    _check(None, tin, v, 0)


@pytest.mark.parametrize("prec", [1, 2])
def test_apply_pauli_sum_density(prec):
    """On a density register each term left-multiplies rho (out = H rho)."""
    envs = _envs(1)
    jin, tin, rho = _pair(envs, ND, prec, np.random.RandomState(3), density=True)
    jout, tout, _ = _pair(envs, ND, prec, np.random.RandomState(4), density=True)
    codes, coeffs = [[1, 0, 2], [3, 3, 0], [0, 2, 1]], [0.7, -0.2, 1.1]
    _both(lambda m, q: m.applyPauliHamil(q[0], _hamil(m, ND, coeffs, codes), q[1]),
          (jin, jout), (tin, tout))
    _check(jout, tout, _pauli_sum_matrix(ND, codes, coeffs) @ rho, TOLS[prec])
    _check(jin, tin, rho, TOLS[prec])


# ---------------------------------------------------------------------------
# Trotter circuits
# ---------------------------------------------------------------------------

def _term_exponential(n, code_row, coeff, dt):
    """e^{-i c dt P}: cos(c dt) I - i sin(c dt) P (P != I), else a phase."""
    P = oracle.pauli_product_matrix(n, range(n), code_row)
    if not any(code_row):
        return np.exp(-1j * coeff * dt) * np.eye(1 << n)
    return math.cos(coeff * dt) * np.eye(1 << n) - 1j * math.sin(coeff * dt) * P


def _trotter_oracle(n, codes, coeffs, time, order, reps):
    """The symmetric Suzuki recursion with exact term exponentials."""
    dim = 1 << n

    def first_order(dt, reverse):
        u = np.eye(dim)
        idx = range(len(coeffs))
        for t in (reversed(list(idx)) if reverse else idx):
            u = _term_exponential(n, codes[t], coeffs[t], dt) @ u
        return u

    def cycle(dt, order):
        if order == 1:
            return first_order(dt, False)
        if order == 2:
            return first_order(dt / 2, True) @ first_order(dt / 2, False)
        p = 1.0 / (4 - 4 ** (1.0 / (order - 1)))
        u = np.eye(dim)
        for frac in (p, p, 1 - 4 * p, p, p):
            u = cycle(frac * dt, order - 2) @ u
        return u

    return np.linalg.matrix_power(cycle(time / reps, order), reps)


TROTTER_CODES = [[1, 0, 0, 0, 0, 0, 3], [3, 3, 0, 0, 0, 0, 0], [0, 0, 2, 1, 0, 2, 0],
                 [0, 0, 0, 0, 0, 0, 0]]
TROTTER_COEFFS = [0.5, -0.3, 0.8, 0.2]


@pytest.mark.parametrize("prec,d,order,reps", [(2, 1, 1, 3), (1, 1, 2, 2), (2, 1, 4, 1),
                                               (2, 4, 2, 1), (1, 8, 1, 1)])
def test_apply_trotter_circuit(prec, d, order, reps):
    jqr, tqr, v = _pair(_envs(d), N, prec, np.random.RandomState(order + reps + d))
    _both(lambda m, q: m.applyTrotterCircuit(
        q, _hamil(m, N, TROTTER_COEFFS, TROTTER_CODES), 0.6, order, reps), jqr, tqr)
    u = _trotter_oracle(N, TROTTER_CODES, TROTTER_COEFFS, 0.6, order, reps)
    _check(jqr, tqr, u @ v, TOLS[prec])


def test_apply_trotter_circuit_density():
    jqr, tqr, rho = _pair(_envs(1), ND, 2, np.random.RandomState(8), density=True)
    codes, coeffs = [[1, 0, 3], [0, 2, 2], [3, 0, 0]], [0.5, -0.4, 0.9]
    _both(lambda m, q: m.applyTrotterCircuit(q, _hamil(m, ND, coeffs, codes), 0.4, 2, 2),
          jqr, tqr)
    u = _trotter_oracle(ND, codes, coeffs, 0.4, 2, 2)
    _check(jqr, tqr, u @ rho @ u.conj().T, 1e-10)


@pytest.mark.parametrize("prec", [1, 2])
def test_set_qureg_to_pauli_hamil(prec):
    envs = _envs(1)
    jqr, tqr, _ = _pair(envs, ND, prec, np.random.RandomState(1), density=True)
    codes, coeffs = [[1, 0, 3], [0, 2, 0], [2, 2, 1], [0, 0, 0], [3, 3, 3]], \
        [0.25, -1.5, 0.7, 0.1, -0.3]
    _both(lambda m, q: m.setQuregToPauliHamil(q, _hamil(m, ND, coeffs, codes)), jqr, tqr)
    _check(jqr, tqr, _pauli_sum_matrix(ND, codes, coeffs), TOLS[prec])
    # the same to rounding as the JAX package's host sum
    np.testing.assert_array_equal(state_to_numpy(tqr), np.asarray(jqr.amps))


# ---------------------------------------------------------------------------
# QFT and projectors
# ---------------------------------------------------------------------------

def _dft(m):
    x = np.arange(1 << m)
    return np.exp(2j * np.pi * np.outer(x, x) / (1 << m)) / math.sqrt(1 << m)


@pytest.mark.parametrize("prec,d", CASES)
def test_qft(prec, d):
    """On 5 qubits (the top 2 or 3 sharded)."""
    tol, n = TOLS[prec], 5
    jqr, tqr, v = _pair(_envs(d), n, prec, np.random.RandomState(10 + d))
    _both(lambda m, q: m.applyFullQFT(q), jqr, tqr)
    v = _dft(n) @ v
    _check(jqr, tqr, v, tol)
    # unsorted, sharded qubits among them at d > 1
    qubits = (4, 1, 3)
    _both(lambda m, q: m.applyQFT(q, list(qubits)), jqr, tqr)
    _check(jqr, tqr, oracle.full_operator(n, qubits, _dft(len(qubits))) @ v, tol)


def test_qft_density():
    jqr, tqr, rho = _pair(_envs(1), ND, 2, np.random.RandomState(12), density=True)
    _both(lambda m, q: m.applyFullQFT(q), jqr, tqr)
    f = _dft(ND)
    rho = f @ rho @ f.conj().T
    _check(jqr, tqr, rho, 1e-10)
    _both(lambda m, q: m.applyQFT(q, [2, 0]), jqr, tqr)
    f = oracle.full_operator(ND, (2, 0), _dft(2))
    _check(jqr, tqr, f @ rho @ f.conj().T, 1e-10)


@pytest.mark.parametrize("prec,d", CASES)
def test_projector(prec, d):
    jqr, tqr, v = _pair(_envs(d), N, prec, np.random.RandomState(20 + d))
    for target, outcome in ((3, 0), (6, 1), (0, 1), (5, 0)):
        _both(lambda m, q: m.applyProjector(q, target, outcome), jqr, tqr)
        proj = np.zeros((2, 2))
        proj[outcome, outcome] = 1
        v = oracle.full_operator(N, (target,), proj) @ v
        _check(jqr, tqr, v, TOLS[prec])


def test_projector_density():
    jqr, tqr, rho = _pair(_envs(1), ND, 2, np.random.RandomState(23), density=True)
    for target, outcome in ((1, 1), (2, 0)):
        _both(lambda m, q: m.applyProjector(q, target, outcome), jqr, tqr)
        proj = np.zeros((2, 2))
        proj[outcome, outcome] = 1
        f = oracle.full_operator(ND, (target,), proj)
        rho = f @ rho @ f.conj().T
        _check(jqr, tqr, rho, 1e-10)


# ---------------------------------------------------------------------------
# DiagonalOp
# ---------------------------------------------------------------------------

def _elems(rng, n):
    """Random diagonal elements, exact in float32 (whatever the global
    precision, the stored elements are the oracle's)."""
    re, im = (rng.randn(1 << n).astype(np.float32).astype(float) for _ in range(2))
    return re, im


@pytest.mark.parametrize("prec,d", CASES)
def test_diagonal_op(prec, d):
    tol = TOLS[prec]
    envs = _envs(d)
    rng = np.random.RandomState(30 + d)
    jqr, tqr, v = _pair(envs, N, prec, rng)
    re, im = _elems(rng, N)
    ops = {}
    for mod, env in zip((jq, tq), envs):
        ops[mod] = op = mod.createDiagonalOp(N, env)
        mod.initDiagonalOp(op, re, im)
        mod.syncDiagonalOp(op)
    top = ops[tq]
    assert (top.shards is None) == (d == 1)
    np.testing.assert_array_equal(top.real, re)
    np.testing.assert_array_equal(top.imag, im)
    dg = re + 1j * im
    want = np.vdot(v, dg * v)
    for mod, q in ((jq, jqr), (tq, tqr)):
        np.testing.assert_allclose(mod.calcExpecDiagonalOp(q, ops[mod]), want, atol=tol)
    _both(lambda m, q: m.applyDiagonalOp(q, ops[m]), jqr, tqr)
    v = dg * v
    _check(jqr, tqr, v, tol)
    # a slice across the shard boundaries (at d = 4 and 8), in place
    sub_re, sub_im = np.arange(9.0, 0.0, -1), -np.arange(1.0, 10.0)
    for mod in (jq, tq):
        mod.setDiagonalOpElems(ops[mod], 28, sub_re, sub_im, 9)
    dg[28:37] = sub_re + 1j * sub_im
    np.testing.assert_array_equal(top.real + 1j * top.imag, dg)
    _both(lambda m, q: m.applyDiagonalOp(q, ops[m]), jqr, tqr)
    _check(jqr, tqr, dg * v, tol * 100)
    tq.destroyDiagonalOp(top, envs[1])
    with pytest.raises(tq.QuESTError, match="createDiagonalOperator"):
        tq.applyDiagonalOp(tqr, top)


def test_diagonal_op_mixed_layouts_and_density():
    """An op cut over 4 shards applied to a one-device register and to a
    register over 8; a one-device op on a density register (D rho, rows
    only) and its Tr(rho D)."""
    rng = np.random.RandomState(41)
    re, im = _elems(rng, N)
    dg = re + 1j * im
    op = tq.createDiagonalOp(N, _envs(4)[1])
    tq.initDiagonalOp(op, re, im)
    for d in (1, 8):
        q = tq.createQureg(N, _envs(d)[1], 2)
        v = oracle.random_statevec(N, rng)
        tq.initStateFromAmps(q, v.real, v.imag)
        np.testing.assert_allclose(tq.calcExpecDiagonalOp(q, op), np.vdot(v, dg * v),
                                   atol=1e-10)
        tq.applyDiagonalOp(q, op)
        _check(None, q, dg * v, 1e-10)
    envs = _envs(1)
    jqr, tqr, rho = _pair(envs, ND, 2, rng, density=True)
    re, im = _elems(rng, ND)
    jop, top = jq.createDiagonalOp(ND, envs[0]), tq.createDiagonalOp(ND, envs[1])
    jq.initDiagonalOp(jop, re, im)
    tq.initDiagonalOp(top, re, im)
    want = np.trace(np.diag(re + 1j * im) @ rho)
    np.testing.assert_allclose(tq.calcExpecDiagonalOp(tqr, top), want, atol=1e-10)
    np.testing.assert_allclose(tq.calcExpecDiagonalOp(tqr, top),
                               jq.calcExpecDiagonalOp(jqr, jop), atol=1e-10)
    _both(lambda m, q: m.applyDiagonalOp(q, jop if m is jq else top), jqr, tqr)
    _check(jqr, tqr, np.diag(re + 1j * im) @ rho, 1e-10)
    # the op's global precision is cast to the register's at apply time
    q32 = tq.createDensityQureg(ND, envs[1], 1)
    tq.initStateFromAmps(q32, *(lambda f: (f.real, f.imag))(rho.T.reshape(-1)))
    tq.applyDiagonalOp(q32, top)
    assert q32.dtype == torch.float32
    _check(None, q32, np.diag(re + 1j * im) @ rho, 2e-4)


@pytest.mark.parametrize("d", [1, 4])
def test_diagonal_op_from_pauli_hamil(tmp_path, d):
    envs = _envs(d)
    codes, coeffs = [[3, 0, 0, 0, 0, 3, 0], [3, 3, 0, 0, 3, 0, 3], [0] * 7], [0.5, -1.2, 0.9]
    want = np.diag(_pauli_sum_matrix(N, codes, coeffs)).real
    ops = []
    for mod, env in zip((jq, tq), envs):
        op = mod.createDiagonalOp(N, env)
        mod.initDiagonalOpFromPauliHamil(op, _hamil(mod, N, coeffs, codes))
        ops.append(op)
    np.testing.assert_array_equal(ops[1].real, np.asarray(ops[0].real))
    np.testing.assert_allclose(ops[1].real, want, atol=1e-14)
    assert not ops[1].imag.any()
    path = tmp_path / "hamil.txt"
    path.write_text("0.5 3 0 0 0 0 0 3\n-1.25 3 3 0 0 0 0 0\n")
    op = tq.createDiagonalOpFromPauliHamilFile(str(path), envs[1])
    jop = jq.createDiagonalOpFromPauliHamilFile(str(path), envs[0])
    np.testing.assert_array_equal(op.real, np.asarray(jop.real))
    bad = _hamil(tq, N, [1.0], [[1, 0, 0, 0, 0, 0, 0]])
    with pytest.raises(tq.QuESTError, match="PAULI_Z"):
        tq.initDiagonalOpFromPauliHamil(op, bad)


# ---------------------------------------------------------------------------
# sub-diagonal operators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec,d", CASES)
def test_sub_diagonal_op(prec, d):
    rng = np.random.RandomState(50 + d)
    jqr, tqr, v = _pair(_envs(d), N, prec, rng)
    for fn, targets in (("applySubDiagonalOp", (6, 1)), ("applyGateSubDiagonalOp", (0, 5, 3))):
        elems = rng.randn(1 << len(targets)) + 1j * rng.randn(1 << len(targets))
        for mod, q in ((jq, jqr), (tq, tqr)):
            op = mod.createSubDiagonalOp(len(targets))
            op.elems[...] = elems
            getattr(mod, fn)(q, list(targets), op)
        v = oracle.full_operator(N, targets, np.diag(elems)) @ v
        _check(jqr, tqr, v, TOLS[prec] * 10)


def test_sub_diagonal_op_density():
    rng = np.random.RandomState(55)
    jqr, tqr, rho = _pair(_envs(1), ND, 1, rng, density=True)
    for fn, targets, shadow in (("applySubDiagonalOp", (2, 0), False),
                                ("applyGateSubDiagonalOp", (1,), True)):
        elems = np.exp(1j * rng.randn(1 << len(targets)))
        for mod, q in ((jq, jqr), (tq, tqr)):
            op = mod.createSubDiagonalOp(len(targets))
            op.elems[...] = elems
            getattr(mod, fn)(q, list(targets), op)
        f = oracle.full_operator(ND, targets, np.diag(elems))
        rho = f @ rho @ f.conj().T if shadow else f @ rho
        _check(jqr, tqr, rho, 2e-4)


# ---------------------------------------------------------------------------
# the host mirror: copyState*GPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec,d", CASES)
def test_copy_state_host_mirror(prec, d):
    envs = _envs(d)
    rng = np.random.RandomState(60 + d)
    jqr, tqr, v = _pair(envs, N, prec, rng)
    got = tq.copyStateFromGPU(tqr)
    assert got is tqr.state_vec and got.dtype == (np.float32 if prec == 1 else np.float64)
    np.testing.assert_array_equal(got, np.asarray(jq.copyStateFromGPU(jqr)))
    # edit the mirror, push it back whole, then a substate across the
    # shard boundaries (at d = 4 and 8)
    for mod, q in ((jq, jqr), (tq, tqr)):
        q.state_vec[:, 5:9] = [[1, 2, 3, 4], [0, 0, -1, 0]]
        mod.copyStateToGPU(q)
        q.state_vec[:, 28:38] = 0.5
        mod.copySubstateToGPU(q, 28, 10)
    np.testing.assert_array_equal(state_to_numpy(tqr), np.asarray(jqr.amps))
    # only the range is pushed
    tqr.state_vec[:, 26:42] = -2.0
    tq.copySubstateToGPU(tqr, 30, 4)
    s = state_to_numpy(tqr)
    assert (s[:, 30:34] == -2).all() and (s[:, 28:30] == 0.5).all() and (s[:, 34:38] == 0.5).all()
    for mod, q in ((jq, jqr), (tq, tqr)):
        mod.pauliX(q, N - 1)
        mod.copySubstateFromGPU(q, 30, 20)
    np.testing.assert_array_equal(tqr.state_vec[:, 30:50], state_to_numpy(tqr)[:, 30:50])
    np.testing.assert_array_equal(tqr.state_vec[:, 30:50], np.asarray(jqr.amps)[:, 30:50])
    assert (tqr.state_vec[:, 26:30] == -2).all()  # outside the pulled range


def test_copy_state_density_round_trip():
    q = tq.createDensityQureg(ND, _envs(1)[1], 2)
    tq.initPlusState(q)
    mirror = tq.copyStateFromGPU(q)
    assert mirror.shape == (2, 1 << 2 * ND)
    mirror[1, 3] = 0.25
    tq.copyStateToGPU(q)
    assert tq.getDensityAmp(q, 3, 0) == complex(1 / 8, 0.25)


# ---------------------------------------------------------------------------
# validation messages and QASM text
# ---------------------------------------------------------------------------

def _setup(mod, env):
    q = mod.createQureg(5, env, 2)
    mod.initDebugState(q)
    rho = mod.createDensityQureg(2, env, 2)
    op = mod.createDiagonalOp(5, env)
    sub = mod.createSubDiagonalOp(2)
    h = mod.createPauliHamil(5, 1)
    mod.initPauliHamil(h, [1.0], [[1, 0, 0, 0, 0]])
    return dict(q=q, rho=rho, op=op, sub=sub, h=h, out=mod.createQureg(5, env, 2))


OPERATOR_ERRORS = [
    lambda m, s: m.applyPauliSum(s["q"], [0] * 4, [1.0], s["out"]),
    lambda m, s: m.applyPauliSum(s["q"], [0, 0, 0, 0, 5], [1.0], s["out"]),
    lambda m, s: m.applyPauliSum(s["q"], [0] * 5, [1.0], s["rho"]),
    lambda m, s: m.applyPauliHamil(s["q"], s["h"], m.createQureg(4, s["env"], 2)),
    lambda m, s: m.applyTrotterCircuit(s["q"], s["h"], 0.1, 3, 1),
    lambda m, s: m.applyTrotterCircuit(s["q"], s["h"], 0.1, 2, 0),
    lambda m, s: m.setQuregToPauliHamil(s["q"], s["h"]),
    lambda m, s: m.setQuregToPauliHamil(s["rho"], s["h"]),
    lambda m, s: m.applyQFT(s["q"], [1, 1]),
    lambda m, s: m.applyQFT(s["q"], [5]),
    lambda m, s: m.applyProjector(s["q"], 0, 2),
    lambda m, s: m.applyProjector(s["q"], -1, 0),
    lambda m, s: m.initDiagonalOp(s["op"], [1.0] * 3, [0.0] * 3),
    lambda m, s: m.setDiagonalOpElems(s["op"], 31, [1.0] * 3, [0.0] * 3, 3),
    lambda m, s: m.setDiagonalOpElems(s["op"], 32, [1.0], [0.0], 1),
    lambda m, s: m.applyDiagonalOp(s["rho"], s["op"]),
    lambda m, s: m.calcExpecDiagonalOp(s["rho"], s["op"]),
    lambda m, s: m.initDiagonalOpFromPauliHamil(s["op"], s["h"]),
    lambda m, s: m.initDiagonalOpFromPauliHamil(m.createDiagonalOp(4, s["env"]), s["h"]),
    lambda m, s: (m.destroyDiagonalOp(s["op"], s["env"]), m.applyDiagonalOp(s["q"], s["op"])),
    lambda m, s: m.createDiagonalOp(0, s["env"]),
    lambda m, s: m.applySubDiagonalOp(s["q"], [0, 1, 2], s["sub"]),
    lambda m, s: m.applyGateSubDiagonalOp(s["q"], [0, 0], s["sub"]),
    lambda m, s: m.copySubstateFromGPU(s["q"], 30, 3),
    lambda m, s: m.copySubstateToGPU(s["q"], -1, 2),
    lambda m, s: (m.destroyQureg(s["q"], s["env"]), m.copyStateFromGPU(s["q"])),
]


@pytest.mark.parametrize("i", range(len(OPERATOR_ERRORS)))
def test_operator_validation_matches_reference(i):
    msgs = []
    for mod, env in zip((jq, tq), _envs(1)):
        s = _setup(mod, env)
        s["env"] = env
        before = np.array(state_to_numpy(s["q"]) if mod is tq else s["q"].amps)
        with pytest.raises(mod.QuESTError) as e:
            OPERATOR_ERRORS[i](mod, s)
        msgs.append(str(e.value))
        if mod is tq and s["q"].amps is not None:
            np.testing.assert_array_equal(state_to_numpy(s["q"]), before)
    assert msgs[1] == msgs[0]


def test_diag_op_validators_match_reference():
    """The validators with no failing path through the rows above: the
    DiagonalOp's fit on a multi-host mesh and its allocation failure."""
    from quest_tpu import validation as JV
    from quest_tpu_torch import validation as TV

    msgs = []
    for V, err in ((JV, jq.QuESTError), (TV, tq.QuESTError)):
        with pytest.raises(err) as e:
            V.validate_diag_op_fits_devices(2, 8, "createDiagonalOp")
        msgs.append(str(e.value))

        def oom():
            raise MemoryError

        with pytest.raises(err) as e:
            V.validate_diag_op_allocation(oom, "createDiagonalOp")
        msgs.append(str(e.value))
    assert msgs[2:] == msgs[:2]


@pytest.mark.parametrize("prec", [1, 2])
def test_operator_qasm_matches_reference(prec):
    texts = []
    for mod, env in zip((jq, tq), _envs(1)):
        q, out = mod.createQureg(3, env, prec), mod.createQureg(3, env, prec)
        for x in (q, out):
            mod.startRecordingQASM(x)
        mod.hadamard(q, 0)
        mod.applyFullQFT(q)
        mod.applyQFT(q, [2, 0])
        h = mod.createPauliHamil(3, 2)
        mod.initPauliHamil(h, [0.5, -0.25], [[1, 0, 3], [0, 2, 1]])
        mod.applyTrotterCircuit(q, h, 0.125, 2, 3)
        mod.applyProjector(q, 2, 1)
        op = mod.createDiagonalOp(3, env)
        mod.initDiagonalOp(op, np.ones(8), np.zeros(8))
        mod.applyDiagonalOp(q, op)
        sub = mod.createSubDiagonalOp(1)
        sub.elems[...] = [1, 1j]
        mod.applySubDiagonalOp(q, [2], sub)
        mod.applyGateSubDiagonalOp(q, [1], sub)
        mod.applyPauliSum(q, [1, 0, 3], [0.5], out)
        mod.applyPauliHamil(q, h, out)
        mod.applyMatrix2(q, 0, np.eye(2))
        texts.append(q.qasm_log.printed() + out.qasm_log.printed())
    assert texts[1] == texts[0]
    assert "applyTrotterCircuit(t=0.125, order=2, reps=3)" in texts[1]


# ---------------------------------------------------------------------------
# QFT and Trotter tapes in fused gate runs
# ---------------------------------------------------------------------------

def _operator_tape(kind, n):
    jc = JCircuit(n)
    jc.hadamard(0)
    if kind == "qft":
        jc.applyFullQFT()
        jc.applyPhaseFunc([1, 0, 2], 0, [0.5, -0.1], [1.0, 2.0])
        jc.applyQFT([3, n - 1, 0, 6])
    else:
        h = jq.createPauliHamil(n, 3)
        jq.initPauliHamil(h, [0.4, -0.7, 0.2],
                          [[3, 3] + [0] * (n - 2), [1] * n, [0, 2, 1] + [0] * (n - 4) + [3]])
        jc.applyTrotterCircuit(h, 0.3, 2, 2)
        jc.applyNamedPhaseFunc([0, 1, n - 2, n - 1], [2, 2], 0, jq.phaseFunc.DISTANCE)
        jc.applyTrotterCircuit(h, -0.1, 1, 1)
    return jc


@pytest.mark.parametrize("kind,n,tb", [("qft", 10, 9), ("trotter", 9, 8)])
def test_operator_tape_fuses_as_reference(kind, n, tb):
    """The QFT and Trotter entries spy-capture into gate events (they are
    no barriers) and plan, at tile bits ``tb``, into the JAX package's
    fused runs; the phase-function entry is the one barrier in both. The
    port's plan runs through the fused-run kernel's plain version and
    agrees with the JAX fused run (Pallas interpreter) and the per-gate
    replay."""
    jc = _operator_tape(kind, n)
    tc = circuit_from_tape(jc._tape, n)
    for (jf, ja, jk), (tf, ta, tk) in zip(jc._tape, tc._tape):
        jev = JF.capture(jf, ja, jk, n, np.float64)
        tev = F.capture(tf, ta, tk, n, torch.float64)
        assert (tev is None) == (jev is None) == ("PhaseFunc" in tf.__name__)
        if tev is not None:
            assert [(e.kind, e.targets, e.controls) for e in tev] == \
                [(e.kind, e.targets, e.controls) for e in jev]
    ref = JF._plan_pallas(tuple(jc._tape), n, np.float64, 5, tb)
    fz = tc.fused(max_qubits=5, pallas=True, dtype=torch.float64, tile_bits=tb)
    got = F._plan_pallas(tuple(tc._tape), n, torch.float64, 5, tb)
    assert_plans_equal(ref, got)
    assert got.num_barriers == 1 and sum(f is F._apply_pallas_run for f, _, _ in fz._tape) \
        == sum(isinstance(i, F.PallasRun) for i in got.items) > 1
    jenv, tenv = _envs(1)
    jqr, tqr, v = _pair((jenv, tenv), n, 2, np.random.RandomState(n))
    for f, a, kw in JF.as_tape(ref):
        f(jqr, *a, **kw)
    fz.run(tqr)
    replay = tq.createQureg(n, tenv, 2)
    tq.initStateFromAmps(replay, v.real, v.imag)
    tc.run(replay)
    scale = np.abs(_vec(replay)).max()
    _check(jqr, tqr, _vec(replay), 1e-10 * scale)
    if kind == "qft":  # against the oracle too
        want = oracle.full_operator(n, (3, n - 1, 0, 6), _dft(4)) @ (
            np.exp(1j * (0.5 * np.arange(8) - 0.1 * np.arange(8) ** 2))[
                ((np.arange(1 << n) >> 1) & 1) | (((np.arange(1 << n)) & 1) << 1)
                | (((np.arange(1 << n) >> 2) & 1) << 2)]
            * (_dft(n) @ (oracle.full_operator(n, (0,), np.array([[1, 1], [1, -1]]) /
                                                np.sqrt(2)) @ v)))
        _check(None, tqr, want, 1e-10 * scale)
