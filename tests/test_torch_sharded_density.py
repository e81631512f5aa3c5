"""Density matrices over shards: quest_tpu_torch's density register on a
mesh of virtual CPU shards against quest_tpu on the same number of its
emulated CPU devices and the dense numpy oracle (tests/oracle.py).

A density register of n qubits is a 2n-qubit flattened state, row bits
low and column bits high, cut over its D shards by its top qubits: column
qubits, so every shadow gate and every channel (qubits t + n) reaches the
sharded zone. Port registers live on ``createQuESTEnv(devices=["cpu"] *
d)``, quest_tpu's on d of its 8 CPU devices; inputs are made with numpy
from a seed and fed to both. Tolerances (tests/helpers.py): 1e-10 in f64,
2e-4 in f32 (of the largest amplitude).
"""

import jax
import numpy as np
import pytest
import torch

import quest_tpu as jq
import quest_tpu_torch as tq
from quest_tpu import fusion as JF
from quest_tpu.circuits import Circuit as JCircuit
from quest_tpu.ops import pallas_gates as PG
from quest_tpu_torch import _capture, channels as CH, fusion as F, telemetry
from quest_tpu_torch.interop import circuit_from_tape, state_to_numpy
from quest_tpu_torch.ops import density as DN
from quest_tpu_torch.ops import fused_gates as FG

from . import oracle
from .test_torch_fusion import _density_tape, assert_plans_equal

TOL = 1e-10
F32_TOL = 2e-4
PRECISIONS = [(2, TOL), (1, F32_TOL)]


def _envs(d):
    return jq.createQuESTEnv(jax.devices()[:d]), tq.createQuESTEnv(devices=["cpu"] * d)


def _pair(n, d, precision=2):
    jenv, tenv = _envs(d)
    return (jq.createDensityQureg(n, jenv, precision),
            tq.createDensityQureg(n, tenv, precision))


def _close(tqr, ref, tol=TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(state_to_numpy(tqr), ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1.0))


def _rho(qureg) -> np.ndarray:
    """The register's rho as a (2^n, 2^n) complex matrix (flat [col, row])."""
    n = qureg.num_qubits_represented
    s = state_to_numpy(qureg)
    return (s[0] + 1j * s[1]).reshape(1 << n, 1 << n).T


def _flat(rho) -> np.ndarray:
    """A (2^n, 2^n) rho as the planar flat state."""
    f = np.asarray(rho).T.reshape(-1)
    return np.stack([f.real, f.imag])


def _random_rho(n, seed):
    return oracle.random_density(n, np.random.RandomState(seed))


def _load(jqr, tqr, rho):
    f = np.asarray(rho).T.reshape(-1)
    jq.initStateFromAmps(jqr, f.real, f.imag)
    tq.initStateFromAmps(tqr, f.real, f.imag)


def _both(jqr, tqr, name, *args):
    getattr(jq, name)(jqr, *args)
    getattr(tq, name)(tqr, *args)


# ---------------------------------------------------------------------------
# registers and initialisation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [4, 8])
def test_density_register_layout_and_inits_match_reference(d):
    """A 4-qubit density register on d shards: every shard (2, 2^(8 - log2 d)),
    as quest_tpu's sharded array; every init equal to quest_tpu's, and
    createCloneQureg a new set of shards."""
    n = 4
    jqr, tqr = _pair(n, d)
    assert tqr.amps is None and len(tqr.shards) == d
    assert all(s.shape == (2, 1 << (2 * n - (d - 1).bit_length())) for s in tqr.shards)
    assert len(jqr.amps.sharding.device_set) == d
    _close(tqr, jqr.amps, 0.0)
    for name, args in (("initPlusState", ()), ("initClassicalState", (11,)),
                       ("initDebugState", ()), ("initBlankState", ()), ("initZeroState", ()),
                       ("setDensityAmps", (3, 5, np.arange(40) / 7, -np.arange(40) / 9, 40))):
        _both(jqr, tqr, name, *args)
        _close(tqr, jqr.amps, 1e-15)
    clone = tq.createCloneQureg(tqr, tqr.env)
    assert len(clone.shards) == d and clone.shards[0] is not tqr.shards[0]
    _close(clone, jqr.amps, 0.0)


@pytest.mark.parametrize("d,dpure", [(4, 4), (8, 4), (4, 1), (8, 8)])
def test_init_pure_state_from_any_layout(d, dpure):
    """initPureState of a sharded density register from a state vector on
    ``dpure`` shards (1: one device) equals quest_tpu's and |psi><psi|."""
    n = 4
    jqr, tqr = _pair(n, d)
    jenv, tenv = _envs(dpure)
    if dpure == 1:
        tenv = tq.createQuESTEnv(device="cpu")
    jpsi, tpsi = jq.createQureg(n, jenv, 2), tq.createQureg(n, tenv, 2)
    v = oracle.random_statevec(n, np.random.RandomState(d + dpure))
    jq.initStateFromAmps(jpsi, v.real, v.imag)
    tq.initStateFromAmps(tpsi, v.real, v.imag)
    jq.initPureState(jqr, jpsi)
    tq.initPureState(tqr, tpsi)
    _close(tqr, jqr.amps)
    np.testing.assert_allclose(_rho(tqr), np.outer(v, v.conj()), atol=TOL)
    # a one-device density register from a sharded state
    one = tq.createDensityQureg(n, tq.createQuESTEnv(device="cpu"), 2)
    tq.initPureState(one, tpsi)
    np.testing.assert_allclose(_rho(one), np.outer(v, v.conj()), atol=TOL)


def _density_reg(n, d, precision=2):
    """(quest_tpu, port) density registers on d devices (1: one device)."""
    if d == 1:
        return (jq.createDensityQureg(n, jq.createQuESTEnv(jax.devices()[:1]), precision),
                tq.createDensityQureg(n, tq.createQuESTEnv(device="cpu"), precision))
    return _pair(n, d, precision)


@pytest.mark.parametrize("d1,d2", [(4, 1), (1, 8), (4, 8)])
def test_mix_clone_and_weighted_sum_across_layouts(d1, d2):
    """mixDensityMatrix, setWeightedQureg and cloneQureg between density
    registers of two layouts (1: one device) against the numpy products
    and, where quest_tpu joins arrays of those two shardings (one of them
    on one device), against quest_tpu."""
    n = 4
    (ja, ta), (jb, tb) = _density_reg(n, d1), _density_reg(n, d2)
    a, b = _random_rho(n, 1), _random_rho(n, 2)
    _load(ja, ta, a)
    _load(jb, tb, b)
    with_ref = 1 in (d1, d2)
    tq.mixDensityMatrix(ta, 0.3, tb)
    a = 0.7 * a + 0.3 * b
    np.testing.assert_allclose(_rho(ta), a, atol=TOL)
    tq.setWeightedQureg(0.5 + 0.1j, ta, -0.25j, tb, 0.75, tb)
    b = (0.5 + 0.1j) * a - 0.25j * b + 0.75 * b
    np.testing.assert_allclose(_rho(tb), b, atol=TOL)
    tq.cloneQureg(ta, tb)
    np.testing.assert_allclose(_rho(ta), b, atol=0)
    if with_ref:
        jq.mixDensityMatrix(ja, 0.3, jb)
        jq.setWeightedQureg(0.5 + 0.1j, ja, -0.25j, jb, 0.75, jb)
        jq.cloneQureg(ja, jb)
        _close(tb, jb.amps)
        _close(ta, ja.amps)


# ---------------------------------------------------------------------------
# shadow gates and channels on the per-gate engine over shards
# ---------------------------------------------------------------------------

def _gate_suite(n, rng):
    """Every gate class, targets and controls in the local and sharded
    zones: (name, args, oracle (targets, matrix, controls, states) or None)."""
    u2 = oracle.random_unitary(1, rng)
    u4 = oracle.random_unitary(2, rng)
    u8 = oracle.random_unitary(3, rng)
    h = np.array([[1, 1], [1, -1]]) / np.sqrt(2)
    x = np.array([[0, 1], [1, 0]])
    swap = np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]])

    def rz(a):
        return np.diag([np.exp(-0.5j * a), np.exp(0.5j * a)])

    # exp(-i theta/2 Z Z) at theta = -0.7
    zz = np.diag([np.exp(0.35j), np.exp(-0.35j), np.exp(-0.35j), np.exp(0.35j)])
    a, b = (1 + 1j) / 2, (1 - 1j) / 2
    sqrt_swap = np.array([[1, 0, 0, 0], [0, a, b, 0], [0, b, a, 0], [0, 0, 0, 1]])
    axis = (0.3, -0.5, 0.8)
    nx, ny, nz = np.asarray(axis) / np.linalg.norm(axis)
    sigma = nx * x + ny * np.array([[0, -1j], [1j, 0]]) + nz * np.diag([1, -1])
    around = np.cos(0.45) * np.eye(2) - 1j * np.sin(0.45) * sigma
    return [
        ("hadamard", (n - 1,), ((n - 1,), h, (), ())),
        ("controlledNot", (n - 1, 0), ((0,), x, (n - 1,), (1,))),
        ("controlledNot", (0, n - 1), ((n - 1,), x, (0,), (1,))),
        ("unitary", (n - 2, u2), ((n - 2,), u2, (), ())),
        ("controlledUnitary", (n - 1, 1, u2), ((1,), u2, (n - 1,), (1,))),
        ("multiStateControlledUnitary", ([n - 1, 0], [0, 1], 2, u2),
         ((2,), u2, (n - 1, 0), (0, 1))),
        ("twoQubitUnitary", (0, n - 1, u4), ((0, n - 1), u4, (), ())),
        ("multiQubitUnitary", ([n - 1, 0, n - 2], u8), ((n - 1, 0, n - 2), u8, (), ())),
        ("multiControlledMultiQubitUnitary", ([n - 2], [n - 1, 1], u4),
         ((n - 1, 1), u4, (n - 2,), (1,))),
        ("rotateZ", (n - 1, 0.31), ((n - 1,), rz(0.31), (), ())),
        ("multiControlledPhaseFlip", (list(range(n)),),
         (tuple(range(n)), np.diag([1] * ((1 << n) - 1) + [-1]), (), ())),
        ("multiRotateZ", ([0, n - 1], -0.7), ((0, n - 1), zz, (), ())),
        ("swapGate", (0, 1), ((0, 1), swap, (), ())),
        ("swapGate", (1, n - 1), ((1, n - 1), swap, (), ())),
        ("swapGate", (n - 2, n - 1), ((n - 2, n - 1), swap, (), ())),
        ("multiQubitNot", ([0, n - 1], ), ((0, n - 1), np.kron(x, x), (), ())),
        ("pauliY", (n - 1,), ((n - 1,), np.array([[0, -1j], [1j, 0]]), (), ())),
        ("tGate", (n - 2,), ((n - 2,), np.diag([1, np.exp(0.25j * np.pi)]), (), ())),
        ("multiRotatePauli", ([0, n - 2, n - 1], [1, 2, 3], 0.4),
         (tuple(range(n)), np.cos(0.2) * np.eye(1 << n) - 1j * np.sin(0.2)
          * oracle.pauli_product_matrix(n, [0, n - 2, n - 1], [1, 2, 3]), (), ())),
        ("sqrtSwapGate", (0, n - 1), ((0, n - 1), sqrt_swap, (), ())),
        ("rotateAroundAxis", (n - 1, 0.9, axis), ((n - 1,), around, (), ())),
        ("controlledPhaseShift", (0, n - 1, 0.23),
         ((0, n - 1), np.diag([1, 1, 1, np.exp(0.23j)]), (), ())),
    ]


@pytest.mark.parametrize("precision,tol", PRECISIONS)
@pytest.mark.parametrize("d", [4, 8])
def test_shadow_gates_match_reference(d, precision, tol):
    """Every gate class on a 4-qubit density register over d shards (row
    and column qubits in both zones; the shadow on q + n always sharded),
    against quest_tpu on d devices and the oracle's U rho U^dagger."""
    n = 4
    jqr, tqr = _pair(n, d, precision)
    rho = _random_rho(n, d)
    _load(jqr, tqr, rho)
    for name, args, (targets, m, controls, states) in _gate_suite(n, np.random.RandomState(d)):
        _both(jqr, tqr, name, *args)
        rho = oracle.apply_to_density(rho, n, targets, m, controls=controls,
                                      control_states=states or None)
    _close(tqr, jqr.amps, tol)
    np.testing.assert_allclose(_rho(tqr), rho, atol=tol * 10)


def _channel_suite(n, rng):
    """Every mix* channel, targets in both zones (their column qubits t + n
    local and sharded): (name, args, Kraus operators on the targets or
    None), as ``tests/test_parallel.py``'s suite."""
    k = 1 / np.sqrt(2)
    kraus1 = [np.array([[k, 0], [0, k]]), np.array([[0, k], [k, 0]])]
    u4 = oracle.random_unitary(2, rng)
    kraus2 = [u4 * 0.8, 1j * 0.6 * u4]
    z = np.diag([1.0, -1.0])
    deph1 = lambda p: [np.sqrt(1 - p) * np.eye(2), np.sqrt(p) * z]  # noqa: E731
    zz = [np.eye(4), np.kron(np.eye(2), z), np.kron(z, np.eye(2)), np.kron(z, z)]
    return [
        ("mixDephasing", (0, 0.12), (0,), deph1(0.12)),
        ("mixDephasing", (n - 1, 0.2), (n - 1,), deph1(0.2)),
        ("mixTwoQubitDephasing", (0, n - 1, 0.15), (0, n - 1),
         [np.sqrt(1 - 0.15) * zz[0]] + [np.sqrt(0.05) * m for m in zz[1:]]),
        ("mixDepolarising", (0, 0.1), (0,), CH.depolarising_kraus(0.1)),
        ("mixDepolarising", (n - 1, 0.25), (n - 1,), CH.depolarising_kraus(0.25)),
        ("mixDamping", (1, 0.3), (1,), CH.damping_kraus(0.3)),
        ("mixDamping", (n - 1, 0.17), (n - 1,), CH.damping_kraus(0.17)),
        ("mixTwoQubitDepolarising", (0, n - 1, 0.2), (0, n - 1),
         CH.two_qubit_depolarising_kraus(0.2)),
        ("mixTwoQubitDepolarising", (n - 2, n - 1, 0.3), (n - 2, n - 1),
         CH.two_qubit_depolarising_kraus(0.3)),
        ("mixPauli", (n - 1, 0.05, 0.1, 0.15), (n - 1,), CH.pauli_kraus(0.05, 0.1, 0.15)),
        ("mixKrausMap", (1, kraus1), (1,), kraus1),
        ("mixKrausMap", (n - 1, kraus1), (n - 1,), kraus1),
        ("mixTwoQubitKrausMap", (n - 2, n - 1, kraus2), (n - 2, n - 1), kraus2),
        ("mixMultiQubitKrausMap", ([n - 1, 0, 2], [np.eye(8)]), (n - 1, 0, 2), [np.eye(8)]),
        ("mixNonTPKrausMap", (n - 1, [0.9 * np.eye(2)]), (n - 1,), [0.9 * np.eye(2)]),
    ]


@pytest.mark.parametrize("precision,tol", PRECISIONS)
@pytest.mark.parametrize("d", [4, 8])
def test_channels_match_reference(d, precision, tol):
    """Every mix* channel on a 4-qubit density register over d shards
    (column qubits 1-3 sharded on 8 shards, 2-3 on 4), against quest_tpu
    on d devices and the oracle's Kraus sums; the sharded channels took
    the engine's exchanges."""
    n = 4
    jqr, tqr = _pair(n, d, precision)
    rho = _random_rho(n, 10 + d)
    _load(jqr, tqr, rho)
    telemetry.reset()
    for name, args, targets, kraus in _channel_suite(n, np.random.RandomState(5)):
        _both(jqr, tqr, name, *args)
        rho = oracle.apply_kraus_to_density(rho, n, targets, kraus)
    _close(tqr, jqr.amps, tol)
    np.testing.assert_allclose(_rho(tqr), rho, atol=tol * 10)
    assert telemetry.counter_value("channel_route_total", route="superop") > 0
    assert (telemetry.counter_value("exchange_calls_total", kind="swap_odd_parity")
            + telemetry.counter_value("exchange_calls_total", kind="pair_exchange")) > 0
    assert abs(tq.calcTotalProb(tqr) - jq.calcTotalProb(jqr)) < tol


@pytest.mark.parametrize("precision,tol", PRECISIONS)
def test_channel_kernel_route_relocates_sharded_column_qubits(monkeypatch, precision, tol):
    """Above the superoperator limit (lowered here to 6 flattened qubits) a
    1-target channel runs as one kraus1 pass per shard (the fused-run
    kernel's plain version on the CPU); a target whose column qubit is
    sharded is moved into a local slot and back by two collective
    permutes. Against quest_tpu on 4 devices and the oracle."""
    monkeypatch.setattr(DN, "_SUPEROP_MAX_QUBITS", 6)
    n, d = 5, 4  # 10 flattened qubits, 8 local: column qubits 8, 9 sharded
    jqr, tqr = _pair(n, d, precision)
    rho = _random_rho(n, 3)
    _load(jqr, tqr, rho)
    telemetry.reset()
    for t in range(n):
        _both(jqr, tqr, "mixDamping", t, 0.1 + 0.05 * t)
        rho = oracle.apply_kraus_to_density(rho, n, (t,), CH.damping_kraus(0.1 + 0.05 * t))
    _both(jqr, tqr, "mixTwoQubitDepolarising", 1, n - 1, 0.2)
    rho = oracle.apply_kraus_to_density(rho, n, (1, n - 1), CH.two_qubit_depolarising_kraus(0.2))
    _close(tqr, jqr.amps, tol)
    np.testing.assert_allclose(_rho(tqr), rho, atol=tol * 10)
    assert telemetry.counter_value("channel_route_total", route="kernel") == n
    assert telemetry.counter_value("channel_route_total", route="engine") == 1
    # targets 3 and 4: column qubits 8 and 9, moved there and back
    assert telemetry.counter_value("exchange_calls_total", kind="grouped_permute") == 4
    assert telemetry.counter_value("pallas_pass_total", kind="fused_run") >= n * d


@pytest.mark.parametrize("d", [4, 8])
def test_measurement_and_collapse_match_reference(d):
    """Seeded measurements and collapses of row qubits on a sharded density
    register: the same outcomes and probabilities as quest_tpu, the same
    states after."""
    n = 4
    jqr, tqr = _pair(n, d)
    rho = _random_rho(n, 20 + d)
    _load(jqr, tqr, rho)
    jq.seedQuEST(jqr.env, [5, 9])
    tq.seedQuEST(tqr.env, [5, 9])
    for q in (n - 1, 0, 2, n - 1):
        jo, jp = jq.measureWithStats(jqr, q)
        to, tp = tq.measureWithStats(tqr, q)
        assert to == jo and abs(tp - jp) < TOL
        _close(tqr, jqr.amps)
    _load(jqr, tqr, rho)
    for q, o in ((n - 1, 1), (1, 0)):
        assert abs(tq.collapseToOutcome(tqr, q, o) - jq.collapseToOutcome(jqr, q, o)) < TOL
        _close(tqr, jqr.amps)


# ---------------------------------------------------------------------------
# readouts and operators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision,tol", PRECISIONS)
@pytest.mark.parametrize("d", [4, 8])
def test_readouts_match_reference(d, precision, tol):
    """The readouts of a sharded density register: trace, purity, fidelity
    (pure state sharded and on one device), outcome probabilities (unsorted
    targets), Pauli products (the workspace too) and sums, inner products
    and distances with a register of another layout, density amplitudes,
    diagonal expectation values; against quest_tpu and the oracle."""
    n = 4
    jqr, tqr = _pair(n, d, precision)
    rho = _random_rho(n, 30 + d)
    _load(jqr, tqr, rho)
    jone = jq.createDensityQureg(n, jq.createQuESTEnv(jax.devices()[:1]), precision)
    tone = tq.createDensityQureg(n, tq.createQuESTEnv(device="cpu"), precision)
    sigma = _random_rho(n, 31 + d)
    _load(jone, tone, sigma)

    def same(tv, jv, ov):
        assert abs(tv - jv) < tol and abs(tv - ov) < tol, (tv, jv, ov)

    same(tq.calcTotalProb(tqr), jq.calcTotalProb(jqr), np.trace(rho).real)
    same(tq.calcPurity(tqr), jq.calcPurity(jqr), np.trace(rho @ rho).real)
    v = oracle.random_statevec(n, np.random.RandomState(d))
    for dp in (d, 1):
        jenv, tenv = _envs(dp) if dp > 1 else (jq.createQuESTEnv(jax.devices()[:1]),
                                               tq.createQuESTEnv(device="cpu"))
        jp, tp = jq.createQureg(n, jenv, precision), tq.createQureg(n, tenv, precision)
        jq.initStateFromAmps(jp, v.real, v.imag)
        tq.initStateFromAmps(tp, v.real, v.imag)
        same(tq.calcFidelity(tqr, tp), jq.calcFidelity(jqr, jp), (v.conj() @ rho @ v).real)
    diag = np.diag(rho).real
    for q in range(n):
        for o in (0, 1):
            same(tq.calcProbOfOutcome(tqr, q, o), jq.calcProbOfOutcome(jqr, q, o),
                 diag[((np.arange(1 << n) >> q) & 1) == o].sum())
    targets = [n - 1, 0, 2]
    np.testing.assert_allclose(tq.calcProbOfAllOutcomes(tqr, targets),
                               np.asarray(jq.calcProbOfAllOutcomes(jqr, targets)), atol=tol)
    same(tq.calcDensityInnerProduct(tqr, tone), jq.calcDensityInnerProduct(jqr, jone),
         np.trace(rho.conj().T @ sigma).real)
    same(tq.calcHilbertSchmidtDistance(tqr, tone), jq.calcHilbertSchmidtDistance(jqr, jone),
         np.sqrt(np.sum(np.abs(rho - sigma) ** 2)))
    for row, col in ((0, 0), (3, 11), (15, 2), (9, 14)):
        t = tq.getDensityAmp(tqr, row, col)
        assert abs(t - rho[row, col]) < tol and abs(t - jq.getDensityAmp(jqr, row, col)) < tol
    jw, tw = _pair(n, d, precision)
    codes = [3, 0, 1, 2]
    same(tq.calcExpecPauliProd(tqr, [0, 1, 2, 3], codes, tw),
         jq.calcExpecPauliProd(jqr, [0, 1, 2, 3], codes, jw),
         np.trace(oracle.pauli_product_matrix(n, [0, 1, 2, 3], codes) @ rho).real)
    _close(tw, jw.amps, tol)
    all_codes = [1, 0, 0, 3, 2, 2, 0, 0, 0, 3, 3, 1]
    coeffs = [0.4, -1.3, 0.7]
    same(tq.calcExpecPauliSum(tqr, all_codes, coeffs, tw),
         jq.calcExpecPauliSum(jqr, all_codes, coeffs, jw),
         sum(c * np.trace(oracle.pauli_product_matrix(n, range(n), all_codes[4 * t:4 * t + 4])
                          @ rho).real for t, c in enumerate(coeffs)))
    jenv, tenv = _envs(d)
    jop, top = jq.createDiagonalOp(n, jenv), tq.createDiagonalOp(n, tenv)
    re, im = np.linspace(-1, 1, 1 << n), np.linspace(0.5, -0.2, 1 << n)
    jq.initDiagonalOp(jop, re, im)
    tq.initDiagonalOp(top, re, im)
    te, je = tq.calcExpecDiagonalOp(tqr, top), jq.calcExpecDiagonalOp(jqr, jop)
    same(te, je, np.sum(np.diag(rho) * (re + 1j * im)))


@pytest.mark.parametrize("precision,tol", PRECISIONS)
@pytest.mark.parametrize("d", [4, 8])
def test_operators_match_reference(d, precision, tol):
    """The operators on a sharded density register: DiagonalOp, phase
    functions (their shadow on the sharded column qubits), projectors,
    sub-diagonal operators, matrices on the left and as gates, Pauli sums
    into a register of another layout, Trotter, setQuregToPauliHamil;
    against quest_tpu on d devices."""
    n = 4
    jqr, tqr = _pair(n, d, precision)
    _load(jqr, tqr, _random_rho(n, 40 + d))
    jenv, tenv = _envs(d)
    jop, top = jq.createDiagonalOp(n, jenv), tq.createDiagonalOp(n, tenv)
    ph = np.linspace(0, 2, 1 << n)
    jq.initDiagonalOp(jop, np.cos(ph), np.sin(ph))
    tq.initDiagonalOp(top, np.cos(ph), np.sin(ph))
    jq.applyDiagonalOp(jqr, jop)
    tq.applyDiagonalOp(tqr, top)
    _close(tqr, jqr.amps, tol)
    _both(jqr, tqr, "applyPhaseFunc", [0, n - 1], 0, [0.5, -1.2], [1.0, 2.0])
    _both(jqr, tqr, "applyNamedPhaseFunc", [0, 1, 2, 3], [2, 2], 0, 0)  # NORM
    _both(jqr, tqr, "applyProjector", n - 1, 1)
    _both(jqr, tqr, "applyProjector", 0, 0)
    _close(tqr, jqr.amps, tol)
    _load(jqr, tqr, _random_rho(n, 41 + d))
    rng = np.random.RandomState(d)
    u4 = oracle.random_unitary(2, rng)
    m4 = rng.randn(4, 4) + 1j * rng.randn(4, 4)
    _both(jqr, tqr, "applyGateMatrixN", [1, n - 1], u4)
    _both(jqr, tqr, "applyMatrixN", [n - 1, 0], m4)
    _both(jqr, tqr, "applyMultiControlledMatrixN", [n - 1], [1], m4[:2, :2])
    sub, tsub = jq.createSubDiagonalOp(2), tq.createSubDiagonalOp(2)
    sub.elems[:] = tsub.elems[:] = np.exp(1j * np.array([0.1, 0.2, -0.3, 0.7]))
    jq.applyGateSubDiagonalOp(jqr, [0, n - 1], sub)
    tq.applyGateSubDiagonalOp(tqr, [0, n - 1], tsub)
    jq.applySubDiagonalOp(jqr, [n - 1, 2], sub)
    tq.applySubDiagonalOp(tqr, [n - 1, 2], tsub)
    _close(tqr, jqr.amps, tol)
    codes = [3, 1, 0, 2, 0, 0, 3, 3]
    coeffs = [0.6, -0.45]
    jo, to = jq.createDensityQureg(n, jq.createQuESTEnv(jax.devices()[:1]), precision), \
        tq.createDensityQureg(n, tq.createQuESTEnv(device="cpu"), precision)
    jq.applyPauliSum(jqr, codes, coeffs, jo)
    tq.applyPauliSum(tqr, codes, coeffs, to)
    _close(to, jo.amps, tol)
    jh, th = jq.createPauliHamil(n, 2), tq.createPauliHamil(n, 2)
    jq.initPauliHamil(jh, coeffs, codes)
    tq.initPauliHamil(th, coeffs, codes)
    jq.applyTrotterCircuit(jqr, jh, 0.7, 2, 2)
    tq.applyTrotterCircuit(tqr, th, 0.7, 2, 2)
    _close(tqr, jqr.amps, tol)
    jq.setQuregToPauliHamil(jqr, jh)
    tq.setQuregToPauliHamil(tqr, th)
    _close(tqr, jqr.amps, tol)


# ---------------------------------------------------------------------------
# fused density plans over shards, Circuit.run and compiled replays
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["r4", "layers+channels"])
@pytest.mark.parametrize("d", [4, 8])
def test_fused_sharded_density_plan_equals_reference(d, kind):
    """``Circuit.fused(pallas=True, shard_devices=d)`` on a 5-qubit density
    tape (the bench's r4 channel circuit; random layers with every channel
    kind) at a pinned tile equals quest_tpu's ``plan_pallas_sharded(...,
    is_density=True)`` item for item, and runs on a register over d shards
    equal to quest_tpu's sharded run of its own plan and to the per-gate
    replay: per-shard kernel passes on 4 shards (no engine fallback, kraus
    ops in the runs), the engine over shards on 8 (shards below two lane
    rows)."""
    n = 5
    jc = _density_tape(kind, n)
    tc = circuit_from_tape(jc._tape, n, True)
    n_local = 2 * n - (d - 1).bit_length()
    tb = PG.local_qubits(n_local, sublanes=4)
    ref = JF.plan_pallas_sharded(tuple(jc._tape), n, np.float64, 4, tb, n_local,
                                 is_density=True)
    got = F.plan_pallas_sharded(tuple(tc._tape), n, torch.float64, 4, tb, n_local,
                                is_density=True)
    assert_plans_equal(ref, got)
    assert F.transpose_stats(got, n_local) == JF.transpose_stats(ref, n_local)
    fz = tc.fused(max_qubits=4, pallas=True, shard_devices=d, tile_bits=tb,
                  dtype=torch.float64)
    jqr, tqr = _pair(n, d)
    rho = _random_rho(n, 50 + d)
    _load(jqr, tqr, rho)
    eager = tq.createDensityQureg(n, tqr.env, 2)
    tq.initStateFromAmps(eager, *_flat(rho))
    telemetry.reset()
    fz.run(tqr)
    runs = sum(1 for f, a, _ in fz._tape if f is F._apply_pallas_run)
    if d == 4:
        assert telemetry.counter_total("engine_fallback_total") == 0
        assert telemetry.counter_value("pallas_pass_total", kind="fused_run") == runs * d
        if kind == "r4":
            assert any(op[0] in FG._KRAUS for f, a, _ in fz._tape
                       if f is F._apply_pallas_run for op in a[0].ops)
    else:
        assert telemetry.counter_value("engine_fallback_total",
                                       reason="shard_map_unsupported") == runs
    jc.fused(max_qubits=4, pallas=True, shard_devices=d).run(jqr)
    tc.run(eager)
    _close(tqr, jqr.amps)
    _close(tqr, state_to_numpy(eager))


@pytest.mark.parametrize("d", [4, 8])
def test_circuit_run_and_compiled_replays_on_sharded_density(d):
    """A density tape with gates and channels in both zones through
    ``Circuit.run``, ``compiled()`` (the eager replay, then a rehearsed
    capture) and ``compiled_segments``, on a register over d shards:
    equal to quest_tpu's sharded run and to each other."""
    n = 4
    jc = JCircuit(n, is_density_matrix=True)
    rng = np.random.RandomState(d)
    for name, args, _ in _gate_suite(n, rng)[:12]:
        getattr(jc, name)(*args)
    for name, args, _, _ in _channel_suite(n, rng)[::2]:
        getattr(jc, name)(*args)
    tc = circuit_from_tape(jc._tape, n, True)
    rho = _random_rho(n, 60 + d)
    jqr, tqr = _pair(n, d)
    _load(jqr, tqr, rho)
    jc.run(jqr)
    tc.run(tqr)
    _close(tqr, jqr.amps)
    fn = tc.compiled()
    for rehearse in (False, True):
        q = tq.createDensityQureg(n, tqr.env, 2)
        tq.initStateFromAmps(q, *_flat(rho))
        if rehearse:
            with _capture.rehearsal():
                fn.run_register(q)
        else:
            fn.run_register(q)
        _close(q, jqr.amps)
    q = tq.createDensityQureg(n, tqr.env, 2)
    tq.initStateFromAmps(q, *_flat(rho))
    tc.compiled_segments(max_items=5).run_register(q)
    _close(q, jqr.amps)


# ---------------------------------------------------------------------------
# what stays refused
# ---------------------------------------------------------------------------

def test_refused_entries_raise_typed_errors():
    """The entries that refuse a density register by design, on any layout
    as in quest_tpu, refuse one over shards with a QuESTError naming why,
    and leave the register as it was. (The Engine, ``EnginePool.submit``,
    ``sampleQureg`` and ``applyMidMeasurement`` serve it:
    tests/test_torch_sharded_sampling.py.)"""
    n = 4
    _, tenv = _envs(4)
    q = tq.createDensityQureg(n, tenv, 2)
    tq.initDebugState(q)
    before = state_to_numpy(q).copy()
    c = tq.Circuit(n, is_density_matrix=True)
    c.hadamard(0)
    c.mixDephasing(1, 0.1)
    # entry -> (the call, what its message names): by design on any density
    # register, as in quest_tpu
    refused = {
        "applyTrajectoryKraus": (lambda: tq.applyTrajectoryKraus(
            q, [0], [np.eye(2)], seed=1, site=0), "pure states"),
        "calcGradExpecPauliSum": (lambda: tq.calcGradExpecPauliSum(
            q, c, [3, 0, 0, 0], [1.0]), "state-vector register"),
    }
    for name, (call, why) in refused.items():
        with pytest.raises(tq.QuESTError) as err:
            call()
        assert why in str(err.value), (name, str(err.value))
    np.testing.assert_array_equal(state_to_numpy(q), before)
