"""The port's phase-function rows (quest_tpu_torch/ops/phasefunc.py and the
eight apply*PhaseFunc* rows of operators.py) against quest_tpu and a numpy
oracle of the reference's scalar loop (the oracles of
tests/test_operators.py, over every index at once).

Inputs are made with numpy from a seed and loaded into both packages.
State vectors run on one device and over 4 and 8 shards (port: virtual CPU
shards; quest_tpu: 4 or 8 of its emulated CPU devices), with registers on
sharded qubits and registers that straddle the shard boundary; density
registers on one device (the conj shadow). Both encodings, every
``phaseFunc`` name, overrides, QASM text and validation messages.
Tolerances as tests/helpers.py's TOL: 2e-4 in f32, 1e-10 in f64.
"""

import jax
import numpy as np
import pytest

import quest_tpu as jq
import quest_tpu_torch as tq
from quest_tpu_torch.interop import state_to_numpy
from quest_tpu_torch.ops import phasefunc as PF

from . import oracle

N = 7
ND = 3
TOLS = {1: 2e-4, 2: 1e-10}
P = tq.phaseFunc


def _envs(d):
    tenv = (tq.createQuESTEnv(device="cpu") if d == 1
            else tq.createQuESTEnv(devices=["cpu"] * d))
    return jq.createQuESTEnv(jax.devices()[:d]), tenv


def _pair(envs, n, prec, rng, density=False):
    """One register in each package holding the same random state; returns
    (jax register, port register, the state as a vector or matrix)."""
    jenv, tenv = envs
    if density:
        rho = oracle.random_density(n, rng)
        flat = rho.T.reshape(-1)
        jqr, tqr = jq.createDensityQureg(n, jenv, prec), tq.createDensityQureg(n, tenv, prec)
    else:
        flat = oracle.random_statevec(n, rng)
        jqr, tqr = jq.createQureg(n, jenv, prec), tq.createQureg(n, tenv, prec)
    for mod, q in ((jq, jqr), (tq, tqr)):
        mod.initStateFromAmps(q, flat.real, flat.imag)
    return jqr, tqr, (rho if density else flat)


def _reg_values(n, qubit_regs, encoding):
    """(num_regs, 2^n) encoded sub-register values of every index."""
    i = np.arange(1 << n)
    vals = []
    for reg in qubit_regs:
        m = len(reg)
        v = np.zeros(1 << n, dtype=np.int64)
        for j, q in enumerate(reg):
            bit = (i >> q) & 1
            v += -(bit << (m - 1)) if encoding == 1 and j == m - 1 else bit << j
        vals.append(v)
    return np.array(vals, dtype=float)


def _overridden(vals, phases, ovr_inds, ovr_phases):
    """First-match-wins overrides (QuEST_cpu.c:4245-4254)."""
    num_regs = vals.shape[0]
    done = np.zeros(vals.shape[1], dtype=bool)
    for o in range(len(ovr_phases)):
        hit = ~done & np.all([vals[r] == ovr_inds[o * num_regs + r]
                              for r in range(num_regs)], axis=0)
        phases = np.where(hit, ovr_phases[o], phases)
        done |= hit
    return phases


def poly_oracle(n, qubit_regs, encoding, coeffs, exponents, terms_per_reg,
                ovr_inds=(), ovr_phases=()):
    vals = _reg_values(n, qubit_regs, encoding)
    phases = np.zeros(1 << n)
    flat = 0
    with np.errstate(divide="ignore", invalid="ignore"):
        for r in range(len(qubit_regs)):
            for _ in range(terms_per_reg[r]):
                phases = phases + coeffs[flat] * vals[r] ** exponents[flat]
                flat += 1
    return _overridden(vals, phases, ovr_inds, ovr_phases)


def named_oracle(n, qubit_regs, encoding, fn, params, ovr_inds=(), ovr_phases=(),
                 eps=1e-13):
    """The reference's named phase functions (QuEST_cpu.c:4440-4530)."""
    vals = _reg_values(n, qubit_regs, encoding)
    num_regs = len(qubit_regs)
    par = list(params) + [0.0] * 16

    def inv(x, num, at_zero, zero_val):
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(at_zero, zero_val, num / np.where(at_zero, 1, x))

    if fn in (P.NORM, P.INVERSE_NORM, P.SCALED_NORM, P.SCALED_INVERSE_NORM,
              P.SCALED_INVERSE_SHIFTED_NORM):
        shift = [par[2 + r] if fn == P.SCALED_INVERSE_SHIFTED_NORM else 0.0
                 for r in range(num_regs)]
        norm = np.sqrt(sum((vals[r] - shift[r]) ** 2 for r in range(num_regs)))
        phases = {P.NORM: norm, P.INVERSE_NORM: inv(norm, 1, norm == 0, par[0]),
                  P.SCALED_NORM: par[0] * norm}.get(fn)
        if phases is None:
            phases = inv(norm, par[0], norm <= eps, par[1])
    elif fn in (P.PRODUCT, P.INVERSE_PRODUCT, P.SCALED_PRODUCT, P.SCALED_INVERSE_PRODUCT):
        prod = np.prod(vals, axis=0)
        phases = {P.PRODUCT: prod, P.INVERSE_PRODUCT: inv(prod, 1, prod == 0, par[0]),
                  P.SCALED_PRODUCT: par[0] * prod}.get(fn)
        if phases is None:
            phases = inv(prod, par[0], prod == 0, par[1])
    else:
        dist = np.zeros(1 << n)
        for r in range(0, num_regs, 2):
            if fn == P.SCALED_INVERSE_SHIFTED_DISTANCE:
                dist += (vals[r] - vals[r + 1] - par[2 + r // 2]) ** 2
            elif fn == P.SCALED_INVERSE_SHIFTED_WEIGHTED_DISTANCE:
                dist += par[2 + r] * (vals[r] - vals[r + 1] - par[2 + r + 1]) ** 2
            else:
                dist += (vals[r + 1] - vals[r]) ** 2
        dist = np.sqrt(np.maximum(dist, 0.0))
        phases = {P.DISTANCE: dist, P.INVERSE_DISTANCE: inv(dist, 1, dist == 0, par[0]),
                  P.SCALED_DISTANCE: par[0] * dist}.get(fn)
        if phases is None:
            phases = inv(dist, par[0], dist <= eps, par[1])
    return _overridden(vals, phases, ovr_inds, ovr_phases)


def _expected(ref, phases, density):
    f = np.exp(1j * phases)
    return f[:, None] * ref * f.conj()[None, :] if density else f * ref


def _check(jqr, tqr, expected, tol, density):
    got = state_to_numpy(tqr)
    got = got[0] + 1j * got[1]
    if density:
        dim = 1 << tqr.num_qubits_represented
        got = got.reshape(dim, dim).T
    np.testing.assert_allclose(got, expected, rtol=0, atol=tol)
    j = np.asarray(jqr.amps)
    np.testing.assert_allclose(state_to_numpy(tqr), j, rtol=0, atol=tol)


def _both(call, jqr, tqr):
    call(jq, jqr)
    call(tq, tqr)


# ---------------------------------------------------------------------------
# applyPhaseFunc / applyPhaseFuncOverrides
# ---------------------------------------------------------------------------

#: (d, qubits): unsorted qubits, sharded ones among them at d > 1 (the top
#: 2 of 7 at d = 4, the top 3 at d = 8)
POLY_QUBITS = [(1, (4, 2, 0)), (4, (6, 2, 0, 5)), (8, (1, 5, 3, 6))]


@pytest.mark.parametrize("prec,d,qubits", [(1, *POLY_QUBITS[0]), (2, *POLY_QUBITS[0]),
                                            (2, *POLY_QUBITS[1]), (1, *POLY_QUBITS[2])])
@pytest.mark.parametrize("encoding", [0, 1])
def test_phase_func_statevec(prec, encoding, d, qubits):
    tol = TOLS[prec]
    rng = np.random.RandomState(100 * prec + 10 * encoding + d)
    jqr, tqr, ref = _pair(_envs(d), N, prec, rng)
    assert (tqr.shards is None) == (d == 1)
    coeffs, exps = [0.3, -0.7, 0.05], [1.0, 2.0, 3.0]
    _both(lambda m, q: m.applyPhaseFunc(q, list(qubits), encoding, coeffs, exps), jqr, tqr)
    phases = poly_oracle(N, [qubits], encoding, coeffs, exps, [3])
    _check(jqr, tqr, _expected(ref, phases, False), tol, False)
    # overrides, first match wins (the value 2 twice), and a negative
    # exponent whose zero index is overridden
    inds = [0, 2, -1 if encoding else 3, 2]
    ovr = [0.25, -0.5, 1.5, 9.0]
    c2, e2 = [1.1, 0.4], [2.0, -1.0]
    _both(lambda m, q: m.applyPhaseFuncOverrides(q, list(qubits), encoding, c2, e2, inds,
                                                 ovr), jqr, tqr)
    phases2 = poly_oracle(N, [qubits], encoding, c2, e2, [2], inds, ovr)
    _check(jqr, tqr, _expected(_expected(ref, phases, False), phases2, False), tol, False)


@pytest.mark.parametrize("encoding", [0, 1])
@pytest.mark.parametrize("prec", [1, 2])
def test_phase_func_density(prec, encoding):
    """rho -> F rho F^dagger: the phase on the row qubits and its negative
    on the column qubits q + n."""
    tol = TOLS[prec]
    jqr, tqr, rho = _pair(_envs(1), ND, prec, np.random.RandomState(7 + prec), True)
    qubits, coeffs, exps = (2, 0), [0.6, -1.3], [1.0, 2.0]
    inds, ovr = [1], [0.7]
    _both(lambda m, q: m.applyPhaseFuncOverrides(q, list(qubits), encoding, coeffs, exps,
                                                 inds, ovr), jqr, tqr)
    phases = poly_oracle(ND, [qubits], encoding, coeffs, exps, [2], inds, ovr)
    _check(jqr, tqr, _expected(rho, phases, True), tol, True)


def test_phase_func_fractional_exponent_and_tiny_shards():
    """A fractional exponent (the pow branch), and 8 shards of a 3-qubit
    register (one amplitude each: a shard shorter than a row of the grid)."""
    rng = np.random.RandomState(5)
    jqr, tqr, ref = _pair(_envs(1), N, 2, rng)
    _both(lambda m, q: m.applyPhaseFunc(q, [3, 1, 6], 0, [0.8, 0.1], [0.5, 0.0]), jqr, tqr)
    phases = poly_oracle(N, [(3, 1, 6)], 0, [0.8, 0.1], [0.5, 0.0], [2])
    _check(jqr, tqr, _expected(ref, phases, False), 1e-10, False)
    env8 = tq.createQuESTEnv(devices=["cpu"] * 8)
    q = tq.createQureg(3, env8, 2)
    v = oracle.random_statevec(3, rng)
    tq.initStateFromAmps(q, v.real, v.imag)
    assert len(q.shards) == 8 and q.shards[0].shape == (2, 1)
    tq.applyPhaseFunc(q, [2, 0, 1], 1, [0.9, -0.2], [1.0, 2.0])
    got = state_to_numpy(q)
    phases = poly_oracle(3, [(2, 0, 1)], 1, [0.9, -0.2], [1.0, 2.0], [2])
    np.testing.assert_allclose(got[0] + 1j * got[1], np.exp(1j * phases) * v, atol=1e-12)


# ---------------------------------------------------------------------------
# applyMultiVarPhaseFunc / applyMultiVarPhaseFuncOverrides
# ---------------------------------------------------------------------------

#: registers per shard count: at d = 4 the first register straddles the
#: shard boundary (qubits 3 local, 5 sharded), at d = 8 both do
MULTI_REGS = {1: [(0, 1), (2, 3, 4)], 4: [(3, 5), (6, 1, 0)], 8: [(6, 2), (0, 4, 5)]}


@pytest.mark.parametrize("prec,d", [(1, 1), (2, 1), (2, 4), (1, 8)])
def test_multi_var_phase_func(prec, d):
    tol = TOLS[prec]
    regs = MULTI_REGS[d]
    flat_q, sizes = [q for r in regs for q in r], [len(r) for r in regs]
    jqr, tqr, ref = _pair(_envs(d), N, prec, np.random.RandomState(20 + 3 * prec + d))
    coeffs, exps, terms = [0.5, -0.2, 0.9], [1.0, 2.0, 1.0], [2, 1]
    _both(lambda m, q: m.applyMultiVarPhaseFunc(q, flat_q, sizes, 0, coeffs, exps, terms),
          jqr, tqr)
    phases = poly_oracle(N, regs, 0, coeffs, exps, terms)
    ref = _expected(ref, phases, False)
    _check(jqr, tqr, ref, tol, False)
    inds, ovr = [1, 2, 0, 0], [3.14, -1.0]
    _both(lambda m, q: m.applyMultiVarPhaseFuncOverrides(
        q, flat_q, sizes, 1, [0.4, 1.3], [2.0, 1.0], [1, 1], inds, ovr), jqr, tqr)
    phases = poly_oracle(N, regs, 1, [0.4, 1.3], [2.0, 1.0], [1, 1], inds, ovr)
    _check(jqr, tqr, _expected(ref, phases, False), tol, False)


def test_multi_var_phase_func_density():
    jqr, tqr, rho = _pair(_envs(1), ND, 2, np.random.RandomState(31), True)
    _both(lambda m, q: m.applyMultiVarPhaseFuncOverrides(
        q, [2, 0, 1], [1, 2], 0, [0.4, 1.3], [2.0, 1.0], [1, 1], [1, 0], [0.5]), jqr, tqr)
    phases = poly_oracle(ND, [(2,), (0, 1)], 0, [0.4, 1.3], [2.0, 1.0], [1, 1], [1, 0], [0.5])
    _check(jqr, tqr, _expected(rho, phases, True), 1e-10, True)


# ---------------------------------------------------------------------------
# the named phase functions
# ---------------------------------------------------------------------------

NAMED_CASES = [
    (P.NORM, []),
    (P.SCALED_NORM, [2.5]),
    (P.INVERSE_NORM, [7.0]),
    (P.SCALED_INVERSE_NORM, [1.5, -3.0]),
    (P.SCALED_INVERSE_SHIFTED_NORM, [1.5, -3.0, 0.5, 1.0]),
    (P.PRODUCT, []),
    (P.SCALED_PRODUCT, [-1.2]),
    (P.INVERSE_PRODUCT, [4.0]),
    (P.SCALED_INVERSE_PRODUCT, [2.0, 0.7]),
    (P.DISTANCE, []),
    (P.SCALED_DISTANCE, [0.8]),
    (P.INVERSE_DISTANCE, [5.0]),
    (P.SCALED_INVERSE_DISTANCE, [1.0, 2.0]),
    (P.SCALED_INVERSE_SHIFTED_DISTANCE, [1.0, 2.0, 1.5]),
    (P.SCALED_INVERSE_SHIFTED_WEIGHTED_DISTANCE, [1.0, 2.0, 0.5, 1.0]),
]


@pytest.mark.parametrize("fn,params", NAMED_CASES, ids=[c[0].name for c in NAMED_CASES])
def test_param_named_phase_func(fn, params):
    """Every named function at f64 on one device and on 4 shards (the
    first register straddles the boundary), against quest_tpu and the
    oracle; the f32 run on one device against the oracle."""
    regs = [(3, 5), (6, 1)]
    flat_q, sizes = [3, 5, 6, 1], [2, 2]
    for d, prec in ((1, 2), (4, 2), (1, 1)):
        enc = 1 if fn in (P.SCALED_INVERSE_NORM, P.DISTANCE) else 0
        jqr, tqr, ref = _pair(_envs(d), N, prec, np.random.RandomState(int(fn) + d))
        _both(lambda m, q: m.applyParamNamedPhaseFunc(q, flat_q, sizes, enc, fn, params),
              jqr, tqr)
        phases = named_oracle(N, regs, enc, fn, params,
                              eps=1e-13 if prec == 2 else 1e-5)
        _check(jqr, tqr, _expected(ref, phases, False), TOLS[prec], False)


@pytest.mark.parametrize("d", [1, 8])
def test_named_phase_func_and_overrides(d):
    regs = [(0, 2), (6, 4)]
    jqr, tqr, ref = _pair(_envs(d), N, 2, np.random.RandomState(40 + d))
    _both(lambda m, q: m.applyNamedPhaseFunc(q, [0, 2, 6, 4], [2, 2], 0, P.NORM), jqr, tqr)
    ref = _expected(ref, named_oracle(N, regs, 0, P.NORM, []), False)
    _check(jqr, tqr, ref, 1e-10, False)
    inds, ovr = [0, 0, 1, 2], [0.123, 4.56]
    _both(lambda m, q: m.applyNamedPhaseFuncOverrides(q, [0, 2, 6, 4], [2, 2], 0,
                                                      P.PRODUCT, inds, ovr), jqr, tqr)
    ref = _expected(ref, named_oracle(N, regs, 0, P.PRODUCT, [], inds, ovr), False)
    _check(jqr, tqr, ref, 1e-10, False)
    # SCALED_INVERSE_NORM under TWOS_COMPLEMENT with its zero overridden
    _both(lambda m, q: m.applyParamNamedPhaseFuncOverrides(
        q, [0, 2, 6, 4], [2, 2], 1, P.SCALED_INVERSE_NORM, [3.0, -0.5], [0, 0], [1.0]),
        jqr, tqr)
    ref = _expected(ref, named_oracle(N, regs, 1, P.SCALED_INVERSE_NORM, [3.0, -0.5],
                                      [0, 0], [1.0]), False)
    _check(jqr, tqr, ref, 1e-10, False)


@pytest.mark.parametrize("prec", [1, 2])
def test_named_phase_func_density(prec):
    jqr, tqr, rho = _pair(_envs(1), ND, prec, np.random.RandomState(50 + prec), True)
    _both(lambda m, q: m.applyParamNamedPhaseFuncOverrides(
        q, [0, 2, 1], [2, 1], 0, P.SCALED_INVERSE_SHIFTED_NORM, [1.5, -3.0, 0.5, 1.0],
        [1, 1], [0.3]), jqr, tqr)
    phases = named_oracle(ND, [(0, 2), (1,)], 0, P.SCALED_INVERSE_SHIFTED_NORM,
                          [1.5, -3.0, 0.5, 1.0], [1, 1], [0.3],
                          eps=1e-13 if prec == 2 else 1e-5)
    _check(jqr, tqr, _expected(rho, phases, True), TOLS[prec], True)


def test_phase_grid_split_matches_reference_split():
    """The (2^h, 2^l) split of the JAX kernel, l = n // 2, and a shard's
    rows of it."""
    assert PF._split(7) == (4, 3) and PF._split(26) == (13, 13)
    assert PF._piece_grid(7, 32, 32) == (slice(4, 8), slice(None))
    assert PF._piece_grid(3, 5, 1) == (slice(2, 3), slice(1, 2))


# ---------------------------------------------------------------------------
# QASM and validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec", [1, 2])
def test_phase_func_qasm_matches_reference(prec):
    jenv, tenv = _envs(1)
    texts = []
    for mod, env in ((jq, jenv), (tq, tenv)):
        q = mod.createQureg(6, env, prec)
        mod.startRecordingQASM(q)
        mod.applyPhaseFunc(q, [0, 1, 2], 0, [0.5, -1.25], [1.0, 2.0])
        mod.applyPhaseFuncOverrides(q, [3, 4], 1, [2.0], [-1.0], [0, -1], [0.5, -0.25])
        mod.applyMultiVarPhaseFuncOverrides(q, [0, 1, 2, 3], [2, 2], 0, [0.4, -1.3, 2.0],
                                            [2.0, 1.0, 3.0], [2, 1], [1, 2], [3.14])
        for fn, params in NAMED_CASES:
            nregs = 2
            mod.applyParamNamedPhaseFunc(q, [0, 1, 4, 5], [nregs, nregs], 0, fn, params)
        mod.applyNamedPhaseFuncOverrides(q, [0, 1, 2, 3, 4, 5], [2, 2, 2], 0, P.PRODUCT,
                                         [0, 1, 2], [0.5])
        texts.append(q.qasm_log.printed())
    assert texts[1] == texts[0]
    assert "applyNamedPhaseFunc" in texts[1] and "overrides" in texts[1]


def _errors(call):
    """The QuESTError messages of ``call`` in each package, and whether the
    port's state was left as it was."""
    msgs = []
    same = True
    for mod in (jq, tq):
        env = mod.createQuESTEnv(jax.devices()[:1]) if mod is jq else \
            tq.createQuESTEnv(device="cpu")
        q = mod.createQureg(5, env, 2)
        mod.initDebugState(q)
        before = np.array(state_to_numpy(q) if mod is tq else q.amps)
        with pytest.raises(mod.QuESTError) as e:
            call(mod, q)
        msgs.append(str(e.value))
        if mod is tq:
            same = np.array_equal(state_to_numpy(q), before)
    return msgs, same


PHASE_ERRORS = [
    lambda m, q: m.applyPhaseFunc(q, [0, 1], 0, [], []),
    lambda m, q: m.applyPhaseFunc(q, [0, 5], 0, [1.0], [1.0]),
    lambda m, q: m.applyPhaseFunc(q, [0, 0], 0, [1.0], [1.0]),
    lambda m, q: m.applyPhaseFunc(q, [0, 1], 2, [1.0], [1.0]),
    lambda m, q: m.applyPhaseFunc(q, [0], 1, [1.0], [1.0]),
    lambda m, q: m.applyPhaseFunc(q, [0, 1], 0, [1.0], [-1.0]),
    lambda m, q: m.applyPhaseFunc(q, [0, 1], 1, [1.0], [0.5]),
    lambda m, q: m.applyPhaseFuncOverrides(q, [0, 1], 0, [1.0], [1.0], [4], [0.1]),
    lambda m, q: m.applyPhaseFuncOverrides(q, [0, 1], 0, [1.0], [1.0], [0, 1], [0.1]),
    lambda m, q: m.applyPhaseFuncOverrides(q, [0], 0, [1.0], [1.0], [0, 1, 0], [.1, .2, .3]),
    lambda m, q: m.applyMultiVarPhaseFunc(q, [0, 1, 2], [1, 2], 0, [1.0], [1.0], [1, 0]),
    lambda m, q: m.applyMultiVarPhaseFunc(q, [0, 1, 2], [1, 2], 0, [1.0, 1.0], [1.0, -2.0],
                                          [1, 1]),
    lambda m, q: m.applyMultiVarPhaseFunc(q, [0, 1, 2, 3], [2, 2], 1, [1.0, 1.0],
                                          [1.0, 0.5], [1, 1]),
    lambda m, q: m.applyMultiVarPhaseFunc(q, [0, 1], [], 0, [1.0], [1.0], []),
    lambda m, q: m.applyNamedPhaseFunc(q, [0, 1, 2], [3], 0, P.DISTANCE),
    lambda m, q: m.applyNamedPhaseFunc(q, [0, 1], [1, 1], 0, 15),
    lambda m, q: m.applyParamNamedPhaseFunc(q, [0, 1], [1, 1], 0, P.SCALED_NORM, []),
    lambda m, q: m.applyParamNamedPhaseFunc(q, [0, 1, 2, 3], [2, 2], 0,
                                            P.SCALED_INVERSE_SHIFTED_DISTANCE, [1.0, 2.0]),
    lambda m, q: m.applyNamedPhaseFunc(q, [0, 0, 1, 2], [2, 2], 0, P.NORM),
    lambda m, q: m.applyNamedPhaseFuncOverrides(q, [0, 1, 2, 3], [2, 2], 1, P.NORM,
                                                [2, 0], [0.5]),
]


@pytest.mark.parametrize("i", range(len(PHASE_ERRORS)))
def test_phase_func_validation_matches_reference(i):
    msgs, same = _errors(PHASE_ERRORS[i])
    assert msgs[1] == msgs[0]
    assert same
