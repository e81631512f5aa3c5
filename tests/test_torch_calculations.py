"""The port's readouts, calculations and API glue against quest_tpu and
the dense numpy oracle (tests/oracle.py): inner products, fidelities,
distances, outcome distributions, Pauli expectation values, PauliHamil,
mixDensityMatrix, createCloneQureg, the environment rows and the
overridable validation hook.

Inputs are made with numpy from a seed and loaded into both packages
(``initStateFromAmps`` on both sides, ``interop.load_state``). State-vector
rows run on one device and over 4 and 8 shards (port: virtual CPU shards;
quest_tpu: 4 or 8 of its emulated CPU devices), and on pairs of registers
of mixed layouts. Tolerances as tests/helpers.py's TOL: 2e-4 in f32, 1e-10
in f64.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quest_tpu as jq
import quest_tpu_torch as tq
from quest_tpu import calculations as JC
from quest_tpu.analysis.surface import REFERENCE_MANIFEST
from quest_tpu_torch import calculations as TC, datatypes as TD, validation as TV
from quest_tpu_torch.interop import load_state, state_to_numpy

from . import oracle

N = 7
ND = 3
TOLS = {1: 2e-4, 2: 1e-10}

#: the 31 rows this slice of the port adds
SLICE_ROWS = (
    "calcProbOfAllOutcomes", "calcInnerProduct", "calcDensityInnerProduct",
    "calcFidelity", "calcHilbertSchmidtDistance", "calcExpecPauliProd",
    "calcExpecPauliSum", "calcExpecPauliHamil", "getProbAmp", "mixDensityMatrix",
    "createPauliHamil", "createPauliHamilFromFile", "destroyPauliHamil",
    "initPauliHamil", "destroyQuESTEnv", "syncQuESTEnv", "syncQuESTSuccess",
    "reportQuESTEnv", "getEnvironmentString", "getQuESTSeeds", "createCloneQureg",
    "invalidQuESTInputError", "reportState", "reportStateToScreen",
    "reportQuregParams", "reportPauliHamil", "startRecordingQASM",
    "stopRecordingQASM", "clearRecordedQASM", "printRecordedQASM",
    "writeRecordedQASMToFile",
)


#: the manifest rows the port still lacks: none (the operators slice and
#: the four copyState*GPU rows closed the surface)
STILL_MISSING = ()


def _envs(d):
    tenv = (tq.createQuESTEnv(device="cpu") if d == 1
            else tq.createQuESTEnv(devices=["cpu"] * d))
    return jq.createQuESTEnv(jax.devices()[:d]), tenv


def _state(rng, num_amps):
    v = rng.randn(num_amps) + 1j * rng.randn(num_amps)
    return v / np.linalg.norm(v)


def _density(rng, n):
    """A random mixed state, flattened [col, row] as both packages store it."""
    rho = oracle.random_density(n, rng)
    return rho, rho.T.reshape(-1)


def _pair(envs, n, prec, flat, density=False):
    """One register in each package, both holding the complex vector ``flat``."""
    jenv, tenv = envs
    if density:
        jqr, tqr = jq.createDensityQureg(n, jenv, prec), tq.createDensityQureg(n, tenv, prec)
    else:
        jqr, tqr = jq.createQureg(n, jenv, prec), tq.createQureg(n, tenv, prec)
    for mod, q in ((jq, jqr), (tq, tqr)):
        mod.initStateFromAmps(q, flat.real, flat.imag)
    return jqr, tqr


def _close(got, ref, tol, scale=1.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=tol * max(scale, 1.0))


# ---------------------------------------------------------------------------
# the surface
# ---------------------------------------------------------------------------

def test_torch_surface_slice():
    assert len(SLICE_ROWS) == 31
    assert [r for r in SLICE_ROWS if not hasattr(tq, r)] == []
    missing = {e.name for e in REFERENCE_MANIFEST if not hasattr(tq, e.name)}
    assert len(STILL_MISSING) == 0
    assert missing == set(STILL_MISSING)
    assert len(REFERENCE_MANIFEST) - len(missing) == 156


# ---------------------------------------------------------------------------
# state-vector rows: one device, 4 and 8 shards
# ---------------------------------------------------------------------------

PROD_TARGETS, PROD_CODES = (6, 1, 4, 0), (1, 2, 3, 2)


@pytest.mark.parametrize("d", [1, 4, 8])
@pytest.mark.parametrize("prec", [1, 2])
def test_statevec_rows_match_reference(prec, d):
    tol = TOLS[prec]
    rng = np.random.RandomState(10 * prec + d)
    a, b = _state(rng, 1 << N), _state(rng, 1 << N)
    envs = _envs(d)
    (ja, ta), (jb, tb) = _pair(envs, N, prec, a), _pair(envs, N, prec, b)
    assert (ta.shards is None) == (d == 1)

    ip, jip = tq.calcInnerProduct(ta, tb), jq.calcInnerProduct(ja, jb)
    _close(ip, np.vdot(a, b), tol)
    _close(ip, jip, tol)
    fid = tq.calcFidelity(ta, tb)
    _close(fid, abs(np.vdot(a, b)) ** 2, tol)
    _close(fid, jq.calcFidelity(ja, jb), tol)

    # unsorted targets, sharded ones among them at d > 1 (local_n 4 at d = 8)
    p = np.abs(a) ** 2
    for targets in ((5, 0, 6, 2), (6, 4), (3,), (2, 6, 0, 5, 1, 4, 3)):
        got = tq.calcProbOfAllOutcomes(ta, targets)
        ref = np.zeros(1 << len(targets))
        for i, pi in enumerate(p):
            ref[sum(((i >> q) & 1) << k for k, q in enumerate(targets))] += pi
        assert got.shape == (1 << len(targets),)
        _close(got, ref, tol)
        _close(got, jq.calcProbOfAllOutcomes(ja, targets), tol)

    for i in (0, 37, (1 << N) - 1):
        _close(tq.getProbAmp(ta, i), abs(a[i]) ** 2, tol)
        _close(tq.getProbAmp(ta, i), jq.getProbAmp(ja, i), tol)

    # calcExpecPauliProd leaves P|a> in the workspace
    pmat = oracle.pauli_product_matrix(N, PROD_TARGETS, PROD_CODES)
    e = tq.calcExpecPauliProd(ta, PROD_TARGETS, PROD_CODES, tb)
    je = jq.calcExpecPauliProd(ja, PROD_TARGETS, PROD_CODES, jb)
    _close(e, np.vdot(a, pmat @ a).real, tol)
    _close(e, je, tol)
    _close(tq.get_np(tb), pmat @ a, tol)
    _close(tq.get_np(tb), np.asarray(jq.get_np(jb)), tol)
    _close(state_to_numpy(ta), np.stack([a.real, a.imag]), tol)  # qureg untouched

    # calcExpecPauliSum / Hamil leave the workspace as it was
    codes = rng.randint(0, 4, size=(6, N))
    coeffs = rng.randn(6)
    ref = sum(c * np.vdot(a, oracle.pauli_product_matrix(N, range(N), row) @ a).real
              for c, row in zip(coeffs, codes))
    before = state_to_numpy(tb)
    s = tq.calcExpecPauliSum(ta, codes.ravel(), coeffs, tb)
    _close(s, ref, tol, np.abs(coeffs).sum())
    _close(s, jq.calcExpecPauliSum(ja, codes.ravel(), coeffs, jb), tol, np.abs(coeffs).sum())
    np.testing.assert_array_equal(state_to_numpy(tb), before)
    th, jh = tq.createPauliHamil(N, 6), jq.createPauliHamil(N, 6)
    tq.initPauliHamil(th, coeffs, codes)
    jq.initPauliHamil(jh, coeffs, codes)
    h = tq.calcExpecPauliHamil(ta, th, tb)
    _close(h, ref, tol, np.abs(coeffs).sum())
    _close(h, jq.calcExpecPauliHamil(ja, jh, jb), tol, np.abs(coeffs).sum())
    np.testing.assert_array_equal(state_to_numpy(tb), before)


@pytest.mark.parametrize("d", [4, 8])
@pytest.mark.parametrize("prec", [1, 2])
def test_mixed_layouts_match_reference(prec, d):
    """One register sharded, the other on one device: the second is re-cut
    into the first's layout, in either order, and the workspace keeps its
    own layout."""
    tol = TOLS[prec]
    rng = np.random.RandomState(40 + d)
    a, b = _state(rng, 1 << N), _state(rng, 1 << N)
    jenv, tenv = _envs(d)
    j1, t1 = _envs(1)
    (ja, ta), (jb, tb) = _pair((jenv, tenv), N, prec, a), _pair((j1, t1), N, prec, b)
    assert ta.shards is not None and tb.shards is None
    for bra, ket, jbra, jket, ref in ((ta, tb, ja, jb, np.vdot(a, b)),
                                      (tb, ta, jb, ja, np.vdot(b, a))):
        _close(tq.calcInnerProduct(bra, ket), ref, tol)
        _close(tq.calcInnerProduct(bra, ket), jq.calcInnerProduct(jbra, jket), tol)
        _close(tq.calcFidelity(bra, ket), abs(ref) ** 2, tol)
    pmat = oracle.pauli_product_matrix(N, PROD_TARGETS, PROD_CODES)
    for (q, jqr, v), (work, jwork, w) in (((ta, ja, a), (tb, jb, b)),
                                          ((tb, jb, b), (ta, ja, a))):
        e = tq.calcExpecPauliProd(q, PROD_TARGETS, PROD_CODES, work)
        je = jq.calcExpecPauliProd(jqr, PROD_TARGETS, PROD_CODES, jwork)
        _close(e, np.vdot(v, pmat @ v).real, tol)
        _close(e, je, tol)
        _close(tq.get_np(work), pmat @ v, tol)
        _close(tq.get_np(work), np.asarray(jq.get_np(jwork)), tol)
        for mod, r in ((tq, work), (jq, jwork)):  # the workspace's state again
            mod.initStateFromAmps(r, w.real, w.imag)
    assert ta.shards is not None and len(ta.shards) == d and tb.shards is None


def test_expec_pauli_sum_amps_matches_reference():
    rng = np.random.RandomState(3)
    a = _state(rng, 1 << N)
    codes = tuple(tuple(int(c) for c in row) for row in rng.randint(0, 4, size=(5, N)))
    coeffs = rng.randn(5)
    planar = np.stack([a.real, a.imag])
    got = TC.expec_pauli_sum_amps(torch.tensor(planar), coeffs, codes=codes, n=N,
                                  density=False)
    # the JAX function under jit, as its callers run it (its ops donate)
    ref = JC._expec_pauli_sum_run(jnp.asarray(planar), jnp.asarray(coeffs), codes=codes,
                                  n=N, density=False)
    assert got.dtype == torch.float64 and got.shape == ()
    _close(float(got), float(ref), 1e-10, np.abs(coeffs).sum())


# ---------------------------------------------------------------------------
# density rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec", [1, 2])
def test_density_rows_match_reference(prec):
    tol = TOLS[prec]
    rng = np.random.RandomState(7 + prec)
    envs = _envs(1)
    (r1, f1), (r2, f2) = _density(rng, ND), _density(rng, ND)
    psi = _state(rng, 1 << ND)
    (j1, t1), (j2, t2) = _pair(envs, ND, prec, f1, True), _pair(envs, ND, prec, f2, True)
    jp, tp = _pair(envs, ND, prec, psi)

    di = tq.calcDensityInnerProduct(t1, t2)
    _close(di, np.trace(r1.conj().T @ r2).real, tol)
    _close(di, jq.calcDensityInnerProduct(j1, j2), tol)
    hs = tq.calcHilbertSchmidtDistance(t1, t2)
    _close(hs, np.sqrt((np.abs(r1 - r2) ** 2).sum()), tol)
    _close(hs, jq.calcHilbertSchmidtDistance(j1, j2), tol)
    fid = tq.calcFidelity(t1, tp)
    _close(fid, np.vdot(psi, r1 @ psi).real, tol)
    _close(fid, jq.calcFidelity(j1, jp), tol)

    diag = np.diagonal(r1).real
    for targets in ((2, 0), (1,), (0, 2, 1)):
        ref = np.zeros(1 << len(targets))
        for i, pi in enumerate(diag):
            ref[sum(((i >> q) & 1) << k for k, q in enumerate(targets))] += pi
        _close(tq.calcProbOfAllOutcomes(t1, targets), ref, tol)
        _close(tq.calcProbOfAllOutcomes(t1, targets),
               jq.calcProbOfAllOutcomes(j1, targets), tol)

    # the workspace holds P applied to the flattened matrix as a plain vector
    targets, codes = (2, 0), (2, 1)
    e = tq.calcExpecPauliProd(t1, targets, codes, t2)
    je = jq.calcExpecPauliProd(j1, targets, codes, j2)
    _close(e, np.trace(oracle.pauli_product_matrix(ND, targets, codes) @ r1).real, tol)
    _close(e, je, tol)
    pflat = oracle.pauli_product_matrix(2 * ND, targets, codes) @ f1
    _close(tq.get_np(t2), pflat, tol)
    _close(tq.get_np(t2), np.asarray(jq.get_np(j2)), tol)

    hcodes = rng.randint(0, 4, size=(4, ND))
    coeffs = rng.randn(4)
    ref = sum(c * np.trace(oracle.pauli_product_matrix(ND, range(ND), row) @ r1).real
              for c, row in zip(coeffs, hcodes))
    before = state_to_numpy(t2)
    s = tq.calcExpecPauliSum(t1, hcodes.ravel(), coeffs, t2)
    _close(s, ref, tol, np.abs(coeffs).sum())
    _close(s, jq.calcExpecPauliSum(j1, hcodes.ravel(), coeffs, j2), tol, np.abs(coeffs).sum())
    th = tq.createPauliHamil(ND, 4)
    tq.initPauliHamil(th, coeffs, hcodes)
    _close(tq.calcExpecPauliHamil(t1, th, t2), ref, tol, np.abs(coeffs).sum())
    np.testing.assert_array_equal(state_to_numpy(t2), before)

    # mixDensityMatrix: the state, its trace and purity, and its QASM record
    for q in (j1, t1):
        q.qasm_log.start()
    jq.mixDensityMatrix(j1, 0.3, j2)
    tq.mixDensityMatrix(t1, 0.3, t2)
    mixed = 0.7 * f1 + 0.3 * pflat
    _close(tq.get_np(t1), mixed, tol)
    _close(tq.get_np(t1), np.asarray(jq.get_np(j1)), tol)
    _close(tq.calcTotalProb(t1), jq.calcTotalProb(j1), tol)
    _close(tq.calcPurity(t1), (np.abs(mixed) ** 2).sum(), tol)
    assert t1.qasm_log.printed() == j1.qasm_log.printed()
    assert t1.qasm_log.printed().endswith("// mixDensityMatrix(0.3)\n")


def test_mix_density_matrix_validates_as_reference():
    envs = _envs(1)
    rng = np.random.RandomState(5)
    _, f = _density(rng, ND)
    (j1, t1), (j2, t2) = _pair(envs, ND, 2, f, True), _pair(envs, ND, 2, f, True)
    jsv, tsv = _pair(envs, ND, 2, _state(rng, 1 << ND))
    jsmall, tsmall = _pair(envs, ND - 1, 2, _density(rng, ND - 1)[1], True)
    for args in ((1.5, 2), (-0.1, 2), (0.2, "sv"), (0.2, "small")):
        p, other = args
        jo, to = {2: (j2, t2), "sv": (jsv, tsv), "small": (jsmall, tsmall)}[other]
        with pytest.raises(jq.QuESTError) as jerr:
            jq.mixDensityMatrix(j1, p, jo)
        with pytest.raises(tq.QuESTError, match=re.escape(jerr.value.message)):
            tq.mixDensityMatrix(t1, p, to)
    np.testing.assert_array_equal(tq.get_np(t1), f)


# ---------------------------------------------------------------------------
# validation of the calculations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", [
    lambda m, sv, sv2, rho, h: m.calcInnerProduct(sv, rho),
    lambda m, sv, sv2, rho, h: m.calcFidelity(sv, rho),
    lambda m, sv, sv2, rho, h: m.calcDensityInnerProduct(sv, rho),
    lambda m, sv, sv2, rho, h: m.calcHilbertSchmidtDistance(rho, sv),
    lambda m, sv, sv2, rho, h: m.calcProbOfAllOutcomes(sv, (1, 1)),
    lambda m, sv, sv2, rho, h: m.calcProbOfAllOutcomes(sv, (N,)),
    lambda m, sv, sv2, rho, h: m.calcExpecPauliProd(sv, (0, 1), (1,), sv2),
    lambda m, sv, sv2, rho, h: m.calcExpecPauliProd(sv, (0,), (4,), sv2),
    lambda m, sv, sv2, rho, h: m.calcExpecPauliProd(sv, (0,), (1,), rho),
    lambda m, sv, sv2, rho, h: m.calcExpecPauliSum(sv, [1] * (N - 1), [0.5], sv2),
    lambda m, sv, sv2, rho, h: m.calcExpecPauliSum(sv, [5] * N, [0.5], sv2),
    lambda m, sv, sv2, rho, h: m.calcExpecPauliHamil(sv, h, sv2),
    lambda m, sv, sv2, rho, h: m.getProbAmp(sv, 1 << N),
    lambda m, sv, sv2, rho, h: m.getProbAmp(rho, 0),
], ids=["inner_density", "fidelity_density_pure", "density_inner_sv", "hs_sv",
        "outcomes_repeated", "outcomes_range", "prod_code_count", "prod_code",
        "prod_workspace_type", "sum_code_count", "sum_code", "hamil_qubits",
        "prob_amp_index", "prob_amp_density"])
def test_calculation_validation_matches_reference(call):
    envs = _envs(1)
    rng = np.random.RandomState(2)
    a = _state(rng, 1 << N)
    (jsv, tsv), (jsv2, tsv2) = _pair(envs, N, 2, a), _pair(envs, N, 2, a)
    jrho, trho = _pair(envs, N, 2, _density(rng, N)[1], True)
    jh, th = jq.createPauliHamil(N + 1, 1), tq.createPauliHamil(N + 1, 1)
    with pytest.raises(jq.QuESTError) as jerr:
        call(jq, jsv, jsv2, jrho, jh)
    with pytest.raises(tq.QuESTError) as terr:
        call(tq, tsv, tsv2, trho, th)
    assert terr.value.message == jerr.value.message
    assert terr.value.func == jerr.value.func
    np.testing.assert_array_equal(tq.get_np(tsv2), a)  # the workspace untouched


# ---------------------------------------------------------------------------
# PauliHamil
# ---------------------------------------------------------------------------

def test_pauli_hamil_rows_match_reference():
    rng = np.random.RandomState(4)
    codes, coeffs = rng.randint(0, 4, size=(3, 4)), rng.randn(3)
    th, jh = tq.createPauliHamil(4, 3), jq.createPauliHamil(4, 3)
    assert th.pauli_codes.shape == (3, 4) and not th.term_coeffs.any()
    tq.initPauliHamil(th, coeffs, codes.ravel())
    jq.initPauliHamil(jh, coeffs, codes.ravel())
    for attr in ("num_qubits", "num_sum_terms", "pauli_codes", "term_coeffs"):
        np.testing.assert_array_equal(getattr(th, attr), getattr(jh, attr))
    assert th.pauli_codes.dtype == np.int32 and th.term_coeffs.dtype == np.float64
    np.testing.assert_array_equal(TD.pauli_term_matrix(codes[0]),
                                  oracle.pauli_product_matrix(4, range(4), codes[0]))
    tq.destroyPauliHamil(th)
    for args in ((0, 2), (2, 0)):
        with pytest.raises(jq.QuESTError) as jerr:
            jq.createPauliHamil(*args)
        with pytest.raises(tq.QuESTError, match=re.escape(jerr.value.message)):
            tq.createPauliHamil(*args)
    with pytest.raises(tq.QuESTError, match="Invalid Pauli code"):
        tq.initPauliHamil(th, coeffs, np.full(12, 7))


@pytest.mark.parametrize("text", [
    "0.5 1 0 3\n-1.25 2 2 0\n\n3 0 0 0\n",
    "0.5 1 0 3\nabc 2 2 0\n",
    "0.5 1 0 3\n-1.25 2 9 0\n",
    "0.5 1 0 3\n-1.25 2 x 0\n",
    "0.5 1 0 3\n-1.25 2 1.5 0\n",
    "0.5 1 0 3\n-1.25 2 1\n",
    "0.5\n",
    None,
], ids=["good", "bad_coefficient", "bad_code", "unparsed_code", "fractional_code",
        "short_row", "no_qubits", "missing_file"])
def test_pauli_hamil_from_file_matches_reference(tmp_path, text):
    path = tmp_path / "hamil.txt"
    if text is not None:
        path.write_text(text)
    try:
        jh = jq.createPauliHamilFromFile(str(path))
    except jq.QuESTError as jerr:
        with pytest.raises(tq.QuESTError, match=re.escape(jerr.message)) as terr:
            tq.createPauliHamilFromFile(str(path))
        assert terr.value.func == jerr.func == "createPauliHamilFromFile"
        return
    th = tq.createPauliHamilFromFile(str(path))
    assert (th.num_qubits, th.num_sum_terms) == (jh.num_qubits, jh.num_sum_terms) == (3, 3)
    np.testing.assert_array_equal(th.pauli_codes, jh.pauli_codes)
    np.testing.assert_array_equal(th.term_coeffs, jh.term_coeffs)


# ---------------------------------------------------------------------------
# createCloneQureg
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 4])
def test_clone_qureg_is_independent(d):
    _, tenv = _envs(d)
    rng = np.random.RandomState(6)
    a = _state(rng, 1 << N)
    src = tq.createQureg(N, tenv, 2)
    tq.initStateFromAmps(src, a.real, a.imag)
    if d == 1:
        src.spare_buffer()
    else:
        src.shard_spare_buffers()
    src.qasm_log.start()
    tq.hadamard(src, 0)
    clone = tq.createCloneQureg(src, tenv)
    before = tq.get_np(src)
    np.testing.assert_array_equal(tq.get_np(clone), before)
    assert clone.spare is None and clone.shard_spares is None
    assert [p.device for p in (clone.shards or [clone.amps])] == \
        [p.device for p in (src.shards or [src.amps])]
    assert not clone.qasm_log.recording
    assert clone.qasm_log.printed() == f"OPENQASM 2.0;\nqreg q[{N}];\ncreg c[{N}];\n"
    # writing to the clone leaves the source as it was
    tq.pauliX(clone, N - 1)
    tq.rotateY(clone, 2, 0.4)
    np.testing.assert_array_equal(tq.get_np(src), before)
    assert np.abs(tq.get_np(clone) - before).max() > 0.01
    # and the reference's clone of the same state holds the same amplitudes
    jenv = _envs(d)[0]
    jsrc = jq.createQureg(N, jenv, 2)
    jq.initStateFromAmps(jsrc, before.real, before.imag)
    jclone = jq.createCloneQureg(jsrc, jenv)
    np.testing.assert_array_equal(np.asarray(jq.get_np(jclone)), before)


def test_clone_density_qureg_matches_reference():
    envs = _envs(1)
    _, f = _density(np.random.RandomState(8), ND)
    jqr, tqr = _pair(envs, ND, 1, f, True)
    tc, jc = tq.createCloneQureg(tqr, envs[1]), jq.createCloneQureg(jqr, envs[0])
    assert tc.is_density_matrix and tc.dtype == torch.float32
    np.testing.assert_array_equal(state_to_numpy(tc), np.asarray(jc.amps))
    tq.mixDephasing(tc, 0, 0.2)
    np.testing.assert_array_equal(state_to_numpy(tqr), np.asarray(jqr.amps))


# ---------------------------------------------------------------------------
# environment rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 4])
def test_environment_rows_match_reference(d):
    jenv, tenv = _envs(d)
    for mod, env in ((jq, jenv), (tq, tenv)):
        mod.seedQuEST(env, [11, 22, 33])
        mod.syncQuESTEnv(env)
    assert tq.getQuESTSeeds(tenv) == jq.getQuESTSeeds(jenv) == [11, 22, 33]
    assert tq.syncQuESTSuccess(1) == jq.syncQuESTSuccess(1) == 1
    assert tq.syncQuESTSuccess(0) == 0
    jstr = jq.getEnvironmentString(jenv)
    assert tq.getEnvironmentString(tenv) == jstr.replace("TPU=1", "TPU=0")
    assert tq.getEnvironmentString(tenv).startswith("CUDA=0 ")
    assert f"ranks={d} devices={d}" in jstr
    tq.destroyQuESTEnv(tenv)
    jq.destroyQuESTEnv(jenv)


# ---------------------------------------------------------------------------
# the overridable validation hook
# ---------------------------------------------------------------------------

class _Caught(Exception):
    pass


def test_input_error_handler_overrides_match_reference(monkeypatch):
    envs = _envs(1)
    jqr, tqr = _pair(envs, N, 2, _state(np.random.RandomState(9), 1 << N))
    seen = {}

    def raising(msg, func):
        seen[func] = msg
        raise _Caught(f"{func}: {msg}")

    try:
        for mod, q in ((jq, jqr), (tq, tqr)):
            mod.set_input_error_handler(raising)
            with pytest.raises(_Caught, match="Invalid target qubit"):
                mod.hadamard(q, N)
            with pytest.raises(_Caught, match="Invalid amplitude index"):
                mod.getProbAmp(q, -1)
            # a handler that returns: the call still raises QuESTError
            mod.set_input_error_handler(lambda msg, func: None)
            with pytest.raises(mod.QuESTError, match="Invalid target qubit"):
                mod.pauliX(q, N)
            mod.set_input_error_handler(None)
            with pytest.raises(mod.QuESTError, match="Invalid target qubit"):
                mod.pauliX(q, N)
    finally:
        jq.set_input_error_handler(None)
        tq.set_input_error_handler(None)
    assert seen == {"hadamard": "Invalid target qubit. Note qubits are zero indexed.",
                    # getProbAmp validates through getAmp, in both packages
                    "getAmp": "Invalid amplitude index. Note amplitudes are zero indexed."}
    # rebinding the reference-named symbol overrides it too
    monkeypatch.setattr(TV, "invalidQuESTInputError", raising)
    with pytest.raises(_Caught, match="Invalid target qubit"):
        tq.hadamard(tqr, N)
    monkeypatch.undo()
    with pytest.raises(tq.QuESTError) as err:
        tq.invalidQuESTInputError("a message", "aFunc")
    with pytest.raises(jq.QuESTError) as jerr:
        jq.invalidQuESTInputError("a message", "aFunc")
    assert str(err.value) == str(jerr.value) == "aFunc: a message"
