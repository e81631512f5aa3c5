"""The port's trajectory noise (quest_tpu_torch/trajectories/) against
quest_tpu.trajectories, the density oracle and its own contracts.

- ``kraus_probabilities`` / ``traj_kraus_matrix`` against the JAX package's
  on the same state and Kraus stack; ``applyTrajectoryKraus`` with a fixed
  seed and site equal to ``quest_tpu``'s state within 1e-10 in f64 for
  every built-in channel and a 2-target explicit map (the port's threefry
  draw is JAX's bit for bit, so the same operator is taken);
- ``unravel`` gives the same entries, sites and seed slot as
  ``quest_tpu.trajectories.unravel`` and raises where it raises;
- the ensemble mean within 4/sqrt(T) of the density oracle for every
  channel at 8 qubits (full rho and the channel's reduced state);
- replays of a seed list bit for bit, raw and through
  ``fused(max_qubits=5, pallas=True)``, the fused ensemble against the raw
  one, lanes against the same seeds served alone bit for bit, 4 CPU shards
  against one device, new seeds building nothing;
- ``shots=`` tables equal to ``quest_tpu``'s in f64;
- QT501, the CPTP and density-register checks, and the counters.

Inputs are drawn from numpy seeds; tolerances are tests/helpers.py's
(1e-10 f64, 2e-4 f32).
"""

import warnings

import jax
import numpy as np
import pytest
import torch

import quest_tpu as jq
from quest_tpu import trajectories as jtr
from quest_tpu.circuits import Circuit as JCircuit
from quest_tpu.trajectories import sample as jsample
import quest_tpu_torch as tq
from quest_tpu_torch import channels, telemetry
from quest_tpu_torch import trajectories as ttr
from quest_tpu_torch.engine import Engine, P
from quest_tpu_torch.trajectories import ensemble as tens
from quest_tpu_torch.trajectories import sample as tsample
from quest_tpu_torch.validation import QuESTError

from .helpers import get_density

F64_TOL, F32_TOL = 1e-10, 2e-4
TENV = tq.createQuESTEnv(device="cpu")
TENV4 = tq.createQuESTEnv(devices=["cpu"] * 4)
JENV = jq.createQuESTEnv(jax.devices()[:1])
WAIT = 60

T_CONV = 256
TOL_CONV = 4.0 / np.sqrt(T_CONV)

#: a CPTP 2-target Kraus map outside the built-in table
_K2A = np.zeros((4, 4))
_K2A[0, 0] = 1.0
_K2A[1, 1] = 1.0
_K2A[2, 2] = np.sqrt(0.4)
_K2A[3, 3] = np.sqrt(0.7)
_K2B = np.zeros((4, 4))
_K2B[0, 2] = np.sqrt(0.6)
_K2B[1, 3] = np.sqrt(0.3)
KRAUS_2T = (_K2A, _K2B)

#: table key -> (probabilities, targets) of one site at 6-8 qubits
SITES = {
    "dephasing": ((0.35,), (3,)),
    "two_qubit_dephasing": ((0.45,), (2, 5)),
    "depolarising": ((0.5,), (1,)),
    "two_qubit_depolarising": ((0.6,), (4, 1)),
    "damping": ((0.4,), (0,)),
    "pauli": ((0.15, 0.1, 0.2), (5,)),
}

#: the convergence matrix: every mix* family and the explicit 2-target map
CHANNEL_CASES = {
    "dephasing": (lambda c: c.mixDephasing(3, 0.35), (3,)),
    "two_qubit_dephasing": (lambda c: c.mixTwoQubitDephasing(2, 5, 0.45), (2, 5)),
    "depolarising": (lambda c: c.mixDepolarising(1, 0.5), (1,)),
    "two_qubit_depolarising": (lambda c: c.mixTwoQubitDepolarising(4, 7, 0.6), (4, 7)),
    "damping": (lambda c: c.mixDamping(0, 0.4), (0,)),
    "pauli": (lambda c: c.mixPauli(6, 0.15, 0.1, 0.2), (6,)),
    "kraus_2t": (lambda c: c.mixTwoQubitKrausMap(3, 7, KRAUS_2T), (3, 7)),
}


def _ops(key):
    probs, targets = SITES[key]
    return tuple(channels.kraus_ops(key, *probs)), targets


def _state(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return v / np.linalg.norm(v)


def _pair(n, v, prec=2):
    jqr, tqr = jq.createQureg(n, JENV, prec), tq.createQureg(n, TENV, prec)
    jq.initStateFromAmps(jqr, v.real, v.imag)
    tq.initStateFromAmps(tqr, v.real, v.imag)
    return jqr, tqr


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _noisy(cls, n, add_channel):
    """Entangled n-qubit base and one channel site, as a density tape."""
    c = cls(n, is_density_matrix=True)
    for q in range(n):
        c.hadamard(q)
    for q in range(0, n - 1, 2):
        c.controlledNot(q, q + 1)
    c.rotateY(n // 2, 0.9)
    add_channel(c)
    c.rotateX(1, -0.4)
    return c


def _eight_qubit_noisy(cls=tq.Circuit):
    c = cls(8, is_density_matrix=True)
    for q in range(8):
        c.hadamard(q)
    c.controlledNot(0, 4)
    c.mixDepolarising(2, 0.3)
    c.rotateZ(5, 0.7)
    c.mixDamping(6, 0.25)
    c.mixTwoQubitDephasing(1, 3, 0.4)
    return c


def _reduced(rho, targets, n):
    """Partial trace of rho down to ``targets`` (targets[0] the low bit)."""
    t = len(targets)
    axes = [n - 1 - q for q in reversed(targets)]
    rest = [a for a in range(n) if a not in axes]
    x = rho.reshape((2,) * n * 2)
    x = x.transpose(axes + rest + [a + n for a in axes] + [a + n for a in rest])
    d, r = 2 ** t, 2 ** (n - t)
    return np.einsum("arbr->ab", x.reshape(d, r, d, r))


# ---------------------------------------------------------------------------
# the selection step against quest_tpu.trajectories.sample
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", sorted(SITES) + ["kraus_2t"])
def test_probabilities_and_selected_matrix_match_jax(key):
    n = 6
    if key == "kraus_2t":
        ops, targets = KRAUS_2T, (3, 5)
    else:
        ops, targets = _ops(key)
    v = _state(n, 11)
    amps = np.stack([v.real, v.imag])
    k = np.asarray([np.asarray(op, dtype=np.complex128) for op in ops])
    m = np.einsum("kli,klj->kij", k.conj(), k)
    mine = tsample.kraus_probabilities(torch.from_numpy(amps), m.real, m.imag, n=n,
                                       targets=targets)
    theirs = jsample.kraus_probabilities(jax.numpy.asarray(amps), m.real, m.imag, n=n,
                                         targets=targets)
    np.testing.assert_allclose(_np(mine), np.asarray(theirs), atol=F64_TOL, rtol=0)
    assert abs(float(mine.sum()) - 1.0) < F64_TOL
    for u in (0.0, 0.13, 0.5, 0.77, 0.999):
        km = tsample.traj_kraus_matrix(mine, torch.tensor(u, dtype=torch.float32),
                                       k.real, k.imag, torch.float64)
        jkm = jsample.traj_kraus_matrix(theirs, jax.numpy.float32(u), k.real, k.imag,
                                        jax.numpy.float64)
        np.testing.assert_allclose(_np(km), np.asarray(jkm), atol=F64_TOL, rtol=0)


@pytest.mark.parametrize("key", sorted(SITES) + ["kraus_2t"])
def test_apply_trajectory_kraus_matches_jax_per_seed(key):
    """A fixed (seed, site) takes the same Kraus operator in both packages:
    the states agree within 1e-10 in f64, and within 2e-4 in f32."""
    n = 6
    if key == "kraus_2t":
        ops, targets = KRAUS_2T, (3, 5)
    else:
        ops, targets = _ops(key)
    v = _state(n, 5)
    for prec, tol in ((2, F64_TOL), (1, F32_TOL)):
        for seed, site in ((0, 0), (1, 3), (7, 1), (123456789, 2), (2**32 - 5, 0)):
            jqr, tqr = _pair(n, v, prec)
            jq.applyTrajectoryKraus(jqr, targets, ops, seed, site=site)
            tq.applyTrajectoryKraus(tqr, targets, ops, seed, site=site)
            np.testing.assert_allclose(_np(tqr.amps), np.asarray(jqr.amps), atol=tol, rtol=0)
            assert abs(tq.calcTotalProb(tqr) - 1.0) < (1e-10 if prec == 2 else 1e-5)


def test_apply_trajectory_kraus_sharded_matches_one_device():
    """Over 4 CPU shards (a target above the shard boundary swaps into a
    local slot) the step draws the same operator as on one device."""
    n = 6
    ops, _ = _ops("two_qubit_depolarising")
    v = _state(n, 8)
    for targets in ((5, 1), (4, 5), (0, 2)):
        one = tq.createQureg(n, TENV, 2)
        four = tq.createQureg(n, TENV4, 2)
        for q in (one, four):
            tq.initStateFromAmps(q, v.real, v.imag)
            tq.applyTrajectoryKraus(q, targets, ops, 31, site=4)
        assert four.shards is not None
        got = torch.cat(list(four.shards), dim=1)
        np.testing.assert_allclose(_np(got), _np(one.amps), atol=F64_TOL, rtol=0)


def test_apply_trajectory_kraus_validation():
    dm = tq.createDensityQureg(2, TENV)
    ops = tuple(channels.kraus_ops("damping", 0.3))
    with pytest.raises(QuESTError, match="pure states"):
        tq.applyTrajectoryKraus(dm, (0,), ops, 1)
    sv = tq.createQureg(2, TENV)
    with pytest.raises(QuESTError):  # not CPTP
        tq.applyTrajectoryKraus(sv, (0,), (np.eye(2) * 0.5,), 1)
    with pytest.raises(QuESTError):  # a target out of range
        tq.applyTrajectoryKraus(sv, (2,), ops, 1)
    tq.initPlusState(sv)
    tq.applyTrajectoryKraus(sv, (0,), ops, seed=4, site=0)
    assert abs(tq.calcTotalProb(sv) - 1.0) < 1e-10


# ---------------------------------------------------------------------------
# unravel
# ---------------------------------------------------------------------------

def _mixed_tape(cls):
    c = cls(6, is_density_matrix=True)
    c.hadamard(0)
    c.mixDepolarising(1, 0.2)
    c.rotateY(2, 0.3)
    c.mixDamping(2, 0.1)
    c.mixPauli(3, 0.1, 0.05, 0.02)
    c.mixTwoQubitDephasing(0, 4, 0.3)
    c.mixTwoQubitDepolarising(5, 1, 0.4)
    c.mixDephasing(5, 0.25)
    c.mixKrausMap(0, channels.kraus_ops("damping", 0.2))
    c.mixTwoQubitKrausMap(1, 2, KRAUS_2T)
    c.mixMultiQubitKrausMap([3, 4], KRAUS_2T)
    return c


def test_unravel_matches_jax_entries_sites_and_seed_slot():
    mine, theirs = ttr.unravel(_mixed_tape(tq.Circuit)), jtr.unravel(_mixed_tape(JCircuit))
    assert not mine.is_density_matrix and len(mine) == len(theirs) == 11
    for (f, a, k), (jf, ja, jk) in zip(mine._tape, theirs._tape):
        assert f.__name__ == jf.__name__
        if f.__name__ != "applyTrajectoryKraus":
            continue
        assert tuple(a[0]) == tuple(ja[0]) and k == jk
        assert len(a[1]) == len(ja[1])
        for op, jop in zip(a[1], ja[1]):
            np.testing.assert_allclose(np.asarray(op), np.asarray(jop), atol=0, rtol=0)
        assert isinstance(a[2], P) and a[2].name == ja[2].name == ttr.SEED_PARAM
    sites = [k["site"] for f, _a, k in mine._tape if f.__name__ == "applyTrajectoryKraus"]
    assert sites == list(range(9))
    slots = mine.lifted().slots
    seed_slots = [s for s in slots if s.kind == "seed"]
    assert len(seed_slots) == 9 and {s.name for s in seed_slots} == {ttr.SEED_PARAM}
    assert [s.kind for s in slots] == [s.kind for s in theirs.lifted().slots]


def test_unravel_errors_and_explicit_seed():
    for add in (lambda c: c.mixNonTPKrausMap(0, [np.eye(2) * 0.5]),
                lambda c: c.mixNonTPTwoQubitKrausMap(0, 1, [np.eye(4) * 0.5]),
                lambda c: c.mixNonTPMultiQubitKrausMap([0, 1], [np.eye(4) * 0.5])):
        bad = tq.Circuit(2, is_density_matrix=True)
        add(bad)
        with pytest.raises(QuESTError, match="unravel"):
            ttr.unravel(bad)
    other = tq.createDensityQureg(2, TENV)
    bad = tq.Circuit(2, is_density_matrix=True)
    bad.append(tq.mixDensityMatrix, 0.5, other)
    with pytest.raises(QuESTError, match="mixDensityMatrix"):
        ttr.unravel(bad)
    with pytest.raises(QuESTError, match="seed Param"):
        ttr.run_ensemble(tq.Circuit(2), 4, env=TENV)  # no channel sites
    c = tq.Circuit(3, is_density_matrix=True)
    c.mixDamping(0, 0.2)
    u = ttr.unravel(c, seed=P("mine"))
    assert u._tape[0][1][2] == P("mine")
    with pytest.raises(QuESTError, match="num_trajectories"):
        ttr.run_ensemble(u, 0, env=TENV)
    with pytest.raises(QuESTError, match="non-empty"):
        ttr.run_ensemble(u, env=TENV, seeds=[])


def test_constant_seed_variants_share_fingerprint():
    def build(seed, site=0):
        c = tq.Circuit(6)
        for q in range(6):
            c.hadamard(q)
        c.applyTrajectoryKraus((2,), tuple(channels.kraus_ops("depolarising", 0.3)), seed,
                               site=site)
        return c
    assert build(0).fingerprint() == build(987654).fingerprint()
    assert build(0, 0).fingerprint() != build(0, 1).fingerprint()


# ---------------------------------------------------------------------------
# the ensemble
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channel", sorted(CHANNEL_CASES))
def test_ensemble_mean_converges_to_density_oracle(channel):
    n = 8
    add, targets = CHANNEL_CASES[channel]
    jc = _noisy(JCircuit, n, add)
    dm = jq.createDensityQureg(n, JENV, 2)
    jc.run(dm)
    rho = get_density(dm)

    res = ttr.run_ensemble(_noisy(tq.Circuit, n, add), T_CONV, env=TENV, base_seed=17,
                           precision_code=2)
    assert res.num_trajectories == T_CONV and res.seed_name == ttr.SEED_PARAM
    assert res.states.dtype == torch.float64 and tuple(res.states.shape) == (T_CONV, 2, 1 << n)
    norms = (res.states.to(torch.float64) ** 2).sum(dim=(1, 2)).numpy()
    np.testing.assert_allclose(norms, 1.0, atol=1e-10)
    rho_e = res.density()
    assert abs(np.trace(rho_e) - 1.0) < 1e-10
    assert np.max(np.abs(rho_e - rho)) < TOL_CONV
    assert np.max(np.abs(_reduced(rho_e, list(targets), n)
                         - _reduced(rho, list(targets), n))) < TOL_CONV
    np.testing.assert_array_equal(rho_e, tq.ensemble_density(res.states))


def test_ensemble_matches_jax_ensemble_per_seed():
    """The same seeds walk the same Kraus paths in both packages (f64)."""
    seeds = [3, 17, 99, 2024]
    mine = ttr.run_ensemble(_eight_qubit_noisy(), env=TENV, seeds=seeds, precision_code=2)
    theirs = jtr.run_ensemble(_eight_qubit_noisy(JCircuit), env=JENV, seeds=seeds,
                              precision_code=2)
    np.testing.assert_allclose(_np(mine.states), np.asarray(theirs.states), atol=F64_TOL,
                               rtol=0)


@pytest.mark.parametrize("prec", [2, 1])
def test_fixed_seed_replay_bit_identical_raw_and_fused(prec):
    dt = torch.float64 if prec == 2 else torch.float32
    u = ttr.unravel(_eight_qubit_noisy())
    fz = u.fused(max_qubits=5, pallas=True, dtype=dt)
    assert any(getattr(f, "__name__", "") == "_apply_pallas_run" for f, _a, _k in fz._tape)
    seeds = [11, 22, 33, 44, 55, 66]
    for circ in (u, fz):
        a = ttr.run_ensemble(circ, env=TENV, seeds=seeds, precision_code=prec)
        b = ttr.run_ensemble(circ, env=TENV, seeds=seeds, precision_code=prec)
        assert a.states.dtype == dt
        assert torch.equal(a.states, b.states)
        assert a.seeds == tuple(seeds)
    raw = ttr.run_ensemble(u, env=TENV, seeds=seeds, precision_code=prec).states
    fused = ttr.run_ensemble(fz, env=TENV, seeds=seeds, precision_code=prec).states
    tol = F64_TOL if prec == 2 else F32_TOL
    np.testing.assert_allclose(_np(fused), _np(raw), atol=tol, rtol=0)


@pytest.mark.parametrize("fused", [False, True])
def test_lanes_equal_seeds_served_alone(fused):
    """A lane's trajectory depends only on its seed: each seed served alone
    through the same lane-batched executable gives its lane of the
    coalesced batch bit for bit; the one-state program (max_batch=1)
    agrees within tolerance (torch's batched and single products may
    accumulate in another order)."""
    u = ttr.unravel(_eight_qubit_noisy())
    if fused:
        u = u.fused(max_qubits=5, pallas=True, dtype=torch.float64)
    seeds = [3, 1, 4, 1, 5, 9]
    batched = ttr.run_ensemble(u, env=TENV, seeds=seeds, precision_code=2).states
    with Engine(u, TENV, precision_code=2, max_batch=len(seeds), max_delay_ms=0.0) as eng:
        alone = [eng.submit({ttr.SEED_PARAM: s}).result(WAIT) for s in seeds]
    for i in range(len(seeds)):
        assert torch.equal(batched[i], alone[i])
    seq = ttr.run_ensemble(u, env=TENV, seeds=seeds, precision_code=2, max_batch=1).states
    np.testing.assert_allclose(_np(seq), _np(batched), atol=F64_TOL, rtol=0)


@pytest.mark.parametrize("fused", [False, True])
def test_ensemble_body_is_capturable(fused):
    """The lane-batched trajectory body replays under
    ``_capture.rehearsal()`` (as the card captures it: staging frozen, host
    copies and syncs raise) to the same bits as its eager run: the seed
    reaches each site as a tensor of the graph's value buffer."""
    from quest_tpu_torch import _capture
    from quest_tpu_torch.engine.engine import _BatchFn
    from quest_tpu_torch.engine.params import bind_host, stack_values

    u = ttr.unravel(_eight_qubit_noisy())
    if fused:
        u = u.fused(max_qubits=5, pallas=True, dtype=torch.float64)
    lifted = u.lifted()
    fn = _BatchFn(u, lifted, None)
    rows = [bind_host(lifted, {ttr.SEED_PARAM: s}) for s in (8, 9, 10)]
    vals = stack_values(lifted, rows, True, pad_to=4)
    assert vals.tensors["seed"].dtype == torch.int64
    x = torch.zeros(2, 1 << 8, dtype=torch.float64)
    x[0, 0] = 1
    eager = fn(x, vals, 3)
    with _capture.rehearsal():
        again = fn(x, vals, 3)
    assert all(torch.equal(a, b) for a, b in zip(eager, again))
    assert not torch.equal(eager[0], eager[1])  # each lane its own stream
    fn.close()


def test_sharded_ensemble_matches_one_device():
    u = ttr.unravel(_eight_qubit_noisy())
    seeds = [101, 202, 303]
    one = ttr.run_ensemble(u, env=TENV, seeds=seeds, precision_code=2).states
    mesh_a = ttr.run_ensemble(u, env=TENV4, seeds=seeds, precision_code=2).states
    mesh_b = ttr.run_ensemble(u, env=TENV4, seeds=seeds, precision_code=2).states
    assert torch.equal(mesh_a, mesh_b)
    np.testing.assert_allclose(_np(mesh_a), _np(one), atol=F64_TOL, rtol=0)


def test_new_seeds_zero_retraces():
    u = ttr.unravel(_eight_qubit_noisy())
    ttr.run_ensemble(u, env=TENV, seeds=[1, 2, 3, 4])
    before = telemetry.counter_value("engine_trace_total", kind="param_replay")
    out = ttr.run_ensemble(u, env=TENV, seeds=[7_000_001, 42, 0, 123456789])
    assert telemetry.counter_value("engine_trace_total", kind="param_replay") == before
    assert out.states.shape[0] == 4


def test_shot_tables_match_jax():
    """``shots=`` draws each trajectory's table in the Engine's finalize;
    f64 tables equal quest_tpu's shot for shot."""
    seeds = [5, 6, 7]
    kw = dict(seeds=seeds, precision_code=2, shots=64, shot_targets=(0, 2, 6), shot_seed=9)
    mine = ttr.run_ensemble(_eight_qubit_noisy(), env=TENV, **kw)
    theirs = jtr.run_ensemble(_eight_qubit_noisy(JCircuit), env=JENV, **kw)
    assert mine.states is None and tuple(mine.shot_tables.shape) == (3, 64)
    assert mine.shot_tables.dtype == torch.int32
    np.testing.assert_array_equal(_np(mine.shot_tables), np.asarray(theirs.shot_tables))
    with pytest.raises(QuESTError, match="shot tables"):
        mine.density()
    with pytest.raises(QuESTError, match="shots"):
        ttr.run_ensemble(_eight_qubit_noisy(), env=TENV, seeds=seeds, shots=0)


# ---------------------------------------------------------------------------
# diagnostics and counters
# ---------------------------------------------------------------------------

def test_qt501_malformed_env_warns_once(monkeypatch):
    monkeypatch.setattr(tens, "_ENV_WARNED", set())
    monkeypatch.setenv("QUEST_TRAJECTORIES", "not-a-number")
    before = telemetry.counter_value("analysis_findings_total", code="QT501",
                                     severity="warning")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert ttr.trajectory_count_default() == ttr.DEFAULT_TRAJECTORIES
        assert ttr.trajectory_count_default() == ttr.DEFAULT_TRAJECTORIES
    assert len([w for w in rec if "QT501" in str(w.message)]) == 1
    assert telemetry.counter_value("analysis_findings_total", code="QT501",
                                   severity="warning") == before + 1
    monkeypatch.setenv("QUEST_TRAJECTORIES", "0")
    with warnings.catch_warnings(record=True) as rec2:
        warnings.simplefilter("always")
        assert ttr.trajectory_count_default() == 1
    assert any("QT501" in str(w.message) for w in rec2)
    monkeypatch.setenv("QUEST_TRAJECTORIES", "5")
    assert ttr.trajectory_count_default() == 5
    c = tq.Circuit(3, is_density_matrix=True)
    c.mixDamping(0, 0.3)
    assert ttr.run_ensemble(c, env=TENV).num_trajectories == 5


def test_trajectory_counters_increment():
    c = tq.Circuit(3, is_density_matrix=True)
    c.hadamard(0)
    c.mixDephasing(1, 0.2)
    c.mixDamping(2, 0.3)
    ch0 = telemetry.counter_value("trajectory_channels_total", channel="damping")
    runs0 = telemetry.counter_value("trajectory_runs_total")
    sites0 = telemetry.counter_value("trajectory_sites_total")
    ens0 = telemetry.counter_value("trajectory_ensembles_total")
    res = ttr.run_ensemble(c, 5, env=TENV, base_seed=2)
    assert telemetry.counter_value("trajectory_channels_total", channel="damping") == ch0 + 1
    assert telemetry.counter_value("trajectory_runs_total") - runs0 == 5
    assert telemetry.counter_value("trajectory_sites_total") - sites0 == 10
    assert telemetry.counter_value("trajectory_ensembles_total") - ens0 == 1
    shots0 = telemetry.counter_value("sample_shots_total")
    ttr.run_ensemble(c, 5, env=TENV, base_seed=2, shots=8)
    assert telemetry.counter_value("sample_shots_total") - shots0 == 40
    np.testing.assert_array_equal(res.density(), tq.ensemble_density(res.states))
