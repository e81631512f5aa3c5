"""Sampling, mid-circuit measurement, gradients and serving over shards:
quest_tpu_torch on a mesh of virtual CPU shards (``createQuESTEnv(devices=
["cpu"] * d)``, d = 2 and 4) against the port on one device and against
quest_tpu on d of its emulated CPU devices.

- shot tables: a dyadic circuit's fixed-seed tables bit for bit across one
  device, 2 and 4 shards and quest_tpu's mesh route (f64, f32); a generic
  circuit's over every qubit and over a subset that mixes sharded and
  local targets, a shot differing only where its draw lies within
  EDGE_ULPS of an edge of either layout's CDF (the count is printed);
  density registers; no state and no 2^n marginal moved to the first
  shard (every ``Tensor.to`` of the sampler counted); the df route of
  quest_tpu (its switch ``pallas_df._DF_ENV`` set) against the port's
  native f64;
- ``sample_request`` on a sharded plan with a Pauli sum and with a
  mid-circuit measurement: one ``route=request`` dispatch, O(S) bytes to
  the host, the body capturable (``_capture.rehearsal``);
- ``applyMidMeasurement`` / ``applyMidCollapse`` on a local and a sharded
  target, state vector and density, within 1e-10 of quest_tpu's mesh;
- ``Circuit.gradient`` and ``calcGradExpecPauliSum`` over shards: the
  value bit for bit that of one device where no dense gate targets a
  sharded qubit (the pair exchange adds in another order: 1e-14 then),
  the gradients within 1e-12 of one device and of quest_tpu's
  explicit-mesh route;
- the Engine over shards: ``submit_grad``, a shot-table ``finalize``,
  ``run_ensemble(shots=)``, a density circuit (a batch equal to a loop of
  single requests bit for bit, within 1e-12 of one device) and
  ``EnginePool.submit`` of it.

Every ``result()`` has a timeout.
"""

import jax
import numpy as np
import pytest
import torch

import quest_tpu as jq
from bench import serving_ansatz as j_serving_ansatz
from quest_tpu.circuits import Circuit as JCircuit
from quest_tpu.engine import Engine as JEngine
from quest_tpu.engine import P as JP
from quest_tpu.ops import init as j_init
from quest_tpu.ops import pallas_df as PDF
from quest_tpu.sampling import request as jrq
from quest_tpu.sampling import sampler as jsp
import quest_tpu_torch as tq
from quest_tpu_torch import _capture, telemetry
from quest_tpu_torch.engine import Engine, P
from quest_tpu_torch.interop import state_to_numpy
from quest_tpu_torch.ops import measure as M
from quest_tpu_torch.sampling import request as rq
from quest_tpu_torch.sampling import rng
from quest_tpu_torch.sampling import sampler as sp
from quest_tpu_torch.trajectories import run_ensemble

from .test_torch_sampling import _edge_misses

TENV = tq.createQuESTEnv(device="cpu")
WAIT = 60  # seconds any result() may take
LAYOUTS = (2, 4)
PRECISIONS = (2, 1)


def _envs(d):
    return jq.createQuESTEnv(jax.devices()[:d]), tq.createQuESTEnv(devices=["cpu"] * d)


def _dyadic(mod, q):
    """Outcome probabilities k 2^-m: every layout's float32 CDF is exact."""
    mod.hadamard(q, 0)
    mod.controlledNot(q, 0, 1)
    mod.hadamard(q, 3)
    mod.pauliX(q, 5)


def _generic(mod, q):
    n = q.num_qubits_represented
    for k in range(n):
        mod.rotateY(q, k, 0.3 + 0.41 * k)
    mod.controlledNot(q, 0, n - 1)
    mod.rotateX(q, 3, 1.3)


def _tables(p: np.ndarray, bb: int):
    """The port's (row_cdf, block_cdf) of the float32 marginal ``p`` on the
    (2^bb, L) split."""
    row = sp._monotone(sp._add_scan(torch.tensor(p).reshape(1 << bb, -1)))
    return row.numpy(), sp._monotone(sp._add_scan(row[:, -1])).numpy()


# ---------------------------------------------------------------------------
# shot tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec", PRECISIONS)
@pytest.mark.parametrize("d", LAYOUTS)
def test_dyadic_tables_bit_for_bit_across_layouts(d, prec):
    """One device, d shards and quest_tpu on d devices: the same table for
    every target set (the subsets mix sharded and local targets) and seed."""
    jenv, tenv = _envs(d)
    one, sh, jqr = (tq.createQureg(6, TENV, prec), tq.createQureg(6, tenv, prec),
                    jq.createQureg(6, jenv, prec))
    for mod, q in ((tq, one), (tq, sh), (jq, jqr)):
        _dyadic(mod, q)
    assert sh.shards is not None and len(sh.shards) == d
    for targets in (None, (3, 0, 5), (5, 4), (1, 2)):
        for seed in (42, 7):
            want = tq.sampleQureg(one, targets=targets, shots=1000, seed=seed)
            got = tq.sampleQureg(sh, targets=targets, shots=1000, seed=seed)
            assert np.array_equal(got, want), (targets, seed)
            assert np.array_equal(got, jq.sampleQureg(jqr, targets=targets, shots=1000,
                                                      seed=seed)), (targets, seed)


@pytest.mark.parametrize("prec", PRECISIONS)
@pytest.mark.parametrize("d", LAYOUTS)
def test_generic_tables_under_the_edge_rule(d, prec, capsys):
    """A generic 8-qubit state: over every qubit in order the split and the
    float32 marginal are one device's, so the tables are equal; over a
    subset whose sharded target is the outcome's low bit the split differs,
    and a shot may differ only at an edge of either layout's CDF."""
    _, tenv = _envs(d)
    one, sh = tq.createQureg(8, TENV, prec), tq.createQureg(8, tenv, prec)
    for q in (one, sh):
        _generic(tq, q)
    shots, seed = 20000, 2026
    u = rng.uniform(sp.shot_key(seed, 0), (shots,)).numpy()
    nl = sh.num_local_qubits
    for targets in (tuple(range(8)), (7, 2, 5, 0), (6, 1, 7, 3, 4)):
        got = tq.sampleQureg(sh, targets=targets, shots=shots, seed=seed)
        want = tq.sampleQureg(one, targets=targets, shots=shots, seed=seed)
        p = M.prob_of_all_outcomes(one.amps, n=8, targets=targets).to(torch.float32).numpy()
        norm = np.float32(float(tq.calcTotalProb(one)))
        draws = (u * norm).astype(np.float32)
        t = len(targets)
        bb_sh = sp._shard_block_bits(t, d, [k for k, q in enumerate(targets) if q >= nl])
        tables = [(_tables(p, t // 2), draws), (_tables(p, bb_sh), draws)]
        ndiff, misses = _edge_misses(draws, got, want, tables)
        with capsys.disabled():
            print(f"\n[{d} shards prec {prec} targets {targets}] {ndiff} of {shots} shots "
                  f"differ from one device's (split 2^{bb_sh} blocks against 2^{t // 2})")
        assert misses == 0, f"{misses} of {ndiff} differing shots are not at an edge"
        if targets == tuple(range(8)):
            assert ndiff == 0


@pytest.mark.parametrize("d", LAYOUTS)
def test_density_sampling_over_shards(d, capsys):
    """A density register over d shards: the dyadic tables equal one
    device's and quest_tpu's mesh route; a depolarised register's under
    the edge rule; the marginal equal to the gathered diagonal's."""
    jenv, tenv = _envs(d)
    one, sh = tq.createDensityQureg(4, TENV, 2), tq.createDensityQureg(4, tenv, 2)
    jqr = jq.createDensityQureg(4, jenv, 2)
    for mod, q in ((tq, one), (tq, sh), (jq, jqr)):
        mod.hadamard(q, 0)
        mod.controlledNot(q, 0, 1)
        mod.hadamard(q, 3)
        mod.mixDephasing(q, 1, 0.3)
    for targets in (None, (3, 0), (2, 3, 1)):
        want = tq.sampleQureg(one, targets=targets, shots=800, seed=11)
        assert np.array_equal(tq.sampleQureg(sh, targets=targets, shots=800, seed=11), want)
        assert np.array_equal(jq.sampleQureg(jqr, targets=targets, shots=800, seed=11), want)
    for q in (one, sh):
        tq.mixDepolarising(q, 2, 0.1)
        tq.rotateY(q, 3, 0.7)
    shots = 8000
    got = tq.sampleQureg(sh, targets=(3, 1, 0), shots=shots, seed=5)
    want = tq.sampleQureg(one, targets=(3, 1, 0), shots=shots, seed=5)
    p = M.density_prob_of_all_outcomes(one.amps, n=4, targets=(3, 1, 0))
    p_sh = M.density_prob_of_all_outcomes_shards(sh.shards, n=4, targets=(3, 1, 0))
    np.testing.assert_allclose(p_sh.numpy(), p.numpy(), rtol=0, atol=1e-14)
    u = rng.uniform(sp.shot_key(5, 0), (shots,)).numpy()
    draws = (u * np.float32(float(tq.calcTotalProb(one)))).astype(np.float32)
    pf = p.to(torch.float32).numpy()
    tables = [(_tables(pf, 1), draws), (_tables(pf, 3), draws), (_tables(pf, 2), draws)]
    ndiff, misses = _edge_misses(draws, got, want, tables)
    with capsys.disabled():
        print(f"\n[density {d} shards] {ndiff} of {shots} shots differ from one device's")
    assert misses == 0


@pytest.mark.parametrize("targets", [None, (7, 2, 5, 0)])
def test_sampler_moves_neither_state_nor_marginal_to_the_first_shard(targets, monkeypatch):
    """Every ``Tensor.to`` the sharded sampler makes is counted: none moves
    more than max(S, B) elements (the shot vectors, the block totals), and
    all of them together stay below the state's and the marginal's size."""
    _, tenv = _envs(4)
    q = tq.createQureg(10, tenv, 1)
    _generic(tq, q)
    shots = 64
    moved = []
    real_to = torch.Tensor.to

    def counting_to(self, *args, **kwargs):
        out = real_to(self, *args, **kwargs)
        if any(isinstance(a, (torch.device, str)) for a in args) or "device" in kwargs:
            moved.append(self.numel())
        return out

    monkeypatch.setattr(torch.Tensor, "to", counting_to)
    u = rng.uniform(sp.shot_key(3, 0), (shots,))
    t = 10 if targets is None else len(targets)
    table = sp.draw_outcomes_shards(q.shards, u, n=10,
                                    targets=tuple(range(10)) if targets is None else targets,
                                    norm=torch.tensor(1.0))
    monkeypatch.undo()
    bb = t // 2 if targets is None else t
    assert table.shape == (shots,) and 0 <= int(table.min()) and int(table.max()) < 1 << t
    assert moved and max(moved) <= max(shots, 1 << bb, 4), moved
    if targets is None:
        # the 2^10 marginal is never assembled: the block totals (2^5) and
        # the shot vectors cross, per part
        assert sum(moved) < 1 << 12 and max(moved) < 1 << 10


def test_shot_stage_pieces_match_one_device(monkeypatch):
    """A shard larger than 2^CHUNK_BITS amplitudes is reduced in pieces: the
    f32 marginals (every local target set), the norm and the tables keep
    the one-device bits, and the piece size changes no bit."""
    from quest_tpu_torch.ops import reduce as R
    _, tenv = _envs(4)
    one, sh = tq.createQureg(9, TENV, 1), tq.createQureg(9, tenv, 1)
    for q in (one, sh):
        _generic(tq, q)
    targets_sets = ((0, 1, 2), (6, 3), (8, 0, 4), tuple(range(9)))
    whole = [tq.sampleQureg(sh, targets=t, shots=3000, seed=9) for t in targets_sets]
    monkeypatch.setattr(R, "CHUNK_BITS", 3)
    assert float(R.total_prob_shards(sh.shards)) == float(R.total_prob_statevec(one.amps))
    for targets, w in zip(targets_sets, whole):
        p = M.prob_of_all_outcomes(one.amps, n=9, targets=targets)
        assert torch.equal(M.prob_of_all_outcomes_shards(sh.shards, n=9, targets=targets), p)
        got = sp.sample_statevec(list(sh.shards), n=9, targets=targets, shots=3000, seed=9)
        assert np.array_equal(got.numpy(), w)
        assert np.array_equal(w, tq.sampleQureg(one, targets=targets, shots=3000, seed=9))


def test_order_key_orders_as_the_floats():
    """The sharded search's keys: for float32 values of either sign, zeros
    of both signs, subnormals and extremes, key(x) <= key(y) exactly when
    x <= y, and every key lies in [0, 2^32)."""
    r = np.random.RandomState(8)
    vals = np.concatenate([
        r.normal(size=200) * 10.0 ** r.randint(-40, 38, size=200),
        [0.0, -0.0, 1e-45, -1e-45, 3.4e38, -3.4e38, 1.0, -1.0, 0.5, 0.5]]).astype(np.float32)
    k = sp._order_key(torch.tensor(vals)).numpy()
    assert k.min() >= 0 and k.max() < 1 << 32
    assert np.array_equal(k[:, None] <= k[None, :], vals[:, None] <= vals[None, :])


def test_df_route_tables_equal_native_f64(monkeypatch):
    """Queue A 9.8: quest_tpu's df route (its switch ``pallas_df._DF_ENV``
    set to 1: the fused double-float circuit, the sampler on top) and the
    port's native f64, on one device and on 4 shards, draw the same table.
    The switch is named through the constant, so this port file does not
    count as a test of quest_tpu's df route in its surface audit."""
    monkeypatch.setenv(PDF._DF_ENV, "1")
    assert PDF.df_wanted()
    c = JCircuit(6)
    c.hadamard(0)
    c.controlledNot(0, 1)
    c.hadamard(3)
    c.pauliX(5)
    amps = c.fused(pallas=True).compiled(donate=False)(
        j_init.init_classical(1 << 6, np.dtype("float32"), 0))
    want = np.asarray(jsp.sample_jit(amps, np.uint32(7), n=6, targets=tuple(range(6)),
                                     shots=500))
    for env in (TENV, _envs(4)[1]):
        q = tq.createQureg(6, env, 2)
        _dyadic(tq, q)
        assert np.array_equal(tq.sampleQureg(q, shots=500, seed=7), want)


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------

def _request_circuit(n, mid, circuit=tq.Circuit, PP=P, dyadic=False):
    """The request's tape; ``dyadic`` leaves out its one rotation, so every
    outcome probability is k 2^-m and every layout's float32 CDF exact."""
    c = circuit(n)
    c.hadamard(0)
    c.controlledNot(0, 1)
    c.hadamard(3)
    c.controlledNot(3, n - 1)
    if not dyadic:
        c.rotateY(2, 0.7)
    if mid is not None:
        c.applyMidMeasurement(mid, PP("m"), site=1)
        c.hadamard(mid)
    return c


@pytest.mark.parametrize("mid", [None, 1, 5])
def test_sample_request_over_shards(mid):
    """A request on a plan for 4 shards, with a Pauli sum and with a
    mid-circuit measurement on a local (1) or a sharded (5) qubit: one
    ``route=request`` dispatch a call, O(S) bytes to the host, the table
    and the expectation of the one-device request, a capturable body; the
    expectation within 1e-12 of quest_tpu's request on 4 devices, and on
    the dyadic tape the table bit for bit quest_tpu's."""
    n, shots = 6, 512
    jenv, tenv = _envs(4)
    codes, coeffs = [[3, 0, 1, 0, 0, 2], [0, 3, 0, 0, 1, 3]], [0.6, -0.25]
    circ = _request_circuit(n, mid)
    plan = circ.fused(max_qubits=3, pallas=True, dtype=torch.float64, shard_devices=4)
    exe = rq.sample_request(plan, shots=shots, donate=False, pauli_codes=codes, coeffs=coeffs)
    ref = rq.sample_request(circ, shots=shots, donate=False, pauli_codes=codes, coeffs=coeffs)
    zero = tq.createQureg(n, tenv, 2)
    before = telemetry.counter_value("device_dispatch_total", route="request")
    out = rq.to_host(exe(list(zero.shards), 5))
    assert telemetry.counter_value("device_dispatch_total", route="request") - before == 1
    assert telemetry.gauge_value("sample_host_transfer_bytes") == out["shots"].nbytes + 8
    want = rq.to_host(ref(tq.createQureg(n, TENV, 2).amps, 5))
    assert np.array_equal(out["shots"], want["shots"])
    assert abs(float(out["expec"]) - float(want["expec"])) <= 1e-12
    if mid is not None:  # every shot carries the drawn outcome: H after it
        assert len(set(((out["shots"] >> mid) & 1).tolist())) == 2
    with _capture.rehearsal():
        again = rq.to_host(exe(list(zero.shards), 5))
    assert np.array_equal(again["shots"], out["shots"])
    for dyadic in (False, True):
        jexe = jrq.sample_request(_request_circuit(n, mid, JCircuit, JP, dyadic), shots=shots,
                                  donate=False, pauli_codes=codes, coeffs=coeffs)
        theirs = jrq.to_host(jexe(jq.createQureg(n, jenv, 2).amps, 5))
        if dyadic:
            plan = _request_circuit(n, mid, dyadic=True).fused(
                max_qubits=3, pallas=True, dtype=torch.float64, shard_devices=4)
            mine = rq.to_host(rq.sample_request(plan, shots=shots, donate=False,
                                                pauli_codes=codes, coeffs=coeffs)(
                list(tq.createQureg(n, tenv, 2).shards), 5))
            assert np.array_equal(mine["shots"], theirs["shots"])
        else:
            mine = out
        assert abs(float(mine["expec"]) - float(theirs["expec"])) <= 1e-12


# ---------------------------------------------------------------------------
# mid-circuit measurement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("density", [False, True])
@pytest.mark.parametrize("where", ["local", "sharded"])
def test_mid_measurement_over_shards_against_quest_tpu(where, density):
    """``applyMidMeasurement`` then ``applyMidCollapse`` on a 4-shard
    register (the measured qubit below or at the shard boundary; for a
    density register the boundary cuts its column qubits) against
    quest_tpu on 4 devices and the port on one, within 1e-10."""
    n = 4 if density else 5
    jenv, tenv = _envs(4)
    mk = "createDensityQureg" if density else "createQureg"
    jqr, sh, one = (getattr(jq, mk)(n, jenv, 2), getattr(tq, mk)(n, tenv, 2),
                    getattr(tq, mk)(n, TENV, 2))
    target = 0 if where == "local" else n - 1
    # the qubit the shard index cuts: the target's, or its column qubit's
    cut = target + (n if density else 0)
    assert (cut >= sh.num_local_qubits) == (where == "sharded")
    for mod, q in ((jq, jqr), (tq, sh), (tq, one)):
        _generic(mod, q)
        if density:
            mod.mixDepolarising(q, 1, 0.1)
    for seed in (1, 2, 3):
        for mod, q in ((jq, jqr), (tq, sh), (tq, one)):
            mod.applyMidMeasurement(q, target, seed)
            mod.hadamard(q, target)
        np.testing.assert_allclose(state_to_numpy(sh), np.asarray(jqr.amps), rtol=0, atol=1e-10)
        np.testing.assert_allclose(state_to_numpy(sh), state_to_numpy(one), rtol=0, atol=1e-12)
    for mod, q in ((jq, jqr), (tq, sh)):
        mod.applyMidCollapse(q, n - 1 - target, 1)
    np.testing.assert_allclose(state_to_numpy(sh), np.asarray(jqr.amps), rtol=0, atol=1e-10)
    assert abs(tq.calcTotalProb(sh) - 1) <= 1e-12


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

def _grad_tape(c, p, vector):
    n = c.num_qubits
    for q in range(n):
        c.rotateY(q, 0.3 + 0.17 * q)
    c.rotateX(0, p("a"))
    c.rotateY(n - 1, p("b"))
    c.controlledRotateZ(n - 1, 1, p("c"))
    c.controlledNot(0, n - 1)
    c.swapGate(0, n - 1)
    c.multiRotatePauli([0, n - 2, n - 1], [1, 2, 3], p("d"))
    c.phaseShift(n - 1, p("e"))
    c.controlledPhaseShift(0, n - 1, 0.3)
    c.rotateAroundAxis(n - 2, p("f"), vector(1.0, 2.0, 3.0))
    c.compactUnitary(n - 1, 0.6 + 0.0j, 0.8j)


def _local_tape(c, p, vector):
    """Dense gates on the low qubits only (local on 2 and 4 shards), the
    sharded qubits reached by diagonal and parity gates and by CNOT."""
    del vector
    for q in range(4):
        c.rotateY(q, 0.3 + 0.17 * q)
    c.rotateX(0, p("a"))
    c.rotateY(3, p("b"))
    c.controlledRotateZ(5, 1, p("c"))
    c.controlledNot(2, 5)
    c.multiRotateZ([0, 4, 5], p("d"))
    c.phaseShift(5, p("e"))
    c.controlledRotateX(4, 2, p("f"))


_HAM = ([[3, 0, 0, 0, 0, 1], [1, 1, 0, 2, 0, 3], [0, 0, 2, 0, 3, 0]], [0.7, -0.4, 0.25])
_PARAMS = dict(a=0.3, b=1.1, c=-0.7, d=0.45, e=0.9, f=-1.3)


def _expectation_layouts(d):
    """The forward value's fold: the same bits for the same amplitudes on
    one device and cut into d shards, whatever the operand bits."""
    from quest_tpu_torch.gradients import expectation_value
    r = np.random.RandomState(3)
    psi, lam = torch.tensor(r.normal(size=(2, 64))), torch.tensor(r.normal(size=(2, 64)))
    cut = [list(x.chunk(d, dim=1)) for x in (psi, lam)]
    return float(expectation_value(psi, lam)), float(expectation_value(*cut))


@pytest.mark.parametrize("tape", ["local", "mixed"])
@pytest.mark.parametrize("d", LAYOUTS)
def test_gradient_over_shards(d, tape):
    """``Circuit.gradient`` on d shards against one device and quest_tpu's
    explicit-mesh route. The forward value's fold has the same bits on any
    layout, so where the forward state has them too (no dense gate on a
    sharded qubit: the "local" tape) the value is one device's bit for
    bit; a dense gate on a sharded qubit is the pair exchange's blend
    (``parallel.exchange.dist_apply_matrix1``), which adds its four
    products in another order than ``ops.apply``'s matmul, and the "mixed"
    tape's value is then held within 1e-14. Gradients within 1e-12 of one
    device and of quest_tpu; calcGradExpecPauliSum on a sharded register
    the same."""
    n = 6
    jenv, tenv = _envs(d)
    one_fold, cut_fold = _expectation_layouts(d)
    assert one_fold == cut_fold
    build = _local_tape if tape == "local" else _grad_tape
    tc, jc = tq.Circuit(n), JCircuit(n)
    build(tc, P, tq.Vector)
    build(jc, JP, jq.Vector)
    params = {k: v for k, v in _PARAMS.items() if k in tc.param_names}
    one = tc.gradient(_HAM, donate=False)(tq.createQureg(n, TENV, 2).amps, params)
    sh = tq.createQureg(n, tenv, 2)
    got = tc.gradient(_HAM, donate=False)(list(sh.shards), params)
    if tape == "local":
        assert float(got["value"]) == float(one["value"])
    assert abs(float(got["value"]) - float(one["value"])) <= 1e-14
    with jq.explicit_mesh(jenv.mesh):
        jqr = jq.createQureg(n, jenv)
        want = jc.gradient(_HAM, donate=False)(jqr.amps, params)
    assert abs(float(got["value"]) - float(want["value"])) <= 1e-12
    for k in params:
        assert abs(float(got["grads"][k]) - float(one["grads"][k])) <= 1e-12
        assert abs(float(got["grads"][k]) - float(want["grads"][k])) <= 1e-12
    value, grads = tq.calcGradExpecPauliSum(sh, tc, np.asarray(_HAM[0]).ravel(), _HAM[1],
                                            params)
    assert value == float(got["value"])
    assert all(abs(grads[k] - float(one["grads"][k])) <= 1e-12 for k in params)


# ---------------------------------------------------------------------------
# serving over shards
# ---------------------------------------------------------------------------

def _dyadic_params(c, PP):
    """:func:`_dyadic` with two Param phases: the outcome probabilities
    stay k 2^-m for any angles."""
    c.hadamard(0)
    c.phaseShift(0, PP("s"))
    c.controlledNot(0, 1)
    c.hadamard(3)
    c.rotateZ(3, PP("z"))
    c.pauliX(5)
    return c


def _jax_shots(amps):
    """quest_tpu's Engine finalize (one argument): its shot-table reduce
    with seed 0, as the port's ``sample_reduce`` draws by default."""
    return jrq.sample_reduce(n=6, targets=(5, 0, 3), shots=64)(amps, 0)


def test_engine_gradients_shots_and_ensembles_over_shards():
    """On 4 shards: ``submit_grad`` (value and gradients within 1e-12 of the
    one-device Engine's and of quest_tpu's Engine on 4 devices), a
    shot-table ``finalize`` (the one-device tables; on a dyadic tape also
    quest_tpu's Engine's on 4 devices, bit for bit) and
    ``run_ensemble(shots=)`` (the one-device ensemble's tables)."""
    n = 6
    jenv, tenv = _envs(4)
    circ = tq.serving_ansatz(n, 2)
    r = np.random.RandomState(1)
    sweep = [dict(zip(circ.param_names, r.uniform(0, 6, len(circ.param_names))))
             for _ in range(3)]
    ham = (_HAM[0][:2], _HAM[1][:2])
    engines = [Engine(circ, env, precision_code=2, hamiltonian=ham, max_batch=mb)
               for env, mb in ((TENV, 1), (tenv, 4))]
    jeng = JEngine(j_serving_ansatz(n, 2), jenv, precision_code=2, hamiltonian=ham,
                   max_batch=4)
    try:
        assert engines[1].sharded and jeng.sharded
        outs = [[f.result(WAIT) for f in [e.submit_grad(p) for p in sweep]]
                for e in engines + [jeng]]
        for (v1, g1), (v4, g4), (jv, jg) in zip(*outs):
            assert abs(float(v1) - float(v4)) <= 1e-12
            assert abs(float(jv) - float(v4)) <= 1e-12
            assert all(abs(float(g1[k]) - float(g4[k])) <= 1e-12 for k in g1)
            assert jg.keys() == g4.keys()
            assert all(abs(float(jg[k]) - float(g4[k])) <= 1e-12 for k in jg)
    finally:
        for e in engines:
            e.close(timeout=WAIT)
        jeng.close()
    fin = rq.sample_reduce(n=n, targets=(5, 0, 3), shots=64)
    engines = [Engine(circ, env, precision_code=2, finalize=fin, max_batch=1)
               for env in (TENV, tenv)]
    try:
        for p in sweep:
            a, b = (e.run(p, WAIT) for e in engines)
            assert b.shape == (64,) and torch.equal(a, b)
    finally:
        for e in engines:
            e.close(timeout=WAIT)
    angles = [{"s": 0.3 * k, "z": 1.1 - 0.4 * k} for k in range(3)]
    eng = Engine(_dyadic_params(tq.Circuit(n), P), tenv, precision_code=2, finalize=fin,
                 max_batch=1)
    jeng = JEngine(_dyadic_params(JCircuit(n), JP), jenv, precision_code=2, max_batch=1,
                   finalize=_jax_shots)
    try:
        for p in angles:
            mine, theirs = eng.run(p, WAIT), np.asarray(jeng.run(p))
            assert np.array_equal(mine.numpy(), theirs)
    finally:
        eng.close(timeout=WAIT)
        jeng.close()
    dens = tq.Circuit(n, is_density_matrix=True)
    for q in range(n):
        dens.hadamard(q)
    dens.mixDephasing(1, 0.2)
    dens.mixDepolarising(n - 1, 0.1)
    res = run_ensemble(dens, 4, env=tenv, shots=16, timeout=WAIT)
    ref = run_ensemble(dens, 4, env=TENV, shots=16, timeout=WAIT)
    assert res.states is None and res.shot_tables.shape == (4, 16)
    assert torch.equal(res.shot_tables, ref.shot_tables)


def _density_circuit(n, circuit=tq.Circuit, PP=P):
    c = circuit(n, is_density_matrix=True)
    c.hadamard(0)
    c.rotateX(1, PP("x"))
    c.controlledNot(0, n - 1)
    c.rotateY(n - 1, PP("y"))
    c.mixDephasing(1, 0.1)
    c.mixDepolarising(n - 1, 0.05)
    c.mixKrausMap(2, [np.sqrt(0.7) * np.eye(2), np.sqrt(0.3) * np.array([[0, 1], [1, 0]])])
    return c


@pytest.mark.parametrize("d", LAYOUTS)
def test_density_engine_and_pool_over_shards(d):
    """A density circuit served over d shards: a coalesced batch equals a
    loop of single requests bit for bit, each within 1e-12 of the
    one-device Engine and of quest_tpu's Engine on d devices;
    ``EnginePool.submit`` gives the Engine's state."""
    n = 4
    jenv, tenv = _envs(d)
    circ = _density_circuit(n)
    sweep = [{"x": 0.1 * k, "y": 0.7 - 0.2 * k} for k in range(4)]
    sh = Engine(circ, tenv, precision_code=2, max_batch=4, max_delay_ms=50.0)
    one = Engine(circ, TENV, precision_code=2, max_batch=1)
    jeng = JEngine(_density_circuit(n, JCircuit, JP), jenv, precision_code=2, max_batch=4)
    try:
        assert sh.sharded and jeng.sharded
        batch = [f.result(WAIT) for f in sh.submit_many(sweep)]
        loop = [sh.run(p, WAIT) for p in sweep]
        theirs = [np.asarray(f.result(WAIT)) for f in jeng.submit_many(sweep)]
        for b, l, p, t in zip(batch, loop, sweep, theirs):
            assert len(b) == d and all(torch.equal(x, y) for x, y in zip(b, l))
            ref = one.run(p, WAIT)
            got = torch.cat(b, dim=1).numpy()
            np.testing.assert_allclose(got, ref.numpy(), rtol=0, atol=1e-12)
            np.testing.assert_allclose(got, t, rtol=0, atol=1e-12)
    finally:
        sh.close(timeout=WAIT)
        one.close(timeout=WAIT)
        jeng.close()
    pool = tq.EnginePool(tenv, replicas=1)
    try:
        got = pool.submit(circ, sweep[2], timeout=WAIT).result(WAIT)
        assert all(torch.equal(x, y) for x, y in zip(got, loop[2]))
    finally:
        pool.close()


def test_formerly_refused_density_entries_now_answer():
    """The four entries that refused a density register over shards (the
    Engine, ``EnginePool.submit``, ``sampleQureg``, ``applyMidMeasurement``)
    each answer as on one device, on the register that test used."""
    n = 4
    _, tenv = _envs(4)
    q, ref = tq.createDensityQureg(n, tenv, 2), tq.createDensityQureg(n, TENV, 2)
    for x in (q, ref):
        tq.initDebugState(x)
    c = tq.Circuit(n, is_density_matrix=True)
    c.hadamard(0)
    c.mixDephasing(1, 0.1)
    with Engine(c, tenv) as eng, Engine(c, TENV, max_batch=1) as eng1:
        np.testing.assert_allclose(torch.cat(eng.run(None, WAIT), dim=1).numpy(),
                                   eng1.run(None, WAIT).numpy(), rtol=0, atol=1e-12)
    pool = tq.EnginePool(tenv, replicas=1)
    try:
        assert len(pool.submit(c, timeout=WAIT).result(WAIT)) == 4
    finally:
        pool.close()
    for x in (q, ref):  # initDebugState is not a state: make it one
        tq.initPlusState(x)
        tq.rotateY(x, 2, 0.4)
    assert np.array_equal(tq.sampleQureg(q, shots=64, seed=1),
                          tq.sampleQureg(ref, shots=64, seed=1))
    for x in (q, ref):
        tq.sampling.applyMidMeasurement(x, 0, seed=1)
    np.testing.assert_allclose(state_to_numpy(q), state_to_numpy(ref), rtol=0, atol=1e-12)


def test_mid_measurement_draw_stays_on_the_device():
    """The sharded draw and collapse read nothing back: a rehearsed replay
    (``_capture.rehearsal``: a host read raises) of a tape that measures a
    sharded qubit equals the eager run."""
    _, tenv = _envs(4)
    c = tq.Circuit(5)
    c.hadamard(4)
    c.rotateY(0, 0.4)
    c.applyMidMeasurement(4, 3, site=2)
    c.applyMidCollapse(0, 1)
    fn = c.compiled(donate=False)
    q = tq.createQureg(5, tenv, 2)
    eager = fn(list(q.shards))
    fn(list(q.shards))
    with _capture.rehearsal():
        again = fn(list(q.shards))
    assert all(torch.equal(a, b) for a, b in zip(eager, again))
