"""The port's sampling slice (quest_tpu_torch/sampling) against quest_tpu's
sampling package, the eager measurement oracle and its own contracts.

- the counter RNG: ``rng.uniform(shot_key(seed, site), S)`` and the raw
  32-bit words equal ``jax.random``'s threefry2x32 stream bit for bit;
- draws: ``draw_outcomes`` never leaves [0, 2^t), its binary-search counts
  equal ``sum(draw >= cdf)`` on its own tables, and given the same
  marginal, uniforms and total its table differs from the JAX package's
  only in shots whose draw lies within 4 float32 ulps of an edge of either
  package's CDF (the count is printed); sampled marginals against the
  exact distribution, a chi-square test, density sampling against state
  vector sampling, fixed-seed tables equal to quest_tpu's on dyadic
  circuits (f64 and f32) and under the edge rule on generic ones;
- requests: ``sample_request`` with and without a Pauli sum and with a
  mid-circuit measurement, one ``device_dispatch_total{route="request"}``
  a call and O(S) bytes to the host, the seed varying the table and not
  the program, the body capturable (``_capture.rehearsal``), an Engine
  with ``finalize=sample_reduce`` returning shot tables equal to single
  ``run``s bit for bit, ``QUEST_SHOTS`` and QT801, input validation;
- mid-circuit measurement: ``applyMidCollapse`` against the eager collapse
  on state vectors (f64, f32) and density registers,
  ``applyMidMeasurement`` collapsing to a valid branch with the marginal's
  frequency and to quest_tpu's branch for the same seed, recorded on a
  tape as a fusion barrier and a segment seam, its seed lifted through
  the Engine (one stream a lane).

On the card (``cuda``) the u words and ``draw_outcomes`` equal the CPU's
bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import quest_tpu as jq
from quest_tpu.engine import P as JP
from quest_tpu.ops import init as j_init
from quest_tpu.sampling import request as jrq
from quest_tpu.sampling import sampler as jsp
import quest_tpu_torch as tq
from quest_tpu_torch import _capture, fusion, sampling, segments, telemetry
from quest_tpu_torch.engine import Engine, P
from quest_tpu_torch.sampling import request as rq
from quest_tpu_torch.sampling import rng
from quest_tpu_torch.sampling import sampler as sp
from quest_tpu_torch.validation import QuESTError

TENV = tq.createQuESTEnv(device="cpu")
JENV = jq.createQuESTEnv(jax.devices()[:1])
WAIT = 60  # seconds any result() may take
#: a differing shot's draw must lie this close to an edge of a CDF
EDGE_ULPS = 4


def _dyadic(mod, q):
    """Gates whose outcome probabilities are all k 2^-m: exact in float32,
    so every route's CDF is the same bit for bit."""
    mod.hadamard(q, 0)
    mod.controlledNot(q, 0, 1)
    mod.hadamard(q, 3)
    mod.pauliX(q, 5)


def _generic(mod, q):
    mod.hadamard(q, 0)
    mod.controlledNot(q, 0, 1)
    mod.rotateY(q, 2, 0.7)
    if q.num_qubits_represented > 3:
        mod.rotateX(q, 3, 1.1)


def _probs(q) -> np.ndarray:
    """The register's exact outcome distribution (float64)."""
    a = q.amps.detach().cpu().numpy().astype(np.float64)
    if q.is_density_matrix:
        dim = 1 << q.num_qubits_represented
        return np.diagonal(a[0].reshape(dim, dim))
    return a[0] ** 2 + a[1] ** 2


def _near(x, edges, scale=0.0) -> bool:
    """Whether float32 ``x`` lies within EDGE_ULPS ulps of any of ``edges``,
    an ulp taken at the larger of the two and ``scale`` (a row's edge is
    the global CDF value offset + row[j], so its ulps are the draw's)."""
    x = np.float32(x)
    edges = np.asarray(edges, dtype=np.float32)
    gap = np.abs(edges.astype(np.float64) - np.float64(x))
    mag = np.maximum(np.maximum(np.abs(edges), np.abs(x)), np.float32(abs(scale)))
    return bool(np.any(gap <= EDGE_ULPS * np.spacing(mag).astype(np.float64)))


def _jax_tables(p: np.ndarray):
    """The JAX package's (row_cdf, block_cdf) for the marginal ``p``: its
    draw_outcomes' two cumsums on the same (B, L) split."""
    t = p.size.bit_length() - 1
    bb = jsp._block_bits(t, None)
    row = jnp.cumsum(jnp.asarray(p).reshape(1 << bb, -1), axis=1)
    return np.asarray(row), np.asarray(jnp.cumsum(row[:, -1]))


def _edge_misses(draws, got, want, tables) -> tuple[int, int]:
    """(differing shots, differing shots whose draw is NOT within
    EDGE_ULPS of an edge of any of ``tables``), for shot tables ``got`` and
    ``want`` of the float32 ``draws``: a shot may land on the neighbouring
    outcome only where the packages' CDFs round its edge differently. An
    edge is a block CDF value, or a global CDF value (the block's offset
    plus its row's entry), in ulps of the draw."""
    diff = np.flatnonzero(got != want)
    misses = 0
    for s in diff:
        ok = False
        for (row, blk), d in tables:
            L = row.shape[1]
            x = np.float32(d[s])
            if _near(x, blk):
                ok = True
                break
            for k in (int(got[s]), int(want[s])):
                b = k // L
                off = np.float32(blk[b - 1]) if b > 0 else np.float32(0.0)
                if _near(np.float32(x - off), row[b], scale=x):
                    ok = True
                    break
            if ok:
                break
        misses += not ok
    return len(diff), misses


# ---------------------------------------------------------------------------
# the counter RNG against jax.random
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("site", [0, 1, 7])
@pytest.mark.parametrize("seed", [0, 1, 2026, 2 ** 32 - 1])
def test_rng_words_and_uniforms_equal_jax(seed, site):
    jkey = jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)), site)
    key = sp.shot_key(seed, site)
    assert [int(k) for k in key] == [int(k) for k in np.asarray(jax.random.key_data(jkey))]
    for S in (1, 3, 1024, 1025):
        want_u = np.asarray(jax.random.uniform(jkey, (S,), jnp.float32))
        want_w = np.asarray(jax.random.bits(jkey, (S,), jnp.uint32))
        got_u = rng.uniform(key, (S,)).numpy()
        got_w = rng.random_bits(key, (S,)).numpy()
        assert got_u.dtype == np.float32
        assert np.array_equal(got_u.view(np.uint32), want_u.view(np.uint32))
        assert np.array_equal(got_w.astype(np.uint32), want_w)
        assert got_w.min() >= 0 and got_w.max() < 2 ** 32


def test_rng_scalar_draw_and_seed_tensor_equal_jax():
    """The mid-circuit draw (shape ()) and a seed given as a tensor (a
    lifted slot) walk the same stream as jax's PRNGKey of a uint32."""
    for seed, site in ((5, 0), (3, 1), (2 ** 31 + 7, 4)):
        jkey = jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)), site)
        want = np.asarray(jax.random.uniform(jkey, dtype=jnp.float32))
        for s in (seed, torch.tensor(seed, dtype=torch.int64)):
            got = rng.uniform(sp.shot_key(s, site)).numpy()
            assert got.shape == () and got.view(np.uint32) == want.view(np.uint32)
    # a seed is taken modulo 2^32, as numpy's uint32 cast takes it
    assert np.array_equal(rng.uniform(sp.shot_key(-1, 2), (8,)).numpy(),
                          rng.uniform(sp.shot_key(2 ** 32 - 1, 2), (8,)).numpy())


def test_rng_batched_seed_gives_each_lane_its_stream():
    seeds = torch.tensor([0, 9, 2026], dtype=torch.int64)
    got = torch.func.vmap(lambda s: rng.uniform(sp.shot_key(s, 3), (17,)))(seeds)
    for i, s in enumerate(seeds.tolist()):
        assert torch.equal(got[i], rng.uniform(sp.shot_key(s, 3), (17,)))


# ---------------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------------

def test_draw_outcomes_never_out_of_range():
    """Draws at the CDF's ends clamp branch-free (u = 0 and u ~ 1), zero
    probability outcomes included."""
    for p in (np.full(8, 0.125, np.float32),
              np.array([0.5, 0, 0, 0.25, 0, 0, 0.25, 0], np.float32),
              np.array([0, 0, 0, 0, 0, 0, 0, 1], np.float32)):
        u = torch.tensor([0.0, 1.0 - 2 ** -24, 0.999999, 0.5], dtype=torch.float32)
        out = sp.draw_outcomes(torch.tensor(p), u)
        assert out.dtype == torch.int32
        assert int(out.min()) >= 0 and int(out.max()) <= 7
        assert all(p[int(k)] > 0 for k in out)
        # a norm slightly above the total still lands inside the table
        out = sp.draw_outcomes(torch.tensor(p), u, norm=torch.tensor(1.001))
        assert int(out.min()) >= 0 and int(out.max()) <= 7


@pytest.mark.parametrize("t", [1, 4, 7, 10, 12])
def test_draw_outcomes_counts_equal_the_sum_rule(t):
    """The binary searches give sum(draw >= cdf) on the port's own
    non-decreasing tables (the JAX package's counting rule)."""
    r = np.random.RandomState(t)
    p = r.rand(1 << t).astype(np.float32)
    p[r.rand(1 << t) < 0.3] = 0
    p /= p.sum()
    u = r.rand(3000).astype(np.float32)
    got = sp.draw_outcomes(torch.tensor(p), torch.tensor(u)).numpy()
    row, blk = (x.numpy() for x in sp.cdf_tables(torch.tensor(p)))
    assert np.all(np.diff(blk) >= 0) and np.all(np.diff(row, axis=1) >= 0)
    draws = (u * blk[-1]).astype(np.float32)
    B, L = row.shape
    b = np.minimum((draws[:, None] >= blk[None]).sum(1), B - 1)
    off = np.where(b > 0, blk[np.maximum(b - 1, 0)], np.float32(0)).astype(np.float32)
    j = np.minimum(((draws - off)[:, None] >= row[b]).sum(1), L - 1)
    assert np.array_equal(got, b * L + j)


@pytest.mark.parametrize("t", [3, 6, 9, 10, 12])
def test_draw_outcomes_against_jax_edge_rule(t, capsys):
    """Same marginal, uniforms and total: the tables differ only in shots
    whose draw lies within EDGE_ULPS float32 ulps of an edge of either
    package's CDF."""
    r = np.random.RandomState(100 + t)
    p = r.rand(1 << t).astype(np.float32) ** 3
    p[r.rand(1 << t) < 0.2] = 0
    p = (p / p.sum()).astype(np.float32)
    u = r.rand(20000).astype(np.float32)
    norm = np.float32(p.astype(np.float64).sum())
    got = sp.draw_outcomes(torch.tensor(p), torch.tensor(u), norm=torch.tensor(norm)).numpy()
    want = np.asarray(jsp.draw_outcomes(jnp.asarray(p), jnp.asarray(u), norm=norm))
    draws = (u * norm).astype(np.float32)
    mine = tuple(x.numpy() for x in sp.cdf_tables(torch.tensor(p)))
    ndiff, misses = _edge_misses(draws, got, want, ((mine, draws), (_jax_tables(p), draws)))
    with capsys.disabled():
        print(f"\n[draw_outcomes t={t}] {ndiff} of {u.size} shots differ from quest_tpu's, "
              f"all within {EDGE_ULPS} ulps of a CDF edge" if not misses else "")
    assert misses == 0, f"{misses} of {ndiff} differing shots are not at an edge"
    assert ndiff <= u.size // 1000


def test_sampled_marginals_match_oracle_small():
    q = tq.createQureg(4, TENV)
    _generic(tq, q)
    p = _probs(q)
    shots = 40000
    tab = tq.sampleQureg(q, shots=shots, seed=11)
    assert tab.shape == (shots,) and tab.dtype == np.int32
    emp = np.bincount(tab, minlength=16) / shots
    assert np.abs(emp - p).max() < 4.0 / np.sqrt(shots)


def test_sampled_subset_targets_match_marginal_oracle():
    q = tq.createQureg(5, TENV)
    _generic(tq, q)
    p = _probs(q)
    marg = np.zeros(4)
    for i in range(32):
        marg[((i >> 1) & 1) | (((i >> 3) & 1) << 1)] += p[i]
    shots = 40000
    tab = tq.sampleQureg(q, targets=(1, 3), shots=shots, seed=3)
    assert tab.max() < 4
    emp = np.bincount(tab, minlength=4) / shots
    assert np.abs(emp - marg).max() < 4.0 / np.sqrt(shots)


def test_density_register_sampling_matches_statevec():
    qs, qd = tq.createQureg(3, TENV), tq.createDensityQureg(3, TENV)
    for q in (qs, qd):
        _generic(tq, q)
    ps = np.bincount(tq.sampleQureg(qs, shots=20000, seed=9), minlength=8) / 20000
    pd = np.bincount(tq.sampleQureg(qd, shots=20000, seed=9), minlength=8) / 20000
    assert np.abs(ps - pd).max() < 4.0 / np.sqrt(20000)
    # a pure state's density register walks the same CDF: the same table
    assert np.array_equal(tq.sampleQureg(qs, shots=2000, seed=4),
                          tq.sampleQureg(qd, shots=2000, seed=4))


def test_chi_square_10q():
    """10 qubits, the marginal over 3: Pearson chi-square of the table
    against the analytic marginal under chi2(3)'s 99.9% point; outcomes of
    probability 0 are never drawn."""
    q = tq.createQureg(10, TENV)
    tq.hadamard(q, 0)
    tq.controlledNot(q, 0, 5)
    tq.rotateY(q, 9, 0.9)
    shots = 50000
    tab = tq.sampleQureg(q, targets=(0, 5, 9), shots=shots, seed=123)
    p1 = np.sin(0.45) ** 2
    marg = np.zeros(8)
    for b2 in (0, 1):
        pb2 = p1 if b2 else 1 - p1
        marg[0 | (b2 << 2)] = marg[3 | (b2 << 2)] = 0.5 * pb2
    emp = np.bincount(tab, minlength=8).astype(np.float64)
    mask = marg > 0
    chi2 = float(np.sum((emp[mask] - shots * marg[mask]) ** 2 / (shots * marg[mask])))
    assert emp[~mask].sum() == 0
    assert chi2 < 16.3, f"chi2={chi2}"


@pytest.mark.parametrize("prec", [2, 1])
def test_fixed_seed_tables_equal_quest_tpu_on_dyadic_circuits(prec):
    """Every outcome probability of a dyadic circuit is exact in float32,
    so both packages walk the same CDF: the same table, in f64 and f32,
    for every target set."""
    tq_q, jq_q = tq.createQureg(6, TENV, prec), jq.createQureg(6, JENV, prec)
    _dyadic(tq, tq_q)
    _dyadic(jq, jq_q)
    for targets in (None, (3, 0, 5)):
        for seed in (42, 7):
            got = tq.sampleQureg(tq_q, targets=targets, shots=1000, seed=seed)
            want = jq.sampleQureg(jq_q, targets=targets, shots=1000, seed=seed)
            assert np.array_equal(got, want)


@pytest.mark.parametrize("prec", [2, 1])
def test_shot_tables_against_quest_tpu_edge_rule(prec, capsys):
    """A generic 8-qubit circuit: each package samples its own state; a shot
    may differ only where its draw is within EDGE_ULPS of a CDF edge."""
    tq_q, jq_q = tq.createQureg(8, TENV, prec), jq.createQureg(8, JENV, prec)
    for mod, q in ((tq, tq_q), (jq, jq_q)):
        for k in range(8):
            mod.rotateY(q, k, 0.3 + 0.41 * k)
        mod.controlledNot(q, 0, 7)
        mod.rotateX(q, 3, 1.3)
    shots, seed = 20000, 2026
    got = tq.sampleQureg(tq_q, shots=shots, seed=seed)
    want = jq.sampleQureg(jq_q, shots=shots, seed=seed)
    u = rng.uniform(sp.shot_key(seed, 0), (shots,)).numpy()
    tables = []
    for p, norm in ((sp.marginal_probs(tq_q.amps, n=8, targets=tuple(range(8))).numpy(),
                     np.float32(float(tq.calcTotalProb(tq_q)))),
                    (np.asarray(jsp.marginal_probs(jq_q.amps, n=8, targets=tuple(range(8)))),
                     np.float32(float(jq.calcTotalProb(jq_q))))):
        draws = (u * norm).astype(np.float32)
        tables.append((tuple(x.numpy() for x in sp.cdf_tables(torch.tensor(p))), draws))
        tables.append((_jax_tables(p), draws))
    ndiff, misses = _edge_misses(tables[0][1], got, want, tables)
    with capsys.disabled():
        print(f"\n[sampleQureg prec {prec}] {ndiff} of {shots} shots differ from quest_tpu's")
    assert misses == 0, f"{misses} of {ndiff} differing shots are not at an edge"


# ---------------------------------------------------------------------------
# one-dispatch requests
# ---------------------------------------------------------------------------

def _zero(n, prec=2):
    return tq.createQureg(n, TENV, prec).amps.clone()


def test_sample_request_single_dispatch_and_o_s_transfer():
    c = tq.Circuit(4)
    c.hadamard(0)
    c.controlledNot(0, 1)
    c.rotateY(2, 0.3)
    exe = rq.sample_request(c, shots=256)
    before = telemetry.counter_value("device_dispatch_total", route="request")
    out = rq.to_host(exe(_zero(4), 5))
    assert telemetry.counter_value("device_dispatch_total", route="request") - before == 1
    assert exe.num_dispatches == 1
    assert out["shots"].shape == (256,) and out["shots"].dtype == np.int32
    assert telemetry.gauge_value("sample_host_transfer_bytes") == out["shots"].nbytes
    # the same request through quest_tpu: the same table (f64, a seed)
    jc = jq.Circuit(4)
    jc.hadamard(0)
    jc.controlledNot(0, 1)
    jc.rotateY(2, 0.3)
    want = jrq.to_host(jrq.sample_request(jc, shots=256)(
        j_init.init_classical(16, np.dtype("float64"), 0), 5))
    assert np.array_equal(out["shots"], want["shots"])


def test_constant_tape_request_runs_through_request_executable():
    """A fused-run plan (no value slot) takes the compiled request chain:
    its segments, the sampler as the terminal reduce, one program."""
    c = tq.Circuit(9)
    tq.random_layers(c, 9, 2)
    fz = c.fused(max_qubits=5, pallas=True, tile_bits=8)
    assert not fz.lifted().slots
    exe = rq.sample_request(fz, targets=(0, 4, 8), shots=500, pauli_codes=[3] + [0] * 8,
                            coeffs=[0.5])
    assert exe.num_segments >= 1 and exe.num_dispatches == 1
    out = rq.to_host(exe(_zero(9), 17))
    q = tq.createQureg(9, TENV)
    fz.run(q)
    want = tq.sampleQureg(q, targets=(0, 4, 8), shots=500, seed=17)
    assert np.array_equal(out["shots"], want)
    ws = tq.createQureg(9, TENV)
    assert out["expec"] == pytest.approx(
        tq.calcExpecPauliSum(q, [3] + [0] * 8, [0.5], ws), abs=1e-12)


def test_sample_request_with_pauli_sum_and_mid_measurement():
    """Circuit + mid-circuit measurement + S shots + Pauli-sum expectation
    as one program: the expectation equals the eager calcExpecPauliSum of
    the same seed's collapsed state and quest_tpu's request; the table
    replays bit for bit and equals quest_tpu's."""
    codes, coeffs = [3, 0, 0, 0, 3, 0], [0.5, 0.25]
    c = tq.Circuit(3)
    c.hadamard(0)
    c.controlledNot(0, 1)
    c.applyMidMeasurement(0, P("s"), site=1)
    exe = rq.sample_request(c, shots=128, pauli_codes=codes, coeffs=coeffs)
    before = telemetry.counter_value("device_dispatch_total", route="request")
    out = rq.to_host(exe(_zero(3), 3))
    assert telemetry.counter_value("device_dispatch_total", route="request") - before == 1
    q = tq.createQureg(3, TENV)
    tq.hadamard(q, 0)
    tq.controlledNot(q, 0, 1)
    tq.applyMidMeasurement(q, 0, 3, site=1)
    ws = tq.createQureg(3, TENV)
    assert out["expec"] == pytest.approx(tq.calcExpecPauliSum(q, codes, coeffs, ws),
                                         abs=1e-12)
    assert np.array_equal(rq.to_host(exe(_zero(3), 3))["shots"], out["shots"])
    jc = jq.Circuit(3)
    jc.hadamard(0)
    jc.controlledNot(0, 1)
    jc.applyMidMeasurement(0, JP("s"), site=1)
    want = jrq.to_host(jrq.sample_request(jc, shots=128, pauli_codes=codes, coeffs=coeffs)(
        j_init.init_classical(8, np.dtype("float64"), 0), 3))
    assert np.array_equal(out["shots"], want["shots"])
    assert out["expec"] == pytest.approx(float(want["expec"]), abs=1e-10)
    # every shot carries the drawn outcome at the measured qubit
    assert len(set((out["shots"] & 1).tolist())) == 1


def test_sample_request_seed_varies_table_not_program():
    c = tq.Circuit(3)
    c.hadamard(0)
    c.rotateY(1, 0.4)
    exe = rq.sample_request(c, shots=200)
    t1 = rq.to_host(exe(_zero(3), 1))
    t2 = rq.to_host(exe(_zero(3), 2))
    assert not np.array_equal(t1["shots"], t2["shots"])
    assert rq.sample_request(c, shots=200) is exe
    # a seed given as a tensor is the same request
    assert np.array_equal(rq.to_host(exe(_zero(3), torch.tensor(2)))["shots"], t2["shots"])


@pytest.mark.parametrize("slotted", [False, True])
def test_sample_request_body_is_capturable(slotted):
    """On the CPU the request's replay runs as the card captures it (the
    staging frozen, the host guard on): no host copy or sync inside, a
    tensor seed, the same table."""
    c = tq.Circuit(5)
    c.hadamard(0)
    c.controlledNot(0, 3)
    if slotted:
        # a lifted constant and a named seed, which the request binds to its
        # own seed (other Params must be bound on the tape)
        c.rotateY(2, 0.77)
        c.applyMidMeasurement(3, P("m"), site=2)
    assert bool(c.lifted().slots) == slotted
    exe = rq.sample_request(c, shots=64, pauli_codes=[1, 0, 3, 0, 0], coeffs=[0.3])
    first = rq.to_host(exe(_zero(5), 9))
    with _capture.rehearsal():
        again = rq.to_host(exe(_zero(5), 9))
    assert np.array_equal(first["shots"], again["shots"])
    assert first["expec"] == again["expec"]


def test_engine_finalize_returns_shot_tables():
    """The Engine's finalize: each lane's shot table (and expectation); the
    2^n states never cross. A lane equals the same request served alone."""
    c = tq.Circuit(3)
    c.hadamard(0)
    c.rotateY(1, P("theta"))
    fin = sampling.sample_reduce(n=3, targets=(0, 1, 2), shots=64)
    red = sampling.expectation_reduce(n=3, codes=[3, 0, 0], coeffs=[1.0])

    def finalize(amps):
        return {"shots": fin(amps, 0), "expec": red(amps)}

    with Engine(c, TENV, max_batch=2, max_delay_ms=0.0, finalize=finalize) as eng:
        outs = [f.result(WAIT) for f in eng.submit_many([{"theta": 0.1}, {"theta": 0.2}])]
    for out in outs:
        assert tuple(out["shots"].shape) == (64,)
        assert float(out["expec"]) == pytest.approx(0.0, abs=1e-9)
    with Engine(c, TENV, max_batch=4, max_delay_ms=0.0, finalize=fin) as eng:
        sweep = [{"theta": 0.1 * k} for k in range(4)]
        outs = [f.result(WAIT) for f in eng.submit_many(sweep)]
        for p, out in zip(sweep, outs):
            assert out.dtype == torch.int32 and torch.equal(out, eng.run(p, WAIT))


def test_quest_shots_env_default_and_qt801(monkeypatch):
    monkeypatch.setenv("QUEST_SHOTS", "37")
    rq._ENV_WARNED.clear()
    assert rq.shots_default() == 37
    monkeypatch.setenv("QUEST_SHOTS", "zero-point-five")
    rq._ENV_WARNED.clear()
    with pytest.warns(RuntimeWarning, match="QT801"):
        assert rq.shots_default() == rq.DEFAULT_SHOTS
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert rq.shots_default() == rq.DEFAULT_SHOTS
    monkeypatch.setenv("QUEST_SHOTS", "0")
    with pytest.warns(RuntimeWarning, match="QT801"):
        assert rq.shots_default() == jrq.shots_default() == 1
    monkeypatch.setenv("QUEST_SHOTS", "5")
    q = tq.createQureg(2, TENV)
    assert tq.sampleQureg(q).shape == (5,)


def test_sampling_input_validation():
    q = tq.createQureg(2, TENV)
    with pytest.raises(QuESTError):
        tq.applyMidMeasurement(q, 5, 0)
    with pytest.raises(QuESTError):
        tq.applyMidCollapse(q, 0, 2)
    with pytest.raises(QuESTError):
        tq.sampleQureg(q, targets=(0, 7))
    with pytest.raises(QuESTError):
        tq.sampleQureg(q, shots=0)
    c = tq.Circuit(2)
    c.hadamard(0)
    with pytest.raises(QuESTError):
        rq.sample_request(c, shots=0)
    with pytest.raises(QuESTError):
        rq.sample_request(c, targets=(0, 0))
    with pytest.raises(QuESTError):
        rq.sample_request(c, pauli_codes=[3, 0])
    with pytest.raises(QuESTError):
        sampling.expectation_reduce(n=2, codes=[3, 0, 1, 1], coeffs=[1.0])
    # a register over shards is sampled and collapsed (tests/test_torch_sharded_sampling.py
    # holds the results against one device and quest_tpu's mesh)
    sharded = tq.createQureg(4, tq.createQuESTEnv(devices=["cpu"] * 2))
    assert np.array_equal(tq.sampleQureg(sharded, shots=4), np.zeros(4, np.int32))
    tq.applyMidCollapse(sharded, 0, 0)
    assert abs(tq.calcTotalProb(sharded) - 1.0) <= 1e-12


def test_sampler_adds_no_host_sync_and_counts_shots():
    q = tq.createQureg(2, TENV)
    tq.hadamard(q, 0)
    before = telemetry.counter_value("sample_shots_total")
    tq.sampleQureg(q, shots=16, seed=0)
    assert telemetry.counter_value("sample_shots_total") - before == 16
    # sampling reads the register and leaves it as it was
    a = q.amps.clone()
    tq.sampleQureg(q, shots=16, seed=1)
    assert torch.equal(a, q.amps)


# ---------------------------------------------------------------------------
# mid-circuit measurement and collapse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec", [2, 1])
def test_mid_collapse_matches_eager_collapse(prec):
    for outcome in (0, 1):
        a, b = tq.createQureg(4, TENV, prec), tq.createQureg(4, TENV, prec)
        for q in (a, b):
            _generic(tq, q)
        tq.collapseToOutcome(a, 1, outcome)
        tq.applyMidCollapse(b, 1, outcome)
        tol = 1e-10 if prec == 2 else 1e-5
        np.testing.assert_allclose(b.amps.numpy(), a.amps.numpy(), atol=tol)


def test_mid_collapse_matches_eager_on_density():
    a, b = tq.createDensityQureg(3, TENV), tq.createDensityQureg(3, TENV)
    for q in (a, b):
        _generic(tq, q)
        tq.mixDephasing(q, 0, 0.2)
    tq.collapseToOutcome(a, 0, 1)
    tq.applyMidCollapse(b, 0, 1)
    np.testing.assert_allclose(b.amps.numpy(), a.amps.numpy(), atol=1e-10)


def test_mid_measurement_collapses_to_valid_branch():
    """The drawn branch is one of the two collapses, drawn with the
    marginal's frequency, and the same branch as quest_tpu's for the seed."""
    hits, trials = 0, 40
    for s in range(trials):
        q, jqq = tq.createQureg(2, TENV), jq.createQureg(2, JENV)
        tq.rotateY(q, 0, 0.8)
        jq.rotateY(jqq, 0, 0.8)
        tq.applyMidMeasurement(q, 0, s)
        jq.applyMidMeasurement(jqq, 0, s)
        p = q.amps[0].numpy() ** 2 + q.amps[1].numpy() ** 2
        odd = p.reshape(2, 2)[:, 1].sum()
        assert odd < 1e-12 or odd > 1 - 1e-12
        assert abs(p.sum() - 1.0) < 1e-9
        np.testing.assert_allclose(q.amps.numpy(), np.asarray(jqq.amps), atol=1e-12)
        hits += odd > 0.5
    expect = np.sin(0.4) ** 2 * trials
    assert abs(hits - expect) < 4 * np.sqrt(trials * 0.16)


def test_mid_measurement_on_density_register():
    q = tq.createDensityQureg(3, TENV)
    _generic(tq, q)
    tq.applyMidMeasurement(q, 2, 11, site=3)
    assert tq.calcTotalProb(q) == pytest.approx(1.0, abs=1e-12)
    p1 = tq.calcProbOfOutcome(q, 2, 1)
    assert p1 == pytest.approx(0.0, abs=1e-12) or p1 == pytest.approx(1.0, abs=1e-12)


def test_mid_measurement_is_tapeable_and_fusion_barrier():
    c = tq.Circuit(3)
    c.hadamard(0)
    c.applyMidMeasurement(0, 5, site=0)
    c.applyMidCollapse(1, 0)
    assert len(c) == 3
    fn, args, kwargs = c._tape[1]
    assert fn.__name__ == "applyMidMeasurement"
    assert fn._fusion_barrier and fn._measurement_site
    assert fusion.capture(fn, args, kwargs, 3, torch.float64) is None
    # the planner keeps it as an entry of its own, and the plan runs it
    d = tq.Circuit(9)
    tq.random_layers(d, 9, 1)
    d.applyMidMeasurement(4, 21, site=0)
    tq.random_layers(d, 9, 1, seed=5)
    fz = d.fused(max_qubits=5, pallas=True, tile_bits=8)
    names = [f.__name__ for f, _, _ in fz._tape]
    assert names.count("applyMidMeasurement") == 1
    a, b = tq.createQureg(9, TENV), tq.createQureg(9, TENV)
    d.run(a)
    fz.run(b)
    np.testing.assert_allclose(b.amps.numpy(), a.amps.numpy(), atol=1e-10)


def test_segment_cuts_forced_at_measurement_seams():
    c = tq.Circuit(3)
    c.hadamard(0)
    c.hadamard(1)
    c.applyMidCollapse(0, 0)
    c.hadamard(2)
    c.pauliX(0)
    assert segments.measurement_seams(c._tape) == {2, 3}
    assert segments.segment_cuts(c._tape, 3) == [0, 2, 3, 5]
    # a measurement site runs inside a compiled program: no item dispatch
    before = telemetry.counter_value("device_dispatch_total", route="item")
    c.compiled_segments()(_zero(3))
    assert telemetry.counter_value("device_dispatch_total", route="item") == before


def test_mid_measurement_seed_lifts_through_engine():
    """P('m') at the seed position is a 'seed' slot: S requests replay ONE
    lane-batched executable, each lane with its own stream, the same as
    the eager measurement of its seed."""
    c = tq.Circuit(2)
    c.hadamard(0)
    c.applyMidMeasurement(0, P("m"), site=0)
    assert [s.kind for s in c.lifted().slots] == ["seed"]
    with Engine(c, TENV, max_batch=4, max_delay_ms=0.0) as eng:
        states = [f.result(WAIT) for f in eng.submit_many([{"m": s} for s in range(4)])]
        again = [f.result(WAIT) for f in eng.submit_many([{"m": s} for s in range(4)])]
    for s, (st, st2) in enumerate(zip(states, again)):
        assert torch.equal(st, st2)
        q = tq.createQureg(2, TENV)
        tq.hadamard(q, 0)
        tq.applyMidMeasurement(q, 0, s)
        np.testing.assert_allclose(st.numpy(), q.amps.numpy(), atol=1e-12)
        p = st[0] ** 2 + st[1] ** 2
        branch = float(p.reshape(2, 2)[:, 1].sum())
        assert branch < 1e-9 or branch > 1 - 1e-9


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_card_words_and_draws_equal_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    key_cpu, key_gpu = sp.shot_key(2026, 3), sp.shot_key(2026, 3, "cuda")
    assert torch.equal(rng.random_bits(key_gpu, (4097,)).cpu(),
                       rng.random_bits(key_cpu, (4097,)))
    u = rng.uniform(key_cpu, (50000,))
    assert torch.equal(rng.uniform(key_gpu, (50000,)).cpu(), u)
    r = np.random.RandomState(5)
    p = torch.tensor(r.rand(1 << 14).astype(np.float32))
    p /= p.sum()
    norm = torch.tensor(1.0000001, dtype=torch.float32)
    want = sp.draw_outcomes(p, u, norm=norm)
    got = sp.draw_outcomes(p.cuda(), u.cuda(), norm=norm.cuda())
    assert torch.equal(got.cpu(), want)
