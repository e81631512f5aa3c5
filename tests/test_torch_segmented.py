"""The port's segmented execution (quest_tpu_torch/resilience/segmented.py)
on the CPU: its cuts against quest_tpu's, its bits against its own routes.

- ``segment_plan`` equals ``quest_tpu.resilience.segment_plan`` on the same
  fused plans at tile_bits 8 (state vectors at 9 and 11 qubits, a sharded
  plan, a density plan) for ``every_n_items`` 1, 2 and 3; QT304 on 0 and
  on ``keep=0``;
- ``run_segmented`` equals ``Circuit.run`` and the eager replay
  (``as_fn``) bit for bit, and ``quest_tpu``'s run and ``tests/oracle.py``
  within tests/helpers.py's tolerances (the reference caveat
  ``test_run_segmented_matches_plain_run`` concerns the JAX package's
  segmented bits and does not apply here);
- preempted and resumed runs on one device and on 4 virtual shards, f32
  and f64, bit for bit; the fall-backs (``skipped_corrupt``,
  ``rejected_gen``, ``no_verified_gen``), the fingerprint check, ``keep``
  and resuming a completed run;
- the sentinel rollback, from the in-memory baseline and from a
  generation, bit for bit; a forced degrade, whose replay is the eager item
  route through the kernel wrapper; a corrupt rollback target failing
  closed; the probe points doing nothing with the sentinels off.

Resume across the packages is not tested: each package's manifests carry
its own circuit fingerprints.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import quest_tpu as jq
from quest_tpu import resilience as jres
from quest_tpu.circuits import Circuit as JCircuit
import quest_tpu_torch as tq
from quest_tpu_torch import segments as S
from quest_tpu_torch import telemetry
from quest_tpu_torch.interop import circuit_from_tape
from quest_tpu_torch.ops import fused_gates as FG
from quest_tpu_torch.resilience import (fault_plan, guard, resume_segmented,
                                        segment_plan, segmented, sentinel,
                                        sentinel_policy)
from quest_tpu_torch.validation import QuESTError

from . import oracle
from .test_torch_compiled import PLAN_KINDS, _plans

F64_TOL, F32_TOL = 1e-10, 2e-4
TENV = tq.createQuESTEnv(device="cpu")
JENV = jq.createQuESTEnv(jax.devices()[:1])
DTYPES = {"f64": (torch.float64, 2), "f32": (torch.float32, 1)}


# -- the cuts -------------------------------------------------------------------

@pytest.mark.parametrize("every", [1, 2, 3])
@pytest.mark.parametrize("kind", PLAN_KINDS)
def test_segment_plan_equals_reference(kind, every):
    from quest_tpu import fusion as JF
    from quest_tpu_torch import fusion as F

    jp, tp, nsv = _plans(kind)
    jt, tt = JF.as_tape(jp), F.as_tape(tp)
    cuts = segment_plan(tt, nsv, every)
    assert cuts == jres.segment_plan(jt, nsv, every)
    assert cuts[0] == 0 and cuts[-1] == len(tt) and len(cuts) > 2
    assert set(cuts) <= set(S.identity_boundaries(tt, nsv))


def test_qt304_on_zero_cadence_and_zero_keep(tmp_path):
    fz, _ = _fused(9, False, torch.float64)
    telemetry.reset()
    with pytest.raises(QuESTError, match="QT304"):
        segment_plan(fz._tape, 9, 0)
    with pytest.raises(QuESTError, match="QT304"):
        fz.run_segmented(TENV, checkpoint_dir=str(tmp_path / "k0"), keep=0)
    assert telemetry.counter_value("analysis_findings_total", code="QT304",
                                   severity="error") == 2
    assert not os.path.exists(tmp_path / "k0")


# -- bit for bit, and against the reference and the oracle ------------------------

def _fused(n, density, tdt, seed=3, shards=None):
    c = tq.density_circuit(n, True) if density else tq.Circuit(n)
    tq.random_layers(c, n, 2 if density else 4, seed=seed)
    tb = 8 if not shards else 7
    return c.fused(max_qubits=4 if density else 5, pallas=True, dtype=tdt, tile_bits=tb,
                   shard_devices=shards), c


def _new(n, density, prec, env=TENV, seed=None):
    q = (tq.createDensityQureg if density else tq.createQureg)(n, env, prec)
    if seed is not None:
        tq.seedQuEST(env, [seed, 1])
    return q


def _host(q):
    """The planar state of a register, or of a state tensor or shard list."""
    if isinstance(q, tq.Qureg):
        q = q.amps if q.shards is None else q.shards
    pieces = q if isinstance(q, list) else [q]
    return np.concatenate([t.numpy() for t in pieces], axis=1)


def _oracle_tape(n, density, seed):
    """(port Circuit, quest_tpu Circuit, oracle state or rho) of a random
    tape of dense and controlled unitaries (and dephasing on a density
    register) from |0>."""
    rng = np.random.RandomState(seed)
    jc = JCircuit(n, is_density_matrix=density)
    dim = 1 << n
    psi = np.zeros(dim, complex)
    psi[0] = 1
    state = np.outer(psi, psi) if density else psi
    for i in range(6 * n):
        qs = [int(v) for v in rng.permutation(n)[:3]]
        t = 1 + i % 2
        U = oracle.random_unitary(t, rng)
        if i % 3 == 2:
            jc.multiControlledMultiQubitUnitary(qs[t:], qs[:t], U)
            ctrl = qs[t:]
        else:
            jc.multiQubitUnitary(qs[:t], U)
            ctrl = []
        if density:
            state = oracle.apply_to_density(state, n, qs[:t], U, ctrl)
        else:
            state = oracle.apply_to_statevec(state, n, qs[:t], U, ctrl)
        if density and i % 4 == 3:
            jc.mixDephasing(qs[0], 0.1)
            z = np.diag([1.0, -1.0])
            state = oracle.apply_kraus_to_density(
                state, n, [qs[0]], [np.sqrt(0.9) * np.eye(2), np.sqrt(0.1) * z])
    return circuit_from_tape(jc._tape, n, density), jc, state


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("density", [False, True], ids=["sv", "density"])
def test_run_segmented_bits_reference_and_oracle(tmp_path, density, dt):
    tdt, prec = DTYPES[dt]
    n = 5 if density else 9
    tc, jc, want = _oracle_tape(n, density, seed=n)
    fz = tc.fused(max_qubits=4 if density else 5, pallas=True, dtype=tdt, tile_bits=8)
    assert len(segment_plan(fz._tape, (2 if density else 1) * n, 1)) > 3
    out = fz.run_segmented(_new(n, density, prec), checkpoint_dir=str(tmp_path / "s"),
                           every_n_items=1)
    ref = _new(n, density, prec)
    fz.run(ref)
    assert torch.equal(out.amps, ref.amps)
    assert torch.equal(out.amps, fz.as_fn()(_new(n, density, prec).amps))
    jr = (jq.createDensityQureg if density else jq.createQureg)(n, JENV, prec)
    jc.run(jr)
    tol = F64_TOL if dt == "f64" else F32_TOL
    got = tq.get_np(out)
    np.testing.assert_allclose(got, jq.get_np(jr), rtol=0, atol=tol)
    if density:
        got = got.reshape(1 << n, 1 << n).T
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


# -- preempt and resume -------------------------------------------------------------

def _preempt(fz, target, d, every=1, nth=1, keep=2):
    with fault_plan(f"segment.boundary:preempt:{nth}"):
        with pytest.raises(tq.QuESTPreemptionError) as err:
            fz.run_segmented(target, checkpoint_dir=d, every_n_items=every, keep=keep)
    assert err.value.checkpoint_dir == d
    return err.value.cursor


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("where", ["one", "four"])
def test_preempt_and_resume_bit_identical(tmp_path, where, dt):
    tdt, prec = DTYPES[dt]
    n = 9 if where == "one" else 11
    shards = None if where == "one" else 4
    fz, _ = _fused(n, False, tdt, shards=shards)
    env = (lambda: tq.createQuESTEnv(devices=["cpu"] * 4)) if shards else (
        lambda: tq.createQuESTEnv(device="cpu"))
    cuts = segment_plan(fz._tape, n, 1)
    d = str(tmp_path / "pre")
    cursor = _preempt(fz, _new(n, False, prec, env(), seed=5), d, nth=2)
    assert cursor == cuts[2] and cursor < len(fz)
    telemetry.reset()
    resumed = resume_segmented(fz, d, env())
    assert telemetry.counter_value("segmented_resume_total", outcome="verified") == 1
    assert telemetry.counter_value("segmented_segments_total") == len(cuts) - 3
    whole = fz.run_segmented(_new(n, False, prec, env(), seed=5),
                             checkpoint_dir=str(tmp_path / "whole"))
    ref = _new(n, False, prec, env())
    fz.run(ref)
    assert np.array_equal(_host(resumed), _host(whole))
    assert np.array_equal(_host(resumed), _host(ref))
    zero = _new(n, False, prec, env())
    eager = fz.as_fn()(zero.amps if not shards else list(zero.shards))
    assert np.array_equal(_host(resumed), _host(eager))
    # the RNG was restored: measurements agree
    assert [tq.measure(resumed, t) for t in range(n)] == \
        [tq.measure(whole, t) for t in range(n)]


def _completed(tmp_path, keep=2, every=1):
    fz, _ = _fused(9, False, torch.float64)
    d = str(tmp_path / "run")
    out = fz.run_segmented(_new(9, False, 2), checkpoint_dir=d, every_n_items=every,
                           keep=keep)
    return fz, d, out


def test_resume_skips_a_corrupt_generation(tmp_path):
    fz, d, out = _completed(tmp_path)
    newest = segmented._gen_dirs(d)[-1]
    shard = sorted(f for f in os.listdir(newest) if f.endswith(".npz"))[0]
    guard._flip_payload(os.path.join(newest, shard))
    with pytest.raises(tq.QuESTChecksumError):
        tq.verify_snapshot(newest)
    telemetry.reset()
    again = resume_segmented(fz, d, tq.createQuESTEnv(device="cpu"))
    assert torch.equal(again.amps, out.amps)
    assert telemetry.counter_value("segmented_resume_total", outcome="skipped_corrupt") == 1
    assert telemetry.counter_value("segmented_resume_total", outcome="verified") == 1
    assert telemetry.counter_value("analysis_findings_total", code="QT305",
                                   severity="warning") == 1


def test_resume_rejects_a_torn_generation_then_none_left(tmp_path):
    fz, d, out = _completed(tmp_path, keep=2)
    gens = segmented._gen_dirs(d)
    os.unlink(os.path.join(gens[-1], "segment.json"))
    telemetry.reset()
    again = resume_segmented(fz, d, tq.createQuESTEnv(device="cpu"))
    assert torch.equal(again.amps, out.amps)
    assert telemetry.counter_value("segmented_resume_total", outcome="rejected_gen") == 1
    with open(os.path.join(gens[0], "qureg.json"), "w") as f:
        f.write("{")
    for g in segmented._gen_dirs(d):
        if os.path.exists(os.path.join(g, "segment.json")) and g != gens[0]:
            os.unlink(os.path.join(g, "segment.json"))
    telemetry.reset()
    with pytest.raises(QuESTError, match="passed verification"):
        resume_segmented(fz, d, tq.createQuESTEnv(device="cpu"))
    assert telemetry.counter_value("segmented_resume_total", outcome="no_verified_gen") == 1


def test_resume_refuses_another_circuit_and_an_empty_dir(tmp_path):
    fz, d, _ = _completed(tmp_path)
    other, _ = _fused(9, False, torch.float64, seed=4)
    assert other.fingerprint() != fz.fingerprint()
    with pytest.raises(QuESTError, match="fingerprint"):
        resume_segmented(other, d, tq.createQuESTEnv(device="cpu"))
    with pytest.raises(QuESTError, match="no checkpoint generations"):
        resume_segmented(fz, str(tmp_path / "empty"), tq.createQuESTEnv(device="cpu"))


@pytest.mark.parametrize("keep", [1, 2, 3])
def test_keep_retains_the_newest_generations(tmp_path, keep):
    fz, d, out = _completed(tmp_path, keep=keep)
    cuts = segment_plan(fz._tape, 9, 1)
    gens = [os.path.basename(g) for g in segmented._gen_dirs(d)]
    assert gens == [f"gen_{c:08d}" for c in cuts[-keep:]]
    m = json.load(open(os.path.join(d, gens[-1], "segment.json")))
    assert m == {"cursor": len(fz), "total_items": len(fz),
                 "fingerprint": fz.fingerprint(), "every_n_items": 1}


def test_resume_of_a_completed_run_runs_nothing(tmp_path):
    fz, d, out = _completed(tmp_path, every=2)
    telemetry.reset()
    again = resume_segmented(fz, d, tq.createQuESTEnv(device="cpu"))
    assert torch.equal(again.amps, out.amps)
    assert telemetry.counter_value("segmented_segments_total") == 0
    assert telemetry.counter_value("device_dispatch_total", route="segment") == 0


# -- the sentinel rollback ----------------------------------------------------------

@pytest.mark.parametrize("nth", [1, 3], ids=["baseline", "generation"])
@pytest.mark.parametrize("where", ["one", "four"])
def test_sentinel_rollback_bit_identical(tmp_path, where, nth):
    n, shards = (9, None) if where == "one" else (11, 4)
    fz, _ = _fused(n, False, torch.float64, shards=shards)
    env = tq.createQuESTEnv(devices=["cpu"] * 4) if shards else TENV
    clean = fz.run_segmented(_new(n, False, 2, env), checkpoint_dir=str(tmp_path / "c"))
    telemetry.reset()
    with sentinel_policy("default"), fault_plan(f"state.corrupt:bitflip1:{nth}"):
        healed = fz.run_segmented(_new(n, False, 2, env), checkpoint_dir=str(tmp_path / "h"))
    assert np.array_equal(_host(healed), _host(clean))
    assert telemetry.counter_value("segmented_rollbacks_total", outcome="replayed") == 1
    assert telemetry.counter_value("fault_injected_total", site="state.corrupt",
                                   kind="bitflip1") == 1
    ev = [e for e in telemetry.events() if e["name"] == "segmented.rollback"]
    assert [e["source"] for e in ev] == ["baseline" if nth == 1 else "gen"]


def test_forced_degrade_runs_the_item_route_through_the_kernel_wrapper(tmp_path,
                                                                      monkeypatch):
    fz, _ = _fused(9, False, torch.float64)
    clean = fz.run_segmented(_new(9, False, 2), checkpoint_dir=str(tmp_path / "c"),
                             every_n_items=2)
    cuts = segment_plan(fz._tape, 9, 2)
    wrapper, plain, inside = FG.fused_run, FG.fused_run_plain, []
    calls = {"wrapper": 0, "plain": 0, "plain_outside": 0}

    def counted_wrapper(*a, **k):
        calls["wrapper"] += 1
        inside.append(1)
        try:
            return wrapper(*a, **k)
        finally:
            inside.pop()

    def counted_plain(*a, **k):
        calls["plain"] += 1
        calls["plain_outside"] += not inside
        return plain(*a, **k)

    monkeypatch.setattr(FG, "fused_run", counted_wrapper)
    monkeypatch.setattr(FG, "fused_run_plain", counted_plain)
    telemetry.reset()
    with sentinel_policy("default"), fault_plan("state.corrupt:bitflip0:1+"):
        healed = fz.run_segmented(_new(9, False, 2), checkpoint_dir=str(tmp_path / "h"),
                                  every_n_items=2)
    assert torch.equal(healed.amps, clean.amps)
    segs = len(cuts) - 1
    assert telemetry.counter_value("segmented_rollbacks_total", outcome="degraded") == segs
    assert telemetry.counter_value("engine_fallback_total", reason="sentinel_degraded") == segs
    assert telemetry.counter_value("device_dispatch_total", route="item") == len(fz)
    runs = sum(f.__name__ == "_apply_pallas_run" for f, _a, _k in fz._tape)
    # every plain pass came from inside the wrapper (a CPU tensor), none around it
    assert calls["plain_outside"] == 0 and calls["plain"] == calls["wrapper"]
    assert calls["wrapper"] >= runs * 4  # per segment: 3 replays and the degrade


def test_corrupt_rollback_target_fails_closed(tmp_path):
    fz, _ = _fused(9, False, torch.float64)
    with sentinel_policy("default"), \
            fault_plan("checkpoint.write:corrupt:1,state.corrupt:bitflip0:2"):
        with pytest.raises(tq.QuESTChecksumError):
            fz.run_segmented(_new(9, False, 2), checkpoint_dir=str(tmp_path / "h"))


def test_sentinels_off_probe_points_do_nothing(tmp_path, monkeypatch):
    fz, _ = _fused(9, False, torch.float64)
    clean = fz.run_segmented(_new(9, False, 2), checkpoint_dir=str(tmp_path / "c"))

    def boom(*a, **k):
        raise AssertionError("a sentinel ran with no policy armed")

    monkeypatch.setattr(sentinel, "check_qureg", boom)
    monkeypatch.setattr(segmented, "_capture_baseline", boom)
    telemetry.reset()
    with sentinel_policy("off"):
        assert not sentinel.enabled()
        out = fz.run_segmented(_new(9, False, 2), checkpoint_dir=str(tmp_path / "a"))
        assert torch.equal(out.amps, clean.amps)
        with fault_plan("state.corrupt:bitflip0:1"):
            bad = fz.run_segmented(_new(9, False, 2), checkpoint_dir=str(tmp_path / "b"))
    assert not torch.equal(bad.amps, clean.amps)  # unhealed: nothing probed
    assert telemetry.counter_total("sentinel_checks_total") == 0
    assert telemetry.counter_total("segmented_rollbacks_total") == 0
