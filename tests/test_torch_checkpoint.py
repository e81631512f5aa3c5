"""The port's checkpoints (quest_tpu_torch/checkpoint.py) against
quest_tpu.checkpoint on the CPU, at 4-8 qubits.

- round trips of state vectors and density registers, f32 and f64, bit for
  bit, with the env's RNG restored: the measurement sequence after a load
  equals the one drawn after the save, and quest_tpu's on the same
  snapshot;
- snapshots across the packages: the port's load in ``quest_tpu`` (one
  device and its 8 virtual devices), ``quest_tpu``'s (made on one device
  and on 8) in the port on one device and on 4 virtual shards, bit for bit;
- the same bytes: at one device both packages write the same
  ``qureg.json`` and the same shard names and CRCs, and byte-identical
  ``writeStateToCSV`` files;
- format 1, the sharded save's files and ranges, the seeds file;
- rejections (a torn shard, a CRC flip, a coverage gap, corrupt
  metadata) raise without creating a register or touching the env's RNG;
- the ``checkpoint.write`` faults: ``io`` retried, ``torn`` and
  ``corrupt`` caught by ``verify_snapshot``.

States are drawn from numpy seeds; snapshots compare bit for bit.
"""

import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quest_tpu as jq
import quest_tpu_torch as tq
from quest_tpu_torch import checkpoint as tck
from quest_tpu_torch import telemetry
from quest_tpu_torch.resilience import faultinject, fault_plan, guard
from quest_tpu_torch.validation import QuESTError

TENV = tq.createQuESTEnv(device="cpu")
TENV4 = tq.createQuESTEnv(devices=["cpu"] * 4)
JENV = jq.createQuESTEnv(jax.devices()[:1])
JENV8 = jq.createQuESTEnv(jax.devices())
SEEDS = [11, 22]
PRECS = {"f64": 2, "f32": 1}


def _planar(n, density, seed):
    """A valid state (a mixed rho for a density register) as planar (2, N)
    float64, rho in the [column, row] flattening."""
    rng = np.random.RandomState(seed)
    dim = 1 << n
    if not density:
        v = rng.normal(size=dim) + 1j * rng.normal(size=dim)
        v /= np.linalg.norm(v)
    else:
        vs = rng.normal(size=(3, dim)) + 1j * rng.normal(size=(3, dim))
        vs /= np.linalg.norm(vs, axis=1, keepdims=True)
        rho = sum(p * np.outer(v, v.conj()) for p, v in zip((0.5, 0.3, 0.2), vs))
        v = rho.T.reshape(-1)
    return np.stack([v.real, v.imag])


def _port(n, density, prec, env=TENV, seed=5):
    q = (tq.createDensityQureg if density else tq.createQureg)(n, env, prec)
    p = _planar(n, density, seed)
    tq.initStateFromAmps(q, p[0], p[1])
    return q


def _jax(n, density, prec, env=JENV, seed=5):
    q = (jq.createDensityQureg if density else jq.createQureg)(n, env, prec)
    p = _planar(n, density, seed)
    q.put(jax.device_put(jnp.asarray(p, dtype=q.amps.dtype), q.amps.sharding))
    return q


def _port_host(q):
    pieces = [q.amps] if q.shards is None else q.shards
    return np.concatenate([t.numpy() for t in pieces], axis=1)


def _measures(pkg, q, env, n):
    """Measure every qubit of clones of ``q`` twice over: the outcomes
    depend on the env's RNG stream."""
    out = []
    for _ in range(2):
        c = pkg.createCloneQureg(q, env)
        out += [pkg.measure(c, t) for t in range(n)]
    return out


def _seeded(pkg, env):
    pkg.seedQuEST(env, SEEDS)
    return env


# -- round trips --------------------------------------------------------------

@pytest.mark.parametrize("prec", list(PRECS))
@pytest.mark.parametrize("density", [False, True], ids=["sv", "density"])
def test_round_trip_bits_and_rng(tmp_path, density, prec):
    n = 3 if density else 6
    env = _seeded(tq, tq.createQuESTEnv(device="cpu"))
    env.rng.random_sample(7)  # a stream position away from the seed's
    q = _port(n, density, PRECS[prec], env)
    d = str(tmp_path / "ck")
    tq.saveQureg(q, d)
    after_save = _measures(tq, q, env, n)
    env2 = tq.createQuESTEnv(device="cpu")
    q2 = tq.loadQureg(d, env2)
    assert q2.is_density_matrix == density and q2.num_qubits_represented == n
    assert q2.dtype == q.dtype and torch.equal(q2.amps, q.amps)
    assert env2.seeds == SEEDS
    assert _measures(tq, q2, env2, n) == after_save
    # quest_tpu on the same snapshot draws the same outcomes
    jenv = jq.createQuESTEnv(jax.devices()[:1])
    jqr = jq.loadQureg(d, jenv)
    assert _measures(jq, jqr, jenv, n) == after_save


# -- across the packages ------------------------------------------------------

@pytest.mark.parametrize("jenv", ["one", "eight"])
@pytest.mark.parametrize("src", ["sv", "sv_4_shards", "density"])
def test_port_snapshot_loads_in_quest_tpu(tmp_path, src, jenv):
    density = src == "density"
    n = 4 if density else 7
    q = _port(n, density, 2, TENV4 if src == "sv_4_shards" else TENV)
    d = str(tmp_path / "ck")
    tq.saveQureg(q, d)
    jqr = jq.loadQureg(d, JENV if jenv == "one" else JENV8)
    assert jqr.is_density_matrix == density
    np.testing.assert_array_equal(np.asarray(jqr.amps), _port_host(q))


@pytest.mark.parametrize("tenv", ["one", "four"])
@pytest.mark.parametrize("jenv", ["one", "eight"])
def test_quest_tpu_snapshot_loads_in_port(tmp_path, jenv, tenv):
    jqr = _jax(7, False, 2, JENV if jenv == "one" else JENV8, seed=9)
    d = str(tmp_path / "ck")
    jq.saveQureg(jqr, d)
    assert len(json.load(open(os.path.join(d, "qureg.json")))["shards"]) == (
        1 if jenv == "one" else 8)
    q = tq.loadQureg(d, TENV if tenv == "one" else TENV4)
    assert (q.shards is None) == (tenv == "one")
    assert q.shards is None or len(q.shards) == 4
    np.testing.assert_array_equal(_port_host(q), np.asarray(jqr.amps))


@pytest.mark.parametrize("prec", list(PRECS))
def test_quest_tpu_density_snapshot_loads_in_port(tmp_path, prec):
    jqr = _jax(3, True, PRECS[prec], JENV8, seed=3)
    d = str(tmp_path / "ck")
    jq.saveQureg(jqr, d)
    q = tq.loadQureg(d, TENV)
    assert q.is_density_matrix and q.dtype == (torch.float64 if prec == "f64"
                                               else torch.float32)
    np.testing.assert_array_equal(_port_host(q), np.asarray(jqr.amps))
    assert abs(tq.calcTotalProb(q) - 1) < (1e-12 if prec == "f64" else 1e-6)


@pytest.mark.parametrize("prec", list(PRECS))
@pytest.mark.parametrize("jenv", ["one", "eight"])
def test_sharded_density_snapshots_both_ways(tmp_path, jenv, prec):
    """A density register on 4 shards saves 4 shard files that quest_tpu
    loads (on one device or eight) bit for bit; quest_tpu's density
    snapshot loads onto the port's 4 shards bit for bit, with its trace;
    and the port's own snapshot loads back onto the shards and onto one
    device."""
    n = 4
    q = _port(n, True, PRECS[prec], TENV4, seed=12)
    assert len(q.shards) == 4
    d = str(tmp_path / "port")
    tq.saveQureg(q, d)
    assert len(json.load(open(os.path.join(d, "qureg.json")))["shards"]) == 4
    jqr = jq.loadQureg(d, JENV if jenv == "one" else JENV8)
    assert jqr.is_density_matrix
    np.testing.assert_array_equal(np.asarray(jqr.amps), _port_host(q))
    for env in (TENV4, TENV):
        back = tq.loadQureg(d, env)
        assert back.is_density_matrix and (back.shards is None) == (env is TENV)
        np.testing.assert_array_equal(_port_host(back), _port_host(q))
    jsrc = _jax(n, True, PRECS[prec], JENV if jenv == "one" else JENV8, seed=13)
    dj = str(tmp_path / "jax")
    jq.saveQureg(jsrc, dj)
    mine = tq.loadQureg(dj, TENV4)
    assert mine.is_density_matrix and len(mine.shards) == 4
    np.testing.assert_array_equal(_port_host(mine), np.asarray(jsrc.amps))
    assert abs(tq.calcTotalProb(mine) - 1) < (1e-12 if prec == "f64" else 1e-6)


# -- the same bytes -----------------------------------------------------------

@pytest.mark.parametrize("prec", list(PRECS))
@pytest.mark.parametrize("density", [False, True], ids=["sv", "density"])
def test_same_index_shard_names_and_crcs(tmp_path, density, prec):
    n = 3 if density else 6
    tenv = _seeded(tq, tq.createQuESTEnv(device="cpu"))
    jenv = _seeded(jq, jq.createQuESTEnv(jax.devices()[:1]))
    tq.saveQureg(_port(n, density, PRECS[prec], tenv), str(tmp_path / "t"))
    jq.saveQureg(_jax(n, density, PRECS[prec], jenv), str(tmp_path / "j"))
    mt = json.load(open(tmp_path / "t" / "qureg.json"))
    mj = json.load(open(tmp_path / "j" / "qureg.json"))
    assert list(mt) == list(mj)
    assert mt == mj  # keys, shard names, ranges, CRCs, seeds and RNG state
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    assert (tmp_path / "t" / "qureg.json").read_bytes() == \
        (tmp_path / "j" / "qureg.json").read_bytes()


@pytest.mark.parametrize("prec", list(PRECS))
@pytest.mark.parametrize("layout", ["sv", "sv_4_shards", "density"])
def test_write_state_csv_byte_identical(tmp_path, layout, prec):
    density = layout == "density"
    n = 3 if density else 5
    q = _port(n, density, PRECS[prec], TENV4 if layout == "sv_4_shards" else TENV)
    jqr = _jax(n, density, PRECS[prec])
    ft = tq.writeStateToCSV(q, str(tmp_path / "t.csv"))
    fj = jq.writeStateToCSV(jqr, str(tmp_path / "j.csv"))
    assert open(ft, "rb").read() == open(fj, "rb").read()
    assert open(ft).read().count("\n") == 1 + (1 << ((2 if density else 1) * n))


def test_write_state_csv_default_name(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert tq.writeStateToCSV(_port(2, False, 2)) == "state_rank_0.csv"
    assert (tmp_path / "state_rank_0.csv").read_text().startswith("real, imag\n")


def test_seeds_file_round_trip_matches_quest_tpu(tmp_path):
    tenv = _seeded(tq, tq.createQuESTEnv(device="cpu"))
    jenv = _seeded(jq, jq.createQuESTEnv(jax.devices()[:1]))
    tenv.rng.random_sample(3)
    jenv.rng.random_sample(3)
    tck.saveSeeds(tenv, str(tmp_path / "t.json"))
    jq.checkpoint.saveSeeds(jenv, str(tmp_path / "j.json"))
    assert json.load(open(tmp_path / "t.json")) == json.load(open(tmp_path / "j.json"))
    after = tenv.rng.random_sample(4)
    other = tq.createQuESTEnv(device="cpu")
    tck.loadSeeds(other, str(tmp_path / "j.json"))
    assert other.seeds == SEEDS
    np.testing.assert_array_equal(other.rng.random_sample(4), after)


# -- format 1, sharded saves ----------------------------------------------------

@pytest.mark.parametrize("prec", list(PRECS))
def test_format1_snapshot_loads(tmp_path, prec):
    dt = np.float64 if prec == "f64" else np.float32
    p = _planar(5, False, 4).astype(dt)
    d = tmp_path / "f1"
    d.mkdir()
    np.savez_compressed(d / "amps.npz", amps=p)
    meta = {"format": 1, "num_qubits_represented": 5, "is_density_matrix": False,
            "dtype": np.dtype(dt).name, "num_amps_total": 32, "seeds": [],
            "rng_state": None}
    (d / "qureg.json").write_text(json.dumps(meta))
    assert tq.verify_snapshot(str(d))["format"] == 1
    for env in (TENV, TENV4):
        np.testing.assert_array_equal(_port_host(tq.loadQureg(str(d), env)), p)


@pytest.mark.parametrize("prec", list(PRECS))
def test_sharded_save_writes_one_file_per_shard(tmp_path, prec):
    q = _port(8, False, PRECS[prec], TENV4)
    d = tmp_path / "ck"
    tq.saveQureg(q, str(d))
    meta = json.load(open(d / "qureg.json"))
    assert [(e["start"], e["stop"]) for e in meta["shards"]] == [
        (r * 64, (r + 1) * 64) for r in range(4)]
    assert sorted(f for f in os.listdir(d) if f.endswith(".npz")) == [
        f"amps.shard_{r * 64:016x}.npz" for r in range(4)]
    for e, s in zip(meta["shards"], q.shards):
        with np.load(d / e["file"]) as z:
            np.testing.assert_array_equal(z["amps"], s.numpy())
            assert (int(z["start"]), int(z["stop"])) == (e["start"], e["stop"])
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]


def test_writer_pieces_read_back(tmp_path, monkeypatch):
    """A payload of many DEFLATE pieces is one valid zip member that np.load
    and quest_tpu read."""
    monkeypatch.setattr(tck, "_DEFLATE_PIECE", 1000)
    q = _port(9, False, 2)
    d = str(tmp_path / "ck")
    tq.saveQureg(q, d)
    path = os.path.join(d, "amps.shard_0000000000000000.npz")
    with zipfile.ZipFile(path) as z:
        assert z.testzip() is None
        assert z.namelist() == ["amps.npy", "start.npy", "stop.npy"]
        assert z.getinfo("amps.npy").compress_type == zipfile.ZIP_DEFLATED
    with np.load(path) as z:
        np.testing.assert_array_equal(z["amps"], q.amps.numpy())
        assert (int(z["start"]), int(z["stop"])) == (0, 512)
    np.testing.assert_array_equal(np.asarray(jq.loadQureg(d, JENV).amps), _port_host(q))


# -- rejections leave nothing changed ------------------------------------------

def _torn(d, meta):
    path = os.path.join(d, meta["shards"][1]["file"])
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)


def _crc_flip(d, meta):
    guard._flip_payload(os.path.join(d, meta["shards"][2]["file"]))


def _gap(d, meta):
    meta["shards"] = meta["shards"][:1] + meta["shards"][2:]
    json.dump(meta, open(os.path.join(d, "qureg.json"), "w"))


def _bad_meta(d, meta):
    with open(os.path.join(d, "qureg.json"), "w") as f:
        f.write('{"format": 2, "num_qub')


REJECTIONS = {"torn": (_torn, "unreadable checkpoint shard"),
              "crc_flip": (_crc_flip, "failed CRC32"),
              "gap": (_gap, "cover"),
              "corrupt_meta": (_bad_meta, "metadata")}


@pytest.mark.parametrize("kind", list(REJECTIONS))
def test_rejection_creates_nothing_and_keeps_rng(tmp_path, monkeypatch, kind):
    q = _port(8, False, 2, TENV4)
    d = str(tmp_path / "ck")
    tq.saveQureg(q, d)
    damage, match = REJECTIONS[kind]
    damage(d, json.load(open(os.path.join(d, "qureg.json"))))
    made = []
    monkeypatch.setattr(tck, "Qureg", lambda *a, **k: made.append(a))
    env = _seeded(tq, tq.createQuESTEnv(devices=["cpu"] * 4))
    env.seeds = [1, 2, 3]  # distinct from the snapshot's
    state = env.rng.get_state()
    for call in (lambda: tq.verify_snapshot(d), lambda: tq.loadQureg(d, env)):
        with pytest.raises(QuESTError, match=match) as err:
            call()
        if kind == "crc_flip":
            e = err.value
            assert isinstance(e, tq.QuESTChecksumError)
            assert e.shard == "amps.shard_0000000000000080.npz"
            with np.load(os.path.join(d, e.shard)) as z:
                import zlib
                assert e.actual_crc == zlib.crc32(np.ascontiguousarray(z["amps"]))
            assert e.expected_crc == zlib.crc32(q.shards[2].numpy())
            assert e.expected_crc != e.actual_crc
    assert made == [] and env.seeds == [1, 2, 3]
    after = env.rng.get_state()
    assert after[0] == state[0] and np.array_equal(after[1], state[1])
    assert after[2:] == state[2:]


def test_missing_snapshot_and_density_on_shards_refused(tmp_path):
    """A missing snapshot is refused and changes nothing; a density
    snapshot, once refused on a mesh, now loads onto its shards (and
    restores the env's seeds)."""
    env = _seeded(tq, tq.createQuESTEnv(devices=["cpu"] * 4))
    env.seeds = [7]
    with pytest.raises(QuESTError, match="no checkpoint"):
        tq.loadQureg(str(tmp_path / "nowhere"), env)
    assert env.seeds == [7]
    d = str(tmp_path / "ck")
    src = _port(3, True, 2)
    tq.saveQureg(src, d)
    q = tq.loadQureg(d, env)
    assert q.is_density_matrix and len(q.shards) == 4
    np.testing.assert_array_equal(_port_host(q), _port_host(src))


# -- the checkpoint.write site ----------------------------------------------------

def test_write_io_fault_is_retried(tmp_path):
    q = _port(6, False, 2, TENV4)
    telemetry.reset()
    with fault_plan("checkpoint.write:io:2"):
        tq.saveQureg(q, str(tmp_path / "ck"))
    assert telemetry.counter_value("retry_attempts_total", site="checkpoint.write",
                                   outcome="retried") == 1
    assert telemetry.counter_value("fault_injected_total", site="checkpoint.write",
                                   kind="io") == 1
    tq.verify_snapshot(str(tmp_path / "ck"))
    np.testing.assert_array_equal(_port_host(tq.loadQureg(str(tmp_path / "ck"), TENV)),
                                  _port_host(q))


@pytest.mark.parametrize("kind", ["torn", "corrupt"])
def test_write_torn_and_corrupt_are_caught(tmp_path, kind):
    q = _port(6, False, 2)
    d = str(tmp_path / "ck")
    with fault_plan(f"checkpoint.write:{kind}:1"):
        tq.saveQureg(q, d)
    with pytest.raises(tq.QuESTChecksumError if kind == "corrupt" else QuESTError):
        tq.verify_snapshot(d)
    # the JAX package's verifier agrees
    with pytest.raises(jq.QuESTChecksumError if kind == "corrupt" else jq.QuESTError):
        jq.verify_snapshot(d)


@pytest.mark.parametrize("kind", ["torn", "corrupt"])
def test_corrupt_file_helper(tmp_path, kind):
    path = tmp_path / "blob"
    path.write_bytes(bytes(range(64)))
    with fault_plan(f"checkpoint.write:{kind}:2"):
        assert faultinject.corrupt_file("checkpoint.write", str(path)) is None
        assert faultinject.corrupt_file("checkpoint.write", str(path)) == kind
    data = path.read_bytes()
    if kind == "torn":
        assert data == bytes(range(32))
    else:
        assert len(data) == 64 and data[32] == 32 ^ 0xFF


@pytest.mark.parametrize("spec,ok", [("checkpoint.write:torn:1", True),
                                     ("segment.boundary:preempt:2+", True),
                                     ("segment.boundary:torn:1", False)])
def test_new_sites_parse(spec, ok):
    if ok:
        plan = faultinject.FaultPlan.parse(spec, strict=True)
        assert plan.specs[0].site == spec.split(":")[0]
    else:
        with pytest.raises(QuESTError, match="QT302"):
            faultinject.FaultPlan.parse(spec, strict=True)
