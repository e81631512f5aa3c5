"""The port's exchanges (quest_tpu_torch/parallel/exchange.py) against the
JAX package's (quest_tpu/parallel/exchange.py) on the emulated CPU mesh.

The same planar state, made with numpy from a seed, is sharded over d of
the 8 CPU devices for quest_tpu and over d virtual CPU shards for the port
(``createQuESTEnv(devices=["cpu"] * d)``); each routine's result, gathered,
must agree at 1e-10 (f64), and the bit permutations with a host oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from quest_tpu.environment import AMP_AXIS
from quest_tpu.ops import cplx as jcplx
from quest_tpu.parallel import exchange as JX
import quest_tpu as jq
import quest_tpu_torch as tq
from quest_tpu_torch import telemetry
from quest_tpu_torch.ops import cplx
from quest_tpu_torch.parallel import exchange as X
from quest_tpu_torch.parallel import mesh as M

TOL = 1e-10
N = 7


def _meshes(d):
    return jq.createQuESTEnv(jax.devices()[:d]).mesh, ("cpu",) * d


def _state(n, seed):
    return np.random.default_rng(seed).normal(size=(2, 1 << n)) / np.sqrt(2 << n)


def _jax(state, mesh):
    return jax.device_put(jnp.asarray(state), NamedSharding(mesh, PartitionSpec(None, AMP_AXIS)))


def _port(state, d):
    return [torch.tensor(c) for c in np.split(state, d, axis=1)]


def _gather(shards):
    return np.concatenate([s.numpy() for s in shards], axis=1)


def _close(got_shards, ref):
    np.testing.assert_allclose(_gather(got_shards), np.asarray(ref), rtol=0, atol=TOL)


def _unitary(k, seed):
    rng = np.random.RandomState(seed)
    q, r = np.linalg.qr(rng.randn(1 << k, 1 << k) + 1j * rng.randn(1 << k, 1 << k))
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _mats(u):
    return jcplx.from_complex(u, jnp.float64), cplx.from_complex(u, torch.float64, "cpu")


@pytest.mark.parametrize("d", [4, 8])
def test_mesh_bookkeeping_matches_reference(d):
    jmesh, tmesh = _meshes(d)
    from quest_tpu.parallel import mesh as JM
    for n in (5, 7, 12):
        assert M.local_qubit_count(n, tmesh) == JM.local_qubit_count(n, jmesh)
        assert M.shard_info(n, tmesh) == JM.shard_info(n, jmesh)[:2]
    assert M.local_qubit_count(9, ("cpu",)) == 9 and M.local_qubit_count(9, None) == 9


@pytest.mark.parametrize("d", [4, 8])
@pytest.mark.parametrize("target,controls,states,conj", [
    (1, (), (), False),            # local target
    (2, (N - 1,), (1,), False),    # local target, sharded control
    (N - 1, (), (), False),        # sharded target: pair exchange
    (N - 1, (0, N - 2), (0, 1), True),  # pair exchange, local and sharded controls
    (N - 2, (3,), (1,), False),
])
def test_dist_apply_matrix1_matches_reference(d, target, controls, states, conj):
    jmesh, _ = _meshes(d)
    state = _state(N, 1)
    jm, tm = _mats(_unitary(1, target))
    ref = JX.dist_apply_matrix1(_jax(state, jmesh), jm, n=N, target=target,
                                controls=controls, control_states=states, conj=conj,
                                mesh=jmesh)
    telemetry.reset()
    got = X.dist_apply_matrix1(_port(state, d), tm, n=N, target=target,
                               controls=controls, control_states=states, conj=conj)
    _close(got, ref)
    nl = N - (d - 1).bit_length()
    assert telemetry.counter_value("exchange_calls_total", kind="pair_exchange") == (
        1 if target >= nl else 0)


@pytest.mark.parametrize("d", [4, 8])
def test_dist_apply_local_matrix_matches_reference(d):
    jmesh, _ = _meshes(d)
    state = _state(N, 2)
    jm, tm = _mats(_unitary(2, 7))
    for controls, states in (((), ()), ((N - 1,), (0,)), ((3, N - 1), (1, 1))):
        ref = JX.dist_apply_local_matrix(_jax(state, jmesh), jm, n=N, targets=(0, 2),
                                         controls=controls, control_states=states,
                                         mesh=jmesh)
        got = X.dist_apply_local_matrix(_port(state, d), tm, n=N, targets=(0, 2),
                                        controls=controls, control_states=states)
        _close(got, ref)
    with pytest.raises(ValueError):
        X.dist_apply_local_matrix(_port(state, d), tm, n=N, targets=(0, N - 1))


@pytest.mark.parametrize("d", [4, 8])
@pytest.mark.parametrize("targets,controls,states", [
    ((1,), (), ()), ((N - 1,), (), ()), ((0, N - 1, N - 2), (2,), (1,)),
    ((N - 2,), (N - 1, 1), (0, 1)), ((3,), (N - 1,), (1,)),
])
def test_dist_apply_x_matches_reference(d, targets, controls, states):
    jmesh, _ = _meshes(d)
    state = _state(N, 3)
    ref = JX.dist_apply_x(_jax(state, jmesh), n=N, targets=targets, controls=controls,
                          control_states=states, mesh=jmesh)
    got = X.dist_apply_x(_port(state, d), n=N, targets=targets, controls=controls,
                         control_states=states)
    _close(got, ref)


@pytest.mark.parametrize("d", [4, 8])
@pytest.mark.parametrize("targets,controls,states,conj", [
    ((0, 3), (), (), False), ((N - 1, 1), (), (), True),
    ((N - 1, N - 2, 2), (4,), (1,), False), ((5,), (N - 1,), (0,), True),
])
def test_dist_apply_diag_phase_matches_reference(d, targets, controls, states, conj):
    jmesh, _ = _meshes(d)
    state = _state(N, 4)
    diag = np.exp(1j * np.random.RandomState(len(targets)).uniform(0, 6, 1 << len(targets)))
    ref = JX.dist_apply_diag_phase(_jax(state, jmesh), jcplx.from_complex(diag, jnp.float64),
                                   n=N, targets=targets, controls=controls,
                                   control_states=states, conj=conj, mesh=jmesh)
    got = X.dist_apply_diag_phase(_port(state, d), cplx.from_complex(diag, torch.float64, "cpu"),
                                  n=N, targets=targets, controls=controls,
                                  control_states=states, conj=conj)
    _close(got, ref)


@pytest.mark.parametrize("d", [4, 8])
@pytest.mark.parametrize("qubits,controls,states,conj", [
    ((0, 2), (), (), False), ((1, N - 1), (), (), True),
    ((N - 1, N - 2), (0,), (1,), False), ((2, 4, N - 1), (N - 2,), (0,), True),
])
def test_dist_apply_parity_phase_matches_reference(d, qubits, controls, states, conj):
    jmesh, _ = _meshes(d)
    state = _state(N, 5)
    ref = JX.dist_apply_parity_phase(_jax(state, jmesh), 0.73, n=N, qubits=qubits,
                                     controls=controls, control_states=states, conj=conj,
                                     mesh=jmesh)
    got = X.dist_apply_parity_phase(_port(state, d), 0.73, n=N, qubits=qubits,
                                    controls=controls, control_states=states, conj=conj)
    _close(got, ref)


@pytest.mark.parametrize("d", [4, 8])
@pytest.mark.parametrize("qb1,qb2,kind", [
    (0, 3, None), (1, N - 1, "swap_odd_parity"), (N - 1, N - 2, "swap_rank_permute"),
])
def test_dist_swap_matches_reference(d, qb1, qb2, kind):
    jmesh, _ = _meshes(d)
    nl = N - (d - 1).bit_length()
    if kind == "swap_rank_permute" and N - 2 < nl:
        kind = "swap_odd_parity"
    state = _state(N, 6)
    ref = JX.dist_swap(_jax(state, jmesh), n=N, qb1=qb1, qb2=qb2, mesh=jmesh)
    telemetry.reset()
    got = X.dist_swap(_port(state, d), n=N, qb1=qb1, qb2=qb2)
    _close(got, ref)
    if kind:
        assert telemetry.counter_value("exchange_calls_total", kind=kind) == 1


def _host_bit_permute(vec, n, source):
    """Oracle: new_bit[q] = old_bit[source[q]] on a flat (2, 2^n) array."""
    j = np.arange(1 << n)
    i = np.zeros_like(j)
    for q in range(n):
        i |= ((j >> q) & 1) << source[q]
    return vec[:, i]


_RNG = np.random.RandomState(11)
PERMS = [tuple(int(x) for x in _RNG.permutation(N)) for _ in range(6)] + [
    tuple(range(N)),            # identity: no-op
    (0, 1, 2, 3, 5, 4, 6),      # shard<->shard only (nl = 4 on 8 shards)
    (0, 1, 2, 6, 4, 5, 3),      # one crossing
    (3, 1, 2, 0, 4, 5, 6),      # local<->local only
    (4, 5, 2, 3, 0, 1, 6),      # two crossings
    (4, 5, 6, 3, 0, 1, 2),      # three crossings
]


@pytest.mark.parametrize("d", [4, 8])
def test_dist_permute_bits_matches_oracle_and_reference(d):
    jmesh, tmesh = _meshes(d)
    state = _state(N, 7)
    for source in PERMS:
        ref = JX.dist_permute_bits(_jax(state, jmesh), n=N, source=source, mesh=jmesh)
        telemetry.reset()
        shards = _port(state, d)
        out = [torch.empty_like(s) for s in shards]
        got = X.dist_permute_bits(shards, n=N, source=source,
                                  out=None if source[0] else out)
        np.testing.assert_allclose(_gather(got), _host_bit_permute(state, N, source),
                                   rtol=0, atol=0, err_msg=f"source={source}")
        _close(got, ref)
        np.testing.assert_array_equal(_gather(shards), state)  # input untouched
        identity = source == tuple(range(N))
        assert telemetry.counter_value("exchange_calls_total",
                                       kind="grouped_permute") == (0 if identity else 1)
        assert X.permute_collective_stats(N, source, tmesh) == \
            JX.permute_collective_stats(N, source, jmesh)


def test_permute_collective_stats_model():
    tmesh = ("cpu",) * 8  # nl = 4
    s = X.permute_collective_stats(N, tuple(range(N)), tmesh)
    assert s["collectives"] == 0 and s["chunk_units"] == 0.0
    s = X.permute_collective_stats(N, (0, 1, 2, 6, 4, 5, 3), tmesh)
    assert s["crossing_bits"] == 1 and s["chunk_units"] == 1.0 and s["collectives"] == 1
    s = X.permute_collective_stats(N, (4, 5, 6, 3, 0, 1, 2), tmesh)
    assert s["crossing_bits"] == 3 and s["chunk_units"] == 2.0 * (1 - 0.125)
    s = X.permute_collective_stats(N, (0, 1, 2, 3, 5, 4, 6), tmesh)
    assert s["relabel_ppermute"] and s["crossing_bits"] == 0 and s["chunk_units"] == 2.0
    with pytest.raises(ValueError):
        X.permute_collective_stats(N, (0, 0, 1, 2, 3, 4, 5), tmesh)


def test_exchanges_copy_between_shard_tensors():
    """An exchange leaves its input shards as they were and returns new
    tensors on each shard's device; a shard untouched by the gate (its
    sharded control misses) is handed back as it is."""
    state = _state(N, 8)
    shards = _port(state, 4)
    _, tm = _mats(_unitary(1, 3))
    got = X.dist_apply_matrix1(shards, tm, n=N, target=N - 1)
    assert all(g.data_ptr() != s.data_ptr() for g, s in zip(got, shards))
    np.testing.assert_array_equal(_gather(shards), state)
    got = X.dist_apply_matrix1(shards, tm, n=N, target=0, controls=(N - 1,))
    assert got[0] is shards[0] and got[1] is shards[1]
    assert got[2] is not shards[2]
