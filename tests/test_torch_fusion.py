"""The port's planner (quest_tpu_torch/fusion.py) against the JAX
package's (quest_tpu/fusion.py): at the same tile geometry the two plans
must be equal item for item -- op tuples, folded swaps, frame swaps,
dense blocks and barriers -- and the port's plan must replay to the same
state as the unfused circuit."""

import numpy as np
import pytest
import torch

from __graft_entry__ import _random_layers
from bench import _density_circuit
from quest_tpu import fusion as JF
from quest_tpu.circuits import Circuit as JCircuit
from quest_tpu.ops import pallas_gates as PG
import quest_tpu as jq
import quest_tpu_torch as tq
from quest_tpu_torch import fusion as F
from quest_tpu_torch.interop import circuit_from_tape, ops_from_reference
from quest_tpu_torch.ops import fused_gates as FG
from quest_tpu_torch.ops import init as ops_init

from . import oracle


def assert_ops_equal(got, ref):
    """Op tuples equal; a kraus op's terms (from each package's Choi
    decomposition) within 1e-12."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if r[0] in FG._KRAUS:
            (gr, gc, gt), (rr, rc, rt) = FG.kraus_parts(g), FG.kraus_parts(r)
            assert (g[0], gr, gc, len(gt)) == (r[0], rr, rc, len(rt))
            for (gs, gk), (rs, rk) in zip(gt, rt):
                assert gs == rs
                np.testing.assert_allclose(gk.arr, rk.arr, rtol=0, atol=1e-12)
        else:
            assert g == r


def _assert_args_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if isinstance(r, (list, tuple)) and not isinstance(r, str):
            _assert_args_equal(g, r)
        else:
            np.testing.assert_array_equal(g, r)


def assert_plans_equal(ref, got):
    assert len(got.items) == len(ref.items)
    assert (got.num_fused_gates, got.num_barriers) == (ref.num_fused_gates,
                                                         ref.num_barriers)
    for a, b in zip(ref.items, got.items):
        assert type(b).__name__ == type(a).__name__
        if isinstance(a, JF.PallasRun):
            assert_ops_equal(b.ops, ops_from_reference(a.ops))
            assert (b.tile_bits, b.load_swap_k, b.load_swap_hi, b.store_swap_k,
                    b.store_swap_hi) == (a.tile_bits, a.load_swap_k,
                                         a.load_swap_hi, a.store_swap_k,
                                         a.store_swap_hi)
            assert b.seg == a.seg  # the frame-identity segment stamps
        elif isinstance(a, JF.FrameSwap):
            assert (b.tile_bits, b.k, b.hi, b.seg) == (a.tile_bits, a.k, a.hi, a.seg)
        elif isinstance(a, JF.FusedBlock):
            assert b.qubits == a.qubits
            np.testing.assert_allclose(b.matrix, a.matrix, rtol=0, atol=1e-14)
        elif isinstance(a, JF.DiagBlock):
            assert b.qubits == a.qubits
            np.testing.assert_allclose(b.diag, a.diag, rtol=0, atol=1e-14)
        else:  # a barrier entry
            assert b[0].__name__ == a[0].__name__
            _assert_args_equal(b[1:], a[1:])


def _apply_run_via_engine(qureg, run):
    """A PallasRun replayed op by op through the per-gate engine, its
    folded swaps as explicit relabeling passes: the plain replay of a plan."""
    nsv, tb = qureg.num_qubits_in_state_vec, run.tile_bits

    def swap(k, hi):
        if k:
            qureg.put(FG.swap_bit_blocks(qureg.amps, n=nsv, lo1=tb - k,
                                         lo2=tb if hi is None else hi, k=k))

    swap(run.load_swap_k, run.load_swap_hi)
    F._apply_ops_via_engine(qureg, run.ops)
    swap(run.store_swap_k, run.store_swap_hi)


def _both(n, depth, seed):
    jc = JCircuit(n)
    _random_layers(jc, n, depth=depth, seed=seed)
    return jc, circuit_from_tape(jc._tape, n)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("n", [9, 10, 11, 12])
def test_pallas_plan_equals_reference(n, seed):
    """Pinned to the JAX tile geometry (sublanes=4, as the JAX tests pin
    it to force frames), the port's plan equals quest_tpu's."""
    jc, tc = _both(n, 3, seed)
    tb = PG.local_qubits(n, sublanes=4)
    ref = JF._plan_pallas(tuple(jc._tape), n, np.float64, 5, tb)
    got = F._plan_pallas(tuple(tc._tape), n, torch.float64, 5, tb)
    assert_plans_equal(ref, got)
    assert any(isinstance(i, F.PallasRun) and (i.load_swap_k or i.store_swap_k)
               for i in got.items) or n == tb


def test_bench_plan_at_hopper_tile_equals_reference():
    """The main path's plan -- the 26-qubit depth-8 bench circuit at the
    Hopper f32 tile (13 bits) -- equals what the JAX planner emits for the
    same geometry; it costs more passes than at the JAX tile (19 bits)."""
    n = 26
    jc, tc = _both(n, 8, 2026)
    fz = tc.fused(max_qubits=5, pallas=True, dtype=torch.float32)
    runs = [a[0] for f, a, _ in fz._tape if f is F._apply_pallas_run]
    assert len(runs) == len(fz._tape) and all(r.tile_bits == 13 for r in runs)
    ref = JF._plan_pallas(tuple(jc._tape), n, np.float32, 5, 13)
    got = F._plan_pallas(tuple(tc._tape), n, torch.float32, 5, 13)
    assert_plans_equal(ref, got)
    assert F.num_passes(got) == len(runs)
    wide = F._plan_pallas(tuple(tc._tape), n, torch.float32, 5,
                          PG.local_qubits(n))
    assert F.num_passes(wide) < F.num_passes(got)


def test_dense_plan_equals_reference_small_register():
    """Registers of <= 7 qubits take the ordinary dense fusion (FusedBlock
    windows and DiagBlocks), as in the JAX package."""
    n = 6
    jc = JCircuit(n)
    jc.hadamard(0)
    jc.controlledNot(0, 5)
    jc.rotateZ(3, 0.4)
    jc.tGate(2)
    jc.controlledPhaseFlip(1, 4)
    jc.rotateX(1, 1.2)
    tc = circuit_from_tape(jc._tape, n)
    ref = JF.plan(tuple(jc._tape), n, np.float64, max_qubits=3)
    got = F.plan(tuple(tc._tape), n, torch.float64, max_qubits=3)
    assert_plans_equal(ref, got)
    fz = tc.fused(max_qubits=3, pallas=True)
    assert all(f is not F._apply_pallas_run for f, _, _ in fz._tape)
    mk = lambda: ops_init.init_debug(1 << n, torch.float64, "cpu")  # noqa: E731
    np.testing.assert_allclose(fz.as_fn()(mk()).numpy(), tc.as_fn()(mk()).numpy(),
                               rtol=1e-10, atol=1e-10)


def test_barrier_entries_pass_through():
    """A tape entry the spy cannot capture (a state initialiser) flushes the
    open runs and stays in the plan unchanged, in both packages."""
    n = 10
    jc = JCircuit(n)
    jc.hadamard(0)
    jc.initPlusState()
    jc.hadamard(9)
    tc = circuit_from_tape(jc._tape, n)
    ref = JF._plan_pallas(tuple(jc._tape), n, np.float64, 5, 9)
    got = F._plan_pallas(tuple(tc._tape), n, torch.float64, 5, 9)
    assert_plans_equal(ref, got)
    assert got.num_barriers == 1


@pytest.mark.parametrize("n", [10, 12])
def test_plan_replays_to_unfused_state(n):
    """Kernel route (plain version on the CPU), the plan replayed op by op
    through the per-gate engine, and the unfused circuit agree."""
    _, tc = _both(n, 3, 5)
    tb = PG.local_qubits(n, sublanes=4)
    p = F.plan(tuple(tc._tape), n, torch.float64, pallas_tile_bits=tb)
    env = tq.createQuESTEnv(device="cpu")
    q_kernel, q_engine, q_ref = (tq.createQureg(n, env, 2) for _ in range(3))
    for q in (q_kernel, q_engine, q_ref):
        tq.initDebugState(q)
    for f, a, kw in F.as_tape(p):
        f(q_kernel, *a, **kw)
    assert all(isinstance(item, F.PallasRun) for item in p.items)
    for item in p.items:
        _apply_run_via_engine(q_engine, item)
    tc.run(q_ref)
    ref = q_ref.amps.numpy()
    for q in (q_kernel, q_engine):
        np.testing.assert_allclose(q.amps.numpy(), ref, rtol=1e-10,
                                   atol=1e-10 * np.abs(ref).max())


def _density_tape(kind, n):
    if kind == "r4":
        return _density_circuit(n, True)
    jc = JCircuit(n, is_density_matrix=True)
    _random_layers(jc, n, depth=2, seed=n)
    if kind == "layers+channels":
        jc.mixDepolarising(n - 1, 0.1)
        jc.mixTwoQubitDepolarising(0, n - 2, 0.2)
        jc.mixDamping(2, 0.3)
        jc.mixMultiQubitKrausMap([n - 1, 0, 2], [np.eye(8)])
        jc.mixDephasing(n - 3, 0.1)
        _random_layers(jc, n, depth=1, seed=n + 1)
    return jc


@pytest.mark.parametrize("kind", ["r4", "layers", "layers+channels"])
@pytest.mark.parametrize("n", [5, 6])
def test_density_pallas_plan_equals_reference(n, kind):
    """Density tapes (the bench's r4 channel circuit, random layers with
    and without channels) at the pinned tile local_qubits(2n, sublanes=4):
    the port's plan equals quest_tpu's item for item -- shadow ops, kraus
    ops with their terms, frame swaps and barriers."""
    jc = _density_tape(kind, n)
    tc = circuit_from_tape(jc._tape, n, True)
    tb = PG.local_qubits(2 * n, sublanes=4)
    ref = JF._plan_pallas(tuple(jc._tape), n, np.float64, 4, tb, is_density=True)
    got = F._plan_pallas(tuple(tc._tape), n, torch.float64, 4, tb, is_density=True)
    assert_plans_equal(ref, got)
    ops = [op for i in got.items if isinstance(i, F.PallasRun) for op in i.ops]
    assert any(op[0] == "matrix" and op[1] >= n for op in ops)  # shadow ops
    if kind != "layers":
        assert {op[0] for op in ops} & set(FG._KRAUS)
    assert any(isinstance(i, F.PallasRun) and (i.load_swap_k or i.store_swap_k)
               for i in got.items)


# ---------------------------------------------------------------------------
# the dense-gate surface
# ---------------------------------------------------------------------------

def _surface_tape(n, is_density=False):
    """chip_smoke.py's gate-surface tape (every tapeable gate and operator
    beyond the bench set, twice), recorded on a quest_tpu Circuit and
    carried across."""
    from chip_smoke import gate_surface_tape

    jc = JCircuit(n, is_density_matrix=is_density)
    gate_surface_tape(jc, jq, n, seed=n, with_left_mult=not is_density)
    return jc, circuit_from_tape(jc._tape, n, is_density)


@pytest.mark.parametrize("n", [9, 11])
def test_gate_surface_plan_equals_reference(n):
    """Plans of a circuit of the new gates and operators equal quest_tpu's
    item for item at the pinned tile (kernel ops, dense window blocks,
    the applyMatrix* barriers), and replay to the unfused state."""
    jc, tc = _surface_tape(n)
    tb = PG.local_qubits(n, sublanes=4)
    ref = JF._plan_pallas(tuple(jc._tape), n, np.float64, 5, tb)
    got = F._plan_pallas(tuple(tc._tape), n, torch.float64, 5, tb)
    assert_plans_equal(ref, got)
    kinds = {type(i).__name__ for i in got.items}
    assert {"PallasRun", "FusedBlock", "tuple"} <= kinds
    env = tq.createQuESTEnv(device="cpu")
    q_plan, q_ref = tq.createQureg(n, env, 2), tq.createQureg(n, env, 2)
    for q in (q_plan, q_ref):
        tq.initPlusState(q)
    for f, a, kw in F.as_tape(got):
        f(q_plan, *a, **kw)
    tc.run(q_ref)
    np.testing.assert_allclose(q_plan.amps.numpy(), q_ref.amps.numpy(), rtol=0, atol=1e-10)


def test_gate_surface_density_plan_equals_reference():
    n = 5
    jc, tc = _surface_tape(n, is_density=True)
    tb = PG.local_qubits(2 * n, sublanes=4)
    ref = JF._plan_pallas(tuple(jc._tape), n, np.float64, 5, tb, is_density=True)
    got = F._plan_pallas(tuple(tc._tape), n, torch.float64, 5, tb, is_density=True)
    assert_plans_equal(ref, got)
    dense = JF.plan(tuple(jc._tape), n, np.float64, max_qubits=5)
    assert_plans_equal(dense, F.plan(tuple(tc._tape), n, torch.float64, max_qubits=5))


class _Shell:
    """The register attributes the dense-block dispatch reads."""

    def __init__(self, nsv, is_density):
        self.num_qubits_in_state_vec = nsv
        self.is_density_matrix = is_density
        self.amps = None

    def put(self, amps):
        self.amps = amps


def test_dense_block_route_matches_reference(monkeypatch):
    """The route the port takes for a FusedBlock on the card is the one
    quest_tpu's _apply_dense_block takes on its accelerator: a lane_u pass
    of the fused kernel for a state-vector window with hi < 7 and at least
    2 x 128 amplitudes, the engine otherwise. On a CPU register the port
    always takes the engine."""
    import quest_tpu.gates as JG

    taken = []
    monkeypatch.setattr(JF, "_pallas_usable", lambda q: True)
    monkeypatch.setattr(PG, "fused_local_run",
                        lambda amps, **kw: taken.append("lane_u") or amps)
    monkeypatch.setattr(JG, "_apply_gate_matrix",
                        lambda *a, **kw: taken.append("engine"))
    windows = [(0,), (2, 3, 4), (3, 4, 5, 6), (5, 6, 7), (6,), (7, 8), (9, 10, 11)]
    for nsv in (7, 8, 9, 12):
        for is_density in (False, True):
            for qubits in windows:
                if qubits[-1] >= nsv:
                    continue
                U = np.eye(1 << len(qubits), dtype=complex)
                JF._apply_dense_block(_Shell(nsv, is_density), U, qubits)
                assert F.dense_block_route(nsv, is_density, qubits, True) == taken[-1]
                assert F.dense_block_route(nsv, is_density, qubits, False) == "engine"
    assert {"lane_u", "engine"} == set(taken)


@pytest.mark.parametrize("qubits", [(0, 1), (2, 4, 5), (1, 2, 3, 4, 6)])
def test_lane_u_pass_matches_engine(qubits):
    """A dense block as one lane_u pass (the kernel's plain version on the
    CPU) equals the block through the per-gate engine."""
    n = 10
    env = tq.createQuESTEnv(device="cpu")
    U = oracle.random_unitary(len(qubits), np.random.RandomState(len(qubits)))
    q_lane, q_engine = tq.createQureg(n, env, 2), tq.createQureg(n, env, 2)
    for q in (q_lane, q_engine):
        tq.initDebugState(q)
    window = tuple(range(qubits[0], qubits[-1] + 1))
    block = F.FusedBlock(window, F.event_matrix(
        F.GateEvent("matrix", qubits, matrix=U), window))
    for _ in range(2):  # the second replay reuses the block's prepared pass
        F._lane_u_pass(q_lane, block)
        tq.multiQubitUnitary(q_engine, list(qubits), U)
    assert block.lane_run is not None
    ref = q_engine.amps.numpy()
    np.testing.assert_allclose(q_lane.amps.numpy(), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
