"""The port's density-matrix route (quest_tpu_torch) against quest_tpu and
the dense numpy oracle (tests/oracle.py).

Inputs are made with numpy from fixed seeds and fed to both packages. The
JAX side runs its Pallas kernel in the interpreter, as its own tests do;
the port's side runs the kernel's plain version (CPU tensors). Tolerances:
1e-10 in f64 (the suite's precision), 2e-4 in f32, where the port's
superoperator and the JAX per-term accumulation sum in other orders;
errors are measured at the state's scale (max |amplitude|, at least 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quest_tpu as jq
from __graft_entry__ import _random_layers
from bench import _density_circuit
from quest_tpu import channels as JCH
from quest_tpu import fusion as JF
from quest_tpu.circuits import Circuit as JCircuit
from quest_tpu.ops import density as JDN
from quest_tpu.ops import pallas_gates as PG
import quest_tpu_torch as tq
from quest_tpu_torch import fusion as F, telemetry
from quest_tpu_torch.interop import (circuit_from_tape, ops_from_reference,
                                     state_from_numpy, state_to_numpy)
from quest_tpu_torch.ops import density as DN
from quest_tpu_torch.ops import fused_gates as FG

from . import oracle

TOL = 1e-10


def assert_close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * max(np.abs(ref).max(), 1.0))


def _flat(rho):
    """A (2^n, 2^n) density matrix -> planar flattened (2, 4^n), col-major."""
    f = rho.T.reshape(-1)
    return np.stack([f.real, f.imag])


def _matrix(planar, n):
    """Planar flattened state -> the (2^n, 2^n) density matrix."""
    p = np.asarray(planar)
    return (p[0] + 1j * p[1]).reshape(1 << n, 1 << n).T


def _hm(rng, d, scale=0.5):
    return PG.HashableMatrix(scale * (rng.randn(d, d) + 1j * rng.randn(d, d)))


# ---------------------------------------------------------------------------
# the kraus kernel ops: plain version against the JAX kernel (interpreter)
# ---------------------------------------------------------------------------

def _kraus_cases():
    """(name, ops, swap kwargs) on a 12-qubit flattened state (a 6-qubit
    density matrix) with 9 tile bits (sublanes=4): each kind without and
    with folded load/store swaps relocating its column qubits into the tile."""
    rng = np.random.RandomState(21)
    u8 = np.linalg.qr(rng.randn(8, 8) + 1j * rng.randn(8, 8))[0]
    signed = ((1.0, PG.HashableMatrix(0.9 * u8)),
              (-1.0, PG.HashableMatrix(0.4 * np.eye(8))))
    two = tuple((1.0, _hm(rng, 2)) for _ in range(3))
    four = tuple((s, _hm(rng, 4, 0.3)) for s in (1.0, -1.0))
    eight = ((1.0, _hm(rng, 8, 0.3)), (1.0, _hm(rng, 8, 0.2)))
    return [
        ("kraus1", (("kraus1", 2, 8, two),), {}),
        ("kraus1+swap", (("kraus1", 4, 8, two),),
         dict(load_swap_k=1, load_swap_hi=10, store_swap_k=1, store_swap_hi=10)),
        ("kraus2", (("kraus2", 1, 0, 7, 6, four),), {}),
        ("kraus2+swap", (("kraus2", 4, 5, 7, 8, four),),
         dict(load_swap_k=2, load_swap_hi=10, store_swap_k=2, store_swap_hi=10)),
        ("krausn_unsorted", (("krausn", (4, 0, 2), (8, 6, 7), eight),), {}),
        ("krausn_signed+swap", (("krausn", (0, 2, 1), (7, 8, 6), signed),),
         dict(load_swap_k=2, load_swap_hi=10, store_swap_k=2, store_swap_hi=10)),
    ]


@pytest.mark.parametrize("name,ops,swaps", _kraus_cases(),
                         ids=[c[0] for c in _kraus_cases()])
def test_kraus_op_plain_matches_reference(name, ops, swaps):
    n, tb = 12, 9
    state = np.random.default_rng(len(name)).normal(size=(2, 1 << n))
    ref = PG.fused_local_run(jnp.asarray(state), n=n, ops=ops, sublanes=4,
                             interpret=True, **swaps)
    t = state_from_numpy(state, "cpu")
    got = FG.fused_run(t, n=n, ops=ops_from_reference(ops), tile_bits=tb,
                       out=torch.empty_like(t), **swaps)
    assert_close(got.numpy(), np.asarray(ref))


def test_kraus_op_f32_matches_reference():
    n = 12
    _, ops, swaps = _kraus_cases()[5]
    state = np.random.default_rng(3).normal(size=(2, 1 << n)).astype(np.float32)
    ref = PG.fused_local_run(jnp.asarray(state), n=n, ops=ops, sublanes=4,
                             interpret=True, **swaps)
    t = torch.as_tensor(state)
    got = FG.fused_run(t, n=n, ops=ops_from_reference(ops), tile_bits=9,
                       out=torch.empty_like(t), **swaps)
    assert got.dtype == torch.float32
    assert_close(got.numpy(), np.asarray(ref), 2e-4)


def _kernel_emulation(x, rec, cf, n):
    """The CUDA kernel's kraus arithmetic in numpy, reading the encoded
    table as the kernel does: S^T indexed by deposits into the qubit mask."""
    t, mask, off = int(rec[1]), int(rec[5]), int(rec[6])
    G = 1 << (2 * t)
    st = cf[off:off + G * G].reshape(G, G) + 1j * cf[off + G * G:off + 2 * G * G].reshape(G, G)
    bits = [q for q in range(n) if (mask >> q) & 1]
    dep = np.array([sum(((v >> i) & 1) << q for i, q in enumerate(bits)) for v in range(G)])
    psi = x[0] + 1j * x[1]
    out = psi.copy()
    for g in (g for g in range(1 << n) if g & mask == 0):
        out[g + dep] = st.T @ psi[g + dep]
    return np.stack([out.real, out.imag])


@pytest.mark.parametrize("case", [0, 2, 4, 5])
def test_kernel_superop_table_applies_the_channel(case):
    """The superoperator block the kernel reads, applied as the kernel
    applies it, gives the JAX kernel's result (no swaps: one tile)."""
    n = 9
    name, ops, _ = _kraus_cases()[case]
    state = np.random.default_rng(case).normal(size=(2, 1 << n))
    ref = PG.fused_local_run(jnp.asarray(state), n=n, ops=ops, sublanes=4,
                             interpret=True)
    table, cf = FG.encode_ops(ops_from_reference(ops))
    assert_close(_kernel_emulation(state, table[0], cf, n), np.asarray(ref))


def test_kraus_ops_never_fold_and_refuse_wide_channels():
    ops = ops_from_reference(_kraus_cases()[0][1]) + (
        ("matrix", 1, (), (), FG.HashableMatrix(np.array([[1, 1], [1, -1]]) / np.sqrt(2))),) * 30
    kinds = [o[0] for o in FG._fold_zone_ops(ops, 9)]
    assert kinds[0] == "kraus1" and "lane_u" in kinds
    with pytest.raises(ValueError, match="1 to 3 row qubits"):
        FG.encode_ops((("krausn", (0, 1, 2, 3), (4, 5, 6, 7), ((1.0, np.eye(16)),)),))
    with pytest.raises(ValueError, match="other column qubits"):
        FG.encode_ops((("kraus2", 0, 1, 1, 2, ((1.0, np.eye(4)),)),))


# ---------------------------------------------------------------------------
# apply_channel's routes
# ---------------------------------------------------------------------------

def test_channel_routes_agree_and_refuse_as_the_reference():
    """The superoperator, the per-term engine and the kraus1 kernel pass
    (column in-tile and relocated by the folded 1-bit swap) agree, signed
    terms included; the kernel route refuses a state below two lane rows,
    as the JAX one does."""
    rng = np.random.RandomState(12)
    n = 6
    x = rng.randn(2, 1 << (2 * n))
    amps = torch.as_tensor(x)
    X = np.array([[0, 1], [1, 0]], dtype=complex)
    non_cp = (DN.kraus_superoperator([np.sqrt(0.8) * np.eye(2)])
              - 0.3 * DN.kraus_superoperator([X]))
    for sup in (DN.kraus_superoperator(DN.depolarising_kraus(0.3)), non_cp):
        terms = DN.choi_kraus(sup)
        for t, lq in [(1, None), (3, 9), (0, 8)]:
            superop = DN.apply_channel(amps, sup, n=n, targets=(t,))
            engine = DN._apply_kraus_sum(amps, terms, nsv=2 * n, rows=(t,), cols=(t + n,))
            kernel = DN._kraus_sum_kernel(amps, terms, n, t, lq=lq)
            ref = JDN._kraus_sum_pallas(jnp.asarray(x), JDN.choi_kraus(sup), n, t, lq=lq)
            for got in (engine, kernel):
                assert_close(got.numpy(), superop.numpy())
            assert_close(kernel.numpy(), np.asarray(ref))
        # refusal: a state below two rows
        assert DN._kraus_sum_kernel(amps[:, :128], terms, 3, 0) is None
    np.testing.assert_array_equal(amps.numpy(), x)  # inputs untouched


@pytest.mark.parametrize("t,lq", [(7, 8), (8, 8), (8, 9), (7, 9)],
                         ids=["row_top_slot", "row_above", "row_top_slot_lq8",
                              "row_below_top"])
def test_kernel_route_relocates_a_row_qubit_at_or_above_the_top_slot(t, lq):
    """A row qubit in the top in-tile slot or above the tile (where the JAX
    route, at its larger tile, never meets one on a single card) is still
    ONE kraus1 pass: the pair swap brings it, or the column qubit, to slot
    lq-2. The result equals quest_tpu's channel, signed terms included."""
    rng = np.random.RandomState(t + 10 * lq)
    n = 9
    x = rng.randn(2, 1 << (2 * n))
    X = np.array([[0, 1], [1, 0]], dtype=complex)
    non_cp = (DN.kraus_superoperator([np.sqrt(0.8) * np.eye(2)])
              - 0.3 * DN.kraus_superoperator([X]))
    for sup in (DN.kraus_superoperator(DN.depolarising_kraus(0.3)), non_cp):
        telemetry.reset()
        got = DN._kraus_sum_kernel(torch.as_tensor(x), DN.choi_kraus(sup), n, t, lq=lq)
        assert telemetry.counter_value("pallas_pass_total", kind="fused_run") == 1
        ref = JDN.apply_channel(jnp.asarray(x), sup, n=n, targets=(t,))
        assert_close(got.numpy(), np.asarray(ref))


def test_pair_swap_is_checked():
    """The pair swap exchanges an in-tile bit with one above the tile, apart
    from the bit-block swaps, and runs out of place."""
    x = torch.zeros(2, 1 << 12, dtype=torch.float64)
    ops = (("matrix", 0, (), (), FG.HashableMatrix(np.eye(2))),)
    for kw in (dict(pair_swap=(9, 10)), dict(pair_swap=(8, 8)),
               dict(pair_swap=(7, 10), load_swap_k=1, load_swap_hi=10),
               dict(pair_swap=(8, 11), store_swap_k=1, store_swap_hi=10)):
        with pytest.raises(ValueError, match="pair swap"):
            FG.fused_run(x, n=12, ops=ops, tile_bits=9, out=torch.empty_like(x), **kw)
    with pytest.raises(ValueError, match="out of place"):
        FG.fused_run(x, n=12, ops=ops, tile_bits=9, pair_swap=(7, 10))


def test_large_register_channel_takes_the_kernel_route(monkeypatch):
    """Above _SUPEROP_MAX_QUBITS a 1-target channel is one kraus1 pass,
    a 2-target one the per-term engine; the routes are counted."""
    monkeypatch.setattr(DN, "_SUPEROP_MAX_QUBITS", 0)
    env = tq.createQuESTEnv(device="cpu")
    n = 5
    q, r = tq.createDensityQureg(n, env, 2), jq.createDensityQureg(n, jq.createQuESTEnv())
    for m in (tq, jq):
        m.initPlusState(q if m is tq else r)
    telemetry.reset()
    passes = telemetry.counter_value("pallas_pass_total", kind="fused_run")
    for m, reg in ((tq, q), (jq, r)):
        m.hadamard(reg, 3)
        m.mixDamping(reg, 3, 0.3)
        m.mixTwoQubitDepolarising(reg, 0, 4, 0.2)
    assert telemetry.counter_value("channel_route_total", route="kernel") == 1
    assert telemetry.counter_value("channel_route_total", route="engine") == 1
    assert telemetry.counter_value("pallas_pass_total", kind="fused_run") == passes + 1
    assert_close(state_to_numpy(q), np.asarray(r.amps))


# ---------------------------------------------------------------------------
# the mix* API against quest_tpu and the oracle
# ---------------------------------------------------------------------------

N = 4
_RNG = np.random.RandomState(55)
_K1 = oracle.random_kraus(1, 3, _RNG)
_K2 = oracle.random_kraus(2, 3, _RNG)
_K3 = oracle.random_kraus(3, 2, _RNG)
_NTP = [0.6 * (_RNG.randn(4, 4) + 1j * _RNG.randn(4, 4))]
_I2, _X, _Y, _Z = (oracle.pauli_matrix(c) for c in range(4))

MIXES = [
    ("mixDephasing", (2, 0.21), (2,), JCH.dephasing_kraus(0.21)),
    ("mixTwoQubitDephasing", (3, 1, 0.3), (3, 1), JCH.two_qubit_dephasing_kraus(0.3)),
    ("mixDepolarising", (0, 0.4), (0,), JCH.depolarising_kraus(0.4)),
    ("mixDamping", (3, 0.35), (3,), JCH.damping_kraus(0.35)),
    ("mixTwoQubitDepolarising", (0, 2, 0.5), (0, 2), JCH.two_qubit_depolarising_kraus(0.5)),
    ("mixPauli", (1, 0.1, 0.15, 0.2), (1,), JCH.pauli_kraus(0.1, 0.15, 0.2)),
    ("mixKrausMap", (1, _K1), (1,), _K1),
    ("mixTwoQubitKrausMap", (3, 0, _K2), (3, 0), _K2),
    ("mixMultiQubitKrausMap", ([2, 0, 3], _K3), (2, 0, 3), _K3),
    ("mixNonTPKrausMap", (1, [np.array([[0.5, 0.2], [0.0, 0.3j]])]), (1,),
     [np.array([[0.5, 0.2], [0.0, 0.3j]])]),
    ("mixNonTPTwoQubitKrausMap", (2, 1, _NTP), (2, 1), _NTP),
    ("mixNonTPMultiQubitKrausMap", ([0, 3, 1], [0.5 * _K3[0]]), (0, 3, 1), [0.5 * _K3[0]]),
]


@pytest.fixture
def density_pair():
    rho = oracle.random_density(N, np.random.RandomState(7))
    j = jq.createDensityQureg(N, jq.createQuESTEnv())
    j.put(jnp.asarray(_flat(rho)))
    t = tq.createDensityQureg(N, tq.createQuESTEnv(device="cpu"), 2)
    t.put(state_from_numpy(_flat(rho), "cpu"))
    return rho, j, t


@pytest.mark.parametrize("name,args,targets,kraus", MIXES, ids=[m[0] for m in MIXES])
def test_mix_matches_reference_and_oracle(density_pair, name, args, targets, kraus):
    rho, j, t = density_pair
    getattr(jq, name)(j, *args)
    getattr(tq, name)(t, *args)
    assert_close(state_to_numpy(t), np.asarray(j.amps))
    ref = oracle.apply_kraus_to_density(rho, N, targets, kraus)
    assert_close(_matrix(state_to_numpy(t), N), ref)


@pytest.mark.parametrize("call,match", [
    (lambda m, q: m.mixDephasing(q, 0, 0.6), "cannot exceed 1/2"),
    (lambda m, q: m.mixTwoQubitDephasing(q, 0, 1, 0.8), "cannot exceed 3/4"),
    (lambda m, q: m.mixDepolarising(q, 0, 0.8), "cannot exceed 3/4"),
    (lambda m, q: m.mixTwoQubitDepolarising(q, 0, 1, 0.95), "cannot exceed 15/16"),
    (lambda m, q: m.mixDamping(q, 0, 1.2), "cannot exceed 1\\."),
    (lambda m, q: m.mixPauli(q, 0, -0.1, 0.3, 0.3), "Probabilities must be in"),
    (lambda m, q: m.mixPauli(q, 0, 0.6, 0.3, 0.3), "cannot exceed the probability of no error"),
    (lambda m, q: m.mixKrausMap(q, 0, [np.eye(2) * 0.5]), "CPTP"),
    (lambda m, q: m.mixKrausMap(q, 0, []), "Invalid number of operators."),
    (lambda m, q: m.mixKrausMap(q, 0, [np.eye(2)] * 5), "Must be >0 and <= 4\\^numTargets"),
    (lambda m, q: m.mixTwoQubitKrausMap(q, 0, 1, [np.eye(2)]), "Matrix size does not match"),
    (lambda m, q: m.mixMultiQubitKrausMap(q, [0, 0], [np.eye(4)]), "target qubits must be unique"),
    (lambda m, q: m.mixTwoQubitDephasing(q, 1, 1, 0.1), "Qubits must be unique"),
    (lambda m, q: m.mixDamping(q, N, 0.1), "Invalid target qubit"),
    (lambda m, q: m.calcPurity(m.createQureg(N, q.env)), "valid only for density matrices"),
    (lambda m, q: m.mixDephasing(m.createQureg(N, q.env), 0, 0.1), "valid only for density"),
    (lambda m, q: m.getDensityAmp(q, 1 << N, 0), "Invalid amplitude index"),
    (lambda m, q: m.initPureState(q, q), "Second argument must be a state-vector"),
    (lambda m, q: m.initPureState(q, m.createQureg(N + 1, q.env)), "Dimensions of the qubit"),
])
def test_density_validation_messages_match_reference(density_pair, call, match):
    _, j, t = density_pair
    before = state_to_numpy(t).copy()
    with pytest.raises(jq.QuESTError, match=match):
        call(jq, j)
    with pytest.raises(tq.QuESTError, match=match):
        call(tq, t)
    np.testing.assert_array_equal(state_to_numpy(t), before)  # state unchanged


def test_readouts_match_reference(density_pair):
    rho, j, t = density_pair
    for m, q in ((jq, j), (tq, t)):
        m.mixDamping(q, 1, 0.3)
        m.hadamard(q, 2)
    assert abs(tq.calcTotalProb(t) - jq.calcTotalProb(j)) < TOL
    assert abs(tq.calcPurity(t) - jq.calcPurity(j)) < TOL
    for target in range(N):
        for outcome in (0, 1):
            assert abs(tq.calcProbOfOutcome(t, target, outcome)
                       - jq.calcProbOfOutcome(j, target, outcome)) < TOL
    for row, col in ((0, 0), (3, 5), (15, 2), (7, 7)):
        assert abs(tq.getDensityAmp(t, row, col) - jq.getDensityAmp(j, row, col)) < TOL
    assert abs(tq.calcPurity(t) - np.trace(_matrix(state_to_numpy(t), N) @
                                          _matrix(state_to_numpy(t), N)).real) < TOL


# ---------------------------------------------------------------------------
# density tapes through Circuit.fused(pallas=True).run
# ---------------------------------------------------------------------------

def _oracle_run(entries, n, rho):
    """Replay a recorded tape on a dense density matrix, gate by gate and
    channel by channel, with the oracle's Kraus sums."""
    H = np.array([[1, 1], [1, -1]]) / np.sqrt(2)
    for fn, args, _ in entries:
        name = fn.__name__
        if name == "hadamard":
            rho = oracle.apply_to_density(rho, n, args, H)
        elif name == "controlledNot":
            rho = oracle.apply_to_density(rho, n, (args[1],), _X, (args[0],))
        elif name == "controlledPhaseFlip":
            rho = oracle.apply_to_density(rho, n, (args[1],), _Z, (args[0],))
        elif name == "tGate":
            rho = oracle.apply_to_density(rho, n, args, np.diag([1, np.exp(0.25j * np.pi)]))
        elif name == "rotateZ":
            a = args[1]
            rho = oracle.apply_to_density(rho, n, args[:1],
                                          np.diag([np.exp(-0.5j * a), np.exp(0.5j * a)]))
        elif name == "rotateX":
            a = args[1]
            rx = np.array([[np.cos(a / 2), -1j * np.sin(a / 2)],
                           [-1j * np.sin(a / 2), np.cos(a / 2)]])
            rho = oracle.apply_to_density(rho, n, args[:1], rx)
        else:
            spec = {m[0]: m for m in MIXES}[name]
            probs = args[len(spec[2]):]
            kraus = (JCH.kraus_ops(JCH.MIX_CHANNELS[name], *probs)
                     if name in JCH.MIX_CHANNELS else args[-1])
            targets = tuple(args[0]) if isinstance(args[0], list) else args[:len(spec[2])]
            rho = oracle.apply_kraus_to_density(rho, n, targets, kraus)
    return rho


def _channel_tape(kind, n):
    """Mirrors of tests/test_pallas.py's density tapes (:115, :142, :181,
    :219, :285) and the bench circuits."""
    c = JCircuit(n, is_density_matrix=True)
    if kind == "shadow_ops":
        c.hadamard(0)
        c.controlledNot(0, 1)
        c.rotateZ(2, 0.4)
        c.tGate(n - 1)
    elif kind == "channels":
        for q in range(3):
            c.hadamard(q)
        c.controlledNot(0, 1)
        c.mixDepolarising(0, 0.05)
        c.mixDamping(2, 0.1)
        k = 1 / np.sqrt(2)
        c.mixKrausMap(1, [np.array([[k, 0], [0, k]]), np.array([[0, k], [k, 0]])])
        c.mixDephasing(3, 0.2)
        c.mixTwoQubitDephasing(0, 1, 0.1)
        c.mixTwoQubitDepolarising(0, 1, 0.1)
    elif kind == "krausn":
        rng = np.random.RandomState(7)
        u8 = np.linalg.qr(rng.randn(8, 8) + 1j * rng.randn(8, 8))[0]
        c.hadamard(0)
        c.hadamard(3)
        c.controlledNot(0, 1)
        c.mixMultiQubitKrausMap([0, 1, 2], [0.8 * u8, 0.6j * np.eye(8)])
        c.tGate(2)
    elif kind == "krausn_non_tp":
        rng = np.random.RandomState(3)
        c.hadamard(0)
        c.controlledNot(0, 2)
        c.mixNonTPMultiQubitKrausMap([0, 2, 4], [0.5 * (rng.randn(8, 8) + 1j * rng.randn(8, 8))])
    elif kind == "frames":
        _random_layers(c, n, depth=2, seed=7)
        c.mixDepolarising(n - 1, 0.1)
        c.mixKrausMap(n - 2, [np.sqrt(0.7) * np.eye(2), np.sqrt(0.3) * _X])
    return c


TAPES = [("shadow_ops", 5), ("channels", 5), ("krausn", 5), ("krausn_non_tp", 5),
         ("frames", 6)]


@pytest.mark.parametrize("tile", ["jax", "hopper"])
@pytest.mark.parametrize("kind,n", TAPES, ids=[t[0] for t in TAPES])
def test_density_tape_fused_matches_reference_and_oracle(kind, n, tile):
    jc = _channel_tape(kind, n)
    tc = circuit_from_tape(jc._tape, n, True)
    tb = PG.local_qubits(2 * n, sublanes=4) if tile == "jax" else None
    tfz = tc.fused(max_qubits=4, pallas=True, tile_bits=tb, dtype=torch.float64)
    runs = [a[0] for f, a, _ in tfz._tape if f is F._apply_pallas_run]
    kinds = [op[0] for r in runs for op in r.ops]
    assert runs
    if kind == "shadow_ops":
        assert any(op[1] >= n for r in runs for op in r.ops if op[0] == "matrix")
    if kind == "channels":  # as tests/test_pallas.py:142 asserts them
        assert (kinds.count("kraus1"), kinds.count("kraus2"), kinds.count("diagw")) == (3, 1, 2)
        assert all(f is F._apply_pallas_run for f, _, _ in tfz._tape)
    if kind.startswith("krausn"):
        assert kinds.count("krausn") == 1
    if kind == "frames" and tile == "jax":
        assert any(r.load_swap_k or r.store_swap_k for r in runs)

    rho0 = oracle.random_density(n, np.random.RandomState(n))
    j = jq.createDensityQureg(n, jq.createQuESTEnv())
    j.put(jnp.asarray(_flat(rho0)))
    jc.run(j)
    t = tq.createDensityQureg(n, tq.createQuESTEnv(device="cpu"), 2)
    t.put(state_from_numpy(_flat(rho0), "cpu"))
    telemetry.reset()
    tfz.run(t)
    assert telemetry.counter_value("pallas_pass_total", kind="fused_run") == len(runs)
    assert telemetry.counter_total("engine_fallback_total") == 0
    assert_close(state_to_numpy(t), np.asarray(j.amps))
    assert_close(_matrix(state_to_numpy(t), n), _oracle_run(jc._tape, n, rho0))


def test_density_run_replays_through_the_engine():
    """The fused plan's runs replayed op by op through the per-gate engine
    (kraus ops as per-term engine sums) reach the fused state."""
    n = 6
    jc = _channel_tape("frames", n)
    tc = circuit_from_tape(jc._tape, n, True)
    p = F.plan(tuple(tc._tape), n, torch.float64, max_qubits=4,
               pallas_tile_bits=PG.local_qubits(2 * n, sublanes=4), is_density=True)
    env = tq.createQuESTEnv(device="cpu")
    q_kernel, q_engine = tq.createDensityQureg(n, env, 2), tq.createDensityQureg(n, env, 2)
    for q in (q_kernel, q_engine):
        tq.initPlusState(q)
    for f, a, kw in F.as_tape(p):
        f(q_kernel, *a, **kw)
    nsv = 2 * n

    def swap(k, hi, tb):
        if k:
            q_engine.put(FG.swap_bit_blocks(q_engine.amps, n=nsv, lo1=tb - k,
                                            lo2=tb if hi is None else hi, k=k))

    for item in p.items:
        assert isinstance(item, F.PallasRun)
        swap(item.load_swap_k, item.load_swap_hi, item.tile_bits)
        F._apply_ops_via_engine(q_engine, item.ops)
        swap(item.store_swap_k, item.store_swap_hi, item.tile_bits)
    assert any(op[0].startswith("kraus") for r in p.items for op in r.ops)
    assert_close(q_engine.amps.numpy(), q_kernel.amps.numpy())


@pytest.mark.parametrize("precision,tol", [(2, TOL), (1, 2e-4)])
@pytest.mark.parametrize("with_krausn", [False, True], ids=["r3", "r4"])
def test_bench_channel_circuits_end_to_end(with_krausn, precision, tol):
    """The bench's r3/r4 channel circuits at n = 6 (12 flattened qubits),
    from initPlusState, at the Hopper tile, against quest_tpu in f64 (the
    port in f32 and f64): one pass per run, no fallback."""
    n = 6
    jc = _density_circuit(n, with_krausn)
    tc = tq.density_circuit(n, with_krausn)
    assert [f.__name__ for f, _, _ in tc._tape] == [f.__name__ for f, _, _ in jc._tape]
    dt = torch.float32 if precision == 1 else torch.float64
    tfz = tc.fused(max_qubits=4, pallas=True, dtype=dt)
    runs = [a[0] for f, a, _ in tfz._tape if f is F._apply_pallas_run]
    assert runs and all(r.tile_bits == 12 for r in runs)
    j = jq.createDensityQureg(n, jq.createQuESTEnv())
    jq.initPlusState(j)
    jc.run(j)
    t = tq.createDensityQureg(n, tq.createQuESTEnv(device="cpu"), precision)
    tq.initPlusState(t)
    telemetry.reset()
    launches = FG.fused_run.launches
    tfz.run(t)
    assert telemetry.counter_value("pallas_pass_total", kind="fused_run") == len(runs)
    assert telemetry.counter_total("engine_fallback_total") == 0
    assert FG.fused_run.launches == launches  # CPU tensors never launch
    assert_close(state_to_numpy(t), np.asarray(j.amps), tol)
    assert abs(tq.calcTotalProb(t) - 1) < tol
    assert abs(tq.calcPurity(t) - jq.calcPurity(j)) < tol


@pytest.mark.cuda
def test_kraus_kernel_matches_plain_on_card():
    """The CUDA kernel's kraus ops against its plain version on the card,
    every kind with and without folded swaps, f32 and f64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = 14
    for dt, tb, tol in ((torch.float32, 9, 1e-5), (torch.float64, 9, 1e-12)):
        x = torch.as_tensor(np.random.default_rng(5).normal(size=(2, 1 << n)),
                            dtype=dt, device="cuda")
        x /= x.norm()
        for _, ops, swaps in _kraus_cases():
            swaps = {k: (n - 2 if k.endswith("hi") else v) for k, v in swaps.items()}
            pops = ops_from_reference(ops)
            prep = FG.PreparedRun(pops, tb)
            ref = FG.fused_run_plain(x, prep, n=n, tile_bits=tb, **swaps)
            before = FG.fused_run.launches
            got = FG.fused_run(x, n=n, ops=pops, tile_bits=tb, out=torch.empty_like(x),
                               prepared=prep, **swaps)
            torch.cuda.synchronize()
            assert FG.fused_run.launches == before + 1
            assert (got - ref).abs().max().item() <= tol
        # the row qubit above the tile, relocated by the pair swap
        terms = tuple((1.0, FG.HashableMatrix(k)) for k in DN.depolarising_kraus(0.2))
        prep = FG.PreparedRun((("kraus1", tb - 2, tb - 1, terms),), tb)
        swaps = dict(load_swap_k=1, load_swap_hi=n - 1, store_swap_k=1,
                     store_swap_hi=n - 1, pair_swap=(tb - 2, n - 2))
        ref = FG.fused_run_plain(x, prep, n=n, tile_bits=tb, **swaps)
        got = FG.fused_run(x, n=n, ops=prep.ops, tile_bits=tb, out=torch.empty_like(x),
                           prepared=prep, **swaps)
        torch.cuda.synchronize()
        assert (got - ref).abs().max().item() <= tol
