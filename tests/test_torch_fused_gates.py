"""The port's fused gate run (quest_tpu_torch/ops/fused_gates.py) against
the JAX package's Pallas kernel (quest_tpu/ops/pallas_gates.py).

On the CPU the port's wrapper takes the kernel's plain PyTorch version and
the JAX kernel runs in the Pallas interpreter, as the JAX package's own
tests run it. Inputs are made with numpy from a seed and fed to both.
Tolerances: 1e-10 in f64; 2e-4 in f32, where the JAX zone dots are bf16x3
(~5e-6 per dot) and the port's plain FP32. Errors are measured at the
state's scale (max |amplitude|, at least 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quest_tpu.ops import pallas_gates as PG
from quest_tpu_torch.interop import ops_from_reference, state_from_numpy
from quest_tpu_torch.ops import fused_gates as FG

H = np.array([[1, 1], [1, -1]]) / np.sqrt(2)
X = np.array([[0, 1], [1, 0]], dtype=complex)


def _rz(th):
    return np.diag([np.exp(-0.5j * th), np.exp(0.5j * th)])


def assert_close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * max(np.abs(ref).max(), 1.0))


def _state(n, seed, dtype=np.float64):
    return np.random.default_rng(seed).normal(size=(2, 1 << n)).astype(dtype)


def _port(state, n, ops, tile_bits, **kw):
    return FG.fused_run(state_from_numpy(state, "cpu"), n=n,
                        ops=ops_from_reference(ops), tile_bits=tile_bits,
                        **kw).numpy()


def test_plain_kernel_matches_reference_all_bit_classes():
    """Targets on lane and sublane bits; controls (with states) and parity
    members on lane, sublane and grid bits; a controlled swap and a wide
    diagonal with a grid-bit target."""
    n = 10
    ops = (
        ("matrix", 0, (), (), PG.HashableMatrix(H)),
        ("matrix", 3, (), (), PG.HashableMatrix(_rz(0.7))),
        ("matrix", 1, (9,), (1,), PG.HashableMatrix(X)),   # grid-bit control
        ("matrix", 8, (2,), (1,), PG.HashableMatrix(X)),   # sublane target
        ("matrix", 5, (7,), (0,), PG.HashableMatrix(H)),   # control-on-zero
        ("parity", (0, 9), (), 0.77),                      # grid-bit parity
        ("matrix", 7, (), (), PG.HashableMatrix(H)),
        ("matrix", 9, (4,), (1,), PG.HashableMatrix(_rz(1.1))),  # grid diag
        ("swap", 2, 6, (8,), (0,)),
        ("diagw", (1, 9, 4), (3,), PG.HashableMatrix(np.exp(1j * np.arange(8)))),
    )
    state = _state(n, 1)
    ref = PG.fused_local_run(jnp.asarray(state), n=n, ops=ops, sublanes=4)
    got = _port(state, n, ops, PG.local_qubits(n, sublanes=4))
    assert_close(got, np.asarray(ref), 1e-10)


def _random_1q_ops(n_qubits, layers, seed):
    rng = np.random.RandomState(seed)
    ops = []
    for _ in range(layers):
        for q in range(n_qubits):
            u, _ = np.linalg.qr(rng.randn(2, 2) + 1j * rng.randn(2, 2))
            ops.append(("matrix", q, (), (), PG.HashableMatrix(u)))
    return tuple(ops)


def test_fold_zone_ops_equal_reference():
    """The port folds the same gates into the same lane_u/window ops at the
    same positions, with matrices that agree."""
    ops = _random_1q_ops(12, 7, 0) + (("parity", (0, 8), (), 0.3),) \
        + _random_1q_ops(12, 2, 1)
    for tile_bits in (12, 13):
        ref = PG._fold_zone_ops(ops, tile_bits)
        got = FG._fold_zone_ops(ops_from_reference(ops), tile_bits)
        assert [o[0] for o in got] == [o[0] for o in ref]
        assert {"lane_u", "window"} <= {o[0] for o in got}
        for a, b in zip(got, ref):
            for x, y in zip(a[1:], b[1:]):
                if hasattr(y, "arr"):
                    np.testing.assert_allclose(x.arr, y.arr, rtol=0, atol=1e-12)
                else:
                    assert x == y


def test_zone_folds_f32_numerics():
    """f32 zone folds (lane_u and window) at 13 qubits, one tile: the
    port's FP32 products against the JAX kernel's bf16x3 dots and against
    an exact gate-by-gate complex128 reference."""
    n = 13
    ops = _random_1q_ops(12, 7, 0)
    rng = np.random.RandomState(0)
    state = rng.randn(2, 1 << n).astype(np.float32)
    state /= np.linalg.norm(state)
    ref = np.asarray(PG.fused_local_run(jnp.asarray(state), n=n, ops=ops,
                                        interpret=True))
    got = _port(state, n, ops, 13)
    assert got.dtype == np.float32
    assert_close(got, ref, 2e-4)

    psi = state[0].astype(np.complex128) + 1j * state[1].astype(np.complex128)
    for _, q, _, _, M in ops:
        v = psi.reshape(1 << (n - q - 1), 2, 1 << q)
        psi = np.einsum("ab,ibj->iaj", np.asarray(M.arr), v).reshape(-1)
    exact = np.stack([psi.real, psi.imag])
    assert np.abs(got - exact).max() / np.abs(exact).max() < 2e-5


def test_lane_fold_matches_reference():
    """A folded lane run (25 Hadamards on lane qubits) in a one-tile call."""
    n = 10
    ops = tuple(("matrix", q % 7, (), (), PG.HashableMatrix(H)) for q in range(25))
    assert any(o[0] == "lane_u" for o in FG._fold_zone_ops(ops_from_reference(ops), 10))
    state = _state(n, 2)
    ref = PG.fused_local_run(jnp.asarray(state), n=n, ops=ops, sublanes=8)
    assert_close(_port(state, n, ops, 10), np.asarray(ref), 1e-10)


def test_grid_bit_target_rejected():
    state = _state(10, 3)
    ops = (("matrix", 9, (), (), PG.HashableMatrix(H)),)
    with pytest.raises(ValueError, match="local_qubits"):
        PG.fused_local_run(jnp.asarray(state), n=10, ops=ops, sublanes=4)
    with pytest.raises(ValueError, match="local_qubits"):
        _port(state, 10, ops, 9)


@pytest.mark.parametrize("load,store", [(2, 0), (0, 2), (2, 2)])
def test_folded_swaps_match_explicit_and_reference(load, store):
    """load/store_swap_k folding against explicit swap_bit_blocks passes,
    and against the JAX kernel's folded DMA."""
    n, tb = 12, 10
    ops = (("matrix", 0, (), (), PG.HashableMatrix(H)),
           ("matrix", 8, (n - 1,), (1,), PG.HashableMatrix(X)),
           ("parity", (3, n - 1), (), 0.31))
    state = _state(n, 5)
    t = torch.as_tensor(state)
    pops = ops_from_reference(ops)

    def sw(a):
        return FG.swap_bit_blocks(a, n=n, lo1=tb - 2, lo2=tb, k=2)

    x = sw(t) if load else t
    explicit = FG.fused_run(x.clone(), n=n, ops=pops, tile_bits=tb)
    if store:
        explicit = sw(explicit)
    got = FG.fused_run(t, n=n, ops=pops, tile_bits=tb, load_swap_k=load,
                       store_swap_k=store, out=torch.empty_like(t))
    assert_close(got.numpy(), explicit.numpy(), 1e-12)
    ref = PG.fused_local_run(jnp.asarray(state), n=n, ops=ops, sublanes=8,
                             interpret=True, load_swap_k=load, store_swap_k=store)
    assert_close(got.numpy(), np.asarray(ref), 1e-10)


def test_folded_swap_asymmetric_geometries():
    """Load and store swaps with different k and hi in one pass."""
    n, tb = 13, 10
    ops = (("matrix", 0, (), (), PG.HashableMatrix(H)),
           ("diagw", (2, 12), (), PG.HashableMatrix(np.exp(0.5j * np.arange(4)))))
    state = _state(n, 9)
    kw = dict(load_swap_k=1, load_swap_hi=12, store_swap_k=2)
    ref = PG.fused_local_run(jnp.asarray(state), n=n, ops=ops, sublanes=8,
                             interpret=True, **kw)
    t = torch.as_tensor(state)
    got = FG.fused_run(t, n=n, ops=ops_from_reference(ops), tile_bits=tb,
                       out=torch.empty_like(t), **kw)
    assert_close(got.numpy(), np.asarray(ref), 1e-10)
    explicit = FG.swap_bit_blocks(
        FG.fused_run(FG.swap_bit_blocks(t, n=n, lo1=tb - 1, lo2=12, k=1), n=n,
                     ops=ops_from_reference(ops), tile_bits=tb),
        n=n, lo1=tb - 2, lo2=tb, k=2)
    assert_close(got.numpy(), explicit.numpy(), 1e-12)


@pytest.mark.parametrize("lo1,lo2,k", [(8, 10, 2), (3, 9, 3), (0, 12, 1)])
def test_swap_bit_blocks_matches_reference(lo1, lo2, k):
    n = 13
    state = _state(n, lo1)
    ref = PG.swap_bit_blocks(jnp.asarray(state), n=n, lo1=lo1, lo2=lo2, k=k)
    got = FG.swap_bit_blocks(torch.as_tensor(state), n=n, lo1=lo1, lo2=lo2, k=k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    ops = (("matrix", 0, (), (), FG.HashableMatrix(H)),)
    x = torch.zeros(2, 1 << 10, dtype=torch.float64)
    with pytest.raises(ValueError, match="planar"):
        FG.fused_run(x[:, :100], n=10, ops=ops, tile_bits=9)
    with pytest.raises(ValueError, match="float32 or float64"):
        FG.fused_run(x.to(torch.float16), n=10, ops=ops, tile_bits=9)
    with pytest.raises(ValueError, match="tile_bits"):
        FG.fused_run(x, n=10, ops=ops, tile_bits=13)
    with pytest.raises(ValueError, match="out of place"):
        FG.fused_run(x, n=10, ops=ops, tile_bits=9, load_swap_k=1)
    with pytest.raises(ValueError, match="exceeds the call geometry"):
        FG.fused_run(x, n=10, ops=ops, tile_bits=9, store_swap_k=2,
                     out=torch.empty_like(x))
    with pytest.raises(ValueError, match="no op 'kraus3'"):
        FG.encode_ops((("kraus3", 0, 5, ()),))
    with pytest.raises(ValueError, match="at least one term"):
        FG.encode_ops((("kraus1", 0, 5, ()),))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version on the card (every op kind,
    a folded swap), f32 and f64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = 16
    ops = ops_from_reference(_random_1q_ops(12, 3, 4)) + (
        ("parity", (0, 13, 15), (2,), 0.4), ("swap", 1, 9, (14,), (0,)),
        ("diagw", (3, 15), (), FG.HashableMatrix(np.exp(1j * np.arange(4)))))
    for dt, tb, tol in ((torch.float32, 13, 1e-5), (torch.float64, 12, 1e-12)):
        x = torch.as_tensor(_state(n, 7), dtype=dt, device="cuda")
        x /= x.norm()
        prep = FG.PreparedRun(ops, tb)
        ref = FG.fused_run_plain(x, prep, n=n, tile_bits=tb, load_swap_k=2)
        before = FG.fused_run.launches
        got = FG.fused_run(x, n=n, ops=ops, tile_bits=tb, load_swap_k=2,
                           out=torch.empty_like(x), prepared=prep)
        torch.cuda.synchronize()
        assert FG.fused_run.launches == before + 1
        assert (got - ref).abs().max().item() <= tol
