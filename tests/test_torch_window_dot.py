"""The port's window_dot (quest_tpu_torch/ops/window_dot.py) against the JAX
package's (quest_tpu/ops/pallas_gates.window_dot, run in interpret mode as
tests/test_pallas.py runs it): the plain version on the CPU at f64 1e-10
and f32 2e-4, the accepted windows, the wrapper's refusals, and on the card
the CUDA kernel against the plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quest_tpu.ops import cplx as jcplx
from quest_tpu.ops import pallas_gates as PG
from quest_tpu_torch import telemetry
from quest_tpu_torch.ops import window_dot as WD

from . import oracle

N = 13
WINDOWS = [(lo, span) for lo in (7, 8, 9) for span in (3, 6) if lo + span <= N]
DTYPES = [(np.float64, torch.float64, 1e-10), (np.float32, torch.float32, 2e-4)]


def _inputs(n, span, seed):
    rng = np.random.RandomState(seed)
    amps = rng.randn(2, 1 << n)
    amps /= np.linalg.norm(amps)
    u = oracle.random_unitary(span, rng)
    return amps, u


@pytest.mark.parametrize("conj", [False, True], ids=["plain", "conj"])
@pytest.mark.parametrize("lo,span", WINDOWS, ids=[f"lo{lo}-span{s}" for lo, s in WINDOWS])
@pytest.mark.parametrize("npdt,dt,tol", DTYPES, ids=["f64", "f32"])
def test_plain_matches_reference_window_dot(lo, span, conj, npdt, dt, tol):
    amps, u = _inputs(N, span, 10 * lo + span)
    hi = lo + span - 1
    ref = PG.window_dot(jnp.asarray(amps, dtype=npdt), jcplx.from_complex(u, npdt),
                        n=N, lo=lo, hi=hi, conj=conj, interpret=True)
    m = torch.as_tensor(np.stack([u.real, u.imag]), dtype=dt)
    x = torch.as_tensor(amps, dtype=dt)
    got = WD.window_dot_plain(x, m, n=N, lo=lo, hi=hi, conj=conj)
    assert torch.equal(x, torch.as_tensor(amps, dtype=dt))  # input left as it was
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol * np.abs(ref).max())
    # the wrapper takes the plain version for a CPU tensor, in place
    before = (WD.window_dot.launches,
              telemetry.counter_value("pallas_pass_total", kind="window_dot"))
    assert WD.window_dot(x, m, n=N, lo=lo, hi=hi, conj=conj) is x
    assert torch.equal(x, got)
    assert (WD.window_dot.launches,
            telemetry.counter_value("pallas_pass_total", kind="window_dot")) == (
                before[0], before[1] + 1)


def test_supported_windows_match_reference():
    grid = [(n, lo, hi) for n in range(6, 16) for lo in range(0, n)
            for hi in range(lo, n + 2)]
    assert [WD.window_dot_supported(*g) for g in grid] == \
           [PG.window_dot_supported(*g) for g in grid]
    assert WD.MAX_SPAN == PG._WINDOW_DOT_MAX_SPAN


def test_wrapper_refuses_what_the_contract_refuses():
    x = torch.zeros(2, 1 << N, dtype=torch.float64)
    m8 = torch.zeros(2, 8, 8, dtype=torch.float64)
    with pytest.raises(ValueError, match="not one window_dot takes"):
        WD.window_dot(x, torch.zeros(2, 2, 2, dtype=torch.float64), n=N, lo=6, hi=6)
    with pytest.raises(ValueError, match="not one window_dot takes"):
        WD.window_dot(x, torch.zeros(2, 128, 128, dtype=torch.float64), n=N, lo=7, hi=13)
    with pytest.raises(ValueError, match="not one window_dot takes"):
        WD.window_dot(x, m8, n=N, lo=11, hi=13)
    with pytest.raises(ValueError, match="not one window_dot takes"):
        WD.window_dot(x, m8, n=N, lo=9, hi=8)
    with pytest.raises(ValueError, match=r"planar \(2, 8, 8\)"):
        WD.window_dot(x, torch.zeros(2, 4, 4, dtype=torch.float64), n=N, lo=7, hi=9)
    with pytest.raises(ValueError, match="planar"):
        WD.window_dot(x[:, :100], m8, n=N, lo=7, hi=9)
    with pytest.raises(ValueError, match="float32 or float64"):
        WD.window_dot(x.to(torch.float16), m8, n=N, lo=7, hi=9)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against the plain version on the card, every span
    and the narrowest and widest lo, with and without conj, f32 and f64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = 16
    for dt, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        for span in range(1, WD.MAX_SPAN + 1):
            for lo in (7, n - span):
                amps, u = _inputs(n, span, span)
                x = torch.as_tensor(amps, dtype=dt, device="cuda")
                m = torch.as_tensor(np.stack([u.real, u.imag]), dtype=dt, device="cuda")
                for conj in (False, True):
                    ref = WD.window_dot_plain(x, m, n=n, lo=lo, hi=lo + span - 1, conj=conj)
                    got = x.clone()
                    before = WD.window_dot.launches
                    WD.window_dot(got, m, n=n, lo=lo, hi=lo + span - 1, conj=conj)
                    torch.cuda.synchronize()
                    assert WD.window_dot.launches == before + 1
                    err = (got - ref).abs().max().item() / ref.abs().max().item()
                    assert err <= tol, (dt, span, lo, conj, err)
