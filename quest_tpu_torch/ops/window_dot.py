"""A dense unitary on a contiguous qubit window, on the card through the
CUDA kernel ``csrc/window_dot.cu``.

The counterpart of ``quest_tpu/ops/pallas_gates.py::window_dot``: view the
planar (2, 2^n) state as (2, A, D, B) with D = 2^span the window's
dimension and B = 2^lo >= 128 the contiguous run of amplitudes below it,
and replace every (D, b) column by U @ column, where U is the planar
(2, D, D) matrix whose index bit j is qubit lo + j (``targets[0]`` the
least-significant bit, as ``ops.apply.apply_matrix``). ``conj=True``
applies conj(U), the density shadow. The accepted windows are the JAX
package's: lo >= 7 and span <= 6.

No route of the planner calls it (the JAX package keeps the per-gate
engine for windows at lo >= 7, by measurement); this is its entry point.
``window_dot`` launches the kernel for a CUDA tensor (or raises) and takes
the plain version, ``window_dot_plain`` = ``ops.apply.apply_matrix`` on
targets (lo..hi), only for a CPU tensor.
"""

from __future__ import annotations

import torch

from .. import telemetry
from .apply import apply_matrix
from .fused_gates import LANE_BITS

#: largest window span the kernel takes (the JAX package's limit): D = 64
MAX_SPAN = 6


def window_dot_supported(n: int, lo: int, hi: int) -> bool:
    """True if the window [lo, hi] is one ``window_dot`` takes: the bits
    below it fill at least one 128-amplitude lane row, and its span is at
    most 6 (pallas_gates.window_dot_supported)."""
    return lo >= LANE_BITS and (hi - lo) < MAX_SPAN


def window_dot_plain(amps: torch.Tensor, matrix: torch.Tensor, *, n: int,
                     lo: int, hi: int, conj: bool = False) -> torch.Tensor:
    """The plain PyTorch version: the per-gate engine on targets
    (lo, ..., hi). Returns a new tensor."""
    return apply_matrix(amps, matrix.to(amps.dtype), n=n,
                        targets=tuple(range(lo, hi + 1)), conj=conj)


def _check(amps: torch.Tensor, matrix: torch.Tensor, n: int, lo: int, hi: int) -> None:
    if amps.dim() != 2 or amps.shape[0] != 2 or amps.shape[1] != 1 << n:
        raise ValueError(f"state must be planar (2, 2^{n}), got {tuple(amps.shape)}")
    if amps.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"state must be float32 or float64, got {amps.dtype}")
    if not (window_dot_supported(n, lo, hi) and lo <= hi < n):
        raise ValueError(f"window [{lo}, {hi}] of an {n}-qubit state is not one "
                         f"window_dot takes (lo >= {LANE_BITS}, span <= {MAX_SPAN}, "
                         f"hi < n)")
    d = 1 << (hi - lo + 1)
    if tuple(matrix.shape) != (2, d, d):
        raise ValueError(f"matrix must be planar (2, {d}, {d}), got {tuple(matrix.shape)}")
    if matrix.device != amps.device:
        raise ValueError("matrix and state must be on the same device")


def window_dot(amps: torch.Tensor, matrix: torch.Tensor, *, n: int, lo: int,
               hi: int, conj: bool = False) -> torch.Tensor:
    """Apply the dense planar (2, D, D) ``matrix`` (``conj``: its
    conjugate) to the window [lo, hi] of the planar (2, 2^n) state, in
    place; returns ``amps``. Counted in ``pallas_pass_total{window_dot}``."""
    _check(amps, matrix, n, lo, hi)
    telemetry.inc("pallas_pass_total", kind="window_dot")
    if amps.device.type == "cpu":
        amps.copy_(window_dot_plain(amps, matrix, n=n, lo=lo, hi=hi, conj=conj))
        return amps
    if amps.device.type != "cuda":
        raise ValueError(f"no window_dot route for device {amps.device}")
    _launch(amps, matrix, n, lo, hi, conj)
    return amps


#: kernel launches (incremented only where the CUDA kernel is launched)
window_dot.launches = 0


def _launch(amps, matrix, n, lo, hi, conj) -> None:
    from .. import _build

    if not amps.is_contiguous():
        raise ValueError("the window_dot kernel takes a contiguous state")
    lib = _build.library("window_dot")
    fn = (lib.quest_window_dot_f32 if amps.dtype == torch.float32
          else lib.quest_window_dot_f64)
    m = matrix.to(amps.dtype).contiguous()
    with torch.cuda.device(amps.device):
        stream = torch.cuda.current_stream(amps.device).cuda_stream
        err = fn(amps.data_ptr(), m.data_ptr(), n, lo, hi - lo + 1, int(conj), stream)
    if err != 0:
        msg = lib.quest_cuda_error_string(err).decode()
        raise RuntimeError(f"window_dot kernel launch failed: {msg} ({err})")
    window_dot.launches += 1
