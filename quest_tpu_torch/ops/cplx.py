"""Planar complex conversion.

The state is stored planar, one real tensor of shape (2, ...) holding
(real, imag): the same SoA layout as the reference's ComplexArray
(QuEST.h:94-98) and as ``quest_tpu``, so the two packages' states compare
plane for plane. Complex values cross only at the API boundary (gate
matrices in, amplitudes out).
"""

from __future__ import annotations

import numpy as np
import torch

from .._capture import to_device


def from_complex(arr, dtype: torch.dtype, device) -> torch.Tensor:
    """Complex array -> planar (2, *shape) tensor on ``device``. A host
    array is staged through ``_capture.to_device`` (inside a compiled
    replay the copy is made once and kept); a tensor is split into its
    planes where it lies, then moved and cast."""
    if isinstance(arr, torch.Tensor):
        im = arr.imag if arr.is_complex() else torch.zeros_like(arr)
        return torch.stack([arr.real, im]).to(device=device, dtype=dtype)
    a = np.asarray(arr)
    return to_device(np.stack([a.real, a.imag]), dtype, device)


def is_planar(x, ndim: int) -> bool:
    """True for a real planar tensor of ``ndim`` dimensions, (real plane,
    imaginary plane) on axis 0: what ``matrices``' tensor branches build
    (a matrix (2, D, D), a diagonal (2, D))."""
    return (isinstance(x, torch.Tensor) and not x.is_complex() and x.dim() == ndim
            and x.shape[0] == 2)


def as_planar(x, ndim: int, dtype: torch.dtype, device) -> torch.Tensor:
    """``x`` as a planar tensor of the dtype on the device: a planar one
    (:func:`is_planar`) is only cast, anything else goes through
    :func:`from_complex`."""
    if is_planar(x, ndim):
        return x.to(device=device, dtype=dtype)
    return from_complex(x, dtype, device)


def to_complex(x: torch.Tensor) -> np.ndarray:
    """Planar tensor -> numpy complex host array."""
    h = x.detach().cpu().numpy()
    return h[0] + 1j * h[1]

