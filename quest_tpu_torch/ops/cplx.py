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


def from_complex(arr, dtype: torch.dtype, device) -> torch.Tensor:
    """Host complex array -> planar (2, *shape) tensor on ``device``."""
    a = np.asarray(arr)
    return torch.as_tensor(np.stack([a.real, a.imag]), dtype=dtype,
                           device=device)


def to_complex(x: torch.Tensor) -> np.ndarray:
    """Planar tensor -> numpy complex host array."""
    h = x.detach().cpu().numpy()
    return h[0] + 1j * h[1]

