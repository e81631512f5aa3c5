"""Precision system for quest_tpu_torch.

As in the reference (``QuEST/include/QuEST_precision.h:40-96``), precision
selects the real type of the amplitude planes and the validation epsilon
``REAL_EPS``. It is a runtime choice carried per register (the dtype of its
planar tensor), with a process-wide default from the ``QUEST_PRECISION``
environment variable (1 = single, 2 = double). Quad precision is not
supported.
"""

from __future__ import annotations

import os

import torch

#: QuEST PRECISION code -> (real dtype, REAL_EPS); eps values mirror
#: QuEST_precision.h:48,63 (1e-5 single, 1e-13 double)
_PRECISIONS = {
    1: (torch.float32, 1e-5),
    2: (torch.float64, 1e-13),
}


def default_precision() -> int:
    """Process-wide default precision code (1 or 2), from $QUEST_PRECISION."""
    code = int(os.environ.get("QUEST_PRECISION", "1"))
    if code not in _PRECISIONS:
        raise ValueError(f"QUEST_PRECISION must be 1 or 2, got {code}")
    return code


def real_dtype(precision: int | None = None) -> torch.dtype:
    code = default_precision() if precision is None else precision
    return _PRECISIONS[code][0]


def precision_for_dtype(dtype) -> int:
    return 1 if as_torch_dtype(dtype) == torch.float32 else 2


def eps_for_dtype(dtype) -> float:
    """REAL_EPS for a given amplitude dtype."""
    return _PRECISIONS[precision_for_dtype(dtype)][1]


def as_torch_dtype(dtype) -> torch.dtype:
    """Accept a torch dtype, a numpy dtype or a dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    import numpy as np

    name = np.dtype(dtype).name
    if name not in ("float32", "float64"):
        raise ValueError(f"amplitude planes must be float32 or float64, got {name}")
    return getattr(torch, name)
