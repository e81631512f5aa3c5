"""State initialisation (reference: ``QuEST_cpu.c:1416-1680`` init family).

Each function returns a fresh planar (2, num_amps) tensor on ``device``.
"""

from __future__ import annotations

import math

import torch


def init_blank(num_amps: int, dtype: torch.dtype, device) -> torch.Tensor:
    """All-zero (unnormalised) state -- initBlankState."""
    return torch.zeros((2, num_amps), dtype=dtype, device=device)


def init_classical(num_amps: int, dtype: torch.dtype, device,
                   index: int = 0) -> torch.Tensor:
    """|index> one-hot -- initClassicalState / initZeroState (index=0)."""
    amps = torch.zeros((2, num_amps), dtype=dtype, device=device)
    amps[0, index] = 1
    return amps


def init_plus(num_amps: int, dtype: torch.dtype, device) -> torch.Tensor:
    """Uniform superposition -- initPlusState."""
    amps = torch.zeros((2, num_amps), dtype=dtype, device=device)
    amps[0].fill_(1.0 / math.sqrt(num_amps))
    return amps


def init_debug(num_amps: int, dtype: torch.dtype, device) -> torch.Tensor:
    """amp_i = (2i + (2i+1) j)/10 -- initDebugState, the test fixture
    (statevec_initDebugState, QuEST_cpu.c:1649-1680)."""
    i = torch.arange(num_amps, dtype=dtype, device=device)
    return torch.stack([(2 * i) / 10, (2 * i + 1) / 10])
