"""Execution environment (reference: ``QuESTEnv``, QuEST.h:405-415).

The env carries the ``torch.device`` every register of it lives on, and the
seed state: the user seeds plus a host Mersenne Twister (numpy's MT19937,
the algorithm of the reference's mt19937ar.c) for measurement outcomes.

Device rule: registers live on the card unless the caller asks for the
CPU. ``createQuESTEnv()`` means ``cuda:0``; without CUDA it raises and names
the way to ask for the CPU. It never picks the CPU by itself.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from . import validation


@dataclass
class QuESTEnv:
    device: torch.device
    seeds: list[int] = field(default_factory=list)
    rng: np.random.RandomState | None = None


def createQuESTEnv(device: str | torch.device | None = None) -> QuESTEnv:
    """Create the environment (createQuESTEnv, QuEST.h:2196) on ``device``
    (default ``cuda:0``). A CUDA device without CUDA raises."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise validation.QuESTError(
            f"CUDA is not available, so the registers cannot live on {dev}. "
            "Pass device=\"cpu\" to run on the CPU.", "createQuESTEnv")
    if dev.type not in ("cuda", "cpu"):
        raise validation.QuESTError(
            f"unsupported device {dev}; use a CUDA device or \"cpu\"",
            "createQuESTEnv")
    env = QuESTEnv(device=dev)
    seedQuESTDefault(env)
    return env


def seedQuEST(env: QuESTEnv, seeds: Sequence[int]) -> None:
    """Seed the measurement RNG from a user key array (numpy's MT19937
    init_by_array, as the reference, QuEST_common.c:209-217)."""
    validation.validate_num_seeds(seeds, "seedQuEST")
    env.seeds = [int(s) for s in seeds]
    env.rng = np.random.RandomState(np.asarray(env.seeds, dtype=np.uint32))


def seedQuESTDefault(env: QuESTEnv) -> None:
    """Default seeding from time + pid (QuEST_common.c:195-207)."""
    seedQuEST(env, [int(time.time()) & 0xFFFFFFFF, os.getpid() & 0xFFFFFFFF])
