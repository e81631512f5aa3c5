"""Execution environment (reference: ``QuESTEnv``, QuEST.h:405-415).

The env carries its mesh, the tuple of ``torch.device``s a register's
amplitudes are sharded over (one device: no sharding), and the seed
state: the user seeds plus a host Mersenne Twister (numpy's MT19937, the
algorithm of the reference's mt19937ar.c) for measurement outcomes.

One process drives the whole mesh, as the JAX package's single-controller
``Mesh`` does: a register on D > 1 devices holds one shard tensor on each
(``registers.Qureg``), and the exchanges between shards are
device-to-device copies (``parallel.exchange``). A mesh may name one
device more than once (virtual shards): the counterpart of the JAX
package's forced host device count, which lets the sharded path run
whole on one card or on the CPU.

Device rule: registers live on the card unless the caller asks for the
CPU. ``createQuESTEnv()`` means every visible card; without CUDA it raises
and names the way to ask for the CPU. It never picks the CPU by itself.
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
    #: the mesh: the devices a register's shards live on, shard r on
    #: devices[r] (a device may repeat)
    devices: tuple
    seeds: list[int] = field(default_factory=list)
    rng: np.random.RandomState | None = None
    #: the per-gate engine of its sharded registers
    #: (``parallel.scheduler.engine``), made at first use
    engine: object = field(default=None, repr=False)

    @property
    def device(self) -> torch.device:
        """The first device of the mesh: where an unsharded register lives."""
        return self.devices[0]

    @property
    def num_ranks(self) -> int:
        return len(self.devices)


def _check_device(dev: torch.device, func: str) -> None:
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise validation.QuESTError(
            f"CUDA is not available, so the registers cannot live on {dev}. "
            "Pass device=\"cpu\" to run on the CPU.", func)
    if dev.type not in ("cuda", "cpu"):
        raise validation.QuESTError(
            f"unsupported device {dev}; use a CUDA device or \"cpu\"", func)


def createQuESTEnv(device: str | torch.device | None = None,
                   devices: Sequence[str | torch.device] | None = None) -> QuESTEnv:
    """Create the environment (createQuESTEnv, QuEST.h:2196).

    ``devices`` is the mesh; a power-of-2 count is required, as the
    reference's validateNumRanks. ``device`` asks for a one-device env.
    With neither: every visible card, trimmed to the largest power of two
    (as the JAX package trims its devices). A CUDA device without CUDA
    raises; the CPU is used only when named."""
    func = "createQuESTEnv"
    if device is not None and devices is not None:
        raise validation.QuESTError("pass device= or devices=, not both", func)
    if devices is None:
        if device is not None:
            devices = [device]
        elif torch.cuda.is_available():
            count = torch.cuda.device_count()
            devices = [f"cuda:{i}" for i in range(1 << (count.bit_length() - 1))]
        else:
            devices = ["cuda:0"]  # raises below, naming device="cpu"
    devs = tuple(torch.device(d) for d in devices)
    for d in devs:
        _check_device(d, func)
    validation.validate_num_ranks(len(devs), func)
    if len({d.type for d in devs}) > 1:
        raise validation.QuESTError(
            f"a mesh holds devices of one type, got {[str(d) for d in devs]}", func)
    env = QuESTEnv(devices=devs)
    seedQuESTDefault(env)
    return env


def destroyQuESTEnv(env: QuESTEnv) -> None:
    """Nothing to release (no MPI_Finalize); kept for API parity."""


def syncQuESTEnv(env: QuESTEnv) -> None:
    """Barrier analogue (MPI_Barrier, QuEST_cpu_distributed.c:166-168): wait
    for the work queued on every CUDA device of the env's mesh; nothing to
    wait for on the CPU."""
    for d in dict.fromkeys(env.devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def syncQuESTSuccess(success_code: int) -> int:
    """All-ranks success agreement (MPI_LAND allreduce in the reference,
    QuEST_cpu_distributed.c:170-174). One controlling process: identity."""
    return success_code


def reportQuESTEnv(env: QuESTEnv) -> None:
    """Print deployment info (reportQuESTEnv; the JAX package's line layout,
    with this package's backend line: torch and CUDA versions, device
    names)."""
    names = sorted({torch.cuda.get_device_name(d) if d.type == "cuda" else "cpu"
                    for d in env.devices})
    print("EXECUTION ENVIRONMENT:")
    print(f"Backend: PyTorch {torch.__version__}, CUDA {torch.version.cuda or 'none'}, "
          f"devices {', '.join(names)}")
    print(f"Number of devices: {env.num_ranks}")
    plats = {d.type for d in env.devices}
    print(f"Device platform(s): {', '.join(sorted(plats)) or 'none'}")
    print(f"Precision default: {os.environ.get('QUEST_PRECISION', '1')}")


def getEnvironmentString(env: QuESTEnv) -> str:
    """The execution-environment summary (getEnvironmentString, QuEST.h:123):
    ``CUDA=1`` when the mesh is on cards, ``CUDA=0`` on the CPU."""
    n = env.num_ranks
    cuda = int(any(d.type == "cuda" for d in env.devices))
    return f"CUDA={cuda} OpenMP=0 MPI=0 TPU=0 threads=1 ranks={n} devices={n}"


def seedQuEST(env: QuESTEnv, seeds: Sequence[int]) -> None:
    """Seed the measurement RNG from a user key array (numpy's MT19937
    init_by_array, as the reference, QuEST_common.c:209-217)."""
    validation.validate_num_seeds(seeds, "seedQuEST")
    env.seeds = [int(s) for s in seeds]
    env.rng = np.random.RandomState(np.asarray(env.seeds, dtype=np.uint32))


def seedQuESTDefault(env: QuESTEnv) -> None:
    """Default seeding from time + pid (QuEST_common.c:195-207)."""
    seedQuEST(env, [int(time.time()) & 0xFFFFFFFF, os.getpid() & 0xFFFFFFFF])


def getQuESTSeeds(env: QuESTEnv) -> list[int]:
    """The seeds the env's RNG was last seeded with (QuEST.h:126)."""
    return list(env.seeds)
