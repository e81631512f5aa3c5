"""Quantum-trajectory noise: noisy circuits at state-vector cost
(``quest_tpu/trajectories``).

Unravels the decoherence channels of a density-matrix tape into stochastic
pure-state trajectories (the Monte-Carlo-wavefunction technique) and runs
the ensemble as ONE lane-batched program through the serving Engine:
channel sites carry a runtime seed slot (``engine.params`` kind
``'seed'``), so T trajectories build once and replay with T independent
counter-based streams (``sampling.rng``, the JAX package's threefry bit
for bit); the branch-free selection keeps the plan's structure independent
of the values.

- :func:`unravel` -- density tape -> trajectory tape (one shared seed Param)
- :func:`noise.applyTrajectoryKraus` -- the recordable channel site
- :func:`run_ensemble` -- T seeds through one Engine, ``TrajectoryResult``
- :func:`ensemble_density` -- the small-n oracle-comparison helper
- the channel table both noise routes share is :mod:`quest_tpu_torch.channels`
"""

from .ensemble import (DEFAULT_TRAJECTORIES, SEED_PARAM, TrajectoryResult,  # noqa: F401
                       ensemble_density, run_ensemble, trajectory_count_default, unravel)
from .noise import applyTrajectoryKraus  # noqa: F401
from .sample import apply_traj_kraus  # noqa: F401

__all__ = [
    "unravel", "run_ensemble", "ensemble_density", "TrajectoryResult",
    "trajectory_count_default", "applyTrajectoryKraus", "apply_traj_kraus",
    "DEFAULT_TRAJECTORIES", "SEED_PARAM",
]
