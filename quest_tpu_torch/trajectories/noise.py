"""Tapeable trajectory noise: the channel site of an unraveled tape
(``quest_tpu/trajectories/noise.py``).

``applyTrajectoryKraus`` is the one recordable entry every unraveled
channel lowers to (``trajectories.unravel`` maps the built-in mix* table
onto it). Its Kraus stack, targets and site index are tape *structure*;
``seed`` is a value slot of kind ``'seed'`` (``engine.params._LIFTABLE``):
a plain int or a ``P("name")`` both lift, so neither the plan nor the
executable cache's fingerprint depends on the seed, and under the
Engine's ``torch.func.vmap`` each lane draws from its own seed (a tensor in
the captured graph's value buffer).

On a fused plan these entries are barriers (``_fusion_barrier``: the drawn
operator exists only at apply time), run on the per-gate engine between
the fused runs, like the Param barriers of a parameterized plan.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Iterable, Sequence

import numpy as np

from .. import validation as V
from ..parallel.scheduler import engine as _engine
from ..validation import QuESTError
from .sample import apply_traj_kraus

if TYPE_CHECKING:
    from ..registers import Qureg

__all__ = ["applyTrajectoryKraus"]


def applyTrajectoryKraus(qureg: Qureg, targets: Iterable[int], ops: Sequence[np.ndarray],
                         seed: object, site: int = 0) -> None:
    """Sample one Kraus operator of ``ops`` on ``targets`` with the
    trajectory's stream and apply it renormalised to the state-vector
    ``qureg`` (a density register takes the exact channel through mix*).

    ``ops``: the channel's CPTP Kraus set (host matrices, baked structure).
    ``seed``: the per-trajectory integer (taken modulo 2^32), recordable
    as ``P("seed")`` so the Engine batches T trajectories into one
    dispatch. ``site``: a static per-site counter (the ``fold_in`` stream
    split); distinct channel sites of one tape carry distinct sites."""
    func = "applyTrajectoryKraus"
    if qureg.is_density_matrix:
        raise QuESTError(
            f"{func} unravels noise over pure states; density registers apply the "
            "exact channel via the mix* family instead")
    targets = tuple(int(t) for t in targets)
    V.validate_multi_targets(qureg, targets, func)
    ops = [np.asarray(op) for op in ops]
    V.validate_kraus_ops(ops, len(targets), qureg.eps, func, check_cptp=True)
    n = qureg.num_qubits_in_state_vec
    if qureg.shards is not None:
        qureg.put_shards(apply_traj_kraus(qureg.shards, ops, n=n, targets=targets,
                                          seed=seed, site=int(site),
                                          scheduler=_engine(qureg)))
    else:
        qureg.put(apply_traj_kraus(qureg.amps, ops, n=n, targets=targets, seed=seed,
                                   site=int(site)))
    if qureg.qasm_log is not None:
        qureg.qasm_log.record_comment(
            f"trajectoryKraus site {int(site)} on qubits {list(targets)} ({len(ops)} ops)")


# the drawn operator is assembled at apply time from the runtime seed:
# never a static event the planner could fuse, even for a constant seed
applyTrajectoryKraus._fusion_barrier = True
