"""Tapeable mid-circuit measurement and collapse (``quest_tpu/sampling/measure.py``).

``measure`` and ``collapseToOutcome`` read a probability back to the host
and branch on it, so they never go on a tape. These two entries are their
recordable forms: the outcome is drawn (or forced) and applied on the
device with a branch-free one-hot collapse and a clamped renormalisation,
so a tape's structure does not depend on the drawn value, and the entry
runs inside a captured replay like any gate:

- both are fusion barriers (``_fusion_barrier``: ``fusion.capture`` never
  records them) and measurement sites (``_measurement_site``:
  ``segments.segment_cuts`` forces a seam at each);
- ``applyMidMeasurement``'s ``seed`` is a value slot of kind ``'seed'``
  (``engine.params._LIFTABLE``): a plain int or a ``P("name")`` both
  lift, so S seeds replay one executable, and under the Engine's
  ``torch.func.vmap`` each lane draws from its own seed.

A register sharded over several devices is refused here: sampling and
measurement over shards are a later slice of the port.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from .. import validation as V
from ..ops import reduce as R
from ..ops.layout import grouped_axes
from . import rng
from .sampler import shot_key

if TYPE_CHECKING:
    from ..registers import Qureg

__all__ = ["applyMidMeasurement", "applyMidCollapse"]

#: probability floor of the renormalisation: a branch this small is
#: numerical cancellation, not physics
_P_FLOOR = 1e-30


def _one_device(qureg, func: str) -> None:
    if qureg.shards is not None:
        raise V.QuESTNotPortedError(
            "a register sharded over several devices is not measured mid-circuit "
            "yet (sampling over shards is a later slice of the port)", func)


def _keep(outcome, dtype, device) -> torch.Tensor:
    """(2,) one-hot of ``outcome`` (an int or a 0-d integer tensor)."""
    return (torch.arange(2, device=device) == outcome).to(dtype)


def _collapse_statevec(amps, *, n, target, outcome, p_sel):
    """Branch-free collapse and renormalisation: the one-hot mask over the
    target axis times rsqrt(max(p_sel, floor))."""
    shape, axis_of = grouped_axes(n, (target,))
    m = [1] * len(shape)
    m[axis_of[target]] = 2
    mask = _keep(outcome, amps.dtype, amps.device).reshape(m)
    scale = torch.rsqrt(torch.clamp(p_sel, min=_P_FLOOR)).to(amps.dtype)
    return (amps.reshape((2,) + shape) * mask * scale).reshape(2, -1)


def _collapse_density(amps, *, n, target, outcome, p_sel):
    """Density variant: zero every element whose row or column bit of
    ``target`` differs from the outcome, scale by 1/max(p_sel, floor)."""
    shape, axis_of = grouped_axes(2 * n, (target, target + n))
    keep = _keep(outcome, amps.dtype, amps.device)
    mask = None
    for q in (target, target + n):
        s = [1] * len(shape)
        s[axis_of[q]] = 2
        v = keep.reshape(s)
        mask = v if mask is None else mask * v
    scale = (1.0 / torch.clamp(p_sel, min=_P_FLOOR)).to(amps.dtype)
    return (amps.reshape((2,) + shape) * mask * scale).reshape(2, -1)


def _zero_prob(amps, n, target, density):
    """P(outcome 0 on ``target``) and the total probability, as compensated
    device reductions (no host read)."""
    shape, axis_of = grouped_axes(n, (target,))
    if density:
        dim = 1 << n
        d = torch.diagonal(amps[0].reshape(dim, dim)).reshape(shape)
        p0 = R._csum(d.select(axis_of[target], 0))
        return p0, R.total_prob_density(amps, n=n)
    sub = amps.reshape((2,) + shape).select(axis_of[target] + 1, 0)
    p0 = R._csum(sub[0] * sub[0] + sub[1] * sub[1])
    return p0, R.total_prob_statevec(amps)


def applyMidMeasurement(qureg: Qureg, target: int, seed: object, site: int = 0) -> None:
    """Measure ``target`` mid-circuit on the device: draw the outcome from
    the qubit's marginal with the stream ``fold_in(PRNGKey(seed), site)``
    (one float32 uniform, whatever the register's precision) and collapse
    and renormalise branch-free. Recordable on a tape; the drawn outcome
    never reaches the host (read it from a final shot table of the same
    seed, or use eager ``measure`` where host control flow needs it).

    ``seed``: a per-request integer (taken modulo 2^32), recordable as
    ``P("name")``. ``site``: a static counter; distinct measurement sites
    of one tape carry distinct sites."""
    func = "applyMidMeasurement"
    V.validate_target(qureg, target, func)
    _one_device(qureg, func)
    target = int(target)
    p0, total = _zero_prob(qureg.amps, qureg.num_qubits_represented, target,
                           qureg.is_density_matrix)
    u = rng.uniform(shot_key(seed, site, qureg.device))
    outcome = (u.to(p0.dtype) * total >= p0).to(torch.int64)
    p_sel = torch.where(outcome == 0, p0, total - p0)
    fn = _collapse_density if qureg.is_density_matrix else _collapse_statevec
    qureg.put(fn(qureg.amps, n=qureg.num_qubits_represented, target=target,
                 outcome=outcome, p_sel=p_sel))
    if qureg.qasm_log is not None:
        qureg.qasm_log.record_comment(f"midMeasurement site {int(site)} on qubit {target}")


def applyMidCollapse(qureg: Qureg, target: int, outcome: int) -> None:
    """Force ``target`` to ``outcome`` mid-circuit on the device: the
    recordable form of ``collapseToOutcome``, without its host-returned
    probability and its zero-probability check (the renormalisation
    clamps instead: a zero-probability branch collapses to a zero state).
    Deterministic: no seed."""
    func = "applyMidCollapse"
    V.validate_target(qureg, target, func)
    V.validate_outcome(outcome, func)
    _one_device(qureg, func)
    target, outcome = int(target), int(outcome)
    p0, total = _zero_prob(qureg.amps, qureg.num_qubits_represented, target,
                           qureg.is_density_matrix)
    p_sel = p0 if outcome == 0 else total - p0
    fn = _collapse_density if qureg.is_density_matrix else _collapse_statevec
    qureg.put(fn(qureg.amps, n=qureg.num_qubits_represented, target=target,
                 outcome=outcome, p_sel=p_sel))
    if qureg.qasm_log is not None:
        qureg.qasm_log.record_comment(f"midCollapse of qubit {target} to outcome {outcome}")


# the collapse mask exists only at apply time, from the runtime draw: never
# a static event the planner could fuse
applyMidMeasurement._fusion_barrier = True
applyMidCollapse._fusion_barrier = True
# segment seams key off this tag
applyMidMeasurement._measurement_site = True
applyMidCollapse._measurement_site = True
