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

Over shards (``_zero_prob_shards``, ``_collapse_shards``) the outcome's
probability and the total are reduced shard by shard and cascaded in
shard order on the first shard's device, where the outcome is drawn from
the same stream as on one device; each shard then collapses on its own
device: by the one-hot mask on a local target, and on a sharded one by a
0/1 factor from its index bit, so a shard on the other branch is zeroed.
Nothing is read back to the host, and nothing moves between shards but
the 0-d outcome and scale.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from .. import validation as V
from ..ops import measure as M, reduce as R
from ..ops.layout import grouped_axes
from ..parallel.mesh import local_qubit_count
from . import rng
from .sampler import shot_key

if TYPE_CHECKING:
    from ..registers import Qureg

__all__ = ["applyMidMeasurement", "applyMidCollapse"]

#: probability floor of the renormalisation: a branch this small is
#: numerical cancellation, not physics
_P_FLOOR = 1e-30


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


def _zero_prob_shards(shards, n, target, density):
    """:func:`_zero_prob` of a sharded register: P(outcome 0 on ``target``)
    and the total, each shard's partial on its device (a density matrix's
    from the diagonal entries it holds), cascaded in shard order on the
    first shard's device."""
    if not density:
        return (R.prob_of_outcome_shards(shards, n=n, target=target, outcome=0),
                R.total_prob_shards(shards))
    parts, nl, _ = M.prob_sources(shards, n=n, density=True)
    if target < nl:
        shape, axis_of = grouped_axes(nl, (target,))
        p0 = R._csum_parts([R._csum(x.reshape(shape).select(axis_of[target], 0))
                            for x in parts])
    else:
        keep = [R._csum(x) for r, x in enumerate(parts) if not (r >> (target - nl)) & 1]
        p0 = R._csum_parts(keep)
    return p0, R.total_prob_density_shards(shards, n=n)


def _collapse_shards(shards, *, nsv, qubits, outcome, scale):
    """Each shard times the one-hot of ``outcome`` over ``qubits`` (of the
    nsv-qubit flattened state) and ``scale``, on its own device: a local
    qubit masks its axis, a sharded one contributes its shard-index bit's
    0/1 factor. ``outcome`` is an int or a 0-d tensor, ``scale`` a 0-d
    tensor, on the first shard's device (moved, never read)."""
    nl = local_qubit_count(nsv, shards)
    local = tuple(q for q in qubits if q < nl)
    out = []
    for r, s in enumerate(shards):
        dev = s.device
        o = outcome.to(dev) if isinstance(outcome, torch.Tensor) else outcome
        f = scale.to(dev)
        for q in qubits:
            if q >= nl:
                hit = o == ((r >> (q - nl)) & 1)
                f = f * (hit.to(s.dtype) if isinstance(hit, torch.Tensor) else float(hit))
        if local:
            shape, axis_of = grouped_axes(nl, local)
            keep = _keep(o, s.dtype, dev)
            mask = None
            for q in local:
                m = [1] * len(shape)
                m[axis_of[q]] = 2
                v = keep.reshape(m)
                mask = v if mask is None else mask * v
            out.append((s.reshape((2,) + shape) * mask * f).reshape(s.shape))
        else:
            out.append(s * f)
    return out


def _apply_outcome(qureg, target, outcome, p_sel) -> None:
    """Collapse ``qureg`` on ``target`` to the 0-d ``outcome`` and
    renormalise by ``p_sel`` (clamped), branch-free: on its tensor or on
    each of its shards."""
    n = qureg.num_qubits_represented
    density = qureg.is_density_matrix
    if qureg.shards is None:
        fn = _collapse_density if density else _collapse_statevec
        qureg.put(fn(qureg.amps, n=n, target=target, outcome=outcome, p_sel=p_sel))
        return
    p = torch.clamp(p_sel, min=_P_FLOOR)
    scale = (1.0 / p) if density else torch.rsqrt(p)
    qubits = (target, target + n) if density else (target,)
    qureg.put_shards(_collapse_shards(qureg.shards, nsv=qureg.num_qubits_in_state_vec,
                                      qubits=qubits, outcome=outcome,
                                      scale=scale.to(qureg.dtype)))


def _probs(qureg, target):
    if qureg.shards is None:
        return _zero_prob(qureg.amps, qureg.num_qubits_represented, target,
                          qureg.is_density_matrix)
    return _zero_prob_shards(qureg.shards, qureg.num_qubits_represented, target,
                             qureg.is_density_matrix)


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
    target = int(target)
    p0, total = _probs(qureg, target)
    u = rng.uniform(shot_key(seed, site, qureg.device))
    outcome = (u.to(p0.dtype) * total >= p0).to(torch.int64)
    p_sel = torch.where(outcome == 0, p0, total - p0)
    _apply_outcome(qureg, target, outcome, p_sel)
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
    target, outcome = int(target), int(outcome)
    p0, total = _probs(qureg, target)
    p_sel = p0 if outcome == 0 else total - p0
    _apply_outcome(qureg, target, outcome, p_sel)
    if qureg.qasm_log is not None:
        qureg.qasm_log.record_comment(f"midCollapse of qubit {target} to outcome {outcome}")


# the collapse mask exists only at apply time, from the runtime draw: never
# a static event the planner could fuse
applyMidMeasurement._fusion_barrier = True
applyMidCollapse._fusion_barrier = True
# segment seams key off this tag
applyMidMeasurement._measurement_site = True
applyMidCollapse._measurement_site = True
