"""Branch-free stochastic Kraus selection over a pure state
(``quest_tpu/trajectories/sample.py``).

The quantum-trajectory unraveling: at a channel site with Kraus operators
{K_k}, a trajectory draws index k with probability
p_k = <psi| K_k^dagger K_k |psi> and continues in the renormalised state
K_k|psi> / sqrt(p_k). The ensemble mean of |psi><psi| over trajectories
converges to the density-matrix evolution at 1/sqrt(T).

The selection runs inside one captured, lane-batched replay (the Engine's
``torch.func.vmap`` over the seed lanes), so nothing here depends on the
seed's value or on the drawn index: no host read, no branch.

- the probabilities come from ONE reduced density over the targets
  (p_k = Tr(M_k rho_red), M_k = K_k^dagger K_k baked on the host): one
  elementwise product and one float64-accumulated sum per pair of target
  rows, on strided views of the state (the JAX package's ``a @ a.T`` on
  the card is a matmul with an inner dimension of 2^n/d, which cuBLAS
  runs slowly and, in float32, too inexactly for the renormalisation);
- the drawn index is the branch-free inverse-CDF count
  ``sum(u * norm >= cumsum(p))``, clamped to m-1;
- the selected operator is a one-hot contraction over the baked Kraus
  stack, with the 1/sqrt(p_k) renormalisation folded into the matrix,
  which one ``ops.apply.apply_matrix`` pass applies (the sharded
  scheduler's on a sharded register).

The draw is ``uniform(fold_in(PRNGKey(seed), site))`` in float32 from
:mod:`..sampling.rng`, the JAX package's threefry stream bit for bit, so
one seed walks one Kraus path in both packages, in every precision.
"""

from __future__ import annotations

import numpy as np
import torch

from .._capture import to_device
from ..ops import apply as _apply
from ..ops.layout import grouped_axes
from ..sampling import rng
from ..sampling.sampler import shot_key

__all__ = ["kraus_probabilities", "traj_kraus_matrix", "apply_traj_kraus"]

#: probability floor of the folded renormalisation: a trajectory reaches a
#: p_k this small only through numerical cancellation (the CPTP check
#: bounds real channels away from it), so the clamp never biases sampling
_P_FLOOR = 1e-30


def _target_rows(plane: torch.Tensor, n: int, targets: tuple) -> list:
    """One planar component (2^n,) as its d = 2^t rows: row s the strided
    view of the amplitudes whose target bits spell s = sum_j bit(targets[j])
    << j (targets[0] the least-significant matrix bit, the apply_matrix
    convention). Views of the grouped layout: nothing is copied."""
    shape, axis_of = grouped_axes(n, targets)
    x = plane.reshape(shape)
    rows = []
    for s in range(1 << len(targets)):
        idx = [slice(None)] * len(shape)
        for j, q in enumerate(targets):
            idx[axis_of[q]] = (s >> j) & 1
        rows.append(x[tuple(idx)])
    return rows


def _sum(x: torch.Tensor) -> torch.Tensor:
    """A sum over every amplitude, accumulated in float64 whatever the
    state's precision (a float32 sum of 2^n terms would drift past the
    renormalisation's tolerance), returned in the state's dtype."""
    return torch.sum(x, dtype=torch.float64).to(x.dtype)


def _reduced_density(amps: torch.Tensor, n: int, targets: tuple) -> tuple:
    """(R, I): the real and imaginary parts of the reduced density over
    ``targets`` (d x d), rho_red[s, t] = R[s, t] + i I[s, t] =
    sum_rest psi[s, rest] conj(psi[t, rest]): one elementwise product and
    one reduction per pair s <= t (R is symmetric, I antisymmetric)."""
    a = _target_rows(amps[0], n, targets)
    b = _target_rows(amps[1], n, targets)
    d = len(a)
    zero = torch.zeros((), dtype=amps.dtype, device=amps.device)
    re = [[zero] * d for _ in range(d)]
    im = [[zero] * d for _ in range(d)]
    for s in range(d):
        for t in range(s, d):
            re[s][t] = re[t][s] = _sum(torch.addcmul(a[s] * a[t], b[s], b[t]))
            if t > s:
                im[s][t] = _sum(torch.addcmul(b[s] * a[t], a[s], b[t], value=-1))
                im[t][s] = -im[s][t]
    return (torch.stack([torch.stack(row) for row in re]),
            torch.stack([torch.stack(row) for row in im]))


def _on(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return to_device(np.asarray(x), dtype, device)


def _probabilities(r: torch.Tensor, im: torch.Tensor, mre, mim) -> torch.Tensor:
    mre = _on(mre, r.dtype, r.device)
    mim = _on(mim, r.dtype, r.device)
    # Re Tr(M rho) = sum_{s,t} Mre[t,s] R[s,t] - Mim[t,s] I[s,t]
    p = torch.einsum("kts,st->k", mre, r) - torch.einsum("kts,st->k", mim, im)
    return torch.clamp(p, min=0.0)


def kraus_probabilities(amps: torch.Tensor, mre, mim, *, n: int, targets) -> torch.Tensor:
    """p_k = Tr(M_k rho_red) for the whole Kraus stack in one reduction
    pass: ``amps`` is the planar (2, 2^n) state, ``mre``/``mim`` the real
    and imaginary parts of M_k = K_k^dagger K_k, shape (m, d, d) (host
    arrays or tensors). Returns the (m,) probability vector in the state's
    dtype (it sums to the squared norm for a CPTP set)."""
    r, im = _reduced_density(amps, n, tuple(int(t) for t in targets))
    return _probabilities(r, im, mre, mim)


def traj_kraus_matrix(p: torch.Tensor, u: torch.Tensor, kre, kim, dtype) -> torch.Tensor:
    """The selected and renormalised Kraus operator as a planar (2, d, d)
    matrix, branch-free: ``p`` the (m,) probability vector, ``u`` a uniform
    [0, 1) draw, ``kre``/``kim`` the (m, d, d) Kraus stack. Selection is
    norm-proportional (``u`` scaled by sum(p), so slight norm drift cannot
    push the draw off the table), and the 1/sqrt(p_k) renormalisation is
    folded into the returned matrix."""
    m = p.shape[-1]
    cdf = torch.cumsum(p, dim=-1)
    draw = u.to(p.dtype) * cdf[-1]
    idx = torch.clamp(torch.sum((draw >= cdf).to(torch.int32)), max=m - 1)
    w = (torch.arange(m, device=p.device) == idx).to(dtype)
    p_sel = torch.sum(w * p.to(dtype))
    scale = torch.rsqrt(torch.clamp(p_sel, min=_P_FLOOR))
    kre = _on(kre, dtype, p.device)
    kim = _on(kim, dtype, p.device)
    sel_re = torch.einsum("k,kij->ij", w, kre) * scale
    sel_im = torch.einsum("k,kij->ij", w, kim) * scale
    return torch.stack([sel_re, sel_im])


def _baked(kraus) -> tuple:
    """The complex (m, d, d) Kraus stack and M_k = K_k^dagger K_k."""
    k = np.asarray([np.asarray(op, dtype=np.complex128) for op in kraus])
    return k, np.einsum("kli,klj->kij", k.conj(), k)


def apply_traj_kraus(amps, kraus, *, n: int, targets, seed, site: int, scheduler=None):
    """One trajectory step: sample a Kraus operator of ``kraus`` (host
    complex operators) on ``targets`` and apply it renormalised. ``amps``
    is a planar state, or a sharded state's list of shards with its
    ``scheduler`` (``parallel.scheduler``). ``seed`` is the per-trajectory
    integer (an int or a 0-d integer tensor: the lifted seed slot, taken
    modulo 2^32); ``site`` the static per-site counter that decorrelates
    the channel sites of one trajectory.

    Shapes, plan and branches are independent of the seed's value and of
    the drawn index, so T trajectories share one captured lane-batched
    program."""
    targets = tuple(int(t) for t in targets)
    k, m_ops = _baked(kraus)
    if isinstance(amps, (list, tuple)):
        return _apply_sharded(list(amps), k, m_ops, n, targets, seed, site, scheduler)
    p = kraus_probabilities(amps, m_ops.real, m_ops.imag, n=n, targets=targets)
    # float32 draw whatever the precision: f32 and f64 trajectories of one
    # seed walk the same Kraus path
    u = rng.uniform(shot_key(seed, site, amps.device))
    km = traj_kraus_matrix(p, u, k.real, k.imag, amps.dtype)
    return _apply.apply_matrix(amps, km, n=n, targets=targets)


def _apply_sharded(shards, k, m_ops, n, targets, seed, site, scheduler):
    """The sharded step: sharded targets swap into local slots (the
    scheduler's relocation), every shard adds its part of the reduced
    density on the first shard's device, one draw selects the operator,
    each shard applies it, and the swaps are undone."""
    from ..parallel import exchange as X
    from ..parallel.mesh import local_qubit_count

    nl = local_qubit_count(n, shards)
    shards, swaps, moved = scheduler._relocate(shards, n, nl, targets)
    local = tuple(moved.get(t, t) for t in targets)
    dev = shards[0].device
    r = im = None
    for s in shards:
        rs, ims = _reduced_density(s, nl, local)
        rs, ims = rs.to(dev), ims.to(dev)
        r, im = (rs, ims) if r is None else (r + rs, im + ims)
    p = _probabilities(r, im, m_ops.real, m_ops.imag)
    u = rng.uniform(shot_key(seed, site, dev))
    km = traj_kraus_matrix(p, u, k.real, k.imag, shards[0].dtype)
    shards = X.dist_apply_local_matrix(shards, km, n=n, targets=local)
    for s, f in swaps:
        scheduler.stats["relocation_swaps"] += 1
        shards = X.dist_swap(shards, n=n, qb1=f, qb2=s)
    return shards
