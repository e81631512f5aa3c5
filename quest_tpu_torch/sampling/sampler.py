"""Batched on-device inverse-CDF shot sampling (``quest_tpu/sampling/sampler.py``).

All S shots of a request are one fixed-shape computation over the
state's outcome marginal: build the marginal's CDF once, then every shot
is a branch-free two-level inverse-CDF search.

- The 2^t marginal is reshaped into (B, L) blocks (B = 2^(t // 2)): each
  row's CDF, the rows' totals, and the (B,) CDF of those totals (the block
  offsets). A shot counts its block in the block CDF, then its outcome in
  that one row: O(log B + log L) work a shot, and never an (S, 2^t)
  comparison.
- Draws are float32 uniforms from the counter-based threefry stream
  ``fold_in(PRNGKey(seed), site)`` (:mod:`.rng`, bit for bit the JAX
  package's), scaled by the state's compensated total probability, so norm
  drift cannot push a shot off the table.
- The CDFs accumulate in float32 in a FIXED order written in elementwise
  torch ops (:func:`_add_scan`, log-step Hillis-Steele adds), made
  non-decreasing by a running maximum (exact in any order). The same
  marginal, uniforms and total therefore give the same table on the CPU
  and on the card. ``torch.cumsum`` and XLA's ``cumsum`` each add in
  another order, so against the JAX package a shot may land on the
  neighbouring outcome where its draw lies within a few ulps of an edge.
- A count is a binary search of log2(width) gathers: on a non-decreasing
  table it equals the JAX package's ``sum(draw >= cdf)``.

The shot count and target set are static (the program's shape); the seed
is a runtime value: a tensor, copied into a captured graph's buffer, or a
lifted ``'seed'`` slot, so S seeds replay one captured program.
"""

from __future__ import annotations

import torch

from ..ops import measure as M, reduce as R
from . import rng

__all__ = ["marginal_probs", "draw_outcomes", "sample_statevec", "sample_density",
           "shot_key", "seed_tensor", "cdf_tables", "sample_jit"]


def seed_tensor(seed, device) -> torch.Tensor:
    """A request's seed as a 0-d int64 tensor on ``device``, taken modulo
    2^32 as numpy's uint32 cast takes it: a tensor argument, which a
    captured program copies into its own buffer (an int would key one
    graph per seed)."""
    if isinstance(seed, torch.Tensor):
        return seed.to(device=device, dtype=torch.int64) & 0xFFFFFFFF
    return torch.tensor(int(seed) & 0xFFFFFFFF, dtype=torch.int64, device=device)


def shot_key(seed, site: int = 0, device=None) -> tuple:
    """The counter-based key of one sampling site:
    ``fold_in(PRNGKey(seed), site)``. Every sampling site of a tape gets
    its own stream from one seed (taken modulo 2^32)."""
    return rng.fold_in(rng.key(seed, device), int(site))


def marginal_probs(amps: torch.Tensor, *, n: int, targets: tuple,
                   density: bool = False) -> torch.Tensor:
    """The (2^t,) float32 outcome marginal of the planar state over
    ``targets`` (targets[0] = the outcome's least-significant bit), by the
    compensated grouped sums of :mod:`..ops.measure`; over every qubit in
    order it is |amp|^2 itself."""
    targets = tuple(int(t) for t in targets)
    if density:
        p = M.density_prob_of_all_outcomes(amps, n=n, targets=targets)
    elif targets == tuple(range(n)):
        p = amps[0] * amps[0] + amps[1] * amps[1]
    else:
        p = M.prob_of_all_outcomes(amps, n=n, targets=targets)
    return p.to(torch.float32)


def _block_bits(t: int, mesh_devices: int | None = None) -> int:
    """The block-count exponent of the (B, L) split: balanced (t // 2), or
    the shard-bit count when an amplitude mesh is wider (each block then
    lies in one shard)."""
    b = t // 2
    if mesh_devices and mesh_devices > 1:
        b = max(b, (int(mesh_devices) - 1).bit_length())
    return min(b, t)


def _add_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the last axis in a fixed order: log-step
    (Hillis-Steele) elementwise adds, the same bits on every device."""
    m = x.shape[-1]
    d = 1
    while d < m:
        x = torch.cat([x[..., :d], x[..., d:] + x[..., :-d]], dim=-1)
        d <<= 1
    return x


def _monotone(x: torch.Tensor) -> torch.Tensor:
    """The running maximum along the last axis (exact whatever the order):
    a scan of non-negative terms made non-decreasing, so a count of its
    entries <= a draw is a binary search."""
    return torch.cummax(x, dim=-1).values


def cdf_tables(p: torch.Tensor) -> tuple:
    """``(row_cdf, block_cdf)`` of the (2^t,) float32 marginal: the (B, L)
    rows' CDFs and the (B,) CDF of their totals, both non-decreasing."""
    t = int(p.shape[-1]).bit_length() - 1
    bb = _block_bits(t)
    B, L = 1 << bb, 1 << (t - bb)
    row_cdf = _monotone(_add_scan(p.reshape(B, L)))
    block_cdf = _monotone(_add_scan(row_cdf[:, -1]))
    return row_cdf, block_cdf


def _count_le(cdf: torch.Tensor, x: torch.Tensor, base, width: int) -> torch.Tensor:
    """For each x, the number of entries of ``cdf[base:base + width]``
    (non-decreasing, 1-D) that are <= x: a binary search of log2(width)
    gathers."""
    pos = torch.zeros_like(x, dtype=torch.int64)
    k = width.bit_length() - 1
    for j in range(k - 1, -1, -1):
        cand = pos + (1 << j)
        v = torch.gather(cdf, 0, base + cand - 1)
        pos = torch.where(v <= x, cand, pos)
    return pos


def draw_outcomes(p: torch.Tensor, u: torch.Tensor, *, norm=None) -> torch.Tensor:
    """Inverse-CDF draw of ``u.shape[0]`` shots from the (2^t,) float32
    marginal ``p``: int32 outcome indices. ``u`` is the (S,) float32
    uniform vector; ``norm`` scales the draws (default: the marginal's own
    total from its CDF). Branch-free and fixed-shape."""
    row_cdf, block_cdf = cdf_tables(p)
    B, L = row_cdf.shape
    if norm is None:
        total = block_cdf[-1]
    elif isinstance(norm, torch.Tensor):
        total = norm.to(torch.float32)
    else:
        total = torch.full((), float(norm), dtype=torch.float32, device=p.device)
    draws = u.to(torch.float32) * total
    zero = torch.zeros_like(draws, dtype=torch.int64)
    b = torch.clamp(_count_le(block_cdf, draws, zero, B), max=B - 1)
    prev = torch.gather(block_cdf, 0, torch.clamp(b - 1, min=0))
    offset = torch.where(b > 0, prev, torch.zeros_like(prev))
    j = torch.clamp(_count_le(row_cdf.reshape(-1), draws - offset, b * L, L), max=L - 1)
    return (b * L + j).to(torch.int32)


def sample_statevec(amps: torch.Tensor, *, n: int, targets: tuple, shots: int, seed,
                    site: int = 0) -> torch.Tensor:
    """S = ``shots`` outcome draws over ``targets`` of a planar state
    vector: the (S,) int32 shot table. ``seed`` is an int or an integer
    tensor (a lifted seed slot); ``site`` decorrelates the sampling sites
    of one tape."""
    p = marginal_probs(amps, n=n, targets=tuple(targets))
    norm = R.total_prob_statevec(amps).to(torch.float32)
    u = rng.uniform(shot_key(seed, site, amps.device), (int(shots),))
    return draw_outcomes(p, u, norm=norm)


def sample_density(amps: torch.Tensor, *, n: int, targets: tuple, shots: int, seed,
                   site: int = 0) -> torch.Tensor:
    """:func:`sample_statevec` of a density register: the marginal from the
    diagonal, the normalizer Re tr(rho)."""
    p = marginal_probs(amps, n=n, targets=tuple(targets), density=True)
    norm = R.total_prob_density(amps, n=n).to(torch.float32)
    u = rng.uniform(shot_key(seed, site, amps.device), (int(shots),))
    return draw_outcomes(p, u, norm=norm)


class _SampleProgram:
    """One compiled sampling program (``_capture``): a Replay of the
    sampler on the state's own buffer, which it only reads, with a
    one-element stand-in spare. On the card its first call per buffer is
    eager and a later one captures a graph (the seed copied into the
    graph's buffer), on the CPU it is eager."""

    def __init__(self, n: int, targets: tuple, shots: int, site: int, density: bool):
        from .._capture import Program, Replay
        fn = sample_density if density else sample_statevec

        def body(shell, seed):
            return fn(shell.amps, n=n, targets=targets, shots=shots, seed=seed, site=site)

        self.program = Program([(None, [Replay(body, n, density)])])
        self._spare: dict = {}

    def close(self) -> None:
        self.program.close()
        self._spare.clear()

    def __call__(self, amps: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
        key = (amps.device, amps.dtype)
        spare = self._spare.get(key)
        if spare is None:
            spare = self._spare[key] = torch.empty(1, dtype=amps.dtype, device=amps.device)
        _, _, out = self.program.run((amps,), (spare,), None, (seed,))
        return out


def sample_jit(amps: torch.Tensor, seed, *, n: int, targets: tuple, shots: int,
               site: int = 0, density: bool = False) -> torch.Tensor:
    """The eager entry point: one compiled program per (shape, targets,
    shots, site, route), kept in the executable cache, drawing all S shots
    on the state's device; ``amps`` is only read. Returns the (S,) int32
    table on that device."""
    from ..engine import cache as _ec
    targets = tuple(int(t) for t in targets)
    key = ("sample_jit", int(n), targets, int(shots), int(site), bool(density))
    prog = _ec.executables().get_or_create(
        key, lambda: _SampleProgram(int(n), targets, int(shots), int(site), bool(density)))
    return prog(amps, seed_tensor(seed, amps.device))
