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

Over shards (a list of shard tensors, :func:`draw_outcomes_shards`) the
state and its 2^t marginal stay where they are:

- with every target local, each shard's marginal is summed with the
  others' in shard order on the first device, and the draw is the
  one-device draw of that marginal;
- with sharded targets, the marginal is one part a value of the sharded
  targets' bits, on that value's first shard (``ops.measure.
  marginal_groups``; over every qubit in order, a shard's own |amp|^2).
  The (B, L) split takes B >= D and every sharded target among the block
  bits, so each block lies in one part: the rows' CDFs are built there
  (2^CHUNK_BITS entries at a time), only the B block totals cross to the
  first device, where their CDF is scanned and each shot finds its block,
  and then its row is searched on the part's device: one ``searchsorted``
  of every shot a piece, on keys that order (row, CDF value), whose counts
  summed over the pieces are the row's offset plus the shot's count. A
  part's rows are scanned twice (once for their totals, once for the
  search), so no more than a piece of them is ever held.

In f32 a part has the one-device marginal's bits and the norm the
one-device cascade's, so where the split is the same (over every qubit in
order) a sharded table equals the one-device table; a dyadic circuit's
tables are equal for any targets.

The shot count and target set are static (the program's shape); the seed
is a runtime value: a tensor, copied into a captured graph's buffer, or a
lifted ``'seed'`` slot, so S seeds replay one captured program.
"""

from __future__ import annotations

import torch

from ..ops import measure as M, reduce as R
from . import rng

__all__ = ["marginal_probs", "draw_outcomes", "draw_outcomes_shards", "sample_statevec",
           "sample_density", "shot_key", "seed_tensor", "cdf_tables", "sample_jit"]


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


def _row_cdf(rows: torch.Tensor) -> torch.Tensor:
    """The non-decreasing fixed-order CDF along the last axis."""
    return _monotone(_add_scan(rows))


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
    row_cdf = _row_cdf(p.reshape(B, L))
    return row_cdf, _row_cdf(row_cdf[:, -1])


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


def _order_key(x: torch.Tensor) -> torch.Tensor:
    """int64 keys in [0, 2^32) of float32 values, in their order: x <= y
    exactly when key(x) <= key(y) (-0.0 taken as +0.0; no NaN)."""
    b = (x.to(torch.float32) + 0.0).view(torch.int32).to(torch.int64)
    b ^= (b >> 63) & 0x7FFFFFFF  # a negative value's magnitude bits reversed
    return b.add_(1 << 31)


def _shard_block_bits(t: int, devices: int, sharded_pos) -> int:
    """The block-count exponent over shards: the mesh term of
    :func:`_block_bits`, raised until every sharded target's outcome bit is
    a block bit (so each block lies in one part of the marginal)."""
    return max(_block_bits(t, devices), t - min(sharded_pos))


def draw_outcomes_shards(shards, u: torch.Tensor, *, n: int, targets: tuple, norm,
                         density: bool = False) -> torch.Tensor:
    """:func:`draw_outcomes` over a sharded state (see the module docstring):
    the (S,) int32 outcomes on the first shard's device, ``u`` there too;
    ``n`` is the register's qubit count. Branch-free: no host read."""
    targets = tuple(int(q) for q in targets)
    dev = shards[0].device
    sources, nl, planar = M.prob_sources(shards, n=n, density=density)
    t = len(targets)
    sharded = [k for k, q in enumerate(targets) if q >= nl]
    if not sharded:
        p = M.marginal_groups(sources, nl=nl, targets=targets, planar=planar)[0]
        return draw_outcomes(p.to(torch.float32), u, norm=norm)
    bb = _shard_block_bits(t, len(shards), sharded)
    B, L = 1 << bb, 1 << (t - bb)
    G = 1 << len(sharded)
    Bg = B // G
    if planar and targets == tuple(range(n)):
        # every qubit in order: a part is one shard's |amp|^2, never held whole
        def rows(g, r0, r1):
            return M._sq(sources[g][:, r0 * L:r1 * L]).to(torch.float32).reshape(-1, L)
    else:
        parts = [x.to(torch.float32) for x in
                 M.marginal_groups(sources, nl=nl, targets=targets, planar=planar)]

        def rows(g, r0, r1):
            return parts[g][r0 * L:r1 * L].reshape(-1, L)
    # block b -> (its part g, its row within the part): the sharded targets'
    # bits of b, and its other bits compacted
    b = torch.arange(B, device=dev)
    lo = t - bb
    grp = torch.zeros_like(b)
    for j, k in enumerate(sharded):
        grp |= ((b >> (k - lo)) & 1) << j
    idx = torch.zeros_like(b)
    for j, i in enumerate(i for i in range(bb) if i + lo not in sharded):
        idx |= ((b >> i) & 1) << j
    step = max(1, (1 << R.CHUNK_BITS) // L)
    spans = [(r0, min(r0 + step, Bg)) for r0 in range(0, Bg, step)]
    # pass 1: the block totals, the only part of the marginal that crosses
    # (each piece's last column copied out: no piece's CDF outlives its scan)
    tots = [torch.cat([_row_cdf(rows(g, r0, r1))[:, -1].clone() for r0, r1 in spans]).to(dev)
            for g in range(G)]
    block_cdf = _monotone(_add_scan(torch.cat(tots)[grp * Bg + idx]))
    total = norm.to(torch.float32) if isinstance(norm, torch.Tensor) else \
        torch.full((), float(norm), dtype=torch.float32, device=dev)
    draws = u.to(torch.float32) * total
    bs = torch.clamp(_count_le(block_cdf, draws, 0, B), max=B - 1)
    prev = torch.gather(block_cdf, 0, torch.clamp(bs - 1, min=0))
    rest = draws - torch.where(bs > 0, prev, torch.zeros_like(prev))
    del draws, prev
    # pass 2: each shot's row searched where its part lies. A shot's key is
    # (its block's row, counted part by part) << 32 | its draw's order key,
    # a piece's the same of its rows' CDF entries, so a piece's keys are
    # sorted and one searchsorted of every shot's key counts, for a shot
    # of a later row, the whole piece, for an earlier one nothing, and for
    # one of the piece's rows the rows before it and its own entries <= its
    # draw. Summed over every piece: the row times L plus that count.
    row = grp[bs] * Bg + idx[bs]
    key = (row << 32) + _order_key(rest)
    del rest
    count = None
    for g in range(G):
        acc = here = None
        for r0, r1 in spans:
            cdf = _row_cdf(rows(g, r0, r1))
            if here is None:  # the shots' keys on the part's device, once
                here = key.to(cdf.device)
            rid = torch.arange(g * Bg + r0, g * Bg + r1, dtype=torch.int64, device=cdf.device)
            keys = _order_key(cdf).add_((rid << 32).unsqueeze(1)).reshape(-1)
            del cdf, rid
            hit = torch.searchsorted(keys, here, right=True)
            del keys
            acc = hit if acc is None else acc.add_(hit)
        count = acc.to(dev) if count is None else count.add_(acc.to(dev))
    j = torch.clamp(count - row * L, max=L - 1)
    return (bs * L + j).to(torch.int32)


def _first(amps) -> torch.Tensor:
    return amps[0] if isinstance(amps, (list, tuple)) else amps


def sample_statevec(amps, *, n: int, targets: tuple, shots: int, seed,
                    site: int = 0) -> torch.Tensor:
    """S = ``shots`` outcome draws over ``targets`` of a planar state
    vector, or of a sharded one's list of shards: the (S,) int32 shot table
    (on the first shard's device). ``seed`` is an int or an integer tensor
    (a lifted seed slot); ``site`` decorrelates the sampling sites of one
    tape."""
    u = rng.uniform(shot_key(seed, site, _first(amps).device), (int(shots),))
    if isinstance(amps, (list, tuple)):
        norm = R.total_prob_shards(amps).to(torch.float32)
        return draw_outcomes_shards(list(amps), u, n=n, targets=tuple(targets), norm=norm)
    p = marginal_probs(amps, n=n, targets=tuple(targets))
    norm = R.total_prob_statevec(amps).to(torch.float32)
    return draw_outcomes(p, u, norm=norm)


def sample_density(amps, *, n: int, targets: tuple, shots: int, seed,
                   site: int = 0) -> torch.Tensor:
    """:func:`sample_statevec` of a density register (its tensor or its
    shards): the marginal from the diagonal, the normalizer Re tr(rho)."""
    u = rng.uniform(shot_key(seed, site, _first(amps).device), (int(shots),))
    if isinstance(amps, (list, tuple)):
        norm = R.total_prob_density_shards(list(amps), n=n).to(torch.float32)
        return draw_outcomes_shards(list(amps), u, n=n, targets=tuple(targets), norm=norm,
                                    density=True)
    p = marginal_probs(amps, n=n, targets=tuple(targets), density=True)
    norm = R.total_prob_density(amps, n=n).to(torch.float32)
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
            amps = shell.amps if shell.shards is None else list(shell.shards)
            return fn(amps, n=n, targets=targets, shots=shots, seed=seed, site=site)

        self.program = Program([(None, [Replay(body, n, density)])])
        self._spare: dict = {}

    def close(self) -> None:
        self.program.close()
        self._spare.clear()

    def __call__(self, amps, seed: torch.Tensor) -> torch.Tensor:
        xs = tuple(amps) if isinstance(amps, (list, tuple)) else (amps,)
        spares = []
        for x in xs:
            key = (x.device, x.dtype)
            spare = self._spare.get(key)
            if spare is None:
                spare = self._spare[key] = torch.empty(1, dtype=x.dtype, device=x.device)
            spares.append(spare)
        _, _, out = self.program.run(xs, tuple(spares), None, (seed,))
        return out


def sample_jit(amps, seed, *, n: int, targets: tuple, shots: int,
               site: int = 0, density: bool = False) -> torch.Tensor:
    """The eager entry point: one compiled program per (shape, targets,
    shots, site, route, layout), kept in the executable cache, drawing all
    S shots on the state's device (a sharded state's list of shards: on
    its shards, the table on the first one's device); ``amps`` is only
    read. Returns the (S,) int32 table."""
    from ..engine import cache as _ec
    targets = tuple(int(t) for t in targets)
    layout = len(amps) if isinstance(amps, (list, tuple)) else 1
    key = ("sample_jit", int(n), targets, int(shots), int(site), bool(density), layout)
    prog = _ec.executables().get_or_create(
        key, lambda: _SampleProgram(int(n), targets, int(shots), int(site), bool(density)))
    return prog(amps, seed_tensor(seed, _first(amps).device))
