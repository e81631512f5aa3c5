"""The reference's distributed protocol over the shards of one register
(``quest_tpu/parallel/exchange.py``; reference QuEST_cpu_distributed.c).

Each routine is a plain function over the list of shard tensors (shard r a
planar (P, 2^nl) tensor on its own device, P = 2 planes) and returns the
new list. Where the JAX package launches a collective inside ``shard_map``,
every exchange here is a device-to-device ``copy_`` between shard
tensors: a peer copy across cards (NVLink on a host with several), a
device copy between virtual shards of one card. Nothing is staged through
host memory.

  - non-local 1-qubit dense gate: pair exchange, then a shard-conditional
    blended update (``exchangeStateVectors`` :495-533, ``getRotAngle``);
  - non-local X class: a whole-shard exchange (:1109-1152);
  - diagonal and parity phases: no communication, the sharded qubits'
    bits read from the shard index;
  - relocation: the odd-parity half exchange (``statevec_swapQubitAmps``,
    :1424-1459), and any bit permutation in one pass
    (:func:`dist_permute_bits`).

Controls split into local controls (an index mask inside the shard) and
sharded controls (a shard-index predicate: a shard whose bits miss keeps
its amplitudes, and nothing travels), as the JAX package splits them.
Counters: ``exchange_calls_total{kind}`` with the JAX package's kinds
(``pair_exchange``, ``x_permute``, ``grouped_permute``,
``swap_rank_permute``, ``swap_odd_parity``). The JAX package's comm
``pipeline`` depth is later work.
"""

from __future__ import annotations

import torch

from .. import telemetry
from ..ops import apply as K
from ..ops import diagonal as D
from .mesh import local_qubit_count

__all__ = ["dist_apply_matrix1", "dist_apply_x", "dist_apply_diag_phase",
           "dist_apply_parity_phase", "dist_apply_local_matrix", "dist_swap",
           "dist_permute_bits", "permute_collective_stats"]


def _fetch(src: torch.Tensor, device) -> torch.Tensor:
    """A copy of shard ``src`` on ``device``: the exchange primitive."""
    dst = torch.empty(src.shape, dtype=src.dtype, device=device)
    dst.copy_(src)
    return dst


def _rank_bit(r: int, q: int, nl: int) -> int:
    return (r >> (q - nl)) & 1


def _ctrl_pred(r: int, shard_controls, shard_states, nl: int) -> bool:
    """Shard-index predicate for sharded controls (no communication)."""
    return all(_rank_bit(r, c, nl) == s for c, s in zip(shard_controls, shard_states))


def _apply_local_ctrl_mask(own, new, local_controls, local_states):
    """``new`` where every local control holds its state, else ``own``."""
    if not local_controls:
        return new
    j = torch.arange(own.shape[1], device=own.device)
    ok = torch.ones(own.shape[1], dtype=torch.bool, device=own.device)
    for c, s in zip(local_controls, local_states):
        ok &= ((j >> c) & 1) == s
    return torch.where(ok, new, own)


def _split_controls(controls, states, nl):
    states = tuple(states) if states else (1,) * len(controls)
    lc = [(c, s) for c, s in zip(controls, states) if c < nl]
    sc = [(c, s) for c, s in zip(controls, states) if c >= nl]
    return ([c for c, _ in lc], [s for _, s in lc],
            [c for c, _ in sc], [s for _, s in sc])


# ---------------------------------------------------------------------------
# 1-qubit dense gate (compactUnitary / unitary class)
# ---------------------------------------------------------------------------

def dist_apply_matrix1(shards, matrix, *, n: int, target: int,
                       controls: tuple = (), control_states: tuple = (),
                       conj: bool = False) -> list:
    """U (planar (2, 2, 2)) on ``target``. A sharded target: each shard
    fetches its pair shard (shard index XOR the target's bit) and blends,
    new(bit b) = m[b, b] own + m[b, 1-b] pair, the reference's traffic. A
    local target: the per-shard engine, no communication."""
    nl = local_qubit_count(n, shards)
    if target >= nl:
        telemetry.inc("exchange_calls_total", kind="pair_exchange")
    lc, ls, sc, ss = _split_controls(controls, control_states, nl)
    out = []
    for r, own in enumerate(shards):
        if not _ctrl_pred(r, sc, ss, nl):
            out.append(own)
            continue
        m = matrix.to(own.device)
        if target < nl:
            out.append(K.apply_matrix(own, m, n=nl, targets=(target,),
                                      controls=tuple(lc), control_states=tuple(ls),
                                      conj=conj))
            continue
        mr, mi = m[0], -m[1] if conj else m[1]
        b = _rank_bit(r, target, nl)
        pair = _fetch(shards[r ^ (1 << (target - nl))], own.device)
        re = (mr[b, b] * own[0] - mi[b, b] * own[1]
              + mr[b, 1 - b] * pair[0] - mi[b, 1 - b] * pair[1])
        im = (mr[b, b] * own[1] + mi[b, b] * own[0]
              + mr[b, 1 - b] * pair[1] + mi[b, 1 - b] * pair[0])
        out.append(_apply_local_ctrl_mask(own, torch.stack([re, im]), lc, ls))
    return out


def dist_apply_local_matrix(shards, matrix, *, n: int, targets: tuple,
                            controls: tuple = (), control_states: tuple = (),
                            conj: bool = False) -> list:
    """A dense gate whose targets are all local: the per-shard engine (the
    reference's *Local fast path, QuEST_cpu_distributed.c:372-377), sharded
    controls a shard-index predicate."""
    nl = local_qubit_count(n, shards)
    if any(t >= nl for t in targets):
        raise ValueError(f"targets {targets} are not all below the {nl} local qubits")
    lc, ls, sc, ss = _split_controls(controls, control_states, nl)
    return [K.apply_matrix(own, matrix.to(own.device), n=nl, targets=tuple(targets),
                           controls=tuple(lc), control_states=tuple(ls), conj=conj)
            if _ctrl_pred(r, sc, ss, nl) else own
            for r, own in enumerate(shards)]


# ---------------------------------------------------------------------------
# X class (amplitude permutation)
# ---------------------------------------------------------------------------

def dist_apply_x(shards, *, n: int, targets: tuple, controls: tuple = (),
                 control_states: tuple = ()) -> list:
    """Multi-controlled multi-target NOT: the sharded target bits are one
    whole-shard exchange (shard r takes shard r XOR their mask), the local
    ones a flip inside the shard (reference :1109-1152)."""
    nl = local_qubit_count(n, shards)
    lc, ls, sc, ss = _split_controls(controls, control_states, nl)
    local_t = tuple(t for t in targets if t < nl)
    mask = sum(1 << (t - nl) for t in targets if t >= nl)
    if mask:
        telemetry.inc("exchange_calls_total", kind="x_permute")
    out = []
    for r, own in enumerate(shards):
        if not _ctrl_pred(r, sc, ss, nl):
            out.append(own)
            continue
        new = _fetch(shards[r ^ mask], own.device) if mask else own
        if local_t:
            new = K.apply_x_class(new, n=nl, targets=local_t)
        out.append(_apply_local_ctrl_mask(own, new, lc, ls))
    return out


# ---------------------------------------------------------------------------
# whole-layout bit permutation
# ---------------------------------------------------------------------------

def _permute_decompose(n: int, source, nl: int):
    """Split the bit permutation ``new_bit[q] = old_bit[source[q]]`` into
    the JAX package's three machine moves: a shard-index relabel (sharded
    to sharded bits), a grouped all-to-all (the local<->sharded crossings)
    and a local transpose. Returns (rho_src, Q_c, L_in, L_out, dest):
    ``rho_src`` maps a sharded position to the old sharded position it
    takes its bit from (None when no relabel is needed), ``Q_c`` lists the
    sharded positions fed from local bits, ``L_in[k]``/``L_out[k]`` the
    outgoing/incoming local bit of crossing k, ``dest`` the inverse."""
    source = tuple(source)
    if sorted(source) != list(range(n)):
        raise ValueError(f"{source} is not a permutation of {n} bits")
    dest = [0] * n
    for q, p in enumerate(source):
        dest[p] = q
    shard = range(nl, n)
    Q_c = [q for q in shard if source[q] < nl]
    P_out = [p for p in shard if dest[p] < nl]
    rho_src = None
    holds = {q: q for q in shard}
    if any(source[q] >= nl and source[q] != q for q in shard):
        rho_src = {q: source[q] for q in shard if source[q] >= nl}
        for q, p in zip(sorted(Q_c), sorted(P_out)):
            rho_src[q] = p
        holds = dict(rho_src)
    L_in = [source[q] for q in sorted(Q_c)]
    L_out = [dest[holds[q]] for q in sorted(Q_c)]
    return rho_src, sorted(Q_c), L_in, L_out, dest


def permute_collective_stats(n: int, source, mesh) -> dict:
    """The cost model of :func:`dist_permute_bits`, as the JAX package's:
    its collectives and chunk units ((send + recv) per half shard). A
    relabel re-routes whole shards (2 units); m crossing bits move
    (2^m - 1)/2^m of each shard each way (2 (1 - 2^-m) units)."""
    nl = local_qubit_count(n, mesh)
    rho_src, Q_c, _, _, _ = _permute_decompose(n, source, nl)
    m = len(Q_c)
    units = (2.0 if rho_src is not None else 0.0)
    units += 2.0 * (1.0 - 0.5 ** m) if m else 0.0
    return {"relabel_ppermute": rho_src is not None, "crossing_bits": m,
            "chunk_units": units,
            "collectives": int(rho_src is not None) + int(m > 0)}


def _runs(source, n: int, nl: int) -> list:
    """The permutation as maximal runs (new_lo, old_lo, length) of new bit
    positions whose source bits are consecutive, cut at the shard boundary
    on both sides: each run is one axis of the copies below."""
    runs, q = [], 0
    while q < n:
        L = 1
        while (q + L < n and source[q + L] == source[q] + L
               and q + L != nl and source[q] + L != nl):
            L += 1
        runs.append((q, source[q], L))
        q += L
    return runs


def _field(x: int, lo: int, L: int) -> int:
    return (x >> lo) & ((1 << L) - 1)


def _permute(shards, n: int, source, out=None) -> list:
    """new_bit[q] = old_bit[source[q]] over the shards, in one pass: the
    JAX package's relabel, grouped all-to-all and local transpose composed
    into one strided copy per (source shard, destination shard) piece. A
    destination takes a piece from each source whose sharded bits agree
    with it (2^m sources for m crossing bits), every piece a ``copy_``
    from the source's device into the destination shard. ``out`` (new
    tensors when None) must not alias ``shards``."""
    nl = local_qubit_count(n, shards)
    runs = _runs(tuple(source), n, nl)
    ll = [r for r in runs if r[0] < nl and r[1] < nl]
    old_axes = sorted((r for r in runs if r[1] < nl), key=lambda r: -r[1])
    new_axes = sorted((r for r in runs if r[0] < nl), key=lambda r: -r[0])
    ll_old = [r for r in old_axes if r in ll]
    ll_new = [r for r in new_axes if r in ll]
    perm = [0] + [1 + ll_old.index(r) for r in ll_new]
    if out is None:
        out = [torch.empty_like(s) for s in shards]
    for rd, dst in enumerate(out):
        dview = dst.view((dst.shape[0],) + tuple(1 << r[2] for r in new_axes))
        for rs, src in enumerate(shards):
            if any(_field(rs, o - nl, L) != _field(rd, q - nl, L)
                   for q, o, L in runs if q >= nl and o >= nl):
                continue
            sview = src.view((src.shape[0],) + tuple(1 << r[2] for r in old_axes))
            # crossing runs: a local bit of the source that lands in the
            # destination's shard index, and back
            sidx = tuple(_field(rd, r[0] - nl, r[2]) if r[0] >= nl else slice(None)
                         for r in old_axes)
            didx = tuple(_field(rs, r[1] - nl, r[2]) if r[1] >= nl else slice(None)
                         for r in new_axes)
            piece = sview[(slice(None),) + sidx].permute(perm)
            dview[(slice(None),) + didx].copy_(piece)
    return out


def dist_permute_bits(shards, *, n: int, source, out=None) -> list:
    """Apply an arbitrary bit permutation of the index,
    ``new_bit[q] = old_bit[source[q]]``, in one pass over the shards (see
    :func:`_permute`): the reconciliation primitive of the JAX package,
    here also every frame transpose that reaches a sharded qubit."""
    source = tuple(source)
    if all(source[q] == q for q in range(n)):
        return list(shards)
    telemetry.inc("exchange_calls_total", kind="grouped_permute")
    return _permute(shards, n, source, out)


# ---------------------------------------------------------------------------
# diagonal and parity phases (no communication)
# ---------------------------------------------------------------------------

def dist_apply_diag_phase(shards, diag, *, n: int, targets: tuple,
                          controls: tuple = (), control_states: tuple = (),
                          conj: bool = False) -> list:
    """diag (planar (2, 2^t)) on ``targets``, entry bit k = targets[k]'s
    bit. A sharded target's bit is a constant of the shard, so each shard
    applies the slice of the diagonal its index selects: no traffic
    (QuEST_cpu.c:3235-3285)."""
    nl = local_qubit_count(n, shards)
    lc, ls, sc, ss = _split_controls(controls, control_states, nl)
    local = [(k, t) for k, t in enumerate(targets) if t < nl]
    out = []
    for r, own in enumerate(shards):
        if not _ctrl_pred(r, sc, ss, nl):
            out.append(own)
            continue
        off = sum(_rank_bit(r, t, nl) << k for k, t in enumerate(targets) if t >= nl)
        # the entry index, built where the diagonal lives (no host copy)
        j = torch.arange(1 << len(local), device=diag.device)
        sel = torch.full_like(j, off)
        for b, (k, _) in enumerate(local):
            sel |= ((j >> b) & 1) << k
        sub = diag[:, sel].to(own.device)
        new = D.apply_diagonal(own, sub, n=nl, targets=tuple(t for _, t in local),
                               conj=conj)
        out.append(_apply_local_ctrl_mask(own, new, lc, ls))
    return out


def dist_apply_parity_phase(shards, theta: float, *, n: int, qubits: tuple,
                            controls: tuple = (), control_states: tuple = (),
                            conj: bool = False) -> list:
    """exp(-i theta/2 Z x...x Z): no communication; the sharded qubits'
    parity is a constant of the shard, and an odd one is the same phase at
    -theta (the reference's mask-parity kernel, QuEST_cpu.c:3235-3285)."""
    nl = local_qubit_count(n, shards)
    lc, ls, sc, ss = _split_controls(controls, control_states, nl)
    local_q = tuple(q for q in qubits if q < nl)
    if not isinstance(theta, torch.Tensor):  # a tensor is a runtime value
        theta = float(theta)
    theta = -theta if conj else theta
    out = []
    for r, own in enumerate(shards):
        if not _ctrl_pred(r, sc, ss, nl):
            out.append(own)
            continue
        par = sum(_rank_bit(r, q, nl) for q in qubits if q >= nl) & 1
        new = D.apply_parity_phase(own, -theta if par else theta, n=nl,
                                   qubits=local_q)
        out.append(_apply_local_ctrl_mask(own, new, lc, ls))
    return out


# ---------------------------------------------------------------------------
# qubit-amplitude swap (the relocation primitive)
# ---------------------------------------------------------------------------

def dist_swap(shards, *, n: int, qb1: int, qb2: int) -> list:
    """SWAP(qb1, qb2) in the reference's three regimes (:1424-1459): both
    local, a swap inside each shard; both sharded, whole shards exchanged
    (``swap_rank_permute``); mixed, each shard sends the half whose local
    bit differs from its shard bit and keeps the other (``swap_odd_parity``,
    half the traffic of a full exchange)."""
    nl = local_qubit_count(n, shards)
    lo, hi = min(qb1, qb2), max(qb1, qb2)
    if hi < nl:
        return [K.apply_swap(s, n=nl, qb1=lo, qb2=hi) for s in shards]
    telemetry.inc("exchange_calls_total",
                  kind="swap_rank_permute" if lo >= nl else "swap_odd_parity")
    source = list(range(n))
    source[lo], source[hi] = hi, lo
    return _permute(shards, n, source)
