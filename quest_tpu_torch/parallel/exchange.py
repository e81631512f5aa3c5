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
``swap_rank_permute``, ``swap_odd_parity``).

**The comm pipeline.** Every routine takes a ``pipeline`` depth: the
explicit argument, else ``QUEST_COMM_PIPELINE`` (:func:`resolve_pipeline`),
clamped to what the site can slice (:func:`effective_comm_pipeline`). At
depth d > 1 a routine moves each shard in d column slices in
:func:`_pipeline_schedule`'s order: the transfer of slice k+1 is issued
before slice k's blend, and on a card the transfers run on a side stream,
each awaited through an event by the blend that reads it. Every slice's
arithmetic is the monolithic launch's on the same amplitudes, so every
depth is bit-identical to depth 1, and the chunk-unit prices
(:func:`permute_collective_stats`) do not depend on it. A bit permutation
has no blend to overlap: its copies are issued slice by slice. Each launch
sets the gauge ``comm_pipeline_depth`` and, when telemetry is on and the
launch is eager (not inside a graph capture, not on meta tensors) and
inside an ``explicit_mesh`` context, times itself into the histogram
``comm_collective_ms{kind,pipeline}`` without waiting for the card
(:func:`_launch`).
"""

from __future__ import annotations

import os
import time

import torch

from .. import telemetry
from ..ops import apply as K
from ..ops import diagonal as D
from .mesh import local_qubit_count

__all__ = ["dist_apply_matrix1", "dist_apply_x", "dist_apply_diag_phase",
           "dist_apply_parity_phase", "dist_apply_local_matrix", "dist_swap",
           "dist_permute_bits", "permute_collective_stats",
           "comm_pipeline_default", "comm_pipeline_dcn_default",
           "resolve_pipeline", "resolve_pipeline_dcn",
           "effective_comm_pipeline"]


# ---------------------------------------------------------------------------
# pipeline depth
# ---------------------------------------------------------------------------

#: the env knob of the default depth (1 = one monolithic launch); a plan's
#: ``Circuit.fused(comm_pipeline=)`` and ``explicit_mesh(comm_pipeline=)``
#: outrank it
_PIPE_ENV = "QUEST_COMM_PIPELINE"
_DEF_COMM_PIPELINE = 1
_PIPE_ENV_WARNED: set = set()

#: the per-link-class override: collectives on a DCN shard bit run at this
#: depth; unset, they inherit the base depth
_PIPE_DCN_ENV = "QUEST_COMM_PIPELINE_DCN"
_PIPE_DCN_ENV_WARNED: set = set()


def comm_pipeline_default() -> int:
    """The env-resolved comm-pipeline depth (warn-once QT206 on a malformed
    ``QUEST_COMM_PIPELINE``)."""
    from ..resilience.findings import env_int
    return env_int(_PIPE_ENV, _DEF_COMM_PIPELINE, minimum=1, code="QT206",
                   warned=_PIPE_ENV_WARNED, noun="pipeline depth")


def resolve_pipeline(pipeline) -> int:
    """The explicit ``pipeline`` argument if given, else the env default."""
    return int(pipeline) if pipeline is not None else comm_pipeline_default()


def comm_pipeline_dcn_default():
    """The env-resolved DCN depth, or None when ``QUEST_COMM_PIPELINE_DCN``
    is unset (inherit the base depth); a malformed value warns once
    (QT210)."""
    from ..resilience.findings import env_int
    if not os.environ.get(_PIPE_DCN_ENV, "").strip():
        return None
    return env_int(_PIPE_DCN_ENV, 1, minimum=1, code="QT210", warned=_PIPE_DCN_ENV_WARNED,
                   noun="DCN pipeline depth")


def resolve_pipeline_dcn(pipeline_dcn, pipeline=None) -> int:
    """Depth of a DCN-riding collective: the explicit ``pipeline_dcn``, else
    ``QUEST_COMM_PIPELINE_DCN``, else the base resolution of ``pipeline``."""
    if pipeline_dcn is not None:
        return int(pipeline_dcn)
    env = comm_pipeline_dcn_default()
    if env is not None:
        return env
    return resolve_pipeline(pipeline)


def effective_comm_pipeline(depth: int, limit: int, *, site: str = "exchange") -> int:
    """The one clamp from a requested depth to what a launch site can slice:
    the largest power of two neither above the request nor above ``limit``
    (the site's slice count ceiling). ``site`` only labels the caller."""
    del site
    depth = max(1, int(depth))
    depth = 1 << (depth.bit_length() - 1)
    limit = max(1, int(limit))
    limit = 1 << (limit.bit_length() - 1)
    return min(depth, limit)


def _pipeline_schedule(nslices, transfer, compute, src=None):
    """The software-pipelined transfer/compute order over ``nslices``
    slices; returns the outputs of ``compute`` in slice order.
    ``transfer(j)`` issues slice j's transfer; ``compute(k, landed)``
    consumes the transfer that output slice k needs, ``src(k)`` (identity
    unless the collective permutes the slice index). Prologue: slice 0's
    transfer; steady state: transfer k+1 before compute k; epilogue: the
    last compute. Every transfer is issued once and consumed once."""
    if src is None:
        src = lambda k: k  # noqa: E731
    inflight = {}

    def ensure(j):
        if j not in inflight:
            inflight[j] = transfer(j)

    ensure(src(0))
    outs = []
    for k in range(nslices):
        if k + 1 < nslices:
            ensure(src(k + 1))
        outs.append(compute(k, inflight.pop(src(k))))
    assert not inflight
    return outs


# ---------------------------------------------------------------------------
# transfers and launch bookkeeping
# ---------------------------------------------------------------------------

_SIDE: dict = {}


def _capturing(device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _side_stream(device):
    """The side stream of a card for pipelined transfers; None elsewhere
    and inside a graph capture (the slices then go in order on the
    caller's stream)."""
    if device.type != "cuda" or _capturing(device):
        return None
    s = _SIDE.get(device.index)
    if s is None:
        s = _SIDE[device.index] = torch.cuda.Stream(device=device)
    return s


def _fetch(src: torch.Tensor, device) -> torch.Tensor:
    """A copy of shard ``src`` on ``device``: the exchange primitive."""
    dst = torch.empty(src.shape, dtype=src.dtype, device=device)
    dst.copy_(src)
    return dst


class _Landed:
    """A transfer issued on a side stream: ``get()`` makes the caller's
    stream wait for it and returns the copy."""

    __slots__ = ("t", "ev")

    def __init__(self, t, ev):
        self.t, self.ev = t, ev

    def get(self):
        if self.ev is not None:
            torch.cuda.current_stream(self.t.device).wait_event(self.ev)
        return self.t


def _issue(src: torch.Tensor, device, stream) -> _Landed:
    """Copy ``src`` to ``device``: on ``stream`` (after the work queued on
    both cards' current streams), or in order when ``stream`` is None."""
    if stream is None:
        return _Landed(_fetch(src, device), None)
    dst = torch.empty(src.shape, dtype=src.dtype, device=device)
    stream.wait_stream(torch.cuda.current_stream(device))
    if src.device != device and src.device.type == "cuda":
        stream.wait_stream(torch.cuda.current_stream(src.device))
    with torch.cuda.stream(stream):
        dst.copy_(src, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(stream)
    return _Landed(dst, ev)


def _launch(kind: str, eff: int, shards, run, out=None):
    """Run one launch ``run()``: set the ``comm_pipeline_depth`` gauge and,
    when telemetry is on and the launch is eager and inside an
    ``explicit_mesh`` context, time it into
    ``comm_collective_ms{kind,pipeline}``: on a card by two CUDA events on
    the first shard's stream, read later (``telemetry.observe_later``, so
    the launch never waits for the card), on the CPU by the wall clock.
    The default sharded route is not timed. Meta shards (the planner's,
    ``scheduler.plan_circuit``) have no values to compute: the launch
    returns them (or ``out``) as they are."""
    from .scheduler import active

    telemetry.set_gauge("comm_pipeline_depth", int(eff))
    dev = shards[0].device
    if dev.type == "meta":
        return list(shards) if out is None else list(out)
    if not telemetry.enabled() or active() is None or _capturing(dev):
        return run()
    labels = dict(kind=kind, pipeline=int(eff))
    if dev.type == "cuda":
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record(torch.cuda.current_stream(dev))
        res = run()
        e1.record(torch.cuda.current_stream(dev))
        telemetry.observe_later("comm_collective_ms",
                                lambda: (e1.synchronize(), e0.elapsed_time(e1))[1],
                                ready=e1.query, **labels)
        return res
    t0 = time.perf_counter()
    res = run()
    telemetry.observe("comm_collective_ms", (time.perf_counter() - t0) * 1e3, **labels)
    return res


def _rank_bit(r: int, q: int, nl: int) -> int:
    return (r >> (q - nl)) & 1


def _ctrl_pred(r: int, shard_controls, shard_states, nl: int) -> bool:
    """Shard-index predicate for sharded controls (no communication)."""
    return all(_rank_bit(r, c, nl) == s for c, s in zip(shard_controls, shard_states))


def _apply_local_ctrl_mask(own, new, local_controls, local_states, offset: int = 0):
    """``new`` where every local control holds its state, else ``own``;
    ``offset`` is the in-shard index of column 0 (a pipelined slice tests
    its controls on the shard's index)."""
    if not local_controls:
        return new
    j = torch.arange(offset, offset + own.shape[1], device=own.device)
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

def _columns(t: torch.Tensor, k: int, s: int) -> torch.Tensor:
    return t[:, k * s:(k + 1) * s]


def dist_apply_matrix1(shards, matrix, *, n: int, target: int,
                       controls: tuple = (), control_states: tuple = (),
                       conj: bool = False, pipeline=None) -> list:
    """U (planar (2, 2, 2)) on ``target``. A sharded target: each shard
    fetches its pair shard (shard index XOR the target's bit) and blends,
    new(bit b) = m[b, b] own + m[b, 1-b] pair, the reference's traffic; at
    depth d > 1 in d column slices, the pair's slice k+1 in flight while
    slice k blends. A local target: the per-shard engine, no
    communication."""
    nl = local_qubit_count(n, shards)
    eff, kind = 1, "local_matrix"
    if target >= nl:
        telemetry.inc("exchange_calls_total", kind="pair_exchange")
        eff = effective_comm_pipeline(resolve_pipeline(pipeline), 1 << nl,
                                      site="pair_exchange")
        kind = "pair_exchange"
    lc, ls, sc, ss = _split_controls(controls, control_states, nl)

    def run():
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
            pair = shards[r ^ (1 << (target - nl))]

            def blend(own_s, pair_s, off):
                re = (mr[b, b] * own_s[0] - mi[b, b] * own_s[1]
                      + mr[b, 1 - b] * pair_s[0] - mi[b, 1 - b] * pair_s[1])
                im = (mr[b, b] * own_s[1] + mi[b, b] * own_s[0]
                      + mr[b, 1 - b] * pair_s[1] + mi[b, 1 - b] * pair_s[0])
                return _apply_local_ctrl_mask(own_s, torch.stack([re, im]), lc, ls, off)

            if eff == 1:
                out.append(blend(own, _fetch(pair, own.device), 0))
                continue
            s, side = own.shape[1] // eff, _side_stream(own.device)
            out.append(torch.cat(_pipeline_schedule(
                eff, lambda j: _issue(_columns(pair, j, s), own.device, side),
                lambda k, got: blend(_columns(own, k, s), got.get(), k * s)), dim=1))
        return out

    return _launch(kind, eff, shards, run)


def dist_apply_local_matrix(shards, matrix, *, n: int, targets: tuple,
                            controls: tuple = (), control_states: tuple = (),
                            conj: bool = False, pipeline=None) -> list:
    """A dense gate whose targets are all local: the per-shard engine (the
    reference's *Local fast path, QuEST_cpu_distributed.c:372-377), sharded
    controls a shard-index predicate. ``pipeline`` is accepted as at every
    site; there is no transfer, so the launch is monolithic."""
    del pipeline
    nl = local_qubit_count(n, shards)
    if any(t >= nl for t in targets):
        raise ValueError(f"targets {targets} are not all below the {nl} local qubits")
    lc, ls, sc, ss = _split_controls(controls, control_states, nl)
    return _launch("local_matrix", 1, shards, lambda: [
        K.apply_matrix(own, matrix.to(own.device), n=nl, targets=tuple(targets),
                       controls=tuple(lc), control_states=tuple(ls), conj=conj)
        if _ctrl_pred(r, sc, ss, nl) else own
        for r, own in enumerate(shards)])


# ---------------------------------------------------------------------------
# X class (amplitude permutation)
# ---------------------------------------------------------------------------

def dist_apply_x(shards, *, n: int, targets: tuple, controls: tuple = (),
                 control_states: tuple = (), pipeline=None) -> list:
    """Multi-controlled multi-target NOT: the sharded target bits are one
    whole-shard exchange (shard r takes shard r XOR their mask), the local
    ones a flip inside the shard (reference :1109-1152). At depth d > 1 the
    exchange moves d column slices; a local target at or above the slice
    width selects which slice feeds output slice k (an XOR of k), one
    below it flips inside the slice, as the JAX package slices it."""
    nl = local_qubit_count(n, shards)
    lc, ls, sc, ss = _split_controls(controls, control_states, nl)
    local_t = tuple(t for t in targets if t < nl)
    mask = sum(1 << (t - nl) for t in targets if t >= nl)
    eff = 1
    if mask:
        telemetry.inc("exchange_calls_total", kind="x_permute")
        eff = effective_comm_pipeline(resolve_pipeline(pipeline), 1 << nl,
                                      site="x_permute")

    def run():
        out = []
        for r, own in enumerate(shards):
            if not _ctrl_pred(r, sc, ss, nl):
                out.append(own)
                continue
            if eff == 1:
                new = _fetch(shards[r ^ mask], own.device) if mask else own
                if local_t:
                    new = K.apply_x_class(new, n=nl, targets=local_t)
                out.append(_apply_local_ctrl_mask(own, new, lc, ls))
                continue
            peer, s = shards[r ^ mask], own.shape[1] // eff
            s_bits = s.bit_length() - 1
            lo_t = tuple(t for t in local_t if t < s_bits)
            hi_mask = sum(1 << (t - s_bits) for t in local_t if t >= s_bits)
            side = _side_stream(own.device)

            def compute(k, got):
                new_s = got.get()
                if lo_t:
                    new_s = K.apply_x_class(new_s, n=s_bits, targets=lo_t)
                return _apply_local_ctrl_mask(_columns(own, k, s), new_s, lc, ls, k * s)

            out.append(torch.cat(_pipeline_schedule(
                eff, lambda j: _issue(_columns(peer, j, s), own.device, side), compute,
                src=lambda k: k ^ hi_mask), dim=1))
        return out

    return _launch("x_permute" if mask else "local_x", eff, shards, run)


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


def permute_collective_stats(n: int, source, mesh, unit_scale: float = 1.0) -> dict:
    """The cost model of :func:`dist_permute_bits`, as the JAX package's:
    its collectives and chunk units ((send + recv) per half shard). A
    relabel re-routes whole shards (2 units); m crossing bits move
    (2^m - 1)/2^m of each shard each way (2 (1 - 2^-m) units).
    ``unit_scale`` restates the units for a wider state (2 for f64)."""
    nl = local_qubit_count(n, mesh)
    rho_src, Q_c, _, _, _ = _permute_decompose(n, source, nl)
    m = len(Q_c)
    units = (2.0 if rho_src is not None else 0.0)
    units += 2.0 * (1.0 - 0.5 ** m) if m else 0.0
    return {"relabel_ppermute": rho_src is not None, "crossing_bits": m,
            "chunk_units": units * unit_scale,
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


def _slice_index(bits: list, depth_bits: int, k: int) -> tuple:
    """Slice k of 2^depth_bits over axes of ``bits`` bits each (the top
    axis first): the index that fixes the top ``depth_bits`` bits of the
    axes' joint index to k's."""
    idx, left = [], depth_bits
    for L in bits:
        if left <= 0:
            idx.append(slice(None))
        elif left >= L:
            left -= L
            idx.append((k >> left) & ((1 << L) - 1))
        else:
            w = 1 << (L - left)
            d = k & ((1 << left) - 1)
            idx.append(slice(d * w, (d + 1) * w))
            left = 0
    return tuple(idx)


def _permute_limit(n: int, source, nl: int) -> int:
    """How many slices a permute can be cut into: the bits that stay local
    (2^(nl - m) for m crossing bits, the JAX package's limit)."""
    return 1 << sum(r[2] for r in _runs(tuple(source), n, nl) if r[0] < nl and r[1] < nl)


def _permute(shards, n: int, source, out=None, eff: int = 1) -> list:
    """new_bit[q] = old_bit[source[q]] over the shards, in one pass: the
    JAX package's relabel, grouped all-to-all and local transpose composed
    into one strided copy per (source shard, destination shard) piece. A
    destination takes a piece from each source whose sharded bits agree
    with it (2^m sources for m crossing bits), every piece a ``copy_``
    from the source's device into the destination shard. At ``eff`` > 1
    every piece is copied in ``eff`` slices of the bits that stay local,
    slice k of every piece before slice k+1. ``out`` (new tensors when
    None) must not alias ``shards``."""
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
    pieces = []
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
            pieces.append((dview[(slice(None),) + didx],
                           sview[(slice(None),) + sidx].permute(perm)))
    if eff == 1:
        for d, p in pieces:
            d.copy_(p)
        return out
    bits, depth_bits = [r[2] for r in ll_new], eff.bit_length() - 1
    for k in range(eff):
        idx = (slice(None),) + _slice_index(bits, depth_bits, k)
        for d, p in pieces:
            d[idx].copy_(p[idx])
    return out


def dist_permute_bits(shards, *, n: int, source, out=None, pipeline=None) -> list:
    """Apply an arbitrary bit permutation of the index,
    ``new_bit[q] = old_bit[source[q]]``, in one pass over the shards (see
    :func:`_permute`): the reconciliation primitive of the JAX package,
    here also every frame transpose that reaches a sharded qubit. Planes
    ride along, whatever their count."""
    source = tuple(source)
    if all(source[q] == q for q in range(n)):
        return list(shards)
    telemetry.inc("exchange_calls_total", kind="grouped_permute")
    nl = local_qubit_count(n, shards)
    m = sum(1 for q in range(nl, n) if source[q] < nl)
    eff = (effective_comm_pipeline(resolve_pipeline(pipeline), _permute_limit(n, source, nl),
                                   site="grouped_permute") if m else 1)
    return _launch("grouped_permute", eff, shards,
                   lambda: _permute(shards, n, source, out, eff), out)


# ---------------------------------------------------------------------------
# diagonal and parity phases (no communication)
# ---------------------------------------------------------------------------

def _phase_slices(eff: int, own, phase) -> torch.Tensor:
    """``phase(own_s, off)`` over ``own`` whole or in ``eff`` column slices."""
    if eff == 1:
        return phase(own, 0)
    s = own.shape[1] // eff
    return torch.cat([phase(_columns(own, k, s), k * s) for k in range(eff)], dim=1)


def dist_apply_diag_phase(shards, diag, *, n: int, targets: tuple,
                          controls: tuple = (), control_states: tuple = (),
                          conj: bool = False, pipeline=None) -> list:
    """diag (planar (2, 2^t)) on ``targets``, entry bit k = targets[k]'s
    bit. A sharded target's bit is a constant of the shard, so each shard
    applies the slice of the diagonal its index selects: no traffic
    (QuEST_cpu.c:3235-3285). At depth d > 1 the phase runs in d column
    slices, a target at or above the slice width a constant of the
    slice."""
    nl = local_qubit_count(n, shards)
    lc, ls, sc, ss = _split_controls(controls, control_states, nl)
    eff = effective_comm_pipeline(resolve_pipeline(pipeline), 1 << nl, site="diag_phase")

    def run():
        out = []
        for r, own in enumerate(shards):
            if not _ctrl_pred(r, sc, ss, nl):
                out.append(own)
                continue

            def phase(own_s, off, r=r):
                w = own_s.shape[1].bit_length() - 1
                const = sum((_rank_bit(r, t, nl) if t >= nl else (off >> t) & 1) << k
                            for k, t in enumerate(targets) if t >= w)
                local = [(k, t) for k, t in enumerate(targets) if t < w]
                # the entry index, built where the diagonal lives (no host copy)
                j = torch.arange(1 << len(local), device=diag.device)
                sel = torch.full_like(j, const)
                for b, (k, _) in enumerate(local):
                    sel |= ((j >> b) & 1) << k
                sub = diag[:, sel].to(own_s.device)
                new = D.apply_diagonal(own_s, sub, n=w, targets=tuple(t for _, t in local),
                                       conj=conj)
                return _apply_local_ctrl_mask(own_s, new, lc, ls, off)

            out.append(_phase_slices(eff, own, phase))
        return out

    return _launch("diag_phase", eff, shards, run)


def dist_apply_parity_phase(shards, theta: float, *, n: int, qubits: tuple,
                            controls: tuple = (), control_states: tuple = (),
                            conj: bool = False, pipeline=None) -> list:
    """exp(-i theta/2 Z x...x Z): no communication; the sharded qubits'
    parity is a constant of the shard, and an odd one is the same phase at
    -theta (the reference's mask-parity kernel, QuEST_cpu.c:3235-3285). At
    depth d > 1 in d column slices, as :func:`dist_apply_diag_phase`."""
    nl = local_qubit_count(n, shards)
    lc, ls, sc, ss = _split_controls(controls, control_states, nl)
    eff = effective_comm_pipeline(resolve_pipeline(pipeline), 1 << nl, site="parity_phase")
    if not isinstance(theta, torch.Tensor):  # a tensor is a runtime value
        theta = float(theta)
    theta = -theta if conj else theta

    def run():
        out = []
        for r, own in enumerate(shards):
            if not _ctrl_pred(r, sc, ss, nl):
                out.append(own)
                continue

            def phase(own_s, off, r=r):
                w = own_s.shape[1].bit_length() - 1
                par = sum(_rank_bit(r, q, nl) if q >= nl else (off >> q) & 1
                          for q in qubits if q >= w) & 1
                new = D.apply_parity_phase(own_s, -theta if par else theta, n=w,
                                           qubits=tuple(q for q in qubits if q < w))
                return _apply_local_ctrl_mask(own_s, new, lc, ls, off)

            out.append(_phase_slices(eff, own, phase))
        return out

    return _launch("parity_phase", eff, shards, run)


# ---------------------------------------------------------------------------
# qubit-amplitude swap (the relocation primitive)
# ---------------------------------------------------------------------------

def dist_swap(shards, *, n: int, qb1: int, qb2: int, pipeline=None) -> list:
    """SWAP(qb1, qb2) in the reference's three regimes (:1424-1459): both
    local, a swap inside each shard; both sharded, whole shards exchanged
    (``swap_rank_permute``); mixed, each shard sends the half whose local
    bit differs from its shard bit and keeps the other (``swap_odd_parity``,
    half the traffic of a full exchange). The sharded regimes are
    :func:`_permute`, sliced at depth d > 1."""
    nl = local_qubit_count(n, shards)
    lo, hi = min(qb1, qb2), max(qb1, qb2)
    if hi < nl:
        return _launch("swap_local", 1, shards,
                       lambda: [K.apply_swap(s, n=nl, qb1=lo, qb2=hi) for s in shards])
    kind = "swap_rank_permute" if lo >= nl else "swap_odd_parity"
    telemetry.inc("exchange_calls_total", kind=kind)
    source = list(range(n))
    source[lo], source[hi] = hi, lo
    eff = effective_comm_pipeline(resolve_pipeline(pipeline),
                                  _permute_limit(n, source, nl), site=kind)
    return _launch(kind, eff, shards, lambda: _permute(shards, n, source, None, eff))
