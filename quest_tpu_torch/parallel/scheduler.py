"""Gate dispatch over the shards of a register: the explicit distributed
scheduler (``quest_tpu/parallel/scheduler.py``).

QuEST_cpu_distributed.c dispatches so:
  - a 1-qubit dense gate on a sharded target: pair exchange (:870-905);
  - a dense gate with several targets, some sharded: swap each sharded
    target into a free local qubit (swapQubitAmps), apply locally, swap
    back (:1526-1568);
  - X class: a whole-shard exchange (:1109-1152);
  - diagonal and phase gates: no communication.
Sharded controls are a shard-index predicate: they travel only when a
relocation swap carries them.

:class:`DistributedScheduler`, the JAX package's flat scheduler, runs that
policy over the :mod:`.exchange` routines, bound to a mesh (the env's
tuple of devices). Each env keeps one in immediate mode for its sharded
registers (:func:`engine` outside an ``explicit_mesh`` context);
:func:`explicit_mesh` binds another to the registers of its mesh.
Immediate mode is the reference's policy gate by gate, the register always
in the identity layout: a relocation swaps into a local slot that is
neither target nor control or, when none is left, carries the control held
there with the swap, as the reference does. Deferred mode (a Circuit
replay, ``begin_defer``) keeps a logical->physical qubit layout, elides
relocation swap-backs (a relocated qubit stays local, evicting the
local qubit used farthest ahead, Belady, or least recently, LRU), makes
an uncontrolled SWAP a relabel (a virtual swap), batches the
relocations pending before the next barrier into one grouped permute
where that is cheaper, and reconciles the layout to identity at barriers
and at the replay's end, by a swap chain or one grouped permute,
whichever costs fewer chunk units. Every decision is priced in chunk
units (one unit = half a shard sent and received by every shard), kept
in ``stats`` (with ``chunks_by_kind_link`` per collective kind and
ICI/DCN link), in the series ``comm_chunk_units_total{kind,link}`` and,
when ``journal`` is a list, as one record per decision: the JAX
package's records, which its ``analysis.plancheck.check_schedule``
re-prices. The frame transposes between per-shard fused-run passes run
through :meth:`DistributedScheduler.apply_frame_permute`, counted the
same way (an f64 state at twice the units of f32).

:func:`plan_circuit` replays a Circuit under a scheduler on shards that are
``torch.device("meta")`` tensors: every decision and count, no state.
The two-tier (``hierarchical=True``) decisions are not ported: they raise
:class:`QuESTNotPortedError`.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field

from .. import telemetry
from .. import validation as V
from . import exchange as X
from .mesh import local_qubit_count, shard_bit_link

_STATE = threading.local()


# ---------------------------------------------------------------------------
# the explicit distributed scheduler
# ---------------------------------------------------------------------------

def _cycle_swaps(occ, pos, n: int) -> list:
    """The (a, b) position-swap sequence that restores the identity layout
    (at most one swap per displaced qubit, cycle restoration): the one
    source of the swap chain's order, for its price and its execution."""
    occ, pos = list(occ), list(pos)
    out = []
    for a in range(n):
        while occ[a] != a:
            b = pos[a]
            out.append((a, b))
            la, lb = occ[a], occ[b]
            occ[a], occ[b] = lb, la
            pos[la], pos[lb] = b, a
    return out


def plane_unit_scale(shards) -> float:
    """Chunk-unit scale of a state's layout against the planar f32 pair (8
    bytes an amplitude): 1.0 for planar f32, 2.0 for planar f64 (the JAX
    package's double-float 4-plane f32 state moves the same bytes). Only
    the frame-transpose accounting uses it."""
    s = shards[0]
    return s.shape[0] * s.element_size() / 8.0


def _swap_price(a: int, b: int, nl: int) -> float:
    """Chunk units of one dist_swap: free when both positions are local, 1
    (odd-parity half exchange) when mixed, 2 (whole-shard re-route) when
    both are sharded."""
    if max(a, b) < nl:
        return 0.0
    return 2.0 if min(a, b) >= nl else 1.0


#: the JAX package's default DCN-against-ICI price of its two-tier
#: decisions (``hierarchical=True``, not ported)
DCN_COST_WEIGHT = 4.0


def _new_stats() -> dict:
    return {
        "pair_exchanges": 0, "relocation_swaps": 0, "rank_permutes": 0,
        "comm_free": 0, "local": 0, "channel_superops": 0,
        "virtual_swaps": 0, "reconcile_swaps": 0,
        "reconcile_collectives": 0, "reconcile_chunks": 0.0,
        "reconcile_swap_equiv_chunks": 0.0,
        "relocation_batches": 0, "relocation_batch_qubits": 0,
        "relocation_prefetched": 0, "relocation_batch_chunks": 0.0,
        "relocation_batch_swap_equiv_chunks": 0.0,
        "frame_transpose_collectives": 0,
        "frame_transpose_chunks": 0.0,
        "frame_transpose_planar_chunks": 0.0,
        "staged_relays": 0,
        "ici_chunks": 0.0, "dcn_chunks": 0.0,
        # chunk units per "kind/link" cell: what the series
        # comm_chunk_units_total{kind,link} sums to
        "chunks_by_kind_link": {}}


def _not_ported() -> V.QuESTNotPortedError:
    return V.QuESTNotPortedError(
        "hierarchical=True (the two-tier ICI/DCN scheduling decisions: "
        "path-decomposed reconcile chains, staged relays, DCN-aware slot "
        "assignment) is ROADMAP queue A item 9.3, not ported yet; the flat "
        "scheduler (hierarchical=False) labels ICI and DCN chunk units",
        "explicit_mesh")


@dataclass
class DistributedScheduler:
    """Gate dispatcher bound to a mesh (a tuple of devices, shard r on
    mesh[r]), with the JAX package's immediate and deferred modes, stats
    and journal (see the module docstring)."""

    mesh: tuple
    #: slice count of a slice-major topology: the top log2(num_slices)
    #: shard bits are labelled DCN, the rest ICI (1 = all ICI)
    num_slices: int = 1
    #: the two-tier decisions (not ported: True raises)
    hierarchical: bool = False
    dcn_cost_weight: float = DCN_COST_WEIGHT
    #: False keeps the reference's immediate policy (begin_defer no-ops)
    allow_defer: bool = True
    #: False reconciles by the swap chain only (A/B plan stats)
    collective_reconcile: bool = True
    #: False relocates one swap at a time in deferred mode (A/B plan stats)
    batch_relocations: bool = True
    #: the depth every collective launch runs at (None = the
    #: QUEST_COMM_PIPELINE default); it never changes a decision or a price
    comm_pipeline: int | None = None
    #: the depth of collectives on a DCN shard bit (None = the
    #: QUEST_COMM_PIPELINE_DCN default, else the base depth)
    comm_pipeline_dcn: int | None = None
    stats: dict = field(default_factory=_new_stats)
    #: when a list, every communication decision appends one record:
    #:   ("pair_exchange", n, target) | ("rank_permute", n, qubit)
    #:   | ("dist_swap", n, a, b, layout_tracked)
    #:   | ("virtual_swap", p1, p2) | ("reconcile_swap", n, a, b)
    #:   | ("permute", n, source, unit_scale, kind) | ("reconcile_done", n)
    #:   | ("segment", lo)  (a sliced replay's defer span, zero cost)
    #: after one leading ("comm_pipeline", depth) stamp, or
    #: ("comm_pipeline", depth, dcn_depth) at num_slices > 1
    journal: list | None = None

    def __post_init__(self):
        if self.hierarchical:
            raise _not_ported()
        self.mesh = tuple(self.mesh)
        self.deferring = False
        self._pos = None        # logical qubit -> physical position
        self._occ = None        # physical position -> logical qubit
        self._last_use = None   # logical qubit -> last-touch counter
        self._clock = 0
        self._future = None     # per-tape-entry access sets (Belady)
        self._future_dense = None  # their relocation-forcing subsets
        self._cursor = 0

    # -- binding and accounting ---------------------------------------------

    def mode(self) -> tuple:
        """What a compiled executable keys on and pins: the mesh and every
        setting that changes a decision or a launch."""
        return (self.mesh, self.num_slices, self.allow_defer,
                self.collective_reconcile, self.batch_relocations,
                self.comm_pipeline, self.comm_pipeline_dcn)

    def covers(self, shards) -> bool:
        """True when ``shards`` lie on this scheduler's mesh, shard r on
        mesh[r] (meta shards, the planner's, on any mesh of their count)."""
        return len(shards) == len(self.mesh) and all(
            s.device == d or s.device.type == "meta" for s, d in zip(shards, self.mesh))

    def _note(self, *rec) -> None:
        if self.journal is not None:
            if not self.journal:
                # stamped at the first record: plan_circuit attaches the
                # journal after construction
                base = X.resolve_pipeline(self.comm_pipeline)
                if self.num_slices > 1:
                    self.journal.append(
                        ("comm_pipeline", base,
                         X.resolve_pipeline_dcn(self.comm_pipeline_dcn, self.comm_pipeline)))
                else:
                    self.journal.append(("comm_pipeline", base))
            self.journal.append(rec)

    def _count_comm(self, n: int, qubit: int, chunks: float, kind: str = "other") -> None:
        """Attribute ``chunks`` to the link the op on sharded physical
        ``qubit`` rides and to its collective ``kind``: stats and the
        series ``comm_chunk_units_total{kind,link}``."""
        link = shard_bit_link(n, self.mesh, self.num_slices, qubit)
        if link is not None:
            self.stats[f"{link}_chunks"] += chunks
        cell = f"{kind}/{link or 'local'}"
        by = self.stats["chunks_by_kind_link"]
        by[cell] = by.get(cell, 0.0) + chunks
        telemetry.inc("comm_chunk_units_total", chunks, kind=kind, link=link or "local")

    def _is_dcn(self, n: int, qubit: int) -> bool:
        return shard_bit_link(n, self.mesh, self.num_slices, qubit) == "dcn"

    def _pipeline_for(self, n: int, positions, pipeline=None, pipeline_dcn=None):
        """Launch depth of a collective on the sharded physical
        ``positions``: the DCN depth where one rides a DCN bit (at
        num_slices > 1), else the base depth."""
        base = pipeline if pipeline is not None else self.comm_pipeline
        if self.num_slices <= 1:
            return base
        if not any(self._is_dcn(n, p) for p in positions):
            return base
        return X.resolve_pipeline_dcn(
            pipeline_dcn if pipeline_dcn is not None else self.comm_pipeline_dcn, base)

    def comm_volume(self, n: int, bytes_per_amp: int = 8) -> dict:
        """The plan's communication volume per device from its chunk units
        (:func:`comm_chunks`); ``bytes_per_amp`` 8 for planar f32, 16 f64."""
        chunk = (1 << n) // len(self.mesh)
        amps_moved = chunk * comm_chunks(self.stats)
        return {"amps_per_device": amps_moved,
                "bytes_per_device": amps_moved * bytes_per_amp,
                "chunk_amps": chunk}

    # -- deferred layout ----------------------------------------------------

    def begin_defer(self, segment: int | None = None) -> bool:
        """Enter deferred mode; False if already deferring or deferral is
        off (the caller then must not end it). ``segment`` labels a sliced
        replay's span in the journal, ("segment", lo)."""
        if self.deferring or not self.allow_defer:
            return False
        self.deferring = True
        if segment is not None:
            self._note("segment", int(segment))
        return True

    def end_defer(self, shards, n: int):
        """Reconcile the layout to identity and leave deferred mode."""
        shards = self.reconcile(shards, n)
        self.deferring = False
        return shards

    def abort_defer(self) -> None:
        """Drop the deferred state without reconciling (an exception path,
        whose state is discarded): a stale layout must not reach the next
        replay."""
        self.deferring = False
        self._pos = self._occ = self._last_use = None
        self._future = None
        self._future_dense = None
        self._cursor = 0

    def set_lookahead(self, accesses, dense=None) -> None:
        """The replay's future qubit accesses for Belady eviction: one
        frozenset of logical qubits per tape entry, None at a barrier;
        ``dense`` the aligned subsets used in a relocation-forcing role
        (non-diagonal targets, X targets, channel rows and columns), which
        the relocation batcher prefetches from."""
        self._future = list(accesses) if accesses is not None else None
        self._future_dense = list(dense) if dense is not None else None
        self._cursor = 0

    def advance(self, index: int) -> None:
        self._cursor = index

    def _next_use(self, lq: int) -> int:
        """Tape index of the next access to logical ``lq`` (the current
        entry included), or a sentinel when none comes before a barrier."""
        for j in range(self._cursor, len(self._future)):
            s = self._future[j]
            if s is None:
                break
            if lq in s:
                return j
        return 1 << 30

    def _ensure_perm(self, n: int) -> None:
        if self._pos is None or len(self._pos) != n:
            self._pos = list(range(n))
            self._occ = list(range(n))
            self._last_use = [0] * n

    def _map(self, n, qs) -> tuple:
        """Logical -> physical coordinates under the current layout."""
        if self._pos is None:
            return tuple(qs)
        self._ensure_perm(n)
        return tuple(self._pos[q] for q in qs)

    def _touch(self, qs) -> None:
        self._clock += 1
        if self._last_use is not None:
            for q in qs:
                self._last_use[q] = self._clock

    def _swap_positions(self, a: int, b: int) -> None:
        """Record a physical swap of positions a and b in the layout."""
        la, lb = self._occ[a], self._occ[b]
        self._occ[a], self._occ[b] = lb, la
        self._pos[la], self._pos[lb] = b, a

    def reconcile(self, shards, n: int):
        """Restore the identity layout: the swap chain (:func:`_cycle_swaps`)
        or one grouped permute (:func:`..exchange.dist_permute_bits`),
        whichever costs fewer chunk units (``collective_reconcile=False``:
        the chain). Both are accounted in ``reconcile_chunks``; what the
        chain would cost is kept in ``reconcile_swap_equiv_chunks``."""
        if self._pos is None:
            return shards
        self._ensure_perm(n)
        nl = local_qubit_count(n, self.mesh)
        swaps = _cycle_swaps(self._occ, self._pos, n)
        if not swaps:
            return shards
        swap_units = sum(_swap_price(a, b, nl) for a, b in swaps)
        local_swaps = sum(1 for a, b in swaps if max(a, b) < nl)
        self.stats["reconcile_swap_equiv_chunks"] += swap_units
        source = tuple(self._pos)  # new bit q <- old bit pos[q]
        cstats = X.permute_collective_stats(n, source, self.mesh)
        if not self.collective_reconcile or swap_units < cstats["chunk_units"]:
            for x, y in swaps:
                price = _swap_price(x, y, nl)
                if price:
                    self.stats["reconcile_swaps"] += 1
                    self.stats["reconcile_chunks"] += price
                    self._count_comm(n, max(x, y), price, kind="reconciliation")
                else:
                    self.stats["local"] += 1
                self._note("reconcile_swap", n, x, y)
                shards = X.dist_swap(shards, n=n, qb1=x, qb2=y,
                                     pipeline=self._pipeline_for(n, (x, y)))
                self._swap_positions(x, y)
            self._note("reconcile_done", n)
            return shards
        self.stats["reconcile_collectives"] += cstats["collectives"]
        self.stats["reconcile_chunks"] += cstats["chunk_units"]
        # the local remainder rides the collective's in-shard transpose;
        # the op count stays comparable with the chain's
        self.stats["local"] += local_swaps
        self._count_permute(n, nl, source, cstats, 1.0, "reconciliation")
        self._note("permute", n, source, 1.0, "reconciliation")
        touched = [q for q in range(nl, n) if source[q] != q]
        shards = X.dist_permute_bits(shards, n=n, source=source,
                                     pipeline=self._pipeline_for(n, touched))
        self._pos = list(range(n))
        self._occ = list(range(n))
        self._note("reconcile_done", n)
        return shards

    def _count_permute(self, n, nl, source, cstats, scale, kind) -> None:
        """Link attribution of a grouped permute: the all-to-all's units
        split evenly over the crossing shard bits, the relabel's over the
        relabeled ones."""
        cross = [q for q in range(nl, n) if source[q] < nl]
        if cross:
            share = 2.0 * (1.0 - 0.5 ** len(cross)) * scale / len(cross)
            for q in cross:
                self._count_comm(n, q, share, kind=kind)
        if cstats["relabel_ppermute"]:
            moved = [q for q in range(nl, n) if source[q] >= nl and source[q] != q]
            for q in moved:
                self._count_comm(n, q, 2.0 * scale / len(moved), kind=kind)

    def count_frame_permute(self, shards, *, n, lo1, lo2, k) -> tuple:
        """The accounting of one frame transpose (the bit blocks
        [lo1, lo1+k) and [lo2, lo2+k) exchanged) as a grouped permute,
        priced at :func:`plane_unit_scale` (f64 twice f32;
        ``frame_transpose_planar_chunks`` keeps the unscaled figure); a
        transpose inside the shards costs nothing and counts no collective.
        Returns (source, the sharded positions it moves)."""
        source = list(range(n))
        for j in range(k):
            source[lo1 + j], source[lo2 + j] = source[lo2 + j], source[lo1 + j]
        source = tuple(source)
        scale = plane_unit_scale(shards)
        cstats = X.permute_collective_stats(n, source, self.mesh)
        nl = local_qubit_count(n, self.mesh)
        self.stats["frame_transpose_collectives"] += cstats["collectives"]
        self.stats["frame_transpose_chunks"] += cstats["chunk_units"] * scale
        self.stats["frame_transpose_planar_chunks"] += cstats["chunk_units"]
        self._count_permute(n, nl, source, cstats, scale, "frame_transpose")
        self._note("permute", n, source, scale, "frame_transpose")
        return source, [q for q in range(nl, n) if source[q] != q]

    def apply_frame_permute(self, shards, *, n, lo1, lo2, k, pipeline=None,
                            pipeline_dcn=None, out=None):
        """One frame transpose as the counted grouped permute
        (:meth:`count_frame_permute`, then
        :func:`..exchange.dist_permute_bits` into ``out`` when given): how
        per-shard fused-run passes are joined under the scheduler."""
        source, touched = self.count_frame_permute(shards, n=n, lo1=lo1, lo2=lo2, k=k)
        return X.dist_permute_bits(shards, n=n, source=source, out=out,
                                   pipeline=self._pipeline_for(n, touched, pipeline,
                                                               pipeline_dcn))

    def _pending_shard_uses(self, n, nl, exclude, capacity) -> list:
        """Sharded physical positions that entries between the cursor and
        the next barrier use in a relocation-forcing role, in first-use
        order, as (position, first use) (at most ``capacity``, skipping
        ``exclude``): the batch candidates of :meth:`_relocate`."""
        dense = self._future_dense
        if capacity <= 0 or dense is None or self._future is None:
            return []
        self._ensure_perm(n)
        out = []
        seen = set(exclude)
        for j in range(self._cursor, min(len(self._future), len(dense))):
            if self._future[j] is None:
                break
            s = dense[j]
            if not s:
                continue
            for lq in sorted(s):
                p = self._pos[lq]
                if p >= nl and p not in seen:
                    seen.add(p)
                    out.append((p, j))
                    if len(out) >= capacity:
                        return out
        return out

    def _next_dense_use(self, lq: int) -> int:
        """Tape index of the next relocation-forcing access to logical
        ``lq``, or a sentinel when none comes before a barrier."""
        dense = self._future_dense
        if dense is None:
            return 1 << 30
        for j in range(self._cursor, min(len(self._future), len(dense))):
            if self._future[j] is None:
                break
            s = dense[j]
            if s and lq in s:
                return j
        return 1 << 30

    def _relocate(self, shards, n, nl, phys_ts, support_phys, on_fail: str = "raise"):
        """Swap each sharded physical position in ``phys_ts`` with a free
        local slot (deferred: the slot whose occupant is used farthest
        ahead, no swap-back). Returns (shards, {old: new position}), or
        (shards, None) with ``on_fail="none"`` when no slot is free.

        In deferred mode the relocations pending before the next barrier
        join the batch (a candidate is admitted only if its first dense
        use comes before the next dense use of the occupant it evicts), and
        a batch of two or more runs as one grouped permute when that costs
        fewer chunk units than its swaps (m crossings: 2 (1 - 2^-m) < m)."""
        shard = [p for p in phys_ts if p >= nl]
        if not shard:
            return shards, {}
        free = [p for p in range(nl) if p not in support_phys]
        if len(free) < len(shard):
            if on_fail == "none":
                return shards, None
            if not self.deferring:
                # the reference's relocation: a control held in the slot
                # moves with the swap (the caller maps it back)
                free = [p for p in range(nl) if p not in phys_ts]
            V.validate_matrix_fits_in_node(len(free), len(shard), "applyMatrix")
        if self.deferring:
            self._ensure_perm(n)
            if self._future is not None:
                free.sort(key=lambda p: -self._next_use(self._occ[p]))
            else:
                # no lookahead (eager deferral): least recently used,
                # high slots first on ties
                free.sort(key=lambda p: (self._last_use[self._occ[p]], -p))
        batch = list(shard)
        slots = free[:len(shard)]
        if self.deferring and self.batch_relocations:
            tail = free[len(shard):]
            tail.sort(key=lambda p: -self._next_dense_use(self._occ[p]))
            cands = self._pending_shard_uses(n, nl, set(batch) | set(support_phys),
                                             len(tail))
            for p, first_use in cands:
                si = len(batch) - len(shard)
                if si >= len(tail):
                    break
                if first_use >= self._next_dense_use(self._occ[tail[si]]):
                    break
                batch.append(p)
            slots = slots + tail[:len(batch) - len(shard)]
        if self.deferring and self.batch_relocations and len(batch) >= 2:
            pairs = list(zip(batch, slots))
            swap_units = float(sum(_swap_price(f, s, nl) for s, f in pairs))
            source = list(range(n))
            for s, f in pairs:
                source[s], source[f] = source[f], source[s]
            cstats = X.permute_collective_stats(n, tuple(source), self.mesh)
            if cstats["chunk_units"] < swap_units:
                self.stats["relocation_batches"] += 1
                self.stats["relocation_batch_qubits"] += len(pairs)
                self.stats["relocation_prefetched"] += len(batch) - len(shard)
                self.stats["relocation_batch_chunks"] += cstats["chunk_units"]
                self.stats["relocation_batch_swap_equiv_chunks"] += swap_units
                share = cstats["chunk_units"] / len(pairs)
                for s, _ in pairs:
                    self._count_comm(n, s, share, kind="relocation_batch")
                self._note("permute", n, tuple(source), 1.0, "relocation_batch")
                shards = X.dist_permute_bits(
                    shards, n=n, source=tuple(source),
                    pipeline=self._pipeline_for(n, [s for s, _ in pairs]))
                for s, f in pairs:
                    self._swap_positions(f, s)
                return shards, {s: f for s, f in pairs if s in set(shard)}
        relocation = {}
        for s, f in zip(shard, free):
            self.stats["relocation_swaps"] += 1
            self._count_comm(n, s, 1.0, kind="dist_swap")
            self._note("dist_swap", n, f, s, self.deferring)
            shards = X.dist_swap(shards, n=n, qb1=f, qb2=s,
                                 pipeline=self._pipeline_for(n, (s,)))
            if self.deferring:
                self._swap_positions(f, s)
            relocation[s] = f
        return shards, relocation

    # -- dense matrices -----------------------------------------------------

    def apply_matrix(self, shards, matrix, *, n, targets, controls=(),
                     control_states=(), conj=False):
        nl = local_qubit_count(n, self.mesh)
        self._touch(targets)
        p_targets = self._map(n, targets)
        p_controls = self._map(n, controls)
        states = tuple(control_states)
        shard_ts = [t for t in p_targets if t >= nl]
        if not shard_ts:
            self.stats["local"] += 1
            return X.dist_apply_local_matrix(
                shards, matrix, n=n, targets=p_targets, controls=p_controls,
                control_states=states, conj=conj, pipeline=self.comm_pipeline)
        support = set(p_targets) | set(p_controls)
        if len(targets) == 1:
            # the reference's pair exchange; deferred mode relocates instead
            # (half the traffic now, none for later gates on the qubit) and
            # falls back to the exchange when no local slot is free
            relocation = None
            if self.deferring:
                shards, relocation = self._relocate(shards, n, nl, p_targets, support,
                                                    on_fail="none")
            if relocation is None:
                self.stats["pair_exchanges"] += 1
                self._count_comm(n, p_targets[0], 2.0, kind="pair_exchange")
                self._note("pair_exchange", n, p_targets[0])
                return X.dist_apply_matrix1(
                    shards, matrix, n=n, target=p_targets[0], controls=p_controls,
                    control_states=states, conj=conj,
                    pipeline=self._pipeline_for(n, (p_targets[0],)))
            self.stats["local"] += 1
            return X.dist_apply_local_matrix(
                shards, matrix, n=n,
                targets=tuple(relocation.get(t, t) for t in p_targets),
                controls=tuple(relocation.get(c, c) for c in p_controls),
                control_states=states, conj=conj, pipeline=self.comm_pipeline)
        # relocate the sharded targets, apply locally; immediate mode swaps
        # back (reference :1526-1568), deferred mode keeps the new layout
        shards, relocation = self._relocate(shards, n, nl, p_targets, support)
        # a control that held a slot (immediate mode, no free slot left)
        # moved with the swap to the target's old position
        carried = {f: s for s, f in relocation.items()}
        self.stats["local"] += 1
        shards = X.dist_apply_local_matrix(
            shards, matrix, n=n, targets=tuple(relocation.get(t, t) for t in p_targets),
            controls=tuple(relocation.get(c, carried.get(c, c)) for c in p_controls),
            control_states=states, conj=conj, pipeline=self.comm_pipeline)
        if not self.deferring:
            for s, f in relocation.items():
                self.stats["relocation_swaps"] += 1
                self._count_comm(n, s, 1.0, kind="dist_swap")
                self._note("dist_swap", n, f, s, False)
                shards = X.dist_swap(shards, n=n, qb1=f, qb2=s,
                                     pipeline=self._pipeline_for(n, (s,)))
        return shards

    # -- permutation class --------------------------------------------------

    def apply_x(self, shards, *, n, targets, controls=(), control_states=()):
        nl = local_qubit_count(n, self.mesh)
        self._touch(tuple(targets) + tuple(controls))
        p_targets = self._map(n, targets)
        p_controls = self._map(n, controls)
        states = tuple(control_states)
        if not any(t >= nl for t in p_targets):
            self.stats["local"] += 1
            return X.dist_apply_x(shards, n=n, targets=p_targets, controls=p_controls,
                                  control_states=states, pipeline=self.comm_pipeline)
        relocation = None
        if self.deferring:
            # relocating moves half a shard each way (1 unit) where the
            # rank permute re-routes it whole (2), and the qubit stays
            support = set(p_targets) | set(p_controls)
            shards, relocation = self._relocate(shards, n, nl, p_targets, support,
                                                on_fail="none")
        if relocation is not None:
            p_targets = tuple(relocation.get(t, t) for t in p_targets)
            p_controls = tuple(relocation.get(c, c) for c in p_controls)
            self.stats["local"] += 1
        else:
            top = max(t for t in p_targets if t >= nl)
            self.stats["rank_permutes"] += 1
            self._count_comm(n, top, 2.0, kind="grouped_permute")
            self._note("rank_permute", n, top)
        return X.dist_apply_x(shards, n=n, targets=p_targets, controls=p_controls,
                              control_states=states,
                              pipeline=self._pipeline_for(
                                  n, [t for t in p_targets if t >= nl]))

    def apply_swap(self, shards, *, n, qb1, qb2):
        self._touch((qb1, qb2))
        if self.deferring:
            # an uncontrolled SWAP is a relabel: no data moves
            self._ensure_perm(n)
            p1, p2 = self._pos[qb1], self._pos[qb2]
            self._swap_positions(p1, p2)
            self.stats["virtual_swaps"] += 1
            self._note("virtual_swap", p1, p2)
            telemetry.inc("comm_ops_total", kind="virtual_swap")
            return shards
        p1, p2 = self._map(n, (qb1, qb2))
        nl = local_qubit_count(n, self.mesh)
        if max(p1, p2) < nl:
            self.stats["local"] += 1
        elif min(p1, p2) >= nl:
            self.stats["rank_permutes"] += 1
            self._count_comm(n, max(p1, p2), 2.0, kind="grouped_permute")
            self._note("rank_permute", n, max(p1, p2))
        else:
            self.stats["relocation_swaps"] += 1
            self._count_comm(n, max(p1, p2), 1.0, kind="dist_swap")
            self._note("dist_swap", n, p1, p2, False)
        return X.dist_swap(shards, n=n, qb1=p1, qb2=p2,
                           pipeline=self._pipeline_for(n, (p1, p2)))

    # -- diagonal family (always comm-free) ---------------------------------

    def map_diagonal_qubits(self, n: int, qubits) -> tuple:
        """Physical coordinates of a purely diagonal access (phase
        functions, projectors, sub-diagonal ops): index algebra runs under
        any layout without communication, so such an entry needs no
        reconciliation. Counted as a comm-free op."""
        self.stats["comm_free"] += 1
        self._touch(qubits)
        return self._map(n, qubits)

    def apply_diagonal(self, shards, diag, *, n, targets, controls=(),
                       control_states=(), conj=False):
        self.stats["comm_free"] += 1
        self._touch(targets)
        return X.dist_apply_diag_phase(
            shards, diag, n=n, targets=self._map(n, targets),
            controls=self._map(n, controls), control_states=tuple(control_states),
            conj=conj, pipeline=self.comm_pipeline)

    def apply_parity_phase(self, shards, theta, *, n, qubits, controls=(),
                           control_states=(), conj=False):
        self.stats["comm_free"] += 1
        self._touch(qubits)
        return X.dist_apply_parity_phase(
            shards, theta, n=n, qubits=self._map(n, qubits),
            controls=self._map(n, controls), control_states=tuple(control_states),
            conj=conj, pipeline=self.comm_pipeline)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

@contextmanager
def explicit_mesh(mesh, num_slices: int = 1, defer: bool = True,
                  collective_reconcile: bool = True,
                  batch_relocations: bool = True,
                  comm_pipeline: int | None = None,
                  hierarchical: bool = False,
                  comm_pipeline_dcn: int | None = None):
    """Route the sharded registers on ``mesh`` (an env's ``devices``)
    through one :class:`DistributedScheduler` while the context is live,
    eagerly and in Circuit replays (which defer). ``num_slices`` > 1
    labels the top shard bits DCN; ``defer=False`` keeps the reference's
    immediate policy; ``collective_reconcile`` / ``batch_relocations``
    False force the swap-at-a-time A/B policies; ``comm_pipeline`` (and
    ``comm_pipeline_dcn`` for DCN-riding collectives) set the depth every
    collective runs at. A mesh of one device (or None) gives no
    scheduler. ``hierarchical=True`` raises :class:`QuESTNotPortedError`."""
    if hierarchical:
        raise _not_ported()
    sched = (DistributedScheduler(tuple(mesh), num_slices=num_slices,
                                  allow_defer=defer,
                                  collective_reconcile=collective_reconcile,
                                  batch_relocations=batch_relocations,
                                  comm_pipeline=comm_pipeline,
                                  comm_pipeline_dcn=comm_pipeline_dcn)
             if mesh is not None and len(mesh) > 1 else None)
    prev = getattr(_STATE, "sched", None)
    _STATE.sched = sched
    try:
        yield sched
    finally:
        _STATE.sched = prev


def active() -> DistributedScheduler | None:
    """The scheduler of the innermost explicit_mesh context, if any."""
    return getattr(_STATE, "sched", None)


def mode() -> tuple | None:
    """The active scheduler's :meth:`~DistributedScheduler.mode`, or None:
    what compiled executables key on."""
    sched = active()
    return sched.mode() if sched is not None else None


@contextmanager
def pinned(mode_key):
    """Run under the scheduler mode ``mode_key`` (a :func:`mode`): the
    active scheduler where it has that mode, else a fresh one of it (None:
    no scheduler). What a compiled executable keyed on a mode runs under,
    wherever it is called."""
    sched = active()
    if (sched.mode() if sched is not None else None) == mode_key:
        yield sched
        return
    if mode_key is None:
        with explicit_mesh(None) as s:
            yield s
        return
    mesh, ns, defer, coll, batch, pipe, pipe_dcn = mode_key
    with explicit_mesh(mesh, num_slices=ns, defer=defer, collective_reconcile=coll,
                       batch_relocations=batch, comm_pipeline=pipe,
                       comm_pipeline_dcn=pipe_dcn) as s:
        yield s


def comm_chunks(stats: dict) -> float:
    """A plan's communication in chunk units, the cost model's one source:
    2 a pair exchange or rank permute, 1 a relocation swap, 0 a virtual
    swap, plus the measured ``reconcile_chunks``,
    ``relocation_batch_chunks`` and ``frame_transpose_chunks``."""
    return (2.0 * stats["pair_exchanges"] + 1.0 * stats["relocation_swaps"]
            + 2.0 * stats["rank_permutes"]
            + stats.get("reconcile_chunks", 0.0)
            + stats.get("relocation_batch_chunks", 0.0)
            + stats.get("frame_transpose_chunks", 0.0))


def plan_circuit(circuit, mesh, num_slices: int = 1, defer: bool = True,
                 collective_reconcile: bool = True, batch_relocations: bool = True,
                 dtype=None, journal: list | None = None,
                 comm_pipeline: int | None = None, hierarchical: bool = False,
                 comm_pipeline_dcn: int | None = None) -> dict:
    """Replay ``circuit`` under the explicit scheduler on ``mesh`` (an env's
    devices) without a state: its shards are ``torch.device("meta")``
    tensors, so nothing of size 2^n is allocated and no kernel launches.
    Returns the plan's stats and ``comm_volume`` ({} on a one-device
    mesh). ``dtype`` is the register's (default: the process precision;
    an f64 plan prices its frame transposes at 2x); ``journal`` (a
    caller's list) receives every decision; the other settings are
    :func:`explicit_mesh`'s."""
    import torch

    from ..precision import as_torch_dtype, real_dtype

    if hierarchical:
        raise _not_ported()
    dt = as_torch_dtype(dtype) if dtype is not None else real_dtype()
    nsv = (2 if circuit.is_density_matrix else 1) * circuit.num_qubits
    mesh = tuple(mesh)
    with explicit_mesh(mesh, num_slices=num_slices, defer=defer,
                       collective_reconcile=collective_reconcile,
                       batch_relocations=batch_relocations,
                       comm_pipeline=comm_pipeline,
                       comm_pipeline_dcn=comm_pipeline_dcn) as sched:
        if sched is None:
            return {}
        if journal is not None:
            sched.journal = journal
        d = len(mesh)
        meta = torch.device("meta")
        shards = [torch.empty((2, (1 << nsv) // d), dtype=dt, device=meta)
                  for _ in range(d)]
        circuit.as_fn()(shards)
    out = dict(sched.stats)
    out["comm_volume"] = sched.comm_volume(
        nsv, bytes_per_amp=2 * torch.empty((), dtype=dt).element_size())
    return out


def engine(qureg, scheduled: bool = True) -> DistributedScheduler:
    """The dispatcher of a sharded register's gates: the active scheduler
    when ``scheduled`` and an ``explicit_mesh`` context over the register's
    mesh is live, else its env's immediate-mode scheduler (a fresh one for
    a register without an env, a compiled replay's bare register around a
    caller's shards). The eager readouts ask with ``scheduled=False``:
    they run outside the scheduler, as the JAX package's do."""
    sched = active()
    if scheduled and sched is not None and qureg.shards is not None \
            and sched.covers(qureg.shards):
        return sched
    if qureg.env is None:
        return DistributedScheduler(tuple(s.device for s in qureg.shards),
                                    allow_defer=False)
    if qureg.env.engine is None:
        qureg.env.engine = DistributedScheduler(qureg.env.devices, allow_defer=False)
    return qureg.env.engine
