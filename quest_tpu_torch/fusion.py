"""Tape-level gate fusion: plan a recorded circuit into fused gate runs.

A copy of ``quest_tpu/fusion.py``'s planner, for state-vector and
density tapes, so that at the same tile geometry the two packages emit the
same plan item for item. Each tape entry is replayed once against a spy
register with the gate primitives patched to record (kind, operands,
qubits) instead of touching any state; entries that don't route through
them act as fusion barriers and run unchanged.

Density tapes plan over the flattened 2n-qubit state: every captured row
op gains its conj-shadow twin on q + n (``_shadow_pop``), decoherence
channels lower to ``kraus1``/``kraus2``/``krausn`` kernel ops
(``_lower_channel``) and dephasing to wide diagonals, and the column
qubits are just more high qubits for the frame machinery to relabel. A
channel whose qubits no frame localises stays a barrier and runs through
``ops.density.apply_channel``.

With a tile geometry (``pallas_tile_bits``) every expressible gate joins a
:class:`PallasRun` -- one read+write pass of the state through the fused
gate-run kernel (``ops.fused_gates``) -- and frame swaps relabel high
qubits into the tile. Without one, gates contract into dense
:class:`FusedBlock` windows and :class:`DiagBlock` diagonals for the
per-gate engine (small registers).

The executors at the end run the items on a register: a PallasRun on a
CUDA register launches the kernel or raises; nothing degrades to another
route.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
from torch._C._functorch import is_batchedtensor

from . import precision, telemetry


# ---------------------------------------------------------------------------
# captured gate events
# ---------------------------------------------------------------------------

@dataclass
class GateEvent:
    """One primitive application captured from a tape entry.

    kind: 'matrix' | 'diag' | 'x' | 'parity' | 'swap' | 'channel'.

    ``extended=True`` marks events that take no conj-shadow twin in density
    planning: 'diag' events captured from the dephasing appliers carry
    flattened-state targets (columns at q + n explicit); 'channel' events
    carry ROW targets only, and ``_lower_channel`` adds the columns."""
    kind: str
    targets: tuple
    controls: tuple = ()
    states: tuple = ()
    matrix: Optional[np.ndarray] = None   # 'matrix': (2^t, 2^t) complex
    diag: Optional[np.ndarray] = None     # 'diag':   (2^t,) complex
    theta: float = 0.0                    # 'parity'
    superop: Optional[np.ndarray] = None  # 'channel': (4^t, 4^t) complex
    extended: bool = False                # targets already in 2n coords

    @property
    def support(self) -> frozenset:
        return frozenset(self.targets) | frozenset(self.controls)


class _SpyAmps:
    """Stands in for ``qureg.amps`` during capture: carries a dtype for
    validation tolerances, raises on any real use."""

    def __init__(self, dtype):
        self.dtype = dtype


class _SpyQureg:
    """Minimal stand-in satisfying validation + the patched primitives."""

    def __init__(self, num_qubits: int, dtype, is_density: bool = False):
        self.num_qubits_represented = int(num_qubits)
        self.is_density_matrix = bool(is_density)
        self.amps = _SpyAmps(dtype)
        self.qasm_log = None
        self.env = None
        #: an unsharded register: swapGate and the operators read this
        #: before they choose their route
        self.shards = None

    @property
    def num_qubits_in_state_vec(self):
        return (2 if self.is_density_matrix else 1) * self.num_qubits_represented

    @property
    def dtype(self):
        return self.amps.dtype

    @property
    def eps(self):
        return precision.eps_for_dtype(self.amps.dtype)

    def put(self, amps):  # swapGate's inline path calls this with the token
        self.amps = amps

    #: no out-of-place buffer: a channel's kernel route is not run here
    spare = None

    def spare_buffer(self):
        return None


@contextlib.contextmanager
def _channel_capture_ctx(events: list):
    """Patch the density-channel appliers in :mod:`.ops.density` to record
    events: Kraus channels (``apply_channel``, row targets) and dephasing
    diagonals (``_diag_dispatch``, flattened 2n coordinates)."""
    from .ops import density as DN

    def cap_channel(amps, superop, *, n, targets, out=None):
        events.append(GateEvent(
            "channel", tuple(targets),
            superop=np.asarray(superop, dtype=complex), extended=True))
        return amps

    def cap_dens_diag(amps, d, *, n, targets):
        events.append(GateEvent("diag", tuple(targets),
                                diag=np.asarray(d, dtype=complex).reshape(-1),
                                extended=True))
        return amps

    saved = (DN.apply_channel, DN._diag_dispatch)
    DN.apply_channel = cap_channel
    DN._diag_dispatch = cap_dens_diag
    try:
        yield
    finally:
        DN.apply_channel, DN._diag_dispatch = saved


@contextlib.contextmanager
def _capture_ctx(events: list):
    """Patch the gate primitives in :mod:`.gates` to record events."""
    from . import gates as G
    from .ops import apply as K

    def cap_matrix(qureg, matrix, targets, controls=(), states=()):
        events.append(GateEvent(
            "matrix", tuple(targets), tuple(controls), tuple(states),
            matrix=np.asarray(matrix, dtype=complex)))

    def cap_diag(qureg, diag, targets, controls=()):
        events.append(GateEvent(
            "diag", tuple(targets), tuple(controls),
            diag=np.asarray(diag, dtype=complex).reshape(-1)))

    def cap_x(qureg, targets, controls=(), states=()):
        events.append(GateEvent("x", tuple(targets), tuple(controls), tuple(states)))

    def cap_parity(qureg, theta, qubits, controls=()):
        events.append(GateEvent(
            "parity", tuple(qubits), tuple(controls), theta=float(theta)))

    def cap_swap(amps, *, n, qb1, qb2, controls=()):
        events.append(GateEvent("swap", (qb1, qb2), tuple(controls)))
        return amps

    saved = (G._apply_gate_matrix, G._apply_gate_diag, G._apply_gate_x,
             G._apply_gate_parity_phase, K.apply_swap)
    G._apply_gate_matrix = cap_matrix
    G._apply_gate_diag = cap_diag
    G._apply_gate_x = cap_x
    G._apply_gate_parity_phase = cap_parity
    K.apply_swap = cap_swap
    try:
        yield
    finally:
        (G._apply_gate_matrix, G._apply_gate_diag, G._apply_gate_x,
         G._apply_gate_parity_phase, K.apply_swap) = saved


def _entry_has_params(args, kwargs) -> bool:
    """True when a tape entry carries ``engine.params.Param`` placeholders:
    the planner never spy-captures it (there is no concrete matrix to fuse
    at plan time) -- the entry passes through as a barrier whose matrix is
    assembled from the runtime values at replay, so the plan's structure
    stays value-independent and one captured replay serves every
    parameter vector."""
    from .engine.params import has_params

    return has_params(args, kwargs)


def capture(fn, args, kwargs, num_qubits: int, dtype,
            is_density: bool = False) -> Optional[list]:
    """Replay one tape entry against a spy register; return its GateEvents,
    or None if the entry doesn't route through the capturable primitives
    (it then acts as a fusion barrier and runs unchanged).

    The first attempt uses a STATE-VECTOR spy, so that gates record their
    row op only (shadows are derived in planning). On a density tape an
    entry that fails it (a decoherence channel, whose validation demands a
    density register) gets a second attempt against a density spy with the
    channel appliers patched."""
    if getattr(fn, "_fusion_barrier", False):
        return None  # a mid-circuit measurement or collapse: never fused
    events: list = []
    shell = _SpyQureg(num_qubits, dtype)
    try:
        with _capture_ctx(events):
            fn(shell, *args, **kwargs)
        return events if events else None
    except Exception:  # any entry the spy cannot replay is a barrier
        pass
    if not is_density:
        return None
    events = []
    shell = _SpyQureg(num_qubits, dtype, is_density=True)
    try:
        with _capture_ctx(events), _channel_capture_ctx(events):
            fn(shell, *args, **kwargs)
    except Exception:
        return None
    return events if events else None


def event_dagger(ev: GateEvent) -> GateEvent:
    """The exact inverse of a captured unitary event, as a new event: a
    'matrix' conjugate-transposes its block, a 'diag' conjugates its
    diagonal, a 'parity' negates its angle, 'x' and 'swap' are their own
    inverses. A 'channel' (and an ``extended`` density event) is not
    unitary and raises ValueError, which the adjoint gradient's planner
    turns into a typed error naming the tape site."""
    if ev.kind == "matrix" and ev.matrix is not None and not ev.extended:
        return GateEvent("matrix", ev.targets, ev.controls, ev.states,
                         matrix=np.conj(np.asarray(ev.matrix)).T)
    if ev.kind == "diag" and ev.diag is not None and not ev.extended:
        return GateEvent("diag", ev.targets, ev.controls, ev.states,
                         diag=np.conj(np.asarray(ev.diag)))
    if ev.kind == "parity":
        return GateEvent("parity", ev.targets, ev.controls, ev.states, theta=-ev.theta)
    if ev.kind in ("x", "swap"):
        return ev
    raise ValueError(f"'{ev.kind}' event has no unitary inverse")


# ---------------------------------------------------------------------------
# dense embedding of one event into a block's qubit space
# ---------------------------------------------------------------------------

def event_matrix(ev: GateEvent, block_qubits: Sequence[int]) -> np.ndarray:
    """The event's full operator on ``block_qubits`` (ascending order; qubit
    block_qubits[j] is bit j of the matrix index). Controls are folded in
    (identity on control-unsatisfied states); for the event's own matrix,
    targets[k] is bit k."""
    pos = {q: j for j, q in enumerate(block_qubits)}
    N = 1 << len(block_qubits)
    out = np.zeros((N, N), dtype=complex)

    cbits = [pos[c] for c in ev.controls]
    states = ev.states if ev.states else (1,) * len(ev.controls)
    tbits = [pos[q] for q in ev.targets]
    t = len(ev.targets)

    if ev.kind == "matrix":
        M = ev.matrix
    elif ev.kind == "diag":
        M = np.diag(ev.diag)
    elif ev.kind == "x":
        M = None  # pure bit-flip, handled per column below
    elif ev.kind == "swap":
        M = np.array([[1, 0, 0, 0], [0, 0, 1, 0],
                      [0, 1, 0, 0], [0, 0, 0, 1]], dtype=complex)
    elif ev.kind == "parity":
        d = np.empty(1 << t, dtype=complex)
        for s in range(1 << t):
            par = bin(s).count("1") & 1
            d[s] = np.exp(-1j * ev.theta / 2 * (1 - 2 * par))
        M = np.diag(d)
    else:
        raise ValueError(f"unknown event kind {ev.kind!r}")

    for s in range(N):
        if any(((s >> c) & 1) != st for c, st in zip(cbits, states)):
            out[s, s] = 1.0
            continue
        if ev.kind == "x":
            s2 = s
            for b in tbits:
                s2 ^= 1 << b
            out[s2, s] = 1.0
            continue
        col = 0
        for j, b in enumerate(tbits):
            col |= ((s >> b) & 1) << j
        base = s
        for b in tbits:
            base &= ~(1 << b)
        for row in range(1 << t):
            s2 = base
            for j, b in enumerate(tbits):
                s2 |= ((row >> j) & 1) << b
            out[s2, s] = M[row, col]
    return out


def _embed_block(U: np.ndarray, old_qubits: Sequence[int],
                 new_qubits: Sequence[int]) -> np.ndarray:
    """Re-embed a block unitary when its qubit set grows."""
    if tuple(old_qubits) == tuple(new_qubits):
        return U
    return event_matrix(GateEvent("matrix", tuple(old_qubits), matrix=U),
                        new_qubits)


def _event_is_diag(ev: GateEvent) -> bool:
    return ev.kind in ("diag", "parity")


def _event_diag(ev: GateEvent, qubits: Sequence[int]) -> np.ndarray:
    """The event's diagonal over ``qubits`` (ascending; qubits[j] is bit j).
    Only valid for diagonal-kind events; controls folded in."""
    pos = {q: j for j, q in enumerate(qubits)}
    cbits = [pos[c] for c in ev.controls]
    states = ev.states if ev.states else (1,) * len(ev.controls)
    tbits = [pos[q] for q in ev.targets]
    out = np.ones(1 << len(qubits), dtype=complex)
    for s in range(1 << len(qubits)):
        if any(((s >> c) & 1) != st for c, st in zip(cbits, states)):
            continue
        idx = sum(((s >> b) & 1) << j for j, b in enumerate(tbits))
        if ev.kind == "parity":
            par = bin(idx).count("1") & 1
            out[s] = np.exp(-1j * ev.theta / 2 * (1 - 2 * par))
        else:
            out[s] = ev.diag[idx]
    return out


# ---------------------------------------------------------------------------
# plan items
# ---------------------------------------------------------------------------

@dataclass
class FusedBlock:
    """A dense unitary over a contiguous qubit window [qubits[0], qubits[-1]]."""
    qubits: tuple            # ascending contiguous run; qubits[j] is bit j
    matrix: np.ndarray       # (2^k, 2^k) complex
    #: the block's lane_u pass (ops.fused_gates.PreparedRun) where it takes
    #: that route, built at first execution and reused by every replay
    lane_run: object = field(default=None, repr=False, compare=False)


@dataclass
class DiagBlock:
    """An accumulated diagonal over (possibly scattered) support qubits."""
    qubits: tuple            # ascending; qubits[j] is bit j of the diag index
    diag: np.ndarray         # (2^k,) complex


@dataclass
class FusePlan:
    #: sequence of FusedBlock | DiagBlock | PallasRun | FrameSwap |
    #: (fn, args, kwargs) passthroughs
    items: list = field(default_factory=list)
    num_fused_gates: int = 0
    num_barriers: int = 0


@dataclass(eq=False)
class PallasRun:
    """A run of tile-local ops executed in ONE pass of the fused gate-run
    kernel (ops.fused_gates.fused_run). Dense targets lie below
    ``tile_bits``; controls and diagonal roles may be any qubit. Ops are
    in PHYSICAL coordinates (after any active frame swap).

    ``load_swap_k`` / ``store_swap_k`` fold a frame switch into this run's
    loads / stores: the bit blocks [tile_bits-k, tile_bits) and [hi, hi+k)
    (hi = ``*_swap_hi``, None meaning tile_bits) are exchanged as the state
    is read / written. The name keeps the JAX package's, so that the two
    packages' plans compare item for item."""
    ops: tuple
    tile_bits: int
    load_swap_k: int = 0
    store_swap_k: int = 0
    load_swap_hi: int | None = None
    store_swap_hi: int | None = None
    #: the index of the frame-identity segment the run belongs to, stamped
    #: by ``segments.stamp_plan`` (None on an unstamped plan)
    seg: int | None = None
    #: the folded, encoded form of ``ops`` (ops.fused_gates.PreparedRun),
    #: built at first execution and reused by every replay
    prepared: object = field(default=None, repr=False, compare=False)

    def prepare(self):
        from .ops.fused_gates import PreparedRun
        if self.prepared is None:
            self.prepared = PreparedRun(self.ops, self.tile_bits)
        return self.prepared


@dataclass
class FrameSwap:
    """Exchange the k-bit grid block [hi, hi+k) (hi = None means
    tile_bits) with the block [tile_bits-k, tile_bits): one relabeling
    pass (ops.fused_gates.swap_bit_blocks). Self-inverse."""
    tile_bits: int
    k: int
    hi: int | None = None
    #: the frame-identity segment index (``segments.stamp_plan``)
    seg: int | None = None


def _window(qubits) -> tuple:
    return tuple(range(min(qubits), max(qubits) + 1))


# ---------------------------------------------------------------------------
# multi-frame planning
#
# The fused kernel can target any qubit below tile_bits and can use any
# qubit diagonally (controls, parity members, diagonal targets). It cannot
# apply a dense target above the tile. The planner therefore runs the
# circuit in several qubit labelings ("frames"): frame None is the
# identity; frame (hi, kf) swaps the grid block [hi, hi+kf) with the
# block [tb-kf, tb). Switching frames folds into a run's loads or stores,
# so a deep circuit executes as [run A][run B][run A]... passes.
# ---------------------------------------------------------------------------

@dataclass
class _POp:
    """A primitive op in LOGICAL coordinates plus its diagonality roles."""
    kind: str            # 'matrix' | 'swap' | 'diagw' | 'parity' | 'kraus*'
    targets: tuple
    controls: tuple
    states: tuple
    data: object         # matrix ndarray | diag ndarray | theta
    diag_targets: bool   # True if the op acts diagonally on its targets

    @property
    def support(self):
        return frozenset(self.targets) | frozenset(self.controls)

    def diag_on(self, q: int) -> bool:
        return q in self.controls or self.diag_targets


def _lower_event(ev: GateEvent):
    """GateEvent -> list of _POp, or None if not expressible as kernel ops
    (dense multi-qubit matrices, wide diagonals)."""
    states = tuple(ev.states) if ev.states else (1,) * len(ev.controls)
    ctrls = tuple(ev.controls)
    if ev.kind == "parity":
        return [_POp("parity", tuple(ev.targets), ctrls, (), float(ev.theta), True)]
    if ev.kind == "swap":
        return [_POp("swap", tuple(ev.targets), ctrls, states, None, False)]
    if ev.kind == "x":
        # C[X (x) X ...] = product of single-target CXs (identical controls)
        X = np.array([[0, 1], [1, 0]], dtype=complex)
        return [_POp("matrix", (t,), ctrls, states, X, False)
                for t in ev.targets]
    if ev.kind == "diag":
        if len(ev.targets) == 1:
            return [_POp("matrix", tuple(ev.targets), ctrls, states,
                         np.diag(ev.diag), True)]
        if len(ev.targets) <= 5:
            if any(s == 0 for s in states):
                # the diagw op has no control-state slot: an anti-controlled
                # wide diagonal runs through the engine instead
                return None
            return [_POp("diagw", tuple(ev.targets), ctrls, (),
                         np.asarray(ev.diag).reshape(-1), True)]
        return None
    if ev.kind == "matrix":
        if len(ev.targets) != 1:
            return None
        m = np.asarray(ev.matrix)
        is_diag = m[0, 1] == 0 and m[1, 0] == 0
        return [_POp("matrix", tuple(ev.targets), ctrls, states, m, is_diag)]
    return None


#: max primitive ops per emitted PallasRun (pre-fold). The port's kernel
#: reads its ops from a table, so it has no per-run compile cost; the cap
#: stays at the JAX package's value so that the two packages' plans agree.
_RUN_OP_CAP = 96


class _FramePlanner:
    """Greedy multi-frame scheduler over an ordered list of pending runs.

    The candidate frames tile the grid bits in k-sized blocks from tb
    upward, so every qubit is in-tile in some frame. A new op joins the
    EARLIEST pending run whose frame localises it and whose every LATER
    pending op commutes past it; ops that fit nowhere open a new run.
    Holding every run open until flush lets late ops join early runs.

    ``boundary`` (a sharded register's local qubit count) aligns the block
    edges to the shard boundary, so that frames below it relabel inside
    each shard and only frames reaching the sharded bits pay a collective
    transpose."""

    def __init__(self, out: FusePlan, tile_bits: int, k: int, nsv: int,
                 boundary: int | None = None):
        self.out = out
        self.tb = tile_bits
        self.k = k
        self.nsv = nsv
        self.boundary = boundary
        self.frames = [None]
        edges = [tile_bits, nsv]
        if boundary is not None and tile_bits < boundary < nsv:
            edges.insert(1, boundary)
        for lo, hi_edge in zip(edges, edges[1:]):
            hi = lo
            while k > 0 and hi < hi_edge:
                self.frames.append((hi, min(k, hi_edge - hi)))
                hi += k
        self.cur_frame = None        # physical frame of the state
        self.runs = []               # ordered pending [frame, [_POp]]

    # -- frame geometry -----------------------------------------------------

    def phys(self, q: int, frame) -> int:
        if frame is None:
            return q
        hi, kf = frame
        if self.tb - kf <= q < self.tb:
            return q - (self.tb - kf) + hi
        if hi <= q < hi + kf:
            return q - hi + (self.tb - kf)
        return q

    def feasible(self, op: _POp, frame) -> bool:
        if op.kind in ("parity", "diagw") or (op.kind == "matrix" and op.diag_targets):
            return True
        return all(self.phys(t, frame) < self.tb for t in op.targets)

    def _frame_for(self, op: _POp, exclude):
        for f in self.frames:
            if f != exclude and self.feasible(op, f):
                return f
        f = self._synth_frame(op)
        if f is not None and f != exclude:
            self.frames.append(f)
            return f
        return Ellipsis

    def _synth_frame(self, op: _POp):
        """Invent a frame when the static k-block tiling localises none: a
        block [hi0, hi0+kf) anchored at the op's high targets, kept narrow
        enough that the displaced region [tb-kf, tb) avoids its low ones.
        Where that block straddles the shard boundary, the two blocks
        clipped at it are tried first (their transposes stay inside the
        shards, or keep the collective to the sharded bits)."""
        targs = tuple(op.targets)
        high = sorted(t for t in targs if t >= self.tb)
        if not high or self.k <= 0:
            return None
        max_lo = max((t for t in targs if t < self.tb), default=-1)
        hi0 = high[0]
        kf = high[-1] + 1 - hi0
        b = self.boundary
        cands = []
        if b is not None and hi0 < b < hi0 + kf:
            cands += [(hi0, b - hi0), (b, high[-1] + 1 - b)]
        cands.append((hi0, kf))
        for a0, w in cands:
            if w <= 0 or w > self.k or w >= self.tb - max_lo or a0 + w > self.nsv:
                continue
            if self.feasible(op, (a0, w)):
                return (a0, w)
        return None

    def feasible_somewhere(self, op: _POp) -> bool:
        return (any(self.feasible(op, f) for f in self.frames)
                or self._synth_frame(op) is not None)

    # -- emission -----------------------------------------------------------

    def _leave_cur_frame(self):
        """Fold the undo of the current frame into the last run's stores,
        or emit an explicit FrameSwap."""
        if self.cur_frame is None:
            return
        hi, kf = self.cur_frame
        last = self.out.items[-1] if self.out.items else None
        if isinstance(last, PallasRun) and last.store_swap_k == 0:
            last.store_swap_k = kf
            last.store_swap_hi = hi
        else:  # a run always precedes a non-identity frame
            self.out.items.append(FrameSwap(self.tb, kf, hi))
        self.cur_frame = None

    def _emit_run(self, frame, ops: list):
        if not ops:
            return
        load_k, load_hi = 0, None
        if self.cur_frame != frame:
            # leaving one frame for another: the undo folds into the
            # PREVIOUS run's stores, the new frame's swap into THIS run's
            # loads
            self._leave_cur_frame()
            if frame is not None:
                load_hi, load_k = frame
            self.cur_frame = frame
        phys = [self._phys_op(op, frame) for op in ops]
        for i in range(0, len(phys), _RUN_OP_CAP):
            self.out.items.append(PallasRun(
                tuple(phys[i:i + _RUN_OP_CAP]), self.tb,
                load_swap_k=load_k if i == 0 else 0,
                load_swap_hi=load_hi if i == 0 else None))

    def _phys_op(self, op: _POp, frame):
        from .ops.fused_gates import HashableMatrix

        t = tuple(self.phys(q, frame) for q in op.targets)
        c = tuple(self.phys(q, frame) for q in op.controls)
        if op.kind == "matrix":
            return ("matrix", t[0], c, op.states, HashableMatrix(op.data))
        if op.kind == "swap":
            return ("swap", t[0], t[1], c, op.states)
        if op.kind == "kraus1":
            return ("kraus1", t[0], t[1], op.data)
        if op.kind == "kraus2":
            return ("kraus2", t[0], t[1], t[2], t[3], op.data)
        if op.kind == "krausn":
            h = len(t) // 2
            return ("krausn", t[:h], t[h:], op.data)
        if op.kind == "diagw":
            return ("diagw", t, c, HashableMatrix(op.data))
        return ("parity", t, c, op.data)

    def flush(self):
        """Emit every pending run in order and return to the identity."""
        for frame, ops in self.runs:
            self._emit_run(frame, ops)
        self._leave_cur_frame()
        self.runs = []

    # -- scheduling ---------------------------------------------------------

    def add(self, op: _POp):
        for i, (frame, ops) in enumerate(self.runs):
            if not self.feasible(op, frame):
                continue
            if all(self._commutes(op, other)
                   for _, later in self.runs[i + 1:] for other in later):
                ops.append(op)
                return
        f = self._frame_for(op, exclude=Ellipsis)
        if f is Ellipsis:
            raise AssertionError("op feasible in no frame reached the scheduler")
        self.runs.append([f, [op]])

    @staticmethod
    def _commutes(a: _POp, b: _POp) -> bool:
        return all(a.diag_on(q) and b.diag_on(q)
                   for q in a.support & b.support)


class _FramePlannerTwoSlot(_FramePlanner):
    """The two-slot variant: one OPEN run plus one lookahead run, rotated
    eagerly when an op fits neither. Neither scheduler dominates, so
    _plan_pallas schedules with both and keeps the cheaper plan."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.open = [None, []]       # [frame, [_POp]]
        self.next = [Ellipsis, []]   # Ellipsis = frame not yet chosen

    def rotate(self):
        frame, ops = self.open
        self._emit_run(frame, ops)
        self.open = self.next
        if self.open[0] is Ellipsis:
            self.open[0] = None
        self.next = [Ellipsis, []]

    def flush(self):
        self._emit_run(*self.open)
        if self.next[0] is not Ellipsis:
            self._emit_run(*self.next)
        self._leave_cur_frame()
        self.open = [None, []]
        self.next = [Ellipsis, []]

    def add(self, op: _POp):
        for _ in range(3):
            of, oops = self.open
            nf, nops = self.next
            if self.feasible(op, of) and all(
                    self._commutes(op, other) for other in nops):
                oops.append(op)
                return
            if nf is Ellipsis:
                nf = self._frame_for(op, exclude=of)
                if nf is not Ellipsis:
                    self.next[0] = nf
                    nops.append(op)
                    return
            elif self.feasible(op, nf):
                nops.append(op)
                return
            self.rotate()
        raise AssertionError("op feasible in no frame reached the scheduler")


def plan(tape, num_qubits: int, dtype, max_qubits: int = 5,
         max_diag_qubits: int = 12, pallas_tile_bits: int | None = None,
         is_density: bool = False) -> FusePlan:
    """Greedy left-to-right fusion of a Circuit tape.

    Without ``pallas_tile_bits``: dense events merge while the combined
    contiguous window spans at most ``max_qubits``; diagonal events merge by
    support up to ``max_diag_qubits`` (on a density register the items stay
    in row coordinates and the primitives apply their shadows). With it:
    multi-frame planning into fused-kernel runs (see the block comment
    above); ``is_density`` plans a density tape over the flattened 2n-qubit
    state. The plan's barriers are counted in ``fusion_barriers_total``."""
    if pallas_tile_bits is not None:
        p = _plan_pallas(tape, num_qubits, dtype, max_qubits, pallas_tile_bits,
                         is_density=is_density)
        telemetry.inc("fusion_barriers_total", p.num_barriers, mode="pallas")
        return p
    out = FusePlan()
    cur = None  # None | FusedBlock | DiagBlock (mutable accumulators)

    def flush():
        nonlocal cur
        if cur is not None:
            out.items.append(cur)
        cur = None

    def add_dense(ev):
        nonlocal cur
        win = _window(ev.support)
        if isinstance(cur, DiagBlock):
            joint = _window(set(cur.qubits) | ev.support)
            if len(joint) <= max_qubits:
                cur = FusedBlock(joint, np.diag(
                    _event_diag(GateEvent("diag", cur.qubits, diag=cur.diag),
                                joint)))
            else:
                flush()
        if isinstance(cur, FusedBlock):
            joint = _window(set(cur.qubits) | ev.support)
            if len(joint) <= max_qubits:
                U = _embed_block(cur.matrix, cur.qubits, joint)
                cur = FusedBlock(joint, event_matrix(ev, joint) @ U)
                return
            flush()
        cur = FusedBlock(win, event_matrix(ev, win))

    def add_diag(ev):
        nonlocal cur
        if isinstance(cur, FusedBlock):
            joint = _window(set(cur.qubits) | ev.support)
            if len(joint) <= max_qubits:
                cur = FusedBlock(joint,
                                 np.diag(_event_diag(ev, joint)) @
                                 _embed_block(cur.matrix, cur.qubits, joint))
                return
            flush()
        if isinstance(cur, DiagBlock):
            joint = tuple(sorted(set(cur.qubits) | ev.support))
            if len(joint) <= max_diag_qubits:
                d = _event_diag(GateEvent("diag", cur.qubits, diag=cur.diag), joint)
                cur = DiagBlock(joint, d * _event_diag(ev, joint))
                return
            flush()
        qs = tuple(sorted(ev.support))
        cur = DiagBlock(qs, _event_diag(ev, qs))

    for fn, args, kwargs in tape:
        if _entry_has_params(args, kwargs):
            flush()
            out.items.append((fn, args, kwargs))
            out.num_barriers += 1
            telemetry.inc("fusion_param_barriers_total", mode="dense")
            continue
        events = capture(fn, args, kwargs, num_qubits, dtype)
        fusible = events is not None and all(
            (len(ev.support) <= max_diag_qubits) if _event_is_diag(ev)
            else (len(_window(ev.support)) <= max_qubits)
            for ev in events)
        if not fusible:
            flush()
            out.items.append((fn, args, kwargs))
            out.num_barriers += 1
            continue
        for ev in events:
            if _event_is_diag(ev):
                add_diag(ev)
            else:
                add_dense(ev)
            out.num_fused_gates += 1
    flush()
    telemetry.inc("fusion_barriers_total", out.num_barriers, mode="dense")
    return out


def num_passes(p: FusePlan) -> int:
    """Passes over the state the plan's kernel items cost: one per
    PallasRun and one per explicit FrameSwap."""
    return sum(isinstance(i, (PallasRun, FrameSwap)) for i in p.items)


def transpose_stats(p: FusePlan, shard_qubits: int | None) -> dict:
    """(collective, local) frame-transpose counts of a fused plan: a
    relabeling is a collective exactly when its block reaches a sharded
    qubit (>= ``shard_qubits``); None counts all as local (one device)."""
    coll = loc = 0
    for i in p.items:
        swaps = []
        if isinstance(i, PallasRun):
            swaps = [(k, i.tile_bits if hi is None else hi)
                     for k, hi in ((i.load_swap_k, i.load_swap_hi),
                                   (i.store_swap_k, i.store_swap_hi)) if k]
        elif isinstance(i, FrameSwap):
            swaps = [(i.k, i.tile_bits if i.hi is None else i.hi)]
        for k, hi in swaps:
            if shard_qubits is not None and hi + k > shard_qubits:
                coll += 1
            else:
                loc += 1
    return {"collective_transposes": coll, "local_transposes": loc}


def tape_transpose_stats(tape, shard_qubits: int | None) -> dict:
    """:func:`transpose_stats` of an ``as_tape`` tape (a fused Circuit's)."""
    return transpose_stats(FusePlan(items=[
        a[0] for f, a, _ in tape if f in (_apply_pallas_run, _apply_frame_swap)]),
        shard_qubits)


def plan_pallas_sharded(tape, num_qubits: int, dtype, max_qubits: int,
                        tile_bits: int, n_local: int,
                        is_density: bool = False) -> FusePlan:
    """Plan for a register sharded with ``n_local`` local qubits twice --
    frame blocks tiled plainly from tile_bits, and aligned to the shard
    boundary -- and keep the plan with fewer collective transposes (ties:
    fewer items), as the JAX package does."""
    nsv = (2 if is_density else 1) * num_qubits
    boundaries = [None]
    if tile_bits < n_local < nsv:
        boundaries.append(n_local)
    cands = [_plan_pallas(tape, num_qubits, dtype, max_qubits, tile_bits,
                          is_density=is_density, shard_boundary=b,
                          score_shard_qubits=n_local)
             for b in boundaries]
    best = min(cands, key=lambda p: (
        transpose_stats(p, n_local)["collective_transposes"], len(p.items)))
    telemetry.inc("fusion_barriers_total", best.num_barriers, mode="pallas_sharded")
    return best


#: widest channel the krausn kernel op takes (the JAX package's limit):
#: its superoperator is 4^t x 4^t, 64 x 64 at t = 3
_KRAUSN_MAX_TARGETS = 3


def _lower_channel(ev: GateEvent, n: int):
    """'channel' event -> [_POp('kraus1'|'kraus2'|'krausn', extended
    targets, ...)] for <= _KRAUSN_MAX_TARGETS-target Kraus maps, or None
    (wider channels stay barriers). The op's data is the hashable
    Kraus-term tuple ((sign, K), ...) of the superoperator's Choi
    decomposition."""
    from .ops.density import choi_kraus
    from .ops.fused_gates import HashableMatrix

    if not 1 <= len(ev.targets) <= _KRAUSN_MAX_TARGETS:
        return None
    terms = tuple((float(s), HashableMatrix(k))
                  for s, k in choi_kraus(ev.superop))
    if len(ev.targets) == 1:
        t = ev.targets[0]
        return [_POp("kraus1", (t, t + n), (), (), terms, False)]
    if len(ev.targets) == 2:
        t1, t2 = ev.targets
        return [_POp("kraus2", (t1, t2, t1 + n, t2 + n), (), (), terms,
                     False)]
    rows = tuple(ev.targets)
    return [_POp("krausn", rows + tuple(q + n for q in rows), (), (),
                 terms, False)]


def _shadow_pop(op: _POp, n: int) -> _POp:
    """The density conj-shadow twin of a lowered row op: the same op on the
    column qubits (q + n) with conjugated data (QuEST.c:184-193). Parity
    phases conjugate by negating theta; swaps are real."""
    targets = tuple(q + n for q in op.targets)
    controls = tuple(q + n for q in op.controls)
    if op.kind == "parity":
        data = -float(op.data)
    elif op.kind == "swap":
        data = op.data
    else:  # 'matrix' | 'diagw'
        data = np.conj(np.asarray(op.data))
    return _POp(op.kind, targets, controls, op.states, data, op.diag_targets)


def _plan_pallas(tape, num_qubits: int, dtype, max_qubits: int,
                 tile_bits: int, is_density: bool = False,
                 shard_boundary: int | None = None,
                 score_shard_qubits: int | None = None) -> FusePlan:
    """Multi-frame plan: lower every event to kernel primitive ops (ONE
    spy-capture pass over the tape), then schedule the lowered stream with
    BOTH frame schedulers and keep the cheaper plan: fewer items (ties:
    fewer frame transposes) on one device, fewer collective transposes
    first when ``score_shard_qubits`` is set. ``shard_boundary`` aligns
    the frames to a shard boundary (``_FramePlanner``). A density tape
    (``is_density``) plans over the flattened 2n-qubit state: every
    lowered row op is paired with its conj-shadow twin, and the runs carry
    both explicitly."""
    from .ops.fused_gates import LANE_BITS

    nsv = (2 if is_density else 1) * num_qubits
    k = min(max(nsv - tile_bits, 0), tile_bits - LANE_BITS)

    def make_planner(cls):
        return cls(FusePlan(), tile_bits, k, nsv, boundary=shard_boundary)

    probe = make_planner(_FramePlanner)

    # -- pass 1: resolve every tape entry (capture + lower + routability) --
    resolved = []  # ('barrier', entry) | ('events', [(ev, pops|None)])
    for fn, args, kwargs in tape:
        if _entry_has_params(args, kwargs):
            # a runtime-parameter entry: a barrier between the static
            # kernel runs, assembled at replay (see _entry_has_params)
            telemetry.inc("fusion_param_barriers_total", mode="pallas")
            resolved.append(("barrier", (fn, args, kwargs)))
            continue
        events = capture(fn, args, kwargs, num_qubits, dtype,
                         is_density=is_density)
        lowered = None
        if events is not None:
            lowered = []
            for ev in events:
                if ev.kind == "channel":
                    pops = _lower_channel(ev, num_qubits)
                else:
                    pops = _lower_event(ev)
                    if pops is not None and is_density and not ev.extended:
                        pops = [q for p in pops
                                for q in (p, _shadow_pop(p, num_qubits))]
                if pops is not None and not all(
                        probe.feasible_somewhere(p) for p in pops):
                    pops = None  # a target no frame localises
                lowered.append(pops)

            def routable(ev, pops):
                # a unitary event falls back to a dense window block; a
                # channel has no dense unitary to fall back to
                return pops is not None or (
                    ev.kind != "channel" and len(_window(ev.support)) <= max_qubits)

            if not all(routable(ev, pops) for ev, pops in zip(events, lowered)):
                events = None  # no route for some event: run the entry as-is
        if events is None:
            resolved.append(("barrier", (fn, args, kwargs)))
        else:
            resolved.append(("events", list(zip(events, lowered))))

    # -- pass 2: schedule with each planner, keep the cheaper plan --------
    def schedule(cls):
        sched = make_planner(cls)
        out = sched.out
        for kind, payload in resolved:
            if kind == "barrier":
                sched.flush()
                out.items.append(payload)
                out.num_barriers += 1
                continue
            for ev, pops in payload:
                if pops is not None:
                    for p in pops:
                        sched.add(p)
                else:
                    # dense multi-qubit matrix: a standalone window block
                    # through the engine, in the identity frame (in row
                    # coordinates: the primitive applies the density shadow)
                    sched.flush()
                    win = _window(ev.support)
                    out.items.append(FusedBlock(win, event_matrix(ev, win)))
                out.num_fused_gates += 1
        sched.flush()
        return out

    def score(p):
        st = transpose_stats(p, score_shard_qubits)
        if score_shard_qubits is not None:
            return (st["collective_transposes"], len(p.items))
        return (len(p.items), st["local_transposes"])

    return min((schedule(cls) for cls in (_FramePlanner, _FramePlannerTwoSlot)),
               key=score)


# ---------------------------------------------------------------------------
# executors (tape entries)
# ---------------------------------------------------------------------------

def _is_lane(qureg) -> bool:
    """True when ``qureg`` holds one lane of a ``torch.func.vmap`` batch (the
    serving Engine's batch body): each kernel pass then goes through
    ``ops.fused_gates.fused_run_lanes``, whose batching rule makes one
    launch for every lane, and each pass and frame swap writes a fresh
    tensor (a lane has no spare buffer of its own)."""
    return is_batchedtensor(qureg.amps)


def _apply_pallas_run(qureg, run: PallasRun) -> None:
    """Tape entry of a PallasRun: one pass of the fused gate-run kernel.

    A run without folded swaps updates the state in place; a run with one
    writes into the register's spare buffer, which then becomes the state
    (see registers.Qureg). A CUDA register launches the kernel or raises;
    a CPU register runs the kernel's plain version. A sharded register
    takes :func:`_apply_pallas_sharded`; a lane of a batch
    (:func:`_is_lane`) one launch for the whole batch."""
    from .ops.fused_gates import fused_run, fused_run_lanes

    if qureg.shards is not None:
        _apply_pallas_sharded(qureg, run)
        return
    if _is_lane(qureg):
        qureg.put(fused_run_lanes(
            qureg.amps, n=qureg.num_qubits_in_state_vec, ops=run.ops,
            tile_bits=run.tile_bits, load_swap_k=run.load_swap_k,
            store_swap_k=run.store_swap_k, load_swap_hi=run.load_swap_hi,
            store_swap_hi=run.store_swap_hi, prepared=run.prepare()))
        return
    swapped = bool(run.load_swap_k or run.store_swap_k)
    out = fused_run(
        qureg.amps, n=qureg.num_qubits_in_state_vec, ops=run.ops,
        tile_bits=run.tile_bits, load_swap_k=run.load_swap_k,
        store_swap_k=run.store_swap_k, load_swap_hi=run.load_swap_hi,
        store_swap_hi=run.store_swap_hi,
        out=qureg.spare_buffer() if swapped else None,
        prepared=run.prepare())
    if out is qureg.spare:
        qureg.swap_spare()


def _sharded_run_plan(qureg, run: PallasRun):
    """Per-shard legality of a run on a sharded register: (n_local, None)
    when every shard can run it at the run's tile -- the tile fits in a
    shard, so every dense target pairs inside it, while roles on sharded
    qubits resolve against the shard index in the kernel -- else (None,
    the JAX package's fallback reason). One pass per shard, no
    communication: the reference runs its local kernel per rank between
    exchanges the same way (QuEST_cpu_distributed.c:870-905)."""
    from .ops.fused_gates import _LANES

    n_local = qureg.num_local_qubits
    if (1 << n_local) < 2 * _LANES or run.tile_bits > n_local:
        return None, "shard_map_unsupported"
    return n_local, None


def _frame_permute(qureg, tile_bits: int, k: int, hi: int) -> None:
    """One frame transpose of a sharded register, the blocks
    [tile_bits-k, tile_bits) and [hi, hi+k) exchanged: a block reaching a
    sharded qubit is ``dist_permute_bits`` of the block swap (a collective,
    into the shards' spare buffers); one inside the shards a
    ``swap_bit_blocks`` pass on each shard, into the shards' spare
    buffers."""
    from .ops.fused_gates import swap_bit_blocks
    from .parallel import exchange as X

    telemetry.inc("pallas_pass_total", kind="frame_swap")
    nsv, nl = qureg.num_qubits_in_state_vec, qureg.num_local_qubits
    lo1 = tile_bits - k
    if hi + k > nl:
        source = list(range(nsv))
        for j in range(k):
            source[lo1 + j], source[hi + j] = hi + j, lo1 + j
        X.dist_permute_bits(qureg.shards, n=nsv, source=source,
                            out=qureg.shard_spare_buffers())
        qureg.swap_shard_spares()
    else:
        for a, out in zip(qureg.shards, qureg.shard_spare_buffers()):
            swap_bit_blocks(a, n=nl, lo1=lo1, lo2=hi, k=k, out=out)
        qureg.swap_shard_spares()


def _apply_pallas_sharded(qureg, run: PallasRun) -> None:
    """A PallasRun on a sharded register: one launch of the fused-run kernel
    per shard, on the shard's device, with the shard's index (roles on
    sharded qubits resolve in the kernel). Folded swaps inside the shards
    ride the kernel, and such a pass writes into the shards' spare
    buffers; one reaching a sharded qubit runs as an explicit collective
    transpose before or after (:func:`_frame_permute`). A run the shards
    cannot execute (:func:`_sharded_run_plan`) replays its ops through the
    per-gate engine over shards, the reason counted in
    ``engine_fallback_total``."""
    from .ops.fused_gates import fused_run

    tb = run.tile_bits
    lk, sk = run.load_swap_k, run.store_swap_k
    lh = tb if run.load_swap_hi is None else run.load_swap_hi
    sh = tb if run.store_swap_hi is None else run.store_swap_hi
    n_local, reason = _sharded_run_plan(qureg, run)
    if n_local is None:
        telemetry.inc("engine_fallback_total", reason=reason)
        if lk:
            _frame_permute(qureg, tb, lk, lh)
        _apply_ops_via_engine(qureg, run.ops)
        if sk:
            _frame_permute(qureg, tb, sk, sh)
        return
    fold_l = bool(lk) and lh + lk <= n_local
    fold_s = bool(sk) and sh + sk <= n_local
    if lk and not fold_l:
        _frame_permute(qureg, tb, lk, lh)
    prep = run.prepare()
    outs = qureg.shard_spare_buffers() if fold_l or fold_s else [None] * len(qureg.shards)
    for r, (shard, out) in enumerate(zip(qureg.shards, outs)):
        fused_run(shard, n=qureg.num_qubits_in_state_vec, local_n=n_local,
                  shard_index=r, ops=run.ops, tile_bits=tb,
                  load_swap_k=lk if fold_l else 0, load_swap_hi=lh,
                  store_swap_k=sk if fold_s else 0, store_swap_hi=sh,
                  out=out, prepared=prep)
    if fold_l or fold_s:
        qureg.swap_shard_spares()
    if sk and not fold_s:
        _frame_permute(qureg, tb, sk, sh)


def _apply_frame_swap(qureg, fs: FrameSwap) -> None:
    """Tape entry of a FrameSwap: one relabeling pass into the register's
    spare buffer, which then becomes the state, as a run with a folded
    swap does (on a sharded register, :func:`_frame_permute`)."""
    from .ops.fused_gates import swap_bit_blocks

    if qureg.shards is not None:
        _frame_permute(qureg, fs.tile_bits, fs.k,
                       fs.tile_bits if fs.hi is None else fs.hi)
        return
    telemetry.inc("pallas_pass_total", kind="frame_swap")
    swap = dict(n=qureg.num_qubits_in_state_vec, lo1=fs.tile_bits - fs.k,
                lo2=fs.tile_bits if fs.hi is None else fs.hi, k=fs.k)
    if _is_lane(qureg):
        qureg.put(swap_bit_blocks(qureg.amps, **swap))
        return
    swap_bit_blocks(qureg.amps, out=qureg.spare_buffer(), **swap)
    qureg.swap_spare()


def dense_block_route(nsv: int, is_density: bool, qubits: tuple,
                      on_card: bool) -> str:
    """How a FusedBlock on ``qubits`` runs, as the JAX package's
    ``_apply_dense_block`` decides on its accelerator: "lane_u" (one pass
    of the fused-run kernel) for a state-vector window below the lane
    boundary (hi < 7) of a state of at least two lane rows, "engine" (the
    per-gate engine) for everything else, windows at lo >= 7 included,
    where the JAX package measured the engine faster than its window
    kernel. A CPU register (``on_card`` False) always takes the engine."""
    from .ops.fused_gates import LANE_BITS, _LANES

    if (on_card and qubits[-1] < LANE_BITS and (1 << nsv) >= 2 * _LANES
            and not is_density):
        return "lane_u"
    return "engine"


def lane_u_run(block: FusedBlock, tile_bits: int):
    """A window below the lane boundary as ONE fused-run pass
    (ops.fused_gates.PreparedRun): the block embedded in the 128x128 lane
    unitary (I (x) U (x) I over the contiguous window), as the kernel's
    lane_u op (W = (Ur^T, Ui^T, Ur^T + Ui^T)). Kept on ``block`` for the
    next replay."""
    from .ops.fused_gates import LANE_BITS, HashableMatrix, PreparedRun

    prep = block.lane_run
    if prep is None or prep.tile_bits != tile_bits:
        lo, hi = block.qubits[0], block.qubits[-1]
        lane = np.kron(np.eye(1 << (LANE_BITS - 1 - hi)),
                       np.kron(np.asarray(block.matrix, dtype=complex), np.eye(1 << lo)))
        W = np.stack([lane.real.T, lane.imag.T, lane.real.T + lane.imag.T])
        prep = block.lane_run = PreparedRun((("lane_u", HashableMatrix(W)),), tile_bits)
    return prep


def _lane_u_pass(qureg, block: FusedBlock) -> None:
    """The block's :func:`lane_u_run` through the fused-run kernel, in place
    (a lane of a batch: one launch for the batch, into a fresh tensor)."""
    from .ops.fused_gates import fused_run, fused_run_lanes, hopper_tile_bits

    nsv = qureg.num_qubits_in_state_vec
    tb = hopper_tile_bits(nsv, qureg.dtype)
    prep = lane_u_run(block, tb)
    if _is_lane(qureg):
        qureg.put(fused_run_lanes(qureg.amps, n=nsv, ops=prep.ops, tile_bits=tb,
                                  prepared=prep))
        return
    fused_run(qureg.amps, n=nsv, ops=prep.ops, tile_bits=tb, prepared=prep)


def _apply_dense_block(qureg, block: FusedBlock) -> None:
    """Tape entry of a FusedBlock, routed by :func:`dense_block_route`: a
    lane_u pass of the fused-run kernel (kept on the block for the next
    replay), or the per-gate engine (ops.apply) through the gate
    primitive, which re-derives the density shadow on a density register
    (the block stays in row coordinates)."""
    from . import gates as G

    if qureg.shards is None and dense_block_route(
            qureg.num_qubits_in_state_vec, qureg.is_density_matrix,
            block.qubits, qureg.device.type == "cuda") == "lane_u":
        _lane_u_pass(qureg, block)
    else:  # a sharded register: the engine over shards, as the JAX package
        G._apply_gate_matrix(qureg, block.matrix, block.qubits)


def _apply_ops_via_engine(qureg, ops: tuple) -> None:
    """Replay kernel-format ops (physical coordinates) through the per-gate
    engine, one op at a time: the independent plain replay of a run that
    the tests hold the kernel route against. Nothing calls it in place of
    the kernel on one device; on a sharded register it is the route of a
    run the shards cannot execute (:func:`_apply_pallas_sharded`), through
    the per-gate engine over shards."""
    from .ops import apply as K
    from .ops import cplx
    from .ops import density as DN
    from .ops import diagonal as D
    from .ops.fused_gates import _KRAUS, kraus_parts

    if qureg.shards is not None:
        _apply_ops_via_shard_engine(qureg, ops)
        return
    nsv = qureg.num_qubits_in_state_vec
    dt, dev = qureg.dtype, qureg.device
    for op in ops:
        if op[0] == "matrix":
            _, q, controls, states, m = op
            qureg.put(K.apply_matrix(qureg.amps, cplx.from_complex(m.arr, dt, dev),
                                     n=nsv, targets=(q,), controls=controls,
                                     control_states=states))
        elif op[0] == "parity":
            _, qubits, controls, theta = op
            qureg.put(D.apply_parity_phase(qureg.amps, theta, n=nsv,
                                           qubits=qubits, controls=controls))
        elif op[0] == "diagw":
            _, targets, controls, d = op
            qureg.put(D.apply_diagonal(qureg.amps, cplx.from_complex(d.arr, dt, dev),
                                       n=nsv, targets=targets, controls=controls))
        elif op[0] == "swap":
            _, q1, q2, controls, states = op
            if states and any(s == 0 for s in states):
                raise ValueError("swap with 0-controls has no engine route")
            qureg.put(K.apply_swap(qureg.amps, n=nsv, qb1=q1, qb2=q2,
                                   controls=controls))
        elif op[0] in _KRAUS:
            rows, cols, terms = kraus_parts(op)
            qureg.put(DN._apply_kraus_sum(qureg.amps, [(s, k.arr) for s, k in terms],
                                          nsv=nsv, rows=rows, cols=cols))
        else:
            raise ValueError(f"no engine route for op {op[0]!r}")


def _apply_ops_via_shard_engine(qureg, ops: tuple) -> None:
    """:func:`_apply_ops_via_engine` on a sharded register: each op through
    the register's per-gate engine over shards (``parallel.scheduler``); a
    kraus op as its Kraus sum, each term's K on the row qubits and conj(K)
    on the column qubits through the engine's exchanges."""
    from .ops import cplx
    from .ops.density import kraus_sum_shards
    from .ops.fused_gates import _KRAUS, kraus_parts
    from .parallel.scheduler import engine

    eng, nsv = engine(qureg), qureg.num_qubits_in_state_vec
    dt, dev = qureg.dtype, qureg.device
    for op in ops:
        if op[0] == "matrix":
            _, q, controls, states, m = op
            new = eng.apply_matrix(qureg.shards, cplx.from_complex(m.arr, dt, dev),
                                   n=nsv, targets=(q,), controls=controls,
                                   control_states=states)
        elif op[0] == "parity":
            _, qubits, controls, theta = op
            new = eng.apply_parity_phase(qureg.shards, theta, n=nsv, qubits=qubits,
                                         controls=controls)
        elif op[0] == "diagw":
            _, targets, controls, d = op
            new = eng.apply_diagonal(qureg.shards, cplx.from_complex(d.arr, dt, dev),
                                     n=nsv, targets=targets, controls=controls)
        elif op[0] == "swap" and not op[3]:
            new = eng.apply_swap(qureg.shards, n=nsv, qb1=op[1], qb2=op[2])
        elif op[0] in _KRAUS:
            rows, cols, terms = kraus_parts(op)
            new = kraus_sum_shards(eng, qureg.shards, [(s, k.arr) for s, k in terms],
                                   nsv=nsv, rows=rows, cols=cols)
        else:
            raise ValueError(f"no route over shards for op {op[0]!r}")
        qureg.put_shards(new)


def as_tape(p: FusePlan) -> list:
    """Lower a FusePlan back to Circuit tape entries (fn, args, kwargs)."""
    from . import gates as G

    entries = []
    for item in p.items:
        if isinstance(item, DiagBlock):
            entries.append((G._apply_gate_diag, (item.diag, item.qubits), {}))
        elif isinstance(item, FusedBlock):
            entries.append((_apply_dense_block, (item,), {}))
        elif isinstance(item, PallasRun):
            entries.append((_apply_pallas_run, (item,), {}))
        elif isinstance(item, FrameSwap):
            entries.append((_apply_frame_swap, (item,), {}))
        else:
            entries.append(item)
    return entries
