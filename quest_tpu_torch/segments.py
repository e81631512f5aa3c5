"""Whole-segment single-dispatch execution (``quest_tpu/segments.py``).

A *segment* is a maximal tape slice whose two-frame permutation starts AND
ends at identity (the seams ``resilience.segmented`` checkpoints at, as in the
JAX package). This module plans the seams and builds the executables that
run a slice, a chain of slices or the whole request as compiled programs
(:mod:`._capture`): on the card a slice is ONE CUDA-graph replay, the
command-buffer/graph-launch idea of the cuQuantum lineage (PAPERS.md); on
the CPU it is the cached eager replay.

- :func:`identity_boundaries`, :func:`measurement_seams`,
  :func:`segment_cuts`, :func:`stamp_plan` -- the plan side, the same
  seams and stamps as the JAX package's on the same plan. The port's tape
  entry of a frame item is ``(_apply_pallas_run, (run,), {})`` or
  ``(_apply_frame_swap, (swap,), {})``, so the frame is read from the
  PallasRun / FrameSwap object.
- :func:`slice_executable` / :func:`run_slice` -- ``tape[lo:hi]`` as one
  program, or item by item with segment dispatch off.
- :func:`chain_executable` (``Circuit.compiled_segments``) -- the tape as
  a chain of segment programs, each at most ``max_items`` entries.
- :func:`request_executable` (``Circuit.compiled_request``) -- every
  segment plus an optional terminal ``reduce`` as ONE program.

A host-bound entry (``circuits._capture_safe`` false: a measurement or
collapse, an entry that copies host data to the card at replay) cannot be
captured: :func:`measurement_seams` cuts around it, so it is a segment of
its own, which runs eagerly as the item route. The whole-request program
refuses such a tape.

Every dispatch counts ``device_dispatch_total{route}`` on the host:
``segment`` per segment program, ``item`` per eagerly run entry,
``circuit`` per ``Circuit.run``, ``request`` per whole-request program,
``block`` per ``compiled_blocks`` block. ``QUEST_SEGMENT_DISPATCH``
(default 1 = on; 0 runs ``run_slice`` item by item) gates the lowering;
:func:`force_route` overrides it per thread.
"""

from __future__ import annotations

import contextlib
import os
import threading
import warnings

from . import telemetry

__all__ = [
    "identity_boundaries", "measurement_seams", "segment_cuts", "stamp_plan",
    "segment_dispatch_default", "segment_dispatch_enabled", "force_route",
    "slice_executable", "run_slice", "chain_executable", "request_executable",
]

_SEG_ENV = "QUEST_SEGMENT_DISPATCH"
_DEF_SEGMENT_DISPATCH = 1
#: raw env strings already warned about (warn once per value)
_SEG_ENV_WARNED: set = set()

_ROUTE = threading.local()


def segment_dispatch_default() -> int:
    """The ``QUEST_SEGMENT_DISPATCH`` env value (default 1 = segment
    programs on, 0 = per-item interpretation). A malformed or negative
    value warns once and falls back to the default."""
    raw = os.environ.get(_SEG_ENV)
    if raw is None or raw.strip() == "":
        return _DEF_SEGMENT_DISPATCH
    try:
        value = int(raw.strip())
    except ValueError:
        value = -1
    if value < 0:
        if raw not in _SEG_ENV_WARNED:
            _SEG_ENV_WARNED.add(raw)
            warnings.warn(f"{_SEG_ENV}={raw!r} is not a non-negative integer "
                          f"segment-dispatch mode; using {_DEF_SEGMENT_DISPATCH}",
                          RuntimeWarning, stacklevel=2)
        return _DEF_SEGMENT_DISPATCH
    return value


def segment_dispatch_enabled() -> bool:
    """Whether tape slices run as single-dispatch segment programs: a
    :func:`force_route` override if one is active on this thread, else
    the ``QUEST_SEGMENT_DISPATCH`` env default."""
    forced = getattr(_ROUTE, "route", None)
    if forced is not None:
        return forced == "segment"
    return segment_dispatch_default() != 0


@contextlib.contextmanager
def force_route(route: str | None):
    """Pin the execution route for this thread: ``"segment"`` (one program
    per slice), ``"item"`` (per-entry interpretation), or None (defer to
    the env knob)."""
    if route not in (None, "segment", "item"):
        raise ValueError(f"unknown dispatch route {route!r}")
    prev = getattr(_ROUTE, "route", None)
    _ROUTE.route = route
    try:
        yield
    finally:
        _ROUTE.route = prev


# -- frame-identity boundaries -----------------------------------------------

def _swap_blocks(perm: list, tile_bits: int, k: int, hi) -> None:
    """Apply one frame relabeling to the symbolic qubit permutation: blocks
    ``[tile_bits-k, tile_bits)`` and ``[hi, hi+k)`` (``hi`` = tile_bits
    when None) exchange, as ``swap_bit_blocks`` does to the state."""
    lo = tile_bits - k
    hi = tile_bits if hi is None else hi
    for i in range(k):
        perm[lo + i], perm[hi + i] = perm[hi + i], perm[lo + i]


def _frame_swaps(f, a) -> list:
    """The (tile_bits, k, hi) relabelings a tape entry applies, in order."""
    from . import fusion
    if f is fusion._apply_pallas_run:
        run = a[0]
        return [(run.tile_bits, k, hi)
                for k, hi in ((run.load_swap_k, run.load_swap_hi),
                              (run.store_swap_k, run.store_swap_hi)) if k]
    if f is fusion._apply_frame_swap:
        fs = a[0]
        return [(fs.tile_bits, fs.k, fs.hi)]
    return []


def identity_boundaries(tape, nsv: int) -> list:
    """Indices ``i`` where the two-frame permutation is identity after
    ``tape[:i]`` -- the legal segment seams. Always includes 0; includes
    ``len(tape)`` iff the tape ends at identity (every fused plan does).
    Replays the frame symbolically from the PallasRun load/store swaps and
    standalone FrameSwaps; all other entries leave the frame untouched."""
    perm = list(range(nsv))
    ident = list(range(nsv))
    bounds = [0]
    for i, (f, a, _kw) in enumerate(tape):
        for tb, k, hi in _frame_swaps(f, a):
            _swap_blocks(perm, tb, k, hi)
        if perm == ident:
            bounds.append(i + 1)
    return bounds


def measurement_seams(tape) -> set:
    """Tape indices that MUST be segment cuts: the seam before and after
    each measurement site (an entry tagged ``_measurement_site``) and each
    host-bound entry (``circuits._capture_safe`` false), which a CUDA graph
    cannot hold and which therefore runs as an item of its own."""
    from .circuits import _capture_safe

    seams: set = set()
    for i, (f, _a, _kw) in enumerate(tape):
        if getattr(f, "_measurement_site", False) or not _capture_safe(f):
            seams.add(i)
            seams.add(i + 1)
    return seams


def segment_cuts(tape, nsv: int, max_items: int | None = None) -> list:
    """Greedy coarsest identity-aligned cut list ``[0, ..., len(tape)]``:
    each segment is the LARGEST boundary-to-boundary span of at most
    ``max_items`` tape entries (None = unbounded). A single
    boundary-to-boundary gap longer than ``max_items`` becomes its own
    segment (frames cannot be cut mid-flight). A tape that does not end at
    identity gets a final segment to ``len(tape)``. The seams of
    :func:`measurement_seams` force cuts where they are at frame identity
    (a seam mid-frame is skipped)."""
    if max_items is not None and max_items < 1:
        raise ValueError("max_items must be >= 1")
    bounds = identity_boundaries(tape, nsv)
    if bounds[-1] != len(tape):
        bounds.append(len(tape))
    forced = sorted(measurement_seams(tape) & set(bounds))
    cuts = [0]
    while cuts[-1] < len(tape):
        start = cuts[-1]
        fence = next((b for b in forced if b > start), None)
        nxt = [b for b in bounds if b > start and (fence is None or b <= fence)]
        if max_items is not None:
            capped = [b for b in nxt if b - start <= max_items]
            cuts.append(capped[-1] if capped else nxt[0])
        else:
            cuts.append(nxt[-1])
    return cuts


def stamp_plan(plan, nsv: int) -> int:
    """Stamp every frame-carrying plan item (PallasRun / FrameSwap) with the
    index of the frame-identity segment it belongs to (``item.seg``) and
    return the segment count. Indices advance exactly at identity
    returns."""
    from . import fusion
    perm = list(range(nsv))
    ident = list(range(nsv))
    seg = 0
    for item in plan.items:
        if isinstance(item, fusion.PallasRun):
            item.seg = seg
            if item.load_swap_k:
                _swap_blocks(perm, item.tile_bits, item.load_swap_k, item.load_swap_hi)
            if item.store_swap_k:
                _swap_blocks(perm, item.tile_bits, item.store_swap_k, item.store_swap_hi)
        elif isinstance(item, fusion.FrameSwap):
            item.seg = seg
            _swap_blocks(perm, item.tile_bits, item.k, item.hi)
        if perm == ident:
            seg += 1
    return seg


# -- segment programs --------------------------------------------------------

def _pieces(circuit, lo: int, hi: int, segment: int | None = None) -> list:
    """``tape[lo:hi]`` as Replays: one per capturable span between
    host-bound entries, and each host-bound entry an eager item. Under an
    explicit scheduler each piece is a deferred span (a host-bound entry
    is a barrier there, so the spans reconcile where the JAX package's one
    replay would); ``segment`` labels the first one in the journal, as
    the JAX package labels a segment program's replay."""
    from .circuits import _capture_safe

    tape = circuit._tape
    out, start = [], lo

    def label():
        return segment if not out else None

    for i in range(lo, hi + 1):
        if i < hi and _capture_safe(tape[i][0]):
            continue
        if start < i:
            out.append(circuit._replay(start, i, segment=label()))
        if i < hi:
            out.append(circuit._replay(i, i + 1, eager_only=True, route="item",
                                       segment=label()))
        start = i + 1
    return out


def slice_executable(circuit, lo: int, hi: int, donate: bool = True):
    """``tape[lo:hi]`` as ONE compiled executable -- the segment program
    (:class:`._capture.Executable`), cached in the process-global bounded
    LRU keyed on the circuit's tape revision and the slice."""
    from ._capture import Executable, Program
    from .engine import cache as _ec
    from .parallel import scheduler as _dist
    key = ("segment", circuit._exec_token(), lo, hi, donate, _dist.mode())

    def build():
        return Executable(Program([(None, _pieces(circuit, lo, hi, segment=lo))]), donate)

    return _ec.executables().get_or_create(key, build)


def run_slice(circuit, qureg, lo: int = 0, hi: int | None = None, *,
              donate: bool = True):
    """Execute ``tape[lo:hi]`` on ``qureg`` (mutates its amps).

    With segment dispatch on (:func:`segment_dispatch_enabled`), the slice
    runs as ONE segment program on the register's own buffers --
    ``device_dispatch_total{route="segment"}`` counts one launch. Otherwise
    each entry is applied eagerly and counts ``route="item"``."""
    hi = len(circuit._tape) if hi is None else hi
    if hi <= lo:
        return qureg
    if segment_dispatch_enabled():
        fn = slice_executable(circuit, lo, hi, donate=donate)
        telemetry.inc("device_dispatch_total", route="segment")
        fn.run_register(qureg)
    else:
        for f, a, kw in circuit._tape[lo:hi]:
            telemetry.inc("device_dispatch_total", route="item")
            f(qureg, *a, **kw)
    return qureg


def chain_executable(circuit, max_items: int | None = None, donate: bool = True):
    """The whole tape as a chain of segment programs (one per
    :func:`segment_cuts` span) sharing one spare buffer, behind
    ``Circuit.compiled_segments``. Calling the chain counts one
    ``device_dispatch_total{route="segment"}`` per capturable link and one
    ``route="item"`` per host-bound entry; ``num_segments`` is the link
    count."""
    from ._capture import Executable, Program
    from .circuits import _capture_safe
    from .engine import cache as _ec
    from .parallel import scheduler as _dist
    key = ("segment_chain", circuit._exec_token(), max_items, donate, _dist.mode())

    def build():
        nsv = (2 if circuit.is_density_matrix else 1) * circuit.num_qubits
        cuts = segment_cuts(circuit._tape, nsv, max_items)
        groups = []
        for a, b in zip(cuts, cuts[1:]):
            if b - a == 1 and not _capture_safe(circuit._tape[a][0]):
                groups.append((None, _pieces(circuit, a, b, segment=a)))
            else:
                groups.append(("segment", _pieces(circuit, a, b, segment=a)))
        exe = Executable(Program(groups), donate)
        exe.num_segments = len(groups)
        return exe

    return _ec.executables().get_or_create(key, build)


def request_executable(circuit, donate: bool = True, reduce=None):
    """The WHOLE request as ONE dispatched program: every frame-identity
    segment of the tape, plus an optional terminal ``reduce(amps, *extra)``
    (a probability readout, an expectation), composed into a single
    replay -- one CUDA graph on the card -- with the state buffer donated
    end to end. Calling it counts exactly ONE
    ``device_dispatch_total{route="request"}``; ``fn.num_segments``
    reports how many segments were composed, ``fn.num_dispatches = 1``.
    With ``reduce`` the executable returns reduce's output (extra runtime
    arguments are passed through: a tensor is copied into the graph's
    own buffer per call, anything else is part of the graph's key).
    A tape with a host-bound entry has no one-dispatch program and
    raises."""
    from ._capture import Executable, Program
    from .circuits import _capture_safe
    from .engine import cache as _ec
    from .validation import QuESTError
    if getattr(reduce, "wants_values", False):
        raise QuESTError(
            "request_executable replays a concrete tape and has no "
            "parameter-values vector to hand a wants_values reduce (the "
            "gradient engine's grad_reduce); use Circuit.gradient / "
            "Engine.submit_grad, which compose it into the parameterized "
            "replay", "request_executable")
    bad = [getattr(f, "__name__", repr(f)) for f, _a, _kw in circuit._tape
           if not _capture_safe(f)]
    if bad:
        raise QuESTError(
            f"request_executable composes the tape into one program, and "
            f"{sorted(set(bad))} cannot be captured into it; use "
            "compiled_segments, which runs such entries as items",
            "request_executable")
    from .parallel import scheduler as _dist
    key = ("request_chain", circuit._exec_token(), donate, reduce, _dist.mode())

    def build():
        nsv = (2 if circuit.is_density_matrix else 1) * circuit.num_qubits
        bounds = identity_boundaries(circuit._tape, nsv)
        if bounds[-1] != len(circuit._tape):
            bounds.append(len(circuit._tape))
        bodies = tuple(circuit._replay_body(None, a, b, segment=a, pin=True)
                       for a, b in zip(bounds, bounds[1:]))

        def whole(shell, *extra, _bodies=bodies, _reduce=reduce):
            for body in _bodies:
                body(shell)
            if _reduce is None:
                return None
            return _reduce(shell.amps if shell.shards is None else list(shell.shards),
                           *extra)

        from ._capture import Replay
        piece = Replay(whole, circuit.num_qubits, circuit.is_density_matrix)
        exe = Executable(Program([(None, [piece])]), donate, route="request",
                         returns_state=reduce is None)
        exe.num_segments = len(bodies)
        exe.num_dispatches = 1
        return exe

    return _ec.executables().get_or_create(key, build)
