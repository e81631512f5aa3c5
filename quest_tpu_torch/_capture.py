"""Compiled execution: a replay body run eagerly, or captured into CUDA
graphs and replayed.

``Circuit.compiled`` and its kin (:mod:`.circuits`, :mod:`.segments`)
build a :class:`Program` here: a list of pieces, each a :class:`Replay` of
a tape slice. The JAX package traces such a slice into one XLA program;
the port's counterpart on the card is a CUDA graph of the eager replay.

- **On a CPU state** a Replay runs its body eagerly on every call, through
  the kernels' plain versions: the compiled routes are the cached eager
  replay. That is how the tests run them.
- **On a CUDA state** its first run is eager, on the caller's buffers: it
  loads the kernel libraries, builds the runs' device tables and stages
  every host constant the body sends to the card (:func:`to_device`) into
  a table the Replay keeps. It captures nothing then, so a call made once
  holds no graph. A later call whose buffers have no graph yet captures
  the piece into a ``torch.cuda.CUDAGraph`` for them, with the staging
  table frozen and the host guard on (a host array that reaches the card,
  a ``.item()``, a ``.cpu()`` or a host test of a tensor inside a capture
  raises :class:`CaptureError`, as does any other capture failure; nothing
  falls back to an eager run), and replays it; a call whose buffers have a
  graph is one ``graph.replay()``.

**Buffers.** A body runs on a shell register around a state buffer X and
its spare S of the same size (a tuple of shard tensors each, on a sharded
state), where every pass with a folded frame swap, every frame swap and
every collective permute writes out of place. A run ends with the result
in X or S (:func:`_settle`), which a capture fixes; a result elsewhere (an
engine entry allocates) is copied into X inside the graph, so a register
or caller never holds memory of a graph's pool. Graphs are keyed on the
buffers' addresses, shapes and dtypes: they touch nothing else but their
pool, the staged constants and the static buffers their Replay owns. A
Replay keeps at most :data:`MAX_GRAPHS` graphs, all in one private memory
pool (every pool allocation is dead when a capture ends, so the graphs may
replay in any order), and :meth:`Replay.close` frees them
(``graph.reset()``): the executable cache calls it on eviction, and when
the tape revision it was made for changes or its Circuit is collected.

**Counting** (:mod:`.telemetry`): a capture records what its body added to
the telemetry counters, takes it back, and every replay adds it again. The
kernels' launch counts (``fused_run.launches``, ``window_dot.launches``)
move only where a wrapper launches its kernel: a capture records launches
without running them, so it takes their increments back too, and a replay
adds nothing to them (what a replay launches is read from its graph's
kernel nodes, which each graph keeps readable).

A mesh that spans two or more cards is not captured: it raises
:class:`NotImplementedError` (ROADMAP A, item 9).
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from . import telemetry

#: graphs one Replay keeps: a loop that ping-pongs between two buffers
#: needs two
MAX_GRAPHS = 4


class CaptureError(RuntimeError):
    """A replay body did something a CUDA graph cannot hold (a host copy or
    sync), or the capture failed."""


_tls = threading.local()


class _Staging:
    """Host constants staged on their devices, keyed by content."""

    __slots__ = ("tensors", "frozen")

    def __init__(self):
        self.tensors: dict = {}
        self.frozen = False


@contextlib.contextmanager
def _staged(table: _Staging, frozen: bool):
    prev = getattr(_tls, "staging", None)
    table.frozen = frozen
    _tls.staging = table
    try:
        yield
    finally:
        _tls.staging = prev
        table.frozen = False


def to_device(host, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.as_tensor(host, dtype=dtype, device=device)`` for a host
    array, staged: inside a Replay's body the copy is made once, at its
    eager run, and kept with the Replay by content; inside a capture a
    constant that was not staged raises :class:`CaptureError`. Every host
    array the capturable routes send to a device goes through here."""
    st = getattr(_tls, "staging", None)
    if st is None:
        return torch.as_tensor(host, dtype=dtype, device=device)
    a = np.ascontiguousarray(host)
    dev = torch.device(device)
    key = (a.shape, a.dtype.str, hashlib.sha1(a.tobytes()).digest(), dtype, str(dev))
    t = st.tensors.get(key)
    if t is None:
        if st.frozen:
            raise CaptureError(
                f"a host array of shape {a.shape} reached {dev} inside a capture: "
                "it was not staged by the replay's eager run")
        t = st.tensors[key] = torch.as_tensor(a, dtype=dtype, device=dev)
    return t


def _host_calls() -> dict:
    T = torch.Tensor
    return {torch.tensor: "torch.tensor", torch.as_tensor: "torch.as_tensor",
            T.item: ".item()", T.tolist: ".tolist()", T.numpy: ".numpy()",
            T.cpu: ".cpu()", T.cuda: ".cuda()", T.__bool__: "bool(tensor)",
            T.__float__: "float(tensor)", T.__int__: "int(tensor)",
            T.__index__: "a tensor used as an index", torch.equal: "torch.equal",
            torch.allclose: "torch.allclose"}


class _HostGuard(torch.overrides.TorchFunctionMode):
    """Raises at any call that copies host data to a device or waits for
    the device: what a CUDA graph cannot capture."""

    def __init__(self):
        super().__init__()
        self.calls = _host_calls()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        what = self.calls.get(func)
        if what is not None:
            raise CaptureError(f"{what} inside a capture: a host copy or a host "
                               "sync cannot be captured")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def rehearsal():
    """On this thread, run every CPU Replay that has had its eager run as
    the card captures it: staging frozen and the host guard on. The tests
    use it to prove on the CPU that a body is capturable."""
    prev = getattr(_tls, "rehearse", False)
    _tls.rehearse = True
    try:
        yield
    finally:
        _tls.rehearse = prev


def _launch_counters() -> tuple:
    from .ops.fused_gates import fused_run
    from .ops.window_dot import window_dot
    return (fused_run, window_dot)


def _counts() -> tuple:
    return telemetry.counters(), tuple(f.launches for f in _launch_counters())


def _restore(saved: tuple) -> None:
    telemetry.restore(saved[0])
    for f, n in zip(_launch_counters(), saved[1]):
        f.launches = n


def _same(t: torch.Tensor, buf: torch.Tensor) -> bool:
    return (t.data_ptr() == buf.data_ptr() and t.shape == buf.shape
            and t.is_contiguous())


def _shares(t: torch.Tensor, buf: torch.Tensor) -> bool:
    return t.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()


def _settle(shell, xs: tuple, ss: tuple) -> tuple:
    """(result, other): where the body left the state, as buffers of the
    pair (X, S) shard by shard. A result in neither is copied into the one
    it does not share storage with."""
    res = (shell.amps,) if shell.shards is None else tuple(shell.shards)
    if len(res) != len(xs):
        raise ValueError(f"the replay left {len(res)} pieces of state, not {len(xs)}")
    result, other = [], []
    for r, x, s in zip(res, xs, ss):
        if _same(r, x):
            result.append(x)
            other.append(s)
        elif _same(r, s):
            result.append(s)
            other.append(x)
        else:
            dst, spare = (s, x) if _shares(r, x) else (x, s)
            dst.copy_(r.reshape(dst.shape))
            result.append(dst)
            other.append(spare)
    return tuple(result), tuple(other)


def _check_one_card(xs: tuple) -> None:
    cards = {t.device for t in xs}
    if len(cards) > 1:
        raise NotImplementedError(
            f"a compiled route over a mesh of {len(cards)} cards is not captured yet "
            "(ROADMAP A, item 9): one card, or virtual shards of one card, only")


def _clone_out(out):
    """A reduce's output (a tensor, or a dict, tuple or list of them) with
    every tensor cloned out of the graph's buffers."""
    if out is None or isinstance(out, torch.Tensor):
        return None if out is None else out.clone()
    if isinstance(out, dict):
        return {k: _clone_out(v) for k, v in out.items()}
    return type(out)(_clone_out(o) for o in out)


class _Graph:
    __slots__ = ("graph", "result", "other", "out", "moves", "extra", "seconds",
                 "bytes")


class Replay:
    """One piece of a :class:`Program`: ``body(shell, *extra)`` applies a
    tape slice to the shell register and returns None, or the output of a
    terminal ``reduce``. ``eager_only`` pieces (host-bound entries) are
    never captured. ``on_build`` is called at the eager run and at every
    capture. ``route`` labels the piece's dispatches
    (``device_dispatch_total``) where it is a program of its own."""

    def __init__(self, body, num_qubits: int, is_density: bool, *,
                 eager_only: bool = False, on_build=None, route: str | None = None):
        self.body = body
        self.num_qubits = int(num_qubits)
        self.is_density = bool(is_density)
        self.eager_only = eager_only
        self.on_build = on_build
        self.route = route
        self.staging = _Staging()
        self.graphs: OrderedDict = OrderedDict()
        self.pool = None
        #: the state signatures (dtype, device, shapes) run eagerly so far:
        #: a capture needs the constants an eager run of its signature staged
        self.warmed: set = set()
        #: (seconds, bytes of device memory reserved) of each capture
        self.captures: list = []
        self._busy = 0
        self._close_after = False

    def close(self) -> None:
        """Free the graphs, their pool and the staged constants (after the
        run in progress, when called from inside one)."""
        if self._busy:
            self._close_after = True
            return
        if self.graphs:
            torch.cuda.synchronize(next(iter(self.graphs.values())).result[0].device)
        for g in self.graphs.values():
            g.graph.reset()
        self.graphs.clear()
        self.staging.tensors.clear()
        self.pool = None
        self.warmed.clear()

    @staticmethod
    def signature(xs: tuple) -> tuple:
        return (len(xs), xs[0].dtype, str(xs[0].device), tuple(xs[0].shape))

    def _shell(self, xs, ss, env):
        from .registers import Qureg
        if len(xs) == 1:
            return Qureg(self.num_qubits, self.is_density, xs[0], env, spare=ss[0])
        return Qureg(self.num_qubits, self.is_density, None, env, shards=list(xs),
                     shard_spares=list(ss))

    @staticmethod
    def _key(xs, ss, extra) -> tuple:
        return (tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in xs),
                tuple(t.data_ptr() for t in ss),
                tuple(("t", tuple(e.shape), e.dtype) if isinstance(e, torch.Tensor)
                      else ("v", e) for e in extra))

    def run(self, xs: tuple, ss: tuple, env=None, extra: tuple = ()) -> tuple:
        """(result buffers, other buffers, output) of one run on state
        buffers ``xs`` and spares ``ss``."""
        self._busy += 1
        try:
            return self._run(xs, ss, env, extra)
        finally:
            self._busy -= 1
            if not self._busy and self._close_after:
                self._close_after = False
                self.close()

    def _run(self, xs, ss, env, extra) -> tuple:
        if self.route is not None:
            telemetry.inc("device_dispatch_total", route=self.route)
        warm = self.signature(xs) in self.warmed
        if xs[0].device.type != "cuda" or self.eager_only or not warm:
            frozen = warm and not self.eager_only and getattr(_tls, "rehearse", False)
            return self._eager(xs, ss, env, extra, frozen)
        _check_one_card(xs)
        key = self._key(xs, ss, extra)
        g = self.graphs.get(key) or self._capture(xs, ss, env, extra, key)
        self.graphs.move_to_end(key)
        for static, e in zip(g.extra, extra):
            if isinstance(e, torch.Tensor):
                static.copy_(e)
        g.graph.replay()
        telemetry.add(g.moves)
        return g.result, g.other, _clone_out(g.out)

    def _eager(self, xs, ss, env, extra, frozen: bool) -> tuple:
        shell = self._shell(xs, ss, env)
        with _staged(self.staging, frozen), \
                (_HostGuard() if frozen else contextlib.nullcontext()):
            out = self.body(shell, *extra)
            result, other = _settle(shell, xs, ss)
        sig = self.signature(xs)
        if sig not in self.warmed:
            self.warmed.add(sig)
            if self.on_build is not None and not self.eager_only:
                self.on_build()
        return result, other, out

    def _capture(self, xs, ss, env, extra, key) -> _Graph:
        dev = xs[0].device
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        g = _Graph()
        # keep_graph: the graph's nodes stay readable after instantiation, so
        # the kernels a replay launches can be listed (``debug_dump``)
        g.graph = torch.cuda.CUDAGraph(keep_graph=True)
        g.extra = tuple(e.clone() if isinstance(e, torch.Tensor) else e for e in extra)
        saved = _counts()
        shell = self._shell(xs, ss, env)
        t0 = time.perf_counter()
        try:
            with _staged(self.staging, True), torch.cuda.device(dev), \
                    torch.cuda.graph(g.graph, pool=self.pool):
                with _HostGuard():
                    g.out = self.body(shell, *g.extra)
                    g.result, g.other = _settle(shell, xs, ss)
            g.graph.instantiate()
        except Exception as e:
            _restore(saved)
            raise CaptureError(f"capturing the replay into a CUDA graph failed: "
                               f"{type(e).__name__}: {e}") from e
        torch.cuda.synchronize(dev)
        g.seconds = time.perf_counter() - t0
        g.moves = telemetry.delta(saved[0], telemetry.counters())
        _restore(saved)
        g.bytes = torch.cuda.memory_reserved(dev) - reserved
        self.captures.append((g.seconds, g.bytes))
        self.graphs[key] = g
        while len(self.graphs) > MAX_GRAPHS:  # the stream is idle: synchronized above
            self.graphs.popitem(last=False)[1].graph.reset()
        if self.on_build is not None:
            self.on_build()
        return g


class Program:
    """Pieces run in order on one state: ``groups`` is a list of (route,
    [Replay, ...]); a group with a route counts one
    ``device_dispatch_total{route}`` per run (a segment of a chain, a
    block), a piece with its own route one per piece. ``extra`` goes to
    the last piece (the terminal reduce)."""

    def __init__(self, groups: list):
        self.groups = [(route, list(pieces)) for route, pieces in groups]

    @property
    def pieces(self) -> list:
        return [p for _, ps in self.groups for p in ps]

    @property
    def captures(self) -> list:
        return [c for p in self.pieces for c in p.captures]

    def close(self) -> None:
        for p in self.pieces:
            p.close()

    def run(self, xs: tuple, ss: tuple, env=None, extra: tuple = ()) -> tuple:
        """One run from (``xs``, ``ss``): (result, other, output)."""
        last = self.pieces[-1] if self.pieces else None
        out = None
        for route, pieces in self.groups:
            if route is not None:
                telemetry.inc("device_dispatch_total", route=route)
            for p in pieces:
                xs, ss, out = p.run(xs, ss, env, extra if p is last else ())
        return xs, ss, out


def _as_bufs(amps) -> tuple[tuple, bool]:
    if isinstance(amps, (list, tuple)):
        return tuple(amps), True
    return (amps,), False


def _fresh_like(xs: tuple, have) -> tuple:
    if have is not None and len(have) == len(xs) and all(
            h.shape == x.shape and h.dtype == x.dtype and h.device == x.device
            for h, x in zip(have, xs)):
        return have
    return tuple(torch.empty_like(x) for x in xs)


class Executable:
    """A :class:`Program` as ``fn(amps, *extra)``: ``amps`` is a planar
    state tensor, or a list of a sharded state's shard tensors. With
    ``donate`` the input's buffers may be consumed: the result is the
    input buffer or the executable's spare, and the other becomes the
    spare, so ``amps = fn(amps)`` copies no state. Without it the input is
    copied into the executable's own work buffer and the result is a new
    tensor, so the input and earlier results stay valid. A program with a
    terminal reduce returns the reduce's output instead of the state.
    :meth:`run_register` runs on a register's own buffers (its state and
    spare). ``num_segments`` and ``num_dispatches`` are set where it is
    made (``segments``)."""

    def __init__(self, program: Program, donate: bool = True, *,
                 route: str | None = None, returns_state: bool = True):
        self.program = program
        self.donate = bool(donate)
        self.route = route
        self.returns_state = returns_state
        self._spare = None
        self._work = None

    @property
    def captures(self) -> list:
        """(seconds, device bytes) of every capture made so far."""
        return self.program.captures

    def close(self) -> None:
        self.program.close()
        self._spare = self._work = None

    def __call__(self, amps, *extra):
        xs, sharded = _as_bufs(amps)
        if self.route is not None:
            telemetry.inc("device_dispatch_total", route=self.route)
        if self.donate:
            spare = _fresh_like(xs, self._spare)
            if any(_shares(x, s) for x, s in zip(xs, spare)):
                spare = tuple(torch.empty_like(x) for x in xs)
            rs, os_, out = self.program.run(xs, spare, None, extra)
            self._spare = os_
        else:
            self._work = _fresh_like(xs + xs, self._work)
            w, s = self._work[:len(xs)], self._work[len(xs):]
            for dst, x in zip(w, xs):
                dst.copy_(x)
            rs, os_, out = self.program.run(w, s, None, extra)
            if self.returns_state:
                rs = tuple(r.clone() for r in rs)
        if not self.returns_state:
            return out
        return list(rs) if sharded else rs[0]

    def run_register(self, qureg) -> None:
        """Run on ``qureg`` in place of its state, its spare buffer(s) the
        spare: no state is copied."""
        if qureg.shards is not None:
            xs, ss = tuple(qureg.shards), tuple(qureg.shard_spare_buffers())
        else:
            xs, ss = (qureg.amps,), (qureg.spare_buffer(),)
        rs, os_, _ = self.program.run(xs, ss, qureg.env)
        if qureg.shards is not None:
            qureg.shards, qureg.shard_spares = list(rs), list(os_)
        else:
            qureg.amps, qureg.spare = rs[0], os_[0]
