"""Micro-batched serving of parameterized circuits (``quest_tpu/engine/engine.py``).

Many requests that are *variants of one circuit structure* (a VQE/QAOA
parameter sweep, or many users sending the same ansatz with their own
angles) arrive at once. Three mechanisms make them cheap:

- **One executable, many parameter vectors**: the engine replays its
  circuit with the lifted values as runtime values
  (:meth:`~quest_tpu_torch.circuits.Circuit.parameterized`'s body), so a
  warm submit captures nothing: values are loaded into the buffer the
  graph reads.
- **Micro-batching**: ``submit(params)`` returns a
  :class:`concurrent.futures.Future` at once; a batcher thread coalesces
  pending requests up to ``max_batch`` within ``max_delay_ms`` and
  dispatches them together. On one device every dispatch is ONE padded
  lane-batched replay: ``torch.func.vmap`` of the replay body over a
  (max_batch, 2, 2^n) batch, captured once as a CUDA graph. Each static
  run of a fused plan is then one launch of the fused-run kernel for all
  lanes (its batching rule, ``ops.fused_gates.fused_run_lanes``), and the
  Param barriers between the runs are torch ops on each lane's own
  values. A short batch is padded to ``max_batch`` with the last request's
  values, so one graph serves every batch, and a request computes the same
  bits whether or not it was coalesced. A sharded env (a state vector or
  a density register over the mesh) replays the requests of a batch in
  sequence instead, through ``Circuit.parameterized``, whose program runs
  on the shards: a ``finalize`` (a shot table, an expectation, the
  adjoint gradient) takes the list of shards and returns its output on
  the first shard's device.
- **Executable reuse across structures**: both executables come from the
  process-global LRU (:mod:`.cache`) at every dispatch, keyed by the
  circuit's structure fingerprint: a second Engine over a structure-equal
  circuit builds nothing (``plan_cache_hit_total``).

Telemetry (:mod:`quest_tpu_torch.telemetry`): ``engine_requests_total``,
``engine_batches_total{mode=vmap|sequential}``, the ``engine_batch_size``
and ``engine_request_latency_seconds`` histograms, the
``engine_queue_depth`` gauge, ``engine_trace_total{kind=param_replay}``
(one per build of a replay: its eager run and each capture).

Failure semantics:

- **Deadlines**: ``submit(params, timeout=)``; a request still queued past
  it resolves with :class:`~quest_tpu_torch.resilience.QuESTTimeoutError`
  (``engine_request_timeouts_total``).
- **Backpressure**: the queue is bounded (``queue_max`` /
  ``QUEST_ENGINE_QUEUE_MAX``); a full queue raises
  :class:`~quest_tpu_torch.resilience.QuESTBackpressureError` at submit,
  ``reason="queue"`` (``engine_backpressure_total``).
- **Poisoned-batch bisection**: a failed batch is bisected through the SAME
  padded executable (``engine_bisections_total``): healthy requests
  complete with the same bits, each poisoned request gets its own
  exception. The ``engine.request`` fault site pins injected poison to a
  request at submit.
- **Typed cancellation**: ``close(drain=False)`` resolves queued futures
  with :class:`~quest_tpu_torch.resilience.QuESTCancelledError`.

Health: :meth:`health` is ``healthy``, ``degraded`` or ``quarantined``. A
sentinel breach on a result (``QUEST_SENTINEL`` armed: the corrupt result
is never served, its future gets a QuESTIntegrityError) degrades the
engine; a second breach, or a watchdog deadline around a dispatch
(``QUEST_WATCHDOG_MS``, QuESTHangError), quarantines it. A quarantined
engine rejects submits (``QuESTBackpressureError``, ``reason=
"quarantined"``) until :meth:`revive`; three clean dispatches heal
``degraded``. Transitions count ``engine_health_transitions_total{from,to}``.

Dispatch is synchronous: the batcher issues a batch on the card's
current stream, waits for the stream, records the dispatch in the health
state and then resolves its lanes' futures, before it coalesces the
next. The JAX package's completion ring (``async_depth`` /
``QUEST_ASYNC_DEPTH``: batch k+1 coalesced while k runs) is not ported:
on the card it served no stream faster, and the argument is accepted and
ignored.

A served lane is a copy of its lane of the graph's buffer, made on the
stream right after the run (padding lanes are not copied), so no later
replay overwrites a result already served.

Lifecycle: construct, optionally :meth:`warmup`, ``submit``/``run``, then
:meth:`close`, which drains the queue (every accepted future resolves)
and joins the batcher. The engine is also a context manager.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future

import torch

from .. import telemetry
from ..resilience import faultinject as _faults
from ..resilience import sentinel as _sentinel
from ..resilience import sync as _sync
from ..resilience import watchdog as _watchdog
from ..resilience.errors import (PoisonedRequestFault, QuESTBackpressureError,
                                 QuESTCancelledError, QuESTHangError,
                                 QuESTIntegrityError, QuESTTimeoutError,
                                 TransientFault)
from . import cache as _cache
from .params import BoundValues, bind_host, stack_values, value_index

__all__ = ["Engine", "HEALTH_STATES"]

#: engine health states, healthiest first
HEALTH_STATES = ("healthy", "degraded", "quarantined")

#: consecutive clean dispatches that heal ``degraded``
_HEAL_STREAK = 3

_QUEUE_ENV_WARNED: set = set()


def _env_queue_max() -> int:
    """``QUEST_ENGINE_QUEUE_MAX`` (0 or unset: unbounded); a malformed value
    is unbounded with a QT303 finding."""
    from ..resilience.findings import env_int
    return env_int("QUEST_ENGINE_QUEUE_MAX", 0, minimum=0, code="QT303",
                   warned=_QUEUE_ENV_WARNED, noun="engine queue bound")


class _Request:
    """One queued parameter set: its host values, the caller's future, the
    enqueue time, an optional deadline and the injected poison pinned at
    submit (None on a healthy request)."""

    __slots__ = ("values", "fut", "t0", "deadline", "poison")

    def __init__(self, values: tuple, fut: Future, t0: float,
                 deadline: float | None, poison: str | None):
        self.values = values
        self.fut = fut
        self.t0 = t0
        self.deadline = deadline
        self.poison = poison


class _BatchFn:
    """The batch executable: ``torch.func.vmap`` of the replay body over a
    (B, 2, 2^n) batch and the stacked values, as ONE compiled program
    (``_capture``: eager at its first call, a CUDA graph captured at the
    second and replayed after on the card; the eager replay on the CPU).
    ``engine_trace_total{kind=param_replay}`` counts its builds. It owns the
    batch buffer the program runs on (the initial state is copied into
    each lane before a run) and a one-element stand-in for the spare, which
    no lane uses. A call returns the first ``count`` lanes as copies, made
    on the stream right after the run, so that no later replay overwrites
    a result already served (with a ``finalize``: its output's lanes).

    One ``_BatchFn`` serves every Engine over a structure-equal circuit
    (the executable LRU), and its buffers, the graph's value tensors and
    its staging are shared state: a call holds the executable's lock from
    the copy-in to the lane copies. The card runs what was issued in order
    on its stream, so each call's lanes are its own."""

    def __init__(self, circuit, lifted, finalize):
        from .._capture import Program, Replay

        body = circuit._replay_fn(lifted)
        index = value_index(lifted)
        kinds = tuple(dict.fromkeys(kind for kind, _ in index))
        self._kinds = kinds

        wants_values = getattr(finalize, "wants_values", False)

        def lane(amps, *tensors):
            values = BoundValues(dict(zip(kinds, tensors)), index)
            out = body(amps, values)
            if finalize is None:
                return out
            # a values-aware finalize (the adjoint gradient) re-assembles
            # the daggered gates from the lane's own values
            return finalize(out, values) if wants_values else finalize(out)

        def run(shell, *tensors):
            out = torch.func.vmap(lane)(shell.amps, *tensors)
            if finalize is not None:
                return out
            shell.put(out)
            return None

        piece = Replay(run, circuit.num_qubits, circuit.is_density_matrix,
                       on_build=lambda: telemetry.inc("engine_trace_total",
                                                      kind="param_replay"))
        self.program = Program([(None, [piece])])
        self._finalize = finalize
        self._bufs = None
        self._lock = threading.RLock()

    @property
    def captures(self) -> list:
        """(seconds, device bytes) of every capture made so far."""
        return self.program.captures

    def close(self) -> None:
        with self._lock:
            self.program.close()
            self._bufs = None

    def __call__(self, initial: torch.Tensor, values: BoundValues, count: int) -> list:
        shape = (values.lanes,) + tuple(initial.shape)
        with self._lock:
            bufs = self._bufs
            if (bufs is None or bufs[0].shape != shape or bufs[0].dtype != initial.dtype
                    or bufs[0].device != initial.device):
                bufs = self._bufs = (
                    torch.empty(shape, dtype=initial.dtype, device=initial.device),
                    torch.empty(1, dtype=initial.dtype, device=initial.device))
            bufs[0].copy_(initial.expand(shape))
            rs, _, out = self.program.run(bufs[:1], bufs[1:], None,
                                          tuple(values.tensors[k] for k in self._kinds))
            if self._finalize is not None:
                return [_lane(out, i) for i in range(count)]
            return [rs[0][i].clone() for i in range(count)]


def _lane(out, i: int):
    """Lane ``i`` of a batch result: a tensor, or a dict, tuple or list of
    them (a ``finalize`` output)."""
    if isinstance(out, torch.Tensor):
        return out[i]
    if isinstance(out, dict):
        return {k: _lane(v, i) for k, v in out.items()}
    return type(out)(_lane(v, i) for v in out)


class Engine:
    """Serving runtime for one circuit structure (see the module docstring).

    ``circuit`` is a raw or fused :class:`~quest_tpu_torch.circuits.Circuit`
    recorded with :class:`~quest_tpu_torch.engine.params.Param` placeholders
    (constant angles are lifted to runtime values too). ``env`` supplies
    the devices: None means ``createQuESTEnv()``, the card; a mesh of more
    than one device shards the state (a state vector or a density
    register) and replays batches in sequence.
    ``initial`` is ``"zero"``, ``"plus"`` or a planar (2, 2^nsv) array
    (on a sharded env also a list of its shards).
    ``finalize``, a function of the final state that ``torch.func.vmap``
    carries and that returns a tensor or a dict, tuple or list of them
    (a shot table: ``sampling.sample_reduce``), is composed into the
    program: futures then resolve to its output, and the sentinels and
    the corruption site are bypassed. A finalize with ``wants_values``
    (the adjoint gradient's) is called as ``finalize(state, values)``
    with the request's bound values, and a ``dispatch_route`` labels its
    dispatches. ``hamiltonian`` (a PauliHamil or a (pauli_codes,
    term_coeffs) pair) is the observable :meth:`submit_grad` serves. Both
    executables run without donating the caller's buffers (the graph's
    buffers are fixed, and the input and results are copied in and out):
    ``donate`` is kept for the JAX package's signature and is ignored, as
    is ``async_depth`` (dispatch is synchronous; see the module docstring).
    """

    def __init__(self, circuit, env=None, *, precision_code: int | None = None,
                 max_batch: int = 8, max_delay_ms: float = 2.0, initial="zero",
                 donate: bool = True, queue_max: int | None = None,
                 async_depth: int | None = None, finalize=None, hamiltonian=None):
        from ..environment import createQuESTEnv
        from ..ops import init as ops_init
        from ..precision import real_dtype
        from ..registers import sharded_over

        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_batch > 65535:
            raise ValueError(f"max_batch must be <= 65535 (the kernel's lane grid), "
                             f"got {max_batch}")
        if max_delay_ms < 0:
            raise ValueError(f"max_delay_ms must be >= 0, got {max_delay_ms}")
        if queue_max is None:
            queue_max = _env_queue_max()
        if queue_max < 0:
            raise ValueError(f"queue_max must be >= 0, got {queue_max}")
        if async_depth is not None and async_depth < 0:
            raise ValueError(f"async_depth must be >= 0, got {async_depth}")
        if env is None:
            env = createQuESTEnv()
        #: pending-queue bound; 0 = unbounded
        self.queue_max = int(queue_max)
        self.circuit = circuit
        self.env = env
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1e3
        self._finalize = finalize
        #: the dispatch route of a finalize that names one (grad_request)
        self._route = getattr(finalize, "dispatch_route", None)
        # the observable submit_grad serves; its companion gradient engine
        # (same ansatz, the gradient as finalize) is built at first use
        self._hamiltonian = hamiltonian
        self._precision_code = precision_code
        self._grad_companion = None
        self.dtype = real_dtype(precision_code)
        nsv = (2 if circuit.is_density_matrix else 1) * circuit.num_qubits
        self.num_amps = 1 << nsv
        #: True when batches replay in sequence over the sharded state
        self.sharded = sharded_over(env, self.num_amps)
        self.device = env.device

        if isinstance(initial, str):
            if initial == "zero":
                amps = (ops_init.shards_classical(self.num_amps, self.dtype, env.devices, 0)
                        if self.sharded else
                        ops_init.init_classical(self.num_amps, self.dtype, env.device, 0))
            elif initial == "plus":
                amps = (ops_init.shards_plus(self.num_amps, self.dtype, env.devices)
                        if self.sharded else
                        ops_init.init_plus(self.num_amps, self.dtype, env.device))
            else:
                raise ValueError(f"initial must be 'zero', 'plus' or an array, "
                                 f"got {initial!r}")
        elif self.sharded and isinstance(initial, (list, tuple)):
            # a sharded initial state as its shards (a companion engine's)
            amps = [torch.as_tensor(c, dtype=self.dtype, device=d)
                    for c, d in zip(initial, env.devices)]
            if len(amps) != env.num_ranks or sum(a.shape[-1] for a in amps) != self.num_amps:
                raise ValueError(f"initial shards do not hold (2, {self.num_amps}) over "
                                 f"{env.num_ranks} devices")
        else:
            amps = torch.as_tensor(initial, dtype=self.dtype, device=env.device)
            if tuple(amps.shape) != (2, self.num_amps):
                raise ValueError(f"initial amps shape {tuple(amps.shape)} != "
                                 f"(2, {self.num_amps})")
            if self.sharded:
                amps = [c.to(d) for c, d in zip(amps.chunk(env.num_ranks, dim=1),
                                                env.devices)]
        #: planar initial state (a list of shards when sharded)
        self.initial_amps = amps

        self._lifted = circuit.lifted()
        self.fingerprint = circuit.fingerprint()
        self._cv = _sync.Condition("engine.cv")
        self._q: deque = deque()
        self._open = True
        self._health = "healthy"
        self._breaches = 0
        self._clean_streak = 0
        self._dispatches = 0
        self._thread = threading.Thread(target=self._loop, name="quest-engine",
                                        daemon=True)
        self._thread.start()
        telemetry.event("engine.start", fingerprint=self.fingerprint[:12], nsv=nsv,
                        max_batch=self.max_batch, sharded=self.sharded,
                        params=len(self._lifted.param_names))

    # -- submission ---------------------------------------------------------

    @property
    def param_names(self) -> tuple:
        """Ordered Param names every submit must bind."""
        return self._lifted.param_names

    def submit(self, params: dict | None = None, timeout: float | None = None) -> Future:
        """Queue one parameter set; the Future resolves to the final planar
        (2, 2^nsv) state (a lane of a batch result; a list of shards when
        sharded). ``timeout`` (seconds) sets a deadline: a request still
        queued when it expires resolves with QuESTTimeoutError."""
        return self.submit_many([params], timeout=timeout)[0]

    def submit_many(self, params_list, timeout: float | None = None) -> list:
        """Queue several parameter sets at once (one lock hold), so that an
        idle engine coalesces them into one dispatch. Raises
        QuESTBackpressureError, accepting none of them, when the bounded
        queue cannot take the whole list. Bad params raise here."""
        if not params_list:
            return []
        if timeout is not None and timeout < 0:
            raise ValueError(f"timeout must be >= 0, got {timeout}")
        if not self._open:
            raise RuntimeError("Engine is closed")
        values_list = [bind_host(self._lifted, p) for p in params_list]
        futs = []
        with self._cv:
            if not self._open:
                raise RuntimeError("Engine is closed")
            if self._health == "quarantined":
                telemetry.inc("engine_backpressure_total", reason="quarantined")
                raise QuESTBackpressureError(
                    f"engine is quarantined ({self._breaches} integrity breach(es) "
                    f"recorded): rejecting {len(values_list)} request(s); "
                    "investigate, then revive()", "Engine.submit", reason="quarantined")
            if self.queue_max and len(self._q) + len(values_list) > self.queue_max:
                telemetry.inc("engine_backpressure_total", reason="queue")
                raise QuESTBackpressureError(
                    f"engine queue full ({len(self._q)} pending, queue_max="
                    f"{self.queue_max}): rejecting {len(values_list)} request(s)",
                    "Engine.submit", reason="queue")
            now = time.perf_counter()
            deadline = None if timeout is None else now + timeout
            for values in values_list:
                fut = Future()
                # injected poison pins to the request here, so the visit
                # count stays deterministic however the batcher coalesces
                poison = _faults.fire("engine.request") if _faults.enabled() else None
                self._q.append(_Request(values, fut, now, deadline, poison))
                futs.append(fut)
            telemetry.inc("engine_requests_total", len(futs))
            telemetry.set_gauge("engine_queue_depth", len(self._q))
            self._cv.notify_all()
        return futs

    def run(self, params: dict | None = None, timeout: float | None = None):
        """``submit(params).result(timeout)``."""
        return self.submit(params).result(timeout)

    # -- health -------------------------------------------------------------

    def health(self) -> str:
        """``healthy``, ``degraded`` or ``quarantined``."""
        with self._cv:
            return self._health

    def is_open(self) -> bool:
        """True until :meth:`close` begins."""
        with self._cv:
            return self._open

    def revive(self) -> str:
        """After a quarantine, the operator's acknowledgement: ``quarantined``
        becomes ``degraded`` (submits are taken again; ``healthy`` after
        three clean dispatches). A no-op in any other state. Returns the
        new state."""
        with self._cv:
            if self._health == "quarantined":
                self._transition("degraded", reason="revive")
                self._clean_streak = 0
            return self._health

    def _transition(self, to: str, *, reason: str) -> None:
        # callers hold self._cv
        if to == self._health:
            return
        telemetry.inc("engine_health_transitions_total", **{"from": self._health, "to": to})
        telemetry.event("engine.health", previous=self._health, state=to, reason=reason)
        self._health = to

    def _note_breach(self, *, hang: bool) -> None:
        with self._cv:
            self._clean_streak = 0
            if hang:
                # a wedged dispatch does not heal itself
                self._transition("quarantined", reason="hang")
                return
            self._breaches += 1
            self._transition("quarantined" if self._breaches >= 2 else "degraded",
                             reason="sentinel_breach")

    def _note_clean(self) -> None:
        with self._cv:
            if self._health != "degraded":
                return
            self._clean_streak += 1
            if self._clean_streak >= _HEAL_STREAK:
                self._breaches = 0
                self._transition("healthy", reason="clean_streak")

    def warmup(self, params: dict | None = None, timeout: float | None = None) -> "Engine":
        """Build the executable and, on the card, capture its graph (a single
        request, then a full batch), so that every later submit captures
        nothing. Named Params warm up at 0.0 unless ``params`` is given."""
        p = params if params is not None else {n: 0.0 for n in self.param_names}
        self.run(p, timeout)
        if self.max_batch > 1:
            for f in self.submit_many([p] * self.max_batch):
                f.result(timeout)
        return self

    # -- gradients ----------------------------------------------------------

    def grad_engine(self) -> "Engine":
        """The companion gradient engine: the same ansatz, env and batching
        knobs, finalized by the adjoint gradient (:mod:`..gradients`), so
        that T optimizer steps coalesce into ONE lane-batched forward +
        backward program, counted as ``route=grad_request``. Built at first
        use; needs ``hamiltonian=`` at construction."""
        from ..validation import QuESTError

        with self._cv:
            if self._grad_companion is not None:
                return self._grad_companion
            if self._hamiltonian is None:
                raise QuESTError(
                    "Engine.submit_grad needs the observable: construct the Engine with "
                    "hamiltonian=(pauli_codes, term_coeffs) or a PauliHamil",
                    "Engine.submit_grad")
        from ..gradients import grad_reduce

        red = grad_reduce(self.circuit, self._hamiltonian, dtype=self.dtype)
        eng = Engine(self.circuit, self.env, precision_code=self._precision_code,
                     max_batch=self.max_batch, max_delay_ms=self.max_delay_s * 1e3,
                     initial=self.initial_amps, queue_max=self.queue_max, finalize=red)
        with self._cv:
            if self._grad_companion is None:
                self._grad_companion, eng = eng, None
        if eng is not None:  # another thread built it first
            eng.close(drain=False)
        return self._grad_companion

    def submit_grad(self, params: dict | None = None,
                    timeout: float | None = None) -> Future:
        """Queue one optimizer step: a Future resolving to ``(value, grads)``
        -- E = <psi(theta)|H|psi(theta)> and the adjoint gradient as a
        Param name -> derivative dict (0-d tensors; slots sharing a Param
        summed). Warm steps capture nothing, and a coalesced batch is one
        dispatch."""
        eng = self.grad_engine()
        telemetry.inc("grad_requests_total")
        telemetry.inc("grad_slots_total", float(eng._finalize.num_slots))
        inner = eng.submit(params, timeout=timeout)
        fut: Future = Future()

        def chain(f, _fut=fut):
            exc = f.exception()
            if exc is not None:
                _sync.resolve_future(_fut, exception=exc, site="engine.submit_grad")
            else:
                out = f.result()
                _sync.resolve_future(_fut, result=(out["value"], out["grads"]),
                                     site="engine.submit_grad")

        inner.add_done_callback(chain)
        return fut

    def warmup_grad(self, params: dict | None = None,
                    timeout: float | None = None) -> "Engine":
        """Build and capture the gradient program ahead of traffic (the
        gradient counterpart of :meth:`warmup`)."""
        self.grad_engine().warmup(params, timeout)
        return self

    # -- lifecycle ----------------------------------------------------------

    def close(self, drain: bool = True, timeout: float | None = None) -> None:
        """Stop taking work and join the batcher. ``drain=True`` dispatches
        everything still queued first; ``drain=False`` resolves queued
        futures with QuESTCancelledError (in-flight work completes). A
        quarantined engine never drains. Every accepted future resolves."""
        dropped: list = []
        with self._cv:
            if drain and self._health == "quarantined":
                drain = False
            if not drain:
                while self._q:
                    dropped.append(self._q.popleft())
            self._open = False
            self._cv.notify_all()
        # resolve outside the lock: done callbacks may take other locks
        for req in dropped:
            exc = QuESTCancelledError("request dropped by Engine.close before dispatch",
                                      "Engine.close")
            _sync.resolve_future(req.fut, exception=exc, site="engine.close")
        if self._thread.is_alive() and self._thread is not threading.current_thread():
            _sync.join_thread(self._thread, timeout)
        if self._grad_companion is not None:
            self._grad_companion.close(drain=drain, timeout=timeout)
        telemetry.set_gauge("engine_queue_depth", 0)
        telemetry.event("engine.close", drained=drain)

    def __enter__(self) -> "Engine":
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close(drain=exc_type is None)
        return False

    # -- executables --------------------------------------------------------

    def _exec1(self):
        """The one-request parameterized executable, fetched from the global
        LRU at every dispatch (a warm dispatch counts
        ``plan_cache_hit_total``)."""
        return self.circuit.parameterized(donate=False, reduce=self._finalize)

    def _execB_key(self) -> tuple:
        """The executable LRU's key of :meth:`_execB` (the pool's
        precompiler probes it with the non-mutating ``peek``)."""
        return ("param_vmap", self.fingerprint, self.max_batch, self.dtype, self._finalize)

    def _execB(self) -> _BatchFn:
        """The lane-batched executable (one device): ONE program evolving
        ``max_batch`` states, every batch padded to that size."""
        circuit, lifted, finalize = self.circuit, self._lifted, self._finalize
        return _cache.executables().get_or_create(
            self._execB_key(), lambda: _BatchFn(circuit, lifted, finalize))

    # -- batcher ------------------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._q and self._open:
                    self._cv.wait()
                if not self._q:
                    return  # closed, and the queue is drained
                batch = [self._q.popleft()]
                deadline = time.perf_counter() + self.max_delay_s
                while len(batch) < self.max_batch:
                    if self._q:
                        batch.append(self._q.popleft())
                        continue
                    if not self._open:
                        break
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                telemetry.set_gauge("engine_queue_depth", len(self._q))
            live = self._expire(batch)
            if live:
                self._dispatch(live)

    def _expire(self, batch: list) -> list:
        """Resolve the requests whose deadline passed in the queue with
        QuESTTimeoutError; return the rest."""
        now = time.perf_counter()
        live = []
        for req in batch:
            if req.deadline is not None and now >= req.deadline:
                telemetry.inc("engine_request_timeouts_total")
                exc = QuESTTimeoutError(
                    f"request deadline expired after {now - req.t0:.3f}s in queue "
                    f"(timeout={req.deadline - req.t0:.3f}s)", "Engine.submit")
                _sync.resolve_future(req.fut, exception=exc, site="engine.expire")
            else:
                live.append(req)
        return live

    def _mode(self) -> str:
        # one device with batching: ALWAYS the padded lane-batched program,
        # a lone request too, so that every request runs in the same lane
        # of the same executable (a separate one-state program would not
        # share the batched ops' accumulation order); max_batch=1 opts out
        return ("vmap" if (not self.sharded and self.max_batch > 1 and self._lifted.slots)
                else "sequential")

    def _dispatch(self, batch: list) -> None:
        mode = self._mode()
        self._dispatches += 1
        telemetry.inc("engine_batches_total", mode=mode)
        telemetry.observe("engine_batch_size", len(batch))
        kind = _faults.fire("engine.dispatch") if _faults.enabled() else None
        # a dispatch the watchdog gave up on must not run late, on its
        # worker thread, beside the batcher's next one
        abandoned = threading.Event()
        # (future, result) of each lane that passed its gates; resolved
        # after the health bookkeeping, so that a caller holding its result
        # sees the health this dispatch left
        served: list = []

        def issue() -> None:
            if not abandoned.is_set():
                self._dispatch_one(batch, mode, served)

        try:
            if kind == "transient":
                # fails THIS batch before it reaches the device; the
                # bisection below re-dispatches it
                raise TransientFault("engine.dispatch", kind)
            _watchdog.watched(issue, site="engine.dispatch", hang=(kind == "hang"))
        except QuESTHangError as e:
            # no bisection: a wedged dispatch would wedge each half too
            abandoned.set()
            self._note_breach(hang=True)
            self._fail_batch(batch, e, site="engine.dispatch")
        except QuESTIntegrityError as e:
            self._note_breach(hang=False)
            self._serve(served)  # the lanes gated clean before the breach
            self._fail_batch(batch, e, site="engine.dispatch")
        except Exception:
            self._bisect(batch, mode)
        except BaseException as e:  # interpreter teardown must not hang waiters
            self._fail_batch(batch, e, site="engine.dispatch")
        else:
            self._note_clean()
            self._serve(served)
        now = time.perf_counter()
        for req in batch:
            telemetry.observe("engine_request_latency_seconds", now - req.t0)

    def _dispatch_one(self, batch: list, mode: str, served: list) -> None:
        """Run one batch on its route; append (future, result) to ``served``
        for each lane that passes its gates (nothing is resolved here)."""
        _sync.guard_blocking("engine.dispatch")
        if mode == "vmap":
            self._dispatch_vmap(batch, served)
        else:
            self._dispatch_sequential(batch, served)

    @staticmethod
    def _serve(served: list) -> None:
        for fut, res in served:
            _sync.resolve_future(fut, result=res, site="engine.dispatch")

    def _bisect(self, batch: list, mode: str) -> None:
        telemetry.inc("engine_bisections_total")
        if len(batch) == 1:
            req = batch[0]
            served: list = []
            try:
                self._dispatch_one(batch, mode, served)
            except BaseException as e:
                if req.poison is not None:
                    telemetry.inc("engine_poisoned_requests_total")
                _sync.resolve_future(req.fut, exception=e, site="engine.bisect")
            else:
                self._serve(served)
            return
        mid = len(batch) // 2
        for half in (batch[:mid], batch[mid:]):
            served = []
            try:
                self._dispatch_one(half, mode, served)
            except BaseException:
                self._bisect(half, mode)
            else:
                self._serve(served)

    def _sentinel_gate(self, amps):
        """Hold one result against the armed sentinels (one boolean when
        ``QUEST_SENTINEL`` is off); a breach raises QuESTIntegrityError
        before any future resolves with the corrupt state."""
        if self._finalize is not None or not _sentinel.enabled():
            return amps
        findings = _sentinel.check_amps(
            amps, density=self.circuit.is_density_matrix, n=self.circuit.num_qubits,
            tick=self._dispatches, where="engine.dispatch")
        if findings:
            raise QuESTIntegrityError(
                "dispatch result breached the integrity sentinels: "
                + "; ".join(f.code for f in findings), "Engine._dispatch",
                findings=findings)
        return amps

    def _maybe_corrupt(self, amps):
        if self._finalize is not None or not _faults.enabled():
            return amps
        from ..resilience import guard as _guard
        return _guard.corrupt_amps(amps)

    def _dispatch_sequential(self, batch: list, served: list) -> None:
        x = self._exec1()
        for req in batch:
            if req.poison is not None:
                raise PoisonedRequestFault("engine.request", req.poison)
            telemetry.inc("device_dispatch_total", route=self._route or "engine_param")
            values = stack_values(self._lifted, [req.values], self.device, stacked=False)
            res = self._maybe_corrupt(x.with_values(self.initial_amps, values))
            self._sentinel_gate(res)
            served.append((req.fut, res))

    def _dispatch_vmap(self, batch: list, served: list) -> None:
        for req in batch:
            # an injected poisoned request fails the whole batched program
            # (as one NaN-making parameter set would); _bisect isolates it
            if req.poison is not None:
                raise PoisonedRequestFault("engine.request", req.poison)
        # host-side assembly: the values stacked on the host, padded with
        # the last request's, one copy per slot kind to the device
        values = stack_values(self._lifted, [req.values for req in batch], self.device,
                              pad_to=self.max_batch)
        fnB = self._execB()
        telemetry.inc("device_dispatch_total", route=self._route or "engine_vmap")
        lanes = fnB(self.initial_amps, values, len(batch))
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        for lane, req in zip(lanes, batch):
            lane = self._maybe_corrupt(lane)
            self._sentinel_gate(lane)
            served.append((req.fut, lane))

    def _fail_batch(self, batch: list, exc, *, site: str) -> None:
        """Resolve every still-pending future of ``batch`` with ``exc``."""
        for req in batch:
            if not req.fut.done():
                _sync.resolve_future(req.fut, exception=exc, site=site)
