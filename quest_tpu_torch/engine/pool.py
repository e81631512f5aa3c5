"""Replica-pool serving: health-aware routing, quarantine drain and
failover, hedged dispatch, warm replacement replicas
(``quest_tpu/engine/pool.py``).

One :class:`~quest_tpu_torch.engine.engine.Engine` serves one circuit
structure from one batcher thread. :class:`EnginePool` is the front end of
many: it owns N replicas (each a lazily filled map of structure
fingerprint -> ``Engine``, all on the pool's one ``env``) and routes every
submit by three signals, in order:

1. **health** -- the replica's worst engine state and a pool-level
   override (``healthy`` routes before ``degraded``; ``quarantined``
   never routes);
2. **structure affinity** -- a request prefers a replica that already
   holds its structure's engine, and a new structure goes to the replica
   serving the fewest, so mixed traffic does not queue behind one
   batcher;
3. **load** -- least outstanding requests breaks ties.

Replicas over one structure share its executables (the process-global
LRU, :mod:`.cache`), so every replica serves the same bits, and a replica
that joins late captures nothing new.

Robustness:

- **Failover and quarantine drain**: when a replica quarantines (an engine
  sentinel breach, a watchdog hang, or an injected ``pool.replica``
  fault), the pool takes it out of rotation and closes its engines with
  ``drain=False``: every queued future resolves with a typed
  :class:`~quest_tpu_torch.resilience.QuESTCancelledError`, and the done
  callbacks re-dispatch those requests to healthy peers. No caller future
  is dropped, and the recovered results are the same bits (the same
  executable; a lane's result does not depend on its batch).
  ``pool_failovers_total{reason}``. A replacement replica is then built
  in the background and **warmed from the fingerprint manifest**
  (:meth:`EnginePool.warm_from_manifest`) BEFORE it joins the rotation:
  its first request builds nothing (``engine_trace_total{kind=
  param_replay}`` stays flat).
- **Admission**: every submit passes the per-tenant token buckets first
  (:mod:`.admission`: ``QuESTBackpressureError`` with ``reason="quota"``,
  a reserve for high priority, the ``admission_*_total`` counters).
  Admitted requests that find NO routable replica (mid-failover) park in
  priority-ordered queues (high drains first) instead of failing.
- **Ahead-of-demand warm-up**: the pool counts requests per structure;
  :meth:`EnginePool.precompile` ranks the manifest by that count and warms
  the most requested executables off the request path
  (``engine_precompile_total{outcome=warmed|cached|error}``; the warm
  probe is the LRU's non-mutating ``peek``, so ranking never changes the
  eviction order). ``precompile_ms`` > 0 runs it on a background thread.
- **Hedged dispatch** (``hedge_ms`` > 0): a request outstanding on a
  ``degraded`` replica past the hedge deadline is sent again to a healthy
  peer through :func:`~quest_tpu_torch.resilience.retry.call_with_retry`
  (site ``pool.hedge``, retrying on backpressure); the first completion
  wins and the loser's future is cancelled. Both compute the same bits, so
  hedging changes tail latency only.
  ``pool_hedges_total{outcome=issued|won_primary|won_hedge}``.

Env knobs (through :func:`~quest_tpu_torch.resilience.findings.env_int`;
a malformed value warns once with QT307): ``QUEST_POOL_REPLICAS``
(default 2), ``QUEST_HEDGE_MS`` (default 0 = off) and ``QUEST_TENANT_QPS``
(read by :mod:`.admission`).

Telemetry: ``pool_requests_total{tenant,priority}``,
``pool_routes_total{outcome=affinity|healthy|degraded|parked}``,
``pool_failovers_total{reason}``, ``pool_quarantines_total{reason}``,
``pool_replacements_total{reason}``, ``pool_hedges_total{outcome}``, the
``pool_request_latency_seconds`` histogram and the ``pool_replicas``
gauge, besides what the member engines count.

Locking: the pool condition ``pool.cv`` orders BEFORE every engine lock:
pool code may read engine health under the pool lock, but never holds an
engine lock while taking the pool lock (engine done callbacks run with no
engine lock held; ``Engine.close`` resolves cancelled futures after
releasing its lock). Futures resolve outside both
(:func:`~quest_tpu_torch.resilience.sync.resolve_future`, QT602 under
``QUEST_CONCHECK=1``).
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import deque
from concurrent.futures import Future

from .. import telemetry
from ..resilience import faultinject as _faults
from ..resilience import retry as _retry
from ..resilience import sync as _sync
from ..resilience.errors import (QuESTBackpressureError, QuESTCancelledError,
                                 QuESTHangError, QuESTIntegrityError, QuESTRetryError)
from .admission import PRIORITIES, AdmissionController
from .engine import Engine

__all__ = ["EnginePool"]

_RANK = {"healthy": 0, "degraded": 1, "quarantined": 2}
_STATES = ("healthy", "degraded", "quarantined")

#: replica-failure exception -> ``pool_failovers_total{reason}`` label;
#: anything NOT here (timeouts, poisoned requests, value errors) is a
#: REQUEST failure and goes to the caller instead of failing over
_FAILOVER_REASONS = (
    (QuESTCancelledError, "drain"),
    (QuESTHangError, "hang"),
    (QuESTIntegrityError, "integrity"),
    (QuESTBackpressureError, "backpressure"),
)

#: QT307 warn-once sets, one per knob
_REPLICAS_WARNED: set = set()
_HEDGE_WARNED: set = set()


def _env_replicas() -> int:
    from ..resilience.findings import env_int
    return env_int("QUEST_POOL_REPLICAS", 2, minimum=1, code="QT307",
                   warned=_REPLICAS_WARNED, noun="replica count")


def _env_hedge_ms() -> int:
    from ..resilience.findings import env_int
    return env_int("QUEST_HEDGE_MS", 0, minimum=0, code="QT307",
                   warned=_HEDGE_WARNED, noun="hedge deadline (ms)")


def _failover_reason(exc) -> str | None:
    for cls, reason in _FAILOVER_REASONS:
        if isinstance(exc, cls):
            return reason
    return None


class _PoolRequest:
    """One pool-level request: the caller's future and what a re-dispatch
    needs (circuit, params, tenant), with the failover and hedge
    bookkeeping (attempts, replicas failed on, engine futures in flight)."""

    __slots__ = ("circuit", "fingerprint", "params", "tenant", "priority", "fut",
                 "deadline", "t0", "attempts", "failed", "inner", "hedged",
                 "dispatched_at", "last_exc", "settled")

    def __init__(self, circuit, fingerprint, params, tenant, priority, deadline):
        self.circuit = circuit
        self.fingerprint = fingerprint
        self.params = params
        self.tenant = tenant
        self.priority = priority
        self.fut: Future = Future()
        self.deadline = deadline
        self.t0 = time.monotonic()
        self.attempts = 0
        self.failed: set = set()   # replica ids this request failed on
        self.inner: list = []      # (replica, engine future, is_hedge)
        self.hedged = False
        self.dispatched_at: float | None = None
        self.last_exc = None
        self.settled = False

    def remaining(self) -> float | None:
        if self.deadline is None:
            return None
        return max(0.0, self.deadline - time.monotonic())


class _Replica:
    """One pool member: fingerprint -> Engine, a pool-level state (a
    quarantine sticks after its engines are closed), and the outstanding
    requests that routing and hedging read."""

    __slots__ = ("id", "engines", "state", "in_rotation", "outstanding", "build_lock")

    def __init__(self, rid: int):
        self.id = rid
        self.engines: dict = {}
        self.state = "healthy"
        self.in_rotation = False
        self.outstanding: set = set()
        self.build_lock = _sync.Lock("pool.build")

    def health(self) -> str:
        """The worst of the pool-level state and every engine's health."""
        h = _RANK[self.state]
        for eng in self.engines.values():
            h = max(h, _RANK[eng.health()])
        return _STATES[h]


class EnginePool:
    """Health-aware replica pool over :class:`Engine` (module docstring).

    ``env`` (None: ``createQuESTEnv()``, the card) and the engine knobs
    (``max_batch``, ``max_delay_ms``, ``queue_max``, ``precision_code``,
    ``donate``, ``finalize``) are shared by every engine the pool builds.
    ``replicas`` defaults to ``QUEST_POOL_REPLICAS`` (2), ``hedge_ms`` to
    ``QUEST_HEDGE_MS`` (0 = off); ``admission`` takes a ready
    :class:`~quest_tpu_torch.engine.admission.AdmissionController` (else one
    is made from ``tenant_qps`` / ``QUEST_TENANT_QPS``).
    ``spawn_replacements=False`` turns off the replacement of quarantined
    replicas (for tests that count replicas exactly)."""

    def __init__(self, env=None, *, replicas: int | None = None, max_batch: int = 8,
                 max_delay_ms: float = 2.0, queue_max: int | None = None,
                 hedge_ms: float | None = None, tenant_qps: int | None = None,
                 admission=None, precision_code: int | None = None, donate: bool = True,
                 spawn_replacements: bool = True, precompile_ms: float = 0.0,
                 finalize=None):
        if replicas is None:
            replicas = _env_replicas()
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if hedge_ms is None:
            hedge_ms = _env_hedge_ms()
        if hedge_ms < 0:
            raise ValueError(f"hedge_ms must be >= 0, got {hedge_ms}")
        if precompile_ms < 0:
            raise ValueError(f"precompile_ms must be >= 0, got {precompile_ms}")
        if env is None:
            from ..environment import createQuESTEnv
            env = createQuESTEnv()
        self._env = env
        # finalize: futures resolve to finalize(final state) (a shot table)
        self._engine_kw = dict(max_batch=max_batch, max_delay_ms=max_delay_ms,
                               queue_max=queue_max, precision_code=precision_code,
                               donate=donate, finalize=finalize)
        self.hedge_s = float(hedge_ms) / 1e3
        self.admission = admission if admission is not None else AdmissionController(tenant_qps)
        self._spawn_replacements = bool(spawn_replacements)
        self._cv = _sync.Condition("pool.cv")
        self._replicas: list[_Replica] = []
        self._manifest: dict = {}          # fingerprint -> circuit
        # gradient traffic rides the same routing and failover under a
        # derived "grad:<ham>:<fp>" fingerprint whose engines are built
        # with the adjoint gradient as their finalize
        self._finalize_for: dict = {}
        self._freq: dict = {}              # fingerprint -> request count
        self._pending = {p: deque() for p in PRIORITIES}
        self._next_rid = 0
        self._closed = False
        self._max_attempts = max(3, int(replicas) + 2)
        self._workers: list[threading.Thread] = []
        for _ in range(int(replicas)):
            rep = _Replica(self._next_rid)
            self._next_rid += 1
            rep.in_rotation = True
            self._replicas.append(rep)
        telemetry.set_gauge("pool_replicas", int(replicas))
        self._hedge_thread = None
        if self.hedge_s > 0:
            self._hedge_thread = threading.Thread(target=self._hedge_loop,
                                                  name="quest-pool-hedge", daemon=True)
            self._hedge_thread.start()
        self.precompile_s = float(precompile_ms) / 1e3
        self._precompile_thread = None
        if self.precompile_s > 0:
            self._precompile_thread = threading.Thread(
                target=self._precompile_loop, name="quest-pool-precompile", daemon=True)
            self._precompile_thread.start()
        telemetry.event("pool.start", replicas=int(replicas), hedge_ms=float(hedge_ms),
                        precompile_ms=float(precompile_ms))

    # -- submission ---------------------------------------------------------

    def submit(self, circuit, params: dict | None = None, *, tenant: str = "default",
               priority: str = "normal", timeout: float | None = None) -> Future:
        """Admit and route one request: a Future resolving to the final
        planar state whichever replica (or how many failovers) served it."""
        return self.submit_many(circuit, [params], tenant=tenant, priority=priority,
                                timeout=timeout)[0]

    def submit_many(self, circuit, params_list, *, tenant: str = "default",
                    priority: str = "normal", timeout: float | None = None,
                    _fingerprint: str | None = None) -> list:
        """Admit ``len(params_list)`` requests at once (the quota sees one
        take), then route each on its own. ``_fingerprint`` (internal)
        overrides the routing key: :meth:`submit_grad` derives one per
        (structure, observable), so gradient engines never meet the plain
        replay engines of the same ansatz."""
        if priority not in PRIORITIES:
            raise ValueError(f"priority must be one of {PRIORITIES}, got {priority!r}")
        if not params_list:
            return []
        if timeout is not None and timeout < 0:
            raise ValueError(f"timeout must be >= 0, got {timeout}")
        with self._cv:
            if self._closed:
                raise RuntimeError("EnginePool is closed")
        self.admission.admit(tenant, priority, len(params_list))
        telemetry.inc("pool_requests_total", len(params_list), tenant=tenant,
                      priority=priority)
        fp = _fingerprint if _fingerprint is not None else circuit.fingerprint()
        with self._cv:
            self._manifest.setdefault(fp, circuit)
            self._freq[fp] = self._freq.get(fp, 0) + len(params_list)
        deadline = None if timeout is None else time.monotonic() + timeout
        futs = []
        for params in params_list:
            req = _PoolRequest(circuit, fp, params, tenant, priority, deadline)
            futs.append(req.fut)
            self._route(req)
        return futs

    def run(self, circuit, params: dict | None = None, **kw):
        """``submit(...).result()``."""
        return self.submit(circuit, params, **kw).result()

    # -- gradients ----------------------------------------------------------

    def submit_grad(self, circuit, params: dict | None = None, *, hamiltonian,
                    tenant: str = "default", priority: str = "normal",
                    timeout: float | None = None) -> Future:
        """Route one optimizer step across the pool: a Future resolving to
        ``(value, grads)`` from the adjoint gradient of ``circuit`` against
        ``hamiltonian`` (a PauliHamil or ``(pauli_codes, term_coeffs)``)."""
        return self.submit_grad_many(circuit, [params], hamiltonian=hamiltonian,
                                     tenant=tenant, priority=priority, timeout=timeout)[0]

    def submit_grad_many(self, circuit, params_list, *, hamiltonian,
                         tenant: str = "default", priority: str = "normal",
                         timeout: float | None = None) -> list:
        """Batch form of :meth:`submit_grad`: gradient requests take the
        ordinary admission, affinity and failover under a derived
        fingerprint, and coalesce into the replica's lane-batched
        ``route=grad_request`` program."""
        from ..gradients import grad_reduce
        from ..precision import real_dtype

        red = grad_reduce(circuit, hamiltonian,
                          dtype=real_dtype(self._engine_kw.get("precision_code")))
        ham_key = hashlib.sha1(repr(red.hamiltonian).encode()).hexdigest()[:12]
        gfp = f"grad:{ham_key}:{circuit.fingerprint()}"
        with self._cv:
            self._finalize_for[gfp] = red
        telemetry.inc("grad_requests_total", len(params_list))
        telemetry.inc("grad_slots_total", float(red.num_slots * len(params_list)))
        inner = self.submit_many(circuit, params_list, tenant=tenant, priority=priority,
                                 timeout=timeout, _fingerprint=gfp)
        outs = []
        for f in inner:
            fut: Future = Future()

            def _chain(src, _fut=fut):
                exc = src.exception()
                if exc is not None:
                    _sync.resolve_future(_fut, exception=exc, site="pool.submit_grad")
                else:
                    out = src.result()
                    _sync.resolve_future(_fut, result=(out["value"], out["grads"]),
                                         site="pool.submit_grad")

            f.add_done_callback(_chain)
            outs.append(fut)
        return outs

    # -- routing ------------------------------------------------------------

    def _select_locked(self, fingerprint, exclude=frozenset(), allow_degraded: bool = True):
        """The routing policy (pool lock held): healthiest first, then
        structure affinity, then least loaded; quarantined never routes."""
        best = best_key = None
        for rep in self._replicas:
            if not rep.in_rotation or rep.id in exclude:
                continue
            h = rep.health()
            if h == "quarantined" or (h == "degraded" and not allow_degraded):
                continue
            # the structure count before the id: a cold fingerprint lands on
            # the replica serving the fewest structures
            key = (_RANK[h], 0 if fingerprint in rep.engines else 1, len(rep.outstanding),
                   len(rep.engines), rep.id)
            if best_key is None or key < best_key:
                best, best_key = rep, key
        return best

    def _route(self, req: _PoolRequest) -> None:
        parked = cancel = False
        rep = None
        with self._cv:
            if self._closed:
                cancel = True
            else:
                rep = self._select_locked(req.fingerprint, exclude=req.failed)
                if rep is None and req.failed:
                    # a replica this request once failed on may have healed:
                    # a stale exclusion must not park it for ever
                    rep = self._select_locked(req.fingerprint)
                if rep is None:
                    telemetry.inc("pool_routes_total", outcome="parked")
                    self._pending[req.priority].append(req)
                    parked = True
                else:
                    telemetry.inc("pool_routes_total",
                                  outcome=("affinity" if req.fingerprint in rep.engines
                                           else rep.health()))
        if cancel:
            self._settle(req, exc=QuESTCancelledError(
                "request dropped: EnginePool is closed", "EnginePool.submit"))
            return
        if parked:
            self.admission.note_queued(req.tenant, req.priority)
            return
        self._dispatch_attempt(req, rep)

    def _dispatch_attempt(self, req: _PoolRequest, rep: _Replica) -> None:
        req.attempts += 1
        if req.attempts > self._max_attempts:
            self._settle(req, exc=req.last_exc or QuESTRetryError(
                f"request failed over {req.attempts - 1} time(s) without a replica "
                "completing it", "EnginePool.submit"))
            return
        if _faults.enabled():
            # the injectable replica death: one visit per routed attempt,
            # so a plan's nth visit replays the same way every run
            kind = _faults.fire("pool.replica")
            if kind is not None:
                req.failed.add(rep.id)
                req.last_exc = QuESTCancelledError(
                    f"injected {kind} fault at site 'pool.replica' (replica {rep.id})",
                    "EnginePool._dispatch")
                self._quarantine(rep, reason=kind)
                telemetry.inc("pool_failovers_total", reason=kind)
                self._route(req)
                return
        eng = None
        try:
            eng = self._engine_for(rep, req.fingerprint, req.circuit)
            f = eng.submit(req.params, timeout=req.remaining())
        except QuESTBackpressureError as e:
            req.failed.add(rep.id)
            req.last_exc = e
            if eng is not None and eng.health() == "quarantined":
                self._quarantine(rep, reason="quarantined")
            telemetry.inc("pool_failovers_total", reason="backpressure")
            self._route(req)
            return
        except RuntimeError as e:
            if eng is not None and not eng.is_open():
                # the quarantine drain closed this engine between routing
                # and submit: the drain's zero-lost contract covers it
                req.failed.add(rep.id)
                req.last_exc = QuESTCancelledError(
                    f"replica {rep.id} closed during dispatch", "EnginePool._dispatch")
                telemetry.inc("pool_failovers_total", reason="closed")
                self._route(req)
                return
            self._settle(req, exc=e)
            return
        except Exception as e:  # a request-level failure: the caller's future takes it
            self._settle(req, exc=e)
            return
        with self._cv:
            req.dispatched_at = time.monotonic()
            req.inner.append((rep, f, False))
            rep.outstanding.add(req)
        f.add_done_callback(
            lambda fut, req=req, rep=rep: self._on_done(req, rep, fut, hedge=False))

    def _settle(self, req: _PoolRequest, result=None, exc=None) -> bool:
        """Resolve the caller's future exactly once (concurrent engine
        completions race through here; the first wins)."""
        with self._cv:
            if req.settled:
                return False
            req.settled = True
            self._cv.notify_all()
        # resolved OUTSIDE the pool lock; the settled flag is the guard
        _sync.resolve_future(req.fut, result=result, exception=exc, site="pool.settle")
        telemetry.observe("pool_request_latency_seconds", time.monotonic() - req.t0)
        return True

    def _on_done(self, req: _PoolRequest, rep: _Replica, fut, *, hedge: bool) -> None:
        with self._cv:
            req.inner = [p for p in req.inner if p[1] is not fut]
            if not any(p[0] is rep for p in req.inner):
                rep.outstanding.discard(req)
            siblings = list(req.inner)
            settled = req.settled
            self._cv.notify_all()
        if fut.cancelled() or settled:
            return  # a hedge loser, or a late failover echo
        exc = fut.exception()
        if exc is None:
            if self._settle(req, result=fut.result()):
                if req.hedged:
                    telemetry.inc("pool_hedges_total",
                                  outcome="won_hedge" if hedge else "won_primary")
                for _rep, f2, _h in siblings:
                    f2.cancel()  # the engines guard fut.done(): safe either way
            self._drain_pending()
            return
        # a replica-level failure quarantines the replica...
        if isinstance(exc, QuESTHangError):
            self._quarantine(rep, reason="hang")
        elif isinstance(exc, QuESTIntegrityError):
            with self._cv:
                state = rep.health()
            if state == "quarantined":
                self._quarantine(rep, reason="integrity")
        if siblings:
            return  # another attempt is still in flight; it decides
        reason = _failover_reason(exc)
        if reason is None:
            # a request-level failure (timeout, poison, user error): the
            # caller gets the typed error, no failover
            self._settle(req, exc=exc)
            return
        req.failed.add(rep.id)
        req.last_exc = exc
        telemetry.inc("pool_failovers_total", reason=reason)
        telemetry.event("pool.failover", replica=rep.id, reason=reason, attempts=req.attempts)
        self._route(req)
        self._drain_pending()

    def _drain_pending(self) -> None:
        """Dispatch parked requests that became routable (high first)."""
        while True:
            req = rep = None
            with self._cv:
                if self._closed:
                    return
                for prio in PRIORITIES:
                    dq = self._pending[prio]
                    if dq:
                        cand = (self._select_locked(dq[0].fingerprint, exclude=dq[0].failed)
                                or self._select_locked(dq[0].fingerprint))
                        if cand is not None:
                            req, rep = dq.popleft(), cand
                            break
                if req is None:
                    return
            self._dispatch_attempt(req, rep)

    # -- engines ------------------------------------------------------------

    def _engine_for(self, rep: _Replica, fingerprint, circuit=None) -> Engine:
        with self._cv:
            eng = rep.engines.get(fingerprint)
            if circuit is None:
                circuit = self._manifest.get(fingerprint)
        if eng is not None:
            return eng
        if circuit is None:
            raise KeyError(f"no circuit recorded for fingerprint {fingerprint[:12]}...")
        with rep.build_lock:
            with self._cv:
                eng = rep.engines.get(fingerprint)
                override = self._finalize_for.get(fingerprint)
            if eng is not None:
                return eng
            kw = self._engine_kw
            if override is not None:
                kw = {**kw, "finalize": override}
            elif isinstance(fingerprint, str) and fingerprint.startswith("grad:"):
                # a gradient row without its observable (replayed into a
                # fresh pool) must fail loud: a plain engine under this key
                # would serve states where the caller expects (value, grads)
                raise KeyError(f"gradient fingerprint {fingerprint[:24]}... has no "
                               "registered observable; route it through submit_grad")
            eng = Engine(circuit, self._env, **kw)
            with self._cv:
                rep.engines[fingerprint] = eng
            return eng

    # -- quarantine, failover, replacement ----------------------------------

    def _quarantine(self, rep: _Replica, *, reason: str) -> None:
        with self._cv:
            if rep.state == "quarantined":
                return
            rep.state = "quarantined"
            rep.in_rotation = False
            engines = list(rep.engines.values())
            spawn = self._spawn_replacements and not self._closed
            self._cv.notify_all()
        telemetry.inc("pool_quarantines_total", reason=reason)
        telemetry.set_gauge("pool_replicas", self._rotation_count())
        telemetry.event("pool.quarantine", replica=rep.id, reason=reason)
        # drain on a helper thread: this may run ON one of the replica's
        # batcher threads (a done callback), and Engine.close joins it
        drainer = threading.Thread(target=self._drain_replica, args=(engines,),
                                   name=f"quest-pool-drain-{rep.id}", daemon=True)
        drainer.start()
        with self._cv:
            self._workers.append(drainer)
        if spawn:
            spawner = threading.Thread(target=self._spawn_replacement, args=(reason,),
                                       name="quest-pool-respawn", daemon=True)
            spawner.start()
            with self._cv:
                self._workers.append(spawner)

    def _drain_replica(self, engines) -> None:
        """Close a quarantined replica's engines without draining: every
        queued future resolves QuESTCancelledError, whose done callbacks
        fail the requests over to healthy peers (zero dropped futures);
        a batch already running completes and serves its waiters."""
        for eng in engines:
            try:
                eng.close(drain=False)
            except Exception as e:  # pragma: no cover - close must not cascade
                telemetry.event("pool.drain_failed", error=type(e).__name__)

    def _spawn_replacement(self, reason: str) -> None:
        try:
            with self._cv:
                if self._closed:
                    return
                rep = _Replica(self._next_rid)
                self._next_rid += 1
                manifest = dict(self._manifest)
            for fp, circ in manifest.items():
                self._engine_for(rep, fp, circ).warmup()
        except Exception as e:  # pragma: no cover - the respawn is best effort
            telemetry.event("pool.respawn_failed", error=type(e).__name__)
            return
        stillborn = None
        with self._cv:
            if self._closed:
                stillborn = list(rep.engines.values())
            else:
                rep.in_rotation = True
                self._replicas.append(rep)
                self._cv.notify_all()
        if stillborn is not None:
            self._drain_replica(stillborn)
            return
        telemetry.inc("pool_replacements_total", reason=reason)
        telemetry.set_gauge("pool_replicas", self._rotation_count())
        telemetry.event("pool.replacement", replica=rep.id, warmed=len(manifest))
        self._drain_pending()

    def warm_from_manifest(self, manifest=None, replica=None) -> list:
        """Build and :meth:`Engine.warmup` the engines of every fingerprint
        in ``manifest`` (default: every structure this pool has served; or
        a ``{fingerprint: circuit}`` map, or an iterable of circuits) on
        ``replica`` (an id, or None = every replica in rotation), so that
        their first real request builds nothing. Returns the warmed
        fingerprints."""
        if manifest is None:
            with self._cv:
                manifest = dict(self._manifest)
        elif not isinstance(manifest, dict):
            manifest = {c.fingerprint(): c for c in manifest}
        with self._cv:
            for fp, circ in manifest.items():
                self._manifest.setdefault(fp, circ)
            if replica is None:
                reps = [r for r in self._replicas if r.in_rotation]
            elif isinstance(replica, _Replica):
                reps = [replica]
            else:
                reps = [r for r in self._replicas if r.id == replica]
                if not reps:
                    raise ValueError(f"no replica with id {replica!r}")
        for rep in reps:
            for fp, circ in manifest.items():
                self._engine_for(rep, fp, circ).warmup()
        return sorted(manifest)

    @property
    def manifest(self) -> dict:
        """Fingerprint -> circuit of every structure served so far."""
        with self._cv:
            return dict(self._manifest)

    @property
    def frequencies(self) -> dict:
        """Fingerprint -> request count: what :meth:`precompile` ranks by."""
        with self._cv:
            return dict(self._freq)

    # -- ahead-of-demand warm-up --------------------------------------------

    def precompile(self, limit: int | None = None, replica=None) -> list:
        """Warm executables OFF the request path: rank every fingerprint
        this pool has served by request count (descending, then by
        fingerprint) and make sure the first ``limit`` (None = all) hold
        warm executables on ``replica`` (an id, or None = every replica in
        rotation).

        Each (fingerprint, replica) counts ``engine_precompile_total``:
        ``cached`` -- the engine exists and the LRU still holds its batch
        executable (probed with the NON-MUTATING ``LRUCache.peek``, so the
        ranking never promotes an entry over one live traffic uses);
        ``warmed`` -- a cold engine was built (or an evicted executable
        warmed again) with :meth:`Engine.warmup`; ``error`` -- the warm-up
        failed (requests are unaffected: they build on first use).

        Returns the fingerprints warm on every replica asked, in rank order."""
        from . import cache as _ec
        with self._cv:
            ranked = sorted(self._freq, key=lambda fp: (-self._freq[fp], fp))
            manifest = {fp: self._manifest[fp] for fp in ranked if fp in self._manifest}
            if replica is None:
                reps = [r for r in self._replicas if r.in_rotation]
            else:
                reps = [r for r in self._replicas if r.id == replica]
                if not reps:
                    raise ValueError(f"no replica with id {replica!r}")
        if limit is not None:
            manifest = dict(list(manifest.items())[:max(0, limit)])
        done = []
        for fp, circ in manifest.items():
            ok = True
            for rep in reps:
                with self._cv:
                    eng = rep.engines.get(fp)
                try:
                    if eng is not None and eng.is_open():
                        if (eng._mode() != "vmap"
                                or _ec.executables().peek(eng._execB_key()) is not None):
                            telemetry.inc("engine_precompile_total", outcome="cached")
                            continue
                        eng.warmup()
                    else:
                        self._engine_for(rep, fp, circ).warmup()
                    telemetry.inc("engine_precompile_total", outcome="warmed")
                except Exception as e:
                    ok = False
                    telemetry.inc("engine_precompile_total", outcome="error")
                    telemetry.event("pool.precompile_failed", fingerprint=fp[:12],
                                    error=type(e).__name__)
            if ok:
                done.append(fp)
        if done:
            telemetry.event("pool.precompile", warmed=len(done), replicas=len(reps))
        return done

    def _precompile_loop(self) -> None:
        while True:
            with self._cv:
                if self._closed:
                    return
                self._cv.wait(self.precompile_s)
                if self._closed:
                    return
            try:
                self.precompile()
            except Exception as e:  # pragma: no cover - the warm-up is best effort
                telemetry.event("pool.precompile_failed", fingerprint="",
                                error=type(e).__name__)

    # -- hedging ------------------------------------------------------------

    def _hedge_loop(self) -> None:
        while True:
            with self._cv:
                if self._closed:
                    return
                now = time.monotonic()
                cands = []
                for rep in self._replicas:
                    if not rep.in_rotation or rep.health() != "degraded":
                        continue
                    for req in list(rep.outstanding):
                        if (req.settled or req.hedged or req.dispatched_at is None
                                or now - req.dispatched_at < self.hedge_s):
                            continue
                        peer = self._select_locked(req.fingerprint,
                                                   exclude={rep.id} | req.failed,
                                                   allow_degraded=False)
                        if peer is not None:
                            req.hedged = True
                            cands.append((req, peer))
            for req, peer in cands:
                self._issue_hedge(req, peer)
            with self._cv:
                if self._closed:
                    return
                self._cv.wait(max(self.hedge_s / 2.0, 0.001))

    def _issue_hedge(self, req: _PoolRequest, peer: _Replica) -> None:
        telemetry.inc("pool_hedges_total", outcome="issued")
        telemetry.event("pool.hedge", replica=peer.id, attempts=req.attempts)

        def attempt():
            return self._engine_for(peer, req.fingerprint, req.circuit).submit(
                req.params, timeout=req.remaining())

        try:
            f = _retry.call_with_retry(attempt, site="pool.hedge",
                                       retryable=(QuESTBackpressureError,))
        except Exception as e:
            telemetry.event("pool.hedge_failed", error=type(e).__name__)
            with self._cv:
                req.hedged = False  # the primary still owns it; may hedge again
            return
        with self._cv:
            req.inner.append((peer, f, True))
            peer.outstanding.add(req)
        f.add_done_callback(
            lambda fut, req=req, rep=peer: self._on_done(req, rep, fut, hedge=True))

    # -- introspection and lifecycle ----------------------------------------

    def _rotation_count(self) -> int:
        with self._cv:
            return sum(1 for r in self._replicas if r.in_rotation)

    def health(self) -> dict:
        """Replica id -> health, quarantined former members included."""
        with self._cv:
            return {rep.id: rep.health() for rep in self._replicas}

    def rotation(self) -> list:
        """Ids of the replicas taking traffic."""
        with self._cv:
            return [rep.id for rep in self._replicas if rep.in_rotation]

    def await_rotation(self, k: int, timeout: float | None = None) -> int:
        """Block until at least ``k`` replicas are in rotation (a
        replacement finished warming); raises TimeoutError otherwise."""
        with self._cv:
            ok = self._cv.wait_for(
                lambda: self._closed or sum(1 for r in self._replicas if r.in_rotation) >= k,
                timeout)
            count = sum(1 for r in self._replicas if r.in_rotation)
        if not ok or count < k:
            raise TimeoutError(f"pool rotation did not reach {k} (have {count})")
        return count

    def revive(self, replica_id: int) -> str:
        """The operator's acknowledgement after a quarantine: return the
        replica to rotation. Engines its drain closed are dropped (they are
        built again at first use, from the shared executables); the others
        are :meth:`Engine.revive`-d. Returns the replica's new health."""
        with self._cv:
            reps = [r for r in self._replicas if r.id == replica_id]
            if not reps:
                raise ValueError(f"no replica with id {replica_id!r}")
            rep = reps[0]
            rep.state = "healthy"
            for fp in [fp for fp, e in rep.engines.items() if not e.is_open()]:
                del rep.engines[fp]
            engines = list(rep.engines.values())
        for eng in engines:
            eng.revive()
        with self._cv:
            rep.in_rotation = True
            self._cv.notify_all()
        telemetry.set_gauge("pool_replicas", self._rotation_count())
        telemetry.event("pool.revive", replica=rep.id)
        self._drain_pending()
        with self._cv:
            return rep.health()

    def close(self, drain: bool = True) -> None:
        """Close every engine of every replica (``drain`` as in
        :meth:`Engine.close`); parked requests resolve with a typed
        QuESTCancelledError. Every accepted future resolves."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            parked = [r for p in PRIORITIES for r in self._pending[p]]
            for p in PRIORITIES:
                self._pending[p].clear()
            reps = list(self._replicas)
            workers = list(self._workers)
            self._cv.notify_all()
        for req in parked:
            self._settle(req, exc=QuESTCancelledError(
                "request dropped by EnginePool.close before dispatch", "EnginePool.close"))
        for t in workers:
            _sync.join_thread(t)
        for rep in reps:
            for eng in list(rep.engines.values()):
                try:
                    eng.close(drain=drain)
                except Exception as e:  # pragma: no cover - close must not cascade
                    telemetry.event("pool.close_failed", error=type(e).__name__)
        if self._hedge_thread is not None and self._hedge_thread.is_alive():
            _sync.join_thread(self._hedge_thread)
        if self._precompile_thread is not None and self._precompile_thread.is_alive():
            _sync.join_thread(self._precompile_thread)
        telemetry.set_gauge("pool_replicas", 0)
        telemetry.event("pool.close", drained=drain)

    def __enter__(self) -> "EnginePool":
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close(drain=exc_type is None)
        return False
