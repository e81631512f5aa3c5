"""Counters, gauges, histograms and events: how a run shows which route it
took, and how the serving Engine shows what it served.

The port keeps the counter names of ``quest_tpu.telemetry`` that the slice
needs:

- ``pallas_pass_total{kind}``: one per pass over the state, ``kind`` =
  ``fused_run`` (a fused-gate-run kernel pass), ``frame_swap`` (an
  explicit bit-block relabeling) or ``window_dot`` (a dense window);
- ``engine_fallback_total{reason}``: every time a kernel route degrades
  to the per-gate engine, with the JAX package's reasons. One device has
  no such fallback; on a sharded register a run whose tile does not fit
  in a shard (a plan made without ``shard_devices``) replays on the
  engine over the shards, ``reason=shard_map_unsupported``;
- ``exchange_calls_total{kind}``: one per exchange between the shards of
  a register (``parallel.exchange``), ``kind`` = ``pair_exchange``,
  ``x_permute``, ``grouped_permute``, ``swap_rank_permute`` or
  ``swap_odd_parity``, as the JAX package counts its collectives;
- the explicit scheduler's series (``parallel.scheduler``):
  ``comm_chunk_units_total{kind,link}`` (chunk units of each counted
  collective, summing to ``comm_chunks`` of its stats),
  ``comm_ops_total{kind=virtual_swap}``, the gauge
  ``comm_pipeline_depth`` (the depth of the last exchange launch) and the
  histogram ``comm_collective_ms{kind,pipeline}`` (each eager exchange
  launch inside an ``explicit_mesh`` context, while :func:`enabled`: on a
  card its device time between two CUDA events on the first shard's
  stream, read when the histogram is read, :func:`observe_later`; on the
  CPU its wall time).

- ``device_dispatch_total{route}``: one per dispatch of a compiled
  route (``Circuit.compiled`` and its kin), ``route`` = ``circuit`` (one
  ``Circuit.run``), ``segment`` (one segment program of a chain),
  ``item`` (one host-bound tape entry run eagerly between programs),
  ``request`` (one whole-request program) or ``block`` (one block of
  ``compiled_blocks``);
- ``plan_cache_{hit,miss,evict}_total{cache}``: the executable cache's
  lookups and evictions (``engine.cache.LRUCache``), with the gauge
  ``plan_cache_size{cache}``;
- ``engine_trace_total{kind=param_replay}``: one each time a
  parameterized executable builds its replay, at its first (warm-up) run
  and at each CUDA-graph capture (its second call on the card, for one
  pair of buffers): the port's counterpart of a trace.

- the serving Engine's series, under the JAX package's names and labels:
  the counters ``engine_requests_total``, ``engine_batches_total{mode}``
  (``vmap``: one lane-batched replay of a coalesced batch; ``sequential``:
  one replay a request), ``engine_backpressure_total{reason}``,
  ``engine_request_timeouts_total``, ``engine_bisections_total``,
  ``engine_poisoned_requests_total``,
  ``engine_health_transitions_total{from,to}``, ``device_dispatch_total{route}``
  (``engine_param``, ``engine_vmap``), the gauge ``engine_queue_depth``,
  and the histograms ``engine_batch_size`` and
  ``engine_request_latency_seconds``; the resilience layer's
  ``fault_injected_total{site,kind}``, ``sentinel_checks_total{kind,outcome}``,
  ``watchdog_timeouts_total{site}`` and ``analysis_findings_total{code,severity}``.

A histogram keeps count, sum, min and max of its observations
(:func:`observe`); :func:`event` appends one record to a bounded ring of
flight-recorder events (:func:`events`). :func:`snapshot` gives the whole
registry as ``{"counters", "gauges", "histograms"}``, series keyed as in
the JAX package.

Kernel launch counts live on the kernel wrappers themselves
(``ops.fused_gates.fused_run.launches``,
``ops.window_dot.window_dot.launches``). A counter key is the name, plus
``{k=v,...}`` with the labels sorted, as in the JAX package.

**The counting rule.** Counters count *executions*, not Python calls. A
compiled route on the card replays a CUDA graph, which runs no Python, so
the executable records what its capture's replay body added to every
counter here (``pallas_pass_total``, ``channel_route_total``,
``exchange_calls_total``, ``engine_fallback_total``, ...), takes those
increments back (a capture executes nothing), and adds the same deltas at
every replay (``_capture``). The counters of a graph replay therefore equal
those of an eager run of the same tape. The kernel launch counts are not
counters: a wrapper adds one where it launches its kernel and nowhere
else, so a capture takes its increments back and a replay adds none; what
a replay launches is read from its graph's kernel nodes.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque

_lock = threading.Lock()
#: whether the timed series are recorded (``QUEST_TELEMETRY=0`` turns them
#: off); counters always count
_enabled = os.environ.get("QUEST_TELEMETRY", "1").strip() != "0"
_counters: dict[str, float] = {}
_gauges: dict[str, float] = {}
_hists: dict[str, dict] = {}
#: the flight-recorder ring: the most recent events
_MAX_EVENTS = 4096
_events: deque = deque(maxlen=_MAX_EVENTS)


def _key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def inc(name: str, value: float = 1.0, **labels) -> None:
    key = _key(name, labels)
    with _lock:
        _counters[key] = _counters.get(key, 0.0) + value


def counter_value(name: str, **labels) -> float:
    with _lock:
        return _counters.get(_key(name, labels), 0.0)


def counter_total(name: str) -> float:
    """Sum of every labelled series of ``name``."""
    with _lock:
        return sum(v for k, v in _counters.items()
                   if k == name or k.startswith(name + "{"))


def set_gauge(name: str, value: float, **labels) -> None:
    with _lock:
        _gauges[_key(name, labels)] = float(value)


def gauge_value(name: str, **labels) -> float:
    with _lock:
        return _gauges.get(_key(name, labels), 0.0)


def observe(name: str, value: float, **labels) -> None:
    """Record one observation into the histogram ``name{labels}`` (count,
    sum, min, max)."""
    key, v = _key(name, labels), float(value)
    with _lock:
        h = _hists.get(key)
        if h is None:
            _hists[key] = {"count": 1, "sum": v, "min": v, "max": v}
        else:
            h["count"] += 1
            h["sum"] += v
            h["min"] = min(h["min"], v)
            h["max"] = max(h["max"], v)


#: observations whose value the device has yet to produce:
#: (name, labels, value(), ready()) resolved when a histogram is read
_pending: list = []
_MAX_PENDING = 1024


def observe_later(name: str, value, ready=None, **labels) -> None:
    """Record an observation whose value ``value()`` can only be read once
    the device has run (a CUDA event pair, ``ready()`` True once it has):
    resolved when a histogram is read, which waits for the device. When
    :data:`_MAX_PENDING` wait, those that are ready resolve and the
    oldest that are not are dropped, so neither the launch that made it
    nor a later one waits for the device."""
    with _lock:
        _pending.append((name, labels, value, ready))
        full = len(_pending) >= _MAX_PENDING
    if full:
        _resolve(wait=False)


def _resolve(wait: bool = True) -> None:
    with _lock:
        todo = list(_pending)
        _pending.clear()
    keep = []
    for item in todo:
        name, labels, value, ready = item
        if wait or ready is None or ready():
            observe(name, value(), **labels)
        else:
            keep.append(item)
    del keep[:max(0, len(keep) - _MAX_PENDING // 2)]  # the oldest not ready
    with _lock:
        _pending[:0] = keep


def histogram(name: str, **labels) -> dict:
    """A copy of one histogram series (empty if never observed)."""
    _resolve()
    with _lock:
        return dict(_hists.get(_key(name, labels), {}))


def event(name: str, **fields) -> None:
    """Append one flight-recorder event."""
    with _lock:
        _events.append({"kind": "event", "name": name, "t": time.time(), **fields})


def events() -> list:
    """A copy of the event ring, the most recent last."""
    with _lock:
        return list(_events)


def counters() -> dict:
    """A copy of every counter (key -> value): what :func:`delta`,
    :func:`restore` and :func:`add` work on."""
    with _lock:
        return dict(_counters)


def snapshot(prefix: str | None = None) -> dict:
    """The registry as ``{"counters", "gauges", "histograms"}`` (histograms
    as count / sum / min / max); ``prefix`` filters the series names."""
    def keep(k):
        return prefix is None or k.startswith(prefix)

    def num(v):
        return int(v) if float(v).is_integer() else v

    _resolve()
    with _lock:
        return {"counters": {k: num(v) for k, v in sorted(_counters.items()) if keep(k)},
                "gauges": {k: v for k, v in sorted(_gauges.items()) if keep(k)},
                "histograms": {k: dict(h) for k, h in sorted(_hists.items()) if keep(k)}}


def delta(before: dict, after: dict) -> dict:
    """The counters that moved from ``before`` to ``after``, by how much."""
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v != before.get(k, 0.0)}


def restore(saved: dict) -> None:
    """Put every counter back to ``saved``."""
    with _lock:
        _counters.clear()
        _counters.update(saved)


def add(moves: dict) -> None:
    """Add a :func:`delta` to the counters."""
    with _lock:
        for k, v in moves.items():
            _counters[k] = _counters.get(k, 0.0) + v


def reset() -> None:
    with _lock:
        _pending.clear()
        _counters.clear()
        _gauges.clear()
        _hists.clear()
        _events.clear()


def enabled() -> bool:
    """True when the timed series (``comm_collective_ms``) are recorded:
    ``QUEST_TELEMETRY`` != 0 and not inside :func:`disabled`."""
    return _enabled


@contextlib.contextmanager
def disabled():
    """Turn the timed series off for the block."""
    global _enabled
    prev, _enabled = _enabled, False
    try:
        yield
    finally:
        _enabled = prev
