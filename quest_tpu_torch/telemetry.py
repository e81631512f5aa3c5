"""Counters only: how a run shows which route it took.

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
  ``swap_odd_parity``, as the JAX package counts its collectives.

Kernel launch counts live on the kernel wrappers themselves
(``ops.fused_gates.fused_run.launches``,
``ops.window_dot.window_dot.launches``). A counter key is the name, plus
``{k=v,...}`` with the labels sorted, as in the JAX package.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_counters: dict[str, float] = {}


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


def reset() -> None:
    with _lock:
        _counters.clear()
