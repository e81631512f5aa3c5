"""Spy points: primitives whose calls a planner may divert, in one thread.

The fuser (``fusion.capture``) and the explicit scheduler's lookahead
(``circuits._tape_accesses``) learn what a tape entry does by replaying it
against a spy register with the gate primitives and appliers diverted to
recorders. The diversion is thread-local: a primitive marked with
:func:`spy_point` looks up this thread's recorders (:func:`recording`) and
runs its own body when it has none, so a capture in one thread never
changes what a gate computes in another (the serving Engine's batcher, a
pool replica).
"""

from __future__ import annotations

import functools
import threading
from contextlib import contextmanager

_LOCAL = threading.local()


def spy_point(fn):
    """Mark ``fn`` as a primitive that :func:`recording` may divert."""

    @functools.wraps(fn)
    def call(*args, **kwargs):
        table = getattr(_LOCAL, "table", None)
        rec = table.get(call) if table else None
        if rec is None:
            return fn(*args, **kwargs)
        return rec(*args, **kwargs)

    return call


@contextmanager
def recording(recorders: dict):
    """Within the context, in this thread only, a call of a spy point ``f``
    that is a key of ``recorders`` runs ``recorders[f]`` (same arguments)
    instead. Contexts nest; the inner one's recorders win."""
    prev = getattr(_LOCAL, "table", None)
    _LOCAL.table = {**prev, **recorders} if prev else dict(recorders)
    try:
        yield
    finally:
        _LOCAL.table = prev
