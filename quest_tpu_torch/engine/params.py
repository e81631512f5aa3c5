"""Parameterized tapes: runtime gate angles instead of constants baked at
record time (``quest_tpu/engine/params.py``).

A ``Circuit`` tape bakes every rotation angle into its entries, so a
parameter sweep (VQE/QAOA, or many users submitting variants of one
ansatz) would build and capture a new executable per parameter set. This
module makes values *runtime arguments* of one captured replay:

- :class:`Param` (alias ``P``) is a named placeholder recordable anywhere
  a gate angle or ``Complex`` scalar goes on a tape:
  ``circ.rotateZ(0, P("theta"))``.
- :func:`lift_tape` canonicalises a recorded tape into a
  :class:`LiftedTape` whose *value slots* cover every ``Param`` AND every
  plain float/complex constant sitting at a liftable position (the
  ``_LIFTABLE`` registry below). Constants elsewhere (unitary matrices,
  channel probabilities, qubit indices) stay baked structure.
- :func:`bind` resolves the slots to one tensor of values per kind on a
  device (:class:`BoundValues`), and :func:`materialize_entry` substitutes
  0-d views of those tensors into the entries at replay time, so gate
  matrices are assembled on the device from the values
  (``matrices.py``'s tensor branches) and one captured graph replays for
  any value vector -- also through a fused plan, where parameterized
  entries ride as barriers between the static kernel runs.

Two tapes that differ only in lifted values produce the SAME
:func:`quest_tpu_torch.engine.cache.structure_fingerprint`, so
structure-equal circuits share one executable.

Besides the ``'real'``/``'complex'`` angle slots the registry names a third
kind, ``'seed'``: an integer PRNG-seed slot, carried by the JAX package's
trajectory-noise and mid-circuit measurement entries, which later slices
of the port bring; seed positions lift plain ints too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

__all__ = ["Param", "P", "LiftedTape", "Slot", "ParamExecutable", "BoundValues",
           "lift_tape", "lift_slot_census", "bind", "bind_host", "stack_values",
           "value_index", "materialize_entry",
           "materialize_tape", "has_params", "is_value"]


class Param:
    """Named placeholder for a runtime gate parameter.

    Record it anywhere a gate angle / ``Complex`` scalar goes::

        from quest_tpu_torch.engine import P
        circ.rotateZ(0, P("theta"))

    The value is supplied per execution
    (``Circuit.parameterized()(amps, {"theta": 0.3})``); the executable is
    value-independent. The same name may appear in several slots -- every
    occurrence receives the one bound value.
    """

    __slots__ = ("name",)

    def __init__(self, name: str):
        if not isinstance(name, str) or not name:
            raise ValueError("Param name must be a non-empty string")
        self.name = name

    def __repr__(self):
        return f"P({self.name!r})"

    def __eq__(self, other):
        return isinstance(other, Param) and other.name == self.name

    def __hash__(self):
        return hash(("quest_tpu_torch.Param", self.name))


#: short alias: ``rotateZ(q, P("t"))``
P = Param


#: tape-arg positions (qureg excluded) and kwarg names whose values are
#: liftable runtime scalars, per API function: the angle / Complex-scalar
#: arguments of the rotation, phase and compact-unitary family. Everything
#: else a tape entry carries is structure and stays baked. Kept whole from
#: the JAX package, with the seed kinds of entries a later slice ports.
_REAL, _CPLX, _SEED = "real", "complex", "seed"
_LIFTABLE = {
    "applyTrajectoryKraus": {2: _SEED, "seed": _SEED},
    "applyMidMeasurement": {1: _SEED, "seed": _SEED},
    "phaseShift": {1: _REAL, "angle": _REAL},
    "controlledPhaseShift": {2: _REAL, "angle": _REAL},
    "multiControlledPhaseShift": {1: _REAL, "angle": _REAL},
    "rotateX": {1: _REAL, "angle": _REAL},
    "rotateY": {1: _REAL, "angle": _REAL},
    "rotateZ": {1: _REAL, "angle": _REAL},
    "rotateAroundAxis": {1: _REAL, "angle": _REAL},
    "controlledRotateX": {2: _REAL, "angle": _REAL},
    "controlledRotateY": {2: _REAL, "angle": _REAL},
    "controlledRotateZ": {2: _REAL, "angle": _REAL},
    "controlledRotateAroundAxis": {2: _REAL, "angle": _REAL},
    "multiRotateZ": {1: _REAL, "angle": _REAL},
    "multiControlledMultiRotateZ": {2: _REAL, "angle": _REAL},
    "multiRotatePauli": {2: _REAL, "angle": _REAL},
    "multiControlledMultiRotatePauli": {3: _REAL, "angle": _REAL},
    "compactUnitary": {1: _CPLX, 2: _CPLX, "alpha": _CPLX, "beta": _CPLX},
    "controlledCompactUnitary": {2: _CPLX, 3: _CPLX, "alpha": _CPLX, "beta": _CPLX},
}


def is_value(x) -> bool:
    """True for the scalar types the lifter treats as runtime values when
    they sit at a liftable position: Params, floats and complex numbers
    (ints and bools are always structure -- they index qubits)."""
    if isinstance(x, Param):
        return True
    if isinstance(x, bool) or isinstance(x, (int, np.integer)):
        return False
    return isinstance(x, (float, complex, np.floating, np.complexfloating))


def _is_seed_value(x) -> bool:
    """At a ``'seed'`` position a plain integer IS the runtime value."""
    if isinstance(x, Param):
        return True
    return isinstance(x, (int, np.integer)) and not isinstance(x, bool)


def has_params(args, kwargs=None) -> bool:
    """True when a tape entry's arguments carry a :class:`Param` anywhere
    (one level into tuples/lists): the planner's pre-check, such entries
    are barriers assembled at replay time, never spy-captured."""
    items = list(args) + list((kwargs or {}).values())
    for x in items:
        if isinstance(x, Param):
            return True
        if isinstance(x, (tuple, list)) and any(isinstance(e, Param) for e in x):
            return True
    return False


@dataclass(frozen=True)
class Slot:
    """One runtime value slot of a lifted tape. ``name`` is None for an
    anonymous slot (a lifted constant, replayed with ``default``); named
    slots come from :class:`Param` placeholders and MUST be bound."""
    index: int
    kind: str                      # 'real' | 'complex' | 'seed'
    name: Optional[str] = None
    default: Optional[complex] = None


class _SlotRef:
    """Placeholder living in a lifted entry's argument template."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index

    def __repr__(self):
        return f"<slot {self.index}>"


@dataclass(frozen=True)
class LiftedTape:
    """A tape with its runtime values factored out: ``entries`` are
    ``(fn, args, kwargs)`` templates holding :class:`_SlotRef` markers,
    ``slots`` describes each value position in template order."""
    entries: tuple
    slots: tuple

    @property
    def param_names(self) -> tuple:
        """Ordered unique Param names (first-appearance order)."""
        seen = []
        for s in self.slots:
            if s.name is not None and s.name not in seen:
                seen.append(s.name)
        return tuple(seen)


def lift_tape(tape) -> LiftedTape:
    """Factor a recorded tape's runtime values into slots. A
    :class:`Param` at a position the registry doesn't cover is an error:
    nothing assembles it on the device (a channel probability, whose
    superoperator is built on the host)."""
    from ..validation import QuESTError

    entries = []
    slots: list[Slot] = []

    def lift_value(v, kind):
        if isinstance(v, Param):
            slots.append(Slot(len(slots), kind, name=v.name))
        else:
            slots.append(Slot(len(slots), kind, default=v))
        return _SlotRef(len(slots) - 1)

    def liftable(v, kind):
        if kind is None:
            return False
        if kind == _SEED:
            return _is_seed_value(v)
        return is_value(v)

    for fn, args, kwargs in tape:
        spec = _LIFTABLE.get(getattr(fn, "__name__", ""), {})
        new_args = []
        for i, v in enumerate(args):
            kind = spec.get(i)
            if liftable(v, kind):
                new_args.append(lift_value(v, kind))
            elif isinstance(v, Param) or (
                    isinstance(v, (tuple, list)) and any(isinstance(e, Param) for e in v)):
                raise QuESTError(
                    f"Param is not supported at argument {i} of "
                    f"'{getattr(fn, '__name__', fn)}' -- only gate angles "
                    "and Complex scalars of the rotation/phase family can "
                    "be runtime parameters")
            else:
                new_args.append(v)
        new_kwargs = {}
        for k, v in kwargs.items():
            kind = spec.get(k)
            if liftable(v, kind):
                new_kwargs[k] = lift_value(v, kind)
            elif isinstance(v, Param):
                raise QuESTError(
                    f"Param is not supported for keyword '{k}' of "
                    f"'{getattr(fn, '__name__', fn)}'")
            else:
                new_kwargs[k] = v
        entries.append((fn, tuple(new_args), new_kwargs))
    return LiftedTape(tuple(entries), tuple(slots))


def lift_slot_census(tape) -> tuple[int, int]:
    """``(anonymous, named)`` slot counts of ``lift_tape(tape)``: how many
    liftable positions carry constants vs ``Param`` placeholders."""
    slots = lift_tape(tuple(tape)).slots
    anon = sum(1 for s in slots if s.name is None)
    return anon, len(slots) - anon


#: the torch dtype each slot kind is bound in: angles in float64 (the
#: matrix is assembled in f64 and cast to the register's dtype, as the
#: host path casts its numpy matrix), Complex scalars in complex128, seeds
#: as int64
_KIND_DTYPE = {_REAL: torch.float64, _CPLX: torch.complex128, _SEED: torch.int64}


class BoundValues:
    """A lifted tape's bound values: one tensor per slot kind (``real``,
    ``complex``, ``seed``) on one device. ``values[i]`` is slot i as a 0-d
    view of its kind's tensor, what :func:`materialize_entry` substitutes,
    so a captured replay reads the values the tensors hold at replay.

    The stacked form (:func:`stack_values`) holds B lanes' values, one
    (B, k) tensor per kind: ``lanes`` is B, and under ``torch.func.vmap`` over the tensors' first axis a
    ``BoundValues(tensors, index)`` built from the per-lane tensors is what
    each lane's replay reads."""

    __slots__ = ("tensors", "index", "_device")

    def __init__(self, tensors: dict, index: tuple, device=None):
        self.tensors = tensors
        self.index = index
        self._device = device

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, i):
        kind, pos = self.index[i]
        return self.tensors[kind][..., pos]

    @property
    def device(self) -> torch.device:
        """The tensors' device (the device bound for, with no slots)."""
        if not self.tensors:
            return torch.device(self._device or "cpu")
        return next(iter(self.tensors.values())).device

    @property
    def lanes(self) -> int | None:
        """B of the stacked form, None for one set of values."""
        t = next(iter(self.tensors.values()), None)
        return None if t is None or t.dim() < 2 else t.shape[0]

    def to(self, device) -> "BoundValues":
        return BoundValues({k: t.to(device) for k, t in self.tensors.items()}, self.index,
                           torch.device(device))

    def clone(self) -> "BoundValues":
        return BoundValues({k: t.clone() for k, t in self.tensors.items()}, self.index,
                           self.device)

    def copy_(self, other: "BoundValues") -> "BoundValues":
        """Load ``other``'s values into these tensors, in place."""
        if other.index != self.index:
            raise ValueError("the values were bound for another slot layout")
        for k, t in self.tensors.items():
            t.copy_(other.tensors[k])
        return self


def bind(lifted: LiftedTape, params=None, device=True):
    """Resolve a lifted tape's slots -- the ``values`` argument of the
    parameterized replay.

    ``params`` maps Param names to numbers (missing names raise);
    anonymous slots replay their recorded defaults. ``device`` (True: the
    CPU, or a torch device) returns :class:`BoundValues`, one tensor per
    slot kind; ``device=False`` returns a tuple of plain Python scalars (a
    tape materialized with them replays through the host assembly path,
    the baseline the tests compare against)."""
    out = bind_host(lifted, params)
    if device is False:
        return out
    return stack_values(lifted, [out], device, stacked=False)


def bind_host(lifted: LiftedTape, params=None) -> tuple:
    """``bind(lifted, params, device=False)``: the values as plain Python
    scalars, one per slot (missing names raise)."""
    from ..validation import QuESTError

    params = params or {}
    out = []
    for s in lifted.slots:
        if s.name is not None:
            if s.name not in params:
                missing = sorted({t.name for t in lifted.slots
                                  if t.name is not None and t.name not in params})
                raise QuESTError(f"missing values for Params {missing}; got {sorted(params)}")
            v = params[s.name]
        else:
            v = s.default
        if isinstance(v, torch.Tensor):
            v = v.item()
        if s.kind == _SEED:
            out.append(int(v))
        elif s.kind == _CPLX:
            out.append(complex(v))
        else:
            out.append(float(v))
    return tuple(out)


def value_index(lifted: LiftedTape) -> tuple:
    """(kind, position) of each slot in its kind's tensor: the
    :class:`BoundValues` index of the lifted tape."""
    counts: dict = {}
    index = []
    for s in lifted.slots:
        index.append((s.kind, counts.get(s.kind, 0)))
        counts[s.kind] = counts.get(s.kind, 0) + 1
    return tuple(index)


def stack_values(lifted: LiftedTape, rows, device=True, *, pad_to: int | None = None,
                 stacked: bool = True) -> BoundValues:
    """Host value tuples (:func:`bind_host`) as ONE :class:`BoundValues` on
    ``device`` (True: the CPU): stacked on the host into a (B, k) tensor per
    slot kind, B = ``pad_to`` (short lists repeat the last row) or the
    number of rows, and sent to the device in one copy per kind.
    ``stacked=False`` takes one row and gives (k,) tensors, :func:`bind`'s
    form."""
    rows = list(rows)
    if pad_to is not None:
        rows += [rows[-1]] * (pad_to - len(rows))
    dev = torch.device("cpu") if device is True else torch.device(device)
    index = value_index(lifted)
    cols: dict = {}
    for j, (kind, _pos) in enumerate(index):
        cols.setdefault(kind, []).append(j)
    tensors = {}
    for kind, js in cols.items():
        host = [[r[j] for j in js] for r in rows]
        t = torch.tensor(host if stacked else host[0], dtype=_KIND_DTYPE[kind])
        tensors[kind] = t.to(dev)
    return BoundValues(tensors, index, dev)


class ParamExecutable:
    """A parameterized replay bound to one circuit's slot layout.

    The underlying ``fn(amps, values)`` may be SHARED across structure-equal
    circuits (it comes out of the executable LRU keyed by the structure
    fingerprint); this wrapper carries the owning circuit's
    :class:`LiftedTape` so named Params bind and anonymous slots default to
    that circuit's own recorded constants.
    """

    def __init__(self, fn, lifted: LiftedTape, fingerprint: str):
        self._fn = fn
        self.lifted = lifted
        self.fingerprint = fingerprint

    @property
    def param_names(self) -> tuple:
        return self.lifted.param_names

    @property
    def captures(self) -> list:
        """(seconds, device bytes) of every capture the shared executable made."""
        return self._fn.captures

    @property
    def program(self):
        """The shared executable's ``_capture.Program`` (its pieces' graphs)."""
        return self._fn.program

    def bind(self, params=None, device=True) -> BoundValues:
        """Resolve ``params`` (Param name -> number) to the values."""
        return bind(self.lifted, params, device)

    def __call__(self, amps, params=None):
        """Replay onto ``amps`` with the given Param values."""
        first = amps[0] if isinstance(amps, (list, tuple)) else amps
        return self._fn(amps, self.bind(params, first.device))

    def with_values(self, amps, values):
        """Replay with already-bound values."""
        return self._fn(amps, values)


def materialize_entry(entry, values):
    """Substitute a lifted entry's slot markers with the bound values (0-d
    tensor views of a :class:`BoundValues`, or host scalars):
    ``(fn, args, kwargs)`` ready to replay."""
    fn, args, kwargs = entry
    args = tuple(values[a.index] if isinstance(a, _SlotRef) else a for a in args)
    if kwargs:
        kwargs = {k: values[v.index] if isinstance(v, _SlotRef) else v
                  for k, v in kwargs.items()}
    return fn, args, kwargs


def materialize_tape(lifted: LiftedTape, values) -> list:
    """The lifted tape with every slot substituted -- host scalars (from
    ``bind(..., device=False)``) give back a plain constant tape."""
    return [materialize_entry(e, values) for e in lifted.entries]
