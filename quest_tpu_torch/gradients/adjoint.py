"""Adjoint-state reverse-mode differentiation of parameterized tapes
(``quest_tpu/gradients/adjoint.py``).

The method (Jones & Gacon, arXiv:2009.02823): for E(theta) =
<psi(theta)|H|psi(theta)> with |psi> = U_P...U_1|psi_0>, run ONE forward
sweep to |psi>, build the costate lambda = H|psi>, then walk backward
k = P..1 keeping two registers in step -- phi <- U_k^dagger phi and
lambda <- U_k^dagger lambda -- taking each parameter's derivative from the
bracket dE/dtheta_k = 2 Re<lambda_k|dU_k|phi_{k-1}> on the way: about
three sweeps and O(1) extra states, against parameter shifts' 2P replays.

The whole of it is a values-aware terminal stage of the parameterized
replay: :func:`grad_reduce` returns ``reduce(psi, values)``
(``wants_values``), which ``Circuit.parameterized`` and the Engine's
batch body compose after the forward replay, so forward, backward and
every accumulation are ONE compiled program (on the card one CUDA graph),
counted as ``route=grad_request`` and batched over lanes by
``torch.func.vmap``.

Derivative rules per lifted family (``engine.params._LIFTABLE``):

- rotations (rotate{X,Y,Z}, rotateAroundAxis, multiRotateZ/Pauli and their
  controlled forms), generator G with U = exp(-i theta G / 2) on the
  controlled block: dE/dtheta = Im<lambda|(Pi_1 x G)|phi_k> on the
  POST-gate state;
- phase shifts, U = diag(1, ..., e^{i theta}): dE/dtheta =
  -2 Im<lambda|Pi|phi_k> with Pi the all-ones projector of the qubits;
- compactUnitary(alpha, beta), two complex slots: per real component on
  the PRE-gate state -- dU/dx_alpha = I, dU/dy_alpha = iZ,
  dU/dx_beta = -iY, dU/dy_beta = iX -- packed as the JAX package packs
  ``jax.grad``'s complex cotangents (dE/dx - i dE/dy).

Contributions accumulate per slot (a lifted constant gets its own
derivative), and named slots sharing one Param sum into that Param's
gradient: the chain rule over the slot graph.

Inverses: a parameterized entry is daggered through its own gate
function (angle -> -angle, (alpha, beta) -> (conj alpha, -beta)); a
concrete entry through the planner's spy capture and
:func:`..fusion.event_dagger`. An entry with no inverse (a measurement, a
channel, a fused-run plan entry) raises a typed QuESTError at lift time
naming the site.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import gates as G
from .. import matrices as M
from .. import telemetry
from ..engine.params import _SlotRef
from ..ops import reduce as R
from ..registers import Qureg
from ..validation import QuESTError
from .expectation import (apply_hamiltonian, expectation_value, hamiltonian_terms, shell_of,
                          state_of)

__all__ = ["grad_reduce", "gradient_executable", "plan_backward", "check_differentiable",
           "GradExecutable"]


#: positional field names (qureg excluded) of each differentiable family:
#: the key that turns a tape entry's (args, kwargs) into one view
_FIELDS = {
    "phaseShift": ("target", "angle"),
    "controlledPhaseShift": ("q1", "q2", "angle"),
    "multiControlledPhaseShift": ("qubits", "angle"),
    "rotateX": ("target", "angle"),
    "rotateY": ("target", "angle"),
    "rotateZ": ("target", "angle"),
    "rotateAroundAxis": ("target", "angle", "axis"),
    "controlledRotateX": ("control", "target", "angle"),
    "controlledRotateY": ("control", "target", "angle"),
    "controlledRotateZ": ("control", "target", "angle"),
    "controlledRotateAroundAxis": ("control", "target", "angle", "axis"),
    "multiRotateZ": ("qubits", "angle"),
    "multiControlledMultiRotateZ": ("controls", "targets", "angle"),
    "multiRotatePauli": ("targets", "paulis", "angle"),
    "multiControlledMultiRotatePauli": ("controls", "targets", "paulis", "angle"),
    "compactUnitary": ("target", "alpha", "beta"),
    "controlledCompactUnitary": ("control", "target", "alpha", "beta"),
}

#: a C -> R cotangent is packed as dE/dx - i dE/dy (the JAX package's
#: ``jax.grad`` convention), so complex slot gradients compare sign-exact
_CPLX_IM = -1.0


def _entry_view(name, args, kwargs) -> dict:
    """Field -> value (a ``_SlotRef`` marker or a structure constant)."""
    fields = _FIELDS[name]
    view = dict(zip(fields, args))
    for k, v in (kwargs or {}).items():
        view[k] = v
    missing = [f for f in fields if f not in view]
    if missing:
        raise QuESTError(f"tape entry '{name}' is missing arguments {missing}", "gradient")
    return view


def _slot_refs(args, kwargs):
    return [a for a in list(args) + list((kwargs or {}).values()) if isinstance(a, _SlotRef)]


# ---------------------------------------------------------------------------
# derivative rules: static bracket programs per family
# ---------------------------------------------------------------------------

_Z = np.array([1.0, -1.0])


def _proj(qubits):
    """|1><1| on each qubit: the controlled block's projector Pi_1."""
    return tuple(("diag", np.array([0.0, 1.0]), (int(q),)) for q in qubits)


def _zs(qubits):
    return tuple(("diag", _Z, (int(q),)) for q in qubits)


def _pauli_steps(targets, paulis):
    steps = []
    for t, p in zip(targets, paulis):
        p = int(p)
        if p == 1:
            steps.append(("x", None, (int(t),)))
        elif p == 2:
            steps.append(("matrix", M.PAULI_Y_M, (int(t),)))
        elif p == 3:
            steps.append(("diag", _Z, (int(t),)))
    return tuple(steps)


def _axis_generator(axis) -> np.ndarray:
    """The normalised x X + y Y + z Z: rotateAroundAxis's generator."""
    x, y, z = float(axis.x), float(axis.y), float(axis.z)
    norm = np.sqrt(x * x + y * y + z * z)
    if norm == 0.0:
        raise QuESTError("rotateAroundAxis axis has zero norm", "gradient")
    return np.array([[z, x - 1j * y], [x + 1j * y, -z]], dtype=np.complex128) / norm


def _rules(name, view):
    """``(post, pre)`` contribution lists of one entry. Each contribution
    is ``(field, coef, part, steps, comp)``: the slot at ``view[field]``
    accumulates ``coef * part<lambda|Op|phi>`` with ``Op`` the ``steps``
    program and ``part`` Re or Im; ``comp`` names the component of a
    complex slot (None for a real one). ``post`` brackets take the
    post-gate phi_k, ``pre`` ones phi_{k-1}."""
    post, pre = [], []
    if name in ("rotateX", "rotateY", "rotateZ", "controlledRotateX",
                "controlledRotateY", "controlledRotateZ"):
        t = int(view["target"])
        ctrl = _proj((view["control"],)) if name.startswith("controlled") else ()
        op = {"X": ("x", None, (t,)), "Y": ("matrix", M.PAULI_Y_M, (t,)),
              "Z": ("diag", _Z, (t,))}[name[-1]]
        post.append(("angle", 1.0, "im", ctrl + (op,), None))
    elif name in ("rotateAroundAxis", "controlledRotateAroundAxis"):
        t = int(view["target"])
        ctrl = _proj((view["control"],)) if name.startswith("controlled") else ()
        post.append(("angle", 1.0, "im",
                     ctrl + (("matrix", _axis_generator(view["axis"]), (t,)),), None))
    elif name == "multiRotateZ":
        post.append(("angle", 1.0, "im", _zs(view["qubits"]), None))
    elif name == "multiControlledMultiRotateZ":
        post.append(("angle", 1.0, "im", _proj(view["controls"]) + _zs(view["targets"]),
                     None))
    elif name == "multiRotatePauli":
        post.append(("angle", 1.0, "im", _pauli_steps(view["targets"], view["paulis"]),
                     None))
    elif name == "multiControlledMultiRotatePauli":
        post.append(("angle", 1.0, "im", _proj(view["controls"])
                     + _pauli_steps(view["targets"], view["paulis"]), None))
    elif name == "phaseShift":
        post.append(("angle", -2.0, "im", _proj((view["target"],)), None))
    elif name == "controlledPhaseShift":
        post.append(("angle", -2.0, "im", _proj((view["q1"], view["q2"])), None))
    elif name == "multiControlledPhaseShift":
        post.append(("angle", -2.0, "im", _proj(view["qubits"]), None))
    elif name in ("compactUnitary", "controlledCompactUnitary"):
        t = int(view["target"])
        ctrl = _proj((view["control"],)) if name.startswith("controlled") else ()
        pre.extend([
            ("alpha", 2.0, "re", ctrl, "re"),
            ("alpha", -2.0, "im", ctrl + (("diag", _Z, (t,)),), "im"),
            ("beta", 2.0, "im", ctrl + (("matrix", M.PAULI_Y_M, (t,)),), "re"),
            ("beta", -2.0, "im", ctrl + (("x", None, (t,)),), "im"),
        ])
    else:  # pragma: no cover - guarded by the plan
        raise QuESTError(f"no derivative rule for '{name}'", "gradient")
    return tuple(post), tuple(pre)


def _apply_steps(shell: Qureg, steps) -> None:
    for kind, payload, qs in steps:
        if kind == "x":
            G._apply_gate_x(shell, qs)
        elif kind == "diag":
            G._apply_gate_diag(shell, payload, qs)
        else:
            G._apply_gate_matrix(shell, payload, qs)


def _bracket(lam_amps, phi_amps, steps, num_qubits: int, part: str):
    """Re or Im of <lambda|Op|phi>, Op the steps program (the identity when
    empty); ``phi_amps`` is left as it was (the engine makes new tensors).
    Both states are tensors, or lists of shards of one layout (each shard
    pair's partial cascaded in shard order)."""
    if steps:
        shell = shell_of(phi_amps, num_qubits)
        _apply_steps(shell, steps)
        phi_amps = state_of(shell)
    if isinstance(lam_amps, (list, tuple)):
        re, im = R.inner_product_shards(lam_amps, phi_amps)
    else:
        re, im = R.inner_product(lam_amps, phi_amps)
    return re if part == "re" else im


# ---------------------------------------------------------------------------
# exact daggers
# ---------------------------------------------------------------------------

def _dagger_param(shell: Qureg, name: str, vals: dict) -> None:
    """The entry's exact inverse through its own gate function (the
    runtime-value branches included): angle -> -angle for the rotation and
    phase families, (alpha, beta) -> (conj alpha, -beta) for the
    compact-unitary family."""
    if name in ("compactUnitary", "controlledCompactUnitary"):
        alpha, beta = vals["alpha"], vals["beta"]
        alpha = torch.conj(alpha) if isinstance(alpha, torch.Tensor) else np.conj(alpha)
        lead = ((vals["control"],) if name.startswith("controlled") else ())
        getattr(G, name)(shell, *lead, vals["target"], alpha, -beta)
        return
    fields = _FIELDS[name]
    args = [vals[f] for f in fields]
    args[fields.index("angle")] = -vals["angle"]
    getattr(G, name)(shell, *args)


def _apply_event_dagger(shell: Qureg, ev) -> None:
    """Invert one captured GateEvent through the gate primitives."""
    from ..fusion import event_dagger
    from ..ops import apply as K

    try:
        inv = event_dagger(ev)
    except ValueError as e:  # pragma: no cover - guarded by the plan
        raise QuESTError(str(e), "gradient") from None
    if inv.kind == "matrix":
        G._apply_gate_matrix(shell, inv.matrix, inv.targets, inv.controls, inv.states)
    elif inv.kind == "diag":
        G._apply_gate_diag(shell, inv.diag, inv.targets, inv.controls)
    elif inv.kind == "x":
        G._apply_gate_x(shell, inv.targets, inv.controls, inv.states)
    elif inv.kind == "parity":
        G._apply_gate_parity_phase(shell, inv.theta, inv.targets, inv.controls)
    elif inv.kind == "swap" and shell.shards is not None:
        # over shards: the engine's swap, or a controlled one as its matrix
        if inv.controls:
            swap = np.eye(4)[[0, 2, 1, 3]]
            G._apply_gate_matrix(shell, swap, inv.targets, inv.controls)
        else:
            from ..parallel.scheduler import engine
            shell.put_shards(engine(shell).apply_swap(
                shell.shards, n=shell.num_qubits_in_state_vec, qb1=inv.targets[0],
                qb2=inv.targets[1]))
    elif inv.kind == "swap":
        shell.put(K.apply_swap(shell.amps, n=shell.num_qubits_in_state_vec,
                               qb1=inv.targets[0], qb2=inv.targets[1],
                               controls=inv.controls))
    else:  # pragma: no cover - event_dagger returns unitary kinds only
        raise QuESTError(f"cannot apply a '{inv.kind}' event", "gradient")


# ---------------------------------------------------------------------------
# backward plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _EntryPlan:
    name: str
    param: bool
    view: Optional[tuple] = None      # ((field, template value), ...)
    post: tuple = ()
    pre: tuple = ()
    events: tuple = ()                # captured GateEvents (a concrete entry)


def _site(idx, name):
    return f"tape[{idx}]:{name}"


def _capture_events(fn, args, kwargs, idx, name, num_qubits, dtype):
    """A concrete entry's invertible GateEvents, or a typed lift-time
    error naming the site."""
    from .. import fusion

    if fn is fusion._apply_dense_block:
        block = args[0]
        return (fusion.GateEvent("matrix", tuple(block.qubits),
                                 matrix=np.asarray(block.matrix)),)
    if fn is G._apply_gate_diag:
        return (fusion.GateEvent("diag", tuple(args[1]),
                                 diag=np.asarray(args[0]).reshape(-1)),)
    if fn in (fusion._apply_pallas_run, fusion._apply_frame_swap):
        raise QuESTError(
            f"Circuit.gradient: {_site(idx, name)} is a fused-run plan entry with no "
            "gate-by-gate inverse; differentiate the raw circuit, or one planned by "
            "fused() without pallas (the gradient is one compiled program either way)",
            "gradient")
    events = fusion.capture(fn, args, kwargs, num_qubits, dtype)
    if events is None or any(ev.kind == "channel" or ev.extended for ev in events):
        hint = (" -- compose measurement statistics via sample_request instead of "
                "differentiating through them"
                if ("easure" in name or "collapse" in name.lower()) else "")
        raise QuESTError(f"Circuit.gradient: {_site(idx, name)} is not invertible, so the "
                         f"adjoint backward sweep cannot cross it{hint}", "gradient")
    return tuple(events)


#: the plan and reduce caches key on the LiftedTape's identity (its
#: kwargs make it unhashable); a cached value keeps the tape alive, so ids
#: stay unique. A Circuit memoizes its lifted tape per revision.
_PLAN_CACHE: dict = {}
_REDUCE_CACHE: dict = {}


def _plan_cached(lifted, num_qubits, dtype):
    key = (id(lifted), num_qubits, dtype)
    hit = _PLAN_CACHE.get(key)
    if hit is not None:
        return hit[1], hit[2]
    plans, stop = _plan_build(lifted, num_qubits, dtype)
    _PLAN_CACHE[key] = (lifted, plans, stop)
    return plans, stop


def _plan_build(lifted, num_qubits, dtype):
    entries = lifted.entries
    plans = [None] * len(entries)
    first_slot = None
    for idx, (fn, args, kwargs) in enumerate(entries):
        name = getattr(fn, "__name__", str(fn))
        if name in _FIELDS:
            view = _entry_view(name, args, kwargs)
            post, pre = _rules(name, view)
            plans[idx] = _EntryPlan(name, True, tuple(view.items()), post, pre)
            if first_slot is None:
                first_slot = idx
        elif _slot_refs(args, kwargs):
            # a slot outside the differentiable families is a stochastic
            # seed (trajectory noise, a mid-circuit measurement)
            hint = ("mid-circuit measurement" if name == "applyMidMeasurement"
                    else "trajectory noise")
            raise QuESTError(
                f"Circuit.gradient: {_site(idx, name)} is a {hint} site -- an "
                "undifferentiable stochastic seam; compose it via sample_request instead "
                "of differentiating through it", "gradient")
        else:
            plans[idx] = (fn, args, kwargs, name)  # resolved below
    if first_slot is None:
        raise QuESTError("Circuit.gradient: tape has no differentiable parameter slots "
                         "(no rotation/phase/compact-unitary entries)", "gradient")
    # the entries before the first slot are the effective initial state:
    # the backward walk never crosses them, so they need no inverse
    for idx in range(first_slot + 1, len(entries)):
        if isinstance(plans[idx], _EntryPlan):
            continue
        fn, args, kwargs, name = plans[idx]
        events = _capture_events(fn, args, kwargs, idx, name, num_qubits, dtype)
        plans[idx] = _EntryPlan(name, False, events=events)
    return tuple(plans[first_slot:]), first_slot


def _dtype(dtype) -> torch.dtype:
    from ..precision import as_torch_dtype, real_dtype
    return real_dtype() if dtype is None else as_torch_dtype(dtype)


def plan_backward(lifted, num_qubits: int, dtype=None):
    """``(plans, stop)``: the backward plan of entries ``stop..P-1``
    (``stop`` = the first slot-bearing entry; the prefix is the effective
    initial state). Raises a typed QuESTError naming the first
    non-invertible site."""
    return _plan_cached(lifted, num_qubits, _dtype(dtype))


def check_differentiable(circuit, dtype=None) -> int:
    """Check that every entry of the tape can be differentiated by the
    adjoint sweep and return the slot count; else a typed QuESTError
    naming the site."""
    if circuit.is_density_matrix:
        raise QuESTError("Circuit.gradient: density-matrix tapes are not supported by the "
                         "adjoint sweep (<lambda|dG|phi> needs pure states); use a "
                         "state-vector register", "gradient")
    lifted = circuit.lifted()
    plan_backward(lifted, circuit.num_qubits, dtype)
    return len(lifted.slots)


# ---------------------------------------------------------------------------
# the reduce: forward value + backward sweep, one program
# ---------------------------------------------------------------------------

def _accumulate(grads, ref, g, comp):
    if comp == "im":
        g = (_CPLX_IM * 1j) * g
    cur = grads[ref.index]
    grads[ref.index] = g if cur is None else cur + g


def _cached_reduce(lifted, num_qubits, codes, coeffs, dtype):
    key = (id(lifted), num_qubits, codes, coeffs, dtype)
    hit = _REDUCE_CACHE.get(key)
    if hit is not None:
        return hit[1]
    plans, _stop = _plan_cached(lifted, num_qubits, dtype)
    slots = lifted.slots
    slot_count = len(slots)

    def grad_fn(amps, values):
        lam = apply_hamiltonian(amps, codes=codes, coeffs=coeffs, num_qubits=num_qubits)
        value = expectation_value(amps, lam)
        grads = [None] * slot_count
        # shells of the state (its shards, on a sharded register: each
        # dagger then reaches the engine over shards gate by gate)
        phi = shell_of(amps, num_qubits)
        lamq = shell_of(lam, num_qubits)
        for plan in reversed(plans):
            if plan.param:
                view = dict(plan.view)
                vals = {f: (values[v.index] if isinstance(v, _SlotRef) else v)
                        for f, v in view.items()}
                for field, coef, part, steps, comp in plan.post:
                    g = coef * _bracket(state_of(lamq), state_of(phi), steps, num_qubits, part)
                    _accumulate(grads, view[field], g, comp)
                _dagger_param(phi, plan.name, vals)
                for field, coef, part, steps, comp in plan.pre:
                    g = coef * _bracket(state_of(lamq), state_of(phi), steps, num_qubits, part)
                    _accumulate(grads, view[field], g, comp)
                _dagger_param(lamq, plan.name, vals)
            else:
                for ev in reversed(plan.events):
                    _apply_event_dagger(phi, ev)
                for ev in reversed(plan.events):
                    _apply_event_dagger(lamq, ev)
        slot_grads = tuple(g if g is not None else torch.real(values[i]) * 0.0
                           for i, g in enumerate(grads))
        named: dict = {}
        for s, g in zip(slots, slot_grads):
            if s.name is not None:
                named[s.name] = named[s.name] + g if s.name in named else g
        return {"value": value, "grads": named, "slot_grads": slot_grads}

    grad_fn.wants_values = True
    grad_fn.dispatch_route = "grad_request"
    grad_fn.num_slots = slot_count
    grad_fn.hamiltonian = (codes, coeffs)
    _REDUCE_CACHE[key] = (lifted, grad_fn)
    return grad_fn


def grad_reduce(circuit, hamiltonian, *, dtype=None):
    """The values-aware terminal stage of a circuit's adjoint gradient:
    ``reduce(psi, values) -> {"value", "grads", "slot_grads"}``. Cached per
    (tape revision, Hamiltonian, dtype), so a warm optimizer loop reuses
    one executable."""
    codes, coeffs = hamiltonian_terms(hamiltonian, circuit.num_qubits)
    check_differentiable(circuit, dtype)
    return _cached_reduce(circuit.lifted(), circuit.num_qubits, codes, coeffs,
                          _dtype(dtype))


# ---------------------------------------------------------------------------
# host-facing executable
# ---------------------------------------------------------------------------

class GradExecutable:
    """A compiled gradient program bound to one circuit's slot layout.
    ``__call__(amps, params)`` runs forward + backward + accumulation as ONE
    program (``device_dispatch_total{route="grad_request"}``) and returns
    ``{"value", "grads", "slot_grads"}``: the value and every slot's
    derivative as 0-d tensors on the state's device, ``grads`` the named
    Params' (shared slots summed)."""

    def __init__(self, ex, reduce_fn):
        self._ex = ex
        self._reduce = reduce_fn
        self.lifted = ex.lifted
        self.fingerprint = ex.fingerprint

    @property
    def param_names(self):
        return self._ex.param_names

    @property
    def num_slots(self):
        return self._reduce.num_slots

    @property
    def captures(self) -> list:
        """(seconds, device bytes) of every capture the program made."""
        return self._ex.captures

    @property
    def program(self):
        """The compiled program (``_capture.Program``: its pieces' graphs)."""
        return self._ex.program

    def bind(self, params=None, device=True):
        return self._ex.bind(params, device)

    def with_values(self, amps, values):
        telemetry.inc("grad_requests_total")
        telemetry.inc("grad_slots_total", self._reduce.num_slots)
        telemetry.inc("device_dispatch_total", route="grad_request")
        return self._ex.with_values(amps, values)

    def __call__(self, amps, params=None):
        first = amps[0] if isinstance(amps, (list, tuple)) else amps
        return self.with_values(amps, self.bind(params, first.device))


def gradient_executable(circuit, hamiltonian, *, donate: bool = True, dtype=None):
    """Compile ``circuit``'s adjoint gradient against a Pauli-sum
    Hamiltonian: the implementation behind :meth:`Circuit.gradient`."""
    reduce_fn = grad_reduce(circuit, hamiltonian, dtype=dtype)
    ex = circuit.parameterized(donate=donate, reduce=reduce_fn)
    return GradExecutable(ex, reduce_fn)
