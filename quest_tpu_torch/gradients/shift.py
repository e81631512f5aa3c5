"""Parameter-shift gradients: the independent second oracle
(``quest_tpu/gradients/shift.py``).

Not a serving route -- 2P (or 4P) whole replays a gradient where the
adjoint sweep does about three -- but an analytically exact check that
shares nothing with the adjoint code beyond the forward replay. Rotation
generators with eigenvalues +-1 and the phase family obey the two-term
rule

    dE/dtheta = [E(theta + pi/2) - E(theta - pi/2)] / 2,

while controlled rotations (generator eigenvalues {-1, 0, +1}) need the
four-term rule

    dE/dtheta = c+ [E(theta + pi/2) - E(theta - pi/2)]
              - c- [E(theta + 3pi/2) - E(theta - 3pi/2)],
    c+- = (sqrt 2 +- 1) / (4 sqrt 2).

Complex (compact-unitary) slots have no shift rule; asking for one raises.
"""

from __future__ import annotations

import numpy as np

from ..engine.params import _SlotRef, bind_host, stack_values
from ..validation import QuESTError
from .adjoint import _FIELDS, _entry_view
from .expectation import hamiltonian_terms

__all__ = ["parameter_shift"]

#: the four-term rule's coefficients, for {-1, 0, +1} generator spectra
_C_PLUS = (np.sqrt(2.0) + 1.0) / (4.0 * np.sqrt(2.0))
_C_MINUS = (np.sqrt(2.0) - 1.0) / (4.0 * np.sqrt(2.0))

#: families whose E(theta) is a pure frequency-1 trigonometric polynomial
_TWO_TERM = {
    "rotateX", "rotateY", "rotateZ", "rotateAroundAxis", "multiRotateZ",
    "multiRotatePauli", "phaseShift", "controlledPhaseShift",
    "multiControlledPhaseShift",
}
#: families mixing frequencies theta/2 and theta (controlled +-1 generators)
_FOUR_TERM = {
    "controlledRotateX", "controlledRotateY", "controlledRotateZ",
    "controlledRotateAroundAxis", "multiControlledMultiRotateZ",
    "multiControlledMultiRotatePauli",
}


def _slot_families(lifted) -> dict:
    """slot index -> the name of the gate family that owns it."""
    fam = {}
    for fn, args, kwargs in lifted.entries:
        name = getattr(fn, "__name__", str(fn))
        if name not in _FIELDS:
            continue
        for v in _entry_view(name, args, kwargs).values():
            if isinstance(v, _SlotRef):
                fam[v.index] = name
    return fam


def parameter_shift(circuit, hamiltonian, amps, params=None) -> dict:
    """The full gradient of <H> by parameter shifts: ``{"value", "grads",
    "slot_grads"}`` as host floats, in :func:`..adjoint.grad_reduce`'s
    layout. Every shifted evaluation replays the SAME cached expectation
    executable (``parameterized`` with ``expectation_reduce``) with
    shifted values, 2 to 4 of them a slot: an oracle, not a serving
    route. ``amps`` is read, never written."""
    from ..sampling.request import expectation_reduce

    codes, coeffs = hamiltonian_terms(hamiltonian, circuit.num_qubits)
    red = expectation_reduce(n=circuit.num_qubits, codes=codes, coeffs=coeffs,
                             density=circuit.is_density_matrix)
    ex = circuit.parameterized(donate=False, reduce=red)
    lifted = ex.lifted
    values = list(bind_host(lifted, params))
    fam = _slot_families(lifted)

    def energy(vals):
        return float(ex.with_values(amps, stack_values(lifted, [tuple(vals)], amps.device,
                                                       stacked=False)))

    def shifted(idx, delta):
        vals = list(values)
        vals[idx] = float(vals[idx]) + delta
        return energy(vals)

    slot_grads = []
    for s in lifted.slots:
        name = fam.get(s.index)
        if s.kind != "real" or name is None:
            raise QuESTError(f"parameter_shift: slot {s.index} ({s.kind}, "
                             f"{name or 'unknown family'}) has no shift rule -- use "
                             "torch.autograd or the adjoint engine", "parameter_shift")
        if name in _TWO_TERM:
            g = (shifted(s.index, np.pi / 2) - shifted(s.index, -np.pi / 2)) / 2.0
        else:
            g = (_C_PLUS * (shifted(s.index, np.pi / 2) - shifted(s.index, -np.pi / 2))
                 - _C_MINUS * (shifted(s.index, 3 * np.pi / 2)
                               - shifted(s.index, -3 * np.pi / 2)))
        slot_grads.append(g)

    named: dict = {}
    for s, g in zip(lifted.slots, slot_grads):
        if s.name is not None:
            named[s.name] = named.get(s.name, 0.0) + g
    return {"value": energy(values), "grads": named, "slot_grads": tuple(slot_grads)}
