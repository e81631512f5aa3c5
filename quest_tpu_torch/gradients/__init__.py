"""Adjoint-mode gradients: variational traffic as first-class requests
(``quest_tpu/gradients``; Jones & Gacon, arXiv:2009.02823).

- :mod:`.adjoint` -- the reverse sweep: ``grad_reduce`` makes forward +
  backward + per-slot accumulation one values-aware terminal stage, which
  the parameterized replay and the Engine's batch body compose into ONE
  ``route=grad_request`` program; ``gradient_executable`` is the
  host-facing compile (``Circuit.gradient``).
- :mod:`.expectation` -- Pauli-sum Hamiltonians and the costate
  lambda = H|psi>.
- :mod:`.shift` -- parameter-shift rules, the independent oracle (2-4
  replays a parameter; never the serving route).

Serving: ``Engine.submit_grad(params)`` batches optimizer steps into one
lane-batched gradient program (``Engine(..., hamiltonian=...)``). On a
sharded register the state, the costate and every bracket stay a list of
shards, and each dagger reaches the engine over shards gate by gate.
"""

from .adjoint import (GradExecutable, check_differentiable, grad_reduce,  # noqa: F401
                      gradient_executable, plan_backward)
from .expectation import apply_hamiltonian, expectation_value, hamiltonian_terms  # noqa: F401
from .shift import parameter_shift  # noqa: F401

__all__ = [
    "GradExecutable", "check_differentiable", "grad_reduce", "gradient_executable",
    "plan_backward", "apply_hamiltonian", "expectation_value", "hamiltonian_terms",
    "parameter_shift",
]
