"""General gate application: the per-gate engine every unitary reduces to.

View the planar (2, 2^n) state grouped over the touched qubits
(:mod:`.layout`), permute the control axes and then the target axes
(most-significant first) to the front, and apply the 2^t x 2^t matrix as
four real matmuls over the planes. This is the route of the planner's
dense-block items (``fusion._apply_dense_block``) and of a plain per-gate
replay; fused gate runs take ``ops.fused_gates`` instead.

Matrix index convention matches the reference (multiQubitUnitary doc): row
index ``sum_k bit(targets[k]) << k``, targets[0] the least-significant bit.
Matrices arrive planar: shape (2, 2^t, 2^t), on the state's device.

Every function returns a new tensor and leaves its input as it was.
"""

from __future__ import annotations

import torch

from .layout import grouped_axes, inverse_permutation

# A float32 matmul on the card may run in TF32 (about three decimal digits)
# when this flag is on; amplitude evolution needs full float32, so the port
# turns it off explicitly rather than relying on PyTorch's default.
torch.backends.cuda.matmul.allow_tf32 = False


def _plan(n, targets, controls):
    """(shape, perm, inv_perm) with the planar axis pinned at 0, the control
    axes next, then the target axes most-significant first."""
    shape, axis_of = grouped_axes(n, tuple(targets) + tuple(controls))
    ctrl_axes = [axis_of[c] + 1 for c in controls]
    targ_axes = [axis_of[q] + 1 for q in reversed(targets)]
    rest = [a for a in range(1, len(shape) + 1)
            if a not in ctrl_axes and a not in targ_axes]
    perm = tuple([0] + ctrl_axes + targ_axes + rest)
    return (2,) + shape, perm, inverse_permutation(perm)


def _grouped(amps, n, targets, controls):
    """The grouped, permuted view as a NEW contiguous tensor (one copy):
    where the permutation only moves size-1 axes (targets on the top
    qubits), ``contiguous()`` would return a view of ``amps`` itself, and
    the functions below, which write into the grouped tensor, would change
    their input. A clone never aliases, also for a state with no storage of
    its own (a lane of ``torch.func.vmap``)."""
    shape, perm, inv = _plan(n, targets, controls)
    return amps.reshape(shape).permute(perm).clone(memory_format=torch.contiguous_format), inv


def _ungroup(tensor, inv):
    return tensor.permute(inv).reshape(2, -1)


def _sub(tensor, controls, states):
    """The control-satisfied sub-block (a view), or the whole tensor."""
    if not controls:
        return tensor
    return tensor[(slice(None),) + tuple(states)]


def apply_matrix(amps: torch.Tensor, matrix: torch.Tensor, *, n: int,
                 targets: tuple, controls: tuple = (),
                 control_states: tuple = (), conj: bool = False) -> torch.Tensor:
    """amps' = (control-gated) M applied to ``targets`` of the n-qubit state.

    ``control_states`` optionally gives the required value of each control
    (default all 1, as multiStateControlledUnitary, QuEST.h:4448).
    ``conj=True`` applies the elementwise conjugate of M."""
    dim = 1 << len(targets)
    states = control_states if control_states else (1,) * len(controls)
    mr, mi = matrix[0], matrix[1]
    if conj:
        mi = -mi
    tensor, inv = _grouped(amps, n, targets, controls)
    sub = _sub(tensor, controls, states)
    flat = sub.reshape(2, dim, -1)
    rr = mr @ flat[0] - mi @ flat[1]
    ii = mr @ flat[1] + mi @ flat[0]
    if torch.is_grad_enabled() and (matrix.requires_grad or amps.requires_grad):
        # autograd keeps ``flat`` for the products' backward: write into a
        # copy, so that the differentiable replay (a gradient oracle) holds
        tensor = tensor.clone()
        sub = _sub(tensor, controls, states)
    sub.copy_(torch.stack([rr, ii]).reshape(sub.shape))
    return _ungroup(tensor, inv)


def apply_x_class(amps: torch.Tensor, *, n: int, targets: tuple,
                  controls: tuple = (), control_states: tuple = ()) -> torch.Tensor:
    """Multi-controlled multi-qubit NOT: an amplitude permutation (flip of
    the target axes of the control-satisfied sub-block)."""
    states = control_states if control_states else (1,) * len(controls)
    tensor, inv = _grouped(amps, n, targets, controls)
    sub = _sub(tensor, controls, states)
    flip_axes = list(range(1, 1 + len(targets)))
    sub.copy_(torch.flip(sub, dims=flip_axes))
    return _ungroup(tensor, inv)


def apply_swap(amps: torch.Tensor, *, n: int, qb1: int, qb2: int,
               controls: tuple = ()) -> torch.Tensor:
    """SWAP as an axis transposition (statevec_swapQubitAmps,
    ``QuEST_cpu.c:3850-3931``), gated on all-1 controls."""
    tensor, inv = _grouped(amps, n, (qb1, qb2), controls)
    sub = _sub(tensor, controls, (1,) * len(controls))
    sub.copy_(sub.transpose(1, 2).clone())
    return _ungroup(tensor, inv)
