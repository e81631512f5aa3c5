"""Qureg: the qubit register (reference struct at QuEST.h:360-396).

A thin mutable handle around one planar tensor of shape
(2, 2^numQubitsInStateVec): real plane, imaginary plane, the SoA layout of
the reference's ComplexArray (QuEST.h:94-98) and of ``quest_tpu``.

On an env whose mesh holds D > 1 devices a state-vector register is
sharded instead: ``shards`` holds D tensors (2, 2^(n-d)), shard r on the
mesh's device r with the flat indices [r 2^(n-d), (r+1) 2^(n-d)), and
``amps`` is None (the JAX package's block sharding, registers.py:95-97;
``parallel.mesh``). A register of fewer amplitudes than devices stays on
the first device, as the JAX package keeps it unsharded. The shards are
gathered only at the API boundary (``get_np``, ``interop``, the host
mirror). A density register shards its flattened 2n-qubit state the same
way: its top qubits, column qubits while the mesh has at most 2^n
devices, are the shard index, so every shadow gate and channel (qubits
t + n) reaches the sharded zone.

The API rebinds ``qureg.amps`` to each new tensor (``put``). A fused-run
pass that folds a frame swap into its loads or stores reads tiles that
other thread blocks write, so it runs out of place: into ``spare``, a
second buffer of the register's size that is allocated once, at the first
such pass, and then ping-pongs with ``amps`` (``swap_spare``). A register
that has run such a pass therefore holds two states' worth of device
memory: 32 qubits in f32 fit an 80 GB card (2 x 32 GiB), 33 do not. A
density register of n qubits is a 2n-qubit state (row bits low, column
bits high): at 14 qubits, 2 x 2 GiB in f32 and 2 x 4 GiB in f64.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import precision, validation
from .environment import QuESTEnv
from .ops import init as ops_init
from .parallel.mesh import local_qubit_count
from .qasm import QASMLogger


@dataclass
class Qureg:
    num_qubits_represented: int
    is_density_matrix: bool
    amps: torch.Tensor
    env: Optional[QuESTEnv]
    qasm_log: Optional[QASMLogger] = None
    #: the out-of-place twin buffer (see the module docstring)
    spare: Optional[torch.Tensor] = None
    #: a sharded register's shard tensors (``amps`` is then None)
    shards: Optional[list] = None
    #: each shard's out-of-place twin, allocated at first use
    shard_spares: Optional[list] = None
    #: the host planar mirror for copyState{To,From}GPU, made at first use
    host_amps: Optional[np.ndarray] = None

    @property
    def state_vec(self) -> np.ndarray:
        """Host planar mirror (the reference's ``qureg.stateVec``); sync with
        copyStateFromGPU/copyStateToGPU."""
        return _host_mirror(self)

    @property
    def num_qubits_in_state_vec(self) -> int:
        return (2 if self.is_density_matrix else 1) * self.num_qubits_represented

    @property
    def num_amps_total(self) -> int:
        return 1 << self.num_qubits_in_state_vec

    @property
    def _first(self) -> torch.Tensor:
        return self.amps if self.shards is None else self.shards[0]

    @property
    def dtype(self) -> torch.dtype:
        """Real dtype of the planar amplitude planes (float32/float64)."""
        return self._first.dtype

    @property
    def device(self) -> torch.device:
        """The device of the state (of the first shard, when sharded)."""
        return self._first.device

    @property
    def eps(self) -> float:
        return precision.eps_for_dtype(self.dtype)

    @property
    def num_local_qubits(self) -> int:
        """Qubits below the shard boundary (all of them, unsharded)."""
        return local_qubit_count(self.num_qubits_in_state_vec, self.shards)

    def put(self, new_amps: torch.Tensor) -> None:
        """Rebind the amplitude tensor."""
        if self.shards is not None:
            raise validation.QuESTError(
                "this register is sharded over several devices: its amplitudes "
                "are rebound shard by shard", "put")
        self.amps = new_amps

    def put_shards(self, new_shards) -> None:
        """Rebind a sharded register's shard tensors."""
        self.shards = list(new_shards)

    def shard_spare_buffers(self) -> list:
        """Each shard's out-of-place twin, allocated at first use."""
        if self.shard_spares is None or any(
                s.shape != a.shape or s.dtype != a.dtype or s.device != a.device
                for s, a in zip(self.shard_spares, self.shards)):
            self.shard_spares = [torch.empty_like(a) for a in self.shards]
        return self.shard_spares

    def swap_shard_spares(self) -> None:
        """After an out-of-place pass into the spares: they become the state."""
        self.shards, self.shard_spares = self.shard_spares, self.shards

    def spare_buffer(self) -> torch.Tensor:
        """The out-of-place twin of ``amps``, allocated at first use."""
        if (self.spare is None or self.spare.shape != self.amps.shape
                or self.spare.dtype != self.amps.dtype
                or self.spare.device != self.amps.device):
            self.spare = torch.empty_like(self.amps)
        return self.spare

    def swap_spare(self) -> None:
        """After an out-of-place pass into ``spare``: it becomes the state."""
        self.amps, self.spare = self.spare, self.amps

    def __repr__(self):
        kind = "density-matrix" if self.is_density_matrix else "state-vector"
        where = (f"device={self.device}" if self.shards is None else
                 f"shards={len(self.shards)} on {[str(s.device) for s in self.shards]}")
        return (f"Qureg({kind}, qubits={self.num_qubits_represented}, "
                f"amps=2^{self.num_qubits_in_state_vec}, dtype={self.dtype}, {where})")


def sharded_over(env: QuESTEnv, num_amps: int) -> bool:
    """True when a state of ``num_amps`` amplitudes is sharded over the
    env's mesh: more than one device and at least one amplitude each."""
    return env.num_ranks > 1 and num_amps >= env.num_ranks


def createQureg(num_qubits: int, env: QuESTEnv, precision_code: int | None = None) -> Qureg:
    """State-vector register in |0...0> on the env's device, or sharded over
    its mesh (createQureg, QuEST.h:579)."""
    func = "createQureg"
    validation._assert(num_qubits > 0, "Invalid number of qubits. Must create >0.", func)
    validation.validate_num_amps_fit_type(num_qubits, False, func)
    dtype = precision.real_dtype(precision_code)
    if sharded_over(env, 1 << num_qubits):
        shards = validation.validate_qureg_allocation(
            lambda: ops_init.shards_classical(1 << num_qubits, dtype, env.devices, 0),
            func)
        q = Qureg(num_qubits, False, None, env, shards=shards)
    else:
        amps = validation.validate_qureg_allocation(
            lambda: ops_init.init_classical(1 << num_qubits, dtype, env.device, 0),
            func)
        q = Qureg(num_qubits, False, amps, env)
    q.qasm_log = QASMLogger(num_qubits, dtype)
    return q


def createDensityQureg(num_qubits: int, env: QuESTEnv,
                       precision_code: int | None = None) -> Qureg:
    """Density-matrix register in |0><0| (createDensityQureg, QuEST.h:673):
    a 2n-qubit flattened state, row bits low and column bits high, on the
    env's device, or sharded over its mesh as a state vector of 2n qubits
    is."""
    func = "createDensityQureg"
    validation._assert(num_qubits > 0, "Invalid number of qubits. Must create >0.", func)
    validation.validate_num_amps_fit_type(num_qubits, True, func)
    dtype = precision.real_dtype(precision_code)
    num_amps = 1 << (2 * num_qubits)
    if sharded_over(env, num_amps):
        shards = validation.validate_qureg_allocation(
            lambda: ops_init.shards_classical(num_amps, dtype, env.devices, 0), func)
        q = Qureg(num_qubits, True, None, env, shards=shards)
    else:
        amps = validation.validate_qureg_allocation(
            lambda: ops_init.init_classical(num_amps, dtype, env.device, 0), func)
        q = Qureg(num_qubits, True, amps, env)
    q.qasm_log = QASMLogger(num_qubits, dtype)
    return q


def createCloneQureg(qureg: Qureg, env: QuESTEnv) -> Qureg:
    """Deep copy (createCloneQureg, QuEST.h:694): new tensors on the
    source's devices (every shard of a sharded register), no spare buffer
    shared with the source, and a fresh QASM log."""
    func = "createCloneQureg"
    if qureg.shards is not None:
        shards = validation.validate_qureg_allocation(
            lambda: [s.clone() for s in qureg.shards], func)
        q = Qureg(qureg.num_qubits_represented, qureg.is_density_matrix, None, env,
                  shards=shards)
    else:
        amps = validation.validate_qureg_allocation(lambda: qureg.amps.clone(), func)
        q = Qureg(qureg.num_qubits_represented, qureg.is_density_matrix, amps, env)
    q.qasm_log = QASMLogger(qureg.num_qubits_represented, qureg.dtype)
    return q


def destroyQureg(qureg: Qureg, env: QuESTEnv | None = None) -> None:
    """Release the device buffers (destroyQureg, QuEST.h:716)."""
    qureg.amps = None
    qureg.spare = None
    qureg.shards = None
    qureg.shard_spares = None


def get_np(qureg: Qureg) -> np.ndarray:
    """The full amplitude vector on the host as numpy complex (tests /
    reporting); a sharded register's shards are gathered here."""
    from .ops import cplx
    if qureg.shards is not None:
        return np.concatenate([cplx.to_complex(s) for s in qureg.shards])
    return cplx.to_complex(qureg.amps)


# --------------------------------------------------------------------------
# Host-mirror synchronisation (copyStateToGPU/FromGPU, QuEST.h:2286-2383).
#
# The reference keeps a host planar array (qureg.stateVec) beside the device
# copy and lets users edit it directly, syncing explicitly. Here the device
# tensors are the state of record; ``qureg.state_vec`` is a planar numpy
# mirror (2, numAmps) of the state's own dtype, made at first use, that
# these four functions sync in either direction. A sharded register's
# shards are gathered into it, and scattered from it, by flat index range:
# a substate may cross a shard boundary. On a CPU register they are
# host-to-host copies, as the reference's CPU definitions are no-ops.
# --------------------------------------------------------------------------

def _host_mirror(qureg: Qureg) -> np.ndarray:
    """The mirror, made (again) where it is missing or of another dtype than
    the state (``applyPauliSum`` binds its input's dtype to its output)."""
    dt = np.float32 if qureg.dtype == torch.float32 else np.float64
    if qureg.host_amps is None or qureg.host_amps.dtype != dt:
        qureg.host_amps = np.zeros((2, qureg.num_amps_total), dtype=dt)
    return qureg.host_amps


def _validate_live(qureg: Qureg, func: str) -> None:
    validation._assert(
        qureg.amps is not None or qureg.shards is not None,
        "Invalid Qureg. The register has been destroyed.", func)


def _pull(qureg: Qureg, start: int, num: int) -> np.ndarray:
    """Copy the flat range [start, start + num) of the device tensors into
    the mirror."""
    mirror = _host_mirror(qureg)
    pieces = [qureg.amps] if qureg.shards is None else qureg.shards
    c = qureg.num_amps_total // len(pieces)
    for r, t in enumerate(pieces):
        lo, hi = max(start, r * c), min(start + num, (r + 1) * c)
        if lo < hi:
            mirror[:, lo:hi] = t[:, lo - r * c:hi - r * c].cpu().numpy()
    return mirror


def _push(qureg: Qureg, start: int, num: int) -> None:
    """Write the mirror's [start, start + num) into the device tensors, in
    place (``state_init._write_slice``, as ``setAmps`` writes)."""
    from .state_init import _write_slice

    mirror = _host_mirror(qureg)
    _write_slice(qureg, start, mirror[0, start:start + num], mirror[1, start:start + num],
                 num)


def copyStateFromGPU(qureg: Qureg) -> np.ndarray:
    """Pull the device state into the host mirror (copyStateFromGPU, QuEST.h:2321)."""
    _validate_live(qureg, "copyStateFromGPU")
    return _pull(qureg, 0, qureg.num_amps_total)


def copyStateToGPU(qureg: Qureg) -> None:
    """Push the host mirror to the device (copyStateToGPU, QuEST.h:2301)."""
    _validate_live(qureg, "copyStateToGPU")
    _push(qureg, 0, qureg.num_amps_total)


def copySubstateFromGPU(qureg: Qureg, start_ind: int, num_amps: int) -> np.ndarray:
    """Pull amplitudes [start, start+num) into the host mirror
    (copySubstateFromGPU, QuEST.h:2383)."""
    func = "copySubstateFromGPU"
    _validate_live(qureg, func)
    validation.validate_num_amps(qureg, start_ind, num_amps, func)
    return _pull(qureg, start_ind, num_amps)


def copySubstateToGPU(qureg: Qureg, start_ind: int, num_amps: int) -> None:
    """Push host-mirror amplitudes [start, start+num) to the device
    (copySubstateToGPU, QuEST.h:2352)."""
    func = "copySubstateToGPU"
    _validate_live(qureg, func)
    validation.validate_num_amps(qureg, start_ind, num_amps, func)
    _push(qureg, start_ind, num_amps)
