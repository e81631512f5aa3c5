"""Qureg: the qubit register (reference struct at QuEST.h:360-396).

A thin mutable handle around one planar tensor of shape
(2, 2^numQubitsInStateVec): real plane, imaginary plane, the SoA layout of
the reference's ComplexArray (QuEST.h:94-98) and of ``quest_tpu``.

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

    @property
    def num_qubits_in_state_vec(self) -> int:
        return (2 if self.is_density_matrix else 1) * self.num_qubits_represented

    @property
    def num_amps_total(self) -> int:
        return 1 << self.num_qubits_in_state_vec

    @property
    def dtype(self) -> torch.dtype:
        """Real dtype of the planar amplitude planes (float32/float64)."""
        return self.amps.dtype

    @property
    def device(self) -> torch.device:
        return self.amps.device

    @property
    def eps(self) -> float:
        return precision.eps_for_dtype(self.amps.dtype)

    def put(self, new_amps: torch.Tensor) -> None:
        """Rebind the amplitude tensor."""
        self.amps = new_amps

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
        return (f"Qureg({kind}, qubits={self.num_qubits_represented}, "
                f"amps=2^{self.num_qubits_in_state_vec}, dtype={self.amps.dtype}, "
                f"device={self.amps.device})")


def createQureg(num_qubits: int, env: QuESTEnv, precision_code: int | None = None) -> Qureg:
    """State-vector register in |0...0> on the env's device (createQureg,
    QuEST.h:579)."""
    func = "createQureg"
    validation._assert(num_qubits > 0, "Invalid number of qubits. Must create >0.", func)
    validation.validate_num_amps_fit_type(num_qubits, False, func)
    dtype = precision.real_dtype(precision_code)
    amps = validation.validate_qureg_allocation(
        lambda: ops_init.init_classical(1 << num_qubits, dtype, env.device, 0),
        func)
    q = Qureg(num_qubits, False, amps, env)
    q.qasm_log = QASMLogger(num_qubits, dtype)
    return q


def createDensityQureg(num_qubits: int, env: QuESTEnv,
                       precision_code: int | None = None) -> Qureg:
    """Density-matrix register in |0><0| on the env's device
    (createDensityQureg, QuEST.h:673): a 2n-qubit flattened state, row bits
    low and column bits high."""
    func = "createDensityQureg"
    validation._assert(num_qubits > 0, "Invalid number of qubits. Must create >0.", func)
    validation.validate_num_amps_fit_type(num_qubits, True, func)
    dtype = precision.real_dtype(precision_code)
    amps = validation.validate_qureg_allocation(
        lambda: ops_init.init_classical(1 << (2 * num_qubits), dtype, env.device, 0),
        func)
    q = Qureg(num_qubits, True, amps, env)
    q.qasm_log = QASMLogger(num_qubits, dtype)
    return q


def destroyQureg(qureg: Qureg, env: QuESTEnv | None = None) -> None:
    """Release the device buffers (destroyQureg, QuEST.h:716)."""
    qureg.amps = None
    qureg.spare = None


def get_np(qureg: Qureg) -> np.ndarray:
    """The full amplitude vector on the host as numpy complex (tests /
    reporting)."""
    from .ops import cplx
    return cplx.to_complex(qureg.amps)
