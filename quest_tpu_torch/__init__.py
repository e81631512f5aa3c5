"""quest_tpu_torch: the PyTorch/CUDA port of quest_tpu for NVIDIA Hopper.

The QuEST API under the reference's names, on the same planar (2, 2^n)
real amplitude layout as ``quest_tpu``. Registers live on the card
(``createQuESTEnv()`` = ``cuda:0``) unless the caller passes
``device="cpu"``. Fused gate runs execute on the card through the
hand-written CUDA kernel ``csrc/fused_gates.cu``.

This package imports ``torch`` and never ``jax`` or ``quest_tpu``.
"""

from .calculations import (calcProbOfOutcome, calcTotalProb, getAmp,
                           getImagAmp, getRealAmp)
from .circuits import Circuit, random_layers
from .environment import (QuESTEnv, createQuESTEnv, seedQuEST,
                          seedQuESTDefault)
from .gates import (controlledNot, controlledPhaseFlip, hadamard,
                    multiRotateZ, multiStateControlledUnitary, pauliX,
                    rotateX, rotateZ, swapGate, tGate, unitary)
from .registers import Qureg, createQureg, destroyQureg, get_np
from .state_init import (initBlankState, initClassicalState, initDebugState,
                         initPlusState, initZeroState)
from .validation import QuESTError

__all__ = [
    "QuESTEnv", "createQuESTEnv", "seedQuEST", "seedQuESTDefault",
    "Qureg", "createQureg", "destroyQureg", "get_np",
    "initBlankState", "initZeroState", "initPlusState", "initClassicalState",
    "initDebugState",
    "hadamard", "tGate", "rotateZ", "rotateX", "controlledNot",
    "controlledPhaseFlip", "unitary", "multiRotateZ", "swapGate",
    "multiStateControlledUnitary", "pauliX",
    "calcTotalProb", "calcProbOfOutcome", "getAmp", "getRealAmp", "getImagAmp",
    "Circuit", "random_layers", "QuESTError",
]
