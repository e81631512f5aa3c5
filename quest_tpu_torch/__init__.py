"""quest_tpu_torch: the PyTorch/CUDA port of quest_tpu for NVIDIA Hopper.

The QuEST API under the reference's names, on the same planar (2, 2^n)
real amplitude layout as ``quest_tpu`` (a density matrix of n qubits is a
2n-qubit state, row bits low). Registers live on the card
(``createQuESTEnv()`` = ``cuda:0``) unless the caller passes
``device="cpu"``. Fused gate runs, decoherence channels among them,
execute on the card through the hand-written CUDA kernel
``csrc/fused_gates.cu``, in float32 and float64.

This package imports ``torch`` and never ``jax`` or ``quest_tpu``.
"""

from .calculations import (calcProbOfOutcome, calcPurity, calcTotalProb,
                           getAmp, getDensityAmp, getImagAmp, getRealAmp)
from .circuits import Circuit, density_circuit, random_layers
from .decoherence import (mixDamping, mixDephasing, mixDepolarising,
                          mixKrausMap, mixMultiQubitKrausMap,
                          mixNonTPKrausMap, mixNonTPMultiQubitKrausMap,
                          mixNonTPTwoQubitKrausMap, mixPauli,
                          mixTwoQubitDephasing, mixTwoQubitDepolarising,
                          mixTwoQubitKrausMap)
from .environment import (QuESTEnv, createQuESTEnv, seedQuEST,
                          seedQuESTDefault)
from .gates import (controlledNot, controlledPhaseFlip, hadamard,
                    multiRotateZ, multiStateControlledUnitary, pauliX,
                    rotateX, rotateZ, swapGate, tGate, unitary)
from .registers import (Qureg, createDensityQureg, createQureg, destroyQureg,
                        get_np)
from .state_init import (initBlankState, initClassicalState, initDebugState,
                         initPlusState, initPureState, initZeroState)
from .validation import QuESTError

__all__ = [
    "QuESTEnv", "createQuESTEnv", "seedQuEST", "seedQuESTDefault",
    "Qureg", "createQureg", "createDensityQureg", "destroyQureg", "get_np",
    "initBlankState", "initZeroState", "initPlusState", "initClassicalState",
    "initPureState", "initDebugState",
    "hadamard", "tGate", "rotateZ", "rotateX", "controlledNot",
    "controlledPhaseFlip", "unitary", "multiRotateZ", "swapGate",
    "multiStateControlledUnitary", "pauliX",
    "mixDephasing", "mixTwoQubitDephasing", "mixDepolarising", "mixDamping",
    "mixTwoQubitDepolarising", "mixPauli", "mixKrausMap",
    "mixTwoQubitKrausMap", "mixMultiQubitKrausMap", "mixNonTPKrausMap",
    "mixNonTPTwoQubitKrausMap", "mixNonTPMultiQubitKrausMap",
    "calcTotalProb", "calcProbOfOutcome", "calcPurity", "getAmp",
    "getRealAmp", "getImagAmp", "getDensityAmp",
    "Circuit", "random_layers", "density_circuit", "QuESTError",
]
