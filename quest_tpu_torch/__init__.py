"""quest_tpu_torch: the PyTorch/CUDA port of quest_tpu for NVIDIA Hopper.

The QuEST API under the reference's names, on the same planar (2, 2^n)
real amplitude layout as ``quest_tpu`` (a density matrix of n qubits is a
2n-qubit state, row bits low). Registers live on the card
(``createQuESTEnv()`` = ``cuda:0``) unless the caller passes
``device="cpu"``. Fused gate runs, decoherence channels among them,
execute on the card through the hand-written CUDA kernel
``csrc/fused_gates.cu``, in float32 and float64; a dense unitary on a
contiguous qubit window through ``csrc/window_dot.cu``
(``ops.window_dot``). Every function of the reference's API surface that
``quest_tpu`` exports is here. ``Circuit.run`` and the compiled routes
(``compiled``, ``compiled_segments``, ``compiled_blocks``,
``compiled_request``, ``parameterized`` with :class:`Param` values) run a
tape on the card as CUDA-graph replays (``_capture``); :class:`Engine`
serves parameter sweeps as micro-batched, lane-batched replays
(``engine``), with the typed failures of ``resilience``. ``sampling``
draws shot tables on the device from the JAX package's counter-based
stream (``sampleQureg``, one-dispatch ``sample_request``, the recordable
``applyMidMeasurement`` / ``applyMidCollapse``); ``gradients`` computes
adjoint-state gradients (``Circuit.gradient``, ``calcGradExpecPauliSum``,
``Engine.submit_grad``, ``parameter_shift`` as the oracle);
``trajectories`` unravels noisy circuits into seeded pure-state ensembles
(``unravel``, ``applyTrajectoryKraus``, ``run_ensemble``,
``ensemble_density``); :class:`EnginePool` serves many structures over
replicas of Engines with failover and hedging. ``checkpoint`` saves and
loads registers in the JAX package's on-disk format (``saveQureg``,
``loadQureg``, ``verify_snapshot``, ``writeStateToCSV``);
``Circuit.run_segmented`` and :func:`resume_segmented` run a tape in
checkpointed segments that a preempted run resumes bit for bit.

This package imports ``torch`` and never ``jax`` or ``quest_tpu``.
"""

from .calculations import *  # noqa: F401,F403
from .calculations import __all__ as _calculations_all
from . import engine
from .circuits import Circuit, density_circuit, random_layers, serving_ansatz
from .datatypes import *  # noqa: F401,F403
from .datatypes import __all__ as _datatypes_all
from .decoherence import *  # noqa: F401,F403
from .decoherence import __all__ as _decoherence_all
from .engine import Engine, EnginePool, P, Param
from . import gradients, sampling
from .gradients import gradient_executable, parameter_shift
from .sampling import applyMidCollapse, applyMidMeasurement, sample_request, sampleQureg
from . import checkpoint, resilience
from .checkpoint import loadQureg, saveQureg, verify_snapshot, writeStateToCSV
from .resilience import (QuESTBackpressureError, QuESTCancelledError, QuESTChecksumError,
                         QuESTHangError, QuESTIntegrityError, QuESTPreemptionError,
                         QuESTRetryError, QuESTTimeoutError, resume_segmented)
from . import trajectories
from .trajectories import applyTrajectoryKraus, ensemble_density, run_ensemble, unravel
from .environment import (QuESTEnv, createQuESTEnv, destroyQuESTEnv,
                          getEnvironmentString, getQuESTSeeds, reportQuESTEnv,
                          seedQuEST, seedQuESTDefault, syncQuESTEnv,
                          syncQuESTSuccess)
from .gates import *  # noqa: F401,F403
from .gates import __all__ as _gates_all
from .operators import *  # noqa: F401,F403
from .operators import __all__ as _operators_all
from .registers import (Qureg, copyStateFromGPU, copyStateToGPU, copySubstateFromGPU,
                        copySubstateToGPU, createCloneQureg, createDensityQureg, createQureg,
                        destroyQureg, get_np)
from .reporting import *  # noqa: F401,F403
from .reporting import __all__ as _reporting_all
from .state_init import *  # noqa: F401,F403
from .state_init import __all__ as _state_init_all
from .validation import (QuESTError, invalid_quest_input_error,
                         invalidQuESTInputError, set_input_error_handler)

__all__ = [
    "QuESTEnv", "createQuESTEnv", "destroyQuESTEnv", "syncQuESTEnv",
    "syncQuESTSuccess", "reportQuESTEnv", "getEnvironmentString", "seedQuEST",
    "seedQuESTDefault", "getQuESTSeeds",
    "Qureg", "createQureg", "createDensityQureg", "createCloneQureg",
    "destroyQureg", "get_np", "copyStateToGPU", "copyStateFromGPU",
    "copySubstateToGPU", "copySubstateFromGPU",
    *_datatypes_all, *_state_init_all, *_gates_all, *_operators_all,
    *_decoherence_all, *_calculations_all, *_reporting_all,
    "Circuit", "random_layers", "density_circuit", "serving_ansatz", "engine", "P",
    "Param", "Engine", "EnginePool", "resilience", "QuESTError", "QuESTTimeoutError",
    "QuESTBackpressureError", "QuESTCancelledError", "QuESTIntegrityError",
    "QuESTHangError", "QuESTRetryError", "QuESTChecksumError", "QuESTPreemptionError",
    "checkpoint", "saveQureg", "loadQureg", "verify_snapshot", "writeStateToCSV",
    "resume_segmented", "trajectories", "unravel", "applyTrajectoryKraus",
    "run_ensemble", "ensemble_density", "sampling", "gradients", "sampleQureg", "sample_request",
    "applyMidMeasurement", "applyMidCollapse", "gradient_executable", "parameter_shift",
    "invalidQuESTInputError", "invalid_quest_input_error", "set_input_error_handler",
]
