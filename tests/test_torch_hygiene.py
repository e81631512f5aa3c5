"""The port stands alone: importing it (or an on-card script) pulls
in neither JAX nor quest_tpu, and its entry point never picks the CPU by
itself."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import quest_tpu_torch as tq

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("module", ["quest_tpu_torch", "chip_smoke", "chip_lane_u_breakdown",
                                    "chip_phase_times"])
def test_import_pulls_in_no_jax(module):
    # every module of the port, found by walking the package
    code = (f"import sys, json, importlib, pkgutil, {module}, quest_tpu_torch; "
            "mods = [importlib.import_module(m.name) for m in pkgutil.walk_packages("
            "quest_tpu_torch.__path__, 'quest_tpu_torch.')]; "
            "assert {'quest_tpu_torch.decoherence', 'quest_tpu_torch.channels', "
            "'quest_tpu_torch.ops.density', 'quest_tpu_torch.ops.measure', "
            "'quest_tpu_torch.datatypes', 'quest_tpu_torch.operators', "
            "'quest_tpu_torch.ops.window_dot', 'quest_tpu_torch.parallel', "
            "'quest_tpu_torch.parallel.mesh', 'quest_tpu_torch.parallel.exchange', "
            "'quest_tpu_torch.parallel.scheduler', 'quest_tpu_torch.reporting', "
            "'quest_tpu_torch.ops.phasefunc', 'quest_tpu_torch.ops.diagonal', "
            "'quest_tpu_torch.ops.reduce', 'quest_tpu_torch.registers', "
            "'quest_tpu_torch.trajectories', 'quest_tpu_torch.trajectories.sample', "
            "'quest_tpu_torch.trajectories.noise', 'quest_tpu_torch.trajectories.ensemble', "
            "'quest_tpu_torch.engine.pool', 'quest_tpu_torch.resilience.retry', "
            "'quest_tpu_torch.checkpoint', 'quest_tpu_torch.resilience.segmented'} "
            "<= {m.__name__ for m in mods}; "
            "print(json.dumps(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'quest_tpu'))))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_env_raises_without_cuda_unless_cpu_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default env is valid here")
    with pytest.raises(tq.QuESTError, match='device="cpu"'):
        tq.createQuESTEnv()
    with pytest.raises(tq.QuESTError, match='device="cpu"'):
        tq.createQuESTEnv(device="cuda:0")
    env = tq.createQuESTEnv(device="cpu")
    assert env.device == torch.device("cpu")
    assert tq.createQureg(3, env).amps.device.type == "cpu"


#: the public names the trajectories-and-pool slice and the checkpoint and
#: segmented-execution slice brought to the port, each where the JAX
#: package exports it
SLICE_NAMES = {
    "quest_tpu_torch": ("EnginePool", "trajectories", "run_ensemble", "applyTrajectoryKraus",
                        "unravel", "ensemble_density", "QuESTRetryError",
                        "checkpoint", "saveQureg", "loadQureg", "verify_snapshot",
                        "writeStateToCSV", "resume_segmented", "QuESTChecksumError",
                        "QuESTPreemptionError"),
    "quest_tpu_torch.engine": ("EnginePool", "pool"),
    "quest_tpu_torch.resilience": ("retry", "QuESTRetryError", "RetryPolicy",
                                   "call_with_retry", "default_policy", "KernelCompileFault",
                                   "segmented", "segment_plan", "run_segmented",
                                   "resume_segmented", "QuESTChecksumError",
                                   "QuESTPreemptionError"),
    "quest_tpu_torch.trajectories": ("unravel", "run_ensemble", "ensemble_density",
                                     "TrajectoryResult", "trajectory_count_default",
                                     "applyTrajectoryKraus", "apply_traj_kraus",
                                     "DEFAULT_TRAJECTORIES", "SEED_PARAM"),
}


@pytest.mark.parametrize("module", sorted(SLICE_NAMES))
def test_trajectories_and_pool_names_exported(module):
    import importlib

    mod = importlib.import_module(module)
    ref = importlib.import_module(module.replace("quest_tpu_torch", "quest_tpu"))
    for name in SLICE_NAMES[module]:
        assert hasattr(mod, name), f"{module} lacks {name}"
        assert hasattr(ref, name), f"{name} is not a public name of the JAX package"
        if hasattr(mod, "__all__") and name in getattr(ref, "__all__", ()):
            assert name in mod.__all__, f"{name} missing from {module}.__all__"
    if module == "quest_tpu_torch":
        assert callable(mod.Circuit.run_segmented) and callable(ref.Circuit.run_segmented)
