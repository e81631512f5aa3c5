"""Unravel a noisy circuit and run its trajectory ensemble through the
Engine (``quest_tpu/trajectories/ensemble.py``).

``unravel`` rewrites a density-matrix tape (gates and mix* channels) into
a state-vector tape whose channel sites are :func:`noise.applyTrajectoryKraus`
entries sharing ONE named seed Param; ``run_ensemble`` then runs T
trajectories as T bindings of that one structure through
:class:`~quest_tpu_torch.engine.Engine`: the Engine stacks the seed lanes,
so on one device the whole ensemble is one lane-batched replay (a CUDA
graph after its first call), in which each fused run of a planned tape is
one launch of the fused-run kernel for every lane.

Cost: a trajectory is a state vector, so a T-trajectory ensemble at n
qubits holds T * 2^n amplitudes against the density route's 4^n, and
reaches sizes (20q and more) where no density matrix fits. The price is
statistical: observables converge at 1/sqrt(T).
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import TYPE_CHECKING, Iterable

import numpy as np
import torch

from .. import channels as _channels
from .. import telemetry
from ..circuits import Circuit
from ..engine.params import _SEED, Param
from ..validation import QuESTError
from . import noise

if TYPE_CHECKING:
    from ..environment import QuESTEnv

__all__ = ["unravel", "run_ensemble", "ensemble_density", "trajectory_count_default",
           "TrajectoryResult", "DEFAULT_TRAJECTORIES", "SEED_PARAM"]

#: ensemble size when neither an argument nor QUEST_TRAJECTORIES says
#: otherwise: 64 keeps the 1/sqrt(T) error near 0.125 at interactive cost
DEFAULT_TRAJECTORIES = 64

#: the Param name ``unravel`` records its seed slot under
SEED_PARAM = "traj_seed"

#: general Kraus mix* entries that unravel directly (their operators are
#: explicit on the tape)
_KRAUS_MIX = {"mixKrausMap", "mixTwoQubitKrausMap", "mixMultiQubitKrausMap"}

#: entries with no unraveling: non-trace-preserving maps have no
#: probability interpretation, and mixDensityMatrix mixes in a second
#: register
_UNRAVELABLE = {"mixNonTPKrausMap", "mixNonTPTwoQubitKrausMap",
                "mixNonTPMultiQubitKrausMap", "mixDensityMatrix"}

_ENV_WARNED: set = set()


def trajectory_count_default() -> int:
    """Ensemble size from ``QUEST_TRAJECTORIES`` (a malformed or sub-1
    value warns once as QT501 and falls back to ``DEFAULT_TRAJECTORIES``
    or is clamped to 1)."""
    from ..resilience.findings import env_int
    return env_int("QUEST_TRAJECTORIES", DEFAULT_TRAJECTORIES, minimum=1, code="QT501",
                   warned=_ENV_WARNED, noun="trajectory count")


def _bound_args(fn, args, kwargs) -> dict:
    """The entry's arguments by parameter name (qureg bound to None)."""
    ba = inspect.signature(fn).bind(None, *args, **kwargs)
    ba.apply_defaults()
    return ba.arguments


def _channel_site(name, fn, args, kwargs) -> tuple:
    """(table key, targets, Kraus operators) of one recorded channel entry."""
    got = _bound_args(fn, args, kwargs)
    if name in _channels.MIX_CHANNELS:
        key = _channels.MIX_CHANNELS[name]
        spec = _channels.CHANNELS[key]
        if spec.num_targets == 1:
            targets = (int(got["target"]),)
        else:
            targets = (int(got["q1"]), int(got["q2"]))
        if key == "pauli":
            probs = (float(got["px"]), float(got["py"]), float(got["pz"]))
        else:
            probs = (float(got["prob"]),)
        return key, targets, tuple(_channels.kraus_ops(key, *probs))
    if name == "mixKrausMap":
        targets = (int(got["target"]),)
    elif name == "mixTwoQubitKrausMap":
        targets = (int(got["q1"]), int(got["q2"]))
    else:
        targets = tuple(int(t) for t in got["targets"])
    ops = tuple(np.asarray(op, dtype=np.complex128) for op in got["ops"])
    return "kraus", targets, ops


def unravel(circuit: Circuit, seed: Param | int | None = None) -> Circuit:
    """Rewrite a noisy (typically density-matrix) circuit into its
    trajectory form: every built-in mix* channel and explicit CPTP Kraus
    entry becomes an :func:`noise.applyTrajectoryKraus` site over a pure
    state; every other entry passes through unchanged (the gate functions
    branch on the register kind themselves).

    All sites share one seed value slot (``seed``, default
    ``P("traj_seed")``) and carry consecutive static ``site`` indices, so
    one integer per trajectory drives an independent counter-based stream
    at every site. Non-trace-preserving maps (mixNonTP*) and
    ``mixDensityMatrix`` have no unraveling and raise."""
    if seed is None:
        seed = Param(SEED_PARAM)
    out = Circuit(circuit.num_qubits, is_density_matrix=False)
    site = 0
    for fn, args, kwargs in circuit._tape:
        name = getattr(fn, "__name__", "")
        if name in _UNRAVELABLE:
            raise QuESTError(
                f"cannot unravel '{name}': non-trace-preserving maps have no trajectory "
                "probability interpretation (QT502)" if name != "mixDensityMatrix" else
                "cannot unravel 'mixDensityMatrix': it mixes in a second register, not a "
                "Kraus channel")
        if name in _channels.MIX_CHANNELS or name in _KRAUS_MIX:
            key, targets, ops = _channel_site(name, fn, args, kwargs)
            out.append(noise.applyTrajectoryKraus, targets, ops, seed, site=site)
            telemetry.inc("trajectory_channels_total", channel=key)
            site += 1
        else:
            out.append(fn, *args, **kwargs)
    return out


def ensemble_density(states) -> np.ndarray:
    """The ensemble-mean density matrix (2^n, 2^n complex128) of a stack of
    planar trajectory states (T, 2, 2^n), a tensor on any device or an
    array: rho[i, j] = mean_t psi_t[i] conj(psi_t[j]). For small n only."""
    if isinstance(states, torch.Tensor):
        states = states.detach().to("cpu", torch.float64).numpy()
    arr = np.asarray(states, dtype=np.float64)
    psi = arr[:, 0, :] + 1j * arr[:, 1, :]
    return psi.T @ psi.conj() / psi.shape[0]


@dataclass(frozen=True)
class TrajectoryResult:
    """One run ensemble: ``states`` is the (T, 2, 2^n) planar stack in seed
    order, a tensor on the env's device; ``seeds`` the per-trajectory
    seeds; ``seed_name`` the bound Param. ``density()`` gives the
    ensemble-mean density matrix (small n only: it holds 4^n complex
    entries on the host).

    When the ensemble sampled on the device (``run_ensemble(...,
    shots=S)``), ``shot_tables`` is the (T, S) int32 stack and ``states``
    is None: the trajectory states were never kept."""
    states: torch.Tensor | None
    seeds: tuple
    seed_name: str
    shot_tables: torch.Tensor | None = None

    @property
    def num_trajectories(self) -> int:
        return len(self.seeds)

    def density(self) -> np.ndarray:
        if self.states is None:
            raise QuESTError(
                "TrajectoryResult.density() needs the trajectory states; this ensemble "
                "sampled on the device (shots=...) and kept only the shot tables")
        return ensemble_density(self.states)


def _gathered(lane):
    """A served lane as one tensor: a sharded state's shards joined on the
    first shard's device."""
    if isinstance(lane, (list, tuple)):
        return torch.cat([s.to(lane[0].device) for s in lane], dim=-1)
    return lane


#: the static sampling site of an ensemble's terminal shot stage: far above
#: any tape's channel sites, so the shot stream never meets a Kraus stream
#: of the same seed
_SHOT_SITE = 1 << 16


def _shot_finalize(*, n: int, targets: tuple, shots: int, shot_seed: int):
    """A cached ``finalize(amps)`` drawing each trajectory's shot table on
    the device (the Engine's finalize). The draws are SHARED across the
    lanes of a batch (one static ``shot_seed``): common random numbers --
    each table is still an unbiased sample of its own trajectory's
    outcome distribution. On a sharded env it draws from the trajectory's
    shards (``sampler.draw_outcomes_shards``). Cached so that a warm Engine
    key reuses it."""
    from ..engine import cache as _ec
    from ..sampling import sampler as _sampler
    key = ("ensemble_shot_finalize", n, targets, int(shots), int(shot_seed))

    def build():
        def finalize(amps):
            return _sampler.sample_statevec(amps, n=n, targets=targets, shots=int(shots),
                                            seed=int(shot_seed), site=_SHOT_SITE)

        return finalize

    return _ec.executables().get_or_create(key, build)


def run_ensemble(circuit: Circuit, num_trajectories: int | None = None, *,
                 env: QuESTEnv | None = None, seeds: Iterable[int] | None = None,
                 base_seed: int = 0, params: dict | None = None,
                 max_batch: int | None = None, precision_code: int | None = None,
                 initial: object = "zero", timeout: float | None = None,
                 shots: int | None = None, shot_targets=None,
                 shot_seed: int = 0) -> TrajectoryResult:
    """Run a trajectory ensemble of ``circuit`` through the serving engine:
    one Engine a call, T = ``num_trajectories`` (default: the
    QUEST_TRAJECTORIES count) seed bindings submitted at once, so the
    batcher coalesces them into ceil(T / max_batch) lane-batched
    dispatches of ONE program (max_batch defaults to T).

    ``circuit`` may be the density form (it is unraveled here) or an
    unraveled tape, raw or planned (``fused``), carrying exactly one named
    seed Param. ``seeds`` overrides the default ``base_seed + t`` stream
    ids; ``params`` supplies any other named Params of the tape. Replaying
    the same seeds gives the same bits, and a lane equals the same seed run
    alone (``max_batch=1``). ``env`` None is ``createQuESTEnv()``, the card.

    ``shots``: draw S outcomes per trajectory ON THE DEVICE (over
    ``shot_targets``, default every qubit, seeded by ``shot_seed``) instead
    of keeping the states: the sampler is the Engine's finalize, so the
    result's ``shot_tables`` is the (T, S) stack and ``states`` is None."""
    from ..engine import Engine

    if circuit.is_density_matrix:
        circuit = unravel(circuit)
    lifted = circuit.lifted()
    seed_names = sorted({s.name for s in lifted.slots if s.kind == _SEED and s.name is not None})
    if len(seed_names) != 1:
        raise QuESTError(
            f"run_ensemble needs exactly one named seed Param on the tape, found "
            f"{seed_names or 'none'}; record channels via unravel() (its sites share "
            f"P({SEED_PARAM!r}))")
    seed_name = seed_names[0]
    if seeds is None:
        t_count = (int(num_trajectories) if num_trajectories is not None
                   else trajectory_count_default())
        if t_count < 1:
            raise QuESTError(f"num_trajectories must be >= 1, got {t_count}")
        seeds = [int(base_seed) + t for t in range(t_count)]
    else:
        seeds = [int(s) for s in seeds]
        if not seeds:
            raise QuESTError("seeds must be non-empty")
    sites = sum(1 for fn, _, _ in circuit._tape
                if getattr(fn, "__name__", "") == "applyTrajectoryKraus")
    finalize = None
    if shots is not None:
        if int(shots) < 1:
            raise QuESTError(f"shots must be >= 1, got {shots}")
        if shot_targets is None:
            shot_targets = tuple(range(circuit.num_qubits))
        shot_targets = tuple(int(t) for t in shot_targets)
        finalize = _shot_finalize(n=circuit.num_qubits, targets=shot_targets,
                                  shots=int(shots), shot_seed=int(shot_seed))
    mb = min(len(seeds), max_batch) if max_batch else len(seeds)
    eng = Engine(circuit, env, max_batch=mb, max_delay_ms=0.0, precision_code=precision_code,
                 initial=initial, finalize=finalize)
    try:
        reqs = [dict(params or {}, **{seed_name: s}) for s in seeds]
        futs = eng.submit_many(reqs, timeout=timeout)
        lanes = [f.result() for f in futs]
    finally:
        eng.close()
    results = torch.stack([_gathered(lane) for lane in lanes])
    del lanes
    telemetry.inc("trajectory_runs_total", len(seeds))
    telemetry.inc("trajectory_sites_total", sites * len(seeds))
    telemetry.inc("trajectory_ensembles_total")
    if finalize is not None:
        telemetry.inc("sample_shots_total", int(shots) * len(seeds))
        telemetry.set_gauge("sample_host_transfer_bytes",
                            results.numel() * results.element_size())
    telemetry.event("trajectories.ensemble", trajectories=len(seeds), sites=sites,
                    max_batch=mb, sharded=eng.sharded,
                    shots=0 if shots is None else int(shots))
    if finalize is not None:
        return TrajectoryResult(states=None, seeds=tuple(seeds), seed_name=seed_name,
                                shot_tables=results)
    return TrajectoryResult(states=results, seeds=tuple(seeds), seed_name=seed_name)
