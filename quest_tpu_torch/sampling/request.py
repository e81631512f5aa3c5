"""One-dispatch sampling requests: circuit + shots + Pauli-sum expectation
(``quest_tpu/sampling/request.py``).

``compiled_request`` composes a whole request into one program but ends
with the 2^N amplitudes, which a sampling client never reads. The functions
here compose the readout INTO that program as its terminal ``reduce``, so
a request -- the state's evolution, S shots, a Pauli-sum expectation -- is
one dispatched program (``device_dispatch_total{route=request}`` moves by
one; on the card one CUDA-graph replay) and the host receives O(S) words
and a scalar (``sample_host_transfer_bytes`` records what crossed).

``shots_default()`` supplies S when the caller does not: ``QUEST_SHOTS``,
with a warn-once QT801 finding on a malformed or sub-1 value.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from .. import telemetry
from ..validation import QuESTError
from . import sampler as _sampler

if TYPE_CHECKING:
    from ..circuits import Circuit
    from ..registers import Qureg

__all__ = ["shots_default", "sample_reduce", "expectation_reduce", "sample_request",
           "sampleQureg", "to_host", "DEFAULT_SHOTS"]

#: shot count when neither an argument nor QUEST_SHOTS says otherwise
DEFAULT_SHOTS = 1024

_ENV_WARNED: set = set()


def shots_default() -> int:
    """The shot count from ``QUEST_SHOTS``: a malformed value falls back to
    ``DEFAULT_SHOTS`` and a value below 1 is clamped to 1, each with a
    warn-once QT801 finding."""
    from ..resilience.findings import env_int
    return env_int("QUEST_SHOTS", DEFAULT_SHOTS, minimum=1, code="QT801",
                   warned=_ENV_WARNED, noun="shot count")


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return np.asarray(x)


def _leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


def _record_transfer(out) -> None:
    """Gauge the bytes a sampling result moved to the host: O(S) shot words
    and O(1) scalars, against the 2^N amplitudes a state readout moves."""
    telemetry.set_gauge("sample_host_transfer_bytes",
                        sum(int(np.asarray(x).nbytes) for x in _leaves(out)))


def to_host(res):
    """A sampling request's result on the host (numpy leaves, the dict
    kept), with the bytes that crossed gauged."""
    out = _host(res)
    _record_transfer(out)
    return out


def sample_reduce(*, n: int, targets, shots: int, site: int = 0, density: bool = False):
    """A ``reduce(amps, seed=0)`` producing the (S,) int32 shot table over
    ``targets``: the terminal stage of a one-dispatch sampling request (or
    an Engine's ``finalize``, which draws with seed 0). ``amps`` is a
    state tensor or a sharded state's list of shards. Cached per spec, so
    its identity is stable in the executable cache's keys."""
    from ..engine import cache as _ec
    targets = tuple(int(t) for t in targets)
    key = ("sample_reduce", int(n), targets, int(shots), int(site), bool(density))

    def build():
        fn = _sampler.sample_density if density else _sampler.sample_statevec

        def reduce(amps, seed=0):
            return fn(amps, n=n, targets=targets, shots=int(shots), seed=seed, site=site)

        return reduce

    return _ec.executables().get_or_create(key, build)


def expectation_reduce(*, n: int, codes, coeffs, density: bool = False):
    """A ``reduce(amps)`` computing ``sum_t c_t <P_t>``: the
    ``calcExpecPauliSum`` contraction (``calculations.expec_pauli_sum_amps``)
    as a request's terminal stage, on a state tensor or a sharded state's
    shards (the sharded Pauli-sum route). Cached per spec."""
    from ..engine import cache as _ec
    codes_t = tuple(tuple(int(c) for c in row) for row in
                    np.asarray(codes, dtype=np.int64).reshape(-1, n))
    coeffs_t = tuple(float(c) for c in np.asarray(coeffs, dtype=np.float64).reshape(-1))
    if len(codes_t) != len(coeffs_t):
        raise QuESTError(f"expectation_reduce: {len(codes_t)} Pauli terms vs "
                         f"{len(coeffs_t)} coefficients")
    key = ("expec_reduce", int(n), codes_t, coeffs_t, bool(density))

    def build():
        def reduce(amps):
            from ..calculations import expec_pauli_sum_amps
            return expec_pauli_sum_amps(amps, coeffs_t, codes=codes_t, n=n, density=density)

        return reduce

    return _ec.executables().get_or_create(key, build)


class _SlottedRequest:
    """The request of a tape with value slots (Params, lifted constants, a
    mid-circuit measurement's seed): ONE compiled program of the lifted
    whole-tape replay and the terminal stage. Every NAMED seed slot is
    bound to the request's seed, so one seed drives every mid-circuit
    draw (a stream a site) and the shot table; every other named Param
    must be bound on the tape (this route takes no params; the Engine
    does). The slot values live in tensors the program owns, so a graph
    reads them at fixed addresses."""

    def __init__(self, circuit, reduce, donate: bool):
        from .._capture import Executable, Program, Replay, to_device
        from ..engine.params import _SEED, BoundValues, bind_host, value_index
        lifted = circuit.lifted()
        named_seeds = {s.name for s in lifted.slots if s.kind == _SEED and s.name is not None}
        host = bind_host(lifted, {name: 0 for name in named_seeds})
        self._lifted, self._host = lifted, host
        index = value_index(lifted)
        kinds = tuple(dict.fromkeys(kind for kind, _ in index))
        # which entries of the seed kind's tensor take the request's seed
        pick = np.array([s.name is not None for (kind, _), s in zip(index, lifted.slots)
                         if kind == _SEED], dtype=bool)
        body = circuit._replay_body(lifted, pin=True)

        def whole(shell, seed, *tensors):
            vals = dict(zip(kinds, tensors))
            if pick.any():
                t = vals[_SEED]
                vals[_SEED] = torch.where(to_device(pick, torch.bool, t.device), seed, t)
            body(shell, BoundValues(vals, index))
            return reduce(shell.amps if shell.shards is None else list(shell.shards), seed)

        self._kinds = kinds
        self._values: dict = {}
        self._exe = Executable(Program([(None, [Replay(whole, circuit.num_qubits,
                                                       circuit.is_density_matrix)])]),
                               donate, route="request", returns_state=False)

    def close(self) -> None:
        self._exe.close()
        self._values.clear()

    def __call__(self, amps, seed):
        from ..engine.params import stack_values
        dev = _sampler._first(amps).device
        vals = self._values.get(dev)
        if vals is None:
            vals = self._values[dev] = stack_values(self._lifted, [self._host], dev,
                                                    stacked=False)
        return self._exe(amps, _sampler.seed_tensor(seed, dev),
                         *(vals.tensors[k] for k in self._kinds))


def sample_request(circuit: Circuit, *, targets=None, shots: int | None = None,
                   site: int = 0, pauli_codes=None, coeffs=None, donate: bool = True):
    """The WHOLE sampling request as ONE dispatched program: the tape, the
    S-shot sampler over ``targets`` (default: every qubit) and, with
    (``pauli_codes``, ``coeffs``), the Pauli-sum expectation. Returns an
    executable called as ``fn(amps, seed)`` giving ``{"shots": (S,)
    int32}`` (and ``"expec"`` with a Pauli sum), on the state's device;
    one call counts one ``device_dispatch_total{route="request"}``.
    ``amps`` may be a sharded state's list of shards (plan the tape with
    ``fused(..., shard_devices=D)``): the tape, the shots and the
    expectation then run on the shards, and the outputs land on the first
    shard's device.

    A tape with no value slot runs through ``request_executable`` with the
    sampler as its terminal reduce; a tape with slots (Params, lifted
    constants, a mid-circuit measurement's seed) as one lifted replay whose
    named seed slots take the request's seed. The seed is a runtime
    argument (S seeds replay one program), the shot count its shape.
    ``shots`` defaults to :func:`shots_default`. Cached per spec."""
    if shots is None:
        shots = shots_default()
    if int(shots) < 1:
        raise QuESTError(f"shots must be >= 1, got {shots}")
    n = circuit.num_qubits
    density = circuit.is_density_matrix
    targets = tuple(range(n)) if targets is None else tuple(int(t) for t in targets)
    if not targets or len(set(targets)) != len(targets) or \
            any(t < 0 or t >= n for t in targets):
        raise QuESTError(f"sample_request: invalid targets {targets} for {n} qubits")
    shot_red = sample_reduce(n=n, targets=targets, shots=int(shots), site=site,
                             density=density)
    expec_red = None
    if pauli_codes is not None or coeffs is not None:
        if pauli_codes is None or coeffs is None:
            raise QuESTError("sample_request needs both pauli_codes and coeffs (or neither)")
        expec_red = expectation_reduce(n=n, codes=pauli_codes, coeffs=coeffs, density=density)

    from ..engine import cache as _ec
    from ..parallel import scheduler as _dist
    # a request pins the scheduler mode it was built under
    key = ("sample_request", circuit._exec_token(), shot_red, expec_red, donate,
           _dist.mode())

    def build():
        def reduce(amps, seed):
            out = {"shots": shot_red(amps, seed)}
            if expec_red is not None:
                out["expec"] = expec_red(amps)
            return out

        if circuit.lifted().slots:
            fn = _SlottedRequest(circuit, reduce, donate)
            fn.num_segments = 1
        else:
            from .. import segments
            inner = segments.request_executable(circuit, donate=donate, reduce=reduce)

            def fn(amps, seed, _inner=inner):
                return _inner(amps, _sampler.seed_tensor(seed, _sampler._first(amps).device))

            fn.num_segments, fn.program = inner.num_segments, inner.program
        fn.num_dispatches = 1
        return fn

    return _ec.executables().get_or_create(key, build)


def sampleQureg(qureg: Qureg, targets=None, shots: int | None = None, seed: int = 0,
                site: int = 0) -> np.ndarray:
    """Draw ``shots`` outcome samples over ``targets`` (default: every
    qubit) of ``qureg``'s CURRENT state as one program on its device; the
    register is not modified. Returns the (S,) int32 shot table on the
    host (targets[0] = each outcome's least-significant bit): O(S) words
    cross, gauged as ``sample_host_transfer_bytes``."""
    from .. import validation as V
    func = "sampleQureg"
    n = qureg.num_qubits_represented
    if targets is None:
        targets = tuple(range(n))
    V.validate_multi_targets(qureg, targets, func)
    if shots is None:
        shots = shots_default()
    if int(shots) < 1:
        raise QuESTError(f"shots must be >= 1, got {shots}", func)
    amps = qureg.amps if qureg.shards is None else list(qureg.shards)
    table = _sampler.sample_jit(amps, seed, n=n,
                                targets=tuple(int(t) for t in targets), shots=int(shots),
                                site=int(site), density=qureg.is_density_matrix)
    out = table.cpu().numpy()
    _record_transfer(out)
    telemetry.inc("sample_shots_total", int(shots))
    return out
