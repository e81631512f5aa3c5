"""Circuit: a recorded gate tape, replayed eagerly or planned into fused
gate runs.

Record the L5 API calls (same names and argument order as ``QuEST.h``,
without the leading register) on a tape, then ``run`` it on a register.
``fused`` plans the tape (``fusion.plan``) into passes of the fused
gate-run kernel: ``Circuit(n)...fused(pallas=True).run(qureg)`` is the
main path, and ``Circuit(n, is_density_matrix=True)`` records gates and
decoherence channels for a density register. There is no ``jit``: replay
is a Python loop over the tape.
"""

from __future__ import annotations

import importlib
import inspect

import numpy as np

from .registers import Qureg

#: modules whose functions can be recorded on a tape
_TAPEABLE_MODULES = ("gates", "operators", "decoherence", "state_init")
#: API names that never go on a tape: measurement and collapse need host
#: control flow and the RNG, the rest host data (the JAX package's set)
_EXCLUDED = {
    "measure", "measureWithStats", "collapseToOutcome",
    "createDiagonalOp", "destroyDiagonalOp", "syncDiagonalOp",
    "initDiagonalOp", "setDiagonalOpElems", "initDiagonalOpFromPauliHamil",
    "createDiagonalOpFromPauliHamilFile", "calcExpecDiagonalOp",
    "initStateFromAmps", "setAmps", "setDensityAmps",
}


def _tape_compatible(fn) -> bool:
    """True iff the target Qureg is ``fn``'s sole Qureg argument and comes
    first."""
    try:
        params = list(inspect.signature(fn).parameters.values())
    except (TypeError, ValueError):
        return False
    if not params:
        return False

    def is_qureg(p):
        return "Qureg" in str(p.annotation) or "qureg" in p.name.lower()

    return is_qureg(params[0]) and not any(is_qureg(p) for p in params[1:])


def _resolve(name):
    for mod_name in _TAPEABLE_MODULES:
        mod = importlib.import_module(f".{mod_name}", __package__)
        fn = getattr(mod, name, None)
        if fn is not None and callable(fn):
            if not _tape_compatible(fn):
                raise AttributeError(
                    f"'{name}' takes a second Qureg (or none first); it must "
                    f"run eagerly, not on a Circuit tape")
            return fn
    raise AttributeError(
        f"'{name}' is not a tapeable quest_tpu_torch API function "
        f"(measurement and calc* functions must run eagerly)")


class Circuit:
    """Deferred-execution circuit over ``num_qubits`` qubits::

        c = Circuit(3)
        c.hadamard(0)
        c.controlledNot(0, 1)
        c.run(qureg)
    """

    def __init__(self, num_qubits: int, is_density_matrix: bool = False):
        self.num_qubits = int(num_qubits)
        self.is_density_matrix = bool(is_density_matrix)
        self._tape: list = []

    # -- recording ----------------------------------------------------------

    def __getattr__(self, name):
        if name.startswith("_") or name in _EXCLUDED:
            raise AttributeError(name)
        fn = _resolve(name)

        def record(*args, **kwargs):
            self.append(fn, *args, **kwargs)

        record.__name__ = name
        return record

    def append(self, fn, *args, **kwargs) -> "Circuit":
        """Record ``fn(qureg, *args, **kwargs)`` on the tape."""
        self._tape.append((fn, args, kwargs))
        return self

    def __len__(self) -> int:
        return len(self._tape)

    # -- execution ----------------------------------------------------------

    def as_fn(self):
        """Function amps -> amps replaying the tape on a bare register
        around the given planar tensor."""
        tape = tuple(self._tape)
        n, is_density = self.num_qubits, self.is_density_matrix

        def fn(amps):
            shell = Qureg(n, is_density, amps, env=None)
            for f, args, kwargs in tape:
                f(shell, *args, **kwargs)
            return shell.amps

        return fn

    def fused(self, max_qubits: int = 5, dtype=None, pallas: bool = False,
              tile_bits: int | None = None,
              shard_devices: int | None = None) -> "Circuit":
        """A new Circuit whose tape is the fusion plan of this one.

        ``pallas=True`` plans fused gate runs (one pass of the fused-run
        kernel each) with multi-frame scheduling; ``tile_bits`` sets their
        tile geometry, by default ``ops.fused_gates.hopper_tile_bits`` for
        ``dtype`` (the default precision's when None). Pinning it to
        ``ops.fused_gates.local_qubits(n, ...)`` reproduces the JAX
        package's plan item for item. A density tape plans over the
        flattened 2n-qubit state, so its geometry is that state's. States
        of at most 7 qubits (no lane tile) take the ordinary dense fusion.

        ``shard_devices`` plans for a register sharded over that many
        devices (a power of 2): the tile is chosen for the shard's size, so
        every run executes per shard, and the frames are planned twice,
        plainly and aligned to the shard boundary, keeping the plan with
        fewer collective transposes (``fusion.plan_pallas_sharded``)."""
        from . import fusion
        from .ops.fused_gates import LANE_BITS, hopper_tile_bits
        from .precision import as_torch_dtype, real_dtype

        dt = as_torch_dtype(dtype) if dtype is not None else real_dtype()
        n_eff = (2 if self.is_density_matrix else 1) * self.num_qubits
        shard_boundary = None
        if pallas and shard_devices and shard_devices > 1:
            d = int(shard_devices)
            if d & (d - 1):
                raise ValueError(
                    f"shard_devices must be a power of 2 (got {d}); "
                    "amplitude sharding splits whole top qubits")
            n_eff -= d.bit_length() - 1
            shard_boundary = n_eff
        tb = None
        if pallas and n_eff > LANE_BITS:
            tb = hopper_tile_bits(n_eff, dt) if tile_bits is None else int(tile_bits)
        if tb is not None and shard_boundary is not None:
            p = fusion.plan_pallas_sharded(tuple(self._tape), self.num_qubits, dt,
                                           max_qubits, tb, shard_boundary,
                                           is_density=self.is_density_matrix)
        else:
            p = fusion.plan(tuple(self._tape), self.num_qubits, dt,
                            max_qubits=max_qubits, pallas_tile_bits=tb,
                            is_density=self.is_density_matrix)
        out = Circuit(self.num_qubits, self.is_density_matrix)
        out._tape = fusion.as_tape(p)
        return out

    def run(self, qureg: Qureg) -> Qureg:
        """Apply the circuit to ``qureg`` (mutates it, like the C API),
        sharded or not: each entry takes the register's route."""
        if qureg.num_qubits_represented != self.num_qubits or \
           qureg.is_density_matrix != self.is_density_matrix:
            raise ValueError(
                f"Circuit({self.num_qubits}q, density={self.is_density_matrix}) "
                f"cannot run on {qureg!r}")
        for f, args, kwargs in self._tape:
            f(qureg, *args, **kwargs)
        return qureg


def random_layers(circ, num_qubits: int, depth: int, seed: int = 2026):
    """Record the bench's deterministic pseudo-random Clifford+T circuit:
    per layer one of H / T / Rz / Rx on every qubit, a CNOT ladder, and
    CZ(0, n-1). The same gates, angles and order as the JAX package's
    bench circuit (``__graft_entry__._random_layers``) for a seed."""
    rng = np.random.RandomState(seed)
    for layer in range(depth):
        for q in range(num_qubits):
            k = rng.randint(4)
            if k == 0:
                circ.hadamard(q)
            elif k == 1:
                circ.tGate(q)
            elif k == 2:
                circ.rotateZ(q, float(rng.uniform(0, 2 * np.pi)))
            else:
                circ.rotateX(q, float(rng.uniform(0, 2 * np.pi)))
        for q in range(layer % 2, num_qubits - 1, 2):
            circ.controlledNot(q, q + 1)
        circ.controlledPhaseFlip(0, num_qubits - 1)


def density_circuit(num_qubits: int, with_krausn: bool) -> Circuit:
    """The bench's channel circuit on an n-qubit density register, the same
    entries as the JAX package's (``bench.py::_density_circuit``): H on
    qubits 0-3, CNOT(0,1), CNOT(2,3), mixDepolarising on qubits 0 and n-1,
    a 1-qubit mixKrausMap, mixTwoQubitDephasing, and with ``with_krausn``
    (the 11-op "r4" circuit; without it the 10-op "r3") a 3-target
    mixMultiQubitKrausMap."""
    k = 1 / np.sqrt(2)
    kraus = [np.array([[k, 0], [0, k]]), np.array([[0, k], [k, 0]])]
    circ = Circuit(num_qubits, is_density_matrix=True)
    for q in range(4):
        circ.hadamard(q)
    circ.controlledNot(0, 1)
    circ.controlledNot(2, 3)
    circ.mixDepolarising(0, 0.05)
    circ.mixDepolarising(num_qubits - 1, 0.05)
    circ.mixKrausMap(1, kraus)
    circ.mixTwoQubitDephasing(0, 1, 0.1)
    if with_krausn:
        xxx = np.kron(np.kron([[0, 1], [1, 0]], [[0, 1], [1, 0]]),
                      [[0, 1], [1, 0]])
        kraus3 = [0.8 * xxx, 0.6j * np.eye(8)]  # CPTP: 0.64 I + 0.36 I
        circ.mixMultiQubitKrausMap([2, 3, 4], kraus3)
    return circ
