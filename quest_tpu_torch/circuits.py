"""Circuit: a recorded gate tape, replayed eagerly, planned into fused
gate runs, or run as compiled programs.

Record the L5 API calls (same names and argument order as ``QuEST.h``,
without the leading register) on a tape, then ``run`` it on a register.
``fused`` plans the tape (``fusion.plan``) into passes of the fused
gate-run kernel: ``Circuit(n)...fused(pallas=True).run(qureg)`` is the
main path, and ``Circuit(n, is_density_matrix=True)`` records gates and
decoherence channels for a density register.

The JAX package runs a tape as one jitted XLA program (``compiled``); the
port's counterpart is a CUDA graph of the eager replay (``_capture``):
``run`` dispatches through ``compiled()``, which on the card runs the
replay eagerly at its first call, captures it at the first later call on
each buffer pair and replays the graph after that, and on the CPU is the
cached eager replay. A tape revision's executables leave the cache, and
free what they hold on the card, when the tape changes or the Circuit is
collected. ``compiled_segments``, ``compiled_blocks`` and
``compiled_request`` split or compose it as the JAX package's routes do
(``segments``), and ``parameterized`` makes the tape's angles runtime
values (``engine.params``) that one captured replay reads from a device
buffer. ``as_fn`` stays the plain eager replay.
"""

from __future__ import annotations

import importlib
import inspect
import threading
import weakref

import numpy as np

from . import telemetry
from .registers import Qureg

#: modules whose functions can be recorded on a tape (``sampling.measure``
#: holds the recordable forms of measurement and collapse,
#: ``trajectories.noise`` the trajectory channel site)
_TAPEABLE_MODULES = ("gates", "operators", "decoherence", "state_init",
                     "trajectories.noise", "sampling.measure")
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


#: modules whose tape entries a CUDA graph can hold: they copy nothing
#: from the host at replay (host constants go through
#: ``_capture.to_device``) and read nothing back
_CAPTURE_SAFE_MODULES = ("quest_tpu_torch.gates", "quest_tpu_torch.decoherence",
                         "quest_tpu_torch.operators", "quest_tpu_torch.state_init",
                         "quest_tpu_torch.sampling.measure",
                         "quest_tpu_torch.trajectories.noise")

#: entries of those modules that a graph cannot hold: measurement and
#: collapse draw or test a probability on the host; ``applyDiagonalOp``
#: reads the DiagonalOp's device tensor, which ``initDiagonalOp`` and
#: ``setDiagonalOpElems`` rebind, so a graph would go on reading the old
#: buffer
_HOST_BOUND_NAMES = {
    "measure", "measureWithStats", "collapseToOutcome", "applyDiagonalOp",
}


def _capture_safe(f) -> bool:
    """True if tape entry ``f`` may run inside a captured replay (the
    port's counterpart of the JAX package's ``_defer_safe`` registry). The
    fused plan's executors and the gate, channel, operator and init
    entries are; a host-bound entry (:data:`_HOST_BOUND_NAMES`, or any
    function of another module, such as a user's) runs eagerly as an item
    of its own between the captured pieces (``segments.segment_cuts``)."""
    from . import fusion

    if f in (fusion._apply_pallas_run, fusion._apply_frame_swap,
             fusion._apply_dense_block):
        return True
    if getattr(f, "__module__", None) in _CAPTURE_SAFE_MODULES:
        return getattr(f, "__name__", "") not in _HOST_BOUND_NAMES
    return False


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
        f"(measure and calc* functions run eagerly; applyMidMeasurement and "
        f"applyMidCollapse are their recordable forms)")


def _drop_revision(token) -> None:
    """Close and drop every cached executable keyed on one tape revision."""
    from .engine import cache as _ec
    _ec.executables().discard(
        lambda k: isinstance(k, tuple) and len(k) > 1 and k[1] is token)


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
        # identity of this tape revision: executable-cache keys carry it, so
        # appending invalidates them (the executables live in the bounded
        # process-global LRU, engine.cache.executables(), and leave it with
        # the revision: _exec_token)
        self._cache_token = object()
        self._token_final = None
        self._lifted_cache = None
        self._fp_cache = None

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
        if self._token_final is not None:
            self._token_final()  # the old revision's executables go
            self._token_final = None
        self._cache_token = object()
        self._lifted_cache = None
        self._fp_cache = None
        return self

    def __len__(self) -> int:
        return len(self._tape)

    # -- execution ----------------------------------------------------------

    def _exec_token(self):
        """The executable-cache token of this tape revision. The executables
        keyed on it are closed and dropped (their graphs, memory pools and
        buffers freed) when the tape changes or the Circuit is collected."""
        if self._token_final is None:
            self._token_final = weakref.finalize(self, _drop_revision, self._cache_token)
            self._token_final.atexit = False
        return self._cache_token

    def as_fn(self):
        """Function amps -> amps replaying the tape eagerly on a bare
        register around the given planar tensor (which a pass may update in
        place)."""
        return self._replay_fn(None)

    def _replay_body(self, lifted, lo: int = 0, hi: int | None = None):
        """``body(shell, values=None)`` applying ``tape[lo:hi]`` to a shell
        register; with a lifted tape (``engine.params.LiftedTape``) the
        body substitutes the bound values into the slotted entries first,
        so gate matrices assemble on the device from them. Slicing
        composes with plain replay only (lifted entries index the whole
        tape)."""
        if lifted is not None and (lo != 0 or hi is not None):
            raise ValueError("sliced replay requires lifted=None")
        tape = tuple(self._tape[lo:hi])
        entries = tuple(lifted.entries) if lifted is not None else None

        def body(shell, values=None):
            if entries is None:
                steps = tape
            else:
                from .engine.params import materialize_entry
                steps = [materialize_entry(e, values) for e in entries]
            for f, args, kwargs in steps:
                f(shell, *args, **kwargs)

        return body

    def _replay_fn(self, lifted, lo: int = 0, hi: int | None = None):
        """The eager replay as ``fn(amps, values=None) -> amps`` (a state
        tensor or a sharded state's list of shards), the JAX package's
        replay body; ``as_fn`` is ``_replay_fn(None)``."""
        body = self._replay_body(lifted, lo, hi)
        n, is_density = self.num_qubits, self.is_density_matrix

        def fn(amps, values=None):
            if isinstance(amps, (list, tuple)):
                shell = Qureg(n, is_density, None, env=None, shards=list(amps))
                body(shell, values)
                return list(shell.shards)
            shell = Qureg(n, is_density, amps, env=None)
            body(shell, values)
            return shell.amps

        return fn

    def _replay(self, lo: int, hi: int, *, eager_only: bool = False,
                route: str | None = None):
        """``tape[lo:hi]`` as one piece of a compiled program."""
        from ._capture import Replay
        return Replay(self._replay_body(None, lo, hi), self.num_qubits,
                      self.is_density_matrix, eager_only=eager_only, route=route)

    def compiled(self, donate: bool = True):
        """The tape as one compiled executable ``fn(amps) -> amps``
        (``_capture.Executable``): on the card the eager replay at its
        first call, then a CUDA graph of it, captured at the first later
        call on each pair of buffers and replayed after; on the CPU the
        eager replay. ``amps`` is a planar state, or a sharded state's list
        of shard tensors. A host-bound entry (``_capture_safe``) splits the
        program, and runs eagerly between its pieces as the item route.
        Cached in the process-global bounded LRU
        (``engine.cache.executables()``), keyed on the tape revision."""
        from . import segments
        from ._capture import Executable, Program
        from .engine import cache as _ec
        key = ("circuit", self._exec_token(), donate)

        def build():
            return Executable(Program([(None, segments._pieces(self, 0, len(self._tape)))]),
                              donate)

        return _ec.executables().get_or_create(key, build)

    # -- parameterized execution -------------------------------------------

    def lifted(self):
        """This tape's :class:`~quest_tpu_torch.engine.params.LiftedTape`
        (value slots factored out of Params AND constant angles/Complex
        scalars), memoized per tape revision."""
        from .engine import params as _prm
        tok = self._cache_token
        if self._lifted_cache is None or self._lifted_cache[0] is not tok:
            self._lifted_cache = (tok, _prm.lift_tape(tuple(self._tape)))
        return self._lifted_cache[1]

    @property
    def param_names(self) -> tuple:
        """Ordered unique :class:`~quest_tpu_torch.engine.params.Param`
        names recorded on the tape."""
        return self.lifted().param_names

    def fingerprint(self) -> str:
        """Structure fingerprint of the tape (gate names, targets/controls,
        value-slot kinds -- never the lifted values): the executable-cache
        key under which structure-equal circuits share one executable
        (``engine.cache.structure_fingerprint``)."""
        from .engine import cache as _ec
        tok = self._cache_token
        if self._fp_cache is None or self._fp_cache[0] is not tok:
            self._fp_cache = (tok, _ec.structure_fingerprint(
                self._tape, self.num_qubits, self.is_density_matrix))
        return self._fp_cache[1]

    def parameterized(self, donate: bool = True, reduce=None):
        """The tape as ONE compiled executable whose lifted values (Params
        and constant angles/Complex scalars) are runtime values: a
        :class:`~quest_tpu_torch.engine.params.ParamExecutable` called as
        ``exe(amps, {"theta": 0.3})``. On the card the graph reads the
        values from a device buffer that each call loads, so new values
        never capture again; gate matrices assemble from them on the
        device (``matrices``' tensor branches), also between the static
        kernel runs of a fused plan.

        ``reduce``: an optional terminal stage composed into the program
        -- the executable returns ``reduce(final_amps)`` (with
        ``reduce.wants_values``, ``reduce(final_amps, values)``) instead
        of the amplitudes. It is part of the cache key.

        Cached in the global LRU keyed by the structure fingerprint: two
        structure-equal circuits -- same ansatz, different recorded angles
        -- share one executable (``plan_cache_hit_total``). Every entry
        must be capturable (``_capture_safe``)."""
        from .engine import cache as _ec
        from .engine.params import ParamExecutable
        from .validation import QuESTError
        bad = sorted({getattr(f, "__name__", repr(f)) for f, _a, _kw in self._tape
                      if not _capture_safe(f)})
        if bad:
            raise QuESTError(f"parameterized replays the tape as one program, and "
                             f"{bad} cannot be captured into it", "parameterized")
        lifted = self.lifted()
        fp = self.fingerprint()
        key = ("param", fp, donate, reduce)

        def build():
            return _ParamFn(self, lifted, donate, reduce)

        return ParamExecutable(_ec.executables().get_or_create(key, build), lifted, fp)

    def gradient(self, hamiltonian, *, donate: bool = True, dtype=None):
        """The tape's adjoint-state gradient against a Pauli-sum Hamiltonian
        (:mod:`quest_tpu_torch.gradients`): one forward sweep, the costate
        H|psi>, and one backward walk daggering every gate while it takes
        <lambda|dG/dtheta|phi> for each slot -- all in ONE compiled program
        (:meth:`parameterized` with the gradient as its terminal stage),
        counted as ``route=grad_request``. Returns a
        :class:`~quest_tpu_torch.gradients.GradExecutable` called as
        ``grad(amps, {"theta": 0.3}) -> {"value", "grads", "slot_grads"}``.

        An entry with no inverse (a measurement, a channel, a fused-run
        plan entry) raises a typed :class:`QuESTError` here, naming its
        site."""
        from .gradients import gradient_executable
        return gradient_executable(self, hamiltonian, donate=donate, dtype=dtype)

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
        # stamp each frame-carrying item with its frame-identity segment
        # (the seams of the segment programs), as the JAX package does
        from . import segments as _segments
        _segments.stamp_plan(p, (2 if self.is_density_matrix else 1) * self.num_qubits)
        out = Circuit(self.num_qubits, self.is_density_matrix)
        out._tape = fusion.as_tape(p)
        return out

    def blocks(self, max_gates: int) -> list:
        """Split the tape into sub-circuits of at most ``max_gates`` gates."""
        if max_gates < 1:
            raise ValueError("max_gates must be >= 1")
        parts = []
        for i in range(0, len(self._tape), max_gates):
            part = Circuit(self.num_qubits, self.is_density_matrix)
            part._tape = list(self._tape[i:i + max_gates])
            parts.append(part)
        return parts

    def compiled_blocks(self, max_gates: int, donate: bool = True):
        """Like :meth:`compiled`, but as a chain of block-sized programs
        sharing one spare buffer; each block's launch counts
        ``device_dispatch_total{route="block"}``. Cached like
        :meth:`compiled`."""
        from . import segments
        from ._capture import Executable, Program
        from .engine import cache as _ec
        key = ("circuit_blocks", self._exec_token(), max_gates, donate)

        def build():
            groups = [("block", segments._pieces(b, 0, len(b)))
                      for b in self.blocks(max_gates)]
            exe = Executable(Program(groups), donate)
            exe.num_blocks = len(groups)
            return exe

        return _ec.executables().get_or_create(key, build)

    def compiled_segments(self, max_items: int | None = None, donate: bool = True):
        """The tape as a chain of frame-identity-aligned segment programs
        (:mod:`quest_tpu_torch.segments`): each segment is ONE dispatch
        covering up to ``max_items`` tape entries, cut only at
        frame-identity seams (``max_items=None`` = the whole tape as one
        program). The chain exposes its link count as ``.num_segments``;
        every link launch counts ``device_dispatch_total{route="segment"}``."""
        from . import segments
        return segments.chain_executable(self, max_items=max_items, donate=donate)

    def compiled_request(self, donate: bool = True, reduce=None):
        """The WHOLE request -- every frame-identity segment plus an optional
        terminal ``reduce(amps)`` -- composed into ONE dispatched program
        (:func:`quest_tpu_torch.segments.request_executable`): one
        ``device_dispatch_total{route="request"}`` per call, however many
        segments (``.num_segments``) were composed."""
        from . import segments
        return segments.request_executable(self, donate=donate, reduce=reduce)

    def run(self, qureg: Qureg) -> Qureg:
        """Apply the circuit to ``qureg`` (mutates it, like the C API),
        sharded or not: the tape dispatches through :meth:`compiled` on the
        register's own buffers (its state and spare), counted as
        ``device_dispatch_total{route="circuit"}``, as the JAX package
        counts it. Each entry takes the register's route."""
        if qureg.num_qubits_represented != self.num_qubits or \
           qureg.is_density_matrix != self.is_density_matrix:
            raise ValueError(
                f"Circuit({self.num_qubits}q, density={self.is_density_matrix}) "
                f"cannot run on {qureg!r}")
        telemetry.inc("device_dispatch_total", route="circuit")
        self.compiled().run_register(qureg)
        return qureg

    def run_segmented(self, target, *, checkpoint_dir: str, every_n_items: int = 1,
                      keep: int = 2) -> Qureg:
        """Run the tape in segments, checkpointing at frame-identity
        boundaries, so that a preempted run resumes bit for bit from the
        newest verified snapshot
        (:func:`quest_tpu_torch.resilience.segmented.resume_segmented`).
        ``target`` is a Qureg, or a QuESTEnv on which a fresh |0...0>
        register is made; ``every_n_items`` spaces the checkpoints in tape
        items and ``keep`` bounds the generations kept on disk."""
        from .resilience import segmented
        return segmented.run_segmented(self, target, checkpoint_dir=checkpoint_dir,
                                       every_n_items=every_n_items, keep=keep)


class _ParamFn:
    """The shared body of :meth:`Circuit.parameterized`: one compiled
    program that reads its values from a :class:`BoundValues` it owns (on
    the state's device); each call loads the caller's values into it, so
    the program's graphs read the new values at their fixed address.
    ``engine_trace_total{kind=param_replay}`` counts each build of the
    replay: its eager run and every capture. Structure-equal circuits share
    it (the executable LRU), so a call holds its lock from the value load
    to the returned copy."""

    def __init__(self, circuit, lifted, donate: bool, reduce):
        from ._capture import Executable, Program, Replay
        self._lock = threading.RLock()
        self._values = None
        self._reduce = reduce
        self._body = circuit._replay_body(lifted)
        piece = Replay(self._run, circuit.num_qubits, circuit.is_density_matrix,
                       on_build=lambda: telemetry.inc("engine_trace_total",
                                                      kind="param_replay"))
        self._exe = Executable(Program([(None, [piece])]), donate,
                               returns_state=reduce is None)

    @property
    def captures(self) -> list:
        return self._exe.captures

    @property
    def program(self):
        return self._exe.program

    def close(self) -> None:
        with self._lock:
            self._exe.close()
            self._values = None

    def _run(self, shell):
        self._body(shell, self._values)
        if self._reduce is None:
            return None
        amps = shell.amps if shell.shards is None else list(shell.shards)
        if getattr(self._reduce, "wants_values", False):
            return self._reduce(amps, self._values)
        return self._reduce(amps)

    def __call__(self, amps, values):
        first = amps[0] if isinstance(amps, (list, tuple)) else amps
        with self._lock:
            have = self._values
            if (have is None or have.index != values.index
                    or have.device != first.device):
                if have is not None:
                    self._exe.close()  # the graphs read the old buffers
                self._values = values.to(first.device).clone()
            else:
                have.copy_(values)
            return self._exe(amps)


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


def serving_ansatz(n: int, depth: int, values: dict | None = None) -> Circuit:
    """The bench's VQE-style serving ansatz (``bench.py::serving_ansatz``):
    per layer rotateZ and rotateX on every qubit, a CNOT ladder and
    CZ(0, n-1). By default every rotation is a runtime
    :class:`~quest_tpu_torch.engine.params.Param` (``a{layer}_{q}``,
    ``b{layer}_{q}``); ``values`` (name -> float) bakes the angles in
    instead, giving the concrete structure-identical twin."""
    from .engine.params import P

    def angle(name):
        return P(name) if values is None else float(values[name])

    circ = Circuit(n)
    for layer in range(depth):
        for q in range(n):
            circ.rotateZ(q, angle(f"a{layer}_{q}"))
            circ.rotateX(q, angle(f"b{layer}_{q}"))
        for q in range(layer % 2, n - 1, 2):
            circ.controlledNot(q, q + 1)
        circ.controlledPhaseFlip(0, n - 1)
    return circ


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
