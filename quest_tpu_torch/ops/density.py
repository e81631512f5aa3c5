"""Density-matrix decoherence kernels.

The counterpart of ``quest_tpu/ops/density.py``. A density matrix on n
qubits is stored as a 2n-qubit state with row bits low and column bits
high (QuEST.c:8-10; flat index col * 2^n + row). Any Kraus channel on
targets T is the superoperator sum_k conj(K_k) (x) K_k on qubits
(T, T+n) of that state (the reference's Choi trick, QuEST_common.c:581-638).

``apply_channel`` routes a channel as the JAX package does:

- up to ``_SUPEROP_MAX_QUBITS`` flattened qubits, one dense superoperator
  through the per-gate engine (``ops.apply.apply_matrix``);
- above that, a 1-target channel runs as ONE pass of the fused gate-run
  kernel (a ``kraus1`` op, its qubits above the tile relocated into it by
  swaps folded into the pass's loads and stores), for a CUDA register on
  the card and for a CPU register through the kernel's plain version;
- every other channel runs the per-term engine ``_apply_kraus_sum``: each
  Kraus term's K on the row qubits and conj(K) on the column qubits,
  accumulated with its sign.

The route taken is counted in ``channel_route_total{route}``. Purely
diagonal channels (dephasing) are one elementwise diagonal pass.

On a sharded register (:func:`apply_channel_shards`) the same split runs
through the register's per-gate engine over shards, whose column qubits
t + n lie in the sharded zone: the superoperator through its relocations;
the ``kraus1`` pass per shard, its column qubit first moved into a local
slot by a collective permute (``parallel.exchange.dist_permute_bits``) and
back after (QuEST_cpu_distributed.c:535-868 exchanges half chunks for the
same channels); the per-term engine through its pair exchanges.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import telemetry
from .._spy import spy_point
from . import apply, cplx, diagonal


def kraus_superoperator(kraus_ops) -> np.ndarray:
    """sum_k conj(K_k) (x) K_k, ordered for application on targets
    (T..., T+n...): row bits (K's action) are the low half of the matrix
    index, column bits (conj(K)'s action) the high half
    (populateKrausSuperOperator, QuEST_common.c:581-638)."""
    ops = [np.asarray(k, dtype=np.complex128) for k in kraus_ops]
    dim = ops[0].shape[0]
    s = np.zeros((dim * dim, dim * dim), dtype=np.complex128)
    for k in ops:
        s += np.kron(np.conj(k), k)
    return s


#: up to this many flattened qubits a channel is one superoperator apply;
#: beyond it, a sum of per-Kraus-term passes (the JAX package's split)
_SUPEROP_MAX_QUBITS = 22


def choi_kraus(superop) -> list[tuple[float, np.ndarray]]:
    """Decompose a superoperator (ordered as :func:`kraus_superoperator`)
    into weighted Kraus terms [(sign, K_i), ...] via the eigendecomposition
    of its Choi matrix. Signs carry non-CP maps; CP maps yield all +1."""
    d2 = superop.shape[0]
    d = int(np.sqrt(d2))
    s = np.asarray(superop, dtype=np.complex128).reshape(d, d, d, d)
    # S[(c',r'),(c,r)] -> M[(r',r),(c',c)] = sum_k vec(K_k) vec(K_k)^dagger
    m = s.transpose(1, 3, 0, 2).reshape(d2, d2)
    vals, vecs = np.linalg.eigh((m + m.conj().T) / 2)
    out = []
    for lam, v in zip(vals, vecs.T):
        if abs(lam) < 1e-12:
            continue
        out.append((float(np.sign(lam)), np.sqrt(abs(lam)) * v.reshape(d, d)))
    return out


@spy_point
def apply_channel(amps: torch.Tensor, superop, *, n: int,
                  targets: tuple[int, ...],
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """Apply a (numpy complex) superoperator to density targets: qubits
    (T..., T+n...) of the flattened 2n-qubit state. Returns a new tensor,
    or ``out`` (a buffer of the state's size, not the state) where the
    kernel route writes into it."""
    if 2 * n <= _SUPEROP_MAX_QUBITS:
        telemetry.inc("channel_route_total", route="superop")
        ext_targets = tuple(targets) + tuple(q + n for q in targets)
        so = cplx.from_complex(superop, amps.dtype, amps.device)
        return apply.apply_matrix(amps, so, n=2 * n, targets=ext_targets)
    terms = choi_kraus(superop)
    if len(targets) == 1:
        new = _kraus_sum_kernel(amps, terms, n, targets[0], out=out)
        if new is not None:
            telemetry.inc("channel_route_total", route="kernel")
            return new
    telemetry.inc("channel_route_total", route="engine")
    return _apply_kraus_sum(amps, terms, nsv=2 * n, rows=tuple(targets),
                            cols=tuple(q + n for q in targets))


def _kraus_sum_kernel(amps: torch.Tensor, terms, n: int, t: int,
                      lq: int | None = None,
                      out: torch.Tensor | None = None) -> torch.Tensor | None:
    """A single-target Kraus sum as ONE fused-run pass: every term's K on
    the row qubit and conj(K) on the column qubit, sign-accumulated, in the
    kernel's ``kraus1`` op, placed by :func:`kraus1_pass`. Returns None
    only for a state smaller than two lane rows, as the JAX package's
    ``_kraus_sum_pallas`` does. ``lq`` (tile bits) defaults to the Hopper
    tile; the pass writes into ``out``, a new tensor when None."""
    from . import fused_gates as FG

    if amps.shape[-1] < 2 * FG._LANES:
        return None
    if lq is None:
        lq = FG.hopper_tile_bits(2 * n, amps.dtype)
    terms_h = tuple((float(s), FG.HashableMatrix(k)) for s, k in terms)
    op, swaps = kraus1_pass(n, t, lq, terms_h)
    return FG.fused_run(amps, n=2 * n, ops=(op,), tile_bits=lq, **swaps,
                        out=torch.empty_like(amps) if out is None else out)


def kraus1_pass(n: int, t: int, lq: int, terms, col: int | None = None) -> tuple[tuple, dict]:
    """The ``kraus1`` op of a channel on row qubit t of an n-qubit density
    register, in the frame of a pass at tile bits ``lq``, and that pass's
    folded swaps (``fused_run`` keywords). The column qubit t+n (``col``
    where a shard holds it elsewhere) usually lies above the tile; a 1-bit
    block swap relocates it to the top slot lq-1, as the JAX package's
    ``_kraus_sum_pallas`` does. Where the row qubit is at lq-1 or above
    the tile (JAX refuses it there, which at its 2^19 tile no single-card
    register reaches; the Hopper tile is 2^13), the pair swap relocates the
    row qubit (t >= lq) or the column qubit (t = lq-1) to slot lq-2."""
    r, c = t, t + n if col is None else col
    hi = pair = None
    if c >= lq:
        if t == lq - 1:
            pair, c = (lq - 2, c), lq - 2
        else:
            hi, c = c, lq - 1
            if t >= lq:
                pair, r = (lq - 2, t), lq - 2
    k = 0 if hi is None else 1
    return ("kraus1", r, c, terms), dict(load_swap_k=k, load_swap_hi=hi, store_swap_k=k,
                                         store_swap_hi=hi, pair_swap=pair)


def apply_channel_shards(shards, superop, *, n: int, targets: tuple, eng,
                         spares: list) -> tuple[list, bool]:
    """:func:`apply_channel` on a sharded n-qubit density register through
    ``eng``, its per-gate engine over shards (``parallel.scheduler``), by
    the same routes: the superoperator on (T, T+n) up to
    ``_SUPEROP_MAX_QUBITS`` flattened qubits (while the targets fit the
    shard's local qubits); above it a 1-target channel as one ``kraus1``
    pass of the fused-run kernel per shard, the column qubit t+n moved
    into a local slot and back by collective permutes when it is sharded,
    the state ping-ponging between the shards and ``spares`` (a buffer of
    each shard's size); every other channel by the per-term engine.
    Returns (the new shards, True when they are ``spares``)."""
    from ..parallel import exchange as X
    from ..parallel.mesh import local_qubit_count
    from ..parallel.scheduler import active
    from . import fused_gates as FG

    nsv = 2 * n
    nl = local_qubit_count(nsv, shards)
    targets = tuple(targets)
    cols = tuple(q + n for q in targets)
    dt, dev = shards[0].dtype, shards[0].device
    if eng is active():
        # the explicit scheduler's routes, as the JAX package's: the
        # superoperator, or the Kraus sum, through its relocations
        eng.stats["channel_superops"] += 1
        if nsv <= _SUPEROP_MAX_QUBITS:
            telemetry.inc("channel_route_total", route="superop")
            so = cplx.from_complex(superop, dt, dev)
            return eng.apply_matrix(shards, so, n=nsv, targets=targets + cols), False
        telemetry.inc("channel_route_total", route="engine")
        return kraus_sum_shards(eng, shards, choi_kraus(superop), nsv=nsv, rows=targets,
                                cols=cols), False
    if nsv <= _SUPEROP_MAX_QUBITS and 2 * len(targets) <= nl:
        telemetry.inc("channel_route_total", route="superop")
        so = cplx.from_complex(superop, dt, dev)
        return eng.apply_matrix(shards, so, n=nsv, targets=targets + cols), False
    terms = choi_kraus(superop)
    if (nsv > _SUPEROP_MAX_QUBITS and len(targets) == 1
            and shards[0].shape[-1] >= 2 * FG._LANES):
        telemetry.inc("channel_route_total", route="kernel")
        t, c = targets[0], cols[0]
        lq = FG.hopper_tile_bits(nl, dt)
        terms_h = tuple((float(sg), FG.HashableMatrix(k)) for sg, k in terms)
        state, free = list(shards), list(spares)
        source = None
        if c >= nl:  # the column qubit into a local slot, collectively
            slot = column_slot(nl, t)
            source = list(range(nsv))
            source[slot], source[c] = c, slot
            state, free = X.dist_permute_bits(state, n=nsv, source=source, out=free), state
            c = slot
        op, swaps = kraus1_pass(n, t, lq, terms_h, col=c)
        for a, o in zip(state, free):
            FG.fused_run(a, n=nl, ops=(op,), tile_bits=lq, **swaps, out=o)
        state, free = free, state
        if source is not None:
            state, free = X.dist_permute_bits(state, n=nsv, source=source, out=free), state
        return state, state[0] is spares[0]
    telemetry.inc("channel_route_total", route="engine")
    return kraus_sum_shards(eng, shards, terms, nsv=nsv, rows=targets, cols=cols), False


def column_slot(nl: int, t: int) -> int:
    """The local qubit that a 1-target channel's sharded column qubit is
    moved into for its ``kraus1`` pass on shards of ``nl`` local qubits: the
    top one, or the next one down where the row qubit ``t`` holds it."""
    return nl - 1 if nl - 1 != t else nl - 2


def kraus_sum_shards(eng, shards: list, terms, *, nsv: int, rows: tuple,
                     cols: tuple) -> list:
    """``_apply_kraus_sum`` over shards through the engine ``eng``: two
    ``apply_matrix`` passes per term over every shard, summed a shard."""
    dt, dev = shards[0].dtype, shards[0].device
    out = [None] * len(shards)
    for sign, k in terms:
        km = cplx.from_complex(k, dt, dev)
        y = eng.apply_matrix(shards, km, n=nsv, targets=rows)
        y = eng.apply_matrix(y, km, n=nsv, targets=cols, conj=True)
        out = [_acc_kraus_term(o, sign, v) for o, v in zip(out, y)]
    return out


def _acc_kraus_term(out, sign, term):
    """out + sign * term (None-seeded), the shared Kraus accumulator."""
    term = sign * term if sign != 1.0 else term
    return term if out is None else out + term


def _apply_kraus_sum(amps: torch.Tensor, terms, *, nsv: int, rows: tuple,
                     cols: tuple) -> torch.Tensor:
    """sum_k s_k K_k rho K_k^dagger through the per-gate engine on an
    nsv-qubit flattened state: two ``apply_matrix`` passes per term (K on
    the ``rows`` qubits, conj(K) on the ``cols`` qubits). ``terms`` is
    [(s_k, K_k complex ndarray), ...]."""
    out = None
    for sign, k in terms:
        km = cplx.from_complex(k, amps.dtype, amps.device)
        y = apply.apply_matrix(amps, km, n=nsv, targets=rows)
        y = apply.apply_matrix(y, km, n=nsv, targets=cols, conj=True)
        out = _acc_kraus_term(out, sign, y)
    return out


def dephase_factors_1q(prob: float) -> np.ndarray:
    """Diagonal of the 1-qubit dephasing superoperator on (q, q+n):
    off-diagonal (row bit != col bit) scaled by 1-2p (densmatr_mixDephasing,
    QuEST_cpu.c:60-105)."""
    f = 1 - 2 * prob
    return np.array([1, f, f, 1], dtype=np.complex128)


def dephase_factors_2q(prob: float) -> np.ndarray:
    """Diagonal on (q1, q2, q1+n, q2+n): element factor (1-p) + p/3 (s1 +
    s2 + s1 s2) with s_i = sign agreement of row/col bit i
    (densmatr_mixTwoQubitDephasing, QuEST_cpu.c:84-135). Index bits:
    (b_{q2+n} b_{q1+n} b_{q2} b_{q1})."""
    d = np.empty(16, dtype=np.complex128)
    p = prob
    for idx in range(16):
        r1, r2, c1, c2 = (idx >> 0) & 1, (idx >> 1) & 1, (idx >> 2) & 1, (idx >> 3) & 1
        s1 = 1 if r1 == c1 else -1
        s2 = 1 if r2 == c2 else -1
        d[idx] = (1 - p) + p / 3 * (s1 + s2 + s1 * s2)
    return d


@spy_point
def _diag_dispatch(amps: torch.Tensor, d: np.ndarray, *, n: int,
                   targets: tuple) -> torch.Tensor:
    """A dephasing diagonal ``d`` (numpy complex) on flattened-state
    ``targets``: the point that ``fusion.capture`` patches to record it."""
    return diagonal.apply_diagonal(amps, cplx.from_complex(d, amps.dtype, amps.device),
                                   n=n, targets=targets)


def apply_dephasing(amps: torch.Tensor, prob: float, *, n: int,
                    target: int) -> torch.Tensor:
    return _diag_dispatch(amps, dephase_factors_1q(prob), n=2 * n,
                          targets=(target, target + n))


def apply_two_qubit_dephasing(amps: torch.Tensor, prob: float, *, n: int,
                              q1: int, q2: int) -> torch.Tensor:
    return _diag_dispatch(amps, dephase_factors_2q(prob), n=2 * n,
                          targets=(q1, q2, q1 + n, q2 + n))


def depolarising_kraus(prob: float):
    """(1-p) rho + p/3 (X r X + Y r Y + Z r Z) (mixDepolarising, QuEST.h:4051)."""
    from ..channels import depolarising_kraus as _k
    return _k(prob)


def two_qubit_depolarising_superop(prob: float) -> np.ndarray:
    """The superoperator of mixTwoQubitDepolarising (QuEST.h:4156), from the
    canonical 16-operator Kraus list."""
    from ..channels import two_qubit_depolarising_kraus as _k
    return kraus_superoperator(_k(prob))


def damping_kraus(prob: float):
    """Amplitude damping (mixDamping, QuEST.h:4089)."""
    from ..channels import damping_kraus as _k
    return _k(prob)


def pauli_kraus(px: float, py: float, pz: float):
    """mixPauli as a 4-operator Kraus map (QuEST_common.c:740-760)."""
    from ..channels import pauli_kraus as _k
    return _k(px, py, pz)
