"""The fused gate run: ONE read+write pass of the state applying a run of
gates, on the card through the CUDA kernel ``csrc/fused_gates.cu``.

The counterpart of ``quest_tpu/ops/pallas_gates.py``. A run's ops are
tuples in physical qubit coordinates (the planner's output,
``fusion.PallasRun``):

    ("matrix", q, controls, states, M)   M: 2x2 complex (HashableMatrix); q
                                         in-tile, or any qubit if M is
                                         diagonal
    ("parity", qubits, controls, theta)  exp(-i theta/2 Z...Z), any qubits
    ("swap", q1, q2, controls, states)   SWAP(q1, q2); both in-tile
    ("diagw", targets, controls, D)      D: (2^t,) diagonal, any targets
    ("lane_u", W)                        W: (3, 128, 128) real stack
                                         (Ur^T, Ui^T, Ur^T + Ui^T): a
                                         folded unitary on qubits [0, 7)
    ("window", lo, span, W)              W: (2*2^span)^2 real block
                                         [[Ur, -Ui], [Ui, Ur]]: a folded
                                         unitary on qubits [lo, lo+span)
    ("kraus1", r, c, terms)              a whole channel on a density
    ("kraus2", r1, r2, c1, c2, terms)    state: rho' = sum_k s_k K_k rho
    ("krausn", rows, cols, terms)        K_k^dagger, K_k on the row qubits
                                         and conj(K_k) on the column
                                         qubits (1, 2 or up to 3 of each,
                                         rows[j] bit j of K's index);
                                         terms = ((s_k, K_k), ...)

``lane_u`` and ``window`` come from ``_fold_zone_ops``, which contracts
runs of zone-local gates into dense per-zone unitaries with the same
decisions as the JAX package; kraus ops never fold. The tile is
2^tile_bits amplitudes; a dense (partner-exchanging) target must lie below
tile_bits, and every qubit of a kraus op is dense.

Below the fold, ``merge_diagonals`` packs each run of consecutive diagonal
ops (diagonal ``matrix``, ``parity``, ``diagw``) into few ``diagw`` tables
of up to 2^8 entries, which the kernel's diagonal arm applies in one sweep
of the tile. The fold (``PreparedRun.ops``) is the plan's work and stays
equal to the JAX package's; the merged list (``PreparedRun.records``) is
what is encoded. Beside the merge, ``group_sweeps`` groups the encoded
records for the kernel's 2x2 arm: each maximal run of non-diagonal 2x2
and swap records whose partner qubits fit a set Q of ``SWEEP_BITS``
in-tile qubits is one register-resident sweep of the tile (a thread holds
the 2^|Q| amplitudes of its slice that differ in Q; a lone record's Q is
its own qubits). The grouping is written into fields of the
table that those records' kinds leave free (``mark_sweeps``), one set per
precision: records, table rows and what the plain version computes stay
as they are.

Route: ``fused_run`` launches the kernel for a CUDA tensor, and uses the
plain PyTorch version ``fused_run_plain`` only for a CPU tensor. Both read
the same encoded op table (``encode_ops`` of the merged records), so the
CPU tests that hold the plain version against ``quest_tpu`` also cover the
encoding the kernel reads, and the card checks the kernel against the
plain version.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import telemetry
from .._capture import to_device

#: the lane zone: qubits [0, 7) fold into one 128x128 unitary (lane_u)
LANE_BITS = 7
_LANES = 1 << LANE_BITS

#: the JAX package's default sublane count (pallas_gates._DEF_SUBLANES);
#: kept only so ``local_qubits`` reproduces its tile geometry
_DEF_SUBLANES = 1 << 12

#: the Hopper tile: the largest one whose two planes fit 64 KiB of shared
#: memory, which leaves room for two thread blocks per SM. It is also the
#: largest tile the kernel takes: its dense ops keep 16 (f32) or 8 (f64)
#: outputs per thread of 512.
HOPPER_TILE_BITS = {torch.float32: 13, torch.float64: 12}

#: width (in qubits) of each sublane fold zone, as in the JAX package
_ZONE_SPAN = 5

#: the widest ``diagw`` record the kernel takes (its diagonal arm stages a
#: table of up to 2^8 entries a record), and the width ``merge_diagonals``
#: packs a run of diagonal ops into: the widest measured fastest (PERF.md)
DIAG_TABLE_BITS = 8

#: the 2x2 arm's width m in qubits, per precision: a register sweep holds
#: the 2^m amplitudes of a thread's slice that differ only in its set Q of
#: m in-tile qubits, 8 (f32) and 4 (f64), two groups a thread at the 2^13
#: / 2^12 tile. The widest the kernel's 64 registers a thread hold (PERF.md:
#: f32 at 4 and f64 at 3 spilled); the kernel takes no other width
SWEEP_BITS = {torch.float32: 3, torch.float64: 2}
#: where a precision's grouping sits in the table (p = 0 f32, 1 f64): the
#: sweep's Q mask in r[5] bits [16 p, 16 p + 16), its record count in r[7]
#: bits [16 + 16 p, 32 + 16 p) (matrix and swap records leave r[5] and
#: r[7] above bit 15 free)
_SWEEP_FIELD = {torch.float32: 0, torch.float64: 1}

#: op kind codes of the kernel's op table (csrc/fused_gates.cu)
_KIND = {"matrix": 0, "parity": 1, "swap": 2, "diagw": 3, "lane_u": 4,
         "window": 5, "kraus1": 6, "kraus2": 7, "krausn": 8}
_KRAUS = ("kraus1", "kraus2", "krausn")
_REC = 8


def local_qubits(n: int, sublanes: int = _DEF_SUBLANES) -> int:
    """The JAX package's tile bits for an n-qubit state with ``sublanes``
    rows of 128 lanes per tile (pallas_gates.local_qubits): the geometry to
    pin when a plan must equal the JAX package's."""
    rows = 1 << max(n - LANE_BITS, 0)
    s = min(sublanes, rows)
    return min(n, LANE_BITS + int(math.log2(s)) if s > 1 else LANE_BITS)


def hopper_tile_bits(n: int, dtype) -> int:
    """The port's default tile bits for an n-qubit state of ``dtype``."""
    from ..precision import as_torch_dtype
    return min(n, HOPPER_TILE_BITS[as_torch_dtype(dtype)])


class HashableMatrix:
    """Immutable ndarray wrapper usable inside the static ``ops`` tuple."""

    def __init__(self, arr):
        self.arr = np.asarray(arr, dtype=complex)
        self.arr.setflags(write=False)
        self._key = self.arr.tobytes()

    def __getitem__(self, idx):
        return self.arr[idx]

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, HashableMatrix) and self._key == other._key


def _arr(m) -> np.ndarray:
    return np.asarray(m.arr if hasattr(m, "arr") else m)


def kraus_parts(op) -> tuple[tuple, tuple, tuple]:
    """(row qubits, column qubits, terms) of a kraus op."""
    if op[0] == "kraus1":
        return (op[1],), (op[2],), op[3]
    if op[0] == "kraus2":
        return tuple(op[1:3]), tuple(op[3:5]), op[5]
    return tuple(op[1]), tuple(op[2]), op[3]


# ---------------------------------------------------------------------------
# host-side op algebra (copies of pallas_gates.py's, so folds agree)
# ---------------------------------------------------------------------------

def _op_event(op):
    """Kernel op tuple -> GateEvent (for host-side dense folding)."""
    from ..fusion import GateEvent

    if op[0] == "matrix":
        return GateEvent("matrix", (op[1],), tuple(op[2]), tuple(op[3]),
                         matrix=_arr(op[4]))
    if op[0] == "swap":
        return GateEvent("swap", (op[1], op[2]), tuple(op[3]), tuple(op[4]))
    if op[0] == "diagw":
        return GateEvent("diag", tuple(op[1]), tuple(op[2]),
                         diag=_arr(op[3]).reshape(-1))
    return GateEvent("parity", tuple(op[1]), tuple(op[2]), theta=float(op[3]))


def op_dense_targets(op) -> tuple:
    """Qubits on which ``op`` needs a DENSE (partner-exchanging) action --
    the ones that must sit below the tile. Diagonal roles (controls,
    parity members, diagw and diagonal-matrix targets) resolve per tile."""
    if op[0] == "matrix":
        m = _arr(op[4])
        if complex(m[0][1]) == 0 and complex(m[1][0]) == 0:
            return ()
        return (op[1],)
    if op[0] == "swap":
        return (op[1], op[2])
    if op[0] in _KRAUS:
        rows, cols, _ = kraus_parts(op)
        return rows + cols
    return ()  # parity / diagw / lane_u / window


def _op_support(op):
    if op[0] == "matrix":
        return {op[1], *op[2]}
    if op[0] == "swap":
        return {op[1], op[2], *op[3]}
    if op[0] in ("diagw", "parity"):
        return {*op[1], *op[2]}
    if op[0] in _KRAUS:
        return set(op_dense_targets(op))
    return set(range(LANE_BITS))  # lane_u acts on the lane zone


def _op_is_diag(op):
    if op[0] in ("diagw", "parity"):
        return True
    if op[0] == "matrix":
        m = _arr(op[4])
        return complex(m[0][1]) == 0 and complex(m[1][0]) == 0
    return False


#: relative cost weights of the fold decision, unitless: a zone folds when
#: the summed weights of its gates exceed the weight of its dense product.
#: Only their ratios matter. They are copied from the JAX package (where
#: they were fitted on its TPU kernel) so that the two packages fold
#: alike and their plans agree; they are to be refit from this kernel's
#: own per-op times on the H100.
_FOLD_LANE_DOT_WEIGHT = 0.47
_FOLD_WINDOW_DOT_WEIGHT = 0.87


def _op_cost(op) -> float:
    """Relative weight of one un-folded op (same scale as the fold
    weights): diagonals are almost free, lane-zone butterflies dear."""
    if _op_is_diag(op):
        return 0.01

    def tcost(q):
        if q < LANE_BITS:
            return 0.76
        return 0.07 if q - LANE_BITS < 3 else 0.25

    if op[0] == "matrix":
        return tcost(op[1])
    if op[0] == "swap":
        return tcost(op[1]) + tcost(op[2])
    return 0.02  # kraus ops never reach this model: zone_of() bars them


def _fold_zone_ops(ops, tile_bits: int) -> tuple:
    """Contract runs of zone-local ops into dense per-zone matrices.

    The tile's qubits split into the lane zone [0, 7) and successive
    _ZONE_SPAN-wide zones [7, 12), [12, 17)... Ops fully inside one zone
    accumulate into that zone's dense unitary; distinct zones touch
    disjoint qubits, so open accumulators commute and each keeps absorbing
    gates until an op that overlaps its zone forces a flush. A flushed zone
    folds only when its gates' summed weight exceeds the zone's dense
    weight; the lane zone emits ("lane_u", W3), a sublane zone
    ("window", lo, span, W)."""
    from ..fusion import event_matrix

    zones = [(0, LANE_BITS)]
    lo = LANE_BITS
    while lo < tile_bits:
        zones.append((lo, min(lo + _ZONE_SPAN, tile_bits)))
        lo += _ZONE_SPAN

    out = []
    accum = {z: [] for z in zones}

    def zone_of(op):
        if op[0] in _KRAUS:
            return None  # non-unitary: never enters a zone's dense fold
        s = _op_support(op)
        for z in zones:
            if all(z[0] <= q < z[1] for q in s):
                return z
        return None

    def flush(z):
        run = accum[z]
        if not run:
            return
        dot = _FOLD_LANE_DOT_WEIGHT if z[0] == 0 else _FOLD_WINDOW_DOT_WEIGHT
        if sum(_op_cost(o) for o in run) <= dot:
            out.extend(run)
            run.clear()
            return
        qubits = tuple(range(z[0], z[1]))
        U = np.eye(1 << len(qubits), dtype=complex)
        for op in run:
            U = event_matrix(_op_event(op), qubits) @ U
        ur, ui = U.real, U.imag
        if z[0] == 0:
            out.append(("lane_u", HashableMatrix(np.stack([ur.T, ui.T, ur.T + ui.T]))))
        else:
            out.append(("window", z[0], z[1] - z[0],
                        HashableMatrix(np.block([[ur, -ui], [ui, ur]]))))
        run.clear()

    for op in ops:
        z = zone_of(op)
        if z is not None:
            accum[z].append(op)
            continue
        s = _op_support(op)
        for z2 in zones:
            if any(z2[0] <= q < z2[1] for q in s):
                flush(z2)
        out.append(op)
    for z in zones:
        flush(z)
    return tuple(out)


def _diag_factor(op, bit) -> np.ndarray:
    """The diagonal of the elementwise ``op`` at every index of a table,
    complex128: ``bit[q]`` holds qubit q's bit of each table index (its
    support's qubits all have one). Identity where a control misses."""
    if op[0] == "matrix":
        _, q, controls, states, M = op
        m = _arr(M).astype(complex)
        states = states if states else (1,) * len(controls)
        f = np.where(bit[q] == 1, m[1, 1], m[0, 0])
    elif op[0] == "parity":
        _, qubits, controls, theta = op
        states = (1,) * len(controls)
        par = np.zeros_like(next(iter(bit.values())))
        for q in qubits:
            par = par ^ bit[q]
        c, s = math.cos(theta / 2), math.sin(theta / 2)
        f = np.where(par == 1, complex(c, s), complex(c, -s))
    else:  # diagw
        _, targets, controls, D = op
        states = (1,) * len(controls)
        k = sum(bit[q] << j for j, q in enumerate(targets))
        f = _arr(D).astype(complex).reshape(-1)[k]
    ok = np.ones(f.shape, dtype=bool)
    for c, st in zip(controls, states):
        ok &= bit[c] == int(st)
    return np.where(ok, f, 1.0)


def _diag_table_op(qubits, ops) -> tuple:
    """One ``diagw`` op over ``qubits`` (ascending: table bit j is the j-th
    lowest, so that a warp's lanes read neighbouring entries) that applies
    every op of ``ops``, with no controls: its table is their product,
    built in complex128."""
    qubits = tuple(sorted(qubits))
    idx = np.arange(1 << len(qubits))
    bit = {q: (idx >> j) & 1 for j, q in enumerate(qubits)}
    d = np.ones(idx.size, dtype=complex)
    for op in ops:
        d = d * _diag_factor(op, bit)
    return ("diagw", qubits, (), HashableMatrix(d))


def merge_diagonals(ops, max_bits: int = DIAG_TABLE_BITS) -> tuple:
    """The records a run's folded ops encode into: each maximal run of
    consecutive elementwise ops (diagonal ``matrix``, ``parity``,
    ``diagw``) packed into as few ``diagw`` tables of at most ``max_bits``
    qubits as first fit finds, every other op as it is. A control (or an
    anti-control) is one more index bit of the table, with identity
    entries where it misses. Diagonal ops commute, so the order inside a
    run is free; an op whose qubits and controls exceed ``max_bits`` stays
    as it is, in the run. Nothing crosses a non-elementwise op. The plan
    (``PreparedRun.ops``) is not changed: only what the kernel and its
    plain version read."""
    if not 0 <= max_bits <= DIAG_TABLE_BITS:
        raise ValueError(f"a diagonal table takes 0 to {DIAG_TABLE_BITS} qubits, "
                         f"got {max_bits}")
    out, run = [], []

    def flush():
        groups, items = [], []  # items: op tuples kept, [qubits, ops] groups
        for op in run:
            s = _op_support(op)
            if len(s) > max_bits:
                items.append(op)
                continue
            g = next((g for g in groups if len(g[0] | s) <= max_bits), None)
            if g is None:
                g = [set(), []]
                groups.append(g)
                items.append(g)
            g[0].update(s)
            g[1].append(op)
        out.extend(_diag_table_op(*it) if isinstance(it, list) else it for it in items)
        run.clear()

    for op in ops:
        if _op_is_diag(op):
            run.append(op)
            continue
        flush()
        out.append(op)
    flush()
    return tuple(out)


def _opens_sweep(op) -> bool:
    """A record the 2x2 arm applies: a non-diagonal ``matrix`` or a ``swap``."""
    return op[0] == "swap" or (op[0] == "matrix" and not _op_is_diag(op))


def _pad_sweep(q: set, m: int, tile_bits: int) -> int:
    """The mask of Q filled up to m in-tile qubits, the extra ones taken from
    [5, tile_bits) first: a warp's 32 lanes take the five lowest tile bits
    outside Q, so that with Q above bit 4 each register step's
    shared-memory accesses fall in distinct banks."""
    free = [b for b in (*range(5, tile_bits), *range(min(5, tile_bits))) if b not in q]
    return _mask(q | set(free[:m - len(q)]))


def group_sweeps(records, m: int, tile_bits: int) -> tuple:
    """The register sweeps of the 2x2 arm over ``records`` (the merged,
    encoded list): ((start, count, qmask), ...). A sweep opens at a
    non-diagonal ``matrix`` or a ``swap`` record and takes, in order, every
    following 2x2 / swap record whose partner qubits, joined to Q, keep Q
    at m qubits or fewer. It closes before any other record (elementwise
    ones stay with the diagonal arm's sweep: PERF.md, the break-even), and
    before a 2x2 that would need an (m+1)-th qubit. Controls add nothing to
    Q: the kernel tests them on each amplitude's index. Nothing moves: a
    sweep is records [start, start + count). The Q of a sweep of several
    records is padded to exactly m in-tile qubits (``_pad_sweep``); a sweep
    of one keeps its record's own partner qubits (the kernel walks it in
    pairs or quads). Every 2x2 and swap record lies in one sweep."""
    if not 2 <= m <= min(tile_bits, 4):
        raise ValueError(f"a register sweep takes 2 to 4 qubits (at most tile_bits="
                         f"{tile_bits}), got {m}")
    out, i, nrec = [], 0, len(records)
    while i < nrec:
        if not _opens_sweep(records[i]):
            i += 1
            continue
        q = set(op_dense_targets(records[i]))
        j = i + 1
        while j < nrec and _opens_sweep(records[j]):
            joined = q | set(op_dense_targets(records[j]))
            if len(joined) > m:
                break
            q, j = joined, j + 1
        out.append((i, j - i, _pad_sweep(q, m, tile_bits) if j - i > 1 else _mask(q)))
        i = j
    return tuple(out)


def mark_sweeps(table: np.ndarray, sweeps: dict) -> None:
    """Write each precision's sweeps (``{dtype: group_sweeps(...)}``) into
    the first record of each: Q's mask into r[5], the record count into
    r[7] above bit 15, at the precision's place (``_SWEEP_FIELD``)."""
    for dt, spans in sweeps.items():
        p = _SWEEP_FIELD[dt]
        for start, count, qmask in spans:
            if not 0 < count < 1 << 16 or table[start, 5] >> (16 * p) & 0xffff:
                raise ValueError(f"bad register sweep at record {start} ({count} records)")
            table[start, 5] |= qmask << (16 * p)
            table[start, 7] |= count << (16 + 16 * p)


def sweep_spans(table: np.ndarray, dtype) -> tuple:
    """The register sweeps that ``table`` holds for ``dtype``, read back
    from its fields: ((start, count, qmask), ...)."""
    p = _SWEEP_FIELD[dtype]
    counts = (table[:, 7] >> (16 + 16 * p)) & 0xffff
    return tuple((int(i), int(counts[i]), int((table[i, 5] >> (16 * p)) & 0xffff))
                 for i in np.flatnonzero(counts))


def swap_bit_blocks(amps: torch.Tensor, *, n: int, lo1: int, lo2: int,
                    k: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """Exchange the k-bit index blocks [lo1, lo1+k) and [lo2, lo2+k)
    (lo1 + k <= lo2) of the planar (2, 2^n) state, or of each lane of a
    (B, 2, 2^n) batch: a pure qubit relabeling, one permute. Returns a new
    contiguous tensor, or ``out`` (a contiguous buffer of the state's size,
    not the state) written in place."""
    if not (lo1 + k <= lo2 and lo2 + k <= n):
        raise ValueError(f"bad bit-block swap (lo1={lo1}, lo2={lo2}, k={k}, n={n})")
    d = 1 << k
    x = amps.reshape(-1, amps.shape[-1] >> (lo2 + k), d, 1 << (lo2 - lo1 - k), d,
                     1 << lo1)
    y = x.permute(0, 1, 4, 3, 2, 5)
    if out is None:
        return y.reshape(amps.shape)
    out.view(y.shape).copy_(y)
    return out


# ---------------------------------------------------------------------------
# the op table the kernel and the plain version read
# ---------------------------------------------------------------------------

def _mask(qubits) -> int:
    m = 0
    for q in qubits:
        m |= 1 << int(q)
    return m


def kraus_superop_table(terms, qubits) -> np.ndarray:
    """The kernel's form of a kraus op: S^T, where S = sum_k s_k conj(K_k)
    (x) K_k is the channel's superoperator on ``qubits`` (rows then
    columns, bit j of S's index is qubits[j], as in
    ``ops.density.kraus_superoperator``), re-indexed so that bit j is the
    j-th LOWEST of the qubits: the kernel walks the index as a deposit into
    the qubits' mask. Complex (G, G), entry [e, d] = S[d, e]."""
    S = sum(s * np.kron(np.conj(K), K) for s, K in terms)
    order = np.argsort(qubits)  # ascending position i holds bit order[i]
    e = np.arange(S.shape[0])
    to_asc = sum(((e >> int(j)) & 1) << i for i, j in enumerate(order))
    Sa = np.empty_like(S)
    Sa[np.ix_(to_asc, to_asc)] = S
    return Sa.T


def tf32_split(w) -> tuple[np.ndarray, np.ndarray]:
    """(hi, lo) of float32 ``w`` as the kernel splits an operand for 3xTF32
    (``csrc/mma.cuh``: ``split_tf32``): hi = w rounded to TF32, nearest
    with ties away from zero, as ``(bits + 0x1000) & 0xffffe000``; lo = w -
    hi, exact in float32 (the tensor core reads it as TF32, dropping its
    low 13 bits). Both float32."""
    w = np.ascontiguousarray(w, dtype=np.float32)
    hi = ((w.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)
    return hi, w - hi


def lane_u_split_table(wr, wi) -> np.ndarray:
    """The f32 kernel's form of a lane_u op's U^T (``wr``, ``wi``: U^T real
    and imaginary, 128 x 128, [c][n]): each rounded to float32 and split
    by :func:`tf32_split`, laid out in the order of its B fragments
    (``csrc/fused_gates.cu``, ``lane_u_mma``): per plane, per output column
    n, per chunk j of 16 c, per k step h, per t the four values hi(c0),
    hi(c0 + 1), lo(c0), lo(c0 + 1) with c0 = 16 j + 4 t + 2 h. Float32,
    (2, 128, 8, 2, 4, 4)."""
    planes = []
    for w in (wr, wi):
        hi, lo = tf32_split(w)
        # c = 16 j + 4 t + 2 h + e: (j, t, h, e, n) -> (n, j, h, t, [hi, lo], e)
        hl = np.stack([hi, lo]).reshape(2, 8, 4, 2, 2, _LANES)
        planes.append(hl.transpose(5, 1, 3, 2, 0, 4).reshape(_LANES, 8, 2, 4, 4))
    return np.stack(planes)


def lane_u_f64_table(wr, wi) -> np.ndarray:
    """The f64 kernel's form of a lane_u op's U^T (``wr``, ``wi``: U^T real
    and imaginary, 128 x 128, [c][n]), in the order of its FP64 B fragments
    (``csrc/fused_gates.cu``, ``lane_u_dmma``): per sweep q (output columns
    64 q .. 64 q + 63), per k step s = 2 j + h, per plane, per output column
    64 q + n, per t the two values U^T[c0][64 q + n], U^T[c0 + 1][64 q + n]
    with c0 = 16 j + 4 t + 2 h, so that each (sweep, k step) is one
    contiguous half panel. The same float64 values, permuted: (2, 16, 2,
    64, 4, 2)."""
    planes = []
    for w in (wr, wi):
        # c = 16 j + 4 t + 2 h + e, column 64 q + n:
        # (j, t, h, e, q, n) -> (q, j, h, n, t, e)
        w = np.asarray(w, dtype=np.float64).reshape(8, 4, 2, 2, 2, _LANES // 2)
        planes.append(w.transpose(4, 0, 2, 5, 1, 3).reshape(2, 16, _LANES // 2, 4, 2))
    return np.stack(planes, axis=2)


def kraus_superop_f64_table(St) -> np.ndarray:
    """The f64 kernel's form of a 3-qubit kraus op's S^T (``St``: the 64 x
    64 complex ``kraus_superop_table``, [e][d]), in the order of its FP64 B
    fragments (``csrc/fused_gates.cu``, ``krausn_dmma``): per k16 step kk,
    per h, per plane (real, imaginary), per output column n, per t the two
    values S^T[16 kk + t + 8 h][n] and S^T[16 kk + t + 8 h + 4][n], so that
    each step is one contiguous 16 KiB chunk (the kernel streams the four
    once per sweep of 32 groups) and each lane's B values of one h one
    16-byte load. The same float64 values, permuted: (4, 2, 2, 64, 4, 2)."""
    St = np.asarray(St)
    planes = []
    for w in (St.real, St.imag):
        # e = 16 kk + 8 h + 4 e' + t: (kk, h, e', t, n) -> (kk, h, n, t, e')
        w = np.asarray(w, dtype=np.float64).reshape(4, 2, 2, 4, 64)
        planes.append(w.transpose(0, 1, 4, 3, 2))
    return np.stack(planes, axis=2)


def kraus_superop_tf32_table(St) -> np.ndarray:
    """The f32 kernel's form of a 3-qubit kraus op's S^T (``St``: the 64 x
    64 complex ``kraus_superop_table``, [e][d]): each plane rounded to
    float32 and split by :func:`tf32_split`, in the order of its split B
    fragments (``csrc/fused_gates.cu``, ``krausn_mma``): per k16 step kk,
    per k8 step h, per plane (real, imaginary), per output column n, per t
    the four values hi(S^T[e0][n]), hi(S^T[e0 + 4][n]), lo(S^T[e0][n]),
    lo(S^T[e0 + 4][n]) with e0 = 16 kk + 8 h + t, so that each step kk is
    one contiguous 16 KiB chunk and each lane's split B values of one h and
    plane one 16-byte load. Float32, (4, 2, 2, 64, 4, 4)."""
    St = np.asarray(St)
    planes = []
    for w in (St.real, St.imag):
        hi, lo = tf32_split(w)
        # e = 16 kk + 8 h + 4 e' + t: ([hi, lo], kk, h, e', t, n) -> (kk, h, n, t, [hi, lo], e')
        hl = np.stack([hi, lo]).reshape(2, 4, 2, 2, 4, 64)
        planes.append(hl.transpose(1, 2, 5, 4, 0, 3).reshape(4, 2, 64, 4, 4))
    return np.stack(planes, axis=2)


def window_f64_table(W, span: int) -> np.ndarray:
    """The f64 kernel's form of a window op's U (``W``: the op's real block
    [[Ur, -Ui], [Ui, Ur]], 2D x 2D, D = 2^span, span 3 to 5), in the order
    of its FP64 A fragments (``csrc/fused_gates.cu``, ``window_dmma``): per
    m16 tile mt (D / 16 of them, one at D = 8), per k8 step ks (D / 8), per
    plane (real, imaginary), per half h, per lane (g, t) = divmod(lane, 4),
    the two values U[16 mt + g][8 ks + t + 4 h] and U[16 mt + g + 8][8 ks +
    t + 4 h], 0 where the row is past D: a lane's A values of one half in
    one 16-byte load. Float64, (max(D / 16, 1), D / 8, 2, 2, 32, 2)."""
    D = 1 << span
    if not 3 <= span <= 5:
        raise ValueError(f"the f64 window table takes spans 3 to 5, got {span}")
    W = np.asarray(W, dtype=np.float64)
    mt = max(D // 16, 1)
    planes = []
    for u in (W[:D, :D], W[D:, :D]):
        # rows 16 mt + 8 j + g (zero-padded to 16 mt rows), columns 8 ks + 4 h + t:
        # (mt, j, g, ks, h, t) -> (mt, ks, h, g, t, j)
        u = np.concatenate([u, np.zeros((16 * mt - D, D))]).reshape(mt, 2, 8, D // 8, 2, 4)
        planes.append(u.transpose(0, 3, 4, 2, 5, 1).reshape(mt, D // 8, 2, 32, 2))
    return np.stack(planes, axis=2)


def _matrix_form(m: np.ndarray) -> int:
    """The arithmetic form of a 2x2 that the kernel's 2x2 arm takes (r[7]
    bits 1-2): 3 X, 1 real, 0 any other."""
    if (m == np.array([[0, 1], [1, 0]])).all():
        return 3
    return int(not m.imag.any())


def encode_ops(ops) -> tuple[np.ndarray, np.ndarray]:
    """(table, coeffs): ``table`` is int64 (num_ops, 8) -- kind, two qubit
    fields, control mask, control values, parity mask, offset into
    ``coeffs``, flags (bit 0: a diagonal ``matrix``; bits 1-2 its form,
    ``_matrix_form``) -- and ``coeffs``
    float64 holds each op's numbers,
    every block padded to a multiple of 4:
    matrix 8 (m00..m11, re/im), parity 2 (cos, sin of theta/2), diagw 2^t
    (t <= 8 targets, packed 6 bits each) interleaved re/im, lane_u U^T
    real then imaginary (128 x 128 each, what the plain version reads),
    then for the f32 kernel the same split
    into TF32 hi and lo in its fragment order (``lane_u_split_table``, 2 x
    128 x 256), then for the f64 kernel the same in its fragment order
    (``lane_u_f64_table``, 2 x 16 x 2 x 64 x 8); window U real then
    imaginary (D x D each, what the plain version and the f32 kernel read:
    its spans 3 to 5 split them into TF32 hi and lo as ``window_mma``
    stages them), then for spans 3 to 5 the same in the f64 kernel's
    A-fragment order (``window_f64_table``, max(D / 16, 1) x D / 8 x 2 x 2
    x 32 x 2), which ``window_dmma`` stages.

    A kraus op on t row and t column qubits (d = 2^t, G = d^2) records t,
    the 2t qubits packed 6 bits each (rows then columns) and their mask;
    its block is ``kraus_superop_table`` (G x G, real then imaginary; built
    in float64 and rounded once to the state's type), what the kernel's t
    = 1, 2 arms read; at t = 3 it is followed by the same S^T in the f64
    kernel's FP64 fragment order (``kraus_superop_f64_table``, 4 x 2 x 2 x
    64 x 8), which ``krausn_dmma`` streams, then by its TF32 split in the
    f32 kernel's fragment order (``kraus_superop_tf32_table``, 4 x 2 x 2 x
    64 x 16, float32 values: exact in the f32 device copy), which
    ``krausn_mma`` streams. The plain version applies the op's terms, which
    stay on the host in the op tuple.

    ``matrix`` and ``swap`` records leave r[5] and r[7] above bit 15 free:
    ``PreparedRun`` writes the 2x2 arm's grouping there afterwards
    (:func:`mark_sweeps`: a sweep's first record carries, per precision,
    its Q mask and its record count), which the plain version ignores."""
    table = np.zeros((len(ops), _REC), dtype=np.int64)
    coeffs: list[np.ndarray] = []
    off = 0

    def put(vals):
        # each op's block starts 4-element aligned: the kernel reads lane_u
        # rows with 16-byte vector loads
        nonlocal off
        vals = np.ascontiguousarray(vals, dtype=np.float64).reshape(-1)
        vals = np.concatenate([vals, np.zeros(-vals.size % 4)])
        coeffs.append(vals)
        start = off
        off += vals.size
        return start

    for i, op in enumerate(ops):
        rec = table[i]
        kind = op[0]
        if kind not in _KIND:
            raise ValueError(f"the fused-run kernel has no op {kind!r} yet")
        rec[0] = _KIND[kind]
        if kind == "matrix":
            _, q, controls, states, M = op
            m = _arr(M).astype(complex)
            states = states if states else (1,) * len(controls)
            rec[1] = q
            rec[3] = _mask(controls)
            rec[4] = _mask(c for c, s in zip(controls, states) if s)
            rec[6] = put([(v.real, v.imag) for v in m.reshape(-1)])
            rec[7] = int(m[0, 1] == 0 and m[1, 0] == 0) | _matrix_form(m) << 1
        elif kind == "parity":
            _, qubits, controls, theta = op
            rec[3] = rec[4] = _mask(controls)
            rec[5] = _mask(qubits)
            rec[6] = put([math.cos(theta / 2), math.sin(theta / 2)])
        elif kind == "swap":
            _, q1, q2, controls, states = op
            states = states if states else (1,) * len(controls)
            rec[1], rec[2] = q1, q2
            rec[3] = _mask(controls)
            rec[4] = _mask(c for c, s in zip(controls, states) if s)
            rec[6] = put([0.0])
        elif kind == "diagw":
            _, targets, controls, D = op
            d = _arr(D).astype(complex).reshape(-1)
            if len(targets) > DIAG_TABLE_BITS or d.size != 1 << len(targets):
                raise ValueError(f"diagw op needs 2^t <= {1 << DIAG_TABLE_BITS} "
                                 f"entries, got {d.size}")
            rec[1] = len(targets)
            rec[2] = sum(int(q) << (6 * j) for j, q in enumerate(targets))
            rec[3] = rec[4] = _mask(controls)
            rec[6] = put(np.stack([d.real, d.imag], axis=1))
        elif kind == "lane_u":
            W = _arr(op[1]).real
            rec[6] = put(np.concatenate([W[0].reshape(-1), W[1].reshape(-1),
                                         lane_u_split_table(W[0], W[1]).reshape(-1),
                                         lane_u_f64_table(W[0], W[1]).reshape(-1)]))
        elif kind in _KRAUS:
            rows, cols, terms = kraus_parts(op)
            t = len(rows)
            if not 1 <= t <= 3 or len(cols) != t or len(set(rows + cols)) != 2 * t:
                raise ValueError(f"a kraus op takes 1 to 3 row qubits and as many "
                                 f"other column qubits, got {rows} and {cols}")
            if not terms:
                raise ValueError("a kraus op needs at least one term")
            ks = [(float(s), _arr(K).astype(complex)) for s, K in terms]
            qubits = rows + cols
            St = kraus_superop_table(ks, qubits)
            rec[1] = t
            rec[2] = sum(int(q) << (6 * j) for j, q in enumerate(qubits))
            rec[5] = _mask(qubits)
            parts = [St.real.reshape(-1), St.imag.reshape(-1)]
            if t == 3:
                parts += [kraus_superop_f64_table(St).reshape(-1),
                          kraus_superop_tf32_table(St).reshape(-1)]
            rec[6] = put(np.concatenate(parts))
        else:  # window
            _, lo, span, W = op
            W = _arr(W).real
            D = 1 << span
            rec[1], rec[2] = lo, span
            parts = [W[:D, :D].reshape(-1), W[D:, :D].reshape(-1)]
            if span >= 3:
                parts.append(window_f64_table(W, span).reshape(-1))
            rec[6] = put(np.concatenate(parts))
    flat = np.concatenate(coeffs) if coeffs else np.zeros(1)
    return table, flat


class PreparedRun:
    """A run's folded ops and their encoded table, computed once per
    (ops, tile_bits) and kept with the run because plans are replayed; the
    device copies are cached per (device, dtype), staged
    (``_capture.to_device``) so that a compiled replay keeps them.

    ``ops`` is the fold, the plan's work (as the JAX package folds it);
    ``records`` what the kernel and the plain version read, one table row
    each: the fold with each run of diagonal ops merged into ``diagw``
    tables of at most ``diag_bits`` qubits (:func:`merge_diagonals`).
    ``sweeps`` holds, per precision, the 2x2 arm's register sweeps over the
    records (:func:`group_sweeps` at the width ``SWEEP_BITS[dtype]``),
    which :func:`mark_sweeps` writes into the table: the first record of a
    sweep carries its Q mask in r[5] and its record count in r[7] above
    bit 15."""

    def __init__(self, ops, tile_bits: int, diag_bits: int = DIAG_TABLE_BITS):
        self.tile_bits = tile_bits
        self.ops = _fold_zone_ops(tuple(ops), tile_bits)
        self.records = merge_diagonals(self.ops, diag_bits)
        self.table, self.coeffs = encode_ops(self.records)
        self.sweeps = {dt: group_sweeps(self.records, m, tile_bits)
                       for dt, m in SWEEP_BITS.items()}
        mark_sweeps(self.table, self.sweeps)
        self.has_lane_u = any(o[0] == "lane_u" for o in self.ops)
        #: what the kernel stages through extra shared memory, the launch's
        #: ``staged`` flags (``csrc/fused_gates.cu``): bit 0 a lane_u op's
        #: matrix, bit 1 a 3-qubit kraus op's S^T, bit 2 the U of a window op
        #: of span 3 or more (in either precision: the f64 fragment table, or
        #: U split into TF32 hi and lo by the f32 kernel as it stages it), bit
        #: 3 an elementwise record (the diagonal arm's tables)
        self.staged = (int(self.has_lane_u)
                       | 2 * any(o[0] in _KRAUS and len(kraus_parts(o)[0]) == 3
                                 for o in self.ops)
                       | 4 * any(o[0] == "window" and o[2] >= 3 for o in self.ops)
                       | 8 * any(_op_is_diag(o) for o in self.records))
        self._device: dict = {}

    def device_tables(self, device, dtype):
        key = (str(device), dtype)
        if key not in self._device:
            self._device[key] = (
                to_device(self.table, None, device).contiguous(),
                to_device(self.coeffs, dtype, device).contiguous())
        return self._device[key]


def _check_windows(prepared: PreparedRun, dtype) -> None:
    """An f64 window op must be the zone [7, tile_bits) that
    ``_fold_zone_ops`` makes at the f64 tile (at most 2^12): the kernel's
    f64 window arm (``window_dmma``) takes lo = 7 and lo + span =
    tile_bits, and no other f64 window reaches it."""
    if dtype != torch.float64:
        return
    for o in prepared.ops:
        if o[0] == "window" and (o[1] != LANE_BITS or o[1] + o[2] != prepared.tile_bits):
            raise ValueError(
                f"an f64 window op must cover the qubits [{LANE_BITS}, tile_bits="
                f"{prepared.tile_bits}), got lo={o[1]}, span={o[2]}")


#: the most lanes one launch takes (the grid's second dimension)
MAX_LANES = 65535


def _check(amps: torch.Tensor, n: int, local_n: int, shard_index: int, ops,
           tile_bits: int, swaps, pair) -> None:
    if not 0 < local_n <= n or not 0 <= shard_index < 1 << (n - local_n):
        raise ValueError(f"shard {shard_index} of 2^{local_n} amplitudes does not "
                         f"lie in a {n}-qubit state")
    if amps.dim() not in (2, 3) or amps.shape[-2:] != (2, 1 << local_n):
        raise ValueError(f"state must be planar (2, 2^{local_n}) or a batch of lanes "
                         f"(B, 2, 2^{local_n}), got {tuple(amps.shape)}")
    if amps.dim() == 3 and not 1 <= amps.shape[0] <= MAX_LANES:
        raise ValueError(f"a launch takes 1 to {MAX_LANES} lanes, got {amps.shape[0]}")
    if amps.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"state must be float32 or float64, got {amps.dtype}")
    if not LANE_BITS <= tile_bits <= min(local_n, HOPPER_TILE_BITS[amps.dtype]):
        raise ValueError(
            f"tile_bits={tile_bits} outside [{LANE_BITS}, "
            f"min(local_n={local_n}, {HOPPER_TILE_BITS[amps.dtype]})] for {amps.dtype}")
    for o in ops:
        bad = [q for q in op_dense_targets(o) if q >= tile_bits]
        if bad:
            raise ValueError(
                f"{o[0]} dense target(s) {bad} >= tile_bits {tile_bits} (the "
                f"local_qubits of this geometry); route wide targets via ops.apply")
    for k, hi in swaps:
        if k and (k > tile_bits - LANE_BITS or hi < tile_bits or hi + k > local_n):
            raise ValueError(f"bit-block swap (k={k}, hi={hi}) exceeds the call "
                             f"geometry (tile_bits={tile_bits}, local_n={local_n})")
    if pair is not None:
        lo, hi = pair
        blocks = {q for k, h in swaps if k
                  for q in (*range(tile_bits - k, tile_bits), *range(h, h + k))}
        if not 0 <= lo < tile_bits <= hi < local_n or {lo, hi} & blocks:
            raise ValueError(f"pair swap {pair} must exchange an in-tile bit with "
                             f"one above the tile (tile_bits={tile_bits}, "
                             f"local_n={local_n}), apart from the bit-block swaps")


def fused_run(amps: torch.Tensor, *, n: int, ops: tuple, tile_bits: int,
              load_swap_k: int = 0, store_swap_k: int = 0,
              load_swap_hi: int | None = None,
              store_swap_hi: int | None = None,
              pair_swap: tuple[int, int] | None = None,
              out: torch.Tensor | None = None,
              prepared: PreparedRun | None = None,
              local_n: int | None = None, shard_index: int = 0) -> torch.Tensor:
    """Apply ``ops`` to the planar (2, 2^n) state in one pass and return
    the tensor that holds the result: ``out`` when given, else ``amps``
    itself (updated in place).

    ``amps`` may be a contiguous (B, 2, 2^n) batch of B lanes (and ``out``
    then the same): each lane is a whole state, and ONE launch applies the
    same op table to all of them (the grid's second dimension is the
    lane).

    ``local_n`` < n runs the pass on one shard of a sharded n-qubit state:
    ``amps`` is (2, 2^local_n), the amplitudes [shard_index 2^local_n,
    (shard_index + 1) 2^local_n) of the flat index. The ops' qubits stay
    global: a role (control, diagonal target, diagw or parity member) on a
    qubit at or above local_n reads that bit of ``shard_index``. Dense
    targets lie below the tile and folded swaps inside the shard.

    ``load_swap_k`` = k > 0 means the state arrives in the other frame:
    ``swap_bit_blocks(lo1=tile_bits-k, lo2=load_swap_hi or tile_bits, k)``
    is folded into the loads, so ``ops`` are in this run's frame.
    ``store_swap_k``/``store_swap_hi`` fold the same relabeling into the
    stores. ``pair_swap`` = (lo, hi), lo < tile_bits <= hi, exchanges the
    two index bits in the loads AND the stores: it brings one more qubit
    from above the tile to slot lo for this run only. A folded swap makes
    a thread block read tiles that others write, so such a call needs
    ``out`` (a different buffer).

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version; a meta tensor (the planner's) returns unchanged.
    ``prepared`` is the run's cached fold and op table."""
    lh = tile_bits if load_swap_hi is None else load_swap_hi
    sh = tile_bits if store_swap_hi is None else store_swap_hi
    local_n = n if local_n is None else local_n
    _check(amps, n, local_n, shard_index, ops, tile_bits,
           ((load_swap_k, lh), (store_swap_k, sh)), pair_swap)
    if prepared is None:
        prepared = PreparedRun(ops, tile_bits)
    elif prepared.tile_bits != tile_bits:
        raise ValueError("prepared run was folded for another tile geometry")
    _check_windows(prepared, amps.dtype)
    dst = amps if out is None else out
    if dst is not amps and (dst.shape != amps.shape or dst.dtype != amps.dtype
                            or dst.device != amps.device):
        raise ValueError("out must match the state's shape, dtype and device")
    if amps.device.type == "meta":
        # the planner's abstract evaluation (parallel.scheduler.plan_circuit):
        # shapes and decisions only, nothing to launch
        return dst
    if ((load_swap_k or store_swap_k or pair_swap)
            and dst.data_ptr() == amps.data_ptr()):
        raise ValueError("a folded frame swap runs out of place: pass out=")
    telemetry.inc("pallas_pass_total", kind="fused_run")
    if amps.device.type == "cpu":
        dst.copy_(fused_run_plain(amps, prepared, n=n, tile_bits=tile_bits,
                                  load_swap_k=load_swap_k, load_swap_hi=lh,
                                  store_swap_k=store_swap_k, store_swap_hi=sh,
                                  pair_swap=pair_swap, local_n=local_n,
                                  shard_index=shard_index))
        return dst
    if amps.device.type != "cuda":
        raise ValueError(f"no fused-run route for device {amps.device}")
    _launch(amps, dst, n, local_n, shard_index, tile_bits, prepared, load_swap_k,
            lh, store_swap_k, sh, pair_swap or (0, 0))
    return dst


#: kernel launches (incremented only where the CUDA kernel is launched)
fused_run.launches = 0


class _LaneRun(torch.autograd.Function):
    """One fused-run pass as a function ``torch.func.vmap`` carries: its
    batching rule moves the lane axis to the front and makes ONE
    lane-batched launch (:func:`fused_run` on the (B, 2, 2^n) batch), as
    ``jax.vmap`` reaches ``pallas_call``'s batching rule. ``call(src,
    out)`` is the pass with its run bound. Out of place: a fresh output."""

    @staticmethod
    def forward(amps, call):
        return call(amps, torch.empty_like(amps))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, amps, call):
        d = in_dims[0]
        x = (amps.expand(info.batch_size, *amps.shape) if d is None
             else amps.movedim(d, 0)).contiguous()
        return call(x, torch.empty_like(x)), 0


def fused_run_lanes(amps: torch.Tensor, **run) -> torch.Tensor:
    """:func:`fused_run` (``run``: its keyword arguments but ``out``) into
    a new tensor; under ``torch.func.vmap`` one launch for every lane."""
    def call(src, out):
        return fused_run(src, out=out, **run)
    return _LaneRun.apply(amps, call)


def _launch(src, dst, n, local_n, shard_index, tile_bits, prepared, lk, lh, sk,
            sh, pair) -> None:
    from .. import _build

    if not (src.is_contiguous() and dst.is_contiguous()):
        raise ValueError("the fused-run kernel takes contiguous states")
    lib = _build.library("fused_gates")
    fn = (lib.quest_fused_run_f32 if src.dtype == torch.float32
          else lib.quest_fused_run_f64)
    table, coeffs = prepared.device_tables(src.device, src.dtype)
    lanes = src.shape[0] if src.dim() == 3 else 1
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = fn(src.data_ptr(), dst.data_ptr(), n, local_n, shard_index, tile_bits,
                 table.data_ptr(), int(table.shape[0]), coeffs.data_ptr(),
                 lk, lh, sk, sh, *pair, prepared.staged, stream, lanes)
    if err != 0:
        msg = lib.quest_cuda_error_string(err).decode()
        raise RuntimeError(f"fused-run kernel launch failed: {msg} ({err})")
    fused_run.launches += 1


def fused_run_plain(amps: torch.Tensor, prepared: PreparedRun, *, n: int,
                    tile_bits: int, load_swap_k: int = 0,
                    load_swap_hi: int | None = None, store_swap_k: int = 0,
                    store_swap_hi: int | None = None,
                    pair_swap: tuple[int, int] | None = None,
                    local_n: int | None = None, shard_index: int = 0) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the same encoded records
    (``prepared.records``: diagonal runs merged), one at a time on the whole
    state (or shard: ``local_n``, ``shard_index`` as
    for :func:`fused_run`) with torch indexing (a kraus op from its terms,
    which the op tuple keeps), and folded swaps as explicit
    ``swap_bit_blocks`` before and after. Roles read the global index,
    partners the shard's own. A (B, 2, 2^n) batch takes the same records
    lane by lane. Returns a new tensor."""
    if amps.dim() == 3:
        return torch.stack([fused_run_plain(
            a, prepared, n=n, tile_bits=tile_bits, load_swap_k=load_swap_k,
            load_swap_hi=load_swap_hi, store_swap_k=store_swap_k,
            store_swap_hi=store_swap_hi, pair_swap=pair_swap, local_n=local_n,
            shard_index=shard_index) for a in amps])
    ln = n if local_n is None else local_n
    x = amps
    if load_swap_k:
        x = swap_bit_blocks(x, n=ln, lo1=tile_bits - load_swap_k,
                            lo2=tile_bits if load_swap_hi is None else load_swap_hi,
                            k=load_swap_k)
    if pair_swap:
        x = swap_bit_blocks(x, n=ln, lo1=pair_swap[0], lo2=pair_swap[1], k=1)
    loc = torch.arange(1 << ln, device=amps.device)
    idx = loc | (int(shard_index) << ln)
    cf = to_device(prepared.coeffs, amps.dtype, amps.device)
    for op, rec in zip(prepared.records, prepared.table.tolist()):
        if op[0] in _KRAUS:
            x = _plain_kraus(x, op, idx, loc)
        else:
            x = _plain_op(x, rec, cf, idx, loc)
    if pair_swap:
        x = swap_bit_blocks(x, n=ln, lo1=pair_swap[0], lo2=pair_swap[1], k=1)
    if store_swap_k:
        x = swap_bit_blocks(x, n=ln, lo1=tile_bits - store_swap_k,
                            lo2=tile_bits if store_swap_hi is None else store_swap_hi,
                            k=store_swap_k)
    return x if x.data_ptr() != amps.data_ptr() else x.clone()


def _bits(mask: int):
    return [q for q in range(mask.bit_length()) if (mask >> q) & 1]


def _plain_op(x, rec, cf, idx, loc):
    kind, a, b, cmask, cval, pmask, off, flags = rec
    N = x.shape[1]
    ok = None if not cmask else (idx & cmask) == cval

    def where_ok(new):
        return new if ok is None else torch.where(ok, new, x)

    if kind == _KIND["matrix"]:
        m00r, m00i, m01r, m01i, m10r, m10i, m11r, m11i = cf[off:off + 8]
        bit = ((idx >> a) & 1).bool()
        sr, si = torch.where(bit, m11r, m00r), torch.where(bit, m11i, m00i)
        if flags & 1:
            return where_ok(torch.stack([x[0] * sr - x[1] * si, x[0] * si + x[1] * sr]))
        pr_, pi_ = x.reshape(2, -1, 2, 1 << a).flip(2).reshape(2, N)
        cr, ci = torch.where(bit, m10r, m01r), torch.where(bit, m10i, m01i)
        return where_ok(torch.stack([
            sr * x[0] - si * x[1] + cr * pr_ - ci * pi_,
            sr * x[1] + si * x[0] + cr * pi_ + ci * pr_]))
    if kind == _KIND["parity"]:
        c, s = cf[off], cf[off + 1]
        par = torch.zeros_like(idx)
        for q in _bits(pmask):
            par ^= (idx >> q) & 1
        fi = torch.where(par.bool(), s, -s)
        return where_ok(torch.stack([x[0] * c - x[1] * fi, x[0] * fi + x[1] * c]))
    if kind == _KIND["swap"]:
        differ = (((idx >> a) ^ (idx >> b)) & 1).bool()
        sel = differ if ok is None else differ & ok
        partner = x[:, loc ^ ((1 << a) | (1 << b))]
        return torch.where(sel, partner, x)
    if kind == _KIND["diagw"]:
        sel = torch.zeros_like(idx)
        for j in range(a):
            sel |= ((idx >> ((b >> (6 * j)) & 63)) & 1) << j
        d = cf[off:off + 2 * (1 << a)].reshape(-1, 2)
        fr, fi = d[sel, 0], d[sel, 1]
        return where_ok(torch.stack([x[0] * fr - x[1] * fi, x[0] * fi + x[1] * fr]))
    if kind == _KIND["lane_u"]:
        w0 = cf[off:off + _LANES * _LANES].reshape(_LANES, _LANES)
        w1 = cf[off + _LANES * _LANES:off + 2 * _LANES * _LANES].reshape(_LANES, _LANES)
        xr, xi = x[0].reshape(-1, _LANES), x[1].reshape(-1, _LANES)
        return torch.stack([xr @ w0 - xi @ w1, xr @ w1 + xi @ w0]).reshape(2, N)
    if kind == _KIND["window"]:
        D = 1 << b
        ur = cf[off:off + D * D].reshape(D, D)
        ui = cf[off + D * D:off + 2 * D * D].reshape(D, D)
        xr, xi = x[0].reshape(-1, D, 1 << a), x[1].reshape(-1, D, 1 << a)
        return torch.stack([ur @ xr - ui @ xi, ur @ xi + ui @ xr]).reshape(2, N)
    raise ValueError(f"unknown op kind code {kind}")


def _plain_kraus(x, op, idx, loc):
    """A kraus op per term, as _ops_body applies it: K on the rows and
    conj(K) on the columns of a copy, accumulated with the term's sign."""
    rows, cols, terms = kraus_parts(op)
    acc = None
    for s, K in terms:
        k = _arr(K).astype(complex)
        kr = to_device(k.real, x.dtype, x.device)
        ki = to_device(k.imag, x.dtype, x.device)
        y = _plain_dense(x, kr, ki, rows, idx, loc)
        y = float(s) * _plain_dense(y, kr, -ki, cols, idx, loc)
        acc = y if acc is None else acc + y
    return acc


def _plain_dense(x, mr, mi, qubits, idx, loc):
    """A d x d complex matrix (mr + i mi) on ``qubits`` of the whole state
    (qubits[j] is bit j of its index): out[i] = sum_delta M[r, r ^ delta]
    x[i ^ flip(delta)], r the bits of i on ``qubits`` (all in the shard:
    ``loc`` addresses the partner)."""
    r = torch.zeros_like(idx)
    for j, q in enumerate(qubits):
        r |= ((idx >> q) & 1) << j
    out_r, out_i = torch.zeros_like(x[0]), torch.zeros_like(x[1])
    for delta in range(1 << len(qubits)):
        flip = sum(1 << q for j, q in enumerate(qubits) if (delta >> j) & 1)
        pr, pi = (x[0], x[1]) if not flip else (x[0][loc ^ flip], x[1][loc ^ flip])
        cr, ci = mr[r, r ^ delta], mi[r, r ^ delta]
        out_r += cr * pr - ci * pi
        out_i += cr * pi + ci * pr
    return torch.stack([out_r, out_i])
