"""State initialisation API (reference QuEST.h:1619-1876, QuEST.c init
family), for state-vector and density registers: every function of
``quest_tpu/state_init.py``.

``setAmps`` and ``setDensityAmps`` write the given slice of the register's
tensor in place (the reference's C semantics; the JAX package, whose
arrays are immutable, builds a new one). Every other function binds a new
tensor. On a sharded register (``registers.Qureg.shards``) each shard is
built on its own device, and ``setAmps`` writes into the shards the slice
covers. ``cloneQureg``, ``initPureState`` and ``setWeightedQureg`` take
registers of any two layouts (one device, or a mesh of any size): the
source is gathered, scattered or re-cut into the target's layout by
device-to-device copies. A density matrix made from a pure state
(``initPureState``) is built shard by shard from the whole state vector,
gathered onto each shard's device (2^n amplitudes, not 4^n).
"""

from __future__ import annotations

import numpy as np
import torch

from . import validation as V
from .ops import init as I
from .registers import Qureg

__all__ = [
    "initBlankState", "initZeroState", "initPlusState", "initClassicalState",
    "initPureState", "initDebugState", "initStateFromAmps", "setAmps",
    "setDensityAmps", "cloneQureg", "setWeightedQureg", "getNumQubits",
    "getNumAmps",
]


def _devices(qureg: Qureg) -> list:
    return [s.device for s in qureg.shards]


def initBlankState(qureg: Qureg) -> None:
    """All-zero amplitudes (unnormalised) (QuEST.h:1619)."""
    if qureg.shards is not None:
        qureg.put_shards(I.shards_blank(qureg.num_amps_total, qureg.dtype,
                                        _devices(qureg)))
    else:
        qureg.put(I.init_blank(qureg.num_amps_total, qureg.dtype, qureg.device))
    if qureg.qasm_log:
        qureg.qasm_log.record_comment(
            "Here, the register was initialised to an unphysical all-zero-amplitudes 'state'.")


def initZeroState(qureg: Qureg) -> None:
    """Set the register to |0...0> (QuEST.h:194)."""
    if qureg.shards is not None:
        qureg.put_shards(I.shards_classical(qureg.num_amps_total, qureg.dtype,
                                            _devices(qureg), 0))
        amps = None
    elif qureg.is_density_matrix:
        amps = I.density_init_classical(qureg.num_amps_total, qureg.dtype,
                                        qureg.device, 0)
    else:
        amps = I.init_classical(qureg.num_amps_total, qureg.dtype, qureg.device, 0)
    if amps is not None:
        qureg.put(amps)
    if qureg.qasm_log:
        qureg.qasm_log.record_init_zero()


def initPlusState(qureg: Qureg) -> None:
    """Set the register to |+>^n, every amplitude equal (QuEST.h:195)."""
    if qureg.shards is not None:
        qureg.put_shards(I.shards_plus(qureg.num_amps_total, qureg.dtype,
                                       _devices(qureg)))
    elif qureg.is_density_matrix:
        qureg.put(I.density_init_plus(qureg.num_amps_total, qureg.dtype, qureg.device))
    else:
        qureg.put(I.init_plus(qureg.num_amps_total, qureg.dtype, qureg.device))
    if qureg.qasm_log:
        qureg.qasm_log.record_init_plus()


def initClassicalState(qureg: Qureg, state_index: int) -> None:
    """Set the register to computational basis state |stateInd> (QuEST.h:196)."""
    V.validate_state_index(qureg, state_index, "initClassicalState")
    if qureg.shards is not None:
        # a density matrix's |s><s| is the one at flat index s (2^n + 1)
        flat = state_index * ((1 << qureg.num_qubits_represented) + 1
                              if qureg.is_density_matrix else 1)
        qureg.put_shards(I.shards_classical(qureg.num_amps_total, qureg.dtype,
                                            _devices(qureg), flat))
    elif qureg.is_density_matrix:
        qureg.put(I.density_init_classical(qureg.num_amps_total, qureg.dtype,
                                           qureg.device, state_index))
    else:
        qureg.put(I.init_classical(qureg.num_amps_total, qureg.dtype, qureg.device,
                                   state_index))
    if qureg.qasm_log:
        qureg.qasm_log.record_init_classical(state_index)


def initPureState(qureg: Qureg, pure: Qureg) -> None:
    """Copy a pure state in; density targets get rho = |psi><psi|
    (QuEST.h:1689; densmatr_initPureState)."""
    func = "initPureState"
    V.validate_second_qureg_state_vec(pure, func)
    V.validate_matching_qureg_dims(qureg, pure, func)
    if qureg.is_density_matrix:
        whole = _whole(pure, qureg.device, qureg.dtype)
        if qureg.shards is not None:
            qureg.put_shards(I.density_shards_from_pure(whole, _devices(qureg), qureg.dtype))
        else:
            qureg.put(I.density_from_pure(whole))
    else:
        _put_pieces(qureg, _in_layout(pure, _pieces(qureg), qureg.dtype))
    if qureg.qasm_log:
        qureg.qasm_log.record_comment(
            "Here, the register was initialised to an undisclosed given pure state.")


def initDebugState(qureg: Qureg) -> None:
    """amp_i = (2i + (2i+1) i)/10: the deterministic test fixture (QuEST.h:1721)."""
    if qureg.shards is not None:
        qureg.put_shards(I.shards_debug(qureg.num_amps_total, qureg.dtype,
                                        _devices(qureg)))
    else:
        qureg.put(I.init_debug(qureg.num_amps_total, qureg.dtype, qureg.device))
    if qureg.qasm_log:
        qureg.qasm_log.record_comment("initDebugState")


def initStateFromAmps(qureg: Qureg, reals, imags) -> None:
    """Full overwrite from host arrays (QuEST.h:1748)."""
    func = "initStateFromAmps"
    reals = np.asarray(reals).reshape(-1)
    imags = np.asarray(imags).reshape(-1)
    V._assert(reals.size == qureg.num_amps_total and imags.size == qureg.num_amps_total,
              "Invalid number of amplitudes. Must match the register size.", func)
    if qureg.shards is not None:
        c = qureg.num_amps_total // len(qureg.shards)
        qureg.put_shards(
            torch.as_tensor(np.stack([reals[r * c:(r + 1) * c], imags[r * c:(r + 1) * c]]),
                            dtype=qureg.dtype, device=d).clone()
            for r, d in enumerate(_devices(qureg)))
    else:
        qureg.put(torch.as_tensor(np.stack([reals, imags]), dtype=qureg.dtype,
                                  device=qureg.device).clone())
    if qureg.qasm_log:
        qureg.qasm_log.record_comment(
            "Here, the register was initialised to an undisclosed given pure state.")


def _write_slice(qureg: Qureg, start: int, reals, imags, num_amps: int) -> None:
    vals = np.stack([np.asarray(reals).reshape(-1)[:num_amps],
                     np.asarray(imags).reshape(-1)[:num_amps]])
    if qureg.shards is None:
        qureg.amps[:, start:start + num_amps] = torch.as_tensor(
            vals, dtype=qureg.dtype, device=qureg.device)
        return
    c = qureg.num_amps_total // len(qureg.shards)
    for r, shard in enumerate(qureg.shards):
        lo, hi = max(start, r * c), min(start + num_amps, (r + 1) * c)
        if lo < hi:
            shard[:, lo - r * c:hi - r * c] = torch.as_tensor(
                vals[:, lo - start:hi - start], dtype=qureg.dtype, device=shard.device)


def setAmps(qureg: Qureg, start_ind: int, reals, imags, num_amps: int) -> None:
    """Overwrite a contiguous slice, in place (QuEST.h:1797)."""
    func = "setAmps"
    V.validate_state_vec(qureg, func)
    V.validate_num_amps(qureg, start_ind, num_amps, func)
    _write_slice(qureg, start_ind, reals, imags, num_amps)
    if qureg.qasm_log:
        qureg.qasm_log.record_comment(
            "Here, some amplitudes in the statevector were manually edited.")


def setDensityAmps(qureg: Qureg, start_row: int, start_col: int, reals, imags,
                   num_amps: int) -> None:
    """Overwrite density elements column-wise from (start_row, start_col),
    in place (QuEST.h:1829). Flat order runs down rows then across columns,
    the row-bits-low layout."""
    func = "setDensityAmps"
    V.validate_density_matr(qureg, func)
    dim = 1 << qureg.num_qubits_represented
    start = start_col * dim + start_row
    V._assert(0 <= start_row < dim and 0 <= start_col < dim,
              "Invalid amplitude index. Note amplitudes are zero indexed.", func)
    V._assert(num_amps >= 0 and start + num_amps <= qureg.num_amps_total,
              "Invalid number of amplitudes. Must be >=0 and fit within the register.", func)
    _write_slice(qureg, start, reals, imags, num_amps)
    if qureg.qasm_log:
        qureg.qasm_log.record_comment(
            "Here, some amplitudes in the density matrix were manually edited.")


def cloneQureg(target: Qureg, source: Qureg) -> None:
    """Overwrite target's state with a copy of source's (QuEST.h:1876)."""
    func = "cloneQureg"
    V.validate_matching_qureg_types(target, source, func)
    V.validate_matching_qureg_dims(target, source, func)
    _put_pieces(target, _in_layout(source, _pieces(target), target.dtype))


def _pieces(qureg: Qureg) -> list:
    """The register's amplitude tensors: its shards, or its one tensor."""
    return [qureg.amps] if qureg.shards is None else list(qureg.shards)


def _in_layout(source: Qureg, like: list, dtype: torch.dtype) -> list:
    """A copy of ``source``'s amplitudes laid out as the tensors ``like``
    (one tensor or a register's shards, each a contiguous block of the flat
    index): new tensors of ``dtype`` on ``like``'s devices, each filled by
    device-to-device ``copy_`` of the source blocks it overlaps. Nothing
    goes through host memory."""
    return _recut(_pieces(source), like, dtype)


def _whole(source: Qureg, device, dtype: torch.dtype) -> torch.Tensor:
    """``source``'s amplitudes as one new tensor of ``dtype`` on ``device``,
    gathered from its shards by device-to-device copies."""
    like = torch.empty((2, source.num_amps_total), device=device)
    return _recut(_pieces(source), [like], dtype)[0]


def _recut(src: list, like: list, dtype: torch.dtype) -> list:
    """:func:`_in_layout` of the tensors ``src`` (each a contiguous block of
    one flat index, in order)."""
    cs, ct = src[0].shape[1], like[0].shape[1]
    out = []
    for j, t in enumerate(like):
        dst = torch.empty(t.shape, dtype=dtype, device=t.device)
        for i, s in enumerate(src):
            lo, hi = max(i * cs, j * ct), min((i + 1) * cs, (j + 1) * ct)
            if lo < hi:
                dst[:, lo - j * ct:hi - j * ct].copy_(s[:, lo - i * cs:hi - i * cs])
        out.append(dst)
    return out


def _put_pieces(qureg: Qureg, pieces: list) -> None:
    if qureg.shards is None:
        qureg.put(pieces[0])
    else:
        qureg.put_shards(pieces)


def setWeightedQureg(fac1: complex, qureg1: Qureg, fac2: complex, qureg2: Qureg,
                     fac_out: complex, out: Qureg) -> None:
    """out = fac1 q1 + fac2 q2 + facOut out (QuEST.h:5688). Inputs of
    another layout than ``out`` are first brought to ``out``'s
    (``_in_layout``); the sum then runs per shard."""
    func = "setWeightedQureg"
    V.validate_matching_qureg_types(qureg1, qureg2, func)
    V.validate_matching_qureg_types(qureg1, out, func)
    V.validate_matching_qureg_dims(qureg1, qureg2, func)
    V.validate_matching_qureg_dims(qureg1, out, func)
    if any(q.shards is not None for q in (qureg1, qureg2, out)):
        like = _pieces(out)
        a, b = (_in_layout(q, like, out.dtype) for q in (qureg1, qureg2))
        _put_pieces(out, [I.weighted_sum(fac1, x, fac2, y, fac_out, o)
                          for x, y, o in zip(a, b, like)])
        return
    out.put(I.weighted_sum(fac1, qureg1.amps.to(out.dtype), fac2,
                           qureg2.amps.to(out.dtype), fac_out, out.amps))


def getNumQubits(qureg: Qureg) -> int:
    """Number of qubits the register represents (QuEST.h:134)."""
    return qureg.num_qubits_represented


def getNumAmps(qureg: Qureg) -> int:
    """Number of statevector amplitudes, 2^numQubits (QuEST.h:135)."""
    V.validate_state_vec(qureg, "getNumAmps")
    return qureg.num_amps_total
