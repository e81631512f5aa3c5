"""Decoherence channels on density matrices (reference QuEST.h:3976-4219,
5412-5630; kernels in ops.density).

Every channel is either a factor diagonal (dephasing) or one superoperator
on qubits (T, T+n) of the flattened state, routed by
``ops.density.apply_channel``. The Kraus operators of the built-in channels
come from the canonical table ``channels.py``. ``mixDensityMatrix`` is a
weighted sum of two registers (``ops.init.weighted_sum``), the second
re-cut into the first's layout where the two are cut differently. On a
sharded register the channels run through its per-gate engine over shards
(``ops.density.apply_channel_shards``); dephasing is a diagonal there too,
with no communication.
"""

from __future__ import annotations

from . import validation as V
from .ops import cplx
from .ops import density as DN
from .ops import init as I
from .parallel.scheduler import engine as _engine
from .registers import Qureg
from .state_init import _in_layout, _pieces, _put_pieces

__all__ = [
    "mixDephasing", "mixTwoQubitDephasing", "mixDepolarising", "mixDamping",
    "mixTwoQubitDepolarising", "mixPauli", "mixKrausMap",
    "mixTwoQubitKrausMap", "mixMultiQubitKrausMap", "mixNonTPKrausMap",
    "mixNonTPTwoQubitKrausMap", "mixNonTPMultiQubitKrausMap", "mixDensityMatrix",
]


def _record(qureg, text):
    if qureg.qasm_log is not None:
        qureg.qasm_log.record_comment(text)


def _channel(qureg, superop, targets):
    """The channel on the register; the kernel route writes into its spare
    buffer, which then becomes the state, as a fused run with a folded swap
    does (so a compiled replay leaves no state in its graph's pool). A
    sharded register: each shard's spare, where the kernel route runs."""
    if qureg.shards is not None:
        new, in_spares = DN.apply_channel_shards(
            qureg.shards, superop, n=qureg.num_qubits_represented, targets=tuple(targets),
            eng=_engine(qureg), spares=qureg.shard_spare_buffers())
        if in_spares:
            qureg.swap_shard_spares()
        else:
            qureg.put_shards(new)
        return
    out = DN.apply_channel(qureg.amps, superop, n=qureg.num_qubits_represented,
                           targets=tuple(targets), out=qureg.spare_buffer())
    if out is qureg.spare:
        qureg.swap_spare()
    else:
        qureg.put(out)


def mixDephasing(qureg: Qureg, target: int, prob: float) -> None:
    """rho -> (1-p) rho + p Z rho Z (QuEST.h:3976)."""
    func = "mixDephasing"
    V.validate_density_matr(qureg, func)
    V.validate_target(qureg, target, func)
    V.validate_one_qubit_dephase_prob(prob, func)
    n = qureg.num_qubits_represented
    if qureg.shards is not None:
        _dephase_shards(qureg, DN.dephase_factors_1q(prob), (target, target + n))
    else:
        qureg.put(DN.apply_dephasing(qureg.amps, prob, n=n, target=target))
    _record(qureg, f"mixDephasing({prob:g}) on q[{target}]")


def mixTwoQubitDephasing(qureg: Qureg, q1: int, q2: int, prob: float) -> None:
    """(QuEST.h:4008)."""
    func = "mixTwoQubitDephasing"
    V.validate_density_matr(qureg, func)
    V.validate_unique_targets(qureg, q1, q2, func)
    V.validate_two_qubit_dephase_prob(prob, func)
    n = qureg.num_qubits_represented
    if qureg.shards is not None:
        _dephase_shards(qureg, DN.dephase_factors_2q(prob), (q1, q2, q1 + n, q2 + n))
    else:
        qureg.put(DN.apply_two_qubit_dephasing(qureg.amps, prob, n=n, q1=q1, q2=q2))
    _record(qureg, f"mixTwoQubitDephasing({prob:g}) on q[{q1}],q[{q2}]")


def _dephase_shards(qureg, factors, qubits) -> None:
    """A dephasing diagonal on a sharded register: the engine over shards'
    diagonal, the sharded qubits' bits read from the shard index."""
    d = cplx.from_complex(factors, qureg.dtype, qureg.device)
    qureg.put_shards(_engine(qureg).apply_diagonal(
        qureg.shards, d, n=qureg.num_qubits_in_state_vec, targets=tuple(qubits)))


def mixDepolarising(qureg: Qureg, target: int, prob: float) -> None:
    """rho -> (1-p) rho + p/3 (X rho X + Y rho Y + Z rho Z) (QuEST.h:4051)."""
    func = "mixDepolarising"
    V.validate_density_matr(qureg, func)
    V.validate_target(qureg, target, func)
    V.validate_one_qubit_depol_prob(prob, func)
    _channel(qureg, DN.kraus_superoperator(DN.depolarising_kraus(prob)), (target,))
    _record(qureg, f"mixDepolarising({prob:g}) on q[{target}]")


def mixDamping(qureg: Qureg, target: int, prob: float) -> None:
    """Amplitude damping toward |0> (QuEST.h:4089)."""
    func = "mixDamping"
    V.validate_density_matr(qureg, func)
    V.validate_target(qureg, target, func)
    V.validate_one_qubit_damping_prob(prob, func)
    _channel(qureg, DN.kraus_superoperator(DN.damping_kraus(prob)), (target,))
    _record(qureg, f"mixDamping({prob:g}) on q[{target}]")


def mixTwoQubitDepolarising(qureg: Qureg, q1: int, q2: int, prob: float) -> None:
    """(QuEST.h:4156): one 16x16 superoperator."""
    func = "mixTwoQubitDepolarising"
    V.validate_density_matr(qureg, func)
    V.validate_unique_targets(qureg, q1, q2, func)
    V.validate_two_qubit_depol_prob(prob, func)
    _channel(qureg, DN.two_qubit_depolarising_superop(prob), (q1, q2))
    _record(qureg, f"mixTwoQubitDepolarising({prob:g}) on q[{q1}],q[{q2}]")


def mixPauli(qureg: Qureg, target: int, px: float, py: float, pz: float) -> None:
    """General Pauli channel (QuEST.h:4197; 4-op Kraus, QuEST_common.c:740-760)."""
    func = "mixPauli"
    V.validate_density_matr(qureg, func)
    V.validate_target(qureg, target, func)
    V.validate_pauli_probs(px, py, pz, func)
    _channel(qureg, DN.kraus_superoperator(DN.pauli_kraus(px, py, pz)), (target,))
    _record(qureg, f"mixPauli({px:g},{py:g},{pz:g}) on q[{target}]")


def mixDensityMatrix(combine: Qureg, prob: float, other: Qureg) -> None:
    """combine = (1-p) combine + p other (QuEST.h:4219)."""
    func = "mixDensityMatrix"
    V.validate_density_matr(combine, func)
    V.validate_density_matr(other, func)
    V.validate_matching_qureg_dims(combine, other, func)
    V.validate_probability(prob, 1.0, func)
    mine = _pieces(combine)
    theirs = (_in_layout(other, mine, combine.dtype)
              if combine.shards is not None or other.shards is not None
              else [other.amps.to(combine.device, combine.dtype)])
    _put_pieces(combine, [I.weighted_sum(1 - prob, a, prob, b, 0.0, a)
                          for a, b in zip(mine, theirs)])
    _record(combine, f"mixDensityMatrix({prob:g})")


def _mix_kraus(qureg, targets, ops, func, check_cptp):
    V.validate_density_matr(qureg, func)
    V.validate_multi_targets(qureg, targets, func)
    V.validate_kraus_ops(ops, len(targets), qureg.eps, func, check_cptp=check_cptp)
    _channel(qureg, DN.kraus_superoperator(ops), targets)
    _record(qureg, f"{func} on qubits {list(targets)}")


def mixKrausMap(qureg: Qureg, target: int, ops) -> None:
    """1-qubit Kraus map of up to 4 operators (QuEST.h:5412)."""
    _mix_kraus(qureg, (target,), ops, "mixKrausMap", True)


def mixTwoQubitKrausMap(qureg: Qureg, q1: int, q2: int, ops) -> None:
    """(QuEST.h:5453); matrix bit order: q1 is the least-significant bit."""
    _mix_kraus(qureg, (q1, q2), ops, "mixTwoQubitKrausMap", True)


def mixMultiQubitKrausMap(qureg: Qureg, targets, ops) -> None:
    """(QuEST.h:5505)."""
    _mix_kraus(qureg, tuple(targets), ops, "mixMultiQubitKrausMap", True)


def mixNonTPKrausMap(qureg: Qureg, target: int, ops) -> None:
    """Non-trace-preserving variant (QuEST.h:5540)."""
    _mix_kraus(qureg, (target,), ops, "mixNonTPKrausMap", False)


def mixNonTPTwoQubitKrausMap(qureg: Qureg, q1: int, q2: int, ops) -> None:
    """Two-qubit Kraus map WITHOUT completeness validation (QuEST.h:270)."""
    _mix_kraus(qureg, (q1, q2), ops, "mixNonTPTwoQubitKrausMap", False)


def mixNonTPMultiQubitKrausMap(qureg: Qureg, targets, ops) -> None:
    """Kraus map on many targets WITHOUT completeness validation (QuEST.h:271)."""
    _mix_kraus(qureg, tuple(targets), ops, "mixNonTPMultiQubitKrausMap", False)
