"""The per-gate engine on a sharded register: the reference's dispatch
policy over the :mod:`.exchange` routines (``quest_tpu/parallel/
scheduler.py``, its immediate mode).

QuEST_cpu_distributed.c dispatches so:
  - a 1-qubit dense gate on a sharded target: pair exchange (:870-905);
  - a dense gate with several targets, some sharded: swap each sharded
    target into the lowest local qubit that is not a target
    (swapQubitAmps), a control held there moving with the swap, apply
    locally, swap back (:1526-1568);
  - X class: a whole-shard exchange (:1109-1152);
  - diagonal and phase gates: no communication.
Sharded controls are a shard-index predicate: they travel only when a
relocation swap moves them. After every gate the register is back in the
identity layout. The JAX package reaches the same per-gate policy through
GSPMD or through this mode of its scheduler; its deferred relocations,
journal and ``plan_circuit`` comm model are later work.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .. import validation as V
from . import exchange as X
from .mesh import local_qubit_count


def _stats() -> dict:
    return {"local": 0, "pair_exchanges": 0, "relocation_swaps": 0,
            "rank_permutes": 0, "comm_free": 0}


@dataclass
class DistributedScheduler:
    """Gate dispatcher over the shards of a register; ``stats`` counts the
    plan's local gates, pair exchanges, relocation swaps, rank permutes
    and communication-free ops, as the JAX package's."""
    stats: dict = field(default_factory=_stats)

    def _relocate(self, shards, n, nl, targets):
        """Swap each sharded target into the lowest local qubit that is not
        a target (QuEST_cpu_distributed.c:1526-1568); a control that held
        that slot moves with the swap, to the target's old position, where
        it resolves from the shard index. Returns (shards, the swaps as
        (sharded, local) pairs, {old position: new position})."""
        if len(targets) > nl:
            # the reference's only limit (validateMultiQubitMatrixFitsInNode,
            # QuEST_validation.c:522-524)
            V.validate_matrix_fits_in_node(nl, len(targets), "applyMatrix")
        free = [p for p in range(nl) if p not in targets]
        swaps = list(zip([t for t in targets if t >= nl], free))
        moved = {}
        for s, f in swaps:
            self.stats["relocation_swaps"] += 1
            shards = X.dist_swap(shards, n=n, qb1=f, qb2=s)
            moved[s], moved[f] = f, s
        return shards, swaps, moved

    def apply_matrix(self, shards, matrix, *, n, targets, controls=(),
                     control_states=(), conj=False) -> list:
        nl = local_qubit_count(n, shards)
        targets, controls = tuple(targets), tuple(controls)
        if not any(t >= nl for t in targets):
            self.stats["local"] += 1
            return X.dist_apply_local_matrix(
                shards, matrix, n=n, targets=targets, controls=controls,
                control_states=tuple(control_states), conj=conj)
        if len(targets) == 1:
            self.stats["pair_exchanges"] += 1
            return X.dist_apply_matrix1(
                shards, matrix, n=n, target=targets[0], controls=controls,
                control_states=tuple(control_states), conj=conj)
        shards, swaps, moved = self._relocate(shards, n, nl, targets)
        self.stats["local"] += 1
        shards = X.dist_apply_local_matrix(
            shards, matrix, n=n, targets=tuple(moved.get(t, t) for t in targets),
            controls=tuple(moved.get(c, c) for c in controls),
            control_states=tuple(control_states), conj=conj)
        for s, f in swaps:
            self.stats["relocation_swaps"] += 1
            shards = X.dist_swap(shards, n=n, qb1=f, qb2=s)
        return shards

    def apply_x(self, shards, *, n, targets, controls=(), control_states=()) -> list:
        nl = local_qubit_count(n, shards)
        self.stats["rank_permutes" if any(t >= nl for t in targets) else "local"] += 1
        return X.dist_apply_x(shards, n=n, targets=tuple(targets),
                              controls=tuple(controls),
                              control_states=tuple(control_states))

    def apply_swap(self, shards, *, n, qb1, qb2) -> list:
        nl = local_qubit_count(n, shards)
        if max(qb1, qb2) < nl:
            self.stats["local"] += 1
        elif min(qb1, qb2) >= nl:
            self.stats["rank_permutes"] += 1
        else:
            self.stats["relocation_swaps"] += 1
        return X.dist_swap(shards, n=n, qb1=qb1, qb2=qb2)

    def apply_diagonal(self, shards, diag, *, n, targets, controls=(),
                       control_states=(), conj=False) -> list:
        self.stats["comm_free"] += 1
        return X.dist_apply_diag_phase(
            shards, diag, n=n, targets=tuple(targets), controls=tuple(controls),
            control_states=tuple(control_states), conj=conj)

    def apply_parity_phase(self, shards, theta, *, n, qubits, controls=(),
                           control_states=(), conj=False) -> list:
        self.stats["comm_free"] += 1
        return X.dist_apply_parity_phase(
            shards, theta, n=n, qubits=tuple(qubits), controls=tuple(controls),
            control_states=tuple(control_states), conj=conj)


def engine(qureg) -> DistributedScheduler:
    """The scheduler that runs a sharded register's gates: its env's, or a
    fresh one for a register without an env (a compiled replay's bare
    register around a caller's shards, ``Circuit.compiled()(shards)``)."""
    if qureg.env is None:
        return DistributedScheduler()
    if qureg.env.engine is None:
        qureg.env.engine = DistributedScheduler()
    return qureg.env.engine
