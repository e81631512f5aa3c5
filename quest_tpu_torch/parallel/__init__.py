"""The sharded state vector: the counterpart of ``quest_tpu/parallel``.

One process drives every shard (``environment``): a register on a mesh of
D = 2^d devices holds D shard tensors (``registers.Qureg.shards``), and
the reference's distributed protocol (QuEST_cpu_distributed.c) runs as
plain functions over the list of shards whose every exchange is a
device-to-device ``copy_`` between shard tensors (:mod:`.exchange`, each
collective sliceable into a comm pipeline). A sharded register's gates
run through the env's per-gate engine, the reference's immediate policy,
or, inside ``explicit_mesh(env.devices)``, through the explicit
scheduler's deferred layouts, batched relocations and collective
reconciliation, counted in chunk units (:mod:`.scheduler`;
``plan_circuit`` plans a Circuit on meta tensors). Fused gate runs
execute per shard in the fused-run kernel (``fusion._apply_pallas_sharded``).
"""

from .mesh import local_qubit_count, shard_bit_link, shard_info, slice_chip_bits  # noqa: F401
from .exchange import (  # noqa: F401
    comm_pipeline_dcn_default, comm_pipeline_default, dist_apply_diag_phase,
    dist_apply_local_matrix, dist_apply_matrix1, dist_apply_parity_phase, dist_apply_x,
    dist_permute_bits, dist_swap, effective_comm_pipeline, permute_collective_stats,
    resolve_pipeline, resolve_pipeline_dcn,
)
from .scheduler import (  # noqa: F401
    DistributedScheduler, active, comm_chunks, explicit_mesh,
    plan_circuit,
)
