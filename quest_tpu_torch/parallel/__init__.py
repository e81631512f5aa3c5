"""The sharded state vector: the counterpart of ``quest_tpu/parallel``.

One process drives every shard (``environment``): a register on a mesh of
D = 2^d devices holds D shard tensors (``registers.Qureg.shards``), and
the reference's distributed protocol (QuEST_cpu_distributed.c) runs as
plain functions over the list of shards whose every exchange is a
device-to-device ``copy_`` between shard tensors (:mod:`.exchange`). The
per-gate engine on a sharded register is the reference's immediate
dispatch policy (:mod:`.scheduler`); fused gate runs execute per shard in
the fused-run kernel (``fusion._apply_pallas_sharded``).
"""

from .mesh import local_qubit_count, shard_info  # noqa: F401
from .exchange import (  # noqa: F401
    dist_apply_diag_phase, dist_apply_local_matrix, dist_apply_matrix1,
    dist_apply_parity_phase, dist_apply_x, dist_permute_bits, dist_swap,
    permute_collective_stats,
)
from .scheduler import DistributedScheduler  # noqa: F401
