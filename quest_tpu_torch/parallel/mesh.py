"""Mesh and shard bookkeeping (``quest_tpu/parallel/mesh.py``).

A mesh is the env's tuple of devices (``environment.QuESTEnv.devices``).
The state (2, 2^n) is block-sharded over its D = 2^d devices, exactly the
reference's rank partition (``numAmpsPerChunk = 2^n / numRanks``,
QuEST_cpu.c:1296-1319): shard r holds flat indices [r C, (r+1) C),
C = 2^(n-d). Qubit q is **local** iff q < n - d (its amplitude pairs lie in
one shard), and a **sharded** qubit q >= n - d is bit q - (n - d) of the
shard index.
"""

from __future__ import annotations


def local_qubit_count(n: int, mesh) -> int:
    """Number of low qubits entirely local to each shard."""
    if mesh is None or len(mesh) == 1:
        return n
    return n - (len(mesh) - 1).bit_length()


def shard_info(n: int, mesh) -> tuple[int, int]:
    """(num_local_qubits, num_shard_qubits)."""
    nl = local_qubit_count(n, mesh)
    return nl, n - nl
