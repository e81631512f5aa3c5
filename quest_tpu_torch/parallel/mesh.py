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


def slice_chip_bits(mesh, num_slices: int) -> int:
    """Number of intra-slice (ICI) shard bits of a slice-major topology:
    the shard index's low bits address chips within a slice, its top
    log2(num_slices) bits cross slices (DCN). A slice count that does not
    split the mesh into equal power-of-two slices raises ValueError."""
    ns = max(int(num_slices), 1)
    if ns & (ns - 1):
        raise ValueError(
            f"num_slices must be a power of two (got {ns}): slice-major "
            f"device order splits the shard bits at a bit boundary")
    size = 1 if mesh is None else len(mesh)
    if ns > size or size % ns:
        raise ValueError(
            f"num_slices={ns} does not partition the {size}-device mesh "
            f"into equal power-of-two slices")
    return ((size // ns) - 1).bit_length()


def shard_bit_link(n: int, mesh, num_slices: int, qubit: int) -> str | None:
    """Which interconnect a comm op on sharded ``qubit`` rides: 'ici' (the
    low shard bits, within a slice) or 'dcn' (the top log2(num_slices)
    shard bits, across slices); None for a local qubit."""
    nl = local_qubit_count(n, mesh)
    if qubit < nl:
        return None
    return "ici" if (qubit - nl) < slice_chip_bits(mesh, num_slices) else "dcn"
