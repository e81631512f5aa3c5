"""Checkpoints: durable snapshots of a register and of its env's RNG
(``quest_tpu/checkpoint.py``), in the JAX package's on-disk format, so
that either package loads the other's snapshots.

- :func:`saveQureg` / :func:`loadQureg` -- a snapshot is a directory of
  one ``amps.shard_{start:016x}.npz`` per shard of the register (members
  ``amps``, the planar ``(2, chunk)`` payload in the register's dtype,
  ``start`` and ``stop``, laid out as ``np.savez_compressed`` writes them;
  the DEFLATE streams are compressed in parallel pieces, :func:`_write_npz`)
  and a ``qureg.json`` index (format 2) naming each shard file with its
  flat range and the CRC32 of its raw payload bytes, the register's structure,
  the env's seeds and the MT19937 state of its RNG. The shards are the
  register's virtual shards (``registers.Qureg.shards``; one, unsharded),
  copied from the card one at a time, never gathered. A load re-cuts the
  snapshot to the destination env: one device, or its D shards. Format-1
  snapshots (one ``amps.npz``) still load.
- :func:`verify_snapshot` -- the same checks as a load, without creating a
  register.
- :func:`writeStateToCSV` -- the reference's ``reportState`` file
  (``state_rank_0.csv``, QuEST_common.c:219-231).

Write protocol (a partial save never loads): the old index is removed
first, each shard lands by an atomic ``os.replace``, and the index is
written last, also by rename. Shard writes pass through the
``checkpoint.write`` fault site (``resilience.guard.checkpoint_write``).

Loads fail closed: every shard is read, shape-checked and CRC-checked
before the register is created or the env's RNG is touched; a CRC
mismatch raises :class:`~.resilience.errors.QuESTChecksumError` naming the
shard, any other defect a :class:`~.validation.QuESTError`.

Each save, verification and load observes its steps in seconds on the
telemetry histograms ``checkpoint_save_seconds{phase=copy|crc|write|rename}``
(card to host, CRC32, compress and write, rename),
``checkpoint_verify_seconds{phase=read|crc}`` and
``checkpoint_load_seconds{phase=read|crc|place}`` (read and decompress,
CRC32, host to device).

The port runs one process, so the JAX package's exchange of the shard
index between processes (``process_allgather``) is not ported: it waits
for the multi-process layer (ROADMAP A, item 9.4).
"""

from __future__ import annotations

import io
import json
import os
import struct
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import telemetry
from .environment import QuESTEnv
from .qasm import QASMLogger
from .registers import Qureg, sharded_over
from .validation import QuESTError

__all__ = ["saveQureg", "loadQureg", "verify_snapshot", "writeStateToCSV",
           "saveSeeds", "loadSeeds"]

_META_NAME = "qureg.json"
_AMPS_NAME = "amps.npz"  # the format-1 payload
#: the index keys every format carries
_META_KEYS = ("num_qubits_represented", "is_density_matrix", "dtype", "num_amps_total")

#: bytes of payload compressed by one worker: the DEFLATE stream is cut
#: into independent pieces of this size, each ending on a byte boundary
_DEFLATE_PIECE = 1 << 23

_NP_DTYPE = {torch.float32: "float32", torch.float64: "float64"}
_TORCH_DTYPE = {v: k for k, v in _NP_DTYPE.items()}


def _pieces(qureg: Qureg) -> list:
    """[(start, stop, tensor)]: the register's shards by flat range."""
    if qureg.amps is None and qureg.shards is None:
        raise QuESTError("Invalid Qureg. The register has been destroyed.", "saveQureg")
    pieces = [qureg.amps] if qureg.shards is None else list(qureg.shards)
    c = qureg.num_amps_total // len(pieces)
    return [(r * c, (r + 1) * c, t) for r, t in enumerate(pieces)]


def _host(t: torch.Tensor) -> np.ndarray:
    """A contiguous host copy of a shard (never a view of a live CPU
    buffer)."""
    return t.detach().to("cpu", copy=True).contiguous().numpy()


def _timed(op: str, phase: str, t0: float) -> float:
    t1 = time.perf_counter()
    telemetry.observe(f"checkpoint_{op}_seconds", t1 - t0, phase=phase)
    return t1


def _npy_bytes(a: np.ndarray) -> tuple:
    """(header, payload) of ``a`` as a ``.npy`` file: the version-1.0
    header ``np.save`` writes, then the raw C-order bytes."""
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(buf, np.lib.format.header_data_from_array_1_0(a))
    return buf.getvalue(), memoryview(np.ascontiguousarray(a)).cast("B")


def _deflate(piece) -> bytes:
    c = zlib.compressobj(6, zlib.DEFLATED, -15)  # np.savez_compressed's level
    return c.compress(piece) + c.flush(zlib.Z_SYNC_FLUSH)


def _write_npz(path: str, members: dict) -> None:
    """Write ``members`` (name -> array) as ``np.savez_compressed`` lays them
    out -- a zip of DEFLATE-compressed ``<name>.npy`` members with zip64
    sizes -- but with each member's DEFLATE stream made of independent
    pieces compressed in parallel, each closed by a sync flush (an empty
    stored block, byte-aligned) and the stream by an empty final block: one
    valid stream that ``np.load`` (and so either package) reads. One zlib
    stream compresses a register's payload at ~20 MB/s (PERF.md), the
    pieces at that rate times the host's cores."""
    dos_time, dos_date = 0, (1 << 5) | 1  # 1980-01-01 00:00
    central = []
    with open(path, "wb") as f, ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        for name, a in members.items():
            header, data = _npy_bytes(np.asarray(a))
            crc = zlib.crc32(data, zlib.crc32(header))
            usize = len(header) + len(data)
            fname = f"{name}.npy".encode()
            offset = f.tell()
            local = struct.pack("<IHHHHHIIIHH", 0x04034B50, 45, 0, 8, dos_time, dos_date,
                                crc, 0xFFFFFFFF, 0xFFFFFFFF, len(fname), 20)
            f.write(local + fname + struct.pack("<HHQQ", 1, 16, usize, 0))
            pieces = [header] + [data[i:i + _DEFLATE_PIECE]
                                 for i in range(0, len(data), _DEFLATE_PIECE)]
            csize = 0
            for out in pool.map(_deflate, pieces):
                f.write(out)
                csize += len(out)
            f.write(b"\x03\x00")  # the final, empty block
            csize += 2
            end = f.tell()
            f.seek(offset + 30 + len(fname) + 12)
            f.write(struct.pack("<Q", csize))  # the zip64 extra's compressed size
            f.seek(end)
            central.append((fname, crc, usize, csize, offset))
        cd_start = f.tell()
        for fname, crc, usize, csize, offset in central:
            f.write(struct.pack("<IHHHHHHIIIHHHHHII", 0x02014B50, 45, 45, 0, 8, dos_time,
                                dos_date, crc, 0xFFFFFFFF, 0xFFFFFFFF, len(fname), 28, 0,
                                0, 0, 0o600 << 16, 0xFFFFFFFF)
                    + fname + struct.pack("<HHQQQ", 1, 24, usize, csize, offset))
        cd_end = f.tell()
        n = len(central)
        f.write(struct.pack("<IQHHIIQQQQ", 0x06064B50, 44, 45, 45, 0, 0, n, n,
                            cd_end - cd_start, cd_start))
        f.write(struct.pack("<IIQI", 0x07064B50, 0, cd_end, 1))
        f.write(struct.pack("<IHHHHIIH", 0x06054B50, 0, 0, 0xFFFF, 0xFFFF, 0xFFFFFFFF,
                            0xFFFFFFFF, 0))


def saveQureg(qureg: Qureg, directory: str) -> None:
    """Snapshot ``qureg`` (amplitudes, structure, the env's seeds and RNG
    position) into ``directory``, created if needed: one file per shard,
    then the index (see the module docstring)."""
    from .resilience import guard

    pieces = _pieces(qureg)
    os.makedirs(directory, exist_ok=True)
    meta_path = os.path.join(directory, _META_NAME)
    if os.path.exists(meta_path):
        os.unlink(meta_path)  # a crash mid-overwrite must not look loadable
    index = []
    for start, stop, t in pieces:
        fname = f"amps.shard_{start:016x}.npz"
        t0 = time.perf_counter()
        host = _host(t)
        t0 = _timed("save", "copy", t0)
        crc = zlib.crc32(host)
        _timed("save", "crc", t0)

        def _write(fname=fname, host=host, start=start, stop=stop) -> str:
            t0 = time.perf_counter()
            tmp = os.path.join(directory, f"{fname}.0.tmp")
            _write_npz(tmp, {"amps": host, "start": np.int64(start),
                             "stop": np.int64(stop)})
            t0 = _timed("save", "write", t0)
            final = os.path.join(directory, fname)
            os.replace(tmp, final)
            _timed("save", "rename", t0)
            return final

        guard.checkpoint_write(_write)
        index.append({"file": fname, "start": int(start), "stop": int(stop),
                      "crc32": int(crc)})
        del host
    env = qureg.env
    meta = {
        "format": 2,
        "num_qubits_represented": qureg.num_qubits_represented,
        "is_density_matrix": qureg.is_density_matrix,
        "dtype": _NP_DTYPE[qureg.dtype],
        "num_amps_total": qureg.num_amps_total,
        "shards": index,
        "seeds": list(env.seeds) if env is not None else [],
        "rng_state": _rng_state_json(env),
    }
    tmp = os.path.join(directory, _META_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, meta_path)


def _read_shard(directory: str, entry: dict, op: str) -> np.ndarray:
    """One format-2 shard's payload, shape-checked against its index range
    and CRC-checked against its index CRC."""
    from .resilience.errors import QuESTChecksumError

    s, e = entry["start"], entry["stop"]
    t0 = time.perf_counter()
    try:
        with np.load(os.path.join(directory, entry["file"])) as z:
            data = z["amps"]
    except Exception as exc:
        raise QuESTError(f"unreadable checkpoint shard {entry['file']!r}: {exc}") from exc
    t0 = _timed(op, "read", t0)
    if data.shape != (2, e - s):
        raise QuESTError(f"checkpoint shard {entry['file']!r} shape {data.shape} != "
                         f"index range {(2, e - s)}")
    if "crc32" in entry:
        data = np.ascontiguousarray(data)
        crc = zlib.crc32(data)
        _timed(op, "crc", t0)
        if crc != int(entry["crc32"]):
            raise QuESTChecksumError(
                f"checkpoint shard {entry['file']!r} failed CRC32 verification "
                f"(payload {crc:#010x} != index {int(entry['crc32']):#010x})",
                shard=entry["file"], expected_crc=int(entry["crc32"]),
                actual_crc=int(crc))
    return data


def _load_ranges(directory: str, meta: dict, ranges: list, op: str = "load") -> list:
    """Host planar arrays for the flat ``ranges`` [(start, stop)], in the
    snapshot's dtype: every shard file overlapping them is read once and
    verified; a range the shards do not cover exactly raises. ``op`` names
    the timing histogram."""
    dtype = meta["dtype"]
    num_amps = meta["num_amps_total"]
    if meta["format"] == 1:
        try:
            with np.load(os.path.join(directory, _AMPS_NAME)) as z:
                host = z["amps"]
        except Exception as e:
            raise QuESTError(f"unreadable checkpoint payload: {e}") from e
        if host.shape != (2, num_amps):
            raise QuESTError(f"checkpoint amplitude shape {host.shape} != {(2, num_amps)}")
        host = host.astype(dtype)
        return [host[:, a:b] for a, b in ranges]
    out = [np.empty((2, b - a), dtype=dtype) for a, b in ranges]
    filled = [0] * len(ranges)
    for entry in meta["shards"]:
        s, e = entry["start"], entry["stop"]
        hits = [i for i, (a, b) in enumerate(ranges) if s < b and e > a]
        if not hits:
            continue
        data = _read_shard(directory, entry, op)
        for i in hits:
            a, b = ranges[i]
            lo, hi = max(s, a), min(e, b)
            out[i][:, lo - a:hi - a] = data[:, lo - s:hi - s]
            filled[i] += hi - lo
        del data
    for (a, b), f in zip(ranges, filled):
        if f != b - a:
            raise QuESTError(f"checkpoint shards cover {f} of {b - a} amplitudes "
                             f"in [{a}, {b})")
    return out


def _read_meta(directory: str) -> dict:
    meta_path = os.path.join(directory, _META_NAME)
    if not os.path.exists(meta_path):
        raise QuESTError(f"no checkpoint at {directory!r}")
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        raise QuESTError(f"unreadable checkpoint metadata: {e}") from e
    if not isinstance(meta, dict) or meta.get("format") not in (1, 2):
        fmt = meta.get("format") if isinstance(meta, dict) else None
        raise QuESTError(f"unsupported checkpoint format {fmt!r}")
    need = _META_KEYS + (("shards",) if meta["format"] == 2 else ())
    missing = [k for k in need if k not in meta]
    if missing or (meta["format"] == 2 and not all(
            isinstance(e, dict) and {"file", "start", "stop"} <= set(e)
            for e in meta["shards"])):
        raise QuESTError(f"checkpoint metadata is malformed (missing {missing or 'shard keys'})")
    return meta


def verify_snapshot(directory: str) -> dict:
    """Check a snapshot without creating a register: the index parses, every
    shard is readable, of its indexed shape and CRC-clean, and the shards
    cover [0, num_amps) exactly. Returns the index (``qureg.json``); raises
    :class:`QuESTError` (a CRC mismatch :class:`QuESTChecksumError`) naming
    the shard at fault. Segmented resume picks its generation with it."""
    meta = _read_meta(directory)
    _load_ranges(directory, meta, [(0, meta["num_amps_total"])], "verify")
    return meta


def loadQureg(directory: str, env: QuESTEnv) -> Qureg:
    """The register a :func:`saveQureg` snapshot holds, on ``env``: on its
    device, or cut into its D shards (the snapshot's own cut does not
    matter). The env's seeds and RNG position are restored, so measurement
    sequences resume where they were. Fails closed: nothing is created or
    restored unless every shard verifies."""
    meta = _read_meta(directory)
    num_amps = meta["num_amps_total"]
    n = meta["num_qubits_represented"]
    density = bool(meta["is_density_matrix"])
    if meta["dtype"] not in _TORCH_DTYPE or num_amps != 1 << ((2 if density else 1) * n):
        raise QuESTError(f"checkpoint metadata is inconsistent: dtype {meta['dtype']!r}, "
                         f"{n} qubits, density {density}, {num_amps} amplitudes")
    sharded = sharded_over(env, num_amps)
    d = env.num_ranks if sharded else 1
    c = num_amps // d
    hosts = _load_ranges(directory, meta, [(r * c, (r + 1) * c) for r in range(d)])
    # every payload verified: only now make the register and restore the RNG
    dtype = _TORCH_DTYPE[meta["dtype"]]
    t0 = time.perf_counter()
    tensors = [torch.from_numpy(np.ascontiguousarray(h)).to(dev, dtype)
               for h, dev in zip(hosts, env.devices)]
    del hosts
    _timed("load", "place", t0)
    if sharded:
        q = Qureg(n, density, None, env, shards=tensors)
    else:
        q = Qureg(n, density, tensors[0], env)
    q.qasm_log = QASMLogger(n, dtype)
    # restore the seeds with the RNG only when the snapshot carries one (a
    # register saved without an env leaves the live env as it is)
    if meta.get("rng_state") is not None:
        env.seeds = list(meta.get("seeds", []))
        _restore_rng(env, meta["rng_state"])
    return q


def writeStateToCSV(qureg: Qureg, filename: str | None = None) -> str:
    """The reference's reportState file (QuEST_common.c:219-231): a header
    and one "re, im" row per amplitude, written shard by shard; returns the
    file name (``state_rank_0.csv`` by default)."""
    filename = filename or "state_rank_0.csv"
    with open(filename, "w") as f:
        f.write("real, imag\n")
        for _start, _stop, t in _pieces(qureg):
            host = _host(t)
            for k in range(host.shape[1]):
                f.write(f"{host[0, k]}, {host[1, k]}\n")
    return filename


def saveSeeds(env: QuESTEnv, path: str) -> None:
    """Write the env's seeds and RNG position to ``path`` (JSON)."""
    with open(path, "w") as f:
        json.dump({"seeds": list(env.seeds), "rng_state": _rng_state_json(env)}, f)


def loadSeeds(env: QuESTEnv, path: str) -> None:
    """Restore the env's seeds and RNG position from :func:`saveSeeds`'s file."""
    with open(path) as f:
        data = json.load(f)
    env.seeds = list(data.get("seeds", []))
    _restore_rng(env, data.get("rng_state"))


def _rng_state_json(env: QuESTEnv | None):
    if env is None or env.rng is None:
        return None
    name, keys, pos, has_gauss, cached = env.rng.get_state()
    return {"name": name, "keys": np.asarray(keys).tolist(), "pos": int(pos),
            "has_gauss": int(has_gauss), "cached": float(cached)}


def _restore_rng(env: QuESTEnv, state) -> None:
    if state is None or env.rng is None:
        return
    env.rng.set_state((state["name"], np.asarray(state["keys"], dtype=np.uint32),
                       int(state["pos"]), int(state["has_gauss"]),
                       float(state["cached"])))
