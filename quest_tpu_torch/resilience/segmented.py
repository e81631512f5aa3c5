"""Preemption-safe segmented execution with verified checkpoints
(``quest_tpu/resilience/segmented.py``).

A fused plan's tape cannot be cut anywhere: between a run's folded load
swap and its store swap the amplitudes live in a permuted frame, which is
no state the API can name. The legal cuts are where the frame is the
identity again, :func:`quest_tpu_torch.segments.identity_boundaries`;
:func:`segment_plan` picks checkpoint cuts among them.

:func:`run_segmented` runs the tape segment by segment. Each segment is
``segments.run_slice``: one segment program, on the card a CUDA graph
whose fused runs launch ``csrc/fused_gates.cu``'s kernel (its first call
runs eagerly). After each segment it writes one checkpoint generation
``gen_{cursor:08d}``: a :func:`~quest_tpu_torch.checkpoint.saveQureg`
snapshot (amplitudes, the env's seeds and RNG position, a CRC32 a shard)
and a ``segment.json`` manifest (the cursor, the tape's item count, the
circuit's fingerprint, ``every_n_items``). ``keep`` generations stay on
disk. The preemption site ``segment.boundary:preempt`` fires between
segments, after the checkpoint is durable.

:func:`resume_segmented` walks the generations newest first and takes the
newest that passes :func:`~quest_tpu_torch.checkpoint.verify_snapshot`; a
rejected one is recorded as a QT305 finding and skipped (a CRC mismatch
counts ``segmented_resume_total{outcome=skipped_corrupt}`` with both CRCs
in the finding, any other defect ``outcome=rejected_gen``), so a torn or
flipped shard falls back to the generation before it. It loads the
register and the RNG and runs the remaining segments. Segment programs are
deterministic and snapshots exact, so a preempted and resumed run equals
the uninterrupted one bit for bit.

Self-healing: with a sentinel policy armed (:mod:`.sentinel`,
``QUEST_SENTINEL``) every segment boundary is an integrity probe. A
breach rolls the register back to the last verified state -- the
generation at the segment's start, or a host copy taken before the first
segment of a fresh run -- and runs the segment again under
:func:`.guard.sentinel_replay`: retry, then degrade, then fail closed with
:class:`~.errors.QuESTIntegrityError`. Fault visits are counted, so an
injected flip (``state.corrupt:bitflip<shard>:nth``) does not fire again
on the replay, and the healed run equals the clean one bit for bit.

The degraded replay differs from the JAX package's by design: there it
forces the kernel dispatch off Pallas, and the port has no kernel-free
route on the card. Here it runs the segment eagerly, entry by entry
(``segments.force_route("item")``, counted
``device_dispatch_total{route=item}``), outside the segment program's
captured graph; its fused runs still launch the hand-written kernel.

The JAX package's ``segmented.segment`` span and ``run_slice``'s trace
phases wait for the port's request traces (ROADMAP A, item 10.2).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import TYPE_CHECKING

from .. import telemetry
from ..validation import QuESTError
from . import faultinject, guard, sentinel
from .errors import QuESTChecksumError, QuESTIntegrityError

if TYPE_CHECKING:
    from ..circuits import Circuit
    from ..environment import QuESTEnv
    from ..registers import Qureg

__all__ = ["segment_plan", "run_segmented", "resume_segmented"]

_MANIFEST = "segment.json"
_GEN_PREFIX = "gen_"


def _qt304(message: str) -> QuESTError:
    from .findings import finding
    finding("QT304", message, "resilience.segmented")
    return QuESTError(f"{message} [QT304]", "run_segmented")


def _qt305(gen_dir: str, why: str) -> None:
    from .findings import finding
    finding("QT305", f"checkpoint generation {os.path.basename(gen_dir)!r} failed "
            f"verification ({why}); falling back to an older generation",
            "resilience.segmented")


def _qt305_crc(gen_dir: str, e: QuESTChecksumError) -> None:
    from .findings import finding
    expected = e.expected_crc if e.expected_crc is not None else 0
    actual = e.actual_crc if e.actual_crc is not None else 0
    finding("QT305", f"checkpoint generation {os.path.basename(gen_dir)!r} shard "
            f"{e.shard!r} is corrupt: payload CRC32 {actual:#010x} != indexed "
            f"{expected:#010x}; skipping this generation", "resilience.segmented")


def segment_plan(tape: list, nsv: int, every_n_items: int = 1) -> list:
    """The checkpoint cuts of ``tape`` on an ``nsv``-qubit state: sorted
    tape indices from 0 to ``len(tape)``, each a frame-identity boundary
    (``segments.identity_boundaries``), at least ``every_n_items`` entries
    apart (the next identity boundary where the exact spacing lands inside
    a permuted frame)."""
    from ..segments import identity_boundaries
    if every_n_items < 1:
        raise _qt304(f"every_n_items must be >= 1, got {every_n_items}")
    boundaries = identity_boundaries(tape, nsv)
    if boundaries[-1] != len(tape):
        raise _qt304("tape does not return to the identity frame at its end")
    cuts = [0]
    for b in boundaries[1:]:
        if b - cuts[-1] >= every_n_items:
            cuts.append(b)
    if cuts[-1] != len(tape):
        cuts.append(len(tape))
    return cuts


def _as_qureg(circuit: Circuit, target) -> Qureg:
    from ..environment import QuESTEnv
    from ..registers import Qureg, createDensityQureg, createQureg

    if isinstance(target, Qureg):
        return target
    if isinstance(target, QuESTEnv):
        make = createDensityQureg if circuit.is_density_matrix else createQureg
        return make(circuit.num_qubits, target)
    raise QuESTError(f"run_segmented needs a QuESTEnv or Qureg, got {type(target)!r}",
                     "run_segmented")


def _gen_dirs(checkpoint_dir: str) -> list:
    """The generation directories under ``checkpoint_dir``, oldest cursor
    first."""
    out = []
    if not os.path.isdir(checkpoint_dir):
        return out
    for name in os.listdir(checkpoint_dir):
        if name.startswith(_GEN_PREFIX):
            try:
                cursor = int(name[len(_GEN_PREFIX):])
            except ValueError:
                continue
            out.append((cursor, os.path.join(checkpoint_dir, name)))
    return [p for _, p in sorted(out)]


def _checkpoint(circuit: Circuit, qureg: Qureg, checkpoint_dir: str, cursor: int,
                every_n_items: int, keep: int) -> str:
    """Write generation ``cursor`` (snapshot, then manifest) and drop all
    but the newest ``keep``."""
    from ..checkpoint import saveQureg

    gen = os.path.join(checkpoint_dir, f"{_GEN_PREFIX}{cursor:08d}")
    saveQureg(qureg, gen)
    manifest = {"cursor": cursor, "total_items": len(circuit._tape),
                "fingerprint": circuit.fingerprint(), "every_n_items": every_n_items}
    tmp = os.path.join(gen, _MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(gen, _MANIFEST))
    telemetry.inc("segmented_checkpoints_total")
    for stale in _gen_dirs(checkpoint_dir)[:-keep] if keep > 0 else []:
        shutil.rmtree(stale, ignore_errors=True)
    return gen


def _state(qureg: Qureg) -> list:
    return [qureg.amps] if qureg.shards is None else list(qureg.shards)


def _run_segment(circuit: Circuit, qureg: Qureg, lo: int, hi: int) -> None:
    """``tape[lo:hi]`` as one segment program, then one visit of the
    ``state.corrupt`` site (a healing replay visits it again, so an
    nth-scoped flip stays out of the replay)."""
    from .. import segments

    segments.run_slice(circuit, qureg, lo, hi)
    telemetry.inc("segmented_segments_total")
    if faultinject.enabled():
        pieces = _state(qureg)
        live = pieces[0] if qureg.shards is None else pieces
        corrupted = guard.corrupt_amps(live)
        if corrupted is not live:
            # into the live buffers: the segment graphs stay keyed on them
            for t, c in zip(pieces, [corrupted] if qureg.shards is None else corrupted):
                t.copy_(c)


def _capture_baseline(qureg: Qureg) -> tuple:
    """The rollback target of a fresh run's first segment (no generation
    exists yet): a host copy of the amplitudes (of each shard) and the env's
    RNG state, the pair a generation holds."""
    env = qureg.env
    rng = env.rng.get_state() if env is not None and env.rng is not None else None
    return [t.detach().to("cpu", copy=True) for t in _state(qureg)], rng


def _rollback(qureg: Qureg, lo: int, checkpoint_dir: str, baseline: tuple | None) -> None:
    """Put the register back to its verified state at cursor ``lo``, in its
    own buffers: the baseline, or generation ``lo`` (CRC-verified, so a
    corrupt rollback target raises instead of feeding the replay)."""
    telemetry.event("segmented.rollback", cursor=lo,
                    source="baseline" if baseline is not None else "gen")
    if baseline is not None:
        hosts, rng = baseline
        for t, h in zip(_state(qureg), hosts):
            t.copy_(h)
        if rng is not None and qureg.env is not None and qureg.env.rng is not None:
            qureg.env.rng.set_state(rng)
        return
    from ..checkpoint import loadQureg

    restored = loadQureg(os.path.join(checkpoint_dir, f"{_GEN_PREFIX}{lo:08d}"), qureg.env)
    for t, h in zip(_state(qureg), _state(restored)):
        t.copy_(h)


def _heal(circuit: Circuit, qureg: Qureg, lo: int, hi: int, checkpoint_dir: str,
          baseline: tuple | None, policy, findings: list) -> None:
    """Rollback and replay of a breached segment ``[lo, hi)``."""
    from .. import segments

    where = f"segment[{lo}:{hi}]"
    telemetry.event("segmented.heal", lo=lo, hi=hi,
                    codes=",".join(f.code for f in findings))

    def _recheck(stage: str) -> None:
        # tick 0 is due for every cadence: a healing check runs every kind
        again = sentinel.check_qureg(qureg, policy=policy, tick=0,
                                     where=f"{where}:{stage}")
        if again:
            raise QuESTIntegrityError(
                f"sentinel breach persists after {stage} of {where}: "
                + "; ".join(f.code for f in again), "run_segmented", findings=again)

    def replay():
        _rollback(qureg, lo, checkpoint_dir, baseline)
        _run_segment(circuit, qureg, lo, hi)
        _recheck("replay")
        return True

    def degrade():
        # entry by entry, outside the segment program's graph; the fused
        # runs still launch the hand-written kernel
        _rollback(qureg, lo, checkpoint_dir, baseline)
        with segments.force_route("item"):
            segments.run_slice(circuit, qureg, lo, hi)
        _recheck("degraded replay")
        return True

    guard.sentinel_replay(replay, degrade, site="segment.sentinel")


def _execute(circuit: Circuit, qureg: Qureg, cuts: list, start: int,
             checkpoint_dir: str, every_n_items: int, keep: int) -> Qureg:
    armed = sentinel.enabled()
    policy = sentinel.active_policy() if armed else None
    tick = 0
    for lo, hi in zip(cuts, cuts[1:]):
        if hi <= start:
            continue
        tick += 1
        baseline = None
        if armed and not os.path.isdir(
                os.path.join(checkpoint_dir, f"{_GEN_PREFIX}{lo:08d}")):
            baseline = _capture_baseline(qureg)  # a fresh run's first segment
        _run_segment(circuit, qureg, lo, hi)
        if armed:
            findings = sentinel.check_qureg(qureg, policy=policy, tick=tick,
                                            where=f"segment[{lo}:{hi}]")
            if findings:
                _heal(circuit, qureg, lo, hi, checkpoint_dir, baseline, policy, findings)
        _checkpoint(circuit, qureg, checkpoint_dir, hi, every_n_items, keep)
        if hi < cuts[-1]:
            # the checkpoint above is durable: a preemption here resumes at hi
            guard.segment_boundary(hi, checkpoint_dir)
    return qureg


def _nsv(circuit: Circuit) -> int:
    return (2 if circuit.is_density_matrix else 1) * circuit.num_qubits


def run_segmented(circuit: Circuit, target, *, checkpoint_dir: str,
                  every_n_items: int = 1, keep: int = 2) -> Qureg:
    """Run ``circuit`` segment by segment, checkpointing after each (see
    the module docstring). ``target`` is a QuESTEnv (a fresh |0...0>
    register is made on it) or a Qureg. Returns the final register; the
    newest generation under ``checkpoint_dir`` holds it (cursor =
    ``len(tape)``)."""
    if keep < 1:
        raise _qt304(f"keep must be >= 1, got {keep}")
    qureg = _as_qureg(circuit, target)
    cuts = segment_plan(circuit._tape, _nsv(circuit), every_n_items)
    os.makedirs(checkpoint_dir, exist_ok=True)
    telemetry.event("segmented.run", segments=len(cuts) - 1, items=len(circuit._tape))
    return _execute(circuit, qureg, cuts, 0, checkpoint_dir, every_n_items, keep)


def resume_segmented(circuit: Circuit, checkpoint_dir: str, env: QuESTEnv, *,
                     every_n_items: int | None = None, keep: int = 2) -> Qureg:
    """Restart a :func:`run_segmented` run from the newest verified
    generation under ``checkpoint_dir`` on ``env`` and run the remaining
    segments; returns the final register. ``every_n_items`` defaults to the
    manifest's, so the resumed run checkpoints on the same cadence."""
    from ..checkpoint import loadQureg, verify_snapshot

    gens = _gen_dirs(checkpoint_dir)
    if not gens:
        raise QuESTError(f"no checkpoint generations under {checkpoint_dir!r}",
                         "resume_segmented")
    chosen = manifest = None
    for gen in reversed(gens):
        try:
            with open(os.path.join(gen, _MANIFEST)) as f:
                m = json.load(f)
            verify_snapshot(gen)
        except QuESTChecksumError as e:
            _qt305_crc(gen, e)
            telemetry.inc("segmented_resume_total", outcome="skipped_corrupt")
            continue
        except (OSError, ValueError, QuESTError) as e:
            _qt305(gen, str(e))
            telemetry.inc("segmented_resume_total", outcome="rejected_gen")
            continue
        if m.get("fingerprint") != circuit.fingerprint():
            raise QuESTError(f"checkpoint generation {os.path.basename(gen)!r} belongs to "
                             "a different circuit (fingerprint mismatch)", "resume_segmented")
        chosen, manifest = gen, m
        break
    if chosen is None:
        telemetry.inc("segmented_resume_total", outcome="no_verified_gen")
        raise QuESTError(f"no generation under {checkpoint_dir!r} passed verification",
                         "resume_segmented")
    qureg = loadQureg(chosen, env)
    cursor = int(manifest["cursor"])
    n_items = (int(manifest.get("every_n_items", 1)) if every_n_items is None
               else every_n_items)
    telemetry.inc("segmented_resume_total", outcome="verified")
    telemetry.event("segmented.resume", cursor=cursor, generation=os.path.basename(chosen))
    if cursor >= len(circuit._tape):
        return qureg
    cuts = segment_plan(circuit._tape, _nsv(circuit), n_items)
    if cursor not in cuts:
        raise QuESTError(f"manifest cursor {cursor} is not a segment boundary of this "
                         f"circuit at every_n_items={n_items}", "resume_segmented")
    return _execute(circuit, qureg, cuts, cursor, checkpoint_dir, n_items, keep)
