"""Time chip_smoke.py's later phases alone, from one checkout.

    python3 chip_phase_times.py --root DIR [--phases 13,14,15,17] [--out FILE]

Imports ``chip_smoke`` and ``quest_tpu_torch`` from DIR (this checkout, or
another commit unpacked there with ``git archive``), builds the kernels
and the main path's 26q depth-8 plans as ``chip_smoke.main`` does, then
runs the chosen phases: 13 (sampling and gradients), 14 (trajectories and
the pool), 15 (checkpoints and segments), 17 (sampling, gradients and
serving over shards, on the sharded path's plans; it reads phase 13's
one-device figures when 13 ran first), ``17s`` (phase 17's sampling
alone) and ``pieces`` (the sharded shot stage alone on a random 26q state
over 4 shards, f32 and f64, at 1024 and 2^20 shots, for pieces of
2^20-2^23 entries (``ops.reduce.CHUNK_BITS``): its peak memory rise, its
ms as a CUDA-graph replay and eager, the tables equal at every size).
Each phase's helper functions are timed on the host's clock (cumulative
seconds and calls). Prints, and appends to FILE, one JSON
line: ``{"root", "card", "phases": {phase: s}, "steps": {fn: [s, calls]}}``
(the ``pieces`` rows under ``phases["pieces_rows"]``).

To compare two commits, run each in its own process in one call on the
card, in the order parent, change, change, parent. Needs one card.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

#: the helpers whose host seconds are reported, by phase
STEPS = {
    "13": ("_sampling_phase", "_gradients_phase"),
    "14": ("_traj_small", "_traj_width", "_pool_path"),
    "15": ("_ckpt_main", "_f32_drift", "_ckpt_rollback", "_ckpt_sharded", "_ckpt_density"),
    "17": ("_sharded_sampling", "_sharded_gradients", "_sharded_serving"),
    "17s": ("_sharded_sampling",),
    "all": ("_release", "_cuda_ms", "_clock_ms", "_graph_kernels", "_require"),
}


def _timed(fn, steps: dict, name: str):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            s = steps.setdefault(name, [0.0, 0])
            s[0] += time.perf_counter() - t0
            s[1] += 1
    return wrapper


def _pieces(dev) -> dict:
    """The ``pieces`` phase (see the module docstring)."""
    import torch

    from quest_tpu_torch.ops import reduce as R
    from quest_tpu_torch.sampling import sampler as sp

    gen = torch.Generator(device="cpu").manual_seed(0)
    targets = tuple(range(26))
    rows, keep = {}, R.CHUNK_BITS
    try:
        for dt in (torch.float32, torch.float64):
            shards = [torch.randn(2, 1 << 24, generator=gen, dtype=dt).to(dev) for _ in range(4)]
            norm = torch.sqrt(sum((s * s).sum() for s in shards))
            shards = [s / norm for s in shards]
            shard_bytes = shards[0].numel() * shards[0].element_size()
            first: dict = {}
            for bits in (20, 21, 22, 23):
                R.CHUNK_BITS = bits
                for shots in (1024, 1 << 20):
                    seed = torch.tensor(7, device=dev)

                    def draw():
                        return sp.sample_statevec(shards, n=26, targets=targets, shots=shots,
                                                  seed=seed)
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                    out = draw()
                    torch.cuda.synchronize()
                    rise = torch.cuda.max_memory_allocated() - base
                    same = bool(first.setdefault(shots, out).equal(out))
                    t0 = time.perf_counter()
                    for _ in range(3):
                        draw()
                    torch.cuda.synchronize()
                    eager_ms = (time.perf_counter() - t0) / 3 * 1e3
                    side = torch.cuda.Stream()
                    side.wait_stream(torch.cuda.current_stream())
                    with torch.cuda.stream(side):
                        draw()
                        draw()
                    torch.cuda.current_stream().wait_stream(side)
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph):
                        replayed = draw()
                    graph.replay()
                    torch.cuda.synchronize()
                    same &= bool(replayed.equal(out))
                    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    e0.record()
                    for _ in range(10):
                        graph.replay()
                    e1.record()
                    torch.cuda.synchronize()
                    ms = e0.elapsed_time(e1) / 10
                    key = f"{str(dt)[6:]} 2^{bits} {shots}"
                    rows[key] = {"rise_mib": rise / 2 ** 20, "shard_mib": shard_bytes / 2 ** 20,
                                 "graph_ms": ms, "eager_ms": eager_ms, "same": same}
                    print(f"# pieces {str(dt)[6:]}: 2^{bits} entries, {shots} shots: peak rise "
                          f"{rise / 2 ** 20:.1f} MiB (one shard {shard_bytes / 2 ** 20:.0f}), "
                          f"graph replay {ms:.3f} ms, eager {eager_ms:.3f} ms, table = the "
                          f"first size's: {same}", flush=True)
                    del graph, replayed, out
                    torch.cuda.empty_cache()
    finally:
        R.CHUNK_BITS = keep
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="the checkout to import from")
    ap.add_argument("--phases", default="13,14,15")
    ap.add_argument("--out", default=None, help="a file the JSON line is appended to")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    out = os.path.abspath(args.out) if args.out else None
    sys.path.insert(0, root)
    os.chdir(root)

    import torch

    if not torch.cuda.is_available():
        print("chip_phase_times: CUDA is not available; this run needs one card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import quest_tpu_torch as qt
    from quest_tpu_torch import _build

    assert cs.__file__.startswith(root) and qt.__file__.startswith(root), "imports not from --root"
    phases = [p.strip() for p in args.phases.split(",") if p.strip()]
    steps: dict = {}
    for key in phases + ["all"]:
        for name in STEPS.get(key, ()):
            if hasattr(cs, name):
                setattr(cs, name, _timed(getattr(cs, name), steps, name))

    card = cs._card_line()
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda:0")
    circ = qt.Circuit(cs.N_MAIN)
    qt.random_layers(circ, cs.N_MAIN, cs.DEPTH_MAIN)
    plans = {}
    for dt in (torch.float32, torch.float64):
        plans[("main", dt)] = circ.fused(max_qubits=5, pallas=True, dtype=dt)
        if "17" in phases or "17s" in phases:
            plans[("sharded", dt)] = circ.fused(max_qubits=5, pallas=True, dtype=dt,
                                                shard_devices=cs.N_SHARDS)
    seconds = {"build": build_s, "plans": time.perf_counter() - t0 - build_s}
    samp_grad = {"sampling": {}, "gradients": {}}
    for p in phases:
        t0 = time.perf_counter()
        if p == "13":
            samp_grad = cs._sampling_gradients_phase(qt, dev, plans)
        elif p == "14":
            cs._trajectories_pool_phase(qt, dev)
        elif p == "15":
            cs._checkpoint_segments_phase(qt, dev, plans)
        elif p == "17":
            cs._sharded_serving_phase(qt, dev, plans, samp_grad)
        elif p == "17s":
            cs._sharded_sampling(qt, dev, plans, samp_grad["sampling"])
        elif p == "pieces":
            seconds["pieces_rows"] = _pieces(dev)
        else:
            raise SystemExit(f"chip_phase_times: unknown phase {p!r}")
        seconds[p] = time.perf_counter() - t0
        cs._release()
    line = json.dumps({"root": root, "card": card, "phases": seconds,
                       "steps": {k: [round(v[0], 3), v[1]] for k, v in steps.items()}})
    print(line)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
