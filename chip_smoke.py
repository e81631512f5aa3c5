#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/H100 port (``quest_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and ``nvidia-smi``; exits non-zero, printing
no result, without them. Phases, in order:

1. build: compile every CUDA kernel of the port from ``csrc/`` (one nvcc
   per source, started together) and print the toolchain and the card;
2. kernel: the fused gate-run kernel against its plain PyTorch version at
   20 qubits in f32 and f64, for every op kind (matrix with lane, sublane
   and grid-bit controls, parity, swap, diagw, lane_u, window) and every
   folded swap form (load, store, both, asymmetric); limits 1e-5 (f32) and
   1e-12 (f64) max abs error on a normalised state;
3. main path: the bench circuit (random Clifford+T layers, 26 qubits,
   depth 8, f32) planned by ``Circuit.fused(max_qubits=5, pallas=True)``
   at the Hopper tile; each of its runs through the kernel against the
   plain version at 26 qubits (and timed), then the whole circuit through
   ``Circuit.run`` with the counts reset just before it: launches must
   equal the runs executed, ``engine_fallback_total`` must read 0, the
   total probability must be within 1e-4 of 1 and the amplitudes within
   2e-4 of a plain per-gate replay; then gates/sec;
4. yardsticks: a full-state ``copy_`` and ``torch.matmul`` of one lane_u
   product, which the port never calls.

Lines starting with ``#`` carry the detail; the line before the last is
``{"kernels": [...]}``, the last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import importlib.metadata
import json
import subprocess
import sys
import time

N_MAIN, DEPTH_MAIN, N_KERNEL = 26, 8, 20
#: H100 SXM data-sheet rates: HBM bytes/s
#: and FP32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def _cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` back-to-back calls, CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _pass_work(prepared, n: int, itemsize: int) -> tuple[float, float]:
    """(bytes, flops) one pass of ``prepared`` needs on an n-qubit state:
    each amplitude of both planes read once and written once; flops per
    control-satisfied amplitude: 2x2 matrix 16, diagonal 6, swap 0,
    lane_u 1024 (128 complex multiply-adds), window 8 * 2^span."""
    from quest_tpu_torch.ops.fused_gates import _op_is_diag

    N = 1 << n
    flops = 0.0
    for op in prepared.ops:
        kind = op[0]
        if kind == "lane_u":
            flops += 1024.0 * N
        elif kind == "window":
            flops += 8.0 * (1 << op[2]) * N
        elif kind == "matrix":
            flops += (6.0 if _op_is_diag(op) else 16.0) * N / (1 << len(op[2]))
        elif kind in ("parity", "diagw"):
            flops += 6.0 * N / (1 << len(op[2]))
    return 2.0 * 2 * N * itemsize, flops


def _kernel_cases(n: int, tb: int, rng):
    """(name, ops, (load_k, load_hi, store_k, store_hi)) covering every op
    kind and every folded-swap form at n qubits, tile bits tb."""
    import numpy as np

    from quest_tpu_torch.ops.fused_gates import HashableMatrix as HM

    def ru():
        q, _ = np.linalg.qr(rng.randn(2, 2) + 1j * rng.randn(2, 2))
        return HM(q)

    g = n - 1  # a grid bit
    matrix = (("matrix", 0, (), (), ru()),                  # lane target
              ("matrix", 9, (), (), ru()),                  # sublane target
              ("matrix", 2, (8,), (1,), ru()),              # sublane control
              ("matrix", 10, (1,), (0,), ru()),             # lane control, state 0
              ("matrix", 4, (g, 11), (1, 0), ru()),         # grid-bit control
              ("matrix", g, (3,), (1,), HM(np.diag([1j, -1]))))  # grid diagonal
    parity = (("parity", (0, 9, g), (), 0.77), ("parity", (2, g - 1), (5, g), -1.3))
    swap = (("swap", 1, 11, (), ()), ("swap", 3, 8, (6, g), (0, 1)))
    diagw = (("diagw", (1, g - 2, 10), (6,), HM(np.exp(1j * rng.rand(8)))),)
    lane = tuple(("matrix", q % 7, (), (), ru()) for q in range(21))
    window = tuple(("matrix", 7 + q % 5, (), (), ru()) for q in range(25))
    mixed = matrix + parity + swap + diagw + lane[:9] + window[:10]
    none = (0, None, 0, None)
    return [("matrix", matrix, none), ("parity", parity, none),
            ("swap", swap, none), ("diagw", diagw, none),
            ("lane_u", lane, none), ("window", window, none),
            ("load_swap", mixed, (2, None, 0, None)),
            ("store_swap", mixed, (0, None, 3, None)),
            ("load+store_swap", mixed, (2, None, 2, None)),
            ("asymmetric_swap", mixed, (1, n - 1, 2, tb + 1))]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs one card",
              file=sys.stderr)
        return 2
    import numpy as np

    import quest_tpu_torch as qt
    from quest_tpu_torch import _build, fusion, telemetry
    from quest_tpu_torch.ops import fused_gates as FG

    card = _card_line()
    kind = torch.cuda.get_device_name(0)
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"# card: {card}")
    try:
        triton = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton = "not installed"
    print(f"# torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, "
          f"triton {triton} (not used by the port)")
    print(f"# nvcc: {nvcc.splitlines()[-1]}")
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"# build: {json.dumps(built)} ({time.perf_counter() - t0:.2f} s in all)")
    for line in _build.build_log("fused_gates").splitlines():
        if "registers" in line or "spill" in line:
            print(f"# ptxas: {line.strip()}")
    dev = torch.device("cuda:0")

    # -- kernel phase: every op kind and swap form, f32 and f64 ------------
    errs = {}
    rng = np.random.RandomState(11)
    for dt, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        tb = FG.HOPPER_TILE_BITS[dt]
        st = torch.as_tensor(rng.randn(2, 1 << N_KERNEL), dtype=dt, device=dev)
        st /= st.norm()
        out = torch.empty_like(st)
        seen = set()
        for name, ops, (lk, lh, sk, sh) in _kernel_cases(N_KERNEL, tb, rng):
            prep = FG.PreparedRun(ops, tb)
            ref = FG.fused_run_plain(st, prep, n=N_KERNEL, tile_bits=tb,
                                     load_swap_k=lk, load_swap_hi=lh,
                                     store_swap_k=sk, store_swap_hi=sh)
            FG.fused_run(st, n=N_KERNEL, ops=ops, tile_bits=tb, load_swap_k=lk,
                         load_swap_hi=lh, store_swap_k=sk, store_swap_hi=sh,
                         out=out, prepared=prep)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            kinds = sorted({o[0] for o in prep.ops})
            seen.update(kinds)
            print(f"# kernel {str(dt)[6:]} {name}: folded kinds {kinds}, "
                  f"max_abs_err {err:.3e} (limit {tol:g})")
            _require(err <= tol, f"{dt} {name} error {err} > {tol}")
            errs[(str(dt), name)] = err
        _require(seen == {"matrix", "parity", "swap", "diagw", "lane_u", "window"},
                 f"kernel phase missed op kinds: {seen}")
        del st, out, ref

    # -- main path: plan, per-run kernel vs plain, then the circuit --------
    dt = torch.float32
    env = qt.createQuESTEnv()
    circ = qt.Circuit(N_MAIN)
    qt.random_layers(circ, N_MAIN, DEPTH_MAIN)
    t0 = time.perf_counter()
    fz = circ.fused(max_qubits=5, pallas=True, dtype=dt)
    plan_s = time.perf_counter() - t0
    runs = [a[0] for f, a, _ in fz._tape if f is fusion._apply_pallas_run]
    other = [f.__name__ for f, _, _ in fz._tape if f is not fusion._apply_pallas_run]
    tb = FG.hopper_tile_bits(N_MAIN, dt)
    jax_tile = FG.local_qubits(N_MAIN)
    wide = fusion.num_passes(fusion.plan(tuple(circ._tape), N_MAIN, dt,
                                         pallas_tile_bits=jax_tile))
    print(f"# main path: {N_MAIN}q depth {DEPTH_MAIN} f32, {len(circ)} gates -> "
          f"{len(runs)} fused runs at tile_bits {tb} (other items: {other}), "
          f"planned in {plan_s:.2f} s; the same planner at the JAX package's "
          f"tile_bits {jax_tile} gives {wide} passes")
    _require(len(runs) > 0 and not other, "plan is not all fused runs")

    itemsize = torch.finfo(dt).bits // 8
    st = torch.as_tensor(rng.randn(2, 1 << N_MAIN), dtype=dt, device=dev)
    st /= st.norm()
    out = torch.empty_like(st)
    pass_ms, plain_ms, bounds, by_ops, main_err = [], [], [], [], 0.0
    for i, run in enumerate(runs):
        prep = run.prepare()
        kw = dict(n=N_MAIN, tile_bits=tb, load_swap_k=run.load_swap_k,
                  load_swap_hi=run.load_swap_hi, store_swap_k=run.store_swap_k,
                  store_swap_hi=run.store_swap_hi)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        ref = FG.fused_run_plain(st, prep, **kw)
        e1.record()
        torch.cuda.synchronize()
        t_plain = e0.elapsed_time(e1)
        ms = _cuda_ms(lambda: FG.fused_run(st, ops=run.ops, out=out,
                                           prepared=prep, **kw), 5)
        err = (out - ref).abs().max().item()
        del ref
        _require(err <= 1e-5, f"main-path run {i} error {err}")
        main_err = max(main_err, err)
        nbytes, flops = _pass_work(prep, N_MAIN, itemsize)
        b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        b_ops = flops / PEAK_FP32_FLOPS * 1e3
        pass_ms.append(ms)
        plain_ms.append(t_plain)
        bounds.append(max(b_bytes, b_ops))
        by_ops.append(b_ops > b_bytes)
        kinds = [o[0] for o in prep.ops]
        print(f"# pass {i}: {len(run.ops)} ops -> {len(kinds)} "
              f"(lane_u {kinds.count('lane_u')}, window {kinds.count('window')}), "
              f"swaps load {run.load_swap_k} store {run.store_swap_k}: kernel "
              f"{ms:.4f} ms, bound {max(b_bytes, b_ops):.4f} ms by "
              f"{'operations' if b_ops > b_bytes else 'bytes'}, plain "
              f"{t_plain:.2f} ms, max_abs_err {err:.3e}")
    del st, out

    q = qt.createQureg(N_MAIN, env, precision_code=1)
    telemetry.reset()
    FG.fused_run.launches = 0
    fz.run(q)
    torch.cuda.synchronize()
    launches = FG.fused_run.launches
    fallbacks = telemetry.counter_total("engine_fallback_total")
    passes = telemetry.counter_value("pallas_pass_total", kind="fused_run")
    print(f"# main path run: launches {launches}, runs {len(runs)}, "
          f"pallas_pass_total{{fused_run}} {passes:g}, engine_fallback_total "
          f"{fallbacks:g}")
    _require(launches == len(runs) == passes, "launches != runs executed")
    _require(fallbacks == 0, "engine fallback on the main path")
    total = qt.calcTotalProb(q)
    ref_q = qt.createQureg(N_MAIN, env, precision_code=1)
    circ.run(ref_q)  # the plain replay: one gate at a time, per-gate engine
    torch.cuda.synchronize()
    diff = (q.amps - ref_q.amps).abs().max().item()
    p0, p0_ref = qt.calcProbOfOutcome(q, 0, 0), qt.calcProbOfOutcome(ref_q, 0, 0)
    a, a_ref = qt.getAmp(q, 5), qt.getAmp(ref_q, 5)
    print(f"# main path check: calcTotalProb {total:.9f}, max |fused - plain "
          f"replay| {diff:.3e}, calcProbOfOutcome(0,0) {p0:.9f} vs {p0_ref:.9f}, "
          f"getAmp(5) {a:.6e} vs {a_ref:.6e}")
    _require(abs(total - 1) <= 1e-4, f"total probability {total}")
    _require(diff <= 2e-4, f"fused vs plain replay {diff}")
    _require(abs(p0 - p0_ref) <= 2e-4 and abs(a - a_ref) <= 2e-4, "readouts")
    qt.destroyQureg(ref_q)
    torch.cuda.empty_cache()

    reps = 5
    fz.run(q)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fz.run(q)
    torch.cuda.synchronize()
    dt_s = time.perf_counter() - t0
    gps = len(circ) * reps / dt_s
    print(f"# gates/sec: {gps:.1f} ({len(circ)} gates x {reps} reps in "
          f"{dt_s:.4f} s; {dt_s / reps * 1e3:.3f} ms per circuit, "
          f"{sum(pass_ms):.3f} ms of it kernel passes)")
    _require(abs(qt.calcTotalProb(q) - 1) <= 1e-4, "norm after timed reps")

    # -- yardsticks (never called by the port) -----------------------------
    y = torch.empty_like(q.amps)
    copy_ms = _cuda_ms(lambda: y.copy_(q.amps), 10)
    xc = torch.complex(q.amps[0], q.amps[1]).reshape(-1, 128)
    u = torch.randn(128, 128, dtype=torch.complex64, device=dev)
    mm_ms = _cuda_ms(lambda: torch.matmul(xc, u), 10)
    print(f"# yardsticks: full-state copy_ {copy_ms:.4f} ms, complex matmul "
          f"(2^19,128)@(128,128) {mm_ms:.4f} ms")

    npass = len(runs)
    lane_ms = [m for m, o in zip(pass_ms, by_ops) if o]
    print(f"# per pass: kernel {sum(pass_ms) / npass:.4f} ms mean "
          f"({len(lane_ms)} operation-bound passes "
          f"{(sum(lane_ms) / max(len(lane_ms), 1)):.4f} ms mean), bound "
          f"{sum(bounds) / npass:.4f} ms mean, plain {sum(plain_ms) / npass:.2f} ms mean")
    entry = {
        "name": "fused_gate_run", "route": "cuda",
        "source": "quest_tpu_torch/csrc/fused_gates.cu",
        "replaces": "quest_tpu/ops/pallas_gates.py:1141",
        "launches": launches,
        "max_abs_err": max(max(errs.values()), main_err),
        "ms": sum(pass_ms) / npass,
        "plain_ms": sum(plain_ms) / npass,
        "bound_ms": sum(bounds) / npass,
        # which limit makes up most of the summed per-pass bound
        "bound_by": ("operations" if 2 * sum(b for b, o in zip(bounds, by_ops) if o)
                     > sum(bounds) else "bytes"),
        # no single PyTorch call computes a fused gate run; the yardsticks
        # (the memory floor and one lane_u product) are reported beside it
        "library_ms": None,
        "library_yardsticks_ms": {"copy_": copy_ms, "matmul_lane_u": mm_ms},
        "passes": npass, "gates_per_sec": gps,
    }
    print("# kernels: " + json.dumps({"fused_gate_run": {
        "launches": launches, "max_abs_err": entry["max_abs_err"]}}))
    print(card)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
