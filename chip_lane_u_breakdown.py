#!/usr/bin/env python3
"""Where the time of the lane_u fold goes, on one CUDA card, f32 and f64.

    python3 chip_lane_u_breakdown.py [--parent DIR] [--dtypes f32,f64]

Builds ``quest_tpu_torch/csrc/fused_gates.cu`` as it is and in variants
that each take one piece of the lane_u op away (or change it), and times a
one-op lane_u pass (a Haar 128x128 unitary, 26 qubits, in place) with
each, in turns on the same card, the unchanged kernel first and last.
f32 (``lane_u_mma``, 3xTF32):

- ``no MMA``: the warps skip the A loads, splits and ``mma.sync`` (the
  tile's load and store, the panel staging and the barriers remain);
- ``load and store``: ``no MMA`` without the panel staging either;
- ``one TF32 term``: ``mma.sync`` hi*hi only, a third of the products;
- ``A broadcast``: every lane reads its A values from the first row of its
  m16 tile (no bank conflicts on A; wrong results, timing only);
- ``interleaved``: the 12 ``mma.sync`` of an n8 tile's four products
  issued term by term across the 8 sums instead of sum by sum.

f64 (``lane_u_dmma``, FP64 ``mma.sync``):

- ``f64 no MMA`` and ``f64 load and store``: as in f32;
- ``f64 no U^T stream``: the products run on whatever the panel ring
  holds, nothing is copied into it (what the stream of U^T from L2 costs;
  wrong results, timing only);
- ``f64 A broadcast``: as in f32;
- ``f64 unmasked``: no row masks (every row read and written: right only
  at the full tile, which this pass has; what the masks cost);
- ``f64 MMA only``: the same ``mma.sync`` on operands held in registers,
  no A or B loads (the tensor cores' share; wrong results, timing only);
- ``f64 m16n8k8``: each chunk's m16n8k16 product of a plane as two FP64
  ``mma.sync`` m16n8k8, one per k step (twice the instructions, the same
  operands);
- ``f64 ring of 3``: U^T streamed through 3 chunk buffers, two ahead,
  instead of 2, one ahead (what the depth of the ring buys);
- ``f64 one block per SM``: the same fold in an instantiation of its own
  with one block per SM (``__launch_bounds__(512, 1)``: up to 128
  registers), as the f32 fold runs.

``--parent DIR`` also builds ``DIR/quest_tpu_torch/csrc/fused_gates.cu``
(another checkout, e.g. the parent commit unpacked by ``git archive``) and
times its f64 pass beside this one's, first and last but one: its kernel
reads the lane_u block's first part (U^T real and imaginary), which this
checkout's ``encode_ops`` still writes first.

The unchanged kernel's results are checked (against ``fused_run_plain``,
1e-5 of the largest amplitude in f32, 1e-12 in f64), and so are the
parent's and those of the variants in ``RIGHT``, which compute the same. Needs ``nvcc`` and ``nvidia-smi``; exits
non-zero without a card. Prints each variant's registers and spills, one
line per variant and dtype, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
from pathlib import Path

N_QUBITS, REPS = 26, 20

_CHAIN = """            quest_mma::mma_3xtf32(accr[j], sr, ur);
            quest_mma::mma_3xtf32(accr[j], si, quest_mma::negate(ui));
            quest_mma::mma_3xtf32(acci[j], sr, ui);
            quest_mma::mma_3xtf32(acci[j], si, ur);
          }
"""
_LOADS = """            const quest_mma::SplitB ur = quest_mma::load_b_split(br + n * kPanelLd + boff);
            const quest_mma::SplitB ui = quest_mma::load_b_split(bi + n * kPanelLd + boff);
"""
_ACTIVE32 = "const bool active = 16 * static_cast<uint32_t>(warp & 3)"
_ACTIVE64 = "const bool active = 16 * static_cast<uint32_t>(warp & 1)"
_STAGE64 = "  for (int v = tid; v < kChunkPanel / 2; v += kThreads) {"
#: the f64 fold's m16n8k16 product of a chunk and one plane of A, as the
#: source has it
_K16 = """        // k = t, t + 4, t + 8, t + 12: the chunk's columns c0 .. c0 + 3
        const double xa[8] = {r0[0].x, r1[0].x, r0[0].y, r1[0].y,
                              r0[1].x, r1[1].x, r0[1].y, r1[1].y};
        const double u4[4] = {ur[0][0], ur[0][1], ur[1][0], ur[1][1]};
        const double sign = p ? -1.0 : 1.0;
        const double v4[4] = {sign * ui[0][0], sign * ui[0][1], sign * ui[1][0],
                              sign * ui[1][1]};
        quest_mma::mma_f64_k16(p ? acci : accr, xa, u4);
        quest_mma::mma_f64_k16(p ? accr : acci, xa, v4);
"""
#: the same as two m16n8k8 products, one per k step
_K8_PAIR = """#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const double xa[4] = {r0[h].x, r1[h].x, r0[h].y, r1[h].y};
          if (p == 0) {
            quest_mma::mma_f64(accr, xa, ur[h]);
            quest_mma::mma_f64(acci, xa, ui[h]);
          } else {
            const double nui[2] = {-ui[h][0], -ui[h][1]};
            quest_mma::mma_f64(acci, xa, ur[h]);
            quest_mma::mma_f64(accr, xa, nui);
          }
        }
"""

#: variant name -> (the dtype it is timed in, [(text in the source, its
#: replacement), ...])
VARIANTS = {
    "no MMA": ("f32", [(_ACTIVE32, "const bool active = false && 16 * static_cast<uint32_t>(warp & 3)")]),
    "load and store": ("f32", [
        (_ACTIVE32, "const bool active = false && 16 * static_cast<uint32_t>(warp & 3)"),
        ("constexpr int kPieces = 2 * kPanelK / 4;",
         "return;\n  constexpr int kPieces = 2 * kPanelK / 4;")]),
    "one TF32 term": ("f32", [(_CHAIN, _CHAIN.replace("mma_3xtf32(", "mma_tf32(")
                               .replace("sr, ", "sr.hi, ").replace("si, ", "si.hi, ")
                               .replace("ur);", "ur.hi);").replace("ui);", "ui.hi);")
                               .replace("negate(ui));", "negate(ui).hi);"))]),
    "A broadcast": ("f32", [("const uint32_t row0 = 16 * (warp & 3) + l.g, row1 = row0 + 8;",
                             "const uint32_t row0 = 16 * (warp & 3), row1 = row0;")]),
    "interleaved": ("f32", [(_LOADS + _CHAIN, """          }
          quest_mma::SplitB ur[4], ui[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = n0 + 8 * j + l.g;
            ur[j] = quest_mma::load_b_split(br + n * kPanelLd + boff);
            ui[j] = quest_mma::load_b_split(bi + n * kPanelLd + boff);
          }
#pragma unroll
          for (int term = 0; term < 3; ++term) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const quest_mma::SplitB nui = quest_mma::negate(ui[j]);
              const quest_mma::SplitB* b[4] = {&ur[j], &nui, &ui[j], &ur[j]};
              float* c[4] = {accr[j], accr[j], acci[j], acci[j]};
              const quest_mma::SplitA* a[4] = {&sr, &si, &sr, &si};
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                if (term == 0) quest_mma::mma_tf32(c[q], a[q]->lo, b[q]->hi);
                if (term == 1) quest_mma::mma_tf32(c[q], a[q]->hi, b[q]->lo);
                if (term == 2) quest_mma::mma_tf32(c[q], a[q]->hi, b[q]->hi);
              }
            }
          }
""")]),
    "f64 no MMA": ("f64", [(_ACTIVE64, "const bool active = false && 16 * static_cast<uint32_t>(warp & 1)")]),
    "f64 load and store": ("f64", [
        (_ACTIVE64, "const bool active = false && 16 * static_cast<uint32_t>(warp & 1)"),
        (_STAGE64, "  return;\n" + _STAGE64)]),
    "f64 no U^T stream": ("f64", [(_STAGE64, "  return;\n" + _STAGE64)]),
    "f64 A broadcast": ("f64", [("const uint32_t row0 = 16 * (warp & 1) + l.g, row1 = row0 + 8;",
                                 "const uint32_t row0 = 16 * (warp & 1), row1 = row0;")]),
    "f64 unmasked": ("f64", [("const bool ok0 = row0 < rows, ok1 = row1 < rows;\n  double accr",
                              "const bool ok0 = true, ok1 = true;\n  double accr")]),
    "f64 MMA only": ("f64", [(
        "        const double* x = p ? sim : sre;\n",
        "        const double* x = p ? sim : sre;\n        if (x) {\n"
        "          const double v[8] = {x[0], x[1], x[2], x[3], x[4], x[5], x[6], x[7]};\n"
        "          const double u4[4] = {ur[0][0], ur[0][1], ur[1][0], ur[1][1]};\n"
        "          const double w4[4] = {ui[0][0], ui[0][1], ui[1][0], ui[1][1]};\n"
        "          quest_mma::mma_f64_k16(accr, v, u4);\n"
        "          quest_mma::mma_f64_k16(acci, v, w4);\n"
        "          continue;\n        }\n"),
        ("        const double2 vr = *reinterpret_cast<const double2*>(b + h * kHalfPanel);\n"
         "        const double2 vi = *reinterpret_cast<const double2*>(b + h * kHalfPanel + kHalf * 8);\n",
         "        const double2 vr = make_double2(b[0], 1.0), vi = make_double2(0.5, -0.5);\n")]),
    "f64 m16n8k8": ("f64", [(_K16, _K8_PAIR)]),
    "f64 ring of 3": ("f64", [("constexpr int kChunkRing = 2;", "constexpr int kChunkRing = 3;")]),
    "f64 one block per SM": ("f64", [
        ("""  if constexpr (sizeof(T) == 4) {
    if (has_lane_u) kernel = fused_run_kernel<T, true>;
  }""", "  if (has_lane_u) kernel = fused_run_kernel<T, true>;"),
        ("  } else if constexpr (kLaneMma) {\n    // one block per SM",
         "  } else if constexpr (kLaneMma && sizeof(T) == 4) {\n    // one block per SM"),
        ("  } else if constexpr (kLaneMma) {\n    for (uint32_t i = 4 * tid;",
         "  } else if constexpr (kLaneMma && sizeof(T) == 4) {\n    for (uint32_t i = 4 * tid;")]),
}


#: the variants that compute the same as the kernel (checked like it)
RIGHT = {"interleaved", "f64 m16n8k8", "f64 ring of 3", "f64 one block per SM"}


def _variant_sources(src: str) -> dict:
    out = {}
    for name, (_, edits) in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: its anchor is not in the source once")
            text = text.replace(old, new)
        out[name] = text
    return out


def _load(so: str):
    from quest_tpu_torch import _build

    lib = ctypes.CDLL(so)
    for fn, (args, res) in _build.SIGNATURES["fused_gates"].items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = res
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another checkout whose f64 fold to time beside")
    ap.add_argument("--dtypes", default="f32,f64", help="which folds to time (default: both)")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_lane_u_breakdown: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from quest_tpu_torch import _build
    from quest_tpu_torch.ops import fused_gates as FG

    csrc = _build._PKG / _build.CSRC
    sources = {name: (text, csrc) for name, text in
               _variant_sources((csrc / "fused_gates.cu").read_text()).items()}
    if args.parent:
        pc = Path(args.parent).resolve() / "quest_tpu_torch" / "csrc"
        sources["parent"] = ((pc / "fused_gates.cu").read_text(), pc)
    libs = {"kernel": _build.library("fused_gates")}
    print(f"# ptxas kernel: {CS._ptxas_kernels(_build.build_log('fused_gates'))}")
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        procs = {}
        for i, (name, (text, inc)) in enumerate(sources.items()):
            cu = os.path.join(tmp, f"variant{i}.cu")
            with open(cu, "w") as f:
                f.write(text)
            procs[name] = (subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(inc), "-o",
                 cu[:-3] + ".so", cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), cu[:-3] + ".so")
        for name, (proc, so) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on variant {name!r}:\n{log}")
            print(f"# variant {name}: ptxas {CS._ptxas_kernels(log)}")
            libs[name] = _load(so)

        dev = torch.device("cuda:0")
        rng = np.random.RandomState(5)
        q, r = np.linalg.qr(rng.randn(128, 128) + 1j * rng.randn(128, 128))
        u = q * (np.diag(r) / np.abs(np.diag(r)))
        W = np.stack([u.real.T, u.imag.T, u.real.T + u.imag.T])
        for dtn, dt, tol in (("f32", torch.float32, 1e-5), ("f64", torch.float64, 1e-12)):
            if dtn not in args.dtypes.split(","):
                continue
            tb = FG.HOPPER_TILE_BITS[dt]
            prep = FG.PreparedRun((("lane_u", FG.HashableMatrix(W)),), tb)
            table, coeffs = prep.device_tables(dev, dt)
            st = torch.as_tensor(rng.randn(2, 1 << N_QUBITS), dtype=dt, device=dev)
            st /= st.norm()
            x = st.clone()

            def run(lib):
                fn = lib.quest_fused_run_f32 if dt == torch.float32 else lib.quest_fused_run_f64
                err = fn(x.data_ptr(), x.data_ptr(), N_QUBITS, N_QUBITS, 0, tb,
                         table.data_ptr(), 1, coeffs.data_ptr(), 0, tb, 0, tb, 0, 0,
                         1, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed ({err})")

            ref = FG.fused_run_plain(st, prep, n=N_QUBITS, tile_bits=tb)
            checked = (["kernel"] + (["parent"] if dtn == "f64" and "parent" in libs else [])
                       + [n for n in RIGHT if VARIANTS[n][0] == dtn])
            for name in checked:
                x.copy_(st)
                run(libs[name])
                torch.cuda.synchronize()
                err, rel = CS._rel_err(x, ref)
                CS._require(rel <= tol, f"{dtn} {name} against plain: {err} ({rel} relative)")
                print(f"# {dtn} {name} against plain: max_abs_err {err:.3e} ({rel:.3e} of "
                      f"the largest, limit {tol:g})")
            del ref
            bound = CS._bound_ms(CS._pass_work(prep, N_QUBITS, 8 if dtn == "f64" else 4),
                                 dtn == "f32")
            mine = [n for n, (d, _) in VARIANTS.items() if d == dtn]
            parent = ["parent"] if dtn == "f64" and "parent" in libs else []
            for name in ["kernel", *parent, *mine, *parent, "kernel"]:
                ms = CS._cuda_ms(lambda: run(libs[name]), REPS)
                print(f"# one-op lane_u pass, {N_QUBITS}q {dtn}, {name}: {ms:.4f} ms "
                      f"(bound {max(bound):.4f} ms, {max(bound) / ms:.1%} of it)")
            del st, x
            torch.cuda.empty_cache()
    print(CS._card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
