#!/usr/bin/env python3
"""Where the time of the f32 lane_u fold goes, on one CUDA card.

    python3 chip_lane_u_breakdown.py

Builds ``quest_tpu_torch/csrc/fused_gates.cu`` as it is and in variants
that each take one piece of the lane_u op away (or change it), and times a
one-op lane_u pass (a Haar 128x128 unitary, 26 qubits, f32, in place) with
each, in turns on the same card, the unchanged kernel first and last:

- ``kernel``: the source as it is;
- ``no MMA``: the warps skip the A loads, splits and ``mma.sync`` (the
  tile's load and store, the panel staging and the barriers remain);
- ``load and store``: ``no MMA`` without the panel staging either;
- ``one TF32 term``: ``mma.sync`` hi*hi only, a third of the products;
- ``A broadcast``: every lane reads its A values from the first row of its
  m16 tile (no bank conflicts on A; wrong results, timing only);
- ``interleaved``: the 12 ``mma.sync`` of an n8 tile's four products
  issued term by term across the 8 sums instead of sum by sum.

Only the unchanged kernel's result is checked (against ``fused_run_plain``,
1e-5 of the largest amplitude). Needs ``nvcc`` and ``nvidia-smi``; exits
non-zero without a card. Prints one line per variant and the card's name
and power limit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

N_QUBITS, TILE_BITS, REPS = 26, 13, 20

_CHAIN = """            quest_mma::mma_3xtf32(accr[j], sr, ur);
            quest_mma::mma_3xtf32(accr[j], si, quest_mma::negate(ui));
            quest_mma::mma_3xtf32(acci[j], sr, ui);
            quest_mma::mma_3xtf32(acci[j], si, ur);
          }
"""
_LOADS = """            const quest_mma::SplitB ur = quest_mma::load_b_split(br + n * kPanelLd + boff);
            const quest_mma::SplitB ui = quest_mma::load_b_split(bi + n * kPanelLd + boff);
"""

#: variant name -> [(text in the source, its replacement), ...]
VARIANTS = {
    "no MMA": [("const bool active = 16 *", "const bool active = false && 16 *")],
    "load and store": [("const bool active = 16 *", "const bool active = false && 16 *"),
                       ("constexpr int kPieces = 2 * kPanelK / 4;",
                        "return;\n  constexpr int kPieces = 2 * kPanelK / 4;")],
    "one TF32 term": [(_CHAIN, _CHAIN.replace("mma_3xtf32(", "mma_tf32(")
                       .replace("sr, ", "sr.hi, ").replace("si, ", "si.hi, ")
                       .replace("ur);", "ur.hi);").replace("ui);", "ui.hi);")
                       .replace("negate(ui));", "negate(ui).hi);"))],
    "A broadcast": [("const uint32_t row0 = 16 * (warp & 3) + l.g, row1 = row0 + 8;",
                     "const uint32_t row0 = 16 * (warp & 3), row1 = row0;")],
    "interleaved": [(_LOADS + _CHAIN, """          }
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
""")],
}


def _variant_sources(src: str) -> dict:
    out = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: its anchor is not in the source once")
            text = text.replace(old, new)
        out[name] = text
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_lane_u_breakdown: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from quest_tpu_torch import _build
    from quest_tpu_torch.ops import fused_gates as FG

    csrc = _build._PKG / _build.CSRC
    src = (csrc / "fused_gates.cu").read_text()
    variants = _variant_sources(src)
    libs = {"kernel": _build.library("fused_gates")}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        procs = {}
        for i, (name, text) in enumerate(variants.items()):
            cu = os.path.join(tmp, f"variant{i}.cu")
            with open(cu, "w") as f:
                f.write(text)
            procs[name] = (subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
                 cu[:-3] + ".so", cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), cu[:-3] + ".so")
        for name, (proc, so) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on variant {name!r}:\n{log}")
            regs = [k for k in CS._ptxas_kernels(log) if "true" in k["kernel"]]
            print(f"# variant {name}: ptxas {regs}")
            lib = ctypes.CDLL(so)
            for fn, (args, res) in _build.SIGNATURES["fused_gates"].items():
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = res
            libs[name] = lib

        dev = torch.device("cuda:0")
        rng = np.random.RandomState(5)
        q, r = np.linalg.qr(rng.randn(128, 128) + 1j * rng.randn(128, 128))
        u = q * (np.diag(r) / np.abs(np.diag(r)))
        W = np.stack([u.real.T, u.imag.T, u.real.T + u.imag.T])
        prep = FG.PreparedRun((("lane_u", FG.HashableMatrix(W)),), TILE_BITS)
        table, coeffs = prep.device_tables(dev, torch.float32)
        st = torch.as_tensor(rng.randn(2, 1 << N_QUBITS), dtype=torch.float32, device=dev)
        st /= st.norm()
        x = st.clone()

        def run(lib):
            err = lib.quest_fused_run_f32(
                x.data_ptr(), x.data_ptr(), N_QUBITS, N_QUBITS, 0, TILE_BITS,
                table.data_ptr(), 1, coeffs.data_ptr(), 0, TILE_BITS, 0, TILE_BITS, 0, 0,
                1, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed ({err})")

        run(libs["kernel"])
        torch.cuda.synchronize()
        ref = FG.fused_run_plain(st, prep, n=N_QUBITS, tile_bits=TILE_BITS)
        err, rel = CS._rel_err(x, ref)
        CS._require(rel <= 1e-5, f"kernel against plain: {err} ({rel} relative)")
        del ref
        print(f"# kernel against plain: max_abs_err {err:.3e} ({rel:.3e} of the largest)")
        bound = CS._bound_ms(CS._pass_work(prep, N_QUBITS, 4), True)
        for name in ["kernel", *variants, "kernel"]:
            ms = CS._cuda_ms(lambda: run(libs[name]), REPS)
            print(f"# one-op lane_u pass, {N_QUBITS}q f32, {name}: {ms:.4f} ms "
                  f"(bound {max(bound):.4f} ms)")
    print(CS._card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
