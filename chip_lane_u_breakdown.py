#!/usr/bin/env python3
"""Where the time of the fused-run kernel's arms goes, on one CUDA card:
the lane_u fold in f32 and f64, the krausn arm in f64 and f32, the window
fold in f64 and f32, the diagonal arm and the 2x2 arm.

    python3 chip_lane_u_breakdown.py [--parent DIR]
        [--passes f32,f64,krausn,krausn32,window64,window32,diag32,diag64,sweep32,sweep64]

Builds ``quest_tpu_torch/csrc/fused_gates.cu`` as it is and in variants
that each take one piece of an op away (or change it), and times a one-op
pass with each, in turns on the same card, the unchanged kernel first and
last: ``f32`` and ``f64``, a lane_u pass (a Haar 128x128 unitary, 26
qubits, in place); ``krausn``, a pass of the density path's 3-target
channel alone (``chip_smoke.py``'s, 28 flattened qubits, f64, in
place); ``krausn32``, the same pass in f32. f32 (``lane_u_mma``, 3xTF32):

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

krausn (``krausn_dmma``, FP64 ``mma.sync``), each also timed on the f64
lane_u pass (the two arms share the instantiation's 64 registers):

- ``krausn no MMA`` and ``krausn load and store``: as in f32 (the tile's
  load and store, with and without the S^T stream and the barriers);
- ``krausn no S^T stream``: nothing is copied into the chunk ring;
- ``krausn no A loads``: the gathered A values replaced by their offsets
  (the address arithmetic stays, the shared-memory loads go);
- ``krausn no B loads``: the B fragments from registers;
- ``krausn m16n8k16``: each step's product of a plane as one FP64
  ``mma.sync`` m16n8k16, as lane_u_dmma takes it (all eight A values of a
  plane, and their addresses, live at once);
- ``krausn column sweeps``: the sweeps over the output columns, as
  lane_u_dmma's (S^T streamed whole each sweep), the first sweep's sums
  kept in registers until every read of the tile is done;
  ``krausn column sweeps, local stash``: the same, kept in a ``volatile``
  thread-local array, as lane_u_dmma keeps its own;
- ``krausn out of line``: the arm as a function of its own
  (``__noinline__``: its registers allocated apart from the kernel's).

krausn32 (``krausn_mma``, 3xTF32 ``mma.sync`` in ``fused_run_kernel<float,
false>``):

- ``krausn32 no MMA``, ``krausn32 load and store`` and ``krausn32 no S^T
  stream``: as for krausn;
- ``krausn32 no A split``: A rounded to TF32 only (hi), so each product is
  hi*hi + hi*lo, two ``mma.sync`` instead of three, and the split of A
  goes (what the split and its third product cost; less accurate, timing
  only);
- ``krausn32 A swap``: lanes of groups g & 4 load the two A values of a k
  step in the other order and swap them in registers (for the density
  path's mask, rows 2-4 low and columns at the top of the tile, a warp's
  loads then hit 32 banks, not 16 twice);
- ``krausn32 8 sums``: one n8 tile a warp, sweeps of 32 groups, as
  krausn_dmma takes them (``kKrausN8 = 1``);
- ``krausn32 mask held``: the mask's bits and what derives from them
  found once, not again each sweep through an opaque move;
- ``krausn32 resident S^T``: S^T not split by the host but the f64
  kernel's fragment-order table cast to float (32 KiB) staged once an op,
  its B fragments split into TF32 hi and lo in registers (no chunk ring);
- ``krausn32 one block per SM``: krausn runs launch the f32 lane_u
  instantiation (``__launch_bounds__(512, 1)``: up to 128 registers), the
  arm's shape unchanged.

window64 (``window_dmma``, FP64 ``mma.sync`` in ``fused_run_kernel<double,
false>``; a one-op pass of a Haar 32x32 unitary on the zone [7, 12), 26
qubits, in place):

- ``window64 no MMA``: no k steps (the tile's load and store, the table's
  stage and the barriers remain; zeros are stored);
- ``window64 load and store``: ``no MMA`` without the stage either;
- ``window64 no U stage``: the A fragments read with ``__ldg`` from the
  coefficient buffer, nothing staged;
- ``window64 X through padded rows``: each k step the warp copies its 8
  rows x 8 columns, both planes, into its 1 KiB of the second chunk
  buffer (halves swapped in rows with bit 1 set) and reads its B
  fragments from there, free of the 4-way bank conflicts;
- ``window64 U^T as B``: the other layout, as window_dot.cu takes it: X^T
  as the A operand (warp w: the m16 tile of columns 16 (w & 7)), U^T as B
  (n8 tiles w >> 3 and (w >> 3) + 2), U staged unpermuted with rows padded
  to D + 4; two warps read each column, so the writes wait for a block
  barrier;
- ``window64 out of line``: the arm as a function of its own
  (``__noinline__``);
- ``window64 offset left to the compiler``: the lane's output offset not
  ``volatile`` (the compiler keeps it where it likes);
- ``window64 offset found again``: the offset computed again from the
  thread index (an opaque move) after the k loop, nothing in thread-local
  memory;
- ``window64 k loop unrolled``: the k loop left to the compiler's
  unrolling;
- ``window64 without the FMA arm``: f64 windows of spans 1-2 trap instead
  of running ``window_op<double, 2, 1>`` (whose registers and spills the
  instantiation then sheds; this pass never takes that arm).

window32 (``window_mma``, 3xTF32 ``mma.sync`` in ``fused_run_kernel<float,
false>``; the same unitary on the zone [7, 12) of the 2^13 tile, two slabs
of 128 columns, 26 qubits, in place):

- ``window32 no MMA`` and ``window32 load and store``: as for window64 (the
  stage here is the kernel's split of U into the table);
- ``window32 no A loads``: the split A fragments from registers, not the
  staged table (wrong results, timing only);
- ``window32 X through padded rows``: each k step the warp copies its 8
  rows x 8 columns, both planes, into 512 bytes of its own after the
  table (rows of 8 floats: the B loads then hit 32 banks) and reads its B
  fragments from there;
- ``window32 U^T as B``: the other layout, as window_dot.cu and krausn_mma
  take it: X^T as the A operand, split in registers (warp: one slab's m16
  block of 16 columns, all of D: 32 sums a thread at D = 32), U^T as B,
  split by the kernel into a B-fragment table as it stages it;
- ``window32 U split by the host``: the table built on the host (the same
  values in the same order, after U in the variant's own coefficient
  buffer) and copied in by cp.async, not split by the kernel as it stages;
- ``window32 k loop unrolled``: the k loop left to the compiler's
  unrolling;
- ``window32 no B loads``, ``window32 no stage``: the X values from
  registers (their offsets), or no table staged (wrong results, timing
  only); ``window32 one TF32 term``: hi*hi alone, a third of the HMMA;
- ``window32 B prefetch``: the next k step's X values loaded before this
  step's products; ``window32 two items at once``: both of a warp's slabs
  in one k loop, each A fragment feeding both (32 sums a thread);
  ``window32 three products``: Ur xr, Ui xi and (Ur + Ui)(xr + xi)
  (Gauss's), out_i from the third less the others (24 sums a thread).

``diag32`` and ``diag64``: the diagonal arm alone (``diag_sweep``), one
pass of the elementwise ops of the 26-qubit QFT's run that holds the most
(its controlled phases, merged into ``diagw`` records), in place:

- ``diag out of line``: ``diag_sweep`` a call, not inlined into the kernel;
- ``diag32 held 8``, ``diag32 held 4``, ``diag64 held 8``, ``diag64 held
  2``: a thread holds 8 or 4 (f32) or 8 or 2 (f64) of its amplitudes in
  registers at once, not 16 or 4;
- ``diag no multiply``: each record's entries loaded but not multiplied
  in (wrong results, timing only);
- ``diag load and store``: the sweep stages its records and reads and
  writes its amplitudes, but applies no record (timing only).

``sweep32`` and ``sweep64``: the 2x2 arm alone (``reg_sweep``), one pass
of ``chip_smoke.TWO_BY_TWO_RUN`` (14 2x2s on [7, 12) with T and Rz
between them) built below the fold, 26 qubits, in place:

- ``sweep load and store``: each sweep reads and writes its groups but
  applies no record (a lone swap still moves; timing only);
- ``sweep no 2x2``: the 2x2 records' arithmetic skipped (swaps stay;
  wrong results, timing only);
- ``sweep general form``: every 2x2 in the general form (16 multiply-adds
  a pair; the host's real, Rx and X forms unused);
- ``sweep32 width 2``, ``sweep32 width 4``, ``sweep64 width 3``: the kernel
  built for sweeps of that many qubits (``sweep_bits``), the pass's table
  grouped at that width (``group_sweeps``, ``mark_sweeps``).

``drift32`` (named only): the norm that each accumulation walk of the
3xTF32 products (``quest_mma::mma_3xtf32``, ``csrc/mma.cuh``) loses on
the card's tensor cores, whose FP32 accumulation truncates. A one-op
lane_u pass and a one-op window pass on [7, 12) (26 qubits, f32) run
through builds of the kernel with each walk: (a) the three products
chained onto the running sum; (b) each product into a zeroed fragment,
added to the sum by an FP32 add (round to nearest); (c) hi*hi into a
zeroed fragment a k step, added so, and the two small products chained
in a second sum (the lane_u and window arms given one); (d) (a) with lo
rounded to TF32 (``cvt.rna``) in the split, the host's split of U^T
too; (e) the three products chained into a zeroed fragment a k step,
hi*hi last, added so; (f) hi*hi into a zeroed fragment d, then
hi*hi again onto -d (what the truncation of d dropped) with the two
small products chained after it, both added so (four products a step).
The checkout's own build (``kernel``) comes first.
Each ``# drift32`` line gives sum |amp|^2 less
that of the exact product (the pass in float64 on the card), the error
over the largest amplitude, and ms; the plain version's line comes
first.

``driftrun`` (named only): phase 15's drift check (``chip_smoke._f32_drift``)
through each of ``drift32``'s walks and the checkout's own: the 26q
depth-8 f32 plan run 8 times from |0>, |1 - calcTotalProb| of the kernel
against that of the plain version, and the plan's ms a run.

``windowdot32`` (named only): ``window_dot`` in f32 on [7, 11] at 26
qubits, this checkout's kernel (and with ``--parent`` the parent's, in
turns), each against the plain version.

With ``--parent``, the sweep passes are followed by the kernel passes of
the 26-qubit main path's and the QFT's fused runs in that precision
(``chip_smoke``'s circuits, each pass with its folded frame swaps), each
through this checkout's kernel and the parent's (kernel, parent, parent,
kernel), the two held against each other and summed a path.

``--parent DIR`` also builds ``DIR/quest_tpu_torch/csrc/fused_gates.cu``
(another checkout, e.g. the parent commit unpacked by ``git archive``) and
times its passes beside this one's, first and last but one: its kernel
reads the parts of the lane_u, kraus and window blocks that it knows (U^T,
S^T or U, real and imaginary, the lane_u split and f64 tables, the kraus
f64 table), which this checkout's ``encode_ops`` still writes where they
were.

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
_ACTIVE32 = "const bool active = 16 * static_cast<uint32_t>(warp & 3) < rows;"
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
    "no MMA": ("f32", [(_ACTIVE32, _ACTIVE32.replace("= 16", "= false && 16"))]),
    "load and store": ("f32", [
        (_ACTIVE32, _ACTIVE32.replace("= 16", "= false && 16")),
        ("constexpr int kPieces = 2 * kPanelK / 4;",
         "return;\n  constexpr int kPieces = 2 * kPanelK / 4;")]),
    "one TF32 term": ("f32", [(_CHAIN, _CHAIN.replace("mma_3xtf32(", "mma_tf32(")
                               .replace("sr, ", "sr.hi, ").replace("si, ", "si.hi, ")
                               .replace("ur);", "ur.hi);").replace("ui);", "ui.hi);")
                               .replace("negate(ui));", "negate(ui).hi);"))]),
    "A broadcast": ("f32", [("const uint32_t row0 = 16 * (warp & 3) + l.g, row1 = row0 + 8;\n"
                             "  const int n0",
                             "const uint32_t row0 = 16 * (warp & 3), row1 = row0;\n"
                             "  const int n0")]),
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
        "\n        const double* x = p ? sim : sre;\n",
        "\n        const double* x = p ? sim : sre;\n        if (x) {\n"
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
        ("      stage = kLaneDmmaStage;\n    }\n  }\n  *smem",
         "      stage = kLaneDmmaStage;\n    }\n"
         "    if (staged & kStagedLaneU) kernel = fused_run_kernel<T, true>;\n  }\n  *smem"),
        ("  } else if constexpr (kLaneMma) {\n    // one block per SM",
         "  } else if constexpr (kLaneMma && sizeof(T) == 4) {\n    // one block per SM"),
        ("  } else if constexpr (kLaneMma) {\n    for (uint32_t i = 4 * tid;",
         "  } else if constexpr (kLaneMma && sizeof(T) == 4) {\n    for (uint32_t i = 4 * tid;")]),
}


_KACTIVE = ("const bool active = 32 * static_cast<uint32_t>(q) + 16 * static_cast<uint32_t>(warp & 1)"
            " < groups;")
_KSTAGE_OFF = [("  stage_chunk(wbuf, steps, 0, me);\n", ""),
               ("      if (kk < 3 || q + 1 < nq) stage_chunk(", "      if (false) stage_chunk(")]
_KA = ("""          const double xr[4] = {ok0 ? sre[a0 + p0] : 0.0, ok1 ? sre[a1 + p0] : 0.0,
                                ok0 ? sre[a0 + p1] : 0.0, ok1 ? sre[a1 + p1] : 0.0};""",
       """          const double xi[4] = {ok0 ? sim[a0 + p0] : 0.0, ok1 ? sim[a1 + p0] : 0.0,
                                ok0 ? sim[a0 + p1] : 0.0, ok1 ? sim[a1 + p1] : 0.0};""")
_KB = """          const double2 r = *reinterpret_cast<const double2*>(b + 2 * h * kKrausPlane);
          const double2 im = *reinterpret_cast<const double2*>(b + (2 * h + 1) * kKrausPlane);
"""
#: the krausn arm's step, as the source has it: two m16n8k8 a plane
_KSTEP_START = "#pragma unroll\n        for (int h = 0; h < 2; ++h) {\n          // b[0] = S^T"
_KSTEP_END = "          quest_mma::mma_f64(accr, xi, w2);\n        }\n"
#: the same step as one m16n8k16 a plane (all four values of m at once)
_KK16 = """        const double2 r0 = *reinterpret_cast<const double2*>(b);
        const double2 i0 = *reinterpret_cast<const double2*>(b + kKrausPlane);
        const double2 r1 = *reinterpret_cast<const double2*>(b + 2 * kKrausPlane);
        const double2 i1 = *reinterpret_cast<const double2*>(b + 3 * kKrausPlane);
        const double u4[4] = {r0.x, r0.y, r1.x, r1.y}, v4[4] = {i0.x, i0.y, i1.x, i1.y};
        const double w4[4] = {-i0.x, -i0.y, -i1.x, -i1.y};
        const double xr[8] = {ok0 ? sre[a0 + o[0]] : 0.0, ok1 ? sre[a1 + o[0]] : 0.0,
                              ok0 ? sre[a0 + o[1]] : 0.0, ok1 ? sre[a1 + o[1]] : 0.0,
                              ok0 ? sre[a0 + o[2]] : 0.0, ok1 ? sre[a1 + o[2]] : 0.0,
                              ok0 ? sre[a0 + o[3]] : 0.0, ok1 ? sre[a1 + o[3]] : 0.0};
        quest_mma::mma_f64_k16(accr, xr, u4);
        quest_mma::mma_f64_k16(acci, xr, v4);
        const double xi[8] = {ok0 ? sim[a0 + o[0]] : 0.0, ok1 ? sim[a1 + o[0]] : 0.0,
                              ok0 ? sim[a0 + o[1]] : 0.0, ok1 ? sim[a1 + o[1]] : 0.0,
                              ok0 ? sim[a0 + o[2]] : 0.0, ok1 ? sim[a1 + o[2]] : 0.0,
                              ok0 ? sim[a0 + o[3]] : 0.0, ok1 ? sim[a1 + o[3]] : 0.0};
        quest_mma::mma_f64_k16(acci, xi, u4);
        quest_mma::mma_f64_k16(accr, xi, w4);
"""
#: the sweep loop of the arm, as the source has it (groups split in two)
_KSWEEPS_START = "  const int n8 = 8 * (warp >> 1);\n  const int nq = groups > 32 ? 2 : 1;"
_KSWEEPS_END = "        quest_mma::mma_f64(accr, xi, w2);\n        }\n      }\n    }\n    __syncthreads();  // every read of the sweep's groups is done\n    if (active) store_sums(sre, sim, accr, acci, a0 - dt, a1 - dt, ok0, ok1, n8 + 2 * l.t, mask);\n  }\n"
#: the sweeps as lane_u_dmma takes them: over the columns (32 a sweep,
#: streaming all of S^T each time, as this checkout's table holds it), sweep
#: 0's sums held until every read of the tile is done (KEPT: how)
_KCOLUMNS = """  const uint32_t row0 = 16 * (warp & 3) + l.g;
  const int n8 = 8 * (warp >> 2);
  const bool active = 16 * static_cast<uint32_t>(warp & 3) < groups;
  const bool ok0 = row0 < groups, ok1 = row0 + 8 < groups;
  const uint32_t a0 = (ok0 ? insert_zeros(row0, mask) : 0u) + dt;
  const uint32_t a1 = (ok1 ? insert_zeros(row0 + 8, mask) : 0u) + dt;
  double accr[4] = {0.0, 0.0, 0.0, 0.0}, acci[4] = {0.0, 0.0, 0.0, 0.0};
  KEPT double kept[8];
  stage_chunk(wbuf, steps, 0, me);
  quest_mma::async_commit();
  for (int i = 0; i < 8; ++i) {
    quest_mma::async_wait<0>();
    __syncthreads();
    if (i + 1 < 8) stage_chunk(wbuf + (i + 1) % 2 * kChunkPanel, steps, (i + 1) % 4, me);
    quest_mma::async_commit();
    if (active) {
      const int kk = i % 4;
      const uint32_t dk = (kk & 1 ? bit[4] : 0u) + (kk & 2 ? bit[5] : 0u);
      const uint32_t o[4] = {dk, dk + bit[2], dk + bit[3], dk + bit[2] + bit[3]};
      const double* b = wbuf + i % 2 * kChunkPanel + (32 * (i / 4) + n8 + l.g) * 8 + 2 * l.t;
STEP      if (i == 3) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          kept[v] = accr[v];
          kept[4 + v] = acci[v];
          accr[v] = acci[v] = 0.0;
        }
      }
    }
  }
  __syncthreads();
  if (active) {
    const double kr[4] = {kept[0], kept[1], kept[2], kept[3]};
    const double ki[4] = {kept[4], kept[5], kept[6], kept[7]};
    store_sums(sre, sim, kr, ki, a0 - dt, a1 - dt, ok0, ok1, n8 + 2 * l.t, mask);
    store_sums(sre, sim, accr, acci, a0 - dt, a1 - dt, ok0, ok1, 32 + n8 + 2 * l.t, mask);
  }
"""


def _between(src: str, start: str, end: str) -> str:
    """The text of ``src`` from ``start`` to the end of ``end`` (each once)."""
    if src.count(start) != 1 or src.count(end) != 1:
        raise RuntimeError("a variant's anchor is not in the source once")
    i = src.index(start)
    return src[i:src.index(end, i) + len(end)]


def _krausn_variants(src: str) -> dict:
    """The krausn variants whose edits are cut from the source itself:
    (the arm's step, and its sweep loop)."""
    step = _between(src, _KSTEP_START, _KSTEP_END)
    sweeps = _between(src, _KSWEEPS_START, _KSWEEPS_END)
    return {
        "krausn m16n8k16": ("krausn", [(step, _KK16)]),
        "krausn column sweeps": ("krausn", [(sweeps, _KCOLUMNS.replace("KEPT ", "").replace("STEP", step))]),
        "krausn column sweeps, local stash": ("krausn", [(sweeps, _KCOLUMNS.replace(
            "KEPT ", "volatile ").replace("STEP", step))]),
    }


VARIANTS.update({
    "krausn no MMA": ("krausn", [(_KACTIVE, _KACTIVE.replace("= 32", "= false && 32"))]),
    "krausn load and store": ("krausn", [(_KACTIVE, _KACTIVE.replace("= 32", "= false && 32")),
                                         *_KSTAGE_OFF]),
    "krausn no S^T stream": ("krausn", _KSTAGE_OFF),
    "krausn no A loads": ("krausn", [
        (_KA[0], """          const double xr[4] = {static_cast<double>(a0 + p0), static_cast<double>(a1 + p0),
                                static_cast<double>(a0 + p1), static_cast<double>(a1 + p1)};"""),
        (_KA[1], """          const double xi[4] = {static_cast<double>(a0 + p1), static_cast<double>(a1 + p1),
                                static_cast<double>(a0 + p0), static_cast<double>(a1 + p0)};""")]),
    "krausn no B loads": ("krausn", [(_KB, """          const double2 r = make_double2(0.5 * kk, 0.25 * h);
          const double2 im = make_double2(0.75 * h, 0.0625 * kk);
""")]),
    "krausn out of line": ("krausn", [("__device__ __forceinline__ void krausn_dmma(",
                                       "__device__ __noinline__ void krausn_dmma(")]),
})

_K32ACTIVE = "    const bool active = m16 < groups;\n"
_K32STAGE_OFF = [("  stage_chunk(ring, split, 0, me);\n", ""),
                 ("      if (kk < 3 || q + 1 < sweeps) {\n", "      if (false) {\n")]
_K32A = ("""          const float xr[4] = {ok0 ? sre[a0 + e0] : 0.f, ok1 ? sre[a1 + e0] : 0.f,
                               ok0 ? sre[a0 + e4] : 0.f, ok1 ? sre[a1 + e4] : 0.f};""",
         """          const float xi[4] = {ok0 ? sim[a0 + e0] : 0.f, ok1 ? sim[a1 + e0] : 0.f,
                               ok0 ? sim[a0 + e4] : 0.f, ok1 ? sim[a1 + e4] : 0.f};""")
#: the f32 arm's products, as the source has them
_K32MMA = """            quest_mma::mma_3xtf32(accr[j], sr, ur[j]);
            quest_mma::mma_3xtf32(acci[j], sr, ui[j]);"""
_K32MMA_I = """            quest_mma::mma_3xtf32(acci[j], si, ur[j]);
            quest_mma::mma_3xtf32(accr[j], si, quest_mma::negate(ui[j]));"""


def _hi_only(text: str) -> str:
    """mma_3xtf32(c, a, b) as hi(a) lo(b) + hi(a) hi(b): A not split."""
    out = []
    for line in text.splitlines():
        c, a, b = line.strip()[len("quest_mma::mma_3xtf32("):-2].split(", ", 2)
        ind = line[:len(line) - len(line.lstrip())]
        out.append(f"{ind}{{ const quest_mma::SplitB bb = {b};\n"
                   f"{ind}  quest_mma::mma_tf32({c}, {a}.hi, bb.lo);\n"
                   f"{ind}  quest_mma::mma_tf32({c}, {a}.hi, bb.hi); }}")
    return "\n".join(out)


def _swapped(plane: str, text: str) -> str:
    """The A loads of ``text`` (one plane) with lanes of g & 4 loading e4 first."""
    x = plane[1]
    return (f"          const uint32_t f0{x} = (l.g & 4) ? e4 : e0, f1{x} = (l.g & 4) ? e0 : e4;\n"
            f"          const float u0{x} = ok0 ? {plane}[a0 + f0{x}] : 0.f, "
            f"u1{x} = ok1 ? {plane}[a1 + f0{x}] : 0.f;\n"
            f"          const float v0{x} = ok0 ? {plane}[a0 + f1{x}] : 0.f, "
            f"v1{x} = ok1 ? {plane}[a1 + f1{x}] : 0.f;\n"
            + text.split("{")[0] + f"{{(l.g & 4) ? v0{x} : u0{x}, (l.g & 4) ? v1{x} : u1{x}, "
            f"(l.g & 4) ? u0{x} : v0{x}, (l.g & 4) ? u1{x} : v1{x}}};")


VARIANTS.update({
    "krausn32 no MMA": ("krausn32", [(_K32ACTIVE, _K32ACTIVE.replace("= m16", "= false && m16"))]),
    "krausn32 load and store": ("krausn32", [
        (_K32ACTIVE, _K32ACTIVE.replace("= m16", "= false && m16")), *_K32STAGE_OFF]),
    "krausn32 no S^T stream": ("krausn32", _K32STAGE_OFF),
    "krausn32 no A split": ("krausn32", [(_K32MMA, _hi_only(_K32MMA)),
                                          (_K32MMA_I, _hi_only(_K32MMA_I))]),
    "krausn32 A swap": ("krausn32", [(_K32A[0], _swapped("sre", _K32A[0])),
                                      (_K32A[1], _swapped("sim", _K32A[1]))]),
    "krausn32 8 sums": ("krausn32", [("constexpr int kKrausN8 = 2;", "constexpr int kKrausN8 = 1;")]),
    "krausn32 mask held": ("krausn32", [(
        '    asm volatile("mov.b32 %0, %1;" : "=r"(m) : "r"(mask));\n', "    m = mask;\n")]),
    "krausn32 resident S^T": ("krausn32", [
        ("  stage_chunk(ring, split, 0, me);\n  quest_mma::async_commit();\n",
         "  for (int v = me; v < 2048; v += kThreads) {\n"
         "    quest_mma::copy16_async(wbuf + 4 * v, cf + kKrausStepOff + 4 * v);\n  }\n"
         "  quest_mma::async_commit();\n  quest_mma::async_wait<0>();\n  __syncthreads();\n"),
        ("""      quest_mma::async_wait<0>();  // step kk, this thread's part
      __syncthreads();             // every thread's part; the step before consumed
      if (kk < 3 || q + 1 < sweeps) {
        stage_chunk(ring + (kk + 1) % 2 * kChunkPanel, split, (kk + 1) % 4, me);
      }
      quest_mma::async_commit();  // (empty at the end: keeps the wait uniform)
""", ""),
        ("const float* b = wbuf + kk % 2 * (2 * kChunkPanel) + (n0 + l.g) * 16 + 4 * l.t;",
         "const float* b = wbuf + kk * 2048 + (n0 + l.g) * 8 + 2 * l.t;"),
        ("""            ur[j] = quest_mma::load_b_split(b + 2 * h * kKrausSplitPlane + 128 * j);
            ui[j] = quest_mma::load_b_split(b + (2 * h + 1) * kKrausSplitPlane + 128 * j);
""", """            const float2 r = *reinterpret_cast<const float2*>(b + 2 * h * 512 + 64 * j);
            const float2 im = *reinterpret_cast<const float2*>(b + (2 * h + 1) * 512 + 64 * j);
            quest_mma::split_tf32(r.x, ur[j].hi[0], ur[j].lo[0]);
            quest_mma::split_tf32(r.y, ur[j].hi[1], ur[j].lo[1]);
            quest_mma::split_tf32(im.x, ui[j].hi[0], ui[j].lo[0]);
            quest_mma::split_tf32(im.y, ui[j].hi[1], ui[j].lo[1]);
""")]),
    "krausn32 one block per SM": ("krausn32", [
        ("    } else if (staged & (kStagedKrausN | kStagedWindow | kStagedDiag)) {\n"
         "      stage = kLaneDmmaStage;\n",
         "    } else if (staged & (kStagedKrausN | kStagedWindow | kStagedDiag)) {\n"
         "      kernel = fused_run_kernel<T, true>;\n      stage = kLaneDmmaStage;\n"),
        ("krausn_mma<kLaneMma ? 1 : kKrausN8>(", "krausn_mma<kKrausN8>(")]),
})

_WSTEPS = "  for (int ks = 0; ks < ksteps; ++ks) {\n    // b[0] = X"
_WSTAGE = "  for (int v = tid; v < 16 * D * mtiles; v += kThreads) {"
_WA = """        const double* a = wbuf + (mt * ksteps + ks) * 256 + 2 * lane;
        const double2 r0 = *reinterpret_cast<const double2*>(a);
        const double2 r1 = *reinterpret_cast<const double2*>(a + 64);
"""
_WAI = """        const double2 i0 = *reinterpret_cast<const double2*>(a + 128);
        const double2 i1 = *reinterpret_cast<const double2*>(a + 192);
"""
_WB = """    const int e0 = ((8 * ks + l.t) << kLaneBits) + col;
    const double xr[2] = {sre[e0], sre[e0 + (4 << kLaneBits)]};
    const double xi[2] = {sim[e0], sim[e0 + (4 << kLaneBits)]};
"""
#: the warp's 8 rows x 8 columns of a k step, both planes, copied into its
#: 1 KiB of the second chunk buffer (rows of 8, the columns' halves swapped
#: in rows with bit 1 set: the B loads then hit 16 different bank pairs a
#: half warp), then the B fragments read from there
_WB_PADDED = """    double* pad = wbuf + kChunkPanel + 128 * (me >> 5);
    __syncwarp();  // the step before read its copy
    {
      const int r = lane >> 2, c = 2 * (lane & 3);
      const int src = ((8 * ks + r) << kLaneBits) + 8 * (me >> 5) + c;
      const int dst = 8 * r + (c ^ (r & 2 ? 4 : 0));
      *reinterpret_cast<double2*>(pad + dst) = *reinterpret_cast<const double2*>(sre + src);
      *reinterpret_cast<double2*>(pad + 64 + dst) = *reinterpret_cast<const double2*>(sim + src);
    }
    __syncwarp();
    const int p0 = 8 * l.t + (l.g ^ (l.t & 2 ? 4 : 0));
    const double xr[2] = {pad[p0], pad[p0 + 32]};
    const double xi[2] = {pad[64 + p0], pad[96 + p0]};
"""
#: the arm with U^T as the B operand and X as A (window_dot.cu's layout):
#: out^T = X^T U^T, M = b (warp w: the m16 tile of columns 16 (w & 7)), N =
#: d (n8 tiles w >> 3 and (w >> 3) + 2), U staged unpermuted from the
#: op's block with rows padded to D + 4; two warps read each column, so
#: the writes wait for a block barrier
_WINDOW_UT = """__device__ __forceinline__ void window_dmma(double* sre, double* sim, double* wbuf,
                                            const double* __restrict__ cf, int span,
                                            int tid) {
  const int D = 1 << span, ld = D + 4;
  for (int v = tid; v < 2 * D * D; v += kThreads) {
    const int p = v / (D * D), e = v % (D * D);
    wbuf[(p * D + e / D) * ld + e % D] = cf[v];
  }
  __syncthreads();
  const int warp = tid >> 5;
  const quest_mma::Lane l = quest_mma::lane_coords();
  const int m0 = 16 * (warp & 7), half = warp >> 3;
  const int nj = D > 16 ? 2 : 1;
  const bool active = D > 8 || half == 0;
  double accr[2][4], acci[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) accr[j][i] = acci[j][i] = 0.0;
  if (active) {
    for (int ks = 0; ks < D / 8; ++ks) {
      double ar[4], ai[4];
      quest_mma::load_a_pairs(sre + ((8 * ks) << kLaneBits) + m0, kLanes, l, ar);
      quest_mma::load_a_pairs(sim + ((8 * ks) << kLaneBits) + m0, kLanes, l, ai);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j < nj) {
          const int n0 = 8 * (half + 2 * j);
          double br[2], bi[2];
          quest_mma::load_b_nmajor(wbuf + n0 * ld + 8 * ks, ld, l, br);
          quest_mma::load_b_nmajor(wbuf + (D + n0) * ld + 8 * ks, ld, l, bi);
          const double nbi[2] = {-bi[0], -bi[1]};
          quest_mma::mma_f64(accr[j], ar, br);
          quest_mma::mma_f64(accr[j], ai, nbi);
          quest_mma::mma_f64(acci[j], ar, bi);
          quest_mma::mma_f64(acci[j], ai, br);
        }
      }
    }
  }
  __syncthreads();  // every read of the tile is done
  if (active) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j < nj) {
        const int n0 = 8 * (half + 2 * j);
        quest_mma::store_c_pairs(sre + (n0 << kLaneBits) + m0, kLanes, l, accr[j]);
        quest_mma::store_c_pairs(sim + (n0 << kLaneBits) + m0, kLanes, l, acci[j]);
      }
    }
  }
}
"""
_WDMMA_START = "__device__ __forceinline__ void window_dmma("


def _window_variants(src: str) -> dict:
    """The window64 variant that replaces the whole arm (cut from the
    source itself: from its signature to the end of its body)."""
    if src.count(_WDMMA_START) != 1:
        raise RuntimeError("the window arm's anchor is not in the source once")
    i = src.index(_WDMMA_START)
    arm = src[i:src.index("\n}\n", i) + 2]
    return {"window64 U^T as B": ("window64", [(arm, _WINDOW_UT.rstrip("\n"))])}


VARIANTS.update({
    "window64 no MMA": ("window64", [(_WSTEPS, _WSTEPS.replace("ks < ksteps", "ks < 0"))]),
    "window64 load and store": ("window64", [
        (_WSTEPS, _WSTEPS.replace("ks < ksteps", "ks < 0")),
        (_WSTAGE, _WSTAGE.replace("v < 16 * D * mtiles", "v < 0"))]),
    "window64 no U stage": ("window64", [
        (_WSTAGE, _WSTAGE.replace("v < 16 * D * mtiles", "v < 0")),
        (_WA, _WA.replace("wbuf + (mt", "table + (mt").replace(
            "*reinterpret_cast<const double2*>(", "__ldg(reinterpret_cast<const double2*>(")
         .replace("(a);", "(a));").replace("(a + 64);", "(a + 64));")),
        (_WAI, _WAI.replace("*reinterpret_cast<const double2*>(",
                            "__ldg(reinterpret_cast<const double2*>(")
         .replace("(a + 128);", "(a + 128));").replace("(a + 192);", "(a + 192));"))]),
    "window64 X through padded rows": ("window64", [(_WB, _WB_PADDED)]),
    "window64 out of line": ("window64", [(_WDMMA_START,
                                           "__device__ __noinline__ void window_dmma(")]),
    "window64 offset left to the compiler": ("window64", [("  volatile int out0[1];\n",
                                                           "  int out0[1];\n")]),
    "window64 k loop unrolled": ("window64", [("#pragma unroll 1\n  for (int ks = 0;",
                                               "  for (int ks = 0;")]),
    "window64 without the FMA arm": ("window64", [(
        "          window_op<T, 2, 1>(sre, sim, tile, cf, lo, span, tid);\n",
        "          __trap();\n")]),
    "window64 offset found again": ("window64", [
        ("  volatile int out0[1];\n"
         "  out0[0] = (((me & 31) >> 2) << kLaneBits) + 8 * (me >> 5) + 2 * (me & 3);\n", ""),
        ("  const int o = out0[0];\n",
         "  asm volatile(\"mov.b32 %0, %1;\" : \"=r\"(me) : \"r\"(tid));\n"
         "  const int o = (((me & 31) >> 2) << kLaneBits) + 8 * (me >> 5) + 2 * (me & 3);\n")]),
})

_W32STEPS = "    for (int ks = 0; ks < ksteps; ++ks) {\n      // b[0] = X[8 ks + t][b0 + g]"
_W32STAGE = "  for (int v = tid; v < 64 * mtiles * ksteps; v += kThreads) {"
_W32B = """      const uint32_t e = x0 + (static_cast<uint32_t>(8 * ks) << lo);
      const quest_mma::SplitB br = quest_mma::split_b(sre[e], sre[e + (4u << lo)]);
      const quest_mma::SplitB bi = quest_mma::split_b(sim[e], sim[e + (4u << lo)]);
"""
#: the warp's 8 rows x 8 columns of a k step, both planes, copied into its
#: 512 bytes after the table (rows of 8 floats: lane (g, t)'s B values then
#: sit at 8 t + g and 8 (t + 4) + g, 32 banks), then read from there
_W32B_PADDED = """      float* pad = wbuf + 4096 + 128 * (me >> 5);
      __syncwarp();  // the step before read its copy
      {
        const int q = lane & 15, r = q >> 1, c = 4 * (q & 1);
        const float* src = (lane < 16 ? sre : sim) + base + ((8 * ks + r) << lo) + c;
        *reinterpret_cast<float4*>(pad + 64 * (lane >> 4) + 8 * r + c) =
            *reinterpret_cast<const float4*>(src);
      }
      __syncwarp();
      const int p0 = 8 * l.t + l.g;
      const quest_mma::SplitB br = quest_mma::split_b(pad[p0], pad[p0 + 32]);
      const quest_mma::SplitB bi = quest_mma::split_b(pad[64 + p0], pad[96 + p0]);
"""
_W32KLOOP = ("#pragma unroll 1\n    for (int ks = 0; ks < ksteps; ++ks) {\n"
             "      // b[0] = X[8 ks + t][b0 + g], b[1] = X[8 ks + t + 4][b0 + g]\n" + _W32B)
#: the next k step's B values loaded before this step's products
_W32KLOOP_PREFETCH = """    float r0 = sre[x0], r1 = sre[x0 + (4u << lo)], i0 = sim[x0], i1 = sim[x0 + (4u << lo)];
#pragma unroll 1
    for (int ks = 0; ks < ksteps; ++ks) {
      const quest_mma::SplitB br = quest_mma::split_b(r0, r1);
      const quest_mma::SplitB bi = quest_mma::split_b(i0, i1);
      if (ks + 1 < ksteps) {
        const uint32_t e = x0 + (static_cast<uint32_t>(8 * ks + 8) << lo);
        r0 = sre[e];
        r1 = sre[e + (4u << lo)];
        i0 = sim[e];
        i1 = sim[e + (4u << lo)];
      }
"""
_W32STAGE_START = "  // one thread a (mt, ks, plane, lane): its four values, split\n"
_W32STAGE_END = "  __syncthreads();  // every thread's part of the split table\n"
#: the table copied from the host's (after U in the variant's coefficients)
_W32STAGE_HOST = """  for (int v = tid; v < 128 * mtiles * ksteps; v += kThreads) {
    quest_mma::copy16_async(wbuf + 4 * v, cf + 2 * D * D + 4 * v);
  }
  quest_mma::async_commit();
  quest_mma::async_wait<0>();
  __syncthreads();
"""
#: the arm with U^T as the B operand and X^T as A (window_dot.cu's and
#: krausn_mma's layout): out^T = X^T U^T, M = b (a warp: one slab's m16
#: block of 16 columns), N = d (all D / 8 n8 tiles: 32 sums a thread at D =
#: 32), X^T split in registers, U^T split by the kernel as it stages it
#: into B-fragment order (per n8 tile j, per k8 step, per plane, per lane
#: hi(U[8 j + g][8 ks + t]), hi(U[..][.. + 4]), lo(..), lo(..))
_WINDOW32_UT = """__device__ __forceinline__ void window_mma(float* sre, float* sim, float* wbuf, uint32_t tile,
                                           const float* __restrict__ cf, int lo, int span,
                                           int tid) {
  const int D = 1 << span;
  const int ksteps = D >> 3;
  quest_mma::async_wait<0>();
  for (int v = tid; v < 64 * ksteps * ksteps; v += kThreads) {
    const int lane = v & 31, plane = (v >> 5) & 1, jk = v >> 6;
    const int d = 8 * (jk >> (span - 3)) + (lane >> 2);
    const int e = 8 * (jk & (ksteps - 1)) + (lane & 3);
    const float* u = cf + plane * D * D + d * D + e;
    uint32_t h0, l0, h1, l1;
    quest_mma::split_tf32(__ldg(u), h0, l0);
    quest_mma::split_tf32(__ldg(u + 4), h1, l1);
    *reinterpret_cast<uint4*>(wbuf + jk * 256 + plane * 128 + 4 * lane) = make_uint4(h0, h1, l0, l1);
  }
  __syncthreads();
  int me;
  asm volatile("mov.b32 %0, %1;" : "=r"(me) : "r"(tid));
  const int lane = me & 31;
  const quest_mma::Lane l = {lane >> 2, lane & 3};
  const uint32_t items = tile >> (span + 4);
  const int nb = lo - 4, nj = D >> 3;
#pragma unroll 1
  for (uint32_t it = me >> 5; it < items; it += kThreads / 32) {
    const uint32_t base = ((it >> nb) << (lo + span)) | ((it & ((1u << nb) - 1)) << 4);
    const uint32_t x0 = base + (static_cast<uint32_t>(l.t) << lo) + l.g;
    float accr[4][4], acci[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) accr[j][i] = acci[j][i] = 0.f;
#pragma unroll 1
    for (int ks = 0; ks < ksteps; ++ks) {
      const uint32_t e = x0 + (static_cast<uint32_t>(8 * ks) << lo), e4 = e + (4u << lo);
      const float ar[4] = {sre[e], sre[e + 8], sre[e4], sre[e4 + 8]};
      const float ai[4] = {sim[e], sim[e + 8], sim[e4], sim[e4 + 8]};
      const quest_mma::SplitA sr = quest_mma::split_a(ar);
      const quest_mma::SplitA si = quest_mma::split_a(ai);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < nj) {
          const float* b = wbuf + (j * ksteps + ks) * 256 + 4 * lane;
          const quest_mma::SplitB ur = quest_mma::load_b_split(b);
          const quest_mma::SplitB ui = quest_mma::load_b_split(b + 128);
          quest_mma::mma_3xtf32(accr[j], sr, ur);
          quest_mma::mma_3xtf32(accr[j], si, quest_mma::negate(ui));
          quest_mma::mma_3xtf32(acci[j], sr, ui);
          quest_mma::mma_3xtf32(acci[j], si, ur);
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < nj) {
        const uint32_t o = base + (static_cast<uint32_t>(8 * j + 2 * l.t) << lo) + l.g;
        sre[o] = accr[j][0];
        sre[o + (1u << lo)] = accr[j][1];
        sre[o + 8] = accr[j][2];
        sre[o + (1u << lo) + 8] = accr[j][3];
        sim[o] = acci[j][0];
        sim[o + (1u << lo)] = acci[j][1];
        sim[o + 8] = acci[j][2];
        sim[o + (1u << lo) + 8] = acci[j][3];
      }
    }
  }
}"""
_W32_START = "__device__ __forceinline__ void window_mma("
#: the arm's item loop, as the source has it
_W32ITEMS_START = "#pragma unroll 1\n  for (uint32_t it = me >> 5; it < items; it += kThreads / 32) {\n"
_W32ITEMS_END = """          *reinterpret_cast<float2*>(sim + o1) = make_float2(acci[mt][2], acci[mt][3]);
        }
      }
    }
  }
"""
#: both of a warp's items (slabs, at the 2^13 tile) in one k loop: each A
#: fragment feeds both, 32 sums a thread at D = 32
_W32TWO_ITEMS = """#pragma unroll 1
  for (uint32_t it0 = me >> 5; it0 < items; it0 += 2 * (kThreads / 32)) {
    const bool two = it0 + kThreads / 32 < items;
    uint32_t base[2], x0[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint32_t it = it0 + q * (kThreads / 32);
      base[q] = ((it >> nb) << (lo + span)) | ((it & ((1u << nb) - 1)) << 3);
      x0[q] = base[q] + (static_cast<uint32_t>(l.t) << lo) + l.g;
    }
    float accr[2][2][4], acci[2][2][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) accr[q][mt][i] = acci[q][mt][i] = 0.f;
#pragma unroll 1
    for (int ks = 0; ks < ksteps; ++ks) {
      quest_mma::SplitB br[2], bi[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint32_t e = (two || q == 0 ? x0[q] : x0[0]) + (static_cast<uint32_t>(8 * ks) << lo);
        br[q] = quest_mma::split_b(sre[e], sre[e + (4u << lo)]);
        bi[q] = quest_mma::split_b(sim[e], sim[e + (4u << lo)]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt < mtiles) {
          const float* a = table + (mt * ksteps + ks) * kWinStep;
          const quest_mma::SplitA ur = quest_mma::load_a_split(a, a + 128);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            quest_mma::mma_3xtf32(accr[q][mt], ur, br[q]);
            quest_mma::mma_3xtf32(acci[q][mt], ur, bi[q]);
          }
          const quest_mma::SplitA ui = quest_mma::load_a_split(a + 256, a + 384);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            quest_mma::mma_3xtf32(acci[q][mt], ui, br[q]);
            quest_mma::mma_3xtf32(accr[q][mt], ui, quest_mma::negate(bi[q]));
          }
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (q == 0 || two) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (mt < mtiles) {
            const uint32_t o0 = base[q] + (static_cast<uint32_t>(16 * mt + l.g) << lo) + 2 * l.t;
            const uint32_t o1 = o0 + (8u << lo);
            *reinterpret_cast<float2*>(sre + o0) = make_float2(accr[q][mt][0], accr[q][mt][1]);
            *reinterpret_cast<float2*>(sim + o0) = make_float2(acci[q][mt][0], acci[q][mt][1]);
            if (D > 8) {
              *reinterpret_cast<float2*>(sre + o1) = make_float2(accr[q][mt][2], accr[q][mt][3]);
              *reinterpret_cast<float2*>(sim + o1) = make_float2(acci[q][mt][2], acci[q][mt][3]);
            }
          }
        }
      }
    }
  }
"""
#: the arm's products of an (mt, ks), as the source has them
_W32MMA = """          quest_mma::mma_3xtf32(accr[mt], ur, br);
          quest_mma::mma_3xtf32(acci[mt], ur, bi);
          const quest_mma::SplitA ui = quest_mma::load_a_split(a + 256, a + 384);
          quest_mma::mma_3xtf32(acci[mt], ui, br);
          quest_mma::mma_3xtf32(accr[mt], ui, quest_mma::negate(bi));
"""
#: the arm with three real products, not four (Gauss's: Ur xr, Ui xi and
#: (Ur + Ui)(xr + xi), out_r = the first less the second, out_i = the
#: third less both): the table holds Ur, Ui and Ur + Ui split (24 KiB at D
#: = 32), B is xr, xi and xr + xi split in registers, 24 sums a thread
_WINDOW32_GAUSS = """__device__ __forceinline__ void window_mma(float* sre, float* sim, float* wbuf, uint32_t tile,
                                           const float* __restrict__ cf, int lo, int span,
                                           int tid) {
  const int D = 1 << span;
  const int ksteps = D >> 3, mtiles = D > 16 ? 2 : 1;
  quest_mma::async_wait<0>();
  for (int v = tid; v < 96 * mtiles * ksteps; v += kThreads) {
    const int lane = v & 31, plane = (v >> 5) % 3, mk = v / 96;
    const int d0 = 16 * (mk >> (span - 3)) + (lane >> 2);
    const int e0 = 8 * (mk & (ksteps - 1)) + (lane & 3);
    const bool pad = d0 + 8 >= D;
    float a[4];
    for (int i = 0; i < 4; ++i) {
      const int at = (d0 + 8 * (i & 1)) * D + e0 + 4 * (i >> 1);
      const float r = __ldg(cf + at), im = __ldg(cf + D * D + at);
      a[i] = (pad && (i & 1)) ? 0.f : plane == 0 ? r : plane == 1 ? im : r + im;
    }
    const quest_mma::SplitA s = quest_mma::split_a(a);
    float* p = wbuf + mk * 768 + plane * 256 + 4 * lane;
    *reinterpret_cast<uint4*>(p) = make_uint4(s.hi[0], s.hi[1], s.hi[2], s.hi[3]);
    *reinterpret_cast<uint4*>(p + 128) = make_uint4(s.lo[0], s.lo[1], s.lo[2], s.lo[3]);
  }
  __syncthreads();
  int me;
  asm volatile("mov.b32 %0, %1;" : "=r"(me) : "r"(tid));
  const int lane = me & 31;
  const quest_mma::Lane l = {lane >> 2, lane & 3};
  const uint32_t items = tile >> (span + 3);
  const int nb = lo - 3;
  const float* table = wbuf + 4 * lane;
#pragma unroll 1
  for (uint32_t it = me >> 5; it < items; it += kThreads / 32) {
    const uint32_t base = ((it >> nb) << (lo + span)) | ((it & ((1u << nb) - 1)) << 3);
    const uint32_t x0 = base + (static_cast<uint32_t>(l.t) << lo) + l.g;
    float c1[2][4], c2[2][4], c3[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) c1[mt][i] = c2[mt][i] = c3[mt][i] = 0.f;
#pragma unroll 1
    for (int ks = 0; ks < ksteps; ++ks) {
      const uint32_t e = x0 + (static_cast<uint32_t>(8 * ks) << lo);
      const float r0 = sre[e], r1 = sre[e + (4u << lo)], i0 = sim[e], i1 = sim[e + (4u << lo)];
      const quest_mma::SplitB br = quest_mma::split_b(r0, r1);
      const quest_mma::SplitB bi = quest_mma::split_b(i0, i1);
      const quest_mma::SplitB bs = quest_mma::split_b(r0 + i0, r1 + i1);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt < mtiles) {
          const float* a = table + (mt * ksteps + ks) * 768;
          quest_mma::mma_3xtf32(c1[mt], quest_mma::load_a_split(a, a + 128), br);
          quest_mma::mma_3xtf32(c2[mt], quest_mma::load_a_split(a + 256, a + 384), bi);
          quest_mma::mma_3xtf32(c3[mt], quest_mma::load_a_split(a + 512, a + 640), bs);
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (mt < mtiles) {
        const uint32_t o0 = base + (static_cast<uint32_t>(16 * mt + l.g) << lo) + 2 * l.t;
        const uint32_t o1 = o0 + (8u << lo);
        *reinterpret_cast<float2*>(sre + o0) = make_float2(c1[mt][0] - c2[mt][0], c1[mt][1] - c2[mt][1]);
        *reinterpret_cast<float2*>(sim + o0) = make_float2(c3[mt][0] - c1[mt][0] - c2[mt][0],
                                                           c3[mt][1] - c1[mt][1] - c2[mt][1]);
        if (D > 8) {
          *reinterpret_cast<float2*>(sre + o1) = make_float2(c1[mt][2] - c2[mt][2], c1[mt][3] - c2[mt][3]);
          *reinterpret_cast<float2*>(sim + o1) = make_float2(c3[mt][2] - c1[mt][2] - c2[mt][2],
                                                             c3[mt][3] - c1[mt][3] - c2[mt][3]);
        }
      }
    }
  }
}"""


def window_split_table(u_block, span: int):
    """The table ``window_mma`` stages (``csrc/fused_gates.cu``), built on
    the host (the ``window32 U split by the host`` variant's, and the CPU
    tests' model of the kernel's): U (``u_block``: U real then imaginary,
    D x D each, D = 2^span, span 3 to 5) rounded to float32 and split by
    ``tf32_split``, per m16 tile mt, per k8 step ks, per plane, hi then lo,
    per lane (g, t) = divmod(lane, 4) the four A values U[16 mt + g + 8 (i
    & 1)][8 ks + t + 4 (i >> 1)], i = 0..3, 0 past D. Float32, (max(D /
    16, 1), D / 8, 2, 2, 32, 4)."""
    import numpy as np

    from quest_tpu_torch.ops.fused_gates import tf32_split

    D = 1 << span
    mt = max(D // 16, 1)
    u = np.asarray(u_block, dtype=np.float32).reshape(2, D, D)
    u = np.concatenate([u, np.zeros((2, 16 * mt - D, D), np.float32)], axis=1)
    # rows 16 mt + 8 j + g, columns 8 ks + 4 h + t, i = 2 h + j:
    # (plane, mt, j, g, ks, h, t) -> (mt, ks, plane, g, t, h, j)
    a = u.reshape(2, mt, 2, 8, D // 8, 2, 4).transpose(1, 4, 0, 3, 6, 5, 2)
    hi, lo = tf32_split(a.reshape(mt, D // 8, 2, 32, 4))
    return np.stack([hi, lo], axis=3)


VARIANTS.update({
    "window32 no MMA": ("window32", [(_W32STEPS, _W32STEPS.replace("ks < ksteps", "ks < 0"))]),
    "window32 load and store": ("window32", [
        (_W32STEPS, _W32STEPS.replace("ks < ksteps", "ks < 0")),
        (_W32STAGE, _W32STAGE.replace("v < 64 * mtiles * ksteps", "v < 0"))]),
    "window32 no A loads": ("window32", [
        ("quest_mma::load_a_split(a, a + 128)",
         "quest_mma::SplitA{{1u * ks, 2u, 3u, 4u}, {5u, 6u, 7u, 8u * mt}}"),
        ("quest_mma::load_a_split(a + 256, a + 384)",
         "quest_mma::SplitA{{2u * ks, 3u, 4u, 5u}, {6u, 7u, 8u, 9u * mt}}")]),
    "window32 X through padded rows": ("window32", [(_W32B, _W32B_PADDED)]),
    "window32 k loop unrolled": ("window32", [("#pragma unroll 1\n    for (int ks = 0;",
                                               "    for (int ks = 0;")]),
    "window32 one TF32 term": ("window32", [(_W32MMA, _W32MMA.replace(
        "mma_3xtf32(accr[mt], ur, br)", "mma_tf32(accr[mt], ur.hi, br.hi)").replace(
        "mma_3xtf32(acci[mt], ur, bi)", "mma_tf32(acci[mt], ur.hi, bi.hi)").replace(
        "mma_3xtf32(acci[mt], ui, br)", "mma_tf32(acci[mt], ui.hi, br.hi)").replace(
        "mma_3xtf32(accr[mt], ui, quest_mma::negate(bi))",
        "mma_tf32(accr[mt], ui.hi, quest_mma::negate(bi).hi)"))]),
    "window32 no B loads": ("window32", [(_W32B, _W32B.replace(
        "split_b(sre[e], sre[e + (4u << lo)])", "split_b(__uint_as_float(e), __uint_as_float(e + 1))")
        .replace("split_b(sim[e], sim[e + (4u << lo)])",
                 "split_b(__uint_as_float(e + 2), __uint_as_float(e + 3))"))]),
    "window32 B prefetch": ("window32", [(_W32KLOOP, _W32KLOOP_PREFETCH)]),
    "window32 no stage": ("window32", [
        (_W32STAGE, _W32STAGE.replace("v < 64 * mtiles * ksteps", "v < 0"))]),
})

_DIAG_HELD = "constexpr int kDiagHeld32 = 16;\nconstexpr int kDiagHeld64 = 4;"


def _diag_held(f32: int, f64: int) -> str:
    return f"constexpr int kDiagHeld32 = {f32};\nconstexpr int kDiagHeld64 = {f64};"


_DIAG_CALL = "__device__ __forceinline__ int diag_sweep("
_DIAG_MUL = "            cmul_into(xr[g], xi[g], f.x, f.y);"
_DIAG_RECS = "      for (int k = 0; k < n; ++k) {\n        const DiagRec& m = meta[k];"
for _arm, _held in (("diag32", ((8, 4), (4, 4))), ("diag64", ((16, 8), (16, 2)))):
    VARIANTS.update({
        f"{_arm} out of line": (_arm, [(_DIAG_CALL, _DIAG_CALL.replace("__forceinline__",
                                                                       "__noinline__"))]),
        f"{_arm} no multiply": (_arm, [(_DIAG_MUL, "            xr[g] += f.x;")]),
        f"{_arm} load and store": (_arm, [(_DIAG_RECS, _DIAG_RECS.replace("k < n", "k < 0"))]),
    })
    for _h in _held:
        VARIANTS[f"{_arm} held {_h[_arm == 'diag64']}"] = (_arm, [(_DIAG_HELD, _diag_held(*_h))])


_SWEEP_LOOP = "    for (int k = 0; k < count; ++k) {\n      const long long* r = r0 + kRec * k;"
_SWEEP_2X2 = ("        reg_2x2_on<T, W>(static_cast<int>(r[7] >> 1) & 3, j1, xr, xi, coeffs + r[6], "
              "cm, cv);\n")
_SWEEP_LONE_2X2 = "      reg_2x2_form<T, 1, 0>(form, xr, xi, cf, 0u, 0u);\n"
_SWEEP_FORM = "const int form = static_cast<int>(r[7] >> 1) & 3;"
_SWEEP_BITS = "return sizeof(T) == 4 ? 3 : 2;"

#: the sweep widths built as variants, a pass
SWEEP_WIDTHS = {"sweep32": (2, 4), "sweep64": (3,)}
for _arm in ("sweep32", "sweep64"):
    VARIANTS.update({
        f"{_arm} load and store": (_arm, [
            (_SWEEP_LOOP, _SWEEP_LOOP.replace("k < count", "k < 0")), (_SWEEP_LONE_2X2, "")]),
        f"{_arm} no 2x2": (_arm, [(_SWEEP_2X2, ""), (_SWEEP_LONE_2X2, "")]),
        f"{_arm} general form": (_arm, [
            (_SWEEP_2X2, _SWEEP_2X2.replace("static_cast<int>(r[7] >> 1) & 3", "0")),
            (_SWEEP_FORM, "const int form = 0;")]),
    })
    for _w in SWEEP_WIDTHS[_arm]:
        VARIANTS[f"{_arm} width {_w}"] = (_arm, [(_SWEEP_BITS, (
            f"return sizeof(T) == 4 ? {_w} : 2;" if _arm == "sweep32"
            else f"return sizeof(T) == 4 ? 3 : {_w};"))])


def _window32_variants(src: str) -> dict:
    """The window32 variants cut from the source itself: the whole arm, and
    its stage."""
    if src.count(_W32_START) != 1:
        raise RuntimeError("the f32 window arm's anchor is not in the source once")
    i = src.index(_W32_START)
    arm = src[i:src.index("\n}\n", i) + 2]
    stage = _between(src, _W32STAGE_START, _W32STAGE_END)
    return {"window32 U^T as B": ("window32", [(arm, _WINDOW32_UT)]),
            "window32 three products": ("window32", [(arm, _WINDOW32_GAUSS)]),
            "window32 two items at once": ("window32", [
                (_between(src, _W32ITEMS_START, _W32ITEMS_END), _W32TWO_ITEMS)]),
            "window32 U split by the host": ("window32", [(stage, _W32STAGE_HOST)])}


#: the variants that compute the same as the kernel (checked like it)
RIGHT = {"interleaved", "f64 m16n8k8", "f64 ring of 3", "f64 one block per SM",
         "krausn m16n8k16", "krausn out of line", "krausn column sweeps",
         "krausn column sweeps, local stash", "krausn32 A swap", "krausn32 8 sums",
         "krausn32 mask held", "krausn32 resident S^T", "krausn32 one block per SM",
         "window64 no U stage", "window64 X through padded rows", "window64 U^T as B",
         "window64 out of line", "window64 offset left to the compiler",
         "window64 offset found again", "window64 without the FMA arm",
         "window64 k loop unrolled", "window32 X through padded rows", "window32 U^T as B",
         "window32 U split by the host", "window32 k loop unrolled", "window32 three products",
         "window32 two items at once", "window32 B prefetch"} | {
             f"{a} {v}" for a in ("diag32", "diag64")
             for v in ("out of line", "held 8", "held 4", "held 2")} - {"diag32 held 2",
                                                                          "diag64 held 4"} | {
             f"{a} {v}" for a in SWEEP_WIDTHS
             for v in ("general form",)} | {
             f"{a} width {w}" for a, ws in SWEEP_WIDTHS.items() for w in ws}


#: the 3xTF32 accumulation walks that ``drift32`` compares, each a body of
#: ``quest_mma::mma_3xtf32`` (``csrc/mma.cuh``): name -> body
_WALKS = {
    "(a) chained": """  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
""",
    "(b) each product apart": """  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(d, a.lo, b.hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c[i] += d[i];
    d[i] = 0.f;
  }
  mma_tf32(d, a.hi, b.lo);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c[i] += d[i];
    d[i] = 0.f;
  }
  mma_tf32(d, a.hi, b.hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += d[i];
""",
    "(e) one fragment a step": """  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += d[i];
""",
}
_WALKS["(f) hi*hi's truncation recovered"] = """  float d[4] = {0.f, 0.f, 0.f, 0.f}, r[4];
  mma_tf32(d, a.hi, b.hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = -d[i];
  mma_tf32(r, a.hi, b.hi);
  mma_tf32(r, a.lo, b.hi);
  mma_tf32(r, a.hi, b.lo);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += d[i] + r[i];
"""
#: (c): hi*hi into a zeroed fragment added to c, the small terms chained
#: in a second accumulator s that the arm adds to c before its store
_WALK_TWO_ACC = """
__device__ __forceinline__ void mma_3xtf32_two(float c[4], float s[4], const SplitA& a,
                                               const SplitB& b) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(d, a.hi, b.hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += d[i];
  mma_tf32(s, a.lo, b.hi);
  mma_tf32(s, a.hi, b.lo);
}
"""
_MMA_SIG = ("__device__ __forceinline__ void mma_3xtf32(float c[4], const SplitA& a, "
            "const SplitB& b) {\n")
_SPLIT_LO = "  lo = __float_as_uint(x - __uint_as_float(hi));\n"
#: the lane_u and window arms with a second accumulator, for (c)
_TWO_ACC_EDITS = [
    ("float accr[4][4], acci[4][4];", "float accr[4][4], acci[4][4], sacr[4][4], saci[4][4];"),
    ("\n    for (int i = 0; i < 4; ++i) accr[j][i] = acci[j][i] = 0.f;",
     "\n    for (int i = 0; i < 4; ++i) accr[j][i] = acci[j][i] = sacr[j][i] = saci[j][i] = 0.f;"),
    ("quest_mma::mma_3xtf32(accr[j], sr, ur);", "quest_mma::mma_3xtf32_two(accr[j], sacr[j], sr, ur);"),
    ("quest_mma::mma_3xtf32(accr[j], si, quest_mma::negate(ui));",
     "quest_mma::mma_3xtf32_two(accr[j], sacr[j], si, quest_mma::negate(ui));"),
    ("quest_mma::mma_3xtf32(acci[j], sr, ui);", "quest_mma::mma_3xtf32_two(acci[j], saci[j], sr, ui);"),
    ("quest_mma::mma_3xtf32(acci[j], si, ur);", "quest_mma::mma_3xtf32_two(acci[j], saci[j], si, ur);"),
    ("      const int col = n0 + 8 * j + 2 * l.t;\n",
     "      for (int i = 0; i < 4; ++i) {\n        accr[j][i] += sacr[j][i];\n"
     "        acci[j][i] += saci[j][i];\n      }\n      const int col = n0 + 8 * j + 2 * l.t;\n"),
    ("float accr[2][4], acci[2][4];", "float accr[2][4], acci[2][4], sacr[2][4], saci[2][4];"),
    ("for (int i = 0; i < 4; ++i) accr[mt][i] = acci[mt][i] = 0.f;",
     "for (int i = 0; i < 4; ++i) accr[mt][i] = acci[mt][i] = sacr[mt][i] = saci[mt][i] = 0.f;"),
    ("quest_mma::mma_3xtf32(accr[mt], ur, br);", "quest_mma::mma_3xtf32_two(accr[mt], sacr[mt], ur, br);"),
    ("quest_mma::mma_3xtf32(acci[mt], ur, bi);", "quest_mma::mma_3xtf32_two(acci[mt], saci[mt], ur, bi);"),
    ("quest_mma::mma_3xtf32(acci[mt], ui, br);", "quest_mma::mma_3xtf32_two(acci[mt], saci[mt], ui, br);"),
    ("quest_mma::mma_3xtf32(accr[mt], ui, quest_mma::negate(bi));",
     "quest_mma::mma_3xtf32_two(accr[mt], sacr[mt], ui, quest_mma::negate(bi));"),
    ("        const uint32_t o0 = base + (static_cast<uint32_t>(16 * mt + l.g) << lo) + 2 * l.t;\n",
     "        for (int i = 0; i < 4; ++i) {\n          accr[mt][i] += sacr[mt][i];\n"
     "          acci[mt][i] += saci[mt][i];\n        }\n"
     "        const uint32_t o0 = base + (static_cast<uint32_t>(16 * mt + l.g) << lo) + 2 * l.t;\n"),
]


def _with_walk(header: str, body: str) -> str:
    """``header`` (``mma.cuh``) with ``mma_3xtf32``'s body replaced."""
    i = header.index(_MMA_SIG) + len(_MMA_SIG)
    return header[:i] + body + header[header.index("\n}\n", i) + 1:]


def _edit(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"drift variant: anchor {old[:40]!r} is not in the source once")
        text = text.replace(old, new)
    return text


def _drift_variants(header: str, kernel: str) -> dict:
    """{variant: (mma.cuh, fused_gates.cu)} of the accumulation walks
    ``drift32`` and ``driftrun`` read, (a)-(f)."""
    out = {name: (_with_walk(header, body), kernel) for name, body in _WALKS.items()}
    two = _with_walk(header, _WALKS["(a) chained"]).replace(
        "\n// cp.async:", _WALK_TWO_ACC + "\n// cp.async:", 1)
    out["(c) hi*hi apart, small terms in a second sum"] = (two, _edit(kernel, _TWO_ACC_EDITS))
    rna = _edit(_with_walk(header, _WALKS["(a) chained"]),
                [(_SPLIT_LO, "  lo = tf32_rna(x - __uint_as_float(hi));\n")])
    out["(d) lo rounded to TF32 (rna)"] = (rna, kernel)
    order = ["(a) chained", "(b) each product apart",
             "(c) hi*hi apart, small terms in a second sum", "(d) lo rounded to TF32 (rna)",
             "(e) one fragment a step", "(f) hi*hi's truncation recovered"]
    return {k: out[k] for k in order}


def _build_dirs(tmp: str, sources: dict, lib: str) -> dict:
    """Build ``lib`` (``fused_gates`` or ``window_dot``) once per entry of
    ``sources`` ({name: {file name: text}}), each in a directory of its own
    under ``tmp``, all nvcc processes at once; {name: loaded library}."""
    from quest_tpu_torch import _build

    import chip_smoke as CS

    procs = {}
    for i, (name, files) in enumerate(sources.items()):
        d = os.path.join(tmp, f"{lib}{i}")
        os.makedirs(d)
        for fname, text in files.items():
            with open(os.path.join(d, fname), "w") as f:
                f.write(text)
        so = os.path.join(d, f"lib{lib}.so")
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", d, "-o", so,
             os.path.join(d, f"{lib}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {lib} {name!r}:\n{log}")
        print(f"# {lib} {name}: ptxas {CS._ptxas_kernels(log)}")
        if lib == "fused_gates":
            libs[name] = _load(so)
        else:
            libs[name] = ctypes.CDLL(so)
            for fn, (args, res) in _build.SIGNATURES["window_dot"].items():
                getattr(libs[name], fn).argtypes = args
                getattr(libs[name], fn).restype = res
    return libs


def _rna_lo_split(w):
    """``ops.fused_gates.tf32_split`` with lo rounded to TF32 as hi is:
    the host's half of variant (d)."""
    import numpy as np

    w = np.ascontiguousarray(w, dtype=np.float32)
    rna = lambda v: ((v.view(np.uint32) + np.uint32(0x1000))  # noqa: E731
                     & np.uint32(0xffffe000)).view(np.float32)
    hi = rna(w)
    return hi, rna(np.ascontiguousarray(w - hi))


def _drift32(tmp: str, W) -> None:
    """The norm each 3xTF32 accumulation walk loses (``# drift32`` lines):
    a one-op lane_u pass (the Haar 128 x 128 unitary ``W``) and a one-op
    span-5 window pass (``_window_pass``) on a random 26-qubit f32 state,
    through each of ``_drift_variants``' builds, the plain version and the
    exact product (the same pass in float64 on the card). Each line gives
    sum |amp|^2 of the output less that of the exact product, the max
    error over the largest amplitude, and the pass's ms."""
    import numpy as np
    import torch

    import chip_smoke as CS
    from quest_tpu_torch import _build
    from quest_tpu_torch.ops import fused_gates as FG

    csrc = _build._PKG / _build.CSRC
    variants = _drift_variants((csrc / "mma.cuh").read_text(),
                               (csrc / "fused_gates.cu").read_text())
    libs = {"kernel": _build.library("fused_gates"),
            **_build_dirs(tmp, {k: {"mma.cuh": h, "fused_gates.cu": c}
                                for k, (h, c) in variants.items()}, "fused_gates")}
    dev, dt, n = torch.device("cuda:0"), torch.float32, N_QUBITS
    tb = FG.HOPPER_TILE_BITS[dt]
    rng = np.random.RandomState(11)
    st = torch.as_tensor(rng.randn(2, 1 << n), dtype=dt, device=dev)
    st /= st.norm()
    x = torch.empty_like(st)

    def norm(t):
        return float((t.double() ** 2).sum())

    for what, make in (("lane_u", lambda: FG.PreparedRun(
            (("lane_u", FG.HashableMatrix(W)),), tb)), ("window [7, 12)",
                                                       lambda: _window_pass(FG, tb))):
        prep = make()
        table, coeffs = prep.device_tables(dev, dt)
        own = {}
        if what == "lane_u":  # (d): the host splits U^T with lo rounded too
            split = FG.tf32_split
            FG.tf32_split = _rna_lo_split
            try:
                own["(d) lo rounded to TF32 (rna)"] = make().device_tables(dev, dt)[1]
            finally:
                FG.tf32_split = split
        exact = FG.fused_run_plain(st.double(), prep, n=n, tile_bits=tb)
        plain = FG.fused_run_plain(st, prep, n=n, tile_bits=tb)
        e2 = norm(exact)
        print(f"# drift32 {what}, {n}q f32: input sum |amp|^2 {norm(st):.9f}, exact product "
              f"{e2:.9f}; plain version {norm(plain) - e2:+.4e} (max error "
              f"{CS._rel_err(plain.double(), exact)[1]:.3e} of the largest)")
        del plain

        def run(name):
            err = libs[name].quest_fused_run_f32(
                x.data_ptr(), x.data_ptr(), n, n, 0, tb, table.data_ptr(),
                int(table.shape[0]), own.get(name, coeffs).data_ptr(), 0, tb, 0, tb, 0, 0,
                prep.staged, torch.cuda.current_stream().cuda_stream, 1)
            if err:
                raise RuntimeError(f"launch failed ({err})")

        for name in libs:
            x.copy_(st)
            run(name)
            torch.cuda.synchronize()
            d2 = norm(x) - e2
            rel = CS._rel_err(x.double(), exact)[1]
            CS._require(rel <= 1e-5, f"drift32 {what} {name}: {rel} of the largest")
            ms = CS._cuda_ms(lambda: run(name), REPS)
            print(f"# drift32 {what}, {name}: sum |amp|^2 less the exact product's "
                  f"{d2:+.4e} (relative {d2 / e2:+.4e}), max error {rel:.3e} of the largest, "
                  f"{ms:.4f} ms")
        del exact
        torch.cuda.empty_cache()


def _drift_runs(tmp: str) -> None:
    """Phase 15's drift check (``chip_smoke._f32_drift``, no limit) through
    each accumulation walk of ``_drift_variants`` and this checkout's: the
    26q depth-8 f32 plan run DRIFT_RUNS times from |0> through a build of
    the kernel with that walk, beside the plain version, then the plan's ms
    a run (``# driftrun`` lines)."""
    import torch

    import chip_smoke as CS
    import quest_tpu_torch as qt
    from quest_tpu_torch import _build

    csrc = _build._PKG / _build.CSRC
    variants = _drift_variants((csrc / "mma.cuh").read_text(),
                               (csrc / "fused_gates.cu").read_text())
    libs = {"kernel": _build.library("fused_gates"),
            **_build_dirs(tmp, {k: {"mma.cuh": h, "fused_gates.cu": c}
                                for k, (h, c) in variants.items()}, "fused_gates")}
    dev = torch.device("cuda:0")
    try:
        for name, lib in libs.items():
            _build._loaded["fused_gates"] = lib
            circ = qt.Circuit(CS.N_MAIN)  # a plan and graphs of its own
            qt.random_layers(circ, CS.N_MAIN, CS.DEPTH_MAIN)
            fz = circ.fused(max_qubits=5, pallas=True, dtype=torch.float32)
            d = CS._f32_drift(qt, dev, fz, limit=None)
            q = qt.createQureg(CS.N_MAIN, qt.createQuESTEnv(device=dev), 1)
            CS._warm_run(fz, q)
            ms = CS._cuda_ms(lambda: fz.run(q), REPS)
            print(f"# driftrun {name}: after {d['runs']} runs |1 - calcTotalProb| kernel "
                  f"{d['kernel'][-1]:.4e}, plain {d['plain'][-1]:.4e}, kernel / plain "
                  f"{d['ratio']:.3f}; the plan {ms:.4f} ms a run")
            qt.destroyQureg(q)
            del fz
            torch.cuda.empty_cache()
    finally:
        _build._loaded["fused_gates"] = libs["kernel"]


def _window_dot32(tmp: str, parent: str | None) -> None:
    """``window_dot`` in f32 on the window [7, 11] of a 26-qubit state
    through this checkout's kernel and, with ``--parent``, the parent's
    (kernel, parent, parent, kernel; ``# window_dot32`` lines), the two
    held against the plain version."""
    import numpy as np
    import torch

    import chip_smoke as CS
    from quest_tpu_torch import _build
    from quest_tpu_torch.ops import window_dot as WD

    srcs = {}
    for name, root in (("kernel", _build._PKG / _build.CSRC),
                       *((("parent", Path(parent).resolve() / "quest_tpu_torch" / "csrc"),)
                         if parent else ())):
        srcs[name] = {f: (root / f).read_text() for f in ("window_dot.cu", "mma.cuh")}
    libs = _build_dirs(tmp, srcs, "window_dot")
    dev, n, lo, hi = torch.device("cuda:0"), N_QUBITS, 7, 11
    rng = np.random.RandomState(13)
    q, r = np.linalg.qr(rng.randn(32, 32) + 1j * rng.randn(32, 32))
    u = q * (np.diag(r) / np.abs(np.diag(r)))
    m = torch.as_tensor(np.stack([u.real, u.imag]), dtype=torch.float32, device=dev)
    st = torch.as_tensor(rng.randn(2, 1 << n), dtype=torch.float32, device=dev)
    st /= st.norm()
    ref = WD.window_dot_plain(st, m, n=n, lo=lo, hi=hi)
    x = st.clone()

    def run(name):
        err = libs[name].quest_window_dot_f32(x.data_ptr(), m.data_ptr(), n, lo, hi - lo + 1,
                                              0, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"window_dot launch failed ({err})")

    for name in libs:
        x.copy_(st)
        run(name)
        torch.cuda.synchronize()
        rel = CS._rel_err(x, ref)[1]
        CS._require(rel <= 1e-5, f"window_dot32 {name} against plain: {rel}")
        print(f"# window_dot32 {name} against plain: {rel:.3e} of the largest")
    for name in ["kernel", *(["parent", "parent"] if parent else []), "kernel"]:
        print(f"# window_dot32 [7, 11], {n}q f32, {name}: "
              f"{CS._cuda_ms(lambda: run(name), REPS):.4f} ms")


def _variant_sources(src: str) -> dict:
    """{variant: (the pass it is timed on, its source)}."""
    out = {}
    for name, (pn, edits) in (VARIANTS | _krausn_variants(src) | _window_variants(src)
                              | _window32_variants(src)).items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: its anchor is not in the source once")
            text = text.replace(old, new)
        out[name] = (pn, text)
    return out


def _load(so: str):
    from quest_tpu_torch import _build

    lib = ctypes.CDLL(so)
    for fn, (args, res) in _build.SIGNATURES["fused_gates"].items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = res
    return lib


def _krausn_pass(FG, tb):
    """The density path's 3-target channel alone, as ``chip_smoke.py``'s
    kraus phase runs it: rows (2, 3, 4), columns at the top of the tile."""
    import numpy as np

    HM = FG.HashableMatrix
    xxx = np.kron(np.kron([[0, 1], [1, 0]], [[0, 1], [1, 0]]), [[0, 1], [1, 0]])
    return FG.PreparedRun((("krausn", (2, 3, 4), (tb - 3, tb - 2, tb - 1),
                            ((1.0, HM(0.8 * xxx)), (1.0, HM(0.6j * np.eye(8))))),), tb)


def _window_pass(FG, tb):
    """A one-op window pass: a Haar 32x32 unitary on the zone [7, 12)."""
    import numpy as np

    rng = np.random.RandomState(7)
    q, r = np.linalg.qr(rng.randn(32, 32) + 1j * rng.randn(32, 32))
    u = q * (np.diag(r) / np.abs(np.diag(r)))
    W = np.block([[u.real, -u.imag], [u.imag, u.real]])
    return FG.PreparedRun((("window", 7, 5, FG.HashableMatrix(W)),), tb)


def _diag_pass(FG, dt):
    """The diagonal arm alone: the elementwise ops of the run of the
    N_QUBITS-qubit QFT, planned at ``dt``'s tile, that holds the most."""
    import quest_tpu_torch as qt
    from quest_tpu_torch import fusion

    c = qt.Circuit(N_QUBITS)
    c.applyFullQFT()
    fz = c.fused(max_qubits=5, pallas=True, dtype=dt)
    runs = [a[0] for f, a, _ in fz._tape if f is fusion._apply_pallas_run]
    run = max(runs, key=lambda r: sum(FG._op_is_diag(o) for o in r.prepare().ops))
    return FG.PreparedRun(tuple(o for o in run.prepare().ops if FG._op_is_diag(o)),
                          run.tile_bits)


def _sweep_pass(FG, dt):
    """The 2x2 arm alone: ``chip_smoke.TWO_BY_TWO_RUN``'s records, below the
    fold, at ``dt``'s tile."""
    import numpy as np

    import chip_smoke as CS

    return CS._below_fold(CS._two_by_two_ops(np.random.RandomState(41)),
                          FG.HOPPER_TILE_BITS[dt])


def _sweep_table(FG, prep, dt, w: int):
    """``prep``'s table with its records grouped into sweeps of ``w``
    qubits for ``dt``."""
    table, _ = FG.encode_ops(prep.records)
    FG.mark_sweeps(table, {dt: FG.group_sweeps(prep.records, w, prep.tile_bits)})
    return table


def _path_passes(dt, libs: dict, tol: float) -> None:
    """The kernel passes of the N_QUBITS-qubit main path's and QFT's fused
    runs in ``dt``, through this checkout's kernel and the parent's in turns
    (kernel, parent, parent, kernel), the parent's held against the kernel,
    summed a path (``# paths`` lines)."""
    import numpy as np
    import torch

    import chip_smoke as CS
    import quest_tpu_torch as qt
    from quest_tpu_torch import _build, fusion
    from quest_tpu_torch.ops import fused_gates as FG

    n, dev = N_QUBITS, torch.device("cuda:0")
    main = qt.Circuit(n)
    qt.random_layers(main, n, CS.DEPTH_MAIN)
    qft = qt.Circuit(n)
    qft.applyFullQFT()
    st = torch.as_tensor(np.random.RandomState(9).randn(2, 1 << n), dtype=dt, device=dev)
    st /= st.norm()
    out, ref = torch.empty_like(st), torch.empty_like(st)
    turns = ["kernel", "parent", "parent", "kernel"]
    try:
        for label, circ in (("main path", main), ("QFT", qft)):
            fz = circ.fused(max_qubits=5, pallas=True, dtype=dt)
            items = [CS._run_item(a[0]) for f, a, _ in fz._tape if f is fusion._apply_pallas_run]
            for i, (_, prep, kw) in enumerate(items):
                _build._loaded["fused_gates"] = libs["kernel"]
                FG.fused_run(st, n=n, ops=prep.ops, out=ref, prepared=prep, **kw)
                _build._loaded["fused_gates"] = libs["parent"]
                FG.fused_run(st, n=n, ops=prep.ops, out=out, prepared=prep, **kw)
                err, rel = CS._rel_err(out, ref)
                CS._require(rel <= tol, f"{label} pass {i}: parent against kernel {rel}")
            ms = {}
            for name in turns:
                _build._loaded["fused_gates"] = libs[name]
                ms.setdefault(name, []).append([CS._cuda_ms(
                    lambda: FG.fused_run(st, n=n, ops=prep.ops, out=out, prepared=prep,
                                         **kw), 10) for _, prep, kw in items])
            mean = {k: np.mean(v, axis=0) for k, v in ms.items()}
            p = mean["parent"].sum()
            print(f"# paths {label} {str(dt)[6:]}, {len(items)} kernel passes, summed ms "
                  f"(against the parent): " + ", ".join(
                      f"{k} " + " / ".join(f"{sum(x):.4f}" for x in v)
                      + f" ({mean[k].sum() / p - 1:+.2%})" for k, v in ms.items()))
            print(f"# paths {label} {str(dt)[6:]} by pass (2x2 records, sweeps; ms of "
                  + ", ".join(ms) + "): " + "; ".join(
                      f"{i} ({sum(FG._opens_sweep(r) for r in prep.records)}, "
                      f"{len(prep.sweeps[dt])}; "
                      + " ".join(f"{mean[k][i]:.4f}" for k in ms) + ")"
                      for i, (_, prep, _) in enumerate(items)))
    finally:
        _build._loaded["fused_gates"] = libs["kernel"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another checkout whose f64 passes to time beside")
    ap.add_argument("--no-variants", action="store_true",
                    help="time only this checkout's kernel (and the parent's), no variant "
                         "builds")
    ap.add_argument("--passes",
                    default="f32,f64,krausn,krausn32,window64,window32,diag32,diag64,"
                            "sweep32,sweep64",
                    help="which passes to time: f32, f64 (lane_u), krausn (f64), krausn32, "
                         "window64, window32, diag32, diag64, sweep32, sweep64 (default), "
                         "and drift32, driftrun, windowdot32 (only when named)")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_lane_u_breakdown: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from quest_tpu_torch import _build
    from quest_tpu_torch.ops import fused_gates as FG

    passes = args.passes.split(",")
    csrc = _build._PKG / _build.CSRC
    variants = _variant_sources((csrc / "fused_gates.cu").read_text())
    sources = {name: (text, csrc) for name, (pn, text) in variants.items()
               if pn in passes and not args.no_variants}
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
        if "drift32" in passes:
            _drift32(tmp, W)
        if "driftrun" in passes:
            _drift_runs(tmp)
        if "windowdot32" in passes:
            _window_dot32(tmp, args.parent)
        for pn, dt, tol in (("f32", torch.float32, 1e-5), ("f64", torch.float64, 1e-12),
                            ("krausn", torch.float64, 1e-12), ("krausn32", torch.float32, 1e-5),
                            ("window64", torch.float64, 1e-12), ("window32", torch.float32, 1e-5),
                            ("diag32", torch.float32, 1e-5), ("diag64", torch.float64, 1e-12),
                            ("sweep32", torch.float32, 1e-5), ("sweep64", torch.float64, 1e-12)):
            if pn not in passes:
                continue
            tb = FG.HOPPER_TILE_BITS[dt]
            kraus = pn.startswith("krausn")
            n = 2 * CS.N_DENSITY if kraus else N_QUBITS
            window = pn.startswith("window")
            diag = pn.startswith("diag")
            sweep = pn.startswith("sweep")
            prep = (_krausn_pass(FG, tb) if kraus else _window_pass(FG, tb) if window
                    else _diag_pass(FG, dt) if diag else _sweep_pass(FG, dt) if sweep
                    else FG.PreparedRun((("lane_u", FG.HashableMatrix(W)),), tb))
            tb = prep.tile_bits
            table, coeffs = prep.device_tables(dev, dt)
            # the host-split variant's own coefficients: U, then its table
            own = {"window32 U split by the host": torch.as_tensor(np.concatenate(
                [prep.coeffs[:2 * 32 * 32], window_split_table(prep.coeffs[:2 * 32 * 32], 5)
                 .reshape(-1)]), dtype=dt, device=dev)} if pn == "window32" else {}
            # the width variants' own tables: the records grouped at their width
            own_table = {f"{pn} width {w}": torch.as_tensor(_sweep_table(FG, prep, dt, w),
                                                            device=dev)
                         for w in SWEEP_WIDTHS.get(pn, ())}
            st = torch.as_tensor(rng.randn(2, 1 << n), dtype=dt, device=dev)
            st /= st.norm()
            x = st.clone()

            def run(name):
                fn = (libs[name].quest_fused_run_f32 if dt == torch.float32
                      else libs[name].quest_fused_run_f64)
                err = fn(x.data_ptr(), x.data_ptr(), n, n, 0, tb,
                         own_table.get(name, table).data_ptr(),
                         int(table.shape[0]),
                         own.get(name, coeffs).data_ptr(), 0, tb, 0, tb, 0, 0, prep.staged,
                         torch.cuda.current_stream().cuda_stream, 1)
                if err:
                    raise RuntimeError(f"launch failed ({err})")

            ref = FG.fused_run_plain(st, prep, n=n, tile_bits=tb)
            parent = ["parent"] if "parent" in libs else []
            checked = ["kernel", *parent] + [v for v in RIGHT if v in libs and variants[v][0] == pn]
            for name in checked:
                x.copy_(st)
                run(name)
                torch.cuda.synchronize()
                err, rel = CS._rel_err(x, ref)
                CS._require(rel <= tol, f"{pn} {name} against plain: {err} ({rel} relative)")
                print(f"# {pn} {name} against plain: max_abs_err {err:.3e} ({rel:.3e} of "
                      f"the largest, limit {tol:g})")
            del ref
            bound = max(CS._bound_ms(CS._pass_work(prep, n, 4 if dt == torch.float32 else 8),
                                     dt == torch.float32))
            # the f64 lane_u pass also under each krausn variant: the two
            # arms share the instantiation's registers
            mine = [v for v, (d, _) in variants.items() if v in libs
                    and (d == pn or (pn, d) == ("f64", "krausn"))]
            what = ("krausn" if kraus else "window" if window else "diagonal arm" if diag
                    else "2x2 arm" if sweep else "lane_u")
            for name in ["kernel", *parent, *mine, *parent, "kernel"]:
                ms = CS._cuda_ms(lambda: run(name), REPS)
                print(f"# {'' if diag or sweep else 'one-op '}{what} pass, {n}q {str(dt)[6:]}, "
                      f"{name}: {ms:.4f} ms "
                      f"(bound {bound:.4f} ms, {bound / ms:.1%} of it)")
            del st, x
            torch.cuda.empty_cache()
            if sweep and parent:
                _path_passes(dt, libs, tol)
    print(CS._card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
