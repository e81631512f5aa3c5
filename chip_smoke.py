#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/H100 port (``quest_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and ``nvidia-smi``; exits non-zero, printing
no result, without them. Phases, in order:

1. build: compile every CUDA kernel of the port from ``csrc/`` (one nvcc
   per source, started together) and print the toolchain and the card,
   each kernel's registers and spills, the count of DMMA, HMMA and DFMA
   instructions in each fused-run instantiation's SASS (``cuobjdump``:
   the f64 one, which runs lane_u, krausn and windows of span 3 or more,
   must hold more DMMA than the lane_u and krausn arms' 36; the f32 ones,
   whose krausn arm, windows of span 3 or more and (the lane_u one)
   lane_u fold run on 3xTF32, more HMMA than those arms took before the
   window's: 192 in the other f32 one, 288 in the lane_u one) and the
   blocks per SM of each kind of run (an f64 run with lane_u, krausn, a
   window of span 3 or more or elementwise records, and an f32 run with
   krausn, such a window or elementwise records, must fit two);
2. kernel: the fused gate-run kernel against its plain PyTorch version at
   20 qubits in f32 and f64, for every op kind (matrix with lane, sublane
   and grid-bit controls, parity, swap, diagw, lane_u, window, and the
   channel ops kraus1, kraus2, krausn with signed terms, unsorted targets
   and non-trace-preserving operators) and every folded swap form (load,
   store, both, asymmetric, the pair swap; each kraus kind with and
   without one; a run holding lane_u folds and krausn), lane_u on the
   small tiles of SMALL_TILE_QUBITS (2 to 32 rows: the tensor-core folds
   at one m16 tile and below it) and krausn on random unsorted qubits at
   KRAUS_TILE_BITS (2 to 32 groups: the tensor-core arms at one sweep,
   idle warps and masked m16 tiles; in f32 also 64 groups, one full sweep
   of the f32 arm, whose 2^13 tile takes two), and the window fold on the
   tensor cores at WINDOW_TILE_BITS (f64: D = 8, 16, 32; f32 also 2^13,
   D = 32 over two slabs), alone, after a lane_u fold (in f32 the lane_u
   instantiation), and before a controlled 2x2 and a lane_u fold, and in
   f32 a window [8, 11) at tile bits 12 (a slab of 256 columns); limits
   1e-5 (f32) and 1e-12 (f64) on the max error over the
   largest amplitude, here and in every kernel-vs-plain check below;
3. main path: the bench circuit (random Clifford+T layers, 26 qubits,
   depth 8, f32) planned by ``Circuit.fused(max_qubits=5, pallas=True)``
   at the Hopper tile; each of its runs through the kernel against the
   plain version at 26 qubits (and timed), then the whole circuit through
   ``Circuit.run`` with the counts reset just before it: launches must
   equal the runs executed, ``engine_fallback_total`` must read 0, the
   total probability must be within 1e-4 of 1 and the amplitudes within
   2e-4 of a plain per-gate replay; then gates/sec;
4. yardstick: a full-state ``copy_``, which the port never calls; then the
   lane_u phase: one-op lane_u passes at 26 qubits, f32 and f64 (a Haar
   128x128 unitary, and a 3-qubit block folded by ``fusion.lane_u_run``),
   each against the plain version and the exact complex128 product (f64:
   within 1e-12 of the largest amplitude of both), timed beside its bound
   (f32 at the 3xTF32 rate, f64 at the FP64 tensor-core rate) and one
   complex ``torch.matmul`` (complex64 / complex128) of the same product,
   which the port never calls; then the window fold alone: a one-op
   window pass on [7, 11] at 26 qubits, f32 and f64, against the plain
   version and the exact complex128 product (both within 1e-5 of the
   largest amplitude in f32, 1e-12 in f64), timed beside its bound (its
   share) and one complex ``torch.matmul`` of the same product, and the
   main path's fold count (in f32, split by the instantiation its runs
   launch); then the 2x2 arm alone (``_two_by_two_arm_alone``, ``# 2x2
   arm alone`` lines), f32 and f64: one 26-qubit pass with no folded swap
   of TWO_BY_TWO_RUN's records (14 2x2s on [7, 12), built below the fold)
   and of the f64 main path's run with the most 2x2 records among those
   with no lane_u, window or kraus record, each against the plain version
   (1e-5 / 1e-12 of the largest amplitude), its 2x2 records and register
   sweeps, timed beside its bytes bound, the plain version and one complex
   ``torch.matmul`` of the state's [7, 12) view by the run's 32 x 32
   product;
   then the main path in f64 on one device: the same circuit
   planned at the f64 tile, each run's pass against the plain version
   (1e-12) and timed, then ``Circuit.run`` on an f64 register with the
   counts reset just before it (launches = runs, zero fallbacks, total
   probability within 1e-10 of 1, amplitudes within 1e-10 of the largest
   of an f64 per-gate replay), its time, gates/sec and the share of its
   passes' summed bound;
5. density path, f32 then f64: the bench's channel circuits ("r3", 10
   entries, and "r4", 11 with a 3-target Kraus map) on a 14-qubit density
   register (28 flattened qubits) from ``initPlusState``, planned by
   ``Circuit.fused(max_qubits=4, pallas=True)`` at the Hopper tile; each
   run's pass through the kernel against the plain version (and timed),
   then the circuit through ``Circuit.run`` with the counts reset just
   before it: launches must equal the runs executed plus the fusion
   barriers (each a Kraus channel that ``apply_channel`` sends through the
   kernel as one ``kraus1`` pass: ``channel_route_total{kernel}``, printed
   with the barrier; the barrier's pass is checked and timed with the
   runs), ``engine_fallback_total`` must read 0; the trace must be within
   1e-4 (f32) or 1e-10 (f64) of 1 and the amplitudes within 2e-4 (f32) or
   1e-10 (f64) of a per-gate replay of the unfused tape with every Kraus
   channel on the per-term engine; then channel-ops/sec, the barrier
   channel's own time, and a full-state ``copy_``; then each kraus kind
   alone in one pass at 28 flattened qubits: against the plain version
   and the exact superoperator product in complex128 (both within 1e-5
   of the largest amplitude in f32, 1e-12 in f64), timed beside its bound
   and one complex ``torch.matmul`` (complex64 / complex128) of a
   (2^(28-2t), 4^t) state by a (4^t, 4^t) matrix, which the port never
   calls;
6. window: ``ops.window_dot.window_dot`` at 26 qubits, f32 and f64, on
   the windows [7, 11], [12, 17] (the widest, span 6) and [21, 25], and
   on [7, 7], [8, 9], [13, 15], [20, 23] (spans 1-4: the FMA path and the
   small tensor-core tiles), each with a random unitary, without and with
   ``conj``: each call counted (one launch) and held against
   ``window_dot_plain``; then each window's time beside its bound (f32
   products at the 3xTF32 rate from span 3 up) and one complex
   ``torch.matmul`` computing the same; the registers and spills of each
   kernel instantiation of both libraries are printed after the build;
7. gate surface: ``gate_surface_tape`` (every function of ``gates.py``
   and ``operators.py`` beyond the bench set that a tape records, twice)
   at 26 qubits, f32, planned by ``Circuit.fused(max_qubits=5,
   pallas=True)`` at the Hopper tile, each fused run and each lane_u dense
   block's pass against the plain version, then run with the counts
   reset: launches = fused runs + lane_u dense blocks, zero fallbacks,
   total probability within 1e-4 of 1, amplitudes within 1e-5 of the
   largest of a per-gate replay; the same with the plan of
   ``Circuit.fused(max_qubits=5)`` (dense blocks below the lane boundary
   as lane_u passes of the fused-run kernel, the rest on the engine); and
   the tape without its left-multiplying operators on a 13-qubit density
   register, trace within 1e-4, entries within 1e-5 of the largest of
   its per-gate replay;
8. sharded: the per-shard kernel (phase 2 also holds it, at N_KERNEL
   qubits over N_SHARDS virtual shards of cuda:0, f32 and f64: controls,
   diagonal targets, diagw and parity members on sharded qubits and
   shard-local folded swaps; each shard's pass against the plain version
   with the shard's index, the shards together against the one-device
   kernel); then the main path's circuit on a register sharded over
   N_SHARDS virtual shards of cuda:0 (``createQuESTEnv(devices=...)``),
   f32 and f64, planned by ``Circuit.fused(..., shard_devices=N_SHARDS)``:
   each run's pass on each shard against the plain version (and timed),
   the run with the counts reset just before it (launches = runs x
   shards, zero fallbacks, ``exchange_calls_total{grouped_permute}`` =
   collective transposes), the gathered state within 1e-5 (f32) / 1e-10
   (f64) of the largest amplitude of the one-device fused run, a plain
   per-gate replay over the shards (pair exchanges, x permutes, phases)
   against the one-device per-gate replay, a 3-target unitary whose two
   sharded targets relocate into its controls' slots (the controls move
   with the swaps) against the one-device per-gate engine, the readouts,
   gates/sec,
   each collective permute's time beside its bound, and one run's time
   on the card's clock split into the shard passes, the permutes and the
   rest (CUDA events around each launch and permute);
9. readouts, on the states the phases above made, f32 and f64: the main
   path's final state at N_MAIN qubits on one device and the sharded
   phase's over N_SHARDS shards (with a ``createCloneQureg`` of it run
   through two more ``random_layers`` as the second state: inner product,
   fidelity, outcome distributions on 4 and 8 unsorted targets,
   ``getProbAmp``, a Pauli product, a 26-qubit transverse-field Ising
   Hamiltonian through ``calcExpecPauliHamil`` and ``calcExpecPauliSum``,
   the clone, ``syncQuESTEnv``; the sharded values also against the same
   states on one device, and three calls on mixed layouts), and the
   density phase's r4 and r3 states (inner product, Hilbert-Schmidt
   distance, fidelity with a pure state, outcome distribution, a Pauli
   product, ``mixDensityMatrix`` at p = 0.3 and the trace and purity
   after it): each value against an evaluation from its definition in
   complex128 of the gathered state (1e-4 f32 / 1e-10 f64; a Pauli sum's
   error relative to sum |c_t|), each call timed beside its bytes bound
   and one PyTorch call computing the same function (``# readout``
   lines);
10. operators, on the main path's final states and fresh registers
   (``_operators_phase``, ``# operators`` lines): the QFT at N_MAIN qubits
   in f32 and f64 planned into fused runs (each pass against the plain
   version, launches = kernel passes, zero fallbacks; against the closed
   form on a basis state and against sqrt(N) ``torch.fft.ifft`` of the
   main path's state; the eager QFT and ``applyQFT`` on a subset against
   the same references; ``torch.fft.fft`` as the yardstick); the kernel's
   diagonal arm alone (``_diag_arm_alone``, ``# diagonal arm alone``
   lines): the elementwise ops of the QFT plan's densest run in one pass,
   their op and record counts, against the plain version (1e-5 / 1e-12 of
   the largest amplitude), timed beside its bytes bound, the plain
   version and one complex ``torch.mul`` by the same diagonal, and at each
   table width of DIAG_WIDTHS; a Trotter
   circuit of the readout phase's Hamiltonian fused against eager (its
   input's total probability printed beside its output's), the
   phase functions (one device, f32 also over N_SHARDS shards; a density
   register), ``DiagonalOp``, projectors, sub-diagonal operators,
   ``setQuregToPauliHamil``, ``applyPauliHamil`` and the copyState*GPU
   host mirror, each against its definition in float64/complex128 and
   timed beside its bytes bound; then the phase's time;
11. compiled (``_compiled_phase``, ``# compiled`` lines): the compiled
   routes as CUDA-graph replays of the eager replay against the eager
   replay in this call -- the main path in f32 and f64 through
   ``compiled()``, ``compiled_segments(24)``, ``compiled_blocks(24)``,
   ``compiled_request()`` (also with a readout) and ``Circuit.run``, bit
   for bit; the fused_run kernel nodes of the graphs a replay launches
   equal the runs, the card's profiler trace shows them running, and the
   wrappers' launch counts do not move in a replay; ``amps = fn(amps)`` with no allocation; ``random_layers(20,
   8)``; the density r4 circuit and the sharded main path through
   ``compiled()`` and ``compiled_request()``, bit for bit with the eager
   run's counts; the QFT and Trotter plans within 1e-5 with no item
   dispatch; the serving ansatz's parameter sweep through
   ``parameterized()`` (one capture, at the second call, none after; a
   structure-equal circuit hitting the executable cache); many distinct
   circuits run once and twice through ``Circuit.run``, with the card's
   reserved memory bounded;
12. serving (``_serving_phase``, ``# serving`` lines): the serving
   ``Engine`` on ``createQuESTEnv(device="cuda:0")``, f32 and f64, over
   the bench's serve_20q (``serving_ansatz(20, 4)``, raw and planned into
   fused runs, ``max_batch=8``) and ``serving_ansatz(26, 4)`` fused at
   ``max_batch=4`` (four 512 MiB / 1 GiB lanes): a coalesced batch
   against a loop of single requests, bit for bit; each lane against the
   unbatched ``parameterized()`` replay (1e-5 / 1e-12 of the largest
   amplitude) and its total probability; no capture after the warm-up;
   the batch's first (eager) call launching the fused-run kernel once a
   run for all lanes, and its graph holding one fused_run node a run
   (``_graph_kernels``); no sentinel breach with ``QUEST_SENTINEL``
   armed; the cold first call and the capture, requests/s of a batch
   against the same requests uncoalesced, p50 / p99 latency of a
   16-request stream; the same sweep through the unbatched
   ``parameterized()`` replay, timed (the route a user would take without
   the Engine); a 12q stream of requests arriving one at a time, with the
   card's and the host's share of a batch (``_single_submits``, ``# serving
   single`` lines);
   and the kernel's lane axis alone (``_lanes_alone``, ``# serving lanes``
   lines): one 26q main-path run over 4 lanes in one launch against 4
   one-lane launches, bit for bit, timed beside its bound;
13. sampling and gradients (``_sampling_gradients_phase``, ``# sampling``
   and ``# gradients`` lines): ``sample_request`` on the main path's fused
   plans, f32 and f64, over all 26 qubits and a 10-qubit subset at 1024
   and 2^20 shots -- the eager request launching the kernel once a run in
   one ``route=request`` dispatch, its graph holding one fused_run node a
   run, every shot in range, the table equal to its stages on the card's
   state and to the CPU's ``draw_outcomes`` of the same marginal, uniforms
   and total (and the card's u words to the CPU's), bit for bit, the
   10-qubit table at 2^20 shots against the float64 marginal by
   chi-square (p-value >= 1e-6), the ms a request against
   ``compiled_request`` of the same plan without the shot stage and the
   shot stage's bytes bound; a 20-qubit request whose
   ``applyMidMeasurement`` every shot carries; the Engine with
   ``finalize=sample_reduce`` over ``serving_ansatz(20, 4)`` fused, 8
   lanes equal to single runs; then ``Circuit.gradient`` of
   ``serving_ansatz(20, 4)`` against a 39-term TFIM, raw and
   ``fused(max_qubits=5)`` (its lane_u blocks the kernel's launches and
   graph nodes), f32 and f64, its ms against the ``parameterized()``
   forward alone, capture s and MiB, raw against fused (f64: the value bit
   for bit, grads within 1e-12), f32 against f64 (1e-3 of the largest
   |g|), f64 against ``parameter_shift`` on ``serving_ansatz(20, 1)``
   (1e-9); ``serving_ansatz(26, 2)`` fused at full width against the
   26-qubit TFIM (the value within 1e-4 / 1e-10 of
   ``calcExpecPauliHamil`` of the forward state); ``Engine.submit_grad``
   at 8 lanes, raw and fused, f32 and f64, lanes equal to single runs bit
   for bit and within 2e-4 / 1e-10 of the largest |g| of the unbatched
   gradient, requests/s against a loop of ``Circuit.gradient``;
14. trajectories and the pool (``_trajectories_pool_phase``, ``#
   trajectories`` and ``# pool`` lines): the bench's trajectory circuit
   (``trajectory_circuit``, a copy on the port's Circuit) at 6 qubits, T =
   128, its ensemble mean within 4/sqrt(T) of the density route's rho on
   the card; unraveled at 20 qubits (T = 16, the bench's trajectories_20q)
   and 26 (T = 4), f32 and f64, planned into fused runs and run through
   ``run_ensemble`` -- the eager ensemble launching the kernel once a run
   for all lanes, its graph holding one fused_run node a run, replays and
   new seeds building nothing, replays bit for bit, a lane equal to its
   seed served alone, the raw tape's ensemble within 1e-5 / 1e-12 of the
   largest amplitude, total probabilities within 1e-4 / 1e-10,
   trajectories/s and ms an ensemble, the runs' lane-batched launches
   alone and each channel site alone (reduced-density pass and
   ``apply_matrix``) beside its bytes bound; then the bench's pool_20q
   (``serving_ansatz(20, 4)`` and ``(20, 5)`` fused, 3 replicas, 32
   requests sent one at a time, f32 and f64) without and with one
   ``pool.replica:kill``: requests/s and p50 / p99, no request lost,
   every result equal to a lone Engine's bit for bit, the replacement's
   first request building nothing, and ``submit_grad`` through the pool
   (requests/s, equal to ``Engine.submit_grad`` bit for bit);
15. checkpoints and segments (``_checkpoint_segments_phase``, ``#
   checkpoint`` and ``# segmented`` lines; the snapshots in a temporary
   directory, removed after): phase 3's 26q depth-8 f32 plan cut into two
   segments (the cuts printed) and run by ``run_segmented`` under
   ``segment.boundary:preempt:1`` (QuESTPreemptionError at the first cut),
   resumed by ``resume_segmented`` on a fresh env -- each segment's first,
   eager call launching the kernel once a run, the seeds restored -- and
   equal bit for bit to an uninterrupted ``run_segmented`` (its segment
   graphs holding one fused_run node a run), ``Circuit.run`` and the eager
   replay, the same measurement outcomes after both; ``saveQureg`` split
   into card to host, CRC32, compress and write, rename (beside
   ``np.savez_compressed``'s one zlib stream on 2^23 of the amplitudes,
   which the port never calls), ``verify_snapshot`` and ``loadQureg``
   split into read, CRC32 and host to card, the segmented run's ms against
   ``Circuit.run``'s; the f32 drift check (the plan run 8 times through the
   kernel and through the plain version of its passes, |1 - calcTotalProb|
   after each, and each pass's change of the norm in one run; the kernel's
   drift after 8 runs must stay within twice the plain version's); 22q f64
   under ``sentinel_policy("default")`` and ``state.corrupt:bitflip0:1``,
   healed by one replayed rollback bit for bit, then the newest
   generation's payload flipped: ``verify_snapshot`` raises
   QuESTChecksumError and the resume falls back (QT305, ``skipped_corrupt``)
   and ends bit for bit; 22q f32 over N_SHARDS virtual shards: 4 shard
   files, loaded on one device and on the shards equal to the source, the
   resume equal to the uninterrupted run; a 10-qubit density register, f32
   and f64, saved and loaded bit for bit with its trace.
16. Sharded density (``_sharded_density_phase``, ``# sharded density``
   lines): the bench's 14q density circuits r3 and r4 on a register over
   N_SHARDS virtual shards of cuda:0, f32 then f64 (28 flattened qubits,
   26 local): the plan of ``Circuit.fused(max_qubits=4, pallas=True,
   shard_devices=N_SHARDS)``; each run's pass and each barrier channel's
   kraus1 pass on each shard through the kernel against the plain version
   with the shard's index; the run with the counts reset just before it
   (launches = (runs + barrier channels) x shards, zero fallbacks, the
   barrier channels on the kernel route, collective permutes = the
   collective transposes + two a barrier whose column qubit is sharded);
   the gathered state against the one-device run of phase 5's plan
   (1e-5 / 1e-12 of the largest amplitude) and the trace (1e-4 / 1e-10 of
   1); channel-ops/sec; each collective permute beside its bytes bound;
   the r4 state's readouts (trace, purity, outcome probabilities,
   fidelity, a Pauli product, inner product and distance against the
   one-device state, a density amplitude, a diagonal operator's
   expectation) against complex128 evaluations;
17. sampling, gradients and serving over shards
   (``_sharded_serving_phase``, ``# sharded sampling``, ``# sharded
   gradients`` and ``# sharded serving`` lines), on N_SHARDS virtual
   shards of cuda:0: ``sample_request`` on the sharded phase's 26q plans,
   f32 and f64, over every qubit and over SAMPLE_SUBSET (its qubit 25
   sharded) at 1024 and 2^20 shots -- the eager request launching the
   kernel once a run a shard, zero fallbacks, its graph holding as many
   fused_run nodes, the table equal to the shot stage on the final shards
   and to the CPU's sharded sampler on the same shards copied to the host
   bit for bit, the shot stage's rise of ``max_memory_allocated`` below
   one shard's bytes (nothing gathered), the subset's 2^20 shots against
   the float64 marginal by chi-square, ms a request beside phase 13's
   one-device request; the MID_MEASURE circuit planned for the shards with
   ``applyMidMeasurement`` on its qubit 7 (local) and 19 (sharded): the
   outcome and the state against the one-device plan (1e-5 / 1e-12 of the
   largest amplitude); ``serving_ansatz(26, 2)``'s gradient over the
   shards against phase 13's one-device gradient (1e-5 / 1e-10 of the
   largest |g|), ms, capture s and MiB; ``Engine.submit_grad`` on the
   shards (GRAD_SHARDED_ENGINE, 4 requests) against one-device
   ``Circuit.gradient``; the 14q r3 density circuit with a Param
   rotation after each Hadamard served by an Engine on the shards (8
   requests f32, 4 f64): launches = (runs + barrier channels) x shards,
   zero fallbacks, a batch equal to a loop bit for bit, within 1e-5 /
   1e-12 of the largest entry of a one-device Engine, requests/s beside
   it, and the same stream through a one-replica EnginePool; then the
   script's time.

Every ``# ... pass`` line gives the pass's records, its 2x2 and swap
records and the register sweeps they take (the 2x2 arm's, at the
precision's width).

Every phase runs its circuits through ``Circuit.run``, which dispatches
through ``compiled()``: a plan's first run is eager (so the launch counts
of a phase's first, counted run are the wrappers' own), and each later
run on a buffer pair that has no graph yet captures one, which the runs
after it replay; a phase warms both buffer orders of a register before it
times its runs. A replay adds the telemetry counts its capture recorded,
and nothing to the wrappers' launch counts. Each phase closes the cached
executables it leaves (``_release``).

The earlier phases pin ``createQuESTEnv(device="cuda:0")``, so that a host
with more cards does not shard them. Lines starting with ``#`` carry the
detail; the line before the last is
``{"kernels": [...]}``, the last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import importlib.metadata
import json
import subprocess
import sys
import time

N_MAIN, DEPTH_MAIN, N_KERNEL, N_DENSITY, N_SHARDS = 26, 8, 20, 14, 4
#: window_dot's windows (lo, span) at N_MAIN qubits: the lowest it takes,
#: the widest, and the top 5-qubit window (tools/microbench.py's)
WINDOWS = ((7, 5), (12, 6), (21, 5))
#: further windows, spans 1-4, held against the plain version and timed:
#: the FMA path (spans 1, 2) and the small tensor-core tiles (D = 8, 16)
CHECK_WINDOWS = ((7, 1), (8, 2), (13, 3), (20, 4))
#: H100 SXM data-sheet rates: HBM bytes/s, FP32 FLOP/s outside the tensor
#: cores, and FP64 FLOP/s on the tensor cores (the card's top FP64 rate;
#: 34e12 outside them)
HBM_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_FP64_FLOPS = 67e12
#: dense TF32 on the tensor cores, and the rate of an f32 product done as
#: 3xTF32 (three TF32 passes): window_dot's f32 route for spans >= 3 and
#: the fused-run kernel's f32 lane_u, krausn and window folds
PEAK_TF32_FLOPS = 494.7e12
TF32X3_FLOPS = PEAK_TF32_FLOPS / 3
#: lane_u passes of the lane_u phase at N_MAIN qubits, f32: a Haar 128x128
#: unitary, and a 3-qubit block [LANE_BLOCK_LO, +3) folded as
#: fusion.lane_u_run folds a dense block below the lane boundary
LANE_BLOCK_LO = 2
#: states below the 2^13 tile whose lane_u ops the kernel phase checks:
#: tiles of 2, 8, 16 and 32 rows of 128 lanes
SMALL_TILE_QUBITS = (8, 10, 11, 12)
#: tiles below the f64 2^12 whose krausn ops the kernel phase checks (2 to
#: 32 groups of 64 amplitudes), on a KRAUS_TILE_QUBITS-qubit state; in f32
#: also 2^12 (64 groups: one full sweep of the f32 arm)
KRAUS_TILE_BITS, KRAUS_TILE_QUBITS = (7, 8, 9, 10, 11), 14
KRAUS_TILE_BITS_F32 = KRAUS_TILE_BITS + (12,)
#: f64 tiles whose window folds (the zone [7, tile_bits): spans 3-5, D = 8,
#: 16, 32) the kernel phase checks on the FP64 tensor cores, alone and in
#: runs with lane_u folds, on a KRAUS_TILE_QUBITS-qubit state; in f32 also
#: the 2^13 tile (the zone [7, 12): D = 32 over two slabs), on 3xTF32
WINDOW_TILE_BITS = (10, 11, 12)
WINDOW_TILE_BITS_F32 = WINDOW_TILE_BITS + (13,)
#: the table widths (qubits) at which the diagonal arm's pass is timed
DIAG_WIDTHS = (4, 5, 6, 7, 8)


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def _ptxas_kernels(log: str) -> list[dict]:
    """Each kernel's registers and spill bytes from a build log of
    ``nvcc -Xptxas -v``, its name demangled by ``c++filt`` where the host
    has it."""
    import re

    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            rows.append({"kernel": name, "spill_stores": int(m.group(1)),
                         "spill_loads": int(m.group(2)), "registers": None})
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and rows and rows[-1]["registers"] is None:
            rows[-1]["registers"] = int(m.group(1))
    rows = [r for r in rows if r["registers"] is not None]
    for r, name in zip(rows, _demangle([r["kernel"] for r in rows])):
        r["kernel"] = name
    return rows


def _demangle(names: list[str]) -> list[str]:
    """Kernel names as ``fused_run_kernel<double, false>``, by ``c++filt``
    where the host has it (else as given)."""
    try:
        full = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                              text=True, timeout=60, check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        full = []
    if len(full) != len(names):
        return names
    return [f.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")
            for f in full]


def _sass_counts(so, opcodes=("DMMA", "HMMA", "DFMA")) -> dict:
    """{kernel: {opcode: count}}: how many instructions of each opcode the
    SASS of each kernel in the built library ``so`` holds (``cuobjdump
    -sass``, beside ``nvcc``)."""
    import os
    import re

    from quest_tpu_torch import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    parts = out.split("Function : ")[1:]
    names = _demangle([part.partition("\n")[0].strip() for part in parts])
    return {name: {op: len(re.findall(rf"\b{op}\b", part)) for op in opcodes}
            for name, part in zip(names, parts)}


def _cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` back-to-back calls, CUDA events,
    after one call that warms up."""
    import torch

    fn()
    torch.cuda.synchronize()
    return _clock_ms(fn, reps)


def _clock_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` back-to-back calls, CUDA events,
    with no warm-up call."""
    import torch

    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _rep_ms(fn, reps: int) -> dict:
    """Median, min and max ms of ``fn()`` over ``reps`` calls, each timed
    alone by CUDA events; the caller has warmed ``fn`` up."""
    import statistics

    import torch

    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return {"median": statistics.median(times), "min": min(times), "max": max(times),
            "reps": reps}


def _range(t: dict) -> str:
    return f"{t['median']:.3f} ms (median of {t['reps']}, {t['min']:.3f}-{t['max']:.3f})"


#: the port's kernels as their names show in a profiler trace of the card
TRACE_NAMES = {"fused_run": ("fused_run_kernel",),
               "window_dot": ("window_mma_kernel", "window_fma_kernel")}


def _card_runs(fn) -> tuple[dict, object]:
    """(kernel -> runs, fn()): ``fn()`` under torch.profiler's CUDA
    activity, and how many times each of the port's kernels ran on the
    card in it, graph replays included (the wrappers count only the
    launches they make). The trace can lose records: late in a full run
    of this script it showed 11-12 of a graph's 13 kernels, while the
    graph's result equalled the eager replay's (PERF.md section 7), so a
    replay's kernels are counted from its graph (``_graph_kernels``) and
    the trace must show some and no more."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    runs = dict.fromkeys(TRACE_NAMES, 0)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for k, names in TRACE_NAMES.items():
                runs[k] += any(n in e.name for n in names)
    return runs, out


def _graph_kernels(exe) -> int:
    """The fused_run kernel nodes of the CUDA graphs that ``exe``'s last
    call replayed (each captured piece's most recently used graph), read
    from the graphs' node lists (``CUDAGraph.debug_dump``): the kernels
    every replay of them launches."""
    import os
    import tempfile
    import warnings

    n = 0
    for p in exe.program.pieces:
        if not p.graphs:
            continue
        g = next(reversed(p.graphs.values())).graph
        with tempfile.TemporaryDirectory() as d, warnings.catch_warnings():
            warnings.simplefilter("ignore")  # debug_dump warns that it ran
            path = os.path.join(d, "graph.dot")
            g.debug_dump(path)
            with open(path) as f:
                dot = f.read()
        n += sum('label="{KERNEL' in node and TRACE_NAMES["fused_run"][0] in node
                 for node in dot.split('"[style=')[1:])
    return n


def _pass_work(prepared, n: int, itemsize: int) -> tuple[float, float, float]:
    """(bytes, flops, tensor-core flops) one pass of ``prepared`` needs on
    an n-qubit state: each amplitude of both planes read once and written
    once; flops per control-satisfied amplitude: 2x2 matrix 16, diagonal 6,
    swap 0, window 8 * 2^span, a kraus op on t row qubits with m terms 8 *
    min(4^t, 2 m 2^t): the fewer complex multiply-adds of its superoperator
    form and its per-term form; and apart, the ops whose f32 products run
    on the tensor cores: lane_u 1024 (128 complex multiply-adds), a window
    of span 3 or more 8 * 2^span."""
    from quest_tpu_torch.ops.fused_gates import _KRAUS, _op_is_diag, kraus_parts

    N = 1 << n
    flops = lane = 0.0
    for op in prepared.ops:
        kind = op[0]
        if kind in _KRAUS:
            rows, _, terms = kraus_parts(op)
            flops += 8.0 * min(4 ** len(rows), 2 * len(terms) * 2 ** len(rows)) * N
        elif kind == "lane_u":
            lane += 1024.0 * N
        elif kind == "window" and op[2] >= 3:
            lane += 8.0 * (1 << op[2]) * N
        elif kind == "window":
            flops += 8.0 * (1 << op[2]) * N
        elif kind == "matrix":
            flops += (6.0 if _op_is_diag(op) else 16.0) * N / (1 << len(op[2]))
        elif kind in ("parity", "diagw"):
            flops += 6.0 * N / (1 << len(op[2]))
    return 2.0 * 2 * N * itemsize, flops, lane


def _bound_ms(work: tuple, f32: bool) -> tuple[float, float]:
    """(bytes ms, operations ms) of ``_pass_work``'s work on the card: the
    bytes at HBM_BYTES_PER_S; the flops at the rate each product runs at:
    in f32 the lane_u products and those of windows of span 3 or more at
    TF32X3_FLOPS (3xTF32 on the tensor cores), the rest at
    PEAK_FP32_FLOPS; in f64 all at PEAK_FP64_FLOPS."""
    nbytes, flops, lane = work
    if f32:
        ops_s = flops / PEAK_FP32_FLOPS + lane / TF32X3_FLOPS
    else:
        ops_s = (flops + lane) / PEAK_FP64_FLOPS
    return nbytes / HBM_BYTES_PER_S * 1e3, ops_s * 1e3


def _swaps(lk=0, lh=None, sk=0, sh=None, pair=None) -> dict:
    return dict(load_swap_k=lk, load_swap_hi=lh, store_swap_k=sk, store_swap_hi=sh,
                pair_swap=pair)


def _kernel_cases(n: int, tb: int, rng):
    """(name, ops, fused_run swap keywords) covering every op kind and
    every folded-swap form at n qubits, tile bits tb."""
    import numpy as np

    from quest_tpu_torch.ops.fused_gates import HashableMatrix as HM

    def ru():
        q, _ = np.linalg.qr(rng.randn(2, 2) + 1j * rng.randn(2, 2))
        return HM(q)

    def rk(d, scale):  # a Kraus operator; a non-CPTP set unless scaled so
        return HM(scale * (rng.randn(d, d) + 1j * rng.randn(d, d)))

    # kraus ops: rows below, columns at the top of the tile, or relocated
    # there by folded swaps from above it (as the planner's frames do)
    signed = tuple((s, rk(2, 0.5)) for s in (1.0, -1.0, 1.0))
    kraus = (("kraus1", 2, tb - 1, signed),
             ("kraus2", 1, 0, tb - 1, tb - 2, tuple((1.0, rk(4, 0.4)) for _ in range(3))),
             ("krausn", (4, 0, 2), (tb - 1, tb - 3, tb - 2),
              ((1.0, rk(8, 0.3)), (-1.0, rk(8, 0.2)))))
    kraus_swapped = (("kraus1", 5, tb - 1, signed),
                     ("kraus2", 3, 4, tb - 2, tb - 1, ((1.0, rk(4, 0.5)),)),
                     ("krausn", (5, 1, 3), (tb - 2, tb - 1, tb - 3),
                      ((1.0, rk(8, 0.3)), (1.0, rk(8, 0.3)))))

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
    cases = [("matrix", matrix, _swaps()), ("parity", parity, _swaps()),
             ("swap", swap, _swaps()), ("diagw", diagw, _swaps()),
             ("lane_u", lane, _swaps()), ("window", window, _swaps())]
    for op, sw in zip(kraus, kraus_swapped):
        k = len(op[1]) if op[0] == "krausn" else int(op[0][-1])
        cases.append((op[0], (op,), _swaps()))
        cases.append((f"{op[0]}+swap", (sw,), _swaps(k, n - k, k, n - k)))
    # a row qubit from above the tile (the pair swap) and its column qubit
    cases.append(("kraus1+pair_swap", (("kraus1", tb - 2, tb - 1, signed),),
                  _swaps(1, n - 1, 1, n - 1, (tb - 2, n - 2))))
    # lane_u under a pair swap (on bit 1 with a block swap, on bit 3
    # alone): the folded swaps' gathers in the f32 tensor-core instantiation
    cases.append(("lane_u+pair_swap bit 1", lane[:9] + window[:5],
                  _swaps(1, n - 1, 1, n - 1, (1, n - 2))))
    cases.append(("lane_u+pair_swap bit 3", lane[:9] + parity,
                  _swaps(0, None, 0, None, (3, n - 3))))
    # lane_u folds before and after a krausn op (its rows in the lane
    # zone): in f32 the lane_u instantiation runs the krausn arm too
    cases.append(("lane_u+krausn", lane[:9] + kraus[2:] + lane[9:18], _swaps()))
    return cases + [
            ("load_swap", mixed, _swaps(2, None, 0, None)),
            ("store_swap", mixed, _swaps(0, None, 3, None)),
            ("load+store_swap", mixed, _swaps(2, None, 2, None)),
            ("asymmetric_swap", mixed, _swaps(1, n - 1, 2, tb + 1))]


def _shard_kernel_cases(n: int, nl: int, rng):
    """(name, ops, fused_run swap keywords) of the per-shard kernel checks
    on an n-qubit state sharded with nl local qubits: matrix ops with
    controls on sharded qubits (both control states) and diagonal targets
    there, diagw and parity ops with members on them, a controlled swap,
    and a mixed run with lane and window folds under shard-local folded
    swaps (load: [tb-2, tb) with [nl-2, nl); store: [tb-1, tb) with
    [tb, tb+1))."""
    import numpy as np

    from quest_tpu_torch.ops.fused_gates import HashableMatrix as HM

    def ru():
        q, _ = np.linalg.qr(rng.randn(2, 2) + 1j * rng.randn(2, 2))
        return HM(q)

    s1, s2 = n - 1, n - 2  # sharded qubits: bits of the shard index
    roles = (("matrix", 3, (s1,), (1,), ru()),
             ("matrix", 9, (s2, 8), (0, 1), ru()),
             ("matrix", 0, (s1, s2), (0, 0), ru()),
             ("matrix", s1, (2,), (1,), HM(np.diag([1j, -1]))),
             ("matrix", s2, (s1,), (0,), HM(np.diag(np.exp([0.3j, -1.1j])))))
    diag = (("diagw", (1, s1, 10), (s2,), HM(np.exp(1j * rng.rand(8)))),
            ("diagw", (s2, s1), (), HM(np.exp(1j * rng.rand(4)))),
            ("parity", (0, s1, 12), (), 0.77),
            ("parity", (s2, 5), (s1,), -1.3))
    swap = (("swap", 1, 11, (s1,), (0,)),)
    folds = (tuple(("matrix", q % 7, (), (), ru()) for q in range(9))
             + tuple(("matrix", 7 + q % 5, (), (), ru()) for q in range(10)))
    return [("sharded controls", roles, _swaps()),
            ("sharded diagw and parity", diag + swap, _swaps()),
            ("mixed, shard-local folded swaps", roles + diag + swap + folds,
             _swaps(2, nl - 2, 1, None))]


def _window_runs(tb: int, rng):
    """(name, ops) of the window checks at tile bits tb: 25 random
    one-qubit gates on [7, min(tb, 12)), which fold into one window op; the
    same after 21 on the lane qubits (a lane_u fold, then the window); and
    the window, a 2x2 controlled from the window's zone, then the lane_u
    fold."""
    import numpy as np

    from quest_tpu_torch.ops.fused_gates import HashableMatrix as HM

    def ru():
        return HM(np.linalg.qr(rng.randn(2, 2) + 1j * rng.randn(2, 2))[0])

    window = tuple(("matrix", 7 + q % (min(tb, 12) - 7), (), (), ru()) for q in range(25))
    lane = tuple(("matrix", q % 7, (), (), ru()) for q in range(21))
    return [("window", window), ("window+lane_u", lane + window),
            ("window+matrix+lane_u", window + (("matrix", 3, (8,), (1,), ru()),) + lane)]


def _shard_kernel_phase(dev, rng) -> dict:
    """The per-shard kernel at N_KERNEL qubits over N_SHARDS virtual shards
    of cuda:0, f32 and f64: each shard's pass (``fused_run`` with
    ``local_n`` and the shard's index) against ``fused_run_plain`` with the
    same index, and the shards' results together against the one-device
    kernel on the whole state; errors over the largest amplitude. Returns
    {dtype: max abs error}."""
    import torch

    from quest_tpu_torch.ops import fused_gates as FG

    n = N_KERNEL
    nl = n - (N_SHARDS - 1).bit_length()
    errs = {}
    for dt, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        tb = FG.HOPPER_TILE_BITS[dt]
        st = torch.as_tensor(rng.randn(2, 1 << n), dtype=dt, device=dev)
        st /= st.norm()
        shards = [c.contiguous() for c in st.chunk(N_SHARDS, dim=1)]
        outs = [torch.empty_like(c) for c in shards]
        whole = torch.empty_like(st)
        errs[dt] = 0.0
        for name, ops, sw in _shard_kernel_cases(n, nl, rng):
            prep = FG.PreparedRun(ops, tb)
            worst = worst_rel = 0.0
            for r, (shard, out) in enumerate(zip(shards, outs)):
                ref = FG.fused_run_plain(shard, prep, n=n, tile_bits=tb, local_n=nl,
                                         shard_index=r, **sw)
                FG.fused_run(shard, n=n, ops=ops, tile_bits=tb, out=out, prepared=prep,
                             local_n=nl, shard_index=r, **sw)
                torch.cuda.synchronize()
                err, rel = _rel_err(out, ref)
                _require(rel <= tol, f"per-shard {dt} {name} shard {r}: error {err} "
                                     f"({rel} relative) > {tol}")
                worst, worst_rel = max(worst, err), max(worst_rel, rel)
            FG.fused_run(st, n=n, ops=ops, tile_bits=tb, out=whole, prepared=prep, **sw)
            err_w, rel_w = _rel_err(torch.cat(outs, dim=1), whole)
            _require(rel_w <= tol, f"per-shard {dt} {name}: shards against the one-device "
                                   f"kernel {err_w} ({rel_w} relative) > {tol}")
            errs[dt] = max(errs[dt], worst)
            print(f"# kernel per shard {str(dt)[6:]} {name}: {n}q over {N_SHARDS} shards "
                  f"(local_n {nl}), folded kinds {sorted({o[0] for o in prep.ops})}, "
                  f"max_abs_err {worst:.3e} ({worst_rel:.3e} of the largest) against the "
                  f"plain version with the shard's index, {err_w:.3e} ({rel_w:.3e} of the largest) against the one-device "
                  f"kernel (limit {tol:g})")
        del st, shards, outs, whole
        torch.cuda.empty_cache()
    return errs


def _run_item(run) -> tuple:
    """(op count, prepared run, fused_run keywords) of a planned run."""
    return len(run.ops), run.prepare(), dict(
        tile_bits=run.tile_bits, **_swaps(run.load_swap_k, run.load_swap_hi,
                                          run.store_swap_k, run.store_swap_hi))


def _rel_err(out, ref) -> tuple[float, float]:
    """(max |out - ref|, that over max |ref|): kernel against plain."""
    err = (out - ref).abs().max().item()
    return err, err / ref.abs().max().item()


def _passes(items, n: int, dt, dev, rng, tol: float, label: str) -> dict:
    """Each pass (``_run_item``) through the kernel against the plain
    version on a random normalised n-qubit state, the max error over the
    largest amplitude within ``tol``, and timed (CUDA events, 5 launches);
    one ``# pass`` line each. Returns the per-pass lists and the max error."""
    import torch

    from quest_tpu_torch.ops import fused_gates as FG

    itemsize = torch.finfo(dt).bits // 8
    st = torch.as_tensor(rng.randn(2, 1 << n), dtype=dt, device=dev)
    st /= st.norm()
    out = torch.empty_like(st)
    res = {"ms": [], "plain_ms": [], "bound_ms": [], "by_ops": [], "kinds": set(),
           "max_abs_err": 0.0}
    for i, (nops, prep, kw) in enumerate(items):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        ref = FG.fused_run_plain(st, prep, n=n, **kw)
        e1.record()
        torch.cuda.synchronize()
        t_plain = e0.elapsed_time(e1)
        ms = _cuda_ms(lambda: FG.fused_run(st, n=n, ops=prep.ops, out=out,
                                           prepared=prep, **kw), 5)
        err, rel = _rel_err(out, ref)
        del ref
        _require(rel <= tol, f"{label} pass {i} error {err} ({rel} relative) > {tol}")
        b_bytes, b_ops = _bound_ms(_pass_work(prep, n, itemsize), dt == torch.float32)
        kinds = [o[0] for o in prep.ops]
        res["ms"].append(ms)
        res["plain_ms"].append(t_plain)
        res["bound_ms"].append(max(b_bytes, b_ops))
        res["by_ops"].append(b_ops > b_bytes)
        res["kinds"].update(kinds)
        res["max_abs_err"] = max(res["max_abs_err"], err)
        folds = ", ".join(f"{k} {kinds.count(k)}" for k in
                          ("lane_u", "window", "kraus1", "kraus2", "krausn")
                          if k in kinds)
        pair = f" pair {kw['pair_swap']}" if kw.get("pair_swap") else ""
        twos = sum(FG._opens_sweep(r) for r in prep.records)
        sweeps = len(FG.sweep_spans(prep.table, dt))
        res.setdefault("two_by_two", []).append(twos)
        res.setdefault("sweeps", []).append(sweeps)
        print(f"# {label} pass {i}: {nops} ops -> {len(kinds)} "
              f"({folds or 'no folds or channels'}; {len(prep.records)} records, {twos} 2x2 "
              f"in {sweeps} sweeps), swaps "
              f"load {kw['load_swap_k']} "
              f"store {kw['store_swap_k']}{pair}: kernel {ms:.4f} ms, bound "
              f"{max(b_bytes, b_ops):.4f} ms by "
              f"{'operations' if b_ops > b_bytes else 'bytes'}, plain "
              f"{t_plain:.2f} ms, max_abs_err {err:.3e} ({rel:.3e} of the largest)")
    return res


def _superop_exact(st, op, prep, n: int):
    """The exact product of a kraus op's superoperator on the planar state
    ``st`` in complex128 (OUT[g] = X[g] S^T, X[g][e] = x[base(g) + dep(e)]
    over the groups g of the n-qubit index, S^T from ``prep``'s table),
    the amplitudes as a (2, 2^n) float64 tensor."""
    import numpy as np
    import torch

    from quest_tpu_torch.ops.fused_gates import kraus_parts

    rows, cols, _ = kraus_parts(op)
    qubits = sorted(rows + cols)
    G = 1 << len(qubits)
    off = int(prep.table[0, 6])
    stt = torch.as_tensor(prep.coeffs[off:off + G * G].reshape(G, G)
                          + 1j * prep.coeffs[off + G * G:off + 2 * G * G].reshape(G, G),
                          device=st.device)
    free = [q for q in range(n) if q not in qubits]

    def deposit(v, bits):
        out = torch.zeros_like(v)
        for j, q in enumerate(bits):
            out |= ((v >> j) & 1) << q
        return out

    idx = (deposit(torch.arange(1 << (n - len(qubits)), device=st.device), free)[:, None]
           + deposit(torch.arange(G, device=st.device), qubits)[None, :])
    psi = torch.complex(st[0].double(), st[1].double())
    out = torch.empty_like(psi)
    out[idx] = psi[idx] @ stt
    del idx, psi
    return torch.stack([out.real, out.imag])


def _kraus_ops_at_width(dt, dev, rng) -> dict:
    """Each kraus kind alone in one pass over the 28-qubit flattened state
    of the density path (no swap; the column qubits at the top of the
    tile): kernel against plain, timed, with its bound; against the exact
    superoperator product in complex128 (within the limit against plain,
    1e-5 of the largest amplitude in f32, 1e-12 in f64); and the
    yardstick, one complex ``torch.matmul`` (complex64 / complex128) of
    the (2^(28 - 2t), 4^t) state by a (4^t, 4^t) matrix: the same product
    with the channel's qubits taken as the lowest 2t, which the port never
    calls."""
    import numpy as np
    import torch

    from quest_tpu_torch.channels import depolarising_kraus
    from quest_tpu_torch.fusion import PallasRun
    from quest_tpu_torch.ops import fused_gates as FG

    n = 2 * N_DENSITY
    tb = FG.hopper_tile_bits(n, dt)
    HM = FG.HashableMatrix

    def rk(d):
        return HM(0.3 * (rng.randn(d, d) + 1j * rng.randn(d, d)))

    xxx = np.kron(np.kron([[0, 1], [1, 0]], [[0, 1], [1, 0]]), [[0, 1], [1, 0]])
    runs = {
        "kraus1": ("kraus1", 0, tb - 1,
                   tuple((1.0, HM(K)) for K in depolarising_kraus(0.05))),
        "kraus2": ("kraus2", 0, 1, tb - 2, tb - 1, tuple((1.0, rk(4)) for _ in range(3))),
        "krausn": ("krausn", (2, 3, 4), (tb - 3, tb - 2, tb - 1),
                   ((1.0, HM(0.8 * xxx)), (1.0, HM(0.6j * np.eye(8))))),
    }

    tol = 1e-5 if dt == torch.float32 else 1e-12
    label = f"kraus ops alone {str(dt)[6:]}"
    items = [_run_item(PallasRun((op,), tb)) for op in runs.values()]
    res = _passes(items, n, dt, dev, rng, tol, label)
    st = torch.as_tensor(rng.randn(2, 1 << n), dtype=dt, device=dev)
    st /= st.norm()
    out = {"max_abs_err": res["max_abs_err"]}
    for i, (kind, op) in enumerate(runs.items()):
        _, prep, kw = items[i]
        x = st.clone()
        FG.fused_run(x, n=n, ops=prep.ops, prepared=prep, **kw)
        ex = _superop_exact(st, op, prep, n)
        rel_exact = ((x.double() - ex).abs().max() / ex.abs().max()).item()
        del x, ex
        _require(rel_exact <= tol,
                 f"{label} {kind}: {rel_exact} of the largest from the exact product")
        G = 1 << (2 * len(FG.kraus_parts(op)[0]))
        xc = torch.complex(st[0], st[1]).reshape(-1, G)
        S = torch.as_tensor(rng.randn(G, G) + 1j * rng.randn(G, G), dtype=xc.dtype, device=dev)
        lib_ms = _cuda_ms(lambda: torch.matmul(xc, S), 10)
        call = f"torch.matmul {str(xc.dtype)[6:]} ({xc.shape[0]} x {G} by {G} x {G})"
        del xc
        torch.cuda.empty_cache()
        ms, bound = res["ms"][i], res["bound_ms"][i]
        out[kind] = {"ms": ms, "bound_ms": bound, "plain_ms": res["plain_ms"][i],
                     "bound_by": "operations" if res["by_ops"][i] else "bytes",
                     "share_of_bound": bound / ms, "library_ms": lib_ms, "library_call": call,
                     "rel_err_vs_exact": rel_exact}
        print(f"# {label} {kind} at {n}q: kernel {ms:.4f} ms ({bound / ms:.1%} of the bound), "
              f"bound {bound:.4f} ms by {out[kind]['bound_by']}, {call} {lib_ms:.4f} ms "
              f"(kernel / matmul {ms / lib_ms:.2f}), plain {res['plain_ms'][i]:.2f} ms; "
              f"{rel_exact:.3e} of the largest from the exact superoperator product")
    del st
    torch.cuda.empty_cache()
    return out


def _lane_u_phase(dev, rng, dt) -> dict:
    """One-op lane_u passes at N_MAIN qubits in ``dt`` through ``fused_run``:
    a Haar 128x128 unitary, and a random 3-qubit unitary on [LANE_BLOCK_LO,
    LANE_BLOCK_LO + 3) folded into the lane zone by ``fusion.lane_u_run``.
    Each launch counted; the result against ``fused_run_plain`` (limit 1e-5
    of the largest amplitude in f32, 1e-12 in f64) and against the exact
    complex128 product (f64: the same limit); then the pass's time (CUDA
    events) beside its bound (f32: at the 3xTF32 rate; f64: at
    PEAK_FP64_FLOPS), its share of the bound, the plain version's time and
    one complex ``torch.matmul`` (complex64; complex128 in f64) of the
    (2^(N_MAIN-7), 128) state by the 128x128 matrix, the same product."""
    import numpy as np
    import torch

    from quest_tpu_torch import fusion
    from quest_tpu_torch.ops import fused_gates as FG

    n = N_MAIN
    f32 = dt == torch.float32
    tol = 1e-5 if f32 else 1e-12
    tb = FG.hopper_tile_bits(n, dt)

    def haar(d):
        q, r = np.linalg.qr(rng.randn(d, d) + 1j * rng.randn(d, d))
        return q * (np.diag(r) / np.abs(np.diag(r)))

    u = haar(128)
    block = fusion.FusedBlock(tuple(range(LANE_BLOCK_LO, LANE_BLOCK_LO + 3)), haar(8))
    runs = {"haar 128x128": FG.PreparedRun(
                (("lane_u", FG.HashableMatrix(np.stack([u.real.T, u.imag.T,
                                                        u.real.T + u.imag.T]))),), tb),
            f"3-qubit block on {list(block.qubits)}": fusion.lane_u_run(block, tb)}
    st = torch.as_tensor(rng.randn(2, 1 << n), dtype=dt, device=dev)
    st /= st.norm()
    xc = torch.complex(st[0], st[1]).reshape(-1, FG._LANES)
    rows, launches, worst = [], 0, 0.0
    for name, prep in runs.items():
        (op,) = prep.ops
        _require(op[0] == "lane_u", f"lane_u phase: {name} did not fold to one lane_u op")
        w = np.asarray(op[1].arr).real
        x = st.clone()
        FG.fused_run.launches = 0
        FG.fused_run(x, n=n, ops=prep.ops, tile_bits=tb, prepared=prep)
        torch.cuda.synchronize()
        _require(FG.fused_run.launches == 1, f"lane_u phase: {name} launches")
        launches += 1
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        ref = FG.fused_run_plain(st, prep, n=n, tile_bits=tb)
        e1.record()
        torch.cuda.synchronize()
        plain_ms = e0.elapsed_time(e1)
        err, rel = _rel_err(x, ref)
        _require(rel <= tol, f"lane_u {name} {dt}: error {err} ({rel} relative) > {tol}")
        del ref
        wc = torch.as_tensor(w[0] + 1j * w[1], device=dev)
        exact = xc.to(torch.complex128) @ wc
        ex = torch.stack([exact.real.reshape(-1), exact.imag.reshape(-1)])
        rel_exact = ((x.double() - ex).abs().max() / ex.abs().max()).item()
        del exact, ex
        _require(f32 or rel_exact <= tol,
                 f"lane_u {name} {dt}: {rel_exact} of the largest from the exact product")
        ms = _cuda_ms(lambda: FG.fused_run(x, n=n, ops=prep.ops, tile_bits=tb, prepared=prep),
                      20)
        wcl = wc.to(xc.dtype)
        lib_ms = _cuda_ms(lambda: torch.matmul(xc, wcl), 20)
        b_bytes, b_ops = _bound_ms(_pass_work(prep, n, 4 if f32 else 8), f32)
        bound = max(b_bytes, b_ops)
        by = "operations" if b_ops > b_bytes else "bytes"
        worst = max(worst, err)
        rows.append({"name": name, "ms": ms, "bound_ms": bound, "bound_by": by,
                     "share_of_bound": bound / ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "max_abs_err": err, "max_rel_err": rel,
                     "rel_err_vs_exact": rel_exact})
        print(f"# lane_u {name} at {n}q {str(dt)[6:]}: kernel {ms:.4f} ms ({bound / ms:.1%} "
              f"of the bound), bound {bound:.4f} ms by {by}, torch.matmul {lib_ms:.4f} ms, "
              f"plain {plain_ms:.2f} ms; max_abs_err {err:.3e} ({rel:.3e} of the largest, "
              f"limit {tol:g}), {rel_exact:.3e} of the largest from the exact complex128 "
              f"product")
        del x
        torch.cuda.empty_cache()
    del st, xc
    torch.cuda.empty_cache()
    return {"rows": rows, "launches": launches, "max_abs_err": worst}


def _window_fold_pass(dev, rng, runs, dt) -> dict:
    """The fused-run kernel's window fold alone: one pass at N_MAIN qubits
    in ``dt`` of the window op that 25 random one-qubit gates on qubits [7,
    11] fold into at the Hopper tile (2^13 in f32, 2^12 in f64: the same
    zone; ``window_mma`` in f32, ``window_dmma`` in f64), against the plain
    version (1e-5 of the largest amplitude in f32, 1e-12 in f64) and timed
    beside its bound; against the exact complex128 product (within the
    same limit); one complex ``torch.matmul``
    (complex64 / complex128) of the 32 x 32 matrix with a complex (2^(N_MAIN
    - 12), 32, 128) copy of the state, the same product, which the port
    never calls; and the folds that ``runs``, the main path's circuit
    planned at ``dt``'s tile, execute (one launch each run; in f32 how many
    in runs with a lane_u fold, which launch ``fused_run_kernel<float,
    true>``)."""
    import numpy as np
    import torch

    from quest_tpu_torch.ops import fused_gates as FG

    n = N_MAIN
    name = str(dt)[6:]
    f32 = dt == torch.float32
    tol = 1e-5 if f32 else 1e-12
    tb = FG.hopper_tile_bits(n, dt)
    gates = tuple(("matrix", 7 + q % 5, (), (),
                   FG.HashableMatrix(np.linalg.qr(rng.randn(2, 2) + 1j * rng.randn(2, 2))[0]))
                  for q in range(25))
    prep = FG.PreparedRun(gates, tb)
    _require([o[0] for o in prep.ops] == ["window"], "window fold pass: no single window op")
    folds = sum(o[0] == "window" for r in runs for o in r.prepare().ops)
    # the f32 runs with a lane_u fold launch fused_run_kernel<float, true>
    in_lane = sum(o[0] == "window" for r in runs if r.prepare().has_lane_u
                  for o in r.prepare().ops)
    res = _passes([(len(gates), prep, dict(tile_bits=tb, **_swaps()))], n, dt, dev, rng,
                  tol, f"window fold alone {name}")
    ms, bound = res["ms"][0], res["bound_ms"][0]
    # against the exact product, and the yardstick
    D, off = 32, int(prep.table[0, 6])
    u = torch.as_tensor(prep.coeffs[off:off + D * D].reshape(D, D)
                        + 1j * prep.coeffs[off + D * D:off + 2 * D * D].reshape(D, D), device=dev)
    st = torch.as_tensor(rng.randn(2, 1 << n), dtype=dt, device=dev)
    st /= st.norm()
    x = st.clone()
    FG.fused_run(x, n=n, ops=prep.ops, tile_bits=tb, prepared=prep)
    xc = torch.complex(st[0], st[1]).reshape(-1, D, 1 << 7)
    exact = torch.matmul(u, xc.to(torch.complex128)).reshape(-1)
    ex = torch.stack([exact.real, exact.imag])
    del exact
    rel_exact = ((x.double() - ex).abs().max() / ex.abs().max()).item()
    del x, ex
    _require(rel_exact <= tol,
             f"window fold alone {name}: {rel_exact} of the largest from the exact product")
    ul = u.to(xc.dtype)
    lib_ms = _cuda_ms(lambda: torch.matmul(ul, xc), 20)
    call = f"torch.matmul {str(xc.dtype)[6:]} (32 x 32 by {xc.shape[0]} x 32 x 128)"
    del st, xc
    torch.cuda.empty_cache()
    by = "operations" if res["by_ops"][0] else "bytes"
    print(f"# window fold alone at {n}q {name}: kernel {ms:.4f} ms ({bound / ms:.1%} of the "
          f"bound), bound {bound:.4f} ms by {by}; {call} {lib_ms:.4f} ms (kernel / matmul "
          f"{ms / lib_ms:.3f}); {rel_exact:.3e} of the largest from the exact complex128 "
          f"product; window folds in the main path's plan at tile_bits {tb}: {folds} (one "
          f"launch each run" + (f"; {in_lane} in <float, true>, {folds - in_lane} in "
                                f"<float, false>)" if f32 else ")"))
    return {"ms": ms, "bound_ms": bound, "plain_ms": res["plain_ms"][0], "bound_by": by,
            "share_of_bound": bound / ms, "library_ms": lib_ms, "library_call": call,
            "rel_err_vs_exact": rel_exact, "main_path_folds": folds,
            "main_path_folds_in_lane_u_runs": in_lane,
            "max_abs_err": res["max_abs_err"]}


def _diag_arm_alone(dev, runs, dt) -> dict:
    """The fused-run kernel's diagonal arm alone: the elementwise ops of
    the run of ``runs`` (the QFT planned at ``dt``'s tile) that holds the
    most (its 75-96 controlled phases), in one N_MAIN-qubit pass with no
    folded swap, merged into ``diagw`` records (``merge_diagonals``):
    against the plain version (1e-5 / 1e-12 of the largest amplitude),
    timed beside its bytes bound, the plain version and one complex
    ``torch.mul`` (complex64 / complex128) of the state by the same
    diagonal, precomputed on the card, which the port never calls; and the
    pass timed at each table width of DIAG_WIDTHS (``# diagonal arm alone``
    line)."""
    import numpy as np
    import torch

    from quest_tpu_torch.ops import fused_gates as FG

    n = N_MAIN
    name = str(dt)[6:]
    tol = 1e-5 if dt == torch.float32 else 1e-12
    run = max(runs, key=lambda r: sum(FG._op_is_diag(o) for o in r.prepare().ops))
    ops = tuple(o for o in run.prepare().ops if FG._op_is_diag(o))
    tb = run.tile_bits
    prep = FG.PreparedRun(ops, tb)
    rng = np.random.RandomState(37)
    res = _passes([(len(ops), prep, dict(tile_bits=tb, **_swaps()))], n, dt, dev, rng, tol,
                  f"diagonal arm alone {name}")
    ms, bound = res["ms"][0], res["bound_ms"][0]
    _require(len(prep.records) < len(ops), f"diagonal arm alone {name}: {len(ops)} ops "
                                           f"encode to {len(prep.records)} records")
    st = torch.as_tensor(rng.randn(2, 1 << n), dtype=dt, device=dev)
    st /= st.norm()
    widths = {}
    for w in DIAG_WIDTHS:
        p = FG.PreparedRun(ops, tb, diag_bits=w)
        widths[w] = {"records": len(p.records), "ms": _cuda_ms(
            lambda: FG.fused_run(st, n=n, ops=p.ops, tile_bits=tb, prepared=p), 5)}
    # the yardstick: the same diagonal as one complex tensor, times the state
    one = torch.zeros_like(st)
    one[0] = 1
    d = FG.fused_run_plain(one, prep, n=n, tile_bits=tb)
    diag = torch.complex(d[0], d[1])
    del d, one
    c = torch.complex(st[0], st[1])
    o = torch.empty_like(c)
    lib_ms = _cuda_ms(lambda: torch.mul(c, diag, out=o), 20)
    call = f"torch.mul {str(c.dtype)[6:]}"
    del st, c, diag, o
    torch.cuda.empty_cache()
    tables = [len(r[1]) for r in prep.records]
    print(f"# diagonal arm alone at {n}q {name}: the QFT run's {len(ops)} elementwise ops -> "
          f"{len(prep.records)} diagw records (tables of {tables} qubits) at tile_bits {tb}: "
          f"kernel {ms:.4f} ms ({bound / ms:.1%} of the bound), bound {bound:.4f} ms by bytes, "
          f"plain {res['plain_ms'][0]:.2f} ms; {call} of the state by the diagonal "
          f"{lib_ms:.4f} ms (kernel / mul {ms / lib_ms:.3f}); max_abs_err "
          f"{res['max_abs_err']:.3e} (limit {tol:g} of the largest); by table width: "
          + ", ".join(f"{w}: {v['records']} records {v['ms']:.4f} ms" for w, v in widths.items()))
    return {"ops": len(ops), "records": len(prep.records), "tables": tables, "ms": ms,
            "bound_ms": bound, "bound_by": "bytes", "share_of_bound": bound / ms,
            "plain_ms": res["plain_ms"][0], "library_ms": lib_ms, "library_call": call,
            "max_abs_err": res["max_abs_err"], "by_width": widths}


#: the 2x2 arm alone: 14 non-diagonal 2x2s in the main path's gate mix (H,
#: Rx and a CNOT ladder) with T and Rz between them, on the qubits [7, 12):
#: (kind, target, control) per gate, "cx" a CNOT from the control
TWO_BY_TWO_RUN = (("h", 7, None), ("t", 8, None), ("rx", 9, None), ("cx", 8, 7),
                  ("rz", 10, None), ("h", 11, None), ("cx", 9, 8), ("t", 7, None),
                  ("rx", 10, None), ("cx", 10, 9), ("h", 8, None), ("rz", 11, None),
                  ("cx", 11, 10), ("rx", 7, None), ("t", 9, None), ("h", 9, None),
                  ("rx", 11, None), ("rz", 8, None), ("h", 10, None), ("rx", 8, None))


def _two_by_two_ops(rng) -> tuple:
    """TWO_BY_TWO_RUN as fused-run ops, its angles from ``rng``."""
    import numpy as np

    from quest_tpu_torch.ops import fused_gates as FG

    ops = []
    for kind, q, c in TWO_BY_TWO_RUN:
        th = float(rng.uniform(-np.pi, np.pi))
        m = {"h": np.array([[1, 1], [1, -1]]) / np.sqrt(2),
             "t": np.diag([1, np.exp(0.25j * np.pi)]),
             "rx": np.array([[np.cos(th / 2), -1j * np.sin(th / 2)],
                             [-1j * np.sin(th / 2), np.cos(th / 2)]]),
             "rz": np.diag([np.exp(-0.5j * th), np.exp(0.5j * th)]),
             "cx": np.array([[0, 1], [1, 0]])}[kind]
        ops.append(("matrix", q, () if c is None else (c,), () if c is None else (1,),
                    FG.HashableMatrix(m)))
    return tuple(ops)


def _below_fold(ops, tb: int):
    """A PreparedRun of ``ops`` as given, the records of one arm: the zone
    fold, which would contract a run of 2x2s on [7, 12) into a window, is
    skipped."""
    from unittest import mock

    from quest_tpu_torch.ops import fused_gates as FG

    with mock.patch.object(FG, "_fold_zone_ops", lambda o, t: tuple(o)):
        return FG.PreparedRun(ops, tb)


def _densest_2x2_run(runs):
    """Of ``runs``, the one with the most 2x2 and swap records among those
    that hold no lane_u, window or kraus record (the 2x2 arm's own passes)."""
    from quest_tpu_torch.ops import fused_gates as FG

    own = [r for r in runs if not {o[0] for o in r.prepare().records}
           & {"lane_u", "window", "kraus1", "kraus2", "krausn"}]
    return max(own, key=lambda r: sum(FG._opens_sweep(o) for o in r.prepare().records))


def _two_by_two_arm_alone(dev, runs64, dt) -> dict:
    """The fused-run kernel's 2x2 arm alone (``reg_sweep``): one N_MAIN-qubit
    pass with no folded swap, in ``dt``, of (a) TWO_BY_TWO_RUN's records,
    built below the fold (``_below_fold``), and (b) the f64 main path's run
    (of ``runs64``) with the most 2x2 records and no lane_u, window or
    kraus record (``_densest_2x2_run``), without its folded swaps. Each
    against the plain version (1e-5 / 1e-12 of the largest amplitude),
    timed beside its bytes bound and the plain version, with its 2x2
    records and sweeps (at the kernel's width; other widths are variant
    builds of ``chip_lane_u_breakdown.py --passes sweep32,sweep64``); (a)
    also beside one complex ``torch.matmul`` (complex64 / complex128) of
    the state's [7, 12) view by the run's 32 x 32 product, precomputed on
    the card, which the port never calls; (b) beside the same call, a
    yardstick of the same bytes (``# 2x2 arm alone`` lines)."""
    import numpy as np
    import torch

    from quest_tpu_torch.fusion import event_matrix
    from quest_tpu_torch.ops import fused_gates as FG

    n = N_MAIN
    name = str(dt)[6:]
    tol = 1e-5 if dt == torch.float32 else 1e-12
    rng = np.random.RandomState(41)
    ops = _two_by_two_ops(rng)
    dense = _densest_2x2_run(runs64)
    U = np.eye(32, dtype=complex)
    for op in ops:
        U = event_matrix(FG._op_event(op), tuple(range(7, 12))) @ U
    st = torch.as_tensor(rng.randn(2, 1 << n), dtype=dt, device=dev)
    st /= st.norm()
    xc = torch.complex(st[0], st[1]).reshape(-1, 32, 1 << 7)
    u = torch.as_tensor(U, dtype=xc.dtype, device=dev)
    lib_ms = _cuda_ms(lambda: torch.matmul(u, xc), 20)
    call = f"torch.matmul {str(xc.dtype)[6:]} (32 x 32 by {xc.shape[0]} x 32 x 128)"
    del st, xc, u
    torch.cuda.empty_cache()
    out = {"library_ms": lib_ms, "library_call": call, "max_abs_err": 0.0}
    cases = (("run_7_12", "the [7, 12) run", _below_fold(ops, FG.hopper_tile_bits(n, dt))),
             ("main_path_f64_densest", "the f64 main path's densest 2x2 run",
              FG.PreparedRun(dense.ops, dense.tile_bits)))
    for key, what, prep in cases:
        tb = prep.tile_bits
        twos = sum(FG._opens_sweep(r) for r in prep.records)
        res = _passes([(len(prep.ops), prep, dict(tile_bits=tb, **_swaps()))], n, dt, dev, rng,
                      tol, f"2x2 arm alone {name} {what}")
        ms, bound = res["ms"][0], res["bound_ms"][0]
        by = "operations" if res["by_ops"][0] else "bytes"
        print(f"# 2x2 arm alone at {n}q {name}, {what}: {len(prep.ops)} ops -> "
              f"{len(prep.records)} records, {twos} 2x2 in {res['sweeps'][0]} sweeps at "
              f"width {FG.SWEEP_BITS[dt]}, tile_bits {tb}: kernel {ms:.4f} ms ({bound / ms:.1%} "
              f"of the bound), bound {bound:.4f} ms by {by}, plain {res['plain_ms'][0]:.2f} ms; "
              f"{call} {lib_ms:.4f} ms (kernel / matmul {ms / lib_ms:.3f}); max_abs_err "
              f"{res['max_abs_err']:.3e} (limit {tol:g} of the largest)")
        out[key] = {"ops": len(prep.ops), "records": len(prep.records), "two_by_two": twos,
                    "sweeps": res["sweeps"][0], "ms": ms, "bound_ms": bound, "bound_by": by,
                    "share_of_bound": bound / ms, "plain_ms": res["plain_ms"][0],
                    "max_abs_err": res["max_abs_err"]}
        out["max_abs_err"] = max(out["max_abs_err"], res["max_abs_err"])
    return out


def _main_path_f64(qt, env, circ, fz, dev) -> dict:
    """The main path's circuit planned at f64 on one device (``fz``:
    ``Circuit.fused(max_qubits=5, pallas=True, dtype=float64)`` at the f64
    tile, 2^12): each run's pass through the kernel against the plain
    version (1e-12 of the largest amplitude; timed), then the circuit
    through ``Circuit.run`` on an f64 register with the counts reset just
    before it: launches must equal the runs, ``engine_fallback_total``
    must read 0, the total probability must be within 1e-10 of 1 and the
    amplitudes within 1e-10 of the largest of an f64 per-gate replay;
    then the circuit's time, gates/sec and the share of its passes' summed
    bound. The passes draw from a generator of their own."""
    import numpy as np
    import torch

    from quest_tpu_torch import fusion, telemetry
    from quest_tpu_torch.ops import fused_gates as FG

    dt, label = torch.float64, "main path f64"
    runs = [a[0] for f, a, _ in fz._tape if f is fusion._apply_pallas_run]
    other = [f.__name__ for f, _, _ in fz._tape if f is not fusion._apply_pallas_run]
    _require(runs and not other, f"{label}: plan is not all fused runs")
    res = _passes([_run_item(r) for r in runs], N_MAIN, dt, dev, np.random.RandomState(37),
                  1e-12, label)
    torch.cuda.empty_cache()
    q = qt.createQureg(N_MAIN, env, 2)
    telemetry.reset()
    FG.fused_run.launches = 0
    fz.run(q)
    torch.cuda.synchronize()
    launches = FG.fused_run.launches
    fallbacks = telemetry.counter_total("engine_fallback_total")
    passes = telemetry.counter_value("pallas_pass_total", kind="fused_run")
    _require(launches == len(runs) == passes, f"{label}: launches {launches} != runs {len(runs)}")
    _require(fallbacks == 0, f"{label}: engine fallback")
    res["launches"] = launches
    total = qt.calcTotalProb(q)
    ref_q = qt.createQureg(N_MAIN, env, 2)
    circ.run(ref_q)  # the plain replay: one gate at a time, per-gate engine
    torch.cuda.synchronize()
    diff = (q.amps - ref_q.amps).abs().max().item()
    rel = diff / ref_q.amps.abs().max().item()
    qt.destroyQureg(ref_q)
    torch.cuda.empty_cache()
    _require(abs(total - 1) <= 1e-10, f"{label}: total probability {total}")
    _require(rel <= 1e-10, f"{label}: fused vs per-gate replay {diff} ({rel} of the largest)")
    reps = 5
    _warm_run(fz, q)
    t0 = time.perf_counter()
    for _ in range(reps):
        fz.run(q)
    torch.cuda.synchronize()
    circuit_ms = (time.perf_counter() - t0) / reps * 1e3
    _require(abs(qt.calcTotalProb(q) - 1) <= 1e-10, f"{label}: norm after timed reps")
    q.spare = None  # the final state stays for the readout phase
    torch.cuda.empty_cache()
    gps = len(circ) * 1e3 / circuit_ms
    bound = sum(res["bound_ms"])
    folds = sum(k == "window" for r in runs for k in (o[0] for o in r.prepare().ops))
    print(f"# {label}: {N_MAIN}q depth {DEPTH_MAIN}, {len(circ)} gates -> {len(runs)} fused "
          f"runs at tile_bits {runs[0].tile_bits} ({folds} window folds); launches "
          f"{launches}, pallas_pass_total{{fused_run}} {passes:g}, engine_fallback_total "
          f"{fallbacks:g}; calcTotalProb {total:.12f}, max |fused - per-gate replay| "
          f"{diff:.3e} ({rel:.3e} of the largest, limit 1e-10); circuit {circuit_ms:.3f} ms "
          f"({gps:.1f} gates/sec; {sum(res['ms']):.3f} ms of kernel passes against a summed "
          f"bound of {bound:.3f} ms: {bound / circuit_ms:.1%} of the circuit)")
    res.update(gates_per_sec=gps, circuit_ms=circuit_ms, runs=len(runs), window_folds=folds,
               share_of_bound=bound / circuit_ms, max_rel_diff_vs_replay=rel, qureg=q)
    return res


#: the operators that left-multiply a density register (M rho, no
#: conj-shadow, so the trace is not kept): left out of the density run
LEFT_MULT = ("applyMatrix2", "applyMatrix4", "applyMatrixN", "applyMultiControlledMatrixN")


def gate_surface_tape(circ, qt, n: int, seed: int, with_left_mult: bool = True) -> None:
    """Record on ``circ`` every function of the dense-gate surface that a
    tape takes (the gates beyond the bench set, and the applyMatrix*
    operators) twice: first on qubits inside a 5-qubit window at the bottom
    of the register (a dense block there lies below the lane boundary),
    then on qubits drawn from the whole register. Qubits, angles, axes,
    Pauli codes and matrices (at most 5 qubits, unitary, so the norm is
    kept) come from ``np.random.RandomState(seed)``. ``qt`` is the package
    whose ``createSubDiagonalOp`` builds diagonalUnitary's operator.
    ``with_left_mult=False`` records the same tape without the LEFT_MULT
    calls."""
    import numpy as np

    rng = np.random.RandomState(seed)

    def unitary(k):
        q, r = np.linalg.qr(rng.randn(1 << k, 1 << k) + 1j * rng.randn(1 << k, 1 << k))
        return q * (np.diag(r) / np.abs(np.diag(r)))

    def angle():
        return float(rng.uniform(-np.pi, np.pi))

    def pair():
        v = rng.randn(2) + 1j * rng.randn(2)
        v /= np.linalg.norm(v)
        return complex(v[0]), complex(v[1])

    def axis():
        return tuple(float(x) for x in rng.uniform(-1, 1, 3))

    def codes(k):
        return [int(c) for c in rng.randint(1, 4, k)]

    def subdiag(k):
        op = qt.createSubDiagonalOp(k)
        op.elems[:] = np.exp(1j * rng.uniform(0, 2 * np.pi, 1 << k))
        return op

    # name -> (qubits it takes, its arguments from the drawn qubits q)
    calls = {
        "phaseShift": (1, lambda q: (q[0], angle())),
        "controlledPhaseShift": (2, lambda q: (q[0], q[1], angle())),
        "multiControlledPhaseShift": (3, lambda q: (list(q), angle())),
        "multiControlledPhaseFlip": (3, lambda q: (list(q),)),
        "sGate": (1, lambda q: (q[0],)),
        "pauliY": (1, lambda q: (q[0],)),
        "pauliZ": (1, lambda q: (q[0],)),
        "controlledPauliY": (2, lambda q: (q[0], q[1])),
        "rotateY": (1, lambda q: (q[0], angle())),
        "rotateAroundAxis": (1, lambda q: (q[0], angle(), axis())),
        "controlledRotateX": (2, lambda q: (q[0], q[1], angle())),
        "controlledRotateY": (2, lambda q: (q[0], q[1], angle())),
        "controlledRotateZ": (2, lambda q: (q[0], q[1], angle())),
        "controlledRotateAroundAxis": (2, lambda q: (q[0], q[1], angle(), axis())),
        "multiRotatePauli": (3, lambda q: (list(q), codes(3), angle())),
        "multiControlledMultiRotatePauli": (
            4, lambda q: (list(q[:2]), list(q[2:]), codes(2), angle())),
        "multiControlledMultiRotateZ": (4, lambda q: (list(q[:2]), list(q[2:]), angle())),
        "diagonalUnitary": (3, lambda q: (list(q), subdiag(3))),
        "multiQubitNot": (3, lambda q: (list(q),)),
        "multiControlledMultiQubitNot": (4, lambda q: (list(q[:2]), list(q[2:]))),
        "compactUnitary": (1, lambda q: (q[0], *pair())),
        "controlledCompactUnitary": (2, lambda q: (q[0], q[1], *pair())),
        "controlledUnitary": (2, lambda q: (q[0], q[1], unitary(1))),
        "multiControlledUnitary": (3, lambda q: (list(q[:2]), q[2], unitary(1))),
        "sqrtSwapGate": (2, lambda q: (q[0], q[1])),
        "twoQubitUnitary": (2, lambda q: (q[0], q[1], unitary(2))),
        "controlledTwoQubitUnitary": (3, lambda q: (q[0], q[1], q[2], unitary(2))),
        "multiControlledTwoQubitUnitary": (
            4, lambda q: (list(q[:2]), q[2], q[3], unitary(2))),
        "multiQubitUnitary": (5, lambda q: (list(q), unitary(5))),
        "controlledMultiQubitUnitary": (4, lambda q: (q[0], list(q[1:]), unitary(3))),
        "multiControlledMultiQubitUnitary": (
            5, lambda q: (list(q[:2]), list(q[2:]), unitary(3))),
        "applyMatrix2": (1, lambda q: (q[0], unitary(1))),
        "applyMatrix4": (2, lambda q: (q[0], q[1], unitary(2))),
        "applyMatrixN": (3, lambda q: (list(q), unitary(3))),
        "applyGateMatrixN": (3, lambda q: (list(q), unitary(3))),
        "applyMultiControlledMatrixN": (4, lambda q: (list(q[:2]), list(q[2:]), unitary(2))),
        "applyMultiControlledGateMatrixN": (
            4, lambda q: (list(q[:2]), list(q[2:]), unitary(2))),
    }
    entries = []
    for low in (True, False):
        for name, (k, build) in calls.items():
            if low:
                lo = int(rng.randint(0, min(2, n - 5) + 1))
                q = tuple(int(x) for x in lo + rng.permutation(5)[:k])
            else:
                q = tuple(int(x) for x in rng.choice(n, k, replace=False))
            entries.append((name, build(q)))
    for name, args in entries:
        if with_left_mult or name not in LEFT_MULT:
            getattr(circ, name)(*args)


def _channel_kraus(name: str, args) -> tuple | None:
    """(row qubits, Kraus operators) of a Kraus-channel tape entry of the
    bench's density circuits; None for a gate or a dephasing diagonal."""
    from quest_tpu_torch.channels import depolarising_kraus

    if name == "mixDepolarising":
        return (args[0],), depolarising_kraus(args[1])
    if name == "mixKrausMap":
        return (args[0],), args[1]
    if name == "mixMultiQubitKrausMap":
        return tuple(args[0]), args[1]
    _require(not name.startswith("mix") or "Dephasing" in name,
             f"no Kraus operators for {name}")
    return None


def _engine_replay(circ, qureg) -> None:
    """The unfused tape on ``qureg``, one entry at a time: gates and
    dephasing diagonals through their own functions (the per-gate engine),
    every Kraus channel straight through the per-term engine
    (``ops.density._apply_kraus_sum``) with its Kraus operators: the
    reference the fused run is held against."""
    import numpy as np

    from quest_tpu_torch.ops import density as DN

    n = qureg.num_qubits_represented
    for fn, args, kw in circ._tape:
        channel = _channel_kraus(fn.__name__, args)
        if channel is None:
            fn(qureg, *args, **kw)
            continue
        rows, ks = channel
        qureg.put(DN._apply_kraus_sum(
            qureg.amps, [(1.0, np.asarray(k, dtype=complex)) for k in ks],
            nsv=2 * n, rows=rows, cols=tuple(q + n for q in rows)))


def _density_path(qt, env, dt, with_krausn: bool, rng, dev) -> dict:
    """The bench's channel circuit on the 14-qubit density register: plan,
    per-run kernel vs plain, the run with the counts reset just before it,
    the checks, then channel-ops/sec and the barrier channel's time."""
    import torch

    from quest_tpu_torch import fusion, telemetry
    from quest_tpu_torch.ops import density as DN
    from quest_tpu_torch.ops import fused_gates as FG

    f32 = dt == torch.float32
    prec, tol_kernel = (1, 1e-5) if f32 else (2, 1e-12)
    tol_trace, tol_amp = (1e-4, 2e-4) if f32 else (1e-10, 1e-10)
    label = f"density {'r4' if with_krausn else 'r3'} {str(dt)[6:]}"
    circ = qt.density_circuit(N_DENSITY, with_krausn)
    telemetry.reset()
    t0 = time.perf_counter()
    fz = circ.fused(max_qubits=4, pallas=True, dtype=dt)
    plan_s = time.perf_counter() - t0
    planned_barriers = telemetry.counter_total("fusion_barriers_total")
    runs = [a[0] for f, a, _ in fz._tape if f is fusion._apply_pallas_run]
    barriers = [(f.__name__, a) for f, a, _ in fz._tape
                if f not in (fusion._apply_pallas_run, fusion._apply_frame_swap)]
    nsv = 2 * N_DENSITY
    tb = FG.hopper_tile_bits(nsv, dt)
    print(f"# {label}: {N_DENSITY}q density ({nsv} flattened qubits), "
          f"{len(circ)} entries -> {len(runs)} fused runs at tile_bits "
          f"{tb}, {len(fz._tape)} passes, "
          f"fusion_barriers_total {planned_barriers:g}: "
          f"{[f'{n}{a}' for n, a in barriers]}; planned in {plan_s:.2f} s")
    _require(runs and planned_barriers == len(barriers), f"{label}: plan")
    items = [_run_item(r) for r in runs]
    for name, a in barriers:  # each barrier channel's one kraus1 pass
        rows, ks = _channel_kraus(name, a)
        _require(len(rows) == 1, f"{label}: barrier {name}{a} is not a 1-target channel")
        op, swaps = DN.kraus1_pass(N_DENSITY, rows[0], tb,
                                   tuple((1.0, FG.HashableMatrix(k)) for k in ks))
        items.append((1, FG.PreparedRun((op,), tb), dict(tile_bits=tb, **swaps)))
    res = _passes(items, nsv, dt, dev, rng, tol_kernel, label)
    torch.cuda.empty_cache()

    rho = qt.createDensityQureg(N_DENSITY, env, prec)
    qt.initPlusState(rho)
    telemetry.reset()
    FG.fused_run.launches = 0
    fz.run(rho)
    torch.cuda.synchronize()
    launches = FG.fused_run.launches
    passes = telemetry.counter_value("pallas_pass_total", kind="fused_run")
    fallbacks = telemetry.counter_total("engine_fallback_total")
    routes = {r: telemetry.counter_value("channel_route_total", route=r)
              for r in ("superop", "kernel", "engine")}
    print(f"# {label} run: launches {launches}, runs {len(runs)} + barrier "
          f"channels {len(barriers)}, pallas_pass_total{{fused_run}} {passes:g}, "
          f"engine_fallback_total {fallbacks:g}; barrier channels by route {routes}")
    _require(launches == len(runs) + len(barriers) == passes,
             f"{label}: launches != runs and barrier channels executed")
    _require(fallbacks == 0, f"{label}: engine fallback")
    _require(routes["kernel"] == len(barriers) and routes["engine"] == 0
             and routes["superop"] == 0, f"{label}: barrier routes {routes}")
    trace, purity = qt.calcTotalProb(rho), qt.calcPurity(rho)

    ref = qt.createDensityQureg(N_DENSITY, env, prec)
    qt.initPlusState(ref)
    _engine_replay(circ, ref)
    torch.cuda.synchronize()
    _require(FG.fused_run.launches == launches, f"{label}: the reference launched")
    diff = (rho.amps - ref.amps).abs().max().item()
    rel = diff / ref.amps.abs().max().item()
    purity_ref = qt.calcPurity(ref)
    p0, p0_ref = qt.calcProbOfOutcome(rho, 0, 0), qt.calcProbOfOutcome(ref, 0, 0)
    print(f"# {label} check: calcTotalProb {trace:.12f}, calcPurity {purity:.12f} "
          f"(engine replay {purity_ref:.12f}), calcProbOfOutcome(0,0) {p0:.12f} vs "
          f"{p0_ref:.12f}, max |fused - engine replay| {diff:.3e} "
          f"({rel:.3e} of the largest amplitude)")
    _require(abs(trace - 1) <= tol_trace, f"{label}: trace {trace}")
    _require(diff <= tol_amp and rel <= tol_amp, f"{label}: amplitudes {diff}, {rel}")
    _require(abs(purity - purity_ref) <= tol_amp and abs(p0 - p0_ref) <= tol_amp,
             f"{label}: readouts")
    qt.destroyQureg(ref)
    del ref
    torch.cuda.empty_cache()

    reps = 3
    _warm_run(fz, rho)
    t0 = time.perf_counter()
    for _ in range(reps):
        fz.run(rho)
    torch.cuda.synchronize()
    circuit_s = (time.perf_counter() - t0) / reps
    cops = len(circ) / circuit_s
    _require(abs(qt.calcTotalProb(rho) - 1) <= tol_trace, f"{label}: trace after reps")
    barrier_ms = [_cuda_ms(lambda: getattr(qt, name)(rho, *a), 3) for name, a in barriers]
    y = torch.empty_like(rho.amps)
    copy_ms = _cuda_ms(lambda: y.copy_(rho.amps), 10)
    print(f"# {label} channel-ops/sec: {cops:.2f} ({len(circ)} entries, "
          f"{circuit_s * 1e3:.3f} ms per circuit; kernel passes {sum(res['ms']):.3f} ms, "
          f"barrier channels {[round(b, 3) for b in barrier_ms]} ms = "
          f"{sum(barrier_ms) / (circuit_s * 1e3):.1%} of the circuit); full-state "
          f"copy_ {copy_ms:.4f} ms")
    rho.spare = None  # the final state stays for the readout phase
    del y
    torch.cuda.empty_cache()
    res.update(launches=launches, passes=len(items), channel_ops_per_sec=cops,
               circuit_ms=circuit_s * 1e3, barrier_ms=barrier_ms, copy_ms=copy_ms,
               trace=trace, purity=purity, max_abs_diff_vs_engine=diff, qureg=rho, plan=fz)
    return res


def _window_phase(dev, rng) -> dict:
    """``window_dot`` at N_MAIN qubits in f32 and f64 on WINDOWS and
    CHECK_WINDOWS (spans 1-6), each with a random unitary, without and
    with ``conj``: each call is the entry point's run, its launch counted
    from 0 just before it and read just after; its result against
    ``window_dot_plain`` on the same input. Then each window's time (CUDA
    events, after a warm-up) beside its bound, the plain version's time,
    and one complex ``torch.matmul`` of the D x D matrix with a complex
    (A, D, B) copy of the state."""
    import numpy as np
    import torch

    from quest_tpu_torch.ops import window_dot as WD

    n, N = N_MAIN, 1 << N_MAIN
    out = {}
    for dt, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        f32 = dt == torch.float32
        itemsize = torch.finfo(dt).bits // 8
        st = torch.as_tensor(rng.randn(2, N), dtype=dt, device=dev)
        st /= st.norm()
        rows, launches, max_err = [], 0, 0.0
        for lo, span in WINDOWS + CHECK_WINDOWS:
            hi, d = lo + span - 1, 1 << span
            q, r = np.linalg.qr(rng.randn(d, d) + 1j * rng.randn(d, d))
            u = q * (np.diag(r) / np.abs(np.diag(r)))
            m = torch.as_tensor(np.stack([u.real, u.imag]), dtype=dt, device=dev)
            err_w, rel_w = 0.0, 0.0
            for conj in (False, True):
                x = st.clone()
                WD.window_dot.launches = 0
                WD.window_dot(x, m, n=n, lo=lo, hi=hi, conj=conj)
                torch.cuda.synchronize()
                launched = WD.window_dot.launches
                _require(launched == 1, f"window_dot [{lo}, {hi}] launched {launched} times")
                launches += launched
                ref = WD.window_dot_plain(st, m, n=n, lo=lo, hi=hi, conj=conj)
                err, rel = _rel_err(x, ref)
                del ref
                _require(rel <= tol, f"window_dot {dt} [{lo}, {hi}] conj={conj}: error "
                                     f"{err} ({rel} relative) > {tol}")
                err_w, rel_w = max(err_w, err), max(rel_w, rel)
            max_err = max(max_err, err_w)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            ref = WD.window_dot_plain(st, m, n=n, lo=lo, hi=hi)
            e1.record()
            torch.cuda.synchronize()
            plain_ms = e0.elapsed_time(e1)
            del ref
            ms = _cuda_ms(lambda: WD.window_dot(x, m, n=n, lo=lo, hi=hi), 10)
            xc = torch.complex(st[0], st[1]).reshape(N >> (lo + span), d, 1 << lo)
            uc = torch.complex(m[0], m[1])
            lib_ms = _cuda_ms(lambda: torch.matmul(uc, xc), 10)
            del x, xc
            torch.cuda.empty_cache()
            # the rate of the products: FP64 or 3xTF32 on the tensor cores
            # (spans >= 3), FP32 FMA outside them (spans 1, 2)
            peak = (PEAK_FP64_FLOPS if not f32 else
                    TF32X3_FLOPS if span >= 3 else PEAK_FP32_FLOPS)
            b_bytes = 2.0 * 2 * N * itemsize / HBM_BYTES_PER_S * 1e3
            b_ops = 8.0 * d * N / peak * 1e3
            bound = max(b_bytes, b_ops)
            by = "operations" if b_ops > b_bytes else "bytes"
            rows.append({"lo": lo, "hi": hi, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
                         "max_abs_err": err_w, "max_rel_err": rel_w,
                         "timed": (lo, span) in WINDOWS})
            print(f"# window {str(dt)[6:]} [{lo}, {hi}] (D {d}) at {n}q: kernel {ms:.4f} ms "
                  f"({bound / ms:.1%} of the bound), bound {bound:.4f} ms by {by}, "
                  f"torch.matmul {lib_ms:.4f} ms, plain {plain_ms:.2f} ms; max_abs_err "
                  f"{err_w:.3e} ({rel_w:.3e} of the largest, conj off and on)")
        print(f"# window {str(dt)[6:]}: launches {launches} ({len(rows)} windows x conj "
              f"off/on), max_abs_err {max_err:.3e} (limit {tol:g} of the largest amplitude)")
        out[dt] = {"rows": rows, "launches": launches, "max_abs_err": max_err}
        del st
        torch.cuda.empty_cache()
    return out


def _window_entry(name: str, phase: dict) -> dict:
    """The ``kernels`` line of window_dot: ms, plain, bound and library are
    means over WINDOWS; every checked window is listed."""
    rows = [r for r in phase["rows"] if r["timed"]]

    def mean(k):
        return sum(r[k] for r in rows) / len(rows)

    ops_b = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    return {
        "name": name, "route": "cuda", "source": "quest_tpu_torch/csrc/window_dot.cu",
        "replaces": "quest_tpu/ops/pallas_gates.py:1312",
        "launches": phase["launches"], "max_abs_err": phase["max_abs_err"],
        "ms": mean("ms"), "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
        "bound_by": "operations" if 2 * ops_b > sum(r["bound_ms"] for r in rows) else "bytes",
        "library_ms": mean("library_ms"), "library_call": "torch.matmul (complex)",
        "windows": phase["rows"],
    }


def _surface_names() -> set:
    """Every function of gates.py beyond the bench gate set that a tape
    records (measurement is not recorded), and the applyMatrix* operators
    (the rest of operators.py is the operators phase's)."""
    from quest_tpu_torch import gates, operators

    bench = {"hadamard", "tGate", "rotateZ", "rotateX", "controlledNot",
             "controlledPhaseFlip", "unitary", "multiRotateZ", "swapGate",
             "multiStateControlledUnitary", "pauliX"}
    measuring = {"measure", "measureWithStats", "collapseToOutcome"}
    matrix_ops = {f for f in operators.__all__ if "Matrix" in f}
    return (set(gates.__all__) | matrix_ops) - bench - measuring


def _gate_surface_path(qt, env, dev, rng) -> dict:
    """The dense-gate surface at N_MAIN qubits, f32: the tape planned by
    ``Circuit.fused(max_qubits=5, pallas=True)`` at the Hopper tile, each
    fused run and lane_u dense-block pass through the kernel against the
    plain version (and timed), then the circuit through ``Circuit.run``
    with the counts reset just before it, against a per-gate replay of the
    unfused tape; then the same tape planned without ``pallas`` (dense
    blocks; those below the lane boundary as lane_u kernel passes), and
    the tape without its LEFT_MULT calls on an N_MAIN/2-qubit density
    register."""
    import torch

    from quest_tpu_torch import fusion, telemetry
    from quest_tpu_torch.ops import fused_gates as FG

    dt = torch.float32
    circ = qt.Circuit(N_MAIN)
    gate_surface_tape(circ, qt, N_MAIN, seed=303)
    names = [f.__name__ for f, _, _ in circ._tape]
    missing = {s for s in _surface_names() if names.count(s) < 2}
    _require(not missing, f"gate-surface tape calls these fewer than twice: {missing}")

    def kernel_passes(fz, qureg):
        """The fused runs of ``fz`` and its dense blocks that take the
        lane_u route on ``qureg``: a run of ``fz`` launches once for each."""
        runs = [a[0] for f, a, _ in fz._tape if f is fusion._apply_pallas_run]
        lane = [a[0] for f, a, _ in fz._tape if f is fusion._apply_dense_block
                and fusion.dense_block_route(
                    qureg.num_qubits_in_state_vec, qureg.is_density_matrix,
                    a[0].qubits, qureg.device.type == "cuda") == "lane_u"]
        return runs, lane

    def check_passes(runs, lane, label):
        """Each fused run and lane_u pass through the kernel against the
        plain version (and timed), added to the phase's pass stats."""
        tb = FG.hopper_tile_bits(N_MAIN, dt)
        items = [_run_item(r) for r in runs] + [
            (1, fusion.lane_u_run(b, tb), dict(tile_bits=tb, **_swaps())) for b in lane]
        p = _passes(items, N_MAIN, dt, dev, rng, 1e-5, f"gate-surface {label}")
        for k in ("ms", "plain_ms", "bound_ms", "by_ops"):
            res[k] += p[k]
        res["kinds"] |= p["kinds"]
        res["max_abs_err"] = max(res["max_abs_err"], p["max_abs_err"])
        return p

    def run_counted(fz, qureg):
        telemetry.reset()
        FG.fused_run.launches = 0
        fz.run(qureg)
        torch.cuda.synchronize()
        return (FG.fused_run.launches,
                telemetry.counter_value("pallas_pass_total", kind="fused_run"),
                telemetry.counter_total("engine_fallback_total"))

    def replay(c, qureg):
        launched = FG.fused_run.launches
        c.run(qureg)  # one gate at a time through the per-gate engine
        torch.cuda.synchronize()
        _require(FG.fused_run.launches == launched, "the per-gate replay launched")

    res = {"ms": [], "plain_ms": [], "bound_ms": [], "by_ops": [], "kinds": set(),
           "max_abs_err": 0.0}
    ref = qt.createQureg(N_MAIN, env, 1)
    qt.initPlusState(ref)
    replay(circ, ref)
    for label, pallas in (("fused", True), ("dense", False)):
        t0 = time.perf_counter()
        fz = circ.fused(max_qubits=5, pallas=pallas, dtype=dt)
        plan_s = time.perf_counter() - t0
        kinds = {}
        for f, _, _ in fz._tape:
            kinds[f.__name__] = kinds.get(f.__name__, 0) + 1
        q = qt.createQureg(N_MAIN, env, 1)
        qt.initPlusState(q)
        runs, lane = kernel_passes(fz, q)
        p = check_passes(runs, lane, label)
        launches, passes, fallbacks = run_counted(fz, q)
        total = qt.calcTotalProb(q)
        diff, rel = _rel_err(q.amps, ref.amps)
        print(f"# gate surface {label}: {N_MAIN}q f32, {len(circ)} entries -> plan "
              f"{kinds} in {plan_s:.2f} s; launches {launches} (fused runs {len(runs)} + "
              f"lane_u dense blocks {len(lane)}), pallas_pass_total{{fused_run}} "
              f"{passes:g}, engine_fallback_total {fallbacks:g}; calcTotalProb "
              f"{total:.9f}, max |run - per-gate replay| {diff:.3e}, {rel:.3e} of "
              f"the largest (limit 1e-5)")
        _require(launches == len(runs) + len(lane) == passes,
                 f"gate surface {label}: launches")
        _require(fallbacks == 0, f"gate surface {label}: engine fallback")
        _require(abs(total - 1) <= 1e-4, f"gate surface {label}: total probability {total}")
        _require(rel <= 1e-5, f"gate surface {label}: amplitudes {diff} ({rel} relative)")
        res[f"{label}_launches"] = launches
        if pallas:
            reps = 3
            _warm_run(fz, q)
            t0 = time.perf_counter()
            for _ in range(reps):
                fz.run(q)
            torch.cuda.synchronize()
            res["circuit_ms"] = (time.perf_counter() - t0) / reps * 1e3
            # one more run, each tape item timed alone: where the circuit's time goes
            by_kind: dict = {}
            for f, a, kw in fz._tape:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                f(q, *a, **kw)
                e1.record()
                torch.cuda.synchronize()
                kind = f.__name__
                if f is fusion._apply_dense_block:
                    kind += "/" + fusion.dense_block_route(N_MAIN, False, a[0].qubits, True)
                elif f not in (fusion._apply_pallas_run, fusion._apply_frame_swap):
                    kind = "barrier " + kind
                by_kind[kind] = by_kind.get(kind, 0.0) + e0.elapsed_time(e1)
            res["ms_by_item"] = by_kind
            print(f"# gate surface fused: {res['circuit_ms']:.3f} ms per circuit "
                  f"({len(circ)} entries), {sum(p['ms']):.3f} ms of it kernel passes; "
                  f"by item, ms: {json.dumps({k: round(v, 3) for k, v in by_kind.items()})}")
        qt.destroyQureg(q)
        torch.cuda.empty_cache()
    qt.destroyQureg(ref)
    torch.cuda.empty_cache()

    nd = N_MAIN // 2
    dcirc = qt.Circuit(nd, is_density_matrix=True)
    gate_surface_tape(dcirc, qt, nd, seed=303, with_left_mult=False)
    fz = dcirc.fused(max_qubits=5, pallas=True, dtype=dt)
    rho = qt.createDensityQureg(nd, env, 1)
    qt.initPlusState(rho)
    runs, lane = kernel_passes(fz, rho)
    launches, passes, fallbacks = run_counted(fz, rho)
    trace = qt.calcTotalProb(rho)
    dref = qt.createDensityQureg(nd, env, 1)
    qt.initPlusState(dref)
    replay(dcirc, dref)
    diff, rel = _rel_err(rho.amps, dref.amps)
    print(f"# gate surface density: {nd}q density ({2 * nd} flattened qubits), "
          f"{len(dcirc)} entries, launches {launches} (fused runs {len(runs)}), "
          f"engine_fallback_total {fallbacks:g}; calcTotalProb {trace:.9f}, "
          f"max |run - per-gate replay| {diff:.3e}, {rel:.3e} of the largest "
          f"(limit 1e-5)")
    _require(launches == len(runs) + len(lane) == passes, "gate surface density: launches")
    _require(fallbacks == 0, "gate surface density: engine fallback")
    _require(abs(trace - 1) <= 1e-4, f"gate surface density: trace {trace}")
    _require(rel <= 1e-5, f"gate surface density: entries {diff} ({rel} relative)")
    res["density_launches"] = launches
    res["launches"] = res["fused_launches"] + res["dense_launches"] + launches
    qt.destroyQureg(rho)
    qt.destroyQureg(dref)
    torch.cuda.empty_cache()
    return res


def _sharded_path(qt, dev, rng, dt) -> dict:
    """The main path's circuit (N_MAIN qubits, depth DEPTH_MAIN) on a
    register sharded over N_SHARDS virtual shards of cuda:0, in ``dt``:
    the plan of ``Circuit.fused(max_qubits=5, pallas=True,
    shard_devices=N_SHARDS)``; each run's pass on each shard through the
    kernel against the plain version with the shard's index (and timed);
    the run with the counts reset just before it (launches = runs x
    shards, zero fallbacks, ``exchange_calls_total{grouped_permute}`` =
    the collective transposes); the gathered state against the one-device
    fused run; a plain per-gate replay over the shards against the
    one-device per-gate replay; the readouts; gates/sec; each collective
    permute's time beside its bound."""
    import torch

    import numpy as np

    from quest_tpu_torch import fusion, telemetry
    from quest_tpu_torch.ops import fused_gates as FG
    from quest_tpu_torch.parallel import exchange as X
    from quest_tpu_torch.parallel.scheduler import engine

    f32 = dt == torch.float32
    prec, tol_kernel, tol = (1, 1e-5, 1e-5) if f32 else (2, 1e-12, 1e-10)
    label = f"sharded {str(dt)[6:]}"
    n, nl = N_MAIN, N_MAIN - (N_SHARDS - 1).bit_length()
    itemsize = torch.finfo(dt).bits // 8
    env = qt.createQuESTEnv(devices=[dev] * N_SHARDS)
    circ = qt.Circuit(n)
    qt.random_layers(circ, n, DEPTH_MAIN)
    t0 = time.perf_counter()
    fz = circ.fused(max_qubits=5, pallas=True, dtype=dt, shard_devices=N_SHARDS)
    plan_s = time.perf_counter() - t0
    runs = [a[0] for f, a, _ in fz._tape if f is fusion._apply_pallas_run]
    other = [f.__name__ for f, _, _ in fz._tape
             if f not in (fusion._apply_pallas_run, fusion._apply_frame_swap)]
    ts = fusion.tape_transpose_stats(fz._tape, nl)
    print(f"# {label}: {n}q depth {DEPTH_MAIN} over {N_SHARDS} shards of {dev} (local_n "
          f"{nl}), {len(circ)} gates -> {len(runs)} fused runs at tile_bits "
          f"{runs[0].tile_bits}, {len(fz._tape) - len(runs)} frame swaps; transposes: "
          f"{ts['collective_transposes']} collective, {ts['local_transposes']} local; "
          f"planned in {plan_s:.2f} s")
    _require(runs and not other, f"{label}: plan is not all fused runs and frame swaps")

    # each run's pass on each shard: kernel against plain, timed
    st = [torch.as_tensor(rng.randn(2, 1 << nl), dtype=dt, device=dev)
          for _ in range(N_SHARDS)]
    norm = sum(float((x * x).sum()) for x in st) ** 0.5
    for x in st:
        x /= norm
    out = torch.empty_like(st[0])
    res = {"ms": [], "plain_ms": [], "bound_ms": [], "by_ops": [], "kinds": set(),
           "max_abs_err": 0.0, "max_rel_err": 0.0}
    for i, run in enumerate(runs):
        prep = run.prepare()
        kw = dict(tile_bits=run.tile_bits, **_swaps(run.load_swap_k, run.load_swap_hi,
                                                      run.store_swap_k, run.store_swap_hi))
        # swaps reaching a sharded qubit run as collectives: not in the pass
        for k, h in (("load_swap_k", "load_swap_hi"), ("store_swap_k", "store_swap_hi")):
            hi = run.tile_bits if kw[h] is None else kw[h]
            if kw[k] and hi + kw[k] > nl:
                kw[k], kw[h] = 0, None
        b_bytes, b_ops = _bound_ms(_pass_work(prep, nl, itemsize), f32)
        for r, shard in enumerate(st):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            ref = FG.fused_run_plain(shard, prep, n=n, local_n=nl, shard_index=r, **kw)
            e1.record()
            torch.cuda.synchronize()
            ms = _cuda_ms(lambda: FG.fused_run(shard, n=n, ops=run.ops, out=out,
                                               prepared=prep, local_n=nl, shard_index=r,
                                               **kw), 3)
            err, rel = _rel_err(out, ref)
            del ref
            _require(rel <= tol_kernel, f"{label} run {i} shard {r}: error {err} "
                                        f"({rel} relative) > {tol_kernel}")
            res["ms"].append(ms)
            res["plain_ms"].append(e0.elapsed_time(e1))
            res["bound_ms"].append(max(b_bytes, b_ops))
            res["by_ops"].append(b_ops > b_bytes)
            res["max_abs_err"] = max(res["max_abs_err"], err)
            res["max_rel_err"] = max(res["max_rel_err"], rel)
        res["kinds"].update(o[0] for o in prep.ops)
        print(f"# {label} run {i}: {len(run.ops)} ops -> {len(prep.ops)}, folded swaps "
              f"load {kw['load_swap_k']} store {kw['store_swap_k']}: per shard "
              f"{[round(m, 4) for m in res['ms'][-N_SHARDS:]]} ms, bound "
              f"{max(b_bytes, b_ops):.4f} ms by {'operations' if b_ops > b_bytes else 'bytes'}, "
              f"plain {sum(res['plain_ms'][-N_SHARDS:]) / N_SHARDS:.2f} ms, max_abs_err "
              f"{res['max_abs_err']:.3e} ({res['max_rel_err']:.3e} of the largest) so far")
    del st, out
    torch.cuda.empty_cache()

    # the circuit on the sharded register, counts reset just before it
    q = qt.createQureg(n, env, prec)
    qt.initPlusState(q)
    telemetry.reset()
    FG.fused_run.launches = 0
    fz.run(q)
    torch.cuda.synchronize()
    launches = FG.fused_run.launches
    fallbacks = telemetry.counter_total("engine_fallback_total")
    grouped = telemetry.counter_value("exchange_calls_total", kind="grouped_permute")
    passes = telemetry.counter_value("pallas_pass_total", kind="fused_run")
    print(f"# {label} run: launches {launches} (runs {len(runs)} x {N_SHARDS} shards), "
          f"pallas_pass_total{{fused_run}} {passes:g}, engine_fallback_total {fallbacks:g}, "
          f"exchange_calls_total{{grouped_permute}} {grouped:g} (collective transposes "
          f"{ts['collective_transposes']})")
    _require(launches == len(runs) * N_SHARDS == passes, f"{label}: launches")
    _require(fallbacks == 0, f"{label}: engine fallback")
    _require(grouped == ts["collective_transposes"], f"{label}: collective permutes")
    res["launches"] = launches

    one = qt.createQuESTEnv(device=dev)
    ref = qt.createQureg(n, one, prec)
    qt.initPlusState(ref)
    circ.fused(max_qubits=5, pallas=True, dtype=dt).run(ref)
    torch.cuda.synchronize()
    gathered = torch.cat(q.shards, dim=1)
    diff, rel = _rel_err(gathered, ref.amps)
    # the largest amplitude of the last shard: an index there, read back
    last = (N_SHARDS - 1 << nl) + int(q.shards[-1].abs().sum(0).argmax())
    a_gathered = complex(*gathered[:, last].tolist())
    del gathered
    total = qt.calcTotalProb(q)
    p0, p0_ref = qt.calcProbOfOutcome(q, 0, 0), qt.calcProbOfOutcome(ref, 0, 0)
    pt, pt_ref = qt.calcProbOfOutcome(q, n - 1, 1), qt.calcProbOfOutcome(ref, n - 1, 1)
    a, a_ref = qt.getAmp(q, last), qt.getAmp(ref, last)
    print(f"# {label} check: max |sharded - one-device fused| {diff:.3e} ({rel:.3e} of the "
          f"largest, limit {tol:g}); calcTotalProb {total:.12f}; calcProbOfOutcome(0,0) "
          f"{p0:.12f} vs {p0_ref:.12f}, ({n - 1},1) {pt:.12f} vs {pt_ref:.12f}; "
          f"getAmp({last}) {a:.6e} vs {a_ref:.6e}")
    tol_read = 2e-4 if f32 else 1e-10
    _require(rel <= tol, f"{label}: gathered state {diff} ({rel} relative)")
    _require(abs(total - 1) <= tol_read, f"{label}: total probability {total}")
    _require(abs(p0 - p0_ref) <= tol_read and abs(pt - pt_ref) <= tol_read,
             f"{label}: outcome probabilities")
    # the read-back amplitude is the gathered one, and no further from the
    # reference in either component than the gathered state's largest
    # difference (taken over components: its modulus may exceed it by up to
    # a factor of sqrt 2)
    d_amp = max(abs(a.real - a_ref.real), abs(a.imag - a_ref.imag))
    _require(a == a_gathered and d_amp <= diff,
             f"{label}: getAmp({last}): {a} (gathered {a_gathered}), {d_amp} from the "
             f"reference against {diff}")
    del ref
    torch.cuda.empty_cache()

    # the plain per-gate replay over the shards against the one-device one
    telemetry.reset()
    q2 = qt.createQureg(n, env, prec)
    qt.initPlusState(q2)
    launched = FG.fused_run.launches
    t0 = time.perf_counter()
    circ.run(q2)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    kinds = {k: telemetry.counter_value("exchange_calls_total", kind=k)
             for k in ("pair_exchange", "x_permute", "grouped_permute")}
    _require(FG.fused_run.launches == launched, f"{label}: the per-gate replay launched")
    r2 = qt.createQureg(n, one, prec)
    qt.initPlusState(r2)
    circ.run(r2)
    torch.cuda.synchronize()
    gathered = torch.cat(q2.shards, dim=1)
    diff2, rel2 = _rel_err(gathered, r2.amps)
    del gathered
    print(f"# {label} per-gate replay over the shards: {replay_s * 1e3:.1f} ms "
          f"({len(circ) / replay_s:.1f} gates/s), exchanges {kinds}; max |sharded - "
          f"one-device per-gate replay| {diff2:.3e} ({rel2:.3e} of the largest)")
    _require(kinds["pair_exchange"] > 0 and kinds["x_permute"] > 0,
             f"{label}: the replay took no pair exchange or x permute")
    _require(rel2 <= tol, f"{label}: per-gate replay {diff2} ({rel2} relative)")
    qt.destroyQureg(q2)
    qt.destroyQureg(r2)
    torch.cuda.empty_cache()

    # the relocation that carries controls (QuEST_cpu_distributed.c:
    # 1526-1568): a 3-target unitary on two sharded qubits and one local,
    # its controls on the slots 0 and 1 that the sharded targets swap into
    d8 = 8
    u8 = np.linalg.qr(rng.randn(d8, d8) + 1j * rng.randn(d8, d8))[0]
    targets, controls = [n - 1, n - 2, n - 3], [0, 1]
    q3 = qt.createQureg(n, env, prec)
    qt.initDebugState(q3)
    swaps0 = engine(q3).stats["relocation_swaps"]
    qt.multiControlledMultiQubitUnitary(q3, controls, targets, u8)
    torch.cuda.synchronize()
    swaps = engine(q3).stats["relocation_swaps"] - swaps0
    r3 = qt.createQureg(n, one, prec)
    qt.initDebugState(r3)
    qt.multiControlledMultiQubitUnitary(r3, controls, targets, u8)
    gathered = torch.cat(q3.shards, dim=1)
    diff3, rel3 = _rel_err(gathered, r3.amps)
    del gathered
    print(f"# {label} relocation carrying controls: multiControlledMultiQubitUnitary "
          f"targets {targets} controls {controls} over {N_SHARDS} shards (local_n {nl}): "
          f"relocation swaps {swaps}; max |sharded - one-device per-gate| {diff3:.3e} "
          f"({rel3:.3e} of the largest, limit {tol:g})")
    _require(swaps == 4, f"{label}: relocation swaps {swaps} != 4")
    _require(rel3 <= tol, f"{label}: relocation carrying controls {diff3} ({rel3} relative)")
    qt.destroyQureg(q3)
    qt.destroyQureg(r3)
    torch.cuda.empty_cache()

    # gates/sec of the fused circuit over the shards, and where its time goes
    reps = 3
    _warm_run(fz, q)
    t0 = time.perf_counter()
    for _ in range(reps):
        fz.run(q)
    torch.cuda.synchronize()
    circuit_s = (time.perf_counter() - t0) / reps
    gps = len(circ) / circuit_s
    _require(abs(qt.calcTotalProb(q) - 1) <= tol_read, f"{label}: norm after timed reps")
    perm_rows = []
    spare = q.shard_spare_buffers()
    blocks = sorted({(r.tile_bits, k, h if h is not None else r.tile_bits)
                     for r in runs for k, h in ((r.load_swap_k, r.load_swap_hi),
                                                (r.store_swap_k, r.store_swap_hi))
                     if k and (r.tile_bits if h is None else h) + k > nl})
    bound_perm = 2.0 * 2 * (1 << n) * itemsize / HBM_BYTES_PER_S * 1e3
    for tb, k, hi in blocks:
        source = list(range(n))
        for j in range(k):
            source[tb - k + j], source[hi + j] = hi + j, tb - k + j
        ms = _cuda_ms(lambda: X.dist_permute_bits(q.shards, n=n, source=source, out=spare), 3)
        perm_rows.append({"block": [tb - k, hi, k], "ms": ms, "bound_ms": bound_perm})
    copy_ms = _cuda_ms(lambda: spare[0].copy_(q.shards[0]), 10)
    ms_perm = {tuple(r["block"]): r["ms"] for r in perm_rows}
    coll_ms = sum(ms_perm[(r.tile_bits - k, r.tile_bits if h is None else h, k)]
                  for r in runs for k, h in ((r.load_swap_k, r.load_swap_hi),
                                             (r.store_swap_k, r.store_swap_hi))
                  if k and (r.tile_bits if h is None else h) + k > nl)
    print(f"# {label} gates/sec: {gps:.1f} ({circuit_s * 1e3:.3f} ms per circuit; "
          f"per-shard kernel passes {sum(res['ms']):.3f} ms, collective permutes "
          f"~{coll_ms:.3f} ms); collective permutes "
          f"{json.dumps([{'block': r['block'], 'ms': round(r['ms'], 4)} for r in perm_rows])}"
          f" each against a bound of {bound_perm:.4f} ms (2 x state bytes / 3.35 TB/s); "
          f"one shard's copy_ {copy_ms:.4f} ms")

    # one more run, eager, with CUDA events around every kernel launch and
    # every collective permute, none synchronised: the eager replay's time
    # on the card's clock split into the shard passes, the permutes and the
    # rest (the card waiting between them)
    spans: dict = {"kernel": [], "permute": []}

    def timed(kind, fn):
        def call(*a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **k)
            e1.record()
            spans[kind].append((e0, e1))
            return out
        return call

    launch, permute = FG._launch, X.dist_permute_bits
    FG._launch, X.dist_permute_bits = timed("kernel", launch), timed("permute", permute)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    _eager_run(fz, q)  # the eager replay: a graph replay runs no Python to time
    e1.record()
    torch.cuda.synchronize()
    FG._launch, X.dist_permute_bits = launch, permute
    split = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
    total_ms = e0.elapsed_time(e1)
    rest_ms = total_ms - split["kernel"] - split["permute"]
    print(f"# {label} in the eager circuit: {total_ms:.3f} ms on the card's clock; "
          f"{len(spans['kernel'])} shard passes {split['kernel']:.3f} ms, "
          f"{len(spans['permute'])} collective permutes {split['permute']:.3f} ms, "
          f"the rest {rest_ms:.3f} ms ({rest_ms / total_ms:.1%}, the card waiting)")
    _require(len(spans["kernel"]) == len(runs) * N_SHARDS
             and len(spans["permute"]) == ts["collective_transposes"],
             f"{label}: the timed run's launches and permutes")
    q.shard_spares = None  # the final state stays for the readout phase
    torch.cuda.empty_cache()
    res.update(in_circuit_ms={"total": total_ms, "shard_passes": split["kernel"],
                              "collective_permutes": split["permute"], "rest": rest_ms})
    res.update(gates_per_sec=gps, circuit_ms=circuit_s * 1e3, permutes=perm_rows,
               copy_ms=copy_ms, replay_gates_per_sec=len(circ) / replay_s,
               collective_transposes=ts["collective_transposes"],
               local_transposes=ts["local_transposes"], runs=len(runs),
               max_abs_diff_vs_one_device=diff, qureg=q, plan=fz)
    return res


#: the readout phase's Pauli product at N_MAIN qubits: Y on the qubits 25
#: and 24, sharded over N_SHARDS shards, and an identity code (most
#: products of X, Y and Z read 0 to 1e-18 on the bench circuit's states,
#: this one does not; the Hamiltonian's terms take X and Z), its outcome
#: targets (unsorted; 24 and 25 sharded), and the density register's
#: product and targets. The density phase leaves its r4 state with qubits
#: 0 and 1 fully mixed, X on 13 about 0.54, Z on 2 about 0.08 and X on 7
#: at 1 (and, the state being real, any one Y at 0): X13 Z2 X7 is not 0
READ_PROD = ((25, 13, 24), (2, 0, 2))
READ_TARGETS = ((13, 0, 25, 7), (25, 3, 18, 0, 24, 7, 22, 14))
READ_PROD_DENSITY = ((13, 2, 7), (1, 3, 1))
READ_TARGETS_DENSITY = (13, 0, 7, 3)


def tfim_hamil(qt, n: int, seed: int):
    """A transverse-field Ising Hamiltonian on n qubits as a PauliHamil,
    built by ``createPauliHamil`` + ``initPauliHamil``: the n - 1 couplings
    J_i Z_i Z_{i+1} (J_i in [0.5, 1.5)) and the n fields h_i X_i (h_i in
    [0.3, 1.0)), drawn from ``seed``."""
    import numpy as np

    rng = np.random.RandomState(seed)
    codes = np.zeros((2 * n - 1, n), dtype=np.int32)
    for i in range(n - 1):
        codes[i, i] = codes[i, i + 1] = 3
    for i in range(n):
        codes[n - 1 + i, i] = 1
    coeffs = np.concatenate([rng.uniform(0.5, 1.5, n - 1), rng.uniform(0.3, 1.0, n)])
    hamil = qt.createPauliHamil(n, 2 * n - 1)
    qt.initPauliHamil(hamil, coeffs, codes)
    return hamil


def _c128(pieces) -> "torch.Tensor":
    """The gathered state of planar pieces (one tensor or the shards) as a
    complex128 vector: the independent reference's input."""
    import torch

    flat = torch.cat(list(pieces), dim=1).double()
    return torch.complex(flat[0], flat[1])


def _pauli_action(k, targets, codes):
    """A Pauli product from its definition: P|k> = c_k |k ^ f>, with f the
    X and Y targets' mask and c_k = i^(number of Y) (-1)^(parity of k's Y
    and Z target bits). Returns (f, c as complex128 over the indices k)."""
    import torch

    f = sum(1 << t for t, c in zip(targets, codes) if c in (1, 2))
    par = torch.zeros_like(k)
    for t, c in zip(targets, codes):
        if c in (2, 3):
            par ^= (k >> t) & 1
    return f, (1 - 2 * par).to(torch.complex128) * (1j ** sum(c == 2 for c in codes))


def _pauli_ref(psi, k, targets, codes):
    """P psi from the definition, in complex128: (P psi)[m] = c_(m^f)
    psi[m ^ f] (:func:`_pauli_action`)."""
    f, coef = _pauli_action(k, targets, codes)
    return coef[k ^ f] * psi[k ^ f]


def _pauli_trace_ref(flat, dim, k, targets, codes):
    """Re Tr(P rho) from the definition, in complex128: the flat layout is
    [col, row], so rho(r, c) = flat[c dim + r], and Tr(P rho) = sum_k c_k
    rho(k, k ^ f) (:func:`_pauli_action`)."""
    f, coef = _pauli_action(k, targets, codes)
    return float((coef * flat[(k ^ f) * dim + k]).sum().real)


def _outcomes_ref(p, k, targets):
    """The outcome distribution from the definition: each basis state's
    probability added at the index its target bits make (targets[0] the
    least significant), in float64."""
    import torch

    o = torch.zeros_like(k)
    for j, t in enumerate(targets):
        o |= ((k >> t) & 1) << j
    return torch.bincount(o, weights=p, minlength=1 << len(targets))


def _grouped_letters(n: int, targets):
    """(shape, bra letters, ket letters, one 'uv' pair per target) of the
    grouped view over ``targets`` (``ops.layout.grouped_axes``: one axis per
    target bit, fused segments between them) for a one-call
    ``torch.einsum`` yardstick."""
    from quest_tpu_torch.ops.layout import grouped_axes

    shape, axis_of = grouped_axes(n, targets)
    letters = iter("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ")
    bra, ket = [], []
    for i in range(len(shape)):
        u = next(letters)
        v = next(letters) if i % 2 else u  # a segment: one letter for both
        bra.append(u)
        ket.append(v)
    return (list(shape), "".join(bra), "".join(ket),
            [bra[axis_of[t]] + ket[axis_of[t]] for t in targets])


def _density_einsum(ca, nd: int, targets, codes, mats):
    """Tr(P rho) as one torch.einsum over the flat matrix ``ca`` ([col,
    row]: mat[a, b] = rho(b, a), so Tr(P rho) = sum_ab P[a, b] mat[a, b]):
    both index groups viewed over the targets, each non-target bit a
    repeated letter (the trace), each target a 2x2 Pauli."""
    import torch

    shape, bra, ket, pairs = _grouped_letters(nd, targets)
    return torch.einsum(f"{bra}{ket},{','.join(pairs)}->", ca.view(shape + shape),
                        *[mats[x] for x in codes])


def _readout_phase(qt, dev, sv: dict, dens: dict, shard: dict) -> list:
    """The readout rows on states the earlier phases made: ``sv`` the main
    path's final registers (N_MAIN qubits, one device), ``dens`` the density
    phase's (r4, r3) registers (N_DENSITY qubits), ``shard`` the sharded
    phase's registers (N_MAIN qubits over N_SHARDS shards), each by dtype.
    Every value against an evaluation from its definition in complex128 of
    the gathered state (limits 1e-4 f32 / 1e-10 f64 on quantities bounded
    by 2; a Pauli sum's relative to sum |c_t|), the sharded values also
    against the one-device values of the same states; each call timed on
    the card's clock beside its bytes bound (the state bytes it must read
    and write over 3.35 TB/s) and one PyTorch call computing the same
    function (the yardstick, named on the line). One ``# readout`` line per
    call; returns the rows."""
    import numpy as np
    import torch

    rows = []

    def row(fn, dt, width, call, ref, limit, nbytes, yname, yard, reps=3, scale=1.0,
            value_of=None, timed=None):
        """Call ``call`` once and hold its value (``value_of`` its result)
        against ``ref``, then time ``timed`` (default ``call``) and the
        yardstick (a number: its ms, measured before). Returns the call's
        result."""
        result = call()
        torch.cuda.synchronize()
        value = value_of(result) if value_of else result
        err = float(np.max(np.abs(np.asarray(value) - np.asarray(ref)))) / scale
        _require(err <= limit, f"readout {fn} {dt} {width}: {value} against {ref}, error "
                               f"{err} > {limit}")
        ms = _clock_ms(timed or call, reps)  # the call above warmed it up
        yms = yard if isinstance(yard, float) else _cuda_ms(yard, reps)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        arr = np.asarray(value).ravel()
        shown = (f"{value:.10g}" if arr.size == 1 else
                 "[" + ", ".join(f"{v:.6g}" for v in arr[:4]) + (", ...]" if arr.size > 4
                                                                else "]"))
        rel = " of sum |c_t|" if scale != 1.0 else ""
        print(f"# readout {fn} {dt} {width}: value {shown}, error {err:.3e}{rel} (limit "
              f"{limit:g}), {ms:.4f} ms, bound {bound:.4f} ms ({nbytes / 2**20:.1f} MiB), "
              f"yardstick {yname} {yms:.4f} ms")
        rows.append({"function": fn, "dtype": dt, "width": width, "error": err,
                     "limit": limit, "ms": ms, "bound_ms": bound, "yardstick": yname,
                     "yardstick_ms": yms})
        return result

    def pieces(x):
        return x.shards or [x.amps]

    def same(x, y) -> float:
        """max |x - y| over two registers' gathered states."""
        return float((_c128(pieces(x)) - _c128(pieces(y))).abs().max())

    hamil = tfim_hamil(qt, N_MAIN, seed=61)
    hcoeffs, hcodes = hamil.term_coeffs, hamil.pauli_codes
    hscale = float(np.abs(hcoeffs).sum())
    hname = f"{len(hcoeffs)} one-term torch.einsum calls, summed"
    terms = [([t for t in range(N_MAIN) if cd[t]], [int(x) for x in cd if x]) for cd in hcodes]
    layers = qt.Circuit(N_MAIN)
    qt.random_layers(layers, N_MAIN, 2, seed=7)
    k = torch.arange(1 << N_MAIN, device=dev)
    t0 = time.perf_counter()
    for dt in (torch.float32, torch.float64):
        f32 = dt == torch.float32
        name, prec, lim = str(dt)[6:], (1 if f32 else 2), (1e-4 if f32 else 1e-10)
        cdt = torch.complex64 if f32 else torch.complex128
        mats = {c: torch.tensor(m, dtype=cdt, device=dev)
                for c, m in ((0, [[1, 0], [0, 1]]), (1, [[0, 1], [1, 0]]),
                             (2, [[0, -1j], [1j, 0]]), (3, [[1, 0], [0, -1]]))}
        item = torch.finfo(dt).bits // 8
        S = 2 * (1 << N_MAIN) * item  # bytes of one N_MAIN-qubit state

        def einsum_expec(c, targets, codes):
            """<c| P |c> as one torch.einsum over the grouped view (the
            yardstick of a Pauli product's expectation)."""
            shape, bra, ket, pairs = _grouped_letters(N_MAIN, targets)
            v = c.view(shape)
            return torch.einsum(f"{bra},{','.join(pairs)},{ket}->", v.conj(),
                                *[mats[x] for x in codes], v)

        for layout in ("one device", f"{N_SHARDS} shards"):
            sharded = layout != "one device"
            q = shard[dt] if sharded else sv[dt]
            env = q.env
            width = f"{N_MAIN}q {layout}"
            q2 = row("createCloneQureg", name, width, lambda: qt.createCloneQureg(q, env),
                     0.0, 0.0, 2 * S, "Tensor.clone", lambda: [x.clone() for x in pieces(q)],
                     value_of=lambda r: same(r, q))
            layers.run(q2)  # the second state: the clone, two more layers
            psi, phi = _c128(pieces(q)), _c128(pieces(q2))
            _require(float((psi - phi).abs().max()) > 0.1 * float(psi.abs().max()),
                     "readout: the two states are equal")
            c, c2 = (torch.complex(*torch.cat(pieces(x), dim=1)) for x in (q, q2))
            ip_ref = complex((psi.conj() * phi).sum())
            got = {}
            got["calcInnerProduct"] = row(
                "calcInnerProduct", name, width, lambda: qt.calcInnerProduct(q, q2), ip_ref,
                lim, 2 * S, "torch.vdot", lambda: torch.vdot(c, c2))
            got["calcFidelity"] = row(
                "calcFidelity", name, width, lambda: qt.calcFidelity(q, q2), abs(ip_ref) ** 2,
                lim, 2 * S, "torch.vdot", lambda: torch.vdot(c, c2))
            p, pd = psi.real ** 2 + psi.imag ** 2, c.real ** 2 + c.imag ** 2
            for targets in READ_TARGETS:
                shape = _grouped_letters(N_MAIN, targets)[0]
                rest = tuple(range(0, len(shape), 2))
                got[f"calcProbOfAllOutcomes {targets}"] = row(
                    "calcProbOfAllOutcomes", name, f"{width} targets {targets}",
                    lambda: qt.calcProbOfAllOutcomes(q, targets),
                    _outcomes_ref(p, k, targets).cpu().numpy(), lim, S,
                    "torch.sum over the grouped |amp|^2",
                    lambda: torch.sum(pd.view(shape), dim=rest))
            idx = int(p.argmax())
            csz = pieces(q)[0].shape[1]
            amp = pieces(q)[idx // csz][:, idx % csz]
            got["getProbAmp"] = row(
                "getProbAmp", name, width, lambda: qt.getProbAmp(q, idx), float(p[idx]), lim,
                2 * item, "torch.linalg.vector_norm", lambda: torch.linalg.vector_norm(amp))
            work = qt.createQureg(N_MAIN, env, prec)
            ppsi = _pauli_ref(psi, k, *READ_PROD)
            got["calcExpecPauliProd"] = row(
                "calcExpecPauliProd", name, width,
                lambda: qt.calcExpecPauliProd(q, *READ_PROD, work),
                float((psi.conj() * ppsi).sum().real), lim, 2 * S, "torch.einsum",
                lambda: einsum_expec(c, *READ_PROD))
            werr = float((_c128(pieces(work)) - ppsi).abs().max())
            _require(werr <= lim, f"readout calcExpecPauliProd {name} {width}: workspace "
                                  f"{werr} from P|psi>")
            del ppsi
            h_ref = sum(float(co) * float((psi.conj() * _pauli_ref(psi, k, *tc)).sum().real)
                        for co, tc in zip(hcoeffs, terms))
            hsum = lambda: sum(float(co) * einsum_expec(c, *tc).real  # noqa: E731
                               for co, tc in zip(hcoeffs, terms))
            before = [x.clone() for x in pieces(work)]
            hwidth = f"{width} TFIM {len(hcoeffs)} terms"
            got["calcExpecPauliHamil"] = row(
                "calcExpecPauliHamil", name, hwidth,
                lambda: qt.calcExpecPauliHamil(q, hamil, work), h_ref, lim, S, hname, hsum,
                reps=1, scale=hscale)
            got["calcExpecPauliSum"] = row(
                "calcExpecPauliSum", name, hwidth,
                lambda: qt.calcExpecPauliSum(q, hcodes.ravel(), hcoeffs, work), h_ref, lim,
                S, hname, rows[-1]["yardstick_ms"], reps=1, scale=hscale)
            _require(all(torch.equal(x, y) for x, y in zip(before, pieces(work))),
                     f"readout {name} {width}: calcExpecPauliSum wrote its workspace")
            del before
            row("syncQuESTEnv", name, width, lambda: qt.syncQuESTEnv(env), 0.0, 0.0, 0,
                "torch.cuda.synchronize", torch.cuda.synchronize, value_of=lambda r: 0.0)
            if sharded:
                # the same states on one device (re-cut across layouts by
                # cloneQureg): the sharded values against the one-device ones
                one = qt.createQuESTEnv(device=dev)
                q1, q12, w1 = (qt.createQureg(N_MAIN, one, prec) for _ in range(3))
                qt.cloneQureg(q1, q)
                qt.cloneQureg(q12, q2)
                ones = {"calcInnerProduct": qt.calcInnerProduct(q1, q12),
                        "calcFidelity": qt.calcFidelity(q1, q12),
                        "getProbAmp": qt.getProbAmp(q1, idx),
                        "calcExpecPauliProd": qt.calcExpecPauliProd(q1, *READ_PROD, w1),
                        "calcExpecPauliHamil": qt.calcExpecPauliHamil(q1, hamil, w1),
                        "calcExpecPauliSum": qt.calcExpecPauliSum(q1, hcodes.ravel(), hcoeffs,
                                                                  w1)}
                ones.update({f"calcProbOfAllOutcomes {t}": qt.calcProbOfAllOutcomes(q1, t)
                             for t in READ_TARGETS})
                worst = 0.0
                for fn, b in ones.items():
                    sc = hscale if "Pauli" in fn and "Prod" not in fn else 1.0
                    e = float(np.max(np.abs(np.asarray(got[fn]) - np.asarray(b)))) / sc
                    _require(e <= lim, f"readout {fn} {name}: sharded {got[fn]} against one "
                                       f"device {b}, {e} > {lim}")
                    worst = max(worst, e)
                # mixed layouts: a sharded register beside a one-device one
                mwidth = f"{N_MAIN}q mixed layouts ({N_SHARDS} shards, one device)"
                row("calcInnerProduct", name, mwidth, lambda: qt.calcInnerProduct(q, q12),
                    ip_ref, lim, 2 * S, "torch.vdot", lambda: torch.vdot(c, c2))
                row("calcFidelity", name, mwidth, lambda: qt.calcFidelity(q1, q2),
                    abs(ip_ref) ** 2, lim, 2 * S, "torch.vdot", lambda: torch.vdot(c, c2))
                row("calcExpecPauliProd", name, mwidth,
                    lambda: qt.calcExpecPauliProd(q, *READ_PROD, w1),
                    got["calcExpecPauliProd"], lim, 2 * S, "torch.einsum",
                    lambda: einsum_expec(c, *READ_PROD))
                print(f"# readout {name} {N_SHARDS} shards against one device: {len(ones)} "
                      f"values, largest difference {worst:.3e} (limit {lim:g})")
                for x in (q1, q12, w1):
                    qt.destroyQureg(x)
            for x in (q2, work):
                qt.destroyQureg(x)
            del psi, phi, p, pd, c, c2, amp
            torch.cuda.empty_cache()

        # -- density: the r4 and r3 states of the density phase -------------
        r4, r3 = dens[dt]
        nd = N_DENSITY
        dim, SD = 1 << nd, 2 * (1 << 2 * nd) * item
        width = f"{nd}q density ({2 * nd} flattened)"
        a, b = _c128([r4.amps]), _c128([r3.amps])
        ca, cb = torch.complex(r4.amps[0], r4.amps[1]), torch.complex(r3.amps[0], r3.amps[1])
        row("calcDensityInnerProduct", name, width, lambda: qt.calcDensityInnerProduct(r4, r3),
            float((a.conj() * b).sum().real), lim, 2 * SD, "torch.vdot",
            lambda: torch.vdot(ca, cb))
        del cb
        row("calcHilbertSchmidtDistance", name, width,
            lambda: qt.calcHilbertSchmidtDistance(r4, r3),
            float((a - b).abs().square().sum().sqrt()), lim, 2 * SD, "torch.dist",
            lambda: torch.dist(r4.amps, r3.amps))
        pure = qt.createQureg(nd, r4.env, prec)
        prng = np.random.RandomState(67)
        v = prng.randn(dim) + 1j * prng.randn(dim)
        v /= np.linalg.norm(v)
        qt.initStateFromAmps(pure, v.real, v.imag)
        psi = _c128([pure.amps])
        cp = torch.complex(pure.amps[0], pure.amps[1])
        kd = torch.arange(dim, device=dev)
        # every reference of the rows below, before the complex128 copies go
        # mat[c, r] = rho(r, c): <psi|rho|psi> = sum_r conj(psi_r) (mat^T psi)_r
        fid_ref = float((psi.conj() * (a.view(dim, dim).T @ psi)).sum().real)
        out_ref = _outcomes_ref(a[kd * dim + kd].real, kd, READ_TARGETS_DENSITY).cpu().numpy()
        prod_ref = _pauli_trace_ref(a, dim, kd, *READ_PROD_DENSITY)
        mixed = 0.7 * a + 0.3 * b
        del a, b, psi
        trace_ref = float(mixed[kd * dim + kd].real.sum())
        purity_ref = float(mixed.abs().square().sum())
        torch.cuda.empty_cache()
        row("calcFidelity", name, f"{width} with a {nd}q pure state",
            lambda: qt.calcFidelity(r4, pure), fid_ref, lim, SD + 2 * dim * item,
            "torch.einsum", lambda: torch.einsum("r,cr,c->", cp.conj(), ca.view(dim, dim), cp))
        dd = r4.amps[0].view(dim, dim).diagonal()
        shape = _grouped_letters(nd, READ_TARGETS_DENSITY)[0]
        rest = tuple(range(0, len(shape), 2))
        row("calcProbOfAllOutcomes", name, f"{width} targets {READ_TARGETS_DENSITY}",
            lambda: qt.calcProbOfAllOutcomes(r4, READ_TARGETS_DENSITY), out_ref, lim,
            dim * item, "torch.sum over the grouped diagonal",
            lambda: torch.sum(dd.reshape(shape), dim=rest))
        dwork = qt.createDensityQureg(nd, r4.env, prec)
        row("calcExpecPauliProd", name, width,
            lambda: qt.calcExpecPauliProd(r4, *READ_PROD_DENSITY, dwork), prod_ref, lim,
            2 * SD, "torch.einsum", lambda: _density_einsum(ca, nd, *READ_PROD_DENSITY, mats))
        qt.destroyQureg(dwork)
        qt.destroyQureg(pure)
        del ca, cp
        torch.cuda.empty_cache()
        # checked on r4 <- 0.7 r4 + 0.3 r3; timed as mixDensityMatrix(r3, 0,
        # r4), the same work, which leaves both registers as they are
        row("mixDensityMatrix", name, f"{width} p 0.3",
            lambda: qt.mixDensityMatrix(r4, 0.3, r3), 0.0, lim, 3 * SD, "torch.lerp",
            lambda: torch.lerp(r4.amps, r3.amps, 0.3),
            value_of=lambda r: float((_c128([r4.amps]) - mixed).abs().max()),
            timed=lambda: qt.mixDensityMatrix(r3, 0.0, r4))
        del mixed
        row("calcTotalProb", name, f"{width} after the mix", lambda: qt.calcTotalProb(r4),
            trace_ref, lim, dim * item, "torch.sum of the diagonal",
            lambda: torch.sum(r4.amps[0].view(dim, dim).diagonal()))
        row("calcPurity", name, f"{width} after the mix", lambda: qt.calcPurity(r4),
            purity_ref, lim, SD, "torch.linalg.vector_norm",
            lambda: torch.linalg.vector_norm(r4.amps))
        torch.cuda.empty_cache()
    print(f"# readout phase: {len(rows)} calls in {time.perf_counter() - t0:.1f} s")
    return rows



#: the operators phase at N_MAIN qubits (25 and 24 sharded over N_SHARDS
#: shards): applyQFT's unsorted qubit subset; the Trotter circuit's order,
#: repetitions and time; the phase functions' registers: the overrides'
#: (TWOS_COMPLEMENT), the multi-variable function's two,
#: SCALED_INVERSE_SHIFTED_DISTANCE's four and NORM's three; the
#: projector's targets; on the N_DENSITY-qubit density register, the phase
#: function's qubits and the sub-diagonal operators' targets
QFT_SUBSET = (17, 3, 25, 9, 0, 12)
TROTTER = (2, 2, 0.1)
PF_OVERRIDE_QUBITS = (25, 3, 17, 24, 8, 11)
PF_MULTI_REGS = ((2, 7, 13, 19, 23), (25, 1, 9, 16))
PF_DIST_REGS = ((0, 5, 10, 15), (20, 24, 2, 7), (12, 25, 3, 18), (22, 8, 14, 1))
PF_NORM_REGS = ((4, 9, 14, 19, 24), (6, 11, 16, 21, 25), (0, 13, 18, 23, 5))
PROJECTOR_TARGETS = (3, 25)
DENSITY_PF_QUBITS = (11, 2, 7, 0)
DENSITY_SUBDIAG_TARGETS = ((13, 4, 9), (1, 12))


def _bits_value(k, qubits, twos: bool = False):
    """Each index's sub-register value (qubits[0] the least significant bit;
    ``twos``: the last qubit weighs -2^(m-1)), float64 on k's device."""
    import torch

    m = len(qubits)
    v = torch.zeros(k.shape, dtype=torch.float64, device=k.device)
    for j, q in enumerate(qubits):
        w = -float(1 << (m - 1)) if twos and j == m - 1 else float(1 << j)
        v += ((k >> q) & 1).to(torch.float64) * w
    return v


def _subset_qft_ref(psi, n: int, qubits):
    """The QFT of the sub-register ``qubits`` (qubits[0] the least
    significant) from its definition in complex128: sqrt(M) ifft along the
    sub-register's index, the other qubits untouched."""
    import torch

    m = len(qubits)
    axes = [n - 1 - q for q in reversed(qubits)]  # most significant first
    t = psi.view([2] * n)
    rest = [a for a in range(n) if a not in axes]
    perm = axes + rest
    x = t.permute(perm).reshape(1 << m, -1)
    y = torch.fft.ifft(x, dim=0) * (1 << m) ** 0.5
    inv = [perm.index(a) for a in range(n)]
    return y.reshape([2] * n).permute(inv).reshape(-1)


def _operators_phase(qt, dev, sv: dict) -> dict:
    """The operators slice on the card (``# operators ...`` lines): ``sv``
    holds the main path's final N_MAIN-qubit registers by dtype, which this
    phase reads and then destroys. Every value against an evaluation from
    its definition in complex128 or float64 on the card:

    - QFT, f32 and f64: ``Circuit(N_MAIN).applyFullQFT()`` planned by
      ``Circuit.fused(max_qubits=5, pallas=True)`` at the Hopper tile, each
      run's pass against the plain version (1e-5 / 1e-12 of the largest
      amplitude; timed), then run with the counts reset (launches = runs,
      no fallback): on ``initClassicalState(k)`` against e^{2 pi i jk/N} /
      sqrt(N), on the main path's final state against sqrt(N)
      ``torch.fft.ifft`` of it (2e-4 / 1e-10 of the largest amplitude);
      the eager ``applyFullQFT`` (per-gate engine) and ``applyQFT`` on
      QFT_SUBSET against the same references; passes, fused and eager ms,
      the passes' summed bound and one ``torch.fft.fft`` (the yardstick,
      never called by the port);
    - Trotter, f32 and f64: the readout phase's 51-term transverse-field
      Ising Hamiltonian, TROTTER's order, repetitions and time, on a tape
      (fused, each pass against the plain version, launches = runs) against
      the eager per-gate run, total probability within 1e-4 / 1e-10 of 1;
    - phase functions, f32 and f64 on one device and f32 over N_SHARDS
      shards (also against one device), TWOS_COMPLEMENT overrides on
      unsorted qubits with the sharded 24 and 25, a two-register
      multi-variable function, SCALED_INVERSE_SHIFTED_DISTANCE on four
      registers, NORM on three; |phase| < 100; and on a 14-qubit f32
      density register with its conj shadow;
    - DiagonalOp, f32 and f64 and f32 over N_SHARDS shards: random
      unit-modulus elements, ``applyDiagonalOp`` and
      ``calcExpecDiagonalOp`` (beside 3 x state bytes and one complex
      ``torch.mul``);
    - ``applyProjector`` on qubit 3 and the sharded qubit 25,
      ``applySubDiagonalOp`` / ``applyGateSubDiagonalOp`` and
      ``setQuregToPauliHamil`` (a 14-qubit TFIM, against a host-built
      sparse reference) on 14-qubit f32 density registers,
      ``applyPauliHamil`` with the 26-qubit TFIM (Re <psi|out> against
      ``calcExpecPauliHamil``, ``in_qureg`` unchanged), and the
      copyState*GPU round trip at N_MAIN qubits and a substate across a
      shard boundary over N_SHARDS shards.

    Each call is timed on the card's clock beside its bytes bound (the
    state bytes it must read and write / 3.35 TB/s). Returns each fused
    path's launches, passes and per-pass stats for the ``kernels`` line."""
    import os

    import numpy as np
    import torch

    from quest_tpu_torch import fusion, telemetry
    from quest_tpu_torch.ops import fused_gates as FG

    t_phase = time.perf_counter()
    n = N_MAIN
    N = 1 << n
    k = torch.arange(N, device=dev)
    env1 = qt.createQuESTEnv(device=dev)
    env4 = qt.createQuESTEnv(devices=[dev] * N_SHARDS)
    out = {}

    def line(what: str) -> None:
        print(f"# operators {what}")

    def pieces(q):
        return q.shards or [q.amps]

    def rel(got, ref) -> float:
        return float((got - ref).abs().max() / ref.abs().max())

    hamil = tfim_hamil(qt, n, seed=61)
    # the DiagonalOp's random unit-modulus elements, host arrays as a user
    # passes them to initDiagonalOp
    theta = np.random.RandomState(79).uniform(0, 2 * np.pi, N)
    re_h, im_h = np.cos(theta), np.sin(theta)
    del theta
    for dt in (torch.float32, torch.float64):
        f32 = dt == torch.float32
        name, prec = str(dt)[6:], (1 if f32 else 2)
        tol_k, tol = (1e-5, 2e-4) if f32 else (1e-12, 1e-10)
        item = 4 if f32 else 8
        S = 2 * N * item
        src = sv[dt]
        psi = _c128(pieces(src))
        cdt = torch.complex64 if f32 else torch.complex128

        # -- QFT: plan, passes, the fused run with the counts reset --------
        circ = qt.Circuit(n)
        circ.applyFullQFT()
        t0 = time.perf_counter()
        fz = circ.fused(max_qubits=5, pallas=True, dtype=dt)
        plan_s = time.perf_counter() - t0
        runs = [a[0] for f, a, _ in fz._tape if f is fusion._apply_pallas_run]
        blocks = [a[0] for f, a, _ in fz._tape if f is fusion._apply_dense_block]
        other = [f.__name__ for f, _, _ in fz._tape
                 if f not in (fusion._apply_pallas_run, fusion._apply_dense_block)]
        _require(runs and not other, f"operators qft {name}: plan holds {other}")
        # a dense block below the lane boundary is one more kernel pass
        lane = [b for b in blocks if fusion.dense_block_route(n, False, b.qubits, True)
                == "lane_u"]
        tb = FG.hopper_tile_bits(n, dt)
        gates = n + n * (n - 1) // 2 + n // 2
        line(f"qft {name}: applyFullQFT at {n}q ({gates} gates) -> {len(runs)} fused runs "
             f"at tile_bits {runs[0].tile_bits} and dense blocks on "
             f"{[b.qubits for b in blocks]} ({len(lane)} through the kernel as lane_u, the "
             f"rest on the per-gate engine), planned in {plan_s:.2f} s")
        res = _passes([_run_item(r) for r in runs] +
                      [(1, fusion.lane_u_run(b, tb), dict(tile_bits=tb, **_swaps()))
                       for b in lane], n, dt, dev,
                      np.random.RandomState(71), tol_k, f"operators qft {name}")
        out[("diag_arm", dt)] = _diag_arm_alone(dev, runs, dt)
        kernel_passes = len(runs) + len(lane)
        torch.cuda.empty_cache()
        q = qt.createQureg(n, env1, prec)
        kc = 12345 % N
        qt.initClassicalState(q, kc)
        telemetry.reset()
        FG.fused_run.launches = 0
        fz.run(q)
        torch.cuda.synchronize()
        launches = FG.fused_run.launches
        fallbacks = telemetry.counter_total("engine_fallback_total")
        _require(launches == kernel_passes, f"operators qft {name}: launches {launches} != "
                                            f"kernel passes {kernel_passes}")
        _require(fallbacks == 0, f"operators qft {name}: engine fallback")
        phase = 2 * np.pi * ((k * kc) % N).to(torch.float64) / N
        closed = torch.polar(torch.full_like(phase, N ** -0.5), phase)
        e_closed = rel(_c128(pieces(q)), closed)
        del phase, closed
        _require(e_closed <= tol, f"operators qft {name}: |k> against the closed form "
                                  f"{e_closed} > {tol}")
        qt.cloneQureg(q, src)
        FG.fused_run.launches = 0
        fz.run(q)  # the second run: a capture for the register's buffers, then its replay
        torch.cuda.synchronize()
        _require(FG.fused_run.launches == 0,
                 f"operators qft {name}: the replay moved the wrapper's launches")
        ref = torch.fft.ifft(psi) * N ** 0.5
        e_fused = rel(_c128(pieces(q)), ref)
        _require(e_fused <= tol, f"operators qft {name}: fused against sqrt(N) ifft "
                                 f"{e_fused} > {tol}")
        _warm_run(fz, q)
        ran, _ = _card_runs(lambda: fz.run(q))  # a replay, nothing captured
        nodes = _graph_kernels(fz.compiled())
        _require(nodes == kernel_passes and 0 < ran["fused_run"] <= nodes,
                 f"operators qft {name}: the replayed graph holds {nodes} fused_run kernels "
                 f"(kernel passes {kernel_passes}), the card's trace shows {ran['fused_run']}")
        fused_ms = _clock_ms(lambda: fz.run(q), 3)
        qe = qt.createQureg(n, env1, prec)
        qt.cloneQureg(qe, src)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        FG.fused_run.launches = 0
        qt.applyFullQFT(qe)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3
        _require(FG.fused_run.launches == 0, "operators: the eager QFT launched the kernel")
        e_eager = rel(_c128(pieces(qe)), ref)
        _require(e_eager <= tol, f"operators qft {name}: eager against sqrt(N) ifft "
                                 f"{e_eager} > {tol}")
        qt.cloneQureg(qe, src)
        t0 = time.perf_counter()
        qt.applyQFT(qe, list(QFT_SUBSET))
        torch.cuda.synchronize()
        sub_ms = (time.perf_counter() - t0) * 1e3
        e_sub = rel(_c128(pieces(qe)), _subset_qft_ref(psi, n, QFT_SUBSET))
        _require(e_sub <= tol, f"operators applyQFT {name}: against its definition "
                               f"{e_sub} > {tol}")
        c = psi.to(cdt)
        fft_ms = _cuda_ms(lambda: torch.fft.fft(c), 3)
        del c, ref
        bound = sum(res["bound_ms"])
        line(f"qft {name}: launches {launches} (runs {len(runs)} + lane_u blocks "
             f"{len(lane)}), engine_fallback_total "
             f"{fallbacks:g}; |{kc}> against the closed form {e_closed:.3e}, the main "
             f"path's state against sqrt(N) ifft {e_fused:.3e} fused, {e_eager:.3e} eager "
             f"(of the largest amplitude, limit {tol:g}); fused {fused_ms:.4f} ms "
             f"({sum(res['ms']):.4f} ms of kernel passes, summed bound {bound:.4f} ms: "
             f"{bound / fused_ms:.1%}), eager {eager_ms:.1f} ms, yardstick torch.fft.fft "
             f"({str(cdt)[6:]}) {fft_ms:.4f} ms ({fused_ms / fft_ms:.2f}x)")
        line(f"applyQFT {name}: qubits {list(QFT_SUBSET)} eager {sub_ms:.1f} ms, against its "
             f"definition {e_sub:.3e} (limit {tol:g})")
        res.update(launches=launches, runs=kernel_passes, fused_ms=fused_ms, eager_ms=eager_ms,
                   fft_ms=fft_ms, summed_bound_ms=bound, graph_kernels=nodes,
                   traced=ran["fused_run"])
        out[("qft", dt)] = res
        out[("qft_plan", dt)] = fz
        qt.destroyQureg(qe)

        # -- Trotter: the TFIM on a tape, fused against eager -------------
        order, reps, t_evol = TROTTER
        tc = qt.Circuit(n)
        tc.applyTrotterCircuit(hamil, t_evol, order, reps)
        tz = tc.fused(max_qubits=5, pallas=True, dtype=dt)
        truns = [a[0] for f, a, _ in tz._tape if f is fusion._apply_pallas_run]
        _require(truns and len(truns) == len(tz._tape),
                 f"operators trotter {name}: plan is not all fused runs")
        tres = _passes([_run_item(r) for r in truns], n, dt, dev,
                       np.random.RandomState(73), tol_k, f"operators trotter {name}")
        qt.cloneQureg(q, src)
        # the input's own total probability, beside the output's: it says
        # whether a miss came from the input state or from the passes
        total_in = qt.calcTotalProb(q)
        telemetry.reset()
        FG.fused_run.launches = 0
        tz.run(q)
        torch.cuda.synchronize()
        tl = FG.fused_run.launches
        _require(tl == len(truns) and telemetry.counter_total("engine_fallback_total") == 0,
                 f"operators trotter {name}: launches {tl} != runs {len(truns)}")
        total = qt.calcTotalProb(q)
        _require(abs(total - 1) <= (1e-4 if f32 else 1e-10),
                 f"operators trotter {name}: total probability {total} (input {total_in})")
        qe = qt.createQureg(n, env1, prec)
        qt.cloneQureg(qe, src)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qt.applyTrotterCircuit(qe, hamil, t_evol, order, reps)
        torch.cuda.synchronize()
        t_eager = (time.perf_counter() - t0) * 1e3
        e_tr = rel(_c128(pieces(q)), _c128(pieces(qe)))
        _require(e_tr <= tol, f"operators trotter {name}: fused against eager {e_tr} > {tol}")
        _warm_run(tz, q)
        t_fused = _clock_ms(lambda: tz.run(q), 2)
        line(f"trotter {name}: {len(hamil.term_coeffs)}-term TFIM, order {order}, reps {reps}, "
             f"t {t_evol}: {len(truns)} fused runs, launches {tl}; calcTotalProb {total:.12f} "
             f"(input {total_in:.12f}); "
             f"fused against eager {e_tr:.3e} of the largest (limit {tol:g}); fused "
             f"{t_fused:.4f} ms ({sum(tres['ms']):.4f} ms of kernel passes, summed bound "
             f"{sum(tres['bound_ms']):.4f} ms), eager {t_eager:.1f} ms")
        tres.update(launches=tl, runs=len(truns), fused_ms=t_fused, eager_ms=t_eager,
                    total_prob=total, input_total_prob=total_in)
        out[("trotter", dt)] = tres
        out[("trotter_plan", dt)] = tz
        qt.destroyQureg(qe)

        # -- phase functions on one device (and in f32 over shards) -------
        pf_calls = [
            ("applyPhaseFuncOverrides", lambda r: qt.applyPhaseFuncOverrides(
                r, list(PF_OVERRIDE_QUBITS), qt.bitEncoding.TWOS_COMPLEMENT,
                [0.5, -0.03, 0.001], [1.0, 2.0, 3.0], [-32, 0, 5], [0.25, -1.5, 3.0])),
            ("applyMultiVarPhaseFunc", lambda r: qt.applyMultiVarPhaseFunc(
                r, [q for g in PF_MULTI_REGS for q in g], [len(g) for g in PF_MULTI_REGS],
                qt.bitEncoding.UNSIGNED, [0.7, -0.02, 0.3], [1.0, 2.0, 1.0], [2, 1])),
            ("applyParamNamedPhaseFunc", lambda r: qt.applyParamNamedPhaseFunc(
                r, [q for g in PF_DIST_REGS for q in g], [len(g) for g in PF_DIST_REGS],
                qt.bitEncoding.UNSIGNED, qt.phaseFunc.SCALED_INVERSE_SHIFTED_DISTANCE,
                [1.5, 0.0, 0.5, -2.5])),
            ("applyNamedPhaseFunc", lambda r: qt.applyNamedPhaseFunc(
                r, [q for g in PF_NORM_REGS for q in g], [len(g) for g in PF_NORM_REGS],
                qt.bitEncoding.UNSIGNED, qt.phaseFunc.NORM)),
        ]

        def pf_ref(fn):
            """The phase of each index from the definition, float64."""
            if fn == "applyPhaseFuncOverrides":
                x = _bits_value(k, PF_OVERRIDE_QUBITS, twos=True)
                ph = 0.5 * x - 0.03 * x ** 2 + 0.001 * x ** 3
                for i, p in reversed(list(zip([-32, 0, 5], [0.25, -1.5, 3.0]))):
                    ph = torch.where(x == i, torch.full_like(ph, p), ph)
                return ph
            if fn == "applyMultiVarPhaseFunc":
                x, y = (_bits_value(k, g) for g in PF_MULTI_REGS)
                return 0.7 * x - 0.02 * x ** 2 + 0.3 * y
            if fn == "applyParamNamedPhaseFunc":
                v = [_bits_value(k, g) for g in PF_DIST_REGS]
                d = torch.sqrt((v[0] - v[1] - 0.5) ** 2 + (v[2] - v[3] + 2.5) ** 2)
                return torch.where(d <= 1e-13, torch.zeros_like(d), 1.5 / d)
            return torch.sqrt(sum(_bits_value(k, g) ** 2 for g in PF_NORM_REGS))

        q1 = qt.createQureg(n, env1, prec)
        qs = qt.createQureg(n, env4, prec) if f32 else None
        for fn, call in pf_calls:
            ph = pf_ref(fn)
            _require(float(ph.abs().max()) < 100, f"operators {fn}: |phase| >= 100")
            want = psi * torch.polar(torch.ones_like(ph), ph)
            del ph
            regs = [(r, lay) for r, lay in ((q1, "one device"), (qs, f"{N_SHARDS} shards"))
                    if r is not None]
            errs = []
            for r, lay in regs:
                qt.cloneQureg(r, src)
                call(r)
                torch.cuda.synchronize()
                got = _c128(pieces(r))
                e = rel(got, want)
                _require(e <= tol, f"operators {fn} {name} {lay}: {e} > {tol}")
                e1 = rel(got, _c128(pieces(q1))) if r is qs else 0.0
                _require(e1 <= 1e-6, f"operators {fn} {name}: shards against one device {e1}")
                errs.append((e, e1))
                del got
            for (r, lay), (e, e1) in zip(regs, errs):
                ms = _cuda_ms(lambda: call(r), 3)
                bound = 2 * S / HBM_BYTES_PER_S * 1e3
                line(f"{fn} {name} {n}q {lay}: against the float64 definition {e:.3e} of the "
                     f"largest (limit {tol:g})" + (f", against one device {e1:.3e}" if r is qs
                                                   else "") +
                     f"; {ms:.4f} ms, bound {bound:.4f} ms ({bound / ms:.1%})")
                out[(fn, dt, lay)] = {"ms": ms, "bound_ms": bound, "error": e}
            del want
        torch.cuda.empty_cache()

        # -- DiagonalOp: apply and expectation ----------------------------
        prev = os.environ.get("QUEST_PRECISION")
        os.environ["QUEST_PRECISION"] = str(prec)  # the op's global precision
        try:
            ops = [(qt.createDiagonalOp(n, env1), q1, "one device")]
            if f32:
                ops.append((qt.createDiagonalOp(n, env4), qs, f"{N_SHARDS} shards"))
        finally:
            if prev is None:
                del os.environ["QUEST_PRECISION"]
            else:
                os.environ["QUEST_PRECISION"] = prev
        for op, r, lay in ops:
            t0 = time.perf_counter()
            qt.initDiagonalOp(op, re_h, im_h)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            _require(op.pieces[0].dtype == dt, f"operators DiagonalOp {name}: dtype")
            d = _c128(op.pieces)
            qt.cloneQureg(r, src)
            want_e = complex((psi.abs() ** 2 * d).sum())
            got_e = qt.calcExpecDiagonalOp(r, op)
            e_e = abs(got_e - want_e)
            _require(e_e <= tol, f"operators calcExpecDiagonalOp {name} {lay}: {got_e} "
                                 f"against {want_e}")
            ems = _cuda_ms(lambda: qt.calcExpecDiagonalOp(r, op), 3)
            qt.applyDiagonalOp(r, op)
            torch.cuda.synchronize()
            e_a = rel(_c128(pieces(r)), d * psi)
            _require(e_a <= tol, f"operators applyDiagonalOp {name} {lay}: {e_a} > {tol}")
            ams = _cuda_ms(lambda: qt.applyDiagonalOp(r, op), 3)
            cs, cd = psi.to(cdt), d.to(cdt)
            mul_ms = _cuda_ms(lambda: torch.mul(cs, cd), 3)
            del cs, cd, d
            bound = 3 * S / HBM_BYTES_PER_S * 1e3
            line(f"DiagonalOp {name} {n}q {lay}: initDiagonalOp {init_s:.2f} s (host arrays); "
                 f"applyDiagonalOp against the definition {e_a:.3e} of the largest, "
                 f"{ams:.4f} ms, bound {bound:.4f} ms, yardstick torch.mul "
                 f"({str(cdt)[6:]}) {mul_ms:.4f} ms; calcExpecDiagonalOp {got_e:.10g}, error "
                 f"{e_e:.3e} (limit {tol:g}), {ems:.4f} ms, bound "
                 f"{2 * S / HBM_BYTES_PER_S * 1e3:.4f} ms")
            out[("applyDiagonalOp", dt, lay)] = {"ms": ams, "bound_ms": bound,
                                                  "yardstick_ms": mul_ms}
            out[("calcExpecDiagonalOp", dt, lay)] = {"ms": ems,
                                                     "bound_ms": 2 * S / HBM_BYTES_PER_S * 1e3}
            qt.destroyDiagonalOp(op)
        torch.cuda.empty_cache()

        # -- projector, Pauli Hamiltonian ---------------------------------
        for r, lay in ((q1, "one device"), (qs, f"{N_SHARDS} shards")):
            if r is None:
                continue
            for target, outcome in zip(PROJECTOR_TARGETS, (1, 0)):
                qt.cloneQureg(r, src)
                qt.applyProjector(r, target, outcome)
                torch.cuda.synchronize()
                keep = ((k >> target) & 1) == outcome
                e = rel(_c128(pieces(r)), torch.where(keep, psi, torch.zeros_like(psi)))
                _require(e <= tol, f"operators applyProjector {name} {lay} {target}: {e}")
                del keep
                ms = _cuda_ms(lambda: qt.applyProjector(r, target, outcome), 3)
                bound = 2 * S / HBM_BYTES_PER_S * 1e3
                line(f"applyProjector {name} {n}q {lay}: qubit {target} outcome {outcome}, "
                     f"against the definition {e:.3e}; {ms:.4f} ms, bound {bound:.4f} ms")
                out[("applyProjector", dt, lay, target)] = {"ms": ms, "bound_ms": bound}
        qt.cloneQureg(q1, src)
        before = q1.amps.clone()
        po = qt.createQureg(n, env1, prec)
        t0 = time.perf_counter()
        qt.applyPauliHamil(q1, hamil, po)
        torch.cuda.synchronize()
        ph_ms = (time.perf_counter() - t0) * 1e3
        _require(torch.equal(before, q1.amps), f"operators applyPauliHamil {name}: in_qureg "
                                               "changed")
        del before
        ip = qt.calcInnerProduct(q1, po).real
        ex = qt.calcExpecPauliHamil(q1, hamil, qt.createQureg(n, env1, prec))
        scale = float(np.abs(hamil.term_coeffs).sum())
        e = abs(ip - ex) / scale
        _require(e <= (1e-4 if f32 else 1e-10), f"operators applyPauliHamil {name}: "
                                                f"Re<psi|out> {ip} against {ex}")
        line(f"applyPauliHamil {name} {n}q: Re<psi|H psi> {ip:.10g} against "
             f"calcExpecPauliHamil {ex:.10g}, {e:.3e} of sum |c_t|; in_qureg unchanged; "
             f"{ph_ms:.1f} ms ({len(hamil.term_coeffs)} terms)")
        out[("applyPauliHamil", dt)] = {"ms": ph_ms}
        for r in (q, q1, po, qs):
            if r is not None:
                qt.destroyQureg(r)
        del psi
        torch.cuda.empty_cache()

    del re_h, im_h

    # -- 14-qubit density, f32: phase function, sub-diagonals, PauliHamil --
    nd, dim = N_DENSITY, 1 << N_DENSITY
    SD = 2 * dim * dim * 4
    rho = qt.createDensityQureg(nd, env1, 1)
    kd = torch.arange(dim * dim, device=dev)
    row, col = kd & (dim - 1), kd >> nd
    qt.initPlusState(rho)  # every element 1 / dim: the result is its factor
    qt.applyPhaseFunc(rho, list(DENSITY_PF_QUBITS), qt.bitEncoding.UNSIGNED, [0.4, -0.02],
                      [1.0, 2.0])
    torch.cuda.synchronize()

    def poly(idx):
        x = _bits_value(idx, DENSITY_PF_QUBITS)
        return 0.4 * x - 0.02 * x ** 2

    want = torch.polar(torch.full(kd.shape, 1.0 / dim, dtype=torch.float64, device=dev),
                       poly(row) - poly(col))
    e = rel(_c128([rho.amps]), want)
    _require(e <= 1e-4, f"operators applyPhaseFunc density: {e}")
    ms = _clock_ms(lambda: qt.applyPhaseFunc(rho, list(DENSITY_PF_QUBITS), 0, [0.4, -0.02],
                                             [1.0, 2.0]), 2)
    line(f"applyPhaseFunc float32 {nd}q density ({2 * nd} flattened), rows and the conj "
         f"shadow: against the definition {e:.3e} (limit 0.0001); {ms:.4f} ms, bound "
         f"{2 * 2 * SD / HBM_BYTES_PER_S * 1e3:.4f} ms (two passes)")
    srng = np.random.RandomState(83)
    for fn, targets, shadow in (("applySubDiagonalOp", DENSITY_SUBDIAG_TARGETS[0], False),
                                ("applyGateSubDiagonalOp", DENSITY_SUBDIAG_TARGETS[1], True)):
        elems = np.exp(1j * srng.uniform(0, 2 * np.pi, 1 << len(targets)))
        op = qt.createSubDiagonalOp(len(targets))
        op.elems[:] = elems
        qt.initPlusState(rho)
        getattr(qt, fn)(rho, list(targets), op)
        torch.cuda.synchronize()
        dv = torch.as_tensor(elems, device=dev)

        def sel(idx):
            s = torch.zeros_like(idx)
            for j, t in enumerate(targets):
                s |= ((idx >> t) & 1) << j
            return s

        want = dv[sel(row)] / dim
        if shadow:
            want = want * dv[sel(col)].conj()
        e = rel(_c128([rho.amps]), want)
        _require(e <= 1e-4, f"operators {fn} density: {e}")
        ms = _clock_ms(lambda: getattr(qt, fn)(rho, list(targets), op), 2)
        line(f"{fn} float32 {nd}q density: targets {list(targets)}, against the definition "
             f"{e:.3e} (limit 0.0001); {ms:.4f} ms, bound "
             f"{(2 if shadow else 1) * 2 * SD / HBM_BYTES_PER_S * 1e3:.4f} ms")
    del want, row, col
    dh = tfim_hamil(qt, nd, seed=89)
    t0 = time.perf_counter()
    qt.setQuregToPauliHamil(rho, dh)
    torch.cuda.synchronize()
    sq_ms = (time.perf_counter() - t0) * 1e3
    # the host-built sparse reference: one non-zero per column and term,
    # at row c ^ f, summed where terms meet (the diagonal)
    ch = np.arange(dim)
    keys, vals = [], []
    for codes, coeff in zip(dh.pauli_codes, dh.term_coeffs):
        f = sum(1 << qq for qq, cc in enumerate(codes) if cc in (1, 2))
        par = np.zeros(dim, dtype=np.int64)
        for qq, cc in enumerate(codes):
            if cc in (2, 3):
                par ^= (ch >> qq) & 1
        keys.append(ch * dim + (ch ^ f))
        vals.append(coeff * (1j ** int(np.sum(codes == 2))) * (1 - 2 * par))
    uk, inv = np.unique(np.concatenate(keys), return_inverse=True)
    uv = np.zeros(uk.size, dtype=np.complex128)
    np.add.at(uv, inv, np.concatenate(vals))
    got = _c128([rho.amps])
    idx = torch.as_tensor(uk, device=dev)
    ref_v = torch.as_tensor(uv, device=dev)
    e_nz = float((got[idx] - ref_v).abs().max() / ref_v.abs().max())
    got[idx] = 0
    e_z = float(got.abs().max())
    _require(e_nz <= 1e-6 and e_z == 0.0, f"operators setQuregToPauliHamil: {e_nz}, {e_z}")
    line(f"setQuregToPauliHamil float32 {nd}q density: {len(dh.term_coeffs)}-term TFIM, "
         f"{uk.size} non-zeros against the host-built sparse reference {e_nz:.3e} of the "
         f"largest, every other element 0; {sq_ms:.1f} ms (bound "
         f"{(SD + SD * 2) / HBM_BYTES_PER_S * 1e3:.4f} ms: the float64 sum written, "
         f"read and the state written)")
    del got, kd
    qt.destroyQureg(rho)
    torch.cuda.empty_cache()

    # -- the host mirror: copyState*GPU --------------------------------------
    q = sv[torch.float32]
    before = q.amps.clone()
    ms_from = _clock_ms(lambda: qt.copyStateFromGPU(q), 1)
    ms_to = _clock_ms(lambda: qt.copyStateToGPU(q), 1)
    _require(torch.equal(before, q.amps), "operators copyState round trip")
    qs = qt.createQureg(n, env4, 1)
    qt.cloneQureg(qs, q)
    c_sh = N // N_SHARDS
    num = min(1 << 13, c_sh)
    start = c_sh - num // 2
    ms_sub = _clock_ms(lambda: qt.copySubstateFromGPU(qs, start, num), 1)
    _require(np.array_equal(qs.state_vec[:, start:start + num],
                            before[:, start:start + num].cpu().numpy()),
             "operators copySubstateFromGPU across the shard boundary")
    qs.state_vec[:, start:start + num] *= -1
    ms_subto = _clock_ms(lambda: qt.copySubstateToGPU(qs, start, num), 1)
    got = torch.cat(qs.shards, dim=1)
    _require(torch.equal(got[:, start:start + num], -before[:, start:start + num])
             and torch.equal(got[:, :start], before[:, :start])
             and torch.equal(got[:, start + num:], before[:, start + num:]),
             "operators copySubstateToGPU across the shard boundary")
    line(f"copyState float32 {n}q: copyStateFromGPU {ms_from:.2f} ms, copyStateToGPU "
         f"{ms_to:.2f} ms ({2 * N * 4 / 2**20:.0f} MiB each way, round trip exact); over "
         f"{N_SHARDS} shards a substate of {num} amplitudes across the boundary at {c_sh}: "
         f"copySubstateFromGPU {ms_sub:.3f} ms, copySubstateToGPU {ms_subto:.3f} ms")
    del got, before
    for r in (qs, *sv.values()):
        qt.destroyQureg(r)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    line(f"phase: {out['phase_s']:.1f} s")
    return out


def _eager_run(circ, qureg) -> None:
    """The tape on ``qureg`` one entry at a time, eagerly: the route that
    ``Circuit.run`` took before it dispatched through ``compiled()``."""
    for f, a, kw in circ._tape:
        f(qureg, *a, **kw)


def _warm_run(fz, qureg) -> None:
    """The runs of ``fz`` on ``qureg`` that capture, after a plan's first
    (eager) run, the graph of each order of the register's state and spare
    buffers that its runs use, so that the timed runs only replay: one run
    where the state stays in its buffer, two where it alternates with the
    spare (the later phases read these states: no run more than needed)."""
    import torch

    def where():
        return (qureg.amps if qureg.shards is None else qureg.shards[0]).data_ptr()

    before = where()
    fz.run(qureg)
    if where() != before:
        fz.run(qureg)
    torch.cuda.synchronize()


def _release() -> None:
    """Close every cached executable (its graphs, their memory pool, its
    spare buffer) and return the cached memory to the card."""
    import torch

    from quest_tpu_torch.engine import executables

    executables().clear()
    torch.cuda.empty_cache()


#: the serving ansatz of the compiled phase's parameter sweep (bench.py's
#: serve_20q): qubits, layers, value vectors
SWEEP = (20, 4, 8)
#: the compiled phase's distinct circuits run through Circuit.run: qubits,
#: random layers, circuits
MANY = (22, 2, 12)


def _marginal(amps):
    """The compiled phase's terminal readout: the outcome distribution of
    the top 4 qubits."""
    return (amps[0] ** 2 + amps[1] ** 2).reshape(16, -1).sum(1)


def _compiled_phase(qt, dev, plans: dict) -> dict:
    """Phase 11: the compiled routes, each a CUDA-graph replay of the eager
    replay (``quest_tpu_torch._capture``), against the eager replay
    (``as_fn``) in this call (``# compiled`` lines):

    - the main path at N_MAIN qubits, depth DEPTH_MAIN, f32 and f64 (the
      plans of the main-path phases): ``compiled()``,
      ``compiled_segments(24)``, ``compiled_blocks(24)``,
      ``compiled_request()``, ``compiled_request(reduce=_marginal)`` and
      ``Circuit.run``, each bit for bit against the eager replay after
      one, two and three applications and after the timed loop: the first
      call eager (its launches = the runs, no capture), the second and
      third capturing the two buffer orders; then one more replay, traced,
      whose graphs hold as many fused_run kernel nodes as there are runs
      (``_graph_kernels``), which the card's profiler trace shows running
      (``_card_runs``), while the wrapper's launch count stays 0; the ``device_dispatch_total`` of that replay, the calls' seconds, each
      capture's seconds and the device memory it holds; ``amps = fn(amps)``
      with the allocator's count of allocations unchanged and at most two
      state buffers;
    - ``random_layers(20, 8)`` in f32, graph against eager;
    - the density r4 circuit at N_DENSITY qubits and the sharded main path
      over N_SHARDS virtual shards, f32 and f64, through ``compiled()`` and
      ``compiled_request()``: bit for bit; a replay's graph kernels equal
      the eager run's launches, and its fallback, channel-route and
      exchange counts the eager run's;
    - the QFT and the Trotter circuit of the operators phase at N_MAIN
      qubits, f32, through ``compiled()``: within 1e-5 of the largest
      amplitude of the eager run, no item dispatch, a replay's graph
      kernels equal to the eager run's launches;
    - ``serving_ansatz(*SWEEP[:2])`` through ``parameterized()``, f32 and
      f64: SWEEP[2] value vectors, each against the concrete twin run
      eagerly (1e-5 / 1e-12 of the largest amplitude), one capture (at the
      second call) and none after, a structure-equal circuit hitting the
      executable cache; capture seconds, the graph's replay ms and ms per
      request;
    - MANY[2] distinct circuits, each run through ``Circuit.run`` and
      dropped: a run made once captures nothing, a dropped circuit's
      executable leaves the cache, and the card's reserved memory grows by
      less than one state over them.
    """
    import numpy as np
    import torch

    from quest_tpu_torch import fusion, telemetry
    from quest_tpu_torch.ops import fused_gates as FG

    t_phase = time.perf_counter()
    out: dict = {}

    def line(what: str) -> None:
        print(f"# compiled {what}")

    def state(n, dt, seed, shards=1):
        g = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn(2, 1 << n, generator=g, device=dev, dtype=dt)
        x /= x.norm()
        return x if shards == 1 else [c.clone() for c in x.chunk(shards, dim=1)]

    def clone(x):
        return [t.clone() for t in x] if isinstance(x, list) else x.clone()

    def equal(a, b):
        if isinstance(a, list):
            return all(torch.equal(u, v) for u, v in zip(a, b))
        return torch.equal(a, b)

    def reset():
        telemetry.reset()
        FG.fused_run.launches = 0

    def counted():
        torch.cuda.synchronize()
        return {"launches": FG.fused_run.launches,
                "passes": telemetry.counter_value("pallas_pass_total", kind="fused_run"),
                "fallbacks": telemetry.counter_total("engine_fallback_total"),
                "channel_routes": {r: telemetry.counter_value("channel_route_total", route=r)
                                   for r in ("superop", "kernel", "engine")},
                "exchanges": telemetry.counter_total("exchange_calls_total"),
                "dispatches": {r: telemetry.counter_value("device_dispatch_total", route=r)
                               for r in ("circuit", "segment", "item", "request", "block")}}

    def replayed(fn, exe, want):
        """The counts of ``fn()``, a replay of ``exe``'s graphs, with those
        reset before it: the fused_run kernels of the graphs it replayed
        (``graph_kernels``, which must be ``want``) and those the card's
        trace shows (``traced``: some, and no more)."""
        reset()
        ran, res = _card_runs(fn)
        c = counted()
        c["graph_kernels"], c["traced"] = _graph_kernels(exe), ran["fused_run"]
        _require(c["graph_kernels"] == want and 0 < c["traced"] <= want,
                 f"compiled: a replay's graphs hold {c['graph_kernels']} fused_run kernels "
                 f"(runs {want}), the card's trace shows {c['traced']}")
        return c, res

    def passes(fz):
        return sum(f is fusion._apply_pallas_run for f, _, _ in fz._tape)

    def held(fn):
        caps = fn.captures
        return ([round(s, 4) for s, _ in caps], [round(b / 2 ** 20, 1) for _, b in caps])

    def loop(fn, x, reps):
        """``x = fn(x)`` reps times, timed on the card's clock; the
        allocations made and the distinct buffers that held the state."""
        box, ptrs = [x], set()

        def step():
            box[0] = fn(box[0])
            ptrs.add(box[0].data_ptr())

        allocs = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
        ms = _clock_ms(step, reps)
        made = torch.cuda.memory_stats(dev)["allocation.all.allocated"] - allocs
        return box[0], ms, made, len(ptrs)

    # -- the main path, f32 and f64 -----------------------------------------
    reps = 5
    for dt in (torch.float32, torch.float64):
        name = str(dt)[6:]
        fz = plans[("main", dt)]
        kp = passes(fz)
        x0 = state(N_MAIN, dt, 101)
        eager = fz.as_fn()
        refs = [x0]  # refs[k]: the state after k eager applications
        for _ in range(3):
            refs.append(eager(refs[-1].clone()))
        torch.cuda.synchronize()
        ref_loop, eager_ms, _, _ = loop(eager, refs[3].clone(), reps)
        rows = {}
        routes = (("compiled", lambda: fz.compiled()),
                  ("segments_24", lambda: fz.compiled_segments(max_items=24)),
                  ("blocks_24", lambda: fz.compiled_blocks(24)),
                  ("request", lambda: fz.compiled_request()))
        for route, make in routes:
            reset()
            t0 = time.perf_counter()
            fn = make()
            a = fn(x0.clone())
            first = counted()
            first_s = time.perf_counter() - t0
            _require(equal(a, refs[1]) and first["launches"] == kp and not fn.captures,
                     f"compiled {name} {route}: first call (eager) {first['launches']} "
                     f"launches, {len(fn.captures)} captures")
            t0 = time.perf_counter()
            for k in (2, 3):  # each buffer order's capture, then its replay
                a = fn(a)
                _require(equal(a, refs[k]), f"compiled {name} {route}: call {k} != eager")
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            ncaps = len(fn.captures)
            a, ms, made, nbuf = loop(fn, a, reps)
            _require(equal(a, ref_loop), f"compiled {name} {route}: timed loop != eager loop")
            _require(made == 0 and nbuf <= 2 and len(fn.captures) == ncaps,
                     f"compiled {name} {route}: the loop allocated {made} times over {nbuf} "
                     f"buffers, {len(fn.captures) - ncaps} captures")
            c, a = replayed(lambda: fn(a), fn, kp)  # one more replay, traced
            _require(c["passes"] == kp and c["launches"] == 0 and c["fallbacks"] == 0
                     and len(fn.captures) == ncaps,
                     f"compiled {name} {route}: a replay's pallas_pass_total {c['passes']} "
                     f"(runs {kp}), wrapper launches {c['launches']}")
            caps_s, caps_mib = held(fn)
            segs = getattr(fn, "num_segments", getattr(fn, "num_blocks", 1))
            disp = {k: v for k, v in c["dispatches"].items() if v}
            line(f"{name} {route}: {N_MAIN}q depth {DEPTH_MAIN}, {len(fz)} items, "
                 f"{segs} {'blocks' if route.startswith('blocks') else 'segments'}; bit for bit "
                 f"with the eager replay after 1-3 calls and the timed loop; first call eager {first_s:.3f} s, "
                 f"launches {first['launches']} (= runs {kp}); calls 2-3 (captures) "
                 f"{warm_s:.3f} s; a replay: its graph {c['graph_kernels']} fused_run kernels, the "
                 f"card's trace {c['traced']}, wrapper launches {c['launches']}, pallas_pass_total "
                 f"{c['passes']:g}, device_dispatch_total {disp}; captures {caps_s} s holding "
                 f"{caps_mib} MiB; graph {ms:.4f} ms per circuit against eager {eager_ms:.4f} "
                 f"ms ({eager_ms / ms:.3f}x); amps = fn(amps) x {reps}: {made} allocations, "
                 f"{nbuf} state buffers")
            rows[route] = {"launches": first["launches"], "graph_kernels": c["graph_kernels"],
                           "traced": c["traced"],
                           "dispatches": disp, "segments": segs, "first_call_s": first_s,
                           "capture_calls_s": warm_s, "capture_s": caps_s,
                           "capture_mib": caps_mib, "ms": ms, "eager_ms": eager_ms,
                           "loop_allocations": made, "loop_buffers": nbuf}
            del fn, a
            _release()
        # the request with its readout (no donation: the input stays)
        reset()
        fn = fz.compiled_request(donate=False, reduce=_marginal)
        want = _marginal(refs[1])
        got = fn(x0)
        first = counted()
        _require(torch.equal(got, want) and first["launches"] == kp,
                 f"compiled {name} request+reduce: readout")
        _require(torch.equal(fn(x0), want), f"compiled {name} request+reduce: capture")
        c, got = replayed(lambda: fn(x0), fn, kp)
        _require(torch.equal(got, want) and c["launches"] == 0
                 and c["dispatches"]["request"] == 1, f"compiled {name} request+reduce: {c}")
        ms = _clock_ms(lambda: fn(x0), reps)
        line(f"{name} request+reduce: the top-4-qubit distribution, bit for bit; first call "
             f"launches {first['launches']}; a replay: its graph {c['graph_kernels']} kernels, "
             f"the card's trace {c['traced']}, "
             f"device_dispatch_total{{request}} {c['dispatches']['request']:g}; {ms:.4f} ms "
             f"per request (input copied in, no donation); captures {held(fn)[0]} s")
        rows["request_reduce"] = {"launches": first["launches"],
                                  "graph_kernels": c["graph_kernels"], "traced": c["traced"],
                                  "ms": ms}
        del fn
        _release()
        # Circuit.run on a register's own buffers
        env = qt.createQuESTEnv(device=dev)
        q = qt.createQureg(N_MAIN, env, 1 if dt == torch.float32 else 2)
        q.amps.copy_(x0)
        reset()
        fz.run(q)
        first = counted()
        _require(torch.equal(q.amps, refs[1]) and first["launches"] == kp
                 and not fz.compiled().captures, f"compiled {name} run: first call")
        for k in (2, 3):
            fz.run(q)
            _require(torch.equal(q.amps, refs[k]), f"compiled {name} run: call {k}")
        ptrs = set()
        allocs = torch.cuda.memory_stats(dev)["allocation.all.allocated"]

        def run_once():
            fz.run(q)
            ptrs.add(q.amps.data_ptr())

        ms = _clock_ms(run_once, reps)
        made = torch.cuda.memory_stats(dev)["allocation.all.allocated"] - allocs
        _require(torch.equal(q.amps, ref_loop) and made == 0 and len(ptrs) <= 2,
                 f"compiled {name} run: loop ({made} allocations)")
        c, _ = replayed(lambda: fz.run(q), fz.compiled(), kp)  # one more replay, traced
        _require(c["launches"] == 0
                 and c["dispatches"]["circuit"] == 1, f"compiled {name} run: replay {c}")
        line(f"{name} Circuit.run: bit for bit; first run eager, launches {first['launches']}, "
             f"no capture; a replay: its graph {c['graph_kernels']} kernels, the card's trace "
             f"{c['traced']}, "
             f"device_dispatch_total{{circuit}} {c['dispatches']['circuit']:g}; {ms:.4f} ms "
             f"per circuit against eager {eager_ms:.4f} ms; {made} allocations over "
             f"{reps} runs, {len(ptrs)} state buffers (the register's amps and spare)")
        rows["run"] = {"launches": first["launches"], "graph_kernels": c["graph_kernels"],
                       "traced": c["traced"], "ms": ms,
                       "eager_ms": eager_ms, "loop_allocations": made}
        qt.destroyQureg(q)
        del x0, refs, ref_loop
        _release()
        out[("main", dt)] = {"rows": rows, "passes": kp, "eager_ms": eager_ms}

    # -- 20 qubits: host dispatch against device time ------------------------
    c20 = qt.Circuit(20)
    qt.random_layers(c20, 20, DEPTH_MAIN)
    fz20 = c20.fused(max_qubits=5, pallas=True, dtype=torch.float32)
    p20 = passes(fz20)
    x0 = state(20, torch.float32, 103)
    eager = fz20.as_fn()
    fn = fz20.compiled()
    reset()
    a = fn(x0.clone())
    first = counted()
    _require(torch.equal(a, eager(x0.clone())) and first["launches"] == p20,
             "compiled 20q: first call")
    a = fn(fn(a))
    c, a = replayed(lambda: fn(a), fn, p20)
    _require(c["launches"] == 0, f"compiled 20q: a replay {c}")
    reps20 = 100  # ~0.5-1 ms a circuit: enough reps to steady the host's share
    _, eager20, _, _ = loop(eager, x0.clone(), reps20)
    _, graph20, made, _ = loop(fn, a, reps20)
    line(f"20q: random_layers(20, {DEPTH_MAIN}) f32, {len(fz20)} items, {p20} runs "
         f"(a replay's graph {c['graph_kernels']}, the card's trace {c['traced']}): graph {graph20:.4f} ms per circuit "
         f"against eager {eager20:.4f} ms ({eager20 / graph20:.2f}x); {made} allocations in "
         f"the graph loop")
    out["20q"] = {"ms": graph20, "eager_ms": eager20, "passes": p20,
                  "launches": first["launches"], "graph_kernels": c["graph_kernels"],
                  "traced": c["traced"]}
    del fn, a, x0
    _release()

    # -- density r4 and the sharded main path: counts against eager ---------
    for dt in (torch.float32, torch.float64):
        name = str(dt)[6:]
        for kind in ("density", "sharded"):
            fz = plans[(kind, dt)]
            if kind == "density":
                x0 = state(2 * N_DENSITY, dt, 105)
            else:
                x0 = state(N_MAIN, dt, 107, shards=N_SHARDS)
            reset()
            ref = fz.as_fn()(clone(x0))
            want = counted()
            for route, make in (("compiled", fz.compiled), ("request", fz.compiled_request)):
                fn = make(donate=False)  # the input stays: one graph for every call
                reset()
                a = fn(x0)
                first = counted()
                _require(equal(a, ref) and first["launches"] == want["launches"],
                         f"compiled {name} {kind} {route}: first call")
                _require(equal(fn(x0), ref), f"compiled {name} {kind} {route}: capture")
                c, a = replayed(lambda: fn(x0), fn, want["launches"])
                _require(equal(a, ref), f"compiled {name} {kind} {route}: replay")
                same = {k: c[k] == want[k] for k in ("fallbacks", "channel_routes",
                                                      "exchanges")}
                same["kernels"] = c["launches"] == 0
                _require(all(same.values()), f"compiled {name} {kind} {route}: counts {c} "
                                             f"against eager {want}")
                ms = _clock_ms(lambda: fn(x0), 3)
                line(f"{name} {kind} {route}: bit for bit with the eager replay; a replay ran "
                     f"its graph's {c['graph_kernels']} fused_run kernels (the card's trace "
                     f"{c['traced']}; the eager run launched "
                     f"{want['launches']}), engine_fallback_total {c['fallbacks']:g}, "
                     f"channel_route_total {c['channel_routes']}, exchange_calls_total "
                     f"{c['exchanges']:g} (all as the eager run's); {ms:.4f} ms per call "
                     f"(the input copied in and the result out); captures {held(fn)[0]} s holding "
                     f"{held(fn)[1]} MiB")
                out[(kind, route, dt)] = {"launches": first["launches"],
                                          "graph_kernels": c["graph_kernels"],
                                          "traced": c["traced"], "ms": ms,
                                          "exchanges": c["exchanges"]}
                del fn, a
                _release()
            del x0, ref

    # -- QFT and Trotter, f32: engine entries in the graph ------------------
    for kind in ("qft", "trotter"):
        fz = plans[(kind, torch.float32)]
        x0 = state(N_MAIN, torch.float32, 109)
        reset()
        ref = fz.as_fn()(x0.clone())
        want = counted()
        fn = fz.compiled(donate=False)
        fn(x0)
        fn(x0)
        c, a = replayed(lambda: fn(x0), fn, want["launches"])
        err = float((a - ref).abs().max() / ref.abs().max())
        _require(err <= 1e-5, f"compiled {kind}: {err} of the largest amplitude > 1e-5")
        _require(c["dispatches"]["item"] == 0 and c["fallbacks"] == 0,
                 f"compiled {kind}: item dispatches {c['dispatches']['item']}")
        _require(c["launches"] == 0, f"compiled {kind}: a replay moved the launch count")
        line(f"float32 {kind}: {len(fz)} items, a replay ran its graph's {c['graph_kernels']} "
             f"fused_run kernels (the card's trace {c['traced']}; the eager run launched {want['launches']}), item dispatches "
             f"{c['dispatches']['item']:g}; against the eager run {err:.3e} of the largest "
             f"amplitude (limit 1e-5); captures {held(fn)[0]} s holding {held(fn)[1]} MiB")
        out[kind] = {"launches": want["launches"], "graph_kernels": c["graph_kernels"],
                     "traced": c["traced"],
                     "max_rel_err": err}
        del fn, a, ref, x0
        _release()

    # -- the parameter sweep -------------------------------------------------
    n, depth, nvec = SWEEP
    for dt, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        name = str(dt)[6:]
        env = qt.createQuESTEnv(device=dev)
        prec = 1 if dt == torch.float32 else 2
        amps0 = qt.createQureg(n, env, prec).amps
        circ = qt.serving_ansatz(n, depth)
        names = circ.param_names
        rng = np.random.RandomState(113)
        vecs = [dict(zip(names, rng.uniform(0, 2 * np.pi, len(names)))) for _ in range(nvec)]
        reset()
        exe = circ.parameterized(donate=False)
        walls, errs = [], []
        for i, v in enumerate(vecs):
            t0 = time.perf_counter()
            got = exe(amps0, v)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if i == 1:
                traces = telemetry.counter_value("engine_trace_total", kind="param_replay")
            want = qt.serving_ansatz(n, depth, v).as_fn()(amps0.clone())
            errs.append(float((got - want).abs().max() / want.abs().max()))
        _require(max(errs) <= tol, f"compiled {name} sweep: {max(errs)} > {tol}")
        _require(traces == 2 and len(exe.captures) == 1,
                 f"compiled {name} sweep: {traces:g} builds after two calls (the warm-up run "
                 f"and one capture expected), {len(exe.captures)} captures")
        moved = telemetry.counter_value("engine_trace_total", kind="param_replay") - traces
        _require(moved == 0, f"compiled {name} sweep: {moved} captures after the second call")
        h0 = telemetry.counter_value("plan_cache_hit_total", cache="executable")
        twin_exe = qt.serving_ansatz(n, depth).parameterized(donate=False)
        hits = telemetry.counter_value("plan_cache_hit_total", cache="executable") - h0
        _require(hits == 1 and twin_exe._fn is exe._fn,
                 f"compiled {name} sweep: a structure-equal circuit missed the cache")
        _require(torch.equal(twin_exe(amps0, vecs[0]), exe(amps0, vecs[0])),
                 f"compiled {name} sweep: the shared executable")
        _require(telemetry.counter_value("engine_trace_total", kind="param_replay") == traces,
                 f"compiled {name} sweep: the shared executable captured again")
        graph = next(iter(exe._fn._exe.program.pieces[0].graphs.values())).graph
        replay_ms = _cuda_ms(graph.replay, 5)
        request_ms = _clock_ms(lambda: exe(amps0, vecs[1]), 5)
        line(f"{name} sweep: serving_ansatz({n}, {depth}), {len(names)} Params, {len(circ)} "
             f"entries; {nvec} value vectors against the concrete twin run eagerly: largest "
             f"{max(errs):.3e} of the largest amplitude (limit {tol:g}); "
             f"engine_trace_total{{param_replay}} {traces:g} after two calls (the first "
             f"call's eager build, the second's capture), moved {moved:g} after; a "
             f"structure-equal circuit: plan_cache_hit_total +{hits:g}, the same executable; "
             f"captures {held(exe)[0]} s holding {held(exe)[1]} MiB; first call "
             f"{walls[0]:.3f} s, second (capture) {walls[1]:.3f} s, then "
             f"{np.mean(walls[2:]) * 1e3:.3f} ms a request on the host's clock; graph replay "
             f"{replay_ms:.4f} ms, request {request_ms:.4f} ms on the card's clock")
        out[("sweep", dt)] = {"params": len(names), "max_rel_err": max(errs),
                              "first_call_s": walls[0], "capture_call_s": walls[1],
                              "request_ms": request_ms, "replay_ms": replay_ms,
                              "captures": held(exe)}
        del exe, twin_exe, amps0
        _release()

    # -- many distinct circuits through Circuit.run: memory held ------------
    from quest_tpu_torch.engine import executables

    env = qt.createQuESTEnv(device=dev)
    q = qt.createQureg(MANY[0], env, 1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = []
    for i in range(MANY[2]):
        c = qt.Circuit(MANY[0])
        qt.random_layers(c, MANY[0], MANY[1], seed=1000 + i)  # per-gate engine entries
        qt.initZeroState(q)
        c.run(q)
        if i == 0:
            _require(not c.compiled().captures, "compiled: a run made once captured")
        c.run(q)
        c.run(q)
        _require(len(executables()) == 1 and c.compiled().captures,
                 f"compiled: circuit {i} holds {len(executables())} executables")
        del c  # its executables leave the cache with it
        _require(len(executables()) == 0, f"compiled: circuit {i} left its executable")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved.append(torch.cuda.memory_reserved(dev))
    grew = max(reserved) - reserved[0]
    state_bytes = q.amps.numel() * q.amps.element_size()
    _require(grew <= state_bytes, f"compiled: reserved memory grew {grew} bytes over "
                                  f"{MANY[2]} distinct circuits")
    line(f"many circuits: {MANY[2]} distinct random_layers({MANY[0]}, {MANY[1]}) tapes "
         f"(per-gate engine entries), each run three times through Circuit.run (eager, "
         f"then the captures of both buffer orders) and dropped: memory_reserved "
         f"{reserved[0] / 2 ** 20:.1f} .. {max(reserved) / 2 ** 20:.1f} MiB (grew "
         f"{grew / 2 ** 20:.1f} MiB, limit one state, {state_bytes / 2 ** 20:.1f} MiB); a "
         f"run made once captured nothing")
    out["many"] = {"reserved_mib": [r / 2 ** 20 for r in reserved]}
    qt.destroyQureg(q)
    _release()
    out["phase_s"] = time.perf_counter() - t_phase
    line(f"phase: {out['phase_s']:.1f} s")
    return out


#: the serving phase's configurations: (name, qubits, layers, fused, max_batch)
SERVING = (("serve_20q", 20, 4, False, 8), ("serve_20q_fused", 20, 4, True, 8),
           ("serve_26q_fused", 26, 4, True, 4))
#: lanes of the kernel-alone measurement
LANES = 4


def _lanes_alone(dev, plans: dict) -> dict:
    """The fused-run kernel's lane axis alone (``# serving lanes`` lines):
    for f32 and f64, the main path's densest run at N_MAIN qubits over
    LANES random lanes in ONE launch, against LANES one-lane launches of the
    same table (bit for bit), timed on the card's clock beside the LANES
    one-lane launches, the plain version on the same batch (against which
    it is held, 1e-5 / 1e-12 of the largest amplitude) and its bound (LANES
    times one lane's bytes at HBM_BYTES_PER_S, and its operations)."""
    import torch

    from quest_tpu_torch import fusion
    from quest_tpu_torch.ops import fused_gates as FG

    out = {}
    for dt in (torch.float32, torch.float64):
        name = str(dt)[6:]
        runs = [a[0] for f, a, _ in plans[dt]._tape if f is fusion._apply_pallas_run]
        run = max(runs, key=lambda r: len(r.prepare().records))
        prep = run.prepare()
        kw = dict(n=N_MAIN, ops=run.ops, tile_bits=run.tile_bits,
                  load_swap_k=run.load_swap_k, store_swap_k=run.store_swap_k,
                  load_swap_hi=run.load_swap_hi, store_swap_hi=run.store_swap_hi,
                  prepared=prep)
        g = torch.Generator(device=dev).manual_seed(19)
        x = torch.randn(LANES, 2, 1 << N_MAIN, generator=g, device=dev, dtype=dt)
        x /= x.flatten(1).norm(dim=1)[:, None, None]
        batch, single = torch.empty_like(x), torch.empty_like(x)
        FG.fused_run.launches = 0
        FG.fused_run(x, out=batch, **kw)
        torch.cuda.synchronize()
        _require(FG.fused_run.launches == 1, f"serving lanes {name}: "
                 f"{FG.fused_run.launches} launches for {LANES} lanes")

        def one_lane_launches():
            for i in range(LANES):
                FG.fused_run(x[i], out=single[i], **kw)

        one_lane_launches()
        torch.cuda.synchronize()
        same = all(torch.equal(batch[i], single[i]) for i in range(LANES))
        _require(same, f"serving lanes {name}: a lane of the batched launch differs "
                       "from its one-lane launch")
        ms = _cuda_ms(lambda: FG.fused_run(x, out=batch, **kw), 5)
        singles_ms = _cuda_ms(one_lane_launches, 5)
        plain_kw = {k: v for k, v in kw.items() if k not in ("ops", "prepared")}
        box = []
        plain_ms = _clock_ms(lambda: box.append(FG.fused_run_plain(x, prep, **plain_kw)), 1)
        err, rel = _rel_err(batch, box.pop())
        tol = 1e-5 if dt == torch.float32 else 1e-12
        _require(rel <= tol, f"serving lanes {name}: the batched launch is {rel} of the "
                             f"largest amplitude from the plain version (limit {tol:g})")
        work = _pass_work(prep, N_MAIN, x.element_size())
        by_bytes, by_ops = (LANES * b for b in _bound_ms(work, dt == torch.float32))
        bound = max(by_bytes, by_ops)
        print(f"# serving lanes {name}: the main path's densest run ({len(prep.records)} "
              f"records, folded swaps load {run.load_swap_k} store {run.store_swap_k}) over "
              f"{LANES} lanes of {N_MAIN} qubits in 1 launch: {ms:.4f} ms, {LANES} one-lane "
              f"launches {singles_ms:.4f} ms, the plain version {plain_ms:.2f} ms (error "
              f"{err:.3e}, {rel:.3e} of the largest); bound {bound:.4f} ms ({LANES} x one "
              f"lane's bytes {by_bytes:.4f} ms, operations {by_ops:.4f} ms), "
              f"{bound / ms:.1%} of it; lanes equal one-lane launches bit for bit")
        out[dt] = {"lanes": LANES, "qubits": N_MAIN, "records": len(prep.records),
                   "launches": 1, "ms": ms, "one_lane_launches_ms": singles_ms,
                   "plain_ms": plain_ms, "max_abs_err": err,
                   "bound_ms": bound, "bound_by": "operations" if by_ops > by_bytes else "bytes",
                   "bit_identical_to_one_lane": same}
    return out


#: the stream of single submits: a small circuit, whose batch is short
#: enough for the host's work around it (values, copies, futures) to
#: matter: (qubits, layers, max_batch, max_delay_ms, requests)
SINGLE_STREAM = (12, 4, 8, 1.0, 96)


def _single_submits(qt, dev) -> dict:
    """Requests arriving one at a time (``# serving single`` lines):
    ``serving_ansatz(12, 4)``, raw and fused, f32, ``max_batch`` 8,
    ``max_delay_ms`` 1, 96 requests submitted one at a time from one
    thread, back to back and then paced at 80% of the back-to-back rate,
    two runs of each: requests/s from the first submit to the last
    completion, p50 / p99 latency, the mean batch; every run serves the
    same bits. Beside them the card's ms of one batch (CUDA events, its
    graph replayed back to back: the copies in and out excluded) and the
    engine's wall ms a batch (``submit_many`` of 8, then the wait)."""
    import numpy as np
    import torch

    from quest_tpu_torch import telemetry
    from quest_tpu_torch.engine import Engine

    n, depth, B, delay, count = SINGLE_STREAM
    wait = 120
    out: dict = {}
    env = qt.createQuESTEnv(device=dev)
    for fused in (False, True):
        name = "fused" if fused else "raw"
        circ = qt.serving_ansatz(n, depth)
        if fused:
            circ = circ.fused(max_qubits=5, pallas=True, dtype=torch.float32)
        rng = np.random.RandomState(1912)
        reqs = [dict(zip(circ.param_names, rng.uniform(0, 2 * np.pi, len(circ.param_names))))
                for _ in range(count)]
        eng = Engine(circ, env, precision_code=1, max_batch=B, max_delay_ms=delay)
        eng.warmup(reqs[0], wait)

        def stream(gap):
            b0 = telemetry.counter_value("engine_batches_total", mode="vmap")
            done_at: dict = {}
            futs, subs = [], []
            t_start = time.perf_counter()
            for i, p in enumerate(reqs):
                if gap:
                    while time.perf_counter() < t_start + i * gap:
                        time.sleep(gap / 8)
                subs.append(time.perf_counter())
                f = eng.submit(p)
                f.add_done_callback(
                    lambda _f, _k=i: done_at.setdefault(_k, time.perf_counter()))
                futs.append(f)
            res = [f.result(wait).cpu() for f in futs]
            batches = telemetry.counter_value("engine_batches_total", mode="vmap") - b0
            lats = [(done_at[k] - subs[k]) * 1e3 for k in range(count)]
            return {"req_s": count / (max(done_at.values()) - subs[0]),
                    "p50_ms": float(np.percentile(lats, 50)),
                    "p99_ms": float(np.percentile(lats, 99)),
                    "mean_batch": count / batches}, res

        ref = None
        gap = 0.0
        for pattern in ("back to back", "paced"):
            runs = []
            for _ in range(2):
                row, res = stream(gap)
                if ref is None:
                    ref = res
                _require(all(torch.equal(a, b) for a, b in zip(res, ref)),
                         f"serving single {name}: a run served other bits")
                runs.append(row)
            m = {k: sum(r[k] for r in runs) / len(runs) for k in runs[0]}
            out[(name, pattern)] = {"gap_ms": gap * 1e3, **m,
                                    "runs_req_s": [r["req_s"] for r in runs]}
            print(f"# serving single {name} {pattern}: serving_ansatz({n}, {depth}) f32, "
                  f"max_batch {B}, max_delay_ms {delay:g}, {count} requests one at a time"
                  + (f" every {gap * 1e3:.3f} ms" if gap else "") +
                  f": {m['req_s']:.1f} requests/s (runs "
                  f"{', '.join(f'{x:.1f}' for x in out[(name, pattern)]['runs_req_s'])}), "
                  f"p50 / p99 {m['p50_ms']:.3f} / {m['p99_ms']:.3f} ms, mean batch "
                  f"{m['mean_batch']:.2f} (the same bits)")
            gap = 1.25 / m["req_s"]
        # the card's time of one batch against the engine's wall time a
        # batch (back to back, full batches)
        graphs = eng._execB().program.pieces[0].graphs
        _require(len(graphs) == 1, f"serving single {name}: {len(graphs)} batch graphs")
        card_ms = _cuda_ms(next(iter(graphs.values())).graph.replay, 20)
        t0 = time.perf_counter()
        for i in range(0, count, B):
            for f in eng.submit_many(reqs[i:i + B]):
                f.result(wait)
        wall_ms = (time.perf_counter() - t0) * 1e3 / (count // B)
        eng.close(timeout=wait)
        out[(name, "batch")] = {"card_ms": card_ms, "wall_ms": wall_ms}
        print(f"# serving single {name} batch: the card {card_ms:.3f} ms a batch of {B} "
              f"(its graph replayed back to back), the engine {wall_ms:.3f} ms a batch "
              f"wall (submit_many of {B}, then the wait), host share "
              f"{1 - card_ms / wall_ms:.1%}")
        del eng
        _release()
    return out


def _serving_phase(qt, dev) -> dict:
    """Phase 12: the serving Engine on the card (see the module docstring,
    item 12), each configuration of SERVING in f32 and f64, its counts
    reset just before its first (eager) batch and read just after."""
    import numpy as np
    import torch

    from quest_tpu_torch import fusion, telemetry
    from quest_tpu_torch.engine import Engine
    from quest_tpu_torch.ops import fused_gates as FG
    from quest_tpu_torch.resilience import sentinel_policy

    t_phase = time.perf_counter()
    out: dict = {}
    wait = 600
    for cfg, n, depth, fused, B in SERVING:
        for dt, tol, ptol in ((torch.float32, 1e-5, 1e-4), (torch.float64, 1e-12, 1e-9)):
            name = f"{cfg} {str(dt)[6:]}"
            prec = 1 if dt == torch.float32 else 2
            env = qt.createQuESTEnv(device=dev)
            circ = qt.serving_ansatz(n, depth)
            if fused:
                circ = circ.fused(max_qubits=5, pallas=True, dtype=dt)
            runs = sum(f is fusion._apply_pallas_run for f, _, _ in circ._tape)
            names = circ.param_names
            rng = np.random.RandomState(1900 + n)
            draw = [dict(zip(names, rng.uniform(0, 2 * np.pi, len(names))))
                    for _ in range(2 * B + 16)]
            sweep, stream = draw[:B], draw[B:B + 16]
            eng = Engine(circ, env, precision_code=prec, max_batch=B, max_delay_ms=0.0)
            # cold: the first call (eager: it loads the kernels and stages the
            # tables), counted; then the second, which captures the graph
            telemetry.reset()
            FG.fused_run.launches = 0
            t0 = time.perf_counter()
            eng.run(draw[-1], wait)
            cold_s = time.perf_counter() - t0
            launches = FG.fused_run.launches
            _require(launches == runs, f"serving {name}: the eager batch launched the "
                     f"kernel {launches} times for {runs} runs of {B} lanes")
            t0 = time.perf_counter()
            eng.warmup(draw[-1], wait)
            capture_s = time.perf_counter() - t0
            batch_fn = eng._execB()
            traces = telemetry.counter_value("engine_trace_total", kind="param_replay")
            _require(traces == 2 and len(batch_fn.captures) == 1,
                     f"serving {name}: {traces:g} builds and {len(batch_fn.captures)} "
                     "captures after the warm-up (the eager run and one capture expected)")
            graph_kernels = _graph_kernels(batch_fn)
            _require(graph_kernels == runs, f"serving {name}: the batch graph holds "
                     f"{graph_kernels} fused_run nodes for {runs} runs")
            # requests/s: the batch (best of `reps`) against the same requests
            # uncoalesced; the two must agree bit for bit
            reps = 3 if n < N_MAIN else 1
            batch_s = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                batched = [f.result(wait) for f in eng.submit_many(sweep)]
                batch_s = min(batch_s, time.perf_counter() - t0)
            t0 = time.perf_counter()
            looped = [eng.run(p, wait) for p in sweep]
            loop_s = time.perf_counter() - t0
            same = all(torch.equal(a, b) for a, b in zip(batched, looped))
            _require(same, f"serving {name}: a coalesced lane differs from its request "
                           "served alone")
            del looped
            # one batch more with the sentinels armed: no breach, the same bits
            with sentinel_policy("default"):
                guarded = [f.result(wait) for f in eng.submit_many(sweep)]
            breaches = sum(telemetry.counter_value("sentinel_checks_total", kind=k,
                                                   outcome="breach")
                           for k in ("norm", "checksum"))
            checks = sum(telemetry.counter_value("sentinel_checks_total", kind=k,
                                                 outcome="ok") for k in ("norm", "checksum"))
            _require(breaches == 0 and checks == 2 * B and all(
                torch.equal(a, b) for a, b in zip(guarded, batched)),
                f"serving {name}: {breaches:g} sentinel breaches, {checks:g} clean checks")
            del guarded
            moved = telemetry.counter_value("engine_trace_total", kind="param_replay") - traces
            _require(moved == 0 and len(batch_fn.captures) == 1,
                     f"serving {name}: {moved:g} builds after the warm-up")
            # the reference: the unbatched parameterized replay (an executable
            # of its own, which builds twice: eager, then its capture), the
            # route a user would take without the Engine: warmed, then the
            # sweep through it timed (best of `reps`) beside the batch
            amps0 = qt.createQureg(n, env, prec).amps
            exe = circ.parameterized(donate=False)
            for _ in range(2):
                exe(amps0, sweep[0])
            replay_s = float("inf")
            for _ in range(reps):
                wants = None
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                wants = [exe(amps0, p) for p in sweep]
                torch.cuda.synchronize(dev)
                replay_s = min(replay_s, time.perf_counter() - t0)
            errs, probs = [], []
            for want, lane in zip(wants, batched):
                errs.append(float((lane - want).abs().max() / want.abs().max()))
                probs.append(abs(float((lane.double() ** 2).sum()) - 1.0))
            del exe, wants, want, batched, amps0
            _require(max(errs) <= tol, f"serving {name}: a lane is {max(errs)} of the "
                     f"largest amplitude from the unbatched replay (limit {tol:g})")
            _require(max(probs) <= ptol, f"serving {name}: total probability off by "
                     f"{max(probs)} (limit {ptol:g})")
            row = {"qubits": n, "layers": depth, "fused": fused, "max_batch": B,
                   "runs": runs, "launches": launches, "graph_kernels": graph_kernels,
                   "cold_s": cold_s, "capture_s": capture_s,
                   "captures": [round(c[0], 4) for c in batch_fn.captures],
                   "capture_mib": [round(c[1] / 2 ** 20, 1) for c in batch_fn.captures],
                   "max_rel_err": max(errs), "max_prob_err": max(probs),
                   "batch_ms": batch_s * 1e3, "batch_req_s": B / batch_s,
                   "loop_req_s": B / loop_s, "batch_speedup": loop_s / batch_s,
                   "replay_req_s": B / replay_s, "vs_replay": replay_s / batch_s,
                   "sentinel_checks": checks}
            lat = ""
            if n < N_MAIN:
                # p50 / p99 latency of a 16-request stream, sent in batches
                # of max_batch through the warm engine
                done_at: dict = {}
                futs, subs = [], []
                for i in range(0, len(stream), B):
                    fs = eng.submit_many(stream[i:i + B])
                    t_sub = time.perf_counter()
                    for f in fs:
                        k = len(futs)
                        futs.append(f)
                        subs.append(t_sub)
                        f.add_done_callback(
                            lambda _f, _k=k: done_at.setdefault(_k, time.perf_counter()))
                for f in futs:
                    f.result(wait)
                lats = [(done_at[k] - subs[k]) * 1e3 for k in range(len(futs))]
                row["p50_ms"] = float(np.percentile(lats, 50))
                row["p99_ms"] = float(np.percentile(lats, 99))
                del futs
                lat = (f"; 16-request stream p50 / p99 {row['p50_ms']:.2f} / "
                       f"{row['p99_ms']:.2f} ms")
            eng.close(timeout=wait)
            del eng, batch_fn
            _release()
            kern = ""
            if fused:
                # where the batch's time goes: its runs' lane-batched launches
                # alone, on B random lanes (the rest is the Param barriers on
                # the per-gate engine and the batch's copies)
                g = torch.Generator(device=dev).manual_seed(n)
                xb = torch.randn(B, 2, 1 << n, generator=g, device=dev, dtype=dt)
                ob = torch.empty_like(xb)
                plan = [a[0] for f, a, _ in circ._tape if f is fusion._apply_pallas_run]

                def all_runs():
                    for r in plan:
                        FG.fused_run(xb, n=n, ops=r.ops, tile_bits=r.tile_bits,
                                     load_swap_k=r.load_swap_k, store_swap_k=r.store_swap_k,
                                     load_swap_hi=r.load_swap_hi,
                                     store_swap_hi=r.store_swap_hi, prepared=r.prepare(),
                                     out=ob)

                row["kernel_ms"] = _cuda_ms(all_runs, 3)
                row["kernel_share"] = row["kernel_ms"] / row["batch_ms"]
                del xb, ob
                torch.cuda.empty_cache()
                kern = (f"; its {runs} runs' lane-batched launches alone "
                        f"{row['kernel_ms']:.3f} ms, {row['kernel_share']:.1%} of the batch")
            print(f"# serving {name}: serving_ansatz({n}, {depth}){' fused' if fused else ''}"
                  f", {len(names)} Params, {runs} fused runs, max_batch {B}: the eager batch "
                  f"launched the kernel {launches} times (runs {runs}), the graph holds "
                  f"{graph_kernels} fused_run nodes; batch = loop bit for bit; lanes within "
                  f"{max(errs):.3e} of the unbatched replay (limit {tol:g}), total "
                  f"probability within {max(probs):.3e}; {checks:g} sentinel checks, no "
                  f"breach; cold {cold_s:.3f} s, capture {capture_s:.3f} s "
                  f"({row['capture_mib']} MiB); a batch {row['batch_ms']:.2f} ms, "
                  f"{row['batch_req_s']:.2f} requests/s coalesced against "
                  f"{row['loop_req_s']:.2f} uncoalesced (x{row['batch_speedup']:.2f}) and "
                  f"{row['replay_req_s']:.2f} through the unbatched parameterized() replay "
                  f"(the Engine x{row['vs_replay']:.2f})"
                  f"{kern}{lat}")
            out[(cfg, dt)] = row
    out["single"] = _single_submits(qt, dev)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"# serving phase: {out['phase_s']:.1f} s")
    return out


#: phase 13's sampling requests: the 10-qubit subset of the 26-qubit main
#: path's state, the shot counts and the seed; the 20-qubit circuit whose
#: mid-circuit measurement every shot must carry (qubits, layers, measured
#: qubit)
SAMPLE_SUBSET = (25, 3, 17, 9, 0, 12, 21, 6, 14, 1)
SAMPLE_SHOTS = (1024, 1 << 20)
SAMPLE_SEED = 2026
MID_MEASURE = (20, 4, 7)
#: phase 13's gradients: the serving ansatz (qubits, layers), its full
#: width (26 qubits, depth cut to 2 for the phase's time), the depth of the
#: parameter-shift check, and the Engine's lanes
GRAD_ANSATZ, GRAD_FULL, SHIFT_DEPTH, GRAD_LANES = (20, 4), (26, 2), 1, 8


def _state_only(amps, seed):
    """The terminal stage of the request the shot stage is timed against:
    nothing read out (the state stays on the card)."""
    return None


def _shot_stage_bytes(n: int, t: int, shots: int, isz: int) -> int:
    """The bytes the shot stage of a request moves: the marginal's read of
    the state (two planes of ``isz`` bytes) and its float32 write; each add
    step of the two log-step scans (two reads and a write of the float32
    table); the running maxima (a read and a write); a uniform, an outcome
    and the binary searches' gathers a shot."""
    bb = t // 2
    steps = (t - bb) * (1 << t) + bb * (1 << bb)
    return (2 * isz * (1 << n) + 4 * (1 << t) + 12 * steps + 8 * ((1 << t) + (1 << bb))
            + shots * (8 + 4 * t))


def _sampling_phase(qt, dev, plans: dict) -> dict:
    """Phase 13, sampling (``# sampling`` lines; see the module docstring,
    item 13): requests on the main path's fused plans, f32 and f64, a
    mid-circuit measurement, and the Engine with a shot-table finalize."""
    import numpy as np
    import torch
    from scipy.stats import chi2 as chi2_dist

    from quest_tpu_torch import fusion, telemetry
    from quest_tpu_torch.engine import Engine, P
    from quest_tpu_torch.ops import fused_gates as FG
    from quest_tpu_torch.ops import measure as M
    from quest_tpu_torch.ops import reduce as R
    from quest_tpu_torch.sampling import rng, sampler as sp
    from quest_tpu_torch.sampling.request import sample_reduce, sample_request

    card = _card_line()
    out: dict = {}
    env = qt.createQuESTEnv(device=dev)
    seed_t = torch.tensor(SAMPLE_SEED, dtype=torch.int64, device=dev)
    for dt in (torch.float32, torch.float64):
        name, prec = str(dt)[6:], (1 if dt == torch.float32 else 2)
        fz = plans[("main", dt)]
        runs = sum(f is fusion._apply_pallas_run for f, _, _ in fz._tape)
        zero = qt.createQureg(N_MAIN, env, prec).amps
        base = fz.compiled_request(donate=False, reduce=_state_only)
        # the card's own final state: the same runs, no shot stage
        state = fz.compiled_request(donate=False)(zero)
        norm = R.total_prob_statevec(state).to(torch.float32)
        for targets in (tuple(range(N_MAIN)), SAMPLE_SUBSET):
            t = len(targets)
            p = sp.marginal_probs(state, n=N_MAIN, targets=targets)
            p_cpu = p.cpu()
            for shots in SAMPLE_SHOTS:
                exe = sample_request(fz, targets=targets, shots=shots, donate=False)
                # the first (eager) call, counted: one kernel launch a run
                telemetry.reset()
                FG.fused_run.launches = 0
                got = exe(zero, seed_t)["shots"]
                torch.cuda.synchronize(dev)
                launches = FG.fused_run.launches
                dispatches = telemetry.counter_value("device_dispatch_total", route="request")
                _require(launches == runs and dispatches == 1,
                         f"sampling {name} {t}q {shots}: the eager request launched the kernel "
                         f"{launches} times for {runs} runs, in {dispatches:g} dispatches")
                again = exe(zero, seed_t)["shots"]  # captures the request's graph
                graph_kernels = _graph_kernels(exe)
                _require(graph_kernels == runs, f"sampling {name} {t}q: the request's graph "
                                                f"holds {graph_kernels} fused_run nodes, {runs} runs")
                _require(torch.equal(got, again) and int(got.min()) >= 0
                         and int(got.max()) < (1 << t),
                         f"sampling {name} {t}q {shots}: a shot out of range, or a replay "
                         "that differs from the eager request")
                # the same table from the explicit stages on the card's state,
                # and from the CPU's words and draws given the same marginal,
                # uniforms and total, bit for bit
                u = rng.uniform(sp.shot_key(SAMPLE_SEED, 0, dev), (shots,))
                _require(torch.equal(sp.draw_outcomes(p, u, norm=norm), got),
                         f"sampling {name} {t}q {shots}: the request's table differs from its "
                         "stages on its state")
                u_cpu = rng.uniform(sp.shot_key(SAMPLE_SEED, 0), (shots,))
                _require(torch.equal(u.cpu(), u_cpu),
                         f"sampling {name}: the card's uniforms differ from the CPU's")
                _require(torch.equal(sp.draw_outcomes(p_cpu, u_cpu, norm=norm.cpu()),
                                     got.cpu()),
                         f"sampling {name} {t}q {shots}: the card's draws differ from the CPU's")
                chi = None
                if t < N_MAIN and shots == max(SAMPLE_SHOTS):
                    exact = M.prob_of_all_outcomes(state.double(), n=N_MAIN,
                                                   targets=targets).cpu().numpy()
                    emp = np.bincount(got.cpu().numpy(), minlength=1 << t).astype(np.float64)
                    exp = shots * exact / exact.sum()
                    live = exp > 0
                    stat = float(np.sum((emp[live] - exp[live]) ** 2 / exp[live]))
                    dof = int(live.sum()) - 1
                    chi = (stat, float(chi2_dist.sf(stat, dof)), dof)
                    _require(chi[1] >= 1e-6 and emp[~live].sum() == 0,
                             f"sampling {name}: chi-square {stat:.1f} over {dof} dof, p-value "
                             f"{chi[1]:.3g} < 1e-6, or a shot on an outcome of probability 0")
                ms = _cuda_ms(lambda: exe(zero, seed_t), 5)
                base(zero, seed_t)
                base_ms = _cuda_ms(lambda: base(zero, seed_t), 5)
                bound = _shot_stage_bytes(N_MAIN, t, shots, dt.itemsize) / HBM_BYTES_PER_S * 1e3
                out[(dt, t, shots)] = {
                    "launches": launches, "runs": runs, "graph_kernels": graph_kernels,
                    "ms": ms, "no_shots_ms": base_ms, "shot_stage_ms": ms - base_ms,
                    "shot_stage_bound_ms": bound, "chi2": chi}
                print(f"# sampling {name} {N_MAIN}q depth {DEPTH_MAIN} fused, {t} targets, "
                      f"{shots} shots: the eager request launched the kernel {launches} times "
                      f"(runs {runs}), its graph holds {graph_kernels} fused_run nodes; shots "
                      f"in range, = its stages on the card's state, = the CPU's draws and u "
                      f"words" + (f"; chi-square {chi[0]:.1f} ({chi[2]} dof, p-value "
                                  f"{chi[1]:.3g})" if chi else "")
                      + f"; {ms:.3f} ms a request against {base_ms:.3f} ms without the shot "
                        f"stage (the shot stage {ms - base_ms:.3f} ms, bytes bound "
                        f"{bound:.3f} ms) [{card}]")
        del zero, state, p, p_cpu, base
        _release()

        # a mid-circuit measurement: every shot carries its drawn outcome
        n, depth, mq = MID_MEASURE
        circs = []
        for seed in (P("m"), SAMPLE_SEED):
            c = qt.Circuit(n)
            qt.random_layers(c, n, depth)
            c.applyMidMeasurement(mq, seed, site=1)
            for q in range(3):
                c.hadamard(q)
            circs.append(c)
        exe = sample_request(circs[0].fused(max_qubits=5, pallas=True, dtype=dt), shots=4096,
                             donate=False)
        zero = qt.createQureg(n, env, prec).amps
        bits = (exe(zero, seed_t)["shots"].cpu().numpy() >> mq) & 1
        exe(zero, seed_t)
        qr = qt.createQureg(n, env, prec)
        circs[1].run(qr)  # the same seed, eagerly
        p1 = qt.calcProbOfOutcome(qr, mq, 1)
        _require(len(set(bits.tolist())) == 1 and abs(p1 - bits[0]) <= 1e-4,
                 f"sampling {name} mid-circuit measurement: the shots carry "
                 f"{sorted(set(bits.tolist()))} at qubit {mq}, the eager run's P(1) {p1}")
        ms = _cuda_ms(lambda: exe(zero, seed_t), 5)
        out[(dt, "mid")] = {"outcome": int(bits[0]), "ms": ms}
        print(f"# sampling {name} mid-circuit measurement: {n}q random_layers({depth}) fused, "
              f"applyMidMeasurement({mq}, P('m')) bound to the request's seed, 4096 shots all "
              f"carry outcome {int(bits[0])} at qubit {mq} (the same seed's eager run: P(1) "
              f"{p1:.6f}); {ms:.3f} ms a request [{card}]")
        del zero, qr, exe
        _release()

        # the Engine with a shot table as its finalize: lanes = single runs
        n, depth = GRAD_ANSATZ
        circ = qt.serving_ansatz(n, depth).fused(max_qubits=5, pallas=True, dtype=dt)
        runs = sum(f is fusion._apply_pallas_run for f, _, _ in circ._tape)
        names = circ.param_names
        r = np.random.RandomState(2020)
        sweep = [dict(zip(names, r.uniform(0, 2 * np.pi, len(names))))
                 for _ in range(GRAD_LANES)]
        fin = sample_reduce(n=n, targets=tuple(range(n)), shots=1024)
        eng = Engine(circ, env, precision_code=prec, max_batch=GRAD_LANES, max_delay_ms=20.0,
                     finalize=fin)
        telemetry.reset()
        FG.fused_run.launches = 0
        eng.run(sweep[0], 600)
        torch.cuda.synchronize(dev)
        e_launches = FG.fused_run.launches
        _require(e_launches == runs, f"sampling {name} engine: the eager batch launched the "
                                     f"kernel {e_launches} times for {runs} runs")
        eng.run(sweep[0], 600)  # the capture
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            lanes = [f.result(600) for f in eng.submit_many(sweep)]
            best = min(best, time.perf_counter() - t0)
        e_graph = _graph_kernels(eng._execB())
        singles = [eng.run(s, 600) for s in sweep]
        _require(all(a.shape == (1024,) and torch.equal(a, b) for a, b in zip(lanes, singles)),
                 f"sampling {name} engine: a lane's shot table differs from its request "
                 "served alone")
        eng.close(timeout=600)
        out[(dt, "engine")] = {"launches": e_launches, "runs": runs, "graph_kernels": e_graph,
                               "requests_per_s": GRAD_LANES / best, "batch_ms": best * 1e3}
        print(f"# sampling {name} engine: serving_ansatz({n}, {depth}) fused ({runs} runs), "
              f"finalize=sample_reduce(1024 shots), {GRAD_LANES} lanes: the eager batch "
              f"launched the kernel {e_launches} times, its graph holds {e_graph} fused_run "
              f"nodes; lanes = single runs bit for bit; a batch {best * 1e3:.2f} ms, "
              f"{GRAD_LANES / best:.2f} requests/s [{card}]")
        del eng, lanes, singles
        _release()
    return out


def _lane_u_blocks(circ) -> int:
    """The dense blocks of a ``fused()`` plan that run as lane_u passes of
    the fused-run kernel on the card."""
    from quest_tpu_torch import fusion

    nsv = circ.num_qubits
    return sum(f is fusion._apply_dense_block
               and fusion.dense_block_route(nsv, False, a[0].qubits, True) == "lane_u"
               for f, a, _ in circ._tape)


def _grad_max(out) -> float:
    return max(abs(float(g)) for g in out["grads"].values())


def _gradients_phase(qt, dev) -> dict:
    """Phase 13, gradients (``# gradients`` lines; see the module docstring,
    item 13)."""
    import numpy as np
    import torch

    from quest_tpu_torch import telemetry
    from quest_tpu_torch.engine import Engine
    from quest_tpu_torch.gradients import parameter_shift
    from quest_tpu_torch.ops import fused_gates as FG

    card = _card_line()
    out: dict = {}
    env = qt.createQuESTEnv(device=dev)

    def params(circ, seed):
        r = np.random.RandomState(seed)
        return dict(zip(circ.param_names, r.uniform(0, 2 * np.pi, len(circ.param_names))))

    def gradient(circ, hamil, dt, prm, reps):
        """One configuration: the cold (eager, counted) call, the capture,
        the timed replays, and the forward alone timed the same way."""
        prec = 1 if dt == torch.float32 else 2
        zero = qt.createQureg(circ.num_qubits, env, prec).amps
        gx = circ.gradient(hamil, donate=False, dtype=dt)
        telemetry.reset()
        FG.fused_run.launches = 0
        t0 = time.perf_counter()
        first = gx(zero, prm)
        torch.cuda.synchronize(dev)
        cold_s = time.perf_counter() - t0
        launches = FG.fused_run.launches
        res = gx(zero, prm)  # the capture
        _require(telemetry.counter_value("device_dispatch_total", route="grad_request") == 2,
                 "a gradient is not one grad_request dispatch")
        same = torch.equal(first["value"], res["value"]) and all(
            torch.equal(first["grads"][k], res["grads"][k]) for k in res["grads"])
        _require(same, "the gradient's graph replay differs from its eager run")
        _require(bool(gx.captures), "the gradient's second call captured no graph")
        cap_s, cap_b = gx.captures[-1] if gx.captures else (0.0, 0)
        graph_kernels = _graph_kernels(gx)
        ms = _cuda_ms(lambda: gx(zero, prm), reps)
        fw = circ.parameterized(donate=False)
        fw(zero, prm)
        fw(zero, prm)
        fw_ms = _cuda_ms(lambda: fw(zero, prm), reps)
        state = fw(zero, prm)
        return {"out": res, "state": state, "launches": launches, "graph_kernels": graph_kernels,
                "cold_s": cold_s, "capture_s": cap_s, "capture_mib": cap_b / 2 ** 20, "ms": ms,
                "forward_ms": fw_ms, "ratio": ms / fw_ms, "slots": gx.num_slots}

    n, depth = GRAD_ANSATZ
    hamil = tfim_hamil(qt, n, 2020)
    raw = qt.serving_ansatz(n, depth)
    fused = raw.fused(max_qubits=5)
    blocks = _lane_u_blocks(fused)
    prm = params(raw, 13)
    for dt in (torch.float32, torch.float64):
        name = str(dt)[6:]
        for kind, circ in (("raw", raw), ("fused", fused)):
            r = gradient(circ, hamil, dt, prm, 3)
            want = blocks if kind == "fused" else 0
            _require(r["launches"] == want and r["graph_kernels"] == want,
                     f"gradients {name} {kind}: the eager gradient launched the kernel "
                     f"{r['launches']} times and its graph holds {r['graph_kernels']} fused_run "
                     f"nodes, for {want} lane_u blocks")
            if kind == "fused":
                _require(want >= 1, "the fused gradient's graph holds no fused_run node")
            out[(dt, kind)] = r
            print(f"# gradients {name} serving_ansatz({n}, {depth}) {kind}: {r['slots']} slots, "
                  f"TFIM {hamil.num_sum_terms} terms; value {float(r['out']['value']):.12f}; the "
                  f"eager gradient launched the kernel {r['launches']} times, the graph holds "
                  f"{r['graph_kernels']} fused_run nodes (lane_u blocks {want}); {r['ms']:.3f} ms "
                  f"a gradient against {r['forward_ms']:.3f} ms the parameterized() forward "
                  f"alone (x{r['ratio']:.2f}); cold {r['cold_s']:.2f} s, capture "
                  f"{r['capture_s']:.2f} s, the graph holds {r['capture_mib']:.1f} MiB [{card}]")
        a, b = out[(dt, "raw")]["out"], out[(dt, "fused")]["out"]
        gd = max(abs(float(a["grads"][k]) - float(b["grads"][k])) for k in a["grads"])
        same_value = torch.equal(a["value"], b["value"])
        if dt == torch.float64:
            _require(same_value and gd <= 1e-12,
                     f"gradients f64 raw against fused: value equal {same_value}, grads {gd:.3e}")
        dv = abs(float(a["value"]) - float(b["value"]))
        value = "bit for bit" if same_value else f"differs by {dv:.3e}"
        limits = " (limits: bit for bit, 1e-12)" if dt == torch.float64 else ""
        print(f"# gradients {name} raw against fused: value {value}, grads within "
              f"{gd:.3e}{limits} [{card}]")
    g32, g64 = out[(torch.float32, "raw")]["out"], out[(torch.float64, "raw")]["out"]
    gmax = _grad_max(g64)
    d = max(abs(float(g32["grads"][k]) - float(g64["grads"][k])) for k in g64["grads"])
    _require(d <= 1e-3 * gmax, f"gradients f32 against f64: {d:.3e} > 1e-3 x {gmax:.3e}")
    print(f"# gradients f32 against f64: grads within {d:.3e} ({d / gmax:.3e} of the largest "
          f"|g| {gmax:.4f}; limit 1e-3) [{card}]")
    for r in out.values():
        r.pop("state")
    _release()

    # the second oracle: parameter shifts on one layer, f64
    shallow = qt.serving_ansatz(n, SHIFT_DEPTH)
    p1 = params(shallow, 14)
    zero = qt.createQureg(n, env, 2).amps
    adj = shallow.gradient(hamil, donate=False, dtype=torch.float64)(zero, p1)
    t0 = time.perf_counter()
    ps = parameter_shift(shallow, hamil, zero, p1)
    ps_s = time.perf_counter() - t0
    d = max(abs(float(adj["grads"][k]) - ps["grads"][k]) for k in ps["grads"])
    dv = abs(float(adj["value"]) - ps["value"])
    _require(d <= 1e-9 and dv <= 1e-9, f"gradients f64 against parameter_shift: {d:.3e}, "
                                       f"value {dv:.3e} (limit 1e-9)")
    out["shift"] = {"max_diff": d, "seconds": ps_s, "slots": len(ps["slot_grads"])}
    print(f"# gradients f64 serving_ansatz({n}, {SHIFT_DEPTH}) against parameter_shift "
          f"({len(ps['slot_grads'])} slots, {2 * len(ps['slot_grads']) + 1} replays in "
          f"{ps_s:.2f} s): grads within {d:.3e}, value within {dv:.3e} (limit 1e-9) [{card}]")
    del zero
    _release()

    # full width: 26 qubits, depth cut to 2
    n26, depth26 = GRAD_FULL
    hamil26 = tfim_hamil(qt, n26, 2026)
    circ26 = qt.serving_ansatz(n26, depth26).fused(max_qubits=5)
    blocks26 = _lane_u_blocks(circ26)
    prm26 = params(circ26, 26)
    for dt, tol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
        name, prec = str(dt)[6:], (1 if dt == torch.float32 else 2)
        r = gradient(circ26, hamil26, dt, prm26, 2)
        _require(r["launches"] == blocks26 and r["graph_kernels"] == blocks26,
                 f"gradients {name} {n26}q: {r['launches']} launches, {r['graph_kernels']} "
                 f"fused_run nodes, for {blocks26} lane_u blocks")
        q = qt.createQureg(n26, env, prec)
        q.amps.copy_(r.pop("state"))
        ws = qt.createQureg(n26, env, prec)
        want = qt.calcExpecPauliHamil(q, hamil26, ws)
        err = abs(float(r["out"]["value"]) - want)
        _require(err <= tol, f"gradients {name} {n26}q: value {float(r['out']['value'])} against "
                             f"calcExpecPauliHamil {want} ({err:.3e} > {tol:g})")
        r["value_err"] = err
        out[(dt, "full")] = r
        print(f"# gradients {name} serving_ansatz({n26}, {depth26}) fused: {r['slots']} slots, "
              f"TFIM {hamil26.num_sum_terms} terms; value within {err:.3e} of "
              f"calcExpecPauliHamil of the forward state (limit {tol:g}); the eager gradient "
              f"launched the kernel {r['launches']} times (lane_u blocks {blocks26}); "
              f"{r['ms']:.2f} ms a gradient against {r['forward_ms']:.2f} ms the forward alone "
              f"(x{r['ratio']:.2f}); cold {r['cold_s']:.2f} s, capture {r['capture_s']:.2f} s, "
              f"the graph holds {r['capture_mib']:.1f} MiB [{card}]")
        del q, ws
        _release()

    # Engine.submit_grad: coalesced lanes against a loop of unbatched gradients
    sweep = [params(raw, 100 + i) for i in range(GRAD_LANES)]
    for dt, tol in ((torch.float32, 2e-4), (torch.float64, 1e-10)):
        name, prec = str(dt)[6:], (1 if dt == torch.float32 else 2)
        for kind, circ in (("raw", raw), ("fused", fused)):
            eng = Engine(circ, env, precision_code=prec, max_batch=GRAD_LANES,
                         max_delay_ms=20.0, hamiltonian=hamil)
            telemetry.reset()
            FG.fused_run.launches = 0
            eng.submit_grad(sweep[0]).result(600)
            torch.cuda.synchronize(dev)
            launches = FG.fused_run.launches
            want = blocks if kind == "fused" else 0
            _require(launches == want, f"gradients {name} engine {kind}: the eager batch "
                                       f"launched the kernel {launches} times for {want} blocks")
            eng.warmup_grad(sweep[0], 600)
            traces = telemetry.counter_value("engine_trace_total", kind="param_replay")
            best = float("inf")
            for _ in range(2):
                t0 = time.perf_counter()
                lanes = [f.result(600) for f in [eng.submit_grad(p) for p in sweep]]
                best = min(best, time.perf_counter() - t0)
            _require(telemetry.counter_value("engine_trace_total", kind="param_replay")
                     == traces, f"gradients {name} engine {kind}: a warm batch built again")
            g_graph = _graph_kernels(eng.grad_engine()._execB())
            singles = [eng.grad_engine().run(p, 600) for p in sweep]
            same = all(torch.equal(v, s["value"]) and all(
                torch.equal(g[k], s["grads"][k]) for k in g) for (v, g), s in zip(lanes, singles))
            _require(same, f"gradients {name} engine {kind}: a lane differs from its request "
                           "served alone")
            eng.close(timeout=600)
            del eng, singles
            zero = qt.createQureg(GRAD_ANSATZ[0], env, prec).amps
            gx = circ.gradient(hamil, donate=False, dtype=dt)
            gx(zero, sweep[0])
            gx(zero, sweep[0])
            loop = float("inf")
            for _ in range(2):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                refs = [gx(zero, p) for p in sweep]
                torch.cuda.synchronize(dev)
                loop = min(loop, time.perf_counter() - t0)
            err = max(abs(float(g[k]) - float(ref["grads"][k])) / _grad_max(ref)
                      for (_, g), ref in zip(lanes, refs) for k in g)
            _require(err <= tol, f"gradients {name} engine {kind}: a lane is {err:.3e} of the "
                                 f"largest |g| from the unbatched gradient (limit {tol:g})")
            out[(dt, "engine", kind)] = {
                "launches": launches, "graph_kernels": g_graph, "blocks": want,
                "requests_per_s": GRAD_LANES / best, "loop_requests_per_s": GRAD_LANES / loop,
                "batch_ms": best * 1e3, "max_rel_err": err}
            print(f"# gradients {name} engine {kind}: serving_ansatz({n}, {depth}), "
                  f"{GRAD_LANES} lanes of submit_grad: the eager batch launched the kernel "
                  f"{launches} times, its graph holds {g_graph} fused_run nodes; lanes = single "
                  f"runs bit for bit, within {err:.3e} of the largest |g| of the unbatched "
                  f"gradient (limit {tol:g}); a batch {best * 1e3:.1f} ms, "
                  f"{GRAD_LANES / best:.2f} requests/s coalesced against "
                  f"{GRAD_LANES / loop:.2f} through a loop of Circuit.gradient "
                  f"(x{loop / best:.2f}) [{card}]")
            del zero, gx, refs, lanes
            _release()
    return out


def _sampling_gradients_phase(qt, dev, plans: dict) -> dict:
    """Phase 13: sampling, then gradients, on the card."""
    t0 = time.perf_counter()
    out = {"sampling": _sampling_phase(qt, dev, plans)}
    out["gradients"] = _gradients_phase(qt, dev)
    out["phase_s"] = time.perf_counter() - t0
    print(f"# sampling and gradients phase: {out['phase_s']:.1f} s")
    return out


#: phase 14's trajectory ensembles: (qubits, trajectories); the small one is
#: held against the density route's rho, the others are the bench's
#: trajectories_20q (``bench.py:2074``) and the main path's width
TRAJ_SMALL = (6, 128)
TRAJ = ((20, 16), (26, 4))
#: phase 14's pool: bench.py's pool_20q (``bench.py:1104``): qubits, the two
#: structures' layers, replicas, requests, max_batch
POOL = (20, (4, 5), 3, 32, 8)


def trajectory_circuit(qt, n: int):
    """``bench.py::trajectory_circuit`` on the port's Circuit: an entangled
    n-qubit base with one channel site from each built-in family
    (depolarising, damping, two-qubit dephasing, Pauli), recorded as a
    density tape; ``trajectories.unravel`` turns it into the stochastic
    pure-state form."""
    circ = qt.Circuit(n, is_density_matrix=True)
    for q in range(n):
        circ.hadamard(q)
    for q in range(0, n - 1, 2):
        circ.controlledNot(q, q + 1)
    circ.mixDepolarising(1, 0.05)
    circ.rotateY(n // 2, 0.9)
    circ.mixDamping(0, 0.1)
    circ.mixTwoQubitDephasing(2, 5, 0.2)
    circ.rotateX(1, -0.4)
    circ.mixPauli(3, 0.02, 0.03, 0.05)
    return circ


def _traj_small(qt, dev) -> dict:
    """The 6-qubit ensemble (T = 128, f64) against the density route's rho
    of the same tape on the card, within 4/sqrt(T)."""
    import numpy as np

    from quest_tpu_torch import trajectories as tr

    n, t = TRAJ_SMALL
    env = qt.createQuESTEnv(device=dev)
    circ = trajectory_circuit(qt, n)
    res = tr.run_ensemble(circ, t, env=env, base_seed=7, precision_code=2)
    rho_q = qt.createDensityQureg(n, env, 2)
    circ.run(rho_q)
    rho = np.asarray(qt.get_np(rho_q)).reshape(1 << n, 1 << n).T
    dev_max = float(np.abs(res.density() - rho).max())
    limit = 4.0 / np.sqrt(t)
    _require(dev_max < limit, f"trajectories {n}q: the ensemble mean is {dev_max} from the "
             f"density route's rho (limit {limit:.4f})")
    print(f"# trajectories {n}q f64: T = {t}, ensemble mean within {dev_max:.4e} of the "
          f"density route's rho on the card (limit 4/sqrt(T) = {limit:.4f})")
    return {"qubits": n, "trajectories": t, "max_abs_dev": dev_max, "limit": limit}


def _site_ms(dev, dt, n: int, t: int, sites) -> list:
    """Each channel site alone at the ensemble's width: the reduced-density
    pass and the ``apply_matrix`` of the drawn operator, under
    ``torch.func.vmap`` over T random unit lanes (as the Engine runs it,
    eagerly: the small tables are copied in at each call), on CUDA events,
    beside the bytes bound (the lanes read once and written once)."""
    import torch

    from quest_tpu_torch.trajectories import sample as TS

    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(t, 2, 1 << n, generator=g, device=dev, dtype=dt)
    x /= x.pow(2).sum(dim=(1, 2), keepdim=True).sqrt()
    seeds = torch.arange(t, device=dev, dtype=torch.int64)
    bound = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
    rows = []
    for targets, ops, site in sites:
        fn = torch.func.vmap(lambda a, s, ops=ops, targets=targets, site=site:
                             TS.apply_traj_kraus(a, ops, n=n, targets=targets, seed=s,
                                                 site=site))
        out = fn(x, seeds)
        norm = float((out.double().pow(2).sum(dim=(1, 2)) - 1).abs().max())
        rows.append({"targets": list(targets), "kraus_ops": len(ops),
                     "ms": _cuda_ms(lambda fn=fn: fn(x, seeds), 3), "bound_ms": bound,
                     "max_norm_err": norm})
        del out
    del x
    torch.cuda.empty_cache()
    return rows


def _traj_width(qt, dev, n: int, t: int, dt) -> dict:
    """One width of the trajectory part: the unraveled trajectory_circuit
    planned into fused runs and run as T seed lanes through
    ``run_ensemble`` (its counts reset just before the first, eager call),
    captured, replayed; each lane against its seed served alone, the raw
    tape's ensemble against the fused one, the norms, the sites alone."""
    import torch

    from quest_tpu_torch import fusion, telemetry
    from quest_tpu_torch import trajectories as tr
    from quest_tpu_torch.engine import Engine, executables
    from quest_tpu_torch.ops import fused_gates as FG

    f32 = dt == torch.float32
    prec, tol, ptol = (1, 1e-5, 1e-4) if f32 else (2, 1e-12, 1e-10)
    name = f"{n}q {str(dt)[6:]}"
    wait = 600
    env = qt.createQuESTEnv(device=dev)
    raw = tr.unravel(trajectory_circuit(qt, n))
    fz = raw.fused(max_qubits=5, pallas=True, dtype=dt)
    runs = sum(f is fusion._apply_pallas_run for f, _, _ in fz._tape)
    sites = [(a[0], a[1], k["site"]) for f, a, k in fz._tape
             if getattr(f, "__name__", "") == "applyTrajectoryKraus"]
    others = sorted({getattr(f, "__name__", "") for f, _, _ in fz._tape
                     if f is not fusion._apply_pallas_run} - {"applyTrajectoryKraus"})
    seeds = list(range(1000, 1000 + t))

    def ensemble(circ, s=seeds):
        out = tr.run_ensemble(circ, env=env, seeds=s, precision_code=prec).states
        torch.cuda.synchronize(dev)
        return out

    telemetry.reset()
    FG.fused_run.launches = 0
    t0 = time.perf_counter()
    first = ensemble(fz)
    cold_s = time.perf_counter() - t0
    launches = FG.fused_run.launches
    _require(launches == runs, f"trajectories {name}: the eager ensemble launched the kernel "
             f"{launches} times for {runs} runs of {t} lanes")
    t0 = time.perf_counter()
    second = ensemble(fz)
    capture_s = time.perf_counter() - t0
    batch_fn = executables().peek(("param_vmap", fz.fingerprint(), t, dt, None))
    traces = telemetry.counter_value("engine_trace_total", kind="param_replay")
    _require(batch_fn is not None and len(batch_fn.captures) == 1 and traces == 2,
             f"trajectories {name}: {traces:g} builds after the capture")
    graph_kernels = _graph_kernels(batch_fn)
    _require(graph_kernels == runs, f"trajectories {name}: the graph holds {graph_kernels} "
             f"fused_run nodes for {runs} runs")
    same = torch.equal(first, second)
    del second
    best = float("inf")
    for _ in range(3 if n < N_MAIN else 2):
        t0 = time.perf_counter()
        third = ensemble(fz)
        best = min(best, time.perf_counter() - t0)
        same = same and torch.equal(first, third)
        del third
    _require(same, f"trajectories {name}: a replay of the same seeds differs")
    ensemble(fz, [s + 7919 for s in seeds])
    moved = telemetry.counter_value("engine_trace_total", kind="param_replay") - traces
    _require(moved == 0, f"trajectories {name}: new seeds built {moved:g} times")
    # one lane against its seed served alone, through the same program
    k = t // 2
    with Engine(fz, env, precision_code=prec, max_batch=t, max_delay_ms=0.0) as eng:
        single = eng.submit({tr.SEED_PARAM: seeds[k]}).result(wait)
    _require(torch.equal(single, first[k]), f"trajectories {name}: lane {k} differs from "
             "its seed served alone")
    del single
    capture_mib = round(sum(c[1] for c in batch_fn.captures) / 2 ** 20, 1)
    norms = (first.double().pow(2).sum(dim=(1, 2)) - 1).abs()
    norm_err = float(norms.max())
    _require(norm_err <= ptol, f"trajectories {name}: total probability off by {norm_err}")
    del batch_fn
    _release()  # the fused graph's pool, before the raw tape's eager run
    # the raw tape (every gate on the per-gate engine): one eager ensemble
    t0 = time.perf_counter()
    plain = ensemble(raw)
    raw_s = time.perf_counter() - t0
    err = float((plain - first).abs().max() / first.abs().max())
    del plain
    _require(err <= tol, f"trajectories {name}: fused against raw {err} of the largest "
             f"amplitude (limit {tol:g})")
    del first
    _release()
    # where an ensemble's time goes: its runs' lane-batched launches alone,
    # and each channel site alone
    g = torch.Generator(device=dev).manual_seed(n)
    xb = torch.randn(t, 2, 1 << n, generator=g, device=dev, dtype=dt)
    ob = torch.empty_like(xb)
    plan = [a[0] for f, a, _ in fz._tape if f is fusion._apply_pallas_run]

    def all_runs():
        for r in plan:
            FG.fused_run(xb, n=n, ops=r.ops, tile_bits=r.tile_bits,
                         load_swap_k=r.load_swap_k, store_swap_k=r.store_swap_k,
                         load_swap_hi=r.load_swap_hi, store_swap_hi=r.store_swap_hi,
                         prepared=r.prepare(), out=ob)

    kernel_ms = _cuda_ms(all_runs, 3)
    del xb, ob
    torch.cuda.empty_cache()
    site_rows = _site_ms(dev, dt, n, t, sites)
    site_ms = sum(r["ms"] for r in site_rows)
    row = {"qubits": n, "trajectories": t, "runs": runs, "sites": len(sites),
           "other_items": others, "launches": launches, "graph_kernels": graph_kernels,
           "cold_s": cold_s, "capture_s": capture_s,
           "capture_mib": capture_mib,
           "ensemble_ms": best * 1e3, "trajectories_per_s": t / best,
           "raw_ensemble_ms": raw_s * 1e3, "fused_vs_raw": err, "max_norm_err": norm_err,
           "kernel_ms": kernel_ms, "site_ms": site_ms, "sites_alone": site_rows}
    print(f"# trajectories {name}: T = {t}, {runs} fused runs + {len(sites)} channel sites "
          f"(other items: {others}); the eager ensemble launched the kernel {launches} "
          f"times (runs {runs}), the graph holds {graph_kernels} fused_run nodes; replays "
          f"and new seeds built nothing, replays bit for bit, lane {k} = its seed alone; "
          f"fused against raw {err:.3e} of the largest (limit {tol:g}); total probability "
          f"within {norm_err:.3e}; {row['trajectories_per_s']:.2f} trajectories/s, "
          f"{row['ensemble_ms']:.2f} ms an ensemble (raw tape, eager: {raw_s * 1e3:.1f} ms); "
          f"cold {cold_s:.3f} s, capture {capture_s:.3f} s ({row['capture_mib']} MiB); its "
          f"runs' lane-batched launches alone {kernel_ms:.3f} ms, its sites alone "
          f"{site_ms:.3f} ms")
    for r in site_rows:
        print(f"# trajectories {name} site on {r['targets']} ({r['kraus_ops']} Kraus ops): "
              f"{r['ms']:.4f} ms (reduced-density pass + apply_matrix over {t} lanes) "
              f"against a bytes bound of {r['bound_ms']:.4f} ms "
              f"(x{r['ms'] / r['bound_ms']:.1f}); norms within {r['max_norm_err']:.2e}")
    return row


def _pool_path(qt, dev, dt) -> dict:
    """bench.py's pool_20q on the card: serving_ansatz(20, 4) and (20, 5)
    planned into fused runs, 3 replicas, 32 requests sent one at a time,
    once without and once with a ``pool.replica:kill`` halfway; every
    served result against a lone Engine's, bit for bit; the replacement's
    first request builds nothing; then ``submit_grad`` through the pool."""
    import contextlib

    import numpy as np
    import torch

    from quest_tpu_torch import fusion, telemetry
    from quest_tpu_torch.engine import Engine, EnginePool, executables
    from quest_tpu_torch.ops import fused_gates as FG
    from quest_tpu_torch.resilience import fault_plan

    n, depths, replicas, requests, batch = POOL
    f32 = dt == torch.float32
    prec = 1 if f32 else 2
    name = f"{n}q {str(dt)[6:]}"
    wait = 600
    env = qt.createQuESTEnv(device=dev)
    structures = [qt.serving_ansatz(n, d).fused(max_qubits=5, pallas=True, dtype=dt)
                  for d in depths]
    runs = [sum(f is fusion._apply_pallas_run for f, _, _ in c._tape) for c in structures]
    rng = np.random.RandomState(13)

    def draw(c):
        return dict(zip(c.param_names, rng.uniform(0, 2 * np.pi, len(c.param_names))))

    work = [(c, draw(c)) for c in (structures[i % len(structures)] for i in range(requests))]
    out: dict = {"qubits": n, "layers": list(depths), "replicas": replicas,
                 "requests": requests, "max_batch": batch, "runs": runs}
    pool = EnginePool(env, replicas=replicas, max_batch=batch, max_delay_ms=1.0,
                      precision_code=prec)
    try:
        # each structure's first request: the eager batch, counted
        telemetry.reset()
        FG.fused_run.launches = 0
        for c in structures:
            pool.submit(c, draw(c)).result(wait)
        launches = FG.fused_run.launches
        _require(launches == sum(runs), f"pool {name}: the eager batches launched the "
                 f"kernel {launches} times for {sum(runs)} runs")
        for c in structures:  # the second captures
            pool.submit(c, draw(c)).result(wait)
        fns = [executables().peek(("param_vmap", c.fingerprint(), batch, dt, None))
               for c in structures]
        graph_kernels = sum(_graph_kernels(f) for f in fns)
        _require(graph_kernels == sum(runs), f"pool {name}: the graphs hold {graph_kernels} "
                 f"fused_run nodes for {sum(runs)} runs")
        out.update(launches=launches, graph_kernels=graph_kernels)
        kill_at = requests // 2

        def stream(kill: bool):
            lat: dict = {}
            futs = []
            plan = (fault_plan(f"pool.replica:kill:{kill_at}") if kill
                    else contextlib.nullcontext())
            done_at: dict = {}
            with plan:
                t_wall = time.time()
                t0 = time.perf_counter()
                for i, (c, p) in enumerate(work):
                    ts = time.perf_counter()
                    f = pool.submit(c, p, tenant=f"tenant{i % 2}")

                    def finished(_f, i=i, ts=ts):
                        done_at[i] = time.perf_counter()
                        lat[i] = done_at[i] - ts

                    f.add_done_callback(finished)
                    futs.append(f)
                submit_s = time.perf_counter() - t0
                got = [f.result(wait) for f in futs]
                wall = time.perf_counter() - t0
            lost = sum(1 for f in futs if not f.done() or f.exception() is not None)
            ms = [lat[i] * 1e3 for i in range(len(work))]
            ends = sorted([t0] + list(done_at.values()))
            # the timeline of the stream: when the pool's and the engines'
            # lifecycle events happened, seconds after the first submit
            timeline = [(e["name"], round(e["t"] - t_wall, 4)) for e in telemetry.events()
                        if e["t"] >= t_wall and e["name"].split(".")[0] in ("pool", "engine")
                        and e["name"] != "engine.health"]
            return got, lost, {"requests_per_s": len(work) / wall, "wall_s": wall,
                               "p50_ms": float(np.percentile(ms, 50)),
                               "p99_ms": float(np.percentile(ms, 99)), "max_ms": max(ms),
                               "submit_s": submit_s,
                               "max_gap_ms": max(b - a for a, b in zip(ends, ends[1:])) * 1e3,
                               "timeline": timeline}

        calm, lost0, out["no_kill"] = stream(False)
        f0 = telemetry.counter_value("pool_failovers_total", reason="kill")
        t_kill = time.perf_counter()
        killed, lost1, out["kill"] = stream(True)
        failovers = telemetry.counter_value("pool_failovers_total", reason="kill") - f0
        _require(lost0 == 0 and lost1 == 0, f"pool {name}: {lost0} / {lost1} requests lost")
        _require(failovers == 1, f"pool {name}: {failovers:g} kill failovers")
        pool.await_rotation(replicas, timeout=wait)
        out["replacement_in_rotation_s"] = time.perf_counter() - t_kill
        new_rep = max(pool._replicas, key=lambda r: r.id)
        _require(new_rep.id == replicas and new_rep.in_rotation,
                 f"pool {name}: no replacement in rotation")
        tr0 = telemetry.counter_value("engine_trace_total", kind="param_replay")
        c, p = work[0]
        fresh = new_rep.engines[c.fingerprint()].submit(p).result(wait)
        retraces = telemetry.counter_value("engine_trace_total", kind="param_replay") - tr0
        _require(retraces == 0, f"pool {name}: the replacement's first request built "
                 f"{retraces:g} times")
        out.update(lost_requests=lost0 + lost1, failovers=failovers,
                   replacement_retraces=retraces)
        # the oracle: lone Engines, each structure's requests coalesced (a
        # lane equals its request served alone)
        oracle = []
        for c in structures:
            with Engine(c, env, precision_code=prec, max_batch=batch,
                        max_delay_ms=0.0) as eng:
                mine = [p for cc, p in work if cc is c]
                oracle.append(dict(zip(range(len(mine)),
                                       [f.result(wait) for f in eng.submit_many(mine)])))
        seen = [0] * len(structures)
        ident = torch.equal(fresh, oracle[0][0])
        for i, (c, _p) in enumerate(work):
            s = structures.index(c)
            want = oracle[s][seen[s]]
            seen[s] += 1
            ident = ident and torch.equal(calm[i], want) and torch.equal(killed[i], want)
        _require(ident, f"pool {name}: a served result differs from the lone Engine's")
        del calm, killed, oracle, fresh
        # gradients through the pool: the raw ansatz (a fused-run entry has
        # no adjoint) against a TFIM, 8 requests a batch
        circ = qt.serving_ansatz(n, depths[0])
        ham = tfim_hamil(qt, n, 2121)
        sweep = [draw(circ) for _ in range(batch)]
        for _ in range(2):  # eager, then the capture
            [f.result(wait) for f in pool.submit_grad_many(circ, sweep, hamiltonian=ham)]
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            grads = [f.result(wait) for f in pool.submit_grad_many(circ, sweep,
                                                                     hamiltonian=ham)]
            best = min(best, time.perf_counter() - t0)
        with Engine(circ, env, precision_code=prec, max_batch=batch, max_delay_ms=0.0,
                    hamiltonian=ham) as eng:
            want = eng.submit_grad(sweep[1]).result(wait)
        g_ident = torch.equal(grads[1][0], want[0]) and all(
            torch.equal(grads[1][1][k], want[1][k]) for k in want[1])
        _require(g_ident, f"pool {name}: submit_grad through the pool differs from "
                 "Engine.submit_grad")
        out["grad_requests_per_s"] = batch / best
        out["grad_batch_ms"] = best * 1e3
    finally:
        pool.close()
    _release()
    nk, k = out["no_kill"], out["kill"]
    print(f"# pool {name}: serving_ansatz({n}, {depths[0]}) and ({n}, {depths[1]}) fused "
          f"({runs} runs), {replicas} replicas, {requests} requests one at a time: the eager "
          f"batches launched the kernel {launches} times, the graphs hold {graph_kernels} "
          f"fused_run nodes; {nk['requests_per_s']:.2f} requests/s, p50 / p99 "
          f"{nk['p50_ms']:.2f} / {nk['p99_ms']:.2f} ms; with a pool.replica kill at request "
          f"{kill_at}: {k['requests_per_s']:.2f} requests/s, p50 / p99 {k['p50_ms']:.2f} / "
          f"{k['p99_ms']:.2f} ms (slowest {k['max_ms']:.2f} ms; submits took "
          f"{k['submit_s'] * 1e3:.1f} ms, the longest gap between completions "
          f"{k['max_gap_ms']:.1f} ms against {nk['max_gap_ms']:.1f} without), "
          f"{out['failovers']:g} "
          f"failover, lost {out['lost_requests']}, every result = a lone Engine's bit for "
          f"bit, the replacement in rotation {out['replacement_in_rotation_s']:.2f} s after "
          f"the stream began and its first request built nothing; submit_grad through the "
          f"pool {out['grad_requests_per_s']:.2f} requests/s ({batch} a batch, "
          f"{out['grad_batch_ms']:.1f} ms), = Engine.submit_grad bit for bit")
    return out


def _trajectories_pool_phase(qt, dev) -> dict:
    """Phase 14: trajectory ensembles, then the replica pool, on the card."""
    import torch

    t_phase = time.perf_counter()
    out = {"small": _traj_small(qt, dev)}
    _release()
    for n, t in TRAJ:
        for dt in (torch.float32, torch.float64):
            out[(n, dt)] = _traj_width(qt, dev, n, t, dt)
    for dt in (torch.float32, torch.float64):
        out[("pool", dt)] = _pool_path(qt, dev, dt)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"# trajectories and pool phase: {out['phase_s']:.1f} s")
    return out


def _trajectories_pool_entries(entries: list, phase: dict) -> None:
    """Phase 14's paths in the f32 and f64 ``kernels`` entries: each
    ensemble's and each pool structure's first (eager) call, the counts
    reset just before it, launches the kernel once a run for every lane,
    and its graph holds as many fused_run nodes; beside them the numbers."""
    import torch

    for e, ddt in zip(entries, (torch.float32, torch.float64)):
        for n, _t in TRAJ:
            r = phase[(n, ddt)]
            e["paths"][f"trajectories_{n}q_fused"] = {
                k: r[k] for k in ("launches", "graph_kernels", "runs", "trajectories")}
        p = phase[("pool", ddt)]
        e["paths"]["pool_20q_fused"] = {k: p[k] for k in ("launches", "graph_kernels", "runs")}
        for key in [f"trajectories_{n}q_fused" for n, _t in TRAJ] + ["pool_20q_fused"]:
            e["launches"] += e["paths"][key]["launches"]
            e["graph_kernels"] = e.get("graph_kernels", 0) + e["paths"][key]["graph_kernels"]
        e["trajectories"] = {f"{n}q": phase[(n, ddt)] for n, _t in TRAJ}
        e["trajectories"]["6q_vs_density"] = phase["small"]
        e["pool"] = p


#: phase 15: the env seeds of the runs whose RNG must agree, the qubits
#: measured after the resumed and the uninterrupted 26q runs, the f32 drift
#: check's runs, and the widths of the 22q and density parts
CKPT_SEEDS = (2026, 22)
CKPT_MEASURE = (0, 3, 7, 11, 13, 19, 22, 25)
DRIFT_RUNS = 8
N_CKPT, N_CKPT_DENSITY = 22, 10


def _halves(fz, n: int, what: str) -> tuple:
    """(every_n_items, cuts, fused runs a segment) of a plan cut into two
    segments or more, printed as a ``# segmented`` line."""
    from quest_tpu_torch import fusion, segments
    from quest_tpu_torch.resilience import segment_plan

    every = (len(fz) + 1) // 2
    cuts = segment_plan(fz._tape, n, every)
    _require(len(cuts) >= 3, f"{what}: every_n_items {every} gives {len(cuts) - 1} segment")
    runs = [sum(f is fusion._apply_pallas_run for f, _, _ in fz._tape[a:b])
            for a, b in zip(cuts, cuts[1:])]
    print(f"# segmented {what}: {len(fz)} items, identity boundaries "
          f"{segments.identity_boundaries(fz._tape, n)}; every_n_items {every} -> cuts "
          f"{cuts} ({len(runs)} segments of {runs} fused runs)")
    return every, cuts, runs


def _hist_s(name: str, phases) -> dict:
    """Seconds in each phase of one checkpoint timing histogram (sums)."""
    from quest_tpu_torch import telemetry

    return {ph: telemetry.histogram(name, phase=ph).get("sum", 0.0) for ph in phases}


def _preempted(qt, fz, qureg, d: str, every: int) -> int:
    """``run_segmented`` under a preemption at the first boundary: the
    cursor of the QuESTPreemptionError (it must raise)."""
    from quest_tpu_torch.resilience import fault_plan

    with fault_plan("segment.boundary:preempt:1"):
        try:
            fz.run_segmented(qureg, checkpoint_dir=d, every_n_items=every)
        except qt.QuESTPreemptionError as e:
            _require(e.checkpoint_dir == d, "the preemption names another directory")
            return e.cursor
    raise RuntimeError("run_segmented was not preempted at segment.boundary:preempt:1")


def _ckpt_main(qt, dev, fz, root: str) -> dict:
    """Phase 15, part 1: the 26q f32 main path preempted, resumed and run
    whole, against ``Circuit.run`` and the eager replay bit for bit."""
    import os

    import torch

    import numpy as np

    from quest_tpu_torch import checkpoint as CK
    from quest_tpu_torch import segments, telemetry
    from quest_tpu_torch.ops import fused_gates as FG

    n = N_MAIN
    every, cuts, runs = _halves(fz, n, f"{n}q f32")

    def seeded():
        env = qt.createQuESTEnv(device=dev)
        qt.seedQuEST(env, list(CKPT_SEEDS))
        return env

    pre_dir, whole_dir = os.path.join(root, "main_pre"), os.path.join(root, "main_whole")
    q = qt.createQureg(n, seeded(), 1)
    telemetry.reset()
    FG.fused_run.launches = 0
    t0 = time.perf_counter()
    cursor = _preempted(qt, fz, q, pre_dir, every)
    pre_s = time.perf_counter() - t0
    eager_first = FG.fused_run.launches
    _require(cursor == cuts[1], f"26q: preempted at cursor {cursor}, not {cuts[1]}")
    _require(eager_first == runs[0], f"26q: the first (eager) segment launched the kernel "
             f"{eager_first} times for {runs[0]} runs")
    save = _hist_s("checkpoint_save_seconds", ("copy", "crc", "write", "rename"))
    gen = os.path.join(pre_dir, f"gen_{cursor:08d}")
    nbytes = sum(os.path.getsize(os.path.join(gen, f)) for f in os.listdir(gen)
                 if f.endswith(".npz"))
    qt.destroyQureg(q)
    del q
    torch.cuda.empty_cache()

    env_r = qt.createQuESTEnv(device=dev)  # fresh: seeded by time and pid
    telemetry.reset()
    FG.fused_run.launches = 0
    t0 = time.perf_counter()
    resumed = qt.resume_segmented(fz, pre_dir, env_r)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    eager_rest = FG.fused_run.launches
    verify = _hist_s("checkpoint_verify_seconds", ("read", "crc"))
    load = _hist_s("checkpoint_load_seconds", ("read", "crc", "place"))
    _require(telemetry.counter_value("segmented_resume_total", outcome="verified") == 1,
             "26q: the resume took no verified generation")
    _require(eager_rest == sum(runs[1:]), f"26q: the resumed (eager) segments launched the "
             f"kernel {eager_rest} times for {sum(runs[1:])} runs")
    _require(env_r.seeds == list(CKPT_SEEDS), "26q: the resume did not restore the seeds")
    # yardstick (never called by the port): np.savez_compressed, one zlib
    # stream, against the port's writer on the same 2^23 amplitudes
    part = resumed.amps[:, :1 << 23].cpu().numpy()
    yard = {}
    for name, write in (("np.savez_compressed", lambda f: np.savez_compressed(
            f, amps=part, start=np.int64(0), stop=np.int64(1 << 23))),
                        ("_write_npz", lambda f: CK._write_npz(f, {
                            "amps": part, "start": np.int64(0), "stop": np.int64(1 << 23)}))):
        path = os.path.join(root, "yardstick.npz")
        t0 = time.perf_counter()
        write(path)
        yard[name] = part.nbytes / 1e6 / (time.perf_counter() - t0)
        os.unlink(path)
    del part

    whole = qt.createQureg(n, seeded(), 1)
    telemetry.reset()
    FG.fused_run.launches = 0
    t0 = time.perf_counter()
    fz.run_segmented(whole, checkpoint_dir=whole_dir, every_n_items=every)
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t0
    whole_save_s = sum(_hist_s("checkpoint_save_seconds",
                               ("copy", "crc", "write", "rename")).values())
    dispatches = telemetry.counter_value("device_dispatch_total", route="segment")
    _require(dispatches == len(runs) and FG.fused_run.launches == 0,
             f"26q: the whole run dispatched {dispatches:g} segment programs and launched "
             f"{FG.fused_run.launches} eager runs")
    graph_kernels = [_graph_kernels(segments.slice_executable(fz, a, b))
                     for a, b in zip(cuts, cuts[1:])]
    _require(graph_kernels == runs, f"26q: the segment graphs hold {graph_kernels} "
             f"fused_run nodes for {runs} runs")

    env = qt.createQuESTEnv(device=dev)
    ref = qt.createQureg(n, env, 1)
    fz.run(ref)  # compiled()'s first call: eager
    timed = qt.createQureg(n, env, 1)
    t0 = time.perf_counter()
    fz.run(timed)  # the first call on these buffers: capture, then replay
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    eager = fz.as_fn()(qt.createQureg(n, env, 1).amps)
    same = {"uninterrupted run_segmented": torch.equal(resumed.amps, whole.amps),
            "Circuit.run": torch.equal(resumed.amps, ref.amps),
            "Circuit.run (graph)": torch.equal(resumed.amps, timed.amps),
            "eager replay (as_fn)": torch.equal(resumed.amps, eager)}
    _require(all(same.values()), f"26q: the resumed state differs: {same}")
    total = qt.calcTotalProb(resumed)
    _require(abs(total - 1) <= 1e-4, f"26q: resumed total probability {total}")
    del eager, ref, timed
    outs = [qt.measure(resumed, t) for t in CKPT_MEASURE]
    outs_whole = [qt.measure(whole, t) for t in CKPT_MEASURE]
    _require(outs == outs_whole, f"26q: measurements {outs} after the resume, "
             f"{outs_whole} after the whole run")
    save_s = sum(save.values())
    row = {"qubits": n, "every_n_items": every, "cuts": cuts, "runs": runs,
           "launches": eager_first + eager_rest, "graph_kernels": sum(graph_kernels),
           "preempted_at": cursor, "snapshot_bytes": nbytes,
           "save_s": save, "save_total_s": save_s, "verify_s": sum(verify.values()),
           "load_s": sum(load.values()), "verify_split_s": verify, "load_split_s": load,
           "preempted_run_s": pre_s, "resume_s": resume_s,
           "segmented_run_ms": whole_s * 1e3, "segmented_saves_ms": whole_save_s * 1e3,
           "circuit_run_ms": run_s * 1e3, "bit_identical": same, "measured": outs,
           "write_mb_per_s_64mib": yard}
    print(f"# checkpoint {n}q f32 saveQureg: {nbytes / 2 ** 20:.1f} MiB in one shard file, "
          f"{save_s:.3f} s (card to host {save['copy']:.3f}, CRC32 {save['crc']:.3f}, "
          f"compress and write {save['write']:.3f}, rename {save['rename']:.4f}); "
          f"{nbytes / 1e6 / save['write']:.1f} MB/s written; on its first 2^23 amplitudes "
          f"the writer {yard['_write_npz']:.1f} MB/s, yardstick np.savez_compressed (one "
          f"zlib stream) {yard['np.savez_compressed']:.1f} MB/s")
    print(f"# checkpoint {n}q f32 verify_snapshot {row['verify_s'] * 1e3:.1f} ms (read "
          f"{verify['read'] * 1e3:.1f}, CRC32 {verify['crc'] * 1e3:.1f}); loadQureg "
          f"{row['load_s'] * 1e3:.1f} ms (read {load['read'] * 1e3:.1f}, CRC32 "
          f"{load['crc'] * 1e3:.1f}, host to card {load['place'] * 1e3:.1f})")
    print(f"# segmented {n}q f32: preempted at cursor {cursor} after {pre_s:.3f} s; resumed "
          f"on a fresh env in {resume_s:.3f} s (seeds restored); the first segment (eager) "
          f"launched the kernel {eager_first} times, the resumed one {eager_rest}; the "
          f"segment graphs hold {graph_kernels} fused_run nodes; resumed state = "
          f"{', '.join(same)}, bit for bit; measure {list(CKPT_MEASURE)} -> {outs} = the "
          f"whole run's; total probability {total:.9f}")
    print(f"# segmented {n}q f32: uninterrupted run_segmented {whole_s * 1e3:.1f} ms "
          f"({whole_save_s * 1e3:.1f} ms of it in {len(runs)} saves, "
          f"{(whole_s - whole_save_s) * 1e3:.1f} ms the rest) against Circuit.run "
          f"{run_s * 1e3:.1f} ms (both the first call on fresh buffers: capture, then "
          f"replay)")
    qt.destroyQureg(resumed)
    qt.destroyQureg(whole)
    return row


def _f32_drift(qt, dev, fz, limit: float | None = 2.0) -> dict:
    """Phase 15, the f32 drift check: the 26q plan run DRIFT_RUNS times in a
    row through the kernel (``Circuit.run``) and through the plain version of
    the same passes, from |0>, |1 - calcTotalProb| after each run; fails if
    the kernel drifts more than ``limit`` times the plain version's way
    (None: only reads it)."""
    import torch

    from quest_tpu_torch import fusion
    from quest_tpu_torch.ops import fused_gates as FG

    n = N_MAIN
    env = qt.createQuESTEnv(device=dev)
    q = qt.createQureg(n, env, 1)
    plain = qt.Qureg(n, False, q.amps.clone(), env)
    items = [_run_item(a[0]) for f, a, _ in fz._tape if f is fusion._apply_pallas_run]
    _require(len(items) == len(fz), "the drift plan holds more than fused runs")
    # where the norm goes: each pass of the first run through the kernel and
    # through the plain version from the same input, the change of
    # sum |amp|^2 in float64 (folded kinds beside it)
    x = q.amps.clone()
    out = torch.empty_like(x)
    passes = []
    for nops, prep, kw in items:
        before = float(torch.linalg.vector_norm(x, dtype=torch.float64) ** 2)
        FG.fused_run(x, n=n, ops=prep.ops, out=out, prepared=prep, **kw)
        ref_x = FG.fused_run_plain(x, prep, n=n, **kw)
        dk = float(torch.linalg.vector_norm(out, dtype=torch.float64) ** 2) - before
        dp = float(torch.linalg.vector_norm(ref_x, dtype=torch.float64) ** 2) - before
        kinds = sorted({o[0] for o in prep.ops} & {"lane_u", "window", "krausn"})
        passes.append({"kernel": dk, "plain": dp, "folds": kinds})
        x, out = out, x
        del ref_x
    del x, out
    folded = [p for p in passes if p["folds"]]
    print(f"# segmented drift {n}q f32 per pass of one run: sum |amp|^2 change kernel / "
          f"plain " + "; ".join(f"{i} {p['kernel']:+.2e} / {p['plain']:+.2e}"
                                 f"{' ' + '+'.join(p['folds']) if p['folds'] else ''}"
                                 for i, p in enumerate(passes))
          + f"; passes with lane_u / window / krausn folds: kernel "
          f"{sum(p['kernel'] for p in folded):+.3e}, plain "
          f"{sum(p['plain'] for p in folded):+.3e}; the others: kernel "
          f"{sum(p['kernel'] for p in passes if not p['folds']):+.3e}, plain "
          f"{sum(p['plain'] for p in passes if not p['folds']):+.3e}")
    kern, ref = [], []
    for _ in range(DRIFT_RUNS):
        fz.run(q)
        for _nops, prep, kw in items:
            plain.amps = FG.fused_run_plain(plain.amps, prep, n=n, **kw)
        torch.cuda.synchronize()
        kern.append(abs(1 - qt.calcTotalProb(q)))
        ref.append(abs(1 - qt.calcTotalProb(plain)))
    diff = (q.amps - plain.amps).abs().max().item()
    ratio = kern[-1] / ref[-1] if ref[-1] else float("inf")
    print(f"# segmented drift {n}q f32: |1 - calcTotalProb| after each of {DRIFT_RUNS} runs: "
          f"kernel {[f'{v:.3e}' for v in kern]}, plain version "
          f"{[f'{v:.3e}' for v in ref]}; after {DRIFT_RUNS} runs kernel / plain "
          f"{ratio:.3f} ({'more' if ratio > 2 else 'not more'} than twice), max |kernel - "
          f"plain| {diff:.3e}")
    # the 3xTF32 folds' truncating accumulation once lost ~1e-5 of norm a
    # run (csrc/mma.cuh): the kernel may drift at most twice the plain
    # version's way
    _require(limit is None or ratio <= limit,
             f"f32 drift after {DRIFT_RUNS} runs: kernel / plain {ratio:.3f} "
             f"(kernel {kern[-1]:.3e}, plain {ref[-1]:.3e}), more than {limit}")
    qt.destroyQureg(q)
    del plain
    torch.cuda.empty_cache()
    return {"runs": DRIFT_RUNS, "kernel": kern, "plain": ref, "ratio": ratio,
            "max_abs_diff": diff, "passes": passes}


def _ckpt_rollback(qt, dev, root: str) -> dict:
    """Phase 15, part 2: 22q f64 under the default sentinels and one
    injected bit flip, healed by replay; then the newest generation's
    payload flipped, and the resume falling back to the one before it."""
    import os

    import torch

    from quest_tpu_torch import fusion, segments, telemetry
    from quest_tpu_torch.ops import fused_gates as FG
    from quest_tpu_torch.resilience import fault_plan, guard, segmented, sentinel_policy

    n, dt = N_CKPT, torch.float64
    circ = qt.Circuit(n)
    qt.random_layers(circ, n, DEPTH_MAIN)
    fz = circ.fused(max_qubits=5, pallas=True, dtype=dt)
    every, cuts, runs = _halves(fz, n, f"{n}q f64")
    env = qt.createQuESTEnv(device=dev)
    telemetry.reset()
    FG.fused_run.launches = 0
    clean = fz.run_segmented(qt.createQureg(n, env, 2),
                             checkpoint_dir=os.path.join(root, "f64_clean"), every_n_items=every)
    launches = FG.fused_run.launches
    _require(launches == sum(runs), f"22q f64: the eager segments launched the kernel "
             f"{launches} times for {sum(runs)} runs")
    heal_dir = os.path.join(root, "f64_heal")
    telemetry.reset()
    t0 = time.perf_counter()
    with sentinel_policy("default"), fault_plan("state.corrupt:bitflip0:1"):
        healed = fz.run_segmented(qt.createQureg(n, env, 2), checkpoint_dir=heal_dir,
                                  every_n_items=every)
    torch.cuda.synchronize()
    heal_s = time.perf_counter() - t0
    replayed = telemetry.counter_value("segmented_rollbacks_total", outcome="replayed")
    breaches = telemetry.counter_value("sentinel_checks_total", kind="norm", outcome="breach")
    _require(replayed == 1 and breaches == 1, f"22q f64: {breaches:g} norm breaches, "
             f"{replayed:g} replayed rollbacks")
    _require(telemetry.counter_total("engine_fallback_total") == 0, "22q f64: a fallback")
    _require(torch.equal(healed.amps, clean.amps), "22q f64: the healed run differs")
    graph_kernels = sum(_graph_kernels(segments.slice_executable(fz, a, b))
                        for a, b in zip(cuts, cuts[1:]))
    _require(graph_kernels == sum(runs), f"22q f64: the segment graphs hold {graph_kernels} "
             f"fused_run nodes for {sum(runs)} runs")
    newest = segmented._gen_dirs(heal_dir)[-1]
    shard = sorted(f for f in os.listdir(newest) if f.endswith(".npz"))[0]
    guard._flip_payload(os.path.join(newest, shard))
    try:
        qt.verify_snapshot(newest)
        caught = None
    except qt.QuESTChecksumError as e:
        caught = e
    _require(caught is not None and caught.shard == shard,
             "22q f64: verify_snapshot passed a flipped payload")
    telemetry.reset()
    resumed = qt.resume_segmented(fz, heal_dir, qt.createQuESTEnv(device=dev))
    skipped = telemetry.counter_value("segmented_resume_total", outcome="skipped_corrupt")
    qt305 = telemetry.counter_value("analysis_findings_total", code="QT305",
                                    severity="warning")
    _require(skipped == 1 and qt305 == 1, f"22q f64: skipped_corrupt {skipped:g}, QT305 "
             f"{qt305:g}")
    _require(torch.equal(resumed.amps, clean.amps), "22q f64: the fallback resume differs")
    print(f"# segmented {n}q f64 rollback: sentinel_policy('default') and "
          f"state.corrupt:bitflip0:1: {breaches:g} norm breach, rolled back to the baseline "
          f"and replayed (segmented_rollbacks_total{{outcome=replayed}} {replayed:g}), healed "
          f"run = the clean run bit for bit in {heal_s:.3f} s; the eager segments launched "
          f"the kernel {launches} times, the graphs hold {graph_kernels} fused_run nodes")
    print(f"# checkpoint {n}q f64: the newest generation's payload flipped -> "
          f"QuESTChecksumError on {caught.shard} (CRC32 {caught.actual_crc:#010x} != "
          f"{caught.expected_crc:#010x}); the resume skipped it (skipped_corrupt "
          f"{skipped:g}, QT305 {qt305:g}) and finished bit for bit from cursor "
          f"{cuts[-2]}")
    for r in (clean, healed, resumed):
        qt.destroyQureg(r)
    return {"qubits": n, "cuts": cuts, "runs": runs, "launches": launches,
            "graph_kernels": graph_kernels, "heal_s": heal_s, "replayed": replayed,
            "skipped_corrupt": skipped}


def _ckpt_sharded(qt, dev, root: str) -> dict:
    """Phase 15, part 3: 22q f32 over N_SHARDS virtual shards: a snapshot of
    one file a shard, loaded on one device and on the shards, and a resume
    bit for bit."""
    import os

    import torch

    from quest_tpu_torch import telemetry
    from quest_tpu_torch.ops import fused_gates as FG

    n, dt = N_CKPT, torch.float32
    circ = qt.Circuit(n)
    qt.random_layers(circ, n, DEPTH_MAIN)
    fz = circ.fused(max_qubits=5, pallas=True, dtype=dt, shard_devices=N_SHARDS)
    every, cuts, runs = _halves(fz, n, f"{n}q f32 over {N_SHARDS} shards")

    def mesh():
        env = qt.createQuESTEnv(devices=[dev] * N_SHARDS)
        qt.seedQuEST(env, list(CKPT_SEEDS))
        return env

    d = os.path.join(root, "shards_pre")
    q = qt.createQureg(n, mesh(), 1)
    telemetry.reset()
    FG.fused_run.launches = 0
    cursor = _preempted(qt, fz, q, d, every)
    launches = FG.fused_run.launches
    _require(launches == runs[0] * N_SHARDS, f"{n}q shards: the first (eager) segment "
             f"launched {launches} shard passes for {runs[0]} runs")
    gen = os.path.join(d, f"gen_{cursor:08d}")
    files = sorted(f for f in os.listdir(gen) if f.endswith(".npz"))
    _require(len(files) == N_SHARDS, f"{n}q shards: the snapshot has {len(files)} files")
    one = qt.loadQureg(gen, qt.createQuESTEnv(device=dev))
    four = qt.loadQureg(gen, mesh())
    same_one = torch.equal(one.amps, torch.cat(q.shards, dim=1))
    same_four = all(torch.equal(a, b) for a, b in zip(four.shards, q.shards))
    _require(same_one and same_four, f"{n}q shards: loaded on one device {same_one}, on "
             f"{N_SHARDS} shards {same_four}")
    for r in (q, one, four):
        qt.destroyQureg(r)
    resumed = qt.resume_segmented(fz, d, mesh())
    whole = fz.run_segmented(qt.createQureg(n, mesh(), 1),
                             checkpoint_dir=os.path.join(root, "shards_whole"),
                             every_n_items=every)
    same = all(torch.equal(a, b) for a, b in zip(resumed.shards, whole.shards))
    _require(same, f"{n}q shards: the resumed state differs from the whole run")
    print(f"# checkpoint {n}q f32 over {N_SHARDS} shards: preempted at cursor {cursor}, "
          f"{len(files)} shard files {files}; loaded on one device and on {N_SHARDS} shards "
          f"= the source bit for bit; the first (eager) segment made {launches} shard "
          f"passes; the resume = the uninterrupted run bit for bit")
    for r in (resumed, whole):
        qt.destroyQureg(r)
    return {"qubits": n, "shards": N_SHARDS, "cuts": cuts, "runs": runs,
            "launches": launches, "files": len(files)}


def _ckpt_density(qt, dev, root: str) -> dict:
    """Phase 15, part 4: a 10-qubit density register, f32 and f64, saved and
    loaded bit for bit, its trace kept."""
    import os

    import torch

    out = {}
    env = qt.createQuESTEnv(device=dev)
    for dt, prec, tol in ((torch.float32, 1, 1e-4), (torch.float64, 2, 1e-10)):
        circ = qt.density_circuit(N_CKPT_DENSITY, True)
        qt.random_layers(circ, N_CKPT_DENSITY, 2)
        q = qt.createDensityQureg(N_CKPT_DENSITY, env, prec)
        circ.fused(max_qubits=4, pallas=True, dtype=dt).run(q)
        d = os.path.join(root, f"density_{str(dt)[6:]}")
        qt.saveQureg(q, d)
        back = qt.loadQureg(d, qt.createQuESTEnv(device=dev))
        trace, trace_back = qt.calcTotalProb(q), qt.calcTotalProb(back)
        _require(back.is_density_matrix and torch.equal(back.amps, q.amps),
                 f"density {dt}: the loaded register differs")
        _require(abs(trace - 1) <= tol and trace_back == trace,
                 f"density {dt}: trace {trace}, loaded {trace_back}")
        print(f"# checkpoint density {N_CKPT_DENSITY}q {str(dt)[6:]}: the bench's r4 channel "
              f"circuit and two random layers, fused; saved and loaded bit for bit, Re "
              f"tr(rho) {trace:.12f} before and after (limit {tol:g})")
        out[str(dt)[6:]] = {"trace": trace}
        qt.destroyQureg(q)
        qt.destroyQureg(back)
    return out


def _checkpoint_segments_phase(qt, dev, plans: dict) -> dict:
    """Phase 15: checkpoints and segmented execution on the card (``#
    checkpoint`` and ``# segmented`` lines; see the module docstring, item
    15). The snapshots go to a temporary directory, removed at the end."""
    import shutil
    import tempfile

    import torch

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="quest_checkpoints_")
    try:
        out = {"main": _ckpt_main(qt, dev, plans[("main", torch.float32)], root)}
        _release()
        out["drift"] = _f32_drift(qt, dev, plans[("main", torch.float32)])
        _release()
        out["rollback"] = _ckpt_rollback(qt, dev, root)
        _release()
        out["sharded"] = _ckpt_sharded(qt, dev, root)
        _release()
        out["density"] = _ckpt_density(qt, dev, root)
        _release()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"# checkpoint and segments phase: {out['phase_s']:.1f} s")
    return out


def _shard_kraus1(name: str, args, nl: int, tb: int):
    """(op, fused_run keywords, column qubit sharded) of a barrier channel's
    kraus1 pass on one shard of the sharded density register, as
    ``ops.density.apply_channel_shards`` places it: its column qubit t + n,
    when sharded, moved into the top local slot (the next one down where
    the row qubit holds it) by a collective permute before the pass."""
    from quest_tpu_torch.ops import density as DN
    from quest_tpu_torch.ops import fused_gates as FG

    rows, ks = _channel_kraus(name, args)
    t, c = rows[0], rows[0] + N_DENSITY
    sharded = c >= nl
    if sharded:
        c = DN.column_slot(nl, t)
    op, swaps = DN.kraus1_pass(N_DENSITY, t, tb, tuple((1.0, FG.HashableMatrix(k)) for k in ks),
                               col=c)
    return op, dict(tile_bits=tb, **swaps), sharded


def _sharded_density_path(qt, dev, rng, dt, with_krausn: bool, one_plan) -> dict:
    """Phase 16, one configuration: the bench's 14q density circuit (r3 or
    r4) on a register sharded over N_SHARDS virtual shards of ``dev`` in
    ``dt``: the plan of ``Circuit.fused(max_qubits=4, pallas=True,
    shard_devices=N_SHARDS)``; each run's pass and each barrier channel's
    kraus1 pass on each shard through the kernel against the plain version
    (with the shard's index); the run with the counts reset just before it
    (launches = (runs + barrier channels) x shards, zero fallbacks, the
    barriers on the kernel route, ``grouped_permute`` = the collective
    transposes + two a barrier whose column qubit is sharded); the gathered
    state against the one-device run of phase 5's plan ``one_plan`` and the
    trace; channel-ops/sec; each collective permute beside its bound."""
    import torch

    from quest_tpu_torch import fusion, telemetry
    from quest_tpu_torch.ops import density as DN
    from quest_tpu_torch.ops import fused_gates as FG
    from quest_tpu_torch.parallel import exchange as X

    f32 = dt == torch.float32
    prec, tol_kernel, tol, tol_trace = (1, 1e-5, 1e-5, 1e-4) if f32 else (2, 1e-12, 1e-12, 1e-10)
    tag = "r4" if with_krausn else "r3"
    label = f"sharded density {tag} {str(dt)[6:]}"
    nsv = 2 * N_DENSITY
    nl = nsv - (N_SHARDS - 1).bit_length()
    steps, t_step = {}, time.perf_counter()

    def step(name):
        nonlocal t_step
        now = time.perf_counter()
        steps[name] = now - t_step
        t_step = now

    itemsize = torch.finfo(dt).bits // 8
    env = qt.createQuESTEnv(devices=[dev] * N_SHARDS)
    circ = qt.density_circuit(N_DENSITY, with_krausn)
    t0 = time.perf_counter()
    fz = circ.fused(max_qubits=4, pallas=True, dtype=dt, shard_devices=N_SHARDS)
    plan_s = time.perf_counter() - t0
    runs = [a[0] for f, a, _ in fz._tape if f is fusion._apply_pallas_run]
    barriers = [(f.__name__, a) for f, a, _ in fz._tape
                if f not in (fusion._apply_pallas_run, fusion._apply_frame_swap)]
    ts = fusion.tape_transpose_stats(fz._tape, nl)
    btb = FG.hopper_tile_bits(nl, dt)
    kraus_passes = [(name, a, *_shard_kraus1(name, a, nl, btb)) for name, a in barriers]
    print(f"# {label}: {N_DENSITY}q density ({nsv} flattened qubits) over {N_SHARDS} shards "
          f"of {dev} (local_n {nl}), {len(circ)} entries -> {len(runs)} fused runs at "
          f"tile_bits {runs[0].tile_bits}, {len(fz._tape) - len(runs) - len(barriers)} frame "
          f"swaps, barrier channels {[f'{n}{a}' for n, a in barriers]} (column qubit sharded: "
          f"{[k[4] for k in kraus_passes]}); transposes {ts['collective_transposes']} "
          f"collective, {ts['local_transposes']} local; planned in {plan_s:.2f} s")
    _require(runs and all(k[4] is not None for k in kraus_passes), f"{label}: plan")

    # each pass on each shard: kernel against plain (the shard's index),
    # timed, on a random state drawn on the card (2^28 host draws took ~15 s)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.randint(2 ** 31)))
    st = [torch.randn((2, 1 << nl), generator=gen, dtype=dt, device=dev)
          for _ in range(N_SHARDS)]
    norm = sum(float((x * x).sum()) for x in st) ** 0.5
    for x in st:
        x /= norm
    out = torch.empty_like(st[0])
    res = {"ms": [], "plain_ms": [], "bound_ms": [], "by_ops": [], "max_abs_err": 0.0,
           "max_rel_err": 0.0, "kinds": set()}
    items = []
    for run in runs:
        kw = dict(tile_bits=run.tile_bits, **_swaps(run.load_swap_k, run.load_swap_hi,
                                                      run.store_swap_k, run.store_swap_hi))
        for k, h in (("load_swap_k", "load_swap_hi"), ("store_swap_k", "store_swap_hi")):
            hi = run.tile_bits if kw[h] is None else kw[h]
            if kw[k] and hi + kw[k] > nl:  # a collective, not in the pass
                kw[k], kw[h] = 0, None
        items.append((run.prepare(), dict(n=nsv, local_n=nl, **kw), True))
    for _name, _a, op, kw, _sh in kraus_passes:
        items.append((FG.PreparedRun((op,), btb), dict(n=nl, **kw), False))
    for i, (prep, kw, roles) in enumerate(items):
        b_bytes, b_ops = _bound_ms(_pass_work(prep, nl, itemsize), f32)
        for r, shard in enumerate(st):
            extra = dict(shard_index=r) if roles else {}
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            ref = FG.fused_run_plain(shard, prep, **kw, **extra)
            e1.record()
            torch.cuda.synchronize()
            ms = _cuda_ms(lambda: FG.fused_run(shard, ops=prep.ops, out=out, prepared=prep,
                                               **kw, **extra), 3)
            err, rel = _rel_err(out, ref)
            del ref
            _require(rel <= tol_kernel, f"{label} pass {i} shard {r}: error {err} ({rel} "
                                        f"relative) > {tol_kernel}")
            res["ms"].append(ms)
            res["plain_ms"].append(e0.elapsed_time(e1))
            res["bound_ms"].append(max(b_bytes, b_ops))
            res["by_ops"].append(b_ops > b_bytes)
            res["max_abs_err"] = max(res["max_abs_err"], err)
            res["max_rel_err"] = max(res["max_rel_err"], rel)
        res["kinds"].update(o[0] for o in prep.ops)
    print(f"# {label} passes: {len(runs)} runs + {len(kraus_passes)} barrier kraus1 passes "
          f"x {N_SHARDS} shards, kinds {sorted(res['kinds'])}: per shard pass "
          f"{sum(res['ms']) / len(res['ms']):.4f} ms mean, bound "
          f"{sum(res['bound_ms']) / len(res['ms']):.4f} ms mean, plain "
          f"{sum(res['plain_ms']) / len(res['ms']):.2f} ms mean; max_abs_err "
          f"{res['max_abs_err']:.3e} ({res['max_rel_err']:.3e} of the largest, limit "
          f"{tol_kernel:g})")
    del st, out
    torch.cuda.empty_cache()
    step("passes")

    # the circuit on the sharded register, counts reset just before it
    q = qt.createDensityQureg(N_DENSITY, env, prec)
    qt.initPlusState(q)
    telemetry.reset()
    FG.fused_run.launches = 0
    fz.run(q)
    torch.cuda.synchronize()
    launches = FG.fused_run.launches
    passes = telemetry.counter_value("pallas_pass_total", kind="fused_run")
    fallbacks = telemetry.counter_total("engine_fallback_total")
    grouped = telemetry.counter_value("exchange_calls_total", kind="grouped_permute")
    routes = {r: telemetry.counter_value("channel_route_total", route=r)
              for r in ("superop", "kernel", "engine")}
    relocated = sum(1 for k in kraus_passes if k[4])
    want = (len(runs) + len(barriers)) * N_SHARDS
    print(f"# {label} run: launches {launches} ((runs {len(runs)} + barrier channels "
          f"{len(barriers)}) x {N_SHARDS} shards), pallas_pass_total{{fused_run}} {passes:g}, "
          f"engine_fallback_total {fallbacks:g}, channel routes {routes}, "
          f"exchange_calls_total{{grouped_permute}} {grouped:g} (collective transposes "
          f"{ts['collective_transposes']} + 2 x {relocated} relocated column qubits)")
    _require(launches == want == passes, f"{label}: launches {launches} != {want}")
    _require(fallbacks == 0, f"{label}: engine fallback")
    _require(routes["kernel"] == len(barriers) and routes["engine"] == routes["superop"] == 0,
             f"{label}: barrier routes {routes}")
    _require(grouped == ts["collective_transposes"] + 2 * relocated,
             f"{label}: collective permutes {grouped}")
    res.update(launches=launches, runs=len(runs), barrier_channels=len(barriers),
               collective_transposes=ts["collective_transposes"],
               relocated_channels=relocated)

    # the gathered state against phase 5's plan run on one device
    one = qt.createQuESTEnv(device=dev)
    ref = qt.createDensityQureg(N_DENSITY, one, prec)
    qt.initPlusState(ref)
    one_plan.run(ref)
    torch.cuda.synchronize()
    gathered = torch.cat(q.shards, dim=1)
    diff, rel = _rel_err(gathered, ref.amps)
    del gathered
    trace, trace_ref = qt.calcTotalProb(q), qt.calcTotalProb(ref)
    print(f"# {label} check: max |sharded - one-device run of phase 5's plan| {diff:.3e} "
          f"({rel:.3e} of the largest, limit {tol:g}); calcTotalProb {trace:.12f} (one "
          f"device {trace_ref:.12f}, limit {tol_trace:g} from 1)")
    _require(rel <= tol, f"{label}: gathered state {diff} ({rel} relative)")
    _require(abs(trace - 1) <= tol_trace, f"{label}: trace {trace}")
    res.update(max_abs_diff_vs_one_device=diff, trace=trace)
    step("run and check")

    # channel-ops/sec, and each collective permute beside its bound
    reps = 3
    _warm_run(fz, q)
    t0 = time.perf_counter()
    for _ in range(reps):
        fz.run(q)
    torch.cuda.synchronize()
    circuit_s = (time.perf_counter() - t0) / reps
    _require(abs(qt.calcTotalProb(q) - 1) <= tol_trace, f"{label}: trace after reps")
    spare = q.shard_spare_buffers()
    bound_perm = 2.0 * 2 * (1 << nsv) * itemsize / HBM_BYTES_PER_S * 1e3
    blocks = sorted({(r.tile_bits - k, r.tile_bits if h is None else h, k)
                     for r in runs for k, h in ((r.load_swap_k, r.load_swap_hi),
                                                (r.store_swap_k, r.store_swap_hi))
                     if k and (r.tile_bits if h is None else h) + k > nl})
    for name, a, op, kw, sh in kraus_passes:
        if sh:
            t = _channel_kraus(name, a)[0][0]
            blocks.append((DN.column_slot(nl, t), t + N_DENSITY, 1))
    perm = []
    for lo, hi, k in sorted(set(blocks)):
        source = list(range(nsv))
        for j in range(k):
            source[lo + j], source[hi + j] = hi + j, lo + j
        ms = _cuda_ms(lambda: X.dist_permute_bits(q.shards, n=nsv, source=source, out=spare), 3)
        perm.append({"block": [lo, hi, k], "ms": ms, "bound_ms": bound_perm})
    copy_ms = _cuda_ms(lambda: spare[0].copy_(q.shards[0]), 10)
    res.update(channel_ops_per_sec=len(circ) / circuit_s, circuit_ms=circuit_s * 1e3,
               permutes=perm, copy_ms=copy_ms)
    print(f"# {label} channel-ops/sec: {len(circ) / circuit_s:.2f} ({len(circ)} entries, "
          f"{circuit_s * 1e3:.3f} ms per circuit; per-shard passes "
          f"{sum(res['ms']):.3f} ms); collective permutes "
          f"{json.dumps([{'block': r['block'], 'ms': round(r['ms'], 4)} for r in perm])} each "
          f"against a bound of {bound_perm:.4f} ms (2 x state bytes / 3.35 TB/s); one "
          f"shard's copy_ {copy_ms:.4f} ms")
    step("timing")
    print(f"# {label}: {sum(steps.values()):.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in steps.items()) + ")")
    q.shard_spares = None
    res.update(qureg=q, ref=ref, seconds=steps)
    return res


def _sharded_density_readouts(qt, dev, q, ref, dt) -> list:
    """Phase 16's readouts of the sharded r4 state ``q`` (``ref``: the same
    state on one device), each against an evaluation from its definition
    in complex128 of the gathered state (limits 1e-4 f32 / 1e-10 f64), each
    call timed on the card's clock."""
    import numpy as np
    import torch

    lim = 1e-4 if dt == torch.float32 else 1e-10
    prec = 1 if dt == torch.float32 else 2
    nd, dim = N_DENSITY, 1 << N_DENSITY
    a = _c128(q.shards)
    kd = torch.arange(dim, device=dev)
    diag = a[kd * dim + kd]
    pure = qt.createQureg(nd, q.env, prec)
    prng = np.random.RandomState(71)
    v = prng.randn(dim) + 1j * prng.randn(dim)
    v /= np.linalg.norm(v)
    qt.initStateFromAmps(pure, v.real, v.imag)
    psi = _c128(pure.shards)
    op = qt.createDiagonalOp(nd, q.env)
    ph = np.linspace(0.0, 3.0, dim)
    qt.initDiagonalOp(op, np.cos(ph), np.sin(ph))
    dop = _c128(op.pieces).to(dev)  # as the op holds them (the global precision's dtype)
    b = _c128([ref.amps])
    work = qt.createDensityQureg(nd, q.env, prec)
    cases = [
        ("calcTotalProb", lambda: qt.calcTotalProb(q), float(diag.real.sum())),
        ("calcPurity", lambda: qt.calcPurity(q), float(a.abs().square().sum())),
        ("calcProbOfOutcome", lambda: qt.calcProbOfOutcome(q, nd - 1, 1),
         float(diag.real[(kd >> (nd - 1)) & 1 == 1].sum())),
        ("calcProbOfAllOutcomes", lambda: qt.calcProbOfAllOutcomes(q, READ_TARGETS_DENSITY),
         _outcomes_ref(diag.real, kd, READ_TARGETS_DENSITY).cpu().numpy()),
        ("calcFidelity", lambda: qt.calcFidelity(q, pure),
         float((psi.conj() * (a.view(dim, dim).T @ psi)).sum().real)),
        ("calcExpecPauliProd", lambda: qt.calcExpecPauliProd(q, *READ_PROD_DENSITY, work),
         _pauli_trace_ref(a, dim, kd, *READ_PROD_DENSITY)),
        ("calcDensityInnerProduct", lambda: qt.calcDensityInnerProduct(q, ref),
         float((a.conj() * b).sum().real)),
        ("calcHilbertSchmidtDistance", lambda: qt.calcHilbertSchmidtDistance(q, ref),
         float((a - b).abs().square().sum().sqrt())),
        ("getDensityAmp", lambda: qt.getDensityAmp(q, 5, dim - 3),
         complex(a[(dim - 3) * dim + 5].item())),
        ("calcExpecDiagonalOp", lambda: qt.calcExpecDiagonalOp(q, op),
         complex((diag * dop).sum().item())),
    ]
    del b
    rows = []
    for fn, call, want in cases:
        got = call()
        torch.cuda.synchronize()
        err = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
        _require(err <= lim, f"sharded density readout {fn} {dt}: {got} against {want}, "
                             f"error {err} > {lim}")
        ms = _clock_ms(call, 3)
        rows.append({"function": fn, "error": err, "ms": ms})
        print(f"# sharded density readout {fn} {str(dt)[6:]}: error {err:.3e} (limit "
              f"{lim:g}) against the complex128 evaluation, {ms:.4f} ms")
    for x in (pure, work):
        qt.destroyQureg(x)
    del a, diag, psi
    torch.cuda.empty_cache()
    return rows


def _sharded_density_phase(qt, dev, plans: dict) -> dict:
    """Phase 16: the bench's 14q density circuits r3 and r4 over N_SHARDS
    virtual shards of ``dev``, f32 then f64 (``_sharded_density_path``, held
    against phase 5's one-device plans ``plans[(dt, tag)]``), and the r4
    state's readouts (``_sharded_density_readouts``)."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    rng = np.random.RandomState(83)
    out = {}
    for ddt in (torch.float32, torch.float64):
        for tag, with_krausn in (("r3", False), ("r4", True)):
            r = _sharded_density_path(qt, dev, rng, ddt, with_krausn, plans[(ddt, tag)])
            q, ref = r.pop("qureg"), r.pop("ref")
            if tag == "r4":
                r["readouts"] = _sharded_density_readouts(qt, dev, q, ref, ddt)
            qt.destroyQureg(q)
            qt.destroyQureg(ref)
            out[(ddt, tag)] = r
            _release()
    out["phase_s"] = time.perf_counter() - t0
    print(f"# sharded density phase: {out['phase_s']:.1f} s")
    return out


def _sharded_density_entries(entries: list, phase: dict) -> None:
    """Phase 16's paths in the per-shard kernel's ``kernels`` entries, each
    driven with the counts reset just before it."""
    import torch

    for e, ddt in ((entries[4], torch.float32), (entries[5], torch.float64)):
        for tag in ("r3", "r4"):
            r = phase[(ddt, tag)]
            n = len(r["ms"])
            e.setdefault("sharded_density_paths", {})[f"density_{N_DENSITY}q_{tag}"] = {
                "launches": r["launches"], "runs": r["runs"],
                "barrier_channels": r["barrier_channels"], "shards": N_SHARDS,
                "ms": sum(r["ms"]) / n, "bound_ms": sum(r["bound_ms"]) / n,
                "plain_ms": sum(r["plain_ms"]) / n, "max_abs_err": r["max_abs_err"],
                "channel_ops_per_sec": r["channel_ops_per_sec"],
                "circuit_ms": r["circuit_ms"], "collective_permutes": r["permutes"],
                "copy_one_shard_ms": r["copy_ms"],
                "max_abs_diff_vs_one_device": r["max_abs_diff_vs_one_device"],
                "readouts": r.get("readouts")}
            e["launches"] += r["launches"]
            e["max_abs_err"] = max(e["max_abs_err"], r["max_abs_err"])


def _checkpoint_entries(entries: list, phase: dict) -> None:
    """Phase 15's paths in the ``kernels`` entries, each counted from its
    eager segments (the counts reset just before them), with the fused_run
    nodes of its segment graphs: the 26q f32 main path in
    ``fused_gate_run``, the 22q f64 rollback in ``fused_gate_run_f64``, the
    22q sharded run in ``fused_gate_run_per_shard``."""
    m, rb, sh = phase["main"], phase["rollback"], phase["sharded"]
    add = ((entries[0], "segmented_26q_depth8", m),
           (entries[1], "segmented_rollback_22q_f64", rb))
    for e, key, r in add:
        e["paths"][key] = {k: r[k] for k in ("launches", "graph_kernels", "runs", "cuts")}
        e["launches"] += r["launches"]
        e["graph_kernels"] = e.get("graph_kernels", 0) + r["graph_kernels"]
    entries[0]["checkpoint"] = {k: v for k, v in m.items() if k not in ("cuts", "runs")}
    entries[0]["f32_drift"] = phase["drift"]
    entries[4].setdefault("segmented_paths", {})[f"segmented_{N_CKPT}q_shards"] = sh
    entries[4]["launches"] += sh["launches"]


def _sampling_gradients_entries(entries: list, samp_grad: dict) -> None:
    """Phase 13's paths in the f32 and f64 ``kernels`` entries: each
    request's, gradient's and engine's first (eager) call, its counts reset
    just before it, launches the kernel once a run (a lane_u block), and its
    graph holds as many fused_run nodes; beside them the phase's numbers."""
    import torch

    samp, grads = samp_grad["sampling"], samp_grad["gradients"]
    for e, ddt in zip(entries, (torch.float32, torch.float64)):
        reqs = [v for k, v in samp.items() if k[0] == ddt and len(k) == 3]
        paths = {
            "sampling_request_26q_depth8": {
                "launches": sum(r["launches"] for r in reqs),
                "graph_kernels": sum(r["graph_kernels"] for r in reqs),
                "runs": reqs[0]["runs"], "requests": len(reqs)},
            "sampling_engine_serve_20q": {
                k: samp[(ddt, "engine")][k] for k in ("launches", "graph_kernels", "runs")},
            "gradient_fused_20q": {
                k: grads[(ddt, "fused")][k] for k in ("launches", "graph_kernels")},
            "gradient_fused_26q": {
                k: grads[(ddt, "full")][k] for k in ("launches", "graph_kernels")},
            "gradient_engine_fused_20q": {
                k: grads[(ddt, "engine", "fused")][k] for k in ("launches", "graph_kernels")},
        }
        for k, v in paths.items():
            e["paths"][k] = v
            e["launches"] += v["launches"]
            e["graph_kernels"] = e.get("graph_kernels", 0) + v["graph_kernels"]
        e["sampling"] = {f"{k[1]}_targets_{k[2]}_shots": {
            f: v for f, v in samp[k].items() if f not in ("launches", "runs")}
            for k in samp if k[0] == ddt and len(k) == 3}
        e["sampling"]["mid_measurement_20q"] = samp[(ddt, "mid")]
        e["sampling"]["engine_serve_20q"] = samp[(ddt, "engine")]
        e["gradients"] = {
            "serve_20q_raw": {k: v for k, v in grads[(ddt, "raw")].items() if k != "out"},
            "serve_20q_fused": {k: v for k, v in grads[(ddt, "fused")].items() if k != "out"},
            "serving_ansatz_26q_2": {k: v for k, v in grads[(ddt, "full")].items()
                                     if k != "out"},
            "engine_raw": grads[(ddt, "engine", "raw")],
            "engine_fused": grads[(ddt, "engine", "fused")]}
    entries[1]["gradients"]["parameter_shift_20q_1"] = grads["shift"]


#: phase 17: the sharded qubit of its mid-circuit measurement (the top of
#: MID_MEASURE's width, at or above the shard boundary), the requests of its
#: gradient Engine and of its density Engine, and the limits its checks
#: hold, f32 / f64
MID_SHARDED = MID_MEASURE[0] - 1
#: the gradient Engine's ansatz over shards (GRAD_ANSATZ's 20 qubits, its
#: depth cut from 4 to 2 for the phase's time: at depth 4 the build of its
#: 160-slot program took 10-15 s a precision) and its requests
GRAD_SHARDED_ENGINE, GRAD_SHARDED_REQUESTS = (GRAD_ANSATZ[0], 2), 4
#: the density Engine's requests, f32 / f64: the batch's states stay on the
#: card while a one-device Engine serves the same stream, and eight f64
#: states (4 GiB each) beside that Engine's buffers and graph pool did not
#: fit the card's 80 GB
SERVE_DENSITY_REQUESTS = {"float32": 8, "float64": 4}
PHASE17_TOL = {"float32": 1e-5, "float64": 1e-12}


def _density_serving_circuit(qt):
    """The bench's 14q r3 density circuit with a Param rotation after each
    of its four Hadamards (``rotateY(q, P("t{q}"))``): the structure the
    phase's density Engine serves with each request's angles."""
    from quest_tpu_torch.engine import P

    base = qt.density_circuit(N_DENSITY, False)
    circ = qt.Circuit(N_DENSITY, is_density_matrix=True)
    for i, (f, a, kw) in enumerate(base._tape):
        circ.append(f, *a, **kw)
        if i < 4:
            circ.rotateY(i, P(f"t{i}"))
    return circ


def _sharded_sampling(qt, dev, plans: dict, one: dict) -> dict:
    """Phase 17, sampling over shards (``# sharded sampling`` lines):
    ``sample_request`` on the sharded path's 26q plans (f32, f64), over
    every qubit and over SAMPLE_SUBSET (qubit 25 sharded), at each of
    SAMPLE_SHOTS; then applyMidMeasurement over the shards on a local and
    a sharded qubit against one device. ``one``: phase 13's sampling
    results, for the one-device ms a request."""
    import numpy as np
    import torch
    from scipy.stats import chi2 as chi2_dist

    from quest_tpu_torch import fusion, telemetry
    from quest_tpu_torch.ops import fused_gates as FG
    from quest_tpu_torch.ops import measure as M
    from quest_tpu_torch.sampling import sampler as sp
    from quest_tpu_torch.sampling.request import sample_request

    card = _card_line()
    env = qt.createQuESTEnv(devices=[dev] * N_SHARDS)
    env1 = qt.createQuESTEnv(device=dev)
    seed_t = torch.tensor(SAMPLE_SEED, dtype=torch.int64, device=dev)
    out: dict = {}
    for dt in (torch.float32, torch.float64):
        name, prec = str(dt)[6:], (1 if dt == torch.float32 else 2)
        fz = plans[("sharded", dt)]
        runs = sum(f is fusion._apply_pallas_run for f, _, _ in fz._tape)
        zs = list(qt.createQureg(N_MAIN, env, prec).shards)
        shard_bytes = zs[0].numel() * zs[0].element_size()
        state = fz.compiled_request(donate=False)(zs)
        host = [s.cpu() for s in state]
        cpu_tables: dict = {}
        for targets in (tuple(range(N_MAIN)), SAMPLE_SUBSET):
            t = len(targets)
            for shots in SAMPLE_SHOTS:
                exe = sample_request(fz, targets=targets, shots=shots, donate=False)
                telemetry.reset()
                FG.fused_run.launches = 0
                got = exe(zs, seed_t)["shots"]
                torch.cuda.synchronize(dev)
                launches = FG.fused_run.launches
                dispatches = telemetry.counter_value("device_dispatch_total", route="request")
                fallbacks = telemetry.counter_total("engine_fallback_total")
                _require(launches == runs * N_SHARDS and dispatches == 1 and fallbacks == 0,
                         f"sharded sampling {name} {t}q {shots}: the eager request launched the "
                         f"kernel {launches} times for {runs} runs x {N_SHARDS} shards, in "
                         f"{dispatches:g} dispatches, {fallbacks:g} fallbacks")
                again = exe(zs, seed_t)["shots"]  # captures the request's graph
                graph_kernels = _graph_kernels(exe)
                _require(graph_kernels == runs * N_SHARDS,
                         f"sharded sampling {name} {t}q: the request's graph holds "
                         f"{graph_kernels} fused_run nodes, for {runs} runs x {N_SHARDS}")
                _require(torch.equal(got, again) and int(got.min()) >= 0
                         and int(got.max()) < (1 << t),
                         f"sharded sampling {name} {t}q {shots}: a shot out of range, or a "
                         "replay that differs from the eager request")
                # the shot stage alone on the request's final shards: its
                # table, and the rise of the card's peak memory during it
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                base_mem = torch.cuda.memory_allocated(dev)
                stage = sp.sample_statevec(state, n=N_MAIN, targets=targets, shots=shots,
                                           seed=seed_t)
                torch.cuda.synchronize(dev)
                rise = torch.cuda.max_memory_allocated(dev) - base_mem
                _require(torch.equal(stage, got), f"sharded sampling {name} {t}q {shots}: the "
                                                  "shot stage on the final shards differs")
                _require(rise < shard_bytes,
                         f"sharded sampling {name} {t}q {shots}: the shot stage raised the "
                         f"card's peak memory by {rise} bytes, one shard holds {shard_bytes}")
                # the CPU's sharded sampler on the same shards, bit for bit.
                # Over every qubit it takes ~4 s on the host, so it runs once
                # a target set, at the most shots: a shot's draw depends on
                # its counter alone, so a table of fewer shots is that
                # table's first shots
                key = (dt, t)
                if key not in cpu_tables:
                    cpu_tables[key] = sp.sample_statevec(
                        host, n=N_MAIN, targets=targets, shots=max(SAMPLE_SHOTS),
                        seed=SAMPLE_SEED)
                cpu = cpu_tables[key][:shots]
                _require(torch.equal(cpu, got.cpu()),
                         f"sharded sampling {name} {t}q {shots}: the card's table differs from "
                         f"the CPU's sharded sampler on the same shards in "
                         f"{int((cpu != got.cpu()).sum())} shots")
                chi = None
                if t < N_MAIN and shots == max(SAMPLE_SHOTS):
                    exact = M.prob_of_all_outcomes_shards(
                        [s.double() for s in state], n=N_MAIN, targets=targets).cpu().numpy()
                    emp = np.bincount(got.cpu().numpy(), minlength=1 << t).astype(np.float64)
                    exp = shots * exact / exact.sum()
                    live = exp > 0
                    stat = float(np.sum((emp[live] - exp[live]) ** 2 / exp[live]))
                    dof = int(live.sum()) - 1
                    chi = (stat, float(chi2_dist.sf(stat, dof)), dof)
                    _require(chi[1] >= 1e-6 and emp[~live].sum() == 0,
                             f"sharded sampling {name}: chi-square {stat:.1f} over {dof} dof, "
                             f"p-value {chi[1]:.3g} < 1e-6, or a shot of probability 0")
                ms = _cuda_ms(lambda: exe(zs, seed_t), 3)
                one_ms = one.get((dt, t, shots), {}).get("ms")
                out[(dt, t, shots)] = {
                    "launches": launches, "runs": runs, "graph_kernels": graph_kernels,
                    "ms": ms, "one_device_ms": one_ms, "shot_stage_peak_rise_bytes": rise,
                    "shard_bytes": shard_bytes, "chi2": chi}
                print(f"# sharded sampling {name} {N_MAIN}q depth {DEPTH_MAIN} over {N_SHARDS} "
                      f"shards, {t} targets, {shots} shots: the eager request launched the "
                      f"kernel {launches} times (runs {runs} x {N_SHARDS}), 0 fallbacks, its graph "
                      f"holds {graph_kernels} fused_run nodes; shots in range, = the shot stage "
                      f"on the final shards, = the CPU's sharded sampler on the same shards bit "
                      f"for bit" + (f"; chi-square {chi[0]:.1f} ({chi[2]} dof, p-value "
                                    f"{chi[1]:.3g})" if chi else "")
                      + f"; the shot stage raised peak memory by {rise / 2 ** 20:.1f} MiB (one "
                        f"shard {shard_bytes / 2 ** 20:.0f} MiB); {ms:.3f} ms a request against "
                        f"{one_ms if one_ms is None else round(one_ms, 3)} ms on one device "
                        f"(phase 13) [{card}]")
                del exe, got, again, stage, cpu
        del zs, state, host, cpu_tables
        _release()

        # a mid-circuit measurement on a local and on a sharded qubit
        n, depth, mq = MID_MEASURE
        tol = PHASE17_TOL[name]
        for target in (mq, MID_SHARDED):
            c = qt.Circuit(n)
            qt.random_layers(c, n, depth)
            c.applyMidMeasurement(target, SAMPLE_SEED, site=1)
            for q in range(3):
                c.hadamard(q)
            sh_plan = c.fused(max_qubits=5, pallas=True, dtype=dt, shard_devices=N_SHARDS)
            one_plan = c.fused(max_qubits=5, pallas=True, dtype=dt)
            sh_runs = sum(f is fusion._apply_pallas_run for f, _, _ in sh_plan._tape)
            qs, q1 = qt.createQureg(n, env, prec), qt.createQureg(n, env1, prec)
            telemetry.reset()
            FG.fused_run.launches = 0
            sh_plan.run(qs)
            torch.cuda.synchronize(dev)
            launches = FG.fused_run.launches
            fallbacks = telemetry.counter_total("engine_fallback_total")
            one_plan.run(q1)
            p_sh, p_one = qt.calcProbOfOutcome(qs, target, 1), qt.calcProbOfOutcome(q1, target, 1)
            diff, rel = _rel_err(torch.cat(qs.shards, dim=1), q1.amps)
            sharded = target >= qs.num_local_qubits
            _require(launches == sh_runs * N_SHARDS and fallbacks == 0,
                     f"sharded mid-circuit {name} qubit {target}: {launches} launches for "
                     f"{sh_runs} runs x {N_SHARDS}, {fallbacks:g} fallbacks")
            _require(round(p_sh) == round(p_one) and abs(p_sh - round(p_sh)) <= 1e-4
                     and rel <= tol,
                     f"sharded mid-circuit {name} qubit {target}: outcome P(1) {p_sh} against "
                     f"{p_one} on one device, state {rel:.3e} of the largest amplitude "
                     f"(limit {tol:g})")
            out[(dt, "mid", target)] = {"launches": launches, "runs": sh_runs,
                                        "outcome": int(round(p_sh)), "max_rel_diff": rel,
                                        "sharded_qubit": sharded}
            print(f"# sharded sampling {name} mid-circuit measurement: {n}q "
                  f"random_layers({depth}) over {N_SHARDS} shards, applyMidMeasurement on "
                  f"qubit {target} ({'sharded' if sharded else 'local'}), {sh_runs} runs: "
                  f"{launches} launches, 0 fallbacks; outcome {int(round(p_sh))} as on one "
                  f"device, the state within {rel:.3e} of the largest amplitude of the "
                  f"one-device run (limit {tol:g}) [{card}]")
            del qs, q1
        _release()
    return out


def _sharded_gradients(qt, dev, one: dict) -> dict:
    """Phase 17, gradients over shards (``# sharded gradients`` lines):
    ``serving_ansatz(26, 2)`` fused (the circuit of phase 13's full-width
    gradient) differentiated on N_SHARDS virtual shards, f32 and f64,
    against phase 13's one-device gradients ``one``; then
    ``Engine.submit_grad`` on the shards at GRAD_SHARDED_ENGINE against
    one-device ``Circuit.gradient``."""
    import numpy as np
    import torch

    from quest_tpu_torch import telemetry
    from quest_tpu_torch.engine import Engine
    from quest_tpu_torch.ops import fused_gates as FG

    card = _card_line()
    env = qt.createQuESTEnv(devices=[dev] * N_SHARDS)
    env1 = qt.createQuESTEnv(device=dev)
    out: dict = {}

    def params(circ, seed):
        r = np.random.RandomState(seed)
        return dict(zip(circ.param_names, r.uniform(0, 2 * np.pi, len(circ.param_names))))

    steps, t_step = {}, time.perf_counter()

    def step(what):
        nonlocal t_step
        now = time.perf_counter()
        steps[what] = round(now - t_step, 2)
        t_step = now

    n26, depth26 = GRAD_FULL
    hamil26 = tfim_hamil(qt, n26, 2026)
    circ26 = qt.serving_ansatz(n26, depth26).fused(max_qubits=5)
    prm26 = params(circ26, 26)
    for dt, gtol in ((torch.float32, 1e-5), (torch.float64, 1e-10)):
        name, prec = str(dt)[6:], (1 if dt == torch.float32 else 2)
        ref = one[(dt, "full")]["out"]
        zs = list(qt.createQureg(n26, env, prec).shards)
        gx = circ26.gradient(hamil26, donate=False, dtype=dt)
        telemetry.reset()
        FG.fused_run.launches = 0
        t0 = time.perf_counter()
        first = gx(zs, prm26)
        torch.cuda.synchronize(dev)
        cold_s = time.perf_counter() - t0
        launches = FG.fused_run.launches
        res = gx(zs, prm26)  # the capture
        same = torch.equal(first["value"], res["value"]) and all(
            torch.equal(first["grads"][k], res["grads"][k]) for k in res["grads"])
        _require(same, f"sharded gradients {name}: the graph replay differs from the eager run")
        cap_s, cap_b = gx.captures[-1] if gx.captures else (0.0, 0)
        ms = _clock_ms(lambda: gx(zs, prm26), 1)  # one replay of the captured graph
        gmax = _grad_max(ref)
        err = max(abs(float(res["grads"][k]) - float(ref["grads"][k])) for k in ref["grads"])
        dv = abs(float(res["value"]) - float(ref["value"]))
        _require(err <= gtol * gmax and dv <= (1e-4 if dt == torch.float32 else 1e-10),
                 f"sharded gradients {name}: grads {err:.3e} from one device's ({err / gmax:.3e} "
                 f"of the largest |g|, limit {gtol:g}), value {dv:.3e}")
        out[(dt, "full")] = {
            "launches": launches, "slots": gx.num_slots, "value": float(res["value"]),
            "one_device_value": float(ref["value"]), "max_rel_grad_diff": err / gmax,
            "ms": ms, "one_device_ms": one[(dt, "full")]["ms"], "cold_s": cold_s,
            "capture_s": cap_s, "capture_mib": cap_b / 2 ** 20}
        print(f"# sharded gradients {name} serving_ansatz({n26}, {depth26}) fused over "
              f"{N_SHARDS} shards: {gx.num_slots} slots, TFIM {hamil26.num_sum_terms} terms; value "
              f"{float(res['value']):.12f} (one device {float(ref['value']):.12f}); grads within "
              f"{err / gmax:.3e} of the largest |g| of phase 13's one-device gradient (limit "
              f"{gtol:g}); {launches} kernel launches (the dense blocks on the engine over "
              f"shards); {ms:.2f} ms a gradient against {one[(dt, 'full')]['ms']:.2f} ms on one "
              f"device; cold {cold_s:.2f} s, capture {cap_s:.2f} s, the graph holds "
              f"{cap_b / 2 ** 20:.1f} MiB [{card}]")
        del zs, gx, first, res
        _release()
        step(f"{n26}q {name}")

    n, depth = GRAD_SHARDED_ENGINE
    hamil = tfim_hamil(qt, n, 2020)
    raw = qt.serving_ansatz(n, depth)
    sweep = [params(raw, 300 + i) for i in range(GRAD_SHARDED_REQUESTS)]
    for dt, tol in ((torch.float32, 2e-4), (torch.float64, 1e-10)):
        name, prec = str(dt)[6:], (1 if dt == torch.float32 else 2)
        eng = Engine(raw, env, precision_code=prec, max_batch=GRAD_SHARDED_REQUESTS,
                     max_delay_ms=20.0, hamiltonian=hamil)
        # the first pass builds (an eager request, then the capture), the
        # second only replays; the counts are read over the first pass
        telemetry.reset()
        FG.fused_run.launches = 0
        first = [f.result(600) for f in [eng.submit_grad(p) for p in sweep]]
        torch.cuda.synchronize(dev)
        launches = FG.fused_run.launches
        fallbacks = telemetry.counter_total("engine_fallback_total")
        _require(fallbacks == 0, f"sharded gradients {name} engine: {fallbacks:g} fallbacks")
        t0 = time.perf_counter()
        got = [f.result(600) for f in [eng.submit_grad(p) for p in sweep]]
        batch_s = time.perf_counter() - t0
        eng.close(timeout=600)
        _require(all(torch.equal(a[0], b[0]) for a, b in zip(first, got)),
                 f"sharded gradients {name} engine: a replayed request differs from its build")
        step(f"engine {name}")
        gx = raw.gradient(hamil, donate=False, dtype=dt)
        zero = qt.createQureg(n, env1, prec).amps
        refs = [gx(zero, p) for p in sweep]
        err = max(abs(float(g[k]) - float(r["grads"][k])) / _grad_max(r)
                  for (_, g), r in zip(got, refs) for k in g)
        dv = max(abs(float(v) - float(r["value"])) for (v, _), r in zip(got, refs))
        _require(err <= tol, f"sharded gradients {name} engine: {err:.3e} of the largest |g| "
                             f"from one device (limit {tol:g})")
        out[(dt, "engine")] = {"requests": len(sweep), "requests_per_s": len(sweep) / batch_s,
                               "max_rel_err": err, "max_value_diff": dv, "launches": launches}
        step(f"one device {name}")
        print(f"# sharded gradients {name} engine: serving_ansatz({n}, {depth}) over "
              f"{N_SHARDS} shards, {len(sweep)} submit_grad requests in sequence: within "
              f"{err:.3e} of the largest |g| of one-device Circuit.gradient (limit {tol:g}), "
              f"values within {dv:.3e}; {launches} kernel launches in the first pass, 0 "
              f"fallbacks; {len(sweep) / batch_s:.2f} requests/s warm; seconds "
              f"{steps} [{card}]")
        del zero, gx, refs, got, first
        _release()
    out["seconds"] = steps
    return out


def _sharded_serving(qt, dev) -> dict:
    """Phase 17, density serving over shards (``# sharded serving`` lines):
    ``_density_serving_circuit`` planned for N_SHARDS shards, served by an
    Engine on the shards (a batch of SERVE_DENSITY_REQUESTS equal to a loop
    of single requests bit for bit, launches = (runs + barrier channels) x
    shards, zero fallbacks), held against a one-device Engine over the
    one-device plan, and the same stream through a one-replica
    EnginePool."""
    import numpy as np
    import torch

    from quest_tpu_torch import fusion, telemetry
    from quest_tpu_torch.engine import Engine
    from quest_tpu_torch.ops import fused_gates as FG

    card = _card_line()
    env = qt.createQuESTEnv(devices=[dev] * N_SHARDS)
    env1 = qt.createQuESTEnv(device=dev)
    circ = _density_serving_circuit(qt)
    r = np.random.RandomState(2017)
    stream = [dict(zip(circ.param_names, r.uniform(0, 2 * np.pi, len(circ.param_names))))
              for _ in range(max(SERVE_DENSITY_REQUESTS.values()))]
    out: dict = {}
    for dt in (torch.float32, torch.float64):
        name, prec = str(dt)[6:], (1 if dt == torch.float32 else 2)
        tol = PHASE17_TOL[name]
        sweep = stream[:SERVE_DENSITY_REQUESTS[name]]
        steps, t_step = {}, time.perf_counter()

        def step(what):
            nonlocal t_step
            now = time.perf_counter()
            steps[what] = round(now - t_step, 2)
            t_step = now

        torch.cuda.reset_peak_memory_stats(dev)
        sh_plan = circ.fused(max_qubits=4, pallas=True, dtype=dt, shard_devices=N_SHARDS)
        one_plan = circ.fused(max_qubits=4, pallas=True, dtype=dt)
        runs = sum(f is fusion._apply_pallas_run for f, _, _ in sh_plan._tape)
        chans = sum(getattr(f, "__name__", "").startswith("mix") for f, _, _ in sh_plan._tape)
        eng = Engine(sh_plan, env, precision_code=prec, max_batch=len(sweep),
                     max_delay_ms=50.0)
        step("plan")
        telemetry.reset()
        FG.fused_run.launches = 0
        first = eng.run(sweep[0], 600)
        torch.cuda.synchronize(dev)
        launches = FG.fused_run.launches
        fallbacks = telemetry.counter_total("engine_fallback_total")
        want = (runs + chans) * N_SHARDS
        _require(launches == want and fallbacks == 0,
                 f"sharded serving {name}: the first request launched the kernel {launches} "
                 f"times for (runs {runs} + barrier channels {chans}) x {N_SHARDS}, "
                 f"{fallbacks:g} fallbacks")
        del first
        eng.run(sweep[0], 600)  # the capture
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        batch = [f.result(600) for f in eng.submit_many(sweep)]
        torch.cuda.synchronize(dev)
        batch_s = time.perf_counter() - t0
        same = True
        for p, b in zip(sweep, batch):
            single = eng.run(p, 600)
            same &= all(torch.equal(x, y) for x, y in zip(b, single))
            del single
        eng.close(timeout=600)
        del eng
        _release()  # the batch's states stay; the engine's buffers and graphs go
        step("sharded engine")
        _require(same, f"sharded serving {name}: a batch differs from a loop of single "
                       "requests")
        one = Engine(one_plan, env1, precision_code=prec, max_batch=1)
        one.run(sweep[0], 600)
        one.run(sweep[0], 600)
        torch.cuda.synchronize(dev)
        err, one_s = 0.0, 0.0
        for p, b in zip(sweep, batch):
            t0 = time.perf_counter()
            ref = one.run(p, 600)
            torch.cuda.synchronize(dev)
            one_s += time.perf_counter() - t0
            err = max(err, _rel_err(torch.cat(b, dim=1), ref)[1])
            del ref
        one.close(timeout=600)
        del one
        _release()
        step("one-device engine")
        _require(err <= tol, f"sharded serving {name}: {err:.3e} of the largest entry from the "
                             f"one-device Engine (limit {tol:g})")
        pool = qt.EnginePool(env, replicas=1, precision_code=prec, max_batch=1)
        try:
            t0 = time.perf_counter()
            pooled = True
            for p, b in zip(sweep, batch):
                got = pool.submit(sh_plan, p, timeout=600).result(600)
                pooled &= all(torch.equal(x, y) for x, y in zip(b, got))
                del got
            pool_s = time.perf_counter() - t0
        finally:
            pool.close()
        _require(pooled, f"sharded serving {name}: the pool's states differ from the Engine's")
        step("pool")
        peak = torch.cuda.max_memory_allocated(dev)
        nreq = len(sweep)
        out[dt] = {"launches": launches, "runs": runs, "barrier_channels": chans,
                   "requests": nreq, "requests_per_s": nreq / batch_s,
                   "one_device_requests_per_s": nreq / one_s, "pool_requests_per_s":
                   nreq / pool_s, "max_rel_diff_vs_one_device": err,
                   "peak_memory_gib": peak / 2 ** 30, "seconds": steps}
        print(f"# sharded serving {name}: {N_DENSITY}q r3 density circuit with 4 Param "
              f"rotations over {N_SHARDS} shards ({runs} runs, {chans} barrier channels): the "
              f"first request launched the kernel {launches} times, 0 fallbacks; a batch of "
              f"{nreq} = a loop of single requests bit for bit, within {err:.3e} of the largest "
              f"entry of the one-device Engine (limit {tol:g}); {nreq / batch_s:.2f} requests/s "
              f"against {nreq / one_s:.2f} on one device; a one-replica EnginePool "
              f"{nreq / pool_s:.2f} requests/s, its states = the Engine's; the card's peak "
              f"memory {peak / 2 ** 30:.1f} GiB (the batch's {nreq} states held); seconds "
              f"{steps} [{card}]")
        del batch
        _release()
    return out


def _sharded_serving_phase(qt, dev, plans: dict, samp_grad: dict) -> dict:
    """Phase 17: sampling, mid-circuit measurement, gradients and serving
    over N_SHARDS virtual shards of ``dev`` (``# sharded sampling``, ``#
    sharded gradients``, ``# sharded serving`` lines), each held against
    phase 13's one-device runs or a one-device run of its own."""
    t0 = time.perf_counter()
    out = {"sampling": _sharded_sampling(qt, dev, plans, samp_grad["sampling"])}
    out["sampling_s"] = time.perf_counter() - t0
    out["gradients"] = _sharded_gradients(qt, dev, samp_grad["gradients"])
    out["gradients_s"] = time.perf_counter() - t0 - out["sampling_s"]
    out["serving"] = _sharded_serving(qt, dev)
    out["phase_s"] = time.perf_counter() - t0
    out["serving_s"] = out["phase_s"] - out["sampling_s"] - out["gradients_s"]
    print(f"# sharded serving phase: {out['phase_s']:.1f} s (sampling {out['sampling_s']:.1f} "
          f"s, gradients {out['gradients_s']:.1f} s, serving {out['serving_s']:.1f} s)")
    return out


def _sharded_serving_entries(entries: list, phase: dict) -> None:
    """Phase 17's paths in the per-shard kernel's ``kernels`` entries, each
    counted from its first (eager) call with the counts reset just before
    it: every sampling request and mid-circuit measurement launches the
    kernel once a run a shard, the density Engine once a run and a barrier
    channel a shard; the gradient paths' counts as read over their first
    pass (they run on the engine over shards, which launches no kernel)."""
    import torch

    samp, grads, serve = phase["sampling"], phase["gradients"], phase["serving"]
    for e, ddt in ((entries[4], torch.float32), (entries[5], torch.float64)):
        reqs = {f"request_{k[1]}_targets_{k[2]}_shots": v for k, v in samp.items()
                if k[0] == ddt and k[1] != "mid"}
        mids = {f"mid_measurement_{MID_MEASURE[0]}q_qubit_{k[2]}": v for k, v in samp.items()
                if k[0] == ddt and k[1] == "mid"}
        e["sharded_sampling_paths"] = dict(reqs, **mids)
        e["sharded_gradient_paths"] = {
            f"serving_ansatz_{GRAD_FULL[0]}q_{GRAD_FULL[1]}": grads[(ddt, "full")],
            f"engine_submit_grad_{GRAD_SHARDED_ENGINE[0]}q_{GRAD_SHARDED_ENGINE[1]}":
                grads[(ddt, "engine")]}
        e["sharded_serving_paths"] = {f"density_{N_DENSITY}q_r3_params": serve[ddt]}
        e["launches"] += (sum(v["launches"] for v in reqs.values())
                          + sum(v["launches"] for v in mids.values()) + serve[ddt]["launches"]
                          + sum(v["launches"] for v in e["sharded_gradient_paths"].values()))
        e["graph_kernels"] = e.get("graph_kernels", 0) + sum(
            v["graph_kernels"] for v in reqs.values())


#: phase 18: the planner's circuit (qubits, depth, meta shards) and the
#: collective permute timed at each pipeline depth (its block swap: bits
#: [lo, lo+k) with the top k, so every shard bit crosses)
PLAN_BIG = (34, 8, 8)
PIPE_DEPTHS = (1, 2, 4)
PIPE_SWAP = (10, 2)
#: warm repetitions of each phase-18 circuit and of each permute depth
REPS_18 = 3
PIPE_REPS = 7


def _gathered(q) -> "torch.Tensor":
    import torch
    return torch.cat(list(q.shards), dim=1)


def _explicit_scheduler_phase(qt, dev, plans: dict) -> dict:
    """Phase 18: the explicit distributed scheduler over N_SHARDS virtual
    shards of ``dev`` (``# explicit scheduler ...`` lines): the main path's
    raw tape in f32, deferred and immediate, each against its own
    ``plan_circuit`` on meta shards and the default sharded route; the f64
    and f32 fused plans of the sharded path on the per-shard kernel joined
    by the scheduler's counted frame transposes (their launches driven
    with the counts reset, then the kernel against its plain version on
    the plan's first run); one collective permute of the f64 state at
    each pipeline depth against depth 1 and its bytes bound; and the 34q
    plan on meta shards (host seconds, no card memory). Every circuit and
    permute is timed as the median of warm repetitions."""
    import torch

    from quest_tpu_torch import fusion, telemetry
    from quest_tpu_torch.ops import fused_gates as FG
    from quest_tpu_torch.parallel import exchange as X
    from quest_tpu_torch.parallel.scheduler import comm_chunks, plane_unit_scale

    t0 = time.perf_counter()
    n, d = N_MAIN, N_SHARDS
    env = qt.createQuESTEnv(devices=[dev] * d)
    circ = qt.Circuit(n)
    qt.random_layers(circ, n, DEPTH_MAIN)
    out: dict = {}

    def plan_of(c, dt, **kw):
        st = qt.plan_circuit(c, env.devices, dtype=dt, **kw)
        st.pop("comm_volume")
        return st

    # 1. the raw tape in f32: deferred and immediate, the default route;
    # each timed over REPS_18 warm circuits after its first (checked) run
    ref = qt.createQureg(n, env, 1)
    qt.initPlusState(ref)
    fn = circ.as_fn()
    ref.put_shards(fn(ref.shards))
    torch.cuda.synchronize()
    want = _gathered(ref)
    scale = want.abs().max().item()
    default_t = _rep_ms(lambda: ref.put_shards(fn(ref.shards)), REPS_18)
    for mode, defer in (("deferred", True), ("immediate", False)):
        planned = plan_of(circ, torch.float32, defer=defer)
        q = qt.createQureg(n, env, 1)
        qt.initPlusState(q)
        with qt.explicit_mesh(env.devices, defer=defer) as sched:
            q.put_shards(fn(q.shards))
            torch.cuda.synchronize()
            stats = dict(sched.stats, chunks_by_kind_link=dict(sched.stats["chunks_by_kind_link"]))
            err = (_gathered(q) - want).abs().max().item() / scale
            t = _rep_ms(lambda: q.put_shards(fn(q.shards)), REPS_18)
        units = comm_chunks(stats)
        print(f"# explicit scheduler raw tape f32 {mode}: {n}q depth {DEPTH_MAIN} over {d} "
              f"shards, {len(circ)} gates: {_range(t)} a circuit (default sharded route "
              f"{_range(default_t)}); chunk units {units} (planned on meta "
              f"{comm_chunks(planned)}); relocation swaps {stats['relocation_swaps']}, "
              f"batches {stats['relocation_batches']}, pair exchanges "
              f"{stats['pair_exchanges']}, rank permutes {stats['rank_permutes']}, "
              f"reconcile collectives {stats['reconcile_collectives']}, local "
              f"{stats['local']}, comm-free {stats['comm_free']}; against the default "
              f"route {err:.3e} of the largest")
        _require(stats == planned, f"explicit {mode}: executed stats {stats} != plan {planned}")
        _require(err <= 1e-5, f"explicit {mode}: state {err} from the default route")
        out[("raw", mode)] = {"ms": t, "chunk_units": units, "stats": stats,
                              "max_rel_err": err}
        qt.destroyQureg(q)
    out["raw_default_ms"] = default_t
    _require(out[("raw", "deferred")]["chunk_units"]
             <= 0.6 * out[("raw", "immediate")]["chunk_units"],
             "deferred chunk units above 0.6x the immediate ones")
    qt.destroyQureg(ref)
    del want
    torch.cuda.empty_cache()

    # 2. and 3. the fused plans on the per-shard kernel under the
    # scheduler: f64, then f32 (priced at 2x and 1x); each against the
    # default sharded route after one run from the same state, then timed
    for dt, lim in ((torch.float64, 1e-10), (torch.float32, 1e-6)):
        tag = "f64" if dt == torch.float64 else "f32"
        fz = plans[("sharded", dt)]
        runs = [a[0] for f, a, _ in fz._tape if f is fusion._apply_pallas_run]
        planned = plan_of(fz, dt)
        prec = 2 if dt == torch.float64 else 1
        ref = qt.createQureg(n, env, prec)
        qt.initPlusState(ref)
        q = qt.createQureg(n, env, prec)
        qt.initPlusState(q)
        first = [s.clone() for s in q.shards]
        fn = fz.as_fn()
        with qt.explicit_mesh(env.devices) as sched:
            telemetry.reset()
            FG.fused_run.launches = 0
            q.put_shards(fn(q.shards))
            torch.cuda.synchronize()
            launches = FG.fused_run.launches
            fallbacks = telemetry.counter_total("engine_fallback_total")
            stats = dict(sched.stats, chunks_by_kind_link=dict(sched.stats["chunks_by_kind_link"]))
        ref.put_shards(fn(ref.shards))
        torch.cuda.synchronize()
        err = ((_gathered(q) - _gathered(ref)).abs().max().item()
               / _gathered(ref).abs().max().item())
        with qt.explicit_mesh(env.devices):
            t = _rep_ms(lambda: q.put_shards(fn(q.shards)), REPS_18)
        default_t = _rep_ms(lambda: ref.put_shards(fn(ref.shards)), REPS_18)
        # the per-shard kernel against its plain version on the plan's first run
        run, kerr, kabs = runs[0], 0.0, 0.0
        prep = run.prepare()
        nl = n - (d - 1).bit_length()
        kw = dict(tile_bits=run.tile_bits, **_swaps(run.load_swap_k, run.load_swap_hi,
                                                      run.store_swap_k, run.store_swap_hi))
        for k, h in (("load_swap_k", "load_swap_hi"), ("store_swap_k", "store_swap_hi")):
            hi = run.tile_bits if kw[h] is None else kw[h]
            if kw[k] and hi + kw[k] > nl:
                kw[k], kw[h] = 0, None
        dst = torch.empty_like(first[0])
        pass_ms, plain_ms = [], []
        for r, shard in enumerate(first):
            FG.fused_run(shard, n=n, ops=run.ops, out=dst, prepared=prep, local_n=nl,
                         shard_index=r, **kw)
            plain = FG.fused_run_plain(shard, prep, n=n, local_n=nl, shard_index=r, **kw)
            a, r_ = _rel_err(dst, plain)
            kabs, kerr = max(kabs, a), max(kerr, r_)
            del plain
            pass_ms.append(_cuda_ms(lambda: FG.fused_run(
                shard, n=n, ops=run.ops, out=dst, prepared=prep, local_n=nl, shard_index=r,
                **kw), 3))
            plain_ms.append(_clock_ms(lambda: FG.fused_run_plain(
                shard, prep, n=n, local_n=nl, shard_index=r, **kw), 1))
        b_bytes, b_ops = _bound_ms(_pass_work(prep, nl, 4 * prec), prec == 1)
        scale = plane_unit_scale(q.shards)
        print(f"# explicit scheduler {tag} fused plan: {len(runs)} runs over {d} shards: "
              f"launches {launches} (runs x shards {len(runs) * d}), fallbacks "
              f"{fallbacks:.0f}; frame transposes {stats['frame_transpose_collectives']} "
              f"collectives, {stats['frame_transpose_chunks']} chunk units at {scale}x "
              f"(planned {planned['frame_transpose_collectives']}, "
              f"{planned['frame_transpose_chunks']}; {stats['chunks_by_kind_link']}); "
              f"{_range(t)} a circuit (default sharded route {_range(default_t)}); against "
              f"the default route {err:.3e} of the largest; first run's per-shard kernel "
              f"against its plain version {kerr:.3e}; its shard passes "
              f"{sum(pass_ms) / d:.4f} ms (bound {max(b_bytes, b_ops):.4f} ms by "
              f"{'operations' if b_ops > b_bytes else 'bytes'}, plain "
              f"{sum(plain_ms) / d:.2f} ms)")
        _require(launches == len(runs) * d and fallbacks == 0, f"explicit {tag}: launches")
        _require(stats == planned, f"explicit {tag}: stats {stats} against plan {planned}")
        if dt == torch.float64:
            _require(stats["frame_transpose_collectives"] == 8
                     and stats["frame_transpose_chunks"] == 24.0,
                     f"explicit f64: frame transposes {stats}")
        _require(err <= lim, f"explicit {tag}: state {err} from the default route")
        _require(kerr <= (1e-12 if prec == 2 else 1e-5),
                 f"explicit {tag}: per-shard kernel {kerr} from its plain version")
        out[tag] = {"launches": launches, "runs": len(runs), "ms": t["median"],
                    "ms_range": t, "default_ms": default_t["median"],
                    "default_ms_range": default_t, "max_rel_err": err,
                    "kernel_rel_err": kerr, "kernel_abs_err": kabs,
                    "pass_ms": sum(pass_ms) / d, "pass_bound_ms": max(b_bytes, b_ops),
                    "pass_plain_ms": sum(plain_ms) / d, "pass_by_ops": b_ops > b_bytes,
                    "frame_transpose_collectives": stats["frame_transpose_collectives"],
                    "frame_transpose_chunks": stats["frame_transpose_chunks"]}
        for x in (q, ref):
            qt.destroyQureg(x)
        del first, dst
        torch.cuda.empty_cache()

    # 4. one collective permute of the f64 state at each pipeline depth
    lo, k = PIPE_SWAP
    source = list(range(n))
    for j in range(k):
        source[lo + j], source[n - k + j] = n - k + j, lo + j
    gen = torch.Generator(device="cpu").manual_seed(18)
    st = [torch.randn(2, 1 << nl, generator=gen, dtype=torch.float64).to(dev)
          for _ in range(d)]
    bound = 2 * sum(s.numel() * s.element_size() for s in st) / HBM_BYTES_PER_S * 1e3
    base = [torch.empty_like(s) for s in st]
    X.dist_permute_bits(st, n=n, source=source, out=base, pipeline=1)
    rows = {}
    for depth in PIPE_DEPTHS:
        o = [torch.empty_like(s) for s in st]
        telemetry.reset()
        with qt.explicit_mesh(env.devices):  # where the launch is timed
            X.dist_permute_bits(st, n=n, source=source, out=o, pipeline=depth)
            torch.cuda.synchronize()
            pm = _rep_ms(lambda: X.dist_permute_bits(st, n=n, source=source, out=o,
                                                     pipeline=depth), PIPE_REPS)
        hist = telemetry.histogram("comm_collective_ms", kind="grouped_permute",
                                   pipeline=depth)
        same = all(torch.equal(a, b) for a, b in zip(o, base))
        rows[depth] = {"ms": pm["median"], "ms_range": pm, "bit_identical": same,
                       "histogram_ms": hist["sum"] / hist["count"]}
        print(f"# explicit scheduler permute f64 depth {depth}: {_range(pm)} (the "
              f"comm_collective_ms histogram's mean {rows[depth]['histogram_ms']:.3f} over "
              f"{hist['count']}), bound {bound:.3f} ms (2 x state bytes at "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s), bit-identical to depth 1: {same}")
        _require(same, f"pipelined permute at depth {depth} differs from depth 1")
        del o
    out["permute"] = {"rows": rows, "bound_ms": bound,
                      "units": X.permute_collective_stats(n, source, env.devices)}
    del st, base
    torch.cuda.empty_cache()
    out["sites"] = _pipeline_sites(dev)

    # 5. the 34q plan on meta shards: host seconds, no card memory
    big = qt.Circuit(PLAN_BIG[0])
    qt.random_layers(big, PLAN_BIG[0], PLAN_BIG[1])
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved(dev)
    t1 = time.perf_counter()
    st = qt.plan_circuit(big, (dev,) * PLAN_BIG[2])
    plan_s = time.perf_counter() - t1
    moved = torch.cuda.memory_reserved(dev) - reserved
    print(f"# explicit scheduler plan_circuit {PLAN_BIG[0]}q depth {PLAN_BIG[1]} over "
          f"{PLAN_BIG[2]} meta shards: {plan_s:.3f} s on the host, chunk units "
          f"{comm_chunks(st)}, card memory reserved moved by {moved} bytes")
    _require(moved == 0, "plan_circuit reserved card memory")
    out["plan_big"] = {"s": plan_s, "chunk_units": comm_chunks(st)}
    out["phase_s"] = time.perf_counter() - t0
    print(f"# explicit scheduler phase: {out['phase_s']:.1f} s")
    return out


#: phase 18's pipelined launch sites: a 20q f64 state over 4 shards
#: (qubits 18, 19 sharded), each site with local and sharded controls
PIPE_SITE_N = 20


def _pipeline_sites(dev) -> dict:
    """Every exchange launch site of ``parallel.exchange`` on the card at
    depths 2 and 4 against depth 1, bit for bit: the pipelined transfers
    run on the side stream there (``# explicit scheduler pipeline sites``)."""
    import torch

    from quest_tpu_torch.parallel import exchange as X

    n, d = PIPE_SITE_N, N_SHARDS
    gen = torch.Generator(device="cpu").manual_seed(181)
    st = [torch.randn(2, 1 << (n - 2), generator=gen, dtype=torch.float64).to(dev)
          for _ in range(d)]
    u = torch.linalg.qr(torch.randn(2, 2, dtype=torch.complex128, generator=gen))[0]
    u = torch.stack([u.real, u.imag]).to(dev)
    diag = torch.stack([torch.cos(torch.arange(4.0)), torch.sin(torch.arange(4.0))]).to(
        dev, torch.float64)
    sites = {
        "pair_exchange": lambda p: X.dist_apply_matrix1(
            st, u, n=n, target=19, controls=(1, 18), control_states=(1, 0), pipeline=p),
        "x_permute": lambda p: X.dist_apply_x(
            st, n=n, targets=(19, 17, 3), controls=(0,), control_states=(1,), pipeline=p),
        "grouped_permute": lambda p: X.dist_permute_bits(
            st, n=n, source=(19, 1, 2) + tuple(range(3, 17)) + (18, 17, 0), pipeline=p),
        "diag_phase": lambda p: X.dist_apply_diag_phase(
            st, diag, n=n, targets=(19, 16), controls=(1,), pipeline=p),
        "parity_phase": lambda p: X.dist_apply_parity_phase(
            st, 0.37, n=n, qubits=(18, 15, 1), controls=(0,), pipeline=p),
        "swap_odd_parity": lambda p: X.dist_swap(st, n=n, qb1=4, qb2=19, pipeline=p),
        "swap_rank_permute": lambda p: X.dist_swap(st, n=n, qb1=18, qb2=19, pipeline=p),
    }
    res = {}
    for name, fn in sites.items():
        base = torch.cat(fn(1), dim=1)
        res[name] = all(torch.equal(base, torch.cat(fn(p), dim=1)) for p in (2, 4))
        _require(res[name], f"pipelined {name} differs from depth 1 on the card")
    torch.cuda.synchronize()
    print(f"# explicit scheduler pipeline sites {n}q f64 over {d} shards, depths 2 and 4 "
          f"bit-identical to depth 1: {res}")
    return res


def _explicit_scheduler_entries(entries: list, phase: dict) -> None:
    """Phase 18's fused plans in the per-shard kernel's entries (f32, f64):
    their launches from the runs driven with the counts reset just before
    them."""
    for e, tag in ((entries[4], "f32"), (entries[5], "f64")):
        p = phase[tag]
        e["explicit_scheduler_paths"] = {
            f"fused_26q_depth8_{tag}": {k: p[k] for k in (
                "launches", "runs", "ms", "ms_range", "default_ms", "default_ms_range",
                "max_rel_err", "kernel_rel_err", "kernel_abs_err",
                "frame_transpose_collectives", "frame_transpose_chunks", "pass_ms",
                "pass_bound_ms", "pass_plain_ms")}}
        e["launches"] += p["launches"]
        e["max_abs_err"] = max(e["max_abs_err"], p["kernel_abs_err"])


def _entry(name, replaces, paths: dict, errs: list, copy_ms: float) -> dict:
    """One line of the ``{"kernels": [...]}`` JSON from the paths' pass
    stats: ms, plain and bound are means over every timed pass."""
    ms = [m for p in paths.values() for m in p["ms"]]
    bounds = [b for p in paths.values() for b in p["bound_ms"]]
    ops_b = sum(b for p in paths.values() for b, o in zip(p["bound_ms"], p["by_ops"]) if o)
    return {
        "name": name, "route": "cuda", "source": "quest_tpu_torch/csrc/fused_gates.cu",
        "replaces": replaces,
        "launches": sum(p["launches"] for p in paths.values()),
        "max_abs_err": max(errs + [p["max_abs_err"] for p in paths.values()]),
        "ms": sum(ms) / len(ms),
        "plain_ms": sum(m for p in paths.values() for m in p["plain_ms"]) / len(ms),
        "bound_ms": sum(bounds) / len(bounds),
        # which limit makes up most of the summed per-pass bound
        "bound_by": "operations" if 2 * ops_b > sum(bounds) else "bytes",
        # no single PyTorch call computes a fused gate run; a full-state
        # copy_ (the memory floor) is reported beside it
        "library_ms": None,
        "library_yardsticks_ms": {"copy_": copy_ms},
        "op_kinds": sorted(set().union(*(p["kinds"] for p in paths.values()))),
        "paths": {k: {"launches": p["launches"], "passes": len(p["ms"]),
                      "ms": sum(p["ms"]) / len(p["ms"]),
                      "bound_ms": sum(p["bound_ms"]) / len(p["ms"]),
                      "plain_ms": sum(p["plain_ms"]) / len(p["ms"])}
                  for k, p in paths.items()},
    }


def _shard_entry(name: str, replaces: str, res: dict, kernel_err: float) -> dict:
    """The ``kernels`` line of the per-shard kernel from the sharded phase:
    ms, plain and bound are means over every timed shard pass."""
    npass = len(res["ms"])
    ops_b = sum(b for b, o in zip(res["bound_ms"], res["by_ops"]) if o)
    return {
        "name": name, "route": "cuda", "source": "quest_tpu_torch/csrc/fused_gates.cu",
        "replaces": replaces, "launches": res["launches"],
        "max_abs_err": max(res["max_abs_err"], kernel_err),
        "ms": sum(res["ms"]) / npass, "plain_ms": sum(res["plain_ms"]) / npass,
        "bound_ms": sum(res["bound_ms"]) / npass,
        "bound_by": "operations" if 2 * ops_b > sum(res["bound_ms"]) else "bytes",
        # no single PyTorch call computes a fused gate run; one shard's
        # copy_ (its memory floor) is reported beside it
        "library_ms": None, "library_yardsticks_ms": {"copy_ one shard": res["copy_ms"]},
        "shards": N_SHARDS, "op_kinds": sorted(res["kinds"]),
        "gates_per_sec": res["gates_per_sec"], "circuit_ms": res["circuit_ms"],
        "per_gate_replay_gates_per_sec": res["replay_gates_per_sec"],
        "runs": res["runs"], "collective_transposes": res["collective_transposes"],
        "local_transposes": res["local_transposes"], "collective_permutes": res["permutes"],
        "in_circuit_ms": res["in_circuit_ms"],
    }


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

    t_start = time.perf_counter()
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
    ptxas = {lib: _ptxas_kernels(_build.build_log(lib)) for lib in _build.SOURCES}
    for lib, kernels in ptxas.items():
        for k in kernels:
            print(f"# ptxas {lib}: {k['kernel']}: {k['registers']} registers, "
                  f"{k['spill_stores']} bytes spill stores, {k['spill_loads']} bytes "
                  f"spill loads")
    # the tensor cores in each fold: FP64 mma.sync is DMMA in SASS, TF32 HMMA
    sass = _sass_counts(_build.library_path("fused_gates"))
    for k, counts in sass.items():
        print(f"# sass fused_gates: {k}: " + ", ".join(f"{c} {op}" for op, c in counts.items()))
    # the f64 instantiation runs lane_u (4 DMMA), krausn (32 more: 36) and,
    # from span 3, the window fold on DMMA
    _require(sass.get("fused_run_kernel<double, false>", {}).get("DMMA", 0) > 36,
             "the f64 instantiation holds no DMMA beyond the lane_u and krausn arms'")
    # the f32 ones: lane_u (192 HMMA) and krausn_mma<1> (96 more: 288) in
    # the lane_u one, krausn_mma<2> (192) in the other, and in both the
    # window fold from span 3
    _require(sass.get("fused_run_kernel<float, true>", {}).get("HMMA", 0) > 288,
             "the f32 lane_u instantiation holds no HMMA beyond the lane_u and krausn arms'")
    _require(sass.get("fused_run_kernel<float, false>", {}).get("HMMA", 0) > 192,
             "the other f32 instantiation holds no HMMA beyond the krausn arm's")
    lib = _build.library("fused_gates")
    occupancy = {}
    for f64, ddt in ((0, torch.float32), (1, torch.float64)):
        # the launch's staged flags: 1 a lane_u op, 2 a krausn op, 4 a
        # window op of span 3 or more (its U, in either precision), 8 an
        # elementwise record (the diagonal arm's tables)
        for staged, what in ((0, ""), (1, " lane_u"), (2, " krausn"), (3, " lane_u+krausn"),
                             (4, " window"), (8, " diag")):
            k = f"{str(ddt)[6:]}{what}"
            occupancy[k] = lib.quest_fused_run_blocks_per_sm(
                f64, FG.HOPPER_TILE_BITS[ddt], staged)
            print(f"# occupancy fused_gates: a {k} run at tile_bits "
                  f"{FG.HOPPER_TILE_BITS[ddt]}: {occupancy[k]} blocks per SM")
    _require(occupancy["float64 lane_u"] == 2, "an f64 lane_u run does not fit two blocks an SM")
    _require(occupancy["float64 krausn"] == 2, "an f64 krausn run does not fit two blocks an SM")
    _require(occupancy["float32 krausn"] == 2, "an f32 krausn run does not fit two blocks an SM")
    _require(occupancy["float64 window"] == 2, "an f64 window run does not fit two blocks an SM")
    _require(occupancy["float32 window"] == 2, "an f32 window run does not fit two blocks an SM")
    _require(occupancy["float64 diag"] == 2, "an f64 diagonal run does not fit two blocks an SM")
    _require(occupancy["float32 diag"] == 2, "an f32 diagonal run does not fit two blocks an SM")
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
        for name, ops, sw in _kernel_cases(N_KERNEL, tb, rng):
            prep = FG.PreparedRun(ops, tb)
            ref = FG.fused_run_plain(st, prep, n=N_KERNEL, tile_bits=tb, **sw)
            FG.fused_run(st, n=N_KERNEL, ops=ops, tile_bits=tb, out=out,
                         prepared=prep, **sw)
            torch.cuda.synchronize()
            err, rel = _rel_err(out, ref)
            kinds = sorted({o[0] for o in prep.ops})
            seen.update(kinds)
            print(f"# kernel {str(dt)[6:]} {name}: folded kinds {kinds}, "
                  f"max_abs_err {err:.3e}, {rel:.3e} of the largest (limit {tol:g})")
            _require(rel <= tol, f"{dt} {name} error {err} ({rel} relative) > {tol}")
            errs[(str(dt), name)] = err
        kinds_checked = {"matrix", "parity", "swap", "diagw", "lane_u", "window",
                         "kraus1", "kraus2", "krausn"}
        _require(seen == kinds_checked, f"kernel phase missed op kinds: {seen}")
        del st, out, ref
        # lane_u on tiles below the largest: fewer rows than the f32
        # kernel's 64 (fewer than one m16 tile below 2^11) and the f64
        # kernel's 32 (one m16 tile at 2^11, fewer below)
        for n in SMALL_TILE_QUBITS:
            stb = FG.hopper_tile_bits(n, dt)
            ops = tuple(("matrix", q % 7, (), (),
                         FG.HashableMatrix(np.linalg.qr(rng.randn(2, 2) + 1j * rng.randn(2, 2))[0]))
                        for q in range(21)) + (("parity", (2, n - 1), (), 0.9),)
            prep = FG.PreparedRun(ops, stb)
            _require(prep.has_lane_u, f"small tile {n}q: no lane_u fold")
            st = torch.as_tensor(rng.randn(2, 1 << n), dtype=dt, device=dev)
            st /= st.norm()
            ref = FG.fused_run_plain(st, prep, n=n, tile_bits=stb)
            x = st.clone()
            FG.fused_run(x, n=n, ops=ops, tile_bits=stb, prepared=prep)
            torch.cuda.synchronize()
            err, rel = _rel_err(x, ref)
            print(f"# kernel {str(dt)[6:]} lane_u small tile: {n}q, tile_bits {stb} "
                  f"({1 << (stb - 7)} rows), folded kinds {[o[0] for o in prep.ops]}, "
                  f"max_abs_err {err:.3e}, {rel:.3e} of the largest (limit {tol:g})")
            _require(rel <= tol, f"{dt} lane_u {n}q error {err} ({rel} relative) > {tol}")
            errs[(str(dt), f"lane_u {n}q")] = err
        # krausn on tiles below the largest, at KRAUS_TILE_BITS (2 to 32
        # groups of 64: the tensor-core arms at one sweep, masked m16 tiles
        # below 16 groups; in f32 also 64 groups, one full sweep), on
        # random unsorted qubits of the tile
        for ktb in KRAUS_TILE_BITS_F32 if dt == torch.float32 else KRAUS_TILE_BITS:
            q = [int(v) for v in rng.permutation(ktb)[:6]]
            op = ("krausn", tuple(q[:3]), tuple(q[3:]),
                  tuple((s, FG.HashableMatrix(0.3 * (rng.randn(8, 8) + 1j * rng.randn(8, 8))))
                        for s in (1.0, -1.0)))
            prep = FG.PreparedRun((op,), ktb)
            st = torch.as_tensor(rng.randn(2, 1 << KRAUS_TILE_QUBITS), dtype=dt, device=dev)
            st /= st.norm()
            ref = FG.fused_run_plain(st, prep, n=KRAUS_TILE_QUBITS, tile_bits=ktb)
            x = st.clone()
            FG.fused_run(x, n=KRAUS_TILE_QUBITS, ops=prep.ops, tile_bits=ktb, prepared=prep)
            torch.cuda.synchronize()
            err, rel = _rel_err(x, ref)
            print(f"# kernel {str(dt)[6:]} krausn small tile: {KRAUS_TILE_QUBITS}q, tile_bits "
                  f"{ktb} ({1 << (ktb - 6)} groups), rows {q[:3]} columns {q[3:]}, max_abs_err "
                  f"{err:.3e}, {rel:.3e} of the largest (limit {tol:g})")
            _require(rel <= tol, f"{dt} krausn tile_bits {ktb} error {err} ({rel} relative) > {tol}")
            errs[(str(dt), f"krausn tile_bits {ktb}")] = err
        # window folds on the tensor cores at D = 8, 16, 32 (in f32 also
        # over the two slabs of the 2^13 tile), alone and beside lane_u
        # folds, and in f32 a hand-built window [8, 11) at tile bits 12
        # (generators of their own: the later phases see the same data as
        # without them)
        f32 = dt == torch.float32
        wrng = np.random.RandomState(43 if f32 else 41)
        wruns = [(wtb, name, ops) for wtb in (WINDOW_TILE_BITS_F32 if f32 else WINDOW_TILE_BITS)
                 for name, ops in _window_runs(wtb, wrng)]
        if f32:
            u = np.linalg.qr(wrng.randn(8, 8) + 1j * wrng.randn(8, 8))[0]
            wruns.append((12, "window [8, 11)", (("window", 8, 3, FG.HashableMatrix(
                np.block([[u.real, -u.imag], [u.imag, u.real]]))),)))
        for wtb, name, ops in wruns:
            prep = FG.PreparedRun(ops, wtb)
            st = torch.as_tensor(wrng.randn(2, 1 << KRAUS_TILE_QUBITS), dtype=dt, device=dev)
            st /= st.norm()
            ref = FG.fused_run_plain(st, prep, n=KRAUS_TILE_QUBITS, tile_bits=wtb)
            x = st.clone()
            FG.fused_run(x, n=KRAUS_TILE_QUBITS, ops=ops, tile_bits=wtb, prepared=prep)
            torch.cuda.synchronize()
            err, rel = _rel_err(x, ref)
            kinds = [o[0] for o in prep.ops]
            zones = [o[1:3] for o in prep.ops if o[0] == "window"]
            print(f"# kernel {str(dt)[6:]} {name}: {KRAUS_TILE_QUBITS}q, tile_bits {wtb}, "
                  f"windows (lo, span) {zones}, folded kinds {kinds}, staged {prep.staged}, "
                  f"max_abs_err {err:.3e}, {rel:.3e} of the largest (limit {tol:g})")
            _require(any(s >= 3 for _, s in zones) and prep.staged & 4,
                     f"{dt} {name} tile_bits {wtb}: no staged window fold")
            _require(rel <= tol, f"{dt} {name} tile_bits {wtb} error {err} ({rel} "
                                 f"relative) > {tol}")
            errs[(str(dt), f"{name} tile_bits {wtb}")] = err
        del st, x, ref
    shard_errs = _shard_kernel_phase(dev, rng)

    # -- main path: plan, per-run kernel vs plain, then the circuit --------
    dt = torch.float32
    env = qt.createQuESTEnv(device="cuda:0")
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
    main = _passes([_run_item(r) for r in runs], N_MAIN, dt, dev, rng, 1e-5,
                   "main-path")
    torch.cuda.empty_cache()

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
    main["launches"] = launches
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
    _warm_run(fz, q)
    t0 = time.perf_counter()
    for _ in range(reps):
        fz.run(q)
    torch.cuda.synchronize()
    dt_s = time.perf_counter() - t0
    gps = len(circ) * reps / dt_s
    print(f"# gates/sec: {gps:.1f} ({len(circ)} gates x {reps} reps in "
          f"{dt_s:.4f} s; {dt_s / reps * 1e3:.3f} ms per circuit, "
          f"{sum(main['ms']):.3f} ms of it kernel passes)")
    _require(abs(qt.calcTotalProb(q) - 1) <= 1e-4, "norm after timed reps")

    # -- yardstick (never called by the port) ------------------------------
    y = torch.empty_like(q.amps)
    copy_ms = _cuda_ms(lambda: y.copy_(q.amps), 10)
    print(f"# yardstick: full-state copy_ {copy_ms:.4f} ms")
    npass = len(runs)
    lane_ms = [m for m, o in zip(main["ms"], main["by_ops"]) if o]
    print(f"# per pass: kernel {sum(main['ms']) / npass:.4f} ms mean "
          f"({len(lane_ms)} operation-bound passes "
          f"{(sum(lane_ms) / max(len(lane_ms), 1)):.4f} ms mean), bound "
          f"{sum(main['bound_ms']) / npass:.4f} ms mean, plain "
          f"{sum(main['plain_ms']) / npass:.2f} ms mean")
    q.spare = None  # the final state stays for the readout phase
    del y
    _release()

    # -- lane_u phase: one-op passes of the tensor-core folds, f32 and f64 -
    # (the f64 passes draw from a generator of their own, so the later
    # phases see the same data as without them)
    lane = {torch.float32: _lane_u_phase(dev, rng, torch.float32),
            torch.float64: _lane_u_phase(dev, np.random.RandomState(29), torch.float64)}
    # the window fold alone (its own generator, as the f64 lane_u passes)
    fz64 = circ.fused(max_qubits=5, pallas=True, dtype=torch.float64)
    runs64 = [a[0] for f, a, _ in fz64._tape if f is fusion._apply_pallas_run]
    window_fold = {ddt: _window_fold_pass(dev, np.random.RandomState(31), r, ddt)
                   for ddt, r in ((torch.float32, runs), (torch.float64, runs64))}
    # the 2x2 arm alone (its own generator)
    two_arm = {ddt: _two_by_two_arm_alone(dev, runs64, ddt)
               for ddt in (torch.float32, torch.float64)}
    # -- main path f64: the same circuit planned at f64 on one device -----
    main64 = _main_path_f64(qt, env, circ, fz64, dev)
    _release()

    # -- density path: the channel circuits, f32 then f64 ------------------
    density, kraus_alone = {}, {}
    for ddt in (torch.float32, torch.float64):
        for tag, with_krausn in (("r3", False), ("r4", True)):
            density[(ddt, tag)] = _density_path(qt, env, ddt, with_krausn, rng, dev)
        kraus_alone[ddt] = _kraus_ops_at_width(ddt, dev, rng)
        _release()

    # -- window phase: window_dot's entry point, f32 and f64 ---------------
    window = _window_phase(dev, rng)

    # -- gate-surface phase: every tapeable gate and operator, f32 ---------
    surface = _gate_surface_path(qt, env, dev, rng)
    _release()

    # -- sharded phase: the main path's circuit over 4 shards, f32 and f64 -
    sharded = {}
    for ddt in (torch.float32, torch.float64):
        sharded[ddt] = _sharded_path(qt, dev, rng, ddt)
        _release()

    # -- readout phase: the readouts on the states the phases above made ---
    kept = ({torch.float32: q, torch.float64: main64.pop("qureg")},
            {ddt: (density[(ddt, "r4")].pop("qureg"), density[(ddt, "r3")].pop("qureg"))
             for ddt in (torch.float32, torch.float64)},
            {ddt: sharded[ddt].pop("qureg") for ddt in (torch.float32, torch.float64)})
    _readout_phase(qt, dev, *kept)
    for regs in kept[1:]:
        for r in regs.values():
            for x in (r if isinstance(r, tuple) else (r,)):
                qt.destroyQureg(x)
    torch.cuda.empty_cache()

    # -- operators phase: the operators slice on the main path's states ----
    operators = _operators_phase(qt, dev, kept[0])
    _release()

    # -- compiled phase: the compiled routes as CUDA-graph replays ---------
    plans = {("main", torch.float32): fz, ("main", torch.float64): fz64}
    for ddt in (torch.float32, torch.float64):
        plans[("density", ddt)] = density[(ddt, "r4")]["plan"]
        plans[("sharded", ddt)] = sharded[ddt]["plan"]
    for k in ("qft", "trotter"):
        plans[(k, torch.float32)] = operators[(f"{k}_plan", torch.float32)]
    compiled = _compiled_phase(qt, dev, plans)

    # -- serving phase: the Engine's lane-batched replays, f32 and f64 -----
    serving = _serving_phase(qt, dev)
    lanes = _lanes_alone(dev, {torch.float32: fz, torch.float64: fz64})

    # -- sampling and gradients phase: shot tables and adjoint gradients ---
    samp_grad = _sampling_gradients_phase(qt, dev, plans)

    # -- trajectories and pool phase: seeded ensembles, the replica pool ---
    traj_pool = _trajectories_pool_phase(qt, dev)

    # -- checkpoint and segments phase: snapshots, preemption and resume ---
    ckpt = _checkpoint_segments_phase(qt, dev, plans)

    # -- sharded density phase: the density circuits over 4 shards --------
    sharded_density = _sharded_density_phase(
        qt, dev, {(ddt, tag): density[(ddt, tag)]["plan"]
                  for ddt in (torch.float32, torch.float64) for tag in ("r3", "r4")})

    # -- sharded serving phase: sampling, gradients, serving over 4 shards -
    sharded_serving = _sharded_serving_phase(qt, dev, plans, samp_grad)
    _release()

    # -- explicit scheduler phase: deferred layouts, counted collectives ---
    explicit = _explicit_scheduler_phase(qt, dev, plans)
    _release()

    f32_paths = {"statevec_26q_depth8": main, "gate_surface_26q": surface}
    f32_paths.update({f"density_14q_{t}": density[(torch.float32, t)] for t in ("r3", "r4")})
    f64_paths = {"statevec_26q_depth8_f64": main64}
    f64_paths.update({f"density_14q_{t}": density[(torch.float64, t)] for t in ("r3", "r4")})
    entries = [
        _entry("fused_gate_run", "quest_tpu/ops/pallas_gates.py:1141", f32_paths,
               [e for (d, _), e in errs.items() if d == str(torch.float32)], copy_ms),
        _entry("fused_gate_run_f64", "quest_tpu/ops/pallas_gates.py:1253", f64_paths,
               [e for (d, _), e in errs.items() if d == str(torch.float64)],
               density[(torch.float64, "r4")]["copy_ms"]),
    ]
    entries[0]["gates_per_sec"] = gps
    entries[1]["gates_per_sec"] = main64["gates_per_sec"]
    entries[1]["statevec_f64"] = {k: main64[k] for k in (
        "circuit_ms", "runs", "window_folds", "share_of_bound", "max_rel_diff_vs_replay")}
    for e, ddt in zip(entries, (torch.float32, torch.float64)):
        e["lane_u_passes"] = lane[ddt]["rows"]
        e["library_yardsticks_ms"]["matmul_lane_u"] = lane[ddt]["rows"][0]["library_ms"]
        e["max_abs_err"] = max(e["max_abs_err"], lane[ddt]["max_abs_err"])
    entries[1]["also_replaces"] = "quest_tpu/ops/pallas_df.py:255"
    for e, paths, ddt in zip(entries, (f32_paths, f64_paths), (torch.float32, torch.float64)):
        e["channel_ops_per_sec"] = {k: p["channel_ops_per_sec"] for k, p in paths.items()
                                    if "channel_ops_per_sec" in p}
        e["kraus_op_passes_28q"] = kraus_alone[ddt]
        e["library_yardsticks_ms"]["matmul_krausn"] = kraus_alone[ddt]["krausn"]["library_ms"]
        e["max_abs_err"] = max(e["max_abs_err"], kraus_alone[ddt]["max_abs_err"])
        e["kernel_phase_op_kinds"] = sorted(kinds_checked)
    for e, ddt in zip(entries, (torch.float32, torch.float64)):
        e["window_fold_pass"] = window_fold[ddt]
        e["max_abs_err"] = max(e["max_abs_err"], window_fold[ddt]["max_abs_err"])
        # the 2x2 arm alone, beside one torch.matmul of the same product
        e["two_by_two_arm_pass"] = two_arm[ddt]
        e["library_yardsticks_ms"]["matmul_2x2_run"] = two_arm[ddt]["library_ms"]
        e["max_abs_err"] = max(e["max_abs_err"], two_arm[ddt]["max_abs_err"])
    entries[0]["gate_surface"] = {k: surface[k] for k in (
        "fused_launches", "dense_launches", "density_launches", "circuit_ms",
        "ms_by_item")}
    entries += [_window_entry("window_dot", window[torch.float32]),
                _window_entry("window_dot_f64", window[torch.float64]),
                _shard_entry("fused_gate_run_per_shard", "quest_tpu/ops/pallas_gates.py:1283",
                             sharded[torch.float32], shard_errs[torch.float32]),
                _shard_entry("fused_gate_run_per_shard_f64",
                             "quest_tpu/ops/pallas_gates.py:1228",
                             sharded[torch.float64], shard_errs[torch.float64])]
    for e in entries:
        e["ptxas"] = ptxas["window_dot" if e["name"].startswith("window_dot") else "fused_gates"]
    for e in entries[:2]:
        e["sass"], e["blocks_per_sm"] = sass, occupancy
    for e, ddt in zip(entries, (torch.float32, torch.float64)):
        # the operators phase's fused QFT and Trotter runs, each driven with
        # the counts reset (beside the paths above, not in their means)
        e["operators_paths"] = {kind: {
            "launches": r["launches"], "runs": r["runs"], "passes": len(r["ms"]),
            "ms": sum(r["ms"]) / len(r["ms"]), "bound_ms": sum(r["bound_ms"]) / len(r["ms"]),
            "plain_ms": sum(r["plain_ms"]) / len(r["ms"]), "fused_ms": r["fused_ms"],
            "eager_ms": r["eager_ms"], "max_abs_err": r["max_abs_err"],
            "graph_kernels": r.get("graph_kernels"), "traced_runs": r.get("traced")}
            for kind, r in ((kind, operators[(kind, ddt)]) for kind in ("qft", "trotter"))}
        e["operators_paths"]["qft"]["yardstick_fft_ms"] = operators[("qft", ddt)]["fft_ms"]
        # the diagonal arm alone: the QFT run's controlled phases in one pass
        arm = operators[("diag_arm", ddt)]
        e["diagonal_arm_pass"] = arm
        e["library_yardsticks_ms"]["mul_diagonal"] = arm["library_ms"]
        e["max_abs_err"] = max(e["max_abs_err"], arm["max_abs_err"])
    # the compiled phase's routes, each driven with the counts reset: the
    # wrapper's launches in the route's first (eager) call, the fused_run
    # kernel nodes of the graphs one replay launches and those the card's
    # trace showed, its ms
    # per circuit beside the eager replay's, and the per-pass bound and
    # plain ms of the same runs
    def replays(e, r):
        for k, v in (("graph_kernels", r["graph_kernels"]), ("traced_runs", r["traced"])):
            e[k] = e.get(k, 0) + v

    for e, ddt, base, shard_e in ((entries[0], torch.float32, main, entries[4]),
                                  (entries[1], torch.float64, main64, entries[5])):
        rows = compiled[("main", ddt)]["rows"]
        npass = compiled[("main", ddt)]["passes"]
        for route, r in rows.items():
            e["paths"][f"compiled_{route}_26q_depth8"] = {
                "launches": r["launches"], "graph_kernels": r["graph_kernels"],
                "traced_runs": r["traced"],
                "passes": npass, "ms": r["ms"] / npass,
                "circuit_ms": r["ms"], "eager_circuit_ms": r.get("eager_ms"),
                "bound_ms": sum(base["bound_ms"]) / len(base["bound_ms"]),
                "plain_ms": sum(base["plain_ms"]) / len(base["plain_ms"])}
            e["launches"] += r["launches"]
            replays(e, r)
        for route in ("compiled", "request"):
            d = compiled[("density", route, ddt)]
            e["paths"][f"compiled_{route}_density_14q_r4"] = {
                "launches": d["launches"], "graph_kernels": d["graph_kernels"],
                "traced_runs": d["traced"],
                "call_ms": d["ms"]}
            e["launches"] += d["launches"]
            replays(e, d)
            sh = compiled[("sharded", route, ddt)]
            shard_e.setdefault("compiled_paths", {})[f"compiled_{route}_26q_depth8"] = {
                "launches": sh["launches"], "graph_kernels": sh["graph_kernels"],
                "traced_runs": sh["traced"],
                "call_ms": sh["ms"], "exchange_calls": sh["exchanges"]}
            shard_e["launches"] += sh["launches"]
            replays(shard_e, sh)
        e["compiled_sweep"] = compiled[("sweep", ddt)]
    entries[0]["launches"] += compiled["20q"]["launches"]
    replays(entries[0], compiled["20q"])
    entries[0]["paths"]["compiled_20q_depth8"] = {
        "launches": compiled["20q"]["launches"],
        "graph_kernels": compiled["20q"]["graph_kernels"],
        "traced_runs": compiled["20q"]["traced"], "passes": compiled["20q"]["passes"],
        "circuit_ms": compiled["20q"]["ms"], "eager_circuit_ms": compiled["20q"]["eager_ms"]}
    for k in ("qft", "trotter"):
        # their launches are the eager run's, counted in the operators phase
        entries[0]["operators_paths"][k]["compiled"] = compiled[k]
        replays(entries[0], compiled[k])
    entries[0]["compiled_many_circuits"] = compiled["many"]
    # the serving phase: each fused configuration's eager batch (its counts
    # reset just before it) launches the kernel once a run for all lanes,
    # and its graph holds one fused_run node a run; the lane axis alone
    for e, ddt in zip(entries[:2], (torch.float32, torch.float64)):
        e["lanes"] = lanes[ddt]
        e["max_abs_err"] = max(e["max_abs_err"], lanes[ddt]["max_abs_err"])
        e["serving"] = {cfg: serving[(cfg, ddt)] for cfg, *_ in SERVING}
        for cfg, n, _depth, fused, batch in SERVING:
            r = serving[(cfg, ddt)]
            if not fused:
                continue
            e["paths"][f"serving_{cfg}"] = {
                "launches": r["launches"], "graph_kernels": r["graph_kernels"],
                "runs": r["runs"], "lanes": batch, "qubits": n}
            e["launches"] += r["launches"]
            e["graph_kernels"] = e.get("graph_kernels", 0) + r["graph_kernels"]
    _sampling_gradients_entries(entries[:2], samp_grad)
    _trajectories_pool_entries(entries[:2], traj_pool)
    _checkpoint_entries(entries, ckpt)
    _sharded_density_entries(entries, sharded_density)
    _sharded_serving_entries(entries, sharded_serving)
    _explicit_scheduler_entries(entries, explicit)
    print("# kernels: " + json.dumps({e["name"]: {
        "launches": e["launches"], "graph_kernels": e.get("graph_kernels", 0),
        "traced_runs": e.get("traced_runs", 0),
        "max_abs_err": e["max_abs_err"],
        "ms": e["ms"], "bound_ms": e["bound_ms"]} for e in entries}))
    print(f"# chip_smoke: {time.perf_counter() - t_start:.1f} s in all (operators phase "
          f"{operators['phase_s']:.1f} s, compiled phase {compiled['phase_s']:.1f} s, "
          f"serving phase {serving['phase_s']:.1f} s, sampling and gradients phase "
          f"{samp_grad['phase_s']:.1f} s, trajectories and pool phase "
          f"{traj_pool['phase_s']:.1f} s, checkpoint and segments phase "
          f"{ckpt['phase_s']:.1f} s, sharded density phase "
          f"{sharded_density['phase_s']:.1f} s, sharded serving phase "
          f"{sharded_serving['phase_s']:.1f} s, explicit scheduler phase "
          f"{explicit['phase_s']:.1f} s)")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
