#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card and
the CUDA toolkit. Phases (each raises on failure; nothing is caught):

1. Print the card's name and power limit (nvidia-smi), and start rendering
   the courses on every core but one (``CourseRender``; each course's
   first frames first, for phase 3), which goes on through phases 2-3.
2. Build the CUDA kernels (one source, one library) from
   ``visual_odom_tpu_torch/csrc`` with nvcc and print the build seconds,
   the ptxas report, each kernel instance's update loop as compiled
   (``sass``) and its resources as the runtime reports them (``instance``:
   registers, shared memory, features resident on the card).
3. Every check of this phase runs each of the four instances (doublestep x
   packed) of the kernel it checks, the plain version once for all four,
   and requires doublestep on and off to agree bit for bit (packed held
   fixed). Hold the LK quad kernel against its plain PyTorch version at
   KITTI size (1241x376) on the inputs the main path gives it: the fast quad (start
   level 1, 384 slots), the probe (start level 2, 64 slots), the safe quad
   (start level 2, 384 slots) and the safe quad as the adaptive policy
   launches it on a frame that is not aliased (all slots masked off).
   Statuses may differ on at most STATUS_MISMATCH_MAX features, tracks that
   agree within PT_TOL px (the packed instances, which sum in another
   order, under the knife-edge rule below on every label). Times the
   kernel's device work (CUDA events
   around a batch of calls queued behind a sleep kernel), one wrapper call
   with the host's time included, and the plain version.
   Then the batched launch at B = BATCH on the batched path's inputs (the
   fast quad, the probe, and the safe quad with sequences 1 and 3 masked
   off): bit for bit against B unbatched launches, and against its plain
   version under the same rules, per sequence, with one bounded exception
   for the aliased "checker" texture (see ``compare_kernel``): a
   knife-edge track that lands elsewhere counts as a status flip unless
   the float64 plain version sides with the kernel.
   The level kernel of the per-leg route (``lk_backend="xla"``) under the
   same rules, on every level launch that ``lk_track_pyramid`` makes for
   leg L0 -> R0 seeded as ``circular_match`` seeds it: the fast leg (start
   level 1), the safe leg, the probe and the masked safe leg (start level
   2), and at B = BATCH the fast leg and the safe leg with sequences 1 and
   3 masked off. Then one leg L0 -> L1 from the pyramid top on the same
   content, kernel against plain under the JAX bench's one-leg parity rule
   (bench.py:307-316), and, for each instance, four chained
   ``lk_track_pyramid`` legs on the card against one quad launch on the
   same inputs, at start levels 1 and 2, single and batched: equal bit for
   bit. Then the same three checks (quad, every level launch of leg L0 ->
   R0, four chained legs against the quad) at start level 3 on the inputs a
   loop-edge measurement gives the kernels (``full_sl3_n384``): fresh
   bucketed points of frame 0, frame 1's pyramids, zero flow and
   disparity. Last, the fast quad and the fast leg at B = WIDE_B, where the
   card fills, to time the instances there.
4. Run the main path (the default instance), ``run_sequence_scan``, at
   1241x376, each frame a replay of the step's CUDA graph (captured, with
   its launches uncounted, before the timed run): 64 steps of the
   "straight" course and 160 steps of "straight" with the periodic "checker"
   texture (which exercises the adaptive fallback). Assert the bench gates
   (accept >= 0.9, ATE <= 1% of course length) and that the kernel ran
   LAUNCHES_PER_FRAME times per frame. The checker course runs at the
   length the JAX package's texture ablation was gated at
   (TEXTURE_ABLATION_r05.json, adaptive row: 0.834 m of 1.28 m): at 32
   steps the JAX package misses the ATE budget too (0.508 m of 0.256 m on
   the CPU: ``python tests/test_torch_pipeline.py lockstep 32``).
   Then the batched path, ``run_sequences_batched``: those two courses and
   BENCH_STEPS steps each of "turning" and "stress" (the quick bench's
   courses, phase 14) in lockstep (B = 4, unequal
   lengths), each held to the bench gates on its own steps, with
   LAUNCHES_PER_FRAME batched launches per batched step whatever B is.
   Then the same three runs on the per-leg route: the level kernel must
   run LEVEL_LAUNCHES_PER_FRAME times per frame or batched step and the
   quad kernel not at all; each run prints its max |delta pose| against
   the quad route's run of the same course.
5. Hold the card's step against the port's CPU step (the plain version,
   itself held to the JAX package by the CPU tests) on a small course fed
   the same RANSAC draws; and a batched step of two sequences against two
   single-sequence steps on the card, fed the same draws.
6. Check that a main-path step never synchronises with the host (CUDA sync
   debug mode "error"), then profile a few frames replayed from the
   step's CUDA graph: device time by kernel, device ops per frame, the
   route's LK kernels by name inside the replays (3 quads or 32 level
   launches a frame), the host's CUDA runtime calls per frame, and the
   device's busy share; the same for the per-leg route's step. The same
   for the batched step at each B of SWEEP_B (the four courses' first
   SWEEP_STEPS steps, tiled to B sequences), after timing those steps
   with ``run_sequences_batched``, graphed and eager (``scans(False)``) in
   turns: aggregate frames/s and ms per step. The sync check also runs
   one step made ``with_tracks`` and, for one sequence, one buffered step
   (``make_buffered_step_fn``).
7. The back end (one ``backend`` line per part), on LOOP_STEPS steps of the
   "loop" course: (a) ``run_sequence_scan(collect_tracks=True)`` under the
   bench gates, one snapshot per step whose valid count is the step's
   ``num_matched``, and its first TRACKS_COST_STEPS steps timed without and
   with collection (the same chain bit for bit); (b) ``smooth_trajectory_ba`` with the CLI's defaults,
   gated as the JAX package behaves on this course (within the bench's ATE
   budget: JAX itself does not bring it below the chain's here), and with
   the km-scale config (reported); (c) ``close_loops`` on the raw chain as
   bench.py:220-222 calls it: at least one edge, the closure shrinks, ATE
   at most LOOP_ATE_FACTOR x the chain's, two quad launches per
   measurement, all from the pyramid top, and on the per-leg route the
   same edges, graph and poses bit for bit with 2 x LEG_STEP_LAUNCHES level
   launches per measurement; (d) the first window's BA problem and the
   loop run's pose graph solved on the card and on the CPU, within
   BA_CARD_CPU_TOL and NODE_CARD_CPU_TOL.
8. On phase 4's "straight" frames (nothing more is rendered): (a)
   ``resume``: ``run_sequence_scan_resumable`` with chunk RESUME_CHUNK and
   a snapshot every RESUME_EVERY steps, uninterrupted, failed by an
   injected exception at frame RESUME_CRASH_AT, and resumed from its last
   snapshot, with track snapshots (phase 11's command line resumes the
   scan without them); the resumed run equals the uninterrupted one and
   ``run_sequence_scan`` bit for bit; each snapshot's
   write ms and bytes. (b) ``mono`` and ``shi_tomasi``: the main path with
   ``mono_rotation=True`` or ``detector="shi-tomasi"`` on both LK routes,
   under the bench gates (where the JAX package on the CPU misses the ATE
   budget, VARIANT_ATE_FACTOR x its ATE), the routes bit for bit, the
   default step's LK launches per frame, no host sync in the step, and
   device ms and ops per step beside the default step's; for Shi-Tomasi
   also the corners per frame before bucketing.
9. The front doors, on phase 4's frames (nothing more is rendered), each
   replaying the step's CUDA graph (one replay a frame for
   ``VisualOdometry`` and the buffered step) and each
   held bit for bit to phase 4's ``run_sequence_scan`` of the course on the
   quad route (poses and every output field) and to its kernel launches
   per frame; one ``front_doors`` line per part: (a) ``run_sequence`` on
   "straight" with collected tracks, metrics and poses files and an
   offscreen ``LiveDisplay`` (each ``FrameResult`` against the scan's
   outputs; the poses file read back through ``load_poses``; each track
   snapshot's valid count is its step's ``num_matched``); (b)
   ``run_sequence_resumable`` with a snapshot every DOOR_EVERY frames,
   uninterrupted, failed at frame DOOR_CRASH_AT and resumed (snapshot ms
   and bytes); (c) ``run_sequence_buffered(preupload=True)``; (d) the
   bench's scan variants (bench.py:126-138) on the first
   DOOR_CHECKER_STEPS steps of the checker course, where the adaptive
   fallback fires (against the same steps of phase 4's scan):
   ``preupload``, one upload thread and four,
   with their frames/s and uploader stats; (e) the per-leg route through
   four upload threads, equal to the quad route.
10. KITTI input, on phase 4's frames (nothing more is rendered): the
   batched courses become KITTI directories of PNGs (written with the
   standard library's ``zlib``) and ground-truth pose files; the native
   runtime is built from ``native/`` and is the only decoder (``cv2`` and
   ``PIL`` are hidden, so a fallback raises). One ``kitti`` line per part:
   (a) ``data``: the library's build seconds, the PNGs written, the
   native decode's µs per image; (b) ``stream``:
   ``KittiSequence.iter_prefetched`` into ``run_sequence_scan`` with 1 and
   4 upload threads, in turns with the in-memory scan, each bit for bit
   phase 4's scan of "straight", with ms per frame and the uploader's
   ``busy_frac``; (c) ``batch``: ``run_sequences_batched`` over the four
   ``KittiSequence``s, failed at frame KITTI_CRASH_AT with a snapshot every
   KITTI_EVERY steps, and resumed, bit for bit phase 4's ``batch_path``
   (poses and statistics; phase 11's ``run-batch`` reads them
   uninterrupted), under the bench gates, with the snapshots' ms and
   bytes; (d) ``eval``: ``eval_all`` over the pose files written, each
   sequence's ATE within EVAL_ATE_TOL of the in-memory poses' (the
   devkit's ATE is Horn-aligned, so it lies at or below phase 4's
   unaligned figure, printed beside it), with t_err and r_err where a
   course is 100 m or longer.
11. The command line and the pipelined runner, on phase 10's directories
   and phase 4's frames (nothing more is rendered or written as PNG),
   with a calibration file whose floats read back exactly (``repr``).
   One ``cli`` line per part, each command run in this process through
   ``runner.cli.main``: (a) ``run`` on "straight" with ``--chunk``
   CLI_CHUNK (pose file and scorecard: phase 10's stream poses and
   ``evaluate_sequence`` of them), ``--chunk 0``, the resumable chunked
   run (``--checkpoint``, a snapshot every CLI_EVERY steps: stopped at its
   first snapshot by ``--max-frames``, resumed, then run again on the
   finished snapshot) and ``--ba-window`` CLI_BA_WINDOW (against
   ``smooth_trajectory_ba`` on phase 8's track snapshots of the scan),
   each pose file byte for byte phase 4's scan, with its launches per
   frame and ms per frame; (b) ``run-batch`` over the four directories
   (chunk CLI_BATCH_CHUNK, snapshots every CLI_BATCH_EVERY steps, ground
   truth): each file phase 4's batched poses, each sequence under the
   bench gates, and ``--data-parallel 2`` on the one card refused (exit
   2); (c) ``eval`` and ``eval-all`` on those files, each ATE phase 10's
   within EVAL_ATE_TOL. Then ``pipe`` lines: ``run_sequence_pipelined``
   on "straight" with both stages on this card (two CUDA streams), on
   both LK routes, every output field bit for bit phase 4's scan of the
   route (``num_bucketed`` against ``num_matched``, as the JAX package's
   pipe reports it), the route's launches per frame, its loop under CUDA
   sync debug mode "error"; ms per frame in two turns with the in-memory
   scan, and device ms per frame and busy share over PIPE_PROFILE_STEPS
   frames under torch.profiler. The command line's unchunked ``run`` and
   the pipe's two stages replay CUDA graphs.

12. The multi-device paths, on meshes built from this card named once per
   position (nothing more is rendered). ``sharded_ba``:
   ``sharded_ba_solve`` over MODEL_SHARDS landmark shards against
   ``ba_solve`` on the card at SHARDED_BA_PROBLEMS' sizes, ms per GN
   iteration of both. ``ring_ba``: ``ring_ba_solve`` over RING_WINDOWS
   windows of a RING_POSES-pose, RING_LANDMARKS-landmark trajectory against
   ``ba_solve`` (halo 2; auto halo with Huber 1.5), ms per GN round beside
   ``ba_solve``'s ms per iteration; the same problem through
   ``make_ring_window_solver``; ``smooth_trajectory_ba`` with that solver on
   phase 8's track snapshots against the default solver; the branch each
   problem took, at least one on the ring. ``posegraph_sharded``:
   ``close_loops(mesh=)`` on phase 7's loop course against phase 7's run,
   the closure before and after. ``batch_mesh``: phase 4's batched courses,
   MESH_STEPS steps, on each of MESH_SHAPES and both LK routes, each against
   the one-device run at its rows' batch (phase 4's for one data row; a
   run per row of its own sequences for two: cuBLAS's kernels depend on
   the batch) bit for bit, or SAME_TOL with the largest difference, and
   against phase 4's run (printed), under the bench gates (the checker
   course's ATE gated at full length only, as phase 4 explains), every chunk
   under sync debug mode "error", each LK launch (the quad's, or the
   per-leg route's level launches) split into ``model`` slices. ``cli``:
   ``run --ba-window CLI_BA_WINDOW --ba-ring RING_WINDOWS`` (one visible
   card: the one-device branch) byte for byte phase 11's ``--ba-window``
   file; ``run-batch --data-parallel 2`` refused on one card and, through
   a device list of this card named twice, stepped on a (2, 1) mesh to the
   poses of its rows' one-device runs.
13. The same paths across processes, one rank per mesh position, on this
   card (``ranks`` lines): GLOO_RANKS ranks over gloo (an explicit choice:
   NCCL refuses two ranks on one card) and one rank over NCCL at world
   size 1, spawned together (``chip_smoke.py --rank ...``), each with
   RANK_TIMEOUT s; a failed or late rank fails the phase. The gloo ranks
   first record whether gloo's all-gather and broadcast take CUDA
   tensors, and two more processes whether its ``batch_isend_irecv`` does
   (it does not: the port's gloo ``ppermute`` goes through the host; the
   probe may end its own processes, which is recorded). Every rank
   runs a ring ``ppermute`` (at world size 1 a send to itself through
   NCCL's ``batch_isend_irecv``), ``sharded_ba_solve`` at
   SHARDED_BA_PROBLEMS[0], ``ring_ba_solve`` on phase 12's problem,
   ``close_loops(mesh=)`` on phase 7's chain with the frames phase 12
   read (passed in an ``.npz``), and phase 4's batched courses (an
   ``.npy``) for MESH_STEPS steps on RANK_MESHES on both LK routes. Each
   result is held bit for bit to its one-process counterpart on the same
   mesh shape (phase 12's batched runs; the solves and the loop closure
   on this card named once per rank, computed meanwhile), with each
   rank's launches per path, and on NCCL every chunk under sync debug
   mode "error". With two cards or more, two NCCL ranks over cards 0 and
   1 (``chip_smoke.py --cards-rank ...``, CARDS_RANK_TIMEOUT s) then run
   ``sharded_ba_solve``, ``ring_ba_solve``, the edge-sharded pose graph
   and the batched runner on CARDS_RANK_MESHES, eager and then replaying
   graphs that hold their NCCL collectives: each path graphed bit for bit
   its eager run with equal launches, the same on both ranks (the
   ``ranks`` line of part ``nccl_across_cards``); on one card that line
   says the check did not run, and why. ``chip_smoke.py
   --nccl-across-cards`` runs that check alone.
14. The bench harness (``bench`` lines): the port's ``vo bench --quick``
   (``visual_odom_tpu_torch.bench``: 65 frames of straight, turning and
   stress, the one-leg parity check, ``bench_lk``) in a subprocess on this
   card, over a course cache holding phase 4's straight, turning and
   stress courses (BENCH_QUICK_FRAMES each); it must exit 0 with ``accuracy_ok``
   true and frames/s above 0. Then the bench's ``main`` in this process on
   straight alone, with the launch counts on: 3 quads per scanned frame,
   ``bench_lk``'s quads and its parity leg's level launches, nothing else.
15. The step as one CUDA graph (``graph`` lines; ``utils.cudagraph``). The
   scan family's step (``make_scan_step_fn``) replayed from its graph
   against the eager step (``_graph=False``) on GRAPH_STEPS steps of
   "straight" on both LK routes, the four batched courses in lockstep
   (B = BATCH), "straight" with track snapshots, and GRAPH_MONO_STEPS
   steps of mono rotation: every output field, the poses, the final
   state's arrays and its generators' state bit for bit, each run with
   the route's launches per step (a replay adds the launches its graph
   holds to the wrappers' counts); the eager run is also held to phase
   4's ``run_sequence_scan`` of the course, graphed by default. Then the
   resumable scan replayed from the graph, failed and resumed, against
   the eager uninterrupted run (poses, outputs, track snapshots, the last
   snapshots' arrays); one replay under sync debug mode "error"; ms a
   frame of ``run_sequence_scan`` graphed and eager in GRAPH_ROUNDS paired
   rounds on both routes and mono, with phase 6's device ms and busy
   share; the sweep's graphed and eager aggregate frames/s; and the
   captures made (seconds each, launches per replay, replays).
16. The per-frame doors, the stepwise batched runner, the pipe and the
   back end's solves as CUDA graphs (``doors_graph`` lines;
   ``utils.cudagraph``), each graphed run (the default on a card) against
   its eager run (``utils.cudagraph.dispatch(False)``) bit for bit, with its
   launches, the replays it made and ms a step both ways in
   DOOR_GRAPH_ROUNDS paired rounds on DOOR_GRAPH_STEPS steps of
   "straight": ``VisualOdometry`` with track snapshots (every
   ``FrameResult`` field, every snapshot, the final state and its
   generator's state), ``run_sequence_buffered``, ``run_sequences_batched
   (chunk=0)`` over the batched courses (B = BATCH) and
   ``run_sequence_pipelined`` with both stages on this card; the command
   line's unchunked ``run synthetic`` (CLI_GRAPH_FRAMES frames, pose files
   byte for byte); on phase 7's loop course ``smooth_trajectory_ba`` with
   the CLI's settings (and one window's solve, ms per GN iteration both
   ways), ``close_loops`` (its loop edges and pose graph; the pose graph's
   solve timed both ways).
17. The multi-device paths as CUDA graphs (``mesh_graph`` lines;
   ``utils.cudagraph``), each graphed run (the default on a card) against
   its eager run (``dispatch(False)``) bit for bit: every output, the final
   state's arrays, the generators' state and the launches. Phase 4's
   batched courses (MESH_GRAPH_STEPS steps, one chunk) through the mesh
   scan on MESH_SHAPES (this card named 2 and 4 times) on both LK routes,
   the capture under sync debug mode "error", with ms a mesh step both
   ways in paired rounds (MESH_GRAPH_ROUNDS on the quad route, one on the
   per-leg route) and the host's runtime calls a step both ways; the
   stepwise mesh step; ``sharded_ba_solve``, ``ring_ba_solve`` (and the
   ring window solver) and ``close_loops(mesh=)`` (its edge-sharded pose
   graph) over this card named MODEL_SHARDS / RING_WINDOWS times, with ms
   a GN iteration or ring round both ways in paired rounds; then one NCCL
   rank at world size 1 in this process (``initialize_distributed``): the
   rank's scan on both routes and the three solvers, graphed (the NCCL
   collectives inside the graphs) against eager, the rank's ms a step both
   ways.
18. PnP-RANSAC's refinement kernels (``pnp`` lines; ``backend.pnp``,
   ``csrc/pnp_gn.cu``): built, each held to its plain twin at the main
   path's shapes (PNP_N slots, PNP_HYPS hypotheses of PNP_SAMPLE points,
   PNP_ITERS iterations and twice as many for the polish) at each B of
   PNP_B (``io.pnp_scene``'s scene, the card tests' criteria): no pose
   finite on one side alone; the polish within PNP_POLISH_TOL of the plain
   twin; the hypotheses' distance to the float64 plain twin, at
   PNP_HYP_QUANTILES, at most PNP_HYP_FACTOR x the plain twin's; each
   launch's device ms eagerly and in a graph's replay (equal to the eager
   launch bit for bit) beside the plain twin's replay and its latency
   bound; ``pnp_ransac`` on the card launching each kernel once.
   ``chip_smoke.py --pnp`` runs this phase alone.

Every run whose launches a phase checks is held to one launch of each PnP
kernel a step as well (``check_counts``; every counter of
``utils.cudagraph`` is set to 0 before the run and read after it), and
each profiled replay shows each PnP kernel once a step.

Prints the ``{"kernels": [...]}`` line (the PnP kernels' rows with their
launches on each path driven), the card line, and last
``{"ok": true, "device": {...}}``. Exits non-zero without a card, or when
the port is not beside this script.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import io
import json
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

H, W = 376, 1241
STRAIGHT_STEPS = 64
CHECKER_STEPS = 160
#: "turning" and "stress": the quick bench's length (``bench --quick``,
#: 65 frames), so that phase 14 runs the bench on these very frames
BENCH_STEPS = 64
CHUNK = 32
BATCH = 4
#: B = 11: the KITTI odometry sequences with ground truth, 00-10
SWEEP_B = (1, 4, 11)
#: the batch at which the instances are timed again, where the card fills
WIDE_B = 11
SWEEP_STEPS = 16
LAUNCHES_PER_FRAME = 3        # fast quad + probe + safe quad (masked)
#: per-leg route: 4 legs x (2 fast + 3 probe + 3 safe) levels
LEVEL_LAUNCHES_PER_FRAME = 32
STATUS_MISMATCH_MAX = 2       # hard thresholds can flip a feature or two
PT_TOL = 1e-3                 # px, on tracks whose statuses agree
#: px; a track whose plain result moves by PT_TOL or more when the points
#: shift by +-KNIFE_SHIFT sits on a knife edge (on an aliased texture a
#: rounding-level change picks another local minimum)
KNIFE_SHIFT = 1e-5
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 non-tensor FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
#: ~25 ms of torch.cuda._sleep at the H100's 1980 MHz boost clock: longer
#: than the host takes to issue a timed batch of kernel calls
SLEEP_CYCLES = 50_000_000
#: per-(feature, leg, level) template setup, as the plain version computes
#: it: separable Scharr (8 flops per px of the 22x24 vertical pass and of the
#: 22x22 horizontal pass), three 21x21 bilinears (7 flops/px), G (6
#: flops/px), the gate
SETUP_FLOPS = 8 * 22 * 24 + 8 * 22 * 22 + 441 * (3 * 7 + 6) + 30
#: per update: 21x21 bilinear (7), diff (1), b1 and b2 (4), reductions, 2x2
ITER_FLOPS = 441 * 12 + 100
#: side of the template superblock (21x21 window + bilinear + Scharr support)
BLOCK = 24
#: window pixels of a lane: 441 over 32 lanes, or over 8 when packed
PIXELS_PER_LANE = {False: 14, True: 56}
#: per-feature inputs (pts, flow, disp, valid) and outputs (4 legs, status)
FEATURE_BYTES = (2 + 2 + 2 + 1) * 4 + (4 * 2 + 1) * 4
#: level kernel, per feature: prev, init, valid in; out, ok out
LEVEL_FEATURE_BYTES = (2 + 2 + 1) * 4 + (2 + 1) * 4
REPLACES = "visual_odom_tpu/ops/lk_pallas.py:299"
#: every instance (doublestep, packed) of both kernels, and the body of the
#: TPU kernel each quad instance stands for: the default body, the
#: VO_LK_DOUBLESTEP update (lk_pallas.py:638-651), the VO_LK_PACKED solve
#: (:486-579; the TPU's packed body has no double step)
INSTANCES = ((False, False), (True, False), (False, True), (True, True))
INSTANCE_REPLACES = {
    (False, False): REPLACES,
    (True, False): "visual_odom_tpu/ops/lk_pallas.py:638",
    (False, True): "visual_odom_tpu/ops/lk_pallas.py:486",
    (True, True): "visual_odom_tpu/ops/lk_pallas.py:486"}
REPLACES_BATCHED = "visual_odom_tpu/ops/lk_pallas.py:798"
REPLACES_LEVEL = "visual_odom_tpu/ops/lk_pallas.py:90"
#: `_build_level_call`, the call that jax.vmap batches for the vmapped step
REPLACES_LEVEL_BATCHED = "visual_odom_tpu/ops/lk_pallas.py:271"
#: bench.py:307-316, the one-leg parity check on real content: statuses
#: agree on more than this share of the tracks, agreed tracks within
#: REAL_LEG_PX
REAL_LEG_AGREE = 0.8
REAL_LEG_PX = 0.05
SOURCE = "visual_odom_tpu_torch/csrc/lk_legs.cu"
#: the batched path's sequences, in batch order: (course, texture family)
BATCH_COURSES = (("straight", "value"), ("straight", "checker"),
                 ("turning", "value"), ("stress", "value"))
#: the back end's course: "loop" closes its square at frame 320 (~256 m)
LOOP_STEPS = 320
#: steps timed without and with snapshot collection
TRACKS_COST_STEPS = 32
#: one loop-edge step (full pyramid, lk_skip_mode "fixed"): one quad, or 4
#: legs x 4 levels on the per-leg route
LEG_STEP_LAUNCHES = 16
#: windowed BA, the CLI's defaults for a short course (cli.py:473-484) and
#: the km-scale config (SOAK_r05.json "ba")
BA_SHORT = dict(window=8, iterations=8, max_landmarks=256, min_track_len=3,
                huber_delta=1.5)
BA_KM = dict(window=16, iterations=8, max_landmarks=384, min_track_len=5,
             huber_delta=0.8)
#: phase 8: the resumable runner's chunk and snapshot interval, and the
#: frame at which a run is made to fail (its last snapshot is at step 32)
RESUME_CHUNK = 16
RESUME_EVERY = 32
RESUME_CRASH_AT = 40
#: phase 9: steps of the checker course the bench's scan variants take
DOOR_CHECKER_STEPS = 64
#: phase 9: the resumable door's snapshot interval (frames) and failure
DOOR_EVERY = 16
DOOR_CRASH_AT = 40
#: phase 10: the batched KITTI run's snapshot interval (steps) and the
#: frame at which it is made to fail (its last snapshot is at step 64)
KITTI_EVERY = 64
KITTI_CRASH_AT = 100
#: phase 10: eval_all's ATE (read back from the ``%.9e`` pose files)
#: against the same ATE of the in-memory poses, in metres
EVAL_ATE_TOL = 1e-6
#: phase 11: the command line's chunked runs (``--chunk``, the resumable
#: one's ``--checkpoint-every``), ``run-batch``'s chunk and snapshot
#: interval, and the window of ``--ba-window``
CLI_CHUNK = 32
CLI_EVERY = 32
CLI_BATCH_CHUNK = 16
CLI_BATCH_EVERY = 64
CLI_BA_WINDOW = 8
#: phase 11: frames of the pipelined runner under torch.profiler
PIPE_PROFILE_STEPS = 8
#: phase 8 gate where the JAX package itself misses the ATE budget on the
#: course: within this factor of its ATE (PR 5's rule for BA)
VARIANT_ATE_FACTOR = 1.1
#: the JAX package on the CPU over the 64 steps of "straight" at 1241x376
#: (``python tests/test_torch_essential.py mono 64`` / ``shi-tomasi 64``)
JAX_VARIANTS = {
    "mono": {"accept": 1.0, "ate_m": 0.11756766261630905},
    "shi_tomasi": {"accept": 1.0, "ate_m": 0.038680731003437205}}
#: close_loops' ATE bar (tests/test_posegraph.py:168-169)
LOOP_ATE_FACTOR = 1.05
#: card against CPU: poses, the JAX package's ring-vs-single bound
#: (tests/test_ba_window.py:122); nodes, its sharded-vs-single bound
#: (tests/test_posegraph.py:106)
BA_CARD_CPU_TOL = 5e-4
NODE_CARD_CPU_TOL = 2e-4
#: phase 12: meshes over this card named several times. Landmark-sharded
#: BA over MODEL_SHARDS shards on (poses, landmarks) problems of the short
#: and the km-scale BA config, held as tests/test_parallel.py:32-37 holds
#: the JAX package's
MODEL_SHARDS = 4
SHARDED_BA_PROBLEMS = ((8, 256), (16, 384))
SHARDED_BA_ITERS = 8
SHARDED_POSE_TOL = 1e-4
SHARDED_LM_TOL = 1e-3
#: the ring over RING_WINDOWS windows on a long synthetic trajectory, held
#: as tests/test_ring_ba.py:71 and :128 hold the JAX package's (the exact
#: halo; auto halo with Huber) and tests/test_ba_window.py:122 its
#: smoothing. Tracks span up to 5 keyframes (obs_window 2, halo 4): with
#: 3-keyframe tracks a 64-pose chain is too weakly coupled for the CG in
#: float32 (Huber: 1.6e-3 from ba_solve on this card at 256 iterations,
#: the JAX package's ring 2.5e-3 on the CPU). 32 CG iterations (the
#: default) leave ~0.2 in both packages; 256 reach ~1e-5
RING_WINDOWS = 4
RING_POSES, RING_LANDMARKS = 64, 1024
RING_OBS_WINDOW = 2
RING_HALO = 4
RING_CG_ITERS = 256
RING_ROUNDS = 10
RING_TOL = 1e-4
RING_HUBER_TOL = 5e-4
RING_SMOOTH_TOL = 5e-4
#: phase 4's batched courses on (data, model) meshes, each against the
#: one-device run at its rows' batch (tests/test_torch_batch.py:59's bound
#: where a pose is not bit for bit); 16 steps, one chunk (cut from 32 to
#: make room for phase 13: each mesh run issues every row's ops from one
#: thread)
MESH_STEPS = 16
MESH_CHUNK = 16
MESH_SHAPES = ((2, 1), (1, 2), (2, 2))
SAME_TOL = 1e-5
#: phase 13: ranks on this card over gloo (two processes may not share one
#: card under NCCL), and each spawned rank's time limit (s)
GLOO_RANKS = 2
RANK_TIMEOUT = 240
SEND_PROBE_TIMEOUT = 60
#: phase 13's meshes of ranks, by world size
RANK_MESHES = {2: ((2, 1), (1, 2)), 1: ((1, 1),)}
#: phase 13 with two cards or more: two NCCL ranks over cards 0 and 1, the
#: meshes they run (phase 4's first batched course pair, B = 2, on the
#: quad route) and their time limit (s)
CARDS_RANK_MESHES = ((2, 1), (1, 2))
CARDS_RANK_TIMEOUT = 300
#: phase 14: the bench's quick gauntlet (``vo bench --quick``): frames per
#: course (phase 4's straight, turning and stress courses have as many),
#: its courses, its scan chunk, and the quads its ``bench_lk`` launches (one
#: warm-up, 5 timed)
BENCH_QUICK_FRAMES = 65
BENCH_QUICK_COURSES = ("straight", "turning", "stress")
BENCH_CHUNK = 32
BENCH_LK_QUADS = 1 + 5
BENCH_TIMEOUT = 600
#: phase 15: steps of the graphed-vs-eager runs (phase 4's straight course
#: and batched courses; mono rotation, whose eager step is ~3x the
#: default's, on fewer), and the paired rounds of ms a frame, each round
#: one graphed and one eager run
GRAPH_STEPS = 64
GRAPH_MONO_STEPS = 32
GRAPH_ROUNDS = 3
#: phase 16: steps of the per-frame doors' graphed-vs-eager runs (phase
#: 4's straight course; its batched courses for the stepwise runner), the
#: paired rounds of ms a frame (each round one graphed and one eager run),
#: the command line's unchunked run's frames, and the solves timed per
#: mode
DOOR_GRAPH_STEPS = 64
DOOR_GRAPH_ROUNDS = 2
CLI_GRAPH_FRAMES = 17
SOLVE_REPS = 5
#: phase 17: steps of the graphed-vs-eager mesh runs (phase 4's batched
#: courses, one chunk), paired rounds of ms a mesh step on the quad route
#: (one on the per-leg route), the stepwise mesh steps, the steps under
#: torch.profiler (host runtime calls), the ring's timed rounds and the
#: solves' paired rounds. 8 steps and one round: at 16 and two the phase
#: took 89-161 s, its eager runs most of it, and the script 938 s on a
#: slow host
MESH_GRAPH_STEPS = 8
MESH_GRAPH_ROUNDS = 1
MESH_GRAPH_STEPWISE = 4
MESH_GRAPH_PROFILE_STEPS = 2
RING_GRAPH_ROUNDS = 2
SOLVE_GRAPH_ROUNDS = 2
#: phase 18: PnP-RANSAC's refinement at the main path's shapes: 384 slots,
#: 500 hypotheses of 6 points, 6 GN iterations and 12 for the polish over
#: the slots, at B = 1 (the live door) and B = 11 (the batched runner)
PNP_N = 384
PNP_HYPS = 500
PNP_SAMPLE = 6
PNP_ITERS = 6
PNP_B = (1, 11)
#: KITTI 00's camera
PNP_K = ((718.856, 0.0, 607.1928), (0.0, 718.856, 185.2157), (0.0, 0.0, 1.0))
PNP_SOURCE = "visual_odom_tpu_torch/csrc/pnp_gn.cu"
#: what the PnP kernels replace: no Pallas kernel, XLA's fused code
PNP_REPLACES = "none (XLA-fused visual_odom_tpu/backend/pnp.py:64)"
#: the PnP kernels' launch counters (``utils.cudagraph``), by kernel
PNP_COUNTERS = {"pnp_hypotheses": "pnp_gn_hypotheses_kernel",
                "pnp_polish": "pnp_gn_polish_kernel"}
#: the PnP launches of the runs whose counts are checked, by counter and
#: path (``tally_pnp``; phase 18's own calls are not among them), and the
#: path they now belong to (``set_path``)
PNP_LAUNCHES = {k: {} for k in PNP_COUNTERS}
PNP_PATH = ["main_path"]
#: phase 18 holds the kernels to their plain twins as the card tests do:
#: the polish within PNP_POLISH_TOL of the plain twin, relative to
#: 1 + |pose| (the two differ only in the order of the sums of the normal
#: equations); the hypotheses, finite where the plain twin's are, by the
#: distribution of their distance to the float64 twin, at each of
#: PNP_HYP_QUANTILES at most PNP_HYP_FACTOR x the plain twin's (+ 1e-7)
PNP_POLISH_TOL = 1e-5
PNP_HYP_QUANTILES = (0.5, 0.9)
PNP_HYP_FACTOR = 2.0
#: a lower bound, counted by hand in csrc/pnp_gn.cu, of the dependent
#: float32 operations on a thread's path through one GN iteration, each
#: counted as one (a division, square root or sine too): the transform to
#: the first Jacobian entry (11), the damping (1), the Cholesky (6 a
#: column), the two triangular solves (3 a row each), the finiteness test
#: (1), the Rodrigues update (10) and the 3x3 product (3). The normal
#: equations add 2 for each point a thread sums, the polish's reduction
#: 10 for the warp's shuffles, 2 for shared memory and 1 a further warp
PNP_CHAIN_ITER = 98
#: the first Rodrigues and the last inverse Rodrigues of a pose
PNP_CHAIN_ENDS = 22
#: the fewest cycles a dependent float32 operation takes on Hopper
FP32_LATENCY_CYCLES = 4


def kitti_intrinsics(height: int, width: int):
    """The bench's camera: KITTI 00 focal length scaled to the width."""
    from visual_odom_tpu_torch.config import CameraIntrinsics

    s = width / 1241.0
    return CameraIntrinsics(fx=718.856 * s, fy=718.856 * s, cx=width / 2.0,
                            cy=height / 2.0, bf=-718.856 * s * 0.537,
                            width=width, height=height)


#: courses built in a render worker process, by their arguments
_COURSES = {}


def _render_frames(args):
    """Frames ``lo``..``hi`` of one course, in a render worker process."""
    from visual_odom_tpu_torch.io.synthetic import make_course

    name, family, n, height, width, lo, hi = args
    key = (name, family, n, height, width)
    if key not in _COURSES:
        _COURSES[key] = make_course(name, kitti_intrinsics(height, width),
                                    num_frames=n, texture_family=family)
    return [_COURSES[key].frame(i) for i in range(lo, hi)]


class CourseRender:
    """Courses rendered on a pool of ``workers`` spawned processes while the
    caller goes on (the renderer holds the GIL for much of a frame, so
    threads reach ~2x on 8 cores); a frame depends only on the course and
    its index. Each course's first ``first_frames`` frames are one job,
    submitted before every other, so ``first`` returns soon; ``result``
    waits for every frame. ``close`` (or leaving the ``with`` block) drops
    what has not started and stops the workers."""

    def __init__(self, specs, height, width, workers=None, first_frames=3):
        import multiprocessing

        workers = workers or os.cpu_count() or 1
        self._specs = list(specs)
        self._size = (height, width)
        self._ex = concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"))
        self._jobs = {}
        for name, family, n in self._specs:
            self._jobs[(name, family)] = [self._submit(
                name, family, n, 0, min(first_frames, n))]
        for name, family, n in self._specs:
            lo = min(first_frames, n)
            cuts = np.linspace(lo, n, min(n - lo, 2 * workers) + 1).astype(int)
            self._jobs[(name, family)] += [
                self._submit(name, family, n, int(a), int(b))
                for a, b in zip(cuts[:-1], cuts[1:]) if b > a]

    def _submit(self, name, family, n, lo, hi):
        return self._ex.submit(_render_frames,
                               (name, family, n, *self._size, lo, hi))

    def first(self, key):
        """The first frames of course ``key`` (name, family)."""
        return self._jobs[key][0].result()

    def result(self):
        """{(name, family): (frames, gt poses)} of every course."""
        from visual_odom_tpu_torch.io.synthetic import make_course

        intr = kitti_intrinsics(*self._size)
        return {(name, family): (
            [f for job in self._jobs[(name, family)] for f in job.result()],
            make_course(name, intr, num_frames=n,
                        texture_family=family).poses)
            for name, family, n in self._specs}

    def close(self):
        self._ex.shutdown(cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def render_courses(specs, height, width):
    """{(name, family): (frames, gt poses)} of the (name, family, frames)
    specs, rendered on a pool of one process per core."""
    with CourseRender(specs, height, width) as render:
        return render.result()


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def instance_name(inst) -> str:
    return f"doublestep={int(inst[0])},packed={int(inst[1])}"


def sass_loops(lib: str) -> dict:
    """Per kernel instance of the built library, its update loop as
    compiled: the innermost loop that holds the update's window loads (4 per
    window pixel of a lane: global loads without window reuse, shared loads
    with it), counted in cuobjdump's SASS (instructions, and how many of
    them are integer adds and address arithmetic). Empty where the toolkit
    has no cuobjdump."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    kernels, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s+Function : \S*?(lk_(?:quad|level)_kernel)ILi(\d+)ELb([01])E",
                     line)
        if m:
            inst = (m.group(3) == "1", m.group(2) == "8")
            name = f"{m.group(1)}[{instance_name(inst)}]"
            kernels[name] = (4 * PIXELS_PER_LANE[inst[1]], [])
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and name:
            kernels[name][1].append((int(m.group(1), 16), m.group(2).strip()))

    def opcode(text):
        # "@!PT" guards an instruction that never runs (ptxas pads
        # asynchronous copies with such loads)
        if text.startswith("@!PT "):
            return "NOP"
        return re.sub(r"^@!?U?P\w+\s+", "", text).split()[0].split(".")[0]

    out = {}
    for name, (window_loads, ins) in kernels.items():
        index = {a: i for i, (a, _) in enumerate(ins)}
        loop = None
        for i, (a, text) in enumerate(ins):
            m = re.search(r"BRA.*?0x([0-9a-f]+)", text)
            if m and int(m.group(1), 16) < a:  # a backward branch closes a loop
                body = [opcode(t) for _, t in
                        ins[index.get(int(m.group(1), 16), 0):i + 1]]
                if (sum(o in ("LDG", "LDS") for o in body) == window_loads
                        and (loop is None or len(body) < len(loop))):
                    loop = body
        if loop:
            out[name] = {"update_loop_instructions": len(loop),
                         "integer_and_address_ops": sum(
                             o in ("IADD3", "LEA", "IMAD") for o in loop),
                         "window_loads": window_loads}
    return out


def time_ms(fn, reps: int, warm: int):
    """Median ms per call with CUDA events, after ``warm`` calls. The span
    includes the host's time to issue the call (and any sync inside it)."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, calls: int = 20, rounds: int = 7, warm: int = 3):
    """Median device ms per call of ``fn``, which must not sync: a sleep
    kernel holds the stream while the host issues ``calls`` calls between
    two events, so the events time the device's work alone."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def stacked_frames(frame_lists, n):
    """The first ``n`` frames of B sequences as (B, H, W) pairs."""
    return [(np.stack([f[i][0] for f in frame_lists]),
             np.stack([f[i][1] for f in frame_lists])) for i in range(n)]


def quad_inputs(frames, config, intr, dev):
    """The quad inputs the main path gives the kernel on frame 2: state
    after one step, then detection + bucketing, priors clamped as
    circular_match clamps them. Frames of (B, H, W) pairs give the batched
    path's inputs."""
    import torch

    from visual_odom_tpu_torch.frontend.bucketing import detect_and_bucket
    from visual_odom_tpu_torch.parallel import batch
    from visual_odom_tpu_torch.runner import pipeline

    step = pipeline.make_step_fn(config, intr, device=dev)
    if frames[0][0].ndim == 3:
        state = batch.batched_init_state(config, *frames[0], device=dev)
    else:
        state = pipeline.init_vo_state(config, intr, *frames[0], device=dev)
    state, _ = step(state, torch.from_numpy(frames[1][0]).to(dev),
                    torch.from_numpy(frames[1][1]).to(dev))
    pad = state.lk_l0.pad
    raw = state.lk_l0.pyramid[0][..., pad:pad + H, pad:pad + W]
    feats = detect_and_bucket(raw, state.features, config)
    lk_l1 = pipeline.prep_image(frames[2][0], config, dev)
    lk_r1 = pipeline.prep_image(frames[2][1], config, dev)
    lim = torch.tensor([W / 4.0, H / 4.0], device=dev)
    flow = torch.maximum(torch.minimum(feats.flow, lim), -lim).contiguous()
    disp = torch.maximum(torch.minimum(feats.disp, lim), -lim).contiguous()
    images = (state.lk_l0, state.lk_r0, lk_r1, lk_l1)   # quad order
    return images, feats.points.contiguous(), feats.valid, flow, disp


def full_pyramid_inputs(frames, config, intr, dev):
    """The quad inputs of a loop-edge measurement (``runner.loopclosure``):
    a state fresh from ``init_vo_state`` on frame 0 (no features), so the
    bucketed points are all fresh, frame 1's pyramids, and zero flow and
    disparity: the quad starts at the top of the pyramid."""
    import torch

    from visual_odom_tpu_torch.frontend.bucketing import detect_and_bucket
    from visual_odom_tpu_torch.runner import pipeline

    state = pipeline.init_vo_state(config, intr, *frames[0], device=dev)
    pad = state.lk_l0.pad
    raw = state.lk_l0.pyramid[0][..., pad:pad + H, pad:pad + W]
    feats = detect_and_bucket(raw, state.features, config)
    lk_l1 = pipeline.prep_image(frames[1][0], config, dev)
    lk_r1 = pipeline.prep_image(frames[1][1], config, dev)
    zero = torch.zeros_like(feats.points)
    images = (state.lk_l0, state.lk_r0, lk_r1, lk_l1)   # quad order
    return images, feats.points.contiguous(), feats.valid, zero, zero


def block_pixels(hp, wp, pad, corners, win, template=True):
    """Distinct plane pixels of the regions the kernels read at window
    corners ``corners`` (m, 2) of one level, placed as the kernels place
    them: the BLOCK x BLOCK template superblock, or (``template`` False)
    the (win + 1)-square J window of an update."""
    import torch

    ix = torch.floor(corners).clamp(-1e9, 1e9).long() + pad
    if template:
        size = BLOCK
        x0 = ix[:, 0].clamp(1, wp - win - 2) - 1
        y0 = ix[:, 1].clamp(1, hp - win - 2) - 1
    else:
        size = win + 1
        x0 = ix[:, 0].clamp(0, wp - win - 1)
        y0 = ix[:, 1].clamp(0, hp - win - 1)
    r = torch.arange(size, device=corners.device)
    seen = torch.zeros((hp, wp), dtype=torch.bool, device=corners.device)
    seen[(y0[:, None] + r)[:, :, None], (x0[:, None] + r)[:, None, :]] = True
    return int(seen.sum())


def plane_bytes(images, out, pts, valid, sl, win):
    """Bytes of the pyramid planes the quad must read, each pixel once: the
    union over valid features of the BLOCK x BLOCK template superblocks,
    per (image, level), placed as the kernel places them. Leg k's template
    in image k sits at the chain point leg k-1 ended on (leg 1's at pts).
    Leg k's J window in image k+1 ends where leg k+1's template is taken
    (leg 4's returns to leg 1's), inside that superblock to within the
    finer levels' sub-pixel corrections, so it is not counted again: the
    count is a lower bound."""
    pad = images[0].pad
    half = (win - 1) * 0.5
    total = 0
    for k, chain in enumerate([pts] + [out[j] for j in range(3)]):
        c = chain[valid]
        for lv in range(sl + 1):
            rows, cols = images[k].shapes[lv]
            total += block_pixels(rows + 2 * pad, cols + 2 * pad, pad,
                                  c / 2.0 ** lv - half, win)
    return total * 4


def quad_check(images, pts, valid, flow, disp, params, sl):
    """``compare_kernel``'s view of one lk_quad_kernel input set: outputs
    (4 legs, [B,] n, 2)."""
    from visual_odom_tpu_torch.ops import lk_cuda

    planes = [im.pyramid for im in images]
    shapes, pad = images[0].shapes, images[0].pad
    batched = pts.dim() == 3
    plain = lk_cuda.lk_quad_plain_batched if batched else lk_cuda.lk_quad_plain

    def kernel(doublestep=None, packed=None):
        return lk_cuda.lk_quad_cuda(planes, shapes, pad, pts, valid, flow,
                                    disp, params, sl, doublestep=doublestep,
                                    packed=packed)

    def plain_at(shift=0.0, double=False):
        pl, p, f, d = planes, pts, flow, disp
        if double:
            pl = [[x.double() for x in im] for im in planes]
            p, f, d = p.double(), f.double(), d.double()
        return plain(pl, shapes, pad, p + shift, valid, f, d, params, sl)

    def sequence(b, doublestep=None, packed=None):
        return lk_cuda.lk_quad_cuda([[p[b] for p in im] for im in planes],
                                    shapes, pad, pts[b], valid[b], flow[b],
                                    disp[b], params, sl, doublestep=doublestep,
                                    packed=packed)

    def work(out_k, st_k, iters):
        setups = int(valid.sum()) * 4 * (sl + 1)
        flops = setups * SETUP_FLOPS + int(iters.sum()) * ITER_FLOPS
        seqs = ([(out_k[:, b], valid[b], pts[b]) for b in range(pts.shape[0])]
                if batched else [(out_k, valid, pts)])
        nbytes = sum(plane_bytes(images, o, p, v, sl, params.window)
                     + pts.shape[-2] * FEATURE_BYTES for o, v, p in seqs)
        return flops, nbytes

    return types.SimpleNamespace(tag="quad", info={"start_level": sl},
                                 valid=valid, kernel=kernel, plain=plain_at,
                                 sequence=sequence, work=work,
                                 chains=lambda iters: iters.sum(dim=(-3, -2)))


def level_check(args, level):
    """``compare_kernel``'s view of one lk_level_cuda call at ``level``,
    given the arguments ``lk_track_pyramid`` passed it: outputs (1, [B,] n,
    2). The kernel gets the route's int32 mask, the plain version its
    bool."""
    from visual_odom_tpu_torch.ops import lk_cuda

    I, J, rows, cols, pad, prev, init, mask, params, finest = args
    valid = mask > 0
    batched = prev.dim() == 3
    plain = (lk_cuda.lk_level_plain_batched if batched
             else lk_cuda.lk_level_plain)

    def kernel(doublestep=None, packed=None):
        out, ok = lk_cuda.lk_level_cuda(I, J, rows, cols, pad, prev, init,
                                        mask, params, finest,
                                        doublestep=doublestep, packed=packed)
        return out[None], ok

    def plain_at(shift=0.0, double=False):
        i, j, p, s = (I, J, prev, init)
        if double:
            i, j, p, s = (x.double() for x in (I, J, prev, init))
        out, ok, iters = plain(i, j, rows, cols, pad, p + shift, s + shift,
                               valid, params, finest)
        return out[None], ok, iters

    def sequence(b, doublestep=None, packed=None):
        out, ok = lk_cuda.lk_level_cuda(I[b], J[b], rows, cols, pad, prev[b],
                                        init[b], mask[b], params, finest,
                                        doublestep=doublestep, packed=packed)
        return out[None], ok

    def work(out_k, st_k, iters):
        """Template superblocks of I at prev for valid features, J windows
        at the refined estimates of the features the level tracked."""
        flops = int(valid.sum()) * SETUP_FLOPS + int(iters.sum()) * ITER_FLOPS
        hp, wp = rows + 2 * pad, cols + 2 * pad
        pix = 0
        for b in range(prev.shape[0]) if batched else [None]:
            sel = (lambda t: t) if b is None else (lambda t: t[b])
            pix += block_pixels(hp, wp, pad, sel(prev)[sel(valid)],
                                params.window)
            pix += block_pixels(hp, wp, pad, sel(out_k[0])[sel(st_k)],
                                params.window, template=False)
        return flops, pix * 4 + valid.numel() * LEVEL_FEATURE_BYTES

    return types.SimpleNamespace(tag="level",
                                 info={"level": level, "finest": finest},
                                 valid=valid, kernel=kernel, plain=plain_at,
                                 sequence=sequence, work=work,
                                 chains=lambda iters: iters)


def compare_kernel(check, label, time_plain=True):
    """Every instance of the kernel (INSTANCES) vs the plain version on one
    input set (``quad_check`` or ``level_check``); returns {instance: result
    dict}. The plain version runs once for all instances. Its
    ``longest_chain`` is the most updates one feature makes in the launch
    (``check.chains``: per feature, over its legs and levels): one lane group
    runs them one after another, and the launch lasts at least that long;
    ``us_per_update`` is the launch's time over it.

    Unbatched inputs are held to the rule of the first slice: at most
    STATUS_MISMATCH_MAX status mismatches, and every track both tracked
    within PT_TOL px. Inputs with a leading batch dim take the batched
    launch, which must equal B unbatched launches bit for bit, and are then
    held per sequence to the same rule with one bounded exception, which
    the packed instances (another order of the sums) take on every label: a
    knife-edge track (one the plain version itself moves by PT_TOL or more
    when the points shift by +-KNIFE_SHIFT px) that lands elsewhere is
    counted as a status flip, unless the kernel's result is no farther
    (within PT_TOL) from the float64 evaluation of the plain version than
    the float32 plain version's is. The bound is the sum of the sequences'
    bounds. With ``packed`` held fixed, doublestep on and off must agree bit
    for bit."""
    import torch

    from visual_odom_tpu_torch.ops import lk_cuda

    valid = check.valid
    batched = valid.dim() == 2
    out_p, st_p, iters = check.plain()
    knife = torch.zeros_like(st_p)
    for shift in (KNIFE_SHIFT, -KNIFE_SHIFT):
        o, st, _ = check.plain(shift)
        knife |= (st != st_p) | ((o - out_p).abs().amax(dim=(0, -1)) >= PT_TOL)
    n_valid = int(valid.sum())
    out_64 = None
    default = lk_cuda.variant()
    outs, results = {}, {}
    for inst in INSTANCES:
        name = f"{label}[{instance_name(inst)}]"
        out_k, st_k = check.kernel(*inst)
        torch.cuda.synchronize()
        outs[inst] = (out_k, st_k)
        if batched:
            for b in range(valid.shape[0]):
                one = check.sequence(b, *inst)
                if not (torch.equal(one[0], out_k[:, b])
                        and torch.equal(one[1], st_k[b])):
                    raise AssertionError(f"{name}: sequence {b} of the "
                                         f"batched launch differs from its "
                                         f"own launch")
        both = st_k & st_p
        diff = (out_k - out_p).abs().amax(dim=(0, -1))

        def worst(mask):
            return float(diff[mask].max()) if bool(mask.any()) else 0.0

        # Diverged knife-edge tracks: the exception of the batched inputs
        # and of the packed instances.
        knife_div = (both & knife & (diff >= PT_TOL) if batched or inst[1]
                     else torch.zeros_like(both))
        arbitrated = torch.zeros_like(knife_div)
        tracks = []
        if bool(knife_div.any()):
            if out_64 is None:
                out_64 = check.plain(double=True)[0]
            k64 = (out_k.double() - out_64).abs().amax(dim=(0, -1))
            p64 = (out_p.double() - out_64).abs().amax(dim=(0, -1))
            arbitrated = knife_div & (k64 <= p64 + PT_TOL)
            tracks = [dict(seq=at[0] if batched else 0, slot=at[-1],
                           dpt=float(diff[tuple(at)]),
                           kernel_vs_f64=float(k64[tuple(at)]),
                           plain_vs_f64=float(p64[tuple(at)]))
                      for at in torch.nonzero(knife_div).tolist()]
        flips = (st_k != st_p) | (knife_div & ~arbitrated)
        mismatch = int(flips.sum(dim=-1).max())
        err_held = worst(both & ~knife_div)
        # Invalid slots pass through in both.
        err_inv = worst(~valid)
        if (mismatch > STATUS_MISMATCH_MAX or err_held >= PT_TOL
                or err_inv != 0.0):
            raise AssertionError(f"{name}: kernel disagrees with plain "
                                 f"version: {mismatch} status flips in one "
                                 f"sequence, max |dpt| {err_held}, "
                                 f"invalid-slot |dpt| {err_inv}, knife-edge "
                                 f"tracks {tracks}")
        results[inst] = dict(
            label=label, instance=instance_name(inst), default=inst == default,
            batch=valid.shape[0] if batched else 1, **check.info,
            n=valid.shape[-1], valid=n_valid, tracked=int(st_k.sum()),
            status_mismatch=int((st_k != st_p).sum()),
            max_abs_err=worst(both), max_abs_err_held=err_held,
            knife_edge=int((both & knife).sum()),
            knife_edge_diverged=int(knife_div.sum()),
            knife_edge_arbitrated=int(arbitrated.sum()),
            max_abs_err_knife_edge=worst(both & knife),
            knife_edge_tracks=tracks,
            ms=device_ms(lambda: check.kernel(*inst)),
            call_ms=time_ms(lambda: check.kernel(*inst), reps=50, warm=5))
    for packed in (False, True):
        (oa, sa), (ob, sb) = outs[False, packed], outs[True, packed]
        if not (torch.equal(oa, ob) and torch.equal(sa, sb)):
            raise AssertionError(f"{label}: doublestep on and off differ "
                                 f"(packed={packed})")
    # The plain version syncs once per iteration of its masked loop, so
    # its time is host and device together, as the main path would see it.
    # The calls above warmed it up.
    plain_ms = (time_ms(check.plain, reps=2 if batched else 3, warm=0)
                if time_plain else None)
    flops, nbytes = check.work(*outs[default], iters)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    chain = int(check.chains(iters).max()) if n_valid else 0
    for inst, res in results.items():
        res.update(plain_ms=plain_ms, updates=int(iters.sum()),
                   longest_chain=chain, flops=flops, bytes=nbytes,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   share_of_bound=max(t_bytes, t_ops) / res["ms"],
                   us_per_update=1e3 * res["ms"] / chain if chain else None,
                   doublestep_bit_exact=True)
        print(check.tag, json.dumps(res))
    return results


@contextlib.contextmanager
def recorded_calls(module, name):
    """Record the positional arguments of every call of ``module.name``
    made inside the block (e.g. the level inputs the per-leg route gives
    ``lk_cuda.lk_level_cuda``)."""
    real = getattr(module, name)
    calls = []

    def record(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def compare_leg(images, pts, valid, disp, params, sl, label, **kw):
    """Each level launch of leg L0 -> R0, seeded at pts + disp as
    ``circular_match`` seeds it, against the plain version on the inputs
    ``lk_track_pyramid`` gives it (``compare_kernel``, every instance)."""
    from visual_odom_tpu_torch.ops import lk_cuda
    from visual_odom_tpu_torch.ops.lk import lk_track_pyramid

    with recorded_calls(lk_cuda, "lk_level_cuda") as calls:
        lk_track_pyramid(images[0], images[1], pts, valid, params,
                         init_pts=pts + disp, start_level=sl)
    return [compare_kernel(level_check(args, sl - k), f"{label}_l{sl - k}",
                           **kw)
            for k, args in enumerate(calls)]


@contextlib.contextmanager
def instance_defaults(inst):
    """Both kernels' default instance set to ``inst`` (doublestep, packed)
    inside the block, so that the routes, which name none, run it."""
    from visual_odom_tpu_torch.ops import lk_cuda

    saved = lk_cuda.DEFAULT_DOUBLESTEP, lk_cuda.DEFAULT_PACKED
    lk_cuda.DEFAULT_DOUBLESTEP, lk_cuda.DEFAULT_PACKED = inst
    try:
        yield
    finally:
        lk_cuda.DEFAULT_DOUBLESTEP, lk_cuda.DEFAULT_PACKED = saved


def real_leg(images, pts, valid, params):
    """One leg L0 -> L1 (the temporal pair) from the pyramid top on the
    main path's content, the kernel's route against the plain version's
    on CPU copies, under the JAX bench's one-leg parity rule (bench.py:
    307-316)."""
    from visual_odom_tpu_torch.ops.lk import LKImage, lk_track_pyramid

    l0, l1 = images[0], images[3]
    pk, sk = lk_track_pyramid(l0, l1, pts, valid, params)
    cpu = [LKImage(tuple(p.cpu() for p in im.pyramid), im.shapes, im.pad)
           for im in (l0, l1)]
    pp, sp = lk_track_pyramid(*cpu, pts.cpu(), valid.cpu(), params)
    pk, sk, v = pk.cpu(), sk.cpu(), valid.cpu()
    agree = sk & sp
    share = int(agree.sum()) / max(1, int(v.sum()))
    dmax = float((pk - pp).abs()[agree].max()) if bool(agree.any()) else 0.0
    res = dict(valid=int(v.sum()), tracked_kernel=int(sk.sum()),
               tracked_plain=int(sp.sum()),
               status_mismatch=int((sk != sp).sum()), agree_share=share,
               max_abs_err=dmax, within_pt_tol=bool(dmax < PT_TOL))
    print("real_leg", json.dumps(res))
    if not (share > REAL_LEG_AGREE and dmax < REAL_LEG_PX):
        raise AssertionError(f"real-content leg: kernel vs plain {res}")
    return res


def route_vs_quad(images, pts, valid, flow, disp, params, sl, label):
    """Four chained ``lk_track_pyramid`` legs on the card, seeded as
    ``circular_match`` seeds them, against one lk_quad_kernel launch on
    the same inputs: positions and statuses equal bit for bit."""
    import torch

    from visual_odom_tpu_torch.ops import lk_cuda
    from visual_odom_tpu_torch.ops.lk import lk_track_pyramid

    out_q, st_q = lk_cuda.lk_quad_cuda([im.pyramid for im in images],
                                       images[0].shapes, images[0].pad, pts,
                                       valid, flow, disp, params, sl)
    p, status, legs = pts, valid, []
    for leg, (src, sgn) in enumerate(lk_cuda.QUAD_SEEDS):
        seed = disp if src == "disp" else flow
        p, ok = lk_track_pyramid(images[leg], images[(leg + 1) % 4], p, valid,
                                 params, init_pts=p + seed if sgn > 0 else p - seed,
                                 start_level=sl)
        legs.append(p)
        status = status & ok
    out_l = torch.stack(legs)
    res = dict(label=label, instance=instance_name(lk_cuda.variant()),
               start_level=sl, tracked=int(st_q.sum()),
               positions_differing=int((out_l != out_q).any(dim=-1).sum()),
               statuses_differing=int((status != st_q).sum()),
               max_abs_diff=float((out_l - out_q).abs().max()))
    print("route_vs_quad", json.dumps(res))
    if res["positions_differing"] or res["statuses_differing"]:
        raise AssertionError(f"{label}: per-leg route differs from the quad "
                             f"launch: {res}")
    return res


def ate_and_budget(poses, gt):
    """ATE RMSE and the bench's ATE budget, 1% of the course length
    (bench.py:145-150)."""
    err = np.linalg.norm(poses[:len(gt), :3, 3] - gt[:, :3, 3], axis=1)
    ate = float(np.sqrt(np.mean(err ** 2)))
    course_len = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0),
                                             axis=1)))
    return ate, 0.01 * course_len


def reset_counts():
    """Every kernel wrapper's launch count to 0 (``utils.cudagraph``'s
    counters: the LK quad's and level kernel's, single and batched, and
    PnP's two), just before a run they measure."""
    from visual_odom_tpu_torch.utils import cudagraph

    cudagraph.set_launch_counts(dict.fromkeys(cudagraph.launch_counts(), 0))


def read_counts() -> dict:
    """Every kernel wrapper's launch count, by ``utils.cudagraph``'s name."""
    from visual_odom_tpu_torch.utils import cudagraph

    return cudagraph.launch_counts()


def pnp_steps(steps) -> dict:
    """PnP's launches for ``steps`` steps: each step is one ``pnp_ransac``
    call (one sequence or a batch), one launch of each kernel."""
    return dict.fromkeys(PNP_COUNTERS, steps)


def set_path(name):
    """The path the runs checked from now on belong to (``tally_pnp``)."""
    PNP_PATH[0] = name


def tally_pnp(counts):
    """Add a checked run's PnP launches to its path's (PNP_LAUNCHES); every
    step launches both kernels, so their counts must agree."""
    if len({counts[key] for key in PNP_LAUNCHES}) != 1:
        raise AssertionError(f"{PNP_PATH[0]}: PnP launches {counts} differ "
                             f"between the kernels")
    for key, by_path in PNP_LAUNCHES.items():
        by_path[PNP_PATH[0]] = by_path.get(PNP_PATH[0], 0) + counts[key]


def check_counts(label, config, counts, steps, batched, tally=True):
    """The route's LK kernel ran its launches per step, each PnP kernel one
    launch per step, and no other kernel launch was made. Returns the
    route's LK count; with ``tally``, adds the PnP launches to the path's."""
    kernel, per_step = (("quad", LAUNCHES_PER_FRAME)
                        if config.resolved_lk_backend() == "pallas"
                        else ("level", LEVEL_LAUNCHES_PER_FRAME))
    if batched:
        kernel += "_batched"
    expected = dict(dict.fromkeys(counts, 0), **pnp_steps(steps))
    expected[kernel] = per_step * steps
    if counts != expected:
        raise AssertionError(f"{label}: kernel launches {counts} for {steps} "
                             f"steps, expected {expected}")
    if tally:
        tally_pnp(counts)
    return counts[kernel]


@contextlib.contextmanager
def scans(graphed: bool):
    """The scan family's doors inside the block step as ``graphed`` says:
    replayed from the step's CUDA graph (the default on a card) or eagerly
    (``make_scan_step_fn(_graph=False)``, the reference the graph is held
    to). The doors look ``make_scan_step_fn`` up when they are called, in
    ``runner.pipeline`` and in ``parallel.batch``."""
    from visual_odom_tpu_torch.parallel import batch
    from visual_odom_tpu_torch.runner import pipeline

    real = pipeline.make_scan_step_fn
    pipeline.make_scan_step_fn = batch.make_scan_step_fn = functools.partial(
        real, _graph=graphed)
    try:
        yield
    finally:
        pipeline.make_scan_step_fn = batch.make_scan_step_fn = real


def warm_graph(frames, config, intr, dev):
    """Capture the scan's graph for ``frames``' shape (one sequence, or
    (B, H, W) stacks) with one chunk of one frame on a throwaway state, so
    that a timed run after it replays from its first frame (where it is
    captured already, this is one replay). The caller resets the counts
    after it."""
    import torch

    from visual_odom_tpu_torch.parallel import batch
    from visual_odom_tpu_torch.runner import pipeline

    if frames[0][0].ndim == 3:
        state = batch.batched_init_state(config, *frames[0], device=dev)
    else:
        state = pipeline.init_vo_state(config, intr, *frames[0], device=dev)
    scan = pipeline.make_scan_step_fn(config, intr, device=dev)
    scan(state, *(torch.from_numpy(x[None]).to(dev) for x in frames[1]))
    torch.cuda.synchronize()


def run_main_path(name, frames, gt, config, intr, dev, ref_poses=None,
                  label="main_path", ate_limit=None):
    """``run_sequence_scan`` on one course, held to the bench gates (or, with
    ``ate_limit``, to that ATE in metres); with ``ref_poses`` (the quad
    route's run of the course) it reports the largest pose difference.
    Prints a ``label`` line. Returns (result dict, poses, fetched
    outputs)."""
    from visual_odom_tpu_torch.runner import pipeline

    warm_graph(frames, config, intr, dev)
    reset_counts()
    poses, fetched, wall, n = pipeline.run_sequence_scan(
        frames, config, intr, chunk=CHUNK, warmup=False, device=dev)
    counts = read_counts()
    accept = float(np.mean(fetched.accept))
    ate, budget = ate_and_budget(poses, gt)
    res = dict(course=name, route=config.resolved_lk_backend(), steps=n,
               wall_s=wall, fps=n / wall,
               ms_per_frame=1e3 * wall / n, accept=accept, ate_m=ate,
               ate_budget_m=budget, fallback_frames=int(fetched.fallback.sum()),
               rejected_frames=[int(i) + 1 for i in
                                np.flatnonzero(~np.asarray(fetched.accept, bool))],
               mean_bucketed=float(fetched.num_bucketed.mean()),
               mean_matched=float(fetched.num_matched.mean()),
               mean_inliers=float(fetched.num_inliers.mean()),
               launch_counts=counts)
    if ate_limit is not None:
        res["ate_limit_m"] = ate_limit
    if ref_poses is not None:
        res["max_abs_dpose_vs_quad"] = float(np.abs(poses - ref_poses).max())
    print(label, json.dumps(res))
    if not (np.isfinite(fetched.T_inv).all() and fetched.T_inv.shape == (n, 4, 4)
            and len(poses) == n + 1 and np.isfinite(poses).all()):
        raise AssertionError(f"{name}: outputs not finite or of the wrong shape")
    res["kernel_launches"] = check_counts(name, config, counts, n, False)
    if not (accept >= 0.9 and ate <= (budget if ate_limit is None
                                      else ate_limit)):
        raise AssertionError(f"{name}: accuracy gates failed: accept {accept}, "
                             f"ATE {ate} m > budget {budget} m")
    return res, poses, fetched


def run_batched_path(courses, config, intr, dev, ref_poses=None):
    """The batched path: BATCH_COURSES in lockstep through
    ``run_sequences_batched``, each sequence held to the bench gates on its
    own steps. Returns (result dict, poses per sequence, the runner's
    statistics per sequence)."""
    from visual_odom_tpu_torch.parallel.batch_eval import run_sequences_batched

    seqs = [courses[k][0] for k in BATCH_COURSES]
    n_steps = max(len(s) for s in seqs) - 1
    # the last chunk is padded with the final frame
    steps_run = -(-n_steps // CHUNK) * CHUNK
    warm_graph(stacked_frames(seqs, 2), config, intr, dev)
    reset_counts()
    poses, stats, wall = run_sequences_batched(seqs, config, intr,
                                               chunk=CHUNK, device=dev)
    counts = read_counts()
    per_seq = []
    for (name, family), p, st in zip(BATCH_COURSES, poses, stats):
        ate, budget = ate_and_budget(p, courses[(name, family)][1])
        per_seq.append(dict(course=f"{name}_{family}", steps=st["frames"] - 1,
                            accept=st["accept_ratio"], ate_m=ate,
                            ate_budget_m=budget,
                            fallback_frames=st["fallback_frames"],
                            mean_inliers=st["mean_inliers"]))
    res = dict(route=config.resolved_lk_backend(), batch=len(seqs),
               steps=n_steps, steps_run=steps_run, wall_s=wall,
               ms_per_step=1e3 * wall / n_steps,
               aggregate_fps=sum(len(s) - 1 for s in seqs) / wall,
               launch_counts=counts, sequences=per_seq)
    if ref_poses is not None:
        res["max_abs_dpose_vs_quad"] = max(float(np.abs(p - r).max())
                                           for p, r in zip(poses, ref_poses))
    print("batch_path", json.dumps(res))
    for p, s in zip(poses, seqs):
        if not (p.shape == (len(s), 4, 4) and np.isfinite(p).all()):
            raise AssertionError("batch path: poses not finite or of the "
                                 "wrong shape")
    res["kernel_launches"] = check_counts("batch path", config, counts,
                                          steps_run, True)
    for r in per_seq:
        if not (r["accept"] >= 0.9 and r["ate_m"] <= r["ate_budget_m"]):
            raise AssertionError(f"batch path: accuracy gates failed: {r}")
    return res, poses, stats


def _small_course():
    from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig

    h, w = 120, 160
    intr = CameraIntrinsics(fx=120.0, fy=120.0, cx=w / 2, cy=h / 2,
                            bf=-120.0 * 0.54, width=w, height=h)
    return intr, VOConfig.for_image(h, w, ransac_iterations=200)


def _check_step_agreement(ref, got, label):
    """The card-vs-CPU step rule: bucketed counts equal, matched and inlier
    counts within 3 %, T^-1 within 2e-3 (rotation) and 2e-2 m."""
    if int(ref.num_bucketed) != int(got.num_bucketed):
        raise AssertionError(f"{label}: bucketed counts differ")
    for k in ("num_matched", "num_inliers"):
        r, g = int(getattr(ref, k)), int(getattr(got, k))
        if abs(g - r) > 0.03 * r:
            raise AssertionError(f"{label}: {k} {g} vs {r}")
    d = np.abs(np.asarray(got.T_inv) - np.asarray(ref.T_inv))
    if d[:3, :3].max() >= 2e-3 or d[:3, 3].max() >= 2e-2:
        raise AssertionError(f"{label}: T_inv differs by {d.max()}")
    return float(d.max())


def small_batched_reference(dev):
    """A batched step of two sequences vs two single-sequence steps, on the
    card, fed the same RANSAC draws, 120x160."""
    import torch

    from visual_odom_tpu_torch.io.synthetic import SyntheticStereoSequence
    from visual_odom_tpu_torch.parallel import batch
    from visual_odom_tpu_torch.runner import pipeline

    intr, cfg = _small_course()
    lists = [[seq.frame(i) for i in range(6)] for seq in
             (SyntheticStereoSequence(intr, num_frames=6, seed=s, speed=0.5)
              for s in (0, 1))]
    frames = stacked_frames(lists, 6)
    us = [torch.from_numpy(np.random.default_rng(i).random(
        (2, 200, cfg.padded_features), dtype=np.float32)).to(dev)
        for i in range(1, 6)]
    step = pipeline.make_step_fn(cfg, intr, device=dev)
    st = batch.batched_init_state(cfg, *frames[0], device=dev)
    batched = []
    for i in range(1, 6):
        st, out = step(st, *(torch.from_numpy(x).to(dev) for x in frames[i]),
                       uniforms=us[i - 1])
        batched.append(pipeline._fetch(out))
    worst, equal_counts = 0.0, True
    for b in range(2):
        s1 = pipeline.init_vo_state(cfg, intr, *lists[b][0], seed=b, device=dev)
        for i in range(1, 6):
            s1, o1 = step(s1, *(torch.from_numpy(x).to(dev) for x in lists[b][i]),
                          uniforms=us[i - 1][b])
            ref = pipeline._fetch(o1)
            got = pipeline.StepOutput(*(x[b] for x in batched[i - 1]))
            worst = max(worst, _check_step_agreement(ref, got,
                                                     "small batched reference"))
            equal_counts &= all(int(getattr(ref, k)) == int(getattr(got, k))
                                for k in ("num_bucketed", "num_matched",
                                          "num_inliers"))
    print("small_batched_reference", json.dumps({
        "frames": 5, "batch": 2, "max_T_inv_diff": worst,
        "counts_equal": equal_counts}))


def small_reference(dev):
    """Card step vs the port's CPU step, same RANSAC draws, 120x160."""
    import torch

    from visual_odom_tpu_torch.io.synthetic import SyntheticStereoSequence
    from visual_odom_tpu_torch.runner import pipeline

    intr, cfg = _small_course()
    seq = SyntheticStereoSequence(intr, num_frames=6, seed=0, speed=0.5)
    frames = [seq.frame(i) for i in range(6)]
    runs = {}
    for d in ("cpu", dev):
        step = pipeline.make_step_fn(cfg, intr, device=d)
        st = pipeline.init_vo_state(cfg, intr, *frames[0], device=d)
        outs = []
        for i in range(1, 6):
            u = torch.from_numpy(np.random.default_rng(i).random(
                (200, cfg.padded_features), dtype=np.float32)).to(d)
            st, out = step(st, torch.from_numpy(frames[i][0]).to(d),
                           torch.from_numpy(frames[i][1]).to(d), uniforms=u)
            outs.append(pipeline.StepOutput(*(x.cpu().numpy() for x in out)))
        runs[str(d)] = outs
    worst = max(_check_step_agreement(ref, got, "small reference")
                for ref, got in zip(runs["cpu"], runs[str(dev)]))
    print("small_reference", json.dumps({"frames": 5, "max_T_inv_diff": worst}))


def profile_frames(frames, config, intr, dev, steady_ms, n_frames=4,
                   label="profile"):
    """Device time by kernel over a few main-path frames (4: the profiler's
    bookkeeping makes each profiled frame cost the script seconds), under
    torch.profiler: replays of the scan's CUDA graph (one chunk of
    ``n_frames``, after a first chunk outside the profile that captures it
    where it is not captured yet), after two eager steps (for one sequence,
    three: the third a buffered step) that must not synchronise with the
    host. The route's LK kernels must appear by name inside the replays,
    LAUNCHES_PER_FRAME (or LEVEL_LAUNCHES_PER_FRAME) a frame, and each PnP
    kernel once a frame; the runtime
    calls the host made (kernel launches, copies, graph launches) are
    counted per frame. The busy share divides the device time by
    ``steady_ms``, the main path's ms/frame without the profiler (which
    slows the host). Frames of (B, H, W) pairs profile the batched step
    (per step, not per frame)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from visual_odom_tpu_torch.parallel import batch
    from visual_odom_tpu_torch.runner import pipeline

    step = pipeline.make_step_fn(config, intr, device=dev)
    single = frames[0][0].ndim == 2
    if single:
        state = pipeline.init_vo_state(config, intr, *frames[0], device=dev)
    else:
        state = batch.batched_init_state(config, *frames[0], device=dev)
    n_sync = 3 if single else 2           # steps under the sync check
    up = [(torch.from_numpy(l).to(dev), torch.from_numpy(r).to(dev))
          for l, r in frames[1:n_sync + n_frames + 2]]
    if len(up) != n_sync + n_frames + 1:
        raise ValueError(f"{label}: {len(frames)} frames, the sync check "
                         f"and the profile need {n_sync + n_frames + 2}")
    tracks_step = pipeline.make_step_fn(config, intr, with_tracks=True,
                                        device=dev)
    if single:
        buffered = pipeline.make_buffered_step_fn(config, intr, device=dev)
        bufs = pipeline.make_output_buffers(1, device=dev)
    # The step never waits for the device, nor does it when it also returns
    # its track snapshot, nor (one sequence) when it writes its outputs at
    # the buffers' device-side cursor: any synchronising call raises.
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = step(state, *up[0])
        state, _, _ = tracks_step(state, *up[1])
        if single:
            state, bufs = buffered(state, *up[2], bufs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if single and bufs.idx.tolist() != [1]:
        raise AssertionError(f"{label}: the buffered step's cursor is "
                             f"{bufs.idx.tolist()}, expected [1]")
    scan = pipeline.make_scan_step_fn(config, intr, device=dev)
    lefts, rights = (torch.stack([f[k] for f in up[n_sync:]]) for k in (0, 1))
    state, _ = scan(state, lefts[:1], rights[:1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, out = scan(state, lefts[1:], rights[1:])
        torch.cuda.synchronize()
    rows = device_rows(prof)
    if not rows:
        raise AssertionError("profile: the profiler saw no device time")
    device_ms = sum(r[0] for r in rows) / 1e3 / n_frames
    kernel, per_frame = (("lk_quad_kernel", LAUNCHES_PER_FRAME)
                         if config.resolved_lk_backend() == "pallas"
                         else ("lk_level_kernel", LEVEL_LAUNCHES_PER_FRAME))
    lk = sum(c for _, k, c in rows if kernel in k) / n_frames
    pnp_kernels = {name: sum(c for _, k, c in rows if name in k) / n_frames
                   for name in PNP_COUNTERS.values()}
    res = {"frames": n_frames, "device_ms_per_frame": device_ms,
           "device_ops_per_frame": sum(r[2] for r in rows) / n_frames,
           "lk_kernel": kernel, "lk_kernels_per_frame": lk,
           "pnp_kernels_per_frame": pnp_kernels,
           "host_runtime_calls_per_frame": host_calls(prof, n_frames),
           "steady_ms_per_frame": steady_ms,
           "device_busy_share": device_ms / steady_ms,
           "top_device_ops": [{"name": k[:90], "ms_per_frame": us / 1e3 / n_frames,
                               "calls_per_frame": c / n_frames}
                              for us, k, c in rows[:10]]}
    print(label, json.dumps(res))
    if lk != per_frame:
        raise AssertionError(f"{label}: {lk} {kernel} a frame inside the "
                             f"replays, expected {per_frame}")
    if any(v != 1 for v in pnp_kernels.values()):
        raise AssertionError(f"{label}: PnP kernels a frame inside the "
                             f"replays {pnp_kernels}, expected one each")
    return res


def host_calls(prof, n_frames) -> dict:
    """The CUDA runtime and driver calls the host made under ``prof``
    (kernel launches, copies, graph launches, ...), by name, per frame."""
    from torch.autograd import DeviceType

    return {e.key: e.count / n_frames for e in prof.key_averages()
            if e.device_type == DeviceType.CPU and e.key.startswith("cu")
            and any(k in e.key for k in ("Launch", "Memcpy", "Memset"))}


def batch_sweep(courses, config, intr, dev, n_prof=4):
    """``run_sequences_batched`` over the first SWEEP_STEPS steps of the
    batched path's courses, tiled to B sequences, for each B of SWEEP_B:
    aggregate frames/s and ms per batched step (one chunk, its upload
    outside the timed wall), replayed from the batched step's CUDA graph
    and stepped eagerly (``scans(False)``), then the batched step's sync
    check and profile. Each B is warmed up on 4 steps both ways first, and
    timed twice in turns (B ascending with the graph first, then all of it
    in reverse): the host-bound times drift within a run."""
    from visual_odom_tpu_torch.parallel.batch_eval import run_sequences_batched

    full = [courses[k][0] for k in BATCH_COURSES]
    tiled = {B: [full[b % len(full)] for b in range(B)] for B in SWEEP_B}
    order = [(B, g) for B in SWEEP_B for g in (True, False)]
    for B, g in order:
        with scans(g):
            run_sequences_batched([f[:5] for f in tiled[B]], config, intr,
                                  chunk=4, device=dev)
    walls = {k: [] for k in order}
    accept = {}
    for B, g in order + order[::-1]:
        reset_counts()
        with scans(g):
            _, stats, wall = run_sequences_batched(
                [f[:SWEEP_STEPS + 1] for f in tiled[B]], config, intr,
                chunk=SWEEP_STEPS, device=dev)
        launches = check_counts(f"sweep B={B}", config, read_counts(),
                                SWEEP_STEPS, True)
        walls[B, g].append(wall)
        accept[B, g] = float(np.mean([s["accept_ratio"] for s in stats]))
    rows = []
    for B in SWEEP_B:
        wall = float(np.mean(walls[B, True]))
        eager = float(np.mean(walls[B, False]))
        step_ms = 1e3 * wall / SWEEP_STEPS
        prof = profile_frames(stacked_frames(tiled[B], n_prof + 4), config,
                              intr, dev, step_ms, n_frames=n_prof,
                              label=f"profile_b{B}")
        row = dict(batch=B, steps=SWEEP_STEPS, walls_s=walls[B, True],
                   ms_per_step=step_ms, aggregate_fps=B * SWEEP_STEPS / wall,
                   eager_walls_s=walls[B, False],
                   eager_ms_per_step=1e3 * eager / SWEEP_STEPS,
                   eager_aggregate_fps=B * SWEEP_STEPS / eager,
                   device_ms_per_step=prof["device_ms_per_frame"],
                   device_ops_per_step=prof["device_ops_per_frame"],
                   device_busy_share=prof["device_busy_share"],
                   kernel_launches=launches,
                   mean_accept=accept[B, True],
                   accept_equal_eager=accept[B, True] == accept[B, False])
        print("sweep", json.dumps(row))
        if not row["accept_equal_eager"]:
            raise AssertionError(f"sweep B={B}: the graphed run's accept "
                                 f"ratio differs from the eager run's")
        rows.append(row)
    return rows


def backend_scan(frames, gt, config, intr, dev):
    """Phase 7 (a): ``run_sequence_scan(collect_tracks=True)`` on the quad
    route under the bench gates; one snapshot per step, its valid count the
    step's ``num_matched``. Returns (result dict, poses, snapshots)."""
    from visual_odom_tpu_torch.runner import pipeline

    reset_counts()
    poses, fetched, wall, n, snaps = pipeline.run_sequence_scan(
        frames, config, intr, chunk=CHUNK, warmup=False, collect_tracks=True,
        device=dev)
    counts = read_counts()
    accept = float(np.mean(fetched.accept))
    ate, budget = ate_and_budget(poses, gt)
    valid = np.array([int(s.valid.sum()) for s in snaps])
    res = dict(part="scan_with_tracks", course="loop", steps=n, wall_s=wall,
               fps=n / wall, ms_per_frame=1e3 * wall / n, accept=accept,
               ate_m=ate, ate_budget_m=budget, snapshots=len(snaps),
               valid_equals_matched=bool(np.array_equal(valid,
                                                        fetched.num_matched)),
               launch_counts=counts)
    print("backend", json.dumps(res))
    if not (len(snaps) == n and res["valid_equals_matched"]
            and all(s.points_l1.shape == (config.padded_features, 2)
                    for s in snaps) and np.isfinite(poses).all()):
        raise AssertionError(f"backend scan: snapshots or poses wrong: {res}")
    res["kernel_launches"] = check_counts("backend scan", config, counts, n,
                                          False)
    if not (accept >= 0.9 and ate <= budget):
        raise AssertionError(f"backend scan: accuracy gates failed: {res}")
    return res, poses, snaps


def tracks_cost(frames, config, intr, dev):
    """Phase 7 (a), the cost of collecting snapshots: the first
    TRACKS_COST_STEPS steps of the course through ``run_sequence_scan``
    without and with ``collect_tracks`` (one run each: the host's speed
    drifts within a run, so the ratio is rough). The chains must be equal
    bit for bit: collecting changes no result."""
    from visual_odom_tpu_torch.runner import pipeline

    part = frames[:TRACKS_COST_STEPS + 1]
    walls = {False: [], True: []}
    poses = {}
    for tracks in (False, True):
        out = pipeline.run_sequence_scan(part, config, intr, chunk=CHUNK,
                                         warmup=False, collect_tracks=tracks,
                                         device=dev)
        walls[tracks].append(1e3 * out[2] / out[3])
        poses.setdefault(tracks, out[0])
    res = dict(part="tracks_cost", steps=TRACKS_COST_STEPS,
               ms_per_frame_without=walls[False], ms_per_frame_with=walls[True],
               ratio=float(np.mean(walls[True]) / np.mean(walls[False])),
               same_chain=bool(np.array_equal(poses[False], poses[True])))
    print("backend", json.dumps(res))
    if not res["same_chain"]:
        raise AssertionError("collecting snapshots changed the chain")
    return res


def backend_ba(snaps, poses, gt, intr, dev):
    """Phase 7 (b) and the BA half of (d): ``smooth_trajectory_ba`` with the
    CLI's short-course defaults and with the km-scale config; the first
    window's problem solved on the card and on the CPU; one GN iteration
    and one 8-iteration solve timed on the card."""
    from visual_odom_tpu_torch.ba import schur, window

    ate_chain, budget = ate_and_budget(poses, gt)
    rows = {}
    for name, kw in (("ba", BA_SHORT), ("ba_km", BA_KM)):
        solved = []

        def solver(problem, kw=kw):
            solved.append(problem.mask.shape)
            return schur.ba_solve(problem, iterations=kw["iterations"],
                                  huber_delta=kw["huber_delta"])

        t = time.perf_counter()
        smoothed = window.smooth_trajectory_ba(
            snaps, poses, intr, window=kw["window"],
            max_landmarks=kw["max_landmarks"],
            min_track_len=kw["min_track_len"], solver=solver, device=dev)
        wall = time.perf_counter() - t
        ate = ate_and_budget(smoothed, gt)[0]
        n_windows = len(poses) // kw["window"]
        rows[name] = dict(part=name, **kw, ate_chain_m=ate_chain, ate_ba_m=ate,
                          ate_budget_m=budget, improved=bool(ate < ate_chain),
                          windows=n_windows, windows_solved=len(solved),
                          windows_skipped=n_windows - len(solved),
                          mean_landmarks=float(np.mean([s[1] for s in solved]))
                          if solved else 0.0, wall_s=wall,
                          gn_iterations=len(solved) * kw["iterations"])
        print("backend", json.dumps(rows[name]))
        if not (smoothed.shape == poses.shape and np.isfinite(smoothed).all()
                and np.allclose(smoothed[0], poses[0], atol=1e-6)
                and solved):
            raise AssertionError(f"{name}: smoothed trajectory wrong: "
                                 f"{rows[name]}")
    # The JAX package on the CPU over this course (python
    # tests/test_torch_ba.py loop 320) smooths the chain's 0.146 m ATE to
    # 0.185 m, missing its own BA bar (tests/test_ba_window.py:100): BA is
    # held to the bench's ATE budget here, as JAX behaves, not below the
    # chain.
    if not rows["ba"]["ate_ba_m"] <= budget:
        raise AssertionError(f"ba: smoothed ATE over the budget: {rows['ba']}")

    kw = BA_SHORT
    problem = window.build_window_problem(
        window.window_tracks(snaps, range(kw["window"])), poses[:kw["window"]],
        intr, max_landmarks=kw["max_landmarks"],
        min_track_len=kw["min_track_len"], device=dev)
    cpu = problem._replace(**{k: getattr(problem, k).cpu() for k in (
        "poses", "landmarks", "observations", "mask")})
    card = schur.ba_solve(problem, iterations=kw["iterations"],
                          huber_delta=kw["huber_delta"]).poses.cpu()
    ref = schur.ba_solve(cpu, iterations=kw["iterations"],
                         huber_delta=kw["huber_delta"]).poses
    diff = float((card - ref).abs().max())
    res = dict(part="ba_card_vs_cpu", window=kw["window"],
               landmarks=int(problem.mask.shape[1]),
               observations=int(problem.mask.sum()),
               max_abs_dpose=diff, tol=BA_CARD_CPU_TOL,
               gn_iteration_ms=time_ms(lambda: schur.ba_gauss_newton_step(
                   problem, huber_delta=kw["huber_delta"]), reps=10, warm=2),
               solve_ms=time_ms(lambda: schur.ba_solve(
                   problem, iterations=kw["iterations"],
                   huber_delta=kw["huber_delta"]), reps=3, warm=1))
    print("backend", json.dumps(res))
    if not diff < BA_CARD_CPU_TOL:
        raise AssertionError(f"BA on the card differs from the CPU: {res}")
    return rows, res


def backend_loops(frames, poses, gt, config, xconfig, intr, dev):
    """Phase 7 (c) and the pose-graph half of (d): ``close_loops`` on the raw
    chain as bench.py:220-222 calls it, on the quad route and on the
    per-leg route; the loop run's graph solved on the card and on the
    CPU."""
    import torch

    from visual_odom_tpu_torch.ba import posegraph
    from visual_odom_tpu_torch.io.synthetic import SyntheticStereoSequence
    from visual_odom_tpu_torch.ops import lk_cuda
    from visual_odom_tpu_torch.runner import loopclosure

    lf = SyntheticStereoSequence._loop_schedule(len(frames))[2]
    ate_chain = ate_and_budget(poses, gt)[0]
    runs = {}
    for cfg in (config, xconfig):
        route = cfg.resolved_lk_backend()
        reset_counts()
        with recorded_calls(lk_cuda, "lk_quad_cuda") as quads, \
                recorded_calls(loopclosure,
                               "measure_loop_edge_bidirectional") as measured:
            t = time.perf_counter()
            new_poses, info = loopclosure.close_loops(
                poses, lambda i: frames[i], cfg, intr, gt_loop_pair=(0, lf),
                device=dev)
            wall = time.perf_counter() - t
        counts = read_counts()
        m = len(measured)
        res = dict(part="loop_closure", route=route, loop_frame=lf,
                   candidates=len(info.candidates), measurements=m,
                   edges=info.edges, closure_before_m=info.closure_before_m,
                   closure_after_m=info.closure_after_m, ate_chain_m=ate_chain,
                   ate_after_m=ate_and_budget(new_poses, gt)[0], wall_s=wall,
                   quad_start_levels=sorted(set(int(q[8]) for q in quads)),
                   launch_counts=counts)
        print("backend", json.dumps(res))
        runs[route] = (res, new_poses, info)
        # a measurement is one step
        expected = dict(dict.fromkeys(counts, 0), **pnp_steps(2 * m))
        if route == "pallas":
            expected["quad"] = 2 * m
        else:
            expected["level"] = 2 * m * LEG_STEP_LAUNCHES
        tally_pnp(counts)
        if counts != expected or (quads and res["quad_start_levels"]
                                  != [cfg.lk_levels]):
            raise AssertionError(f"loop closure ({route}): launches {counts}, "
                                 f"expected {expected}, quad start levels "
                                 f"{res['quad_start_levels']}")
    (res, new_poses, info), (xres, xposes, xinfo) = runs["pallas"], runs["xla"]
    same = (info.edges == xinfo.edges and info.candidates == xinfo.candidates
            and (info.graph is None) == (xinfo.graph is None)
            and (info.graph is None or all(
                torch.equal(a, b) for a, b in zip(info.graph, xinfo.graph)))
            and np.array_equal(new_poses, xposes))
    print("backend", json.dumps(dict(part="loop_routes_bit_exact",
                                     equal=same)))
    if not same:
        raise AssertionError("loop closure: the per-leg route's edges, graph "
                             "or poses differ from the quad route's")
    if not (info.edges and res["closure_after_m"] < res["closure_before_m"]
            and res["ate_after_m"] <= LOOP_ATE_FACTOR * ate_chain):
        raise AssertionError(f"loop closure: gates failed: {res}")

    graph = info.graph
    card = posegraph.posegraph_solve(graph).nodes.cpu()
    ref = posegraph.posegraph_solve(
        posegraph.PoseGraph(*(x.cpu() for x in graph))).nodes
    diff = float((card - ref).abs().max())
    pg = dict(part="posegraph_card_vs_cpu", nodes=int(graph.nodes.shape[0]),
              edges=int(graph.edges.shape[0]), max_abs_dnode=diff,
              tol=NODE_CARD_CPU_TOL,
              solve_ms=time_ms(lambda: posegraph.posegraph_solve(graph),
                               reps=3, warm=1))
    print("backend", json.dumps(pg))
    if not diff < NODE_CARD_CPU_TOL:
        raise AssertionError(f"pose graph on the card differs from the CPU: "
                             f"{pg}")
    return res, xres, pg, new_poses


class RandomAccess:
    """A list of frames as the resumable runner takes it (``len``,
    ``.frame(i)``); with ``crash_at`` it raises once when that frame is
    first asked for, as a decode failure would."""

    def __init__(self, frames, crash_at=None):
        self.frames, self.crash_at = frames, crash_at

    def __len__(self):
        return len(self.frames)

    def frame(self, i):
        if self.crash_at is not None and i >= self.crash_at:
            self.crash_at = None
            raise RuntimeError("injected decode failure")
        return self.frames[i]


def resume_check(frames, config, intr, dev):
    """Phase 8 ``resume``: ``run_sequence_scan_resumable`` (chunk
    RESUME_CHUNK, a snapshot every RESUME_EVERY steps) uninterrupted,
    interrupted by a failure at frame RESUME_CRASH_AT, and resumed from its
    last snapshot, with track snapshots (phase 11's command line resumes
    the scan without them). The resumed run equals the uninterrupted one
    bit for bit, and both equal ``run_sequence_scan`` at the same chunk.
    Returns the resumed run's launch counts and the reference scan's track
    snapshots (phase 11's BA input)."""
    from visual_odom_tpu_torch.runner import pipeline
    from visual_odom_tpu_torch.utils.checkpoint import load_scan_checkpoint

    ref = pipeline.run_sequence_scan(frames, config, intr, chunk=RESUME_CHUNK,
                                     warmup=False, collect_tracks=True,
                                     device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(checkpoint_every=RESUME_EVERY, chunk=RESUME_CHUNK,
                  warmup=False, collect_tracks=True, device=dev)
        full_ck, crash_ck = (os.path.join(tmp, f"{k}.npz")
                             for k in ("full", "crash"))
        stats = []
        full = pipeline.run_sequence_scan_resumable(
            RandomAccess(frames), config, intr, full_ck,
            snapshot_stats=stats, **kw)
        try:
            pipeline.run_sequence_scan_resumable(
                RandomAccess(frames, RESUME_CRASH_AT), config, intr,
                crash_ck, **kw)
            raise AssertionError("resume: the injected failure did not "
                                 "surface")
        except RuntimeError as e:
            if "injected" not in str(e):
                raise
        at = int(load_scan_checkpoint(crash_ck)["frames_done"])
        reset_counts()
        resumed = pipeline.run_sequence_scan_resumable(
            RandomAccess(frames), config, intr, crash_ck, **kw)
        counts = read_counts()
        launches = check_counts("resume", config, counts, resumed[3], False)

    def same(a, b):
        return all(np.array_equal(x, y) for x, y in zip(a, b))

    eq = {"poses_resumed_vs_full": bool(np.array_equal(resumed[0], full[0])),
          "poses_full_vs_scan": bool(np.array_equal(full[0], ref[0])),
          "outputs_resumed_vs_full": same(resumed[1], full[1]),
          "outputs_full_vs_scan": same(full[1], ref[1]),
          "tracks_resumed_vs_full": all(
              same(a, b) for a, b in zip(resumed[4], full[4])),
          "tracks_full_vs_scan": all(
              same(a, b) for a, b in zip(full[4], ref[4]))}
    res = dict(tracks=True, steps=full[3], chunk=RESUME_CHUNK,
               checkpoint_every=RESUME_EVERY, crash_at=RESUME_CRASH_AT,
               snapshot_at=at, resumed_steps=resumed[3], snapshots=stats,
               wall_full_s=full[2], wall_resumed_s=resumed[2],
               launch_counts=counts, **eq)
    print("resume", json.dumps(res))
    if not (all(eq.values()) and at == RESUME_EVERY
            and resumed[3] == len(frames) - 1 - at):
        raise AssertionError(f"resume: not bit for bit: {res}")
    return launches, ref[4]


def variant_check(name, opts, frames, gt, intr, dev, default_profile,
                  jax_ref):
    """Phase 8 ``mono`` / ``shi_tomasi``: the main path with ``opts`` on
    both LK routes, held to the bench gates (or, where the JAX package
    itself misses the ATE budget on this course, to VARIANT_ATE_FACTOR x
    its ATE), the routes equal bit for bit, the LK launches per frame of
    the default step; then the step's sync check and profile beside the
    default step's. Returns the launch counts per route and the
    profile."""
    import torch

    from visual_odom_tpu_torch.config import VOConfig
    from visual_odom_tpu_torch.ops.fast import shi_tomasi_corner_map

    budget = ate_and_budget(np.tile(np.eye(4), (len(gt), 1, 1)), gt)[1]
    limit = None
    if not (jax_ref["accept"] >= 0.9 and jax_ref["ate_m"] <= budget):
        limit = VARIANT_ATE_FACTOR * jax_ref["ate_m"]
    config = VOConfig.for_image(H, W, **opts)
    xconfig = VOConfig.for_image(H, W, lk_backend="xla", **opts)
    q, poses, _ = run_main_path(f"straight_{name}", frames, gt, config, intr,
                             dev, label=f"{name}_path", ate_limit=limit)
    x = run_main_path(f"straight_{name}", frames, gt, xconfig, intr, dev,
                      ref_poses=poses, label=f"{name}_path",
                      ate_limit=limit)[0]
    prof = profile_frames(frames, config, intr, dev, q["ms_per_frame"],
                          label=f"profile_{name}")
    res = dict(
        course="straight", steps=q["steps"], accept=q["accept"],
        ate_m=q["ate_m"], ate_budget_m=q["ate_budget_m"], ate_limit_m=limit,
        jax_cpu=jax_ref, ms_per_frame=q["ms_per_frame"],
        ms_per_frame_xla=x["ms_per_frame"],
        device_ms_per_step=prof["device_ms_per_frame"],
        device_ops_per_step=prof["device_ops_per_frame"],
        default_device_ms_per_step=default_profile["device_ms_per_frame"],
        default_device_ops_per_step=default_profile["device_ops_per_frame"],
        host_syncs_per_step=0,
        lk_launches_per_frame={
            "quad": q["kernel_launches"] / q["steps"],
            "level": x["kernel_launches"] / x["steps"]},
        max_abs_dpose_routes=x["max_abs_dpose_vs_quad"])
    if name == "shi_tomasi":
        counts = []
        for i in range(0, len(frames), 16):
            lefts = torch.from_numpy(np.stack([f[0] for f in
                                               frames[i:i + 16]])).to(dev)
            m = shi_tomasi_corner_map(lefts.to(torch.float32),
                                      config.shi_tomasi_quality,
                                      config.shi_tomasi_min_distance)
            counts += (m > 0).sum(dim=(1, 2)).tolist()
        res.update(corners_per_frame_mean=float(np.mean(counts)),
                   corners_per_frame_min=int(np.min(counts)),
                   mean_bucketed=q["mean_bucketed"])
    print(name, json.dumps(res))
    if res["max_abs_dpose_routes"] != 0.0:
        raise AssertionError(f"{name}: the routes differ: {res}")
    return q["kernel_launches"], x["kernel_launches"], prof


def _same(a, b) -> bool:
    """Two NamedTuples of numpy arrays equal field by field, bit for bit."""
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def _results_match(results, fetched, first=0) -> bool:
    """``FrameResult`` i against step ``first + i`` of a fetched StepOutput
    stack, on every field the two share."""
    return all(
        r.frame_id == first + i + 1
        and all(getattr(r, k) == getattr(fetched, k)[first + i].item()
                for k in ("accept", "scale", "num_inliers", "num_matched",
                          "num_bucketed"))
        for i, r in enumerate(results))


def front_doors(frames, cframes, ref, cref, config, xconfig, intr, dev):
    """Phase 9: the front doors on phase 4's frames, each held bit for bit
    to phase 4's ``run_sequence_scan`` of the course (``ref``, ``cref``:
    poses and fetched outputs, quad route) and to its kernel launches per
    frame. One ``front_doors`` line per part. Returns the launches per
    kernel."""
    from visual_odom_tpu_torch.eval.plot import LiveDisplay
    from visual_odom_tpu_torch.io.kitti import load_poses
    from visual_odom_tpu_torch.runner import pipeline
    from visual_odom_tpu_torch.utils.checkpoint import load_checkpoint

    launches = {"quad": 0, "level": 0}
    ref_poses, ref_out = ref
    n = len(frames) - 1

    def door(label, cfg, steps, fn):
        reset_counts()
        t = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t
        counts = read_counts()
        kernel = "quad" if cfg.resolved_lk_backend() == "pallas" else "level"
        launches[kernel] += check_counts(label, cfg, counts, steps, False)
        return out, wall, counts

    def report(res, eq):
        res.update(eq)
        print("front_doors", json.dumps(res))
        if not all(eq.values()):
            raise AssertionError(f"front doors, {res['part']}: {eq}")

    with tempfile.TemporaryDirectory() as tmp:
        # (a) run_sequence with every option on
        mpath, ppath = (os.path.join(tmp, f) for f in ("m.jsonl", "p.txt"))
        live = LiveDisplay(offscreen=True)
        (poses, results, snaps), wall, counts = door(
            "run_sequence", config, n, lambda: pipeline.run_sequence(
                frames, config, intr, metrics_path=mpath, poses_path=ppath,
                collect_tracks=True, live=live, device=dev))
        with open(mpath) as f:
            metric_lines = len(f.read().splitlines())
        rows = np.array([[float(f"{v:.9e}") for v in p[:3].reshape(12)]
                         for p in poses])
        report(dict(part="run_sequence", course="straight", steps=n,
                    wall_s=wall, ms_per_frame=1e3 * wall / n,
                    mean_frame_time_ms=float(np.mean(
                        [r.frame_time_ms for r in results])),
                    launch_counts=counts), {
            "poses_vs_scan": bool(np.array_equal(poses, ref_poses)),
            "results_vs_scan": _results_match(results, ref_out),
            "poses_file": bool(np.array_equal(
                load_poses(ppath)[:, :3, :].reshape(-1, 12), rows)),
            "metrics_lines": metric_lines == n,
            "snapshot_valid_is_matched": all(
                int(s.valid.sum()) == r.num_matched
                for s, r in zip(snaps, results)) and len(snaps) == n,
            "live_frames": live.frames_shown == n})

        # (b) run_sequence_resumable: uninterrupted, failed, resumed
        stats = []
        full_ck, crash_ck = (os.path.join(tmp, f) for f in ("f.npz", "c.npz"))
        (full, full_res), wall_full, counts_full = door(
            "resumable", config, n, lambda: pipeline.run_sequence_resumable(
                RandomAccess(frames), config, intr, full_ck,
                checkpoint_every=DOOR_EVERY, snapshot_stats=stats,
                device=dev))
        try:
            pipeline.run_sequence_resumable(
                RandomAccess(frames, DOOR_CRASH_AT), config, intr, crash_ck,
                checkpoint_every=DOOR_EVERY, device=dev)
            raise AssertionError("front doors: the injected failure did not "
                                 "surface")
        except RuntimeError as e:
            if "injected" not in str(e):
                raise
        at = int(load_checkpoint(crash_ck)["frame_id"])
        (resumed, res_res), wall_res, counts_res = door(
            "resumable, resumed", config, n - at,
            lambda: pipeline.run_sequence_resumable(
                RandomAccess(frames), config, intr, crash_ck,
                checkpoint_every=DOOR_EVERY, device=dev))
        report(dict(part="run_sequence_resumable", course="straight",
                    steps=n, checkpoint_every=DOOR_EVERY,
                    crash_at=DOOR_CRASH_AT, snapshot_at=at,
                    resumed_steps=len(res_res), wall_full_s=wall_full,
                    ms_per_frame=1e3 * wall_full / n,
                    wall_resumed_s=wall_res, snapshots=stats,
                    launch_counts=counts_full,
                    launch_counts_resumed=counts_res), {
            "snapshot_at_expected": at == DOOR_CRASH_AT // DOOR_EVERY
            * DOOR_EVERY,
            "poses_full_vs_run_sequence": bool(np.array_equal(full, poses)),
            "poses_resumed_vs_full": bool(np.array_equal(resumed, full)),
            "results_full_vs_scan": _results_match(full_res, ref_out),
            "results_resumed_vs_scan": _results_match(res_res, ref_out,
                                                      first=at)})

    # (c) run_sequence_buffered, every frame on the card first
    (bposes, bufs, bwall), wall, counts = door(
        "buffered", config, n, lambda: pipeline.run_sequence_buffered(
            frames, config, intr, preupload=True, device=dev))
    report(dict(part="run_sequence_buffered", course="straight", steps=n,
                preupload=True, wall_s=bwall, fps=n / bwall,
                ms_per_frame=1e3 * bwall / n, call_s=wall,
                launch_counts=counts), {
        "poses_vs_run_sequence": bool(np.array_equal(bposes, poses)),
        "outputs_vs_scan": all(
            np.array_equal(getattr(bufs, k), getattr(ref_out, k))
            for k in pipeline.OutputBuffers._fields[:-1]),
        "cursor": bufs.idx.tolist() == [n]})

    # (d) the bench's scan variants (bench.py:126-138) on the checker
    # course, where the adaptive fallback fires (scripts/door_turns.py
    # times the doors against each other in paired rounds): its first
    # DOOR_CHECKER_STEPS steps, against the same steps of phase 4's scan (a
    # scan's steps do not depend on the ones after them)
    cn = min(DOOR_CHECKER_STEPS, len(cframes) - 1)
    cframes = cframes[:cn + 1]
    cref = (cref[0][:cn + 1], type(cref[1])(*(x[:cn] for x in cref[1])))
    keep = ("chunks", "upload_bytes", "decode_s", "upload_s",
            "thread_wall_s", "busy_frac", "upload_mb_s")
    for variant, kw in (("preupload", dict(preupload=True)),
                        ("threads_1", dict(upload_threads=1)),
                        ("threads_4", dict(upload_threads=4))):
        stats = {}
        (p, out, swall, m), wall, counts = door(
            f"scan {variant}", config, cn, lambda: pipeline.run_sequence_scan(
                cframes, config, intr, chunk=CHUNK, warmup=False,
                stats_out=stats, device=dev, **kw))
        report(dict(part=f"scan_{variant}", course="straight_checker",
                    steps=m, wall_s=swall, fps=m / swall,
                    ms_per_frame=1e3 * swall / m, call_s=wall,
                    fallback_frames=int(out.fallback.sum()),
                    launch_counts=counts,
                    stats={k: stats[k] for k in keep + (
                        "threads", "pool_wall_s", "agg_upload_mb_s")
                           if k in stats},
                    per_thread=[{k: t[k] for k in keep}
                                for t in stats.get("per_thread", [])]), {
            "poses_vs_scan": bool(np.array_equal(p, cref[0])),
            "outputs_vs_scan": _same(out, cref[1]),
            "fallback_fired": int(out.fallback.sum()) > 0})

    # (e) the per-leg route through four upload threads
    stats = {}
    (p, out, swall, m), wall, counts = door(
        "scan per-leg", xconfig, n, lambda: pipeline.run_sequence_scan(
            frames, xconfig, intr, chunk=CHUNK, warmup=False,
            upload_threads=4, stats_out=stats, device=dev))
    report(dict(part="scan_threads_4_xla", course="straight", steps=m,
                route="xla", wall_s=swall, fps=m / swall,
                ms_per_frame=1e3 * swall / m, launch_counts=counts,
                busy_frac=stats["busy_frac"],
                agg_upload_mb_s=stats["agg_upload_mb_s"]), {
        "poses_vs_quad_scan": bool(np.array_equal(p, ref_poses)),
        "outputs_vs_quad_scan": _same(out, ref_out)})
    return launches


def write_png(path, img):
    """An 8-bit grayscale PNG at zlib level 1, written with the standard
    library alone (``struct`` and ``zlib``: no image package needed)."""
    import struct
    import zlib

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    h, w = img.shape
    raw = b"".join(b"\0" + img[r].tobytes() for r in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))
    return os.path.getsize(path)


def write_kitti(courses, keys, root):
    """The courses ``keys`` as KITTI sequence directories under ``root``
    (``<course>/image_0``, ``image_1``, ``%06d.png``) and ground-truth
    pose files (``gt/<course>.txt``), the PNGs written on a thread pool
    (zlib releases the GIL). Returns ({key: directory}, bytes written)."""
    from visual_odom_tpu_torch.io.kitti import save_poses_kitti

    dirs, jobs = {}, []
    os.makedirs(os.path.join(root, "gt"))
    for key in keys:
        frames, gt = courses[key]
        name = "_".join(key)
        dirs[key] = os.path.join(root, name)
        for side, d in enumerate(("image_0", "image_1")):
            os.makedirs(os.path.join(dirs[key], d))
            jobs += [(os.path.join(dirs[key], d, f"{i:06d}.png"), f[side])
                     for i, f in enumerate(frames)]
        save_poses_kitti(os.path.join(root, "gt", name + ".txt"), gt)
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 1) as ex:
        size = sum(ex.map(lambda job: write_png(*job), jobs))
    return dirs, size


class FailingSequence:
    """A random-access sequence that raises once when a frame at or past
    ``crash_at`` is first asked for, as a decode failure would."""

    def __init__(self, seq, crash_at):
        self.seq, self.crash_at = seq, crash_at

    def __len__(self):
        return len(self.seq)

    def frame(self, i):
        if self.crash_at is not None and i >= self.crash_at:
            self.crash_at = None
            raise RuntimeError("injected decode failure")
        return self.seq.frame(i)


@contextlib.contextmanager
def image_packages_hidden():
    """``import cv2`` and ``import PIL`` fail inside: a PNG that the native
    decoder did not take raises instead of reaching a fallback."""
    saved = {m: sys.modules.get(m) for m in ("cv2", "PIL", "PIL.Image")}
    sys.modules.update(dict.fromkeys(saved))
    try:
        yield
    finally:
        for m, mod in saved.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod


def kitti_phase(courses, ref, bposes, bstats, config, intr, dev, root):
    """Phase 10: phase 4's batched courses as KITTI PNG directories under
    ``root``, read back through the native decoder only (the caller hides
    the image packages), each run held bit for bit to phase 4's in-memory
    run (``bposes``, ``bstats``: the batched one's poses and statistics).
    One ``kitti`` line per part. Returns the launches per kernel
    ({"quad", "quad_batched"}), the directories ({course key: path}) and
    ``eval_all``'s scores."""
    from visual_odom_tpu_torch.eval.devkit import eval_all
    from visual_odom_tpu_torch.eval.kitti_eval import ate_rmse
    from visual_odom_tpu_torch.io import native
    from visual_odom_tpu_torch.io.kitti import KittiSequence, save_poses_kitti
    from visual_odom_tpu_torch.parallel.batch_eval import run_sequences_batched
    from visual_odom_tpu_torch.runner import pipeline

    launches = {"quad": 0, "quad_batched": 0}

    def report(part, res, eq):
        res.update(eq)
        print("kitti", json.dumps({"part": part, **res}))
        if not all(eq.values()):
            raise AssertionError(f"kitti, {part}: {eq}")

    # (a) the native library and the data
    t = time.perf_counter()
    lib_path = native.build_library()
    build_s = time.perf_counter() - t
    if not native.available():
        raise AssertionError("the native runtime did not load")
    t = time.perf_counter()
    dirs, size = write_kitti(courses, BATCH_COURSES, root)
    write_s = time.perf_counter() - t
    sframes = courses[("straight", "value")][0]
    left = os.path.join(dirs[("straight", "value")], "image_0")
    paths = [os.path.join(left, f"{i:06d}.png")
             for i in range(len(sframes))]
    t = time.perf_counter()
    decoded = [native.decode_png_gray(p) for p in paths]
    decode_us = 1e6 * (time.perf_counter() - t) / len(paths)
    seq = KittiSequence(dirs[("straight", "value")])
    report("data", dict(
        library=os.path.basename(lib_path), build_s=build_s,
        sequences=len(dirs), frames=sum(len(courses[k][0])
                                        for k in BATCH_COURSES),
        png_files=2 * sum(len(courses[k][0]) for k in BATCH_COURSES),
        png_mb=size / 1e6, write_s=write_s, decode_images=len(paths),
        decode_us_per_image=decode_us, image=f"{W}x{H}"), {
        "native_available": True,
        "decoded_equal_rendered": all(
            np.array_equal(d, f[0]) for d, f in zip(decoded, sframes)),
        "frame_equal_rendered": all(
            np.array_equal(a, b) for a, b in zip(seq.frame(7),
                                                 sframes[7])),
        "fallbacks_blocked": sys.modules.get("cv2", 0) is None
        and sys.modules.get("PIL", 0) is None})

    # (b) the PNG stream into the scan, in turns with the in-memory scan
    ref_poses, ref_out = ref
    n = len(sframes) - 1
    runs = []
    order = [("memory", 1), ("png", 1), ("png", 4)]
    for src, threads in order + order[::-1]:
        frames = (sframes if src == "memory"
                  else seq.iter_prefetched(n_threads=4))
        stats = {}
        reset_counts()
        p, out, wall, m = pipeline.run_sequence_scan(
            frames, config, intr, chunk=CHUNK, warmup=False,
            upload_threads=threads, stats_out=stats, device=dev)
        counts = read_counts()
        got = check_counts(f"kitti stream {src}", config, counts, m, False)
        if src == "png":
            launches["quad"] += got
        runs.append(dict(
            source=src, upload_threads=threads, steps=m, wall_s=wall,
            ms_per_frame=1e3 * wall / m, busy_frac=stats["busy_frac"],
            decode_s=stats["decode_s"], upload_s=stats["upload_s"],
            poses_vs_scan=bool(np.array_equal(p, ref_poses)),
            outputs_vs_scan=_same(out, ref_out)))
    report("stream", dict(course="straight", prefetch_threads=4,
                          runs=runs, **{
        f"median_ms_per_frame_{src}_{k}": float(np.median(
            [r["ms_per_frame"] for r in runs
             if (r["source"], r["upload_threads"]) == (src, k)]))
        for src, k in order}), {
        "every_run_bit_for_bit": all(
            r["poses_vs_scan"] and r["outputs_vs_scan"] for r in runs)})

    # (c) the batched runner over the four directories, failed after its
    # first snapshot and resumed (phase 11's run-batch reads them
    # uninterrupted)
    seqs = [KittiSequence(dirs[k]) for k in BATCH_COURSES]
    n_steps = max(len(s) for s in seqs) - 1
    ck = os.path.join(root, "batch.npz")
    kw = dict(chunk=CHUNK, device=dev)

    def batched(label, run_seqs, steps, **extra):
        reset_counts()
        out = run_sequences_batched(run_seqs, config, intr, **kw, **extra)
        launches["quad_batched"] += check_counts(
            label, config, read_counts(), steps, True)
        return out

    crash_stats, resume_stats = [], []
    reset_counts()
    # the failure is injected into a full-length course (frames past a
    # short course's end are its last frame)
    longest = max(range(len(seqs)), key=lambda i: len(seqs[i]))
    try:
        run_sequences_batched(seqs[:longest]
                              + [FailingSequence(seqs[longest],
                                                 KITTI_CRASH_AT)]
                              + seqs[longest + 1:],
                              config, intr,
                              checkpoint_path=ck,
                              checkpoint_every=KITTI_EVERY,
                              snapshot_stats=crash_stats, **kw)
        raise AssertionError("kitti batched: the injected failure did "
                             "not surface")
    except RuntimeError as e:
        if "injected" not in str(e):
            raise
    crash_launches = read_counts()["quad_batched"]
    launches["quad_batched"] += crash_launches
    at = crash_stats[-1]["step"]
    resumed = batched("kitti batched, resumed", seqs,
                      -(-(n_steps - at) // CHUNK) * CHUNK,
                      checkpoint_path=ck, checkpoint_every=KITTI_EVERY,
                      snapshot_stats=resume_stats)
    per_seq = []
    for key, p, st in zip(BATCH_COURSES, resumed[0], resumed[1]):
        ate, budget = ate_and_budget(p, courses[key][1])
        per_seq.append(dict(course="_".join(key), steps=st["frames"] - 1,
                            accept=st["accept_ratio"], ate_m=ate,
                            ate_budget_m=budget,
                            fallback_frames=st["fallback_frames"]))
    report("batch", dict(
        batch=len(seqs), steps=n_steps, chunk=CHUNK,
        checkpoint_every=KITTI_EVERY, crash_at=KITTI_CRASH_AT,
        snapshot_at=at, wall_resumed_s=resumed[2],
        ms_per_resumed_step=1e3 * resumed[2] / (n_steps - at),
        crash_launches=crash_launches,
        snapshots=crash_stats + resume_stats, sequences=per_seq), {
        "snapshot_at_expected": at == KITTI_CRASH_AT // KITTI_EVERY
        * KITTI_EVERY,
        "poses_resumed_vs_batch_path": all(
            np.array_equal(a, b) for a, b in zip(resumed[0], bposes)),
        "stats_resumed_vs_batch_path": resumed[1] == bstats,
        "bench_gates": all(r["accept"] >= 0.9
                           and r["ate_m"] <= r["ate_budget_m"]
                           for r in per_seq)})

    # (d) the devkit over the four results
    res_dir = os.path.join(root, "results")
    os.makedirs(res_dir)
    for key, p in zip(BATCH_COURSES, bposes):
        save_poses_kitti(os.path.join(res_dir, "_".join(key) + ".txt"), p)
    t = time.perf_counter()
    scores = eval_all(os.path.join(root, "gt"), res_dir,
                      os.path.join(root, "devkit"), plots=False)
    eval_s = time.perf_counter() - t
    rows, eq = [], {}
    for key, p in zip(BATCH_COURSES, bposes):
        name, gt = "_".join(key), courses[key][1]
        length = float(np.sum(np.linalg.norm(
            np.diff(gt[:, :3, 3], axis=0), axis=1)))
        aligned = ate_rmse(gt, p)
        row = dict(course=name, length_m=length,
                   ate_m=scores[name]["ate"], ate_in_memory_m=aligned,
                   ate_unaligned_m=ate_and_budget(p, gt)[0])
        if length >= 100.0:
            row.update(t_err_pct=100 * scores[name]["t_err"],
                       r_err_deg_per_m=57.2957795 * scores[name]["r_err"])
        rows.append(row)
        eq[f"ate_{name}"] = (abs(row["ate_m"] - aligned) <= EVAL_ATE_TOL
                             and aligned <= row["ate_unaligned_m"] + 1e-9)
    report("eval", dict(eval_s=eval_s, ate_tol_m=EVAL_ATE_TOL,
                        sequences=rows, avg=scores.get("avg")), eq)
    return launches, dirs, scores


def write_calibration(path, intr):
    """``intr`` as an OpenCV-YAML calibration file, each float written with
    ``repr`` so that ``load_calibration`` reads back the very same
    floats."""
    with open(path, "w") as f:
        f.write("%YAML:1.0\n")
        for k in ("fx", "fy", "cx", "cy", "bf"):
            f.write(f"Camera.{k}: {getattr(intr, k)!r}\n")
        f.write(f"Camera.width: {intr.width}\nCamera.height: {intr.height}\n")


def run_cli(argv):
    """The port's ``cli.main(argv)`` in this process (nothing is rebuilt):
    (exit code, stdout, stderr, seconds)."""
    from visual_odom_tpu_torch.runner import cli

    out, err = io.StringIO(), io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main([str(a) for a in argv])
    return rc, out.getvalue(), err.getvalue(), time.perf_counter() - t


def poses_file_bytes(path, poses):
    from visual_odom_tpu_torch.io.kitti import save_poses_kitti

    save_poses_kitti(path, poses)
    with open(path, "rb") as f:
        return f.read()


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def loop_ms_per_frame(stdout):
    """The ms per frame of the command's own "N frames in S s" line."""
    m = re.search(r"(\d+) frames in ([0-9.]+)s", stdout)
    return 1e3 * float(m.group(2)) / int(m.group(1)) if m else None


def cli_phase(courses, dirs, scores, ref, tracks, bposes, config, intr, dev,
              root):
    """Phase 11, the command line, in this process on phase 10's KITTI
    directories (nothing is rendered or written as PNG again) and a
    calibration file of the bench's camera. One ``cli`` line per part:
    (a) ``run`` on "straight": ``--chunk`` CLI_CHUNK, ``--chunk 0``, the
    resumable chunked run (stopped at its first snapshot, resumed, run
    again), and ``--ba-window`` CLI_BA_WINDOW, each pose file byte for byte
    the poses of phase 4's scan (or of ``smooth_trajectory_ba`` on that
    scan's track snapshots), with the kernel's launches; (b) ``run-batch``
    over the four directories (chunk CLI_BATCH_CHUNK, snapshots), each
    file phase 4's batched poses, under the bench gates, and a
    ``--data-parallel 2`` mesh refused; (c) ``eval`` and ``eval-all`` on
    those files against phase 10's ``eval_all``. Returns the launches per
    kernel ({"quad", "quad_batched"})."""
    from visual_odom_tpu_torch.ba.window import smooth_trajectory_ba
    from visual_odom_tpu_torch.config import load_calibration
    from visual_odom_tpu_torch.eval.kitti_eval import evaluate_sequence
    from visual_odom_tpu_torch.io.kitti import load_poses

    launches = {"quad": 0, "quad_batched": 0}
    work = os.path.join(root, "cli")
    os.makedirs(work)
    calib = os.path.join(work, "calib.yaml")
    write_calibration(calib, intr)
    ref_poses = ref[0]
    key = ("straight", "value")
    name = "_".join(key)
    seq_dir, gt_file = dirs[key], os.path.join(root, "gt", name + ".txt")
    n_steps = len(ref_poses) - 1

    def report(part, res, eq):
        res.update(eq)
        print("cli", json.dumps({"part": part, **res}))
        if not all(eq.values()):
            raise AssertionError(f"cli, {part}: {eq}")

    def counted(label, argv, steps, batched=False):
        """One command, its launches held to ``steps`` steps of the route."""
        reset_counts()
        rc, out, err, sec = run_cli(argv)
        if rc != 0:
            raise AssertionError(f"cli {label}: exit {rc}: {err[-2000:]}")
        got = check_counts(f"cli {label}", config, read_counts(), steps,
                           batched)
        launches["quad_batched" if batched else "quad"] += got
        return out, sec, got

    # (a) run, on the straight course
    gt = load_poses(gt_file)
    n = min(len(gt), len(ref_poses))
    want_score = json.dumps(evaluate_sequence(gt[:n], ref_poses[:n]),
                            indent=2)
    want = poses_file_bytes(os.path.join(work, "want.txt"), ref_poses)
    base = ["run", seq_dir, calib]
    runs, eq = [], {"calibration_round_trip": load_calibration(calib) == intr}

    def run_row(label, out_file, out, sec, got, **kw):
        runs.append(dict(variant=label, command_s=sec,
                         command_ms_per_frame=1e3 * sec / n_steps,
                         loop_ms_per_frame=loop_ms_per_frame(out),
                         launches=got, **kw))

    o = os.path.join(work, "chunk.txt")
    # the scan's warm-up steps its first chunk once on a throwaway state
    out, sec, got = counted("chunk", base + [gt_file, "--chunk", CLI_CHUNK,
                                             "--output", o],
                            n_steps + CLI_CHUNK)
    run_row("chunk", o, out, sec, got)
    eq["chunk_file_vs_scan"] = read_bytes(o) == want
    eq["chunk_scorecard"] = out[out.index("{"):].strip() == want_score

    o = os.path.join(work, "run.txt")
    out, sec, got = counted("run", base + ["--chunk", 0, "--output", o,
                                           "--quiet"], n_steps)
    run_row("run", o, out, sec, got)
    eq["run_file_vs_scan"] = read_bytes(o) == want

    o, ck = os.path.join(work, "resumable.txt"), os.path.join(work, "ck.npz")
    argv = base + ["--chunk", CLI_CHUNK, "--checkpoint", ck,
                   "--checkpoint-every", CLI_EVERY, "--output", o]
    # stopped at its first snapshot (the warm-up steps one frame), resumed
    # from it, and run again on the finished snapshot
    out, sec, got = counted("resumable, first part",
                            argv + ["--max-frames", CLI_EVERY + 1],
                            CLI_EVERY + 1)
    run_row("resumable_first_part", o, out, sec, got)
    eq["first_part_snapshot"] = os.path.exists(ck)
    out, sec, got = counted("resumable, resumed", argv, n_steps - CLI_EVERY + 1)
    run_row("resumable_resumed", o, out, sec, got)
    eq["resumed_says_so"] = f"resumed scan from {ck} at step {CLI_EVERY}" in out
    eq["resumed_file_vs_scan"] = read_bytes(o) == want
    out, sec, got = counted("resumable, again", argv, 0)
    run_row("resumable_again", o, out, sec, got)
    eq["again_file_unchanged"] = read_bytes(o) == want

    o = os.path.join(work, "ba.txt")
    out, sec, got = counted("ba", base + ["--chunk", CLI_CHUNK, "--ba-window",
                                          CLI_BA_WINDOW, "--output", o,
                                          "--quiet"], n_steps + CLI_CHUNK)
    run_row("ba_window", o, out, sec, got)
    t = time.perf_counter()
    smoothed = smooth_trajectory_ba(tracks, ref_poses[:len(tracks) + 1], intr,
                                    window=CLI_BA_WINDOW, max_landmarks=256,
                                    min_track_len=3, huber_delta=1.5,
                                    device=dev)
    ba_s = time.perf_counter() - t
    eq["ba_file_vs_direct"] = read_bytes(o) == poses_file_bytes(
        os.path.join(work, "want_ba.txt"), smoothed)
    eq["ba_moved_poses"] = not np.array_equal(smoothed, ref_poses)
    report("run", dict(course=name, steps=n_steps, chunk=CLI_CHUNK,
                       checkpoint_every=CLI_EVERY, ba_window=CLI_BA_WINDOW,
                       direct_ba_s=ba_s, runs=runs), eq)

    # (b) run-batch over the four directories
    out_dir = os.path.join(work, "batch")
    seqs = [dirs[k] for k in BATCH_COURSES]
    b_steps = max(len(courses[k][0]) for k in BATCH_COURSES) - 1
    argv = ["run-batch", *seqs, "--calibration", calib, "--out-dir", out_dir,
            "--gt-dir", os.path.join(root, "gt"), "--chunk", CLI_BATCH_CHUNK,
            "--checkpoint", os.path.join(work, "batch.npz"),
            "--checkpoint-every", CLI_BATCH_EVERY]
    out, sec, got = counted("run-batch", argv,
                            -(-b_steps // CLI_BATCH_CHUNK) * CLI_BATCH_CHUNK,
                            batched=True)
    per_seq, eq = [], {}
    for k, p in zip(BATCH_COURSES, bposes):
        cname = "_".join(k)
        f = os.path.join(out_dir, cname + ".txt")
        got_poses = load_poses(f)
        ate, budget = ate_and_budget(got_poses, courses[k][1])
        # a rejected frame leaves the pose where it was
        moved = np.any(got_poses[1:] != got_poses[:-1], axis=(1, 2))
        per_seq.append(dict(course=cname, steps=len(got_poses) - 1,
                            accept=float(moved.mean()), ate_m=ate,
                            ate_budget_m=budget))
        eq[f"file_vs_batch_path_{cname}"] = read_bytes(f) == poses_file_bytes(
            os.path.join(work, "want_" + cname + ".txt"), p)
    eq["bench_gates"] = all(r["accept"] >= 0.9 and r["ate_m"] <= r["ate_budget_m"]
                            for r in per_seq)
    summary = json.loads(out[out.index("{"):])
    eq["summary_names"] = sorted(summary) == sorted(
        "_".join(k) for k in BATCH_COURSES)
    rc, _, err, _ = run_cli(argv[:-4] + ["--data-parallel", 2])
    eq["data_parallel_2_refused"] = (rc == 2 and "mesh wants 2 devices, "
                                     "only 1 available" in err)
    report("run_batch", dict(batch=len(seqs), steps=b_steps,
                             chunk=CLI_BATCH_CHUNK,
                             checkpoint_every=CLI_BATCH_EVERY,
                             command_s=sec, launches=got,
                             ms_per_step=1e3 * sec / b_steps,
                             batch_refusal=err.strip(), sequences=per_seq), eq)

    # (c) eval and eval-all on those files
    rows, eq = [], {}
    for k in BATCH_COURSES:
        cname = "_".join(k)
        rc, out, _, _ = run_cli(["eval", "--gt", os.path.join(
            root, "gt", cname + ".txt"), "--result", os.path.join(
                out_dir, cname + ".txt")])
        ate = json.loads(out)["ate_rmse_m"]
        rows.append(dict(course=cname, ate_m=ate,
                         phase10_ate_m=scores[cname]["ate"]))
        eq[f"eval_{cname}"] = (rc == 0 and abs(ate - scores[cname]["ate"])
                               <= EVAL_ATE_TOL)
    rc, _, _, sec = run_cli(["eval-all", "--gt-dir", os.path.join(root, "gt"),
                             "--result-dir", out_dir, "--out-dir",
                             os.path.join(work, "devkit"), "--no-plots"])
    with open(os.path.join(work, "devkit", "summary.json")) as f:
        summary = json.load(f)
    eq["eval_all_exit"] = rc == 0
    for k in BATCH_COURSES:
        cname = "_".join(k)
        eq[f"eval_all_{cname}"] = (abs(summary[cname]["ate"]
                                       - scores[cname]["ate"]) <= EVAL_ATE_TOL)
    report("eval", dict(ate_tol_m=EVAL_ATE_TOL, eval_all_s=sec,
                        sequences=rows), eq)
    return launches


def device_rows(prof):
    """(device µs, op name, calls) of every device-side event (kernels,
    copies), largest first: the CPU-side aten ops carry the same device
    time again."""
    from torch.autograd import DeviceType

    return sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)


def pipe_phase(frames, ref, xref, config, xconfig, intr, dev):
    """Phase 11 ``pipe``: ``run_sequence_pipelined`` on "straight" with both
    stages on this card (two streams), on both LK routes: every output
    equal to phase 4's scan of the route bit for bit (``num_bucketed``
    against ``num_matched``, the JAX package's pipe's count), the route's
    launches per frame, the loop under sync-debug "error" (no host sync);
    then ms per frame in two turns with the in-memory scan, and device ms
    per frame and busy share over PIPE_PROFILE_STEPS frames under
    torch.profiler. Returns the launches per kernel ({"quad", "level"})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from visual_odom_tpu_torch.parallel import pipe
    from visual_odom_tpu_torch.runner import pipeline

    launches = {"quad": 0, "level": 0}
    devices = [dev, dev]
    n = len(frames) - 1
    real_loop = pipe._pipeline_loop
    strict = []

    def strict_loop(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real_loop(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            strict.append(True)

    for cfg, (ref_poses, ref_out) in ((config, ref), (xconfig, xref)):
        route = cfg.resolved_lk_backend()
        reset_counts()
        pipe._pipeline_loop = strict_loop
        try:
            poses, out, wall = pipe.run_sequence_pipelined(
                frames, cfg, intr, devices=devices)
        finally:
            pipe._pipeline_loop = real_loop
        counts = read_counts()
        got = check_counts(f"pipe {route}", cfg, counts, n, False)
        launches["quad" if route == "pallas" else "level"] += got
        eq = {"poses_vs_scan": bool(np.array_equal(poses, ref_poses)),
              "loop_without_host_sync": strict.pop() is True}
        for field in ref_out._fields:
            want = getattr(ref_out, "num_matched" if field == "num_bucketed"
                           else field)
            eq[f"{field}_vs_scan"] = bool(np.array_equal(getattr(out, field),
                                                         want))
        res = dict(part="bit_exact", route=route, steps=n, wall_s=wall,
                   ms_per_frame=1e3 * wall / n, launch_counts=counts, **eq)
        print("pipe", json.dumps(res))
        if not all(eq.values()):
            raise AssertionError(f"pipe, {route}: {eq}")

    # ms per frame in two turns with the in-memory scan, the quad route
    turns = []
    for door in ("scan", "pipe", "pipe", "scan"):
        if door == "scan":
            p, _, wall, m = pipeline.run_sequence_scan(
                frames, config, intr, chunk=CHUNK, warmup=False, device=dev)
        else:
            p, _, wall = pipe.run_sequence_pipelined(frames, config, intr,
                                                     devices=devices)
            m = n
        turns.append(dict(door=door, ms_per_frame=1e3 * wall / m,
                          poses_vs_scan=bool(np.array_equal(p, ref[0]))))
    steady = {d: float(np.median([r["ms_per_frame"] for r in turns
                                  if r["door"] == d])) for d in ("scan", "pipe")}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pipe.run_sequence_pipelined(frames[:PIPE_PROFILE_STEPS + 1], config,
                                    intr, devices=devices)
    rows = device_rows(prof)
    if not rows:
        raise AssertionError("pipe profile: the profiler saw no device time")
    device_ms = sum(r[0] for r in rows) / 1e3 / PIPE_PROFILE_STEPS
    res = dict(part="turns", route="pallas", turns=turns,
               median_ms_per_frame_scan=steady["scan"],
               median_ms_per_frame_pipe=steady["pipe"],
               pipe_over_scan=steady["pipe"] / steady["scan"],
               profiled_steps=PIPE_PROFILE_STEPS,
               device_ms_per_frame=device_ms,
               device_ops_per_frame=sum(r[2] for r in rows)
               / PIPE_PROFILE_STEPS,
               device_busy_share=device_ms / steady["pipe"],
               top_device_ops=[{"name": k[:90],
                                "ms_per_frame": us / 1e3 / PIPE_PROFILE_STEPS}
                               for us, k, _ in rows[:5]],
               every_turn_bit_for_bit=all(r["poses_vs_scan"] for r in turns))
    print("pipe", json.dumps(res))
    if not res["every_turn_bit_for_bit"]:
        raise AssertionError(f"pipe turns: {res}")
    return launches


def card_mesh(axes, dev):
    """A mesh of the given axes over ``dev`` named once per position."""
    from visual_odom_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(axes, devices=[dev] * int(np.prod(list(axes.values()))))


def sharded_ba_phase(dev):
    """Phase 12 ``sharded_ba``: ``sharded_ba_solve`` over MODEL_SHARDS
    landmark shards against ``ba_solve`` on the card, on a problem of each
    of SHARDED_BA_PROBLEMS' sizes; ms per GN iteration of both."""
    from visual_odom_tpu_torch.ba import problem, schur
    from visual_odom_tpu_torch.parallel.sharded_ba import sharded_ba_solve

    mesh = card_mesh({"data": 1, "model": MODEL_SHARDS}, dev)
    for n_poses, n_landmarks in SHARDED_BA_PROBLEMS:
        p, _, _ = problem.synthetic_ba_problem(
            num_poses=n_poses, num_landmarks=n_landmarks, seed=7,
            obs_window=None if n_poses <= 8 else 2, device=dev)
        ref = schur.ba_solve(p, iterations=SHARDED_BA_ITERS)
        got = sharded_ba_solve(p, mesh, iterations=SHARDED_BA_ITERS)
        res = dict(poses=n_poses, landmarks=n_landmarks, shards=MODEL_SHARDS,
                   iterations=SHARDED_BA_ITERS,
                   max_abs_dpose=float((got.poses - ref.poses).abs().max()),
                   max_abs_dlandmark=float(
                       (got.landmarks - ref.landmarks).abs().max()),
                   pose_tol=SHARDED_POSE_TOL, landmark_tol=SHARDED_LM_TOL,
                   ms_per_iteration=time_ms(lambda: sharded_ba_solve(
                       p, mesh, iterations=1), reps=5, warm=1),
                   ba_solve_ms_per_iteration=time_ms(lambda: schur.ba_solve(
                       p, iterations=1), reps=5, warm=1))
        print("sharded_ba", json.dumps(res))
        if not (res["max_abs_dpose"] < SHARDED_POSE_TOL
                and res["max_abs_dlandmark"] < SHARDED_LM_TOL):
            raise AssertionError(f"sharded BA differs from ba_solve: {res}")


def ring_phase(tracks, poses, intr, dev):
    """Phase 12 ``ring_ba``: ``ring_ba_solve`` over RING_WINDOWS windows of
    a RING_POSES x RING_LANDMARKS synthetic trajectory against
    ``ba_solve`` (halo RING_HALO; auto halo with Huber 1.5 and one gross
    outlier),
    the same problem through ``make_ring_window_solver``, and
    ``smooth_trajectory_ba`` with that solver on phase 8's track snapshots
    against the default solver; which branch each problem took, and ms
    per GN round beside ``ba_solve``'s ms per iteration."""
    import torch

    from visual_odom_tpu_torch.ba import problem, schur, window
    from visual_odom_tpu_torch.parallel import ring_ba

    mesh = card_mesh({"seq": RING_WINDOWS}, dev)
    p, _, _ = problem.synthetic_ba_problem(
        num_poses=RING_POSES, num_landmarks=RING_LANDMARKS, pixel_noise=0.2,
        pose_perturb=0.015, landmark_perturb=0.08, seed=3,
        obs_window=RING_OBS_WINDOW, device=dev)
    obs = p.observations.clone()
    w, l = np.argwhere(p.mask.cpu().numpy())[0]
    obs[w, l, :2] += 25.0
    ring_problems = 0
    for label, prob, kw, tol in (
            (f"halo{RING_HALO}", p, dict(halo=RING_HALO, rounds=RING_ROUNDS),
             RING_TOL),
            ("auto_halo_huber", p._replace(observations=obs),
             dict(halo=None, rounds=8, huber_delta=1.5), RING_HUBER_TOL)):
        huber = kw.get("huber_delta", 0.0)
        ref = schur.ba_solve(prob, iterations=kw["rounds"], huber_delta=huber)
        got = ring_ba.ring_ba_solve(prob, mesh, cg_iters=RING_CG_ITERS, **kw)
        res = dict(part=label, poses=RING_POSES, landmarks=RING_LANDMARKS,
                   obs_window=RING_OBS_WINDOW, windows=RING_WINDOWS,
                   cg_iters=RING_CG_ITERS,
                   halo=ring_ba.required_ring_halo(prob) if kw["halo"] is None
                   else kw["halo"], rounds=kw["rounds"], huber_delta=huber,
                   max_abs_dpose=float((got.poses - ref.poses).abs().max()),
                   tol=tol, gauge_fixed=bool(torch.equal(got.poses[0],
                                                         prob.poses[0])),
                   ms_per_round=time_ms(lambda: ring_ba.ring_ba_solve(
                       prob, mesh, cg_iters=RING_CG_ITERS,
                       **dict(kw, rounds=1)), reps=3, warm=1),
                   ba_solve_ms_per_iteration=time_ms(lambda: schur.ba_solve(
                       prob, iterations=1, huber_delta=huber), reps=5,
                       warm=1))
        print("ring_ba", json.dumps(res))
        if not (res["max_abs_dpose"] < tol and res["gauge_fixed"]):
            raise AssertionError(f"ring BA differs from ba_solve: {res}")

    solver = ring_ba.make_ring_window_solver(mesh, cg_iters=RING_CG_ITERS)
    got = solver(p)
    ref = schur.ba_solve(p, iterations=8, huber_delta=1.5)
    res = dict(part="window_solver", branches=dict(solver.branches),
               max_abs_dpose=float((got.poses - ref.poses).abs().max()),
               tol=RING_SMOOTH_TOL)
    print("ring_ba", json.dumps(res))
    ring_problems += solver.branches["ring"]
    if not res["max_abs_dpose"] < RING_SMOOTH_TOL:
        raise AssertionError(f"ring window solver: {res}")

    kw = BA_SHORT
    solver = ring_ba.make_ring_window_solver(mesh)
    start = poses[:len(tracks) + 1]
    t = time.perf_counter()
    ring = window.smooth_trajectory_ba(
        tracks, start, intr, window=kw["window"], solver=solver,
        max_landmarks=kw["max_landmarks"], min_track_len=kw["min_track_len"],
        device=dev)
    ring_s = time.perf_counter() - t
    ref = window.smooth_trajectory_ba(
        tracks, start, intr, window=kw["window"], iterations=kw["iterations"],
        max_landmarks=kw["max_landmarks"], min_track_len=kw["min_track_len"],
        huber_delta=kw["huber_delta"], device=dev)
    ring_problems += solver.branches["ring"]
    res = dict(part="smoothing", course="straight_value",
               window=kw["window"], windows=len(start) // kw["window"],
               branches=dict(solver.branches), wall_s=ring_s,
               max_abs_dpose=float(np.abs(ring - ref).max()),
               tol=RING_SMOOTH_TOL, ring_problems_in_phase=ring_problems)
    print("ring_ba", json.dumps(res))
    if not (res["max_abs_dpose"] < RING_SMOOTH_TOL and ring_problems >= 1):
        raise AssertionError(f"ring smoothing: {res}")


def posegraph_sharded_phase(frames, poses, gt, ref_poses, config, intr, dev):
    """Phase 12 ``posegraph_sharded``: ``close_loops`` on phase 7's loop
    course with the graph solved edge-sharded over MODEL_SHARDS shards,
    against phase 7's ``close_loops`` (``mesh=None``); the closure before
    and after; ms per sharded and single solve. Returns its quad
    launches (one loop-edge measurement: 2) and the frames it read, by
    index (phase 13 hands the ranks those alone)."""
    from visual_odom_tpu_torch.ba import posegraph
    from visual_odom_tpu_torch.io.synthetic import SyntheticStereoSequence
    from visual_odom_tpu_torch.runner import loopclosure

    mesh = card_mesh({"data": 1, "model": MODEL_SHARDS}, dev)
    lf = SyntheticStereoSequence._loop_schedule(len(frames))[2]
    read = set()

    def frame(i):
        read.add(int(i))
        return frames[i]

    reset_counts()
    new_poses, info = loopclosure.close_loops(
        poses, frame, config, intr, gt_loop_pair=(0, lf), mesh=mesh,
        device=dev)
    counts = read_counts()
    graph = info.graph
    res = dict(shards=MODEL_SHARDS, edges=info.edges,
               nodes=int(graph.nodes.shape[0]),
               graph_edges=int(graph.edges.shape[0]),
               closure_before_m=info.closure_before_m,
               closure_after_m=info.closure_after_m,
               ate_after_m=ate_and_budget(new_poses, gt)[0],
               max_abs_dpose_vs_single=float(np.abs(new_poses
                                                    - ref_poses).max()),
               tol=NODE_CARD_CPU_TOL, launch_counts=counts,
               sharded_solve_ms=time_ms(
                   lambda: posegraph.sharded_posegraph_solve(graph, mesh),
                   reps=3, warm=1),
               solve_ms=time_ms(lambda: posegraph.posegraph_solve(graph),
                                reps=3, warm=1))
    print("posegraph_sharded", json.dumps(res))
    # a loop measurement is one step, one quad launch
    steps = counts["quad"]
    if not (res["max_abs_dpose_vs_single"] < NODE_CARD_CPU_TOL
            and info.closure_after_m < info.closure_before_m
            and counts == dict(dict.fromkeys(counts, 0), quad=steps,
                               **pnp_steps(steps))):
        raise AssertionError(f"sharded pose graph: {res}")
    tally_pnp(counts)
    return counts["quad"], sorted(read)


def _poses_agree(got, want):
    """(bit for bit, largest |difference|) of two pose lists."""
    same = all(np.array_equal(a, b) for a, b in zip(got, want))
    return same, max(float(np.abs(a - b).max()) for a, b in zip(got, want))


def batch_mesh_phase(courses, bposes, xbposes, config, xconfig, intr, dev):
    """Phase 12 ``batch_mesh``: phase 4's batched courses, MESH_STEPS
    steps, through ``run_sequences_batched(mesh=)`` on each of MESH_SHAPES
    (this card named once per position), on both LK routes. Each mesh is
    held bit for bit (or within SAME_TOL, the largest difference printed)
    to the one-device run at its rows' batch: phase 4's batched run of the
    route (its first MESH_STEPS steps) for one data row; for two, one
    one-device batched run per row of that row's sequences, seeded as the
    row seeds them (cuBLAS picks its kernels by batch size: the coarsest
    pyramid level of a batch of 2 differs in the last bits from the same
    rows of a batch of 4). Each is also compared with phase 4's run
    (printed), every sequence held to the bench gates (the checker
    course's ATE only at its full length, in phase 4: over its first
    steps the JAX package misses the budget too, see phase 4), every chunk
    stepped under CUDA sync debug mode "error", and the quad's launches
    counted per mesh position (each row's 3 quads a step, or its 32 level
    launches, split into ``model`` launches of n/model slots). Each row
    replays its step's CUDA graph, captured inside the run (the
    graph caches cleared before it), so that the launches' slots are read
    from the calls made at capture. Returns the
    launches per kernel ({"quad_batched", "level_batched"}) and the
    one-device reference poses by route and data rows ({route: {1: phase
    4's, 2: the rows' own}})."""
    import torch

    from visual_odom_tpu_torch.ops import lk_cuda
    from visual_odom_tpu_torch.parallel import batch, batch_eval
    from visual_odom_tpu_torch.parallel.mesh import split_ranges
    from visual_odom_tpu_torch.runner import pipeline

    seqs = [courses[k][0][:MESH_STEPS + 1] for k in BATCH_COURSES]
    launches = {"quad_batched": 0, "level_batched": 0}
    row_refs = {}
    real_scan = batch_eval.make_batched_scan_fn
    strict = []

    def strict_scan_fn(*args, **kwargs):
        scan = real_scan(*args, **kwargs)

        def scan_strict(state, lefts, rights):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return scan(state, lefts, rights)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                strict.append(lefts.shape[0])

        return scan_strict

    for cfg, ref in ((config, bposes), (xconfig, xbposes)):
        route = cfg.resolved_lk_backend()
        unsharded = [r[:MESH_STEPS + 1] for r in ref]
        by_rows = {1: unsharded, 2: [p for a, b in split_ranges(len(seqs), 2)
                                     for p in batch_eval.run_sequences_batched(
                                         seqs[a:b], cfg, intr, seed=a,
                                         chunk=MESH_CHUNK, device=dev)[0]]}
        row_refs[route] = by_rows
        for rows, cols in MESH_SHAPES:
            want = by_rows[rows]
            mesh = card_mesh({"data": rows, "model": cols}, dev)
            # The rows' graphs are captured inside the run (under the sync
            # check), so that their kernels' calls, made at capture, are
            # recorded.
            pipeline._graphed_step.cache_clear()
            batch._graphed_split_step.cache_clear()
            reset_counts()
            strict.clear()
            batch_eval.make_batched_scan_fn = strict_scan_fn
            try:
                with recorded_calls(lk_cuda, "lk_quad_cuda") as quads:
                    poses, stats, wall = batch_eval.run_sequences_batched(
                        seqs, cfg, intr, chunk=MESH_CHUNK, mesh=mesh)
            finally:
                batch_eval.make_batched_scan_fn = real_scan
            counts = read_counts()
            same, diff = _poses_agree(poses, want)
            diff_unsharded = _poses_agree(poses, unsharded)
            per_seq = []
            for k, p, st in zip(BATCH_COURSES, poses, stats):
                ate, budget = ate_and_budget(p, courses[k][1][:MESH_STEPS + 1])
                per_seq.append(dict(course="_".join(k),
                                    accept=st["accept_ratio"], ate_m=ate,
                                    ate_budget_m=budget,
                                    ate_gated=k[1] != "checker"))
            # each row steps its sequences: one pnp_ransac call a step
            expected = dict(dict.fromkeys(counts, 0),
                            **pnp_steps(rows * MESH_STEPS))
            tally_pnp(counts)
            if route == "pallas":
                expected["quad_batched"] = (LAUNCHES_PER_FRAME * rows * cols
                                            * MESH_STEPS)
            else:
                expected["level_batched"] = (LEVEL_LAUNCHES_PER_FRAME * rows
                                             * cols * MESH_STEPS)
            slots = sorted(set(int(q[3].shape[-2]) for q in quads))
            batches = sorted(set(int(q[3].shape[0]) for q in quads))
            res = dict(route=route, mesh=mesh.shape, steps=MESH_STEPS,
                       wall_s=wall, ms_per_step=1e3 * wall / MESH_STEPS,
                       reference=("phase 4, batch 4" if rows == 1 else
                                  f"one device, batch {len(seqs) // rows}"),
                       bit_for_bit=same, max_abs_dpose=diff, tol=SAME_TOL,
                       bit_for_bit_vs_phase4=diff_unsharded[0],
                       max_abs_dpose_vs_phase4=diff_unsharded[1],
                       chunks_without_host_sync=len(strict),
                       launch_counts=counts,
                       launches_per_mesh_position=sum(counts.values())
                       / (rows * cols),
                       quad_slots=slots, quad_batch=batches,
                       sequences=per_seq)
            print("batch_mesh", json.dumps(res))
            want_slots = ([] if route != "pallas" else sorted(
                {-(-384 // cols), 384 // cols, -(-64 // cols), 64 // cols}))
            if not ((same or diff < SAME_TOL) and counts == expected
                    and len(strict) == MESH_STEPS // MESH_CHUNK
                    and slots == want_slots
                    and all(r["accept"] >= 0.9
                            and (r["ate_m"] <= r["ate_budget_m"]
                                 or not r["ate_gated"]) for r in per_seq)):
                raise AssertionError(f"batch mesh {mesh.shape}, {route}: {res}")
            for k in launches:
                launches[k] += counts[k]
    return launches, row_refs


def cli_mesh_phase(dirs, root, bposes, row_poses, config, dev):
    """Phase 12 ``cli``: (a) ``run --ba-window CLI_BA_WINDOW --ba-ring
    RING_WINDOWS`` on "straight": the "seq" mesh is the visible cards, so on
    one card the solver takes its one-device branch (``ba_solve`` at the
    default solver's settings) and the pose file is phase 11's
    ``--ba-window`` file byte for byte; (b) ``run-batch --data-parallel 2``
    on one card exits 2 with make_mesh's message; (c) through a device list
    of this card named twice, ``run-batch --data-parallel 2`` steps a (2, 1)
    mesh to its pose files, each the poses of the one-device run of its
    data row (``batch_mesh_phase``'s ``row_poses``, MESH_STEPS steps).
    Returns the launches per kernel ({"quad", "quad_batched"})."""
    from visual_odom_tpu_torch.io.kitti import load_poses
    from visual_odom_tpu_torch.runner import cli

    work = os.path.join(root, "cli")
    calib = os.path.join(work, "calib.yaml")
    straight = dirs[("straight", "value")]
    n_steps = len(bposes[0]) - 1
    eq, res = {}, {}

    o = os.path.join(work, "ba_ring.txt")
    reset_counts()
    rc, out, err, sec = run_cli(["run", straight, calib, "--chunk", CLI_CHUNK,
                                 "--ba-window", CLI_BA_WINDOW, "--ba-ring",
                                 RING_WINDOWS, "--output", o, "--quiet"])
    if rc != 0:
        raise AssertionError(f"cli --ba-ring: exit {rc}: {err[-2000:]}")
    quad = check_counts("cli --ba-ring", config, read_counts(),
                        n_steps + CLI_CHUNK, False)
    eq["ba_ring_file_vs_ba_window_file"] = read_bytes(o) == read_bytes(
        os.path.join(work, "ba.txt"))
    res["ba_ring_command_s"] = sec

    out_dir = os.path.join(work, "batch_mesh")
    argv = ["run-batch", *(dirs[k] for k in BATCH_COURSES), "--calibration",
            calib, "--out-dir", out_dir, "--chunk", CLI_BATCH_CHUNK,
            "--max-frames", MESH_STEPS + 1, "--data-parallel", 2]
    rc, _, refusal, _ = run_cli(argv)
    eq["data_parallel_2_refused_on_one_card"] = (
        rc == 2 and "mesh wants 2 devices, only 1 available" in refusal)
    real = cli._mesh_devices
    cli._mesh_devices = lambda device: [dev, dev]
    reset_counts()
    try:
        rc, out, err, sec = run_cli(argv)
    finally:
        cli._mesh_devices = real
    if rc != 0:
        raise AssertionError(f"cli run-batch on a mesh: exit {rc}: "
                             f"{err[-2000:]}")
    counts = read_counts()
    batched = counts["quad_batched"]
    eq["run_batch_mesh_launches"] = counts == dict(
        dict.fromkeys(counts, 0), **pnp_steps(2 * MESH_STEPS),
        quad_batched=LAUNCHES_PER_FRAME * 2 * MESH_STEPS)
    tally_pnp(counts)
    got = [load_poses(os.path.join(out_dir, "_".join(k) + ".txt"))
           for k in BATCH_COURSES]
    want = row_poses
    eq["run_batch_mesh_files"] = all(
        read_bytes(os.path.join(out_dir, "_".join(k) + ".txt"))
        == poses_file_bytes(os.path.join(work, "want_mesh.txt"), p)
        for k, p in zip(BATCH_COURSES, want)) or (
        max(float(np.abs(a - b).max()) for a, b in zip(got, want))
        < SAME_TOL)
    res.update(run_batch_mesh={"data": 2, "model": 1},
               run_batch_command_s=sec, launch_counts=counts,
               run_batch_max_abs_dpose=max(float(np.abs(a - b).max())
                                           for a, b in zip(got, want)),
               refusal=refusal.strip())
    res.update(eq)
    print("cli", json.dumps({"part": "mesh", **res}))
    if not all(eq.values()):
        raise AssertionError(f"cli, mesh: {eq}")
    return {"quad": quad, "quad_batched": batched}


def _rank_inputs(root, lposes, lgt_pair, lframes, loop_read, courses):
    """Phase 13's inputs for the spawned ranks, under ``root``: phase 7's
    chain and the loop frames ``close_loops`` reads (``loop.npz``), and
    the batched courses' first MESH_STEPS + 1 frames (``batch.npy``,
    (courses, frames, 2, H, W) uint8)."""
    np.savez(os.path.join(root, "loop.npz"), poses=lposes,
             pair=np.asarray(lgt_pair), index=np.asarray(loop_read),
             frames=np.asarray([np.stack(lframes[i]) for i in loop_read],
                               dtype=np.uint8).reshape(
                 (len(loop_read), 2) + np.shape(lframes[0][0])))
    np.save(os.path.join(root, "batch.npy"), np.stack([
        np.stack([np.stack(f) for f in courses[k][0][:MESH_STEPS + 1]])
        for k in BATCH_COURSES]))


def _probe_gloo_cuda(dev) -> dict:
    """Whether gloo's all-gather and broadcast take CUDA tensors, each
    tried once on a group of its own."""
    import torch
    import torch.distributed as dist

    me, world = dist.get_rank(), dist.get_world_size()
    res = {}
    for op in ("all_gather", "broadcast"):
        group = dist.new_group(list(range(world)), backend="gloo")
        x = torch.full((4,), float(me + 1), device=dev)
        if op == "all_gather":
            out = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(out, x, group=group)
            res[op] = [float(o[0]) for o in out] == [r + 1.0
                                                     for r in range(world)]
        else:
            dist.broadcast(x, src=0, group=group)
            res[op] = float(x[0]) == 1.0
        dist.destroy_process_group(group)
    return res


def send_probe_main(argv) -> int:
    """``chip_smoke.py --gloo-send-probe PORT RANK``: two ranks over gloo
    exchange CUDA tensors with ``batch_isend_irecv``; prints "sent" when
    that works (gloo's TCP pairs write from host memory, so it may end the
    process instead)."""
    import torch
    import torch.distributed as dist

    port, rank = argv
    rank = int(rank)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    x = torch.full((4,), float(rank + 1), device=dev)
    y = torch.empty_like(x)
    for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 1 - rank),
                                     dist.P2POp(dist.irecv, y, 1 - rank)]):
        w.wait()
    print("sent" if float(y[0]) == 2.0 - rank else "wrong", flush=True)
    dist.destroy_process_group()
    return 0


def rank_main(argv) -> int:
    """One rank of phase 13 (``chip_smoke.py --rank BACKEND WORLD RANK PORT
    DIR``) on ``cuda:0``: the multi-device paths on meshes of the group's
    ranks, each result saved to DIR for the parent to hold to its
    one-process counterpart."""
    import torch
    import torch.distributed as dist

    from visual_odom_tpu_torch.ba import problem
    from visual_odom_tpu_torch.config import VOConfig
    from visual_odom_tpu_torch.parallel import batch_eval, collectives
    from visual_odom_tpu_torch.parallel.mesh import (Rank,
                                                     initialize_distributed,
                                                     make_mesh, mesh_axis)
    from visual_odom_tpu_torch.parallel.ring_ba import ring_ba_solve
    from visual_odom_tpu_torch.parallel.sharded_ba import sharded_ba_solve
    from visual_odom_tpu_torch.runner import loopclosure

    backend, world, rank, port, where = argv
    world, rank = int(world), int(rank)
    dev = torch.device("cuda", 0)
    coordinator = f"127.0.0.1:{port}"
    t0 = time.perf_counter()
    if backend == "nccl":
        initialize_distributed(coordinator, world, rank, device=dev)
    else:
        # gloo on the card: the phase's explicit choice, two ranks on one
        # card (NCCL refuses a card named twice)
        torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=world, rank=rank)
    res = {"backend": dist.get_backend(), "world": world, "rank": rank,
           "init_s": time.perf_counter() - t0}
    positions = [Rank(r, dev) for r in range(world)]
    arrays = {}
    if backend == "gloo":
        res["gloo_cuda_tensors"] = _probe_gloo_cuda(dev)
    # ppermute around the ring of ranks (at world size 1 a rank sends to
    # itself: NCCL's batch_isend_irecv on the card)
    line = mesh_axis(make_mesh({"x": world}, positions), "x")
    x = torch.arange(3, dtype=torch.float32, device=dev) + rank
    got = collectives.ppermute([x], [(k, (k + 1) % world)
                                     for k in range(world)], line)[0]
    res["ppermute_ring_ok"] = bool(torch.equal(
        got, torch.arange(3, dtype=torch.float32, device=dev)
        + (rank - 1) % world))

    t = time.perf_counter()
    p = problem.synthetic_ba_problem(num_poses=SHARDED_BA_PROBLEMS[0][0],
                                     num_landmarks=SHARDED_BA_PROBLEMS[0][1],
                                     seed=7, device=dev)[0]
    got = sharded_ba_solve(p, make_mesh({"data": 1, "model": world},
                                        positions),
                           iterations=SHARDED_BA_ITERS)
    arrays["sharded_ba_poses"] = got.poses.cpu().numpy()
    arrays["sharded_ba_landmarks"] = got.landmarks.cpu().numpy()
    res["sharded_ba_s"] = time.perf_counter() - t

    t = time.perf_counter()
    got = ring_ba_solve(_ring_problem(dev), make_mesh({"seq": world},
                                                      positions),
                        halo=RING_HALO, rounds=RING_ROUNDS,
                        cg_iters=RING_CG_ITERS)
    arrays["ring_poses"] = got.poses.cpu().numpy()
    res["ring_s"] = time.perf_counter() - t

    H_, W_ = H, W
    config = VOConfig.for_image(H_, W_)
    xconfig = VOConfig.for_image(H_, W_, lk_backend="xla")
    intr = kitti_intrinsics(H_, W_)
    loop = np.load(os.path.join(where, "loop.npz"))
    frames = {int(i): tuple(f) for i, f in zip(loop["index"],
                                                loop["frames"])}
    t = time.perf_counter()
    reset_counts()
    new_poses, info = loopclosure.close_loops(
        loop["poses"], lambda i: frames[int(i)], config, intr,
        gt_loop_pair=tuple(int(v) for v in loop["pair"]),
        mesh=make_mesh({"model": world}, positions), device=dev)
    res["loop_counts"] = read_counts()
    res["loop_s"] = time.perf_counter() - t
    res["loop_edges"] = info.edges
    arrays["loop_poses"] = new_poses

    seqs_arr = np.load(os.path.join(where, "batch.npy"))
    seqs = [[(f[0], f[1]) for f in c] for c in seqs_arr]
    real_scan = batch_eval.make_batched_scan_fn
    strict = []

    def strict_scan_fn(*args, **kwargs):
        scan = real_scan(*args, **kwargs)

        def scan_strict(state, lefts, rights):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return scan(state, lefts, rights)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                strict.append(lefts.shape[0])

        return scan_strict

    res["batch"] = {}
    for shape in RANK_MESHES[world]:
        for cfg in (config, xconfig):
            route = cfg.resolved_lk_backend()
            mesh = make_mesh({"data": shape[0], "model": shape[1]},
                             positions)
            strict.clear()
            # NCCL's collectives run on the card's streams: the chunks
            # must never wait for the card; gloo's wait on the host
            if backend == "nccl":
                batch_eval.make_batched_scan_fn = strict_scan_fn
            reset_counts()
            try:
                poses, stats, wall = batch_eval.run_sequences_batched(
                    seqs, cfg, intr, chunk=MESH_CHUNK, mesh=mesh)
            finally:
                batch_eval.make_batched_scan_fn = real_scan
            key = f"{shape[0]}x{shape[1]}_{route}"
            res["batch"][key] = dict(
                counts=read_counts(), wall_s=wall,
                ms_per_step=1e3 * wall / MESH_STEPS,
                chunks_without_host_sync=len(strict),
                accept=[s["accept_ratio"] for s in stats])
            arrays[f"batch_{key}"] = np.stack(poses)
    res["total_s"] = time.perf_counter() - t0
    np.savez(os.path.join(where, f"rank-{backend}-{rank}.npz"), **arrays)
    with open(os.path.join(where, f"rank-{backend}-{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    return 0


def cards_rank_main(argv) -> int:
    """One of the two NCCL ranks of phase 13's check across cards
    (``chip_smoke.py --cards-rank RANK PORT DIR``), rank r on ``cuda:r``:
    ``sharded_ba_solve`` (SHARDED_BA_PROBLEMS[0]), ``ring_ba_solve``
    (phase 12's problem, RING_GRAPH_ROUNDS rounds), the edge-sharded pose
    graph of a 64-keyframe circle and ``run_sequences_batched`` of
    ``batch.npy``'s first two courses on CARDS_RANK_MESHES, each over the
    two ranks, first eager (``dispatch(False)``) and then by default,
    replaying CUDA graphs that hold the NCCL collectives. Saves each run's
    results, launches and ms, and the graphs built, to DIR."""
    import torch

    from visual_odom_tpu_torch.ba import posegraph, problem
    from visual_odom_tpu_torch.config import VOConfig
    from visual_odom_tpu_torch.parallel.batch_eval import run_sequences_batched
    from visual_odom_tpu_torch.parallel.mesh import (initialize_distributed,
                                                     make_mesh,
                                                     visible_devices)
    from visual_odom_tpu_torch.parallel.ring_ba import ring_ba_solve
    from visual_odom_tpu_torch.parallel.sharded_ba import sharded_ba_solve
    from visual_odom_tpu_torch.utils import cudagraph

    rank, port, where = int(argv[0]), argv[1], argv[2]
    dev = torch.device("cuda", rank)
    initialize_distributed(f"127.0.0.1:{port}", 2, rank, device=dev)
    ranks = visible_devices()
    p = problem.synthetic_ba_problem(num_poses=SHARDED_BA_PROBLEMS[0][0],
                                     num_landmarks=SHARDED_BA_PROBLEMS[0][1],
                                     seed=7, device=dev)[0]
    ring = _ring_problem(dev)
    graph = posegraph.build_keyframe_graph(*_circle_chain(), device=dev)
    seqs = [[(f[0], f[1]) for f in c]
            for c in np.load(os.path.join(where, "batch.npy"))[:2]]
    config = VOConfig.for_image(H, W)
    intr = kitti_intrinsics(H, W)
    paths = {
        "sharded_ba": lambda: sharded_ba_solve(
            p, make_mesh({"data": 1, "model": 2}, ranks),
            iterations=SHARDED_BA_ITERS)[:2],
        "ring": lambda: ring_ba_solve(
            ring, make_mesh({"seq": 2}, ranks), halo=RING_HALO,
            rounds=RING_GRAPH_ROUNDS, cg_iters=RING_CG_ITERS)[:2],
        "posegraph": lambda: (posegraph.sharded_posegraph_solve(
            graph, make_mesh({"model": 2}, ranks)).nodes,)}
    for rows, cols in CARDS_RANK_MESHES:
        paths[f"batch_{rows}x{cols}"] = lambda rows=rows, cols=cols: tuple(
            torch.from_numpy(x) for x in run_sequences_batched(
                seqs, config, intr, chunk=MESH_CHUNK, mesh=make_mesh(
                    {"data": rows, "model": cols}, ranks))[0])
    out = {}
    for mode in ("eager", "graph"):
        for name, fn in paths.items():
            torch.distributed.barrier()
            torch.cuda.synchronize(dev)
            before = read_counts()
            t = time.perf_counter()
            with (cudagraph.dispatch(False) if mode == "eager"
                  else contextlib.nullcontext()):
                got = fn()
            torch.cuda.synchronize(dev)
            ms = 1e3 * (time.perf_counter() - t)
            after = read_counts()
            out[f"{mode}_{name}"] = {
                "out": [x.cpu().numpy() for x in got], "ms": ms,
                "launches": {k: after[k] - before[k] for k in after}}
    built = [c.label for g in list(cudagraph._GRAPHED)
             for c in g.captures.values() if c.collectives]
    torch.distributed.destroy_process_group()
    with open(os.path.join(where, f"cards-rank-{rank}.pkl"), "wb") as f:
        pickle.dump({"runs": out, "graphs_built": built}, f)
    return 0


def nccl_across_cards(root) -> dict:
    """Phase 13 on two cards or more: two NCCL ranks over cards 0 and 1
    (``cards_rank_main``, on ``root``'s ``batch.npy``), each path's graphed
    run held bit for bit to its eager run with equal launches, and every
    path's results held equal on both ranks. Prints the ``ranks`` line of
    part ``nccl_across_cards`` and returns it; on one card the line says
    the check did not run, and why."""
    import socket

    import torch

    n = torch.cuda.device_count()
    if n < 2:
        line = {"part": "nccl_across_cards", "run": False,
                "reason": f"{n} card visible: two NCCL ranks need two cards"}
        print("ranks", json.dumps(line))
        return line
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.monotonic()
    procs = []
    for r in range(2):
        log = open(os.path.join(root, f"cards-rank-{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cards-rank",
             str(r), str(port), root], stdout=log,
            stderr=subprocess.STDOUT), log))
    bad = _wait_ranks(procs, t0 + CARDS_RANK_TIMEOUT)
    if bad:
        raise AssertionError(f"phase 13: NCCL ranks across cards failed or "
                             f"timed out: {bad}")
    res = []
    for r in range(2):
        with open(os.path.join(root, f"cards-rank-{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    names = [k[len("graph_"):] for k in res[0]["runs"] if
             k.startswith("graph_")]

    def same(a, b):
        return len(a) == len(b) and all(
            x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a, b))

    graphed_eq = {f"{name}_rank{r}": (
        same(x["runs"][f"graph_{name}"]["out"], x["runs"][f"eager_{name}"]
             ["out"]) and x["runs"][f"graph_{name}"]["launches"]
        == x["runs"][f"eager_{name}"]["launches"])
        for name in names for r, x in enumerate(res)}
    ranks_eq = {name: same(res[0]["runs"][f"graph_{name}"]["out"],
                           res[1]["runs"][f"graph_{name}"]["out"])
                for name in names}
    line = {"part": "nccl_across_cards", "run": True, "world": 2,
            "cards": ["cuda:0", "cuda:1"],
            "graphs_built": [len(x["graphs_built"]) for x in res],
            "graphed_equals_eager": graphed_eq,
            "ranks_equal": ranks_eq,
            "ms_graph": {name: [x["runs"][f"graph_{name}"]["ms"]
                                for x in res] for name in names},
            "ms_eager": {name: [x["runs"][f"eager_{name}"]["ms"]
                                for x in res] for name in names},
            "launches": {name: res[0]["runs"][f"graph_{name}"]["launches"]
                         for name in names},
            "wall_s": time.monotonic() - t0}
    print("ranks", json.dumps(line))
    if not (all(graphed_eq.values()) and all(ranks_eq.values())
            and all(line["graphs_built"])):
        raise AssertionError(f"phase 13: NCCL ranks across cards: graphed "
                             f"differs from eager or between ranks: {line}")
    return line


def _ring_problem(dev):
    """Phase 12's ring problem, as ``ring_phase`` builds it."""
    from visual_odom_tpu_torch.ba import problem

    return problem.synthetic_ba_problem(
        num_poses=RING_POSES, num_landmarks=RING_LANDMARKS, pixel_noise=0.2,
        pose_perturb=0.015, landmark_perturb=0.08, seed=3,
        obs_window=RING_OBS_WINDOW, device=dev)[0]


def _spawn_ranks(mode, world, root):
    """Start ``world`` ranks on a free port, each this script in ``mode``
    ("gloo" or "nccl": ``rank_main``; "send-probe": ``send_probe_main``);
    their output goes to ``root``."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(world):
        argv = (["--gloo-send-probe", str(port), str(r)]
                if mode == "send-probe" else
                ["--rank", mode, str(world), str(r), str(port), root])
        log = open(os.path.join(root, f"rank-{mode}-{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *argv],
            stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def _wait_ranks(procs, deadline) -> list:
    """Wait for every rank until ``deadline`` (time.monotonic()); kill
    every one still running then. Returns the failed or timed-out ranks'
    arguments, exit codes and logs."""
    try:
        for p, _ in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return [(p.args[3:6], p.returncode, open(log.name).read()[-3000:])
            for p, log in procs if p.returncode]


def ranks_phase(lposes, lframes, loop_read, loop_launches, courses,
                mesh_refs, config, intr, dev, root):
    """Phase 13: the multi-device paths across processes, one rank per
    mesh position, on this card. GLOO_RANKS ranks over gloo and one rank
    over NCCL (world size 1) run at once, each with RANK_TIMEOUT s; the
    phase kills them all and fails on any failure. Each rank runs
    ``sharded_ba_solve`` (SHARDED_BA_PROBLEMS[0]), ``ring_ba_solve``
    (phase 12's problem), ``close_loops(mesh=)`` on phase 7's chain and
    the loop frames phase 12 read, and phase 4's batched courses for
    MESH_STEPS steps on RANK_MESHES on both LK routes. Every result is
    held bit for bit to its one-process counterpart on the same mesh
    shape: phase 12's batched runs, and the solves and the loop closure
    on this card named once per rank, computed here while the ranks run;
    each rank's launches per path (a loop closure makes phase 12's quad
    launches; a batched step its route's launches, each of its slice),
    and on NCCL every chunk under sync debug mode "error". Returns the
    ranks' launches by path, summed over ranks."""
    from visual_odom_tpu_torch.ba import problem
    from visual_odom_tpu_torch.io.synthetic import SyntheticStereoSequence
    from visual_odom_tpu_torch.parallel.mesh import make_mesh
    from visual_odom_tpu_torch.parallel.ring_ba import ring_ba_solve
    from visual_odom_tpu_torch.parallel.sharded_ba import sharded_ba_solve
    from visual_odom_tpu_torch.runner import loopclosure

    lgt_pair = (0, SyntheticStereoSequence._loop_schedule(len(lframes))[2])
    _rank_inputs(root, lposes, lgt_pair, lframes, loop_read, courses)
    t0 = time.monotonic()
    sets = {"gloo": _spawn_ranks("gloo", GLOO_RANKS, root),
            "nccl": _spawn_ranks("nccl", 1, root)}
    probe = _spawn_ranks("send-probe", 2, root)
    deadline = t0 + RANK_TIMEOUT
    try:
        refs = {}
        for world in (GLOO_RANKS, 1):
            devs = [dev] * world
            p = problem.synthetic_ba_problem(
                num_poses=SHARDED_BA_PROBLEMS[0][0],
                num_landmarks=SHARDED_BA_PROBLEMS[0][1], seed=7,
                device=dev)[0]
            got = sharded_ba_solve(p, make_mesh({"data": 1, "model": world},
                                                devs),
                                   iterations=SHARDED_BA_ITERS)
            ring = ring_ba_solve(_ring_problem(dev), make_mesh(
                {"seq": world}, devs), halo=RING_HALO, rounds=RING_ROUNDS,
                cg_iters=RING_CG_ITERS)
            loop_poses, _ = loopclosure.close_loops(
                lposes, lambda i: lframes[i], config, intr,
                gt_loop_pair=lgt_pair, mesh=make_mesh({"model": world},
                                                      devs), device=dev)
            refs[world] = {"sharded_ba_poses": got.poses.cpu().numpy(),
                           "sharded_ba_landmarks":
                               got.landmarks.cpu().numpy(),
                           "ring_poses": ring.poses.cpu().numpy(),
                           "loop_poses": loop_poses}
    finally:
        bad = [b for procs in sets.values()
               for b in _wait_ranks(procs, deadline)]
        # the send probe may end its processes: recorded, not a failure
        probed = _wait_ranks(probe, t0 + SEND_PROBE_TIMEOUT)
        if bad:
            raise AssertionError(f"phase 13 ranks failed or timed out: "
                                 f"{bad}")
    wall = time.monotonic() - t0
    logs = [open(log.name).read() for _, log in probe]
    send = ("takes CUDA tensors" if not probed
            and all("sent" in t for t in logs) else
            "refused CUDA tensors: " + "; ".join(
                f"exit {p.returncode}: "
                f"{(t.strip().splitlines() or [''])[-1][:160]}"
                for (p, _), t in zip(probe, logs)))
    print("ranks", json.dumps({"part": "gloo_cuda_send_recv",
                               "batch_isend_irecv": send}))
    launches = {"rank_loop_edges": 0, "rank_batch_mesh_quad": 0,
                "rank_batch_mesh_level": 0}
    failed = []
    for backend, world in (("gloo", GLOO_RANKS), ("nccl", 1)):
        for r in range(world):
            with open(os.path.join(root, f"rank-{backend}-{r}.json")) as f:
                res = json.load(f)
            arr = np.load(os.path.join(root, f"rank-{backend}-{r}.npz"))
            eq = {k: bool(np.array_equal(arr[k], refs[world][k]))
                  for k in refs[world]}
            launches["rank_loop_edges"] += res["loop_counts"]["quad"]
            for key, run in res["batch"].items():
                rows, cols = (int(v) for v in key.split("_")[0].split("x"))
                route = key.split("_", 1)[1]
                want = mesh_refs[route][rows]
                eq[f"batch_{key}"] = bool(all(np.array_equal(a, b) for a, b in
                                              zip(arr[f"batch_{key}"], want)))
                counts = run["counts"]
                launches["rank_batch_mesh_quad"] += counts["quad_batched"]
                launches["rank_batch_mesh_level"] += counts["level_batched"]
                per = (LAUNCHES_PER_FRAME if route == "pallas"
                       else LEVEL_LAUNCHES_PER_FRAME) * MESH_STEPS
                kernel = ("quad_batched" if route == "pallas"
                          else "level_batched")
                eq[f"launches_{key}"] = counts == dict(
                    dict.fromkeys(counts, 0), **pnp_steps(MESH_STEPS),
                    **{kernel: per})
                tally_pnp(counts)
                if backend == "nccl":
                    eq[f"no_host_sync_{key}"] = (
                        run["chunks_without_host_sync"]
                        == MESH_STEPS // MESH_CHUNK)
            # a loop measurement is one step, one quad launch
            eq["loop_launches"] = res["loop_counts"] == dict(
                dict.fromkeys(res["loop_counts"], 0),
                **pnp_steps(loop_launches), quad=loop_launches)
            tally_pnp(res["loop_counts"])
            eq["ppermute_ring"] = res["ppermute_ring_ok"]
            line = dict(backend=res["backend"], world=world, rank=r,
                        device=str(dev), bit_for_bit=eq,
                        **{k: v for k, v in res.items()
                           if k not in ("backend", "world", "rank")})
            print("ranks", json.dumps(line))
            if not all(eq.values()):
                failed.append((backend, r, eq))
    print("ranks", json.dumps({"part": "phase", "wall_s": wall,
                               "launches_summed_over_ranks": launches}))
    if failed:
        raise AssertionError(f"phase 13: results differ from one process: "
                             f"{failed}")
    return launches


@contextlib.contextmanager
def environment(**values):
    """``os.environ`` with ``values`` set inside the block (and so in the
    processes started there), restored after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def bench_phase(courses, root):
    """Phase 14: the port's ``vo bench --quick`` in a subprocess on this
    card, over a course cache in ``root`` that holds phase 4's straight,
    turning and stress courses (the quick gauntlet's 65 frames) under the
    bench's keys; then the bench's ``main`` once more in this
    process on ``straight`` alone with the launch counts on: 3 quads per
    scanned frame (the warm-up chunk and the timed run), ``bench_lk``'s
    quads, and its one-leg parity check's level launches. Returns the
    launches of the in-process run."""
    from visual_odom_tpu_torch import bench
    from visual_odom_tpu_torch.ops.lk import LKParams

    cache = os.path.join(root, "course_cache")
    with environment(VO_COURSE_CACHE=cache):
        for name in BENCH_QUICK_COURSES:
            frames, gt = courses[(name, "value")]
            if len(frames) != BENCH_QUICK_FRAMES:
                raise AssertionError(f"phase 14: {name} has {len(frames)} "
                                     f"frames, the quick bench {BENCH_QUICK_FRAMES}")
            path = bench.course_cache_path(name, BENCH_QUICK_FRAMES, H, W)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.savez(path, lefts=np.stack([f[0] for f in frames]),
                     rights=np.stack([f[1] for f in frames]), poses=gt)

        t = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "visual_odom_tpu_torch.runner.cli",
             "bench", "--quick"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=BENCH_TIMEOUT)
        sub_wall = time.perf_counter() - t
        for ln in r.stderr.splitlines():
            if ln.startswith("[bench]"):
                print(ln)
        if r.returncode != 0:
            raise AssertionError(f"phase 14: vo bench --quick exited "
                                 f"{r.returncode}:\n{r.stderr[-4000:]}")
        line = json.loads(r.stdout.strip().splitlines()[-1])
        print("bench", json.dumps(line))
        if not (line["accuracy_ok"] is True and line["value"] > 0
                and tuple(line["courses"]) == BENCH_QUICK_COURSES):
            raise AssertionError(f"phase 14: vo bench --quick: {line}")

        t = time.perf_counter()
        reset_counts()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = bench.main(["--quick", "--courses", "straight"])
        counts = read_counts()
        in_wall = time.perf_counter() - t
    own = json.loads(out.getvalue().strip().splitlines()[-1])
    steps = BENCH_QUICK_FRAMES - 1
    scanned = steps + min(BENCH_CHUNK, steps)
    tally_pnp(counts)
    expected = dict(dict.fromkeys(counts, 0), **pnp_steps(scanned),
                    quad=LAUNCHES_PER_FRAME * scanned + BENCH_LK_QUADS,
                    level=LKParams().levels + 1)
    print("bench_in_process", json.dumps(dict(
        rc=rc, value=own["value"], accuracy_ok=own["accuracy_ok"],
        lk_survivors=own["lk_survivors"],
        lk_circular_matches_per_s=own["lk_circular_matches_per_s"],
        scanned_frames=scanned, launch_counts=counts,
        expected_launch_counts=expected, subprocess_wall_s=sub_wall,
        in_process_wall_s=in_wall)))
    if not (rc == 0 and own["accuracy_ok"] is True and counts == expected):
        raise AssertionError(f"phase 14: the bench in process: rc {rc}, "
                             f"{own}, launches {counts} != {expected}")
    return counts


def _bits(a, b) -> bool:
    """Two arrays equal bit for bit: dtype, shape and bytes."""
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def scan_course(frames, config, intr, dev, graph, with_tracks=False):
    """The scan family's chunk step, ``make_scan_step_fn(_graph=graph)``,
    over ``frames``: (H, W) pairs, or (B, H, W) stacks for B sequences
    (generators seeded 0..B-1), CHUNK frames a call from chunks uploaded
    before the loop. Returns (the outputs fetched and concatenated, the
    final state's arrays with its generators' state, the launch counts,
    the wall)."""
    import torch

    from visual_odom_tpu_torch.parallel import batch
    from visual_odom_tpu_torch.runner import pipeline

    if frames[0][0].ndim == 3:
        state = batch.batched_init_state(config, *frames[0], device=dev)
    else:
        state = pipeline.init_vo_state(config, intr, *frames[0], device=dev)
    scan = pipeline.make_scan_step_fn(config, intr, with_tracks=with_tracks,
                                      device=dev, _graph=graph)
    chunks = [tuple(torch.from_numpy(np.stack([f[k] for f in
                                               frames[i:i + CHUNK]])).to(dev)
                    for k in (0, 1))
              for i in range(1, len(frames), CHUNK)]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    outs = []
    for lefts, rights in chunks:
        state, *out = scan(state, lefts, rights)
        outs.append(out)
    fetched = pipeline._concat(pipeline._fetch_chunks(outs))
    wall = time.perf_counter() - t0
    return fetched, pipeline.state_arrays(state), read_counts(), wall


def _chains(out):
    """Each sequence's float64 pose chain of a fetched StepOutput stack."""
    from visual_odom_tpu_torch.runner.pipeline import chain_poses_host

    if out.T_inv.ndim == 3:
        return [chain_poses_host(out.T_inv, out.accept)]
    return [chain_poses_host(out.T_inv[:, b], out.accept[:, b])
            for b in range(out.T_inv.shape[1])]


def graph_vs_eager(case, frames, config, intr, dev, with_tracks=False,
                   scan_ref=None):
    """Phase 15 ``graph``: the scan family's step replayed from its CUDA
    graph against the eager step (``_graph=False``) on ``frames``, bit for
    bit: every output field (and track snapshot field), each sequence's
    poses, the final state's arrays and its generators' state; each run
    with the route's launches per step. ``scan_ref`` (poses, fetched
    outputs of phase 4's ``run_sequence_scan`` of the course, graphed by
    default) is held to the eager run too. Returns the line."""
    batched = frames[0][0].ndim == 3
    steps = len(frames) - 1
    (ef, es, ec, ew), (gf, gs, gc, gw) = (
        scan_course(frames, config, intr, dev, g, with_tracks)
        for g in (False, True))
    eq = {"outputs": all(_bits(x, y) for a, b in zip(ef, gf)
                         for x, y in zip(a, b)),
          "poses": all(_bits(a, b) for a, b in zip(_chains(ef[0]),
                                                   _chains(gf[0]))),
          "state": all(_bits(es[k], gs[k]) for k in es if k != "gen_state"),
          "generator_state": _bits(es["gen_state"], gs["gen_state"])}
    if scan_ref is not None:
        eq["run_sequence_scan"] = (_bits(scan_ref[0], _chains(ef[0])[0])
                                   and all(_bits(x, y) for x, y in
                                           zip(scan_ref[1], ef[0])))
    res = dict(case=case, route=config.resolved_lk_backend(),
               batch=frames[0][0].shape[0] if batched else 1, steps=steps,
               chunk=CHUNK, tracks=with_tracks, bit_exact=eq,
               wall_eager_s=ew, wall_graph_s=gw, launch_counts_eager=ec,
               launch_counts_graph=gc)
    print("graph", json.dumps(res))
    for label, counts in (("eager", ec), ("graph", gc)):
        check_counts(f"graph {case} ({label})", config, counts, steps,
                     batched, tally=label == "graph")
    if not all(eq.values()):
        raise AssertionError(f"graph {case}: graphed and eager differ: {eq}")
    return res


def graph_resume(frames, config, intr, dev):
    """Phase 15 ``graph_resume``: ``run_sequence_scan_resumable`` replayed
    from the graph, failed at frame RESUME_CRASH_AT and resumed from its
    last snapshot, against the eager uninterrupted run (``scans(False)``),
    with track snapshots: poses, outputs, track snapshots and the two runs'
    last snapshots (the generators' state among their arrays) bit for
    bit."""
    from visual_odom_tpu_torch.runner import pipeline
    from visual_odom_tpu_torch.utils.checkpoint import load_scan_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(checkpoint_every=RESUME_EVERY, chunk=RESUME_CHUNK,
                  warmup=False, collect_tracks=True, device=dev)
        eager_ck, crash_ck = (os.path.join(tmp, f"{k}.npz")
                              for k in ("eager", "crash"))
        with scans(False):
            eager = pipeline.run_sequence_scan_resumable(
                RandomAccess(frames), config, intr, eager_ck, **kw)
        try:
            pipeline.run_sequence_scan_resumable(
                RandomAccess(frames, RESUME_CRASH_AT), config, intr,
                crash_ck, **kw)
            raise AssertionError("graph_resume: the injected failure did "
                                 "not surface")
        except RuntimeError as e:
            if "injected" not in str(e):
                raise
        at = int(load_scan_checkpoint(crash_ck)["frames_done"])
        resumed = pipeline.run_sequence_scan_resumable(
            RandomAccess(frames), config, intr, crash_ck, **kw)
        snaps = [load_scan_checkpoint(p) for p in (eager_ck, crash_ck)]
    eq = {"poses": _bits(resumed[0], eager[0]),
          "outputs": all(_bits(x, y) for x, y in zip(resumed[1], eager[1])),
          "tracks": len(resumed[4]) == len(eager[4]) and all(
              _bits(x, y) for a, b in zip(resumed[4], eager[4])
              for x, y in zip(a, b)),
          "last_snapshot": (sorted(snaps[0]) == sorted(snaps[1])
                            and all(_bits(snaps[0][k], snaps[1][k])
                                    for k in snaps[0]))}
    res = dict(steps=eager[3], chunk=RESUME_CHUNK,
               checkpoint_every=RESUME_EVERY, crash_at=RESUME_CRASH_AT,
               snapshot_at=at, resumed_steps=resumed[3],
               last_snapshot_step=int(snaps[1]["frames_done"]), bit_exact=eq)
    print("graph_resume", json.dumps(res))
    if not (all(eq.values()) and at == RESUME_EVERY):
        raise AssertionError(f"graph_resume: not bit for bit: {res}")
    return res


def graph_sync(frames, config, intr, dev):
    """Phase 15: one replay of the graphed step (``GraphedStep.__call__``,
    the eager step's contract) under CUDA sync debug mode "error"; its
    graph is captured first, outside it."""
    import torch

    from visual_odom_tpu_torch.runner import pipeline

    graphed = pipeline._graphed_step(config, intr, False, dev)
    state = pipeline.init_vo_state(config, intr, *frames[0], device=dev)
    up = [tuple(torch.from_numpy(x).to(dev) for x in f) for f in frames[1:3]]
    state, _ = graphed(state, *up[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, out = graphed(state, *up[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out.T_inv).all()):
        raise AssertionError("graph_sync: the replayed step's T_inv is not "
                             "finite")


def graph_turns(frames, config, intr, dev, rounds):
    """Phase 15: ms a frame of ``run_sequence_scan`` (chunk CHUNK, one
    upload thread, no warm-up) replayed from the graph and stepped eagerly,
    in turns (graph, eager, eager, graph, ...), every run's poses bit for
    bit the first's. Returns ({"graph": [ms...], "eager": [ms...]}, poses
    of the first run)."""
    from visual_odom_tpu_torch.runner import pipeline

    ms = {"graph": [], "eager": []}
    ref = None
    for k in range(rounds):
        for v in (("graph", "eager") if k % 2 == 0 else ("eager", "graph")):
            with scans(v == "graph"):
                poses, _, wall, n = pipeline.run_sequence_scan(
                    frames, config, intr, chunk=CHUNK, warmup=False,
                    device=dev)
            ms[v].append(1e3 * wall / n)
            if ref is None:
                ref = poses
            elif not _bits(poses, ref):
                raise AssertionError(f"graph_turns: a {v} run's poses "
                                     f"differ from the first run's")
    return ms, ref


def graph_phase(frames, courses, ref, xref, config, xconfig, intr, dev,
                profiles, sweep):
    """Phase 15: the scan family's step as one CUDA graph (``graph``
    lines). Graphed against eager bit for bit on GRAPH_STEPS steps of
    "straight" on both LK routes, the batched courses (B = BATCH), the
    straight course with track snapshots, mono rotation on GRAPH_MONO_STEPS
    steps; the resumable scan crashed and resumed against the eager
    uninterrupted run; one replay under sync debug "error"; ms a frame in
    GRAPH_ROUNDS paired rounds on both routes and mono; the captures made
    (seconds each, launches per replay, replays); the device ms and busy
    share (phase 6's profiles of replays over the paired rounds' graphed
    ms) and the sweep's graphed and eager aggregate frames/s. Returns the
    graphed runs' launch counts, summed."""
    from visual_odom_tpu_torch.config import VOConfig
    from visual_odom_tpu_torch.runner import pipeline

    mconfig = VOConfig.for_image(H, W, mono_rotation=True)
    bframes = stacked_frames([courses[k][0] for k in BATCH_COURSES],
                             GRAPH_STEPS + 1)
    cases = [("straight", frames[:GRAPH_STEPS + 1], config, False, ref),
             ("straight_xla", frames[:GRAPH_STEPS + 1], xconfig, False,
              xref),
             (f"batched_b{BATCH}", bframes, config, False, None),
             ("straight_tracks", frames[:GRAPH_STEPS + 1], config, True,
              None),
             ("straight_mono", frames[:GRAPH_MONO_STEPS + 1], mconfig, False,
              None)]
    launches = dict.fromkeys(read_counts(), 0)
    for case, fr, cfg, tracks, scan_ref in cases:
        res = graph_vs_eager(case, fr, cfg, intr, dev, tracks, scan_ref)
        for k, n in res["launch_counts_graph"].items():
            launches[k] += n
    graph_resume(frames, config, intr, dev)
    graph_sync(frames, config, intr, dev)
    for name, cfg, n in (("quad", config, GRAPH_STEPS),
                         ("xla", xconfig, GRAPH_STEPS),
                         ("mono", mconfig, GRAPH_MONO_STEPS)):
        ms, _ = graph_turns(frames[:n + 1], cfg, intr, dev, GRAPH_ROUNDS)
        prof = profiles.get(name)
        graph_ms = float(np.median(ms["graph"]))
        print("graph_turns", json.dumps(dict(
            route=name, steps=n, rounds=GRAPH_ROUNDS, ms_graph=ms["graph"],
            ms_eager=ms["eager"], median_ms_graph=graph_ms,
            median_ms_eager=float(np.median(ms["eager"])),
            rounds_graph_faster=sum(g < e for g, e in zip(ms["graph"],
                                                          ms["eager"])),
            **({"device_ms_per_frame": prof["device_ms_per_frame"],
                "device_busy_share": prof["device_ms_per_frame"] / graph_ms,
                "host_runtime_calls_per_frame":
                    prof["host_runtime_calls_per_frame"]}
               if prof else {}))))
    print("graph_sweep", json.dumps([{k: r[k] for k in (
        "batch", "aggregate_fps", "eager_aggregate_fps", "ms_per_step",
        "eager_ms_per_step", "device_ms_per_step", "device_busy_share")}
        for r in sweep]))
    captures = []
    for name, cfg, tracks in (("default", config, False),
                              ("default_tracks", config, True),
                              ("xla", xconfig, False),
                              ("mono", mconfig, False)):
        for key, cap in pipeline._graphed_step(cfg, intr, tracks,
                                               dev).captures.items():
            captures.append(dict(config=name, frames=list(key[2]),
                                 seconds=cap.seconds,
                                 per_replay=cap.per_replay,
                                 replays=_replays_of(cap)))
    print("graph_captures", json.dumps(captures))
    return launches


def _count_replays():
    """The replays each capture made, by capture: the captures keep no
    count, so the ``replay`` of each of ``utils.cudagraph``'s capture forms
    is wrapped to count them, once in a process (``run_phases`` does it
    before any capture)."""
    import weakref

    from visual_odom_tpu_torch.utils import cudagraph

    if hasattr(cudagraph._Capture.replay, "counts"):
        return cudagraph._Capture.replay.counts
    counts = weakref.WeakKeyDictionary()
    for cls in (cudagraph._Capture, cudagraph._BodyCapture):
        def counted(self, _replay=cls.__dict__["replay"]):
            counts[self] = counts.get(self, 0) + 1
            return _replay(self)
        counted.counts = counts
        cls.replay = counted
    return counts


def _replays(*graphed) -> int:
    """The replays made so far by every capture of these ``GraphedStep``s
    and ``GraphedLoop``s."""
    counts = _count_replays()
    return sum(counts.get(c, 0) for g in graphed for c in g.captures.values())


def _replays_of(capture) -> int:
    return _count_replays().get(capture, 0)


def door_turns(label, run, graphed_objs, rounds, per_replay=1):
    """``run() -> (result, wall_s, steps)`` in turns, graphed (inside
    ``utils.cudagraph.dispatch(True)``) and eager (``dispatch(False)``), in
    ``rounds`` pairs (graph eager, eager graph, ...). Each run's launch
    counts are read (the counts set to 0 just before it); every graphed
    run must replay ``graphed_objs``' captures ``per_replay`` times a
    step, every eager run none. Returns ({"graph": [ms a step...],
    "eager": [...]}, {mode: (first result, its counts)})."""
    from visual_odom_tpu_torch.utils.cudagraph import dispatch

    ms = {"graph": [], "eager": []}
    first = {}
    for k in range(rounds):
        for mode in (("graph", "eager") if k % 2 == 0 else ("eager", "graph")):
            before = _replays(*graphed_objs)
            with dispatch(mode == "graph"):
                reset_counts()
                res, wall, steps = run()
                counts = read_counts()
            replays = _replays(*graphed_objs) - before
            want = per_replay * steps if mode == "graph" else 0
            if replays != want:
                raise AssertionError(f"doors_graph {label}: a {mode} run "
                                     f"made {replays} replays, expected "
                                     f"{want}")
            ms[mode].append(1e3 * wall / steps)
            first.setdefault(mode, (res, counts))
    return ms, first


def _door_line(part, ms, first, eq, **extra):
    """Print a ``doors_graph`` line (ms a step both ways, medians, rounds
    the graph won, launch counts both ways, the bit-for-bit checks) and
    raise if a check failed or the launches differ."""
    res = dict(part=part, ms_graph=ms["graph"], ms_eager=ms["eager"],
               median_ms_graph=float(np.median(ms["graph"])),
               median_ms_eager=float(np.median(ms["eager"])),
               rounds_graph_faster=sum(g < e for g, e in zip(ms["graph"],
                                                             ms["eager"])),
               launch_counts_graph=first["graph"][1],
               launch_counts_eager=first["eager"][1], bit_exact=eq, **extra)
    print("doors_graph", json.dumps(res))
    if not all(eq.values()):
        raise AssertionError(f"doors_graph {part}: graphed and eager "
                             f"differ: {eq}")
    if first["graph"][1] != first["eager"][1]:
        raise AssertionError(f"doors_graph {part}: launches differ: {res}")
    return res


def doors_graph_phase(frames, courses, lframes, lposes, lsnaps, config, intr,
                      dev):
    """Phase 16: the per-frame doors, the stepwise batched runner, the pipe
    and the back end's solves replayed from CUDA graphs (the default on a
    card) against their eager runs (``utils.cudagraph.dispatch(False)``),
    bit for bit, with ms a step (or a solve) both ways (``doors_graph``
    lines). Returns the graphed runs' launch counts, summed."""
    import torch

    from visual_odom_tpu_torch.ba import posegraph, schur, window
    from visual_odom_tpu_torch.io.synthetic import SyntheticStereoSequence
    from visual_odom_tpu_torch.parallel import pipe
    from visual_odom_tpu_torch.parallel.batch_eval import run_sequences_batched
    from visual_odom_tpu_torch.runner import loopclosure, pipeline
    from visual_odom_tpu_torch.utils.cudagraph import dispatch

    n = DOOR_GRAPH_STEPS
    fr = frames[:n + 1]
    launches = dict.fromkeys(read_counts(), 0)

    def add(counts):
        tally_pnp(counts)
        for k, v in counts.items():
            launches[k] += v

    # (a) VisualOdometry with track snapshots: every FrameResult field but
    # the frame's time, every snapshot, the final state's arrays and its
    # generator's state
    def vo_run():
        vo = pipeline.VisualOdometry(config, intr, with_tracks=True,
                                     device=dev)
        vo.initialize(*fr[0])
        results, snaps = [], []
        t = time.perf_counter()
        for left, right in fr[1:]:
            results.append(vo.process_frame(left, right))
            snaps.append(vo.last_tracks)
        wall = time.perf_counter() - t
        return (results, snaps, pipeline.state_arrays(vo.state)), wall, n

    g_tracks = pipeline._graphed_step(config, intr, True, dev)
    ms, first = door_turns("VisualOdometry", vo_run, [g_tracks],
                           DOOR_GRAPH_ROUNDS)
    (gr, gs, gst), (er, es, est) = first["graph"][0], first["eager"][0]
    eq = {"results": all(_bits(np.asarray(a[k]), np.asarray(b[k]))
                         for a, b in zip(gr, er)
                         for k in range(1, len(a) - 1)),
          "poses": all(_bits(a.pose, b.pose) for a, b in zip(gr, er)),
          "tracks": all(_bits(x, y) for a, b in zip(gs, es)
                        for x, y in zip(a, b)),
          "state": all(_bits(gst[k], est[k]) for k in est
                       if k != "gen_state"),
          "generator_state": _bits(gst["gen_state"], est["gen_state"])}
    add(first["graph"][1])
    _door_line("VisualOdometry", ms, first, eq, steps=n, tracks=True)

    # (b) the buffered step, every frame on the card first
    g_plain = pipeline._graphed_step(config, intr, False, dev)

    def buffered_run():
        poses, bufs, wall = pipeline.run_sequence_buffered(
            fr, config, intr, preupload=True, device=dev)
        return (poses, bufs), wall, n

    ms, first = door_turns("buffered", buffered_run, [g_plain],
                           DOOR_GRAPH_ROUNDS)
    (gp, gb), (ep, eb) = first["graph"][0], first["eager"][0]
    eq = {"poses": _bits(gp, ep),
          "buffers": all(_bits(x, y) for x, y in zip(gb, eb))}
    add(first["graph"][1])
    _door_line("run_sequence_buffered", ms, first, eq, steps=n)

    # (c) the stepwise batched runner, B = BATCH
    seqs = [courses[k][0][:n + 1] for k in BATCH_COURSES]

    def batched_run():
        poses, stats, wall = run_sequences_batched(seqs, config, intr,
                                                   chunk=0, device=dev)
        return (poses, stats), wall, n

    ms, first = door_turns("stepwise_batched", batched_run, [g_plain],
                           DOOR_GRAPH_ROUNDS)
    (gp, gs_), (ep, es_) = first["graph"][0], first["eager"][0]
    eq = {"poses": all(_bits(a, b) for a, b in zip(gp, ep)),
          "stats": gs_ == es_}
    add(first["graph"][1])
    _door_line("run_sequences_batched_chunk0", ms, first, eq, steps=n,
               batch=BATCH)

    # (d) the pipe, both stages on this card
    stages = pipe._graphed_stages(config, intr, dev, dev)

    def pipe_run():
        poses, out, wall = pipe.run_sequence_pipelined(fr, config, intr,
                                                       devices=[dev, dev])
        return (poses, out), wall, n

    ms, first = door_turns("pipe", pipe_run, stages, DOOR_GRAPH_ROUNDS,
                           per_replay=2)
    (gp, go), (ep, eo) = first["graph"][0], first["eager"][0]
    eq = {"poses": _bits(gp, ep),
          "outputs": all(_bits(x, y) for x, y in zip(go, eo))}
    add(first["graph"][1])
    _door_line("pipe", ms, first, eq, steps=n)

    # (e) the command line's unchunked run (VisualOdometry), pose files
    # byte for byte
    with tempfile.TemporaryDirectory() as tmp:
        calib = os.path.join(tmp, "calib.yaml")
        write_calibration(calib, intr)
        files, walls = {}, {}
        for mode in ("graph", "eager"):
            out = os.path.join(tmp, f"{mode}.txt")
            with dispatch(mode == "graph"):
                rc, stdout, stderr, sec = run_cli([
                    "run", "synthetic", calib, "--max-frames",
                    CLI_GRAPH_FRAMES, "--output", out, "--quiet"])
            if rc != 0:
                raise AssertionError(f"doors_graph cli ({mode}): rc {rc}: "
                                     f"{stderr[-2000:]}")
            files[mode], walls[mode] = read_bytes(out), sec
    res = dict(part="cli_run_unchunked", frames=CLI_GRAPH_FRAMES,
               command_s_graph=walls["graph"], command_s_eager=walls["eager"],
               bit_exact={"poses_file": files["graph"] == files["eager"]})
    print("doors_graph", json.dumps(res))
    if not all(res["bit_exact"].values()):
        raise AssertionError(f"doors_graph cli: {res}")

    # (f) windowed BA on phase 7's loop course (the CLI's short-course
    # settings): the smoothed trajectory both ways, and a solve of the
    # first window timed both ways (ms per GN iteration)
    kw = BA_SHORT
    smoothed, walls = {}, {}
    for mode in ("graph", "eager"):
        with dispatch(mode == "graph"):
            torch.cuda.synchronize()
            t = time.perf_counter()
            smoothed[mode] = window.smooth_trajectory_ba(
                lsnaps, lposes, intr, window=kw["window"],
                iterations=kw["iterations"],
                max_landmarks=kw["max_landmarks"],
                min_track_len=kw["min_track_len"],
                huber_delta=kw["huber_delta"], device=dev)
            walls[mode] = time.perf_counter() - t
    problem = window.build_window_problem(
        window.window_tracks(lsnaps, range(kw["window"])),
        lposes[:kw["window"]], intr, max_landmarks=kw["max_landmarks"],
        min_track_len=kw["min_track_len"], device=dev)
    iter_ms = {}
    for mode in ("graph", "eager"):
        with dispatch(mode == "graph"):
            iter_ms[mode] = time_ms(lambda: schur.ba_solve(
                problem, iterations=kw["iterations"],
                huber_delta=kw["huber_delta"]), reps=SOLVE_REPS,
                warm=1) / kw["iterations"]
    solved = {}
    for mode in ("graph", "eager"):
        with dispatch(mode == "graph"):
            solved[mode] = schur.ba_solve(problem,
                                          iterations=kw["iterations"],
                                          huber_delta=kw["huber_delta"])
    ba_loop = schur._graphed_solve(1e-4, float(kw["huber_delta"]), dev)
    res = dict(part="ba", course="loop", **kw, windows=len(lposes)
               // kw["window"], smooth_s_graph=walls["graph"],
               smooth_s_eager=walls["eager"],
               landmarks=int(problem.mask.shape[1]),
               gn_iteration_ms_graph=iter_ms["graph"],
               gn_iteration_ms_eager=iter_ms["eager"],
               captures=[dict(shape=[list(s) for s, _ in key[0][0]][:2],
                              seconds=c.seconds, replays=_replays_of(c))
                         for key, c in ba_loop.captures.items()],
               bit_exact={
                   "smoothed": _bits(smoothed["graph"], smoothed["eager"]),
                   "solve": all(_bits(getattr(solved["graph"], k).cpu(),
                                      getattr(solved["eager"], k).cpu())
                                for k in ("poses", "landmarks"))})
    print("doors_graph", json.dumps(res))
    if not all(res["bit_exact"].values()):
        raise AssertionError(f"doors_graph ba: {res}")

    # (g) loop closure on the loop course: the loop edges measured by the
    # edge step's graph, the keyframe pose graph solved by its loop
    lf = SyntheticStereoSequence._loop_schedule(len(lframes))[2]
    closed, walls, counts = {}, {}, {}
    for mode in ("graph", "eager"):
        with dispatch(mode == "graph"):
            reset_counts()
            t = time.perf_counter()
            closed[mode] = loopclosure.close_loops(
                lposes, lambda i: lframes[i], config, intr,
                gt_loop_pair=(0, lf), device=dev)
            walls[mode] = time.perf_counter() - t
            counts[mode] = read_counts()
    (gp, ginfo), (ep, einfo) = closed["graph"], closed["eager"]
    graph = ginfo.graph
    pg_ms, nodes = {}, {}
    for mode in ("graph", "eager"):
        with dispatch(mode == "graph"):
            pg_ms[mode] = time_ms(lambda: posegraph.posegraph_solve(graph),
                                  reps=SOLVE_REPS, warm=1)
            nodes[mode] = posegraph.posegraph_solve(graph).nodes.cpu()
    add(counts["graph"])
    res = dict(part="loop_closure", course="loop", edges=ginfo.edges,
               closure_before_m=ginfo.closure_before_m,
               closure_after_m=ginfo.closure_after_m,
               close_loops_s_graph=walls["graph"],
               close_loops_s_eager=walls["eager"],
               posegraph_nodes=int(graph.nodes.shape[0]) if graph is not None
               else 0, posegraph_solve_ms_graph=pg_ms["graph"],
               posegraph_solve_ms_eager=pg_ms["eager"],
               launch_counts_graph=counts["graph"],
               launch_counts_eager=counts["eager"],
               bit_exact={"poses": _bits(gp, ep),
                          "edges": ginfo.edges == einfo.edges,
                          "candidates": ginfo.candidates == einfo.candidates,
                          "posegraph_nodes": _bits(nodes["graph"],
                                                   nodes["eager"])})
    print("doors_graph", json.dumps(res))
    if not (all(res["bit_exact"].values()) and ginfo.edges
            and counts["graph"] == counts["eager"]):
        raise AssertionError(f"doors_graph loop closure: {res}")
    return launches


def _state_bits(a, b) -> bool:
    """Two states (a ``MeshState``, a batched ``VOState``) hold the same
    tensors and their generators the same state, bit for bit."""
    from visual_odom_tpu_torch.utils.cudagraph import generators, state_tensors

    rows = [(x.rows if hasattr(x, "rows") else (x,)) for x in (a, b)]
    ta = [t for r in rows[0] for t in state_tensors(r)]
    tb = [t for r in rows[1] for t in state_tensors(r)]
    ga = [g.get_state() for r in rows[0] for g in generators(r)]
    gb = [g.get_state() for r in rows[1] for g in generators(r)]
    return (len(ta) == len(tb) and all(_bits(x.cpu(), y.cpu())
                                       for x, y in zip(ta, tb))
            and len(ga) == len(gb) and all(_bits(x, y)
                                           for x, y in zip(ga, gb)))


def _out_bits(a, b) -> bool:
    return all(_bits(x.cpu(), y.cpu()) for x, y in zip(a, b))


def _mesh_chunk(seqs, n, dev):
    """(first lefts, first rights) as numpy, and the n frames after them
    stacked (n, B, H, W) on the card."""
    import torch

    first = [np.stack([s[0][k] for s in seqs]) for k in (0, 1)]
    chunk = [torch.from_numpy(np.stack([np.stack([s[i][k] for s in seqs])
                                        for i in range(1, n + 1)])).to(dev)
             for k in (0, 1)]
    return first, chunk


def _mesh_scan_run(cfg, intr, mesh, first, chunk, graphed, strict=False):
    """One chunk through the mesh scan built inside ``dispatch(graphed)``:
    (state, outputs, launch counts, wall s, the scan). ``strict`` steps
    it under sync debug mode "error"."""
    import torch

    from visual_odom_tpu_torch.parallel import batch
    from visual_odom_tpu_torch.utils.cudagraph import dispatch

    with dispatch(graphed):
        scan = batch.make_batched_scan_fn(cfg, intr, chunk[0].shape[0],
                                          mesh=mesh)
        st = batch.batched_init_state(cfg, *first, mesh=mesh)
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        if strict:
            torch.cuda.set_sync_debug_mode("error")
        try:
            st, out = scan(st, *chunk)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = read_counts()
    return st, out, counts, wall, scan


def _paired_ms(run, rounds, per):
    """``run(graphed) -> wall s`` in ``rounds`` pairs (graph eager, eager
    graph, ...): ms per ``per`` (steps, iterations) both ways."""
    ms = {"graph": [], "eager": []}
    for k in range(rounds):
        for mode in (("graph", "eager") if k % 2 == 0 else ("eager", "graph")):
            ms[mode].append(1e3 * run(mode == "graph") / per)
    return ms


def _host_calls_per_step(scan, state, chunk, graphed, steps):
    """The host's CUDA runtime calls a step of ``scan`` (already captured
    where it replays graphs), under torch.profiler."""
    import torch

    from visual_odom_tpu_torch.utils.cudagraph import dispatch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with dispatch(graphed), torch.profiler.profile(activities=acts) as prof:
        scan(state, *chunk)
        torch.cuda.synchronize()
    calls = host_calls(prof, steps)
    return dict(calls, total=sum(calls.values()))


def mesh_graph_phase(courses, lframes, lposes, config, xconfig, intr, dev):
    """Phase 17: the multi-device paths replayed from CUDA graphs against
    their eager runs (``mesh_graph`` lines). Returns the graphed runs'
    launch counts, summed."""
    import torch

    from visual_odom_tpu_torch.io.synthetic import SyntheticStereoSequence
    from visual_odom_tpu_torch.parallel import batch
    from visual_odom_tpu_torch.runner import loopclosure
    from visual_odom_tpu_torch.utils.cudagraph import dispatch

    n = MESH_GRAPH_STEPS
    seqs = [courses[k][0][:n + 1] for k in BATCH_COURSES]
    first, chunk = _mesh_chunk(seqs, n, dev)
    launches = dict.fromkeys(read_counts(), 0)

    def add(counts):
        tally_pnp(counts)
        for k, v in counts.items():
            launches[k] += v

    # (a) the mesh scan on this card named 2 and 4 times, both routes
    for cfg in (config, xconfig):
        route = cfg.resolved_lk_backend()
        for rows, cols in MESH_SHAPES:
            mesh = card_mesh({"data": rows, "model": cols}, dev)
            est, eout, ecounts, _, _ = _mesh_scan_run(cfg, intr, mesh, first,
                                                      chunk, False)
            t = time.perf_counter()
            gst, gout, gcounts, _, gscan = _mesh_scan_run(
                cfg, intr, mesh, first, chunk, True, strict=True)
            capture_s = time.perf_counter() - t
            rounds = MESH_GRAPH_ROUNDS if route == "pallas" else 1
            again = []

            def timed(graphed):
                st, out, _, wall, _ = _mesh_scan_run(cfg, intr, mesh, first,
                                                     chunk, graphed)
                again.append(_out_bits(out, eout) and _state_bits(st, est))
                return wall

            ms = _paired_ms(timed, rounds, n)
            res = dict(part="mesh_scan", route=route, mesh=mesh.shape,
                       steps=n, batch=len(seqs),
                       ms_graph=ms["graph"], ms_eager=ms["eager"],
                       first_graph_run_s=capture_s,
                       graphed_rows=sum(g is not None for g in (
                           batch._row(cfg, intr, tuple(r)).graphed
                           for r in mesh.devices)),
                       launch_counts_graph=gcounts,
                       launch_counts_eager=ecounts,
                       bit_exact={"outputs": _out_bits(gout, eout),
                                  "state": _state_bits(gst, est),
                                  "rounds": all(again)})
            if route == "pallas" and (rows, cols) == (2, 2):
                prof_first, prof_chunk = _mesh_chunk(
                    seqs, MESH_GRAPH_PROFILE_STEPS, dev)
                res["host_calls_per_step"] = {}
                for mode in ("graph", "eager"):
                    with dispatch(mode == "graph"):
                        scan = batch.make_batched_scan_fn(
                            cfg, intr, MESH_GRAPH_PROFILE_STEPS, mesh=mesh)
                        st = batch.batched_init_state(cfg, *prof_first,
                                                      mesh=mesh)
                        scan(st, *prof_chunk)       # captures, if graphed
                    res["host_calls_per_step"][mode] = _host_calls_per_step(
                        scan, st, prof_chunk, mode == "graph",
                        MESH_GRAPH_PROFILE_STEPS)
            print("mesh_graph", json.dumps(res))
            if not (all(res["bit_exact"].values()) and gcounts == ecounts
                    and res["graphed_rows"] == rows):
                raise AssertionError(f"mesh_graph scan {mesh.shape}, "
                                     f"{route}: {res}")
            add(gcounts)

    # (b) the stepwise mesh step, (2, 2), quad route
    mesh = card_mesh({"data": 2, "model": 2}, dev)
    runs = {}
    for graphed in (False, True):
        with dispatch(graphed):
            step = batch.make_batched_step_fn(config, intr, mesh=mesh)
            st = batch.batched_init_state(config, *first, mesh=mesh)
            reset_counts()
            outs = []
            for i in range(MESH_GRAPH_STEPWISE):
                st, out = step(st, chunk[0][i], chunk[1][i])
                outs.append(out)
            torch.cuda.synchronize()
            runs[graphed] = (st, outs, read_counts())
    (est, eouts, ec), (gst, gouts, gc) = runs[False], runs[True]
    res = dict(part="mesh_step", mesh=mesh.shape, steps=MESH_GRAPH_STEPWISE,
               launch_counts_graph=gc, launch_counts_eager=ec,
               bit_exact={"outputs": all(_out_bits(a, b) for a, b in
                                         zip(gouts, eouts)),
                          "state": _state_bits(gst, est)})
    print("mesh_graph", json.dumps(res))
    if not (all(res["bit_exact"].values()) and gc == ec):
        raise AssertionError(f"mesh_graph stepwise: {res}")
    add(gc)

    # (c) the solvers over this card named several times
    _solvers_graph_line(card_mesh, dev, "card", MODEL_SHARDS, RING_WINDOWS)

    # (d) close_loops(mesh=) on phase 7's loop course: the edges measured
    # by the edge step's graph, the pose graph solved edge-sharded
    lf = SyntheticStereoSequence._loop_schedule(len(lframes))[2]
    mesh = card_mesh({"data": 1, "model": MODEL_SHARDS}, dev)
    closed, counts = {}, {}
    for mode in ("graph", "eager"):
        with dispatch(mode == "graph"):
            reset_counts()
            closed[mode] = loopclosure.close_loops(
                lposes, lambda i: lframes[i], config, intr,
                gt_loop_pair=(0, lf), mesh=mesh, device=dev)
            counts[mode] = read_counts()
    (gp, ginfo), (ep, einfo) = closed["graph"], closed["eager"]
    res = dict(part="close_loops", shards=MODEL_SHARDS, edges=ginfo.edges,
               closure_before_m=ginfo.closure_before_m,
               closure_after_m=ginfo.closure_after_m,
               launch_counts_graph=counts["graph"],
               launch_counts_eager=counts["eager"],
               bit_exact={"poses": _bits(gp, ep),
                          "edges": ginfo.edges == einfo.edges,
                          "closure": ginfo.closure_after_m
                          == einfo.closure_after_m})
    print("mesh_graph", json.dumps(res))
    if not (all(res["bit_exact"].values()) and ginfo.edges
            and counts["graph"] == counts["eager"]):
        raise AssertionError(f"mesh_graph close_loops: {res}")
    add(counts["graph"])

    # (e) one NCCL rank at world size 1, in this process
    add(_nccl_rank_graph(seqs, first, chunk, config, xconfig, intr, dev))

    # (f) a capture that fails leaves nothing capturing
    _failed_capture_line(dev)

    # (g) the batched mono and Shi-Tomasi steps, B sequences on this card
    add(_batched_variants_graph(seqs, first, chunk, intr, dev))
    return launches


def _failed_capture_line(dev):
    """Phase 17 (f): a loop whose body fails while it is captured, by a
    Python error or by a value read back to the host (which CUDA refuses
    inside a capture), raises to the caller and keeps no capture; no
    stream of the card is left capturing, the card synchronises, and the
    next capture in this process replays bit for bit its eager loop."""
    import torch

    from visual_odom_tpu_torch.utils import cudagraph

    def loop_body(fail=None):
        calls, streams = [], []

        def body(carry):
            calls.append(1)
            (x,) = carry
            total = x.sum()
            if fail and len(calls) == 2:        # the capture
                streams.append(torch.cuda.current_stream(dev))
                if fail == "raise":
                    raise RuntimeError("injected failure")
                float(total)
            return (x * 0.5 + total,)

        return body, streams

    x0 = torch.arange(12, dtype=torch.float32, device=dev).reshape(3, 4)
    res = dict(part="failed_capture")
    for fail in ("raise", "host_read"):
        body, streams = loop_body(fail)
        loop = cudagraph.GraphedLoop(body, dev)
        try:
            loop((x0,), 3)
            raised = None
        except RuntimeError as err:
            raised = str(err).splitlines()[0][:120]
        capturing = []
        for st in streams + [torch.cuda.current_stream(dev)]:
            with torch.cuda.stream(st):
                capturing.append(torch.cuda.is_current_stream_capturing())
        torch.cuda.synchronize()
        good = loop_body()[0]
        again = cudagraph.GraphedLoop(good, dev)
        got = again((x0,), 3)
        want = (x0,)
        for _ in range(3):
            want = good(want)
        res[fail] = dict(raised=raised, captures_kept=len(loop.captures),
                         streams_capturing=sum(capturing),
                         open_captures=len(cudagraph._open()),
                         next_capture_replays=_replays(again),
                         next_capture_bit_exact=_bits(got[0].cpu(),
                                                      want[0].cpu()))
    print("mesh_graph", json.dumps(res))
    for fail in ("raise", "host_read"):
        r = res[fail]
        if not (r["raised"] and r["captures_kept"] == 0
                and r["streams_capturing"] == 0 and r["open_captures"] == 0
                and r["next_capture_replays"] == 3
                and r["next_capture_bit_exact"]):
            raise AssertionError(f"mesh_graph failed_capture: {res}")


def _batched_variants_graph(seqs, first, chunk, intr, dev):
    """Phase 17 (g): the batched step with mono rotation and with the
    Shi-Tomasi detector, the B sequences of ``seqs`` on this card, stepwise:
    graphed (captured before the timed steps) against eager, bit for bit
    with equal launches. Returns the graphed runs' launch counts."""
    import torch

    from visual_odom_tpu_torch.config import VOConfig
    from visual_odom_tpu_torch.parallel import batch
    from visual_odom_tpu_torch.utils.cudagraph import dispatch

    launches = dict.fromkeys(read_counts(), 0)
    for name, opts in (("mono", dict(mono_rotation=True)),
                       ("shi_tomasi", dict(detector="shi-tomasi"))):
        cfg = VOConfig.for_image(H, W, **opts)
        runs = {}
        for graphed in (False, True):
            with dispatch(graphed):
                step = batch.make_batched_step_fn(cfg, intr, device=dev)
                st = batch.batched_init_state(cfg, *first, device=dev)
                t = time.perf_counter()
                step.capture(st, chunk[0][0], chunk[1][0])
                torch.cuda.synchronize()
                capture_s = time.perf_counter() - t
                reset_counts()
                t = time.perf_counter()
                outs = []
                for i in range(chunk[0].shape[0]):
                    st, out = step(st, chunk[0][i], chunk[1][i])
                    outs.append(out)
                torch.cuda.synchronize()
                runs[graphed] = (st, outs, read_counts(),
                                 time.perf_counter() - t, capture_s)
        (est, eouts, ec, ew, _), (gst, gouts, gc, gw, gcap) = (runs[False],
                                                              runs[True])
        n = len(gouts)
        res = dict(part=f"batched_{name}", batch=len(seqs), steps=n,
                   ms_graph=1e3 * gw / n, ms_eager=1e3 * ew / n,
                   capture_s=gcap,
                   accept=float(np.mean([o.accept.cpu().numpy()
                                         for o in gouts])),
                   launch_counts_graph=gc, launch_counts_eager=ec,
                   bit_exact={"outputs": all(_out_bits(a, b) for a, b in
                                             zip(gouts, eouts)),
                              "state": _state_bits(gst, est)})
        print("mesh_graph", json.dumps(res))
        if not (all(res["bit_exact"].values()) and gc == ec
                and sum(gc.values()) > 0):
            raise AssertionError(f"mesh_graph batched {name}: {res}")
        for k, v in gc.items():
            launches[k] += v
    return launches


def _solvers_graph_line(make, dev, where, shards, windows):
    """``sharded_ba_solve`` (SHARDED_BA_PROBLEMS) over ``shards`` landmark
    shards, ``ring_ba_solve`` (phase 12's halo problem, RING_GRAPH_ROUNDS
    rounds) and the ring window solver over ``windows`` windows, and
    ``sharded_posegraph_solve`` over ``shards`` edge shards, on
    ``make(axes, dev)`` meshes, graphed against eager bit for bit, with ms
    a GN iteration or round both ways in paired rounds."""
    import torch

    from visual_odom_tpu_torch.ba import posegraph, problem
    from visual_odom_tpu_torch.parallel import ring_ba
    from visual_odom_tpu_torch.parallel.sharded_ba import sharded_ba_solve
    from visual_odom_tpu_torch.utils.cudagraph import dispatch

    def both(fn, per, rounds=SOLVE_GRAPH_ROUNDS):
        """fn() graphed and eager: (results, ms per ``per`` paired)."""
        out = {}
        for mode in ("eager", "graph"):
            with dispatch(mode == "graph"):
                out[mode] = fn()
        torch.cuda.synchronize()

        def timed(graphed):
            with dispatch(graphed):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                return time.perf_counter() - t

        return out, _paired_ms(timed, rounds, per)

    def line(part, out, ms, fields, **extra):
        res = dict(part=part, where=where, ms_graph=ms["graph"],
                   ms_eager=ms["eager"], **extra,
                   bit_exact={k: _bits(getattr(out["graph"], k).cpu(),
                                       getattr(out["eager"], k).cpu())
                              for k in fields})
        print("mesh_graph", json.dumps(res))
        if not all(res["bit_exact"].values()):
            raise AssertionError(f"mesh_graph {part} ({where}): {res}")

    mesh = make({"data": 1, "model": shards}, dev)
    for n_poses, n_landmarks in SHARDED_BA_PROBLEMS:
        p, _, _ = problem.synthetic_ba_problem(
            num_poses=n_poses, num_landmarks=n_landmarks, seed=7,
            obs_window=None if n_poses <= 8 else 2, device=dev)
        out, ms = both(lambda: sharded_ba_solve(
            p, mesh, iterations=SHARDED_BA_ITERS), SHARDED_BA_ITERS)
        line("sharded_ba", out, ms, ("poses", "landmarks"), poses=n_poses,
             landmarks=n_landmarks, shards=shards,
             iterations=SHARDED_BA_ITERS, unit="ms per GN iteration")

    seq = make({"seq": windows}, dev)
    p, _, _ = problem.synthetic_ba_problem(
        num_poses=RING_POSES, num_landmarks=RING_LANDMARKS, pixel_noise=0.2,
        pose_perturb=0.015, landmark_perturb=0.08, seed=3,
        obs_window=RING_OBS_WINDOW, device=dev)
    out, ms = both(lambda: ring_ba.ring_ba_solve(
        p, seq, halo=RING_HALO, rounds=RING_GRAPH_ROUNDS,
        cg_iters=RING_CG_ITERS), RING_GRAPH_ROUNDS)
    line("ring_ba", out, ms, ("poses", "landmarks"), poses=RING_POSES,
         landmarks=RING_LANDMARKS, windows=windows, halo=RING_HALO,
         cg_iters=RING_CG_ITERS, rounds=RING_GRAPH_ROUNDS,
         unit="ms per GN round")
    solver = {}
    for mode in ("eager", "graph"):
        with dispatch(mode == "graph"):
            s = ring_ba.make_ring_window_solver(seq, cg_iters=RING_CG_ITERS)
            solver[mode] = (s(p), dict(s.branches))
    line("ring_window_solver", {k: v[0] for k, v in solver.items()},
         {"graph": [], "eager": []}, ("poses", "landmarks"),
         branches=solver["graph"][1])

    graph = posegraph.build_keyframe_graph(*_circle_chain(), device=dev)
    out, ms = both(lambda: posegraph.sharded_posegraph_solve(graph, mesh),
                   10)
    line("posegraph_sharded", out, ms, ("nodes",), shards=shards,
         nodes=int(graph.nodes.shape[0]), unit="ms per GN iteration")


def _circle_chain(n=64):
    """A drifted circle of ``n`` keyframes closed by one loop edge, as
    tests/test_posegraph.py builds it: (poses, keyframe indices, loop
    edges) for ``build_keyframe_graph``."""
    th = 2 * np.pi * np.arange(n) / n
    truth = np.tile(np.eye(4), (n, 1, 1))
    truth[:, 0, 0] = truth[:, 2, 2] = np.cos(th)
    truth[:, 0, 2], truth[:, 2, 0] = np.sin(th), -np.sin(th)
    truth[:, 0, 3], truth[:, 2, 3] = 10 * np.sin(th), 10 * (1 - np.cos(th))
    est = truth.copy()
    est[:, :3, 3] += np.cumsum(np.random.default_rng(3).normal(
        0, 0.02, (n, 3)), axis=0)
    return est, np.arange(n), [(0, n - 1, np.linalg.inv(truth[0])
                                @ truth[-1], 10.0)]


def _nccl_rank_graph(seqs, first, chunk, config, xconfig, intr, dev):
    """Phase 17 (e): one NCCL rank at world size 1 in this process: the
    rank's scan on both routes (its LK launches split over its model group
    of one, whose all-gathers the graph holds) graphed against eager bit
    for bit, ms a step both ways in paired rounds, and the three solvers
    over a line of this one rank. Returns the graphed scans' launches."""
    import socket

    import torch

    from visual_odom_tpu_torch.parallel.mesh import (initialize_distributed,
                                                     make_mesh,
                                                     visible_devices)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    initialize_distributed(coordinator=f"127.0.0.1:{port}", num_processes=1,
                           process_id=0, device=dev)
    launches = dict.fromkeys(read_counts(), 0)
    try:
        ranks = visible_devices()

        def rank_mesh(axes, _dev):
            return make_mesh(axes, ranks)

        mesh = rank_mesh({"data": 1, "model": 1}, dev)
        for cfg in (config, xconfig):
            route = cfg.resolved_lk_backend()
            est, eout, ec, _, _ = _mesh_scan_run(cfg, intr, mesh, first,
                                                 chunk, False)
            gst, gout, gc, _, _ = _mesh_scan_run(cfg, intr, mesh, first,
                                                 chunk, True, strict=True)
            again = []

            def timed(graphed):
                st, out, _, wall, _ = _mesh_scan_run(cfg, intr, mesh, first,
                                                     chunk, graphed)
                again.append(_out_bits(out, eout) and _state_bits(st, est))
                return wall

            ms = _paired_ms(timed, MESH_GRAPH_ROUNDS if route == "pallas"
                            else 1, MESH_GRAPH_STEPS)
            res = dict(part="nccl_rank_scan", route=route, world=1,
                       steps=MESH_GRAPH_STEPS, batch=len(seqs),
                       ms_graph=ms["graph"], ms_eager=ms["eager"],
                       launch_counts_graph=gc, launch_counts_eager=ec,
                       bit_exact={"outputs": _out_bits(gout, eout),
                                  "state": _state_bits(gst, est),
                                  "rounds": all(again)})
            print("mesh_graph", json.dumps(res))
            if not (all(res["bit_exact"].values()) and gc == ec):
                raise AssertionError(f"mesh_graph NCCL rank, {route}: {res}")
            for k, v in gc.items():
                launches[k] += v
        _solvers_graph_line(rank_mesh, dev, "nccl_rank", 1, 1)
    finally:
        torch.distributed.destroy_process_group()
    return launches


def pnp_compare(name, got, plain, ref64) -> dict:
    """The kernel's poses against the plain twin's on the card and against
    the plain twin in float64, held as the card tests hold them: the
    finiteness mismatches and the largest component differences over the
    poses both leave finite; for the polish, the largest difference to the
    plain twin relative to 1 + |pose| (PNP_POLISH_TOL); for the hypotheses,
    each side's distance to float64 at PNP_HYP_QUANTILES (at most
    PNP_HYP_FACTOR x the plain twin's). ``ok`` says whether it held."""
    import torch

    got, plain, ref64 = (a.detach().cpu().double() for a in (got, plain, ref64))
    fin_g = torch.isfinite(got).all(-1)
    fin_p = torch.isfinite(plain).all(-1)
    both = fin_g & fin_p

    def dist(a, b):
        return (a - b).abs().amax(-1)[both]

    def worst(a, b):
        d = dist(a, b)
        return float(d.max()) if d.numel() else 0.0

    res = dict(poses=int(got.shape[0]), finite=int(both.sum()),
               finite_mismatch=int((fin_g != fin_p).sum()),
               max_abs_diff=worst(got, plain),
               plain_vs_f64=worst(plain, ref64),
               kernel_vs_f64=worst(got, ref64))
    if "polish" in name:
        rel = ((got - plain).abs() / (1.0 + plain.abs()))[both]
        res.update(max_rel_diff=float(rel.max()) if rel.numel() else 0.0,
                   tol_rel_diff=PNP_POLISH_TOL)
        ok = (res["finite"] == res["poses"]
              and res["max_rel_diff"] < PNP_POLISH_TOL)
    else:
        mine, twin = dist(got, ref64), dist(plain, ref64)
        q = torch.tensor(PNP_HYP_QUANTILES, dtype=torch.float64)
        qm, qt = ((torch.quantile(x, q).tolist() if x.numel()
                   else [float("nan")] * len(q)) for x in (mine, twin))
        res.update(quantiles=list(PNP_HYP_QUANTILES), kernel_vs_f64_q=qm,
                   plain_vs_f64_q=qt, tol_factor=PNP_HYP_FACTOR,
                   min_finite_share=0.9)
        ok = (res["finite"] >= 0.9 * res["poses"]
              and all(m <= PNP_HYP_FACTOR * t + 1e-7
                      for m, t in zip(qm, qt)))
    res["ok"] = bool(ok and not res["finite_mismatch"])
    return res


def _graph_of(fn):
    """``fn`` captured in a CUDA graph (after one warm-up call on the
    capture's stream)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def pnp_phase(dev) -> tuple:
    """Phase 18: build ``csrc/pnp_gn.cu`` and hold both PnP refinement
    kernels to the plain twin at the main path's shapes (PNP_B), each
    launch timed on the device eagerly and in a graph's replay beside the
    plain twin's replay and the launch's latency bound (PNP_CHAIN_*), and
    ``pnp_ransac`` on the card launching each kernel once. One ``pnp`` line
    per kernel and B; raises where a kernel misses its plain twin by more
    than the card tests allow (``pnp_compare``). Returns the lines, by
    kernel, and the launches made, by kernel."""
    import torch

    from visual_odom_tpu_torch.backend import pnp
    from visual_odom_tpu_torch.io.pnp_scene import pnp_scene
    from visual_odom_tpu_torch.ops import _nvcc

    t = time.perf_counter()
    path = _nvcc.build("pnp_gn")
    print(f"pnp build: {time.perf_counter() - t:.2f} s")
    with open(path + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print("pnp ptxas:", line.strip())
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.split()[0])
    cycle_ms = 1e-3 / clock_mhz
    before = (pnp.refine_hypotheses.launches, pnp.refine_polish.launches)
    lines = {name: [] for name in PNP_COUNTERS.values()}
    for B in PNP_B:
        d = pnp_scene(dev, B, PNP_N, PNP_HYPS, PNP_SAMPLE, PNP_K, seed=B)
        hyp_args = (d["pose0"], d["X"], d["x"], d["idx"], d["K"], PNP_ITERS)
        pol_args = (d["polish"], d["X"], d["x"], d["w"], d["K"],
                    2 * PNP_ITERS)
        cpu64 = {k: v.cpu().double() if v.is_floating_point() else v.cpu()
                 for k, v in d.items() if k != "valid"}
        checks = {
            "pnp_gn_hypotheses_kernel": (
                lambda: pnp.refine_hypotheses(*hyp_args),
                lambda: pnp._refine_hypotheses_plain(*hyp_args),
                lambda: pnp._refine_hypotheses_plain(
                    cpu64["pose0"], cpu64["X"], cpu64["x"], cpu64["idx"],
                    cpu64["K"], PNP_ITERS),
                PNP_ITERS * (PNP_CHAIN_ITER + 2 * PNP_SAMPLE)),
            "pnp_gn_polish_kernel": (
                lambda: pnp.refine_polish(*pol_args),
                lambda: pnp._gn_refine(*pol_args),
                lambda: pnp._gn_refine(
                    cpu64["polish"], cpu64["X"], cpu64["x"], cpu64["w"],
                    cpu64["K"], 2 * PNP_ITERS),
                2 * PNP_ITERS * (PNP_CHAIN_ITER + 2 * -(-PNP_N // 256) + 12
                                 + 256 // 32 - 1))}
        for name, (kernel, plain, ref, chain) in checks.items():
            got = kernel()
            want = plain()
            torch.cuda.synchronize()
            cmp = pnp_compare(name, got, want, ref())
            k_graph, k_out = _graph_of(kernel)
            p_graph, _ = _graph_of(plain)
            k_graph.replay()
            torch.cuda.synchronize()
            if not torch.equal(k_out, got):
                raise AssertionError(f"{name} B={B}: the graph's replay "
                                     f"differs from the eager launch")
            ms = device_ms(kernel)
            graph_ms = device_ms(k_graph.replay)
            plain_graph_ms = device_ms(p_graph.replay)
            bound_ms = (chain + PNP_CHAIN_ENDS) * FP32_LATENCY_CYCLES * cycle_ms
            line = dict(
                kernel=name, source=PNP_SOURCE, B=B, hyps=PNP_HYPS,
                sample=PNP_SAMPLE, slots=PNP_N, iters=PNP_ITERS * (
                    2 if "polish" in name else 1),
                ms=ms, graph_ms=graph_ms, plain_graph_ms=plain_graph_ms,
                bound_ms=bound_ms, bound_by="latency",
                share_of_bound=bound_ms / graph_ms, clock_mhz=clock_mhz,
                **cmp)
            print("pnp", json.dumps(line))
            if not cmp["ok"]:
                raise AssertionError(f"{name} B={B}: the kernel misses its "
                                     f"plain twin: {cmp}")
            lines[name].append(line)
    # pnp_ransac on the card: one launch of each kernel a call
    d = pnp_scene(dev, 1, PNP_N, PNP_HYPS, PNP_SAMPLE, PNP_K, seed=7)
    counts = (pnp.refine_hypotheses.launches, pnp.refine_polish.launches)
    pnp.pnp_ransac(d["X"][0], d["x"][0], d["valid"][0], d["K"],
                   torch.zeros(3, device=dev), d["pose0"][0, 3:],
                   generator=torch.Generator(device=dev).manual_seed(0),
                   iterations=PNP_HYPS, sample_size=PNP_SAMPLE,
                   refine_iters=PNP_ITERS)
    torch.cuda.synchronize()
    made = (pnp.refine_hypotheses.launches - counts[0],
            pnp.refine_polish.launches - counts[1])
    if made != (1, 1):
        raise AssertionError(f"pnp_ransac launched {made} PnP kernels, "
                             f"expected (1, 1)")
    return lines, {"pnp_gn_hypotheses_kernel":
                   pnp.refine_hypotheses.launches - before[0],
                   "pnp_gn_polish_kernel":
                   pnp.refine_polish.launches - before[1]}


def pnp_main() -> int:
    """``chip_smoke.py --pnp``: phase 18 alone."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    print("card:", card_line())
    print("pnp launches", json.dumps(pnp_phase(torch.device("cuda", 0))[1]))
    print(card_line())
    return 0


def main() -> int:
    """Every phase; the render pool stops whatever happens."""
    with contextlib.ExitStack() as stack:
        return run_phases(stack)


def run_phases(stack) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the card",
              file=sys.stderr)
        return 2
    try:
        import visual_odom_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    from visual_odom_tpu_torch.config import VOConfig
    from visual_odom_tpu_torch.ops import _nvcc, lk_cuda
    from visual_odom_tpu_torch.ops.lk import LKParams

    _count_replays()
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    print("card:", card)
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "python", sys.version.split()[0])

    # The courses render on every core but one while the kernels build and
    # phase 3 checks them on the first frames, which render first.
    t_render = time.perf_counter()
    render = stack.enter_context(CourseRender(
        [("straight", "value", STRAIGHT_STEPS + 1),
         ("straight", "checker", CHECKER_STEPS + 1),
         ("turning", "value", BENCH_STEPS + 1),
         ("stress", "value", BENCH_STEPS + 1),
         ("loop", "value", LOOP_STEPS + 1)], H, W,
        workers=max(1, (os.cpu_count() or 1) - 1)))

    t = time.perf_counter()
    path = _nvcc.build("lk_legs")
    print(f"build: {time.perf_counter() - t:.2f} s")
    with open(path + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print("ptxas:", line.strip())
    print("sass", json.dumps(sass_loops(path)))
    # Resources of each instance, and how many features the card holds at
    # once: the waves a launch of WIDE_B sequences of 384 slots takes.
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    infos = {}
    for level in (False, True):
        for inst in INSTANCES:
            info = lk_cuda.kernel_info(level, *inst)
            resident = info["blocks_per_sm"] * info["features_per_block"] * n_sm
            info.update(features_resident=resident,
                        waves_at_wide_b=-(-WIDE_B * 384 // resident))
            infos[level, inst] = info
            print("instance", json.dumps(dict(
                kernel="lk_level_kernel" if level else "lk_quad_kernel",
                instance=instance_name(inst), sms=n_sm, **info)))

    config = VOConfig.for_image(H, W)
    intr = kitti_intrinsics(H, W)
    params = LKParams(window=config.lk_window, levels=config.lk_levels,
                      max_iters=config.lk_max_iters, eps=config.lk_eps,
                      min_eig_threshold=config.lk_min_eig_threshold)
    first = {k: render.first(k) for k in BATCH_COURSES}
    frames = first[("straight", "value")]
    print(f"render, first frames: {time.perf_counter() - t_render:.2f} s")

    # ---- phase 3: kernels vs plain at KITTI shapes -----------------------
    t = time.perf_counter()
    images, pts, valid, flow, disp = quad_inputs(frames, config, intr, dev)
    probe = torch.arange(0, pts.shape[0], pts.shape[0] // 64, device=dev)[:64]
    masked = torch.zeros_like(valid)

    def probe_of(*xs):
        return [x[..., probe, :].contiguous() if x.dim() > valid.dim()
                else x[..., probe] for x in xs]

    quads = [
        compare_kernel(quad_check(images, pts, valid, flow, disp, params, 1),
                       "fast_sl1_n384"),
        compare_kernel(quad_check(images, *probe_of(pts, valid, flow, disp),
                                  params, 2), "probe_sl2_n64"),
        compare_kernel(quad_check(images, pts, valid, flow, disp, params, 2),
                       "safe_sl2_n384"),
        compare_kernel(quad_check(images, pts, masked, flow, disp, params, 2),
                       "safe_masked_sl2_n384"),
    ]
    levels = (compare_leg(images, pts, valid, disp, params, 1, "fast_leg_sl1_n384")
              + compare_leg(images, pts, valid, disp, params, 2, "safe_leg_sl2_n384")
              + compare_leg(images, *probe_of(pts, valid, disp), params, 2,
                            "probe_leg_sl2_n64")
              + compare_leg(images, pts, masked, disp, params, 2,
                            "safe_masked_leg_sl2_n384"))
    real_leg(images, pts, valid, params)
    for inst in INSTANCES:
        with instance_defaults(inst):
            for sl in (1, 2):
                route_vs_quad(images, pts, valid, flow, disp, params, sl,
                              f"sl{sl}_n384")
    # From the pyramid top, as each loop-edge measurement launches them.
    full = full_pyramid_inputs(frames, config, intr, dev)
    sl_top = params.levels
    quad_full = compare_kernel(quad_check(*full, params, sl_top),
                               f"full_sl{sl_top}_n384")
    quads.append(quad_full)
    levels += compare_leg(full[0], full[1], full[2], full[4], params, sl_top,
                          f"full_leg_sl{sl_top}_n384")
    for inst in INSTANCES:
        with instance_defaults(inst):
            route_vs_quad(*full, params, sl_top, f"full_sl{sl_top}_n384")
    del full
    bframes = stacked_frames([first[k] for k in BATCH_COURSES], 3)
    images, pts, valid, flow, disp = quad_inputs(bframes, config, intr, dev)
    some = valid & (torch.arange(BATCH, device=dev) % 2 == 0)[:, None]
    bquads = [
        compare_kernel(quad_check(images, pts, valid, flow, disp, params, 1),
                       f"fast_sl1_b{BATCH}_n384"),
        compare_kernel(quad_check(images, *probe_of(pts, valid, flow, disp),
                                  params, 2), f"probe_sl2_b{BATCH}_n64"),
        compare_kernel(quad_check(images, pts, some, flow, disp, params, 2),
                       f"safe_some_masked_sl2_b{BATCH}_n384"),
    ]
    blevels = (compare_leg(images, pts, valid, disp, params, 1,
                           f"fast_leg_sl1_b{BATCH}_n384")
               + compare_leg(images, pts, some, disp, params, 2,
                             f"safe_some_masked_leg_sl2_b{BATCH}_n384"))
    for inst in INSTANCES:
        with instance_defaults(inst):
            for sl in (1, 2):
                route_vs_quad(images, pts, valid, flow, disp, params, sl,
                              f"sl{sl}_b{BATCH}_n384")
    # The instances again at WIDE_B sequences, where the card fills (the
    # plain version is not timed here).
    wframes = stacked_frames([first[BATCH_COURSES[b % BATCH]]
                              for b in range(WIDE_B)], 3)
    images, pts, valid, flow, disp = quad_inputs(wframes, config, intr, dev)
    wquad = compare_kernel(quad_check(images, pts, valid, flow, disp, params,
                                      1), f"fast_sl1_b{WIDE_B}_n384",
                           time_plain=False)
    wlevels = compare_leg(images, pts, valid, disp, params, 1,
                          f"fast_leg_sl1_b{WIDE_B}_n384", time_plain=False)
    del images, pts, valid, flow, disp
    print(f"phase 3: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    courses = render.result()
    render.close()
    frames, gt = courses[("straight", "value")]
    print(f"render: {time.perf_counter() - t_render:.2f} s from the start, "
          f"{time.perf_counter() - t:.2f} s waited after phase 3")

    # ---- phase 4: the main path, on both routes --------------------------
    t = time.perf_counter()
    set_path("main_path")
    xconfig = VOConfig.for_image(H, W, lk_backend="xla")
    cframes, cgt = courses[("straight", "checker")]
    runs, xruns, refs, xrefs = [], [], [], []
    for name, fr, g in (("straight", frames, gt),
                        ("straight_checker", cframes, cgt)):
        res, poses, fetched = run_main_path(name, fr, g, config, intr, dev)
        runs.append(res)
        refs.append((poses, fetched))
        xres, xposes, xfetched = run_main_path(name, fr, g, xconfig, intr,
                                               dev, ref_poses=poses)
        xruns.append(xres)
        xrefs.append((xposes, xfetched))
    batched_run, bposes, bstats = run_batched_path(courses, config, intr, dev)
    xbatched_run, xbposes, _ = run_batched_path(courses, xconfig, intr, dev,
                                                ref_poses=bposes)

    print(f"phase 4: {time.perf_counter() - t:.1f} s")

    # ---- phase 5: small input against the CPU reference -----------------
    t = time.perf_counter()
    small_reference(dev)
    small_batched_reference(dev)

    # ---- phase 6: where the time goes -----------------------------------
    default_prof = profile_frames(frames, config, intr, dev,
                                  runs[0]["ms_per_frame"])
    xla_prof = profile_frames(frames, xconfig, intr, dev,
                              xruns[0]["ms_per_frame"], label="profile_xla")
    sweep = batch_sweep(courses, config, intr, dev)
    print(f"phases 5-6: {time.perf_counter() - t:.1f} s")

    # ---- phase 7: the back end on the loop course -------------------------
    t = time.perf_counter()
    set_path("backend")
    lframes, lgt = courses[("loop", "value")]
    scan, lposes, snaps = backend_scan(lframes, lgt, config, intr, dev)
    tracks_cost(lframes, config, intr, dev)
    backend_ba(snaps, lposes, lgt, intr, dev)
    loops, xloops, _, loop_poses = backend_loops(lframes, lposes, lgt,
                                                 config, xconfig, intr, dev)
    print(f"phase 7: {time.perf_counter() - t:.1f} s")

    # ---- phase 8: resume, mono rotation, Shi-Tomasi, on "straight" -----
    t = time.perf_counter()
    set_path("resume_variants")
    resume_launches, straight_tracks = resume_check(frames, config, intr,
                                                    dev)
    variants = {name: variant_check(name, opts, frames, gt, intr, dev,
                                    default_prof, JAX_VARIANTS[name])
                for name, opts in (("mono", dict(mono_rotation=True)),
                                   ("shi_tomasi", dict(detector="shi-tomasi")))}
    profiles = {"quad": default_prof, "xla": xla_prof,
                "mono": variants["mono"][2]}
    print(f"phase 8: {time.perf_counter() - t:.1f} s")

    # ---- phase 9: the front doors, on phase 4's frames -------------------
    t = time.perf_counter()
    set_path("front_doors")
    door_launches = front_doors(frames, cframes, refs[0], refs[1], config,
                                xconfig, intr, dev)
    print(f"phase 9: {time.perf_counter() - t:.1f} s")

    # ---- phases 10-11: KITTI PNG input, the command line, the pipe --------
    with tempfile.TemporaryDirectory() as root, image_packages_hidden():
        t = time.perf_counter()
        set_path("kitti")
        kitti_launches, dirs, scores = kitti_phase(
            courses, refs[0], bposes, bstats, config, intr, dev, root)
        print(f"phase 10: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        set_path("cli_pipe")
        cli_launches = cli_phase(courses, dirs, scores, refs[0],
                                 straight_tracks, bposes, config, intr, dev,
                                 root)
        pipe_launches = pipe_phase(frames, refs[0], xrefs[0], config, xconfig,
                                   intr, dev)
        print(f"phase 11: {time.perf_counter() - t:.1f} s")

        # ---- phase 12: the multi-device paths, on meshes of this card -----
        t = time.perf_counter()
        set_path("meshes")
        sharded_ba_phase(dev)
        ring_phase(straight_tracks, refs[0][0], intr, dev)
        mesh_loop_launches, loop_read = posegraph_sharded_phase(
            lframes, lposes, lgt, loop_poses, config, intr, dev)
        mesh_launches, mesh_refs = batch_mesh_phase(courses, bposes, xbposes,
                                                    config, xconfig, intr,
                                                    dev)
        cli_mesh_launches = cli_mesh_phase(dirs, root, bposes,
                                           mesh_refs["pallas"][2], config,
                                           dev)
        print(f"phase 12: {time.perf_counter() - t:.1f} s")

        # ---- phase 13: the same paths across processes, on this card -----
        t = time.perf_counter()
        set_path("ranks")
        rank_launches = ranks_phase(lposes, lframes, loop_read,
                                    mesh_loop_launches, courses, mesh_refs,
                                    config, intr, dev, root)
        nccl_across_cards(root)
        print(f"phase 13: {time.perf_counter() - t:.1f} s")

        # ---- phase 14: the bench harness, vo bench --quick ---------------
        t = time.perf_counter()
        set_path("bench")
        bench_launches = bench_phase(courses, root)
        print(f"phase 14: {time.perf_counter() - t:.1f} s")

    # ---- phase 15: the step as one CUDA graph, against eager -------------
    t = time.perf_counter()
    set_path("graph")
    graph_launches = graph_phase(frames, courses, refs[0], xrefs[0], config,
                                 xconfig, intr, dev, profiles, sweep)
    print(f"phase 15: {time.perf_counter() - t:.1f} s")

    # ---- phase 16: the doors, the pipe and the solves as CUDA graphs ------
    t = time.perf_counter()
    set_path("doors_graph")
    door_graph_launches = doors_graph_phase(frames, courses, lframes, lposes,
                                            snaps, config, intr, dev)
    del snaps
    print(f"phase 16: {time.perf_counter() - t:.1f} s")

    # ---- phase 17: the multi-device paths as CUDA graphs -----------------
    t = time.perf_counter()
    set_path("mesh_graph")
    mesh_graph_launches = mesh_graph_phase(courses, lframes, lposes, config,
                                           xconfig, intr, dev)
    print(f"phase 17: {time.perf_counter() - t:.1f} s")

    # ---- phase 18: PnP-RANSAC's refinement kernels -----------------------
    t = time.perf_counter()
    pnp_lines, pnp_made = pnp_phase(dev)
    print("pnp launches", json.dumps(pnp_made))
    print(f"phase 18: {time.perf_counter() - t:.1f} s")
    print("pnp launches_by_path", json.dumps(PNP_LAUNCHES))
    if not all(PNP_LAUNCHES[k] == PNP_LAUNCHES["pnp_hypotheses"]
               and sum(PNP_LAUNCHES[k].values()) > 0 for k in PNP_LAUNCHES):
        raise AssertionError(f"PnP launches by path: {PNP_LAUNCHES}")

    default = lk_cuda.variant()

    def row(name, replaces, paths, qs, lead, level, wide=None, top=None):
        """The kernel's row, at the default instance; ``lead`` is the check
        whose launch stands for the kernel's time and bound. ``paths``
        gives its launches on each path driven ({path: count}), ``launches``
        their sum. ``instances`` gives every instance's numbers on the same
        check (and on ``wide``, the same check at WIDE_B sequences; on
        ``top``, the quad from the pyramid top)."""
        d = [q[default] for q in qs]
        lead_d = lead[default]
        return {"name": name, "route": "cuda", "source": SOURCE,
                "replaces": replaces, "launches": sum(paths.values()),
                "launches_by_path": paths,
                "max_abs_err": max(q["max_abs_err"] for q in d),
                "ms": lead_d["ms"], "plain_ms": lead_d["plain_ms"],
                "bound_ms": lead_d["bound_ms"], "bound_by": lead_d["bound_by"],
                "library_ms": None, "timed": lead_d["label"],
                "instance": instance_name(default),
                "max_abs_err_held": max(q["max_abs_err_held"] for q in d),
                **{k: sum(q[k] for q in d) for k in (
                    "knife_edge", "knife_edge_diverged",
                    "knife_edge_arbitrated")},
                "max_abs_err_knife_edge": max(q["max_abs_err_knife_edge"]
                                              for q in d),
                "instances": [dict(
                    instance=instance_name(i), default=i == default,
                    replaces=replaces if level else INSTANCE_REPLACES[i],
                    ms=lead[i]["ms"], bound_ms=lead[i]["bound_ms"],
                    share_of_bound=lead[i]["share_of_bound"],
                    longest_chain=lead[i]["longest_chain"],
                    us_per_update=lead[i]["us_per_update"],
                    max_abs_err=max(q[i]["max_abs_err"] for q in qs),
                    **({f"ms_b{WIDE_B}": wide[i]["ms"],
                        f"us_per_update_b{WIDE_B}": wide[i]["us_per_update"]}
                       if wide else {}),
                    **({f"ms_{top[i]['label']}": top[i]["ms"],
                        f"bound_ms_{top[i]['label']}": top[i]["bound_ms"]}
                       if top else {}),
                    **{k: infos[level, i][k] for k in (
                        "registers", "local_bytes", "features_resident")})
                    for i in INSTANCES]}

    def finest(qs):
        return next(q for q in qs if q[default]["level"] == 0)

    def pnp_row(key):
        """A PnP kernel's row: its launches on each path driven (the runs
        whose counts were checked), its time in a graph's replay beside the
        plain twin's and its latency bound at B = PNP_B[0] (phase 18), and
        each B's."""
        name = PNP_COUNTERS[key]
        lines = pnp_lines[name]
        lead = lines[0]
        paths = dict(PNP_LAUNCHES[key])
        return {"name": name, "route": "cuda", "source": PNP_SOURCE,
                "replaces": PNP_REPLACES, "launches": sum(paths.values()),
                "launches_by_path": paths,
                "max_abs_err": max(ln["max_abs_diff"] for ln in lines),
                "ms": lead["graph_ms"], "plain_ms": lead["plain_graph_ms"],
                "bound_ms": lead["bound_ms"], "bound_by": lead["bound_by"],
                "library_ms": None,
                "timed": f"B={lead['B']}, a graph's replay",
                "batches": [{k: ln[k] for k in (
                    "B", "ms", "graph_ms", "plain_graph_ms", "bound_ms",
                    "share_of_bound", "max_abs_diff")} for ln in lines]}

    print("total:", f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        row("lk_quad_kernel", REPLACES,
            {"main_path": sum(r["kernel_launches"] for r in runs),
             "backend_scan": scan["kernel_launches"],
             "loop_edges": loops["launch_counts"]["quad"],
             "resume": resume_launches,
             "mono": variants["mono"][0],
             "shi_tomasi": variants["shi_tomasi"][0],
             "front_doors": door_launches["quad"],
             "kitti_stream": kitti_launches["quad"],
             "cli": cli_launches["quad"],
             "pipe": pipe_launches["quad"],
             "mesh_loop_edges": mesh_loop_launches,
             "cli_ba_ring": cli_mesh_launches["quad"],
             "rank_loop_edges": rank_launches["rank_loop_edges"],
             "bench": bench_launches["quad"],
             "graph": graph_launches["quad"],
             "doors_graph": door_graph_launches["quad"],
             "mesh_graph_loop_edges": mesh_graph_launches["quad"]},
            quads, quads[0], False, top=quad_full),
        row("lk_quad_kernel_batched", REPLACES_BATCHED,
            {"batched_path": batched_run["kernel_launches"],
             "kitti_batched": kitti_launches["quad_batched"],
             "cli_batch": cli_launches["quad_batched"],
             "batch_mesh": mesh_launches["quad_batched"],
             "cli_batch_mesh": cli_mesh_launches["quad_batched"],
             "rank_batch_mesh": rank_launches["rank_batch_mesh_quad"],
             "graph": graph_launches["quad_batched"],
             "doors_graph": door_graph_launches["quad_batched"],
             "mesh_graph": mesh_graph_launches["quad_batched"]},
            bquads,
            bquads[0], False, wquad),
        row("lk_level_kernel", REPLACES_LEVEL,
            {"main_path": sum(r["kernel_launches"] for r in xruns),
             "loop_edges": xloops["launch_counts"]["level"],
             "mono": variants["mono"][1],
             "shi_tomasi": variants["shi_tomasi"][1],
             "front_doors": door_launches["level"],
             "pipe": pipe_launches["level"],
             "bench": bench_launches["level"],
             "graph": graph_launches["level"]},
            levels, finest(levels), True),
        row("lk_level_kernel_batched", REPLACES_LEVEL_BATCHED,
            {"batched_path": xbatched_run["kernel_launches"],
             "batch_mesh": mesh_launches["level_batched"],
             "rank_batch_mesh": rank_launches["rank_batch_mesh_level"],
             "mesh_graph": mesh_graph_launches["level_batched"]},
            blevels,
            finest(blevels), True, finest(wlevels)),
        *(pnp_row(key) for key in PNP_COUNTERS)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def across_cards_main() -> int:
    """``chip_smoke.py --nccl-across-cards``: phase 13's check across cards
    alone (the kernels built, phase 4's batched courses rendered first);
    needs two cards."""
    import torch

    if torch.cuda.device_count() < 2:
        print("chip_smoke: --nccl-across-cards needs two cards",
              file=sys.stderr)
        return 2
    from visual_odom_tpu_torch.ops import lk_cuda

    lk_cuda._library()
    courses = render_courses([(k[0], k[1], MESH_STEPS + 1)
                              for k in BATCH_COURSES[:2]], H, W)
    with tempfile.TemporaryDirectory() as root:
        np.save(os.path.join(root, "batch.npy"), np.stack([
            np.stack([np.stack(f) for f in courses[k][0]])
            for k in BATCH_COURSES[:2]]))
        nccl_across_cards(root)
    print(card_line())
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--cards-rank"]:
        sys.exit(cards_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--nccl-across-cards"]:
        sys.exit(across_cards_main())
    if sys.argv[1:2] == ["--gloo-send-probe"]:
        sys.exit(send_probe_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--pnp"]:
        sys.exit(pnp_main())
    sys.exit(main())
