#!/usr/bin/env python
"""Drive the PyTorch/CUDA port's paths on one GPU: the bundle-adjustment fast
paths (camera table, windows, expanded operands, the unfused table kernels,
whole-table and windowed), the BA command line on BAL files with in-engine
annealing, the generic engine, pose-graph SLAM (SE(2) and SE(3)), the halo
paths, the schedules, the fixed-lag serving loop, checkpoint / resume and
the profiling helpers, structure from motion from rendered pixels, the
multi-process paths, the degree-class segmented layout, cameras in the
ELL slot and the benchmark layer.

    python3 chip_smoke.py

Phases (each prints one line or a few; any failure raises and exits
non-zero; no phase is caught):

  1. device: a CUDA card must be present; prints its name and power limit
     (nvidia-smi), torch and CUDA versions; pins exact float32.
  2. build: compiles gbp_tpu_torch/csrc/*.cu with nvcc (first use, one
     compiler per source side by side) and prints the seconds taken and
     ptxas's register/spill report.
  3. kernel vs plain, full-table kernels: on the 8-cam/120-landmark scene
     and on the bench scene (64 cams, 8000 landmarks, 469,861 factors),
     after 8 plain sweeps on the CPU (8 = min_linear_iters), each kernel and
     its plain PyTorch version run on identical CUDA inputs:
     relinearization at the config's beta (every valid row relinearizes) and
     at the median distance (half do), messages with and without Huber.
     float64 must agree to 1e-11 and float32 to 1e-4, relative to each
     output's magnitude (the messages' fifth output, the camera-side sum
     the messages launch computes, too); that fifth output must equal the
     model of the kernel's order at the card's launch plan
     (`ops.messages.fold_table_sum`, `table_plan`) bit for bit and two runs
     must give the same bits (`hold_fold`); the standalone camera sum
     (kernel 3) must repeat bit for bit.
  4. kernel vs plain, windowed kernels: the same checks on 7 merged blocks
     of 40 cameras (280 cameras, float64 and float32; the shuffled landmark
     numbering makes the locality sort engage; a single 280-camera corridor
     diverges under the plain schedule, non-finite in float32 by sweep 8,
     and leaves nothing to compare) and on the city scene (1,280 cameras,
     float32), and again with the windows widened to 256 cameras (float64)
     and 384 (city, float32), where a block stages more than 48 KB and the
     launch asks for dynamic shared memory; `messages_cm_tabblk_ell`'s
     fifth output (the window partials its launch computes) must equal the
     model of its order (`fold_window_sum`, `window_plan`) bit for bit,
     also at the pose and BAL shapes, at venice (phase 7) and under the
     schedule masks; `segsum_cm_blk` and `scatter_windows_cm` must repeat bit for
     bit, their combination is held against the whole-table camera sum, and
     `scatter_windows_cm` must equal its plain version bit for bit (max abs
     err 0.0), here, at the pose shapes and per halo partition, and a dense
     accumulation in tile order with overlapping and repeated window starts,
     float64 and float32.  `segsum_cm_blk` must equal its plain version
     computed on CPU copies of its operands bit for bit (max abs err 0.0:
     both add each segment in CSR order), here, at the pose shapes, in
     phase 18's windowed entries and per halo partition on its owned-rows
     CSR (phase 22); at city, at venice (phase 7) and on city cut in two
     (partition 0, phase 22) it prints its launch plan
     (`ops.messages.segsum_blk_plan`: components per item, items, blocks,
     threads, shared bytes, registers, local bytes, blocks per SM) and its
     device time by the profiler, bound and share
     (`bench/compare_sums.segsum_blk_report`).
     Each windowed check prints the launch plan of `messages_cm_tabblk_ell`
     (`ops.messages.window_plan`: units of rows, persistent blocks, the
     split's grain, shared bytes, registers, local bytes, blocks per SM,
     the slots a warp keeps in shared memory), as each fold check does for
     kernels 2 and 10 (`hold_fold`); at city, and at venice in phase 7, its device time by
     the profiler, bound and share (`bench/compare_windows.kernel_report`).
     At the bench scene (full-table kernels) and the city scene (windowed
     kernels), float32, each kernel is timed against its plain version, its
     bound (bytes moved once over the card's memory rate, or operations over
     its float32 rate) and, for the sums, one `index_add_` call; the
     camera-side sums (`segsum_by_id`, `scatter_windows_cm`) and that call
     also by the profiler (device time; the events time of a short kernel
     is its wrapper's host time).
  5. windowed path vs full-table path: the 280-camera scene in float32 fits
     both; 15 sweeps each way, ARE equal to 5e-3 px (mid-convergence float32
     roundoff: the two summation orders take different paths to the same
     fixed point while the ARE is still falling by pixels per sweep).
  6. main path, bench scene: simulate -> build (f32) -> prepare ->
     init_state -> 200 sweeps through the kernels (launch counts 200, plain
     counts 0, no `segsum_by_id`: the messages launch returns the sum; by
     the profiler no launch of kernel 3's or 16's CUDA functions, device
     records a sweep printed) -> to_gbp_state -> ARE, held to <= 1.05x the ARE of 6
     Gauss-Newton steps on the card; a rerun from the same init must give
     bitwise-equal means; a second timed 200-sweep call gives sweeps/s.
  7. main path, city scene (32 blocks x 40 cameras x 60 landmarks per
     camera, shuffled ids): simulate_blocks -> build (f32) ->
     prepare(window=True) -> init_state -> 50 sweeps through the windowed
     kernels (launch counts 50, plain counts 0; no `segsum_cm_blk`, and by
     the profiler no launch of kernel 3 or 16) -> to_gbp_state -> ARE:
     finite, below the initial ARE and within 1e-2 px of the same 50 sweeps
     through the plain versions; bitwise rerun; 200 timed sweeps.  Then the
     venice scene (256 blocks x 40 x 80; 10,240 cameras, about 4.1 million
     factors): 50 sweeps, finite ARE below the initial one, launch counts,
     timed sweeps.
  8. kernel vs plain, expanded-operand kernels (csrc/rows.cu), on the 8-cam
     and the bench scene from the same states: `relin_cm` and `messages_cm`
     on component-major operands, `fused_relin_messages` and
     `fused_messages` on their row-major transposes, both relinearization
     regimes, Huber none / scalar / per row, diagonal and full precision
     (float64 1e-11, float32 1e-4); timed with their bounds at the bench
     scene in float32.
  9. generic path: the bench scene through `core.sweep` under
     message_form="pallas" (row-major state, `fused_relin_messages` every
     sweep): 200 sweeps, launch counts 200, plain calls 0, ARE <= 1.05x the
     MAP ARE, bitwise rerun, sweeps/s; then 50 sweeps with layout="none"
     (both belief updates by the deterministic segment sum), ARE within
     1e-3 px of the ELL run at 50 sweeps; its two segment sums (row-major:
     the short form) against their plain versions (1e-4), the 64 cameras'
     and the 8,000 landmarks', each repeating bit for bit.  Every path
     prints the form of its `segsum_by_id` launches.
 10. rows path: 512 cameras that all see every landmark (no window engages,
     the packed table is beyond shared memory): `prepare` must choose
     gather_mode "rows"; 50 sweeps (counts, ARE finite and below the initial
     one), 200 sweeps against the MAP ARE (printed, which of the two it
     meets), bitwise rerun, sweeps/s, peak memory; `segsum_by_id` at this
     shape against its plain version, timed beside its bound and one
     `index_add_`; then the bench scene
     forced to "rows" and "take1", 50 sweeps, within 1e-3 px of "table".
 11. linear path: the 1-D toy chain in float64 under message_form="pallas"
     on the card (kernel `fused_messages` at (1, 1, 1)), means against
     `oracle.map_solution` to 1e-9.
 12. kernel vs plain, unfused table kernels (csrc/unfused.cu): inside phase
     3, from the same states (8-cam and bench scene, float64 and float32) and
     on the 280-camera scene prepared without windows (float32: in float64
     its table is beyond the 48 KB the full-table kernels stage):
     `expand_ell_blk` (exact), `relin_cm_tab` in both regimes,
     `messages_cm_tab` with and without Huber; timed with their bounds at
     the bench scene, `expand_ell_blk` beside one `index_select`.
 13. kernel vs plain at the pose-graph shapes: every kernel at (3, 3, 3)
     with per-row Huber thresholds on Manhattan graphs after 11 plain sweeps
     (500 poses in float64 and 1,000 in float32: the largest tables that fit
     48 KB), fused, unfused, expanded operands in both layouts; the windowed
     kernels on the 1,500-pose graph; everything again at (6, 6, 6) on a
     250-pose SE(3) helix (its ELL layout groups by the first end of its
     factors, so slot 1 is the gathered one).
 14. unfused path: the bench scene with `prepare(ell_fused=False)`, 50 sweeps
     through `relin_cm_tab`, `messages_cm_tab`, `expand_ell_blk` and
     `segsum_by_id` (launch counts 50 each, plain calls 0), ARE within 1e-3 px
     of the fused run's, bitwise rerun, both timed side by side.
 15. pose path: a 4,000-pose Manhattan graph (f32) -> `prepare` (prints the
     mode it chose) -> 400 timed sweeps with `pose_graph.default_config()`
     (launch counts, plain calls 0, ATE finite and below the initial ATE,
     bitwise rerun), the Gauss-Newton ATE by `schur.solve_pcg` on the card,
     then 50-sweep chunks up to 6,000 sweeps until the ATE is at or below
     1.25 x ATE_GN + 0.02 (or the statement that it was not reached); 1,000
     poses in table mode fused and unfused (150 sweeps each, ATE finite,
     means equal to 1e-2 after them and to 1e-4 after one more sweep from
     the same state; the unfused path again with its camera-side sum in
     another order, the spread that float32 reassociation alone gives,
     printed) and the same generator's 500 poses in float64 (the paths'
     means equal to 1e-8 after 150 sweeps and after one), the 200-pose graph
     of the reference's float32 test (ATE below half the initial one);
     1,500 poses windowed against
     window=False (50 sweeps); a 250-pose SE(3) helix (100 sweeps); and
     data/manhattan_sim.g2o (full information matrices) through `read_g2o`,
     `build_g2o` and the generic engine, energy decreasing.
 16. the kernels' JSON line (each kernel's launches on its path, the worst
     absolute and relative error its checks measured, its times and
     bound), the card line, and the last line {"ok": true, "device": {...}}.
 17. kernel vs plain, windowed unfused kernels (csrc/unfused_win.cu): inside
     phase 4, from the same states (280 cameras in float64 and float32, the
     windows widened to 256 cameras in float64, city widened to 384 and city
     in float32) and inside phase 13 on the 1,500-pose graph at (3, 3, 3)
     with per-row thresholds: `relin_cm_tabblk` in both regimes,
     `messages_cm_tabblk` with and without Huber; timed with their bounds at
     the city scene; the launch plan of `messages_cm_tabblk` and, at city
     (and at venice in phase 19), its device time, bound and share.
 18. kernel vs plain, BAL models: on data/ladybug49_sim.txt.gz after 8 plain
     sweeps, float64 and float32, every relinearization and messages entry
     (full-table, unfused, expanded operands in both layouts, and the
     windowed fused and unfused entries with every tile's window holding
     all 49 cameras) with `bal_reprojection_normalized` and its per-row
     arguments at (6, 3, 2), and with `bal_reprojection_intrinsics` at
     (9, 3, 2).
 19. windowed unfused path: city and venice with `prepare(window=True,
     ell_fused=False)`, 50 sweeps through `relin_cm_tabblk`,
     `messages_cm_tabblk`, `expand_ell_blk`, `segsum_cm_blk` and
     `scatter_windows_cm` (launch counts 50 each, plain calls 0), ARE
     finite and falling; at city within 1e-3 px of the fused windowed run
     and a bitwise rerun; seconds per sweep beside the fused path's.
 20. BAL path: `python -m gbp_tpu_torch.ba --bal_file
     data/ladybug49_sim.txt.gz --n_iters 100 --oracle` in this process, with
     and without --optimize_intrinsics: launch counts 100, plain calls 0,
     final ARE <= 1.05x the dense-MAP ARE, the ARE every 10 sweeps beside
     the reference's CPU run, a bitwise rerun, sweeps/s; then
     data/corridor_sim.txt.gz with --prior_prec 1000 under the full default
     schedule in float32: ARE finite and falling.
 21. `run_annealed_cm` on the city scene, 50 sweeps through the windowed
     kernels: launch counts, ARE finite and below the initial one.
 22. kernel vs plain, the halo paths' windowed kernels (csrc/halo.cuh,
     kernels 12, 13, 17, 18): the merged-blocks scene of 1,280 cameras with
     8 landmarks each (float64, 1e-11) and the city scene (float32, 1e-4),
     both cut into 2 owner-sharded partitions (`halo_cm.distribute`, plain
     layout) after 8 plain sweeps on the CPU; per partition, on the
     operands its sweep hands them: `relin_cm_tabblkg_ell` and
     `relin_cm_tabblkg` in both relinearization regimes,
     `messages_cm_tabblkg_ell` and `messages_cm_tabblkg` with and without
     Huber; then the partition's gathered-slot sums of those messages,
     `segsum_cm_blk` on the owned-rows CSR and `scatter_windows_cm` (both
     held to equality) and `segsum_by_id` on the ghost rows; city again
     with every window widened to 384 cameras (64,512 bytes, dynamic
     shared memory); timed at city, partition 0; the launch
     plans of kernels 17 and 12 and, at
     city, partition 0, their device time, bound and share.
 23. halo paths, the P partitions in one process on the card through the
     single-process exchange: city at P = 2 through kernels 17, 18 and,
     unfused, 12, 13 (50 sweeps: launch counts P per sweep, plain calls 0,
     ARE finite, below the initial one and within 5e-3 px of the
     one-device run of phase 7, bitwise rerun, sweeps/s, collective bytes);
     city at P = 4 and venice at P = 4 (the mode `prepare` picks, 50 sweeps,
     ARE finite and falling, sweeps/s, peak memory);
     `python -m gbp_tpu_torch.slam --n_poses 4000 --n_iters 100 --n_chips 2`
     (launch counts, ATE finite and at or below the initial one, sweeps/s);
     `python -m gbp_tpu_torch.ba --bal_file data/ladybug49_sim.txt.gz
     --n_iters 100 --n_chips 2 --oracle`, final ARE within 1e-3 px of the
     same command on one device.
 24. the row-major kernels (staged through shared memory) on the generic
     engine's own operands: after min_linear_iters sweeps of `core.sweep`
     under message_form="pallas" on the card, the operands of the next
     sweep's `fused_relin_messages` (or `fused_messages`) call are recorded
     (the beliefs as views into packed rows: leading strides 48 and 15,
     lam 24 bytes into the row at (6, 3, 2) in float32) on the bench scene
     (float32), the 8-camera scene, ladybug49 with per-row distortion
     arguments and with 9-dof cameras, a 500-pose Manhattan graph (per-row
     Huber thresholds), data/manhattan_sim.g2o (full information), a
     120-pose SE(3) helix and the linear toy chain (float64 and float32):
     every shape (6, 3, 2), (9, 3, 2), (3, 3, 3), (6, 6, 6), (1, 1, 1).
     The relinearization at the sweep's beta and at the median distance,
     then the messages with diagonal, full and per-row-threshold precision,
     against the plain versions (float64 1e-11, float32 1e-4) and bit for
     bit against `relin_cm` / `messages_cm` on the transposed operands; the
     same on a prefix of the rows that fills no tile.  Per instantiation:
     rows per block, shared bytes, registers, local memory, blocks per SM
     (ptxas's spills are in the build lines); in
     float32 the device time, bound and share of kernels 19, 20 (and its
     relinearization, and the floor of its two kernels), 4 and 5 on those
     operands.
 25. schedules (core/schedules.py, parallel/schedules.py).  (a) Inside
     phases 3, 4, 8, 12, 17 (8-camera, bench, 280-camera and city scenes),
     22 (city cut in two, per partition) and 24 (bench and 8-camera
     scenes): every kernel that takes the act operand (1, 2, 4-13, 17-20)
     again with act = the validity mask x a priority mask (frac 0.25, from
     the operands' own means against a perturbed last_x) and x a
     Bernoulli(0.5) mask from a seeded generator: against its plain version
     (float64 1e-11, float32 1e-4), every inactive row returning its
     inputs (linearization point, Jacobian, residual, both messages) bit for
     bit and since_relin + 1; the camera-side sums of those messages
     (`segsum_by_id` against its plain version and repeated bit for bit,
     `segsum_cm_blk` and `scatter_windows_cm` equal to theirs).  (b) The
     runners at full width in float32: bench64 `run_wildfire_cm` with
     tau < 0 equal to `sweep_cm.run` bit for bit after 200 sweeps, then
     wildfire (tau 1e-4), priority (frac 0.5) and random (keep 0.7), 200
     sweeps each; city wildfire and priority, 50 sweeps; bench64 on the
     generic engine (message_form "pallas"), wildfire and priority, 50
     sweeps.  Each: the ARE (finite, below the initial one) and the first
     5-sweep chunk at or below 1.05x the Gauss-Newton MAP ARE, the mean
     active share, the runner equal bit for bit to the same sweeps stepped
     one by one, launch counts, kernel launches and device ms per sweep (the
     profiler) and sweeps/s beside the synchronous run's; a rerun of the
     random schedule from the same seed bit for bit.  City cut in two
     (`halo_cm.distribute`): `make_run_wildfire_cm` (ARE within 5e-3 px of
     the one-device wildfire run), `make_run_priority_cm(0.5)` and
     `make_run_chip_dropout_cm` (partition 1 dead for 15 sweeps: its factor
     state after sweep 15 equals its initial one but since_relin, which
     counts 15), 50 sweeps each.  Two sweeps of every runner under
     `torch.cuda.set_sync_debug_mode("warn")`: no more host
     synchronizations than two synchronous sweeps of the same scene.
 26. streaming (models/online.py, bench/serving.py): the serving corridor
     (120 cameras, 40 landmarks each, absolute arrivals, lag 16, 4 evicted
     at a time, 10 sweeps a frame, capacities 16 / 2,048 / 8,192).  (a)
     After 24 frames (two evictions) in float64 and float32 under
     message_form "pallas": kernel 3 on the online graph's device CSRs (the
     cameras' and landmarks' belief sums of the next sweep, the absorbed
     messages of an eviction) and kernel 20 at the sweep's beta and at the
     median distance, against their plain versions (float64 1e-11, float32
     1e-4; inert rows kept bit for bit, the sums repeating bit for bit);
     in float32 timed beside their bounds.  (b) 24 frames captured (each
     variant one CUDA graph) against eager, bit for bit, in both message
     forms, and two captured runs equal; the launches of the warm-ups and
     captures counted.  (c) four steady frames' staging and replay under
     `torch.cuda.set_sync_debug_mode("error")`.  (d) `serving.serve` at
     full width, 120 absolute and 240 odometry frames: frames/s captured and
     eager, p50 / p95 latency, kernels, launch calls and device ms per frame
     (the profiler), ARE median / max / final, at most 3 graphs (and the
     absolute stream again under message_form "pallas"); the 120-frame
     stream's median ARE below 2.5 px and its last 10 frames below 1.25x the
     median + 0.5, or, where the reference's own stream of this
     configuration misses that bound too (`REFERENCE_SERVING_CPU`), below
     the same margin over the reference's tail.
 27. utilities (utils/checkpoint.py, utils/profiling.py).  (a) Saved after 9
     sweeps (past the first relinearization), restored into a fresh
     template and resumed for 3 sweeps, equal bit for bit to 3 sweeps from
     the state before saving, each resume through its kernels (launch
     counts): the generic engine on the bench scene under message_form
     "pallas" (kernels 20, 19, 3), the fast path at the bench scene through
     `sweep_cm.from_gbp_state` (kernels 1-3), and the halo path at city cut
     in two (`halo_cm.distribute`, P = 2).  (b) The fast path's state saved
     on the card restored into a CPU template and, saved there, restored
     into the card template: every leaf equal.  (c) `time_sweeps` of 200
     fast-path sweeps at the bench scene (sweeps/s by CUDA events).  (d)
     `profiling.trace` of 3 fast-path sweeps: the Chrome trace's kernel
     events name `relin_kernel`, `messages_kernel` and the `segsum` kernels
     (the profiler can drop some device records: up to 3 traces, until
     each is named).
 28. structure from motion from pixels (frontend/, examples/
     sfm_from_pixels.py).  (a) The example on the card: 6 cameras, 120
     landmarks rendered at 240 x 320, Harris + ZNCC tracks, the essential +
     PnP bootstrap, 60 generic sweeps: all 6 cameras registered and the ARE
     below 1.5 px (the reference test's bound), the counts printed beside
     the reference's own CPU run (`REFERENCE_SFM_CPU`), kernel 3's launches
     counted.  (b) The same bootstrapped problem (layout "ell") for 60
     sweeps under message_form "pallas" (kernels 20, 19, 3) and through
     `sweep_cm.prepare` (kernels 1-3): each below 1.5 px.  (c) The
     frontend's time per frame (CUDA events) at 64 frames of 480 x 640, 3,000
     landmarks, max_corners 1,024: rendering, detection, description,
     matching per pair, and `build_tracks` end to end.  (d) `triangulate` of
     the bench scene's 469,861 observations twice on the card: equal bit
     for bit, and to 1e-9 of the CPU's.
 29. several processes (parallel/multihost.py, spmd.py, sharding.py, the
     sharded Schur step).  Two ranks spawned on the card, joined in a gloo
     group (NCCL takes one rank a card; CUDA tensors are staged through
     pinned host memory), each running on its own partitions: (a) city
     cut in two (one partition a rank), 50 halo_cm sweeps through kernels
     17, 18, 16, 15, 3, once a sweep each on each rank; (b) city cut in
     four (two a rank); both collected means equal the one-process run on
     the same partitions bit for bit (or, printing why not, within 1e-6
     relative).  (c) In this process, a one-rank NCCL group holding both
     partitions of city cut in two: all_gather, all_reduce and shift equal
     `halo.LocalComm` bit for bit, and so do 50 halo_cm sweeps.  (d) bench64
     (float32, message_form "pallas") through `spmd` and through
     `sharding` on the two ranks, 50 sweeps: ARE within 1e-3 px of the
     one-device generic run; kernels 20 and 19 once a sweep, 3 once per
     slot into a block without a dense inbox.  (e) The float64 bench64
     Schur step (100 CG iterations) on the two ranks within 1e-9 relative
     of the one-device step.  Per rank: sweeps/s, launches per sweep, bytes
     through the communicator per sweep beside `halo.collective_bytes`,
     and the host staging's bytes and time.  A rank that fails, or runs past
     MP_TIMEOUT_S, fails the phase.
 30. the degree-class segmented layout (`sweep_cm.prepare_seg`,
     `prepare(segment=True)`).  (a) Per class, each class's kernels against
     their plain versions on the state after 8 sweeps (windowed: 11, 10
     with and without Huber, 16 and 15 bit for bit; whole table: 1, 2, 3):
     city (auto, three windowed classes of degree 6, 5, 4) and blocks7
     (exact, three windowed and two unwindowed classes) in float32;
     blocks8 (auto, two windowed) and the reference's segmented test scene
     (exact, five unwindowed) in float64, where blocks7's declines (its
     camera table exceeds the full-table kernels' 48 KB).  (b) City through
     `prepare(segment=True)`: 50 sweeps launch 11, 10, 16, 15 three times
     a sweep and no plain version; the ARE within 5e-3 px of the single
     segment's; a bitwise rerun.  (c) City and venice, segmented and single
     segment in one call: sweeps/s (8 pairs of runs in alternating order,
     after a warm one; every run printed, the median and the pairs'
     ratios), kernel launches and device ms per sweep (the profiler), busy
     share.
 31. cameras in the ELL slot (graphs with more cameras than landmarks: the
     landmarks gathered, slot 1, at (6, 3, 2) and (9, 3, 2)).  (a) Float64
     and float32, every table kernel against its plain version at slot 1:
     windowed fused (11, 10, 16, 15) and unfused (9, 8, 14), and with the
     windows off the whole-table fused (1, 2, 3) and unfused (7, 6, 14)
     kernels, on 640 cameras with a quarter of their landmarks
     (`bench.dense_cameras`) as reprojection and as a BAL problem
     (`bench.bal_scene`, per-row distortion and 9-dof cameras), the 16 x 12
     scene in float64; the halo kernels 17, 18, 12, 13 per partition of
     1,920 such cameras cut in two, as reprojection and 9-dof BAL.  (b) `python -m
     gbp_tpu_torch.ba --n_cams 16 --n_lmks 12 --oracle`, with and without
     `--n_chips 2`: kernels 1, 2 and 3 once a sweep on each partition and
     no other launch or plain call (counted), the final ARE within 1.05x
     the dense MAP's.
 32. the benchmark layer (gbp_tpu_torch/bench: headline, convergence,
     per_chip_rate, scaling, window_profile; utils/capture.py).  (a)
     `python -m gbp_tpu_torch.bench` in its own process: bench.py's six
     keys, 469,861 factors, vs_baseline from the cached baseline, a finite
     wall-clock to 1.05x the MAP ARE, and its captured sweeps/s above the
     eager rate it logs.  (b) In this process, the headline's measurement:
     the captured 200 sweeps equal the eager 200 from the same state bit for
     bit, the ARE after 200 sweeps within 1.05x the MAP ARE, reached at
     sweep 10 or one chunk from it; one replay of the 5-sweep chunk against
     5 eager sweeps by the profiler (the port's kernels as often, one launch
     call), device ms and busy share a sweep both ways.  (c) convergence,
     per_chip_rate (one partition's ARE within 5e-3 px of plain CM's),
     scaling (1, 2 and 4 partitions, paths halo and halo_cm: every column
     finite) and window_profile (fused and unfused: every stage finite),
     each through its `main`.
 33. the belief update (`ops.messages.update_beliefs`, csrc/beliefs.cu) on
     the operands a sweep hands it at bench64 (8,000 landmarks and 7,999:
     one padding landmark) and at the venice1778 cell's scene (BAL
     Venice-1778's counts, ELL degree 6), float32: the kernel against its
     plain version on the card (eta, lam and mean to the float32 tolerance),
     a rerun bit for bit; its launch plan, wrapper ms, device ms, bound ms
     (every operand it reads and writes once over 3.35 TB/s) and share.
"""
import contextlib
import dataclasses
import json
import math
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import gbp_tpu_torch
from gbp_tpu_torch import ba as ba_cli
from gbp_tpu_torch import slam as slam_cli
from gbp_tpu_torch import bench
from gbp_tpu_torch.bench import BIG_BUILD as BIG
from gbp_tpu_torch.bench import CFG, CITY, VENICE, card_line
from gbp_tpu_torch.bench import compare_sums as CS
from gbp_tpu_torch.bench import compare_windows as CW
from gbp_tpu_torch.bench import convergence, headline, per_chip_rate, scaling, window_profile
from gbp_tpu_torch.bench import serving
from gbp_tpu_torch.core import anneal, oracle, schedules, sweep, sweep_cm
from gbp_tpu_torch.core.sweep import _kernel_params
from gbp_tpu_torch.examples import sfm_from_pixels as sfm_example
from gbp_tpu_torch.frontend import features, pipeline
from gbp_tpu_torch.io import bal, g2o
from gbp_tpu_torch.models import ba, online, pose_graph, toy
from gbp_tpu_torch.ops import _build
from gbp_tpu_torch.ops import messages as M
from gbp_tpu_torch.parallel import halo, halo_cm, multihost, schur, sharding, spmd
from gbp_tpu_torch.parallel import schedules as halo_schedules
from gbp_tpu_torch.utils import checkpoint, profiling

SWEEPS = 200
QUALITY_SWEEPS = 50  # corridor scenes: the plain schedule is taken at 50 sweeps
BENCH = dict(n_cams=64, n_lmks=8000, pix_sigma=1.0, seed=0)
SMALL = dict(n_cams=8, n_lmks=120, seed=0)
BLOCKS7 = dict(n_blocks=7, n_cams=40, lmks_per_cam=20, window=3, seed=0, shuffle=True)
TOL = {torch.float64: 1e-11, torch.float32: 1e-4}
# Phase 25 (a): the scenes whose act-taking kernels are held against their
# plain versions under partial schedule masks (check_kernels' tags, then the
# generic engine's, phase 24).
SCHEDULE_SCENES = ("8cam", "64cam", "280cam", "city")
SCHEDULE_STAGED = ("bench64", "8cam")
# One sweep of the fused paths: the messages launches return the camera-side
# sum themselves (kernel 2 with its combine, kernel 10 its window partials).
FULL = ("relin_cm_tab_ell", "messages_cm_tab_ell")
WINDOWED = ("relin_cm_tabblk_ell", "messages_cm_tabblk_ell", "scatter_windows_cm")
ROWS = ("messages_cm", "relin_cm", "fused_messages", "fused_relin_messages")
UNFUSED = ("relin_cm_tab", "messages_cm_tab", "expand_ell_blk")
UNFUSED_WIN = ("relin_cm_tabblk", "messages_cm_tabblk")
# The belief update, once a sweep on a single-segment graph whose two slots
# lie on two variable blocks (bundle adjustment), whatever the gather mode.
BELIEFS = ("update_beliefs",)
# One sweep of the windowed unfused path.
UNFUSED_WIN_PATH = (*UNFUSED_WIN, "expand_ell_blk", "segsum_cm_blk", "scatter_windows_cm")
ROWS_MODE = ("relin_cm", "messages_cm", "segsum_by_id", "expand_ell_blk")
HALO_KERNELS = ("relin_cm_tabblkg_ell", "messages_cm_tabblkg_ell", "relin_cm_tabblkg",
                "messages_cm_tabblkg")
# One partition's sweep of the windowed halo path, fused and unfused.
HALO_FUSED_PATH = ("relin_cm_tabblkg_ell", "messages_cm_tabblkg_ell", "segsum_cm_blk",
                   "scatter_windows_cm", "segsum_by_id")
HALO_UNFUSED_PATH = ("relin_cm_tabblkg", "messages_cm_tabblkg", "expand_ell_blk",
                     "segsum_cm_blk", "scatter_windows_cm", "segsum_by_id")
# The halo paths partition the plain layout (the command lines' choice).
HALO_BUILD = dict(layout="none", cam_prior_prec=1000.0, lmk_prior_prec=1000.0)
HALO_BLOCKS = dict(n_blocks=32, n_cams=40, lmks_per_cam=8, window=3, seed=0, shuffle=True)
NONLOCAL = dict(n_cams=512, n_lmks=2000, pix_sigma=1.0, seed=0)
# Manhattan pose graphs: the kernel checks' (500 poses fill the 48 KB table
# in float64, 1,000 in float32), the windowed one, the pose path's.
M500 = dict(n_poses=500, seed=0, loop_prob=0.3, loop_radius=3.0, outlier_frac=0.1)
M1000 = dict(n_poses=1000, seed=0, loop_prob=0.3, loop_radius=3.0)
# Its float64 counterpart in table mode: 500 poses (a float64 table of 1,000
# exceeds SMEM_TABLE_BYTES).
M1000_F64 = {**M1000, "n_poses": 500}
# Fused against unfused float32 means after 150 sweeps of manhattan1000.  The
# two paths add the camera-side sum in different orders, and the transient
# amplifies float32 reassociation: on an H100 the gap was 2.7e-3, and the
# unfused path against itself with its sum in a third order (printed by
# phase 15) 2.8e-3; the bar is set from those readings (PERF.md).  float64
# holds the paths themselves to POSE_F64_TOL.
POSE_F32_GAP = 1e-2
POSE_F64_TOL = 1e-8
M1500 = dict(n_poses=1500, seed=4, loop_prob=0.5, loop_radius=3.0)
M4000 = dict(n_poses=4000, seed=0, loop_prob=0.3, loop_radius=3.0)
HELIX = dict(n_poses=250, seed=0)
M200 = dict(n_poses=200, seed=1, loop_prob=0.5, loop_radius=3.0)
# Sweeps before a pose graph's kernel checks: with min_linear_iters = 5 rows
# relinearize in sweep 6 and are eligible again from sweep 12 on.
POSE_WARM = 11
DATA = Path(__file__).resolve().parent / "data"
G2O_FILE = DATA / "manhattan_sim.g2o"
LADYBUG = DATA / "ladybug49_sim.txt.gz"
CORRIDOR = DATA / "corridor_sim.txt.gz"
# The reference's command line on ladybug49 (`python ba.py --bal_file
# data/ladybug49_sim.txt.gz --n_iters 100 --oracle`, JAX on a CPU in float32,
# Pallas in interpret mode): the ARE every 10 sweeps, printed beside the
# port's for comparison, not held.
LADYBUG_REFERENCE_CPU = {"": {0: 21.3756, 10: 1.2461, 20: 1.2331, 50: 1.2325, 100: 1.2323},
                         "--optimize_intrinsics": {0: 21.3756, 10: 1.2511, 20: 1.2345,
                                                   50: 1.2338, 60: 1.2337}}
PCFG = pose_graph.default_config()
SOURCE = {**dict.fromkeys(FULL, "gbp_tpu_torch/csrc/messages.cu"),
          "segsum_by_id": "gbp_tpu_torch/csrc/segsum.cu",
          **dict.fromkeys((*WINDOWED, "segsum_cm_blk"), "gbp_tpu_torch/csrc/windows.cu"),
          **dict.fromkeys(ROWS, "gbp_tpu_torch/csrc/rows.cu"),
          **dict.fromkeys(UNFUSED, "gbp_tpu_torch/csrc/unfused.cu"),
          **dict.fromkeys(UNFUSED_WIN, "gbp_tpu_torch/csrc/unfused_win.cu"),
          **dict.fromkeys(HALO_KERNELS, "gbp_tpu_torch/csrc/halo.cuh"),
          "update_beliefs": "gbp_tpu_torch/csrc/beliefs.cu"}
REPLACES = {
    "relin_cm_tab_ell": "gbp_tpu/ops/messages_pallas.py:1118",
    "messages_cm_tab_ell": "gbp_tpu/ops/messages_pallas.py:1054",
    "segsum_by_id": "gbp_tpu/ops/messages_pallas.py:646",
    "relin_cm_tabblk_ell": "gbp_tpu/ops/messages_pallas.py:1221",
    "messages_cm_tabblk_ell": "gbp_tpu/ops/messages_pallas.py:1162",
    "segsum_cm_blk": "gbp_tpu/ops/messages_pallas.py:1588",
    "scatter_windows_cm": "gbp_tpu/ops/messages_pallas.py:1562",
    "messages_cm": "gbp_tpu/ops/messages_pallas.py:372",
    "relin_cm": "gbp_tpu/ops/messages_pallas.py:404",
    "fused_messages": "gbp_tpu/ops/messages_pallas.py:1796",
    "fused_relin_messages": "gbp_tpu/ops/messages_pallas.py:1871",
    "messages_cm_tab": "gbp_tpu/ops/messages_pallas.py:446",
    "relin_cm_tab": "gbp_tpu/ops/messages_pallas.py:491",
    "expand_ell_blk": "gbp_tpu/ops/messages_pallas.py:1469",
    "messages_cm_tabblk": "gbp_tpu/ops/messages_pallas.py:734",
    "relin_cm_tabblk": "gbp_tpu/ops/messages_pallas.py:787",
    "messages_cm_tabblkg": "gbp_tpu/ops/messages_pallas.py:1348",
    "relin_cm_tabblkg": "gbp_tpu/ops/messages_pallas.py:1396",
    "messages_cm_tabblkg_ell": "gbp_tpu/ops/messages_pallas.py:1700",
    "relin_cm_tabblkg_ell": "gbp_tpu/ops/messages_pallas.py:1748",
    # The port's own kernel: the reference updates beliefs in XLA.
    "update_beliefs": "gbp_tpu/core/sweep_cm.py (XLA, no Pallas kernel)",
}
# The card's published peaks (H100 SXM data sheet): device memory rate and
# float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# Arithmetic per factor row, counted from csrc/messages_rows.cuh: the
# distance test of every row (27) and Rodrigues + the 2x9 Jacobian of a
# relinearizing row (about 300); two cavity inverses (6x6 about 430, 3x3 about
# 70), their projections (about 420) and the two emitted messages (about 520).
RELIN_TEST_FLOPS, RELIN_ROW_FLOPS, MESSAGES_ROW_FLOPS = 27, 300, 1440
# Leave the timed venice sweeps out beyond this many seconds of script time.
VENICE_TIMING_DEADLINE_S = 700.0
T_START = time.perf_counter()
# The worst relative error each kernel's checks measured (every scene, dtype
# and mask), for the closing JSON line beside the worst absolute one.
REL_ERRS = {}


def note_rel(name, rel):
    REL_ERRS[name] = max(REL_ERRS.get(name, 0.0), rel)


def to_device(obj, device):
    """Move every tensor of a (nested) NamedTuple/tuple state to `device`."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, tuple):
        items = [to_device(o, device) for o in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    return obj


def rel_err(got, ref):
    """(max |got - ref| / max |ref|, max |got - ref|)."""
    err = float((got - ref).abs().max())
    return err / max(float(ref.abs().max()), 1e-300), err


def exact(name, got, ref, tag):
    """Hold a kernel to equality bit for bit (max abs err 0.0)."""
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    print(f"[kernels] {tag} {name}: max abs {err:.3e} (held to equality)")
    if not torch.equal(got, ref):
        raise AssertionError(f"{name} {tag}: not equal bit for bit (max abs {err:.3e})")
    note_rel(name, 0.0)


def sync(x):
    torch.cuda.synchronize()
    return x


def time_ms(fn, n):
    """Mean ms per call over n calls, by CUDA events, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def profiled_ms(fn, n=20):
    """{kernel name: [device ms of each launch]} of `fn`'s kernels over n
    calls, by the profiler, after one warm call; in a new window while it
    recorded no launch (it may drop a window's device records)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                out.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
        if out:
            return out
    raise RuntimeError("the profiler recorded no launch in 5 windows")


def device_ms(fn, n=20):
    """Mean device ms per call of every kernel `fn` launches, over n calls,
    by the profiler (an events time of a short kernel is the wrapper's host
    time), after one warm call."""
    return sum(sum(ts) for ts in profiled_ms(fn, n).values()) / n


def bound_ms(inputs, outputs, flops, nbytes=None):
    """(ms, "bytes" | "operations"): the least time the card could take, the
    larger of every input read once and every output written once over the
    memory rate (or `nbytes`, where the function reads only part of its
    inputs), and `flops` over the float32 rate."""
    if nbytes is None:
        nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs)
                     if isinstance(t, torch.Tensor))
    by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def segsum_bound_ms(seg_args, out):
    """`bound_ms` of `segsum_by_id` (component-major): the rows its CSR
    lists, each of the f components read once, the CSR read once and the
    output written once; one addition per listed row and component."""
    me, ml, seg_rows, seg_offsets = seg_args
    n, f = int(seg_offsets[-1]), out.shape[0]
    nbytes = (n * f * me.element_size() + (n + seg_offsets.numel()) * 4
              + out.numel() * out.element_size())
    return bound_ms(seg_args, (out,), f * n, nbytes)


def are_px(graph, cmg, state, k):
    return float(ba.avg_reprojection_error(graph, sweep_cm.to_gbp_state(cmg, state), k=k))


def check_counts(what, names, sweeps):
    """The kernels `names` were launched `sweeps` times each (or, given a
    dict, its count times `sweeps`), the others not at all, and no plain
    version ran; returns the launch counts."""
    launches, plain = dict(M.COUNTS.kernel), dict(M.COUNTS.plain)
    per = names if isinstance(names, dict) else dict.fromkeys(names, 1)
    want = {k: sweeps * per.get(k, 0) for k in M.KERNELS}
    if launches != want or any(plain.values()):
        raise AssertionError(f"{what} did not run through its kernels: launches {launches} "
                             f"(expected {want}), plain calls {plain}")
    if launches["segsum_by_id"]:
        print(f"[forms] {what}: segsum_by_id {dict(M.COUNTS.segsum_forms)}")
    return launches


def print_plan(tag, name, dtype, **kw):
    """Phases 4, 17, 22: how a windowed messages kernel launches here
    (`M.window_plan`): its persistent grid, shared memory, registers."""
    p = M.window_plan(name, dtype, **kw)
    print(f"[kernels] {tag} {name} plan: {p['units']} units of {p['unit_rows']} rows on "
          f"{p['blocks']} blocks, {p['smem_bytes']} shared bytes, {p['registers']} registers, "
          f"{p['local_bytes']} local bytes, {p['blocks_per_sm']} blocks per SM")


def report_window_kernel(tag, name, args, kw):
    """The device time, bound and share of a windowed messages kernel on
    these operands (`compare_windows.kernel_report`)."""
    print(f"[kernels] {tag} on the device (profiler): "
          f"{CW.report_line(name, CW.kernel_report(name, args, kw))} ({card_line()})")


def hold_segsum_blk(tag, part, me, ml, win_rows, win_offsets):
    """Kernel 16's partials `part` of me | ml against the plain version on
    CPU copies of the operands: equal bit for bit (the kernel adds each
    segment in CSR order, as the plain version does on the CPU)."""
    n_tiles, _, w = part.shape
    ref = M.segsum_cm_blk_plain(me.cpu(), ml.cpu(), win_rows.cpu(), win_offsets.cpu(),
                                n_tiles=n_tiles, w=w)
    exact("segsum_cm_blk", sync(part), ref.to(part.device), f"{tag} (plain on the CPU)")


def report_segsum_blk(tag, me, ml, win_rows, win_offsets, n_tiles, w):
    """Kernel 16's launch plan (`M.segsum_blk_plan`), device time by the
    profiler, bound and share on these operands
    (`compare_sums.segsum_blk_report`)."""
    r = CS.segsum_blk_report(me, ml, win_rows, win_offsets, n_tiles=n_tiles, w=w)
    p = r["plan"]
    print(f"[kernels] {tag} segsum_cm_blk plan: {p['comps_per_block']} components per item, "
          f"{p['groups']} items per tile, {p['items']} items on {p['blocks']} blocks of "
          f"{p['threads']} threads, {p['smem_bytes']} shared bytes, {p['registers']} registers, "
          f"{p['local_bytes']} local bytes, {p['blocks_per_sm']} blocks per SM")
    print(f"[kernels] {tag} segsum_cm_blk on the device (profiler): {r['device_ms']:.4f} ms "
          f"({r['launches']} launches profiled), bound {r['bound_ms']:.4f} ms, share "
          f"{r['share']:.3f}, equal to the plain version on the CPU: {r['equals_plain']}, "
          f"output {r['digest']} ({card_line()})")
    if not r["equals_plain"]:
        raise AssertionError(f"segsum_cm_blk {tag}: not equal to the plain version")


def fold_ops(cmg, cam_tab, gslot):
    """`hold_fold`'s operands of a single-segment CMGraph (`table_ops` has
    them too)."""
    return dict(gslot=gslot, mp=cmg.mp, z=cmg.z, cam_tab=cam_tab, win_w=cmg.win_w,
                win_rows=cmg.win_rows, win_offsets=cmg.win_offsets, seg_rows=cmg.seg_rows,
                seg_offsets=cmg.seg_offsets)


def hold_fold(tag, dtype, got, o, again=None, huber=None):
    """Kernels 2 and 10 return the camera-side sum themselves: the fifth
    output `got[4]` of their wrappers on the operands `o` equals the model of
    the kernel's order at this card's launch plan (`M.fold_table_sum`,
    `M.fold_window_sum` on CPU copies) bit for bit; with `again`, a second
    run gives the same bits.  Prints the plan: grid, registers, local bytes,
    blocks per SM, the warps' slots in shared memory."""
    g, mp = o["gslot"], o["mp"]
    me, ml = got[2 * g], got[2 * g + 1]
    shape = dict(d0=got[0].shape[0], d1=got[2].shape[0], z=o["z"].shape[0], gslot=g,
                 huber=huber)
    extra = ""
    if o["win_w"]:
        name, n_tiles, w = "messages_cm_tabblk_ell", mp // M.TILE, o["win_w"]
        plan = M.window_plan(name, dtype, win_w=w, mp=mp, **shape)
        csr = (me.cpu(), ml.cpu(), o["win_rows"].cpu(), o["win_offsets"].cpu())
        if plan["folded"]:
            model = M.fold_window_sum(*csr, n_tiles=n_tiles, w=w, threads=plan["threads"])
            extra = "; folded, whole tiles a block"
        else:
            model = M.segsum_cm_blk_plain(*csr, n_tiles=n_tiles, w=w)
            extra = "; not folded: kernel 16 after the launch"
    else:
        name = "messages_cm_tab_ell"
        plan = M.table_plan(dtype, n_cam=o["cam_tab"].shape[0],
                            n_seg=o["seg_offsets"].shape[0] - 1, mp=mp, **shape)
        model = M.fold_table_sum(me.cpu(), ml.cpu(), o["seg_rows"].cpu(), o["seg_offsets"].cpu(),
                                 blocks=plan["blocks"], unit_rows=plan["unit_rows"])
    if not torch.equal(got[4].cpu(), model):
        raise AssertionError(f"{name} {tag}: the fifth output is not the model of the kernel's "
                             f"order (max abs {float((got[4].cpu() - model).abs().max()):.3e})")
    if again is not None:
        if not all(torch.equal(a, b) for a, b in zip(got, sync(again()))):
            raise AssertionError(f"{name} {tag}: two runs differ")
        extra += "; two runs bitwise equal"
    print(f"[fold] {tag} {name}: fifth output ({plan['units']} units "
          f"of {plan['unit_rows']} rows on {plan['blocks']} blocks of {plan['threads']} "
          f"threads, split every {plan['split_rows']} rows, {plan['registers']} registers, "
          f"{plan['local_bytes']} local bytes, {plan['smem_bytes']} shared bytes, "
          f"{plan['blocks_per_sm']} blocks per SM, {plan['slab_slots']} slots a warp in shared "
          f"memory ({plan['slab_bytes']} bytes)) equal to the model of its order bit for "
          f"bit{extra}")
    return plan


@contextlib.contextmanager
def plain_versions(names=WINDOWED):
    """Inside, `sweep_cm.sweep` calls the plain versions of the kernels
    `names` (the windowed ones) whatever the device: the reference run
    beside the kernels' run."""
    saved = {name: getattr(sweep_cm, name) for name in names}
    try:
        for name in saved:
            setattr(sweep_cm, name, scatter_plain if name == "scatter_windows_cm"
                    else getattr(M, name + "_plain"))
        yield
    finally:
        for name, fn in saved.items():
            setattr(sweep_cm, name, fn)


def scatter_plain(part, win_starts, blk_tiles, blk_offsets, *, n_seg):
    """`scatter_windows_cm`'s plain version on the kernel's arguments: it
    walks the cover lists, built from the starts, not the block lists."""
    return M.scatter_windows_cm_plain(
        part, win_starts, *M.cover_lists(win_starts, part.shape[2], n_seg), n_seg=n_seg)


def cpu_state(sim, dtype, build_kw, prep_kw):
    """The state after 8 plain sweeps on the CPU (in resident order)."""
    g_cpu, m_cpu = ba.build(sim, dtype=dtype, device="cpu", **build_kw)
    cmg_cpu = sweep_cm.prepare(g_cpu, **prep_kw)
    return sweep_cm.run(cmg_cpu, sweep_cm.init_state(cmg_cpu, m_cpu), CFG, 8)


def widened(cmg, w):
    """`cmg` with every camera window widened to `w` (starts moved down where
    the wider window would pass the padded camera count): still a valid
    windowing, at the shared-memory sizes of wider scenes."""
    dev = cmg.gidx.device
    starts = np.minimum(cmg.win_starts.cpu().numpy(), cmg.win_ncpad - w) // sweep_cm.SUB \
        * sweep_cm.SUB
    if w > cmg.win_ncpad or (starts < 0).any():
        raise ValueError(f"a window of {w} does not fit {cmg.win_ncpad} cameras")
    rows, offsets = M.window_rows_csr(cmg.gidx.cpu().numpy(), starts, w)
    blk_tiles, blk_offsets = M.window_block_csr(starts, w, cmg.base.vblocks[0].count)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    return cmg._replace(win_w=w, win_starts=i32(starts), win_rows=i32(rows),
                        win_offsets=i32(offsets), blk_tiles=i32(blk_tiles),
                        blk_offsets=i32(blk_offsets))


def table_ops(cmg, st):
    """The table kernels' operands of a single-segment CMGraph and its state
    (`sweep_cm.belief_tables`): what `check_table_kernels` and the unfused
    checks take, as `seg_ops` gives them for a degree class."""
    cam_mean, lmk_mean, cam_tab, lmk_tab = sweep_cm.belief_tables(cmg, st)
    fb = cmg.fb
    return dict(gslot=1 - fb.ell_slot, deg=fb.ell_deg, mp=cmg.mp, gidx=cmg.gidx, z=cmg.z,
                prec=cmg.prec, act=cmg.act, args=cmg.args, comp_name=fb.ftype.name,
                win_w=cmg.win_w, win_starts=cmg.win_starts, win_rows=cmg.win_rows,
                win_offsets=cmg.win_offsets, blk_tiles=cmg.blk_tiles, blk_offsets=cmg.blk_offsets,
                seg_rows=cmg.seg_rows, seg_offsets=cmg.seg_offsets, seg_ids=cmg.seg_ids,
                cam_mean=cam_mean, cam_tab=cam_tab, lmk_mean=lmk_mean, lmk_tab=lmk_tab,
                fs=st.f)


def make_compare(tag, tol, errs):
    """`compare(name, got, ref, record=True, key=None)`: hold every output to
    the relative tolerance `tol` and file the worst abs error in `errs`;
    `key` files it under a kernel's name and prints one line for the call,
    not one per output."""
    def compare(name, got, ref, record=True, key=None):
        worst_rel, worst_abs = 0.0, 0.0
        for i, (a, b) in enumerate(zip(got, ref)):
            rel, err = rel_err(a, b)
            if key is None:
                print(f"[kernels] {tag} {name} out{i}: max abs {err:.3e} rel {rel:.3e}")
            if not rel <= tol:
                raise AssertionError(f"{name} {tag} out{i}: rel err {rel:.3e} > {tol:g}")
            worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, err)
        if key is not None:
            print(f"[kernels] {tag} {name}: {len(got)} outputs, max abs {worst_abs:.3e} rel "
                  f"{worst_rel:.3e}")
        if record:
            errs[key or name] = max(errs.get(key or name, 0.0), worst_abs)
            note_rel(key or name, worst_rel)
    compare.errs = errs
    return compare


def check_kernels(tag, sim, dtype, dev, build_kw, timings=None, wide=None, prep_kw=None):
    """Phases 3 and 4 for one scene and dtype: the full-table kernels when
    the prepared graph has no windows, the windowed ones when it has (with
    the windows widened to `wide` cameras, if given), then the row kernels
    and the unfused ones on the same state.
    Returns {kernel: max abs err}."""
    masked = tag in SCHEDULE_SCENES
    prep_kw = prep_kw or {}
    st = to_device(cpu_state(sim, dtype, build_kw, prep_kw), dev)
    cmg = sweep_cm.prepare(ba.build(sim, dtype=dtype, **build_kw)[0], **prep_kw)
    if wide:
        cmg = widened(cmg, wide)
    tag = f"{tag} {str(dtype)[6:]}"
    errs = {}
    compare = make_compare(tag, TOL[dtype], errs)
    o = table_ops(cmg, st)
    if cmg.win_w:
        print(f"[kernels] {tag}: {cmg.mp // M.TILE} tiles, win_w {cmg.win_w} "
              f"({cmg.win_w * M.F_CAM * o['cam_tab'].element_size()} bytes of packed beliefs "
              f"per block), locality sort {'on' if cmg.vperm is not None else 'off'}")
    ref_r, acts, _ = check_table_kernels(tag, o, dtype, compare, timings, masked)
    if cmg.win_w:
        check_unfused_win_kernels(tag, o, dtype, compare, timings, acts)
    else:
        check_row_kernels(tag, cmg, st, ref_r, dtype, compare, timings, acts)
        check_unfused_kernels(tag, o, dtype, compare, timings, acts)
    return errs


def check_table_kernels(tag, o, dtype, compare, timings=None, masked=False):
    """The fused table kernels of one graph or degree class against their
    plain versions on its operands `o` (`table_ops`, `seg_ops`), at either
    gathered slot: windowed, 11, 10 (Huber off and 1.0), 16 and 15 bit for
    bit (16 against the plain version on CPU copies) and against the
    whole-table sum where `o` has its CSR; whole table, 1, 2 and 3;
    relinearization at the median distance (half the rows relinearize) and
    at the config's beta; each sum repeated bit for bit.  With `masked`
    (phase 25 (a)) 1, 2 or 11, 10 again under partial masks.  `timings`
    collects each kernel's times for the JSON line.  Returns (the
    relinearized state at the config's beta, the masks, {kernel: a call on
    these operands})."""
    g, deg, fs = o["gslot"], o["deg"], o["fs"]
    dev = o["gidx"].device
    win = bool(o["win_w"])
    params = _kernel_params(CFG, dtype)
    n_cam = o["cam_mean"].shape[0]
    model = dict(comp_name=o["comp_name"], gslot=g, fargs=o["args"])

    def repeats(name, fn, args, kw, first):
        if not torch.equal(first, sync(fn(*args, **kw))):
            raise AssertionError(f"{name} {tag}: two runs differ")
        print(f"[kernels] {tag} {name}: two runs bitwise equal")

    if win:
        n_relin_name, n_msg_name = "relin_cm_tabblk_ell", "messages_cm_tabblk_ell"
        ids, r_kw = (o["gidx"], o["win_starts"]), dict(deg=deg, win_w=o["win_w"])
        sum_index = (o["win_rows"], o["win_offsets"])
    else:
        n_relin_name, n_msg_name = "relin_cm_tab_ell", "messages_cm_tab_ell"
        ids, r_kw = (o["gidx"],), dict(deg=deg)
        sum_index = (o["seg_rows"], o["seg_offsets"])
    relin, relin_plain = getattr(M, n_relin_name), getattr(M, n_relin_name + "_plain")
    msgs, msgs_plain = getattr(M, n_msg_name), getattr(M, n_msg_name + "_plain")
    # Kernel 2 reads the CSR as the graph's per-row map.
    m_kw = dict(gslot=g, **r_kw, **({} if win else dict(seg_ids=o["seg_ids"])))
    r_kw = dict(model, **r_kw)

    # The median linearization-point distance of the valid rows, as beta,
    # makes half of them relinearize: the beta decision is checked both ways.
    rows = torch.arange(o["mp"], device=dev) // deg
    by_slot = lambda gat, ell: (gat, ell) if g == 0 else (ell, gat)
    x = torch.cat(by_slot(o["cam_mean"][o["gidx"].long()], o["lmk_mean"][rows]), 1).T
    on = o["act"][0] > 0.5
    beta_mid = float(((x - fs.lp) ** 2).sum(0).sqrt()[on].double().median())
    n_valid = int(on.sum())
    for beta in (beta_mid, CFG.beta):  # the config's beta last: its outputs feed on
        relin_args = (_kernel_params(dataclasses.replace(CFG, beta=beta), dtype), o["cam_mean"],
                      o["lmk_mean"], *ids, o["z"], fs.lp, fs.jac, fs.r0, fs.srel, o["act"])
        ref_r = sync(relin_plain(*relin_args, **r_kw))
        n_relin = int((ref_r[3] == 0).sum())
        print(f"[kernels] {tag} beta {beta:.4g}: {n_relin} of {n_valid} valid rows relinearize")
        if n_relin == 0 or (beta == beta_mid and n_relin == n_valid):
            raise AssertionError(f"{tag}: the relinearization check needs both kinds of rows")
        compare(n_relin_name, sync(relin(*relin_args, **r_kw)), ref_r)

    lp, jac, r0, srel = ref_r
    msg_args = (params, o["cam_tab"], o["lmk_tab"], *ids, jac, lp, r0, o["prec"], srel, o["act"],
                fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1], fs.msg_lam[1], *sum_index)
    for huber in (1.0, None):
        ref_m = sync(msgs_plain(*msg_args, huber=huber, **m_kw))
        got_m = sync(msgs(*msg_args, huber=huber, **m_kw))
        compare(n_msg_name, got_m, ref_m)
        hold_fold(tag, dtype, got_m, o, lambda: msgs(*msg_args, huber=huber, **m_kw), huber)
    calls = {n_relin_name: lambda: relin(*relin_args, **r_kw),
             n_msg_name: lambda: msgs(*msg_args, huber=None, **m_kw)}

    if win:
        print(f"[kernels] {tag} relin_cm_tabblk_ell: "
              f"{M.window_blocks_per_sm('relin_cm_tabblk_ell', o['win_w'], dtype)} blocks of "
              f"256 threads per SM at win_w {o['win_w']}")
        print_plan(tag, "messages_cm_tabblk_ell", dtype, win_w=o["win_w"], mp=o["mp"])

    me, ml = ref_m[2 * g], ref_m[2 * g + 1]
    whole = (None if o["seg_rows"] is None
             else sync(M.segsum_by_id_plain(me, ml, o["seg_rows"], o["seg_offsets"])))
    if win:
        blk_args, blk_kw = (me, ml, *sum_index), dict(n_tiles=o["mp"] // M.TILE, w=o["win_w"])
        part = sync(M.segsum_cm_blk(*blk_args, **blk_kw))
        hold_segsum_blk(tag, part, *blk_args)
        repeats("segsum_cm_blk", M.segsum_cm_blk, blk_args, blk_kw, part)
        sc_args = (part, o["win_starts"], o["blk_tiles"], o["blk_offsets"])
        sc_kw = dict(n_seg=n_cam)
        got_s = sync(M.scatter_windows_cm(*sc_args, **sc_kw))
        exact("scatter_windows_cm", got_s, sync(scatter_plain(*sc_args, **sc_kw)), tag)
        compare.errs["segsum_cm_blk"] = compare.errs["scatter_windows_cm"] = 0.0
        if whole is not None:
            compare("scatter_windows_cm vs the whole-table sum", (got_s,), (whole,), record=False)
        repeats("scatter_windows_cm", M.scatter_windows_cm, sc_args, sc_kw, got_s)
        calls["segsum_cm_blk"] = lambda: M.segsum_cm_blk(*blk_args, **blk_kw)
        calls["scatter_windows_cm"] = lambda: M.scatter_windows_cm(*sc_args, **sc_kw)
    else:
        seg_args = (me, ml, *sum_index)
        got_s = sync(M.segsum_by_id(*seg_args))
        print(f"[kernels] {tag} segsum_by_id form (chunk, group) "
              f"{M.segsum_form(o['mp'], n_cam, o['seg_rows'].shape[0])}")
        compare("segsum_by_id", (got_s,), (whole,))
        repeats("segsum_by_id", M.segsum_by_id, seg_args, {}, got_s)
        calls["segsum_by_id"] = lambda: M.segsum_by_id(*seg_args)

    acts = schedule_acts(x, o["act"]) if masked else None
    if acts:
        hold_masked(tag, n_relin_name, relin, relin_plain, relin_args, r_kw, o["act"], acts,
                    relin_kept(fs), keyed(compare))
        outs = hold_masked(tag, n_msg_name, msgs, msgs_plain, msg_args, dict(huber=1.0, **m_kw),
                           o["act"], acts, messages_kept(fs), keyed(compare))
        for label, out in outs.items():
            # The camera-side sums of messages that kept their old values.
            hold_fold(f"{tag} {label} mask", dtype, out, o, huber=1.0)
            if win:
                sc_args = (out[-1], o["win_starts"], o["blk_tiles"], o["blk_offsets"])
                exact("scatter_windows_cm", sync(M.scatter_windows_cm(*sc_args, n_seg=n_cam)),
                      sync(scatter_plain(*sc_args, n_seg=n_cam)), f"{tag} {label} mask")
            else:
                seg_args = (out[2 * g], out[2 * g + 1], *sum_index)
                compare(f"segsum_by_id[{label} mask]", (out[-1],),
                        (M.segsum_by_id_plain(*seg_args),), record=False)
    if timings is None:
        return ref_r, acts, calls
    vals = torch.cat([me, ml])
    gl = o["gidx"].long()
    width = vals.shape[0]
    zeros = lambda n: torch.zeros((width, n), dtype=dtype, device=dev)
    n_relin_cfg = int((ref_r[3] == 0).sum())
    timed = [
        (n_relin_name, relin, relin_plain, relin_args, r_kw, ref_r,
         RELIN_TEST_FLOPS * o["mp"] + RELIN_ROW_FLOPS * n_relin_cfg, None),
        (n_msg_name, msgs, msgs_plain, msg_args, dict(huber=None, **m_kw), got_m,
         (MESSAGES_ROW_FLOPS + width) * o["mp"], None),
    ]
    if win:
        tile_key = (torch.arange(o["mp"], device=dev) // M.TILE) * o["win_w"] + (
            gl - o["win_starts"].long().repeat_interleave(M.TILE))
        win_ids = (o["win_starts"].long()[:, None]
                   + torch.arange(o["win_w"], device=dev)).reshape(-1)
        part_cm = part.permute(1, 0, 2).reshape(width, -1).contiguous()
        n_cover = int(M.cover_lists(o["win_starts"], o["win_w"], n_cam)[1][-1])
        n_cpad = -(-n_cam // sweep_cm.SUB) * sweep_cm.SUB  # the window table's cameras
        timed += [
            ("segsum_cm_blk", M.segsum_cm_blk, M.segsum_cm_blk_plain, blk_args, blk_kw, (part,),
             width * o["mp"],
             lambda: zeros(part_cm.shape[1]).index_add_(1, tile_key, vals)),
            # One addition per covering tile, camera and component.
            ("scatter_windows_cm", M.scatter_windows_cm, scatter_plain, sc_args, sc_kw,
             (got_s,), width * n_cover,
             lambda: zeros(n_cpad).index_add_(1, win_ids, part_cm)),
        ]
    else:
        timed.append(("segsum_by_id", M.segsum_by_id, M.segsum_by_id_plain, seg_args, {},
                      (got_s,), None,
                      lambda: zeros(n_cam).index_add_(1, gl, vals)))
    # What each kernel reads: kernel 2 the per-row map in place of the CSR.
    reads = {} if win else {n_msg_name: (*msg_args[:-2], o["seg_ids"])}
    for name, kern, plain, args, kw, outs, flops, library in timed:
        ms = time_ms(lambda: kern(*args, **kw), 20)
        plain_ms = time_ms(lambda: plain(*args, **kw), 3)
        b_ms, b_by = (segsum_bound_ms(args, outs[0]) if name == "segsum_by_id"
                      else bound_ms(reads.get(name, args), outs, flops))
        lib_ms = None if library is None else time_ms(library, 20)
        timings[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib_ms)
        print(f"[kernels] {tag} {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), index_add_ "
              + ("none" if lib_ms is None else f"{lib_ms:.4f} ms"))
        if name in ("segsum_by_id", "scatter_windows_cm"):
            print(f"[kernels] {tag} {name} on the device (profiler): kernel "
                  f"{device_ms(lambda: kern(*args, **kw)):.4f} ms, index_add_ "
                  f"{device_ms(library):.4f} ms ({card_line()})")
        if name == "messages_cm_tabblk_ell":
            report_window_kernel(tag, name, args, kw)
        if name == "segsum_cm_blk":
            report_segsum_blk(tag, *args, **kw)
    return ref_r, acts, calls


def check_row_kernels(tag, cmg, st, ref_r, dtype, compare, timings, acts=None):
    """Phase 8 for one scene and dtype, from the state `st` of the full-table
    checks: the four expanded-operand entries against their plain versions.
    `ref_r` is the relinearized state at the config's beta.  With `acts`
    (phase 25 (a)) `relin_cm` and `messages_cm` again under those masks."""
    fs = st.f
    fb = cmg.fb
    dev = fs.lp.device
    rows = cmg._replace(gather_mode="rows", gidx_rm=cmg.gidx.long())
    be1, bl1, mean1 = sweep_cm._expand_ell(rows, st.v[fb.vblocks[1]])
    be0, bl0, mean0 = sweep_cm._expand_gather(rows, st.v[fb.vblocks[0]])
    x = torch.cat([mean0, mean1])
    rm = lambda a: a.T.contiguous()  # the same operand, one row per factor
    shape = dict(d0=M.D0, d1=M.D1, z=M.Z)
    on = cmg.act[0] > 0.5
    beta_mid = float(((x - fs.lp) ** 2).sum(0).sqrt()[on].double().median())
    n_valid = int(on.sum())

    lp, jac, r0, srel = ref_r
    gen = torch.Generator(device="cpu").manual_seed(0)
    thr = torch.randint(0, 3, (1, cmg.mp), generator=gen).to(dev, dtype)  # 0 = off
    off = 0.3 * (cmg.prec[0] * cmg.prec[1]).sqrt()
    prec_of = {
        (False, False): cmg.prec,
        (False, True): torch.cat([cmg.prec, thr]),
        (True, False): torch.stack([cmg.prec[0], off, off, cmg.prec[1]]),
    }
    msgs = (fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1], fs.msg_lam[1])
    for huber, prec_full in ((None, False), (1.0, False), ("row", False), (None, True),
                             (1.0, True)):
        prec = prec_of[(prec_full, huber == "row")]
        kw = dict(prec_full=prec_full, huber=huber, **shape)
        cm_args = (_kernel_params(CFG, dtype), jac, lp, r0, prec, srel, cmg.act, be0, bl0, be1,
                   bl1, *msgs)
        got_cm = sync(M.messages_cm(*cm_args, **kw))
        compare(f"messages_cm[huber={huber}, full={prec_full}]",
                got_cm, sync(M.messages_cm_plain(*cm_args, **kw)), key="messages_cm")
        rm_args = (cm_args[0], *(rm(a) for a in cm_args[1:5]), srel[0], cmg.act[0],
                   *(rm(a) for a in cm_args[7:]))
        got_rm = sync(M.fused_messages(*rm_args, **kw))
        compare(f"fused_messages[huber={huber}, full={prec_full}]",
                got_rm, sync(M.fused_messages_plain(*rm_args, **kw)), key="fused_messages")
        # One body, two layouts: the same bits either way.
        for a, b in zip(got_cm, got_rm):
            if not torch.equal(a.T, b):
                raise AssertionError(f"{tag}: messages_cm and fused_messages differ")

    kw = dict(prec_full=False, huber=None, **shape)
    for beta in (beta_mid, CFG.beta):
        params = _kernel_params(dataclasses.replace(CFG, beta=beta), dtype)
        relin_args = (params, x, cmg.z, None, fs.lp, fs.jac, fs.r0, fs.srel, cmg.act)
        r_kw = dict(comp_name=fb.ftype.name, **shape)
        ref = sync(M.relin_cm_plain(*relin_args, **r_kw))
        n_relin = int((ref[3] == 0).sum())
        print(f"[kernels] {tag} rows beta {beta:.4g}: {n_relin} of {n_valid} valid rows "
              f"relinearize")
        if n_relin == 0 or (beta == beta_mid and n_relin == n_valid):
            raise AssertionError(f"{tag}: the relinearization check needs both kinds of rows")
        compare("relin_cm", sync(M.relin_cm(*relin_args, **r_kw)), ref, key="relin_cm")
        frm_args = (params, rm(x), rm(cmg.z), None, rm(fs.lp), rm(fs.jac), rm(fs.r0),
                    rm(cmg.prec), fs.srel[0], cmg.act[0], *(rm(a) for a in (be0, bl0, be1, bl1)),
                    *(rm(a) for a in msgs))
        frm_kw = dict(comp_name=fb.ftype.name, **kw)
        compare("fused_relin_messages", sync(M.fused_relin_messages(*frm_args, **frm_kw)),
                sync(M.fused_relin_messages_plain(*frm_args, **frm_kw)),
                key="fused_relin_messages")

    if acts:
        hold_masked(tag, "relin_cm", M.relin_cm, M.relin_cm_plain, relin_args, r_kw, cmg.act,
                    acts, relin_kept(fs), keyed(compare))
        cm_args = (_kernel_params(CFG, dtype), jac, lp, r0, cmg.prec, srel, cmg.act, be0, bl0,
                   be1, bl1, *msgs)
        hold_masked(tag, "messages_cm", M.messages_cm, M.messages_cm_plain, cm_args,
                    dict(prec_full=False, huber=1.0, **shape), cmg.act, acts,
                    messages_kept(fs), keyed(compare))
    if timings is None:
        return
    n_relin_cfg = int((ref_r[3] == 0).sum())
    msg_flops = MESSAGES_ROW_FLOPS * cmg.mp
    relin_flops = RELIN_TEST_FLOPS * cmg.mp + RELIN_ROW_FLOPS * n_relin_cfg
    cm_args = (_kernel_params(CFG, dtype), jac, lp, r0, cmg.prec, srel, cmg.act, be0, bl0, be1,
               bl1, *msgs)
    rm_args = (cm_args[0], *(rm(a) for a in cm_args[1:5]), srel[0], cmg.act[0],
               *(rm(a) for a in cm_args[7:]))
    timed = [
        ("messages_cm", M.messages_cm, M.messages_cm_plain, cm_args, kw, msg_flops),
        ("relin_cm", M.relin_cm, M.relin_cm_plain, relin_args, r_kw, relin_flops),
        ("fused_messages", M.fused_messages, M.fused_messages_plain, rm_args, kw, msg_flops),
        ("fused_relin_messages", M.fused_relin_messages, M.fused_relin_messages_plain,
         frm_args, frm_kw, msg_flops + relin_flops),
    ]
    for name, kern, plain, args, t_kw, flops in timed:
        outs = kern(*args, **t_kw)
        ms = time_ms(lambda: kern(*args, **t_kw), 20)
        plain_ms = time_ms(lambda: plain(*args, **t_kw), 3)
        b_ms, b_by = bound_ms(args, outs, flops)
        timings[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=None)
        print(f"[kernels] {tag} {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), no single library call")


def expanded_ell(tag, o, compare):
    """The ELL slot's per-row operands (eta, lam, mean) of the operands `o`
    by `expand_ell_blk` (14), held bit for bit against its plain version;
    returns them with the packed table it expanded."""
    d_e = o["lmk_mean"].shape[1]
    pk = torch.cat([o["lmk_tab"], o["lmk_mean"]], 1).contiguous()
    cm = sync(M.expand_ell_blk(pk, deg=o["deg"]))
    ref = sync(M.expand_ell_blk_plain(pk, deg=o["deg"]))
    exact("expand_ell_blk", cm, ref, f"{tag} ({pk.shape[1]} values a row)")
    compare("expand_ell_blk", (cm,), (ref,))
    return (*sweep_cm._split(cm, d_e), pk, cm)


def check_unfused_kernels(tag, o, dtype, compare, timings, acts=None):
    """Phase 12 for one graph or degree class and dtype, on its operands `o`
    (`table_ops`, `seg_ops`) at either gathered slot: `expand_ell_blk`,
    `relin_cm_tab` and `messages_cm_tab` against their plain versions; with
    `acts` (phase 25 (a)) the last two again under those masks.  Returns
    {kernel: a call on these operands}."""
    fs, deg, g = o["fs"], o["deg"], o["gslot"]
    dev = fs.lp.device
    be_e, bl_e, mean_e, pk, cm = expanded_ell(tag, o, compare)
    mtab, btab = o["cam_mean"], o["cam_tab"]
    by_slot = lambda gat, ell: (gat, ell) if g == 0 else (ell, gat)
    x = torch.cat(by_slot(mtab[o["gidx"].long()].T, mean_e))
    on = o["act"][0] > 0.5
    beta_mid = float(((x - fs.lp) ** 2).sum(0).sqrt()[on].double().median())
    r_kw = dict(comp_name=o["comp_name"], gslot=g)
    for beta in (beta_mid, CFG.beta):
        params = _kernel_params(dataclasses.replace(CFG, beta=beta), dtype)
        relin_args = (params, mean_e, mtab, o["gidx"], o["z"], o["args"], fs.lp, fs.jac, fs.r0,
                      fs.srel, o["act"])
        ref_r = sync(M.relin_cm_tab_plain(*relin_args, **r_kw))
        n_relin = int((ref_r[3] == 0).sum())
        if n_relin == 0 or (beta == beta_mid and n_relin == int(on.sum())):
            raise AssertionError(f"{tag}: the relinearization check needs both kinds of rows")
        compare("relin_cm_tab", sync(M.relin_cm_tab(*relin_args, **r_kw)), ref_r,
                key="relin_cm_tab")
    lp, jac, r0, srel = ref_r
    msg_args = (_kernel_params(CFG, dtype), jac, lp, r0, o["prec"], srel, o["act"], be_e, bl_e,
                btab, o["gidx"], fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1], fs.msg_lam[1])
    for huber in (1.0, None):
        got_m = sync(M.messages_cm_tab(*msg_args, huber=huber, gslot=g))
        compare(f"messages_cm_tab[huber={huber}]", got_m,
                sync(M.messages_cm_tab_plain(*msg_args, huber=huber, gslot=g)),
                key="messages_cm_tab")
    if acts:
        hold_masked(tag, "relin_cm_tab", M.relin_cm_tab, M.relin_cm_tab_plain, relin_args, r_kw,
                    o["act"], acts, relin_kept(fs), keyed(compare))
        hold_masked(tag, "messages_cm_tab", M.messages_cm_tab, M.messages_cm_tab_plain, msg_args,
                    dict(huber=1.0, gslot=g), o["act"], acts, messages_kept(fs), keyed(compare))
    calls = {"expand_ell_blk": lambda: M.expand_ell_blk(pk, deg=deg),
             "relin_cm_tab": lambda: M.relin_cm_tab(*relin_args, **r_kw),
             "messages_cm_tab": lambda: M.messages_cm_tab(*msg_args, huber=None, gslot=g)}
    if timings is None:
        return calls
    rows = torch.arange(o["mp"], device=dev) // deg
    pk_t = pk.T.contiguous()
    n_relin_cfg = int((ref_r[3] == 0).sum())
    timed = [
        ("expand_ell_blk", M.expand_ell_blk, M.expand_ell_blk_plain, (pk,), dict(deg=deg), (cm,),
         0, lambda: pk_t.index_select(1, rows)),
        ("relin_cm_tab", M.relin_cm_tab, M.relin_cm_tab_plain, relin_args, r_kw, ref_r,
         RELIN_TEST_FLOPS * o["mp"] + RELIN_ROW_FLOPS * n_relin_cfg, None),
        ("messages_cm_tab", M.messages_cm_tab, M.messages_cm_tab_plain, msg_args,
         dict(huber=None, gslot=g), got_m, MESSAGES_ROW_FLOPS * o["mp"], None),
    ]
    for name, kern, plain, args, kw, outs, flops, library in timed:
        ms = time_ms(lambda: kern(*args, **kw), 20)
        plain_ms = time_ms(lambda: plain(*args, **kw), 3)
        b_ms, b_by = bound_ms(args, outs, flops)
        lib_ms = None if library is None else time_ms(library, 20)
        timings[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib_ms)
        print(f"[kernels] {tag} {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), index_select "
              + ("none" if lib_ms is None else f"{lib_ms:.4f} ms"))
    return calls


def check_unfused_win_kernels(tag, o, dtype, compare, timings, acts=None):
    """Phase 17 for one windowed graph or degree class and dtype, on its
    operands `o` at either gathered slot: `relin_cm_tabblk` (both regimes)
    and `messages_cm_tabblk` (Huber none and scalar) against their plain
    versions, the ELL slot expanded by `expand_ell_blk` (held bit for bit);
    timed with their bounds when `timings` is given; with `acts` (phase 25
    (a)) both again under those masks.  Returns {kernel: a call on these
    operands}."""
    fs, deg, g = o["fs"], o["deg"], o["gslot"]
    be_e, bl_e, mean_e, pk, _ = expanded_ell(tag, o, compare)
    mtab, btab = o["cam_mean"], o["cam_tab"]
    w_kw = dict(win_w=o["win_w"])
    by_slot = lambda gat, ell: (gat, ell) if g == 0 else (ell, gat)
    x = torch.cat(by_slot(mtab[o["gidx"].long()].T, mean_e))
    on = o["act"][0] > 0.5
    beta_mid = float(((x - fs.lp) ** 2).sum(0).sqrt()[on].double().median())
    r_kw = dict(comp_name=o["comp_name"], gslot=g, **w_kw)
    for beta in (beta_mid, CFG.beta):
        params = _kernel_params(dataclasses.replace(CFG, beta=beta), dtype)
        relin_args = (params, mean_e, mtab, o["gidx"], o["win_starts"], o["z"], o["args"], fs.lp,
                      fs.jac, fs.r0, fs.srel, o["act"])
        ref_r = sync(M.relin_cm_tabblk_plain(*relin_args, **r_kw))
        n_relin = int((ref_r[3] == 0).sum())
        if n_relin == 0 or (beta == beta_mid and n_relin == int(on.sum())):
            raise AssertionError(f"{tag}: the relinearization check needs both kinds of rows")
        compare("relin_cm_tabblk", sync(M.relin_cm_tabblk(*relin_args, **r_kw)), ref_r,
                key="relin_cm_tabblk")
    lp, jac, r0, srel = ref_r
    msg_args = (_kernel_params(CFG, dtype), jac, lp, r0, o["prec"], srel, o["act"], be_e, bl_e,
                btab, o["gidx"], o["win_starts"], fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1],
                fs.msg_lam[1])
    m_kw = dict(gslot=g, **w_kw)
    print_plan(tag, "messages_cm_tabblk", dtype, win_w=o["win_w"], mp=o["mp"])
    for huber in (1.0, None):
        got_m = sync(M.messages_cm_tabblk(*msg_args, huber=huber, **m_kw))
        compare(f"messages_cm_tabblk[huber={huber}]", got_m,
                sync(M.messages_cm_tabblk_plain(*msg_args, huber=huber, **m_kw)),
                key="messages_cm_tabblk")
    if acts:
        hold_masked(tag, "relin_cm_tabblk", M.relin_cm_tabblk, M.relin_cm_tabblk_plain,
                    relin_args, r_kw, o["act"], acts, relin_kept(fs), keyed(compare))
        hold_masked(tag, "messages_cm_tabblk", M.messages_cm_tabblk, M.messages_cm_tabblk_plain,
                    msg_args, dict(huber=1.0, **m_kw), o["act"], acts, messages_kept(fs),
                    keyed(compare))
    calls = {"expand_ell_blk": lambda: M.expand_ell_blk(pk, deg=deg),
             "relin_cm_tabblk": lambda: M.relin_cm_tabblk(*relin_args, **r_kw),
             "messages_cm_tabblk": lambda: M.messages_cm_tabblk(*msg_args, huber=None, **m_kw)}
    if timings is None:
        return calls
    n_relin_cfg = int((ref_r[3] == 0).sum())
    timed = [
        ("relin_cm_tabblk", M.relin_cm_tabblk, M.relin_cm_tabblk_plain, relin_args, r_kw, ref_r,
         RELIN_TEST_FLOPS * o["mp"] + RELIN_ROW_FLOPS * n_relin_cfg),
        ("messages_cm_tabblk", M.messages_cm_tabblk, M.messages_cm_tabblk_plain, msg_args,
         dict(huber=None, **m_kw), got_m, MESSAGES_ROW_FLOPS * o["mp"]),
    ]
    for name, kern, plain, args, kw, outs, flops in timed:
        ms = time_ms(lambda: kern(*args, **kw), 20)
        plain_ms = time_ms(lambda: plain(*args, **kw), 3)
        b_ms, b_by = bound_ms(args, outs, flops)
        timings[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=None)
        print(f"[kernels] {tag} {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), no single library call")
    report_window_kernel(tag, "messages_cm_tabblk", msg_args, dict(huber=None, **m_kw))
    return calls


def check_pose_kernels(tag, build, dtype, dev, ptimes):
    """Phase 13 for one pose graph and dtype.  `build(dtype, device)` gives
    (graph, means).  From the state after POSE_WARM plain sweeps on the CPU
    (every row is eligible to relinearize in the next), every kernel the graph's shape can
    reach runs against its plain version on identical CUDA inputs: the fused
    table kernels, or the windowed ones where `prepare` cuts windows, the
    unfused ones, the expanded-operand ones in both layouts.  Thresholds:
    the graph's own (per row, or none) and a scalar.  `ptimes` collects the
    kernels' times at this graph's shape."""
    tol = TOL[dtype]
    g_cpu, m_cpu = build(dtype, "cpu")
    cmg_cpu = sweep_cm.prepare(g_cpu)
    st = to_device(sweep_cm.run(cmg_cpu, sweep_cm.init_state(cmg_cpu, m_cpu), PCFG, POSE_WARM),
                   dev)
    graph = build(dtype, dev)[0]
    cmg = sweep_cm.prepare(graph)
    fs, fb = st.f, cmg.fb
    e, deg, model = fb.ell_slot, fb.ell_deg, fb.ftype.name
    g = 1 - e
    shape = dict(d0=fb.dofs[0], d1=fb.dofs[1], z=cmg.z.shape[0])
    own = "row" if fb.huber_arr is not None else fb.huber
    hubers = (own, 1.5) if own is not None else (None, 1.5)
    tag = f"{tag} {str(dtype)[6:]} {tuple(shape.values())}"
    print(f"[kernels] {tag}: {cmg.mp} rows (deg {deg}, ELL slot {e}), mode "
          f"{cmg.gather_mode!r}, win_w {cmg.win_w}, thresholds {own!r}")
    by_slot = lambda a_g, a_e: (a_g, a_e) if g == 0 else (a_e, a_g)
    worst = {}

    def hold(name, got, ref):
        for i, (a, b) in enumerate(zip(got, ref)):
            rel, err = rel_err(a, b)
            if not rel <= tol:
                raise AssertionError(f"{name} {tag} out{i}: rel err {rel:.3e} > {tol:g}")
            worst[name] = max(worst.get(name, 0.0), rel)
            note_rel(name, rel)

    def timed(name, fn):
        if dtype == torch.float32:
            ptimes.setdefault(name, {})[tuple(shape.values())] = time_ms(fn, 20)

    vs_c, vs_l = sweep_cm._slot_states(cmg, st)
    cam_mean, lmk_mean, cam_tab, lmk_tab = sweep_cm.belief_tables(cmg, st)
    x = sweep_cm.expand_means(cmg, st)
    on = cmg.act[0] > 0.5
    beta_mid = float(((x - fs.lp) ** 2).sum(0).sqrt()[on].double().median())
    betas = (beta_mid, PCFG.beta)
    params_at = lambda beta: _kernel_params(dataclasses.replace(PCFG, beta=beta), dtype)
    params = params_at(PCFG.beta)
    state_ops = (cmg.z, fs.lp, fs.jac, fs.r0, fs.srel, cmg.act)
    msgs = (fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1], fs.msg_lam[1])
    prec_of = lambda h: cmg.prec if h == own else cmg.prec[:shape["z"]].contiguous()

    def both_regimes(name, ref_of):
        """The plain version's output at the config's beta, after checking
        that the median distance as beta splits the valid rows."""
        n_mid = int((sync(ref_of(beta_mid))[3] == 0).sum())
        ref = sync(ref_of(PCFG.beta))
        print(f"[kernels] {tag} {name}: {n_mid} of {int(on.sum())} valid rows relinearize at "
              f"beta {beta_mid:.4g}, {int((ref[3] == 0).sum())} at {PCFG.beta}")
        if not 0 < n_mid < int(on.sum()):
            raise AssertionError(f"{tag} {name}: the relinearization check needs both kinds "
                                 f"of rows")
        return ref

    # Fused table kernels, whole table or windows.
    if cmg.win_w:
        w_kw = dict(deg=deg, win_w=cmg.win_w, gslot=g)
        r_args = lambda beta: (params_at(beta), cam_mean, lmk_mean, cmg.gidx, cmg.win_starts,
                               *state_ops)
        for beta in betas:
            hold("relin_cm_tabblk_ell",
                 sync(M.relin_cm_tabblk_ell(*r_args(beta), comp_name=model, **w_kw)),
                 M.relin_cm_tabblk_ell_plain(*r_args(beta), comp_name=model, **w_kw))
        ref_r = both_regimes("relin_cm_tabblk_ell", lambda beta: M.relin_cm_tabblk_ell_plain(
            *r_args(beta), comp_name=model, **w_kw))
        lp, jac, r0, srel = ref_r
        for h in hubers:
            m_args = (params, cam_tab, lmk_tab, cmg.gidx, cmg.win_starts, jac, lp, r0,
                      prec_of(h), srel, cmg.act, *msgs, cmg.win_rows, cmg.win_offsets)
            ref_m = sync(M.messages_cm_tabblk_ell_plain(*m_args, huber=h, **w_kw))
            got_m = sync(M.messages_cm_tabblk_ell(*m_args, huber=h, **w_kw))
            hold("messages_cm_tabblk_ell", got_m, ref_m)
            hold_fold(tag, dtype, got_m, fold_ops(cmg, cam_tab, g), huber=h)
        sc_args = (got_m[4], cmg.win_starts, cmg.blk_tiles, cmg.blk_offsets)
        n_g = cam_mean.shape[0]
        got_s = sync(M.scatter_windows_cm(*sc_args, n_seg=n_g))
        exact("scatter_windows_cm", got_s, scatter_plain(*sc_args, n_seg=n_g), tag)
        worst["scatter_windows_cm"] = 0.0
        hold("scatter_windows_cm", (got_s,), (M.segsum_by_id_plain(
            ref_m[2 * g], ref_m[2 * g + 1], cmg.seg_rows, cmg.seg_offsets),))
        timed("messages_cm_tabblk_ell", lambda: M.messages_cm_tabblk_ell(*m_args, huber=h, **w_kw))
        timed("relin_cm_tabblk_ell", lambda: M.relin_cm_tabblk_ell(
            *r_args(PCFG.beta), comp_name=model, **w_kw))
    elif cmg.gather_mode == "table":
        t_kw = dict(deg=deg, gslot=g)
        r_args = lambda beta: (params_at(beta), cam_mean, lmk_mean, cmg.gidx, *state_ops)
        for beta in betas:
            hold("relin_cm_tab_ell",
                 sync(M.relin_cm_tab_ell(*r_args(beta), comp_name=model, **t_kw)),
                 M.relin_cm_tab_ell_plain(*r_args(beta), comp_name=model, **t_kw))
        ref_r = both_regimes("relin_cm_tab_ell", lambda beta: M.relin_cm_tab_ell_plain(
            *r_args(beta), comp_name=model, **t_kw))
        lp, jac, r0, srel = ref_r
        for h in hubers:
            m_args = (params, cam_tab, lmk_tab, cmg.gidx, jac, lp, r0, prec_of(h), srel,
                      cmg.act, *msgs, cmg.seg_rows, cmg.seg_offsets)
            ref_m = sync(M.messages_cm_tab_ell_plain(*m_args, huber=h, **t_kw))
            got_m = sync(M.messages_cm_tab_ell(*m_args, huber=h, **t_kw))
            hold("messages_cm_tab_ell", got_m, ref_m)
            hold_fold(tag, dtype, got_m, fold_ops(cmg, cam_tab, g), huber=h)
        timed("messages_cm_tab_ell", lambda: M.messages_cm_tab_ell(*m_args, huber=h, **t_kw))
        timed("relin_cm_tab_ell", lambda: M.relin_cm_tab_ell(
            *r_args(PCFG.beta), comp_name=model, **t_kw))
    else:
        raise AssertionError(f"{tag}: prepare chose {cmg.gather_mode!r}; the check needs a table")

    # Expansion, then the unfused kernels (where the whole table fits) and
    # the expanded-operand kernels in both layouts.
    d_e = fb.dofs[e]
    pk = sweep_cm._with_identity_rows(sweep_cm._pack_beliefs(vs_l), d_e,
                                      cmg.nv - vs_l.eta.shape[0]).contiguous()
    cm = sync(M.expand_ell_blk(pk, deg=deg))
    if not torch.equal(cm, M.expand_ell_blk_plain(pk, deg=deg)):
        raise AssertionError(f"expand_ell_blk {tag}: differs from its plain version")
    worst["expand_ell_blk"] = 0.0
    be_l, bl_l, mean_l = sweep_cm._split(cm, d_e)
    if not cmg.win_w:
        mtab, btab = vs_c.mean.contiguous(), sweep_cm._packed(vs_c).contiguous()
        u_args = lambda beta: (params_at(beta), mean_l, mtab, cmg.gidx, cmg.z, None, *state_ops[1:])
        for beta in betas:
            hold("relin_cm_tab", sync(M.relin_cm_tab(*u_args(beta), comp_name=model, gslot=g)),
                 M.relin_cm_tab_plain(*u_args(beta), comp_name=model, gslot=g))
        for h in hubers:
            m_args = (params, jac, lp, r0, prec_of(h), srel, cmg.act, be_l, bl_l, btab,
                      cmg.gidx, *msgs)
            hold("messages_cm_tab", sync(M.messages_cm_tab(*m_args, huber=h, gslot=g)),
                 M.messages_cm_tab_plain(*m_args, huber=h, gslot=g))
        timed("messages_cm_tab", lambda: M.messages_cm_tab(*m_args, huber=h, gslot=g))
    else:
        mtab, btab = vs_c.mean.contiguous(), sweep_cm._packed(vs_c).contiguous()
        w_kw = dict(win_w=cmg.win_w, gslot=g)
        u_args = lambda beta: (params_at(beta), mean_l, mtab, cmg.gidx, cmg.win_starts, cmg.z,
                               None, *state_ops[1:])
        for beta in betas:
            hold("relin_cm_tabblk",
                 sync(M.relin_cm_tabblk(*u_args(beta), comp_name=model, **w_kw)),
                 M.relin_cm_tabblk_plain(*u_args(beta), comp_name=model, **w_kw))
        for h in hubers:
            m_args = (params, jac, lp, r0, prec_of(h), srel, cmg.act, be_l, bl_l, btab,
                      cmg.gidx, cmg.win_starts, *msgs)
            hold("messages_cm_tabblk", sync(M.messages_cm_tabblk(*m_args, huber=h, **w_kw)),
                 M.messages_cm_tabblk_plain(*m_args, huber=h, **w_kw))
        timed("messages_cm_tabblk", lambda: M.messages_cm_tabblk(*m_args, huber=h, **w_kw))
    rows_cmg = cmg._replace(gather_mode="rows", gidx_rm=cmg.gidx.long())
    be_c, bl_c, mean_c = sweep_cm._expand_gather(rows_cmg, vs_c)
    (be0, be1), (bl0, bl1) = by_slot(be_c, be_l), by_slot(bl_c, bl_l)
    x_cm = torch.cat(by_slot(mean_c, mean_l))
    rm = lambda a: a.T.contiguous()
    for beta in betas:
        rr_args = (params_at(beta), x_cm, cmg.z, None, *state_ops[1:])
        rr_kw = dict(comp_name=model, **shape)
        hold("relin_cm", sync(M.relin_cm(*rr_args, **rr_kw)), M.relin_cm_plain(*rr_args, **rr_kw))
        frm_args = (params_at(beta), rm(x_cm), rm(cmg.z), None, rm(fs.lp), rm(fs.jac), rm(fs.r0),
                    rm(cmg.prec), fs.srel[0], cmg.act[0],
                    *(rm(a) for a in (be0, bl0, be1, bl1)), *(rm(a) for a in msgs))
        frm_kw = dict(prec_full=False, huber=own, comp_name=model, **shape)
        hold("fused_relin_messages", sync(M.fused_relin_messages(*frm_args, **frm_kw)),
             M.fused_relin_messages_plain(*frm_args, **frm_kw))
    for h in hubers:
        cm_args = (params, jac, lp, r0, prec_of(h), srel, cmg.act, be0, bl0, be1, bl1, *msgs)
        kw = dict(prec_full=False, huber=h, **shape)
        got_cm = sync(M.messages_cm(*cm_args, **kw))
        hold("messages_cm", got_cm, M.messages_cm_plain(*cm_args, **kw))
        rm_args = (params, *(rm(a) for a in cm_args[1:5]), srel[0], cmg.act[0],
                   *(rm(a) for a in cm_args[7:]))
        got_rm = sync(M.fused_messages(*rm_args, **kw))
        hold("fused_messages", got_rm, M.fused_messages_plain(*rm_args, **kw))
        for a, b in zip(got_cm, got_rm):
            if not torch.equal(a.T, b):
                raise AssertionError(f"{tag}: messages_cm and fused_messages differ")
    # Full precision in the row-major layout, as the generic engine hands a
    # g2o file's information matrices over.
    zd = shape["z"]
    full = torch.diag_embed(rm(cmg.prec[:zd])).reshape(cmg.mp, zd * zd).contiguous()
    fp_args = (params, *(rm(a) for a in (jac, lp, r0)), full, srel[0], cmg.act[0],
               *(rm(a) for a in (be0, bl0, be1, bl1)), *(rm(a) for a in msgs))
    fp_kw = dict(prec_full=True, huber=None, **shape)
    hold("fused_messages", sync(M.fused_messages(*fp_args, **fp_kw)),
         M.fused_messages_plain(*fp_args, **fp_kw))
    timed("messages_cm", lambda: M.messages_cm(*cm_args, **kw))
    timed("fused_messages", lambda: M.fused_messages(*rm_args, **kw))
    print(f"[kernels] {tag}: worst rel err per kernel "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()) + f" (tolerance {tol:g})")


def check_bal_kernels(tag, intrinsics, dtype, dev):
    """Phase 18 on ladybug49 for one camera model and dtype: from the state
    after 8 plain sweeps on the CPU, every relinearization and messages
    entry the BAL graph reaches (the full-table kernels, the unfused table
    kernels with the expansion, the expanded-operand kernels in both
    layouts) against its plain version on identical CUDA inputs, with the
    BAL model's per-row arguments [k1, k2] (6-dof cameras) or at (9, 3, 2)
    (9-dof cameras); relinearization in both regimes, Huber none and
    scalar; the windowed entries with one window of all cameras per
    tile."""
    tol = TOL[dtype]
    sim = bal.to_sim(bal.prune(bal.read_bal(LADYBUG)))
    build = lambda device: ba.build_bal(sim, dtype=dtype, device=device,
                                        optimize_intrinsics=intrinsics)[:2]
    g_cpu, m_cpu = build("cpu")
    cmg_cpu = sweep_cm.prepare(g_cpu)
    st = to_device(sweep_cm.run(cmg_cpu, sweep_cm.init_state(cmg_cpu, m_cpu), CFG, 8), dev)
    cmg = sweep_cm.prepare(build(dev)[0])
    fs, fb = st.f, cmg.fb
    model, deg = fb.ftype.name, fb.ell_deg
    shape = dict(d0=fb.dofs[0], d1=fb.dofs[1], z=cmg.z.shape[0])
    tag = f"{tag} {str(dtype)[6:]} {tuple(shape.values())}"
    if cmg.gather_mode != "table" or cmg.win_w or not cmg.ell_fused:
        raise AssertionError(f"{tag}: prepare chose {cmg.gather_mode!r}, win_w {cmg.win_w}")
    print(f"[kernels] {tag}: {model}, {cmg.mp} rows (deg {deg}), args "
          f"{None if cmg.args is None else tuple(cmg.args.shape)}")
    worst = {}

    def hold(name, got, ref):
        for i, (a, b) in enumerate(zip(got, ref)):
            rel, _ = rel_err(a, b)
            if not rel <= tol:
                raise AssertionError(f"{name} {tag} out{i}: rel err {rel:.3e} > {tol:g}")
            worst[name] = max(worst.get(name, 0.0), rel)
            note_rel(name, rel)

    cam_mean, lmk_mean, cam_tab, lmk_tab = sweep_cm.belief_tables(cmg, st)
    x = sweep_cm.expand_means(cmg, st)
    on = cmg.act[0] > 0.5
    beta_mid = float(((x - fs.lp) ** 2).sum(0).sqrt()[on].double().median())
    params_at = lambda beta: _kernel_params(dataclasses.replace(CFG, beta=beta), dtype)
    params = params_at(CFG.beta)
    state_ops = (cmg.z, fs.lp, fs.jac, fs.r0, fs.srel, cmg.act)
    msgs = (fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1], fs.msg_lam[1])
    for beta in (beta_mid, CFG.beta):
        r_args = (params_at(beta), cam_mean, lmk_mean, cmg.gidx, *state_ops)
        r_kw = dict(deg=deg, comp_name=model, fargs=cmg.args)
        ref_r = sync(M.relin_cm_tab_ell_plain(*r_args, **r_kw))
        n_relin = int((ref_r[3] == 0).sum())
        if n_relin == 0 or (beta == beta_mid and n_relin == int(on.sum())):
            raise AssertionError(f"{tag}: the relinearization check needs both kinds of rows")
        hold("relin_cm_tab_ell", sync(M.relin_cm_tab_ell(*r_args, **r_kw)), ref_r)
    lp, jac, r0, srel = ref_r
    for h in (None, 1.0):
        m_args = (params, cam_tab, lmk_tab, cmg.gidx, jac, lp, r0, cmg.prec, srel, cmg.act, *msgs,
                  cmg.seg_rows, cmg.seg_offsets)
        got_m = sync(M.messages_cm_tab_ell(*m_args, deg=deg, huber=h))
        hold("messages_cm_tab_ell", got_m, M.messages_cm_tab_ell_plain(*m_args, deg=deg, huber=h))
        hold_fold(tag, dtype, got_m, fold_ops(cmg, cam_tab, 0), huber=h)
    vs_c, vs_l = st.v[0], st.v[1]
    pk = sweep_cm._with_identity_rows(sweep_cm._pack_beliefs(vs_l), 3,
                                      cmg.nv - vs_l.eta.shape[0]).contiguous()
    be1, bl1, mean1 = sweep_cm._split(sync(M.expand_ell_blk(pk, deg=deg)), 3)
    mtab, btab = vs_c.mean.contiguous(), sweep_cm._packed(vs_c).contiguous()
    for beta in (beta_mid, CFG.beta):
        u_args = (params_at(beta), mean1, mtab, cmg.gidx, cmg.z, cmg.args, *state_ops[1:])
        hold("relin_cm_tab", sync(M.relin_cm_tab(*u_args, comp_name=model)),
             M.relin_cm_tab_plain(*u_args, comp_name=model))
    for h in (None, 1.0):
        m_args = (params, jac, lp, r0, cmg.prec, srel, cmg.act, be1, bl1, btab, cmg.gidx, *msgs)
        hold("messages_cm_tab", sync(M.messages_cm_tab(*m_args, huber=h)),
             M.messages_cm_tab_plain(*m_args, huber=h))
    rows_cmg = cmg._replace(gather_mode="rows", gidx_rm=cmg.gidx.long())
    be0, bl0, mean0 = sweep_cm._expand_gather(rows_cmg, vs_c)
    x_cm = torch.cat([mean0, mean1])
    rm = lambda a: None if a is None else a.T.contiguous()
    for beta in (beta_mid, CFG.beta):
        rr_args = (params_at(beta), x_cm, cmg.z, cmg.args, *state_ops[1:])
        hold("relin_cm", sync(M.relin_cm(*rr_args, comp_name=model, **shape)),
             M.relin_cm_plain(*rr_args, comp_name=model, **shape))
        frm_args = (params_at(beta), rm(x_cm), rm(cmg.z), rm(cmg.args), rm(fs.lp), rm(fs.jac),
                    rm(fs.r0), rm(cmg.prec), fs.srel[0], cmg.act[0],
                    *(rm(a) for a in (be0, bl0, be1, bl1)), *(rm(a) for a in msgs))
        frm_kw = dict(prec_full=False, huber=None, comp_name=model, **shape)
        hold("fused_relin_messages", sync(M.fused_relin_messages(*frm_args, **frm_kw)),
             M.fused_relin_messages_plain(*frm_args, **frm_kw))
    for h in (None, 1.0):
        cm_args = (params, jac, lp, r0, cmg.prec, srel, cmg.act, be0, bl0, be1, bl1, *msgs)
        kw = dict(prec_full=False, huber=h, **shape)
        hold("messages_cm", sync(M.messages_cm(*cm_args, **kw)), M.messages_cm_plain(*cm_args, **kw))
        rm_args = (params, *(rm(a) for a in cm_args[1:5]), srel[0], cmg.act[0],
                   *(rm(a) for a in cm_args[7:]))
        hold("fused_messages", sync(M.fused_messages(*rm_args, **kw)),
             M.fused_messages_plain(*rm_args, **kw))
    # The windowed entries on the same operands, every tile's window holding
    # all cameras (the BAL files have too few for windows of their own).
    n_tiles = cmg.mp // M.TILE
    w = -(-cam_mean.shape[0] // sweep_cm.SUB) * sweep_cm.SUB
    starts = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    win_rows, win_offsets = (torch.tensor(a, device=dev) for a in M.window_rows_csr(
        cmg.gidx.cpu().numpy(), np.zeros(n_tiles, dtype=np.int64), w))
    w_kw = dict(win_w=w)
    for beta in (beta_mid, CFG.beta):
        r_args = (params_at(beta), cam_mean, lmk_mean, cmg.gidx, starts, *state_ops)
        r_kw = dict(deg=deg, comp_name=model, fargs=cmg.args, **w_kw)
        hold("relin_cm_tabblk_ell", sync(M.relin_cm_tabblk_ell(*r_args, **r_kw)),
             M.relin_cm_tabblk_ell_plain(*r_args, **r_kw))
        u_args = (params_at(beta), mean1, mtab, cmg.gidx, starts, cmg.z, cmg.args,
                  *state_ops[1:])
        hold("relin_cm_tabblk", sync(M.relin_cm_tabblk(*u_args, comp_name=model, **w_kw)),
             M.relin_cm_tabblk_plain(*u_args, comp_name=model, **w_kw))
    for h in (None, 1.0):
        m_args = (params, cam_tab, lmk_tab, cmg.gidx, starts, jac, lp, r0, cmg.prec, srel,
                  cmg.act, *msgs, win_rows, win_offsets)
        got_w = sync(M.messages_cm_tabblk_ell(*m_args, deg=deg, huber=h, **w_kw))
        hold("messages_cm_tabblk_ell", got_w,
             M.messages_cm_tabblk_ell_plain(*m_args, deg=deg, huber=h, **w_kw))
        hold_fold(tag, dtype, got_w, dict(fold_ops(cmg, cam_tab, 0), win_w=w, win_rows=win_rows,
                                          win_offsets=win_offsets), huber=h)
        u_args = (params, jac, lp, r0, cmg.prec, srel, cmg.act, be1, bl1, btab, cmg.gidx, starts,
                  *msgs)
        hold("messages_cm_tabblk", sync(M.messages_cm_tabblk(*u_args, huber=h, **w_kw)),
             M.messages_cm_tabblk_plain(*u_args, huber=h, **w_kw))
    print(f"[kernels] {tag}: worst rel err per kernel "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()) + f" (tolerance {tol:g})")


# --- the row-major kernels on the generic engine's own operands (phase 24) -----------


@contextlib.contextmanager
def recording(name, module=sweep):
    """Inside, `module`'s (the generic sweep's) calls of the wrapper `name`
    are recorded, (args, kwargs) into the yielded list, and still run."""
    calls, real = [], getattr(module, name)

    def record(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def staged_scenes():
    """The generic engine's graphs at every shape of the row-major kernels:
    (tag, build(dtype) -> (graph, means), config, dtypes).  The bench scene
    (its operands also time kernels 4, 5, 19 and 20), the 8-camera scene,
    ladybug49 with the per-row distortion arguments and with 9-dof cameras,
    a Manhattan graph with per-row Huber thresholds, manhattan_sim.g2o (full
    information), an SE(3) helix and the linear toy chain."""
    f32, f64 = torch.float32, torch.float64
    lady = bal.to_sim(bal.prune(bal.read_bal(LADYBUG)))
    yield "bench64", lambda dt: ba.build(ba.simulate(**BENCH), dtype=dt), CFG, (f32,)
    yield "8cam", lambda dt: ba.build(ba.simulate(**SMALL), dtype=dt), CFG, (f64, f32)
    for intr in (False, True):
        yield (f"ladybug49{' 9-dof' if intr else ''}",
               lambda dt, intr=intr: ba.build_bal(lady, dtype=dt, optimize_intrinsics=intr)[:2],
               CFG, (f64, f32))
    yield ("manhattan500", lambda dt: pose_graph.build(pose_graph.simulate_manhattan(**M500),
                                                       dtype=dt, layout="ell"), PCFG, (f64, f32))
    yield ("manhattan_sim.g2o", lambda dt: pose_graph.build_g2o(
        g2o.read_g2o(G2O_FILE), huber=2.0, dtype=dt, layout="ell"), PCFG, (f64, f32))
    yield ("helix120", lambda dt: pose_graph.build_g2o(
        pose_graph.simulate_helix(n_poses=120, seed=0), dtype=dt, layout="ell"), PCFG,
        (f64, f32))
    yield "toy chain", lambda dt: toy.build(toy.simulate(n=50), dtype=dt), CFG, (f64, f32)


def device_ms_by_kernel(fn, n=20):
    """{kernel name: device ms per launch} of the port's kernels `fn`
    launches (each once a call), by the profiler: the mean of the launches
    it recorded over n calls after a warm one."""
    return {k: sum(ts) / len(ts) for k, ts in profiled_ms(fn, n).items() if "gbp::" in k}


def prec_variants(prec, z, prec_full, dev):
    """The precision operand of a recorded call in the three forms the
    messages kernel takes: {(prec_full, huber): prec}: the diagonal (Huber
    none or scalar), a full SPD matrix with that diagonal, and the diagonal
    with a per-row threshold column (0 = off for that row)."""
    m = prec.shape[0]
    diag = prec.reshape(m, z, z).diagonal(dim1=1, dim2=2) if prec_full else prec[:, :z]
    root = diag.sqrt()
    full = 0.3 * root[:, :, None] * root[:, None, :] + torch.diag_embed(0.7 * diag)
    gen = torch.Generator(device="cpu").manual_seed(0)
    thr = torch.randint(0, 3, (m, 1), generator=gen).to(dev, prec.dtype)
    diag = diag.contiguous()
    return {(False, None): diag, (False, 1.0): diag,
            (False, "row"): torch.cat([diag, thr], 1),
            (True, None): full.reshape(m, z * z).contiguous(),
            (True, 1.0): full.reshape(m, z * z).contiguous()}


def check_staged_kernels(tag, build, cfg, dtype, staged):
    """Phase 24 for one graph and dtype: the row-major (staged) kernels on
    the operands the generic sweep hands them after min_linear_iters sweeps
    on the card (belief operands as views into packed rows), against their plain
    versions and bit for bit against the component-major kernels on the
    transposed operands; again on a prefix of the rows that fills no tile;
    the messages kernel with every precision and Huber form.  In float32
    the staged and the component-major kernels are timed on these operands;
    `staged` collects, per instantiation, the figures and times."""
    tol = TOL[dtype]
    graph, means = build(dtype)
    cfg = dataclasses.replace(cfg, message_form="pallas")
    # After min_linear_iters sweeps every row is eligible to relinearize in
    # the next.
    state = sweep.run(graph, sweep.init_state(graph, means), cfg, cfg.min_linear_iters)
    with recording("fused_relin_messages") as rel_calls, \
            recording("fused_messages") as msg_calls:
        sync(sweep.sweep(graph, state, cfg))
    relin = bool(rel_calls)
    args, kw = (rel_calls or msg_calls)[0]
    shape = dict(d0=kw["d0"], d1=kw["d1"], z=kw["z"])
    zd = kw["z"]
    cm = lambda a: a.T.contiguous() if isinstance(a, torch.Tensor) and a.ndim == 2 else a
    key = f"{tag} {str(dtype)[6:]} {tuple(shape.values())}"

    def hold(name, got, ref):
        worst = 0.0
        for i, (a, b) in enumerate(zip(got, ref)):
            rel, _ = rel_err(a, b)
            if not rel <= tol:
                raise AssertionError(f"{name} {key} out{i}: rel err {rel:.3e} > {tol:g}")
            worst = max(worst, rel)
        return worst

    def same_bits(name, rm_out, cm_out):
        for a, b in zip(rm_out, cm_out):
            if not torch.equal(a, b.T):
                raise AssertionError(f"{name} {key}: differs from the component-major kernel "
                                     f"(max abs {float((a - b.T).abs().max()):.3e})")

    m = args[1].shape[0]
    m_part = m - min(77, m // 3)
    m_part -= m_part % 32 == 0
    part = lambda a: a[:m_part] if isinstance(a, torch.Tensor) else a
    worst = {}
    if relin:
        params, x, z, fargs, lp, jac, r0, prec, srel, act, *rest = args
        on = act > 0.5
        beta_mid = float((x - lp).norm(dim=1)[on].double().median())
        n_relin = []
        for beta in (params[4], beta_mid):
            p = (*params[:4], beta, *params[5:])
            b_args = (p, *args[1:])
            got = sync(M.fused_relin_messages(*b_args, **kw))
            n_relin.append(int((got[7][on] == 0).sum()))
            worst["fused_relin_messages"] = max(worst.get("fused_relin_messages", 0.0), hold(
                "fused_relin_messages", got, M.fused_relin_messages_plain(*b_args, **kw)))
            rkw = dict(comp_name=kw["comp_name"], **shape)
            cm_r = sync(M.relin_cm(p, cm(x), cm(z), cm(fargs), cm(lp), cm(jac), cm(r0), srel,
                                   act, **rkw))
            same_bits("fused_relin_messages (relinearization)", got[4:], cm_r)
            mkw = dict(prec_full=kw["prec_full"], huber=kw["huber"], **shape)
            cm_m = sync(M.messages_cm(p, cm_r[1], cm_r[0], cm_r[2], cm(prec), cm_r[3], act,
                                      *map(cm, rest), **mkw))
            same_bits("fused_relin_messages (messages)", got[:4], cm_m)
            head = sync(M.fused_relin_messages(*map(part, b_args), **kw))
            for a, b in zip(head, got):
                if not torch.equal(a, b[:m_part]):
                    raise AssertionError(f"fused_relin_messages {key}: {m_part} rows differ "
                                         f"from the first {m_part} of {m}")
        if not any(0 < n < int(on.sum()) for n in n_relin):
            raise AssertionError(f"{key}: the relinearization check needs both kinds of rows")
        msg_state = (params, got[5], got[4], got[6], prec, got[7][:, 0], act, *rest)
    else:
        msg_state = args
        n_relin = None
    params, jac, x0, r0, prec, srel, act, *rest = msg_state
    variants = prec_variants(prec, zd, kw["prec_full"], prec.device)
    for (prec_full, huber), pv in variants.items():
        v_args = (params, jac, x0, r0, pv, srel, act, *rest)
        v_kw = dict(prec_full=prec_full, huber=huber, **shape)
        got = sync(M.fused_messages(*v_args, **v_kw))
        worst["fused_messages"] = max(worst.get("fused_messages", 0.0), hold(
            "fused_messages", got, M.fused_messages_plain(*v_args, **v_kw)))
        same_bits(f"fused_messages[full={prec_full}, huber={huber}]", got,
                  sync(M.messages_cm(*map(cm, v_args), **v_kw)))
        head = sync(M.fused_messages(*map(part, v_args), **v_kw))
        if not all(torch.equal(a, b[:m_part]) for a, b in zip(head, got)):
            raise AssertionError(f"fused_messages {key}: {m_part} rows differ")
    if tag in SCHEDULE_STAGED:  # phase 25 (a)
        # args: (params, x, z, fargs, lp, jac, r0, prec, srel, act, 4 beliefs,
        # 4 messages); msg_state: (params, jac, lp, r0, prec, srel, act, ...).
        masked = lambda label, got, ref: hold(label, got, ref)
        acts = schedule_acts((args[1] if relin else msg_state[2]).T, msg_state[6])
        if relin:
            hold_masked(key, "fused_relin_messages", M.fused_relin_messages,
                        M.fused_relin_messages_plain, args, kw, args[9], acts,
                        [(a, 0) for a in (*args[14:18], *args[4:7])] + [(args[8], 1)], masked,
                        rows=True)
        hold_masked(key, "fused_messages", M.fused_messages, M.fused_messages_plain, msg_state,
                    dict(prec_full=kw["prec_full"], huber=kw["huber"], **shape), msg_state[6],
                    acts, [(a, 0) for a in msg_state[11:15]], masked, rows=True)
    print(f"[staged] {key}: {m} rows (and the first {m_part}), views "
          f"{[tuple(a.stride()) for a in rest[:4]]}, relinearizing rows at the sweep's beta and "
          f"the median {n_relin}: bit for bit the component-major kernels; worst rel err vs "
          f"plain " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()) + f" (tol {tol:g})")

    infos = {"fused_messages": M.staged_info(
        "fused_messages", dtype, prec_full=kw["prec_full"], huber=kw["huber"], **shape)}
    if relin:
        infos["relinearization"] = M.staged_info("fused_relin_messages", dtype,
                                                 comp_name=kw["comp_name"])
    for name, info in infos.items():
        print(f"[staged] {key} {name}: {info['rows']} rows per block, {info['smem_bytes']} "
              f"bytes of shared memory, {info['registers']} registers, {info['local_bytes']} "
              f"bytes of local memory per thread, {info['blocks_per_sm']} blocks per SM")
    if dtype != torch.float32:
        return
    # Kernels 19 and 4 on the recorded state, 20 and 5 on the recorded call.
    mkw = dict(prec_full=kw["prec_full"], huber=kw["huber"], **shape)
    row_out = M.fused_messages(*msg_state, **mkw)
    timed = {"fused_messages": (lambda: M.fused_messages(*msg_state, **mkw),
                                bound_ms(msg_state[1:], row_out, 0)[0]),
             "messages_cm": (lambda: M.messages_cm(*map(cm, msg_state), **mkw),
                             bound_ms(msg_state[1:], row_out, 0)[0])}
    if relin:
        rkw = dict(comp_name=kw["comp_name"], **shape)
        cm_relin_args = (args[0], *map(cm, args[1:7]), args[8], args[9])
        new = M.fused_relin_messages(*args, **kw)
        relin_io = (*args[1:7], args[8], args[9], *new[4:])
        timed["fused_relin_messages"] = (lambda: M.fused_relin_messages(*args, **kw),
                                         bound_ms(args[1:], new, 0)[0])
        timed["relin_cm"] = (lambda: M.relin_cm(*cm_relin_args, **rkw),
                             bound_ms(relin_io, (), 0)[0])
    rec = staged.setdefault(key, {"rows": m, "info": infos})
    for name, (fn, b_ms) in timed.items():
        by_kernel = device_ms_by_kernel(fn)
        dev_ms = sum(by_kernel.values())
        rec[name] = dict(device_ms=dev_ms, bound_ms=b_ms, share=b_ms / dev_ms)
        line = (f"[staged] {key} {name}: device {dev_ms:.4f} ms, bound {b_ms:.4f} ms, share "
                f"{b_ms / dev_ms:.3f}")
        if name == "fused_relin_messages":
            r_ms = sum(v for k, v in by_kernel.items() if "gbp::relin" in k)
            r_b = bound_ms(relin_io, (), 0)[0]
            floor = b_ms + sum(t.numel() * t.element_size() for t in new[4:]) \
                / PEAK_BYTES_PER_S * 1e3
            rec[name].update(relin_ms=r_ms, relin_bound_ms=r_b, two_kernel_floor_ms=floor)
            line += (f"; its relinearization {r_ms:.4f} ms (bound {r_b:.4f}, share "
                     f"{r_b / r_ms:.3f}); the two kernels' floor {floor:.4f} ms (share "
                     f"{floor / dev_ms:.3f})")
        print(line + f" ({card_line()})")


def check_scatter_dense(dev):
    """`scatter_windows_cm` against a dense accumulation in tile order, with
    overlapping windows, a repeated start and a window reaching into the
    padded tail of the camera range."""
    n_tiles, f, w, n_seg, ncpad = 7, M.F_CAM, 128, 1280, 1536
    rng = np.random.default_rng(7)
    starts = np.sort(rng.integers(0, (ncpad - w) // 8 + 1, size=n_tiles)) * 8
    starts[1] = starts[0]
    starts[-1] = ncpad - w
    on_dev = lambda a: torch.tensor(a, device=dev)
    blk = tuple(map(on_dev, M.window_block_csr(starts, w, n_seg)))
    for dtype in (torch.float64, torch.float32):
        part = torch.tensor(rng.normal(size=(n_tiles, f, w)), dtype=dtype, device=dev)
        want = torch.zeros((f, ncpad), dtype=dtype, device=dev)
        for i, s in enumerate(starts):
            want[:, s:s + w] += part[i]
        got = sync(M.scatter_windows_cm(
            part, torch.tensor(starts, dtype=torch.int32, device=dev), *blk, n_seg=n_seg))
        print(f"[kernels] scatter_windows_cm vs dense accumulation {str(dtype)[6:]}: starts "
              f"{starts.tolist()}")
        exact("scatter_windows_cm vs dense accumulation", got, want[:, :n_seg], str(dtype)[6:])


def window_vs_full():
    """Phase 5: one scene through the windowed and the full-table kernels."""
    sim = ba.simulate_blocks(**BLOCKS7)
    graph, means = ba.build(sim, dtype=torch.float32, **BIG)
    n = 15
    ares, states = {}, {}
    for window, names in ((True, (*WINDOWED, *BELIEFS)), (False, (*FULL, *BELIEFS))):
        cmg = sweep_cm.prepare(graph, window=window)
        if bool(cmg.win_w) != window or (cmg.vperm is not None) != window:
            raise AssertionError(f"prepare(window={window}) gave win_w {cmg.win_w}")
        M.COUNTS.reset()
        st = sync(sweep_cm.run(cmg, sweep_cm.init_state(cmg, means), CFG, n))
        check_counts(f"window={window}", names, n)
        states[window] = sweep_cm.to_gbp_state(cmg, st)
        ares[window] = are_px(graph, cmg, st, sim["k"])
    diff = max(float((a.mean - b.mean).abs().max())
               for a, b in zip(states[True].v, states[False].v))
    print(f"[paths] 280 cams in 7 blocks f32, {n} sweeps: ARE windowed {ares[True]:.6f} px, "
          f"full table {ares[False]:.6f} px; largest difference of the means {diff:.3e}")
    if not abs(ares[True] - ares[False]) <= 5e-3:
        raise AssertionError(f"windowed and full-table ARE differ: {ares}")


# The standalone camera-side sums' CUDA functions (kernels 3 and 16).
STANDALONE_SUMS = ("segsum_chunk_kernel", "gbp::segsum_kernel", "segsum_blk_kernel")


def hold_fold_path(tag, sweep, n=5, unfolded=False):
    """A fused path's sweeps by the profiler: the messages launches return
    the camera-side sums, so none launches the standalone sums, except
    kernel 16 after a windowed launch that does not fold (`unfolded`: at
    most once a sweep, and at least once in the run); prints the device
    records a sweep."""
    recs = {k: len(v) / n for k, v in profiled_ms(sweep, n).items()}
    allowed = lambda k, v: unfolded and "segsum_blk_kernel" in k and v <= 1
    bad = {k: v for k, v in recs.items()
           if any(s in k for s in STANDALONE_SUMS) and not allowed(k, v)}
    ours = {k.split("<")[0].split("gbp::")[-1]: v for k, v in recs.items() if "gbp::" in k}
    print(f"[{tag}] a sweep by the profiler: {sum(recs.values()):.1f} device records, the "
          f"port's kernels {ours}")
    if bad:
        raise AssertionError(f"{tag}: the fused sweep launched the standalone sums {bad}")
    if unfolded and not any("segsum_blk_kernel" in k for k in recs):
        raise AssertionError(f"{tag}: the windowed launch did not fold, and kernel 16 never ran")


def timed_sweeps(tag, cmg, init, n, n_valid, card, cfg=CFG):
    """Time n sweeps from `init`; returns the seconds per sweep."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sync(sweep_cm.run(cmg, init, cfg, n))
    dt = time.perf_counter() - t0
    print(f"[{tag}] timed {n} sweeps: {dt:.4f} s -> {n / dt:.2f} sweeps/s, "
          f"{dt / n / n_valid * 1e9:.4f} ns per valid factor (informational; {card}); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return dt / n


def bench_path(card):
    """Phase 6.  Built on the default device: the card."""
    sim = ba.simulate(**BENCH)
    graph, means = ba.build(sim, dtype=torch.float32)
    cmg = sweep_cm.prepare(graph, segsum_exact=True)
    n_valid = graph.fblocks[0].n_valid
    print(f"[main] bench scene on {means[0].device}: {BENCH['n_cams']} cams, "
          f"{sim['lmk_init'].shape[0]} lmks, {n_valid} factors in {cmg.mp} rows "
          f"(deg {cmg.fb.ell_deg})")
    init = sweep_cm.init_state(cmg, means)
    torch.cuda.synchronize()

    M.COUNTS.reset()
    t0 = time.perf_counter()
    state = sync(sweep_cm.run(cmg, init, CFG, SWEEPS))
    t_first = time.perf_counter() - t0
    launches = check_counts("the bench path", (*FULL, *BELIEFS), SWEEPS)
    print(f"[main] {SWEEPS} sweeps (first call) in {t_first:.3f} s; launches {launches}; "
          f"plain calls 0")
    hold_fold_path("main", lambda: sweep_cm.sweep(cmg, state, CFG))

    are = are_px(graph, cmg, state, sim["k"])
    mu = means
    for _ in range(6):
        mu = schur.gauss_newton_step(graph, mu, cg_iters=60)
    are_map = float(ba.avg_reprojection_error(
        graph, ba.with_means(sweep_cm.to_gbp_state(cmg, state), mu), k=sim["k"]))
    print(f"[main] ARE after {SWEEPS} sweeps {are:.6f} px; MAP (6 Gauss-Newton steps) "
          f"{are_map:.6f} px; ratio {are / are_map:.6f}")
    if not (are == are and are_map == are_map and are <= 1.05 * are_map):
        raise AssertionError(f"ARE {are} not within 1.05x of MAP ARE {are_map}")

    again = sync(sweep_cm.run(cmg, init, CFG, SWEEPS))
    for vi, (a, b) in enumerate(zip(state.v, again.v)):
        if not torch.equal(a.mean, b.mean):
            raise AssertionError(f"rerun from the same init differs (variable block {vi})")
    print("[main] rerun from the same init: means bitwise equal")
    timed_sweeps("main", cmg, init, SWEEPS, n_valid, card)
    return launches


def big_path(tag, scene, card, against_plain):
    """Phase 7 for one merged-blocks scene, through the entry points a user
    calls, on the default device."""
    t0 = time.perf_counter()
    sim = ba.simulate_blocks(**scene)
    graph, means = ba.build(sim, dtype=torch.float32, **BIG)
    cmg = sweep_cm.prepare(graph, segsum_exact=True, window=True)
    n_valid = graph.fblocks[0].n_valid
    if not cmg.win_w or cmg.vperm is None:
        raise AssertionError(f"{tag}: the windows did not engage through the locality sort")
    init = sweep_cm.init_state(cmg, means)
    are0 = are_px(graph, cmg, init, sim["k"])
    torch.cuda.synchronize()
    print(f"[{tag}] scene on {means[0].device}: {sim['cam_init'].shape[0]} cams, "
          f"{sim['lmk_init'].shape[0]} lmks, {n_valid} factors in {cmg.mp} rows (deg "
          f"{cmg.fb.ell_deg}); {cmg.mp // M.TILE} tiles, win_w {cmg.win_w}, "
          f"{int(cmg.blk_offsets[-1])} tiles in the scatter's block lists; built and prepared in "
          f"{time.perf_counter() - t0:.1f} s; initial ARE {are0:.6f} px")

    M.COUNTS.reset()
    t0 = time.perf_counter()
    state = sync(sweep_cm.run(cmg, init, CFG, QUALITY_SWEEPS))
    t_first = time.perf_counter() - t0
    launches = check_counts(f"the {tag} path", (*WINDOWED, *BELIEFS), QUALITY_SWEEPS)
    are = are_px(graph, cmg, state, sim["k"])
    print(f"[{tag}] {QUALITY_SWEEPS} sweeps (first call) in {t_first:.3f} s; launches "
          f"{launches}; plain calls 0; ARE {are:.6f} px")
    plan = M.window_plan("messages_cm_tabblk_ell", torch.float32, win_w=cmg.win_w, mp=cmg.mp)
    print(f"[{tag}] kernel 10 {'folds' if plan['folded'] else 'does not fold'}: "
          f"{cmg.mp // M.TILE} tiles on {plan['blocks']} blocks")
    hold_fold_path(tag, lambda: sweep_cm.sweep(cmg, state, CFG), unfolded=not plan["folded"])
    if not (math.isfinite(are) and are < are0):
        raise AssertionError(f"{tag}: ARE {are} is not finite and below the initial {are0}")

    if against_plain:
        with plain_versions():
            ref = sync(sweep_cm.run(cmg, init, CFG, QUALITY_SWEEPS))
        are_ref = are_px(graph, cmg, ref, sim["k"])
        print(f"[{tag}] the same {QUALITY_SWEEPS} sweeps through the plain versions on the "
              f"card: ARE {are_ref:.6f} px (difference {abs(are - are_ref):.3e})")
        if not abs(are - are_ref) <= 1e-2:
            raise AssertionError(f"{tag}: ARE {are} vs plain versions' {are_ref}")
        again = sync(sweep_cm.run(cmg, init, CFG, QUALITY_SWEEPS))
        for vi, (a, b) in enumerate(zip(state.v, again.v)):
            if not torch.equal(a.mean, b.mean):
                raise AssertionError(f"{tag}: rerun from the same init differs (block {vi})")
        print(f"[{tag}] rerun from the same init: means bitwise equal")
        mu = means
        for _ in range(6):
            mu = schur.gauss_newton_step(graph, mu, cg_iters=60)
        are_gn = float(ba.avg_reprojection_error(
            graph, ba.with_means(sweep_cm.to_gbp_state(cmg, state), mu), k=sim["k"]))
        print(f"[{tag}] ARE of 6 Gauss-Newton steps on the card {are_gn:.6f} px "
              f"(informational)")

    if tag == "venice":  # kernel 10 on the venice sweep's own operands
        args, kw = CW.recorded_calls(sweep_cm, ("messages_cm_tabblk_ell",),
                                     lambda: sweep_cm.sweep(cmg, state, CFG))[
            "messages_cm_tabblk_ell"]
        report_window_kernel(tag, "messages_cm_tabblk_ell", args, kw)
        # Its five outputs against the plain version's on the card, the fifth
        # against the model of its order and kernel 16 on the same messages.
        out = sync(M.messages_cm_tabblk_ell(*args, **kw))
        ref = sync(M.messages_cm_tabblk_ell_plain(*args, **kw))
        for i, (a, b) in enumerate(zip(out, ref)):
            rel, err = rel_err(a, b)
            print(f"[kernels] {tag} float32 messages_cm_tabblk_ell out{i}: max abs {err:.3e} rel "
                  f"{rel:.3e}")
            if not rel <= TOL[torch.float32]:
                raise AssertionError(f"messages_cm_tabblk_ell {tag} out{i}: rel err {rel:.3e}")
            note_rel("messages_cm_tabblk_ell", rel)
        del ref
        hold_fold(tag, torch.float32, out, fold_ops(cmg, args[1], kw.get("gslot", 0)),
                  lambda: M.messages_cm_tabblk_ell(*args, **kw), kw.get("huber"))
        # Kernel 16 on that call's new camera messages.
        report_segsum_blk(tag, out[0], out[1], args[-2], args[-1], cmg.mp // M.TILE, cmg.win_w)
        del out
    late = time.perf_counter() - T_START > VENICE_TIMING_DEADLINE_S
    n = QUALITY_SWEEPS if late else SWEEPS
    if late:
        print(f"[{tag}] past {VENICE_TIMING_DEADLINE_S:.0f} s of script time: timing {n} "
              f"sweeps instead of {SWEEPS}")
    per_sweep = timed_sweeps(tag, cmg, init, n, n_valid, card)
    return launches, (are, per_sweep)


def map_are(graph, state, means, k):
    """The ARE of 6 Gauss-Newton steps from `means`, on the card."""
    mu = means
    for _ in range(6):
        mu = schur.gauss_newton_step(graph, mu, cg_iters=60)
    return float(ba.avg_reprojection_error(graph, ba.with_means(state, mu), k=k))


def same_means(what, a, b):
    for vi, (x, y) in enumerate(zip(a.v, b.v)):
        if not torch.equal(x.mean, y.mean):
            raise AssertionError(f"{what}: rerun from the same init differs (variable block {vi})")
    print(f"[{what}] rerun from the same init: means bitwise equal")


def generic_path(card):
    """Phase 9.  Built on the default device: the card."""
    cfg = dataclasses.replace(CFG, message_form="pallas")
    sim = ba.simulate(**BENCH)
    graph, means = ba.build(sim, dtype=torch.float32, layout="ell")
    fb = graph.fblocks[0]
    print(f"[generic] bench scene on {means[0].device}: {fb.n_valid} factors in {fb.count} "
          f"row-major rows (ELL by landmark, deg {fb.ell_deg}), message_form 'pallas'")
    init = sweep.init_state(graph, means)
    are = lambda g, st: float(ba.avg_reprojection_error(g, st, k=sim["k"]))
    are50 = are(graph, sync(sweep.run(graph, init, cfg, QUALITY_SWEEPS)))

    per_sweep = {"fused_relin_messages": 1, "fused_messages": 1, "segsum_by_id": 1}
    M.COUNTS.reset()
    t0 = time.perf_counter()
    state = sync(sweep.run(graph, init, cfg, SWEEPS))
    t_first = time.perf_counter() - t0
    launches = check_counts("the generic path", per_sweep, SWEEPS)
    a, a_map = are(graph, state), map_are(graph, state, means, sim["k"])
    print(f"[generic] {SWEEPS} sweeps (first call) in {t_first:.3f} s; launches "
          f"{ {k: v for k, v in launches.items() if v} }; plain calls 0; ARE {a:.6f} px; MAP "
          f"{a_map:.6f} px; ratio {a / a_map:.6f}; ARE at {QUALITY_SWEEPS} sweeps {are50:.6f} px")
    if not (a == a and a_map == a_map and a <= 1.05 * a_map):
        raise AssertionError(f"generic path: ARE {a} not within 1.05x of MAP ARE {a_map}")
    same_means("generic", state, sync(sweep.run(graph, init, cfg, SWEEPS)))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sync(sweep.run(graph, init, cfg, SWEEPS))
    dt = time.perf_counter() - t0
    print(f"[generic] timed {SWEEPS} sweeps: {dt:.4f} s -> {SWEEPS / dt:.2f} sweeps/s, "
          f"{dt / SWEEPS / fb.n_valid * 1e9:.4f} ns per valid factor (informational; {card}); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    flat, means_n = ba.build(sim, dtype=torch.float32, layout="none")
    M.COUNTS.reset()
    t0 = time.perf_counter()
    st_n = sync(sweep.run(flat, sweep.init_state(flat, means_n), cfg, QUALITY_SWEEPS))
    dt = time.perf_counter() - t0
    check_counts("the generic path, layout none", {**per_sweep, "segsum_by_id": 2},
                 QUALITY_SWEEPS)
    fb_n = flat.fblocks[0]
    for k in (0, 1):
        ml = st_n.f[0].msg_lam[k]
        seg_args = (st_n.f[0].msg_eta[k], ml.reshape(ml.shape[0], -1), *fb_n.csr[k])
        M.COUNTS.reset()
        got = sync(M.segsum_by_id(*seg_args, row_major=True))
        rel, err = rel_err(got, M.segsum_by_id_plain(*seg_args, row_major=True))
        n_seg = fb_n.csr[k][1].shape[0] - 1
        print(f"[generic] layout none, slot {k} ({n_seg} segments): segsum_by_id "
              f"{dict(M.COUNTS.segsum_forms)} against its plain version: max abs {err:.3e} rel "
              f"{rel:.3e}")
        if M.COUNTS.segsum_forms["short"] != 1 or not rel <= TOL[torch.float32]:
            raise AssertionError(f"generic layout none slot {k}: form {M.COUNTS.segsum_forms}, "
                                 f"rel err {rel:.3e}")
        if not torch.equal(got, sync(M.segsum_by_id(*seg_args, row_major=True))):
            raise AssertionError(f"generic layout none slot {k}: two runs differ")
    a_n = are(flat, st_n)
    print(f"[generic] layout none, {QUALITY_SWEEPS} sweeps in {dt:.3f} s "
          f"({QUALITY_SWEEPS / dt:.2f} sweeps/s, first call): ARE {a_n:.6f} px vs ELL "
          f"{are50:.6f} px")
    if not abs(a_n - are50) <= 1e-3:
        raise AssertionError(f"generic path: layout none ARE {a_n} vs ELL {are50}")
    return launches


def rows_path(card):
    """Phase 10.  Built on the default device: the card."""
    sim = ba.simulate(**NONLOCAL)
    graph, means = ba.build(sim, dtype=torch.float32)
    cmg = sweep_cm.prepare(graph)
    n_valid = graph.fblocks[0].n_valid
    n_cam = graph.vblocks[0].count
    if cmg.gather_mode != "rows" or cmg.win_w:
        raise AssertionError(f"nonlocal512: prepare chose {cmg.gather_mode!r}, win_w {cmg.win_w}")
    init = sweep_cm.init_state(cmg, means)
    are0 = are_px(graph, cmg, init, sim["k"])
    print(f"[rows] nonlocal512 on {means[0].device}: {n_cam} cams "
          f"({n_cam * M.F_CAM * 4} bytes of packed beliefs, shared-memory table limit "
          f"{sweep_cm.SMEM_TABLE_BYTES}), {sim['lmk_init'].shape[0]} lmks, {n_valid} factors in "
          f"{cmg.mp} rows (deg {cmg.fb.ell_deg}); gather_mode {cmg.gather_mode!r}; initial ARE "
          f"{are0:.6f} px")
    names = (*ROWS_MODE, *BELIEFS)
    M.COUNTS.reset()
    st50 = sync(sweep_cm.run(cmg, init, CFG, QUALITY_SWEEPS))
    launches = check_counts("the rows path", names, QUALITY_SWEEPS)
    a50 = are_px(graph, cmg, st50, sim["k"])
    print(f"[rows] {QUALITY_SWEEPS} sweeps: launches { {k: launches[k] for k in names} }; plain "
          f"calls 0; ARE {a50:.6f} px")
    if not (math.isfinite(a50) and a50 < are0):
        raise AssertionError(f"rows path: ARE {a50} is not finite and below the initial {are0}")
    same_means("rows", st50, sync(sweep_cm.run(cmg, init, CFG, QUALITY_SWEEPS)))
    # segsum_by_id at this scene's shape, on the camera messages of sweep 50.
    seg_args = (st50.f.msg_eta[0], st50.f.msg_lam[0], cmg.seg_rows, cmg.seg_offsets)
    got = sync(M.segsum_by_id(*seg_args))
    rel, err = rel_err(got, M.segsum_by_id_plain(*seg_args))
    if not rel <= TOL[torch.float32]:
        raise AssertionError(f"segsum_by_id at nonlocal512: rel err {rel:.3e}")
    vals, gl = torch.cat(seg_args[:2]), cmg.gidx.long()
    ms = time_ms(lambda: M.segsum_by_id(*seg_args), 20)
    b_ms, b_by = segsum_bound_ms(seg_args, got)
    lib = lambda: torch.zeros((M.F_CAM, n_cam), device=got.device).index_add_(1, gl, vals)
    print(f"[rows] nonlocal512 segsum_by_id form (chunk, group) "
          f"{M.segsum_form(cmg.mp, n_cam, cmg.seg_rows.shape[0])}: kernel {ms:.4f} ms (device "
          f"{device_ms(lambda: M.segsum_by_id(*seg_args)):.4f}), bound {b_ms:.4f} ms ({b_by}), "
          f"index_add_ {time_ms(lib, 20):.4f} ms (device {device_ms(lib):.4f}); max abs "
          f"{err:.3e} rel {rel:.3e} ({card})")
    st = sync(sweep_cm.run(cmg, st50, CFG, SWEEPS - QUALITY_SWEEPS))
    a = are_px(graph, cmg, st, sim["k"])
    a_map = map_are(graph, sweep_cm.to_gbp_state(cmg, st), means, sim["k"])
    print(f"[rows] ARE after {SWEEPS} sweeps {a:.6f} px; MAP (6 Gauss-Newton steps) "
          f"{a_map:.6f} px; ratio {a / a_map:.6f}: "
          + ("within 1.05x of the MAP ARE" if a <= 1.05 * a_map else
             "NOT within 1.05x of the MAP ARE (informational at this scene)"))
    if not math.isfinite(a):
        raise AssertionError(f"rows path: ARE {a} after {SWEEPS} sweeps")
    timed_sweeps("rows", cmg, init, SWEEPS, n_valid, card)

    sim = ba.simulate(**BENCH)
    graph, means = ba.build(sim, dtype=torch.float32)
    ares = {}
    for mode in ("table", "rows", "take1"):
        cmg = sweep_cm.prepare(graph, gather_mode=mode)
        if cmg.gather_mode != mode:
            raise AssertionError(f"prepare(gather_mode={mode!r}) gave {cmg.gather_mode!r}")
        init = sweep_cm.init_state(cmg, means)
        sync(sweep_cm.run(cmg, init, CFG, 5))
        M.COUNTS.reset()
        t0 = time.perf_counter()
        st = sync(sweep_cm.run(cmg, init, CFG, QUALITY_SWEEPS))
        dt = time.perf_counter() - t0
        check_counts(f"bench64 {mode}", (*FULL, *BELIEFS) if mode == "table" else names,
                     QUALITY_SWEEPS)
        ares[mode] = are_px(graph, cmg, st, sim["k"])
        print(f"[rows] bench64 gather_mode {mode!r}: {QUALITY_SWEEPS} sweeps in {dt:.4f} s "
              f"({QUALITY_SWEEPS / dt:.2f} sweeps/s), ARE {ares[mode]:.6f} px")
    if not all(abs(ares[m] - ares["table"]) <= 1e-3 for m in ares):
        raise AssertionError(f"gather modes disagree at bench64: {ares}")
    return launches


def unfused_path(card):
    """Phase 14.  Built on the default device: the card."""
    sim = ba.simulate(**BENCH)
    graph, means = ba.build(sim, dtype=torch.float32)
    n_valid = graph.fblocks[0].n_valid
    n = QUALITY_SWEEPS
    out = {}
    for fused, names in ((True, (*FULL, *BELIEFS)),
                         (False, (*UNFUSED, "segsum_by_id", *BELIEFS))):
        cmg = sweep_cm.prepare(graph, ell_fused=fused)
        if cmg.ell_fused != fused or cmg.gather_mode != "table" or cmg.win_w:
            raise AssertionError(f"prepare(ell_fused={fused}) gave ell_fused {cmg.ell_fused}, "
                                 f"mode {cmg.gather_mode!r}, win_w {cmg.win_w}")
        init = sweep_cm.init_state(cmg, means)
        sync(sweep_cm.run(cmg, init, CFG, 5))
        M.COUNTS.reset()
        t0 = time.perf_counter()
        st = sync(sweep_cm.run(cmg, init, CFG, n))
        dt = time.perf_counter() - t0
        launches = check_counts(f"bench64 ell_fused={fused}", names, n)
        out[fused] = (are_px(graph, cmg, st, sim["k"]), dt, launches, cmg, init, st)
    (a_f, dt_f, _, _, _, _), (a_u, dt_u, launches, cmg, init, st) = out[True], out[False]
    print(f"[unfused] bench64, {n} sweeps, ell_fused=False: launches "
          f"{ {k: launches[k] for k in (*UNFUSED, 'segsum_by_id')} }; plain calls 0; ARE "
          f"{a_u:.6f} px vs fused {a_f:.6f} px; {dt_u / n * 1e3:.4f} ms per sweep "
          f"({n / dt_u:.2f} sweeps/s) vs fused {dt_f / n * 1e3:.4f} ms ({n / dt_f:.2f} sweeps/s) "
          f"({card})")
    if not (math.isfinite(a_u) and abs(a_u - a_f) <= 1e-3):
        raise AssertionError(f"unfused path: ARE {a_u} vs the fused path's {a_f}")
    same_means("unfused", st, sync(sweep_cm.run(cmg, init, CFG, n)))
    timed_sweeps("unfused", cmg, init, SWEEPS, n_valid, card)
    return launches


def unfused_big_path(tag, scene, card, fused):
    """Phase 19 for one merged-blocks scene: `prepare(window=True,
    ell_fused=False)`, the windowed unfused kernels (kernels 8 and 9 of the
    reference) with the expansion and the windowed camera sum.  `fused` is
    (ARE after QUALITY_SWEEPS sweeps, seconds per sweep) of the fused
    windowed run of `big_path`; with `against_fused` the ARE is held to
    1e-3 px of it and a rerun must repeat bit for bit."""
    sim = ba.simulate_blocks(**scene)
    graph, means = ba.build(sim, dtype=torch.float32, **BIG)
    cmg = sweep_cm.prepare(graph, window=True, ell_fused=False)
    n_valid = graph.fblocks[0].n_valid
    if not cmg.win_w or cmg.ell_fused or cmg.gather_mode != "table":
        raise AssertionError(f"{tag}: prepare(ell_fused=False) gave win_w {cmg.win_w}, "
                             f"ell_fused {cmg.ell_fused}, mode {cmg.gather_mode!r}")
    init = sweep_cm.init_state(cmg, means)
    are0 = are_px(graph, cmg, init, sim["k"])
    sync(sweep_cm.run(cmg, init, CFG, 2))
    M.COUNTS.reset()
    t0 = time.perf_counter()
    state = sync(sweep_cm.run(cmg, init, CFG, QUALITY_SWEEPS))
    dt = time.perf_counter() - t0
    launches = check_counts(f"the {tag} unfused path", (*UNFUSED_WIN_PATH, *BELIEFS),
                            QUALITY_SWEEPS)
    are = are_px(graph, cmg, state, sim["k"])
    print(f"[{tag}_unfused] {n_valid} factors in {cmg.mp} rows, win_w {cmg.win_w}: "
          f"{QUALITY_SWEEPS} sweeps, launches { {k: launches[k] for k in UNFUSED_WIN_PATH} }; "
          f"plain calls 0; ARE {are0:.6f} -> {are:.6f} px vs fused {fused[0]:.6f} px; "
          f"{dt / QUALITY_SWEEPS * 1e3:.4f} ms per sweep ({QUALITY_SWEEPS / dt:.2f} sweeps/s) vs "
          f"fused {fused[1] * 1e3:.4f} ms ({1 / fused[1]:.2f} sweeps/s) ({card})")
    if not (math.isfinite(are) and are < are0):
        raise AssertionError(f"{tag} unfused: ARE {are} is not finite and below {are0}")
    if tag == "city":
        if not abs(are - fused[0]) <= 1e-3:
            raise AssertionError(f"city unfused: ARE {are} vs the fused path's {fused[0]}")
        same_means("city_unfused", state, sync(sweep_cm.run(cmg, init, CFG, QUALITY_SWEEPS)))
    else:  # kernel 8 on the venice sweep's own operands
        args, kw = CW.recorded_calls(sweep_cm, ("messages_cm_tabblk",),
                                     lambda: sweep_cm.sweep(cmg, state, CFG))["messages_cm_tabblk"]
        report_window_kernel(f"{tag}_unfused", "messages_cm_tabblk", args, kw)
    return launches


def bal_path(card):
    """Phase 20: the BA command line (`python -m gbp_tpu_torch.ba`) in this
    process, on the card: ladybug49 with and without its intrinsics in the
    state, 100 annealed sweeps and the dense MAP; then the corridor file
    under the full default schedule."""
    out = {}
    for extra in ("", "--optimize_intrinsics"):
        argv = ["--bal_file", str(LADYBUG), "--n_iters", "100", "--oracle", *extra.split()]
        M.COUNTS.reset()
        res = ba_cli.main(argv)
        launches = check_counts(f"ladybug49 {extra or 'fixed intrinsics'}", (*FULL, *BELIEFS),
                                100)
        final, are_map = res["are"][-1][1], res["are_map"]
        ref = LADYBUG_REFERENCE_CPU[extra]
        print(f"[bal] ladybug49 {extra or '(fixed intrinsics)'}: launches "
              f"{ {k: launches[k] for k in FULL} }; plain calls 0; ARE per 10 sweeps on the card "
              f"vs the reference's CPU run: "
              + ", ".join(f"{i}: {a:.4f}" + (f" ({ref[i]:.4f})" if i in ref else "")
                          for i, a in res["are"])
              + f"; final {final:.6f} px, dense MAP {are_map:.6f} px, ratio "
              f"{final / are_map:.6f}; {res['sweeps_per_s']:.2f} sweeps/s ({card})")
        if not (math.isfinite(final) and final <= 1.05 * are_map):
            raise AssertionError(f"ladybug49 {extra}: ARE {final} not within 1.05x of {are_map}")
        again = ba_cli.main([a for a in argv if a != "--oracle"])
        same_means(f"ladybug49 {extra or 'fixed'}", res["state"], again["state"])
        out[extra] = launches
    res = ba_cli.main(["--bal_file", str(CORRIDOR), "--prior_prec", "1000"])
    ares = [a for _, a in res["are"]]
    print(f"[bal] corridor_sim, prior_prec 1000, float32, default schedule: ARE "
          + ", ".join(f"{a:.4f}" for a in ares))
    if not (all(map(math.isfinite, ares)) and ares[-1] < ares[0]):
        raise AssertionError(f"corridor: ARE {ares} not finite and falling")
    return out[""]


def annealed_city(card):
    """Phase 21: `run_annealed_cm` on the city scene, 50 sweeps through the
    windowed kernels under the default schedule (the reference's
    tests/test_table_window.py runs the same on its city scene)."""
    sim = ba.simulate_blocks(**CITY)
    graph, means = ba.build(sim, dtype=torch.float32, **BIG)
    cmg = sweep_cm.prepare(graph, window=True)
    init = sweep_cm.init_state(cmg, means)
    are0 = are_px(graph, cmg, init, sim["k"])
    M.COUNTS.reset()
    t0 = time.perf_counter()
    st = sync(anneal.run_annealed_cm(cmg, init, CFG, QUALITY_SWEEPS))
    dt = time.perf_counter() - t0
    check_counts("annealed city", (*WINDOWED, *BELIEFS), QUALITY_SWEEPS)
    are = are_px(graph, cmg, st, sim["k"])
    print(f"[anneal] city, {QUALITY_SWEEPS} annealed sweeps in {dt:.3f} s (first call): ARE "
          f"{are0:.6f} -> {are:.6f} px ({card})")
    if not (math.isfinite(are) and are < are0):
        raise AssertionError(f"annealed city: ARE {are} not finite and below {are0}")


def mode_kernels(cmg):
    """The kernels one sweep of the prepared graph launches, once each."""
    beliefs = BELIEFS if len(set(cmg.fb.vblocks)) == 2 else ()
    if cmg.gather_mode != "table":
        return (*ROWS_MODE, *beliefs)
    if not cmg.ell_fused:
        return (*(UNFUSED_WIN_PATH if cmg.win_w else (*UNFUSED, "segsum_by_id")), *beliefs)
    return (*(WINDOWED if cmg.win_w else FULL), *beliefs)


def pose_run(tag, graph, means, truth, n, card, prep_kw=None, timed=False, gate=1.0):
    """Prepare a pose graph, run `n` sweeps through the kernels (launch
    counts checked, plain calls 0), return (cmg, state, ATE, initial ATE,
    launch counts).  The ATE must be finite and below `gate` times the
    initial one (None: finite)."""
    cmg = sweep_cm.prepare(graph, **(prep_kw or {}))
    if cmg is None:
        raise AssertionError(f"{tag}: prepare declined the graph")
    fb = graph.fblocks[0]
    init = sweep_cm.init_state(cmg, means)
    ate0 = pose_graph.ate(means[0], truth)
    torch.cuda.synchronize()
    M.COUNTS.reset()
    t0 = time.perf_counter()
    st = sync(sweep_cm.run(cmg, init, PCFG, n))
    dt = time.perf_counter() - t0
    launches = check_counts(tag, mode_kernels(cmg), n)
    ate = pose_graph.ate(st.v[0].mean, truth)
    print(f"[pose] {tag} on {means[0].device}: {graph.vblocks[0].count} poses, {fb.n_valid} "
          f"factors in {cmg.mp} rows (deg {fb.ell_deg}, ELL slot {fb.ell_slot}), mode "
          f"{cmg.gather_mode!r}, ell_fused {cmg.ell_fused}, win_w {cmg.win_w}; {n} sweeps (first "
          f"call) in {dt:.3f} s; launches { {k: v for k, v in launches.items() if v} }; plain "
          f"calls 0; ATE {ate0:.6f} -> {ate:.6f}")
    if not (math.isfinite(ate) and (gate is None or ate < gate * ate0)):
        raise AssertionError(f"{tag}: ATE {ate} is not finite and below {gate} x the initial "
                             f"{ate0}")
    if timed:
        same_means(tag, st, sync(sweep_cm.run(cmg, init, PCFG, n)))
        timed_sweeps(tag, cmg, init, n, fb.n_valid, card, PCFG)
    return cmg, st, ate, ate0, launches


def pose_path(card):
    """Phase 15.  Built on the default device: the card."""
    f32 = torch.float32
    sim = pose_graph.simulate_manhattan(**M4000)
    graph, means = pose_graph.build(sim, layout="ell")
    n_poses = M4000["n_poses"]
    n_g = graph.vblocks[0].count
    print(f"[pose] manhattan4000: {n_g * 12 * 4} bytes of packed pose beliefs, shared-memory "
          f"table limit {sweep_cm.SMEM_TABLE_BYTES}")
    cmg, st, ate, ate0, launches = pose_run("manhattan4000", graph, means, sim["truth"], 400,
                                            card, timed=True)
    if not all(launches[k] == 400 for k in mode_kernels(cmg)):
        raise AssertionError(f"manhattan4000 launched {launches}")
    t0 = time.perf_counter()
    mu = sync(schur.solve_pcg(graph, means, n_steps=8, cg_iters=max(1000, n_poses // 2)))
    ate_gn = pose_graph.ate(mu[0], sim["truth"])
    target = 1.25 * ate_gn + 0.02
    print(f"[pose] manhattan4000 Gauss-Newton target (8 PCG steps of "
          f"{max(1000, n_poses // 2)} iterations on the card, {time.perf_counter() - t0:.1f} s): "
          f"ATE_GN {ate_gn:.6f}; bar 1.25 x ATE_GN + 0.02 = {target:.6f}")
    if not math.isfinite(ate_gn):
        raise AssertionError(f"pose path: ATE_GN {ate_gn}")
    chunk, reached, traj = 50, None, []
    state = sweep_cm.init_state(cmg, means)
    t0 = time.perf_counter()
    for i in range(6000 // chunk):
        state = sync(sweep_cm.run(cmg, state, PCFG, chunk))
        a = pose_graph.ate(state.v[0].mean, sim["truth"])
        traj.append(round(a, 4))
        if a <= target:
            reached = ((i + 1) * chunk, time.perf_counter() - t0)
            break
    print("[pose] manhattan4000 ATE per 50 sweeps " + str(traj[:20]) + ": "
          + (f"at or below the bar at sweep {reached[0]} ({reached[1]:.3f} s of wall clock)"
             if reached else "did NOT reach the bar within 6000 sweeps (throughput only)"))

    # 200 poses, the graph of the reference's float32 test: half the initial
    # ATE within 150 sweeps.
    sim = pose_graph.simulate_manhattan(**M200)
    graph, means = pose_graph.build(sim, layout="ell")
    pose_run("manhattan200", graph, means, sim["truth"], 150, card, gate=0.5)

    # 1,000 poses: the largest table that fits shared memory; fused against
    # unfused.  Its diameter is far beyond 150 sweeps (the ATE is still in its
    # transient, and may pass above the initial one), so the two paths'
    # agreement is held.  The fused kernel adds the camera-side sum in its own
    # order (its messages launch), the unfused path by segsum_by_id: in
    # float32 the transient amplifies that reassociation, so the unfused path
    # runs once more with its sum in a third order (segsum_by_id's plain
    # version, nothing else changed) to show that spread beside the gap, and
    # float64 (500 poses, the largest float64 table) holds the paths to
    # POSE_F64_TOL after the same 150 sweeps.
    for tag, kw, dt in (("manhattan1000", M1000, torch.float32),
                        ("manhattan500 float64", M1000_F64, torch.float64)):
        sim = pose_graph.simulate_manhattan(**kw)
        graph, means = pose_graph.build(sim, layout="ell", dtype=dt)
        runs = {}
        for fused in (True, False):
            cmg, st, ate, ate0, _ = pose_run(f"{tag} ell_fused={fused}", graph, means,
                                             sim["truth"], 150, card,
                                             prep_kw=dict(ell_fused=fused), gate=None)
            if cmg.gather_mode != "table" or cmg.ell_fused != fused:
                raise AssertionError(f"{tag}: mode {cmg.gather_mode!r}, ell_fused "
                                     f"{cmg.ell_fused}")
            runs[fused] = (cmg, st)
        gap = float((runs[True][1].v[0].mean - runs[False][1].v[0].mean).abs().max())
        one = [sync(sweep_cm.sweep(cmg, runs[True][1], PCFG)).v[0].mean
               for cmg, _ in runs.values()]
        gap1 = float((one[0] - one[1]).abs().max())
        cmg = runs[False][0]
        with plain_versions(("segsum_by_id",)):
            other = sync(sweep_cm.run(cmg, sweep_cm.init_state(cmg, means), PCFG, 150))
        spread = float((other.v[0].mean - runs[False][1].v[0].mean).abs().max())
        bar1, bar = (1e-4, POSE_F32_GAP) if dt == torch.float32 else (POSE_F64_TOL,) * 2
        print(f"[pose] {tag} fused vs unfused, largest difference of the means: one sweep from "
              f"the same state {gap1:.3e} (held to {bar1:g}); after 150 sweeps each {gap:.3e} "
              f"(held to {bar:g}); the unfused path's 150 sweeps with its camera-side sum in "
              f"another order {spread:.3e}")
        if not gap1 <= bar1:
            raise AssertionError(f"{tag}: fused and unfused means differ by {gap1} after one "
                                 f"sweep")
        if not gap <= bar:
            raise AssertionError(f"{tag}: fused and unfused means differ by {gap} after 150 "
                                 f"sweeps")

    # 1,500 poses: chain locality engages the windows.
    sim = pose_graph.simulate_manhattan(**M1500)
    graph, means = pose_graph.build(sim, layout="ell")
    ates = {}
    for window in (True, False):
        cmg, st, ates[window], _, _ = pose_run(f"manhattan1500 window={window}", graph, means,
                                               sim["truth"], QUALITY_SWEEPS, card,
                                               prep_kw=dict(window=window))
        if bool(cmg.win_w) != window:
            raise AssertionError(f"manhattan1500: prepare(window={window}) gave win_w {cmg.win_w}")
    if not abs(ates[True] - ates[False]) <= 1e-3:
        raise AssertionError(f"manhattan1500: windowed ATE {ates[True]} vs {ates[False]}")

    # SE(3): a 250-pose helix, diagonal information, table mode.
    data = pose_graph.simulate_helix(**HELIX)
    graph, means = pose_graph.build_g2o(data, dtype=f32, layout="ell")
    # Its initial estimate is the truth plus 5 cm of noise, and the first
    # hundreds of sweeps of the schedule move the chain away from it before it
    # settles (0.085 -> 0.89 at 100 sweeps in the reference as well): the ATE is
    # held finite, not falling.
    pose_run("helix250 (SE(3))", graph, means, data["truth"], 100, card, gate=None)

    # A g2o file with full information matrices: the generic engine.
    data = g2o.read_g2o(G2O_FILE)
    graph, means = pose_graph.build_g2o(data, huber=2.0, dtype=f32, layout="ell")
    if sweep_cm.prepare(graph) is not None:
        raise AssertionError("manhattan_sim.g2o: prepare took a full-precision graph")
    cfg = dataclasses.replace(PCFG, message_form="pallas")
    state = sweep.init_state(graph, means)
    e0 = float(sweep.energy(graph, state))
    M.COUNTS.reset()
    state = sync(sweep.run(graph, state, cfg, 100))
    got = {k: v for k, v in M.COUNTS.kernel.items() if v}
    e1 = float(sweep.energy(graph, state))
    print(f"[pose] {G2O_FILE.name} ({data['kind']}, {data['poses'].shape[0]} poses, "
          f"{data['edges_ij'].shape[0]} edges, full information): generic engine, 100 sweeps, "
          f"launches {got}, plain calls {sum(M.COUNTS.plain.values())}; energy {e0:.3f} -> "
          f"{e1:.3f}")
    if any(M.COUNTS.plain.values()) or got.get("fused_relin_messages") != 100:
        raise AssertionError(f"g2o path did not run through its kernels: {got}")
    if not (math.isfinite(e1) and e1 < e0):
        raise AssertionError(f"g2o path: energy {e0} -> {e1}")


def linear_path():
    """Phase 11: a linear chain, where GBP is exact, through the (1, 1, 1)
    instantiation of the row-major messages kernel, in float64."""
    n, sweeps = 50, 300
    graph, means = toy.build(toy.simulate(n=n), dtype=torch.float64)
    cfg = sweep.GBPConfig(message_form="pallas")
    M.COUNTS.reset()
    state = sync(sweep.run(graph, sweep.init_state(graph, means), cfg, sweeps))
    # The smoothness block goes through the kernel; its two slots and the
    # unary block's one are summed by the deterministic segment sum.
    check_counts("the linear path", {"fused_messages": 1, "segsum_by_id": 3}, sweeps)
    err = float((state.v[0].mean - oracle.map_solution(graph, state)[0]).abs().max())
    print(f"[linear] toy chain of {n} on {means[0].device}, float64, {sweeps} sweeps under "
          f"message_form 'pallas': largest difference from the dense MAP solution {err:.3e}")
    if not err <= 1e-9:
        raise AssertionError(f"linear path: {err:.3e} from the oracle")


# --- the halo paths (phases 22 and 23) ------------------------------------------------


def halo_mode_kernels(hcm):
    """The kernels one partition's sweep launches, once each."""
    if hcm.gather_mode != "table":
        return ROWS_MODE
    if hcm.win_w:
        return HALO_FUSED_PATH if hcm.ell_fused else HALO_UNFUSED_PATH
    return FULL if hcm.ell_fused else (*UNFUSED, "segsum_by_id")


def halo_widened(hcm, w):
    """`hcm` with every partition's owned-camera windows widened to `w`
    (starts moved down where the wider window would pass the padded owned
    count): still a valid windowing, at the shared-memory sizes of wider
    scenes."""
    dev = hcm.gidx.device
    no = hcm.comm[hcm.vb_g].n_own_max
    nopad = -(-no // sweep_cm.SUB) * sweep_cm.SUB
    starts = np.minimum(hcm.win_starts.cpu().numpy(), nopad - w) // sweep_cm.SUB * sweep_cm.SUB
    if w > nopad or (starts < 0).any():
        raise ValueError(f"a window of {w} does not fit {nopad} owned cameras")
    gidx = hcm.gidx.cpu().numpy()
    csr = [M.window_rows_csr(gidx[c], starts[c], w, n_own=no) for c in range(len(starts))]
    blk = [M.window_block_csr(starts[c], w, no) for c in range(len(starts))]
    i32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32, device=dev)
    padded = lambda lists: np.stack([np.pad(a, (0, max(len(b) for b, _ in lists) - len(a)))
                                     for a, _ in lists])
    return hcm._replace(win_w=w, win_starts=i32(starts),
                        win_rows=i32(np.stack([a for a, _ in csr])),
                        win_offsets=i32(np.stack([b for _, b in csr])),
                        blk_tiles=i32(padded(blk)), blk_offsets=i32(np.stack([b for _, b in blk])))


def halo_state(sim, dtype, n_parts, sweeps):
    """The halo_cm partition of `sim` (plain layout) and its state after
    `sweeps` plain sweeps on the CPU, both moved to the card."""
    g, m = ba.build(sim, dtype=dtype, device="cpu", **HALO_BUILD)
    hp, hcm, st, run = halo_cm.distribute(g, m, n_parts, device="cpu")
    st = run(hcm, st, CFG, sweeps)
    return halo.to_device(hcm, "cuda"), halo.to_device(st, "cuda")


def check_halo_kernels(tag, hcm, st, dtype, errs, timings=None, masked=False):
    """Phase 22 for one partitioned scene and dtype: per partition, kernels
    12, 13, 17 and 18 against their plain versions on the operands the halo
    sweep hands them (relinearization at the median distance and at the
    config's beta, messages with and without Huber); timed on partition 0
    when `timings` is given.  `masked` (phase 25 (a)): per partition the four
    again under partial schedule masks, and the partition's gathered-slot
    sums of those messages."""
    tol = TOL[dtype]
    tag = f"{tag} {str(dtype)[6:]}"
    d_e = hcm.dofs[hcm.e]
    f_e = d_e + d_e * d_e
    gslot = 1 - hcm.e
    no = hcm.comm[hcm.vb_g].n_own_max
    tab_e, mean_e, tab_g, mean_g, gtab_g, gmean_g = halo_cm.belief_tables(hcm, st)
    wkw = dict(win_w=hcm.win_w, n_own=no, gslot=gslot)
    print(f"[halo kernels] {tag}: {hcm.z.shape[0]} partitions, {hcm.mp // M.TILE} tiles each, "
          f"win_w {hcm.win_w} ({hcm.win_w * tab_g.shape[2] * tab_g.element_size()} bytes of "
          f"packed beliefs per block), ghost table {gtab_g.shape[1]} rows, cut cameras "
          f"{hcm.n_cut}")

    def compare(name, got, ref):
        worst_rel, worst_abs = 0.0, 0.0
        for i, (a, b) in enumerate(zip(got, ref)):
            rel, err = rel_err(a, b)
            if not rel <= tol:
                raise AssertionError(f"{name} {tag} out{i}: rel err {rel:.3e} > {tol:g}")
            worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, err)
        print(f"[halo kernels] {tag} {name}: {len(got)} outputs, max abs {worst_abs:.3e} rel "
              f"{worst_rel:.3e}")
        errs[name] = max(errs.get(name, 0.0), worst_abs)
        note_rel(name, worst_rel)

    for name in HALO_KERNELS[1::2]:
        print_plan(tag, name, dtype, win_w=hcm.win_w, mp=hcm.mp, d0=hcm.dofs[0],
                   d1=hcm.dofs[1], z=hcm.z.shape[1], gslot=gslot)
    for p in range(hcm.z.shape[0]):
        fs = sweep_cm.CMFactorState(*(halo._at(x, p) for x in st.f))
        cm_e = sync(M.expand_ell_blk(torch.cat([tab_e[p], mean_e[p]], 1), deg=hcm.deg))
        be_e, bl_e, x_e = cm_e[:d_e], cm_e[d_e:f_e], cm_e[f_e:]
        state_r = (fs.lp, fs.jac, fs.r0, fs.srel, hcm.act[p])
        msgs = (fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1], fs.msg_lam[1])
        x = halo_cm.expand_means(hcm, st)[p]
        on = hcm.act[p, 0] > 0.5
        beta_mid = float(((x - fs.lp) ** 2).sum(0).sqrt()[on].double().median())
        calls = {}
        for beta in (beta_mid, CFG.beta):  # the config's beta last: its outputs feed on
            params = _kernel_params(dataclasses.replace(CFG, beta=beta), dtype)
            calls["relin_cm_tabblkg_ell"] = (
                (params, mean_g[p, :no], gmean_g[p], mean_e[p], hcm.gidx[p], hcm.win_starts[p],
                 hcm.z[p], *state_r),
                dict(deg=hcm.deg, comp_name=hcm.comp_name, fargs=None, **wkw))
            calls["relin_cm_tabblkg"] = (
                (params, x_e, mean_g[p, :no], gmean_g[p], hcm.gidx[p], hcm.win_starts[p],
                 hcm.z[p], None, *state_r), dict(comp_name=hcm.comp_name, **wkw))
            for name in ("relin_cm_tabblkg_ell", "relin_cm_tabblkg"):
                args, kw = calls[name]
                ref_r = sync(getattr(M, name + "_plain")(*args, **kw))
                n_relin, n_on = int((ref_r[3] == 0).sum()), int(on.sum())
                if n_relin == 0 or (beta == beta_mid and n_relin == n_on):
                    raise AssertionError(f"{tag}: the relinearization check needs both kinds "
                                         f"of rows")
                compare(name, sync(getattr(M, name)(*args, **kw)), ref_r)
        lp, jac, r0, srel = ref_r
        head = (jac, lp, r0, hcm.prec[p], srel, hcm.act[p])
        for huber in (None, 1.0):
            params = _kernel_params(CFG, dtype)
            calls["messages_cm_tabblkg_ell"] = (
                (params, tab_g[p, :no], gtab_g[p], tab_e[p], hcm.gidx[p], hcm.win_starts[p],
                 *head, *msgs), dict(deg=hcm.deg, huber=huber, **wkw))
            calls["messages_cm_tabblkg"] = (
                (params, *head, be_e, bl_e, tab_g[p, :no], gtab_g[p], hcm.gidx[p],
                 hcm.win_starts[p], *msgs), dict(huber=huber, **wkw))
            for name in ("messages_cm_tabblkg_ell", "messages_cm_tabblkg"):
                args, kw = calls[name]
                compare(name, sync(getattr(M, name)(*args, **kw)),
                        sync(getattr(M, name + "_plain")(*args, **kw)))
        # The partition's two gathered-slot sums on these messages: the
        # windows combined by kernel 15, the ghost rows by segsum_by_id.
        args, kw = calls["messages_cm_tabblkg_ell"]
        o = sync(M.messages_cm_tabblkg_ell_plain(*args, **kw))
        me_g, ml_g = o[2 * gslot], o[2 * gslot + 1]
        blk = (me_g, ml_g, hcm.win_rows[p], hcm.win_offsets[p])
        part = sync(M.segsum_cm_blk(*blk, n_tiles=hcm.mp // M.TILE, w=hcm.win_w))
        hold_segsum_blk(f"{tag} partition {p} (owned rows)", part, *blk)
        if timings is not None and p == 0:
            report_segsum_blk(f"{tag} partition 0", *blk, hcm.mp // M.TILE, hcm.win_w)
        sc_args = (part, hcm.win_starts[p], hcm.blk_tiles[p], hcm.blk_offsets[p])
        exact("scatter_windows_cm", sync(M.scatter_windows_cm(*sc_args, n_seg=no)),
              scatter_plain(*sc_args, n_seg=no), f"{tag} partition {p}")
        ext = (me_g, ml_g, hcm.ext_rows[p], hcm.ext_offsets[p])
        print(f"[halo kernels] {tag} segsum_by_id on the ghost rows: form (chunk, group) "
              f"{M.segsum_form(hcm.mp, hcm.ext_offsets.shape[1] - 1, hcm.ext_rows.shape[1])}")
        compare("segsum_by_id (ghost rows)", (sync(M.segsum_by_id(*ext)),),
                (M.segsum_by_id_plain(*ext),))
        if masked:
            acts, held = schedule_acts(x, hcm.act[p]), {}
            for name in HALO_KERNELS:
                args, kw = calls[name]
                relin = name.startswith("relin")
                held[name] = hold_masked(f"{tag} partition {p}", name, getattr(M, name),
                                         getattr(M, name + "_plain"), args, kw,
                                         (state_r if relin else head)[-1], acts,
                                         relin_kept(fs) if relin else messages_kept(fs),
                                         lambda label, got, ref: compare(label, got, ref))
            for label, o in held["messages_cm_tabblkg_ell"].items():
                me_g, ml_g = o[2 * gslot], o[2 * gslot + 1]
                blk = (me_g, ml_g, hcm.win_rows[p], hcm.win_offsets[p])
                part = sync(M.segsum_cm_blk(*blk, n_tiles=hcm.mp // M.TILE, w=hcm.win_w))
                hold_segsum_blk(f"{tag} partition {p} {label} mask", part, *blk)
                sc_args = (part, hcm.win_starts[p], hcm.blk_tiles[p], hcm.blk_offsets[p])
                exact("scatter_windows_cm", sync(M.scatter_windows_cm(*sc_args, n_seg=no)),
                      scatter_plain(*sc_args, n_seg=no), f"{tag} partition {p} {label} mask")
                ext = (me_g, ml_g, hcm.ext_rows[p], hcm.ext_offsets[p])
                compare(f"segsum_by_id (ghost rows)[{label} mask]",
                        (sync(M.segsum_by_id(*ext)),), (M.segsum_by_id_plain(*ext),))
        if timings is None or p:
            continue
        n_relin_cfg = int((ref_r[3] == 0).sum())
        for name in HALO_KERNELS:
            args, kw = calls[name]
            kern, plain = getattr(M, name), getattr(M, name + "_plain")
            outs = sync(kern(*args, **kw))
            flops = (RELIN_TEST_FLOPS * hcm.mp + RELIN_ROW_FLOPS * n_relin_cfg
                     if name.startswith("relin") else MESSAGES_ROW_FLOPS * hcm.mp)
            ms = time_ms(lambda: kern(*args, **kw), 20)
            plain_ms = time_ms(lambda: plain(*args, **kw), 3)
            b_ms, b_by = bound_ms(args, outs, flops)
            timings[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                 library_ms=None)
            print(f"[halo kernels] {tag} {name} (partition 0, huber 1.0): kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), no single library "
                  f"call")
            if name.startswith("messages"):
                report_window_kernel(f"{tag} partition 0, huber 1.0", name, args, kw)


def halo_run(tag, graph, means, k, n_parts, card, are_single=None, ell_fused=None, timed=True):
    """Phase 23 for one BA scene: `halo_cm.distribute` on the card, 50 sweeps
    through the partition's kernels (launch counts P per sweep, plain calls
    0), ARE finite and below the initial one (and within 5e-3 px of the
    one-device run when given), a bitwise rerun, sweeps/s, peak memory and
    the collective volume.  Returns the launch counts."""
    t0 = time.perf_counter()
    hp, hcm, init, run = halo_cm.distribute(graph, means, n_parts, ell_fused=ell_fused)
    tmpl = sweep.init_state(graph, means)
    are_of = lambda st: float(ba.avg_reprojection_error(
        graph, ba.with_means(tmpl, halo.collect_means(hp, st)), k=k))
    are0 = are_of(init)
    torch.cuda.synchronize()
    print(f"[halo] {tag}: {n_parts} partitions of {hcm.mp} rows (deg {hcm.deg}), gather mode "
          f"{hcm.gather_mode}, win_w {hcm.win_w}, ell_fused {hcm.ell_fused}, owned cameras "
          f"{hcm.comm[hcm.vb_g].n_own_max} and ghost cameras {hcm.comm[hcm.vb_g].n_ghost_max} "
          f"per partition, cut cameras {hcm.n_cut or 'none'}; distributed in "
          f"{time.perf_counter() - t0:.1f} s; initial ARE {are0:.6f} px; collective bytes "
          f"{halo.collective_bytes(hp)}")
    M.COUNTS.reset()
    state = sync(run(hcm, init, CFG, QUALITY_SWEEPS))
    launches = check_counts(f"the {tag} halo path",
                            dict.fromkeys(halo_mode_kernels(hcm), n_parts), QUALITY_SWEEPS)
    are = are_of(state)
    print(f"[halo] {tag}: {QUALITY_SWEEPS} sweeps, launches "
          f"{ {k: v for k, v in launches.items() if v} }; plain calls 0; ARE {are:.6f} px"
          + ("" if are_single is None else f" (one device {are_single:.6f} px, difference "
             f"{abs(are - are_single):.3e})"))
    if not (math.isfinite(are) and are < are0):
        raise AssertionError(f"{tag}: ARE {are} is not finite and below the initial {are0}")
    if are_single is not None and not abs(are - are_single) <= 5e-3:
        raise AssertionError(f"{tag}: ARE {are} vs one device's {are_single}")
    same_means(f"halo {tag}", state, sync(run(hcm, init, CFG, QUALITY_SWEEPS)))
    if timed:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sync(run(hcm, init, CFG, QUALITY_SWEEPS))
        dt = time.perf_counter() - t0
        print(f"[halo] {tag}: timed {QUALITY_SWEEPS} sweeps {dt:.4f} s -> "
              f"{QUALITY_SWEEPS / dt:.2f} sweeps/s ({card}); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return launches


def halo_path(card, are_city):
    """Phase 23: the owner-sharded halo paths through the entry points a
    user calls, the P partitions in one process on the card."""
    out = {}
    sim = ba.simulate_blocks(**CITY)
    graph, means = ba.build(sim, dtype=torch.float32, **HALO_BUILD)
    out["fused"] = halo_run("city1280 P=2", graph, means, sim["k"], 2, card, are_city)
    out["unfused"] = halo_run("city1280 P=2 unfused", graph, means, sim["k"], 2, card,
                              are_city, ell_fused=False)
    halo_run("city1280 P=4", graph, means, sim["k"], 4, card, timed=False)
    del graph, means
    torch.cuda.empty_cache()
    sim = ba.simulate_blocks(**VENICE)
    graph, means = ba.build(sim, dtype=torch.float32, **HALO_BUILD)
    halo_run("venice10240 P=4", graph, means, sim["k"], 4, card)
    del graph, means
    torch.cuda.empty_cache()

    # python -m gbp_tpu_torch.slam --n_poses 4000 --n_iters 100 --n_chips 2
    M.COUNTS.reset()
    res = slam_cli.main(["--n_poses", "4000", "--n_iters", "100", "--n_chips", "2"])
    hcm = res["hcm"]
    launches = check_counts("slam --n_chips 2", dict.fromkeys(halo_mode_kernels(hcm), 2), 100)
    ate0, ate = res["ate0"], res["ate"][-1][1]
    print(f"[halo] slam manhattan4000 --n_chips 2: gather mode {hcm.gather_mode} (slot "
          f"{1 - hcm.e} gathered), launches { {k: v for k, v in launches.items() if v} }, "
          f"plain calls 0; ATE {ate0:.6f} -> {ate:.6f}; {res['sweeps_per_s']:.2f} sweeps/s "
          f"({card})")
    if not (math.isfinite(ate) and ate <= ate0):
        raise AssertionError(f"slam --n_chips 2: ATE {ate} not finite and at or below {ate0}")

    # python -m gbp_tpu_torch.ba --bal_file data/ladybug49_sim.txt.gz --n_iters 100
    #   --n_chips 2 --oracle, against the same command on one device.
    argv = ["--bal_file", str(LADYBUG), "--n_iters", "100", "--oracle"]
    one = ba_cli.main(argv)
    M.COUNTS.reset()
    two = ba_cli.main([*argv, "--n_chips", "2"])
    hcm = two["hcm"]
    launches = check_counts("ba --n_chips 2", dict.fromkeys(halo_mode_kernels(hcm), 2), 100)
    a1, a2 = one["are"][-1][1], two["are"][-1][1]
    print(f"[halo] ladybug49 --n_chips 2: path {two['path']} ({hcm.gather_mode}, ell_fused "
          f"{hcm.ell_fused}), launches { {k: v for k, v in launches.items() if v} }; ARE per 10 "
          f"sweeps " + ", ".join(f"{i}: {a:.4f}" for i, a in two["are"])
          + f"; final {a2:.6f} px against {a1:.6f} on one device (difference "
          f"{abs(a2 - a1):.3e}); dense MAP {two['are_map']:.6f} / {one['are_map']:.6f} px; "
          f"{two['sweeps_per_s']:.2f} sweeps/s ({card})")
    if not abs(a2 - a1) <= 1e-3:
        raise AssertionError(f"ladybug49 --n_chips 2: ARE {a2} vs one device's {a1}")
    return out


# --- the schedules (phase 25) ---------------------------------------------------------


def keyed(compare):
    """`check_kernels`' compare, filing a masked check's error under its
    kernel's name."""
    return lambda label, got, ref: compare(label, got, ref, key=label.split("[")[0])


def relin_kept(fs):
    """What a relinearization's outputs (lp, jac, r0, srel) are at a row it
    leaves inactive: its inputs, since_relin counted up by one."""
    return [(fs.lp, 0), (fs.jac, 0), (fs.r0, 0), (fs.srel, 1)]


def messages_kept(fs):
    """What the four new messages are at an inactive row: the old ones."""
    return [(a, 0) for a in (fs.msg_eta[0], fs.msg_lam[0], fs.msg_eta[1], fs.msg_lam[1])]


def schedule_acts(x, act, seed=0):
    """Phase 25 (a): two partial act operands from the operands' own
    adjacent means x [tdof, rows] and the validity mask `act` (rows
    elements, any shape): act x the priority mask of frac 0.25 (the top
    quarter of the valid rows by ||x - last_x||, last_x = x perturbed,
    `parallel.schedules._priority_mask`) and act x a Bernoulli(0.5) draw,
    both from a seeded generator on the card."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    last = x + 1e-3 * (1 + x.abs()) * torch.randn(x.shape, generator=gen, device=x.device,
                                                  dtype=x.dtype)
    valid = act.reshape(-1) > 0.5
    score = halo_schedules._scores_cm(x[None], last[None])[0]
    prio = halo_schedules._priority_mask(score, valid, max(1, int(0.25 * int(valid.sum()))))
    bern = torch.rand(valid.shape, generator=gen, device=x.device) < 0.5
    return {label: act * m.reshape(act.shape).to(act.dtype)
            for label, m in (("priority", prio), ("Bernoulli", bern))}


def hold_masked(tag, name, kern, plain, args, kw, act, acts, kept, compare, rows=False):
    """Phase 25 (a): kernel `name` against its plain version with its act
    operand (the tensor `act` in `args`) replaced by each mask of `acts`.
    `compare(label, got, ref)` holds the outputs to the tolerance; at every
    row a mask turns off, output i must equal its input kept[i] = (input,
    step) bit for bit, plus `step` (1: since_relin).  Component-major
    operands hold rows along the last axis, row-major ones (`rows`) along
    the first.  Returns {mask label: the kernel's outputs}."""
    at = next(i for i, a in enumerate(args) if a is act)
    valid = act.reshape(-1) > 0.5
    n_valid = int(valid.sum())
    outs = {}
    for label, mask in acts.items():
        m_args = (*args[:at], mask, *args[at + 1:])
        got = sync(kern(*m_args, **kw))
        compare(f"{name}[{label} mask]", got, sync(plain(*m_args, **kw)))
        off = mask.reshape(-1) <= 0.5
        n_on = n_valid - int((off & valid).sum())
        if not 0 < n_on < n_valid:
            raise AssertionError(f"{name} {tag}: the {label} mask is not partial ({n_on} of "
                                 f"{n_valid} valid rows on)")
        sel = (lambda t: t.reshape(t.shape[0], -1)[off]) if rows else (lambda t: t[..., off])
        for i, (inp, step) in enumerate(kept):
            want = sel(inp).to(got[i].dtype)
            if not torch.equal(sel(got[i]), want + step if step else want):
                raise AssertionError(f"{name} {tag}, {label} mask: output {i} of an inactive "
                                     f"row is not its input" + (" + 1" if step else ""))
        print(f"[masked] {tag} {name}, {label} mask: {n_on} of {n_valid} valid rows active, "
              f"every inactive row returned its {len(kept)} inputs bit for bit"
              + (" (since_relin + 1)" if any(step for _, step in kept) else ""))
        outs[label] = got
    return outs


def launches_and_device_ms(run, n1=3, n2=8):
    """(kernel launches per sweep, device ms per sweep) of `run(n)` (n
    sweeps), by the profiler: runs of n2 and n1 sweeps differenced, so a
    run's one-time set-up cancels."""
    run(n1)
    torch.cuda.synchronize()
    got = []
    for n in (n1, n2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(n)
            torch.cuda.synchronize()
        events = prof.events()
        got.append((sum(1 for e in events if e.name in serving.LAUNCH_CALLS),
                    sum(e.time_range.elapsed_us() for e in events
                        if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3))
    return tuple((b - a) / (n2 - n1) for a, b in zip(*got))


def sync_warnings(fn):
    """How many synchronizing CUDA calls `fn` makes, as
    `torch.cuda.set_sync_debug_mode("warn")` reports them."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum(1 for w in caught if "synchroniz" in str(w.message))


def timed(fn):
    """(fn()'s result, wall seconds), the card synchronized on both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sync(fn())
    return out, time.perf_counter() - t0


def bits(t):
    """A tensor's bits as integers (NaN equals the same NaN)."""
    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def same_state(what, a, b):
    """Every tensor of two states equal bit for bit."""
    la, lb = leaves(a), leaves(b)
    if len(la) != len(lb) or not all(torch.equal(bits(x), bits(y)) for x, y in zip(la, lb)):
        raise AssertionError(f"{what}: the two states differ")


def leaves(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    return [t for o in obj for t in leaves(o)] if isinstance(obj, tuple) else []


def stepper(kind, arg, masks, sweep_fn, valid, gen=None):
    """One schedule sweep at a time, for the 5-sweep ARE chunks: returns
    one(state) -> (state, active valid rows on the card).  `masks` is the
    engine's (init, wildfire mask, priority mask, random mask) and
    `sweep_fn(state, active)` its masked sweep; the fire points are recorded
    as the runners record them."""
    init, wildfire, priority, random = masks
    box = {}

    def one(st):
        if kind == "random":
            active = random(gen, arg)
        else:
            if "sched" not in box:
                box["sched"] = init(st)
            active, xs = (wildfire if kind == "wildfire" else priority)(st, box["sched"], arg)
            box["sched"] = box["sched"]._replace(last_x=record(active, xs, box["sched"].last_x))
        per_block = active if isinstance(active, tuple) else (active,)
        n_on = sum((a.reshape(-1) & v).sum() for a, v in zip(per_block, valid))
        return sweep_fn(st, active), n_on

    return one


def record(active, xs, last):
    """last_x <- the current means where a row fired (both engines)."""
    if isinstance(last, tuple):
        return schedules._record(active, xs, last)
    return torch.where(active, xs, last)


def chunked(tag, one, state, n, are_of, are0, are_map, n_valid, gate_sweeps=None):
    """n sweeps of `one` in 5-sweep chunks, the ARE after each, which must
    be finite and below the initial ARE after the last chunk (after the
    first `gate_sweeps` sweeps when given: a schedule that diverges on the
    scene in the reference too).  Returns (state, the final ARE, the first
    sweep at or below 1.05x the MAP ARE or None, the mean active share of
    the valid rows, the ARE per chunk)."""
    first, n_on, ares = None, 0, []
    for i in range(0, n, 5):
        for _ in range(5):
            state, on = one(state)
            n_on = n_on + on
        ares.append(are_of(state))
        if first is None and ares[-1] <= 1.05 * are_map:
            first = i + 5
    gated = ares[-1] if gate_sweeps is None else ares[gate_sweeps // 5 - 1]
    if not (math.isfinite(gated) and gated < are0):
        raise AssertionError(f"{tag}: ARE {gated} is not finite and below the initial {are0}")
    return state, ares[-1], first, float(n_on) / n / n_valid, ares


def against_sync(run, sync_run, n, reps=3):
    """`run(k)` (k sweeps of a schedule) beside `sync_run(k)` (the
    synchronous sweeps of the same scene): kernel launches and device ms per
    sweep (`launches_and_device_ms`) and the median sweeps/s of n-sweep runs
    timed alternately, `reps` times each (the host's load drifts)."""
    out = dict(zip(("launches_per_sweep", "device_ms"), launches_and_device_ms(run)))
    out.update(zip(("sync_launches_per_sweep", "sync_device_ms"),
                   launches_and_device_ms(sync_run)))
    sps, sync_sps = [], []
    for _ in range(reps):
        sync_sps.append(n / timed(lambda: sync_run(n))[1])
        sps.append(n / timed(lambda: run(n))[1])
    out.update(sweeps_per_s=sorted(sps)[reps // 2], sync_sweeps_per_s=sorted(sync_sps)[reps // 2])
    return out


def schedule_line(tag, r, card):
    """One run's line: ARE and its chunks, the 1.05x MAP sweep, active
    share, then `against_sync`'s figures."""
    if "first_reach" in r:
        reach = ("not reached" if r["first_reach"] is None
                 else f"reached at sweep {r['first_reach']}")
        print(f"[schedules] {tag}: ARE {r['are']:.6f} px, 1.05x MAP {reach}; active share "
              f"{r['active_share']:.4f}; ARE per 5 sweeps "
              + ", ".join(f"{a:.4f}" for a in r["are_per_5"]))
    print(f"[schedules] {tag}: {r['launches_per_sweep']:.1f} launches per sweep (synchronous "
          f"{r['sync_launches_per_sweep']:.1f}); device {r['device_ms']:.4f} ms per sweep "
          f"(synchronous {r['sync_device_ms']:.4f}); {r['sweeps_per_s']:.2f} sweeps/s "
          f"(synchronous {r['sync_sweeps_per_s']:.2f}; medians of 3 alternate timed runs of "
          f"{QUALITY_SWEEPS} sweeps) ({card})")


def hold_sync_warnings(tag, run, sync_warn):
    """Two sweeps of `run` make no more host synchronizations than two
    synchronous sweeps (`sync_warn`)."""
    warn = sync_warnings(lambda: run(2))
    print(f"[schedules] {tag}: host synchronizations in 2 sweeps {warn}, synchronous sweeps "
          f"{sync_warn}")
    if warn > sync_warn:
        raise AssertionError(f"{tag}: the schedule adds host synchronizations")


def sync_chunks(tag, sweep_fn, init, n, are_of, are0, are_map, report):
    """The synchronous sweeps' ARE per 5 sweeps, the schedules' yardstick."""
    n_on = torch.zeros((), device=init.v[0].mean.device)
    _, are, first, _, ares = chunked(f"{tag} synchronous", lambda st: (sweep_fn(st), n_on),
                                     init, n, are_of, are0, are_map, 1)
    reach = "not reached" if first is None else f"reached at sweep {first}"
    print(f"[schedules] {tag} synchronous, {n} sweeps: ARE {are:.6f} px, 1.05x MAP {reach}; "
          f"ARE per 5 sweeps " + ", ".join(f"{a:.4f}" for a in ares))
    report[f"{tag} synchronous"] = dict(are=are, are_per_5=ares, first_reach=first)


def cm_masks(cmg):
    return (lambda st: schedules.init_schedule_cm(cmg, st),
            lambda st, sc, tau: schedules.wildfire_mask_cm(cmg, st, sc, tau),
            lambda st, sc, frac: schedules.priority_mask_cm(cmg, st, sc, frac),
            lambda gen, keep: schedules.random_mask_cm(cmg, gen, keep))


def cm_schedules(tag, sim, graph, means, cmg, kinds, n, card, are_map, report):
    """Phase 25 (b) on one CM scene: each (kind, arg, gate_sweeps) of
    `kinds` stepped in 5-sweep chunks and through its runner (equal bit for
    bit, launch counts), beside the synchronous sweeps (`against_sync`),
    and its host synchronizations beside theirs.  Returns {kind: final
    state}."""
    init = sweep_cm.init_state(cmg, means)
    are_of = lambda st: are_px(graph, cmg, st, sim["k"])
    are0 = are_of(init)
    names = (*(FULL if not cmg.win_w else WINDOWED), *BELIEFS)
    n_valid = graph.fblocks[0].n_valid
    valid = (cmg.act[0] > 0.5,)
    sync_run = lambda k: sweep_cm.run(cmg, init, CFG, k)
    sync_warn = sync_warnings(lambda: sync_run(2))
    sync_chunks(tag, lambda st: sweep_cm.sweep(cmg, st, CFG), init, n, are_of, are0, are_map,
                report)
    runners = {"wildfire": schedules.run_wildfire_cm, "priority": schedules.run_priority_cm,
               "random": schedules.run_random_cm}
    out = {}
    for kind, arg, gate_sweeps in kinds:
        gen = lambda: torch.Generator(device=cmg.act.device).manual_seed(0)
        run = lambda k: runners[kind](cmg, init, CFG, k, arg, *((gen(),) if kind == "random"
                                                              else ()))
        one = stepper(kind, arg, cm_masks(cmg),
                      lambda st, act: sweep_cm.sweep(cmg, st, CFG, active=act), valid, gen())
        stepped, are, first, share, ares = chunked(f"{tag} {kind}", one, init, n, are_of, are0,
                                                   are_map, n_valid, gate_sweeps)
        M.COUNTS.reset()
        state = sync(run(n))
        check_counts(f"{tag} {kind}", names, n)
        same_state(f"{tag} {kind}: the runner and the stepped sweeps", state, stepped)
        if kind == "random":
            same_state(f"{tag} random: a rerun from the same seed", state, sync(run(n)))
        if gate_sweeps:
            print(f"[schedules] {tag} {kind}({arg}): held at sweep {gate_sweeps}, ARE "
                  f"{ares[gate_sweeps // 5 - 1]:.6f} px (initial {are0:.6f}): the reference's "
                  f"schedule diverges on merged blocks too (tests/test_torch_schedules.py)")
        hold_sync_warnings(f"{tag} {kind}", run, sync_warn)
        r = dict(are=are, are_per_5=ares, first_reach=first, active_share=share,
                 **against_sync(run, sync_run, QUALITY_SWEEPS))
        schedule_line(f"{tag} {kind}({arg}), {n} sweeps", r, card)
        report[f"{tag} {kind}"] = r
        out[kind] = state
    return out


def schedules_path(card):
    """Phase 25 (b): the schedule runners at full width, float32, on the card."""
    t_phase = time.perf_counter()
    report = {}
    # bench64, the main path: kernels 1, 2, 3 under the schedules' masks.
    sim = ba.simulate(**BENCH)
    graph, means = ba.build(sim, dtype=torch.float32)
    cmg = sweep_cm.prepare(graph, segsum_exact=True)
    init = sweep_cm.init_state(cmg, means)
    are_map = map_are(graph, sweep_cm.to_gbp_state(cmg, init), means, sim["k"])
    M.COUNTS.reset()
    below = sync(schedules.run_wildfire_cm(cmg, init, CFG, SWEEPS, -1.0))
    check_counts("bench64 wildfire tau < 0", (*FULL, *BELIEFS), SWEEPS)
    same_state(f"bench64: wildfire with tau < 0 and the synchronous run, {SWEEPS} sweeps",
               below, sync(sweep_cm.run(cmg, init, CFG, SWEEPS)))
    print(f"[schedules] bench64: run_wildfire_cm(tau=-1) equals sweep_cm.run bit for bit after "
          f"{SWEEPS} sweeps; MAP ARE {are_map:.6f} px")
    cm_schedules("bench64", sim, graph, means, cmg,
                 (("wildfire", 1e-4, None), ("priority", 0.5, None), ("random", 0.7, None)),
                 SWEEPS, card, are_map, report)
    del graph, means, cmg, init, below

    # bench64 on the generic engine: kernels 19, 20.
    cfg = dataclasses.replace(CFG, message_form="pallas")
    graph, means = ba.build(sim, dtype=torch.float32, layout="ell")
    fb = graph.fblocks[0]
    init = sweep.init_state(graph, means)
    are_of = lambda st: float(ba.avg_reprojection_error(graph, st, k=sim["k"]))
    are0 = are_of(init)
    per_sweep = {"fused_relin_messages": 1, "fused_messages": 1, "segsum_by_id": 1}
    sync_run = lambda k: sweep.run(graph, init, cfg, k)
    sync_warn = sync_warnings(lambda: sync_run(2))
    sync_chunks("bench64 generic", lambda st: sweep.sweep(graph, st, cfg), init, QUALITY_SWEEPS,
                are_of, are0, are_map, report)
    masks = (lambda st: schedules.init_schedule(graph, st),
             lambda st, sc, tau: (schedules.wildfire_masks(graph, st, sc, tau),
                                  schedules._means(graph, st)),
             lambda st, sc, frac: (schedules.priority_masks(graph, st, sc, frac),
                                   schedules._means(graph, st)), None)
    for kind, arg, runner in (("wildfire", 1e-4, schedules.run_wildfire),
                              ("priority", 0.5, schedules.run_priority)):
        run = lambda k: runner(graph, init, cfg, k, arg)
        one = stepper(kind, arg, masks, lambda st, act: sweep.sweep(graph, st, cfg, active=act),
                      (fb.valid,))
        stepped, are, first, share, ares = chunked(f"bench64 generic {kind}", one, init,
                                                   QUALITY_SWEEPS, are_of, are0, are_map,
                                                   fb.n_valid)
        M.COUNTS.reset()
        state = sync(run(QUALITY_SWEEPS))
        check_counts(f"bench64 generic {kind}", per_sweep, QUALITY_SWEEPS)
        same_state(f"bench64 generic {kind}: the runner and the stepped sweeps", state, stepped)
        hold_sync_warnings(f"bench64 generic {kind}", run, sync_warn)
        r = dict(are=are, are_per_5=ares, first_reach=first, active_share=share,
                 **against_sync(run, sync_run, QUALITY_SWEEPS))
        schedule_line(f"bench64 generic {kind}({arg}), {QUALITY_SWEEPS} sweeps", r, card)
        report[f"bench64 generic {kind}"] = r
    del graph, means, init
    torch.cuda.empty_cache()
    print(f"[schedules] bench64 done at {time.perf_counter() - T_START:.1f} s")

    # city, windows: kernels 10, 11, 15, 16.
    sim = ba.simulate_blocks(**CITY)
    graph, means = ba.build(sim, dtype=torch.float32, **BIG)
    cmg = sweep_cm.prepare(graph, segsum_exact=True, window=True)
    are_map = map_are(graph, sweep_cm.to_gbp_state(cmg, sweep_cm.init_state(cmg, means)), means,
                      sim["k"])
    # Priority at frac 0.5 diverges on merged blocks after its first chunk,
    # in the reference as here: it is held at sweep 5.
    one_device = cm_schedules("city", sim, graph, means, cmg,
                              (("wildfire", 1e-4, None), ("priority", 0.5, 5)), QUALITY_SWEEPS,
                              card, are_map, report)
    are_wf = are_px(graph, cmg, one_device["wildfire"], sim["k"])
    del graph, means, cmg, one_device
    torch.cuda.empty_cache()

    # city cut in two (halo_cm.distribute): kernels 17, 18, 16, 15, 3.
    graph, means = ba.build(sim, dtype=torch.float32, **HALO_BUILD)
    hp, hcm, init, run_sync = halo_cm.distribute(graph, means, 2)
    tmpl = sweep.init_state(graph, means)
    are_of = lambda st: float(ba.avg_reprojection_error(
        graph, ba.with_means(tmpl, halo.collect_means(hp, st)), k=sim["k"]))
    are0 = are_of(init)
    names = dict.fromkeys(halo_mode_kernels(hcm), 2)
    n = QUALITY_SWEEPS
    sync_run = lambda k: run_sync(hcm, init, CFG, k)
    sync_warn = sync_warnings(lambda: sync_run(2))
    runs = {"wildfire": (halo_schedules.make_run_wildfire_cm(hcm), (1e-4,)),
            "priority": (halo_schedules.make_run_priority_cm(hcm, 0.5), ()),
            "chip dropout": (halo_schedules.make_run_chip_dropout_cm(hcm), (1, 15))}
    for kind, (runner, extra) in runs.items():
        run = lambda k: runner(hcm, init, CFG, k, *extra)
        M.COUNTS.reset()
        state = sync(run(n))
        check_counts(f"city P=2 {kind}", names, n)
        are = gated = are_of(state)
        note = ""
        if kind == "priority":  # diverges on merged blocks, as on one device
            gated = are_of(sync(run(5)))
            note = f"; held at sweep 5: ARE {gated:.6f} px"
        if not (math.isfinite(gated) and gated < are0):
            raise AssertionError(f"city P=2 {kind}: ARE {gated} not finite and below {are0}")
        if kind == "wildfire":
            note = f"; one device {are_wf:.6f} px, difference {abs(are - are_wf):.3e}"
            if not abs(are - are_wf) <= 5e-3:
                raise AssertionError(f"city P=2 wildfire: ARE {are} vs one device's {are_wf}")
        if kind == "chip dropout":
            # Partition 1 is dead for sweeps 1-15: its factor state stays,
            # since_relin counts 15; the run then continues to 50 sweeps.
            st15 = sync(run(15))
            f0, f1 = init.f, st15.f
            for name in ("lp", "jac", "r0", "msg_eta", "msg_lam"):
                if not all(torch.equal(a[1], b[1]) for a, b in zip(
                        leaves(getattr(f1, name)), leaves(getattr(f0, name)))):
                    raise AssertionError(f"city P=2 dropout: partition 1's {name} changed")
            if not torch.equal(f1.srel[1], f0.srel[1] + 15):
                raise AssertionError("city P=2 dropout: since_relin did not count the sweeps")
            same_state("city P=2 dropout: 15 + 35 sweeps and one run of 50", state,
                       sync(runner(hcm, st15, CFG, n - 15, 1, 0)))
            note = "; partition 1's factor state after sweep 15 equals its initial one but srel"
        print(f"[schedules] city P=2 {kind}{extra}, {n} sweeps: ARE {are:.6f} px (initial "
              f"{are0:.6f}){note}")
        hold_sync_warnings(f"city P=2 {kind}", run, sync_warn)
        r = dict(are=are, **against_sync(run, sync_run, n))
        schedule_line(f"city P=2 {kind}{extra}, {n} sweeps", r, card)
        report[f"city P=2 {kind}"] = r
    del graph, means, hp, hcm, init
    torch.cuda.empty_cache()
    print(f"[schedules] phase 25 (b) took {time.perf_counter() - t_phase:.1f} s: "
          + json.dumps(report))


# --- streaming (phase 26) -------------------------------------------------------------------

STREAM_LAG, STREAM_EVICT, STREAM_SWEEPS = 16, 4, 10
STREAM_CHECK_FRAMES = 24  # two evictions at lag 16
# The reference's stream of the serving configuration (120 absolute frames)
# on a CPU, JAX in float32: tests/test_torch_serving.py::
# test_reference_serving_stream_tail prints these.
REFERENCE_SERVING_CPU = dict(median=1.3684, last10=3.6451, max=39.4826, argmax=104,
                             final=1.9356)


def stream_frames(cfg, dtype, capture, n_frames, wrap=None, on_frame=None):
    """The serving stream's first n_frames frames on the card (absolute
    arrivals, lag 16, 4 evicted at a time, 10 sweeps a frame, capacities
    16 / 2048 / 8192): (final state, the frame step)."""
    sim, frames, chunk = serving.scene(120, 40, "absolute")
    step = serving._make_step(cfg, STREAM_SWEEPS, STREAM_EVICT, capture)
    ob, _ = serving._stream(serving.fresh(sim, chunk, STREAM_LAG, dtype, "cuda"),
                            frames[:n_frames], sim["lmk_init"], chunk, STREAM_LAG,
                            STREAM_EVICT, wrap(step) if wrap else step, on_frame)
    return ob, step


def check_online_kernels(dtype, timings):
    """Phase 26 (a): kernels 3 and 20 on the online graph's own operands
    (capacity-padded, partly valid, after two evictions), held against their
    plain versions; in float32 timed beside their bounds."""
    tol = TOL[dtype]
    cfg = dataclasses.replace(serving.CFG, message_form="pallas")
    ob, _ = stream_frames(cfg, dtype, False, STREAM_CHECK_FRAMES)
    with recording("segsum_by_id") as sums, recording("fused_relin_messages") as rels:
        sync(sweep.sweep(ob.graph, ob.state, cfg))
    with recording("segsum_by_id", online) as absorbed:
        sync(online.evict_frames(ob, STREAM_EVICT))
    fb = ob.graph.fblocks[0]
    n_valid = int(fb.valid.sum())
    key = f"online {str(dtype)[6:]} ({fb.count} rows, {n_valid} valid)"
    worst = {}
    for tag, (args, kw) in (("cameras", sums[0]), ("landmarks", sums[1]),
                            ("evicted", absorbed[0])):
        got = sync(M.segsum_by_id(*args, **kw))
        rel, err = rel_err(got, M.segsum_by_id_plain(*args, **kw))
        if not rel <= tol:
            raise AssertionError(f"segsum_by_id {key} {tag}: rel err {rel:.3e} > {tol:g}")
        if not torch.equal(got, sync(M.segsum_by_id(*args, **kw))):
            raise AssertionError(f"segsum_by_id {key} {tag}: two launches differ")
        worst["segsum_by_id"] = max(worst.get("segsum_by_id", 0.0), rel)
        print(f"[streaming] {key} segsum_by_id {tag} ({int(args[3][-1])} listed rows of "
              f"{args[0].shape[0]}, {args[3].shape[0] - 1} segments): rel err {rel:.3e} "
              f"(max abs {err:.3e}), repeats bit for bit")
    args, kw = rels[0]
    on = args[9] > 0.5
    beta_mid = float((args[1] - args[4]).norm(dim=1)[on].double().median())
    for beta in (args[0][4], beta_mid):
        b_args = ((*args[0][:4], beta, *args[0][5:]), *args[1:])
        got = sync(M.fused_relin_messages(*b_args, **kw))
        ref = M.fused_relin_messages_plain(*b_args, **kw)
        rel = max(rel_err(a, b)[0] for a, b in zip(got, ref))
        if not rel <= tol:
            raise AssertionError(f"fused_relin_messages {key} beta {beta:g}: rel err "
                                 f"{rel:.3e} > {tol:g}")
        inert = ~on
        for out, inp in zip(got[:4], args[14:18]):
            if not torch.equal(out[inert], inp[inert]):
                raise AssertionError(f"fused_relin_messages {key}: an inert row changed")
        worst["fused_relin_messages"] = max(worst.get("fused_relin_messages", 0.0), rel)
        print(f"[streaming] {key} fused_relin_messages at beta {beta:.3g}: "
              f"{int((got[7][on] == 0).sum())} of {int(on.sum())} valid rows relinearize, rel "
              f"err {rel:.3e}; inert rows kept bit for bit")
    if dtype != torch.float32:
        return worst
    seg_args, seg_kw = sums[1]
    seg_out = M.segsum_by_id(*seg_args, **seg_kw)
    me, ml, rows, offs = seg_args
    n_listed = int(offs[-1])
    f = seg_out.shape[1]
    seg_bytes = (n_listed * f + seg_out.numel()) * me.element_size() + (rows.numel() +
                                                                         offs.numel()) * 4
    new = M.fused_relin_messages(*args, **kw)
    for name, fn, b in (
            ("segsum_by_id", lambda: M.segsum_by_id(*seg_args, **seg_kw),
             bound_ms(seg_args, (seg_out,), f * n_listed, seg_bytes)),
            ("fused_relin_messages", lambda: M.fused_relin_messages(*args, **kw),
             bound_ms(args[1:], new, RELIN_TEST_FLOPS * fb.count
                      + (RELIN_ROW_FLOPS + MESSAGES_ROW_FLOPS) * n_valid))):
        dev_ms = device_ms(fn)
        timings[name] = dict(ms=time_ms(fn, 20), device_ms=dev_ms, bound_ms=b[0],
                             bound_by=b[1])
        print(f"[streaming] {key} {name}: {timings[name]['ms']:.4f} ms per call (events), "
              f"device {dev_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}), share "
              f"{b[0] / dev_ms:.3f} ({card_line()})")
    return worst


def streaming_path(card):
    """Phase 26: the online model and the serving loop on the card."""
    t_phase = time.perf_counter()
    timings = {}
    for dtype in (torch.float64, torch.float32):
        check_online_kernels(dtype, timings)

    # (b) captured against eager, both message forms, bit for bit; two
    # captured runs equal; the launches the captures made.
    for form in ("covariance", "pallas"):
        cfg = dataclasses.replace(serving.CFG, message_form=form)
        runs = []
        for capture in (True, False, True):
            M.COUNTS.reset()
            ob, step = stream_frames(cfg, torch.float32, capture, STREAM_CHECK_FRAMES)
            runs.append((ob, dict(M.COUNTS.kernel), dict(M.COUNTS.plain), len(step.graphs)))
        (cap, launches, plain, n_graphs), (eager, _, _, _), (cap2, _, _, _) = runs
        same_state(f"streaming {form}: captured and eager", online.tensors(cap),
                   online.tensors(eager))
        same_state(f"streaming {form}: two captured runs", online.tensors(cap),
                   online.tensors(cap2))
        # Each variant (plain without and with an eviction) ran once as a
        # warm-up and once under capture: 2 sums per sweep, 1 per eviction.
        want_sums = 2 * sum(2 * STREAM_SWEEPS + evict for evict in (0, 1))
        path = {"segsum_by_id": want_sums}
        if form == "pallas":
            path.update(fused_relin_messages=2 * 2 * STREAM_SWEEPS,
                        fused_messages=2 * 2 * STREAM_SWEEPS)
        want = {k: path.get(k, 0) for k in M.KERNELS}
        if n_graphs != 2 or launches != want or any(plain.values()):
            raise AssertionError(f"streaming {form}: {n_graphs} graphs, launches {launches} "
                                 f"(expected {want}), plain calls {plain}")
        print(f"[streaming] {form}: {STREAM_CHECK_FRAMES} frames (2 evictions), captured = "
              f"eager bit for bit, two captured runs equal; {n_graphs} graphs; launches at "
              f"warm-up and capture {path}")

    # (c) a steady frame's step (staging and replay) under
    # set_sync_debug_mode("error"): no host sync but the serving point's.
    strict = []

    def wrap(step):
        def call(ob, *args, **kw):
            strict.append(len(strict) >= STREAM_CHECK_FRAMES - 4)
            if not strict[-1]:
                return step(ob, *args, **kw)
            torch.cuda.set_sync_debug_mode("error")
            try:
                return step(ob, *args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return call

    stream_frames(serving.CFG, torch.float32, True, STREAM_CHECK_FRAMES, wrap)
    print(f"[streaming] frames {STREAM_CHECK_FRAMES - 3}-{STREAM_CHECK_FRAMES}: staging and "
          f"replay under set_sync_debug_mode(\"error\"): no host synchronization "
          f"({sum(strict)} frames)")

    # (d) the serving configuration at full width.
    # The serving configuration (the reference's covariance form), and its
    # absolute stream again under message_form "pallas" (kernels 19, 20).
    results = {}
    pallas = dataclasses.replace(serving.CFG, message_form="pallas")
    for name, frames, arrivals, cfg, path in (
            ("absolute", 120, "absolute", serving.CFG, ("segsum_by_id",)),
            ("odometry", 240, "odometry", serving.CFG, ("segsum_by_id",)),
            ("absolute pallas", 120, "absolute", pallas,
             ("segsum_by_id", "fused_relin_messages", "fused_messages"))):
        M.COUNTS.reset()
        out = serving.serve(frames, 40, STREAM_LAG, STREAM_EVICT, STREAM_SWEEPS, arrivals,
                            "cuda", cfg)
        launches = {k: v for k, v in M.COUNTS.kernel.items() if v}
        if set(launches) != set(path) or any(M.COUNTS.plain.values()):
            raise AssertionError(f"serving {name}: launches {launches} (expected {path}), "
                                 f"plain {dict(M.COUNTS.plain)}")
        if out["graphs_captured"] > serving.MAX_GRAPHS:
            raise AssertionError(f"serving {name}: {out['graphs_captured']} graphs")
        a = np.asarray(out["are_px"])
        if not np.isfinite(a).all():
            raise AssertionError(f"serving {name}: non-finite ARE")
        results[name] = out
        print(f"[streaming] {frames} frames {name}: {out['frames_per_s_steady']:.2f} "
              f"frames/s captured (p50 {out['frame_latency_ms_p50']:.4f} ms, p95 "
              f"{out['frame_latency_ms_p95']:.4f} ms), eager "
              f"{out['frames_per_s_steady_eager']:.2f} frames/s (p50 "
              f"{out['frame_latency_ms_p50_eager']:.4f} ms); per frame "
              f"{out['kernels_per_frame']:.1f} kernels, {out['launch_calls_per_frame']:.1f} "
              f"launch calls captured ({out['launch_calls_per_frame_eager']:.1f} eager), "
              f"device {out['device_ms_per_frame']:.4f} ms captured "
              f"({out['device_ms_per_frame_eager']:.4f} eager); ARE median "
              f"{out['are_px_median']:.4f} max {out['are_px_max']:.4f} final "
              f"{out['are_px_final']:.4f} px; {out['graphs_captured']} graphs; launches at "
              f"warm-up and capture {launches} ({card})")
    # The stationarity bounds of the reference's serving test: the median
    # below 2.5 px, the median of the last 10 frames below 1.25x the median +
    # 0.5.  The reference's own stream of this configuration misses the
    # second (REFERENCE_SERVING_CPU); where the card's does too, it is held
    # to the same margin over the reference's tail.
    a = np.asarray(results["absolute"]["are_px"])
    med, tail = float(np.median(a)), float(np.median(a[-10:]))
    ref = REFERENCE_SERVING_CPU
    if not med < 2.5:
        raise AssertionError(f"serving absolute: ARE median {med:.4f} px >= 2.5")
    if tail < 1.25 * med + 0.5:
        verdict = f"below the bound {1.25 * med + 0.5:.4f} px: stationary"
    elif tail < 1.25 * ref["last10"] + 0.5:
        verdict = (f"above the bound {1.25 * med + 0.5:.4f} px, as the reference's CPU run "
                   f"(last 10 {ref['last10']:.4f}, median {ref['median']:.4f}, max "
                   f"{ref['max']:.4f} at frame {ref['argmax']}); below "
                   f"{1.25 * ref['last10'] + 0.5:.4f} px, the same margin over the reference's")
    else:
        raise AssertionError(f"serving absolute: last 10 {tail:.4f} px, beyond the bound and "
                             f"the reference's tail {ref['last10']:.4f} px")
    print(f"[streaming] 120 frames absolute: ARE median {med:.4f} < 2.5 px; last 10 "
          f"{tail:.4f} px, max {a.max():.4f} at frame {int(a.argmax())}, {verdict}")
    print("[streaming] serving JSON: " + json.dumps(
        {k: {n: v for n, v in r.items() if n != "are_px"} for k, r in results.items()}))
    print(f"[streaming] phase 26 took {time.perf_counter() - t_phase:.1f} s")
    return timings

# --- the utilities (phase 27) -------------------------------------------------------------

# Phase 27 (a): sweeps before the checkpoint (past the first relinearization
# at min_linear_iters = 8) and after it.
RESUME_AT, RESUME_MORE = 9, 3


def as_is(st):
    return st


def resume(tag, ck, run, graph, mid, template, path, cfg=CFG, to_saved=as_is, from_saved=as_is,
           compared=as_is):
    """Phase 27 (a) for one engine: the state `mid` after RESUME_AT sweeps
    goes through a checkpoint (saved as `to_saved(mid)`, restored into
    `template`, turned back by `from_saved`), and RESUME_MORE sweeps from it
    through the engine's kernels (`path`: launches per sweep) equal
    RESUME_MORE sweeps from `mid` itself, bit for bit (as `compared`)."""
    checkpoint.save(ck, to_saved(mid), extras={"sweep": RESUME_AT})
    want = sync(run(graph, mid, cfg, RESUME_MORE))
    restored, extras = checkpoint.restore(ck, template, extras_template={"sweep": 0})
    if int(extras["sweep"]) != RESUME_AT:
        raise AssertionError(f"{tag}: extras {extras}")
    M.COUNTS.reset()
    got = sync(run(graph, from_saved(restored), cfg, RESUME_MORE))
    launches = check_counts(f"{tag} resumed", path, RESUME_MORE)
    same_state(f"{tag}: resumed and uninterrupted runs", compared(got), compared(want))
    print(f"[utilities] {tag}: saved after {RESUME_AT} sweeps "
          f"({ck.stat().st_size / 2**20:.1f} MiB), restored, {RESUME_MORE} more sweeps equal "
          f"the uninterrupted run bit for bit; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    return launches


def utilities_path(card):
    """Phase 27: checkpoint / resume into the generic engine, the fast path
    and the halo path on the card; checkpoints across devices; time_sweeps
    and a profiler trace of the fast path."""
    t_phase = time.perf_counter()
    out = {}
    sim = ba.simulate(**BENCH)
    graph, means = ba.build(sim, dtype=torch.float32, layout="ell")
    pallas = dataclasses.replace(CFG, message_form="pallas")
    cmg = sweep_cm.prepare(graph, segsum_exact=True)
    init = sweep_cm.init_state(cmg, means)
    mid = sync(sweep_cm.run(cmg, init, CFG, RESUME_AT))
    as_gbp = lambda st: sweep_cm.to_gbp_state(cmg, st)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # (a) the three engines.
        g_init = sweep.init_state(graph, means)
        out["generic"] = resume(
            "bench64 generic (pallas)", tmp / "generic", sweep.run, graph,
            sync(sweep.run(graph, g_init, pallas, RESUME_AT)), g_init,
            {"fused_relin_messages": 1, "fused_messages": 1, "segsum_by_id": 1}, pallas)
        out["fast"] = resume(
            "bench64 fast path", tmp / "fast", sweep_cm.run, cmg, mid, as_gbp(init),
            (*FULL, *BELIEFS),
            to_saved=as_gbp, from_saved=lambda st: sweep_cm.from_gbp_state(cmg, st),
            compared=lambda st: (as_gbp(st), tuple(v.mean for v in st.v)))
        city = ba.simulate_blocks(**CITY)
        cg, cm = ba.build(city, dtype=torch.float32, **HALO_BUILD)
        _, hcm, h_init, h_run = halo_cm.distribute(cg, cm, 2)
        out["halo"] = resume(
            "city1280 P=2 halo", tmp / "halo", h_run, hcm,
            sync(h_run(hcm, h_init, CFG, RESUME_AT)), h_init,
            dict.fromkeys(halo_mode_kernels(hcm), 2))
        del cg, cm, hcm, h_init
        torch.cuda.empty_cache()

        # (b) saved on the card, restored on the CPU, and back.
        checkpoint.save(tmp / "card", as_gbp(mid))
        on_cpu = checkpoint.restore(tmp / "card", to_device(as_gbp(init), "cpu"))
        same_state("card -> CPU", on_cpu, to_device(as_gbp(mid), "cpu"))
        checkpoint.save(tmp / "cpu", on_cpu)
        back = checkpoint.restore(tmp / "cpu", as_gbp(init))
        if any(t.device != u.device for t, u in zip(leaves(back), leaves(as_gbp(init)))):
            raise AssertionError("a checkpoint restored into a card template left the card")
        same_state("CPU -> card", back, as_gbp(mid))
        print(f"[utilities] bench64 fast-path state saved on the card restored on the CPU, "
              f"saved there and restored on the card: leaves equal ({len(leaves(back))} "
              f"tensors)")

        # (c) time_sweeps.
        rate, _ = profiling.time_sweeps(sweep_cm.run, cmg, init, CFG, SWEEPS)
        print(f"[utilities] time_sweeps bench64 fast path, {SWEEPS} sweeps after 5: "
              f"{rate:.2f} sweeps/s (CUDA events; {card})")

        # (d) a trace of 3 fast-path sweeps names the kernels' CUDA functions.
        # The profiler can drop some of a window's device records: trace
        # again, up to 3 times, until every kernel of the path is named.
        for attempt in range(1, 4):
            logdir = tmp / f"trace{attempt}"
            with profiling.trace(logdir):
                sync(sweep_cm.run(cmg, mid, CFG, 3))
            files = list(logdir.glob("*.pt.trace.json"))
            events = json.loads(files[0].read_text())["traceEvents"] if len(files) == 1 else []
            names = [e["name"] for e in events if e.get("cat") == "kernel"]
            seen = {k: sum(k in n for n in names) for k in ("relin_kernel", "messages_kernel",
                                                            "segsum")}
            print(f"[utilities] trace of 3 fast-path sweeps (attempt {attempt}): {len(files)} "
                  f"file, {len(names)} kernel events; by name {seen} (3, 3, 3 when none is "
                  f"dropped: the sum's combine)")
            if min(seen.values()) > 0:
                break
        else:
            raise AssertionError(f"the trace misses the fast path's kernels: {seen}")
    print(f"[utilities] phase 27 took {time.perf_counter() - t_phase:.1f} s")
    return out


# --- pixels to GBP (phase 28) ------------------------------------------------------------

# The reference's own example on a CPU (`python examples/sfm_from_pixels.py`,
# JAX in float32): what it prints.
REFERENCE_SFM_CPU = dict(observations=156, tracks=40, cameras=6, landmarks=37, are_px=1.248)
# Phase 28 (c): the frontend at a size users run.
FRONTEND_SCENE = dict(n_cams=64, n_lmks=3000, seed=0, fov_frac=0.25)
FRONTEND_SHAPE, FRONTEND_CORNERS = (480, 640), 1024


def events_ms(fn):
    """(fn(), ms of the stream from its first launch to its last kernel's
    end, by CUDA events)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def frontend_timing(card):
    """Phase 28 (c): render_scene and build_tracks' detection, description
    and matching over 64 frames of 480 x 640, max_corners 1024, on the
    card."""
    sim = ba.simulate(**FRONTEND_SCENE)
    n = FRONTEND_SCENE["n_cams"]
    track = dict(min_score=sfm_example.TRACKING["min_score"],
                 ratio=sfm_example.TRACKING["ratio"], max_disp=sfm_example.TRACKING["max_disp"])
    frames, render = events_ms(lambda: pipeline.render_scene(
        sim["cam_truth"], sim["lmk_truth"], sim["k"], shape=FRONTEND_SHAPE, seed=0))
    dets, detect = events_ms(lambda: [features.detect(f, max_corners=FRONTEND_CORNERS)
                                      for f in frames])
    descs, describe = events_ms(lambda: [features.extract_patches(f, xy)
                                         for f, (xy, _) in zip(frames, dets)])
    pairs, match = events_ms(lambda: [
        features.match(descs[i], descs[i + 1], dets[i][1] > 0, dets[i + 1][1] > 0, dets[i][0],
                       dets[i + 1][0], **track) for i in range(n - 1)])
    corners = float(torch.stack([(s > 0).sum() for _, s in dets]).float().mean())
    matched = float(torch.stack([ok.sum() for _, ok in pairs]).float().mean())
    t0 = time.perf_counter()
    cam_ids, lmk_ids, obs = pipeline.build_tracks(
        frames, max_corners=FRONTEND_CORNERS, min_track_len=3, **track)
    tracks_s = time.perf_counter() - t0
    print(f"[sfm] frontend, {n} frames of {FRONTEND_SHAPE[0]} x {FRONTEND_SHAPE[1]}, "
          f"{FRONTEND_SCENE['n_lmks']} landmarks, max_corners {FRONTEND_CORNERS} (CUDA events, "
          f"ms per frame): render_scene {render / n:.4f}, detect {detect / n:.4f}, describe "
          f"{describe / n:.4f}, match {match / (n - 1):.4f} per pair; {corners:.1f} corners per "
          f"frame, {matched:.1f} matches per pair; build_tracks end to end (host clock, the "
          f"chaining on the host) {tracks_s * 1e3 / n:.4f} ms per frame, {obs.shape[0]} "
          f"observations of {len(np.unique(lmk_ids))} tracks ({card})")
    if not (corners > 0.9 * FRONTEND_CORNERS and matched > 0 and obs.shape[0] > 0):
        raise AssertionError(f"frontend at {FRONTEND_SHAPE}: {corners} corners, {matched} matches")


def sfm_path(card):
    """Phase 28: rendered pixels -> tracks -> pose bootstrap -> GBP on the
    card (the example), the bootstrapped problem under message_form "pallas"
    and through the fast path, the frontend's time per frame, and
    triangulate repeating bit for bit."""
    t_phase = time.perf_counter()
    dev = gbp_tpu_torch.default_device()
    ref = REFERENCE_SFM_CPU
    # (a) the example, through its entry point.
    M.COUNTS.reset()
    are, counts = sfm_example.main(log=lambda line: print(f"[sfm] example: {line.strip()}"))
    launches = check_counts("the sfm example", {"segsum_by_id": 1}, sfm_example.SWEEPS)
    launches = {k: v for k, v in launches.items() if v}
    print(f"[sfm] example on the card: {counts['observations']} observations across "
          f"{counts['tracks']} tracks, {counts['cameras']}/6 cameras and {counts['landmarks']} "
          f"landmarks registered, ARE {are:.6f} px after {sfm_example.SWEEPS} generic sweeps "
          f"(the reference's CPU run: {ref['observations']}, {ref['tracks']}, "
          f"{ref['cameras']}/6, {ref['landmarks']}, {ref['are_px']} px); launches {launches}, "
          f"plain calls 0")
    if counts["cameras"] != 6 or not are < 1.5:
        raise AssertionError(f"sfm example on the card: {counts}, ARE {are}")

    # (b) the bootstrapped problem (layout "ell") under "pallas" and through
    # the fast path.
    sim = sfm_example.scene()
    frames = pipeline.render_scene(sim["cam_truth"], sim["lmk_truth"], sfm_example.K,
                                   shape=sfm_example.SHAPE, seed=3)
    boot, _ = sfm_example.bootstrap(frames, dev, log=lambda line: None)
    graph, means = ba.build(boot, huber=2.0, layout="ell")
    are_of = lambda st: float(ba.avg_reprojection_error(graph, st, k=sfm_example.K))
    pallas = dataclasses.replace(sfm_example.CFG, message_form="pallas")
    n = sfm_example.SWEEPS
    M.COUNTS.reset()
    a_pallas = are_of(sync(sweep.run(graph, sweep.init_state(graph, means), pallas, n)))
    check_counts("sfm pallas", {"fused_relin_messages": 1, "fused_messages": 1,
                                "segsum_by_id": 1}, n)
    cmg = sweep_cm.prepare(graph, segsum_exact=True)
    M.COUNTS.reset()
    st = sync(sweep_cm.run(cmg, sweep_cm.init_state(cmg, means), sfm_example.CFG, n))
    check_counts("sfm fast path", (*FULL, *BELIEFS), n)
    a_fast = are_of(sweep_cm.to_gbp_state(cmg, st))
    print(f"[sfm] bootstrapped problem ({graph.fblocks[0].n_valid} factors, ELL deg "
          f"{graph.fblocks[0].ell_deg}), {n} sweeps: ARE {a_pallas:.6f} px under \"pallas\" "
          f"(kernels 20, 19, 3 once a sweep), {a_fast:.6f} px through sweep_cm.prepare "
          f"({cmg.gather_mode}, kernels 1-3 once a sweep)")
    if not (a_pallas < 1.5 and a_fast < 1.5):
        raise AssertionError(f"sfm: ARE pallas {a_pallas}, fast path {a_fast}")

    # (c) the frontend's time per frame at a size users run.
    frontend_timing(card)

    # (d) triangulate twice on the card, bench64's 469,861 observations.
    bench = ba.simulate(**BENCH)
    args = (bench["cam_truth"], bench["k"], bench["cam_ids"], bench["lmk_ids"], bench["obs"])
    one, two = (sync(pipeline.triangulate(*args)) for _ in range(2))
    rel, _ = rel_err(one.cpu(), pipeline.triangulate(*args, device="cpu"))
    print(f"[sfm] triangulate, {bench['obs'].shape[0]} observations of "
          f"{bench['lmk_truth'].shape[0]} landmarks (float64): two runs on the card equal bit "
          f"for bit: {torch.equal(one, two)}; against the CPU rel {rel:.3e}")
    if not torch.equal(one, two) or not rel <= 1e-9:
        raise AssertionError(f"triangulate on the card: repeat {torch.equal(one, two)}, "
                             f"rel {rel:.3e}")
    print(f"[sfm] phase 28 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# --- several processes (phase 29) ---------------------------------------------------------


MP_SWEEPS = 50
# The reference test's count (tests/test_schur.py): at 50 the CG is far
# from converged and the one-device step differs from itself by 8.8e-9
# relative between two runs (`index_add_`'s order on the card), at 100 by
# 2.4e-12.
MP_SCHUR_CG = 100
MP_TIMEOUT_S = 420.0  # the ranks' time limit: a hung rank fails the phase


def mp_halo(tag, graph, means, n_parts, comm):
    """One rank's halo_cm run of `graph` on its partitions of `n_parts`:
    MP_SWEEPS sweeps through the partitions' kernels (each launched once per
    held partition and sweep, no plain call), the collected means, and a
    timed rerun with the communicator's bytes and host staging."""
    hp, hcm, init, run = halo_cm.distribute(graph, means, n_parts, comm=comm)
    k = len(comm.parts)
    M.COUNTS.reset()
    st = sync(run(hcm, init, CFG, MP_SWEEPS))
    launches = check_counts(f"{tag} rank {comm.rank}", dict.fromkeys(halo_mode_kernels(hcm), k),
                            MP_SWEEPS)
    means_out = [m.cpu() for m in multihost.collect_means(hp, st, comm)]
    comm.reset_stats()
    t0 = time.perf_counter()
    sync(run(hcm, init, CFG, MP_SWEEPS))
    dt = time.perf_counter() - t0
    return dict(means=means_out, sweeps_per_s=MP_SWEEPS / dt, stats=dict(comm.stats),
                launches={n: c / MP_SWEEPS for n, c in launches.items() if c},
                collective_bytes=halo.collective_bytes(hp), mode=hcm.gather_mode,
                win_w=hcm.win_w, transport=comm.transport, parts=(comm.parts.start,
                                                                  comm.parts.stop))


def mp_spmd(tag, graph, means, n_parts, comm, shard):
    """One rank's spmd (or, shard=True, sharding) run of the bench scene
    under message_form "pallas": MP_SWEEPS sweeps, launches per sweep, the
    replicated means, a timed rerun."""
    cfg = dataclasses.replace(CFG, message_form="pallas")
    if shard:
        g, init = sharding.distribute(graph, sweep.init_state(graph, means), n_parts, comm=comm)
    else:
        g, init = spmd.distribute(graph, means, n_parts, comm=comm)
    run = spmd.make_run(g, n_parts, comm)
    inbox = [s is not None for s in (g.inboxes or (None,) * len(g.vblocks))]
    # Per held partition and sweep: kernel 20 (which launches 19) once, and
    # kernel 3 once per slot into a variable block without a dense inbox.
    k = len(comm.parts)
    sums = sum(1 for vb in g.fblocks[0].vblocks if not inbox[vb])
    M.COUNTS.reset()
    st = sync(run(g, init, cfg, MP_SWEEPS))
    launches = check_counts(f"{tag} rank {comm.rank}", {
        "fused_relin_messages": k, "fused_messages": k, "segsum_by_id": k * sums}, MP_SWEEPS)
    comm.reset_stats()
    t0 = time.perf_counter()
    sync(run(g, init, cfg, MP_SWEEPS))
    dt = time.perf_counter() - t0
    return dict(means=[vs.mean.cpu() for vs in st.v], sweeps_per_s=MP_SWEEPS / dt,
                stats=dict(comm.stats), launches={n: c / MP_SWEEPS for n, c in launches.items()
                                                  if c},
                inboxes=inbox, rows=g.fblocks[0].count, transport=comm.transport,
                parts=(comm.parts.start, comm.parts.stop))


def mp_worker(rank, world, init_method, out_dir):
    """Phase 29 on one rank of a gloo group whose ranks share the card."""
    device = multihost.initialize(init_method, world, rank, backend="gloo",
                                  device=gbp_tpu_torch.default_device())
    gbp_tpu_torch.set_exact_f32()
    t0 = time.perf_counter()
    out = {}
    city = ba.simulate_blocks(**CITY)
    graph, means = ba.build(city, dtype=torch.float32, device=device, **HALO_BUILD)
    for n_parts in (2, 4):
        comm = multihost.global_comm(n_parts, device=device)
        out[f"city P={n_parts}"] = mp_halo(f"city1280 P={n_parts}", graph, means, n_parts, comm)
    del graph, means
    bench = ba.simulate(**BENCH)
    graph, means = ba.build(bench, dtype=torch.float32, device=device, layout="ell")
    comm = multihost.global_comm(2, device=device)
    out["spmd"] = mp_spmd("bench64 spmd", graph, means, 2, comm, shard=False)
    out["sharding"] = mp_spmd("bench64 sharding", graph, means, 2, comm, shard=True)
    graph, means = ba.build(bench, dtype=torch.float64, device=device, layout="ell")
    g, _ = sharding.distribute(graph, sweep.init_state(graph, means), 2, comm=comm)
    comm.reset_stats()
    t1 = time.perf_counter()
    step = sync(schur.gauss_newton_step(g, means, cg_iters=MP_SCHUR_CG, comm=comm))
    out["schur"] = dict(means=[m.cpu() for m in step], seconds=time.perf_counter() - t1,
                        stats=dict(comm.stats))
    out["seconds"] = time.perf_counter() - t0
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()



def spawn_ranks(world, timeout):
    """`mp_worker` in `world` spawned processes; returns each rank's
    results.  A rank that exits non-zero fails the phase; one still running
    after `timeout` seconds is killed and fails it."""
    ctx = torch.multiprocessing.get_context("spawn")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as out:
        procs = [ctx.Process(target=mp_worker, args=(r, world, f"tcp://localhost:{port}", out))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.perf_counter() + timeout
        try:
            for p in procs:
                p.join(max(deadline - time.perf_counter(), 0.0))
            codes = [p.exitcode for p in procs]
            if codes != [0] * world:
                raise AssertionError(f"phase 29: rank exit codes {codes} (None: still running "
                                     f"after {timeout} s)")
            return [torch.load(Path(out) / f"rank{r}.pt") for r in range(world)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()


def same_or_close(what, got, want, why):
    """Bit for bit, or (printing `why`) within 1e-6 relative."""
    if all(torch.equal(a, b) for a, b in zip(got, want)):
        print(f"[multiprocess] {what}: equal bit for bit")
        return
    rel = max(rel_err(a, b)[0] for a, b in zip(got, want))
    print(f"[multiprocess] {what}: not bit for bit, {rel:.3e} relative ({why})")
    if not rel <= 1e-6:
        raise AssertionError(f"{what}: {rel:.3e} relative")


def rank_line(tag, r, res):
    st, sweeps = res["stats"], MP_SWEEPS
    extra = ""
    if "collective_bytes" in res:
        extra = (f"; halo.collective_bytes {res['collective_bytes']['halo_bytes_per_sweep']} "
                 f"bytes a partition and sweep")
    print(f"[multiprocess] {tag} rank {r} (partitions {res.get('parts', '-')}, transport "
          f"{res['transport']}): {res['sweeps_per_s']:.2f} sweeps/s; launches per sweep "
          f"{res['launches']}; through the communicator per sweep {st['bytes_sent'] / sweeps:.0f} "
          f"bytes sent, {st['bytes_received'] / sweeps:.0f} received, "
          f"{st['collectives'] / sweeps:.0f} collectives{extra}; host staging "
          f"{st['staged_bytes'] / sweeps:.0f} bytes and {st['staging_s'] / sweeps * 1e3:.3f} ms "
          f"per sweep")


def nccl_check(card):
    """Phase 29 (c): a one-rank NCCL group holding both partitions of city
    cut in two: the three collectives equal `LocalComm` bit for bit, and so
    do MP_SWEEPS halo_cm sweeps."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dev = multihost.initialize(f"tcp://localhost:{port}", 1, 0, backend="nccl",
                               device=gbp_tpu_torch.default_device())
    try:
        comm, local = multihost.global_comm(2, device=dev), halo.LocalComm(2)
        x = torch.randn((2, 1000, 12), generator=torch.Generator(dev).manual_seed(0), device=dev)
        ops = [("all_gather", comm.all_gather(x), local.all_gather(x)),
               ("all_reduce", comm.all_reduce(x), local.all_reduce(x))]
        ops += [(f"shift {o}", comm.shift(x, o), local.shift(x, o)) for o in (-1, 1, 2)]
        for name, a, b in ops:
            if not torch.equal(a, b):
                raise AssertionError(f"nccl {name}: not equal to LocalComm")
        sim = ba.simulate_blocks(**CITY)
        graph, means = ba.build(sim, dtype=torch.float32, **HALO_BUILD)
        res = mp_halo("city1280 P=2 nccl", graph, means, 2, comm)
        hp, hcm, init, run = halo_cm.distribute(graph, means, 2)
        want = halo.collect_means(hp, sync(run(hcm, init, CFG, MP_SWEEPS)))
        print(f"[multiprocess] (c) one-rank NCCL group, P = 2, K = 2 ({comm.transport}): "
              f"all_gather, all_reduce, shift -1, 1, 2 equal LocalComm bit for bit")
        rank_line("(c) city1280 P=2", 0, res)
        same_or_close("(c) city1280 P=2 over NCCL against one process", res["means"],
                      [m.cpu() for m in want], "the same kernels on the same inputs")
    finally:
        torch.distributed.destroy_process_group()


def multiprocess_path(card):
    """Phase 29: the halo, SPMD, sharded and Schur paths across processes on
    the card: two gloo ranks sharing it (host-staged transport) and a
    one-rank NCCL group, each against the one-process run."""
    t_phase = time.perf_counter()
    ranks = spawn_ranks(2, MP_TIMEOUT_S)
    print(f"[multiprocess] two ranks on {card} under gloo: {ranks[0]['seconds']:.1f} / "
          f"{ranks[1]['seconds']:.1f} s of work each, the card time-sliced between them")
    sim = ba.simulate_blocks(**CITY)
    graph, means = ba.build(sim, dtype=torch.float32, **HALO_BUILD)
    tmpl = sweep.init_state(graph, means)
    for n_parts, tag in ((2, "(a)"), (4, "(b)")):
        key = f"city P={n_parts}"
        hp, hcm, init, run = halo_cm.distribute(graph, means, n_parts)
        M.COUNTS.reset()
        t0 = time.perf_counter()
        want = halo.collect_means(hp, sync(run(hcm, init, CFG, MP_SWEEPS)))
        one_s = MP_SWEEPS / (time.perf_counter() - t0)
        are = float(ba.avg_reprojection_error(graph, ba.with_means(tmpl, want), k=sim["k"]))
        print(f"[multiprocess] {tag} city1280 P={n_parts} on 2 ranks (K = {n_parts // 2}; "
              f"mode {ranks[0][key]['mode']}, win_w {ranks[0][key]['win_w']}); one process "
              f"{one_s:.2f} sweeps/s, ARE {are:.6f} px")
        for r, res in enumerate(ranks):
            rank_line(f"{tag} city1280 P={n_parts}", r, res[key])
            same_or_close(f"{tag} city1280 P={n_parts} rank {r} against one process",
                          res[key]["means"], [m.cpu() for m in want],
                          "the same kernels on the same inputs")
    del graph, means, tmpl
    torch.cuda.empty_cache()
    nccl_check(card)

    # (d) spmd and sharding at full width, against the single-device generic run.
    dev = gbp_tpu_torch.default_device()
    bench = ba.simulate(**BENCH)
    graph, means = ba.build(bench, dtype=torch.float32, layout="ell")
    tmpl = sweep.init_state(graph, means)
    cfg = dataclasses.replace(CFG, message_form="pallas")
    one = sync(sweep.run(graph, tmpl, cfg, MP_SWEEPS))
    are_of = lambda mu: float(ba.avg_reprojection_error(
        graph, ba.with_means(tmpl, tuple(m.to(dev) for m in mu)), k=bench["k"]))
    are1 = are_of([vs.mean for vs in one.v])
    for key in ("spmd", "sharding"):
        for r, res in enumerate(ranks):
            are = are_of(res[key]["means"])
            print(f"[multiprocess] (d) bench64 {key} on 2 ranks ({res[key]['rows']} rows a "
                  f"rank, dense inboxes {res[key]['inboxes']}): ARE {are:.6f} px after "
                  f"{MP_SWEEPS} sweeps, one device {are1:.6f} (difference {abs(are - are1):.3e})")
            rank_line(f"(d) bench64 {key}", r, res[key])
            if not abs(are - are1) <= 1e-3:
                raise AssertionError(f"bench64 {key} rank {r}: ARE {are} vs one device's {are1}")
    del graph, means, tmpl, one
    torch.cuda.empty_cache()

    # (e) the sharded Schur step, float64.
    graph, means = ba.build(bench, dtype=torch.float64, layout="ell")
    t0 = time.perf_counter()
    want = sync(schur.gauss_newton_step(graph, means, cg_iters=MP_SCHUR_CG))
    one_s = time.perf_counter() - t0
    for r, res in enumerate(ranks):
        rel = max(rel_err(a.to(dev), b)[0] for a, b in zip(res["schur"]["means"], want))
        st = res["schur"]["stats"]
        print(f"[multiprocess] (e) bench64 float64 Schur step ({MP_SCHUR_CG} CG iterations) on "
              f"2 ranks, rank {r}: {res['schur']['seconds']:.3f} s (one device {one_s:.3f} s), "
              f"{st['collectives']} all-reduces, {st['bytes_sent']} bytes sent, host staging "
              f"{st['staging_s'] * 1e3:.1f} ms; {rel:.3e} relative to the one-device step")
        if not rel <= 1e-9:
            raise AssertionError(f"sharded Schur step rank {r}: {rel:.3e} relative")
    print(f"[multiprocess] phase 29 took {time.perf_counter() - t_phase:.1f} s; a run across "
          f"several cards (NCCL between cards) cannot be measured on this machine")


# --- the segmented layout and cameras in the ELL slot (phases 30 and 31) ------------------


# Phase 30's scenes: the reference's own segmented test scene (2 x 16
# cameras), blocks8 (auto: two windowed classes) and blocks7 (exact:
# windowed and unwindowed classes); city and venice (auto: three and five
# windowed classes).
SEG_SCENE = dict(n_blocks=2, n_cams=16, lmks_per_cam=30, window=3, seed=0, shuffle=True)
BLOCKS8 = dict(BLOCKS7, n_blocks=8)
SEG_SWEEPS_VENICE = 50  # sweeps per timed repeat at venice (city: SWEEPS)
SEG_PAIRS = 8  # alternating segmented / single runs per scene
# Phase 31's scenes: the 16 x 12 command line's, 640 cameras with a quarter
# of their landmarks (the landmark windows engage), 1,920 cameras the same
# way (windows per halo partition), each also as a BAL problem; the 9-dof
# cameras take a stiff intrinsics prior (3.5 observations a camera).
DENSE48 = dict(bench.DENSE_BLOCKS, n_blocks=48)
BAL_INTR_PRIOR = (1e6, 1e6, 1e6)


def seg_ops(sg, st, i):
    """The operands class i of a segmented graph hands its kernels: its
    rows of the shared landmark tables (`sweep_cm.sweep_seg`)."""
    p, fb = sg.parts[i], sg.fb
    e = fb.ell_slot
    vs_c, vs_l = st.v[fb.vblocks[1 - e]], st.v[fb.vblocks[e]]
    n_pad = sg.n_tab - vs_l.eta.shape[0]
    lmk_tab = sweep_cm._with_identity_rows(sweep_cm._packed(vs_l), fb.dofs[e], n_pad)
    lmk_mean = torch.nn.functional.pad(vs_l.mean, (0, 0, 0, n_pad))
    rows = slice(p.v0, p.v0 + p.nv)
    return dict(gslot=1 - e, deg=p.deg, mp=p.mp, gidx=p.gidx, z=p.z, prec=p.prec, act=p.act,
                args=p.args, comp_name=fb.ftype.name, win_w=p.win_w, win_starts=p.win_starts,
                win_rows=p.win_rows, win_offsets=p.win_offsets, blk_tiles=p.blk_tiles,
                blk_offsets=p.blk_offsets, seg_rows=p.seg_rows, seg_offsets=p.seg_offsets,
                seg_ids=p.seg_ids, cam_mean=vs_c.mean.contiguous(),
                cam_tab=sweep_cm._packed(vs_c).contiguous(),
                lmk_mean=lmk_mean[rows].contiguous(), lmk_tab=lmk_tab[rows].contiguous(),
                fs=st.f[i])


def check_ops(tag, o, dtype, errs, unfused=False, times=None):
    """Phases 30 and 31: the table kernels of one graph or degree class on
    its operands `o` (`table_ops`, `seg_ops`) against their plain versions
    (`check_table_kernels`); with `unfused` also 14 and 9, 8 (windowed) or
    7, 6 on its output.  float64 to 1e-11, float32 to 1e-4, relative.
    Given `times`, each kernel's device ms per call on these operands (the
    profiler, the config's beta, Huber off) goes into it by name."""
    compare = make_compare(tag, TOL[dtype], errs)
    calls = check_table_kernels(tag, o, dtype, compare)[2]
    if unfused:
        check = check_unfused_win_kernels if o["win_w"] else check_unfused_kernels
        calls.update(check(tag, o, dtype, compare, None))
    if times is not None:
        for name, fn in calls.items():
            times[name] = device_ms(fn, 10)
        print(f"[kernels] {tag} on the device (profiler, ms a call): "
              + ", ".join(f"{name} {ms:.4f}" for name, ms in times.items()) + f" ({card_line()})")


def seg_graph(tag, scene, mode, dtype, windows):
    """The segmented graph of a merged-blocks scene on the card, its classes
    windowed as `windows` says, and its state after 8 sweeps."""
    graph, means = ba.build(ba.simulate_blocks(**scene), dtype=dtype, **BIG)
    sg = sweep_cm.prepare_seg(graph, classes_mode=mode)
    if not isinstance(sg, sweep_cm.CMSegGraph) or [bool(p.win_w) for p in sg.parts] != windows:
        raise AssertionError(f"{tag}: prepare_seg gave " + ("None" if sg is None else str(
            [(p.deg, p.win_w) for p in sg.parts])))
    print(f"[seg] {tag} {str(dtype)[6:]}: classes (degree, landmarks, rows, win_w) "
          f"{[(p.deg, p.n_groups, p.mp, p.win_w) for p in sg.parts]}, {sg.mp} rows")
    return graph, means, sg, sync(sweep_cm.run(sg, sweep_cm.init_state(sg, means), CFG, 8))


def seg_speed(tag, graph, means, sg, n, card):
    """Sweeps/s of the segmented graph and of the single segment: runs of n
    sweeps after a warm one, SEG_PAIRS pairs in one call, each pair in the
    other order than the last (segmented first, then single first, ...),
    every run printed; then kernel launches and device ms per sweep over
    one profiled run of 10 sweeps and the busy share."""
    runs = {}
    for name, cmg in (("segmented", sg), ("single", sweep_cm.prepare(graph, window=True))):
        init = sweep_cm.init_state(cmg, means)
        runs[name] = (cmg, lambda k, cmg=cmg, init=init: sweep_cm.run(cmg, init, CFG, k))
        sync(runs[name][1](n))
    rates = {name: [] for name in runs}
    for k in range(SEG_PAIRS):
        for name in ("segmented", "single")[::1 if k % 2 == 0 else -1]:
            rates[name].append(n / timed(lambda: runs[name][1](n))[1])
    ratios = sorted(a / b for a, b in zip(rates["segmented"], rates["single"]))
    for name, (cmg, run) in runs.items():
        r = rates[name]
        med = statistics.median(r)
        launches, dev_ms = profiled_sweeps(run, 10)
        print(f"[seg] {tag} {name}: {cmg.mp} rows, {med:.2f} sweeps/s (median of {len(r)} runs "
              f"of {n} sweeps in alternating pairs; every run in order: "
              f"{', '.join(f'{x:.2f}' for x in r)}), {launches:.1f} launches and "
              f"{dev_ms:.4f} device ms per sweep, busy share {dev_ms * med / 1e3:.3f} ({card})")
    print(f"[seg] {tag} segmented / single, pair by pair (sorted): "
          f"{', '.join(f'{x:.3f}' for x in ratios)}; median {statistics.median(ratios):.3f}; "
          f"segmented faster in {sum(x > 1 for x in ratios)} of {len(ratios)} pairs")
    del runs
    torch.cuda.empty_cache()


def profiled_sweeps(run, n):
    """(kernel launches, device ms) per sweep of `run(n)` (n sweeps from a
    prepared state, nothing set up), by the profiler over one run."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(n)
        torch.cuda.synchronize()
    events = prof.events()
    launches = sum(1 for e in events if e.name in serving.LAUNCH_CALLS)
    dev_us = sum(e.time_range.elapsed_us() for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    return launches / n, dev_us / 1e3 / n


def seg_path(card):
    """Phase 30: the degree-class segmented layout (`prepare_seg`,
    `sweep_seg`) on the card.  (a) Per class, kernels 1, 2, 3 or 11, 10, 16,
    15 against their plain versions: city (auto, three windowed classes)
    and blocks7 (exact, windowed and unwindowed classes) in float32; in
    float64 blocks7's whole camera table exceeds the full-table kernels'
    shared memory, so `prepare_seg` declines it there, and float64 runs
    blocks8 (auto, windowed) and the reference's test scene (exact, five
    unwindowed classes).  (b) City through `prepare(segment=True)`: kernel
    launches per sweep counted (11, 10, 16, 15 three times), the ARE at 50
    sweeps within 5e-3 px of the single segment.  (c) Sweeps/s, launches
    and device ms per sweep, segmented and single segment, at city and
    venice."""
    t_phase = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    errs = {}
    for tag, scene, mode, dtype, windows in (
            ("city1280 auto", CITY, "auto", f32, [True] * 3),
            ("blocks7 exact", BLOCKS7, "exact", f32, [True] * 3 + [False] * 2),
            ("blocks8 auto", BLOCKS8, "auto", f64, [True] * 2),
            ("scene32 exact", SEG_SCENE, "exact", f64, [False] * 5)):
        _, _, sg, st = seg_graph(tag, scene, mode, dtype, windows)
        for i, p in enumerate(sg.parts):
            check_ops(f"{tag} {str(dtype)[6:]} class {i} (deg {p.deg}, "
                      f"{'windowed' if p.win_w else 'whole table'})", seg_ops(sg, st, i), dtype,
                      errs)
        del sg, st
    g7, _ = ba.build(ba.simulate_blocks(**BLOCKS7), dtype=f64, device="cpu", **BIG)
    if sweep_cm.prepare_seg(g7, classes_mode="exact") is not None:
        raise AssertionError("blocks7 float64: prepare_seg should decline (table gate)")
    print(f"[seg] blocks7 exact float64: declined, its whole camera table "
          f"({280 * M.F_CAM * 8} bytes) exceeds SMEM_TABLE_BYTES ({M.SMEM_TABLE_BYTES})")
    print(f"[seg] kernels held per class (max abs err): {json.dumps(errs)}")

    sim = ba.simulate_blocks(**CITY)
    graph, means = ba.build(sim, dtype=f32, **BIG)
    sg = sweep_cm.prepare(graph, window=True, segment=True)
    if not isinstance(sg, sweep_cm.CMSegGraph) or len(sg.parts) != 3:
        raise AssertionError(f"city: prepare(segment=True) gave {type(sg).__name__}")
    M.COUNTS.reset()
    st = sync(sweep_cm.run(sg, sweep_cm.init_state(sg, means), CFG, QUALITY_SWEEPS))
    launches = check_counts("city segmented", dict.fromkeys(WINDOWED, 3), QUALITY_SWEEPS)
    single = sweep_cm.prepare(graph, window=True)
    st1 = sweep_cm.run(single, sweep_cm.init_state(single, means), CFG, QUALITY_SWEEPS)
    are, are1 = are_px(graph, sg, st, sim["k"]), are_px(graph, single, st1, sim["k"])
    print(f"[seg] city segmented: {QUALITY_SWEEPS} sweeps, launches "
          f"{ {k: v for k, v in launches.items() if v} } ({len(sg.parts)} classes x "
          f"{QUALITY_SWEEPS}); plain calls 0; ARE {are:.6f} px, single segment {are1:.6f} px "
          f"(difference {abs(are - are1):.3e})")
    if not (math.isfinite(are) and abs(are - are1) <= 5e-3):
        raise AssertionError(f"city segmented ARE {are} vs single segment {are1}")
    same_means("city segmented", st, sweep_cm.run(sg, sweep_cm.init_state(sg, means), CFG,
                                                  QUALITY_SWEEPS))
    del st, st1, single
    seg_speed("city1280", graph, means, sg, SWEEPS, card)
    del graph, means, sg
    torch.cuda.empty_cache()
    graph, means = ba.build(ba.simulate_blocks(**VENICE), dtype=f32, **BIG)
    sg = sweep_cm.prepare(graph, window=True, segment=True)
    if not isinstance(sg, sweep_cm.CMSegGraph):
        raise AssertionError("venice: prepare(segment=True) declined")
    print(f"[seg] venice10240: classes (degree, landmarks, rows, win_w) "
          f"{[(p.deg, p.n_groups, p.mp, p.win_w) for p in sg.parts]}, {sg.mp} rows")
    seg_speed("venice10240", graph, means, sg, SEG_SWEEPS_VENICE, card)
    del graph, means, sg
    torch.cuda.empty_cache()
    print(f"[seg] phase 30 took {time.perf_counter() - t_phase:.1f} s")


def ell_camera_scenes(dtype):
    """Phase 31's single-device scenes: (tag, graph, means) on the card."""
    f64 = dtype == torch.float64
    dense = bench.dense_cameras(ba.simulate_blocks(**bench.DENSE_BLOCKS))
    bal_dense = bench.bal_scene(dense)
    out = [("dense640 (6, 3, 2)", *ba.build(dense, dtype=dtype, **BIG))]
    for intr in (False, True):
        g, m, _ = ba.build_bal(bal_dense, dtype=dtype, optimize_intrinsics=intr,
                               cam_prior_prec=1000.0, lmk_prior_prec=1000.0,
                               intr_prior_prec=BAL_INTR_PRIOR)
        out.append((f"bal dense640 {'(9, 3, 2)' if intr else '(6, 3, 2) BAL'}", g, m))
    if f64:
        out.append(("16x12 (6, 3, 2)", *ba.build(ba.simulate(n_cams=16, n_lmks=12, seed=0),
                                                 dtype=dtype)))
    return out


def ell_cameras_path(card):
    """Phase 31: cameras in the ELL slot (the landmarks gathered, slot 1, at
    (6, 3, 2) and (9, 3, 2)).  (a) Every table kernel against its plain
    version at slot 1, float64 and float32: the windowed fused and unfused
    kernels (11, 10, 16, 15; 9, 8, 14) and, with the windows off, the
    whole-table ones (1, 2, 3; 7, 6, 14), on 640 cameras with a quarter of
    their landmarks (windows over landmark ids) and on the same geometry as
    a BAL problem with 6-dof (per-row distortion) and 9-dof cameras; the
    halo kernels 17, 18, 12, 13 per partition of 1,920 such cameras cut in
    two, as reprojection and as 9-dof BAL.  (b) `python -m
    gbp_tpu_torch.ba --n_cams 16 --n_lmks 12 --oracle`, on one device and
    with `--n_chips 2`: kernels 1, 2 and 3 launched once a sweep on each
    partition and nothing else (counted; no plain call), the final ARE
    finite and within 1.05x the dense MAP's.  In float32 every kernel's
    device time at slot 1 is printed (the profiler; the halo kernels on
    partition 0 with their bounds)."""
    t_phase = time.perf_counter()
    errs = {}
    for dtype in (torch.float64, torch.float32):
        f32 = dtype == torch.float32
        for tag, graph, means in ell_camera_scenes(dtype):
            fb = graph.fblocks[0]
            if fb.ell_slot != 0:
                raise AssertionError(f"{tag}: the ELL slot is {fb.ell_slot}, not the cameras")
            for window in (True, False):
                cmg = sweep_cm.prepare(graph, window=window)
                if cmg.gather_mode != "table" or (window and "16x12" not in tag
                                                  and not cmg.win_w):
                    raise AssertionError(f"{tag}: {cmg.gather_mode}, win_w {cmg.win_w}")
                st = sync(sweep_cm.run(cmg, sweep_cm.init_state(cmg, means), CFG, 8))
                check_ops(f"{tag} {str(dtype)[6:]} "
                          + (f"win_w {cmg.win_w}" if cmg.win_w else "whole table"),
                          table_ops(cmg, st), dtype, errs, unfused=True,
                          times={} if f32 and "16x12" not in tag else None)
        dense48 = bench.dense_cameras(ba.simulate_blocks(**DENSE48))
        for tag, build in (
                ("dense1920 (6, 3, 2) P=2", lambda dv: ba.build(
                    dense48, dtype=dtype, device=dv, **HALO_BUILD)),
                ("bal dense1920 (9, 3, 2) P=2", lambda dv: ba.build_bal(
                    bench.bal_scene(dense48), dtype=dtype, device=dv, layout="none",
                    optimize_intrinsics=True, cam_prior_prec=1000.0, lmk_prior_prec=1000.0,
                    intr_prior_prec=BAL_INTR_PRIOR)[:2])):
            g, m = build("cpu")
            hp, hcm, st, run = halo_cm.distribute(g, m, 2, device="cpu")
            if hcm.e != 0 or not hcm.win_w:
                raise AssertionError(f"{tag}: ELL slot {hcm.e}, win_w {hcm.win_w}")
            st = run(hcm, st, CFG, 8)
            check_halo_kernels(tag, halo.to_device(hcm, "cuda"), halo.to_device(st, "cuda"),
                               dtype, errs, {} if f32 else None)
    print(f"[cams in ELL] kernels held at slot 1 (max abs err): {json.dumps(errs)}")
    for extra in ([], ["--n_chips", "2"]):
        M.COUNTS.reset()
        res = ba_cli.main(["--n_cams", "16", "--n_lmks", "12", "--oracle", *extra])
        used = {k: v for k, v in M.COUNTS.kernel.items() if v}
        final, are_map = res["are"][-1][1], res["are_map"]
        print(f"[cams in ELL] python -m gbp_tpu_torch.ba --n_cams 16 --n_lmks 12 --oracle "
              f"{' '.join(extra)}: path {res['path']!r}, launches {used}, plain calls "
              f"{sum(M.COUNTS.plain.values())}; final ARE {final:.6f} px, dense MAP "
              f"{are_map:.6f} px, ratio {final / are_map:.6f}; {res['sweeps_per_s']:.2f} "
              f"sweeps/s ({card})")
        # Kernels 1, 2 and 3 once a sweep on each partition (the 16 x 12 scene
        # has no windows), no other kernel and no plain call.
        parts = int(extra[1]) if extra else 1
        check_counts(f"--n_cams 16 --n_lmks 12 {' '.join(extra)}",
                     FULL if extra else (*FULL, *BELIEFS), res["are"][-1][0] * parts)
        if not (math.isfinite(final) and final <= 1.05 * are_map):
            raise AssertionError(f"--n_cams 16 --n_lmks 12 {extra}: ARE {final} vs {are_map}")
    print(f"[cams in ELL] phase 31 took {time.perf_counter() - t_phase:.1f} s")


# --- the benchmark layer (phase 32) ------------------------------------------------------------

# bench_baseline.json's entry at the bench size (469,861 factors), s a sweep.
BASELINE_S_PER_SWEEP = 80.87697839736938
BENCH_FACTORS = 469861
HARNESS_TIMEOUT_S = 300.0  # the headline's process: a hung run fails the phase


def headline_cli(card):
    """Phase 32 (a): `python -m gbp_tpu_torch.bench` in its own process (its
    stderr echoed), its last line parsed; returns it with the eager rate
    the process logged."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(root), os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "gbp_tpu_torch.bench"], cwd=root, env=env,
                          capture_output=True, text=True, timeout=HARNESS_TIMEOUT_S)
    for line in proc.stderr.splitlines():
        print(f"[bench cli] {line}")
    if proc.returncode:
        raise AssertionError(f"python -m gbp_tpu_torch.bench exited {proc.returncode}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    eager = float(re.search(r"eager \d+ sweeps: [\d.]+s -> ([\d.]+) sweeps/s",
                            proc.stderr).group(1))
    print(f"[bench cli] python -m gbp_tpu_torch.bench ({time.perf_counter() - t0:.1f} s, {card}): "
          f"{json.dumps(res)}; eager {eager:.2f} sweeps/s")
    keys = {"metric", "value", "unit", "vs_baseline", "wall_clock_to_convergence_s", "n_factors"}
    if set(res) != keys or res["n_factors"] != BENCH_FACTORS:
        raise AssertionError(f"the headline line {res} lacks bench.py's keys or its factors")
    # Both numbers are rounded to 2 decimals from the same unrounded rate.
    if not abs(res["vs_baseline"] - res["value"] * BASELINE_S_PER_SWEEP) <= (
            0.005 * BASELINE_S_PER_SWEEP + 0.005):
        raise AssertionError(f"vs_baseline {res['vs_baseline']} is not the cached baseline's")
    if not (res["wall_clock_to_convergence_s"] is not None
            and math.isfinite(res["wall_clock_to_convergence_s"])):
        raise AssertionError("the headline did not reach 1.05x the MAP ARE")
    if not res["value"] > eager:
        raise AssertionError(f"captured {res['value']} sweeps/s not above eager {eager}")
    return res, eager


def replay_records(fn, n=3):
    """({device record name: count}, launch calls, device ms) per call of
    `fn` over n calls, by the profiler, after one warm call; in a new window
    while it recorded no device activity."""
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        names, launches, dev_us = {}, 0, 0.0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                names[e.name] = names.get(e.name, 0) + 1
                dev_us += e.time_range.elapsed_us()
            elif e.name in serving.LAUNCH_CALLS:
                launches += 1
        if names:
            return {k: v / n for k, v in names.items()}, launches / n, dev_us / 1e3 / n
    raise RuntimeError("the profiler recorded no device activity in 5 windows")


# The venice1778 cell's scene (benchmark/configs/venice1778.json): 127
# corridors of 14 cameras, 993,186 landmarks, 5,001,729 observations.
VENICE1778 = dict(n_blocks=127, n_cams=14, lmks_per_cam=562, window=3, wall_dist=4.77, seed=1,
                  shuffle=True)


def belief_operands(cmg, state):
    """(args, deg) that one sweep from `state` hands `update_beliefs`."""
    seen = []

    def record(*args, deg):
        seen.append((args, deg))
        return M.update_beliefs_plain(*args, deg=deg)

    real, sweep_cm.update_beliefs = sweep_cm.update_beliefs, record
    try:
        sync(sweep_cm.sweep(cmg, state, CFG))
    finally:
        sweep_cm.update_beliefs = real
    (op,) = seen
    return op


def beliefs_path(card, timings=None, errs=None):
    """Phase 33: the belief-update kernel against its plain version on the
    card at bench64 (with and without a padding landmark) and venice1778,
    float32, with its launch plan, device ms, bound and share.  The bench64
    row lands in `timings` and `errs`."""
    t_phase = time.perf_counter()
    f32 = torch.float32
    errs = {} if errs is None else errs
    scenes = (("bench64", lambda: ba.build(ba.simulate(**BENCH), dtype=f32)),
              ("bench64 7,999", lambda: ba.build(ba.simulate(**{**BENCH, "n_lmks": 7999}),
                                                 dtype=f32)),
              ("venice1778", lambda: ba.build(ba.simulate_blocks(**VENICE1778), dtype=f32, **BIG)))
    for tag, build in scenes:
        graph, means = build()
        cmg = sweep_cm.prepare(graph)
        st = sync(sweep_cm.run(cmg, sweep_cm.init_state(cmg, means), CFG, 3))
        args, deg = belief_operands(cmg, st)
        me, ml, sum_c, pe, pl, pe_c, pl_c = args
        kern = lambda: M.update_beliefs(*args, deg=deg)
        got, again = sync(kern()), sync(kern())
        if not all(torch.equal(a, b) for a, b in zip(got[0] + got[1], again[0] + again[1])):
            raise AssertionError(f"beliefs {tag}: two runs of the kernel differ")
        ref = sync(M.update_beliefs_plain(*args, deg=deg))
        make_compare(f"beliefs {tag}", TOL[f32], errs)(
            "update_beliefs", got[0] + got[1], ref[0] + ref[1], key="update_beliefs")
        (n_l, d_e), (n_c, d_g) = pe.shape, pe_c.shape
        plan = M.belief_plan(f32, d_e=d_e, d_g=d_g, deg=deg, n_l=n_l, n_c=n_c)
        # Read once: the real variables' message rows, the priors, the
        # gathered sums; written once: both blocks' eta, lam and mean.
        nbytes = 4 * (n_l * deg * (d_e + d_e * d_e) + sum_c.numel() + pe.numel() + pl.numel()
                      + pe_c.numel() + pl_c.numel()
                      + sum(t.numel() for t in got[0] + got[1]))
        ms, plain_ms = time_ms(kern, 20), time_ms(lambda: M.update_beliefs_plain(*args, deg=deg),
                                                  3)
        dev = device_ms(kern, 20)
        b_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        print(f"[beliefs] {tag}: {n_l} ELL variables of degree {deg} (mp {me.shape[1]}), {n_c} "
              f"gathered; plan {plan}; wrapper {ms:.4f} ms, device {dev:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({nbytes / 1e6:.1f} MB once), share "
              f"{b_ms / dev:.3f} ({card})")
        if tag == "bench64" and timings is not None:
            timings["update_beliefs"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                             bound_by="bytes", library_ms=None)
        del graph, means, cmg, st, args, got, again, ref
        torch.cuda.empty_cache()
    print(f"[beliefs] took {time.perf_counter() - t_phase:.1f} s")


def bench_layer_path(card):
    """Phase 32: the benchmark layer (`gbp_tpu_torch.bench`).  (a) `python
    -m gbp_tpu_torch.bench` in its own process: bench.py's six keys,
    469,861 factors, vs_baseline from the cached baseline, a finite
    wall-clock to 1.05x the MAP ARE and a captured rate above the eager one
    it logs.  (b) In this process, `headline.measure` on the bench scene:
    the captured 200 timed sweeps equal the eager 200 from the same state
    bit for bit, the ARE after 200 sweeps from the start within 1.05x the
    MAP ARE, reached at sweep 10 or one chunk from it; one replay of the
    5-sweep chunk against 5 eager sweeps by the profiler: the same kernels
    of the port, as often, in one graph launch; device ms and busy share
    per sweep, captured and eager.  (c) The four harnesses in this process:
    convergence, per_chip_rate, scaling (`--chips 1 2 4`, paths halo and
    halo_cm) and window_profile (fused and `--unfused`), at their defaults
    unless the argument lists below say otherwise."""
    t_phase = time.perf_counter()
    res, eager_cli = headline_cli(card)
    t_b = time.perf_counter()
    p = headline.problem(ba.simulate(**BENCH), "cuda")
    r = headline.measure(p)
    print(f"[bench] in process ({card}): captured {r.sweeps_per_s:.2f} sweeps/s, eager "
          f"{r.eager_sweeps_per_s:.2f} ({r.sweeps_per_s / r.eager_sweeps_per_s:.2f}x); "
          f"captured == eager bit for bit: {r.captured_equals_eager}; MAP ARE "
          f"{r.are_map_px:.6f} px, ARE after {len(r.ares) * headline.CHUNK} sweeps "
          f"{r.ares[-1]:.6f} (ratio {r.ares[-1] / r.are_map_px:.6f}); 1.05x MAP at sweep "
          f"{r.conv_sweeps} in {r.t_conv} s; ARE per chunk "
          + " ".join(f"{a:.4f}" for a in r.ares[:6]))
    if not r.captured_equals_eager:
        raise AssertionError("the captured 200 sweeps differ from the eager 200")
    if not r.ares[-1] <= 1.05 * r.are_map_px:
        raise AssertionError(f"ARE {r.ares[-1]} after 200 sweeps vs MAP {r.are_map_px}")
    if r.conv_sweeps not in (5, 10, 15):
        raise AssertionError(f"1.05x MAP reached at sweep {r.conv_sweeps}, not 10 +- 5")
    st = r.run.state
    own = lambda d: {k: v for k, v in d.items() if "gbp::" in k}
    for _ in range(3):  # the profiler may drop some of a window's device records
        cap, cap_launches, cap_ms = replay_records(r.run)
        eag, eag_launches, eag_ms = replay_records(
            lambda: sweep_cm.run(p.cmg, st, CFG, headline.CHUNK))
        if own(cap) == own(eag):
            break
    n = headline.CHUNK
    print(f"[bench] one replay of {n} sweeps: {sum(cap.values()) / n:.1f} device records and "
          f"{cap_launches / n:.2f} launch calls a sweep, {cap_ms / n:.4f} device ms a sweep, "
          f"busy {cap_ms / n * r.sweeps_per_s / 1e3:.3f}; eager {sum(eag.values()) / n:.1f} "
          f"records, {eag_launches / n:.1f} launch calls, {eag_ms / n:.4f} device ms, busy "
          f"{eag_ms / n * r.eager_sweeps_per_s / 1e3:.3f} ({card})")
    print(f"[bench] records a replay not in the eager sweeps: "
          f"{ {k: v for k, v in cap.items() if v != eag.get(k)} }")
    if own(cap) != own(eag) or cap_launches != 1:
        raise AssertionError(f"a replay launched {own(cap)} in {cap_launches} launch calls, "
                             f"5 eager sweeps {own(eag)}")
    del r, st
    torch.cuda.empty_cache()
    print(f"[bench] (b) took {time.perf_counter() - t_b:.1f} s")

    for module, argv in ((convergence, []), (per_chip_rate, []),
                         (scaling, ["--chips", "1", "2", "4"]),
                         (scaling, ["--chips", "1", "2", "4", "--path", "halo_cm"]),
                         (window_profile, []), (window_profile, ["--unfused"])):
        t0 = time.perf_counter()
        out = module.main(argv)
        print(f"[bench] {module.__name__.rsplit('.', 1)[-1]} {' '.join(argv)}: exit 0 in "
              f"{time.perf_counter() - t0:.1f} s")
        if module is convergence and not math.isfinite(out["gbp_seconds"]):
            raise AssertionError(f"convergence: not within tol of GN: {out}")
        if module is per_chip_rate:
            row = out["results"]["ba"]
            if not abs(row["are_halo_cm_px"] - row["are_plain_cm_px"]) <= 5e-3:
                raise AssertionError(f"per_chip_rate: one partition's ARE vs plain CM's: {row}")
        if module is scaling:
            bad = [row for row in out["results"] for k in ("raw_efficiency",
                   "collective_overhead_efficiency", "single_process_same_size_ratio")
                   if not math.isfinite(row[k])]
            if bad:
                raise AssertionError(f"scaling: a column is not finite: {bad}")
        if module is window_profile:
            for key, sc in out["scenes"].items():
                if not all(math.isfinite(sc[f"{s}_ms"]) for s in (
                        "full", "tabprep", "relin", "messages", "segsum", "other")):
                    raise AssertionError(f"window_profile {key}: {sc}")
        torch.cuda.empty_cache()
    print(f"[bench] phase 32 took {time.perf_counter() - t_phase:.1f} s")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    dev = gbp_tpu_torch.default_device()
    card = card_line()
    print(f"[device] {card}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    gbp_tpu_torch.set_exact_f32()

    t0 = time.perf_counter()
    _, compile_s = _build.build()
    _build.library()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {compile_s:.2f} s)")
    # One line per kernel instantiation of ptxas's report: mangled name (its
    # template arguments follow the kernel's name), registers, spilled bytes.
    for name, stores, loads, regs in re.findall(
            r"Compiling entry function '_ZN3gbp\d+([^']+)' for 'sm_90a'\n(?:.*\n)*?.*?(\d+) bytes "
            r"spill stores, (\d+) bytes spill loads\n.*?Used (\d+) registers",
            _build.ptxas_report()):
        print(f"[build] {regs:>3} registers, spills {stores}/{loads} bytes: {name[:60]}")

    timings, errs = {}, {}
    f64, f32 = torch.float64, torch.float32
    # (scene, build arguments, dtypes, widened window; the last dtype's run is
    # timed and kept for the JSON line when `keep`).  The widened runs stage
    # more than 48 KB per block (dynamic shared memory): 86,016 bytes at 256
    # cameras in float64, 64,512 at 384 in float32.
    city = ba.simulate_blocks(**CITY)
    checks = [
        ("8cam", ba.simulate(**SMALL), {}, (f64, f32), None, False),
        ("64cam", ba.simulate(**BENCH), {}, (f64, f32), None, True),
        ("280cam", ba.simulate_blocks(**BLOCKS7), BIG, (f64, f32), None, False),
        ("280cam wide", ba.simulate_blocks(**BLOCKS7), BIG, (f64,), 256, False),
        ("280cam no windows", ba.simulate_blocks(**BLOCKS7), BIG, (f32,), None, False),
        ("city wide", city, BIG, (f32,), 384, False),
        ("city", city, BIG, (f32,), None, True),
    ]
    for tag, sim, build_kw, dtypes, wide, keep in checks:
        prep_kw = dict(window=False) if tag.endswith("no windows") else None
        for dtype in dtypes:
            last = keep and dtype is dtypes[-1]
            e = check_kernels(tag, sim, dtype, dev, build_kw, timings if last else None, wide,
                              prep_kw)
            if last:
                errs.update(e)
        print(f"[kernels] {tag} done at {time.perf_counter() - T_START:.1f} s")
    check_scatter_dense(dev)
    window_vs_full()

    # Pose-graph shapes: (3, 3, 3) with per-row thresholds, (6, 6, 6).
    ptimes = {}
    m500, m1000 = (pose_graph.simulate_manhattan(**kw) for kw in (M500, M1000))
    m1500 = pose_graph.simulate_manhattan(**M1500)
    helix = pose_graph.simulate_helix(**HELIX)
    se2 = lambda sim: lambda dt, dv: pose_graph.build(sim, dtype=dt, layout="ell", device=dv)
    se3 = lambda dt, dv: pose_graph.build_g2o(helix, dtype=dt, layout="ell", device=dv)
    for tag, build, dtypes in (("manhattan500", se2(m500), (f64,)),
                               ("manhattan1000", se2(m1000), (f32,)),
                               ("manhattan1500", se2(m1500), (f64, f32)),
                               ("helix120", lambda dt, dv: pose_graph.build_g2o(
                                   pose_graph.simulate_helix(n_poses=120, seed=0), dtype=dt,
                                   layout="ell", device=dv), (f64,)),
                               ("helix250", se3, (f32,))):
        for dtype in dtypes:
            check_pose_kernels(tag, build, dtype, dev, ptimes)
    for name, by_shape in ptimes.items():
        print(f"[kernels] {name} at the pose-graph shapes, float32 ({card}): "
              + ", ".join(f"{shape} {ms:.4f} ms" for shape, ms in by_shape.items()))
    print(f"[kernels] pose shapes done at {time.perf_counter() - T_START:.1f} s")

    # The BAL models: per-row arguments at (6, 3, 2), the 9-dof camera.
    for intrinsics in (False, True):
        for dtype in (f64, f32):
            check_bal_kernels("ladybug49", intrinsics, dtype, dev)
    print(f"[kernels] BAL models done at {time.perf_counter() - T_START:.1f} s")

    # The row-major kernels on the generic engine's own operands, every shape.
    staged = {}
    for tag, build, cfg, dtypes in staged_scenes():
        for dtype in dtypes:
            check_staged_kernels(tag, build, cfg, dtype, staged)
    print(f"[staged] done at {time.perf_counter() - T_START:.1f} s: "
          + json.dumps({k: {n: v for n, v in r.items() if n != "info"}
                        for k, r in staged.items()}))

    launches = bench_path(card)
    unfused = unfused_path(card)
    city, city_fused = big_path("city", CITY, card, against_plain=True)
    city_unfused = unfused_big_path("city", CITY, card, city_fused)
    torch.cuda.empty_cache()
    venice, venice_fused = big_path("venice", VENICE, card, against_plain=False)
    if any(venice[k] != city[k] for k in WINDOWED):
        raise AssertionError(f"venice launches {venice} differ from the city's {city}")
    unfused_big_path("venice", VENICE, card, venice_fused)
    launches = {**{k: launches[k] for k in (*FULL, *BELIEFS)}, **{k: city[k] for k in WINDOWED},
                **{k: city_unfused[k] for k in (*UNFUSED_WIN, "segsum_cm_blk")}}
    torch.cuda.empty_cache()
    annealed_city(card)
    bal_path(card)

    # The halo paths' kernels against their plain versions, then the paths.
    other = {}
    for dtype in (f64, f32):
        hcm, st = halo_state(ba.simulate_blocks(**HALO_BLOCKS), dtype, 2, 8)
        check_halo_kernels("blocks1280 P=2", hcm, st, dtype, other)
    hcm, st = halo_state(ba.simulate_blocks(**CITY), f32, 2, 8)
    check_halo_kernels("city P=2", hcm, st, f32, errs, timings, masked=True)
    check_halo_kernels("city P=2 wide", halo_widened(hcm, 384), st, f32, other)
    del hcm, st
    torch.cuda.empty_cache()
    print(f"[halo kernels] done at {time.perf_counter() - T_START:.1f} s")
    halo_launches = halo_path(card, city_fused[0])
    launches.update({k: halo_launches["fused"][k] for k in HALO_KERNELS[:2]},
                    **{k: halo_launches["unfused"][k] for k in HALO_KERNELS[2:]})
    print(f"[halo] done at {time.perf_counter() - T_START:.1f} s")
    generic = generic_path(card)
    rows = rows_path(card)
    linear_path()
    pose_path(card)
    schedules_path(card)
    streaming_path(card)
    utilities_path(card)
    sfm_path(card)
    multiprocess_path(card)
    seg_path(card)
    ell_cameras_path(card)
    bench_layer_path(card)
    beliefs_path(card, timings, errs)
    launches.update({k: generic[k] for k in ROWS[2:]}, **{k: rows[k] for k in ROWS[:2]},
                    **{k: unfused[k] for k in (*UNFUSED, "segsum_by_id")})
    print(f"[done] {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE[name], "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": errs[name],
         "max_rel_err": REL_ERRS[name], **timings[name]}
        for name in M.KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
