#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`pillarnet_lts_torch`) on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each of which raises on failure:
  0. card name and power limit, torch and CUDA versions;
  1. build every CUDA kernel from `pillarnet_lts_torch/csrc/` (nvcc, sm_90a,
     one nvcc per source, all at once);
  2. the pillar scatter-max kernel (K1) against its plain version at the
     flagship shape (1 x 262,144 points x 32 channels -> 1440 x 1440), f32
     signed, f32 nonneg and int8 codes, and with every point in one pillar,
     bit-equal; each case timed with its wrapper, its kernels alone
     (`torch.profiler`), the plain version and `scatter_reduce_`;
  3. the rotated-overlap kernel (K2) against its plain version, bit-equal,
     at (6, 1000, 1000) NMS-like pairs, and replayed on the candidates that
     the served requests of phases 5 (f32 nuScenes, (6, 1000)) and 11
     (Waymo, (3, 2048)) handed it; each timed with its wrapper, its kernels
     alone (`torch.profiler`) and the plain version, with the share of
     pairs that `ops.iou3d.pairs_may_meet` lets through to the clip;
  4. the committed golden fixture (`tests/fixtures/golden_e2e_r3.npz`)
     replayed through the port with the fixture's own weights, within the
     tolerances of `tests/test_golden_e2e.py`;
  5. the flagship config `configs/pillarnet/pillarnet34_nusc.py` with seeded
     random weights, serving 3 warm-up + 10 timed requests at batch 1 and 2
     requests at batch 2 through `ServingPipeline(make_infer_fn(model))`,
     with both kernels' launch counters rising on every request; one more
     request under `torch.cuda.set_sync_debug_mode("error")` up to its
     host copy (no host sync inside a request);
  6. the int8 deploy config `configs/pillarnet/pillarnet34_nusc_int8.py`,
     seeded random weights, calibrated on 4 synthetic clouds (its heatmaps'
     distance from the bf16 forward is printed); one request served with
     the fused stage off, the arguments of its 51 int8 conv (K4) calls
     captured and each replayed through K4 and its plain version,
     bit-equal; per distinct shape the wrapper time, kernels alone
     (`torch.profiler`), plain, bound, the share of 8 x 16 tiles with an
     active site, and the cuDNN bf16 conv of that shape (a yardstick, not
     the same function); per-frame sums;
  7. the fused int8 stage kernel (K5, n = 7) on that request's stride-1
     stage (its input, mask and the model's stacked params), bit-equal to
     its plain version and to the per-conv route's output, timed beside the
     per-conv route over the same 7 convs;
  8. the int8 canary of tests/test_quant_int8.py:88-106 (its demo model at
     the int8 kernels' 32-channel widths: int8 head outputs within 0.2 of
     the bf16 ones); the int8 flagship serving 3 warm-up + 10 timed
     requests at batch 1 with the fused stage on (`s2d_pallas`) and off,
     every request raising the counters of the kernels of its path, and
     the two routes' detections identical on every cloud;
  9. the suppression-mask kernel (K3) against its plain version, bit-equal,
     at (6, 1000, 1000) pairs (threshold 0.2) and the Waymo grouped shape
     (3, 2048, 2048) (thresholds 0.8 / 0.55 / 0.55), its own corners
     bit-equal to `mask_kernel_corners`, timed as K2 in phase 3; its masks
     and keep
     sets against the default overlap-kernel route on the same candidates
     (`rotated_nms(use_mask_kernel=True)` vs `rotated_nms`,
     `_greedy_suppress_mask` vs `rotated_nms_dynamic`): a decision may
     differ only on a pair whose IoU lies within MASK_EPS of its threshold
     (each such pair is printed);
 10. the sorted-run scatter-max kernel (K1') against its plain version, the
     atomic one and `scatter_reduce_`, equal by value with identical
     occupancy, at the Waymo (1 x 196,608 x 32 -> 1504^2) and nuScenes
     shapes, in bf16 and int8 at the Waymo shape, and with every point in
     one pillar; timed as in phase 2;
 11. the Waymo config `configs/pillarnet/pillarnet34_waymo.py` (full width
     and depth, f32, per-class NMS), seeded random weights, serving 3
     warm-up + 10 timed requests at batch 1 on 196,608-point single-sweep
     clouds; every class fills NMS slots; one more request under
     `torch.cuda.set_sync_debug_mode("error")`;
 12. the same model with `ops.scatter.set_backend("tiled")`: detections
     identical to phase 11's on the same clouds; then also with
     `test_cfg.nms.use_mask_kernel`: detections equal to phase 11's except
     where the mask kernel decided a pair within MASK_EPS of its threshold
     otherwise (checked on the request's own candidates); K3 replayed on
     the last such request's candidates as in phase 9;
 13. training: the pillar ids of the 4 flagship calibration clouds and of
     every pillar edge +-1 ulp on the card equal to the CPU's (which the
     CPU tests hold equal to jitted JAX); (a) K1's gradient at the
     flagship shape with 300 points
     duplicated onto others, through the scatter op's registered autograd,
     bit-equal to the same backward over the plain version's grid and to
     the CPU, forward and backward timed; (b) one train step of the demo
     config on the card and on the CPU from the same weights and batch,
     within stated tolerances; (c) `pillarnet34_nusc` at full width
     (remat) trained by `apis.train_detector` at bs=4 on 4 synthetic
     scenes with every class, 2 + 4 timed steps: finite metrics, K1
     launched on every step, step time, samples/s, peak memory; (d) with
     deterministic cuDNN, the next step from the trained state and from
     its checkpoint resumed into a fresh model equal, its loss below the
     first step's;
 14. two-stage serving: `configs/pillarrcnn/pillarrcnn18_waymo.py` (full
     width and depth, f32), seeded random weights with the first stage's
     head spread, 3 warm-up + 10 timed requests at batch 1 on 196,608-point
     single-sweep clouds through `ServingPipeline(make_infer_fn(model))`:
     (a) K1 once and K2 once per task on every request (counts reset just
     before the run, read just after); (b) the RoIs the second stage pools
     are the detections `single_det` predicts on its own (labels, scores,
     RoI grids bit-equal); (c) boxes (1, 500, 7) finite, scores in [0, 1],
     labels {0, 1, 2}, kept boxes with positive dims; (d) one request under
     `set_sync_debug_mode("error")`; (e) the demo two-stage config on the
     card against the CPU from the same weights (RoI set, kept slots and
     labels equal; boxes within 1e-3 m, scores within 1e-4); (f) p50/p90,
     first- and second-stage device ms (CUDA events), kernel sums by group
     over 5 requests (`torch.profiler`), busy share, peak memory, and the
     second stage's kernels alone, every kernel and by group (the
     bilinear gather's `index_select`, the heads' GEMMs, the convs); K1
     replayed at the request's shape and K2 on both tasks' candidates as
     in phases 2-3.
 15. two-stage training: (a) the RoI sampler (`proposal_target_layer`)
     at the config's shape, 4 samples x 500 RoIs jittered from GT against
     500 GT rows (mostly padding) -> 128 slots, on the card under
     `set_sync_debug_mode("error")` with draws from a card generator: one
     K2 launch; the CPU's own IoU matrix within 1e-3 of the card's, and
     given the card's IoU the CPU's targets bit-equal from the same draws;
     every quota branch fires (fg below and above the quota, no background,
     hard background only); (c) one `pillarrcnn18_demo` step (dropout off,
     a fifth of the RoI slots near the GT, so fg RoIs are sampled) on the
     card and on the CPU from the same weights, batch and draws: sampled
     RoI labels and masks equal, RoIs within 1e-3 m, running statistics
     within 1e-4, metrics and parameters within twice the CPU's own
     spread from weights nudged by 1e-6 (measured in the run, every nudged
     run sampling the same RoI labels and masks; at least phase 13b's
     tolerances), the gradients' differences by module group reported;
     (d) `pillarrcnn18_waymo` at full width (remat, dropout 0.3) trained
     by `apis.train_detector` at bs=4 on 4 synthetic 196,608-point scenes
     with every class, 2 + 4 timed steps (counts reset just before):
     finite metrics with the RCNN and point losses, K1 and K2 (in predict
     and in the sampler) launched on every step, the sampled fg RoIs per
     step, step time, samples/s, peak memory; (e) under deterministic
     algorithms, the next step of the run equal to the same step from its
     checkpoint in a fresh model; one more step split into forward /
     backward / optimizer (CUDA events); (b) every kernel call of step (e)
     replayed against its plain version: K1 at bs=4 as phase 2, K2's two
     predict calls and the sampler's (4, 500, 500) call as phase 3, the
     sampler's again with 100 RoI rows of each sample zeroed; (f) (d)
     again with 100 of each sample's RoI slots near its GT, as a trained
     first stage's proposals are: fg RoIs and a nonzero regression loss
     on every step, its last sampler K2 call replayed;
 16. evaluation through `python -m pillarnet_lts_torch.tools.dist_test`'s
     main, seeded random weights with the heads spread on the first cloud
     saved as a port checkpoint (`spread_checkpoint`, `--checkpoint`),
     each run with the launch counts reset just before: (a) 8 frames of a
     nuScenes-layout val set written to a temporary directory (a keyframe
     and 9 sweep `.bin`s of 26,215 points each, 4 x 4 sweep transforms, GT
     from the demo scenes), listed 12 times (96 frames) so that a pass
     outlasts its warm-up, through `pillarnet34_nusc` at full width:
     `--speed_test` (batch 1, middle-third ms on the host clock and on
     CUDA events) and the pipelined default (batch 4, frames/s with the
     loader over the pass and over its middle third of batches), K1 and K2
     once a request, every K1 and K2 call of the pipelined pass replayed
     against its plain version (bit-equal, timed as phases 2 and 3), the
     two passes' detections bit-equal, mAP / NDS printed, GT as detections
     mAP 1, the card's ms a frame at batch 4 and the loader's alone in 3
     passes; (b) 4 Waymo-layout frames (196,608 points, 26 / 12 / 1 GT
     boxes a frame) through `pillarnet34_waymo`: every K2 call of the
     Waymo evaluator captured and replayed, the card's metrics equal to
     the CPU evaluator's on the same detections, GT as detections AP 1;
     (c) `pillarnet34_nusc` with double-flip TTA over 24 frames (4 clouds
     a frame, one detection set a frame), its K1 and K2 calls replayed,
     and the demo config with double-flip on the card against the CPU
     from one checkpoint (phase 14e's tolerances); (d) the demo
     `Trainer.run([('train', 1), ('val', 1)])` on the card logging what
     `dist_test` gives on its checkpoint; (e) `--int8` over one batch of 4
     of (a)'s frames, its K1, K2 and 51 K4 calls replayed (K4 as phase 6).
 17. training as the configs write it: (a) `pillarrcnn18_waymo` at full
     width and depth (bs=4, remat, dropout 0.3) with its train pipeline as
     written (GT-AUG sampling 15 / 10 / 10 VEHICLE / PEDESTRIAN / CYCLIST
     objects, flips, global rotation, scaling and translation, shuffle)
     over 16 Waymo-layout frames of 196,608 points (GT boxes a frame from
     4 / 2 / 0 to 48 / 22 / 2, 26 / 12 / 1 on average, so that sparse
     frames get vehicles and pedestrians pasted) written under a temporary
     directory laid out as the config's `data_root`, with the GT database
     the port builds there (`datasets/utils/create_gt_database.py`) at the
     config's `db_info_path`: the loader alone (ms a sample on one thread,
     also split by whether GT-AUG pasted vehicles or pedestrians, and on
     the config's threads; GT-AUG boxes a class and points pasted a
     sample, points past `max_points`), then one epoch (4 steps) through
     `apis.train_detector` with the launch counts set to 0 just before:
     K1 and K2 (predict and sampler) on every step, step ms (median after
     the first), samples/s, peak memory, the last step's K1 and K2 calls
     replayed bit-equal against their plain versions and timed as phases
     2 and 3; (b) `python -m pillarnet_lts_torch.tools.train` on the demo
     config in a subprocess on the card: exit 0, finite loss, a checkpoint.
 18. the two-stage model in the precisions users serve and the rest of the
     zoo: (a) `pillarrcnn18_waymo` after `enable_backbone_quant` (f32
     compute, the int8 build) at full width, calibrated on 4 clouds, and
     (b) `pillarrcnn18_waymo_bf16`, each serving 3 warm-up + 10 timed
     requests at bs=1 and 1 warm-up + 2 timed at bs=4 (196,608-point
     clouds) with the launch counts set to 0 just before: every request
     launches K1 once, K2 once per task and (a) K4's f32 variant once per
     quantized conv (41), and nothing else; p50 / p90, frames/s at bs=4, peak memory; one request
     under sync debug mode; one request's K1 and K2 calls, and (a) its 41
     K4 calls, replayed bit-equal (K4 per shape: wrapper, kernels alone,
     plain, bound, the cuDNN f32 conv of the shape as a yardstick and the
     bf16 variant on the same calls cast to bf16); the stage split, kernel
     groups and busy share as phase 14f; (c) `dist_test --int8` on the f32
     `pillarnet34_waymo` over 4 Waymo-layout frames (the int8 convs on
     K4's f32 variant, each call equal to its plain version, finite
     detections); (d) `twostage18_demo`, `voxelnet18_demo` and
     `pillarnet18_demo` with circular NMS on the card against the CPU
     (phase 14e's tolerances); phase 18's wall seconds.
 19. data-parallel training and sharded evaluation
     (`pillarnet_lts_torch/parallel/`; cut in depth to keep the whole run
     inside its time: 19a/b one step from one state and one nudged
     one-process step, 19c 8 written frames, 2 steps). NCCL refuses two ranks on one
     card, so the two-rank runs are two gloo ranks that share card 0
     (CUDA tensors on both, the backend passed explicitly, `LOCAL_RANK`
     0 on both), spawned with torchrun's environment (`spawn_ranks`, a
     join timeout; each rank's group start and collectives time out on
     their own); the smoke
     process frees its cached memory before they start. (a)
     `pillarnet34_nusc` at full width, 13c's global batch of 4 as 2 a
     rank through `apis.train_detector` (`--dp-rank`), 2 steps, against
     the one-process bs=4 step on the ranks' rows in rank order from the state
     each step started from, computed in the ranks' order (`dp_reference`,
     `in_rank_order`: convs, matmuls and BN sums on each rank's rows apart;
     `check_dp_training`): the ranks' parameters and BN buffers bit-identical
     to one another; the metrics (losses 1e-5 relative, `grad_norm` 1e-3;
     against the plain one-process step losses 1e-4; read also against the step
     with only its convs and matmuls so), the parameters (two Adam steps, at
     most 0.5% beyond 1e-4), the running statistics (1e-4) and the gradients by
     module group (1e-3), each also within twice the one process's own spread
     under a 1e-6 weight nudge (phase 15c's measure), a group's gradients never
     beyond DP_GRAD_CAP (0.1); K1 once a step a rank, and each rank's last-step
     K1 calls replayed bit-equal and timed as phase 2, one rank
     after the other; step ms and peak memory per rank; (b) the same for
     `pillarrcnn18_waymo` (15d's batch of 4, dropout 0.3), its RoI
     sampler given boxes about each sample's GT drawn for the global batch
     (`proposals_at_gt`: the first stage's own proposals can differ where
     a rounding tips its NMS at a near tie), with dropout's draws and the
     sampler's draws, proposals and targets bit-equal to the one-process
     rows, K2 three times a step a rank (predict's two, the sampler's)
     and its calls replayed as phase 3; (c) `torchrun
     --nproc_per_node 1` (NCCL, a real group of one) runs `tools.train
     --validate` on 17a's written frames (one loader thread), and the
     same CLI without torchrun, both under deterministic algorithms
     (`--cli-rank`): the checkpoints bit-equal; (d) `tools.dist_test`
     over 2 gloo ranks (torchrun, `cli_rank --share-card`) at the one-process
     run's batch size on 16a's 8 written frames through
     `pillarnet34_nusc`: the merged detections bit-equal to the
     one-process run's (or within phase 14e's tolerances); every K1 and
     K2 call of 19c and 19d held bit-equal to its plain version; phase
     19's wall seconds.
 20. the compact sparse path (`reader.compact_kmax`: conv1 and conv2 as
     gather convs over the active sites, `ops/compact.py`,
     `models/backbones/compact_exec.py`), each compact model with the
     weights of its dense twin; every cloud's active sites (k_valid) and
     the sites the reader's and the default coarse budget drop, as the
     modules count them (`dropped_sites`, `dropped_coarse_sites`), are
     printed, and where the coarse budget drops sites, `compact_kmax2` is
     set explicitly (a truncated table makes compact and dense differ, as
     in the JAX package), and the served run's last request must drop
     none: (a) `pillarnet34_nusc` with `compact_kmax` =
     262,144 (its `max_points`) serving 3 warm-up + 10 timed requests at
     bs=1 and 2 at bs=2 through `ServingPipeline(make_infer_fn(model))`,
     the launch counts set to 0 just before and read just after: every
     request launches K2 as the dense twin's does and nothing else (no
     K1), every K2 call replayed bit-equal against its plain version; the
     detections against the dense twin's on the same clouds (kept slots
     identical, each kept box matched to a dense box of its label by
     centre, boxes within 5e-3 m and scores within 1e-3,
     `tests/test_compact_backbone.py:164-172`, or twice the dense route's
     own difference under a 1e-6 weight nudge where that is larger: a
     random-weight box dimension is exp of a head output); p50 / p90 and
     peak memory
     of both routes; the first cloud's compact tables (site ids, k_valid,
     the SubM, strided and coarse tables, the coarse sites, the densified
     occupancy) bit-equal card vs CPU, and its segment-max rows of the
     same features; one request under `set_sync_debug_mode("error")`;
     (b) conv1 + conv2 (`PillarResNet.conv12`) of both routes on 3 clouds
     in f32 and in bf16: device ms from `torch.profiler` kernel sums, the
     compact route split into table building, gathers, matmuls, densify
     and the rest, each reader alone, MACs, serial p50, peak memory above
     the input; (c) `pillarnet34_nusc_bf16` with the compact reader,
     4 requests: launches and K2 replays as (a), every head map within
     max(5e-2, the port's bf16 bound, and twice the dense twin's own bf16
     error against the f32 model of the same weights) of its max |value|
     of the dense twin's, the kept boxes matched to the dense twin's by
     label and centre and reported; (d) `pillarrcnn18_waymo` with
     `compact_kmax` = 196,608, 4 requests as (a), detections as (a);
     (e) two training steps of (a)'s model at bs=4 on 13c's batch against
     the dense route from the same state (losses and gradients by group
     within phase 19's bounds from the dense step's own 1e-6 nudge
     spread), no kernel launched on the compact step, step ms and peak
     memory of both routes; phase 20's wall seconds;
 21. the serving export (`runtime/export.py`): (a) f32 `pillarnet34_nusc`
     at batch 1 (phase 5's seeded weights), (b) `pillarnet34_nusc_int8` at
     batch 8 (the JAX package's recommended deploy; calibrated on 4
     clouds, fused stage off) and (c) f32 `pillarrcnn18_waymo` at batch 1,
     each served eager (`make_infer_fn`), then traced on the card
     (`export_serving`, timed; its graph holds the `pillarnet.*` kernel
     ops and no data pointer), saved, and loaded in a fresh process
     (`--serve-artifact SPEC`) that imports torch and
     `pillarnet_lts_torch.ops.library` only (no `models/`, `apis` or JAX in
     `sys.modules`): 2 warm-up + 10 timed requests on the same clouds as
     eager, detections bit-equal to eager's, every kernel's launches a
     request equal to eager's; one more request of the program captured
     through a `TorchDispatchMode` and its K1 and K2 calls replayed against
     their plain versions and timed as phases 2-3, its K4 calls (21b)
     held bit-equal and timed as they run (wrapper, plain, bound; each
     shape's first call alone), summed per request; p50 latency (21a, 21c) or frames/s (21b)
     eager vs program, host-synced, the export seconds and the program's
     MB; `{"export": ...}` is printed before the kernels' line, whose K1,
     K2 and K4 rows carry phase 21's launches a request and replays under
     `export`.
 22. dataset preparation -> training -> evaluation on the card machine
     without JAX or a devkit (`data_prep_chain`): the host C++ library
     (`pillarnet_lts_torch/native`, built in step 1; a failed build fails
     the run with the compiler's stderr); (a) 8 train and 4 val raw Waymo
     frames of 196,608 points in the converter's layout
     (`datasets/synth.py::write_waymo_raw`), then `python -m
     pillarnet_lts_torch.tools.create_data waymo_data_prep` over both
     splits on the native route and on the numpy route (`--data-prep-numpy
     ARGS`, the library's box functions returning None), each timed;
     (b) the training CLI's main (`tools/train.py`) on `pillarrcnn18_waymo`
     at full width over the prepared infos, 2 steps at bs 2, its GT-AUG
     reading the database (22a) at `dbinfos_train_1sweeps.pkl`, the name
     `create_data` writes; K1 and K2 counted (set to 0 just before, read
     just after) and every call replayed against its plain version;
     (c) `dist_test`'s main on that checkpoint over the 4 val frames, the
     native Waymo evaluator; `{"data_prep": ...}` is printed before the
     kernels' line, whose K1 and K2 rows carry (b)'s launches and replays
     and (c)'s launches under `data_prep_chain`. The training loader's ms
     a sample on each route is phase 17a's (its passes on 8 threads, the
     routes in turns, each beside the host's load average).

 23. the two-stage remainder (`two_stage_remainder`): (a) bf16 training:
     `pillarnet34_nusc_bf16` and `pillarrcnn18_waymo_bf16` as written at
     full width, bs=4, 3 steps each (the first untimed; the two-stage
     config with 100 RoI slots a sample near the GT): every loss finite,
     the parameters f32, step ms, samples/s and peak memory beside the f32
     twins of 13c and 15d, the launch counts set to 0 just before and read
     just after, every K1 and K2 call replayed against its plain version;
     one step of the bf16 `pillarrcnn18_demo` on the card and on the CPU,
     the card held to twice the CPU's own spread under a one-ulp bf16
     nudge of the weights;
     (b) `pillarrcnn18_waymo` in f32 with each second-stage variant
     (`rcnn_variant`: `RoIMIXHead` with `MLPMixer` or `ResMLP`,
     `RoIFFNHead` with its IoU branch at the JAX defaults, the point
     head's `ATT_MODEL`): 6 requests at bs=1 (p50, the second stage's
     device ms), K1 and K2 counted per request; 2 training steps at bs=4
     with the IoU (or point) loss positive and finite, the last step's K1
     and K2 calls replayed; the demo with the variant, one step on the
     card against the CPU as 15c; (c) K5 on f32 activations: 18a's build
     with `backbone.s2d_pallas`, 6 requests on the per-conv route and on
     the fused one, detections bit-equal, p50 of each; every K5 f32 call
     of the fused route (counts set to 0 just before) replayed bit-equal,
     the first timed with its bound; K5 f32 and bf16 timed on one
     synthetic 1 x 1440^2 x 32 stage (n = 7, ~7.7% of the sites active in
     8 x 8 clusters); `{"two_stage_remainder": ...}` is printed before
     the kernels' line, which gains the `int8_stage_f32` row and K1's and
     K2's rows phase 23's launches and replays under
     `two_stage_remainder`.
 24. the model remainder (`model_remainder`); each served run of 6
     requests at bs=1 (the first 2 untimed) with the launch counts set
     to 0 just before and read just after: (a) `pillarnet34_nusc_int8`
     with `bbox_head.quant=True` (`enable_backbone_quant(head=True)`,
     bf16, fused stage off), calibrated on 4 clouds: every request
     launches K1, K2, K4 per tensor once per quantized conv (52: the
     backbone, the neck and the shared conv) and K4's per-channel variant
     (`int8_conv_pc`) once per task (6: each SepHead's wide conv, 1 x
     180^2 x 64 -> 384); one request's 58 K4 calls held bit-equal to
     their plain versions, the shared conv's and the wide convs' timed as
     phase 6 times K4 (wrapper, alone, plain, bound, cuDNN yardstick);
     the heatmaps' error against the f32 model of the same weights beside
     the backbone-only int8 build's (a reading: the JAX package measured
     the int8 head as an mAP collapse); then at batch 8 as a `.pt2`
     program against eager (`export_cell`, as 21b); (b) 18a's build
     (`pillarrcnn18_waymo`, f32) with the head quantized: K4's f32
     variant per tensor and its per-channel f32 variant
     (`int8_conv_pc_f32`) once per task, every call held bit-equal, the
     wide convs timed; (c) `pillarnet34_waymo` and `pillarnet34_nusc`,
     f32, with `test_cfg.nms.approx_topk` on, with and without
     `use_mask_kernel`: detections on 2 clouds bit-equal to approx_topk
     off; each NMS's `greedy_suppress_with_convergence` flags printed;
     (d) `pillarnet34_nusc` with every common head at 1 and at 3 convs:
     served (K1, K2), one bs=2 training step (finite, a gradient on every
     new conv kernel), the demo config at the same depth one step card vs
     CPU as 13b; (e) the legacy `RPN` on `pillarnet34_nusc`'s backbone
     with CenterPoint's PointPillars neck widths: `neck=dict(type="RPN",
     layer_nums=[3, 5, 5], ds_layer_strides=[1, 2, 1], ds_num_filters=
     [64, 128, 256], us_layer_strides=[2, 4, 4], us_num_filters=[128, 128,
     128], in_channels=256)` and `bbox_head.in_channels=[384]` (conv5 at
     stride 16 up to the head's stride 8), served in f32 and in int8 (the
     same weights, `enable_backbone_quant`: its 13 units on K4's f32
     variant), every K4 call of one request held bit-equal;
     `{"model_remainder": ...}` is printed before the kernels' line, which
     gains the `int8_conv_pc` (24a, with its program's calls under
     `export_bs8`) and `int8_conv_pc_f32` (24b) rows, and every row phase
     24's launches under `model_remainder_launches`.
 25. spatial (BEV-grid) sharding (`spatial_sharding`;
     `parallel/spatial.py`, `models/backbones/band_exec.py`): 2 gloo
     ranks that share card 0 (`--spatial-rank SPEC`), each holding the
     whole model and the same points, the stride-1 stage and conv2 on its
     band of grid rows with halo rows from the other, conv2 gathered,
     the rest replicated; against one process on the same card: (a) f32
     `pillarnet34_nusc` at full width, 3 requests at bs 1 (the first
     untimed), detections within phase 14e's tolerances; (b)
     `pillarnet34_nusc_int8` (bf16, every conv1 / conv2 K4 call on a
     band), calibrated by the ranks under the group (their scales beside
     one process's), then served on one process's scales: the gathered
     conv2 map and the detections bit-equal; (c) one bs-2 training step
     of `pillarnet34_nusc` (remat): the ranks identical, every loss within
     1e-5, the gradients by module group within phase 19's bound (from one
     nudged one-process step), the running statistics within 1e-4, the
     summed gradients exactly the reader's, conv1's and conv2's, the
     summing norms exactly the sharded stages'; (d) a group of one under
     NCCL (`torchrun --nproc_per_node 1`: the gather's all_reduce on
     NCCL) serving (a)'s requests bit-equal to one process, and with two
     or more cards (a)-(c) with one NCCL rank a card; (e) the box ops
     (`ops.roiaware_pool3d`, `points_in_boxes_*`, `points_in_rbbox_device`)
     card vs CPU. Every K1, K2 and K4 call of the ranks' timed requests and
     step is held to its plain version; the request wall ms of each rank
     and of one process, the all_reduce calls a request and the phase's
     seconds are printed; `{"spatial": ...}` follows
     `{"model_remainder": ...}`, and K1's, K2's and K4's rows carry the
     ranks' launches and replays under `spatial`.

Every kernel's record carries its bound: the least time the card could
take for the same work on this run's inputs, the larger of the bytes it
must move (each input read once, each output written once; of the int8
convs' x and residual, only what the active output sites need) at 3.35 TB/s
and the operations it must do at the peak rate of their type (f32 67
TFLOP/s, int8 1,979 TOP/s), and the time of one PyTorch call that computes
the same function where there is one (`library_ms`, else null). K2's and
K3's operations are those of their near pairs (what `pairs_may_meet` lets
through) plus the separation test on every pair they test; the old count
(every pair clipped) is printed beside it.

Every `torch.profiler` number comes from `profiled`, which retakes a
session that lost device events (PROFILE_TRIES sessions at most) and
keeps the one that lost the fewest; a `[profiler]` line counts the
sessions. A pass's replayed K1 / K2 calls are each held bit-equal to the
plain version, and the first REPLAY_TIMED of them timed. Before the last three lines stdout
carries phase 13's, 14's, 15's, 16's, 17's, 18's and 19's JSON records
(`{"training": ...}`, `{"two_stage": ...}`, `{"two_stage_training": ...}`,
`{"eval": ...}`, `{"training_as_written": ...}`, `{"precisions": ...}`,
`{"data_parallel": ...}`) and phase 20's (`{"compact": ...}`), 21's
(`{"export": ...}`), 22's (`{"data_prep": ...}`) and 23's
(`{"two_stage_remainder": ...}`), 24's (`{"model_remainder": ...}`) and
25's (`{"spatial": ...}`);
then the kernels' JSON record (K1's and K2's rows also carry
`two_stage_launches`, under `two_stage_train` phase 15's launches and
replays, `eval_launches`, phase 16a's pipelined pass, under
`augmented_train` phase 17a's launches and replays, and under
`precision_launches` / `precision_replays` phase 18a's and 18b's; K1's,
K2's and K4's rows `eval_replays`, phase 16's replays by pass; K4's f32
variant, `int8_conv_f32`, has a row of its own from phase 18a; K1's and
K2's rows carry phase 19's launches per rank and replays under
`data_parallel`; K2's row phase 20's launches and replays under
`compact`, K1's `compact_launches`, 0 on every compact path,
phase 21's under `export` and phase 22's under `data_prep_chain`), the
card's
`nvidia-smi` name and power
limit, and the last line `{"ok": true, "device": {...}}`. Without a CUDA
device, or outside the repository, it exits non-zero and prints no result.
No JAX is imported. `--dp-rank SPEC` and `--cli-rank OUT TOOL ARGS` are
phase 19's rank processes, `--spatial-rank SPEC` phase 25's
(`--spatial-cards`: phase 25a-c alone, one NCCL rank a card over every
card of the machine), `--serve-artifact SPEC` phase 21's program
server, `--data-prep-numpy ARGS` phase 22's numpy-route `create_data`,
which the smoke starts itself. `--loader-compare PARENT` times phase
17a's loader passes with this checkout and with the one at PARENT, in
turns, on the host alone (`--loader-passes TREE TMP ROUTE...`, one
process's passes). `--k4-compare PARENT` holds K4 per tensor built from
the checkout at PARENT against this one's on the int8 flagship's calls at
bs 1 and 8 (outputs byte-identical, times in turns).
"""

import contextlib
import json
import math
import os
import pickle
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(ROOT, "configs", "pillarnet", "pillarnet34_nusc.py")
FLAGSHIP_INT8 = FLAGSHIP.replace(".py", "_int8.py")
DEMO = os.path.join(ROOT, "configs", "demo", "pillarnet18_demo.py")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "golden_e2e_r3.npz")
WAYMO = os.path.join(ROOT, "configs", "pillarnet", "pillarnet34_waymo.py")
RCNN = os.path.join(ROOT, "configs", "pillarrcnn", "pillarrcnn18_waymo.py")
RCNN_DEMO = os.path.join(ROOT, "configs", "demo", "pillarrcnn18_demo.py")

N_POINTS = 262144
NMS_TASKS, NMS_K = 6, 1000
TIMING_ITERS = 20
PROFILE_TRIES = 3  # profiled: sessions taken before the best is kept
REPLAY_TIMED = 4  # replays of a pass timed (every call held bit-equal)
PROFILE_LOST = 0.01  # device_ms: the share of lost events it accepts
PRIMER = "spin_kernel"  # torch.cuda._sleep's kernel, which pads a session
PRIMERS = 8  # profiled: primer kernels before fn's and after them
LAUNCH_CALLS = ("LaunchKernel", "cuLaunch", "Memset", "Memcpy")
PROFILE_STATS = {"sessions": 0, "retaken": 0, "lossy": 0,
                 "cuda_events": 0}
PLAIN_ITERS = 3  # the int8 plain versions sum in float64: slow
F32_PATH = {"pillar_scatter_max", "rotated_overlap"}  # kernels of phase 5
HM_REL_BOUND = 0.2  # int8 vs bf16 heads, tests/test_quant_int8.py:88-106
WAYMO_K, WAYMO_THRESH = 2048, (0.8, 0.55, 0.55)  # the grouped per-class NMS
# the mask kernel's IoU (shoelace areas) and the default route's (w * l
# areas) may decide a pair differently only this close to its threshold
MASK_EPS = 1e-4
# phase 14e: the demo two-stage detections on the card against the CPU
# (the golden replay's tolerances, `tests/test_golden_e2e.py`)
RCNN_BOX_TOL, RCNN_SCORE_TOL = 1e-3, 1e-4
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, f32 (no tensor
# cores) and int8 (tensor cores, dense) operations/s
HBM_BPS, F32_OPS, INT8_OPS = 3.35e12, 67e12, 1979e12
# f32 operations of one box pair: the overlap kernel (two one-sided clips,
# the B+ scaling, two shoelaces) and the mask kernel (eight clipped edges
# of 71 ops, the IoU), counted from the sources; and the separation test
# of `csrc/rotated_pairs.cuh::may_meet` that every tested pair costs
OVERLAP_PAIR_OPS, MASK_PAIR_OPS, CULL_PAIR_OPS = 610, 575, 9


def golden_model_cfg():
    """Copy of `tools/make_golden_fixture_e2e.py::model_cfg` (that module
    imports JAX); `tests/test_torch_port_e2e.py` pins the two equal."""
    tasks = [
        dict(stride=4, class_names=["car"]),
        dict(stride=4, class_names=["pedestrian", "cyclist"]),
    ]
    pc_range = [-16.0, -16.0, -4.0, 16.0, 16.0, 2.0]
    pillar = 0.25  # 128 x 128 grid
    return dict(
        type="PillarNet",
        reader=dict(
            type="DynamicPFE", in_channels=5, num_filters=(8,),
            pillar_size=pillar, pc_range=pc_range,
        ),
        backbone=dict(type="PillarResNet18S", in_channels=8),
        neck=dict(
            type="RPNV2", layer_nums=[2, 2], num_filters=32,
            in_channels=[32, 64],
        ),
        bbox_head=dict(
            type="CenterHead",
            tasks=tasks,
            in_channels=[32],
            code_weights=[1.0] * 8 + [0.2, 0.2],
            common_heads={
                "reg": (2, 2), "height": (1, 2), "dim": (3, 2),
                "rot": (2, 2), "iou": (1, 2),
            },
            reg_iou="GIoU",
            pillar_size=pillar,
            point_cloud_range=pc_range,
        ),
    ), dict(
        nms=dict(
            use_rotate_nms=True, nms_pre_max_size=256,
            nms_post_max_size=64, nms_iou_threshold=0.2,
        ),
        rectifier=0.5,
        score_threshold=0.05,
        post_center_limit_range=[-20.0, -20.0, -6.0, 20.0, 20.0, 4.0],
    )


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=TIMING_ITERS, warmup=3):
    """Mean device time of fn() over `iters` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes, ops, peak):
    """(bound_ms, bound_by): the larger of `n_bytes` at the HBM rate and
    `ops` at `peak` operations/s."""
    t_bytes, t_ops = n_bytes / HBM_BPS * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scatter_library(torch, x, ids, valid, hw):
    """The one-call yardstick of a scatter-max: `scatter_reduce_(amax,
    include_self=False)` into a zeroed grid with a spare row for dropped
    points; returns a callable of no arguments and the index it uses."""
    B, N, C = x.shape
    idx = torch.where(valid, ids, hw).long()[..., None].expand(B, N, C)

    def call():
        grid = torch.zeros((B, hw + 1, C), dtype=x.dtype, device=x.device)
        return grid.scatter_reduce_(1, idx, x, reduce="amax",
                                    include_self=False)
    return call


def profiled(fn):
    """Run fn() under `torch.profiler` (CPU and CUDA activities) and
    return (rows, fn's result, lost): the device rows of `kernel_table`
    and the share of the session's device events that the profiler lost.

    On the H100 a profiler session now and then loses device events: at
    times all of them, and late in a long run two or three in nearly
    every session, whatever its size. Each session therefore wraps fn()
    in PRIMERS primer kernels (`torch.cuda._sleep`, left out of the rows)
    on each side, and one that holds fewer of fn's device events than fn's
    launch calls (kernel launches, memsets and memcpys of the runtime and
    driver APIs) is taken again, PROFILE_TRIES sessions in all; the one
    that lost the fewest is returned. PROFILE_STATS counts the sessions."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    best = None
    for _ in range(PROFILE_TRIES):
        with torch.profiler.profile(activities=acts) as prof:
            prime(torch)
            out = fn()
            torch.cuda.synchronize()
            prime(torch)
        events = prof.key_averages()
        primed = device_events(e for e in events if PRIMER in e.key)
        calls = launch_calls(events) - 2 * PRIMERS
        lost = max(calls - device_events(events) + primed, 0)
        PROFILE_STATS["sessions"] += 1
        if best is None or lost < best[0]:
            best = (lost, calls, primed, events, out)
        if not lost:
            break
        PROFILE_STATS["retaken"] += 1
    lost, calls, primed, events, out = best
    if lost:
        PROFILE_STATS["lossy"] += 1
        print(f"[profiler] kept a session that lost {lost} of {calls} "
              f"device events ({primed} of {2 * PRIMERS} primer kernels "
              f"kept)")
    return kernel_table(events), out, lost / max(calls, 1)


def prime(torch):
    for _ in range(PRIMERS):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def device_events(events):
    from torch.autograd import DeviceType

    return sum(e.count for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False))


def launch_calls(events):
    from torch.autograd import DeviceType

    return sum(e.count for e in events if e.device_type == DeviceType.CPU
               and any(k in e.key for k in LAUNCH_CALLS))


def device_ms(fn, iters=10):
    """Mean device time of the kernels and memsets that one fn() call
    launches (`profiled`'s sums over `iters` calls): the call's kernels
    alone, without the host's launch gaps. Returns it and the per-kernel
    means, longest first. Where every session lost more than PROFILE_LOST
    of its device events, the time is the CUDA events' (`cuda_ms`, launch
    gaps included) and the one per-kernel entry says so."""
    import torch

    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(iters):
            fn()

    rows, _, lost = profiled(calls)
    if lost > PROFILE_LOST:
        PROFILE_STATS["cuda_events"] += 1
        ms = cuda_ms(fn, iters=iters)
        return ms, [(ms, "CUDA events (the profiler lost device events)")]
    per = sorted(((ms / iters, k) for k, ms, _ in rows), reverse=True)
    return sum(ms for ms, _ in per), per


# kernel groups of a `torch.profiler` window (`kernel_table`): the port's
# kernels by name; the two scatter-max kernels share the streaming pass of
# `csrc/pillar_grid.cuh` (`pillar_grid_fill_kernel`), told apart by its tag
# (`SortedRuns` for K1', `ClaimedPillars` for K1); their head-map memsets
# fall under "other", the sort of K1' under its cub kernels. The second
# stage's bilinear gather is `index_select`'s row gather
# (`vectorized_gather_kernel`; `indexSelect*` kernels on other PyTorch
# versions); `torch.gather` elsewhere is an elementwise kernel. cuDNN's
# convs (implicit-GEMM, FFT with its complex `cf32` GEMMs, the transposed
# convs' `dgrad`) are told from cuBLAS's f32 GEMMs and GEMVs (the RoI and
# point heads' Dense layers) by name, the convs first.
GROUPS = (("K1' pillar_scatter_max_tiled", ("scatter_max_sorted",
                                            "SortedRuns")),
          ("K1 pillar_scatter_max", ("scatter_max_claim", "scatter_max_merge",
                                     "ClaimedPillars")),
          ("K2 rotated_overlap", ("rotated_overlap",)),
          ("K3 suppression_mask", ("suppression_mask",)),
          ("K4 int8_conv", ("int8_conv_kernel",)),
          ("K5 int8_stage", ("int8_stage_kernel",)),
          ("index_select", ("indexSelect", "vectorized_gather")),
          ("conv", ("conv", "implicit_gemm", "cudnn", "winograd", "fft",
                    "cf32", "dgrad", "wgrad", "fprop")),
          ("gemm", ("gemm", "gemv")),
          ("transpose", ("nchwToNhwc", "nhwcToNchw", "transpose")),
          ("elementwise", ("elementwise", "vectorized", "reduce")))


def kernel_table(events):
    """(kernel name, ms, count) rows of a profile's device kernels
    (`key_averages()`), longest first, without `profiled`'s primer."""
    from torch.autograd import DeviceType

    rows = []
    for e in events:
        # a user range (the optimizer's `step`) spans kernels counted alone
        if (e.device_type != DeviceType.CUDA or PRIMER in e.key
                or getattr(e, "is_user_annotation", False)):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((e.key, us / 1e3, e.count))
    return sorted(rows, key=lambda r: -r[1])


def group_of(kernel):
    low = kernel.lower()
    for g, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return g
    return "other"


def group_table(rows):
    groups = {}
    for k, ms, _ in rows:
        g = group_of(k)
        groups[g] = groups.get(g, 0.0) + ms
    return groups


def check_scatter_equal(torch, tag, got, want, by_value=False):
    """Identical occupancy; the grid bit-equal, or equal by value (-0.0 and
    +0.0 may trade places). Returns the grid's max |got - want|."""
    (grid, occ), (g2, o2) = got, want
    err = (grid.float() - g2.float()).abs().max().item()
    same = bool((grid == g2).all()) if by_value else torch.equal(grid, g2)
    if not (same and grid.dtype == g2.dtype and torch.equal(occ, o2)):
        raise AssertionError(f"{tag}: max |d| {err}, occupancy mismatches "
                             f"{int((occ != o2).sum())}")
    return err


def scatter_times(torch, tag, call, plain, x, ids, valid, out, peak,
                  iters=TIMING_ITERS):
    """Phase 2 and 10 timings of one scatter-max case: the wrapper (CUDA
    events), its kernels alone (profiler), the plain version, the one-call
    `scatter_reduce_` yardstick and the bound; printed (unless `tag` is
    None) and returned."""
    library = scatter_library(torch, x, ids, valid, out[1][0].numel())
    alone, per_kernel = device_ms(call, iters=min(iters, 10))
    r = {"ms": cuda_ms(call, iters=iters), "alone_ms": alone,
         "plain_ms": cuda_ms(plain, iters=iters),
         "library_ms": cuda_ms(library, iters=iters)}
    r["bound_ms"], r["bound_by"] = bound(
        nbytes(x, ids, valid, *out), int(valid.sum()) * x.shape[-1], peak)
    if tag is None:
        return r
    print(f"{tag}: wrapper {r['ms']:.4f} ms, kernels alone "
          f"{r['alone_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
          f"scatter_reduce_ {r['library_ms']:.4f} ms, bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}); mean of {iters} "
          f"calls; kernels: " + "; ".join(
              f"{k.replace('(anonymous namespace)::', '').split('(')[0][-60:]}"
              f" {ms * 1e3:.1f} us"
              for ms, k in per_kernel[:6]))
    return r


def one_pillar(torch, ids, width, height):
    """The same points, every id moved to the centre pillar."""
    return torch.full_like(ids, (height // 2) * width + width // 2)


def check_scatter(torch, dev, pc_range, pillar_size):
    """Phase 2: the pillar scatter-max kernel (K1) vs its plain version at
    the flagship shape in its three modes, and with every point in one
    pillar; returns the per-mode records."""
    from pillarnet_lts_torch.datasets import synth_points_realistic
    from pillarnet_lts_torch.ops.scatter import pillar_scatter_max
    from pillarnet_lts_torch.ops.voxelize import (
        PillarSpec, scatter_max_to_grid, voxelize_points)

    spec = PillarSpec(pillar_size, tuple(pc_range))
    H, W = spec.height, spec.width
    pts, msk = synth_points_realistic(1, N_POINTS, pc_range, seed=100)
    pts = torch.from_numpy(pts).to(dev)
    msk = torch.from_numpy(msk).to(dev)
    feats, ids, valid = voxelize_points(pts, msk, spec)
    g = torch.Generator().manual_seed(0)
    w = (torch.randn(32, feats.shape[-1], generator=g) * 0.5).to(dev)
    signed = torch.nn.functional.linear(feats, w).contiguous()
    relu = torch.relu(signed)
    codes = torch.round(relu * (127.0 / relu.max())).clamp_(0, 127) \
        .to(torch.int8)
    cases = (("f32_signed", signed, False, F32_OPS),
             ("f32_nonneg", relu, True, F32_OPS),
             ("int8", codes, True, INT8_OPS))
    modes, err = {}, 0.0
    for tag, x, nonneg, peak in cases:
        args = (x, ids, valid, H, W)
        out = pillar_scatter_max(*args, nonneg=nonneg)
        err = max(err, check_scatter_equal(torch, f"pillar_scatter_max {tag}",
                                           out, scatter_max_to_grid(*args)))
        modes[tag] = scatter_times(
            torch, f"[2] K1 {tag} {tuple(x.shape)} -> {H}x{W}, bit-equal, "
            f"{int(out[1].sum())} of {H * W} pillars occupied",
            lambda: pillar_scatter_max(*args, nonneg=nonneg),
            lambda: scatter_max_to_grid(*args), x, ids, valid, out, peak)

    # the longest run: every point in one pillar (atomics on one row)
    args = (signed, one_pillar(torch, ids, W, H), valid, H, W)
    out = pillar_scatter_max(*args)
    err = max(err, check_scatter_equal(torch, "pillar_scatter_max one pillar",
                                       out, scatter_max_to_grid(*args)))
    modes["one_pillar_f32"] = scatter_times(
        torch, f"[2] K1 f32 signed, all {int(valid.sum())} points in one "
        f"pillar, bit-equal", lambda: pillar_scatter_max(*args),
        lambda: scatter_max_to_grid(*args), signed, args[1], valid, out,
        F32_OPS, iters=5)
    return {"max_abs_err": err, "modes": modes}


def nms_like_boxes(torch, seed, T=NMS_TASKS, K=NMS_K):
    """(T, K, 5) pcdet BEV boxes in +-54 m, dims 0.3-12 m, with clustered,
    identical and edge-touching pairs."""
    rng = np.random.RandomState(seed)
    b = np.zeros((T, K, 5), np.float32)
    b[..., 0:2] = rng.uniform(-54, 54, (T, K, 2))
    b[..., 2:4] = rng.uniform(0.3, 12, (T, K, 2))
    b[..., 4] = rng.uniform(-np.pi, np.pi, (T, K))
    # clusters: a third of the boxes around 10 centres per task
    nc = K // 3
    centres = rng.uniform(-50, 50, (T, 10, 2))
    pick = rng.randint(0, 10, (T, nc))
    b[:, :nc, 0:2] = (np.take_along_axis(centres, pick[..., None], 1)
                      + rng.randn(T, nc, 2) * 1.5)
    # identical pairs: K/20 boxes copied from the next K/20
    d = K // 20
    b[:, nc:nc + d] = b[:, nc + d:nc + 2 * d]
    # edge-touching axis-aligned pairs: box j+1 starts where box j ends
    s, e = nc + 2 * d, nc + 2 * d + 2 * (K // 20)
    b[:, s:e:2, 4] = 0.0
    b[:, s + 1:e:2] = b[:, s:e:2]
    b[:, s + 1:e:2, 0] += b[:, s:e:2, 2]
    return torch.from_numpy(b)


def bit_equal(torch, a, b):
    """Same shape and the same f32 bits (+0 and -0 differ, NaN equals)."""
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def pair_bound(n_bytes, near, tested, pair_ops, all_pairs):
    """(bound, old bound): the pair kernels' bound from this run's near
    pairs plus the test on every tested pair, and the earlier count that
    charged every pair the full clip."""
    return (bound(n_bytes, near * pair_ops + tested * CULL_PAIR_OPS, F32_OPS),
            bound(n_bytes, all_pairs * pair_ops, F32_OPS))


def pair_times(call, plain, plain_iters=5):
    """Wrapper (CUDA events), kernels alone (profiler), plain."""
    return {"ms": cuda_ms(call), "alone_ms": device_ms(call)[0],
            "plain_ms": cuda_ms(plain, iters=plain_iters, warmup=1)}


def check_overlap(torch, tag, a, b, phase="3", quiet=False):
    """Phase 3: the rotated-overlap kernel (K2) on corners a, b against its
    plain version, bit-equal, timed three ways; its near-pair share and
    recounted bound. `phase` labels the printed line; `quiet` leaves it
    out."""
    from pillarnet_lts_torch.ops.iou3d import (
        _pairwise_area_plain, convex_intersection_area, pairs_may_meet)

    got = convex_intersection_area(a, b)
    want = _pairwise_area_plain(a, b)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"rotated_overlap ({tag}): non-finite areas")
    err = (got - want).abs().max().item()
    if not bit_equal(torch, got, want):
        raise AssertionError(f"rotated_overlap ({tag}) differs from plain: "
                             f"max |d| {err}, {int((got != want).sum())} "
                             f"pairs")
    pairs = got.numel()
    near = int(pairs_may_meet(a, b).sum())
    r = dict(pair_times(lambda: convex_intersection_area(a, b),
                        lambda: _pairwise_area_plain(a, b)),
             max_abs_err=err, shape=list(got.shape), near_share=near / pairs)
    r["bound"], r["bound_all_pairs"] = pair_bound(
        nbytes(a, b, got), near, pairs, OVERLAP_PAIR_OPS, pairs)
    if quiet:
        return r
    print(f"[{phase}] K2 rotated overlap, {tag} {tuple(got.shape)}: "
          f"bit-equal to "
          f"plain ({int((want > 0).sum())} overlapping pairs); near pairs "
          f"{near} of {pairs} ({r['near_share']:.2%}); wrapper "
          f"{r['ms']:.4f} ms, kernels alone {r['alone_ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
          f"({r['bound'][1]}; every pair clipped: "
          f"{r['bound_all_pairs'][0]:.4f} ms)")
    return r


@contextlib.contextmanager
def patched(owner, name, make):
    """`owner.name` (a module's or an object's) replaced by make(real)
    while the context is open."""
    real, own = getattr(owner, name), name in vars(owner)
    setattr(owner, name, make(real))
    try:
        yield
    finally:
        if own:
            setattr(owner, name, real)
        else:
            delattr(owner, name)


def recording(owner, name, calls, keep=lambda a, k: (a, k)):
    """`owner.name` with keep(args, kwargs) of each call appended to
    `calls` while the context is open."""
    def make(real):
        def record(*args, **kwargs):
            calls.append(keep(args, kwargs))
            return real(*args, **kwargs)
        return record
    return patched(owner, name, make)


def capture_overlap(request):
    """Run request() with `ops.iou3d.convex_intersection_area` recorded:
    returns its result and the (a_quad, b_quad) of its K2 calls."""
    from pillarnet_lts_torch.ops import iou3d

    calls = []
    with recording(iou3d, "convex_intersection_area", calls,
                   keep=lambda a, k: a):
        return request(), calls


def check_no_sync(torch, infer, pts, msk, tag):
    """One request on card-resident points with every host sync an error,
    up to its host copy."""
    from pillarnet_lts_torch.runtime.serving import to_host

    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        det = infer(pts, msk)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    det = to_host(det)
    print(f"[{tag}] a request under set_sync_debug_mode('error'): no host "
          f"sync before its host copy ({int(det['mask'].sum())} kept)")


def check_golden(torch, dev):
    """Phase 4: golden fixture replay on the card."""
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.models import build_detector
    from pillarnet_lts_torch.runtime.convert import (
        load_jax_variables, variables_from_keystr)

    data = np.load(FIXTURE)
    mcfg, tcfg = golden_model_cfg()
    model = build_detector(mcfg, test_cfg=tcfg, device=dev)
    load_jax_variables(model, variables_from_keystr(data))
    det = make_infer_fn(model)(
        torch.from_numpy(data["points"]).to(dev),
        torch.from_numpy(data["points_mask"]).to(dev))
    det = {k: v.cpu().numpy() for k, v in det.items()}
    np.testing.assert_array_equal(det["mask"], data["det_mask"],
                                  err_msg="NMS keep-set changed")
    m = data["det_mask"].astype(bool)
    np.testing.assert_array_equal(det["label_preds"][m],
                                  data["label_preds"][m])
    np.testing.assert_allclose(det["scores"][m], data["scores"][m], atol=1e-4)
    np.testing.assert_allclose(det["box3d_lidar"][m], data["box3d_lidar"][m],
                               atol=1e-3)
    print(f"[4] golden replay: {int(m.sum())} detections match the fixture "
          f"(max |d| score "
          f"{np.abs(det['scores'][m] - data['scores'][m]).max():.2e}, box "
          f"{np.abs(det['box3d_lidar'][m] - data['box3d_lidar'][m]).max():.2e})")


def serve_flagship(torch, dev, card):
    """Phase 5: the f32 flagship config as a server. Returns the corners
    that its first request handed K2."""
    from pillarnet_lts_torch.datasets import synth_points_realistic
    from pillarnet_lts_torch.apis import (
        build_model_from_cfg, load_config, spread_head_outputs)
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.ops import _kernels
    from pillarnet_lts_torch.runtime.serving import ServingPipeline

    cfg = load_config(FLAGSHIP)
    n, pc_range = int(cfg["data"]["max_points"]), cfg["point_cloud_range"]
    model = build_model_from_cfg(cfg, device=dev, seed=0)
    post = cfg["test_cfg"]["nms"]["nms_post_max_size"] * len(cfg["tasks"])
    clouds = [synth_points_realistic(1, n, pc_range, seed=s)
              for s in range(13)]
    clouds += [synth_points_realistic(2, n, pc_range, seed=s)
               for s in (13, 14)]
    # random weights: spread the head outputs so that NMS sees valid boxes
    calib = synth_points_realistic(1, n, pc_range, seed=99)
    spread_head_outputs(model, torch.from_numpy(calib[0]).to(dev),
                        torch.from_numpy(calib[1]).to(dev))
    infer = make_infer_fn(model)
    pipe = ServingPipeline(infer, depth=1)

    def request(pts, msk):
        before = dict(_kernels.LAUNCHES)
        outs = list(pipe.map([(torch.from_numpy(pts).to(dev),
                               torch.from_numpy(msk).to(dev))]))
        for name, count in _kernels.LAUNCHES.items():
            if (count > before[name]) != (name in F32_PATH):
                raise AssertionError(f"f32 request: {name} launched="
                                     f"{count > before[name]}")
        return outs[0]

    torch.cuda.reset_peak_memory_stats(dev)
    _kernels.reset_launches()
    lat, kept = [], []
    for i, (pts, msk) in enumerate(clouds):
        t0 = time.perf_counter()
        if i == 0:  # a warm-up request: record what it hands K2
            det, k2_calls = capture_overlap(lambda: request(pts, msk))
        else:
            det = request(pts, msk)
        dt = (time.perf_counter() - t0) * 1e3
        B = pts.shape[0]
        for key, shape in (("box3d_lidar", (B, post, 9)), ("scores", (B, post)),
                           ("label_preds", (B, post)), ("mask", (B, post))):
            if det[key].shape != shape:
                raise AssertionError(f"{key} shape {det[key].shape} != {shape}")
        if not (np.isfinite(det["box3d_lidar"]).all()
                and np.isfinite(det["scores"]).all()):
            raise AssertionError(f"request {i}: non-finite detections")
        if 3 <= i < 13:
            lat.append(dt)
            kept.append(int(det["mask"].sum()))
        elif i >= 13:
            print(f"[5] bs=2 request {i - 12}: {dt:.2f} ms, kept "
                  f"{det['mask'].sum(axis=1).tolist()} boxes")
    launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    for mod in ("jax", "pillarnet_lts_tpu", "__graft_entry__"):
        if mod in sys.modules:
            raise AssertionError(f"the port imported {mod}")
    q = statistics.quantiles(lat, n=10)
    print(f"[5] flagship pillarnet34_nusc bs=1, {len(lat)} timed requests "
          f"(after 3 warm-up), host-synced latency: p50 "
          f"{statistics.median(lat):.2f} ms, p90 {q[8]:.2f} ms; peak "
          f"allocated {peak / 2**30:.3f} GiB; mean kept boxes "
          f"{statistics.mean(kept):.1f} of {post}; card: {card}")
    print(f"[5] launches over {len(clouds)} requests: {launches}")
    check_no_sync(torch, infer, *on_card(torch, dev, clouds[3]), "5")
    if len(k2_calls) != 1:
        raise AssertionError(f"a request made {len(k2_calls)} K2 calls")
    return k2_calls[0]


def rel_errors(ref, got, heads=None):
    """max |got - ref| / max |ref| per task over the named head outputs."""
    return [max(((a[k].float() - b[k].float()).abs().max()
                 / (a[k].float().abs().max() + 1e-6)).item()
                for k in (heads or a)) for a, b in zip(ref, got)]


def demo_canary(torch, dev):
    """The int8 accuracy canary of tests/test_quant_int8.py:88-106 (its
    model, input, protocol and 0.2 bound) on the card: the demo config at
    the int8 kernels' widths (32-channel stage 1), seeded weights,
    calibrated on the input it is then run on, every head output within
    0.2 of its max of the same model's bf16 forward."""
    from pillarnet_lts_torch.apis import build_model_from_cfg, load_config
    from pillarnet_lts_torch.runtime.quantize import (
        calibrate, enable_backbone_quant)

    cfg = load_config(DEMO)
    enable_backbone_quant(cfg["model"])
    cfg["model"]["dtype"] = "bfloat16"
    cfg["model"]["reader"]["num_filters"] = (32,)
    cfg["model"]["backbone"]["in_channels"] = 32
    model = build_model_from_cfg(cfg, device=dev, seed=0)
    rng = np.random.RandomState(1)
    pts = torch.from_numpy(rng.uniform(-15, 15, (1, 512, 5))
                           .astype(np.float32)).to(dev)
    msk = torch.ones((1, 512), dtype=torch.bool, device=dev)
    with torch.no_grad():
        ref = model(pts, msk)
        calibrate(model, [(pts, msk)])
        got = model(pts, msk)
    errs = rel_errors(ref, got)
    print(f"[8] int8 canary (demo model at 32-channel widths): max |int8 - "
          f"bf16| / max|bf16| over head outputs per task "
          f"{[round(e, 4) for e in errs]} (bound {HM_REL_BOUND})")
    if max(errs) > HM_REL_BOUND:
        raise AssertionError(f"int8 canary {max(errs)} > {HM_REL_BOUND}")


def int8_flagship(torch, dev, tag="6"):
    """The int8 deploy config with seeded random weights and spread head
    outputs, calibrated on 4 synthetic clouds (its heatmaps' distance from
    the bf16 forward is printed). Returns the model, a cloud maker and the
    number of NMS slots."""
    from pillarnet_lts_torch.datasets import synth_points_realistic
    from pillarnet_lts_torch.apis import (
        build_model_from_cfg, load_config, spread_head_outputs)
    from pillarnet_lts_torch.runtime.quantize import calibrate

    cfg = load_config(FLAGSHIP_INT8)
    n, pc_range = int(cfg["data"]["max_points"]), cfg["point_cloud_range"]
    post = cfg["test_cfg"]["nms"]["nms_post_max_size"] * len(cfg["tasks"])

    def cloud(seed):  # in host memory, as a request arrives
        return synth_points_realistic(1, n, pc_range, seed=seed)

    model = build_model_from_cfg(cfg, device=dev, seed=0)
    calib = [on_card(torch, dev, cloud(s)) for s in (90, 91, 92, 93)]
    with torch.no_grad():
        # uncalibrated: the bf16 path
        spread_head_outputs(model, *on_card(torch, dev, cloud(99)))
        ref = model(*calib[0])
        t0 = time.perf_counter()
        calibrate(model, calib)
        torch.cuda.synchronize()
        t_cal = time.perf_counter() - t0
        got = model(*calib[0])
    print(f"[{tag}] int8 flagship calibrated on 4 clouds in {t_cal:.2f} s; "
          f"heatmap |int8 - bf16| / max|bf16| per task on a calibration "
          f"cloud (random weights, reported): "
          f"{[round(e, 4) for e in rel_errors(ref, got, ('hm',))]}")
    return model, cloud, post


def on_card(torch, dev, cloud):
    return tuple(torch.from_numpy(a).to(dev) for a in cloud)


def capture_int8_convs(torch, model, request):
    """Serve one request with the fused stage off and record (args, kwargs,
    output) of every K4 call in it: `MaskedConv.int8` reaches the wrapper
    through `models/backbones/base.py`, so the masks and residuals are the
    served ones."""
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.runtime.serving import ServingPipeline

    calls = []
    model.backbone_net.s2d_pallas = False
    with recording_int8_convs(calls):
        list(ServingPipeline(make_infer_fn(model), depth=1).map([request]))
    torch.cuda.synchronize()
    return calls


@contextlib.contextmanager
def recording_int8_convs(calls):
    """Record (args, kwargs, output) of every K4 call inside the block in
    `calls`: `MaskedConv.int8` reaches the wrapper through
    `models/backbones/base.py::int8_conv_bn_act`, an int8 SepHead's wide
    conv through `models/bbox_heads/center_head.py::int8_conv_bn_act`."""
    from pillarnet_lts_torch.models.backbones import base
    from pillarnet_lts_torch.models.bbox_heads import center_head

    def make(real):
        def record(*args, **kw):
            out = real(*args, **kw)
            calls.append((args, kw, out))
            return out
        return record

    with patched(base, "int8_conv_bn_act", make), \
            patched(center_head, "int8_conv_bn_act", make):
        yield


def plain_kwargs(kw):
    """The keyword arguments that the plain version takes."""
    return {k: v for k, v in kw.items() if k in ("mask", "residual", "act")}


def input_sites(torch, mask, H, W, stride):
    """Input sites that a 3x3 conv (padding 1) at `stride` reads for the
    active sites of its (B, Ho, Wo) output `mask`: the mask dilated by the
    conv window, counted on the (B, H, W) input."""
    import torch.nn.functional as F

    m = (mask != 0).float()[:, None]
    if stride == 2:
        up = m.new_zeros((m.shape[0], 1, 2 * m.shape[2], 2 * m.shape[3]))
        up[..., ::2, ::2] = m
        m = up
    return int(F.max_pool2d(m, 3, 1, 1)[..., :H, :W].sum())


def live_tiles(torch, mask, th=8, tw=16):
    """Share of K4's th x tw output tiles with an active site: the tiles
    that read their haloed input patch and residual."""
    import torch.nn.functional as F

    m = F.max_pool2d((mask != 0).float()[:, None], (th, tw), (th, tw),
                     ceil_mode=True)
    return float(m.mean())


def int8_conv_bound(torch, args, kw, out):
    """K4's bound for one call, from what the function needs: the packed
    kernel, the scales and the mask once, x at the input sites that the
    active output sites' 3x3 windows cover, the residual at the active
    sites, and the whole output (inactive sites are written as 0); 2 * 9 *
    Cin * Cout operations per active output site (every site when there is
    no mask). Returns the bound and the active output sites."""
    x, w_q, stride = args[0], args[1], args[5]
    B, H, W, cin = x.shape
    cout = w_q.shape[3]
    mask, res = kw.get("mask"), kw.get("residual")
    sites = out.shape[0] * out.shape[1] * out.shape[2]
    sites_in = B * H * W
    if mask is not None:
        sites = int((mask != 0).sum())
        sites_in = input_sites(torch, mask, H, W, stride)
    n_bytes = (nbytes(kw.get("w_pack", w_q), *args[2:5], mask, out)
               + sites_in * cin * x.element_size()
               + (0 if res is None else sites * cout * res.element_size()))
    return bound(n_bytes, 2 * 9 * cin * cout * sites, INT8_OPS), sites


def bf16_twin(torch, args, kw):
    """A K4 call's arguments with its f32 activations, mask and residual
    cast to bf16: the bf16 variant at the same shapes."""
    def cast(t):
        return t if t is None else t.to(torch.bfloat16)

    return ((cast(args[0]),) + tuple(args[1:]),
            dict(kw, mask=cast(kw.get("mask")),
                 residual=cast(kw.get("residual"))))


def check_int8_conv(torch, calls, phase="6"):
    """Phase 6: every K4 call of one served int8 request replayed through
    the kernel and its plain version, bit-equal; each call timed with its
    wrapper and its plain version, each distinct shape with its kernels
    alone (`torch.profiler`), its bound and the cuDNN conv of the same
    shape in the activations' dtype (a yardstick, not the same function);
    per-frame sums. Calls of the f32 variant (`int8_conv_f32`, phase 18a)
    also time the bf16 variant on the same calls cast to bf16 (wrapper and
    alone). `phase` labels the printed lines."""
    import torch.nn.functional as F
    from pillarnet_lts_torch.ops.quant import (
        int8_conv_bn_act, int8_conv_bn_act_plain)

    f32 = calls[0][0][0].dtype == torch.float32
    yard = "f32_conv_ms" if f32 else "bf16_conv_ms"

    shapes, err = {}, 0.0
    for i, (args, kw, out) in enumerate(calls):
        got = int8_conv_bn_act(*args, **kw)
        want = int8_conv_bn_act_plain(*args, **plain_kwargs(kw))
        torch.cuda.synchronize()
        d = (got.float() - want.float()).abs().max().item()
        err = max(err, d)
        if not (torch.equal(got, want) and torch.equal(got, out)):
            raise AssertionError(
                f"int8_conv call {i} {tuple(args[0].shape)} -> "
                f"{tuple(got.shape)} differs from plain: max |d| {d}, "
                f"{int((got != want).sum())} elements")
        (b_ms, b_by), sites = int8_conv_bound(torch, args, kw, out)
        x, w_q, stride = args[0], args[1], args[5]
        key = (tuple(x.shape), w_q.shape[3], stride,
               kw.get("mask") is not None, kw.get("residual") is not None)
        s = shapes.setdefault(key, {"calls": [], "ms": [], "plain_ms": [],
                                    "bound_ms": [], "sites": [], "live": []})
        s["calls"].append((args, kw))
        s["ms"].append(cuda_ms(lambda: int8_conv_bn_act(*args, **kw)))
        s["plain_ms"].append(cuda_ms(
            lambda: int8_conv_bn_act_plain(*args, **plain_kwargs(kw)),
            iters=PLAIN_ITERS, warmup=1))
        s["bound_ms"].append(b_ms)
        s["bound_by"] = b_by
        s["sites"].append(sites)
        s["live"].append(1.0 if kw.get("mask") is None
                         else live_tiles(torch, kw["mask"]))

    keys = ("ms", "alone_ms", "plain_ms", "bound_ms", yard) + (
        ("bf16_variant_ms", "bf16_variant_alone_ms") if f32 else ())
    rows, frame = [], {k: 0.0 for k in keys}
    for (xs, cout, stride, has_mask, has_res), s in shapes.items():
        n = len(s["calls"])
        alone, _ = device_ms(lambda: [int8_conv_bn_act(*a, **k)
                                      for a, k in s["calls"]], iters=5)
        x, w_q = s["calls"][0][0][0], s["calls"][0][0][1]
        xc = x.permute(0, 3, 1, 2)  # NCHW view of NHWC: channels_last
        wc = w_q.permute(3, 2, 0, 1).to(x.dtype).contiguous(
            memory_format=torch.channels_last)
        conv = cuda_ms(lambda: F.conv2d(xc, wc, stride=stride, padding=1))
        r = {"shape": f"{xs[0]}x{xs[1]}x{xs[2]}x{xs[3]} -> {cout}, stride "
                      f"{stride}" + (", mask" if has_mask else ", dense")
                      + (", residual" if has_res else ""),
             "launches": n, "ms": statistics.mean(s["ms"]),
             "alone_ms": alone / n, "plain_ms": statistics.mean(s["plain_ms"]),
             "bound_ms": statistics.mean(s["bound_ms"]),
             "bound_by": s["bound_by"], yard: conv,
             "active_sites": statistics.mean(s["sites"]),
             "live_tiles": statistics.mean(s["live"]),
             "key": (has_res, xs[1] * xs[2])}
        twin = ""
        if f32:
            bf = [bf16_twin(torch, a, k) for a, k in s["calls"]]
            r["bf16_variant_ms"] = statistics.mean(
                cuda_ms(lambda: int8_conv_bn_act(*a, **k)) for a, k in bf)
            r["bf16_variant_alone_ms"] = device_ms(
                lambda: [int8_conv_bn_act(*a, **k) for a, k in bf],
                iters=5)[0] / n
            twin = (f"; the bf16 variant on the same calls cast to bf16: "
                    f"wrapper {r['bf16_variant_ms']:.4f} ms, alone "
                    f"{r['bf16_variant_alone_ms']:.4f} ms")
        rows.append(r)
        for k in frame:
            frame[k] += n * r[k]
        print(f"[{phase}] K4 {r['shape']}: {n} launches, bit-equal; wrapper "
              f"{r['ms']:.4f} ms, kernels alone {r['alone_ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; {r['bound_ms'] / r['alone_ms']:.0%} of it "
              f"alone), cuDNN {yard[:-8]} conv of the shape (not the same "
              f"function) {conv:.4f} ms; {r['active_sites']:.0f} active "
              f"output sites, {r['live_tiles']:.1%} of its 8 x 16 tiles "
              f"live" + twin)
    print(f"[{phase}] K4 per int8 request ({len(calls)} calls of the "
          f"{'f32' if f32 else 'bf16'} variant, fused stage off): "
          f"wrapper {frame['ms']:.4f} ms, kernels alone "
          f"{frame['alone_ms']:.4f} ms, plain {frame['plain_ms']:.4f} ms, "
          f"bound {frame['bound_ms']:.4f} ms, cuDNN {yard[:-8]} convs "
          f"{frame[yard]:.4f} ms" + (
              f"; the bf16 variant: wrapper {frame['bf16_variant_ms']:.4f} "
              f"ms, alone {frame['bf16_variant_alone_ms']:.4f} ms"
              if f32 else ""))
    # the row's own numbers: the stage-1 residual conv (the largest map)
    main = max(rows, key=lambda r: r["key"])
    for r in rows:
        del r["key"]
    return {"max_abs_err": err, "ms": main["ms"], "alone_ms":
            main["alone_ms"], "plain_ms": main["plain_ms"],
            "bound": (main["bound_ms"], main["bound_by"]), "main_shape":
            main["shape"], "shapes": rows, "frame": frame}


def check_int8_stage(torch, model, calls):
    """Phase 7: the fused int8 stage kernel (K5) on the served request's
    stride-1 stage (its input and mask from the first captured K4 call, the
    model's stacked int8 params) vs its plain version and vs the per-conv
    route over the same convs, all bit-equal."""
    from pillarnet_lts_torch.ops.int8_stage import int8_stage, int8_stage_plain
    from pillarnet_lts_torch.ops.quant import int8_conv_bn_act

    bb = model.backbone_net
    bb.s2d_pallas = True
    params = bb.fused_stage1_params()
    n = params[0].shape[0]
    (x, *_), kw0, _ = calls[0]
    args = (x, *params[:4], kw0["mask"])
    pack = {"w_pack": params[4]}
    got = int8_stage(*args, **pack)
    want = int8_stage_plain(*args)
    per_conv = calls[n - 1][2]
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not (torch.equal(got, want) and torch.equal(got, per_conv)):
        raise AssertionError(f"int8_stage differs from plain or the per-conv "
                             f"route: max |d| {err}, "
                             f"{int((got != want).sum())} elements")
    route = [(a, k) for a, k, _ in calls[:n]]
    r = {"max_abs_err": err, "ms": cuda_ms(lambda: int8_stage(*args, **pack)),
         "alone_ms": device_ms(lambda: int8_stage(*args, **pack),
                               iters=5)[0],
         "plain_ms": cuda_ms(lambda: int8_stage_plain(*args),
                             iters=PLAIN_ITERS, warmup=1),
         "per_conv_ms": cuda_ms(lambda: [int8_conv_bn_act(*a, **k)
                                         for a, k in route]),
         "per_conv_alone_ms": device_ms(lambda: [int8_conv_bn_act(*a, **k)
                                                 for a, k in route],
                                        iters=5)[0]}
    # bytes as for K4: x where the active sites' windows reach it (later
    # convs read only the stage's own intermediates), the whole output
    sites = int((kw0["mask"] != 0).sum())
    sites_in = input_sites(torch, kw0["mask"], x.shape[1], x.shape[2], 1)
    r["bound"] = bound(nbytes(*args[2:], params[4], got)
                       + sites_in * 32 * x.element_size(),
                       n * 2 * 9 * 32 * 32 * sites, INT8_OPS)
    print(f"[7] fused int8 stage, n = {n}, {tuple(x.shape)} (the served "
          f"request's stage 1, {sites} active sites): bit-equal to plain and "
          f"to the per-conv route; wrapper {r['ms']:.4f} ms, kernels alone "
          f"{r['alone_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
          f"{r['bound'][0]:.4f} ms ({r['bound'][1]}); the per-conv route "
          f"over the same {n} convs: wrapper {r['per_conv_ms']:.4f} ms, "
          f"kernels alone {r['per_conv_alone_ms']:.4f} ms")
    return r


def serve_int8_flagship(torch, dev, card, model, cloud, post):
    """Phase 8: the int8 deploy config as a server, fused stage on and off,
    on the same clouds: both routes are bit-equal to the same plain chain,
    so they must serve identical detections. Returns the launch counts of
    the fused-stage run."""
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.ops import _kernels
    from pillarnet_lts_torch.runtime.serving import ServingPipeline

    demo_canary(torch, dev)
    clouds = [cloud(s) for s in range(13)]
    path = {"pillar_scatter_max", "rotated_overlap", "int8_conv"}
    launches, served = None, {}
    for fused in (True, False):
        model.backbone_net.s2d_pallas = fused
        kernels = path | {"int8_stage"} if fused else path
        pipe = ServingPipeline(make_infer_fn(model), depth=1)
        torch.cuda.reset_peak_memory_stats(dev)
        _kernels.reset_launches()
        lat, kept, dets = [], [], []
        for i, (pts, msk) in enumerate(clouds):
            before = dict(_kernels.LAUNCHES)
            t0 = time.perf_counter()
            det = list(pipe.map([(torch.from_numpy(pts).to(dev),
                                  torch.from_numpy(msk).to(dev))]))[0]
            dt = (time.perf_counter() - t0) * 1e3
            for name, count in _kernels.LAUNCHES.items():
                rose = count > before[name]
                if rose != (name in kernels):
                    raise AssertionError(f"int8 request {i} (fused={fused}):"
                                         f" {name} launched={rose}")
            if det["box3d_lidar"].shape != (1, post, 9) or not (
                    np.isfinite(det["box3d_lidar"]).all()
                    and np.isfinite(det["scores"]).all()):
                raise AssertionError(f"int8 request {i}: bad detections")
            dets.append(det)
            if i >= 3:
                lat.append(dt)
                kept.append(int(det["mask"].sum()))
        counts = dict(_kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        q = statistics.quantiles(lat, n=10)
        print(f"[8] int8 flagship pillarnet34_nusc_int8 bs=1, fused stage "
              f"{'on' if fused else 'off'}: {len(lat)} timed requests (after "
              f"3 warm-up), host-synced latency p50 "
              f"{statistics.median(lat):.2f} ms, p90 {q[8]:.2f} ms; peak "
              f"allocated {peak / 2**30:.3f} GiB; mean kept boxes "
              f"{statistics.mean(kept):.1f} of {post}; launches over "
              f"{len(clouds)} requests {counts}; card: {card}")
        served[fused] = dets
        if fused:
            launches = counts
    for i, (a, b) in enumerate(zip(served[True], served[False])):
        for key in a:
            if not np.array_equal(a[key], b[key]):
                raise AssertionError(f"int8 request {i}: {key} differs "
                                     f"between the fused and per-conv routes")
    print(f"[8] the fused and per-conv int8 routes served identical "
          f"detections on all {len(clouds)} clouds")
    return launches


def det3d_from_bev(torch, bev):
    """pcdet BEV (..., 5) -> det3d (..., 7) boxes (z 0, height 1.5): the
    inverse of `ops.iou3d.to_pcdet_bev`."""
    x, y, dx, dy, heading = bev.unbind(-1)
    return torch.stack([x, y, torch.zeros_like(x), dy, dx,
                        torch.full_like(x, 1.5), -heading - math.pi / 2], -1)


def mask_flips(torch, boxes, thresh, m_kernel, tag):
    """Pairs the mask kernel decides unlike the default route (overlap
    kernel IoU > threshold); each must lie within MASK_EPS of its row's
    threshold. Prints them; returns their count."""
    from pillarnet_lts_torch.ops.iou3d import rotated_iou_bev, to_pcdet_bev

    bev = to_pcdet_bev(boxes)
    iou = rotated_iou_bev(bev, bev)
    k = boxes.shape[1]
    upper = torch.ones((k, k), dtype=torch.bool, device=boxes.device).triu(1)
    th = thresh.reshape(-1, 1, 1)
    flips = (m_kernel > 0) != (upper & (iou > th))
    bad = flips & ((iou - th).abs() >= MASK_EPS)
    for r, j, i in flips.nonzero().tolist():
        print(f"[9] {tag}: pair (row {r}, {j}, {i}) decided otherwise than "
              f"the default route: IoU {iou[r, j, i].item():.9f}, threshold "
              f"{th[r, 0, 0].item()}")
    if bool(bad.any()):
        raise AssertionError(f"{tag}: {int(bad.sum())} mask decisions differ "
                             f"from the default route off the threshold")
    return int(flips.sum())


def check_suppression_mask(torch, tag, boxes, thresh):
    """K3 on (R, K, D) det3d boxes and thresholds (a float or (R,)) against
    its plain version, bit-equal, and its own corners against
    `mask_kernel_corners`, bit-equal; timed three ways (the plain version
    from given corners); its near-pair share and recounted bound. Returns
    the record and the mask."""
    from pillarnet_lts_torch.ops import nms
    from pillarnet_lts_torch.ops.iou3d import pairs_may_meet

    R, K = boxes.shape[:2]
    th = thresh if torch.is_tensor(thresh) else torch.full(
        (R,), float(thresh), device=boxes.device)
    got = nms.suppression_matrix(boxes, thresh)
    ca, cb = nms.mask_kernel_corners(boxes)
    want = nms._suppression_matrix_plain(ca, cb, th)
    kca, kcb = nms.suppression_mask_corners(boxes)
    torch.cuda.synchronize()
    corner_err = max((kca - ca).abs().max().item(),
                     (kcb - cb).abs().max().item())
    if not (bit_equal(torch, kca, ca) and bit_equal(torch, kcb, cb)):
        raise AssertionError(f"suppression_mask ({tag}): the kernel's corners "
                             f"differ from mask_kernel_corners by "
                             f"{corner_err}")
    if not bit_equal(torch, got, want):
        raise AssertionError(f"suppression_mask ({tag}) differs from plain "
                             f"at {int((got != want).sum())} pairs")
    upper = torch.ones((K, K), dtype=torch.bool, device=boxes.device).triu(1)
    near = int((pairs_may_meet(ca, ca) & upper).sum())
    tested = R * K * (K - 1) // 2
    r = dict(pair_times(lambda: nms.suppression_matrix(boxes, thresh),
                        lambda: nms._suppression_matrix_plain(ca, cb, th),
                        plain_iters=PLAIN_ITERS),
             max_abs_err=0.0, shape=list(got.shape), near_share=near / tested,
             corner_max_abs_err=corner_err)
    r["bound"], r["bound_all_pairs"] = pair_bound(
        nbytes(boxes, th, got), near, tested, MASK_PAIR_OPS, tested)
    print(f"[9] K3 suppression mask, {tag} {tuple(got.shape)}: bit-equal to "
          f"plain ({int(got.sum())} suppressing pairs), its corners "
          f"bit-equal to mask_kernel_corners; near pairs {near} of {tested} "
          f"above the diagonal ({r['near_share']:.2%}); wrapper "
          f"{r['ms']:.4f} ms, kernels alone {r['alone_ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
          f"({r['bound'][1]}; every pair clipped: "
          f"{r['bound_all_pairs'][0]:.4f} ms)")
    return r, got


def check_mask(torch, dev):
    """Phase 9: the suppression-mask kernel vs its plain version, and vs the
    default (overlap-kernel) route, at the nuScenes and Waymo shapes."""
    from pillarnet_lts_torch.ops import nms

    shapes = (("nuScenes", NMS_TASKS, NMS_K, (0.2,) * NMS_TASKS, 1),
              ("Waymo grouped", 3, WAYMO_K, WAYMO_THRESH, 2))
    res = {}
    for tag, R, K, ths, seed in shapes:
        boxes = det3d_from_bev(torch, nms_like_boxes(torch, seed, R, K)
                               .to(dev)).contiguous()
        thresh = torch.tensor(ths, dtype=torch.float32, device=dev)
        res[tag], got = check_suppression_mask(torch, tag, boxes, thresh)
        n_flips = mask_flips(torch, boxes, thresh, got, tag)
        valid = torch.rand((R, K), generator=torch.Generator(device=dev)
                           .manual_seed(seed), device=dev) > 0.05
        scores = torch.zeros((R, K), device=dev)
        if tag == "nuScenes":  # the static-threshold route
            mine = nms.rotated_nms(boxes, scores, valid, ths[0], K,
                                   use_mask_kernel=True)
            ref = nms.rotated_nms(boxes, scores, valid, ths[0], K)
        else:  # the per-row-threshold route, mask given
            mine = nms._select_topk_sorted(
                nms._greedy_suppress_mask(got, valid), K)
            ref = nms.rotated_nms_dynamic(boxes, scores, valid, thresh, K)
        same = all(torch.equal(x, y) for x, y in zip(mine, ref))
        if not same and n_flips == 0:
            raise AssertionError(f"{tag}: keep sets differ with equal masks")
        print(f"[9] {tag}: vs the default route {n_flips} pairs decided "
              f"otherwise (within {MASK_EPS}), keep sets "
              f"{'equal' if same else 'differ'} ({int(ref[1].sum())} kept)")
    return res


def check_scatter_tiled(torch, dev):
    """Phase 10: the sorted-run scatter-max kernel (K1') vs its plain
    version, the atomic kernel and `scatter_reduce_` at the Waymo and
    nuScenes shapes (signed f32), in bf16 and int8 at the Waymo shape, and
    with every point in one pillar."""
    from pillarnet_lts_torch.apis import load_config
    from pillarnet_lts_torch.datasets import synth_points_realistic
    from pillarnet_lts_torch.ops.scatter import (
        pillar_scatter_max, pillar_scatter_max_tiled, scatter_max_tiled_plain)
    from pillarnet_lts_torch.ops.voxelize import PillarSpec, voxelize_points

    modes, err = {}, 0.0
    for tag, path in (("waymo", WAYMO), ("nuscenes", FLAGSHIP)):
        cfg = load_config(path)
        pc_range = cfg["point_cloud_range"]
        spec = PillarSpec(cfg["pillar_size"], tuple(pc_range))
        H, W = spec.height, spec.width
        pts, msk = synth_points_realistic(
            1, int(cfg["data"]["max_points"]), pc_range, seed=101,
            nsweeps=cfg.get("nsweeps", 10))
        feats, ids, valid = voxelize_points(
            torch.from_numpy(pts).to(dev), torch.from_numpy(msk).to(dev), spec)
        g = torch.Generator().manual_seed(1)
        w = (torch.randn(32, feats.shape[-1], generator=g) * 0.5).to(dev)
        x = torch.nn.functional.linear(feats, w).contiguous()  # signed
        args = (x, ids, valid, H, W)
        out = pillar_scatter_max_tiled(*args)
        library = scatter_library(torch, x, ids, valid, H * W)
        lib = (library()[:, :H * W].reshape(out[0].shape), out[1])
        for name, want in (("plain", scatter_max_tiled_plain(*args)),
                           ("the atomic kernel",
                            pillar_scatter_max(*args, nonneg=False)),
                           ("scatter_reduce_", lib)):
            err = max(err, check_scatter_equal(
                torch, f"pillar_scatter_max_tiled ({tag}) vs {name}", out,
                want, by_value=True))
        modes[tag] = scatter_times(
            torch, f"[10] K1' {tag} {tuple(x.shape)} -> {H}x{W}, equal by "
            f"value to plain, K1 and scatter_reduce_, {int(out[1].sum())} "
            f"pillars occupied", lambda: pillar_scatter_max_tiled(*args),
            lambda: scatter_max_tiled_plain(*args), x, ids, valid, out,
            F32_OPS)
        if tag != "waymo":
            continue
        for dtype in (torch.bfloat16, torch.int8):
            xd = (x.relu() * 20).round().clamp(0, 127).to(dtype) \
                if dtype == torch.int8 else x.to(dtype)
            a2 = (xd, ids, valid, H, W)
            got = pillar_scatter_max_tiled(*a2)
            err = max(err, check_scatter_equal(
                torch, f"pillar_scatter_max_tiled ({tag}, {dtype})", got,
                scatter_max_tiled_plain(*a2), by_value=True))
            modes[f"waymo_{str(dtype)[6:]}"] = scatter_times(
                torch, f"[10] K1' {tag} {dtype}, equal by value to plain",
                lambda: pillar_scatter_max_tiled(*a2),
                lambda: scatter_max_tiled_plain(*a2), xd, ids, valid, got,
                F32_OPS)
        # the longest run: every point in one pillar, walked by one group
        a1 = (x, one_pillar(torch, ids, W, H), valid, H, W)
        got = pillar_scatter_max_tiled(*a1)
        err = max(err, check_scatter_equal(
            torch, "pillar_scatter_max_tiled one pillar", got,
            scatter_max_tiled_plain(*a1), by_value=True))
        modes["one_pillar_waymo"] = scatter_times(
            torch, f"[10] K1' {tag}, all {int(valid.sum())} points in one "
            f"pillar, equal by value to plain",
            lambda: pillar_scatter_max_tiled(*a1),
            lambda: scatter_max_tiled_plain(*a1), x, a1[1], valid, got,
            F32_OPS, iters=3)
    return {"max_abs_err": err, "modes": modes}


def serve_waymo(torch, dev, card):
    """Phases 11-12: the Waymo config as a server on the default route,
    then with the sorted-run scatter-max, then also with the mask kernel.
    Returns the launch counts of phase 12, the corners that phase 11's
    first request handed K2 and the (boxes, thresh) that phase 12's last
    request handed K3."""
    from pillarnet_lts_torch.datasets import synth_points_realistic
    from pillarnet_lts_torch.apis import (
        build_model_from_cfg, load_config, spread_head_outputs)
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.ops import _kernels, nms, scatter
    from pillarnet_lts_torch.runtime.serving import ServingPipeline

    cfg = load_config(WAYMO)
    n, pc_range = int(cfg["data"]["max_points"]), cfg["point_cloud_range"]
    posts = cfg["test_cfg"]["nms"]["nms_post_max_size"]
    post = sum(posts)
    model = build_model_from_cfg(cfg, device=dev, seed=0)
    clouds = [synth_points_realistic(1, n, pc_range, seed=200 + s,
                                      nsweeps=cfg["nsweeps"])
              for s in range(13)]
    calib = synth_points_realistic(1, n, pc_range, seed=99, nsweeps=1)
    spread_head_outputs(model, torch.from_numpy(calib[0]).to(dev),
                        torch.from_numpy(calib[1]).to(dev))
    test_cfg = model.processed_test_cfg()
    if test_cfg["nms"]["nms_iou_threshold"] != [list(WAYMO_THRESH)]:
        raise AssertionError(f"per-class params not regrouped: {test_cfg}")

    def serve(pipe, cloud, kernels, tag):
        before = dict(_kernels.LAUNCHES)
        t0 = time.perf_counter()
        det = list(pipe.map([(torch.from_numpy(cloud[0]).to(dev),
                              torch.from_numpy(cloud[1]).to(dev))]))[0]
        dt = (time.perf_counter() - t0) * 1e3
        for name, count in _kernels.LAUNCHES.items():
            if (count > before[name]) != (name in kernels):
                raise AssertionError(f"{tag}: {name} launched="
                                     f"{count > before[name]}")
        if det["box3d_lidar"].shape != (1, post, 7) or not (
                np.isfinite(det["box3d_lidar"]).all()
                and np.isfinite(det["scores"]).all()):
            raise AssertionError(f"{tag}: bad detections")
        return det, dt

    # phase 11: default route (atomic scatter-max, overlap kernel)
    infer = make_infer_fn(model, test_cfg)
    pipe = ServingPipeline(infer, depth=1)
    torch.cuda.reset_peak_memory_stats(dev)
    _kernels.reset_launches()
    lat, dets = [], []
    for i, cloud in enumerate(clouds):
        def request():
            return serve(pipe, cloud, {"pillar_scatter_max",
                                       "rotated_overlap"},
                         f"waymo request {i}")

        if i == 0:  # a warm-up request: record what it hands K2
            (det, dt), k2_calls = capture_overlap(request)
        else:
            det, dt = request()
        dets.append(det)
        if i >= 3:
            lat.append(dt)
    launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    starts = np.cumsum([0] + posts)
    per_class = [[int(d["mask"][0, starts[k]:starts[k + 1]].sum())
                  for k in range(3)] for d in dets]
    for k in range(3):
        if min(c[k] for c in per_class) == 0:
            raise AssertionError(f"class {k} kept no box on some request")
        labels = np.concatenate([d["label_preds"][0, starts[k]:starts[k + 1]]
                                 [d["mask"][0, starts[k]:starts[k + 1]]]
                                 for d in dets])
        if not (labels == k).all():
            raise AssertionError(f"class {k} slots hold other labels")
    q = statistics.quantiles(lat, n=10)
    print(f"[11] waymo pillarnet34_waymo bs=1, {len(lat)} timed requests "
          f"(after 3 warm-up), host-synced latency: p50 "
          f"{statistics.median(lat):.2f} ms, p90 {q[8]:.2f} ms; peak "
          f"allocated {peak / 2**30:.3f} GiB; kept per class (of {posts}) "
          f"first requests {per_class[:3]}, mean "
          f"{np.mean(per_class, axis=0).round(1).tolist()}; launches over "
          f"{len(clouds)} requests {launches}; card: {card}")
    check_no_sync(torch, infer, *on_card(torch, dev, clouds[3]), "11")
    if len(k2_calls) != 1:
        raise AssertionError(f"a Waymo request made {len(k2_calls)} K2 calls")

    # phase 12: the switches, on three of the same clouds
    mask_cfg = dict(test_cfg, nms=dict(test_cfg["nms"], use_mask_kernel=True))
    seen = []

    def make(real):
        def record(boxes, thresh):  # the candidates the mask kernel sees
            out = real(boxes, thresh)
            seen.append((boxes, thresh, out))
            return out
        return record

    _kernels.reset_launches()
    try:
        scatter.set_backend("tiled")
        tiled = ServingPipeline(make_infer_fn(model, test_cfg), depth=1)
        masked = ServingPipeline(make_infer_fn(model, mask_cfg), depth=1)
        with patched(nms, "suppression_matrix", make):
            for i in (3, 7, 11):
                det, dt = serve(tiled, clouds[i],
                                {"pillar_scatter_max_tiled",
                                 "rotated_overlap"}, f"tiled request {i}")
                for key in det:
                    if not np.array_equal(det[key], dets[i][key]):
                        raise AssertionError(f"tiled request {i}: {key} "
                                             f"differs from the default "
                                             f"route's")
                seen.clear()
                det, dt_m = serve(masked, clouds[i],
                                  {"pillar_scatter_max_tiled",
                                   "suppression_mask"},
                                  f"mask-kernel request {i}")
                (boxes, thresh, m_kernel), = seen
                flips = mask_flips(torch, boxes, thresh, m_kernel,
                                   f"waymo request {i}")
                same = all(np.array_equal(det[k], dets[i][k]) for k in det)
                if not same and flips == 0:
                    raise AssertionError(f"mask-kernel request {i}: "
                                         f"detections differ with equal "
                                         f"masks")
                print(f"[12] request {i}: tiled scatter {dt:.2f} ms, "
                      f"detections identical; + mask kernel {dt_m:.2f} ms, "
                      f"{flips} pairs decided otherwise (within "
                      f"{MASK_EPS}), detections "
                      f"{'identical' if same else 'differ'}")
    finally:
        scatter.set_backend("auto")
    launches = dict(_kernels.LAUNCHES)
    print(f"[12] launches over 3 + 3 requests: {launches}")
    return launches, k2_calls[0], (boxes, thresh)


def capture_scatter(request):
    """Run request() with the reader's K1 wrapper recorded: returns its
    result and the (args, kwargs) of its K1 calls."""
    from pillarnet_lts_torch.models.readers import dynamic_pillar_encoder

    calls = []
    with recording(dynamic_pillar_encoder, "pillar_scatter_max", calls):
        return request(), calls


def check_rcnn_detections(det, posts, tag):
    """Phase 14c: padded (1, R, 7) finite boxes, scores in [0, 1], labels
    in {0, 1, 2}, every class keeps a box, kept boxes have positive
    dimensions."""
    R = sum(posts)
    for key, shape in (("box3d_lidar", (1, R, 7)), ("scores", (1, R)),
                       ("label_preds", (1, R)), ("mask", (1, R))):
        if det[key].shape != shape:
            raise AssertionError(f"{tag}: {key} shape {det[key].shape} != "
                                 f"{shape}")
    m = det["mask"].astype(bool)
    if not (np.isfinite(det["box3d_lidar"]).all()
            and np.isfinite(det["scores"]).all()):
        raise AssertionError(f"{tag}: non-finite detections")
    if not ((det["scores"] >= 0) & (det["scores"] <= 1)).all():
        raise AssertionError(f"{tag}: a score outside [0, 1]")
    labels = det["label_preds"][m]
    if not set(np.unique(labels).tolist()) == {0, 1, 2}:
        raise AssertionError(f"{tag}: kept labels {np.unique(labels)}")
    if not (det["box3d_lidar"][m][:, 3:6] > 0).all():
        raise AssertionError(f"{tag}: a kept box without positive dims")
    return int(m.sum())


def rcnn_stage_split(torch, model, cloud, iters=10):
    """Phase 14f: device ms of the first stage (forward, decode, NMS) and
    the second (RoI pooling, heads, decoding, post_process) by CUDA
    events, median of `iters` requests; and the second stage's kernels
    alone (`torch.profiler`, on the last request's first-stage outputs):
    the total, by group, and every kernel."""
    first_ms, second_ms = [], []
    with torch.inference_mode():
        for _ in range(iters):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            first, bev, feats, _ = model.first_stage(*cloud)
            ev[1].record()
            model.post_process(model.second_stage(first, bev, feats))
            ev[2].record()
            torch.cuda.synchronize()
            first_ms.append(ev[0].elapsed_time(ev[1]))
            second_ms.append(ev[1].elapsed_time(ev[2]))
        alone, per = device_ms(lambda: model.post_process(
            model.second_stage(first, bev, feats)))
    groups = group_table([(k, ms, 1) for ms, k in per])
    return {"first_stage_ms": statistics.median(first_ms),
            "second_stage_ms": statistics.median(second_ms),
            "second_stage_alone_ms": alone, "second_stage_groups_ms": groups,
            "second_stage_kernels": [dict(name=k, ms=ms) for ms, k in per]}


def card_vs_cpu(torch, dev, path, tag, edit=None):
    """A demo config (`edit(cfg)` applied) from the same weights and cloud
    on the CPU and on the card: the same kept slots (and, two-stage, the
    same RoI set), labels equal, boxes within RCNN_BOX_TOL m and scores
    within RCNN_SCORE_TOL (phase 14e's tolerances)."""
    from pillarnet_lts_torch.apis import (
        build_model_from_cfg, load_config, spread_head_outputs)
    from pillarnet_lts_torch.datasets import synth_points_realistic
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.runtime.serving import to_host

    cfg = load_config(path)
    if edit is not None:
        edit(cfg)
    cloud = synth_points_realistic(1, cfg["data"]["max_points"],
                                   cfg["point_cloud_range"], seed=7,
                                   nsweeps=1)
    cpu = build_model_from_cfg(cfg, device="cpu", seed=0)
    spread_head_outputs(cpu, *on_card(torch, "cpu", cloud))
    card = build_model_from_cfg(cfg, device=dev, seed=1)
    card.load_state_dict(cpu.state_dict())
    two_stage = not hasattr(cpu, "predict")

    def serve(model, device):  # make_infer_fn's forward + decode
        args = on_card(torch, device, cloud)
        if not two_stage:
            return None, to_host(make_infer_fn(model)(*args))
        with torch.inference_mode():
            out = model(*args)
            return to_host(out), to_host(model.post_process(out))

    (want_out, want), (got_out, got) = serve(cpu, "cpu"), serve(card, dev)
    if two_stage and not np.array_equal(got_out["roi_labels"],
                                        want_out["roi_labels"]):
        raise AssertionError(f"{tag} card vs CPU: the RoI sets differ")
    for key in ("mask", "label_preds"):
        if not np.array_equal(got[key], want[key]):
            raise AssertionError(f"{tag} card vs CPU: {key} differs")
    m = want["mask"].astype(bool)
    r = {"kept": int(m.sum()),
         "box_max_abs": float(np.abs(got["box3d_lidar"][m]
                                     - want["box3d_lidar"][m]).max()),
         "score_max_abs": float(np.abs(got["scores"][m]
                                       - want["scores"][m]).max())}
    if two_stage:
        r["roi_score_max_abs"] = float(np.abs(
            got_out["roi_scores"] - want_out["roi_scores"]).max())
    if r["kept"] < 1 or r["box_max_abs"] > RCNN_BOX_TOL \
            or r["score_max_abs"] > RCNN_SCORE_TOL:
        raise AssertionError(f"{tag} card vs CPU beyond tolerance: {r}")
    print(f"[{tag}] {os.path.basename(path)}{' (edited)' if edit else ''} "
          f"card vs CPU: " + ("RoI set and " if two_stage else "")
          + f"{r['kept']} kept slots equal, labels equal; max |d| box "
          f"{r['box_max_abs']:.3e} m (tolerance {RCNN_BOX_TOL}), score "
          f"{r['score_max_abs']:.3e} ({RCNN_SCORE_TOL})" + (
              f", RoI score {r['roi_score_max_abs']:.3e}" if two_stage
              else ""))
    return r


def rcnn_card_vs_cpu(torch, dev):
    """Phase 14e: the demo two-stage config on the card against the CPU."""
    return card_vs_cpu(torch, dev, RCNN_DEMO, "14e")


def profile_requests(torch, infer, requests, rec, tag):
    """Requests served back to back under `profiled`: kernel time, window,
    busy share, lost events, kernel groups and the top kernels; printed
    beside `rec`'s stage split (`rcnn_stage_split`). Returns the
    record."""
    def serve():
        t0 = time.perf_counter()
        for c in requests:
            infer(*c)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    rows, window, lost = profiled(serve)
    groups = group_table(rows)
    busy = sum(groups.values())
    print(f"[{tag}] device ms by CUDA events (median of 10): first stage "
          f"{rec['first_stage_ms']:.2f}, second stage "
          f"{rec['second_stage_ms']:.2f}; {len(requests)} requests: kernel "
          f"time {busy:.2f} ms in a {window:.2f} ms window (busy "
          f"{100 * busy / window:.1f}%; {lost:.2%} of the device events "
          f"lost); by group: " + ", ".join(
              f"{g} {v:.3f}" for g, v in sorted(groups.items(),
                                                key=lambda x: -x[1])))
    for k, ms, c in rows[:8]:
        print(f"[{tag}]   {ms:9.3f} ms x{c:<5d} {k[:100]}")
    print(f"[{tag}] second stage, kernels alone (profiler, mean of 10): "
          f"{rec['second_stage_alone_ms']:.4f} ms; by group: " + ", ".join(
              f"{g} {v:.4f}" for g, v in sorted(
                  rec["second_stage_groups_ms"].items(),
                  key=lambda x: -x[1])))
    for k in rec["second_stage_kernels"][:10]:
        print(f"[{tag}]   {k['ms']:8.4f} ms {k['name'][:100]}")
    return {"window_ms": window, "kernel_ms": busy, "lost_events": lost,
            "groups_ms": groups,
            "top_kernels": [dict(name=k, ms=ms, count=c) for k, ms, c in
                            rows[:12]]}


def serve_rcnn(torch, dev, card):
    """Phase 14: the two-stage config as a server. Returns the phase's
    record, K1's mode record at the served shape and the (a, b) corners of
    the K2 calls of its first request."""
    from pillarnet_lts_torch.apis import (
        build_model_from_cfg, load_config, spread_head_outputs)
    from pillarnet_lts_torch.datasets import synth_points_realistic
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.models.second_stage import roi_grid_points
    from pillarnet_lts_torch.ops import _kernels
    from pillarnet_lts_torch.ops.scatter import pillar_scatter_max
    from pillarnet_lts_torch.ops.voxelize import scatter_max_to_grid
    from pillarnet_lts_torch.runtime.serving import ServingPipeline

    cfg = load_config(RCNN)
    n, pc_range = int(cfg["data"]["max_points"]), cfg["point_cloud_range"]
    posts = cfg["test_cfg"]["nms"]["nms_post_max_size"]
    model = build_model_from_cfg(cfg, device=dev, seed=0)
    clouds = [synth_points_realistic(1, n, pc_range, seed=300 + s,
                                      nsweeps=1) for s in range(13)]
    spread_head_outputs(model, *on_card(torch, dev, synth_points_realistic(
        1, n, pc_range, seed=99, nsweeps=1)))
    infer = make_infer_fn(model)
    pipe = ServingPipeline(infer, depth=1)

    def request(i):
        before = dict(_kernels.LAUNCHES)
        t0 = time.perf_counter()
        det = list(pipe.map([on_card(torch, dev, clouds[i])]))[0]
        dt = (time.perf_counter() - t0) * 1e3
        for name, count in _kernels.LAUNCHES.items():
            if (count > before[name]) != (name in F32_PATH):
                raise AssertionError(f"two-stage request {i}: {name} "
                                     f"launched={count > before[name]}")
        return det, dt, check_rcnn_detections(det, posts,
                                              f"two-stage request {i}")

    # (a), (c): 3 warm-up + 10 timed requests, counts read just after
    torch.cuda.reset_peak_memory_stats(dev)
    _kernels.reset_launches()
    lat, kept = [], []
    for i in range(len(clouds)):
        if i == 0:  # record what the first request hands K1 and K2
            ((_, dt, k), k2_calls), k1_calls = capture_scatter(
                lambda: capture_overlap(lambda: request(0)))
        else:
            _, dt, k = request(i)
        if i >= 3:
            lat.append(dt)
            kept.append(k)
    launches = {k: _kernels.LAUNCHES[k] for k in sorted(F32_PATH)}
    peak = torch.cuda.max_memory_allocated(dev)
    q = statistics.quantiles(lat, n=10)
    rec = {"requests": len(clouds), "launches": launches,
           "p50_ms": statistics.median(lat), "p90_ms": q[8],
           "peak_allocated_gib": peak / 2**30,
           "mean_kept": statistics.mean(kept), "slots": sum(posts)}
    print(f"[14] two-stage pillarrcnn18_waymo bs=1, {len(lat)} timed "
          f"requests (after 3 warm-up), host-synced latency: p50 "
          f"{rec['p50_ms']:.2f} ms, p90 {rec['p90_ms']:.2f} ms; peak "
          f"allocated {rec['peak_allocated_gib']:.3f} GiB; mean kept "
          f"{rec['mean_kept']:.1f} of {sum(posts)}; launches over "
          f"{len(clouds)} requests {launches}; card: {card}")

    # (b) the RoIs pooled are the single-stage detections
    pts, msk = on_card(torch, dev, clouds[3])
    single = make_infer_fn(model.single_det)(pts, msk)
    with torch.inference_mode():
        out = model(pts, msk)
    valid = single["mask"]
    rois = single["box3d_lidar"] * valid[..., None]
    if not (torch.equal(out["roi_labels"],
                        (single["label_preds"] + 1) * valid)
            and torch.equal(out["roi_scores"], single["scores"] * valid)
            and torch.equal(out["point_coords"], roi_grid_points(rois, 7))):
        raise AssertionError("the pooled RoIs are not single_det's "
                             "detections")
    print(f"[14b] the second stage pooled single_det's {int(valid.sum())} "
          f"detections (+ {int((~valid).sum())} padded slots): labels, "
          f"scores and RoI grids bit-equal")

    # (d) no host sync inside a request
    check_no_sync(torch, infer, *on_card(torch, dev, clouds[4]), "14d")
    # (e)
    rec["card_vs_cpu"] = rcnn_card_vs_cpu(torch, dev)

    # (f) the stages' device time, kernel sums, busy share
    rec.update(rcnn_stage_split(torch, model, on_card(torch, dev, clouds[5])))
    rec["profile_5_requests"] = profile_requests(
        torch, infer, [on_card(torch, dev, c) for c in clouds[6:11]], rec,
        "14f")

    # K1 at the served shape against its plain version
    (args, kwargs), = k1_calls
    got = pillar_scatter_max(*args, **kwargs)
    err = check_scatter_equal(torch, "two-stage K1", got,
                              scatter_max_to_grid(*args))
    x, ids, valid_pts, H, W = args
    k1 = dict(scatter_times(
        torch, f"[14] K1 f32 nonneg {tuple(x.shape)} -> {H}x{W} (the "
        f"two-stage request's), bit-equal, {int(got[1].sum())} of {H * W} "
        f"pillars occupied", lambda: pillar_scatter_max(*args, **kwargs),
        lambda: scatter_max_to_grid(*args), x, ids, valid_pts, got, F32_OPS),
        max_abs_err=err)
    if len(k2_calls) != 2:
        raise AssertionError(f"a two-stage request made {len(k2_calls)} K2 "
                             f"calls (one per task expected)")
    return rec, k1, k2_calls


# phases 13 and 15: training steps, the first untimed (6 since phase 23
# joined the run, to keep it inside its time limit; 10 before)
TRAIN_STEPS, TRAIN_WARMUP = 6, 2
TRAIN_DUPLICATES = 300  # phase 13a: points copied onto others (exact ties)


def params_within_first_adam_step(torch, got, want, names, shifted, lr0,
                                  max_share=5e-3):
    """Every parameter within two first Adam steps (2 lr0) of `want` plus
    rtol = atol = 1e-4, and at most `max_share` (0.5%) of the elements
    outside the names in `shifted` beyond rtol = atol = 1e-4: Adam's first
    step is about lr * sign(g), and a gradient within the rounding of 0
    (all of a BN-shifted bias's) may take either sign. Returns (share,
    max |d|)."""
    bad = total = 0
    worst = 0.0
    for k in names:
        d = (got[k] - want[k]).abs()
        tol = 1e-4 + 1e-4 * want[k].abs()
        if bool((d > 2 * lr0 * 1.0001 + tol).any()):
            raise AssertionError(f"{k}: {d.max().item()} beyond two Adam "
                                 f"steps of {lr0}")
        worst = max(worst, d.max().item())
        if k not in shifted:
            bad += int((d > tol).sum())
            total += d.numel()
    if bad > max_share * total:
        raise AssertionError(f"{bad} of {total} parameters beyond 1e-4")
    return bad / total, worst


def check_pillar_ids(torch, dev, pc_range, pillar_size):
    """Phase 13, first: the pillar ids and validity of the flagship's 4
    calibration clouds (seeds 90-93, 1,048,576 points) and of every pillar
    edge +-1 ulp in x and y, on the card equal to the CPU's (which
    `tests/test_torch_port_train.py` holds equal to jitted JAX)."""
    from pillarnet_lts_torch.datasets import synth_points_realistic
    from pillarnet_lts_torch.ops.voxelize import PillarSpec, voxelize_points

    spec = PillarSpec(pillar_size, tuple(pc_range))
    edge = np.float32(pc_range[0] + np.arange(spec.width + 1) * pillar_size)
    xs = np.concatenate([np.nextafter(edge, np.float32(-np.inf)), edge,
                         np.nextafter(edge, np.float32(np.inf))])
    edges = np.zeros((2, xs.size, 5), np.float32)
    edges[0, :, 0] = edges[1, :, 1] = xs
    inside = np.float32(pc_range[0] + 0.3 * pillar_size)
    edges[0, :, 1] = edges[1, :, 0] = inside
    clouds = [synth_points_realistic(1, N_POINTS, pc_range, seed=s)
              for s in (90, 91, 92, 93)]
    clouds.append((edges, np.ones(edges.shape[:2], bool)))
    n = 0
    for pts, msk in clouds:
        pts, msk = torch.from_numpy(pts), torch.from_numpy(msk)
        _, ids, valid = voxelize_points(pts.to(dev), msk.to(dev), spec)
        _, want_ids, want_valid = voxelize_points(pts, msk, spec)
        if not (torch.equal(ids.cpu(), want_ids)
                and torch.equal(valid.cpu(), want_valid)):
            bad = int((ids.cpu() != want_ids).sum())
            raise AssertionError(f"{bad} pillar ids on the card differ "
                                 f"from the CPU's")
        n += ids.numel()
    print(f"[13] pillar ids of the 4 flagship calibration clouds and "
          f"{edges.shape[1]} pillar-edge points (+-1 ulp) in x and y, "
          f"{n} points: the card's equal the CPU's")


def check_scatter_grad(torch, dev, pc_range, pillar_size):
    """Phase 13a: K1's gradient at the flagship shape (1 x 262,144 x 32 ->
    1440^2, post-ReLU features with TRAIN_DUPLICATES points copied onto
    others): through `pillar_scatter_max`'s registered autograd on the card,
    bit-equal to the same backward over the plain version's grid on the
    card and to the op on the CPU; the forward (the kernel, saving
    for backward) and the backward (`scatter_max_backward`, torch ops)
    timed, the backward's bound from the bytes it must move."""
    from pillarnet_lts_torch.datasets import synth_points_realistic
    from pillarnet_lts_torch.ops import _kernels
    from pillarnet_lts_torch.ops.scatter import (
        pillar_scatter_max, scatter_max_backward)
    from pillarnet_lts_torch.ops.voxelize import (
        PillarSpec, scatter_max_to_grid, voxelize_points)

    spec = PillarSpec(pillar_size, tuple(pc_range))
    H, W = spec.height, spec.width
    pts, msk = synth_points_realistic(1, N_POINTS, pc_range, seed=101)
    feats, ids, valid = voxelize_points(torch.from_numpy(pts).to(dev),
                                        torch.from_numpy(msk).to(dev), spec)
    g = torch.Generator().manual_seed(1)
    w = (torch.randn(32, feats.shape[-1], generator=g) * 0.5).to(dev)
    x = torch.relu(torch.nn.functional.linear(feats, w))
    live = torch.nonzero(valid[0])[:, 0]
    src, dst = live[:TRAIN_DUPLICATES], live[-TRAIN_DUPLICATES:]
    x[0, src] += 0.5
    x[0, dst] = x[0, src]
    ids[0, dst] = ids[0, src]
    x = x.contiguous()
    dgrid = torch.randn((1, H, W, x.shape[-1]), generator=g).to(dev)

    xr = x.clone().requires_grad_(True)
    before = _kernels.LAUNCHES["pillar_scatter_max"]
    grid, occ = pillar_scatter_max(xr, ids, valid, H, W, nonneg=True)
    (dx,) = torch.autograd.grad(grid, xr, dgrid)
    if _kernels.LAUNCHES["pillar_scatter_max"] != before + 1:
        raise AssertionError("the Function did not launch K1 once")
    pgrid, pocc = scatter_max_to_grid(x, ids, valid, H, W)
    want = scatter_max_backward(x, ids, valid, pgrid, dgrid)
    if not (bit_equal(torch, grid, pgrid) and torch.equal(occ, pocc)
            and bit_equal(torch, dx, want)):
        raise AssertionError("K1's gradient differs from the plain "
                             "version's")
    xc = x.cpu().requires_grad_(True)
    gc, _ = pillar_scatter_max(xc, ids.cpu(), valid.cpu(), H, W, nonneg=True)
    (dxc,) = torch.autograd.grad(gc, xc, dgrid.cpu())
    if not bit_equal(torch, dx.cpu(), dxc):
        raise AssertionError("K1's gradient on the card differs from the "
                             "CPU's")
    both = ((dx[0, src] != 0) & (dx[0, dst] != 0)).any(-1)
    if not bool(both.any()):
        raise AssertionError("no tied pair received the gradient")

    fwd = cuda_ms(lambda: pillar_scatter_max(xr, ids, valid, H, W,
                                             nonneg=True))
    grid = grid.detach()

    def backward():
        return scatter_max_backward(x, ids, valid, grid, dgrid)

    bwd = cuda_ms(backward)
    bwd_alone, per = device_ms(backward)
    rows = int(occ.sum()) * x.shape[-1] * x.element_size()
    b = bound(nbytes(x, ids, valid, dx) + 2 * rows, 0, F32_OPS)
    r = {"forward_ms": fwd, "backward_ms": bwd, "backward_alone_ms": bwd_alone,
         "backward_bound_ms": b[0], "backward_bound_by": b[1],
         "tied_pairs_with_gradient": int(both.sum()),
         "max_abs_err": 0.0}
    print(f"[13a] K1 gradient {tuple(x.shape)} -> {H}x{W}, "
          f"{TRAIN_DUPLICATES} duplicated points "
          f"({r['tied_pairs_with_gradient']} tied pairs both with "
          f"gradient): bit-equal to the plain version "
          f"on the card and to the CPU; forward {fwd:.4f} ms, backward "
          f"{bwd:.4f} ms (kernels alone {bwd_alone:.4f} ms; bound "
          f"{b[0]:.4f} ms, {b[1]}); backward kernels: " + "; ".join(
              f"{k.split('(')[0][-50:]} {ms * 1e3:.1f} us"
              for ms, k in per[:4]))
    return r


def train_card_vs_cpu(torch, dev, edit=None, tag="13b"):
    """Phase 13b: one train step of the demo config (`edit(cfg)` applied,
    24d) on the card and on the CPU from the same seeded weights and
    batch: metrics within rtol 1e-4 (`grad_norm` 1e-3), running statistics
    within rtol = atol = 1e-4, the parameters as
    `params_within_first_adam_step`."""
    from pillarnet_lts_torch.apis import (build_model_from_cfg, load_config,
                                          optimizer_from_cfg)
    from pillarnet_lts_torch.datasets import SynthDataset, collate_batch
    from pillarnet_lts_torch.runtime.train_step import (
        batch_to_device, bn_shifted_biases, train_step)

    cfg = load_config(DEMO)
    if edit is not None:
        edit(cfg)
    ds = SynthDataset(cfg, 2, 4096, seed=31)
    batch = collate_batch([ds[0], ds[1]], cfg["data"]["max_points"])
    runs = []
    for d in (dev, torch.device("cpu")):
        model = build_model_from_cfg(cfg, device=d, seed=3)
        opt = optimizer_from_cfg(model, cfg, 10)
        m = train_step(model, opt, batch_to_device(batch, d),
                       cfg["train_cfg"])
        runs.append(({k: float(v) for k, v in m.items()},
                     {k: v.detach().cpu() for k, v in
                      model.state_dict().items()}))
    (mg, sg), (mc, sc) = runs
    rel = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-30) for k in mc}
    for k, r in rel.items():
        if r > (1e-3 if k == "grad_norm" else 1e-4):
            raise AssertionError(f"{tag} card vs CPU {k}: {mg[k]} vs "
                                 f"{mc[k]}")
    params = [n for n, _ in model.named_parameters()]
    for k in sc:
        if k not in params and not torch.allclose(sg[k], sc[k], rtol=1e-4,
                                                  atol=1e-4):
            raise AssertionError(f"{tag} card vs CPU {k}")
    share, worst = params_within_first_adam_step(
        torch, sg, sc, params, set(bn_shifted_biases(model)),
        opt.lr_fn(0))
    print(f"[{tag}] demo config, one step on the card and on the CPU (same "
          f"weights, batch 2): loss {mg['loss']:.6f} / {mc['loss']:.6f}, "
          f"largest metric rel diff {max(rel.values()):.2e} "
          f"({max(rel, key=rel.get)}); running statistics within 1e-4; "
          f"parameters: {share:.2e} beyond 1e-4, max |d| {worst:.2e}")
    return {"metrics_max_rel": max(rel.values()), "params_share": share}


def train_flagship(torch, dev, card):
    """Phase 13c and d: `pillarnet34_nusc` (full width, remat) trained by
    `apis.train_detector` at bs=4 on 4 seeded synthetic scenes with every
    class (262,144 points each): TRAIN_STEPS steps, the first TRAIN_WARMUP
    untimed; every metric finite, K1 launched on every step, the step time
    (host, synced by the metrics' read-back; loader time excluded),
    samples/s and peak memory printed. Then, with deterministic cuDNN, one
    more step on the same scenes from the trained state and the same step
    from the checkpoint in a fresh model: equal; its loss below the first
    step's."""
    import shutil

    from pillarnet_lts_torch.apis import (build_model_from_cfg, load_config,
                                          optimizer_from_cfg, train_detector)
    from pillarnet_lts_torch.datasets import SynthDataset, collate_batch
    from pillarnet_lts_torch.ops import _kernels
    from pillarnet_lts_torch.runtime.checkpoint import (latest_checkpoint,
                                                        load_checkpoint)
    from pillarnet_lts_torch.runtime.hooks import Hook
    from pillarnet_lts_torch.runtime.train_step import (batch_to_device,
                                                        train_step)

    cfg = load_config(FLAGSHIP)
    bs = cfg["data"]["samples_per_gpu"]
    cfg["total_epochs"] = TRAIN_STEPS
    cfg["checkpoint_config"] = dict(interval=TRAIN_STEPS)
    work = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(work, ignore_errors=True)
    ds = SynthDataset(cfg, bs, cfg["data"]["max_points"], seed=200,
                      num_boxes=(10, 21))
    model = build_model_from_cfg(cfg, device=dev, seed=0)
    if not model.backbone_net.remat:
        raise AssertionError("the flagship config trains with remat")

    class K1PerStep(Hook):
        def before_train_iter(self, trainer):
            self.before = _kernels.LAUNCHES["pillar_scatter_max"]

        def after_train_iter(self, trainer):
            n = _kernels.LAUNCHES["pillar_scatter_max"] - self.before
            if n < 1:
                raise AssertionError(f"step {trainer.iter}: K1 not launched")
            counts.append(n)

    counts = []
    with open(FLAGSHIP) as f:
        cfg_text = f.read()
    torch.cuda.reset_peak_memory_stats(dev)
    _kernels.reset_launches()
    trainer = train_detector(model, ds, cfg, work_dir=work,
                             cfg_text=cfg_text, hooks=[K1PerStep()])
    launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    hist = trainer.log_buffer.val_history
    for k, vals in hist.items():
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"non-finite {k}: {vals}")
    step_ms = [(t - d) * 1e3 for t, d in zip(hist["time"], hist["data_time"])]
    timed = step_ms[TRAIN_WARMUP:]
    med = statistics.median(timed)
    print(f"[13c] pillarnet34_nusc training, bs={bs}, remat, "
          f"{TRAIN_STEPS} steps ({TRAIN_WARMUP} untimed): median step "
          f"{med:.1f} ms (min {min(timed):.1f}, max {max(timed):.1f}), "
          f"{bs / med * 1e3:.3f} samples/s, peak allocated "
          f"{peak / 2**30:.3f} GiB; loss {hist['loss'][0]:.3f} -> "
          f"{hist['loss'][-1]:.3f}, grad_norm {hist['grad_norm'][0]:.1f} -> "
          f"{hist['grad_norm'][-1]:.1f}; K1 launches per step {counts}; "
          f"card: {card}")

    torch.backends.cudnn.deterministic = True
    try:
        batch = batch_to_device(collate_batch(
            [ds[i] for i in range(bs)], cfg["data"]["max_points"]), dev)
        path = latest_checkpoint(work)
        ma = train_step(trainer.model, trainer.optimizer, batch,
                        cfg["train_cfg"])
        ma = {k: float(v) for k, v in ma.items()}
        sa = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        fresh = build_model_from_cfg(cfg, device=dev, seed=1)
        opt = optimizer_from_cfg(fresh, cfg, TRAIN_STEPS)
        meta = load_checkpoint(path, fresh, opt)
        mb = {k: float(v) for k, v in train_step(fresh, opt, batch,
                                                 cfg["train_cfg"]).items()}
        sb = fresh.state_dict()
    finally:
        torch.backends.cudnn.deterministic = False
    if meta["epoch"] != TRAIN_STEPS or meta["CLASSES"] != cfg["class_names"]:
        raise AssertionError(f"checkpoint meta {meta['epoch']}, "
                             f"{meta['CLASSES']}")
    exact = ma == mb and all(torch.equal(sa[k], sb[k]) for k in sa)
    worst = max(max(abs(ma[k] - mb[k]) / max(abs(ma[k]), 1e-30) for k in ma),
                max(((sa[k] - sb[k]).abs() / (1 + sa[k].abs())).max().item()
                    for k in sa))
    if worst > 1e-6:
        raise AssertionError(f"resumed step differs: {worst}")
    if not ma["loss"] < hist["loss"][0]:
        raise AssertionError(f"loss did not fall: {hist['loss'][0]} -> "
                             f"{ma['loss']}")
    print(f"[13d] checkpoint {os.path.basename(path)} resumed into a fresh "
          f"model: the next step {'bit-equal' if exact else 'equal'} to the "
          f"unresumed one (largest rel diff {worst:.2e}); loss on the same "
          f"scenes after {TRAIN_STEPS} steps {ma['loss']:.3f} < step 0's "
          f"{hist['loss'][0]:.3f}")
    shutil.rmtree(work, ignore_errors=True)
    return {"config": "configs/pillarnet/pillarnet34_nusc.py",
            "batch": bs, "steps": TRAIN_STEPS, "timed_steps": len(timed),
            "step_ms": step_ms, "median_step_ms": med,
            "samples_per_s": bs / med * 1e3,
            "peak_allocated_gib": peak / 2**30,
            "loss": hist["loss"], "loss_after": ma["loss"],
            "grad_norm": hist["grad_norm"], "k1_launches_per_step": counts,
            "launches": launches, "resume_bit_equal": exact,
            "resume_max_rel": worst}


# phase 15: two-stage training
SAMPLER_R = SAMPLER_G = 500  # phase 15a: RoIs and GT rows per sample
# phase 15a: the card's IoU matrix against the CPU's own. The two devices'
# sin/cos of the corners differ by an ulp, and K2's edge integrals
# (x dy - y dx in world coordinates) scale a corner's error by its
# distance from the origin: one ulp at (52, 41) m moves a 4.56 m^2 overlap
# by 4.9e-4 m^2 (CPU experiment), an IoU near 0.9 by ~1e-4
SAMPLER_IOU_TOL = 1e-3
RCNN_TRAIN_NUDGES = 3  # phase 15c: CPU steps from nudged weights


def gt_rows(rng, B, G, real, extent=30.0):
    """(B, G, 8) GT rows, class last: `real[b]` boxes of classes 1-3 cycled
    with centres in +-extent m, then zero rows (padding, class 0)."""
    gt = np.zeros((B, G, 8), np.float32)
    for b in range(B):
        n = real[b]
        gt[b, :n, :2] = rng.uniform(-extent, extent, (n, 2))
        gt[b, :n, 2] = rng.uniform(-1, 1, n)
        gt[b, :n, 3:6] = rng.uniform(1.0, 4.0, (n, 3))
        gt[b, :n, 6] = rng.uniform(-np.pi, np.pi, n)
        gt[b, :n, 7] = np.arange(n) % 3 + 1
    return gt


def jitter_rois(rng, gt, plan):
    """RoIs drawn around one sample's GT rows (`gt` (G, 8), class last, 0 =
    padding): `plan` = counts of 'fg' (centre moved by up to 5% of the
    dims, dims by 3%, yaw by 0.03: IoU ~0.8-0.95), 'hard' (the footprint
    scaled by 1.5-2.9 about its centre: IoU 0.12-0.44), 'easy' (40-45 m
    away: IoU 0) and 'zero' (padded slots: the zero box, label 0). Labels
    are the source GT's class (random for 'easy'). Returns (rois (R, 7),
    labels (R,))."""
    real = gt[gt[:, 7] > 0]
    rois, labels = [], []
    for kind, n in plan:
        src = real[rng.randint(0, max(len(real), 1), n)] if len(real) else \
            np.zeros((n, 8), np.float32)
        box = src[:, :7].copy()
        lab = src[:, 7].astype(np.int32)
        if kind == "fg":
            box[:, :2] += rng.uniform(-0.05, 0.05, (n, 2)) * box[:, 3:5]
            box[:, 3:6] *= rng.uniform(0.97, 1.03, (n, 3))
            box[:, 6] += rng.uniform(-0.03, 0.03, n)
        elif kind == "hard":
            box[:, 3:5] *= rng.uniform(1.5, 2.9, (n, 1))
        elif kind == "easy":
            box[:, :2] += 40.0 + rng.uniform(0, 5, (n, 2))
            lab = rng.randint(1, 4, n).astype(np.int32)
        else:
            box[:] = 0
            lab[:] = 0
        rois.append(box)
        labels.append(lab)
    return np.concatenate(rois), np.concatenate(labels)


def sampler_inputs(seed):
    """Phase 15a: 4 samples of SAMPLER_R RoIs against SAMPLER_G GT rows
    (mostly padding), the sampler's shape in `pillarrcnn18_waymo`, with
    every quota branch: sample 0 has fewer fg RoIs than the 64-slot fg
    quota, sample 1 more (both with hard and easy background and padded
    slots), sample 2 only fg (no background: fg drawn with replacement),
    sample 3 only hard background (no fg). Returns numpy (rois, scores,
    labels, gt (B, G, 8))."""
    rng = np.random.RandomState(seed)
    R = SAMPLER_R
    plans = [([("fg", 30), ("hard", 200), ("easy", 170), ("zero", 100)], 40),
             ([("fg", 200), ("hard", 150), ("easy", 50), ("zero", 100)], 60),
             ([("fg", R)], 20), ([("hard", R)], 30)]
    gt = gt_rows(rng, len(plans), SAMPLER_G, [n for _, n in plans], 60.0)
    rois, labels = zip(*(jitter_rois(rng, gt[b], plan)
                         for b, (plan, _) in enumerate(plans)))
    labels = np.stack(labels)
    scores = (rng.rand(len(plans), R) * (labels > 0)).astype(np.float32)
    return np.stack(rois), scores, labels, gt


def equal_targets(torch, got, want):
    """Names of the `RoiTargets` fields of got and want that differ in a
    bit."""
    bad = []
    for name, g, w in zip(got._fields, got, want):
        g = g.cpu()
        same = (bit_equal(torch, g, w) if w.dtype == torch.float32
                else torch.equal(g, w))
        if not same:
            bad.append(name)
    return bad


def check_sampler(torch, dev):
    """Phase 15a: the RoI sampler (`proposal_target_layer`, with the IoU
    from K2) on the card under `set_sync_debug_mode("error")`, draws from a
    card generator; one K2 launch. Against the CPU from the same inputs and
    draws: the CPU's own IoU matrix within SAMPLER_IOU_TOL of the card's
    (the box corners' sin/cos may differ by an ulp between the devices), and
    given the card's IoU matrix every field bit-equal; every quota branch
    fires (the counts from the max overlaps); timed on both."""
    from pillarnet_lts_torch.apis import load_config
    from pillarnet_lts_torch.models.roi_heads import proposal_target_layer \
        as ptl
    from pillarnet_lts_torch.ops import _kernels

    cfg = dict(load_config(RCNN)["model"]["roi_head"]["model_cfg"]
               ["TARGET_CONFIG"])
    M = int(cfg["ROI_PER_IMAGE"])
    quota = int(round(cfg["FG_RATIO"] * M))
    rois, scores, labels, gt = (torch.from_numpy(a)
                                for a in sampler_inputs(15))
    B, R = labels.shape
    card = [t.to(dev) for t in (rois, scores, labels, gt)]
    gen = torch.Generator(device=dev).manual_seed(15)
    real_iou, ious = ptl.boxes_iou3d, []

    def recording_iou(a, b):
        ious.append(real_iou(a, b))
        return ious[-1]

    torch.cuda.synchronize()
    before = _kernels.LAUNCHES["rotated_overlap"]
    ptl.boxes_iou3d = recording_iou
    try:
        torch.cuda.set_sync_debug_mode("error")
        draws = ptl.sampler_draws(gen, B, R, M, dev)
        got = ptl.proposal_target_layer(*card, cfg, draws)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        ptl.boxes_iou3d = real_iou
    if _kernels.LAUNCHES["rotated_overlap"] != before + 1:
        raise AssertionError("the sampler did not launch K2 once")
    card_iou = ious[0].cpu()
    cpu_iou = real_iou(rois[..., :7], gt[..., :7])
    iou_err = (card_iou - cpu_iou).abs().max().item()
    if iou_err > SAMPLER_IOU_TOL:
        raise AssertionError(f"the IoU on the card is {iou_err} from the "
                             f"CPU's")
    cpu_draws = ptl.SamplerDraws(*(d.cpu() for d in draws))
    ptl.boxes_iou3d = lambda a, b: card_iou
    try:
        want = ptl.proposal_target_layer(rois, scores, labels, gt, cfg,
                                         cpu_draws)
    finally:
        ptl.boxes_iou3d = real_iou
    bad = equal_targets(torch, got, want)
    if bad:
        raise AssertionError(f"the sampler on the card differs from the "
                             f"CPU in {bad}")
    own = ptl.proposal_target_layer(rois, scores, labels, gt, cfg, cpu_draws)
    own_bad = equal_targets(torch, got, own)

    mo, _ = ptl._match(rois, labels, gt[..., :7], gt[..., -1].long(),
                       bool(cfg["SAMPLE_ROI_BY_EACH_CLASS"]))
    fg = (mo >= min(cfg["REG_FG_THRESH"], cfg["CLS_FG_THRESH"])).sum(-1)
    easy = (mo < cfg["CLS_BG_THRESH_LO"]).sum(-1)
    hard = ((mo < cfg["REG_FG_THRESH"])
            & (mo >= cfg["CLS_BG_THRESH_LO"])).sum(-1)
    counts = [tuple(int(x) for x in c) for c in zip(fg, hard, easy)]
    branches = {
        "fg without replacement, below the quota":
            0 < counts[0][0] < quota and counts[0][1] and counts[0][2],
        "fg without replacement, above the quota":
            counts[1][0] > quota and counts[1][1] and counts[1][2],
        "no background (fg with replacement)": counts[2] == (R, 0, 0),
        "no fg, hard background only": counts[3] == (0, R, 0)}
    if not all(branches.values()):
        raise AssertionError(f"sampler branches {branches}, counts {counts}")
    labels_soft = got.rcnn_cls_labels
    ms = cuda_ms(lambda: ptl.proposal_target_layer(*card, cfg, draws))
    cpu_ms = cuda_ms(lambda: ptl.proposal_target_layer(
        rois, scores, labels, gt, cfg, cpu_draws), iters=3, warmup=1)
    r = {"shape": [B, R, SAMPLER_G, M], "counts_fg_hard_easy": counts,
         "iou_card_vs_cpu_max_abs": iou_err,
         "iou_card_vs_cpu_differ": int((card_iou != cpu_iou).sum()),
         "fields_differing_with_the_cpus_own_iou": own_bad,
         "sampled_fg": [int(x) for x in got.reg_valid_mask.sum(-1).cpu()],
         "ramp_labels": int(((labels_soft > 0) & (labels_soft < 1)).sum()),
         "ms": ms, "cpu_ms": cpu_ms}
    print(f"[15a] RoI sampler {B} x {R} RoIs vs {SAMPLER_G} GT rows -> {M} "
          f"slots, under set_sync_debug_mode('error'), one K2 launch: "
          f"bit-equal to the CPU from the same draws and the card's IoU "
          f"matrix (the CPU's own: max |d| {iou_err:.2e}, "
          f"{r['iou_card_vs_cpu_differ']} of {card_iou.numel()} differ; "
          f"fields then differing: {own_bad or 'none'}); (fg, hard, easy) per "
          f"sample {counts} ({'; '.join(branches)}); sampled fg "
          f"{r['sampled_fg']}, {r['ramp_labels']} soft labels; card "
          f"{ms:.4f} ms (wrapper, CUDA events), CPU {cpu_ms:.2f} ms")
    return r


def rcnn_train_cfg(path, dp_ratio=None):
    from pillarnet_lts_torch.apis import load_config

    cfg = load_config(path)
    if dp_ratio is not None:
        head = cfg["model"]["roi_head"]
        cfg["model"]["roi_head"] = dict(head, model_cfg=dict(
            head["model_cfg"], DP_RATIO=dp_ratio))
    return cfg


@contextlib.contextmanager
def recording_sampler(records):
    """`PillarRCNN`'s `proposal_target_layer` recorded into `records`: for
    each call its K2 launches, its `RoiTargets` (on the device) and the
    (a_quad, b_quad) of its K2 calls (`capture_overlap`)."""
    from pillarnet_lts_torch.models.detectors import pillar_rcnn
    from pillarnet_lts_torch.ops import _kernels

    def make(real):
        def record(*args, **kwargs):
            before = _kernels.LAUNCHES["rotated_overlap"]
            out, calls = capture_overlap(lambda: real(*args, **kwargs))
            records.append((_kernels.LAUNCHES["rotated_overlap"] - before,
                            out, calls))
            return out
        return record

    with patched(pillar_rcnn, "proposal_target_layer", make):
        yield records


def near_gt(gt, u):
    """Boxes jittered about GT rows picked by uniforms u (B, n, 8): the
    centre moved by up to 25% of the dims, the dims scaled by 0.8-1.25,
    the yaw turned by up to 0.25 (IoU ~0.2-0.95), the GT's class, a score
    in [0.3, 1); and whether the sample has a real GT row. Returns (boxes
    (B, n, 7), classes, scores, has (B, 1))."""
    import torch

    B, G = gt.shape[:2]
    count = (gt[..., -1] > 0).sum(-1, keepdim=True)  # real rows first
    pick = (u[..., 0] * count).long().clamp_max(G - 1)
    src = torch.gather(gt, 1, pick[..., None].expand(-1, -1, gt.shape[-1]))
    box = src[..., :7].clone()
    box[..., :2] += (u[..., 1:3] - 0.5) * 0.5 * src[..., 3:5]
    box[..., 3:6] *= 0.8 + 0.45 * u[..., 3:6]
    box[..., 6] += (u[..., 6] - 0.5) * 0.5
    return box, src[..., -1], 0.3 + 0.7 * u[..., 7], count > 0


@contextlib.contextmanager
def proposals_near_gt(torch, n, seed):
    """`PillarRCNN`'s sampler given RoIs whose first n slots in each sample
    are boxes jittered about its real GT rows (`near_gt`), as a trained
    first stage's proposals cluster on the objects; the other slots keep
    the first stage's proposals. The jitter comes from one CPU generator
    seeded `seed`, so the card and the CPU get the same boxes."""
    from pillarnet_lts_torch.models.detectors import pillar_rcnn

    real = pillar_rcnn.proposal_target_layer
    gen = torch.Generator().manual_seed(seed)

    def sample(rois, scores, labels, gt, cfg, draws):
        u = torch.rand(gt.shape[0], n, 8, generator=gen).to(rois.device)
        box, cls, score, has = near_gt(gt, u)
        rois, scores, labels = rois.clone(), scores.clone(), labels.clone()
        rois[:, :n] = torch.where(has[..., None], box, rois[:, :n])
        labels[:, :n] = torch.where(has, cls.to(labels.dtype), labels[:, :n])
        scores[:, :n] = torch.where(has, score, scores[:, :n])
        return real(rois, scores, labels, gt, cfg, draws)

    pillar_rcnn.proposal_target_layer = sample
    try:
        yield
    finally:
        pillar_rcnn.proposal_target_layer = real


@contextlib.contextmanager
def proposals_at_gt(torch, seed, first_call=0):
    """`PillarRCNN`'s sampler given, in every slot, a box jittered about
    one of its sample's real GT rows (`near_gt`), in place of the first
    stage's proposals, whose NMS a rounding can tip at a near tie. Call
    k's jitter is drawn for the global batch from a CPU generator seeded
    (seed, first_call + k), each rank keeping its rows
    (`parallel.mesh.rank_rows`): the rows one process gets, so the
    sampler sees the same proposals in both runs."""
    from pillarnet_lts_torch.models.detectors import pillar_rcnn
    from pillarnet_lts_torch.parallel.mesh import rank_rows

    real = pillar_rcnn.proposal_target_layer
    calls = [first_call]

    def sample(rois, scores, labels, gt, cfg, draws):
        gen = torch.Generator().manual_seed(seed * 1000 + calls[0])
        calls[0] += 1
        u = rank_rows(lambda size: torch.rand(size, generator=gen),
                      gt.shape[0], rois.shape[1], 8).to(rois.device)
        box, cls, score, has = near_gt(gt, u)
        if not bool(has.all()):
            raise AssertionError("a sample without GT")
        return real(box, score, cls.to(labels.dtype), gt, cfg, draws)

    pillar_rcnn.proposal_target_layer = sample
    try:
        yield
    finally:
        pillar_rcnn.proposal_target_layer = real


def grad_groups(name):
    """The module group of a parameter: the first stage's part
    (`single_det.backbone_net`, ...) or the second stage's module."""
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] == "single_det" else parts[0]


def grad_diffs(torch, got, want):
    """Per module group ||got - want|| / ||want|| over its parameters'
    gradients, and the leaf with the largest ||got - want||."""
    groups, worst = {}, (0.0, "", 0.0)
    for n, w in want.items():
        d = float((got[n] - w).double().norm())
        acc = groups.setdefault(grad_groups(n), [0.0, 0.0])
        acc[0] += d * d
        acc[1] += float(w.double().norm()) ** 2
        if d > worst[0]:
            worst = (d, n, d / max(float(w.norm()), 1e-30))
    return ({g: math.sqrt(d / max(r, 1e-60)) for g, (d, r) in groups.items()},
            worst)


def rcnn_train_card_vs_cpu(torch, dev, variant=None, tag="15c",
                           nudges=RCNN_TRAIN_NUDGES):
    """Phase 15c (23b with a second-stage `variant`, `rcnn_variant`, and
    `nudges` nudged runs): one train step of `pillarrcnn18_demo` (dropout
    off) on the card and on the CPU from the same weights (first-stage
    head spread),
    batch and draws (one CPU generator seed; the card's draws are copied
    from it), with a fifth of the RoI slots near the GT
    (`proposals_near_gt`) so that the sampler's fg path and the regression
    loss run: the sampled RoI labels and masks equal, RoIs within
    RCNN_BOX_TOL m, running statistics within rtol = atol = 1e-4. The
    two-stage step's gradient is sensitive to rounding, so the metrics and
    parameters are held to the CPU's own spread, measured in this run: the
    CPU step again from the weights times 1 + 1e-6 N(0, 1)
    (RCNN_TRAIN_NUDGES draws), each of which must sample the same RoI
    labels and masks, and RoIs within RCNN_BOX_TOL m, as the unnudged CPU
    run (the spread is then one of rounding, not of other data). Each
    metric within max(2 x its largest nudged difference, rtol 1e-4;
    `grad_norm` 1e-3); every parameter within two first Adam steps, and at
    most max(2 x the nudged runs' share, 0.5%) beyond 1e-4. The gradients'
    differences by module group and the leaf that moves most are
    reported for the card and for the nudged runs."""
    from pillarnet_lts_torch.apis import (build_model_from_cfg,
                                          optimizer_from_cfg, rcnn_variant,
                                          spread_head_outputs)
    from pillarnet_lts_torch.datasets import SynthDataset, collate_batch
    from pillarnet_lts_torch.runtime.train_step import (
        batch_to_device, bn_shifted_biases, train_step)

    cfg = rcnn_train_cfg(RCNN_DEMO, dp_ratio=0.0)
    if variant:
        cfg["model"] = rcnn_variant(cfg["model"], variant)
    near = sum(cfg["test_cfg"]["nms"]["nms_post_max_size"]) // 5
    ds = SynthDataset(cfg, 2, 4096, seed=31)
    batch = collate_batch([ds[0], ds[1]], cfg["data"]["max_points"])
    cpu = build_model_from_cfg(cfg, device="cpu", seed=3)
    b_cpu = batch_to_device(batch, "cpu")
    spread_head_outputs(cpu, b_cpu["points"], b_cpu["points_mask"])
    state = {k: v.clone() for k, v in cpu.state_dict().items()}
    params = [n for n, _ in cpu.named_parameters()]
    g = torch.Generator().manual_seed(16)
    nudged = [{k: v * (1 + 1e-6 * torch.randn(v.shape, generator=g))
               if k in params else v for k, v in state.items()}
              for _ in range(nudges)]
    runs = []
    for d, weights in [(dev, state), (torch.device("cpu"), state)] + [
            (torch.device("cpu"), w) for w in nudged]:
        model = build_model_from_cfg(cfg, device=d, seed=4)
        model.load_state_dict(weights)
        opt = optimizer_from_cfg(model, cfg, 10)
        records = []
        with proposals_near_gt(torch, near, 17), recording_sampler(records):
            m = train_step(model, opt, batch_to_device(batch, d),
                           cfg["train_cfg"], torch.Generator().manual_seed(5))
        runs.append(({k: float(v) for k, v in m.items()},
                     {k: v.detach().cpu() for k, v in
                      model.state_dict().items()}, records[0][1],
                     {n: p.grad.detach().cpu() for n, p in
                      model.named_parameters() if p.grad is not None}))
    (mg, sg, tg, gg), (mc, sc, tc, gc) = runs[:2]

    def same_targets(t, tag):
        for name in ("roi_labels", "reg_valid_mask"):
            if not torch.equal(getattr(t, name).cpu(), getattr(tc, name)):
                raise AssertionError(f"{tag}: sampled {name} differ from "
                                     f"the CPU run's")
        err = (t.rois.cpu() - tc.rois).abs().max().item()
        if err > RCNN_BOX_TOL:
            raise AssertionError(f"{tag}: sampled RoIs {err} m from the CPU "
                                 f"run's")
        return err

    roi_err = same_targets(tg, "card vs CPU")
    nudge_roi_err = max(same_targets(t, f"nudged CPU run {i}")
                        for i, (_, _, t, _) in enumerate(runs[2:]))
    if mc["roi_reg_loss_task0"] == 0:
        raise AssertionError("no fg RoI sampled: the regression loss is 0")

    def rel(a, b):
        return {k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for k in b
                if a[k] != 0 or b[k] != 0}

    card = rel(mg, mc)
    spread = {k: max(rel(m, mc).get(k, 0.0) for m, _, _, _ in runs[2:])
              for k in card}
    tol = {k: max(2 * spread[k], 1e-3 if k == "grad_norm" else 1e-4)
           for k in card}
    for k, r in card.items():
        if r > tol[k]:
            raise AssertionError(f"card vs CPU {k}: {mg[k]} vs {mc[k]} "
                                 f"(rel {r:.2e}, tolerance {tol[k]:.2e})")
    for k in sc:
        if k not in params and not torch.allclose(sg[k], sc[k], rtol=1e-4,
                                                  atol=1e-4):
            raise AssertionError(f"card vs CPU {k}")
    shifted, lr0 = set(bn_shifted_biases(model)), opt.lr_fn(0)
    own = max(params_within_first_adam_step(torch, s, sc, params, shifted,
                                            lr0, max_share=1.0)[0]
              for _, s, _, _ in runs[2:])
    share, worst = params_within_first_adam_step(
        torch, sg, sc, params, shifted, lr0, max_share=max(2 * own, 5e-3))
    kept = {n: v for n, v in gc.items() if n not in shifted}
    card_groups, card_leaf = grad_diffs(torch, gg, kept)
    nudge = [grad_diffs(torch, gr, kept) for _, _, _, gr in runs[2:]]
    nudge_groups = {k: max(gr[k] for gr, _ in nudge) for k in card_groups}
    nudge_leaf = max((lf for _, lf in nudge), key=lambda lf: lf[0])
    group_norm = {}
    for n, v in kept.items():
        group_norm[grad_groups(n)] = group_norm.get(grad_groups(n), 0.0) \
            + float(v.double().norm()) ** 2
    group_norm = {k: math.sqrt(v) for k, v in group_norm.items()}
    worst_k = max(card, key=lambda k: card[k] / tol[k])
    r = {"metrics_rel": card, "metrics_cpu_spread": spread,
         "params_share": share, "params_cpu_spread_share": own,
         "roi_max_abs_m": roi_err, "nudged_roi_max_abs_m": nudge_roi_err,
         "near_gt_slots": near, "sampled_fg": int(tc.reg_valid_mask.sum()),
         "rois_real": int((tc.roi_labels > 0).sum()),
         "grad_norm_by_group": group_norm,
         "grad_rel_by_group": card_groups,
         "grad_rel_by_group_cpu_spread": nudge_groups,
         "grad_worst_leaf": {"name": card_leaf[1], "rel": card_leaf[2]},
         "grad_worst_leaf_cpu_spread": {"name": nudge_leaf[1],
                                        "rel": nudge_leaf[2]},
         "loss": [mg["loss"], mc["loss"]]}
    with_variant = f" with {variant}" if variant else ""
    print(f"[{tag}] pillarrcnn18_demo{with_variant} (dropout off, {near} RoI "
          f"slots per sample near the GT), one step on the card and on the "
          f"CPU (same weights, batch 2, same draws): sampled RoI labels and "
          f"masks equal ({r['rois_real']} real RoIs, {r['sampled_fg']} fg), "
          f"RoIs "
          f"within {roi_err:.2e} m (the {nudges} nudged CPU runs: "
          f"the same labels and masks, RoIs within {nudge_roi_err:.2e} m); "
          f"loss {mg['loss']:.6f} / {mc['loss']:.6f}, roi_reg "
          f"{mg['roi_reg_loss_task0']:.6f} / {mc['roi_reg_loss_task0']:.6f}; "
          f"the closest metric to its tolerance {worst_k} rel "
          f"{card[worst_k]:.2e} (tolerance {tol[worst_k]:.2e}; the CPU's own "
          f"spread under a 1e-6 nudge {spread[worst_k]:.2e}); grad_norm rel "
          f"{card['grad_norm']:.2e} (CPU spread {spread['grad_norm']:.2e}); "
          f"running statistics within 1e-4; parameters: {share:.2e} beyond "
          f"1e-4 (CPU spread {own:.2e}), max |d| {worst:.2e}")
    groups = sorted(group_norm, key=lambda k: -group_norm[k])
    print(f"[{tag}] gradients by module group, BN-shifted biases left out "
          "(CPU norm; card rel diff; nudged CPU rel diff, largest): "
          + "; ".join(f"{k} {group_norm[k]:.4g}, {card_groups[k]:.2e}, "
                      f"{nudge_groups[k]:.2e}" for k in groups))
    print(f"[{tag}] the leaf that moves most: card {card_leaf[1]} (rel "
          f"{card_leaf[2]:.2e}); nudged {nudge_leaf[1]} (rel "
          f"{nudge_leaf[2]:.2e})")
    return r


def train_phases(torch, model, opt, batch, train_cfg, generator):
    """Forward with the losses, backward, optimizer step of one train step,
    each by CUDA events (ms)."""
    from pillarnet_lts_torch.runtime.train_step import step_losses

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    total, _ = step_losses(model, batch, train_cfg, generator)
    ev[1].record()
    opt.zero_grad(set_to_none=True)
    total.backward()
    ev[2].record()
    opt.step()
    ev[3].record()
    torch.cuda.synchronize()
    return {name: ev[a].elapsed_time(ev[b]) for name, a, b in
            (("forward", 0, 1), ("backward", 1, 2), ("optimizer", 2, 3))}


def rcnn_train_run(torch, dev, card, tag, near=0):
    """Phase 15d (near=0: the random-weight first stage's own proposals)
    or 15f (near RoI slots of each sample near its GT,
    `proposals_near_gt`): `pillarrcnn18_waymo` (full width, remat, dropout
    0.3) built from seed 0 and trained by `apis.train_detector` at bs=4 on
    4 seeded synthetic 196,608-point scenes with every class: TRAIN_STEPS
    steps, the first TRAIN_WARMUP untimed; the launch counts reset just
    before; every metric finite (the RCNN and point losses among them); K1
    and K2 launched on every step, K2 in predict and in the sampler
    (counted per step); the sampled fg RoIs per step (with near > 0: fg
    RoIs and a nonzero regression loss on every step); step time,
    samples/s, peak memory. Returns (cfg, dataset, work dir, trainer,
    record, the last step's `recording_sampler` records)."""
    import shutil

    from pillarnet_lts_torch.apis import build_model_from_cfg, train_detector
    from pillarnet_lts_torch.datasets import SynthDataset
    from pillarnet_lts_torch.ops import _kernels
    from pillarnet_lts_torch.runtime.hooks import Hook

    cfg = rcnn_train_cfg(RCNN)
    bs = cfg["data"]["samples_per_gpu"]
    per_image = cfg["model"]["roi_head"]["model_cfg"]["TARGET_CONFIG"][
        "ROI_PER_IMAGE"]
    cfg["total_epochs"] = TRAIN_STEPS
    cfg["checkpoint_config"] = dict(interval=TRAIN_STEPS)
    work = os.path.join(ROOT, "build", f"chip_smoke_train_rcnn_{tag}")
    shutil.rmtree(work, ignore_errors=True)
    ds = SynthDataset(cfg, bs, cfg["data"]["max_points"], seed=400,
                      num_boxes=(10, 21))
    model = build_model_from_cfg(cfg, device=dev, seed=0)
    if not model.single_det.backbone_net.remat:
        raise AssertionError("pillarrcnn18_waymo trains with remat")
    records, per_step = [], []

    class CountPerStep(Hook):
        def before_train_iter(self, trainer):
            self.before = dict(_kernels.LAUNCHES)
            records.clear()

        def after_train_iter(self, trainer):
            n = {k: _kernels.LAUNCHES[k] - self.before[k]
                 for k in ("pillar_scatter_max", "rotated_overlap")}
            sampler = sum(k for k, _, _ in records)
            step = {"k1": n["pillar_scatter_max"], "k2_sampler": sampler,
                    "k2_predict": n["rotated_overlap"] - sampler,
                    "fg": int(sum(int(t.reg_valid_mask.sum())
                                  for _, t, _ in records))}
            if step["k1"] < 1 or step["k2_sampler"] < 1 \
                    or step["k2_predict"] < 1 or (near and step["fg"] < 1):
                raise AssertionError(f"15{tag} step {trainer.iter}: {step}")
            per_step.append(step)

    with open(RCNN) as f:
        cfg_text = f.read()
    torch.cuda.reset_peak_memory_stats(dev)
    _kernels.reset_launches()
    with contextlib.ExitStack() as stack:
        if near:
            stack.enter_context(proposals_near_gt(torch, near, 18))
        stack.enter_context(recording_sampler(records))
        trainer = train_detector(model, ds, cfg, work_dir=work,
                                 cfg_text=cfg_text, hooks=[CountPerStep()])
    launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    hist = trainer.log_buffer.val_history
    for k in ("roi_cls_loss_task0", "roi_reg_loss_task0",
              "point_loss_task0", "roi_cls_loss_task1"):
        if k not in hist:
            raise AssertionError(f"metric {k} missing")
    for k, vals in hist.items():
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"non-finite {k}: {vals}")
    if near and not all(v > 0 for v in hist["roi_reg_loss_task0"]):
        raise AssertionError(f"15{tag}: roi_reg_loss "
                             f"{hist['roi_reg_loss_task0']}")
    step_ms = [(t - d) * 1e3 for t, d in zip(hist["time"], hist["data_time"])]
    timed = step_ms[TRAIN_WARMUP:]
    med = statistics.median(timed)
    traffic = (f"{near} RoI slots per sample near the GT" if near else
               "the random-weight first stage's own proposals")
    print(f"[15{tag}] pillarrcnn18_waymo training, bs={bs}, remat, dropout "
          f"0.3, {traffic}, {TRAIN_STEPS} steps ({TRAIN_WARMUP} untimed): "
          f"median step {med:.1f} ms (min {min(timed):.1f}, max "
          f"{max(timed):.1f}), {bs / med * 1e3:.3f} samples/s, peak "
          f"allocated {peak / 2**30:.3f} GiB; loss {hist['loss'][0]:.3f} -> "
          f"{hist['loss'][-1]:.3f}; roi_cls "
          f"{hist['roi_cls_loss_task0'][0]:.4f} -> "
          f"{hist['roi_cls_loss_task0'][-1]:.4f}, roi_reg "
          f"{hist['roi_reg_loss_task0'][0]:.4f} -> "
          f"{hist['roi_reg_loss_task0'][-1]:.4f}, point "
          f"{hist['point_loss_task0'][0]:.3f} -> "
          f"{hist['point_loss_task0'][-1]:.3f}; per step K1 "
          f"{[s['k1'] for s in per_step]}, K2 in predict "
          f"{[s['k2_predict'] for s in per_step]} and in the sampler "
          f"{[s['k2_sampler'] for s in per_step]}; sampled fg RoIs per step "
          f"{[s['fg'] for s in per_step]} of {bs * per_image}; card: {card}")
    rec = {"config": "configs/pillarrcnn/pillarrcnn18_waymo.py",
           "traffic": traffic, "near_gt_slots": near, "batch": bs,
           "steps": TRAIN_STEPS, "timed_steps": len(timed),
           "step_ms": step_ms, "median_step_ms": med,
           "samples_per_s": bs / med * 1e3, "peak_allocated_gib": peak / 2**30,
           "loss": hist["loss"], "roi_cls_loss": hist["roi_cls_loss_task0"],
           "roi_reg_loss": hist["roi_reg_loss_task0"],
           "point_loss": hist["point_loss_task0"], "per_step": per_step,
           "launches": launches}
    return cfg, ds, work, trainer, rec, list(records)


def train_rcnn(torch, dev, card):
    """Phases 15d, e, b, f. (d) `rcnn_train_run` on the random-weight first
    stage's proposals. (e) With deterministic algorithms, the next step of
    that run and the same step from its checkpoint resumed into a fresh
    model (the same step generator): equal; then one more step split into
    forward / backward / optimizer by CUDA events. (b) Every kernel call of
    step (e) replayed against its plain version: K1 (bs=4) bit-equal to
    `scatter_max_to_grid` and timed as phase 2, K2's two predict calls and
    its sampler call (found by `recording_sampler`) bit-equal as phase 3,
    the sampler's also with 100 RoI rows of each sample zeroed. (f)
    `rcnn_train_run` again with a fifth of the RoI slots near the GT, and
    its last step's sampler K2 call replayed. Returns ({"waymo",
    "waymo_near_gt"} records, K1's replay, K2's replays)."""
    import shutil

    from pillarnet_lts_torch.apis import (build_model_from_cfg,
                                          optimizer_from_cfg)
    from pillarnet_lts_torch.datasets import collate_batch
    from pillarnet_lts_torch.ops.scatter import pillar_scatter_max
    from pillarnet_lts_torch.ops.voxelize import scatter_max_to_grid
    from pillarnet_lts_torch.runtime.checkpoint import (latest_checkpoint,
                                                        load_checkpoint)
    from pillarnet_lts_torch.runtime.train_step import (
        batch_to_device, step_generator, train_step)

    cfg, ds, work, trainer, rec, _ = rcnn_train_run(torch, dev, card, "d")
    bs = cfg["data"]["samples_per_gpu"]

    # (e) the next step of the run and the same step from its checkpoint in
    # a fresh model (the step's generator in both), its kernel calls kept
    batch = batch_to_device(collate_batch(
        [ds[i] for i in range(bs)], cfg["data"]["max_points"]), dev)
    step = trainer.iter
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    records = []
    try:
        path = latest_checkpoint(work)
        with recording_sampler(records):
            (ma, k2_calls), k1_calls = capture_scatter(
                lambda: capture_overlap(lambda: train_step(
                    trainer.model, trainer.optimizer, batch,
                    cfg["train_cfg"], step_generator(0, step, dev))))
        ma = {k: float(v) for k, v in ma.items()}
        sa = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        fresh = build_model_from_cfg(cfg, device=dev, seed=1)
        opt = optimizer_from_cfg(fresh, cfg, TRAIN_STEPS)
        meta = load_checkpoint(path, fresh, opt)
        mb = {k: float(v) for k, v in train_step(
            fresh, opt, batch, cfg["train_cfg"],
            step_generator(0, meta["iter"], dev)).items()}
        sb = fresh.state_dict()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    if (meta["epoch"], meta["iter"]) != (TRAIN_STEPS, step) \
            or meta["CLASSES"] != cfg["class_names"]:
        raise AssertionError(f"checkpoint meta {meta['epoch']}, "
                             f"{meta['iter']}, {meta['CLASSES']}")
    exact = ma == mb and all(torch.equal(sa[k], sb[k]) for k in sa)
    worst = max(max(abs(ma[k] - mb[k]) / max(abs(ma[k]), 1e-30) for k in ma
                    if ma[k] != 0 or mb[k] != 0),
                max(((sa[k] - sb[k]).abs() / (1 + sa[k].abs())).max().item()
                    for k in sa))
    if worst > 1e-6:
        raise AssertionError(f"resumed step differs: {worst}")
    print(f"[15e] checkpoint {os.path.basename(path)} resumed into a fresh "
          f"model: step {step} (the same step generator) "
          f"{'bit-equal' if exact else 'equal'} to the uninterrupted run's "
          f"(largest rel diff {worst:.2e}); loss {ma['loss']:.3f}")
    rec.update(resume_bit_equal=exact, resume_max_rel=worst)
    del fresh, opt, sa, sb

    rec["phase_ms"] = train_phases(torch, trainer.model, trainer.optimizer,
                                   batch, cfg["train_cfg"],
                                   step_generator(0, step + 1, dev))
    print(f"[15d] one more step by CUDA events: forward + losses "
          f"{rec['phase_ms']['forward']:.1f} ms, backward "
          f"{rec['phase_ms']['backward']:.1f}, optimizer "
          f"{rec['phase_ms']['optimizer']:.1f}")
    shutil.rmtree(work, ignore_errors=True)
    del trainer, batch
    torch.cuda.empty_cache()

    # (b) step (e)'s kernel calls against their plain versions
    sampler_calls = [c for _, _, calls in records for c in calls]
    predict_calls = [c for c in k2_calls
                     if not any(c[0] is a for a, _ in sampler_calls)]
    if len(sampler_calls) != 1 or len(predict_calls) != 2 \
            or len(k1_calls) != 1:
        raise AssertionError(
            f"training step {step}: K1 calls {len(k1_calls)}, K2 calls in "
            f"predict {[tuple(a.shape) for a, _ in predict_calls]}, in the "
            f"sampler {[tuple(a.shape) for a, _ in sampler_calls]}")
    (args, kwargs), = k1_calls
    args = tuple(x.detach() if torch.is_tensor(x) else x for x in args)
    got = pillar_scatter_max(*args, **kwargs)
    err = check_scatter_equal(torch, "two-stage training K1", got,
                              scatter_max_to_grid(*args))
    x, ids, valid_pts, H, W = args
    k1 = dict(scatter_times(
        torch, f"[15b] K1 f32 nonneg {tuple(x.shape)} -> {H}x{W} (training "
        f"step {step}'s), bit-equal, {int(got[1].sum())} of "
        f"{x.shape[0] * H * W} pillars occupied",
        lambda: pillar_scatter_max(*args, **kwargs),
        lambda: scatter_max_to_grid(*args), x, ids, valid_pts, got,
        F32_OPS), max_abs_err=err, shape=list(x.shape))
    del got, args, k1_calls
    replays = {f"predict_task{t}": check_overlap(
        torch, f"training step {step}'s predict, task {t} candidates", a, b)
        for t, (a, b) in enumerate(predict_calls)}
    (a, b), = sampler_calls
    zero = [int((q == 0).flatten(-2).all(-1).sum()) for q in (a, b)]
    replays["sampler"] = check_overlap(
        torch, f"the sampler's RoIs vs GT rows of training step {step} "
        f"({zero[0]} zero RoI rows, {zero[1]} zero GT rows)", a, b)
    replays["sampler"]["zero_rows"] = zero
    a0 = a.clone()
    a0[:, -100:] = 0
    replays["sampler_zero_rows"] = check_overlap(
        torch, "the same with the last 100 RoI rows of each sample zeroed",
        a0, b)

    # (f) the same training with RoIs near the GT
    near = sum(cfg["test_cfg"]["nms"]["nms_post_max_size"]) // 5
    _, _, work_f, trainer_f, rec_f, last = rcnn_train_run(
        torch, dev, card, "f", near=near)
    shutil.rmtree(work_f, ignore_errors=True)
    del trainer_f
    (a, b), = [c for _, _, calls in last for c in calls]
    zero = [int((q == 0).flatten(-2).all(-1).sum()) for q in (a, b)]
    replays["sampler_near_gt"] = check_overlap(
        torch, f"the sampler's RoIs vs GT rows of 15f's last step, {near} "
        f"slots per sample near the GT ({zero[0]} zero RoI rows, {zero[1]} "
        f"zero GT rows)", a, b)
    replays["sampler_near_gt"]["zero_rows"] = zero
    torch.cuda.empty_cache()
    return {"waymo": rec, "waymo_near_gt": rec_f}, k1, replays


def train_two_stage(torch, dev, card):
    """Phase 15: two-stage training. Returns its record, K1's replay at
    the training shape and K2's replays."""
    rec = {"sampler": check_sampler(torch, dev),
           "card_vs_cpu": rcnn_train_card_vs_cpu(torch, dev)}
    runs, k1, replays = train_rcnn(torch, dev, card)
    rec.update(runs)
    return rec, k1, replays


# phase 16: evaluation through `pillarnet_lts_torch.tools.dist_test`
EVAL_FRAMES, EVAL_SWEEP_POINTS = 8, 26215  # 16a: frames written; points a .bin
EVAL_REPEAT = 12  # 16a: the info list holds the 8 frames 12 times (96)
LOADER_PASSES = 3  # 16a: passes of the loader alone
EVAL_WAYMO_FRAMES = 4  # 16b
# 16b: GT boxes a Waymo frame, by class: the mean of the Waymo Open
# Dataset's 3D labels (6.1M vehicles, 2.8M pedestrians, 67k cyclists over
# 230k frames; Sun et al., CVPR 2020, Table 2), the cyclists rounded up
WAYMO_GT_COUNTS = (26, 12, 1)
# a config's double-flip TTA, as `apis.with_double_flip` sets it
DOUBLE_FLIP = ("from pillarnet_lts_torch.apis import with_double_flip\n"
               "globals().update(with_double_flip(dict(test_cfg=test_cfg, "
               "data=data)))\n")


def config_file(tmp, name, base, *lines):
    """A config file `{tmp}/{name}.py`: `base` and then `lines`."""
    path = os.path.join(tmp, f"{name}.py")
    with open(path, "w") as f:
        f.write(f"exec(open({base!r}).read())\n" + "".join(lines))
    return path


def eval_config(tmp, base, info, name, double_flip=False, **val):
    """A config file under `tmp`: `base` with its val split read from the
    info pkl `info` (its directory the root), `val`'s keys set, and
    double-flip TTA if asked."""
    extra = "".join(f", {k}={v!r}" for k, v in val.items())
    return config_file(
        tmp, name, base,
        f"data['val'] = dict(data['val'], info_path={info!r}, "
        f"root_path={os.path.dirname(info)!r}{extra})\n",
        DOUBLE_FLIP if double_flip else "")


def spread_checkpoint(torch, config, device, work_dir, seed=0):
    """A port checkpoint of `config`'s model: weights from `seed`, the
    head projections spread (`apis.spread_head_outputs`) on the first
    cloud of its val set so that random weights give detections. Returns
    its path, for `dist_test --checkpoint`."""
    from pillarnet_lts_torch.apis import (build_model_from_cfg, load_config,
                                          spread_head_outputs)
    from pillarnet_lts_torch.datasets import DataLoader, build_dataset
    from pillarnet_lts_torch.runtime.checkpoint import save_checkpoint

    cfg = load_config(config)
    data = cfg["data"]
    batch = next(iter(DataLoader(build_dataset(data["val"]), 1,
                                 num_workers=1,
                                 max_points=data.get("max_points"))))
    model = build_model_from_cfg(cfg, device=device, seed=seed)
    spread_head_outputs(model, *(torch.from_numpy(batch[k][:1]).to(device)
                                 for k in ("points", "points_mask")))
    os.makedirs(work_dir, exist_ok=True)
    return save_checkpoint(work_dir, model,
                           torch.optim.SGD(model.parameters(), lr=0.0), 0,
                           {"epoch": 0, "iter": 0,
                            "CLASSES": cfg["class_names"]})


def repeat_infos(info, times):
    """An info pkl beside `info` that lists its frames `times` times, each
    copy under a token of its own (the same files): a pass long enough to
    leave out its warm-up. Returns its path."""
    import pickle

    with open(info, "rb") as f:
        infos = pickle.load(f)
    out = [dict(i, token=f"{i['token']}_{k}",
                gt_boxes_token=np.array([f"{t}_{k}"
                                         for t in i["gt_boxes_token"]]))
           for k in range(times) for i in infos]
    path = info.replace(".pkl", f"_x{times}.pkl")
    with open(path, "wb") as f:
        pickle.dump(out, f)
    return path


def dist_test_run(torch, args):
    """`tools/dist_test.py`'s main with every launch count set to 0 just
    before; returns its result and the counts just after."""
    from pillarnet_lts_torch.ops import _kernels
    from pillarnet_lts_torch.tools import dist_test

    _kernels.reset_launches()
    out = dist_test.main(args)
    torch.cuda.synchronize()
    return out, dict(_kernels.LAUNCHES)


def captured_run(torch, args, int8=False):
    """`dist_test_run` with its K1 and K2 calls (and K4's, with `int8`)
    recorded: returns (out, launches, k1_calls, k2_calls, k4_calls)."""
    k4 = []
    with (recording_int8_convs(k4) if int8 else contextlib.nullcontext()):
        ((out, launches), k2), k1 = capture_scatter(
            lambda: capture_overlap(lambda: dist_test_run(torch, args)))
    if (len(k1), len(k2), len(k4)) != (
            launches["pillar_scatter_max"], launches["rotated_overlap"],
            launches["int8_conv"] + launches["int8_conv_f32"]):
        raise AssertionError(f"captured {len(k1)} K1, {len(k2)} K2 and "
                             f"{len(k4)} K4 calls of launches {launches}")
    return out, launches, k1, k2, k4


def replay_scatter(torch, calls):
    """Each captured K1 call against `scatter_max_to_grid`, bit-equal, the
    first REPLAY_TIMED timed as phase 2 (wrapper, kernels alone, plain,
    `scatter_reduce_`, bound); returns the per-call records."""
    from pillarnet_lts_torch.ops.scatter import pillar_scatter_max
    from pillarnet_lts_torch.ops.voxelize import scatter_max_to_grid

    recs = []
    for k, (args, kwargs) in enumerate(calls):
        args = tuple(x.detach() if torch.is_tensor(x) else x for x in args)
        got = pillar_scatter_max(*args, **kwargs)
        err = check_scatter_equal(torch, f"K1 call {k}", got,
                                  scatter_max_to_grid(*args))
        x, ids, valid = args[:3]
        rec = dict(max_abs_err=err, shape=[*x.shape, args[3], args[4]])
        if k < REPLAY_TIMED:
            peak = INT8_OPS if x.dtype == torch.int8 else F32_OPS
            rec.update(scatter_times(
                torch, None, lambda: pillar_scatter_max(*args, **kwargs),
                lambda: scatter_max_to_grid(*args), x, ids, valid, got,
                peak))
        recs.append(rec)
    return recs


def replay_overlap(torch, calls, tag):
    """Each captured K2 call against `_pairwise_area_plain`, bit-equal, the
    first REPLAY_TIMED timed as phase 3; returns the per-call records."""
    from pillarnet_lts_torch.ops.iou3d import (_pairwise_area_plain,
                                               convex_intersection_area)

    recs = []
    for k, (a, b) in enumerate(calls):
        if k >= REPLAY_TIMED:
            got, want = (convex_intersection_area(a, b),
                         _pairwise_area_plain(a, b))
            if not bit_equal(torch, got, want):
                raise AssertionError(f"{tag} call {k}: K2 differs from "
                                     f"its plain version")
            recs.append({"shape": list(got.shape), "max_abs_err": (
                (got - want).abs().max().item() if got.numel() else 0.0)})
            continue
        r = check_overlap(torch, f"{tag} call {k}", a, b, quiet=True)
        recs.append({f: r[f] for f in ("shape", "ms", "alone_ms",
                                       "plain_ms", "near_share",
                                       "max_abs_err")}
                    | {"bound_ms": r["bound"][0], "bound_by": r["bound"][1]})
    return recs


def replay_summary(recs):
    """Calls, shapes and the worst error of a pass's replays, with the mean
    and the [min, max] of each time over the timed calls, its bound and
    the near-pair share."""
    out = {"calls": len(recs),
           "timed": sum("ms" in r for r in recs),
           "shapes": sorted({str(r["shape"]) for r in recs}),
           "max_abs_err": max(r["max_abs_err"] for r in recs),
           "bound_by": sorted({r["bound_by"] for r in recs
                               if "bound_by" in r})}
    for k in ("ms", "alone_ms", "plain_ms", "library_ms", "bound_ms",
              "near_share"):
        v = [r[k] for r in recs if k in r]
        if v:
            out[k] = statistics.mean(v)
            out[f"{k}_range"] = [min(v), max(v)]
    return out


def print_replays(tag, name, s):
    print(f"[{tag}] {name}: {s['calls']} calls {', '.join(s['shapes'])}, "
          f"each bit-equal to its plain version; wrapper {s['ms']:.4f} ms "
          f"({s['ms_range'][0]:.4f}-{s['ms_range'][1]:.4f}), kernels alone "
          f"{s['alone_ms']:.4f} ms, plain {s['plain_ms']:.4f} ms, bound "
          f"{s['bound_ms']:.4g} ms ({'/'.join(s['bound_by'])})"
          + (f", scatter_reduce_ {s['library_ms']:.4f} ms"
             if "library_ms" in s else "")
          + (f", near pairs {s['near_share']:.2%}"
             if "near_share" in s else "")
          + f"; means over the first {s['timed']} calls")


def replay_pass(torch, tag, k1, k2, k2_name):
    """K1's and K2's captured calls of one pass replayed and summed up:
    returns ({"k1", "k2"} summaries, {"k1", "k2"} per-call records)."""
    each = {"k1": replay_scatter(torch, k1),
            "k2": replay_overlap(torch, k2, k2_name)}
    summary = {k: replay_summary(v) for k, v in each.items()}
    print_replays(tag, "K1 pillar_scatter_max", summary["k1"])
    print_replays(tag, f"K2 rotated_overlap ({k2_name})", summary["k2"])
    return summary, each


def detection_diff(a, b):
    """(equal, max |d| of boxes and scores) of two {token: detections}."""
    if sorted(a) != sorted(b):
        return False, math.inf
    equal, worst = True, 0.0
    for t in a:
        for k in ("box3d_lidar", "scores", "label_preds"):
            x, y = np.asarray(a[t][k]), np.asarray(b[t][k])
            if x.shape != y.shape:
                return False, math.inf
            equal &= np.array_equal(x, y)
            if x.size and k != "label_preds":
                worst = max(worst, float(np.abs(x - y).max()))
    return equal, worst


def gt_as_detections(infos, class_names):
    """Each frame's GT as its detections, score 1."""
    return {i["token"]: {
        "box3d_lidar": np.asarray(i["gt_boxes"], np.float32),
        "scores": np.ones(len(i["gt_boxes"]), np.float32),
        "label_preds": np.array([class_names.index(str(n))
                                 for n in i["gt_names"]], np.int64),
        "metadata": {"token": i["token"]}} for i in infos}


def expect_launches(tag, got, k1, k2):
    if (got["pillar_scatter_max"], got["rotated_overlap"]) != (k1, k2):
        raise AssertionError(f"{tag}: launches {got}, expected K1 {k1} and "
                             f"K2 {k2}")


def card_ms_per_frame(torch, cfg, ckpt, dataset):
    """The served model's card time a frame at the config's batch: 6
    card-resident batches of `dataset` back to back (CUDA events, host
    launches included), with `ckpt`'s weights."""
    import logging

    from pillarnet_lts_torch.apis import build_model_from_cfg
    from pillarnet_lts_torch.datasets import DataLoader
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.tools.dist_test import load_weights, on_device

    data = cfg["data"]
    loader = DataLoader(dataset, data["samples_per_gpu"], num_workers=2,
                        max_points=data["max_points"])
    batches = [on_device(b, "cuda") for _, b in zip(range(6), loader)]
    model = build_model_from_cfg(cfg, device="cuda")
    load_weights(model, ckpt, logging.getLogger("chip_smoke"))
    infer = make_infer_fn(model)
    ms = cuda_ms(lambda: [infer(*b) for b in batches], iters=3, warmup=1)
    del model, batches
    torch.cuda.empty_cache()
    return ms / (6 * data["samples_per_gpu"])


def eval_nuscenes(torch, card, tmp):
    """Phase 16a. Returns its record, the pipelined pass's launches and
    replays (summaries), the info pkl of the written frames and the spread
    checkpoint."""
    from pillarnet_lts_torch.apis import load_config
    from pillarnet_lts_torch.datasets import DataLoader, build_dataset
    from pillarnet_lts_torch.datasets.synth import write_nuscenes_set

    cfg = load_config(FLAGSHIP)
    t0 = time.perf_counter()
    info = write_nuscenes_set(os.path.join(tmp, "nusc"), EVAL_FRAMES,
                              EVAL_SWEEP_POINTS, cfg["nsweeps"],
                              cfg["class_names"], cfg["point_cloud_range"],
                              seed=160)
    t_write = time.perf_counter() - t0
    path = eval_config(tmp, FLAGSHIP, repeat_infos(info, EVAL_REPEAT),
                       "nusc")
    frames = EVAL_FRAMES * EVAL_REPEAT
    ckpt = spread_checkpoint(torch, path, "cuda", os.path.join(tmp, "ckpt"))
    args = [path, "--checkpoint", ckpt, "--seed", "0", "--work_dir"]
    speed, l_speed = dist_test_run(
        torch, args + [os.path.join(tmp, "nusc_speed"), "--speed_test"])
    pipe, l_pipe, k1, k2, _ = captured_run(
        torch, args + [os.path.join(tmp, "nusc_pipe")])
    bs = cfg["data"]["samples_per_gpu"]
    batches = -(-frames // bs)
    # K1 and K2 once a request (one NMS for the six tasks)
    expect_launches("16a speed test", l_speed, frames, frames)
    expect_launches("16a pipelined", l_pipe, batches, batches)
    replays, each = replay_pass(torch, "16a", k1, k2, "NMS")
    del k1, k2
    torch.cuda.empty_cache()
    equal, diff = detection_diff(speed["detections"], pipe["detections"])
    kept = sum(len(d["scores"]) for d in pipe["detections"].values())
    if not equal:
        raise AssertionError(f"16a: batch 1 and batch {bs} detections "
                             f"differ (max |d| {diff})")
    if kept == 0:
        raise AssertionError("16a: no detections")
    text = pipe["result"]["results"]["nusc"]
    if "mAP:" not in text or "NDS:" not in text:
        raise AssertionError(f"16a: no mAP / NDS in {text!r}")
    dataset = build_dataset(load_config(path)["data"]["val"])
    perfect, _ = dataset.evaluation(
        gt_as_detections(dataset._nusc_infos, cfg["class_names"]),
        device="cuda")
    if "mAP: 1.0000" not in perfect["results"]["nusc"]:
        raise AssertionError(f"16a: GT as detections scored "
                             f"{perfect['results']['nusc']!r}")
    # the loader alone (the config's threads; the files in the page
    # cache), pass by pass, against the card's time a frame at batch bs
    loader_ms = []
    for _ in range(LOADER_PASSES):
        loader = DataLoader(dataset, bs,
                            num_workers=cfg["data"]["workers_per_gpu"],
                            max_points=cfg["data"]["max_points"],
                            drop_last=False)
        t0 = time.perf_counter()
        n = sum(len(b["metadata"]) for b in loader)
        loader_ms.append((time.perf_counter() - t0) / n * 1e3)
    card_ms = card_ms_per_frame(torch, cfg, ckpt, dataset)
    sp, pp = speed["speed"], pipe["speed"]
    rec = {"frames": frames, "distinct_frames": EVAL_FRAMES,
           "points_per_file": EVAL_SWEEP_POINTS,
           "files_per_frame": cfg["nsweeps"], "write_s": t_write,
           "speed_test": {k: sp[k] for k in ("host_ms", "device_ms",
                                             "host_ms_all",
                                             "device_ms_all")},
           "pipelined": {"batch": bs, **pp},
           "card_ms_per_frame_batched": card_ms,
           "loader_ms_per_frame": loader_ms,
           "loader_workers": cfg["data"]["workers_per_gpu"],
           "kept_detections": kept, "speed_vs_pipelined_bit_equal": equal,
           "launches_speed_test": l_speed, "launches_pipelined": l_pipe,
           "replays": replays, "replays_each": each,
           "result": text, "gt_result": perfect["results"]["nusc"]}
    print(f"[16a] pillarnet34_nusc eval over {frames} nuScenes-layout "
          f"frames ({EVAL_FRAMES} written, {cfg['nsweeps']} .bin of "
          f"{EVAL_SWEEP_POINTS} points each), seeded weights, on {card}: "
          f"speed test (batch 1, middle third of {frames}) "
          f"{sp['host_ms']:.2f} ms a frame on the host clock, "
          f"{sp['device_ms']:.2f} ms on CUDA events; pipelined (batch {bs}, "
          f"loader included) {pp['frames_per_s']:.2f} frames/s over the "
          f"pass, {pp['steady_frames_per_s']:.2f} over the middle third of "
          f"its {pp['batches']} batches; the card alone {card_ms:.2f} ms a "
          f"frame at batch {bs}; the loader alone "
          f"({cfg['data']['workers_per_gpu']} threads, page cache) "
          f"{', '.join(f'{t:.2f}' for t in loader_ms)} ms a frame in "
          f"{LOADER_PASSES} passes; K1 / K2 once a request; the two "
          f"passes' {kept} detections bit-equal; "
          f"{text.strip().splitlines()[-1]}; GT as detections: mAP 1")
    return rec, l_pipe, replays, info, ckpt


def eval_waymo(torch, card, tmp):
    """Phase 16b. Returns its record and the evaluator's K2 replays."""
    from pillarnet_lts_torch.apis import load_config
    from pillarnet_lts_torch.datasets import build_dataset
    from pillarnet_lts_torch.datasets.synth import write_waymo_set
    from pillarnet_lts_torch.datasets.waymo import waymo_eval
    from pillarnet_lts_torch.ops import _kernels

    cfg = load_config(WAYMO)
    info = write_waymo_set(os.path.join(tmp, "waymo"), EVAL_WAYMO_FRAMES,
                           cfg["data"]["max_points"], cfg["class_names"],
                           cfg["point_cloud_range"], seed=161,
                           class_counts=WAYMO_GT_COUNTS)
    path = eval_config(tmp, WAYMO, info, "waymo")
    ckpt = spread_checkpoint(torch, path, "cuda",
                             os.path.join(tmp, "waymo_ckpt"))
    calls = []

    def make(real):
        def record(gt, pred, device="cuda"):
            before = _kernels.LAUNCHES["rotated_overlap"]
            out, k2 = capture_overlap(lambda: real(gt, pred, device))
            launched = _kernels.LAUNCHES["rotated_overlap"] - before
            if launched != len(k2) or launched != int(len(gt) > 0
                                                      and len(pred) > 0):
                raise AssertionError(f"16b: an IoU matrix ({len(gt)}, "
                                     f"{len(pred)}) made {launched} "
                                     f"launches")
            calls.extend(k2)
            return out
        return record

    with patched(waymo_eval, "_iou_matrix", make):
        out, launches = dist_test_run(torch, [
            path, "--checkpoint", ckpt, "--seed", "0", "--work_dir",
            os.path.join(tmp, "waymo_out")])
    if not calls:
        raise AssertionError("16b: the evaluator launched no K2")
    each = replay_overlap(torch, calls, "the Waymo evaluator's")
    replays = replay_summary(each)
    print_replays("16b", "K2 rotated_overlap (the Waymo evaluator's GT x "
                  "predictions)", replays)
    dataset = build_dataset(load_config(path)["data"]["val"])
    cpu, _ = dataset.evaluation_native(out["detections"], device="cpu")
    if cpu != out["result"]:
        raise AssertionError(f"16b: card and CPU evaluators differ: "
                             f"{out['result']} vs {cpu}")
    perfect, _ = dataset.evaluation_native(
        gt_as_detections(dataset._waymo_infos, cfg["class_names"]),
        device="cuda")
    if "mAP L1 1.0000 mAPH L1 1.0000" not in perfect["results"]["waymo"]:
        raise AssertionError(f"16b: GT as detections scored "
                             f"{perfect['results']['waymo']!r}")
    text = out["result"]["results"]["waymo"]
    rec = {"frames": EVAL_WAYMO_FRAMES, "points": cfg["data"]["max_points"],
           "gt_per_frame": dict(zip(cfg["class_names"], WAYMO_GT_COUNTS)),
           "launches": launches, "evaluator_launches": len(calls),
           "evaluator_launches_per_frame": len(calls) / EVAL_WAYMO_FRAMES,
           "replays": replays, "replays_each": each,
           "card_equals_cpu": True, "result": text,
           "gt_result": perfect["results"]["waymo"]}
    print(f"[16b] pillarnet34_waymo eval over {EVAL_WAYMO_FRAMES} "
          f"Waymo-layout frames with {sum(WAYMO_GT_COUNTS)} GT boxes each "
          f"{WAYMO_GT_COUNTS}: the evaluator's {len(calls)} K2 calls (one "
          f"per frame and class) each bit-equal to the plain version; card "
          f"and CPU evaluators equal; {text.strip().splitlines()[-1]}; GT "
          f"as detections: AP 1")
    return rec, replays


def eval_double_flip(torch, card, tmp, info, ckpt):
    """Phase 16c. Returns its record and its K1 / K2 replays."""
    from pillarnet_lts_torch.apis import load_config
    from pillarnet_lts_torch.datasets import DataLoader, build_dataset
    from pillarnet_lts_torch.tools import dist_test

    path = eval_config(tmp, FLAGSHIP, repeat_infos(info, EVAL_REPEAT),
                       "nusc_flip", double_flip=True, load_interval=4)
    dataset = build_dataset(load_config(path)["data"]["val"])
    frames = len(dataset)
    if next(iter(DataLoader(dataset, 1, num_workers=1)))[
            "points"].shape[0] != 4:
        raise AssertionError("16c: a frame is not 4 clouds")
    out, launches, k1, k2, _ = captured_run(torch, [
        path, "--checkpoint", ckpt, "--seed", "0", "--speed_test",
        "--work_dir", os.path.join(tmp, "nusc_flip")])
    expect_launches("16c", launches, frames, frames)
    tokens = [i["token"] for i in dataset._nusc_infos]
    if sorted(out["detections"]) != sorted(tokens):
        raise AssertionError("16c: not one detection set a frame")
    kept = sum(len(d["scores"]) for d in out["detections"].values())
    replays, each = replay_pass(torch, "16c", k1, k2, "NMS")
    del k1, k2
    torch.cuda.empty_cache()

    demo = config_file(tmp, "demo_flip", DEMO, DOUBLE_FLIP)
    args = [demo, "--checkpoint", spread_checkpoint(
        torch, demo, "cpu", os.path.join(tmp, "demo_ckpt")), "--seed", "0",
            "--work_dir"]
    got, _ = dist_test_run(torch, args + [os.path.join(tmp, "demo_card")])
    want = dist_test.main(args + [os.path.join(tmp, "demo_cpu"),
                                  "--device", "cpu"])
    g, w = got["detections"], want["detections"]
    r = {"frames": frames, "clouds_per_frame": 4, "kept": kept,
         "speed_test": out["speed"], "launches": launches,
         "replays": replays, "replays_each": each,
         "demo_kept": sum(len(d["scores"]) for d in w.values())}
    if sorted(g) != sorted(w) or any(
            not np.array_equal(g[t]["label_preds"], w[t]["label_preds"])
            for t in w):
        raise AssertionError("16c: demo double-flip card vs CPU: the kept "
                             "detections or their labels differ")
    r["demo_box_max_abs"] = max(float(np.abs(
        g[t]["box3d_lidar"] - w[t]["box3d_lidar"]).max(initial=0))
        for t in w)
    r["demo_score_max_abs"] = max(float(np.abs(
        g[t]["scores"] - w[t]["scores"]).max(initial=0)) for t in w)
    if (r["demo_box_max_abs"] > RCNN_BOX_TOL
            or r["demo_score_max_abs"] > RCNN_SCORE_TOL or not r["demo_kept"]):
        raise AssertionError(f"16c: demo double-flip card vs CPU: {r}")
    sp = out["speed"]
    print(f"[16c] pillarnet34_nusc double-flip over {frames} frames (4 "
          f"clouds each, one detection set each, {kept} kept): "
          f"{sp['device_ms']:.2f} ms a frame on CUDA events, "
          f"{sp['host_ms']:.2f} on the host clock (middle third); demo "
          f"double-flip card vs CPU, the same checkpoint: {r['demo_kept']} "
          f"kept detections and labels equal, max |d| box "
          f"{r['demo_box_max_abs']:.3e} m, score "
          f"{r['demo_score_max_abs']:.3e}")
    return r, replays


def eval_trainer(torch, dev, tmp):
    """Phase 16d."""
    import logging

    from pillarnet_lts_torch.apis import (build_model_from_cfg, load_config,
                                          spread_head_outputs,
                                          train_detector)
    from pillarnet_lts_torch.datasets import SynthDataset, build_dataset

    path = config_file(tmp, "demo_train", DEMO,
                       "data['samples_per_gpu'] = 2\n"
                       "data['max_points'] = 4096\n")
    cfg = load_config(path)

    class Lines(logging.Handler):
        def __init__(self):
            super().__init__()
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    logger, lines = logging.getLogger("chip_smoke.train"), Lines()
    logger.addHandler(lines)
    logger.setLevel(logging.INFO)
    model = build_model_from_cfg(cfg, device=dev, seed=3)
    scene = SynthDataset(cfg, 1, 4096)[0]["points"][None]
    spread_head_outputs(model, torch.from_numpy(scene).to(dev),
                        torch.ones(scene.shape[:2], dtype=torch.bool,
                                   device=dev))
    work = os.path.join(tmp, "demo_run")
    train_detector(model, SynthDataset(cfg, 4, 4096), cfg, logger=logger,
                   work_dir=work,
                   val_dataset=build_dataset(cfg["data"]["val"]))
    logged = [s for s in lines.lines if s.startswith("Evaluation demo")]
    out, _ = dist_test_run(torch, [path, "--checkpoint",
                                   os.path.join(work, "epoch_1.pth"),
                                   "--work_dir", os.path.join(tmp, "demo")])
    want = f"Evaluation demo: {out['result']['results']['demo']}"
    if logged != [want]:
        raise AssertionError(f"16d: Trainer.val logged {logged}, dist_test "
                             f"on its checkpoint {want!r}")
    print(f"[16d] demo Trainer.run([('train', 1), ('val', 1)]) on the card "
          f"logged what dist_test gives on its checkpoint: {want}")
    return {"logged": logged[0]}


def eval_int8(torch, tmp, info):
    """Phase 16e: one batch of 4 frames. Returns its record, its K1 / K2
    replays and its K4 replay (phase 6's record)."""
    path = eval_config(tmp, FLAGSHIP_INT8, info, "nusc_int8", load_interval=2)
    ckpt = spread_checkpoint(torch, path, "cuda",
                             os.path.join(tmp, "int8_ckpt"))
    out, launches, k1, k2, k4 = captured_run(torch, [
        path, "--int8", "--checkpoint", ckpt, "--seed", "0", "--work_dir",
        os.path.join(tmp, "nusc_int8")], int8=True)
    dets = out["detections"]
    # K1 in the calibration forward and in the request
    if len(dets) != EVAL_FRAMES // 2 or (
            launches["pillar_scatter_max"], launches["rotated_overlap"]) \
            != (2, 1) or launches["int8_conv"] < 1:
        raise AssertionError(f"16e: {len(dets)} frames, launches {launches}")
    if not all(np.isfinite(d["box3d_lidar"]).all() for d in dets.values()):
        raise AssertionError("16e: non-finite int8 detections")
    replays, _ = replay_pass(torch, "16e", k1, k2, "NMS")
    conv = check_int8_conv(torch, k4, phase="16e")
    del k1, k2, k4
    torch.cuda.empty_cache()
    text = out["result"]["results"]["nusc"]
    print(f"[16e] dist_test --int8 over {len(dets)} frames (one batch): "
          f"launches {launches}; {text.strip().splitlines()[-1]}")
    return ({"frames": len(dets), "launches": launches, "result": text,
             "replays": replays, "int8_conv": conv}, replays, conv)


def evaluate(torch, dev, card):
    """Phase 16: evaluation. Returns its record, K1's and K2's launches of
    the nuScenes eval pass, and every pass's replays ({"k1": {pass:
    summary}, "k2": {pass: summary}, "k4": phase 6's record of 16e})."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="pillarnet_eval_") as tmp:
        rec, replays = {}, {"k1": {}, "k2": {}}
        rec["nuscenes"], launches, r, info, ckpt = eval_nuscenes(
            torch, card, tmp)
        replays["k1"]["16a_pipelined"] = r["k1"]
        replays["k2"]["16a_pipelined"] = r["k2"]
        rec["waymo"], replays["k2"]["16b_waymo_evaluator"] = eval_waymo(
            torch, card, tmp)
        rec["double_flip"], r = eval_double_flip(torch, card, tmp, info,
                                                 ckpt)
        replays["k1"]["16c_double_flip"] = r["k1"]
        replays["k2"]["16c_double_flip"] = r["k2"]
        rec["trainer"] = eval_trainer(torch, dev, tmp)
        rec["int8"], r, replays["k4"] = eval_int8(torch, tmp, info)
        replays["k1"]["16e_int8"] = r["k1"]
        replays["k2"]["16e_int8"] = r["k2"]
    return rec, launches, replays


# phase 17: training as the configs write it (augmentations, GT-AUG)
AUG_FRAMES = 16  # 17a: Waymo-layout frames written, one epoch of 4 steps
# 17a: each frame's GT (VEHICLE, PEDESTRIAN, CYCLIST), a Waymo frame's mean
# WAYMO_GT_COUNTS spread from sparse scenes, below GT-AUG's 15 / 10 / 10
# quotas, to dense ones above them
AUG_GT_COUNTS = list(zip(
    (4, 8, 12, 16, 20, 22, 24, 26, 26, 28, 30, 32, 36, 40, 44, 48),
    (2, 4, 6, 8, 10, 11, 12, 12, 12, 12, 13, 14, 16, 18, 20, 22),
    (0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2)))
DATA_ROOT = "data/Waymo/"  # the Waymo configs' relative data_root


def rooted(obj, tmp):
    """A copy of a config value with every path under DATA_ROOT moved
    under directory `tmp`."""
    if isinstance(obj, dict):
        return {k: rooted(v, tmp) for k, v in obj.items()}
    if isinstance(obj, list):
        return [rooted(v, tmp) for v in obj]
    if isinstance(obj, str) and obj.startswith(DATA_ROOT):
        return os.path.join(tmp, obj)
    return obj


def augmented_set(tmp, cfg, frames=AUG_FRAMES):
    """`frames` (AUG_FRAMES) Waymo-layout frames of the config's
    `max_points` points with AUG_GT_COUNTS' boxes a class (the first
    `frames` rows), under `tmp` laid out as the config's `data_root`, the
    infos under the config's train name, and the GT database the port
    builds over them at the config's `db_info_path`. Returns (seconds to
    write, seconds to build, database infos)."""
    from pillarnet_lts_torch.datasets.synth import write_waymo_set
    from pillarnet_lts_torch.datasets.utils import (
        create_groundtruth_database)

    root = os.path.join(tmp, DATA_ROOT)
    train = cfg["data"]["train"]
    t0 = time.perf_counter()
    info = write_waymo_set(root, frames, cfg["data"]["max_points"],
                           cfg["class_names"], cfg["point_cloud_range"],
                           seed=170, split="train",
                           class_counts=AUG_GT_COUNTS[:frames])
    os.replace(info, os.path.join(tmp, train["info_path"]))
    t_write = time.perf_counter() - t0
    pre = next(st["cfg"] for st in cfg["train_pipeline"]
               if st["type"] == "Preprocess")
    t0 = time.perf_counter()
    infos = create_groundtruth_database(
        "WaymoDataset", root, os.path.join(tmp, train["info_path"]),
        used_classes=cfg["class_names"],
        dbinfo_path=os.path.join(tmp, pre["db_sampler"]["db_info_path"]))
    return t_write, time.perf_counter() - t0, infos


def timed(fn, sums, key):
    """fn with its host seconds added to sums[key] on every call."""
    def call(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            sums[key] = sums.get(key, 0.0) + time.perf_counter() - t0
    return call


def gt_aug_sampler(dataset):
    """The GT-AUG sampler of a dataset's `Preprocess`."""
    return next(t for t in dataset.pipeline.transforms
                if type(t).__name__ == "Preprocess").db_sampler


@contextlib.contextmanager
def timed_pipeline(dataset):
    """The host seconds of each stage of a dataset's pipeline, of GT-AUG's
    `sample_all` and of `points_in_rbbox` (GT-AUG's cut of the raw
    points), summed into the yielded dict while the context is open."""
    from pillarnet_lts_torch.core.bbox import box_np_ops

    sums, stages = {}, dataset.pipeline.transforms
    sampler, kept = gt_aug_sampler(dataset), list(stages)
    stages[:] = [timed(t, sums, type(t).__name__) for t in kept]
    try:
        with patched(sampler, "sample_all",
                     lambda f: timed(f, sums, "GT-AUG sample_all")), \
                patched(box_np_ops, "points_in_rbbox",
                        lambda f: timed(f, sums, "points_in_rbbox")):
            yield sums
    finally:
        stages[:] = kept


@contextlib.contextmanager
def gt_aug_stats(dataset, class_names):
    """While open, each GT-AUG draw of a dataset's `Preprocess` appends
    ([boxes of each of `class_names`], points) to the yielded list."""
    counts = []

    def make(real):
        def sample_all(*args, **kwargs):
            out = real(*args, **kwargs)
            names = np.asarray([] if out is None else out["gt_names"])
            counts.append(([int((names == n).sum()) for n in class_names],
                           0 if out is None else len(out["points"])))
            return out
        return sample_all

    with patched(gt_aug_sampler(dataset), "sample_all", make):
        yield counts


def loader_groups(sample_ms, boxes, dropped):
    """17a's one-thread loader split by what GT-AUG pasted: samples given
    vehicles or pedestrians (their frames below those quotas) and samples
    given only cyclists. Per group: samples, ms a sample, points dropped
    at `max_points` a sample."""
    out = {}
    for group, take in (("vehicles_or_pedestrians", True),
                        ("cyclists_only", False)):
        idx = [i for i, b in enumerate(boxes) if (b[0] + b[1] > 0) == take]
        out[group] = {
            "samples": len(idx),
            "ms_per_sample": (statistics.mean(sample_ms[i] for i in idx)
                              if idx else None),
            "dropped_per_sample": [dropped[i] for i in idx]}
    return out


LOADER_ROUTES = ("native", "numpy", "numpy", "native")  # 17a's passes


def loader_routes(native, loader, routes):
    """One pass of `loader` on each route of `routes` ("native": the host
    library, "numpy": `numpy_route`; `native` None: a tree without the
    library, whose only route is numpy). Returns {"ms_per_sample",
    "cpu_ms_per_sample" (the process's CPU time), "load_avg_1min" (the
    host's, as the pass starts): {route: [one a pass]}}."""
    if native is None and "native" in routes:
        raise AssertionError("no host library: no native route")
    rec = {"ms_per_sample": {}, "cpu_ms_per_sample": {}, "load_avg_1min": {}}
    for route in routes:
        with (numpy_route(native) if route == "numpy" and native
              else contextlib.nullcontext()):
            load = os.getloadavg()[0]
            t0, c0 = time.perf_counter(), time.process_time()
            n = sum(len(b["metadata"]) for b in loader)
            wall, cpu = time.perf_counter() - t0, time.process_time() - c0
        for key, v in (("ms_per_sample", wall / n * 1e3),
                       ("cpu_ms_per_sample", cpu / n * 1e3),
                       ("load_avg_1min", load)):
            rec[key].setdefault(route, []).append(v)
    return rec


def loader_passes(tree, tmp, *routes):
    """`python3 chip_smoke.py --loader-passes TREE TMP ROUTE...`: one pass
    of phase 17a's loader on each ROUTE with the package of the checkout
    at TREE, over the set `augmented_set` wrote under TMP; prints one JSON
    line of `loader_routes`' record."""
    sys.path.insert(0, os.path.abspath(tree))
    import pillarnet_lts_torch
    from pillarnet_lts_torch.datasets import DataLoader, build_dataset

    if not pillarnet_lts_torch.__file__.startswith(os.path.abspath(tree)):
        raise AssertionError(f"imported {pillarnet_lts_torch.__file__}")
    try:
        from pillarnet_lts_torch import native
    except ImportError:  # a tree from before the host library
        native = None
    data = rooted(rcnn_train_cfg(RCNN)["data"], tmp)
    loader = DataLoader(build_dataset(data["train"]), data["samples_per_gpu"],
                        shuffle=True, num_workers=data["workers_per_gpu"],
                        max_points=data["max_points"], seed=1)
    rec = loader_routes(native, loader, routes)
    print(json.dumps(dict(rec, threads=data["workers_per_gpu"])))
    return 0


# --loader-compare: a kind of process -> (tree, its passes' routes)
LOADER_KINDS = {"parent": (None, ("numpy",) * 4),
                "this_numpy": (ROOT, ("numpy",) * 4),
                "this": (ROOT, LOADER_ROUTES)}
LOADER_TURNS = ("parent", "this_numpy", "this", "this", "this_numpy",
                "parent") * 2


def loader_compare(parent):
    """`python3 chip_smoke.py --loader-compare PARENT`: phase 17a's loader
    passes on 17a's set (written once, so every read is warm), each kind
    of LOADER_KINDS in processes of its own (`--loader-passes`; the
    parent: the checkout at PARENT), in LOADER_TURNS; prints one JSON line
    {"loader_compare": {kind: [a record a process]}, "card": ...}. Runs
    on the host alone."""
    import tempfile

    sys.path.insert(0, ROOT)
    out = {kind: [] for kind in LOADER_KINDS}
    with tempfile.TemporaryDirectory() as tmp:
        augmented_set(tmp, rcnn_train_cfg(RCNN))
        for kind in LOADER_TURNS:
            tree, routes = LOADER_KINDS[kind]
            tree = tree or os.path.abspath(parent)
            proc = subprocess.run(
                [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                 "--loader-passes", tree, tmp, *routes],
                capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"--loader-passes {tree} exited "
                                     f"{proc.returncode}: "
                                     f"{proc.stderr[-3000:]}")
            out[kind].append(json.loads(proc.stdout.splitlines()[-1]))
            print(f"[loader] {kind}: {out[kind][-1]}", flush=True)
    print(json.dumps({"loader_compare": out, "card": card_line()}))
    return 0


def train_augmented(torch, dev, card, tmp):
    """Phase 17a: `pillarrcnn18_waymo` at full width and depth (bs=4,
    remat, dropout 0.3) with its train pipeline as written (GT-AUG of
    15 / 10 / 10 VEHICLE / PEDESTRIAN / CYCLIST, flips, rotation,
    scaling, translation, shuffle) over AUG_FRAMES written frames, one
    epoch through `apis.train_detector` with the launch counts set to 0
    just before; the loader alone first (one thread, then the config's);
    K1 and K2 (predict and sampler) on every step; the last step's K1 and
    K2 calls replayed bit-equal. Returns (record, launches, K1 and K2
    replay summaries)."""
    from pillarnet_lts_torch import native
    from pillarnet_lts_torch.apis import build_model_from_cfg, train_detector
    from pillarnet_lts_torch.datasets import DataLoader, build_dataset
    from pillarnet_lts_torch.models.readers import dynamic_pillar_encoder
    from pillarnet_lts_torch.ops import _kernels, iou3d
    from pillarnet_lts_torch.runtime.hooks import Hook

    cfg = rcnn_train_cfg(RCNN)
    cfg["total_epochs"] = 1
    t_write, t_db, db = augmented_set(tmp, cfg)
    cfg["data"] = rooted(cfg["data"], tmp)
    data = cfg["data"]
    bs, max_points = data["samples_per_gpu"], data["max_points"]

    # the loader alone: each sample once on one thread, then a pass of the
    # config's threads
    names = cfg["class_names"]
    dataset = build_dataset(data["train"])
    sizes, sample_ms = [], []
    with gt_aug_stats(dataset, names) as counts, \
            timed_pipeline(dataset) as stage_s:
        for i in range(len(dataset)):
            t0 = time.perf_counter()
            sizes.append(len(dataset[i]["points"]))
            sample_ms.append((time.perf_counter() - t0) * 1e3)
    serial_ms = statistics.mean(sample_ms)
    stage_ms = {k: v / len(dataset) * 1e3 for k, v in stage_s.items()}
    loader = DataLoader(dataset, bs, shuffle=True,
                        num_workers=data["workers_per_gpu"],
                        max_points=max_points, seed=1)
    # a pass on each route of the box tests, in turns: the host C++ and
    # the numpy route (the loader's only route before the library), each
    # beside the host's 1-minute load average as it starts
    routes = loader_routes(native, loader, LOADER_ROUTES)
    by_route = routes["ms_per_sample"]
    threaded_ms = by_route["numpy"][0]
    boxes = [c[0] for c in counts]
    pasted = [c[1] for c in counts]
    dropped = [max(0, k - max_points) for k in sizes]
    groups = loader_groups(sample_ms, boxes, dropped)
    if min(map(sum, boxes)) < 1 or not all(
            sum(b[c] for b in boxes) for c in range(len(names))):
        raise AssertionError(f"17a: a sample without GT-AUG boxes or a "
                             f"class never pasted: {boxes}")

    # one epoch through train_detector, the last step's kernel calls kept
    model = build_model_from_cfg(cfg, device=dev, seed=0)
    dataset = build_dataset(data["train"])
    k1_calls, k2_calls, per_step = [], [], []
    steps = len(dataset) // bs

    class LastStep(Hook):
        def before_train_iter(self, trainer):
            self.before = dict(_kernels.LAUNCHES)
            self.stack = contextlib.ExitStack()
            if trainer.iter == steps - 1:
                self.stack.enter_context(recording(
                    dynamic_pillar_encoder, "pillar_scatter_max", k1_calls))
                self.stack.enter_context(recording(
                    iou3d, "convex_intersection_area", k2_calls,
                    keep=lambda a, k: a))

        def after_train_iter(self, trainer):
            self.stack.close()
            n = {k: _kernels.LAUNCHES[k] - self.before[k]
                 for k in ("pillar_scatter_max", "rotated_overlap")}
            if n["pillar_scatter_max"] < 1 or n["rotated_overlap"] < 3:
                raise AssertionError(f"17a step {trainer.iter}: {n}")
            per_step.append(n)

    work = os.path.join(tmp, "work")
    with open(RCNN) as f:
        cfg_text = f.read()
    torch.cuda.reset_peak_memory_stats(dev)
    with gt_aug_stats(dataset, names) as train_counts:
        _kernels.reset_launches()
        trainer = train_detector(model, dataset, cfg, work_dir=work,
                                 cfg_text=cfg_text, hooks=[LastStep()])
        launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    hist = trainer.log_buffer.val_history
    for k, vals in hist.items():
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"17a: non-finite {k}: {vals}")
    if trainer.iter != steps or not os.path.exists(
            os.path.join(work, "epoch_1.pth")):
        raise AssertionError(f"17a: {trainer.iter} steps, no checkpoint")
    step_ms = [(t - d) * 1e3 for t, d in zip(hist["time"], hist["data_time"])]
    med = statistics.median(step_ms[1:])
    del trainer, model
    if (len(k1_calls), len(k2_calls)) != (per_step[-1]["pillar_scatter_max"],
                                          per_step[-1]["rotated_overlap"]):
        raise AssertionError(f"17a: captured {len(k1_calls)} K1 and "
                             f"{len(k2_calls)} K2 calls of {per_step[-1]}")
    replays, _ = replay_pass(torch, "17a", k1_calls, k2_calls,
                             "predict and RoI sampler")
    del k1_calls, k2_calls
    torch.cuda.empty_cache()
    rec = {"config": "configs/pillarrcnn/pillarrcnn18_waymo.py",
           "frames": AUG_FRAMES, "points_per_frame": max_points,
           "gt_per_frame": AUG_GT_COUNTS, "batch": bs,
           "steps": steps, "write_s": t_write, "gt_database_s": t_db,
           "gt_database": {str(k): len(v) for k, v in db.items()},
           "step_ms": step_ms, "median_step_ms_after_first": med,
           "samples_per_s": bs / med * 1e3,
           "data_ms": [d * 1e3 for d in hist["data_time"]],
           "peak_allocated_gib": peak / 2**30, "loss": hist["loss"],
           "loader_ms_per_sample_one_thread": serial_ms,
           "loader_stage_ms_per_sample_one_thread": stage_ms,
           "loader_ms_per_sample_threads": threaded_ms,
           "loader_ms_per_sample_threads_by_route": by_route,
           "loader_cpu_ms_per_sample_threads_by_route":
               routes["cpu_ms_per_sample"],
           "loader_load_avg_1min_by_route": routes["load_avg_1min"],
           "loader_threads": data["workers_per_gpu"],
           "loader_ms_one_thread_by_gt_aug": groups,
           "sampled_boxes_per_sample_by_class": boxes,
           "pasted_points_per_sample": pasted,
           "points_per_sample": sizes, "dropped_at_max_points": dropped,
           "train_sampled_boxes_by_class": [c[0] for c in train_counts],
           "train_pasted_points": [c[1] for c in train_counts],
           "per_step_launches": per_step, "launches": launches,
           "replays": replays}
    print(f"[17a] pillarrcnn18_waymo trained as written (GT-AUG "
          f"15/10/10, flips, rotation, scaling, translation), bs={bs}, "
          f"remat, dropout 0.3, {AUG_FRAMES} written frames of {max_points} "
          f"points (GT a class {AUG_GT_COUNTS}; written "
          f"in {t_write:.1f} s, GT database {rec['gt_database']} in "
          f"{t_db:.1f} s): steps {', '.join(f'{t:.1f}' for t in step_ms)} "
          f"ms, median after the first {med:.1f} ms, {bs / med * 1e3:.3f} "
          f"samples/s, peak allocated {peak / 2**30:.3f} GiB, loss "
          f"{hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f}; the loader "
          f"alone {serial_ms:.1f} ms a sample on one thread ("
          + ", ".join(f"{k} {v:.1f}" for k, v in stage_ms.items())
          + f"), on {data['workers_per_gpu']} threads native "
          f"{[round(v, 2) for v in by_route['native']]}, numpy "
          f"{[round(v, 2) for v in by_route['numpy']]} (process CPU ms a "
          f"sample {routes['cpu_ms_per_sample']}, host load "
          f"{routes['load_avg_1min']}); by what "
          f"GT-AUG pasted {groups}; GT-AUG boxes a sample by class "
          f"{boxes}, points pasted {pasted}, points past max_points "
          f"{dropped}; K1 / K2 a step {per_step}; card: {card}")
    return rec, launches, replays


def train_cli(torch, tmp):
    """Phase 17b: `python -m pillarnet_lts_torch.tools.train` on the demo
    config in a subprocess on the card: exit 0, finite losses, a
    checkpoint."""
    work = os.path.join(tmp, "cli")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "pillarnet_lts_torch.tools.train", DEMO,
         "--work_dir", work, "--seed", "7"], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"17b: the training CLI exited "
                             f"{out.returncode}: {out.stderr[-2000:]}")
    with open(os.path.join(work, "log.json")) as f:
        losses = [json.loads(line)["loss"] for line in f]
    if not losses or not all(math.isfinite(v) for v in losses) \
            or not os.path.exists(os.path.join(work, "epoch_1.pth")):
        raise AssertionError(f"17b: losses {losses}, {os.listdir(work)}")
    print(f"[17b] python -m pillarnet_lts_torch.tools.train "
          f"configs/demo/pillarnet18_demo.py --seed 7 on the card: exit 0 in "
          f"{seconds:.1f} s, loss {losses}, checkpoint epoch_1.pth")
    return {"seconds": seconds, "loss": losses}


def train_as_written(torch, dev, card):
    """Phase 17. Returns its record, 17a's launches and K1 / K2 replays."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="pillarnet_aug_") as tmp:
        t0 = time.perf_counter()
        rec, launches, replays = train_augmented(torch, dev, card, tmp)
        rec["seconds"] = time.perf_counter() - t0
        cli = train_cli(torch, tmp)
    return {"augmented": rec, "cli": cli}, launches, replays


# phase 18: the two-stage model in the precisions users serve, and the
# rest of the config zoo on the card
PRECISION_REQUESTS, PRECISION_WARMUP = 13, 3  # 18a/b: bs=1, untimed first
PRECISION_BATCHES, PRECISION_BS = 3, 4  # 18a/b: batched, untimed first
CALIB_CLOUDS = 4  # 18a: calibration clouds
RCNN_BF16 = RCNN.replace(".py", "_bf16.py")


def precision_path(model, int8):
    """{kernel: launches a request} of a two-stage request: K1 once, K2
    once per task, and (int8 on f32 activations) K4's f32 variant once
    per quantized conv; no other kernel."""
    from pillarnet_lts_torch.models.backbones.base import MaskedConv

    path = {"pillar_scatter_max": 1,
            "rotated_overlap": len(model.single_det.head_net.tasks)}
    if int8:
        path["int8_conv_f32"] = sum(
            1 for m in model.modules() if isinstance(m, MaskedConv)
            and m.quant_ready())
    return path


def serve_precision(torch, dev, card, tag, int8):
    """Phase 18a (`pillarrcnn18_waymo` after `enable_backbone_quant`,
    f32 compute, calibrated on CALIB_CLOUDS clouds) or 18b
    (`pillarrcnn18_waymo_bf16`) at full width as a server: 3 warm-up + 10
    timed requests at bs=1 and 1 warm-up + 2 timed at bs=4 (the first
    call at a new batch size picks its cuDNN algorithms) through
    `ServingPipeline(
    make_infer_fn(model))`, with the launch counts set to 0 just before
    and read just after, every request raising exactly its path's counts
    (`precision_path`); one request under sync debug mode; the K1 and K2
    calls (and, int8, every K4 call) of one request replayed against
    their plain versions; the stage split, kernel groups, busy share and
    peak memory. Returns (record, launches, K1 / K2 replays, K4's
    `check_int8_conv` record or None)."""
    from pillarnet_lts_torch.apis import (
        build_model_from_cfg, load_config, spread_head_outputs)
    from pillarnet_lts_torch.datasets import synth_points_realistic
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.ops import _kernels
    from pillarnet_lts_torch.runtime.quantize import (
        calibrate, enable_backbone_quant)
    from pillarnet_lts_torch.runtime.serving import ServingPipeline

    cfg = load_config(RCNN if int8 else RCNN_BF16)
    if int8:
        enable_backbone_quant(cfg["model"])
    n, pc_range = int(cfg["data"]["max_points"]), cfg["point_cloud_range"]
    posts = cfg["test_cfg"]["nms"]["nms_post_max_size"]
    model = build_model_from_cfg(cfg, device=dev, seed=0)
    spread_head_outputs(model, *on_card(torch, dev, synth_points_realistic(
        1, n, pc_range, seed=99, nsweeps=1)))
    rec = {"config": os.path.relpath(RCNN if int8 else RCNN_BF16, ROOT),
           "int8": int8, "dtype": str(model.dtype)}
    if int8:
        calib = [on_card(torch, dev, synth_points_realistic(
            1, n, pc_range, seed=400 + s, nsweeps=1))
            for s in range(CALIB_CLOUDS)]
        t0 = time.perf_counter()
        calibrate(model, calib)
        torch.cuda.synchronize()
        rec["calibration_s"] = time.perf_counter() - t0
        del calib
    path = precision_path(model, int8)
    infer = make_infer_fn(model)
    pipe = ServingPipeline(infer, depth=1)
    clouds = [synth_points_realistic(1, n, pc_range, seed=500 + s,
                                      nsweeps=1)
              for s in range(PRECISION_REQUESTS)]
    batches = [synth_points_realistic(PRECISION_BS, n, pc_range,
                                      seed=600 + s, nsweeps=1)
               for s in range(PRECISION_BATCHES)]

    def request(cloud, what):
        before = dict(_kernels.LAUNCHES)
        t0 = time.perf_counter()
        det = list(pipe.map([on_card(torch, dev, cloud)]))[0]
        dt = (time.perf_counter() - t0) * 1e3
        got = {k: v - before[k] for k, v in _kernels.LAUNCHES.items()
               if v != before[k]}
        if got != path:
            raise AssertionError(f"{tag} {what}: launches {got}, the path "
                                 f"is {path}")
        return det, dt

    # the main path: counts set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats(dev)
    _kernels.reset_launches()
    lat, kept = [], []
    for i, cloud in enumerate(clouds):
        det, dt = request(cloud, f"request {i}")
        if i >= PRECISION_WARMUP:
            lat.append(dt)
            kept.append(check_rcnn_detections(det, posts,
                                              f"{tag} request {i}"))
    batch_ms = []
    for i, cloud in enumerate(batches):
        det, dt = request(cloud, f"batch {i}")
        if i:
            batch_ms.append(dt)
        R = sum(posts)
        if det["box3d_lidar"].shape != (PRECISION_BS, R, 7) \
                or not np.isfinite(det["box3d_lidar"]).all() \
                or not det["mask"].any(axis=1).all():
            raise AssertionError(f"{tag} batch {i}: detections "
                                 f"{det['box3d_lidar'].shape}")
    launches = dict(_kernels.LAUNCHES)
    for name, per in path.items():
        if launches[name] != per * (len(clouds) + len(batches)):
            raise AssertionError(f"{tag}: {name} launched {launches[name]}")
    peak = torch.cuda.max_memory_allocated(dev)
    q = statistics.quantiles(lat, n=10)
    rec.update({"requests": len(clouds), "launches": launches,
                "path_per_request": path,
                "p50_ms": statistics.median(lat), "p90_ms": q[8],
                f"bs{PRECISION_BS}_ms": batch_ms,
                f"bs{PRECISION_BS}_frames_per_s": PRECISION_BS * 1e3
                / statistics.mean(batch_ms),
                "peak_allocated_gib": peak / 2**30,
                "mean_kept": statistics.mean(kept), "slots": sum(posts)})
    print(f"[{tag}] {rec['config']}{' + enable_backbone_quant' if int8 else ''}"
          f" ({rec['dtype']}) bs=1, {len(lat)} timed requests (after "
          f"{PRECISION_WARMUP} warm-up), host-synced latency: p50 "
          f"{rec['p50_ms']:.2f} ms, p90 {rec['p90_ms']:.2f} ms; bs="
          f"{PRECISION_BS} (after 1 warm-up): "
          f"{', '.join(f'{v:.2f}' for v in batch_ms)} ms "
          f"({rec[f'bs{PRECISION_BS}_frames_per_s']:.2f} frames/s); peak "
          f"allocated {rec['peak_allocated_gib']:.3f} GiB; mean kept "
          f"{rec['mean_kept']:.1f} of {sum(posts)}; per request {path}, "
          f"over the {len(clouds) + len(batches)} requests {launches}"
          + (f"; calibration {rec['calibration_s']:.2f} s on "
             f"{CALIB_CLOUDS} clouds" if int8 else "") + f"; card: {card}")

    check_no_sync(torch, infer, *on_card(torch, dev, clouds[4]), tag)
    k4 = []
    with (recording_int8_convs(k4) if int8 else contextlib.nullcontext()):
        (_, k2), k1 = capture_scatter(lambda: capture_overlap(
            lambda: infer(*on_card(torch, dev, clouds[5]))))
    torch.cuda.synchronize()
    replays, _ = replay_pass(torch, tag, k1, k2, "NMS, one call per task")
    conv = None
    if int8:
        if len(k4) != path["int8_conv_f32"]:
            raise AssertionError(f"{tag}: captured {len(k4)} K4 calls")
        conv = check_int8_conv(torch, k4, phase=tag)
        rec["int8_conv_f32"] = {k: conv[k] for k in (
            "max_abs_err", "ms", "alone_ms", "plain_ms", "main_shape",
            "frame")} | {"calls": len(k4)}
    del k1, k2, k4
    rec["replays"] = replays
    rec.update(rcnn_stage_split(torch, model, on_card(torch, dev,
                                                      clouds[6])))
    rec["profile_5_requests"] = profile_requests(
        torch, infer, [on_card(torch, dev, c) for c in clouds[7:12]], rec,
        tag)
    del model, infer, pipe
    torch.cuda.empty_cache()
    return rec, launches, replays, conv


def replay_int8_equal(torch, calls, tag):
    """Every captured K4 call through the kernel and its plain version,
    equal by value (untimed). Returns the call count and the largest
    |d|."""
    from pillarnet_lts_torch.ops.quant import (
        int8_conv_bn_act, int8_conv_bn_act_plain)

    err = 0.0
    for i, (args, kw, out) in enumerate(calls):
        got = int8_conv_bn_act(*args, **kw)
        want = int8_conv_bn_act_plain(*args, **plain_kwargs(kw))
        d = (got.float() - want.float()).abs().max().item()
        err = max(err, d)
        if not (torch.equal(got, want) and torch.equal(got, out)):
            raise AssertionError(f"{tag}: K4 call {i} {tuple(args[0].shape)}"
                                 f" differs from plain: max |d| {d}")
    return len(calls), err


def dist_test_int8_f32(torch, tmp):
    """Phase 18c: `dist_test --int8` on the f32 `pillarnet34_waymo` over
    16b's EVAL_WAYMO_FRAMES Waymo-layout frames: exit without error,
    finite detections, the int8 convs on K4's f32 variant only, every K4
    call replayed equal to its plain version."""
    from pillarnet_lts_torch.apis import load_config
    from pillarnet_lts_torch.datasets.synth import write_waymo_set

    cfg = load_config(WAYMO)
    info = write_waymo_set(os.path.join(tmp, "waymo"), EVAL_WAYMO_FRAMES,
                           cfg["data"]["max_points"], cfg["class_names"],
                           cfg["point_cloud_range"], seed=161,
                           class_counts=WAYMO_GT_COUNTS)
    path = eval_config(tmp, WAYMO, info, "waymo")
    ckpt = spread_checkpoint(torch, path, "cuda",
                             os.path.join(tmp, "waymo_ckpt"))
    t0 = time.perf_counter()
    out, launches, k1, k2, k4 = captured_run(torch, [
        path, "--int8", "--checkpoint", ckpt, "--seed", "0", "--work_dir",
        os.path.join(tmp, "waymo_int8")], int8=True)
    seconds = time.perf_counter() - t0
    dets = out["detections"]
    if len(dets) != EVAL_WAYMO_FRAMES or launches["int8_conv"] \
            or launches["int8_conv_f32"] < 1 \
            or launches["pillar_scatter_max"] < 2:
        raise AssertionError(f"18c: {len(dets)} frames, launches {launches}")
    if not all(np.isfinite(d["box3d_lidar"]).all()
               and np.isfinite(d["scores"]).all() for d in dets.values()):
        raise AssertionError("18c: non-finite int8 detections")
    calls, err = replay_int8_equal(torch, k4, "18c")
    del k1, k2, k4
    torch.cuda.empty_cache()
    text = out["result"]["results"]["waymo"]
    kept = sum(len(d["scores"]) for d in dets.values())
    print(f"[18c] dist_test --int8 on the f32 pillarnet34_waymo over "
          f"{len(dets)} Waymo-layout frames in {seconds:.1f} s: launches "
          f"{launches}; {calls} K4 calls (f32 variant) each equal to its "
          f"plain version; {kept} detections, all finite; "
          f"{text.strip().splitlines()[-1]}")
    return {"frames": len(dets), "launches": launches, "seconds": seconds,
            "k4_calls": calls, "k4_max_abs_err": err, "detections": kept,
            "result": text}


def circular_nms(cfg):
    """pillarnet18_demo's test config with circular NMS (the
    CenterPoint-style route; squared radii per task)."""
    cfg["test_cfg"].update(circular_nms=True, min_radius=[4.0, 0.175])


def precisions(torch, dev, card):
    """Phase 18. Returns its record, each path's launches, and the K1 / K2
    replays and K4 f32 record of 18a."""
    import tempfile

    t0 = time.perf_counter()
    rec, launches = {}, {}
    rec["rcnn_int8"], launches["rcnn_int8"], replays, conv = \
        serve_precision(torch, dev, card, "18a", int8=True)
    rec["rcnn_bf16"], launches["rcnn_bf16"], replays_bf16, _ = \
        serve_precision(torch, dev, card, "18b", int8=False)
    with tempfile.TemporaryDirectory(prefix="pillarnet_int8_f32_") as tmp:
        rec["dist_test_int8_f32"] = dist_test_int8_f32(torch, tmp)
    demo = os.path.join(ROOT, "configs", "demo")
    rec["demo_card_vs_cpu"] = {
        "twostage18_demo": card_vs_cpu(
            torch, dev, os.path.join(demo, "twostage18_demo.py"), "18d"),
        "voxelnet18_demo": card_vs_cpu(
            torch, dev, os.path.join(demo, "voxelnet18_demo.py"), "18d"),
        "pillarnet18_demo_circular_nms": card_vs_cpu(
            torch, dev, DEMO, "18d", edit=circular_nms)}
    rec["seconds"] = time.perf_counter() - t0
    print(f"[18] phase 18 took {rec['seconds']:.1f} s")
    return rec, launches, {"18a": replays, "18b": replays_bf16}, conv



# phase 19: data-parallel training and sharded evaluation. NCCL refuses
# two ranks on one card, so the two-rank runs are gloo ranks that share the
# card (CUDA tensors on both, the backend passed explicitly); the NCCL path
# is driven by a group of one (19c)
DP_WORLD = 2  # 19a/b/d: ranks
DP_STEPS = 2  # 19a/b: steps from one state
DP_TIMEOUT = 900  # s: a spawned run that has not ended by then is killed
DP_INIT_TIMEOUT = 300  # s: a rank that waits longer for the others raises
# 19a/b: every loss of the ranks against the one-process step computed in the
# ranks' order (`in_rank_order`), and against the plain one-process step, whose
# BN sums and reader matmul run over the 4 frames at once: phase 13b's
# card-vs-CPU metric tolerance, since that order moves a loss by up to ~2e-5
# (the readings side by side show it)
DP_LOSS_RTOL = 1e-5
DP_LOSS_RTOL_PLAIN = 1e-4
DP_GRAD_RTOL = 1e-3  # grad_norm, as phase 13b holds the card to the CPU
DP_STAT_TOL = 1e-4  # BN running statistics, rtol = atol, as phase 13b
# a module group's gradient may differ from one process's by at most twice
# the one process's own spread, and never by more than this: a rank that
# averages the gradients (0.5) or a BN whose sum over the ranks passes no
# gradient back lies beyond it (tests/test_torch_port_parallel.py)
DP_GRAD_CAP = 0.1
DP_NUDGES = 2  # 19a/b: one-process steps from nudged weights (the spread)
# the smoke's 19a/b: one step from one state, one nudged step (the CPU
# tests, `tests/test_torch_port_parallel.py`, keep DP_STEPS and DP_NUDGES);
# 19c: a smaller written set, one epoch of 2 steps
DP_SMOKE_STEPS, DP_SMOKE_NUDGES, DP_CLI_FRAMES = 1, 1, 8


def spawn_ranks(argv, world, timeout, env=None):
    """Run `argv` from the repository root as `world` ranks of one node,
    each with torchrun's environment (`RANK`, `WORLD_SIZE`,
    `LOCAL_WORLD_SIZE`, a free port on localhost) and `env`, and
    `LOCAL_RANK` 0: on the card the ranks share card 0. When a rank fails
    or `timeout` seconds pass, every rank still running is killed.
    Returns [(exit code, output)] in rank order."""
    import socket
    import tempfile

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    path = os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH"))
                           if p)
    procs, logs = [], []
    try:
        for r in range(world):
            logs.append(tempfile.TemporaryFile("w+"))
            procs.append(subprocess.Popen(
                argv, cwd=ROOT, stdout=logs[-1], stderr=subprocess.STDOUT,
                env=dict(os.environ, **(env or {}), PYTHONPATH=path,
                         RANK=str(r), WORLD_SIZE=str(world),
                         LOCAL_RANK="0", LOCAL_WORLD_SIZE=str(world),
                         MASTER_ADDR="localhost", MASTER_PORT=str(port))))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def run_ranks(tag, argv, world=DP_WORLD, env=None, timeout=DP_TIMEOUT):
    """`spawn_ranks` that raises unless every rank exits 0; the ranks'
    `[19...]` lines are printed. Returns the wall seconds."""
    t0 = time.perf_counter()
    res = spawn_ranks(argv, world, timeout, env)
    seconds = time.perf_counter() - t0
    for r, (rc, out) in enumerate(res):
        for line in out.splitlines():
            if line.startswith(("[19", "[25")):
                print(line)
        if rc != 0:
            raise AssertionError(f"{tag}: rank {r} of {world} exited {rc}:\n"
                                 f"{out[-4000:]}")
    return seconds


def dp_spec(config, device, out, **kw):
    """A phase-19 training run: the config, a global batch of `batch`
    synthetic scenes of `points` points with every class a step, `steps`
    steps (one epoch), weights from `model_seed` (the first stage's heads
    spread on the first scene with `spread`), the run's `seed`, a val set
    of `val_frames` demo frames (0: none); with `at_gt` the two-stage
    sampler's proposals are boxes about the GT (`proposals_at_gt`); with
    `draws` (a path) the sampler's draws are the ones saved there
    (`given_draws`); `compact_kmax` > 0 serves the reader's compact path
    with that budget; `dtype` sets the model's compute dtype and
    `variant` a second-stage variant (`rcnn_variant`)."""
    spec = dict(config=config, device=device, backend="gloo", out=out,
                batch=4, points=N_POINTS, steps=DP_STEPS, seed=3,
                model_seed=5, data_seed=200, num_boxes=[10, 21],
                dp_ratio=None, spread=False, at_gt=False, val_frames=0,
                workers=2, threads=None, draws=None, compact_kmax=0,
                dtype=None, variant=None)
    spec.update(kw)
    return spec


def dp_setup(torch, spec, dev):
    """(config, training set, model) of a phase-19 run on `dev`."""
    from pillarnet_lts_torch.apis import (build_model_from_cfg, rcnn_variant,
                                          spread_head_outputs)
    from pillarnet_lts_torch.datasets import SynthDataset

    cfg = rcnn_train_cfg(spec["config"], spec["dp_ratio"])
    if spec.get("variant"):
        cfg["model"] = rcnn_variant(cfg["model"], spec["variant"])
    if spec.get("dtype"):
        cfg["model"]["dtype"] = spec["dtype"]
    if spec["compact_kmax"]:
        cfg["model"]["reader"] = dict(cfg["model"]["reader"],
                                      compact_kmax=spec["compact_kmax"])
    cfg["data"] = dict(cfg["data"], samples_per_gpu=spec["batch"],
                       max_points=spec["points"], workers_per_gpu=spec[
                           "workers"])
    cfg["total_epochs"] = 1
    if spec["val_frames"]:
        cfg["data"]["val"] = dict(cfg["data"]["val"],
                                  num_frames=spec["val_frames"],
                                  num_points=spec["points"])
    ds = SynthDataset(cfg, spec["batch"] * spec["steps"], spec["points"],
                      seed=spec["data_seed"],
                      num_boxes=tuple(spec["num_boxes"]))
    model = build_model_from_cfg(cfg, device=dev, seed=spec["model_seed"])
    if spec["spread"]:
        pts = torch.from_numpy(ds[0]["points"][None]).to(dev)
        spread_head_outputs(model, pts, torch.ones(
            pts.shape[:2], dtype=bool, device=dev))
    return cfg, ds, model


def dp_rows(ds, spec, world=DP_WORLD):
    """Each step's global batch as frame indices, the ranks' rows in rank
    order: the loader's batches that `apis.train_detector` gives each rank
    of one node (`parallel.mesh.train_shards`: contiguous blocks of the
    node's batch), which are the JAX loader's batches."""
    from pillarnet_lts_torch.datasets import DataLoader

    per = spec["batch"] // world
    ranks = [DataLoader(ds, per, shuffle=True, seed=spec["seed"],
                        block=(r, world)).batches() for r in range(world)]
    return [[int(i) for rows in ranks for i in rows[s]]
            for s in range(spec["steps"])]


@contextlib.contextmanager
def recording_draws(rec):
    """Appended to rec: "targets", each call of `PillarRCNN`'s
    `proposal_target_layer` as (its proposals, its `RoiTargets`);
    "sampler", the sampler's draws (`pillar_rcnn.sampler_draws`);
    "dropout", dropout's uniforms (`roi_heads.rank_rows`)."""
    from pillarnet_lts_torch.models.detectors import pillar_rcnn
    from pillarnet_lts_torch.models.roi_heads import roi_heads

    def keep(key, inputs=False):
        def wrap(real):
            def record(*args, **kwargs):
                out = real(*args, **kwargs)
                rec[key].append((args[0], out) if inputs else out)
                return out
            return record
        return wrap

    with patched(pillar_rcnn, "proposal_target_layer",
                 keep("targets", inputs=True)), \
            patched(pillar_rcnn, "sampler_draws", keep("sampler")), \
            patched(roi_heads, "rank_rows", keep("dropout")):
        yield rec


@contextlib.contextmanager
def given_draws(torch, path):
    """`PillarRCNN`'s sampler draws taken from `path` (a saved list of (u,
    r) pairs made for the global batch, one a call, e.g. the JAX package's
    `jax.random` draws) in place of the generator's, each rank keeping its
    rows (`parallel.mesh.rank_rows`)."""
    from pillarnet_lts_torch.models.detectors import pillar_rcnn
    from pillarnet_lts_torch.models.roi_heads.proposal_target_layer import (
        SamplerDraws)
    from pillarnet_lts_torch.parallel.mesh import rank_rows

    given = iter(torch.load(path))

    def draws(generator, batch, num_rois, roi_per_image, device):
        u, r = next(given)
        return SamplerDraws(rank_rows(lambda size: u, batch).to(device),
                            rank_rows(lambda size: r, batch).to(device))

    with patched(pillar_rcnn, "sampler_draws", lambda real: draws):
        yield


def on_cpu(torch, tree):
    """A nest of tuples, lists and dicts of tensors, every tensor on the
    CPU."""
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: on_cpu(torch, v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(on_cpu(torch, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(on_cpu(torch, v) for v in tree)
    return tree


def state_of(torch, model):
    return {k: v.detach().cpu().clone()
            for k, v in model.state_dict().items()}


def grads_of(torch, model):
    return {n: p.grad.detach().cpu().clone() for n, p in
            model.named_parameters() if p.grad is not None}


@contextlib.contextmanager
def in_rank_order(torch, bn_sums, world=DP_WORLD):
    """A one-process step that computes as the ranks do, on a batch whose
    rows are the ranks' in rank order: every 2-D convolution, transposed
    convolution and `F.linear` of a batch that `world` divides on each
    rank's rows apart, the results concatenated (cuDNN and cuBLAS, or the
    CPU, pick the algorithms a rank picks); with `bn_sums` also the
    masked BN's sums (`norm._site_sum`), each rank's rows summed apart and
    the partial sums added, as the ranks' all-reduce adds theirs."""
    import torch.nn.functional as F

    from pillarnet_lts_torch.models.utils import norm

    def split(batched):  # whether an input's dim 0 is the batch
        def make(real):
            def op(x, *args, **kwargs):
                if not batched(x) or x.shape[0] % world:
                    return real(x, *args, **kwargs)
                return torch.cat([real(c, *args, **kwargs)
                                  for c in x.chunk(world)])
            return op
        return make

    def rank_sum(real):
        def site_sum(t, dims):
            if t.shape[0] % world:
                raise ValueError(f"in_rank_order: {world} ranks do not "
                                 f"split a batch of {t.shape[0]}")
            parts = [real(c, dims) for c in t.chunk(world)]
            total = parts[0]
            for part in parts[1:]:
                total = total + part
            return total
        return site_sum

    with contextlib.ExitStack() as stack:
        conv = split(lambda x: x.dim() == 4)
        stack.enter_context(patched(F, "conv2d", conv))
        stack.enter_context(patched(F, "conv_transpose2d", conv))
        stack.enter_context(patched(F, "linear", split(
            lambda x: x.dim() >= 2)))
        if bn_sums:
            stack.enter_context(patched(norm, "_site_sum", rank_sum))
        yield


def dp_reference(torch, spec, dev, ranks, nudges=DP_NUDGES):
    """Phase 19's one-process steps: each step of `dp_spec` on its global
    batch (`dp_rows`) from the state the ranks started it from (the
    seeded weights, then rank 0's model and optimizer state after the
    step before), with the trainer's step generator, on `dev`, computed
    in the ranks' order (`in_rank_order`). Returns per step its metrics,
    state, gradients and learning rate, the sampler's targets and
    dropout's draws; the metrics of the same step computed plainly and
    with only its convs and matmuls on the ranks' rows apart; and the one
    process's own spread: the step in the ranks' order from the
    parameters times 1 + 1e-6 N(0, 1) (`nudges` draws), as phase 15c
    measures it."""
    from pillarnet_lts_torch.apis import optimizer_from_cfg
    from pillarnet_lts_torch.datasets import collate_batch
    from pillarnet_lts_torch.runtime.train_step import (
        batch_to_device, bn_shifted_biases, step_generator, train_step)

    cfg, ds, model = dp_setup(torch, spec, dev)
    opt = optimizer_from_cfg(model, cfg, spec["steps"])
    params = [n for n, _ in model.named_parameters()]
    shifted = set(bn_shifted_biases(model))
    rec = {"metrics": [], "states": [], "grads": [], "targets": [],
           "sampler": [], "dropout": [], "spread": [], "params": params,
           "dtype": str(model.dtype).replace("torch.", ""),
           "metrics_plain": [], "metrics_convs_matmuls": [],
           "shifted": sorted(shifted),
           "lr": [opt.lr_fn(s) for s in range(spec["steps"])]}
    start = (state_of(torch, model), opt.state_dict())
    g = torch.Generator().manual_seed(16)
    for s, rows in enumerate(dp_rows(ds, spec)):
        if s:
            start = (ranks[0]["states"][s - 1], ranks[0]["optim"][s - 1])
        batch = batch_to_device(
            collate_batch([ds[i] for i in rows], spec["points"]), dev)
        runs = []
        # the ranks' order (the reference), plain, convs and matmuls alone
        # on the ranks' rows, nudged in the ranks' order
        for k in range(3 + nudges):
            weights = start[0] if k < 3 else {
                n: v * (1 + 1e-6 * torch.randn(v.shape, generator=g))
                if n in params else v for n, v in start[0].items()}
            model.load_state_dict(weights)
            opt.load_state_dict(start[1])
            with (recording_draws(rec) if k == 0
                  else contextlib.nullcontext()), (
                    in_rank_order(torch, bn_sums=k != 2) if k != 1
                    else contextlib.nullcontext()), (
                    proposals_at_gt(torch, spec["seed"], first_call=s)
                    if spec["at_gt"] else contextlib.nullcontext()):
                m = train_step(model, opt, batch, cfg["train_cfg"],
                               step_generator(spec["seed"], s, dev))
            m = {key: float(v) for key, v in m.items()}
            if k in (1, 2):
                rec["metrics_plain" if k == 1
                    else "metrics_convs_matmuls"].append(m)
                continue
            runs.append((m, state_of(torch, model), grads_of(torch, model)))
        (m0, s0, g0), nudged = runs[0], runs[1:]
        rec["metrics"].append(m0)
        rec["states"].append(s0)
        rec["grads"].append(g0)
        groups = [grad_diffs(torch, gr, g0)[0] for _, _, gr in nudged]
        rec["spread"].append({
            "metrics": {k: max(rel_diff(m[k], m0[k]) for m, _, _ in nudged)
                        for k in m0},
            "params_share": max(params_within_first_adam_step(
                torch, st, s0, params, shifted, rec["lr"][s],
                max_share=1.0)[0] for _, st, _ in nudged),
            "grad_groups": {k: max(gr[k] for gr in groups)
                            for k in groups[0]}})
    for key in ("targets", "sampler", "dropout"):
        rec[key] = on_cpu(torch, rec[key])
    return rec


def rel_diff(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def dp_rank(spec_path):
    """A rank of a phase-19 training run (`python3 chip_smoke.py --dp-rank
    SPEC`, spawned by `spawn_ranks`): the run of `dp_spec` through
    `apis.train_detector` on this rank's shard, the group started by
    `parallel.dist.init_from_env`; per step the metrics, the state, the
    gradients and the optimizer state, the RoI sampler's proposals,
    draws and targets and dropout's draws; on the card the launch counts
    (set to 0 just before), step ms, peak memory and the last step's K1
    and K2 calls replayed against their plain versions, one rank after
    the other. With `val_frames`, `Trainer.val` over the sharded val set.
    Saved to `{out}/rank{r}.pt`."""
    import datetime

    import torch

    sys.path.insert(0, ROOT)
    from pillarnet_lts_torch.apis import train_detector
    from pillarnet_lts_torch.datasets import build_dataset
    from pillarnet_lts_torch.ops import _kernels, iou3d
    from pillarnet_lts_torch.models.readers import dynamic_pillar_encoder
    from pillarnet_lts_torch.parallel import dist
    from pillarnet_lts_torch.runtime.hooks import Hook
    from pillarnet_lts_torch.runtime.trainer import Trainer

    with open(spec_path) as f:
        spec = json.load(f)
    if spec["threads"]:
        torch.set_num_threads(spec["threads"])
    dev = dist.init_from_env(spec["device"], backend=spec["backend"],
                             timeout=datetime.timedelta(
                                 seconds=DP_INIT_TIMEOUT))
    r, cuda = dist.rank(), dev.type == "cuda"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, ds, model = dp_setup(torch, spec, dev)
    rec = {"rank": r, "world": dist.process_count(), "device": str(dev),
           "states": [], "grads": [], "optim": [], "targets": [],
           "sampler": [], "dropout": [], "val": []}
    k1, k2, steps = [], [], spec["steps"]

    class Record(Hook):
        def before_train_iter(self, trainer):
            self.stack = contextlib.ExitStack()
            if cuda and trainer.iter == steps - 1:
                self.stack.enter_context(recording(
                    dynamic_pillar_encoder, "pillar_scatter_max", k1))
                self.stack.enter_context(recording(
                    iou3d, "convex_intersection_area", k2,
                    keep=lambda a, k: a))

        def after_train_iter(self, trainer):
            self.stack.close()
            rec["states"].append(state_of(torch, trainer.model))
            rec["grads"].append(grads_of(torch, trainer.model))
            rec["optim"].append(on_cpu(torch,
                                       trainer.optimizer.state_dict()))

    def keep_val(real):
        def val(*args, **kwargs):
            out = real(*args, **kwargs)
            rec["val"].append(out)
            return out
        return val

    val_ds = (build_dataset(cfg["data"]["val"]) if spec["val_frames"]
              else None)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    _kernels.reset_launches()
    with (given_draws(torch, spec["draws"]) if spec["draws"]
          else contextlib.nullcontext()), \
            recording_draws(rec), patched(Trainer, "val", keep_val), (
                proposals_at_gt(torch, spec["seed"]) if spec["at_gt"]
                else contextlib.nullcontext()):
        trainer = train_detector(model, ds, cfg, seed=spec["seed"],
                                 work_dir=os.path.join(spec["out"], "work"),
                                 hooks=[Record()], val_dataset=val_ds)
    rec["launches"] = dict(_kernels.LAUNCHES)
    hist = trainer.log_buffer.val_history
    rec["metrics"] = [{k: v[s] for k, v in hist.items()
                       if k not in ("time", "data_time")}
                      for s in range(steps)]
    rec["step_ms"] = [(t - d) * 1e3 for t, d in zip(hist["time"],
                                                     hist["data_time"])]
    for key in ("targets", "sampler", "dropout"):
        rec[key] = on_cpu(torch, rec[key])
    if cuda:
        rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        del trainer, model
        # the replays are timed one rank at a time: the ranks share a card
        for turn in range(rec["world"]):
            if turn == r:
                rec["replays"] = {"k1": replay_summary(
                    replay_scatter(torch, k1))}
                print_replays(f"19 rank {r}", "K1 pillar_scatter_max",
                              rec["replays"]["k1"])
                if k2:
                    rec["replays"]["k2"] = replay_summary(
                        replay_overlap(torch, k2, "predict and sampler"))
                    print_replays(f"19 rank {r}", "K2 rotated_overlap "
                                  "(predict and RoI sampler)",
                                  rec["replays"]["k2"])
            dist.barrier()
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "pillarnet_lts_tpu")]
    if bad:
        raise AssertionError(f"a rank imported {bad[:4]}")
    torch.save(rec, os.path.join(spec["out"], f"rank{r}.pt"))
    dist.shutdown()
    return 0


def run_dp_training(torch, spec, tag, timeout=DP_TIMEOUT, rank_argv=None):
    """The ranks of `spec` spawned (`dp_rank`, or `rank_argv` + [the spec's
    path]; killed after `timeout` seconds); returns their records in rank
    order and the wall seconds."""
    os.makedirs(spec["out"], exist_ok=True)
    path = os.path.join(spec["out"], "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    env = {"OMP_NUM_THREADS": str(spec["threads"])} if spec["threads"] \
        else None
    argv = rank_argv or [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                         "--dp-rank"]
    seconds = run_ranks(tag, argv + [path], env=env, timeout=timeout)
    return [torch.load(os.path.join(spec["out"], f"rank{r}.pt"),
                       weights_only=False)
            for r in range(DP_WORLD)], seconds


def rank_chunk(t, r, world=DP_WORLD):
    """Rank r's rows of a tensor of the global batch (dim 0)."""
    return t.chunk(world)[r]


def check_metrics(tag, s, got, want, spread, loss_rtol):
    """The ranks' metrics of step s against one process's: the
    `num_positive` counts equal, `grad_norm` within max(2 x the one
    process's own spread, DP_GRAD_RTOL), every loss within max(2 x the
    spread, loss_rtol). Returns each metric's relative difference and
    tolerance."""
    if set(got) != set(want):
        raise AssertionError(f"{tag}: metric keys {sorted(got)} vs "
                             f"{sorted(want)}")
    rel = {k: rel_diff(got[k], want[k]) for k in want}
    tol = {k: 0.0 if k.startswith("num_positive") else max(
        2 * spread[k], DP_GRAD_RTOL if k == "grad_norm" else loss_rtol)
        for k in want}
    for k, d in rel.items():
        if d > tol[k]:
            raise AssertionError(
                f"{tag} step {s} {k}: ranks {got[k]} vs one process "
                f"{want[k]} (rel {d:.2e}, tolerance {tol[k]:.2e})")
    return rel, tol


def check_grad_groups(torch, tag, s, got, want, spread):
    """The ranks' gradients of step s against one process's by module
    group (`grad_diffs`), each within min(max(2 x the one process's own
    spread, DP_GRAD_RTOL), DP_GRAD_CAP). Returns the differences, the
    bounds and the worst leaf."""
    groups, leaf = grad_diffs(torch, got, want)
    bounds = {k: min(max(2 * spread[k], DP_GRAD_RTOL), DP_GRAD_CAP)
              for k in groups}
    for k, d in groups.items():
        if d > bounds[k]:
            raise AssertionError(f"{tag} step {s}: the {k} gradients "
                                 f"{d:.2e} from one process's (bound "
                                 f"{bounds[k]:.2e})")
    return groups, bounds, leaf


def check_dp_training(torch, tag, ref, ranks):
    """Phase 19a/b's checks of the ranks against the one-process steps
    (`dp_reference`, in the ranks' order): after every step every rank's state
    bit-identical to rank 0's and its metrics equal; the metrics
    (`check_metrics`) within DP_LOSS_RTOL, and within DP_LOSS_RTOL_PLAIN of the
    plain step's; every parameter within two Adam steps of the step's learning
    rate and at most max(2 x the spread's share, 0.5%) beyond 1e-4
    (`params_within_first_adam_step`); the running statistics within
    DP_STAT_TOL; the gradients by module group (`check_grad_groups`); the
    sampler's discrete targets and dropout's draws bit-equal to the one-process
    rows. Returns the record of the differences, with the metrics' relative
    differences also to the step whose convs and matmuls alone ran on the
    ranks' rows apart (a reading: what their batch size moves). A bf16
    model's plain step is a reading too, not a check: its convs over the
    whole batch round to bf16 otherwise than a rank's over its half, and
    on random weights a one-ulp flip grows through the step (0.6% in a
    loss of the two-stage demo, beyond DP_LOSS_RTOL_PLAIN), where the
    steps in the ranks' order stay within DP_LOSS_RTOL."""
    out = {"steps": []}
    for s, want in enumerate(ref["metrics"]):
        for rk in ranks[1:]:
            if rk["metrics"][s] != ranks[0]["metrics"][s]:
                raise AssertionError(f"{tag} step {s}: rank {rk['rank']}'s "
                                     f"metrics differ from rank 0's")
            for k, v in ranks[0]["states"][s].items():
                if not torch.equal(rk["states"][s][k], v):
                    raise AssertionError(f"{tag} step {s}: rank "
                                         f"{rk['rank']}'s {k} differs")
        got, spread = ranks[0]["metrics"][s], ref["spread"][s]
        rel, tol = check_metrics(tag, s, got, want, spread["metrics"],
                                 DP_LOSS_RTOL)
        if ref.get("dtype", "float32") == "float32":
            rel_plain, _ = check_metrics(
                f"{tag} (the plain one-process step)", s, got,
                ref["metrics_plain"][s], spread["metrics"],
                DP_LOSS_RTOL_PLAIN)
        else:
            rel_plain = {k: rel_diff(got[k], v)
                         for k, v in ref["metrics_plain"][s].items()}
        rel_split = {k: rel_diff(got[k], v) for k, v in
                     ref["metrics_convs_matmuls"][s].items()}
        gs, ws = ranks[0]["states"][s], ref["states"][s]
        share, worst = params_within_first_adam_step(
            torch, gs, ws, ref["params"], set(ref["shifted"]), ref["lr"][s],
            max_share=max(2 * spread["params_share"], 5e-3))
        for k in ws:
            if k not in ref["params"] and not torch.allclose(
                    gs[k], ws[k], rtol=DP_STAT_TOL, atol=DP_STAT_TOL):
                raise AssertionError(f"{tag} step {s}: running statistic "
                                     f"{k} beyond {DP_STAT_TOL}")
        groups, bounds, leaf = check_grad_groups(
            torch, tag, s, ranks[0]["grads"][s], ref["grads"][s],
            spread["grad_groups"])
        worst_k = max(rel, key=lambda k: rel[k] / max(tol[k], 1e-30))
        out["steps"].append({
            "loss": [got["loss"], want["loss"]],
            "metrics_rel": rel, "metrics_spread": spread["metrics"],
            "metrics_rel_plain": rel_plain,
            "metrics_rel_convs_matmuls": rel_split,
            "closest_metric": worst_k,
            "params_share_beyond_1e-4": share, "params_max_abs": worst,
            "params_spread_share": spread["params_share"],
            "grad_rel_by_group": groups,
            "grad_rel_by_group_spread": spread["grad_groups"],
            "grad_bound_by_group": bounds,
            "grad_worst_leaf": {"name": leaf[1], "rel": leaf[2]}})
    if ref["targets"]:
        out["targets"] = check_dp_draws(torch, tag, ref, ranks)
    return out


def check_dp_draws(torch, tag, ref, ranks):
    """The two-stage draws and targets of each rank against the
    one-process rows, call by call, bit-equal: dropout's uniforms, the RoI
    sampler's draws, the proposals it was given (`proposals_at_gt`: the
    first stage's own can differ where a rounding tips its NMS at a near
    tie) and its targets. Returns the sampled RoI slots compared."""
    slots = 0
    for rk in ranks:
        r = rk["rank"]
        for key in ("targets", "sampler", "dropout"):
            if len(rk[key]) != len(ref[key]):
                raise AssertionError(f"{tag}: rank {r} made {len(rk[key])} "
                                     f"{key} calls, one process "
                                     f"{len(ref[key])}")
        for i, (got, want) in enumerate(zip(rk["dropout"], ref["dropout"])):
            if not bit_equal(torch, got, rank_chunk(want, r)):
                raise AssertionError(f"{tag}: rank {r}'s dropout draw {i} "
                                     f"is not the one-process rows'")
        for i, (got, want) in enumerate(zip(rk["sampler"], ref["sampler"])):
            if not all(torch.equal(a, rank_chunk(b, r))
                       for a, b in zip(got, want)):
                raise AssertionError(f"{tag}: rank {r}'s sampler draws {i} "
                                     f"are not the one-process rows'")
        for i, ((rois, got), (ref_rois, want)) in enumerate(
                zip(rk["targets"], ref["targets"])):
            pairs = [("proposals", rois, ref_rois)] + [
                (f, getattr(got, f), getattr(want, f)) for f in got._fields]
            for name, a, b in pairs:
                if not torch.equal(a, rank_chunk(b, r)):
                    raise AssertionError(f"{tag}: rank {r}'s sampler {name} "
                                         f"(call {i}) differ from the "
                                         f"one-process rows'")
            slots += got.rois.shape[0] * got.rois.shape[1]
    return {"sampled_slots": slots}


def run_torchrun(tag, nproc, argv, cwd=ROOT):
    """`torchrun --standalone --nproc_per_node nproc argv` from `cwd`
    (the package on PYTHONPATH); raises unless it exits 0 within
    DP_TIMEOUT (then torchrun is told to stop its ranks, and killed).
    The ranks' `[19...]` lines are printed. Returns the wall seconds."""
    import signal

    path = os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH"))
                           if p)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(nproc)] + argv, cwd=cwd,
        env=dict(os.environ, PYTHONPATH=path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=DP_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.send_signal(signal.SIGTERM)
        try:
            out, _ = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
    seconds = time.perf_counter() - t0
    for line in out.splitlines():
        if line.startswith(("[19", "[25")):
            print(line)
    if proc.returncode != 0:
        raise AssertionError(f"{tag}: torchrun exited {proc.returncode}:\n"
                             f"{out[-4000:]}")
    return seconds


def replay_equal(torch, k1, k2, tag):
    """Each captured K1 call bit-equal to `scatter_max_to_grid` and each
    K2 call to `_pairwise_area_plain` (untimed); returns {"k1", "k2"}:
    the calls and the largest |d|."""
    from pillarnet_lts_torch.ops.iou3d import (_pairwise_area_plain,
                                               convex_intersection_area)
    from pillarnet_lts_torch.ops.scatter import pillar_scatter_max
    from pillarnet_lts_torch.ops.voxelize import scatter_max_to_grid

    err1 = err2 = 0.0
    for k, (args, kwargs) in enumerate(k1):
        args = tuple(x.detach() if torch.is_tensor(x) else x for x in args)
        err1 = max(err1, check_scatter_equal(
            torch, f"{tag} K1 call {k}", pillar_scatter_max(*args, **kwargs),
            scatter_max_to_grid(*args)))
    for k, (a, b) in enumerate(k2):
        got, want = convex_intersection_area(a, b), _pairwise_area_plain(a, b)
        err2 = max(err2, (got - want).abs().max().item() if got.numel()
                   else 0.0)
        if not bit_equal(torch, got, want):
            raise AssertionError(f"{tag} K2 call {k} differs from plain")
    return {"k1": {"calls": len(k1), "max_abs_err": err1},
            "k2": {"calls": len(k2), "max_abs_err": err2}}


def cli_rank(argv):
    """`python3 chip_smoke.py --cli-rank OUT train|dist_test ARGS...`: a
    rank of phase 19c/d under torchrun (or, without its environment, the
    one process): the CLI's main on the card, the launch counts set to 0
    just before, its K1 and K2 calls captured and each held bit-equal to
    its plain version (`replay_equal`); training under deterministic
    algorithms (cuDNN's and torch's), so that two runs give the same bits.
    With `--share-card` before ARGS the ranks are gloo ranks that share
    card 0 (torchrun's `LOCAL_RANK` read as 0). The process group's
    backend and size are recorded. Writes {OUT}/rank{r}.json."""
    import torch

    sys.path.insert(0, ROOT)
    from pillarnet_lts_torch.ops import _kernels
    from pillarnet_lts_torch.parallel import dist
    from pillarnet_lts_torch.tools import dist_test, train

    out, tool, args = argv[0], argv[1], argv[2:]
    share = args[:1] == ["--share-card"]
    if share:
        args = args[1:]
        os.environ["LOCAL_RANK"] = "0"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if tool == "train":
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
    group = {}

    def noting(real):
        def init(*a, **k):
            dev = real(*a, **(dict(k, backend="gloo") if share else k))
            if dist.is_initialized():
                group.update(backend=str(torch.distributed.get_backend()),
                             world=dist.process_count(), rank=dist.rank())
            group["device"] = str(dev)
            return dev
        return init

    main = {"train": train.main, "dist_test": dist_test.main}[tool]
    t0 = time.perf_counter()
    with patched(train, "init_from_env", noting), \
            patched(dist_test, "init_from_env", noting):
        _kernels.reset_launches()
        (res, k2), k1 = capture_scatter(
            lambda: capture_overlap(lambda: main(args)))
        launches = dict(_kernels.LAUNCHES)
    seconds = time.perf_counter() - t0
    r = group.get("rank", 0)
    rec = dict(group, launches=launches, seconds=seconds,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30
               if torch.cuda.is_available() else None,
               replays=replay_equal(torch, k1, k2, f"19 {tool} rank {r}"))
    if tool == "dist_test":
        rec["speed"] = res["speed"]
        rec["frames"] = len(res["detections"])
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"rank{r}.json"), "w") as f:
        json.dump(rec, f)
    return 0


def read_ranks(out, world):
    recs = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    return recs


def dp_train_phase(torch, dev, card, tag, config, name, **kw):
    """Phase 19a/b: `config` at full width trained 2 steps (global batch 4,
    2 a rank) by 2 gloo ranks on the card (`dp_rank`), against the
    one-process steps (`dp_reference`, `check_dp_training`). Returns its
    record and the ranks' launches and K1 / K2 replays."""
    import shutil

    spec = dp_spec(config, "cuda", os.path.join(
        ROOT, "build", f"chip_smoke_dp_{tag}"), steps=DP_SMOKE_STEPS, **kw)
    shutil.rmtree(spec["out"], ignore_errors=True)
    torch.cuda.empty_cache()  # the ranks share the card with this process
    ranks, seconds = run_dp_training(torch, spec, tag)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    ref = dp_reference(torch, spec, dev, ranks, nudges=DP_SMOKE_NUDGES)
    ref_s = time.perf_counter() - t0
    ref_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    out = check_dp_training(torch, tag, ref, ranks)
    del ref
    torch.cuda.empty_cache()
    k2_per_step = 3 if "rcnn" in name else 0  # predict's 2, the sampler's
    for rk in ranks:
        got = rk["launches"]
        if (got["pillar_scatter_max"], got["rotated_overlap"]) != (
                spec["steps"], k2_per_step * spec["steps"]):
            raise AssertionError(f"{tag} rank {rk['rank']}: launches {got}")
    rec = {"config": name, "ranks": DP_WORLD, "global_batch": spec["batch"],
           "points": spec["points"], "steps": spec["steps"],
           "spawn_seconds": seconds, "reference_seconds": ref_s,
           "reference_peak_gib": ref_peak,
           "step_ms_per_rank": [rk["step_ms"] for rk in ranks],
           "peak_gib_per_rank": [rk["peak_gib"] for rk in ranks],
           "launches_per_rank": [rk["launches"] for rk in ranks],
           "checks": out}
    launches = rec["launches_per_rank"]
    k12 = [(n["pillar_scatter_max"], n["rotated_overlap"]) for n in launches]
    def losses(key):  # the largest relative difference of a loss metric
        return max(v for st in out["steps"] for k, v in st[key].items()
                   if "loss" in k)

    worst = [losses("metrics_rel"), losses("metrics_rel_convs_matmuls"),
             losses("metrics_rel_plain"),
             max(s["metrics_rel"]["grad_norm"] for s in out["steps"])]
    print(f"[{tag}] {name} at full width, 2 gloo ranks sharing the card x "
          f"{spec['batch'] // DP_WORLD} frames of {spec['points']} points, "
          f"{spec['steps']} steps against one process at bs={spec['batch']} "
          f"from the same state: ranks bit-identical; losses' rel diff up "
          f"to {worst[0]:.2e} with one process in the ranks' order (convs, "
          f"matmuls and BN sums on the ranks' rows apart), {worst[1]:.2e} "
          f"with its "
          f"convs and matmuls alone so, {worst[2]:.2e} plain; grad_norm "
          f"{worst[3]:.2e}; parameters beyond 1e-4: "
          f"{[s['params_share_beyond_1e-4'] for s in out['steps']]}; "
          f"gradients by group "
          f"{[s['grad_rel_by_group'] for s in out['steps']]} (bounds "
          f"{[s['grad_bound_by_group'] for s in out['steps']]})"
          + (f"; dropout's and the RoI sampler's draws, proposals and "
             f"targets ({out['targets']['sampled_slots']} sampled RoI "
             f"slots) bit-equal to the one-process rows"
             if "targets" in out else "")
          + f"; step ms per rank {rec['step_ms_per_rank']}, peak GiB per "
          f"rank {rec['peak_gib_per_rank']} (one process "
          f"{ref_peak:.3f}); launches (K1, K2) per rank "
          f"{k12}; {seconds:.1f} s for the ranks; card: {card}")
    return rec, launches, [rk["replays"] for rk in ranks]


def dp_train_cli(torch, card, tmp):
    """Phase 19c: `torchrun --nproc_per_node 1` (NCCL, a real group of one)
    runs `tools.train` with `--validate` on the first DP_CLI_FRAMES frames
    of phase 17a's on-disk set (`augmented_set`: `pillarrcnn18_waymo` as
    written, one epoch of 2 steps, one loader thread, so that GT-AUG's
    shared stream draws in sample order; the val split on the same
    frames), and the same CLI runs without torchrun: both under
    deterministic algorithms (`cli_rank`), the checkpoints bit-equal."""
    cfg = rcnn_train_cfg(RCNN)
    augmented_set(tmp, cfg, DP_CLI_FRAMES)
    steps = DP_CLI_FRAMES // cfg["data"]["samples_per_gpu"]
    path = config_file(
        tmp, "rcnn19c", RCNN, "data['workers_per_gpu'] = 1\n",
        "data['val'] = dict(data['val'], info_path=data['train']"
        "['info_path'], ann_file=data['train']['info_path'])\n",
        "total_epochs = 1\n")
    runs = {}
    for how in ("torchrun", "plain"):
        out = os.path.join(tmp, f"19c_{how}")
        argv = [os.path.join(ROOT, "chip_smoke.py"), "--cli-rank", out,
                "train", path, "--work_dir", os.path.join(out, "work"),
                "--validate", "--seed", "0"]
        if how == "torchrun":
            seconds = run_torchrun("19c", 1, argv, cwd=tmp)
        else:
            t0 = time.perf_counter()
            res = subprocess.run([sys.executable] + argv, cwd=tmp,
                                 capture_output=True, text=True,
                                 timeout=DP_TIMEOUT, env=dict(
                                     os.environ, PYTHONPATH=ROOT))
            seconds = time.perf_counter() - t0
            if res.returncode != 0:
                raise AssertionError(f"19c: the plain run exited "
                                     f"{res.returncode}: {res.stdout[-2000:]}"
                                     f"{res.stderr[-2000:]}")
        rec = read_ranks(out, 1)[0]
        rec["wall_seconds"] = seconds
        runs[how] = (rec, torch.load(os.path.join(out, "work", "epoch_1.pth"),
                                     weights_only=False))
    (dist_rec, a), (plain_rec, b) = runs["torchrun"], runs["plain"]
    if (dist_rec.get("backend"), dist_rec.get("world")) != ("nccl", 1) \
            or "backend" in plain_rec:
        raise AssertionError(f"19c: groups {dist_rec}, {plain_rec}")
    check_same_checkpoint(torch, "19c", a, b)
    for rec in (dist_rec, plain_rec):
        if rec["launches"]["pillar_scatter_max"] < steps \
                or rec["launches"]["rotated_overlap"] < 3 * steps:
            raise AssertionError(f"19c: launches {rec['launches']}")
    print(f"[19c] torchrun --nproc_per_node 1 (nccl, a group of 1) "
          f"tools.train --validate pillarrcnn18_waymo on {DP_CLI_FRAMES} of "
          f"17a's written frames (one epoch, {steps} steps, then val): "
          f"checkpoint bit-equal to the run without torchrun (model and "
          f"optimizer state, meta); {dist_rec['wall_seconds']:.1f} s / "
          f"{plain_rec['wall_seconds']:.1f} s; launches "
          f"{dist_rec['launches']}; K1 {dist_rec['replays']['k1']['calls']}"
          f" and K2 {dist_rec['replays']['k2']['calls']} calls each "
          f"bit-equal to plain; peak {dist_rec['peak_gib']:.3f} GiB; "
          f"card: {card}")
    return {"torchrun": dist_rec, "plain": plain_rec}


def check_same_checkpoint(torch, tag, a, b):
    """Two loaded trainer checkpoints with the same bits: every tensor of
    the model and optimizer states, every other value and the meta."""
    for part in ("model", "optimizer", "meta"):
        flat_a, flat_b = dict(_flat(a[part])), dict(_flat(b[part]))
        if flat_a.keys() != flat_b.keys() or not all(
                torch.equal(v, flat_b[k]) if torch.is_tensor(v)
                else v == flat_b[k] for k, v in flat_a.items()):
            raise AssertionError(f"{tag}: the checkpoints' {part} differ")


def _flat(tree, prefix=""):
    """(dotted key, leaf) pairs of a nest of dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}.")
    else:
        yield prefix, tree


def dp_dist_test(torch, card, tmp):
    """Phase 19d: `tools.dist_test` over 2 gloo ranks sharing the card
    (torchrun, `cli_rank --share-card`), each at the one-process run's batch
    size, on phase 16a's 8 written nuScenes-layout frames through
    `pillarnet34_nusc` at full width (a spread-head checkpoint): rank 0's
    merged detections against the one-process run's per token, bit-equal or
    within phase 14e's tolerances (boxes RCNN_BOX_TOL m, scores RCNN_SCORE_TOL,
    the same tokens and kept counts); every K1 and K2 call of both runs held
    bit-equal to its plain version."""
    import pickle

    from pillarnet_lts_torch.apis import load_config
    from pillarnet_lts_torch.datasets.synth import write_nuscenes_set

    cfg = load_config(FLAGSHIP)
    info = write_nuscenes_set(os.path.join(tmp, "nusc19"), EVAL_FRAMES,
                              EVAL_SWEEP_POINTS, cfg["nsweeps"],
                              cfg["class_names"], cfg["point_cloud_range"],
                              seed=160)
    path = eval_config(tmp, FLAGSHIP, info, "nusc19")
    ckpt = spread_checkpoint(torch, path, "cuda", os.path.join(tmp, "ck19"))
    args = [path, "--checkpoint", ckpt, "--seed", "0"]
    t0 = time.perf_counter()
    one, l_one, k1, k2, _ = captured_run(torch, args + [
        "--work_dir", os.path.join(tmp, "19d_one")])
    one_s = time.perf_counter() - t0
    one_replays = replay_equal(torch, k1, k2, "19d one process")
    del k1, k2
    torch.cuda.empty_cache()
    out = os.path.join(tmp, "19d_ranks")
    seconds = run_torchrun("19d", DP_WORLD, [
        os.path.join(ROOT, "chip_smoke.py"), "--cli-rank", out, "dist_test",
        "--share-card", *args, "--work_dir", os.path.join(out, "work")])
    ranks = read_ranks(out, DP_WORLD)
    with open(os.path.join(out, "work", "prediction.pkl"), "rb") as f:
        merged = pickle.load(f)
    equal, worst = detection_diff(merged, one["detections"])
    if not equal:
        kept = {t: len(d["scores"]) for t, d in merged.items()}
        if kept != {t: len(d["scores"]) for t, d in
                    one["detections"].items()} or worst > RCNN_BOX_TOL:
            raise AssertionError(f"19d: merged detections differ from the "
                                 f"one-process run's (max |d| {worst})")
    bs = cfg["data"]["samples_per_gpu"]
    for rk in ranks:
        if rk["backend"] != "gloo" or rk["frames"] != EVAL_FRAMES:
            raise AssertionError(f"19d rank {rk['rank']}: {rk}")
        expect_launches(f"19d rank {rk['rank']}", rk["launches"],
                        EVAL_FRAMES // DP_WORLD // bs,
                        EVAL_FRAMES // DP_WORLD // bs)
    rec = {"frames": EVAL_FRAMES, "batch": bs, "bit_equal": equal,
           "max_abs_diff": worst, "one_process_seconds": one_s,
           "ranks_seconds": seconds, "one_process_launches": l_one,
           "one_process_replays": one_replays, "ranks": ranks,
           "result": one["result"]["results"]}
    print(f"[19d] tools.dist_test over {DP_WORLD} gloo ranks sharing the "
          f"card (batch {bs} a rank) on {EVAL_FRAMES} nuScenes-layout "
          f"frames through pillarnet34_nusc: merged detections "
          + ("bit-equal to" if equal else f"within {worst:.2e} of")
          + f" the one-process run's, every token once; per rank "
          f"{[rk['speed']['frames_per_s'] for rk in ranks]} frames/s, peak "
          f"{[round(rk['peak_gib'], 3) for rk in ranks]} GiB, launches "
          f"{[rk['launches'] for rk in ranks]}; every K1 / K2 call of both "
          f"runs bit-equal to plain; {seconds:.1f} s (one process "
          f"{one_s:.1f} s); card: {card}")
    return rec


def data_parallel(torch, dev, card):
    """Phase 19. Returns its record, and 19a's and 19b's per-rank K1 / K2
    launches and replays."""
    import tempfile

    t0 = time.perf_counter()
    rec, launches, replays = {}, {}, {}
    rec["19a"], launches["19a"], replays["19a"] = dp_train_phase(
        torch, dev, card, "19a", FLAGSHIP, "pillarnet34_nusc")
    rec["19b"], launches["19b"], replays["19b"] = dp_train_phase(
        torch, dev, card, "19b", RCNN, "pillarrcnn18_waymo",
        points=load_cfg_points(RCNN), data_seed=400, at_gt=True)
    with tempfile.TemporaryDirectory(prefix="pillarnet_dp_") as tmp:
        rec["19c"] = dp_train_cli(torch, card, tmp)
        rec["19d"] = dp_dist_test(torch, card, tmp)
    rec["seconds"] = time.perf_counter() - t0
    print(f"[19] phase 19 took {rec['seconds']:.1f} s")
    return rec, launches, replays


# phase 20: the compact sparse path (`reader.compact_kmax`)
COMPACT_KMAX = N_POINTS  # 20a-c, e: pillarnet34_nusc's max_points
RCNN_COMPACT_KMAX = 196608  # 20d: pillarrcnn18_waymo's max_points
# detections of the compact path against the dense one from the same
# weights (f32): tests/test_compact_backbone.py:164-172
COMPACT_BOX_TOL, COMPACT_SCORE_TOL = 5e-3, 1e-3
# bf16 head maps against the dense twin's, relative to each map's max
# |value| (the port's bf16 bound: tests/test_torch_port_cuda.py, 18b)
COMPACT_BF16_REL = 5e-2
COMPACT_MATCH_M = 0.05  # a kept box's centre, matched by label
COMPACT_REQUESTS, COMPACT_WARMUP, COMPACT_BATCHES = 13, 3, 2  # 20a
COMPACT_FEW = 4  # 20c, 20d: requests, the first untimed
CONV12_CLOUDS = 3  # 20b: clouds a route's conv1 + conv2 is timed on


def compact_config(path, kmax):
    """A config with `reader.compact_kmax = kmax` (the first stage's,
    two-stage)."""
    from pillarnet_lts_torch.apis import load_config

    cfg = load_config(path)
    inner = cfg["model"].get("first_stage_cfg", cfg["model"])
    inner["reader"]["compact_kmax"] = kmax
    return cfg


def first_stage(model):
    return getattr(model, "single_det", model)


def compact_budgets(torch, tag, model, clouds):
    """Each cloud's active sites (k_valid) and the sites each budget drops
    at the default coarse budget, as the reader and the backbone count
    them (`dropped_sites`, `dropped_coarse_sites`); a cloud that fills the
    reader's budget fails. Where the coarse budget drops sites,
    `compact_kmax2` is set explicitly to cover every cloud (a truncated
    coarse table makes compact and dense differ, the JAX package's
    semantics too) and said so. Returns the record."""
    det = first_stage(model)
    backbone = det.backbone_net
    kmax = det.reader_net.compact_kmax
    default = backbone.coarse_budget(kmax)
    kmax2, backbone.compact_kmax2 = backbone.compact_kmax2, 0
    kv, fine, coarse = [], [], []
    with torch.inference_mode():
        for cloud in clouds:
            cp, _ = det.reader_net(*cloud)
            backbone.conv12(cp, None)
            kv += cp.k_valid.tolist()
            fine.append(int(det.reader_net.dropped_sites))
            coarse.append(int(backbone.dropped_coarse_sites))
    backbone.compact_kmax2 = kmax2
    rec = {"kmax": kmax, "k_valid": kv, "fine_dropped": fine,
           "coarse_dropped": coarse, "kmax2_default": default}
    if max(fine) > 0:
        raise AssertionError(f"{tag}: the reader budget {kmax} drops "
                             f"{fine} sites (k_valid {kv})")
    if max(coarse) > 0:
        backbone.compact_kmax2 = (default + max(coarse) + 7) // 8 * 8
    rec["kmax2"] = backbone.coarse_budget(kmax)
    print(f"[{tag}] budgets: {kmax} fine sites, k_valid per cloud {kv}, "
          f"dropped {fine}; the default coarse budget {default} drops "
          f"{coarse} coarse sites"
          + (f": compact_kmax2 set to {rec['kmax2']} explicitly"
             if rec["kmax2"] != default else ", no truncation"))
    return rec


def served_drops(tag, model):
    """The sites the budgets dropped in the model's last forward, as its
    reader and backbone count them; fails where either dropped any."""
    det = first_stage(model)
    rec = {"fine": int(det.reader_net.dropped_sites),
           "coarse": int(det.backbone_net.dropped_coarse_sites)}
    print(f"[{tag}] the last request's budgets dropped {rec['fine']} fine "
          f"and {rec['coarse']} coarse sites")
    if rec["fine"] or rec["coarse"]:
        raise AssertionError(f"{tag}: a served request lost sites: {rec}")
    return rec


def compact_pair(torch, dev, path, kmax, seed_cloud):
    """The dense model of a config (seeded weights, heads spread on the
    cloud) and its compact twin with the same weights."""
    from pillarnet_lts_torch.apis import (
        build_model_from_cfg, load_config, spread_head_outputs)

    dense = build_model_from_cfg(load_config(path), device=dev, seed=0)
    spread_head_outputs(dense, *seed_cloud)
    compact = build_model_from_cfg(compact_config(path, kmax), device=dev,
                                   seed=1)
    compact.load_state_dict(dense.state_dict())
    return dense, compact


def served_run(torch, dev, model, clouds, warmup, capture):
    """Requests through `ServingPipeline(make_infer_fn(model))` with the
    launch counts set to 0 just before and read just after, each request's
    launch deltas recorded (and, with `capture`, its K2 calls). Returns
    the detections, host-synced ms, per-request deltas, the run's
    launches, peak memory and the K2 calls."""
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.ops import _kernels
    from pillarnet_lts_torch.runtime.serving import ServingPipeline

    pipe = ServingPipeline(make_infer_fn(model), depth=1)
    dets, ms, deltas, k2 = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _kernels.reset_launches()
    for cloud in clouds:
        before = dict(_kernels.LAUNCHES)
        t0 = time.perf_counter()
        if capture:
            out, calls = capture_overlap(lambda: list(pipe.map(
                [on_card(torch, dev, cloud)]))[0])
            k2.append(calls)
        else:
            out = list(pipe.map([on_card(torch, dev, cloud)]))[0]
        ms.append((time.perf_counter() - t0) * 1e3)
        dets.append(out)
        deltas.append({k: v - before[k] for k, v in _kernels.LAUNCHES.items()
                       if v != before[k]})
    launches = dict(_kernels.LAUNCHES)
    return {"dets": dets, "ms": ms, "timed_ms": ms[warmup:],
            "deltas": deltas, "launches": launches,
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "k2_calls": k2}


def matched_gap(got, want, radius=COMPACT_MATCH_M):
    """Each kept box of `got` matched to the kept box of `want` with its
    label and the nearest centre (within `radius` m): the largest box and
    score |d| over the matched pairs and the boxes without a match. Slots
    may reorder where scores nearly tie; the match does not care."""
    r = {"box_max_abs": 0.0, "score_max_abs": 0.0, "matched": 0,
         "unmatched": 0, "box_by_component": {}}
    for g, w in zip(got, want):
        gm, wm = g["mask"].astype(bool), w["mask"].astype(bool)
        wb, wl, ws = (w["box3d_lidar"][wm], w["label_preds"][wm],
                      w["scores"][wm])
        for b, lab, sc in zip(g["box3d_lidar"][gm], g["label_preds"][gm],
                              g["scores"][gm]):
            d = np.linalg.norm(wb[:, :2] - b[:2], axis=-1)
            d[wl != lab] = np.inf
            j = int(d.argmin()) if d.size else -1
            if j < 0 or d[j] > radius:
                r["unmatched"] += 1
                continue
            r["matched"] += 1
            d = np.abs(wb[j] - b)
            r["box_max_abs"] = max(r["box_max_abs"], float(d.max()))
            for c, v in enumerate(d):
                if v >= r["box_by_component"].get(c, (0.0, 0.0))[0]:
                    r["box_by_component"][c] = (float(v), float(wb[j][c]))
            r["score_max_abs"] = max(r["score_max_abs"],
                                     float(abs(ws[j] - sc)))
    return r


def nudge_spread(torch, dev, model, clouds, want, draws=2, seed=20):
    """The dense route's own spread (phases 15c and 19's measure): the
    detections of `model` from its parameters times 1 + 1e-6 N(0, 1)
    (`draws` draws) on the clouds against its own (`want`), box by box
    (`matched_gap`): the largest box and score |d| and the boxes that
    found no match. The model's weights are restored."""
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.runtime.serving import to_host

    params = {n for n, _ in model.named_parameters()}
    start = state_of(torch, model)
    g = torch.Generator().manual_seed(seed)
    out = {"box_max_abs": 0.0, "score_max_abs": 0.0, "unmatched": 0}
    infer = make_infer_fn(model)
    try:
        for _ in range(draws):
            model.load_state_dict({
                n: v * (1 + 1e-6 * torch.randn(v.shape, generator=g))
                if n in params else v for n, v in start.items()})
            gap = matched_gap([to_host(infer(*on_card(torch, dev, c)))
                               for c in clouds], want)
            out["box_max_abs"] = max(out["box_max_abs"], gap["box_max_abs"])
            out["score_max_abs"] = max(out["score_max_abs"],
                                       gap["score_max_abs"])
            out["unmatched"] += gap["unmatched"]
    finally:
        model.load_state_dict(start)
    return out


def compare_detections(tag, got, want, box_tol, score_tol, spread):
    """The kept slots identical on every request and every kept box
    matched to a dense one of its label (`matched_gap`: a near score tie
    may swap two slots, the two-stage RoIs above all); the matched boxes
    within max(box_tol, 2 x the dense route's own nudge spread) m and
    their scores within max(score_tol, 2 x its spread) (`nudge_spread`:
    with random weights a box dimension is exp of a head output, so f32
    summation order moves a 20 m box by ~1e-2 m). Returns the differences
    and the bounds."""
    r = matched_gap(got, want)
    r["kept"] = sum(int(w["mask"].sum()) for w in want)
    r["same_slots"] = all(np.array_equal(g["mask"], w["mask"])
                          for g, w in zip(got, want))
    r["box_bound"] = max(box_tol, 2 * spread["box_max_abs"])
    r["score_bound"] = max(score_tol, 2 * spread["score_max_abs"])
    r["nudge_spread"] = spread
    if not r["same_slots"] or r["unmatched"] or r["kept"] < 1 \
            or r["box_max_abs"] > r["box_bound"] \
            or r["score_max_abs"] > r["score_bound"]:
        raise AssertionError(f"{tag} compact vs dense beyond tolerance: {r}")
    return r


def check_compact_launches(tag, compact, dense):
    """Every compact request launched K2 as its dense twin did and nothing
    else (no K1); returns the per-request K2 launches."""
    per = []
    for i, (c, d) in enumerate(zip(compact["deltas"], dense["deltas"])):
        k2 = d.get("rotated_overlap", 0)
        if c != {"rotated_overlap": k2} or k2 < 1 \
                or d.get("pillar_scatter_max", 0) < 1:
            raise AssertionError(f"{tag} request {i}: compact launches {c}, "
                                 f"dense {d}")
        per.append(k2)
    if compact["launches"]["pillar_scatter_max"]:
        raise AssertionError(f"{tag}: K1 launched on the compact path")
    return per


def replay_compact_k2(torch, tag, calls):
    """Every captured K2 call of the compact run bit-equal to its plain
    version (untimed) and the first timed as phase 3; returns the
    record."""
    flat = [c for req in calls for c in req]
    rec = replay_equal(torch, [], flat, tag)["k2"]
    rec["first"] = check_overlap(torch, f"{tag}'s first compact request",
                                 *flat[0], phase=tag)
    return rec


def serve_compact(torch, dev, card, tag, path, kmax, requests, warmup,
                  batches=0, bs=2, nsweeps=10):
    """Phase 20a / 20c / 20d: `path` with `reader.compact_kmax = kmax` and
    its dense twin from the same seeded weights, serving the same clouds
    (`requests` at bs=1, the first `warmup` untimed, then `batches` at
    bs=`bs`), the compact run with the launch counts set to 0 just before
    and read just after. Returns the record and the two models."""
    from pillarnet_lts_torch.apis import load_config
    from pillarnet_lts_torch.datasets import synth_points_realistic

    cfg = load_config(path)
    n, pc_range = int(cfg["data"]["max_points"]), cfg["point_cloud_range"]
    clouds = [synth_points_realistic(1, n, pc_range, seed=2000 + s,
                                     nsweeps=nsweeps)
              for s in range(requests)]
    clouds += [synth_points_realistic(bs, n, pc_range, seed=2100 + s,
                                      nsweeps=nsweeps)
               for s in range(batches)]
    dense, compact = compact_pair(torch, dev, path, kmax, on_card(
        torch, dev, synth_points_realistic(1, n, pc_range, seed=99,
                                           nsweeps=nsweeps)))
    rec = {"config": os.path.relpath(path, ROOT), "compact_kmax": kmax,
           "dtype": str(first_stage(compact).dtype),
           "budgets": compact_budgets(torch, tag, compact, [
               on_card(torch, dev, c) for c in clouds])}
    d = served_run(torch, dev, dense, clouds, warmup, capture=False)
    c = served_run(torch, dev, compact, clouds, warmup, capture=True)
    rec["dropped_last_request"] = served_drops(tag, compact)
    rec["k2_per_request"] = check_compact_launches(tag, c, d)
    rec["launches"] = c["launches"]
    for name, run in (("compact", c), ("dense", d)):
        q = statistics.quantiles(run["timed_ms"][:requests - warmup], n=10)
        rec[name] = {"p50_ms": statistics.median(
            run["timed_ms"][:requests - warmup]), "p90_ms": q[8],
            "batch_ms": run["ms"][requests:],
            "peak_allocated_gib": run["peak_gib"]}
    rec["k2_replays"] = replay_compact_k2(torch, tag, c["k2_calls"])
    rec["_dets"] = (c["dets"], d["dets"], clouds)
    print(f"[{tag}] {rec['config']} ({rec['dtype']}) compact_kmax={kmax}, "
          f"{len(clouds)} requests ({requests} at bs=1, the first "
          f"{warmup} untimed; {batches} at bs={bs}): compact p50 "
          f"{rec['compact']['p50_ms']:.2f} ms (p90 "
          f"{rec['compact']['p90_ms']:.2f}), dense p50 "
          f"{rec['dense']['p50_ms']:.2f} ms (p90 "
          f"{rec['dense']['p90_ms']:.2f}); peak allocated compact "
          f"{rec['compact']['peak_allocated_gib']:.3f} GiB, dense "
          f"{rec['dense']['peak_allocated_gib']:.3f}; compact launches "
          f"{c['launches']} (K2 per request {rec['k2_per_request']}, K1 "
          f"none); {rec['k2_replays']['calls']} K2 calls replayed "
          f"bit-equal; card: {card}")
    return rec, dense, compact


def compact_tables_card_vs_cpu(torch, dev, model, cloud, tag):
    """The first cloud's compact integer tables (site ids, k_valid, the
    SubM, strided and coarse tables, the coarse sites) from the card's
    pillar ids and the CPU's, bit-equal, and the segment-max rows from
    the card's MLP features on both devices, bit-equal."""
    from pillarnet_lts_torch.ops import compact as oc
    from pillarnet_lts_torch.ops.voxelize import voxelize_points

    det = first_stage(model)
    reader, backbone = det.reader_net, det.backbone_net
    spec, kmax = reader.spec, reader.compact_kmax
    H, W = spec.height, spec.width
    k2max = backbone.coarse_budget(kmax)

    def tables(device, feats):
        pts, msk = on_card(torch, device, cloud)
        _, ids, valid = voxelize_points(pts, msk, spec)
        rows, sites, k, _ = oc.compact_segment_max(
            feats.to(device), ids, valid, H * W, kmax)
        ids2, k2, _ = oc.downsample_site_ids(sites, k, H, W, k2max)
        return {"rows": rows, "site_ids": sites, "k_valid": k,
                "nbr1": oc.subm_neighbor_table(sites, k, H, W, kmax),
                "site_ids2": ids2, "k2_valid": k2,
                "nbr_down": oc.down_conv_neighbor_table(ids2, k2, sites, k,
                                                        H, W, kmax),
                "nbr2": oc.subm_neighbor_table(ids2, k2, H // 2, W // 2,
                                               k2max),
                "occupancy": oc.compact_to_dense(rows, sites, k, H, W)[1]}

    g = torch.Generator().manual_seed(20)
    feats = torch.relu(torch.randn((1, cloud[0].shape[1], 32), generator=g))
    with torch.inference_mode():
        got = tables(dev, feats)
        want = tables("cpu", feats)
    for key, w in want.items():
        if not (got[key].dtype == w.dtype
                and torch.equal(got[key].cpu(), w)):
            raise AssertionError(f"{tag}: {key} differs card vs CPU")
    print(f"[{tag}] the first cloud's compact tables card vs CPU bit-equal: "
          f"{', '.join(want)} (k_valid {want['k_valid'].tolist()}, k2 "
          f"{want['k2_valid'].tolist()})")
    return {"k_valid": want["k_valid"].tolist(),
            "k2_valid": want["k2_valid"].tolist(), "bit_equal": list(want)}


def conv12_inputs(torch, dev, dense, compact, clouds):
    """Each cloud's dense reader output and compact table."""
    with torch.inference_mode():
        return ([first_stage(dense).reader_net(*c) for c in clouds],
                [first_stage(compact).reader_net(*c)[0] for c in clouds])


def compact_tables(torch, backbone, cp):
    """The tables `_conv12_compact` builds from one reader table."""
    from pillarnet_lts_torch.ops import compact as oc

    H, W = cp.height, cp.width
    kmax = cp.site_ids.shape[1]
    k2max = backbone.coarse_budget(kmax)
    nbr1 = oc.subm_neighbor_table(cp.site_ids, cp.k_valid, H, W, kmax)
    ids2, k2, _ = oc.downsample_site_ids(cp.site_ids, cp.k_valid, H, W,
                                         k2max)
    return (nbr1.long(), ids2, k2,
            oc.down_conv_neighbor_table(ids2, k2, cp.site_ids, cp.k_valid,
                                        H, W, kmax).long(),
            oc.subm_neighbor_table(ids2, k2, H // 2, W // 2, k2max).long())


def peak_of(torch, dev, fn):
    """Peak memory allocated by fn() above what was allocated before, GiB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated(dev) - base) / 2**30


def conv12_times(torch, dev, tag, dense, compact, clouds):
    """Phase 20b on one precision: device time of conv1 + conv2
    (`PillarResNet.conv12`) by each route on the same clouds, from
    `torch.profiler` kernel sums, a cloud's mean; each reader alone;
    the compact route split into table building (`compact_tables`), the
    im2col gathers and the matmuls of its 16 gather convs (replayed from
    the recorded `gather_conv` calls of one cloud), the densify
    (`compact_to_dense` of conv1's and conv2's rows) and the rest (bias,
    BN fold, re-zero, ReLU, residual adds); each route's kernel groups,
    serial p50 (host clock, synced) and peak memory above its input."""
    from pillarnet_lts_torch.models.backbones import compact_exec
    from pillarnet_lts_torch.ops import compact as oc

    bd, bc = first_stage(dense).backbone_net, first_stage(compact).backbone_net
    d_in, c_in = conv12_inputs(torch, dev, dense, compact, clouds)
    n = len(clouds)
    rec = {"clouds": n, "k_valid": [int(cp.k_valid[0]) for cp in c_in]}
    with torch.inference_mode():
        for name, fn in (
                ("reader_dense", lambda: [first_stage(dense).reader_net(*c)
                                          for c in clouds]),
                ("reader_compact", lambda: [
                    first_stage(compact).reader_net(*c) for c in clouds]),
                ("conv12_dense", lambda: [bd.conv12(*x) for x in d_in]),
                ("conv12_compact", lambda: [bc.conv12(cp, None)
                                            for cp in c_in]),
                ("tables", lambda: [compact_tables(torch, bc, cp)
                                    for cp in c_in])):
            ms, per = device_ms(fn, iters=2)
            rec[f"{name}_ms"] = ms / n
            if name.startswith("conv12"):
                groups = {}
                for k_ms, k in per:
                    g = group_of(k)
                    groups[g] = groups.get(g, 0.0) + k_ms / n
                rec[f"{name}_groups_ms"] = groups
                rec[f"{name}_top"] = [{"name": k[:100], "ms": k_ms / n}
                                      for k_ms, k in per[:6]]
        calls = []  # (rows, index, weight) of each gather conv
        with recording(compact_exec, "gather_conv", calls,
                       keep=lambda a, k: (a[0], a[1].idx, a[2])):
            out = bc.conv12(c_in[0], None)
        rec["gather_convs"] = len(calls)
        rec["gather_ms"] = device_ms(lambda: [oc._take(r, nb)
                                              for r, nb, _ in calls],
                                     iters=2)[0]
        cols = [oc._take(r, nb).reshape(nb.shape[0], nb.shape[1], -1)
                for r, nb, _ in calls]
        rec["matmul_ms"] = device_ms(lambda: [g @ w for g, (_, _, w) in
                                              zip(cols, calls)], iters=2)[0]
        rec["gather_bytes"] = sum(nbytes(r, nb, c) for c, (r, nb, _)
                                  in zip(cols, calls))
        rec["gather_bound_ms"] = bound(rec["gather_bytes"], 0, F32_OPS)[0]
        rec["matmul_flop"] = sum(2 * c.shape[0] * c.shape[1] * c.shape[2]
                                 * w.shape[1] for c, (_, _, w) in
                                 zip(cols, calls))
        del cols
        cp = c_in[0]
        _, ids2, k2, _, _ = compact_tables(torch, bc, cp)
        x1 = torch.zeros_like(cp.rows[:, :, :1]).expand(
            -1, -1, bc.in_channels).contiguous()
        x2 = x1.new_zeros((1, ids2.shape[1] + 1, 2 * bc.in_channels))
        rec["densify_ms"] = device_ms(lambda: (
            oc.compact_to_dense(compact_exec._ext(x1), cp.site_ids,
                                cp.k_valid, cp.height, cp.width),
            oc.compact_to_dense(x2, ids2, k2, cp.height // 2,
                                cp.width // 2)), iters=2)[0]
        rec["compact_rest_ms"] = (rec["conv12_compact_ms"] - rec["tables_ms"]
                                  - rec["gather_ms"] - rec["matmul_ms"]
                                  - rec["densify_ms"])
        del out, calls
        # MACs of the two routes' convs: dense over every site of the grid,
        # compact over the budget's rows (and over the active rows alone)
        H, W, c = cp.height, cp.width, bc.in_channels
        convs1 = 2 * bc.conv1_blocks + 1
        convs2 = 1 + 2 * bc.conv2.num_blocks
        k2max = ids2.shape[1]
        per1, per2 = 9 * c * c * convs1, 9 * c * c * (2 + 4 * (convs2 - 1))
        rec["macs_dense"] = per1 * H * W + per2 * (H // 2) * (W // 2)
        rec["macs_compact"] = per1 * cp.site_ids.shape[1] + per2 * k2max
        rec["macs_compact_active"] = (per1 * int(cp.k_valid[0])
                                      + per2 * int(k2[0]))
        for name, fn in (("dense", lambda: bd.conv12(*d_in[0])),
                         ("compact", lambda: bc.conv12(c_in[0], None))):
            lat = []
            for i in range(8):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                if i >= 3:
                    lat.append((time.perf_counter() - t0) * 1e3)
            rec[f"conv12_{name}_serial_p50_ms"] = statistics.median(lat)
            rec[f"conv12_{name}_peak_gib"] = peak_of(torch, dev, fn)
    print(f"[{tag}] conv1 + conv2 device ms a cloud (profiler, {n} clouds, "
          f"k_valid {rec['k_valid']}): dense {rec['conv12_dense_ms']:.3f}, "
          f"compact {rec['conv12_compact_ms']:.3f} = tables "
          f"{rec['tables_ms']:.3f} + gathers {rec['gather_ms']:.3f} "
          f"(bound {rec['gather_bound_ms']:.3f}) + matmuls "
          f"{rec['matmul_ms']:.3f} ({rec['gather_convs']} convs, "
          f"{rec['matmul_flop'] / 1e9:.2f} GFLOP) + densify "
          f"{rec['densify_ms']:.3f} + the rest "
          f"{rec['compact_rest_ms']:.3f}; readers: dense (K1) "
          f"{rec['reader_dense_ms']:.3f}, compact (segment max) "
          f"{rec['reader_compact_ms']:.3f}; MACs dense "
          f"{rec['macs_dense'] / 1e9:.2f} G, compact "
          f"{rec['macs_compact'] / 1e9:.2f} G (active rows "
          f"{rec['macs_compact_active'] / 1e9:.2f} G); serial p50 dense "
          f"{rec['conv12_dense_serial_p50_ms']:.3f} ms, compact "
          f"{rec['conv12_compact_serial_p50_ms']:.3f} ms; peak above the "
          f"input dense {rec['conv12_dense_peak_gib']:.3f} GiB, compact "
          f"{rec['conv12_compact_peak_gib']:.3f} GiB")
    for route in ("dense", "compact"):
        print(f"[{tag}]   {route} by group: " + ", ".join(
            f"{g} {v:.3f}" for g, v in sorted(
                rec[f"conv12_{route}_groups_ms"].items(),
                key=lambda x: -x[1])) + "; top: " + "; ".join(
            f"{t['name'][:60]} {t['ms']:.3f}"
            for t in rec[f"conv12_{route}_top"][:4]))
    return rec


def head_errors(got, want):
    """{(task, head): max |got - want| / max |want|} of two forwards' head
    maps."""
    return {(t, h): ((g[h].float() - w[h].float()).abs().max()
                     / w[h].float().abs().max().clamp_min(1e-30)).item()
            for t, (g, w) in enumerate(zip(got, want)) for h in w}


def compact_bf16(torch, dev, card):
    """Phase 20c: `pillarnet34_nusc_bf16` with the compact reader against
    its dense bf16 twin, COMPACT_FEW requests. Every head map of the
    compact route within max(COMPACT_BF16_REL, 2 x the dense route's own
    bf16 error) of the dense route's, relative to its max |value|: the
    own error is the dense bf16 map against the f32 model of the same
    weights (`pillarnet34_nusc`), and two bf16 routes that each round that
    far from f32 may differ by twice it. The kept boxes matched to the
    dense ones by label and centre (`matched_gap`) and reported: bf16
    scores tie and reorder, and a candidate near a threshold may fall
    either way."""
    from pillarnet_lts_torch.apis import build_model_from_cfg, load_config
    from pillarnet_lts_torch.datasets import synth_points_realistic

    rec, dense, compact = serve_compact(
        torch, dev, card, "20c", FLAGSHIP.replace(".py", "_bf16.py"),
        COMPACT_KMAX, COMPACT_FEW, 1)
    cfg = load_config(FLAGSHIP)
    f32 = build_model_from_cfg(cfg, device=dev, seed=1)
    f32.load_state_dict(dense.state_dict())
    worst = {"compact_vs_dense": 0.0, "compact_vs_f32": 0.0,
             "dense_vs_f32": 0.0, "bound": 0.0}
    with torch.inference_mode():
        for s in range(COMPACT_FEW):
            cloud = on_card(torch, dev, synth_points_realistic(
                1, int(cfg["data"]["max_points"]), cfg["point_cloud_range"],
                seed=2000 + s))
            pc, pd, pf = compact(*cloud), dense(*cloud), f32(*cloud)
            e_cd, e_c, e_d = (head_errors(pc, pd), head_errors(pc, pf),
                              head_errors(pd, pf))
            for k, e in e_cd.items():
                b = max(COMPACT_BF16_REL, 2 * e_d[k])
                if e > b:
                    raise AssertionError(
                        f"20c cloud {s} task {k[0]} {k[1]}: compact vs dense "
                        f"{e:.3e} of its max, bound {b:.3e} (dense vs f32 "
                        f"{e_d[k]:.3e}, compact vs f32 {e_c[k]:.3e})")
            for name, errs in (("compact_vs_dense", e_cd),
                               ("compact_vs_f32", e_c),
                               ("dense_vs_f32", e_d)):
                worst[name] = max(worst[name], max(errs.values()))
            worst["bound"] = max(worst["bound"], max(
                max(COMPACT_BF16_REL, 2 * e) for e in e_d.values()))
    del f32
    got, want, _ = rec.pop("_dets")
    gap = matched_gap(got, want)
    rec["bf16"] = dict(heads_max_rel=worst, detections=gap,
                       compact_kept=sum(int(g["mask"].sum()) for g in got),
                       dense_kept=sum(int(w["mask"].sum()) for w in want))
    print(f"[20c] bf16 head maps, largest |d| / max |value| over the maps: "
          f"compact vs dense {worst['compact_vs_dense']:.3e} (each map "
          f"within max({COMPACT_BF16_REL}, 2 x its dense vs f32)), dense "
          f"vs f32 {worst['dense_vs_f32']:.3e}, compact vs f32 "
          f"{worst['compact_vs_f32']:.3e}; kept boxes compact "
          f"{rec['bf16']['compact_kept']}, dense {rec['bf16']['dense_kept']}"
          f": {gap['matched']} matched by label within {COMPACT_MATCH_M} m "
          f"(box |d| <= {gap['box_max_abs']:.3e}, score |d| <= "
          f"{gap['score_max_abs']:.3e}), {gap['unmatched']} without a match")
    return rec, dense, compact


def compact_training(torch, dev, card):
    """Phase 20e: two training steps of `pillarnet34_nusc` at bs=4 (13c's
    batch) with the compact reader against the dense route on the same
    batch, each step from the same state (the compact run's model and
    optimizer state before it): the metrics (`check_metrics`, losses
    within max(2 x the dense step's own spread under a 1e-6 weight nudge,
    DP_LOSS_RTOL_PLAIN)) and the gradients by module group
    (`check_grad_groups`, within min(max(2 x the spread, DP_GRAD_RTOL),
    DP_GRAD_CAP)), as phase 19 holds ranks to one process; no kernel
    launched on the compact route (single-stage training runs no NMS);
    each route's step ms (host, synced) and peak memory."""
    from pillarnet_lts_torch.apis import (build_model_from_cfg, load_config,
                                          optimizer_from_cfg)
    from pillarnet_lts_torch.datasets import SynthDataset, collate_batch
    from pillarnet_lts_torch.ops import _kernels
    from pillarnet_lts_torch.runtime.train_step import (batch_to_device,
                                                        train_step)

    cfg = load_config(FLAGSHIP)
    bs = cfg["data"]["samples_per_gpu"]
    ds = SynthDataset(cfg, bs, cfg["data"]["max_points"], seed=200,
                      num_boxes=(10, 21))
    batch = batch_to_device(collate_batch(
        [ds[i] for i in range(bs)], cfg["data"]["max_points"]), dev)
    dense = build_model_from_cfg(cfg, device=dev, seed=0).train()
    compact = build_model_from_cfg(compact_config(FLAGSHIP, COMPACT_KMAX),
                                   device=dev, seed=1).train()
    compact.load_state_dict(dense.state_dict())
    budgets = compact_budgets(torch, "20e", compact.eval(), [
        (batch["points"][i:i + 1], batch["points_mask"][i:i + 1])
        for i in range(bs)])
    compact.train()
    opts = {"dense": optimizer_from_cfg(dense, cfg, 2),
            "compact": optimizer_from_cfg(compact, cfg, 2)}
    params = [n for n, _ in dense.named_parameters()]
    g = torch.Generator().manual_seed(20)

    def step(route, model, weights=None, opt_state=None):
        opt = opts[route]
        if weights is not None:
            model.load_state_dict(weights)
            opt.load_state_dict(opt_state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = dict(_kernels.LAUNCHES)
        t0 = time.perf_counter()
        m = {k: float(v) for k, v in train_step(model, opt, batch,
                                                cfg["train_cfg"]).items()}
        ms = (time.perf_counter() - t0) * 1e3
        launched = {k: v - before[k] for k, v in _kernels.LAUNCHES.items()
                    if v != before[k]}
        return (m, grads_of(torch, model), ms,
                torch.cuda.max_memory_allocated(dev) / 2**30, launched)

    rec = {"config": "configs/pillarnet/pillarnet34_nusc.py", "batch": bs,
           "compact_kmax": COMPACT_KMAX, "budgets": budgets, "steps": []}
    for s in range(2):
        # on the CPU: every load copies it (a same-device load would share
        # the optimizer's moments with `start`)
        start = (state_of(torch, compact),
                 on_cpu(torch, opts["compact"].state_dict()))
        md, gd, ms_d, peak_d, ld = step("dense", dense, *start)
        nudged = []
        for _ in range(DP_NUDGES):
            w = {n: v * (1 + 1e-6 * torch.randn(v.shape, generator=g))
                 if n in params else v for n, v in start[0].items()}
            mn, gn, _, _, _ = step("dense", dense, w, start[1])
            nudged.append((mn, gn))
        mc, gc, ms_c, peak_c, lc = step("compact", compact)
        if lc:
            raise AssertionError(f"20e step {s}: the compact step launched "
                                 f"{lc}")
        groups = [grad_diffs(torch, gr, gd)[0] for _, gr in nudged]
        spread = {"metrics": {k: max(rel_diff(m[k], md[k])
                                     for m, _ in nudged) for k in md},
                  "grad_groups": {k: max(gr[k] for gr in groups)
                                  for k in groups[0]}}
        rel, tol = check_metrics(f"20e compact vs dense", s, mc, md,
                                 spread["metrics"], DP_LOSS_RTOL_PLAIN)
        grp, bounds, leaf = check_grad_groups(torch, "20e compact vs dense",
                                              s, gc, gd,
                                              spread["grad_groups"])
        rec["steps"].append({
            "loss_compact": mc["loss"], "loss_dense": md["loss"],
            "metrics_rel": rel, "metrics_tol": tol,
            "grad_rel_by_group": grp, "grad_bounds": bounds,
            "grad_worst_leaf": {"name": leaf[1], "rel": leaf[2]},
            "step_ms_compact": ms_c, "step_ms_dense": ms_d,
            "peak_gib_compact": peak_c, "peak_gib_dense": peak_d,
            "dense_launches": ld})
        print(f"[20e] step {s}: loss compact {mc['loss']:.6f}, dense "
              f"{md['loss']:.6f} (largest metric rel "
              f"{max(rel.values()):.2e}); gradients by group rel "
              + ", ".join(f"{k} {v:.2e} (bound {bounds[k]:.2e})"
                          for k, v in grp.items())
              + f"; step ms compact {ms_c:.1f}, dense {ms_d:.1f}; peak "
              f"allocated compact {peak_c:.3f} GiB, dense {peak_d:.3f} GiB")
    del dense, compact, opts
    torch.cuda.empty_cache()
    return rec


def check_vs_dense(torch, dev, tag, rec, dense):
    """20a / 20d: the compact detections of `serve_compact` against the
    dense twin's (`compare_detections`, the dense route's nudge spread
    measured on the same clouds); printed and returned."""
    got, want, clouds = rec.pop("_dets")
    r = compare_detections(tag, got, want, COMPACT_BOX_TOL,
                           COMPACT_SCORE_TOL,
                           nudge_spread(torch, dev, dense, clouds, want))
    names = ("x", "y", "z", "w", "l", "h", "vx", "vy", "rot")
    print(f"[{tag}] compact vs dense detections: {r['kept']} kept slots "
          f"identical, each kept box matched to a dense one of its label "
          f"within {COMPACT_MATCH_M} m; max |d| box {r['box_max_abs']:.3e} m "
          f"(bound {r['box_bound']:.3e}: {COMPACT_BOX_TOL} or twice the "
          f"dense route's own {r['nudge_spread']['box_max_abs']:.3e} under "
          f"a 1e-6 weight nudge), score {r['score_max_abs']:.3e} (bound "
          f"{r['score_bound']:.3e}); by component " + ", ".join(
              f"{names[c] if c < len(names) else c} {d:.2e} at {v:.2f}"
              for c, (d, v) in sorted(r["box_by_component"].items()))
          + f"; the nudged dense route left "
          f"{r['nudge_spread']['unmatched']} kept boxes without a match")
    return r


def compact_path(torch, dev, card):
    """Phase 20. Returns its record and K2's launches and replays on the
    compact paths."""
    t0 = time.perf_counter()
    rec = {}
    a, dense, compact = serve_compact(
        torch, dev, card, "20a", FLAGSHIP, COMPACT_KMAX, COMPACT_REQUESTS,
        COMPACT_WARMUP, COMPACT_BATCHES)
    a["vs_dense"] = check_vs_dense(torch, dev, "20a", a, dense)
    from pillarnet_lts_torch.apis import load_config
    from pillarnet_lts_torch.datasets import synth_points_realistic
    from pillarnet_lts_torch.eval_utils import make_infer_fn

    cfg = load_config(FLAGSHIP)
    n, pc_range = int(cfg["data"]["max_points"]), cfg["point_cloud_range"]
    first = synth_points_realistic(1, n, pc_range, seed=2000)
    a["tables_card_vs_cpu"] = compact_tables_card_vs_cpu(
        torch, dev, compact, first, "20a")
    check_no_sync(torch, make_infer_fn(compact), *on_card(torch, dev, first),
                  "20a")
    rec["20a"] = a
    conv_clouds = [on_card(torch, dev, synth_points_realistic(
        1, n, pc_range, seed=2000 + s))
        for s in range(CONV12_CLOUDS)]
    rec["20b"] = {"f32": conv12_times(torch, dev, "20b f32", dense, compact,
                                      conv_clouds)}
    del dense, compact
    torch.cuda.empty_cache()
    rec["20c"], dense, compact = compact_bf16(torch, dev, card)
    rec["20b"]["bf16"] = conv12_times(torch, dev, "20b bf16", dense, compact,
                                      conv_clouds)
    del dense, compact, conv_clouds
    torch.cuda.empty_cache()
    d, dense, compact = serve_compact(torch, dev, card, "20d", RCNN,
                                      RCNN_COMPACT_KMAX, COMPACT_FEW, 1,
                                      nsweeps=1)
    d["vs_dense"] = check_vs_dense(torch, dev, "20d", d, dense)
    rec["20d"] = d
    del dense, compact
    torch.cuda.empty_cache()
    rec["20e"] = compact_training(torch, dev, card)
    rec["seconds"] = time.perf_counter() - t0
    print(f"[20] phase 20 took {rec['seconds']:.1f} s")
    launches = {t: rec[t]["launches"]["rotated_overlap"]
                for t in ("20a", "20c", "20d")}
    replays = {t: {k: v for k, v in rec[t]["k2_replays"].items()
                   if k != "first"} for t in ("20a", "20c", "20d")}
    return rec, launches, replays


# phase 21: the serving export (`runtime/export.py`)
EXPORT_WARMUP, EXPORT_REQUESTS = 2, 10  # a side: untimed, then timed
EXPORT_BATCHES = 3  # distinct request batches, cycled
EXPORT_INT8_BATCH = 8  # 21b: the JAX package's `--batch 8 --int8` deploy
EXPORT_TIMEOUT = 600  # s: the program server is killed past it
# the modules a program server must not have imported
SERVER_FORBIDDEN = ("jax", "pillarnet_lts_tpu", "pillarnet_lts_torch.models",
                    "pillarnet_lts_torch.apis")


def served_requests(torch, infer, batches, dev):
    """EXPORT_WARMUP + EXPORT_REQUESTS requests of `infer` on `batches`
    (cycled), each host-synced: returns the detections of the first
    len(batches) requests (numpy), each request's kernel launches and the
    timed requests' ms."""
    from pillarnet_lts_torch.ops import _kernels
    from pillarnet_lts_torch.runtime.serving import to_host

    dets, launches, ms = [], [], []
    for i in range(EXPORT_WARMUP + EXPORT_REQUESTS):
        pts, msk = on_card(torch, dev, batches[i % len(batches)])
        before = dict(_kernels.LAUNCHES)
        t0 = time.perf_counter()
        with torch.inference_mode():
            det = to_host(infer(pts, msk))
        dt = (time.perf_counter() - t0) * 1e3
        launches.append({k: v - before[k]
                         for k, v in _kernels.LAUNCHES.items()
                         if v > before[k]})
        if i < len(batches):
            dets.append(det)
        if i >= EXPORT_WARMUP:
            ms.append(dt)
    return dets, launches, ms


def kernel_op_mode(torch, on_call):
    """A `TorchDispatchMode` that calls on_call(name, args, out) after each
    `pillarnet::*` op run inside it (the kernel ops of `ops/library.py`, as
    a traced program calls them)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.namespace == "pillarnet":
                on_call(func._opname, args, out)
            return out

    return Mode()


def time_int8_call(torch, shapes, args, kw, out, tag):
    """One captured K4 call of a program: held bit-equal to its plain
    version (`replay_int8_equal`) and timed as `check_int8_conv` times it
    (wrapper and plain version, CUDA events), with its bound; the first
    call of each distinct shape also with its kernels alone (`device_ms`).
    Added to its shape's entry of `shapes`; nothing of the call is kept.
    Returns its largest |d|."""
    from pillarnet_lts_torch.ops.quant import (
        int8_conv_bn_act, int8_conv_bn_act_plain)

    err = replay_int8_equal(torch, [(args, kw, out)], f"{tag} program")[1]
    (b_ms, b_by), sites = int8_conv_bound(torch, args, kw, out)
    x, w_q, stride = args[0], args[1], args[5]
    key = (tuple(x.shape), w_q.shape[3], stride, kw["mask"] is not None,
           kw["residual"] is not None)
    s = shapes.get(key)
    if s is None:
        s = shapes[key] = {"launches": 0, "ms": [], "plain_ms": [],
                           "bound_ms": [], "bound_by": b_by, "sites": []}
        s["alone_ms"] = device_ms(lambda: int8_conv_bn_act(*args, **kw),
                                  iters=5)[0]
    s["launches"] += 1
    s["ms"].append(cuda_ms(lambda: int8_conv_bn_act(*args, **kw)))
    s["plain_ms"].append(cuda_ms(
        lambda: int8_conv_bn_act_plain(*args, **plain_kwargs(kw)),
        iters=PLAIN_ITERS, warmup=1))
    s["bound_ms"].append(b_ms)
    s["sites"].append(sites)
    return err


def int8_request_summary(shapes, err, tag):
    """`time_int8_call`'s shapes as rows (means over each shape's calls)
    and their per-request sums; printed."""
    rows, request = [], {k: 0.0 for k in ("ms", "alone_ms", "plain_ms",
                                          "bound_ms")}
    for (xs, cout, stride, has_mask, has_res), s in shapes.items():
        n = s["launches"]
        r = {"shape": f"{xs[0]}x{xs[1]}x{xs[2]}x{xs[3]} -> {cout}, stride "
                      f"{stride}" + (", mask" if has_mask else ", dense")
                      + (", residual" if has_res else ""),
             "launches": n, "ms": statistics.mean(s["ms"]),
             "alone_ms": s["alone_ms"],
             "plain_ms": statistics.mean(s["plain_ms"]),
             "bound_ms": statistics.mean(s["bound_ms"]),
             "bound_by": s["bound_by"],
             "active_sites": statistics.mean(s["sites"])}
        rows.append(r)
        for k in request:
            request[k] += n * r[k]
        print(f"[{tag}] K4 (program) {r['shape']}: {n} calls, bit-equal; "
              f"wrapper {r['ms']:.4f} ms, kernels alone {r['alone_ms']:.4f} "
              f"ms (its first call), plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}; "
              f"{r['bound_ms'] / r['alone_ms']:.0%} of it alone); "
              f"{r['active_sites']:.0f} active output sites")
    calls = sum(r["launches"] for r in rows)
    print(f"[{tag}] K4 (program) per request ({calls} calls, each bit-equal "
          f"to its plain version, max |d| {err}): wrapper "
          f"{request['ms']:.4f} ms, kernels alone {request['alone_ms']:.4f} "
          f"ms, plain {request['plain_ms']:.4f} ms, bound "
          f"{request['bound_ms']:.4f} ms ("
          f"{request['bound_ms'] / request['alone_ms']:.0%} of it alone)")
    return {"calls": calls, "max_abs_err": err, "request": request,
            "shapes": rows}


def replay_program_calls(torch, module, batch, dev, tag):
    """One request of a loaded program with its kernel op calls captured:
    K1's and K2's replayed against their plain versions and timed
    (`replay_scatter`, `replay_overlap`), K4's (either variant) held
    bit-equal to the plain version and timed as they run
    (`time_int8_call`: at batch 8 the inputs of all its calls do not fit
    beside the model). Returns the summaries."""
    from pillarnet_lts_torch.ops.quant import unpack_kernel

    k1, k2, k4, shapes = [], [], [], {}

    def on_call(name, args, out):
        if name == "pillar_scatter_max":
            k1.append((args[:5], {"nonneg": args[5]}))
        elif name == "rotated_overlap":
            k2.append(args)
        elif name in ("int8_conv", "int8_conv_f32", "int8_conv_pc",
                      "int8_conv_pc_f32"):
            x, w_pack, inv_s, dq, shift, stride, mask, residual, act = args
            kw = {"mask": mask, "residual": residual, "act": act,
                  "w_pack": w_pack}
            k4.append(time_int8_call(torch, shapes, (
                x, unpack_kernel(w_pack).contiguous(), inv_s, dq, shift,
                stride), kw, out, tag))

    pts, msk = on_card(torch, dev, batch)
    with torch.inference_mode(), kernel_op_mode(torch, on_call):
        module(pts, msk)
    torch.cuda.synchronize()
    out = {}
    if k1:
        out["k1"] = replay_summary(replay_scatter(torch, k1))
        print_replays(tag, "K1 pillar_scatter_max (program)", out["k1"])
    if k2:
        out["k2"] = replay_summary(replay_overlap(torch, k2, "program"))
        print_replays(tag, "K2 rotated_overlap (program)", out["k2"])
    if k4:
        out["k4"] = int8_request_summary(shapes, max(k4), tag)
    return out


def serve_artifact(spec_path):
    """Phase 21's program server (`python3 chip_smoke.py --serve-artifact
    SPEC`): load the program with torch and `ops.library` alone, serve the
    spec's clouds as `served_requests` does, replay one request's kernel
    calls, and write the detections and a JSON record beside the spec."""
    import torch

    sys.path.insert(0, ROOT)
    from pillarnet_lts_torch.ops import _kernels
    from pillarnet_lts_torch.runtime.export import load_serving

    with open(spec_path) as f:
        spec = json.load(f)
    tag, dev = spec["tag"], torch.device(spec["device"])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _kernels.build_all()  # the parent built them: loads its libraries
    t0 = time.perf_counter()
    module = load_serving(spec["program"]).module()
    load_s = time.perf_counter() - t0
    present = [m for m in SERVER_FORBIDDEN if m in sys.modules]
    if present:
        raise AssertionError(f"the program server imported {present}")
    data = np.load(spec["clouds"])
    batches = [(data[f"points{i}"], data[f"mask{i}"])
               for i in range(len(data.files) // 2)]
    dets, launches, ms = served_requests(torch, module, batches, dev)
    replays = replay_program_calls(torch, module, batches[0], dev, tag)
    np.savez(spec["dets"], **{f"{k}{i}": v for i, d in enumerate(dets)
                              for k, v in d.items()})
    with open(spec["record"], "w") as f:
        json.dump({"load_s": load_s, "launches": launches, "ms": ms,
                   "replays": replays,
                   "modules": sorted(m for m in sys.modules
                                     if m.startswith("pillarnet_lts_torch"))},
                  f)
    print(f"[{tag}] program server: loaded in {load_s:.2f} s with "
          f"{', '.join(SERVER_FORBIDDEN)} not imported; "
          f"{len(ms)} timed requests")
    return 0


def export_cell(torch, dev, card, tag, model, batches, tmp):
    """One cell of phase 21: eager serving, the export, the program served
    by a fresh process, and the checks. Returns its record."""
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.runtime.export import (export_serving,
                                                    save_serving)

    B, n = batches[0][0].shape[:2]
    eager, eager_launches, eager_ms = served_requests(
        torch, make_infer_fn(model), batches, dev)
    t0 = time.perf_counter()
    program = export_serving(model, B, n, dev)
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    ops = sorted({str(nd.target).split(".")[1] for nd in program.graph.nodes
                  if nd.op == "call_function"
                  and str(nd.target).startswith("pillarnet.")})
    if "data_ptr" in program.graph_module.code:
        raise AssertionError(f"{tag}: the traced graph reads a data pointer")
    path = os.path.join(tmp, f"{tag}.pt2")
    save_serving(program, path)
    del program
    spec = {"tag": tag, "program": path, "device": str(dev),
            "clouds": os.path.join(tmp, f"{tag}_clouds.npz"),
            "dets": os.path.join(tmp, f"{tag}_dets.npz"),
            "record": os.path.join(tmp, f"{tag}.json")}
    np.savez(spec["clouds"], **{f"{k}{i}": a for i, (p, m) in
                                enumerate(batches)
                                for k, a in (("points", p), ("mask", m))})
    with open(os.path.join(tmp, f"{tag}_spec.json"), "w") as f:
        json.dump(spec, f)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--serve-artifact",
                          os.path.join(tmp, f"{tag}_spec.json")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=EXPORT_TIMEOUT)
    server_s = time.perf_counter() - t0
    sys.stdout.write(out.stdout)
    if out.returncode != 0:
        raise AssertionError(f"{tag}: the program server failed "
                             f"({out.returncode}):\n{out.stderr[-4000:]}")
    with open(spec["record"]) as f:
        served = json.load(f)
    got = np.load(spec["dets"])
    for i, det in enumerate(eager):
        for k, v in det.items():
            if not np.array_equal(got[f"{k}{i}"], v):
                raise AssertionError(f"{tag}: request {i} {k} of the program"
                                     f" differs from eager serving")
    if served["launches"] != eager_launches:
        raise AssertionError(f"{tag}: launches a request, program "
                             f"{served['launches']} vs eager "
                             f"{eager_launches}")
    per_request = eager_launches[-1]
    kept = [int(d["mask"].sum()) for d in eager]
    rec = {"batch": int(B), "points": int(n), "export_s": export_s,
           "program_mb": os.path.getsize(path) / 1e6, "ops": ops,
           "server_s": server_s, "load_s": served["load_s"],
           "launches_per_request": per_request,
           "eager_p50_ms": statistics.median(eager_ms),
           "program_p50_ms": statistics.median(served["ms"]),
           "eager_ms": eager_ms, "program_ms": served["ms"],
           "kept": kept, "replays": served["replays"],
           "server_modules": served["modules"]}
    rec["eager_frames_per_s"] = B * 1e3 / rec["eager_p50_ms"]
    rec["program_frames_per_s"] = B * 1e3 / rec["program_p50_ms"]
    print(f"[{tag}] exported in {export_s:.2f} s to {rec['program_mb']:.1f} "
          f"MB (ops {', '.join(ops)}); the program served "
          f"{len(served['ms'])} timed requests of batch {B} x {n} points in "
          f"a fresh process, detections bit-equal to eager's on all "
          f"{len(eager)} batches (kept {kept}), launches a request "
          f"{per_request} as eager; host-synced p50 eager "
          f"{rec['eager_p50_ms']:.2f} ms vs program "
          f"{rec['program_p50_ms']:.2f} ms ({rec['eager_frames_per_s']:.2f} "
          f"vs {rec['program_frames_per_s']:.2f} frames/s); card: {card}")
    return rec


def export_clouds(cfg, batch, seed0, **kw):
    from pillarnet_lts_torch.datasets import synth_points_realistic

    n, pc_range = int(cfg["data"]["max_points"]), cfg["point_cloud_range"]
    return [synth_points_realistic(batch, n, pc_range, seed=seed0 + i, **kw)
            for i in range(EXPORT_BATCHES)]


def dispatch_cost(torch, dev, card, calls=2000):
    """The custom-op dispatcher's host cost per call: K2 on 8 x 8 pairs
    (a launch-bound call), through `torch.ops.pillarnet.rotated_overlap`
    and through its CUDA implementation called directly, host microseconds
    a call over `calls` calls each, in turns (op, direct, direct, op)."""
    from pillarnet_lts_torch.ops import library

    quads = torch.rand(1, 8, 4, 2, device=dev)
    fns = {"op": torch.ops.pillarnet.rotated_overlap,
           "direct": library._rotated_overlap_cuda}
    us = {k: [] for k in fns}
    for name in ("op", "direct", "direct", "op"):
        fn = fns[name]
        fn(quads, quads)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(quads, quads)
        us[name].append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    rec = {k: statistics.mean(v) for k, v in us.items()}
    rec["per_call_us"] = rec["op"] - rec["direct"]
    print(f"[21] the custom-op dispatcher: K2 on 8 x 8 pairs {rec['op']:.2f} "
          f"us a call through the op, {rec['direct']:.2f} us through its "
          f"CUDA implementation called directly (host clock, {calls} calls "
          f"each, in turns): {rec['per_call_us']:.2f} us a call; card: "
          f"{card}")
    return rec


def serving_export(torch, dev, card):
    """Phase 21. Returns its record."""
    import tempfile

    from pillarnet_lts_torch.apis import (build_model_from_cfg, load_config,
                                          spread_head_outputs)
    from pillarnet_lts_torch.datasets import synth_points_realistic

    t0 = time.perf_counter()
    rec = {}
    with tempfile.TemporaryDirectory() as tmp:
        # 21a: phase 5's weights
        cfg = load_config(FLAGSHIP)
        n = int(cfg["data"]["max_points"])
        model = build_model_from_cfg(cfg, device=dev, seed=0)
        spread_head_outputs(model, *on_card(torch, dev, synth_points_realistic(
            1, n, cfg["point_cloud_range"], seed=99)))
        rec["21a"] = export_cell(torch, dev, card, "21a", model,
                                 export_clouds(cfg, 1, 500), tmp)
        # 21b: phase 6's int8 flagship at batch 8, fused stage off
        model, _, _ = int8_flagship(torch, dev, tag="21b")
        rec["21b"] = export_cell(
            torch, dev, card, "21b", model,
            export_clouds(load_config(FLAGSHIP_INT8), EXPORT_INT8_BATCH,
                          600), tmp)
        del model
        # 21c: phase 14's weights
        cfg = load_config(RCNN)
        n = int(cfg["data"]["max_points"])
        model = build_model_from_cfg(cfg, device=dev, seed=0)
        spread_head_outputs(model, *on_card(torch, dev, synth_points_realistic(
            1, n, cfg["point_cloud_range"], seed=99, nsweeps=1)))
        rec["21c"] = export_cell(torch, dev, card, "21c", model,
                                 export_clouds(cfg, 1, 700, nsweeps=1), tmp)
        del model
    torch.cuda.empty_cache()
    rec["dispatch"] = dispatch_cost(torch, dev, card)
    rec["seconds"] = time.perf_counter() - t0
    print(f"[21] phase 21 took {rec['seconds']:.1f} s")
    return rec


# phase 22: dataset preparation -> training -> evaluation, no JAX, no devkit
PREP_SEQUENCES = 2  # 22a: raw Waymo sequences a split
PREP_FRAMES = {"train": 4, "val": 2}  # frames a sequence: 8 train, 4 val


def numpy_route(*natives):
    """Each host library module in `natives` made to say it is not there
    (`available` False, the two box functions None): the numpy route of
    `core/bbox/box_np_ops.py` (all patched while open)."""
    stack = contextlib.ExitStack()
    for native in natives:
        stack.enter_context(patched(native, "available",
                                    lambda real: lambda: False))
        for name in ("points_in_rbbox", "box_collision_test"):
            stack.enter_context(patched(native, name,
                                        lambda real: lambda *a, **k: None))
    return stack


def data_prep_numpy(argv):
    """`python3 chip_smoke.py --data-prep-numpy ARGS`: `tools/create_data.
    py`'s main (ARGS its arguments) on the numpy route (`numpy_route`)."""
    sys.path.insert(0, ROOT)
    from pillarnet_lts_torch import native
    from pillarnet_lts_torch.tools import create_data

    with numpy_route(native):
        create_data.main(argv)
    return 0


def create_data_run(root, split, route):
    """`python -m pillarnet_lts_torch.tools.create_data waymo_data_prep` on
    `root` (`route` "native"; "numpy": through `data_prep_numpy`) in a
    subprocess; returns the seconds the command reports and its wall
    seconds. Fails unless the command reports the host library on the
    native route and none on the numpy route."""
    args = ["waymo_data_prep", "--root_path", root, "--split", split]
    argv = ([sys.executable, "-m", "pillarnet_lts_torch.tools.create_data"]
            if route == "native" else
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--data-prep-numpy"])
    t0 = time.perf_counter()
    out = subprocess.run(argv + args, cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"22a: create_data {split} ({route}) exited "
                             f"{out.returncode}: {out.stderr[-3000:]}")
    said = [ln for ln in out.stdout.splitlines()
            if ln.startswith("waymo_data_prep: ")]
    if len(said) != 1:
        raise AssertionError(f"22a: create_data printed {out.stdout[-2000:]}")
    library = said[0].split("host library: ")[-1]
    if (library == "None") != (route == "numpy"):
        raise AssertionError(f"22a: create_data {split} ({route}) ran on "
                             f"host library {library}")
    return float(said[0].split()[1]), wall


def prep_config(tmp, root):
    """pillarrcnn18_waymo at full width on the prepared set under `root`:
    the infos under the names `create_data` writes (the config's own), the
    GT-AUG database at `dbinfos_train_1sweeps.pkl` (the name
    `create_data` writes; the config reads `..._withvelo.pkl`, the JAX
    package's name fault), 2 frames a step, one epoch of every other
    frame, a log line a step."""
    return config_file(
        tmp, "prep_rcnn", RCNN,
        f"db_sampler['db_info_path'] = {root!r} + "
        "'dbinfos_train_1sweeps.pkl'\n",
        "data['samples_per_gpu'] = 2\n",
        f"data['train'] = dict(data['train'], root_path={root!r}, "
        f"info_path={root!r} + 'infos_train_01sweeps_filter_zero_gt.pkl', "
        "load_interval=2)\n",
        f"data['val'] = dict(data['val'], root_path={root!r}, "
        f"info_path={root!r} + 'infos_val_01sweeps_filter_zero_gt.pkl')\n",
        "log_config = dict(interval=1)\n", "total_epochs = 1\n")


def data_prep_chain(torch, dev, card):
    """Phase 22: the host library built; raw Waymo frames (the converter's
    layout, `write_waymo_raw`) at the Waymo configs' cloud size; the
    `create_data` CLI over both splits on each route (22a); the training
    CLI's main on `pillarrcnn18_waymo` at full width over the prepared
    infos and database, K1 / K2 counted (set to 0 just before, read just
    after) and their calls replayed against the plain versions (22b);
    `dist_test`'s main on its checkpoint over the val frames, the native
    Waymo evaluator (22c). The loader's ms a sample on each route is
    phase 17a's, on the set of the earlier loader numbers. Returns
    (record, 22b's launches, 22b's replays)."""
    import tempfile

    from pillarnet_lts_torch import native
    from pillarnet_lts_torch.apis import load_config
    from pillarnet_lts_torch.datasets.synth import write_waymo_raw
    from pillarnet_lts_torch.ops import _kernels
    from pillarnet_lts_torch.tools import train as train_cli

    t_phase = time.perf_counter()
    if not native.available():
        raise AssertionError(f"22a: the host library did not build:\n"
                             f"{native.build_error()}")
    cfg = load_config(RCNN)
    n = int(cfg["data"]["max_points"])
    rec = {"card": card, "points": n, "library": native.library_path(),
           "frames": {s: PREP_SEQUENCES * f for s, f in PREP_FRAMES.items()}}
    with tempfile.TemporaryDirectory() as tmp:
        roots = {r: os.path.join(tmp, r) + "/" for r in ("native", "numpy")}
        t0 = time.perf_counter()
        for split, frames in PREP_FRAMES.items():
            write_waymo_raw(roots["native"], split, PREP_SEQUENCES, frames, n,
                            cfg["point_cloud_range"], seed=220)
        os.makedirs(roots["numpy"])
        for split in PREP_FRAMES:
            os.symlink(os.path.join(roots["native"], split),
                       os.path.join(roots["numpy"], split))
        rec["write_s"] = time.perf_counter() - t0
        rec["create_data"] = {}
        for route in ("numpy", "native"):
            for split in PREP_FRAMES:
                said, wall = create_data_run(roots[route], split, route)
                rec["create_data"][f"{route}_{split}"] = {
                    "seconds": said, "wall_s": wall,
                    "s_per_frame": said / rec["frames"][split]}
        with open(os.path.join(roots["native"], "dbinfos_train_1sweeps.pkl"),
                  "rb") as f:
            dbinfos = pickle.load(f)
        rec["database"] = {str(k): len(v) for k, v in dbinfos.items()}
        with open(os.path.join(roots["numpy"], "dbinfos_train_1sweeps.pkl"),
                  "rb") as f:
            rec["database_numpy"] = {str(k): len(v)
                                     for k, v in pickle.load(f).items()}
        c = rec["create_data"]
        print(f"[22a] create_data waymo_data_prep on {rec['frames']} raw "
              f"frames of {n} points: train {c['native_train']['seconds']:.3f}"
              f" s native ({c['native_train']['s_per_frame']:.4f} s a frame)"
              f" / {c['numpy_train']['seconds']:.3f} s numpy "
              f"({c['numpy_train']['s_per_frame']:.4f}); val "
              f"{c['native_val']['seconds']:.3f} / "
              f"{c['numpy_val']['seconds']:.3f} s; database "
              f"{rec['database']} (numpy route {rec['database_numpy']}); "
              f"{card}")

        # 22b: the training CLI on the prepared data
        path = prep_config(tmp, roots["native"])
        work = os.path.join(tmp, "work")
        _kernels.reset_launches()
        t0 = time.perf_counter()
        (_, k2), k1 = capture_scatter(lambda: capture_overlap(
            lambda: train_cli.main([path, "--work_dir", work, "--seed",
                                    "22"])))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = dict(_kernels.LAUNCHES)
        with open(os.path.join(work, "log.json")) as f:
            logged = [json.loads(line) for line in f]
        losses = [r["loss"] for r in logged]
        steps = len(losses)
        if not losses or not all(math.isfinite(v) for v in losses) \
                or not os.path.exists(os.path.join(work, "epoch_1.pth")):
            raise AssertionError(f"22b: losses {losses}, {os.listdir(work)}")
        if launches["pillar_scatter_max"] < 1 or launches[
                "rotated_overlap"] < 1 or (len(k1), len(k2)) != (
                launches["pillar_scatter_max"], launches["rotated_overlap"]):
            raise AssertionError(f"22b: launches {launches}, captured "
                                 f"{len(k1)} K1 and {len(k2)} K2 calls")
        rec["train"] = {"seconds": train_s, "steps": steps, "loss": losses,
                        "launches": launches,
                        "step_ms": [r["time"] * 1e3 for r in logged]}
        print(f"[22b] python -m pillarnet_lts_torch.tools.train "
              f"pillarrcnn18_waymo (bs 2, GT-AUG from the prepared database) "
              f"on the card: {steps} logged steps in {train_s:.1f} s, loss "
              f"{losses}, K1 {launches['pillar_scatter_max']} / K2 "
              f"{launches['rotated_overlap']} launches")
        summary, _ = replay_pass(torch, "22b", k1, k2,
                                 "predict and RoI sampler")
        del k1, k2

        # 22c: dist_test of that checkpoint, the native Waymo evaluator
        out, ev = dist_test_run(torch, [
            path, "--checkpoint", os.path.join(work, "epoch_1.pth"),
            "--work_dir", os.path.join(tmp, "eval")])
        if "Waymo (native eval)" not in out["result"]["results"]["waymo"] \
                or len(out["detections"]) != rec["frames"]["val"]:
            raise AssertionError(f"22c: {out['result']}")
        rec["dist_test"] = {"launches": ev, "frames": len(out["detections"]),
                            "result": out["result"]["results"]["waymo"]}
        print(f"[22c] dist_test on the checkpoint over "
              f"{len(out['detections'])} val frames: the native Waymo "
              f"evaluator, launches {ev}")
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"[22] phase 22 took {rec['seconds']:.1f} s")
    return rec, launches, summary


# phase 23: the two-stage remainder (bf16 training, the head variants, K5
# on f32 activations)
BF16_TRAIN_BS, BF16_TRAIN_STEPS = 4, 3  # 23a: per config, the first untimed
BF16_NUDGES = 2  # 23a: the bf16 demo's nudged CPU runs (card vs CPU)
# 23a: the bf16 demo's second stage card vs CPU, at the tolerances of
# tests/test_torch_port_rcnn_heads.py's bf16 second stage against JAX
BF16_LOSS_RTOL, BF16_GRAD_RTOL = 2e-2, 5e-2
VARIANT_REQUESTS, VARIANT_WARMUP = 6, 1  # 23b: bs=1, untimed first
VARIANT_TRAIN_STEPS, VARIANT_NEAR = 2, 100  # 23b: bs=4; RoI slots near GT
VARIANT_NUDGES = 2  # 23b: the demo's nudged CPU runs (card vs CPU)
FUSED_F32_REQUESTS = 21  # 23c: per route, bs=1, the first untimed
STAGE_ROUNDS = 10  # 23c: the stride-1 stage timed on each route in turns
STAGE_SHAPE = (1, 1440, 1440)  # 23c: K5 f32 and bf16 at the bf16 row's shape
STAGE_OCCUPANCY = 0.077  # ... at the flagship's share of active pillars


def time_first_calls(torch, replays, k1, k2, tag):
    """Into `replay_equal`'s record: the first K1 call and the first
    non-empty K2 call timed as phases 2-3."""
    k2 = [c for c in k2 if c[0].numel() and c[1].numel()]
    if k1:
        replays["k1"]["first_call"] = replay_summary(
            replay_scatter(torch, k1[:1]))
    if k2:
        replays["k2"]["first_call"] = replay_summary(
            replay_overlap(torch, k2[:1], tag))
    print(f"[{tag}] replays: K1 {len(k1)} calls, K2 "
          f"{replays['k2']['calls']} calls, each bit-equal to its plain "
          f"version (the first of each timed)")
    return replays


def bf16_train_run(torch, dev, card, path, twin):
    """Phase 23a: `path` (a bf16 config as written) at full width trained
    at bs=BF16_TRAIN_BS for BF16_TRAIN_STEPS steps by `train_step` on
    seeded synthetic scenes (the two-stage config with VARIANT_NEAR RoI
    slots near the GT, so the regression runs): every metric finite, the
    parameters f32; step ms (synced by the metrics' read-back), samples/s
    and peak memory beside the f32 twin's (`twin`: phase 13c's or 15d's
    record); the launch counts set to 0 just before, read just after, and
    every K1 and K2 call replayed."""
    from pillarnet_lts_torch.apis import (build_model_from_cfg,
                                          optimizer_from_cfg)
    from pillarnet_lts_torch.datasets import SynthDataset, collate_batch
    from pillarnet_lts_torch.ops import _kernels
    from pillarnet_lts_torch.runtime.train_step import (
        batch_to_device, step_generator, train_step)

    cfg = rcnn_train_cfg(path)
    two_stage = "roi_head" in cfg["model"]
    bs, n = BF16_TRAIN_BS, int(cfg["data"]["max_points"])
    ds = SynthDataset(cfg, bs, n, seed=700, num_boxes=(10, 21))
    batch = batch_to_device(collate_batch([ds[i] for i in range(bs)], n),
                            dev)
    model = build_model_from_cfg(cfg, device=dev, seed=0)
    if model.dtype != torch.bfloat16:
        raise AssertionError(f"{path}: dtype {model.dtype}")
    opt = optimizer_from_cfg(model, cfg, BF16_TRAIN_STEPS)
    metrics, step_ms = [], []
    torch.cuda.reset_peak_memory_stats(dev)
    _kernels.reset_launches()
    def steps():
        for s in range(BF16_TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = train_step(model, opt, batch, cfg["train_cfg"],
                           step_generator(0, s, dev))
            metrics.append({k: float(v) for k, v in m.items()})
            step_ms.append((time.perf_counter() - t0) * 1e3)

    with contextlib.ExitStack() as stack:
        if two_stage:
            stack.enter_context(proposals_near_gt(torch, VARIANT_NEAR, 19))
        (_, k2), k1 = capture_scatter(lambda: capture_overlap(steps))
    launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    for s, m in enumerate(metrics):
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"[23a] {path} step {s}: non-finite {bad}")
    if not all(p.dtype == torch.float32 for p in model.parameters()):
        raise AssertionError("[23a] a parameter left f32")
    k2_per_step = 3 if two_stage else 1  # predict per task (+ the sampler)
    if launches["pillar_scatter_max"] != BF16_TRAIN_STEPS or (
            two_stage and launches["rotated_overlap"] < k2_per_step
            * BF16_TRAIN_STEPS):
        raise AssertionError(f"[23a] {path}: launches {launches}")
    timed = step_ms[1:]
    med = statistics.median(timed)
    rec = {"config": os.path.relpath(path, ROOT), "batch": bs,
           "steps": BF16_TRAIN_STEPS, "step_ms": step_ms,
           "median_step_ms": med, "samples_per_s": bs / med * 1e3,
           "peak_allocated_gib": peak / 2**30, "launches": launches,
           "loss": [m["loss"] for m in metrics],
           "grad_norm": [m["grad_norm"] for m in metrics],
           "f32_twin": {k: twin.get(k) for k in (
               "config", "median_step_ms", "samples_per_s",
               "peak_allocated_gib")}}
    if two_stage:
        rec["roi_reg_loss"] = [m["roi_reg_loss_task0"] for m in metrics]
        rec["point_loss"] = [m["point_loss_task0"] for m in metrics]
    print(f"[23a] {rec['config']} (bf16, as written) training, bs={bs}, "
          f"{BF16_TRAIN_STEPS} steps (the first untimed): median step "
          f"{med:.1f} ms, {rec['samples_per_s']:.3f} samples/s, peak "
          f"allocated {rec['peak_allocated_gib']:.3f} GiB; the f32 twin "
          f"({twin.get('config')}): {twin.get('median_step_ms', 0):.1f} ms, "
          f"{twin.get('samples_per_s', 0):.3f} samples/s, "
          f"{twin.get('peak_allocated_gib', 0):.3f} GiB; loss "
          f"{rec['loss'][0]:.3f} -> {rec['loss'][-1]:.3f}; launches "
          f"{ {k: v for k, v in launches.items() if v} }; card: {card}")
    rec["replays"] = time_first_calls(
        torch, replay_equal(torch, k1, k2, "23a"), k1, k2, "23a")
    del k1, k2, model, opt, batch
    torch.cuda.empty_cache()
    return rec


def bf16_step_card_vs_cpu(torch, dev):
    """Phase 23a: one train step of the bf16 `pillarrcnn18_demo` (dropout
    off, a fifth of the RoI slots near the GT) on the card and on the CPU
    from the same weights, batch and draws. A bf16 step on random weights
    is chaotic: a one-ulp flip grows about twofold a stage, and cuDNN and
    the CPU's kernels round their bf16 sums at other places. So, as the
    CPU test holds the port's bf16 step to the JAX package's own spread
    over its builds (`tests/test_torch_port_bf16_train.py`), and as phase
    15c holds the f32 card to the CPU's spread under a nudge at f32's
    rounding scale, the card is held to the CPU's own spread under a
    nudge at bf16's: the CPU step again from the parameters times
    1 + 2^-8 N(0, 1) (BF16_NUDGES draws; one bf16 ulp, relative). The
    card's largest relative difference of any metric from the CPU's at
    most twice the nudged runs' largest; every metric finite."""
    from pillarnet_lts_torch.apis import (build_model_from_cfg,
                                          optimizer_from_cfg,
                                          spread_head_outputs)
    from pillarnet_lts_torch.datasets import SynthDataset, collate_batch
    from pillarnet_lts_torch.runtime.train_step import (batch_to_device,
                                                        train_step)

    cfg = rcnn_train_cfg(RCNN_DEMO, dp_ratio=0.0)
    cfg["model"]["dtype"] = "bfloat16"
    near = sum(cfg["test_cfg"]["nms"]["nms_post_max_size"]) // 5
    ds = SynthDataset(cfg, 2, 4096, seed=31)
    batch = collate_batch([ds[0], ds[1]], cfg["data"]["max_points"])
    cpu = build_model_from_cfg(cfg, device="cpu", seed=3)
    b_cpu = batch_to_device(batch, "cpu")
    spread_head_outputs(cpu, b_cpu["points"], b_cpu["points_mask"])
    state = {k: v.clone() for k, v in cpu.state_dict().items()}
    params = {n for n, _ in cpu.named_parameters()}
    g = torch.Generator().manual_seed(16)
    nudged = [{k: v * (1 + 2.0 ** -8 * torch.randn(v.shape, generator=g))
               if k in params else v for k, v in state.items()}
              for _ in range(BF16_NUDGES)]
    runs = []
    for d, weights in [(dev, state), (torch.device("cpu"), state)] + [
            (torch.device("cpu"), w) for w in nudged]:
        model = build_model_from_cfg(cfg, device=d, seed=4)
        model.load_state_dict(weights)
        opt = optimizer_from_cfg(model, cfg, 10)
        with proposals_near_gt(torch, near, 17):
            m = train_step(model, opt, batch_to_device(batch, d),
                           cfg["train_cfg"], torch.Generator().manual_seed(5))
        runs.append({k: float(v) for k, v in m.items()})
    card, plain = runs[:2]
    for m in runs:
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"[23a] bf16 demo step: non-finite {m}")
    keys = [k for k in plain if plain[k] != 0]

    def rel(m):
        return {k: abs(m[k] - plain[k]) / abs(plain[k]) for k in keys}

    card_rel = rel(card)
    own = max(max(rel(m).values()) for m in runs[2:])
    worst = max(card_rel, key=card_rel.get)
    if card_rel[worst] > 2 * own:
        raise AssertionError(
            f"[23a] bf16 demo card vs CPU {worst}: rel {card_rel[worst]:.2e} "
            f"beyond twice the CPU's own spread {own:.2e}")
    print(f"[23a] bf16 pillarrcnn18_demo, one step on the card and on the "
          f"CPU (same weights, batch 2, draws; {near} RoI slots near the "
          f"GT): loss {card['loss']:.6f} / {plain['loss']:.6f}; the largest "
          f"metric rel diff {card_rel[worst]:.2e} ({worst}); the CPU's own "
          f"spread under a one-ulp bf16 nudge ({BF16_NUDGES} draws) "
          f"{own:.2e}")
    return {"metrics_rel": card_rel, "cpu_nudge_spread": own,
            "loss": [card["loss"], plain["loss"]],
            "second_stage": bf16_second_stage_card_vs_cpu(
                torch, dev, cfg, state, b_cpu["gt_boxes_and_cls"])}


_SECOND_STAGE = ("second_stage_0", "point_head_net", "roi_head_net")


@contextlib.contextmanager
def relu_decisions(decisions, record, flips=None):
    """`F.relu` of the second stage's modules (the BEV convs, the Dense
    layers, the RoI heads) recording its decisions (x > 0, on the host)
    into `decisions`, or, with `record` False, taking them in turn
    (x times the decision; the count of values on the other side of 0
    added to flips[0]): the ReLU's derivative jumps at 0, and a value
    rounded across 0 on one device flips a gradient path."""
    import types

    import torch.nn.functional as F
    from pillarnet_lts_torch.models.backbones import base
    from pillarnet_lts_torch.models.roi_heads import roi_heads
    from pillarnet_lts_torch.models.second_stage import bev_feature
    from pillarnet_lts_torch.models.utils import dense

    taken = []

    class Relu(types.ModuleType):
        def __getattr__(self, name):
            return getattr(F, name)

        def relu(self, x):
            if record:
                decisions.append((x > 0).cpu())
                return F.relu(x)
            d = decisions[len(taken)]
            taken.append(d)
            if d.shape != x.shape:
                raise AssertionError(f"relu {len(taken)}: {d.shape} vs "
                                     f"{x.shape}")
            if flips is not None:
                flips[0] += int(((x > 0).cpu() != d).sum())
            return x * d.to(x.device, x.dtype)

    with contextlib.ExitStack() as stack:
        for mod in (base, bev_feature, dense, roi_heads):
            stack.enter_context(patched(mod, "F", lambda real: Relu("F")))
        yield
    if not record and len(taken) != len(decisions):
        raise AssertionError(f"{len(taken)} of {len(decisions)} ReLU "
                             f"decisions taken")


def bf16_second_stage_card_vs_cpu(torch, dev, cfg, state, gt):
    """Phase 23a: the bf16 demo's training second stage (`cfg`, weights
    `state`) on the card and on the CPU from the same fixed first-stage
    outputs, which is not chaotic as the whole step is: bf16 neck and
    conv3 maps drawn from a seed at the demo's size, every RoI slot a box
    jittered about a GT row of `gt` (`near_gt`), the same sampler draws,
    the card's ReLUs taking the CPU's decisions (`relu_decisions`, as the
    CPU test's JAX package takes the port's).
    The sampled RoI labels and masks equal, the soft labels within 1e-5
    (each from an f32 IoU); each loss (RCNN classification, regression,
    point) within BF16_LOSS_RTOL; the gradient of the classification and
    point losses within
    BF16_GRAD_RTOL in norm for every weight leaf (kernels, BN scales) and
    for each module's whole gradient, biases included, as
    `tests/test_torch_port_rcnn_heads.py` holds the bf16 second stage
    against the JAX package. The regression L1 flips its gradient with
    the sign of each refinement that starts within rounding of its
    target (the CPU test makes the JAX package take the port's signs; the
    card cannot), so the whole loss's gradient is a reading."""
    from pillarnet_lts_torch.apis import build_model_from_cfg
    from pillarnet_lts_torch.models.roi_heads.proposal_target_layer import (
        sampler_draws)

    B = gt.shape[0]
    R = sum(cfg["test_cfg"]["nms"]["nms_post_max_size"])
    M = cfg["model"]["roi_head"]["model_cfg"]["TARGET_CONFIG"][
        "ROI_PER_IMAGE"]
    g = torch.Generator().manual_seed(18)
    box, cls, score, has = near_gt(gt, torch.rand(B, R, 8, generator=g))
    first = {"box3d_lidar": box, "mask": has.expand(B, R),
             "label_preds": (cls - 1).clamp_min(0).to(torch.int32),
             "scores": score}
    occ = torch.rand(B, 16, 16, generator=g) < 0.5
    maps = (torch.randn(B, 128, 16, 16, generator=g).bfloat16(),
            (torch.randn(B, 64, 16, 16, generator=g) * occ[:, None])
            .bfloat16())
    runs, decisions, flips = [], [], [0]
    for d in (torch.device("cpu"), dev):
        model = build_model_from_cfg(cfg, device=d, seed=4)
        model.load_state_dict(state)
        model.train()
        params = [(n, p) for n, p in model.named_parameters()
                  if n.split(".")[0] in _SECOND_STAGE]
        with relu_decisions(decisions, d.type == "cpu", flips):
            out = model.second_stage_train(
                {k: v.to(d) for k, v in first.items()}, (maps[0].to(d),),
                {"conv3": (maps[1].to(d), occ.to(d))}, gt.to(d),
                sampler_draws(torch.Generator().manual_seed(19), B, R, M,
                              d))
        losses = dict(zip(("roi_cls", "roi_reg", "point"),
                          model.second_stage_losses(out)))
        grads = {}
        for part, loss in (("smooth", losses["roi_cls"] + losses["point"]),
                           ("whole", sum(losses.values()))):
            got = torch.autograd.grad(loss, [p for _, p in params],
                                      retain_graph=True, allow_unused=True)
            grads[part] = {n: (torch.zeros_like(p) if t is None else t)
                           .detach().cpu().double()
                           for (n, p), t in zip(params, got)}
        runs.append({"losses": {k: float(v.detach())
                                for k, v in losses.items()},
                     "targets": {k: out["targets"][k].cpu() for k in (
                         "roi_labels", "reg_valid_mask", "rcnn_cls_labels")},
                     "grads": grads})
        del model, out, losses
    cpu, card = runs
    for k, v in cpu["targets"].items():
        # the soft labels come from each RoI's f32 IoU with its GT
        d = (card["targets"][k].float() - v.float()).abs().max().item()
        if d > (1e-5 if k == "rcnn_cls_labels" else 0):
            raise AssertionError(f"[23a] bf16 second stage: {k} differs "
                                 f"between the card and the CPU by {d}")
    if not (cpu["targets"]["reg_valid_mask"] > 0).any():
        raise AssertionError("[23a] bf16 second stage: no foreground RoI")
    loss_rel = {k: abs(card["losses"][k] - v) / abs(v)
                for k, v in cpu["losses"].items()}

    def rel(a, b):
        return float((a - b).norm() / b.norm()) if b.norm() > 0 else 0.0

    def readings(part):
        c, w = card["grads"][part], cpu["grads"][part]
        leaves = {n: rel(c[n], w[n]) for n in w
                  if n.endswith(".weight") and w[n].norm() > 0}
        modules = {m: rel(torch.cat([c[n].ravel() for n in w
                                     if n.split(".")[0] == m]),
                          torch.cat([w[n].ravel() for n in w
                                     if n.split(".")[0] == m]))
                   for m in _SECOND_STAGE}
        return leaves, modules

    leaves, modules = readings("smooth")
    whole_leaves, whole_modules = readings("whole")
    worst = max(leaves, key=leaves.get)
    bad = ([f"loss {k} {v:.2e}" for k, v in loss_rel.items()
            if not v <= BF16_LOSS_RTOL]
           + [f"grad {k} {v:.2e}" for k, v in {**leaves, **modules}.items()
              if not v <= BF16_GRAD_RTOL])
    if bad:
        raise AssertionError(f"[23a] bf16 second stage card vs CPU beyond "
                             f"its tolerances: {', '.join(bad)}")
    rec = {"loss_rel": loss_rel, "smooth_grad_worst_leaf": [worst,
                                                            leaves[worst]],
           "smooth_grad_modules": modules,
           "whole_grad_worst_leaf": max(whole_leaves.items(),
                                        key=lambda kv: kv[1]),
           "whole_grad_modules": whole_modules,
           "fg_rois": int((cpu["targets"]["reg_valid_mask"] > 0).sum()),
           "relu_flips": [flips[0], sum(int(t.numel()) for t in decisions)]}
    print(f"[23a] bf16 pillarrcnn18_demo second stage on fixed first-stage "
          f"outputs, card vs CPU (same weights, maps, RoIs, draws; "
          f"{rec['fg_rois']} fg RoIs; the card's ReLUs take the CPU's "
          f"decisions, {flips[0]} of {rec['relu_flips'][1]} on the other "
          f"side of 0 there): the sampled targets equal; loss rel "
          f"{ {k: f'{v:.2e}' for k, v in loss_rel.items()} } (limit "
          f"{BF16_LOSS_RTOL}); cls + point gradient: worst weight leaf "
          f"{worst} {leaves[worst]:.2e}, modules "
          f"{ {k: f'{v:.2e}' for k, v in modules.items()} } (limit "
          f"{BF16_GRAD_RTOL}); with the regression L1 (a reading): worst "
          f"leaf {rec['whole_grad_worst_leaf'][0]} "
          f"{rec['whole_grad_worst_leaf'][1]:.2e}, modules "
          f"{ {k: f'{v:.2e}' for k, v in whole_modules.items()} }")
    return rec


def variant_detections(det, posts, tag):
    """A variant's served detections (random second-stage weights):
    padded (1, R, 7) finite boxes, scores in [0, 1], some kept, each kept
    box with positive dimensions. Returns the kept count."""
    R = sum(posts)
    for key, shape in (("box3d_lidar", (1, R, 7)), ("scores", (1, R)),
                       ("label_preds", (1, R)), ("mask", (1, R))):
        if det[key].shape != shape:
            raise AssertionError(f"{tag}: {key} shape {det[key].shape}")
    m = det["mask"].astype(bool)
    if not (np.isfinite(det["box3d_lidar"]).all()
            and np.isfinite(det["scores"]).all() and m.any()
            and ((det["scores"] >= 0) & (det["scores"] <= 1)).all()
            and (det["box3d_lidar"][m][:, 3:6] > 0).all()):
        raise AssertionError(f"{tag}: detections out of their contract "
                             f"({int(m.sum())} kept)")
    return int(m.sum())


def serve_variant(torch, dev, card, variant):
    """Phase 23b: `pillarrcnn18_waymo` (f32, full width) with `variant`
    (`rcnn_variant`), seeded weights and a spread first-stage head:
    VARIANT_REQUESTS requests at bs=1 (the first untimed) with the launch
    counts set to 0 just before and read just after, K1 once and K2 once
    per task on each; finite detections of the served shape; the second
    stage's device ms (CUDA events); then VARIANT_TRAIN_STEPS training
    steps at bs=4 (VARIANT_NEAR RoI slots near the GT): every metric
    finite, the IoU loss (RoIFFNHead) or the point loss positive; every
    K1 and K2 call of the last step replayed; and one step of the demo
    config with the variant on the card against the CPU
    (`rcnn_train_card_vs_cpu`)."""
    from pillarnet_lts_torch.apis import (
        build_model_from_cfg, load_config, optimizer_from_cfg, rcnn_variant,
        spread_head_outputs)
    from pillarnet_lts_torch.datasets import (SynthDataset, collate_batch,
                                              synth_points_realistic)
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.ops import _kernels
    from pillarnet_lts_torch.runtime.train_step import (
        batch_to_device, step_generator, train_step)

    tag = f"23b {variant}"
    cfg = load_config(RCNN)
    cfg["model"] = rcnn_variant(cfg["model"], variant)
    n, pc_range = int(cfg["data"]["max_points"]), cfg["point_cloud_range"]
    posts = cfg["test_cfg"]["nms"]["nms_post_max_size"]
    model = build_model_from_cfg(cfg, device=dev, seed=0)
    spread_head_outputs(model, *on_card(torch, dev, synth_points_realistic(
        1, n, pc_range, seed=99, nsweeps=1)))
    path = precision_path(model, False)
    infer = make_infer_fn(model)
    clouds = [on_card(torch, dev, synth_points_realistic(
        1, n, pc_range, seed=800 + s, nsweeps=1))
        for s in range(VARIANT_REQUESTS)]
    lat, kept = [], []
    _kernels.reset_launches()
    for i, cloud in enumerate(clouds):
        before = dict(_kernels.LAUNCHES)
        t0 = time.perf_counter()
        det = {k: v.cpu().numpy() for k, v in infer(*cloud).items()}
        dt = (time.perf_counter() - t0) * 1e3
        got = {k: v - before[k] for k, v in _kernels.LAUNCHES.items()
               if v != before[k]}
        if got != path:
            raise AssertionError(f"[{tag}] request {i}: launches {got}, "
                                 f"the path is {path}")
        kept.append(variant_detections(det, posts, f"[{tag}] request {i}"))
        if i >= VARIANT_WARMUP:
            lat.append(dt)
    launches = dict(_kernels.LAUNCHES)
    split = rcnn_stage_split(torch, model, clouds[-1], iters=5)
    rec = {"variant": variant, "requests": len(clouds), "launches": launches,
           "p50_ms": statistics.median(lat),
           "second_stage_ms": split["second_stage_ms"],
           "second_stage_alone_ms": split["second_stage_alone_ms"],
           "first_stage_ms": split["first_stage_ms"],
           "mean_kept": statistics.mean(kept)}
    del infer, clouds
    model.train()
    bs = BF16_TRAIN_BS
    ds = SynthDataset(cfg, bs, n, seed=900, num_boxes=(10, 21))
    batch = batch_to_device(collate_batch([ds[i] for i in range(bs)], n),
                            dev)
    opt = optimizer_from_cfg(model, cfg, VARIANT_TRAIN_STEPS)
    metrics, k1, k2 = [], [], []
    with proposals_near_gt(torch, VARIANT_NEAR, 21):
        for s in range(VARIANT_TRAIN_STEPS):
            k1.clear()
            k2.clear()
            (_, calls2), calls1 = capture_scatter(lambda: capture_overlap(
                lambda: metrics.append({k: float(v) for k, v in train_step(
                    model, opt, batch, cfg["train_cfg"],
                    step_generator(0, s, dev)).items()})))
            k1.extend(calls1)
            k2.extend(calls2)
    key = "roi_iou_loss_task0" if variant == "RoIFFNHead" \
        else "point_loss_task0"
    for s, m in enumerate(metrics):
        if not all(math.isfinite(v) for v in m.values()) or not m[key] > 0:
            finite = all(map(math.isfinite, m.values()))
            raise AssertionError(f"[{tag}] step {s}: {key} {m.get(key)}, "
                                 f"finite {finite}")
    rec.update(train_loss=[m["loss"] for m in metrics],
               train_key=key, train_key_values=[m[key] for m in metrics],
               train_roi_reg_loss=[m["roi_reg_loss_task0"] for m in metrics])
    print(f"[{tag}] pillarrcnn18_waymo with {variant} (f32): bs=1 p50 "
          f"{rec['p50_ms']:.2f} ms over {len(lat)} requests (after "
          f"{VARIANT_WARMUP} warm-up), the second stage "
          f"{split['second_stage_ms']:.3f} ms (its kernels alone "
          f"{split['second_stage_alone_ms']:.3f} ms), "
          f"the first {split['first_stage_ms']:.2f} ms; mean kept "
          f"{rec['mean_kept']:.1f} of {sum(posts)}; launches {path} a "
          f"request; {VARIANT_TRAIN_STEPS} training steps at bs={bs}: {key} "
          f"{', '.join(f'{v:.4f}' for v in rec['train_key_values'])}, loss "
          f"{', '.join(f'{v:.3f}' for v in rec['train_loss'])}; card: {card}")
    rec["replays"] = time_first_calls(
        torch, replay_equal(torch, k1, k2, tag), k1, k2, tag)
    del k1, k2, model, opt, batch
    torch.cuda.empty_cache()
    rec["demo_card_vs_cpu"] = rcnn_train_card_vs_cpu(
        torch, dev, variant=variant, tag=tag, nudges=VARIANT_NUDGES)
    return rec


def stage_inputs(torch, dev, shape, n, seed, occupancy=STAGE_OCCUPANCY):
    """Synthetic K5 arguments at `shape` (B, H, W), 32 channels: an
    occupancy of clusters (runs of 8 x 8 sites around seeded centres, a
    lidar cloud's pillars cluster) at about `occupancy` of the sites, f32
    features there, seeded int8 kernels and scales of the tests'
    magnitudes."""
    g = torch.Generator().manual_seed(seed)
    B, H, W = shape
    coarse = torch.rand(B, H // 8 + 1, W // 8 + 1, generator=g) < occupancy
    occ = coarse.repeat_interleave(8, 1).repeat_interleave(8, 2)[:, :H, :W]
    occ &= torch.rand(B, H, W, generator=g) < 0.9
    x = torch.randn(B, H, W, 32, generator=g) * occ[..., None]
    w_q = torch.randint(-127, 128, (n, 3, 3, 32, 32), generator=g,
                        dtype=torch.int8)
    inv_s = 30.0 + 5 * torch.arange(n, dtype=torch.float32)
    dq = torch.rand(n, 32, generator=g) * 2e-5 + 1e-5
    shift = torch.randn(n, 32, generator=g) * 0.05
    return [t.to(dev) for t in (x, w_q, inv_s, dq, shift,
                                occ.to(torch.float32))]


def time_stage(torch, args, pack, tag):
    """K5 on `args` (x, w_q, inv_s, dq, shift, mask) in x's dtype's
    variant, against its plain version (bit-equal) and timed: wrapper,
    kernels alone, plain, bound (as phase 7)."""
    from pillarnet_lts_torch.ops.int8_stage import (int8_stage,
                                                    int8_stage_plain)

    got = int8_stage(*args, w_pack=pack)
    want = int8_stage_plain(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not torch.equal(got, want):
        raise AssertionError(f"[{tag}] K5 differs from its plain version: "
                             f"max |d| {err}, {int((got != want).sum())} "
                             f"elements")
    x, mask, n = args[0], args[5], args[1].shape[0]
    sites = int((mask != 0).sum())
    sites_in = input_sites(torch, mask, x.shape[1], x.shape[2], 1)
    r = {"shape": list(x.shape), "dtype": str(x.dtype).replace("torch.", ""),
         "n": n, "active_sites": sites, "max_abs_err": err,
         "ms": cuda_ms(lambda: int8_stage(*args, w_pack=pack)),
         "alone_ms": device_ms(lambda: int8_stage(*args, w_pack=pack),
                               iters=5)[0],
         "plain_ms": cuda_ms(lambda: int8_stage_plain(*args),
                             iters=PLAIN_ITERS, warmup=1),
         "bound": bound(nbytes(*args[2:], pack, got)
                        + sites_in * 32 * x.element_size(),
                        n * 2 * 9 * 32 * 32 * sites, INT8_OPS)}
    print(f"[{tag}] K5 {r['dtype']}, n = {n}, {tuple(x.shape)}, {sites} "
          f"active sites: bit-equal to plain; wrapper {r['ms']:.4f} ms, "
          f"kernels alone {r['alone_ms']:.4f} ms, plain {r['plain_ms']:.4f} "
          f"ms, bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")
    return r


def stage_routes(torch, bb, args, kw):
    """The stride-1 stage of 18a's build on one captured K5 f32 input, on
    each route as `PillarResNet.conv12` runs it: one K5 f32 call
    (`int8_stage`, its NHWC copy of the input included) against the
    per-conv route (the stage's blocks: one K4 f32 call per conv), outputs
    bit-equal, the launches of one pass counted, each timed by CUDA events
    (`cuda_ms`) STAGE_ROUNDS times in turns. Returns the record."""
    from pillarnet_lts_torch.models.backbones.base import nhwc
    from pillarnet_lts_torch.models.backbones.pillar_resnet import _nchw
    from pillarnet_lts_torch.ops import _kernels
    from pillarnet_lts_torch.ops.int8_stage import int8_stage

    # the stage's input as `conv12` holds it, and its two routes there
    x, mask = _nchw(args[0]), args[5][:, None]

    def per_conv():
        y = x
        for blk in bb._stage1_blocks():
            y = blk(y, mask)
        return y

    def fused():
        return int8_stage(nhwc(x), *args[1:], **kw)

    passes = {}
    with torch.inference_mode():
        for name, fn in (("fused", fused), ("per_conv", per_conv)):
            _kernels.reset_launches()
            out = fn()
            passes[name] = ({k: v for k, v in _kernels.LAUNCHES.items() if v},
                            out)
        n = args[1].shape[0]
        if x.is_cuda and (passes["fused"][0] != {"int8_stage_f32": 1}
                          or passes["per_conv"][0] != {"int8_conv_f32": n}):
            raise AssertionError(f"[23c] the stage's launches "
                                 f"{ {k: v[0] for k, v in passes.items()} }")
        if not torch.equal(passes["fused"][1],
                           passes["per_conv"][1].permute(0, 2, 3, 1)):
            raise AssertionError("[23c] the stride-1 stage differs between "
                                 "the routes")
        ms = {"fused": [], "per_conv": []}
        for _ in range(STAGE_ROUNDS):
            ms["fused"].append(cuda_ms(fused))
            ms["per_conv"].append(cuda_ms(per_conv))
    rec = {"shape": list(args[0].shape), "n": n,
           "launches": {k: v[0] for k, v in passes.items()},
           "ms": ms, **{f"median_ms_{k}": statistics.median(v)
                        for k, v in ms.items()}}
    print(f"[23c] the stride-1 stage {tuple(args[0].shape)}, n = "
          f"{rec['n']}, outputs bit-equal: fused "
          f"{rec['median_ms_fused']:.4f} ms ({rec['launches']['fused']}) vs "
          f"per-conv {rec['median_ms_per_conv']:.4f} ms "
          f"({rec['launches']['per_conv']}); medians of {STAGE_ROUNDS} "
          f"rounds in turns, CUDA events")
    return rec


def fused_f32_stage(torch, dev, card):
    """Phase 23c: `pillarrcnn18_waymo` + `enable_backbone_quant` (f32
    activations, 18a's build) calibrated on CALIB_CLOUDS clouds, served at
    bs=1 on the per-conv route and with `backbone.s2d_pallas` (K5's f32
    variant over the stride-1 stage), FUSED_F32_REQUESTS requests each
    (the first untimed) on the same clouds, the two routes in turns; the
    launch counts set to 0 just before each fused request and read just
    after; the two routes' detections bit-equal (the same int32 sums and
    f32 epilogue); every K5 f32 call of the fused route replayed bit-equal
    against its plain version; the stride-1 stage alone on both routes
    (`stage_routes`); K5 f32 timed at 18a's stage (the captured call) and,
    with the bf16 variant on the same input cast, at STAGE_SHAPE (n = 7,
    the bf16 row's shape). Returns (record, launches, K5 f32 record)."""
    from pillarnet_lts_torch.apis import (
        build_model_from_cfg, load_config, spread_head_outputs)
    from pillarnet_lts_torch.datasets import synth_points_realistic
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.models.backbones import pillar_resnet
    from pillarnet_lts_torch.ops import _kernels
    from pillarnet_lts_torch.ops.int8_stage import (int8_stage,
                                                    int8_stage_plain)
    from pillarnet_lts_torch.ops.quant import pack_kernel
    from pillarnet_lts_torch.runtime.quantize import (
        calibrate, enable_backbone_quant)

    cfg = load_config(RCNN)
    enable_backbone_quant(cfg["model"])
    n, pc_range = int(cfg["data"]["max_points"]), cfg["point_cloud_range"]
    model = build_model_from_cfg(cfg, device=dev, seed=0)
    if model.dtype != torch.float32:
        raise AssertionError(f"[23c] dtype {model.dtype}")
    spread_head_outputs(model, *on_card(torch, dev, synth_points_realistic(
        1, n, pc_range, seed=99, nsweeps=1)))
    calibrate(model, [on_card(torch, dev, synth_points_realistic(
        1, n, pc_range, seed=400 + s, nsweeps=1))
        for s in range(CALIB_CLOUDS)])
    bb = model.single_det.backbone_net
    infer = make_infer_fn(model)
    clouds = [on_card(torch, dev, synth_points_realistic(
        1, n, pc_range, seed=1000 + s, nsweeps=1))
        for s in range(FUSED_F32_REQUESTS)]

    def request(cloud, fused):
        bb.s2d_pallas = fused
        if (bb.fused_stage1_params() is not None) != fused:
            raise AssertionError(f"[23c] the fused stage is "
                                 f"{'off' if fused else 'on'}")
        t0 = time.perf_counter()
        det = {k: v.cpu() for k, v in infer(*cloud).items()}
        return det, (time.perf_counter() - t0) * 1e3

    # the routes in turns, each request on both, the order alternating; the
    # fused route's launches counted from 0 just before each of its
    # requests and read just after
    calls, lat = [], {False: [], True: []}
    launches = dict.fromkeys(_kernels.LAUNCHES, 0)
    with recording(pillar_resnet, "int8_stage", calls):
        for i, cloud in enumerate(clouds):
            dets = {}
            for fused in ((False, True) if i % 2 else (True, False)):
                if fused:
                    _kernels.reset_launches()
                dets[fused], ms = request(cloud, fused)
                if fused:
                    for k, v in _kernels.LAUNCHES.items():
                        launches[k] += v
                if i:
                    lat[fused].append(ms)
            for k in dets[False]:
                if not torch.equal(dets[False][k], dets[True][k]):
                    raise AssertionError(f"[23c] request {i}: {k} differs "
                                         f"between the fused and per-conv "
                                         f"routes")
    if launches["int8_stage_f32"] != len(clouds) or launches["int8_stage"]:
        raise AssertionError(f"[23c] launches {launches}")
    p50_fused = statistics.median(lat[True])
    p50_per_conv = statistics.median(lat[False])
    # every call bit-equal to its plain version; the first one timed
    stage18a = time_stage(torch, calls[0][0], calls[0][1]["w_pack"], "23c")
    for k, (args, kw) in enumerate(calls[1:], 1):
        got, want = int8_stage(*args, **kw), int8_stage_plain(*args)
        if not torch.equal(got, want):
            raise AssertionError(f"[23c] K5 f32 call {k} differs from its "
                                 f"plain version")
    routes = stage_routes(torch, bb, *calls[0])
    stage18a["calls"] = len(calls)
    bb.s2d_pallas = False
    del calls, infer, model, bb
    torch.cuda.empty_cache()
    args = stage_inputs(torch, dev, STAGE_SHAPE, 7, 23)
    pack = pack_kernel(args[1])
    at_shape = {"f32": time_stage(torch, args, pack, "23c"),
                "bf16": time_stage(torch, [args[0].bfloat16(), *args[1:5],
                                           args[5].bfloat16()], pack, "23c")}
    del args, pack
    torch.cuda.empty_cache()
    rec = {"config": os.path.relpath(RCNN, ROOT) + " + enable_backbone_quant",
           "requests": len(clouds), "p50_ms_fused": p50_fused,
           "p50_ms_per_conv": p50_per_conv,
           "ms_fused": lat[True], "ms_per_conv": lat[False],
           "launches": launches, "detections_bit_equal": True,
           "stage_routes": routes, "k5_f32_18a_stage": stage18a,
           "k5_at_stage_shape": at_shape}
    print(f"[23c] {rec['config']} (f32) with s2d_pallas: the fused route's "
          f"detections bit-equal to the per-conv route's on {len(clouds)} "
          f"requests, the routes in turns; p50 fused {p50_fused:.2f} ms "
          f"vs per-conv {p50_per_conv:.2f} ms (bs=1, {len(lat[True])} "
          f"timed each, the first untimed; host clock); K5 f32 "
          f"{stage18a['calls']} calls, each bit-equal to its plain version; "
          f"launches {launches}; card: {card}")
    return rec, launches, stage18a


def two_stage_remainder(torch, dev, card, twins):
    """Phase 23. `twins`: phase 13c's and 15d's records (the f32 twins of
    23a's runs). Returns (record, {sub-phase: launches}, K5 f32 record)."""
    from pillarnet_lts_torch.apis import RCNN_VARIANTS

    t0 = time.perf_counter()
    rec = {"23a": {
        "pillarnet34_nusc_bf16": bf16_train_run(
            torch, dev, card, FLAGSHIP.replace(".py", "_bf16.py"),
            twins["flagship"]),
        "pillarrcnn18_waymo_bf16": bf16_train_run(
            torch, dev, card, RCNN_BF16, twins["rcnn"]),
        "demo_card_vs_cpu": bf16_step_card_vs_cpu(torch, dev)}}
    rec["23b"] = {v: serve_variant(torch, dev, card, v)
                  for v in RCNN_VARIANTS}
    rec["23c"], fused_launches, k5 = fused_f32_stage(torch, dev, card)
    rec["seconds"] = time.perf_counter() - t0
    launches = {"23a_" + k: v["launches"] for k, v in rec["23a"].items()
                if "launches" in v}
    launches.update({"23b_" + k: v["launches"]
                     for k, v in rec["23b"].items()})
    launches["23c"] = fused_launches
    print(f"[23] phase 23 took {rec['seconds']:.1f} s")
    return rec, launches, k5


# phase 24: the model remainder (the int8 CenterHead on K4's per-channel
# variant, approx_topk, SepHead of any depth, the legacy RPN)
REMAINDER_REQUESTS, REMAINDER_WARMUP = 6, 2  # 24a-e: bs=1, untimed first
HEAD_CALIB_CLOUDS = 4  # 24a, 24b: calibration clouds
# 24e: CenterPoint's PointPillars neck widths (`layer_nums`,
# `ds_num_filters`, `us_num_filters`) on pillarnet34_nusc's conv5 (stride
# 16, 256 channels): integer strides 1 / 2 / 1 down and 2 / 4 / 4 up meet
# the head's stride 8 (180^2), 384 channels out
RPN_OVERRIDE = dict(type="RPN", layer_nums=[3, 5, 5],
                    ds_layer_strides=[1, 2, 1], ds_num_filters=[64, 128, 256],
                    us_layer_strides=[2, 4, 4],
                    us_num_filters=[128, 128, 128], in_channels=256)


def served_path(torch, dev, infer, clouds, path, tag):
    """Serve `clouds` (host (points, mask) pairs) one request at a time,
    host-synced, each request's launches exactly `path` ({kernel: count};
    None: not checked). Returns the host detections, the timed requests'
    ms (after REMAINDER_WARMUP) and the launches of the whole run."""
    from pillarnet_lts_torch.ops import _kernels
    from pillarnet_lts_torch.runtime.serving import to_host

    dets, ms = [], []
    _kernels.reset_launches()  # the counts of this run alone
    for i, cloud in enumerate(clouds):
        pts, msk = on_card(torch, dev, cloud)
        before = dict(_kernels.LAUNCHES)
        t0 = time.perf_counter()
        det = to_host(infer(pts, msk))
        dt = (time.perf_counter() - t0) * 1e3
        got = {k: v - before[k] for k, v in _kernels.LAUNCHES.items()
               if v != before[k]}
        if path is not None and got != path:
            raise AssertionError(f"{tag} request {i}: launches {got}, the "
                                 f"path is {path}")
        if not (np.isfinite(det["box3d_lidar"]).all()
                and np.isfinite(det["scores"]).all()):
            raise AssertionError(f"{tag} request {i}: non-finite detections")
        dets.append(det)
        if i >= REMAINDER_WARMUP:
            ms.append(dt)
    return dets, ms, {k: v for k, v in _kernels.LAUNCHES.items() if v}


def quant_convs(model):
    """{K4 variant: calibrated convs of `model`} by its compute dtype: the
    per-tensor MaskedConvs and the per-channel SepHead wide convs."""
    from pillarnet_lts_torch.models.backbones.base import MaskedConv
    from pillarnet_lts_torch.models.bbox_heads.center_head import SepHead

    sfx = "_f32" if str(model.dtype) == "torch.float32" else ""
    mods = list(model.modules())
    out = {"int8_conv" + sfx: sum(isinstance(m, MaskedConv)
                                  and m.quant_ready() for m in mods),
           "int8_conv_pc" + sfx: sum(isinstance(m, SepHead)
                                     and m.quant_ready() for m in mods)}
    return {k: v for k, v in out.items() if v}


def head_calls(torch, calls, tag):
    """A served request's captured K4 calls: every call held bit-equal to
    its plain version (`replay_int8_equal`); returns the head's calls, the
    shared conv's (per tensor: the call just before the first wide conv)
    and the wide convs' (per channel), and the largest |d|."""
    n, err = replay_int8_equal(torch, calls, tag)
    first = next(i for i, c in enumerate(calls) if c[0][2].dim() == 1)
    share = calls[first - 1:first]
    wide = [c for c in calls if c[0][2].dim() == 1]
    print(f"[{tag}] {n} K4 calls of one request, each equal to its plain "
          f"version (max |d| {err}): {n - len(wide)} per tensor, "
          f"{len(wide)} per input channel")
    return share, wide, err


def int8_head_nusc(torch, dev, card, tmp):
    """Phase 24a: `pillarnet34_nusc_int8` with `bbox_head.quant=True`
    (`enable_backbone_quant(head=True)`), seeded weights and spread heads,
    calibrated on HEAD_CALIB_CLOUDS clouds, fused stage off: the launch
    counts set to 0 just before REMAINDER_REQUESTS requests at bs 1 and
    read just after, every request launching K1, K2, K4 per tensor (the
    backbone, neck and shared conv) and K4's per-channel variant once per
    task; one request's K4 calls replayed bit-equal, the shared conv and
    the 6 wide convs timed (`check_int8_conv`); the head maps' error
    against the f32 model of the same weights beside the backbone-only
    int8 build's (a reading); at bs 8 as a `.pt2` program against eager
    (`export_cell`: a fresh process with torch and `ops.library` only,
    detections bit for bit, launches as eager, its K4 calls held
    bit-equal and timed)."""
    from pillarnet_lts_torch.apis import (build_model_from_cfg, load_config,
                                          spread_head_outputs)
    from pillarnet_lts_torch.datasets import synth_points_realistic
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.models.utils.quant import Calibrated
    from pillarnet_lts_torch.runtime.convert import (load_jax_variables,
                                                     variables_of)
    from pillarnet_lts_torch.runtime.quantize import (calibrate,
                                                      enable_backbone_quant)

    cfg = load_config(FLAGSHIP_INT8)
    enable_backbone_quant(cfg["model"], head=True)
    n, pc_range = int(cfg["data"]["max_points"]), cfg["point_cloud_range"]

    def cloud(seed):
        return synth_points_realistic(1, n, pc_range, seed=seed)

    model = build_model_from_cfg(cfg, device=dev, seed=0)
    spread_head_outputs(model, *on_card(torch, dev, cloud(99)))
    t0 = time.perf_counter()
    calibrate(model, [on_card(torch, dev, cloud(90 + i))
                      for i in range(HEAD_CALIB_CLOUDS)])
    torch.cuda.synchronize()
    rec = {"calibration_s": time.perf_counter() - t0}
    tasks = len(model.head_net.tasks)
    path = dict(quant_convs(model), pillar_scatter_max=1, rotated_overlap=1)
    if path.get("int8_conv_pc") != tasks:
        raise AssertionError(f"24a: the int8 path {path}")
    infer = make_infer_fn(model)
    clouds = [cloud(800 + i) for i in range(REMAINDER_REQUESTS)]
    dets, ms, launches = served_path(torch, dev, infer, clouds, path, "24a")
    kept = [int(d["mask"].sum()) for d in dets]
    calls = []
    with recording_int8_convs(calls):
        infer(*on_card(torch, dev, clouds[0]))
    torch.cuda.synchronize()
    share, wide, err = head_calls(torch, calls, "24a")
    del calls
    rec["share_conv"] = check_int8_conv(torch, share, phase="24a")
    rec["wide_conv"] = check_int8_conv(torch, wide, phase="24a")
    # the head maps against the f32 model of the same weights, and the
    # backbone-only int8 build's (the head's convs uncalibrated)
    f32_cfg = load_config(FLAGSHIP)
    f32 = load_jax_variables(build_model_from_cfg(f32_cfg, device=dev,
                                                  seed=1),
                             variables_of(model))
    pts = on_card(torch, dev, clouds[1])
    head = [m for m in model.head_net.modules()
            if isinstance(m, Calibrated) and m.quant]
    with torch.inference_mode():
        ref = f32(*pts)
        full = model(*pts)
        for m in head:
            m.calibrated = False
        backbone_only = model(*pts)
        for m in head:
            m.calibrated = True
    rec["hm_rel_err_vs_f32"] = {
        "int8_head": rel_errors(ref, full, ("hm",)),
        "backbone_only_int8": rel_errors(ref, backbone_only, ("hm",))}
    del f32, ref, full, backbone_only
    q = statistics.quantiles(ms, n=10)
    rec.update({"requests": len(clouds), "path_per_request": path,
                "launches": launches, "p50_ms": statistics.median(ms),
                "p90_ms": q[8], "kept": kept, "k4_max_abs_err": err})
    print(f"[24a] pillarnet34_nusc_int8 + bbox_head.quant (bf16) bs=1, "
          f"{len(ms)} timed requests: p50 {rec['p50_ms']:.2f} ms, p90 "
          f"{rec['p90_ms']:.2f} ms; per request {path}; kept {kept}; "
          f"heatmap |x - f32| / max|f32| per task (random weights, a "
          f"reading): int8 head "
          f"{[round(e, 4) for e in rec['hm_rel_err_vs_f32']['int8_head']]}"
          f", backbone-only int8 "
          f"{[round(e, 4) for e in rec['hm_rel_err_vs_f32']['backbone_only_int8']]}"
          f"; calibration {rec['calibration_s']:.2f} s; card: {card}")
    rec["export_bs8"] = export_cell(
        torch, dev, card, "24a", model,
        export_clouds(cfg, EXPORT_INT8_BATCH, 810), tmp)
    if rec["export_bs8"]["launches_per_request"].get("int8_conv_pc") \
            != tasks:
        raise AssertionError(f"24a program: launches "
                             f"{rec['export_bs8']['launches_per_request']}")
    del model, infer
    torch.cuda.empty_cache()
    return rec, launches


def int8_head_rcnn(torch, dev, card):
    """Phase 24b: 18a's build (`pillarrcnn18_waymo` after
    `enable_backbone_quant`, f32 compute) with the head quantized too:
    calibrated on HEAD_CALIB_CLOUDS clouds, REMAINDER_REQUESTS requests
    at bs 1 with the launch counts set to 0 just before and read just
    after (K1, K2 once per task, K4's f32 variant once per quantized conv,
    its per-channel f32 variant once per task), one request's K4 calls
    replayed bit-equal and the head's timed."""
    from pillarnet_lts_torch.apis import (build_model_from_cfg, load_config,
                                          spread_head_outputs)
    from pillarnet_lts_torch.datasets import synth_points_realistic
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.runtime.quantize import (calibrate,
                                                      enable_backbone_quant)

    cfg = load_config(RCNN)
    enable_backbone_quant(cfg["model"], head=True)
    n, pc_range = int(cfg["data"]["max_points"]), cfg["point_cloud_range"]

    def cloud(seed):
        return synth_points_realistic(1, n, pc_range, seed=seed, nsweeps=1)

    model = build_model_from_cfg(cfg, device=dev, seed=0)
    spread_head_outputs(model, *on_card(torch, dev, cloud(99)))
    calibrate(model, [on_card(torch, dev, cloud(400 + i))
                      for i in range(HEAD_CALIB_CLOUDS)])
    tasks = len(model.single_det.head_net.tasks)
    path = dict(quant_convs(model), pillar_scatter_max=1,
                rotated_overlap=tasks)
    if path.get("int8_conv_pc_f32") != tasks:
        raise AssertionError(f"24b: the int8 path {path}")
    infer = make_infer_fn(model)
    clouds = [cloud(820 + i) for i in range(REMAINDER_REQUESTS)]
    dets, ms, launches = served_path(torch, dev, infer, clouds, path, "24b")
    posts = cfg["test_cfg"]["nms"]["nms_post_max_size"]
    kept = [check_rcnn_detections(d, posts, f"24b request {i}")
            for i, d in enumerate(dets)]
    calls = []
    with recording_int8_convs(calls):
        infer(*on_card(torch, dev, clouds[0]))
    torch.cuda.synchronize()
    _, wide, err = head_calls(torch, calls, "24b")
    del calls
    rec = {"requests": len(clouds), "path_per_request": path,
           "launches": launches, "p50_ms": statistics.median(ms),
           "kept": kept, "k4_max_abs_err": err,
           "wide_conv": check_int8_conv(torch, wide, phase="24b")}
    print(f"[24b] pillarrcnn18_waymo + enable_backbone_quant(head=True) "
          f"(f32) bs=1, {len(ms)} timed requests: p50 {rec['p50_ms']:.2f} "
          f"ms; per request {path}; mean kept {statistics.mean(kept):.1f}; "
          f"card: {card}")
    del model, infer
    torch.cuda.empty_cache()
    return rec, launches


@contextlib.contextmanager
def recording_nms(calls):
    """Record (boxes, valid, thresh, sweeps) of every rotated NMS that
    predict runs inside the block (`center_head.py`'s `rotated_nms` and
    `rotated_nms_dynamic`)."""
    from pillarnet_lts_torch.models.bbox_heads import center_head

    def make(real):
        def record(boxes, scores, valid, thresh, post, sweeps=16, **kw):
            calls.append((boxes, valid, thresh, sweeps))
            return real(boxes, scores, valid, thresh, post, sweeps=sweeps,
                        **kw)
        return record

    with patched(center_head, "rotated_nms", make), \
            patched(center_head, "rotated_nms_dynamic", make):
        yield


def convergence_flags(torch, calls):
    """Each recorded NMS's `greedy_suppress_with_convergence` flags (one a
    row: one more sweep from its keep set changes nothing), on the default
    route's IoU (K2)."""
    from pillarnet_lts_torch.ops.iou3d import rotated_iou_bev, to_pcdet_bev
    from pillarnet_lts_torch.ops.nms import greedy_suppress_with_convergence

    flags = []
    for boxes, valid, thresh, sweeps in calls:
        bev = to_pcdet_bev(boxes)
        th = thresh[:, None, None] if torch.is_tensor(thresh) else thresh
        _, conv = greedy_suppress_with_convergence(
            rotated_iou_bev(bev, bev), valid, th, sweeps)
        flags.append([bool(c) for c in conv.reshape(-1).tolist()])
    return flags


def approx_topk_cells(torch, dev, card):
    """Phase 24c: `pillarnet34_waymo` (per-class grouped NMS) and
    `pillarnet34_nusc` (grouped rotated NMS), f32, seeded weights and
    spread heads, each serving 2 clouds with `test_cfg.nms.approx_topk`
    on and off, with and without `use_mask_kernel`: the detections with
    it on bit-equal to those with it off (the port's approx_topk is the
    exact top-k); each NMS's `greedy_suppress_with_convergence` flags
    printed. The launch counts are set to 0 just before each served run
    with approx_topk on and read just after."""
    from pillarnet_lts_torch.apis import (build_model_from_cfg, load_config,
                                          spread_head_outputs)
    from pillarnet_lts_torch.datasets import synth_points_realistic
    from pillarnet_lts_torch.eval_utils import make_infer_fn

    rec, launches = {}, {}
    for name, path in (("pillarnet34_waymo", WAYMO),
                       ("pillarnet34_nusc", FLAGSHIP)):
        cfg = load_config(path)
        n, pc_range = int(cfg["data"]["max_points"]), cfg["point_cloud_range"]
        nsweeps = cfg.get("nsweeps", 1)
        clouds = [synth_points_realistic(1, n, pc_range, seed=830 + i,
                                         nsweeps=nsweeps) for i in range(2)]
        model = build_model_from_cfg(cfg, device=dev, seed=0)
        spread_head_outputs(model, *on_card(torch, dev, clouds[0]))
        for mask_kernel in (False, True):
            tag = f"{name}{'_mask_kernel' if mask_kernel else ''}"
            test_cfg = model.processed_test_cfg()
            test_cfg["nms"] = dict(test_cfg["nms"],
                                   use_mask_kernel=mask_kernel)
            exact = [to_host_det(torch, make_infer_fn(model, test_cfg), dev,
                                 c) for c in clouds]
            test_cfg["nms"] = dict(test_cfg["nms"], approx_topk=True)
            nms = []
            with recording_nms(nms):
                got, _, launches[tag] = served_path(
                    torch, dev, make_infer_fn(model, test_cfg), clouds, None,
                    f"24c {tag}")
            for i, (a, b) in enumerate(zip(got, exact)):
                for k in b:
                    if not np.array_equal(a[k], b[k]):
                        raise AssertionError(f"24c {tag} cloud {i}: {k} "
                                             f"with approx_topk differs")
            kernel = "suppression_mask" if mask_kernel else "rotated_overlap"
            if launches[tag].get(kernel, 0) < len(clouds):
                raise AssertionError(f"24c {tag}: launches {launches[tag]}")
            flags = convergence_flags(torch, nms)
            kept = [int(d["mask"].sum()) for d in got]
            rec[tag] = {"launches": launches[tag], "kept": kept,
                        "converged": flags, "nms_calls": len(nms)}
            print(f"[24c] {tag} with approx_topk: detections on {len(clouds)}"
                  f" clouds bit-equal to approx_topk off (kept {kept}); "
                  f"launches {launches[tag]}; greedy_suppress_with_"
                  f"convergence per NMS (rows): {flags}; card: {card}")
            if not all(all(f) for f in flags):
                print(f"[24c] {tag}: an NMS needs more than its sweeps "
                      f"(test_cfg.nms.nms_sweeps)")
        del model
        torch.cuda.empty_cache()
    return rec, launches


def to_host_det(torch, infer, dev, cloud):
    from pillarnet_lts_torch.runtime.serving import to_host

    return to_host(infer(*on_card(torch, dev, cloud)))


def with_depth(depth):
    """A config edit: every common head of the CenterHead at `depth`
    convs (the heatmap branch keeps two, as the JAX package builds it)."""
    def edit(cfg):
        head = cfg["model"]["bbox_head"]
        head["common_heads"] = {k: (c, depth) for k, (c, _) in
                                head["common_heads"].items()}
    return edit


def sephead_depths(torch, dev, card):
    """Phase 24d: `pillarnet34_nusc` (f32, full width) with every common
    head at 1 and at 3 convs: seeded weights and spread heads serving
    REMAINDER_REQUESTS requests (the launch counts set to 0 just before,
    read just after: K1 and K2 once each), then one bs-2 training step
    (finite losses, a gradient on every new conv, K1 launched); the demo
    config at the same depth one step on the card against the CPU as
    phase 13b holds it."""
    from pillarnet_lts_torch.apis import (build_model_from_cfg, load_config,
                                          optimizer_from_cfg,
                                          spread_head_outputs)
    from pillarnet_lts_torch.datasets import (SynthDataset, collate_batch,
                                              synth_points_realistic)
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.ops import _kernels
    from pillarnet_lts_torch.runtime.train_step import (batch_to_device,
                                                        train_step)

    rec, launches = {}, {}
    for depth in (1, 3):
        tag = f"depth{depth}"
        cfg = load_config(FLAGSHIP)
        with_depth(depth)(cfg)
        n, pc_range = int(cfg["data"]["max_points"]), cfg["point_cloud_range"]
        model = build_model_from_cfg(cfg, device=dev, seed=0)
        clouds = [synth_points_realistic(1, n, pc_range, seed=840 + i)
                  for i in range(REMAINDER_REQUESTS)]
        spread_head_outputs(model, *on_card(torch, dev, clouds[0]))
        dets, ms, launches[tag] = served_path(
            torch, dev, make_infer_fn(model), clouds,
            {"pillar_scatter_max": 1, "rotated_overlap": 1}, f"24d {tag}")
        kept = [int(d["mask"].sum()) for d in dets]
        ds = SynthDataset(cfg, 2, n, seed=200, num_boxes=(10, 21))
        batch = batch_to_device(collate_batch([ds[0], ds[1]], n), dev)
        opt = optimizer_from_cfg(model, cfg, 10)
        before = _kernels.LAUNCHES["pillar_scatter_max"]
        t0 = time.perf_counter()
        m = train_step(model, opt, batch, cfg["train_cfg"])
        metrics = {k: float(v) for k, v in m.items()}
        step_s = time.perf_counter() - t0
        if not all(math.isfinite(v) for v in metrics.values()) \
                or _kernels.LAUNCHES["pillar_scatter_max"] == before:
            raise AssertionError(f"24d {tag}: step {metrics}")
        # the new convs' kernels (an L1 loss's bias gradient is a sum of
        # signs that can cancel exactly)
        new = {name: p for name, p in model.named_parameters()
               if name.startswith("head_net.task") and name.endswith(".weight")
               and (f"_conv{depth - 2}." in name if depth > 2
                    else ("_out." in name and "hm_out" not in name))}
        none = [name for name, p in new.items()
                if p.grad is None or not bool(p.grad.any())]
        if not new or none:
            raise AssertionError(f"24d {tag}: no gradient on {none}")
        model.eval()
        vs_cpu = train_card_vs_cpu(torch, dev, edit=with_depth(depth),
                                   tag=f"24d {tag}")
        rec[tag] = {"launches": launches[tag], "kept": kept,
                    "p50_ms": statistics.median(ms), "step": metrics,
                    "step_s": step_s, "new_leaves": len(new),
                    "demo_card_vs_cpu": vs_cpu}
        print(f"[24d] pillarnet34_nusc, common heads at {depth} conv"
              f"{'s' if depth > 1 else ''}: p50 {rec[tag]['p50_ms']:.2f} ms "
              f"over {len(ms)} timed requests, kept {kept}, launches "
              f"{launches[tag]}; one bs-2 step in {step_s:.2f} s, loss "
              f"{metrics['loss']:.4f}, grad_norm {metrics['grad_norm']:.4f},"
              f" a gradient on each of the {len(new)} new kernels; card: "
              f"{card}")
        del model, opt, batch
        torch.cuda.empty_cache()
    return rec, launches


def legacy_rpn(torch, dev, card):
    """Phase 24e: the legacy `RPN` (RPN_OVERRIDE) on `pillarnet34_nusc`'s
    backbone, f32, seeded weights and spread heads, REMAINDER_REQUESTS
    requests (K1, K2 once each); then the int8 build of the same weights
    (`enable_backbone_quant`: reader, backbone and the RPN's units on K4's
    f32 variant), calibrated on 2 clouds, REMAINDER_REQUESTS requests
    with the launch counts set to 0 just before and read just after, one
    request's K4 calls replayed bit-equal, its head maps' error against
    the f32 build (a reading)."""
    from pillarnet_lts_torch.apis import (build_model_from_cfg, load_config,
                                          spread_head_outputs)
    from pillarnet_lts_torch.datasets import synth_points_realistic
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.models.necks.rpn import RPN, _ConvBNReLU
    from pillarnet_lts_torch.runtime.convert import (load_jax_variables,
                                                     variables_of)
    from pillarnet_lts_torch.runtime.quantize import (calibrate,
                                                      enable_backbone_quant)

    def config():
        cfg = load_config(FLAGSHIP)
        cfg["model"]["neck"] = dict(RPN_OVERRIDE)
        cfg["model"]["bbox_head"]["in_channels"] = [
            sum(RPN_OVERRIDE["us_num_filters"])]
        return cfg

    cfg = config()
    n, pc_range = int(cfg["data"]["max_points"]), cfg["point_cloud_range"]
    clouds = [synth_points_realistic(1, n, pc_range, seed=850 + i)
              for i in range(REMAINDER_REQUESTS)]
    f32 = build_model_from_cfg(cfg, device=dev, seed=0)
    if not isinstance(f32.neck_net, RPN):
        raise AssertionError("24e: the neck is not the legacy RPN")
    spread_head_outputs(f32, *on_card(torch, dev, clouds[0]))
    rec, launches = {}, {}
    dets, ms, launches["f32"] = served_path(
        torch, dev, make_infer_fn(f32), clouds,
        {"pillar_scatter_max": 1, "rotated_overlap": 1}, "24e f32")
    rec["f32"] = {"p50_ms": statistics.median(ms),
                  "kept": [int(d["mask"].sum()) for d in dets],
                  "launches": launches["f32"]}
    icfg = config()
    enable_backbone_quant(icfg["model"])
    int8 = load_jax_variables(build_model_from_cfg(icfg, device=dev, seed=1),
                              variables_of(f32))
    calibrate(int8, [on_card(torch, dev, synth_points_realistic(
        1, n, pc_range, seed=860 + i)) for i in range(2)])
    path = dict(quant_convs(int8), pillar_scatter_max=1, rotated_overlap=1)
    dets, ms, launches["int8"] = served_path(
        torch, dev, make_infer_fn(int8), clouds, path, "24e int8")
    calls = []
    with recording_int8_convs(calls):
        make_infer_fn(int8)(*on_card(torch, dev, clouds[1]))
    torch.cuda.synchronize()
    units = sum(m.Conv_0.quant_ready() for m in int8.neck_net.modules()
                if isinstance(m, _ConvBNReLU))
    if units != sum(RPN_OVERRIDE["layer_nums"]):
        raise AssertionError(f"24e: {units} of the RPN's units are int8")
    k4, err = replay_int8_equal(torch, calls, "24e")
    del calls
    pts = on_card(torch, dev, clouds[2])
    with torch.inference_mode():
        errs = rel_errors(f32(*pts), int8(*pts), ("hm",))
    rec["int8"] = {"p50_ms": statistics.median(ms),
                   "kept": [int(d["mask"].sum()) for d in dets],
                   "launches": launches["int8"], "path_per_request": path,
                   "k4_calls": k4, "k4_max_abs_err": err,
                   "hm_rel_err_vs_f32": errs}
    print(f"[24e] pillarnet34_nusc with the legacy RPN {RPN_OVERRIDE}: f32 "
          f"p50 {rec['f32']['p50_ms']:.2f} ms (kept {rec['f32']['kept']}); "
          f"int8 (f32 activations) p50 {rec['int8']['p50_ms']:.2f} ms, per "
          f"request {path}, {k4} K4 calls of one request ({units} the RPN's "
          f"units) each equal to its plain version; heatmap |int8 - "
          f"f32| / max|f32| per task (a reading) "
          f"{[round(e, 4) for e in errs]}; card: {card}")
    del f32, int8
    torch.cuda.empty_cache()
    return rec, launches


def model_remainder(torch, dev, card):
    """Phase 24. Returns its record, each path's launches, and the K4
    per-channel records of 24a (bf16) and 24b (f32)."""
    import tempfile

    t0 = time.perf_counter()
    rec, launches = {}, {}
    with tempfile.TemporaryDirectory(prefix="pillarnet_24a_") as tmp:
        rec["24a"], launches["24a"] = int8_head_nusc(torch, dev, card, tmp)
    rec["24b"], launches["24b"] = int8_head_rcnn(torch, dev, card)
    rec["24c"], launches["24c"] = approx_topk_cells(torch, dev, card)
    rec["24d"], launches["24d"] = sephead_depths(torch, dev, card)
    rec["24e"], launches["24e"] = legacy_rpn(torch, dev, card)
    rec["seconds"] = time.perf_counter() - t0
    print(f"[24] phase 24 took {rec['seconds']:.1f} s")
    return rec, launches


K4_COMPARE_ROUNDS = 5  # --k4-compare: rounds of (parent, this, this, parent)


SP_WORLD = 2  # 25a-c: gloo ranks that share card 0
SP_REQUESTS = 3  # 25a/b: requests each rank serves (the first is cold)
SP_TIMEOUT = 600  # s: a spawned run that has not ended by then is killed
SP_BATCH = 2  # 25c: frames of the training step
# 25a, 25d: the served detections against one process's, phase 14e's
SP_BOX_TOL, SP_SCORE_TOL = 1e-3, 1e-4
SP_LOSS_RTOL = 1e-5  # 25c: every loss, relative, as phase 19 holds them
SP_GRAD_RTOL = 1e-3  # 25c: a module group's gradients, relative (phase 19)
SP_STAT_TOL = 1e-4  # 25c: BN running statistics, rtol = atol (phase 19)
SP_NUDGES = 1  # 25c: one-process steps from nudged weights (the spread)


def sp_job(name, kind, config, **kw):
    """A phase-25 job that a spatial rank (`spatial_rank`) and one process
    (`sp_run`) both run: `kind` "serve" (the clouds saved at `clouds`,
    each a request of `make_infer_fn`; the first cloud's head outputs and,
    with `conv12`, its gathered conv1 and conv2 maps; with `calibrate`,
    the int8 scales the ranks take on the clouds before they load the
    weights) or "train" (one `train_step` on the batch pickled at
    `batch`), on the weights saved at `weights` (`sp_weights`), the
    config at `config` with the model keys `edit` and, with `int8`,
    `enable_backbone_quant`."""
    job = dict(name=name, kind=kind, config=config, edit={}, int8=False,
               weights=None, clouds=None, batch=None, calibrate=False,
               conv12=False, seed=3, capture=False)
    job.update(kw)
    return job


def sp_config(job, axis=None):
    """The config of a job, with `spatial_axis` = axis (None: unsharded)
    on the detector or a two-stage model's first stage."""
    from pillarnet_lts_torch.apis import load_config
    from pillarnet_lts_torch.runtime.quantize import enable_backbone_quant

    cfg = load_config(job["config"])
    model = cfg["model"]
    for k, v in job["edit"].items():
        model[k] = dict(model[k], **v) if isinstance(v, dict) else v
    if job["int8"]:
        enable_backbone_quant(model)
    if axis:
        if "first_stage_cfg" in model:
            model["first_stage_cfg"] = dict(model["first_stage_cfg"],
                                            spatial_axis=axis)
        else:
            model["spatial_axis"] = axis
    return cfg


def sp_clouds(cfg, n, points, seed):
    """n single-cloud requests of `points` points in the config's range."""
    from pillarnet_lts_torch.datasets import synth_points_realistic

    return [synth_points_realistic(1, points, cfg["point_cloud_range"],
                                   seed=seed + i) for i in range(n)]


def sp_weights(torch, job, dev, clouds, path):
    """The job's weights: the config's model from `job["seed"]`, its heads
    spread on the first cloud, an int8 model calibrated on the clouds
    unsharded; saved to `path`. Returns the model."""
    from pillarnet_lts_torch.apis import (build_model_from_cfg,
                                          spread_head_outputs)
    from pillarnet_lts_torch.runtime.quantize import calibrate

    cfg = sp_config(job)
    model = build_model_from_cfg(cfg, device=dev, seed=job["seed"])
    spread_head_outputs(model, *on_card(torch, dev, clouds[0]))
    if job["int8"]:
        calibrate(model, [on_card(torch, dev, c) for c in clouds])
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, path)
    return model


def sp_model(torch, job, dev, axis=None):
    """The job's model on `dev` with its saved weights (an int8 model
    takes the saved scales as calibrated)."""
    from pillarnet_lts_torch.apis import build_model_from_cfg
    from pillarnet_lts_torch.runtime.quantize import observers

    cfg = sp_config(job, axis)
    model = build_model_from_cfg(cfg, device=dev, seed=job["seed"])
    model.load_state_dict(torch.load(job["weights"], map_location=dev,
                                     weights_only=True))
    for m in observers(model) if job["int8"] else ():
        m.set_absmax(m.absmax().clone())
    return cfg, model


@contextlib.contextmanager
def counting_collectives(counts):
    """Every `torch.distributed.all_reduce` inside the block adds one to
    counts["all_reduce"]."""
    import torch.distributed as tdist

    def make(real):
        def count(*args, **kwargs):
            counts["all_reduce"] += 1
            return real(*args, **kwargs)
        return count

    with patched(tdist, "all_reduce", make):
        yield counts


@contextlib.contextmanager
def capturing(torch, calls, on):
    """K1's, K2's and K4's calls inside the block appended to calls["k1"],
    ["k2"], ["k4"] (when `on`)."""
    from pillarnet_lts_torch.models.readers import dynamic_pillar_encoder
    from pillarnet_lts_torch.ops import iou3d

    if not on:
        yield
        return
    with recording(dynamic_pillar_encoder, "pillar_scatter_max",
                   calls["k1"]), \
            recording(iou3d, "convex_intersection_area", calls["k2"],
                      keep=lambda a, k: a), \
            recording_int8_convs(calls["k4"]):
        yield


def sp_serve(torch, job, model, dev, counts, calls):
    """A serve job on `model`: each cloud one request, host-synced (wall
    ms, all_reduce calls a request, launches a request), the first
    cloud's head outputs and (`conv12`) its conv1 and conv2 maps."""
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.ops import _kernels
    from pillarnet_lts_torch.runtime.serving import to_host

    clouds = torch.load(job["clouds"], weights_only=False)
    infer = make_infer_fn(model)
    rec = {"detections": [], "ms": [], "collectives": [], "launches": []}
    for i, cloud in enumerate(clouds):
        pts, msk = on_card(torch, dev, cloud)
        before = dict(_kernels.LAUNCHES)
        counts["all_reduce"] = 0
        t0 = time.perf_counter()
        with capturing(torch, calls, job["capture"] and i > 0):
            det = to_host(infer(pts, msk))
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        rec["collectives"].append(counts["all_reduce"])
        rec["launches"].append({k: v - before[k] for k, v in
                                _kernels.LAUNCHES.items() if v > before[k]})
        rec["detections"].append(det)
    first = getattr(model, "single_det", model)
    first.spatial_conv1 = job["conv12"]
    with torch.inference_mode():
        pts, msk = on_card(torch, dev, clouds[0])
        rec["preds"] = on_cpu(torch, model(pts, msk))
        if job["conv12"]:
            _, feats = first.extract_feat(pts, msk)
            rec["conv"] = {k: feats[k][0].cpu() for k in ("conv1", "conv2")}
    return rec


def sp_train(torch, job, cfg, model, dev, counts, calls):
    """A train job on `model`: one `train_step` on the job's batch; its
    metrics, gradients (after the step's sums), state after the step,
    the parameters whose gradients were summed over the ranks and the
    norms whose statistics were."""
    from pillarnet_lts_torch.apis import optimizer_from_cfg
    from pillarnet_lts_torch.models.utils.norm import MaskedBatchNorm
    from pillarnet_lts_torch.ops import _kernels
    from pillarnet_lts_torch.runtime import train_step as ts

    with open(job["batch"], "rb") as f:
        batch = ts.batch_to_device(pickle.load(f), dev)
    opt = optimizer_from_cfg(model, cfg, 1)
    summed = []

    def record(real):
        def sums(params):
            params = list(params)
            summed.extend(id(p) for p in params)
            return real(params)
        return sums

    before = dict(_kernels.LAUNCHES)
    counts["all_reduce"] = 0
    t0 = time.perf_counter()
    with patched(ts, "sum_gradients_over_ranks", record), \
            capturing(torch, calls, job["capture"]):
        metrics = ts.train_step(model, opt, batch, cfg["train_cfg"],
                                ts.step_generator(job["seed"], 0, dev))
        metrics = {k: float(v) for k, v in metrics.items()}
    names = {id(p): n for n, p in model.named_parameters()}
    return {"metrics": metrics, "grads": grads_of(torch, model),
            "state": state_of(torch, model),
            "ms": (time.perf_counter() - t0) * 1e3,
            "collectives": counts["all_reduce"],
            "launches": {k: v - before[k] for k, v in
                         _kernels.LAUNCHES.items() if v > before[k]},
            "summed": sorted(names[i] for i in summed),
            "bn_summed": sorted(
                n for n, m in model.named_modules()
                if isinstance(m, MaskedBatchNorm) and m.sums_over_ranks())}


def sp_run(torch, job, dev, axis=None, calls=None):
    """Run one job on `dev`: the model spatially sharded over the group
    (`axis`) or in one process (None). An int8 job records its scales:
    with `calibrate` a sharded job first calibrates on the clouds under
    the group and records the scales it took, then serves on the saved
    ones."""
    from pillarnet_lts_torch.runtime.quantize import calibrate, observers

    counts = {"all_reduce": 0}
    calls = calls if calls is not None else {"k1": [], "k2": [], "k4": []}
    out = {}
    with counting_collectives(counts):
        cfg, model = sp_model(torch, job, dev, axis)
        if job["int8"] and job["calibrate"] and axis:
            clouds = torch.load(job["clouds"], weights_only=False)
            calibrate(model, [on_card(torch, dev, c) for c in clouds])
            out["absmax"] = [m.absmax().cpu() for m in observers(model)]
            cfg, model = sp_model(torch, job, dev, axis)
        elif job["int8"]:
            out["absmax"] = [m.absmax().cpu() for m in observers(model)]
        if job["kind"] == "serve":
            out.update(sp_serve(torch, job, model, dev, counts, calls))
        else:
            model.train()
            out.update(sp_train(torch, job, cfg, model, dev, counts, calls))
    return out


def absmax_rel(torch, got, want):
    """The largest relative difference between two lists of scales."""
    return max(((g - w).abs() / w.abs().clamp_min(1e-30)).max().item()
               for g, w in zip(got, want))


def sp_ops(torch, world):
    """The collectives and the band execution alone, on the rank's band of
    seeded maps, gathered: `sharded_conv3x3` and `sharded_subm_conv3x3` on
    `tests/test_spatial_sharding.py`'s shapes and seeds (NHWC out), and
    on an uneven last band (62 rows) the SubM conv with its input's
    gradient through the halo's backward, a 2-row halo exchange, and a
    stride-2 `SparseDownStage` (`band_exec.down_stage_band`) in eval and
    in training (its output, BN statistics and input gradient)."""
    import torch.nn.functional as F

    from pillarnet_lts_torch.models.backbones.band_exec import (
        down_stage_band)
    from pillarnet_lts_torch.models.backbones.base import SparseDownStage
    from pillarnet_lts_torch.models.utils import init_weights
    from pillarnet_lts_torch.models.utils.norm import MaskedBatchNorm
    from pillarnet_lts_torch.parallel import dist
    from pillarnet_lts_torch.parallel.spatial import (
        coarse_bands, gather_rows, halo_exchange_h, row_bands,
        sharded_conv3x3, sharded_subm_conv3x3)

    r, out = dist.rank(), {}

    def band(x, bands):
        return x[:, :, bands[r][0]:bands[r][1]]

    rng = np.random.RandomState(0)
    x = rng.randn(2, 64, 32, 8).astype(np.float32)
    k = (rng.randn(3, 3, 8, 16) * 0.1).astype(np.float32)
    bands = row_bands(64, world)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    w = torch.from_numpy(k).permute(3, 2, 0, 1)
    y = gather_rows(sharded_conv3x3(band(xt, bands).contiguous(), w, bands),
                    bands)
    out["conv"] = y.permute(0, 2, 3, 1).numpy()
    rng = np.random.RandomState(1)
    mask = rng.rand(1, 64, 32) > 0.6
    x = (rng.randn(1, 64, 32, 4) * mask[..., None]).astype(np.float32)
    k = (rng.randn(3, 3, 4, 4) * 0.1).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    mt = torch.from_numpy(mask)
    y = sharded_subm_conv3x3(band(xt, bands).contiguous(),
                             mt[:, bands[r][0]:bands[r][1]],
                             torch.from_numpy(k).permute(3, 2, 0, 1), bands)
    out["subm"] = gather_rows(y, bands).permute(0, 2, 3, 1).numpy()

    # an uneven last band: 62 rows
    g = torch.Generator().manual_seed(7)
    H = 62
    bands = row_bands(H, world)
    occ = torch.rand(2, H, 20, generator=g) > 0.7
    x = torch.randn(2, 8, H, 20, generator=g) * occ[:, None]
    w = torch.randn(8, 8, 3, 3, generator=g) * 0.1
    R = torch.randn(2, 8, H, 20, generator=g)
    xb = band(x, bands).clone().requires_grad_(True)
    y = gather_rows(sharded_subm_conv3x3(
        xb, occ[:, bands[r][0]:bands[r][1]], w, bands), bands)
    (y * R).sum().backward()
    halo2 = halo_exchange_h(band(x, bands).contiguous(), bands, rows=2)
    out["uneven"] = {"y": y.detach(), "grad": gather_rows(xb.grad, bands),
                     "halo2": gather_rows(halo2[:, :, 2:-2], bands),
                     "halo2_rows": halo2}
    coarse = coarse_bands(bands, H)
    for mode in ("eval", "train"):
        stage = init_weights(SparseDownStage(8, 16, 1), 11)
        stage.train(mode == "train")
        for m in stage.modules():
            if isinstance(m, MaskedBatchNorm):
                m.over_ranks = True
        xb = band(x, bands).clone().requires_grad_(True)
        y, m2 = down_stage_band(stage, xb, occ, bands, coarse)
        y = gather_rows(y, coarse)
        (y * F.avg_pool2d(R, 2, ceil_mode=True).repeat(1, 2, 1, 1)
         ).sum().backward()
        out[f"down_{mode}"] = {
            "y": y.detach(), "occ": m2, "grad": gather_rows(xb.grad, bands),
            "stats": {k: v.clone() for k, v in stage.state_dict().items()
                      if "running" in k}}
    return out


def spatial_rank(spec_path):
    """A rank of a spatially sharded run (`python3 chip_smoke.py
    --spatial-rank SPEC`, spawned by `spawn_ranks` or torchrun): the group
    started by `parallel.dist.init_from_env` (the spec's device and
    backend), then each job of the spec (`sp_job`) on the sharded model
    (`sp_run`), the launch counts set to 0 just before each job and read
    just after, and with `ops` the collectives alone (`sp_ops`); on the
    card every K1, K2 and K4 call of the captured requests held to its
    plain version. Saved to `{out}/rank{r}.pt`."""
    import datetime

    import torch

    sys.path.insert(0, ROOT)
    from pillarnet_lts_torch.ops import _kernels
    from pillarnet_lts_torch.parallel import dist

    with open(spec_path) as f:
        spec = json.load(f)
    if spec["threads"]:
        torch.set_num_threads(spec["threads"])
    dev = dist.init_from_env(spec["device"], backend=spec["backend"],
                             timeout=datetime.timedelta(
                                 seconds=DP_INIT_TIMEOUT))
    r, cuda = dist.rank(), dev.type == "cuda"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = {"rank": r, "world": dist.process_count(), "device": str(dev),
           "backend": spec["backend"], "jobs": {}}
    calls = {"k1": [], "k2": [], "k4": []}
    if spec.get("ops"):
        rec["ops"] = sp_ops(torch, dist.process_count())
    for job in spec["jobs"]:
        _kernels.reset_launches()
        rec["jobs"][job["name"]] = sp_run(torch, job, dev, "sp", calls)
        rec["jobs"][job["name"]]["job_launches"] = dict(_kernels.LAUNCHES)
        print(f"[25 rank {r}] {job['name']}: "
              + (f"request ms {[round(v, 2) for v in rec['jobs'][job['name']]['ms']]}"
                 if job["kind"] == "serve" else
                 f"step ms {rec['jobs'][job['name']]['ms']:.2f}"), flush=True)
    if cuda:
        rec["replays"] = replay_equal(torch, calls["k1"], calls["k2"],
                                      f"25 rank {r}")
        rec["replays"]["k4"] = dict(zip(("calls", "max_abs_err"),
                                        replay_int8_equal(
                                            torch, calls["k4"],
                                            f"25 rank {r}")))
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "pillarnet_lts_tpu")]
    if bad:
        raise AssertionError(f"a rank imported {bad[:4]}")
    torch.save(rec, os.path.join(spec["out"], f"rank{r}.pt"))
    dist.shutdown()
    return 0


def run_spatial(spec, tag, world=SP_WORLD, timeout=SP_TIMEOUT,
                torchrun=False):
    """The ranks of `spec` (`spatial_rank`): `world` processes spawned with
    torchrun's environment (`spawn_ranks`; on the card they share card 0),
    or under `torchrun` itself (`torchrun`: a rank a card). Returns their
    records in rank order and the wall seconds."""
    import torch

    os.makedirs(spec["out"], exist_ok=True)
    path = os.path.join(spec["out"], "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    argv = [os.path.join(ROOT, "chip_smoke.py"), "--spatial-rank", path]
    if torchrun:
        seconds = run_torchrun(tag, world, argv)
    else:
        env = ({"OMP_NUM_THREADS": str(spec["threads"])} if spec["threads"]
               else None)
        seconds = run_ranks(tag, [sys.executable] + argv, world, env,
                            timeout)
    return [torch.load(os.path.join(spec["out"], f"rank{r}.pt"),
                       weights_only=False) for r in range(world)], seconds


def sp_spec(device, backend, out, jobs, threads=None, ops=False):
    return dict(device=device, backend=backend, out=out, jobs=jobs,
                threads=threads, ops=ops)


def compare_sp_detections(tag, got, want, box_tol=SP_BOX_TOL,
                          score_tol=SP_SCORE_TOL, exact=False):
    """A rank's served detections against one process's, request by
    request: the kept slots and labels equal, boxes within `box_tol` m and
    scores within `score_tol` (`exact`: every array bit-equal). Returns
    the largest box and score differences."""
    worst = [0.0, 0.0]
    for i, (g, w) in enumerate(zip(got, want)):
        if exact:
            for k in w:
                if not np.array_equal(g[k], w[k]):
                    raise AssertionError(f"{tag} request {i}: {k} differs")
            continue
        m = w["mask"].astype(bool)
        if not (np.array_equal(g["mask"], w["mask"])
                and np.array_equal(g["label_preds"][m], w["label_preds"][m])):
            raise AssertionError(f"{tag} request {i}: kept slots or labels "
                                 f"differ")
        db = float(np.abs(g["box3d_lidar"][m] - w["box3d_lidar"][m]).max(
            initial=0.0))
        ds = float(np.abs(g["scores"][m] - w["scores"][m]).max(initial=0.0))
        worst = [max(worst[0], db), max(worst[1], ds)]
        if db > box_tol or ds > score_tol:
            raise AssertionError(f"{tag} request {i}: boxes {db:.3g} m, "
                                 f"scores {ds:.3g} from one process's")
    return worst


def sp_spread(torch, job, dev, want, nudges, path):
    """The one process's own spread of a training job: per module group
    the largest gradient difference (`grad_diffs`) of the step from the
    saved weights times 1 + 1e-6 N(0, 1) (`nudges` draws, written to
    `path`) against the step from the weights themselves (`want`), as
    phase 19 measures it."""
    state = torch.load(job["weights"], weights_only=True)
    g = torch.Generator().manual_seed(16)
    spread = {}
    for _ in range(nudges):
        torch.save({n: v * (1 + 1e-6 * torch.randn(v.shape, generator=g))
                    if v.is_floating_point() and "running" not in n else v
                    for n, v in state.items()}, path)
        got = sp_run(torch, dict(job, weights=path, capture=False), dev)
        for k, d in grad_diffs(torch, got["grads"], want["grads"])[0].items():
            spread[k] = max(spread.get(k, 0.0), d)
    return spread


def check_sp_training(torch, tag, got, want, spread):
    """A training job of the ranks against one process's: the ranks'
    states and metrics bit-identical to one another; every loss within
    SP_LOSS_RTOL; the gradients by module group within min(max(2 x the
    one process's own spread (`sp_spread`), SP_GRAD_RTOL), DP_GRAD_CAP),
    phase 19's bound; the running statistics within SP_STAT_TOL; the
    summed gradients exactly those of `partial_prefixes`, the summing
    norms exactly the sharded stages'. Returns the differences."""
    r0 = got[0]
    for rk in got[1:]:
        if rk["metrics"] != r0["metrics"]:
            raise AssertionError(f"{tag}: the ranks' metrics differ")
        for k, v in r0["state"].items():
            if not torch.equal(rk["state"][k], v):
                raise AssertionError(f"{tag}: the ranks' {k} differs")
    rel = {k: rel_diff(r0["metrics"][k], v) for k, v in want["metrics"].items()
           if k.endswith("loss") or "_loss_" in k}
    bad = {k: v for k, v in rel.items() if v > SP_LOSS_RTOL}
    if bad:
        raise AssertionError(f"{tag}: losses beyond {SP_LOSS_RTOL}: {bad}")
    groups, leaf = grad_diffs(torch, r0["grads"], want["grads"])
    bounds = {k: min(max(2 * spread[k], SP_GRAD_RTOL), DP_GRAD_CAP)
              for k in groups}
    bad = {k: v for k, v in groups.items() if v > bounds[k]}
    if bad:
        raise AssertionError(f"{tag}: gradient groups beyond their bounds "
                             f"{bounds}: {bad}")
    stats = 0.0
    for k, w in want["state"].items():
        if "running" in k:
            g = r0["state"][k]
            stats = max(stats, (g - w).abs().max().item())
            if not torch.allclose(g, w, rtol=SP_STAT_TOL, atol=SP_STAT_TOL):
                raise AssertionError(f"{tag}: running statistic {k} beyond "
                                     f"{SP_STAT_TOL}")
    summed, prefixes = r0["summed"], partial_prefixes(want["grads"])
    want_summed = sorted(n for n in want["grads"] if n.startswith(prefixes))
    if summed != want_summed:
        raise AssertionError(f"{tag}: the ranks summed the gradients of "
                             f"{set(summed) ^ set(want_summed)} otherwise")
    bn_prefixes = prefixes[1:]
    if not r0["bn_summed"] or not all(
            n.startswith(bn_prefixes) for n in r0["bn_summed"]):
        raise AssertionError(f"{tag}: norms summed over the ranks: "
                             f"{r0['bn_summed']}")
    return {"loss": [r0["metrics"]["loss"], want["metrics"]["loss"]],
            "loss_rel": rel, "grad_rel_by_group": groups,
            "grad_bound_by_group": bounds, "grad_spread_by_group": spread,
            "grad_worst_leaf": {"name": leaf[1], "rel": leaf[2]},
            "running_stats_max_abs": stats,
            "summed_params": len(summed), "summed_norms": len(r0["bn_summed"])}


def partial_prefixes(names):
    """The parameter-name prefixes of the reader, the stride-1 stage and
    conv2 of a model's (first stage's) detector, given its names."""
    det = "single_det." if any(n.startswith("single_det.") for n in names) \
        else ""
    return (f"{det}reader_net.", f"{det}backbone_net.conv1_block",
            f"{det}backbone_net.conv2.")


def box_ops_card_vs_cpu(torch, dev):
    """Phase 25e: `ops.roiaware_pool3d` (max, avg; 24 and 40 RoIs),
    `points_in_boxes_index`, `points_in_boxes_batch` and
    `points_in_rbbox_device` on CUDA tensors against the CPU: the integer
    outputs equal, the pooled features within 1e-5 (the card's sin and
    cos may round otherwise), the gradients of the pooled features by
    value."""
    from pillarnet_lts_torch import ops

    rng = np.random.RandomState(25)
    out = {}
    for n in (24, 40):
        pts = rng.uniform(-20, 20, (20000, 3)).astype(np.float32)
        rois = np.zeros((n, 7), np.float32)
        rois[:, :3] = rng.uniform(-15, 15, (n, 3))
        rois[:, 3:6] = rng.uniform(2, 8, (n, 3))
        rois[:, 6] = rng.uniform(-np.pi, np.pi, n)
        feats = rng.randn(20000, 16).astype(np.float32)
        res = {}
        for where in ("cpu", dev):
            p, b, f = (torch.from_numpy(a).to(where)
                       for a in (pts, rois, feats))
            f.requires_grad_(True)
            pooled = {pool: ops.roiaware_pool3d(b, p, f, (6, 6, 4), pool=pool)
                      for pool in ("max", "avg")}
            (pooled["max"].sum() + pooled["avg"].sum()).backward()
            res[str(where)] = {
                "index": ops.points_in_boxes_index(p, b).cpu(),
                "batch": ops.points_in_boxes_batch(p[None], b[None]).cpu(),
                "rbbox": ops.points_in_rbbox_device(p, b).cpu(),
                **{k: v.detach().cpu() for k, v in pooled.items()},
                "grad": f.grad.cpu()}
        cpu, card = res["cpu"], res[str(dev)]
        for k in ("index", "batch", "rbbox"):
            if not torch.equal(cpu[k], card[k]):
                raise AssertionError(f"[25e] {k} ({n} boxes): card != CPU")
        errs = {k: (cpu[k] - card[k]).abs().max().item()
                for k in ("max", "avg", "grad")}
        if max(errs.values()) > 1e-5:
            raise AssertionError(f"[25e] pooled ({n} RoIs): {errs}")
        out[f"rois{n}"] = dict(errs, inside=int((cpu["index"] >= 0).sum()))
    print(f"[25e] box ops on the card equal to the CPU: {out}")
    return out


def sp_flagship_jobs(torch, dev, tmp, config, int8_config, points):
    """Phase 25a-c's jobs (`sp_job`) with their inputs written under `tmp`
    (SP_REQUESTS clouds, the f32 and the calibrated int8 weights, a bs-2
    batch), one process's runs of them on `dev` (`sp_run`) and its own
    training spread under SP_NUDGES weight nudges (`sp_spread`)."""
    from pillarnet_lts_torch.apis import load_config
    from pillarnet_lts_torch.datasets import SynthDataset, collate_batch

    cfg = load_config(config)
    clouds = sp_clouds(cfg, SP_REQUESTS, points, 250)
    cloud_path = os.path.join(tmp, "clouds.pt")
    torch.save(clouds, cloud_path)
    jobs = [sp_job("25a", "serve", config, clouds=cloud_path,
                   weights=os.path.join(tmp, "f32.pt"), capture=True),
            sp_job("25b", "serve", int8_config, clouds=cloud_path,
                   weights=os.path.join(tmp, "int8.pt"), int8=True,
                   calibrate=True, conv12=True, capture=True),
            sp_job("25c", "train", config,
                   weights=os.path.join(tmp, "f32.pt"),
                   batch=os.path.join(tmp, "batch.pkl"), capture=True)]
    sp_weights(torch, jobs[0], dev, clouds, jobs[0]["weights"])
    sp_weights(torch, jobs[1], dev, clouds, jobs[1]["weights"])
    ds = SynthDataset(cfg, SP_BATCH, points, seed=260, num_boxes=(10, 21))
    with open(jobs[2]["batch"], "wb") as f:
        pickle.dump(collate_batch([ds[i] for i in range(SP_BATCH)], points),
                    f)
    one = {job["name"]: sp_run(torch, job, dev) for job in jobs}
    spread = sp_spread(torch, jobs[2], dev, one["25c"], SP_NUDGES,
                       os.path.join(tmp, "nudged.pt"))
    return jobs, one, spread


def check_sp_ranks(torch, ranks, one, spread, group, card):
    """Phase 25a-c's checks of the ranks' records against one process's:
    (a) detections within phase 14e's tolerances, (b) the gathered conv2
    map and the detections bit-equal and the ranks' calibrated scales
    beside one process's, (c) `check_sp_training`. `group` names the
    ranks in the prints. Returns the record (with the ranks' replays)."""
    out = {}
    for tag in ("25a", "25b"):
        got = [rk["jobs"][tag] for rk in ranks]
        exact = tag == "25b"
        worst = [compare_sp_detections(f"[{tag}] rank {rk['rank']}",
                                       g["detections"],
                                       one[tag]["detections"], exact=exact)
                 for rk, g in zip(ranks, got)]
        res = {"requests": len(got[0]["detections"]),
               "per_rank": [g["launches"] for g in got],
               "box_max_abs": max(w[0] for w in worst),
               "score_max_abs": max(w[1] for w in worst),
               "request_ms_per_rank": [g["ms"] for g in got],
               "one_process_ms": one[tag]["ms"],
               "collectives_per_request": got[0]["collectives"],
               "launches_per_request": got[0]["launches"],
               "one_process_launches": one[tag]["launches"]}
        if exact:
            for rk, g in zip(ranks, got):
                if not torch.equal(g["conv"]["conv2"],
                                   one[tag]["conv"]["conv2"]):
                    raise AssertionError(f"[{tag}] rank {rk['rank']}: the "
                                         "gathered conv2 map differs")
            res["absmax_rel_to_one_process"] = absmax_rel(
                torch, got[0]["absmax"], one[tag]["absmax"])
        out[tag] = res
        print(f"[{tag}] {group}: request wall ms per rank "
              f"{[[round(v, 2) for v in g['ms']] for g in got]} (one "
              f"process {[round(v, 2) for v in one[tag]['ms']]}); "
              f"all_reduce calls a request {got[0]['collectives']}; "
              f"launches a request {got[0]['launches'][-1]}; detections "
              + ("bit-equal to" if exact else
                 f"within {res['box_max_abs']:.3g} m / "
                 f"{res['score_max_abs']:.3g} of")
              + f" one process's; card: {card}")
    got = [rk["jobs"]["25c"] for rk in ranks]
    out["25c"] = check_sp_training(torch, "[25c]", got, one["25c"], spread)
    out["25c"].update(per_rank=[g["launches"] for g in got],
                      step_ms_per_rank=[g["ms"] for g in got],
                      one_process_ms=one["25c"]["ms"],
                      collectives=got[0]["collectives"],
                      launches=got[0]["launches"])
    print(f"[25c] one bs-{SP_BATCH} step, {group}: {out['25c']}; "
          f"card: {card}")
    out["replays"] = [rk.get("replays") for rk in ranks]
    return out


def spatial_sharding(torch, dev, card, config=FLAGSHIP, int8_config=None,
                     points=N_POINTS):
    """Phase 25: spatial (BEV-grid) sharding (`parallel/spatial.py`,
    `models/backbones/band_exec.py`) on the card: 2 gloo ranks that share
    card 0 (NCCL refuses two ranks on one card), each holding the whole
    model and the same points, against one process on the same card
    (`check_sp_ranks`): (a) f32 `pillarnet34_nusc` at full width,
    SP_REQUESTS requests at bs 1; (b) `pillarnet34_nusc_int8` (bf16, K4 on
    every conv1 / conv2 band), calibrated by the ranks under the group,
    then served on one process's scales; (c) one bs-2 training step of
    `pillarnet34_nusc` (remat); (d) a group of one under NCCL (`torchrun
    --nproc_per_node 1`) serving (a)'s requests, bit-equal to one
    process, and with two or more cards (a)-(c) with one NCCL rank a card;
    (e) the box ops card vs CPU. Every K1, K2 and K4 call of the ranks'
    timed requests and step is held to its plain version. Prints the
    request wall ms, the collectives a request and the phase's seconds.
    (`config`, `int8_config`, `points`: another config and cloud size,
    which a CPU rehearsal takes.)"""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    out = {"card": card}
    cuda = dev.type == "cuda"
    tmp = tempfile.mkdtemp(prefix="phase25_", dir=os.environ.get("TMPDIR"))
    try:
        jobs, one, spread = sp_flagship_jobs(
            torch, dev, tmp, config,
            int8_config or config.replace(".py", "_int8.py"), points)
        if cuda:
            torch.cuda.empty_cache()
        ranks, seconds = run_spatial(
            sp_spec(dev.type, "gloo", os.path.join(tmp, "gloo"), jobs),
            "25a-c")
        out.update(check_sp_ranks(torch, ranks, one, spread,
                                  "2 gloo ranks on one card", card),
                   ranks_seconds=seconds)
        # (d) a group of one under NCCL
        nccl_job = dict(jobs[0], capture=False)
        one_rank, s1 = run_spatial(
            sp_spec(dev.type, "nccl" if cuda else "gloo",
                    os.path.join(tmp, "nccl1"), [nccl_job]),
            "25d", world=1, torchrun=True)
        compare_sp_detections("[25d] NCCL group of one",
                              one_rank[0]["jobs"]["25a"]["detections"],
                              one["25a"]["detections"], exact=True)
        out["25d"] = {"seconds": s1, "collectives_per_request":
                      one_rank[0]["jobs"]["25a"]["collectives"],
                      "backend": one_rank[0]["backend"]}
        cards = torch.cuda.device_count() if cuda else 0
        if cards >= 2:
            out["25d"]["cards"] = spatial_on_cards(torch, tmp, jobs, one,
                                                   spread, cards, card)
        print(f"[25d] {out['25d']}")
        out["25e"] = box_ops_card_vs_cpu(torch, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"[25] phase 25 took {out['seconds']:.1f} s; card: {card}")
    return out


def spatial_on_cards(torch, tmp, jobs, one, spread, cards, card):
    """Phase 25a-c with one NCCL rank a card over `cards` cards (torchrun)
    against one process on card 0 (`check_sp_ranks`)."""
    torch.cuda.empty_cache()
    ranks, seconds = run_spatial(
        sp_spec("cuda", "nccl", os.path.join(tmp, "cards"), jobs), "25d",
        world=cards, torchrun=True)
    return dict(check_sp_ranks(torch, ranks, one, spread,
                               f"{cards} NCCL ranks, one a card", card),
                world=cards, seconds=seconds)


def spatial_cards():
    """`python3 chip_smoke.py --spatial-cards`: phase 25a-c alone with one
    NCCL rank a card over every card of the machine, against one process
    on card 0 (the kernels built first, TF32 off); one JSON line. Needs
    two or more cards."""
    import shutil
    import tempfile

    import torch

    sys.path.insert(0, ROOT)
    from pillarnet_lts_torch.ops import _kernels

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 2:
        print(f"--spatial-cards: {cards} cards", file=sys.stderr)
        return 2
    _kernels.build_all()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    tmp = tempfile.mkdtemp(prefix="cards_", dir=os.environ.get("TMPDIR"))
    try:
        jobs, one, spread = sp_flagship_jobs(
            torch, torch.device("cuda", 0), tmp, FLAGSHIP,
            FLAGSHIP.replace(".py", "_int8.py"), N_POINTS)
        out = spatial_on_cards(torch, tmp, jobs, one, spread, cards, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"spatial_cards": out}, default=str))
    print(card)
    return 0


def k4_launcher(torch, fn, args, kw):
    """A callable that launches the C entry `fn` of `int8_conv.cu` (either
    checkout's build) on one captured K4 call's arguments into one output
    tensor, and returns it."""
    from pillarnet_lts_torch.ops import _kernels
    from pillarnet_lts_torch.ops.quant import pack_kernel

    x, w_q, inv_s, dq, shift, stride = args
    mask, res = kw.get("mask"), kw.get("residual")
    w_pack = kw.get("w_pack")
    if w_pack is None:
        w_pack = pack_kernel(w_q)
    B, H, W, cin = x.shape
    cout = w_pack.shape[1]
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    y = torch.empty((B, Ho, Wo, cout), dtype=x.dtype, device=x.device)
    ptrs = (x.data_ptr(), w_pack.data_ptr(), inv_s.data_ptr(),
            dq.data_ptr(), shift.data_ptr(),
            None if mask is None else mask.data_ptr(),
            None if res is None else res.data_ptr(), y.data_ptr())
    dims = (B, H, W, cin, Ho, Wo, cout, stride, int(kw.get("act", True)),
            _kernels.stream_handle(x.device))

    def run():
        _kernels.raise_on_error("int8_conv", fn(*ptrs, *dims))
        return y
    return run


def k4_compare(parent):
    """`python3 chip_smoke.py --k4-compare PARENT`: K4 per tensor (bf16)
    built from the checkout at PARENT (its `pillarnet_lts_torch/csrc/
    int8_conv.cu`, the same flags) and from this one, on the captured K4
    calls of one int8 flagship request (phase 6's model, fused stage off)
    at bs 1 and at bs 8: every output of the two byte-identical, and each
    side's calls of a request timed by CUDA events, in turns parent,
    this, this, parent over K4_COMPARE_ROUNDS rounds. Prints one JSON
    line."""
    import ctypes

    import torch

    sys.path.insert(0, ROOT)
    from pillarnet_lts_torch.apis import load_config
    from pillarnet_lts_torch.ops import _kernels

    _kernels.build_all()
    torch.backends.cudnn.allow_tf32 = False
    dev, card = torch.device("cuda", 0), card_line()
    lib = os.path.join(_kernels.BUILD_DIR, "int8_conv_parent.so")
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, *_kernels._NO_FMA,
                    "-o", lib, os.path.join(os.path.abspath(parent),
                                            "pillarnet_lts_torch", "csrc",
                                            "int8_conv.cu")], check=True)
    sides = {"parent": ctypes.CDLL(lib).int8_conv_bf16,
             "this": _kernels.kernel("int8_conv")}
    sides["parent"].argtypes = _kernels.KERNELS["int8_conv"][3]
    sides["parent"].restype = ctypes.c_int
    model, cloud, _ = int8_flagship(torch, dev, tag="k4")
    rec = {"card": card}
    for bs in (1, 8):
        batch = cloud(50) if bs == 1 else export_clouds(
            load_config(FLAGSHIP_INT8), bs, 600)[0]
        calls = capture_int8_convs(torch, model, on_card(torch, dev, batch))
        runs = {k: [k4_launcher(torch, fn, a, kw) for a, kw, _ in calls]
                for k, fn in sides.items()}
        for i, (a, b) in enumerate(zip(runs["parent"], runs["this"])):
            ya, yb = a().clone(), b()
            torch.cuda.synchronize()
            if not (torch.equal(ya.view(torch.int16), yb.view(torch.int16))
                    and torch.equal(yb, calls[i][2])):
                raise AssertionError(f"k4 bs {bs}: call {i} differs")
        times = {k: [] for k in sides}
        for _ in range(K4_COMPARE_ROUNDS):
            for k in ("parent", "this", "this", "parent"):
                times[k].append(cuda_ms(lambda: [r() for r in runs[k]],
                                        iters=10, warmup=1))
        rec[f"bs{bs}"] = {"calls": len(calls), "ms_a_request": times}
        print(f"[k4] bs {bs}: {len(calls)} calls byte-identical; ms a "
              f"request (CUDA events; parent, this, this, parent x "
              f"{K4_COMPARE_ROUNDS}): " + ", ".join(
                  f"{k} median {statistics.median(v):.4f} (range "
                  f"{min(v):.4f}-{max(v):.4f})" for k, v in times.items())
              + f"; card: {card}", flush=True)
        del calls, runs
        torch.cuda.empty_cache()
    print(json.dumps({"k4_compare": rec}))
    return 0


def load_cfg_points(path):
    from pillarnet_lts_torch.apis import load_config

    return load_config(path)["data"]["max_points"]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from pillarnet_lts_torch.apis import load_config
    from pillarnet_lts_torch.ops import _kernels
    from pillarnet_lts_torch.ops.iou3d import box_corners_bev

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[0] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _kernels.build_all()
    print(f"[1] built {sorted(_kernels.KERNELS)} in "
          f"{time.perf_counter() - t0:.2f} s")
    from pillarnet_lts_torch import native

    t0 = time.perf_counter()
    if not native.available():  # the data pipeline's host C++ (phase 22)
        raise AssertionError(f"[1] the host library did not build:\n"
                             f"{native.build_error()}")
    print(f"[1] built the host library "
          f"{os.path.basename(native.library_path())} in "
          f"{time.perf_counter() - t0:.2f} s")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config(FLAGSHIP)
    scatter = check_scatter(torch, dev, cfg["point_cloud_range"],
                            cfg["pillar_size"])
    corners = box_corners_bev(nms_like_boxes(torch, 1).to(dev)).contiguous()
    overlaps = {"nms_like": check_overlap(torch, "NMS-like", corners,
                                          corners)}
    del corners
    check_golden(torch, dev)
    overlaps["served_nuscenes"] = check_overlap(
        torch, "the served f32 nuScenes request's candidates",
        *serve_flagship(torch, dev, card))
    model, cloud, post = int8_flagship(torch, dev)
    calls = capture_int8_convs(torch, model, on_card(torch, dev, cloud(50)))
    conv = check_int8_conv(torch, calls)
    stage = check_int8_stage(torch, model, calls)
    del calls
    launches = serve_int8_flagship(torch, dev, card, model, cloud, post)
    masks = check_mask(torch, dev)
    tiled = check_scatter_tiled(torch, dev)
    switched, k2_waymo, k3_waymo = serve_waymo(torch, dev, card)
    overlaps["served_waymo"] = check_overlap(
        torch, "the served Waymo request's candidates", *k2_waymo)
    masks["served_waymo"], _ = check_suppression_mask(
        torch, "the served Waymo request's candidates (phase 12)", *k3_waymo)
    overlap, mask = overlaps["served_nuscenes"], masks["served_waymo"]
    check_pillar_ids(torch, dev, cfg["point_cloud_range"], cfg["pillar_size"])
    training = {"k1_gradient": check_scatter_grad(
        torch, dev, cfg["point_cloud_range"], cfg["pillar_size"])}
    training["card_vs_cpu"] = train_card_vs_cpu(torch, dev)
    training["flagship"] = train_flagship(torch, dev, card)
    two_stage, k1_rcnn, k2_rcnn = serve_rcnn(torch, dev, card)
    scatter["modes"]["rcnn_waymo"] = k1_rcnn
    scatter["max_abs_err"] = max(scatter["max_abs_err"],
                                 k1_rcnn["max_abs_err"])
    for task, (a, b) in enumerate(k2_rcnn):
        overlaps[f"served_rcnn_task{task}"] = check_overlap(
            torch, f"the served two-stage request's task {task} candidates",
            a, b)
    two_stage_training, k1_train, k2_train = train_two_stage(torch, dev,
                                                             card)
    scatter["modes"]["rcnn_train"] = k1_train
    scatter["max_abs_err"] = max(scatter["max_abs_err"],
                                 k1_train["max_abs_err"])
    evaluation, eval_launches, eval_replays = evaluate(torch, dev, card)
    as_written, aug_launches, aug_replays = train_as_written(torch, dev,
                                                             card)
    precision, prec_launches, prec_replays, conv_f32 = precisions(
        torch, dev, card)
    data_par, dp_launches, dp_replays = data_parallel(torch, dev, card)
    compact, compact_launches, compact_replays = compact_path(torch, dev,
                                                              card)
    exported = serving_export(torch, dev, card)
    prep, prep_launches, prep_replays = data_prep_chain(torch, dev, card)
    remainder, rem_launches, k5_f32 = two_stage_remainder(
        torch, dev, card, {"flagship": training["flagship"],
                           "rcnn": two_stage_training["waymo"]})
    model_rem, model_launches = model_remainder(torch, dev, card)
    spatial = spatial_sharding(torch, dev, card)

    # launches: K1, K2, K4, K5 from the int8 flagship's run with the fused
    # stage on (phase 8), K1' and K3 from the Waymo run with the switches
    # on (phase 12); times, errors and bounds: phases 2-3, 6-7, 9-10. K1's
    # and K1''s rows carry the mode of their launches' path (int8 codes,
    # the Waymo shape) and every mode's times under "modes"; K2's and K3's
    # rows the served candidates' replay (f32 nuScenes, Waymo phase 12) and
    # every replay under "replays"
    def row(name, source, replaces, count, res, ms, plain_ms, b, lib=None):
        return {"name": name, "route": "cuda",
                "source": f"pillarnet_lts_torch/csrc/{source}",
                "replaces": f"pillarnet_lts_tpu/ops/pallas/{replaces}",
                "launches": count, "max_abs_err": res["max_abs_err"],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
                "bound_by": b[1], "library_ms": lib}

    def scatter_row(name, source, replaces, count, res, main):
        m = res["modes"][main]
        return dict(row(name, source, replaces, count, res, m["ms"],
                        m["plain_ms"], (m["bound_ms"], m["bound_by"]),
                        m["library_ms"]), main_mode=main, modes=res["modes"])

    record = {"kernels": [
        scatter_row("pillar_scatter_max", "pillar_scatter_max.cu",
                    "voxelize_kernel.py:411", launches["pillar_scatter_max"],
                    scatter, "int8"),
        scatter_row("pillar_scatter_max_tiled", "pillar_scatter_max_tiled.cu",
                    "voxelize_kernel.py:78",
                    switched["pillar_scatter_max_tiled"], tiled, "waymo"),
        dict(row("rotated_overlap", "rotated_overlap.cu", "iou_kernel.py:105",
                 launches["rotated_overlap"], overlap, overlap["ms"],
                 overlap["plain_ms"], overlap["bound"]),
             alone_ms=overlap["alone_ms"], near_share=overlap["near_share"],
             bound_all_pairs_ms=overlap["bound_all_pairs"][0],
             replays=overlaps),
        dict(row("suppression_mask", "suppression_mask.cu",
                 "nms_kernel.py:221", switched["suppression_mask"], mask,
                 mask["ms"], mask["plain_ms"], mask["bound"]),
             alone_ms=mask["alone_ms"], near_share=mask["near_share"],
             bound_all_pairs_ms=mask["bound_all_pairs"][0], replays=masks),
        dict(row("int8_conv", "int8_conv.cu", "s2d_conv_kernel.py:137",
                 launches["int8_conv"], conv, conv["ms"], conv["plain_ms"],
                 conv["bound"]), alone_ms=conv["alone_ms"],
             main_shape=conv["main_shape"], shapes=conv["shapes"],
             frame=conv["frame"]),
        dict(row("int8_stage", "int8_stage.cu", "s2d_conv_kernel.py:385",
                 launches["int8_stage"], stage, stage["ms"],
                 stage["plain_ms"], stage["bound"]),
             alone_ms=stage["alone_ms"], per_conv_ms=stage["per_conv_ms"],
             per_conv_alone_ms=stage["per_conv_alone_ms"]),
        # K4's f32 variant: launches of phase 18a's path (counts reset just
        # before), its calls replayed there (phase 6's record)
        dict(row("int8_conv_f32", "int8_conv.cu", "s2d_conv_kernel.py:137",
                 prec_launches["rcnn_int8"]["int8_conv_f32"], conv_f32,
                 conv_f32["ms"], conv_f32["plain_ms"], conv_f32["bound"]),
             alone_ms=conv_f32["alone_ms"], main_shape=conv_f32["main_shape"],
             shapes=conv_f32["shapes"], frame=conv_f32["frame"]),
        # K5's f32 variant: launches of phase 23c's fused route (counts
        # reset just before), its calls replayed and the first timed there
        dict(row("int8_stage_f32", "int8_stage.cu", "s2d_conv_kernel.py:385",
                 rem_launches["23c"]["int8_stage_f32"], k5_f32,
                 k5_f32["ms"], k5_f32["plain_ms"], k5_f32["bound"]),
             alone_ms=k5_f32["alone_ms"], shape=k5_f32["shape"],
             calls=k5_f32["calls"],
             at_stage_shape=remainder["23c"]["k5_at_stage_shape"]),
    ]}
    # K4's per-channel variants: launches of phase 24a's (bf16) and 24b's
    # (f32) int8-head paths (counts reset just before each, read just
    # after), the wide convs of one request replayed and timed there
    for name, tag in (("int8_conv_pc", "24a"), ("int8_conv_pc_f32", "24b")):
        pc = model_rem[tag]["wide_conv"]
        record["kernels"].append(dict(
            row(name, "int8_conv.cu", "s2d_conv_kernel.py:137",
                model_launches[tag].get(name, 0), pc, pc["ms"],
                pc["plain_ms"],
                pc["bound"]), alone_ms=pc["alone_ms"],
            main_shape=pc["main_shape"], shapes=pc["shapes"],
            frame=pc["frame"]))
    # phase 24's paths: each one's launches (counts set to 0 just before
    # each served run, read just after); K4's row the 24a shared conv's
    # replay (per tensor, bf16)
    flat = {}
    for tag, v in model_launches.items():
        if tag in ("24a", "24b"):
            flat[tag] = v
        else:
            flat.update({f"{tag}_{sub}": n for sub, n in v.items()})
    for k in record["kernels"]:
        k["model_remainder_launches"] = {t: n.get(k["name"], 0)
                                         for t, n in flat.items()}
    share = model_rem["24a"]["share_conv"]
    record["kernels"][4]["model_remainder_share_conv"] = {
        f: share[f] for f in ("max_abs_err", "ms", "alone_ms", "plain_ms",
                              "bound", "main_shape")}
    pc_program = model_rem["24a"]["export_bs8"]
    record["kernels"][-2]["export_bs8"] = {
        "launches_per_request":
            pc_program["launches_per_request"]["int8_conv_pc"],
        "replays": pc_program["replays"].get("k4")}
    # the two-stage path's launches (phase 14, counts reset just before)
    record["kernels"][0]["two_stage_launches"] = \
        two_stage["launches"]["pillar_scatter_max"]
    record["kernels"][2]["two_stage_launches"] = \
        two_stage["launches"]["rotated_overlap"]
    # the two-stage training path (phase 15d, counts reset just before;
    # 15f, the same with RoIs near the GT): launches in all, K2's in
    # predict and in the sampler, and step 15e's calls replayed (15b)
    waymo = two_stage_training["waymo"]
    near_gt = two_stage_training["waymo_near_gt"]
    record["kernels"][0]["two_stage_train"] = dict(
        launches=waymo["launches"]["pillar_scatter_max"],
        launches_near_gt=near_gt["launches"]["pillar_scatter_max"],
        **k1_train)
    record["kernels"][2]["two_stage_train"] = {
        "launches": waymo["launches"]["rotated_overlap"],
        "predict_launches": sum(s["k2_predict"] for s in waymo["per_step"]),
        "sampler_launches": sum(s["k2_sampler"] for s in waymo["per_step"]),
        "launches_near_gt": near_gt["launches"]["rotated_overlap"],
        "replays": {k: {f: r[f] for f in (
            "shape", "ms", "alone_ms", "plain_ms", "bound", "near_share",
            "max_abs_err")} for k, r in k2_train.items()}}
    # the nuScenes eval pass through dist_test (phase 16a, counts reset
    # just before), and every eval pass's K1, K2 and K4 calls replayed
    # (16a's pipelined pass, 16b's Waymo evaluator, 16c, 16e)
    record["kernels"][0]["eval_launches"] = \
        eval_launches["pillar_scatter_max"]
    record["kernels"][2]["eval_launches"] = eval_launches["rotated_overlap"]
    for i, key in ((0, "k1"), (2, "k2")):
        record["kernels"][i]["eval_replays"] = eval_replays[key]
        record["kernels"][i]["max_abs_err"] = max(
            [record["kernels"][i]["max_abs_err"]]
            + [r["max_abs_err"] for r in eval_replays[key].values()])
    # training as the configs write it (phase 17a, counts reset just
    # before), and its last step's K1 and K2 calls replayed
    for i, key in ((0, "k1"), (2, "k2")):
        name = ("pillar_scatter_max", "rotated_overlap")[i // 2]
        record["kernels"][i]["augmented_train"] = {
            "launches": aug_launches[name], "replays": aug_replays[key]}
        record["kernels"][i]["max_abs_err"] = max(
            record["kernels"][i]["max_abs_err"],
            aug_replays[key]["max_abs_err"])
    # phase 18's paths (counts reset just before each), and 18a/b's K1 and
    # K2 calls replayed
    for i, name in ((0, "pillar_scatter_max"), (2, "rotated_overlap")):
        k = record["kernels"][i]
        k["precision_launches"] = {p: v[name]
                                   for p, v in prec_launches.items()}
        k["precision_replays"] = {t: r["k1" if i == 0 else "k2"]
                                  for t, r in prec_replays.items()}
        k["max_abs_err"] = max([k["max_abs_err"]] + [
            r["k1" if i == 0 else "k2"]["max_abs_err"]
            for r in prec_replays.values()])
    # phase 19: 19a/b's launches per rank (counts set to 0 in each rank
    # just before its run) and each rank's last-step calls replayed and
    # timed; 19c/d's calls held bit-equal (untimed)
    for i, key in ((0, "k1"), (2, "k2")):
        name = ("pillar_scatter_max", "rotated_overlap")[i // 2]
        k = record["kernels"][i]
        k["data_parallel"] = {tag: {
            "launches_per_rank": [n[name] for n in dp_launches[tag]],
            "replays_per_rank": [r[key] for r in dp_replays[tag] if key in r]}
            for tag in dp_launches}
        k["data_parallel"]["19c"] = {
            run: data_par["19c"][run]["replays"][key]
            for run in ("torchrun", "plain")}
        k["data_parallel"]["19d"] = {
            "one_process": data_par["19d"]["one_process_replays"][key],
            "ranks": [rk["replays"][key] for rk in data_par["19d"]["ranks"]]}
        k["max_abs_err"] = max(
            [k["max_abs_err"]]
            + [r["max_abs_err"] for tag in dp_replays
               for r in k["data_parallel"][tag]["replays_per_rank"]]
            + [r["max_abs_err"] for r in k["data_parallel"]["19c"].values()]
            + [k["data_parallel"]["19d"]["one_process"]["max_abs_err"]]
            + [r["max_abs_err"] for r in k["data_parallel"]["19d"]["ranks"]])
    # phase 20: the compact paths (counts reset just before each served
    # run) launch K2 and never K1; K2's calls there replayed bit-equal
    record["kernels"][0]["compact_launches"] = {
        t: compact[t]["launches"]["pillar_scatter_max"]
        for t in compact_launches}
    record["kernels"][2]["compact"] = {"launches": compact_launches,
                                       "replays": compact_replays}
    record["kernels"][2]["max_abs_err"] = max(
        [record["kernels"][2]["max_abs_err"]]
        + [r["max_abs_err"] for r in compact_replays.values()])
    conv16 = eval_replays["k4"]
    record["kernels"][4]["eval_replays"] = {"16e_int8": {
        "calls": sum(r["launches"] for r in conv16["shapes"]),
        "max_abs_err": conv16["max_abs_err"], "request": conv16["frame"],
        "shapes": conv16["shapes"]}}
    record["kernels"][4]["max_abs_err"] = max(
        record["kernels"][4]["max_abs_err"], conv16["max_abs_err"])
    # phase 21: each program's launches a request (equal to eager's) and
    # its one request's K1 / K2 replays and K4 calls (bit-equal, timed)
    for i, key, name in ((0, "k1", "pillar_scatter_max"),
                         (2, "k2", "rotated_overlap"), (4, "k4", "int8_conv")):
        k = record["kernels"][i]
        k["export"] = {tag: {
            "launches_per_request": r["launches_per_request"].get(name, 0),
            "replays": r["replays"].get(key)}
            for tag, r in exported.items() if tag.startswith("21")}
        k["max_abs_err"] = max([k["max_abs_err"]] + [
            r["replays"]["max_abs_err"] for r in k["export"].values()
            if r["replays"]])
    # phase 22: the create_data -> train chain's launches (counts set to 0
    # just before 22b, read just after) and its calls replayed; 22c's
    for i, key, name in ((0, "k1", "pillar_scatter_max"),
                         (2, "k2", "rotated_overlap")):
        k = record["kernels"][i]
        k["data_prep_chain"] = {
            "train_launches": prep_launches[name],
            "dist_test_launches": prep["dist_test"]["launches"][name],
            "replays": prep_replays[key]}
        k["max_abs_err"] = max(k["max_abs_err"],
                               prep_replays[key]["max_abs_err"])
    # phase 23: each path's launches (counts set to 0 just before each,
    # read just after) and its K1 / K2 calls replayed (23a, 23b)
    for i, key, name in ((0, "k1", "pillar_scatter_max"),
                         (2, "k2", "rotated_overlap")):
        k = record["kernels"][i]
        k["two_stage_remainder"] = {
            "launches": {t: v[name] for t, v in rem_launches.items()},
            "replays": {t: v["replays"][key] for t, v in
                        list(remainder["23a"].items())
                        + list(remainder["23b"].items())
                        if key in v.get("replays", {})}}
        k["max_abs_err"] = max([k["max_abs_err"]] + [
            r["max_abs_err"] for r in
            k["two_stage_remainder"]["replays"].values()])
    # phase 25: the spatial ranks' launches a request (the last served
    # request of 25a / 25b, 25c's step) and their calls held to the plain
    # versions
    for i, key, name in ((0, "k1", "pillar_scatter_max"),
                         (2, "k2", "rotated_overlap"), (4, "k4", "int8_conv")):
        k = record["kernels"][i]
        k["spatial"] = {
            "launches_per_rank": {tag: [
                (launches[-1] if isinstance(launches, list) else launches)
                .get(name, 0) for launches in spatial[tag]["per_rank"]]
                for tag in ("25a", "25b", "25c")},
            "replays_per_rank": [r[key] for r in spatial["replays"]]}
        k["max_abs_err"] = max([k["max_abs_err"]] + [
            r[key]["max_abs_err"] for r in spatial["replays"]])
    for k in record["kernels"]:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} never launched on the path")
    print(f"[profiler] {PROFILE_STATS['sessions']} sessions, "
          f"{PROFILE_STATS['retaken']} taken again for lost device events, "
          f"{PROFILE_STATS['lossy']} kept with a loss, "
          f"{PROFILE_STATS['cuda_events']} timed by CUDA events instead")
    print(json.dumps({"training": training}))
    print(json.dumps({"two_stage": two_stage}))
    print(json.dumps({"two_stage_training": two_stage_training}))
    print(json.dumps({"eval": evaluation}))
    print(json.dumps({"training_as_written": as_written}))
    print(json.dumps({"precisions": precision}))
    print(json.dumps({"data_parallel": data_par}))
    print(json.dumps({"compact": compact}))
    print(json.dumps({"export": exported}))
    print(json.dumps({"data_prep": prep}))
    print(json.dumps({"two_stage_remainder": remainder}))
    print(json.dumps({"model_remainder": model_rem}))
    print(json.dumps({"spatial": {k: v for k, v in spatial.items()
                                  if k != "replays"}}))
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.exit(dp_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--spatial-rank"]:
        sys.exit(spatial_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--spatial-cards"]:
        sys.exit(spatial_cards())
    if sys.argv[1:2] == ["--cli-rank"]:
        sys.exit(cli_rank(sys.argv[2:]))
    if sys.argv[1:2] == ["--serve-artifact"]:
        sys.exit(serve_artifact(sys.argv[2]))
    if sys.argv[1:2] == ["--data-prep-numpy"]:
        sys.exit(data_prep_numpy(sys.argv[2:]))
    if sys.argv[1:2] == ["--loader-passes"]:
        sys.exit(loader_passes(*sys.argv[2:]))
    if sys.argv[1:2] == ["--loader-compare"]:
        sys.exit(loader_compare(sys.argv[2]))
    if sys.argv[1:2] == ["--k4-compare"]:
        sys.exit(k4_compare(sys.argv[2]))
    sys.exit(main())
