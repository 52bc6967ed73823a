#!/usr/bin/env python3
"""Drive the PyTorch port (mgproto_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs a CUDA GPU and nvcc
    python3 chip_smoke.py --repeat-serve N   # the kernel and serve phases in N fresh processes
    python3 chip_smoke.py --dist-probe       # the collectives two processes can run on the card

Phases, one JSON line each (`t_s`: seconds since the script started):
  1. env:    torch/CUDA versions and the card (name, power limit); then a
             probe line: whether cv2 and matplotlib import here (the port
             needs neither; the probe never fails);
  2. build:  the four CUDA kernels compiled from mgproto_tpu_torch/csrc/,
             one nvcc per source, in parallel;
  3. kernel: each kernel held against its plain PyTorch version on the card
             at the shapes the flagship's serve path (B = 8) and train step
             (B = 80) give it: score_pool at B = 8, HW = 196 and 784, at
             B = 80 and 1, HW = 196, at a ragged P = 2037 and on exact ties;
             the BN epilogue at the four ResNet-34 stage shapes, at B = 8 in
             f32 and bf16 and at B = 80 in f32 on the batch's own
             statistics; the score_pool backward at B = 80, P = 2000, T = 20
             on the train step's mined gradient (HW = 196), on a dense one
             (HW = 196 and 784) and on a hub input (equal feature rows,
             mined g), bitwise across two launches; the EM E-step over
             A = 200 classes of N = 800 rows, K = 10, d = 64 and over a
             compact slab of 80 of them (bitwise across two launches, and
             equal to the same classes in the A = 200 call), and on that
             slab with sigmas in 0.3-0.5, and over a slab of 16 (the
             online consolidation's width). Each is timed
             beside its bound, the plain version and (score_pool) the
             unfused torch.matmul + torch.topk, as device time (CUDA events
             around calls queued behind a spin kernel); inputs larger than a
             MB rotate through copies larger than the L2, so they come from
             HBM as on the main paths;
  4. serve:  the flagship ResNet-34 MGProto (C=200, K=10, d=64, T=20, 224 px,
             seeded random weights) calibrated on 16 ID images and served
             through ServingEngine; every id answered once, bad payloads
             rejected typed, the kernel launch counts per dispatch checked
             (score_pool 1, epilogue 16), and served scores held against the
             same weights run through the plain path on the CPU (where the
             two disagree, against the float64 forward, and the CPU's
             departure is reported); the same comparison with TF32 switched
             on must exceed the tolerance;
  5. train:  the flagship Trainer at batch 80 from a full seeded bank: six
             steps with mining and EM, then a warm step, with the launches,
             the EM fallback and the pinning of untouched classes checked
             per step; the first step is repeated from the same state on
             three other routes (every kernel off; the epilogue off on both
             sides, so only the scoring kernels and the E-step differ; and
             the plain route on images scaled by 1 + 1e-7, the floor), and
             activations and their gradients are compared along the trunk,
             and the scoring route reports the score_pool kernel's index
             agreement with the plain pool on its own first-step features;
             then a profile of three steps by kernel family;
     planner: the memory planner at the flagship, in process
             (perf/planner.py): every candidate of `candidate_plans`
             (batches 80 / 160 / 320, remat none and layer1, prefetch 2
             and 0, the uint8 wire) measured by one step on the card from a
             seeded throwaway state with a full bank: its peak, seconds and
             launches (1 / 16 / 1 / 3 a program, 19 epilogues with layer1
             recomputed), one candidate measured twice (spread within 5 %),
             then `autotune` under a budget between the top batch's peaks
             and the smaller ones', so rejections are exercised without an
             out-of-memory error; beside it the planner pair: two gloo
             ranks on cuda:0 (`chip_smoke.py --planner-child`, started
             with the phase) run `cli.train`'s planning step at 40 rows a
             rank with the default measure, rank 1 under a budget between
             the in-process b80 and b160 program peaks, rank 0 under the
             card's total: both choose the same plan under rank 1's
             budget, each candidate's peak the larger rank's, and a
             candidate that fits rank 0 alone is rejected;
     telemetry_cost: three b80 steps of `train_epoch` with a StepMonitor
             and without, twice each (cuDNN deterministic): the same
             launches, the states bit-equal, the step times side by side;
  6. input:  the training input path: a seeded folder of 800 JPEGs (200
             classes x 4, 500x375, quality 90) under build/input_phase/,
             read by build_pipelines' train loader (ImageFolder, the
             geometry-only TrainTransform, 8 spawn workers, the shared-memory
             ring) on the uint8 wire with per-sample seeds; the host native
             library built and held to its numpy plain version; two passes
             over epoch 0's first two batches, and the thread backend, give
             the same bytes (sha256); the augmentation tail on the card held
             to the same function on the CPU and timed; the first step on
             the uint8 route held to the same batch augmented on the CPU and
             shipped as f32; one batch on each wire copied alone, timed by
             put_batch's CUDA events on its copy stream; then the flagship
             trained for one epoch (10 steps at batch 80, mining and EM on)
             through Trainer.train_epoch with the launches counted and each
             step's copy timed the same way (beside PCIe Gen5 x16's peak),
             and a profile of the next epoch. The observatory rides on that
             epoch: (a) a telemetry session's StepMonitor and a
             ProfilerWindow over steps 3-4 observe it (the `input` line's
             timing figures leave out steps 3-5, which carry the window's
             start, trace and export); the window's
             trace holds each kernel's device events at its launches a step
             times its CUDA kernels a launch, each in its stall bucket; its
             stall report (obs/stall.py: the CUDA streams merged, fractions
             summing to 1, measured MFU against 67 TFLOP/s) has its device
             busy a step within 10 % of the profile's; the cost counter
             gives the same FLOPs, bytes and kernel rows on the card and
             the CPU at batch 8; (b) a cold batch shape between two
             epoch-shaped steps fires the recompile trigger and its capture
             holds device events; (e) `cli.telemetry summarize` shows the
             report in the session's directory as its perf section, and
             `check --stall-report R --stall-baseline R` exits 0;
  7. schedule: the whole training schedule through cli/train.run_training
             at the flagship (the input phase's folder as the train, push
             and test set, a second seeded folder of 5 classes x 16 as one
             OoD set; 2 epochs with mining and EM from a full seeded bank,
             push at epoch 1, top-8 prune; cuDNN deterministic): every
             stage checkpoint, the launches of the run, of one test pass and
             of one push scan; the test pass's log p(x) on the kernel route
             against the plain route on the card; pushed means against the
             features recomputed at their (image, patch); the pruned priors;
             a checkpoint's save, restore and bytes, bit-exact; the run
             resumed from epoch 0's checkpoint against the uninterrupted
             one, bit for bit; and one step on a batch holding a label -1
             sentinel row. The push renders (run_training's default): the
             render line checks 3 JPEGs per pushed prototype, decodes a
             seeded sample, and holds 8 crop boxes from maps upsampled on
             the card to the boxes from the same maps on the host. Its
             checkpoints are removed at the end but for a copy of the
             `push` checkpoint;
  8. interpret: that checkpoint restored through cli/interpret.run_interpret
             (metric "all", the patch CSV) on a CUB-layout tree of 200
             classes x 4 seeded 500x375 JPEGs with CUB's 15 parts: the four
             metrics and the CSV rows, the clean and noisy passes' times, the
             host post-passes' times and the epilogue's launches (16 a batch
             and pass); then the maps on the kernel route against the plain
             route (epilogue off), the batched peaks on the card against
             the scalar host peaks, and purity_from_csv against the purity;
  9. options: the flagship with compute_dtype="bfloat16" and the other
             training options: the bf16 epilogue at the four stage shapes
             at B = 80 on the batch's own statistics against its plain
             version (timed beside its bf16 byte bound); the bf16 forward
             calibrated on 16 ID images and served (launches per dispatch,
             |d log p(x)| and |d logit| against the same weights in f32, a
             float32-stamped calibration refused); six bf16 steps at batch
             80 with mining and EM from a full seeded bank (launches per
             step, the state's statistics f32, the first step against the
             f32 first step, a profile by kernel family), then a test pass
             and a push of that state (launches, f32 means); one step with
             each of the five other aux losses; remat and remat_stages
             against the plain step (cuDNN deterministic, peak memory);
             one reference-stepping EM call on the card against the CPU.
 10. backbones: vgg19 and densenet121 at the flagship's widths (C=200,
             K=10, d=64, T=20, bank 800, batch 80, 224 px, f32), each trunk
             from a seeded torchvision-layout .pth written under
             build/pretrained/ (the DenseNet file with legacy `norm.1`
             keys) through create_train_state(pretrained=True), held bit
             for bit to the file; six steps with mining and EM from a full
             seeded bank (launches per step: score_pool 1, its backward 1,
             the E-step num_em_loop, the epilogue 0); the first step held
             to the plain route on the card (loss, EM log-likelihood,
             priors, and the gradient within 1e-4, or 2x its floor on
             images x (1 + 1e-7) if larger and that perturbation changes
             no top-T list); a test batch's log p(x) on both routes; a profile of
             three steps by kernel family; densenet121 with remat=True
             against the plain step, cuDNN deterministic, bit for bit, with
             both peaks;
 11. cli:    the command line: (a) `python -m mgproto_tpu_torch.cli.train
             --arch densenet121` from phase 10's .pth on the input phase's
             folder, with the schedule phase's OoD folder as its test and
             push set, one epoch with the push (rendered) at epoch 0, then
             the prune, with `--profile_steps 2:4 --profile_out`: its
             window's capture holds steps 3-4's device events and the head's
             kernels at their launches; (b) `cli.evaluate` on its prune checkpoint prints the
             accuracy its last test pass wrote; (c) `cli.interpret` on the
             interpret phase's tree and checkpoint prints the metrics its
             run_interpret returned; (d) a real SIGTERM to a resnet18
             `cli.train`'s process group in its first step, while a spawn
             worker is still starting in that group: exit 0,
             PREEMPTED.json, a preempt checkpoint with its batch position,
             its 2 spawn workers neither replaced nor left behind, and `--resume auto` finishes
             the run (the OoD folder as its test set) and clears the
             marker, with `--profile_dir --profile_on_anomaly`: the resumed
             epoch's trace holds device events, and the recompile capture
             that falls due inside it is skipped with a logged note (one
             profiler a process); (e) the preempt and NaN drills
             through run_training (resnet18, cuDNN deterministic) end bit
             for bit at the clean run's state, and a budget of 0 rollbacks
             raises.
 12. serve plane: the export and serving plane on the schedule's `prune`
             and `push` checkpoints (copied under build/serve_phase/run/ with
             the run's push provenance; seeded flagship states when the
             phase runs alone): (a) `cli.export --calibrate --explain` on the
             first and `--calibrate` on the second, two processes at once,
             bytes and wall s; (b) `cli.serve --artifact --images` on 64
             test images of the input phase's folder with `--stdin` JSONL
             (two images, three malformed lines) and `--explain`: every id
             answered once, the malformed rejected typed, each line
             bit-equal to `ServingEngine.from_live` on the restored
             checkpoint in this process, the artifact's logits bit-equal to
             from_live's on the same card and buckets and within 1e-4 of the
             CPU plain path, its explanations' indices equal and
             log-densities within 1e-4, no pruned prototype explained;
             dispatch ms per bucket; with `--trace_requests` and
             `--profile_warmup` (the observatory's (c)): every answered
             request's timings and its frontend, batcher, replica and engine
             spans in the session's trace, serving_stage_seconds counting
             each request, the warmup trace's score_pool and epilogue events
             at 1 and 16 a bucket, the tracer's host cost a request; (c) the plane in this process, 1 then
             2 replicas behind the frontend on a loopback port, 32 requests:
             the launches per dispatch (score_pool 1, epilogue 16, the
             training kernels 0) and the peak memory of each; (d)
             `cli.serve --listen --replicas 2` as a process (started beside
             (b)): 8 client threads of 8 requests (requests/s, p50/p99),
             /healthz, /readyz, /metrics, a swap to the push artifact
             (committed) and one to an uncalibrated copy (refused, the old
             model still answers), then SIGTERM with 16 requests in flight:
             each answered typed, exit 0; (e) `cli.export --quantize int8
             --calibrate` on the push checkpoint (a third process started
             with (a)'s two, collected after (d)): the int8 artifact, its
             dequantize-on-load twin and the f32 push artifact each served
             through a ServingEngine at buckets 1/2/4/8 on the 64 images:
             int8 vs twin within 1e-5 (0 expected), int8 vs the CPU plain
             path within 1e-4 (float64 where the CPU departs), int8 vs f32
             printed, the weights at rest equal to quant_config's
             total_weight_bytes, launches (1 / 16 / 0 / 0 a dispatch), the
             gate drill (the f32 calibration grafted in: quant_mismatch,
             counted once, verify_head "quant_mismatch"); memory after load
             and over a bucket-8 dispatch, its device ms and the
             dequantize's launches and ms, artifact bytes, and the check's
             seconds on a line of its own.
 13. elastic: (a) the async bank pipeline at the flagship (batch 80, a full
             seeded bank, cuDNN deterministic), 8 steps sync and 8 async
             from one cloned state in f32 and in bf16: the async run bit-
             equal to a one-step-stale oracle built from the sync trainer's
             own functions, its first step's scalars equal to the sync
             first step's, the flushed bank's lengths equal to the sync
             run's (its cursors are reported: which patches a step enqueues
             depends on the means it scored), launches per step equal
             (1 / 16 / 1 / 3);
             median step s, a 3-step profile of each mode (idle share) and
             the ms in which bank-stream kernels ran beside main-stream ones
             (its chrome trace), beside the async steps'
             bank_dispatch_overlap_fraction gauge (the observatory's (d):
             in (0, 1]); then phase 11's rollback and preemption
             drills on the async pipeline, bit-equal to the clean async run;
             (b) on phase 12's `push` artifact (exported here when phase 12
             did not run): a ReplicaSet at 1 replica under Autoscaler(1, 3)
             on its pump, a burst of 96 requests: up to >= 2 and back to 1,
             every request answered or shed typed, each scale-up's pump
             turn timed, peak memory; and `cli.serve --listen --autoscale
             1:3` (started first) under 8 HTTP clients with GET
             /admin/autoscale before and after; (c) three tenants (the
             calibration at the 5th, 25th and 50th percentile) on a
             2-replica fleet, a fourth mounted mid-load, one image scored
             equal under each, MGPROTO_CHAOS_TENANT_STORM_AT shedding only
             the storm tenant's tail, MGPROTO_CHAOS_TENANT_BAD_SWAP=1
             refusing that tenant's swap while the others serve on, 0 cold
             dispatches, 1 / 16 / 0 / 0 launches a dispatch; (d)
             MGPROTO_CHAOS_SERVE_REPLICA_KILL_AT and _DEVICE_ERRORS on a
             2-replica fleet: every request answered typed, the killed
             replica restarted.
 14. online (its three processes, (b)'s and (c)'s, start first,
             together, and the in-process checks that time nothing run
             beside them; (a) and (b)'s timed consolidation run after they
             exit): (a) the start of a serving process split into its parts
             (`start_split`: import, CUDA context, kernel library load,
             artifact read, model build, warmup) in two fresh `cli.serve
             --artifact --images` processes of phase 12's `push` artifact,
             the second building no kernel; (b) `cli.serve --checkpoint
             --calibrate --online --online_capture_percentile 10` on 64 of
             the input phase's images as a process, calibrated on the first
             image of each class (captured > 0, at least
             one consolidation, samples = captured), and in process the
             same 64 samples consolidated at width 16 on the card and on the
             CPU plain path from that checkpoint, batch by batch: a sample
             whose top-1 patch list differs must be a near tie in the CPU's
             densities (margin <= 2e-4), at most 2 such samples, and their
             classes are set apart; in every other class means within 1e-4,
             priors within 1e-5, bank lengths equal and bank rows within
             1e-4; in a class set apart means and priors within what its
             differing rows can move in the EM rounds run; launches a
             batch (score_pool 1, epilogue 16, its backward 0, the E-step
             num_em_loop), `steady_recompiles` 0, served logits bit-equal
             across the consolidation, and a Republisher commit through
             hot_swap on 2 replicas answering as from_live on the
             candidate; ms a batch and peak GB above the loaded model; (c)
             `cli.online drill --device cuda` with each drift kind as
             processes under MGPROTO_CHAOS_ONLINE_POISON_RATE=0.05: the
             gates' verdicts equal the same drill's on the CPU, the gates
             that hold by construction pass, the poison counted and none of
             it captured by the shift drill, the new class in slot 4 without
             a cold dispatch or a build; (d) three tenants with drift
             monitors and capture reservoirs on the artifact, the storm
             tenant's lane poisoned by MGPROTO_CHAOS_TENANT_POISON_RATE: only
             its monitor breaches.
 15. trust  ((a)'s process starts first; (b) and (c), which time nothing,
             run beside it): (a) `cli.trust matrix --artifact <phase 12's
             push artifact> --device cuda --max_samples 64` with the input
             phase's folder as the ID set and the schedule phase's OoD folder
             (run through `chip_smoke.py --trust-child`, which calls
             `cli.trust.main` and prints the process's launch counts and
             dispatches): 22 cells of 64 requests, each with submitted =
             returned = n, 0 cold dispatches, not degraded, the exit code
             equal to `cli.telemetry check --trust` on the written report,
             launches 1 / 16 / 0 / 0 a dispatch (warmup included); the
             matrix's seconds, then ms per corruption chunk (B = 8, 224 px)
             of each kind at severity 5; (b) the ID cell's first chunk and
             each kind's severity-5 first chunk corrupted and served on the
             card and on the CPU plain path from the same artifact: images
             within 1e-6, log p(x) within 1e-4 (or the card within it of the
             float64 forward where the CPU departs), outcomes equal but near
             the threshold; (c) `matrix --synthetic` at the reduced size on
             the card and on the CPU from the same seeded state: the same
             verdicts, outcome counts equal but near the threshold, scores
             within 1e-4; on the card run itself, each bootstrap batch
             launches score_pool 1, the epilogue 0 and the E-step
             num_em_loop, and the run exactly its bootstrap, calibration,
             warmup and matrix forwards' score_pool and nothing else.
 16. distributed: (a) two ranks on the one card (`python3 chip_smoke.py
             --dist-child`, gloo named explicitly: NCCL refuses one card
             twice), the flagship at batch 80 (40 a rank) from a seeded state
             with a full seeded bank, at mesh (2, 1) and (1, 2): three steps
             with mining and EM, each rank's launches a step exact (score_pool
             1 on its class slab, its backward 1, the epilogue 16, the E-step
             3 on its slab), the ranks' parameters and BatchNorm statistics
             bit-equal, and the steps held to the one-process Trainer's on
             the card: losses within 1e-5 relative or twice what images x
             (1 + 1e-7) move them, accuracy within one sample, em_active
             equal, the bank's lengths equal, the means, the first step's
             gradient and the parameters' update within twice that
             perturbation's floor; then two more steps with the collectives
             timed apart (per-rank step s, collective and compute ms); at
             (1, 2) the parameters, the proxies and their Adam moments are
             held cut over the model axis, and after the restore, after the
             steps and after the async steps every rank's storage behind
             them equals `tree_bytes_per_chip` of their specs exactly
             (printed beside the replicated count, with the card's
             allocated bytes at rest); then
             three steps of the async bank pipeline and its flush at each
             mesh (the bank phase's gather and EM sums on its own process
             groups, from the bank stream), held to the one-process async
             Trainer the same way, the ranks bit-equal, launches a rank and
             step score_pool 1, its backward 1, the epilogue 16, the E-step
             3 on the bank stream (none on the fill step, 3 in the flush);
             the async state saved sharded at (1, 2) (each rank its slab and
             its slices, COMMIT-published; each rank's npz within its chunks'
             headers of the bytes its specs give it), restored by the pair
             at (2, 1) and by the parent at world 1, each bit-equal to the
             saved gathered state (save and restore seconds and bytes a
             rank); (b) `cli.train
             --distributed` at world size 1 under NCCL (the launcher's
             environment set) for one epoch on the input phase's folder,
             the OoD folder as test and push set: it trains, tests, pushes
             (rendered), prunes and saves, and `cli.evaluate --distributed`
             prints the run's last test accuracy from its prune checkpoint;
             (c) the pod drill: resnet18 at the flagship's head widths, two
             gloo ranks of `cli.train --distributed --ckpt_format sharded
             --barrier_timeout_s 10` on cuda:0 (`chip_smoke.py
             --pod-child`, cuDNN deterministic) on the OoD folder, one pair
             clean and one with MGPROTO_CHAOS_KILL_HOST_AT on rank 1: rank
             1 exits 86, rank 0 exits 75 within the failure agreement's
             wait (the timeout twice) and a margin with PEER_LOST.json
             naming rank 1 and its flight recorder dump (rank 0's,
             unsuffixed), only committed checkpoints are left, and the
             pair relaunched with `--resume auto` ends at the clean run's
             state digest; `cli.evaluate` in one process restores the
             clean pair's sharded prune checkpoint and prints its last
             test accuracy (within one sample); (d) the (1, 2) pair's
             `interp_metrics_sharded` on the interpret phase's CUB tree cut
             to its first 32 images, from (a)'s sharded save, equals
             `run_interpret`'s metrics on them in one process exactly, or
             differs by at most two near ties where every map is within
             1e-4 of the other's largest value; beside it `cli.interpret
             --distributed --mesh_model 2` as two gloo rank processes on
             cuda:0 (`chip_smoke.py --interp-child`, started with the
             phase, its main run once the save's COMMIT exists) on the same
             save and images prints the pair's metrics by the same rule, rank 0
             alone printing and writing the CSV, each rank's epilogue
             launches exact.
Telemetry: the mains' processes write their telemetry
directories (phase 11's `cli.train` and `cli.evaluate`, phase 12 (b)'s
`cli.serve --telemetry_dir`, phase 16 (c)'s rank pairs, the killed pair's
stream cut mid-run), and each is read by `cli.telemetry summarize` and
gated by `check --baseline` against itself (exit 0; a `telemetry_dir`
line each). Phase 12 (e) adds the planner's serve ladders
(`serve_ladders`: each bucket's program peak on the f32 and the int8
engine plus the weight term; under the budget where int8's largest bucket
just fits, its ladder is longer than f32's). Phase 15 (d) (`quant_record`)
runs (a)'s matrix on 12 (e)'s int8 artifact in process and gates the
record of (e)'s numbers with `check --quant` (exit 0; seeded weights).
Then the kernel summary line (times at the train step's shapes, the serve
path's beside them; `launches` counted on the input phase's epoch,
`schedule_launches` on the schedule phase's run, `interpret_launches` on
the interpret phase's run_interpret, `bf16_train_launches` on the options
phase's bf16 steps, `backbone_launches` on phase 10's six steps of each
trunk, `drill_launches` on phase 11's in-process drills, `serve_plane_launches`
on phase 12's in-process plane, `quant_serve_launches` on (e)'s int8
engine, `planner_launches` on the planner's measured steps, `async_launches` on phase 13's async
steps and their flushes, `async_drill_launches` on its async drills,
`elastic_serve_launches` on its autoscaled and tenant planes,
`online_launches` on phase 14's consolidation on the card, `trust_launches`
on phase 15's full-width matrix process, `distributed_launches` on
phase 16 (a)'s ranks, both meshes, `distributed_async_launches` on their
async steps and flushes, `distributed_interp_launches` on (d),
`distributed_interpret_cli_launches` on (d)'s cli.interpret pair; the epilogue's
bf16 times at B = 80 under "train_bf16") after a `script` line with the
script's seconds, the card line as
nvidia-smi prints it, and last `{"ok": true, "device": {...}}`. Any failed
check exits non-zero before that line is printed.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()

F32_TFLOPS = 67e12  # H100 SXM data sheet: non-tensor float32
HBM_BYTES_S = 3.35e12  # H100 SXM data sheet: HBM3
# H100 SXM data sheet: PCIe Gen5 x16, 128 GB/s both ways; one direction's
# 64 GB/s less the 128b/130b line code
PCIE_BYTES_S = 64e9 * 128 / 130
# a timing loop cycles through copies of its inputs that together hold 4x the
# H100's 50 MB L2, so each launch reads them from HBM as the served path does
ROTATE_BYTES = 4 * 50e6
# device_ms's first spin ahead of the timed calls: ~8.5 ms at 1.98 GHz
SPIN_CYCLES = 1 << 24
# ResNet-34 without the stem pool at 224 px: (blocks, H=W, C) per stage
R34_STAGES = ((3, 112, 64), (4, 56, 128), (6, 28, 256), (3, 14, 512))
# served log p(x) / logits vs the CPU plain path. cuDNN and oneDNN sum the 36
# f32 convolutions in different orders: measured 9.1e-6 (logits) and 6.7e-6
# (log p(x)) on an H100. The limit sits 10x above that and below what TF32
# convolutions give (the serve phase measures that too and requires it to
# fail this limit), so the precision the numerics policy forbids is caught.
SERVE_ATOL = 1e-4
SCORE_ATOL = 1e-4  # score_pool vs plain: FMA chain vs cuBLAS order, |v| <= ~15
# score_pool backward and E-step statistics vs plain: summation order only,
# so 1e-5 of the plain output's largest magnitude; the E-step's mean
# log-likelihood (|ll| ~ 50) within 1e-4
BWD_RTOL = 1e-5
ESTEP_RTOL = 1e-5
ESTEP_LL_ATOL = 1e-4
TRAIN_BATCH = 80
TRAIN_STEPS = 6  # then one warm step
ONLINE_WIDTH = 16  # the online consolidation batch (phase 14) and its E-step case
# Routes of the first train step from one state, on the card, against the
# plain route (every kernel off). All share the cuDNN convolutions.
#  * Loss relative 1e-5; EM log-likelihood atol 1e-3 (|ll| ~ 50); priors
#    atol 1e-5, on every route.
#  * Scoring route (score_pool forward and backward and the E-step on, the
#    epilogue off on both sides): the trunk gradient within 1e-4 relative
#    norm. The two differ only in the head's summation order (1.5e-5
#    measured on an H100), so a wrong term in either kernel, even on the
#    ~5.5 % of the pooled values the mining mask leaves live, shows.
#  * Kernel route (every kernel on): the epilogue computes x*a + b with
#    folded constants against (x - mean)*a + bias, a one-ulp difference in
#    most activations. The trunk gradient moves under such a difference by
#    a floor measured here, `grad_rel_floor`: the plain route against itself
#    on the images scaled by 1 + 1e-7. The kernel route must stay within
#    TRAIN_GRAD_FLOOR_MULT times that floor; a wrong term in a backward
#    gives O(1).
TRAIN_LOSS_RTOL = 1e-5
TRAIN_SCORING_GRAD_RTOL = 1e-4
TRAIN_GRAD_FLOOR_MULT = 2.0
TRAIN_LL_ATOL = 1e-3
TRAIN_PRIOR_ATOL = 1e-5
# the input phase: the augmentation tail on the card against the same
# function on the CPU (f32 elementwise ops in one order; the card's and the
# CPU's division and rounding of the mean luma may differ in the last ulp);
# the first step on the uint8 route against the same batch augmented on the
# CPU and shipped as f32: the train phase's loss tolerance
TAIL_ATOL = 1e-5
INPUT_CLASSES, INPUT_PER_CLASS, INPUT_HW = 200, 4, (375, 500)
INPUT_WORKERS = 8
# spawn workers of the SIGTERM'd train main: eight importing torch at once
# took 10-74 s to start, the run's wall; two exercise the same path
SIGTERM_WORKERS = 2
# the schedule phase: a second folder as its OoD set, 2 epochs, top-8 prune
OOD_CLASSES, OOD_PER_CLASS = 5, 16
SCHEDULE_EPOCHS = 2
SCHEDULE_PRUNE_M = 8
# the command-line phase's in-process drills train on 2 of the 4 images a class
DRILL_PER_CLASS = 2
# pushed means against the features recomputed at their (image, patch) in
# a batch of another size: the convolutions may pick other algorithms, so
# SERVE_ATOL, not bit equality
PUSH_FEATURE_SAMPLE = 16
# the push render: rendered prototypes decoded, and those whose crop box is
# recomputed from the map on the card and from the same map on the host
RENDER_DECODE_SAMPLE = 32
RENDER_BOX_SAMPLE = 8
# the interpret phase: a CUB-layout tree of 200 classes x 4 test images
# (CUB's test split has 5,794, ~29 a class) with CUB's 15 parts, each
# visible with probability 0.8; metrics with the JAX CLI's defaults
CUB_PARTS = ("back", "beak", "belly", "breast", "crown", "forehead", "left eye", "left leg",
             "left wing", "nape", "right eye", "right leg", "right wing", "tail", "throat")
INTERPRET_PER_CLASS = 4
PART_VISIBLE = 0.8
# collected maps, kernel route vs plain route (epilogue off): the served
# tolerance, of each map's maximum
MAP_ATOL_OF_MAX = SERVE_ATOL
# batched peaks on the card vs the scalar host peaks on the same maps: the
# card's and the CPU's bicubic round differently, so a near-tie argmax may
# move by one pixel on at most this share of maps
PEAK_MOVED_SHARE = 0.01
# the options phase (9): the flagship trained and served with
# compute_dtype="bfloat16" and the other training options.
#  * The bf16 first step against the f32 first step from one state and
#    batch: the loss within 2 % (the JAX package's gate for a bf16 step,
#    tests/test_precision.py); the gradient's norm ratio and cosine are
#    reported, not gated (JAX measured a cosine of 0.89-0.91 at resnet18).
#  * Served bf16 scores against the same weights served in f32: reported,
#    not gated (whether bf16 keeps log p(x) inside a calibration's
#    tolerance is what the phase measures).
#  * Remat against the plain step from one state, cuDNN deterministic: the
#    BatchNorm running statistics bit-equal; the gradients bit-equal, or
#    within REMAT_GRAD_RTOL relative norm should cuDNN pick another
#    algorithm for the recomputed forward.
#  * Reference stepping on the card against the same call on the CPU: the
#    priors atol 1e-5; the means within 1e-5 (summation order of the
#    E-step; measured 7.5e-8 on an H100), except on at most 1e-3 of the
#    elements, which may lie within 2 lr per round (a near-zero gradient
#    turns into +-lr under Adam, so a difference in the last ulp of one
#    can move an element 2 lr); the Adam moments within 1e-4 of their
#    largest magnitude.
BF16_LOSS_RTOL = 0.02
REMAT_GRAD_RTOL = 1e-5
REF_EM_PRIOR_ATOL = 1e-5
REF_EM_MEANS_ATOL = 1e-5
REF_EM_MEANS_BEYOND_SHARE = 1e-3
REF_EM_MOMENT_RTOL = 1e-4
OPTION_AUX_LOSSES = ("proxy_nca", "ms", "contrastive", "triplet", "npair")
# where activations and their gradients are compared between routes: the
# ResNet-34 stages; the VGG and DenseNet trunks' output and the add-on
PROBES = ("features.bn1", "features.layer1", "features.layer2", "features.layer3",
          "features.layer4", "add_on")
BACKBONE_PROBES = ("features", "add_on")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(phase, **kw):
    # one write a line: phase 11 emits from two threads at once
    sys.stdout.write(json.dumps({"phase": phase, **kw, "t_s": time.perf_counter() - T_START}) + "\n")
    sys.stdout.flush()


def event_ms(fn, iters=50, warmup=3):
    """Mean time per call of `fn` over `iters` back-to-back calls between two
    CUDA events. Where a call's host work (Python, ctypes, launch) outlasts
    its kernels, this is the host's issue interval, not device time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, warmup=3):
    """Mean device time per call of `fn` over `iters` warmed calls. The calls
    are queued behind a spin kernel (torch.cuda._sleep) that outlasts the
    host's issue of all of them, so the two CUDA events around them time the
    device's work back to back, without the host's launch gaps. The spin
    grows until the first event is still pending when the host has issued
    the last call; a `fn` that synchronizes never gets there and fails."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = SPIN_CYCLES
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued = not start.query()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / iters
        cycles *= 8
    raise SmokeFailure("device_ms: the host did not queue the calls before the spin ended")


def rel_error(got, want):
    """max |got - want| / |want| over entries with |want| > 1e-6 (ReLU zeros
    and exact zeros carry no relative error)."""
    got, want = got.float(), want.float()
    keep = want.abs() > 1e-6
    return ((got - want).abs()[keep] / want.abs()[keep]).max().item() if keep.any() else 0.0


def bound_ms(flops, nbytes):
    """The larger of f32 operations over the non-tensor f32 peak and bytes
    over the HBM rate, in ms, and which of the two it is."""
    t_ops, t_bytes = flops / F32_TFLOPS, nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


# ------------------------------------------------------------------ kernels
def score_pool_case(name, feat, means, sigmas, t_levels):
    """Kernel vs plain on one input; returns the case's record."""
    import torch

    from mgproto_tpu_torch.ops.fused_scoring import launch_score_pool, score_pool, score_pool_plain
    from mgproto_tpu_torch.ops.gaussian import precompute_diag_gaussian

    b, hw, d = feat.shape
    msc, ivar, const = (t.contiguous() for t in precompute_diag_gaussian(means, sigmas, 1e-10))
    p = msc.shape[0]
    vals, idx = score_pool(feat, means, sigmas, t_levels)
    pvals, pidx = score_pool_plain(feat, means, sigmas, t_levels)
    torch.cuda.synchronize()
    dens = const[None, :, None] + msc @ feat.transpose(1, 2) - 0.5 * ivar @ (feat * feat).transpose(1, 2)
    err = (vals - pvals).abs().max().item()
    rel_err = rel_error(vals, pvals)
    picked_err = (torch.gather(dens, 2, idx) - vals).abs().max().item()
    agree = (idx == pidx).float().mean().item()
    s_idx, _ = idx.sort(-1)
    distinct = bool((s_idx[..., 1:] != s_idx[..., :-1]).all())
    check(vals.shape == (b, p, t_levels) and torch.isfinite(vals).all(), f"{name}: bad values")
    check(err <= SCORE_ATOL, f"{name}: max |vals - plain| {err} > {SCORE_ATOL}")
    check(picked_err <= SCORE_ATOL, f"{name}: a picked index's density is off by {picked_err}")
    check(distinct, f"{name}: an index repeats within a top-T list")

    ring, copies = ring_of((feat,), 4.0 * feat.numel())

    def kernel():
        return launch_score_pool(next(ring)[0], msc, ivar, const, t_levels)

    def library():
        f = next(ring)[0]
        dd = const[None, :, None] + torch.matmul(msc, f.transpose(1, 2)) \
            - 0.5 * torch.matmul(ivar, (f * f).transpose(1, 2))
        return torch.topk(dd, t_levels, dim=-1)

    flops = 4.0 * b * hw * p * d
    nbytes = 4.0 * (b * hw * d + 2 * p * d + p) + 8.0 * b * p * t_levels
    bms, by = bound_ms(flops, nbytes)
    rec = {
        "case": name, "B": b, "HW": hw, "P": p, "d": d, "T": t_levels,
        "max_abs_err": err, "max_rel_err": rel_err, "picked_density_err": picked_err,
        "index_agreement": agree, "input_copies": copies,
        "ms": device_ms(kernel), "event_ms": event_ms(kernel),
        "wrapper_ms": device_ms(lambda: score_pool(next(ring)[0], means, sigmas, t_levels)),
        "plain_ms": device_ms(lambda: score_pool_plain(next(ring)[0], means, sigmas, t_levels)),
        "library_ms": device_ms(library),
        "bound_ms": bms, "bound_by": by,
    }
    return rec, (vals, idx, pvals, pidx)


def kernel_phase():
    import torch

    g = torch.Generator().manual_seed(0)
    c, k, d, t = 200, 10, 64, 20
    means = torch.nn.functional.normalize(torch.rand(c, k, d, generator=g), dim=-1).cuda()
    sigmas = torch.full((c, k, d), 1.0 / (2 * torch.pi) ** 0.5).cuda()
    cases = []
    for b, hw, path in ((8, 196, "serve"), (8, 784, "serve"), (TRAIN_BATCH, 196, "train"),
                        (1, 196, "serve"), (ONLINE_WIDTH, 196, "online")):
        feat = torch.nn.functional.normalize(torch.randn(b, hw, d, generator=g), dim=-1).cuda()
        rec, _ = score_pool_case(f"{path}_b{b}_hw{hw}", feat, means, sigmas, t)
        cases.append(rec)
        emit("kernel", kernel="score_pool", path=path, **rec)
    # a ragged prototype count: the last 128-prototype tile holds 117 (2037 = 15 * 128 + 117)
    rmeans = torch.nn.functional.normalize(torch.rand(2037, 1, d, generator=g), dim=-1).cuda()
    rsig = torch.full((2037, 1, d), 1.0 / (2 * torch.pi) ** 0.5).cuda()
    feat = torch.nn.functional.normalize(torch.randn(8, 196, d, generator=g), dim=-1).cuda()
    rec, _ = score_pool_case("ragged_p2037_b8_hw196", feat, rmeans, rsig, t)
    cases.append(rec)
    emit("kernel", kernel="score_pool", path="serve", **rec)
    # exact ties: dyadic values repeated at 4 positions each (row n = base[n % 49])
    base = torch.randint(-4, 5, (8, 49, d), generator=g).float() / 16
    tfeat = base.repeat(1, 4, 1).cuda()
    tmeans = (torch.randint(-4, 5, (c, k, d), generator=g).float() / 16).cuda()
    tsig = torch.full((c, k, d), 0.5).cuda()
    rec, (vals, idx, pvals, pidx) = score_pool_case("ties_hw196", tfeat, tmeans, tsig, t)
    check(torch.equal(idx, pidx), "ties: kernel indices differ from the stable plain order")
    check(torch.equal(vals, pvals), "ties: kernel values differ on exact inputs")
    check(bool((idx[..., 0] < 49).all()), "ties: top-1 is not the first occurrence")
    cases.append(rec)
    emit("kernel", kernel="score_pool", path="serve", **rec)
    serve_sp, train_sp, online_sp = cases[0], cases[2], cases[4]

    # the 16 launches of a forward: serve (B = 8, running statistics, f32 and
    # bf16), train step (B = 80, the batch's statistics, f32) and the online
    # consolidation batch (B = 16, running statistics, f32)
    epi = {path: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0}
           for path in ("serve", "train", "online")}
    gc = torch.Generator(device="cuda").manual_seed(0)
    for path, b, dtype in (("serve", 8, torch.float32), ("serve", 8, torch.bfloat16),
                           ("train", TRAIN_BATCH, torch.float32),
                           ("online", ONLINE_WIDTH, torch.float32)):
        for blocks, hw, ch in R34_STAGES:
            rec = epilogue_case(path, b, hw, ch, dtype, gc)
            rec["launches_per_forward"] = blocks
            emit("kernel", kernel="bn_epilogue", path=path, **rec)
            if dtype == torch.float32:
                e = epi[path]
                e["max_abs_err"] = max(e["max_abs_err"], rec["max_abs_err"])
                for key in ("ms", "plain_ms", "bound_ms"):
                    e[key] += blocks * rec[key]
    bwd = [score_pool_bwd_case(hw, mined, means, sigmas, g, hub)
           for hw, mined, hub in ((196, True, False), (196, False, False), (784, False, False),
                                  (196, True, True))]
    est = em_estep_cases(g)

    def serve(rec, library=True):
        keys = ("ms", "plain_ms", "bound_ms") + (("library_ms",) if library else ())
        return {key: rec[key] for key in keys}

    # ms, plain_ms and bound_ms at the train step's shapes (where the
    # launches are counted); the serve path's (B = 8) under "serve"
    return [
        {
            "name": "score_pool", "route": "cuda",
            "source": "mgproto_tpu_torch/csrc/score_pool.cu",
            "replaces": "mgproto_tpu/ops/fused_scoring.py:50",
            "launches": None, "max_abs_err": max(r["max_abs_err"] for r in cases),
            "ms": train_sp["ms"], "plain_ms": train_sp["plain_ms"],
            "bound_ms": train_sp["bound_ms"], "bound_by": train_sp["bound_by"],
            "library_ms": train_sp["library_ms"], "at": "B=80, HW=196, P=2000, T=20",
            "serve": dict(serve(serve_sp), at="B=8, HW=196"),
            "online": dict(serve(online_sp), at=f"B={ONLINE_WIDTH}, HW=196"),
        },
        {
            "name": "bn_epilogue", "route": "cuda",
            "source": "mgproto_tpu_torch/csrc/bn_epilogue.cu",
            "replaces": "mgproto_tpu/ops/fused_epilogue.py:69",
            "launches": None,
            "max_abs_err": max(e["max_abs_err"] for e in epi.values()),
            "ms": epi["train"]["ms"], "plain_ms": epi["train"]["plain_ms"],
            "bound_ms": epi["train"]["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "at": "the 16 launches of a forward, B=80, f32, batch statistics",
            "serve": dict(serve(epi["serve"], False), at="16 launches, B=8, f32"),
            "online": dict(serve(epi["online"], False),
                           at=f"16 launches, B={ONLINE_WIDTH}, f32"),
        },
        {
            "name": "score_pool_bwd", "route": "cuda",
            "source": "mgproto_tpu_torch/csrc/score_pool_bwd.cu",
            "replaces": "mgproto_tpu/ops/fused_scoring.py:91",
            "launches": None, "max_abs_err": max(r["max_abs_err"] for r in bwd),
            "ms": bwd[0]["ms"], "plain_ms": bwd[0]["plain_ms"],
            "bound_ms": bwd[0]["bound_ms"], "bound_by": bwd[0]["bound_by"],
            "library_ms": None, "at": "B=80, HW=196, mined gradient",
        },
        {
            "name": "em_estep", "route": "cuda",
            "source": "mgproto_tpu_torch/csrc/em_estep.cu",
            "replaces": "mgproto_tpu/ops/em_kernels.py:59",
            "launches": None, "max_abs_err": max(r["max_abs_err"] for r in est),
            "ms": est[0]["ms"], "plain_ms": est[0]["plain_ms"],
            "bound_ms": est[0]["bound_ms"], "bound_by": est[0]["bound_by"],
            "library_ms": None, "at": "A=80 (the compact width), N=800, K=10",
            "dense": dict(serve(est[1], False), at="A=200 (the dense fallback)"),
            "online": dict(serve(est[3], False),
                           at=f"A={ONLINE_WIDTH} (the online consolidation width)"),
        },
    ]


def epilogue_case(path, b, hw, ch, dtype, gen):
    """The epilogue at one ResNet-34 stage shape: kernel vs plain, timed on
    rotating inputs. The serve path normalizes with running statistics (any
    positive variance); the train step with the batch's own, computed as
    models/common.py's BatchNorm computes them."""
    import torch

    from mgproto_tpu_torch.models.common import BatchNorm
    from mgproto_tpu_torch.ops.fused_epilogue import epilogue_reference, fold_constants, launch_bn_epilogue

    def draw(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    x = draw(b, hw, hw, ch).to(dtype).permute(0, 3, 1, 2)
    r = draw(b, hw, hw, ch).to(dtype).permute(0, 3, 1, 2)
    if path == "train":
        mean, var = BatchNorm(ch).cuda().batch_statistics(x)
    else:
        mean = 0.1 * draw(ch)
        var = 0.5 + torch.rand(ch, generator=gen, device="cuda")
    scale = 0.5 + torch.rand(ch, generator=gen, device="cuda")
    bias = 0.1 * draw(ch)
    a, bb = fold_constants(mean, var, scale, bias, 1e-5)
    ring, copies = ring_of((x, r), 2 * x.numel() * x.element_size())

    def kernel():
        xi, ri = next(ring)
        return launch_bn_epilogue(xi, ri, a, bb)

    def plain():
        xi, ri = next(ring)
        return epilogue_reference(xi, mean, var, scale, bias, ri, 1e-5, torch.float32).to(dtype)

    # the kernel does f32 math and rounds once, so its plain version here is
    # epilogue_reference in f32, rounded to the activation dtype: equal up to
    # FMA contraction and the folding, i.e. 1e-5 absolute in f32 and one bf16
    # ulp (2^-7 relative) in bf16
    rtol = 0.0 if dtype == torch.float32 else 2.0 ** -7
    out = launch_bn_epilogue(x, r, a, bb)
    ref = epilogue_reference(x, mean, var, scale, bias, r, 1e-5, torch.float32).to(dtype)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    what = f"epilogue {path} {dtype} B={b} {hw}x{hw}x{ch}"
    check(out.is_contiguous(memory_format=torch.channels_last), f"{what}: lost channels_last")
    check(bool((diff <= 1e-5 + rtol * ref.float().abs()).all()),
          f"{what}: max err {err} beyond 1e-5 + {rtol}|ref|")
    nbytes = 3.0 * x.numel() * x.element_size() + 2 * 4 * ch
    bms, by = bound_ms(2.0 * x.numel(), nbytes)
    return {
        "dtype": str(dtype).split(".")[-1], "B": b, "H": hw, "C": ch,
        "max_abs_err": err, "max_rel_err": rel_error(out, ref), "input_copies": copies,
        "ms": device_ms(kernel), "event_ms": event_ms(kernel), "plain_ms": device_ms(plain),
        "bound_ms": bms, "bound_by": by,
    }


def ring_of(tensors, nbytes):
    """An endless cycle over copies of `tensors` (`nbytes` a copy; memory
    format kept) holding ROTATE_BYTES in all, at least two, so each call
    reads its inputs from HBM. Inputs under a MB are not copied: they stay
    in the L2 on the main paths too. Returns (cycle, number of copies)."""
    if nbytes < 2 ** 20:
        return itertools.repeat(tuple(tensors)), 1
    copies = max(2, -(-int(ROTATE_BYTES) // int(nbytes)))
    return itertools.cycle([tuple(t.clone() for t in tensors) for _ in range(copies)]), copies


def score_pool_bwd_case(hw, mined, means, sigmas, g, hub=False):
    """The feature gradient at the flagship train shapes: kernel vs plain,
    bitwise across two launches, timed on rotating inputs. `mined` gives g
    the train step's pattern: the mining mask (ops/pooling.py) leaves a
    sample's own class all T levels and every other prototype its top-1
    only, so the rest of g is exactly zero; otherwise g is dense. `hub`
    makes a sample's feature rows equal, so every prototype's top-T is the
    same T patches (ties to the lowest index): each of them gathers P
    entries, the other patches none."""
    import torch

    from mgproto_tpu_torch.ops.fused_scoring import (
        launch_score_pool, launch_score_pool_bwd, score_pool_bwd_plain,
    )
    from mgproto_tpu_torch.ops.gaussian import precompute_diag_gaussian

    b, t, d = TRAIN_BATCH, 20, 64
    c, k = means.shape[:2]
    msc, ivar, const = (x.contiguous() for x in precompute_diag_gaussian(means, sigmas, 1e-10))
    p = msc.shape[0]
    feat = torch.nn.functional.normalize(torch.randn(b, hw, d, generator=g), dim=-1).cuda()
    if hub:
        feat = feat[:, :1].expand(b, hw, d).contiguous()
    _, idx = launch_score_pool(feat, msc, ivar, const, t)
    if hub:
        check(bool((idx < t).all()), "score_pool_bwd hub: the top-T lists did not concentrate")
    cot = torch.randn(b, p, t, generator=g)
    if mined:
        labels = torch.randint(0, c, (b,), generator=g)
        own = (torch.arange(p)[None, :] // k) == labels[:, None]  # [B, P]
        live = own[:, :, None] | (torch.arange(t) == 0)[None, None, :]
        cot = cot * live
    cot = cot.cuda()
    out = launch_score_pool_bwd(cot, idx, feat, msc, ivar)
    again = launch_score_pool_bwd(cot, idx, feat, msc, ivar)
    ref = score_pool_bwd_plain(cot, idx, feat, msc, ivar)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    what = f"score_pool_bwd hw{hw} {'mined' if mined else 'dense'}{' hub' if hub else ''}"
    check(torch.isfinite(out).all() and out.shape == (b, hw, d), f"{what}: bad output")
    check(err <= BWD_RTOL * scale, f"{what}: max err {err} > {BWD_RTOL} x {scale}")
    check(torch.equal(out, again), f"{what}: two launches differ")
    nbytes = 4.0 * (2 * b * p * t + 2 * b * hw * d + 2 * p * d)
    ring, copies = ring_of((cot, idx, feat), 4.0 * (2 * b * p * t + b * hw * d))

    def kernel():
        c_, i_, f_ = next(ring)
        return launch_score_pool_bwd(c_, i_, f_, msc, ivar)

    def plain():
        c_, i_, f_ = next(ring)
        return score_pool_bwd_plain(c_, i_, f_, msc, ivar)

    live = int((cot != 0).sum())  # entries the kernel works on (zero g is skipped)
    bms, by = bound_ms(4.0 * live * d, nbytes)
    rec = {"g": "mined" if mined else "dense", "hub": hub, "B": b, "HW": hw, "P": p, "T": t, "d": d,
           "live_entries": live, "live_share": live / (b * p * t),
           "max_abs_err": err, "max_abs_plain": scale,
           "bitwise_repeat": True, "input_copies": copies,
           "ms": device_ms(kernel), "event_ms": event_ms(kernel), "plain_ms": device_ms(plain),
           "bound_ms": bms, "bound_by": by}
    emit("kernel", kernel="score_pool_bwd", **rec)
    return rec


def em_estep_case(name, x, means, sigmas, priors, timed=True):
    """The E-step over one slab of classes: kernel vs plain, bitwise across
    two launches, timed on rotating bank slabs. Returns the record and the
    kernel's outputs."""
    import torch

    from mgproto_tpu_torch.ops.em_kernels import _prepare, em_estep_stats_plain, launch_em_estep

    a, n, d = x.shape
    k = means.shape[1]
    msc, ivar, const = (t.contiguous() for t in _prepare(means, sigmas, priors, 1e-10))
    got = launch_em_estep(x, msc, ivar, const)
    again = launch_em_estep(x, msc, ivar, const)
    want = em_estep_stats_plain(x, means, sigmas, priors)
    torch.cuda.synchronize()
    ll_err = (got[0] - want[0]).abs().max().item()
    errs = [(o - r).abs().max().item() for o, r in zip(got[1:], want[1:])]
    scales = [r.abs().max().item() for r in want[1:]]
    what = f"em_estep {name}"
    check(all(torch.isfinite(o).all() for o in got), f"{what}: non-finite output")
    check(ll_err <= ESTEP_LL_ATOL, f"{what}: ll err {ll_err} > {ESTEP_LL_ATOL}")
    for stat, e, sc in zip(("s", "sx", "sxx"), errs, scales):
        check(e <= ESTEP_RTOL * sc, f"{what}: {stat} err {e} > {ESTEP_RTOL} x {sc}")
    check(all(torch.equal(p, q) for p, q in zip(got, again)), f"{what}: two launches differ")
    rec = {"case": name, "A": a, "N": n, "K": k, "d": d, "max_abs_err": max(errs),
           "ll_err": ll_err, "errs_s_sx_sxx": errs, "max_abs_plain_s_sx_sxx": scales,
           "bitwise_repeat": True}
    if timed:
        ring, copies = ring_of((x,), 4.0 * a * n * d)

        def kernel():
            return launch_em_estep(next(ring)[0], msc, ivar, const)

        def plain():
            return em_estep_stats_plain(next(ring)[0], means, sigmas, priors)

        # the work itself: the partial-statistics scratch is not counted
        flops = 8.0 * a * n * k * d  # two products for w, two for sx / sxx
        nbytes = 4.0 * (a * n * d + 2 * a * k * d + a * k) + 4.0 * (a + a * k + 2 * a * k * d)
        bms, by = bound_ms(flops, nbytes)
        rec.update(input_copies=copies, ms=device_ms(kernel), event_ms=event_ms(kernel),
                   plain_ms=device_ms(plain), bound_ms=bms, bound_by=by)
    emit("kernel", kernel="em_estep", **rec)
    return rec, got


def em_estep_cases(g):
    """The E-step at the train step's two widths: every class of a flagship
    bank (A = 200, the dense call the first EM round falls back to) and a
    compact slab of 80 of them gathered as core/em.py gathers it, which
    must give the same bits as those classes inside the A = 200 call; then
    the slab again with sigmas drawn in 0.3-0.5 (sharp responsibilities)."""
    import torch

    c, n, k, d = 200, 800, 10, 64
    x = torch.nn.functional.normalize(torch.randn(c, n, d, generator=g), dim=-1).cuda()
    means = torch.nn.functional.normalize(torch.rand(c, k, d, generator=g), dim=-1).cuda()
    sigmas = torch.full((c, k, d), 1.0 / (2 * torch.pi) ** 0.5).cuda()
    priors = torch.softmax(torch.randn(c, k, generator=g), -1).cuda()
    idx = torch.randperm(c, generator=g)[:TRAIN_BATCH].sort().values.cuda()
    dense, dense_out = em_estep_case("A=200", x, means, sigmas, priors)
    slab = [t[idx].contiguous() for t in (x, means, sigmas, priors)]
    compact, compact_out = em_estep_case("A=80", *slab)
    check(all(torch.equal(f[idx], s) for f, s in zip(dense_out, compact_out)),
          "em_estep: classes of the A=80 slab differ from the same classes in the A=200 call")
    compact["slab_independent"] = True
    sharp_sig = (0.3 + 0.2 * torch.rand(TRAIN_BATCH, k, d, generator=g)).cuda()
    sharp, _ = em_estep_case("A=80, sigma 0.3-0.5", slab[0], slab[1], sharp_sig, slab[3], timed=False)
    # the online plane's width: a consolidation batch of 16 samples dirties
    # at most 16 classes (online/consolidate.py)
    idx16 = idx[:ONLINE_WIDTH]
    online, online_out = em_estep_case(f"A={ONLINE_WIDTH}",
                                       *[t[idx16].contiguous() for t in (x, means, sigmas, priors)])
    check(all(torch.equal(f[idx16], s) for f, s in zip(dense_out, online_out)),
          f"em_estep: classes of the A={ONLINE_WIDTH} slab differ from the A=200 call's")
    online["slab_independent"] = True
    return compact, dense, sharp, online


# -------------------------------------------------------------------- serve
def serve_phase():
    import numpy as np
    import torch

    from mgproto_tpu_torch.config import Config
    from mgproto_tpu_torch.core.mgproto import build_mgproto
    from mgproto_tpu_torch.engine.eval import Evaluator
    from mgproto_tpu_torch.numerics import apply_numerics_policy
    from mgproto_tpu_torch.ops.fused_epilogue import fused_bn_epilogue
    from mgproto_tpu_torch.ops.fused_scoring import score_pool
    from mgproto_tpu_torch.serving.calibration import calibrate
    from mgproto_tpu_torch.serving.engine import ServingEngine

    cfg = Config()
    m = cfg.model
    model, gmm = build_mgproto(m, device="cuda", seed=0)
    ev = Evaluator(model, gmm, cfg, device="cuda")
    rng = np.random.default_rng(0)
    img = (m.img_size, m.img_size, 3)
    id_images = rng.normal(size=(16, *img)).astype(np.float32)
    cal = calibrate(ev, [id_images[:8], id_images[8:]], source="chip_smoke seeded ID images")
    engine = ServingEngine.from_live(ev, calibration=cal, buckets=(1, 2, 4, 8))
    warm = engine.warmup()
    check(not engine.gate.degraded, "engine degraded with a fresh calibration")

    valid = list(rng.normal(size=(19, *img)).astype(np.float32))
    payloads = valid[:10] + [np.zeros((m.img_size, m.img_size), np.float32)] + valid[10:]
    payloads.append(np.full(img, np.nan, np.float32))
    ids = [f"r{i:02d}" for i in range(len(payloads))]

    score_pool.launches = 0
    fused_bn_epilogue.launches = 0
    engine.dispatch_count = 0
    t0 = time.perf_counter()
    resps = engine.serve_all(payloads, request_ids=ids)
    serve_s = time.perf_counter() - t0
    launches = {"score_pool": score_pool.launches, "bn_epilogue": fused_bn_epilogue.launches}
    dispatches = engine.dispatch_count

    check([r.request_id for r in resps] == ids, "not every id answered exactly once")
    bad = {r.request_id: (r.outcome, r.reason) for r in resps if r.request_id in ("r10", ids[-1])}
    check(bad == {"r10": ("reject", "bad_shape"), ids[-1]: ("reject", "nonfinite")},
          f"bad payloads not rejected typed: {bad}")
    served = [r for r in resps if r.request_id not in bad]
    check(all(r.outcome in ("predict", "abstain") for r in served),
          f"valid payloads not served: {[(r.request_id, r.outcome, r.reason) for r in served]}; "
          f"last dispatch error: {engine.last_dispatch_error}")
    check(dispatches == 3, f"expected 3 dispatches (8 + 8 + 3), got {dispatches}")
    check(launches["score_pool"] == dispatches, f"score_pool launches {launches} per {dispatches}")
    check(launches["bn_epilogue"] == 16 * dispatches, f"epilogue launches {launches} per {dispatches}")

    # the same weights through the plain path on the CPU
    cpu_model, _ = build_mgproto(m, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    cpu_ev = Evaluator(cpu_model, gmm.to("cpu"), cfg, device="cpu")
    x = np.stack(valid)
    ref_logits = torch.cat([cpu_ev(x[i:i + 8]).logits for i in range(0, len(x), 8)]).numpy()
    ref_px = np.logaddexp.reduce(ref_logits.astype(np.float64), axis=-1)
    gpu_logits = torch.cat([ev(x[i:i + 8]).logits.cpu() for i in range(0, len(x), 8)]).numpy()
    check(np.isfinite(gpu_logits).all() and gpu_logits.shape == (19, m.num_classes), "bad served logits")
    logit_err = float(np.abs(gpu_logits - ref_logits).max())
    cpu_departure = None
    if logit_err > SERVE_ATOL:
        # In some processes the CPU's float32 forward has departed from the
        # math by 1.17e-3 while the card's had not (ROADMAP §C item 3). The
        # float64 forward of the same weights decides: the card is held to
        # it within SERVE_ATOL, and the CPU's departure is reported.
        exact = float64_logits(cpu_ev, x)
        card_exact = float(np.abs(gpu_logits - exact).max())
        if card_exact > SERVE_ATOL:
            raise SmokeFailure(f"served logits vs CPU plain path: {logit_err} > {SERVE_ATOL}, "
                               f"vs its float64 forward {card_exact}; "
                               + serve_mismatch_report(ev, cpu_ev, x, ref_logits, gpu_logits))
        cpu_departure = {"card_vs_cpu": logit_err, "card_vs_float64": card_exact,
                         "cpu_vs_float64": float(np.abs(ref_logits - exact).max())}
        ref_logits, logit_err = exact, card_exact
        ref_px = np.logaddexp.reduce(exact, axis=-1)
    px_err = float(np.abs(np.array([r.log_px for r in served]) - ref_px).max())
    srt = np.sort(ref_logits, axis=-1)
    clear = (srt[:, -1] - srt[:, -2]) > 2 * SERVE_ATOL
    pred_ok = bool((np.array([r.prediction for r in served]) == ref_logits.argmax(-1))[clear].all())
    check(px_err <= SERVE_ATOL, f"served log p(x) vs CPU plain path: {px_err} > {SERVE_ATOL}")
    check(pred_ok, "served predictions differ from the CPU plain path")

    # the tolerance must tell the policy's f32 from TF32: the same forward with
    # TF32 switched on (what PyTorch gives cuDNN convolutions by default)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = [ev(x[i:i + 8]) for i in range(0, len(x), 8)]
        torch.cuda.synchronize()
    finally:
        apply_numerics_policy()
    tf32_logit_err = float(np.abs(torch.cat([o.logits.cpu() for o in tf32]).numpy() - ref_logits).max())
    tf32_px_err = float(np.abs(torch.cat([o.log_px.cpu() for o in tf32]).numpy() - ref_px).max())
    check(min(tf32_logit_err, tf32_px_err) > SERVE_ATOL,
          f"TF32 scores pass the f32 tolerance {SERVE_ATOL}: logits {tf32_logit_err}, "
          f"log p(x) {tf32_px_err}")

    latency = {}
    for b in engine.buckets:
        batch = x[:b]
        engine._dispatch(batch)
        times = []
        for _ in range(10):
            t1 = time.perf_counter()
            engine._dispatch(batch)
            times.append((time.perf_counter() - t1) * 1e3)
        latency[str(b)] = {"median_ms": float(np.median(times)), "min_ms": float(min(times))}
    emit("serve", requests=len(payloads), dispatches=dispatches, launches=launches,
         outcomes={o: sum(r.outcome == o for r in resps) for o in ("predict", "abstain", "reject")},
         serve_all_s=serve_s, warmup=warm, logits_max_abs_err_vs_cpu=logit_err,
         log_px_max_abs_err_vs_cpu=px_err, tolerance=SERVE_ATOL,
         cpu_reference_departure=cpu_departure,
         tf32_logits_max_abs_err_vs_cpu=tf32_logit_err,
         tf32_log_px_max_abs_err_vs_cpu=tf32_px_err,
         dispatch_latency_host_ms=latency)
    profile_phase(engine, x[:8])
    return launches, dispatches


def float64_logits(cpu_ev, images):
    """Level-0 logits of `cpu_ev`'s model and GMM recomputed in float64 on
    the CPU (a copy of the model; the plain path throughout): the oracle
    that says which of two float32 forwards departs from the math."""
    import copy

    import torch

    from mgproto_tpu_torch.core.mgproto import GMMState, head_forward

    model = copy.deepcopy(cpu_ev.model).double()
    gmm = GMMState(*(t.double() if t.is_floating_point() else t for t in cpu_ev.gmm))
    with torch.inference_mode():
        x = torch.from_numpy(images).double().permute(0, 3, 1, 2)
        proto_map = model.add_on(model.features(x)).permute(0, 2, 3, 1)
        logits, _, _ = head_forward(proto_map, gmm, None, cpu_ev.cfg.model.mine_T)
    return logits[..., 0].numpy()


def serve_mismatch_report(ev, cpu_ev, x, ref_logits, gpu_logits):
    """Where a served forward departs from the CPU's (a failed serve check
    only): each batch's error, the card's forward run again, the CPU's
    forward run again, both held to the float64 forward of the worst batch,
    and the worst batch's error after each trunk stage and at the head's
    inputs."""
    import numpy as np
    import torch

    batches = [(i, min(i + 8, len(x))) for i in range(0, len(x), 8)]
    again = np.concatenate([ev(x[a:b]).logits.cpu().numpy() for a, b in batches])
    cpu_again = np.concatenate([cpu_ev(x[a:b]).logits.numpy() for a, b in batches])
    err = np.abs(gpu_logits - ref_logits)
    worst = max(range(len(batches)), key=lambda j: err[slice(*batches[j])].max())
    wa, wb = batches[worst]
    exact = float64_logits(cpu_ev, x[wa:wb])
    acts = {}
    names = ("features.layer1", "features.layer2", "features.layer3", "features.layer4",
             "add_on")
    hooks = [dict(e.model.named_modules())[n].register_forward_hook(
        lambda mod, inp, out, n=n: acts.setdefault(n, []).append(out.float().cpu()))
        for e in (ev, cpu_ev) for n in names]
    try:
        a, b = batches[worst]
        ev(x[a:b])
        cpu_ev(x[a:b])
    finally:
        for h in hooks:
            h.remove()
    row, col = np.unravel_index(err.argmax(), err.shape)
    return json.dumps({
        "batch_errors": [float(err[a:b].max()) for a, b in batches],
        "worst": {"row": int(row), "class": int(col), "card": float(gpu_logits[row, col]),
                  "cpu": float(ref_logits[row, col])},
        "card_again_vs_first": float(np.abs(again - gpu_logits).max()),
        "card_again_vs_cpu": float(np.abs(again - ref_logits).max()),
        "cpu_again_vs_first": float(np.abs(cpu_again - ref_logits).max()),
        "worst_batch_vs_float64": {
            "card": float(np.abs(gpu_logits[wa:wb] - exact).max()),
            "cpu": float(np.abs(ref_logits[wa:wb] - exact).max()),
            "cpu_again": float(np.abs(cpu_again[wa:wb] - exact).max())},
        "stages_of_worst_batch": {n: float((v[0] - v[1]).abs().max()) for n, v in acts.items()},
        "cudnn": [torch.backends.cudnn.version(), torch.backends.cudnn.allow_tf32,
                  torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic]})


KERNEL_FAMILIES = ("score_pool_bwd", "score_pool", "bn_epilogue", "em_estep")


def family(name):
    name = name.lower()
    for fam in KERNEL_FAMILIES:
        if fam in name:
            return fam
    # cuDNN/cuBLAS kernels: implicit-GEMM, FFT and weight/data-gradient engines
    if any(w in name for w in ("conv", "gemm", "xmma", "cudnn", "sm90", "wgrad", "dgrad",
                               "fft", "complex", "cutlass")):
        return "conv/gemm"
    return "memcpy" if "memcpy" in name else "other"


def device_breakdown(run, reps, trace=None):
    """Device time by kernel family over `reps` calls of `run`, and the
    device's idle share of that window (torch.profiler GPU activity events,
    overlapping spans merged). None when the profiler saw no device event.
    `trace`: a path the profile's chrome trace is written to."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if trace is not None:
        prof.export_chrome_trace(trace)
    spans, by_family, other = [], {}, {}
    for e in prof.events():
        # user annotations (e.g. the optimizer's step range) are drawn on the
        # GPU timeline too; they are not device work
        if e.device_type != torch.autograd.DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        fam = family(e.name)
        by_family[fam] = by_family.get(fam, 0.0) + (end - start) / 1e3
        if fam == "other":
            key = e.name[:80]
            ms, n = other.get(key, (0.0, 0))
            other[key] = (ms + (end - start) / 1e3, n + 1)
    if not spans:
        return None
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy, cur_s, cur_e = busy + cur_e - cur_s, s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    top_other = sorted(other.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "device_ms_per_call": {k: v / reps for k, v in sorted(by_family.items())},
        "other_top_ms_per_call": [[name, ms / reps, n / reps] for name, (ms, n) in top_other],
        "device_busy_ms_per_call": busy / reps / 1e3, "wall_ms_per_call": wall_us / reps / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
    }


def profile_phase(engine, images):
    """Device time by kernel family over 5 bucket-8 dispatches."""
    rec = device_breakdown(lambda: engine._dispatch(images), 5)
    if rec is None:
        emit("profile", path="serve", note="profiler recorded no device events: not measured")
        return
    emit("profile", path="serve", bucket=int(images.shape[0]), dispatches=5, **rec)


# -------------------------------------------------------------------- train
def clone_state(src, cfg):
    """A TrainState for `cfg` holding a copy of `src`'s weights, BatchNorm
    statistics, proxies, GMM, bank and step, with fresh optimizers."""
    import torch

    from mgproto_tpu_torch.core.memory import Memory
    from mgproto_tpu_torch.core.state import create_train_state

    dst = create_train_state(cfg, torch.Generator().manual_seed(0), src.gmm.means.device)
    dst.model.load_state_dict(src.model.state_dict())
    with torch.no_grad():
        if src.proxies is not None:
            dst.proxies.copy_(src.proxies)
        dst.gmm.means.copy_(src.gmm.means)
    dst.gmm = dst.gmm._replace(sigmas=src.gmm.sigmas.clone(), priors=src.gmm.priors.clone(),
                               keep=src.gmm.keep.clone())
    dst.memory = Memory(*(t.clone() for t in src.memory))
    dst.step = src.step
    return dst


def full_bank(m, seed):
    """A flagship memory bank on the card, every queue full of seeded unit
    vectors and marked updated (so the first EM call is dense)."""
    import torch

    from mgproto_tpu_torch.core.memory import Memory

    gen = torch.Generator(device="cuda").manual_seed(seed)
    c, cap, d = m.num_classes, m.mem_capacity, m.proto_dim
    bank = torch.randn(c, cap, d, generator=gen, device="cuda")
    return Memory(
        feats=torch.nn.functional.normalize(bank, dim=-1),
        length=torch.full((c,), cap, dtype=torch.int32, device="cuda"),
        cursor=torch.zeros(c, dtype=torch.int32, device="cuda"),
        updated=torch.ones(c, dtype=torch.bool, device="cuda"),
    )


def launch_counts():
    from mgproto_tpu_torch.ops.em_kernels import em_estep_stats
    from mgproto_tpu_torch.ops.fused_epilogue import fused_bn_epilogue
    from mgproto_tpu_torch.ops.fused_scoring import score_pool, score_pool_bwd

    return {"score_pool": score_pool.launches, "bn_epilogue": fused_bn_epilogue.launches,
            "score_pool_bwd": score_pool_bwd.launches, "em_estep": em_estep_stats.launches}


def reset_launch_counts():
    from mgproto_tpu_torch.ops.em_kernels import em_estep_stats
    from mgproto_tpu_torch.ops.fused_epilogue import fused_bn_epilogue
    from mgproto_tpu_torch.ops.fused_scoring import score_pool, score_pool_bwd

    for fn in (score_pool, fused_bn_epilogue, score_pool_bwd, em_estep_stats):
        fn.launches = 0


class Probe:
    """The activations at `names` of one model in its next forward, and
    their gradients in the backward after it."""

    def __init__(self, model, names=PROBES):
        mods = dict(model.named_modules())
        self.act, self.grad = {}, {}
        self.handles = [mods[name].register_forward_hook(self._hook(name)) for name in names]

    def _hook(self, name):
        def fwd(_mod, _inp, out):
            self.act[name] = out.detach().clone()
            out.register_hook(lambda g: self.grad.__setitem__(name, g.detach().clone()))
        return fwd

    def remove(self):
        for h in self.handles:
            h.remove()


def rel_norm(got, want):
    return ((got - want).norm() / want.norm()).item()


def route_features(probe):
    """The scored features [B, HW, d] of a route's first step: its add-on
    output, L2-normalized per patch as the head does."""
    from mgproto_tpu_torch.core.mgproto import l2_normalize

    x = probe.act["add_on"].permute(0, 2, 3, 1)
    return l2_normalize(x.reshape(x.shape[0], -1, x.shape[-1]).float()).contiguous()


def top_t_changed(probe, ref, gmm0, t_levels):
    """Pooled (sample, prototype) lists whose top-T indices differ between
    two routes' features, both scored by the plain pool (so only the
    features differ)."""
    from mgproto_tpu_torch.ops.fused_scoring import score_pool_plain

    a, b = (score_pool_plain(route_features(p), *gmm0, t_levels)[1] for p in (probe, ref))
    return int((a != b).any(-1).sum()), a.shape[0] * a.shape[1]


def forward_agreement(probe, gmm0, t_levels):
    """The score_pool kernel against its plain version on a route's own
    first-step features: the share of equal indices and the largest value
    difference."""
    from mgproto_tpu_torch.ops.fused_scoring import score_pool, score_pool_plain

    x = route_features(probe)
    vals, idx = score_pool(x, *gmm0, t_levels)
    pvals, pidx = score_pool_plain(x, *gmm0, t_levels)
    return (idx == pidx).float().mean().item(), (vals - pvals).abs().max().item()


def route_record(name, run, ref, gmm0, t_levels):
    """One route's first step (`run`: its metrics, probe, gradient, EM
    log-likelihood and priors) against the plain route's `ref`."""
    met, probe, grad = run["met"], run["probe"], run["grad"]
    changed, lists = top_t_changed(probe, ref["probe"], gmm0, t_levels)
    return {
        "route": name,
        "loss_abs_err": abs(met.loss.item() - ref["met"].loss.item()),
        "grad_rel_err": rel_norm(grad, ref["grad"]),
        "grad_rel_err_by_group": {
            group: rel_norm(grad[sl], ref["grad"][sl]) for group, sl in ref["groups"].items()
        },
        "em_ll_abs_err": abs(run["ll"] - ref["ll"]),
        "priors_max_abs_err": (run["priors"] - ref["priors"]).abs().max().item(),
        "em_compact_fallback": met.em_compact_fallback,
        "act_rel_err": {p: rel_norm(probe.act[p], ref["probe"].act[p]) for p in probe.act},
        "act_grad_rel_err": {p: rel_norm(probe.grad[p], ref["probe"].grad[p]) for p in probe.act},
        "top_t_lists_changed": changed, "top_t_lists": lists,
    }


def first_step_run(trainer, state, probe, met):
    """What route_record reads of a route's first step, taken right after it."""
    import torch

    return {"met": met, "probe": probe,
            "grad": torch.cat([p.grad.reshape(-1) for p in trainer.params(state)]),
            "ll": trainer.last_bank.em.log_likelihood.item(),
            "priors": state.gmm.priors.clone()}


def train_phase():
    """The flagship training step on the card; returns the launch counts of
    the driven run and its number of steps."""
    import dataclasses

    import numpy as np
    import torch

    from mgproto_tpu_torch.config import Config, DataConfig
    from mgproto_tpu_torch.engine.train import Trainer

    # f32 batches of seeded noise, no augmentation: the input phase drives
    # the uint8 wire and the augmentation tail
    cfg = Config(data=DataConfig(device_augment=False))
    m = cfg.model
    trainer = Trainer(cfg, steps_per_epoch=100, device="cuda")
    check(trainer.fused and trainer.em_cfg.max_active_classes == TRAIN_BATCH,
          "the flagship trainer did not resolve to the kernels and a compact width of 80")
    state = trainer.init_state(seed=0)
    c = m.num_classes
    state.memory = full_bank(m, seed=1)
    gmm0 = (state.gmm.means.detach().clone(), state.gmm.sigmas.clone())

    def route(plain):
        """A trainer with the epilogue kernel off, and a copy of the initial
        state; `plain` turns the scoring kernels and the E-step off too."""
        rcfg = cfg.replace(
            model=dataclasses.replace(m, fused_scoring=False if plain else None,
                                      fused_epilogue=False),
            em=dataclasses.replace(cfg.em, fused_estep=False if plain else None),
        )
        tr = Trainer(rcfg, steps_per_epoch=100, device="cuda")
        return tr, clone_state(state, rcfg)

    plain_trainer, plain_state = route(plain=True)
    floor_state = clone_state(state, plain_trainer.cfg)
    score_trainer, score_state = route(plain=False)
    check(score_trainer.fused and not plain_trainer.fused, "the routes did not resolve as asked")

    rng = np.random.default_rng(0)
    batches = [(rng.normal(size=(TRAIN_BATCH, m.img_size, m.img_size, 3)).astype(np.float32),
                rng.integers(0, c, size=TRAIN_BATCH)) for _ in range(TRAIN_STEPS + 1)]
    per_step = {"score_pool": 1, "bn_epilogue": 16, "score_pool_bwd": 1}
    step_s, losses, first = [], [], None
    torch.cuda.synchronize()
    reset_launch_counts()
    for i, (images, labels) in enumerate(batches[:TRAIN_STEPS]):
        means0 = state.gmm.means.detach().clone()
        probe = Probe(state.model) if i == 0 else None
        before = launch_counts()
        t0 = time.perf_counter()
        state, met = trainer.train_step(state, images, labels, use_mine=True, update_gmm=True)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        loss = met.loss.item()
        losses.append(loss)
        check(np.isfinite(loss) and not met.nonfinite, f"train step {i}: loss {loss}")
        want = dict(per_step, em_estep=cfg.em.num_em_loop)
        check(delta == want, f"train step {i}: launches {delta}, expected {want}")
        check(met.em_compact_fallback == (1 if i == 0 else 0),
              f"train step {i}: em_compact_fallback {met.em_compact_fallback}")
        if i == 0:
            probe.remove()
            check(met.em_active == c, f"first EM call touched {met.em_active} classes, not {c}")
            first = first_step_run(trainer, state, probe, met)
        else:
            untouched = torch.ones(c, dtype=torch.bool, device="cuda")
            untouched[torch.as_tensor(labels, device="cuda")] = False
            check(met.em_active == c - int(untouched.sum()), f"train step {i}: em_active {met.em_active}")
            check(torch.equal(state.gmm.means.detach()[untouched], means0[untouched]),
                  f"train step {i}: an untouched class's means moved")
    trunk0 = [p.detach().clone() for p in state.model.features.parameters()]
    before = launch_counts()
    state, met = trainer.train_step(state, *batches[TRAIN_STEPS], use_mine=True,
                                    update_gmm=True, warm=True)
    torch.cuda.synchronize()
    launches = launch_counts()
    delta = {k: v - before[k] for k, v in launches.items()}
    check(delta == dict(per_step, em_estep=cfg.em.num_em_loop), f"warm step: launches {delta}")
    check(np.isfinite(met.loss.item()), "warm step: non-finite loss")
    check(all(torch.equal(p.detach(), q) for p, q in zip(state.model.features.parameters(), trunk0)),
          "the warm step moved the trunk")

    # the first step again from the same state on the other routes
    images0, labels0 = batches[0]
    runs = {"kernel": first}
    for name, tr, st, imgs in (("plain", plain_trainer, plain_state, images0),
                               ("floor", plain_trainer, floor_state, images0 * np.float32(1 + 1e-7)),
                               ("scoring", score_trainer, score_state, images0)):
        probe = Probe(st.model)
        st, rmet = tr.train_step(st, imgs, labels0, use_mine=True, update_gmm=True)
        probe.remove()
        runs[name] = first_step_run(tr, st, probe, rmet)
    ref = runs.pop("plain")
    at, groups = 0, {}
    for group, ps in (("features", plain_state.model.features.parameters()),
                      ("add_on", plain_state.model.add_on.parameters()),
                      ("embedding", plain_state.model.embedding.parameters()),
                      ("proxies", [plain_state.proxies])):
        n = sum(p.numel() for p in ps)
        groups[group] = slice(at, at + n)
        at += n
    ref["groups"] = groups
    records = {name: route_record(name, run, ref, gmm0, m.mine_T) for name, run in runs.items()}
    agree, fwd_err = forward_agreement(runs["scoring"]["probe"], gmm0, m.mine_T)
    records["scoring"].update(index_agreement=agree, fwd_max_abs_err=fwd_err)
    check(fwd_err <= SCORE_ATOL, f"score_pool at the train step's features: max err {fwd_err}")
    pmet = ref["met"]
    check(pmet.em_compact_fallback == 1, "plain route: first EM call did not fall back")
    grad_floor = records["floor"]["grad_rel_err"]
    for name in ("kernel", "scoring"):
        rec = records[name]
        check(rec["em_compact_fallback"] == 1, f"{name} route: first EM call did not fall back")
        check(rec["loss_abs_err"] <= TRAIN_LOSS_RTOL * abs(pmet.loss.item()),
              f"{name} vs plain route: loss differs by {rec['loss_abs_err']}")
        check(rec["em_ll_abs_err"] <= TRAIN_LL_ATOL,
              f"{name} vs plain route: EM log-likelihood differs by {rec['em_ll_abs_err']}")
        check(rec["priors_max_abs_err"] <= TRAIN_PRIOR_ATOL,
              f"{name} vs plain route: priors differ by {rec['priors_max_abs_err']}")
    check(records["scoring"]["grad_rel_err"] <= TRAIN_SCORING_GRAD_RTOL,
          f"scoring vs plain route: trunk gradient rel err {records['scoring']['grad_rel_err']}")
    check(records["kernel"]["grad_rel_err"] <= TRAIN_GRAD_FLOOR_MULT * grad_floor,
          f"kernel vs plain route: trunk gradient rel err {records['kernel']['grad_rel_err']} "
          f"> {TRAIN_GRAD_FLOOR_MULT} x the floor {grad_floor}")

    timed = step_s[1:]
    med = float(np.median(timed))
    emit("train", batch=TRAIN_BATCH, steps=TRAIN_STEPS, warm_steps=1, losses=losses,
         launches=launches, step_s=step_s, step_s_median=med, step_s_min=float(min(timed)),
         img_per_s=TRAIN_BATCH / med, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         first_step_loss=pmet.loss.item(), first_step_em_ll=ref["ll"],
         tolerances={"loss_rtol": TRAIN_LOSS_RTOL, "scoring_grad_rtol": TRAIN_SCORING_GRAD_RTOL,
                     "grad_floor_mult": TRAIN_GRAD_FLOOR_MULT, "grad_floor": grad_floor,
                     "ll_atol": TRAIN_LL_ATOL, "prior_atol": TRAIN_PRIOR_ATOL})
    for name in ("kernel", "scoring", "floor"):
        emit("train_route", vs="plain", **records[name])
    del plain_state, plain_trainer, floor_state, score_state, score_trainer, first, runs, ref

    it = itertools.cycle(batches[1:TRAIN_STEPS])
    holder = [state]

    def one_step():
        holder[0], _ = trainer.train_step(holder[0], *next(it), use_mine=True, update_gmm=True)

    rec = device_breakdown(one_step, 3)
    if rec is None:
        emit("profile", path="train", note="profiler recorded no device events: not measured")
    else:
        emit("profile", path="train", batch=TRAIN_BATCH, steps=3, **rec)
    return launches, TRAIN_STEPS + 1


# ------------------------------------------------------ planner, telemetry
TELEMETRY_STEPS = 3  # steps of each run of the telemetry cost check
# the same candidate's program peak measured twice, the allocator emptied
# and its peak reset between: cuDNN's workspace may be chosen anew
PLANNER_SPREAD = 0.05
PLANNER_PAIR_DIR = os.path.join(HERE, "build", "planner_pair")
PLANNER_PAIR_BATCH = 40  # a rank's rows: candidates at global 80 / 160 / 320
PLANNER_PAIR_WAIT_S = 600  # a child waits this long for the go file


def planner_pair_start():
    """Two gloo ranks on cuda:0 (`chip_smoke.py --planner-child`), started
    with the planner phase; each plans once the go file exists, after the
    in-process planner has given its memory back."""
    import shutil

    shutil.rmtree(PLANNER_PAIR_DIR, ignore_errors=True)
    os.makedirs(PLANNER_PAIR_DIR)
    port, procs = free_port(), []
    for r in range(DIST_RANKS):
        env = dict(os.environ, PYTHONUNBUFFERED="1", RANK=str(r), WORLD_SIZE=str(DIST_RANKS),
                   LOCAL_RANK="0", MASTER_ADDR="localhost", MASTER_PORT=str(port))
        log = open(os.path.join(PLANNER_PAIR_DIR, f"rank{r}.log"), "w")
        procs.append(Started(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--planner-child", PLANNER_PAIR_DIR],
            cwd=HERE, stdout=log, stderr=subprocess.STDOUT, env=env), log.name))
    return procs


def planner_child(argv):
    """`python3 chip_smoke.py --planner-child DIR`: one rank of the planner
    pair. Joins the gloo group, waits for DIR/go.json (each rank's budget),
    then runs `cli.train`'s planning step on the flagship at
    PLANNER_PAIR_BATCH rows a rank with the default measure on the card,
    and writes DIR/rank<r>.json: the outcome, the plan, the per-rank batch
    and this rank's own program peaks, taken before the ranks agree."""
    import dataclasses

    from mgproto_tpu_torch.cli import train
    from mgproto_tpu_torch.config import Config
    from mgproto_tpu_torch.parallel.mesh import initialize_distributed, world
    from mgproto_tpu_torch.perf import planner

    initialize_distributed(backend=DIST_BACKEND, device="cuda:0", strict=True,
                           timeout_s=DIST_CHILD_TIMEOUT_S)
    rank = world()[0]
    go = os.path.join(argv[0], "go.json")
    deadline = time.time() + PLANNER_PAIR_WAIT_S
    while not os.path.exists(go):
        check(time.time() < deadline, f"planner pair: {go} did not appear")
        time.sleep(0.2)
    with open(go) as f:
        os.environ[planner.BUDGET_ENV] = str(json.load(f)["budgets"][rank])
    os.environ[planner.MARGIN_ENV] = "0"
    own, measure = {}, planner.measure_candidate

    def recorded(base_cfg, cand, *a, **k):
        peak, detail = measure(base_cfg, cand, *a, **k)
        own[f"{cand.batch}:{'+'.join(cand.remat_stages)}"] = detail["program_peak_bytes"]
        return peak, detail

    planner.measure_candidate = recorded
    cfg = Config()
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, train_batch_size=PLANNER_PAIR_BATCH))
    t0 = time.perf_counter()
    cfg, outcome, plan = train._autotune(cfg, True, None, DIST_RANKS, "cuda:0", lambda s: None)
    with open(os.path.join(argv[0], f"rank{rank}.json"), "w") as f:
        json.dump({"outcome": outcome.to_meta(), "plan": plan, "own_peaks": own,
                   "rank_batch": cfg.data.train_batch_size,
                   "seconds": time.perf_counter() - t0}, f)
    return 0


def planner_pair_check(smi, pair, solo):
    """The pair plans one batch for the world: rank 1's budget lies between
    the in-process planner's program peaks at a rank's b80 and b160 (so
    the global b320 without remat is over it on rank 1 only), rank 0's is
    the card's total. Both ranks choose the same plan and rank batch, both
    plan under rank 1's budget, each candidate's peak is the larger of the
    two ranks' own, and a candidate that fits rank 0 alone is rejected."""
    import torch

    from mgproto_tpu_torch.config import Config
    from mgproto_tpu_torch.perf import planner

    img_size = Config().model.img_size
    by = {(r.candidate.batch, r.candidate.remat_stages): r.detail["program_peak_bytes"]
          for r in solo.reports if not r.error and not r.candidate.prefetch_depth}
    low, high = by[(2 * PLANNER_PAIR_BATCH, ())], by[(4 * PLANNER_PAIR_BATCH, ())]
    budgets = [int(torch.cuda.mem_get_info()[1]), (low + high) // 2]
    with open(os.path.join(PLANNER_PAIR_DIR, "go.json.tmp"), "w") as f:
        json.dump({"budgets": budgets}, f)
    os.replace(os.path.join(PLANNER_PAIR_DIR, "go.json.tmp"),
               os.path.join(PLANNER_PAIR_DIR, "go.json"))
    for r, p in enumerate(pair):
        code, _ = p.wait(timeout=PLANNER_PAIR_WAIT_S)
        check(code == 0, f"planner pair rank {r} exited {code}:\n" + open(p.out).read()[-3000:])
    got = [json.load(open(os.path.join(PLANNER_PAIR_DIR, f"rank{r}.json")))
           for r in range(DIST_RANKS)]
    check(got[0]["plan"] is not None and got[0]["plan"] == got[1]["plan"]
          and got[0]["rank_batch"] == got[1]["rank_batch"],
          f"planner pair: the ranks chose {[g['plan'] for g in got]}")
    check(all(g["outcome"]["budget_bytes"] == budgets[1] for g in got),
          f"planner pair: budgets {[g['outcome']['budget_bytes'] for g in got]}")
    solo_fits = []
    for row0, row1 in zip(got[0]["outcome"]["candidates"], got[1]["outcome"]["candidates"]):
        check(row0["fits"] == row1["fits"] and row0["peak_bytes"] == row1["peak_bytes"],
              f"planner pair: {row0} vs {row1}")
        key = f"{row0['batch']}:{'+'.join(row0['remat_stages'])}"
        if "error" in row0:
            continue
        own = [g["own_peaks"][key] for g in got]
        headroom = row0["prefetch_depth"] * planner.batch_bytes(
            row0["batch"] // DIST_RANKS, img_size, row0["device_augment"])
        check(row0["peak_bytes"] == max(own) + headroom,
              f"planner pair: {row0['name']} peak {row0['peak_bytes']} vs own {own}")
        if own[0] + headroom <= budgets[0] and not row0["fits"]:
            solo_fits.append(row0["name"])
    check(solo_fits, "planner pair: no candidate that fits rank 0 alone was rejected")
    emit("planner_pair", card=smi, ranks=DIST_RANKS, backend=DIST_BACKEND,
         rank_batch=got[0]["rank_batch"], plan=got[0]["plan"]["name"], budgets=budgets,
         rejected_for_rank_1=solo_fits,
         own_peaks=[g["own_peaks"] for g in got],
         agreed=[{k: c.get(k) for k in ("name", "peak_bytes", "fits", "error")}
                 for c in got[0]["outcome"]["candidates"]],
         seconds=[g["seconds"] for g in got],
         note="two ranks share cuda:0 and measure at the same time; each rank's own peaks "
              "are its process's")


def planner_phase(smi):
    """The memory planner at the flagship (perf/planner.py), in process:
    every candidate of `candidate_plans` (batches 80 / 160 / 320, remat
    none and layer1, prefetch 2 and 0, the uint8 wire) measured by one
    step on the card from a full seeded bank, with its peak, its seconds
    and its launches (1 / 16 / 1 / 3 a measured program, 19 epilogues with
    layer1's 3 blocks recomputed; the prefetch variants are arithmetic),
    one candidate measured twice for the spread,
    then `autotune` under a budget halfway between the largest peak below
    the top batch and the smallest at it, so rejections are exercised
    without running out of memory. Then the planner pair: two gloo ranks
    on the card plan one world's batch through `cli.train`'s planning step
    with their own budgets (`planner_pair_check`). Returns the launch
    counts of the in-process measures."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    pair = planner_pair_start()
    try:
        launches = planner_in_process(smi, t_phase)
        planner_pair_check(smi, pair, launches.pop("outcome"))
    finally:
        for p in pair:
            if p.proc.poll() is None:
                p.proc.kill()
                p.proc.wait()
    return launches


def planner_in_process(smi, t_phase):
    """`planner_phase`'s in-process part; returns the launch counts of the
    measures and, under "outcome", the outcome under the card's total."""
    import dataclasses
    import gc

    import torch

    from mgproto_tpu_torch.config import Config
    from mgproto_tpu_torch.perf import planner

    cfg = Config()
    cands = planner.candidate_plans(cfg, device="cuda")
    measure = planner.make_cached_measure(cfg, device="cuda")
    launches, per_program = {}, {}
    reset_launch_counts()

    def counted(cand):
        before = launch_counts()
        out = measure(cand)
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        if any(delta.values()):
            per_program[cand.name] = delta
        return out

    total = torch.cuda.mem_get_info()[1]
    outcome = planner.HBMPlanner(budget_bytes=total, margin=0.0, measure=counted).plan(cfg, cands)
    launches = launch_counts()
    rows = [{"name": r.candidate.name, "peak_bytes": r.peak_bytes, "fits": r.fits,
             "program_peak_bytes": r.detail.get("program_peak_bytes"),
             "prefetch_headroom_bytes": r.detail.get("prefetch_headroom_bytes"),
             "measure_s": r.detail.get("measure_s"), "error": r.error or None}
            for r in outcome.reports]
    check(all(r.fits or r.error for r in outcome.reports),
          f"a flagship candidate neither measured within the card nor rejected: {rows}")
    measured = [r for r in outcome.reports if not r.error]
    check(len(measured) >= 2, f"fewer than two flagship candidates measured: {rows}")
    # a rematted stage's blocks run their tails again in the recompute
    stage_blocks = {f"layer{i + 1}": blocks for i, (blocks, _, _) in enumerate(R34_STAGES)}
    by_name = {r.candidate.name: r for r in measured}
    for name, delta in per_program.items():
        cand, steps = by_name[name].candidate, by_name[name].detail["steps"]
        want = {"score_pool": 1, "score_pool_bwd": 1, "em_estep": cfg.em.num_em_loop,
                "bn_epilogue": 16 + sum(stage_blocks[s] for s in cand.remat_stages)}
        check(delta == {k: v * steps for k, v in want.items()},
              f"planner measure of {name}: launches {delta}, expected {want} a step")
    programs = len({(r.candidate.batch, r.candidate.remat_stages) for r in outcome.reports})
    check(len(per_program) == programs,
          f"{len(per_program)} measured steps for {programs} programs (prefetch is arithmetic)")
    # the spread: the first candidate's program again, the allocator reset
    first = cands[0]
    again, again_detail = planner.measure_candidate(
        cfg, dataclasses.replace(first, prefetch_depth=0), device="cuda")
    first_peak = next(r for r in outcome.reports if r.candidate == first).detail[
        "program_peak_bytes"]
    spread = abs(again - first_peak) / max(again, first_peak)
    check(spread <= PLANNER_SPREAD, f"{first.name} measured twice: {first_peak} and {again} B")
    # a budget between the largest peak below the top batch and the
    # smallest at it: every top-batch candidate is rejected by the budget,
    # not by the card
    top = max(r.candidate.batch for r in measured)
    below = max((r.peak_bytes for r in measured if r.candidate.batch < top), default=0)
    above = min(r.peak_bytes for r in measured if r.candidate.batch == top)
    peaks = sorted({r.peak_bytes for r in measured})
    check(len(peaks) >= 2, f"the measured peaks are not distinct: {rows}")
    # where remat brings the top batch under a smaller one's peak: between
    # the two largest peaks
    budget = (below + above) // 2 if 0 < below < above else (peaks[-2] + peaks[-1]) // 2
    cfg2, tuned = planner.autotune(cfg, budget_bytes=budget, margin=0.0, candidates=cands,
                                   measure=counted)
    check(tuned.chosen is not None and tuned.chosen.peak_bytes <= budget and tuned.rejected >= 1
          and all(not r.fits for r in tuned.reports if r.peak_bytes > budget),
          f"autotune under {budget} B: {tuned.to_meta()}")
    check(cfg2.data.train_batch_size == tuned.chosen.candidate.batch,
          "autotune did not apply the chosen batch")
    del measure
    gc.collect()
    torch.cuda.empty_cache()
    emit("planner", card=smi, device_total_bytes=total, candidates=rows,
         launches_per_program=per_program, launches=launches,
         measure_s=sum({(r.candidate.batch, r.candidate.remat_stages): r.detail["measure_s"]
                        for r in measured}.values()),
         spread={"candidate": first.name, "program_peak_bytes": [first_peak, again],
                 "relative": spread, "limit": PLANNER_SPREAD,
                 "seconds": again_detail["measure_s"]},
         budget={"bytes": budget, "chosen": tuned.chosen.candidate.name,
                 "rejected": tuned.rejected},
         state_bytes_per_chip=planner.state_bytes_per_chip(cfg),
         seconds=time.perf_counter() - t_phase)
    return dict(launches, outcome=outcome)


def telemetry_cost_check(smi):
    """Telemetry costs the step nothing: the flagship at batch 80 from two
    clones of one seeded state with a full bank, TELEMETRY_STEPS steps of
    `train_epoch` with a StepMonitor and without (cuDNN deterministic): the
    same launches (1 / 16 / 1 / 3 a step), the states bit-equal, the step
    times side by side."""
    import numpy as np
    import torch

    from mgproto_tpu_torch.config import Config, DataConfig
    from mgproto_tpu_torch.engine.train import Trainer
    from mgproto_tpu_torch.perf.planner import ThrowawayState
    from mgproto_tpu_torch.telemetry import MetricRegistry, StepMonitor

    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        cfg = Config(data=DataConfig(device_augment=False))
        base = ThrowawayState(cfg, "cuda", seed=0)
        rng = np.random.default_rng(17)
        batches = [(rng.normal(size=(TRAIN_BATCH, 224, 224, 3)).astype(np.float32),
                    rng.integers(0, cfg.model.num_classes, size=TRAIN_BATCH))
                   for _ in range(TELEMETRY_STEPS)]
        runs = {}
        for on in (False, True, False, True):  # off, on, off, on: compare within one call
            trainer = Trainer(cfg, steps_per_epoch=100, device="cuda")
            state = base.clone(cfg)
            reg = MetricRegistry()
            monitor = StepMonitor(registry=reg).watch(trainer.cold_paths.total) if on else None
            torch.cuda.synchronize()
            reset_launch_counts()
            state, _ = trainer.train_epoch(state, batches, 0, monitor=monitor,
                                           flags={"warm": False, "use_mine": True,
                                                  "update_gmm": True})
            torch.cuda.synchronize()
            key = "on" if on else "off"
            run = runs.setdefault(key, {"step_s": [], "launches": launch_counts()})
            run["step_s"].append([r.step_s for r in trainer.step_log])
            run["state"] = [t.detach().clone() for t in (*state.model.state_dict().values(),
                                                         *state.gmm, *state.memory)]
            if on:
                snap = reg.snapshot()
                run["monitor"] = {k: snap[k]["series"][0]["value"] for k in
                                  ("steps_total", "images_total", "host_transfer_bytes_total",
                                   "jit_recompiles_total")}
            del state, trainer
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    want = {"score_pool": 1, "bn_epilogue": 16, "score_pool_bwd": 1, "em_estep": 3}
    for key, run in runs.items():
        check(run["launches"] == {k: v * TELEMETRY_STEPS for k, v in want.items()},
              f"telemetry {key}: launches {run['launches']} over {TELEMETRY_STEPS} steps")
    equal = all(torch.equal(a, b) for a, b in zip(runs["on"]["state"], runs["off"]["state"]))
    check(equal, "the state after the steps differs with telemetry on")
    mon = runs["on"]["monitor"]
    check(mon["steps_total"] == TELEMETRY_STEPS and mon["images_total"] ==
          TELEMETRY_STEPS * TRAIN_BATCH and mon["jit_recompiles_total"] == 1,
          f"the monitor counted {mon}")
    emit("telemetry_cost", card=smi, steps=TELEMETRY_STEPS, batch=TRAIN_BATCH,
         launches_per_step=want, state_bit_equal=equal, monitor=mon,
         step_s={k: run["step_s"] for k, run in runs.items()},
         median_step_s={k: float(np.median([s for r in run["step_s"] for s in r[1:]]))
                        for k, run in runs.items()})


# -------------------------------------------------------------------- input
def write_jpeg_tree(root, classes, per_class, hw, seed=0):
    """`classes` folders of `per_class` JPEGs (quality 90) at hw = (H, W):
    smooth seeded content, a bilinear upsample of a 6 x 8 grid of random
    colours, as CUB's photographs are smooth at 8 x 8 JPEG blocks."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = hw
    for c in range(classes):
        cdir = os.path.join(root, f"{c:03d}.class")
        os.makedirs(cdir, exist_ok=True)
        for i in range(per_class):
            coarse = Image.fromarray(rng.integers(0, 256, size=(6, 8, 3), dtype=np.uint8))
            coarse.resize((w, h), Image.BILINEAR).save(os.path.join(cdir, f"{i}.jpg"), quality=90)


def input_config(root, batch, workers, model=None):
    """The input phase's Config: the folder as the train, push and test
    directories, the process backend, the uint8 wire, mining and EM on from
    epoch 0."""
    from mgproto_tpu_torch.config import Config, DataConfig, ModelConfig, ScheduleConfig

    return Config(
        model=model if model is not None else ModelConfig(),
        data=DataConfig(train_dir=root, test_dir=root, train_push_dir=root,
                        train_batch_size=batch, test_batch_size=batch,
                        train_push_batch_size=batch, num_workers=workers,
                        worker_backend="process", device_augment=True),
        schedule=ScheduleConfig(num_warm_epochs=0, mine_start=0, update_gmm_start=0),
    )


def batch_digest(batches):
    """sha256 of the uint8 bytes, labels, ids and seeds of host batches."""
    import hashlib

    h = hashlib.sha256()
    for batch in batches:
        for a in batch:
            h.update(a.dtype.str.encode())
            h.update(a.tobytes())
    return h.hexdigest()


def first_batches(loader, n, epoch=0):
    """The first `n` batches of `epoch` (the loader's epoch counter is set
    back, so the same batches come again on a second call)."""
    loader.epoch = epoch
    out = []
    for batch in loader:
        out.append(batch)
        if len(out) == n:
            break
    return out


def loader_determinism(cfg, device):
    """Two passes over epoch 0's first two batches of build_pipelines'
    train loader (process backend, shared memory), and the thread backend's,
    by sha256. Returns the loaders and the record."""
    import dataclasses

    from mgproto_tpu_torch.data import build_pipelines

    loaders = build_pipelines(cfg, device=device)
    thread_cfg = cfg.replace(data=dataclasses.replace(cfg.data, worker_backend="thread"))
    thread = build_pipelines(thread_cfg, device=device)
    train = loaders[0]
    t0 = time.perf_counter()
    first = first_batches(train, 2)
    first_s = time.perf_counter() - t0
    digests = [batch_digest(first), batch_digest(first_batches(train, 2)),
               batch_digest(first_batches(thread[0], 2))]
    for dl in (*thread[:3], *thread[3]):
        dl.close()
    check(train.with_seeds and train.worker_backend == "process",
          "the train loader is not the process backend on the uint8 wire with seeds")
    check(first[0][0].dtype.name == "uint8" and first[0][3].dtype.name == "uint32",
          f"train batches are {first[0][0].dtype} with {first[0][3].dtype} seeds")
    check(digests[0] == digests[1], "two passes over epoch 0's first batches differ")
    check(digests[0] == digests[2], "the thread and process backends' batches differ")
    return loaders, first, {"sha256": digests[0], "passes_equal": True,
                            "thread_equals_process": True, "first_two_batches_s": first_s}


def uint8_route_check(cfg, state, batch, cpu_images, device):
    """The first step from `state` on the uint8 route (the seeds' draws, the
    tail on `device`) against the same batch augmented on the CPU
    (`cpu_images`, f32) on a trainer with augmentation off."""
    import dataclasses

    import numpy as np

    from mgproto_tpu_torch.engine.train import Trainer

    images, labels, _, seeds = batch
    f32_cfg = cfg.replace(data=dataclasses.replace(cfg.data, device_augment=False))
    runs = {}
    for name, rcfg, args in (("uint8", cfg, (images, labels)), ("f32", f32_cfg, (cpu_images, labels))):
        tr = Trainer(rcfg, steps_per_epoch=10, device=device)
        st = clone_state(state, rcfg)
        _, met = tr.train_step(st, *args, use_mine=True, update_gmm=True,
                               seeds=seeds if name == "uint8" else None)
        runs[name] = met.loss.item()
        del st, tr
    err = abs(runs["uint8"] - runs["f32"])
    check(all(np.isfinite(v) for v in runs.values()), f"uint8 route: non-finite loss {runs}")
    check(err <= TRAIN_LOSS_RTOL * abs(runs["f32"]),
          f"uint8 route vs CPU-augmented f32 route: loss differs by {err} ({runs})")
    return {"loss_uint8": runs["uint8"], "loss_f32_cpu_augmented": runs["f32"], "loss_abs_err": err,
            "loss_rtol": TRAIN_LOSS_RTOL}


def h2d_copies(trainers, batches, reps=5):
    """Host-to-device copy time of one batch per wire, alone on the card:
    `put_batch`'s events around its copies on the copy stream, median of
    `reps` puts after one that warms the pinned and device caches. Each put
    is read and freed before the next, so its blocks are reused and no
    allocation falls between the events (pinning is host work before the
    first)."""
    import numpy as np

    out = {}
    for name, trainer in trainers.items():
        ms = []
        for i in range(reps + 1):
            put = trainer.put_batch(batches[name])
            ms.append(put.copy_ms())
            nbytes = put.h2d_bytes
            del put
        med = float(np.median(ms[1:]))
        out[name] = {"bytes": nbytes, "ms": med, "gb_s": nbytes / med / 1e6,
                     "share_of_pcie": nbytes / med / 1e-3 / PCIE_BYTES_S, "ms_all": ms}
    return out


# ----------------------------------------------------------------- observatory
OBS_DIR = os.path.join(HERE, "build", "obs_phase")
OBS_WINDOW = (2, 4)  # the profiler window's step range over the input epoch
OBS_COST_BATCH = 8  # the batch the cost counter is held CPU vs card at
OBS_BUSY_RTOL = 0.10  # the window's device busy vs device_breakdown's, a step
CLI_PROFILE_STEPS = "2:4"  # 11 (a)'s --profile_steps
OBS_REQTRACE_REQUESTS = 2000  # requests of the request tracer's cost loop
# the CUDA kernels one launch of each wrapper runs (the backward's compact
# and accumulate passes, the E-step's partial and combine kernels)
KERNELS_PER_LAUNCH = {"score_pool": 1, "bn_epilogue": 1, "score_pool_bwd": 2, "em_estep": 2}
# each kernel's stall bucket: its bound in PERF.md §6
KERNEL_BUCKETS = {"score_pool": "mxu_busy", "bn_epilogue": "hbm_bound",
                  "score_pool_bwd": "hbm_bound", "em_estep": "hbm_bound"}


def kernel_events(events):
    """The port's kernels' device events in a trace, by kernel family."""
    from mgproto_tpu_torch.obs.stall import device_events

    out = dict.fromkeys(KERNEL_FAMILIES, 0)
    for e in device_events(events):
        fam = family(e["name"])
        if fam in out:
            out[fam] += 1
    return out


def obs_cost_check(cfg):
    """The cost counter on the card against the CPU for the same config at
    OBS_COST_BATCH (the same FLOPs and bytes, the kernels' rows equal), and
    the card's count of one step at the input epoch's batch. Returns that
    count and the comparison's record."""
    from mgproto_tpu_torch.obs.stall import step_costs

    t0 = time.perf_counter()
    card = step_costs(cfg, batch=OBS_COST_BATCH, device="cuda")
    cpu = step_costs(cfg, batch=OBS_COST_BATCH, device="cpu")
    keys = ("flops", "raw_bytes", "fused_bytes", "programs", "kernels")
    diff = {k: (card[k], cpu[k]) for k in keys if card[k] != cpu[k]}
    rows = {n: (card["rows"].get(n), cpu["rows"].get(n))
            for n in set(card["rows"]) | set(cpu["rows"])
            if card["rows"].get(n) != cpu["rows"].get(n)}
    check(not diff, f"the cost counter's card and CPU counts differ: {diff}; rows {rows}")
    full = step_costs(cfg, device="cuda")
    return full, {"batch": OBS_COST_BATCH, "equal_on_cpu_and_card": True,
                  "flops": card["flops"], "raw_bytes": card["raw_bytes"],
                  "fused_bytes": card["fused_bytes"], "kernels": card["kernels"],
                  "seconds": time.perf_counter() - t0}


def obs_window_report(window, trainer, launches, steps, costs, cfg, out):
    """(a): the window's capture over the input epoch: every kernel's device
    events at the epoch's launches a step times its CUDA kernels a launch,
    each in its bucket, and its stall report (fractions summing to 1, the
    device span plus the host wait, measured MFU), written to `out`."""
    from mgproto_tpu_torch.obs import stall

    (cap,) = window.captures
    check(not cap["fallback"] and cap["steps"] == OBS_WINDOW[1] - OBS_WINDOW[0]
          and cap["device_events"] > 0, f"(a) the window's capture: {cap}")
    t0 = time.perf_counter()
    events = stall.load_chrome_trace(cap["dir"])
    load_s = time.perf_counter() - t0
    counts = kernel_events(events)
    want = {k: cap["steps"] * launches[k] // steps * KERNELS_PER_LAUNCH[k] for k in counts}
    check(counts == want, f"(a) kernel events in the window {counts}, expected {want}")
    buckets = {}
    for e in stall.device_events(events):
        fam = family(e["name"])
        if fam in KERNEL_BUCKETS:
            buckets.setdefault(fam, set()).add(stall.classify_op(e["name"]))
    check(buckets == {k: {v} for k, v in KERNEL_BUCKETS.items()},
          f"(a) the kernels' stall buckets: {buckets}")
    first = cap["step"]  # the window's steps, by their index in the epoch
    host_wait = sum(r.wait_s for r in trainer.step_log[first:first + cap["steps"]])
    peak = stall.default_peak_flops(cfg.model.compute_dtype)
    rep = stall.finish_report(
        stall.attribute_trace(events, host_infeed_s=host_wait),
        flops=costs["flops"] * cap["steps"], peak_flops=peak,
        extra={"trace": os.path.relpath(cap["trace"], HERE), "steps": cap["steps"],
               "batch": TRAIN_BATCH, "compute_dtype": cfg.model.compute_dtype,
               "byte_source": "counted_raw", "bytes_accessed": costs["raw_bytes"] * cap["steps"],
               "top_byte_movers": stall.top_byte_movers_from_trace(events, top_n=8)})
    # no fallback on the card: a report that took the cost path fails here
    check(rep["source"] == "trace" and rep["device_lane"]["rule"] == "cuda_device_streams_merged",
          f"(a) the stall report did not attribute the device trace: {rep['source']}")
    check(abs(rep["fraction_sum"] - 1.0) <= 1e-4, f"(a) fractions sum to {rep['fraction_sum']}")
    check(abs(rep["step_time_s"] - rep["span_s"] - host_wait) <= 1e-9 * rep["step_time_s"] + 1e-12,
          "(a) the report's step time is not the device span plus the host wait")
    with open(out, "w") as f:
        f.write(json.dumps(rep, sort_keys=True) + "\n")
    return rep, {"capture_s": cap["capture_s"], "export_s": cap["export_s"],
                 "trace_mb": cap["trace_bytes"] / 1e6, "device_events": cap["device_events"],
                 "load_s": load_s, "kernel_events": counts, "host_wait_s": host_wait}


def obs_anomaly_check(trainer, state, monitor, batch):
    """(b): a recompile-triggered capture: one step at another batch shape
    (a cold path the monitor counts) between two at the epoch's; the window
    opens after the cold step and holds the next step's device events."""
    from mgproto_tpu_torch.obs.profiler import ProfilerWindow, Triggers

    half = tuple(t[: TRAIN_BATCH // 2] if t is not None else None for t in batch)
    monitor.check_recompiles()  # the window's baseline: the count so far
    window = ProfilerWindow(os.path.join(OBS_DIR, "anomaly"), on_anomaly=True, capture_steps=1,
                            monitor=monitor, triggers=Triggers(min_steps=1000), device="cuda")
    state, _ = trainer.train_epoch(state, [batch, half, batch], 1, monitor=monitor, window=window)
    window.close()
    check([(c["reason"], c["step"]) for c in window.captures] == [("recompile", 2)],
          f"(b) anomaly captures {window.captures}")
    cap = window.captures[0]
    check(os.path.isdir(cap["dir"]) and cap["device_events"] > 0,
          f"(b) the anomaly capture holds no device events: {cap}")
    return state, {"reason": cap["reason"], "step": cap["step"], "dir": os.path.relpath(
        cap["dir"], HERE), "device_events": cap["device_events"],
        "kernel_events": kernel_events(json.load(open(cap["trace"]))["traceEvents"])}


def obs_gates_check(telem_dir, report_path):
    """(e): the run's telemetry directory with the stall report in it:
    `summarize` shows the perf section; `check --stall-report R
    --stall-baseline R` exits 0."""
    from mgproto_tpu_torch.cli import telemetry as cli_telemetry

    code, text = captured(cli_telemetry.main, ["summarize", telem_dir])
    check(code is None and "perf (stall attribution" in text and "byte_mover_1" in text,
          f"(e) summarize shows no perf section:\n{text[-2000:]}")
    ccode, ctext = captured(cli_telemetry.check_main, ["--stall-report", report_path,
                                                       "--stall-baseline", report_path])
    check(ccode == 0, f"(e) check --stall-report against itself exited {ccode}:\n{ctext}")
    return {"summarize_perf_section": True, "stall_check_exit": ccode}


def input_phase(smi):
    """The training input path on the card; returns the launch counts of the
    loader-fed epoch and its number of steps."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from mgproto_tpu_torch import native
    from mgproto_tpu_torch.engine.train import Trainer
    from mgproto_tpu_torch.obs.profiler import ProfilerWindow
    from mgproto_tpu_torch.ops.augment import augment_draws, augment_tail
    from mgproto_tpu_torch.telemetry import make_session
    from mgproto_tpu_torch.utils.images import IMAGENET_MEAN, IMAGENET_STD

    root = os.path.join(HERE, "build", "input_phase", "train")
    t0 = time.perf_counter()
    write_jpeg_tree(root, INPUT_CLASSES, INPUT_PER_CLASS, INPUT_HW)
    write_s = time.perf_counter() - t0

    # the host native library: built here (g++), held to its plain version
    t0 = time.perf_counter()
    native.load()
    native_s = time.perf_counter() - t0
    img = np.random.default_rng(2).integers(0, 256, size=(224, 224, 3), dtype=np.uint8)
    check(np.array_equal(native.u8_to_f32_norm(img, IMAGENET_MEAN, IMAGENET_STD),
                         native.u8_to_f32_norm_plain(img, IMAGENET_MEAN, IMAGENET_STD)),
          "host native u8_to_f32_norm differs from its numpy plain version")

    cfg = input_config(root, TRAIN_BATCH, INPUT_WORKERS)
    loaders, first, determinism = loader_determinism(cfg, "cuda")
    train_loader = loaders[0]
    try:
        steps = len(train_loader)
        check(steps == INPUT_CLASSES * INPUT_PER_CLASS // TRAIN_BATCH, f"{steps} batches an epoch")

        # the tail on the card against the same function on the CPU
        images, labels, _, seeds = first[0]
        draws = augment_draws(seeds)
        cpu = augment_tail(torch.from_numpy(images), torch.from_numpy(draws))
        gpu_in = (torch.from_numpy(images).cuda(), torch.from_numpy(draws).cuda())
        gpu = augment_tail(*gpu_in)
        tail_err = (gpu.cpu() - cpu).abs().max().item()
        check(torch.isfinite(gpu).all() and gpu.shape == images.shape,
              "augment_tail on the card: bad output")
        check(tail_err <= TAIL_ATOL, f"augment_tail card vs CPU: {tail_err} > {TAIL_ATOL}")
        ring, copies = ring_of(gpu_in, images.nbytes)
        # ~80 launches a call: 5 calls stay inside the card's queue of
        # pending launches, which would otherwise fill behind the spin
        tail_ms = device_ms(lambda: augment_tail(*next(ring)), iters=5)
        # one read of the u8 batch and the draws, one write of the f32 batch
        tail_bound, tail_by = bound_ms(0.0, images.nbytes * 5.0 + draws.nbytes)
        del ring, gpu, gpu_in

        trainer = Trainer(cfg, steps_per_epoch=steps, device="cuda")
        check(trainer.fused and trainer.device_augment, "the input trainer did not resolve to "
              "the kernels and the device augmentation tail")
        state = trainer.init_state(seed=0)
        state.memory = full_bank(cfg.model, seed=1)
        route = uint8_route_check(cfg, state, first[0], cpu.numpy(), "cuda")
        f32_cfg = cfg.replace(data=dataclasses.replace(cfg.data, device_augment=False))
        alone = h2d_copies(
            {"uint8": trainer, "f32": Trainer(f32_cfg, steps_per_epoch=steps, device="cuda")},
            {"uint8": first[0], "f32": (cpu.numpy(), labels)})
        del cpu

        # the main path: one epoch from the loader, kernel launches counted,
        # observed by a telemetry session's monitor and, over OBS_WINDOW, a
        # profiler window (the observatory's (a))
        shutil.rmtree(OBS_DIR, ignore_errors=True)
        telem = make_session(os.path.join(OBS_DIR, "telemetry"))
        telem.monitor.watch(trainer.cold_paths.total)
        window = ProfilerWindow(os.path.join(OBS_DIR, "window"), steps=OBS_WINDOW, device="cuda")
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        state, met = trainer.train_epoch(state, train_loader, 0, monitor=telem.monitor,
                                         window=window)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        launches = launch_counts()
        log = trainer.step_log
        want = {"score_pool": steps, "bn_epilogue": 16 * steps, "score_pool_bwd": steps,
                "em_estep": cfg.em.num_em_loop * steps}
        check(len(log) == steps, f"train_epoch took {len(log)} steps, not {steps}")
        check(launches == want, f"input epoch: launches {launches}, expected {want}")
        check(np.isfinite(met.loss.item()) and not met.nonfinite, f"input epoch: loss {met.loss}")
        check(met.em_active > 0, "input epoch: EM touched no class")

        step_s = [r.step_s for r in log]
        wait_s = [r.wait_s for r in log]
        copy_ms = [r.copy_ms for r in log]
        copy_gb_s = log[0].h2d_bytes / float(np.median(copy_ms)) / 1e6
        # the window's steps and the step after them (its arm's synchronize
        # falls in the first, its stop and export in the one after) stay
        # out of the timing figures; step 0 waits for the loader's start
        windowed = list(range(OBS_WINDOW[0] + 1, OBS_WINDOW[1] + 2))
        clean = [i for i in range(steps) if i not in windowed]
        steady = [i for i in clean if i > 0]
        med = float(np.median([step_s[i] for i in steady]))
        emit("input", batch=TRAIN_BATCH, steps=steps, classes=INPUT_CLASSES,
             images=INPUT_CLASSES * INPUT_PER_CLASS, source_hw=list(INPUT_HW),
             workers=INPUT_WORKERS, backend="process", wire="uint8",
             jpeg_write_s=write_s, native_build_s=native_s, determinism=determinism,
             tail={"max_abs_err_vs_cpu": tail_err, "atol": TAIL_ATOL, "ms": tail_ms,
                   "bound_ms": tail_bound, "bound_by": tail_by, "input_copies": copies,
                   "at": f"B={TRAIN_BATCH}, 224x224x3 uint8"},
             uint8_route=route, launches=launches, loss=met.loss.item(),
             em_active=met.em_active, epoch_s=epoch_s, step_s=step_s, wait_s=wait_s,
             step_s_median=med, img_per_s=TRAIN_BATCH / med,
             loader_wait_share=sum(wait_s[i] for i in steady) / sum(step_s[i] for i in steady),
             loader_wait_share_all_steps=(sum(wait_s[i] for i in clean)
                                          / sum(step_s[i] for i in clean)),
             window_affected_steps=windowed, window_affected_s=sum(step_s[i] for i in windowed),
             h2d_image_bytes_per_step=log[0].image_bytes, h2d_bytes_per_step=log[0].h2d_bytes,
             h2d={"in_epoch_ms": copy_ms, "in_epoch_ms_median": float(np.median(copy_ms)),
                  "in_epoch_gb_s_median": copy_gb_s,
                  "in_epoch_share_of_pcie": copy_gb_s * 1e9 / PCIE_BYTES_S,
                  "alone": alone, "pcie_gb_s": PCIE_BYTES_S / 1e9},
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
             window_steps=list(range(OBS_WINDOW[0] + 1, OBS_WINDOW[1] + 1)))

        # the observatory: (a) the window's stall report, the cost counter
        # card vs CPU, (b) an anomaly capture, (e) the telemetry gates
        t_obs = time.perf_counter()
        costs, cost_rec = obs_cost_check(cfg)
        report_path = os.path.join(OBS_DIR, "telemetry", "stall_report.json")
        report, window_rec = obs_window_report(window, trainer, launches, steps, costs, cfg,
                                               report_path)
        state, anomaly_rec = obs_anomaly_check(trainer, state, telem.monitor, first[0])
        telem.flush(step=state.step)
        gates_rec = obs_gates_check(telem.out_dir, report_path)
        telem.close()
        obs_s = time.perf_counter() - t_obs

        holder = [state]

        def one_epoch():
            holder[0], _ = trainer.train_epoch(holder[0], train_loader, 1)

        rec = device_breakdown(one_epoch, 1)
        check(rec is not None, "the input profile recorded no device events")
        # (a): the window's device busy a step against this profile's
        busy_ms = {"window": report["device_busy_s"] * 1e3 / report["steps"],
                   "device_breakdown": rec["device_busy_ms_per_call"] / steps}
        busy_rel = busy_ms["window"] / busy_ms["device_breakdown"] - 1.0
        check(abs(busy_rel) <= OBS_BUSY_RTOL,
              f"(a) the window's device busy a step {busy_ms} is {busy_rel:+.1%} off the profile's")
        emit("obs", card=smi, part="window_and_stall", batch=TRAIN_BATCH, window=window_rec,
             stall_report={k: report[k] for k in ("source", "span_s", "device_busy_s",
                                                  "stream_overlap_s", "step_time_s",
                                                  "fraction_sum", "flops", "peak_flops",
                                                  "measured_mfu", "device_lane")},
             buckets={k: v["fraction"] for k, v in report["buckets"].items()},
             bucket_s_per_step={k: v["seconds"] / report["steps"]
                                for k, v in report["buckets"].items()},
             measured_mfu=report["measured_mfu"], peak_tflops=report["peak_flops"] / 1e12,
             device_busy_ms_per_step=busy_ms, busy_rel=busy_rel, cost=cost_rec,
             step_flops=costs["flops"], step_raw_bytes=costs["raw_bytes"],
             step_fused_bytes=costs["fused_bytes"], step_peak_bytes=costs["peak_bytes"],
             anomaly=anomaly_rec, gates=gates_rec, seconds=obs_s)
        per_step = {k: v / steps for k, v in rec["device_ms_per_call"].items()}
        # the profiled epoch's first step waits for the loader's first two
        # batches with the card idle; the share without that wait
        first_wait_ms = trainer.step_log[0].wait_s * 1e3
        busy, wall = rec["device_busy_ms_per_call"], rec["wall_ms_per_call"]
        emit("profile", path="input", batch=TRAIN_BATCH, steps=steps,
             device_ms_per_step=per_step, device_busy_ms_per_step=busy / steps,
             wall_ms_per_step=wall / steps, device_idle_share=rec["device_idle_share"],
             first_step_wait_ms=first_wait_ms,
             device_idle_share_after_first_wait=1.0 - busy / (wall - first_wait_ms),
             other_top_ms_per_epoch=rec["other_top_ms_per_call"])
    finally:
        for dl in (*loaders[:3], *loaders[3]):
            dl.close()
    return launches, steps, window_rec["kernel_events"]


# ------------------------------------------------------------------ schedule
def schedule_config(train_root, ood_root, model_dir):
    """The schedule phase's Config: the input phase's folder as the train,
    push and test set, one OoD folder, mining and EM from epoch 0, push at
    epoch 1, the top-8 prune."""
    import dataclasses

    from mgproto_tpu_torch.config import ScheduleConfig

    cfg = input_config(train_root, TRAIN_BATCH, INPUT_WORKERS)
    return cfg.replace(
        data=dataclasses.replace(cfg.data, ood_dirs=(ood_root,)),
        schedule=ScheduleConfig(num_train_epochs=SCHEDULE_EPOCHS, mine_start=0,
                                update_gmm_start=0, push_start=1, push_every=1,
                                prune_top_m=SCHEDULE_PRUNE_M),
        model_dir=model_dir)


def state_tensors(state):
    from mgproto_tpu_torch.utils.checkpoint import _tensors, state_payload

    return dict(_tensors(state_payload(state)))


def state_view(state, copy=False):
    """(tensors by name, (step, joint_updates)) of a train state; `copy`
    clones the tensors, so the view outlives later in-place updates."""
    tensors = state_tensors(state)
    if copy:
        tensors = {k: v.detach().clone() for k, v in tensors.items()}
    return tensors, (state.step, state.joint_updates)


def state_mismatches(a, b):
    """Names of the tensors (and counters) of two train states, or views of
    them, that are not bit-equal."""
    import torch

    (ta, ca), (tb, cb) = (x if isinstance(x, tuple) else state_view(x) for x in (a, b))
    bad = sorted(set(ta) ^ set(tb))
    bad += [k for k in ta.keys() & tb.keys()
            if ta[k].dtype != tb[k].dtype or not torch.equal(ta[k].cpu(), tb[k].cpu())]
    if ca != cb:
        bad.append("step/joint_updates")
    return bad


def metric_records(model_dir):
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if not k.endswith("_s") and k != "time"}
                for line in f]


def pushed_features_check(trainer, state, push_ds, model_dir):
    """Each of a sample of pushed prototypes' means against the L2-normalized
    feature at its (image, patch), recomputed on the card."""
    import numpy as np
    import torch

    from mgproto_tpu_torch.core.mgproto import l2_normalize
    from mgproto_tpu_torch.engine.eval import eval_mode, to_device_images
    from mgproto_tpu_torch.engine.push import load_push_provenance
    from mgproto_tpu_torch.utils.images import preprocess_input

    prov = load_push_provenance(model_dir)
    c, k = state.gmm.priors.shape
    ids = np.array(prov["image_id"]).reshape(c, k)
    sp = np.array(prov["spatial_idx"]).reshape(c, k)
    pushed = np.argwhere(ids >= 0)
    sample = pushed[np.random.default_rng(0).choice(len(pushed), PUSH_FEATURE_SAMPLE,
                                                    replace=False)]
    loaded = [push_ds.load(int(ids[ci, ki])) for ci, ki in sample]
    check(all(lbl == ci for (_, lbl, _), (ci, _) in zip(loaded, sample)),
          "a prototype was pushed onto an image of another class")
    x = to_device_images(preprocess_input(np.stack([a for a, _, _ in loaded])), trainer.device)
    with eval_mode(state.model) as model:
        proto_map, _ = model(x)
        b, h, w, d = proto_map.shape
        feat = l2_normalize(proto_map, dim=-1).reshape(b, h * w, d)
        dev = feat.device
        got = feat[torch.arange(b, device=dev),
                   torch.from_numpy(sp[sample[:, 0], sample[:, 1]]).to(dev)]
        want = state.gmm.means.detach()[torch.from_numpy(sample[:, 0]).to(dev),
                                        torch.from_numpy(sample[:, 1]).to(dev)]
        err = (got - want).abs().max().item()
    check(err <= SERVE_ATOL, f"pushed means vs recomputed features: {err} > {SERVE_ATOL}")
    return {"prototypes_checked": int(len(sample)), "max_abs_err": err, "atol": SERVE_ATOL,
            "pushed": int(len(pushed)), "of": int(c * k)}


def sentinel_step_check(cfg, state, batch):
    """C1 on the card: one flagship step on a batch whose first row is the
    loader's sentinel (zero image, label -1). The loss is finite and the
    row enqueues nothing: class C-1, which no labelled row of the batch
    holds, keeps its bank rows and length, and only the labelled rows'
    classes are written."""
    import numpy as np
    import torch

    from mgproto_tpu_torch.engine.train import Trainer

    images, labels, _, seeds = (a.copy() for a in batch)
    c = cfg.model.num_classes
    labels[labels == c - 1] = c - 2  # keep class C-1 for the sentinel to miss
    images[0], labels[0] = 0, -1
    trainer = Trainer(cfg, steps_per_epoch=10, device="cuda")
    st = clone_state(state, cfg)
    st.memory = full_bank(cfg.model, seed=3)
    before = [t.clone() for t in st.memory]
    st, met = trainer.train_step(st, images, labels, use_mine=True, update_gmm=True, seeds=seeds)
    written = (st.memory.feats != before[0]).any(-1).any(-1).cpu().numpy()
    loss = met.loss.item()
    check(np.isfinite(loss) and not met.nonfinite, f"sentinel step: loss {loss}")
    check(torch.equal(st.memory.length[c - 1], before[1][c - 1]) and not written[c - 1],
          "sentinel step: the label -1 row was enqueued into class C-1")
    check(set(np.nonzero(written)[0]) <= set(labels[labels >= 0].tolist()),
          "sentinel step: a class outside the batch's labels was written")
    return {"loss": loss, "classes_written": int(written.sum()), "em_active": met.em_active}


def render_check(trainer, state, push_ds, model_dir, epoch):
    """The push render of `epoch`: 3 JPEGs per pushed prototype; a seeded
    sample decodes (each original and overlay 224 x 224 x 3, each crop the
    size of its box); and for a smaller sample the crop box from the map
    upsampled on the card equals the box the CPU path computes from the
    same map copied to the host, and the crop file has that box's size.
    That sample also times the render's two halves: the batch-1 forward,
    and the host's upsample copy, crop, overlay and three JPEGs."""
    import numpy as np
    import torch
    from PIL import Image

    from mgproto_tpu_torch.core.mgproto import gt_class_log_densities
    from mgproto_tpu_torch.engine.eval import eval_mode, to_device_images
    from mgproto_tpu_torch.engine.push import load_push_provenance
    from mgproto_tpu_torch.utils import vis
    from mgproto_tpu_torch.utils.images import preprocess_input

    out = os.path.join(model_dir, "img", f"epoch-{epoch}")
    prov = load_push_provenance(model_dir)
    c, k = state.gmm.priors.shape
    ids = np.array(prov["image_id"]).reshape(c, k)
    pushed = np.argwhere(ids >= 0)
    files = sorted(os.listdir(out))
    check(len(files) == 3 * len(pushed), f"render: {len(files)} files for {len(pushed)} pushed")
    img = trainer.cfg.model.img_size
    rng = np.random.default_rng(0)
    decoded = {}
    for ci, ki in pushed[rng.choice(len(pushed), RENDER_DECODE_SAMPLE, replace=False)]:
        j = ci * k + ki
        for name in (f"{j}prototype-img-original.jpg",
                     f"{j}prototype-img-original_with_self_act.jpg", f"{j}prototype-img.jpg"):
            with Image.open(os.path.join(out, name)) as im:
                decoded[name] = np.asarray(im).shape
        check(decoded[f"{j}prototype-img-original.jpg"] == (img, img, 3)
              and decoded[f"{j}prototype-img-original_with_self_act.jpg"] == (img, img, 3),
              f"render: prototype {j}'s pictures are not {img} x {img} x 3")
    boxes, forward_ms, host_ms = [], [], []
    scratch = os.path.join(os.path.dirname(model_dir), "render_timing")
    os.makedirs(scratch, exist_ok=True)
    with eval_mode(state.model) as model:
        for ci, ki in pushed[rng.choice(len(pushed), RENDER_BOX_SAMPLE, replace=False)]:
            raw = np.asarray(push_ds.load(int(ids[ci, ki]))[0], np.float32)
            # the render's two halves, timed apart: the batch-1 forward on
            # the card, then the upsample, crop, overlay and 3 JPEGs
            t0 = time.perf_counter()
            x = to_device_images(preprocess_input(raw)[None], trainer.device)
            lp, _ = gt_class_log_densities(
                model, state.gmm, x, torch.full((1,), int(ci), device=trainer.device))
            act = torch.exp(lp[0, ki])
            torch.cuda.synchronize()
            forward_ms.append(1e3 * (time.perf_counter() - t0))
            t0 = time.perf_counter()
            up = vis.upsample_activation(act, raw.shape[:2]).cpu().numpy()
            on_card = vis.find_high_activation_crop(up)
            vis.imsave_with_bbox(os.path.join(scratch, "a.jpg"), raw, *on_card)
            vis.imsave_with_bbox(os.path.join(scratch, "b.jpg"), vis.heatmap_overlay(raw, up),
                                 *on_card)
            vis.imsave(os.path.join(scratch, "c.jpg"),
                       raw[on_card[0]:on_card[1], on_card[2]:on_card[3]])
            host_ms.append(1e3 * (time.perf_counter() - t0))
            on_host = vis.find_high_activation_crop(
                vis.upsample_activation(act.cpu().numpy(), raw.shape[:2]))
            y0, y1, x0, x1 = on_card
            with Image.open(os.path.join(out, f"{ci * k + ki}prototype-img.jpg")) as im:
                crop = np.asarray(im).shape
            check(on_card == on_host, f"render: prototype ({ci}, {ki}) box {on_card} on the "
                                      f"card, {on_host} from the host's map")
            check(crop == (y1 - y0, x1 - x0, 3),
                  f"render: prototype ({ci}, {ki}) crop {crop} for box {on_card}")
            boxes.append([int(v) for v in on_card])
    return {"files": len(files), "pushed": int(len(pushed)), "decoded": len(decoded),
            "boxes_card_eq_host": len(boxes), "sample_boxes": boxes,
            "forward_ms_median": float(np.median(forward_ms)),
            "host_ms_median": float(np.median(host_ms)), "forward_ms": forward_ms,
            "host_ms": host_ms}


def write_cub_tree(root, classes, per_class, hw, seed):
    """A CUB_200_2011-layout tree: the seeded JPEGs of `write_jpeg_tree`
    under images/, every image in the test split, a seeded bounding box
    per image, CUB's 15 parts at seeded places inside it (each visible with
    probability PART_VISIBLE), and the five tables."""
    import numpy as np

    write_jpeg_tree(os.path.join(root, "images"), classes, per_class, hw, seed=seed)
    rng = np.random.default_rng(seed + 1)
    h, w = hw
    os.makedirs(os.path.join(root, "parts"), exist_ok=True)
    tables = {"images": [], "image_class_labels": [], "train_test_split": [],
              "bounding_boxes": []}
    locs = []
    img_id = 0
    for c in range(classes):
        for i in range(per_class):
            img_id += 1
            tables["images"].append(f"{img_id} {c:03d}.class/{i}.jpg")
            tables["image_class_labels"].append(f"{img_id} {c + 1}")
            tables["train_test_split"].append(f"{img_id} 0")
            x0, y0 = rng.uniform(0, w / 3), rng.uniform(0, h / 3)
            bw, bh = rng.uniform(w / 3, w - x0), rng.uniform(h / 3, h - y0)
            tables["bounding_boxes"].append(f"{img_id} {x0:.1f} {y0:.1f} {bw:.1f} {bh:.1f}")
            for p in range(len(CUB_PARTS)):
                if rng.uniform() < PART_VISIBLE:
                    locs.append(f"{img_id} {p + 1} {rng.uniform(x0, x0 + bw):.1f} "
                                f"{rng.uniform(y0, y0 + bh):.1f} 1")
                else:
                    locs.append(f"{img_id} {p + 1} 0.0 0.0 0")
    for name, rows in tables.items():
        with open(os.path.join(root, f"{name}.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
    with open(os.path.join(root, "parts", "parts.txt"), "w") as f:
        f.write("".join(f"{p + 1} {n}\n" for p, n in enumerate(CUB_PARTS)))
    with open(os.path.join(root, "parts", "part_locs.txt"), "w") as f:
        f.write("\n".join(locs) + "\n")
    return img_id


def interpret_phase(smi, cfg, ckpt):
    """The interpretability plane on the card: the schedule phase's push
    checkpoint restored through cli/interpret.run_interpret on a mini-CUB,
    then its maps on the kernel route against the plain route, the batched
    device peaks against the scalar host peaks, the CSV against purity.
    Returns the launch counts of the run_interpret call and what the
    command-line phase reruns: the tree, the checkpoint, the config and the
    metrics (the caller removes the tree)."""
    import dataclasses

    import numpy as np
    import torch

    from mgproto_tpu_torch.cli.interpret import build_eval_loader, run_interpret
    from mgproto_tpu_torch.data.cub_parts import CubParts
    from mgproto_tpu_torch.engine.interpretability import (
        collect_gt_activations,
        peak_box,
        peak_positions,
        purity_from_csv,
    )
    from mgproto_tpu_torch.engine.train import Trainer
    from mgproto_tpu_torch.utils.checkpoint import restore_checkpoint

    base = os.path.dirname(ckpt)
    root = os.path.join(base, "cub")
    t0 = time.perf_counter()
    n_images = write_cub_tree(root, cfg.model.num_classes, INTERPRET_PER_CLASS, INPUT_HW,
                              seed=11)
    write_s = time.perf_counter() - t0
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, worker_backend="thread"))
    csv_path = os.path.join(base, "patches.csv")
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = run_interpret(cfg, root, checkpoint=ckpt, metric="all", export_csv=csv_path,
                        device="cuda")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = launch_counts()
    batches = -(-n_images // cfg.data.test_batch_size)
    check(res["images"] == n_images, f"interpret: {res['images']} images of {n_images}")
    check(launches["bn_epilogue"] == 16 * batches * 2,
          f"interpret launches {launches}: bn_epilogue not 16 x {batches} batches x 2 passes")
    metrics = {m: res[m] for m in ("consistency", "stability", "purity", "purity_std")}
    check(all(np.isfinite(v) and 0.0 <= v <= 100.0 for v in metrics.values()),
          f"interpret: a metric outside [0, 100]: {metrics}")
    k = cfg.model.prototypes_per_class
    check(res["csv_rows"] == cfg.model.num_classes * k * min(10, INTERPRET_PER_CLASS),
          f"interpret: {res['csv_rows']} CSV rows")
    parts = CubParts(root)
    via_csv = purity_from_csv(csv_path, parts, cfg.model.img_size)
    check(abs(via_csv[0] - res["purity"]) <= 1e-9 and abs(via_csv[1] - res["purity_std"])
          <= 1e-9, f"interpret: purity_from_csv {via_csv} vs evaluate_purity "
                   f"{(res['purity'], res['purity_std'])}")

    # the same checkpoint's maps on the kernel route and the plain route
    loader = build_eval_loader(cfg, root)
    try:
        t0 = time.perf_counter()
        loaded = list(loader)
        load_s = time.perf_counter() - t0
    finally:
        loader.close()
    maps = {}
    for name, fused in (("kernel", None), ("plain", False)):
        rcfg = cfg.replace(model=dataclasses.replace(cfg.model, fused_epilogue=fused))
        trainer = Trainer(rcfg, steps_per_epoch=1, device="cuda")
        state = restore_checkpoint(ckpt, trainer.init_state(rcfg.seed))
        reset_launch_counts()
        maps[name] = collect_gt_activations(trainer, state, loaded)[0]
        check((launch_counts()["bn_epilogue"] > 0) == (fused is None),
              f"interpret: the {name} route's epilogue launches {launch_counts()}")
        del state, trainer
    scale = maps["plain"].amax(dim=(2, 3), keepdim=True)
    map_err = float(((maps["kernel"] - maps["plain"]).abs() / scale).max())
    check(map_err <= MAP_ATOL_OF_MAX,
          f"interpret maps, kernel vs plain route: {map_err} > {MAP_ATOL_OF_MAX} of the max")

    # batched device peaks against the scalar host peaks, same maps
    img = cfg.model.img_size
    t0 = time.perf_counter()
    on_card = peak_positions(maps["kernel"], img)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    host_maps = maps["kernel"].cpu().numpy()
    t0 = time.perf_counter()
    on_host = np.array([[peak_box(m, img, 0)[::2] for m in row] for row in host_maps])
    host_s = time.perf_counter() - t0
    diff = np.abs(on_card - on_host)
    moved = int(diff.any(-1).sum())
    check(diff.max() <= 1 and moved <= PEAK_MOVED_SHARE * diff[..., 0].size,
          f"interpret peaks: {moved} of {diff[..., 0].size} maps moved, by up to {diff.max()}")

    sec = res["seconds"]
    emit("interpret", card=smi, images=n_images, batch=cfg.data.test_batch_size,
         reduced=f"CUB's test split cut from 5,794 images (~29 a class) to "
                 f"{INTERPRET_PER_CLASS} a class, {n_images} in all",
         **metrics, csv_rows=res["csv_rows"], run_s=run_s, write_tree_s=write_s,
         clean_pass={"s": sec["clean_pass"], "img_per_s": n_images / sec["clean_pass"]},
         noisy_pass={"s": sec["noisy_pass"], "img_per_s": n_images / sec["noisy_pass"]},
         host_post_pass_s={m: sec[m] for m in ("consistency", "stability", "purity", "csv")},
         launches=launches, bn_epilogue_expected=16 * batches * 2,
         maps_kernel_vs_plain_of_max=map_err, atol_of_max=MAP_ATOL_OF_MAX,
         peaks={"maps": int(diff[..., 0].size), "moved_one_px": moved,
                "card_s": card_s, "host_scalar_s": host_s},
         purity_from_csv=list(via_csv), host_load_s=load_s,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches, {"cub_root": root, "checkpoint": ckpt, "cfg": cfg,
                      "metrics": dict(metrics, csv_rows=res["csv_rows"])}


def image_library_probe():
    """Whether cv2 and matplotlib import on this machine, and their
    versions (the port needs neither); never fails."""
    code = ("import importlib, json\nout = {}\nfor m in ('cv2', 'matplotlib'):\n"
            "    try:\n        out[m] = importlib.import_module(m).__version__\n"
            "    except Exception as e:\n        out[m] = None\nprint(json.dumps(out))")
    try:
        run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             timeout=120)
        return json.loads(run.stdout.strip().splitlines()[-1])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError) as e:
        return {"probe_failed": repr(e)}


def schedule_phase(smi):
    """The whole schedule on the card; returns the launch counts of the
    run, the Config and a copy of the run's `push` checkpoint (under
    build/interpret_phase/, for the interpret phase)."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from mgproto_tpu_torch.cli import train as cli_train
    from mgproto_tpu_torch.cli.train import run_training
    from mgproto_tpu_torch.data import build_pipelines
    from mgproto_tpu_torch.engine.evaluate import _run_eval
    from mgproto_tpu_torch.engine.push import _greedy_assign, scan_candidates
    from mgproto_tpu_torch.engine.train import Trainer
    from mgproto_tpu_torch.utils import checkpoint as ck

    train_root = os.path.join(HERE, "build", "input_phase", "train")
    if not os.path.isdir(train_root):
        write_jpeg_tree(train_root, INPUT_CLASSES, INPUT_PER_CLASS, INPUT_HW)
    base = os.path.join(HERE, "build", "schedule_phase")
    shutil.rmtree(base, ignore_errors=True)
    ood_root = os.path.join(base, "ood")
    write_jpeg_tree(ood_root, OOD_CLASSES, OOD_PER_CLASS, INPUT_HW, seed=7)
    cfg = schedule_config(train_root, ood_root, os.path.join(base, "run"))
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        # the start: seeded random weights and a full seeded bank, handed
        # to run_training as a checkpoint to resume (epoch -1)
        trainer = Trainer(cfg, steps_per_epoch=INPUT_CLASSES * INPUT_PER_CLASS // TRAIN_BATCH,
                          device="cuda")
        start = trainer.init_state(0)
        start.memory = full_bank(cfg.model, seed=1)
        start_path = ck.save_checkpoint(base, start, "start",
                                        metadata={"epoch": -1, "stage": "nopush"})
        del start

        # the state that the run saves mid-run (epoch 0's nopush checkpoint),
        # copied as it is saved, for check 5
        saved_mid_run = {}

        def save_and_keep(ckpt_dir, state, epoch, stage, *args, **kwargs):
            path = ck.save_state_w_condition(ckpt_dir, state, epoch, stage, *args, **kwargs)
            if (epoch, stage) == (0, "nopush"):
                saved_mid_run[path] = state_view(state, copy=True)
            return path

        cli_train.save_state_w_condition = save_and_keep
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        try:
            state, acc = run_training(cfg, resume=start_path, keep_last=3, device="cuda")
        finally:
            cli_train.save_state_w_condition = ck.save_state_w_condition
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = launch_counts()
        ckpts = ck.list_checkpoints(cfg.model_dir)
        stages = sorted({c[1] for c in ckpts})
        check(stages == ["nopush", "prune", "push"], f"stage checkpoints {stages}")
        keep_for_serve_plane(cfg.model_dir, ckpts)
        check(state.step == SCHEDULE_EPOCHS * trainer.steps_per_epoch, f"step {state.step}")
        steps = state.step
        for name in ("score_pool", "bn_epilogue", "score_pool_bwd", "em_estep"):
            check(launches[name] > 0, f"{name} was not launched on the schedule path")
        records = metric_records(cfg.model_dir)
        with open(os.path.join(cfg.model_dir, "metrics.jsonl")) as f:
            timed = [json.loads(line) for line in f]

        # one test pass and one push scan, by themselves: launches and times;
        # the first train batch for check 6 (the thread backend gives the
        # process backend's bytes, as the input phase checks)
        thread_cfg = cfg.replace(data=dataclasses.replace(cfg.data, worker_backend="thread"))
        train_loader, push_loader, test_loader, oods = build_pipelines(thread_cfg, device="cuda")
        try:
            first = first_batches(train_loader, 1)[0]
            t0 = time.perf_counter()
            test_batches = [(b[0], b[1]) for b in test_loader]
            test_load_s = time.perf_counter() - t0
            push_batches = list(push_loader)
            push_ds = push_loader.dataset
        finally:
            for dl in (train_loader, push_loader, test_loader, *oods):
                dl.close()
        n_test = sum(int((b[1] >= 0).sum()) for b in test_batches)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        lp_kernel, _, _, _, _ = _run_eval(trainer, state, test_batches)
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
        test_launches = launch_counts()
        check(test_launches["score_pool"] == len(test_batches)
              and test_launches["bn_epilogue"] == 16 * len(test_batches),
              f"test pass launches {test_launches} over {len(test_batches)} batches")
        reset_launch_counts()
        t0 = time.perf_counter()
        cand = scan_candidates(trainer, state, push_batches)
        torch.cuda.synchronize()
        scan_s = time.perf_counter() - t0
        push_launches = launch_counts()
        check(push_launches["bn_epilogue"] == 16 * len(push_batches),
              f"push scan launches {push_launches} over {len(push_batches)} batches")
        t0 = time.perf_counter()
        _greedy_assign(*cand, cfg.model.num_classes)
        assign_s = time.perf_counter() - t0

        # check 2: the kernel route against the plain route, same state
        plain_cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, fused_scoring=False, fused_epilogue=False))
        plain_trainer = Trainer(plain_cfg, steps_per_epoch=trainer.steps_per_epoch, device="cuda")
        plain_state = clone_state(state, plain_cfg)
        lp_plain, _, _, _, _ = _run_eval(plain_trainer, plain_state, test_batches)
        route_err = float(np.abs(lp_kernel - lp_plain).max())
        check(np.isfinite(lp_kernel).all() and lp_kernel.shape == (n_test,),
              "test pass: bad log p(x)")
        check(route_err <= SERVE_ATOL,
              f"test pass log p(x), kernel vs plain route: {route_err} > {SERVE_ATOL}")
        del plain_state, plain_trainer

        # check 3: pushed means are the features at their (image, patch),
        # and the push rendered each pushed prototype's pictures
        pushed = pushed_features_check(trainer, state, push_ds, cfg.model_dir)
        render = render_check(trainer, state, push_ds, cfg.model_dir, epoch=1)
        emit("render", card=smi, epoch=1,
             render_s_in_run=[r["render_s"] for r in timed if "render_s" in r], **render)

        # check 4: the prune
        keep = state.gmm.keep
        check(bool((state.gmm.priors[~keep] == 0).all()), "a pruned prior is not 0")
        check(int(keep.sum(-1).min()) >= SCHEDULE_PRUNE_M,
              f"a class keeps {int(keep.sum(-1).min())} < {SCHEDULE_PRUNE_M} slots")

        # check 5: the checkpoint saved mid-run, a checkpoint's round trip,
        # timed, and the run's own prune checkpoint, restored into fresh states
        epoch0 = [c[3] for c in ckpts if c[:2] == (0, "nopush")][0]
        check(list(saved_mid_run) == [epoch0], f"mid-run saves {list(saved_mid_run)}")
        bad = state_mismatches(ck.restore_checkpoint(epoch0, trainer.init_state(1)),
                               saved_mid_run.pop(epoch0))
        check(not bad, f"epoch 0's checkpoint differs from the state it saved in {bad[:5]}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timing_path = ck.save_checkpoint(os.path.join(base, "timing"), state, "9timing1.0000")
        save_s = time.perf_counter() - t0
        ckpt_bytes = sum(os.path.getsize(os.path.join(timing_path, f))
                         for f in os.listdir(timing_path))
        t0 = time.perf_counter()
        restored = ck.restore_checkpoint(timing_path, trainer.init_state(1))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        bad = state_mismatches(restored, state)
        check(not bad, f"checkpoint round trip differs in {bad[:5]}")
        prune_ckpt = [c[3] for c in ckpts if c[1] == "prune"][0]
        bad = state_mismatches(ck.restore_checkpoint(prune_ckpt, restored), state)
        check(not bad, f"the run's prune checkpoint differs from the final state in {bad[:5]}")
        del restored

        # the run resumed from epoch 0's checkpoint, against the uninterrupted one
        resumed_cfg = cfg.replace(model_dir=os.path.join(base, "resumed"))
        t0 = time.perf_counter()
        # without the render: the uninterrupted run's render is checked above,
        # and drawing the 800 prototypes again changes no state
        resumed, acc_r = run_training(resumed_cfg, resume=epoch0, device="cuda", render_push=False)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        bad = state_mismatches(resumed, state)
        resumed_records = metric_records(resumed_cfg.model_dir)
        check(not bad, f"the resumed run's final state differs in {bad[:5]}")
        check(resumed_records == records[-len(resumed_records):] and acc_r == acc,
              "the resumed run's losses or test results differ from the uninterrupted run's")
        del resumed

        # check 6: a label -1 sentinel row on the card
        sentinel = sentinel_step_check(cfg, state, first)

        train_s = [r["train_s"] for r in timed if "train_s" in r]
        test_pass_s = [r["test_s"] for r in timed if "test_s" in r]
        emit("schedule", card=smi, epochs=SCHEDULE_EPOCHS, steps=steps, batch=TRAIN_BATCH,
             cudnn_deterministic=True, run_s=run_s, launches=launches,
             train_s_per_epoch=train_s, test_pass_s_in_run=test_pass_s,
             push_s_in_run=[r["push_s"] for r in timed if "push_s" in r],
             test_pass={"images": n_test, "batches": len(test_batches), "s": test_s,
                        "img_per_s": n_test / test_s, "host_load_s": test_load_s,
                        "launches": test_launches,
                        "log_px_kernel_vs_plain_max_abs_err": route_err, "atol": SERVE_ATOL},
             push={"scan_s": scan_s, "assign_s": assign_s, "batches": len(push_batches),
                   "launches": push_launches, "features": pushed},
             checkpoint={"bytes": ckpt_bytes, "save_s": save_s, "restore_s": restore_s,
                         "bit_exact": True, "mid_run_bit_exact": True},
             resume={"from": os.path.basename(epoch0), "s": resume_s, "bit_exact": True},
             final_accuracy=acc, pushed=pushed["pushed"],
             pruned=int((~keep).sum().item()), kept_min_per_class=int(keep.sum(-1).min()),
             sentinel_step=sentinel, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        push_ckpt = [c[3] for c in ckpts if c[1] == "push"][0]
        kept = os.path.join(HERE, "build", "interpret_phase", os.path.basename(push_ckpt))
        shutil.rmtree(os.path.dirname(kept), ignore_errors=True)
        shutil.copytree(push_ckpt, kept)
        return launches, cfg, kept
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
        shutil.rmtree(base, ignore_errors=True)


# ------------------------------------------------------------------ options
def bf16_config(cfg):
    import dataclasses

    return cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="bfloat16"))


def flat_grads(trainer, state):
    import torch

    return torch.cat([p.grad.reshape(-1).float() for p in trainer.params(state)])


def cosine(a, b):
    return (a @ b / (a.norm() * b.norm())).item()


def state_dtypes(state):
    """Every floating tensor of a train state that the precision policy
    keeps f32, by name, and its dtype."""
    out = {f"model.{n}": t.dtype for n, t in state.model.state_dict().items()
           if t.is_floating_point()}
    out["memory.feats"] = state.memory.feats.dtype
    for name in ("means", "sigmas", "priors"):
        out[f"gmm.{name}"] = getattr(state.gmm, name).dtype
    for oname in ("opt", "mean_opt"):
        for i, st in enumerate(getattr(state, oname).state.values()):
            for key in ("exp_avg", "exp_avg_sq"):
                out[f"{oname}.{i}.{key}"] = st[key].dtype
    return out


def bf16_epilogue_cases():
    """The bf16 epilogue at the four ResNet-34 stage shapes of a training
    step (B = 80, the batch's own statistics): each held to its plain
    version and timed; the 16 launches of a step summed."""
    import torch

    gc = torch.Generator(device="cuda").manual_seed(1)
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0}
    for blocks, hw, ch in R34_STAGES:
        rec = epilogue_case("train", TRAIN_BATCH, hw, ch, torch.bfloat16, gc)
        rec["launches_per_forward"] = blocks
        emit("kernel", kernel="bn_epilogue", path="train_bf16", **rec)
        total["max_abs_err"] = max(total["max_abs_err"], rec["max_abs_err"])
        for key in ("ms", "plain_ms", "bound_ms"):
            total[key] += blocks * rec[key]
    torch.cuda.empty_cache()
    return dict(total, bound_by="bytes", at="16 launches, B=80, bf16, batch statistics")


def bf16_serve_check():
    """The flagship served in bf16 beside the same weights in f32."""
    import numpy as np
    import torch

    from mgproto_tpu_torch.config import Config
    from mgproto_tpu_torch.core.mgproto import build_mgproto
    from mgproto_tpu_torch.engine.eval import Evaluator
    from mgproto_tpu_torch.serving.calibration import Calibration, calibrate
    from mgproto_tpu_torch.serving.engine import ServingEngine

    cfg = Config()
    m = cfg.model
    rng = np.random.default_rng(0)
    img = (m.img_size, m.img_size, 3)
    id_images = rng.normal(size=(16, *img)).astype(np.float32)
    x = rng.normal(size=(19, *img)).astype(np.float32)
    out = {}
    for name, c in (("f32", cfg), ("bf16", bf16_config(cfg))):
        model, gmm = build_mgproto(c.model, device="cuda", seed=0)
        ev = Evaluator(model, gmm, c, device="cuda")
        cal = calibrate(ev, [id_images[:8], id_images[8:]], source="chip_smoke seeded ID images")
        engine = ServingEngine.from_live(ev, calibration=cal, buckets=(1, 2, 4, 8))
        engine.warmup()
        check(not engine.gate.degraded, f"{name} engine degraded with its own calibration")
        check(cal.compute_dtype == c.model.compute_dtype, f"{name} calibration stamped {cal.compute_dtype}")
        reset_launch_counts()
        engine.dispatch_count = 0
        resps = engine.serve_all(list(x))
        launches = launch_counts()
        d = engine.dispatch_count
        check(all(r.outcome in ("predict", "abstain") for r in resps), f"{name}: not every request served")
        check(launches["score_pool"] == d and launches["bn_epilogue"] == 16 * d,
              f"{name} serve: launches {launches} for {d} dispatches")
        logits = torch.cat([ev(x[i:i + 8]).logits.cpu() for i in range(0, len(x), 8)]).numpy()
        check(np.isfinite(logits).all(), f"{name}: non-finite served logits")
        lat = []
        for _ in range(10):
            t1 = time.perf_counter()
            engine._dispatch(x[:8])
            lat.append((time.perf_counter() - t1) * 1e3)
        out[name] = dict(ev=ev, cal=cal, logits=logits, px=np.array([r.log_px for r in resps]),
                         pred=np.array([r.prediction for r in resps]), launches=launches,
                         dispatches=d, bucket8_median_ms=float(np.median(lat)))
    a, b = out["bf16"], out["f32"]
    f32_cal = Calibration.from_dict({**a["cal"].to_dict(), "compute_dtype": "float32"})
    mismatched = ServingEngine.from_live(a["ev"], calibration=f32_cal, buckets=(8,))
    check(mismatched.gate.degraded and mismatched.gate.precision_mismatch,
          "a float32-stamped calibration did not degrade the bf16 engine")
    rec = {
        "requests": len(x), "dispatches": a["dispatches"], "launches": a["launches"],
        "log_px_max_abs_diff_vs_f32": float(np.abs(a["px"] - b["px"]).max()),
        "logits_max_abs_diff_vs_f32": float(np.abs(a["logits"] - b["logits"]).max()),
        "log_px_range_f32": [float(b["px"].min()), float(b["px"].max())],
        "threshold_bf16": a["cal"].threshold_log_px, "threshold_f32": b["cal"].threshold_log_px,
        "predictions_equal_share": float((a["pred"] == b["pred"]).mean()),
        "bucket8_dispatch_host_ms": {"bf16": a["bucket8_median_ms"], "f32": b["bucket8_median_ms"]},
        "f32_calibration_degrades_bf16_engine": True,
    }
    del out, mismatched
    torch.cuda.empty_cache()
    return rec


def bf16_train_check():
    """Six bf16 steps at batch 80 with mining and EM from a full seeded
    bank; the first against the f32 first step from the same state."""
    import dataclasses

    import numpy as np
    import torch

    from mgproto_tpu_torch.config import Config, DataConfig
    from mgproto_tpu_torch.engine.train import Trainer

    cfg32 = Config(data=DataConfig(device_augment=False))
    cfg = bf16_config(cfg32)
    m = cfg.model
    trainer = Trainer(cfg, steps_per_epoch=100, device="cuda")
    check(trainer.precision.mixed and trainer.fused, "the bf16 trainer did not resolve as asked")
    state = trainer.init_state(seed=0)
    state.memory = full_bank(m, seed=1)
    tr32 = Trainer(cfg32, steps_per_epoch=100, device="cuda")
    st32 = clone_state(state, cfg32)
    rng = np.random.default_rng(0)
    batches = [(rng.normal(size=(TRAIN_BATCH, m.img_size, m.img_size, 3)).astype(np.float32),
                rng.integers(0, m.num_classes, size=TRAIN_BATCH)) for _ in range(TRAIN_STEPS)]
    st32, met32 = tr32.train_step(st32, *batches[0], use_mine=True, update_gmm=True)
    g32 = flat_grads(tr32, st32)
    del st32, tr32
    # the same bf16 first step on the plain block tails (the epilogue kernel
    # off), and on the plain tails with the images one bf16 step larger:
    # how far the gradient moves under a rounding placed elsewhere, and
    # under one bf16 step of the input (the floor the cosines sit on)
    routes = {}
    plain_cfg = cfg.replace(model=dataclasses.replace(m, fused_epilogue=False))
    tr_plain = Trainer(plain_cfg, steps_per_epoch=100, device="cuda")
    for name, scale in (("plain_tails", 1.0), ("plain_tails_input_one_step", 1.0 + 2.0 ** -7)):
        st = clone_state(state, plain_cfg)
        st, _ = tr_plain.train_step(st, batches[0][0] * np.float32(scale), batches[0][1],
                                    use_mine=True, update_gmm=True)
        routes[name] = flat_grads(tr_plain, st)
        del st
    del tr_plain
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    per_step = {"score_pool": 1, "bn_epilogue": 16, "score_pool_bwd": 1,
                "em_estep": cfg.em.num_em_loop}
    step_s, losses = [], []
    torch.cuda.synchronize()
    reset_launch_counts()
    for i, (images, labels) in enumerate(batches):
        before = launch_counts()
        t0 = time.perf_counter()
        state, met = trainer.train_step(state, images, labels, use_mine=True, update_gmm=True)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        losses.append(met.loss.item())
        check(np.isfinite(losses[-1]) and not met.nonfinite, f"bf16 step {i}: loss {losses[-1]}")
        check(delta == per_step, f"bf16 step {i}: launches {delta}, expected {per_step}")
        if i == 0:
            g16 = flat_grads(trainer, state)
            first = met
    launches = launch_counts()
    bad = {k: str(v) for k, v in state_dtypes(state).items() if v != torch.float32}
    check(not bad, f"bf16 training left statistics or masters in half precision: {bad}")
    check(trainer.last_bank.em is not None
          and trainer.last_bank.em.log_likelihood.dtype == torch.float32,
          "the EM statistics of the bf16 step are not f32")
    loss_rel = abs(first.loss.item() - met32.loss.item()) / abs(met32.loss.item())
    check(loss_rel <= BF16_LOSS_RTOL, f"bf16 first-step loss {first.loss.item()} vs f32 "
          f"{met32.loss.item()}: {loss_rel} > {BF16_LOSS_RTOL}")
    med = float(np.median(step_s[1:]))
    rec = {
        "batch": TRAIN_BATCH, "steps": TRAIN_STEPS, "losses": losses, "launches": launches,
        "step_s": step_s, "step_s_median": med, "img_per_s": TRAIN_BATCH / med,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "first_step_loss_bf16": first.loss.item(), "first_step_loss_f32": met32.loss.item(),
        "first_step_loss_rel_diff": loss_rel, "loss_rtol": BF16_LOSS_RTOL,
        "grad_norm_ratio": (g16.norm() / g32.norm()).item(),
        "grad_cosine": cosine(g16, g32),
        "grad_cosine_kernel_vs_plain_tails_bf16": cosine(g16, routes["plain_tails"]),
        "grad_cosine_plain_tails_vs_input_one_bf16_step": cosine(
            routes["plain_tails"], routes["plain_tails_input_one_step"]),
        "grad_cosine_plain_tails_bf16_vs_f32": cosine(routes["plain_tails"], g32),
        "state_tensors_f32": len(state_dtypes(state)),
    }
    del g16, g32, routes
    it = itertools.cycle(batches[1:])
    holder = [state]

    def one_step():
        holder[0], _ = trainer.train_step(holder[0], *next(it), use_mine=True, update_gmm=True)

    prof = device_breakdown(one_step, 3)
    state = holder[0]
    rec.update(bf16_eval_and_push(trainer, state, batches[:2], rng))
    del holder, state, trainer
    torch.cuda.empty_cache()
    return rec, prof, launches, TRAIN_STEPS


def bf16_eval_and_push(trainer, state, batches, rng):
    """A test pass and a push of the bf16 state through the schedule's own
    entry points (engine/evaluate.py, engine/push.py): their launches, a
    finite accuracy pass, and pushed means that stay f32 and finite."""
    import numpy as np
    import torch

    from mgproto_tpu_torch.engine.evaluate import evaluate
    from mgproto_tpu_torch.engine.push import push_prototypes

    reset_launch_counts()
    acc, res = evaluate(trainer, state, [(x, y) for x, y in batches], log=lambda *_: None)
    eval_launches = launch_counts()
    m = trainer.cfg.model
    push_batches = [(rng.random((TRAIN_BATCH, m.img_size, m.img_size, 3), dtype=np.float32), y,
                     np.arange(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH))
                    for i, (_, y) in enumerate(batches)]
    reset_launch_counts()
    state, pushed = push_prototypes(trainer, state, push_batches)
    push_launches = launch_counts()
    torch.cuda.synchronize()
    n = len(batches)
    check(eval_launches["score_pool"] == n and eval_launches["bn_epilogue"] == 16 * n,
          f"bf16 test pass: launches {eval_launches} for {n} batches")
    check(push_launches["bn_epilogue"] == 16 * n, f"bf16 push: launches {push_launches}")
    check(np.isfinite(res["cross_entropy"]), f"bf16 test pass: cross entropy {res['cross_entropy']}")
    means = state.gmm.means.detach()
    check(means.dtype == torch.float32 and bool(torch.isfinite(means).all())
          and int(pushed.pushed.sum()) > 0, "bf16 push: means not f32 and finite, or none pushed")
    return {"eval_accuracy": acc, "eval_cross_entropy": res["cross_entropy"],
            "eval_launches": eval_launches, "pushed": int(pushed.pushed.sum()),
            "push_launches": push_launches}


def aux_loss_checks():
    """One flagship step with each of the five other aux losses."""
    import numpy as np
    import torch

    from mgproto_tpu_torch.config import Config, DataConfig, LossConfig
    from mgproto_tpu_torch.engine.train import Trainer

    rng = np.random.default_rng(3)
    m = Config().model
    images = rng.normal(size=(TRAIN_BATCH, m.img_size, m.img_size, 3)).astype(np.float32)
    labels = rng.integers(0, m.num_classes, size=TRAIN_BATCH)
    out = {}
    for name in OPTION_AUX_LOSSES:
        cfg = Config(data=DataConfig(device_augment=False), loss=LossConfig(aux_loss=name))
        trainer = Trainer(cfg, steps_per_epoch=100, device="cuda")
        state = trainer.init_state(seed=0)
        state, met = trainer.train_step(state, images, labels, use_mine=True, update_gmm=False)
        proxies = state.proxies is not None
        check(np.isfinite(met.loss.item()) and np.isfinite(met.aux.item()) and not met.nonfinite,
              f"aux loss {name}: loss {met.loss.item()}, aux {met.aux.item()}")
        check(proxies == (name == "proxy_nca"), f"aux loss {name}: proxies present = {proxies}")
        out[name] = {"loss": met.loss.item(), "aux": met.aux.item(), "proxies": proxies}
        del state, trainer
    torch.cuda.empty_cache()
    return out


def remat_checks():
    """remat and remat_stages=("layer3",) against the plain step from one
    state and batch, cuDNN deterministic."""
    import dataclasses

    import numpy as np
    import torch

    from mgproto_tpu_torch.config import Config, DataConfig
    from mgproto_tpu_torch.engine.train import Trainer

    base = Config(data=DataConfig(device_augment=False))
    rng = np.random.default_rng(4)
    m = base.model
    images = rng.normal(size=(TRAIN_BATCH, m.img_size, m.img_size, 3)).astype(np.float32)
    labels = rng.integers(0, m.num_classes, size=TRAIN_BATCH)
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    runs = {}
    try:
        for name, kw in (("plain", {}), ("remat", {"remat": True}),
                         ("remat_stages_layer3", {"remat_stages": ("layer3",)})):
            cfg = base.replace(model=dataclasses.replace(m, **kw))
            trainer = Trainer(cfg, steps_per_epoch=100, device="cuda")
            state = trainer.init_state(seed=0)
            torch.cuda.synchronize()
            base_bytes = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            before = launch_counts()
            t0 = time.perf_counter()
            state, met = trainer.train_step(state, images, labels, use_mine=True, update_gmm=False)
            torch.cuda.synchronize()
            runs[name] = {
                "step_s": time.perf_counter() - t0,
                "peak_step_gb": (torch.cuda.max_memory_allocated() - base_bytes) / 1e9,
                "epilogue_launches": launch_counts()["bn_epilogue"] - before["bn_epilogue"],
                "loss": met.loss.item(),
                "stats": {n: t.clone() for n, t in state.model.state_dict().items()
                          if "running" in n},
                "grad": flat_grads(trainer, state),
            }
            del state, trainer
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    ref = runs.pop("plain")
    rec = {"plain": {k: v for k, v in ref.items() if k not in ("stats", "grad")}}
    for name, run in runs.items():
        stats_equal = all(torch.equal(run["stats"][k], ref["stats"][k]) for k in ref["stats"])
        grad_equal = torch.equal(run["grad"], ref["grad"])
        grad_rel = rel_norm(run["grad"], ref["grad"])
        check(stats_equal, f"{name}: running statistics differ from the plain step")
        check(grad_equal or grad_rel <= REMAT_GRAD_RTOL,
              f"{name}: gradient rel err {grad_rel} > {REMAT_GRAD_RTOL}")
        check(run["loss"] == ref["loss"], f"{name}: loss {run['loss']} vs {ref['loss']}")
        rec[name] = {k: v for k, v in run.items() if k not in ("stats", "grad")}
        rec[name].update(stats_bit_equal=stats_equal, grad_bit_equal=grad_equal,
                         grad_rel_err=grad_rel)
    del runs, ref
    torch.cuda.empty_cache()
    return rec


def reference_em_check():
    """One reference-stepping EM call on the flagship bank (every class
    full and updated) on the card, against the same call on the CPU."""
    import dataclasses

    import torch

    from mgproto_tpu_torch.config import Config
    from mgproto_tpu_torch.core.em import em_update, make_mean_optimizer
    from mgproto_tpu_torch.core.mgproto import init_gmm

    cfg = Config()
    em_cfg = dataclasses.replace(cfg.em, reference_stepping=True)
    bank = full_bank(cfg.model, seed=5)
    out = {}
    for dev in ("cuda", "cpu"):
        gmm = init_gmm(cfg.model, torch.Generator().manual_seed(0), dev)
        opt = make_mean_optimizer(gmm.means, em_cfg)
        memory = type(bank)(*(t.to(dev) for t in bank))
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        gmm, _, aux = em_update(gmm, memory, opt, em_cfg)
        if dev == "cuda":
            torch.cuda.synchronize()
        st = opt.state[gmm.means]
        out[dev] = {"s": time.perf_counter() - t0, "means": gmm.means.detach().cpu(),
                    "priors": gmm.priors.cpu(), "exp_avg": st["exp_avg"].cpu(),
                    "exp_avg_sq": st["exp_avg_sq"].cpu(), "step": int(st["step"]),
                    "active": aux.num_active, "loss": aux.loss.item(),
                    "ll": aux.log_likelihood.item()}
    a, b = out["cuda"], out["cpu"]
    lr_tol = 2 * em_cfg.num_em_loop * em_cfg.mean_lr
    errs = {
        "means_max_abs": (a["means"] - b["means"]).abs().max().item(),
        "means_beyond_atol_share": ((a["means"] - b["means"]).abs()
                                    > REF_EM_MEANS_ATOL).float().mean().item(),
        "priors_max_abs": (a["priors"] - b["priors"]).abs().max().item(),
        "exp_avg_rel_of_max": ((a["exp_avg"] - b["exp_avg"]).abs().max()
                               / b["exp_avg"].abs().max()).item(),
        "exp_avg_sq_rel_of_max": ((a["exp_avg_sq"] - b["exp_avg_sq"]).abs().max()
                                  / b["exp_avg_sq"].abs().max()).item(),
        "loss_rel": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
        "ll_abs": abs(a["ll"] - b["ll"]),
    }
    check(a["active"] == b["active"] == cfg.model.num_classes, f"reference EM active {a['active']}")
    check(a["step"] == b["step"] == cfg.model.num_classes * em_cfg.num_em_loop,
          f"reference EM Adam steps {a['step']} / {b['step']}")
    check(errs["priors_max_abs"] <= REF_EM_PRIOR_ATOL, f"reference EM priors: {errs}")
    check(errs["means_max_abs"] <= lr_tol, f"reference EM means: {errs}")
    check(errs["means_beyond_atol_share"] <= REF_EM_MEANS_BEYOND_SHARE,
          f"reference EM means beyond {REF_EM_MEANS_ATOL}: {errs}")
    check(max(errs["exp_avg_rel_of_max"], errs["exp_avg_sq_rel_of_max"]) <= REF_EM_MOMENT_RTOL,
          f"reference EM Adam moments: {errs}")
    return {"classes": a["active"], "adam_steps": a["step"], "card_s": a["s"], "cpu_s": b["s"],
            **errs, "tolerances": {"priors_atol": REF_EM_PRIOR_ATOL,
                                   "means_atol": REF_EM_MEANS_ATOL,
                                   "means_beyond_atol_share": REF_EM_MEANS_BEYOND_SHARE,
                                   "means_beyond_atol_max": lr_tol,
                                   "moments_rtol_of_max": REF_EM_MOMENT_RTOL}}


def options_phase():
    """Phase 9; returns the bf16 epilogue's summary, the bf16 steps'
    launches and their number of steps."""
    t0 = time.perf_counter()
    epi = bf16_epilogue_cases()
    emit("options", part="serve_bf16", **bf16_serve_check())
    train, prof, launches, steps = bf16_train_check()
    emit("options", part="train_bf16", **train)
    if prof is None:
        emit("profile", path="train_bf16", note="profiler recorded no device events: not measured")
    else:
        emit("profile", path="train_bf16", batch=TRAIN_BATCH, steps=3, **prof)
    emit("options", part="aux_losses", **aux_loss_checks())
    emit("options", part="remat", cudnn_deterministic=True, grad_rtol=REMAT_GRAD_RTOL,
         **remat_checks())
    emit("options", part="reference_stepping", **reference_em_check())
    emit("options", part="done", seconds=time.perf_counter() - t0)
    return epi, launches, steps


# ---------------------------------------------------------------- backbones
def torchvision_state(arch, seed, legacy=False):
    """A seeded state_dict of `arch`'s trunk in torchvision's layout (the
    `features.` prefix of VGG and DenseNet files, the classifier head,
    `num_batches_tracked`); `legacy` names DenseNet's layers `norm.1`,
    `conv.1`, ... as old torchvision files do."""
    import torch

    from mgproto_tpu_torch.models.registry import build_backbone, family

    gen = torch.Generator().manual_seed(seed)
    prefix = "" if family(arch) == "resnet" else "features."
    out = {}
    for k, v in build_backbone(arch).state_dict().items():
        if not v.is_floating_point():
            out[prefix + k] = v.clone()
        elif k.endswith("running_var"):
            out[prefix + k] = 0.5 + torch.rand(v.shape, generator=gen)
        elif k.endswith(".weight") and v.dim() == 4:  # He-normal, fan_out
            fan = v.shape[0] * v.shape[2] * v.shape[3]
            out[prefix + k] = torch.randn(v.shape, generator=gen) * (2.0 / fan) ** 0.5
        elif k.endswith(".weight"):  # BatchNorm scale around 1
            out[prefix + k] = 0.5 + torch.rand(v.shape, generator=gen)
        else:
            out[prefix + k] = 0.1 * torch.randn(v.shape, generator=gen)
    head = "fc" if family(arch) == "resnet" else "classifier"
    out[f"{head}.weight"] = torch.zeros(1000, 8)
    out[f"{head}.bias"] = torch.zeros(1000)
    if legacy:
        for a, b in ((".norm1.", ".norm.1."), (".norm2.", ".norm.2."),
                     (".conv1.", ".conv.1."), (".conv2.", ".conv.2.")):
            out = {k.replace(a, b): v for k, v in out.items()}
    return out


def backbone_config(arch, **model_kw):
    """The flagship's widths on another trunk: C=200, K=10, d=64, T=20, the
    bank of 800, batch 80, 224 px, f32, the trunk from its local .pth; f32
    batches of seeded noise (the input phase drives the uint8 wire)."""
    from mgproto_tpu_torch.config import Config, DataConfig, ModelConfig

    return Config(model=ModelConfig(arch=arch, pretrained=True, **model_kw),
                  data=DataConfig(device_augment=False))


def grad_vector(trainer, state):
    import torch

    return torch.cat([p.grad.reshape(-1) for p in trainer.params(state)])


def conv_gflop(model, img_size):
    """Forward convolution GFLOP of one image through `model` (2 x MACs,
    from the shapes each conv sees in a batch-1 eval forward on the card)."""
    import torch

    total = [0]

    def hook(mod, inp, out):
        k = mod.kernel_size[0] * mod.kernel_size[1] * mod.in_channels // mod.groups
        total[0] += 2 * out.numel() * k

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.Conv2d)]
    try:
        was_training = model.training
        with torch.no_grad():
            model.eval()(torch.zeros(1, img_size, img_size, 3, device="cuda"))
        model.train(was_training)
    finally:
        for h in handles:
            h.remove()
    return total[0] / 1e9


def backbone_train_check(smi, arch, pth):
    """Phase 10 for one trunk; returns the launch counts of its six steps."""
    import dataclasses

    import numpy as np
    import torch

    from mgproto_tpu_torch.engine.train import Trainer

    cfg = backbone_config(arch)
    m = cfg.model
    trainer = Trainer(cfg, steps_per_epoch=100, device="cuda")
    check(trainer.fused, f"{arch}: the trainer did not resolve to the kernels")
    state = trainer.init_state(seed=0)
    file_sd = torch.load(pth, map_location="cpu", weights_only=True)
    prefix = "" if arch.startswith("resnet") else "features."
    renamed = {k: v for k, v in file_sd.items()}
    if any(".norm.1." in k for k in renamed):
        for a, b in ((".norm.1.", ".norm1."), (".norm.2.", ".norm2."),
                     (".conv.1.", ".conv1."), (".conv.2.", ".conv2.")):
            renamed = {k.replace(a, b): v for k, v in renamed.items()}
    trunk = state.model.features.state_dict()
    bad = [k for k, v in trunk.items()
           if not k.endswith("num_batches_tracked") and not torch.equal(v.cpu(), renamed[prefix + k])]
    check(not bad, f"{arch}: the loaded trunk differs from {pth} in {bad[:5]}")
    state.memory = full_bank(m, seed=1)
    gmm0 = (state.gmm.means.detach().clone(), state.gmm.sigmas.clone())
    gflop = conv_gflop(state.model, m.img_size)

    plain_cfg = cfg.replace(model=dataclasses.replace(m, fused_scoring=False),
                            em=dataclasses.replace(cfg.em, fused_estep=False))
    plain_trainer = Trainer(plain_cfg, steps_per_epoch=100, device="cuda")
    plain_state = clone_state(state, plain_cfg)
    floor_state = clone_state(state, plain_cfg)
    check(not plain_trainer.fused, f"{arch}: the plain route resolved to the kernels")

    rng = np.random.default_rng(0)
    c = m.num_classes
    batches = [(rng.normal(size=(TRAIN_BATCH, m.img_size, m.img_size, 3)).astype(np.float32),
                rng.integers(0, c, size=TRAIN_BATCH)) for _ in range(TRAIN_STEPS)]
    want = {"score_pool": 1, "bn_epilogue": 0, "score_pool_bwd": 1,
            "em_estep": cfg.em.num_em_loop}
    step_s, losses, first = [], [], None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    for i, (images, labels) in enumerate(batches):
        probe = Probe(state.model, BACKBONE_PROBES) if i == 0 else None
        before = launch_counts()
        t0 = time.perf_counter()
        state, met = trainer.train_step(state, images, labels, use_mine=True, update_gmm=True)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        losses.append(met.loss.item())
        check(np.isfinite(losses[-1]) and not met.nonfinite, f"{arch} step {i}: loss {losses[-1]}")
        check(delta == want, f"{arch} step {i}: launches {delta}, expected {want}")
        if i == 0:
            probe.remove()
            first = first_step_run(trainer, state, probe, met)
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    images0, labels0 = batches[0]

    def plain_first_step(st, imgs):
        probe = Probe(st.model, BACKBONE_PROBES)
        st, rmet = plain_trainer.train_step(st, imgs, labels0, use_mine=True, update_gmm=True)
        probe.remove()
        return first_step_run(plain_trainer, st, probe, rmet)

    ref = plain_first_step(plain_state, images0)
    ref["groups"] = {"all": slice(0, ref["grad"].numel())}
    rec = route_record("kernel", first, ref, gmm0, m.mine_T)
    # The floor: the plain route against itself on images x (1 + 1e-7). A
    # patch that this moves across a top-T boundary moves the gradient by
    # its whole term, a jump no rounding explains (one ulp of the images
    # moves 311 of vgg19's 160000 lists and 474 of densenet121's at batch
    # 80 on an H100), so such a floor says nothing of the kernels. The
    # trunk is the same code on both routes here (no epilogue): the kernel
    # route is then held to the scoring bound alone.
    fr = route_record("floor", plain_first_step(floor_state, images0 * np.float32(1 + 1e-7)),
                      ref, gmm0, m.mine_T)
    floor_flips = fr["top_t_lists_changed"]
    floor = fr["grad_rel_err"] if floor_flips == 0 else 0.0
    grad_bound = max(TRAIN_SCORING_GRAD_RTOL, TRAIN_GRAD_FLOOR_MULT * floor)
    pmet, em_ll = ref["met"], ref["ll"]
    check(rec["loss_abs_err"] <= TRAIN_LOSS_RTOL * abs(pmet.loss.item()),
          f"{arch} kernel vs plain route: loss differs by {rec['loss_abs_err']}")
    check(rec["em_ll_abs_err"] <= TRAIN_LL_ATOL,
          f"{arch} kernel vs plain route: EM log-likelihood differs by {rec['em_ll_abs_err']}")
    check(rec["priors_max_abs_err"] <= TRAIN_PRIOR_ATOL,
          f"{arch} kernel vs plain route: priors differ by {rec['priors_max_abs_err']}")
    check(rec["grad_rel_err"] <= grad_bound,
          f"{arch} kernel vs plain route: gradient rel err {rec['grad_rel_err']} > {grad_bound}")
    del plain_state, floor_state, ref, first

    # a test pass on one batch: log p(x) on the kernel route and the plain one
    eval_images = rng.normal(size=(TRAIN_BATCH, m.img_size, m.img_size, 3)).astype(np.float32)
    before = launch_counts()
    lp_kernel = trainer.eval_step(state, eval_images).log_px
    eval_launches = {k: v - before[k] for k, v in launch_counts().items()}
    lp_plain = plain_trainer.eval_step(state, eval_images).log_px
    lp_err = (lp_kernel - lp_plain).abs().max().item()
    check(bool(torch.isfinite(lp_kernel).all()) and lp_err <= SERVE_ATOL,
          f"{arch} test pass log p(x), kernel vs plain route: {lp_err} > {SERVE_ATOL}")
    check(eval_launches["score_pool"] == 1 and eval_launches["bn_epilogue"] == 0,
          f"{arch} test pass launches {eval_launches}")

    timed = step_s[1:]
    med = float(np.median(timed))
    emit("backbone", card=smi, arch=arch, pretrained=os.path.basename(pth), batch=TRAIN_BATCH,
         img_size=m.img_size, conv_gflop_fwd_per_image=gflop, steps=TRAIN_STEPS, losses=losses,
         launches=launches, step_s=step_s,
         step_s_median=med, img_per_s=TRAIN_BATCH / med, peak_mem_gb=peak_gb,
         first_step={"loss": pmet.loss.item(), "em_ll": em_ll, "grad_floor": floor,
                     "floor_run": {"grad_rel_err": fr["grad_rel_err"],
                                   "top_t_lists_changed": floor_flips},
                     "grad_bound": grad_bound, **{k: rec[k] for k in (
                         "loss_abs_err", "grad_rel_err", "em_ll_abs_err",
                         "priors_max_abs_err", "act_rel_err", "act_grad_rel_err",
                         "top_t_lists_changed", "top_t_lists")}},
         test_pass={"log_px_kernel_vs_plain_max_abs_err": lp_err, "atol": SERVE_ATOL,
                    "launches": eval_launches})

    it = itertools.cycle(batches[1:])
    holder = [state]

    def one_step():
        holder[0], _ = trainer.train_step(holder[0], *next(it), use_mine=True, update_gmm=True)

    prof = device_breakdown(one_step, 3)
    if prof is None:
        emit("profile", path=f"train_{arch}", note="profiler recorded no device events: not measured")
    else:
        emit("profile", path=f"train_{arch}", batch=TRAIN_BATCH, steps=3, **prof)
    return launches


def densenet_remat_check(smi, pth):
    """densenet121 with remat=True against the plain step from one state,
    cuDNN deterministic: the running statistics and the gradients
    bit-equal; the peaks of both."""
    import dataclasses

    import numpy as np
    import torch

    from mgproto_tpu_torch.engine.train import Trainer

    cfg = backbone_config("densenet121")
    rng = np.random.default_rng(5)
    images = rng.normal(size=(TRAIN_BATCH, 224, 224, 3)).astype(np.float32)
    labels = rng.integers(0, cfg.model.num_classes, size=TRAIN_BATCH)
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    out = {}
    try:
        start = None
        for name, remat in (("plain", False), ("remat", True)):
            rcfg = cfg.replace(model=dataclasses.replace(cfg.model, remat=remat))
            trainer = Trainer(rcfg, steps_per_epoch=100, device="cuda")
            if start is None:
                start = trainer.init_state(0)
                start.memory = full_bank(rcfg.model, seed=1)
            state = clone_state(start, rcfg)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, met = trainer.train_step(state, images, labels, use_mine=True,
                                            update_gmm=True)
            torch.cuda.synchronize()
            out[name] = {"s": time.perf_counter() - t0,
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                         "loss": met.loss.item(), "grad": grad_vector(trainer, state).clone(),
                         "stats": {k: v.clone() for k, v in state.model.state_dict().items()
                                   if "running" in k}}
            del state, trainer
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    a, b = out["plain"], out["remat"]
    stats_equal = all(torch.equal(a["stats"][k], b["stats"][k]) for k in a["stats"])
    check(stats_equal, "densenet121 remat: the running statistics differ from the plain step's")
    check(torch.equal(a["grad"], b["grad"]) and a["loss"] == b["loss"],
          f"densenet121 remat: gradient rel err {rel_norm(b['grad'], a['grad'])}")
    emit("backbone", card=smi, arch="densenet121", part="remat", cudnn_deterministic=True,
         bit_equal=True, batch=TRAIN_BATCH, plain={k: a[k] for k in ("s", "peak_gb")},
         remat={k: b[k] for k in ("s", "peak_gb")})


def backbone_phase(smi):
    """Phase 10; returns {arch: launch counts of its six steps} and the
    directory of the .pth files (for the command-line phase)."""
    import torch

    pth_dir = os.path.join(HERE, "build", "pretrained")
    os.makedirs(pth_dir, exist_ok=True)
    paths = {"vgg19": os.path.join(pth_dir, "vgg19-dcbb9e9d.pth"),
             "densenet121": os.path.join(pth_dir, "densenet121-a639ec97.pth")}
    t0 = time.perf_counter()
    for i, (arch, path) in enumerate(paths.items()):
        # the DenseNet file names its layers as old torchvision files do
        torch.save(torchvision_state(arch, seed=20 + i, legacy=arch == "densenet121"), path)
    write_s = time.perf_counter() - t0
    os.environ["MGPROTO_PRETRAINED_DIR"] = pth_dir
    t0 = time.perf_counter()
    launches = {arch: backbone_train_check(smi, arch, path) for arch, path in paths.items()}
    densenet_remat_check(smi, paths["densenet121"])
    emit("backbone", part="done", write_pth_s=write_s, seconds=time.perf_counter() - t0)
    return launches, pth_dir


# ------------------------------------------------------------ command line
def cli_flags(root, model_dir, **extra):
    """Flags of the port's mains: the input phase's folder as the train,
    push and test set, the flagship's widths, batch 80."""
    flags = ["--train_dir", root, "--test_dir", root, "--push_dir", root, "--model_dir", model_dir]
    for k, v in {"num_workers": INPUT_WORKERS, **extra}.items():
        flags += [f"--{k}"] + ([] if v is True else [str(v)])
    return flags


def run_main(module, flags, timeout, env=None):
    """`python -m mgproto_tpu_torch.cli.<module>` from the repository root;
    returns (exit code, stdout, stderr, seconds)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", f"mgproto_tpu_torch.cli.{module}", *flags],
                       cwd=HERE, capture_output=True, text=True, timeout=timeout,
                       env=dict(os.environ, PYTHONUNBUFFERED="1", **(env or {})))
    return r.returncode, r.stdout, r.stderr, time.perf_counter() - t0


def last_json(text):
    lines = [ln for ln in text.strip().splitlines() if ln.startswith("{")]
    check(bool(lines), f"no JSON line in:\n{text[-2000:]}")
    return json.loads(lines[-1])


def captured(fn, argv):
    """(return value, stdout) of a command's `main` called in this process."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = fn(argv)
    return code, out.getvalue()


def telemetry_dir_check(smi, part, run_dir, steps=None, serving_requests=None):
    """The telemetry a main wrote (its session's directory, or a run dir
    holding telemetry/): `cli.telemetry summarize` reads it (in this
    process: the command imports no torch), `check --write-baseline` then
    `check --baseline` against itself exit 0. `steps`: the train steps it
    must count; `serving_requests`: the requests its serving section must
    count. Returns the summary."""
    from mgproto_tpu_torch.cli import telemetry as cli_telemetry

    t0 = time.perf_counter()
    code, text = captured(cli_telemetry.main, ["summarize", run_dir, "--json"])
    summary = json.loads(text)
    check(code is None and summary["snapshots"] > 0 and summary["artifacts"]["metrics.jsonl"],
          f"{part}: summarize found no telemetry in {run_dir}")
    if steps is not None:
        check(summary["steps"]["steps_total"] == steps,
              f"{part}: {summary['steps']['steps_total']} steps in the telemetry, {steps} run")
    if serving_requests is not None:
        got = sum((summary.get("serving") or {}).get("requests_by_outcome", {}).values())
        check(got == serving_requests, f"{part}: {got} requests in the telemetry, "
              f"{serving_requests} served")
    baseline = os.path.join(os.path.dirname(summary["telemetry_dir"]),
                            os.path.basename(summary["telemetry_dir"]) + "_baseline.json")
    wcode, _ = captured(cli_telemetry.check_main, [run_dir, "--baseline", baseline,
                                                   "--write-baseline"])
    ccode, ctext = captured(cli_telemetry.check_main, [run_dir, "--baseline", baseline, "--json"])
    result = json.loads(ctext)
    check(wcode == 0 and ccode == 0 and result["ok"] and result["checked"] > 0,
          f"{part}: check --baseline against itself exited {ccode}: {result}")
    steps_s = summary.get("steps", {})
    emit("telemetry_dir", card=smi, part=part, snapshots=summary["snapshots"],
         steps_total=steps_s.get("steps_total"), images_total=steps_s.get("images_total"),
         step_time_p50_s=steps_s.get("step_time_p50_seconds"),
         step_time_p99_s=steps_s.get("step_time_p99_seconds"),
         images_per_sec=steps_s.get("images_per_sec"),
         recompiles=summary["recompiles"]["jit_recompiles_total"],
         health_records=(summary.get("health") or {}).get("records", 0),
         spans=sorted(summary.get("spans", {}))[:12],
         serving=(summary.get("serving") or {}).get("requests_by_outcome"),
         baseline_entries=result["checked"], check_exit=ccode,
         seconds=time.perf_counter() - t0)
    return summary


def children(pid):
    """PIDs whose parent is `pid`, from /proc."""
    out = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    if int(f.read().rsplit(")", 1)[1].split()[1]) == pid:
                        out.append(int(d))
            except (OSError, IndexError, ValueError):
                pass
    return out


def cmdline(pid):
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read()
    except OSError:
        return b""


def process_group(pid):
    try:
        return os.getpgid(pid)
    except OSError:
        return None


def alive(pid):
    """Whether `pid` runs (a zombie does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def cli_train_check(smi, root, base, beside=None):
    """11 (a) and (b): the train main on densenet121 from its .pth, then the
    evaluate main on its prune checkpoint, with `beside` (a check of its own,
    here the interpret main's) run in a thread while the evaluate main runs."""
    import concurrent.futures

    from mgproto_tpu_torch.utils import checkpoint as ck

    run_dir = os.path.join(base, "densenet121")
    # the schedule phase's OoD folder (5 x 16) as the test and push set: the
    # schedule phase already renders the whole folder's push
    ood = trust_trees()[1]
    captures = os.path.join(base, "captures")
    flags = cli_flags(root, run_dir, arch="densenet121", epochs=1, mine_start=0, gmm_start=0,
                      push_start=0, push_every=1, test_dir=ood, push_dir=ood,
                      profile_steps=CLI_PROFILE_STEPS, profile_out=captures)
    rc, out, err, train_s = run_main("train", flags, timeout=600)
    check(rc == 0, f"cli.train exited {rc}:\n{err[-3000:]}")
    window = cli_capture_check(captures)
    stages = sorted({c[1] for c in ck.list_checkpoints(run_dir)})
    check(stages == ["nopush", "prune", "push"], f"cli.train stage checkpoints {stages}")
    log = open(os.path.join(run_dir, "train.log")).read()
    check("training done" in log and "arch='densenet121'" in log and "pretrained=True" in log,
          "cli.train: train.log lacks the run")
    records = [json.loads(ln) for ln in open(os.path.join(run_dir, "metrics.jsonl"))]
    img_dir = os.path.join(run_dir, "img", "epoch-0")
    rendered = len(os.listdir(img_dir)) if os.path.isdir(img_dir) else 0
    check(rendered > 0 and records[-1].get("stage") == "prune", "cli.train: no render or prune")
    # one epoch: the train record's step is the epoch's step count
    telemetry_dir_check(smi, "11 (a) cli.train", run_dir,
                        steps=[r for r in records if "train_s" in r][-1]["step"])

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        side = pool.submit(beside) if beside is not None else None
        rc, eout, eerr, eval_s = run_main("evaluate", cli_flags(root, run_dir, arch="densenet121",
                                                                test_dir=ood), timeout=300)
        if side is not None:
            side.result()  # its check's failure raises here
    check(rc == 0, f"cli.evaluate exited {rc}:\n{eerr[-3000:]}")
    res = last_json(eout)
    prune = [c[3] for c in ck.list_checkpoints(run_dir) if c[1] == "prune"][0]
    check(res["checkpoint"] == prune, f"cli.evaluate read {res['checkpoint']}, not {prune}")
    check(res["accuracy"] == records[-1]["acc"],
          f"cli.evaluate accuracy {res['accuracy']} != the run's last test pass "
          f"{records[-1]['acc']}")
    telemetry_dir_check(smi, "11 (b) cli.evaluate", os.path.join(run_dir, "telemetry_eval"))
    emit("cli", card=smi, part="train_evaluate", arch="densenet121", epochs=1, batch=TRAIN_BATCH,
         train_wall_s=train_s, stages=stages, rendered_jpegs=rendered,
         train_s=[r["train_s"] for r in records if "train_s" in r],
         render_s=[r["render_s"] for r in records if "render_s" in r],
         accuracy=records[-1]["acc"], evaluate_wall_s=eval_s, evaluate_accuracy=res["accuracy"],
         profile_window=window)


def cli_capture_check(captures):
    """11 (a)'s `--profile_steps` window: one capture of its two steps
    (the range arms after step 2 and closes after step 4), its trace
    with device events and the head's kernels at their launches a step
    times their CUDA kernels a launch (densenet121 has no ResNet block
    tail, so no epilogue). The E-step runs only on classes whose bank is
    full, which a run from an empty bank may not have yet: its events are
    whole launches, at most `num_em_loop` a step."""
    from mgproto_tpu_torch.obs import stall

    a, b = (int(x) for x in CLI_PROFILE_STEPS.split(":"))
    dirs = os.listdir(captures) if os.path.isdir(captures) else []
    check(dirs == [f"trace_steps_step{a + 1:06d}"], f"11 (a) --profile_steps captures {dirs}")
    cap = os.path.join(captures, dirs[0])
    meta = json.load(open(os.path.join(cap, "capture_meta.json")))
    check(not meta["fallback"] and meta["steps"] == b - a and meta["device_events"] > 0,
          f"11 (a) the window's capture meta {meta}")
    events = stall.load_chrome_trace(cap)
    counts = kernel_events(events)
    want = {"score_pool": 1, "bn_epilogue": 0, "score_pool_bwd": 1}
    want = {k: (b - a) * n * KERNELS_PER_LAUNCH[k] for k, n in want.items()}
    estep = counts["em_estep"]
    check({k: counts[k] for k in want} == want and estep % KERNELS_PER_LAUNCH["em_estep"] == 0
          and estep <= (b - a) * 3 * KERNELS_PER_LAUNCH["em_estep"],
          f"11 (a) kernel events in the window {counts}, expected {want} and whole E-steps")
    return {"steps": meta["steps"], "device_events": meta["device_events"],
            "trace_mb": meta["trace_bytes"] / 1e6, "capture_s": meta["capture_s"],
            "kernel_events": counts}


def cli_interpret_check(smi, interp):
    """11 (c): the interpret main on the interpret phase's tree and
    checkpoint prints the metrics its run_interpret returned."""
    cfg = interp["cfg"]
    csv = os.path.join(os.path.dirname(interp["checkpoint"]), "cli_patches.csv")
    flags = ["--cub_root", interp["cub_root"], "--checkpoint", interp["checkpoint"],
             "--model_dir", os.path.dirname(interp["checkpoint"]), "--export_csv", csv,
             "--batch_size", str(cfg.data.test_batch_size),
             "--num_workers", str(cfg.data.num_workers), "--no_pretrained"]
    rc, out, err, wall_s = run_main("interpret", flags, timeout=300)
    check(rc == 0, f"cli.interpret exited {rc}:\n{err[-3000:]}")
    res = last_json(out)
    want = interp["metrics"]
    check({k: res[k] for k in want} == want,
          f"cli.interpret printed {res}, run_interpret returned {want}")
    emit("cli", card=smi, part="interpret", wall_s=wall_s, **{k: res[k] for k in want})


def cli_preempt_check(smi, root, base):
    """11 (d): a real SIGTERM to the train main's process group in its
    first step, while its spawn workers start (resnet18, one epoch): the
    signal is sent once a worker exists that has not yet left the group.
    Then `--resume auto` (on thread workers, which give the same batches)."""
    import signal
    import threading

    from mgproto_tpu_torch.resilience.preemption import read_marker
    from mgproto_tpu_torch.utils import checkpoint as ck

    run_dir = os.path.join(base, "sigterm")
    # the schedule phase's OoD folder (5 x 16) as the test set: the resume's
    # two test passes need no more to show the run finished
    ood = trust_trees()[1]
    run = dict(arch="resnet18", epochs=1, mine_start=0, gmm_start=0, push_start=100,
               no_pretrained=True, test_dir=ood, push_dir=ood)
    flags = cli_flags(root, run_dir, **run)
    spawn = cli_flags(root, run_dir, **run, num_workers=SIGTERM_WORKERS,
                      worker_backend="process")
    # the main as `-m` runs it, with SIGUSR1 dumping every thread's stack
    # (sent below should the run not exit)
    main = ("import faulthandler, runpy, signal, sys; "
            "faulthandler.register(signal.SIGUSR1, all_threads=True); "
            "sys.argv[0] = 'mgproto_tpu_torch.cli.train'; "
            "runpy.run_module('mgproto_tpu_torch.cli.train', run_name='__main__', alter_sys=True)")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", main, *spawn],
                            cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONUNBUFFERED="1"), start_new_session=True)
    workers, starting, lines = set(), [], []
    done = threading.Event()

    def watch():  # every spawn worker the run has, until it exits
        while not done.is_set():
            workers.update(p for p in children(proc.pid) if b"spawn_main" in cmdline(p))
            time.sleep(0.05)

    watcher = threading.Thread(target=watch, daemon=True)
    try:
        # the epoch's gates are logged right before its first step; the
        # train loader starts its spawn pool for that step's batch
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("update GMM:"):
                break
        deadline = time.time() + 120
        while not starting and time.time() < deadline:
            starting = [p for p in children(proc.pid)
                        if b"spawn_main" in cmdline(p) and process_group(p) == proc.pid]
            time.sleep(0.01)
        check(starting, "cli.train: no spawn worker was seen in its process group")
        os.killpg(proc.pid, signal.SIGTERM)  # as a terminal or a scheduler sends it
        sent_s = time.perf_counter() - t0
        watcher.start()
        try:
            rest, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            os.kill(proc.pid, signal.SIGUSR1)
            time.sleep(2)
            proc.kill()
            _, err = proc.communicate()
            done.set()
            watcher.join()
            for p in workers:  # in sessions of their own: not the main's to end now
                if alive(p):
                    os.kill(p, signal.SIGKILL)
            raise SmokeFailure(f"the SIGTERM'd cli.train did not exit in 300 s:\n{err[-6000:]}")
    finally:
        done.set()
        if watcher.is_alive():
            watcher.join()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"preempted cli.train exited {proc.returncode}:\n{err[-3000:]}")
    marker = read_marker(run_dir)
    ckpts = ck.list_checkpoints(run_dir)
    check(marker is not None and ckpts and ckpts[-1][1] == "preempt",
          f"no PREEMPTED.json or preempt checkpoint: {marker}, {ckpts}")
    meta = ck.load_metadata(ckpts[-1][3])
    check(meta["reason"] == "signal SIGTERM" and meta["batch_in_epoch"] >= 1
          and marker["batch_in_epoch"] == meta["batch_in_epoch"],
          f"preempt metadata {meta}, marker {marker}")
    deadline = time.time() + 20
    while any(alive(p) for p in workers) and time.time() < deadline:
        time.sleep(0.2)
    orphans = [p for p in workers if alive(p)]
    for p in orphans:  # this script stops what it started, whatever the check says
        os.kill(p, signal.SIGKILL)
    # the signal killed no worker: the pool replaced none
    check(len(workers) == SIGTERM_WORKERS and set(starting) <= workers and not orphans,
          f"spawn workers {sorted(workers)} (signalled while starting: {starting}): "
          f"{orphans} still alive after the run exited")

    epoch_trace, captures = os.path.join(base, "epoch_trace"), os.path.join(base, "held")
    rc, out, err2, resume_s = run_main(
        "train", flags + ["--resume", "auto", "--profile_dir", epoch_trace,
                          "--profile_on_anomaly", "--profile_out", captures], timeout=600)
    check(rc == 0, f"resumed cli.train exited {rc}:\n{err2[-3000:]}")
    check(read_marker(run_dir) is None, "the resumed run left PREEMPTED.json")
    stages = [c[1] for c in ck.list_checkpoints(run_dir)]
    check(stages[-1] == "prune", f"the resumed run did not finish: {stages}")
    log = open(os.path.join(run_dir, "train.log")).read()
    check(f"skipping {meta['batch_in_epoch']} completed batches" in log,
          "the resumed run did not skip the applied batches")
    # --profile_dir traced the resumed epoch; the cold first step's
    # recompile capture fell due inside that trace and was held off
    from mgproto_tpu_torch.obs.stall import device_events

    trace = os.path.join(epoch_trace, "epoch.trace.json")
    trace_mb = os.path.getsize(trace) / 1e6 if os.path.exists(trace) else 0.0
    n_dev = len(device_events(json.load(open(trace))["traceEvents"])) if trace_mb else 0
    check(n_dev > 0, f"11 (d) the --profile_dir trace {trace} holds no device event")
    check("recompile capture at step 1 skipped while the --profile_dir trace" in log
          and not os.path.exists(captures),
          "11 (d) the anomaly window was not held while the --profile_dir trace was open")
    emit("cli", card=smi, part="sigterm", arch="resnet18", signal_sent_s=sent_s,
         preempted_wall_s=wall_s, batch_in_epoch=meta["batch_in_epoch"],
         spawn_workers=len(workers), starting_at_signal=len(starting), orphans=len(orphans),
         resume_wall_s=resume_s, stages=stages,
         profile_dir={"device_events": n_dev, "trace_mb": trace_mb, "held_capture": "recompile"})


def drill_config(root, model_dir, async_bank=False):
    """The in-process drills: resnet18 at the flagship's widths, 2 epochs
    without a push on `root` (thread workers), seeded random weights;
    `async_bank` turns the async bank pipeline on."""
    import dataclasses

    from mgproto_tpu_torch.config import EMConfig, ModelConfig, ScheduleConfig

    cfg = input_config(root, TRAIN_BATCH, INPUT_WORKERS, model=ModelConfig(arch="resnet18"))
    return cfg.replace(data=dataclasses.replace(cfg.data, worker_backend="thread"),
                       schedule=ScheduleConfig(num_train_epochs=2, mine_start=0,
                                               update_gmm_start=0, push_start=100),
                       em=EMConfig(async_bank=async_bank), model_dir=model_dir)


def cli_drill_check(smi, root, base, async_bank=False):
    """11 (e): the preempt and NaN drills through run_training, cuDNN
    deterministic, against the clean run bit for bit; a budget of 0
    rollbacks raises. Every run starts from one checkpoint with a full
    seeded bank, so EM runs in every step. Returns the launch counts of
    the drills.

    `async_bank=True` (phase 13 (a)) runs them on the async bank pipeline,
    with the preemption at the last step of epoch 0: a preemption flushes
    the held bank phase before the save (as in the JAX package), so a run
    resumed mid-epoch scores prototypes one step fresher than the
    uninterrupted run, while at an epoch's end that flush is the one the
    clean run makes too. The rollback replays epoch 1 from its start, as in
    sync mode. The 0-rollback budget run is phase 11's alone."""
    import torch

    from mgproto_tpu_torch.cli.train import run_training
    from mgproto_tpu_torch.engine.train import Trainer
    from mgproto_tpu_torch.resilience import chaos
    from mgproto_tpu_torch.resilience.guard import DivergenceError
    from mgproto_tpu_torch.utils import checkpoint as ck

    # the input phase's folder cut to 2 images a class (links): 5 steps an epoch
    half = os.path.join(base, "half")
    for cls in sorted(os.listdir(root)):
        os.makedirs(os.path.join(half, cls))
        for name in sorted(os.listdir(os.path.join(root, cls)))[:DRILL_PER_CLASS]:
            os.symlink(os.path.join(root, cls, name), os.path.join(half, cls, name))
    root = half
    steps = INPUT_CLASSES * DRILL_PER_CLASS // TRAIN_BATCH
    # sync: the third step of epoch 1; async: the preemption at the last
    # step of epoch 0, the NaN at the third of epoch 1
    at = steps + 2
    preempt_at = steps - 1 if async_bank else at

    cfg = drill_config(root, base, async_bank)
    start = Trainer(cfg, steps_per_epoch=steps, device="cuda").init_state(0)
    start.memory = full_bank(cfg.model, seed=1)
    start_path = ck.save_checkpoint(base, start, "start", metadata={"epoch": -1, "stage": "nopush"})
    del start

    def run(name, resume=start_path, **kw):
        cfg = drill_config(root, os.path.join(base, name), async_bank)
        t0 = time.perf_counter()
        state, acc = run_training(cfg, resume=resume, device="cuda", render_push=False, **kw)
        torch.cuda.synchronize()
        return cfg, state, acc, time.perf_counter() - t0

    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        _, clean, acc, clean_s = run("clean")
        cfg, _, _, pre_s = run("preempt", chaos=chaos.ChaosState(chaos.ChaosPlan(
            preempt_at_step=preempt_at)))
        _, resumed, acc_r, res_s = run("preempt", resume="auto")
        bad = state_mismatches(resumed, clean)
        check(not bad and acc_r == acc, f"preempt drill: the resumed state differs in {bad[:5]}")
        nan = chaos.ChaosState(chaos.ChaosPlan(nan_at_step=at))
        cfg, rolled, acc_n, nan_s = run("nan", chaos=nan, max_bad_steps=1,
                                        divergence_check_every=1, max_rollbacks=1)
        log = open(os.path.join(cfg.model_dir, "train.log")).read()
        n_rollbacks = log.count(f"; rolling back to {cfg.model_dir}")
        bad = state_mismatches(rolled, clean)
        check(nan.injections == {"nan_loss": 1} and n_rollbacks == 1,
              f"NaN drill: injections {nan.injections}, rollbacks {n_rollbacks}")
        check(not bad and acc_n == acc, f"NaN drill: the final state differs in {bad[:5]}")
        raised = None
        if not async_bank:
            try:
                run("budget", chaos=chaos.ChaosState(chaos.ChaosPlan(nan_at_step=at)),
                    max_bad_steps=1, divergence_check_every=1, max_rollbacks=0)
            except DivergenceError as e:
                raised = e
            check(raised is not None and raised.epoch == 1,
                  "a budget of 0 rollbacks did not raise")
        launches = launch_counts()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    emit("cli" if not async_bank else "elastic", card=smi,
         part="drills" if not async_bank else "async_drills", arch="resnet18",
         cudnn_deterministic=True, async_bank=async_bank, steps_per_epoch=steps,
         event_step=at, preempt_step=preempt_at, clean_s=clean_s, preempt_s=pre_s,
         resume_s=res_s, nan_s=nan_s, rollbacks=n_rollbacks, bit_equal=True,
         budget_0_raised=str(raised), launches=launches)
    return launches


def cli_phase(smi, interp):
    """Phase 11; returns the launch counts of the in-process drills."""
    import gc
    import shutil

    import torch

    # the mains run in processes of their own: hand back what this one holds
    # in torch's cache (a densenet121 step at batch 80 needs ~60 GB)
    gc.collect()
    torch.cuda.empty_cache()

    root = os.path.join(HERE, "build", "input_phase", "train")
    if not os.path.isdir(root):
        write_jpeg_tree(root, INPUT_CLASSES, INPUT_PER_CLASS, INPUT_HW)
    base = os.path.join(HERE, "build", "cli_phase")
    shutil.rmtree(base, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        # the interpret main runs beside the evaluate main (two light processes)
        cli_train_check(smi, root, base, beside=lambda: cli_interpret_check(smi, interp))
        cli_preempt_check(smi, root, base)
        launches = cli_drill_check(smi, root, base)
    finally:
        shutil.rmtree(base, ignore_errors=True)
        shutil.rmtree(os.path.dirname(interp["checkpoint"]), ignore_errors=True)
    emit("cli", part="done", seconds=time.perf_counter() - t0)
    return launches


# ------------------------------------------------------------- serve plane
SERVE_PLANE_IMAGES = 64  # the --images batch of the batch face
SERVE_PLANE_BODIES = 16  # distinct images JSON-encoded for the HTTP requests
SERVE_PLANE_REQUESTS = 32  # requests of each in-process plane run (1, then 2 replicas)
SERVE_PLANE_CLIENTS = 8  # client threads against the network face
SERVE_PLANE_PER_CLIENT = 8  # requests a client sends, one after another
SERVE_PLANE_INFLIGHT = 16  # requests sent just before the SIGTERM
SERVE_PLANE_TOP_E = 5
SERVE_PLANE_DIR = os.path.join(HERE, "build", "serve_phase")


def keep_for_serve_plane(model_dir, ckpts):
    """Copies of the schedule's `prune` and `push` checkpoints and its push
    provenance under build/serve_phase/run/, for phase 12."""
    import shutil

    run = os.path.join(SERVE_PLANE_DIR, "run")
    shutil.rmtree(SERVE_PLANE_DIR, ignore_errors=True)
    os.makedirs(run)
    for stage in ("prune", "push"):
        src = [c[3] for c in ckpts if c[1] == stage][0]
        shutil.copytree(src, os.path.join(run, os.path.basename(src)))
    shutil.copy(os.path.join(model_dir, "push_provenance.json"), run)


def serve_plane_checkpoints():
    """(prune, push) checkpoint paths under build/serve_phase/run/: the
    schedule phase's copies, or (this phase run alone) two seeded flagship
    states, the first pruned to its top 8 of 10 by seeded priors, with a
    seeded push provenance."""
    import torch

    from mgproto_tpu_torch.config import Config
    from mgproto_tpu_torch.core.mgproto import prune_top_m
    from mgproto_tpu_torch.engine.train import Trainer
    from mgproto_tpu_torch.utils import checkpoint as ck

    run = os.path.join(SERVE_PLANE_DIR, "run")
    found = {c[1]: c[3] for c in ck.list_checkpoints(run)} if os.path.isdir(run) else {}
    if not {"prune", "push"} <= set(found):
        os.makedirs(run, exist_ok=True)
        trainer = Trainer(Config(), steps_per_epoch=1, device="cuda")
        for seed, stage in ((1, "push"), (2, "prune")):
            state = trainer.init_state(seed)
            if stage == "prune":
                g = torch.Generator().manual_seed(seed)
                priors = torch.rand(state.gmm.priors.shape, generator=g).cuda()
                state.gmm = prune_top_m(state.gmm._replace(priors=priors / priors.sum(-1, True)),
                                        SCHEDULE_PRUNE_M)
            found[stage] = ck.save_checkpoint(run, state, ck.checkpoint_name(1, stage, 0.0),
                                              metadata={"epoch": 1, "stage": stage})
        p = state.gmm.priors.numel()
        rng = torch.Generator().manual_seed(3)
        with open(os.path.join(run, "push_provenance.json"), "w") as f:
            json.dump({"image_id": torch.randint(-1, 800, (p,), generator=rng).tolist(),
                       "spatial_idx": torch.randint(0, 196, (p,), generator=rng).tolist(),
                       "log_prob": (-torch.rand(p, generator=rng) * 8).tolist()}, f)
    return found["prune"], found["push"]


def start_main(module, flags, env=None, **kw):
    """`python -m mgproto_tpu_torch.cli.<module>` started, not waited for;
    `env` adds to this process's environment."""
    return subprocess.Popen([sys.executable, "-m", f"mgproto_tpu_torch.cli.{module}", *flags],
                            cwd=HERE, text=True,
                            env=dict(os.environ, PYTHONUNBUFFERED="1", **(env or {})), **kw)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_call(port, method, path, body=b"", timeout=120):
    """(status, body bytes, seconds) of one HTTP/1.1 request."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request(method, path, body=body or None)
    resp = conn.getresponse()
    out = resp.status, resp.read()
    conn.close()
    return out[0], out[1], time.perf_counter() - t0


def strip_uncalibrated(src, dst):
    """A copy of an artifact without its calibration.json."""
    import zipfile

    with zipfile.ZipFile(src) as z, zipfile.ZipFile(dst, "w", zipfile.ZIP_DEFLATED) as out:
        for name in z.namelist():
            if name != "calibration.json":
                out.writestr(z.getinfo(name), z.read(name))


def served_lines(text):
    lines = [json.loads(ln) for ln in text.strip().splitlines() if ln.startswith("{")]
    return [ln for ln in lines if "request_id" in ln], lines[-1]


def reqtrace_and_warmup_check(smi, resps, summary, telem_dir, warmup_dir, tel_summary):
    """The observatory's (c), on phase 12's batch face: every answered
    request carries its timings and has a frontend, batcher, replica and
    engine span in the session's trace; `serving_stage_seconds` counts every
    admitted request (total), the answered ones (queue, device); the warmup
    trace holds score_pool and epilogue events at 1 and 16 a warmed bucket.
    Then the tracer's host cost a request, in this process. Returns the
    warmup trace's kernel events."""
    from mgproto_tpu_torch.obs import reqtrace, stall
    from mgproto_tpu_torch.serving.response import ServeResponse
    from mgproto_tpu_torch.telemetry.tracing import Tracer

    answered = [r for r in resps if r["outcome"] in ("predict", "abstain")]
    check(all({"total_s", "queue_s", "device_s"} <= set(r.get("timings") or {})
              for r in answered), "(c) an answered request carries no timings")
    with open(os.path.join(telem_dir, "trace.json")) as f:
        spans = json.load(f)["traceEvents"]
    by_request = {}
    for e in spans:
        rid = (e.get("args") or {}).get("request")
        if rid is not None:
            by_request.setdefault(rid, set()).add(e["name"])
    stages = {"frontend", "batcher", "replica", "engine"}
    missing = [r["request_id"] for r in answered
               if not stages <= by_request.get(r["request_id"], set())]
    check(not missing, f"(c) requests without all four stage spans: {missing[:5]}")
    stage = (tel_summary.get("serving") or {}).get("stage_seconds") or {}
    admitted = [r for r in resps if r["outcome"] != "reject"]
    counts = {k: (stage.get(k) or {}).get("count") for k in ("queue", "device", "total")}
    check(counts == {"queue": len(answered), "device": len(answered), "total": len(admitted)},
          f"(c) serving_stage_seconds counts {counts}: {len(admitted)} admitted, "
          f"{len(answered)} answered")
    (cap,) = os.listdir(warmup_dir)
    with open(os.path.join(warmup_dir, cap, "capture_meta.json")) as f:
        meta = json.load(f)
    events = stall.load_chrome_trace(os.path.join(warmup_dir, cap))
    kernels = kernel_events(events)
    buckets = summary["warmup_compiles"]
    check(not meta["fallback"] and kernels["score_pool"] == buckets
          and kernels["bn_epilogue"] == 16 * buckets,
          f"(c) the warmup trace's kernels {kernels} for {buckets} buckets ({meta})")
    # the tracer's host cost: a request minted, admitted, dispatched alone
    # and finished, against the same calls with tracing off
    costs = {}
    for on in (False, True):
        if on:
            reqtrace.enable(tracer=Tracer(), include_timings=True)
        t0 = time.perf_counter()
        for i in range(OBS_REQTRACE_REQUESTS):
            rid = f"r{i}"
            reqtrace.mint(rid)
            reqtrace.on_enqueue(rid, time.monotonic())
            reqtrace.dispatch_context("r0", "linger", time.monotonic())
            reqtrace.on_dispatch([rid], bucket=1, fill=1.0)
            reqtrace.finish(ServeResponse(request_id=rid, outcome="predict"))
        costs["on" if on else "off"] = (time.perf_counter() - t0) / OBS_REQTRACE_REQUESTS * 1e6
        reqtrace.disable()
    emit("obs", card=smi, part="reqtrace_and_warmup", answered=len(answered),
         admitted=len(admitted), stage_counts=counts,
         stage_p50_s={k: (stage.get(k) or {}).get("p50") for k in counts},
         warmup={"capture": cap, "kernel_events": kernels, "buckets": buckets,
                 "device_events": meta.get("device_events"), "trace_mb":
                 meta.get("trace_bytes", 0) / 1e6, "capture_s": meta.get("capture_s")},
         reqtrace_host_us_per_request=costs, requests_timed=OBS_REQTRACE_REQUESTS)
    return kernels


def serve_plane_phase(smi):
    """Phase 12; returns the launch counts of the in-process plane's run."""
    import asyncio
    import atexit
    import concurrent.futures
    import gc
    import shutil
    import signal
    import socket
    import threading

    import numpy as np
    import torch

    from mgproto_tpu_torch.data.folder import ImageFolder
    from mgproto_tpu_torch.data.transforms import test_transform
    from mgproto_tpu_torch.engine import export
    from mgproto_tpu_torch.engine.eval import Evaluator
    from mgproto_tpu_torch.engine.push import load_push_provenance
    from mgproto_tpu_torch.engine.train import Trainer
    from mgproto_tpu_torch.serving.batcher import BatcherConfig
    from mgproto_tpu_torch.serving.engine import ServingEngine
    from mgproto_tpu_torch.serving.frontend import Frontend
    from mgproto_tpu_torch.serving.replica import ReplicaSet
    from mgproto_tpu_torch.utils import checkpoint as ck

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()  # the mains below are processes of their own
    root = os.path.join(HERE, "build", "input_phase", "train")
    if not os.path.isdir(root):
        write_jpeg_tree(root, INPUT_CLASSES, INPUT_PER_CLASS, INPUT_HW)
    prune_ckpt, push_ckpt = serve_plane_checkpoints()
    run = os.path.dirname(prune_ckpt)
    art = {name: os.path.join(SERVE_PLANE_DIR, f"{name}.mgproto")
           for name in ("prune", "push", "int8")}
    uncal = os.path.join(SERVE_PLANE_DIR, "uncalibrated.mgproto")

    # 1. the export main on both checkpoints, and (e)'s int8 export of the
    #    push checkpoint, as three processes at once
    t0 = time.perf_counter()
    extra = {"prune": {"explain": True}, "push": {}, "int8": {"quantize": "int8"}}
    procs = {name: start_main("export", cli_flags(root, run, no_pretrained=True, checkpoint=ckpt,
                                                 out=art[name], calibrate=True, **extra[name]),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for name, ckpt in (("prune", prune_ckpt), ("push", push_ckpt),
                                ("int8", push_ckpt))}
    for p in procs.values():  # a failed check below must not leave them running
        atexit.register(lambda p=p: p.poll() is None and p.kill())

    # the payloads, made while the exports run: the batch face's npy and
    # stdin lines, and the HTTP bodies (each a distinct id; the JSON text of
    # SERVE_PLANE_BODIES images, encoded once each)
    ds = ImageFolder(root, test_transform(224))
    rng = np.random.default_rng(12)
    pick = rng.choice(len(ds), SERVE_PLANE_IMAGES + 2, replace=False)
    imgs = np.stack([ds.load(int(i))[0] for i in pick]).astype(np.float32)
    npy = os.path.join(SERVE_PLANE_DIR, "images.npy")
    np.save(npy, imgs[:SERVE_PLANE_IMAGES])
    stdin = "\n".join([json.dumps({"id": "json0", "image": imgs[-2].tolist()}), "{not json",
                       json.dumps({"id": "noimage", "pixels": [1]}),
                       json.dumps({"id": "badshape", "image": [[0.0, 1.0]]}),
                       json.dumps({"id": "json1", "image": imgs[-1].tolist()})]) + "\n"
    texts = [json.dumps(imgs[i].tolist()).encode() for i in range(SERVE_PLANE_BODIES)]
    bodies = [b'{"id": "p%d", "image": ' % i + texts[i % len(texts)] + b"}"
              for i in range(SERVE_PLANE_IMAGES)]
    t1 = time.perf_counter()
    json.loads(bodies[0])
    decode_one_s = time.perf_counter() - t1

    exports = {}
    int8_proc = procs.pop("int8")  # collected by (e), so it runs beside 2.-4.
    for name, p in procs.items():
        out, err = p.communicate(timeout=600)
        check(p.returncode == 0, f"cli.export ({name}) exited {p.returncode}:\n{err[-3000:]}")
        exports[name] = last_json(out)
        check(exports[name]["calibrated"] and exports[name]["bytes"] == os.path.getsize(art[name]),
              f"cli.export ({name}): {exports[name]}")
    export_wall_s = time.perf_counter() - t0
    check(exports["prune"]["explain"], "cli.export --explain wrote no explanation table")
    strip_uncalibrated(art["prune"], uncal)
    loaded = export.load_artifact(art["prune"], device="cuda")
    provenance = load_push_provenance(run)
    check(provenance is not None and loaded.explain_table["provenance"]["image_id"]
          == provenance["image_id"], "the run's push provenance is not in the table")

    split_s = {"export": time.perf_counter() - t_phase}  # each step's end, from the phase's start
    # 2. the batch face: --images (64 test images of the folder) and --stdin
    #    (two images as nested lists and three malformed lines), explained;
    #    the network face's process (4.) starts beside it and warms meanwhile
    port = free_port()
    listen_log = open(os.path.join(SERVE_PLANE_DIR, "listen.err"), "w")
    listen = start_main("serve", ["--artifact", art["prune"], "--listen", f"127.0.0.1:{port}",
                                  "--replicas", "2"], stdout=subprocess.PIPE, stderr=listen_log)
    # a failed check below must not leave it running
    atexit.register(lambda: listen.poll() is None and listen.kill())
    t0 = time.perf_counter()
    # the whole batch is admitted before the first dispatch: the queue holds it
    queue = str(2 * SERVE_PLANE_IMAGES)
    serve_telemetry = os.path.join(SERVE_PLANE_DIR, "serve_telemetry")
    warmup_profile = os.path.join(SERVE_PLANE_DIR, "warmup_profile")
    shutil.rmtree(warmup_profile, ignore_errors=True)
    shutil.rmtree(serve_telemetry, ignore_errors=True)
    # with the observatory's (c): request tracing and the warmup's trace
    p = start_main("serve", ["--artifact", art["prune"], "--images", npy, "--stdin", "--explain",
                             "--queue_capacity", queue, "--telemetry_dir", serve_telemetry,
                             "--trace_requests", "--profile_warmup", warmup_profile],
                   stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    out, err = p.communicate(stdin, timeout=600)
    batch_wall_s = time.perf_counter() - t0
    check(p.returncode == 0, f"cli.serve (batch) exited {p.returncode}:\n{err[-3000:]}")
    resps, summary = served_lines(out)
    ids = [f"images.npy[{i}]" for i in range(SERVE_PLANE_IMAGES)] + [
        "json0", "stdin[1]", "stdin[2]", "badshape", "json1"]
    check([r["request_id"] for r in resps] == ids, "the batch face did not answer every id once")
    bad = {r["request_id"]: (r["outcome"], r["reason"]) for r in resps
           if r["request_id"] in ("stdin[1]", "stdin[2]", "badshape")}
    check(bad == {"stdin[1]": ("reject", "bad_dtype"), "stdin[2]": ("reject", "bad_dtype"),
                  "badshape": ("reject", "bad_shape")}, f"malformed lines not rejected typed: {bad}")
    served = [r for r in resps if r["outcome"] in ("predict", "abstain")]
    check(len(served) == SERVE_PLANE_IMAGES + 2 and summary["steady_state_recompiles"] == 0
          and summary["warmup_compiles"] == 4, f"batch face summary {summary}")
    tel_summary = telemetry_dir_check(smi, "12 (b) cli.serve", serve_telemetry,
                                      serving_requests=len(resps))
    warmup_events = reqtrace_and_warmup_check(smi, resps, summary, serve_telemetry,
                                              warmup_profile, tel_summary)

    # the same payloads through from_live on the restored checkpoint, this
    # process, this card, the same buckets: bit-equal
    trainer = Trainer(loaded.evaluator.cfg, steps_per_epoch=1, device="cuda")
    state = ck.restore_checkpoint(prune_ckpt, trainer.init_state(0, for_restore=True))
    live_ev = Evaluator(state.model, state.gmm, loaded.evaluator.cfg, device="cuda")
    live = ServingEngine.from_live(live_ev, calibration=loaded.calibration, explain=True,
                                   explain_top=SERVE_PLANE_TOP_E, provenance=provenance,
                                   queue_capacity=int(queue))
    live.warmup()
    payloads = list(imgs[:SERVE_PLANE_IMAGES]) + [imgs[-2], None, None, [[0.0, 1.0]], imgs[-1]]
    mine = [r.to_dict() for r in live.serve_all(payloads, request_ids=ids)]
    keys = ("request_id", "outcome", "reason", "prediction", "log_px", "confidence",
            "trust_score", "explain")
    diff = [(r["request_id"], [k for k in keys if r.get(k) != m.get(k)])
            for r, m in zip(resps, mine) if any(r.get(k) != m.get(k) for k in keys)]
    check(not diff, f"cli.serve differs from from_live on the same card (id, keys): {diff[:5]}")
    art_eng = ServingEngine.from_loaded(loaded, explain=True)
    art_eng.warmup()
    x = np.stack([imgs[i] for i in range(SERVE_PLANE_IMAGES)] + [imgs[-2], imgs[-1]])
    card, live_out, cpu = [], [], []
    for i in range(0, len(x), 8):
        card.append(art_eng._dispatch(x[i:i + 8]))
        live_out.append(live._dispatch(x[i:i + 8]))
    bit_equal = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                    and np.array_equal(a[2][0], b[2][0]) for a, b in zip(card, live_out))
    check(bit_equal, "the artifact's logits differ from from_live's on the same card and bucket")
    # the plain path on the CPU
    cpu_art = export.load_artifact(art["prune"], device="cpu")
    cpu_eng = ServingEngine.from_loaded(cpu_art, explain=True)
    t0 = time.perf_counter()
    for i in range(0, len(x), 8):
        cpu.append(cpu_eng._dispatch(x[i:i + 8]))
    cpu_s = time.perf_counter() - t0
    cat = [np.concatenate([c[j] if j < 2 else c[2][j - 2] for c in group])
           for group in (card, cpu) for j in range(4)]
    logit_err = float(np.abs(cat[0] - cat[4]).max())
    px_err = float(np.abs(cat[1] - cat[5]).max())
    logd_err = float(np.abs(cat[3] - cat[7]).max())
    gaps = np.abs(np.diff(cat[7], axis=1))
    clear = (gaps > SERVE_ATOL).all(axis=1)
    idx_equal = bool((cat[2][clear] == cat[6][clear]).all())
    # rows with near-ties (prototypes pushed onto one patch tie exactly):
    # each run of log-densities within SERVE_ATOL of its neighbour lists the
    # same prototypes in either order; a run that ends the list may go on
    # past it, so only its one-element case is held
    tie_groups = 0
    for card_idx, cpu_idx, g in zip(cat[2][~clear], cat[6][~clear], gaps[~clear]):
        for grp in np.split(np.arange(len(cpu_idx)), np.flatnonzero(g > SERVE_ATOL) + 1):
            if grp[-1] < len(cpu_idx) - 1 or len(grp) == 1:
                idx_equal &= sorted(card_idx[grp]) == sorted(cpu_idx[grp])
            tie_groups += len(grp) > 1
    check(logit_err <= SERVE_ATOL and px_err <= SERVE_ATOL,
          f"served scores vs the CPU plain path: logits {logit_err}, log p(x) {px_err}")
    check(logd_err <= SERVE_ATOL and idx_equal and clear.sum() >= len(x) // 2,
          f"explanations vs the CPU plain path: logd {logd_err}, idx equal {idx_equal} on "
          f"{int(clear.sum())} clear rows and in the others' {tie_groups} near-tie runs")
    priors = loaded.evaluator.gmm.priors.reshape(-1).cpu().numpy()
    check(bool((priors[cat[2]] > 0).all()), "a pruned prototype was explained")
    dispatch_ms = {}
    for b in art_eng.buckets:
        times = []
        for _ in range(10):
            t1 = time.perf_counter()
            art_eng._dispatch(x[:b])
            times.append((time.perf_counter() - t1) * 1e3)
        dispatch_ms[str(b)] = {"median": float(np.median(times)), "min": float(min(times))}
    del cpu_art, cpu_eng, state, trainer, live

    split_s["batch_face"] = time.perf_counter() - t_phase
    # 3. the plane in this process: 2 replicas over the loaded artifact
    #    behind the HTTP frontend on a loopback port; peak memory for 1 and 2
    def plane(replicas):
        factory = lambda: ServingEngine.from_loaded(loaded)  # noqa: E731
        rs = ReplicaSet(factory, replicas=replicas, batcher_config=BatcherConfig(max_linger_s=0.005))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        rs.start()
        fe = Frontend(rs, poll_interval_s=0.001)
        statuses = []

        async def drive():
            await fe.start()
            loop = asyncio.get_running_loop()
            # the clients' own threads: the frontend's pump steps in the
            # default executor, which blocked clients must not fill
            with concurrent.futures.ThreadPoolExecutor(SERVE_PLANE_CLIENTS) as pool:
                results = await asyncio.gather(*[
                    loop.run_in_executor(pool, http_call, fe.port, "POST", "/v1/predict", b)
                    for b in bodies[:SERVE_PLANE_REQUESTS]])
            statuses.extend(s for s, _, _ in results)
            fe.request_stop()
            await fe.run_until_drained()

        reset_launch_counts()
        asyncio.run(drive())
        launches = launch_counts()
        dispatches = sum(rep.engine.dispatch_count for rep in rs.replicas)
        return rs, statuses, launches, dispatches, {
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "above_loaded_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}

    _, st1, _, _, mem1 = plane(1)
    rs2, st2, plane_launches, plane_dispatches, mem2 = plane(2)
    check(st1 == st2 == [200] * SERVE_PLANE_REQUESTS, f"plane statuses {set(st1)} {set(st2)}")
    check(all(rep.engine.dispatch_count > 0 for rep in rs2.replicas),
          "a replica of the plane served nothing")
    check(plane_launches["score_pool"] == plane_dispatches
          and plane_launches["bn_epilogue"] == 16 * plane_dispatches
          and plane_launches["score_pool_bwd"] == 0 and plane_launches["em_estep"] == 0,
          f"plane launches {plane_launches} over {plane_dispatches} dispatches")
    del rs2

    split_s["plane"] = time.perf_counter() - t_phase
    # 4. the network face as a process: 2 replicas, concurrent clients, the
    #    probes, a committed and a refused swap, then SIGTERM in flight
    p = listen
    try:
        banner = json.loads(p.stdout.readline() or "{}")
        check(banner.get("listening") and banner.get("port") == port,
              f"cli.serve --listen did not come up: {banner}")
        probes = {path: http_call(port, "GET", path)[:2] for path in ("/healthz", "/readyz",
                                                                      "/metrics")}
        check(probes["/healthz"][0] == 200 and probes["/readyz"][0] == 200
              and len(json.loads(probes["/readyz"][1])["replicas"]) == 2
              and b"serving_replicas_ready 2" in probes["/metrics"][1], f"probes {probes}")
        lat, statuses = [], []

        def client(k):
            for j in range(SERVE_PLANE_PER_CLIENT):
                s, b, sec = http_call(port, "POST", "/v1/predict",
                                      bodies[(k * SERVE_PLANE_PER_CLIENT + j) % len(bodies)])
                statuses.append(s)
                lat.append(sec)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,)) for k in range(SERVE_PLANE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        load_s = time.perf_counter() - t0
        n_req = SERVE_PLANE_CLIENTS * SERVE_PLANE_PER_CLIENT
        check(statuses == [200] * n_req, f"network face statuses {sorted(set(statuses))}")
        s, b, swap_s = http_call(port, "POST", "/admin/swap",
                                 json.dumps({"artifact": art["push"]}).encode())
        commit = json.loads(b)
        check(s == 200 and commit["reason"] == "committed" and commit["replicas_swapped"] == 2,
              f"swap to the push artifact: {s} {commit}")
        s, b, refuse_s = http_call(port, "POST", "/admin/swap",
                                   json.dumps({"artifact": uncal}).encode())
        check(s == 409 and json.loads(b)["reason"] == "uncalibrated",
              f"swap to an uncalibrated artifact: {s} {b[:300]}")
        s, b, _ = http_call(port, "POST", "/v1/predict", bodies[0])
        check(s == 200 and json.loads(b)["outcome"] in ("predict", "abstain"),
              "the fleet stopped answering after the refused swap")
        # SIGTERM once every in-flight request's bytes are written
        sent, answers = threading.Barrier(SERVE_PLANE_INFLIGHT + 1), [None] * SERVE_PLANE_INFLIGHT

        def inflight(i):
            body = bodies[i]
            with socket.create_connection(("127.0.0.1", port), timeout=120) as sock:
                sock.sendall(b"POST /v1/predict HTTP/1.1\r\nHost: t\r\nContent-Length: %d\r\n\r\n"
                             % len(body) + body)
                sent.wait(120)
                chunks = []
                while True:
                    c = sock.recv(1 << 16)
                    if not c:
                        break
                    chunks.append(c)
            raw = b"".join(chunks)
            head, _, payload = raw.partition(b"\r\n\r\n")
            answers[i] = (int(head.split()[1]), json.loads(payload))

        threads = [threading.Thread(target=inflight, args=(i,))
                   for i in range(SERVE_PLANE_INFLIGHT)]
        for t in threads:
            t.start()
        sent.wait(120)
        p.send_signal(signal.SIGTERM)
        for t in threads:
            t.join(120)
        out = p.stdout.read()
        rc = p.wait(timeout=120)
    finally:
        if p.poll() is None:
            p.kill()
        listen_log.close()
    check(rc == 0, f"cli.serve --listen exited {rc} after SIGTERM")
    typed = [(s, a.get("outcome"), a.get("reason")) for s, a in answers]
    check(all((s == 200 and o in ("predict", "abstain")) or (s == 503 and r == "shutdown")
              for s, o, r in typed), f"in-flight requests at SIGTERM: {typed}")
    final = json.loads(out.strip().splitlines()[-1])
    check(final["drained"] and final["steady_state_recompiles"] == 0,
          f"network face summary {final}")
    lat_ms = sorted(1e3 * v for v in lat)
    emit("serve_plane", card=smi,
         export={name: {"bytes": e["bytes"], "explain": e["explain"]} for name, e in exports.items()},
         export_wall_s=export_wall_s,
         batch_face={"requests": len(resps), "served": len(served), "wall_s": batch_wall_s,
                     "bit_equal_to_from_live": True, "logits_max_abs_err_vs_cpu": logit_err,
                     "log_px_max_abs_err_vs_cpu": px_err, "explain_logd_max_abs_err_vs_cpu":
                     logd_err, "explain_idx_equal_rows": int(clear.sum()),
                     "explain_near_tie_runs": tie_groups, "cpu_plain_s": cpu_s,
                     "tolerance": SERVE_ATOL},
         dispatch_ms_host=dispatch_ms,
         plane={"dispatches": plane_dispatches, "launches": plane_launches,
                "memory_1_replica": mem1, "memory_2_replicas": mem2},
         network_face={"requests": n_req, "clients": SERVE_PLANE_CLIENTS, "wall_s": load_s,
                       "requests_per_s": n_req / load_s,
                       "p50_ms": lat_ms[len(lat_ms) // 2],
                       "p99_ms": lat_ms[min(len(lat_ms) - 1, int(0.99 * len(lat_ms)))],
                       "json_body_mb": len(bodies[0]) / 1e6,
                       "json_decode_ms_here": decode_one_s * 1e3,
                       "json_decode_server": final.get("json_decode_s"),
                       "swap_commit_s": swap_s, "swap_refused_s": refuse_s,
                       "sigterm_answers": {f"{s} {o} {r}": sum(1 for t in typed if t == (s, o, r))
                                           for s, o, r in set(typed)},
                       "outcomes": final["outcomes"]},
         split_s=split_s, seconds=time.perf_counter() - t_phase)
    out, err = int8_proc.communicate(timeout=600)
    check(int8_proc.returncode == 0,
          f"cli.export --quantize int8 exited {int8_proc.returncode}:\n{err[-3000:]}")
    int8_line = last_json(out)
    check(int8_line["bytes"] == os.path.getsize(art["int8"]), f"cli.export (int8): {int8_line}")
    quant_launches = quant_serve_check(smi, art, imgs[:SERVE_PLANE_IMAGES], int8_line)
    return plane_launches, quant_launches, warmup_events


def quant_serve_check(smi, art, x, export_line):
    """Phase 12 (e): the int8 artifact of the push checkpoint
    (`cli.export --quantize int8 --calibrate`, step 1) served on the card
    beside its dequantize-on-load twin and the f32 push artifact, through
    ServingEngines at buckets 1/2/4/8 on the phase's 64 test images. Held:
    int8 vs twin within TAIL_ATOL (the same f32 weights, so 0 is expected),
    int8 vs the CPU plain path on the dequantized weights within SERVE_ATOL
    (the float64 forward of the twin decides where the CPU departs, as in
    the serve phase), the weights at rest = quant_config's
    total_weight_bytes, the kernels' launches, and the gate drill (the f32
    artifact's unstamped calibration grafted into a copy of the int8 one
    degrades it with quant_mismatch). int8 vs f32 is printed, not gated.
    Returns the launch counts of the int8 engine's serve."""
    import gc
    import shutil

    import numpy as np
    import torch

    from mgproto_tpu_torch.engine import export
    from mgproto_tpu_torch.models.quantized import dequantize_weight, quantized_modules
    from mgproto_tpu_torch.perf.quant import QUANT_TAG_INT8, resident_weight_bytes, weight_rows
    from mgproto_tpu_torch.serving import metrics as sm
    from mgproto_tpu_torch.serving.engine import ServingEngine
    from mgproto_tpu_torch.serving.swap import REJECT_QUANT, verify_head

    t_check = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    check(export_line["quantize"] == "int8" and export_line["calibrated"],
          f"cli.export --quantize int8: {export_line}")
    loaded, engines, memory = {}, {}, {}
    for name, path, deq in (("f32", art["push"], False), ("int8", art["int8"], False),
                            ("twin", art["int8"], True)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        loaded[name] = export.load_artifact(path, device="cuda", dequantize=deq)
        torch.cuda.synchronize()
        memory[name] = {"after_load_mb": (torch.cuda.memory_allocated() - base) / 1e6}
        engines[name] = ServingEngine.from_loaded(loaded[name])
        engines[name].warmup()
    q = loaded["int8"]
    qc = q.meta["quant_config"]
    check(q.calibration.quant_config == QUANT_TAG_INT8 == engines["int8"].quant_config
          and not engines["int8"].gate.degraded,
          f"the int8 artifact is not gated by its stamped calibration: {q.calibration.quant_config!r}")
    resident = resident_weight_bytes(q.evaluator.model, q.proxies)
    check(resident == qc["total_weight_bytes"],
          f"int8 weights at rest {resident} B != quant_config total_weight_bytes "
          f"{qc['total_weight_bytes']} B")
    mods = [m for _, m in quantized_modules(q.evaluator.model)]
    check(len(mods) == qc["num_quantized"] and not list(quantized_modules(
        loaded["twin"].evaluator.model)), "the int8 model's quantized modules are not the block's")

    # the 64 images through each engine, the int8 one's launches counted
    out = {}
    for name, eng in engines.items():
        if name == "int8":
            reset_launch_counts()
            d0 = eng.dispatch_count
        resps = eng.serve_all(list(x))
        if name == "int8":
            launches = launch_counts()
            dispatches = eng.dispatch_count - d0
        check(all(r.outcome in ("predict", "abstain") for r in resps),
              f"{name}: outcomes {sorted(set(r.outcome for r in resps))}")
        parts = [eng._dispatch(x[i:i + 8]) for i in range(0, len(x), 8)]
        out[name] = (np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts]),
                     [r.outcome for r in resps])
    check(launches["score_pool"] == dispatches and launches["bn_epilogue"] == 16 * dispatches
          and launches["score_pool_bwd"] == 0 and launches["em_estep"] == 0,
          f"int8 serve launches {launches} over {dispatches} dispatches")
    twin_err = [float(np.abs(out["int8"][j] - out["twin"][j]).max()) for j in (0, 1)]
    check(max(twin_err) <= TAIL_ATOL, f"int8 vs its twin on the card: {twin_err}")
    ladders = serve_ladders_check(smi, engines, qc, resident)

    # the CPU plain path on the dequantized weights
    t0 = time.perf_counter()
    cpu = export.load_artifact(art["int8"], device="cpu")
    cpu_logits = np.concatenate([cpu.infer(x[i:i + 8])["logits"] for i in range(0, len(x), 8)])
    cpu_s = time.perf_counter() - t0
    cpu_px = np.logaddexp.reduce(cpu_logits.astype(np.float64), axis=-1)
    cpu_err = [float(np.abs(out["int8"][0] - cpu_logits).max()),
               float(np.abs(out["int8"][1] - cpu_px).max())]
    departure = None
    if max(cpu_err) > SERVE_ATOL:
        # ROADMAP §C item 3: the float64 forward of the twin's weights decides
        twin_cpu = export.load_artifact(art["int8"], device="cpu", dequantize=True)
        exact = float64_logits(twin_cpu.evaluator, x)
        card_exact = [float(np.abs(out["int8"][0] - exact).max()),
                      float(np.abs(out["int8"][1] - np.logaddexp.reduce(exact, axis=-1)).max())]
        check(max(card_exact) <= SERVE_ATOL,
              f"int8 on the card vs the CPU plain path {cpu_err}, vs float64 {card_exact}")
        departure = {"card_vs_cpu": cpu_err, "card_vs_float64": card_exact}
    agree = float((out["int8"][0].argmax(-1) == out["f32"][0].argmax(-1)).mean())
    vs_f32 = {"logits_max_abs_diff": float(np.abs(out["int8"][0] - out["f32"][0]).max()),
              "log_px_max_abs_diff": float(np.abs(out["int8"][1] - out["f32"][1]).max()),
              "top1_agreement": agree,
              "outcome_agreement": float(np.mean([a == b for a, b in
                                                  zip(out["int8"][2], out["f32"][2])]))}

    # bucket 8: peak memory over one dispatch and device ms, for each
    xb = torch.from_numpy(np.ascontiguousarray(x[:8])).cuda()
    dispatch_ms = {}
    for name, ld in loaded.items():
        ev = ld.evaluator
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ev(xb)
        torch.cuda.synchronize()
        memory[name]["peak_over_bucket8_dispatch_mb"] = (torch.cuda.max_memory_allocated()
                                                         - base) / 1e6
        # a dispatch issues a few hundred launches: 2 calls behind the spin
        # keep the launch queue from filling; three such readings
        dispatch_ms[name] = [device_ms(lambda ev=ev: ev(xb), iters=2) for _ in range(3)]
    profile = device_breakdown(lambda: loaded["int8"].evaluator(xb), 3)
    # the per-call dequantize alone: its launches and ms in one dispatch
    calls0 = dequantize_weight.calls
    engines["int8"]._dispatch(x[:8])
    dequant_calls = dequantize_weight.calls - calls0
    check(dequant_calls == len(mods), f"{dequant_calls} dequantizes in a dispatch of "
          f"{len(mods)} quantized modules")

    def dequant_all():
        with torch.inference_mode():
            for m in mods:
                m.dequantized_weight(torch.float32)

    dequant_ms = device_ms(dequant_all, iters=5)

    # the gate drill: the f32 artifact's calibration grafted into the int8 one
    grafted = os.path.join(SERVE_PLANE_DIR, "int8_grafted.mgproto")
    shutil.copy(art["int8"], grafted)
    export.embed_calibration(grafted, export.load_calibration(art["push"]))
    prev = sm.set_current_registry(None)
    try:
        eng = ServingEngine.from_artifact(grafted, device="cuda")
        drill = {"degraded": eng.gate.degraded, "quant_mismatch": eng.gate.quant_mismatch,
                 "precision_mismatch": eng.gate.precision_mismatch,
                 "quant_mismatch_total": sm.counter(sm.QUANT_MISMATCHES).value(),
                 "verify_head": verify_head(eng.gate),
                 "weight_bytes_gauge": sm.gauge(sm.QUANT_WEIGHT_BYTES).value()}
    finally:
        sm.set_current_registry(prev)
    check(drill["degraded"] and drill["quant_mismatch"] and not drill["precision_mismatch"]
          and drill["quant_mismatch_total"] == 1 and drill["verify_head"] == REJECT_QUANT
          and drill["weight_bytes_gauge"] == qc["total_weight_bytes"],
          f"the quant gate drill: {drill}")
    seconds = time.perf_counter() - t_check
    emit("quant_serve", card=smi, images=len(x), dispatches=dispatches, launches=launches,
         int8_vs_twin_max_abs=twin_err, twin_tolerance=TAIL_ATOL,
         int8_vs_cpu_max_abs=cpu_err, cpu_tolerance=SERVE_ATOL, cpu_plain_s=cpu_s,
         cpu_reference_departure=departure, int8_vs_f32=vs_f32,
         artifact_bytes={"f32": os.path.getsize(art["push"]),
                         "int8": os.path.getsize(art["int8"])},
         quant_config={k: qc[k] for k in ("num_quantized", "num_skipped", "total_weight_bytes",
                                          "total_f32_bytes", "quantized_weight_bytes")},
         resident_weight_bytes=resident, memory=memory, bucket8_device_ms=dispatch_ms,
         int8_bucket8_profile=profile if profile is not None else "not measured",
         dequantize={"launches_per_dispatch": dequant_calls, "device_ms_per_dispatch": dequant_ms},
         gate_drill=drill, seconds=seconds)
    emit("quant_serve_seconds", seconds=seconds, limit_s=30)
    # (e)'s numbers in the JAX package's quant record schema; phase 15 adds
    # the two trust matrices and gates the record
    # the per-leaf rows by shape math, on the twin's float model
    rows = weight_rows(loaded["twin"].evaluator.model, q.proxies)
    QUANT_RECORD.update(
        artifact=art["int8"], metric="quant", backend="cuda",
        config={"seeded_weights": True, "images": len(x),
                "buckets": list(engines["int8"].buckets),
                "auroc_rederive_tol": 1e-9},
        weights={"rows": rows, "f32_total": int(qc["total_f32_bytes"]),
                 "int8_total": int(qc["total_weight_bytes"]),
                 "num_quantized": qc["num_quantized"], "num_skipped": qc["num_skipped"]},
        parity={"tolerance": QUANT_FLOORS["tolerance"],
                "logit_delta_max_per_sample":
                    np.abs(out["int8"][0] - out["twin"][0]).max(-1).tolist(),
                "log_px_delta": np.abs(out["int8"][1] - out["twin"][1]).tolist(),
                "max_logit_delta": twin_err[0], "max_log_px_delta": twin_err[1]},
        planner=ladders, floors=dict(QUANT_FLOORS),
        drill={"quant_mismatch_total": drill["quant_mismatch_total"],
               "degraded": drill["degraded"], "swap_reject": drill["verify_head"]})
    del engines, loaded, eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# JAX's committed floors of its quant record (evidence/quant_bench.json):
# weight reduction, int8 vs twin parity, the trust deltas, the int8 sketch
QUANT_FLOORS = {"weight_reduction_min": 3.0, "tolerance": 1e-3, "auroc_delta_limit": 0.05,
                "answered_accuracy_delta_limit": 0.1, "px_divergence_limit": 0.25}
QUANT_RECORD = {}  # filled by phase 12 (e), completed and gated by phase 15


def serve_ladders_check(smi, engines, qc, resident):
    """12 (e), the planner's serve ladders (perf/planner.py
    `plan_serve_buckets`) on the f32 and the int8 engines: each bucket's
    program peak measured by one dispatch on the card (the loaded model in
    the baseline), plus the weight term, quant_config's total_f32_bytes
    and total_weight_bytes (= the int8 weights at rest). Planned once
    under the card's budget, then replayed under the budget where every
    int8 bucket just fits: the int8 ladder must be longer than the f32
    one. Returns the record's planner block."""
    from mgproto_tpu_torch.perf.planner import plan_serve_buckets

    weights = {"f32": int(qc["total_f32_bytes"]), "int8": int(qc["total_weight_bytes"])}
    check(weights["int8"] == resident, f"the int8 weight term {weights['int8']} != the weights "
          f"at rest {resident}")
    first, peaks = {}, {}
    for name in ("f32", "int8"):
        fit, outcome = plan_serve_buckets(engines[name], weight_bytes=weights[name])
        check(fit == list(engines[name].buckets),
              f"{name}: buckets {fit} of {engines[name].buckets} fit the card")
        first[name] = outcome
        peaks[name] = {r.candidate.batch: (r.detail["program_peak_bytes"], r.detail)
                       for r in outcome.reports}
    budget = max(p + weights["int8"] for p, _ in peaks["int8"].values())
    block = {"budget_bytes": budget, "per_replica_hbm_drop_bytes": weights["f32"] - weights["int8"]}
    for name in ("f32", "int8"):
        fit, outcome = plan_serve_buckets(
            engines[name], budget_bytes=budget, margin=0.0, weight_bytes=weights[name],
            measure=lambda c, name=name: peaks[name][c.batch])
        block[name] = {"weight_resident_bytes": weights[name], "rows": [
            {"batch": r.candidate.batch, "program_peak_bytes": r.detail["program_peak_bytes"],
             "weight_resident_bytes": r.detail["weight_resident_bytes"],
             "total_bytes": r.peak_bytes, "fits": r.fits} for r in outcome.reports]}
        block[f"{name}_buckets_fit"] = fit
    check(len(block["int8_buckets_fit"]) > len(block["f32_buckets_fit"]),
          f"under {budget} B the int8 ladder {block['int8_buckets_fit']} is not longer than "
          f"the f32 one {block['f32_buckets_fit']}")
    emit("serve_ladders", card=smi, budget_bytes=budget, weight_bytes=weights,
         program_peak_bytes={n: {b: p for b, (p, _) in v.items()} for n, v in peaks.items()},
         baseline_bytes={n: {b: d["baseline_bytes"] for b, (_, d) in v.items()}
                         for n, v in peaks.items()},
         measure_s={n: sum(d["measure_s"] for _, d in v.values()) for n, v in peaks.items()},
         card_budget_bytes=first["int8"].budget_bytes,
         fit={n: block[f"{n}_buckets_fit"] for n in ("f32", "int8")})
    return block


# ----------------------------------------------------------- elastic plane
ASYNC_STEPS = 8  # steps of each mode and dtype in 13 (a)
ASYNC_PROFILE_STEPS = 3
ELASTIC_DIR = os.path.join(HERE, "build", "elastic_phase")
ELASTIC_BURST = 96  # requests submitted at once against one replica (13 b)
ELASTIC_MAX_REPLICAS = 3
ELASTIC_HTTP_CLIENTS = 8
ELASTIC_HTTP_PER_CLIENT = 2
TENANT_PERCENTILES = (("t5", 5.0), ("t25", 25.0), ("t50", 50.0))
TENANT_REQUESTS = 96  # requests of the tenant drill (13 c)
TENANT_MOUNT_AT, TENANT_STORM_AT, TENANT_SWAP_AT = 24, 48, 64
# each engine's queue (a tenant's share: 32 / 4 = 8) and the storm's bursts:
# a burst of 32 puts 16 of the storm tenant's requests on one replica
TENANT_QUEUE, TENANT_BURST = 32, 32
CHAOS_REQUESTS = 48  # requests of the serve chaos drill (13 d)


def stream_overlap_ms(trace_path, bank_kernel="em_estep"):
    """From a chrome trace: the kernels' ms on the stream that ran
    `bank_kernel` (the bank stream), on every other stream, and the ms in
    which both were busy (unions of the kernel spans, intersected)."""
    with open(trace_path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    bank_streams = {e["args"].get("stream") for e in kernels if bank_kernel in e["name"]}

    def union(spans):
        out = []
        for a, b in sorted(spans):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    bank = union((e["ts"], e["ts"] + e["dur"]) for e in kernels
                 if e["args"].get("stream") in bank_streams)
    main = union((e["ts"], e["ts"] + e["dur"]) for e in kernels
                 if e["args"].get("stream") not in bank_streams)
    both, i, j = 0.0, 0, 0
    while i < len(bank) and j < len(main):
        lo, hi = max(bank[i][0], main[j][0]), min(bank[i][1], main[j][1])
        both += max(hi - lo, 0.0)
        if bank[i][1] < main[j][1]:
            i += 1
        else:
            j += 1
    return {"bank_stream_ms": sum(b - a for a, b in bank) / 1e3,
            "main_streams_ms": sum(b - a for a, b in main) / 1e3,
            "overlap_ms": both / 1e3, "bank_streams": sorted(bank_streams, key=str)}


def async_bank_check(smi):
    """13 (a): the flagship at batch 80 from one cloned state with a full
    seeded bank, ASYNC_STEPS steps sync and async, in f32 and bf16, cuDNN
    deterministic. Checks: the async run bit-equal to the one-step-stale
    oracle, its first step's scalars equal the sync first step's, after the
    flush the bank's lengths equal the sync run's, launches per step (steps
    2+) equal the sync step's. Reports each mode's median step
    s (steps 2+), a profile of ASYNC_PROFILE_STEPS steps (idle share) and,
    from its trace, the ms in which bank-stream kernels ran beside
    main-stream ones. Returns the async runs' launch counts and steps."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from mgproto_tpu_torch.config import Config, DataConfig
    from mgproto_tpu_torch.engine.train import Trainer
    from mgproto_tpu_torch.telemetry.monitor import StepMonitor
    from mgproto_tpu_torch.telemetry.registry import MetricRegistry

    # the oracle the CPU and card tests hold the pipeline to
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from _torch_async_oracle import one_step_stale_oracle

    base = Config(data=DataConfig(device_augment=False))
    m = base.model
    rng = np.random.default_rng(13)
    batches = [(rng.normal(size=(TRAIN_BATCH, m.img_size, m.img_size, 3)).astype(np.float32),
                rng.integers(0, m.num_classes, size=TRAIN_BATCH)) for _ in range(ASYNC_STEPS)]
    want = {"score_pool": 1, "bn_epilogue": 16, "score_pool_bwd": 1,
            "em_estep": base.em.num_em_loop}
    os.makedirs(ELASTIC_DIR, exist_ok=True)
    async_launches = dict.fromkeys(want, 0)
    async_steps = 0
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        for dtype in ("float32", "bfloat16"):
            t_dtype = time.perf_counter()
            cfg = base.replace(model=dataclasses.replace(m, compute_dtype=dtype))
            trainers = {mode: Trainer(cfg.replace(em=dataclasses.replace(
                cfg.em, async_bank=mode == "async")), steps_per_epoch=100, device="cuda")
                for mode in ("sync", "async")}
            check(trainers["async"].async_bank and not trainers["sync"].async_bank,
                  "the async_bank field did not resolve as set")
            src = trainers["sync"].init_state(seed=0)
            src.memory = full_bank(m, seed=1)
            runs = {}
            # the observatory's (d): each step's overlap estimate into a
            # StepMonitor's bank_dispatch_overlap_fraction gauge
            gauge_reg = MetricRegistry()
            monitor = StepMonitor(registry=gauge_reg)
            for mode, tr in trainers.items():
                st = copy.deepcopy(src)  # the modes' configs differ in async_bank only
                torch.cuda.synchronize()
                reset_launch_counts()
                step_s, losses, per_step, mets = [], [], [], []
                for images, labels in batches:
                    before = launch_counts()
                    t0 = time.perf_counter()
                    st, met = tr.train_step(st, images, labels, use_mine=True, update_gmm=True)
                    torch.cuda.synchronize()
                    step_s.append(time.perf_counter() - t0)
                    if mode == "async":
                        monitor.observe_step(TRAIN_BATCH, step_s[-1], check_recompiles=False,
                                             bank_overlap_seconds=tr.bank_overlap_step_s)
                    per_step.append({k: v - before[k] for k, v in launch_counts().items()})
                    losses.append(met.loss.clone())
                    mets.append(met)
                    check(not met.nonfinite and bool(torch.isfinite(met.loss)),
                          f"{dtype} {mode} step: loss {met.loss.item()}")
                if mode == "async":
                    async_steps += ASYNC_STEPS
                    for k, v in launch_counts().items():
                        async_launches[k] += v
                before = launch_counts()
                st, flushed = tr.flush_bank(st)
                torch.cuda.synchronize()
                flush_launches = {k: v - before[k] for k, v in launch_counts().items()}
                if mode == "async":  # the flushed bank phase is the last step's
                    for k, v in flush_launches.items():
                        async_launches[k] += v
                check((flushed is None) == (mode == "sync"), f"{mode}: flush returned {flushed}")
                runs[mode] = dict(state=st, step_s=step_s, losses=losses, per_step=per_step,
                                  mets=mets, flush_launches=flush_launches)
            sync, asy = runs["sync"], runs["async"]
            # the first async step is the first sync step's trunk, no bank yet
            m0s, m0a = sync["mets"][0], asy["mets"][0]
            for k in ("loss", "cross_entropy", "mine", "aux", "accuracy"):
                check(torch.equal(getattr(m0a, k), getattr(m0s, k)),
                      f"{dtype}: the first async step's {k} differs from the sync step's")
            check((m0a.em_active, m0a.em_compact_fallback) == (0, 0),
                  f"{dtype}: the fill step reports a bank {m0a.em_active}")
            # every queue stays full in both modes; the cursors may differ:
            # a step enqueues its K top-1 patches per sample deduplicated,
            # and which patches those are depends on the means the trunk
            # scored, one bank phase apart (the oracle check below holds the
            # async run's bank bit for bit)
            check(torch.equal(asy["state"].memory.length, sync["state"].memory.length),
                  f"{dtype}: the flushed bank's lengths differ from the sync run's")
            cursor_diff = int((asy["state"].memory.cursor
                               != sync["state"].memory.cursor).sum())
            for i in range(1, ASYNC_STEPS):
                check(asy["per_step"][i] == sync["per_step"][i] == want,
                      f"{dtype} step {i}: launches async {asy['per_step'][i]}, "
                      f"sync {sync['per_step'][i]}, expected {want}")
            check(asy["flush_launches"]["em_estep"] == want["em_estep"],
                  f"{dtype}: the flush launched {asy['flush_launches']}")
            # the oracle: the sync trainer's functions on the async schedule
            ost, olosses = one_step_stale_oracle(trainers["sync"], copy.deepcopy(src), batches)
            torch.cuda.synchronize()
            bad = state_mismatches(asy["state"], ost)
            check(not bad and all(torch.equal(a, b) for a, b in zip(asy["losses"], olosses)),
                  f"{dtype}: the async run differs from the one-step-stale oracle in {bad[:6]}")
            del ost
            profiles = {}
            for mode, tr in trainers.items():
                st, it = runs[mode]["state"], iter(batches * 2)
                cell = {"state": st}

                def step(tr=tr, it=it, cell=cell):
                    cell["state"], _ = tr.train_step(cell["state"], *next(it), use_mine=True,
                                                     update_gmm=True)

                trace = os.path.join(ELASTIC_DIR, f"trace_{dtype}_{mode}.json")
                rec = device_breakdown(step, ASYNC_PROFILE_STEPS, trace=trace)
                tr.flush_bank(cell["state"])
                if rec is None:
                    profiles[mode] = "not measured (no device events)"
                    continue
                profiles[mode] = {"device_idle_share": rec["device_idle_share"],
                                  "device_busy_ms_per_step": rec["device_busy_ms_per_call"],
                                  "wall_ms_per_step": rec["wall_ms_per_call"],
                                  "device_ms_per_step": rec["device_ms_per_call"]}
                if mode == "async":
                    streams = stream_overlap_ms(trace)
                    profiles[mode].update(
                        {f"{k}_per_step": v / ASYNC_PROFILE_STEPS for k, v in streams.items()
                         if k.endswith("_ms")}, bank_streams=streams["bank_streams"])
            overlap = gauge_reg.gauge("bank_dispatch_overlap_fraction").value(phase="train")
            check(0.0 < overlap <= 1.0,
                  f"{dtype}: bank_dispatch_overlap_fraction {overlap} on the async steps")
            bank_ms = (profiles["async"].get("bank_stream_ms_per_step")
                       if isinstance(profiles["async"], dict) else None)
            emit("obs", card=smi, part="bank_overlap_gauge", dtype=dtype,
                 bank_dispatch_overlap_fraction=overlap, bank_stream_ms_per_step=bank_ms,
                 async_median_step_s=float(np.median(runs["async"]["step_s"][1:])))
            emit("elastic", card=smi, part="async_bank", dtype=dtype, steps=ASYNC_STEPS,
                 cudnn_deterministic=True,
                 median_step_s={k: float(np.median(r["step_s"][1:])) for k, r in runs.items()},
                 step_s={k: r["step_s"] for k, r in runs.items()},
                 losses={k: [float(x) for x in r["losses"]] for k, r in runs.items()},
                 launches_per_step={k: r["per_step"][1] for k, r in runs.items()},
                 flush_launches=asy["flush_launches"], bit_equal_to_oracle=True,
                 first_step_equal=True, flushed_lengths_equal=True,
                 classes_cursor_differs_from_sync=cursor_diff, profile=profiles,
                 seconds=time.perf_counter() - t_dtype)
            del runs, trainers, src
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    return async_launches, async_steps


def elastic_images(n):
    """`n` test-transformed images of the input phase's folder (written when
    this phase runs alone), as f32 [n, 224, 224, 3], and their folder
    labels: (root, images, labels)."""
    import numpy as np

    from mgproto_tpu_torch.data.folder import ImageFolder
    from mgproto_tpu_torch.data.transforms import test_transform

    root = os.path.join(HERE, "build", "input_phase", "train")
    if not os.path.isdir(root):
        write_jpeg_tree(root, INPUT_CLASSES, INPUT_PER_CLASS, INPUT_HW)
    ds = ImageFolder(root, test_transform(224))
    pick = np.random.default_rng(21).choice(len(ds), n, replace=False)
    rows = [ds.load(int(i)) for i in pick]
    return (root, np.stack([r[0] for r in rows]).astype(np.float32),
            np.asarray([r[1] for r in rows], np.int64))


def elastic_artifact(root):
    """Phase 12's `push` artifact, exported here when that phase did not run."""
    path = os.path.join(SERVE_PLANE_DIR, "push.mgproto")
    if not os.path.exists(path):
        from mgproto_tpu_torch.cli import export as cli_export

        _, push_ckpt = serve_plane_checkpoints()
        cli_export.main(cli_flags(root, os.path.dirname(push_ckpt), no_pretrained=True,
                                  checkpoint=push_ckpt, out=path, calibrate=True))
    return path


def autoscale_check(smi, loaded, imgs):
    """13 (b), in process: a ReplicaSet of the artifact starting at one
    replica, Autoscaler(1, ELASTIC_MAX_REPLICAS) ticking on the pump. A
    burst of ELASTIC_BURST requests at once must scale up to >= 2, a calm
    window back to 1, and every request get a prediction or a typed shed.
    Returns the launch counts and dispatches of the run."""
    import gc

    import torch

    from mgproto_tpu_torch.serving.autoscale import Autoscaler, AutoscalerConfig
    from mgproto_tpu_torch.serving.batcher import BatcherConfig
    from mgproto_tpu_torch.serving.engine import ServingEngine
    from mgproto_tpu_torch.serving.replica import ReplicaSet

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    rs = ReplicaSet(lambda: ServingEngine.from_loaded(loaded), replicas=1,
                    batcher_config=BatcherConfig(max_linger_s=0.005))
    rs.start()
    scaler = Autoscaler(rs, AutoscalerConfig(
        min_replicas=1, max_replicas=ELASTIC_MAX_REPLICAS, interval_s=0.05,
        up_cooldown_s=0.1, down_patience=3, down_cooldown_s=0.2))
    reset_launch_counts()
    out, ready_s, t0 = [], [], time.perf_counter()
    ids = [f"b{i}" for i in range(ELASTIC_BURST)]
    for i, rid in enumerate(ids):
        out.extend(rs.submit(imgs[i % len(imgs)], request_id=rid))
    peak_replicas = 1
    while len({r.request_id for r in out}) < len(ids) or len(rs.replicas) > 1:
        pending = [r for r in rs.replicas if r.engine is None]
        t_poll = time.perf_counter()
        out.extend(rs.poll())
        ready_s += [time.perf_counter() - t_poll for r in pending if r.engine is not None]
        d = scaler.tick()
        if d is not None:
            out.extend(d.responses)
        peak_replicas = max(peak_replicas, len(rs.replicas))
        check(time.perf_counter() - t0 < 120, f"the autoscale drill did not settle: {scaler.status()}")
    torch.cuda.synchronize()
    launches = launch_counts()
    dispatches = sum(r.engine.dispatch_count for r in rs.replicas if r.engine is not None)
    answered = sorted(r.request_id for r in out)
    outcomes = {o: sum(r.outcome == o for r in out) for o in ("predict", "abstain", "shed")}
    ups = [d for d in scaler.decisions if d.direction == "up"]
    downs = [d for d in scaler.decisions if d.direction == "down"]
    check(answered == sorted(ids), "the autoscale drill dropped or repeated a request")
    check(all(r.outcome in ("predict", "abstain") or (r.outcome == "shed" and r.reason)
              for r in out), "an untyped answer in the autoscale drill")
    check(ups and peak_replicas >= 2 and downs and len(rs.replicas) == 1,
          f"autoscale: peak {peak_replicas} replicas, {len(ups)} up, {len(downs)} down")
    check(rs.steady_recompiles == 0, f"autoscale: {rs.steady_recompiles} cold dispatches")
    emit("elastic", card=smi, part="autoscale", burst=ELASTIC_BURST, outcomes=outcomes,
         peak_replicas=peak_replicas, replica_ready_s=ready_s,
         decisions=[d.to_dict() for d in scaler.decisions], status=scaler.status(),
         launches=launches, dispatches=dispatches, seconds=time.perf_counter() - t0,
         memory={"loaded_gb": base_gb, "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches, dispatches


def tenants_check(smi, loaded, imgs):
    """13 (c): three tenants (the artifact's calibration at the 5th, 25th
    and 50th percentile) on one 2-replica fleet; a fourth mounted mid-load;
    MGPROTO_CHAOS_TENANT_STORM_AT sends the rest of the load to one tenant
    (which sheds its own tail only); MGPROTO_CHAOS_TENANT_BAD_SWAP=1 strips
    that tenant's next head swap, which is refused while the others serve
    on. Checks 0 cold dispatches, 1 / 16 / 0 / 0 launches a dispatch, and
    one image's scores equal under every tenant. Returns the launches and
    dispatches."""
    from mgproto_tpu_torch.resilience import chaos
    from mgproto_tpu_torch.serving.batcher import BatcherConfig
    from mgproto_tpu_torch.serving.engine import ServingEngine
    from mgproto_tpu_torch.serving.replica import ReplicaSet
    from mgproto_tpu_torch.serving.tenants import TenantDirectory

    cal, fp = loaded.calibration, loaded.meta.get("gmm_fingerprint")
    d = TenantDirectory()
    for name, pct in TENANT_PERCENTILES:
        d.mount(name, cal, percentile=pct, expected_fingerprint=fp)
    rs = ReplicaSet(lambda: ServingEngine.from_loaded(loaded, tenants=d,
                                                      queue_capacity=TENANT_QUEUE),
                    replicas=2, batcher_config=BatcherConfig(max_linger_s=0.005))
    rs.start()
    prev = chaos.set_active(chaos.ChaosState(chaos.plan_from_env({
        "MGPROTO_CHAOS_TENANT_STORM_AT": str(TENANT_STORM_AT),
        "MGPROTO_CHAOS_TENANT_BAD_SWAP": "1"})))
    t0 = time.perf_counter()
    names = [n for n, _ in TENANT_PERCENTILES]
    out, mount, swaps = [], None, []
    try:
        reset_launch_counts()
        calm = 0  # requests not sent to the storm tenant, which rotate over the tenants
        for i in range(TENANT_REQUESTS):
            # from the storm on, three requests in four go to one tenant
            storm = chaos.get_active().tenant_storm_due(i)
            if storm and i % 4 != 3:
                tenant = "t25"
            else:
                tenant, calm = names[calm % len(names)], calm + 1
            out.extend(rs.submit(imgs[0] if i < 4 else imgs[i % len(imgs)],
                                 request_id=f"t{i}", tenant=tenant))
            if i == 3:
                # one image under three tenants, in buckets of 2 on both replicas
                out.extend(rs.flush())
            if i == TENANT_MOUNT_AT:
                mount = d.mount("t4", cal, expected_fingerprint=fp).to_dict()
                names.append("t4")
            if i == TENANT_SWAP_AT:
                swaps = [d.swap("t25", cal, expected_fingerprint=fp, percentile=25.0).to_dict()
                         for _ in range(2)]
            if i > 3 and not storm:
                out.extend(rs.poll())
            elif storm and i % TENANT_BURST == TENANT_BURST - 1:  # the storm comes in bursts
                out.extend(rs.flush())
        out.extend(rs.flush())
        launches = launch_counts()
        injections = dict(chaos.get_active().injections)
    finally:
        chaos.set_active(prev)
    dispatches = sum(r.engine.dispatch_count for r in rs.replicas)
    check(sorted(r.request_id for r in out) == sorted(f"t{i}" for i in range(TENANT_REQUESTS)),
          "the tenant drill dropped or repeated a request")
    sheds = {(r.tenant, r.reason) for r in out if r.outcome == "shed"}
    check(sheds and {t for t, _ in sheds} == {"t25"}, f"tenant sheds {sheds}")
    check([s["reason"] for s in swaps] == ["uncalibrated", "committed"], f"tenant swaps {swaps}")
    check(rs.steady_recompiles == 0, f"tenants: {rs.steady_recompiles} cold dispatches")
    check(launches["score_pool"] == dispatches and launches["bn_epilogue"] == 16 * dispatches
          and launches["score_pool_bwd"] == 0 and launches["em_estep"] == 0,
          f"tenant launches {launches} over {dispatches} dispatches")
    first = [r for r in out if r.request_id in ("t0", "t1", "t2", "t3")]
    check(len({(r.log_px, r.prediction, r.confidence) for r in first}) == 1
          and len({r.tenant for r in first}) == 3,
          f"one image scored differently across tenants: {[r.to_dict() for r in first]}")
    labels = {}
    for r in out:
        if r.outcome in ("predict", "abstain"):
            labels.setdefault(r.tenant, {}).setdefault(r.outcome, 0)
            labels[r.tenant][r.outcome] += 1
    after_swap = [r for r in out if r.tenant != "t25" and r.outcome in ("predict", "abstain")
                  and int(r.request_id[1:]) > TENANT_SWAP_AT]
    check(after_swap, "no other tenant served after the refused swap")
    emit("elastic", card=smi, part="tenants", requests=TENANT_REQUESTS, mount=mount,
         swaps=swaps, sheds=sorted(map(list, sheds)), outcomes_by_tenant=labels,
         thresholds={n: d.gate_for(n).threshold for n in names}, launches=launches,
         dispatches=dispatches, steady_state_recompiles=rs.steady_recompiles,
         injections=injections, tenant_scores_equal=True,
         served_after_the_refused_swap=len(after_swap),
         seconds=time.perf_counter() - t0)
    return launches, dispatches


def serve_chaos_check(smi, loaded, imgs):
    """13 (d): MGPROTO_CHAOS_SERVE_REPLICA_KILL_AT and _DEVICE_ERRORS on a
    2-replica fleet of the artifact: every request answered typed, the
    killed replica detected by its stale heartbeat and restarted."""
    from mgproto_tpu_torch.resilience import chaos
    from mgproto_tpu_torch.serving.batcher import BatcherConfig
    from mgproto_tpu_torch.serving.engine import ServingEngine
    from mgproto_tpu_torch.serving.replica import ReplicaSet

    rs = ReplicaSet(lambda: ServingEngine.from_loaded(loaded), replicas=2,
                    heartbeat_timeout_s=0.2, restart_base_delay_s=0.05,
                    batcher_config=BatcherConfig(max_linger_s=0.005))
    rs.start()
    prev = chaos.set_active(chaos.ChaosState(chaos.plan_from_env({
        "MGPROTO_CHAOS_SERVE_REPLICA_KILL_AT": "10",
        "MGPROTO_CHAOS_SERVE_DEVICE_ERRORS": "3,4"})))
    t0 = time.perf_counter()
    out = []
    try:
        for i in range(CHAOS_REQUESTS):
            out.extend(rs.submit(imgs[i % len(imgs)], request_id=f"c{i}"))
            out.extend(rs.poll())
        # until every request is answered and the killed replica is back
        while (len({r.request_id for r in out}) < CHAOS_REQUESTS
               or not all(r.responsive() for r in rs.replicas)):
            out.extend(rs.poll())
            check(time.perf_counter() - t0 < 60, "the serve chaos drill did not settle")
        restarted_s = time.perf_counter() - t0
        out.extend(rs.flush())
        injections = dict(chaos.get_active().injections)
    finally:
        chaos.set_active(prev)
    from mgproto_tpu_torch.serving import metrics as _m

    check(sorted(r.request_id for r in out) == sorted(f"c{i}" for i in range(CHAOS_REQUESTS)),
          "the serve chaos drill dropped or repeated a request")
    check(all(r.outcome in ("predict", "abstain") or r.reason for r in out),
          "an untyped answer in the serve chaos drill")
    restarts = _m.counter(_m.REPLICA_RESTARTS).value(reason="dead")
    check(injections.get("serve_replica_kill") == 1 and injections.get("serve_device_error") == 2
          and restarts >= 1 and sum(r.restarts for r in rs.replicas) >= 1,
          f"serve chaos: injections {injections}, restarts {restarts}")
    emit("elastic", card=smi, part="serve_chaos", requests=CHAOS_REQUESTS,
         outcomes={f"{o} {r}": sum(1 for x in out if (x.outcome, x.reason) == (o, r))
                   for o, r in sorted({(x.outcome, x.reason) for x in out}, key=str)},
         injections=injections, replica_restarts=restarts, settled_s=restarted_s,
         replicas=[{"name": r.name, "state": r.state, "restarts": r.restarts}
                   for r in rs.replicas], seconds=time.perf_counter() - t0)


def autoscale_http_check(smi, listen, port, bodies):
    """13 (b), the network face: `cli.serve --listen --autoscale 1:3` under
    ELASTIC_HTTP_CLIENTS clients; reports GET /admin/autoscale before and
    after the load, then drains it with SIGTERM."""
    import signal
    import threading

    banner = json.loads(listen.stdout.readline() or "{}")
    check(banner.get("listening") and banner.get("autoscale") == f"1:{ELASTIC_MAX_REPLICAS}",
          f"cli.serve --autoscale did not come up: {banner}")
    s0, b0, _ = http_call(port, "GET", "/admin/autoscale")
    statuses, lat = [], []

    def client(k):
        for j in range(ELASTIC_HTTP_PER_CLIENT):
            s, _, sec = http_call(port, "POST", "/v1/predict",
                                  bodies[(k * ELASTIC_HTTP_PER_CLIENT + j) % len(bodies)])
            statuses.append(s)
            lat.append(sec)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,)) for k in range(ELASTIC_HTTP_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    load_s = time.perf_counter() - t0
    s1, b1, _ = http_call(port, "GET", "/admin/autoscale")
    listen.send_signal(signal.SIGTERM)
    out, _ = listen.communicate(timeout=120)
    n = ELASTIC_HTTP_CLIENTS * ELASTIC_HTTP_PER_CLIENT
    with open(os.path.join(ELASTIC_DIR, "listen.err")) as f:
        err = f.read()
    check(s0 == s1 == 200 and listen.returncode == 0 and statuses == [200] * n,
          f"the autoscaled network face: {s0} {s1} exit {listen.returncode} "
          f"statuses {sorted(set(statuses))}: {err[-2000:]}")
    summary = json.loads(out.strip().splitlines()[-1])
    emit("elastic", card=smi, part="autoscale_http", clients=ELASTIC_HTTP_CLIENTS, requests=n,
         load_s=load_s, requests_per_s=n / load_s, p50_ms=sorted(lat)[n // 2] * 1e3,
         status_before=json.loads(b0), status_after=json.loads(b1),
         summary_outcomes=summary.get("outcomes"),
         steady_state_recompiles=summary.get("steady_state_recompiles"))


def elastic_phase(smi):
    """Phase 13; returns ({part: launch counts}, async steps, serve-plane
    dispatches)."""
    import atexit
    import gc
    import shutil

    import torch

    from mgproto_tpu_torch.engine import export

    t_phase = time.perf_counter()
    shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    os.makedirs(ELASTIC_DIR)
    root, imgs, _ = elastic_images(32)
    art = elastic_artifact(root)
    # the network face starts first: it loads and warms while the rest runs
    port = free_port()
    listen_log = open(os.path.join(ELASTIC_DIR, "listen.err"), "w")
    listen = start_main("serve", ["--artifact", art, "--listen", f"127.0.0.1:{port}",
                                  "--replicas", "1", "--autoscale", f"1:{ELASTIC_MAX_REPLICAS}",
                                  "--autoscale_interval_s", "0.1"],
                        stdout=subprocess.PIPE, stderr=listen_log)
    atexit.register(lambda: listen.poll() is None and listen.kill())
    bodies = [b'{"id": "a%d", "image": ' % i + json.dumps(imgs[i].tolist()).encode() + b"}"
              for i in range(ELASTIC_HTTP_CLIENTS)]
    split_s = {}
    async_launches, async_steps = async_bank_check(smi)
    split_s["async_bank"] = time.perf_counter() - t_phase
    gc.collect()
    torch.cuda.empty_cache()
    base = os.path.join(ELASTIC_DIR, "drills")
    drill_launches = cli_drill_check(smi, os.path.join(HERE, "build", "input_phase", "train"),
                                     base, async_bank=True)
    shutil.rmtree(base, ignore_errors=True)
    split_s["async_drills"] = time.perf_counter() - t_phase
    loaded = export.load_artifact(art, device="cuda")
    serve_launches, serve_dispatches = autoscale_check(smi, loaded, imgs)
    tenant_launches, tenant_dispatches = tenants_check(smi, loaded, imgs)
    serve_chaos_check(smi, loaded, imgs)
    split_s["in_process_plane"] = time.perf_counter() - t_phase
    autoscale_http_check(smi, listen, port, bodies)
    split_s["network_face"] = time.perf_counter() - t_phase
    emit("elastic", card=smi, part="done", split_s=split_s,
         seconds=time.perf_counter() - t_phase)
    launches = {"async": async_launches, "async_drills": drill_launches,
                "autoscale": serve_launches, "tenants": tenant_launches}
    return launches, async_steps, serve_dispatches + tenant_dispatches


ONLINE_DIR = os.path.join(HERE, "build", "online_phase")
ONLINE_IMAGES = 64  # the --images batch of (a) and (b), from the input phase's folder
ONLINE_PERCENTILE = 10.0  # the capture gate of (b)
ONLINE_MEANS_ATOL = 1e-4  # consolidation on the card vs the CPU plain path
ONLINE_PRIORS_ATOL = 1e-5
ONLINE_BANK_ATOL = 1e-4
# a sample whose top-1 patch differs between the card and the CPU must be a
# near tie in the CPU's own densities: its top-1 margin within twice the
# serve check's tolerance (the `clear` rule of serve_phase); and near ties
# are rare (0 or 1 of 64 samples on the card so far)
ONLINE_TIE_MARGIN = 2 * SERVE_ATOL
ONLINE_MAX_TIES = 2
ONLINE_TENANT_REQUESTS = 48  # requests a tenant in (d)
ONLINE_TENANT_DRIFT = 0.5  # px divergence threshold of the tenants' monitors, in IQRs
ONLINE_DRILL_POISON = 0.05  # MGPROTO_CHAOS_ONLINE_POISON_RATE of (c)'s drills
# drift-drill gates whose verdict depends on the seeded data and weights (the
# JAX package's own drill fails each on some seed); phase 14 holds them to
# the CPU plain path's verdicts on the same seeded state
DATA_GATES = ("drill.accuracy_dipped_under_drift", "drill.accuracy_recovered_after_republish",
              "drill.poison_never_capture_eligible")


def online_calibration_dir(root):
    """A class folder of the input phase's first image of each class
    (symlinks) under ONLINE_DIR: (b)'s process calibrates on it, 200
    decodes instead of 800, beside the drills."""
    calib = os.path.join(ONLINE_DIR, "calib")
    if not os.path.isdir(calib):
        for cls in sorted(os.listdir(root)):
            first = sorted(os.listdir(os.path.join(root, cls)))[0]
            os.makedirs(os.path.join(calib, cls))
            os.symlink(os.path.join(root, cls, first), os.path.join(calib, cls, first))
    return calib


def start_split_check(smi, art, npy):
    """14 (a): two fresh `cli.serve --artifact --images` processes, the
    second after the first; each one's `start_split` and wall seconds.
    The second builds no kernel library (the directory's files unchanged)."""
    from mgproto_tpu_torch.ops import _build

    runs = []
    for i in range(2):
        before = sorted(os.listdir(_build.BUILD_DIR))
        code, out, err, wall = run_main("serve", ["--artifact", art, "--images", npy], 300)
        check(code == 0, f"start split process {i}: exit {code}\n{err[-3000:]}")
        summary = last_json(out)
        check(summary.get("summary") and summary["outcomes"].get("predict", 0) > 0,
              f"start split process {i}: {summary}")
        split = summary["start_split"]
        built = sorted(set(os.listdir(_build.BUILD_DIR)) - set(before))
        runs.append({"wall_s": wall, "start_split": split, "parts_s": sum(split.values()),
                     "outside_parts_s": wall - sum(split.values()), "new_build_files": built})
    check(not runs[1]["new_build_files"], f"the second process built {runs[1]['new_build_files']}")
    check(set(runs[0]["start_split"]) >= {"import", "cuda_context", "kernel_load", "artifact_read",
                                          "model_build", "warmup"},
          f"start split parts {sorted(runs[0]['start_split'])}")
    emit("online", card=smi, part="start_split", runs=runs)
    return runs


def consolidation_vs_cpu(trainer, state, ckpt, samples):
    """The same samples consolidated batch by batch (ONLINE_WIDTH each) from
    the `ckpt` state on the card (`trainer`, `state`) and on the CPU plain
    path. After each batch the two enqueues are compared: a sample whose
    top-1 patch list (per prototype of its class) differs enqueues other
    rows, so its class is set apart; it must be a near tie in the CPU's own
    densities (margin <= ONLINE_TIE_MARGIN where the lists differ), and at
    most ONLINE_MAX_TIES samples may differ. Returns (card consolidator, CPU
    consolidator, the classes set apart, the CPU margins of the samples
    whose lists differ, CPU seconds a batch)."""
    import torch

    from mgproto_tpu_torch.config import Config
    from mgproto_tpu_torch.engine.train import Trainer
    from mgproto_tpu_torch.online.consolidate import Consolidator, ConsolidatorConfig
    from mgproto_tpu_torch.utils.checkpoint import restore_checkpoint

    ctrainer = Trainer(Config(), steps_per_epoch=1, device="cpu")
    cstate = restore_checkpoint(ckpt, ctrainer.init_state(0, for_restore=True))
    cfg = ConsolidatorConfig(batch_width=ONLINE_WIDTH)
    card, cpu = Consolidator(trainer, state, config=cfg), Consolidator(ctrainer, cstate, config=cfg)
    apart, margins, cpu_s = set(), [], 0.0
    for i in range(0, len(samples), ONLINE_WIDTH):
        chunk = samples[i:i + ONLINE_WIDTH]
        card.ingest(chunk)
        t0 = time.perf_counter()
        cpu.ingest(chunk)
        cpu_s += time.perf_counter() - t0
        (gtop, _, gvalid), (ctop, cmargin, cvalid) = card.last_enqueue, cpu.last_enqueue
        k = gtop.shape[1]
        # the valid masks are the dedup of each sample's top-1 list: they
        # differ only in a sample whose list does
        protos = (gtop.cpu() != ctop)[:len(chunk)]  # [n, K]
        vrows = (gvalid.cpu() != cvalid).reshape(-1, k)[:len(chunk)].any(-1)
        check(not (vrows & ~protos.any(-1)).any(),
              "enqueue valid masks differ in a sample whose top-1 list agrees")
        for j in torch.nonzero(protos.any(-1)).flatten().tolist():
            margin = cmargin[j][protos[j]].max().item()
            margins.append(margin)
            apart.add(chunk[j].class_id)
            check(margin <= ONLINE_TIE_MARGIN,
                  f"sample {i + j}: the card's top-1 patch differs from the CPU's where the CPU's "
                  f"top-1 margin is {margin} > {ONLINE_TIE_MARGIN} (not a near tie)")
    check(len(margins) <= ONLINE_MAX_TIES,
          f"{len(margins)} samples' top-1 lists differ card vs CPU (at most {ONLINE_MAX_TIES})")
    return card, cpu, apart, margins, cpu_s / max(cpu.batches, 1)


def online_vs_cpu_check(ckpt, imgs, labels):
    """14 (b), the part that times nothing (run beside the phase's
    processes): the samples, the serving state's engine and its answers
    before any consolidation; the same samples consolidated on the card and
    on the CPU plain path from the same state (`consolidation_vs_cpu`);
    served logits bit-equal after that consolidation; a Republisher commit
    through hot_swap on 2 replicas whose answers equal from_live on the
    candidate. Returns what `online_consolidation_check` reads."""
    import copy

    import numpy as np
    import torch

    from mgproto_tpu_torch.config import Config
    from mgproto_tpu_torch.engine.eval import Evaluator
    from mgproto_tpu_torch.engine.train import Trainer
    from mgproto_tpu_torch.online.capture import CapturedSample
    from mgproto_tpu_torch.online.drift import DriftReport
    from mgproto_tpu_torch.online.republish import Republisher
    from mgproto_tpu_torch.serving.batcher import BatcherConfig
    from mgproto_tpu_torch.serving.calibration import calibrate
    from mgproto_tpu_torch.serving.engine import ServingEngine
    from mgproto_tpu_torch.serving.replica import ReplicaSet
    from mgproto_tpu_torch.utils.checkpoint import restore_checkpoint

    trainer = Trainer(Config(), steps_per_epoch=1, device="cuda")
    state = restore_checkpoint(ckpt, trainer.init_state(0, for_restore=True))
    serving_ev = Evaluator(state.model, state.gmm, trainer.cfg, device="cuda")
    eng = ServingEngine.from_live(serving_ev, buckets=(8,))
    eng.warmup()
    before = eng.infer_fn(imgs[:8])
    samples = [CapturedSample(img, int(c), None, f"o{i}", True)
               for i, (img, c) in enumerate(zip(imgs, labels))]

    def served_unmoved(what):
        after = eng.infer_fn(imgs[:8])
        check(all(np.array_equal(before[k], after[k]) for k in ("logits", "log_px")),
              f"served logits moved with the candidate ({what})")

    # the same samples on the card and on the CPU plain path, batch by batch
    card, cpu, apart, margins, cpu_s = consolidation_vs_cpu(trainer, state, ckpt, samples)
    served_unmoved("the card-vs-CPU consolidation")
    batches = card.batches
    same = torch.ones(trainer.cfg.model.num_classes, dtype=torch.bool)
    same[sorted(apart)] = False
    means_d = (card.gmm.means.detach().cpu() - cpu.gmm.means.detach()).abs().amax((1, 2))
    priors_d = (card.gmm.priors.cpu() - cpu.gmm.priors).abs().amax(-1)
    len_d = card.memory.length.cpu() != cpu.memory.length
    row_err = (card.memory.feats.cpu() - cpu.memory.feats).abs().amax(-1)  # [C, cap]
    means_err, priors_err = means_d[same].max().item(), priors_d[same].max().item()
    bad_rows = int((row_err > ONLINE_BANK_ATOL).sum())
    check(means_err <= ONLINE_MEANS_ATOL, f"consolidated means: card vs CPU {means_err}")
    check(priors_err <= ONLINE_PRIORS_ATOL, f"consolidated priors: card vs CPU {priors_err}")
    check(not len_d[same].any(), f"bank lengths differ in classes "
          f"{torch.nonzero(len_d & same).flatten().tolist()} whose enqueues agree")
    check(not (row_err[same] > ONLINE_BANK_ATOL).any(),
          f"bank rows differ beyond {ONLINE_BANK_ATOL} in classes whose enqueues agree")
    # a class set apart holds up to K other bank rows a near tie: its
    # means and priors are still held, to what those rows can move in the
    # EM rounds run (an Adam step moves a mean coordinate by about mean_lr;
    # a round moves a prior by (1 - tau) times the change of its
    # responsibility sum over the bank's capacity)
    em, k = trainer.cfg.em, trainer.cfg.model.prototypes_per_class
    rounds = em.num_em_loop * batches
    apart_means_atol = 2 * em.mean_lr * rounds
    apart_priors_atol = 2 * (1 - em.tau) * rounds * k * len(margins) / card.memory.feats.shape[1]
    apart_means = means_d[~same].max().item() if apart else None
    apart_priors = priors_d[~same].max().item() if apart else None
    if apart:
        check(apart_means <= apart_means_atol,
              f"means of the classes set apart: card vs CPU {apart_means} > {apart_means_atol}")
        check(apart_priors <= apart_priors_atol,
              f"priors of the classes set apart: card vs CPU {apart_priors} > {apart_priors_atol}")
    compare = {"samples_whose_top1_lists_differ": len(margins),
               "cpu_top1_margins_where_lists_differ": margins,
               "classes_set_apart": len(apart),
               "bank_rows_differ": bad_rows,
               "bank_lengths_differ": int(len_d.sum()),
               "means_max_abs_err_vs_cpu": means_err,
               "priors_max_abs_err_vs_cpu": priors_err,
               "means_max_abs_err_set_apart": apart_means,
               "priors_max_abs_err_set_apart": apart_priors,
               "set_apart_atol": {"means": apart_means_atol, "priors": apart_priors_atol},
               "cpu_ms_per_batch": 1e3 * cpu_s}
    del cpu

    # the Republisher through hot_swap on 2 replicas, from the card's candidate
    calib = calibrate(serving_ev, [imgs[i:i + 8] for i in range(0, len(imgs), 8)])
    rs = ReplicaSet(lambda: ServingEngine.from_live(serving_ev, calibration=calib,
                                                    buckets=(1, 8)),
                    replicas=2, batcher_config=BatcherConfig(max_linger_s=0.0))
    rs.start()
    pending = {}

    def recalibrate():
        cand = card.candidate_state(state)
        ev = Evaluator(copy.deepcopy(cand.model), cand.gmm, trainer.cfg, device="cuda")
        pending["ev"] = ev
        return calibrate(ev, [imgs[i:i + 8] for i in range(0, len(imgs), 8)])

    def factory_for(calibration):
        return lambda: ServingEngine.from_live(pending["ev"], calibration=calibration,
                                               buckets=(1, 8))

    commits = []
    rep = Republisher(rs, recalibrate, factory_for, min_interval_s=0.0, on_commit=commits.append)
    breach = DriftReport(t=0.0, px_divergence=1.0, mean_shift_max=0.0, cov_shift_max=0.0,
                         class_shifts={}, breached=True, signals=("px",))
    rep.maybe_republish(breach)
    rec = rep.maybe_republish(breach)
    check(rec is not None and rec.result == "committed", f"republish {rec and rec.to_dict()}")
    check(pending["ev"].model is not state.model, "the candidate engine shares the model")
    want_r = ServingEngine.from_live(pending["ev"], calibration=commits[0],
                                     buckets=(1, 8)).serve_all(list(imgs[:8]))
    got = []
    for i, row in enumerate(imgs[:8]):
        got.extend(rs.submit(row, request_id=f"req{i}"))
    got.extend(rs.flush())
    got.sort(key=lambda r: r.request_id)
    check([(r.prediction, r.log_px, r.trust) for r in got]
          == [(r.prediction, r.log_px, r.trust) for r in want_r],
          "the republished fleet answers differently from from_live on the candidate")
    served_unmoved("the republish")
    return {"trainer": trainer, "state": state, "samples": samples,
            "served_unmoved": served_unmoved, "vs_cpu": compare,
            "republish": rec.to_dict()["result"]}


def online_consolidation_check(smi, ctx):
    """14 (b), timed, with no other process on the card: the samples
    ingested by a fresh Consolidator of the serving state (the card-vs-CPU
    comparison paid the process's first launches at this width); ms a
    batch; peak GB above what the process held; launches a batch;
    `steady_recompiles` 0, and still 0 after a second ingest; served
    logits bit-equal. Returns the launch counts of the timed ingest."""
    import gc

    import torch

    from mgproto_tpu_torch.online.consolidate import Consolidator, ConsolidatorConfig

    trainer, state, samples = ctx["trainer"], ctx["state"], ctx["samples"]
    cfg = ConsolidatorConfig(batch_width=ONLINE_WIDTH)
    gc.collect()
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    cons = Consolidator(trainer, state, config=cfg)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = cons.ingest(samples)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 - base_gb
    ctx["served_unmoved"]("the timed consolidation")
    batches = report.batches
    want = {"score_pool": batches, "bn_epilogue": 16 * batches, "score_pool_bwd": 0,
            "em_estep": trainer.cfg.em.num_em_loop * batches}
    check(launches == want, f"consolidation launches {launches}, want {want}")
    check(cons.steady_recompiles() == 0, f"steady_recompiles {cons.steady_recompiles()}")
    # a second ingest at the same width: no new shape, no build
    cons.ingest(samples[:ONLINE_WIDTH // 2])
    check(cons.steady_recompiles() == 0, "a second ingest changed shape or built a kernel")
    emit("online", card=smi, part="full_width", width=ONLINE_WIDTH, samples=len(samples),
         batches=batches, launches=launches, ms_per_batch=1e3 * ingest_s / batches,
         peak_gb_above_model=peak_gb, em_active_max=report.em_active_max,
         compact_fallbacks=report.compact_fallbacks, steady_recompiles=cons.steady_recompiles(),
         vs_cpu=ctx["vs_cpu"], served_bit_equal_across_consolidation=True,
         republish=ctx["republish"], republished_answers_equal_from_live=True)
    return launches


def online_serve_process_check(smi, started):
    """14 (b): the --online checkpoint face's process, read: captured > 0,
    consolidation runs >= 1, samples equal to captured."""
    code, wall = started.wait(timeout=600)
    with open(started.out) as f:
        text = f.read()
    check(code == 0, f"cli.serve --online: exit {code}\n{text[-3000:]}")
    summary = last_json(text)
    online = summary.get("online") or {}
    cap, cons = online.get("capture", {}), online.get("consolidation", {})
    check(cap.get("accepted", 0) > 0, f"--online captured nothing: {online}")
    check(cons.get("runs", 0) >= 1 and cons.get("samples") == cap.get("accepted"),
          f"--online consolidation {cons} vs capture {cap}")
    emit("online", card=smi, part="serve_online_process", online=online,
         outcomes=summary["outcomes"], steady_state_recompiles=summary["steady_state_recompiles"],
         start_split=summary.get("start_split"), wall_s=wall)


def online_drill_check(smi, drills, serve):
    """14 (c) and (d)'s online poison: `cli.online drill --device cuda` with
    each drift kind, as processes under MGPROTO_CHAOS_ONLINE_POISON_RATE;
    each record's gate verdicts equal the same drill's on the CPU plain path
    in this process (the seeded state is the same); the gates that hold by
    construction pass (detection via p(x) before the correction, a committed
    republish, zero drops, zero cold dispatches and steady recompiles); the
    poisoned requests are counted, and the shift drill captures none (the
    new-class drill's count is the CPU's, reported); the new class claims
    slot 4."""
    from mgproto_tpu_torch.online.drill import run_drill

    # the CPU references while the processes run, then (b)'s process
    cpus = {kind: run_drill(drift_kind=kind, device="cpu", poison_rate=ONLINE_DRILL_POISON)
            for kind in drills}
    online_serve_process_check(smi, serve)
    out = {}
    for kind, started in drills.items():
        code, wall = started.wait(timeout=600)
        path, cpu = started.out, cpus[kind]
        check(os.path.exists(path), f"drill {kind}: exit {code}, no record")
        with open(path) as f:
            rec = json.loads(f.read())
        verdicts = {r["key"]: r["ok"] for r in rec["gates"]["rows"]}
        check(verdicts == {r["key"]: r["ok"] for r in cpu["gates"]["rows"]},
              f"drill {kind}: card gates {verdicts} vs CPU {cpu['gates']['rows']}")
        check(code == (0 if rec["gates"]["ok"] else 1), f"drill {kind}: exit {code}")
        # the gates the data decide (the dip, the recovery, the poison the
        # gate lets through) are held to the CPU's verdicts above; these hold
        # by construction
        structural = {k: v for k, v in verdicts.items() if k not in DATA_GATES}
        check(all(structural.values()), f"drill {kind}: {structural}")
        o = rec["online"]
        check(o["poison"]["injected"] > 0
              and (kind != "shift" or o["poison"]["capture_eligible"] == 0),
              f"drill {kind}: poison {o['poison']}")
        if kind == "new_class":
            check(o["new_class_slot"] == 4 and o["labeled_feedback"] > 0,
                  f"new class slot {o['new_class_slot']}")
        out[kind] = {"wall_s": wall, "exit": code, "gates": verdicts,
                     "republish_by_result": o["republish_by_result"],
                     "first_breach_t": (o["detection"]["first_breach"] or {}).get("t"),
                     "first_commit_t": o["detection"]["first_commit_t"],
                     "cpu_first_breach_t": (cpu["online"]["detection"]["first_breach"]
                                            or {}).get("t"),
                     "served_accuracy": [w["served_accuracy"] for w in o["accuracy_windows"]],
                     "cpu_served_accuracy": [w["served_accuracy"]
                                             for w in cpu["online"]["accuracy_windows"]],
                     "consolidation": o["consolidation"], "poison": o["poison"],
                     "cpu_poison": cpu["online"]["poison"],
                     "steady_state_recompiles": rec["steady_state_recompiles"],
                     "new_class_slot": o["new_class_slot"]}
    emit("online", card=smi, part="drift_drill", drills=out)


def online_tenants_poison_check(smi, loaded, imgs):
    """14 (d): three tenants with per-tenant drift monitors and capture
    reservoirs on a 2-replica fleet of the artifact, with
    MGPROTO_CHAOS_TENANT_POISON_RATE junk in the storm tenant's lane: only
    that tenant's monitor breaches (the poison the storm tenant's reservoir
    staged is reported: the seeded flagship's p(x) does not separate it)."""
    import numpy as np

    from mgproto_tpu_torch.online.capture import CaptureConfig
    from mgproto_tpu_torch.online.drift import DriftConfig
    from mgproto_tpu_torch.resilience import chaos
    from mgproto_tpu_torch.serving.batcher import BatcherConfig
    from mgproto_tpu_torch.serving.engine import ServingEngine
    from mgproto_tpu_torch.serving.replica import ReplicaSet
    from mgproto_tpu_torch.serving.tenants import TenantDirectory

    cal, fp = loaded.calibration, loaded.meta.get("gmm_fingerprint")
    c = int(loaded.meta["num_classes"])
    t0 = time.perf_counter()
    d = TenantDirectory()
    drift_cfg = DriftConfig(px_window=ONLINE_TENANT_REQUESTS, min_px_samples=24,
                            eval_interval_s=0.0, px_divergence_threshold=ONLINE_TENANT_DRIFT,
                            mean_shift_threshold=0.0)
    cap_cfg = CaptureConfig(percentile=ONLINE_PERCENTILE, capacity_per_class=64)
    names = ("t0", "t1", "t2")
    for name in names:
        d.mount(name, cal, expected_fingerprint=fp, drift_config=drift_cfg,
                capture_config=cap_cfg, num_classes=c)
    rs = ReplicaSet(lambda: ServingEngine.from_loaded(loaded, tenants=d, queue_capacity=256),
                    replicas=2, batcher_config=BatcherConfig(max_linger_s=0.005))
    rs.start()
    prev = chaos.set_active(chaos.ChaosState(chaos.plan_from_env({
        "MGPROTO_CHAOS_TENANT_POISON_RATE": "0.5", "MGPROTO_CHAOS_SEED": "3"})))
    poisoned, out, seq = set(), [], 0
    try:
        for i in range(len(names) * ONLINE_TENANT_REQUESTS):
            tenant = names[i % len(names)]
            x = imgs[i % len(imgs)]
            if tenant == "t0":
                if chaos.get_active().tenant_poison_due(seq):
                    x = (x * 6.0 - 3.0).astype(np.float32)
                    poisoned.add(f"q{i}")
                seq += 1
            out.extend(rs.submit(x, request_id=f"q{i}", tenant=tenant))
            if i % 8 == 7:
                out.extend(rs.poll())
        out.extend(rs.flush())
        tenant_injections = dict(chaos.get_active().injections)
    finally:
        chaos.set_active(prev)
    check(len({r.request_id for r in out}) == len(names) * ONLINE_TENANT_REQUESTS,
          "the tenant poison drill dropped a request")
    breaches = {n: d.head_for(n).drift.breaches for n in names}
    check(breaches["t0"] > 0 and breaches["t1"] == 0 and breaches["t2"] == 0,
          f"tenant drift breaches {breaches}")
    divergence = {n: d.head_for(n).drift.last_report.px_divergence for n in names}
    emit("online", card=smi, part="tenants_poison", breaches=breaches,
         px_divergence=divergence, tenant_poison_injected=tenant_injections.get("tenant_poison"),
         storm_poison_staged=sum(d.head_for("t0").capture.was_captured(r) for r in poisoned),
         captures={n: d.head_for(n).capture.stats()["accepted"] for n in names},
         steady_state_recompiles=rs.steady_recompiles, seconds=time.perf_counter() - t0)


class Started:
    """A process started now; a thread records when it ends (so a check
    that reads it later still gets its own wall seconds)."""

    def __init__(self, proc, out=None):
        import threading

        self.proc, self.out, self.t0, self.t1 = proc, out, time.perf_counter(), None

        def watch():
            proc.wait()
            self.t1 = time.perf_counter()

        threading.Thread(target=watch, daemon=True).start()

    def wait(self, timeout):
        code = self.proc.wait(timeout=timeout)
        while self.t1 is None:
            time.sleep(0.01)
        return code, self.t1 - self.t0


def online_background():
    """Phase 14's processes, started together: (b)'s `cli.serve --online` on
    the checkpoint of phase 12's `push` artifact and (c)'s two drills."""
    import numpy as np

    root, imgs, labels = elastic_images(ONLINE_IMAGES)
    npy = os.path.join(ONLINE_DIR, "x.npy")
    np.save(npy, imgs)
    art = elastic_artifact(root)
    _, push_ckpt = serve_plane_checkpoints()
    serve_out = os.path.join(ONLINE_DIR, "serve_online.out")
    serve = Started(start_main(
        "serve", cli_flags(online_calibration_dir(root), os.path.dirname(push_ckpt),
                           no_pretrained=True, checkpoint=push_ckpt, calibrate=True, online=True,
                           online_capture_percentile=ONLINE_PERCENTILE, images=npy,
                           num_workers=2),
        stdout=open(serve_out, "w"), stderr=subprocess.STDOUT), serve_out)
    drills = {}
    for kind in ("shift", "new_class"):
        path = os.path.join(ONLINE_DIR, f"drill_{kind}.json")
        drills[kind] = Started(start_main(
            "online", ["drill", "--device", "cuda", "--drift-kind", kind, "--out", path],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            env={"MGPROTO_CHAOS_ONLINE_POISON_RATE": str(ONLINE_DRILL_POISON)}), path)
    import atexit

    procs = [serve.proc] + [d.proc for d in drills.values()]
    atexit.register(lambda: [p.kill() for p in procs if p.poll() is None])
    return {"root": root, "imgs": imgs, "labels": labels, "npy": npy, "art": art,
            "push_ckpt": push_ckpt, "serve": serve, "drills": drills}


def reset_online_dir():
    import shutil

    shutil.rmtree(ONLINE_DIR, ignore_errors=True)
    os.makedirs(ONLINE_DIR)


def online_phase(smi):
    """Phase 14; returns the launch counts of (b)'s timed consolidation on
    the card. Its three processes ((b)'s `cli.serve --online`, (c)'s
    drills) start first, together; the in-process checks that time nothing
    run beside them ((b)'s card-vs-CPU comparison and republish, (d), the
    drills' CPU references); then, with no other process on the card, the
    start split (a) and (b)'s timed consolidation."""
    import gc

    import torch

    from mgproto_tpu_torch.engine import export

    t_phase = time.perf_counter()
    split_s = {}
    reset_online_dir()
    st = online_background()
    procs = [st["serve"].proc] + [d.proc for d in st["drills"].values()]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ctx = online_vs_cpu_check(st["push_ckpt"], st["imgs"], st["labels"])
        split_s["vs_cpu_and_republish"] = time.perf_counter() - t_phase
        online_tenants_poison_check(smi, export.load_artifact(st["art"], device="cuda"),
                                    st["imgs"])
        split_s["tenants_poison"] = time.perf_counter() - t_phase
        online_drill_check(smi, st["drills"], st["serve"])
        split_s["processes"] = time.perf_counter() - t_phase
        gc.collect()
        torch.cuda.empty_cache()
        start_split_check(smi, st["art"], st["npy"])
        split_s["start_split"] = time.perf_counter() - t_phase
        launches = online_consolidation_check(smi, ctx)
        split_s["timed_consolidation"] = time.perf_counter() - t_phase
    finally:
        torch.backends.cudnn.deterministic = deterministic
        for p in procs:
            if p.poll() is None:
                p.kill()
    emit("online", card=smi, part="done", split_s=split_s, seconds=time.perf_counter() - t_phase)
    return launches


TRUST_DIR = os.path.join(HERE, "build", "trust_phase")
TRUST_MAX_SAMPLES = 64  # requests a cell of (a)'s full-width matrix
TRUST_CORRUPT_ATOL = 1e-6  # the ladder on the card vs the CPU (tests/test_torch_corrupt.py)
TRUST_TIE_MARGIN = 2 * SERVE_ATOL  # an outcome may differ only this near the threshold
TRUST_DRILL = dict(seed=0, per_class=8, bootstrap_epochs=12,
                   config_overrides={"monotone_tol": 0.30})  # (c): tests' reduced size
TRUST_DRILL_SCORE_ATOL = 1e-4


@contextlib.contextmanager
def instances_of(cls):
    """The instances of `cls` made inside the block, in a list."""
    made = []
    init = cls.__init__

    def record(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    cls.__init__ = record
    try:
        yield made
    finally:
        cls.__init__ = init


def trust_child(argv):
    """`python3 chip_smoke.py --trust-child matrix ...`: `cli.trust.main`
    on that argv, as `python -m mgproto_tpu_torch.cli.trust` runs it, then
    one JSON line of what the process saw: its launch counts, its engines'
    dispatches (warmup included) and the seconds of `main`."""
    from mgproto_tpu_torch.cli import trust as cli_trust
    from mgproto_tpu_torch.serving.engine import ServingEngine

    with instances_of(ServingEngine) as engines:
        t0 = time.perf_counter()
        code = cli_trust.main(argv)
        seconds = time.perf_counter() - t0
    print(json.dumps({"trust_child": {
        "launches": launch_counts(), "seconds": seconds,
        "dispatches": sum(e.dispatch_count for e in engines),
        "warmup_dispatches": sum(len(e.warmup_report) for e in engines)}}), flush=True)
    return code


def trust_trees():
    """(the input phase's folder, the schedule phase's OoD folder), written
    when those phases did not run."""
    root = os.path.join(HERE, "build", "input_phase", "train")
    if not os.path.isdir(root):
        write_jpeg_tree(root, INPUT_CLASSES, INPUT_PER_CLASS, INPUT_HW)
    ood = os.path.join(HERE, "build", "schedule_phase", "ood")
    if not os.path.isdir(ood):
        write_jpeg_tree(ood, OOD_CLASSES, OOD_PER_CLASS, INPUT_HW, seed=7)
    return root, ood


def trust_vs_cpu_check(art, root):
    """15 (b), times nothing: the ID cell's first chunk and each kind's
    severity-5 first chunk (the matrix's chunks: 8 images of the input
    folder, 224 px), corrupted and served on the card and on the CPU plain
    path from the same artifact. Corrupted images within
    TRUST_CORRUPT_ATOL; served log p(x) within SERVE_ATOL, or where the CPU
    departs, the card's within it of the float64 forward; outcomes equal
    but where the CPU's score lies within TRUST_TIE_MARGIN of the
    threshold."""
    import argparse

    import numpy as np

    from mgproto_tpu_torch.cli import trust as cli_trust
    from mgproto_tpu_torch.cli.common import add_train_args, config_from_args
    from mgproto_tpu_torch.engine import export
    from mgproto_tpu_torch.ops.corrupt import CORRUPTION_KINDS
    from mgproto_tpu_torch.serving.engine import ServingEngine
    from mgproto_tpu_torch.trust.matrix import corrupt_chunks

    p = argparse.ArgumentParser()
    add_train_args(p)
    cfg = config_from_args(p.parse_args(["--train_dir", root, "--push_dir", root, "--test_dir",
                                         root, "--num_workers", "0"]))
    images, _, _ = cli_trust._matrix_sets(cfg, 8, "cpu")
    card_art, cpu_art = (export.load_artifact(art, device=d) for d in ("cuda", "cpu"))
    card_eng, cpu_eng = (ServingEngine.from_loaded(a) for a in (card_art, cpu_art))
    card_eng.warmup()
    card_eng.check_cold_dispatches()
    thr = cpu_eng.gate.threshold
    cells = {"id": (images, images)}
    corrupt_err = {}
    for kind in CORRUPTION_KINDS:
        card = corrupt_chunks(images, kind, 5, 0, 8, "cuda")
        cpu = corrupt_chunks(images, kind, 5, 0, 8, "cpu")
        corrupt_err[kind] = float(np.abs(card - cpu).max())
        cells[f"{kind}:5"] = (card, cpu)
    out = {"corrupt_max_abs_err": corrupt_err, "cells": {}}
    for name, (card_x, cpu_x) in cells.items():
        ids = [f"{name}:{i}" for i in range(len(card_x))]
        card_r = card_eng.serve_all(list(card_x), request_ids=ids)
        cpu_r = cpu_eng.serve_all(list(cpu_x), request_ids=ids)
        card_px = np.array([r.log_px for r in card_r])
        cpu_px = np.array([r.log_px for r in cpu_r])
        err = float(np.abs(card_px - cpu_px).max())
        departure = None
        if err > SERVE_ATOL:
            exact = np.logaddexp.reduce(float64_logits(cpu_art.evaluator, cpu_x), axis=-1)
            card_exact = float(np.abs(card_px - exact).max())
            check(card_exact <= SERVE_ATOL,
                  f"trust {name}: served log p(x) vs CPU {err}, vs float64 {card_exact}")
            departure = {"card_vs_cpu": err, "card_vs_float64": card_exact,
                         "cpu_vs_float64": float(np.abs(cpu_px - exact).max())}
        differ = [i for i, (a, b) in enumerate(zip(card_r, cpu_r)) if a.outcome != b.outcome]
        near = [i for i in differ if abs(cpu_px[i] - thr) <= TRUST_TIE_MARGIN]
        check(differ == near, f"trust {name}: outcomes differ away from the threshold at "
                              f"{[(i, cpu_px[i], thr) for i in differ if i not in near]}")
        out["cells"][name] = {"log_px_max_abs_err": err, "cpu_reference_departure": departure,
                              "outcomes_differ_near_threshold": len(near),
                              "outcomes": [r.outcome for r in card_r]}
    check(max(corrupt_err.values()) <= TRUST_CORRUPT_ATOL,
          f"trust: corruption on the card vs the CPU {corrupt_err} > {TRUST_CORRUPT_ATOL}")
    check(card_eng.check_cold_dispatches() == 0, "trust (b): a cold dispatch")
    return out


def trust_drill_check():
    """15 (c), times nothing: `matrix --synthetic` at the reduced size on the
    card and on the CPU in this process, from the same seeded state: the
    gates' verdicts equal, outcome counts equal but where the CPU's score
    is a near tie with the threshold, scores within
    TRUST_DRILL_SCORE_ATOL. The card run's own launches, read around it
    and around each of its bootstrap batches: every bootstrap batch
    launches score_pool 1, the epilogue 0 (the tiny trunk has no residual
    tail) and the E-step num_em_loop, and the run as a whole exactly its
    bootstrap batches, calibration batches, warmup and matrix dispatches
    (one score_pool each) and nothing else."""
    import math

    import numpy as np

    from mgproto_tpu_torch.cli.trust import run_synthetic_matrix, synthetic_config
    from mgproto_tpu_torch.online.consolidate import Consolidator
    from mgproto_tpu_torch.serving.engine import ServingEngine

    batch_launches = []
    consolidate = Consolidator._consolidate

    def counted(self, *a, **kw):
        before = launch_counts()
        out = consolidate(self, *a, **kw)
        batch_launches.append({k: v - before[k] for k, v in launch_counts().items()})
        return out

    Consolidator._consolidate = counted
    try:
        with instances_of(ServingEngine) as engines:
            reset_launch_counts()
            card = run_synthetic_matrix(device="cuda", **TRUST_DRILL)
            drill_launches = launch_counts()
    finally:
        Consolidator._consolidate = consolidate
    cpu = run_synthetic_matrix(device="cpu", **TRUST_DRILL)
    verdicts = [(r["key"], r["ok"]) for r in card["gates"]["rows"]]
    check(verdicts == [(r["key"], r["ok"]) for r in cpu["gates"]["rows"]],
          f"trust drill: card verdicts {verdicts} vs CPU {cpu['gates']['rows']}")
    check(card["steady_state_recompiles"] == 0 and not card["degraded"],
          f"trust drill: recompiles {card['steady_state_recompiles']}")
    thr = cpu["config"]["threshold_log_px"]
    score_err, ties = 0.0, 0

    def cells(r):
        return [r["id"]] + r["pairs"] + [c for k in sorted(r["ladder"]) for c in r["ladder"][k]]

    for a, b in zip(cells(card), cells(cpu)):
        if a["outcomes"] != b["outcomes"]:
            ties += 1
            check(any(abs(s - thr) <= TRUST_TIE_MARGIN for s in b["scores"]),
                  f"trust drill: outcomes {a['outcomes']} vs CPU {b['outcomes']} with no near tie")
        else:
            score_err = max(score_err, float(np.abs(np.subtract(a["scores"], b["scores"])).max()))
    check(score_err <= TRUST_DRILL_SCORE_ATOL, f"trust drill: scores differ by {score_err}")

    # what the card run must have launched: each bootstrap ingest of
    # bootstrap_per_class (8) images is one width-8 batch; the calibration
    # two batches a class; warmup one dispatch a bucket; the matrix one
    # dispatch a bucket-8 chunk of each cell
    drill = card["synthetic_drill"]
    num_em_loop = synthetic_config(drill["classes"]).em.num_em_loop
    bootstrap = drill["bootstrap_epochs"] * drill["classes"]
    calibration = 2 * drill["classes"]
    check(len(engines) == 1, f"trust drill: {len(engines)} engines")
    engine = engines[0]
    warmup = len(engine.warmup_report)
    matrix = sum(math.ceil(c["n"] / engine.buckets[-1]) for c in cells(card))
    one_batch = {"score_pool": 1, "bn_epilogue": 0, "score_pool_bwd": 0, "em_estep": num_em_loop}
    check(len(batch_launches) == bootstrap and all(b == one_batch for b in batch_launches),
          f"trust drill: {len(batch_launches)} bootstrap batches (want {bootstrap}), launches "
          f"{[b for b in batch_launches if b != one_batch][:3]} where {one_batch}")
    check(warmup == len(engine.buckets) and engine.dispatch_count == matrix,
          f"trust drill: {warmup} warmup and {engine.dispatch_count} matrix dispatches, "
          f"want {len(engine.buckets)} and {matrix}")
    want = {"score_pool": bootstrap + calibration + warmup + matrix, "bn_epilogue": 0,
            "score_pool_bwd": 0, "em_estep": bootstrap * num_em_loop}
    check(drill_launches == want, f"trust drill launches {drill_launches}, want {want}")
    return {"verdicts": dict(verdicts), "gates_ok": card["gates"]["ok"],
            "outcome_cells_differ_near_threshold": ties, "score_max_abs_err": score_err,
            "drill_launches": drill_launches,
            "drill_counts": {"bootstrap_batches": bootstrap, "calibration_batches": calibration,
                             "warmup_dispatches": warmup, "matrix_dispatches": matrix},
            "bootstrap_batch_launches": batch_launches[-1],
            "pairs_auroc": {p["pair"]: p["auroc"] for p in card["pairs"]}}


def corruption_chunk_ms():
    """ms per corruption chunk (B = 8, 224 px) of each kind at severity 5 on
    the card, the seeds already there (device time, `device_ms`)."""
    import numpy as np
    import torch

    from mgproto_tpu_torch.ops.corrupt import CORRUPTION_KINDS, make_corrupt_fn, per_sample_seeds

    x = torch.from_numpy(np.random.default_rng(5).normal(size=(8, 224, 224, 3))
                         .astype(np.float32)).cuda()
    seeds = torch.from_numpy(per_sample_seeds(0, 8).astype(np.int64)).cuda()
    out = {}
    for kind in CORRUPTION_KINDS:
        fn = make_corrupt_fn(kind, 5)
        # noise launches ~150 kernels a chunk: few calls, or the launch queue
        # fills behind the spin
        out[kind] = device_ms(lambda: fn(x, seeds), iters=3)
    return out


def quant_record_check(smi, f32_report, root, ood):
    """15 (d): the quant record of the card in the JAX package's schema
    (`cli.telemetry check --quant`'s input): phase 12 (e)'s per-leaf weight
    rows, int8-vs-twin parity per sample, serve ladders and gate drill,
    with (a)'s f32 report and the same matrix run here, in process, on
    (e)'s int8 artifact. `check --quant` on it must exit 0. The weights are
    seeded, not trained: the AUROC and accuracy deltas between f32 and
    int8 are measured where both sit near chance (ROADMAP A item 4's gap)."""
    from mgproto_tpu_torch.cli import telemetry as cli_telemetry
    from mgproto_tpu_torch.cli import trust as cli_trust

    check(bool(QUANT_RECORD), "15 (d): phase 12 (e) did not run in this process")
    t0 = time.perf_counter()
    path = os.path.join(TRUST_DIR, "trust_report_int8.json")
    code, _ = captured(cli_trust.main, [
        "matrix", "--artifact", QUANT_RECORD["artifact"], "--device", "cuda",
        "--max_samples", str(TRUST_MAX_SAMPLES), "--train_dir", root, "--push_dir", root,
        "--test_dir", root, "--ood_dir", ood, "--out", path])
    matrix_s = time.perf_counter() - t0
    with open(path) as f:
        int8_report = json.load(f)
    record = {k: v for k, v in QUANT_RECORD.items() if k != "artifact"}
    record["trust"] = {"f32": f32_report, "int8": int8_report}
    rec_path = os.path.join(TRUST_DIR, "quant_record.json")
    with open(rec_path, "w") as f:
        json.dump(record, f)
    qcode, text = captured(cli_telemetry.main, ["check", "--quant", rec_path, "--json"])
    result = json.loads(text)
    failed = [r for r in result["rows"] if not r["ok"]]
    check(qcode == 0 and result["ok"], f"15 (d): check --quant on the card's record exited "
          f"{qcode}: {failed}")
    rows = {r["key"]: r["value"] for r in result["rows"]}
    emit("quant_record", card=smi, int8_matrix_exit=code, int8_matrix_s=matrix_s,
         check_exit=qcode, checked=result["checked"], failed=result["failed"],
         weight_reduction=rows.get("quant.weight_reduction_floor"),
         auroc_delta={k: v for k, v in rows.items() if k.startswith("quant.auroc_delta")},
         ladders={k: record["planner"][f"{k}_buckets_fit"] for k in ("f32", "int8")},
         record=os.path.relpath(rec_path, HERE), seeded_weights=True,
         seconds=time.perf_counter() - t0)


def trust_phase(smi):
    """Phase 15; returns the launch counts of (a)'s full-width matrix
    process and its dispatches. (a)'s process starts first; (b) and (c),
    which time nothing, run beside it; the corruption chunks are timed
    after it exits."""
    import shutil

    t_phase = time.perf_counter()
    split_s = {}
    shutil.rmtree(TRUST_DIR, ignore_errors=True)
    os.makedirs(TRUST_DIR)
    root, ood = trust_trees()
    art = elastic_artifact(root)
    report_path = os.path.join(TRUST_DIR, "trust_report.json")
    log = os.path.join(TRUST_DIR, "matrix.out")
    matrix = Started(subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--trust-child", "matrix", "--artifact", art,
         "--device", "cuda", "--max_samples", str(TRUST_MAX_SAMPLES), "--train_dir", root,
         "--push_dir", root, "--test_dir", root, "--ood_dir", ood, "--out", report_path],
        cwd=HERE, text=True, env=dict(os.environ, PYTHONUNBUFFERED="1"),
        stdout=open(log, "w"), stderr=subprocess.STDOUT), log)
    try:
        vs_cpu = trust_vs_cpu_check(art, root)
        split_s["vs_cpu"] = time.perf_counter() - t_phase
        drill = trust_drill_check()
        split_s["drill"] = time.perf_counter() - t_phase
        code, wall = matrix.wait(timeout=600)
        split_s["matrix_process"] = time.perf_counter() - t_phase
    finally:
        if matrix.proc.poll() is None:
            matrix.proc.kill()
    with open(log) as f:
        text = f.read()
    check(os.path.exists(report_path), f"trust matrix: exit {code}, no report\n{text[-3000:]}")
    child = [json.loads(ln)["trust_child"] for ln in text.splitlines()
             if ln.startswith('{"trust_child"')]
    check(bool(child), f"trust matrix: exit {code}\n{text[-3000:]}")
    child = child[-1]
    summary = last_json("\n".join(ln for ln in text.splitlines() if ln.startswith('{"report"')))
    with open(report_path) as f:
        report = json.load(f)
    ccode, cout, _, _ = run_main("telemetry", ["check", "--trust", report_path], 120)
    check(code == ccode == (0 if report["gates"]["ok"] else 1),
          f"trust matrix exit {code}, check --trust exit {ccode}, gates ok "
          f"{report['gates']['ok']}\n{cout[-2000:]}")
    cells = [("id", report["id"])] + [(f"ood:{p['pair']}", p) for p in report["pairs"]]
    cells += [(f"{k}:{c['severity']}", c) for k in sorted(report["ladder"])
              for c in report["ladder"][k]]
    check(len(cells) == 22 and all(c["submitted"] == c["returned"] == c["n"] == TRUST_MAX_SAMPLES
                                   for _, c in cells),
          f"trust matrix cells {[(n, c['n'], c['submitted'], c['returned']) for n, c in cells]}")
    check(report["steady_state_recompiles"] == 0 and report["degraded"] is False,
          f"trust matrix: recompiles {report['steady_state_recompiles']}, degraded "
          f"{report['degraded']}")
    dispatches = child["dispatches"] + child["warmup_dispatches"]
    want = {"score_pool": 1, "bn_epilogue": 16, "score_pool_bwd": 0, "em_estep": 0}
    check(child["dispatches"] == 22 * TRUST_MAX_SAMPLES // 8
          and child["launches"] == {k: v * dispatches for k, v in want.items()},
          f"trust matrix: launches {child['launches']} over {dispatches} dispatches")
    quant_record_check(smi, report, root, ood)
    split_s["quant_record"] = time.perf_counter() - t_phase
    chunk_ms = corruption_chunk_ms()
    split_s["chunk_ms"] = time.perf_counter() - t_phase
    emit("trust", card=smi, exit=code, check_exit=ccode, matrix_wall_s=wall,
         matrix_main_s=child["seconds"], dispatches=child["dispatches"],
         warmup_dispatches=child["warmup_dispatches"], launches=child["launches"],
         launches_per_dispatch={k: v / dispatches for k, v in child["launches"].items()},
         corruption_chunk_ms_severity5=chunk_ms, summary=summary,
         gates_failed=[r["key"] for r in report["gates"]["rows"] if not r["ok"]],
         cells={n: {"outcomes": c["outcomes"], "answered": c["answered"],
                    "correct_answered": c["correct_answered"]} for n, c in cells},
         px_divergence=report["id"]["px_divergence"], vs_cpu=vs_cpu, drill=drill,
         split_s=split_s, seconds=time.perf_counter() - t_phase)
    return child["launches"], dispatches


# ------------------------------------------------------------ distributed
DIST_DIR = os.path.join(HERE, "build", "dist_phase")
DIST_RANKS = 2
DIST_STEPS = 3  # the steps held to the one-process trainer
DIST_TIMED_STEPS = 2  # then these, with the collectives timed apart
DIST_MESHES = ((2, 1), (1, 2))
DIST_BACKEND = "gloo"  # two ranks on one card: NCCL refuses a card twice
DIST_ACC_ATOL = 1.0 / TRAIN_BATCH  # one sample's argmax may flip at a near tie
DIST_CHILD_TIMEOUT_S = 300
DIST_SAVE_MESH, DIST_RESTORE_MESH = (1, 2), (2, 1)  # (a)'s sharded save, then its restore
DIST_INTERP_MESH = (1, 2)  # (d): the class slabs score the maps
DIST_INTERP_IMAGES, DIST_INTERP_BATCH = 32, 16  # the interpret tree's first 32 images
DIST_NPZ_HEADER_BYTES = 512  # a chunk's zip entry and .npy header, at most
DIST_INTERP_WAIT_S = 900  # (d)'s cli.interpret pair waits this long for the save
# (d) is exact unless the two collections differ only by rounding: every map
# within this share of its largest value of the other's, and at most this
# many peaks or top-K orders moved by it
DIST_INTERP_MAP_RTOL, DIST_INTERP_MAX_TIES = 1e-4, 2
# (c): the pod drill, resnet18 at the flagship's head widths, two gloo ranks
POD_TIMEOUT_S = 10  # --barrier_timeout_s
POD_KILL_AT = 7  # the global step whose batch kills rank 1 (epoch 1 of 2, 5 steps each)
POD_BATCH = 8  # a rank's rows: a global batch of 16 on the OoD folder's 80 images
POD_EXIT_MARGIN_S = 30  # rank 0's exit after rank 1's: the agreement's wait plus this at most


def dist_batches():
    """The phase's global batches of 80: seeded noise images, labels."""
    import numpy as np

    rng = np.random.default_rng(16)
    return [(rng.normal(size=(TRAIN_BATCH, 224, 224, 3)).astype(np.float32),
             rng.integers(0, 200, size=TRAIN_BATCH)) for _ in range(DIST_STEPS + DIST_TIMED_STEPS)]


def dist_config(batch, async_bank=False):
    from mgproto_tpu_torch.config import Config, DataConfig, EMConfig

    return Config(data=DataConfig(device_augment=False, train_batch_size=batch),
                  em=EMConfig(async_bank=async_bank))


def dist_state_digest(trainer, state):
    """sha256 of the parameters and buffers (the ranks' bit-equality)."""
    import hashlib

    import torch

    params = params_vector(trainer, state)
    buffers = torch.cat([b.float().reshape(-1) for b in state.model.buffers()])
    return hashlib.sha256(torch.cat([params, buffers]).cpu().numpy().tobytes()).hexdigest()


def dist_save_npz(path, trainer, full):
    import numpy as np

    np.savez(path, params=params_vector(trainer, full).cpu().numpy(),
             means=full.gmm.means.detach().cpu().numpy(), priors=full.gmm.priors.cpu().numpy(),
             length=full.memory.length.cpu().numpy(), cursor=full.memory.cursor.cpu().numpy())


def dist_child_async(spec, rank, mesh, shape, batches, out, out_dir):
    """16 (a)'s async steps at `mesh`: DIST_STEPS steps and the flush from
    the seeded start, each step's launches counted (the E-step on the bank
    stream), the gathered state to the parent; at DIST_SAVE_MESH the state
    saved sharded, each rank's save seconds and shard bytes."""
    import torch

    from mgproto_tpu_torch.parallel.sharding import put_batch
    from mgproto_tpu_torch.parallel.trainer import ShardedTrainer
    from mgproto_tpu_torch.utils.checkpoint import state_digest

    trainer = ShardedTrainer(dist_config(TRAIN_BATCH // DIST_RANKS, async_bank=True),
                             steps_per_epoch=100, mesh=mesh, device="cuda:0")
    state = trainer.restore(spec["ckpt"])
    out["async_steps"] = []
    for i in range(DIST_STEPS):
        x, y = put_batch(batches[i], mesh)
        before = launch_counts()
        t0 = time.perf_counter()
        state, met = trainer.train_step(state, x, y, use_mine=True, update_gmm=True)
        torch.cuda.synchronize()
        out["async_steps"].append({
            "s": time.perf_counter() - t0, "loss": met.loss.item(),
            "accuracy": met.accuracy.item(), "em_active": met.em_active,
            "nonfinite": met.nonfinite,
            "launches": {k: v - before[k] for k, v in launch_counts().items()}})
    before = launch_counts()
    state, flushed = trainer.flush_bank(state)
    torch.cuda.synchronize()
    out["async_flush"] = {"em_active": flushed[0].num_active,
                          "launches": {k: v - before[k] for k, v in launch_counts().items()}}
    out["async_sha256"] = dist_state_digest(trainer, state)
    with trainer.full_params(state, moments=True):
        full = trainer.full_state(state)
        if rank == 0:
            dist_save_npz(os.path.join(out_dir, "async_state.npz"), trainer, full)
        gathered = state_digest(full)
    out["async_layout"] = param_layout(trainer, state)
    if tuple(shape) == DIST_SAVE_MESH:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = trainer.save(spec["ckpt_dir"], state, "1nopush0.0000",
                            metadata={"epoch": 1, "stage": "nopush"})
        spec_bytes, chunks = shard_spec_bytes(trainer, state)
        out["save"] = {"s": time.perf_counter() - t0, "path": path,
                       "bytes": sum(os.path.getsize(os.path.join(path, f))
                                    for f in os.listdir(path)
                                    if f.startswith(f"shard_{rank:05d}.")),
                       "npz_bytes": os.path.getsize(os.path.join(path, f"shard_{rank:05d}.npz")),
                       "spec_bytes": spec_bytes, "chunks": chunks, "gathered_digest": gathered}
    del trainer, state, full
    torch.cuda.empty_cache()


def dist_child_restore_and_interp(spec, rank, out):
    """16 (a)'s restore of the sharded save by the pair at DIST_RESTORE_MESH
    (seconds, the gathered state's digest), then (d): the save restored at
    DIST_INTERP_MESH and `interp_metrics_sharded` over the interpret tree's
    first images (its launches counted); rank 0 writes the maps too."""
    import dataclasses

    import numpy as np
    import torch

    from mgproto_tpu_torch.cli.interpret import build_eval_loader
    from mgproto_tpu_torch.data.cub_parts import CubParts
    from mgproto_tpu_torch.parallel.mesh import make_mesh
    from mgproto_tpu_torch.parallel.trainer import ShardedTrainer
    from mgproto_tpu_torch.trust.interp_sharded import (
        collect_gt_activations_sharded,
        interp_metrics_sharded,
    )
    from mgproto_tpu_torch.utils.checkpoint import state_digest

    saved = os.path.join(spec["ckpt_dir"], "1nopush0.0000")
    mesh = make_mesh(*DIST_RESTORE_MESH, timeout_s=DIST_CHILD_TIMEOUT_S)
    trainer = ShardedTrainer(dist_config(TRAIN_BATCH // DIST_RANKS, async_bank=True),
                             steps_per_epoch=100, mesh=mesh, device="cuda:0")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = trainer.restore(saved)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    with trainer.full_params(state, moments=True):
        gathered = state_digest(trainer.full_state(state))
    out["restore"] = {"s": restore_s, "mesh": list(DIST_RESTORE_MESH),
                      "read_bytes": sum(os.path.getsize(os.path.join(saved, f))
                                        for f in os.listdir(saved)),
                      "gathered_digest": gathered}
    del trainer, state
    mesh = make_mesh(*DIST_INTERP_MESH, timeout_s=DIST_CHILD_TIMEOUT_S)
    cfg = dist_config(TRAIN_BATCH // DIST_RANKS)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, test_batch_size=DIST_INTERP_BATCH,
                                               num_workers=0))
    trainer = ShardedTrainer(cfg, steps_per_epoch=1, mesh=mesh, device="cuda:0")
    state = trainer.restore(saved)
    batches = lambda: iter(build_eval_loader(cfg, spec["cub"]))  # noqa: E731
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out["interp"] = interp_metrics_sharded(trainer, state, batches, CubParts(spec["cub"]),
                                           cfg.model.num_classes)
    torch.cuda.synchronize()
    out["interp"].update(s=time.perf_counter() - t0, launches=launch_counts(),
                         class_slab=trainer.class_slab())
    clean = collect_gt_activations_sharded(trainer, state, batches())
    noisy = collect_gt_activations_sharded(trainer, state, batches(), use_noise=True)
    if rank == 0:
        np.savez(os.path.join(spec["out"], "interp_maps.npz"), clean=clean[0].cpu().numpy(),
                 noisy=noisy[0].cpu().numpy(), targets=clean[1], ids=clean[2])
    del trainer, state
    torch.cuda.empty_cache()


def params_vector(trainer, state):
    """Every parameter flattened, whole: under a mesh that cuts them,
    gathered over the model group (a collective of the group)."""
    import torch

    with trainer.full_params(state):
        return torch.cat([p.detach().reshape(-1) for p in trainer.params(state)])


def param_layout(trainer, state):
    """The rank's parameters and Adam moments at rest: the bytes of the
    storage behind them (each storage once) beside `tree_bytes_per_chip`
    of their specs at the mesh's model axis and at a model axis of 1 (the
    replicated layout), and the card's allocated bytes."""
    import torch

    from mgproto_tpu_torch.parallel import sharding

    c, m = trainer.cfg.model.num_classes, trainer.mesh.model
    return {"held_bytes": sharding.held_bytes(sharding.param_tensors(state)),
            "spec_bytes": sharding.param_bytes_per_rank(state, c, m),
            "replicated_bytes": sharding.param_bytes_per_rank(state, c, 1),
            "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9}


def shard_spec_bytes(trainer, state):
    """(bytes, chunks) this rank writes of a sharded save of `state` by the
    specs: the leaves `sharded_payload_axes` names when it is the first
    rank of its model column, every other leaf on rank 0."""
    from mgproto_tpu_torch.parallel.sharding import sharded_payload_axes
    from mgproto_tpu_torch.utils import checkpoint as ck

    mesh = trainer.mesh
    axes = (sharded_payload_axes(state, trainer.cfg.model.num_classes, mesh.model)
            if mesh.model > 1 else {})
    leaves = [t for path, t in ck._tensors(ck.state_payload(state))
              if (mesh.data_index == 0 if path in axes else mesh.rank == 0)]
    return sum(t.numel() * t.element_size() for t in leaves), len(leaves)


def dist_child(argv):
    """`python3 chip_smoke.py --dist-child SPEC RANK`: one rank of 16 (a)
    and (d) on the card (`cuda:0`, shared with the other rank), with the
    backend SPEC names, for each mesh of SPEC in turn: restores the seeded
    start onto the mesh, runs DIST_STEPS steps on its rows of the phase's
    global batches (each step's launches counted), then DIST_TIMED_STEPS
    with the collectives timed apart, then the async steps
    (`dist_child_async`, the sharded save at DIST_SAVE_MESH), and writes
    what the parent holds to the one-process runs under SPEC's
    out/mesh{d}x{m}/; last the save's restore and (d)
    (`dist_child_restore_and_interp`), into out/."""
    import numpy as np
    import torch

    from mgproto_tpu_torch.parallel import collectives
    from mgproto_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from mgproto_tpu_torch.parallel.sharding import put_batch, whole_grads
    from mgproto_tpu_torch.parallel.trainer import ShardedTrainer

    with open(argv[0]) as f:
        spec = json.load(f)
    rank = int(argv[1])
    torch.cuda.set_device(0)
    initialize_distributed(backend=spec["backend"], init_method=spec["init"], rank=rank,
                           world_size=DIST_RANKS, device="cuda:0", timeout_s=DIST_CHILD_TIMEOUT_S)
    batches = dist_batches()
    for shape in spec["meshes"]:
        out_dir = os.path.join(spec["out"], f"mesh{shape[0]}x{shape[1]}")
        mesh = make_mesh(*shape, timeout_s=DIST_CHILD_TIMEOUT_S)
        cfg = dist_config(TRAIN_BATCH // DIST_RANKS)
        trainer = ShardedTrainer(cfg, steps_per_epoch=100, mesh=mesh, device="cuda:0")
        state = trainer.restore(spec["ckpt"])
        torch.cuda.synchronize()
        out = {"rank": rank, "mesh": shape, "class_slab": trainer.class_slab(),
               "em_width": trainer.em_cfg.max_active_classes, "fused": trainer.fused,
               "steps": [], "timed": [], "layout_restored": param_layout(trainer, state)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        for i in range(DIST_STEPS):
            x, y = put_batch(batches[i], mesh)
            before = launch_counts()
            t0 = time.perf_counter()
            state, met = trainer.train_step(state, x, y, use_mine=True, update_gmm=True)
            torch.cuda.synchronize()
            out["steps"].append({
                "s": time.perf_counter() - t0, "loss": met.loss.item(),
                "accuracy": met.accuracy.item(), "em_active": met.em_active,
                "em_compact_fallback": met.em_compact_fallback, "nonfinite": met.nonfinite,
                "launches": {k: v - before[k] for k, v in launch_counts().items()}})
            if i == 0:  # the whole gradient: a collective where the mesh cuts it
                grads = whole_grads(trainer.params(state), trainer._param_mesh)
                if rank == 0:
                    grad = torch.cat([g.reshape(-1) for g in grads])
                    np.save(os.path.join(out_dir, "grad1.npy"), grad.cpu().numpy())
                del grads
        out["launches"] = launch_counts()
        torch.cuda.synchronize()
        out["layout"] = param_layout(trainer, state)
        out["params_sha256"] = dist_state_digest(trainer, state)
        with trainer.full_params(state, moments=True):
            full = trainer.full_state(state)
            if rank == 0:
                dist_save_npz(os.path.join(out_dir, "state.npz"), trainer, full)
        collectives.stats.timing = True
        for i in range(DIST_STEPS, DIST_STEPS + DIST_TIMED_STEPS):
            x, y = put_batch(batches[i], mesh)
            collectives.stats.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = trainer.train_step(state, x, y, use_mine=True, update_gmm=True)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            out["timed"].append({"s": step_s, "collective_s": collectives.stats.seconds,
                                 "compute_s": step_s - collectives.stats.seconds,
                                 "collectives": collectives.stats.calls,
                                 "collective_bytes": collectives.stats.bytes})
        collectives.stats.timing = False
        del trainer, state, full
        torch.cuda.empty_cache()
        reset_launch_counts()
        dist_child_async(spec, rank, mesh, shape, batches, out, out_dir)
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    out = {"rank": rank}
    dist_child_restore_and_interp(spec, rank, out)
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()
    return 0


def dist_probe_ops(rank, world, dev):
    """Each collective once on `dev` tensors (ms, or the error it raised),
    then an all-reduce of a ResNet-34 gradient's 87 MB twice."""
    import torch
    import torch.distributed as dist

    res = {}

    def run(name, fn):
        try:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            res[name] = round((time.perf_counter() - t0) * 1e3, 3)
        except Exception as e:  # noqa: BLE001 - a probe reports what each call raised
            res[name] = repr(e)[:200]

    x = torch.arange(4.0, device=dev) + rank
    big = torch.ones(21_800_000, device=dev)
    run("all_reduce", lambda: dist.all_reduce(x))
    run("all_gather", lambda: dist.all_gather([torch.empty(4, device=dev)
                                               for _ in range(world)], x))
    run("reduce_scatter", lambda: dist.reduce_scatter(
        torch.empty(4, device=dev), [torch.ones(4, device=dev) for _ in range(world)]))
    run("broadcast", lambda: dist.broadcast(x, 0))
    run("barrier", dist.barrier)
    run("new_group_all_reduce", lambda: dist.all_reduce(x, group=dist.new_group(
        list(range(world)))))
    run("all_reduce_87MB", lambda: dist.all_reduce(big))
    run("all_reduce_87MB_again", lambda: dist.all_reduce(big))
    return res


def dist_probe_rank(rank, world, port, backend, queue):
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    out = {"rank": rank}
    try:
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=60))
        out["ms"] = dist_probe_ops(rank, world, torch.device("cuda", 0))
        dist.destroy_process_group()
    except Exception as e:  # noqa: BLE001 - a probe reports the refusal
        out["error"] = repr(e)[:300]
    queue.put(out)


def dist_probe() -> int:
    """`python3 chip_smoke.py --dist-probe`: which collectives two processes
    can run on the one card, each backend named: the card's compute mode,
    then gloo with 2 ranks, NCCL with 1, NCCL with 2 on cuda:0 (each rank's
    ms a call, or what it raised). Phase 16 is built on what this finds; it
    never switches a backend itself."""
    import multiprocessing as mp
    import queue as queue_mod

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,compute_mode",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    ctx = mp.get_context("spawn")
    for backend, world in (("gloo", 2), ("nccl", 1), ("nccl", 2)):
        q = ctx.Queue()
        port = free_port()
        procs = [ctx.Process(target=dist_probe_rank, args=(r, world, port, backend, q))
                 for r in range(world)]
        for p in procs:
            p.start()
        results, t0 = [], time.perf_counter()
        while len(results) < world and time.perf_counter() - t0 < 150:
            try:
                results.append(q.get(timeout=5))
            except queue_mod.Empty:
                pass
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
                results.append({"killed": p.pid})
        print(json.dumps({"probe": backend, "world": world, "ranks": results}), flush=True)
    return 0


def dist_reference(ckpt, batches, scale=1.0, async_bank=False):
    """The one-process Trainer's DIST_STEPS steps from the start checkpoint
    on the global batches (images times `scale`; with `async_bank` the
    async pipeline, flushed after the last step): per-step records, the
    first step's gradient, the final parameters and the gathered bank."""
    import numpy as np
    import torch

    from mgproto_tpu_torch.engine.train import Trainer
    from mgproto_tpu_torch.utils.checkpoint import restore_checkpoint

    tr = Trainer(dist_config(TRAIN_BATCH, async_bank), steps_per_epoch=100, device="cuda")
    st = restore_checkpoint(ckpt, tr.init_state(0, for_restore=True))
    theta0 = params_vector(tr, st).clone()
    steps, grad1 = [], None
    for i in range(DIST_STEPS):
        x, y = batches[i]
        st, met = tr.train_step(st, x * np.float32(scale), y, use_mine=True, update_gmm=True)
        steps.append({"loss": met.loss.item(), "accuracy": met.accuracy.item(),
                      "em_active": met.em_active, "em_compact_fallback": met.em_compact_fallback})
        if i == 0:
            grad1 = torch.cat([p.grad.reshape(-1) for p in tr.params(st)]).clone()
    st, _ = tr.flush_bank(st)  # a no-op in sync mode
    out = {"steps": steps, "grad1": grad1, "theta0": theta0, "params": params_vector(tr, st),
           "means": st.gmm.means.detach().clone(), "priors": st.gmm.priors.clone(),
           "length": st.memory.length.clone(), "cursor": st.memory.cursor.clone()}
    del tr, st
    return out


def dist_ranks_run(ckpt, cub):
    """16 (a)'s and (d)'s two ranks as processes on the card, every mesh of
    DIST_MESHES in turn in one process group, then the restore and (d) on
    the CUB tree `cub`, joined within DIST_CHILD_TIMEOUT_S; returns their
    wall seconds."""
    spec_path = os.path.join(DIST_DIR, "spec.json")
    for mesh in DIST_MESHES:
        os.makedirs(os.path.join(DIST_DIR, f"mesh{mesh[0]}x{mesh[1]}"))
    with open(spec_path, "w") as f:
        json.dump({"init": f"tcp://localhost:{free_port()}", "meshes": DIST_MESHES, "ckpt": ckpt,
                   "backend": DIST_BACKEND, "out": DIST_DIR,
                   "ckpt_dir": os.path.join(DIST_DIR, "sharded"), "cub": cub}, f)
    t0 = time.perf_counter()
    logs = [open(os.path.join(DIST_DIR, f"rank{r}.log"), "w") for r in range(DIST_RANKS)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dist-child",
                               spec_path, str(r)], cwd=HERE, stdout=logs[r],
                              stderr=subprocess.STDOUT, env=dict(os.environ, PYTHONUNBUFFERED="1"))
             for r in range(DIST_RANKS)]
    try:
        for r, p in enumerate(procs):
            code = p.wait(timeout=max(DIST_CHILD_TIMEOUT_S - (time.perf_counter() - t0), 1))
            logs[r].close()
            check(code == 0, f"16 (a) rank {r} exited {code}:\n"
                  + open(os.path.join(DIST_DIR, f"rank{r}.log")).read()[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return time.perf_counter() - t0


def dist_mesh_check(smi, mesh, refs, wall_s):
    """16 (a) at one mesh: the two ranks' steps held to the one-process run
    `refs["sync"]`, within twice what the perturbed run `refs["floor"]`
    moves it, then their async steps (`dist_async_check`); returns the
    launches of both ranks' DIST_STEPS sync steps, and of their async
    steps and flush."""
    ref, floor = refs["sync"], refs["floor"]
    import numpy as np
    import torch

    out_dir = os.path.join(DIST_DIR, f"mesh{mesh[0]}x{mesh[1]}")
    ranks = []
    for r in range(DIST_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    got = np.load(os.path.join(out_dir, "state.npz"))
    grad1 = torch.from_numpy(np.load(os.path.join(out_dir, "grad1.npy"))).cuda()

    def diff(a, b):
        return (torch.as_tensor(a, device="cuda").float()
                - torch.as_tensor(b, device="cuda").float()).abs().max().item()

    # per-rank launches a step: score_pool and its backward once, the block
    # tails 16 times, the E-step num_em_loop times on the rank's slab
    want = {"score_pool": 1, "score_pool_bwd": 1, "bn_epilogue": 16, "em_estep": 3}
    for rk in ranks:
        check(rk["fused"], f"16 (a) mesh {mesh}: the rank did not resolve to the kernels")
        for i, step in enumerate(rk["steps"]):
            check(step["launches"] == want, f"16 (a) mesh {mesh} rank {rk['rank']} step {i}: "
                  f"launches {step['launches']}, expected {want}")
            check(not step["nonfinite"], f"16 (a) mesh {mesh}: step {i} skipped as non-finite")
    check(len({rk["params_sha256"] for rk in ranks}) == 1,
          f"16 (a) mesh {mesh}: the ranks' parameters differ")
    for rk in ranks:  # the parameters and moments at rest: the specs' bytes exactly
        for when in ("layout_restored", "layout", "async_layout"):
            lay = rk[when]
            check(lay["held_bytes"] == lay["spec_bytes"],
                  f"16 (a) mesh {mesh} rank {rk['rank']} {when}: the parameters and moments "
                  f"hold {lay['held_bytes']} bytes, the specs {lay['spec_bytes']}")
            check((lay["spec_bytes"] < lay["replicated_bytes"]) == (mesh[1] > 1),
                  f"16 (a) mesh {mesh} rank {rk['rank']} {when}: {lay}")
    steps = ranks[0]["steps"]
    for i, (s, r, fl) in enumerate(zip(steps, ref["steps"], floor["steps"])):
        for rk in ranks[1:]:
            check(rk["steps"][i]["loss"] == s["loss"], f"16 (a) mesh {mesh}: ranks' losses differ")
        tol = max(TRAIN_LOSS_RTOL * abs(r["loss"]), TRAIN_GRAD_FLOOR_MULT * abs(fl["loss"] - r["loss"]))
        check(abs(s["loss"] - r["loss"]) <= tol,
              f"16 (a) mesh {mesh} step {i}: loss {s['loss']} vs one process {r['loss']} "
              f"(tolerance {tol})")
        check(abs(s["accuracy"] - r["accuracy"]) <= DIST_ACC_ATOL,
              f"16 (a) mesh {mesh} step {i}: accuracy {s['accuracy']} vs {r['accuracy']}")
        check(s["em_active"] == r["em_active"],
              f"16 (a) mesh {mesh} step {i}: em_active {s['em_active']} vs {r['em_active']}")
    check(bool(torch.equal(torch.from_numpy(got["length"]).cuda(), ref["length"].int())),
          f"16 (a) mesh {mesh}: the bank's lengths differ from the one-process run's")
    means_err, means_floor = diff(got["means"], ref["means"]), diff(floor["means"], ref["means"])
    check(means_err <= max(1e-5, TRAIN_GRAD_FLOOR_MULT * means_floor),
          f"16 (a) mesh {mesh}: means differ by {means_err} (floor {means_floor})")
    grad_err = rel_norm(grad1, ref["grad1"])
    grad_floor = rel_norm(floor["grad1"], ref["grad1"])
    check(grad_err <= TRAIN_GRAD_FLOOR_MULT * grad_floor,
          f"16 (a) mesh {mesh}: first-step gradient rel err {grad_err} > "
          f"{TRAIN_GRAD_FLOOR_MULT} x the floor {grad_floor}")
    update = (ref["params"] - ref["theta0"]).norm().item()
    params = torch.from_numpy(got["params"]).cuda()
    param_err = (params - ref["params"]).norm().item() / update
    param_floor = (floor["params"] - ref["params"]).norm().item() / update
    check(param_err <= TRAIN_GRAD_FLOOR_MULT * param_floor,
          f"16 (a) mesh {mesh}: parameters after {DIST_STEPS} steps, rel err of the update "
          f"{param_err} > {TRAIN_GRAD_FLOOR_MULT} x the floor {param_floor}")
    cursors_equal = float((torch.from_numpy(got["cursor"]).cuda() == ref["cursor"]).float().mean())
    per_rank = [{"rank": rk["rank"], "class_slab": rk["class_slab"], "em_width": rk["em_width"],
                 "step_s": [s["s"] for s in rk["steps"]],
                 "timed_step_s": [t["s"] for t in rk["timed"]],
                 "collective_ms": [1e3 * t["collective_s"] for t in rk["timed"]],
                 "compute_ms": [1e3 * t["compute_s"] for t in rk["timed"]],
                 "collectives_per_step": [t["collectives"] for t in rk["timed"]],
                 "collective_mb_per_step": [t["collective_bytes"] / 1e6 for t in rk["timed"]],
                 "launches_per_step": rk["steps"][0]["launches"],
                 "em_compact_fallback": [s["em_compact_fallback"] for s in rk["steps"]],
                 "params_and_moments_at_rest": {
                     "after_restore": rk["layout_restored"], "after_steps": rk["layout"],
                     "after_async_steps": rk["async_layout"]},
                 "peak_mem_gb": rk["peak_mem_gb"]} for rk in ranks]
    emit("distributed", part="a", card=smi, backend=DIST_BACKEND, mesh=list(mesh),
         ranks_on_one_card=DIST_RANKS, global_batch=TRAIN_BATCH,
         batch_per_rank=TRAIN_BATCH // DIST_RANKS, steps=DIST_STEPS,
         ranks_wall_s_both_meshes=wall_s,
         losses=[s["loss"] for s in steps], one_process_losses=[r["loss"] for r in ref["steps"]],
         floor_losses=[r["loss"] for r in floor["steps"]],
         accuracy=[s["accuracy"] for s in steps], em_active=[s["em_active"] for s in steps],
         means_max_abs_err=means_err, means_floor=means_floor, grad_rel_err=grad_err,
         grad_floor=grad_floor, param_update_rel_err=param_err, param_floor=param_floor,
         cursors_equal_share=cursors_equal, params_bit_equal_across_ranks=True,
         params_sharded_at_rest=mesh[1] > 1, per_rank=per_rank,
         compare_with="mesh (2, 1) of this run (model axis 1: the replicated layout) and "
                      "PERF.md section 5, Distributed",
         note="gloo on one card: both ranks share the H100, and gloo stages CUDA tensors "
              "through the host; not a multi-GPU NCCL figure")
    sync_launches = {k: sum(rk["launches"][k] for rk in ranks) for k in want}
    async_launches = dist_async_check(smi, mesh, ranks, out_dir, refs["async"],
                                      refs["async_floor"], want)
    return sync_launches, async_launches


def dist_async_check(smi, mesh, ranks, out_dir, ref, floor, want):
    """16 (a)'s async steps at one mesh, held to the one-process async
    trainer `ref` within twice what the perturbed run `floor` moves it
    (the sync steps' floors): the launches of each rank and step (the fill step
    holds its bank phase, so no E-step; every later step the previous
    bank phase's num_em_loop on the bank stream; the flush the last), the
    ranks bit-equal. Returns both ranks' launches, steps and flush."""
    import numpy as np
    import torch

    got = np.load(os.path.join(out_dir, "async_state.npz"))

    def diff(a, b):
        return (torch.as_tensor(a, device="cuda").float()
                - torch.as_tensor(b, device="cuda").float()).abs().max().item()

    for rk in ranks:
        for i, step in enumerate(rk["async_steps"]):
            exp = dict(want, em_estep=0 if i == 0 else want["em_estep"])
            check(step["launches"] == exp, f"16 (a) async mesh {mesh} rank {rk['rank']} step "
                  f"{i}: launches {step['launches']}, expected {exp}")
            check(not step["nonfinite"], f"16 (a) async mesh {mesh}: step {i} non-finite")
        flush = dict.fromkeys(want, 0)
        flush["em_estep"] = want["em_estep"]
        check(rk["async_flush"]["launches"] == flush,
              f"16 (a) async mesh {mesh}: the flush launched {rk['async_flush']['launches']}")
    check(len({rk["async_sha256"] for rk in ranks}) == 1,
          f"16 (a) async mesh {mesh}: the ranks' parameters differ")
    steps = ranks[0]["async_steps"]
    for i, (s, r, fl) in enumerate(zip(steps, ref["steps"], floor["steps"])):
        tol = max(TRAIN_LOSS_RTOL * abs(r["loss"]), TRAIN_GRAD_FLOOR_MULT * abs(fl["loss"] - r["loss"]))
        check(abs(s["loss"] - r["loss"]) <= tol, f"16 (a) async mesh {mesh} step {i}: loss "
              f"{s['loss']} vs one process {r['loss']} (tolerance {tol})")
        check(abs(s["accuracy"] - r["accuracy"]) <= DIST_ACC_ATOL,
              f"16 (a) async mesh {mesh} step {i}: accuracy {s['accuracy']} vs {r['accuracy']}")
        check(s["em_active"] == r["em_active"], f"16 (a) async mesh {mesh} step {i}: "
              f"em_active {s['em_active']} vs {r['em_active']}")
    check(bool(torch.equal(torch.from_numpy(got["length"]).cuda(), ref["length"].int())),
          f"16 (a) async mesh {mesh}: the bank's lengths differ from the one-process run's")
    means_err, means_floor = diff(got["means"], ref["means"]), diff(floor["means"], ref["means"])
    check(means_err <= max(1e-5, TRAIN_GRAD_FLOOR_MULT * means_floor),
          f"16 (a) async mesh {mesh}: means differ by {means_err} (floor {means_floor})")
    update = (ref["params"] - ref["theta0"]).norm().item()
    params = torch.from_numpy(got["params"]).cuda()
    param_err = (params - ref["params"]).norm().item() / update
    param_floor = (floor["params"] - ref["params"]).norm().item() / update
    check(param_err <= TRAIN_GRAD_FLOOR_MULT * param_floor,
          f"16 (a) async mesh {mesh}: parameters, rel err of the update {param_err} > "
          f"{TRAIN_GRAD_FLOOR_MULT} x the floor {param_floor}")
    emit("distributed", part="a_async", card=smi, backend=DIST_BACKEND, mesh=list(mesh),
         steps=DIST_STEPS, losses=[s["loss"] for s in steps],
         one_process_losses=[r["loss"] for r in ref["steps"]],
         em_active=[s["em_active"] for s in steps],
         flush_em_active=ranks[0]["async_flush"]["em_active"], means_max_abs_err=means_err,
         means_floor=means_floor, param_update_rel_err=param_err, param_floor=param_floor,
         params_bit_equal_across_ranks=True,
         step_s=[[s["s"] for s in rk["async_steps"]] for rk in ranks],
         launches_per_step=[s["launches"] for s in ranks[0]["async_steps"]],
         flush_launches=ranks[0]["async_flush"]["launches"])
    out = {k: 0 for k in want}
    for rk in ranks:
        for step in rk["async_steps"] + [rk["async_flush"]]:
            for k in want:
                out[k] += step["launches"][k]
    return out


def dist_restore_check(smi, ranks_dir):
    """16 (a)'s sharded save at DIST_SAVE_MESH: restored by the pair at
    DIST_RESTORE_MESH and here at world 1, the gathered state's digest
    equal to the saving ranks' each time; each rank's save and restore
    seconds and bytes."""
    import torch

    from mgproto_tpu_torch.engine.train import Trainer
    from mgproto_tpu_torch.utils import checkpoint as ck

    save_dir = os.path.join(DIST_DIR, f"mesh{DIST_SAVE_MESH[0]}x{DIST_SAVE_MESH[1]}")
    savers = [json.load(open(os.path.join(save_dir, f"rank{r}.json"))) for r in range(DIST_RANKS)]
    restorers = [json.load(open(os.path.join(ranks_dir, f"rank{r}.json")))
                 for r in range(DIST_RANKS)]
    path = savers[0]["save"]["path"]
    check(ck.is_committed(path) and ck.has_shard_files(path),
          f"16 (a): the sharded save {path} is not committed")
    for r, sv in enumerate(savers):  # each rank's shard: its spec's chunks, plus npz headers
        save = sv["save"]
        check(save["spec_bytes"] <= save["npz_bytes"]
              <= save["spec_bytes"] + DIST_NPZ_HEADER_BYTES * save["chunks"],
              f"16 (a): rank {r}'s shard holds {save['npz_bytes']} bytes for the specs' "
              f"{save['spec_bytes']} in {save['chunks']} chunks")
    digest = savers[0]["save"]["gathered_digest"]
    check(all(s["save"]["gathered_digest"] == digest for s in savers),
          "16 (a): the saving ranks' gathered states differ")
    for rk in restorers:
        check(rk["restore"]["gathered_digest"] == digest,
              f"16 (a): rank {rk['rank']} at mesh {DIST_RESTORE_MESH} restored another state")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = Trainer(dist_config(TRAIN_BATCH, async_bank=True), steps_per_epoch=100, device="cuda")
    st = ck.restore_checkpoint(path, tr.init_state(0, for_restore=True))
    torch.cuda.synchronize()
    world1_s = time.perf_counter() - t0
    check(ck.state_digest(st) == digest, "16 (a): the world-1 restore differs from the save")
    del tr, st
    emit("distributed", part="a_checkpoint", card=smi, saved_at=list(DIST_SAVE_MESH),
         restored_at=[list(DIST_RESTORE_MESH), [1, 1]], bit_equal=True,
         save_s=[s["save"]["s"] for s in savers],
         shard_bytes_per_rank=[s["save"]["bytes"] for s in savers],
         shard_npz_bytes_per_rank=[s["save"]["npz_bytes"] for s in savers],
         spec_bytes_per_rank=[s["save"]["spec_bytes"] for s in savers],
         chunks_per_rank=[s["save"]["chunks"] for s in savers],
         restore_s=[r["restore"]["s"] for r in restorers],
         restore_read_bytes_per_rank=[r["restore"]["read_bytes"] for r in restorers],
         world1_restore_s=world1_s, files=sorted(os.listdir(path)))
    return path


def dist_interp_near_ties(cfg, cub, saved, ranks_dir):
    """(the differences between the one-process collections of `saved` and
    the ranks' maps: maps whose upsampled peak differs, clean or noisy, and
    prototypes whose top-K image order differs; the prototypes scored; the
    largest map difference over the largest map value). Each difference is
    a near tie when that share is within DIST_INTERP_MAP_RTOL."""
    import numpy as np

    from mgproto_tpu_torch.cli.interpret import build_eval_loader
    from mgproto_tpu_torch.engine import interpretability as ti
    from mgproto_tpu_torch.engine.train import Trainer
    from mgproto_tpu_torch.utils.checkpoint import restore_checkpoint

    tr = Trainer(cfg, steps_per_epoch=1, device="cuda")
    st = restore_checkpoint(saved, tr.init_state(0, for_restore=True))
    got = np.load(os.path.join(ranks_dir, "interp_maps.npz"))
    img, flips, rel = cfg.model.img_size, set(), 0.0
    for noisy in (False, True):
        loader = build_eval_loader(cfg, cub)
        try:
            acts = ti.collect_gt_activations(tr, st, iter(loader), use_noise=noisy)
        finally:
            loader.close()
        theirs = got["noisy" if noisy else "clean"]
        rel = max(rel, float(np.abs(acts[0] - theirs).max() / max(np.abs(acts[0]).max(), 1e-30)))
        moved = (ti.peak_positions(acts[0], img) != ti.peak_positions(theirs, img)).any(-1)
        flips |= {("map", int(r), int(k)) for r, k in np.argwhere(moved)}
    classes = sorted(set(acts[1].tolist()))
    for c in classes:
        idx = np.nonzero(acts[1] == c)[0]
        mine, yours = ti._topk_rows(acts[0][idx], 10), ti._topk_rows(got["clean"][idx], 10)
        flips |= {("topk", c, int(k)) for k in np.nonzero((mine != yours).any(0))[0]}
    return flips, len(classes) * acts[0].shape[1], rel


def interp_child(argv):
    """`python3 chip_smoke.py --interp-child READY FLAGS`: one rank of (d)'s
    `cli.interpret --distributed` pair on cuda:0: the gloo group joined
    first (two ranks on one card: NCCL refuses a card twice; the main's
    own join then finds the group), then, once the file READY exists (the
    checkpoint's COMMIT), `cli.interpret.main` on FLAGS, then one JSON line
    of the process's launch counts and the seconds of `main`."""
    from mgproto_tpu_torch.cli import interpret
    from mgproto_tpu_torch.parallel.mesh import initialize_distributed

    initialize_distributed(backend=DIST_BACKEND, device="cuda:0", strict=True,
                           timeout_s=DIST_CHILD_TIMEOUT_S)
    deadline = time.time() + DIST_INTERP_WAIT_S
    while not os.path.exists(argv[0]):
        check(time.time() < deadline, f"16 (d): {argv[0]} did not appear")
        time.sleep(0.2)
    argv = argv[1:]
    reset_launch_counts()
    t0 = time.perf_counter()
    interpret.main(argv)
    print(json.dumps({"interp_child": {"launches": launch_counts(),
                                       "seconds": time.perf_counter() - t0}}), flush=True)
    return 0


def interp_cli_start(saved, cub):
    """(d)'s `cli.interpret --distributed --mesh_model 2` as two gloo rank
    processes on cuda:0 (the launcher's environment set here, LOCAL_RANK 0
    for both) on (a)'s sharded save and the CUB tree `cub`, at the pair's
    batch; each rank names a CSV of its own, of which only rank 0's may
    appear. Started with the phase, each runs its main once the save's
    COMMIT exists, so its process start is off the phase's critical path."""
    port, procs = free_port(), []
    for r in range(DIST_RANKS):
        env = dict(os.environ, PYTHONUNBUFFERED="1", RANK=str(r), WORLD_SIZE=str(DIST_RANKS),
                   LOCAL_RANK="0", MASTER_ADDR="localhost", MASTER_PORT=str(port))
        flags = ["--cub_root", cub, "--checkpoint", saved, "--model_dir", os.path.dirname(saved),
                 "--batch_size", str(DIST_INTERP_BATCH), "--num_workers", "0",
                 "--no_pretrained", "--distributed", "--mesh_model", str(DIST_INTERP_MESH[1]),
                 "--export_csv", os.path.join(DIST_DIR, f"interpret_rank{r}.csv")]
        log = open(os.path.join(DIST_DIR, f"interp_cli_rank{r}.log"), "w")
        procs.append(Started(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--interp-child",
             os.path.join(saved, "COMMIT"), *flags], cwd=HERE,
            stdout=log, stderr=subprocess.STDOUT, env=env), log.name))
    return procs


def interp_cli_results(pair):
    """Each rank's (metric line or None, launch line) of the pair, both
    exited 0."""
    out = []
    for r, (code, _) in enumerate(p.wait(timeout=DIST_CHILD_TIMEOUT_S) for p in pair):
        text = open(pair[r].out).read()
        check(code == 0, f"16 (d) cli.interpret rank {r} exited {code}:\n{text[-3000:]}")
        lines = [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]
        child = [ln["interp_child"] for ln in lines if "interp_child" in ln]
        metrics = [ln for ln in lines if "interp_child" not in ln]
        check(len(child) == 1, f"16 (d) cli.interpret rank {r}: no launch line:\n{text[-3000:]}")
        out.append((metrics[-1] if metrics else None, child[0]))
    return out


def dist_interp_check(smi, ranks_dir, saved, cub, pair):
    """16 (d): the ranks' `interp_metrics_sharded` at DIST_INTERP_MESH equals
    `run_interpret`'s metrics on the same images in one process, exactly
    (the CPU test's rule). Only where the two collections differ by
    rounding alone (every map within DIST_INTERP_MAP_RTOL of the other's,
    `dist_interp_near_ties`) may each of at most DIST_INTERP_MAX_TIES near
    ties (a map's peak or a prototype's top-K order) move a metric by one
    prototype's weight (100 / prototypes); a wrong pass fails. The
    `cli.interpret` rank pair `pair` prints (rank 0 alone, with the CSV)
    the in-process pair's metrics by the same rule."""
    import dataclasses

    from mgproto_tpu_torch.cli.interpret import run_interpret

    ranks = [json.load(open(os.path.join(ranks_dir, f"rank{r}.json")))["interp"]
             for r in range(DIST_RANKS)]
    keys = ("consistency", "stability", "purity", "purity_std")
    check(all(r[k] == ranks[0][k] for r in ranks for k in keys), "16 (d): the ranks disagree")
    cfg = dist_config(TRAIN_BATCH)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, test_batch_size=DIST_INTERP_BATCH,
                                               num_workers=0))
    t0 = time.perf_counter()
    one = run_interpret(cfg, cub, checkpoint=saved, device="cuda")
    one_s = time.perf_counter() - t0
    check(one["images"] == ranks[0]["num_images"] == DIST_INTERP_IMAGES,
          f"16 (d): {one['images']} and {ranks[0]['num_images']} images")
    flips, n_protos, rel = set(), 1, 0.0
    if any(ranks[0][k] != one[k] for k in keys):
        flips, n_protos, rel = dist_interp_near_ties(cfg, cub, saved, ranks_dir)
        check(rel <= DIST_INTERP_MAP_RTOL and len(flips) <= DIST_INTERP_MAX_TIES,
              f"16 (d): metrics {[(ranks[0][k], one[k]) for k in keys]} differ with the maps "
              f"{rel} apart (limit {DIST_INTERP_MAP_RTOL}) and {len(flips)} moved peaks or "
              f"orders (limit {DIST_INTERP_MAX_TIES}): {sorted(flips)[:20]}")
    for k in keys:
        check(abs(ranks[0][k] - one[k]) <= 100.0 * len(flips) / n_protos + 1e-9,
              f"16 (d): {k} {ranks[0][k]} on two ranks vs {one[k]} in one process "
              f"(near ties {sorted(flips)})")
    per_rank = 16 * 2 * -(-DIST_INTERP_IMAGES // DIST_INTERP_BATCH)
    check(ranks[0]["launches"]["bn_epilogue"] == per_rank,
          f"16 (d): the epilogue launched {ranks[0]['launches']}, expected {per_rank} a rank")
    (cli, child0), (cli1, child1) = interp_cli_results(pair)
    check(cli is not None and cli1 is None, "16 (d) cli.interpret: rank 0 alone prints the line")
    check(os.path.isfile(cli["csv"]) and cli["csv_rows"] > 0
          and not os.path.exists(os.path.join(DIST_DIR, "interpret_rank1.csv")),
          f"16 (d) cli.interpret: the CSV is not rank 0's alone: {cli}")
    if any(cli[k] != ranks[0][k] for k in keys):
        if not flips:
            flips, n_protos, rel = dist_interp_near_ties(cfg, cub, saved, ranks_dir)
        check(rel <= DIST_INTERP_MAP_RTOL and len(flips) <= DIST_INTERP_MAX_TIES
              and all(abs(cli[k] - one[k]) <= 100.0 * len(flips) / n_protos + 1e-9
                      for k in keys),
              f"16 (d) cli.interpret: {[(cli[k], ranks[0][k], one[k]) for k in keys]} (the "
              f"pair, the in-process pair, one process) with near ties {sorted(flips)}")
    for child in (child0, child1):
        check(child["launches"] == dict(dict.fromkeys(child["launches"], 0),
                                        bn_epilogue=per_rank),
              f"16 (d) cli.interpret: a rank launched {child['launches']}, expected the "
              f"epilogue {per_rank} times")
    emit("distributed", part="d", card=smi, mesh=list(DIST_INTERP_MESH), images=one["images"],
         batch=DIST_INTERP_BATCH, two_ranks={k: ranks[0][k] for k in keys},
         one_process={k: one[k] for k in keys}, near_ties=len(flips), maps_rel_diff=rel,
         class_slab=[r["class_slab"] for r in ranks], launches_per_rank=ranks[0]["launches"],
         two_ranks_s=ranks[0]["s"], one_process_s=one_s,
         cli_interpret={k: cli[k] for k in keys + ("csv_rows",)},
         cli_interpret_main_s=[child0["seconds"], child1["seconds"]],
         cli_interpret_launches_per_rank=child0["launches"],
         note="the cli.interpret pair's main ran from the save's COMMIT on, beside the ranks' "
              "restore and interp pass and this process's one-process interpret",
         reduced="the interpret phase's CUB tree cut to its first 32 images (8 classes)")
    return ({k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]},
            {k: child0["launches"][k] + child1["launches"][k] for k in child0["launches"]})


def dist_cli_flags():
    root, ood = trust_trees()
    return ["--train_dir", root, "--test_dir", ood, "--push_dir", ood, "--model_dir",
            os.path.join(DIST_DIR, "cli"), "--num_workers", str(INPUT_WORKERS), "--no_pretrained"]


def dist_cli_env():
    """The launcher's environment of a group of one rank."""
    return {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
            "MASTER_PORT": str(free_port())}


def dist_cli_start():
    """16 (b)'s `cli.train --distributed` process at world size 1 under NCCL
    (the launcher's environment set here) for one epoch on the input
    phase's folder, with the schedule phase's OoD folder as the test and
    push set; started first, beside (a)'s untimed one-process runs."""
    log = open(os.path.join(DIST_DIR, "cli_train.log"), "w")
    flags = dist_cli_flags() + ["--distributed", "--epochs", "1", "--mine_start", "0",
                                "--gmm_start", "0", "--push_start", "0", "--push_every", "1"]
    proc = subprocess.Popen([sys.executable, "-m", "mgproto_tpu_torch.cli.train", *flags],
                            cwd=HERE, stdout=log, stderr=subprocess.STDOUT,
                            env=dict(os.environ, PYTHONUNBUFFERED="1", **dist_cli_env()))
    return Started(proc, log.name)


def dist_cli_check(smi, train, evaluate):
    """16 (b): the `cli.train --distributed` process `train` trained,
    tested, pushed (rendered), pruned and saved; `evaluate`, the future of
    its `cli.evaluate --distributed` run, restored the prune checkpoint and
    printed the run's last test accuracy."""
    from mgproto_tpu_torch.utils import checkpoint as ck

    rc, train_s = train.wait(timeout=400)
    check(rc == 0, f"16 (b) cli.train --distributed exited {rc}:\n"
          + open(train.out).read()[-3000:])
    run_dir = os.path.join(DIST_DIR, "cli")
    stages = sorted({c[1] for c in ck.list_checkpoints(run_dir)})
    check(stages == ["nopush", "prune", "push"], f"16 (b) cli.train stage checkpoints {stages}")
    log = open(os.path.join(run_dir, "train.log")).read()
    check("rank: 0 of 1" in log and "backend: nccl" in log and "training done" in log,
          "16 (b) cli.train: train.log does not show the NCCL group of one rank")
    records = [json.loads(ln) for ln in open(os.path.join(run_dir, "metrics.jsonl"))]
    img_dir = os.path.join(run_dir, "img", "epoch-0")
    rendered = len(os.listdir(img_dir)) if os.path.isdir(img_dir) else 0
    check(rendered > 0 and records[-1].get("stage") == "prune", "16 (b): no render or prune")
    drc, dout, derr, dist_s = evaluate.result()
    check(drc == 0, f"16 (b) cli.evaluate --distributed exited {drc}:\n{derr[-3000:]}")
    dres = last_json(dout)
    prune = [c[3] for c in ck.list_checkpoints(run_dir) if c[1] == "prune"][0]
    check(dres["checkpoint"] == prune, "16 (b): evaluate read another file")
    check(dres["accuracy"] == records[-1]["acc"],
          f"16 (b): evaluate --distributed {dres['accuracy']}, the run's last test pass "
          f"{records[-1]['acc']}")
    emit("distributed", part="b", card=smi, backend="nccl", world_size=1, epochs=1,
         batch=TRAIN_BATCH, train_wall_s=train_s, stages=stages, rendered_jpegs=rendered,
         train_s=[r["train_s"] for r in records if "train_s" in r], accuracy=records[-1]["acc"],
         evaluate_distributed_wall_s=dist_s, evaluate_accuracy=dres["accuracy"],
         note="the train process ran beside (a)'s untimed one-process runs and (c)'s drills")


# ---------------------------------------------------------- 16 (c): the pod drill
POD_DIR = os.path.join(DIST_DIR, "pod")


def pod_flags(model_dir):
    """The drill's model and data: resnet18 at the flagship's head widths
    (C = 200, K = 10, d = 64, T = 20, a bank of 800), 224 px, on the
    schedule phase's OoD folder (80 images) as train, test and push set;
    2 epochs of 5 steps at a global batch of 16, no push."""
    _, ood = trust_trees()
    return ["--arch", "resnet18", "--no_pretrained", "--num_workers", "0",
            "--batch_size", str(POD_BATCH), "--epochs", "2", "--mine_start", "0",
            "--gmm_start", "0", "--push_start", "99", "--train_dir", ood, "--test_dir", ood,
            "--push_dir", ood, "--model_dir", model_dir]


def pod_child(argv):
    """`python3 chip_smoke.py --pod-child FLAGS`: `cli.train`'s main with
    cuDNN deterministic (bit-exact resume needs it on the card), in the
    gloo group joined here first (two ranks on one card: NCCL refuses a
    card twice; main's own join then finds the group)."""
    import torch

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    from mgproto_tpu_torch.cli import train
    from mgproto_tpu_torch.parallel.mesh import initialize_distributed

    initialize_distributed(backend=DIST_BACKEND, device="cuda:0", strict=True,
                           timeout_s=POD_TIMEOUT_S)
    train.main(argv)
    return 0


def pod_start(name, kill=False, resume=False):
    """16 (c)'s two gloo ranks of `cli.train --distributed --ckpt_format
    sharded --barrier_timeout_s POD_TIMEOUT_S` on cuda:0 (the launcher's
    environment set here; `pod_child` joins the gloo group); with `kill`,
    MGPROTO_CHAOS_KILL_HOST_AT in rank 1's environment only."""
    model_dir = os.path.join(POD_DIR, "kill" if name == "relaunch" else name)
    port, procs = free_port(), []
    for r in range(DIST_RANKS):
        env = dict(os.environ, PYTHONUNBUFFERED="1", RANK=str(r), WORLD_SIZE=str(DIST_RANKS),
                   LOCAL_RANK="0", MASTER_ADDR="localhost", MASTER_PORT=str(port))
        env.pop("MGPROTO_BARRIER_SESSION", None)  # each incarnation agrees on its own
        if kill and r == 1:
            env["MGPROTO_CHAOS_KILL_HOST_AT"] = str(POD_KILL_AT)
        argv = pod_flags(model_dir) + ["--distributed", "--ckpt_format", "sharded",
                                       "--barrier_timeout_s", str(POD_TIMEOUT_S),
                                       "--no_preempt_handlers"]
        log = open(os.path.join(POD_DIR, f"{name}_rank{r}.log"), "w")
        procs.append(Started(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--pod-child", *argv,
             *(["--resume", "auto"] if resume else [])],
            cwd=HERE, stdout=log, stderr=subprocess.STDOUT, env=env), log.name))
    return procs


def pod_wait(procs, timeout=400):
    """[(exit code, wall s)] of the ranks, each waited for in turn."""
    return [p.wait(timeout=timeout) for p in procs]


def pod_digest(model_dir):
    """(the newest resumable checkpoint, the digest of its whole state
    restored here, at world 1)."""
    import argparse

    from mgproto_tpu_torch.cli.common import add_train_args, config_from_args
    from mgproto_tpu_torch.engine.train import Trainer
    from mgproto_tpu_torch.utils import checkpoint as ck

    p = argparse.ArgumentParser()
    add_train_args(p)
    cfg = config_from_args(p.parse_args(pod_flags(model_dir)))
    last = ck.find_latest_checkpoint(model_dir)
    tr = Trainer(cfg, steps_per_epoch=1, device="cuda")
    return last, ck.state_digest(ck.restore_checkpoint(last, tr.init_state(0, for_restore=True)))


def pod_kill_check(clean, kill):
    """16 (c), the kill: the clean pair exits 0; rank 1 of the killed pair
    exits 86, rank 0 exits 75 within the failure agreement's wait (the
    barrier timeout plus the process group's, the same POD_TIMEOUT_S) and
    POD_EXIT_MARGIN_S of rank 1's death, with PEER_LOST.json naming rank 1
    and its flight recorder dumped (unsuffixed: rank 0's name); only
    committed checkpoints are listed."""
    from mgproto_tpu_torch.parallel.multihost import PEER_LOST_EXIT_CODE, PEER_LOST_FILE
    from mgproto_tpu_torch.resilience.chaos import HOST_KILL_EXIT_CODE
    from mgproto_tpu_torch.utils import checkpoint as ck

    for r, (code, _) in enumerate(pod_wait(clean)):
        check(code == 0, f"16 (c) clean rank {r} exited {code}:\n"
              + open(clean[r].out).read()[-3000:])
    codes = pod_wait(kill)
    check(codes[1][0] == HOST_KILL_EXIT_CODE, f"16 (c): the killed rank exited {codes[1][0]}")
    check(codes[0][0] == PEER_LOST_EXIT_CODE, f"16 (c): the survivor exited {codes[0][0]}:\n"
          + open(kill[0].out).read()[-3000:])
    after_s = kill[0].t1 - kill[1].t1
    check(after_s <= 2 * POD_TIMEOUT_S + POD_EXIT_MARGIN_S,
          f"16 (c): the survivor exited {after_s} s after its peer died")
    kill_dir = os.path.join(POD_DIR, "kill")
    with open(os.path.join(kill_dir, PEER_LOST_FILE)) as f:
        marker = json.load(f)
    check(marker["missing_processes"] == [1] and marker["survivor"] == 0,
          f"16 (c): PEER_LOST.json {marker}")
    dump = os.path.join(kill_dir, "telemetry", "flightrec_peer_lost_000.jsonl")
    check(os.path.isfile(dump), "16 (c): no peer_lost dump of rank 0")
    header = json.loads(open(dump).readline())
    check(header["host"] == 0 and header["reason"] == "peer_lost", f"16 (c): dump {header}")
    listed = ck.list_checkpoints(kill_dir)
    names = [n for n in os.listdir(kill_dir) if ck.parse_checkpoint_name(n)]
    check(all(ck.is_committed(os.path.join(kill_dir, n)) for n in names),
          f"16 (c): an uncommitted checkpoint directory is left: {sorted(names)}")
    check([(c[0], c[1]) for c in listed] == [(0, "nopush")], f"16 (c): listed {listed}")
    return {"clean_wall_s": [c[1] for c in pod_wait(clean)], "killed_exit": codes[1][0],
            "survivor_exit": codes[0][0], "survivor_after_kill_s": after_s,
            "marker": {k: marker[k] for k in ("barrier", "missing_processes", "timeout_s")},
            "listed_after_kill": [os.path.basename(c[3]) for c in listed]}


def pod_relaunch_check(smi, relaunch, killed, evaluate):
    """16 (c), the relaunch: both ranks resume from the last commit and end
    at the clean run's state digest, bit for bit; `evaluate` (cli.evaluate
    in one process, the elastic restore of the clean pair's sharded prune
    checkpoint) prints that run's last test accuracy, within one sample."""
    for r, (code, _) in enumerate(pod_wait(relaunch)):
        check(code == 0, f"16 (c) relaunched rank {r} exited {code}:\n"
              + open(relaunch[r].out).read()[-3000:])
    kill_dir = os.path.join(POD_DIR, "kill")
    clean_last, clean = pod_digest(os.path.join(POD_DIR, "clean"))
    last, digest = pod_digest(kill_dir)
    check(os.path.basename(last) == os.path.basename(clean_last),
          f"16 (c): the relaunch ended at {last}, the clean run at {clean_last}")
    check(digest == clean, "16 (c): the relaunched run's state differs from the clean run's")
    records = [json.loads(ln)
               for ln in open(os.path.join(POD_DIR, "clean", "metrics.jsonl"))]
    rc, out, err, eval_s = evaluate.result()
    check(rc == 0, f"16 (c) cli.evaluate of the drill exited {rc}:\n{err[-3000:]}")
    res = last_json(out)
    n_test = OOD_CLASSES * OOD_PER_CLASS
    check(res["checkpoint"] == clean_last
          and abs(res["accuracy"] - records[-1]["acc"]) <= 1 / n_test,
          f"16 (c): evaluate {res} vs the run's last test pass {records[-1]['acc']}")
    # the clean pair's telemetry and the killed pair's (rank 1's stream cut
    # mid-run, the relaunch's appended after it)
    for name in ("clean", "kill"):
        telemetry_dir_check(smi, f"16 (c) {name}", os.path.join(POD_DIR, name))
    emit("distributed", part="c", card=smi, backend=DIST_BACKEND, arch="resnet18",
         global_batch=POD_BATCH * DIST_RANKS, epochs=2, kill_at_step=POD_KILL_AT,
         barrier_timeout_s=POD_TIMEOUT_S, **killed, digest_equal=True,
         relaunch_wall_s=[c[1] for c in pod_wait(relaunch)], final=os.path.basename(last),
         evaluate_wall_s=eval_s, evaluate_accuracy=res["accuracy"],
         run_accuracy=records[-1]["acc"],
         note="two gloo ranks share cuda:0; a lost peer shows first as gloo's connection "
              "error; NCCL's loss path is not shown on one card")


def dist_phase(smi):
    """Phase 16; returns the launch counts of (a)'s ranks (sync and async,
    both meshes and both ranks) and of (d)'s."""
    import concurrent.futures
    import shutil

    import torch

    from mgproto_tpu_torch.engine.train import Trainer
    from mgproto_tpu_torch.utils.checkpoint import save_checkpoint

    t_phase = time.perf_counter()
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    os.makedirs(POD_DIR)
    train = dist_cli_start()
    clean, kill = pod_start("clean"), pod_start("kill", kill=True)
    cub = os.path.join(DIST_DIR, "cub")
    # (d)'s cli.interpret pair waits for (a)'s sharded save to run its main
    pair = interp_cli_start(os.path.join(DIST_DIR, "sharded", "1nopush0.0000"), cub)
    started = [train, *clean, *kill, *pair]
    pool = concurrent.futures.ThreadPoolExecutor(2)
    try:
        cfg = dist_config(TRAIN_BATCH)
        start = Trainer(cfg, steps_per_epoch=100, device="cuda").init_state(0)
        start.memory = full_bank(cfg.model, seed=1)
        ckpt = save_checkpoint(DIST_DIR, start, "start",
                               metadata={"epoch": -1, "stage": "nopush"})
        del start
        batches = dist_batches()
        refs = {"sync": dist_reference(ckpt, batches),
                "floor": dist_reference(ckpt, batches, scale=1 + 1e-7),
                "async": dist_reference(ckpt, batches, async_bank=True),
                "async_floor": dist_reference(ckpt, batches, scale=1 + 1e-7, async_bank=True)}
        torch.cuda.empty_cache()
        # (c)'s first two pairs end, then (b)'s train; the relaunch runs
        # beside (b)'s evaluation and the drill's (of the clean run's
        # sharded checkpoint)
        killed = pod_kill_check(clean, kill)
        relaunch = pod_start("relaunch", resume=True)
        started += relaunch
        train.wait(timeout=400)
        b_eval = pool.submit(run_main, "evaluate", dist_cli_flags() + ["--distributed"], 300,
                             dist_cli_env())
        c_eval = pool.submit(run_main, "evaluate", pod_flags(os.path.join(POD_DIR, "clean")), 300)
        dist_cli_check(smi, train, b_eval)
        pod_relaunch_check(smi, relaunch, killed, c_eval)
        # (a) and (d): the ranks have the card to themselves (their steps are
        # timed) until their save publishes, when the cli.interpret pair starts
        n = write_cub_tree(cub, DIST_INTERP_IMAGES // INTERPRET_PER_CLASS, INTERPRET_PER_CLASS,
                           INPUT_HW, seed=11)
        check(n == DIST_INTERP_IMAGES, f"16 (d): {n} images written")
        wall_s = dist_ranks_run(ckpt, cub)
        launches = {"sync": {}, "async": {}}
        for mesh in DIST_MESHES:
            for part, counts in zip(("sync", "async"), dist_mesh_check(smi, mesh, refs, wall_s)):
                for k, v in counts.items():
                    launches[part][k] = launches[part].get(k, 0) + v
        del refs
        torch.cuda.empty_cache()
        saved = dist_restore_check(smi, DIST_DIR)
        launches["interp"], launches["interpret_cli"] = dist_interp_check(smi, DIST_DIR, saved,
                                                                          cub, pair)
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
        for p in started:
            if p.proc.poll() is None:
                p.proc.kill()
                p.proc.wait()
    emit("distributed", part="phase", seconds=time.perf_counter() - t_phase, launches=launches)
    return launches


def serve_once() -> None:
    """The kernel and serve phases alone; prints `RES ok` or `RES <the serve
    check's failure and its report>`."""
    kernel_phase()
    global profile_phase
    profile_phase = lambda *a, **k: None  # noqa: E731 (the profile is not under test)
    try:
        serve_phase()
        print("RES ok", flush=True)
    except SmokeFailure as e:
        print(f"RES {e}", flush=True)


def repeat_serve(n: int) -> int:
    """`python3 chip_smoke.py --repeat-serve N`: the kernel and serve phases
    in N fresh processes, one line each (`ok`, or the serve check's failure
    with its report, and the serve line's `cpu_reference_departure`), then
    the count of failures and of departures with the largest card vs
    float64 error among them. For a check that fails in some processes
    only (ROADMAP §C, item 3)."""
    fails, departures = 0, []
    for i in range(n):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--serve-once"],
                           cwd=HERE, capture_output=True, text=True, timeout=600)
        res = [ln[4:] for ln in r.stdout.splitlines() if ln.startswith("RES ")]
        res = res[-1] if res else f"exit {r.returncode}: {r.stderr[-1500:]}"
        serve = [json.loads(ln) for ln in r.stdout.splitlines()
                 if ln.startswith('{"phase": "serve"')]
        dep = serve[-1].get("cpu_reference_departure") if serve else None
        fails += res != "ok"
        if dep is not None:
            departures.append(dep)
        print(i, round(time.perf_counter() - t0, 1), res,
              json.dumps({"logits_vs_cpu": serve[-1]["logits_max_abs_err_vs_cpu"] if serve
                          else None, "cpu_reference_departure": dep}), flush=True)
    print(f"failures {fails} of {n}", flush=True)
    print(f"departures {len(departures)} of {n}; card vs float64 at most "
          f"{max((d['card_vs_float64'] for d in departures), default=None)}", flush=True)
    return 0


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "mgproto_tpu_torch")):
        print("chip_smoke: mgproto_tpu_torch/ not found beside this script", file=sys.stderr)
        return 3
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU only", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--repeat-serve"]:
        return repeat_serve(int(sys.argv[2]) if len(sys.argv) > 2 else 30)
    sys.path.insert(0, HERE)
    from mgproto_tpu_torch.numerics import apply_numerics_policy
    from mgproto_tpu_torch.ops import _build

    apply_numerics_policy()
    if sys.argv[1:2] == ["--serve-once"]:
        _build.build_all()
        serve_once()
        return 0
    if sys.argv[1:2] == ["--trust-child"]:
        return trust_child(sys.argv[2:])
    if sys.argv[1:2] == ["--dist-child"]:
        return dist_child(sys.argv[2:])
    if sys.argv[1:2] == ["--dist-probe"]:
        return dist_probe()
    if sys.argv[1:2] == ["--pod-child"]:
        return pod_child(sys.argv[2:])
    if sys.argv[1:2] == ["--interp-child"]:
        return interp_child(sys.argv[2:])
    if sys.argv[1:2] == ["--planner-child"]:
        return planner_child(sys.argv[2:])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit("env", torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0],
         card=smi, device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    emit("probe", image_libraries=image_library_probe())

    t0 = time.perf_counter()
    libs = _build.build_all()
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln] for name in libs}
    emit("build", seconds=time.perf_counter() - t0, libraries=libs, ptxas=ptxas)

    kernels = kernel_phase()
    serve_launches, dispatches = serve_phase()
    train_launches, train_steps = train_phase()
    planner_launches = planner_phase(smi)
    telemetry_cost_check(smi)
    input_launches, input_steps, window_events = input_phase(smi)
    schedule_launches, schedule_cfg, push_ckpt = schedule_phase(smi)
    interpret_launches, interp = interpret_phase(smi, schedule_cfg, push_ckpt)
    epi_bf16, bf16_launches, bf16_steps = options_phase()
    backbone_launches, _ = backbone_phase(smi)
    drill_launches = cli_phase(smi, interp)
    serve_plane_launches, quant_launches, warmup_events = serve_plane_phase(smi)
    elastic_launches, async_steps, elastic_dispatches = elastic_phase(smi)
    online_launches = online_phase(smi)
    trust_launches, trust_dispatches = trust_phase(smi)
    torch.cuda.empty_cache()
    distributed_launches = dist_phase(smi)
    for k in kernels:
        # `launches`: the loader-fed epoch of the input phase (this path's
        # main run); the train phase's and the serve phase's beside them
        k["launches"] = input_launches[k["name"]]
        k["launches_per_input_step"] = k["launches"] / input_steps
        # the observatory: the kernel's device events in the input epoch's
        # profiler window (its launches there times its CUDA kernels a
        # launch) and in phase 12's warmup trace
        k["obs_window_device_events"] = window_events[k["name"]]
        k["serve_warmup_trace_device_events"] = warmup_events[k["name"]]
        k["train_launches"] = train_launches[k["name"]]
        k["launches_per_train_step"] = k["train_launches"] / train_steps
        # the planner's measured flagship steps (one a distinct program)
        k["planner_launches"] = planner_launches[k["name"]]
        check(k["planner_launches"] > 0, f"{k['name']} was not launched by the planner's measure")
        k["serve_launches"] = serve_launches.get(k["name"], 0)
        k["schedule_launches"] = schedule_launches[k["name"]]
        # the interpret run: the trunk's block tails only (its density is
        # plain torch, as in the JAX package)
        k["interpret_launches"] = interpret_launches[k["name"]]
        # the options phase's six bf16 steps at batch 80
        k["bf16_train_launches"] = bf16_launches[k["name"]]
        k["launches_per_bf16_train_step"] = k["bf16_train_launches"] / bf16_steps
        check(k["launches"] > 0, f"{k['name']} was not launched on the input path")
        check(k["train_launches"] > 0, f"{k['name']} was not launched on the train path")
        check(k["bf16_train_launches"] > 0, f"{k['name']} was not launched on the bf16 path")
        # the backbone phase's six steps of each trunk: the epilogue is a
        # resnet kernel, so it must not launch there
        k["backbone_launches"] = {arch: counts[k["name"]]
                                  for arch, counts in backbone_launches.items()}
        for arch, n in k["backbone_launches"].items():
            check((n == 0) == (k["name"] == "bn_epilogue"),
                  f"{k['name']}: {n} launches on the {arch} path")
        # the command-line phase's in-process drills (resnet18)
        k["drill_launches"] = drill_launches[k["name"]]
        check(k["drill_launches"] > 0, f"{k['name']} was not launched in the drills")
        # phase 12's in-process plane: the serving kernels only
        k["serve_plane_launches"] = serve_plane_launches[k["name"]]
        check((k["serve_plane_launches"] > 0) == (k["name"] in ("score_pool", "bn_epilogue")),
              f"{k['name']}: {k['serve_plane_launches']} launches on the serve plane")
        # phase 12 (e): the int8 artifact's engine serving the 64 images
        k["quant_serve_launches"] = quant_launches[k["name"]]
        check((k["quant_serve_launches"] > 0) == (k["name"] in ("score_pool", "bn_epilogue")),
              f"{k['name']}: {k['quant_serve_launches']} launches on the int8 serve")
        # phase 13: the async bank steps (f32 and bf16, their flushes
        # included), the async drills, and the autoscaled and tenant planes
        k["async_launches"] = elastic_launches["async"][k["name"]]
        k["launches_per_async_step"] = k["async_launches"] / async_steps
        k["async_drill_launches"] = elastic_launches["async_drills"][k["name"]]
        check(k["async_launches"] > 0 and k["async_drill_launches"] > 0,
              f"{k['name']} was not launched on the async bank path")
        k["elastic_serve_launches"] = (elastic_launches["autoscale"][k["name"]]
                                       + elastic_launches["tenants"][k["name"]])
        check((k["elastic_serve_launches"] > 0) == (k["name"] in ("score_pool", "bn_epilogue")),
              f"{k['name']}: {k['elastic_serve_launches']} launches on the elastic plane")
        # phase 14: the consolidation of 64 captured samples on the card
        # (4 batches of 16): the eval trunk, the enqueue's score_pool and EM
        k["online_launches"] = online_launches[k["name"]]
        check((k["online_launches"] > 0) == (k["name"] != "score_pool_bwd"),
              f"{k['name']}: {k['online_launches']} launches on the online path")
        # phase 15: the full-width trust matrix process (warmup included)
        k["trust_launches"] = trust_launches[k["name"]]
        k["trust_launches_per_dispatch"] = k["trust_launches"] / trust_dispatches
        check((k["trust_launches"] > 0) == (k["name"] in ("score_pool", "bn_epilogue")),
              f"{k['name']}: {k['trust_launches']} launches on the trust matrix")
        # phase 16 (a): both ranks of both meshes, DIST_STEPS steps each,
        # sync, then async with its flush; (d): the sharded interp pass,
        # the trunk's tails only (its density is plain torch, as in JAX)
        k["distributed_launches"] = distributed_launches["sync"][k["name"]]
        k["distributed_async_launches"] = distributed_launches["async"][k["name"]]
        check(k["distributed_launches"] > 0 and k["distributed_async_launches"] > 0,
              f"{k['name']} was not launched on the two-rank path")
        k["distributed_interp_launches"] = distributed_launches["interp"].get(k["name"], 0)
        check((k["distributed_interp_launches"] > 0) == (k["name"] == "bn_epilogue"),
              f"{k['name']}: {k['distributed_interp_launches']} launches on the sharded "
              "interp pass")
        # (d)'s cli.interpret --distributed pair, both ranks
        k["distributed_interpret_cli_launches"] = distributed_launches["interpret_cli"][k["name"]]
        check((k["distributed_interpret_cli_launches"] > 0) == (k["name"] == "bn_epilogue"),
              f"{k['name']}: {k['distributed_interpret_cli_launches']} launches in the "
              "cli.interpret pair")
        if k["name"] == "bn_epilogue":
            k["train_bf16"] = dict(epi_bf16, launches=bf16_launches["bn_epilogue"])
    emit("script", seconds=time.perf_counter() - T_START, limit_s=1200)
    print(json.dumps({"kernels": kernels, "input_steps": input_steps, "train_steps": train_steps,
                      "serve_dispatches": dispatches, "bf16_train_steps": bf16_steps,
                      "backbone_steps": TRAIN_STEPS, "async_steps": async_steps,
                      "elastic_dispatches": elastic_dispatches,
                      "trust_dispatches": trust_dispatches}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
