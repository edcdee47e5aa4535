#!/usr/bin/env python3
"""Smoke run of the torch port (``monosowa_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. env    — TF32 off for matmuls and convolutions, as the entry points'
            ``resolve_device`` sets it (asserted); the card's name and
            power limit as nvidia-smi reports them.
2. build  — nvcc builds every kernel of the serve, train, label and
            row-fetch paths from ``ops/csrc`` (the LAP solvers of the
            matcher included) and the host compiler builds
            the KITTI evaluation's library from ``evalkitti/csrc``, one
            compiler per source, all started together.
3. kernel — each kernel against its plain PyTorch version at the paths'
            shapes (MSDA forward and backward: the encoder's B=2,
            Q=S=10,200 tokens, with offsets near the reference points and
            with wide ones, and the decoder's Q=50 at serving and Q=550 in
            training, each with the kernel's time inside a replayed CUDA
            graph, its time launched from Python, its block map and the
            levels it keeps in shared memory; the
            template-fitting coverage counts: the fit's rescore shape,
            48 cars x 40 poses, and its fine-pass shape, 4 cars x 360
            poses, of 1000 template points against 2048 scan points, with
            the pairs the kernel's cell list tests (counted by its numpy
            mirror) and the least time for them; the
            windowed row fetch, both forms: the micro-benchmark's 10,240
            rows of a 10,240 x 128 bf16 bank and the 163,200 quad rows one
            image and head of the encoder reads, difference 0 required),
            with error, times, the least time the card could take and,
            where one PyTorch call computes the same function, its time.
   msda_bf16 — the MSDA kernels' bf16 forms (bf16 value rows, float32
            sums) against their plain versions on the same bf16 value at
            the encoder's shape and the decoder's Q=50 and 550 (out, dloc,
            daw within 1e-5 of their magnitude; dvalue within one bf16
            step plus that), with both clocks, the bound at 2-byte rows
            and the float32 forms' numbers of this run beside them.
4. serve  — the full-width MonoDETR (ResNet-50, d_model 256, 3+3 layers,
            seeded random weights, ``compute_dtype="float32"``) answers
            three requests of two 384x1280 images through
            ``run_inference``; the result files are read back, each
            kernel's launch count is checked, and one forward with the
            plain MSDA is compared with the kernel's.
   serve_bf16 — the same with configs/monodetr_kitti.yaml's model
            through ``build_monodetr``, ``compute_dtype`` left at "auto"
            (bf16 activations on the card, asserted on ``value_proj`` and
            the backbone's C5); the bf16 kernels' forward against the plain
            MSDA's on the JAX package's bf16 bars, and the float32 serve's
            numbers beside its own.
5. train  — the float32 model in training mode (50 x 11 Group-DETR queries)
            on ``sample_batch(2, 384, 1280)``.  First, dropout off and from
            the seeded weights, one forward and backward with the kernels
            against one through the plain MSDA (loss dict, gradients) and
            one with the forward kernel and the plain backward (gradients:
            the backward kernel alone).  Then, dropout 0.1, a warm-up step
            and three timed steps of ``make_train_step`` with AdamW and the
            JV matcher on the card (3 ``lap_jv`` launches a step); losses,
            gradient norm and launch counts are checked.  Three more steps
            with the host matcher (scipy) for comparison, and one with the
            auction matcher (3 ``lap_auction`` launches).
   train_bf16 — ``make_train_step`` under "auto" (bf16 on the card):
            from the seeded weights, dropout off, the kernels' step against
            the plain-MSDA step (loss dict on the JAX package's bf16 bar,
            gradients within 5e-2 of their scale: the float32 bar plus ten
            bf16 steps), then a warm-up and three timed steps: launch counts,
            finite losses, float32 params, gradients and AdamW moments.
   detector_variants — configs/monodetr_kitti.yaml's model at its
            widths (float32) with the variants that the JAX package's
            ``build_monodetr`` reads: (a) ``two_stage`` and (b)
            ``use_dab`` + learned position embedding + ``use_depth``
            (4-channel images), each through
            ``build_monodetr``, ``make_train_step`` (JV matcher: a tall
            ``lap_jv`` launch a two_stage step for the encoder match of
            10,200 tokens x 50 padded targets, 12 and 7 valid) and
            ``run_inference``; (c) DN-DETR, 5 groups of 50 slots before
            the 550 queries (800 decoder queries an image), written out as
            the JAX package's tests/test_dn_wiring.py does: ``prepare_dn``,
            the forward, the criterion plus ``dn_loss``, backward, AdamW.
            Each: from the seeded weights, dropout off, the kernels' step
            against the plain-MSDA step and against the forward kernel
            with the plain backward (the train phase's bars, 1e-2 and
            1e-3 of each gradient's scale; the worst tensor of each
            printed), a warm-up
            step with every MSDA and JV launch recorded, three timed steps
            (launch counts held), a request of two images.  Then K1 and
            K2/K3 replayed on the recorded decoder launches (Q = 550, 800;
            1e-5 of each output's magnitude) with both clocks and the
            bound, and the tall ``lap_jv`` on the recorded encoder match:
            equal to the plain JV on the card, at scipy's optimum, its
            times, the plain version's, the scipy route's and the bound.
   train_add — the same model trained on pseudo-label cars
            (``SampleDataset`` with ``use_add_data``, its cars written as
            the labeller's ``optimized_cars`` cache; ``use_tfl`` and
            ``use_mask_loss``; 512 points and 16 cars a frame, masks at
            stride 8, templates of 256 points, 32 gathered queries): from
            the seeded weights, dropout off, the kernels (MSDA, JV)
            against the plain MSDA and the plain JV (loss dict, the
            TFL / mask losses of every layer, gradients), and the
            gradient of ``loss_tfl`` alone in the 3D heads; then a
            warm-up step and three timed steps, with launch counts.
   train_add_bf16 — the same under the bf16 policy: the kernels' step
            against the plain-MSDA step (train_bf16's bars: the loss
            dict, the TFL and mask losses included, within 0.15 of
            |a| + 1; the backward kernel alone within 1e-3 plus four bf16
            steps of each gradient's scale), three timed steps on the bf16
            kernels, float32 params, gradients and moments.
   msda_onehot — configs/monodetr_kitti.yaml's model under
            ``compute_dtype: float32`` with ``msda_backend: onehot``:
            value rounded to bf16 before each MSDA, as the JAX backends
            read it, so three requests and one train step run the bf16
            kernels (6 of each a step) and no float32 one; each MSDA
            launch of the step replayed against the plain versions on the
            same bf16 rows; one request each under ``mxu`` and ``pallas``
            (the same launches and result files).
   ddp    — data parallelism (``monosowa_tpu_torch/parallel``), one train
            step at full width with dropout on against one process on the
            whole batch: a world of one on ``nccl`` (loss dict equal,
            gradients within 1e-5 of the largest) and two processes on
            ``gloo`` with CUDA tensors on the one card, each with half
            the batch (each loss within 2e-4 of itself, gradients within
            2e-4 of the largest; each tensor's own share reported).
   lap    — both LAP kernels (``lap_jv``, ``lap_auction``) against their
            plain versions on the card, assignment for assignment, on 22
            problems of 50 x 50 from a generator (n_valid 0..50, padding
            columns, ties) and on the three cost batches a train_add step
            solved; against scipy (JV at the optimum within rel 1e-6 /
            abs 1e-5, the auction within 5% where no column is padding
            and within its guarantee elsewhere); the kernels' times, the
            plain versions', the host route's and the bound; and the
            device match under torch's sync debug mode.
6. fit    — ``fit_cars_conv`` at the full grid (41 x 41 translations,
            40 thetas, 360 fine thetas) on 16 synthetic cars at known
            poses, standing and moving: x and z within 0.35 m, yaw within
            6 degrees modulo pi; the coarse grid's rounded cuDNN
            correlations against the same correlations without cuDNN.
7. label  — the pseudo-labeller at full width: a synthetic 375x1242
            sequence (about 460k points a frame), one group of 8 reference
            frames with windows of +-6 frames through
            ``PseudoLabeler.label_frames`` (host candidates), one KITTI
            label file per frame, read back and held against the scene.
   label_bank — the same group with depth maps (bank mode: device
            extraction, the point bank, one fit + NMS + re-fit), asserted
            to take the bank path and held against the scene and the label
            phase's files; ``label_frames_stream`` over 3 groups against
            per-group calls, byte for byte, with stage A of a group run
            under torch's sync debug mode; one group at the production
            window of +-30 frames; the device extraction without the bank
            against the banked one on one chunk.  Prints
            ``label_ms_per_frame``, ``host_share``, ``stage_seconds``, each
            fit's device ms, K5 launches and ``peak_mem_GB``.
   label_k360 — the CLI's ``main`` on a KITTI-360 tree of the same
            scene (4 reference frames ``<seq>_<number>``, +-6 windows,
            ``cam0_to_world.txt`` poses with a gap, uncompressed
            ``lidar_raw/`` and ``masks_raw/`` caches, a JSON config):
            ``transformations`` against the ego poses (zero at the gap),
            ``candidates``, ``frames_aggregation``, ``optimization`` over
            the merged cars (the label phase's bars), ``demo`` (the scale
            detector: K5 at B=1 x 3,200 and 160 poses), ``optimization``
            with ``robust_optimization`` (K5 at B=cars x 3,200), every K5
            launch of those two held against the plain version (counts
            equal); the ``chamfer`` loss kind through ``fit_cars_conv``
            at the full grid (seconds a car); the dimension estimator
            through ``label_from_cars`` and the outlier ensemble's four
            votes, card against CPU; the seed-360 frame order and
            ``--dataset all``.  K5's times and bound at the new
            shapes; each step's seconds.
   label_lidar — the label phase's scene as velodyne scans (a 64-beam
            scanner's rows: every 4th pixel row, about 117k points a
            frame, x, y, z, reflectance in the velodyne frame; the cars
            rendered to 85 m; a standing person where no car covers it; the
            nearest car 8-40 m ahead hidden from the first reference
            frame), read by ``load_velo_scan`` / ``velo_to_cam`` and
            labelled by ``label_frames`` with ``use_pseudo_lidar=False``,
            ``strict_hidden_standing`` and ``extract_pedestrians`` (the
            person's mask a job; cars without a reference mask written):
            the hidden car dropped, and back within 2.5 m without the
            strict check; a car beyond 75 m kept; one Pedestrian row a
            frame within 0.5 m of the person; every car within 2.5 m of a
            scene car; every K5 launch against the plain version (counts
            equal); the hidden car's frame with a cut grid (11 x 11 x 8,
            36 fine thetas) on the card and on the CPU, the same label
            file.
8. bench  — the row-fetch micro-benchmark as a user runs it
            (``tools/bench_gather_micro_torch.py`` ``run``, both forms at
            its default shape), against its numpy oracle.
9. epoch  — the loop of ``tools/train_val_torch.py`` ``run`` at full width
            on an in-memory KITTI-like dataset (8 training and 4 test
            images, batch 2): one epoch of 4 train steps, a checkpoint,
            ``test`` (inference, result files, KITTI AP through the native
            library), the best-by-Car-moderate-AP checkpoint; then
            evaluate-only from the checkpoint, which must rewrite the same
            result files byte for byte; and the AP stack on its own ground
            truth, which must score 100.  The steps match with the JV
            kernel, as ``criterion_config_from_yaml`` says.
10. masks — Mask2Former on Swin-B at full width (the JAX package's
            benchmark widths: embed 128, depths 2-2-18-2, window 12, 100
            queries, 80 labels, 6 encoder and 10 decoder layers) from
            seeded weights, the car label's class bias raised so that the
            median query of the first frame reaches 0.7; written as a zoo
            checkpoint by ``save_checkpoint`` and loaded by
            ``zoo.mask_backend`` from a config; the driver's
            ``mask_tracking`` over 4 seeded 375x1242 frames (handed to its
            ``_image`` by a subclass: no PIL on the card's machine), 6 MSDA
            launches a frame; the same forwards with the plain MSDA (class
            and mask logits within 1e-5 of their magnitude where the
            kernel's decoder takes the plain forward's attention masks,
            within 1e-3 free-running, with the attention entries that
            flipped counted; the written masks equal to the kernel
            forward's, and to the plain forward's except where |logit| is
            under 1e-3 of its magnitude); K1 alone on
            the inputs of the pixel decoder's six launches (3 levels, B=1,
            Q=S=10,080) with both clocks and the bound.  Prints
            ``mask_ms_per_frame``, the forward's ms, the device's busy
            share and ``peak_mem_GB``.
    depth — Depth Anything Large (DINOv2-L, 24 layers, metric, max 80 m)
            at full width from seeded weights through a zoo checkpoint and
            the driver's ``lidar_scans`` over 2 frames (input 518x1722):
            depth finite in [0, 80], ``lidar_raw/`` read back by
            ``load_pseudo_lidar``; a 2-layer copy on the card against the
            same weights on the CPU (2e-4 of max_depth).  Prints
            ``depth_ms_per_frame``, the forward's ms, the busy share and
            ``peak_mem_GB``.
    sam   — SAM ViT-H at full width (hidden 1280, 32 layers, 16 heads,
            global attention at layers 7, 15, 23, 31, window 14, input
            1024) from seeded weights, kernels at unit gain, written by
            ``save_checkpoint`` (stored, not deflated) and loaded by
            ``zoo.sam_refine_backend`` from ``paths.sam_path``; the
            driver's ``mask_tracking`` with ``use_SAM`` and
            ``extract_pedestrians`` over the 4 frames with the masks
            phase's Mask2Former (6 MSDA launches a frame; queries kept
            from 0.5, so some masks sit below SAM's 0.7).  Holds: (a) a
            2-layer copy (layer 1 global) on the card against the CPU on
            one frame's boxes, low-res logits and IoU within 1e-4 of their
            magnitude; (b) the full depth in float32 against float64 on the
            card (embedding, logits, IoU within 1e-3), the written masks
            equal to the float64 forward's where |logit| clears 1e-3 of its
            magnitude, the flips counted; (c) every car mask above 0.7
            replaced by SAM's refinement of its box, the others (0.5 to
            0.7) byte for byte the detector's, the files reload; (d) K1
            on the inputs of the pixel decoder's six launches.  Prints
            the encoder's ms and its bound, the decoder's ms a chunk of 16
            boxes, ``sam_ms_per_frame``, ``mask_ms_per_frame`` with SAM,
            the busy share and ``peak_mem_GB``.
    images_to_labels — the driver's ``optimization`` over the masks_raw/
            and lidar_raw/ the two phases wrote, 2 frames: one label file
            each (content not judged: random weights).
    waymo — raw Waymo segments through ``sowa/cli.py``'s
            ``WaymoSegmentDriver`` at Waymo's sizes: a seeded segment of 6
            frames, 5 cameras (1280 x 1920; the side cameras 886 x 1920,
            handed to the driver in memory: no PIL there), a standing and
            a moving car in the FRONT camera, fused LiDAR (about 216k
            points: the cars and the ground in the FRONT camera's view,
            the ground in the other four cameras') and poses written with
            numpy.  (a) ``homographies`` through a
            scene matcher (true correspondences, 30% outliers: RANSAC on the
            host; every H within 1 px of the truth at the camera's
            corners); ``mask_tracking`` over the scene's car masks as a
            masks_raw cache (1380 x 4590 pair canvases stitched on the
            card, the template tracker on the card; each car tracked over
            the segment); ``transformations``; ``optimization`` at the
            shipped grid (every K5 launch replayed against the plain
            version; the standing car within 0.35 m of the truth); the
            reference frame at a cut grid on the card and on the CPU, the
            same label file.  The window run: the reference frame of a
            61-frame segment (its motion a tenth, so that both cars stay
            in view) labelled at the shipped config's +-30 scans, through
            ``mask_tracking``, ``transformations`` and ``optimization``
            (the standing car within 0.35 m).  ``mask_tracking`` again with the masks
            phase's Mask2Former on the canvases (its 384 x 1280 encode; the
            threshold keeps 3 queries of the first canvas): 6 K1 launches
            a canvas, K1 held on one canvas's recorded inputs.  (b)
            EfficientLoFTR at full width (seeded, a zoo checkpoint) through
            ``backends.matcher: loftr`` on the segment's pairs at 480 x
            640: ms a pair.  Its checks run at a match threshold of 1e-6
            (random weights match nothing above 0.2) on the FRONT image
            beside itself moved 64 columns (the segment's cameras are
            independent noise), so that matches exist: float32 against float64 on the card at full depth
            (coarse features, fine-fusion windows and matched scores
            within 1e-3 of their magnitude, keypoints within 1e-5 of the
            image size where the matches agree), 2 attention layers on
            the card against the CPU (1e-4); flipped matches and
            keypoints counted, at most 1% of the coarse cells.  The ViT tracker at full width through
            ``backends.tracker: vit``: steps, ms a step, card against CPU
            (1e-4).  Prints each action's ms a frame, the stages' seconds,
            the host share of a live mask frame and ``peak_mem_GB``.
    optional_stages — the labeller's stages that the shipped config
            leaves off, through their own functions (no CLI flag reads
            them): (a) ICP poses: a seeded street (buildings 9-13 m to
            each side, parked cars) cast by a 64-beam scanner's 115,200
            rays a frame at 80 m, 1 m a frame at one speed on a curve;
            ``icp_window_transforms_v2`` (an odometry prior 0.16 m and 0.4
            degrees off a pair) and ``icp_window_transforms`` around the
            middle frame at +-130, jump 5, 4,096 points, 20 iterations,
            k = 10: v2's frames registered straight to the reference
            (+-4) held to the truth (5 cm, 0.5 degrees), its anchors',
            the +-30 frames', the window's errors and v1's printed; one
            pair on the card against the CPU port (1e-4); ms a pair, s a
            window, pairs a window.  (b) ``perform_growing_frame`` for
            each car mask of the label scene's 375 x 1242 pseudo-LiDAR
            frame (a point a pixel): the grown points inside the mask's
            car grown by 0.3 m where the car shows, none where a nearer
            car covers it; on the CPU at full resolution the recorded
            rounds of at most 5 M edges (the same region) and the largest
            round's labels at 0.1 m (equal); card and CPU equal on every
            4th row and column; each round's crop and edges, ms a mask,
            ``peak_mem_GB``.  (c) ``fit_deformable_batch`` at
            ``DeformConfig()`` (1,000 steps) with ``make_car_mesh()``
            (288 vertices) on 16 cars of 2,048 points: finite, scales
            clipped, mean vertex-to-scan distance under 0.25 m; 30 steps
            card against CPU (1e-4 of the vertices' scale); s a batch,
            launches a step, busy share.  (d) ``fit_cars`` (the
            gather-field fit) on 16 cars at ``FitConfig()``, one car's
            standing and moving fits on the CPU too (poses equal); ms a
            batch.  (e) ``custom_dataset``: the standing cars saved,
            loaded and re-fitted by ``evaluate_fitting_on_pairs`` through
            (d)'s fit, the IoUs those of the batch fit.  The fine theta
            pass of (d) and (e) launches ``tfl_counts``: counted (in the
            ``kernels`` line) and each launch replayed against the plain
            version.
11. kernels — one line listing every ported kernel with its numbers.

The last line is ``{"ok": true, "device": {...}}``.  Any failed phase
raises and the script exits non-zero without it; so does a machine
without a GPU.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_FLOPS = 67e12            # H100 SXM float32 outside the tensor cores
ENC_SHAPES = ((48, 160), (24, 80), (12, 40), (6, 20))   # 384x1280 pyramid
M_HEADS, D_HEAD, N_POINTS = 8, 32, 4
IMG_H, IMG_W, BATCH, REQUESTS = 384, 1280, 2, 3
MSDA_PER_FORWARD = 6          # 3 encoder + 3 decoder layers
KERNELS = ("msda_fwd", "msda_bwd", "tfl_counts", "row_fetch", "lap")
TRAIN_STEPS = 3
TRAIN_QUERIES = 50 * 11       # num_queries x group_num
LAP_PER_STEP = 3              # matches a step: the final and 2 aux layers
LAP_Q = LAP_M = 50            # queries a group; padded targets (max_objs)
LAP_PROBLEMS = BATCH * 11     # one per (image, Group-DETR group)
MATCH_BIG = 1e6               # the matcher's cost of a padding column
# use_add_data at the shipped config's widths
ADD_DATA = {"add_data_points": 512, "max_add_cars": 16, "add_mask_stride": 8}
TFL_GATHER_K = 32
TFL_T, TFL_S, TFL_RADIUS = 1000, 2048, 0.2   # template, scan, threshold
TFL_PER_FIT = 3               # rescore, half-pitch refinement, fine pass
BANK_S = 10 * (TFL_S // 10)   # bank mode's scan: 10 slots x 204 points
FIT_CARS = 16
LABEL_FRAMES, LABEL_WINDOW = 8, 6
LABEL_STREAM_GROUPS, PRODUCTION_WINDOW = 3, 30
# row fetch: the micro-benchmark's shape and the quad rows (4 levels x 4
# points per token) that one image and head of the encoder reads
RF_T, RF_D, RF_BQ = 10240, 128, 256
RF_ROWS = {"K6": RF_T, "encoder head": 10200 * 16}
EPOCH_TRAIN, EPOCH_VAL, PERFECT_IMAGES = 8, 4, 16
# the model zoo: KITTI frames, Mask2Former's input (the zoo's
# mask_input_hw), Depth Anything's input size (518 x 1722 for a 375 x 1242
# frame)
ZOO_HW, MASK_INPUT_HW = (375, 1242), (384, 1280)
MASK_FRAMES, DEPTH_FRAMES, DEPTH_INPUT_SIZE = 4, 2, 518
CAR_LABEL = 2                 # COCO's car (the zoo's mask_car_labels)
# kernel vs plain MSDA through a whole Mask2Former forward on the same
# decoder attention masks, of the outputs' magnitude (ROADMAP's
# kernel-vs-plain bar: float32 sums in another order)
MASK_LOGIT_BAR = 1e-5
# the free-running forwards (each on its own attention masks, which can flip
# at a logit of 0; the serve phase's whole-forward bar): a written mask's
# pixel may differ only where the plain forward's resized logit is within
# this of 0, and a query be kept by one forward only where its probability
# is within this of the threshold
WHOLE_FORWARD_BAR = 1e-3
# a 2-layer Depth Anything, the card against the CPU: float32 sums in
# another order through 2 transformer layers and 20 convolutions, of
# max_depth (ROADMAP's transformer-layer bars are 2e-4 to 3e-4)
DEPTH_CPU_BAR = 2e-4
# SAM ViT-H (sam phase): a 2-layer copy, the card against the CPU, of the
# outputs' magnitude (float32 sums in another order through 2 layers of
# 1280 channels and the decoder); the full depth in float32 against the
# same weights in float64 on the card (32 layers: the serve phase's
# whole-forward bar); refine_masks' score threshold
SAM_CPU_BAR = 1e-4
SAM_F64_BAR = 1e-3
SAM_SCORE, SAM_DETECTOR_SCORE = 0.7, 0.5
# label_lidar: the label phase's scene as velodyne scans (a 64-beam
# scanner's density: every 4th pixel row, about 117k points a frame), the
# cars rendered to 85 m, one standing person; velodyne -> camera as
# KITTI's axes with a lever arm
LIDAR_ROW_STEP, LIDAR_Z_MAX = 4, 85.0
T_CAM_VELO = ((0.0, -1.0, 0.0, 0.06), (0.0, 0.0, -1.0, -0.08),
              (1.0, 0.0, 0.0, -0.27), (0.0, 0.0, 0.0, 1.0))
# the CPU comparison's grid (the full one takes minutes a frame on the
# host): the label tests' 11 x 11 x 8 coarse and 36 fine thetas
LIDAR_CPU_GRID = {"n_dx": 11, "n_dz": 11, "n_theta": 8, "n_theta_fine": 36}
AP_KEYS = tuple(f"car_{m}_{s}" for s in ("strict", "loose")
                for m in ("bbox", "bev", "3d"))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time in ms of ``iters`` calls of fn() launched back to back
    from Python (the device's time or the host's launch rate)."""
    from monosowa_tpu_torch.timing import launched_ms

    return launched_ms(fn, iters, warmup)


def device_ms(fn, iters: int) -> float:
    """Mean device time of fn() in ms inside a replayed CUDA graph."""
    from monosowa_tpu_torch.timing import device_ms as graph_ms

    return graph_ms(fn, iters)


def ptxas_registers(log: str) -> dict:
    """Registers and spilled bytes of each kernel in nvcc's ``-Xptxas -v``
    output, by mangled name (an MSDA kernel's ``ILi4ELi8E`` is its
    instantiation for 4 channels a lane and 8 lanes a query)."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            name = found.group(1)
            out[name] = {}
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill and name:
            out[name]["spill_bytes"] = int(spill.group(1)) \
                + int(spill.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            out[name]["registers"] = int(used.group(1))
    return out


def msda_inputs(rng, q: int, ref, dev, wide: bool = False):
    """value, loc, aw for MSDA at the 384x1280 pyramid.  loc sits at the
    reference points plus ring-pattern offsets of the sampling-offset
    bias, jittered by half a pixel (an untrained model's offsets), or, with
    ``wide``, plus offsets with a standard deviation of 4 pixels of each
    level (far less local); 2% of the samples are redrawn in [-0.15, 1.15]
    so out-of-bounds corners are covered."""
    import numpy as np
    import torch

    from monosowa_tpu_torch.models.transformer import ring_bias

    b, m, d, p, n_lv = BATCH, M_HEADS, D_HEAD, N_POINTS, len(ENC_SHAPES)
    s = sum(h * w for h, w in ENC_SHAPES)
    ring = ring_bias(m, n_lv, p).reshape(1, 1, m, n_lv, p, 2)
    if wide:
        offs = rng.normal(0, 4.0, (b, q, m, n_lv, p, 2))
    else:
        offs = ring * rng.uniform(0.5, 1.5, (b, q, m, n_lv, p, 1)) \
            + rng.normal(0, 0.5, (b, q, m, n_lv, p, 2))
    norm = np.array([[w, h] for h, w in ENC_SHAPES], np.float32)
    loc = ref[:, :, None, :, None, :] + offs / norm[:, None, :]
    wild = rng.random((b, q, m, n_lv, p)) < 0.02
    loc[wild] = rng.uniform(-0.15, 1.15, (int(wild.sum()), 2))
    logits = rng.normal(size=(b, q, m, n_lv * p))
    aw = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    value = rng.normal(size=(b, s, m, d))
    return tuple(torch.from_numpy(a.astype(np.float32)).to(dev)
                 for a in (value, loc, aw.reshape(b, q, m, n_lv, p)))


def msda_bound(value, loc, other_bytes: int, macs_per_corner: int,
               shapes=ENC_SHAPES):
    """Least time for the work: compulsory bytes over the memory rate, and
    the operations the in-bounds corners need (``macs_per_corner``
    multiply-adds per channel, float32 whatever value's type) over the
    float32 rate.  The bytes are ``other_bytes`` (the other inputs read once
    and the outputs written once) and of value only the distinct (b, token,
    head) rows that some in-bounds corner of this run's samples reads, once
    each, in value's own type (2 bytes a channel in bf16).  Returns
    (bound_ms, bound_by, bytes, flops, corners per level, value_rows)."""
    import torch

    from monosowa_tpu_torch.ops.msda import _corner_geometry

    b, s, m, d = value.shape
    bi = torch.arange(b, device=loc.device).view(b, 1, 1, 1)
    mi = torch.arange(m, device=loc.device).view(1, 1, m, 1)
    keys, corners, start = [], [], 0
    for lvl, (h, w) in enumerate(shapes):
        corners.append(0)
        for flat, _, _, _, inb in _corner_geometry(loc[:, :, :, lvl], h, w):
            hit = inb > 0
            corners[lvl] += int(hit.sum().item())
            keys.append(((bi * s + start + flat) * m + mi)[hit])
        start += h * w
    value_rows = int(torch.unique(torch.cat(keys)).numel())
    nbytes = value_rows * d * value.element_size() + other_bytes
    flops = 2 * macs_per_corner * d * sum(corners)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    return (max(t_bytes, t_ops) * 1e3, bound_by, nbytes, flops, corners,
            value_rows)


def msda_report(label, q, value, loc, err, kernel, plain, bound, rows_moved,
                shapes=ENC_SHAPES) -> dict:
    """The numbers of one MSDA kernel at one shape: its time inside a
    replayed CUDA graph and launched from Python, the plain version's time,
    the bound, the block map, and the rate at which corner rows are
    consumed: all of them, and those of the levels that are not resident in
    shared memory (the most that L2 can have served; what L1 serves lowers
    it further).  ``rows_moved`` is 1 for the forward (a row read) and 2
    for the backward (a row read and a row of adds)."""
    from monosowa_tpu_torch.ops import msda

    bound_ms, bound_by, nbytes, flops, corners, value_rows = bound
    plan = msda.msda_plan(shapes, q, N_POINTS, D_HEAD, value.device,
                          value.element_size())
    row = D_HEAD * value.element_size()
    b = value.shape[0]
    res = {
        "shape": f"{label}: B={b} Q={q} S={value.shape[1]} "
                 f"M={M_HEADS} D={D_HEAD} L={len(shapes)} P={N_POINTS}",
        **err,
        "ms": device_ms(kernel, 50),
        "ms_launched_from_python": cuda_ms(kernel, 50),
        "plain_ms": cuda_ms(plain, 5),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "compulsory_bytes": nbytes, "flops": flops,
        "value_row_bytes": value_rows * row,
        "corner_row_bytes": sum(corners) * row,
        "corner_row_bytes_resident": sum(corners[lvl]
                                         for lvl in plan.resident) * row,
        "blocks": plan.n_runs * b * M_HEADS, "runs": plan.n_runs,
        "longest_run": plan.max_run, "tiled_order": not plan.identity,
        "resident_levels": list(plan.resident),
        "resident_bytes": plan.resident_bytes,
        "grad_levels_in_shared": list(plan.grad),
        "grad_bytes": plan.grad_bytes,
    }
    res["corner_rate_TBps"] = rows_moved * res["corner_row_bytes"] \
        / res["ms"] / 1e9
    res["l2_corner_rate_TBps"] = rows_moved * (
        res["corner_row_bytes"] - res["corner_row_bytes_resident"]) \
        / res["ms"] / 1e9
    return res


def check_msda(rng, q: int, ref, label: str, dev, wide: bool = False,
               bf16: bool = False) -> dict:
    """The forward kernel against the plain forward on the same inputs,
    with a float32 value or, with ``bf16``, the same value rounded to
    bfloat16 (the kernel's bf16 form; out float32 in both)."""
    import torch

    from monosowa_tpu_torch.ops import msda

    value, loc, aw = msda_inputs(rng, q, ref, dev, wide)
    if bf16:
        value = value.to(torch.bfloat16)
    out_k = msda.ms_deform_attn(value, ENC_SHAPES, loc, aw)
    out_p = msda.ms_deform_attn_plain(value, ENC_SHAPES, loc, aw)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    scale = float(out_p.abs().max())
    # float32 sums in another order (of the same bf16 rows in the bf16
    # form): 1e-5 of the output's magnitude
    if not (out_k.dtype == torch.float32 and torch.isfinite(out_k).all()
            and err <= 1e-5 * scale):
        raise AssertionError(f"msda_fwd {label}: max abs err {err} > "
                             f"1e-5 * {scale}, {out_k.dtype}")
    # loc and aw read once, out written once; one multiply-add per channel
    return msda_report(
        label, q, value, loc, {"max_abs_err": err, "max_abs_out": scale},
        lambda: msda.ms_deform_attn(value, ENC_SHAPES, loc, aw),
        lambda: msda.ms_deform_attn_plain(value, ENC_SHAPES, loc, aw),
        msda_bound(value, loc, 4 * (loc.numel() + aw.numel()
                                    + out_k.numel()), 1), 1)


def bf16_step(x):
    """One bfloat16 step (unit in the last place) at each element's
    magnitude: 2**-7 of the power of two at or below it."""
    import torch

    mag = x.float().abs().clamp(min=1e-30)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def check_msda_bwd(rng, q: int, ref, label: str, dev, wide: bool = False,
                   bf16: bool = False) -> dict:
    """The backward kernel (dvalue, dloc, daw in one call) against the
    plain backward on the same inputs and a random incoming gradient; with
    ``bf16`` on the same value rounded to bfloat16 (dvalue then bf16, the
    float32 sum rounded once, as the plain version rounds its own)."""
    import numpy as np
    import torch

    from monosowa_tpu_torch.ops import msda

    value, loc, aw = msda_inputs(rng, q, ref, dev, wide)
    if bf16:
        value = value.to(torch.bfloat16)
    dout = torch.from_numpy(rng.normal(
        size=(BATCH, q, M_HEADS * D_HEAD)).astype(np.float32)).to(dev)

    def plain():
        dloc, daw = msda.msda_grad_loc_aw_plain(value, ENC_SHAPES, loc, aw,
                                                dout)
        return (msda.msda_grad_value_plain(value.shape, ENC_SHAPES, loc, aw,
                                           dout, value.dtype), dloc, daw)

    got = msda._launch_bwd(value, ENC_SHAPES, loc, aw, dout)
    want = plain()
    torch.cuda.synchronize()
    errs = {}
    for name, g, w in zip(("dvalue", "dloc", "daw"), got, want):
        diff = (g.float() - w.float()).abs()
        err, scale = float(diff.max()), float(w.float().abs().max())
        errs[name] = {"max_abs_err": err, "max_abs": scale}
        # float32 sums in another order (dvalue's atomics in a different
        # order in every run): 1e-5 of the output's magnitude; a bf16
        # dvalue, those sums rounded once, one bf16 step more
        bar = torch.full_like(diff, 1e-5 * scale)
        if bf16 and name == "dvalue":
            step = bf16_step(torch.maximum(g.float().abs(), w.float().abs()))
            bar = bar + step
            errs[name]["max_bf16_steps"] = float((diff / step).max())
        if not (g.dtype == w.dtype and torch.isfinite(g).all()
                and bool((diff <= bar).all())):
            raise AssertionError(f"msda_bwd {label} {name}: max abs err "
                                 f"{err}, max abs {scale}, {g.dtype}")
    # loc, aw and dout read once; dvalue (value's type), dloc and daw
    # written once; two multiply-adds per channel and in-bounds corner (the
    # dot for dloc and daw, the scatter for dvalue)
    return msda_report(
        label, q, value, loc,
        {"max_abs_err": max(e["max_abs_err"] for e in errs.values()),
         "outputs": errs},
        lambda: msda._launch_bwd(value, ENC_SHAPES, loc, aw, dout), plain,
        msda_bound(value, loc, 4 * (2 * (loc.numel() + aw.numel())
                                    + dout.numel())
                   + value.numel() * value.element_size(), 2), 2)


def synthetic_car(rng, template, moving: bool, n_ground: int = 740):
    """One car's scan as the labeller's aggregation hands it to the fit: the
    template posed at a known pose with 0.02 m noise, plus ground points.
    A moving car's ground points lie mostly on the camera's side of it, so
    the median of its scan lies before its center, as the +1 m shift of
    the moving-car grid expects.  Returns (points (n, 3) float32, pose
    dict)."""
    import numpy as np

    theta = rng.uniform(0, 2 * np.pi)
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    pose = np.array([rng.uniform(-8, 8), 0.9, rng.uniform(8, 40)])
    car = template @ rot.T + pose + rng.normal(scale=0.02,
                                               size=template.shape)
    z_lo, z_hi = (-12, 2) if moving else (-8, 8)
    ground = np.stack([pose[0] + rng.uniform(-8, 8, n_ground),
                       np.full(n_ground, 1.66),
                       pose[2] + rng.uniform(z_lo, z_hi, n_ground)], 1)
    return (np.concatenate([car, ground]).astype(np.float32),
            {"x": pose[0], "z": pose[2], "theta": theta})


def tfl_inputs(rng, b: int, p: int, dev, t: int = TFL_T, s: int = TFL_S):
    """scan (B, S, 3), mask (B, S), posed templates (B, P, T, 3) as the fit
    makes them: per car a noisy posed template plus ground points, padded
    to S with a masked tail and a few masked points inside; P poses around
    the true one (all thetas of a P-step circle at P >= 360, else 5 thetas
    x P / 5 translations near the truth)."""
    import numpy as np
    import torch

    from monosowa_tpu_torch.sowa.fitting import _pose_template
    from monosowa_tpu_torch.sowa.templates import TemplateBank

    template = TemplateBank.default(num_points=t).points[0]
    scan = np.zeros((b, s, 3), np.float32)
    mask = np.zeros((b, s), bool)
    thetas = np.zeros((b, p), np.float32)
    trans = np.zeros((b, p, 3), np.float32)
    for i in range(b):
        pts, pose = synthetic_car(rng, template, False,
                                  n_ground=min(740, s - t))
        center = np.median(pts, axis=0)
        scan[i, :len(pts)] = pts - center
        mask[i, :len(pts)] = True
        mask[i, 7:len(pts):29] = False
        true_t = np.array([pose["x"], 0.9, pose["z"]]) - center
        if p >= 360:
            thetas[i] = np.linspace(0, 2 * np.pi, p, endpoint=False)
            trans[i] = true_t
        else:
            n_tr = p // 5
            thetas[i] = np.tile(pose["theta"] + 0.157 * np.arange(-2, 3),
                                n_tr)
            trans[i] = np.repeat(true_t + rng.normal(
                scale=0.1, size=(n_tr, 3)) * [1, 0, 1], 5, axis=0)
    scan_d, mask_d = torch.from_numpy(scan).to(dev), \
        torch.from_numpy(mask).to(dev)
    posed = _pose_template(torch.from_numpy(template).to(dev),
                           torch.from_numpy(thetas).to(dev)) \
        + torch.from_numpy(trans).to(dev)[:, :, None, :]
    return scan_d, mask_d, posed.contiguous()


def tfl_work(scan, mask, posed) -> dict:
    """What the coverage counts must do on these inputs.  Bytes: templates,
    scan and mask read once, two (B, P) outputs written once.  Operations:
    8 float32 operations (3 subtractions, 3 products, 2 sums) per pair the
    cell list tests (``cell_pairs``: a template point against the staged
    scan points of its 3 x 3 x 3 cells, counted by the kernel's numpy
    mirror ``tfl.cell_walk`` on the same inputs); ``pairs`` is every pair
    of a template point and a valid scan point, what the all-pairs design
    had to test."""
    from monosowa_tpu_torch.ops import tfl

    b, p, t, _ = posed.shape
    nbytes = 4 * (posed.numel() + scan.numel() + 2 * b * p) + mask.numel()
    pairs = int(mask.sum().item()) * p * t
    cell_pairs = int(tfl.cell_walk(scan.cpu().numpy(), mask.cpu().numpy(),
                                   posed.cpu().numpy(), TFL_RADIUS,
                                   hits=False)[2].sum())
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 8 * cell_pairs / FP32_FLOPS
    return {"compulsory_bytes": nbytes, "pairs": pairs,
            "cell_pairs": cell_pairs, "flops": 8 * cell_pairs,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "all_pairs_bound_ms": max(t_bytes, 8 * pairs / FP32_FLOPS)
            * 1e3}


def check_tfl(rng, b: int, p: int, label: str, dev, t: int = TFL_T,
              s: int = TFL_S, masked_rows: int = 0) -> dict:
    """The coverage-count kernel against its plain version: counts of pairs
    under the same float32 squared distance, so the fractions are equal
    (the bar is 1e-6, a count of one is 1e-3).  The last ``masked_rows``
    cars have every scan point masked, as the bank's re-fit rows without
    a target do."""
    import torch

    from monosowa_tpu_torch.ops import tfl

    scan, mask, posed = tfl_inputs(rng, b, p, dev, t, s)
    if masked_rows:
        mask[b - masked_rows:] = False

    def kernel():
        return tfl.binary_both_way_counts(scan, mask, posed, TFL_RADIUS)

    def launch():       # the kernel alone, without the wrapper's divisions
        return tfl._launch_counts(scan, mask, posed, TFL_RADIUS)

    def plain():
        return tfl._fractions(
            *tfl.binary_both_way_counts_plain(scan, mask, posed, TFL_RADIUS),
            mask, t)

    got = kernel()
    want = plain()
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    if not (all(torch.isfinite(g).all() for g in got) and err <= 1e-6):
        raise AssertionError(f"tfl_counts {label}: max abs err {err} > 1e-6")
    if not (float(got[0].max()) > 0.5 and float(got[1].max()) > 0.3):
        raise AssertionError(f"tfl_counts {label}: the poses around the "
                             f"truth cover too little: {float(got[0].max())}"
                             f", {float(got[1].max())}")
    return {
        "shape": f"{label}: B={b} P={p} T={t} S={s} "
                 f"valid={int(mask.sum().item()) / b:.0f}"
                 + (f" all-masked rows={masked_rows}" if masked_rows else ""),
        "max_abs_err": err, "max_t_frac": float(got[0].max()),
        "max_s_frac": float(got[1].max()),
        # a replayed CUDA graph cannot hold the wrapper's divisions (they
        # copy a host scalar): the graph clock times the launch alone
        "ms": device_ms(launch, 20),
        "ms_launched_from_python": cuda_ms(kernel, 20),
        "plain_ms": cuda_ms(plain, 2, warmup=1),
        **tfl_work(scan, mask, posed),
    }


def fit_check(dev, n_cars: int = FIT_CARS, fit_cfg=None) -> dict:
    """``fit_cars_conv`` through the kernel on cars at known poses, the
    bars of the JAX package's tests/test_pipeline_e2e.py (x, z within
    0.35 m, yaw within 6 degrees modulo pi).  Even cars stand; odd cars
    move, with a trajectory angle 2 degrees off the truth."""
    import numpy as np
    import torch

    from monosowa_tpu_torch.ops import tfl
    from monosowa_tpu_torch.sowa import fitting
    from monosowa_tpu_torch.sowa.templates import TemplateBank

    rng = np.random.default_rng(2)
    cfg = fit_cfg or fitting.FitConfig()
    template = TemplateBank.default().points[0]
    t0 = time.perf_counter()
    spec, occ, memb = fitting.make_conv_kernels(template, cfg, dev)
    kernels_s = time.perf_counter() - t0
    pts = np.zeros((n_cars, TFL_S, 3), np.float32)
    mask = np.zeros((n_cars, TFL_S), bool)
    moving = np.arange(n_cars) % 2 == 1
    theta_est = np.zeros(n_cars, np.float32)
    truth = []
    for i in range(n_cars):
        p, pose = synthetic_car(rng, template, bool(moving[i]))
        pts[i, :len(p)], mask[i, :len(p)] = p, True
        theta_est[i] = pose["theta"] + np.deg2rad(2.0) if moving[i] else 0
        truth.append(pose)
    batch = fitting.CarBatch(pts, mask, moving, theta_est, moving.copy(),
                             np.ones(n_cars, bool))
    tmpl = torch.as_tensor(template, device=dev)
    fitting.fit_cars_conv(batch, tmpl, occ, memb, spec, cfg)     # warm-up
    torch.cuda.synchronize()
    before = tfl.launches
    t0 = time.perf_counter()
    res = fitting.fit_cars_conv(batch, tmpl, occ, memb, spec, cfg)
    torch.cuda.synchronize()
    fit_ms = (time.perf_counter() - t0) * 1e3
    launches = tfl.launches - before
    if launches != TFL_PER_FIT:
        raise AssertionError(f"fit_cars_conv launched tfl_counts {launches} "
                             f"times, not {TFL_PER_FIT}")
    x, z, theta = (getattr(res, k).cpu().numpy() for k in ("x", "z", "theta"))
    dx = np.abs(x - [t["x"] for t in truth])
    dz = np.abs(z - [t["z"] for t in truth])
    dth = np.abs((theta - [t["theta"] for t in truth] + np.pi)
                 % (2 * np.pi) - np.pi)
    dyaw = np.degrees(np.minimum(dth, np.abs(dth - np.pi)))
    if not (np.isfinite([x, z, theta]).all() and dx.max() < 0.35
            and dz.max() < 0.35 and dyaw.max() < 6.0):
        raise AssertionError(f"fit: |dx| {dx.tolist()} |dz| {dz.tolist()} "
                             f"yaw deg {dyaw.tolist()}")

    # the tie order the rescore relies on, on the card: argmin is the first
    # minimum, a stable sort lists equal values by index
    ties = torch.tensor([[3, 1, 2, 1, 5, 1, 2, 0, 0, 4.]], device=dev)
    first = int(ties.argmin(dim=1))
    lowest = torch.sort(ties, dim=1, stable=True).indices[0, :6].tolist()
    if first != 7 or lowest != [7, 8, 1, 3, 5, 2]:
        raise AssertionError(f"tie order on the card: argmin {first}, "
                             f"stable sort {lowest}")

    # the coarse grid's counts are whole numbers: the rounded cuDNN
    # correlations against the same correlations without cuDNN
    local = torch.as_tensor(pts, device=dev) - res.center[:, None]
    mask_d = torch.as_tensor(mask, device=dev)
    got = tfl.grid_pose_counts_conv(local, mask_d, occ, memb, spec)
    counts_yxz, memb_yxz = tfl._conv_fields(local, mask_d, spec)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        raw = (torch.nn.functional.conv2d(memb_yxz, occ),
               torch.nn.functional.conv2d(counts_yxz, memb))
    with torch.backends.cudnn.flags(enabled=False):
        want = (torch.nn.functional.conv2d(memb_yxz, occ),
                torch.nn.functional.conv2d(counts_yxz, memb))
    for name, g, w in zip(("count_t", "count_s"), got, want):
        if not (torch.equal(w, w.round()) and torch.equal(g, w)):
            raise AssertionError(
                f"coarse grid {name}: rounded cuDNN correlation differs "
                f"from the correlation without cuDNN by "
                f"{float((g - w).abs().max())}")
    return {"phase": "fit", "cars": n_cars, "standing": int((~moving).sum()),
            "moving": int(moving.sum()), "grid": [spec.n_dx, spec.n_dz,
                                                  spec.n_theta],
            "fine_thetas": cfg.n_theta_fine, "conv_kernels_s": kernels_s,
            "fit_ms": fit_ms, "tfl_launches_per_fit": launches,
            "max_abs_dx_m": float(dx.max()), "max_abs_dz_m": float(dz.max()),
            "max_yaw_err_deg_standing": float(dyaw[~moving].max()),
            "max_yaw_err_deg_moving": float(dyaw[moving].max()),
            "cudnn_conv_max_off_whole": max(
                float((r - r.round()).abs().max()) for r in raw),
            "conv_count_max": [float(w.max()) for w in want]}


@contextlib.contextmanager
def recording_tfl():
    """Every ``tfl_counts`` launch's inputs (copies, taken before the
    launch), for ``replay_tfl_launches``."""
    from monosowa_tpu_torch.ops import tfl

    launch = tfl._launch_counts
    recorded = []

    def recording_launch(scan, scan_mask, templates, radius):
        recorded.append((scan.clone(), scan_mask.clone(), templates.clone(),
                         radius))
        return launch(scan, scan_mask, templates, radius)

    tfl._launch_counts = recording_launch
    try:
        yield recorded
    finally:
        tfl._launch_counts = launch


def replay_tfl_launches(recorded, label: str) -> list:
    """Each recorded ``tfl_counts`` launch again, against the plain version
    on the same card tensors: the counts must be equal.  One entry a
    launch: its shape and its all-masked scan rows."""
    import torch

    from monosowa_tpu_torch.ops import tfl

    checked = []
    for scan, mask, posed, radius in recorded:
        shape = "B={} P={} T={} S={}".format(*posed.shape[:3], scan.shape[1])
        got = tfl._launch_counts(scan, mask, posed, radius)
        want = tfl.binary_both_way_counts_plain(scan, mask, posed, radius)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            raise AssertionError(f"{label}: tfl_counts at {shape} differs "
                                 f"from the plain version by {err}")
        checked.append({"shape": shape,
                        "all_masked_rows": int((~mask.any(1)).sum())})
    return checked


@contextlib.contextmanager
def timed_fits(module, record: bool = False):
    """Wrap ``module.fit_cars_conv`` (the name the pipeline or the bank
    calls): every call's cars, device time (CUDA events) and
    ``tfl_counts`` launches.  With ``record``, also a copy of the inputs of
    each of its ``tfl_counts`` launches (``recording_tfl``; the copies
    fall inside the fit's device time), for ``check_recorded_launches``."""
    import torch

    from monosowa_tpu_torch.ops import tfl

    fits = []
    inner = module.fit_cars_conv
    with (recording_tfl() if record else contextlib.nullcontext([])) \
            as recorded:

        def timed_fit(batch, *args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            before = tfl.launches
            recorded.clear()
            start.record()
            res = inner(batch, *args)
            end.record()
            fits.append({"cars": len(batch.points), "events": (start, end),
                         "tfl_launches": tfl.launches - before,
                         "tfl_inputs": list(recorded)})
            return res

        module.fit_cars_conv = timed_fit
        try:
            yield fits
        finally:
            module.fit_cars_conv = inner


def fit_report(fits) -> list:
    """The fits' device ms (after a synchronize); 3 launches each."""
    for f in fits:
        if f["tfl_launches"] != TFL_PER_FIT:
            raise AssertionError(f"a fit_cars_conv call launched tfl_counts "
                                 f"{f['tfl_launches']} times")
        start, end = f.pop("events")
        f["device_ms"] = start.elapsed_time(end)
    return fits


def check_recorded_launches(fits) -> None:
    """Each fit's recorded ``tfl_counts`` launches replayed
    (``replay_tfl_launches``: counts equal to the plain version's).
    Replaces each fit's ``tfl_inputs`` by the result."""
    for f in fits:
        inputs = f.pop("tfl_inputs")
        if len(inputs) != f["tfl_launches"]:
            raise AssertionError(f"{len(inputs)} tfl_counts launches "
                                 f"recorded, {f['tfl_launches']} counted")
        f["tfl_checked"] = replay_tfl_launches(inputs, "a fit on the path")


def check_label_files(jobs, frames, scene_cars, n_frames: int):
    """Each job's label file: only finite Car rows, every car within 2.5 m
    of a scene car, at least one car a frame on average.  Returns (cars
    per frame, largest distance to a scene car, the label sets)."""
    import numpy as np

    from monosowa_tpu_torch.kittiio import read_label_file

    cars_per_frame, worst, sets = [], 0.0, []
    for job in jobs:
        labels = read_label_file(job["out_path"])
        sets.append(labels)
        if labels.names != ["Car"] * len(labels):
            raise AssertionError(f"{job['out_path']}: {labels.names}")
        vals = np.concatenate([labels.box2d.ravel(), labels.hwl.ravel(),
                               labels.pos.ravel(), labels.ry])
        if not np.isfinite(vals).all():
            raise AssertionError(f"{job['out_path']}: non-finite label")
        cars_per_frame.append(len(labels))
        # the scene's cars in this reference frame's camera coordinates
        ego_z = frames[job["frame_index"]]["ego_z"]
        scene_xz = np.array([[c["x"], c["z"] - ego_z] for c in scene_cars])
        for pos in labels.pos:
            worst = max(worst, float(np.hypot(
                scene_xz[:, 0] - pos[0], scene_xz[:, 1] - pos[2]).min()))
    if len(jobs) != n_frames or sum(cars_per_frame) < n_frames:
        raise AssertionError(f"cars per frame {cars_per_frame}")
    if worst > 2.5:
        raise AssertionError(f"a written car lies {worst} m from every "
                             "scene car")
    return cars_per_frame, worst, sets


def run_group(labeler, jobs, fit_module, check_launches: bool = False
              ) -> dict:
    """One ``label_frames`` call with its fits timed, the K5 launch count
    zeroed just before and read just after, and the peak memory.  With
    ``check_launches``, every K5 launch of its fits is held against the
    plain version afterwards, on its own inputs."""
    import torch

    from monosowa_tpu_torch.ops import tfl

    with timed_fits(fit_module, record=check_launches) as fits:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tfl.launches = 0
        t0 = time.perf_counter()
        n_written = labeler.label_frames(jobs)          # the main path
        torch.cuda.synchronize()
        label_s = time.perf_counter() - t0
        launches = tfl.launches
    if n_written != len(jobs):
        raise AssertionError(f"{n_written} frames written, not {len(jobs)}")
    stages = dict(labeler.stage_seconds)
    peak = torch.cuda.max_memory_allocated() / 1e9
    fit_report(fits)
    if check_launches:
        check_recorded_launches(fits)
    else:
        for f in fits:
            del f["tfl_inputs"]
    return {"label_ms_per_frame": label_s * 1e3 / len(jobs),
            "stage_seconds": stages,
            "host_share": (stages["extract"] + stages["track_aggregate"])
            / label_s,
            "fits": fits, "tfl_launches": launches, "peak_mem_GB": peak}


def label_config(window: int):
    """The configuration of the JAX package's tools/bench_pipeline.py."""
    from monosowa_tpu_torch.sowa import fitting, pipeline

    return pipeline.PipelineConfig(
        nscans_before=window, nscans_after=window, max_cars=16,
        max_points=TFL_S, min_standing_points=400,
        fit=fitting.FitConfig(fine_chunk=60))


def label(dev, n_frames: int = LABEL_FRAMES, window: int = LABEL_WINDOW,
          hw=None, cfg=None) -> dict:
    """One group of reference frames of the synthetic sequence through
    ``PseudoLabeler.label_frames`` (host candidates: points, masks and
    frame ids, no depth maps).  The result's ``_labels`` (the label sets,
    for ``label_bank``) is not printed."""
    from monosowa_tpu_torch.sowa import pipeline, sample

    h, w = hw or (sample.H, sample.W)
    t0 = time.perf_counter()
    frames, scene_cars = sample.make_sequence(n_frames, window, h=h, w=w)
    scene_s = time.perf_counter() - t0
    labeler = pipeline.PseudoLabeler(cfg or label_config(window))
    if labeler.device.type != "cuda":            # on the card: none given
        raise AssertionError(f"the labeller is on {labeler.device}")

    with tempfile.TemporaryDirectory() as tmp:
        jobs = sample.make_jobs(frames, window, tmp, h=h, w=w)
        run = run_group(labeler, jobs, pipeline)
        if run["stage_seconds"]["bank_path"] != 0.0:
            raise AssertionError("jobs without depth took bank mode")
        cars_per_frame, worst, sets = check_label_files(
            jobs, frames, scene_cars, n_frames)
        mtimes = [os.path.getmtime(j["out_path"]) for j in jobs]
        again = labeler.label_frames(jobs)              # skip-if-exists
        if again != 0 or mtimes != [os.path.getmtime(j["out_path"])
                                    for j in jobs]:
            raise AssertionError(f"a second label_frames wrote {again} "
                                 "frames")
    # the window is the JAX bench's default; production aggregates +-30
    # frames (PipelineConfig's default): label_bank measures it
    return {"phase": "label", "frames": n_frames, "window": window,
            "production_window": pipeline.PipelineConfig().nscans_before,
            "image_hw": [h, w], "points_per_frame": len(frames[0]["points"]),
            "distinct_frames": n_frames + 2 * window,
            "scene_build_s": scene_s, "label_files": n_frames,
            "cars_per_frame": cars_per_frame,
            "max_dist_to_scene_car_m": worst, **run, "_labels": sets}


def clear_spot(cars, n_total: int, ref_frames, h: int, w: int,
               z_max: float, depths, width: float, top_y: float,
               bottom_y: float) -> dict:
    """A place (x, z in frame 0's coordinates) for an upright rectangle
    ``width`` wide from ``top_y`` to ``bottom_y`` (camera y, down) that
    every reference camera sees ``depths`` (lo, hi) ahead, and whose pixels
    no car's rectangle comes within 10 pixels of in any frame of the
    sequence (``sowa/sample.py``'s rendering rule)."""
    import numpy as np

    from monosowa_tpu_torch.sowa import sample

    fu, _ = sample.intrinsics(h, w)

    def rect(x, z, wide, top, bottom):
        u = fu * x / z + w / 2
        return (fu * top / z + h / 2, fu * bottom / z + h / 2,
                u - fu * wide / 2 / z, u + fu * wide / 2 / z)

    ego = [k * sample.EGO_STEP for k in range(n_total)]
    reach = 0.9 * depths[0] * (w / 2) / fu      # inside the image's sides
    for z in np.arange(ego[ref_frames[-1]] + depths[0],
                       ego[ref_frames[0]] + depths[1], 0.5):
        for x in sorted(np.arange(-reach, reach, 0.5), key=abs):
            ok = True
            for k, ez in enumerate(ego):
                d = z - ez
                if not 1.0 <= d <= z_max:
                    continue
                pt, pb, pl, pr = rect(x, d, width, top_y, bottom_y)
                if k in ref_frames and not (0 <= pl and pr < w):
                    ok = False
                    break
                for car in cars:
                    dc = car["z"] - ez
                    if not 4 <= dc <= z_max:
                        continue
                    ct, cb, cl, cr = rect(car["x"], dc, 4.0, car["y"] - 1.6,
                                          car["y"])
                    if cl - 10 < pr and pl < cr + 10 and ct - 10 < pb \
                            and pt < cb + 10:
                        ok = False
                        break
                if not ok:
                    break
            if ok:
                return {"x": float(x), "z": float(z)}
    raise AssertionError(f"no clear place {depths} m ahead in the scene")


def write_velodyne(frames, out_dir: str, h: int, w: int):
    """Each frame's camera-frame points, a 64-beam scanner's rows of them
    (every LIDAR_ROW_STEP-th pixel row), as a velodyne ``.bin`` (x, y, z,
    reflectance float32 in the velodyne frame).  Returns the paths."""
    import numpy as np

    inv = np.linalg.inv(np.asarray(T_CAM_VELO))
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for k, f in enumerate(frames):
        cam = f["points"].reshape(h, w, 3)[::LIDAR_ROW_STEP]
        cam = cam.reshape(-1, 3).astype(np.float64)
        velo = np.hstack([cam, np.ones((len(cam), 1))]) @ inv.T
        velo[:, 3] = 0.5                               # reflectance
        path = os.path.join(out_dir, f"{k:010d}.bin")
        velo.astype(np.float32).tofile(path)
        paths.append(path)
    return paths


def lidar_labels(jobs, frames, scene_cars, person, hidden) -> dict:
    """Each label file: Car rows within 2.5 m of a scene car and one
    Pedestrian row within 0.5 m of the person; the hidden car of its
    frame's file not among the cars; a car beyond 75 m somewhere."""
    import numpy as np

    from monosowa_tpu_torch.kittiio import read_label_file

    cars_per_frame, worst, far, ped_err = [], 0.0, [], 0.0
    for job in jobs:
        labels = read_label_file(job["out_path"])
        vals = np.concatenate([labels.hwl.ravel(), labels.pos.ravel(),
                               labels.ry])
        if not np.isfinite(vals).all() or \
                set(labels.names) - {"Car", "Pedestrian"}:
            raise AssertionError(f"{job['out_path']}: {labels.names}")
        ego_z = frames[job["frame_index"]]["ego_z"]
        scene = np.array([[c["x"], c["z"] - ego_z] for c in scene_cars])
        peds = [p for n, p in zip(labels.names, labels.pos)
                if n == "Pedestrian"]
        if len(peds) != 1:
            raise AssertionError(f"{job['out_path']}: {len(peds)} "
                                 "Pedestrian rows")
        ped_err = max(ped_err, float(np.hypot(
            peds[0][0] - person["x"], peds[0][2] - (person["z"] - ego_z))))
        cars = [p for n, p in zip(labels.names, labels.pos) if n == "Car"]
        cars_per_frame.append(len(cars))
        for pos in cars:
            dist = np.hypot(scene[:, 0] - pos[0], scene[:, 1] - pos[2])
            worst = max(worst, float(dist.min()))
            if np.hypot(pos[0], pos[2]) > 75.0:
                far.append(float(np.hypot(pos[0], pos[2])))
        if job["frame_index"] == hidden["frame"]:
            hx, hz = hidden["x"], hidden["z"] - ego_z
            near = [float(np.hypot(p[0] - hx, p[2] - hz)) for p in cars]
            if near and min(near) < 2.5:
                raise AssertionError(f"the car hidden from frame "
                                     f"{hidden['frame']}'s scan was kept")
    if worst > 2.5 or ped_err > 0.5 or not far or min(cars_per_frame) < 1:
        raise AssertionError(f"cars a frame {cars_per_frame}, {worst} m "
                             f"from a scene car, person {ped_err} m off, "
                             f"beyond 75 m: {far}")
    return {"cars_per_frame": cars_per_frame,
            "max_dist_to_scene_car_m": worst,
            "pedestrian_err_m": ped_err, "cars_beyond_75m": far}


def hidden_standing_plain(points, ref_scan, radius: float = 0.1,
                          chunk: int = 2048) -> bool:
    """The JAX package's strict hidden-standing rule, the plain version of
    ``aggregation.hidden_standing_keep_real``: the float32 expanded
    distances of every scan point, where the port measures only those
    near the car."""
    import numpy as np

    scan = np.asarray(ref_scan[:, :3], np.float32)
    r2 = radius * radius
    for c0 in range(0, points.shape[0], chunk):
        p = points[c0:c0 + chunk, :3]
        d2 = ((p ** 2).sum(1)[:, None] + (scan ** 2).sum(1)[None, :]
              - 2.0 * (p @ scan.T))
        if (d2 < r2).any():
            return True
    return False


def check_strict_calls(calls) -> dict:
    """The labeller's strict hidden-standing calls again: every one through
    the port's check (host ms, the answer the labeller got), and the
    farthest car's and the call of the median size also through the plain
    rule over the whole scan (ms, the same answer: the plain rule takes
    about 0.7 ms a car point on a 117k-point scan, a minute for the
    largest tracks)."""
    import numpy as np

    from monosowa_tpu_torch.sowa import aggregation

    if not calls:
        raise AssertionError("the labeller made no strict check")
    port_ms, dist = [], []
    for args, kwargs, kept in calls:
        t0 = time.perf_counter()
        again = aggregation.hidden_standing_keep_real(*args, **kwargs)
        port_ms.append((time.perf_counter() - t0) * 1e3)
        if again != kept or not kwargs.get("strict"):
            raise AssertionError("a strict check answered otherwise again")
        dist.append(float(np.linalg.norm(np.median(args[0][:, :3], 0))))
    far = int(np.argmax(dist))
    by_size = sorted(range(len(calls)), key=lambda i: len(calls[i][0][0]))
    pick = [far] + [i for i in by_size[len(by_size) // 2:] if i != far][:1]
    plain = []
    for i in pick:
        (points, scan), _, kept = calls[i]
        t0 = time.perf_counter()
        want = hidden_standing_plain(points, scan)
        plain_ms = (time.perf_counter() - t0) * 1e3
        if want != kept:
            raise AssertionError(f"the strict check of a car {dist[i]} m "
                                 f"away: {kept}, the plain rule: {want}")
        plain.append({"points": len(points), "scan_points": len(scan),
                      "median_m": dist[i], "kept": bool(kept),
                      "port_ms": port_ms[i], "plain_ms": plain_ms})
    if dist[far] <= 75.0:
        raise AssertionError(f"no strict check beyond 75 m: {dist[far]}")
    return {"strict_calls": len(calls),
            "strict_kept": int(sum(c[2] for c in calls)),
            "strict_port_ms_total": float(sum(port_ms)),
            "strict_port_ms_max": float(max(port_ms)),
            "strict_vs_plain": plain}


def label_lidar(dev, n_frames: int = LABEL_FRAMES,
                window: int = LABEL_WINDOW, hw=None, cfg=None,
                cpu_grid=None) -> dict:
    """The label phase's scene, cars rendered to 85 m with one more 76-84 m
    ahead, one standing person and one car hidden from the first
    reference frame, both where no car covers them, as velodyne scans
    read by ``load_velo_scan`` / ``velo_to_cam``; one group through
    ``PseudoLabeler.label_frames`` with ``use_pseudo_lidar=False``,
    ``strict_hidden_standing`` and ``extract_pedestrians`` (the person's
    mask a job); every K5 launch of its fits replayed against the plain
    version, the strict check's calls against the plain rule
    (``check_strict_calls``).  Then the hidden car's frame without the
    strict check (the car comes back), and with a cut grid on the card and
    on the CPU (the same label file)."""
    import numpy as np
    import torch

    from monosowa_tpu_torch.kittiio.velodyne import load_velo_scan, velo_to_cam
    from monosowa_tpu_torch.sowa import (aggregation, fitting, pipeline,
                                         sample)

    h, w = hw or (sample.H, sample.W)
    _, scene_cars = sample.make_sequence(n_frames, window, h=8, w=16,
                                         z_max=LIDAR_Z_MAX)
    ref_frames = list(range(window, window + n_frames))
    n_total = n_frames + 2 * window
    # a car 76-84 m ahead of every reference camera, clear of the others
    far = clear_spot(scene_cars, n_total, ref_frames, h, w, LIDAR_Z_MAX,
                     (76.0, 84.0), 4.0, -0.5, 1.1)
    far_car = {"x": far["x"], "y": 1.1, "z": far["z"], "theta": 0.3}
    scene_cars = scene_cars + [far_car]
    # the hidden car: the nearest scene car 8-40 m ahead of the first
    # reference camera
    ego0 = ref_frames[0] * sample.EGO_STEP
    ci = min((i for i, c in enumerate(scene_cars)
              if 8 <= c["z"] - ego0 <= 40), key=lambda i: scene_cars[i]["z"])
    hidden = {"frame": ref_frames[0], "x": scene_cars[ci]["x"],
              "z": scene_cars[ci]["z"], "car": ci}
    person = clear_spot(scene_cars, n_total, ref_frames, h, w, LIDAR_Z_MAX,
                        (12.0, 30.0), 0.6, -0.05, 1.65)
    t0 = time.perf_counter()
    frames, _ = sample.make_sequence(n_frames, window, h=h, w=w,
                                     z_max=LIDAR_Z_MAX,
                                     hidden={ref_frames[0]: [ci]},
                                     person=person, extra_cars=[far_car])
    scene_s = time.perf_counter() - t0
    cfg = dataclasses.replace(cfg or label_config(window),
                              use_pseudo_lidar=False,
                              strict_hidden_standing=True,
                              extract_pedestrians=True,
                              skip_non_visible=False)
    labeler = pipeline.PseudoLabeler(cfg)
    if labeler.device.type != "cuda":
        raise AssertionError(f"the labeller is on {labeler.device}")
    t_cam_velo = np.asarray(T_CAM_VELO)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = write_velodyne(frames, os.path.join(tmp, "velodyne"), h, w)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        scans = [velo_to_cam(load_velo_scan(p), t_cam_velo) for p in paths]
        read_s = time.perf_counter() - t0
        for f in frames:                    # the scans are all there is
            del f["points"]

        def jobs_in(out_dir, lo=0, hi=None):
            jobs = sample.make_jobs(frames, window, out_dir, tag="velo",
                                    lo=lo, hi=hi, h=h, w=w)
            for j in jobs:
                j["get_points"] = (lambda k, fi=j["frame_index"]:
                                   scans[fi - window + k])
            return jobs

        jobs = jobs_in(os.path.join(tmp, "labels"))
        if not all(len(j["ped_masks"]) == 1 and j["ped_masks"][0].any()
                   for j in jobs):
            raise AssertionError("a reference frame without the person")
        with recording_calls(aggregation,
                             "hidden_standing_keep_real") as strict_calls:
            run = run_group(labeler, jobs, pipeline, check_launches=True)
        strict = check_strict_calls(strict_calls)
        del strict_calls
        if run["stage_seconds"]["bank_path"] != 0.0:
            raise AssertionError("real LiDAR took bank mode")
        checked = lidar_labels(jobs, frames, scene_cars, person, hidden)
        # the hidden car's frame without the strict check: the car is kept
        # (the reference's filter keeps every standing car)
        loose = pipeline.PseudoLabeler(dataclasses.replace(
            cfg, strict_hidden_standing=False))
        job = jobs_in(os.path.join(tmp, "loose"), 0, 1)
        loose.label_frames(job)
        ego = frames[hidden["frame"]]["ego_z"]
        from monosowa_tpu_torch.kittiio import read_label_file
        pos = read_label_file(job[0]["out_path"]).pos
        back = float(np.hypot(pos[:, 0] - hidden["x"],
                              pos[:, 2] - (hidden["z"] - ego)).min())
        if back > 2.5:
            raise AssertionError(f"without the strict check the hidden car "
                                 f"is {back} m from every label")
        # the card against the CPU: the same labeller (a cut grid), the
        # same label file
        grid = cpu_grid or LIDAR_CPU_GRID
        small = dataclasses.replace(cfg, fit=fitting.FitConfig(
            fine_chunk=60, **grid))
        texts, cpu_s = [], 0.0
        for where in (None, "cpu"):
            job = jobs_in(os.path.join(tmp, f"small_{where}"), 0, 1)
            t0 = time.perf_counter()
            pipeline.PseudoLabeler(small, device=where).label_frames(job)
            cpu_s = time.perf_counter() - t0
            texts.append(open(job[0]["out_path"]).read())
        if texts[0] != texts[1] or "Pedestrian" not in texts[0]:
            raise AssertionError("the card's label file is not the CPU's:\n"
                                 + texts[0] + "\n" + texts[1])
    return {"phase": "label_lidar", "frames": n_frames, "window": window,
            "image_hw": [h, w], "scan_points": [len(s) for s in scans[:3]],
            "scene_build_s": scene_s, "velodyne_write_s": write_s,
            "velodyne_read_s": read_s, "person": person,
            "hidden_car": hidden, "hidden_car_without_strict_m": back,
            **checked, **strict, **run, "cpu_grid": grid,
            "cpu_label_file_equal": True, "cpu_label_s": cpu_s}


def stage_a_enqueues_only(labeler, jobs) -> None:
    """Stage A of a bank-mode group under torch's sync debug mode "error":
    any operation that waits for the card raises.  Then the group is
    finished normally."""
    import torch

    gen = labeler._label_frames_staged(jobs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        next(gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    next(gen)
    labeler.evict_extractions()


def label_bank(dev, host_labels, n_frames: int = LABEL_FRAMES,
               window: int = LABEL_WINDOW, hw=None, cfg_for=None,
               groups: int = LABEL_STREAM_GROUPS,
               production_window: int = PRODUCTION_WINDOW) -> dict:
    """Bank mode (``make_jobs(with_depth=True)``: device extraction, the
    point bank, one fit + NMS + re-fit a group):
    (a) the ``label`` phase's group through ``label_frames``, the bank path
        asserted, held against the scene and the host path's files;
    (b) ``label_frames_stream`` over ``groups`` groups against per-group
        ``label_frames``, byte for byte; stage A of a group enqueues only;
    (c) one group at the production window, timed;
    (d) ``DeviceExtractor.extract_frames`` against ``extract_frames_banked``
        on one chunk, both on float depth: the same surviving masks,
        centres within 2e-3 m."""
    import numpy as np
    import torch

    from monosowa_tpu_torch.sowa import bank, pipeline, sample
    from monosowa_tpu_torch.sowa.candidates_device import DeviceExtractor

    h, w = hw or (sample.H, sample.W)
    cfg_for = cfg_for or label_config
    out = {"phase": "label_bank", "frames": n_frames, "image_hw": [h, w]}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the label phase's frames
        frames, scene_cars = sample.make_sequence(n_frames, window, h=h,
                                                  w=w)
        labeler = pipeline.PseudoLabeler(cfg_for(window))
        if labeler.device.type != "cuda":
            raise AssertionError(f"the labeller is on {labeler.device}")
        jobs = sample.make_jobs(frames, window, tmp + "/a", h=h, w=w,
                                with_depth=True)
        # the peak memory includes the copies of K5's inputs held for the
        # check of every launch on its own scan (S = 2,040, the re-fit's
        # rows without a target all masked)
        run = run_group(labeler, jobs, bank, check_launches=True)
        if run["stage_seconds"]["bank_path"] != 1.0:
            raise AssertionError("jobs with depth maps did not take bank "
                                 "mode")
        bank_s = labeler.cfg.bank_slots * (labeler.cfg.max_points
                                           // labeler.cfg.bank_slots)
        scans = {c["shape"].split("S=")[1] for f in run["fits"]
                 for c in f["tfl_checked"]}
        if scans - {str(bank_s)}:
            raise AssertionError(f"K5 ran on scans of {scans} points, not "
                                 f"the bank's {bank_s}")
        cars_per_frame, worst, sets = check_label_files(
            jobs, frames, scene_cars, n_frames)
        # the host path's files (the label phase's) against the bank's: the
        # checks of tests/test_candidates_device.py:175-180 where their
        # premise holds.  The bank keeps a mask's first max_points member
        # pixels in raster order (the JAX package's _compact_bank_packed),
        # so a car whose mask is larger is fitted on its top rows (y, z
        # move) and the NMS may keep a car the host path suppresses
        # (ROADMAP Queue 3): every host car must be a bank car with the same
        # 2D box and a position within 2.0 m, and within 0.1 m in y where
        # its reference mask (a rectangle) fits in the bank
        cmp = {"host_cars": 0, "bank_cars": 0, "max_pos_diff_m": 0.0,
               "max_y_diff_m_uncapped": 0.0, "max_y_diff_m_capped": 0.0}
        cap = labeler.cfg.max_points
        for fi, (lb, lh) in enumerate(zip(sets, host_labels)):
            cmp["host_cars"] += len(lh.names)
            cmp["bank_cars"] += len(lb.names)
            for i, box in enumerate(lh.box2d):
                d = (np.abs(lb.box2d - box).max(1) if len(lb.names)
                     else np.array([np.inf]))
                j = int(np.argmin(d))
                if d[j] > 0.5:
                    raise AssertionError(f"frame {fi}: the host car at "
                                         f"{lh.pos[i]} is no bank car")
                dpos = np.abs(lb.pos[j] - lh.pos[i])
                area = (box[2] - box[0] + 1) * (box[3] - box[1] + 1)
                key = ("max_y_diff_m_uncapped" if area <= cap
                       else "max_y_diff_m_capped")
                cmp["max_pos_diff_m"] = max(cmp["max_pos_diff_m"],
                                            float(dpos.max()))
                cmp[key] = max(cmp[key], float(dpos[1]))
                if dpos.max() > 2.0 or (area <= cap and dpos[1] > 0.1):
                    raise AssertionError(f"frame {fi}: bank {lb.pos[j]} vs "
                                         f"host {lh.pos[i]}")
        out["a"] = {"window": window, "distinct_frames": n_frames + 2 * window,
                    "cars_per_frame": cars_per_frame, "vs_host_path": cmp,
                    "max_dist_to_scene_car_m": worst, **run}

        # (b) the stream against per-group calls
        n_b = groups * n_frames
        frames_b, _ = sample.make_sequence(n_b, window, h=h, w=w)
        jobs_x = sample.make_jobs(frames_b, window, tmp + "/x", h=h, w=w,
                                  with_depth=True)
        stage_a_enqueues_only(labeler, jobs_x[:n_frames])
        jobs_s = sample.make_jobs(frames_b, window, tmp + "/s", h=h, w=w,
                                  with_depth=True)
        jobs_g = sample.make_jobs(frames_b, window, tmp + "/g", h=h, w=w,
                                  with_depth=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_s = labeler.label_frames_stream(jobs_s, group_size=n_frames)
        torch.cuda.synchronize()
        stream_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        n_g = sum(labeler.label_frames(jobs_g[g0:g0 + n_frames])
                  for g0 in range(0, n_b, n_frames))
        torch.cuda.synchronize()
        groups_s = time.perf_counter() - t0
        if n_s != n_b or n_g != n_b:
            raise AssertionError(f"stream wrote {n_s}, groups {n_g}")
        for js, jg in zip(jobs_s, jobs_g):
            with open(js["out_path"]) as a, open(jg["out_path"]) as b:
                if a.read() != b.read():
                    raise AssertionError(f"{js['out_path']}: the stream's "
                                         "file differs from its group's")
        out["b"] = {"groups": groups, "stage_a_syncs": 0,
                    "stream_ms_per_frame": stream_s * 1e3 / n_b,
                    "per_group_ms_per_frame": groups_s * 1e3 / n_b}
        del frames_b, jobs_x, jobs_s, jobs_g

        # (c) the production window
        frames_c, scene_c = sample.make_sequence(n_frames, production_window,
                                                 h=h, w=w)
        labeler_c = pipeline.PseudoLabeler(cfg_for(production_window))
        jobs_c = sample.make_jobs(frames_c, production_window, tmp + "/c",
                                  h=h, w=w, with_depth=True)
        run_c = run_group(labeler_c, jobs_c, bank)
        if run_c["stage_seconds"]["bank_path"] != 1.0:
            raise AssertionError("the production window left bank mode")
        cars_c, worst_c, _ = check_label_files(jobs_c, frames_c, scene_c,
                                               n_frames)
        out["c"] = {"window": production_window,
                    "distinct_frames": n_frames + 2 * production_window,
                    "cars_per_frame": cars_c,
                    "max_dist_to_scene_car_m": worst_c, **run_c}
        del frames_c, jobs_c

    # (d) the two device routes on one chunk of float depth
    ext = DeviceExtractor(sample.intrinsics(h, w)[1].astype(np.float32),
                          (h, w), labeler.cfg.candidate,
                          max_masks=labeler.cfg.max_cars, depth_u16=False)
    chunk = frames[:ext.frame_bucket]
    depths = [f["depth"] for f in chunk]
    masks = [f["masks"] for f in chunk]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = ext.extract_frames(depths, masks)
    plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cands, bank_dev = ext.extract_frames_banked(depths, masks,
                                                cap=labeler.cfg.max_points)
    torch.cuda.synchronize()
    banked_s = time.perf_counter() - t0
    worst_c, worst_p, n_masks = 0.0, 0.0, 0
    for p, c in zip(plain, cands):
        if p is None or c is None:
            if (p is None) != (c is None):
                raise AssertionError("one route dropped a frame")
            continue
        if len(p["masks"]) != len(c["masks"]) or any(
                a is not b for a, b in zip(p["masks"], c["masks"])):
            raise AssertionError("the two routes kept other masks")
        n_masks += len(c["masks"])
        if len(c["masks"]):
            worst_c = max(worst_c, float(np.abs(
                p["locations"] - c["locations"]).max()))
        for ref, pts in zip(c["points"], p["points"]):
            got = bank_dev[ref.row, ref.mi, :ref.count].cpu().numpy()
            worst_p = max(worst_p, float(np.abs(got - pts[:ref.count]).max()))
    if worst_c > 2e-3 or n_masks == 0:
        raise AssertionError(f"centres differ by {worst_c} m ({n_masks} "
                             "masks)")
    if worst_p > 1e-5:
        raise AssertionError(f"bank points differ by {worst_p} m")
    out["d"] = {"chunk_frames": len(chunk), "masks_kept": n_masks,
                "max_centre_diff_m": worst_c,
                "max_bank_point_diff_m": worst_p,
                "extract_frames_s": plain_s,
                "extract_frames_banked_s": banked_s}
    out["tfl_launches"] = run["tfl_launches"]
    return out


K360_SEQ = "2013_05_28_drive_0000_sync"
K360_FRAMES = 4               # reference frames of the KITTI-360 phase
K360_RANGE = LABEL_WINDOW + 2  # its transformations: 2 past the window
K360_CHAMFER_CARS = 2
K360_VOTE_POINTS = 4096        # a car's points for the votes card vs CPU


def write_png(path: str, h: int, w: int) -> None:
    """A black 8-bit grey h x w PNG, written with zlib: the card's machine
    has no image library, and the driver reads only the size."""
    import struct
    import zlib

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    raw = b"".join(b"\0" + bytes(w) for _ in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0,
                                             0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def k360_tree(root: str, frames, n_frames: int, window: int, rng_t: int,
              hw) -> dict:
    """The synthetic sequence as a KITTI-360 tree under ``root``: frame
    ids ``<seq>_<number>`` for the reference frames (PNG, calib),
    ``data_poses/<seq>/cam0_to_world.txt`` from the scene's ego poses for
    frames 0 .. last + rng_t with frame ``len(frames)`` missing (a gap
    in the transformations' windows, past every aggregation window), and
    the caches the pipeline reads: ``masks_raw/`` and
    ``lidar_raw/<fid>/pcds/<offset>.npz`` of each reference frame's
    window, written uncompressed (``np.savez``).  Returns the reference
    frames' {fid: frame index} and the gap's frame number."""
    import numpy as np

    from monosowa_tpu_torch.sowa import sample

    h, w = hw
    _, p2 = sample.intrinsics(h, w)
    kitti = os.path.join(root, "kitti", "training")
    cache = os.path.join(root, "cache")
    for d in ("image_2", "calib"):
        os.makedirs(os.path.join(kitti, d))
    poses_dir = os.path.join(root, "k360", "data_poses", K360_SEQ)
    os.makedirs(poses_dir)
    gap = len(frames)
    last = window + n_frames - 1 + rng_t
    with open(os.path.join(poses_dir, "cam0_to_world.txt"), "w") as f:
        for i in range(last + 1):
            if i == gap:
                continue
            pose = np.eye(4)
            pose[2, 3] = i * sample.EGO_STEP
            f.write(f"{i} " + " ".join(f"{v:.12f}" for v in pose.ravel())
                    + "\n")
    p2_line = " ".join(repr(float(v)) for v in p2.ravel())
    refs = {}
    for fi in range(window, window + n_frames):
        fid = f"{K360_SEQ}_{fi:010d}"
        refs[fid] = fi
        write_png(os.path.join(kitti, "image_2", f"{fid}.png"), h, w)
        with open(os.path.join(kitti, "calib", f"{fid}.txt"), "w") as f:
            f.write("\n".join([f"P{i}: {p2_line}" for i in range(4)] + [
                "R0_rect: 1 0 0 0 1 0 0 0 1",
                "Tr_velo_to_cam: 1 0 0 0 0 1 0 0 0 0 1 0"]) + "\n")
        pcds = os.path.join(cache, "lidar_raw", fid, "pcds")
        os.makedirs(pcds)
        os.makedirs(os.path.join(cache, "masks_raw"), exist_ok=True)
        for k in range(-window, window + 1):
            frame = frames[fi + k]
            np.savez(os.path.join(pcds, f"{k:+d}.npz"),
                     points=frame["points"])
            ms = frame["masks"]
            arr = (np.stack(ms) if ms else np.zeros((0, h, w), bool))
            name = fid if k == 0 else f"{fid}{k:+d}"
            # sowa/masks.py save_masks' format, uncompressed
            np.savez(os.path.join(cache, "masks_raw", f"{name}.npz"),
                     packed=np.packbits(arr, axis=-1),
                     shape=np.array(arr.shape))
    return {"refs": refs, "gap": gap}


def k360_config(root: str, tag: str, window: int, rng_t: int, extra=None,
                min_points: int = 400) -> str:
    """The phase's config as JSON (YAML's subset; the card's machine has
    no PyYAML): label_config's labeller through the yaml's keys."""
    cfg = {"paths": {"kitti_path": os.path.join(root, "kitti"),
                     "merged_frames_path": os.path.join(root, "cache"),
                     "labels_path": os.path.join(root, "labels_" + tag),
                     "all_dataset_path": os.path.join(root, "k360")},
           "frames_creation": {"nscans_before": window,
                               "nscans_after": window,
                               "nscans_transformation_range": rng_t},
           "optimization": {"max_cars_per_frame": 16},
           "filtering": {"max_points_per_car": TFL_S,
                         "lidar_threshold_during_optim": min_points}}
    for k, v in (extra or {}).items():
        cfg[k].update(v)
    path = os.path.join(root, tag + ".json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _host(x):
    """A copy of ``x`` on the host: tensors on the CPU, numpy arrays
    copied, tuples element by element."""
    import numpy as np
    import torch

    if torch.is_tensor(x):
        return x.detach().cpu().clone()
    if isinstance(x, np.ndarray):
        return x.copy()
    if isinstance(x, tuple):
        return type(x)(*map(_host, x)) if hasattr(x, "_fields") \
            else tuple(map(_host, x))
    return x


@contextlib.contextmanager
def recording_calls(module, name: str):
    """Wrap ``module.<name>``: each call's arguments and result, copied to
    the host, for ``replay_on_cpu``."""
    inner = getattr(module, name)
    calls = []

    def recording(*args, **kwargs):
        res = inner(*args, **kwargs)
        calls.append((_host(args), _host(kwargs), _host(res)))
        return res

    setattr(module, name, recording)
    try:
        yield calls
    finally:
        setattr(module, name, inner)


def replay_on_cpu(fn, calls, atol: float, label: str) -> float:
    """Each recorded call of ``fn`` again on the CPU, on the host copies of
    its inputs: every number of the result within ``atol`` of the card's
    (NaN where the card has NaN).  Returns the largest difference."""
    import numpy as np
    import torch

    def flat(r):
        parts = r if isinstance(r, tuple) else (r,)
        return [np.asarray(v.numpy() if torch.is_tensor(v) else v,
                           np.float64).ravel() for v in parts]

    worst = 0.0
    for args, kwargs, got in calls:
        if "device" in kwargs:
            kwargs = dict(kwargs, device="cpu")
        for g, w in zip(flat(got), flat(fn(*args, **kwargs))):
            if not np.allclose(g, w, rtol=0, atol=atol, equal_nan=True):
                raise AssertionError(f"{label} on the card: {g}, on the "
                                     f"CPU: {w}")
            both = np.isfinite(g) & np.isfinite(w)
            if both.any():
                worst = max(worst, float(np.abs(g - w)[both].max()))
    return worst


def time_tfl_launch(scan, mask, posed, label: str) -> dict:
    """K5 at one recorded launch's inputs: both clocks, the plain
    version's time and the bound (``tfl_work``)."""
    from monosowa_tpu_torch.ops import tfl

    t = posed.shape[2]
    got = tfl._launch_counts(scan, mask, posed, TFL_RADIUS)
    want = tfl.binary_both_way_counts_plain(scan, mask, posed, TFL_RADIUS)
    return {
        "shape": f"{label}: B={posed.shape[0]} P={posed.shape[1]} T={t} "
                 f"S={scan.shape[1]}",
        "max_abs_err": max(float((g - w).abs().max())
                           for g, w in zip(tfl._fractions(*got, mask, t),
                                           tfl._fractions(*want, mask, t))),
        "ms": device_ms(lambda: tfl._launch_counts(scan, mask, posed,
                                                   TFL_RADIUS), 20),
        "ms_launched_from_python": cuda_ms(
            lambda: tfl.binary_both_way_counts(scan, mask, posed,
                                               TFL_RADIUS), 20),
        "plain_ms": cuda_ms(lambda: tfl.binary_both_way_counts_plain(
            scan, mask, posed, TFL_RADIUS), 2, warmup=1),
        **tfl_work(scan, mask, posed)}


def k360_labels(driver_labels: str, refs: dict, frames, scene_cars):
    """The label phase's bars on the label files of one action."""
    jobs = [{"out_path": os.path.join(driver_labels, f"{fid}.txt"),
             "frame_index": fi} for fid, fi in refs.items()]
    return check_label_files(jobs, frames, scene_cars, len(refs))


def label_k360(dev, n_frames: int = K360_FRAMES,
               window: int = LABEL_WINDOW, rng_t: int = K360_RANGE,
               hw=None, chamfer_cars: int = K360_CHAMFER_CARS,
               fit_cfg=None, min_points: int = 400) -> dict:
    """The CLI (``sowa/cli.py`` ``main``) on a KITTI-360 tree of the
    synthetic sequence, on the card: ``transformations`` (each window
    held against the scene's ego poses, zeros at the gap), ``candidates``,
    ``frames_aggregation``, ``optimization`` over the merged cars (the
    label phase's bars), ``demo`` (the scale detector and the box
    reducer: every K5 launch held against the plain version, counts
    equal; every car's box reducer and the scale detector of the car
    with the fewest points against the CPU's on the same inputs),
    ``optimization`` with ``robust_optimization`` (K5 at B cars x 3,200
    poses, held the same way); the ``chamfer`` loss kind through
    ``fit_cars_conv`` on merged cars at the full grid; the dimension
    estimator through ``label_from_cars`` on one frame's merged cars
    (its dimensions and yaw against the CPU's), and the outlier
    ensemble's four votes on the card against the CPU's; the seed-360
    frame order against its longhand draw and ``--dataset all``'s
    windows against kitti360's.  K5 at the new shapes: both clocks and
    the bound.  ``fit_cfg`` and ``min_points`` (rehearsals on the CPU at a
    small size) replace the full grid and the 400 points a standing car
    needs."""
    import numpy as np
    import torch

    from monosowa_tpu_torch.ops import tfl
    from monosowa_tpu_torch.sowa import aggregation, cache as cache_mod
    from monosowa_tpu_torch.sowa import (cli, dimensions, filtering, fitting,
                                         pipeline, sample, scale, transforms)

    h, w = hw or (sample.H, sample.W)
    out = {"phase": "label_k360", "frames": n_frames, "window": window,
           "transformation_range": rng_t, "image_hw": [h, w]}
    steps = out["step_seconds"] = {}
    clock = time.perf_counter
    grid = {}
    if fit_cfg is not None:
        grid = {"optimization": {
            "opt_param1_iters": fit_cfg.n_dx, "opt_param2_iters": fit_cfg.n_dz,
            "opt_param3_iters": fit_cfg.n_theta,
            "opt_fine_iters": fit_cfg.n_theta_fine}}
    with tempfile.TemporaryDirectory() as root:
        t0 = clock()
        frames, scene_cars = sample.make_sequence(n_frames, window, h=h, w=w)
        tree = k360_tree(root, frames, n_frames, window, rng_t, (h, w))
        refs = tree["refs"]
        steps["scene_and_tree"] = clock() - t0

        def main(tag, action, extra=None):
            sections = {k: dict(v) for k, v in grid.items()}
            for k, v in (extra or {}).items():
                sections.setdefault(k, {}).update(v)
            conf = k360_config(root, tag, window, rng_t, sections,
                               min_points)
            t0 = clock()
            rc = cli.main(["--config", conf, "--dataset", "kitti360",
                           "--action", action])
            torch.cuda.synchronize()
            steps[f"{action} ({tag})"] = clock() - t0
            if rc != 0:
                raise AssertionError(f"{action}: exit code {rc}")
            return os.path.join(root, "labels_" + tag)

        # 1. transformations: the scene's ego motion, zero at the gap
        main("opt", "transformations")
        tdir = os.path.join(root, "cache", "transformations")
        for fid, fi in refs.items():
            full = transforms.load_window_transforms(tdir, fid)
            for k in range(-rng_t, rng_t + 1):
                want = np.eye(4)
                want[2, 3] = (fi + k - fi) * sample.EGO_STEP
                if fi + k == tree["gap"] or fi + k < 0:
                    want = np.zeros((4, 4))
                if not np.allclose(full[k + rng_t], want, atol=1e-9):
                    raise AssertionError(f"transformations {fid} {k:+d}: "
                                         f"{full[k + rng_t]}")
        zero_windows = [int((~np.load(os.path.join(tdir, f"{fid}.npy"))
                             .any((1, 2))).sum()) for fid in refs]
        # 2. candidates, 3. frames_aggregation
        main("opt", "candidates")
        main("opt", "frames_aggregation")
        merged_cars = []
        for fid in refs:
            cand = cache_mod.load_candidates(
                os.path.join(root, "cache", "candidates"), fid)
            merged = cache_mod.load_merged_cars(
                os.path.join(root, "cache", "merged_cars"), fid)
            if not cand["points"] or not merged[0]:
                raise AssertionError(f"{fid}: {len(cand['points'])} "
                                     f"candidates, {len(merged[0])} cars")
            merged_cars.append(len(merged[0]))
        # 4. optimization over the merged cars
        tfl.launches = 0
        labels = main("opt", "optimization")
        out["optimization_tfl_launches"] = tfl.launches
        cars, worst, _ = k360_labels(labels, refs, frames, scene_cars)
        out.update(cars_per_frame=cars, max_dist_to_scene_car_m=worst,
                   zero_matrices_per_window=zero_windows,
                   merged_cars_per_frame=merged_cars)
        # 5. demo: the scale detector and the box reducer, each call
        # recorded for its replay on the CPU
        with recording_tfl() as rec_demo, \
                recording_calls(scale, "optimize_scale") as rec_scale, \
                recording_calls(scale, "bbox_reduce") as rec_reduce:
            tfl.launches = 0
            labels = main("demo", "demo")
            out["demo_tfl_launches"] = tfl.launches
        cars, worst, sets = k360_labels(labels, refs, frames, scene_cars)
        out.update(demo_cars_per_frame=cars, demo_max_dist_m=worst,
                   demo_lengths_m=[float(v) for s in sets
                                   for v in s.hwl[:, 2]])
        # the box reducer of every car, and the scale detector of the car
        # with the fewest points (its valid points only: the padding counts
        # for nothing), on the CPU within the labels' 1e-4
        t0 = clock()
        out["demo_reduce_max_diff_cpu"] = replay_on_cpu(
            scale.bbox_reduce, rec_reduce, 1e-4, "bbox_reduce")
        args, kwargs, res = min(rec_scale, key=lambda c: int(c[0][1].sum()))
        mask = args[1].bool()
        compact = (args[0][mask], mask[mask]) + args[2:]
        out["demo_scale_max_diff_cpu"] = replay_on_cpu(
            scale.optimize_scale, [(compact, kwargs, res)], 1e-4,
            "optimize_scale")
        steps["demo scale + reduce on the CPU"] = clock() - t0
        out.update(demo_scale_calls=len(rec_scale),
                   demo_reduce_calls=len(rec_reduce),
                   demo_scale_cpu_points=int(mask.sum()))
        del rec_scale, rec_reduce
        t0 = clock()
        out["demo_launches_by_shape"] = dict(collections.Counter(
            c["shape"] for c in replay_tfl_launches(rec_demo, "demo")))
        steps["demo launches vs plain"] = clock() - t0
        # 6. optimization with the robust fit over the same merged cars
        with recording_tfl() as rec_rob:
            tfl.launches = 0
            labels = main("robust", "optimization", extra={
                "optimization": {"robust_optimization": True}})
            out["robust_tfl_launches"] = tfl.launches
        cars, worst, _ = k360_labels(labels, refs, frames, scene_cars)
        out.update(robust_cars_per_frame=cars, robust_max_dist_m=worst)
        t0 = clock()
        out["robust_launches_by_shape"] = dict(collections.Counter(
            c["shape"] for c in replay_tfl_launches(rec_rob, "robust")))
        steps["robust launches vs plain"] = clock() - t0
        scale_p = 4 * 8 * 10 * 10
        rob_p = 2 * (fit_cfg or fitting.FitConfig()).n_dx \
            * (fit_cfg or fitting.FitConfig()).n_dz
        # the first launch of each scale pass, the robust grid's launch
        # with the fewest cars
        first = {}
        for rec, tag in ((rec_demo, "scale"), (rec_rob, "robust")):
            for scan, mask, posed, _ in rec:
                key = {(True, scale_p): "scale pass 1 (P=3,200)",
                       (True, 160): "scale pass 2 (P=160)",
                       (False, rob_p): "robust grid (B=cars, P=3,200)"}.get(
                    (tag == "scale", posed.shape[1]))
                if key and (key not in first or (
                        tag == "robust"
                        and posed.shape[0] < first[key][2].shape[0])):
                    first[key] = (scan, mask, posed)
        if len(first) != 3:
            raise AssertionError(f"new K5 shapes seen: {sorted(first)}")
        t0 = clock()
        out["tfl_new_shapes"] = {k: time_tfl_launch(*v, k)
                                 for k, v in first.items()}
        steps["K5 timing at the new shapes"] = clock() - t0
        del rec_demo, rec_rob, first
        # 7. chamfer through the fit, on merged cars, at the full grid
        fid0 = next(iter(refs))
        tracks, points, ref_masks = cache_mod.load_merged_cars(
            os.path.join(root, "cache", "merged_cars"), fid0)
        n_ch = min(chamfer_cars, len(tracks))
        batch = aggregation.build_car_batch(
            tracks[:n_ch], points[:n_ch], list(range(-window, window + 1)),
            n_ch, TFL_S)
        from monosowa_tpu_torch.sowa.templates import TemplateBank
        template = torch.as_tensor(TemplateBank.default().points[0],
                                   device=dev)
        ch_cfg = dataclasses.replace(fit_cfg or fitting.FitConfig(),
                                     loss_function="chamfer")
        spec, occ, memb = fitting.make_conv_kernels(
            template.cpu().numpy(), ch_cfg, dev)
        torch.cuda.synchronize()
        t0 = clock()
        res = fitting.fit_cars_conv(batch, template, occ, memb, spec, ch_cfg)
        torch.cuda.synchronize()
        ch_s = clock() - t0
        xz = torch.stack([res.x, res.z], 1).cpu().numpy()
        ego = frames[refs[fid0]]["ego_z"]
        scene_xz = np.array([[c["x"], c["z"] - ego] for c in scene_cars])
        ch_dist = [float(np.hypot(*(scene_xz - p).T).min()) for p in xz]
        if not (np.isfinite(xz).all() and max(ch_dist) < 2.5):
            raise AssertionError(f"chamfer fit: {xz}, {ch_dist}")
        out.update(chamfer_cars=n_ch, chamfer_s_per_car=ch_s / n_ch,
                   chamfer_grid=[ch_cfg.n_dx, ch_cfg.n_dz, ch_cfg.n_theta,
                                 ch_cfg.n_theta_fine],
                   chamfer_dist_to_scene_car_m=ch_dist)
        # 8. the other two stages on the card: the dimension estimator
        # through label_from_cars on the merged cars, and the outlier
        # ensemble's four votes on a car's points against the CPU's
        pcfg = dataclasses.replace(
            cli.pipeline_config_from(cli.load_config(
                os.path.join(root, "opt.json"))),
            use_dimensions_estimation=True)
        labeler = pipeline.PseudoLabeler(pcfg)
        t0 = clock()
        with recording_calls(dimensions, "estimate_car_dimensions") as rec:
            cars = labeler.label_from_cars(tracks, points, ref_masks,
                                           list(range(-window, window + 1)))
        torch.cuda.synchronize()
        steps["dimension estimator, one frame"] = clock() - t0
        # its dimensions and yaw against the CPU's on the same cars, at
        # tests/test_dimensions.py's 1e-5
        out["dims_max_diff_cpu"] = replay_on_cpu(
            dimensions.estimate_car_dimensions, rec, 1e-5,
            "estimate_car_dimensions")
        out["dims_yaw_rad"] = [c[2][1] for c in rec]
        far = [float(np.hypot(*(scene_xz - [c["x"], c["z"]]).T).min())
               for c in cars]
        if not cars or max(far) > 2.5:
            raise AssertionError(f"dimension estimator: cars {far} m from "
                                 "the scene's")
        cloud = torch.as_tensor(points[0][:K360_VOTE_POINTS])
        ones = torch.ones(len(cloud), dtype=torch.bool)
        t0 = clock()
        votes = filtering._four_votes(cloud.to(dev), ones.to(dev)).cpu()
        steps["four votes on the card"] = clock() - t0
        if not torch.equal(votes, filtering._four_votes(cloud, ones)):
            raise AssertionError("the outlier votes on the card differ from "
                                 "the CPU's")
        out.update(dims_cars=len(cars), dims_max_dist_m=max(far),
                   vote_points=len(cloud),
                   points_by_votes=[int((votes == k).sum())
                                    for k in range(5)])
        # the seed-360 draw, and --dataset all
        order = cli.shuffled_frame_order(25, 3, 17)
        np.random.seed(360)
        longhand = np.arange(25)
        np.random.shuffle(longhand)
        if not np.array_equal(order, longhand[3:17]):
            raise AssertionError(f"shuffled_frame_order: {order}")
        all_cache = os.path.join(root, "all_cache")
        conf = k360_config(root, "all", window, rng_t)
        with open(conf) as f:
            c = json.load(f)
        c["paths"]["merged_frames_path"] = all_cache
        with open(conf, "w") as f:
            json.dump(c, f)
        if cli.main(["--config", conf, "--dataset", "all", "--action",
                     "transformations"]) != 0:
            raise AssertionError("--dataset all: transformations")
        for fid in refs:
            if not np.array_equal(
                    np.load(os.path.join(all_cache, "transformations",
                                         f"{fid}.npy")),
                    np.load(os.path.join(tdir, f"{fid}.npy"))):
                raise AssertionError(f"--dataset all differs at {fid}")
    out["launches"] = (out["optimization_tfl_launches"]
                       + out["demo_tfl_launches"]
                       + out["robust_tfl_launches"])
    return out


def check_row_fetch(form: str, label: str, dev) -> dict:
    """One form of the row-fetch kernel against its plain version at one
    shape: a copy with an exact bf16 -> f32 conversion, so the difference
    must be 0.  Also timed: the one PyTorch call that computes the same
    function (``index_select``, a cast and a mask; used nowhere in the
    port)."""
    import torch

    from monosowa_tpu_torch.ops import row_fetch as rf
    from tools import bench_gather_micro_torch as bench

    n_rows = RF_ROWS[label]
    block, k_win = rf.window_params(form)
    idx_np, bank_np = bench.make_inputs(RF_BQ, RF_D, RF_T, n_rows)
    bank = torch.from_numpy(bank_np).to(dev).to(torch.bfloat16)
    idx = torch.from_numpy(idx_np).to(dev)

    def kernel():
        return rf.row_fetch(bank, idx, RF_BQ, form=form)

    def plain():
        return rf.row_fetch_plain(bank, idx, RF_BQ, block, k_win)

    keep = rf.in_window(idx, RF_T, RF_BQ, block, k_win)[:, None]
    safe = idx.clamp(0, RF_T - 1)

    def library():
        return torch.index_select(bank, 0, safe).float() * keep

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not (torch.isfinite(got).all() and err == 0.0
            and torch.equal(library(), want)):
        raise AssertionError(f"row_fetch {form} {label}: max abs err {err}")
    return {
        "shape": f"{label}, {form}: N={n_rows} T={RF_T} D={RF_D} bf16 "
                 f"bq={RF_BQ} block={block} k_win={k_win}",
        "form": form, "max_abs_err": err,
        "coverage": float(keep.float().mean()),
        # a few microseconds a call: timed inside a replayed CUDA graph, or
        # the host's launch rate would be what is measured
        "ms": device_ms(kernel, 50),
        "plain_ms": device_ms(plain, 5),
        "library_ms": device_ms(library, 20),
        "ms_launched_from_python": cuda_ms(kernel, 50),
        # idx and bank read once, out written once; nothing is computed
        "bound_ms": bench.bound_ms(n_rows, RF_T, RF_D, bank.element_size()),
        "bound_by": "bytes",
    }


def bench_row_fetch() -> dict:
    """The micro-benchmark through its own entry point, both forms at its
    default shape, each held against the tool's numpy oracle."""
    from monosowa_tpu_torch.ops import row_fetch as rf
    from tools import bench_gather_micro_torch as bench

    rf.launches = 0
    runs = [bench.run(form) for form in rf.FORMS]   # the main path
    launches = rf.launches
    for r in runs:
        if not (r["on_card"] and r["max_err"] == 0.0
                and r["coverage"] == 1.0):
            raise AssertionError(f"bench_gather_micro_torch: {r}")
    if launches < 2 * len(runs):
        raise AssertionError(f"the tool launched row_fetch {launches} times")
    return {"phase": "bench", "runs": runs, "row_fetch_launches": launches}


@contextlib.contextmanager
def recording_lap():
    """Wrap ``lap._launch_jv``: a copy of every JV launch's (cost,
    n_valid), for checking the kernel on the costs of a real step."""
    from monosowa_tpu_torch.ops import lap

    recorded = []
    launch = lap._launch_jv

    def recording_launch(cost, n_valid):
        recorded.append((cost.clone(), n_valid.clone()))
        return launch(cost, n_valid)

    lap._launch_jv = recording_launch
    try:
        yield recorded
    finally:
        lap._launch_jv = launch


def lap_problems(rng, dev):
    """LAP_PROBLEMS problems of 50 x 50 as the matcher makes them: costs
    of random scales, n_valid in 0..50 (0 and 50 included) with the
    columns past it at the matcher's padding cost, and ties (duplicated
    columns and rows, a constant problem, two equal groups)."""
    import numpy as np
    import torch

    n = LAP_PROBLEMS
    cost = (rng.normal(size=(n, LAP_Q, LAP_M))
            * 10 ** rng.uniform(-2, 2, (n, 1, 1))).astype(np.float32)
    m = rng.integers(0, LAP_M + 1, n)
    m[:4] = (0, LAP_M, 1, 12)
    cost[4, :, 7] = cost[4, :, 2]
    cost[4, 30] = cost[4, 3]
    cost[5] = 1.0
    cost[6] = np.round(cost[6], 0)
    cost[8] = cost[7]
    m[8] = m[7]
    for k in range(n):
        cost[k, :, m[k]:] = MATCH_BIG
    return (torch.from_numpy(cost).to(dev),
            torch.from_numpy(m.astype(np.int64)).to(dev))


def check_lap(label, cost, n_valid) -> dict:
    """Both LAP kernels on one batch of problems against their plain
    versions on the card (assignments equal) and scipy (JV's total cost at
    the optimum within rel 1e-6 / abs 1e-5; the auction's within 5% where
    no column is padding, else within its guarantee), with
    their times, the plain versions', the host route's (copy to the host,
    a scipy solve per problem, copy back) and the bound."""
    import numpy as np
    import torch

    from monosowa_tpu_torch.ops import lap

    n, q, mmax = cost.shape
    host = lap.solve_lap_host(cost, n_valid)
    costs, counts = cost.cpu().numpy().astype(np.float64), n_valid.cpu()
    # bytes: cost in, the counts (int32) in, the assignment (int64) out
    bound_ms = (cost.numel() * 4 + n * 4 + n * q * 8) / HBM_BYTES_PER_S * 1e3

    def total(assign):
        a = assign.cpu().numpy()
        return np.array([costs[k, a[k] >= 0, a[k][a[k] >= 0]].sum()
                         for k in range(n)])

    def host_clock_ms(fn, reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    opt = total(host)
    out = {}
    for name, kernel, plain, reps in (
            ("lap_jv", lap.lap_jv, lap.solve_lap_jv, 50),
            ("lap_auction", lap.lap_auction, lap.solve_lap_auction, 10)):
        got = kernel(cost, n_valid)
        want = plain(cost, n_valid)
        torch.cuda.synchronize()
        differ = int((got != want).sum())
        if differ:
            raise AssertionError(f"{name} {label}: {differ} assignments "
                                 "differ from the plain version's")
        if not ((got >= 0).sum(1).cpu() == counts.clamp(max=min(q, mmax))
                ).all():
            raise AssertionError(f"{name} {label}: a valid column is "
                                 "unassigned")
        val = total(got)
        if name == "lap_jv":
            ok = np.abs(val - opt) <= 1e-5 + 1e-6 * np.abs(opt)
        else:
            # within 5% where no column is padding (the JAX package's test
            # matrices); everywhere within Q times the last epsilon, the
            # auction's own guarantee: padding at MATCH_BIG makes that
            # epsilon 1e-4 of 1e6
            eps = lap.auction_eps(cost)[:, -1].double().cpu().numpy()
            ok = val <= opt + q * eps + 1e-5 * np.abs(opt)
            full = counts.numpy() == mmax
            ok &= ~full | (val <= opt + 0.05 * np.maximum(1.0, np.abs(opt)))
        if not ok.all():
            raise AssertionError(f"{name} {label}: total cost {val[~ok]} "
                                 f"against scipy's {opt[~ok]}")
        out[name] = {
            "label": label, "shape": f"N={n} Q={q} M={mmax}",
            "n_valid": counts.tolist(), "assignments_differing": differ,
            "max_abs_err": 0.0,
            "max_rel_cost_over_optimum": float(np.max(
                (val - opt) / np.maximum(np.abs(opt), 1e-12))),
            "max_rel_cost_over_optimum_unpadded": float(np.max(
                ((val - opt) / np.maximum(np.abs(opt), 1e-12))[
                    counts.numpy() == mmax], initial=0.0)),
            "ms": device_ms(lambda: kernel(cost, n_valid), reps),
            "ms_launched_from_python": cuda_ms(lambda: kernel(cost, n_valid),
                                               reps),
            "plain_ms": host_clock_ms(lambda: plain(cost, n_valid), 1),
            "host_route_ms": host_clock_ms(
                lambda: lap.solve_lap_host(cost, n_valid), 5),
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}
    return out


def check_match_syncs_nothing(dev) -> None:
    """hungarian_match with the device backends under torch's sync debug
    mode: the match never waits for the card."""
    import numpy as np
    import torch

    from monosowa_tpu_torch.models.matcher import (MatcherConfig,
                                                   hungarian_match)

    rng = np.random.default_rng(3)
    valid = np.arange(LAP_M)[None, :] < np.array([[5], [17]])
    args = [torch.from_numpy(a).to(dev) for a in (
        rng.normal(size=(BATCH, TRAIN_QUERIES, 3)).astype(np.float32),
        rng.uniform(0.1, 0.9, (BATCH, TRAIN_QUERIES, 6)).astype(np.float32),
        rng.integers(0, 3, (BATCH, LAP_M)),
        rng.uniform(0.1, 0.9, (BATCH, LAP_M, 6)).astype(np.float32), valid)]
    for backend in ("jv", "auction"):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            idx = hungarian_match(*args, MatcherConfig(backend=backend), 50)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if (idx >= 0).sum(1).tolist() != [5 * 11, 17 * 11]:
            raise AssertionError(f"hungarian_match {backend}: matches "
                                 f"{(idx >= 0).sum(1).tolist()}")


def lap_phase(dev, recorded) -> dict:
    """The LAP kernels on the generator's problems and on the three cost
    batches recorded from a train step; the device match's sync check."""
    import numpy as np

    if len(recorded) != LAP_PER_STEP:
        raise AssertionError(f"{len(recorded)} JV launches recorded in a "
                             "train step")
    runs = {"generator": check_lap("generator", *lap_problems(
        np.random.default_rng(8), dev))}
    for i, (cost, n_valid) in enumerate(recorded):
        layer = "final layer" if i == 0 else f"aux layer {i - 1}"
        runs[f"train step, {layer}"] = check_lap(f"train step, {layer}",
                                                 cost, n_valid)
    check_match_syncs_nothing(dev)
    return runs


def detector_config(root: str, h: int, w: int, model=None) -> dict:
    """The shipped detector's config (configs/monodetr_kitti.yaml) as a
    dict, with the batch, the epochs and the score threshold of this run."""
    return {
        "random_seed": 444,
        "dataset": {"type": "KITTI", "root_dir": root, "batch_size": BATCH,
                    "resolution": [w, h], "writelist": ["Car"],
                    "random_flip": 0.5, "aug_crop": False,
                    "depth_scale": "normal", "use_canonical_module": True,
                    "canonical_focal_length": 500.0},
        "model": model or {
            "num_classes": 3, "num_feature_levels": 4, "num_depth_bins": 80,
            "depth_min": 1e-3, "depth_max": 60.0, "enc_layers": 3,
            "dec_layers": 3, "hidden_dim": 256, "dim_feedforward": 256,
            "dropout": 0.1, "nheads": 8, "num_queries": 50,
            "enc_n_points": 4, "dec_n_points": 4,
            "compute_dtype": "float32"},
        "optimizer": {"type": "adamw", "lr": 2e-4, "weight_decay": 1e-4},
        "lr_scheduler": {"type": "step", "warmup": False, "decay_rate": 0.1,
                         "decay_list": [125, 165]},
        "trainer": {"max_epoch": 1, "save_frequency": 1,
                    "save_path": os.path.join(root, "outputs")},
        # 0, so that the random-init model's detections reach the files
        "tester": {"mode": "all", "threshold": 0.0, "topk": 50},
    }


def epoch(dev, n_train: int = EPOCH_TRAIN, n_val: int = EPOCH_VAL,
          hw=(IMG_H, IMG_W), model=None, msda_per_forward=MSDA_PER_FORWARD
          ) -> dict:
    """Train -> checkpoint -> test -> KITTI AP -> best checkpoint ->
    evaluate-only with resume, through ``tools/train_val_torch.py``
    ``run``."""
    import numpy as np

    from monosowa_tpu_torch.evalkitti import eval as kitti_eval
    from monosowa_tpu_torch.kittiio import read_label_file
    from monosowa_tpu_torch.ops import lap, msda
    from monosowa_tpu_torch.train import checkpoint as ckpt_io
    from monosowa_tpu_torch.train import tester
    from monosowa_tpu_torch.train.sample import (SampleDataset,
                                                 write_sample_labels)
    from tools import train_val_torch

    h, w = hw
    quiet = lambda s: None                                   # noqa: E731

    def no_python_route(*args, **kwargs):
        raise AssertionError("the AP evaluation left the native library for "
                             "its python route")

    python_route = (kitti_eval.compute_statistics,
                    kitti_eval._torch_bev_inter)
    kitti_eval.compute_statistics = no_python_route
    kitti_eval._torch_bev_inter = no_python_route
    try:
        with tempfile.TemporaryDirectory() as tmp:
            cfg = detector_config(tmp, h, w, model)
            train_ds = SampleDataset(n_train, cfg["dataset"])
            val_ds = SampleDataset(n_val, cfg["dataset"], first_id=n_train)
            label_dir = os.path.join(tmp, "training", "label_2")
            write_sample_labels(label_dir, val_ds)

            # the main path: one epoch, its checkpoint, its evaluation
            msda.launches = msda.bwd_launches = 0
            lap.jv_launches = lap.auction_launches = 0
            t0 = time.perf_counter()
            record = train_val_torch.run(cfg, train_ds, val_ds, dev,
                                         logger=quiet)
            run_s = time.perf_counter() - t0
            fwd_launches, bwd_launches = msda.launches, msda.bwd_launches
            jv_launches = lap.jv_launches

            steps = n_train // BATCH
            val_batches = -(-n_val // BATCH)
            ep, ev = record["epochs"][0], record["evaluated"][0]
            if record["device"] != str(dev) or len(record["epochs"]) != 1 \
                    or len(ep["loss_total"]) != steps \
                    or not np.isfinite(ep["loss_total"]).all() \
                    or not np.isfinite(list(ep["losses"].values())).all():
                raise AssertionError(f"epoch record: {record}")
            if bwd_launches != msda_per_forward * steps or \
                    fwd_launches != msda_per_forward * (steps + val_batches):
                raise AssertionError(
                    f"{steps} steps and {val_batches} test batches launched "
                    f"msda_fwd {fwd_launches} and msda_bwd {bwd_launches} "
                    "times")
            # one match a decoder layer and step
            if jv_launches != int(cfg["model"]["dec_layers"]) * steps \
                    or lap.auction_launches:
                raise AssertionError(f"{steps} steps launched lap_jv "
                                     f"{jv_launches} times")
            save_path = cfg["trainer"]["save_path"]
            ckpt = ckpt_io.latest_checkpoint(save_path)
            best = ckpt_io.latest_checkpoint(save_path, tag="best")
            if not (ckpt and ckpt.endswith("checkpoint_epoch_1") and best
                    and os.path.exists(ckpt + ".meta")
                    and os.path.exists(best + ".meta")):
                raise AssertionError(f"checkpoints: {os.listdir(save_path)}")
            saved = sorted(n for n in os.listdir(save_path) if n != "outputs")
            data_dir = os.path.join(save_path, "outputs", "data")

            def result_files():
                out = {}
                for name in sorted(os.listdir(data_dir)):
                    with open(os.path.join(data_dir, name), "rb") as f:
                        out[name] = f.read()
                return out

            files = result_files()
            rows = [len(read_label_file(os.path.join(data_dir, n)))
                    for n in files]
            if sorted(files) != [f"{i}.txt" for i in val_ds.idx_list] \
                    or min(rows) < 1:
                raise AssertionError(f"result files {sorted(files)}, rows "
                                     f"{rows}")
            res = ev["results"]
            aps = [a for k in AP_KEYS for a in res[k]["ap40"] + res[k]["ap11"]]
            if sorted(res) != sorted(AP_KEYS) or not all(
                    np.isfinite(a) and 0.0 <= a <= 100.0 for a in aps):
                raise AssertionError(f"AP dict: {res}")

            # evaluate-only, resumed from the checkpoint: the same files
            for name in files:
                os.remove(os.path.join(data_dir, name))
            t0 = time.perf_counter()
            again = train_val_torch.run(cfg, train_ds, val_ds, dev,
                                        evaluate_only=True, ckpt=ckpt,
                                        logger=quiet)
            eval_only_s = time.perf_counter() - t0
            if again["start_epoch"] != 1 or again["epochs"] \
                    or result_files() != files:
                raise AssertionError("evaluate-only from the checkpoint did "
                                     "not reproduce the result files")

            # the AP stack on its own ground truth: 100 (KITTI's AP needs
            # 41 valid boxes for that, hence a larger set of near cars)
            perfect_ds = SampleDataset(PERFECT_IMAGES, cfg["dataset"],
                                       first_id=100, max_depth=20.0)
            perfect_cfg = {"dataset": {"root_dir": os.path.join(tmp, "p")}}
            gt_dir = os.path.join(tmp, "p", "training", "label_2")
            write_sample_labels(gt_dir, perfect_ds)
            perfect = tester.evaluate_results(perfect_ds, gt_dir, perfect_cfg,
                                              quiet)
            if perfect["car_3d_strict"]["ap40"] != [100.0] * 3:
                raise AssertionError(f"ground truth as detections: {perfect}")
    finally:
        kitti_eval.compute_statistics, kitti_eval._torch_bev_inter = \
            python_route
    return {"phase": "epoch", "train_images": n_train, "val_images": n_val,
            "batch": BATCH, "image_hw": [h, w], "steps": steps,
            "run_s": run_s, "epoch_s": ep["train_s"],
            "steps_per_s": steps / ep["train_s"],
            "step_s": ep["step_s"], "loader_wait_s": ep["loader_wait_s"],
            "loss_total": ep["loss_total"],
            "checkpoint_ms": ep["checkpoint_s"] * 1e3,
            "checkpoint_files": saved,
            "test_ms_per_image": ev["inference"] * 1e3 / n_val,
            "ap_eval_ms": ev["ap"] * 1e3,
            "result_files": len(files), "result_rows": rows,
            "car_3d_strict_ap40": res["car_3d_strict"]["ap40"],
            "best_ap": record["best_ap"], "ap_route": "native",
            "evaluate_only_s": eval_only_s,
            "evaluate_only_files_identical": True,
            "ap_of_ground_truth": perfect["car_3d_strict"]["ap40"],
            "msda_fwd_launches": fwd_launches,
            "msda_bwd_launches": bwd_launches,
            "lap_jv_launches": jv_launches}


def sample_batch(rng, img_id0: int):
    """One request: BATCH normalised images with the KITTI-like P2 of the
    JAX package's `__graft_entry__._sample_batch` (f = 700, principal
    point at the centre)."""
    import numpy as np

    b, h, w = BATCH, IMG_H, IMG_W
    calib = np.tile(np.array([[700.0, 0, w / 2, 0], [0, 700.0, h / 2, 0],
                              [0, 0, 1, 0]], np.float32), (b, 1, 1))
    return {
        "image": rng.normal(size=(b, h, w, 3)).astype(np.float32),
        "calib": calib,
        "img_size": np.tile(np.array([w, h], np.float32), (b, 1)),
        "img_id": np.arange(img_id0, img_id0 + b, dtype=np.int64),
        "canonical_scale": np.ones(b, np.float32),
        "height_crop": np.ones(b, np.float32),
    }


def shipped_model_config() -> dict:
    """The ``model`` section of configs/monodetr_kitti.yaml, read line by
    line (the card's machine has no PyYAML); its values are scalars."""
    def scalar(text):
        for cast in (int, float):
            try:
                return cast(text)
            except ValueError:
                pass
        return {"True": True, "False": False}.get(text, text.strip("'\""))

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "configs", "monodetr_kitti.yaml")
    out, inside = {}, False
    with open(path) as f:
        for line in f:
            text = line.split("#", 1)[0].rstrip()
            if not text.strip():
                continue
            if not text.startswith(" "):
                inside = text == "model:"
            elif inside:
                key, _, val = text.strip().partition(":")
                out[key] = scalar(val.strip())
    return out


@contextlib.contextmanager
def policy_dtypes(model):
    """Records the dtypes of the first encoder layer's ``value_proj``
    output and of the backbone's C5 while the block runs."""
    seen = {"value_proj": set(), "backbone_c5": set()}
    hooks = [
        model.encoder.layer0.self_attn.value_proj.register_forward_hook(
            lambda m, a, out: seen["value_proj"].add(str(out.dtype))),
        model.backbone.register_forward_hook(
            lambda m, a, out: seen["backbone_c5"].add(str(out[2].dtype)))]
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()


def check_policy(seen, want: str, where: str) -> None:
    if seen != {"value_proj": {want}, "backbone_c5": {want}}:
        raise AssertionError(f"{where}: activations {seen}, want {want}")


def bf16_head_errors(out_p, out_k) -> dict:
    """The JAX package's whole-model bf16 statistics
    (tests/test_mixed_precision.py:46-51) of out_k against out_p:
    |a - b| / (|a| + 1), its max, for depth also its 0.9 quantile; raises
    outside that test's bars (max 0.15; depth: 0.9 quantile 0.1, max
    0.6)."""
    import torch

    errs = {}
    for k in ("pred_logits", "pred_boxes", "pred_depth"):
        a, b = out_p[k].float(), out_k[k].float()
        if out_k[k].dtype != torch.float32 or not torch.isfinite(b).all():
            raise AssertionError(f"{k}: {out_k[k].dtype}, finite "
                                 f"{bool(torch.isfinite(b).all())}")
        err = ((a - b).abs() / (a.abs() + 1.0)).flatten()
        errs[k] = {"max": float(err.max())}
        if k == "pred_depth":
            errs[k]["q90"] = float(torch.quantile(err, 0.9))
    ok = (errs["pred_logits"]["max"] < 0.15
          and errs["pred_boxes"]["max"] < 0.15
          and errs["pred_depth"]["q90"] < 0.1
          and errs["pred_depth"]["max"] < 0.6)
    if not ok:
        raise AssertionError(f"outside the bf16 bars: {errs}")
    return errs


def serve(dev, bf16: bool = False) -> dict:
    """Three requests through ``run_inference``.  Float32: ``MonoDETR`` at
    ``compute_dtype="float32"``.  ``bf16``: the shipped config
    (configs/monodetr_kitti.yaml, ``compute_dtype`` left at "auto", bf16
    on the card) through ``build_monodetr``."""
    import numpy as np
    import torch

    from monosowa_tpu_torch.kittiio import read_label_file
    from monosowa_tpu_torch.models.layers import resolve_dtype
    from monosowa_tpu_torch.models.monodetr import MonoDETR, build_monodetr
    from monosowa_tpu_torch.models.transformer import MSDeformAttnModule
    from monosowa_tpu_torch.ops import msda
    from monosowa_tpu_torch.train.tester import run_inference
    from monosowa_tpu_torch.train.trainer import MODEL_INPUTS, make_eval_step

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if bf16:
        model = build_monodetr(shipped_model_config(), device=dev, seed=0)
        if model.compute_dtype != "auto" or \
                resolve_dtype(model.compute_dtype, dev) != torch.bfloat16:
            raise AssertionError(f"the shipped config resolves to "
                                 f"{model.compute_dtype}")
    else:
        model = MonoDETR(device=dev, seed=0, compute_dtype="float32")
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    batches = [sample_batch(rng, 2 * i) for i in range(REQUESTS)]
    eval_step = make_eval_step(model, topk=50)
    eval_step(batches[0])                           # warm-up
    torch.cuda.synchronize()

    # the main path: three requests through run_inference
    with tempfile.TemporaryDirectory() as tmp, \
            policy_dtypes(model) as seen:
        cfg = {"tester": {"threshold": 0.0, "topk": 50},
               "trainer": {"save_path": tmp}, "dataset": {}}
        msda.launches = msda.launches_bf16 = 0
        t0 = time.perf_counter()
        out_dir = run_inference(model, batches, cfg, logger=lambda s: None)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = {"msda_fwd": msda.launches,
                    "msda_fwd_bf16": msda.launches_bf16}
        files = sorted(os.listdir(out_dir))
        n_rows = 0
        for f in files:
            labels = read_label_file(os.path.join(out_dir, f))
            vals = np.concatenate([labels.box2d.ravel(), labels.hwl.ravel(),
                                   labels.pos.ravel(), labels.ry,
                                   labels.score])
            if len(labels) != 50 or not np.isfinite(vals).all():
                raise AssertionError(f"{f}: {len(labels)} rows, finite "
                                     f"{np.isfinite(vals).all()}")
            n_rows += len(labels)
    check_policy(seen, "torch.bfloat16" if bf16 else "torch.float32",
                 "serve_bf16" if bf16 else "serve")
    if len(files) != REQUESTS * BATCH:
        raise AssertionError(f"{len(files)} result files")
    form, other = ("msda_fwd_bf16", "msda_fwd") if bf16 else \
        ("msda_fwd", "msda_fwd_bf16")
    if launches[form] != MSDA_PER_FORWARD * REQUESTS or launches[other]:
        raise AssertionError(f"{REQUESTS} forwards launched {launches}")

    # forward + top-k alone, per image
    def forward_all():
        for bt in batches:
            dets = eval_step(bt)
        return dets

    dets = forward_all()
    torch.cuda.synchronize()
    if not torch.isfinite(dets).all():
        raise AssertionError("non-finite detections")
    t0 = time.perf_counter()
    forward_all()
    torch.cuda.synchronize()
    fwd_ms_per_image = (time.perf_counter() - t0) * 1e3 / (REQUESTS * BATCH)
    peak = torch.cuda.max_memory_allocated()

    # the same forward with the plain MSDA, called by name
    args = [torch.as_tensor(batches[0][k], device=dev) for k in MODEL_INPUTS]
    with torch.no_grad():
        out_k = model(*args)
        attn = [mod for mod in model.modules()
                if isinstance(mod, MSDeformAttnModule)]
        for mod in attn:
            mod.msda = msda.ms_deform_attn_plain
        out_p = model(*args)
        for mod in attn:
            mod.msda = msda.ms_deform_attn
    if bf16:
        # every bf16 cast after an MSDA rounds the two float32 sums apart
        # by a bf16 step where they straddle one: the JAX package's bf16
        # bars for whole models
        rel = bf16_head_errors(out_p, out_k)
    else:
        rel = {}
        for k in ("pred_boxes", "pred_logits", "pred_depth"):
            rel[k] = float((out_k[k] - out_p[k]).abs().max()
                           / out_p[k].abs().max())
        if max(rel.values()) > 1e-3:
            raise AssertionError(f"kernel forward vs plain forward: {rel}")
    return {"phase": "serve_bf16" if bf16 else "serve",
            "compute_dtype": model.compute_dtype, "activations": {
                k: sorted(v) for k, v in seen.items()},
            "model_build_s": build_s,
            "requests": REQUESTS, "images_per_request": BATCH,
            "image_hw": [IMG_H, IMG_W], "result_files": len(files),
            "rows": n_rows, "msda_launches": launches[form],
            "serve_ms_per_image": serve_s * 1e3 / (REQUESTS * BATCH),
            "forward_ms_per_image": fwd_ms_per_image,
            "kernel_vs_plain_forward_max_rel" if not bf16 else
            "kernel_vs_plain_forward_bf16_errors": rel,
            "peak_mem_GB": peak / 1e9}


def kernel_fwd_plain_bwd(value, shapes, loc, aw):
    """MSDA with the forward kernel and the plain backward, so that a
    whole-model comparison with the kernels' step isolates the backward
    kernel (dvalue in value's dtype, its float32 sum rounded once)."""
    import torch

    from monosowa_tpu_torch.ops import msda

    class KernelFwdPlainBwd(torch.autograd.Function):
        @staticmethod
        def forward(ctx, value, loc, aw, shapes):
            ctx.shapes = shapes
            ctx.save_for_backward(value, loc, aw)
            return msda._launch_fwd(value, shapes, loc, aw)

        @staticmethod
        def backward(ctx, dout):
            value, loc, aw = ctx.saved_tensors
            dout = dout.contiguous()
            dloc, daw = msda.msda_grad_loc_aw_plain(value, ctx.shapes, loc,
                                                    aw, dout)
            return (msda.msda_grad_value_plain(value.shape, ctx.shapes, loc,
                                               aw, dout, value.dtype), dloc,
                    daw, None)

    return KernelFwdPlainBwd.apply(value.contiguous(), loc.contiguous(),
                                   aw.contiguous(), tuple(shapes))


def msda_step_grads(model, loss_of, msda_fn):
    """Loss dict (floats), gradients (copies) and peak device memory of one
    forward and backward of ``loss_of()`` with every MSDA module of the
    model calling ``msda_fn``."""
    import torch

    from monosowa_tpu_torch.models.transformer import MSDeformAttnModule

    for mod in model.modules():
        if isinstance(mod, MSDeformAttnModule):
            mod.msda = msda_fn
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = loss_of()
    losses["loss_total"].backward()
    torch.cuda.synchronize()
    return ({k: float(v.detach()) for k, v in losses.items()},
            {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None},
            torch.cuda.max_memory_allocated())


def grad_rel(got: dict, want: dict):
    """(name, value) of the largest gradient difference, each tensor's max
    abs over its scale, the scale floored at 1e-4 of the largest gradient:
    the key projections' biases have an exact gradient of 0."""
    if set(got) != set(want):
        raise AssertionError(f"gradients of {sorted(set(got) ^ set(want))} "
                             "in one run only")
    floor = 1e-4 * max(float(g.abs().max()) for g in want.values())
    rel = {n: float((got[n] - g).abs().max())
           / max(float(g.abs().max()), floor) for n, g in want.items()}
    worst = max(rel, key=rel.get)
    return worst, rel[worst]


def train(dev) -> dict:
    import numpy as np
    import torch

    from monosowa_tpu_torch.models.criterion import CriterionConfig, criterion
    from monosowa_tpu_torch.models.layers import Dropout
    from monosowa_tpu_torch.models.matcher import MatcherConfig
    from monosowa_tpu_torch.models.monodetr import MonoDETR
    from monosowa_tpu_torch.models.transformer import MSDeformAttnModule
    from monosowa_tpu_torch.ops import lap, msda
    from monosowa_tpu_torch.train.optim import make_optimizer
    from monosowa_tpu_torch.train.sample import sample_batch as train_batch
    from monosowa_tpu_torch.train.trainer import (MODEL_INPUTS,
                                                  make_train_step,
                                                  targets_from_batch)

    model = MonoDETR(device=dev, seed=0, compute_dtype="float32")
    batch = train_batch(BATCH, IMG_H, IMG_W)

    # one forward + backward each from the seeded weights, in training mode
    # with dropout off: with the kernels, through the plain MSDA (autograd
    # through its gathers), and with the forward kernel and the plain
    # backward.  Before any update, so that every run compares at the same
    # weights: the backward's atomics round dvalue differently in every
    # run, and after a few updates the weights, and with them which
    # sampling points lie within rounding of a pixel edge, differ from run
    # to run
    model.train()
    dropouts = [mod for mod in model.modules() if isinstance(mod, Dropout)]
    dropout_p = [mod.p for mod in dropouts]
    for mod in dropouts:
        mod.p = 0.0
    attn = [mod for mod in model.modules()
            if isinstance(mod, MSDeformAttnModule)]
    inputs = [torch.as_tensor(batch[k], dtype=torch.float32, device=dev)
              for k in MODEL_INPUTS]
    targets = targets_from_batch(batch, dev)
    ccfg = CriterionConfig(group_num=model.group_num,
                           num_queries=model.num_queries,
                           num_classes=model.num_classes)

    def grads_with(fn):
        return msda_step_grads(
            model, lambda: criterion(model(*inputs), targets, ccfg), fn)

    losses_k, grads_k, peak_k = grads_with(msda.ms_deform_attn)
    losses_p, grads_p, peak_p = grads_with(msda.ms_deform_attn_plain)
    losses_kp, grads_kp, _ = grads_with(kernel_fwd_plain_bwd)
    for mod in attn:
        mod.msda = msda.ms_deform_attn
    for mod, p_drop in zip(dropouts, dropout_p):
        mod.p = p_drop
    model.zero_grad(set_to_none=True)
    loss_rel = {k: abs(losses_k[k] - v) / max(abs(v), 1e-12)
                for k, v in losses_p.items()}
    if max(loss_rel.values()) > 1e-5:
        raise AssertionError(f"kernel vs plain loss dict: {loss_rel}")
    if losses_kp != losses_k:
        raise AssertionError("the forward kernel is not deterministic: "
                             f"{losses_k} != {losses_kp}")
    # the backward kernel vs the plain backward, the same forward: 1e-3
    # (grad_rel's floor: 1e-4 of the largest gradient of the reference)
    worst_b, rel_b = grad_rel(grads_k, grads_kp)
    if rel_b > 1e-3:
        raise AssertionError(f"backward kernel vs plain backward, gradient "
                             f"of {worst_b}: {rel_b} of its scale")
    # both kernels vs the plain MSDA: the forwards differ in the last bits,
    # so from the second MSDA layer of each stack on, a sampling point
    # within rounding of a pixel edge can fall into the neighbouring cell,
    # where the bilinear weights' derivative (dLoc) jumps; 1e-2
    worst_a, rel_a = grad_rel(grads_k, grads_p)
    if rel_a > 1e-2:
        raise AssertionError(f"kernels vs plain MSDA, gradient of "
                             f"{worst_a}: {rel_a} of its scale")
    del grads_k, grads_p, grads_kp
    torch.cuda.empty_cache()

    step = make_train_step(model, None, make_optimizer(model, 2e-4, 1e-4))
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    step(batch, gen)                                 # warm-up
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    # the main path: TRAIN_STEPS steps of make_train_step (the JV matcher
    # on the card, as the JAX trainer's)
    torch.cuda.reset_peak_memory_stats()
    msda.launches = msda.bwd_launches = 0
    msda.launches_bf16 = msda.bwd_launches_bf16 = 0
    lap.jv_launches = lap.auction_launches = 0
    history, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        history.append(step(batch, gen))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    fwd_launches, bwd_launches = msda.launches, msda.bwd_launches
    jv_launches, auction_launches = lap.jv_launches, lap.auction_launches
    step_peak = torch.cuda.max_memory_allocated()
    if msda.launches_bf16 or msda.bwd_launches_bf16:
        raise AssertionError("the float32 train step launched a bf16 form")
    if (jv_launches, auction_launches) != (LAP_PER_STEP * TRAIN_STEPS, 0):
        raise AssertionError(f"{TRAIN_STEPS} train steps launched lap_jv "
                             f"{jv_launches} and lap_auction "
                             f"{auction_launches} times")

    # the same steps with the host matcher (scipy, PR 7's route), and one
    # with the auction matcher on the card
    def steps_with(backend, n):
        ccfg_b = CriterionConfig(group_num=model.group_num,
                                 num_queries=model.num_queries,
                                 num_classes=model.num_classes,
                                 matcher=MatcherConfig(backend=backend))
        step_b = make_train_step(model, ccfg_b,
                                 make_optimizer(model, 2e-4, 1e-4))
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            losses_b = step_b(batch, gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if not np.isfinite(losses_b["loss_total"]):
                raise AssertionError(f"{backend} matcher: {losses_b}")
        return times

    host_ms = steps_with("host", TRAIN_STEPS)
    lap.auction_launches = 0
    auction_ms = steps_with("auction", 1)
    auction_path = lap.auction_launches
    if auction_path != LAP_PER_STEP:
        raise AssertionError(f"a step with the auction matcher launched "
                             f"lap_auction {auction_path} times")
    for losses in history:
        if not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"non-finite losses: {losses}")
        if not losses["grad_norm"] > 0:
            raise AssertionError(f"grad_norm {losses['grad_norm']}")
    if fwd_launches != bwd_launches or \
            fwd_launches != MSDA_PER_FORWARD * TRAIN_STEPS:
        raise AssertionError(f"{TRAIN_STEPS} train steps launched msda_fwd "
                             f"{fwd_launches} and msda_bwd {bwd_launches} "
                             "times")

    return {"phase": "train", "batch": BATCH, "image_hw": [IMG_H, IMG_W],
            "queries": TRAIN_QUERIES, "steps": TRAIN_STEPS,
            "warmup_step_s": warmup_s, "train_step_ms": step_ms,
            "train_step_ms_mean": sum(step_ms) / len(step_ms),
            "loss_total": [h["loss_total"] for h in history],
            "grad_norm": [h["grad_norm"] for h in history],
            "msda_fwd_launches": fwd_launches,
            "msda_bwd_launches": bwd_launches,
            "lap_jv_launches": jv_launches,
            "train_step_ms_host_matcher": host_ms,
            "train_step_ms_host_matcher_mean": sum(host_ms) / len(host_ms),
            "train_step_ms_auction_matcher": auction_ms,
            "lap_auction_launches_auction_step": auction_path,
            "peak_mem_GB": step_peak / 1e9,
            "kernel_vs_plain_loss_max_rel": max(loss_rel.values()),
            "kernel_vs_plain_grad_max_rel": rel_a,
            "kernel_vs_plain_grad_worst": worst_a,
            "bwd_kernel_vs_plain_bwd_grad_max_rel": rel_b,
            "bwd_kernel_vs_plain_bwd_grad_worst": worst_b,
            "kernel_step_peak_mem_GB": peak_k / 1e9,
            "plain_step_peak_mem_GB": peak_p / 1e9}


# bars of train_bf16, which compares the kernels' step with two others from
# the seeded weights.  Against the plain-MSDA step (the plain versions of all
# three kernels): the forwards differ in float32 sum order, and every bf16
# cast after an MSDA turns that into a bf16 step (2**-8) wherever a value
# straddles one, over 3 + 3 layers.  The loss dict is held on the JAX
# package's statistic and bar for whole models in bf16, |a - b| / (|a| + 1)
# < 0.15 (tests/test_mixed_precision.py:51), as
# tests/test_torch_mixed_precision.py holds the port's bf16 step against
# JAX's (the depth head amplifies those steps through 1/sigmoid).  Its
# gradients are reported, not held: so many sampling points move by a bf16
# step's worth that some cross a pixel edge, where dLoc jumps (the float32
# train phase's 1e-2 bar is set by the same jumps at float32's last bit).
# Against the kernel forward with the plain backward (the backward kernel
# alone, as the float32 train phase's 1e-3): the forwards are the same bits;
# dvalue, the one output the two backwards round apart, differs by a bf16
# step where a float32 sum straddles one, and every bf16 gradient product
# below it may round one step apart too: 1e-3 plus BF16_STEPS such steps of
# each gradient's scale, its floor 1e-2 of the largest gradient (the float32
# floor, 1e-4, times the ratio of bf16's rounding noise on an exactly zero
# gradient to float32's is above 1)
BF16_LOSS_BAR = 0.15
BF16_STEPS = 4
BF16_BWD_GRAD_BAR = 1e-3 + BF16_STEPS * 2.0 ** -8
BF16_GRAD_FLOOR = 1e-2


def bf16_step_comparison(model, inputs, targets, ccfg, floor_rel: float,
                         add_data=None):
    """Loss dicts and gradients of one forward and backward from the current
    weights, dropout off (with ``add_data``, the pseudo-label cars' losses
    too): the kernels ("k"), the plain MSDA ("p"), the forward kernel with
    the plain backward ("kp").  Returns the loss
    statistic |a - b| / (|a| + 1) of k against p, and each parameter's
    max |difference| over its scale (floored at ``floor_rel`` of the largest
    gradient) of k against p and against kp, and k's loss dict."""
    import torch

    from monosowa_tpu_torch.models.criterion import criterion
    from monosowa_tpu_torch.models.layers import Dropout
    from monosowa_tpu_torch.models.transformer import MSDeformAttnModule
    from monosowa_tpu_torch.ops import msda

    class Plain(torch.autograd.Function):
        """The MSDA forward kernel or its plain version, with the plain
        backward of K2 and K3 (dvalue in value's dtype, its float32 sum
        rounded once)."""

        @staticmethod
        def forward(ctx, value, loc, aw, shapes, kernel_fwd):
            ctx.shapes = shapes
            ctx.save_for_backward(value, loc, aw)
            if kernel_fwd:
                return msda._launch_fwd(value, shapes, loc, aw)
            return msda.ms_deform_attn_plain(value, shapes, loc, aw)

        @staticmethod
        def backward(ctx, dout):
            value, loc, aw = ctx.saved_tensors
            dout = dout.contiguous()
            dloc, daw = msda.msda_grad_loc_aw_plain(value, ctx.shapes, loc,
                                                    aw, dout)
            return (msda.msda_grad_value_plain(value.shape, ctx.shapes, loc,
                                               aw, dout, value.dtype),
                    dloc, daw, None, None)

    def plain(kernel_fwd):
        return lambda value, shapes, loc, aw: Plain.apply(
            value.contiguous(), loc.contiguous(), aw.contiguous(),
            tuple(shapes), kernel_fwd)

    model.train()
    dropouts = [mod for mod in model.modules() if isinstance(mod, Dropout)]
    dropout_p = [mod.p for mod in dropouts]
    for mod in dropouts:
        mod.p = 0.0
    attn = [mod for mod in model.modules()
            if isinstance(mod, MSDeformAttnModule)]

    def grads_with(fn):
        for mod in attn:
            mod.msda = fn
        model.zero_grad(set_to_none=True)
        losses = criterion(model(*inputs), targets, ccfg,
                           add_data=add_data)
        losses["loss_total"].backward()
        torch.cuda.synchronize()
        return ({k: float(v.detach()) for k, v in losses.items()},
                {n: p.grad.detach().clone()
                 for n, p in model.named_parameters()})

    try:
        runs = {"k": grads_with(msda.ms_deform_attn),
                "p": grads_with(plain(False)),
                "kp": grads_with(plain(True))}
    finally:
        for mod in attn:
            mod.msda = msda.ms_deform_attn
        for mod, p_drop in zip(dropouts, dropout_p):
            mod.p = p_drop
        model.zero_grad(set_to_none=True)
    losses_k, grads_k = runs["k"]

    def rel(want):
        floor = floor_rel * max(float(g.abs().max()) for g in want.values())
        return {n: float((grads_k[n] - g).abs().max())
                / max(float(g.abs().max()), floor) for n, g in want.items()}

    if not all(g.dtype == torch.float32 for g in grads_k.values()):
        raise AssertionError("a gradient left float32")
    loss = {k: abs(losses_k[k] - v) / (abs(v) + 1.0)
            for k, v in runs["p"][0].items()}
    return loss, rel(runs["p"][1]), rel(runs["kp"][1]), losses_k


def train_bf16(dev) -> dict:
    """``make_train_step`` on the shipped config under "auto" (bf16 on the
    card): batch 2, 50 x 11 queries, the JV matcher.  First, from the seeded
    weights, ``bf16_step_comparison`` (bars above); then a warm-up and three
    timed steps, with launch counts, finite losses and float32 params,
    gradients and AdamW moments."""
    import numpy as np
    import torch

    from monosowa_tpu_torch.models.criterion import CriterionConfig
    from monosowa_tpu_torch.models.monodetr import build_monodetr
    from monosowa_tpu_torch.ops import lap, msda
    from monosowa_tpu_torch.train.optim import make_optimizer
    from monosowa_tpu_torch.train.sample import sample_batch as train_batch
    from monosowa_tpu_torch.train.trainer import (MODEL_INPUTS,
                                                  make_train_step,
                                                  targets_from_batch)

    torch.cuda.reset_peak_memory_stats()
    model = build_monodetr(shipped_model_config(), device=dev, seed=0)
    batch = train_batch(BATCH, IMG_H, IMG_W)
    inputs = [torch.as_tensor(batch[k], dtype=torch.float32, device=dev)
              for k in MODEL_INPUTS]
    ccfg = CriterionConfig(group_num=model.group_num,
                           num_queries=model.num_queries,
                           num_classes=model.num_classes)
    msda.launches_bf16 = msda.bwd_launches_bf16 = 0
    loss, grad_p, grad_kp, _ = bf16_step_comparison(
        model, inputs, targets_from_batch(batch, dev), ccfg, BF16_GRAD_FLOOR)
    # the kernels' step and the forward kernel of the kernel-plain step
    if (msda.launches_bf16, msda.bwd_launches_bf16) != (
            2 * MSDA_PER_FORWARD, MSDA_PER_FORWARD):
        raise AssertionError("the kernels' step did not go through the bf16 "
                             "kernels")
    worst_loss = max(loss, key=loss.get)
    worst_p = max(grad_p, key=grad_p.get)
    worst_kp = max(grad_kp, key=grad_kp.get)
    if loss[worst_loss] >= BF16_LOSS_BAR:
        raise AssertionError(f"bf16 kernels vs plain MSDA, {worst_loss}: "
                             f"{loss[worst_loss]}")
    if grad_kp[worst_kp] > BF16_BWD_GRAD_BAR:
        raise AssertionError(f"bf16 backward kernel vs plain backward, "
                             f"gradient of {worst_kp}: {grad_kp[worst_kp]} "
                             f"of its scale")
    torch.cuda.empty_cache()

    opt = make_optimizer(model, 2e-4, 1e-4)
    step = make_train_step(model, None, opt)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    step(batch, gen)                                 # warm-up
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    # the main path: TRAIN_STEPS steps of make_train_step under "auto"
    torch.cuda.reset_peak_memory_stats()
    msda.launches = msda.bwd_launches = 0
    msda.launches_bf16 = msda.bwd_launches_bf16 = 0
    lap.jv_launches = lap.auction_launches = 0
    history, step_ms = [], []
    with policy_dtypes(model) as seen:
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            history.append(step(batch, gen))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {"msda_fwd_bf16": msda.launches_bf16,
                "msda_bwd_bf16": msda.bwd_launches_bf16,
                "msda_fwd": msda.launches, "msda_bwd": msda.bwd_launches,
                "lap_jv": lap.jv_launches}
    step_peak = torch.cuda.max_memory_allocated()
    check_policy(seen, "torch.bfloat16", "train_bf16")
    want = {"msda_fwd_bf16": MSDA_PER_FORWARD * TRAIN_STEPS,
            "msda_bwd_bf16": MSDA_PER_FORWARD * TRAIN_STEPS,
            "msda_fwd": 0, "msda_bwd": 0,
            "lap_jv": LAP_PER_STEP * TRAIN_STEPS}
    if launches != want:
        raise AssertionError(f"{TRAIN_STEPS} bf16 steps launched {launches}, "
                             f"want {want}")
    for losses in history:
        if not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"non-finite losses: {losses}")
        if not losses["grad_norm"] > 0:
            raise AssertionError(f"grad_norm {losses['grad_norm']}")
    moments = [t for st in opt.state.values() for t in st.values()
               if torch.is_tensor(t) and t.dim()]
    kept = {str(t.dtype) for t in [*model.parameters(), *moments]} | {
        str(p.grad.dtype) for p in model.parameters() if p.grad is not None}
    if kept != {"torch.float32"}:
        raise AssertionError(f"params, gradients and moments in {kept}")
    return {"phase": "train_bf16", "compute_dtype": model.compute_dtype,
            "activations": {k: sorted(v) for k, v in seen.items()},
            "batch": BATCH, "image_hw": [IMG_H, IMG_W],
            "queries": TRAIN_QUERIES, "steps": TRAIN_STEPS,
            "warmup_step_s": warmup_s, "train_step_ms": step_ms,
            "train_step_ms_mean": sum(step_ms) / len(step_ms),
            "loss_total": [h["loss_total"] for h in history],
            "grad_norm": [h["grad_norm"] for h in history],
            "launches": launches, "params_grads_moments": sorted(kept),
            "peak_mem_GB": step_peak / 1e9,
            "kernel_vs_plain_loss_max_err": loss[worst_loss],
            "kernel_vs_plain_loss_worst": worst_loss,
            "kernel_vs_plain_grad_max_rel_reported": grad_p[worst_p],
            "kernel_vs_plain_grad_worst": worst_p,
            "bwd_kernel_vs_plain_bwd_grad_max_rel": grad_kp[worst_kp],
            "bwd_kernel_vs_plain_bwd_grad_worst": worst_kp,
            "bars": {"loss_abs_over_abs_plus_1": BF16_LOSS_BAR,
                     "bwd_grad_rel": BF16_BWD_GRAD_BAR,
                     "grad_floor_of_largest": BF16_GRAD_FLOOR}}


def live_add_data(model, inputs, targets, add, ccfg, per_layer: int = 4):
    """The payload with cars moved onto the model's own boxes: for each
    decoder layer and image, a canonical car (the first template, 256
    points) 0.3 m off the centre of each of the layer's first
    ``per_layer`` matched queries (decoded as the criterion decodes them),
    its mask the union of the image's own car masks.  A random model's
    boxes lie far from the dataset's cars (no query within
    ``tfl_match_dist``: the TFL and mask losses are 0 there), so the aux
    losses and their gradients are live only on such a payload."""
    import torch

    from monosowa_tpu_torch.models import tfl_aux
    from monosowa_tpu_torch.models.matcher import hungarian_match

    with torch.no_grad():
        out = model(*inputs)
    layers = [out] + out["aux_outputs"]
    pts, pmask = add.car_points.clone(), add.car_pmask.clone()
    valid, masks = add.car_valid.clone(), add.car_masks.clone()
    tmpl = add.templates[0]
    for lid, o in enumerate(layers):
        idx = hungarian_match(o["pred_logits"], o["pred_boxes"],
                              targets.labels, targets.boxes_3d,
                              targets.valid, ccfg.matcher, ccfg.num_queries)
        for b in range(pts.shape[0]):
            qidx, _ = tfl_aux.gather_matched_queries(idx[b], per_layer)
            boxes7 = tfl_aux.decode_pred_boxes7(
                o["pred_boxes"][b, qidx], o["pred_depth"][b, qidx],
                o["pred_3d_dim"][b, qidx], o["pred_angle"][b, qidx],
                add.calib[b], add.resolution, add.canonical_scale[b],
                add.calib.new_zeros(3), add.trans_inv[b], add.flip[b],
                add.img_w[b])
            for k in range(per_layer):
                c = lid * per_layer + k
                pts[b, c] = 0.0
                pts[b, c, :tmpl.shape[0]] = tmpl + boxes7[k, :3] + 0.3
                pmask[b, c] = False
                pmask[b, c, :tmpl.shape[0]] = True
                valid[b, c] = True
                masks[b, c] = add.car_masks[b].amax(0)
    return add._replace(car_points=pts, car_pmask=pmask, car_valid=valid,
                        car_masks=masks)


def add_data_ccfg(model):
    """train_add's criterion: use_tfl and use_mask_loss, the JV matcher."""
    from monosowa_tpu_torch.models.criterion import CriterionConfig
    from monosowa_tpu_torch.models.matcher import MatcherConfig

    return CriterionConfig(group_num=model.group_num,
                           num_queries=model.num_queries,
                           num_classes=model.num_classes,
                           matcher=MatcherConfig(backend="jv"),
                           use_tfl=True, use_mask_loss=True,
                           tfl_gather_k=TFL_GATHER_K)


def add_data_batch():
    """A batch of SampleDataset with use_add_data, its cars written as the
    labeller's optimized_cars cache (write_sample_cars); and the payload's
    host ms an image."""
    from monosowa_tpu_torch.data.kitti_dataset import collate
    from monosowa_tpu_torch.train.sample import (SampleDataset,
                                                 write_sample_cars)

    with tempfile.TemporaryDirectory() as tmp:
        ds = SampleDataset(BATCH, {"resolution": [IMG_W, IMG_H],
                                   "use_add_data": True,
                                   "add_data_path": tmp, **ADD_DATA})
        write_sample_cars(tmp, ds)
        t0 = time.perf_counter()
        batch = collate([ds[i] for i in range(BATCH)])
        load_ms = (time.perf_counter() - t0) * 1e3 / BATCH
    n_cars = int(batch["car_valid"].sum())
    if n_cars < BATCH or not batch["car_masks"].any():
        raise AssertionError(f"{n_cars} cars with masks "
                             f"{batch['car_masks'].any()} in the payload")
    return batch, load_ms


def train_add(dev) -> dict:
    """The train step with pseudo-label cars: SampleDataset with
    use_add_data (its cars written as the labeller's optimized_cars cache
    by write_sample_cars), use_tfl and use_mask_loss, the JV matcher."""
    import numpy as np
    import torch

    from monosowa_tpu_torch.models.criterion import criterion
    from monosowa_tpu_torch.models.layers import Dropout
    from monosowa_tpu_torch.models.monodetr import MonoDETR
    from monosowa_tpu_torch.models.transformer import MSDeformAttnModule
    from monosowa_tpu_torch.ops import lap, msda
    from monosowa_tpu_torch.train.optim import make_optimizer
    from monosowa_tpu_torch.train.trainer import (MODEL_INPUTS,
                                                  _tfl_templates,
                                                  add_data_from_batch,
                                                  make_train_step,
                                                  targets_from_batch)

    model = MonoDETR(device=dev, seed=0, compute_dtype="float32")
    ccfg = add_data_ccfg(model)
    batch, load_ms = add_data_batch()
    n_cars = int(batch["car_valid"].sum())

    # one forward + backward each from the seeded weights, dropout off, on
    # the live payload: the kernels (MSDA, JV) against the plain MSDA and
    # the plain JV
    model.train()
    dropouts = [mod for mod in model.modules() if isinstance(mod, Dropout)]
    dropout_p = [mod.p for mod in dropouts]
    for mod in dropouts:
        mod.p = 0.0
    attn = [mod for mod in model.modules()
            if isinstance(mod, MSDeformAttnModule)]
    inputs = [torch.as_tensor(batch[k], dtype=torch.float32, device=dev)
              for k in MODEL_INPUTS]
    targets = targets_from_batch(batch, dev)
    add = add_data_from_batch(batch, *_tfl_templates(dev), dev)
    live = live_add_data(model, inputs, targets, add, ccfg)
    heads = [p for n, p in model.named_parameters()
             if n.startswith(("depth_embed", "dim_embed", "angle_embed",
                              "bbox_embed"))]
    jv_kernel = lap.lap_jv

    def grads_with(msda_fn, jv_fn):
        for mod in attn:
            mod.msda = msda_fn
        lap.lap_jv = jv_fn
        model.zero_grad(set_to_none=True)
        try:
            losses = criterion(model(*inputs), targets, ccfg, add_data=live)
            g_tfl = torch.autograd.grad(losses["loss_tfl"], heads,
                                        retain_graph=True, allow_unused=True)
            losses["loss_total"].backward()
        finally:
            lap.lap_jv = jv_kernel
        torch.cuda.synchronize()
        tfl_norm = float(torch.linalg.vector_norm(torch.stack(
            [g.norm() for g in g_tfl if g is not None])))
        return ({k: float(v.detach()) for k, v in losses.items()},
                {n: p.grad.detach().clone()
                 for n, p in model.named_parameters()}, tfl_norm)

    jv0 = lap.jv_launches
    losses_k, grads_k, tfl_norm = grads_with(msda.ms_deform_attn, jv_kernel)
    if lap.jv_launches - jv0 != LAP_PER_STEP:
        raise AssertionError(f"the kernel step launched lap_jv "
                             f"{lap.jv_launches - jv0} times")
    losses_p, grads_p, _ = grads_with(msda.ms_deform_attn_plain,
                                      lap.solve_lap_jv)
    for mod in attn:
        mod.msda = msda.ms_deform_attn
    for mod, p_drop in zip(dropouts, dropout_p):
        mod.p = p_drop
    model.zero_grad(set_to_none=True)
    aux_keys = [k for k in losses_k if k.startswith(("loss_tfl",
                                                      "loss_mask"))]
    if sorted(aux_keys) != ["loss_mask", "loss_mask_0", "loss_mask_1",
                            "loss_tfl", "loss_tfl_0", "loss_tfl_1"]:
        raise AssertionError(f"aux-loss keys {aux_keys}")
    for k in aux_keys:
        if not (np.isfinite(losses_k[k]) and losses_k[k] > 0):
            raise AssertionError(f"{k} = {losses_k[k]}")
    if not tfl_norm > 0:
        raise AssertionError("loss_tfl alone has no gradient in the 3D "
                             "heads")
    loss_rel = {k: abs(losses_k[k] - v) / max(abs(v), 1e-12)
                for k, v in losses_p.items()}
    if max(loss_rel.values()) > 1e-5:
        raise AssertionError(f"kernels vs plain, loss dict: {loss_rel}")
    floor = 1e-4 * max(float(g.abs().max()) for g in grads_p.values())
    grad_rel = {n: float((grads_k[n] - g).abs().max())
                / max(float(g.abs().max()), floor)
                for n, g in grads_p.items()}
    worst = max(grad_rel, key=grad_rel.get)
    if grad_rel[worst] > 1e-2:
        raise AssertionError(f"kernels vs plain, gradient of {worst}: "
                             f"{grad_rel[worst]} of its scale")
    del grads_k, grads_p
    torch.cuda.empty_cache()

    step = make_train_step(model, ccfg, make_optimizer(model, 2e-4, 1e-4))
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    with recording_lap() as recorded:                # the matches' costs
        step(batch, gen)                             # warm-up
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    # the main path: TRAIN_STEPS steps of make_train_step with add data
    torch.cuda.reset_peak_memory_stats()
    msda.launches = msda.bwd_launches = 0
    msda.launches_bf16 = msda.bwd_launches_bf16 = 0
    lap.jv_launches = lap.auction_launches = 0
    history, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        history.append(step(batch, gen))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {"msda_fwd": msda.launches, "msda_bwd": msda.bwd_launches,
                "lap_jv": lap.jv_launches,
                "lap_auction": lap.auction_launches}
    peak = torch.cuda.max_memory_allocated()
    for losses in history:
        if not all(np.isfinite(v) for v in losses.values()) \
                or not losses["grad_norm"] > 0 \
                or not all(losses[k] >= 0 for k in aux_keys):
            raise AssertionError(f"train_add losses: {losses}")
    want = {"msda_fwd": MSDA_PER_FORWARD * TRAIN_STEPS,
            "msda_bwd": MSDA_PER_FORWARD * TRAIN_STEPS,
            "lap_jv": LAP_PER_STEP * TRAIN_STEPS, "lap_auction": 0}
    if launches != want:
        raise AssertionError(f"{TRAIN_STEPS} train steps with add data "
                             f"launched {launches}, want {want}")
    return {"phase": "train_add", "batch": BATCH, "image_hw": [IMG_H, IMG_W],
            "queries": TRAIN_QUERIES, "steps": TRAIN_STEPS, **ADD_DATA,
            "template_points": int(add.templates.shape[1]),
            "tfl_gather_k": TFL_GATHER_K, "cars": n_cars,
            "payload_ms_per_image": load_ms, "warmup_step_s": warmup_s,
            "train_step_ms": step_ms,
            "train_step_ms_mean": sum(step_ms) / len(step_ms),
            "loss_total": [h["loss_total"] for h in history],
            "aux_losses": {k: [h[k] for h in history] for k in aux_keys},
            "live_payload_aux_losses": {k: losses_k[k] for k in aux_keys},
            "grad_norm": [h["grad_norm"] for h in history],
            "loss_tfl_grad_norm_3d_heads": tfl_norm,
            "launches": launches, "peak_mem_GB": peak / 1e9,
            "_lap_costs": recorded,
            "kernel_vs_plain_loss_max_rel": max(loss_rel.values()),
            "kernel_vs_plain_aux_loss_rel": {k: loss_rel[k]
                                             for k in aux_keys},
            "kernel_vs_plain_grad_max_rel": grad_rel[worst],
            "kernel_vs_plain_grad_worst": worst}


def train_add_bf16(dev) -> dict:
    """train_add under the bf16 policy (``compute_dtype`` "bfloat16", what
    "auto" resolves to on the card): from the seeded weights, dropout off, on the live payload,
    ``bf16_step_comparison`` with the TFL and mask losses on train_bf16's
    bars (the loss dict within BF16_LOSS_BAR of |a| + 1; the backward
    kernel alone within BF16_BWD_GRAD_BAR of each gradient's scale, inside
    the 5e-2 bar of a bf16 step; the kernels against the plain MSDA
    reported, as train_bf16 reports them: dLoc's jumps); then a warm-up and
    TRAIN_STEPS timed steps of ``make_train_step``: launch counts, finite
    aux losses, float32 params, gradients and AdamW moments."""
    import numpy as np
    import torch

    from monosowa_tpu_torch.models.layers import Dropout
    from monosowa_tpu_torch.models.monodetr import MonoDETR
    from monosowa_tpu_torch.ops import msda
    from monosowa_tpu_torch.train.optim import make_optimizer
    from monosowa_tpu_torch.train.trainer import (MODEL_INPUTS,
                                                  _tfl_templates,
                                                  add_data_from_batch,
                                                  make_train_step,
                                                  targets_from_batch)

    model = MonoDETR(device=dev, seed=0, compute_dtype="bfloat16")
    ccfg = add_data_ccfg(model)
    batch, _ = add_data_batch()
    inputs = [torch.as_tensor(batch[k], dtype=torch.float32, device=dev)
              for k in MODEL_INPUTS]
    targets = targets_from_batch(batch, dev)
    add = add_data_from_batch(batch, *_tfl_templates(dev), dev)
    dropouts = [mod for mod in model.modules() if isinstance(mod, Dropout)]
    dropout_p = [mod.p for mod in dropouts]
    for mod in dropouts:
        mod.p = 0.0
    model.train()
    live = live_add_data(model, inputs, targets, add, ccfg)
    for mod, p_drop in zip(dropouts, dropout_p):
        mod.p = p_drop
    msda.launches_bf16 = msda.bwd_launches_bf16 = 0
    loss, grad_p, grad_kp, losses_k = bf16_step_comparison(
        model, inputs, targets, ccfg, BF16_GRAD_FLOOR, add_data=live)
    if (msda.launches_bf16, msda.bwd_launches_bf16) != (
            2 * MSDA_PER_FORWARD, MSDA_PER_FORWARD):
        raise AssertionError("the kernels' step did not go through the bf16 "
                             "kernels")
    aux_keys = sorted(k for k in losses_k if k.startswith(("loss_tfl",
                                                            "loss_mask")))
    if aux_keys != ["loss_mask", "loss_mask_0", "loss_mask_1", "loss_tfl",
                    "loss_tfl_0", "loss_tfl_1"]:
        raise AssertionError(f"aux-loss keys {aux_keys}")
    for k in aux_keys:
        if not (np.isfinite(losses_k[k]) and losses_k[k] > 0):
            raise AssertionError(f"{k} = {losses_k[k]}")
    worst_loss = max(loss, key=loss.get)
    worst_p = max(grad_p, key=grad_p.get)
    worst_kp = max(grad_kp, key=grad_kp.get)
    if loss[worst_loss] >= BF16_LOSS_BAR:
        raise AssertionError(f"train_add bf16 kernels vs plain MSDA, "
                             f"{worst_loss}: {loss[worst_loss]}")
    if grad_kp[worst_kp] > BF16_BWD_GRAD_BAR:
        raise AssertionError(f"train_add bf16 backward kernel vs plain "
                             f"backward, gradient of {worst_kp}: "
                             f"{grad_kp[worst_kp]} of its scale")
    torch.cuda.empty_cache()

    opt = make_optimizer(model, 2e-4, 1e-4)
    step = make_train_step(model, ccfg, opt)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    step(batch, gen)                                 # warm-up
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    # the main path: TRAIN_STEPS steps of make_train_step with add data
    # under the bf16 policy
    torch.cuda.reset_peak_memory_stats()
    reset_variant_counts()
    history, step_ms = [], []
    with policy_dtypes(model) as seen:
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            history.append(step(batch, gen))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = variant_counts()
    peak = torch.cuda.max_memory_allocated()
    check_policy(seen, "torch.bfloat16", "train_add_bf16")
    want = {k: 0 for k in launches}
    want.update(msda_fwd_bf16=MSDA_PER_FORWARD * TRAIN_STEPS,
                msda_bwd_bf16=MSDA_PER_FORWARD * TRAIN_STEPS,
                lap_jv=LAP_PER_STEP * TRAIN_STEPS)
    if launches != want:
        raise AssertionError(f"{TRAIN_STEPS} bf16 steps with add data "
                             f"launched {launches}, want {want}")
    for losses in history:
        if not all(np.isfinite(v) for v in losses.values()) \
                or not losses["grad_norm"] > 0 \
                or not all(losses[k] >= 0 for k in aux_keys):
            raise AssertionError(f"train_add_bf16 losses: {losses}")
    moments = [t for st in opt.state.values() for t in st.values()
               if torch.is_tensor(t) and t.dim()]
    kept = {str(t.dtype) for t in [*model.parameters(), *moments]} | {
        str(p.grad.dtype) for p in model.parameters() if p.grad is not None}
    if kept != {"torch.float32"}:
        raise AssertionError(f"params, gradients and moments in {kept}")
    return {"phase": "train_add_bf16", "compute_dtype": model.compute_dtype,
            "batch": BATCH, "image_hw": [IMG_H, IMG_W],
            "queries": TRAIN_QUERIES, "steps": TRAIN_STEPS, **ADD_DATA,
            "warmup_step_s": warmup_s, "train_step_ms": step_ms,
            "train_step_ms_mean": sum(step_ms) / len(step_ms),
            "loss_total": [h["loss_total"] for h in history],
            "aux_losses": {k: [h[k] for h in history] for k in aux_keys},
            "live_payload_aux_losses": {k: losses_k[k] for k in aux_keys},
            "grad_norm": [h["grad_norm"] for h in history],
            "launches": launches, "params_grads_moments": sorted(kept),
            "peak_mem_GB": peak / 1e9,
            "kernel_vs_plain_loss_max_err": loss[worst_loss],
            "kernel_vs_plain_loss_worst": worst_loss,
            "kernel_vs_plain_aux_loss_err": {k: loss[k] for k in aux_keys},
            "kernel_vs_plain_grad_max_rel_reported": grad_p[worst_p],
            "kernel_vs_plain_grad_worst": worst_p,
            "bwd_kernel_vs_plain_bwd_grad_max_rel": grad_kp[worst_kp],
            "bwd_kernel_vs_plain_bwd_grad_worst": worst_kp,
            "bars": {"loss_abs_over_abs_plus_1": BF16_LOSS_BAR,
                     "bwd_grad_rel": BF16_BWD_GRAD_BAR,
                     "grad_floor_of_largest": BF16_GRAD_FLOOR}}


# ---------------------------------------------------------------------------
# msda_onehot: the explicit MSDA backends under float32 read bf16 value rows
# ---------------------------------------------------------------------------

def msda_onehot(dev) -> dict:
    """configs/monodetr_kitti.yaml's model at its widths through
    ``build_monodetr`` with ``compute_dtype: float32`` and ``msda_backend:
    onehot``: value is rounded to bf16 before every MSDA (the JAX backend's
    bf16 operands), so the bf16 kernels run and the float32 ones do not.
    REQUESTS requests through ``run_inference`` and one step of
    ``make_train_step`` (MSDA_PER_FORWARD launches of each bf16 kernel),
    every MSDA launch of the step recorded and replayed against the plain
    versions on the same bf16 rows (out, dloc, daw within 1e-5 of their
    magnitude, dvalue one bf16 step more); then one request each under
    ``mxu`` and ``pallas``: the same bf16 kernels, the same result files."""
    import numpy as np
    import torch

    from monosowa_tpu_torch.kittiio import read_label_file
    from monosowa_tpu_torch.models.monodetr import build_monodetr
    from monosowa_tpu_torch.models.transformer import MSDeformAttnModule
    from monosowa_tpu_torch.train.optim import make_optimizer
    from monosowa_tpu_torch.train.sample import sample_batch as train_batch
    from monosowa_tpu_torch.train.tester import run_inference
    from monosowa_tpu_torch.train.trainer import (make_eval_step,
                                                  make_train_step)

    t_phase = time.perf_counter()
    base = {**shipped_model_config(), "compute_dtype": "float32"}
    rng = np.random.default_rng(3)
    batches = [sample_batch(rng, 2 * i) for i in range(REQUESTS)]

    def requests(backend: str, n: int):
        model = build_monodetr({**base, "msda_backend": backend},
                               device=dev, seed=0)
        attn = [m for m in model.modules()
                if isinstance(m, MSDeformAttnModule)]
        if len(attn) != MSDA_PER_FORWARD or any(m.backend != backend
                                                for m in attn):
            raise AssertionError(f"{backend}: the model's MSDA modules")
        make_eval_step(model, topk=50)(batches[0])   # warm-up
        torch.cuda.synchronize()
        reset_variant_counts()
        with tempfile.TemporaryDirectory() as tmp:
            cfg = {"tester": {"threshold": 0.0, "topk": 50},
                   "trainer": {"save_path": tmp}, "dataset": {}}
            t0 = time.perf_counter()
            out_dir = run_inference(model, batches[:n], cfg,
                                    logger=lambda s: None)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / n
            files = {}
            for f in sorted(os.listdir(out_dir)):
                labels = read_label_file(os.path.join(out_dir, f))
                if len(labels) != 50 or not np.isfinite(labels.pos).all():
                    raise AssertionError(f"{backend} {f}: {len(labels)} "
                                         "rows")
                with open(os.path.join(out_dir, f)) as fh:
                    files[f] = fh.read()
        counts = {k: v for k, v in variant_counts().items() if v}
        if counts != {"msda_fwd_bf16": MSDA_PER_FORWARD * n} \
                or len(files) != n * BATCH:
            raise AssertionError(f"{backend}: {n} requests launched {counts}"
                                 f", {len(files)} result files")
        return model, files, ms, counts

    model, files, ms, serve_counts = requests("onehot", REQUESTS)

    # one step of make_train_step, every MSDA launch recorded
    batch = train_batch(BATCH, IMG_H, IMG_W)
    step = make_train_step(model, None, make_optimizer(model, 2e-4, 1e-4))
    gen = torch.Generator(device=dev).manual_seed(0)
    attn = [m for m in model.modules() if isinstance(m, MSDeformAttnModule)]
    fwd_rec, restore = recording_msda(attn)
    try:
        with recording_msda_bwd() as bwd_rec:
            reset_variant_counts()
            t0 = time.perf_counter()
            losses = step(batch, gen)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            step_counts = {k: v for k, v in variant_counts().items() if v}
    finally:
        restore()
    want = {"msda_fwd_bf16": MSDA_PER_FORWARD,
            "msda_bwd_bf16": MSDA_PER_FORWARD, "lap_jv": LAP_PER_STEP}
    if step_counts != want:
        raise AssertionError(f"the onehot step launched {step_counts}, "
                             f"want {want}")
    if not all(np.isfinite(v) for v in losses.values()) \
            or not losses["grad_norm"] > 0:
        raise AssertionError(f"onehot step: {losses}")
    if {str(r[0].dtype) for r in fwd_rec + bwd_rec} != {"torch.bfloat16"}:
        raise AssertionError("an MSDA of the step read other rows than "
                             "bf16")
    del model, step
    torch.cuda.empty_cache()

    # K1 / K2+K3 bf16 against the plain versions on the recorded launches
    fwd, bwd = {}, {}
    for name, pick in (("encoder", lambda q: q == ENC_TOKENS),
                       ("decoder", lambda q: q != ENC_TOKENS)):
        recs_f = [r for r in fwd_rec if pick(r[2].shape[1])]
        recs_b = [r for r in bwd_rec if pick(r[2].shape[1])]
        label = f"onehot {name} Q={recs_f[0][2].shape[1]}"
        fwd[label] = check_msda_recorded(label, recs_f)
        bwd[label] = check_msda_bwd_recorded(label, recs_b)
    del fwd_rec, bwd_rec
    torch.cuda.empty_cache()

    # step 0's dispatch: mxu and pallas read the same bf16 rows
    others = {}
    for backend in ("mxu", "pallas"):
        m2, f2, ms2, c2 = requests(backend, 1)
        if f2 != {k: files[k] for k in f2}:
            raise AssertionError(f"{backend}: result files differ from "
                                 "onehot's")
        others[backend] = {"ms_per_request": ms2, "launches": c2,
                           "result_files_equal_onehot": len(f2)}
        del m2
        torch.cuda.empty_cache()
    keys = ("shape", "max_abs_err", "ms", "ms_launched_from_python",
            "plain_ms", "bound_ms", "bound_by")
    return {"phase": "msda_onehot", "compute_dtype": "float32",
            "msda_backend": "onehot", "requests": REQUESTS,
            "images_per_request": BATCH, "image_hw": [IMG_H, IMG_W],
            "ms_per_request": ms, "serve_launches": serve_counts,
            "train_step_s_first": step_s, "train_step_launches": step_counts,
            "loss_total": losses["loss_total"],
            "grad_norm": losses["grad_norm"], "other_backends": others,
            "msda_fwd_bf16": {k: {f: v.get(f) for f in keys}
                              for k, v in fwd.items()},
            "msda_bwd_bf16": {k: {f: v.get(f) for f in keys}
                              for k, v in bwd.items()},
            "launches": {
                "msda_fwd_bf16": serve_counts["msda_fwd_bf16"]
                + step_counts["msda_fwd_bf16"]
                + sum(o["launches"]["msda_fwd_bf16"]
                      for o in others.values()),
                "msda_bwd_bf16": step_counts["msda_bwd_bf16"],
                "lap_jv": step_counts["lap_jv"]},
            "seconds": time.perf_counter() - t_phase,
            "_fwd": fwd, "_bwd": bwd}


# ---------------------------------------------------------------------------
# ddp: data-parallel training (monosowa_tpu_torch/parallel) on the one card
# ---------------------------------------------------------------------------

DDP_WORLD = 2
DDP_TIMEOUT_S = 300


def ddp_step(dev, data_parallel=None, timed: int = 2):
    """The train phase's float32 model (seed 0, dropout 0.1) and batch, one
    step of ``make_train_step`` on this rank's slice of the batch (all of it
    without ``data_parallel``): loss dict, gradients (copies) and launch
    counts of that step, and the ms of the first step and of ``timed``
    steps after a second warm-up step (their mean)."""
    import torch

    from monosowa_tpu_torch.models.monodetr import MonoDETR
    from monosowa_tpu_torch.train.optim import make_optimizer
    from monosowa_tpu_torch.train.sample import sample_batch as train_batch
    from monosowa_tpu_torch.train.trainer import make_train_step

    model = MonoDETR(device=dev, seed=0, compute_dtype="float32")
    batch = train_batch(BATCH, IMG_H, IMG_W)
    if data_parallel is not None:
        batch = {k: v[data_parallel.shard(BATCH)] for k, v in batch.items()}
    step = make_train_step(model, None, make_optimizer(model, 2e-4, 1e-4),
                           data_parallel=data_parallel)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    reset_variant_counts()
    t0 = time.perf_counter()
    losses = step(batch, gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = {k: v for k, v in variant_counts().items() if v}
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    step(batch, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        step(batch, gen)
    torch.cuda.synchronize()
    return losses, grads, counts, {
        "first_step_ms": ms,
        "step_ms_mean": (time.perf_counter() - t0) * 1e3 / timed}


def ddp_rank(rank: int, store: str, out_dir: str, device: str) -> None:
    """A rank of the ddp phase's gloo group, in a process of its own on
    ``device`` (the one card): ``ddp_step`` on its half of the batch,
    written to ``out_dir``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from monosowa_tpu_torch.device import resolve_device
    from monosowa_tpu_torch.parallel import from_process_group

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(store, DDP_WORLD),
                            rank=rank, world_size=DDP_WORLD)
    try:
        dp = from_process_group(BATCH, dev)
        if (dp.rank, dp.size) != (rank, DDP_WORLD) or dp.group is None:
            raise AssertionError(f"rank {rank}: {dp}")
        losses, grads, counts, ms = ddp_step(dev, dp)
        torch.save({"losses": losses, "counts": counts, "ms": ms,
                    "grads": {k: v.cpu() for k, v in grads.items()}},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def ddp(dev, backend: str = "nccl") -> dict:
    """Data parallelism (``monosowa_tpu_torch/parallel``), one train step of
    the float32 model at full width with dropout on, against the same step
    of one process on the whole batch without a process group: (a) a
    world of one on ``nccl`` (the loss dict equal; gradients within 1e-5
    of the largest, the backward's float32 atomics may sum in another
    order); (b) DDP_WORLD processes on ``gloo`` with CUDA tensors on the
    one card, each with its half of the batch (each loss within 2e-4 of
    itself and the gradients within 2e-4 of the largest:
    tests/test_torch_train_step.py's bar; each tensor's own share is
    reported: a half batch sums in another order, and a ReLU input of the
    random ResNet-50 within rounding of 0 then moves the gradients of the
    weights below it, tools/check_relu_ties.py).
    ``backend`` is the world of one's."""
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from monosowa_tpu_torch.parallel import from_process_group

    t_phase = time.perf_counter()
    losses_0, grads_0, counts_0, ms_0 = ddp_step(dev)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            dp = from_process_group(BATCH, dev)
            if dp.group is None or dist.get_backend(dp.group) != backend:
                raise AssertionError(f"the world of one: {dp}")
            losses_1, grads_1, counts_1, ms_1 = ddp_step(dev, dp)
        finally:
            dist.destroy_process_group()
    if counts_1 != counts_0:
        raise AssertionError(f"nccl step launched {counts_1}, the step "
                             f"without a group {counts_0}")
    same = {k: v for k, v in losses_1.items()
            if k != "grad_norm" and v != losses_0[k]}
    if sorted(losses_1) != sorted(losses_0) or same:
        raise AssertionError(f"nccl world of one, loss dict: {same}")
    if set(grads_1) != set(grads_0):
        raise AssertionError("nccl world of one: other gradients")
    top = max(float(g.abs().max()) for g in grads_0.values())
    err_1 = max(float((grads_1[k] - g).abs().max())
                for k, g in grads_0.items())
    if err_1 > 1e-5 * top:
        raise AssertionError(f"nccl world of one, gradients: {err_1} > "
                             f"1e-5 * {top}")
    worst_1, rel_1 = grad_rel(grads_1, grads_0)
    del grads_1
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.spawn(ddp_rank, args=(os.path.join(tmp, "store"), tmp,
                                       str(dev)),
                       nprocs=DDP_WORLD, join=False)
        # a rank that hangs in a collective is killed, not waited for
        deadline = time.monotonic() + DDP_TIMEOUT_S
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                raise AssertionError(f"gloo ranks still running after "
                                     f"{DDP_TIMEOUT_S} s")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                 for r in range(DDP_WORLD)]
    gloo_s = time.perf_counter() - t0
    for r in ranks[1:]:
        if r["losses"] != ranks[0]["losses"] or any(
                not torch.equal(r["grads"][k], ranks[0]["grads"][k])
                for k in ranks[0]["grads"]):
            raise AssertionError("the gloo ranks hold other losses or "
                                 "gradients")
    got_l = ranks[0]["losses"]
    loss_rel = {k: abs(got_l[k] - v) / max(abs(v), 1e-6)
                for k, v in losses_0.items()}
    worst_l = max(loss_rel, key=loss_rel.get)
    if sorted(got_l) != sorted(losses_0) or loss_rel[worst_l] > 2e-4:
        raise AssertionError(f"gloo ranks vs one process, loss "
                             f"{worst_l}: {loss_rel[worst_l]}")
    grads_2 = {k: v.to(dev) for k, v in ranks[0]["grads"].items()}
    if set(grads_2) != set(grads_0):
        raise AssertionError("gloo ranks: other gradients")
    err_2 = max(float((grads_2[k] - g).abs().max())
                for k, g in grads_0.items())
    if err_2 > 2e-4 * top:
        raise AssertionError(f"gloo ranks vs one process, gradients: "
                             f"{err_2} > 2e-4 * {top}")
    worst_2, rel_2 = grad_rel(grads_2, grads_0)
    return {"phase": "ddp", "batch": BATCH, "image_hw": [IMG_H, IMG_W],
            "queries": TRAIN_QUERIES, "dropout": 0.1,
            "one_process": {**ms_0, "launches": counts_0,
                            "loss_total": losses_0["loss_total"],
                            "grad_norm": losses_0["grad_norm"]},
            "world_1": {"backend": backend, **ms_1, "launches": counts_1,
                             "loss_dict_equal": True,
                             "grad_max_abs_err": err_1,
                             "grad_max_abs": top,
                             "grad_max_rel": rel_1, "grad_worst": worst_1,
                             "grad_norm": losses_1["grad_norm"]},
            "gloo_world_2": {
                "step_ms_by_rank": [r["ms"] for r in ranks],
                "launches_by_rank": [r["counts"] for r in ranks],
                "seconds_with_process_start": gloo_s,
                "loss_max_rel": loss_rel[worst_l], "loss_worst": worst_l,
                "grad_max_abs_err": err_2, "grad_max_abs": top,
                "grad_max_rel_reported": rel_2, "grad_worst": worst_2,
                "grad_norm": got_l["grad_norm"]},
            "launches": {k: counts_0.get(k, 0) + counts_1.get(k, 0)
                         for k in ("msda_fwd", "msda_bwd", "lap_jv")},
            "seconds": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# the labeller's live networks (the model zoo): masks, depth, and labels
# from the caches they write
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# detector_variants: two_stage; DAB anchors + learned position embedding +
# RGB-D; DN-DETR queries; at the shipped widths
# ---------------------------------------------------------------------------

# padded targets an image (the dataset's max_objs), the valid ones of the
# two images, DN-DETR's groups of VARIANT_OBJS slots
VARIANT_OBJS = 50
VARIANT_VALID = (12, 7)
DN_GROUPS = 5
DN_QUERIES = DN_GROUPS * VARIANT_OBJS + TRAIN_QUERIES    # 800 an image
ENC_TOKENS = sum(h * w for h, w in ENC_SHAPES)           # 10,200


def variant_batch(use_depth: bool = False) -> dict:
    """``train.sample.sample_batch`` at 384 x 1280 with VARIANT_OBJS padded
    targets of which VARIANT_VALID are valid; with ``use_depth`` a 4th
    channel as the dataset encodes depth (metres clipped to 150, / 75 - 1)."""
    import numpy as np

    from monosowa_tpu_torch.train.sample import sample_batch as train_batch

    batch = train_batch(BATCH, IMG_H, IMG_W, max_objs=VARIANT_OBJS)
    valid = np.arange(VARIANT_OBJS)[None] < np.array(VARIANT_VALID)[:, None]
    batch["valid"], batch["mask_2d"] = valid, valid.copy()
    if use_depth:
        depth = np.random.default_rng(5).uniform(2.0, 80.0,
                                                 (BATCH, IMG_H, IMG_W, 1))
        batch["image"] = np.concatenate(
            [batch["image"], (depth / 75.0 - 1.0).astype(np.float32)], -1)
    return batch


def kernel_vs_plain_step(model, loss_of, label: str) -> dict:
    """One forward and backward of ``loss_of()`` with the MSDA kernels
    against one through the plain MSDA and one with the forward kernel and
    the plain backward, from the model's current weights with dropout off,
    on the train phase's bars: the loss dict within 1e-5 relative, each
    gradient within 1e-2 of its scale (``grad_rel``) against the plain
    MSDA and within 1e-3 against the plain backward on the same forward
    (the backward kernel alone)."""
    import torch

    from monosowa_tpu_torch.models.layers import Dropout
    from monosowa_tpu_torch.models.transformer import MSDeformAttnModule
    from monosowa_tpu_torch.ops import msda

    dropouts = [m for m in model.modules() if isinstance(m, Dropout)]
    saved_p = [m.p for m in dropouts]
    try:
        for m in dropouts:
            m.p = 0.0
        loss_k, grad_k, peak_k = msda_step_grads(model, loss_of,
                                                 msda.ms_deform_attn)
        loss_p, grad_p, peak_p = msda_step_grads(model, loss_of,
                                                 msda.ms_deform_attn_plain)
        loss_kp, grad_kp, _ = msda_step_grads(model, loss_of,
                                              kernel_fwd_plain_bwd)
    finally:
        for m in model.modules():
            if isinstance(m, MSDeformAttnModule):
                m.msda = msda.ms_deform_attn
        for m, p in zip(dropouts, saved_p):
            m.p = p
        model.zero_grad(set_to_none=True)
    loss_rel = {k: abs(loss_k[k] - v) / max(abs(v), 1e-12)
                for k, v in loss_p.items()}
    if sorted(loss_k) != sorted(loss_p) or max(loss_rel.values()) > 1e-5:
        raise AssertionError(f"{label}: kernel vs plain loss dict "
                             f"{loss_rel}")
    if loss_kp != loss_k:
        raise AssertionError(f"{label}: the forward kernel is not "
                             f"deterministic: {loss_k} != {loss_kp}")
    # the backward kernel vs the plain backward, the same forward: 1e-3
    worst_b, rel_b = grad_rel(grad_k, grad_kp)
    if rel_b > 1e-3:
        raise AssertionError(f"{label}: backward kernel vs plain backward, "
                             f"gradient of {worst_b}: {rel_b} of its scale")
    worst, rel = grad_rel(grad_k, grad_p)
    if rel > 1e-2:
        raise AssertionError(f"{label}: kernels vs plain MSDA, gradient of "
                             f"{worst}: {rel} of its scale")
    loss_worst = max(loss_rel, key=loss_rel.get)
    torch.cuda.empty_cache()
    return {"kernel_vs_plain_loss_max_rel": loss_rel[loss_worst],
            "kernel_vs_plain_loss_worst": loss_worst,
            "kernel_vs_plain_grad_max_rel": rel,
            "kernel_vs_plain_grad_worst": worst,
            "bwd_kernel_vs_plain_bwd_grad_max_rel": rel_b,
            "bwd_kernel_vs_plain_bwd_grad_worst": worst_b,
            "kernel_step_peak_mem_GB": peak_k / 1e9,
            "plain_step_peak_mem_GB": peak_p / 1e9}


@contextlib.contextmanager
def recording_msda_bwd():
    """Wrap ``msda._launch_bwd``: a copy of every backward launch's
    (value, shapes, loc, aw, dout)."""
    from monosowa_tpu_torch.ops import msda

    recorded = []
    launch = msda._launch_bwd

    def recording_launch(value, shapes, loc, aw, dout):
        recorded.append((value.clone(), tuple(shapes), loc.clone(),
                         aw.clone(), dout.clone()))
        return launch(value, shapes, loc, aw, dout)

    msda._launch_bwd = recording_launch
    try:
        yield recorded
    finally:
        msda._launch_bwd = launch


def check_msda_bwd_recorded(label: str, recorded) -> dict:
    """The backward kernel against the plain backward on the inputs of
    real launches: dvalue, dloc and daw each within 1e-5 of its magnitude,
    a bf16 dvalue one bf16 step more (``check_msda_bwd``'s bars); the first
    launch's times, bound and block map."""
    import torch

    from monosowa_tpu_torch.ops import msda

    def plain(value, shapes, loc, aw, dout):
        dloc, daw = msda.msda_grad_loc_aw_plain(value, shapes, loc, aw, dout)
        return (msda.msda_grad_value_plain(value.shape, shapes, loc, aw,
                                           dout, value.dtype), dloc, daw)

    errs = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    for value, shapes, loc, aw, dout in recorded:
        got = msda._launch_bwd(value, shapes, loc, aw, dout)
        want = plain(value, shapes, loc, aw, dout)
        torch.cuda.synchronize()
        for name, g, w in zip(("dvalue", "dloc", "daw"), got, want):
            diff = (g.float() - w.float()).abs()
            err, scale = float(diff.max()), float(w.float().abs().max())
            bar = torch.full_like(diff, 1e-5 * scale)
            if name == "dvalue" and value.dtype == torch.bfloat16:
                bar = bar + bf16_step(torch.maximum(g.float().abs(),
                                                    w.float().abs()))
            if not (g.dtype == w.dtype and torch.isfinite(g).all()
                    and bool((diff <= bar).all())):
                raise AssertionError(f"msda_bwd {label} {name}: max abs err "
                                     f"{err}, max abs {scale}, {g.dtype}")
            errs["max_abs_err"] = max(errs["max_abs_err"], err)
            errs["max_rel_err"] = max(errs["max_rel_err"],
                                      err / max(scale, 1e-30))
    value, shapes, loc, aw, dout = recorded[0]
    return msda_report(
        label, loc.shape[1], value, loc,
        {**errs, "launches_checked": len(recorded)},
        lambda: msda._launch_bwd(value, shapes, loc, aw, dout),
        lambda: plain(value, shapes, loc, aw, dout),
        msda_bound(value, loc, 4 * (2 * (loc.numel() + aw.numel())
                                    + dout.numel())
                   + value.numel() * value.element_size(), 2, shapes), 2,
        shapes)


def check_tall_jv(label: str, cost, n_valid) -> dict:
    """The tall form of ``lap_jv`` on one encoder match's costs (N images x
    10,200 tokens x 50 padded targets): equal to the plain
    ``solve_lap_jv`` on the card, its total cost at scipy's optimum within
    rel 1e-6 / abs 1e-5, every valid target assigned; its ms from a
    replayed graph and from Python, the plain version's, the scipy route's
    and the bound (the cost read once, the counts read and the assignment
    written once)."""
    import numpy as np
    import torch

    from monosowa_tpu_torch.ops import lap

    n, q, mmax = cost.shape
    if lap.jv_smem_bytes(q, mmax) <= lap.SMEM_LIMIT:
        raise AssertionError(f"{label}: Q={q} M={mmax} is not tall")
    launches = lap.jv_tall_launches
    got = lap.lap_jv(cost, n_valid)
    if lap.jv_tall_launches != launches + 1:
        raise AssertionError(f"{label}: the tall form did not launch")
    want = lap.solve_lap_jv(cost, n_valid)
    torch.cuda.synchronize()
    differ = int((got != want).sum())
    if differ:
        raise AssertionError(f"lap_jv {label}: {differ} assignments differ "
                             "from the plain version's")
    costs = cost.cpu().numpy().astype(np.float64)
    counts = n_valid.cpu().numpy()
    host = lap.solve_lap_host(cost, n_valid).cpu().numpy()
    a = got.cpu().numpy()
    for k in range(n):
        if int((a[k] >= 0).sum()) != min(int(counts[k]), q, mmax):
            raise AssertionError(f"lap_jv {label}: a valid target of "
                                 f"problem {k} is unassigned")
        val = costs[k, a[k] >= 0, a[k][a[k] >= 0]].sum()
        opt = costs[k, host[k] >= 0, host[k][host[k] >= 0]].sum()
        if abs(val - opt) > 1e-5 + 1e-6 * abs(opt):
            raise AssertionError(f"lap_jv {label}: total cost {val} against "
                                 f"scipy's {opt}")

    def host_clock_ms(fn, reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    nbytes = cost.numel() * 4 + n * 4 + n * q * 8
    return {"label": label, "form": "tall (one block of 1,024 threads a "
            "problem)", "shape": f"{label}: N={n} Q={q} M={mmax}",
            "n_valid": counts.tolist(), "assignments_differing": differ,
            "max_abs_err": 0.0,
            "ms": device_ms(lambda: lap.lap_jv(cost, n_valid), 20),
            "ms_launched_from_python": cuda_ms(
                lambda: lap.lap_jv(cost, n_valid), 20),
            "plain_ms": host_clock_ms(
                lambda: lap.solve_lap_jv(cost, n_valid), 1),
            "host_route_ms": host_clock_ms(
                lambda: lap.solve_lap_host(cost, n_valid), 3),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "compulsory_bytes": nbytes, "library_ms": None}


def variant_counts() -> dict:
    from monosowa_tpu_torch.ops import lap, msda

    return {"msda_fwd": msda.launches, "msda_bwd": msda.bwd_launches,
            "msda_fwd_bf16": msda.launches_bf16,
            "msda_bwd_bf16": msda.bwd_launches_bf16,
            "lap_jv": lap.jv_launches, "lap_jv_tall": lap.jv_tall_launches,
            "lap_auction": lap.auction_launches}


def reset_variant_counts() -> None:
    from monosowa_tpu_torch.ops import lap, msda

    msda.launches = msda.bwd_launches = 0
    msda.launches_bf16 = msda.bwd_launches_bf16 = 0
    lap.jv_launches = lap.jv_tall_launches = lap.auction_launches = 0


def run_variant(name: str, model, step, loss_of, want: dict,
                eval_batch=None) -> dict:
    """One variant: its kernels' step against the plain MSDA's
    (``kernel_vs_plain_step``), a warm-up step with every MSDA and JV
    launch recorded and one without, TRAIN_STEPS timed steps of ``step``
    (the main path: launch counts held to ``want``, a step's counts times
    TRAIN_STEPS), and with ``eval_batch`` REQUESTS requests through
    ``run_inference``."""
    import numpy as np
    import torch

    from monosowa_tpu_torch.kittiio import read_label_file
    from monosowa_tpu_torch.models.transformer import MSDeformAttnModule
    from monosowa_tpu_torch.train.tester import run_inference

    res = {"variant": name, **kernel_vs_plain_step(model, loss_of, name)}
    attn = [m for m in model.modules() if isinstance(m, MSDeformAttnModule)]
    fwd_rec, restore = recording_msda(attn)
    try:
        with recording_msda_bwd() as bwd_rec, recording_lap() as lap_rec:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            res["warmup_step_s"] = time.perf_counter() - t0
    finally:
        restore()
    step()                              # a second warm-up, not recorded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_variant_counts()
    history, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        history.append(step())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = variant_counts()
    res["peak_mem_GB"] = torch.cuda.max_memory_allocated() / 1e9
    expected = {k: want.get(k, 0) * TRAIN_STEPS for k in launches}
    if launches != expected:
        raise AssertionError(f"{name}: {TRAIN_STEPS} steps launched "
                             f"{launches}, want {expected}")
    for losses in history:
        if not all(np.isfinite(v) for v in losses.values()) \
                or not losses["grad_norm"] > 0:
            raise AssertionError(f"{name}: {losses}")
    res.update(train_step_ms=step_ms,
               train_step_ms_mean=sum(step_ms) / len(step_ms),
               loss_total=[h["loss_total"] for h in history],
               launches=launches)
    if eval_batch is not None:
        with tempfile.TemporaryDirectory() as tmp:
            cfg = {"tester": {"threshold": 0.0, "topk": 50},
                   "trainer": {"save_path": tmp}, "dataset": {}}
            run_inference(model, [eval_batch], cfg, logger=lambda s: None)
            torch.cuda.synchronize()
            reset_variant_counts()
            t0 = time.perf_counter()
            out_dir = run_inference(model, [eval_batch] * REQUESTS, cfg,
                                    logger=lambda s: None)
            torch.cuda.synchronize()
            res["ms_per_request"] = (time.perf_counter() - t0) * 1e3 \
                / REQUESTS
            res["eval_launches"] = variant_counts()
            if res["eval_launches"]["msda_fwd"] != \
                    MSDA_PER_FORWARD * REQUESTS:
                raise AssertionError(f"{name} eval: {res['eval_launches']}")
            for f in sorted(os.listdir(out_dir)):
                labels = read_label_file(os.path.join(out_dir, f))
                if len(labels) != 50 or not np.isfinite(labels.pos).all():
                    raise AssertionError(f"{name} eval {f}: {len(labels)} "
                                         "rows")
    # the recorded launches at the decoder's shapes (Q other than S)
    res["_fwd"] = [r for r in fwd_rec if r[2].shape[1] != ENC_TOKENS]
    res["_bwd"] = [r for r in bwd_rec if r[2].shape[1] != ENC_TOKENS]
    res["_tall"] = [r for r in lap_rec if r[0].shape[1] == ENC_TOKENS]
    return res


def detector_variants(dev) -> dict:
    """configs/monodetr_kitti.yaml's model at its widths (float32, seeded
    weights) with (a) ``two_stage`` and (b) ``use_dab`` + learned position
    embedding + ``use_depth``, each through ``build_monodetr``,
    ``make_train_step`` (JV matcher) and ``run_inference``; (c) DN-DETR
    (5 groups of 50 slots before the 550 queries: 800 decoder queries an
    image) written out as the JAX package's tests/test_dn_wiring.py does:
    ``prepare_dn``, the forward, the criterion plus ``dn_loss`` of the last
    layer, backward and an AdamW step.  Then K1 and K2/K3 replayed on the
    recorded decoder launches and the tall ``lap_jv`` on the recorded
    encoder matches."""
    import numpy as np
    import torch

    from monosowa_tpu_torch.models.criterion import CriterionConfig, criterion
    from monosowa_tpu_torch.models.dn_components import (DNConfig, dn_loss,
                                                         prepare_dn)
    from monosowa_tpu_torch.models.matcher import MatcherConfig
    from monosowa_tpu_torch.models.monodetr import MonoDETR, build_monodetr
    from monosowa_tpu_torch.train.optim import make_optimizer
    from monosowa_tpu_torch.train.trainer import (MODEL_INPUTS,
                                                  make_train_step,
                                                  targets_from_batch)

    t_phase = time.perf_counter()
    shipped = {**shipped_model_config(), "compute_dtype": "float32"}
    rng = np.random.default_rng(6)
    out = {"phase": "detector_variants", "batch": BATCH,
           "image_hw": [IMG_H, IMG_W], "targets": list(VARIANT_VALID),
           "padded_targets": VARIANT_OBJS}
    runs = {}

    def through_trainer(name, flags, use_depth=False):
        model = build_monodetr({**shipped, **flags}, device=dev, seed=0)
        batch = variant_batch(use_depth)
        inputs = [torch.as_tensor(batch[k], dtype=torch.float32, device=dev)
                  for k in MODEL_INPUTS]
        targets = targets_from_batch(batch, dev)
        ccfg = CriterionConfig(group_num=model.group_num,
                               num_queries=model.num_queries,
                               num_classes=model.num_classes,
                               matcher=MatcherConfig(backend="jv"))

        def loss_of():
            model.train()
            return criterion(model(*inputs), targets, ccfg)

        step_fn = make_train_step(model, None,
                                  make_optimizer(model, 2e-4, 1e-4))
        gen = torch.Generator(device=dev).manual_seed(0)
        request = sample_batch(rng, 0)
        if use_depth:
            request["image"] = variant_batch(True)["image"]
        want = {"msda_fwd": MSDA_PER_FORWARD, "msda_bwd": MSDA_PER_FORWARD,
                "lap_jv": LAP_PER_STEP + bool(flags.get("two_stage")),
                "lap_jv_tall": int(bool(flags.get("two_stage")))}
        runs[name] = run_variant(name, model, lambda: step_fn(batch, gen),
                                 loss_of, want, request)
        del model, step_fn
        torch.cuda.empty_cache()

    through_trainer("two_stage", {"two_stage": True})
    through_trainer("dab_learned_depth", {"use_dab": True,
                                          "position_embedding": "learned",
                                          "use_depth": True}, use_depth=True)

    # (c) DN-DETR, written out; MonoDETR's defaults are the shipped widths
    model = MonoDETR(use_dn=True, compute_dtype="float32", device=dev,
                     seed=0)
    if (model.d_model, model.num_queries, model.dec_layers) != (
            shipped["hidden_dim"], shipped["num_queries"],
            shipped["dec_layers"]):
        raise AssertionError("the DN model is not at the shipped widths")
    batch = variant_batch()
    inputs = [torch.as_tensor(batch[k], dtype=torch.float32, device=dev)
              for k in MODEL_INPUTS]
    targets = targets_from_batch(batch, dev)
    ccfg = CriterionConfig(group_num=model.group_num,
                           num_queries=model.num_queries,
                           num_classes=model.num_classes,
                           matcher=MatcherConfig(backend="jv"))
    dn_cfg = DNConfig(scalar=DN_GROUPS, num_classes=model.num_classes)
    gen = torch.Generator(device=dev).manual_seed(0)
    opt = make_optimizer(model, 2e-4, 1e-4)
    fixed = prepare_dn(gen, targets.labels, targets.boxes_3d, targets.valid,
                       TRAIN_QUERIES, dn_cfg)

    def dn_losses(queries, generator=None):
        model.train()
        o = model(*inputs, generator=generator, dn_queries=queries)
        if o["pred_logits"].shape[1] != TRAIN_QUERIES or \
                o["dn_outputs"][-1]["pred_logits"].shape[1] != \
                DN_GROUPS * VARIANT_OBJS:
            raise AssertionError("DN outputs of the wrong shape")
        losses = criterion(o, targets, ccfg)
        losses.update(dn_loss(o["dn_outputs"][-1], targets.labels,
                              targets.boxes_3d, targets.valid, dn_cfg))
        losses["loss_total"] = (losses["loss_total"]
                                + losses["tgt_loss_ce"]
                                + losses["tgt_loss_bbox"])
        return losses

    def dn_step():
        queries = prepare_dn(gen, targets.labels, targets.boxes_3d,
                             targets.valid, TRAIN_QUERIES, dn_cfg)
        losses = dn_losses(queries, gen)
        opt.zero_grad(set_to_none=True)
        losses["loss_total"].backward()
        grad_norm = torch.nn.utils.get_total_norm(
            [p.grad for p in model.parameters() if p.grad is not None])
        opt.step()
        vals = torch.stack([v.detach() for v in losses.values()]
                           + [grad_norm]).cpu().tolist()
        return dict(zip(list(losses) + ["grad_norm"], vals))

    runs["dn"] = run_variant(
        "dn", model, dn_step, lambda: dn_losses(fixed),
        {"msda_fwd": MSDA_PER_FORWARD, "msda_bwd": MSDA_PER_FORWARD,
         "lap_jv": LAP_PER_STEP})
    del model, opt
    torch.cuda.empty_cache()

    # the recorded launches: K1 and K2/K3 at the decoder's shapes, the
    # tall JV on the encoder matches
    fwd, bwd = {}, {}
    for name, res in runs.items():
        recs_f, recs_b = res.pop("_fwd"), res.pop("_bwd")
        q = recs_f[0][2].shape[1]
        label = f"{name} decoder Q={q}"
        fwd[label] = check_msda_recorded(label, recs_f)
        bwd[label] = check_msda_bwd_recorded(label, recs_b)
    tall = [r for res in runs.values() for r in res.pop("_tall")]
    if len(tall) != 1:
        raise AssertionError(f"{len(tall)} encoder matches recorded")
    tall_runs = {"two_stage encoder match": check_tall_jv(
        "two_stage encoder match", *tall[0])}
    torch.cuda.empty_cache()
    out.update(variants=runs,
               msda_fwd={k: {f: v.get(f) for f in (
                   "shape", "max_abs_err", "ms", "ms_launched_from_python",
                   "plain_ms", "bound_ms", "bound_by")}
                   for k, v in fwd.items()},
               msda_bwd={k: {f: v.get(f) for f in (
                   "shape", "max_abs_err", "ms", "ms_launched_from_python",
                   "plain_ms", "bound_ms", "bound_by")}
                   for k, v in bwd.items()},
               lap_jv_tall=tall_runs,
               launches={k: sum(r["launches"][k] for r in runs.values())
                         for k in ("msda_fwd", "msda_bwd", "lap_jv",
                                   "lap_jv_tall")},
               seconds=time.perf_counter() - t_phase)
    out["_fwd"], out["_bwd"], out["_tall"] = fwd, bwd, tall_runs
    return out


def mask2former_config():
    """Mask2Former on Swin-B at the JAX package's benchmark widths
    (tools/bench_models.py; facebook/mask2former-swin-base-coco-instance):
    100 queries, 80 labels, 6 encoder and 10 decoder layers, 3 levels."""
    from monosowa_tpu_torch.models.mask2former import Mask2FormerConfig
    from monosowa_tpu_torch.models.swin import SwinConfig

    return Mask2FormerConfig(backbone=SwinConfig(
        embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32),
        window_size=12))


def depth_anything_config(layers: int = 24):
    """Depth Anything Large, metric (tools/bench_models.py;
    Depth-Anything-V2-Metric-Outdoor-Large): the DINOv2-L trunk, its
    hidden states 21-24, neck (256, 512, 1024, 1024), fusion 256.  A copy
    with fewer ``layers`` takes the same widths and its last four states
    (repeated where it has fewer)."""
    from monosowa_tpu_torch.models.depth_anything import DepthAnythingConfig
    from monosowa_tpu_torch.models.dinov2 import Dinov2Config

    out = tuple(max(1, layers - 3 + i) for i in range(4))
    return DepthAnythingConfig(
        backbone=Dinov2Config(hidden_size=1024, num_hidden_layers=layers,
                              num_attention_heads=16, pos_grid=37),
        out_indices=out, neck_hidden_sizes=(256, 512, 1024, 1024),
        fusion_hidden_size=256, head_hidden_size=32,
        depth_estimation_type="metric", max_depth=80.0)


def unit_gain(tree):
    """A zoo param tree with every kernel rescaled to std 1 / sqrt(fan in)
    (a weight choice: at the initialisers' 0.02 a random Depth Anything
    answers sigmoid(0) x max_depth everywhere)."""
    import numpy as np

    if isinstance(tree, dict):
        return {k: (v / v.std() / np.sqrt(np.prod(v.shape[:-1]))).astype(
            np.float32) if k == "kernel" else unit_gain(v)
            for k, v in tree.items()}
    if isinstance(tree, list):
        return [unit_gain(v) for v in tree]
    return tree


def zoo_frames(n: int, hw=ZOO_HW) -> dict:
    """``n`` seeded uint8 RGB frames of KITTI's size: smooth gradients,
    a horizon, bright boxes and noise, by frame id."""
    import numpy as np

    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = {}
    for i in range(n):
        rng = np.random.default_rng(300 + i)
        img = np.stack([xx * 255 / w, yy * 255 / h,
                        127 + 90 * np.sin(xx / 37.0 + i)], -1)
        img[yy > h * 0.45] *= 0.5                     # the road
        for _ in range(6):
            y0, x0 = rng.integers(0, h - 80), rng.integers(0, w - 160)
            img[y0:y0 + 80, x0:x0 + 160] = rng.uniform(0, 255, 3)
        img += rng.normal(0, 12, (h, w, 3))
        frames[f"{i:06d}"] = np.clip(img, 0, 255).astype(np.uint8)
    return frames


def zoo_driver(root: str, action: str, dev, frames: dict, extra: dict):
    """The CLI driver (``sowa/cli.py`` ``KittiObjectDriver``) over a KITTI
    tree under ``root`` whose calib files are on disk and whose images are
    the in-memory ``frames``: the card's machine has no PIL to read PNGs,
    so a subclass hands them to the driver's ``_image``."""
    from monosowa_tpu_torch.config import Config, PipelineFlags
    from monosowa_tpu_torch.sowa.cli import KittiObjectDriver

    calib_dir = os.path.join(root, "kitti", "training", "calib")
    os.makedirs(calib_dir, exist_ok=True)
    p2 = "721.5377 0 609.5593 44.85728 0 721.5377 172.854 0.2163791 0 0 1 " \
         "0.002745884"
    for fid in frames:
        with open(os.path.join(calib_dir, f"{fid}.txt"), "w") as f:
            f.write("\n".join([f"P{i}: {p2}" for i in range(4)] + [
                "R0_rect: 1 0 0 0 1 0 0 0 1",
                "Tr_velo_to_cam: 1 0 0 0 0 1 0 0 0 0 1 0",
                "Tr_imu_to_velo: 1 0 0 0 0 1 0 0 0 0 1 0"]) + "\n")
    cfg = {"paths": {"kitti_path": os.path.join(root, "kitti"),
                     "merged_frames_path": os.path.join(root, "cache"),
                     "labels_path": os.path.join(root, "labels")}}
    for k, v in extra.items():
        cfg.setdefault(k, {}).update(v)

    class InMemoryImages(KittiObjectDriver):
        def frame_ids(self):
            return sorted(frames)

        def _image(self, fid):
            return frames.get(fid)

        def _image_hw(self, fid):
            return frames[fid].shape[:2]

        def _masks_frame(self, fid, backend, refine=None):
            # for the checks after
            self.mask_backend, self.refine_backend = backend, refine
            return super()._masks_frame(fid, backend, refine)

    return InMemoryImages(Config(cfg), PipelineFlags(action), device=dev)


def busy_share(fn, top: int = 6) -> dict:
    """Wall ms of fn() (ending in a synchronise), the device's kernel ms
    inside it, their ratio and the ``top`` kernels by device time, from
    ``torch.profiler``."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.device_time_total > 0), key=lambda r: -r[1])
    dev_ms = sum(r[1] for r in rows)
    return {"wall_ms": wall, "device_ms": dev_ms,
            "device_busy_share": dev_ms / wall,
            "top_kernels": [{"kernel": k[:80], "ms": t, "count": c}
                            for k, t, c in rows[:top]]}


def recording_msda(layers):
    """Swap each MSDA module's call for one that keeps a copy of its
    inputs and then calls it; returns the list and a restore function."""
    recorded = []

    def wrap(fn):
        def rec(value, shapes, loc, aw):
            recorded.append((value.detach().clone(), tuple(shapes),
                             loc.detach().clone(), aw.detach().clone()))
            return fn(value, shapes, loc, aw)
        return rec

    saved = [layer.msda for layer in layers]
    for layer in layers:
        layer.msda = wrap(layer.msda)

    def restore():
        for layer, fn in zip(layers, saved):
            layer.msda = fn
    return recorded, restore


def check_msda_recorded(label: str, recorded) -> dict:
    """The forward kernel against the plain version on the inputs of real
    launches (``recording_msda``): each within 1e-5 of its output's
    magnitude; the first one's times, bound and block map."""
    import torch

    from monosowa_tpu_torch.ops import msda

    errs = []
    for value, shapes, loc, aw in recorded:
        out_k = msda._launch_fwd(value, shapes, loc, aw)
        out_p = msda.ms_deform_attn_plain(value, shapes, loc, aw)
        torch.cuda.synchronize()
        err = float((out_k - out_p).abs().max())
        scale = float(out_p.abs().max())
        if not (torch.isfinite(out_k).all() and err <= 1e-5 * scale):
            raise AssertionError(f"msda_fwd {label}: max abs err {err} > "
                                 f"1e-5 * {scale}")
        errs.append({"max_abs_err": err, "max_abs_out": scale})
    value, shapes, loc, aw = recorded[0]
    worst = max(errs, key=lambda e: e["max_abs_err"] / e["max_abs_out"])
    return msda_report(
        label, loc.shape[1], value, loc,
        {**worst, "launches_checked": len(recorded)},
        lambda: msda.ms_deform_attn(value, shapes, loc, aw),
        lambda: msda.ms_deform_attn_plain(value, shapes, loc, aw),
        msda_bound(value, loc, 4 * (loc.numel() + aw.numel()
                                    + loc.shape[0] * loc.shape[1]
                                    * value.shape[2] * value.shape[3]), 1,
                   shapes), 1, shapes)


def kept_masks(classes, logits, ids, thr, hw):
    """The backend's rule on one forward's outputs: per kept query (in
    index order) its probability, its logits at the image's size and its
    mask."""
    import torch

    from monosowa_tpu_torch.ops.resize import cv2_resize_linear

    prob = torch.softmax(classes.float(), -1)[:, :-1][:, list(ids)].max(-1)
    prob = prob.values
    keep = torch.nonzero(prob > thr)[:, 0]
    full = cv2_resize_linear(logits[keep].permute(1, 2, 0).contiguous(), hw)
    full = full.permute(2, 0, 1)
    out = {}
    for q, f in zip(keep.tolist(), full):
        if bool((f > 0).any()):
            out[q] = (float(prob[q]), f)
    return prob, out


def decoder_forward(backend, image, att_in=None):
    """The backend's forward on one frame -> (class logits, mask logits,
    the decoder's attention masks layer by layer); with ``att_in`` the
    decoder takes those masks in place of its own (a forward hook replaces
    each prediction's mask)."""
    seen = []

    def hook(_mod, _args, out):
        seen.append(out[1])
        if att_in is not None:
            return out[0], att_in[len(seen) - 1]

    pred = backend.model.transformer.mask_predictor
    handle = pred.register_forward_hook(hook)
    try:
        cls, logits = backend.forward(image)
    finally:
        handle.remove()
    return cls, logits, seen


def masks(dev, root: str, frames: dict) -> dict:
    """Mask2Former Swin-B at full width from seeded weights through the
    driver's ``mask_tracking`` (a zoo checkpoint written by the port's
    ``save_checkpoint``, loaded by ``zoo.mask_backend``), held against the
    same forward with the plain MSDA."""
    import numpy as np
    import torch

    from monosowa_tpu_torch.convert import zoo_params
    from monosowa_tpu_torch.models.mask2former import Mask2Former
    from monosowa_tpu_torch.ops import msda
    from monosowa_tpu_torch.ops.resize import cv2_resize_linear
    from monosowa_tpu_torch.sowa import masks as masks_mod
    from monosowa_tpu_torch.sowa import zoo
    from monosowa_tpu_torch.sowa.masks import Mask2FormerBackend

    cfg = mask2former_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Mask2Former(cfg, device=dev, seed=0)
    build_s = time.perf_counter() - t0
    fids = sorted(frames)
    # the car label's class bias (a weight choice): random weights give
    # every query about 1 / 81 of each label; the median query of the first
    # frame reaches 0.7
    img = cv2_resize_linear(torch.tensor(frames[fids[0]], device=dev),
                            MASK_INPUT_HW).float() / 255.0
    mean, std = (torch.tensor(v, device=dev) for v in (
        Mask2FormerBackend.IMAGENET01_MEAN, Mask2FormerBackend.IMAGENET01_STD))
    with torch.no_grad():
        logits = model(((img - mean) / std)[None])[0][0].double()
    others = torch.cat([logits[:, :CAR_LABEL], logits[:, CAR_LABEL + 1:]], 1)
    need = np.log(0.7 / 0.3) + torch.logsumexp(others, 1) \
        - logits[:, CAR_LABEL]
    car_bias = float(need.median())
    with torch.no_grad():
        model.transformer.class_predictor.bias[CAR_LABEL] += car_bias
    t0 = time.perf_counter()
    ckpt = os.path.join(root, "zoo", "mask2former.npz")
    zoo.save_checkpoint(ckpt, "mask2former", zoo_params(model), cfg)
    save_s = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()

    # the main path: the driver's mask_tracking over the frames
    driver = zoo_driver(root, "mask_tracking", dev, frames, {
        "backends": {"mask": "mask2former", "mask_checkpoint": ckpt,
                     "mask_input_hw": list(MASK_INPUT_HW)}})
    msda.launches = msda.launches_bf16 = 0
    t0 = time.perf_counter()
    written = driver.run(None, None)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = msda.launches
    # one launch per encoder layer of the pixel decoder and frame
    if written != len(frames) or launches != cfg.encoder_layers \
            * len(frames) or msda.launches_bf16:
        raise AssertionError(f"mask_tracking wrote {written} frames with "
                             f"{launches} MSDA launches")
    backend = driver.mask_backend
    layers = list(backend.model.pixel_decoder.encoder_layers)
    thr = backend.score_threshold
    files = {fid: masks_mod.load_masks(driver.masks_dir, fid)
             for fid in fids}

    # steady state: the same driver into a fresh cache, then the forward
    driver.cache = os.path.join(root, "cache_timed")
    t0 = time.perf_counter()
    for fid in fids:
        driver._masks_frame(fid, backend)
    torch.cuda.synchronize()
    ms_per_frame = (time.perf_counter() - t0) * 1e3 / len(fids)
    t0 = time.perf_counter()
    for fid in fids:
        backend.predict_masks_scores(frames[fid])
    predict_ms = (time.perf_counter() - t0) * 1e3 / len(fids)
    t0 = time.perf_counter()
    for fid in fids:
        backend.forward(frames[fid])
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3 / len(fids)
    driver.cache = os.path.join(root, "cache_profiled")
    prof = busy_share(lambda: driver._masks_frame(fids[0], backend))
    peak = torch.cuda.max_memory_allocated()

    # the same forwards with the plain MSDA.  The decoder binarises its
    # attention masks at a logit of 0, so a last-bit difference can flip an
    # entry that every later layer inherits: the kernel is held on the plain
    # forward's masks (the same discrete decisions), and the free-running
    # forwards, the written masks among them, on the whole-forward bar
    hw = frames[fids[0]].shape[:2]
    worst = {"class_logits": 0.0, "mask_logits": 0.0}
    free = dict(worst)
    att_flips, flips, kept, near_thr = 0, 0, [], 0
    for fid in fids:
        cls_k, log_k, att_k = decoder_forward(backend, frames[fid])
        for layer in layers:
            layer.msda = msda.ms_deform_attn_plain
        cls_p, log_p, att_p = decoder_forward(backend, frames[fid])
        for layer in layers:
            layer.msda = msda.ms_deform_attn
        cls_s, log_s, _ = decoder_forward(backend, frames[fid], att_p)
        att_flips += sum(int((a != b).sum()) for a, b in zip(att_k, att_p))
        for name, a, b, c in (("class_logits", cls_s, cls_p, cls_k),
                              ("mask_logits", log_s, log_p, log_k)):
            scale = float(b.abs().max())
            worst[name] = max(worst[name], float((a - b).abs().max())
                              / scale)
            free[name] = max(free[name], float((c - b).abs().max()) / scale)
        prob_k, out_k = kept_masks(cls_k, log_k, backend.car_label_ids, thr,
                                   hw)
        prob_p, out_p = kept_masks(cls_p, log_p, backend.car_label_ids, thr,
                                   hw)
        got = files[fid]
        if len(got) != len(out_k) or any(
                not np.array_equal(g, (f > 0).cpu().numpy())
                for g, (_, f) in zip(got, out_k.values())):
            raise AssertionError(f"masks_raw/{fid} is not the kernel "
                                 "forward's masks")
        kept.append(len(got))
        bar = WHOLE_FORWARD_BAR * float(log_p.abs().max())
        for q in set(out_k) ^ set(out_p):
            # a query kept by one forward only: its probability at the
            # threshold
            if abs(float(prob_p[q]) - thr) > WHOLE_FORWARD_BAR:
                raise AssertionError(f"{fid}: query {q} kept by one "
                                     "forward only")
            near_thr += 1
        for q in set(out_k) & set(out_p):
            fk, fp = out_k[q][1], out_p[q][1]
            diff = (fk > 0) != (fp > 0)
            flips += int(diff.sum())
            if bool((fp[diff].abs() > bar).any()):
                raise AssertionError(f"{fid}: query {q}'s mask differs "
                                     f"where |logit| > {bar}")
    if max(worst.values()) > MASK_LOGIT_BAR or \
            max(free.values()) > WHOLE_FORWARD_BAR:
        raise AssertionError(f"kernel vs plain MSDA forward: {worst} on the "
                             f"plain forward's masks, {free} free")
    if not 0 < sum(kept) < cfg.num_queries * len(fids):
        raise AssertionError(f"queries kept a frame: {kept}")

    # K1 alone on the inputs of the pixel decoder's six launches
    recorded, restore = recording_msda(layers)
    backend.forward(frames[fids[0]])
    restore()
    k1 = check_msda_recorded("pixel decoder", recorded)
    del recorded
    out = {"phase": "masks", "model": "mask2former swin-b (seeded weights)",
           "frames": len(fids), "image_hw": list(hw),
           "input_hw": list(MASK_INPUT_HW), "model_build_s": build_s,
           "checkpoint_save_s": save_s, "car_label_bias": car_bias,
           "mask_tracking_s": run_s, "msda_launches": launches,
           "msda_launches_per_frame": launches / len(fids),
           "mask_ms_per_frame": ms_per_frame, "predict_ms": predict_ms,
           "forward_ms": fwd_ms,
           **{k: prof[k] for k in ("device_ms", "device_busy_share",
                                   "top_kernels")},
           "profiled_frame_wall_ms": prof["wall_ms"],
           "peak_mem_GB": peak / 1e9, "queries_kept": kept,
           "kernel_vs_plain_forward_max_rel": worst,
           "kernel_vs_plain_free_forward_max_rel": free,
           "attention_entries_flipped": att_flips,
           "mask_pixels_flipped": flips,
           "queries_at_threshold": near_thr,
           "pixel_decoder_k1": k1}
    del backend, driver
    torch.cuda.empty_cache()
    return out


def depth(dev, root: str, frames: dict) -> dict:
    """Depth Anything Large at full width from seeded weights through the
    driver's ``lidar_scans`` (a zoo checkpoint, ``zoo.depth_backend``);
    a 2-layer copy on the card against the same weights on the CPU."""
    import numpy as np
    import torch

    from monosowa_tpu_torch.convert import load_zoo_params, zoo_params
    from monosowa_tpu_torch.models.depth_anything import DepthAnything
    from monosowa_tpu_torch.sowa import depth as depth_mod
    from monosowa_tpu_torch.sowa import zoo

    cfg = depth_anything_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = DepthAnything(cfg, device=dev, seed=0)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt = os.path.join(root, "zoo", "depth_anything.npz")
    zoo.save_checkpoint(ckpt, "depth_anything", unit_gain(zoo_params(model)),
                        cfg)
    save_s = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()

    fids = sorted(frames)[:DEPTH_FRAMES]
    sub = {fid: frames[fid] for fid in fids}
    driver = zoo_driver(root, "lidar_scans", dev, sub, {
        "backends": {"depth": "depth_anything", "depth_checkpoint": ckpt,
                     "depth_input_size": DEPTH_INPUT_SIZE}})
    t0 = time.perf_counter()
    written = driver.run(None, None)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    if written != len(fids):
        raise AssertionError(f"lidar_scans wrote {written} frames")
    backend = driver._depth_backend()
    npts = []
    for fid in fids:
        pts = depth_mod.load_pseudo_lidar(os.path.join(driver.pcd_dir,
                                                       f"{fid}.npz"))
        if pts is None or pts.ndim != 2 or pts.shape[1] != 3 or \
                not len(pts) or not np.isfinite(pts).all():
            raise AssertionError(f"lidar_raw/{fid}.npz: "
                             f"{None if pts is None else pts.shape}")
        npts.append(len(pts))
    metric = backend.predict_metric_depth(frames[fids[0]])
    if metric.shape != frames[fids[0]].shape[:2] or \
            not np.isfinite(metric).all() or metric.min() < 0 or \
            metric.max() > cfg.max_depth:
        raise AssertionError(f"depth {metric.shape} in [{metric.min()}, "
                             f"{metric.max()}]")
    # steady state: the same driver into a fresh cache, then the forward
    driver.cache = os.path.join(root, "cache_timed")
    t0 = time.perf_counter()
    for fid in fids:
        driver._lidar_frame(fid)
    torch.cuda.synchronize()
    ms_per_frame = (time.perf_counter() - t0) * 1e3 / len(fids)
    t0 = time.perf_counter()
    for fid in fids:
        backend.predict_depth(frames[fid])
    predict_ms = (time.perf_counter() - t0) * 1e3 / len(fids)
    x = backend._encode(frames[fids[0]])[None]
    t0 = time.perf_counter()
    with torch.no_grad():
        backend.model(x)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    prof = busy_share(lambda: backend.predict_depth(frames[fids[0]]))
    peak = torch.cuda.max_memory_allocated()
    input_hw = list(x.shape[1:3])
    del backend, driver
    torch.cuda.empty_cache()

    # a 2-layer copy: the card against the CPU, same weights, same input
    small = depth_anything_config(2)
    tree = unit_gain(zoo_params(DepthAnything(small, device="cpu",
                                              seed=1)))
    card = load_zoo_params(DepthAnything(small, device=dev), tree)
    host = load_zoo_params(DepthAnything(small, device="cpu"), tree)
    with torch.no_grad():
        d_card = card(x)[0].cpu()
        d_host = host(x.cpu())[0]
    err = float((d_card - d_host).abs().max())
    if err > DEPTH_CPU_BAR * small.max_depth or float(d_host.std()) < 1.0:
        raise AssertionError(f"2-layer depth card vs CPU: {err}")
    del card, host
    torch.cuda.empty_cache()
    return {"phase": "depth", "model": "depth anything large (seeded "
            "weights)", "frames": len(fids), "image_hw":
            list(frames[fids[0]].shape[:2]), "input_hw": input_hw,
            "model_build_s": build_s, "checkpoint_save_s": save_s,
            "lidar_scans_s": run_s, "points_per_frame": npts,
            "depth_ms_per_frame": ms_per_frame, "predict_ms": predict_ms,
            "forward_ms": fwd_ms,
            **{k: prof[k] for k in ("device_ms", "device_busy_share",
                                    "top_kernels")},
            "profiled_frame_wall_ms": prof["wall_ms"],
            "peak_mem_GB": peak / 1e9,
            "depth_range_m": [float(metric.min()), float(metric.max())],
            "two_layer_card_vs_cpu_max_abs_m": err,
            "two_layer_depth_std_m": float(d_host.std())}


def images_to_labels(dev, root: str, frames: dict) -> dict:
    """The driver's ``optimization`` over the caches ``masks`` and
    ``depth`` wrote (``masks_raw/``, ``lidar_raw/``), for the frames that
    have both: label files written (their content is not judged: the
    networks' weights are random)."""
    import torch

    from monosowa_tpu_torch.ops import tfl

    fids = sorted(frames)[:DEPTH_FRAMES]
    sub = {fid: frames[fid] for fid in fids}
    driver = zoo_driver(root, "optimization", dev, sub, {
        "frames_creation": {"nscans_before": 0, "nscans_after": 0}})
    tfl.launches = 0
    t0 = time.perf_counter()
    written = driver.run(None, None)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    files = sorted(os.listdir(driver.labels_path))
    if written != len(fids) or files != [f"{fid}.txt" for fid in fids]:
        raise AssertionError(f"optimization wrote {written}: {files}")
    rows = [sum(1 for _ in open(os.path.join(driver.labels_path, f)))
            for f in files]
    return {"phase": "images_to_labels", "frames": len(fids),
            "label_files": files, "label_rows": rows,
            "optimization_s": run_s, "tfl_launches": tfl.launches}


def sam_encoder_work(cfg) -> dict:
    """Floating-point operations of SAM's image encoder at its input size
    (2 a multiply-add of every matrix product and convolution: patch
    embedding, qkv and output projections over the padded windows, the
    MLPs, q k^T and p v, the relative-position einsums, the neck) and the
    bytes it must move (its weights read once, the image in, the
    embedding out)."""
    v = cfg.vision
    g, c = v.grid, v.hidden_size
    heads = v.num_attention_heads
    d, n = c // heads, g * g
    flops = 2 * n * v.patch_size ** 2 * 3 * c
    params = v.patch_size ** 2 * 3 * c + c + n * c
    for i in range(v.num_hidden_layers):
        if i in tuple(v.global_attn_indexes):
            units, side = 1, g
        else:
            side = v.window_size
            units = (-(-g // side)) ** 2
        t = units * side * side
        flops += 2 * t * c * 4 * c + 2 * n * c * 2 * v.mlp_dim
        flops += units * heads * 2 * 2 * (side * side) ** 2 * d
        flops += units * heads * 2 * 2 * side ** 3 * d
        params += 4 * c * c + 2 * c * v.mlp_dim + 2 * (2 * side - 1) * d \
            + 4 * c + c * 3 + v.mlp_dim + c
    out = v.output_channels
    flops += 2 * n * c * out + 2 * n * out * out * 9
    params += c * out + out * out * 9 + 4 * out
    nbytes = 4 * (params + v.image_size ** 2 * 3 + n * out)
    return {"flop": flops, "bytes": nbytes,
            "bound_ms": max(flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)
            * 1e3, "bound_by": "operations" if flops / FP32_FLOPS
            > nbytes / HBM_BYTES_PER_S else "bytes"}


def eligible_boxes(masks, scores):
    """refine_masks' rule: the indices of the masks above its score
    threshold that hold a pixel, and their boxes."""
    import numpy as np

    from monosowa_tpu_torch.sowa.masks import mask_box

    idx = [i for i, s in enumerate(scores)
           if s > SAM_SCORE and np.any(masks[i])]
    boxes = (np.stack([mask_box(masks[i]) for i in idx]) if idx
             else np.zeros((0, 4), np.int64))
    return idx, boxes


def mask_frame_spans(driver, fids, backend, refine, cache: str,
                     dev) -> dict:
    """``driver._masks_frame`` over the frames into a fresh ``cache``:
    ms a frame on the host's clock in all and in its parts, the
    detector's call (forward, the kept masks resized, copied and
    tested), ``refine_masks`` (SAM; 0 without ``refine``) and within it
    ``mask_box`` (the eligible masks' boxes), ``save_masks`` (masks_raw/
    and pedestrians/), the rest (the image read); then, alone, the
    device-to-host copy of as many frame-sized bool masks as the frame
    wrote, in the detector's layout."""
    import torch

    from monosowa_tpu_torch.sowa import masks as masks_mod

    spans = {"detector": 0.0, "refine": 0.0, "mask_box": 0.0,
             "save_masks": 0.0}

    def timed(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            spans[name] += time.perf_counter() - t0
            return out
        return call

    saved = (masks_mod.refine_masks, masks_mod.save_masks,
             masks_mod.mask_box)
    backend.predict_masks_multi = timed("detector",
                                        backend.predict_masks_multi)
    masks_mod.refine_masks = timed("refine", saved[0])
    masks_mod.save_masks = timed("save_masks", saved[1])
    masks_mod.mask_box = timed("mask_box", saved[2])
    driver.cache = cache
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for fid in fids:
            driver._masks_frame(fid, backend, refine)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        del backend.predict_masks_multi
        (masks_mod.refine_masks, masks_mod.save_masks,
         masks_mod.mask_box) = saved
    n_masks, copy_s = 0, 0.0
    for fid in fids:
        n = sum(len(masks_mod.load_masks(d, fid) or ()) for d in (
            driver.masks_dir, os.path.join(cache, "pedestrians")))
        h, w = driver._image(fid).shape[:2]
        x = torch.zeros((h, w, n), dtype=torch.bool, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x.permute(2, 0, 1).cpu().numpy()
        copy_s += time.perf_counter() - t0
        n_masks += n
    out = {k + "_ms": v * 1e3 / len(fids) for k, v in spans.items()}
    out["other_ms"] = (total - spans["detector"] - spans["refine"]
                       - spans["save_masks"]) * 1e3 / len(fids)
    return {"ms_per_frame": total * 1e3 / len(fids), **out,
            "masks_written_per_frame": n_masks / len(fids),
            "copy_alone_ms": copy_s * 1e3 / len(fids)}


def sam(dev, root: str, frames: dict) -> dict:
    """SAM ViT-H at full width from seeded weights (kernels at unit gain)
    behind ``use_SAM``: a zoo checkpoint written by the port's
    ``save_checkpoint``, loaded by ``zoo.sam_refine_backend`` from
    ``paths.sam_path``, through the driver's ``mask_tracking`` with
    ``extract_pedestrians`` and the masks phase's Mask2Former checkpoint.
    Holds: (a) a 2-layer copy (layer 1 global) on the card against the
    CPU; (b) the full depth in float32 against float64 on the card, the
    written masks equal where the float64 logit clears the bar; (c) every
    eligible mask replaced by SAM's, the others (kept from 0.5) byte for
    byte the detector's, the files reload; (d) K1 at the pixel decoder
    against the plain MSDA."""
    import copy

    import numpy as np
    import torch

    from monosowa_tpu_torch.convert import load_zoo_params, zoo_params
    from monosowa_tpu_torch.models.sam import Sam, vit_h
    from monosowa_tpu_torch.ops import msda
    from monosowa_tpu_torch.ops.resize import (cv2_resize_linear,
                                               resize_bilinear_torch)
    from monosowa_tpu_torch.sowa import masks as masks_mod
    from monosowa_tpu_torch.sowa import zoo

    cfg = vit_h()
    t0 = time.perf_counter()
    tree = unit_gain(zoo_params(Sam(cfg, device="cpu", seed=0)))
    build_s = time.perf_counter() - t0
    n_params = sum(a.size for a in zoo.flatten_params(tree).values())
    t0 = time.perf_counter()
    ckpt = os.path.join(root, "zoo", "sam_vit_h.npz")
    zoo.save_checkpoint(ckpt, "sam", tree, cfg)
    save_s = time.perf_counter() - t0
    del tree

    # the main path: mask_tracking with use_SAM over the frames
    fids = sorted(frames)
    driver = zoo_driver(root, "mask_tracking", dev, frames, {
        "backends": {"mask": "mask2former",
                     "mask_checkpoint": os.path.join(root, "zoo",
                                                     "mask2former.npz"),
                     "mask_input_hw": list(MASK_INPUT_HW)},
        "paths": {"sam_path": ckpt},
        # the detector keeps queries from 0.5, SAM refines those above 0.7
        "filtering": {"score_detectron_thresh": SAM_DETECTOR_SCORE},
        "frames_creation": {"use_SAM": True, "extract_pedestrians": True}})
    driver.cache = os.path.join(root, "cache_sam")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    msda.launches = msda.launches_bf16 = 0
    t0 = time.perf_counter()
    written = driver.run(None, None)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = msda.launches
    peak_run = torch.cuda.max_memory_allocated()
    if written != len(frames) or launches != MSDA_PER_FORWARD * len(frames) \
            or msda.launches_bf16:
        raise AssertionError(f"mask_tracking with SAM wrote {written} "
                             f"frames with {launches} MSDA launches")
    backend, refine = driver.mask_backend, driver.refine_backend
    model = refine.model
    if not isinstance(refine, masks_mod.SamRefineBackend) or \
            refine.device != dev or refine.cfg != cfg:
        raise AssertionError(f"refine backend {refine}")

    # (c) per frame: the detector's masks again, each eligible one
    # replaced by SAM's refinement, the others byte for byte; the files
    # reload, the person group's too
    per_frame, boxes_of, idx_of = [], {}, {}
    for fid in fids:
        raw, scores = backend.predict_masks_scores(frames[fid])
        idx, boxes = eligible_boxes(raw, scores)
        boxes_of[fid], idx_of[fid] = boxes, idx
        got = masks_mod.load_masks(driver.masks_dir, fid)
        peds = masks_mod.load_masks(os.path.join(driver.cache,
                                                 "pedestrians"), fid)
        if got is None or peds is None or len(got) != len(raw):
            raise AssertionError(f"{fid}: masks_raw / pedestrians files")
        want = refine.refine(frames[fid], boxes)
        changed = 0
        for i, m in enumerate(raw):
            ref = want[idx.index(i)] if i in idx else m
            if not np.array_equal(got[i], ref):
                raise AssertionError(f"masks_raw/{fid} mask {i} is not "
                                     + ("SAM's" if i in idx else
                                        "the detector's"))
            changed += i in idx and not np.array_equal(ref, m)
        per_frame.append({"masks": len(raw), "eligible": len(idx),
                          "changed_by_sam": changed,
                          "passed_through": len(raw) - len(idx),
                          "persons": len(peds)})
    if not all(sum(f[k] for f in per_frame) for k in (
            "eligible", "changed_by_sam", "passed_through")):
        raise AssertionError(f"refined and passed-through masks: "
                             f"{per_frame}")

    # timings on the boxes of the frame with the most: the encoder, the
    # decoder a chunk of max_boxes, refine a frame, a mask frame with SAM
    fid0 = max(fids, key=lambda f: len(idx_of[f]))
    img0, boxes0 = frames[fid0], boxes_of[fid0]
    padded, (nh, nw), scale = refine._encode(img0)
    chunk = torch.from_numpy(np.resize(boxes0, (refine.max_boxes, 4))
                             .astype(np.float32) * scale).to(dev)[None]
    with torch.no_grad():
        emb = model.vision_forward(padded[None])
        enc_ms = cuda_ms(lambda: model.vision_forward(padded[None]), 5, 1)
        dec_ms = cuda_ms(lambda: model.decode_boxes(emb, chunk), 10)
    t0 = time.perf_counter()
    for fid in fids:
        refine.refine(frames[fid], boxes_of[fid])
    sam_ms = (time.perf_counter() - t0) * 1e3 / len(fids)
    # the same frames and threshold without SAM, then with it
    without_sam = mask_frame_spans(driver, fids, backend, None,
                                   os.path.join(root, "cache_no_sam"), dev)
    with_sam = mask_frame_spans(driver, fids, backend, refine,
                                os.path.join(root, "cache_sam_timed"), dev)
    driver.cache = os.path.join(root, "cache_sam_profiled")
    prof = busy_share(lambda: driver._masks_frame(fids[0], backend,
                                                  refine), top=10)
    work = sam_encoder_work(cfg)

    # (b) the full depth, float32 against float64 on the card, that
    # frame's boxes: embedding, low-res logits, iou; then the written
    # masks against the float64 logits through the same post-processing
    with torch.no_grad():
        low32, iou32 = refine.decode(emb, boxes0, scale)
        m64 = copy.deepcopy(model).double()
        emb64 = m64.vision_forward(padded.double()[None])
        lows, ious = [], []
        for c0 in range(0, len(boxes0), refine.max_boxes):
            b = torch.from_numpy(np.asarray(
                boxes0[c0:c0 + refine.max_boxes], np.float32) * scale)
            lo, io = m64.decode_boxes(emb64, b.to(dev).double()[None])
            lows.append(lo[0, :, 0])
            ious.append(io[0, :, 0])
        low64, iou64 = torch.cat(lows), torch.cat(ious)
        del m64
        rel64 = {}
        for name, a, b in (("embedding", emb, emb64),
                           ("low_res_logits", low32, low64),
                           ("iou", iou32, iou64)):
            rel64[name] = float((a.double() - b).abs().max()
                                / b.abs().max())
        s = cfg.vision.image_size
        up = resize_bilinear_torch(low64.float()[..., None], (s, s))
        full64 = cv2_resize_linear(up[:, :nh, :nw, 0].permute(1, 2, 0)
                                   .contiguous(), img0.shape[:2])
        full64 = full64.permute(2, 0, 1)
    del emb64, low64
    bar = SAM_F64_BAR * float(full64.abs().max())
    got0 = masks_mod.load_masks(os.path.join(root, "cache_sam", "masks_raw"),
                                fid0)
    flips = 0
    for j, i in enumerate(idx_of[fid0]):
        diff = torch.from_numpy(got0[i]).to(dev) != (full64[j] > 0)
        flips += int(diff.sum())
        if bool((full64[j][diff].abs() > bar).any()):
            raise AssertionError(f"a written SAM mask differs from the "
                                 f"float64 forward where |logit| > {bar}")
    if max(rel64.values()) > SAM_F64_BAR:
        raise AssertionError(f"SAM float32 vs float64: {rel64}")
    del full64
    torch.cuda.empty_cache()

    # (a) a 2-layer copy at full width (layer 1 global): card vs CPU on
    # that frame's boxes (one chunk)
    small = dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, num_hidden_layers=2, global_attn_indexes=(1,)))
    tree2 = unit_gain(zoo_params(Sam(small, device="cpu", seed=1)))
    x = padded[None]
    b = torch.from_numpy(np.asarray(boxes0[:refine.max_boxes], np.float32)
                         * scale)[None]
    outs = []
    t0 = time.perf_counter()
    for where in (dev, "cpu"):
        m2 = load_zoo_params(Sam(small, device=where), tree2)
        with torch.no_grad():
            outs.append([t.cpu() for t in m2.predict_boxes(x.to(where),
                                                           b.to(where))])
        del m2
    cpu_pair_s = time.perf_counter() - t0
    rel_cpu = {name: float((c - h).abs().max() / h.abs().max())
               for name, c, h in zip(("low_res_logits", "iou"), *outs)}
    scale_cpu = float(outs[1][0].abs().max())
    if max(rel_cpu.values()) > SAM_CPU_BAR or scale_cpu < 1e-2:
        raise AssertionError(f"2-layer SAM card vs CPU: {rel_cpu}, "
                             f"logits up to {scale_cpu}")
    del outs
    torch.cuda.empty_cache()

    # (d) K1 on the inputs of the pixel decoder's six launches
    recorded, restore = recording_msda(
        list(backend.model.pixel_decoder.encoder_layers))
    backend.forward(img0)
    restore()
    k1 = check_msda_recorded("pixel decoder (sam phase)", recorded)
    del recorded
    out = {"phase": "sam", "model": "sam vit-h (seeded weights, unit gain)",
           "params": n_params, "frames": len(fids),
           "image_hw": list(img0.shape[:2]),
           "sam_input": [cfg.vision.image_size] * 2,
           "resized_hw": [nh, nw], "model_build_s": build_s,
           "checkpoint_save_s": save_s, "mask_tracking_s": run_s,
           "msda_launches": launches, "per_frame": per_frame,
           "encoder_ms": enc_ms, "encoder_bound_ms": work["bound_ms"],
           "encoder_bound_by": work["bound_by"],
           "encoder_tflop": work["flop"] / 1e12,
           "encoder_tflops_achieved": work["flop"] / enc_ms / 1e9,
           "decoder_ms_per_chunk": dec_ms, "chunk_boxes": refine.max_boxes,
           "sam_ms_per_frame": sam_ms,
           "mask_ms_per_frame": with_sam["ms_per_frame"],
           "mask_frame_with_sam": with_sam,
           "mask_frame_without_sam": without_sam,
           **{k: prof[k] for k in ("device_ms", "device_busy_share",
                                   "top_kernels")},
           "profiled_frame_wall_ms": prof["wall_ms"],
           "peak_mem_GB": peak_run / 1e9,
           "peak_mem_GB_with_holds": torch.cuda.max_memory_allocated() / 1e9,
           "float32_vs_float64_max_rel": rel64,
           "mask_pixels_flipped_vs_float64": flips,
           "two_layer_card_vs_cpu_max_rel": rel_cpu,
           "two_layer_logit_scale": scale_cpu,
           "two_layer_card_and_cpu_s": cpu_pair_s,
           "pixel_decoder_k1": k1}
    del backend, refine, driver, model, emb
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# waymo: raw Waymo segments through the CLI's WaymoSegmentDriver
# ---------------------------------------------------------------------------

WAYMO_FRAMES = 6
WAYMO_F = 2000.0             # the FRONT camera's focal length, px at 1920
WAYMO_EGO_STEP = 0.5         # ego motion a frame, m along the vehicle's +x
# camera-frame poses at the reference frame; "step": m a frame along +x of
# the vehicle (the moving car drives ahead of the ego)
WAYMO_CARS = ({"x": 1.0, "y": 0.9, "z": 14.0, "theta": 0.6, "step": 0.0},
              {"x": -4.5, "y": 0.9, "z": 20.0, "theta": 0.1, "step": 1.2})
WAYMO_GROUND = 60000         # ground points drawn a camera and scan
# yaw of each camera slot about the vehicle's up axis (SIDE_LEFT,
# FRONT_LEFT, FRONT, FRONT_RIGHT, SIDE_RIGHT)
WAYMO_CAM_YAW = (90.0, 45.0, 0.0, -45.0, -90.0)
# the window run: the shipped config's +-30 scans (configs/sowa_kitti.yaml)
# over a segment of 61 frames, its motion a tenth of the segment's, so that
# both cars stay in view over the whole window
WAYMO_WINDOW = 30
WAYMO_WINDOW_MOTION = 0.1
WAYMO_MATCHES, WAYMO_OUTLIERS = 240, 0.3
WAYMO_KEPT = 3               # Mask2Former queries kept a canvas
WAYMO_CUT_GRID = {"opt_param1_iters": 11, "opt_param2_iters": 11,
                  "opt_param3_iters": 8, "opt_fine_iters": 36}
WAYMO_CAR_BAR = 0.35         # m, tests/test_waymo2d_e2e.py's
LOFTR_INPUT_HW = (480, 640)  # the backend's default (sowa/stitching.py)
LOFTR_CUT_LAYERS = 2
LOFTR_CPU_BAR = 1e-4         # card vs CPU at the cut depth, of max abs
LOFTR_F64_BAR = 1e-3         # float32 vs float64 at full depth
# the checks' match threshold: random weights match nothing above the
# shipped 0.2 (tests/test_torch_efficientloftr.py's)
LOFTR_CHECK_THRESHOLD = 1e-6
# and on a pair that shares content: the FRONT image beside itself moved
# this many columns (the segment's cameras are independent noise, whose
# pairs match nothing)
LOFTR_CHECK_SHIFT = 64
LOFTR_KP_BAR = 1e-5          # keypoints, of the image size
LOFTR_FLIP_SHARE = 0.01      # flipped matches or keypoints, of the cells
TRACKER_CPU_BAR = 1e-4
TRACKER_TIMED_STEPS = 20


def waymo_homographies(layout):
    """The true homography of each pair: the warped camera beside its
    fixed partner with an overlap of 1/15 of the width, a small shear and
    perspective."""
    import numpy as np

    cw, y0 = layout.cam_w, layout.paste_y0
    right_x0 = layout.canvas_hw[1] - cw
    out = []
    for z in range(4):
        h = np.eye(3)
        h[0, 2] = right_x0 - cw + cw // 15 if z < 2 else cw - cw // 15
        h[1, 2] = y0 + 0.02 * layout.cam_h
        h[0, 1], h[1, 0] = 0.01, -0.008
        h[2, 0] = (2e-5 if z < 2 else -2e-5) * 1920 / cw
        out.append(h)
    return out


def car_mask(u, v, h: int, w: int, cell: int = 8):
    """A car's mask from its projected points: the cells of ``cell``
    pixels they fall in, dilated once and filled."""
    import numpy as np
    import scipy.ndimage

    g = np.zeros((h // cell + 1, w // cell + 1), bool)
    g[(v // cell).astype(int), (u // cell).astype(int)] = True
    g = scipy.ndimage.binary_fill_holes(scipy.ndimage.binary_dilation(g))
    return np.repeat(np.repeat(g, cell, 0), cell, 1)[:h, :w]


def side_ground(rng, layout, ground: int, cam2veh, f: float):
    """Ground points in the view of the four cameras other than FRONT as
    fused-scan rows (vehicle xyz, the camera's id, u, v): drawn in a
    camera frame like FRONT's, turned by the slot's ``WAYMO_CAM_YAW``."""
    import numpy as np

    from monosowa_tpu_torch.sowa.waymo2d import CAM_SLOT_TO_WAYMO_ID

    rows = []
    for slot in (0, 1, 3, 4):
        h = layout.side_h if slot in (0, 4) else layout.cam_h
        g = np.stack([rng.uniform(-15, 15, ground), np.full(ground, 1.66),
                      rng.uniform(4, 60, ground)], 1)
        u = f * g[:, 0] / g[:, 2] + layout.cam_w / 2
        v = f * g[:, 1] / g[:, 2] + h / 2
        vis = (u >= 0) & (u < layout.cam_w) & (v >= 0) & (v < h)
        yaw = np.radians(WAYMO_CAM_YAW[slot])
        rot = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                        [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
        xyz = g[vis] @ cam2veh[:3, :3].T @ rot.T
        n = int(vis.sum())
        rows.append(np.concatenate([
            xyz, np.full((n, 1), CAM_SLOT_TO_WAYMO_ID[slot]),
            np.stack([u[vis], v[vis]], 1)], 1))
    return np.concatenate(rows)


def waymo_scene(layout, n_frames: int = WAYMO_FRAMES, ground: int =
                WAYMO_GROUND, seed: int = 0, motion: float = 1.0) -> dict:
    """A seeded segment at ``layout``'s sizes: 5 cameras of noise (side
    cameras ``side_h`` rows), the two ``WAYMO_CARS`` (the template bank's
    car) painted in the FRONT camera where their points project, their
    masks on pair canvases 1 and 2 (the FRONT camera is the fixed slot of
    both), a fused scan (vehicle xyz, camera id, u, v) of the cars and the
    ground in the FRONT camera's view and of the ground in the other four
    cameras', ego poses along +x; ``motion`` scales the ego's and the
    cars' steps."""
    import numpy as np

    from monosowa_tpu_torch.sowa.templates import TemplateBank
    from monosowa_tpu_torch.sowa.waymo2d import VEHICLE_TO_CAM

    rng = np.random.default_rng(seed)
    pts = TemplateBank.default().points[0]
    ref = n_frames // 2
    h, w = layout.cam_h, layout.cam_w
    f = WAYMO_F * w / 1920.0
    cam2veh = np.linalg.inv(VEHICLE_TO_CAM)
    cars = []
    for c in WAYMO_CARS:
        ct, st = np.cos(c["theta"]), np.sin(c["theta"])
        rot = np.array([[ct, 0, st], [0, 1, 0], [-st, 0, ct]])
        cars.append((pts @ rot.T + [c["x"], c["y"], c["z"]]) @ cam2veh.T)
    ys1, xs1 = layout.paste_slice(True)
    ys2, xs2 = layout.paste_slice(False)
    colours = ((230, 180, 90), (90, 200, 230))
    scene = {"images": [], "lidars": [], "poses": [], "det_masks": [],
             "ref": ref, "layout": layout}
    for k in range(n_frames):
        pose = np.eye(4)
        pose[0, 3] = (k - ref) * WAYMO_EGO_STEP * motion
        ground_cam = np.stack([rng.uniform(-15, 15, ground),
                               np.full(ground, 1.66),
                               rng.uniform(4, 60, ground)], 1)
        parts = [ground_cam @ cam2veh.T]
        for c, car in zip(WAYMO_CARS, cars):
            moved = car + [(k - ref) * c["step"] * motion, 0, 0] \
                - pose[:3, 3]
            parts.append(moved + rng.normal(scale=0.02, size=moved.shape))
        imgs = [rng.integers(0, 40, (layout.side_h if s in (0, 4) else h,
                                     w, 3), dtype=np.uint8)
                for s in range(5)]
        keep, on1, on2 = [], [], []
        ground_uv = None
        for j, part in enumerate(parts):
            cam = part @ VEHICLE_TO_CAM.T
            u = f * cam[:, 0] / cam[:, 2] + w / 2
            v = f * cam[:, 1] / cam[:, 2] + h / 2
            vis = (cam[:, 2] > 1) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
            if j == 0:
                ground_uv = (u, v, cam[:, 2], vis)
                continue
            m = car_mask(u[vis], v[vis], h, w, max(2, 8 * w // 1920))
            imgs[2][m] = colours[j - 1]
            # the car hides the ground behind it from the scanner
            gu, gv, gz, gvis = ground_uv
            hit = gvis.copy()
            hit[gvis] = m[gv[gvis].astype(int), gu[gvis].astype(int)]
            ground_uv = (gu, gv, gz, gvis & ~(hit & (gz > cam[:, 2].min())))
            keep.append((part, u, v, vis))
            for ys, xs, dst in ((ys1, xs1, on1), (ys2, xs2, on2)):
                pano = np.zeros(layout.canvas_hw, bool)
                pano[ys, xs] = m
                dst.append(pano)
        gu, gv, _, gvis = ground_uv
        keep.insert(0, (parts[0], gu, gv, gvis))
        scene["lidars"].append(np.concatenate([np.concatenate(
            [part[vis], np.ones((int(vis.sum()), 1)),
             np.stack([u[vis], v[vis]], 1)], 1)
            for part, u, v, vis in keep]
            + [side_ground(rng, layout, ground, cam2veh, f)]).astype(
                np.float32))
        scene["images"].append(imgs)
        scene["poses"].append(pose)
        scene["det_masks"].append([[], on1, on2, []])
    return scene


class SceneMatcher:
    """``MatcherBackend`` of the synthetic segment (the card's machine has
    no OpenCV for ORB): each pair's true correspondences, points of the
    warped camera and their images under the pair's homography in the
    fixed camera's pixels, a share of them replaced by outliers, so that
    RANSAC and ``select_best_homography`` do their work.  The driver asks
    for the pairs in order, 4 a frame."""

    def __init__(self, homos, layout, n: int = WAYMO_MATCHES,
                 outliers: float = WAYMO_OUTLIERS):
        self.homos, self.layout, self.n, self.outliers = (homos, layout, n,
                                                          outliers)
        self.calls = 0

    def match(self, img_src, img_dst):
        import numpy as np

        from monosowa_tpu_torch.sowa.waymo2d import PAIRS

        z = self.calls % 4
        rng = np.random.default_rng(self.calls)
        self.calls += 1
        lay = self.layout
        src = rng.uniform([0, 0], [lay.cam_w, lay.cam_h], (self.n, 2))
        hom = np.hstack([src, np.ones((self.n, 1))]) @ self.homos[z].T
        ys, xs = lay.paste_slice(PAIRS[z][2])
        dst = hom[:, :2] / hom[:, 2:] - [xs.start, ys.start]
        bad = rng.uniform(size=self.n) < self.outliers
        dst[bad] = rng.uniform([0, 0], [lay.cam_w, lay.cam_h],
                               (int(bad.sum()), 2))
        return src, dst


def waymo_driver(root: str, action: str, dev, scene: dict, cache: str,
                 labels: str = "labels", extra=None, matcher=None):
    """The CLI driver (``sowa/cli.py`` ``WaymoSegmentDriver``) over one
    segment under ``root``: its LiDAR (npz) and poses (npy) written with
    numpy, its images handed over in memory (the card's machine has no
    PIL to read PNGs); ``matcher`` in place of the configured one."""
    import numpy as np

    from monosowa_tpu_torch.config import Config, PipelineFlags
    from monosowa_tpu_torch.sowa.cli import WaymoSegmentDriver

    seg = os.path.join(root, "segments", "seg-000")
    if not os.path.exists(os.path.join(seg, "poses.npy")):
        os.makedirs(os.path.join(seg, "lidar"), exist_ok=True)
        for i, pts in enumerate(scene["lidars"]):
            np.savez_compressed(os.path.join(seg, "lidar", f"{i:06d}.npz"),
                                points=pts)
        np.save(os.path.join(seg, "poses.npy"), np.stack(scene["poses"]))
    n = len(scene["images"])
    cfg = {"paths": {"waymo_path": os.path.join(root, "segments"),
                     "merged_frames_path": os.path.join(root, cache),
                     "labels_path": os.path.join(root, labels)},
           "frames_creation": {"nscans_before": n // 2,
                               "nscans_after": n // 2,
                               "nscans_transformation_range": n // 2},
           "image_stitching": {
               "height_pxl_pad": scene["layout"].height_pad,
               "width_pxl_pad": scene["layout"].width_pad}}
    for k, v in (extra or {}).items():
        cfg.setdefault(k, {}).update(v)

    class InMemorySegment(WaymoSegmentDriver):
        def _n_frames(self, seg):
            return n

        def _get_imgs(self, seg):
            return lambda i: scene["images"][i]

        def _matcher(self):
            self.matcher = matcher or super()._matcher()
            return self.matcher

    return InMemorySegment(Config(cfg), PipelineFlags(action), device=dev)


def copy_cache(root: str, src: str, dst: str, sub: str) -> None:
    import shutil

    shutil.copytree(os.path.join(root, src, sub), os.path.join(root, dst,
                                                                sub))


def corner_error(got, want, layout) -> float:
    """Largest distance at the warped camera's corners between two
    homographies' images (canvas pixels)."""
    import numpy as np

    c = np.array([[0, 0, 1], [layout.cam_w, 0, 1], [0, layout.cam_h, 1],
                  [layout.cam_w, layout.cam_h, 1]], float)
    a, b = c @ got.T, c @ want.T
    return float(np.abs(a[:, :2] / a[:, 2:] - b[:, :2] / b[:, 2:]).max())


def label_cars(path: str):
    from monosowa_tpu_torch.kittiio import read_label_file

    lab = read_label_file(path)
    return [(str(n), float(p[0]), float(p[2]))
            for n, p in zip(lab.names, lab.pos)]


def rel_err(a, b) -> float:
    return float((a.double().cpu() - b.double().cpu()).abs().max()
                 / max(float(b.double().abs().max()), 1e-30))


def loftr_parts(model, pair) -> dict:
    """One LoFTR forward's outputs with the coarse features and the
    fine-fusion windows it computed on the way (``EfficientLoFTR.forward``
    calls both methods once)."""
    import torch

    rec = {}

    def keep(name, fn):
        def call(*args):
            rec[name] = fn(*args)
            return rec[name]
        return call

    model.coarse_features = keep("coarse", model.coarse_features)
    model.fine_fusion_forward = keep("windows", model.fine_fusion_forward)
    try:
        with torch.no_grad():
            kp, sc, idx = model(pair)
    finally:
        del model.coarse_features, model.fine_fusion_forward
    return {"coarse": rec["coarse"][1], "windows": rec["windows"], "kp": kp,
            "sc": sc, "idx": idx}


def loftr_agreement(got: dict, want: dict, bar: float, what: str) -> dict:
    """Two LoFTR forwards held together: coarse features and fine-fusion
    windows within ``bar`` of their magnitude; where the coarse matches
    agree, scores within ``bar`` and keypoints within ``LOFTR_KP_BAR`` of
    the image size.  A match is discontinuous (a score at the threshold,
    a mutual-nearest tie, the fine stage's argmax): the slots whose match
    or keypoint flipped are counted, at most ``LOFTR_FLIP_SHARE`` of the
    coarse cells."""
    idx, idx_w = got["idx"].cpu(), want["idx"].cpu()
    same = (idx == idx_w) & (idx_w >= 0)
    kp_err = (got["kp"].double().cpu() - want["kp"].double().cpu()).abs(
        ).amax(-1)[same]
    held = kp_err <= LOFTR_KP_BAR
    out = {"coarse_rel": rel_err(got["coarse"], want["coarse"]),
           "windows_rel": max(rel_err(a, b) for a, b in zip(
               got["windows"], want["windows"])),
           "matched": int((idx_w >= 0).sum()),
           "matched_equal": int(same.sum()),
           "scores_rel": rel_err(got["sc"].cpu()[same],
                                 want["sc"].cpu()[same])
           if bool(same.any()) else None,
           "kp_abs": float(kp_err[held].max()) if bool(held.any()) else None,
           "match_flips": int((idx != idx_w).sum()),
           "kp_flips": int((~held).sum())}
    flips = out["match_flips"] + out["kp_flips"]
    if not out["matched_equal"] or max(
            out["coarse_rel"], out["windows_rel"], out["scores_rel"]) > bar \
            or flips > LOFTR_FLIP_SHARE * idx.numel():
        raise AssertionError(f"LoFTR {what}: {out}")
    return out


def waymo_window(dev, root: str, layout, homos_dir: str) -> dict:
    """The reference frame of a segment of ``2 * WAYMO_WINDOW + 1`` frames
    labelled at the shipped config's window of +-``WAYMO_WINDOW`` scans:
    the scene's car masks as the masks_raw cache, the template tracker,
    ``transformations``, then ``optimization`` of that frame alone (the
    other frames' label files are there already).  The homographies are
    the short segment's (the same cameras)."""
    import shutil

    import numpy as np
    import torch

    from monosowa_tpu_torch.ops import tfl
    from monosowa_tpu_torch.sowa import masks as masks_mod

    n = 2 * WAYMO_WINDOW + 1
    t0 = time.perf_counter()
    scene = waymo_scene(layout, n, motion=WAYMO_WINDOW_MOTION)
    out = {"frames": n, "window": [-WAYMO_WINDOW, WAYMO_WINDOW],
           "motion": WAYMO_WINDOW_MOTION,
           "scene_build_s": time.perf_counter() - t0,
           "scan_points": len(scene["lidars"][scene["ref"]])}
    seg, ref = "seg-000", scene["ref"]
    shutil.copytree(homos_dir, os.path.join(root, "cache", "homographies"))
    mdir = os.path.join(root, "cache", "masks_raw", seg)
    for i in range(n):
        for z in range(4):
            masks_mod.save_masks(mdir, f"{i:06d}_{z}",
                                 scene["det_masks"][i][z], layout.canvas_hw)
    step_s = {}
    for action in ("mask_tracking", "transformations"):
        drv = waymo_driver(root, action, dev, scene, "cache")
        t0 = time.perf_counter()
        drv.run(None, None)
        torch.cuda.synchronize()
        step_s[action] = time.perf_counter() - t0
        out[f"{action}_stage_s"] = dict(drv.stage_seconds)
    lab = os.path.join(root, "labels", seg)
    os.makedirs(lab, exist_ok=True)
    for i in range(n):
        if i != ref:
            open(os.path.join(lab, f"{i:06d}.txt"), "w").close()
    drv = waymo_driver(root, "optimization", dev, scene, "cache")
    if (drv.pcfg.nscans_before, drv.pcfg.nscans_after) != (WAYMO_WINDOW,
                                                           WAYMO_WINDOW):
        raise AssertionError("the window run's window is "
                             f"{drv.pcfg.nscans_before, drv.pcfg.nscans_after}")
    tfl.launches = 0
    t0 = time.perf_counter()
    written = drv.run(None, None)
    torch.cuda.synchronize()
    step_s["optimization"] = time.perf_counter() - t0
    out["optimization_stage_s"] = dict(drv.stage_seconds)
    out["tfl_launches"] = tfl.launches
    cars = label_cars(os.path.join(lab, f"{ref:06d}.txt"))
    want = WAYMO_CARS[0]
    off = min((max(abs(x - want["x"]), abs(z - want["z"]))
               for _, x, z in cars), default=float("inf"))
    if written != 1 or off > WAYMO_CAR_BAR:
        raise AssertionError(f"window run: {written} label files, the "
                             f"standing car {off} m from every label: "
                             f"{cars}")
    out["standing_car_err_m"] = off
    out["ms_per_frame"] = {"mask_tracking": step_s["mask_tracking"] * 1e3
                           / n,
                           "transformations": step_s["transformations"]
                           * 1e3 / n,
                           "optimization": step_s["optimization"] * 1e3}
    out["step_s"] = step_s
    return out


def waymo(dev, root: str, mask_ckpt: str, n_frames: int = WAYMO_FRAMES,
          layout=None, loftr_cfg=None, tracker_cfg=None,
          mask_input_hw=MASK_INPUT_HW, grid=None) -> dict:
    """Raw Waymo segments through ``sowa/cli.py``'s ``WaymoSegmentDriver``
    at Waymo's sizes (module docstring, phase ``waymo``)."""

    import numpy as np
    import torch

    from monosowa_tpu_torch.config import Config
    from monosowa_tpu_torch.convert import load_zoo_params, zoo_params
    from monosowa_tpu_torch.models.efficientloftr import (
        EfficientLoFTR, EfficientLoFTRConfig)
    from monosowa_tpu_torch.models.vit_tracker import (ViTTracker,
                                                       ViTTrackerConfig)
    from monosowa_tpu_torch.ops import msda, tfl
    from monosowa_tpu_torch.sowa import masks as masks_mod
    from monosowa_tpu_torch.sowa import tracker2d, waymo2d, zoo

    layout = layout or waymo2d.PairLayout()
    out = {"phase": "waymo", "frames": n_frames,
           "camera_hw": [layout.cam_h, layout.cam_w],
           "side_hw": [layout.side_h, layout.cam_w],
           "canvas_hw": list(layout.canvas_hw)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scene = waymo_scene(layout, n_frames)
    out["scene_build_s"] = time.perf_counter() - t0
    out["scan_points"] = [len(p) for p in scene["lidars"][:3]]
    truth = waymo_homographies(layout)
    seg, ref = "seg-000", scene["ref"]
    step_s = {}

    # (a) homographies through the scene's matcher (RANSAC on the host)
    drv = waymo_driver(root, "homographies", dev, scene, "cache",
                       matcher=SceneMatcher(truth, layout))
    t0 = time.perf_counter()
    drv.run(None, None)
    step_s["homographies"] = time.perf_counter() - t0
    homos = drv._load_homos(seg)
    err = max(corner_error(h, t, layout) for h, t in zip(homos, truth))
    if err > 1.0:
        raise AssertionError(f"homographies {err} px from the truth")
    out["homography_corner_err_px"] = err
    # the scene's car masks as the masks_raw cache (cached-artifact mode)
    mdir = os.path.join(root, "cache", "masks_raw", seg)
    t0 = time.perf_counter()
    for i in range(n_frames):
        for z in range(4):
            masks_mod.save_masks(mdir, f"{i:06d}_{z}",
                                 scene["det_masks"][i][z], layout.canvas_hw)
    out["masks_raw_write_s"] = time.perf_counter() - t0

    # (a) mask_tracking: canvases stitched on the card, the template
    # tracker on the card
    drv = waymo_driver(root, "mask_tracking", dev, scene, "cache")
    t0 = time.perf_counter()
    drv.run(None, None)
    torch.cuda.synchronize()
    step_s["mask_tracking"] = time.perf_counter() - t0
    out["mask_tracking_stage_s"] = dict(drv.stage_seconds)
    cars2d, _ = drv._load_tracked(seg, n_frames)
    spans = sorted((len(o) for o in cars2d), reverse=True)
    if spans[:2] != [n_frames, n_frames]:
        raise AssertionError(f"track lengths {spans}: each car is tracked "
                             "over the segment")
    out["tracks"] = len(cars2d)

    drv = waymo_driver(root, "transformations", dev, scene, "cache")
    t0 = time.perf_counter()
    drv.run(None, None)
    step_s["transformations"] = time.perf_counter() - t0

    # optimization at the shipped grid: K5 counted and replayed
    drv = waymo_driver(root, "optimization", dev, scene, "cache",
                       extra=grid and {"optimization": grid})
    tfl.launches = 0
    with recording_tfl() as recorded:
        t0 = time.perf_counter()
        written = drv.run(None, None)
        torch.cuda.synchronize()
        step_s["optimization"] = time.perf_counter() - t0
        k5 = tfl.launches
    out["tfl_launches"] = k5
    out["tfl_replayed"] = replay_tfl_launches(recorded, "waymo")
    del recorded
    out["optimization_stage_s"] = dict(drv.stage_seconds)
    if written != n_frames or k5 == 0:
        raise AssertionError(f"optimization wrote {written} files with "
                             f"{k5} tfl_counts launches")
    cars = label_cars(os.path.join(root, "labels", seg, f"{ref:06d}.txt"))
    want = WAYMO_CARS[0]
    off = min(max(abs(x - want["x"]), abs(z - want["z"]))
              for _, x, z in cars)
    if off > WAYMO_CAR_BAR:
        raise AssertionError(f"the standing car is {off} m from every "
                             f"label: {cars}")
    out["standing_car_err_m"] = off
    out["reference_labels"] = cars
    out["ms_per_frame"] = {k: v * 1e3 / n_frames for k, v in step_s.items()}
    out["step_s"] = step_s

    # the reference frame at a cut grid on the card and on the CPU, from
    # the same caches: the same label file
    texts = []
    for tag, where in (("labels_cut_card", dev), ("labels_cut_cpu", "cpu")):
        lab = os.path.join(root, tag, seg)
        os.makedirs(lab, exist_ok=True)
        for i in range(n_frames):
            if i != ref:
                open(os.path.join(lab, f"{i:06d}.txt"), "w").close()
        drv = waymo_driver(root, "optimization", where, scene, "cache",
                           labels=tag, extra={"optimization":
                                              WAYMO_CUT_GRID})
        t0 = time.perf_counter()
        drv.run(None, None)
        out[tag.replace("labels", "s")] = time.perf_counter() - t0
        with open(os.path.join(lab, f"{ref:06d}.txt")) as f:
            texts.append(f.read())
    if texts[0] != texts[1] or not texts[1].startswith("Car"):
        raise AssertionError("the card's label file is not the CPU's:\n"
                             + texts[0] + "\n" + texts[1])
    out["cpu_label_file_equal"] = True

    # the reference frame of a longer segment at the shipped window
    out["window_run"] = waymo_window(dev, os.path.join(root, "window"),
                                     layout, os.path.join(root, "cache",
                                                          "homographies"))
    torch.cuda.empty_cache()

    # the live Mask2Former on the canvases (the masks phase's checkpoint):
    # 6 K1 launches a canvas; the threshold keeps WAYMO_KEPT queries of the
    # first canvas (a weight choice: random weights give every query the
    # same few labels)
    canvases = waymo2d.stitch_frame(scene["images"][0], homos, layout,
                                    device=dev)
    hw = list(mask_input_hw)
    probe = zoo.mask_backend(Config({"backends": {
        "mask": "mask2former", "mask_checkpoint": mask_ckpt,
        "mask_input_hw": hw}}), device=dev)
    with torch.no_grad():
        cls, _ = probe.forward(canvases[1])
    prob = torch.softmax(cls.float(), -1)[:, CAR_LABEL].sort().values
    thr = float(prob[-WAYMO_KEPT - 1] + prob[-WAYMO_KEPT]) / 2
    del probe
    os.makedirs(os.path.join(root, "cache_live"), exist_ok=True)
    copy_cache(root, "cache", "cache_live", "homographies")
    drv = waymo_driver(root, "mask_tracking", dev, scene, "cache_live",
                       extra={"backends": {"mask": "mask2former",
                                           "mask_checkpoint": mask_ckpt,
                                           "mask_input_hw": hw},
                              "filtering": {"score_detectron_thresh": thr}})
    msda.launches = 0
    t0 = time.perf_counter()
    drv.run(None, None)
    torch.cuda.synchronize()
    live_s = time.perf_counter() - t0
    k1 = msda.launches
    backend = drv._mask_backend_cache
    per_canvas = backend.cfg.encoder_layers
    if k1 != per_canvas * 4 * n_frames:
        raise AssertionError(f"{k1} MSDA launches for {4 * n_frames} "
                             "canvases")
    out["msda_launches"] = k1
    out["live_mask_tracking_s"] = live_s
    out["live_ms_per_frame"] = live_s * 1e3 / n_frames
    out["live_stage_s"] = dict(drv.stage_seconds)
    out["score_threshold"] = thr
    out["mask_ms_per_canvas"] = cuda_ms(
        lambda: backend.predict_masks(canvases[1]), 3, 1)
    out["mask_forward_ms_per_canvas"] = cuda_ms(
        lambda: backend.forward(canvases[1]), 3, 1)
    prof = busy_share(lambda: [drv._pair_masks(seg, 0, z, c)
                               for z, c in enumerate(canvases)])
    out["live_masks_frame"] = {k: prof[k] for k in (
        "wall_ms", "device_ms", "device_busy_share", "top_kernels")}
    out["live_masks_host_share"] = 1.0 - prof["device_busy_share"]
    recorded, restore = recording_msda(
        list(backend.model.pixel_decoder.encoder_layers))
    backend.forward(canvases[1])
    restore()
    out["canvas_k1"] = check_msda_recorded("waymo canvas", recorded)
    del recorded, backend, drv
    torch.cuda.empty_cache()

    # (b) LoFTR at full width through backends.matcher: loftr
    lcfg = loftr_cfg or EfficientLoFTRConfig()
    t0 = time.perf_counter()
    lpath = os.path.join(root, "zoo", "loftr.npz")
    ltree = zoo_params(EfficientLoFTR(lcfg))
    zoo.save_checkpoint(lpath, "loftr", ltree, lcfg)
    out["loftr_checkpoint_s"] = time.perf_counter() - t0
    drv = waymo_driver(root, "homographies", dev, scene, "cache_loftr",
                       extra={"backends": {
                           "matcher": "loftr", "matcher_checkpoint": lpath,
                           "matcher_input_hw": list(LOFTR_INPUT_HW)}})
    t0 = time.perf_counter()
    drv.run(None, None)
    out["loftr_homographies_s"] = time.perf_counter() - t0
    matcher = drv.matcher
    a, b = (waymo2d.pad_side_image(im, layout)
            for im in scene["images"][0][1:3])
    pair = torch.stack([matcher._gray(a), matcher._gray(b)])[None]
    out["loftr_input_hw"] = list(pair.shape[-2:])
    out["loftr_ms_per_pair"] = cuda_ms(lambda: matcher.model(pair), 5)
    out["loftr_match_ms_per_pair"] = cuda_ms(lambda: matcher.match(a, b),
                                             3, 1)
    front = scene["images"][0][2]
    pair = torch.stack([matcher._gray(front), matcher._gray(
        np.roll(front, -LOFTR_CHECK_SHIFT, axis=1))])[None]
    del matcher, drv
    # the checks at a threshold that keeps matches, so that the fine
    # fusion, the fine matching and the keypoints are held too
    low = dataclasses.replace(lcfg,
                              coarse_matching_threshold=LOFTR_CHECK_THRESHOLD)
    m32 = load_zoo_params(EfficientLoFTR(low, device=dev), ltree)
    got = loftr_parts(m32, pair)
    m64 = m32.double()
    out["loftr_f64"] = loftr_agreement(got, loftr_parts(m64, pair.double()),
                                       LOFTR_F64_BAR, "float32 vs float64")
    del m32, m64, got
    torch.cuda.empty_cache()
    cut = dataclasses.replace(low, num_attention_layers=LOFTR_CUT_LAYERS)
    tree = zoo_params(EfficientLoFTR(cut, seed=1))
    res = [loftr_parts(load_zoo_params(EfficientLoFTR(cut, device=where),
                                       tree), pair.to(where))
           for where in (dev, "cpu")]
    out["loftr_cut_cpu"] = {"layers": LOFTR_CUT_LAYERS, **loftr_agreement(
        *res, LOFTR_CPU_BAR, "card vs CPU")}
    del res
    torch.cuda.empty_cache()

    # (b) the ViT tracker at full width through backends.tracker: vit
    tcfg = tracker_cfg or ViTTrackerConfig()
    tpath = os.path.join(root, "zoo", "vit_tracker.npz")
    ttree = zoo_params(ViTTracker(tcfg))
    zoo.save_checkpoint(tpath, "vit_tracker", ttree, tcfg)
    for sub in ("homographies", "masks_raw"):
        copy_cache(root, "cache", "cache_vit", sub)
    drv = waymo_driver(root, "mask_tracking", dev, scene, "cache_vit",
                       extra={"backends": {"tracker": "vit",
                                           "tracker_checkpoint": tpath}})
    steps, seen = [0], []
    inner = tracker2d.ViTTrackerBackend.step

    def counted(self, image):
        steps[0] += 1
        seen.append(self)
        return inner(self, image)

    tracker2d.ViTTrackerBackend.step = counted
    try:
        t0 = time.perf_counter()
        drv.run(None, None)
        torch.cuda.synchronize()
        out["vit_mask_tracking_s"] = time.perf_counter() - t0
    finally:
        tracker2d.ViTTrackerBackend.step = inner
    if not steps[0]:
        raise AssertionError("the ViT tracker took no step")
    out["vit_steps"] = steps[0]
    trk = seen[-1]
    z_, x_ = trk._template[None], trk._crop(
        canvases[1], 3000.0, 700.0, 600.0, tcfg.search_size)[None]
    tok = trk.model.track_token.detach()
    out["tracker_ms_per_step"] = cuda_ms(lambda: trk.model(z_, x_, tok),
                                         TRACKER_TIMED_STEPS)
    cpu_model = load_zoo_params(ViTTracker(tcfg, device="cpu"), ttree)
    with torch.no_grad():
        got = trk.model(z_, x_, tok)
        want = cpu_model(z_.cpu(), x_.cpu(), tok.cpu())
    # the box is read at the score map's argmax: compared where that agrees
    out["tracker_cpu"] = {n: rel_err(g, w) for n, g, w in zip(
        ("score_map", "track_tokens"), got[1:], want[1:])}
    same = bool(torch.equal(got[1].flatten(1).argmax(-1).cpu(),
                            want[1].flatten(1).argmax(-1)))
    out["tracker_cpu"]["box_abs"] = float(
        (got[0].cpu() - want[0]).abs().max()) if same else None
    if max(out["tracker_cpu"]["score_map"],
           out["tracker_cpu"]["track_tokens"]) > TRACKER_CPU_BAR or (
               same and out["tracker_cpu"]["box_abs"] > TRACKER_CPU_BAR):
        raise AssertionError(f"tracker card vs CPU: {out['tracker_cpu']}")
    out["peak_mem_GB"] = torch.cuda.max_memory_allocated() / 1e9
    del drv, trk, seen, canvases
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# optional_stages (slice 15): ICP poses, region growing, the deformable
# mesh, the gather-field fit and the custom-dataset harness
# ---------------------------------------------------------------------------

# ICP: the shipped +-130 window (configs/sowa_kitti.yaml
# nscans_transformation_range) at jump 5, 4,096 points, 20 iterations,
# k = 10; a 64-beam scanner's rays (HDL-64E: +2 to -24.8 degrees, 1,800
# azimuths: about 115k a frame, 80 m) at KITTI's driving speed (1 m a
# frame at 10 Hz) on a gentle curve.  The label scenes' scans (a flat
# ground and cars that face the camera) leave a point-to-plane ICP no
# constraint across the road, hence a street of its own
ICP_RNG, ICP_JUMP, ICP_POINTS = 130, 5, 4096
ICP_BEAMS, ICP_AZIMUTHS, ICP_RANGE = 64, 1800, 80.0
ICP_STEP, ICP_YAW_RATE, ICP_NOISE = 1.0, 0.0005, 0.01
# v2 (with its prior) is held to the truth on every frame within
# ICP_HOLD_WINDOW of the reference: the frames registered straight to it,
# 1-4 m away.  Its anchors, 5 m apart, miss the bar on this street (a
# corridor: little but the gaps and the parked cars' ends fixes the
# forward motion of a 4,096-point sample), and over the +-130 window's
# 26 anchor links their errors chain into a drift (reported: the reach,
# the largest r whose frames all hold the bar, the errors within the
# +-30 frames the labeller aggregates and over the window, each
# anchor's).  v1 has no prior, and its pairs, 5 m apart, start outside
# its 1 m correspondence gate: reported, not held
ICP_HOLD_WINDOW = 4
ICP_REPORT_WINDOW = 30
ICP_POS_BAR, ICP_ROT_BAR_DEG, ICP_CPU_BAR = 0.05, 0.5, 1e-4
# region growing: the CPU checks at full resolution are the rounds of the
# card's run with at most GROW_CPU_EDGES edges (the far cars' second
# rounds) and the largest round at the smallest threshold; the whole flow
# of every mask on every GROW_CPU_STRIDE-th pixel row and column (a near
# car's round, with its 790 M edges, takes minutes on the host)
GROW_CPU_STRIDE, GROW_BOX_MARGIN, GROW_CPU_EDGES = 4, 0.3, 5_000_000
# the deformable mesh: DeformConfig() on 16 cars of 2,048 points; the card
# against the CPU over 30 steps, of the vertices' scale
DEFORM_CARS, DEFORM_S, DEFORM_CPU_STEPS, DEFORM_CPU_BAR = 16, 2048, 30, 1e-4
DEFORM_DIST_BAR = 0.25        # m, tests/test_deformable.py's
DEFORM_BUSY_STEPS = 100       # steps of the profiled run
# the gather-field fit at FitConfig(): 16 cars, the second (moving) of
# them through both the standing and the moving fit on the CPU too
GATHER_CARS, GATHER_CPU_CAR = 16, 1


def icp_world(rng, path_len: float):
    """Boxes (center (M, 3), half extents (M, 3), yaw (M,)) along the ego
    path in frame 0's camera axes (x right, y down, z forward; the ground
    at y = 1.65): buildings 9-13 m to each side (8-16 m long, 1-4 m gaps,
    9.65 m tall) and parked cars 4-6 m to each side every 6-10 m, yawed
    up to 0.3 rad off the road, from 80 m behind to 80 m beyond the
    path."""
    import numpy as np

    centers, halves, yaws = [], [], []

    def along(s, lateral):
        psi = ICP_YAW_RATE * s / ICP_STEP          # the road's heading at s
        k = np.arange(0.0, s, ICP_STEP) if s > 0 else np.zeros(0)
        x = float(np.sum(ICP_STEP * np.sin(ICP_YAW_RATE * k / ICP_STEP)))
        z = float(np.sum(ICP_STEP * np.cos(ICP_YAW_RATE * k / ICP_STEP)))
        if s <= 0:
            x, z = 0.0, s
        return (x + lateral * np.cos(psi), z - lateral * np.sin(psi), psi)

    for side in (-1, 1):
        s = -80.0
        while s < path_len + 80.0:
            length = rng.uniform(8, 16)
            off = side * (rng.uniform(9, 13) + 5.0)
            x, z, psi = along(s + length / 2, off)
            centers.append([x, 1.65 - 4.825, z])
            halves.append([5.0, 4.825, length / 2])
            yaws.append(psi)
            s += length + rng.uniform(1, 4)
        s = -80.0
        while s < path_len + 80.0:
            x, z, psi = along(s, side * rng.uniform(4, 6))
            centers.append([x, 1.65 - 0.75, z])
            halves.append([0.9, 0.75, 2.1])
            yaws.append(psi + rng.uniform(-0.3, 0.3))
            s += rng.uniform(6, 10)
    return (np.asarray(centers), np.asarray(halves), np.asarray(yaws))


def icp_poses(n: int):
    """(n, 4, 4) camera-to-world poses: ICP_STEP a frame, at one speed,
    along a heading that turns ICP_YAW_RATE a frame."""
    import numpy as np

    poses = np.tile(np.eye(4), (n, 1, 1))
    pos = np.zeros(3)
    for k in range(n):
        psi = ICP_YAW_RATE * k
        c, s = np.cos(psi), np.sin(psi)
        poses[k, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        poses[k, :3, 3] = pos
        pos = pos + ICP_STEP * np.array([s, 0.0, c])
    return poses


def ray_scan(world, pose, dev, gen):
    """One frame's scan, (N, 3) float32 camera-frame points: every ray of
    the scanner's rings hits the ground or a box within ICP_RANGE, moved
    along the ray by ICP_NOISE Gaussian noise (ray casting on ``dev``)."""
    import numpy as np
    import torch

    el = torch.deg2rad(torch.linspace(2.0, -24.8, ICP_BEAMS,
                                      dtype=torch.float64, device=dev))
    az = torch.arange(ICP_AZIMUTHS, dtype=torch.float64,
                      device=dev) * (2 * np.pi / ICP_AZIMUTHS)
    el, az = el[:, None], az[None, :]
    d_cam = torch.stack([torch.cos(el) * torch.sin(az),
                         (-torch.sin(el)).expand(-1, az.shape[1]),
                         torch.cos(el) * torch.cos(az)], -1).reshape(-1, 3)
    rot = torch.as_tensor(pose[:3, :3], device=dev)
    origin = torch.as_tensor(pose[:3, 3], device=dev)
    d = d_cam @ rot.T                                        # world rays
    t = torch.where(d[:, 1] > 1e-9, (1.65 - origin[1]) / d[:, 1],
                    torch.full_like(d[:, 1], np.inf))
    centers, halves, yaws = (torch.as_tensor(a, device=dev) for a in world)
    near = ((centers[:, [0, 2]] - origin[[0, 2]]).norm(dim=1)
            < ICP_RANGE + halves.norm(dim=1))
    c, h, yw = centers[near], halves[near], yaws[near]
    cy, sy = torch.cos(yw), torch.sin(yw)
    # into each box's frame: R_y(yaw)^T (p - c)
    rel = origin[None] - c                                   # (M, 3)
    o_b = torch.stack([cy * rel[:, 0] - sy * rel[:, 2], rel[:, 1],
                       sy * rel[:, 0] + cy * rel[:, 2]], -1)
    d_b = torch.stack([cy[None] * d[:, None, 0] - sy[None] * d[:, None, 2],
                       d[:, None, 1].expand(-1, len(yw)),
                       sy[None] * d[:, None, 0] + cy[None] * d[:, None, 2]],
                      -1)                                    # (R, M, 3)
    d_b = torch.where(d_b.abs() < 1e-12, torch.full_like(d_b, 1e-12), d_b)
    t1 = (-h[None] - o_b[None]) / d_b
    t2 = (h[None] - o_b[None]) / d_b
    t_near = torch.minimum(t1, t2).amax(-1)
    t_far = torch.maximum(t1, t2).amin(-1)
    hit = (t_far >= t_near) & (t_near > 0)
    t_box = torch.where(hit, t_near, torch.full_like(t_near, np.inf))
    t = torch.minimum(t, t_box.amin(-1) if len(yw) else t)
    keep = t <= ICP_RANGE
    t = t[keep] + ICP_NOISE * torch.randn(int(keep.sum()), dtype=t.dtype,
                                          device=dev, generator=gen)
    return (d_cam[keep] * t[:, None]).float().cpu().numpy()


def pose_errors(got, want):
    """(translation errors m, rotation errors degrees), each (n,), between
    two stacks of 4x4 transforms."""
    import numpy as np

    dt = np.linalg.norm(got[:, :3, 3] - want[:, :3, 3], axis=1)
    rel = np.einsum("nji,njk->nik", got[:, :3, :3], want[:, :3, :3])
    cos = np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1)
    return dt, np.degrees(np.arccos(cos))


def window_errors(got, truth, rng_w: int) -> dict:
    """A window's largest errors within ICP_HOLD_WINDOW and
    ICP_REPORT_WINDOW of the reference and over all of it, each anchor's
    within ICP_REPORT_WINDOW ([offset, m, degrees]), and its reach: the
    largest r whose frames within +-r all hold the bar."""
    import numpy as np

    dt, dr = pose_errors(got, truth)
    signed = np.arange(-rng_w, rng_w + 1)
    off = np.abs(signed)
    held = off <= ICP_HOLD_WINDOW
    near = off <= ICP_REPORT_WINDOW
    bad = off[(dt >= ICP_POS_BAR) | (dr >= ICP_ROT_BAR_DEG)
              | ~np.isfinite(got).all((1, 2))]
    anchors = near & (signed % ICP_JUMP == 0) & (off > 0)
    return {"max_pos_err_m": float(dt.max()),
            "max_rot_err_deg": float(dr.max()),
            "held_max_pos_err_m": float(dt[held].max()),
            "held_max_rot_err_deg": float(dr[held].max()),
            "aggregated_max_pos_err_m": float(dt[near].max()),
            "aggregated_max_rot_err_deg": float(dr[near].max()),
            "anchors": [[int(o), float(a), float(b)] for o, a, b in
                        zip(signed[anchors], dt[anchors], dr[anchors])],
            "reach": int(bad.min()) - 1 if len(bad) else rng_w}


def icp_stage(dev, rng_w: int = ICP_RNG) -> dict:
    """(a) ICP: v2 (with an odometry prior 0.16 m and 0.4 degrees off a
    pair) and v1 (no prior) over the +-rng_w window of the middle frame
    of a 2 rng_w + 1 frame sequence; v2's transforms within
    ICP_HOLD_WINDOW of the reference held to the truth, its whole
    window's error and reach reported, v1's reported; one pair on the
    card against the CPU port."""
    import numpy as np
    import torch

    from monosowa_tpu_torch.ops import icp
    from monosowa_tpu_torch.sowa import transforms

    n = 2 * rng_w + 1
    ref = rng_w
    poses = icp_poses(n)
    world = icp_world(np.random.default_rng(11),
                      float(np.linalg.norm(poses[-1, :3, 3])))
    gen = torch.Generator(dev).manual_seed(12)
    scans = {}

    def get_scan(f):
        if f not in scans:
            scans[f] = ray_scan(world, poses[f], dev, gen)
        return scans[f]

    truth = np.stack([np.linalg.inv(poses[ref]) @ poses[f]
                      for f in range(ref - rng_w, ref + rng_w + 1)])
    err_rot = np.eye(4)
    c, s = np.cos(np.deg2rad(0.4)), np.sin(np.deg2rad(0.4))
    err_rot[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    err_rot[:3, 3] = [0.1, 0.05, -0.12]

    def prior(cur, anchor):
        return np.linalg.inv(poses[anchor]) @ poses[cur] @ err_rot

    t0 = time.perf_counter()
    for f in range(n):
        get_scan(f)
    torch.cuda.synchronize()
    scene_s = time.perf_counter() - t0
    points = [len(scans[f]) for f in range(n)]
    kw = dict(jump=ICP_JUMP, max_points=ICP_POINTS, device=dev)
    t0 = time.perf_counter()
    v2 = transforms.icp_window_transforms_v2(get_scan, ref, rng_w, n,
                                             get_prior=prior, **kw)
    v2_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    v1 = transforms.icp_window_transforms(get_scan, ref, rng_w, n, **kw)
    v1_s = time.perf_counter() - t0
    anchors = 2 * (rng_w // ICP_JUMP)
    pairs_v2 = anchors + (n - 1 - anchors)
    pairs_v1 = anchors
    out = {"frames": n, "points_per_frame": [min(points), max(points)],
           "metres_per_frame": ICP_STEP, "held_window": ICP_HOLD_WINDOW,
           "v2": window_errors(v2, truth, rng_w),
           "v1": window_errors(v1, truth, rng_w)}
    if not (np.isfinite(v1).all() and out["v2"]["reach"]
            >= min(rng_w, ICP_HOLD_WINDOW)):
        raise AssertionError(f"icp v2 holds {ICP_POS_BAR} m and "
                             f"{ICP_ROT_BAR_DEG} deg to +-"
                             f"{out['v2']['reach']}, not +-"
                             f"{ICP_HOLD_WINDOW}: {out['v2']}")
    # one pair on the card and on the CPU (the v2 phase 1 pair of anchor
    # +jump: its own subsample)
    rs = np.random.default_rng(3)
    a, b = get_scan(ref + ICP_JUMP), get_scan(ref)
    a = a[rs.choice(len(a), ICP_POINTS, replace=False)]
    b = b[rs.choice(len(b), ICP_POINTS, replace=False)]
    p = prior(ref + ICP_JUMP, ref)
    a = (a @ p[:3, :3].T + p[:3, 3]).astype(np.float32)
    m = np.ones(ICP_POINTS, bool)
    args = [torch.from_numpy(x) for x in (a, m, b, m)]
    t_cpu, r_cpu = icp.icp_point_to_plane(*args)
    t_gpu, r_gpu = icp.icp_point_to_plane(*(x.to(dev) for x in args))
    pair_err = float((t_gpu.cpu() - t_cpu).abs().max())
    if not pair_err <= ICP_CPU_BAR:
        raise AssertionError(f"icp pair card vs CPU {pair_err}")
    # the batch's time a pair, alone
    srcs = torch.stack([args[0]] * 8).to(dev)
    ms_ = torch.stack([args[1]] * 8).to(dev)
    tgts = torch.stack([args[2]] * 8).to(dev)
    pair_ms = cuda_ms(lambda: icp.icp_batch(srcs, ms_, tgts, ms_), 3, 1) / 8
    out.update({"pairs_v2": pairs_v2, "pairs_v1": pairs_v1,
                "v2_window_s": v2_s, "v1_window_s": v1_s,
                "v2_ms_per_pair": v2_s * 1e3 / pairs_v2,
                "v1_ms_per_pair": v1_s * 1e3 / pairs_v1,
                "batch_ms_per_pair": pair_ms, "scene_s": scene_s,
                "pair_card_vs_cpu": pair_err,
                "pair_rms": [float(r_cpu), float(r_gpu)]})
    return out


def growing_scene(stride: int = 1):
    """The label scene's frame 0 as pseudo-LiDAR at one point a pixel (or
    every ``stride``-th row and column), (N, 6) [x, y, z, camera 0, row,
    column]; its car masks (full size) and each mask's scene car, with the
    share of the mask's pixels that show it (a nearer car may cover it:
    the masks are the cars' whole rectangles)."""
    import numpy as np

    from monosowa_tpu_torch.sowa import sample

    frames, cars = sample.make_sequence(1, 0)
    f = frames[0]
    h, w = sample.H, sample.W
    rows, cols = np.mgrid[0:h, 0:w]
    scan = np.concatenate([f["points"], np.zeros((h * w, 1), np.float32),
                           rows.reshape(-1, 1).astype(np.float32),
                           cols.reshape(-1, 1).astype(np.float32)], 1)
    if stride > 1:
        keep = ((rows % stride == 0) & (cols % stride == 0)).reshape(-1)
        scan = scan[keep]
    fu, _ = sample.intrinsics(h, w)
    owners = []       # make_sequence's rule for the cars it gives masks
    for ci, car in enumerate(cars):
        z = car["z"]
        if z < 4 or z > 70.0:
            continue
        u = fu * car["x"] / z + w / 2
        v = fu * car["y"] / z + h / 2
        x1, x2 = int(u - fu * 2.0 / z), int(u + fu * 2.0 / z)
        y1, y2 = int(v - fu * 1.6 / z), int(v)
        if x2 < 0 or x1 >= w or y2 < 0 or y1 >= h:
            continue
        owners.append(car)
    if len(owners) != len(f["masks"]):
        raise AssertionError("growing scene: masks and cars disagree")
    for car, m in zip(owners, f["masks"]):
        car["visible"] = float((np.abs(f["depth"][m] - car["z"])
                                < 1e-3).mean())
    return scan, f["masks"], owners


def grown_inside(points, car, margin: float = GROW_BOX_MARGIN) -> bool:
    """Every point inside the car's rectangle (4 m wide, 1.6 m tall, at its
    depth) grown by ``margin``."""
    import numpy as np

    lo = np.array([car["x"] - 2.0, car["y"] - 1.6, car["z"]]) - margin
    hi = np.array([car["x"] + 2.0, car["y"], car["z"]]) + margin
    return bool(((points >= lo) & (points <= hi)).all())


@contextlib.contextmanager
def recording_regions():
    """Every ``growing.largest_region`` call's host inputs and result (a
    numpy mask or None), for ``growing_full_size_on_cpu``."""
    from monosowa_tpu_torch.sowa import growing

    inner = growing.largest_region
    recorded = []

    def recording(pts, mask, car, thresholds, **kw):
        region = inner(pts, mask, car, thresholds, **kw)
        recorded.append({"pts": pts, "mask": mask, "car": car,
                         "thresholds": tuple(thresholds),
                         "edges": kw["stats"]["edges"],
                         "region": None if region is None
                         else region.cpu().numpy()})
        return region

    growing.largest_region = recording
    try:
        yield recorded
    finally:
        growing.largest_region = inner


def growing_full_size_on_cpu(recorded, dev) -> dict:
    """The card's rounds at full resolution on the CPU: every recorded
    ``largest_region`` with at most GROW_CPU_EDGES edges again (the same
    region), and the round with the most edges at the smallest threshold:
    the card's labels from its edges at the largest threshold, filtered,
    as ``largest_region`` takes them, against the CPU's
    ``connected_components`` (the same labels)."""
    import numpy as np
    import torch

    from monosowa_tpu_torch.sowa import growing

    rounds = []
    for r in recorded:
        if r["edges"] > GROW_CPU_EDGES:
            continue
        got = growing.largest_region(r["pts"], r["mask"], r["car"],
                                     r["thresholds"], device="cpu")
        same = (got is None and r["region"] is None) or (
            got is not None and r["region"] is not None
            and np.array_equal(got.numpy(), r["region"]))
        rounds.append({"points": len(r["pts"]), "edges": r["edges"],
                       "equal": same})
        if not same:
            raise AssertionError(f"growing round of {r['edges']} edges: "
                                 "card and CPU regions differ")
    if not rounds:
        raise AssertionError("growing: no round the CPU can take")
    big = max(recorded, key=lambda r: r["edges"])
    t_lo, t_hi = min(big["thresholds"]), max(big["thresholds"])
    pts = torch.from_numpy(big["pts"])
    mask = torch.from_numpy(big["mask"])
    ei, ej, d2 = growing.neighbor_edges(pts.to(dev), mask.to(dev), t_hi)
    keep = d2 <= growing._sq_threshold(t_lo)
    card = growing.propagate_labels(len(pts), mask.to(dev), ei[keep],
                                    ej[keep]).cpu()
    edges_hi, edges_lo = ei.numel(), int(keep.sum())
    del ei, ej, d2, keep
    cpu = growing.connected_components(pts, mask, t_lo)
    if not torch.equal(card, cpu):
        raise AssertionError(f"growing: the {edges_hi}-edge round's labels "
                             f"at {t_lo} m differ on the card and the CPU")
    return {"rounds_replayed": rounds,
            "largest_round": {"points": len(pts), "edges": edges_hi,
                              "threshold": t_lo, "edges_at_threshold":
                              edges_lo, "components": len(cpu.unique()),
                              "labels_equal": True}}


def growing_stage(dev) -> dict:
    """(b) ``perform_growing_frame`` for each car mask of a 375 x 1242
    pseudo-LiDAR frame on the card (a CPU-seeded draw, so the card and the
    CPU fit the same planes); the grown points inside the mask's car where
    the car shows, no region where a nearer car covers all of it; the
    card's rounds against the CPU at full resolution
    (``growing_full_size_on_cpu``); on every GROW_CPU_STRIDE-th row and
    column, each mask's grown points on the card and the CPU equal."""
    import numpy as np
    import torch

    from monosowa_tpu_torch.sowa import growing

    scan, masks, owners = growing_scene()
    per_mask = []
    torch.cuda.reset_peak_memory_stats()
    with recording_regions() as recorded:
        for i, m in enumerate(masks):
            stats = []
            t0 = time.perf_counter()
            got = growing.perform_growing_frame(
                scan, m, 0, growing.make_draw(i, "cpu"), device=dev,
                stats=stats)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            per_mask.append((got, stats, ms))
    peak = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    full = growing_full_size_on_cpu(recorded, dev)
    full["seconds"] = time.perf_counter() - t0
    del recorded
    for i, (got, stats, ms) in enumerate(per_mask):
        shown = owners[i]["visible"] > 0
        inside = got is not None and grown_inside(got, owners[i])
        per_mask[i] = {"mask_pixels": int(masks[i].sum()),
                       "visible_share": owners[i]["visible"], "ms": ms,
                       "grown": 0 if got is None else len(got),
                       "inside_box": inside, "rounds": stats}
        if (inside if shown else got is None) is not True:
            raise AssertionError(f"growing mask {i}: {per_mask[i]}")
    t0 = time.perf_counter()
    small, _, _ = growing_scene(GROW_CPU_STRIDE)
    equal = []
    for i, m in enumerate(masks):
        a = growing.perform_growing_frame(small, m, 0,
                                          growing.make_draw(i, "cpu"),
                                          device=dev)
        b = growing.perform_growing_frame(small, m, 0,
                                          growing.make_draw(i, "cpu"),
                                          device="cpu")
        same = (a is None and b is None) or (
            a is not None and b is not None and np.array_equal(a, b))
        equal.append(same)
        if not same:
            raise AssertionError(f"growing mask {i} at stride "
                                 f"{GROW_CPU_STRIDE}: card and CPU differ")
    return {"points": len(scan), "masks": len(masks),
            "per_mask": per_mask,
            "ms_per_mask": float(np.mean([p["ms"] for p in per_mask])),
            "peak_mem_GB": peak, "full_size_cpu_check": full,
            "cpu_check_points": len(small), "cpu_check_equal": equal,
            "cpu_check_s": time.perf_counter() - t0}


def deform_cars(rng, verts, faces, b: int, s: int):
    """B scans of the mesh's surface (0.6 S to S points, stretched 0.9-1.15
    an axis, posed, 2 cm noise), zero-padded to S; initial poses 0.1 m and
    0.05 rad off."""
    import numpy as np

    from monosowa_tpu_torch.sowa.mesh_io import sample_mesh_surface

    pts = np.zeros((b, s, 3), np.float32)
    mask = np.zeros((b, s), bool)
    centers = np.zeros((b, 3), np.float32)
    thetas = np.zeros(b, np.float32)
    for i in range(b):
        n = int(rng.integers(s * 3 // 5, s + 1))
        stretch = rng.uniform(0.9, 1.15, 3)
        surf = sample_mesh_surface(verts.astype(np.float64) * stretch, faces,
                                   n, seed=i)
        th = rng.uniform(0, 2 * np.pi)
        c, sn = np.cos(th), np.sin(th)
        rot = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]])
        center = np.array([rng.uniform(-8, 8), 0.9, rng.uniform(8, 40)])
        pts[i, :n] = surf @ rot.T + center + rng.normal(scale=0.02,
                                                        size=(n, 3))
        mask[i, :n] = True
        centers[i] = center + [rng.normal(scale=0.1), 0.0,
                               rng.normal(scale=0.1)]
        thetas[i] = th + rng.normal(scale=0.05)
    return pts, mask, centers, thetas


def deformable_stage(dev) -> dict:
    """(c) ``fit_deformable_batch`` at DeformConfig() with make_car_mesh()
    on DEFORM_CARS cars: losses finite, scales in the clip range, the mean
    vertex-to-scan distance under 0.25 m; 30 steps on the card against the
    CPU, each from the card's state before it; seconds a batch, launches
    a step, the busy share."""
    import dataclasses as dc

    import numpy as np
    import torch

    from monosowa_tpu_torch.sowa import deformable as dfm

    verts, faces = dfm.make_car_mesh()
    pts, mask, centers, thetas = deform_cars(np.random.default_rng(21),
                                             verts, faces, DEFORM_CARS,
                                             DEFORM_S)
    host = [torch.from_numpy(verts), torch.from_numpy(dfm.mesh_edges(faces)
                                                      ).long(),
            torch.from_numpy(dfm.vertex_adjacency(faces, len(verts))).long(),
            torch.from_numpy(dfm.mirror_indices(verts)).long(),
            torch.from_numpy(pts), torch.from_numpy(mask),
            torch.from_numpy(centers), torch.from_numpy(thetas)]
    args = [a.to(dev) for a in host]
    cfg = dfm.DeformConfig()
    dfm.fit_deformable_batch(*args, dc.replace(cfg, iterations=5))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = dfm.fit_deformable_batch(*args, cfg)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    v = res.verts.cpu().numpy()
    dist = []
    for i in range(DEFORM_CARS):
        scan = pts[i][mask[i]]
        d2 = ((v[i][:, None] - scan[None]) ** 2).sum(-1)
        dist.append(float(np.sqrt(d2.min(1)).mean()))
    scales = res.scales.cpu().numpy()
    if not (torch.isfinite(res.loss).all() and np.isfinite(v).all()
            and scales.min() >= cfg.scale_min - 1e-6
            and scales.max() <= cfg.scale_max + 1e-6
            and max(dist) < DEFORM_DIST_BAR):
        raise AssertionError(f"deformable: loss {res.loss.tolist()}, scales "
                             f"{scales.tolist()}, distance {dist}")
    # 30 steps on the card against the CPU, a step at a time: each of the
    # card's steps repeated on the CPU from the card's state before it.
    # The fit is chaotic at this size (moving every input by 1e-14 of
    # itself moves float64 vertices by about 2e-4 of their scale in 30
    # steps), so two free-running fits are not held to each other
    t0 = time.perf_counter()
    prob = {"card": dfm.deform_problem(*args), "cpu": dfm.deform_problem(*host)}
    bc = {k: dfm.bias_corrections(DEFORM_CPU_STEPS, torch.float32,
                                  p.scans.device) for k, p in prob.items()}
    state = dfm.initial_state(prob["card"])
    step_err = []
    for it in range(DEFORM_CPU_STEPS):
        mirror = dfm.DeformState(*(
            [t.detach().cpu().requires_grad_(t.requires_grad) for t in part]
            for part in state))
        dfm.deform_step(prob["cpu"], mirror, it, bc["cpu"][it], cfg)
        dfm.deform_step(prob["card"], state, it, bc["card"][it], cfg)
        with torch.no_grad():
            got = dfm.deform_vertices(prob["card"], state, it + 1, cfg)
            want = dfm.deform_vertices(prob["cpu"], mirror, it + 1, cfg)
        step_err.append(float((got.cpu() - want).abs().max()
                              / want.abs().max()))
    cpu_err = {"max_step": max(step_err), "steps": step_err}
    if not max(step_err) <= DEFORM_CPU_BAR:
        raise AssertionError(f"deformable 30 steps card vs CPU {cpu_err}")
    cpu_s = time.perf_counter() - t0
    # launches a step: kernels of a 20-step fit less a 10-step one
    counts = {}
    for steps in (10, 20):
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            dfm.fit_deformable_batch(*args, dc.replace(cfg, iterations=steps))
            torch.cuda.synchronize()
        counts[steps] = sum(e.count for e in prof.key_averages()
                            if e.device_type
                            == torch.autograd.DeviceType.CUDA)
    busy = busy_share(lambda: dfm.fit_deformable_batch(
        *args, dc.replace(cfg, iterations=DEFORM_BUSY_STEPS)))
    return {"cars": DEFORM_CARS, "scan_points": DEFORM_S,
            "vertices": len(verts), "steps": cfg.iterations,
            "s_per_batch": batch_s, "ms_per_step": batch_s * 1e3
            / cfg.iterations,
            "launches_per_step": (counts[20] - counts[10]) / 10,
            "busy_share_steps": DEFORM_BUSY_STEPS, "busy": busy,
            "mean_vertex_to_scan_m": [min(dist), max(dist)],
            "scales": [float(scales.min()), float(scales.max())],
            "card_vs_cpu_30_steps": cpu_err, "cpu_check_s": cpu_s}


def gather_stage(dev, root: str, cfg=None) -> dict:
    """(d) ``fit_cars`` (the gather-field fit) on GATHER_CARS synthetic cars
    at FitConfig(), one of them through both single-car fits on the card
    and the CPU (the same pose); (e) the
    standing cars through ``custom_dataset``: saved, loaded, re-fitted by
    ``evaluate_fitting_on_pairs`` with the same fit.  The fine theta pass
    of ``fit_cars`` launches ``tfl_counts`` (K5): its launches are counted
    in the timed batch and in the harness, the warm-up's and the
    harness's recorded and replayed against the plain version."""
    import numpy as np
    import torch

    from monosowa_tpu_torch.ops import tfl
    from monosowa_tpu_torch.sowa import custom_dataset, fitting
    from monosowa_tpu_torch.sowa.templates import TemplateBank

    rng = np.random.default_rng(31)
    cfg = cfg or fitting.FitConfig()
    template = TemplateBank.default().points[0]
    pts = np.zeros((GATHER_CARS, TFL_S, 3), np.float32)
    mask = np.zeros((GATHER_CARS, TFL_S), bool)
    moving = np.arange(GATHER_CARS) % 2 == 1
    theta_est = np.zeros(GATHER_CARS, np.float32)
    truth = []
    for i in range(GATHER_CARS):
        p, pose = synthetic_car(rng, template, bool(moving[i]))
        pts[i, :len(p)], mask[i, :len(p)] = p, True
        theta_est[i] = pose["theta"] + np.deg2rad(2.0) if moving[i] else 0
        truth.append(pose)

    def batch(sel):
        return fitting.CarBatch(pts[sel], mask[sel], moving[sel],
                                theta_est[sel], moving[sel].copy(),
                                np.ones(len(pts[sel]), bool))

    every = np.arange(GATHER_CARS)
    tmpl = {d: torch.as_tensor(template, device=d) for d in (dev, "cpu")}
    field = {d: tfl.build_template_field(template, cfg.radius, device=d)
             for d in (dev, "cpu")}
    with recording_tfl() as rec_batch:                          # warm-up
        fitting.fit_cars(batch(every), tmpl[dev], field[dev], cfg)
    torch.cuda.synchronize()
    tfl.launches = 0
    t0 = time.perf_counter()
    res = fitting.fit_cars(batch(every), tmpl[dev], field[dev], cfg)
    torch.cuda.synchronize()
    fit_ms = (time.perf_counter() - t0) * 1e3
    fit_launches = tfl.launches
    if fit_launches != 1 or len(rec_batch) != 1:
        raise AssertionError(f"fit_cars launched tfl_counts {fit_launches} "
                             f"times ({len(rec_batch)} recorded), not once")
    k5_replayed = replay_tfl_launches(rec_batch, "fit_cars")
    del rec_batch
    # the CPU check: car GATHER_CPU_CAR (moving, with a trajectory angle)
    # through the standing and the moving fit, on the card and the CPU
    i = GATHER_CPU_CAR
    t0 = time.perf_counter()
    local = pts[i] - fitting.masked_median(
        torch.from_numpy(pts[i]), torch.from_numpy(mask[i])).numpy()
    diffs = {}
    for name, fit in (
            ("standing", lambda d: fitting.fit_standing_car(
                torch.as_tensor(local, device=d), torch.as_tensor(
                    mask[i], device=d), tmpl[d], field[d], cfg)),
            ("moving", lambda d: fitting.fit_moving_car(
                torch.as_tensor(local, device=d), torch.as_tensor(
                    mask[i], device=d), tmpl[d], field[d],
                float(theta_est[i]), True, cfg))):
        a, b = fit(dev), fit("cpu")
        diffs[name] = {k: float((getattr(a, k).cpu() - getattr(b, k)).abs())
                       for k in ("x", "z", "theta", "loss")}
        if not (diffs[name]["x"] == 0 and diffs[name]["z"] == 0
                and diffs[name]["loss"] == 0
                and diffs[name]["theta"] <= 1e-6):
            raise AssertionError(f"gather fit card vs CPU: {diffs}")
    mov = fitting.fit_moving_car(torch.as_tensor(local, device=dev),
                                 torch.as_tensor(mask[i], device=dev),
                                 tmpl[dev], field[dev],
                                 float(theta_est[i]), True, cfg)
    if not (float(res.x[i]) == float(res.center[i, 0] + mov.x)
            and float(res.theta[i]) == float(mov.theta)):
        raise AssertionError("gather fit: the batch's car differs from "
                             "the single car's")
    cpu_s = time.perf_counter() - t0
    x, z, th = (getattr(res, k).cpu().numpy() for k in ("x", "z", "theta"))
    dx = np.abs(x - [t["x"] for t in truth])
    dz = np.abs(z - [t["z"] for t in truth])
    # (e) the harness: each standing car stored with its true box
    # (center, template dims, KITTI ry = theta - pi/2) and re-fitted alone
    out_dir = os.path.join(root, "custom_dataset")
    standing = np.flatnonzero(~moving)
    boxes = {}
    for i in standing:
        gt = np.array([truth[i]["x"], 0.9, truth[i]["z"], 3.88, 1.63, 1.526,
                       truth[i]["theta"] - np.pi / 2], np.float32)
        custom_dataset.save_pair(out_dir, f"car{i:02d}", pts[i][mask[i]], gt)
        boxes[i] = gt

    def fit_fn(points):
        one = np.zeros((1, TFL_S, 3), np.float32)
        m = np.zeros((1, TFL_S), bool)
        one[0, :len(points)], m[0, :len(points)] = points, True
        r = fitting.fit_cars(fitting.CarBatch(
            one, m, np.zeros(1, bool), np.zeros(1, np.float32),
            np.zeros(1, bool), np.ones(1, bool)), tmpl[dev], field[dev], cfg)
        return [float(r.x[0]), float(r.y[0]), float(r.z[0]), 3.88, 1.63,
                1.526, float(r.theta[0]) - np.pi / 2]

    loaded, gt_boxes, _ = custom_dataset.load_pairs(out_dir)
    if not (len(loaded) == len(standing) and all(
            np.array_equal(loaded[k], pts[i][mask[i]])
            for k, i in enumerate(standing))
            and np.array_equal(gt_boxes, np.stack([boxes[i]
                                                   for i in standing]))):
        raise AssertionError("custom_dataset: the loaded pairs differ")
    with recording_tfl() as rec_harness:
        tfl.launches = 0
        t0 = time.perf_counter()
        ious = custom_dataset.evaluate_fitting_on_pairs(out_dir, fit_fn)
        harness_s = time.perf_counter() - t0
        harness_launches = tfl.launches
    if harness_launches != len(standing):
        raise AssertionError(f"the harness launched tfl_counts "
                             f"{harness_launches} times for "
                             f"{len(standing)} cars")
    k5_replayed += replay_tfl_launches(rec_harness, "custom_dataset")
    del rec_harness
    direct = [custom_dataset.compute_pair_iou(
        [x[i], float(res.y[i]), z[i], 3.88, 1.63, 1.526,
         th[i] - np.pi / 2], boxes[i]) for i in standing]
    if not np.allclose(ious, direct, atol=1e-5):
        raise AssertionError(f"custom_dataset IoUs {ious} against the "
                             f"batch fit's {direct}")
    return {"gather": {"cars": GATHER_CARS, "grid": [cfg.n_dx, cfg.n_dz,
                                                     cfg.n_theta],
                       "fine_thetas": cfg.n_theta_fine, "ms_per_batch":
                       fit_ms, "cpu_car": GATHER_CPU_CAR,
                       "cpu_check_s": cpu_s,
                       "card_vs_cpu": diffs,
                       "max_abs_dx_m": float(dx.max()),
                       "max_abs_dz_m": float(dz.max()),
                       "tfl_launches": fit_launches},
            "custom_dataset": {"pairs": len(ious), "ious": ious,
                               "min_iou": float(min(ious)),
                               "harness_s": harness_s,
                               "tfl_launches": harness_launches},
            "tfl_launches": fit_launches + harness_launches,
            "tfl_replayed": dict(collections.Counter(
                c["shape"] for c in k5_replayed))}


def optional_stages(dev, icp_rng: int = ICP_RNG, fit_cfg=None) -> dict:
    """The labeller's optional stages on the card: (a) ICP windows, (b)
    region growing, (c) the deformable mesh, (d) the gather-field fit and
    (e) the custom-dataset harness."""
    import torch

    t0 = time.perf_counter()
    out = {"phase": "optional_stages"}
    steps = {}
    t = time.perf_counter()
    out["icp"] = icp_stage(dev, icp_rng)
    steps["icp"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out["growing"] = growing_stage(dev)
    steps["growing"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out["deformable"] = deformable_stage(dev)
    steps["deformable"] = time.perf_counter() - t
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        out.update(gather_stage(dev, root, fit_cfg))
    steps["gather_and_custom_dataset"] = time.perf_counter() - t
    out["step_seconds"] = steps
    out["seconds"] = time.perf_counter() - t0
    return out


def main() -> int:
    # one card: the first of those visible
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ("0" if visible is None
                                          else visible.split(",")[0])
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from monosowa_tpu_torch.evalkitti import native
    from monosowa_tpu_torch.models.transformer import encoder_reference_points
    from monosowa_tpu_torch.ops import _build

    # 1. env: the entry points' device resolution turns TF32 off, from
    # PyTorch's defaults; the smoke keeps its own setting, the same
    from monosowa_tpu_torch.device import resolve_device

    tf32_default = [torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32]
    resolve_device()
    tf32_entry = [torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.allow_tf32]
    if tf32_entry != [False, False]:
        raise AssertionError(f"after resolve_device TF32 is {tf32_entry} "
                             "(matmul, cudnn); the checks run without it")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    emit({"phase": "env", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": False, "allow_tf32_default": tf32_default,
          "allow_tf32_after_resolve_device": tf32_entry})

    # 2. build: one compiler per source, all started together (nvcc for
    # the kernels, the host compiler for the KITTI evaluation's library)
    def timed_eval_build():
        t_eval = time.perf_counter()
        native.build()
        return time.perf_counter() - t_eval

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS) + 1) as pool:
        eval_build = pool.submit(timed_eval_build)
        logs = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
        eval_build_s = eval_build.result()
    registers = {k: ptxas_registers(log) for k, log in logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "evalkitti_library_seconds": eval_build_s,
          "registers": registers})

    # 3. kernel vs plain at the serve and train paths' shapes
    rng = np.random.default_rng(0)
    s = sum(h * w for h, w in ENC_SHAPES)
    enc_ref = np.broadcast_to(encoder_reference_points(ENC_SHAPES)[None],
                              (BATCH, s, len(ENC_SHAPES), 2))

    def dec_ref(q):
        return np.broadcast_to(rng.uniform(0.05, 0.95, (BATCH, q, 1, 2)),
                               (BATCH, q, len(ENC_SHAPES), 2))

    def msda_cases(check):
        return {"encoder": check(rng, s, enc_ref, "encoder", dev),
                "encoder wide": check(rng, s, enc_ref, "encoder wide", dev,
                                      wide=True),
                "decoder": check(rng, 50, dec_ref(50), "decoder", dev),
                "train decoder": check(rng, TRAIN_QUERIES,
                                       dec_ref(TRAIN_QUERIES),
                                       "train decoder", dev)}

    fwd = msda_cases(check_msda)
    for res in fwd.values():
        emit({"phase": "kernel", "name": "msda_fwd",
              "registers": registers["msda_fwd"], **res})
    bwd = msda_cases(check_msda_bwd)
    for res in bwd.values():
        emit({"phase": "kernel", "name": "msda_bwd",
              "registers": registers["msda_bwd"], **res})
    # the label path's scans of 2,048 points and the bank path's of
    # 10 slots x 204 (its re-fit: 8 rows, those without a target masked)
    cov = {"rescore": check_tfl(rng, 48, 40, "rescore", dev),
           "fine": check_tfl(rng, 4, 360, "fine pass", dev),
           "bank rescore": check_tfl(rng, 48, 40, "bank rescore", dev,
                                     s=BANK_S),
           "bank re-fit": check_tfl(rng, 8, 360, "bank re-fit fine pass",
                                    dev, s=BANK_S, masked_rows=4)}
    for res in cov.values():
        emit({"phase": "kernel", "name": "tfl_counts", **res})
    fetch = {f"{label} {form}": check_row_fetch(form, label, dev)
             for label in RF_ROWS for form in ("direct", "staged")}
    for res in fetch.values():
        emit({"phase": "kernel", "name": "row_fetch", **res})
    # 3b. msda_bf16: the kernels' bf16 forms (bf16 value rows, float32
    # sums) against their plain versions on the same bf16 value, at the
    # encoder's shape and the decoder's Q = 50 and 550, beside the float32
    # forms' times of this run
    def bf16_cases(check):
        return {"encoder": check(rng, s, enc_ref, "encoder", dev,
                                 bf16=True),
                "decoder": check(rng, 50, dec_ref(50), "decoder", dev,
                                 bf16=True),
                "train decoder": check(rng, TRAIN_QUERIES,
                                       dec_ref(TRAIN_QUERIES),
                                       "train decoder", dev, bf16=True)}

    fwd16, bwd16 = bf16_cases(check_msda), bf16_cases(check_msda_bwd)
    for name, runs16, runs32 in (("msda_fwd", fwd16, fwd),
                                 ("msda_bwd", bwd16, bwd)):
        for key, res in runs16.items():
            emit({"phase": "msda_bf16", "name": name + "_bf16",
                  "registers": registers[name], **res,
                  "float32": {k: runs32[key][k] for k in (
                      "ms", "ms_launched_from_python", "bound_ms",
                      "compulsory_bytes")}})
    # hand the plain versions' large temporaries back, so the phases below
    # start from an empty allocator cache
    torch.cuda.empty_cache()

    # 4. serve, float32 and under the shipped config's "auto" (bf16)
    srv = serve(dev)
    emit(srv)
    srv16 = serve(dev, bf16=True)
    srv16["float32_serve"] = {k: srv[k] for k in (
        "forward_ms_per_image", "serve_ms_per_image", "peak_mem_GB")}
    emit(srv16)

    # 5. train, float32 and bf16
    trn = train(dev)
    emit(trn)
    trn16 = train_bf16(dev)
    trn16["float32_train"] = {k: trn[k] for k in (
        "train_step_ms_mean", "peak_mem_GB")}
    emit(trn16)

    # 5a. detector_variants: two_stage, DAB + learned + RGB-D, DN-DETR
    dvr = detector_variants(dev)
    dv_fwd, dv_bwd, dv_tall = dvr.pop("_fwd"), dvr.pop("_bwd"), \
        dvr.pop("_tall")
    dvr["train_phase_step_ms_mean"] = trn["train_step_ms_mean"]
    emit(dvr)
    for name, runs in (("msda_fwd", dv_fwd), ("msda_bwd", dv_bwd)):
        for res in runs.values():
            emit({"phase": "kernel", "name": name, **res})
    for res in dv_tall.values():
        emit({"phase": "kernel", "name": "lap_jv", **res})
    fwd.update(dv_fwd)
    bwd.update(dv_bwd)
    torch.cuda.empty_cache()

    # 5b. train_add, float32 and under the bf16 policy
    tra = train_add(dev)
    recorded = tra.pop("_lap_costs")
    tra["train_phase_step_ms_mean"] = trn["train_step_ms_mean"]
    emit(tra)
    tra16 = train_add_bf16(dev)
    tra16["float32_train_add_step_ms_mean"] = tra["train_step_ms_mean"]
    emit(tra16)
    torch.cuda.empty_cache()

    # 5d. msda_onehot: msda_backend onehot (and mxu, pallas) under float32
    # reads bf16 value rows: the bf16 kernels
    onehot = msda_onehot(dev)
    oh_fwd, oh_bwd = onehot.pop("_fwd"), onehot.pop("_bwd")
    emit(onehot)
    for name, runs in (("msda_fwd_bf16", oh_fwd), ("msda_bwd_bf16", oh_bwd)):
        for res in runs.values():
            emit({"phase": "kernel", "name": name, **res})
    fwd16.update(oh_fwd)
    bwd16.update(oh_bwd)
    torch.cuda.empty_cache()

    # 5e. ddp: a world of one on nccl, two processes on gloo on the card
    dpr = ddp(dev)
    dpr["nvidia_smi"] = smi
    emit(dpr)
    torch.cuda.empty_cache()

    # 5c. the LAP kernels on the generator's problems and on the costs a
    # train_add step solved
    lap_runs = lap_phase(dev, recorded)
    del recorded
    for res in lap_runs.values():
        for name in ("lap_jv", "lap_auction"):
            emit({"phase": "kernel", "name": name, **res[name]})
    # the tall form on the two-stage encoder match (detector_variants)
    lap_runs.update({f"{key} (tall form)": {"lap_jv": res}
                     for key, res in dv_tall.items()})
    torch.cuda.empty_cache()

    # 6. fit
    emit(fit_check(dev))

    # 7. label
    lbl = label(dev)
    host_labels = lbl.pop("_labels")
    emit(lbl)

    # 7b. label_bank
    lbk = label_bank(dev, host_labels)
    emit(lbk)

    # 7c. label_k360: the CLI's actions on a KITTI-360 tree
    k3 = label_k360(dev)
    emit(k3)
    torch.cuda.empty_cache()

    # 7d. label_lidar: velodyne scans, strict hidden standing, pedestrians
    lld = label_lidar(dev)
    emit(lld)
    torch.cuda.empty_cache()

    # 8. bench
    bch = bench_row_fetch()
    emit(bch)

    # 9. epoch
    epc = epoch(dev)
    emit(epc)
    torch.cuda.empty_cache()

    # 10. the model zoo: masks and depth through the driver's actions, then
    # labels from the caches they wrote
    with tempfile.TemporaryDirectory() as zroot:
        frames = zoo_frames(MASK_FRAMES)
        msk = masks(dev, zroot, frames)
        fwd["pixel decoder"] = msk.pop("pixel_decoder_k1")
        emit(msk)
        emit({"phase": "kernel", "name": "msda_fwd",
              "registers": registers["msda_fwd"], **fwd["pixel decoder"]})
        smp = sam(dev, zroot, frames)
        fwd["pixel decoder (sam)"] = smp.pop("pixel_decoder_k1")
        emit(smp)
        emit({"phase": "kernel", "name": "msda_fwd",
              "registers": registers["msda_fwd"],
              **fwd["pixel decoder (sam)"]})
        dep = depth(dev, zroot, frames)
        emit(dep)
        itl = images_to_labels(dev, zroot, frames)
        emit(itl)
        # raw Waymo segments through the driver (the masks phase's
        # Mask2Former checkpoint on the pair canvases)
        wmo = waymo(dev, zroot, os.path.join(zroot, "zoo",
                                             "mask2former.npz"))
        fwd["waymo canvas"] = wmo.pop("canvas_k1")
        emit(wmo)
        emit({"phase": "kernel", "name": "msda_fwd",
              "registers": registers["msda_fwd"], **fwd["waymo canvas"]})

    # 10b. optional_stages: ICP, region growing, the deformable mesh, the
    # gather-field fit, the custom-dataset harness
    ops_ = optional_stages(dev)
    ops_["nvidia_smi"] = smi
    emit(ops_)
    torch.cuda.empty_cache()

    # 11. kernels; library_ms is None where no one PyTorch call computes the
    # kernel's function (MSDA, its gradient, the two-way coverage)
    def entry(name, source, replaces, launches, runs, first="encoder"):
        keys = ("shape", "max_abs_err", "ms", "ms_launched_from_python",
                "plain_ms", "bound_ms", "bound_by", "library_ms")
        enc = runs[first]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(launches.values()),
                "launches_by_path": launches,
                "max_abs_err": enc["max_abs_err"], "ms": enc["ms"],
                "plain_ms": enc["plain_ms"], "bound_ms": enc["bound_ms"],
                "bound_by": enc["bound_by"],
                "library_ms": enc.get("library_ms"),
                "ms_launched_from_python": enc.get("ms_launched_from_python"),
                "at": enc["shape"],
                "other_shapes": [{k: r.get(k) for k in keys}
                                 for key, r in runs.items() if key != first]}

    def lap_entry(name, replaces, launches):
        runs = {key: res[name] for key, res in lap_runs.items()
                if name in res}
        out = entry(name, "monosowa_tpu_torch/ops/csrc/lap.cu", replaces,
                    launches, runs, "train step, final layer")
        out["host_route_ms"] = runs["train step, final layer"][
            "host_route_ms"]
        return out

    kernels = [
        entry("msda_fwd", "monosowa_tpu_torch/ops/csrc/msda_fwd.cu",
              "monosowa_tpu/ops/msda_mxu.py:378 (K1 ms_deform_attn_mxu); "
              "monosowa_tpu/ops/msda_pallas.py:71 (K4 "
              "ms_deform_attn_pallas)",
              {"serve": srv["msda_launches"],
               "train": trn["msda_fwd_launches"],
               "train_add": tra["launches"]["msda_fwd"],
               "detector_variants": dvr["launches"]["msda_fwd"],
               "ddp": dpr["launches"]["msda_fwd"],
               "epoch": epc["msda_fwd_launches"],
               "masks": msk["msda_launches"],
               "sam": smp["msda_launches"],
               "waymo": wmo["msda_launches"]}, fwd),
        entry("msda_bwd", "monosowa_tpu_torch/ops/csrc/msda_bwd.cu",
              "monosowa_tpu/ops/msda_mxu.py:306 (K2 msda_gdot_mxu); "
              "monosowa_tpu/ops/msda_mxu.py:544 (K3 msda_dvalue_mxu)",
              {"train": trn["msda_bwd_launches"],
               "train_add": tra["launches"]["msda_bwd"],
               "detector_variants": dvr["launches"]["msda_bwd"],
               "ddp": dpr["launches"]["msda_bwd"],
               "epoch": epc["msda_bwd_launches"]}, bwd),
        entry("msda_fwd_bf16", "monosowa_tpu_torch/ops/csrc/msda_fwd.cu",
              "monosowa_tpu/ops/msda_mxu.py:378 (K1 ms_deform_attn_mxu, "
              "bf16 quad rows :235); monosowa_tpu/ops/msda_pallas.py:71 (K4 "
              "ms_deform_attn_pallas, bf16 value :98)",
              {"serve_bf16": srv16["msda_launches"],
               "train_bf16": trn16["launches"]["msda_fwd_bf16"],
               "train_add_bf16": tra16["launches"]["msda_fwd_bf16"],
               "msda_onehot": onehot["launches"]["msda_fwd_bf16"]}, fwd16),
        entry("msda_bwd_bf16", "monosowa_tpu_torch/ops/csrc/msda_bwd.cu",
              "monosowa_tpu/ops/msda_mxu.py:306 (K2 msda_gdot_mxu, bf16 quad "
              "rows :331); monosowa_tpu/ops/msda_mxu.py:544 (K3 "
              "msda_dvalue_mxu, cast to value's dtype :635)",
              {"train_bf16": trn16["launches"]["msda_bwd_bf16"],
               "train_add_bf16": tra16["launches"]["msda_bwd_bf16"],
               "msda_onehot": onehot["launches"]["msda_bwd_bf16"]}, bwd16),
        entry("tfl_counts", "monosowa_tpu_torch/ops/csrc/tfl_counts.cu",
              "monosowa_tpu/ops/tfl_pallas.py:67 (K5 "
              "binary_both_way_counts_pallas)",
              {"label": lbl["tfl_launches"],
               "label_bank": lbk["tfl_launches"],
               "label_k360": k3["launches"],
               "label_lidar": lld["tfl_launches"],
               "images_to_labels": itl["tfl_launches"],
               "waymo": wmo["tfl_launches"],
               "optional_stages": ops_["tfl_launches"]},
              {**cov, **k3["tfl_new_shapes"]}, "rescore"),
        entry("row_fetch", "monosowa_tpu_torch/ops/csrc/row_fetch.cu",
              "tools/bench_gather_micro.py:61 (K6 run; bodies _kernel_gather "
              ":26, _kernel_onehot :45)",
              {"bench": bch["row_fetch_launches"]}, fetch, "K6 direct"),
        lap_entry("lap_jv", "monosowa_tpu/ops/lap.py:54 solve_lap_jv "
                  "(XLA, not Pallas)",
                  {"train": trn["lap_jv_launches"],
                   "train_add": tra["launches"]["lap_jv"],
                   "train_add_bf16": tra16["launches"]["lap_jv"],
                   "msda_onehot": onehot["launches"]["lap_jv"],
                   "ddp": dpr["launches"]["lap_jv"],
                   "detector_variants": dvr["launches"]["lap_jv"],
                   "epoch": epc["lap_jv_launches"]}),
        lap_entry("lap_auction", "monosowa_tpu/ops/lap.py:219 "
                  "solve_lap_auction (XLA, not Pallas)",
                  {"train (auction matcher)":
                   trn["lap_auction_launches_auction_step"]}),
    ]
    idle = [k["name"] for k in kernels if not k["launches"] > 0]
    if idle:
        raise AssertionError(f"kernels the main paths never launched: {idle}")
    emit({"kernels": kernels})
    if torch.cuda.device_count() != 1:
        raise AssertionError(f"{torch.cuda.device_count()} cards visible")
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
