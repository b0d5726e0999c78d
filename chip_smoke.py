"""Chip smoke test of the PyTorch + CUDA port (multipathnet_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):
  1. device: a CUDA device must be present; prints nvidia-smi's name and
     power limit.
  2. build: compiles csrc/ with nvcc (ops/_build.py) and prints the time,
     ptxas's report and each pool and gradient instance's registers, local
     memory (spills) and static/dynamic shared memory
     (cudaFuncGetAttributes).
  3. kernels: K1 (window_pool_multi) and K2 (resident_pool) against their
     plain PyTorch versions on random 640^2 c3/c4/c5 maps in float32
     (atol 1e-4) and bfloat16 (rtol 1e-2, atol 1e-2: one bf16 rounding of a
     float32 sum; the share of outputs that differ at all is printed), at
     the main path's shapes (8 images x 1000 proposals: K1 8000 views x 3
     levels, K2 8 x 3000 views) and on 2 images with 2048 ROIs at every
     pyramid scale, border ROIs included; then both timed against their
     plain versions on the main path's bf16 inputs, with the rate at which
     they read windows.
  4. main path: Detector on `multipath_vgg16_batched` (bf16 VGG-16,
     8 images x 1000 proposals, 640^2 canvas, weights normal * 0.02 drawn
     on the card from a seeded generator): first-call time, steady img/s
     over 10 batches, a profiler breakdown of one batch; both kernels must
     have launched, outputs finite with shapes (8, 100, 4) / (8, 100).
     Then the bias passes (models/layers.py adds each bias after its
     product, as flax does): every biased layer's output of one batch
     recorded, and the time of its bias add, head and trunk apart.
  5. NMS under load: the same with eval.score_threshold = 0, so NMS sees
     candidates (random weights put every class near 1/81 < 0.05);
     detections must be > 0.
  6. train kernels: at the train path's geometry (multipath_vgg16_train:
     8 images x 64 ROIs, 640^2, C = 512), K1's forward on its two train
     groups (512 1x views over c3+c4+c5; 1536 context views over c5 alone,
     the single-level instance eval never launches) against its plain
     version in float32 (atol 1e-4) and bfloat16 (rtol/atol 1e-2), each
     timed against it; K3 (window_grad) and K4 (window_rmw_grad) against
     their plain versions (K3 on c5 with all 2048 foveal views and on c4
     with the 512 1x views, K4 on c3 with the 512 1x views) on random
     float32 cotangents, with a float32 output (atol 1e-4 x max(1, max
     |g|)) and the bf16 output the path writes (within one bf16 step of
     the plain float32 sum rounded), each output equal bit for bit over two
     calls, then each timed against its plain version in bf16; and
     WindowPoolMulti's backward on the card (K3 on c5 and c4, K4 on c3, no
     placement GEMM) against autograd through the plain forward.
  7. training: Trainer on `multipath_vgg16_train` at full width (VGG-16,
     conv1-2 frozen, float32 parameters, bf16 compute, batch 8 at 640^2,
     1000 proposals and 64 sampled ROIs per image), weights normal * 0.02
     from a seeded generator on the card, a synthetic batch from seed 0:
     the first step's time, 10 timed steps (ms/step, img/s), peak device
     memory and a profiler breakdown of one step. Every loss finite, fg
     sampled, K1/K3/K4 launched (K3 three times a step: c5 twice, c4) and
     K2 and the placement GEMMs not, frozen blocks bit-identical, conv3_1's
     gradient nonzero. Then two steps from one saved state on one batch,
     under the default settings and under cudnn.deterministic: whether
     loss, gradients and parameters come out equal, and the
     deterministic step's ms/step.
  8. int8 epilogue: K1 and K2 with the skip bias (the quant instances) at
     the main path's shapes (K1 8000 views x 3 levels, K2 8 x 3000 views,
     C = 512), float32 and bfloat16: bit for bit against the plain epilogue
     (roi_pool.quant_view_ref) applied to the same kernel's own pooled
     output, and against the fully plain version codes within 1 and scales
     within 1e-5 (float32) / 1e-2 (bfloat16) relative; in bf16 the share of
     pooled outputs that differ from the plain version is printed, and each
     kernel timed against its plain version and against the kernel without
     the epilogue followed by the plain epilogue.
  9. int8 serving: Detector on `multipath_vgg16_int8` at 8 x 1000
     proposals, 640^2: float32 weights normal * 0.02 drawn on the card
     from a seeded generator, quantized by Detector's load-time transform
     (bench.py's flow); first-call time, steady img/s over 10 batches, peak
     device memory, a profiler breakdown of one batch. The quant K1/K2 must
     have launched and K1/K2 without the epilogue not; outputs finite with
     shapes (8, 100, 4) / (8, 100).
 10. int8 + truncated-SVD serving: the same on `multipath_vgg16_int8_svd`,
     the factored layout (fc6 rank 1024, fc7 rank 256) drawn directly in
     float32, as bench.py does (the load-time SVD is tested on the CPU).
     Then phase 4's bf16 img/s is printed beside both.
 11. single-level pools: K5 (window_pool) on the main path's 8000 1x views
     (bench.py's 8 x 1000 proposals, 640^2) over the stacked 8-image c3
     pyramid of a random C = 512 map, against its plain version in float32
     (atol 1e-4) and bfloat16 (rtol/atol 1e-2), timed against it in bf16.
     Then the entry points as a path of their own (`pool_api`, launches
     counted from 0): batched_pyramid_pool on those views in bf16, and the
     three differentiable forms in float32 with their backward, each
     through K4 (accumulate_windows): batched_pyramid_pool(trainable) on
     the same views, batched_pyramid_pool_resident(trainable) on the main
     path's 8 x 3000 context views over c5, and WindowPoolMulti without
     rows_list on the train geometry (512 1x views over c3+c4+c5). Each
     gradient is held against autograd through the plain forward, float32,
     atol 1e-4 x max(1, max |g|) (GRAD_ATOL says why).
 12. window-read probe P (tools/probe_int8_window_dma.py of the port) at
     its tool's shapes (32000 views over a (4096, 160, 512) buffer), bf16
     and int8 windows: the kernel against its plain version (rtol/atol
     1e-2, a bf16 output), each timed against it; then the tool's `bench`
     for each dtype as the path `probe` (launches counted from 0).
 13. dataset to AP (`dataset_eval`): synthetic.generate writes a COCO split
     under build/ (32 PNG images of 600^2, 80 categories, up to 4 objects
     and 1000 proposals per image, seed 0); Tester runs
     `multipath_vgg16_batched` on it (batch 8, 640^2, weights as in phase
     4, score_threshold 0). After a one-batch warm-up, Tester.test timed
     end to end (decode, padding, copy, detect, conversion, evaluation:
     split img/s) with the launches counted; then collect_detections
     and the serial loop below timed in turns, eval_batches alone, the evaluator alone and the device's busy
     share over collect_detections under the profiler. Every metric
     finite, K1/K2 launched, the detections > 0 and equal, bit for bit, to
     a serial loop of detect_batch on synchronously copied eval_batches.
 14. training to AP (`train_eval`), (a)-(c) under cudnn.deterministic:
     (a) the reference's golden overfit at `tiny` (8 images of 64^2, 5
     classes, batch 2, 30 epochs through epoch_on_device) for init seeds
     0-4, AP50 before and after each; the median must reach AP50 > 0.5, a
     rise of more than 0.3 and a last loss under 0.75 x the first, every
     loss finite; (b) cli.train on a synthetic `tiny` split (6 steps, a
     checkpoint every 2), --resume to 9, and cli.eval --json on the
     checkpoints equal to an in-process Tester; (c) 2 steps, a checkpoint,
     a fresh Trainer restored from it and 1 step against 3 steps straight:
     loss, parameters, momentum and generator state equal bit for bit;
     (d) `multipath_vgg16_train` at full width on phase 13's split through
     epoch_on_device: 6 steps (ms/step, img/s beside phase 7's), losses
     finite, K1/K3/K4 launched, one more step profiled.
 15. the reference's ResNet and AlexNet models (`resnet`): (a) Detector on
     `multipath_resnet18_integral` at 8 x 1000 proposals (bench.py's
     generator), 640^2, every parameter normal * 0.02 and then the trunk,
     BN statistics included (variances from a positive draw), from a
     seeded torchvision-layout state dict through import_weights: first
     call, 10 timed batches (img/s), peak memory, one profiled batch
     (device ms, busy share) and the frozen-BN passes timed alone; K1/K2
     must have launched, detections finite with the right shapes; (b) the
     same for `sharpmask_multipath_e2e`'s ResNet-50 detector and that
     preset with ResNet-101, 3 timed batches each; (c) Trainer on
     `multipath_resnet18_integral` at full width (batch 8, 640^2, 64 ROIs
     per image, stages 1-2 frozen), 1 + 5 steps (ms/step), losses finite,
     K1/K3/K4 launched, every BN buffer and frozen parameter bit-unchanged,
     one profiled step, two steps from one state equal under
     cudnn.deterministic; (d) Detector on the bf16 preset with the AlexNet
     trunk, one batch: finite detections and c3/c4/c5 of the right shapes.
 16. `multipath_vgg16_reference` (`reference_exact`: max pooling, caffe_bgr,
     the exact route in plain ops): every weight from a seeded state dict
     in the reference's torch contract (features.N, reduce, fc6.{i},
     fc7.{i}, classifier.{k}, bbox) through import_weights; Detector at 8 x
     1000 proposals, 640^2: first call, 3 timed batches (ms/batch), peak
     memory, one profiled batch, no window kernel launched; then on one
     image's raw maps and 64 ROIs the max pooling of each view x level
     group on the card equal to the CPU's bit for bit, the whole pool with
     its bf16 1x1 reduces and level sums within four bf16 steps (at the
     largest magnitude) of the CPU's, and the
     windowed route equal to the exact one, bit for bit, on 512 views up to
     28 px (bins within one base cell) at every level.
 17. config 5 (`sharpmask`: `sharpmask_multipath_e2e`, SharpMask proposals
     into the ResNet-50 detector), launches counted over the phase: (a) a
     ProposalTrainer's SharpMaskNet at full width (ResNet-50 trunk from
     phase 15's seeded torchvision-layout state dict, the rest normal *
     0.02; neck c5, 40 x 40 x 12 = 19,200 anchors an image) generates the
     top 1000 proposals of 8 images of 640^2 with the cascade and 28 x 28
     masks, and phase 15's ResNet-50 Detector runs on them: ms a batch for
     generation with and without masks, detection, end to end (img/s),
     peak memory, one profiled batch (busy share); K1/K2 must launch; (b)
     the eval ("pyramid") and training ("direct") mask decodes of 64 ROIs
     held to tests/test_torch_sharpmask.py's bar; (c) the proposal train
     step at full width on a synthetic batch with mask targets: 5 steps
     after a first (ms/step), every loss finite, a profiled step, two
     steps from one state equal under cudnn.deterministic; (d) the `tiny`
     proposal overfit of the reference's tests/test_sharpmask.py for init
     seeds 0-4, its bar held on the median; (e) cli.train --proposal-net,
     cli.export_proposals --with-masks, cli.eval on the exported file and
     cli.demo --proposal-source sharpmask, at `tiny`.
 18. serving over HTTP (`serve`): a float `multipath_vgg16_int8`
     checkpoint (weights normal * 0.02), cli.export_serving --quant int8,
     cli.serve --warmup in a process of its own on localhost: 20 requests
     of one 640^2 image with 1000 proposals and 2 of 8 images (latency
     p50/p90/p99, the server's JSON decode and detection ms), the
     server's kernel launches over them from /healthz (the int8 K1/K2
     must launch), the detections equal to a Detector on the bundle
     called in this process, and an oversized image answered 400.
 19. the mesh (`parallel`), ranks launched through core/mesh.spawn, each
     rank's launches counted: (a) one NCCL rank, mesh (1, 1): one
     `multipath_vgg16_train` step (phase 7's weights and batch, warmup off,
     cudnn.deterministic) equal to the plain Trainer's bit for bit (loss,
     gradients, parameters), and a Detector batch of phase 4 equal to the
     plain Detector's, and a Tester on phase 13's split at batch 4 for
     (c); (b)-(e) two ranks, sharing the one card through
     gloo (NCCL, a card each, where there are two): (b) the same step on a
     (2, 1) mesh, 4 images a rank, 5 more steps timed (not a speed-up on
     one card), each rank's peak memory, the loss within rel 1e-2 of (a)'s
     and the largest parameter difference, two steps from one state equal,
     K1/K3/K4 launched on every rank and K2 and the placement GEMMs not;
     the `tiny` float32 loss within rel 1e-5 of one rank's; (c) Tester on
     phase 13's split at (2, 1): AP/AP50/AP75 within 1e-6 of phase 13's,
     the detections equal bit for bit to (a)'s rank's Tester at batch 4
     (each rank's share of a batch of 8) and, beside phase 13's at batch
     8, the same images and counts with each image's sorted scores within
     5e-3 (the share that differ printed), the images each rank decoded,
     K1 and K2 on each rank; (d) tensor-parallel serving at (1, 2), 8 x
     1000 proposals: `multipath_vgg16_int8` equal to the unsharded int8
     head bit for bit (scores, boxes, detections), fc6's local kernel_i8
     half its columns, the quant K1/K2 launched; `multipath_vgg16_batched`
     probabilities within 1e-2; each timed over 5 batches; (e) `tiny`
     float32 training at (1, 2) against (2, 1) within rel 1e-4, both timed
     over 5 steps, the (1, 2) checkpoint restored here on one device bit
     for bit and a step after it.
The line before the last is a JSON object with each kernel's launches (the
runs of phases 4, 7, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18 and 19, each
counted from 0, and their sum),
error, times and bound: for the pool kernels the larger of the bytes they
must move (each pyramid cell under a window, the geometry and the output
once) over 3.35 TB/s and their operations (float32 ones over 67 TF/s; the
bf16 body's W2 GEMM, 2 x 49 x 160 per view, level and channel, over the
989 TF/s of the bf16 tensor cores); for P the
distinct cells under its windows and its output over 3.35 TB/s, with the
int8 numbers beside the bf16 ones. The last line is {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import io
import json
import os
import shutil
import subprocess
import time

import numpy as np
import torch

from multipathnet_tpu_torch.cli import common, demo, export_proposals
from multipathnet_tpu_torch.cli import eval as eval_cli
from multipathnet_tpu_torch.cli import export_serving
from multipathnet_tpu_torch.cli import train as train_cli
from multipathnet_tpu_torch.core.config import preset
from multipathnet_tpu_torch.core.mesh import spawn
from multipathnet_tpu_torch.data import synthetic
from multipathnet_tpu_torch.data.coco import CocoLoader
from multipathnet_tpu_torch.data.pipeline import DetectionPipeline
from multipathnet_tpu_torch.data.proposals import ProposalStore
from multipathnet_tpu_torch.eval.coco_eval import CocoEvaluator
from multipathnet_tpu_torch.eval.detect import Detector, detect_batch
from multipathnet_tpu_torch.eval.tester import (Tester, detections_to_coco,
                                                groundtruth_to_coco)
from multipathnet_tpu_torch.data import transforms
from multipathnet_tpu_torch.models import convert, import_weights, layers
from multipathnet_tpu_torch.models.multipath import build_model
from multipathnet_tpu_torch.models.sharpmask import generate_proposals
from multipathnet_tpu_torch.ops import _build
from multipathnet_tpu_torch.ops import roi as roi_ops
from multipathnet_tpu_torch.ops import roi_pool, roi_pyramid
from multipathnet_tpu_torch.ops.boxes import expand
from multipathnet_tpu_torch.tools import mesh_runs
from multipathnet_tpu_torch.tools import probe_int8_window_dma as probe
from multipathnet_tpu_torch.train.checkpoint import Checkpointer
from multipathnet_tpu_torch.train.loop import (Batch, Trainer,
                                               restore_train_state,
                                               snapshot_train_state)
from multipathnet_tpu_torch.train.proposal import ProposalTrainer

# every model path pools in bf16, which runs the tensor-core body; the
# float32 body (csrc/roi_window_pool.cu) is checked in phases 3, 6, 8, 11
POOL_SOURCE = "multipathnet_tpu_torch/csrc/roi_window_pool_wgmma.cu"
GRAD_SOURCE = "multipathnet_tpu_torch/csrc/roi_window_grad.cu"
PROBE_SOURCE = "multipathnet_tpu_torch/csrc/window_read_probe.cu"
PALLAS = "multipathnet_tpu/ops/roi_pallas.py"
# name -> (source, the TPU kernel it replaces, wrapper, its launch counter)
KERNELS = {
    "window_pool_multi": (POOL_SOURCE, f"{PALLAS}:472",
                          roi_pool.window_pool_multi, "launches"),
    "resident_pool": (POOL_SOURCE, f"{PALLAS}:940", roi_pool.resident_pool,
                      "launches"),
    "window_pool_multi_quant": (POOL_SOURCE, f"{PALLAS}:536",
                                roi_pool.window_pool_multi,
                                "quant_launches"),
    "resident_pool_quant": (POOL_SOURCE, f"{PALLAS}:977",
                            roi_pool.resident_pool, "quant_launches"),
    "window_grad": (GRAD_SOURCE, f"{PALLAS}:659", roi_pool.window_grad,
                    "launches"),
    "window_rmw_grad": (GRAD_SOURCE, f"{PALLAS}:745",
                        roi_pool.window_rmw_grad, "launches"),
    "window_pool": (POOL_SOURCE, f"{PALLAS}:113", roi_pool.window_pool,
                    "launches"),
    "window_read_probe": (PROBE_SOURCE, "tools/probe_int8_window_dma.py:30",
                          probe.window_read_probe, "launches"),
}


def reset_launches() -> None:
    for _, _, fn, counter in KERNELS.values():
        setattr(fn, counter, 0)


def read_launches() -> dict:
    return {name: getattr(fn, counter)
            for name, (_, _, fn, counter) in KERNELS.items()}


LEVELS = (("c3", 4), ("c4", 8), ("c5", 16))
CONTEXT = (1.5, 2.0, 4.0)


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def make_inputs(batch: int, proposals: int, canvas: int, seed: int = 0):
    """bench.py's generator (make_inputs): uint8 images, full-canvas valid
    extents, proposals of 16 px to 0.3 x canvas."""
    rng = np.random.default_rng(seed)
    b, p_, s = batch, proposals, canvas
    images = rng.integers(0, 255, (b, s, s, 3), dtype=np.uint8)
    src_hws = np.full((b, 2), float(s), np.float32)
    x1 = rng.uniform(0, s * 0.7, (b, p_)).astype(np.float32)
    y1 = rng.uniform(0, s * 0.7, (b, p_)).astype(np.float32)
    w = rng.uniform(16, s * 0.3, (b, p_)).astype(np.float32)
    h = rng.uniform(16, s * 0.3, (b, p_)).astype(np.float32)
    boxes = np.stack([x1, y1, x1 + w, y1 + h], -1)
    return images, src_hws, boxes, np.ones((b, p_), bool)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn over `iters` runs, CUDA events, warmed up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def alternate_ms(plain, kernel, iters_plain: int, iters_kernel: int):
    """Time plain and kernel in turns (plain, kernel, kernel, plain) and
    average each one's two readings."""
    p1 = cuda_ms(plain, iters_plain)
    k1 = cuda_ms(kernel, iters_kernel)
    k2 = cuda_ms(kernel, iters_kernel)
    p2 = cuda_ms(plain, iters_plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


# ---------------------------------------------------------------- bounds ---

HBM_BYTES_PER_MS = 3.35e9     # H100 SXM, 3.35 TB/s
F32_OPS_PER_MS = 67e9         # H100 SXM float32 on the CUDA cores, 67 TF/s
BF16_OPS_PER_MS = 989e9       # H100 SXM bf16 dense tensor cores, 989 TF/s
# per view and level: row0, x0 (int32), wy (7 x 10), wx (7 x 16) float32
GEOMETRY_BYTES = 4 + 4 + 4 * 7 * 10 + 4 * 7 * 16
POOL_OPS = 2 * 1610           # per view, level and channel: the separable
#                               contraction's FMAs (csrc/roi_window_pool.cu)
W2_OPS = 2 * 49 * 160         # the same for the bf16 body's W2 GEMM
#                               (csrc/roi_window_pool_wgmma.cu)
EPILOGUE_OPS = 5              # per output element: bias add, ReLU, max,
#                               divide, round


def bound(n_bytes, n_ops, n_bf16_ops=0):
    """The least time the card could take, in ms, and what sets it: the
    larger of the bytes over the HBM rate and the operations, float32 ones
    over the CUDA cores' peak and bf16 tensor-core ones over theirs (two
    units that can run at once, so the larger of their two times)."""
    t_bytes = n_bytes / HBM_BYTES_PER_MS
    t_ops = max(n_ops / F32_OPS_PER_MS, n_bf16_ops / BF16_OPS_PER_MS)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def window_cells(row0, x0, n_rows, wmax) -> int:
    """The distinct cells of an (n_rows, wmax) buffer under the 10 x 16
    windows at (row0, x0): what these views need read."""
    dev = row0.device
    mask = torch.zeros((n_rows, wmax), dtype=torch.bool, device=dev)
    ys = row0.long()[:, None] + torch.arange(10, device=dev)
    xs = x0.long()[:, None] + torch.arange(16, device=dev)
    mask[ys[:, :, None], xs[:, None, :]] = True
    return int(mask.sum())


def pool_bound(flats, row0s, x0s, quant: bool):
    """bound() of one K1 or K2 call on these inputs: each pyramid cell
    under a window read once, the geometry read once, the (N, 7, 7, C)
    output written once (int8 codes, one float32 scale per view and the
    bias read with the epilogue); per view, level and channel POOL_OPS
    float32 operations (the float32 body) or W2_OPS bf16 tensor-core ones
    (the bf16 body), plus EPILOGUE_OPS float32 operations per output
    element with the epilogue. K2's per-image pyramids (B, rows, Wmax, C)
    take image-relative rows."""
    c, size = flats[0].shape[-1], flats[0].element_size()
    n = row0s[0].numel()
    cells = 0
    for flat, row0, x0 in zip(flats, row0s, x0s):
        if flat.dim() == 4:
            b, rows = flat.shape[:2]
            row0 = row0 + torch.arange(b, device=row0.device)[:, None] * rows
        wmax = flat.shape[-2]
        cells += window_cells(row0.reshape(-1), x0.reshape(-1),
                              flat.numel() // (wmax * c), wmax)
    out = n * 49 * c + n * 4 + c * size if quant else n * 49 * c * size
    views = n * len(flats) * c
    bf16 = flats[0].dtype == torch.bfloat16
    return bound(cells * c * size + n * len(flats) * GEOMETRY_BYTES + out,
                 (0 if bf16 else views * POOL_OPS)
                 + (n * 49 * c * EPILOGUE_OPS if quant else 0),
                 views * W2_OPS if bf16 else 0)


def window_read_gb_s(flats, row0s, ms: float) -> float:
    """The rate at which one K1/K2/K5 call of `ms` reads its windows:
    every view's L (10, 16, C) windows, counted each time a view reads one
    (neighbouring views read cells again), in GB/s."""
    c, size = flats[0].shape[-1], flats[0].element_size()
    return row0s[0].numel() * len(flats) * 160 * c * size / ms / 1e6


def grad_bound(gout, out_numel: int, out_size: int):
    """bound() of one K3 or K4 call: the float32 cotangent and the geometry
    read once, the whole gradient buffer written once in the dtype the
    path writes (out_size bytes a value); POOL_OPS per view and channel
    (the transposed contraction)."""
    n, c = gout.shape[0], gout.shape[-1]
    return bound(gout.numel() * 4 + n * GEOMETRY_BYTES + out_numel * out_size,
                 n * c * POOL_OPS)


def log_pool_instances() -> None:
    """Phase 2: each pool and gradient instance's registers, local memory
    (spills) and shared memory, from cudaFuncGetAttributes
    (mpn_pool_kernel_attrs, mpn_grad_kernel_attrs)."""
    attrs = (ctypes.c_int * 5)()
    for out_bf16 in (0, 1):
        rc = _build.kernels().mpn_grad_kernel_attrs(out_bf16,
                                                    ctypes.addressof(attrs))
        require(rc == 0, f"mpn_grad_kernel_attrs: cudaError {rc}")
        regs, local, static, dynamic, threads = attrs
        log(f"[build] K3/K4 gradient body, {'bf16' if out_bf16 else 'float32'}"
            f" output: {regs} registers, {local} B local memory (spills), "
            f"{static} B static + {dynamic} B dynamic shared memory, at most "
            f"{threads} threads per block")
    for is_bf16, body in ((1, "bf16 tensor-core"), (0, "float32 CUDA-core")):
        for levels in (1, 2, 3):
            for quant in (0, 1):
                rc = _build.kernels().mpn_pool_kernel_attrs(
                    is_bf16, levels, quant, ctypes.addressof(attrs))
                require(rc == 0, f"mpn_pool_kernel_attrs: cudaError {rc}")
                regs, local, static, dynamic, threads = attrs
                log(f"[build] pool {body} body, L = {levels}"
                    f"{', int8 epilogue' if quant else ''}: {regs} registers,"
                    f" {local} B local memory (spills), {static} B static + "
                    f"{dynamic} B dynamic shared memory, at most {threads} "
                    f"threads per block")


# ------------------------------------------------------------- phase 3 ---

def random_levels(batch, canvas, channels, gen, dtype):
    return {name: (torch.randn((batch, canvas // s, canvas // s, channels),
                               generator=gen, device="cuda").to(dtype), s)
            for name, s in LEVELS}


def border_and_scale_rois(n_per_image, batch, canvas, rng):
    """ROIs log-uniform from 4 px to the whole canvas (every pyramid scale
    of every level), a third of them pushed over the image border and
    clipped."""
    out = []
    for _ in range(batch):
        wh = np.exp(rng.uniform(np.log(4.0), np.log(canvas), (n_per_image, 2)))
        xy = rng.uniform(0, canvas, (n_per_image, 2)) - 0.5 * wh
        xy[: n_per_image // 3] -= 0.4 * wh[: n_per_image // 3]
        boxes = np.concatenate([xy, xy + wh], -1)
        out.append(np.clip(boxes, 0, canvas))
    return torch.tensor(np.stack(out), dtype=torch.float32, device="cuda")


def k1_args(pyr, names, views, img_idx, dtype=None):
    """window_pool_multi's arguments for `views` (image-major, img_idx their
    images) over the pyramids `names`, as batched_pyramid_pool_multi builds
    them; the flats cast to `dtype` if given."""
    args = [[], [], [], [], []]
    for name in names:
        flat, meta = pyr[name]
        row0, x0, wy, wx = roi_pool.view_geometry(meta, views)
        row0 = (row0 + img_idx * meta.flat.shape[0]).contiguous()
        flat = flat if dtype is None else flat.to(dtype)
        for dst, v in zip(args, (flat, row0, x0, wy, wx)):
            dst.append(v)
    return args


def pool_inputs(levels, rois, canvas):
    """-> (K1 args, K2 args, pyramid levels used per view at c3): K1 pools
    the 1x views over c3+c4+c5, K2 the context views over c5, exactly as
    MultiPathNet.pool_rois routes them."""
    b, r = rois.shape[:2]
    pyr = {name: roi_pyramid.build_pyramid_batch(f, 1.0 / s)
           for name, (f, s) in levels.items()}
    img_idx = torch.arange(b, dtype=torch.int32,
                           device="cuda").repeat_interleave(r)
    k1 = k1_args(pyr, [name for name, _ in LEVELS], rois.reshape(-1, 4),
                 img_idx)
    flat, meta = pyr["c5"]
    ctx = torch.stack([expand(rois, f, canvas, canvas) for f in CONTEXT],
                      dim=1).reshape(-1, 4)
    row0, x0, wy, wx = roi_pool.view_geometry(meta, ctx)
    v = ctx.shape[0] // b
    rows, wmax, c = meta.flat.shape
    k2 = (flat.reshape(b, rows, wmax, c), row0.reshape(b, v),
          x0.reshape(b, v), wy.reshape(b, v, 7, 10), wx.reshape(b, v, 7, 16))
    c3_meta = pyr["c3"][1]
    c3_levels = torch.searchsorted(c3_meta.row_offsets.long(),
                                   (k1[1][0] % c3_meta.flat.shape[0]).long(),
                                   right=True) - 1
    return k1, k2, c3_levels, c3_meta.num_scales


def differ_share(got, want) -> float:
    """The share of outputs that are not equal to the plain version's."""
    return float((got != want).float().mean())


def compare(name, dtype, got, want):
    """Max abs error of a kernel's output against its plain version, held
    to atol 1e-4 in float32 and to rtol/atol 1e-2 in bfloat16 (one bf16
    rounding of a float32 sum); in bfloat16 the tolerance string also
    gives the share of outputs that differ at all."""
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{name}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    err = (got.float() - want.float()).abs().max().item()
    if dtype == torch.float32:
        ok, tol = err <= 1e-4, "atol 1e-4"
    else:
        ok = torch.allclose(got.float(), want.float(), rtol=1e-2, atol=1e-2)
        tol = (f"rtol 1e-2, atol 1e-2; {100 * differ_share(got, want):.4f}% "
               f"of the outputs differ")
    require(ok and np.isfinite(err), f"{name} {dtype} disagrees with its "
            f"plain version: max abs err {err}")
    return err, tol


def check_and_time_kernels(gen):
    """K1 and K2 against their plain versions on the same inputs, in float32
    (a float32 copy of the bf16 maps) and bfloat16, in two cases:
      main path: bench.py's proposals for 8 images x 1000, so K1 pools 8000
          views over c3+c4+c5 and K2 8 x 3000 context views over c5;
      coverage: 2 images, 2048 ROIs at every c3 pyramid scale, a third of
          them over the image border.
    Then each kernel is timed against its plain version on the main path's
    bf16 inputs. Returns {name: {"float32": err, "bfloat16": err, "ms": t,
    "plain_ms": t, "bound_ms": t, "bound_by": ...}} of the main-path
    case."""
    _, _, boxes, _ = make_inputs(8, 1000, 640)
    cases = (("main path", torch.from_numpy(boxes).cuda()),
             ("coverage", border_and_scale_rois(
                 1024, 2, 640, np.random.default_rng(1))))
    out = {"window_pool_multi": {}, "resident_pool": {}}
    for case, rois in cases:
        levels = random_levels(rois.shape[0], 640, 512, gen, torch.bfloat16)
        for dtype in (torch.float32, torch.bfloat16):
            k1, k2, c3_levels, n_scales = pool_inputs(
                {n: (f.to(dtype), s) for n, (f, s) in levels.items()}, rois,
                640)
            if case == "coverage":
                require(set(c3_levels.tolist()) == set(range(n_scales)),
                        f"coverage views miss c3 pyramid scales: "
                        f"{c3_levels.unique()}")
            for name, kern, ref, args in (
                    ("window_pool_multi", roi_pool.window_pool_multi,
                     roi_pool.window_pool_multi_ref, k1),
                    ("resident_pool", roi_pool.resident_pool,
                     roi_pool.resident_pool_ref, k2)):
                got = kern(*args)
                torch.cuda.synchronize()
                err, tol = compare(name, dtype, got, ref(*args))
                shape = "x".join(map(str, got.shape[:got.dim() - 3]))
                log(f"[kernels] {case}: {name} {str(dtype)[6:]}, {shape} "
                    f"views, max abs err {err:.3e} ({tol}) ok")
                if case != "main path":
                    continue
                out[name][str(dtype)[6:]] = err
                if dtype == torch.bfloat16:
                    ms, plain_ms = alternate_ms(lambda: ref(*args),
                                                lambda: kern(*args), 2, 10)
                    flats, row0s, x0s = ((args[0], args[1], args[2])
                                         if name == "window_pool_multi" else
                                         ([args[0]], [args[1]], [args[2]]))
                    b_ms, b_by = pool_bound(flats, row0s, x0s, quant=False)
                    log(f"[kernels] main path: {name} bf16 kernel {ms:.3f} "
                        f"ms ({window_read_gb_s(flats, row0s, ms):.0f} GB/s "
                        f"of window reads), plain {plain_ms:.3f} ms, bound "
                        f"{b_ms:.3f} ms ({b_by})")
                    out[name].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by)
            del k1, k2
        del levels
    return out


# ------------------------------------------------------------- phase 4 ---

# bench.py's weights: every parameter normal * 0.02, drawn on the model's
# device from one seeded generator (the rank bodies of phase 19 draw them so)
seeded_normal_ = mesh_runs.seeded_normal_


def profile_once(tag: str, what: str, fn, top: int = 12) -> float:
    """fn() once under torch.profiler: device time by kernel (the top ones
    and every pool kernel) and by op, and the device's busy share of the
    wall time, which it returns. User annotations (Optimizer.step's range)
    are not kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    stats = prof.key_averages()
    kernels = sorted((e for e in stats
                      if str(e.device_type).endswith("CUDA")
                      and e.device_time_total > 0
                      and not getattr(e, "is_user_annotation", False)),
                     key=lambda e: -e.device_time_total)
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    profile_once.device_ms = busy_ms
    log(f"[{tag}] {what}: wall {wall_ms:.2f} ms, device kernels "
        f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}% busy)")
    for i, e in enumerate(kernels):
        if i < top or "window_" in e.key:
            log(f"[{tag}]   kernel {e.device_time_total / 1e3:8.3f} ms "
                f"x{e.count:<4d} {e.key[:80]}")
    ops = [e for e in stats if not str(e.device_type).endswith("CUDA")
           and e.self_device_time_total > 0]
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[{tag}]   op {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<4d} {e.key[:80]}")
    return busy_ms / wall_ms


def main_path():
    cfg = preset("multipath_vgg16_batched")
    b, p = 8, cfg.data.max_proposals
    canvas = cfg.data.image_size[0]
    require((b, p, canvas) == (8, 1000, 640),
            f"unexpected main-path shape {(b, p, canvas)}")
    t0 = time.perf_counter()
    model = build_model(cfg.model, device="cuda")
    n_params = seeded_normal_(model, 0)
    torch.cuda.synchronize()
    log(f"[main] multipath_vgg16_batched: {n_params / 1e6:.1f}M params "
        f"({cfg.model.dtype}) on the card in {time.perf_counter() - t0:.1f}s")
    det = Detector(model, cfg, "cuda")
    inputs = make_inputs(b, p, canvas)

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = det(*inputs)
    first_s = time.perf_counter() - t0
    log(f"[main] first call {first_s:.2f} s; detections img0: "
        f"{int(out['valid'][0].sum())}")

    dev_inputs = [torch.as_tensor(x).cuda() for x in inputs]
    iters = 10
    detect_batch(model, cfg, *dev_inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        res = detect_batch(model, cfg, *dev_inputs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    ips = b * iters / dt
    log(f"[main] steady: {iters} batches x {b} images in {dt:.3f} s = "
        f"{b * iters / dt:.2f} img/s ({1e3 * dt / iters:.2f} ms/batch); "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[main] kernel launches in the main-path run: {launches}")
    require(launches["window_pool_multi"] > 0 and launches["resident_pool"]
            > 0 and launches["window_pool_multi_quant"] == 0
            and launches["resident_pool_quant"] == 0,
            f"a kernel of the path never launched, or a quant one did: "
            f"{launches}")
    for key, shape in (("boxes", (8, 100, 4)), ("scores", (8, 100)),
                       ("classes", (8, 100)), ("valid", (8, 100))):
        require(out[key].shape == shape and tuple(res[key].shape) == shape,
                f"{key} shape {out[key].shape}")
    require(np.isfinite(out["boxes"]).all() and np.isfinite(
        out["scores"]).all(), "non-finite detections")

    # NMS under load: threshold 0 lets every class through to NMS
    cfg0 = cfg.replace(eval=dataclasses.replace(cfg.eval,
                                                score_threshold=0.0))
    out0 = Detector(model, cfg0, "cuda")(*inputs)
    n_det = int(out0["valid"].sum())
    detect_batch(model, cfg0, *dev_inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        detect_batch(model, cfg0, *dev_inputs)
    torch.cuda.synchronize()
    dt0 = time.perf_counter() - t0
    log(f"[nms] score_threshold=0: {n_det} detections over {b} images; "
        f"{b * iters / dt0:.2f} img/s ({1e3 * dt0 / iters:.2f} ms/batch)")
    require(n_det > 0 and np.isfinite(out0["boxes"]).all(),
            "no detections with score_threshold=0")
    profile_once("profile", "one batch",
                 lambda: detect_batch(model, cfg0, *dev_inputs))
    bias = bias_pass_ms(lambda: detect_batch(model, cfg0, *dev_inputs))
    log(f"[profile] bias passes per batch (each bias added after its "
        f"product, models/layers.py): head {bias['head']:.3f} ms over "
        f"{bias['head_calls']} layers, trunk {bias['trunk']:.3f} ms over "
        f"{bias['trunk_calls']} layers")
    return launches, ips, b * iters / dt0


def bias_pass_ms(run):
    """The bias passes of one run(): every biased conv and linear output
    that models/layers.py makes in it recorded by shape (the layer
    functions wrapped for that one run), then each output's bias add timed
    alone on random data of its shape and dtype. Returns {"head": ms,
    "trunk": ms, "head_calls": n, "trunk_calls": n}; the head is every
    linear layer, the trunk every convolution."""
    seen = []
    conv, linear = layers.conv, layers.linear

    def record(part, fn):
        def wrapped(mod, x, dtype):
            y = fn(mod, x, dtype)
            if mod.bias is not None:
                seen.append((part, tuple(y.shape), y.dtype))
            return y
        return wrapped

    layers.conv = record("trunk", conv)
    layers.linear = record("head", linear)
    try:
        with torch.no_grad():
            run()
    finally:
        layers.conv, layers.linear = conv, linear
    out = {"head": 0.0, "trunk": 0.0, "head_calls": 0, "trunk_calls": 0}
    for part, shape, dtype in seen:
        y = torch.randn(shape, device="cuda").to(dtype)
        channels = shape[1] if part == "trunk" else shape[-1]
        b = torch.randn(channels, device="cuda").to(dtype)
        if part == "trunk":
            b = b[:, None, None]
        out[part] += cuda_ms(lambda: y + b, 5)
        out[f"{part}_calls"] += 1
        del y
    return out


# ------------------------------------------------------------- phase 6 ---

FOVEAL = (1.0, 1.5, 2.0, 4.0)
# the train path's two K1 groups (MultiPathNet.pool_rois with train=True)
TRAIN_GROUPS = (("1x views over c3+c4+c5", FOVEAL[:1], ("c3", "c4", "c5")),
                ("context views over c5", FOVEAL[1:], ("c5",)))


def group_views(rois, factors, canvas=640):
    """A K1 group's views of rois (B, R, 4), image-major, and their
    images."""
    b, r = rois.shape[:2]
    views = torch.stack([expand(rois, f, canvas, canvas) for f in factors],
                        dim=1).reshape(-1, 4)
    img_idx = torch.arange(b, dtype=torch.int32,
                           device="cuda").repeat_interleave(len(factors) * r)
    return views, img_idx


def train_geometry(gen, batch=8, rois_per_image=64, canvas=640, c=512):
    """The pool's inputs at multipath_vgg16_train: random float32 c3/c4/c5
    maps, 64 ROIs per image from bench.py's generator, and
      k3: all 4 foveal views of every ROI over c5 (8 x 256 = 2048 views,
          image-major, rows image-relative) -> window_grad args;
      k3_c4: the 1x views over c4 (512 views, rows image-relative) ->
          window_grad args: the level the reference sends to its
          placement GEMMs and the card to K3;
      k4: the 1x views over c3 (512 views, rows absolute) ->
          window_rmw_grad args (without the dtype);
    plus the pyramids and the ROIs (B, R, 4) for K1 and WindowPoolMulti."""
    _, _, boxes, _ = make_inputs(batch, rois_per_image, canvas)
    rois = torch.from_numpy(boxes).cuda()
    levels = random_levels(batch, canvas, c, gen, torch.float32)
    pyr = {name: roi_pyramid.build_pyramid_batch(f, 1.0 / s)
           for name, (f, s) in levels.items()}
    views, _ = group_views(rois, FOVEAL, canvas)
    meta = pyr["c5"][1]
    rows, wmax = meta.flat.shape[:2]
    row0, x0, wy, wx = roi_pool.view_geometry(meta, views)
    gout = torch.randn((views.shape[0], 7, 7, c), generator=gen,
                       device="cuda")
    k3 = (gout, row0, x0, wy, wx, batch, rows, wmax)
    ones, img_idx = group_views(rois, FOVEAL[:1], canvas)
    meta = pyr["c4"][1]
    rows, wmax = meta.flat.shape[:2]
    row0, x0, wy, wx = roi_pool.view_geometry(meta, ones)
    gout = torch.randn((ones.shape[0], 7, 7, c), generator=gen,
                       device="cuda")
    k3_c4 = (gout, row0, x0, wy, wx, batch, rows, wmax)
    (flat,), (row0,), (x0,), (wy,), (wx,) = k1_args(pyr, ("c3",), ones,
                                                    img_idx)
    gout = torch.randn((ones.shape[0], 7, 7, c), generator=gen,
                       device="cuda")
    k4 = (gout, row0, x0, wy, wx, tuple(flat.shape))
    return k3, k3_c4, k4, pyr, rois


def check_train_forward(pyr, rois):
    """K1 against its plain version on the train path's two groups (512 1x
    views over c3+c4+c5, and 1536 context views over c5 alone, the
    single-level instance that eval never launches), float32 (atol 1e-4)
    and bfloat16 (rtol/atol 1e-2, the pyramids cast), each group timed
    against its plain version in bf16. Returns {"float32": err,
    "bfloat16": err}, the larger of the two groups' errors."""
    out = {"float32": 0.0, "bfloat16": 0.0}
    for group, factors, names in TRAIN_GROUPS:
        views, img_idx = group_views(rois, factors)
        for dtype in (torch.float32, torch.bfloat16):
            args = k1_args(pyr, names, views, img_idx, dtype)
            got = roi_pool.window_pool_multi(*args)
            torch.cuda.synchronize()
            err, tol = compare(f"window_pool_multi ({group})", dtype, got,
                               roi_pool.window_pool_multi_ref(*args))
            key = str(dtype)[6:]
            out[key] = max(out[key], err)
            log(f"[grad] train forward: window_pool_multi {key}, "
                f"{views.shape[0]} {group}, max abs err {err:.3e} ({tol}) "
                f"ok")
        ms, plain_ms = alternate_ms(
            lambda: roi_pool.window_pool_multi_ref(*args),
            lambda: roi_pool.window_pool_multi(*args), 2, 10)
        log(f"[grad] train forward: window_pool_multi bf16, {group}: kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
        del got, args
    return out


def views_per_tile(row0, x0, batch, rows, wmax, tile=16):
    """What count_kernel counts in csrc/roi_window_grad.cu: for each
    tile x tile block of each image's (rows, wmax) gradient, the views
    (image-major, rows image-relative) whose 10 x 16 window meets it.
    Returns (tiles, tiles with a view, the most views on one tile, the
    median over tiles with a view)."""
    n = row0.numel()
    r0, x0 = row0.long(), x0.long()
    img = torch.arange(n, device=row0.device) // max(1, n // batch)
    rt = torch.stack([r0 // tile, (r0 + 9) // tile], 1)
    ct = torch.stack([x0 // tile, (x0 + 15) // tile], 1)
    n_rt, n_ct = -(-rows // tile), -(-wmax // tile)
    ids = []
    for a in (0, 1):
        for b in (0, 1):
            keep = torch.ones(n, dtype=torch.bool, device=row0.device)
            if a:
                keep &= rt[:, 1] != rt[:, 0]
            if b:
                keep &= ct[:, 1] != ct[:, 0]
            ids.append(((img * n_rt + rt[:, a]) * n_ct + ct[:, b])[keep])
    counts = torch.bincount(torch.cat(ids), minlength=batch * n_rt * n_ct)
    hit = counts[counts > 0].float()
    return (counts.numel(), hit.numel(), int(hit.max()),
            float(hit.median()))


def grad_close(name, got, want32):
    """A backward kernel's output against its plain version's float32 sum:
    a float32 output to atol GRAD_ATOL x max(1, max |g|) (float32 sums of
    overlapping windows in another order); a bf16 one within one bf16 step
    (the spacing of bf16 values at the larger magnitude) of the float32
    sum rounded, since each side rounds its own float32 sum once. Returns
    (max abs error, the tolerance as a string)."""
    require(got.shape == want32.shape, f"{name}: {got.shape} vs "
            f"{want32.shape}")
    g = got.float()
    err = (g - want32).abs().max().item()
    if got.dtype == torch.float32:
        scale = max(1.0, want32.abs().max().item())
        ok = err <= GRAD_ATOL * scale
        tol = f"atol 1e-4 x max(1, max |g| = {scale:.2f})"
    else:
        want = want32.to(got.dtype).float()
        _, e = torch.frexp(torch.maximum(g.abs(), want.abs()))
        over = int(((g - want).abs()
                    > torch.ldexp(torch.ones_like(g), e - 8)).sum())
        ok = over == 0
        err = (g - want).abs().max().item()
        tol = (f"one bf16 step; {100 * differ_share(g, want):.4f}% of the "
               f"outputs differ from the plain sum rounded")
    require(ok and np.isfinite(err), f"{name} {got.dtype} disagrees with "
            f"its plain version: max abs err {err} ({tol})")
    return err, tol


def check_and_time_grad_kernels(gen):
    """K1's forward at the train path's two groups (check_train_forward);
    K3 (on c5 and c4) and K4 (on c3) against their plain versions on the
    train path's geometry, with a float32 and a bf16 output (grad_close),
    each output equal bit for bit over two calls, then timed against the
    plain version with the bf16 output the path writes; then
    WindowPoolMulti's backward on the card (K3 on c5 and c4, K4 on c3, no
    placement GEMM) against autograd through the plain forward, float32.
    Returns ({name: {"float32": err, "bfloat16": err, "ms": t, "plain_ms":
    t, "bound_ms": t, "bound_by": ..., "extra": {c4's numbers}}} for K3
    (the c5 case) and K4, K1's train errors)."""
    k3, k3_c4, k4, pyr, rois = train_geometry(gen)
    k1_train = check_train_forward(pyr, rois)
    out = {"window_grad": {"extra": {}}, "window_rmw_grad": {}}
    bf16 = torch.bfloat16
    for name, level, kern, plain, args in (
            ("window_grad", "c5", roi_pool.window_grad,
             lambda *a: roi_pool.window_grad_ref(*a[:-1]).to(a[-1]), k3),
            ("window_grad", "c4", roi_pool.window_grad,
             lambda *a: roi_pool.window_grad_ref(*a[:-1]).to(a[-1]), k3_c4),
            ("window_rmw_grad", "c3", roi_pool.window_rmw_grad,
             roi_pool.window_rmw_grad_ref, k4)):
        if name == "window_grad":
            tiles = views_per_tile(args[1], args[2], args[5], args[6],
                                   args[7])
        else:
            tiles = views_per_tile(args[1], args[2], 1, *args[5][:2])
        log(f"[grad] {name} on {level}: {tiles[0]} tiles of 16 x 16, "
            f"{tiles[1]} with a view; views per tile: at most {tiles[2]}, "
            f"median {tiles[3]:.0f}")
        want = plain(*args, torch.float32)
        stats = {}
        for dtype in (torch.float32, bf16):
            got = kern(*args, dtype)
            again = kern(*args, dtype)
            torch.cuda.synchronize()
            require(torch.equal(got, again), f"{name} on {level}, "
                    f"{dtype}: two calls on the same inputs differ")
            err, tol = grad_close(f"{name} on {level}", got, want)
            stats[str(dtype)[6:]] = err
            log(f"[grad] {name} on {level}, {str(dtype)[6:]} output, "
                f"{args[0].shape[0]} views into {tuple(got.shape)}: max abs "
                f"err {err:.3e} ({tol}) ok; bit-equal over two calls")
            del got, again
        del want
        ms, plain_ms = alternate_ms(lambda: plain(*args, bf16),
                                    lambda: kern(*args, bf16), 2, 10)
        if name == "window_grad":    # (batch * rows, wmax, C)
            numel = args[5] * args[6] * args[7] * args[0].shape[-1]
        else:                        # the buffer's shape
            numel = int(np.prod(args[5]))
        b_ms, b_by = grad_bound(args[0], numel, 2)
        log(f"[grad] {name} on {level}, bf16 output: kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
        if level == "c4":
            out[name]["extra"].update(
                c4_ms=round(ms, 4), c4_plain_ms=round(plain_ms, 4),
                c4_bound_ms=round(b_ms, 4), c4_max_abs_err=stats["float32"],
                c4_max_abs_err_bf16=stats["bfloat16"])
            continue
        out[name].update(float32=stats["float32"],
                         bfloat16=stats["bfloat16"], ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        # the wrapper's own passes beside the kernel's: none are left
        profile_once("grad", f"{name} on {level} wrapper, one call",
                     lambda: kern(*args, bf16), top=4)

    names = [n for n, _ in LEVELS]
    flats = [pyr[n][0].detach().requires_grad_() for n in names]
    metas = [pyr[n][1] for n in names]
    ones, img_idx = group_views(rois, FOVEAL[:1])
    gout = torch.randn((ones.shape[0], 7, 7, flats[0].shape[-1]),
                       generator=gen, device="cuda")
    before = (roi_pool.window_grad.launches,
              roi_pool.window_rmw_grad.launches,
              roi_pool.place_windows_per_image.calls)
    got = torch.autograd.grad(
        (roi_pool.batched_pyramid_pool_multi(flats, metas, ones, img_idx,
                                             trainable=True) * gout).sum(),
        flats)
    torch.cuda.synchronize()
    calls = (roi_pool.window_grad.launches - before[0],
             roi_pool.window_rmw_grad.launches - before[1],
             roi_pool.place_windows_per_image.calls - before[2])
    require(calls == (2, 1, 0), f"WindowPoolMulti backward: K3, K4, "
            f"placement calls {calls}, expected (2, 1, 0)")
    _, *geometry = k1_args(pyr, names, ones, img_idx)
    plain = roi_pool.window_pool_multi_ref(flats, *geometry)
    want = torch.autograd.grad((plain * gout).sum(), flats)
    for (lv, _), g_, w_ in zip(LEVELS, got, want):
        err, tol = grad_close(f"WindowPoolMulti backward {lv}", g_, w_)
        log(f"[grad] WindowPoolMulti backward {lv}: max abs err {err:.3e} "
            f"({tol}) ok")
    log("[grad] WindowPoolMulti backward: c5 and c4 through K3, c3 through "
        "K4, no placement GEMM")
    return out, k1_train


# ------------------------------------------------------------- phase 7 ---

def train_batch(cfg, seed: int = 0) -> Batch:
    """A synthetic batch at the pipeline's shapes, numpy from `seed`: uint8
    images on the (H, W) canvas, valid extents in [480, 640], 5-20 GT boxes
    per image padded to max_gt_per_image, and max_proposals proposals per
    image, half of them jittered around GT so fg exists."""
    rng = np.random.default_rng(seed)
    b, (h, w) = cfg.train.batch_size, cfg.data.image_size
    p, g = cfg.data.max_proposals, cfg.data.max_gt_per_image
    images = rng.integers(0, 255, (b, h, w, 3), dtype=np.uint8)
    src_hws = rng.integers(480, 641, (b, 2)).astype(np.float32)
    n_gt = rng.integers(5, 21, b)
    gt = np.zeros((b, g, 4), np.float32)
    classes = np.zeros((b, g), np.int32)
    props = np.zeros((b, p, 4), np.float32)
    for i in range(b):
        ext = src_hws[i, ::-1]                              # (w, h)
        wh = rng.uniform(32, 0.5 * ext.min(), (n_gt[i], 2))
        xy = rng.uniform(0, 1, (n_gt[i], 2)) * (ext - wh)
        gt[i, :n_gt[i]] = np.concatenate([xy, xy + wh], -1)
        classes[i, :n_gt[i]] = rng.integers(1, cfg.model.num_classes,
                                            n_gt[i])
        near = gt[i, rng.integers(0, n_gt[i], p // 2)]
        size = np.tile(near[:, 2:] - near[:, :2], 2)        # (w, h, w, h)
        near = near + rng.normal(0, 0.1, near.shape) * size
        pwh = rng.uniform(16, 0.6 * ext.min(), (p - p // 2, 2))
        pxy = rng.uniform(0, 1, (p - p // 2, 2)) * (ext - pwh)
        far = np.concatenate([pxy, pxy + pwh], -1)
        props[i] = np.clip(np.concatenate([near, far]), 0,
                           np.tile(ext, 2))
    return Batch(images, src_hws, props, np.ones((b, p), bool), gt, classes,
                 np.arange(g)[None, :] < n_gt[:, None])


def train_path():
    """Phase 7: Trainer.step on multipath_vgg16_train at full width."""
    cfg = preset("multipath_vgg16_train")
    m, d, t = cfg.model, cfg.data, cfg.train
    shape = (m.backbone, t.batch_size, d.image_size, d.max_proposals,
             d.rois_per_image, m.fc_dim, m.num_classes,
             len(m.integral_thresholds), m.dtype, t.freeze_backbone_stages)
    require(shape == ("vgg16", 8, (640, 640), 1000, 64, 4096, 81, 6,
                      "bfloat16", 2), f"unexpected train shape {shape}")
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device="cuda")
    state = trainer.init_state(0)
    n_params = seeded_normal_(trainer.model, 0)
    require(all(p.dtype == torch.float32
                for p in trainer.model.parameters()),
            "training parameters must be float32")
    frozen = {n: p.detach().clone()
              for n, p in trainer.model.named_parameters()
              if n in trainer.frozen}
    require(frozen and all(n.startswith(("backbone.conv1_", "backbone.conv2_"))
                           for n in frozen), f"frozen set {sorted(frozen)}")
    batch = trainer.put_batch(train_batch(cfg))
    torch.cuda.synchronize()
    log(f"[train] multipath_vgg16_train: {n_params / 1e6:.1f}M float32 "
        f"params ({len(frozen)} frozen tensors), {m.dtype} compute, on the "
        f"card in {time.perf_counter() - t0:.1f}s")

    reset_launches()
    roi_pool.place_windows_per_image.calls = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, metrics = trainer.step(state, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    history = [metrics]
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        state, metrics = trainer.step(state, batch)
        history.append(metrics)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    placements = roi_pool.place_windows_per_image.calls
    b = t.batch_size
    log(f"[train] first step {first_s:.2f} s; steady: {iters} steps x {b} "
        f"images in {dt:.3f} s = {1e3 * dt / iters:.2f} ms/step, "
        f"{b * iters / dt:.2f} img/s ({b * d.rois_per_image} ROIs/step); "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[train] kernel launches in {iters + 1} steps: {launches}")
    log("[train] last step: " + ", ".join(
        f"{k} {float(v):.4g}" for k, v in metrics.items()))
    losses = [float(h["loss"]) for h in history]
    require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    require(all(float(h["num_fg"]) > 0 for h in history),
            "a step sampled no foreground ROI")
    for name in ("window_pool_multi", "window_grad", "window_rmw_grad"):
        require(launches[name] > 0, f"{name} never launched in training")
    steps = iters + 1
    require(launches["window_grad"] == 3 * steps
            and launches["window_rmw_grad"] == steps and placements == 0,
            f"the backward's routing: K3 {launches['window_grad']}, K4 "
            f"{launches['window_rmw_grad']}, placement GEMMs {placements} "
            f"in {steps} steps; expected K3 on c5 (both groups) and c4, K4 "
            f"on c3, no placement")
    for name in ("resident_pool", "window_pool_multi_quant",
                 "resident_pool_quant"):
        require(launches[name] == 0, f"{name} launched in training: "
                f"{launches}")
    params = dict(trainer.model.named_parameters())
    for name, before in frozen.items():
        require(torch.equal(params[name], before), f"frozen {name} moved")
    g31 = params["backbone.conv3_1.weight"].grad
    require(g31 is not None and bool(g31.abs().sum() > 0),
            "no gradient reached conv3_1")
    profile_once("train", "one step",
                 lambda: trainer.step(state, batch), top=24)
    repeat_steps(trainer, state, batch)
    return launches, 1e3 * dt / iters, b * iters / dt


def repeat_steps(trainer, state, batch, iters: int = 5,
                 tag: str = "train") -> None:
    """Two steps from one saved state (parameters, momentum, step count,
    generator) on one batch, under the default settings and under
    cudnn.deterministic: whether loss, every gradient and every parameter
    come out equal bit for bit, and the deterministic setting's ms/step
    over `iters` steps beside the default's in this call. The port's own
    kernels (K3/K4 without atomics) repeat; cuDNN's default backward
    algorithms may not, and only the deterministic setting is required to
    repeat."""
    saved = snapshot_train_state(trainer, state)
    params = dict(trainer.model.named_parameters())
    ms = {}
    for setting, det in (("default", False), ("cudnn.deterministic", True)):
        torch.backends.cudnn.deterministic = det
        try:
            first = None
            for _ in range(2):
                st = restore_train_state(trainer, saved)
                _, m = trainer.step(st, batch)
                run = (m["loss"].clone(),
                       {n: (p.detach().clone(), p.grad.clone())
                        for n, p in params.items() if p.grad is not None})
                if first is None:
                    first = run
            loss_eq = bool(torch.equal(first[0], run[0]))
            grads = [n for n in first[1]
                     if not torch.equal(first[1][n][1], run[1][n][1])]
            moved = [n for n in first[1]
                     if not torch.equal(first[1][n][0], run[1][n][0])]
            del first, run
            st = restore_train_state(trainer, saved)
            trainer.step(st, batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                st, _ = trainer.step(st, batch)
            torch.cuda.synchronize()
            ms[setting] = 1e3 * (time.perf_counter() - t0) / iters
        finally:
            torch.backends.cudnn.deterministic = False
        equal = loss_eq and not grads and not moved
        log(f"[{tag}] two steps from one state, {setting}: "
            f"{'equal' if equal else 'NOT equal'} (loss "
            f"{'equal' if loss_eq else 'differs'}; {len(grads)} of "
            f"{len(params)} gradients and {len(moved)} parameters differ"
            f"{': ' + ', '.join(sorted(grads)[:6]) if grads else ''}); "
            f"{ms[setting]:.2f} ms/step over {iters} steps")
        if det:
            require(equal, "two steps from one state differ under "
                    "cudnn.deterministic")
    restore_train_state(trainer, saved)


# ------------------------------------------------------------- phase 8 ---

def check_and_time_quant_kernels(gen):
    """K1 and K2 with the int8 epilogue at the main path's shapes (bench.py's
    8 x 1000 proposals on random 640^2 c3/c4/c5 maps, C = 512, a random skip
    bias), float32 and bfloat16: bit for bit against quant_view_ref of the
    same kernel's own pooled output; against the fully plain version codes
    within 1 and scales within 1e-5 (float32) / 1e-2 (bfloat16) relative.
    In bf16, each timed against its plain version and against the kernel
    without the epilogue followed by the plain epilogue ("unfused").
    Returns {name: {"float32": max code error, "bfloat16": ..., "ms": t,
    "plain_ms": t, "bound_ms": t, "bound_by": ..., "extra": {...}}}."""
    _, _, boxes, _ = make_inputs(8, 1000, 640)
    rois = torch.from_numpy(boxes).cuda()
    levels = random_levels(8, 640, 512, gen, torch.bfloat16)
    out = {"window_pool_multi_quant": {"extra": {}},
           "resident_pool_quant": {"extra": {}}}
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype)[6:]
        k1, k2, _, _ = pool_inputs(
            {n: (f.to(dtype), s) for n, (f, s) in levels.items()}, rois, 640)
        bias = (torch.randn(512, generator=gen, device="cuda") * 0.5).to(
            dtype)
        for name, kern, ref, args in (
                ("window_pool_multi_quant", roi_pool.window_pool_multi,
                 roi_pool.window_pool_multi_ref, k1),
                ("resident_pool_quant", roi_pool.resident_pool,
                 roi_pool.resident_pool_ref, k2)):
            q, s = kern(*args, quant_bias=bias)
            torch.cuda.synchronize()
            n = s.numel()

            def unfused():
                pooled = kern(*args).reshape(n, 7, 7, 512)
                return roi_pool.quant_view_ref(pooled, bias)

            own_q, own_s = unfused()
            require(torch.equal(q.reshape(n, 7, 7, 512), own_q)
                    and torch.equal(s.reshape(n), own_s),
                    f"{name} {key}: not bit-equal to the plain epilogue on "
                    f"its own pooled output")
            plain_q, plain_s = ref(*args, quant_bias=bias)
            if dtype == torch.bfloat16:
                log(f"[quant] {name.removesuffix('_quant')} bf16 pooled "
                    f"output: {100 * differ_share(kern(*args), ref(*args)):.4f}"
                    f"% differs from its plain version")
            diff = (q.int() - plain_q.int()).abs()
            code_err = int(diff.max())
            share = float((diff > 0).float().mean())
            scale_err = float(((s - plain_s).abs() / plain_s).max())
            tol = 1e-5 if dtype == torch.float32 else 1e-2
            require(code_err <= 1 and scale_err <= tol,
                    f"{name} {key} disagrees with its plain version: codes "
                    f"{code_err}, scales rel {scale_err}")
            log(f"[quant] {name} {key}, {n} views: bit-equal to the plain "
                f"epilogue on its own pooled output; against the plain "
                f"version max code error {code_err} ({100 * share:.4f}% of "
                f"codes), scales max rel err {scale_err:.3e} (tol {tol}) ok")
            out[name][key] = code_err
            out[name]["extra"].update({f"code_share_{key}": share,
                                       f"scale_rel_err_{key}": scale_err})
            del q, s, own_q, own_s, plain_q, plain_s, diff
            if dtype != torch.bfloat16:
                continue
            ms, plain_ms = alternate_ms(
                lambda: ref(*args, quant_bias=bias),
                lambda: kern(*args, quant_bias=bias), 2, 10)
            unfused_ms = cuda_ms(unfused, 10)
            flats, row0s, x0s = ((args[0], args[1], args[2])
                                 if name == "window_pool_multi_quant" else
                                 ([args[0]], [args[1]], [args[2]]))
            b_ms, b_by = pool_bound(flats, row0s, x0s, quant=True)
            log(f"[quant] {name} bf16: kernel {ms:.3f} ms "
                f"({window_read_gb_s(flats, row0s, ms):.0f} GB/s of window "
                f"reads), plain "
                f"{plain_ms:.3f} ms, kernel without the epilogue + plain "
                f"epilogue {unfused_ms:.3f} ms, bound {b_ms:.3f} ms "
                f"({b_by})")
            out[name].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by)
            out[name]["extra"]["unfused_ms"] = round(unfused_ms, 4)
        del k1, k2
    return out


# -------------------------------------------------------- phases 9, 10 ---

def serving_path(preset_name: str, tag: str):
    """Detector on an int8 serving preset at 8 x 1000 proposals, 640^2:
    bench.py's flow, the preset's own layout (factored at its ranks) drawn
    in float32 on the card, then Detector's load-time transform quantizes
    it. Returns (launches, steady img/s)."""
    cfg = preset(preset_name)
    m = cfg.model
    b, p = 8, cfg.data.max_proposals
    canvas = cfg.data.image_size[0]
    require((b, p, canvas, m.head_quant) == (8, 1000, 640, "int8"),
            f"unexpected {preset_name} shape {(b, p, canvas, m.head_quant)}")
    t0 = time.perf_counter()
    float_model = build_model(dataclasses.replace(m, head_quant="none"),
                              param_dtype=torch.float32, device="cuda")
    n_params = seeded_normal_(float_model, 0)
    tree = convert.flax_from_state_dict(float_model.state_dict(), host=False)
    del float_model
    model = build_model(m, device="cuda")
    det = Detector(model, cfg, params=tree)
    del tree
    torch.cuda.synchronize()
    require(bool(model.head.fc6_f0.weight_i8.any()),
            "the int8 head holds no weights")
    log(f"[{tag}] {preset_name}: {n_params / 1e6:.1f}M float32 params "
        f"(fc6_rank {m.fc6_rank}, fc7_rank {m.fc7_rank}) drawn on the card "
        f"and quantized at load in {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    inputs = make_inputs(b, p, canvas)

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = det(*inputs)
    first_s = time.perf_counter() - t0
    dev_inputs = [torch.as_tensor(x).cuda() for x in inputs]
    iters = 10
    detect_batch(model, cfg, *dev_inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        res = detect_batch(model, cfg, *dev_inputs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    ips = b * iters / dt
    log(f"[{tag}] first call {first_s:.2f} s; steady: {iters} batches x {b} "
        f"images in {dt:.3f} s = {ips:.2f} img/s ({1e3 * dt / iters:.2f} "
        f"ms/batch); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[{tag}] kernel launches in this run: {launches}")
    require(launches["window_pool_multi_quant"] > 0
            and launches["resident_pool_quant"] > 0,
            f"a quant kernel never launched: {launches}")
    require(launches["window_pool_multi"] == 0
            and launches["resident_pool"] == 0,
            f"a pool kernel without the epilogue launched: {launches}")
    for key, shape in (("boxes", (8, 100, 4)), ("scores", (8, 100)),
                       ("classes", (8, 100)), ("valid", (8, 100))):
        require(out[key].shape == shape and tuple(res[key].shape) == shape,
                f"{key} shape {out[key].shape}")
    require(np.isfinite(out["boxes"]).all() and np.isfinite(
        out["scores"]).all(), "non-finite detections")
    profile_once(tag, "one batch",
                 lambda: detect_batch(model, cfg, *dev_inputs))
    return launches, ips


# ------------------------------------------------------------ phase 11 ---

# The single-level backwards are held to atol 1e-4 x max(1, max |g|): on
# the c5 context group the gradient sums thousands of overlapping windows
# and reaches |g| near 100 (the run prints it), where one float32 ulp is
# 7.6e-6 and two float32 summation orders (K4's atomics, index_put_) differ
# by about 1e-4.
GRAD_ATOL = 1e-4

def check_and_time_window_pool(pyr, views, img_idx):
    """K5 against its plain version on `views` (rows absolute) over the
    stacked c3 pyramid, float32 (atol 1e-4) and bfloat16 (rtol/atol 1e-2),
    then timed against it in bf16. Returns {"float32": err, "bfloat16":
    err, "ms": t, "plain_ms": t, "bound_ms": t, "bound_by": ...}."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        (flat,), (row0,), (x0,), (wy,), (wx,) = k1_args(pyr, ("c3",), views,
                                                        img_idx, dtype)
        args = (flat, row0, x0, wy, wx)
        got = roi_pool.window_pool(*args)
        torch.cuda.synchronize()
        err, tol = compare("window_pool", dtype, got,
                           roi_pool.window_pool_ref(*args))
        out[str(dtype)[6:]] = err
        log(f"[pool_api] window_pool {str(dtype)[6:]}, {row0.numel()} views "
            f"over c3, max abs err {err:.3e} ({tol}) ok")
        del got
    ms, plain_ms = alternate_ms(lambda: roi_pool.window_pool_ref(*args),
                                lambda: roi_pool.window_pool(*args), 2, 10)
    b_ms, b_by = pool_bound([flat], [row0], [x0], quant=False)
    log(f"[pool_api] window_pool bf16 kernel {ms:.3f} ms "
        f"({window_read_gb_s([flat], [row0], ms):.0f} GB/s of window reads), "
        f"plain "
        f"{plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
    out.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    return out


def pool_api_path(gen):
    """Phase 11: K5 checked and timed (check_and_time_window_pool), then
    the single-level entry points as the path `pool_api`, launches counted
    from 0: batched_pyramid_pool on the main path's 8000 1x views over c3
    in bf16; in float32 with their backward, batched_pyramid_pool(trainable)
    on the same views, batched_pyramid_pool_resident(trainable) on the
    8 x 3000 context views over c5, and WindowPoolMulti without rows_list
    on the train geometry (512 1x views over c3+c4+c5). After the path,
    each gradient against autograd through the plain forward, float32,
    atol 1e-4 x max(1, max |g|). Returns (K5's stats, the path's
    launches)."""
    _, _, boxes, _ = make_inputs(8, 1000, 640)
    rois = torch.from_numpy(boxes).cuda()
    levels = random_levels(8, 640, 512, gen, torch.float32)
    pyr = {name: roi_pyramid.build_pyramid_batch(f, 1.0 / s)
           for name, (f, s) in levels.items()}
    del levels
    ones, ones_img = group_views(rois, FOVEAL[:1])
    ctx, _ = group_views(rois, CONTEXT)
    _, _, train_boxes, _ = make_inputs(8, 64, 640)
    train_ones, train_img = group_views(torch.from_numpy(train_boxes).cuda(),
                                        FOVEAL[:1])
    stats = check_and_time_window_pool(pyr, ones, ones_img)
    names = [n for n, _ in LEVELS]
    flat3, meta3 = pyr["c3"]
    flat5, meta5 = pyr["c5"]
    c = flat3.shape[-1]
    g1 = torch.randn((ones.shape[0], 7, 7, c), generator=gen, device="cuda")
    g2 = torch.randn((ctx.shape[0], 7, 7, c), generator=gen, device="cuda")
    g3 = torch.randn((train_ones.shape[0], 7, 7, c), generator=gen,
                     device="cuda")
    leaf = {n: pyr[n][0].detach().requires_grad_() for n in names}
    train_geo = k1_args(pyr, names, train_ones, train_img)[1:]

    reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        pooled = roi_pool.batched_pyramid_pool(flat3.bfloat16(), meta3, ones,
                                               ones_img)
    out = roi_pool.batched_pyramid_pool(leaf["c3"], meta3, ones, ones_img,
                                        trainable=True)
    (k5_grad,) = torch.autograd.grad((out * g1).sum(), leaf["c3"])
    out = roi_pool.batched_pyramid_pool_resident(leaf["c5"], meta5, ctx, 8,
                                                 trainable=True)
    (k2_grad,) = torch.autograd.grad((out * g2).sum(), leaf["c5"])
    flats = [leaf[n] for n in names]
    out = roi_pool.WindowPoolMulti.apply(train_geo, None, None, *flats)
    k1_grads = torch.autograd.grad((out * g3).sum(), flats)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[pool_api] path: K5 forward, K5/K2/K1 forward + backward in "
        f"{time.perf_counter() - t0:.3f} s; launches {launches}")
    del out
    require(launches["window_pool"] == 2 and launches["resident_pool"] == 1
            and launches["window_pool_multi"] == 1
            and launches["window_rmw_grad"] == 5
            and launches["window_grad"] == 0
            and launches["window_pool_multi_quant"] == 0
            and launches["resident_pool_quant"] == 0,
            f"pool_api launched other kernels than K5 x 2, K2, K1 and K4 x 5:"
            f" {launches}")
    require(pooled.shape == (ones.shape[0], 7, 7, c)
            and pooled.dtype == torch.bfloat16
            and bool(torch.isfinite(pooled).all()), "K5's bf16 pool")

    def plain_grad(fn, flats, gout):
        flats = [f.detach().requires_grad_() for f in flats]
        return torch.autograd.grad((fn(*flats) * gout).sum(), flats)

    row0, x0, wy, wx = roi_pool.view_geometry(meta3, ones)
    row0 = row0 + ones_img * meta3.flat.shape[0]
    checks = [("window_pool_trainable backward, c3", k5_grad, plain_grad(
        lambda f: roi_pool.window_pool_ref(f, row0, x0, wy, wx), [flat3],
        g1)[0])]
    row0, x0, wy, wx = roi_pool.view_geometry(meta5, ctx)
    rows, wmax = meta5.flat.shape[:2]
    v = ctx.shape[0] // 8
    plain = plain_grad(lambda f: roi_pool.resident_pool_ref(
        f.reshape(8, rows, wmax, c), row0.reshape(8, v), x0.reshape(8, v),
        wy.reshape(8, v, 7, 10), wx.reshape(8, v, 7, 16)).reshape(-1, 7, 7, c),
        [flat5], g2)[0]
    checks.append(("resident_pool_trainable backward, c5", k2_grad, plain))
    plain = plain_grad(lambda *fs: roi_pool.window_pool_multi_ref(
        list(fs), *train_geo), [pyr[n][0] for n in names], g3)
    checks += [(f"WindowPoolMulti backward without rows_list, {n}", got,
                want) for n, got, want in zip(names, k1_grads, plain)]
    errs = []
    for what, got, want in checks:
        require(got.shape == want.shape and got.dtype == want.dtype,
                f"{what}: {got.shape}/{got.dtype} vs {want.shape}/"
                f"{want.dtype}")
        err = (got - want).abs().max().item()
        scale = max(1.0, want.abs().max().item())
        require(err <= GRAD_ATOL * scale, f"{what} disagrees with autograd "
                f"of the plain forward: max abs err {err} at max |g| {scale}")
        log(f"[pool_api] {what}: max abs err {err:.3e} (atol 1e-4 x max(1, "
            f"max |g| = {scale:.2f})) ok")
        errs.append(err)
    stats["extra"] = {"backward_max_abs_err": max(errs)}
    return stats, launches


# ------------------------------------------------------------ phase 12 ---

def probe_bound(flat, row0, x0):
    """bound() of one P call: the distinct cells under its windows read
    once, row0/x0 read once, the (N, 49, C) bf16 output written once; 160
    float32 adds per view and channel."""
    rows, wmax, c = flat.shape
    n = row0.numel()
    cells = window_cells(row0, x0, rows, wmax)
    return bound(cells * c * flat.element_size() + n * 8 + n * 49 * c * 2,
                 n * c * 160)


def probe_path():
    """Phase 12: P against its plain version at its tool's shapes, bf16 and
    int8 windows (rtol/atol 1e-2), each timed against it; then the tool's
    bench for each dtype as the path `probe`, launches counted from 0.
    Returns (stats with the bf16 numbers as the row's and the int8 ones in
    "extra", the path's launches)."""
    stats = {"extra": {}}
    for dtype in (torch.bfloat16, torch.int8):
        key = str(dtype)[6:]
        args = probe.probe_inputs(dtype)
        got = probe.window_read_probe(*args)
        torch.cuda.synchronize()
        err, tol = compare(f"window_read_probe {key}", torch.bfloat16, got,
                           probe.window_read_probe_ref(*args))
        del got
        ms, plain_ms = alternate_ms(lambda: probe.window_read_probe_ref(*args),
                                    lambda: probe.window_read_probe(*args),
                                    1, 10)
        b_ms, b_by = probe_bound(*args)
        n, c = args[1].numel(), args[0].shape[-1]
        read_gb_s = n * 160 * c * args[0].element_size() / ms / 1e6
        log(f"[probe] window_read_probe {key} windows, {n} views: max abs "
            f"err {err:.3e} ({tol}) ok; kernel {ms:.4f} ms ({read_gb_s:.1f} "
            f"GB/s of window reads), plain {plain_ms:.3f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
        if dtype == torch.bfloat16:
            stats.update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by)
            stats["extra"]["read_gb_s"] = read_gb_s
        else:
            stats["extra"].update(
                max_abs_err_int8=err, int8_ms=round(ms, 4),
                int8_plain_ms=round(plain_ms, 4),
                int8_bound_ms=round(b_ms, 4), int8_bound_by=b_by,
                int8_read_gb_s=read_gb_s)
        del args
        torch.cuda.empty_cache()
    reset_launches()
    bf16 = probe.bench(torch.bfloat16)
    int8 = probe.bench(torch.int8)
    launches = read_launches()
    log(f"[probe] bench: bf16 / int8 time {bf16['ms'] / int8['ms']:.3f}x; "
        f"launches {launches}")
    require(launches["window_read_probe"] > 0
            and sum(launches.values()) == launches["window_read_probe"],
            f"the probe's bench launched {launches}")
    stats["extra"].update(bench_ms=round(bf16["ms"], 4),
                          int8_bench_ms=round(int8["ms"], 4),
                          bench_read_gb_s=bf16["gb_s"],
                          int8_bench_read_gb_s=int8["gb_s"])
    return stats, launches


# ------------------------------------------------------------ phase 13 ---

BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")


def fresh_dir(name: str) -> str:
    """An empty directory build/chip_smoke/<name> (build/ is ignored by
    git)."""
    path = os.path.join(BUILD, "chip_smoke", name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def disk_split():
    """Phase 13's split: synthetic.generate's COCO layout on disk, 32 PNG
    images of 600^2, 80 categories (81 classes with the background, the
    published width of the VGG-16 presets), up to 4 objects and 1000
    proposals per image, seed 0. -> (loader, proposals)."""
    t0 = time.perf_counter()
    fx = synthetic.generate(fresh_dir("split"), num_images=32,
                            image_size=600, num_classes=80, max_objects=4,
                            proposals_per_image=1000, seed=0)
    loader = CocoLoader(fx["annotations"], fx["images"])
    props = ProposalStore.load(fx["proposals"])
    n_gt = sum(len(loader.annotations(i)["boxes"])
               for i in range(len(loader)))
    log(f"[dataset_eval] split: {len(loader)} PNG images of 600^2, "
        f"{loader.num_classes - 1} categories, {n_gt} objects, "
        f"{len(props.boxes)} proposals, written in "
        f"{time.perf_counter() - t0:.1f} s")
    return loader, props


def serial_detections(tester, model, cfg):
    """The loop phase 13 holds the Tester to: detect_batch on each
    eval_batches batch, copied to the card synchronously from pageable
    memory, each batch converted before the next is read."""
    dets = []
    for idxs, batch in tester.pipeline.eval_batches():
        out = detect_batch(model, cfg, *(torch.as_tensor(x, device="cuda")
                                         for x in batch[:4]))
        ids = [tester.loader.image_id(i) for i in idxs]
        dets += detections_to_coco(
            {k: v.cpu().numpy()[:len(ids)] for k, v in out.items()}, ids,
            tester.loader.label_to_cat)
    return dets


def dataset_eval_path(loader, props):
    """Phase 13: Tester on `multipath_vgg16_batched` over the split on
    disk. Returns (launches, split img/s, the metrics, the detections)."""
    cfg = preset("multipath_vgg16_batched")
    cfg = cfg.replace(eval=dataclasses.replace(cfg.eval,
                                               score_threshold=0.0))
    shape = (loader.num_classes, cfg.model.num_classes,
             cfg.data.max_proposals, cfg.data.image_size)
    require(shape == (81, 81, 1000, (640, 640)),
            f"unexpected dataset_eval shape {shape}")
    model = build_model(cfg.model, device="cuda")
    seeded_normal_(model, 0)
    tester = Tester(model, cfg, loader, props, device="cuda", batch_size=8)
    n = len(loader)
    t0 = time.perf_counter()
    tester.collect_detections(max_images=8)
    log(f"[dataset_eval] warm-up, one batch: "
        f"{time.perf_counter() - t0:.2f} s")

    reset_launches()
    t0 = time.perf_counter()
    metrics = tester.test()
    dt = time.perf_counter() - t0
    launches = read_launches()
    log(f"[dataset_eval] Tester.test over {n} images from disk (decode, "
        f"padding, copy, detect, conversion, evaluation): {dt:.3f} s = "
        f"{n / dt:.2f} img/s")
    log(f"[dataset_eval] kernel launches in Tester.test: {launches}")
    require(launches["window_pool_multi"] > 0 and launches["resident_pool"]
            > 0 and launches["window_pool_multi_quant"] == 0
            and launches["resident_pool_quant"] == 0,
            f"a kernel of the path never launched, or a quant one did: "
            f"{launches}")
    require(all(np.isfinite(v) for v in metrics.values()),
            f"non-finite metric: {metrics}")

    # the Tester against the serial loop, in turns (Tester, serial, serial,
    # Tester): what its conversion one batch behind costs or buys
    runs = {"tester": [], "serial": []}
    for which in ("tester", "serial", "serial", "tester"):
        t0 = time.perf_counter()
        if which == "tester":
            dets = tester.collect_detections()
        else:
            serial = serial_detections(tester, model, cfg)
        runs[which].append(time.perf_counter() - t0)
    require(len(dets) > 0 and dets == serial,
            f"the Tester's {len(dets)} detections differ from the serial "
            f"loop's {len(serial)}")
    collect_s = float(np.mean(runs["tester"]))
    log(f"[dataset_eval] split in turns: collect_detections "
        f"{' / '.join(f'{t:.4f}' for t in runs['tester'])} s, the serial "
        f"loop (synchronous copies from pageable memory) "
        f"{' / '.join(f'{t:.4f}' for t in runs['serial'])} s")
    t0 = time.perf_counter()
    for _ in tester.pipeline.eval_batches():
        pass
    host_s = time.perf_counter() - t0
    gts = groundtruth_to_coco(loader)
    t0 = time.perf_counter()
    again = CocoEvaluator().evaluate(gts, dets)
    eval_s = time.perf_counter() - t0
    require(again == metrics, "the evaluator on the collected detections "
            "differs from Tester.test")
    log(f"[dataset_eval] collect_detections {collect_s:.3f} s "
        f"({n / collect_s:.2f} img/s); {len(dets)} detections, equal to the "
        f"serial loop's bit for bit; eval_batches alone (decode, padding, "
        f"stacking; two decode threads) {host_s:.3f} s; the evaluator "
        f"{eval_s:.3f} s over {len(gts)} objects")
    busy = profile_once("dataset_eval", "collect_detections over the split",
                        tester.collect_detections, top=8)
    log(f"[dataset_eval] device busy over the split: {100 * busy:.1f}%")
    log("[dataset_eval] metrics: " + json.dumps(metrics))
    return launches, n / dt, metrics, dets


# ------------------------------------------------------------ phase 14 ---

def overfit_tiny():
    """(a) The reference's golden check (its tests/test_e2e.py on the
    overfit_tiny fixture) on the card: 8 synthetic images of 64^2, `tiny`
    with 5 classes, batch 2, 30 epochs through epoch_on_device, for init
    seeds 0-4; the median run must reach AP50 > 0.5, rise by more than 0.3
    and end its loss under 0.75 x its first (tests/test_torch_eval.py says
    why the median)."""
    fx = synthetic.generate(fresh_dir("overfit"), num_images=8,
                            image_size=64, num_classes=4,
                            proposals_per_image=24, seed=5)
    cfg = preset("tiny")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, num_classes=5))
    loader = CocoLoader(fx["annotations"], fx["images"])
    props = ProposalStore.load(fx["proposals"])
    trainer = Trainer(cfg, device="cuda")
    pipe = DetectionPipeline(loader, props, cfg.data, batch_size=2, seed=0)

    def ap50():
        return Tester(trainer.model, cfg, loader, props, device="cuda",
                      batch_size=2).test()["AP50"]

    runs = []
    for seed in range(5):
        t0 = time.perf_counter()
        state = trainer.init_state(seed)
        before = ap50()
        losses = []
        for ep in range(30):
            for batch in pipe.epoch_on_device(ep, trainer.stream_batch):
                state, m = trainer.step(state, batch)
                losses.append(m["loss"])
        after = ap50()
        losses = torch.stack(losses).tolist()
        require(np.all(np.isfinite(losses)), f"non-finite loss, seed {seed}")
        runs.append((after, after - before, losses[-1] / losses[0]))
        log(f"[train_eval] overfit seed {seed}: AP50 {before:.4f} -> "
            f"{after:.4f}, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
            f"{len(losses)} steps, {time.perf_counter() - t0:.1f} s")
    ap, rise, ratio = np.median(np.asarray(runs), axis=0)
    log(f"[train_eval] overfit median: AP50 {ap:.4f}, rise {rise:.4f}, "
        f"last/first loss {ratio:.4f}")
    require(ap > 0.5 and rise > 0.3 and ratio < 0.75,
            f"the tiny overfit missed the bar: {runs}")


def cli_round_trip():
    """(b) cli.train on a synthetic `tiny` split (6 steps, a checkpoint
    every 2), --resume to 9, then cli.eval --json on the checkpoints:
    its metrics must equal an in-process Tester's on the restored
    parameters. Returns the split (loader, proposals)."""
    work = fresh_dir("cli")
    ds, run = os.path.join(work, "ds"), os.path.join(work, "run")
    args = ["--preset", "tiny", "--synthetic", "--dataset-root", ds,
            "--device", "cuda"]
    train_args = ["--no-final-eval", "--set", f"train.checkpoint_dir={run}",
                  "--set", "train.checkpoint_every=2",
                  "--set", "train.log_every=2"]
    ckpt = Checkpointer(os.path.join(run, "ckpt"))
    train_cli.main([*args, "--steps", "6", *train_args])
    require(ckpt.all_steps() == [2, 4, 6], f"checkpoints {ckpt.all_steps()}")
    train_cli.main([*args, "--steps", "9", "--resume", *train_args])
    require(ckpt.all_steps() == [6, 8, 9],
            f"checkpoints after --resume {ckpt.all_steps()}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        eval_cli.main([*args, "--checkpoint-dir", run, "--json"])
    got = json.loads(out.getvalue().strip().splitlines()[-1])
    cfg = preset("tiny")
    loader = CocoLoader(os.path.join(ds, "annotations",
                                     "instances_synthetic.json"),
                        os.path.join(ds, "synthetic"))
    props = ProposalStore.load(os.path.join(ds, "proposals_synthetic.npz"))
    trainer, state = common.restore_float_state(cfg, run, device="cuda")
    want = Tester(trainer.model, cfg, loader, props, device="cuda").test()
    want = {k: round(v, 5) for k, v in want.items()}
    log(f"[train_eval] cli.eval at step {state.step}: {json.dumps(got)}")
    require(state.step == 9 and got == want,
            f"cli.eval {got} differs from the in-process Tester {want}")
    return loader, props


def exact_resume(loader, props):
    """(c) Two steps, a checkpoint, a fresh Trainer restored from it and one
    step, against three steps straight: loss, parameters, momentum and the
    generator's state equal bit for bit."""
    cfg = preset("tiny")
    batches = list(DetectionPipeline(loader, props, cfg.data,
                                     batch_size=2).epoch(0))[:3]
    straight = Trainer(cfg, device="cuda")
    state = straight.init_state(0)
    ckpt = Checkpointer(fresh_dir("resume"))
    for b in batches[:2]:
        state, _ = straight.step(state, b)
    ckpt.save(straight, state)
    state, want = straight.step(state, batches[2])
    resumed = Trainer(cfg, device="cuda")
    restored = ckpt.restore_latest(resumed, resumed.init_state(1))
    restored, got = resumed.step(restored, batches[2])
    params = dict(straight.model.named_parameters())
    moved = [n for n, p in resumed.model.named_parameters()
             if not torch.equal(p, params[n])]
    sa = state.optimizer.sgd.state_dict()["state"]
    sb = restored.optimizer.sgd.state_dict()["state"]
    momentum = [k for k in sa if not torch.equal(
        sa[k]["momentum_buffer"], sb[k]["momentum_buffer"])]
    gen_eq = torch.equal(state.generator.get_state(),
                         restored.generator.get_state())
    loss_eq = torch.equal(got["loss"], want["loss"])
    log(f"[train_eval] resume 2 + 1 against 3 steps: loss "
        f"{'equal' if loss_eq else 'differs'}, {len(moved)} parameters and "
        f"{len(momentum)} momentum buffers differ, generator state "
        f"{'equal' if gen_eq else 'differs'}")
    require(loss_eq and not moved and not momentum and gen_eq
            and restored.step == state.step == 3, "resume is not exact")


def train_from_disk(loader, props, resident_ms, resident_ips):
    """(d) Trainer on `multipath_vgg16_train` at full width over phase 13's
    split through epoch_on_device: 6 steps (the first apart), then one
    profiled. Returns this part's launches."""
    cfg = preset("multipath_vgg16_train")
    require(loader.num_classes == cfg.model.num_classes,
            f"{loader.num_classes} classes on disk, "
            f"{cfg.model.num_classes} in the preset")
    trainer = Trainer(cfg, device="cuda")
    state = trainer.init_state(0)
    seeded_normal_(trainer.model, 0)
    pipe = DetectionPipeline(loader, props, cfg.data,
                             batch_size=cfg.train.batch_size, seed=0)

    def batches():
        epoch = 0
        while True:
            yield from pipe.epoch_on_device(epoch, trainer.stream_batch)
            epoch += 1

    it = batches()
    before = read_launches()
    t0 = time.perf_counter()
    state, metrics = trainer.step(state, next(it))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    history = [metrics]
    iters, b = 5, cfg.train.batch_size
    t0 = time.perf_counter()
    for _ in range(iters):
        state, metrics = trainer.step(state, next(it))
        history.append(metrics)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    now = read_launches()
    launches = {k: now[k] - before[k] for k in now}
    losses = [float(h["loss"]) for h in history]
    log(f"[train_eval] multipath_vgg16_train from disk: first step "
        f"{first_s:.2f} s; {iters} steps x {b} images in {dt:.3f} s = "
        f"{1e3 * dt / iters:.2f} ms/step, {b * iters / dt:.2f} img/s "
        f"(phase 7, one resident batch, this process and card: "
        f"{resident_ms:.2f} ms/step, {resident_ips:.2f} img/s); losses "
        + ", ".join(f"{v:.4g}" for v in losses))
    log(f"[train_eval] kernel launches in the {iters + 1} steps: {launches}")
    require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    for name in ("window_pool_multi", "window_grad", "window_rmw_grad"):
        require(launches[name] > 0, f"{name} never launched in training "
                f"from disk")
    busy = profile_once("train_eval", "one step from disk (its batch "
                        "fetched in the window)",
                        lambda: trainer.step(state, next(it)), top=12)
    log(f"[train_eval] device busy in one step from disk: {100 * busy:.1f}%")
    it.close()


def train_eval_path(loader, props, resident_ms, resident_ips):
    """Phase 14: (a)-(c) at `tiny` under cudnn.deterministic (each run
    repeats bit for bit), (d) at full width under the default settings, as
    phase 7 runs. Returns the phase's launches."""
    reset_launches()
    torch.backends.cudnn.deterministic = True
    try:
        overfit_tiny()
        tiny_loader, tiny_props = cli_round_trip()
        exact_resume(tiny_loader, tiny_props)
    finally:
        torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()
    train_from_disk(loader, props, resident_ms, resident_ips)
    return read_launches()


# ------------------------------------------------------------ phase 15 ---

RESNET_STAGES = {"resnet18": (2, 2, 2), "resnet50": (3, 4, 6),
                 "resnet101": (3, 4, 23)}


def torchvision_resnet_state(name: str, seed: int) -> dict:
    """A torchvision-layout ResNet trunk (conv1, bn1, layer1-3; basic
    blocks for resnet18, bottlenecks otherwise) as numpy arrays from a
    seed: convolutions He-normal, BN weight U(0.2, 0.6), bias N(0, 0.1),
    running mean N(0, 0.1), running variance from a positive draw
    U(0.5, 2)."""
    rng = np.random.default_rng(seed)
    out = {}

    def conv(key, cout, cin, k):
        out[f"{key}.weight"] = (rng.standard_normal((cout, cin, k, k),
                                                    dtype=np.float32)
                                * np.float32(np.sqrt(2.0 / (cin * k * k))))

    def bn(key, c):
        out[f"{key}.weight"] = rng.uniform(0.2, 0.6, c).astype(np.float32)
        out[f"{key}.bias"] = (rng.standard_normal(c, dtype=np.float32)
                              * np.float32(0.1))
        out[f"{key}.running_mean"] = (rng.standard_normal(c, dtype=np.float32)
                                      * np.float32(0.1))
        out[f"{key}.running_var"] = rng.uniform(0.5, 2.0, c).astype(
            np.float32)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    basic = name == "resnet18"
    cin, width = 64, 64
    for layer, n in enumerate(RESNET_STAGES[name], start=1):
        cout = width if basic else 4 * width
        for blk in range(n):
            src = f"layer{layer}.{blk}"
            stride = 2 if layer > 1 and blk == 0 else 1
            if basic:
                convs = ((width, cin, 3), (width, width, 3))
            else:
                convs = ((width, cin, 1), (width, width, 3), (cout, width, 1))
            for k, (o, i, ks) in enumerate(convs, start=1):
                conv(f"{src}.conv{k}", o, i, ks)
                bn(f"{src}.bn{k}", o)
            if blk == 0 and (cin != cout or stride != 1):
                conv(f"{src}.downsample.0", cout, cin, 1)
                bn(f"{src}.downsample.1", cout)
            cin = cout
        width *= 2
    return out


def resnet_model(cfg, seed: int = 0, param_dtype=None, model=None):
    """The model for cfg (a ResNet trunk) on the card: every parameter
    normal * 0.02 (seeded_normal_), then the trunk, BN statistics included,
    from a seeded torchvision-layout state dict through the port's
    import_weights. Returns (model, parameter count)."""
    model = model or build_model(cfg.model, device="cuda",
                                 param_dtype=param_dtype)
    n_params = seeded_normal_(model, seed)
    state = torchvision_resnet_state(cfg.model.backbone, seed)
    mapper = getattr(import_weights,
                     f"{cfg.model.backbone}_params_from_state_dict")
    import_weights.install_params(model, mapper(state))
    return model, n_params


def bn_pass_ms(run):
    """The frozen-BN passes of one run(): every FrozenBatchNorm input
    recorded by shape, then each BN timed alone (its float32 input in
    channels_last, its bf16 output) on random data. -> (ms, count)."""
    seen = []
    forward = layers.FrozenBatchNorm.forward

    def record(self, x, dtype):
        seen.append((self, tuple(x.shape), dtype))
        return forward(self, x, dtype)

    layers.FrozenBatchNorm.forward = record
    try:
        with torch.no_grad():
            run()
    finally:
        layers.FrozenBatchNorm.forward = forward
    total = 0.0
    with torch.no_grad():
        for mod, shape, dtype in seen:
            x = torch.randn(shape, device="cuda").contiguous(
                memory_format=torch.channels_last)
            total += cuda_ms(lambda: mod(x, dtype), 5)
            del x
    return total, len(seen)


def check_detections(tag, out, b=8, d=100):
    for key, shape in (("boxes", (b, d, 4)), ("scores", (b, d)),
                       ("classes", (b, d)), ("valid", (b, d))):
        require(out[key].shape == shape, f"[{tag}] {key} shape "
                f"{out[key].shape}")
    require(np.isfinite(out["boxes"]).all()
            and np.isfinite(out["scores"]).all(),
            f"[{tag}] non-finite detections")


def resnet_serve(cfg, tag: str, iters: int, profile: bool = False):
    """Detector at 8 x 1000 proposals, 640^2, on cfg's ResNet model:
    first call, `iters` timed batches (img/s), peak device memory, finite
    detections of the right shapes; with `profile`, one profiled batch
    (device ms, busy share) and the BN passes timed. Returns a dict of the
    numbers."""
    b, p = 8, cfg.data.max_proposals
    canvas = cfg.data.image_size[0]
    require((b, p, canvas) == (8, 1000, 640),
            f"unexpected {tag} shape {(b, p, canvas)}")
    t0 = time.perf_counter()
    model, n_params = resnet_model(cfg)
    torch.cuda.synchronize()
    log(f"[{tag}] {cfg.model.backbone}: {n_params / 1e6:.1f}M params "
        f"({cfg.model.dtype}), trunk from a torchvision-layout state dict "
        f"through import_weights, on the card in "
        f"{time.perf_counter() - t0:.1f}s")
    det = Detector(model, cfg, "cuda")
    inputs = make_inputs(b, p, canvas)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = det(*inputs)
    first_s = time.perf_counter() - t0
    check_detections(tag, out)
    dev_inputs = [torch.as_tensor(x).cuda() for x in inputs]
    detect_batch(model, cfg, *dev_inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        detect_batch(model, cfg, *dev_inputs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    res = {"ips": b * iters / dt, "ms": 1e3 * dt / iters, "first_s": first_s,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"[{tag}] first call {first_s:.2f} s; steady: {iters} batches x {b} "
        f"images in {dt:.3f} s = {res['ips']:.2f} img/s ({res['ms']:.2f} "
        f"ms/batch); peak device memory {res['peak_gib']:.2f} GiB")
    if profile:
        res["busy"] = profile_once(
            tag, "one batch", lambda: detect_batch(model, cfg, *dev_inputs))
        res["device_ms"] = profile_once.device_ms
        res["bn_ms"], res["bn_calls"] = bn_pass_ms(
            lambda: detect_batch(model, cfg, *dev_inputs))
        log(f"[{tag}] frozen-BN passes per batch (float32 in, one rounding "
            f"out, models/layers.FrozenBatchNorm): {res['bn_ms']:.3f} ms "
            f"over {res['bn_calls']} BN layers")
    del model, det
    return res


def resnet_train(cfg):
    """(c) Trainer on multipath_resnet18_integral at full width: 1 + 5
    steps, ms/step, finite losses, K1/K3/K4 launched in them; BN buffers
    and frozen stages bit-unchanged; a profiled step; two steps from one
    state equal under cudnn.deterministic. Returns ({"ms", "busy",
    "device_ms"}, the 6 steps' launches)."""
    m, d, t = cfg.model, cfg.data, cfg.train
    shape = (m.backbone, t.batch_size, d.image_size, d.max_proposals,
             d.rois_per_image, t.freeze_backbone_stages, m.dtype)
    require(shape == ("resnet18", 8, (640, 640), 1000, 64, 2, "bfloat16"),
            f"unexpected ResNet train shape {shape}")
    trainer = Trainer(cfg, device="cuda")
    state = trainer.init_state(0)
    resnet_model(cfg, model=trainer.model)
    require(all(p.dtype == torch.float32
                for p in trainer.model.parameters()),
            "training parameters must be float32")
    frozen = {n: p.detach().clone()
              for n, p in trainer.model.named_parameters()
              if n in trainer.frozen}
    buffers = {n: b.clone() for n, b in trainer.model.named_buffers()}
    require(frozen and all(n.startswith(("backbone.stem",
                                         "backbone.stage2_"))
                           for n in frozen) and buffers,
            f"frozen set {sorted(frozen)[:4]}..., {len(buffers)} buffers")
    batch = trainer.put_batch(train_batch(cfg))
    start = read_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, metrics = trainer.step(state, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    losses = [float(metrics["loss"])]
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        state, metrics = trainer.step(state, batch)
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / iters
    launches = {k: v - start[k] for k, v in read_launches().items()}
    log(f"[resnet_train] first step {first_s:.2f} s; {iters} steps "
        f"{ms:.2f} ms/step, {8 * 1e3 / ms:.2f} img/s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; losses "
        f"{[round(x, 4) for x in losses]}")
    log(f"[resnet_train] kernel launches in {iters + 1} steps: {launches}")
    require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    for name in ("window_pool_multi", "window_grad", "window_rmw_grad"):
        require(launches[name] > 0, f"{name} never launched in ResNet "
                f"training: {launches}")
    params = dict(trainer.model.named_parameters())
    for n, before in frozen.items():
        require(torch.equal(params[n], before), f"frozen {n} moved")
    for n, b in trainer.model.named_buffers():
        require(torch.equal(b, buffers[n]), f"BN buffer {n} moved")
    log(f"[resnet_train] {len(frozen)} frozen tensors and {len(buffers)} BN "
        f"buffers bit-unchanged after {iters + 1} steps")
    busy = profile_once("resnet_train", "one step",
                        lambda: trainer.step(state, batch), top=16)
    dev_ms = profile_once.device_ms
    saved = snapshot_train_state(trainer, state)
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for _ in range(2):
            st = restore_train_state(trainer, saved)
            _, mt = trainer.step(st, batch)
            runs.append((mt["loss"].clone(),
                         {n: p.detach().clone() for n, p in params.items()}))
    finally:
        torch.backends.cudnn.deterministic = False
    moved = [n for n in runs[0][1]
             if not torch.equal(runs[0][1][n], runs[1][1][n])]
    equal = bool(torch.equal(runs[0][0], runs[1][0])) and not moved
    log(f"[resnet_train] two steps from one state, cudnn.deterministic: "
        f"{'equal' if equal else 'NOT equal'} ({len(moved)} parameters "
        f"differ)")
    require(equal, "two ResNet steps from one state differ")
    restore_train_state(trainer, saved)
    return {"ms": ms, "busy": busy, "device_ms": dev_ms}, launches


def resnet_path():
    """Phase 15 (`resnet`), launches counted from 0 over the whole phase:
    (a) ResNet-18 serving, (b) ResNet-50/101 serving, (c) ResNet-18
    training, (d) AlexNet through Detector."""
    reset_launches()
    cfg18 = preset("multipath_resnet18_integral")
    a = resnet_serve(cfg18, "resnet18", 10, profile=True)
    serve = read_launches()
    log(f"[resnet18] kernel launches in (a): {serve}")
    require(serve["window_pool_multi"] > 0 and serve["resident_pool"] > 0,
            f"ResNet-18 serving never reached K1/K2: {serve}")
    torch.cuda.empty_cache()
    cfg50 = preset("sharpmask_multipath_e2e")
    require(cfg50.model.backbone == "resnet50", cfg50.model.backbone)
    b50 = resnet_serve(cfg50, "resnet50", 3)
    torch.cuda.empty_cache()
    cfg101 = cfg50.replace(model=dataclasses.replace(cfg50.model,
                                                     backbone="resnet101"))
    b101 = resnet_serve(cfg101, "resnet101", 3)
    torch.cuda.empty_cache()
    train_res, _ = resnet_train(cfg18)
    torch.cuda.empty_cache()
    cfga = preset("multipath_vgg16_batched")
    cfga = cfga.replace(model=dataclasses.replace(cfga.model,
                                                  backbone="alexnet"))
    model = build_model(cfga.model, device="cuda")
    seeded_normal_(model, 0)
    hw = cfga.data.image_size[0]
    out = Detector(model, cfga, "cuda")(*make_inputs(
        8, cfga.data.max_proposals, hw))
    check_detections("alexnet", out)
    with torch.no_grad():
        x = torch.randn(8, hw, hw, 3, device="cuda")
        feats = model.backbone(x)
    for lv, stride in LEVELS:
        c = model.backbone.feature_channels[lv]
        require(tuple(feats[lv].shape) == (8, hw // stride, hw // stride, c)
                and bool(torch.isfinite(feats[lv]).all()),
                f"alexnet {lv} {tuple(feats[lv].shape)}")
    log(f"[alexnet] one Detector batch at 8 x {cfga.data.max_proposals}, "
        f"{hw}^2: "
        f"{int(out['valid'].sum())} detections, finite; c3/c4/c5 "
        f"{[tuple(feats[lv].shape) for lv, _ in LEVELS]}")
    del model
    launches = read_launches()
    log(f"[resnet] serving img/s at 8 x 1000 proposals, 640^2 "
        f"(ResNet-18 {a['ips']:.2f}, ResNet-50 {b50['ips']:.2f}, "
        f"ResNet-101 {b101['ips']:.2f}); peak GiB {a['peak_gib']:.2f} / "
        f"{b50['peak_gib']:.2f} / {b101['peak_gib']:.2f}; ResNet-18 "
        f"{a['device_ms']:.2f} device ms a batch, {100 * a['busy']:.1f}% "
        f"busy, BN passes {a['bn_ms']:.3f} ms; train {train_res['ms']:.2f} "
        f"ms/step, {train_res['device_ms']:.2f} device ms, "
        f"{100 * train_res['busy']:.1f}% busy")
    log(f"[resnet] kernel launches over phase 15: {launches}")
    return launches


# ------------------------------------------------------------ phase 16 ---

def reference_contract_state(cfg, seed: int) -> dict:
    """A seeded state dict in the reference's torch contract for cfg
    (features.N of VGG-16, reduce, fc6.{i}, fc7.{i}, classifier.{k},
    bbox), numpy float32: convolutions He-normal with conv1_1 scaled by
    1/128 for 0-255 pixels, fully connected layers normal * sqrt(1 /
    fan_in), biases N(0, 0.01)."""
    m = cfg.model
    gen = torch.Generator().manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=gen).mul_(std).numpy()

    state, cin = {}, 3
    chans = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
    for i, (idx, c) in enumerate(zip(import_weights.VGG16_TORCH_INDICES,
                                     chans)):
        std = np.sqrt(2.0 / (9 * cin)) / (128.0 if i == 0 else 1.0)
        state[f"features.{idx}.weight"] = normal((c, cin, 3, 3), std)
        state[f"features.{idx}.bias"] = normal(c, 0.01)
        cin = c
    skip = sum({"c3": 256, "c4": 512, "c5": 512}[lv] for lv in m.skip_levels)
    d, g, f = m.skip_reduce_dim, m.roi_output_size, len(m.foveal_scales)
    state["reduce.weight"] = normal((d, skip, 1, 1), np.sqrt(2.0 / skip))
    state["reduce.bias"] = normal(d, 0.01)
    for i in range(f):
        state[f"fc6.{i}.weight"] = normal((m.fc_dim, g * g * d),
                                          np.sqrt(1.0 / (g * g * d)))
        state[f"fc6.{i}.bias"] = normal(m.fc_dim, 0.01)
        state[f"fc7.{i}.weight"] = normal((m.fc_dim, m.fc_dim),
                                          np.sqrt(1.0 / m.fc_dim))
        state[f"fc7.{i}.bias"] = normal(m.fc_dim, 0.01)
    for k in range(len(m.integral_thresholds)):
        state[f"classifier.{k}.weight"] = normal((m.num_classes,
                                                  f * m.fc_dim),
                                                 np.sqrt(1.0 / m.fc_dim))
        state[f"classifier.{k}.bias"] = normal(m.num_classes, 0.01)
    state["bbox.weight"] = normal((4 * m.num_classes, f * m.fc_dim), 1e-3)
    state["bbox.bias"] = normal(4 * m.num_classes, 0.01)
    return state


def reference_exact_path():
    """Phase 16 (`reference_exact`): multipath_vgg16_reference through
    Detector at 8 x 1000 proposals, 640^2, weights from the reference's
    torch contract through import_weights; then the max route held to the
    CPU. Returns (launches, ms per batch)."""
    cfg = preset("multipath_vgg16_reference")
    m = cfg.model
    proposals, hw = cfg.data.max_proposals, cfg.data.image_size[0]
    require((m.roi_mode, m.preprocess, m.roi_impl, m.backbone) ==
            ("max", "caffe_bgr", "direct", "vgg16"),
            f"unexpected reference preset {m}")
    t0 = time.perf_counter()
    state = reference_contract_state(cfg, 0)
    imported = {
        **import_weights.vgg16_params_from_state_dict(state),
        **import_weights.multipath_head_params_from_state_dict(
            state, skip_channels={"c3": 256, "c4": 512, "c5": 512},
            roi_output_size=m.roi_output_size)}
    del state
    model = build_model(m, device="cuda")
    import_weights.install_params(model, imported)
    require(set(imported) == set(model.state_dict()),
            "the contract did not cover the model")
    del imported
    torch.cuda.synchronize()
    log(f"[reference_exact] multipath_vgg16_reference ({m.dtype}, roi_mode "
        f"max, caffe_bgr, roi_impl direct): every weight from a seeded "
        f"torch-contract state dict through import_weights in "
        f"{time.perf_counter() - t0:.1f}s")
    reset_launches()
    det = Detector(model, cfg, "cuda")
    inputs = make_inputs(8, proposals, hw)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = det(*inputs)
    first_s = time.perf_counter() - t0
    check_detections("reference_exact", out)
    dev_inputs = [torch.as_tensor(x).cuda() for x in inputs]
    iters = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        detect_batch(model, cfg, *dev_inputs)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / iters
    log(f"[reference_exact] 8 x {proposals} proposals, {hw}^2: first call "
        f"{first_s:.2f} s, {ms:.2f} ms/batch ({8e3 / ms:.2f} img/s) over "
        f"{iters} batches; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"{int(out['valid'].sum())} detections")
    profile_once("reference_exact", "one batch",
                 lambda: detect_batch(model, cfg, *dev_inputs))
    launches = read_launches()
    require(not any(launches.values()),
            f"the exact max route launched a window kernel: {launches}")

    # the route held to the CPU: one image's raw maps, 64 ROIs, every level
    images, hws, boxes, _ = inputs
    with torch.no_grad():
        canvas, scale = transforms.batch_resize_to_canvas(
            dev_inputs[0][:1], (hw, hw), dev_inputs[1][:1], "caffe_bgr")
        feats = model.features(canvas)
    rois = (torch.from_numpy(boxes[:1, :64]).cuda() * scale[:, None, None])
    strides = model.backbone.feature_strides
    scales = {lv: 1.0 / strides[lv] for lv in m.skip_levels}
    for factors, levels in model._view_level_plan():
        args = dict(scales=scales, foveal_factors=factors,
                    image_hw=(hw, hw), output_size=m.roi_output_size)
        got = roi_ops.multilevel_foveal_roi_features(
            {lv: feats[lv][0] for lv in levels}, rois[0], **args)
        want = roi_ops.multilevel_foveal_roi_features(
            {lv: feats[lv][0].cpu() for lv in levels}, rois[0].cpu(), **args)
        require(torch.equal(got.cpu(), want),
                f"the exact max route on the card differs from the CPU "
                f"({factors}, {levels})")
    with torch.no_grad():
        got = model.pool_rois(feats, rois, (hw, hw)).float().cpu()
        reduces = [getattr(model, f"reduce_{lv}") for lv in m.skip_levels]
        for mod in reduces:  # the same model, its 1x1 reduces on the CPU
            mod.cpu()
        want = model.pool_rois({lv: f.cpu() for lv, f in feats.items()},
                               rois.cpu(), (hw, hw)).float()
        for mod in reduces:
            mod.cuda()
    # the three levels' 1x1 reduces round their float32 sums (summed in
    # another order by cuDNN and oneDNN) to bf16, and the two level sums
    # round again: four bf16 steps at the largest magnitude bound them
    step = 2.0 ** (float(torch.floor(torch.log2(want.abs().max()))) - 7)
    share = float((got != want).float().mean())
    diff = float((got - want).abs().max())
    log(f"[reference_exact] 64 ROIs of one image, every level: the max "
        f"pooling equal to the CPU's bit for bit; after the bf16 1x1 "
        f"reduces (cuDNN against oneDNN) and the level sums "
        f"{100 * share:.3f}% of values differ, largest {diff:.4g} ("
        f"{diff / step:.1f} bf16 steps at the largest magnitude, at most 4 "
        f"allowed)")
    require(diff <= 4 * step,
            "the reduced max route is more than four bf16 steps off the CPU")
    # windowed == exact where every bin spans at most one base cell
    rng = np.random.default_rng(1)
    xy = rng.uniform(0, hw - 40, (512, 2))
    wh = rng.uniform(2, 28, (512, 2))
    small = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(
        np.float32)).cuda()
    for lv in m.skip_levels:
        pyr = roi_pyramid.build_pyramid(feats[lv][0], scales[lv],
                                        mode="max")
        exact = roi_ops.roi_pool_max(feats[lv][0], small,
                                     spatial_scale=scales[lv]).float()
        windowed = roi_pyramid.pyramid_roi_align(pyr, small)
        require(torch.equal(exact, windowed),
                f"windowed and exact max routes differ at {lv}")
    log("[reference_exact] windowed route equal to the exact one, bit for "
        "bit, on 512 views up to 28 px at c3/c4/c5")
    del model, det, feats
    return launches, ms


# ------------------------------------------------------------ phase 17 ---

def sharpmask_trainer(cfg, seed: int = 0):
    """ProposalTrainer for cfg on the card (float32 parameters, cfg's
    compute dtype, canvas-relative anchors, its neck level) with phase
    15's weights: every parameter normal * 0.02, then the trunk, BN
    statistics included, from a seeded torchvision-layout state dict.
    Returns (trainer, state)."""
    trainer = ProposalTrainer(cfg, device="cuda")
    state = trainer.init_state(seed)
    resnet_model(cfg, seed, model=trainer.model)
    return trainer, state


def timed_ms(fn, iters: int) -> float:
    """Host wall ms per call of fn over `iters` calls, after one warm-up,
    synchronized at both ends."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def sharpmask_e2e(cfg, trainer):
    """(a) Config 5 end to end at full width: generate_proposals (top 1000,
    the cascade, 28 x 28 masks) on 8 images of 640^2 feeding the ResNet-50
    detector at 1000 proposals per image, all on the card: ms a batch for
    generation with and without masks, detection and end to end (img/s),
    peak memory, one profiled end-to-end batch; K1/K2 must launch. Returns
    (the numbers, the images on the card)."""
    b, p, hw = cfg.train.batch_size, cfg.data.max_proposals, \
        cfg.data.image_size[0]
    images, src_hws, _, _ = make_inputs(b, p, hw, seed=3)
    x_u8 = torch.as_tensor(images, device="cuda")
    hws = torch.as_tensor(src_hws, device="cuda")
    prop_mask = torch.ones(b, p, dtype=torch.bool, device="cuda")
    model = trainer.model.eval()
    det_model, n_det = resnet_model(cfg, seed=1)

    def generate(masks=True):
        return generate_proposals(model, transforms.normalize(x_u8),
                                  top_k=p, with_masks=masks)

    def detect(props):
        return detect_batch(det_model, cfg, x_u8, hws, props["boxes"],
                            prop_mask)

    def e2e():
        return detect(generate())

    with torch.no_grad():
        n_anchors = model.dense(transforms.normalize(x_u8[:1]))[1].shape[1]
    require(n_anchors == (hw // 16) ** 2 * 12,
            f"{n_anchors} anchors per image")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    props = generate()
    torch.cuda.synchronize()
    first_gen = time.perf_counter() - t0
    for key, shape in (("boxes", (b, p, 4)), ("scores", (b, p)),
                       ("masks", (b, p, 28, 28))):
        v = props[key]
        require(tuple(v.shape) == shape and bool(torch.isfinite(v).all()),
                f"[sharpmask] {key} {tuple(v.shape)}")
    bx = props["boxes"]
    require(bool((bx >= 0).all() and (bx <= hw).all()
                 and (props["scores"] >= 0).all()
                 and (props["scores"] <= 1).all()
                 and (props["masks"] >= 0).all()
                 and (props["masks"] <= 1).all()), "[sharpmask] ranges")
    reset_launches()
    out = {k: v.cpu().numpy() for k, v in e2e().items()}
    check_detections("sharpmask", out)
    iters = 3
    gen_ms = timed_ms(generate, iters)
    gen_nomask_ms = timed_ms(lambda: generate(False), iters)
    det_ms = timed_ms(lambda: detect(props), iters)
    e2e_ms = timed_ms(e2e, iters)
    launches = read_launches()
    res = {"gen_ms": gen_ms, "gen_nomask_ms": gen_nomask_ms,
           "det_ms": det_ms, "e2e_ms": e2e_ms, "ips": 1e3 * b / e2e_ms,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "first_gen_s": first_gen}
    log(f"[sharpmask] config 5 at {b} x {p} proposals, {hw}^2 "
        f"({cfg.model.backbone}, {cfg.model.dtype}; {n_anchors} anchors "
        f"an image; detector {n_det / 1e6:.1f}M params): first generation "
        f"{first_gen:.2f} s; generation {gen_ms:.2f} ms/batch with 28 x 28 "
        f"masks, {gen_nomask_ms:.2f} without; detection {det_ms:.2f} "
        f"ms/batch; end to end {e2e_ms:.2f} ms/batch = {res['ips']:.2f} "
        f"img/s over {iters} batches; peak device memory "
        f"{res['peak_gib']:.2f} GiB; {int(out['valid'].sum())} detections")
    log(f"[sharpmask] kernel launches in the end-to-end runs: {launches}")
    require(launches["window_pool_multi"] > 0
            and launches["resident_pool"] > 0,
            f"config 5's detector never reached K1/K2: {launches}")
    res["busy"] = profile_once("sharpmask", "one end-to-end batch", e2e,
                               top=16)
    res["device_ms"] = profile_once.device_ms
    del det_model, props
    return res, x_u8


def decode_routes(model, x_u8, hw):
    """(b) The eval ("pyramid") and training ("direct") mask decodes of
    64 ROIs on the card (2 images x 24 ROIs of 40-100 px, inside level 0
    of the 28 x 28 pyramid at stride 4, and 8 of 300-600 px), held to
    tests/test_torch_sharpmask.py's bar: level-0 logits within 5e-2, their
    mean difference below 1e-2; the large ones correlated above 0.6; the
    mean probability difference below 0.02."""
    rng = np.random.default_rng(4)
    w = np.concatenate([rng.uniform(40, 100, (2, 24)),
                        rng.uniform(300, 600, (2, 8))], 1)
    xy = rng.uniform(0, 1, (2, 32, 2)) * (hw - w[..., None])
    rois = torch.from_numpy(np.concatenate(
        [xy, xy + w[..., None]], -1).astype(np.float32)).cuda()
    with torch.no_grad():
        feats = model.dense(transforms.normalize(x_u8[:2]))[3]
        outs = {impl: model.decode_masks(feats, rois, (hw, hw), impl=impl)
                for impl in ("direct", "pyramid")}
    d0 = (outs["pyramid"][:, :24] - outs["direct"][:, :24]).abs()
    corr = float(np.corrcoef(
        outs["pyramid"][:, 24:].flatten().cpu().numpy(),
        outs["direct"][:, 24:].flatten().cpu().numpy())[0, 1])
    dprob = float((torch.sigmoid(outs["pyramid"])
                   - torch.sigmoid(outs["direct"])).abs().mean())
    log(f"[sharpmask] decode routes, 64 ROIs: level 0 max |pyramid - "
        f"direct| {float(d0.max()):.4g} (mean {float(d0.mean()):.4g}; logits "
        f"up to {float(outs['direct'].abs().max()):.3g}), large ROIs "
        f"correlation {corr:.4f}, mean probability difference {dprob:.4g}")
    require(float(d0.max()) <= 5e-2 and float(d0.mean()) < 1e-2
            and corr > 0.6 and dprob < 0.02,
            "the pyramid mask decode is off the direct one")


def sharpmask_train(cfg, trainer, state):
    """(c) ProposalTrainer at full width on a synthetic batch (phase 7's
    generator at this preset's shapes: 8 images at 640^2, 5-20 GT per
    image padded to 100, random 28 x 28 mask targets): 5 steps after a
    first one (ms/step), every loss finite, one profiled step, then two
    steps from one state (equal required under cudnn.deterministic)."""
    rng = np.random.default_rng(5)
    batch = train_batch(cfg, seed=5)
    g = cfg.data.max_gt_per_image
    batch = trainer.put_batch(batch._replace(gt_masks=(rng.uniform(
        size=(cfg.train.batch_size, g, 28, 28)) > 0.5).astype(np.float32)))
    trainer.model.train()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m = trainer.step(state, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    history, iters = [m], 5
    t0 = time.perf_counter()
    for _ in range(iters):
        state, m = trainer.step(state, batch)
        history.append(m)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / iters
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(h["loss"]) for h in history]
    log(f"[sharpmask] proposal train step at full width: first "
        f"{first_s:.2f} s, {ms:.2f} ms/step over {iters} steps "
        f"({1e3 * cfg.train.batch_size / ms:.2f} img/s), peak device memory "
        f"{peak:.2f} GiB; losses {[round(x, 4) for x in losses]}; last: "
        + ", ".join(f"{k} {float(v):.4g}" for k, v in m.items()))
    require(all(np.isfinite(float(v)) for h in history for v in h.values()),
            "a non-finite proposal loss")
    busy = profile_once("sharpmask_train", "one step",
                        lambda: trainer.step(state, batch), top=16)
    repeat_steps(trainer, state, batch, tag="sharpmask_train")
    return {"ms": ms, "peak_gib": peak, "busy": busy,
            "device_ms": profile_once.device_ms}


def proposal_quality(model, loader, refine, top_k=32):
    """tests/test_sharpmask.py's _proposal_quality on the card: (median
    best IoU over the proposals, share at IoU >= 0.5, oracle (mean best
    proposal IoU per GT), GT recall at 0.5)."""
    from multipathnet_tpu_torch.ops.boxes import iou_matrix

    ious, gt_best = [], []
    for i in range(len(loader)):
        x = transforms.normalize(torch.from_numpy(loader.load_image(i).astype(
            np.float32)).cuda())[None]
        out = generate_proposals(model, x, top_k=top_k, with_masks=False,
                                 refine=refine)
        iou = iou_matrix(out["boxes"][0], torch.as_tensor(
            loader.annotations(i)["boxes"], dtype=torch.float32,
            device="cuda")).cpu().numpy()
        ious.append(iou.max(1))
        gt_best.append(iou.max(0))
    ious, gt_best = np.concatenate(ious), np.concatenate(gt_best)
    return (float(np.median(ious)), float((ious >= 0.5).mean()),
            float(gt_best.mean()), float((gt_best >= 0.5).mean()))


def proposal_overfit():
    """(d) The reference's proposal-quality bar on the card: `tiny` (bf16),
    30 epochs at lr 5e-3 on synthetic.generate(seed=21), batch 2, for init
    seeds 0-4; the median of each number over the seeds must reach refined
    median IoU >= 0.4, >= 30% of boxes at IoU >= 0.5, oracle >= 0.75,
    recall@0.5 >= 0.9 and a refined median >= the stage-1 median + 0.05."""
    fx = synthetic.generate(fresh_dir("proposal_overfit"), num_images=8,
                            image_size=64, num_classes=4,
                            proposals_per_image=8, seed=21)
    cfg = preset("tiny")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, num_classes=5),
                      train=dataclasses.replace(cfg.train, lr=5e-3))
    loader = CocoLoader(fx["annotations"], fx["images"])
    pipe = DetectionPipeline(loader, ProposalStore.load(fx["proposals"]),
                             cfg.data, batch_size=2, seed=0,
                             with_masks=True, mask_size=28)
    trainer = ProposalTrainer(cfg, device="cuda")
    runs = []
    for seed in range(5):
        t0 = time.perf_counter()
        state, losses = trainer.init_state(seed), []
        for ep in range(30):
            for batch in pipe.epoch_on_device(ep, trainer.stream_batch):
                state, m = trainer.step(state, batch)
                losses.append(m["loss"])
        losses = torch.stack(losses).tolist()
        require(np.all(np.isfinite(losses)), f"non-finite loss, seed {seed}")
        med1 = proposal_quality(trainer.model, loader, refine=False)[0]
        med2, f50, oracle, rec = proposal_quality(trainer.model, loader,
                                                  refine=True)
        runs.append((med2, f50, oracle, rec, med2 - med1))
        log(f"[sharpmask] overfit seed {seed}: loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}; stage 1 median IoU {med1:.4f}, refined "
            f"{med2:.4f}, at IoU >= 0.5 {f50:.4f}, oracle {oracle:.4f}, "
            f"recall {rec:.4f}; {time.perf_counter() - t0:.1f} s")
    med2, f50, oracle, rec, lift = np.median(np.asarray(runs), axis=0)
    passed = sum(r[0] >= 0.4 and r[1] >= 0.3 and r[2] >= 0.75
                 and r[3] >= 0.9 and r[4] >= 0.05 for r in runs)
    log(f"[sharpmask] overfit median over seeds 0-4: refined median IoU "
        f"{med2:.4f}, at IoU >= 0.5 {f50:.4f}, oracle {oracle:.4f}, recall "
        f"{rec:.4f}, cascade lift {lift:.4f}; {passed} of 5 seeds reach "
        f"the bar alone")
    require(med2 >= 0.4 and f50 >= 0.3 and oracle >= 0.75 and rec >= 0.9
            and lift >= 0.05, f"the proposal overfit missed the bar: {runs}")


def proposal_cli_chain():
    """(e) The CLI chain at `tiny` on the card: cli.train --proposal-net
    (6 steps, its proposal-recall eval), cli.export_proposals --with-masks
    on its checkpoint, cli.eval on the exported .npz, and cli.demo
    --proposal-source sharpmask writing a PNG."""
    from PIL import Image

    work = fresh_dir("proposal_cli")
    ds, run = os.path.join(work, "ds"), os.path.join(work, "run")
    npz, png = os.path.join(work, "generated.npz"), os.path.join(work,
                                                                 "demo.png")
    base = ["--preset", "tiny", "--synthetic", "--dataset-root", ds,
            "--device", "cuda"]
    train_cli.main([*base, "--steps", "6", "--proposal-net", "--set",
                    f"train.checkpoint_dir={run}", "--set", "train.lr=0.005",
                    "--set", "train.checkpoint_every=3"])
    require(Checkpointer(os.path.join(run, "ckpt")).all_steps() == [3, 6],
            "cli.train --proposal-net checkpoints")
    export_proposals.main([*base, "--proposal-checkpoint-dir", run,
                           "--output", npz, "--top-k", "32",
                           "--with-masks"])
    store = ProposalStore.load(npz)
    require(len(store) == 16 and store.rles is not None
            and len(store.rles) == len(store.boxes) == 16 * 32,
            "the exported proposal file")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        eval_cli.main([*base, "--proposals", npz, "--json"])
    metrics = json.loads(out.getvalue().strip().splitlines()[-1])
    require(all(np.isfinite(v) for v in metrics.values()),
            f"cli.eval on the exported proposals: {metrics}")
    with contextlib.redirect_stdout(io.StringIO()):
        demo.main([*base, "--proposal-source", "sharpmask",
                   "--proposal-checkpoint-dir", run, "--top-proposals", "32",
                   "--output", png])
    size = Image.open(png).size
    require(size == (64, 64), f"demo PNG {size}")
    log(f"[sharpmask] CLI chain: cli.train --proposal-net 6 steps, "
        f"export_proposals {len(store)} images x 32 proposals with RLE "
        f"masks, cli.eval AP50 {metrics['AP50']:.4f} on them, demo PNG "
        f"{size}")


def sharpmask_path():
    """Phase 17 (`sharpmask`), launches counted from 0 over the whole
    phase: (a) config 5 end to end, (b) the two mask decodes, (c) the
    proposal train step at full width, (d) the tiny proposal overfit, (e)
    the CLI chain. Returns (launches, the numbers of (a) and (c))."""
    cfg = preset("sharpmask_multipath_e2e")
    m, d, t = cfg.model, cfg.data, cfg.train
    shape = (m.backbone, m.dtype, t.batch_size, d.image_size,
             d.max_proposals, d.max_gt_per_image)
    require(shape == ("resnet50", "bfloat16", 8, (640, 640), 1000, 100),
            f"unexpected config 5 shape {shape}")
    reset_launches()
    t0 = time.perf_counter()
    trainer, state = sharpmask_trainer(cfg)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    require(trainer.model.neck_level == "c5"
            and trainer.model.anchor_scales == (76.8, 160.0, 320.0, 512.0),
            "the proposal net's neck or anchors")
    log(f"[sharpmask] SharpMaskNet ({m.backbone}, neck c5, anchors "
        f"{trainer.model.anchor_scales} x aspects (0.5, 1, 2)): "
        f"{n_params / 1e6:.1f}M float32 params, {m.dtype} compute, on the "
        f"card in {time.perf_counter() - t0:.1f}s")
    e2e, x_u8 = sharpmask_e2e(cfg, trainer)
    torch.cuda.empty_cache()
    decode_routes(trainer.model, x_u8, d.image_size[0])
    torch.cuda.empty_cache()
    train = sharpmask_train(cfg, trainer, state)
    del trainer, state, x_u8
    torch.cuda.empty_cache()
    proposal_overfit()
    proposal_cli_chain()
    launches = read_launches()
    log(f"[sharpmask] kernel launches over phase 17: {launches}")
    return launches, e2e, train


# ------------------------------------------------------------ phase 18 ---

def http_json(url: str, body: bytes | None = None, timeout: float = 300):
    """-> (status, decoded JSON reply, ms from sending to the parsed
    reply)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, headers={
        "Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    return status, json.loads(raw), 1e3 * (time.perf_counter() - t0)


def serve_path():
    """Phase 18 (`serve`): a float checkpoint of multipath_vgg16_int8
    (weights normal * 0.02), cli.export_serving --quant int8, cli.serve
    --warmup in a process of its own on localhost; 20 requests of one
    640^2 image with 1000 proposals and 2 of 8 images; /healthz before and
    after (the server's kernel launches in between are the path's); the
    HTTP detections equal to a Detector on the bundle called in this
    process on the same padded batches; an oversized image answered 400.
    Returns (launches, the latency numbers)."""
    import subprocess
    import sys
    import threading

    from multipathnet_tpu_torch.eval.serving import load_detector

    cfg = preset("multipath_vgg16_int8")
    work = fresh_dir("serve")
    run, bundle = os.path.join(work, "run"), os.path.join(work, "bundle")
    float_cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                      head_quant="none"))
    trainer = Trainer(float_cfg, device="cuda")
    state = trainer.init_state(0)
    seeded_normal_(trainer.model, 0)
    ckpt = Checkpointer(os.path.join(run, "ckpt"))
    ckpt.save(trainer, state)
    ckpt.wait()
    del trainer, state
    torch.cuda.empty_cache()
    with contextlib.redirect_stdout(io.StringIO()):
        export_serving.main(["--preset", "multipath_vgg16_int8",
                             "--checkpoint-dir", run, "--out", bundle,
                             "--quant", "int8", "--device", "cuda"])
    b, p, hw = cfg.train.batch_size, cfg.data.max_proposals, \
        cfg.data.image_size[0]
    images, _, boxes, _ = make_inputs(b, p, hw, seed=6)
    single = [json.dumps({"images": [images[i % b].tolist()],
                          "proposals": [boxes[i % b].tolist()]}).encode()
              for i in range(b)]
    batch8 = json.dumps({"images": images.tolist(),
                         "proposals": boxes.tolist()}).encode()

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "multipathnet_tpu_torch.cli.serve",
         "--bundle", bundle, "--port", "0", "--warmup"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stderr=subprocess.PIPE, text=True)
    errors = []
    try:
        for line in proc.stderr:
            errors.append(line.rstrip())
            if "listening on" in line:
                break
        require("listening on" in errors[-1] if errors else False,
                f"cli.serve did not start: {errors[-20:]}")
        threading.Thread(target=lambda: errors.extend(proc.stderr),
                         daemon=True).start()
        start_s = time.perf_counter() - t0
        url = "http://" + errors[-1].split("listening on ")[1].split()[0]
        status, health, _ = http_json(url + "/healthz")
        require(status == 200 and health["ok"]
                and health["head_quant"] == "int8", f"/healthz {health}")
        before = health["kernel_launches"]
        lat, dec, det = [], [], []
        replies = []
        for i in range(20):
            status, reply, ms = http_json(url + "/detect", single[i % b])
            require(status == 200, f"request {i}: {status} {reply}")
            lat.append(ms)
            dec.append(reply["decode_ms"])
            det.append(reply["batch_ms"])
            if i < b:
                replies.append(reply["detections"][0])
        big = []
        for _ in range(2):
            status, reply, ms = http_json(url + "/detect", batch8)
            require(status == 200 and len(reply["detections"]) == b,
                    f"8-image request: {status}")
            big.append((ms, reply["decode_ms"], reply["batch_ms"]))
        big_dets = reply["detections"]
        status, health, _ = http_json(url + "/healthz")
        launches = {k: v - before[k]
                    for k, v in health["kernel_launches"].items()}
        oversized = json.dumps({"images": [np.zeros(
            (hw + 8, hw, 3), np.uint8).tolist()], "proposals": [[[0, 0, 8, 8]]]
        }).encode()
        status, reply, _ = http_json(url + "/detect", oversized)
        require(status == 400 and "exceeds serving canvas" in reply["error"],
                f"an oversized image got {status} {reply}")
    finally:
        proc.kill()
        proc.wait(timeout=60)
    log(f"[serve] cli.serve --warmup up in {start_s:.1f} s; kernel "
        f"launches in the 22 requests: {launches}")
    require(launches["window_pool_multi_quant"] > 0
            and launches["resident_pool_quant"] > 0,
            f"the served requests never reached the int8 K1/K2: {launches}")

    # the same padded batches through a Detector on the bundle, here, with
    # the server process's default cuDNN settings
    detector = load_detector(bundle, device="cuda")

    def direct(lo, hi):
        n = hi - lo
        pad = np.zeros((b, hw, hw, 3), np.uint8)
        pad[:n] = images[lo:hi]
        hws = np.ones((b, 2), np.float32)
        hws[:n] = hw
        props = np.zeros((b, p, 4), np.float32)
        props[:n] = boxes[lo:hi]
        mask = np.zeros((b, p), bool)
        mask[:n] = True
        res = detector(pad, hws, props, mask)
        return [{"boxes": res["boxes"][j][res["valid"][j]].round(2).tolist(),
                 "scores": res["scores"][j][res["valid"][j]].round(
                     4).tolist(),
                 "classes": res["classes"][j][res["valid"][j]].astype(
                     int).tolist()} for j in range(n)]

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for i in range(b):
            require(direct(i, i + 1)[0] == replies[i],
                    f"HTTP detections of image {i} differ from a direct "
                    f"Detector")
        require(direct(0, b) == big_dets,
                "HTTP detections of the 8-image request differ from a "
                "direct Detector")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    del detector
    pct = {q: float(np.percentile(lat, q)) for q in (50, 90, 99)}
    res = {"p50": pct[50], "p90": pct[90], "p99": pct[99],
           "decode_ms": float(np.median(dec)), "batch_ms": float(np.median(
               det)), "big_ms": float(np.mean([x[0] for x in big])),
           "big_decode_ms": float(np.mean([x[1] for x in big])),
           "big_batch_ms": float(np.mean([x[2] for x in big]))}
    log(f"[serve] multipath_vgg16_int8 bundle over HTTP, 1 image of "
        f"{hw}^2 + {p} proposals a request (a {len(single[0]) / 1e6:.1f} MB "
        f"JSON body), 20 requests: latency p50 {pct[50]:.1f} ms, p90 "
        f"{pct[90]:.1f}, p99 {pct[99]:.1f} (client send to parsed reply); "
        f"of it, the server's request read and JSON decode "
        f"{res['decode_ms']:.1f} ms and detection {res['batch_ms']:.1f} ms "
        f"(medians); 8-image requests ({len(batch8) / 1e6:.1f} MB) "
        f"{res['big_ms']:.1f} ms, decode {res['big_decode_ms']:.1f}, "
        f"detection {res['big_batch_ms']:.1f}; the detections equal a "
        f"Detector called directly; /healthz answered, an oversized image "
        f"got 400")
    return launches, res


# ------------------------------------------------------------ phase 19 ---

def tiny_parallel_batch():
    """`tiny` in float32 (batch 4, warmup off) and the first batch of a
    synthetic split of 8 images of 64^2 (tests/test_sharding.py's data)."""
    cfg = preset("tiny")
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, dtype="float32"),
        train=dataclasses.replace(cfg.train, batch_size=4, warmup_steps=0))
    fx = synthetic.generate(fresh_dir("parallel_tiny"), num_images=8,
                            image_size=64, num_classes=4,
                            proposals_per_image=16, seed=31)
    loader = CocoLoader(fx["annotations"], fx["images"])
    return cfg, next(DetectionPipeline(
        loader, ProposalStore.load(fx["proposals"]), cfg.data,
        batch_size=4, seed=0).epoch(0))


def differ_dets(got: list, want: list):
    """-> (the share of detections, by position, that differ at all; the
    largest difference between the two sides' sorted scores of an image,
    inf where an image's detections differ in number)."""
    share = 1.0 - sum(a == b for a, b in zip(got, want)) / max(
        len(got), len(want), 1)

    def scores(dets):
        by_image = {}
        for d in dets:
            by_image.setdefault(d["image_id"], []).append(d["score"])
        return {k: np.sort(v) for k, v in by_image.items()}

    a, b = scores(got), scores(want)
    if a.keys() != b.keys() or any(len(a[k]) != len(b[k]) for k in a):
        return share, float("inf")
    return share, max((float(np.abs(a[k] - b[k]).max()) for k in a),
                      default=0.0)


def parallel_path(phase13, resident_ms):
    """Phase 19: the mesh paths through core/mesh.spawn, each rank's
    kernel launches summed. Returns the launches."""
    t_phase = time.perf_counter()
    work = fresh_dir("parallel")
    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= 2 else "gloo"
    # phase 7's weights and batch; without the warmup, whose first step's
    # learning rate is 0, so that the step moves the parameters
    cfg = preset("multipath_vgg16_train")
    batch = train_batch(cfg)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, warmup_steps=0))
    bcfg = preset("multipath_vgg16_batched")
    inputs = make_inputs(8, bcfg.data.max_proposals, 640)
    # phase 13's split and Tester config
    t_split = split_paths()
    ecfg = bcfg.replace(eval=dataclasses.replace(bcfg.eval,
                                                 score_threshold=0.0))
    launches = {name: 0 for name in KERNELS}

    def count(results):
        for r in results:
            for name, n in r["launches"].items():
                if name in launches:
                    launches[name] += n

    # (a) one NCCL rank: the plain Trainer's step and Detector's batch
    a_file = os.path.join(work, "a_params.pt")
    jobs = [(mesh_runs.train_run, (cfg, (1, 1), batch),
             dict(device="cuda", normal_std=0.02, compare_plain=True,
                  deterministic=True, return_params=False,
                  dump_file=a_file)),
            (mesh_runs.detect_run, (bcfg, (1, 1), inputs),
             dict(device="cuda", normal_seed=0, compare_unsharded=True)),
            (mesh_runs.tester_run, (ecfg, (1, 1), t_split),
             dict(device="cuda", normal_seed=0, batch_size=4,
                  collect=True))]
    t0 = time.perf_counter()
    (a_train, a_det, a_test), = spawn(mesh_runs.run_jobs, 1, args=(jobs,),
                              backend="nccl", device="cuda", timeout_s=600,
                              workdir=work)
    count([a_train, a_det])
    a_loss = a_train["metrics"][0]["loss"]
    log(f"[parallel] (a) one NCCL rank, mesh (1, 1), "
        f"{time.perf_counter() - t0:.1f} s with its start: "
        f"multipath_vgg16_train step (batch 8, 640^2, cudnn.deterministic) "
        f"loss {a_loss:.6f}, against the plain Trainer "
        f"{a_train['plain_equal']}"
        f"; launches {a_train['launches']}")
    require(all(a_train["plain_equal"].values()),
            f"the 1 x 1 mesh's step differs from the plain Trainer's: "
            f"{a_train['plain_equal']}")
    for k, v in a_det["unsharded"]["detections"].items():
        require(np.array_equal(a_det["detections"][k], v),
                f"the 1 x 1 mesh's Detector differs from phase 4's in {k}")
    log(f"[parallel] (a) Detector on multipath_vgg16_batched (8 x 1000, "
        f"phase 4's weights and batch): equal to the plain Detector bit for "
        f"bit; launches {a_det['launches']}")
    count([a_test])

    # (b)-(e) two ranks
    tcfg, tbatch = tiny_parallel_batch()
    qcfg = preset("multipath_vgg16_int8")
    ckpt = os.path.join(work, "tp_ckpt")
    jobs = [(mesh_runs.train_run, (cfg, (2, 1), batch),
             dict(device="cuda", normal_std=0.02, timed=5, repeat=True,
                  deterministic=True, return_params=False,
                  diff_file=a_file)),
            (mesh_runs.train_run, (tcfg, (2, 1), tbatch),
             dict(device="cuda", deterministic=True, return_params=False)),
            (mesh_runs.tester_run, (ecfg, (2, 1), t_split),
             dict(device="cuda", normal_seed=0, batch_size=8,
                  collect=True)),
            (mesh_runs.detect_run, (qcfg, (1, 2), inputs),
             dict(device="cuda", normal_seed=0, compare_unsharded=True,
                  timed=5)),
            (mesh_runs.detect_run, (bcfg, (1, 2), inputs),
             dict(device="cuda", normal_seed=0, compare_unsharded=True,
                  timed=5)),
            (mesh_runs.train_run, (tcfg, (1, 2), tbatch),
             dict(device="cuda", save_dir=ckpt, timed=5)),
            (mesh_runs.train_run, (tcfg, (2, 1), tbatch),
             dict(device="cuda", return_params=False, timed=5))]
    t0 = time.perf_counter()
    ranks = spawn(mesh_runs.run_jobs, 2, args=(jobs,), backend=backend,
                  device="cuda", timeout_s=900, workdir=work)
    b_full, b_tiny, c_test, d_int8, d_bf16, e_tp, e_dp = zip(*ranks)
    shared = backend == "gloo"
    how = ("they share the one card; gloo stages each collective through "
           "the host" if shared else "one card each")
    log(f"[parallel] (b)-(e): 2 ranks, {backend} ({how}), "
        f"{time.perf_counter() - t0:.1f} s with their start")

    # (b) data parallelism at full width
    for r in b_full:
        count([r])
        log(f"[parallel] (b) rank {r['coord']}: multipath_vgg16_train, 4 "
            f"images of the batch: first step {r['first_s']:.2f} s, "
            f"{r['ms_per_step']:.2f} ms/step over 5 steps (cudnn."
            f"deterministic), peak memory {r['peak_gib']:.2f} GiB; "
            f"launches {r['launches']}")
        n = r["launches"]
        require(n["window_pool_multi"] > 0 and n["window_grad"] > 0
                and n["window_rmw_grad"] > 0,
                f"a train kernel never launched on rank {r['coord']}: {n}")
        require(n["resident_pool"] == 0 and n["placements"] == 0,
                f"K2 or a placement GEMM launched in training: {n}")
        require(r["repeat_equal"], "two DP steps from one state differ")
    b_loss = b_full[0]["metrics"][0]["loss"]
    require(all(r["metrics"] == b_full[0]["metrics"] for r in b_full),
            "the ranks' metrics differ")
    rel = abs(b_loss - a_loss) / abs(a_loss)
    log(f"[parallel] (b) loss {b_loss:.6f} against (a)'s {a_loss:.6f}: rel "
        f"{rel:.2e} (bf16); largest parameter difference after the step "
        f"{b_full[0]['max_param_diff']:.3e}; two steps from one state equal "
        f"bit for bit; {b_full[0]['ms_per_step']:.2f} ms/step for 8 images "
        f"against phase 7's {resident_ms:.2f} on one rank"
        f"{': not a speed-up, both ranks share one card' if shared else ''}")
    require(rel < 1e-2, f"DP loss {b_loss} vs one rank's {a_loss}")
    torch.backends.cudnn.deterministic = True
    try:
        plain = Trainer(tcfg, device="cuda")
        _, m = plain.step(plain.init_state(0), tbatch)
    finally:
        torch.backends.cudnn.deterministic = False
    t_loss = b_tiny[0]["metrics"][0]["loss"]
    rel = abs(t_loss - float(m["loss"])) / abs(float(m["loss"]))
    log(f"[parallel] (b) tiny float32, cudnn.deterministic: (2, 1) loss "
        f"{t_loss:.8f}, one rank {float(m['loss']):.8f}, rel {rel:.2e}")
    require(rel <= 1e-5, "tiny DP loss off one rank's by more than 1e-5")
    count(b_tiny)

    # (c) the Tester on phase 13's split. Its APs are 0 for random weights,
    # so the detections carry the check: each rank detects 4 images of a
    # batch of 8, as a one-rank Tester at batch 4 detects each group of 4,
    # so the two must be equal bit for bit (a row gathered into another
    # image's place, or a rank's images dropped, is not); beside phase 13
    # (batch 8: cuDNN and cuBLAS at other shapes) the image ids and counts
    # must match and each image's sorted scores differ in their last bits
    metrics13, dets13 = phase13
    got = c_test[0]["metrics"]
    diff = max(abs(got[k] - metrics13[k]) for k in ("AP", "AP50", "AP75"))
    share, gap = differ_dets(c_test[0]["detections"], dets13)
    same4 = c_test[0]["detections"] == a_test["detections"]
    log(f"[parallel] (c) Tester at (2, 1) on phase 13's split: AP "
        f"{got['AP']:.6f} AP50 {got['AP50']:.6f} AP75 {got['AP75']:.6f}, "
        f"largest difference from phase 13 {diff:.2e}; its "
        f"{len(c_test[0]['detections'])} detections against one rank's "
        f"Tester at batch 4: {'equal bit for bit' if same4 else 'DIFFERENT'}"
        f"; against phase 13's {len(dets13)} (batch 8): "
        f"{100 * share:.2f}% differ at all, each image's sorted scores "
        f"within {gap:.2e}; images decoded per rank "
        f"{[r['decoded'] for r in c_test]}; Tester.test "
        f"{c_test[0]['seconds']:.2f} s; launches "
        f"{[r['launches'] for r in c_test]}")
    require(diff <= 1e-6, f"DP Tester AP off phase 13's by {diff}")
    require(all(r["metrics"] == got for r in c_test),
            "the ranks' metrics differ")
    require(len(a_test["detections"]) > 0 and same4,
            "the DP Tester's detections differ from one rank's at batch 4")
    require(gap <= 5e-3, f"the DP Tester's images or scores differ from "
            f"phase 13's: sorted-score gap {gap}")
    for r in c_test:
        require(r["launches"]["window_pool_multi"] > 0
                and r["launches"]["resident_pool"] > 0,
                f"K1 or K2 never launched in the DP Tester: {r['launches']}")
    count(c_test)

    # (d) tensor-parallel serving
    for r in d_int8:
        for k in ("boxes", "probs"):
            require(np.array_equal(r["scores"][k],
                                   r["unsharded"]["scores"][k]),
                    f"TP int8 {k} differ from the unsharded head")
        for k, v in r["unsharded"]["detections"].items():
            require(np.array_equal(r["detections"][k], v),
                    f"TP int8 detections differ in {k}")
        n = r["launches"]
        require(n["window_pool_multi_quant"] > 0
                and n["resident_pool_quant"] > 0,
                f"a quant kernel never launched in TP serving: {n}")
        shape = r["head_state_shapes"]["fc6_f0.weight_i8"]
        require(shape[0] == 2048, f"fc6's local kernel_i8 {shape}")
    log(f"[parallel] (d) multipath_vgg16_int8 at (1, 2), 8 x 1000, 640^2: "
        f"scores, boxes and detections equal to the unsharded int8 head bit "
        f"for bit on both ranks; fc6's local kernel_i8 "
        f"{d_int8[0]['head_state_shapes']['fc6_f0.weight_i8']} (of 4096 "
        f"columns); {d_int8[0]['ms_per_batch']:.2f} ms/batch over 5 "
        f"batches{' (both ranks on one card)' if shared else ''}; peak "
        f"{[round(r['peak_gib'], 2) for r in d_int8]} GiB; "
        f"launches {d_int8[0]['launches']}")
    for r in d_bf16:
        got, want = r["scores"]["probs"], r["unsharded"]["scores"]["probs"]
        err = float(np.abs(got - want).max())
        require(err <= 1e-2, f"TP bf16 probabilities off by {err}")
    log(f"[parallel] (d) multipath_vgg16_batched (bf16) at (1, 2): "
        f"probabilities within {err:.2e} of the unsharded head, "
        f"{100 * float(np.mean(got != want)):.2f}% differ at all; "
        f"{d_bf16[0]['ms_per_batch']:.2f} ms/batch over 5 batches (the "
        f"row-parallel fc7 in float32 with TF32); launches "
        f"{d_bf16[0]['launches']}")
    count(d_int8 + d_bf16)

    # (e) tensor-parallel training and its checkpoint
    tp_loss = e_tp[0]["metrics"][0]["loss"]
    dp_loss = e_dp[0]["metrics"][0]["loss"]
    rel = abs(tp_loss - dp_loss) / abs(dp_loss)
    trainer = Trainer(tcfg, device="cuda")
    state = Checkpointer(ckpt).restore_latest(trainer, trainer.init_state())
    equal = all(np.array_equal(t.cpu().numpy(), e_tp[0]["params"][n])
                for n, t in trainer.model.state_dict().items())
    state, m = trainer.step(state, tbatch)
    log(f"[parallel] (e) tiny float32: (1, 2) loss {tp_loss:.8f}, (2, 1) "
        f"{dp_loss:.8f}, rel {rel:.2e}; {e_tp[0]['ms_per_step']:.2f} "
        f"ms/step at (1, 2), {e_dp[0]['ms_per_step']:.2f} at (2, 1), over "
        f"5 steps; roles {e_tp[0]['tp_roles']}; its "
        f"checkpoint restored on one device "
        f"{'equal bit for bit' if equal else 'DIFFERENT'}, a step after it: "
        f"loss {float(m['loss']):.6f}")
    require(rel <= 1e-4, "TP loss off DP's by more than 1e-4")
    require(equal, "the TP checkpoint restores other parameters")
    require(np.isfinite(float(m["loss"])), "no step after the restore")
    count(e_tp + e_dp)
    log(f"[parallel] kernel launches of the phase's mesh runs, all ranks: "
        f"{launches}; the phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


def split_paths():
    """(annotations file, image directory, proposals file) of phase 13's
    split, as disk_split writes it."""
    root = os.path.join(BUILD, "chip_smoke", "split")
    return (os.path.join(root, "annotations", "instances_synthetic.json"),
            os.path.join(root, "synthetic"),
            os.path.join(root, "proposals_synthetic.npz"))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this check needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    lib_path, seconds, nvcc_out = _build.build(verbose=True)
    _build.kernels()
    log(f"[build] {lib_path.name} built in {seconds:.1f} s")
    for line in nvcc_out.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build]   {line.strip()}")
    log_pool_instances()

    gen = torch.Generator(device="cuda").manual_seed(0)
    stats = check_and_time_kernels(gen)
    torch.cuda.empty_cache()
    eval_launches, bf16_ips, nms_ips = main_path()
    torch.cuda.empty_cache()
    grad_stats, k1_train = check_and_time_grad_kernels(gen)
    stats.update(grad_stats)
    torch.cuda.empty_cache()
    train_launches, resident_ms, resident_ips = train_path()
    torch.cuda.empty_cache()
    stats.update(check_and_time_quant_kernels(gen))
    torch.cuda.empty_cache()
    int8_launches, int8_ips = serving_path("multipath_vgg16_int8", "int8")
    torch.cuda.empty_cache()
    svd_launches, svd_ips = serving_path("multipath_vgg16_int8_svd",
                                         "int8_svd")
    log(f"[serving] steady img/s at 8 x 1000 proposals, 640^2, this process "
        f"and card: bf16 {bf16_ips:.2f} (phase 4), int8 {int8_ips:.2f}, "
        f"int8+SVD {svd_ips:.2f}")
    torch.cuda.empty_cache()
    stats["window_pool"], pool_api_launches = pool_api_path(gen)
    torch.cuda.empty_cache()
    stats["window_read_probe"], probe_launches = probe_path()
    torch.cuda.empty_cache()
    split = disk_split()
    dataset_eval_launches, split_ips, *phase13 = dataset_eval_path(*split)
    torch.cuda.empty_cache()
    train_eval_launches = train_eval_path(*split, resident_ms, resident_ips)
    log(f"[dataset_eval] split img/s from disk {split_ips:.2f}; one "
        f"resident batch repeated, this process and card: {nms_ips:.2f} "
        f"with score_threshold 0 (phase 5), {bf16_ips:.2f} with 0.05 "
        f"(phase 4)")
    torch.cuda.empty_cache()
    resnet_launches = resnet_path()
    torch.cuda.empty_cache()
    reference_launches, _ = reference_exact_path()
    torch.cuda.empty_cache()
    sharpmask_launches, sm_e2e, sm_train = sharpmask_path()
    torch.cuda.empty_cache()
    serve_launches, serve = serve_path()
    torch.cuda.empty_cache()
    parallel_launches = parallel_path(phase13, resident_ms)
    log(f"[summary] config 5 end to end {sm_e2e['ips']:.2f} img/s "
        f"({sm_e2e['e2e_ms']:.2f} ms/batch: generation with masks "
        f"{sm_e2e['gen_ms']:.2f}, without {sm_e2e['gen_nomask_ms']:.2f}, "
        f"detection {sm_e2e['det_ms']:.2f}), {sm_e2e['device_ms']:.2f} device "
        f"ms, {100 * sm_e2e['busy']:.1f}% busy, peak {sm_e2e['peak_gib']:.2f} "
        f"GiB; proposal train {sm_train['ms']:.2f} ms/step, "
        f"{sm_train['device_ms']:.2f} device ms, {100 * sm_train['busy']:.1f}"
        f"% busy, peak {sm_train['peak_gib']:.2f} GiB; serve p50/p90/p99 "
        f"{serve['p50']:.1f}/{serve['p90']:.1f}/{serve['p99']:.1f} ms")

    # launches: each path's run, counted from 0, and their sum; K1's
    # train_max_abs_err*: its forward at the train path's groups; the quant
    # kernels' max_abs_err*: the largest code difference from the plain
    # version (their epilogue is bit-equal on their own pooled output);
    # P's max_abs_err: its bf16 windows' (its output is bf16 either way)
    paths = {"eval": eval_launches, "train": train_launches,
             "int8": int8_launches, "int8_svd": svd_launches,
             "pool_api": pool_api_launches, "probe": probe_launches,
             "dataset_eval": dataset_eval_launches,
             "train_eval": train_eval_launches,
             "resnet": resnet_launches,
             "reference_exact": reference_launches,
             "sharpmask": sharpmask_launches,
             "serve": {name: serve_launches.get(name, 0) for name in KERNELS},
             "parallel": parallel_launches}
    extra = {"window_pool_multi": {
        "train_max_abs_err": k1_train["float32"],
        "train_max_abs_err_bf16": k1_train["bfloat16"]}}
    kernels = [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": sum(counts[name] for counts in paths.values()),
        **{f"{path}_launches": counts[name]
           for path, counts in paths.items()},
        **({"max_abs_err": stats[name]["float32"],
            "max_abs_err_bf16": stats[name]["bfloat16"]}
           if "float32" in stats[name]
           else {"max_abs_err": stats[name]["max_abs_err"]}),
        "ms": round(stats[name]["ms"], 4),
        "plain_ms": round(stats[name]["plain_ms"], 4),
        "bound_ms": round(stats[name]["bound_ms"], 4),
        "bound_by": stats[name]["bound_by"],
        "library_ms": None,   # no single PyTorch call computes the function
        **extra.get(name, {}), **stats[name].get("extra", {}),
    } for name, (source, replaces, _, _) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
