"""Serving cells: a closed loop of one caller on `eval.detect.Detector`.

Set-up draws the configuration's float checkpoint on the card from the
seed and hands it to `Detector`, which transforms it at load as it does
for users (SVD factors checked, int8 quantization); draws the mix's pool
of host batches; builds the kernels through the program's cache under
build/ on the first call; and warms up on the pool's first batches. The
window then calls the detector batch after batch, cycling the pool, each
call timed on the host clock from the call until its numpy detections
are back. A traced run adds a profiled slice after the window.

Correctness: for a sample of the pool's batches drawn from the seed, the
last detections served in the window, and the scores and boxes that
entered NMS in that call, are kept. Once the window has closed and the
program is freed, the reference (benchmark/reference/multipath.py)
recomputes scores and boxes from the raw batch and the checkpoint drawn
again from the seed. Three numbers are compared with their limits in the
configuration's `limits`:
  prob_err     the widest gap |log p - log p_ref| over every proposal and
               foreground class, p the averaged integral softmax;
  box_err      the widest gap of a decoded, clipped box coordinate, over
               the larger side of the reference box;
  nms_mismatch the detections served that differ from the reference's
               NMS (benchmark/reference/nms.py) run on the scores and boxes
               the program fed its own NMS, plus the difference in count:
               the reference follows the program there, its start being
               held by the two numbers above.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark import harness, peaks, traffic, weights
from benchmark.counts import multipath as counts
from benchmark.entries import replace_fields
from benchmark.reference import multipath as ref
from benchmark.reference import nms as ref_nms
from benchmark.trace import Spans, profile, reduce_trace

WARMUP = 3          # calls before the window
SLICE = 12          # batches in the profiled slice


def program_config(config: dict, mix: dict):
    """The program's Config for the configuration file and the mix."""
    from multipathnet_tpu_torch.core.config import preset

    cfg = preset(config["preset"])

    cfg = cfg.replace(model=replace_fields(cfg.model, config["model"]),
                      eval=replace_fields(cfg.eval, config["eval"]))
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data,
                                 image_size=(mix["canvas"], mix["canvas"]),
                                 max_proposals=mix["proposals"]),
        eval=dataclasses.replace(cfg.eval,
                                 score_threshold=mix["score_threshold"]))
    return cfg


def checkpoint_shapes(cfg) -> dict:
    """{name: shape} of the float model's state dict (its serving layout,
    factors included), built on the meta device."""
    from multipathnet_tpu_torch.models.multipath import MultiPathNet

    m = dataclasses.replace(cfg.model, head_quant="none")
    net = MultiPathNet(m, device="meta", param_dtype=torch.float32)
    return {k: tuple(v.shape) for k, v in net.state_dict().items()}


def build_detector(cfg, config: dict, seed: int, device):
    """The program's Detector, loaded from the checkpoint drawn from the
    seed, as a user loads a float checkpoint."""
    from multipathnet_tpu_torch.eval.detect import Detector
    from multipathnet_tpu_torch.models import convert
    from multipathnet_tpu_torch.models.multipath import build_model

    sd = weights.draw(checkpoint_shapes(cfg), config["weights"], seed,
                      device)
    tree = convert.flax_from_state_dict(sd, host=False)
    det = Detector(build_model(cfg.model, device=device), cfg, device=device,
                   params=tree)
    return det


class Server:
    """The detector with its spans; keeps what the check reads."""

    def __init__(self, det, keep: set):
        from multipathnet_tpu_torch.ops import nms as nms_mod

        self.det = det
        self.keep = keep
        self.current = -1
        self.failed = 0       # batches with a non-finite detection
        self.fed = {}         # batch -> (boxes, probs, valid) fed to NMS
        self.served = {}      # batch -> numpy detections
        self.spans = Spans()
        model = det.model
        for attr in ("features", "pool_rois", "predict_rois"):
            self.spans.wrap(model, attr, attr)
        self.spans.wrap(nms_mod, "multiclass_nms", "multiclass_nms",
                        hook=self._fed)

    def _fed(self, args, kwargs, out):
        if self.current in self.keep:
            self.fed[self.current] = args[:3]
        return out

    def __call__(self, i: int, batch):
        self.current = i
        out = self.det(*batch)
        v = out["valid"]
        if not (np.isfinite(out["scores"][v]).all()
                and np.isfinite(out["boxes"][v]).all()):
            self.failed += 1
        if i in self.keep:
            self.served[i] = out
        return out

    def close(self):
        self.spans.unwrap()


def window(server: Server, pool: list, seconds: float, first: int):
    """Calls the detector for `seconds`, cycling the pool from batch
    `first` -> (latencies in s, window s, batches, next batch)."""
    lat = []
    i = first
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        k = i % len(pool)
        t = time.perf_counter()
        server(k, pool[k])
        t_end = time.perf_counter()
        lat.append(t_end - t)
        i += 1
        if t_end >= deadline:
            break
    return lat, t_end - t_start, i - first, i


def nms_mismatch(fed, served, cfg) -> int:
    """Detections of `served` (numpy, classes 1-based) that differ from
    the reference NMS on `fed`, plus the difference in their counts."""
    boxes, probs, valid = fed
    e = cfg.eval
    want = ref_nms.multiclass_nms(
        boxes, probs, valid, score_threshold=e.score_threshold,
        iou_threshold=e.nms_iou_threshold, pre_nms=e.pre_nms_per_class,
        max_det=e.max_detections)
    bad = 0
    for img, dets in enumerate(want):
        v = served["valid"][img]
        got = list(zip(served["scores"][img][v].tolist(),
                       (served["classes"][img][v] - 1).tolist(),
                       served["indices"][img][v].tolist(),
                       served["boxes"][img][v].tolist()))
        bad += abs(len(got) - len(dets))
        bad += sum(1 for a, b in zip(got, dets) if a != b)
    return bad


def gaps(probs, boxes, probs_ref, boxes_ref) -> tuple:
    """(prob_err, box_err) of foreground scores and boxes (B, P, C[, 4])
    against the reference's."""
    lp = torch.log(torch.clamp(probs.float(), min=1e-30))
    lr = torch.log(torch.clamp(probs_ref.float(), min=1e-30))
    side = torch.maximum(boxes_ref[..., 2] - boxes_ref[..., 0],
                         boxes_ref[..., 3] - boxes_ref[..., 1])
    side = torch.clamp(side, min=1.0)[..., None]
    return (float((lp - lr).abs().max()),
            float(((boxes.float() - boxes_ref).abs() / side).max()))


def reference_readings(sd, config, mix, batch, device, prec=ref.Precision()):
    """The reference's (foreground probs, boxes) of one host batch."""
    images, hws, props = (torch.as_tensor(x, device=device)
                          for x in batch[:3])
    probs, boxes = ref.detect_scores(sd, config["model"], mix["canvas"],
                                     images, hws, props, prec)
    return probs[:, :, 1:], boxes[:, :, 1:]


def check(fed: dict, served: dict, keep: set, cfg, config, mix, pool, seed,
          device) -> dict:
    """The numbers compared over the kept batches, from what the program
    fed its NMS (`fed`) and served (`served`): {name: value}."""
    sd = weights.draw(checkpoint_shapes(cfg), config["weights"], seed,
                      device)
    prob_err = box_err = 0.0
    mismatch = 0
    for i in sorted(keep):
        if i not in fed or i not in served:
            mismatch += 1   # kept but never served in the window
            continue
        boxes, probs, _ = fed[i]
        pr, br = reference_readings(sd, config, mix, pool[i], device)
        pe, be = gaps(probs, boxes, pr, br)
        prob_err, box_err = max(prob_err, pe), max(box_err, be)
        mismatch += nms_mismatch(fed[i], served[i], cfg)
    return {"prob_err": prob_err, "box_err": box_err,
            "nms_mismatch": float(mismatch)}


def kept_batches(mix: dict, seed: int) -> set:
    rng = np.random.default_rng([weights.seed64(seed), 1])
    return set(rng.choice(mix["pool"], mix["check_batches"],
                          replace=False).tolist())


def layer_data(config, mix, pool, nms_ms, traced, per_batch_s,
               device) -> dict:
    """What the per-layer readers read: per batch, the device seconds of
    each span, the counted work, the untraced window's time, NMS's host
    time."""
    model = config["model"]
    rois = [torch.as_tensor(b[2], device=device) for b in pool]
    pool_work = [counts.pool(model, mix["canvas"], r) for r in rois]
    work = {"trunk": counts.trunk(model, mix["canvas"], mix["batch"]),
            "head": counts.head(model, mix["batch"] * mix["proposals"]),
            "pool": {k: sum(w[k] for w in pool_work) / len(pool_work)
                     for k in ("ops", "bytes")}}
    for name, dtype in (("trunk", "bf16"), ("pool", "bf16"),
                        ("head", "int8" if model["head_quant"] == "int8"
                         else "bf16")):
        harness.log(f"{name}: {work[name]['ops']:.6g} ops, "
                    f"{work[name]['bytes']:.6g} bytes a batch; "
                    f"{peaks.binds(work[name], dtype)} bind")
    return {"kind": "serve", "batches": SLICE,
            "head_int8": model["head_quant"] == "int8",
            "span_device_s": {k: v / SLICE for k, v in
                              traced["span_device_s"].items()},
            "busy_s": traced["busy_s"], "window_s": traced["window_s"],
            "batch_s": per_batch_s, "work": work,
            "nms_ms": nms_ms}


def run(run: harness.Run) -> harness.Outcome:
    dev = run.device
    cfg = program_config(run.config, run.mix)

    def stage(what):
        t = time.perf_counter() - run.start
        harness.log(f"set-up: {what} at {t:.3f} s")

    stage("imports done")
    det = build_detector(cfg, run.config, run.seed, dev)
    stage("detector loaded")
    pool = traffic.batches(run.mix, weights.seed64(run.seed))
    stage("traffic drawn")
    server = Server(det, kept_batches(run.mix, run.seed))
    for i in range(WARMUP):
        server(i % len(pool), pool[i % len(pool)])
        stage(f"warm-up call {i} done")
    server.spans.reset()
    setup_s = time.perf_counter() - run.start
    harness.log(f"set-up {setup_s:.3f} s")
    lat, win_s, n, nxt = window(server, pool, run.seconds, WARMUP)
    nms_ms = 1e3 * server.spans.host["multiclass_nms"] / max(
        server.spans.calls["multiclass_nms"], 1)
    lat_ms = np.array(lat) * 1e3
    harness.log(f"window {win_s:.3f} s, {n} batches; batch ms median "
                f"{np.median(lat_ms):.4f} p95 {np.percentile(lat_ms, 95):.4f}"
                f" over {len(lat_ms)} samples")
    traced = None
    if run.trace:
        def step():
            nonlocal nxt
            k = nxt % len(pool)
            server(k, pool[k])
            nxt += 1
        server.spans.profiling = True
        traced = reduce_trace(profile(step, SLICE, dev))
        server.spans.profiling = False
        for name in ("features", "pool_rois", "predict_rois",
                     "multiclass_nms"):
            if server.spans.calls[name] == 0:
                raise RuntimeError(f"span {name} never ran")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    server.close()
    fed, served, keep = server.fed, server.served, server.keep
    failed = server.failed
    del det, server
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    layer = None
    if traced is not None:
        layer = layer_data(run.config, run.mix, pool, nms_ms, traced,
                           win_s / n, dev)
    t = time.perf_counter()
    got = check(fed, served, keep, cfg, run.config, run.mix, pool, run.seed,
                dev)
    harness.log(f"check {time.perf_counter() - t:.3f} s")
    limits = run.config["limits"]
    return harness.Outcome(
        attempted=n, failed=failed,
        end_to_end={"img_per_s": n * run.mix["batch"] / win_s,
                    "batch_p95_ms": float(np.percentile(lat_ms, 95)),
                    "setup_s": setup_s},
        checks=[harness.Check(k, got[k], limits[k]) for k in
                ("prob_err", "box_err", "nms_mismatch")],
        memory_peak_bytes=peak, layer=layer,
        busy_s=None if traced is None else traced["busy_s"],
        window_s=None if traced is None else traced["window_s"],
        breakdown=None if traced is None else traced["breakdown"])
