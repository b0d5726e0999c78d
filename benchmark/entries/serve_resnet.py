"""Serving cells on a ResNet trunk: the closed loop of one caller on
`eval.detect.Detector` and the check of benchmark/entries/serve.py, with
what a ResNet trunk needs in place of VGG-16's:

- the weights: benchmark/weights_resnet.py's draw (He-normal
  convolutions, BatchNorm statistics with positive variances), handed
  to `Detector` as a float checkpoint that it transforms at load (SVD
  factors checked, int8 quantization), as serve.py does;
- the reference: benchmark/reference/multipath_resnet.py (the trunk
  written out; pool, head and decode those of the VGG-16 reference);
- the trunk's work: benchmark/counts/resnet.py.

Set-up also logs the standard deviation of each tap (c3, c4, c5) as the
program computed it on the first warm-up batch, and fails unless every
tap is finite with its deviation inside the configuration's `tap_std`:
under a draw that made the trunk vanish or blow up, the comparison with
the reference would say nothing.

The check is serve.py's: prob_err, box_err and nms_mismatch over the
mix's kept batches, against the configuration's `limits`, and one more
number, which holds the trunk on its own:
  tap_err  the widest gap of a reduced map (c3, c4, c5, the trunk and its
           1x1 reductions) over the reference map's largest magnitude,
           the served model fed the reference's canvases of each kept
           batch once the window has closed.
The scores barely see the trunk's rounding at the cell's random head
(an fp8 trunk with the int8 head stays inside prob_err's and box_err's
limits; PERF.md), so the taps carry the trunk's check. `run`, `check` and
`layer_data` repeat serve.py's with the parts above swapped in, since
serve.py's call its draw, reference and count by name.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import harness, peaks, traffic, weights, weights_resnet
from benchmark.counts import multipath as counts
from benchmark.counts import resnet as resnet_counts
from benchmark.entries import serve
from benchmark.reference import multipath_resnet as ref
from benchmark.trace import profile, reduce_trace


def checkpoint(cfg, config: dict, seed: int, device) -> dict:
    return weights_resnet.draw(serve.checkpoint_shapes(cfg),
                               config["weights"], seed, device)


def build_detector(cfg, config: dict, seed: int, device):
    """The program's Detector, loaded from the checkpoint drawn from the
    seed, as a user loads a float checkpoint."""
    from multipathnet_tpu_torch.eval.detect import Detector
    from multipathnet_tpu_torch.models import convert
    from multipathnet_tpu_torch.models.multipath import build_model

    tree = convert.flax_from_state_dict(checkpoint(cfg, config, seed, device),
                                        host=False)
    return Detector(build_model(cfg.model, device=device), cfg,
                    device=device, params=tree)


def tap_stds(server: serve.Server, k: int, batch, band) -> dict:
    """Serves batch k once while a hook reads the trunk's taps: ->
    {tap: std}; raises unless each is finite and inside band."""
    got = {}

    def hook(module, args, out):
        for lv, x in out.items():
            x = x.float()
            got[lv] = (float(x.std()), bool(torch.isfinite(x).all()))

    handle = server.det.model.backbone.register_forward_hook(hook)
    try:
        server(k, batch)
    finally:
        handle.remove()
    lo, hi = band
    for lv, (std, finite) in sorted(got.items()):
        harness.log(f"tap {lv}: std {std:.6g}, finite {finite}")
        if not (finite and lo <= std <= hi):
            raise RuntimeError(f"tap {lv} of the drawn trunk is not finite "
                               f"with std in [{lo}, {hi}]: std {std!r}")
    return {lv: std for lv, (std, _) in got.items()}


def program_taps(det, keep: set, pool, canvas: int, device) -> dict:
    """{batch: (canvases, {level: reduced map})}: the served model's maps
    of each kept batch, fed the reference's canvases of the raw batch."""
    out = {}
    for i in sorted(keep):
        images, hws = (torch.as_tensor(x, device=device)
                       for x in pool[i][:2])
        x, _ = ref.base.canvases(images, hws, canvas)
        with torch.inference_mode():
            out[i] = (x, det.model.features(x))
    return out


def tap_gap(sd, config, x, taps, prec=ref.base.Precision()) -> float:
    """The widest gap of a map of `taps` over the largest magnitude of the
    reference's (computed with `prec` from the canvases x)."""
    ref.base.exact_float32()
    model = config["model"]
    want = ref.trunk(sd, model["backbone"], x, model["skip_levels"], prec)
    return max(float((taps[lv].float() - w).abs().max() / w.abs().max())
               for lv, w in want.items())


def check(fed: dict, served: dict, keep: set, taps: dict, cfg, config, mix,
          pool, seed, device) -> dict:
    """serve.check with this module's checkpoint and reference, and the
    taps' gap."""
    sd = checkpoint(cfg, config, seed, device)
    prob_err = box_err = tap_err = 0.0
    mismatch = 0
    for i in sorted(keep):
        x, maps = taps[i]
        tap_err = max(tap_err, tap_gap(sd, config, x, maps))
        if i not in fed or i not in served:
            mismatch += 1   # kept but never served in the window
            continue
        boxes, probs, _ = fed[i]
        pr, br = reference_readings(sd, config, mix, pool[i], device)
        pe, be = serve.gaps(probs, boxes, pr, br)
        prob_err, box_err = max(prob_err, pe), max(box_err, be)
        mismatch += serve.nms_mismatch(fed[i], served[i], cfg)
    return {"prob_err": prob_err, "box_err": box_err,
            "nms_mismatch": float(mismatch), "tap_err": tap_err}


def reference_readings(sd, config, mix, batch, device,
                       prec=ref.base.Precision()):
    """The reference's (foreground probs, boxes) of one host batch."""
    images, hws, props = (torch.as_tensor(x, device=device)
                          for x in batch[:3])
    probs, boxes = ref.detect_scores(sd, config["model"], mix["canvas"],
                                     images, hws, props, prec)
    return probs[:, :, 1:], boxes[:, :, 1:]


def layer_data(config, mix, pool, nms_ms, traced, per_batch_s,
               device) -> dict:
    """serve.layer_data's readings, the trunk's work counted as a
    ResNet's (benchmark/counts/resnet.py)."""
    model = config["model"]
    rois = [torch.as_tensor(b[2], device=device) for b in pool]
    pool_work = [counts.pool(model, mix["canvas"], r) for r in rois]
    work = {"trunk": resnet_counts.trunk(model, mix["canvas"], mix["batch"]),
            "head": counts.head(model, mix["batch"] * mix["proposals"]),
            "pool": {k: sum(w[k] for w in pool_work) / len(pool_work)
                     for k in ("ops", "bytes")}}
    for name, dtype in (("trunk", "bf16"), ("pool", "bf16"),
                        ("head", "int8")):
        harness.log(f"{name}: {work[name]['ops']:.6g} ops, "
                    f"{work[name]['bytes']:.6g} bytes a batch; "
                    f"{peaks.binds(work[name], dtype)} bind")
    n = serve.SLICE
    return {"kind": "serve", "batches": n,
            "head_int8": model["head_quant"] == "int8",
            "span_device_s": {k: v / n for k, v in
                              traced["span_device_s"].items()},
            "busy_s": traced["busy_s"], "window_s": traced["window_s"],
            "batch_s": per_batch_s, "work": work, "nms_ms": nms_ms}


def run(run: harness.Run) -> harness.Outcome:
    dev = run.device
    cfg = serve.program_config(run.config, run.mix)

    def stage(what):
        harness.log(f"set-up: {what} at "
                    f"{time.perf_counter() - run.start:.3f} s")

    stage("imports done")
    det = build_detector(cfg, run.config, run.seed, dev)
    stage("detector loaded")
    pool = traffic.batches(run.mix, weights.seed64(run.seed))
    stage("traffic drawn")
    server = serve.Server(det, serve.kept_batches(run.mix, run.seed))
    tap_stds(server, 0, pool[0], run.config["tap_std"])
    stage("warm-up call 0 done")
    for i in range(1, serve.WARMUP):
        server(i % len(pool), pool[i % len(pool)])
        stage(f"warm-up call {i} done")
    server.spans.reset()
    setup_s = time.perf_counter() - run.start
    harness.log(f"set-up {setup_s:.3f} s")
    lat, win_s, n, nxt = serve.window(server, pool, run.seconds,
                                      serve.WARMUP)
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
        traced = reduce_trace(profile(step, serve.SLICE, dev))
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
    taps = program_taps(det, keep, pool, run.mix["canvas"], dev)
    del det, server
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    layer = None
    if traced is not None:
        layer = layer_data(run.config, run.mix, pool, nms_ms, traced,
                           win_s / n, dev)
    t = time.perf_counter()
    got = check(fed, served, keep, taps, cfg, run.config, run.mix, pool,
                run.seed, dev)
    harness.log(f"check {time.perf_counter() - t:.3f} s")
    limits = run.config["limits"]
    return harness.Outcome(
        attempted=n, failed=failed,
        end_to_end={"img_per_s": n * run.mix["batch"] / win_s,
                    "batch_p95_ms": float(np.percentile(lat_ms, 95)),
                    "setup_s": setup_s},
        checks=[harness.Check(k, got[k], limits[k]) for k in
                ("prob_err", "box_err", "nms_mismatch", "tap_err")],
        memory_peak_bytes=peak, layer=layer,
        busy_s=None if traced is None else traced["busy_s"],
        window_s=None if traced is None else traced["window_s"],
        breakdown=None if traced is None else traced["breakdown"])
