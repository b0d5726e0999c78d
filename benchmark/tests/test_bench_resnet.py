"""The ResNet-101 serving cell (entry serve_resnet): a whole tiny run of it
on the CPU through the harness (the ResNet-101 trunk at its published
widths and depth on a 64 x 64 canvas, the head cut as the tiny VGG cell's),
its result line, its readers found by name, its work count, the draw's
guard on the taps, the program against the cell's plain reference
(benchmark/reference/multipath_resnet.py) at a small size, and, on a card,
the controls failing the cell's limits at the cell's own size.

The program against the reference, on the CPU: the trunk at its published
widths and depth on a 64 or 96 px canvas, the head cut to fc_dim 64 with
SVD ranks 16/8 and 5 classes; weights from the cell's draw
(benchmark/weights_resnet.py) through `Detector`'s load transform (SVD,
int8), the program's normal path (`score_batch`, the kernels' plain
versions). Tolerances, each against the reference's float32 with its
reason, for the preset's bf16 and (as a check that the arithmetic is the
same) for the model computed in float32:
- float32: taps 1e-5 of the largest magnitude (the same operations, float32
  sums in another order; 1.6e-6 read), probabilities 1e-4 and boxes 5e-5
  (an int8 code moves where a value sits on a rounding edge; 1.0e-5 and
  3.6e-6 read);
- bf16 taps (the reduced c3/c4/c5 maps, fed the same canvases): 2e-2 of
  the reference map's largest magnitude. The program rounds every
  convolution's operands and every BatchNorm's output to bf16 (8
  significant bits) through 94 convolutions; it reads 0.5-0.9% here, an
  fp8 trunk (e4m3, 4 significant bits) 6.5-9.5%, so an fp8 trunk fails
  it (test_fp8_trunk_fails_the_tap_tolerance);
- bf16 probabilities (|log p - log p_ref|) 2e-4 and boxes (over the box's
  larger side) 1e-4: the int8 head's codes, taken from bf16 pooled maps,
  move by a code where a value sits near a rounding edge; the program
  reads at most 5e-5 and 3e-5. With the head cut to fc_dim 64 and drawn
  at normal * 0.02 the scores stay near uniform, so at this size the
  probabilities barely see the trunk: the taps carry the trunk's check.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import pytest
import torch

from benchmark import calibrate_resnet, harness, traffic, weights_resnet
from benchmark.counts import resnet as resnet_counts
from benchmark.entries import serve
from benchmark.reference import multipath_resnet as ref

from conftest import REPO, TINY_EVAL, TINY_MIX, TINY_MODEL

CELL = "serve_r101_int8svd_p1000"
CONFIG = "multipath_resnet101_int8_svd"
# the cell's own readers, then those it shares with serve_int8svd_p1000
OWN = ["trunk_roofline.serve_r101", "bn_passes.serve_r101"]
SHARED = ["device_idle_pct.serve", "mfu.serve", "pool_roofline.serve",
          "head_roofline.serve", "nms_ms.serve", "h2d_ms.serve",
          "host_syncs.serve", "nms_rounds.serve"]
READERS = OWN + SHARED
# the tiny size's own limits, above the program's readings there (about
# 3e-5 on both); the cell's are set at its size on the card (PERF.md)
LIMITS = {"prob_err": 2e-4, "box_err": 1e-4}
SEED = 2**40 + 3


def tiny_resnet_root(path, config=None) -> str:
    """A checkout at `path` with the one cell "tiny_r101": the ResNet-101
    configuration with the tiny cell's head, eval and mix."""
    spec = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    conf = json.load(open(os.path.join(REPO, "benchmark", "configs",
                                       CONFIG + ".json")))
    conf["model"].update(TINY_MODEL)
    conf["eval"].update(TINY_EVAL)
    conf["limits"].update(LIMITS)
    conf.update(config or {})
    os.makedirs(os.path.join(path, "benchmark", "traffic"))
    with open(os.path.join(path, "tiny_r101.json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(path, "benchmark", "traffic", "tiny.json"),
              "w") as f:
        json.dump(TINY_MIX, f)
    entry = harness.find(spec["configs"], CONFIG, "config")
    spec["configs"] = [dict(entry, name="tiny_r101", file="tiny_r101.json")]
    spec["workloads"] = [{"name": "tiny_r101", "config": "tiny_r101",
                          "traffic": "tiny", "chips": 1, "why": "test"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny_r101"] if CELL in m["workloads"] else []
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return str(path)


def run(root, trace):
    from multipathnet_tpu_torch.utils import profiling

    profiling.clear_records()   # roots other tests left in this process
    metrics, out = harness.run_cell(root, "tiny_r101", SEED, 0.1, trace,
                                    torch.device("cpu"), time.perf_counter())
    return harness.result_line(metrics, out, {"platform": "cpu"})


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_line(tmp_path, trace):
    line = run(tiny_resnet_root(tmp_path), trace)
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["checks"]) == {"prob_err", "box_err", "nms_mismatch",
                                   "tap_err"}
    if not trace:
        assert set(line["metrics"]) == {"img_per_s", "batch_p95_ms",
                                        "setup_s"}
        return
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # off the card no kernel is traced: the roofline and the idle share
    # read nothing
    assert set(line["metrics"]) == {"mfu.serve", "bn_passes.serve_r101",
                                    "nms_ms.serve", "host_syncs.serve",
                                    "nms_rounds.serve"}
    assert line["metrics"]["bn_passes.serve_r101"]["value"] == 94.0


def test_vanishing_trunk_fails_set_up(tmp_path):
    """A draw whose taps fall outside the configuration's band stops the
    run before anything is timed."""
    root = tiny_resnet_root(tmp_path, {"tap_std": [1e3, 1e4]})
    with pytest.raises(RuntimeError, match="tap c3"):
        run(root, False)


def test_cell_is_listed():
    spec = harness.load_spec(REPO)
    _, cell, config, mix = harness.load_cell(REPO, CELL)
    assert cell["config"] == CONFIG and cell["chips"] == 1
    assert config["entry"] == "serve_resnet" and mix["kind"] == "detect"
    assert config["model"]["backbone"] == "resnet101"
    assert config["reduced"] == []
    assert {m["name"] for m in harness.cell_metrics(spec, CELL, False)} == {
        "img_per_s", "batch_p95_ms", "setup_s"}
    assert {m["name"] for m in harness.cell_metrics(spec, CELL, True)} == set(
        READERS)
    for name in READERS:
        assert callable(harness.load_reader(name))
    vgg = json.load(open(os.path.join(REPO, "benchmark", "configs",
                                      "multipath_vgg16_int8_svd.json")))
    assert config["model"] == dict(vgg["model"], backbone="resnet101")
    assert config["eval"] == vgg["eval"]


LAYER = {"kind": "serve", "batches": 2, "busy_s": 0.06, "batch_s": 0.04,
         "head_int8": True,
         "span_device_s": {"features": 0.001, "features.stem": 0.002,
                           "features.stage2": 0.003,
                           "features.stage3": 0.004,
                           "features.stage4": 0.010, "pool_rois": 0.005},
         "work": {"trunk": {"ops": 989e12 * 0.002, "bytes": 0.0},
                  "pool": {"ops": 989e12 * 0.001, "bytes": 0.0},
                  "head": {"ops": 1979e12 * 0.001, "bytes": 0.0}}}


def test_readers_on_a_fake_layer():
    read = harness.load_reader
    # the trunk's span and its stage spans: 20 ms against a 2 ms bound
    assert read("trunk_roofline.serve_r101")(LAYER) == pytest.approx(10.0)
    # a program without the stage spans reads features alone
    parent = dict(LAYER, span_device_s={"features": 0.020})
    assert read("trunk_roofline.serve_r101")(parent) == pytest.approx(10.0)
    # the shared readers read the ResNet trunk's count from the same keys
    assert read("mfu.serve")(LAYER) == pytest.approx(10.0)
    assert read("device_idle_pct.serve")(LAYER) == pytest.approx(25.0)
    for name in READERS:
        assert read(name)(None) is None
        assert read(name)(dict(LAYER, kind="train")) is None


def _root(counters):
    return {"name": "detect", "device_ms": None, "children": [],
            "counters": counters}


def test_bn_passes_reader(monkeypatch):
    from multipathnet_tpu_torch.utils import profiling

    read = harness.load_reader("bn_passes.serve_r101")
    monkeypatch.setattr(profiling, "counters", lambda: {"bn.passes": 188})
    monkeypatch.setattr(profiling, "records", lambda: [
        _root({"bn.passes": 94}), _root({"bn.passes": 94})])
    assert read(LAYER) == 94.0
    monkeypatch.setattr(profiling, "records", lambda: [
        _root({"bn.passes": 94})])
    assert read(LAYER) is None   # a root too few
    # the parent of the change that added the counter reads nothing
    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert read(LAYER) is None
    monkeypatch.delattr(profiling, "records")
    assert read(LAYER) is None


def test_trunk_count():
    """Table 1's convolutions listed by hand, (side, in, out, k), at 640^2:
    1.007 TFLOP a batch of 8, bound by operations at bf16's peak."""
    from benchmark import peaks

    convs = [(320, 3, 64, 7)]
    for side, cin, f, n, s0 in ((160, 64, 64, 3, 160),
                                (80, 256, 128, 4, 160),
                                (40, 512, 256, 23, 80)):
        convs += [(s0, cin, f, 1), (side, f, f, 3), (side, f, 4 * f, 1),
                  (side, cin, 4 * f, 1)]
        convs += [(side, 4 * f, f, 1), (side, f, f, 3),
                  (side, f, 4 * f, 1)] * (n - 1)
    convs += [(160, 256, 512, 1), (80, 512, 512, 1), (40, 1024, 512, 1)]
    # the stem, 30 bottlenecks of 3 and their 3 projections (one
    # BatchNorm each), then the 3 reductions
    assert len(convs) == 1 + 3 * 30 + 3 + 3
    macs = sum(s * s * i * o * k * k for s, i, o, k in convs)
    model = {"backbone": "resnet101", "skip_reduce_dim": 512,
             "skip_levels": ["c3", "c4", "c5"]}
    got = resnet_counts.trunk(model, 640, 8)
    assert got["ops"] == 2 * 8 * macs == 1006947532800
    weights = sum(i * o * k * k for _, i, o, k in convs)
    maps = 160 * 160 + 80 * 80 + 40 * 40
    assert got["bytes"] == 2 * weights + 8 * (640 * 640 * 3 * 4
                                              + 2 * 512 * maps)
    assert peaks.binds(got, "bf16") == "operations"


@pytest.mark.cuda
@pytest.mark.parametrize("control", sorted(calibrate_resnet.CONTROLS))
def test_control_fails_the_cell_limits(control):
    """The reference with an fp8 trunk, reduce and pooled maps, and an
    int4 head ("fp8_int4") or the configured int8 head ("fp8_trunk"), put
    in the program's place, reads above the cell's limits at the cell's
    own size. On a card:
        python -m pytest benchmark/tests -m cuda -q"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = torch.device("cuda", 0)
    _, _, config, mix = harness.load_cell(REPO, CELL)
    cfg = serve.program_config(config, mix)
    got = calibrate_resnet.control_readings(
        cfg, config, mix, 11, card, calibrate_resnet.CONTROLS[control])
    assert any(got[k] > config["limits"][k] for k in got), got


# ------------------------------------ the program against the reference ---

TAP_TOL = 2e-2
# dtype -> (taps, probabilities, boxes)
TOLS = {"bfloat16": (TAP_TOL, 2e-4, 1e-4), "float32": (1e-5, 1e-4, 5e-5)}


def _serving(canvas: int, seed: int, dtype: str = "bfloat16"):
    """-> (cfg, the drawn checkpoint, a Detector loaded from it, one
    batch (images, hws, proposals) as tensors)."""
    from multipathnet_tpu_torch.core.config import preset
    from multipathnet_tpu_torch.eval.detect import Detector
    from multipathnet_tpu_torch.models import convert
    from multipathnet_tpu_torch.models.multipath import build_model

    _, _, config, _ = harness.load_cell(REPO, CELL)
    cfg = preset(CONFIG)
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, fc_dim=64, fc6_rank=16,
                                  fc7_rank=8, num_classes=5, dtype=dtype),
        data=dataclasses.replace(cfg.data, image_size=(canvas, canvas),
                                 max_proposals=16))
    cpu = torch.device("cpu")
    sd = weights_resnet.draw(serve.checkpoint_shapes(cfg), config["weights"],
                             seed, cpu)
    det = Detector(build_model(cfg.model, device="cpu"), cfg, device="cpu",
                   params=convert.flax_from_state_dict(sd))
    mix = {"kind": "detect", "batch": 2, "canvas": canvas,
           "long_side": canvas, "short_side": [canvas * 5 // 8, canvas],
           "proposals": 16, "xy_frac": 0.7, "side": [4, 0.3], "pool": 1,
           "score_threshold": 0.0, "check_batches": 1}
    batch = traffic.batches(mix, seed)[0]
    return cfg, sd, det, tuple(torch.as_tensor(x) for x in batch[:3])


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("dtype", sorted(TOLS))
@pytest.mark.parametrize("canvas,seed", [(64, 1), (96, SEED)])
def test_port_matches_reference(canvas, seed, dtype):
    from multipathnet_tpu_torch.eval.detect import score_batch

    tap_tol, prob_tol, box_tol = TOLS[dtype]
    cfg, sd, det, (images, hws, props) = _serving(canvas, seed, dtype)
    model = dataclasses.asdict(cfg.model)
    x, _ = ref.base.canvases(images, hws, canvas)
    with torch.inference_mode():
        feats = det.model.features(x)
    want = ref.trunk(sd, "resnet101", x, model["skip_levels"],
                     ref.base.Precision())
    for lv in ("c3", "c4", "c5"):
        assert feats[lv].shape == want[lv].shape
        assert _rel(feats[lv], want[lv]) < tap_tol, lv

    boxes, probs = score_batch(det.model, cfg, images, hws, props)
    probs_ref, boxes_ref = ref.detect_scores(sd, model, canvas, images, hws,
                                             props)
    prob_err, box_err = serve.gaps(probs[..., 1:], boxes[..., 1:, :],
                                   probs_ref[..., 1:], boxes_ref[..., 1:, :])
    assert prob_err < prob_tol and box_err < box_tol, (prob_err, box_err)


def test_fp8_trunk_fails_the_tap_tolerance():
    cfg, sd, _, (images, hws, _) = _serving(64, 1)
    x, _ = ref.base.canvases(images, hws, 64)
    levels = cfg.model.skip_levels
    exact = ref.trunk(sd, "resnet101", x, levels, ref.base.Precision())
    low = ref.trunk(sd, "resnet101", x, levels, ref.base.Precision(fp8=True))
    assert all(_rel(low[lv], exact[lv]) > 2 * TAP_TOL for lv in levels)


@pytest.mark.parametrize("seed", [0, 7, SEED])
def test_draw_keeps_taps_finite_and_sized(seed):
    """The program's raw taps (conv2_x..conv4_x outputs) under the draw:
    finite, each standard deviation inside the cell's band."""
    _, _, config, _ = harness.load_cell(REPO, CELL)
    lo, hi = config["tap_std"]
    _, _, det, (images, hws, _) = _serving(64, seed)
    x, _ = ref.base.canvases(images, hws, 64)
    with torch.inference_mode():
        taps = det.model.backbone(x)
    assert set(taps) == {"c3", "c4", "c5"}
    for lv, t in taps.items():
        t = t.float()
        assert torch.isfinite(t).all(), lv
        assert lo <= float(t.std()) <= hi, lv



def test_tap_err_holds_the_trunk():
    """serve_resnet's tap_err on the served model at a small size sits
    under the cell's limit, and the reference's fp8 trunk (the trunk-only
    control) over it."""
    from benchmark.entries import serve_resnet

    _, _, config, _ = harness.load_cell(REPO, CELL)
    limit = config["limits"]["tap_err"]
    cfg, sd, det, (images, hws, props) = _serving(64, 1)
    batch = (images.numpy(), hws.numpy(), props.numpy())
    (x, maps), = serve_resnet.program_taps(det, {0}, [batch], 64,
                                           torch.device("cpu")).values()
    assert serve_resnet.tap_gap(sd, config, x, maps) < limit
    model = config["model"]
    low = ref.trunk(sd, model["backbone"], x, model["skip_levels"],
                    calibrate_resnet.CONTROLS["fp8_trunk"])
    assert serve_resnet.tap_gap(sd, config, x, low) > limit
