"""The ResNet-101 training cell (entry train_resnet): a whole tiny run of it
on the CPU through the harness (the ResNet-101 trunk at its published
widths and depth on a 64 x 64 canvas, the head cut as the tiny training
cell's), its result line, the program against the cell's plain reference
(benchmark/reference/train_resnet.py) on seeded weights, both fp8
controls and the planted faults failing a check, the step's and the
trunk's work counts against hand counts, and the two new readers on a
recorded slice.

At the tiny size the checks take limits of their own (LIMITS), set from
its readings on the test's seed: the program in bf16 reads loss_gap 5e-6,
grad_gap 0.023, update_gap 0.079 (reduce_c3's change, a small leaf) and
trunk_gap 0.047; the fp8 control trunk_gap 0.20, the trunk-only fp8
control trunk_gap 0.14. The cell's limits are set at its own size on the
card (PERF.md section 2). In float32 the program computes the reference's
arithmetic (sums in another order), and every gap is under 1e-4.
"""

from __future__ import annotations

import json
import os
import time

import pytest
import torch

from benchmark import calibrate_resnet_train as cal
from benchmark import harness
from benchmark.counts import resnet as resnet_counts
from benchmark.counts import resnet_train as counts

from conftest import REPO, TINY_MODEL, TINY_TRAIN_MIX

CELL = "train_r101_b8"
CONFIG = "multipath_resnet101_train"
OWN = ["trunk_roofline.train_r101", "trunk_backward_ms.train_r101"]
SHARED = ["device_idle_pct.train", "mfu.train", "host_syncs.train",
          "optimizer_ms.train", "pool_backward_ms.train"]
LIMITS = {"loss_gap": 1e-4, "grad_gap": 0.1, "update_gap": 0.1,
          "trunk_gap": 0.1}
SEED = 2**40 + 5
CHECKS = {"loss_gap", "grad_gap", "update_gap", "trunk_gap"}


def tiny_root(path, model=None) -> str:
    """A checkout at `path` with the one cell "tiny_r101_train": the
    configuration with the tiny training cell's head and mix."""
    spec = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    conf = json.load(open(os.path.join(REPO, "benchmark", "configs",
                                       CONFIG + ".json")))
    conf["model"].update({k: v for k, v in TINY_MODEL.items()
                          if not k.endswith("_rank")}, **(model or {}))
    conf["data"]["rois_per_image"] = 8
    conf["limits"].update(LIMITS)
    os.makedirs(os.path.join(path, "benchmark", "traffic"))
    with open(os.path.join(path, "tiny_r101_train.json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(path, "benchmark", "traffic",
                           "tiny_train.json"), "w") as f:
        json.dump(TINY_TRAIN_MIX, f)
    entry = harness.find(spec["configs"], CONFIG, "config")
    spec["configs"] = [dict(entry, name="tiny_r101_train",
                            file="tiny_r101_train.json")]
    spec["workloads"] = [{"name": "tiny_r101_train",
                          "config": "tiny_r101_train",
                          "traffic": "tiny_train", "chips": 1,
                          "why": "test"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = (["tiny_r101_train"] if CELL in m["workloads"]
                              else [])
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return str(path)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("r101_train"))


def run(root, trace):
    from multipathnet_tpu_torch.utils import profiling

    profiling.clear_records()   # roots other tests left in this process
    metrics, out = harness.run_cell(root, "tiny_r101_train", SEED, 0.1,
                                    trace, torch.device("cpu"),
                                    time.perf_counter())
    return harness.result_line(metrics, out, {"platform": "cpu"})


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_line(root, trace):
    line = run(root, trace)
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["checks"]) == CHECKS
    if not trace:
        assert set(line["metrics"]) == {"train_step_ms", "setup_s"}
        return
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # off the card no kernel is traced and no span has a device interval:
    # the rooflines, the idle share and the spans' ms read nothing
    assert set(line["metrics"]) == {"mfu.train", "host_syncs.train"}


def test_cell_is_listed():
    spec = harness.load_spec(REPO)
    _, cell, config, mix = harness.load_cell(REPO, CELL)
    assert cell["config"] == CONFIG and cell["chips"] == 1
    assert cell["traffic"] == "train_b8" and mix["kind"] == "train"
    assert config["entry"] == "train_resnet"
    assert config["reduced"] == [] and config["start_step"] == 500
    assert set(config["limits"]) == CHECKS
    vgg = json.load(open(os.path.join(REPO, "benchmark", "configs",
                                      "multipath_vgg16_train.json")))
    serving = json.load(open(os.path.join(
        REPO, "benchmark", "configs", "multipath_resnet101_int8_svd.json")))
    assert config["model"] == dict(vgg["model"], backbone="resnet101")
    assert (config["data"], config["train"]) == (vgg["data"], vgg["train"])
    assert config["weights"] == serving["weights"]
    assert config["tap_std"] == serving["tap_std"]
    assert {m["name"] for m in harness.cell_metrics(spec, CELL, False)} == {
        "train_step_ms", "setup_s"}
    assert {m["name"] for m in harness.cell_metrics(spec, CELL, True)} == set(
        OWN + SHARED)
    for name in OWN + SHARED:
        assert callable(harness.load_reader(name))


# ------------------------------ the program against the reference ---

def test_float32_program_computes_the_reference(tmp_path):
    """The cell's own check at the tiny size with the model in float32:
    the same arithmetic, sums in another order."""
    r = tiny_root(tmp_path, {"dtype": "float32"})
    got = cal.program_readings("tiny_r101_train", SEED, torch.device("cpu"),
                               root=r)
    assert set(got) == CHECKS
    assert all(v < 1e-4 for v in got.values()), got


@pytest.mark.parametrize("side", ["control:fp8", "control:fp8_trunk",
                                  "half_batch"])
def test_controls_and_half_batch_fail_a_check(root, side):
    _, _, config, mix = harness.load_cell(root, "tiny_r101_train")
    cfg = cal.train_resnet.program_config(config, mix)
    cpu = torch.device("cpu")
    if side == "half_batch":
        got = cal.substitute(cfg, config, mix, SEED, cpu,
                             keep_images=slice(0, mix["batch"] // 2))
    else:
        got = cal.substitute(cfg, config, mix, SEED, cpu,
                             **cal.CONTROLS[side.split(":")[1]])
    assert any(got[k] > config["limits"][k] for k in got), got
    if side == "control:fp8_trunk":
        # the trunk alone lowered: trunk_gap is the number that sees it
        assert got["trunk_gap"] > config["limits"]["trunk_gap"], got


@pytest.mark.parametrize("fault", ["no_momentum", "schedule_restarted"])
def test_planted_faults_fail_a_check(root, fault):
    _, _, config, _ = harness.load_cell(root, "tiny_r101_train")
    got = cal.program_readings("tiny_r101_train", SEED, torch.device("cpu"),
                               fault, root=root)
    assert any(got[k] > config["limits"][k] for k in got), got


def test_reference_freezes_the_stem_and_conv2_x_and_keeps_statistics(root):
    """Three steps of the reference: the stem, stem_bn, conv2_x and every
    BN statistic stay bit-equal; conv3_x's and conv4_x's convolutions and
    BN scales and biases move, and only they, the reductions and the
    head train."""
    from benchmark import traffic, weights, weights_resnet
    from benchmark.entries import serve
    from benchmark.reference.train_resnet import Reference

    _, _, config, mix = harness.load_cell(root, "tiny_r101_train")
    cfg = cal.train_resnet.program_config(config, mix)
    cpu = torch.device("cpu")
    sd = weights_resnet.draw(serve.checkpoint_shapes(cfg),
                             config["weights"], 7, cpu)
    r = Reference(sd, config, mix["canvas"], 8, cpu)
    for b in traffic.batches(mix, weights.seed64(7)):
        r.step(b)
    assert "backbone.stage3_block0.BatchNorm_0.weight" in r.trainable
    for k, v in sd.items():
        moved = not torch.equal(r.params[k].detach(), v)
        frozen = k.startswith(("backbone.stem", "backbone.stage2_"))
        statistic = k.endswith(("running_mean", "running_var"))
        assert moved == (not frozen and not statistic), k
        assert (k in r.trainable) == moved, k


# ------------------------------------------------------------ counts ---

MODEL = {"backbone": "resnet101", "skip_reduce_dim": 512,
         "skip_levels": ["c3", "c4", "c5"], "roi_output_size": 7,
         "foveal_scales": [1.0, 1.5, 2.0, 4.0], "fc_dim": 4096,
         "fc6_rank": 0, "fc7_rank": 0, "num_classes": 81,
         "integral_thresholds": [0.5, 0.55, 0.6, 0.65, 0.7, 0.75],
         "class_specific_bbox": True, "head_quant": "none"}


def test_step_and_trunk_counts():
    """Table 1's convolutions listed by hand at 640^2, (stage, side, in,
    out, k, reads the frozen stage's output); a step of 8 canvases and
    512 ROIs with the stem and conv2_x frozen."""
    convs = [(1, 320, 3, 64, 7, False)]
    for stage, side, cin, f, n, s0 in ((2, 160, 64, 64, 3, 160),
                                       (3, 80, 256, 128, 4, 160),
                                       (4, 40, 512, 256, 23, 80)):
        convs += [(stage, s0, cin, f, 1, stage == 3),
                  (stage, side, f, f, 3, False),
                  (stage, side, f, 4 * f, 1, False),
                  (stage, side, cin, 4 * f, 1, stage == 3)]
        convs += [(stage, side, 4 * f, f, 1, False),
                  (stage, side, f, f, 3, False),
                  (stage, side, f, 4 * f, 1, False)] * (n - 1)
    assert len(convs) == 94
    reduce = 160 * 160 * 256 * 512 + 80 * 80 * 512 * 512 + (
        40 * 40 * 1024 * 512)

    def macs(c):
        return c[1] * c[1] * c[2] * c[3] * c[4] * c[4]

    forward = sum(map(macs, convs)) + reduce
    trainable = sum(macs(c) for c in convs if c[0] >= 3) + reduce
    backward = sum(macs(c) * (1 if c[5] else 2) for c in convs if c[0] >= 3)
    g, views, fc = 7, 4, 4096
    head = views * (g * g * 512 * fc + fc * fc + fc * (6 * 81 + 4 * 81))
    got = counts.train(MODEL, 640, 8, 512, 2)
    assert got["ops"] == 2 * 8 * forward + 2 * 512 * head + 2 * (
        2 * 8 * trainable + 2 * 512 * head)
    assert got["trunk"]["ops"] == 2 * 8 * (forward + backward)
    assert 2 * 8 * forward == resnet_counts.trunk(MODEL, 640, 8)["ops"]
    weights = sum(c[2] * c[3] * c[4] * c[4] for c in convs if c[0] >= 3)
    assert got["trunk"]["bytes"] == resnet_counts.trunk(
        MODEL, 640, 8)["bytes"] + 6 * weights
    assert round(got["trunk"]["ops"] / 1e12, 3) == 2.601
    assert round(got["ops"] / 1e12, 3) == 4.325


# ----------------------------------------------------------- readers ---

LAYER = {"kind": "train", "steps": 2, "busy_s": 0.1, "step_s": 0.1,
         "work": {"ops": 989e12 * 0.01,
                  "trunk": {"ops": 989e12 * 0.002, "bytes": 0.0}},
         "span_device_s": {"features": 0.001, "features.stem": 0.001,
                           "features.stage2": 0.002,
                           "features.stage3": 0.002,
                           "features.stage4": 0.004,
                           "features.stage4.backward": 0.006,
                           "features.stage3.backward": 0.004,
                           "pool_rois": 0.005, "train.backward": 0.003}}


def _record(name, device_ms, children=()):
    return {"name": name, "device_ms": device_ms,
            "children": list(children)}


def _step(stage4_ms, stage3_ms):
    return dict(_record("train.step", None, [
        _record("features", 9.0, [_record("features.stage4", 5.0)]),
        _record("train.backward", 30.0, [
            _record("pool_rois.backward", 1.0),
            _record("features.stage4.backward", stage4_ms),
            _record("features.stage3.backward", stage3_ms)])]),
        counters={})


def test_trunk_roofline_reader():
    read = harness.load_reader("trunk_roofline.train_r101")
    # 20 ms of the trunk's spans, forward and backward, against a 2 ms
    # bound
    assert read(LAYER) == pytest.approx(10.0)
    # a program without the backward spans reads nothing
    forward = {k: v for k, v in LAYER["span_device_s"].items()
               if not k.endswith(".backward")}
    assert read(dict(LAYER, span_device_s=forward)) is None
    assert read(dict(LAYER, kind="serve")) is None
    assert read(None) is None
    vgg = {k: v for k, v in LAYER.items() if k != "span_device_s"}
    assert read(vgg) is None


def test_trunk_backward_ms_reader(monkeypatch):
    from multipathnet_tpu_torch.utils import profiling

    read = harness.load_reader("trunk_backward_ms.train_r101")
    monkeypatch.setattr(profiling, "records", lambda: [
        _step(6.0, 4.0), _step(7.0, 5.0)])
    assert read(LAYER) == pytest.approx(11.0)
    monkeypatch.setattr(profiling, "records", lambda: [_step(6.0, 4.0)])
    assert read(LAYER) is None   # a root too few
    monkeypatch.setattr(profiling, "records", lambda: [
        _step(6.0, None), _step(7.0, 5.0)])
    assert read(LAYER) is None   # off the card: no device interval
    # the parent of the change that added the spans reads nothing
    bare = dict(_record("train.step", None, [
        _record("train.backward", 30.0, [
            _record("pool_rois.backward", 1.0)])]), counters={})
    monkeypatch.setattr(profiling, "records", lambda: [bare, bare])
    assert read(LAYER) is None
    monkeypatch.delattr(profiling, "records")
    assert read(LAYER) is None
    assert read(dict(LAYER, kind="serve")) is None
