"""The port's spans and counters (utils/profiling): an off span records
nothing and enters no profiler range; on spans nest by parent and root in
a bounded ring, adopt spans of another thread, and carry their root's
counter changes; under torch.profiler a Detector call and a Trainer.step
put the layer spans in the trace with nothing else inside the model's
and NMS's spans, and so do tracing()'s records without the profiler;
nms.rounds counts the fixpoint's rounds and h2d.bytes the inputs' bytes;
every kernel's launches are counters, read through profiling.kernel_launches.

The `cuda` tests (skipped without a card) hold the counted sync.* sites to
every synchronizing call that torch's sync debug mode reports, for one
batch and one step at the benchmark cells' shapes. On a GPU machine:
    python -m pytest tests/test_torch_tracing.py --noconftest -m cuda -q
"""

import collections
import dataclasses
import json
import threading
import time
import types
import warnings

import numpy as np
import pytest
import torch

from multipathnet_tpu_torch.core.config import preset
from multipathnet_tpu_torch.eval.detect import Detector
from multipathnet_tpu_torch.models import convert
from multipathnet_tpu_torch.models.multipath import build_model, init_params_
from multipathnet_tpu_torch.ops import nms as nms_ops
from multipathnet_tpu_torch.ops import roi_pool
from multipathnet_tpu_torch.train import loop as tloop
from multipathnet_tpu_torch.utils import profiling

SERVE_SPANS = {"detect", "detect.put", "detect.resize", "features",
               "pool_rois", "predict_rois", "detect.decode",
               "multiclass_nms", "detect.fetch"}
TRAIN_SPANS = {"train.step", "train.put", "train.augment", "train.sample",
               "features", "pool_rois", "predict_rois", "train.loss",
               "train.backward", "pool_rois.backward", "train.optimizer"}
# the spans whose device time the benchmark's rooflines and NMS read
LAYER_SPANS = ("features", "pool_rois", "predict_rois", "multiclass_nms")
# a ResNet trunk's stage spans, the only spans inside features
RESNET_SPANS = {"features.stem", "features.stage2", "features.stage3",
                "features.stage4"}
# a ResNet trunk's training stages' backward spans with conv2_x frozen,
# under train.backward
RESNET_BACKWARD_SPANS = {"features.stage3.backward",
                         "features.stage4.backward"}


@pytest.fixture(autouse=True)
def fresh_records():
    profiling.clear_records()
    yield
    profiling.clear_records()


def _serve_inputs(cfg, b=2, p=16, seed=0):
    rng = np.random.default_rng(seed)
    h, w = cfg.data.image_size
    images = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    hws = np.tile(np.asarray([[h, w], [h - 8, w - 6]], np.float32),
                  (b, 1))[:b]
    xy = rng.uniform(0, h / 2, (b, p, 2))
    wh = rng.uniform(6, h / 2, (b, p, 2))
    props = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    return images, hws, props, np.ones((b, p), bool)


def _train_batch(cfg, b=2, seed=0):
    images, hws, props, _ = _serve_inputs(cfg, b, cfg.data.max_proposals,
                                          seed)
    b, g = images.shape[0], cfg.data.max_gt_per_image
    gt = np.zeros((b, g, 4), np.float32)
    gt[:, :3] = props[:, :3]
    classes = np.zeros((b, g), np.int32)
    classes[:, :3] = 1
    gt_mask = np.zeros((b, g), bool)
    gt_mask[:, :3] = True
    return tloop.Batch(images, hws, props, np.ones(props.shape[:2], bool),
                       gt, classes, gt_mask)


@pytest.fixture(scope="module")
def tiny_detector():
    cfg = preset("tiny")
    model = init_params_(build_model(cfg.model, device="cpu"),
                         torch.Generator().manual_seed(0))
    det = Detector(model, cfg, device="cpu")
    det(*_serve_inputs(cfg))           # the first call, outside any test
    return det


@pytest.fixture(scope="module")
def tiny_int8_detector():
    """tiny with the int8 head, quantized at load from a float tree."""
    cfg = preset("tiny")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, head_quant="int8"))
    float_model = init_params_(
        build_model(dataclasses.replace(cfg.model, head_quant="none"),
                    device="cpu"), torch.Generator().manual_seed(0))
    det = Detector(build_model(cfg.model, device="cpu"), cfg, device="cpu",
                   params=convert.flax_from_state_dict(
                       float_model.state_dict(), host=False))
    det(*_serve_inputs(cfg))
    return det


@pytest.fixture(scope="module")
def tiny_resnet_detector():
    cfg = preset("tiny")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                backbone="resnet18"))
    model = init_params_(build_model(cfg.model, device="cpu"),
                         torch.Generator().manual_seed(0))
    det = Detector(model, cfg, device="cpu")
    det(*_serve_inputs(cfg))
    return det


def _stepper(cfg):
    trainer = tloop.Trainer(cfg, device="cpu")
    state = trainer.init_state(0)
    box = [trainer, state]
    batch = _train_batch(cfg)

    def step():
        box[1], metrics = trainer.step(box[1], batch)
        return metrics

    step()
    return types.SimpleNamespace(trainer=trainer, step=step, batch=batch)


@pytest.fixture(scope="module")
def tiny_trainer():
    return _stepper(preset("tiny"))


@pytest.fixture(scope="module")
def tiny_resnet_trainer():
    """tiny on a ResNet-50 trunk (multipath_resnet101_train's bottleneck
    blocks) with its stem and conv2_x frozen, as that preset freezes."""
    cfg = preset("tiny")
    return _stepper(cfg.replace(
        model=dataclasses.replace(cfg.model, backbone="resnet50"),
        train=dataclasses.replace(cfg.train, freeze_backbone_stages=2)))


def _names(record) -> list:
    return [r["name"] for r in profiling.walk(record)]


# ------------------------------------------------------------- spans ---

def test_off_span_records_nothing_and_enters_no_range(monkeypatch,
                                                      tiny_detector):
    def no_range(*a, **k):
        raise AssertionError("an off span entered a profiler range")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    assert not profiling.tracing_on()

    @profiling.span("outer")
    def f(x):
        with profiling.span("inner"):
            return x + 1

    assert f(1) == 2
    det = tiny_detector
    det(*_serve_inputs(det.cfg))
    assert profiling.records() == []


def test_on_spans_nest_with_parent_and_root():
    @profiling.span("leaf")
    def leaf():
        return 3

    with profiling.tracing():
        assert profiling.tracing_on()
        with profiling.span("root"):
            with profiling.span("mid"):
                leaf()
            leaf()
    assert not profiling.tracing_on()
    (rec,) = profiling.records()
    assert _names(rec) == ["root", "mid", "leaf", "leaf"]
    mid, leaf2 = rec["children"]
    (leaf1,) = mid["children"]
    assert [r["parent"] for r in (rec, mid, leaf1, leaf2)] == [
        None, "root", "mid", "root"]
    assert {r["root"] for r in profiling.walk(rec)} == {"root"}
    for r in profiling.walk(rec):
        assert rec["start_ns"] <= r["start_ns"] <= r["end_ns"]
        assert r["end_ns"] <= rec["end_ns"]
        assert r["device_ms"] is None          # no card here
    assert "counters" in rec and "counters" not in mid


def test_ring_keeps_the_last_roots():
    with profiling.tracing():
        for i in range(profiling.RING + 44):
            with profiling.span(f"r{i}"):
                pass
    got = [r["name"] for r in profiling.records()]
    assert len(got) == profiling.RING
    assert got[0] == "r44" and got[-1] == f"r{profiling.RING + 43}"
    profiling.clear_records()
    assert profiling.records() == []


@pytest.mark.parametrize("adopt", [True, False])
def test_span_on_another_thread_is_adopted(adopt):
    """A span opened on a thread with nothing open there is a child of the
    open adopting span (as autograd's device thread runs the pool's
    backward inside train.backward), else a root of its own. A name keeps
    the adopt it was first given."""
    def worker():
        with profiling.span("pool_rois.backward"):
            pass

    outer = "train.backward" if adopt else "train.loss"
    with profiling.tracing():
        with profiling.span(outer, adopt=adopt):
            t = threading.Thread(target=worker)
            t.start()
            t.join()
        worker()        # after the adopter closed: a root
    recs = profiling.records()
    if adopt:
        back, alone = recs
        (child,) = back["children"]
        assert child["parent"] == "train.backward"
        assert child["root"] == "train.backward"
        assert child["thread"] != back["thread"]
    else:
        first, back, alone = recs
        assert first["name"] == "pool_rois.backward"
        assert back["name"] == "train.loss" and back["children"] == []
    assert alone["name"] == "pool_rois.backward" and alone["parent"] is None
    with pytest.raises(ValueError, match="adopt"):
        profiling.span(outer, adopt=not adopt)


def _trace_spans(tmp_path, fn) -> list:
    """(name, start, end) of every span range in the Chrome trace of
    fn() under torch.profiler on the CPU."""
    from torch.profiler import ProfilerActivity

    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.tracing_on()
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"][len("span:"):], float(e["ts"]),
             float(e["ts"]) + float(e["dur"])) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"].startswith("span:")]


@pytest.mark.parametrize("kind", ["serve", "train", "serve_resnet",
                                  "train_resnet"])
def test_profiler_trace_holds_the_layer_spans(kind, tmp_path, tiny_detector,
                                              tiny_trainer,
                                              tiny_resnet_detector,
                                              tiny_resnet_trainer):
    """The spans of the layer boundaries, by name, in the exported trace;
    none inside features, pool_rois, predict_rois or multiclass_nms
    under another name (a child there would take device time from the
    span the benchmark's rooflines read), but for a ResNet trunk's stage
    spans inside features, which the ResNet trunk's roofline reads with
    it; the records agree. A ResNet training step also holds its
    training stages' backward spans, once each, under train.backward;
    serving opens no backward span of the trunk."""
    stages = set()
    if kind == "serve":
        det = tiny_detector
        spans = _trace_spans(tmp_path, lambda: det(*_serve_inputs(det.cfg)))
        want, root = SERVE_SPANS, "detect"
    elif kind == "serve_resnet":
        det = tiny_resnet_detector
        spans = _trace_spans(tmp_path, lambda: det(*_serve_inputs(det.cfg)))
        stages = RESNET_SPANS
        want, root = SERVE_SPANS | stages, "detect"
    elif kind == "train_resnet":
        spans = _trace_spans(tmp_path, tiny_resnet_trainer.step)
        stages = RESNET_SPANS
        want = TRAIN_SPANS | stages | RESNET_BACKWARD_SPANS
        root = "train.step"
    else:
        spans = _trace_spans(tmp_path, tiny_trainer.step)
        want, root = TRAIN_SPANS, "train.step"
    assert {n for n, _, _ in spans} == want
    for name, a, b in spans:
        if name in LAYER_SPANS:
            inside = [n for n, a2, b2 in spans
                      if a <= a2 and b2 <= b and n != name]
            if name == "features":
                assert sorted(inside) == sorted(stages), inside
            else:
                assert not inside, f"{inside} inside {name}"
    (rec,) = profiling.records()
    assert rec["name"] == root and set(_names(rec)) == want
    if kind.startswith("train"):
        back = [r for r in profiling.walk(rec)
                if r["name"] == "pool_rois.backward"]
        assert back and all(r["parent"] == "train.backward" for r in back)
    trunk_back = [r for r in profiling.walk(rec)
                  if r["name"] in RESNET_BACKWARD_SPANS]
    assert sorted(r["name"] for r in trunk_back) == sorted(
        RESNET_BACKWARD_SPANS if kind == "train_resnet" else ())
    assert all(r["parent"] == "train.backward" for r in trunk_back)


# ---------------------------------------------------------- counters ---

def _chain(n: int):
    """n boxes in descending score order, each overlapping the next with
    IoU 7/13 and the one after with 4/16."""
    x = torch.arange(n, dtype=torch.float32) * 3.0
    boxes = torch.stack([x, torch.zeros(n), x + 10.0,
                         torch.full((n,), 10.0)], -1)
    return boxes, torch.linspace(1.0, 0.5, n)


def _fixpoint_rounds(n: int):
    """The fixpoint on the chain in plain Python: keep_i = not exists
    j < i kept with iou(j, i) > 0.5, only neighbours overlapping; ->
    (rounds, the last one that changes nothing included; keep)."""
    keep = [True] * n
    rounds = 0
    while True:
        rounds += 1
        new = [i == 0 or not keep[i - 1] for i in range(n)]
        if new == keep:
            return rounds, keep
        keep = new


@pytest.mark.parametrize("n", [1, 2, 5, 12])
def test_nms_rounds_count_the_fixpoint(n):
    boxes, scores = _chain(n)
    want_rounds, want_keep = _fixpoint_rounds(n)
    assert want_rounds >= n - 1 or n <= 2
    before = profiling.counters()
    keep = nms_ops.nms_sorted(boxes, scores, 0.5)
    after = profiling.counters()
    assert keep.tolist() == want_keep
    assert want_keep == [i % 2 == 0 for i in range(n)]   # greedy's answer
    assert after["nms.rounds"] - before.get("nms.rounds", 0) == want_rounds
    # no sync is counted off the card
    assert {k: v for k, v in after.items() if k.startswith("sync.")} == {
        k: v for k, v in before.items() if k.startswith("sync.")}


def _delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_h2d_bytes_are_the_inputs_bytes(kind, tiny_detector, tiny_trainer):
    if kind == "serve":
        inputs = _serve_inputs(tiny_detector.cfg, seed=3)
        before = profiling.counters()
        tiny_detector(*inputs)
    else:
        inputs = [x for x in tiny_trainer.batch if x is not None]
        before = profiling.counters()
        tiny_trainer.step()
    got = _delta(before, profiling.counters())
    assert got["h2d.bytes"] == sum(x.nbytes for x in inputs)
    if kind == "serve":
        assert got["d2h.bytes"] == sum(
            v.nbytes for v in tiny_detector(*inputs).values())


def test_host_to_device_counts_its_bytes():
    from multipathnet_tpu_torch.core.device import HostToDevice

    arrays = [np.ones((3, 5), np.float32), None, np.zeros(7, np.uint8)]
    before = profiling.counters().get("h2d.bytes", 0)
    out = HostToDevice("cpu")(arrays, [torch.float32, None, torch.int32])
    assert out[1] is None and out[2].dtype == torch.int32
    assert profiling.counters()["h2d.bytes"] - before == 3 * 5 * 4 + 7 * 4


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_root_record_holds_its_counter_deltas(kind, tiny_detector,
                                              tiny_trainer):
    before = profiling.counters()
    with profiling.tracing():
        if kind == "serve":
            tiny_detector(*_serve_inputs(tiny_detector.cfg, seed=5))
        else:
            tiny_trainer.step()
    want = _delta(before, profiling.counters())
    (rec,) = profiling.records()
    assert rec["counters"] == want
    assert want["h2d.bytes"] > 0
    assert (want.get("nms.rounds", 0) > 0) == (kind == "serve")


def test_pool_backward_checks_its_windows_before_its_span(monkeypatch,
                                                          tiny_trainer):
    """WindowPoolMulti's backward reads every level's windows in one check
    before its span opens, so the span's device interval holds no wait of
    the host; a window that leaves its image's rows raises there."""
    seen = []
    check = roi_pool._check_windows

    def spy(*buffers):
        seen.append((time.perf_counter_ns(), len(buffers)))
        return check(*buffers)

    monkeypatch.setattr(roi_pool, "_check_windows", spy)
    with profiling.tracing():
        tiny_trainer.step()
    (rec,) = profiling.records()
    back = [r for r in profiling.walk(rec)
            if r["name"] == "pool_rois.backward"]
    assert back and len(seen) == len(back)
    for at, n in seen:
        assert n >= 1
        assert not any(r["start_ns"] <= at <= r["end_ns"] for r in back)

    g, rows = 7, 12
    flat = torch.zeros(2 * rows, roi_pool.WINDOW_X, 4, requires_grad=True)
    row0 = torch.tensor([5, rows + 2], dtype=torch.int32)  # 5 + 10 > 12
    x0 = torch.zeros(2, dtype=torch.int32)
    wy = torch.full((2, g, roi_pool.WINDOW), 0.1)
    wx = torch.full((2, g, roi_pool.WINDOW_X), 0.1)
    out = roi_pool.WindowPoolMulti.apply(([row0], [x0], [wy], [wx]),
                                         (rows,), 2, flat)
    with pytest.raises(ValueError, match="falls outside"):
        out.sum().backward()


KERNELS = {"window_pool_multi", "window_pool_multi_quant", "resident_pool",
           "resident_pool_quant", "window_pool", "window_grad",
           "window_rmw_grad", "placements", "int8_epilogue", "quantize_rows",
           "bn_epilogue", "bn_epilogue_backward", "conv1x1_bn",
           "window_read_probe"}


@pytest.fixture
def own_counters(monkeypatch):
    """The counters as they stand, in a registry of the test's own, so
    what the test counts leaves the process's registry as it was."""
    monkeypatch.setattr(profiling, "_counts",
                        collections.defaultdict(int, profiling._counts))


def test_a_launch_is_a_counter_and_no_attribute(own_counters):
    """Every kernel's launch counter is listed at 0 from import on, and
    kernel_launches() reads them by kernel, less an earlier snapshot; no
    wrapper or module keeps a count of its own."""
    from multipathnet_tpu_torch.ops import batchnorm, conv_bn, quant
    from multipathnet_tpu_torch.tools import probe_int8_window_dma as probe

    assert set(profiling.kernel_launches()) == KERNELS
    before = profiling.counters()
    profiling.count("launches.window_grad", 5)
    profiling.count("launches.placements", 2)
    got = profiling.kernel_launches(before)
    assert set(got) == KERNELS
    assert {k: v for k, v in got.items() if v} == {"window_grad": 5,
                                                   "placements": 2}
    assert profiling.counters()["launches.window_grad"] == before[
        "launches.window_grad"] + 5
    for fn in (roi_pool.window_pool_multi, roi_pool.resident_pool,
               roi_pool.window_pool, roi_pool.window_grad,
               roi_pool.window_rmw_grad, roi_pool.place_windows_per_image,
               quant.int8_epilogue, quant.quantize_rows_padded,
               batchnorm.bn_epilogue, batchnorm.bn_epilogue_backward,
               conv_bn.conv1x1_bn,
               probe.window_read_probe):
        assert vars(fn) == {}, fn.__name__
    for mod in (roi_pool, quant, batchnorm, conv_bn, probe):
        assert not [k for k in vars(mod) if "count" in k], mod.__name__
    assert {k for k in vars(profiling) if "count" in k or "source" in k} == {
        "_counts", "count", "count_sync", "counters"}


@pytest.mark.parametrize("kind", ["serve", "serve_int8", "train"])
def test_tracing_records_the_span_tree_without_the_profiler(
        kind, monkeypatch, own_counters, tiny_detector, tiny_int8_detector,
        tiny_trainer):
    """Under tracing() alone (no torch.profiler session) a Detector call,
    with the float or the int8 head, and a Trainer.step each leave one
    root record: the layer spans' tree, each child's host interval inside
    its parent's, and on the root the launches.* changes over it."""
    if kind == "train":
        call, want, root = tiny_trainer.step, TRAIN_SPANS, "train.step"
    else:
        det = tiny_int8_detector if kind == "serve_int8" else tiny_detector
        call, want, root = (lambda: det(*_serve_inputs(det.cfg)),
                            SERVE_SPANS, "detect")

    # stand-ins for the card's launch sites: on the CPU a wrapper runs its
    # plain version and counts nothing, so each counts here as on the card
    def launching(fn, name):
        def launch(*args, **kwargs):
            profiling.count("launches." + name)
            return fn(*args, **kwargs)
        return launch

    for name in ("window_pool_multi", "resident_pool"):
        monkeypatch.setattr(roi_pool, name,
                            launching(getattr(roi_pool, name), name))
    before = profiling.counters()
    with profiling.tracing():
        assert not torch.autograd._profiler_enabled()
        call()
    launched = {k: v for k, v in profiling.kernel_launches(before).items() if v}
    (rec,) = profiling.records()
    assert rec["name"] == root and set(_names(rec)) == want
    for parent in profiling.walk(rec):
        assert parent["device_ms"] is None            # no card here
        for child in parent["children"]:
            assert child["parent"] == parent["name"]
            assert (parent["start_ns"] <= child["start_ns"]
                    <= child["end_ns"] <= parent["end_ns"])
    assert launched and {
        k.removeprefix("launches."): v for k, v in rec["counters"].items()
        if k.startswith("launches.")} == launched


# ------------------------------------------------------------- the card ---

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _serve_cell(device):
    """serve_int8svd_p1000's shapes: the int8+SVD preset, 8 images at 640,
    1000 proposals each, score threshold 0 (every class's top 100 reaches
    NMS); bench.py's draw and batch."""
    from multipathnet_tpu_torch.bench import build_preset, make_inputs

    args = types.SimpleNamespace(backbone=None, proposals=1000, canvas=640,
                                 batch=8)
    det, _ = build_preset("multipath_vgg16_int8_svd", args, device)
    det.cfg = det.cfg.replace(eval=dataclasses.replace(
        det.cfg.eval, score_threshold=0.0))
    inputs = make_inputs(args)
    return lambda: det(*inputs)


def _train_cell(device):
    """train_vgg16_b8's shapes: the training preset, 8 images at 640,
    1000 proposals and 3 boxes an image, 64 sampled ROIs each."""
    cfg = preset("multipath_vgg16_train")
    trainer = tloop.Trainer(cfg, device=device)
    box = [trainer.init_state(0)]
    batch = _train_batch(cfg, b=cfg.train.batch_size)

    def step():
        box[0], _ = trainer.step(box[0], batch)
    return step


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["serve", "train"])
def test_counted_syncs_are_every_sync(cuda, kind):
    """Under torch.cuda.set_sync_debug_mode("warn") the synchronizing
    calls of one call (after a warm-up call) are exactly the counted
    sync.* sites; the root record holds the same counts, and in training
    the pool's backward, run on autograd's device thread, is a child of
    train.backward."""
    call = _serve_cell(cuda) if kind == "serve" else _train_cell(cuda)
    call()
    torch.cuda.synchronize()
    before = profiling.counters()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with profiling.tracing():
                call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in seen
             if "synchronizing CUDA operation" in str(w.message)]
    counted = {k: v for k, v in _delta(before, profiling.counters()).items()
               if k.startswith("sync.")}
    where = {}
    for w in syncs:
        key = f"{w.filename.rsplit('/', 2)[-1]}:{w.lineno}"
        where[key] = where.get(key, 0) + 1
    assert len(syncs) == sum(counted.values()), (
        f"{len(syncs)} syncs reported at {where}; counted {counted}")
    (rec,) = profiling.records()
    assert {k: v for k, v in rec["counters"].items()
            if k.startswith("sync.")} == counted
    assert all(r["device_ms"] is not None and r["device_ms"] >= 0
               for r in profiling.walk(rec))
    if kind == "train":
        back = [r for r in profiling.walk(rec)
                if r["name"] == "pool_rois.backward"]
        assert back and all(r["parent"] == "train.backward" for r in back)
        assert all(r["thread"] != rec["thread"] for r in back)
