"""Port parity, evaluation: the COCO and VOC evaluators (the hand-built
cases of tests/test_coco_eval.py and tests/test_voc_eval.py, random
detections, segm mode), the COCO conversions, and the whole Tester at
`tiny` in float32 on one synthetic split.

The evaluators are float64 NumPy on both sides, so their metric dicts must
be equal exactly. The Tester runs the JAX side with roi_impl="pallas" (the
Pallas kernels in interpret mode on the CPU) and the port with its kernels'
plain versions, on one parameter tree carried across by models/convert.py:
valid masks and classes equal, boxes and scores within rtol 1e-5 / atol
1e-4 (float32 sums in other orders), AP/AR within 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multipathnet_tpu.core.config import preset as jpreset
from multipathnet_tpu.data import coco as jcoco
from multipathnet_tpu.data import proposals as jprop
from multipathnet_tpu.data import rle as jrle
from multipathnet_tpu.data import synthetic as jsyn
from multipathnet_tpu.data import voc as jvoc
from multipathnet_tpu.eval import coco_eval as jeval
from multipathnet_tpu.eval import tester as jtester
from multipathnet_tpu.eval import voc_eval as jvoc_eval
from multipathnet_tpu.models.multipath import build_model as jbuild
from multipathnet_tpu_torch.core.config import preset
from multipathnet_tpu_torch.data.coco import CocoLoader
from multipathnet_tpu_torch.data.pipeline import DetectionPipeline
from multipathnet_tpu_torch.data.proposals import ProposalStore
from multipathnet_tpu_torch.eval import coco_eval as teval
from multipathnet_tpu_torch.eval import tester as ttester
from multipathnet_tpu_torch.eval import voc_eval as tvoc_eval
from multipathnet_tpu_torch.models import convert
from multipathnet_tpu_torch.models.multipath import build_model
from multipathnet_tpu_torch.train.loop import Trainer

torch.set_num_threads(2)


def gt(img, cat, bbox, **kw):
    return {"image_id": img, "category_id": cat, "bbox": list(bbox), **kw}


def det(img, cat, bbox, score):
    return {"image_id": img, "category_id": cat, "bbox": list(bbox),
            "score": score}


# tests/test_coco_eval.py's hand-built cases, by name: (gts, dets)
COCO_CASES = {
    "perfect": ([gt(1, 1, [0, 0, 10, 10]), gt(1, 1, [50, 50, 20, 20])],
                [det(1, 1, [0, 0, 10, 10], 0.9),
                 det(1, 1, [50, 50, 20, 20], 0.8)]),
    "high_fp": ([gt(1, 1, [0, 0, 10, 10])],
                [det(1, 1, [200, 200, 10, 10], 0.9),
                 det(1, 1, [0, 0, 10, 10], 0.8)]),
    "low_fp": ([gt(1, 1, [0, 0, 10, 10])],
               [det(1, 1, [0, 0, 10, 10], 0.9),
                det(1, 1, [200, 200, 10, 10], 0.1)]),
    "iou_060": ([gt(1, 1, [0, 0, 10, 10])], [det(1, 1, [0, 0, 10, 6], 0.9)]),
    "missed_gt": ([gt(1, 1, [0, 0, 10, 10]), gt(1, 1, [100, 100, 10, 10])],
                  [det(1, 1, [0, 0, 10, 10], 0.9)]),
    "crowd": ([gt(1, 1, [0, 0, 10, 10]),
               gt(1, 1, [100, 100, 50, 50], iscrowd=1)],
              [det(1, 1, [0, 0, 10, 10], 0.9),
               det(1, 1, [100, 100, 25, 50], 0.8),
               det(1, 1, [110, 100, 40, 50], 0.7)]),
    "cat_without_gt": ([gt(1, 1, [0, 0, 10, 10])],
                       [det(1, 1, [0, 0, 10, 10], 0.9),
                        det(1, 2, [0, 0, 10, 10], 0.9)]),
    "two_cats": ([gt(1, 1, [0, 0, 10, 10]), gt(1, 2, [50, 50, 10, 10])],
                 [det(1, 1, [0, 0, 10, 10], 0.9),
                  det(1, 2, [200, 200, 10, 10], 0.9)]),
    "areas": ([gt(1, 1, [0, 0, 10, 10]), gt(1, 1, [50, 50, 100, 100])],
              [det(1, 1, [0, 0, 10, 10], 0.9),
               det(1, 1, [50, 50, 100, 100], 0.8)]),
    "maxdets": ([gt(1, 1, [0, 0, 10, 10]), gt(1, 1, [100, 100, 10, 10])],
                [det(1, 1, [0, 0, 10, 10], 0.9),
                 det(1, 1, [100, 100, 10, 10], 0.8)]),
    "duplicate": ([gt(1, 1, [0, 0, 10, 10]), gt(2, 1, [0, 0, 10, 10])],
                  [det(1, 1, [0, 0, 10, 10], 0.9),
                   det(1, 1, [0, 0, 10, 10], 0.85),
                   det(2, 1, [0, 0, 10, 10], 0.8)]),
}

# tests/test_voc_eval.py's hand-built cases
VOC_CASES = {
    "perfect": ([gt(1, 1, [0, 0, 10, 10]), gt(2, 1, [5, 5, 10, 10])],
                [det(1, 1, [0, 0, 10, 10], 0.9),
                 det(2, 1, [5, 5, 10, 10], 0.8)]),
    "high_fp": ([gt(1, 1, [0, 0, 10, 10])],
                [det(1, 1, [100, 100, 5, 5], 0.95),
                 det(1, 1, [0, 0, 10, 10], 0.9)]),
    "duplicate": ([gt(1, 1, [0, 0, 10, 10])],
                  [det(1, 1, [0, 0, 10, 10], 0.9),
                   det(1, 1, [1, 0, 10, 10], 0.8)]),
    "difficult": ([gt(1, 1, [0, 0, 10, 10]),
                   gt(1, 1, [50, 50, 10, 10], difficult=True)],
                  [det(1, 1, [0, 0, 10, 10], 0.9),
                   det(1, 1, [50, 50, 10, 10], 0.8)]),
    "missed_gt": ([gt(1, 1, [0, 0, 10, 10]), gt(1, 1, [50, 50, 10, 10])],
                  [det(1, 1, [0, 0, 10, 10], 0.9)]),
    "multiclass": ([gt(1, 1, [0, 0, 10, 10]), gt(1, 2, [50, 50, 10, 10])],
                   [det(1, 1, [0, 0, 10, 10], 0.9),
                    det(1, 2, [200, 200, 10, 10], 0.9)]),
}


def _random_case(seed, n_img=6, n_cat=3):
    """GT of every area range (crowds and VOC-difficult flags included) and
    detections jittered around it plus clutter, with tied scores."""
    rng = np.random.default_rng(seed)
    gts, dts = [], []
    for img in range(n_img):
        for _ in range(rng.integers(0, 6)):
            xy = rng.uniform(0, 300, 2)
            wh = np.exp(rng.uniform(np.log(4), np.log(200), 2))
            c = int(rng.integers(1, n_cat + 1))
            gts.append(gt(img, c, [*xy, *wh], iscrowd=int(rng.uniform() < .1),
                          difficult=bool(rng.uniform() < .1)))
            for _ in range(rng.integers(0, 3)):
                j = wh * rng.normal(0, 0.15, 2)
                dts.append(det(img, c, [*(xy + j), *(wh * np.exp(
                    rng.normal(0, 0.1, 2)))], float(rng.integers(0, 20)) / 20))
        for _ in range(rng.integers(0, 8)):
            dts.append(det(img, int(rng.integers(1, n_cat + 1)),
                           [*rng.uniform(0, 300, 2), *rng.uniform(2, 150, 2)],
                           float(rng.uniform())))
    return gts, dts


@pytest.mark.parametrize("case", [*COCO_CASES, "random0", "random1",
                                  "random2"])
def test_coco_evaluator_matches_reference(case):
    gts, dts = (COCO_CASES[case] if case in COCO_CASES
                else _random_case(int(case[-1])))
    got = teval.CocoEvaluator().evaluate(gts, dts)
    want = jeval.CocoEvaluator().evaluate(gts, dts)
    assert got == want
    assert teval.evaluate_detections(gts, dts) == want


def test_coco_evaluator_known_values():
    """Two of the hand-built cases' analytic APs, on the port alone."""
    ev = teval.CocoEvaluator()
    assert abs(ev.evaluate(*COCO_CASES["iou_060"])["AP"] - 0.3) < 1e-9
    want = (51 * 1.0 + 50 * (2 / 3)) / 101
    assert abs(ev.evaluate(*COCO_CASES["duplicate"])["AP"] - want) < 1e-9


def test_box_iou_matches_reference():
    rng = np.random.default_rng(0)
    d = rng.uniform(0, 50, (7, 4))
    g = rng.uniform(0, 50, (5, 4))
    crowd = np.array([0, 1, 0, 0, 1], bool)
    np.testing.assert_array_equal(teval.box_iou_xywh(d, g, crowd),
                                  jeval.box_iou_xywh(d, g, crowd))
    assert teval.box_iou_xywh(d[:0], g, crowd).shape == (0, 5)


@pytest.mark.parametrize("case", [*VOC_CASES, "random0", "random1"])
@pytest.mark.parametrize("use_07", [False, True], ids=["voc10", "voc07"])
def test_voc_evaluator_matches_reference(case, use_07):
    gts, dts = (VOC_CASES[case] if case in VOC_CASES
                else _random_case(int(case[-1])))
    got = tvoc_eval.evaluate_voc(gts, dts, use_07_metric=use_07)
    want = jvoc_eval.evaluate_voc(gts, dts, use_07_metric=use_07)
    np.testing.assert_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_segm_evaluator_matches_reference(seed):
    """mode="segm": mask IoU on RLE masks, crowd GT included."""
    rng = np.random.default_rng(seed)
    h, w = 40, 48

    def mask(x, y, bw, bh):
        m = np.zeros((h, w), np.uint8)
        m[y:y + bh, x:x + bw] = rng.uniform(size=(min(bh, h - y),
                                                  min(bw, w - x))) < 0.9
        return jrle.encode(m)

    gts, dts = [], []
    for img in range(3):
        for k in range(3):
            x, y = rng.integers(0, 30, 2)
            bw, bh = rng.integers(4, 18, 2)
            g = gt(img, 1 + k % 2, [x, y, bw, bh], iscrowd=int(k == 2),
                   area=float(bw * bh))
            g["segmentation"] = mask(x, y, bw, bh)
            gts.append(g)
            for s in rng.uniform(size=2):
                d = det(img, 1 + k % 2, [x, y, bw, bh], float(s))
                d["segmentation"] = mask(x + int(rng.integers(0, 3)), y, bw,
                                         bh)
                dts.append(d)
    got = teval.CocoEvaluator(mode="segm").evaluate(gts, dts)
    assert got == jeval.CocoEvaluator(mode="segm").evaluate(gts, dts)
    assert got["AP"] > 0


def test_detections_to_coco_matches_reference():
    rng = np.random.default_rng(0)
    b, d = 3, 6
    x1 = rng.uniform(0, 40, (b, d, 2))
    out = {"boxes": np.concatenate([x1, x1 + rng.uniform(1, 20, (b, d, 2))],
                                   -1).astype(np.float32),
           "scores": rng.uniform(size=(b, d)).astype(np.float32),
           "classes": rng.integers(1, 4, (b, d)).astype(np.int32),
           "indices": rng.integers(-1, 5, (b, d)).astype(np.int32),
           "valid": rng.uniform(size=(b, d)) < 0.7}
    label_to_cat = {1: 3, 2: 9, 3: 11}
    rles = [[jrle.encode(rng.uniform(size=(8, 8)) < 0.5) for _ in range(5)]
            for _ in range(b)]
    for kw in ({}, {"rles_per_image": rles}):
        got = ttester.detections_to_coco(out, [7, 8, 9], label_to_cat, **kw)
        assert got == jtester.detections_to_coco(out, [7, 8, 9],
                                                 label_to_cat, **kw)
        assert got


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_splits")
    kw = dict(num_images=5, image_size=48, num_classes=3,
              proposals_per_image=12, seed=2)
    return (jsyn.generate(str(root / "coco"), **kw),
            jsyn.generate_voc(str(root / "voc"), difficult_frac=0.3, **kw))


@pytest.mark.parametrize("segm", [False, True], ids=["bbox", "segm"])
def test_groundtruth_to_coco_matches_reference(splits, segm):
    coco_fx, voc_fx = splits
    loaders = [(CocoLoader(coco_fx["annotations"], coco_fx["images"]),
                jcoco.CocoLoader(coco_fx["annotations"], coco_fx["images"]))]
    if not segm:       # VOC GT has no masks; its difficult flags pass
        from multipathnet_tpu_torch.data.voc import VocLoader

        loaders.append((VocLoader(voc_fx["devkit"]),
                        jvoc.VocLoader(voc_fx["devkit"])))
    for tl, jl in loaders:
        got = ttester.groundtruth_to_coco(tl, segm=segm)
        assert got == jtester.groundtruth_to_coco(jl, segm=segm)
        assert got


# ------------------------------------------------------- the whole Tester ---

def _tiny(make_preset):
    cfg = make_preset("tiny")
    return cfg.replace(model=dataclasses.replace(
        cfg.model, dtype="float32", roi_impl="pallas", num_classes=5))


@pytest.fixture(scope="module")
def tester_pair(tmp_path_factory):
    """The JAX Tester and the port's on one split and one parameter tree:
    the port's Trainer fits the split for 20 epochs (so AP is far from 0),
    and models/convert.py carries its weights to the JAX side."""
    fx = jsyn.generate(str(tmp_path_factory.mktemp("tester")), num_images=6,
                       image_size=64, num_classes=4, proposals_per_image=24,
                       seed=11)
    tcfg = _tiny(preset)
    tl = CocoLoader(fx["annotations"], fx["images"])
    props = ProposalStore.load(fx["proposals"])
    trainer = Trainer(tcfg, device="cpu")
    state = trainer.init_state()
    pipe = DetectionPipeline(tl, props, tcfg.data, batch_size=2)
    for ep in range(20):
        for batch in pipe.epoch(ep):
            state, _ = trainer.step(state, batch)
    params = convert.flax_from_state_dict(trainer.model.state_dict())
    jcfg = _tiny(jpreset)
    jt = jtester.Tester(jbuild(jcfg.model), params, jcfg,
                        jcoco.CocoLoader(fx["annotations"], fx["images"]),
                        jprop.ProposalStore.load(fx["proposals"]),
                        batch_size=4)
    tt = ttester.Tester(build_model(tcfg.model, device="cpu"), tcfg, tl,
                        props, params=params, device="cpu", batch_size=4)
    return jt, tt


def test_tester_detections_match_reference(tester_pair):
    """Per eval batch (the last padded by repetition): the detector's
    fixed-size outputs."""
    jt, tt = tester_pair
    n_valid = 0
    for (ji, jb), (ti, tb) in zip(jt.pipeline.eval_batches(),
                                  tt.pipeline.eval_batches()):
        assert ji == ti
        want = jt.detector(jb.images, jb.src_hws, jb.proposals, jb.prop_mask)
        got = tt.detector(*tb[:4])
        for key in ("valid", "classes"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        valid = want["valid"]
        for key in ("boxes", "scores"):
            np.testing.assert_allclose(got[key][valid], want[key][valid],
                                       rtol=1e-5, atol=1e-4, err_msg=key)
        n_valid += int(valid.sum())
    assert n_valid > 0


@pytest.mark.parametrize("max_images", [None, 3])
def test_tester_metrics_match_reference(tester_pair, max_images):
    """Tester.test: the COCO metric dict within 1e-6 (the differences are
    printed); with max_images the split is cut as the reference cuts it."""
    jt, tt = tester_pair
    want = jt.test(max_images=max_images)
    got = tt.test(max_images=max_images)
    assert set(got) == set(want)
    diff = {k: abs(got[k] - want[k]) for k in want}
    print("AP/AR |port - reference|:", diff)
    assert max(diff.values()) <= 1e-6, diff
    assert want["AP50"] > 0.1


def test_tester_voc_protocol_matches_reference(tester_pair, splits):
    """A VocLoader routes Tester.test to the VOC mAP."""
    from multipathnet_tpu_torch.data.voc import VocLoader

    jt, tt = tester_pair
    _, voc_fx = splits
    props = voc_fx["proposals"]
    jtv = jtester.Tester(jt.detector.model, jt.detector.params, jt.cfg,
                         jvoc.VocLoader(voc_fx["devkit"]),
                         jprop.ProposalStore.load(props), batch_size=4)
    ttv = ttester.Tester(tt.detector.model, tt.cfg, VocLoader(voc_fx["devkit"]),
                         ProposalStore.load(props), device="cpu",
                         batch_size=4)
    want, got = jtv.test(), ttv.test()
    assert set(got) == set(want) and "mAP" in got
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6 or (np.isnan(got[k])
                                                 and np.isnan(want[k])), k


def test_tester_segm_mode_matches_reference(tester_pair):
    """mode="segm": each detection carries its source proposal's mask (the
    NMS provenance indices) into the mask-IoU protocol; the proposals here
    are the split's boxes as mask proposals."""
    jt, tt = tester_pair
    per_rles, per_scores, ids = [], [], []
    for i in range(len(tt.loader)):
        img = tt.loader.image_id(i)
        boxes, scores = tt.proposals.for_image_id(img)
        h, w = tt.loader.image_size(i)
        rles = []
        for x1, y1, x2, y2 in boxes:
            m = np.zeros((h, w), np.uint8)
            m[int(y1):int(np.ceil(y2)), int(x1):int(np.ceil(x2))] = 1
            rles.append(jrle.encode(m))
        per_rles.append(rles)
        per_scores.append(scores)
        ids.append(img)
    jtm = jtester.Tester(
        jt.detector.model, jt.detector.params, jt.cfg, jt.loader,
        jprop.ProposalStore.from_mask_proposals(per_rles, per_scores, ids),
        batch_size=4)
    ttm = ttester.Tester(
        tt.detector.model, tt.cfg, tt.loader,
        ProposalStore.from_mask_proposals(per_rles, per_scores, ids),
        device="cpu", batch_size=4)
    want, got = jtm.test(mode="segm"), ttm.test(mode="segm")
    diff = {k: abs(got[k] - want[k]) for k in want}
    print("segm AP/AR |port - reference|:", diff)
    assert set(got) == set(want) and max(diff.values()) <= 1e-6, diff
    assert want["AP50"] > 0.1


def test_tester_takes_device_prefetched_batches(tester_pair):
    """collect_detections (each batch's conversion after the next one's
    detection, the reference's order) equals a serial loop of detector
    calls on eval_batches."""
    _, tt = tester_pair
    want = []
    for idxs, b in tt.pipeline.eval_batches():
        out = tt.detector(*b[:4])
        want += ttester.detections_to_coco(
            {k: v[:len(idxs)] for k, v in out.items()},
            [tt.loader.image_id(i) for i in idxs], tt.loader.label_to_cat)
    assert tt.collect_detections() == want and want


def test_overfit_synthetic_reaches_high_ap(tmp_path):
    """The reference's golden check (tests/test_e2e.py on its overfit_tiny
    fixture) on the port alone: 8 synthetic images, `tiny` with 5 classes,
    batch 2, 30 epochs through epoch_on_device, held over the first five
    init seeds. One seed's outcome spreads widely at this size, for the
    reference as for the port (tests/overfit_seeds.py, bf16): the
    reference trained through its Pallas route from the port's weights and
    on the port's own draws (flips, ROI samples, dropout masks) ends under
    0.5 in 2 of seeds 0-9 as the port does (0.2829 and 0.3773 against the
    port's 0.0185 and 0.4665); in float32 the two runs from seed 1 end at
    AP50 0.5280 and 0.5220, no parameter 0.0021 apart (test_torch_train.py
    holds the first 8 steps of that lockstep). So the bar holds for the
    median run: AP50 > 0.5, a rise of more than 0.3, the last loss under
    0.75 x the first; every loss finite."""
    fx = jsyn.generate(str(tmp_path), num_images=8, image_size=64,
                       num_classes=4, proposals_per_image=24, seed=5)
    cfg = preset("tiny")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, num_classes=5))
    loader = CocoLoader(fx["annotations"], fx["images"])
    props = ProposalStore.load(fx["proposals"])
    trainer = Trainer(cfg, device="cpu")
    pipe = DetectionPipeline(loader, props, cfg.data, batch_size=2, seed=0)
    runs = []
    for seed in range(5):
        state = trainer.init_state(seed)
        before = ttester.Tester(trainer.model, cfg, loader, props,
                                device="cpu", batch_size=2).test()
        losses = []
        for ep in range(30):
            for batch in pipe.epoch_on_device(ep, trainer.stream_batch):
                state, m = trainer.step(state, batch)
                losses.append(float(m["loss"]))
        after = ttester.Tester(trainer.model, cfg, loader, props,
                               device="cpu", batch_size=2).test()
        assert np.all(np.isfinite(losses)), seed
        runs.append((after["AP50"], after["AP50"] - before["AP50"],
                     losses[-1] / losses[0]))
    print("per seed (AP50 after, rise, last/first loss):", runs)
    ap50, rise, ratio = np.median(np.asarray(runs), axis=0)
    assert ap50 > 0.5, runs
    assert rise > 0.3, runs
    assert ratio < 0.75, runs
