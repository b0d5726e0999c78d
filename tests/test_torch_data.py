"""Port parity, the data layer: padding, the RLE codec, ProposalStore, the
synthetic generator, the COCO/VOC loaders and DetectionPipeline against
the JAX package's host modules, on files written from seeds into temp
dirs. Everything here is exact: equal arrays, equal strings, equal files.
The reference's RLE codec may run its C++ build; its results are
byte-equal to its NumPy one (tests/test_rle_native.py), which is the
port's."""

import json
import os

import numpy as np
import pytest

from multipathnet_tpu.core import padding as jpad
from multipathnet_tpu.data import coco as jcoco
from multipathnet_tpu.data import pipeline as jpipe
from multipathnet_tpu.data import proposals as jprop
from multipathnet_tpu.data import rle as jrle
from multipathnet_tpu.data import synthetic as jsyn
from multipathnet_tpu.data import voc as jvoc
from multipathnet_tpu_torch.core import padding as tpad
from multipathnet_tpu_torch.core.config import preset
from multipathnet_tpu_torch.data import coco as tcoco
from multipathnet_tpu_torch.data import pipeline as tpipe
from multipathnet_tpu_torch.data import proposals as tprop
from multipathnet_tpu_torch.data import rle as trle
from multipathnet_tpu_torch.data import synthetic as tsyn
from multipathnet_tpu_torch.data import voc as tvoc

GEN = dict(num_images=6, image_size=48, num_classes=4, proposals_per_image=20,
           seed=3)


@pytest.fixture(scope="module")
def coco_pair(tmp_path_factory):
    """The same synthetic COCO split written by each package."""
    root = tmp_path_factory.mktemp("coco")
    return (jsyn.generate(str(root / "jax"), **GEN),
            tsyn.generate(str(root / "torch"), **GEN))


@pytest.fixture(scope="module")
def voc_pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    kw = dict(GEN, difficult_frac=0.3)
    return (jsyn.generate_voc(str(root / "jax"), **kw),
            tsyn.generate_voc(str(root / "torch"), **kw))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("size", [5, 7, 9])
@pytest.mark.parametrize("value", [0.0, -1.0])
def test_padding_matches_reference(size, value):
    x = np.random.default_rng(size).normal(size=(7, 3)).astype(np.float32)
    for axis in (0, 1):
        np.testing.assert_array_equal(tpad.pad_axis_to(x, size, axis, value),
                                      jpad.pad_axis_to(x, size, axis, value))
    for got, want in zip(tpad.pad_to(x, size, value),
                         jpad.pad_to(x, size, value)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_rle_matches_reference(seed):
    """encode/decode, area, bbox and IoU on random masks (empty, full and
    first-pixel-set included), the polygon rasterizer and paste_mask."""
    rng = np.random.default_rng(seed)
    h, w = rng.integers(5, 40, 2)
    masks = [rng.uniform(size=(h, w)) < p for p in (0.0, 0.05, 0.5, 1.0)]
    masks[2][0, 0] = True
    for m in masks:
        rle = trle.encode(m)
        assert rle == jrle.encode(m)
        assert trle.mask_to_counts(m) == jrle.mask_to_counts(m)
        np.testing.assert_array_equal(trle.decode(rle), jrle.decode(rle))
        np.testing.assert_array_equal(trle.decode(rle), m.astype(np.uint8))
        assert trle.area(rle) == jrle.area(rle)
        np.testing.assert_array_equal(trle.to_bbox(rle), jrle.to_bbox(rle))
        assert trle.decode_counts(rle["counts"]) == jrle.decode_counts(
            rle["counts"])
    rles = [trle.encode(m) for m in masks]
    crowd = [0, 1, 0, 1]
    np.testing.assert_array_equal(trle.iou(rles, rles[::-1], crowd),
                                  jrle.iou(rles, rles[::-1], crowd))
    polys = [list(rng.uniform(0, min(h, w), 2 * k)) for k in (3, 5, 8)]
    np.testing.assert_array_equal(trle.polys_to_mask(polys, h, w),
                                  jrle.polys_to_mask(polys, h, w))
    prob = rng.uniform(size=(3, 14, 14)).astype(np.float32)
    boxes = np.asarray([[-2.0, 1.5, 20.0, 30.0], [3.2, 4.1, 9.9, 8.3],
                        [5.0, 5.0, 5.0, 9.0]], np.float32)
    assert (trle.masks_to_rles(prob, boxes, h, w)
            == jrle.masks_to_rles(prob, boxes, h, w))


def test_proposal_files_read_across_packages(tmp_path):
    """Files written by either package read equal in the other, box-only
    and with mask proposals; the lookups agree."""
    rng = np.random.default_rng(0)
    ids = [1000, 1003, 1007]
    boxes = [rng.uniform(0, 50, (n, 4)).astype(np.float32) for n in (3, 0, 5)]
    scores = [rng.uniform(size=len(b)).astype(np.float32) for b in boxes]
    masks = [[rng.uniform(size=(12, 16)) < 0.3 for _ in b] for b in boxes]
    rles = [[jrle.encode(m) for m in ms] for ms in masks]
    made = {"jax": (jprop.ProposalStore.from_lists(boxes, scores, ids),
                    jprop.ProposalStore.from_mask_proposals(rles, scores,
                                                            ids)),
            "torch": (tprop.ProposalStore.from_lists(boxes, scores, ids),
                      tprop.ProposalStore.from_mask_proposals(rles, scores,
                                                              ids))}
    for writer, reader in (("jax", tprop.ProposalStore),
                           ("torch", jprop.ProposalStore)):
        for k, store in enumerate(made[writer]):
            path = str(tmp_path / f"{writer}{k}.npz")
            store.save(path)
            got = reader.load(path)
            want = made["torch" if writer == "jax" else "jax"][k]
            for field in ("boxes", "scores", "offsets", "image_ids"):
                np.testing.assert_array_equal(getattr(got, field),
                                              getattr(want, field))
            assert got.rles == want.rles
            assert len(got) == len(want) == 3
            for i, img in enumerate(ids):
                for a, b in zip(got.for_index(i), want.for_image_id(img)):
                    np.testing.assert_array_equal(a, b)
                assert got.rles_for_image_id(img) == want.rles_for_image_id(
                    img)


def test_synthetic_coco_files_match_reference(coco_pair):
    """One seed writes the same annotations JSON, the same proposals and
    the same images (decoded) from both packages."""
    jfx, tfx = coco_pair
    assert _files(jfx["root"]) == _files(tfx["root"])
    with open(jfx["annotations"]) as fj, open(tfx["annotations"]) as ft:
        assert json.load(fj) == json.load(ft)
    zj, zt = np.load(jfx["proposals"]), np.load(tfx["proposals"])
    assert zj.files == zt.files
    for k in zj.files:
        np.testing.assert_array_equal(zj[k], zt[k])
    jl = jcoco.CocoLoader(jfx["annotations"], jfx["images"])
    tl = tcoco.CocoLoader(tfx["annotations"], tfx["images"])
    for i in range(len(jl)):
        np.testing.assert_array_equal(tl.load_image(i), jl.load_image(i))


def test_synthetic_jpeg_matches_reference(tmp_path):
    kw = dict(GEN, num_images=2, image_format="jpeg")
    jfx = jsyn.generate(str(tmp_path / "jax"), **kw)
    tfx = tsyn.generate(str(tmp_path / "torch"), **kw)
    jl = jcoco.CocoLoader(jfx["annotations"], jfx["images"])
    tl = tcoco.CocoLoader(tfx["annotations"], tfx["images"])
    assert tl.image_path(0).endswith(".jpg")
    for i in range(2):
        np.testing.assert_array_equal(tl.load_image(i), jl.load_image(i))


def test_synthetic_voc_files_match_reference(voc_pair):
    jfx, tfx = voc_pair
    assert _files(jfx["root"]) == _files(tfx["root"])
    for rel in _files(jfx["root"]):
        if rel.endswith((".xml", ".txt")):
            with open(os.path.join(jfx["root"], rel)) as fj, \
                    open(os.path.join(tfx["root"], rel)) as ft:
                assert fj.read() == ft.read(), rel
    zj, zt = np.load(jfx["proposals"]), np.load(tfx["proposals"])
    for k in zj.files:
        np.testing.assert_array_equal(zj[k], zt[k])
    jl, tl = jvoc.VocLoader(jfx["devkit"]), tvoc.VocLoader(tfx["devkit"])
    for i in range(len(jl)):
        np.testing.assert_array_equal(tl.load_image(i), jl.load_image(i))


def _assert_loaders_equal(tl, jl):
    assert len(tl) == len(jl)
    for attr in ("num_classes", "category_ids", "category_names",
                 "cat_to_label", "label_to_cat"):
        assert getattr(tl, attr) == getattr(jl, attr), attr
    assert getattr(tl, "protocol", "coco") == getattr(jl, "protocol", "coco")
    for i in range(len(jl)):
        assert tl.image_id(i) == jl.image_id(i)
        assert tl.image_size(i) == jl.image_size(i)
        assert os.path.basename(tl.image_path(i)) == os.path.basename(
            jl.image_path(i))
        np.testing.assert_array_equal(tl.load_image(i), jl.load_image(i))
        ta, ja = tl.annotations(i), jl.annotations(i)
        assert set(ta) == set(ja)
        for k in ja:
            if isinstance(ja[k], np.ndarray):
                assert ta[k].dtype == ja[k].dtype, k
                np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
            else:
                assert ta[k] == ja[k], k


def test_coco_loaders_match_reference(coco_pair):
    """CocoLoader, NarrowLoader and ConcatLoader over one split, with a
    crowd annotation and sparse category ids, read equal."""
    jfx, _ = coco_pair
    with open(jfx["annotations"]) as f:
        js = json.load(f)
    for c in js["categories"]:
        c["id"] = 3 * c["id"] + 7                 # sparse ids, as COCO's
    for a in js["annotations"]:
        a["category_id"] = 3 * a["category_id"] + 7
    js["annotations"][1]["iscrowd"] = 1
    path = os.path.join(jfx["root"], "annotations", "sparse.json")
    with open(path, "w") as f:
        json.dump(js, f)
    jl = jcoco.CocoLoader(path, jfx["images"])
    tl = tcoco.CocoLoader(path, jfx["images"])
    _assert_loaders_equal(tl, jl)
    _assert_loaders_equal(tcoco.NarrowLoader(tl, 2, 3),
                          jcoco.NarrowLoader(jl, 2, 3))
    _assert_loaders_equal(
        tcoco.ConcatLoader([tl, tcoco.NarrowLoader(tl, 1, 2)]),
        jcoco.ConcatLoader([jl, jcoco.NarrowLoader(jl, 1, 2)]))


def test_make_split_matches_reference(tmp_path):
    """trainval35k = train2014 + the head of val2014, minival5k = its
    tail, at val_take/minival sized to a small fixture."""
    for split, n in (("train2014", 3), ("val2014", 5)):
        jsyn.generate(str(tmp_path), split=split, **dict(GEN, num_images=n))
    kw = dict(val_take=3, minival=2)
    for split in ("train2014", "trainval35k", "minival5k"):
        _assert_loaders_equal(tcoco.make_split(str(tmp_path), split, **kw),
                              jcoco.make_split(str(tmp_path), split, **kw))
    with pytest.raises(KeyError):
        tcoco.make_split(str(tmp_path), "nope")


def test_voc_loader_matches_reference(voc_pair):
    jfx, _ = voc_pair
    jl = jvoc.VocLoader(jfx["devkit"], split="test")
    tl = tvoc.VocLoader(jfx["devkit"], split="test")
    assert tl.protocol == "voc"
    _assert_loaders_equal(tl, jl)
    assert any(tl.annotations(i)["difficult"].any() for i in range(len(tl)))


def _pipelines(fx, batch_size, **kw):
    cfg = preset("tiny")
    jl = jcoco.CocoLoader(fx["annotations"], fx["images"])
    tl = tcoco.CocoLoader(fx["annotations"], fx["images"])
    return (tpipe.DetectionPipeline(
                tl, tprop.ProposalStore.load(fx["proposals"]), cfg.data,
                batch_size, **kw),
            jpipe.DetectionPipeline(
                jl, jprop.ProposalStore.load(fx["proposals"]), cfg.data,
                batch_size, **kw))


def _assert_batches_equal(got, want):
    assert type(got).__name__ == "Batch" and got._fields == want._fields
    for name, g, w in zip(want._fields, got, want):
        if w is None:
            assert g is None, name
            continue
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_pipeline_epochs_match_reference(coco_pair, num_workers):
    """epoch(0) and epoch(1) (shuffled from (seed, epoch)) give the
    reference's batches field for field, inline and with the decode
    pool."""
    jfx, _ = coco_pair
    tp, jp = _pipelines(jfx, 2, seed=4, num_workers=num_workers)
    assert len(tp) == len(jp) == 3
    for ep in (0, 1):
        got, want = list(tp.epoch(ep)), list(jp.epoch(ep))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            _assert_batches_equal(g, w)


def test_pipeline_eval_batches_and_masks_match_reference(coco_pair):
    """eval_batches at batch 4 over 6 images: the last batch is padded by
    repeating its final example; with_masks adds the rasterized GT masks
    (polygons of every shape class)."""
    jfx, _ = coco_pair
    tp, jp = _pipelines(jfx, 4, with_masks=True, mask_size=14)
    got, want = list(tp.eval_batches()), list(jp.eval_batches())
    assert [i for i, _ in got] == [i for i, _ in want] == [[0, 1, 2, 3],
                                                           [4, 5]]
    for (_, g), (_, w) in zip(got, want):
        _assert_batches_equal(g, w)
    last = got[-1][1]
    np.testing.assert_array_equal(last.images[2], last.images[1])
    assert got[0][1].gt_masks.shape == (4, 8, 14, 14)
    assert got[0][1].gt_masks.max() > 0


def test_device_prefetch_keeps_order_and_depth():
    """device_prefetch yields put's results in order, calling put `depth`
    batches ahead of consumption."""
    calls = []

    def put(b):
        calls.append(b)
        return b * 10

    out = []
    for x in tpipe.device_prefetch(iter(range(5)), put, depth=2):
        out.append((x, len(calls)))
    assert out == [(0, 3), (10, 4), (20, 5), (30, 5), (40, 5)]
