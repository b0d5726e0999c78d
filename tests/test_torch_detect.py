"""Port parity, the whole slice: images + proposals -> scores, boxes and
detections, at the `tiny` preset in float32. The JAX side runs
roi_impl="pallas" — the Pallas pool kernels in interpret mode on the CPU —
and the port runs its pool kernels' plain versions, with one parameter
tree converted by models/convert.py; the int8 and int8 + SVD serving forms
are made from that tree by each side's Detector at load."""

import dataclasses
import warnings
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multipathnet_tpu.core.config import preset as jpreset
from multipathnet_tpu.eval import detect as jdetect
from multipathnet_tpu.models.multipath import build_model as jbuild
from multipathnet_tpu_torch.core.config import preset
from multipathnet_tpu_torch.eval import detect as tdetect
from multipathnet_tpu_torch.models import convert
from multipathnet_tpu_torch.models.multipath import build_model

torch.set_num_threads(2)

B, P = 2, 16


def _cfg(make_preset):
    cfg = make_preset("tiny")
    return cfg.replace(model=dataclasses.replace(
        cfg.model, dtype="float32", roi_impl="pallas"))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (B, 48, 56, 3), dtype=np.uint8)
    src_hws = np.asarray([[48, 56], [40, 50]], np.float32)
    x1 = rng.uniform(0, 34, (B, P))
    y1 = rng.uniform(0, 28, (B, P))
    w = rng.uniform(4, 22, (B, P))
    h = rng.uniform(4, 20, (B, P))
    proposals = np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)
    prop_mask = np.ones((B, P), bool)
    prop_mask[1, -3:] = False
    return images, src_hws, proposals, prop_mask


@pytest.fixture(scope="module")
def slice_pair():
    """(jax model, params, cfg) and (torch model, cfg) on one tree."""
    jcfg = _cfg(jpreset)
    jmodel = jbuild(jcfg.model)
    shapes = jax.eval_shape(
        jmodel.init, jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
        jnp.asarray([[[0.0, 0.0, 16.0, 16.0]]]))
    rng = np.random.default_rng(7)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            fan_in = int(np.prod(s.shape[:-1]))
            gain = 8.0 if "cls_bbox" in name else 2.0  # spread the scores
            return (rng.normal(size=s.shape) * np.sqrt(gain / fan_in)
                    ).astype(np.float32)
        return (rng.normal(size=s.shape) * 0.1).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    tcfg = _cfg(preset)
    tmodel = convert.load_flax_params(
        build_model(tcfg.model, device="cpu"), params)
    return (jmodel, params, jcfg), (tmodel.eval(), tcfg)


def test_score_batch_matches_reference(slice_pair):
    (jmodel, params, jcfg), (tmodel, tcfg) = slice_pair
    images, src_hws, proposals, _ = _inputs()
    want_b, want_p = jax.jit(partial(jdetect.score_batch, model=jmodel,
                                     cfg=jcfg))(
        params, images_u8=images, src_hws=src_hws, proposals=proposals)
    got_b, got_p = tdetect.score_batch(
        tmodel, tcfg, *(torch.from_numpy(x) for x in
                        (images, src_hws, proposals)))
    assert got_p.shape == want_p.shape and got_b.shape == want_b.shape
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-5)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), atol=1e-3)
    # the scores are spread enough that NMS order is not decided by ULPs
    assert np.asarray(want_p).std() > 0.05


def test_detect_batch_matches_reference(slice_pair):
    (jmodel, params, jcfg), (tmodel, tcfg) = slice_pair
    inputs = _inputs()
    want = jax.jit(lambda p, *a: jdetect.detect_batch(p, jmodel, jcfg, *a))(
        params, *inputs)
    got = tdetect.Detector(tmodel, tcfg, "cpu")(*inputs)
    assert set(got) == set(want)
    for key in ("valid", "classes", "indices"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)
    np.testing.assert_allclose(got["scores"], np.asarray(want["scores"]),
                               atol=1e-5)
    np.testing.assert_allclose(got["boxes"], np.asarray(want["boxes"]),
                               atol=1e-3)
    assert got["valid"].any()
    d = tcfg.eval.max_detections
    assert got["boxes"].shape == (B, d, 4) and got["scores"].shape == (B, d)
    assert got["classes"].dtype == np.int32


def test_detector_takes_numpy_and_tensors_alike(slice_pair):
    """Detector returns the same detections for numpy inputs and for
    tensors already on its device (used as they are)."""
    _, (tmodel, tcfg) = slice_pair
    det = tdetect.Detector(tmodel, tcfg, "cpu")
    inputs = _inputs()
    want = det(*inputs)
    got = det(*(torch.from_numpy(x) for x in inputs))
    assert set(got) == set(want)
    for key in want:
        assert isinstance(got[key], np.ndarray)
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_model_forward_matches_reference(slice_pair):
    """The reference contract {images, rois} -> (scores, deltas)."""
    (jmodel, params, _), (tmodel, _) = slice_pair
    rng = np.random.default_rng(3)
    images = rng.normal(size=(B, 64, 64, 3)).astype(np.float32)
    rois = _inputs(1)[2]
    want_s, want_d = jax.jit(jmodel.apply)(params, images, rois)
    with torch.no_grad():
        got_s, got_d = tmodel(torch.from_numpy(images),
                              torch.from_numpy(rois))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-4)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-4)


def _serving_cfg(cfg, fc6_rank, fc7_rank):
    return cfg.replace(model=dataclasses.replace(
        cfg.model, head_quant="int8", fc6_rank=fc6_rank, fc7_rank=fc7_rank))


@pytest.mark.parametrize("ranks", [(0, 0), (16, 8)], ids=["int8", "int8_svd"])
def test_int8_serving_matches_reference(slice_pair, ranks):
    """int8 serving, and int8 with truncated-SVD heads, of slice_pair's one
    float tree: each side's Detector factorizes (fc6 rank 16, fc7 rank 8)
    and quantizes it at load, then scores the same images and proposals
    through its quantized pool route. The pools sum in other orders, so a
    pooled value one ULP apart can flip an int8 code at a rounding tie
    (test_torch_quant bounds their share); a flipped code moves a score by
    one code step (seen: probs 4.8e-4, boxes 1.9e-2 pixels), hence probs
    atol 2e-3 and boxes atol 5e-2."""
    (_, params, jcfg), (_, tcfg) = slice_pair
    jcfg, tcfg = (_serving_cfg(c, *ranks) for c in (jcfg, tcfg))
    jmodel = jbuild(jcfg.model)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # random weights: a flat spectrum
        jdet = jdetect.Detector(jmodel, params, jcfg)
        tdet = tdetect.Detector(build_model(tcfg.model, device="cpu"), tcfg,
                                params=params)
    images, src_hws, proposals, prop_mask = _inputs()
    want_b, want_p = jax.jit(partial(jdetect.score_batch, model=jmodel,
                                     cfg=jcfg))(
        jdet.params, images_u8=images, src_hws=src_hws, proposals=proposals)
    got_b, got_p = tdetect.score_batch(
        tdet.model, tcfg, *(torch.from_numpy(x) for x in
                            (images, src_hws, proposals)))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=2e-3)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), atol=5e-2)
    got = tdet(images, src_hws, proposals, prop_mask)
    d = tcfg.eval.max_detections
    assert got["boxes"].shape == (B, d, 4) and got["valid"].any()
