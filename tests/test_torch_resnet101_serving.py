"""Port parity, MultiPath on a ResNet-101 trunk served int8 + SVD (preset
multipath_resnet101_int8_svd) against the JAX package's Detector on the
reference's multipath_vgg16_int8_svd with backbone "resnet101", on the CPU.

The trunk is ResNet-101's to conv4_x at its published widths and depth
(3/4/23 bottlenecks, 64-1024 channels, skip reduce 512, G = 7) on a 64 or
96 px canvas; the head is cut to fc_dim 64 with SVD ranks 16/8 and 5
classes so that the test runs in seconds. One float tree (params and
batch_stats, numpy) goes to both Detectors, each of which factorizes and
quantizes it at load; both pool through their kernel route (roi_impl
"pallas": the Pallas kernels in interpret mode, the port's kernels' plain
versions). The draw keeps the trunk's maps of order one: He-normal
kernels, BN scales in [0.2, 0.6], variances in [0.5, 2], means and biases
N(0, 0.1).

Tolerances, with their reasons:
- the served model's features (the reduced c3/c4/c5 maps): float32 within
  1e-5 of the largest magnitude (float32 sums in another order; 1.8e-6
  read); bf16 within one bf16 step at the level's largest magnitude, the
  share of values that differ pinned (1.0-1.2%, 21-26%, 67-68% read for
  c3/c4/c5: as in test_torch_backbones, a float32 ulp that moves one
  rounding carries on through the residual sums). Rounding the trunk's
  weights to fp8 moves these maps by several percent, far outside either;
- probabilities atol 4e-3 and boxes atol 0.25 px: the pools sum in other
  orders, so a pooled value one ulp apart can flip an int8 code at a
  rounding tie, and a flipped code moves a score by a code step (read:
  probabilities 6.6e-4 / 8.7e-4 in float32, 1.7e-3 / 2.2e-3 in bf16; boxes
  0.02-0.15 px). With the head cut to fc_dim 64 the scores stay near
  uniform, so they barely see the trunk: the features carry its check,
  and these hold the load transform, pool, head and decode together.

`bn.passes` (utils/profiling) counts each FrozenBatchNorm forward: 94 a
ResNet-101 batch (the stem, 3 x 3 + 1, 4 x 3 + 1, 23 x 3 + 1), 0 for
VGG-16.
"""

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
from multipathnet_tpu.models.multipath import MultiPathNet as JMultiPathNet
from multipathnet_tpu.models.multipath import build_model as jbuild
from multipathnet_tpu_torch.core.config import preset
from multipathnet_tpu_torch.eval import detect as tdetect
from multipathnet_tpu_torch.models.multipath import build_model
from multipathnet_tpu_torch.utils import profiling

torch.set_num_threads(2)

B, P = 2, 16
# bf16: the share of feature values allowed to differ, by level
BF16_SHARE = {"c3": 0.03, "c4": 0.4, "c5": 0.8}
PROB_ATOL, BOX_ATOL = 4e-3, 0.25


def _cfg(make_preset, name: str, canvas: int, dtype: str,
         backbone: str = "resnet101"):
    cfg = make_preset(name)
    return cfg.replace(
        model=dataclasses.replace(cfg.model, backbone=backbone, fc_dim=64,
                                  fc6_rank=16, fc7_rank=8, num_classes=5,
                                  dtype=dtype, roi_impl="pallas"),
        data=dataclasses.replace(cfg.data, image_size=(canvas, canvas),
                                 max_proposals=P))


def _tree(jcfg, canvas: int, seed: int = 7):
    """A float tree (params and batch_stats) for jcfg's model with a float
    head, numpy leaves."""
    jmodel = jbuild(dataclasses.replace(jcfg.model, head_quant="none",
                                        fc6_rank=0, fc7_rank=0))
    shapes = jax.eval_shape(
        jmodel.init, jax.random.key(0), jnp.zeros((1, canvas, canvas, 3)),
        jnp.asarray([[[0.0, 0.0, 16.0, 16.0]]]))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            fan_in = int(np.prod(s.shape[:-1]))
            gain = 8.0 if "cls_bbox" in name else 2.0  # spread the scores
            return (rng.normal(size=s.shape) * np.sqrt(gain / fan_in)
                    ).astype(np.float32)
        if "'var'" in name:
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        if "'scale'" in name:
            return rng.uniform(0.2, 0.6, s.shape).astype(np.float32)
        return (rng.normal(size=s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _inputs(canvas: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    h, w = canvas * 7 // 8, canvas
    images = rng.integers(0, 256, (B, h, w, 3), dtype=np.uint8)
    src_hws = np.asarray([[h, w], [h - 8, w - 6]], np.float32)
    x1 = rng.uniform(0, 0.6 * w, (B, P))
    y1 = rng.uniform(0, 0.6 * h, (B, P))
    bw = rng.uniform(4, 0.4 * w, (B, P))
    bh = rng.uniform(4, 0.4 * h, (B, P))
    proposals = np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32)
    prop_mask = np.ones((B, P), bool)
    prop_mask[1, -3:] = False
    return images, src_hws, proposals, prop_mask


def _bf16_step(x):
    """The bf16 spacing at |x| (2^(e - 7) for x in [2^e, 2^(e+1)))."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("canvas", [64, 96])
def test_detector_matches_reference(canvas, dtype):
    jcfg = _cfg(jpreset, "multipath_vgg16_int8_svd", canvas, dtype)
    tcfg = _cfg(preset, "multipath_resnet101_int8_svd", canvas, dtype)
    jmodel = jbuild(jcfg.model)
    params = _tree(jcfg, canvas)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # random weights: a flat spectrum
        jdet = jdetect.Detector(jmodel, params, jcfg)
        tdet = tdetect.Detector(build_model(tcfg.model, device="cpu"), tcfg,
                                device="cpu", params=params)

    x = np.random.default_rng(3).normal(size=(B, canvas, canvas, 3)).astype(
        np.float32)
    want = jax.jit(partial(jmodel.apply, method=JMultiPathNet.features))(
        jdet.params, x)
    with torch.inference_mode():
        got = tdet.model.features(torch.from_numpy(x))
    assert set(got) == set(want) == {"c3", "c4", "c5"}
    for lv in want:
        w = np.asarray(want[lv], np.float32)
        g = got[lv].float().numpy()
        assert g.shape == w.shape, lv
        diff = np.abs(g - w).max()
        if dtype == "float32":
            assert diff <= 1e-5 * np.abs(w).max(), (lv, diff)
        else:
            assert diff <= _bf16_step(np.abs(w).max()), (lv, diff)
            assert (g != w).mean() <= BF16_SHARE[lv], lv

    images, src_hws, proposals, prop_mask = _inputs(canvas)
    want_b, want_p = jax.jit(partial(jdetect.score_batch, model=jmodel,
                                     cfg=jcfg))(
        jdet.params, images_u8=images, src_hws=src_hws, proposals=proposals)
    got_b, got_p = tdetect.score_batch(
        tdet.model, tcfg, *(torch.from_numpy(a) for a in
                            (images, src_hws, proposals)))
    want_p = np.asarray(want_p, np.float32)
    assert got_p.shape == want_p.shape and got_b.shape == want_b.shape
    np.testing.assert_allclose(got_p.float().numpy(), want_p, rtol=0,
                               atol=PROB_ATOL)
    np.testing.assert_allclose(got_b.float().numpy(),
                               np.asarray(want_b, np.float32), rtol=0,
                               atol=BOX_ATOL)
    assert want_p.std() > 0.01   # not one constant score
    got = tdet(images, src_hws, proposals, prop_mask)
    d = tcfg.eval.max_detections
    assert got["boxes"].shape == (B, d, 4) and got["valid"].any()


@pytest.mark.parametrize("backbone,passes", [("resnet101", 94),
                                             ("resnet50", 43),
                                             ("resnet18", 15),
                                             ("vgg16", 0)])
def test_bn_passes_a_batch(backbone, passes):
    """bn.passes over one Detector call: the root's counter change and
    the registry's agree."""
    cfg = _cfg(preset, "multipath_resnet101_int8_svd", 64, "bfloat16",
               backbone)
    det = tdetect.Detector(build_model(cfg.model, device="cpu"), cfg,
                           device="cpu")
    before = profiling.counters().get("bn.passes", 0)
    profiling.clear_records()
    with profiling.tracing():
        det(*_inputs(64))
    (rec,) = profiling.records()
    profiling.clear_records()
    assert profiling.counters().get("bn.passes", 0) - before == passes
    assert rec["counters"].get("bn.passes", 0) == passes
