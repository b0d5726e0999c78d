"""Port parity, model layer: the torch trunks, head and weight bridge
(multipathnet_tpu_torch.models) against the flax modules of the JAX package,
on one numpy parameter tree."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multipathnet_tpu.models.backbones.small import TinyNet as JTinyNet
from multipathnet_tpu.models.backbones.vgg import VGG16 as JVGG16
from multipathnet_tpu.models.heads import MultiPathHead as JHead
from multipathnet_tpu_torch.core.config import preset
from multipathnet_tpu_torch.models import convert
from multipathnet_tpu_torch.models.backbones import get_backbone
from multipathnet_tpu_torch.models.backbones.small import TinyNet
from multipathnet_tpu_torch.models.backbones.vgg import VGG16
from multipathnet_tpu_torch.models.heads import MultiPathHead
from multipathnet_tpu_torch.models.multipath import MultiPathNet

torch.set_num_threads(2)


def random_tree(shapes, seed):
    """numpy params for a flax shape tree: He-scaled kernels, small biases,
    so activations stay O(1) through deep stacks."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) * np.sqrt(2.0 / fan_in)
                    ).astype(np.float32)
        return (rng.normal(size=s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _trunk_parity(jmodel, tmodel, hw, seed):
    x = np.random.default_rng(seed).normal(size=(2, *hw, 3)).astype(np.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.asarray(x))
    params = random_tree(shapes, seed)
    want = jax.jit(jmodel.apply)(params, jnp.asarray(x))
    convert.load_flax_params(tmodel, params)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    assert set(got) == set(want) == {"c3", "c4", "c5"}
    for lv in want:
        assert tuple(got[lv].shape) == want[lv].shape, lv
        assert _rel_err(got[lv].numpy(), want[lv]) < 1e-4, lv


def test_vgg16_trunk_matches_reference():
    _trunk_parity(JVGG16(dtype=jnp.float32), VGG16(dtype=torch.float32),
                  (64, 64), seed=0)


@pytest.mark.parametrize("hw", [(64, 64), (50, 37)], ids=["even", "odd"])
def test_tinynet_matches_reference(hw):
    """flax SAME padding on stride-2 convs: (0, 1) on even sizes."""
    _trunk_parity(JTinyNet(dtype=jnp.float32), TinyNet(dtype=torch.float32),
                  hw, seed=1)


def test_head_matches_reference():
    kw = dict(num_classes=5, foveal_scales=(1.0, 1.5, 2.0, 4.0),
              num_integral_heads=3, fc_dim=24, skip_reduce_dim=16)
    jhead = JHead(dtype=jnp.float32, **kw)
    thead = MultiPathHead(dtype=torch.float32, **kw)
    rng = np.random.default_rng(2)
    pooled = rng.normal(size=(2, 4, 5, 7, 7, 16)).astype(np.float32)
    shapes = jax.eval_shape(jhead.init, jax.random.key(0),
                            jnp.asarray(pooled))
    params = random_tree(shapes, 3)
    want_s, want_d = jax.jit(jhead.apply)(params, jnp.asarray(pooled))
    convert.load_flax_params(thead, params)
    with torch.no_grad():
        got_s, got_d = thead(torch.from_numpy(pooled))
    assert got_s.dtype == got_d.dtype == torch.float32
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-4)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-4)


def test_convert_layouts():
    """HWIO -> OIHW, (in, out) -> (out, in); names joined with dots."""
    k4 = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    k2 = np.arange(12, dtype=np.float32).reshape(3, 4)
    sd = convert.state_dict_from_flax({"params": {
        "backbone": {"conv1": {"kernel": k4, "bias": np.ones(5)}},
        "head": {"fc6_f0": {"kernel": k2}, "skip_bias": np.zeros(4)}}})
    assert set(sd) == {"backbone.conv1.weight", "backbone.conv1.bias",
                       "head.fc6_f0.weight", "head.skip_bias"}
    np.testing.assert_array_equal(sd["backbone.conv1.weight"].numpy(),
                                  k4.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["head.fc6_f0.weight"].numpy(), k2.T)


@pytest.mark.parametrize("field,value", [
    ("roi_mode", "max"),
    ("preprocess", "caffe_bgr"),
    ("backbone", "resnet50"),
    ("backbone", "alexnet"),
])
def test_reference_options_build(field, value):
    """The options that raised until the reference's models were ported
    build now (the whole slice's parity is tests/
    test_torch_reference_models.py); an unknown roi_mode still raises."""
    cfg = dataclasses.replace(preset("tiny").model, **{field: value})
    MultiPathNet(cfg, device="meta")
    with pytest.raises(ValueError, match="roi_mode"):
        MultiPathNet(dataclasses.replace(cfg, roi_mode="bilinear"),
                     device="meta")


def test_backbone_registry():
    assert isinstance(get_backbone("tinynet", torch.float32), TinyNet)
    for name in ("resnet18", "resnet50", "resnet101", "alexnet"):
        get_backbone(name, torch.float32, device="meta")
    with pytest.raises(KeyError):
        get_backbone("vgg19", torch.float32)
