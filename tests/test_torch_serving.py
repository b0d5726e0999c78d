"""Port parity, serving weights: the reference's int8 and factored trees
carried into the port's models and back (models/convert.py), and serving
bundles (eval/serving.py): a round trip gives the detections of a Detector
on the same float tree, and export refuses what the reference's export
refuses."""

import dataclasses
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multipathnet_tpu.core.config import preset as jpreset
from multipathnet_tpu.eval import serving as jserving
from multipathnet_tpu.models.multipath import build_model as jbuild
from multipathnet_tpu.ops import lowrank as jlowrank
from multipathnet_tpu.ops import quant as jquant
from multipathnet_tpu_torch.core.config import preset
from multipathnet_tpu_torch.eval import serving
from multipathnet_tpu_torch.eval.detect import Detector
from multipathnet_tpu_torch.models import convert
from multipathnet_tpu_torch.models.multipath import build_model

torch.set_num_threads(2)

FORMS = {"float": ("none", 0, 0), "int8": ("int8", 0, 0),
         "svd": ("none", 16, 8), "int8_svd": ("int8", 16, 8)}


def _cfg(make_preset, form="int8", dtype="float32"):
    quant, r6, r7 = FORMS[form]
    cfg = make_preset("tiny")
    return cfg.replace(model=dataclasses.replace(
        cfg.model, dtype=dtype, head_quant=quant, fc6_rank=r6, fc7_rank=r7))


@pytest.fixture(scope="module")
def float_tree():
    """The tiny model's float tree, flax layout, numpy leaves from a seed."""
    cfg = jpreset("tiny")
    shapes = jax.eval_shape(jbuild(cfg.model).init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 3)),
                            jnp.asarray([[[0.0, 0.0, 16.0, 16.0]]]))
    rng = np.random.default_rng(9)
    return jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) * 0.1).astype(np.float32),
        shapes)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_reference_serving_tree_carries_across(float_tree, form):
    """A tree transformed by the reference (lowrank.factorize_head_params,
    quant.quantize_head_params) loads into the port's model for that form
    unchanged and comes back out equal, int8 codes and cls_bbox's width
    (50, padded to 56 inside the model) included."""
    quant, r6, r7 = FORMS[form]
    tree = float_tree
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if r6 or r7:
            tree = jlowrank.factorize_head_params(tree, r6, r7)
    if quant == "int8":
        tree = jquant.quantize_head_params(tree)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    model = convert.load_flax_params(
        build_model(_cfg(preset, form).model, device="cpu"), tree)
    back = dict(_leaves(convert.flax_from_state_dict(model.state_dict())))
    want = dict(_leaves(tree))
    assert set(back) == set(want)
    for name, w in want.items():
        assert back[name].dtype == w.dtype, name
        np.testing.assert_array_equal(back[name], w, err_msg=name)
    if quant == "int8":
        assert model.head.cls_bbox.weight_i8.shape == (56, 256)
        assert back["params/head/cls_bbox/kernel_i8"].shape == (256, 50)
    if r6:
        leaf = "kernel_i8" if quant == "int8" else "kernel"
        assert back[f"params/head/fc6_f0_u/{leaf}"].shape == (1568, 16)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_bundle_round_trip_matches_detector(float_tree, form, tmp_path):
    """save_bundle of the float tree, then load_detector, gives the
    detections of a Detector transforming the same tree at load."""
    cfg = _cfg(preset, form)
    images = np.random.default_rng(0).integers(0, 256, (2, 48, 56, 3),
                                               dtype=np.uint8)
    hws = np.asarray([[48, 56], [40, 50]], np.float32)
    xy = np.random.default_rng(1).uniform(0, 30, (2, 16, 2))
    props = np.concatenate([xy, xy + 14.0], -1).astype(np.float32)
    mask = np.ones((2, 16), bool)
    report = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = Detector(build_model(cfg.model, device="cpu"), cfg,
                        params=float_tree)(images, hws, props, mask)
        serving.save_bundle(str(tmp_path), cfg, float_tree,
                            svd_report=report)
    assert len(report) == (8 if cfg.model.fc6_rank else 0)
    assert json.loads((tmp_path / "config.json").read_text()) == json.loads(
        cfg.to_json())
    got = serving.load_detector(str(tmp_path), device="cpu")(images, hws,
                                                            props, mask)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["valid"].any()


def test_bundle_quant_override(float_tree, tmp_path):
    cfg = _cfg(preset, "float")
    serving.save_bundle(str(tmp_path), cfg, float_tree, quant="int8")
    cfg2, model, params = serving.load_bundle(str(tmp_path), device="cpu")
    assert cfg2.model.head_quant == "int8"
    assert params["params"]["head"]["cls_bbox"]["kernel_i8"].dtype == (
        torch.int8)
    assert next(model.parameters()).device.type == "cpu"


@pytest.mark.parametrize("case", ["int8_under_none", "wrong_ranks",
                                  "factorize_int8", "bad_quant"])
def test_bundle_export_errors_match_reference(float_tree, case, tmp_path):
    """Each export the reference's save_bundle refuses, the port's refuses
    with a ValueError too, before writing anything."""
    int8 = jax.tree_util.tree_map(np.asarray,
                                  jquant.quantize_head_params(float_tree))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        factored = jax.tree_util.tree_map(
            np.asarray, jlowrank.factorize_head_params(float_tree, 16, 8))
    form, tree, kw = {
        "int8_under_none": ("float", int8, {}),
        "wrong_ranks": ("int8_svd", jax.tree_util.tree_map(
            np.asarray, jlowrank.factorize_head_params(float_tree, 8, 8)),
            {}),
        "factorize_int8": ("int8_svd", int8, {}),
        "bad_quant": ("int8", factored, {"quant": "int4"}),
    }[case]
    for cfg, save in ((_cfg(jpreset, form), jserving.save_bundle),
                      (_cfg(preset, form), serving.save_bundle)):
        with pytest.raises((ValueError, AssertionError)) as err:
            save(str(tmp_path / save.__module__), cfg, tree, **kw)
        if save is serving.save_bundle:
            assert err.type is ValueError
    assert not (tmp_path / serving.save_bundle.__module__).exists()
