"""The port's bench (multipathnet_tpu_torch/bench.py) against the root
bench.py: the batch bit for bit, the JSON record key for key (the metric
label, vs_baseline, the companions) with both `measure`s replaced by one
fake, the parameter counts of the presets (shapes only: the reference's
jax.eval_shape of the float init, then of quantize_head_params; the port's
model on the meta device), one CPU run of the CLI, and bench.py's weights
on a ResNet trunk: its frozen BN statistics drawn normal * 0.02, so about
half of the variances are negative and the features NaN, run through
detect_batch in both packages."""

import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multipathnet_tpu.core.config import preset as jpreset
from multipathnet_tpu.eval import detect as jdetect
from multipathnet_tpu.models.multipath import build_model as jbuild
from multipathnet_tpu.ops.quant import quantize_head_params
from multipathnet_tpu_torch import bench as tbench
from multipathnet_tpu_torch.core.config import preset
from multipathnet_tpu_torch.eval import detect as tdetect
from multipathnet_tpu_torch.models import convert
from multipathnet_tpu_torch.models.multipath import build_model

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("root_bench", ROOT / "bench.py")
rbench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(rbench)

PRESETS = ("multipath_vgg16_int8_svd", "multipath_vgg16_batched",
           "multipath_vgg16_int8")
# a distinct img/s per preset, so a companion filled from the wrong run shows
FAKE_IPS = {"multipath_vgg16_int8_svd": 123.45678,
            "multipath_vgg16_batched": 98.76543,
            "multipath_vgg16_int8": 111.11111}


@pytest.mark.parametrize("shape", [(8, 1000, 640), (2, 7, 96), (1, 8, 64)])
def test_make_inputs_bit_equal_to_bench(shape):
    args = SimpleNamespace(batch=shape[0], proposals=shape[1],
                           canvas=shape[2])
    for got, want in zip(tbench.make_inputs(args), rbench.make_inputs(args),
                         strict=True):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backbone", ["", "resnet18", "resnet50",
                                      "resnet101"])
@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("companions", [True, False])
def test_record_equals_bench(name, backbone, companions, monkeypatch,
                             capsys):
    """Both mains with their `measure` replaced by one fake: the same JSON
    line (metric label, value, unit, vs_baseline, companions), and the
    same presets measured in the same order. With --preset one of the
    companions, that companion is the headline's number, measured once."""
    argv = ["--preset", name, "--iters", "1"]
    argv += ["--backbone", backbone] if backbone else []
    argv += [] if companions else ["--no-companions"]
    calls = {"root": [], "port": []}

    def fake(side):
        def measure(preset_name, args, raw_inputs, *device):
            calls[side].append((preset_name, args.backbone, args.iters))
            return FAKE_IPS[preset_name]
        return measure

    monkeypatch.setattr(rbench, "measure", fake("root"))
    monkeypatch.setattr(tbench, "measure", fake("port"))
    monkeypatch.setattr(sys, "argv", ["bench.py", *argv])
    rbench.main()
    want = capsys.readouterr().out
    tbench.main([*argv, "--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want and len(got.splitlines()) == 1
    assert calls["port"] == calls["root"]
    record = json.loads(got)
    assert record["value"] == round(FAKE_IPS[name], 3)
    if companions:
        assert record["companions"] == {
            "bf16": round(FAKE_IPS["multipath_vgg16_batched"], 3),
            "int8": round(FAKE_IPS["multipath_vgg16_int8"], 3)}
        # the headline once, then each companion that is not the headline
        assert [c[0] for c in calls["port"]] == [name] + [
            n for _, n in tbench.COMPANIONS if n != name]
    else:
        assert "companions" not in record and len(calls["port"]) == 1
    for key in ("", "resnet101"):
        cfg = tbench.eval_config(name, key)
        assert tbench.tag_for(cfg.model) == rbench.tag_for(cfg.model)


def _reference_count(name, backbone=""):
    """bench.py's parameter count, from shapes alone."""
    cfg = jpreset(name)
    model = dataclasses.replace(cfg.model, head_quant="none",
                                **({"backbone": backbone} if backbone
                                   else {}))
    fm = jbuild(model)
    shapes = jax.eval_shape(lambda: fm.init(
        jax.random.key(0), jnp.zeros((1, 640, 640, 3), jnp.float32),
        jnp.asarray([[[0, 0, 64, 64]]], jnp.float32)))
    if cfg.model.head_quant != "none":
        shapes = jax.eval_shape(quantize_head_params, shapes)
    return sum(math.prod(x.shape) for x in jax.tree.leaves(shapes))


@pytest.mark.parametrize("name,backbone", [
    *((n, "") for n in PRESETS), ("multipath_vgg16_int8_svd", "resnet101")])
def test_param_count_equals_bench(name, backbone):
    """The serving model's leaves after the load-time transform (int8
    kernels, their scales, a ResNet's BN statistics) number as bench.py
    counts them at full width."""
    cfg = tbench.eval_config(name, backbone)
    got = tbench.count_params(build_model(cfg.model, device="meta"))
    assert got == _reference_count(name, backbone)


def test_build_preset_transforms_at_load(monkeypatch):
    """build_preset at `tiny` with int8 heads and odd SVD ranks: the
    Detector's model holds the reference's tree after quantize_head_params
    entry for entry in shape, every entry drawn (no zero tensor left),
    and the count is the state dict's."""
    ranks = dict(head_quant="int8", fc6_rank=9, fc7_rank=5)
    original = tbench.eval_config
    monkeypatch.setattr(tbench, "eval_config", lambda name, *a: original(
        name, *a).replace(model=dataclasses.replace(preset(name).model,
                                                    **ranks)))
    det, n = tbench.build_preset("tiny", SimpleNamespace(
        canvas=64, proposals=8, backbone=""), torch.device("cpu"))
    fm = jbuild(dataclasses.replace(jpreset("tiny").model,
                                    **{**ranks, "head_quant": "none"}))
    shapes = jax.eval_shape(quantize_head_params, jax.eval_shape(
        lambda: fm.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
                        jnp.asarray([[[0, 0, 16, 16]]], jnp.float32))))
    want = convert.state_dict_from_flax(jax.tree.map(
        lambda x: np.zeros(x.shape, x.dtype), shapes))
    state = det.model.state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert n == sum(v.numel() for v in state.values())
    assert all(bool(v.any()) for v in state.values())
    assert det.model.head.fc6_f0.weight_i8.dtype == torch.int8


def test_cli_prints_one_json_line():
    proc = subprocess.run(
        [sys.executable, "-m", "multipathnet_tpu_torch.bench", "--device",
         "cpu", "--preset", "tiny", "--batch", "1", "--proposals", "8",
         "--canvas", "64", "--iters", "1", "--no-companions"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 1, proc.stdout
    record = json.loads(lines[0])
    assert list(record) == ["metric", "value", "unit", "vs_baseline"]
    assert record["metric"].startswith("images/sec/chip (MultiPath tinynet")
    assert record["value"] > 0 and record["unit"] == "images/sec"
    assert "[tiny] kernel launches: {" in proc.stderr


# ------------------------------------------------ bench.py's ResNet draw ---

def _nan_cfg(make_preset, dtype, quant):
    """`multipath_resnet18_integral` at 64^2 and 8 proposals, its head cut
    to fc_dim 64, skip reduce 32 and 5 classes; the window-kernel route
    (the JAX side's Pallas kernels in interpret mode)."""
    cfg = make_preset("multipath_resnet18_integral")
    m = dataclasses.replace(
        cfg.model, fc_dim=64, skip_reduce_dim=32, num_classes=5, dtype=dtype,
        roi_impl="pallas",
        **({"head_quant": "int8", "fc6_rank": 16, "fc7_rank": 8}
           if quant else {}))
    return cfg.replace(model=m, data=dataclasses.replace(
        cfg.data, image_size=(64, 64), max_proposals=8))


def _bench_draw(jcfg):
    """bench.py's weights, as its measure() draws them: every leaf of
    jax.eval_shape of the float model's init (batch_stats included)
    normal * 0.02 from split keys, then quantize_head_params."""
    fm = jbuild(dataclasses.replace(jcfg.model, head_quant="none"))
    shapes = jax.eval_shape(lambda: fm.init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3), jnp.float32),
        jnp.asarray([[[0, 0, 64, 64]]], jnp.float32)))
    leaves, treedef = jax.tree.flatten(shapes)
    keys = jax.random.split(jax.random.key(0), len(leaves))
    params = jax.tree.unflatten(treedef, [
        jax.random.normal(k, x.shape, x.dtype) * 0.02
        for k, x in zip(keys, leaves)])
    if jcfg.model.head_quant != "none":
        params = quantize_head_params(params)
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("dtype,quant", [("float32", False),
                                         ("bfloat16", False),
                                         ("bfloat16", True)])
def test_nan_bn_statistics_run_to_the_end_as_reference(dtype, quant):
    """bench.py's draw on a ResNet-18 trunk: about half of the BN variances
    negative, every probability NaN in both packages. detect_batch
    finishes in both with no valid detection, and valid, classes, indices
    and every finite entry of boxes and scores agree."""
    jcfg, tcfg = _nan_cfg(jpreset, dtype, quant), _nan_cfg(preset, dtype,
                                                            quant)
    params = _bench_draw(jcfg)
    var = np.concatenate([v.ravel() for v in
                          jax.tree.leaves(params["batch_stats"])])
    assert 0.4 < (var < 0).mean() < 0.6
    args = SimpleNamespace(batch=2, proposals=8, canvas=64)
    inputs = tbench.make_inputs(args)
    jm = jbuild(jcfg.model)
    want = jax.jit(lambda p, *a: jdetect.detect_batch(p, jm, jcfg, *a))(
        params, *inputs)
    want = {k: np.asarray(v) for k, v in want.items()}
    model = convert.load_flax_params(build_model(tcfg.model, device="cpu"),
                                     params)
    got = tdetect.Detector(model, tcfg, "cpu")(*inputs)
    _, probs = tdetect.score_batch(model, tcfg, *(
        torch.from_numpy(x) for x in inputs[:3]))
    assert bool(torch.isnan(probs).all())
    assert not want["valid"].any() and not got["valid"].any()
    for key in ("valid", "classes", "indices"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("boxes", "scores"):
        finite = np.isfinite(want[key])
        np.testing.assert_array_equal(np.isfinite(got[key]), finite,
                                      err_msg=key)
        np.testing.assert_array_equal(got[key][finite], want[key][finite],
                                      err_msg=key)
