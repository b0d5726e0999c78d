"""Port parity, the trunks of slice 8: ResNet-18/50/101 with frozen BN and
AlexNetLike (multipathnet_tpu_torch/models/backbones) against the JAX
package's flax trunks, on one numpy variable tree carried across by
models/convert.py (params and batch_stats), at 64^2; and the ResNet-18
trunk against the torchvision-layout torch trunk that
tests/test_torch_parity.py builds, through the port's import_weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multipathnet_tpu.models.backbones import get_backbone as jget
from multipathnet_tpu.models.backbones.resnet import BasicBlock as JBasic
from multipathnet_tpu.models.backbones.resnet import \
    BottleneckBlock as JBottleneck
from multipathnet_tpu.models.backbones.resnet import ResNet as JResNet
from multipathnet_tpu.train import loop as jloop
from multipathnet_tpu_torch.models import convert
from multipathnet_tpu_torch.models import import_weights as IW
from multipathnet_tpu_torch.models.backbones import get_backbone
from multipathnet_tpu_torch.models.backbones.resnet import (BasicBlock,
                                                            BottleneckBlock,
                                                            ResNet)
from multipathnet_tpu_torch.models.multipath import build_model
from multipathnet_tpu_torch.train.loop import frozen_parameter_names

torch.set_num_threads(2)


def random_variables(shapes, seed):
    """numpy variables for a flax shape tree: He-scaled kernels, small
    biases, BN scales in [0.5, 1.5], means N(0, 0.5) and variances from a
    positive draw in [0.5, 2], so no BN is the identity."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) * np.sqrt(2.0 / fan_in)
                    ).astype(np.float32)
        if "'var'" in name:
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        if "'mean'" in name:
            return (rng.normal(size=s.shape) * 0.5).astype(np.float32)
        if "'scale'" in name:
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.normal(size=s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _images(seed=0, hw=64):
    return np.random.default_rng(seed).normal(size=(2, hw, hw, 3)).astype(
        np.float32)


def _pair(name, stage_sizes=None):
    """(flax trunk, port trunk factory) by registry name, or a ResNet at
    reduced depth when stage_sizes is given."""
    if stage_sizes is None:
        return (lambda dt: jget(name, dt),
                lambda dt: get_backbone(name, dt, device="cpu",
                                        param_dtype=torch.float32))
    jblock, tblock = ((JBasic, BasicBlock) if name == "resnet18"
                      else (JBottleneck, BottleneckBlock))
    return (lambda dt: JResNet(stage_sizes, jblock, dt),
            lambda dt: ResNet(stage_sizes, tblock, dt, device="cpu",
                              param_dtype=torch.float32))


def _taps(name, stage_sizes, jdt, tdt, seed=1):
    jmake, tmake = _pair(name, stage_sizes)
    x = _images()
    jm = jmake(jdt)
    variables = random_variables(
        jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(x)), seed)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    tm = convert.load_flax_params(tmake(tdt), variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert set(got) == set(want) == {"c3", "c4", "c5"}
    out = {}
    for lv in want:
        assert tuple(got[lv].shape) == want[lv].shape, lv
        assert got[lv].dtype == tdt, lv
        out[lv] = (got[lv].float().numpy(),
                   np.asarray(want[lv]).astype(np.float32))
    return out


CASES = {"resnet18": None, "resnet50_cut": (1, 2, 1), "resnet101": None,
         "alexnet": None}


@pytest.mark.parametrize("case", sorted(CASES))
def test_trunk_float32_matches_reference(case):
    """float32 taps within 1e-5 x max |x| (float32 convolutions sum in
    another order); ResNet-50 at reduced depth (1, 2, 1) bottleneck blocks,
    the (3, 4, 6) stage map being checked by name in
    test_full_depth_trees_load_strictly; ResNet-101 at its full (3, 4, 23)
    depth and widths (2.3e-6 read at c5)."""
    name = case.split("_")[0]
    for lv, (got, want) in _taps(name, CASES[case], jnp.float32,
                                 torch.float32).items():
        scale = np.abs(want).max()
        assert scale > 0.1, lv
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale,
                                   err_msg=lv)


def _bf16_step(x):
    """The bf16 spacing at |x| (2^(e - 7) for x in [2^e, 2^(e+1)))."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


# the share of bf16 values allowed to differ, by trunk and level (seen with
# these seeds: resnet18 1.07%, 12.7%, 20.5% of c3/c4/c5; resnet50_cut 0,
# 0.40%, 1.10%; resnet101 0.21%, 16.3%, 54.2%; alexnet 0.003%, 0.004%, 0)
_BF16_SHARE = {"resnet18": {"c3": 0.02, "c4": 0.2, "c5": 0.3},
               "resnet50_cut": {"c3": 0.01, "c4": 0.02, "c5": 0.04},
               "resnet101": {"c3": 0.01, "c4": 0.25, "c5": 0.7},
               "alexnet": {"c3": 1e-3, "c4": 1e-2, "c5": 1e-2}}
# bf16 steps allowed at a level's largest magnitude where one is not enough:
# ResNet-101's 23 conv4_x blocks carry a moved rounding on through the
# residual sums, and c5 reads 3 steps (1.6% of its largest magnitude; an
# fp8 trunk moves the taps by 6-10%)
_BF16_STEPS = {"resnet101": {"c5": 4}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_trunk_bf16_matches_reference(case):
    """bf16 compute, float32 parameters and statistics. In the ResNets
    every convolution feeds its BN in float32 and the BN rounds once
    (models/layers.conv_f32, FrozenBatchNorm), as the reference's XLA
    computes it; AlexNet adds each bias after its rounded product (models/
    layers.py). The float32 convolutions still sum in another order than
    XLA's, so a differing float32 ulp can move a bf16 rounding, and the
    difference compounds with depth: each level's largest difference is
    at most one bf16 step at the level's largest magnitude, and the share
    of values that differ at all is pinned (_BF16_SHARE); at ResNet-101's
    c5 the difference is held to the few steps of _BF16_STEPS. Rounding
    the ResNet convolutions' outputs to bf16 before their BN instead makes
    27% of the stem BN's outputs differ."""
    name = case.split("_")[0]
    for lv, (got, want) in _taps(name, CASES[case], jnp.bfloat16,
                                 torch.bfloat16).items():
        diff = np.abs(got - want).max()
        steps = _BF16_STEPS.get(case, {}).get(lv, 1)
        assert diff <= steps * _bf16_step(np.abs(want).max()), (lv, diff)
        share = (got != want).mean()
        assert share <= _BF16_SHARE[case][lv], (lv, share)


@pytest.mark.parametrize("name", ["resnet18", "resnet50", "resnet101",
                                  "alexnet"])
def test_full_depth_trees_load_strictly(name):
    """Every leaf of the reference's full-depth variables (params and
    batch_stats) maps onto exactly one port parameter or buffer, shapes
    equal (a strict load), and back: the (3, 4, 6) and (3, 4, 23) stage
    maps and the Conv_k / BatchNorm_k names, downsample included."""
    jm = jget(name, jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 3)))
    variables = random_variables(shapes, 0)
    tm = get_backbone(name, torch.float32, device="meta")
    sd = convert.state_dict_from_flax(variables)
    assert set(sd) == set(tm.state_dict())
    for k, v in tm.state_dict().items():
        assert tuple(v.shape) == tuple(sd[k].shape), k
    back = convert.flax_from_state_dict(sd)
    assert set(back) == set(variables)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(variables))


@pytest.mark.parametrize("name", ["resnet18", "resnet50", "alexnet"])
@pytest.mark.parametrize("n", [0, 1, 2, 3, 5])
def test_frozen_stages_match_reference(name, n):
    """frozen_parameter_names (the port) against the reference's
    _freeze_mask on its own variables: the same parameters freeze for
    every stage count (the reference's mask also covers the frozen stages'
    batch_stats, whose gradients are zero anyway; in the port they are
    buffers, outside any optimizer)."""
    import dataclasses

    from multipathnet_tpu.core.config import preset as jpreset
    from multipathnet_tpu.models.multipath import build_model as jbuild
    from multipathnet_tpu_torch.core.config import preset

    jcfg = jpreset("tiny").model
    jcfg = dataclasses.replace(jcfg, backbone=name)
    jm = jbuild(jcfg)
    shapes = jax.eval_shape(jm.init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 1, 4)))
    mask = jloop._freeze_mask(shapes, n, jget(name, jnp.float32))
    want = {"/".join(str(p.key) for p in path)
            for path, m in jax.tree_util.tree_leaves_with_path(mask)
            if m == 0.0 and path[0].key == "params"}
    model = build_model(dataclasses.replace(preset("tiny").model,
                                            backbone=name), device="cpu")
    got = frozen_parameter_names(model, n)
    tree = convert.flax_from_state_dict(
        {k: v for k, v in model.state_dict().items() if k in got})
    got_paths = {"/".join(path) for path in _paths(tree)}
    assert got_paths == want
    assert not any("running" in k for k in got)


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def test_frozen_stages_get_no_gradient():
    """freeze_stages=2 on ResNet-18: the stem and stage 2 get no gradient
    (the trunk detaches after them, the reference's stop_gradient), stage
    3 does; the BN statistics never have one."""
    tm = ResNet((2, 2, 2), BasicBlock, torch.float32, device="cpu",
                freeze_stages=2)
    feats = tm(torch.from_numpy(_images()))
    sum(f.sum() for f in feats.values()).backward()
    for n, p in tm.named_parameters():
        frozen = n.startswith(ResNet.frozen_prefixes(2))
        assert (p.grad is None) == frozen, n
    assert all(not b.requires_grad for b in tm.buffers())


def test_resnet18_matches_torchvision_layout_trunk():
    """tests/test_torch_parity.py's torchvision-equivalent ResNet-18 trunk
    (random weights, randomized BN statistics, eval mode) imported by the
    port's import_weights.resnet18_params_from_state_dict: c3/c4/c5 within
    1e-5 x max |x| in float32."""
    from test_torch_parity import build_torch_resnet18_trunk

    torch.manual_seed(0)
    ref = build_torch_resnet18_trunk()
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.5)
                m.running_var.uniform_(0.5, 2.0)
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0, 0.1)
    ref.eval()
    state = {k: v.numpy() for k, v in ref.state_dict().items()}
    tm = ResNet((2, 2, 2), BasicBlock, torch.float32, device="cpu")
    IW.install_params(tm, {k[len("backbone."):]: v for k, v in
                           IW.resnet18_params_from_state_dict(state).items()})
    x = _images(3)
    with torch.no_grad():
        want = ref(torch.from_numpy(x).permute(0, 3, 1, 2))
        got = tm(torch.from_numpy(x))
    for lv in ("c3", "c4", "c5"):
        w = want[lv].permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got[lv].numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=lv)
