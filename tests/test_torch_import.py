"""Port parity, weight import: multipathnet_tpu_torch/models/import_weights
.py and t7_import.py against the JAX package's, and the batch_stats half of
models/convert.py.

Path A is the port's import (a torchvision-layout or head-contract state
dict straight to the port's state dict); path B is the reference's import
to a flax tree followed by the port's convert. Both must give the same
names and the same float32 arrays, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multipathnet_tpu.models import import_weights as JIW
from multipathnet_tpu.models import t7_import as jt7i
from multipathnet_tpu_torch.models import convert
from multipathnet_tpu_torch.models import import_weights as IW
from multipathnet_tpu_torch.models import t7_import as tt7i
from test_torch_parity import (build_torch_resnet18_trunk,
                               build_torch_resnet50_trunk, build_torch_vgg16)

torch.set_num_threads(2)


def _fill(shapes: dict, seed: int) -> dict:
    """numpy arrays for {name: shape}: normal draws, BN running variances
    from a positive draw."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in shapes.items():
        if k.endswith("running_var"):
            out[k] = rng.uniform(0.5, 2.0, shape).astype(np.float32)
        else:
            out[k] = rng.normal(size=shape).astype(np.float32)
    return out


def _torch_shapes(module, prefix=""):
    return {prefix + k: tuple(v.shape) for k, v in module.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def _equal(a: dict, b: dict):
    assert set(a) == set(b), sorted(set(a) ^ set(b))
    for k in a:
        assert a[k].dtype == b[k].dtype == torch.float32, k
        assert torch.equal(a[k], b[k]), k


def test_vgg16_path_a_equals_path_b():
    state = _fill(_torch_shapes(build_torch_vgg16(), "features."), 0)
    got = IW.vgg16_params_from_state_dict(state)
    want = convert.state_dict_from_flax(
        {"params": {"backbone": JIW.vgg16_params_from_state_dict(state)}})
    _equal(got, want)
    assert len(got) == 26


@pytest.mark.parametrize("depth", [18, 50])
def test_resnet_path_a_equals_path_b(depth):
    """The trunk with its BN: parameters and running statistics (the
    reference's batch_stats) map to the same port names and arrays."""
    if depth == 18:
        trunk = build_torch_resnet18_trunk()
        a, b = (IW.resnet18_params_from_state_dict,
                JIW.resnet18_params_from_state_dict)
    else:
        trunk = build_torch_resnet50_trunk()
        a, b = (IW.resnet50_params_from_state_dict,
                JIW.resnet50_params_from_state_dict)
    state = _fill(_torch_shapes(trunk), depth)
    params, stats = b(state)
    want = convert.state_dict_from_flax(
        {"params": {"backbone": params}, "batch_stats": {"backbone": stats}})
    got = a(state)
    _equal(got, want)
    assert any(k.endswith("running_var") for k in got)
    assert ("backbone.stage3_block0.Conv_3.weight" in got) == (depth == 50)


def _head_state(rng, skip, d=16, g=7, fc=24, n_f=4, n_k=3, ncls=5):
    state = {"reduce.weight": rng.normal(size=(d, sum(skip.values()), 1, 1)),
             "reduce.bias": rng.normal(size=d),
             "bbox.weight": rng.normal(size=(4 * ncls, n_f * fc)),
             "bbox.bias": rng.normal(size=4 * ncls)}
    for i in range(n_f):
        state[f"fc6.{i}.weight"] = rng.normal(size=(fc, g * g * d))
        state[f"fc6.{i}.bias"] = rng.normal(size=fc)
        state[f"fc7.{i}.weight"] = rng.normal(size=(fc, fc))
        state[f"fc7.{i}.bias"] = rng.normal(size=fc)
    for k in range(n_k):
        state[f"classifier.{k}.weight"] = rng.normal(size=(ncls, n_f * fc))
        state[f"classifier.{k}.bias"] = rng.normal(size=ncls)
    return {k: v.astype(np.float32) for k, v in state.items()}


@pytest.mark.parametrize("foveal_order", [None, (2, 0, 3, 1)])
def test_head_contract_path_a_equals_path_b(foveal_order):
    """reduce split per level, fc6 rows permuted to the (y, x, c) flatten,
    K classifiers + bbox fused into cls_bbox, columns in foveal_order."""
    skip = {"c3": 8, "c4": 16, "c5": 32}
    state = _head_state(np.random.default_rng(1), skip)
    got = IW.multipath_head_params_from_state_dict(
        state, skip_channels=skip, foveal_order=foveal_order)
    tree = JIW.multipath_head_params_from_state_dict(
        state, skip_channels=skip, foveal_order=foveal_order)
    want = convert.state_dict_from_flax({"params": tree})
    _equal(got, want)
    # branch i of the port is the checkpoint's branch foveal_order[i]
    src = 0 if foveal_order is None else foveal_order[0]
    np.testing.assert_array_equal(got["head.fc7_f0.weight"].numpy(),
                                  state[f"fc7.{src}.weight"])


def test_head_contract_refuses_bad_input():
    skip = {"c3": 8, "c4": 16, "c5": 32}
    state = _head_state(np.random.default_rng(1), skip)
    with pytest.raises(ValueError, match="in-channels"):
        IW.multipath_head_params_from_state_dict(
            state, skip_channels={"c4": 16, "c5": 32})
    with pytest.raises(ValueError, match="permutation"):
        IW.multipath_head_params_from_state_dict(
            state, skip_channels=skip, foveal_order=(0, 0, 1, 2))


def test_npz_loaders_and_install(tmp_path):
    """load_resnet18_npz equals the in-memory import; install_params puts
    it in a model (each entry keeps the model's dtype) and refuses unknown
    names and wrong shapes."""
    import dataclasses

    from multipathnet_tpu_torch.core.config import preset
    from multipathnet_tpu_torch.models.multipath import build_model

    state = _fill(_torch_shapes(build_torch_resnet18_trunk()), 3)
    np.savez(tmp_path / "r18.npz", **state)
    got = IW.load_resnet18_npz(str(tmp_path / "r18.npz"))
    _equal(got, IW.resnet18_params_from_state_dict(state))
    cfg = dataclasses.replace(preset("tiny").model, backbone="resnet18")
    model = build_model(cfg, device="cpu")  # bf16 compute and parameters
    IW.install_params(model, got)
    sd = model.state_dict()
    assert sd["backbone.stem.weight"].dtype == torch.bfloat16
    assert torch.equal(sd["backbone.stem.weight"],
                       got["backbone.stem.weight"].bfloat16())
    # BN stays float32 in a bf16 model, and its statistics load exactly
    assert torch.equal(sd["backbone.stem_bn.running_var"],
                       got["backbone.stem_bn.running_var"])
    with pytest.raises(KeyError, match="not in the model"):
        IW.install_params(model, {"backbone.nope.weight": torch.zeros(1)})
    with pytest.raises(ValueError, match="backbone.stem.weight"):
        IW.install_params(model, {"backbone.stem.weight": torch.zeros(1)})


# ------------------------------------------------------------ .t7 graph ---

def _graph_bytes(seed):
    """A whole MultiPath nn graph in the reference's container layout:
    DataParallelTable (two trunk replicas; only the first is read) of a
    VGG-16 trunk in SpatialConvolutionMM's flattened layout, a
    cudnn.SpatialConvolution 1x1 reduce, a ParallelTable foveal bank of
    fc6 -> fc7 branches and a ConcatTable of 3 classifiers and the bbox
    regressor, with weightless modules between. Returns (bytes, the
    torch-contract state dict it holds)."""
    from t7write import GraphWriter

    rng = np.random.default_rng(seed)
    gw = GraphWriter()
    chans = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
    trunk, replica, cin = [], [], 3
    state = {}
    for idx, c in zip(JIW.VGG16_TORCH_INDICES, chans):
        w = (rng.normal(size=(c, cin, 3, 3)) * 0.05).astype(np.float32)
        b = rng.normal(size=c).astype(np.float32)
        state[f"features.{idx}.weight"], state[f"features.{idx}.bias"] = w, b
        for seq in (trunk, replica):
            seq.append(gw.module(
                "nn.SpatialConvolutionMM",
                {"weight": w.reshape(c, -1), "bias": b},
                {"nInputPlane": cin, "nOutputPlane": c, "kW": 3, "kH": 3}))
        trunk.append(gw.module("nn.ReLU"))
        cin = c
    dpt = gw.container("nn.DataParallelTable", [
        gw.container("nn.Sequential", trunk),
        gw.container("nn.Sequential", replica)])
    skip = {"c3": 256, "c4": 512, "c5": 512}
    head = _head_state(rng, skip, d=16, fc=24, n_k=3, ncls=5)
    state.update(head)
    reduce_mod = gw.module("cudnn.SpatialConvolution",
                           {"weight": head["reduce.weight"],
                            "bias": head["reduce.bias"]})
    branches = [gw.container("nn.Sequential", [
        gw.module("inn.ROIPooling", scalars={"W": 7, "H": 7}),
        gw.module("nn.Linear", {"weight": head[f"fc6.{i}.weight"],
                                "bias": head[f"fc6.{i}.bias"]}),
        gw.module("nn.Dropout", scalars={"p": 0.5}),
        gw.module("nn.Linear", {"weight": head[f"fc7.{i}.weight"],
                                "bias": head[f"fc7.{i}.bias"]})])
        for i in range(4)]
    heads = [gw.module("nn.Linear", {"weight": head[f"classifier.{k}.weight"],
                                     "bias": head[f"classifier.{k}.bias"]})
             for k in range(3)]
    heads.append(gw.module("nn.Linear", {"weight": head["bbox.weight"],
                                         "bias": head["bbox.bias"]}))
    graph = gw.container("nn.Sequential", [
        dpt, gw.container("nn.Sequential", [
            reduce_mod, gw.container("nn.ParallelTable", branches),
            gw.container("nn.ConcatTable", heads)])])
    return graph, state


@pytest.fixture(scope="module")
def t7_graph(tmp_path_factory):
    data, state = _graph_bytes(4)
    path = tmp_path_factory.mktemp("t7") / "model.t7"
    path.write_bytes(data)
    return str(path), state


def _reference_model_cfg():
    import dataclasses

    from multipathnet_tpu.core.config import preset as jpreset

    m = jpreset("multipath_vgg16_reference").model
    return dataclasses.replace(m, fc_dim=24, skip_reduce_dim=16,
                               num_classes=5,
                               integral_thresholds=(0.5, 0.6, 0.7))


def test_import_model_t7_matches_reference(t7_graph):
    """import_model_t7 on the nn graph: every array the reference grafts
    into its variables equals the port's import (after convert), bit for
    bit; the structural walk maps the graph's own weights (the flattened
    MM kernels reshaped, replica 2 ignored)."""
    from multipathnet_tpu.models.multipath import build_model as jbuild

    path, state = t7_graph
    got = tt7i.import_model_t7(path, foveal_order=(1, 0, 2, 3))
    jm = jbuild(_reference_model_cfg())
    shapes = jax.eval_shape(jm.init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 1, 4)))
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    want = convert.state_dict_from_flax(jt7i.import_model_t7(
        path, zeros, foveal_order=(1, 0, 2, 3)))
    assert set(got) <= set(want)
    assert len(got) == 26 + 3 + 1 + 4 * 4 + 2
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
    np.testing.assert_array_equal(got["backbone.conv2_1.weight"].numpy(),
                                  state["features.5.weight"])
    np.testing.assert_array_equal(got["head.fc6_f0.bias"].numpy(),
                                  state["fc6.1.bias"])


def test_import_model_t7_into_a_model_runs(t7_graph):
    """With a model, import_model_t7 installs every imported entry (a
    `multipath_vgg16_reference` at the graph's head widths) and the model
    runs its max route on the imported weights."""
    import dataclasses

    from multipathnet_tpu_torch.core.config import preset
    from multipathnet_tpu_torch.models.multipath import build_model

    path, _ = t7_graph
    m = preset("multipath_vgg16_reference").model
    m = dataclasses.replace(m, fc_dim=24, skip_reduce_dim=16, num_classes=5,
                            integral_thresholds=(0.5, 0.6, 0.7),
                            dtype="float32")
    model = tt7i.import_model_t7(path, build_model(m, device="cpu"))
    want = tt7i.import_model_t7(path)
    sd = model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in want.items())
    rois = torch.tensor([[[4.0, 6.0, 40.0, 50.0], [10.0, 0.0, 30.0, 20.0]]])
    with torch.no_grad():
        scores, deltas = model(torch.randn(1, 64, 64, 3), rois)
    assert scores.shape == (1, 2, 3, 5) and deltas.shape == (1, 2, 20)
    assert torch.isfinite(scores).all() and torch.isfinite(deltas).all()


def test_import_model_t7_structural_errors():
    """The walk diagnoses graphs that are not a MultiPath VGG-16 model."""
    from t7write import GraphWriter

    from multipathnet_tpu_torch.data import t7

    gw = GraphWriter()
    graph = gw.container("nn.Sequential", [
        gw.module("nn.SpatialConvolution",
                  {"weight": np.zeros((4, 3, 3, 3), np.float32),
                   "bias": np.zeros(4, np.float32)})])
    with pytest.raises(ValueError, match="3x3 convs"):
        tt7i.map_multipath_nn_graph(t7.loads(graph))


# ------------------------------------------------------------- convert ---

def test_convert_carries_batch_stats_both_ways():
    """A ResNet model's flax variables (params and batch_stats) -> the
    port's state dict -> back: the same tree, bit for bit; BN scale <->
    weight, mean/var <-> running_mean/running_var; a model without BN gives
    no batch_stats; an unknown collection raises instead of being
    dropped."""
    import dataclasses

    from multipathnet_tpu.core.config import preset as jpreset
    from multipathnet_tpu.models.multipath import build_model as jbuild
    from multipathnet_tpu_torch.core.config import preset
    from multipathnet_tpu_torch.models.multipath import build_model
    from test_torch_backbones import random_variables

    jm = jbuild(dataclasses.replace(jpreset("tiny").model,
                                    backbone="resnet18"))
    shapes = jax.eval_shape(jm.init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 1, 4)))
    variables = random_variables(shapes, 5)
    assert set(variables) == {"params", "batch_stats"}
    model = convert.load_flax_params(build_model(dataclasses.replace(
        preset("tiny").model, backbone="resnet18"), device="cpu",
        param_dtype=torch.float32), variables)
    sd = model.state_dict()
    np.testing.assert_array_equal(
        sd["backbone.stage3_block0.BatchNorm_2.running_var"].numpy(),
        variables["batch_stats"]["backbone"]["stage3_block0"]["BatchNorm_2"][
            "var"])
    np.testing.assert_array_equal(
        sd["backbone.stem_bn.weight"].numpy(),
        variables["params"]["backbone"]["stem_bn"]["scale"])
    back = convert.flax_from_state_dict(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = jax.tree_util.tree_leaves_with_path(variables)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (p, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, np.asarray(b).astype(a.dtype),
                                      err_msg=str(p))
    vgg = build_model(preset("tiny").model, device="cpu")
    assert set(convert.flax_from_state_dict(vgg.state_dict())) == {"params"}
    with pytest.raises(ValueError, match="unknown flax collection"):
        convert.state_dict_from_flax({**variables, "cache": {}})
