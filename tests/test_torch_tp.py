"""Port parity, tensor parallelism at `tiny` in float32: the train step on
(data x model) meshes against pure data parallelism, and the serving head
(float, int8, truncated-SVD int8, an odd SVD rank) on a (1, 2) mesh
against the unsharded port and the reference's GSPMD-partitioned outputs
(tests/test_sharding.py's bars). The ranks are gloo processes on the CPU,
launched once for the module (multipathnet_tpu_torch/tools/mesh_runs.py);
the reference runs on the conftest's 8 virtual devices."""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multipathnet_tpu_torch.core.config import preset
from multipathnet_tpu_torch.core.mesh import spawn
from multipathnet_tpu_torch.data import synthetic
from multipathnet_tpu_torch.data.coco import CocoLoader
from multipathnet_tpu_torch.data.pipeline import DetectionPipeline
from multipathnet_tpu_torch.data.proposals import ProposalStore
from multipathnet_tpu_torch.tools import mesh_runs

TIMEOUT = 300  # seconds the module's launch may take before it fails

# layout -> (head_quant, fc6_rank, fc7_rank); svd_odd's rank 15 divides
# no model axis, so its fc6 pair stays whole and fc7 alone is sharded
_SERVING = {"int8": ("int8", 0, 0), "svd_int8": ("int8", 16, 8),
            "svd_odd": ("int8", 15, 0), "svd": ("none", 16, 8),
            "float": ("none", 0, 0)}


def _cfg(make_preset, head_quant="none", fc6_rank=0, fc7_rank=0, **model):
    """tests/test_sharding.py's config (tiny, 5 classes, fc_dim 64, batch
    4) in float32; the reference's "pyramid" pool route, the XLA oracle
    of the windowed kernels, which its GSPMD partitioning takes."""
    cfg = make_preset("tiny")
    return cfg.replace(
        model=dataclasses.replace(
            cfg.model, num_classes=5, fc_dim=64, dtype="float32",
            roi_impl="pyramid", head_quant=head_quant, fc6_rank=fc6_rank,
            fc7_rank=fc7_rank, **model),
        train=dataclasses.replace(cfg.train, batch_size=4, warmup_steps=0))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    fx = synthetic.generate(str(tmp_path_factory.mktemp("tp_ds")),
                            num_images=8, image_size=64, num_classes=4,
                            proposals_per_image=16, seed=31)
    cfg = _cfg(preset)
    loader = CocoLoader(fx["annotations"], fx["images"])
    batch = next(DetectionPipeline(loader, ProposalStore.load(
        fx["proposals"]), cfg.data, batch_size=4, seed=0).epoch(0))
    return cfg, batch


@functools.lru_cache(maxsize=None)
def _float_init():
    """The reference's float tree at `tiny` (5 classes, fc_dim 64), key 0."""
    from multipathnet_tpu.core.config import preset as jpreset
    from multipathnet_tpu.models.multipath import build_model as jbuild

    return jbuild(_cfg(jpreset).model).init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 1, 4)))


def _serving_tree(layout):
    """The reference's serving tree of `layout` from its float init
    (key 0): factorized, then quantized, as its Detector loads it."""
    from multipathnet_tpu.ops.lowrank import factorize_head_params
    from multipathnet_tpu.ops.quant import quantize_head_params

    quant, r6, r7 = _SERVING[layout]
    params = _float_init()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # random weights: a flat spectrum
        if r6 or r7:
            params = factorize_head_params(params, r6, r7)
        if quant == "int8":
            params = quantize_head_params(params)
    return jax.tree.map(np.asarray, params)


def _reference_tp_scores(layout, tree, batch):
    """score_batch of the reference on `tree`, GSPMD-partitioned over a
    (1, 2) mesh with its MeshRules.tree_sharding: (boxes, probs)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from multipathnet_tpu.core.config import preset as jpreset
    from multipathnet_tpu.core.mesh import MeshRules, make_mesh
    from multipathnet_tpu.eval.detect import score_batch
    from multipathnet_tpu.models.multipath import build_model as jbuild

    cfg = _cfg(jpreset, *_SERVING[layout])
    model = jbuild(cfg.model)
    mesh = make_mesh(n_data=1, n_model=2)
    params = jax.device_put(tree, MeshRules(mesh).tree_sharding(tree))
    rep = NamedSharding(mesh, P())
    args = tuple(jax.device_put(jnp.asarray(a), rep) for a in
                 (batch.images, batch.src_hws, batch.proposals))
    f = jax.jit(lambda p, im, hw, pr: score_batch(p, model, cfg, im, hw, pr))
    return jax.tree.map(np.asarray, f(params, *args))


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """Every tensor-parallel run of the module in one launch of 8 ranks,
    results by job; and the serving trees."""
    cfg, batch = data
    k1 = _cfg(preset, integral_thresholds=(0.5,))
    trees = {layout: _serving_tree(layout) for layout in _SERVING}
    images = (batch.images, batch.src_hws, batch.proposals, batch.prop_mask)
    cpu = dict(device="cpu")
    jobs = [(mesh_runs.train_run, (cfg, (4, 1), batch),
             dict(cpu, steps=2, return_params=False)),
            (mesh_runs.train_run, (cfg, (2, 2), batch), dict(cpu, steps=2)),
            (mesh_runs.train_run, (cfg, (2, 4), batch),
             dict(cpu, return_params=False)),
            (mesh_runs.train_run, (k1, (2, 2), batch),
             dict(cpu, return_params=False))]
    jobs += [(mesh_runs.detect_run, (_cfg(preset, *_SERVING[layout]), (1, 2),
                             images), dict(cpu, tree=trees[layout],
                                           compare_unsharded=True))
             for layout in _SERVING]
    res = spawn(mesh_runs.run_jobs, 8, args=(jobs,), device="cpu",
                timeout_s=TIMEOUT,
                workdir=str(tmp_path_factory.mktemp("tp_ranks")))
    by_job = list(zip(*res))
    return by_job[:4], dict(zip(_SERVING, by_job[4:])), trees


def _losses(ranks, step=0):
    live = [r for r in ranks if r is not None]
    losses = {r["metrics"][step]["loss"] for r in live}
    assert len(losses) == 1, losses   # every rank holds the global loss
    return losses.pop()


@pytest.mark.parametrize("job,shape", [(1, (2, 2)), (2, (2, 4))])
def test_dp_tp_matches_dp(runs, job, shape):
    """(2, 2) and (2, 4) meshes against the 4-wide data mesh: the loss
    within rel 1e-4 (tests/test_sharding.py's bar), fc6 column-parallel
    and fc7 row-parallel, each rank holding its part of the kernels."""
    train = runs[0]
    l_dp = _losses(train[0])
    assert _losses(train[job]) == pytest.approx(l_dp, rel=1e-4)
    r0 = train[job][0]
    n_model = shape[1]
    assert r0["tp_roles"]["fc6_f0"] == "col"
    assert r0["tp_roles"]["fc7_f0"] == "row"
    assert r0["head_shapes"]["fc6_f0.weight"][0] == 64 // n_model
    assert r0["head_shapes"]["fc7_f0.weight"][1] == 64 // n_model
    assert r0["head_shapes"]["fc7_f0.bias"] == (64,)


def test_tp_second_step_runs(runs):
    train = runs[0]
    ranks = train[1]
    assert all(r["step"] == 2 for r in ranks[:4])
    assert np.isfinite(_losses(ranks, step=1))
    assert _losses(ranks, step=1) == pytest.approx(_losses(train[0], 1),
                                                   rel=1e-4)


def test_tp_parameters_after_steps_match_dp(data, runs):
    """The (2, 2) mesh's whole parameters after two steps (its shards
    gathered) against one process's two steps: within 1e-6."""
    from multipathnet_tpu_torch.train.loop import Trainer

    cfg, batch = data
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(0)
    for _ in range(2):
        state, _ = trainer.step(state, batch)
    got = runs[0][1][0]["params"]
    for name, want in trainer.model.state_dict().items():
        np.testing.assert_allclose(got[name], want.numpy(), atol=1e-6,
                                   rtol=0, err_msg=name)


def test_cls_bbox_shards_only_when_its_dimension_divides(runs):
    """cls_bbox's 50 outputs (6 heads x 5 classes + 4 x 5) shard 2-way
    and not 4-way; with one integral head (25) not even 2-way."""
    train = runs[0]
    assert train[1][0]["tp_roles"]["cls_bbox"] == "col"
    assert train[1][0]["head_shapes"]["cls_bbox.weight"][0] == 25
    assert "cls_bbox" not in train[2][0]["tp_roles"]
    assert "cls_bbox" not in train[3][0]["tp_roles"]
    assert train[3][0]["head_shapes"]["cls_bbox.weight"][0] == 25
    assert np.isfinite(_losses(train[3]))


@pytest.mark.parametrize("layout", list(_SERVING))
def test_tp_serving_matches_unsharded_and_reference(data, runs, layout):
    """A (1, 2) mesh's serving head: the int8 layouts (SVD pairs
    included) equal the unsharded port head bit for bit (pre-NMS boxes
    and probabilities, and the detections: the int32 partials sum
    exactly), the float layouts within float32 summation order; all within
    the reference's GSPMD bars of its outputs (probabilities atol 1e-4,
    boxes 1e-3)."""
    cfg, batch = data
    ranks = runs[1][layout]
    quant, r6, r7 = _SERVING[layout]
    for r in ranks[:2]:
        got, want = r["scores"], r["unsharded"]["scores"]
        if quant == "none":
            np.testing.assert_allclose(got["probs"], want["probs"],
                                       atol=1e-6)
            np.testing.assert_allclose(got["boxes"], want["boxes"],
                                       atol=1e-4)
        else:
            for k in ("boxes", "probs"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            for k, v in r["unsharded"]["detections"].items():
                np.testing.assert_array_equal(r["detections"][k], v,
                                              err_msg=k)
    shapes = ranks[0]["head_state_shapes"]
    w = "weight_i8" if quant == "int8" else "weight"
    if layout == "svd_odd":
        assert {"fc6_f0_u", "fc6_f0"}.isdisjoint(ranks[0]["tp_roles"])
        assert ranks[0]["tp_roles"]["fc7_f0"] == "row"
    elif r6:
        assert ranks[0]["tp_roles"]["fc6_f0_u"] == "col"
        assert ranks[0]["tp_roles"]["fc6_f0"] == "row"
        assert shapes[f"fc6_f0_u.{w}"][0] == r6 // 2
    else:
        assert shapes[f"fc6_f0.{w}"][0] == 32   # half fc6's 64 columns
    ref_boxes, ref_probs = _reference_tp_scores(layout, runs[2][layout],
                                                batch)
    got = ranks[0]["scores"]
    np.testing.assert_allclose(got["probs"], ref_probs, atol=1e-4)
    np.testing.assert_allclose(got["boxes"], ref_boxes, atol=1e-3)
