"""Port parity, the mesh (multipathnet_tpu_torch/core/mesh.py): the
reference's auto-mesh rule and tensor-parallel layout, the rank launcher,
the head's collectives, pipeline shards, and checkpoints across meshes.

Ranks are gloo processes on the CPU (core/mesh.spawn: a file rendezvous
under the test's tmp_path, one thread each, every launch with its own
timeout); their bodies live in modules that do not import jax
(tests/torch_mesh_workers.py, multipathnet_tpu_torch/tools/mesh_runs.py).
The reference side runs on the conftest's 8 virtual CPU devices."""

import dataclasses
import functools
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_workers as workers
from multipathnet_tpu_torch.core import mesh as tmesh
from multipathnet_tpu_torch.core.config import preset
from multipathnet_tpu_torch.data import synthetic
from multipathnet_tpu_torch.data.coco import CocoLoader
from multipathnet_tpu_torch.data.pipeline import DetectionPipeline
from multipathnet_tpu_torch.data.proposals import ProposalStore
from multipathnet_tpu_torch.models.heads import shard_head_, tp_dims
from multipathnet_tpu_torch.models.multipath import build_model
from multipathnet_tpu_torch.tools import mesh_runs
from multipathnet_tpu_torch.train.checkpoint import Checkpointer
from multipathnet_tpu_torch.train.loop import Batch, Trainer

TIMEOUT = 240  # seconds a launch may take before it fails


# ------------------------------------------------------------ the rules ---

@pytest.mark.parametrize("world", range(1, 9))
def test_largest_data_width_matches_reference(world):
    from multipathnet_tpu.core.mesh import DATA_AXIS, largest_data_mesh

    for batch in range(1, 17):
        want = largest_data_mesh(batch, jax.devices()[:world])
        assert tmesh.largest_data_width(batch, world) == \
            want.shape[DATA_AXIS], (batch, world)


def _layouts():
    cases = []
    for mesh in ((1, 2), (2, 2), (2, 4)):
        for layout in ("float", "int8", "svd", "svd_int8", "svd_odd",
                       "k1"):
            cases.append((mesh, layout))
    return cases


@functools.lru_cache(maxsize=None)
def _reference_tree(layout):
    """A reference head tree of `layout` at `tiny` (fc_dim 64): float,
    int8, truncated-SVD (fc6 rank 16, fc7 rank 8; odd: fc6 rank 15, fc7
    unfactored), or one integral head (cls_bbox's 25 columns divide no
    model axis)."""
    from multipathnet_tpu.core.config import preset as jpreset
    from multipathnet_tpu.models.multipath import build_model as jbuild
    from multipathnet_tpu.ops.lowrank import factorize_head_params
    from multipathnet_tpu.ops.quant import quantize_head_params

    cfg = jpreset("tiny")
    if layout == "k1":
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, integral_thresholds=(0.5,)))
    shapes = jax.eval_shape(jbuild(cfg.model).init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 1, 4)))
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(
        np.float32), shapes)
    ranks = {"svd": (16, 8), "svd_int8": (16, 8), "svd_odd": (15, 0)}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # random weights: a flat spectrum
        if layout in ranks:
            tree = factorize_head_params(tree, *ranks[layout])
    if layout in ("int8", "svd_int8"):
        tree = quantize_head_params(tree)
    return cfg, tree, ranks.get(layout, (0, 0))


@pytest.mark.parametrize("mesh_shape,layout", _layouts())
def test_head_layout_matches_reference(mesh_shape, layout):
    """MeshRules.head_layout against the reference's
    MeshRules.tree_sharding, leaf by leaf of the head; then shard_head_
    on a port head of the same layout keeps, on model rank 0, each
    tensor's part of the shape the reference's spec gives a shard."""
    from multipathnet_tpu.core.mesh import MODEL_AXIS, MeshRules, make_mesh

    jcfg, tree, (r6, r7) = _reference_tree(layout)
    n_model = mesh_shape[1]
    specs = MeshRules(make_mesh(*mesh_shape)).tree_sharding(tree)
    head, head_specs = tree["params"]["head"], specs["params"]["head"]
    u_names = {n for n in head if n.endswith("_u")}
    rules = tmesh.MeshRules(n_model)
    sharded = {}
    for layer, leaves in head.items():
        if not isinstance(leaves, dict):
            continue
        for leaf, value in leaves.items():
            spec = tuple(head_specs[layer][leaf].spec)
            want = spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None
            got = rules.head_layout(f"{layer}/{leaf}", value.shape, u_names)
            assert got == want, (layer, leaf, value.shape, spec)
            if want is not None:
                sharded[(layer, leaf)] = want

    # the port's head: build it in this layout and shard it for rank 0
    cfg = preset("tiny")
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, integral_thresholds=jcfg.model.integral_thresholds,
        head_quant="int8" if "int8" in layout else "none",
        fc6_rank=r6, fc7_rank=r7, dtype="float32"))
    model = build_model(cfg.model, device="cpu")
    full = {k: tuple(v.shape) for k, v in model.head.state_dict().items()}
    mesh = tmesh.Mesh(mesh_shape[0], n_model, 0, 0, torch.device("cpu"))
    shard_head_(model.head, mesh)
    local = {k: tuple(v.shape) for k, v in model.head.state_dict().items()}
    dims = tp_dims(model.head)
    names = {"kernel": "weight", "kernel_i8": "weight_i8",
             "kernel_scale": "weight_scale", "bias": "bias"}
    want_dims = {}
    for (layer, leaf), axis in sharded.items():
        name = f"{layer}.{names[leaf]}"
        # torch stores the (in, out) kernels as (out, in)
        want_dims[name] = 1 - axis if leaf.startswith("kernel") and \
            leaf != "kernel_scale" else axis
    assert dims == want_dims
    for name, shape in full.items():
        want = list(shape)
        if name in dims:
            want[dims[name]] //= n_model
        assert local[name] == tuple(want), name
    if layout == "k1":
        assert "cls_bbox" not in model.head.tp_roles
    if layout == "svd_odd":
        assert not {"fc6_f0_u", "fc6_f0"} & set(model.head.tp_roles)
        assert model.head.tp_roles["fc7_f0"] == "row"


# ------------------------------------------------------------- launches ---

def test_spawn_raises_when_a_rank_fails(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 says no"):
        tmesh.spawn(workers.fail_on_rank, 2, args=(1, "rank 1 says no"),
                    timeout_s=TIMEOUT, workdir=str(tmp_path))


def test_spawn_stops_ranks_past_their_timeout(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        tmesh.spawn(workers.sleep, 2, args=(600,), timeout_s=6,
                    workdir=str(tmp_path))
    assert time.monotonic() - t0 < 30


def test_nccl_refuses_ranks_sharing_a_card(tmp_path):
    """Two NCCL ranks need two cards; the launcher refuses before it
    starts a rank (on this machine there are fewer than two)."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("two cards: NCCL ranks each get one")
    with pytest.raises(RuntimeError, match="NCCL needs a card per rank"):
        tmesh.spawn(workers.sleep, 2, args=(0,), device="cuda",
                    timeout_s=TIMEOUT, workdir=str(tmp_path))


def test_mesh_groups_and_head_collectives(tmp_path):
    """A (2, 2) mesh over 4 ranks: each rank's coordinate, a (1, 2) mesh
    leaving ranks 2 and 3 out (None), the groups' sums and maxima, and a
    column-parallel, row-parallel, gathered and split chain of layers
    equal to the unsharded chain in loss and every gradient part."""
    res = tmesh.spawn(workers.collectives, 4, args=((2, 2), (1, 2)),
                      timeout_s=TIMEOUT, workdir=str(tmp_path))
    assert [r["coord"] for r in res] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [r["narrow"] for r in res] == [(0, 0), (0, 1), None, None]
    for r in res:
        assert r["sum"] == 4.0
        np.testing.assert_allclose(*r["loss"], rtol=1e-6)
        assert r["max_err"] < 1e-4 * max(1.0, abs(r["loss"][1])), r
    assert [r["max"] for r in res] == [2.0, 3.0, 2.0, 3.0]


def test_spawned_ranks_import_no_jax(tmp_path):
    """Ranks launched from this process (which has jax) run a train step
    and a Detector batch of the port and import no module of jax, flax,
    optax or the JAX package."""
    cfg = preset("tiny")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dtype="float32"),
                      train=dataclasses.replace(cfg.train, batch_size=2))
    rng = np.random.default_rng(0)
    p = cfg.data.max_proposals
    boxes = rng.uniform(0, 40, (2, p, 2)).astype(np.float32)
    boxes = np.concatenate([boxes, boxes + 16], -1)
    gt = boxes[:, :cfg.data.max_gt_per_image]
    batch = Batch(rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8),
                  np.full((2, 2), 64, np.float32), boxes,
                  np.ones((2, p), bool), gt, np.ones(gt.shape[:2], np.int32),
                  np.ones(gt.shape[:2], bool))
    jobs = [(mesh_runs.train_run, (cfg, (2, 1), batch), dict(return_params=False)),
            (mesh_runs.detect_run, (cfg, (2, 1), batch[:4]), dict(normal_seed=0))]
    res = tmesh.spawn(workers.jobs_then_modules, 2, args=(jobs,),
                      timeout_s=TIMEOUT, workdir=str(tmp_path))
    assert res == [[], []]


# -------------------------------------------------------------- shards ---

@pytest.fixture(scope="module")
def split(tmp_path_factory):
    fx = synthetic.generate(str(tmp_path_factory.mktemp("mesh_ds")),
                            num_images=8, image_size=64, num_classes=4,
                            proposals_per_image=16, seed=31)
    return (CocoLoader(fx["annotations"], fx["images"]),
            ProposalStore.load(fx["proposals"]), fx)


@pytest.mark.parametrize("count", [2, 4])
def test_pipeline_shards_make_the_single_process_batch(split, count):
    """DetectionPipeline(shard=(i, count)): the ranks' parts of every
    batch, concatenated in rank order, equal the single-process batch bit
    for bit, for training epochs (masks included) and eval batches; each
    shard decodes only its rows."""
    loader, props, _ = split
    cfg = preset("tiny").data

    def pipe(shard):
        return DetectionPipeline(loader, props, cfg, batch_size=4, seed=3,
                                 with_masks=True, shard=shard)

    whole = pipe((0, 1))
    parts = [pipe((i, count)) for i in range(count)]
    for epoch in (0, 1):
        for want, *got in zip(whole.epoch(epoch),
                              *(p.epoch(epoch) for p in parts)):
            for field, w in zip(want._fields, want):
                np.testing.assert_array_equal(
                    np.concatenate([getattr(g, field) for g in got]), w,
                    err_msg=field)
    for (wi, want), *got in zip(whole.eval_batches(),
                                *(p.eval_batches() for p in parts)):
        assert all(gi == wi for gi, _ in got)
        for field, w in zip(want._fields, want):
            np.testing.assert_array_equal(
                np.concatenate([getattr(g, field) for _, g in got]), w)
    assert all(p.examples_decoded == whole.examples_decoded // count
               for p in parts)
    with pytest.raises(ValueError):
        DetectionPipeline(loader, props, cfg, batch_size=3, shard=(0, 2))


# --------------------------------------------------------- checkpoints ---

def test_checkpoint_restores_across_meshes(split, tmp_path):
    """A checkpoint saved on a (2, 2) mesh (tensor-parallel head, the
    shards gathered whole by the first rank's write) restores on (1, 1)
    and on (2, 4) to the same whole parameters, bit for bit, and the
    (2, 4) trainer takes a step from it."""
    loader, props, _ = split
    cfg = preset("tiny")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dtype="float32"),
                      train=dataclasses.replace(cfg.train, batch_size=4))
    batch = next(DetectionPipeline(loader, props, cfg.data, batch_size=4,
                                   seed=0).epoch(0))
    ckpt = str(tmp_path / "ckpt")
    jobs = [(mesh_runs.train_run, (cfg, (2, 2), batch), dict(save_dir=ckpt)),
            (mesh_runs.train_run, (cfg, (2, 4), batch),
             dict(steps=0, restore_dir=ckpt)),
            (mesh_runs.train_run, (cfg, (2, 4), batch),
             dict(restore_dir=ckpt, return_params=False))]
    res = tmesh.spawn(mesh_runs.run_jobs, 8, args=(jobs,), timeout_s=TIMEOUT,
                      workdir=str(tmp_path))
    saved, on24, stepped = res[0]
    assert saved["tp_roles"]["fc6_f0"] == "col" and on24["step"] == 1
    for name, want in saved["params"].items():
        np.testing.assert_array_equal(on24["params"][name], want,
                                      err_msg=name)
    assert np.isfinite(stepped["metrics"][0]["loss"])
    assert stepped["step"] == 2

    trainer = Trainer(cfg, device="cpu")
    state = Checkpointer(ckpt).restore_latest(trainer,
                                              trainer.init_state())
    assert state.step == 1
    for name, t in trainer.model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), saved["params"][name],
                                      err_msg=name)


def test_checkpoint_save_takes_the_first_ranks_branch(tmp_path):
    """Saving one step twice on a (2, 1) mesh into a directory of each
    rank's own (only the first rank sees its write): both ranks skip the
    second save, as the first rank decides, and do not split around the
    write's barrier; the first rank alone writes."""
    cfg = preset("tiny")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dtype="float32"),
                      train=dataclasses.replace(cfg.train, batch_size=2))
    res = tmesh.spawn(workers.save_twice, 2, args=(cfg, str(tmp_path)),
                      timeout_s=60, workdir=str(tmp_path))
    assert res == [[0], []]
