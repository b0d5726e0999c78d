"""The port's measurement tools (multipathnet_tpu_torch/tools/), each
driven once at `tiny` on the CPU: soak_svd_decay (its float AP equal to a
Tester on the same parameters, every step in its TensorBoard events),
prop_quality_scale; and the card route of the truncated SVD (ops/lowrank.factorize_kernel_torch)
against the numpy one."""

import dataclasses
import math
import warnings

import numpy as np
import pytest
import torch

from multipathnet_tpu_torch.core.config import preset
from multipathnet_tpu_torch.data.coco import CocoLoader
from multipathnet_tpu_torch.data.proposals import ProposalStore
from multipathnet_tpu_torch.eval.tester import Tester
from multipathnet_tpu_torch.models import convert
from multipathnet_tpu_torch.models.multipath import build_model
from multipathnet_tpu_torch.ops import lowrank
from multipathnet_tpu_torch.tools import prop_quality_scale, soak_svd_decay
from multipathnet_tpu_torch.utils import tbevents

torch.set_num_threads(2)


@pytest.mark.parametrize("shape,rank", [((300, 100), 20), ((100, 300), 20),
                                        ((64, 48), 40)],
                         ids=["tall", "wide", "exact"])
def test_factorize_kernel_torch_matches_numpy(shape, rank):
    """The torch route (taken for kernels on the card) draws the numpy
    route's test matrix: the same product A B within float32 rounding
    (1e-4 x max |W|), A's columns orthonormal, the same truncation error
    within 1e-5; factorize_head_params keeps CPU tensors on the numpy
    route."""
    w = np.random.default_rng(rank).normal(size=shape).astype(np.float32)
    a, b = lowrank.factorize_kernel(w, rank)
    ta, tb = lowrank.factorize_kernel_torch(torch.from_numpy(w), rank)
    assert ta.shape == a.shape and tb.shape == b.shape
    np.testing.assert_allclose((ta @ tb).numpy(), a @ b,
                               atol=1e-4 * np.abs(w).max())
    np.testing.assert_allclose((ta.T @ ta).numpy(), np.eye(rank), atol=1e-4)
    assert abs(lowrank.truncation_rel_err(torch.from_numpy(w), ta, tb)
               - lowrank.truncation_rel_err(w, a, b)) < 1e-5
    with pytest.raises(ValueError):
        lowrank.factorize_kernel_torch(torch.from_numpy(w), min(shape) + 1)


def test_soak_svd_decay_at_tiny(tmp_path):
    """4 steps with weight decay 0.1, one snapshot: the float AP equals a
    Tester's on the trainer's parameters, the four configs give finite
    APs, the truncation errors lie in [0, 1], and the event file holds
    every step's loss and lr, equal to the JSONL rows."""
    cfg = preset("tiny")
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, lr=0.02, weight_decay=0.1, warmup_steps=0, total_steps=4))
    out = soak_svd_decay.soak(cfg, steps=4, snap_every=4, images=4,
                              eval_batch=2, workdir=str(tmp_path),
                              device="cpu", ranks=(16, 8))
    (row,) = out["snapshots"]
    assert row["step"] == 4 and len(out["losses"]) == 4
    assert all(math.isfinite(x) for x in out["losses"])
    for name in ("float", "int8", "svd", "int8+svd"):
        assert all(math.isfinite(v) for v in row[name].values()), name
    for lo, hi in (row["trunc_fc6"], row["trunc_fc7"]):
        assert 0.0 <= lo <= hi <= 1.0
    assert row["gap"] == row["float"]["AP"] - row["int8+svd"]["AP"]
    fx = out["split"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = Tester(build_model(cfg.model, device="cpu"), cfg,
                      CocoLoader(fx["annotations"], fx["images"]),
                      ProposalStore.load(fx["proposals"]),
                      params=convert.flax_from_state_dict(
                          out["trainer"].model.state_dict()),
                      device="cpu", batch_size=2).test()
    assert row["float"] == want
    seen = tbevents.read_scalars(out["tensorboard"])
    assert sorted(seen["loss"]) == [1, 2, 3, 4]
    assert sorted(seen["lr"]) == [1, 2, 3, 4]
    np.testing.assert_allclose([seen["loss"][s] for s in range(1, 5)],
                               out["losses"], rtol=1e-6)


def test_prop_quality_scale_at_tiny(tmp_path):
    cfg = preset("tiny")
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, num_classes=9),
        train=dataclasses.replace(cfg.train, lr=5e-3, warmup_steps=0,
                                  batch_size=2))
    rows = prop_quality_scale.run(cfg, epochs=2, images=4, max_objects=3,
                                  top_k=16, quality_every=1,
                                  workdir=str(tmp_path), device="cpu")
    assert [(r["epoch"], r["step"]) for r in rows] == [(1, 2), (2, 4)]
    for r in rows:
        assert math.isfinite(r["loss"])
        for q in (r["stage1"], r["cascade"]):
            assert len(q) == 4 and all(0.0 <= v <= 1.0 for v in q)
