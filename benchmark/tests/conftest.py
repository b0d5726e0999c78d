"""Fixtures of the benchmark's own tests: a checkout root holding one tiny
serving cell, so that a whole run fits on the CPU."""

from __future__ import annotations

import json
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TINY_MODEL = {"skip_reduce_dim": 16, "fc_dim": 32, "fc6_rank": 8,
              "fc7_rank": 8, "num_classes": 5}
TINY_EVAL = {"pre_nms_per_class": 8, "max_detections": 10}
TINY_MIX = {"kind": "detect", "batch": 2, "canvas": 64, "long_side": 64,
            "short_side": [40, 64], "proposals": 12, "xy_frac": 0.7,
            "side": [4, 0.3], "pool": 2, "score_threshold": 0.0,
            "check_batches": 2}


def tiny_root(path, limits=None) -> str:
    """A checkout at `path`: BENCHMARK.json with the one cell "tiny" of the
    int8+SVD configuration cut to a CPU's size."""
    spec = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    conf = json.load(open(os.path.join(
        REPO, "benchmark", "configs", "multipath_vgg16_int8_svd.json")))
    conf["model"].update(TINY_MODEL)
    conf["eval"].update(TINY_EVAL)
    if limits:
        conf["limits"].update(limits)
    os.makedirs(os.path.join(path, "benchmark", "traffic"))
    with open(os.path.join(path, "tiny.json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(path, "benchmark", "traffic", "tiny.json"),
              "w") as f:
        json.dump(TINY_MIX, f)
    spec["configs"] = [dict(spec["configs"][0], name="tiny",
                            file="tiny.json")]
    spec["workloads"] = [{"name": "tiny", "config": "tiny",
                          "traffic": "tiny", "chips": 1, "why": "test"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = (["tiny"] if "serve_int8svd_p1000"
                              in m["workloads"] else [])
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return str(path)


@pytest.fixture
def tiny(tmp_path):
    return tiny_root(tmp_path)


TINY_TRAIN_MIX = dict(TINY_MIX, kind="train", pool=3, gt=[1, 3], max_gt=4,
                      gt_classes=[1, 5])
del TINY_TRAIN_MIX["score_threshold"], TINY_TRAIN_MIX["check_batches"]


def tiny_train_root(path, limits=None) -> str:
    """A checkout at `path` with the one cell "tiny_train": the training
    configuration cut to a CPU's size."""
    spec = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    conf = json.load(open(os.path.join(
        REPO, "benchmark", "configs", "multipath_vgg16_train.json")))
    conf["model"].update({k: v for k, v in TINY_MODEL.items()
                          if not k.endswith("_rank")})
    conf["data"]["rois_per_image"] = 8
    if limits:
        conf["limits"].update(limits)
    os.makedirs(os.path.join(path, "benchmark", "traffic"))
    with open(os.path.join(path, "tiny_train.json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(path, "benchmark", "traffic", "tiny_train.json"),
              "w") as f:
        json.dump(TINY_TRAIN_MIX, f)
    cfg = next(c for c in spec["configs"] if c["name"] ==
               "multipath_vgg16_train")
    spec["configs"] = [dict(cfg, name="tiny_train", file="tiny_train.json")]
    spec["workloads"] = [{"name": "tiny_train", "config": "tiny_train",
                          "traffic": "tiny_train", "chips": 1,
                          "why": "test"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = (["tiny_train"] if "train_vgg16_b8"
                              in m["workloads"] else [])
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return str(path)


@pytest.fixture
def tiny_train(tmp_path):
    return tiny_train_root(tmp_path)
