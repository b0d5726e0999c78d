"""The control at each cell's own size on the card: the reference in the
precision below the configuration's, put in the program's place, reads
above the configuration's limits. Marked `cuda`; it skips where there is
no card. On a card:
    python -m pytest benchmark/tests -m cuda -q
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from benchmark import calibrate, harness
from benchmark.entries import serve, train
from benchmark.reference import multipath as ref

from conftest import REPO

SPEC = json.load(open(os.path.join(REPO, "BENCHMARK.json")))


def cells(entry):
    out = []
    for w in SPEC["workloads"]:
        conf = harness.find(SPEC["configs"], w["config"], "config")
        if json.load(open(os.path.join(REPO, conf["file"])))["entry"] == entry:
            out.append(w["name"])
    return out


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells("serve"))
def test_serve_control_fails(card, cell):
    _, _, config, mix = harness.load_cell(REPO, cell)
    cfg = serve.program_config(config, mix)
    got = calibrate.control_readings(cfg, config, mix, 11, card)
    assert any(got[k] > config["limits"][k] for k in got), got


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells("train"))
def test_train_control_fails(card, cell):
    _, _, config, mix = harness.load_cell(REPO, cell)
    cfg = train.program_config(config, mix)
    got = calibrate.train_substitute(cfg, config, mix, 11, card,
                                     ref.Precision(True, 0))
    assert any(got[k] > config["limits"][k] for k in got), got
