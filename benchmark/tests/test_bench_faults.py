"""The check fails what it must: the control in the program's place, and
the timed path broken underneath, each seen through a whole tiny run on
the CPU (the card's look skipped). The limits here are the tiny size's
own, set between the program's readings there and the control's; the
cell's limits are set at its own size on the card (PERF.md)."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness, weights
from benchmark.entries import serve
from benchmark.reference import multipath as ref

from conftest import tiny_root, tiny_train_root

SERVE_LIMITS = {"prob_err": 1e-4, "box_err": 5e-5}
TRAIN_LIMITS = {"loss_gap": 1e-3, "grad_gap": 0.03, "update_gap": 0.5}
SEED = 1


def correct(root, cell) -> bool:
    metrics, out = harness.run_cell(root, cell, SEED, 0.1, False,
                                    torch.device("cpu"), time.perf_counter())
    return harness.result_line(metrics, out, {})["correct"]


@pytest.fixture
def serve_root(tmp_path):
    return tiny_root(tmp_path, SERVE_LIMITS)


@pytest.fixture
def train_root(tmp_path):
    return tiny_train_root(tmp_path, TRAIN_LIMITS)


def test_serve_sound_run_passes(serve_root):
    assert correct(serve_root, "tiny")


def test_serve_control_fails(serve_root, monkeypatch):
    """fp8 trunk and int4 head (the reference) in place of score_batch."""
    from multipathnet_tpu_torch.eval import detect

    _, _, config, mix = harness.load_cell(serve_root, "tiny")
    cfg = serve.program_config(config, mix)
    sd = weights.draw(serve.checkpoint_shapes(cfg), config["weights"], SEED,
                      torch.device("cpu"))

    def control(model, cfg, images, hws, props):
        probs, boxes = ref.detect_scores(sd, config["model"], mix["canvas"],
                                         images, hws, props,
                                         ref.Precision(True, 4))
        return boxes, probs

    monkeypatch.setattr(detect, "score_batch", control)
    assert not correct(serve_root, "tiny")


def _nms_fault(monkeypatch, change):
    from multipathnet_tpu_torch.ops import nms

    real = nms.multiclass_nms

    def broken(*args, **kwargs):
        out = real(*args, **kwargs)
        change(out)
        return out

    monkeypatch.setattr(nms, "multiclass_nms", broken)


def test_serve_altered_answer_fails(serve_root, monkeypatch):
    def change(out):
        out["scores"][0, 0] += 1e-3

    _nms_fault(monkeypatch, change)
    assert not correct(serve_root, "tiny")


def test_serve_half_batch_left_out_fails(serve_root, monkeypatch):
    def change(out):
        out["valid"][out["valid"].shape[0] // 2:] = False

    _nms_fault(monkeypatch, change)
    assert not correct(serve_root, "tiny")


def test_serve_altered_scores_fail(serve_root, monkeypatch):
    from multipathnet_tpu_torch.models.multipath import MultiPathNet

    real = MultiPathNet.predict_rois

    def broken(self, *args, **kwargs):
        scores, deltas = real(self, *args, **kwargs)
        return scores + 0.3 * (torch.arange(scores.shape[-1]) == 1), deltas

    monkeypatch.setattr(MultiPathNet, "predict_rois", broken)
    assert not correct(serve_root, "tiny")


def test_train_sound_run_passes(train_root):
    assert correct(train_root, "tiny_train")


def test_train_control_fails(train_root):
    """fp8 forward operands (the reference) in the program's place."""
    from benchmark import calibrate
    from benchmark.entries import train

    _, _, config, mix = harness.load_cell(train_root, "tiny_train")
    cfg = train.program_config(config, mix)
    got = calibrate.train_substitute(cfg, config, mix, SEED,
                                     torch.device("cpu"),
                                     ref.Precision(True, 0))
    assert any(got[k] > v for k, v in TRAIN_LIMITS.items()), got


def test_train_unchanged_state_fails(train_root, monkeypatch):
    from multipathnet_tpu_torch.train import schedule

    monkeypatch.setattr(schedule.Optimizer, "step",
                        lambda self: torch.zeros(()))
    assert not correct(train_root, "tiny_train")


def _loss_fault(monkeypatch, change):
    from multipathnet_tpu_torch.train import loop

    real = loop.detection_loss

    def broken(scores, deltas, sample, **kw):
        return change(real, scores, deltas, sample, **kw)

    monkeypatch.setattr(loop, "detection_loss", broken)


def test_train_half_batch_left_out_fails(train_root, monkeypatch):
    def change(real, scores, deltas, sample, **kw):
        half = scores.shape[0] // 2
        return real(scores[:half], deltas[:half],
                    type(sample)(*(x[:half] for x in sample)), **kw)

    _loss_fault(monkeypatch, change)
    assert not correct(train_root, "tiny_train")


def test_train_altered_loss_fails(train_root, monkeypatch):
    def change(real, *args, **kw):
        loss, metrics = real(*args, **kw)
        metrics["loss"] = loss * 1.01
        return loss * 1.01, metrics

    _loss_fault(monkeypatch, change)
    assert not correct(train_root, "tiny_train")


@pytest.mark.parametrize("fault", ["no_momentum", "schedule_restarted"])
def test_train_optimizer_fault_fails(train_root, fault):
    """Faults planted in the program's optimizer (calibrate.FAULTS) that
    the cell's limits catch on the card."""
    from benchmark import calibrate

    got = calibrate.program_readings("tiny_train", SEED, torch.device("cpu"),
                                     fault, root=train_root)
    assert any(got[k] > v for k, v in TRAIN_LIMITS.items()), got


@pytest.mark.parametrize("cell", ["tiny", "tiny_train"])
def test_calibrate_reads_a_sound_run(tmp_path, cell):
    """calibrate.py reads the program through a run of the harness."""
    from benchmark import calibrate

    root = (tiny_root(tmp_path, SERVE_LIMITS) if cell == "tiny"
            else tiny_train_root(tmp_path, TRAIN_LIMITS))
    got = calibrate.program_readings(cell, SEED, torch.device("cpu"),
                                     root=root)
    limits = SERVE_LIMITS if cell == "tiny" else TRAIN_LIMITS
    assert got.keys() >= limits.keys()
    assert all(got[k] <= v for k, v in limits.items()), got
