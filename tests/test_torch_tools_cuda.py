"""On the card: int8 serving in max mode (GPU against CPU), the
profiling helpers fencing and tracing the card, and debug_nans on a CUDA
NaN.

Marked `cuda`: each test skips where torch.cuda.is_available() is false
(decided inside the fixture, never at import). Run on a GPU machine with
    python -m pytest tests/test_torch_tools_cuda.py --noconftest -m cuda -q
(tests/conftest.py imports jax, which a GPU machine need not have).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from multipathnet_tpu_torch.core.config import preset
from multipathnet_tpu_torch.eval.detect import Detector, score_batch
from multipathnet_tpu_torch.models import convert
from multipathnet_tpu_torch.models.multipath import build_model, init_params_
from multipathnet_tpu_torch.utils import profiling

# roi_pool's kernels and its placement GEMMs on the card
POOL_KERNELS = ("window_pool_multi", "window_pool_multi_quant",
                "resident_pool", "resident_pool_quant", "window_pool",
                "window_grad", "window_rmw_grad", "placements")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("ranks", [(0, 0), (16, 8)], ids=["int8",
                                                          "int8_svd"])
def test_tiny_int8_max_mode_on_gpu_matches_cpu(cuda, ranks):
    """int8 serving with roi_mode="max" (the exact route) at `tiny` in
    float32, GPU against CPU from one float tree transformed at load: the
    pool runs in plain ops with no epilogue, so no pool kernel launches,
    and the head quantizes its rows. Probabilities atol 2e-3, boxes 5e-2
    (a pooled value one ulp apart can flip an int8 code at a tie)."""
    cfg = preset("tiny")
    fcfg = cfg.replace(model=dataclasses.replace(
        cfg.model, dtype="float32", roi_mode="max", roi_impl="direct"))
    fmodel = init_params_(build_model(fcfg.model, device="cpu"),
                          torch.Generator().manual_seed(0))
    tree = convert.flax_from_state_dict(fmodel.state_dict())
    qcfg = fcfg.replace(model=dataclasses.replace(
        fcfg.model, head_quant="int8", fc6_rank=ranks[0], fc7_rank=ranks[1]))
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (2, 60, 64, 3), dtype=np.uint8)
    hws = np.asarray([[60, 64], [50, 41]], np.float32)
    xy = rng.uniform(0, 40, (2, 24, 2))
    wh = rng.uniform(6, 24, (2, 24, 2))
    props = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    before = profiling.counters()
    outs = []
    for dev in ("cpu", cuda):
        det = Detector(build_model(qcfg.model, device=dev), qcfg,
                       params=tree)
        outs.append(score_batch(det.model, qcfg, *(
            torch.from_numpy(x).to(dev) for x in (images, hws, props))))
        dets = det(images, hws, props, np.ones((2, 24), bool))
        assert dets["boxes"].shape == (2, qcfg.eval.max_detections, 4)
    launched = profiling.kernel_launches(before)
    assert not any(launched[k] for k in POOL_KERNELS), launched
    (want_b, want_p), (got_b, got_p) = outs
    assert torch.isfinite(got_p).all() and torch.isfinite(got_b).all()
    torch.testing.assert_close(got_p.cpu(), want_p, rtol=0, atol=2e-3)
    torch.testing.assert_close(got_b.cpu(), want_b, rtol=0, atol=5e-2)


def test_timed_fences_the_card(cuda, monkeypatch):
    """timed synchronizes the output's device once after the warm-up and
    once after the timed calls, and the time covers the device work: a
    device sleep of about 2 ms a call is not missed."""
    seen = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: seen.append(d) or real(d))

    def sleep():
        torch.cuda._sleep(2_000_000)      # clock cycles: about 1-2 ms
        return torch.ones(4, device=cuda) * 2

    sec, out = profiling.timed(sleep, iters=5, warmup=1)
    assert len(seen) == 2 and all(torch.device(d) == out.device
                                  for d in seen)
    assert sec > 5e-4 and torch.equal(out.cpu(), torch.full((4,), 2.0))


def test_trace_records_the_card(cuda, tmp_path):
    x = torch.randn(512, 512, device=cuda)
    with profiling.trace(str(tmp_path)):
        (x @ x).sum().item()
    (name,) = os.listdir(tmp_path)
    text = (tmp_path / name).read_text()
    assert '"cat": "kernel"' in text, "no device kernel in the trace"


def test_debug_nans_on_the_card(cuda):
    with pytest.raises(FloatingPointError):
        with profiling.debug_nans():
            torch.zeros(4, device=cuda) / 0.0
    with profiling.debug_nans():
        (torch.ones(4, device=cuda) / 2.0).sum().item()
    assert not torch.is_anomaly_enabled()
