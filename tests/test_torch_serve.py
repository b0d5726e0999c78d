"""The HTTP detection service (cli/serve.py of the port) over an int8
serving bundle at `tiny` on the CPU, mirroring tests/test_serve.py: the
padding and splitting of requests, the rejections, the endpoints, the
detections equal to a Detector called directly, and `main` in a process of
its own."""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from multipathnet_tpu_torch.cli.serve import DetectionService, make_handler
from multipathnet_tpu_torch.core.config import preset
from multipathnet_tpu_torch.eval.detect import Detector
from multipathnet_tpu_torch.eval.serving import load_bundle, save_bundle
from multipathnet_tpu_torch.models import convert
from multipathnet_tpu_torch.models.multipath import build_model, init_params_

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(31)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A `tiny` bundle with an int8 head from a seeded float model."""
    cfg = preset("tiny")
    model = init_params_(build_model(cfg.model, device="cpu",
                                     param_dtype=torch.float32),
                         torch.Generator().manual_seed(3))
    out = str(tmp_path_factory.mktemp("bundle") / "b")
    save_bundle(out, cfg, convert.flax_from_state_dict(model.state_dict()),
                quant="int8")
    return out


def _images_and_props(n, hw=48):
    images = [RNG.integers(0, 255, (hw, hw, 3)).astype(np.uint8)
              for _ in range(n)]
    props = [[[2.0, 2.0, 30.0, 30.0], [10.0, 8.0, 44.0, 40.0]]
             for _ in range(n)]
    return images, props


def test_service_pads_and_splits(bundle):
    svc = DetectionService(bundle, device="cpu")  # tiny preset: batch 2
    assert svc.batch == 2 and svc.cfg.model.head_quant == "int8"
    # 3 images -> two padded device batches; variable image sizes
    images, props = _images_and_props(3)
    images[1] = images[1][:32, :40]  # a smaller image exercises hw padding
    dets = svc(images, props)
    assert len(dets) == 3
    for d in dets:
        assert set(d) == {"boxes", "scores", "classes"}
        assert len(d["boxes"]) == len(d["scores"]) == len(d["classes"])
        assert np.isfinite(np.asarray(d["scores"], np.float32)).all()
    # detections stay inside each image's true extent
    for b in dets[1]["boxes"]:
        assert b[2] <= 40.0 + 1e-3 and b[3] <= 32.0 + 1e-3
    assert DetectionService(bundle, batch_size=3, device="cpu").batch == 3


def test_service_equals_a_direct_detector(bundle):
    """Each image's detections are those of the bundle's Detector called on
    that image alone in a padded batch (the other slots empty)."""
    svc = DetectionService(bundle, device="cpu")
    cfg, model, params = load_bundle(bundle, device="cpu")
    det = Detector(model, cfg, params=params)
    images, props = _images_and_props(3, hw=64)
    got = svc(images, props)
    p = cfg.data.max_proposals
    for i, im in enumerate(images):
        imgs = np.zeros((2, 64, 64, 3), np.uint8)
        imgs[0] = im
        boxes = np.zeros((2, p, 4), np.float32)
        boxes[0, :2] = props[i]
        mask = np.zeros((2, p), bool)
        mask[0, :2] = True
        out = det(imgs, np.asarray([[64, 64], [1, 1]], np.float32), boxes,
                  mask)
        valid = out["valid"][0].astype(bool)
        assert got[i] == {
            "boxes": out["boxes"][0][valid].round(2).tolist(),
            "scores": out["scores"][0][valid].round(4).tolist(),
            "classes": out["classes"][0][valid].astype(int).tolist()}


def test_service_rejects_oversized_inputs(bundle):
    svc = DetectionService(bundle, device="cpu")
    images = [RNG.integers(0, 255, (100, 100, 3)).astype(np.uint8)]
    with pytest.raises(ValueError, match="exceeds serving canvas"):
        svc(images, [[[0.0, 0.0, 8.0, 8.0]]])
    ok = [RNG.integers(0, 255, (32, 32, 3)).astype(np.uint8)]
    with pytest.raises(ValueError, match="max_proposals"):
        svc(ok, [[[0.0, 0.0, 8.0, 8.0]] * 33])  # the bundle holds 32
    with pytest.raises(ValueError, match="proposal lists"):
        svc(ok, [])


def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/detect", data=payload,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_http_endpoints(bundle):
    from http.server import HTTPServer

    svc = DetectionService(bundle, device="cpu")
    httpd = HTTPServer(("127.0.0.1", 0), make_handler(svc))
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["head_quant"] == "int8"
        assert health["canvas"] == [64, 64] and health["batch"] == 2
        assert health["config"] == "tiny"
        # on the CPU the wrappers run their plain versions: no launch
        assert set(health["kernel_launches"]) >= {
            "window_pool_multi_quant", "resident_pool_quant",
            "int8_epilogue", "quantize_rows", "bn_epilogue"}
        assert not any(health["kernel_launches"].values())
        assert {f"launches.{k}" for k in health["kernel_launches"]} <= set(
            health["counters"])

        images, props = _images_and_props(2)
        out = _post(port, json.dumps({"images": [im.tolist()
                                                 for im in images],
                                      "proposals": props}).encode())
        assert len(out["detections"]) == 2 and out["batch_ms"] > 0
        assert out["decode_ms"] >= 0
        assert out["detections"] == svc(images, props)

        # malformed and oversized requests -> 400, the server stays up
        for body in (b'{"images": [[1]]}', b"not json", json.dumps(
                {"images": [np.zeros((80, 80, 3), int).tolist()],
                 "proposals": [[[0, 0, 4, 4]]]}).encode()):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(port, body)
            assert e.value.code == 400 and "error" in json.loads(
                e.value.read())
        for path in ("/nope", "/detect"):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                       timeout=30)
            assert e.value.code == 404
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            assert json.loads(r.read())["ok"]
    finally:
        httpd.shutdown()


def test_serve_main_in_a_process(bundle):
    """`python -m multipathnet_tpu_torch.cli.serve --warmup --port 0` on
    the CPU: it warms up, says where it listens, and answers /healthz and
    /detect."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "multipathnet_tpu_torch.cli.serve",
         "--bundle", bundle, "--port", "0", "--warmup", "--device", "cpu"],
        cwd=ROOT, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    try:
        lines = []
        for line in proc.stderr:
            lines.append(line)
            if "listening on" in line:
                break
        assert any("warm in" in x for x in lines), lines
        port = int(lines[-1].split("listening on 127.0.0.1:")[1].split()[0])
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            assert json.loads(r.read())["ok"]
        images, props = _images_and_props(1)
        out = _post(port, json.dumps({"images": [images[0].tolist()],
                                      "proposals": props}).encode())
        assert len(out["detections"]) == 1
    finally:
        proc.kill()
        proc.wait(timeout=30)
