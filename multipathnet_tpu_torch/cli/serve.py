"""HTTP detection service over a serving bundle — port of
multipathnet_tpu/cli/serve.py.

    python -m multipathnet_tpu_torch.cli.serve --bundle BUNDLE --port 8000 \
        [--warmup] [--device cpu]

Standard library only (http.server, one request at a time: requests share
one model on one device, so a threaded front would only reorder the same
work).

Protocol (JSON in, JSON out):

  POST /detect
    {"images": [[...HxWx3 uint8...], ...],          # per-image nested lists
     "proposals": [[[x1,y1,x2,y2], ...], ...]}      # per-image box lists
  -> {"detections": [{"boxes": [[x1,y1,x2,y2]...],
                      "scores": [...], "classes": [...]}, ...],
      "batch_ms": float, "decode_ms": float}
  Errors (an image larger than the canvas, more proposals than the
  bundle's max_proposals, mismatched lists, malformed JSON) -> 400
  {"error": "..."}.

  GET /healthz -> {"ok": true, "config": "<preset name>", ...,
                   "kernel_launches": {kernel: launches so far}}

Images may be any size up to the bundle's canvas; each request is padded
to the bundle's batch, canvas and proposal count, and split into batches
when it holds more images. --warmup runs one padded batch before the
server accepts traffic (the kernel build and cuDNN/cuBLAS selection).
`batch_ms` is the detection (padding, copies, the detector, the lists
out); `decode_ms` reading and parsing the request body. The reply's
encoding is in neither.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class DetectionService:
    """Bundle -> padded-batch detection callable on one device (the card
    unless the caller names another)."""

    def __init__(self, bundle_dir: str, batch_size: int = 0, device=None):
        import dataclasses

        from multipathnet_tpu_torch.eval.detect import Detector
        from multipathnet_tpu_torch.eval.serving import load_bundle

        cfg, model, params = load_bundle(bundle_dir, device=device)
        if batch_size:
            cfg = cfg.replace(train=dataclasses.replace(
                cfg.train, batch_size=batch_size))
        self.cfg = cfg
        self.batch = max(cfg.train.batch_size, 1)
        self.canvas = cfg.data.image_size
        self.max_proposals = cfg.data.max_proposals
        self.detector = Detector(model, cfg, params=params)

    def warmup(self) -> float:
        """One padded batch through the detector; -> seconds."""
        t0 = time.time()
        self(np.zeros((1, 16, 16, 3), np.uint8), [[[0.0, 0.0, 8.0, 8.0]]])
        return time.time() - t0

    def __call__(self, images, proposals_per_image):
        """images: a list or array of HxWx3 uint8 (H, W <= canvas);
        proposals: a list of (Pi <= max_proposals, 4) float lists. Pads to
        the (batch, canvas, max_proposals) shapes and splits requests
        larger than the batch. Raises ValueError (-> HTTP 400) on inputs
        beyond those shapes — never silently truncates."""
        n = len(images)
        if n != len(proposals_per_image):
            raise ValueError(f"{n} images but "
                             f"{len(proposals_per_image)} proposal lists")
        ch, cw = self.canvas
        out = []
        for lo in range(0, n, self.batch):
            k = min(lo + self.batch, n) - lo
            imgs = np.zeros((self.batch, ch, cw, 3), np.uint8)
            hws = np.ones((self.batch, 2), np.float32)
            props = np.zeros((self.batch, self.max_proposals, 4), np.float32)
            mask = np.zeros((self.batch, self.max_proposals), bool)
            for i in range(k):
                im = np.asarray(images[lo + i], np.uint8)
                h, w = im.shape[:2]
                if h > ch or w > cw:
                    raise ValueError(
                        f"image {h}x{w} exceeds serving canvas {ch}x{cw}")
                imgs[i, :h, :w] = im
                hws[i] = (h, w)
                p = np.asarray(proposals_per_image[lo + i],
                               np.float32).reshape(-1, 4)
                if len(p) > self.max_proposals:
                    raise ValueError(
                        f"{len(p)} proposals exceed the bundle's "
                        f"max_proposals={self.max_proposals}; re-export the "
                        f"bundle with a larger data.max_proposals or send "
                        f"the top-{self.max_proposals}")
                props[i, :len(p)] = p
                mask[i, :len(p)] = True
            res = self.detector(imgs, hws, props, mask)
            for i in range(k):
                valid = res["valid"][i].astype(bool)
                out.append({
                    "boxes": res["boxes"][i][valid].round(2).tolist(),
                    "scores": res["scores"][i][valid].round(4).tolist(),
                    "classes": res["classes"][i][valid].astype(int).tolist(),
                })
        return out


def make_handler(service: DetectionService):
    from http.server import BaseHTTPRequestHandler

    from multipathnet_tpu_torch.ops import roi_pool

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *a):  # access logs to stderr
            log(f"serve: {fmt % a}")

        def do_GET(self):
            if self.path != "/healthz":
                return self._reply(404, {"error": "unknown path"})
            self._reply(200, {
                "ok": True, "config": service.cfg.name,
                "backbone": service.cfg.model.backbone,
                "head_quant": service.cfg.model.head_quant,
                "batch": service.batch,
                "canvas": list(service.canvas),
                "max_proposals": service.max_proposals,
                "kernel_launches": roi_pool.launch_counts(),
            })

        def do_POST(self):
            if self.path != "/detect":
                return self._reply(404, {"error": "unknown path"})
            try:
                t0 = time.perf_counter()
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n))
                t1 = time.perf_counter()
                dets = service(req["images"], req["proposals"])
                t2 = time.perf_counter()
                self._reply(200, {"detections": dets,
                                  "batch_ms": round((t2 - t1) * 1e3, 2),
                                  "decode_ms": round((t1 - t0) * 1e3, 2)})
            except Exception as e:  # surface the error to the client
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--bundle", required=True, help="serving bundle directory")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch-size", type=int, default=0,
                   help="override the bundle's serving batch size")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="run on the CUDA card (default) or the CPU")
    p.add_argument("--warmup", action="store_true",
                   help="run one batch before accepting traffic")
    args = p.parse_args(argv)

    service = DetectionService(args.bundle, batch_size=args.batch_size,
                               device=args.device)
    if args.warmup:
        log("serve: warmup...")
        log(f"serve: warm in {service.warmup():.1f}s")

    from http.server import HTTPServer

    httpd = HTTPServer((args.host, args.port), make_handler(service))
    log(f"serve: listening on {args.host}:{httpd.server_address[1]} "
        f"(batch {service.batch}, canvas {service.canvas}, "
        f"head_quant={service.cfg.model.head_quant})")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
