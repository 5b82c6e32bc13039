"""A minimal HTTP front end over `serve.Enhancer`.

Counterpart of `hybrid_diffusion_tpu/serve_http.py`, with the standard
library's ThreadingHTTPServer:

  POST /enhance   body: JPEG/PNG bytes → enhanced PNG bytes
                  (?size=WxH sets the output size)
  GET  /healthz   {"status": "ok", "requests": N}
  GET  /stats     request and error counts, mean latency, model size

The device work goes through one lock (one Enhancer, one card); decoding
and encoding run on the request threads, so they overlap across requests.
Decoding tries the native JPEG/PNG path (data/native.py), then cv2, then
PIL, as the JAX module does, and last the standard library's PNG decoder
(data/registry.py); encoding tries cv2, then PIL, then the standard
library's PNG writer. (The card's machine has neither cv2 nor PIL.)

Usage:
    python -m hybrid_diffusion_tpu_torch.serve_http --port 8787 \
        --weights docs/assets/flagship256_r5_fp16.npz --sampler dpm++2m \
        --ddim_step 5
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np


def _encode_png(img: np.ndarray) -> bytes:
    """RGB uint8 HWC -> PNG bytes (cv2, else PIL, else the stdlib)."""
    try:
        import cv2
    except ImportError:
        pass
    else:
        ok, buf = cv2.imencode(".png", img[..., ::-1])
        if not ok:
            raise RuntimeError("png encode failed")
        return buf.tobytes()
    try:
        from PIL import Image
    except ImportError:
        from .data.registry import _png_bytes

        return _png_bytes(img)
    out = io.BytesIO()
    Image.fromarray(img).save(out, format="PNG")
    return out.getvalue()


def _decode_any(data: bytes) -> Optional[np.ndarray]:
    """JPEG/PNG bytes -> RGB uint8 HWC, None when undecodable."""
    from .data.native import decode_image
    from .data.registry import _png_decode

    img = decode_image(data)  # native JPEG/PNG fast path
    if img is not None:
        return img
    try:
        import cv2
    except ImportError:
        pass
    else:
        arr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        return None if arr is None else arr[..., ::-1].copy()
    try:
        from PIL import Image, UnidentifiedImageError
    except ImportError:
        return _png_decode(data)
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except (UnidentifiedImageError, OSError):
        return None


class EnhancerServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, addr, enhancer):
        self.enhancer = enhancer
        self.device_lock = threading.Lock()  # one card, one sampler
        self.stats_lock = threading.Lock()   # handler threads update stats
        self.stats = {"requests": 0, "errors": 0, "total_ms": 0.0}
        super().__init__(addr, _Handler)

    def bump(self, *, errors: int = 0, requests: int = 0,
             total_ms: float = 0.0) -> None:
        with self.stats_lock:
            self.stats["errors"] += errors
            self.stats["requests"] += requests
            self.stats["total_ms"] += total_ms

    def snapshot(self) -> dict:
        with self.stats_lock:
            return dict(self.stats)


class _Handler(BaseHTTPRequestHandler):
    server: EnhancerServer

    def log_message(self, *a):  # quiet; the stats carry the signal
        pass

    def _reply(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, obj) -> None:
        self._reply(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):
        s = self.server.snapshot()
        if self.path.startswith("/healthz"):
            self._json(200, {"status": "ok", "requests": s["requests"]})
        elif self.path.startswith("/stats"):
            e = self.server.enhancer
            self._json(200, {
                **s,
                "mean_ms": round(s["total_ms"] / max(s["requests"], 1), 1),
                "model_size": e.size,
                "max_batch": e.max_batch,
            })
        else:
            self._json(404, {"error": "unknown path"})

    def _parse_size(self) -> Optional[tuple]:
        """?size=WxH -> (W, H), None when absent; ValueError on junk."""
        from urllib.parse import parse_qs, urlparse

        q = parse_qs(urlparse(self.path).query).get("size")
        if not q:
            return None
        w, _, h = q[0].lower().partition("x")
        size = (int(w), int(h))
        if size[0] <= 0 or size[1] <= 0:
            raise ValueError(q[0])
        return size

    def do_POST(self):
        if not self.path.startswith("/enhance"):
            self._json(404, {"error": "unknown path"})
            return
        try:
            size = self._parse_size()
        except ValueError:
            self.server.bump(errors=1)
            self._json(400, {"error": "bad size= parameter (want WxH)"})
            return
        n = int(self.headers.get("Content-Length", 0))
        img = _decode_any(self.rfile.read(n))
        if img is None:
            self.server.bump(errors=1)
            self._json(400, {"error": "undecodable image"})
            return
        t0 = time.time()
        with self.server.device_lock:
            out = self.server.enhancer.enhance([img])[0]
        ms = (time.time() - t0) * 1000
        if size is not None and (out.shape[1], out.shape[0]) != size:
            # The model's resolution stays fixed; the output is resized on
            # the host.
            from .data.registry import resize_image_wh

            out = resize_image_wh(out, size[0], size[1])
        self.server.bump(requests=1, total_ms=ms)
        self._reply(200, _encode_png(out), "image/png")


def serve(enhancer, host: str = "127.0.0.1", port: int = 8787,
          block: bool = True) -> EnhancerServer:
    """Start serving; block=False returns the running server (its thread
    is a daemon; call `shutdown()` and `server_close()` to stop it)."""
    server = EnhancerServer((host, port), enhancer)
    if block:
        print(f"[serve_http] listening on http://{host}:{server.server_port}")
        server.serve_forever()
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def main(argv=None) -> int:
    """The CLI: --host, --port, --max_batch, --weights (a flat params npz,
    by default the configuration's --pretrained_path), then any flag of the
    main CLI's configuration (the device is --device, "cuda" by default)."""
    import argparse

    from .config import parse_config
    from .serve import Enhancer

    p = argparse.ArgumentParser()
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--max_batch", type=int, default=1)
    p.add_argument("--weights", default=None)
    args, rest = p.parse_known_args(argv)
    cfg = parse_config(rest)
    weights = args.weights or cfg.pretrained_path
    if not weights:
        p.error("--weights (or --pretrained_path) names no params npz")
    serve(Enhancer(cfg, weights, max_batch=args.max_batch, device=cfg.device),
          host=args.host, port=args.port)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
