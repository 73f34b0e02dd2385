"""A minimal inference server over an exported ``torch.export`` artifact
(``dusty_gan_tpu/cli/serve.py``): it loads ``generator.pt2`` and its
manifest once (``cli/export.py`` writes them) and serves generation over
HTTP with the Python standard library only: no model code and no web
framework.

    python -m dusty_gan_torch.cli.serve --export-dir exports/dusty2_kitti --port 8901

Endpoints:
    GET  /healthz    -> {"ok": true, "manifest": {...}}
    POST /generate   body {"batch": N, "seed": S}            (server latents)
                     or   {"latents": [[...], ...]}          (client latents)
                     ``?format=json`` returns nested lists; the default is an
                     ``.npz`` stream with depth / mask [/ points] arrays.

A fixed-batch artifact is padded to its batch and trimmed; a request above
that batch gets a 400.  Calls to the program go one at a time behind a
lock, and each copies its outputs to the host inside it.  Each call runs
under cuDNN's deterministic algorithms (``deterministic_convolutions``):
cuDNN's default float32 engines for the ConvTs sum with atomics, so
without the pin one seeded request could come back in other bits, and a
mask pixel near the threshold could flip; with it, an answer repeats per
seed, as the JAX server's does.  The program runs
on the device the manifest names (the GPU it was exported on); a GPU
artifact does not load without one.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from dusty_gan_torch import deterministic_convolutions
from dusty_gan_torch.utils.export import load_exported


class GeneratorService:
    """The exported call with batching and latent handling."""

    def __init__(self, export_dir: str):
        self.call, self.manifest = load_exported(export_dir)
        self.device = torch.device(self.manifest["device"])
        self.in_ch = int(self.manifest["in_ch"])
        batch = self.manifest.get("batch", "dynamic")
        self.fixed_batch = None if batch == "dynamic" else int(batch)
        self.lock = threading.Lock()

    def latents(self, req: dict) -> np.ndarray:
        if "latents" in req:
            z = np.asarray(req["latents"], np.float32)
            if z.ndim != 2 or z.shape[1] != self.in_ch or z.shape[0] < 1:
                raise ValueError(f"latents must be (batch, {self.in_ch}); got {z.shape}")
            return z
        batch = int(req.get("batch", 1))
        if batch < 1:
            raise ValueError(f"batch must be >= 1; got {batch}")
        seed = int(req.get("seed", 0))
        # seed-stable whatever the batch: one latent per (seed, index), the
        # JAX server's draws
        rows = [np.random.RandomState((seed * 1_000_003 + i) % (2**31 - 1)).randn(self.in_ch)
                for i in range(batch)]
        return np.asarray(rows, np.float32)

    def generate(self, z: np.ndarray) -> dict:
        n = z.shape[0]
        if self.fixed_batch is not None:
            if n > self.fixed_batch:
                raise ValueError(f"request batch {n} exceeds the artifact's fixed batch "
                                 f"{self.fixed_batch}; export again with a dynamic batch")
            z = np.pad(z, [(0, self.fixed_batch - n), (0, 0)], mode="edge")
        zt = torch.from_numpy(np.ascontiguousarray(z))
        # autograd's mode is per thread: each handler thread sets it itself
        with self.lock, deterministic_convolutions(), torch.inference_mode():
            out = self.call(zt.to(self.device))
            return {k: v[:n].cpu().numpy() for k, v in out.items()}


def _make_handler(service: GeneratorService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            if os.environ.get("DUSTY_SERVE_VERBOSE"):
                super().log_message(fmt, *args)

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path.split("?")[0] == "/healthz":
                self._send_json(200, {"ok": True, "manifest": service.manifest})
            else:
                self._send_json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            path, _, query = self.path.partition("?")
            if path != "/generate":
                self._send_json(404, {"error": f"no route {path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("the request body must be a JSON object")
                out = service.generate(service.latents(req))
            except (ValueError, TypeError, KeyError, json.JSONDecodeError) as e:
                self._send_json(400, {"error": str(e)})
                return
            if "format=json" in query:
                self._send_json(200, {k: v.tolist() for k, v in out.items()})
            else:
                buf = io.BytesIO()
                np.savez_compressed(buf, **out)
                self._send(200, buf.getvalue(), "application/octet-stream")

    return Handler


def make_server(export_dir: str, host: str = "127.0.0.1", port: int = 0):
    """(server, service); ``port=0`` picks a free port."""
    service = GeneratorService(export_dir)
    server = ThreadingHTTPServer((host, port), _make_handler(service))
    return server, service


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--export-dir", type=str, required=True)
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8901)
    args = parser.parse_args(argv)

    server, service = make_server(args.export_dir, args.host, args.port)
    print(f"serving {service.manifest.get('arch')} (batch={service.manifest.get('batch')}, "
          f"device={service.device}) on http://{args.host}:{server.server_address[1]}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
