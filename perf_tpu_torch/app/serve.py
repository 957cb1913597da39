"""Scene serving: render a trained scene over HTTP (``mode=serve``).

Counterpart of ``perf_tpu/app/serve.py:44-191``. The server owns a
``NeRFScene`` whose snapshot is baked once, or a ``PropNeRFScene``, which
has no snapshot and renders through its proposal cascade (``/info`` then
reports ``snapshot_baked: false``; JAX's server raises there, its prop
scene having no ``snapshot``); each request renders one frame on the
scene's device:

    GET /health                 -> {"status": "ok", ...}
    GET /info                   -> scene + snapshot metadata
    GET /render?px=&py=&pz=&yaw=&pitch=&cam=pano|pers[&q=rgb|distance]
                                -> image/png

One render resolution per server (``serve.height/width``); renders
serialize through a lock (one device queue). Standard-library HTTP only;
PNG encoding and the JET colouring come from ``utils/io.py``.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..core import gen_pano_rays, gen_pers_rays
from ..utils.io import colorize_single_channel_image, png_bytes


def _pose_from_query(q: dict) -> np.ndarray:
    """[4, 4] c2w from px/py/pz translation + yaw/pitch (radians, world
    z-up)."""
    px = float(q.get("px", ["0"])[0])
    py = float(q.get("py", ["0"])[0])
    pz = float(q.get("pz", ["0"])[0])
    yaw = float(q.get("yaw", ["0"])[0])
    pitch = float(q.get("pitch", ["0"])[0])
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    rot_yaw = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]],
                       np.float32)
    rot_pitch = np.array([[cp, 0.0, sp], [0.0, 1.0, 0.0], [-sp, 0.0, cp]],
                         np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = rot_yaw @ rot_pitch
    pose[:3, 3] = (px, py, pz)
    return pose


class SceneServer:
    """Owns the scene + baked snapshot; renders poses serially."""

    def __init__(self, scene, height: int = 512, width: int = 1024,
                 pers_fov_deg: float = 75.0):
        self.scene = scene
        self.height = int(height)
        self.width = int(width)
        self.pers_fov = float(np.deg2rad(pers_fov_deg))
        self._lock = threading.Lock()
        self.n_rendered = 0
        self.started = time.time()

    def warmup(self):
        """Render each camera once before serving (the first render bakes
        the snapshot of an occupancy scene)."""
        for cam in ("pano", "pers"):
            self.render(np.eye(4, dtype=np.float32), cam)

    def rays_for(self, pose: np.ndarray, cam: str = "pano"):
        dev = self.scene.device
        if cam == "pano":
            p = pose.copy()
            p[:3, :3] = np.eye(3)   # pano frames stay axis-aligned
            return gen_pano_rays(torch.from_numpy(p).to(dev), self.height,
                                 self.width)
        if cam == "pers":
            return gen_pers_rays(torch.from_numpy(pose).to(dev),
                                 fov=self.pers_fov, res=self.height)
        raise ValueError(f"cam must be pano|pers, got {cam!r}")

    def render(self, pose: np.ndarray, cam: str = "pano",
               query: str = "rgb") -> np.ndarray:
        rays = self.rays_for(pose, cam)
        with self._lock:
            out = self.scene.render_snapshot(rays, query_keys=(query,))
            arr = out[query].cpu().numpy()
            self.n_rendered += 1
        if query == "rgb":
            img = np.clip(arr, 0.0, 1.0)
        else:   # distance -> inverse-depth vis, as the offline dumps do
            img = colorize_single_channel_image(1.0 / np.maximum(arr, 1e-6))
        return (img * 255).astype(np.uint8)

    def info(self) -> dict:
        snap = self.scene.snapshot
        return {
            "render_height": self.height,
            "render_width": self.width,
            "device": str(self.scene.device),
            "snapshot_baked": snap is not None,
            "snapshot_rows": None if snap is None else int(snap.shape[0]),
            "n_rendered": self.n_rendered,
            "uptime_sec": round(time.time() - self.started, 1),
        }


def make_http_server(scene_server: SceneServer, host: str = "127.0.0.1",
                     port: int = 8080) -> ThreadingHTTPServer:
    """ThreadingHTTPServer around a SceneServer. The caller owns
    serve_forever / shutdown / server_close."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, ctype: str, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, payload: dict):
            self._send(code, "application/json", json.dumps(payload).encode())

        def do_GET(self):
            url = urlparse(self.path)
            try:
                if url.path == "/health":
                    self._json(200, {"status": "ok", **scene_server.info()})
                elif url.path == "/info":
                    self._json(200, scene_server.info())
                elif url.path == "/render":
                    q = parse_qs(url.query)
                    cam = q.get("cam", ["pano"])[0]
                    query = q.get("q", ["rgb"])[0]
                    if query not in ("rgb", "distance"):
                        self._json(400, {"error": "q must be rgb|distance"})
                        return
                    img = scene_server.render(_pose_from_query(q), cam, query)
                    self._send(200, "image/png", png_bytes(img))
                else:
                    self._json(404, {"error": f"no route {url.path}"})
            except (ValueError, KeyError) as e:
                self._json(400, {"error": str(e)})

    return ThreadingHTTPServer((host, port), Handler)


def serve_scene(scene, conf=None, block: bool = True):
    """CLI entry (``mode=serve``): warm up, bind, serve until interrupted.
    Returns the live server (``.scene_server`` attached) when
    ``block=False``; the caller then owns ``shutdown`` and
    ``server_close``."""
    get = (conf.get_path if conf is not None else lambda k, d=None: d)
    srv = SceneServer(scene,
                      height=int(get("serve.height", 512)),
                      width=int(get("serve.width", 1024)),
                      pers_fov_deg=float(get("serve.pers_fov_deg", 75.0)))
    srv.warmup()
    httpd = make_http_server(srv, host=str(get("serve.host", "127.0.0.1")),
                             port=int(get("serve.port", 8080)))
    httpd.scene_server = srv
    if not block:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return httpd
    print(f"serving on http://{httpd.server_address[0]}:"
          f"{httpd.server_address[1]}  (GET /render?px=..&cam=pano|pers)",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
