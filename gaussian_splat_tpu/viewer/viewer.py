"""Headless interactive viewer: device-rendered frames + live metrics.

Product-contract counterpart of the reference's app shell
(/root/reference/src/main.mm): an event loop that renders frames through the
framework and surfaces FPS / frame-time / point-count metrics. On an
accelerator host there is usually no display, so the viewer is headless-first:

  * `Viewer.render_frame()` — one camera→image step with stage timing.
  * `Viewer.orbit_turntable()` — offline turntable render (frames or video dir).
  * `Viewer.serve()` — zero-dependency MJPEG HTTP server (stdlib only): open
    http://host:port/ for a live view with click-drag orbit / wheel zoom via
    fetch callbacks — the headless stand-in for the reference's SDL window +
    trackball interaction (main.mm:101-151).

Metrics mirror the ImGui debug window (main.mm:162-182): FPS, frame ms,
per-stage ms, point count, camera position.
"""

from __future__ import annotations

import io
import json
import threading
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gaussian_splat_tpu.camera import Camera
from gaussian_splat_tpu.config import RenderConfig
from gaussian_splat_tpu.models.gaussians import GaussianModel
from gaussian_splat_tpu.ops.render import render
from gaussian_splat_tpu.utils.timing import ScopeTimer
from gaussian_splat_tpu.viewer.trackball import TrackballCamera


def to_uint8(image: jax.Array) -> np.ndarray:
    return np.asarray(
        jnp.clip(image * 255.0 + 0.5, 0, 255).astype(jnp.uint8)
    )


class Viewer:
    def __init__(
        self,
        model: GaussianModel,
        config: RenderConfig = RenderConfig(),
        width: int = 1280,
        height: int = 720,  # reference default viewport, main.mm:22-28
        overlay_objects: Optional[list] = None,  # default: grid + axes, like
        #   the reference scene (main.mm:61-62: Grid(10, 1.0), Axes(2.0))
        show_overlay: bool = True,
        hot_reload: bool = False,  # poll the Pallas kernel module's mtime
        #   every frame and hot-swap it, keeping the last good build on
        #   failure (reference: instanced_splat_renderer.mm:285-336, 430-432)
        background=(0.1, 0.1, 0.15),  # the reference's clear color
        #   (simple_geometry_renderer.mm:148-149)
        lod_fraction: float = 0.0,  # >0: render the top-impact subset
        #   (GaussianModel.lod) while the camera is being dragged/zoomed and
        #   the full model once idle — interactive degradation the reference
        #   never needed (its GPU rasterizer is per-frame cheap; our binning/
        #   gather stages scale with N)
        lod_pair_budget: float = 0.0,  # >0: pair-budget-aware drag subset
        #   instead — per-splat tile costs measured at the start pose
        #   (ops.render.measure_pair_costs), subset bounded to this fraction
        #   of the frame's tile-pair cost (GaussianModel.lod_pair_budget).
        #   Frame time is pair-proportional, so this bounds drag latency
        #   directly where lod_fraction only bounds N. Takes precedence.
    ):
        self.model = model
        self.config = config
        self.width = width
        self.height = height
        self.mode = "color"  # "color" | "depth" | "alpha" debug views
        self.background = background
        self.trackball = TrackballCamera()
        self.timers = ScopeTimer()
        self.lod_fraction = lod_fraction
        self.lod_pair_budget = lod_pair_budget
        if 0.0 < lod_pair_budget < 1.0:
            from gaussian_splat_tpu.ops.render import measure_pair_costs

            cam0 = self.trackball.camera(width, height)
            costs = measure_pair_costs(model, cam0, config)
            # value-ordered admission under the measured pair budget — the
            # selector that preserved the image best at a fixed pair spend
            # (see GaussianModel.lod_pair_budget's measured comparison)
            self._model_lod = model.lod_pair_budget(lod_pair_budget, costs)
        elif 0.0 < lod_fraction < 1.0:
            self._model_lod = model.lod(lod_fraction)
        else:
            self._model_lod = None
        self._interacting_until = 0.0

        from gaussian_splat_tpu.viewer import overlay as _ov

        self._overlay_mod = _ov
        if overlay_objects is None:
            overlay_objects = [_ov.grid(10, 1.0), _ov.axes(2.0)]
        self.overlay_objects = overlay_objects
        self.show_overlay = show_overlay

        def _build(module=None):
            # splats are rendered over BLACK so T_final carries the residual
            # for the overlay/background composite (reference pass order)
            cfg = config
            if cfg.background != (0.0, 0.0, 0.0):
                import dataclasses as _dc

                cfg = _dc.replace(cfg, background=(0.0, 0.0, 0.0))
            return jax.jit(lambda m, cam: render(m, cam, cfg)[:3])

        self._reloader = None
        if hot_reload:
            from gaussian_splat_tpu.utils.hot_reload import HotReloader

            probe_cam = self.trackball.camera(width, height)
            self._reloader = HotReloader(
                module_name="gaussian_splat_tpu.ops.pallas_raster",
                build=lambda module: _build(module),
                probe_args=(model, probe_cam),
            )
            self._render_jit = self._reloader.get()
        else:
            self._render_jit = _build()
        self._overlay_jit = jax.jit(
            lambda cam: self._overlay_mod.render_overlay(self.overlay_objects, cam)
        )

    # -- single frame --------------------------------------------------------
    def render_frame(self, camera: Optional[Camera] = None) -> np.ndarray:
        if self._reloader is not None:
            # per-frame mtime poll, like the reference's checkForShaderChanges
            # (instanced_splat_renderer.mm:430-432); cheap stat when unchanged
            self._render_jit = self._reloader.get()
        cam = camera or self.trackball.camera(self.width, self.height)
        model = self.model
        if self._model_lod is not None:
            import time as _time

            if _time.monotonic() < self._interacting_until:
                model = self._model_lod
        with self.timers.scope("frame") as h:
            h["result"] = self._render_jit(model, cam)
        image, alpha, depth = h["result"]
        if self.mode == "color":
            if self.show_overlay and self.overlay_objects:
                ov_rgb, ov_cov = self._overlay_jit(cam)
                image = self._overlay_mod.composite_over_background(
                    image, 1.0 - alpha, ov_rgb, ov_cov, self.background
                )
            else:
                image = image + (1.0 - alpha)[..., None] * jnp.asarray(
                    self.background, jnp.float32
                )
        if self.mode == "alpha":
            image = jnp.repeat(alpha[..., None], 3, axis=-1)
        elif self.mode == "depth":
            # normalized inverse-depth heat view (near = bright)
            a = jnp.maximum(alpha, 1e-6)
            d = depth / a
            inv = jnp.where(alpha > 0.05, 1.0 / jnp.maximum(d, 1e-3), 0.0)
            inv = inv / jnp.maximum(inv.max(), 1e-6)
            image = jnp.stack([inv, inv * 0.6, 1.0 - inv], axis=-1) * (
                alpha[..., None] > 0.05
            )
        return to_uint8(image)

    def resize(self, width: int, height: int) -> None:
        """Change the viewport (reference: main.mm:50-52 → resize(w, h)).
        The next frame re-jits for the new static shape; externally-supplied
        cameras can use `Camera.resized` for the same intrinsics scaling."""
        width = max(16, int(width))
        height = max(16, int(height))
        if (width, height) != (self.width, self.height):
            self.width, self.height = width, height

    def metrics(self) -> dict:
        frame = self.timers.stats.get("frame")
        ms = frame.mean if frame else 0.0
        return {
            "fps": 1000.0 / ms if ms > 0 else 0.0,
            "frame_ms": ms,
            "num_gaussians": self.model.num_gaussians,
            "resolution": [self.width, self.height],
            "camera_position": [float(v) for v in self.trackball.position],
        }

    # -- offline turntable ---------------------------------------------------
    def orbit_turntable(
        self,
        n_frames: int = 60,
        radius: float = 5.0,
        elevation_deg: float = 20.0,
        out_dir: Optional[str] = None,
    ):
        """Render an orbit; optionally save PNG frames. Returns the frames."""
        from gaussian_splat_tpu.camera import orbit_camera

        frames = []
        for i in range(n_frames):
            cam = orbit_camera(
                radius,
                360.0 * i / n_frames,
                elevation_deg,
                width=self.width,
                height=self.height,
            )
            frames.append(self.render_frame(cam))
        if out_dir is not None:
            import os

            from PIL import Image

            os.makedirs(out_dir, exist_ok=True)
            for i, f in enumerate(frames):
                Image.fromarray(f).save(f"{out_dir}/frame_{i:04d}.png")
        return frames

    # -- live HTTP viewer ----------------------------------------------------
    def serve(self, host: str = "127.0.0.1", port: int = 8000, block: bool = True):
        """Serve a live MJPEG view with mouse orbit/zoom controls."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def do_GET(self):
                if self.path == "/":
                    body = _INDEX_HTML.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path.startswith("/frame"):
                    frame = viewer.render_frame()
                    from PIL import Image

                    buf = io.BytesIO()
                    Image.fromarray(frame).save(buf, "JPEG", quality=90)
                    body = buf.getvalue()
                    self.send_response(200)
                    self.send_header("Content-Type", "image/jpeg")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/metrics":
                    body = json.dumps(viewer.metrics()).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path.startswith("/input"):
                    from urllib.parse import parse_qs, urlparse

                    q = parse_qs(urlparse(self.path).query)
                    kind = q.get("kind", [""])[0]
                    tb = viewer.trackball
                    if kind in ("down", "move", "scroll") and viewer._model_lod is not None:
                        import time as _time

                        # render the LOD subset while interacting, full model
                        # ~0.4 s after the last input
                        viewer._interacting_until = _time.monotonic() + 0.4
                    if kind == "down":
                        tb.handle_mouse_down(
                            float(q["x"][0]), float(q["y"][0]), int(q.get("b", ["0"])[0])
                        )
                    elif kind == "move":
                        tb.handle_mouse_move(
                            float(q["x"][0]), float(q["y"][0]), viewer.height
                        )
                    elif kind == "up":
                        tb.handle_mouse_up()
                    elif kind == "scroll":
                        tb.handle_scroll(float(q["dy"][0]))
                    elif kind == "mode":
                        m = q.get("m", ["color"])[0]
                        if m in ("color", "depth", "alpha"):
                            viewer.mode = m
                    elif kind == "overlay":
                        viewer.show_overlay = not viewer.show_overlay
                    elif kind == "resize":
                        # reference resize path: drawable size → renderer
                        # (main.mm:50-52, metal_renderer.mm:158-160)
                        w = int(q.get("w", [viewer.width])[0])
                        h = int(q.get("h", [viewer.height])[0])
                        viewer.resize(w, h)
                    self.send_response(204)
                    self.end_headers()
                else:
                    self.send_response(404)
                    self.end_headers()

        server = ThreadingHTTPServer((host, port), Handler)
        if block:
            server.serve_forever()
        else:
            t = threading.Thread(target=server.serve_forever, daemon=True)
            t.start()
            return server


_INDEX_HTML = """<!doctype html>
<html><head><title>gaussian_splat_tpu viewer</title><style>
body{margin:0;background:#111;color:#ddd;font:13px monospace}
#hud{position:fixed;top:8px;left:8px;background:#0008;padding:6px 10px;border-radius:4px}
img{display:block;margin:auto;max-width:100vw;max-height:100vh}
</style></head><body>
<div id="hud">loading…</div><img id="view" draggable="false">
<script>
const img=document.getElementById('view'),hud=document.getElementById('hud');
let busy=false;
async function refresh(){if(busy)return;busy=true;
 img.src='/frame?t='+Date.now();
 await new Promise(r=>{img.onload=r;img.onerror=r});busy=false;}
setInterval(refresh,66);refresh();
setInterval(async()=>{const m=await(await fetch('/metrics')).json();
 hud.textContent=`${m.fps.toFixed(1)} fps  ${m.frame_ms.toFixed(1)} ms  `+
   `${m.num_gaussians} splats  cam ${m.camera_position.map(v=>v.toFixed(2))}`;},500);
const send=p=>fetch('/input?'+p);
img.addEventListener('mousedown',e=>send(`kind=down&x=${e.clientX}&y=${e.clientY}&b=${e.button}`));
window.addEventListener('mousemove',e=>send(`kind=move&x=${e.clientX}&y=${e.clientY}`));
window.addEventListener('mouseup',()=>send('kind=up'));
img.addEventListener('wheel',e=>{e.preventDefault();send(`kind=scroll&dy=${Math.sign(e.deltaY)}`)});
img.addEventListener('contextmenu',e=>e.preventDefault());
window.addEventListener('keydown',e=>{
 if(e.key==='g'){send('kind=overlay');return;}
 const m={c:'color',d:'depth',a:'alpha'}[e.key];
 if(m)send('kind=mode&m='+m);});
let rt=null;
window.addEventListener('resize',()=>{clearTimeout(rt);
 rt=setTimeout(()=>send(`kind=resize&w=${window.innerWidth}&h=${window.innerHeight}`),300);});
</script></body></html>
"""
