"""Browser front end: a dependency-light HTTP render server.

PyTorch counterpart of blackhole_tpu.viz.server.  The reference's
flagship UX is a 1280x720 OpenGL window with ImGui sliders; this is its
analog without any GL dependency: a stdlib HTTP server streams
progressively refined PNG frames to a canvas and maps the controls onto
the terminal viewer's command grammar (viz.viewer.ViewerState.apply).
The canvas is navigable: drag to orbit, wheel to zoom, WASD/arrow keys
nudge azimuth/elevation, Q/E zoom, all mapped onto az/el/dist commands.

Threads:

* one RENDER thread owns the device and is the only thread that
  touches a tensor on it: the progressive quality ladder
  (animate.QUALITY_LADDER), then full-resolution temporal accumulation,
  restarting whenever a parameter command lands.  Every frame launches
  K1 on the card (image.render_image for a tier, trace_rays_fast for an
  accumulation frame).  The frame goes to the host as uint8 and is
  encoded by viz.io.encode_png_banded (zlib, no PIL), which the render
  thread waits for;
* ENCODER threads (the server's pool, one a band: viz.io.band_count)
  deflate the frame's bands of rows; render_loop shuts the pool down
  when it ends;
* HTTP handler threads read the latest encoded PNG and push commands
  onto the state under the lock.

A frame that fails stores its exception (RenderServer.error, and the
`status` of /state) and ends the render thread with it; nothing falls
back to another device or to a kernel's plain version.

Run:  python -m blackhole_tpu_torch.cli serve [--port 8000]
"""

from __future__ import annotations

import collections
import contextlib
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from blackhole_tpu_torch.render import image as image_mod
from blackhole_tpu_torch.utils import profiling
from blackhole_tpu_torch.viz import animate, io as viz_io, viewer
from blackhole_tpu_torch.viz.viewer import ViewerState


class RenderServer:
    """Shared state between the render thread and the HTTP handlers."""

    def __init__(self, state: ViewerState | None = None,
                 width: int = 480, height: int = 270,
                 accum_frames: int = 32):
        self.state = state or ViewerState()
        self.width = width
        self.height = height
        self.accum_frames = accum_frames
        self._lock = threading.Lock()  # guards everything below
        self._png: bytes = b""
        self._seq = 0
        self._tier = "startup"
        self._render_ms = 0.0
        self._dirty = True  # restart the ladder (param change)
        self._applied = 0  # commands applied that changed the state
        self._running = True
        self._status = "ready"
        self.error: BaseException | None = None
        # One record per published frame (the newest 4096): its seq,
        # tier, publish time (time.perf_counter), render_ms (to the
        # frame's uint8 on the host), the stages' ms (profiling.Stages:
        # trace, accumulate, particles, readback), encode_ms,
        # encode_bands (the bands its PNG was deflated in), frame_ms,
        # lock_ms (the render thread's waits for the lock in the frame)
        # and stale (a command changed the state while the frame was
        # rendered: it was superseded before it was shown).
        self._timings = collections.deque(maxlen=4096)
        # The encoder's threads, one a band of viz_io.band_count's,
        # started as the bands need them.
        self._encoder = ThreadPoolExecutor(viz_io.MAX_BANDS,
                                           thread_name_prefix="png-band")

    # ---- command side (HTTP handler threads) ----
    def apply(self, line: str) -> str:
        with self._lock:
            action = self.state.apply(line)
            if action == "changed":
                self._dirty = True
                self._applied += 1
                self._status = f"applied: {line.strip()}"
            elif action.startswith("error"):
                self._status = action
            return action

    def frame(self):
        with self._lock:
            return self._png, self._seq, self._tier

    def stats(self) -> dict:
        with self._lock:
            s = self.state
            shadow, isco = viewer.radii(s.mass, s.spin)
            return {
                "mass": s.mass, "spin": s.spin, "charge": s.charge,
                "fov": s.fov, "distance": s.distance,
                "elevation": s.elevation, "azimuth": s.azimuth,
                "steps": s.steps, "disk": s.disk, "sky": s.sky,
                "particles": s.particles,
                "shadow_radius": shadow,
                "isco": isco,
                "seq": self._seq, "tier": self._tier,
                "render_ms": round(self._render_ms, 1),
                "status": self._status,
            }

    def frame_timings(self) -> list:
        """The per-frame timing records, oldest first (a copy)."""
        with self._lock:
            return list(self._timings)

    def stop(self):
        with self._lock:
            self._running = False

    # ---- render side (one background thread; owns the device) ----
    @contextlib.contextmanager
    def _held(self, waits: list):
        """The lock, taken by the render thread: the wait is a
        frame.lock span, its length appended to waits (ns)."""
        with profiling.span("frame.lock") as wait:
            self._lock.acquire()
        waits.append(wait.ns)
        try:
            yield
        finally:
            self._lock.release()

    def _publish(self, frame, tier: str, t0: float, stages, waits: list,
                 applied: int) -> int:
        """Bring the frame (an (H, W, 3) float tensor) to the host as
        uint8, the JAX package's clip(frame * 255, 0, 255) truncated,
        encode it and make it current; returns its seq.  t0: the frame's
        start (time.perf_counter); stages: its profiling.Stages; waits:
        its lock waits so far (ns); applied: the count of applied
        commands when it began."""
        u8 = (frame * 255.0).clamp(0.0, 255.0).to(torch.uint8).cpu().numpy()
        render_s = time.perf_counter() - t0
        stages.mark("readback")
        t1 = time.perf_counter()
        bands = viz_io.band_count(u8.shape[0])
        with profiling.span("frame.encode"):
            png = viz_io.encode_png_banded(u8, bands, self._encoder)
        t2 = time.perf_counter()
        record = {"tier": tier, "t": t2, "render_ms": render_s * 1e3,
                  **stages.ms(), "encode_ms": (t2 - t1) * 1e3,
                  "encode_bands": bands, "frame_ms": (t2 - t0) * 1e3}
        with self._held(waits):
            self._png = png
            self._seq += 1
            self._tier = tier
            self._render_ms = render_s * 1000.0
            self._timings.append({"seq": self._seq, **record,
                                  "lock_ms": sum(waits) / 1e6,
                                  "stale": self._applied != applied})
            return self._seq

    def render_loop(self, max_frames: int | None = None):
        """Progressive render loop, run by the render thread.

        max_frames: stop after N published frames (tests); None = run
        until stop().  An exception ends the loop after it is stored in
        self.error and the status.  However the loop ends, the encoder's
        threads end with it."""
        try:
            self._render(max_frames)
        except BaseException as exc:
            with self._lock:
                self.error = exc
                self._status = f"render error: {exc!r}"
            raise
        finally:
            self._encoder.shutdown()

    def _render(self, max_frames):
        frames = 0
        history = None
        accum_idx = 0
        jitter_idx = 0
        psystem = None  # the particle pool, made on first use
        ladder = iter(animate.QUALITY_LADDER)
        while True:
            with profiling.span("frame") as frame_span:
                waits = []
                with self._held(waits):
                    if not self._running:
                        return
                    if self._dirty:
                        ladder = iter(animate.QUALITY_LADDER)
                        history = None
                        accum_idx = 0
                        jitter_idx = 0
                        self._dirty = False
                    scene = self.state.scene()
                    camera = self.state.camera()
                    particles = self.state.particles
                    applied = self._applied
                t0 = time.perf_counter()
                stages = profiling.Stages(self.state.device)
                tier = next(ladder, None)
                if tier is not None:
                    divisor, steps = tier
                    frame = animate.tier_frame(scene, camera, self.width,
                                               self.height, divisor, steps)
                    stages.mark("trace")
                    tier_label = f"1/{divisor}"
                else:
                    new = viewer.accumulation_frame(
                        scene, camera, self.width, self.height, jitter_idx,
                        self.accum_frames)
                    jitter_idx += 1
                    stages.mark("trace")
                    if history is None:
                        history, accum_idx = new, 1
                    else:
                        history, _ = image_mod.temporal_accumulate(
                            history, new, accum_idx,
                            max_frames=self.accum_frames,
                        )
                        # temporal_accumulate's index, kept on the host.
                        accum_idx = min(accum_idx + 1, self.accum_frames)
                    stages.mark("accumulate")
                    frame = history
                    tier_label = f"full+{accum_idx}"
                if particles:
                    frame, psystem = self._overlay_particles(
                        frame, psystem, scene, camera)
                    stages.mark("particles")
                else:
                    psystem = None
                frame_span.key = self._publish(frame, tier_label, t0, stages,
                                               waits, applied)
            frames += 1
            if max_frames is not None and frames >= max_frames:
                return
            if tier is None and accum_idx >= self.accum_frames:
                # Converged: idle until the next parameter change.
                while True:
                    with self._lock:
                        if not self._running or self._dirty:
                            break
                    time.sleep(0.05)

    def _overlay_particles(self, frame, psystem, scene, camera):
        """Step and splat the live disk-particle pool over the frame
        (viewer.overlay_particles)."""
        return viewer.overlay_particles(frame, psystem, scene, camera,
                                        self.state.n_particles)


_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>blackhole_tpu</title>
<style>
 body{background:#0b0e14;color:#cdd6e3;font:14px system-ui;margin:0;
      display:flex;min-height:100vh}
 #view{flex:1;display:flex;align-items:center;justify-content:center}
 #frame{image-rendering:auto;max-width:100%;border:1px solid #222}
 #panel{width:300px;padding:14px;background:#11151f;overflow-y:auto}
 label{display:block;margin:10px 0 2px;color:#8fa1b8}
 input[type=range]{width:100%}
 .val{float:right;color:#e6edf6}
 #stats{margin-top:14px;font:12px ui-monospace,monospace;color:#7d8fa8;
        white-space:pre-line}
 #cmd{width:100%;box-sizing:border-box;background:#0b0e14;color:#cdd6e3;
      border:1px solid #333;padding:5px;margin-top:10px}
 h1{font-size:15px;margin:0 0 6px}
 .chk{margin:8px 0}
</style></head><body>
<div id="view"><img id="frame" alt="render"></div>
<div id="panel">
 <h1>blackhole_tpu</h1>
 <div style="font:12px ui-monospace,monospace;color:#7d8fa8">
   drag: orbit &nbsp; wheel: zoom &nbsp; WASD/arrows: orbit &nbsp;
   Q/E: zoom</div>
 <div id="sliders"></div>
 <div class="chk"><input type="checkbox" id="disk" checked>
   <label for="disk" style="display:inline">accretion disk</label></div>
 <div class="chk"><input type="checkbox" id="sky">
   <label for="sky" style="display:inline">lensed starfield</label></div>
 <div class="chk"><input type="checkbox" id="particles">
   <label for="particles" style="display:inline">particles</label></div>
 <input id="cmd" placeholder="command (e.g. charge 0.3) — enter">
 <div id="stats"></div>
</div>
<script>
const SLIDERS = [
 ["mass", 0.2, 3, 0.01], ["spin", 0, 0.998, 0.002],
 ["fov", 5, 90, 1], ["dist", 8, 120, 1],
 ["el", -89, 89, 1], ["az", -180, 180, 1], ["steps", 50, 2000, 10]];
const KEYMAP = {dist:"distance", el:"elevation", az:"azimuth"};
const box = document.getElementById("sliders");
for (const [name, lo, hi, st] of SLIDERS) {
  const l = document.createElement("label");
  l.textContent = name;
  const v = document.createElement("span");
  v.className = "val"; v.id = "v_" + name; l.appendChild(v);
  const r = document.createElement("input");
  r.type = "range"; r.min = lo; r.max = hi; r.step = st; r.id = name;
  r.oninput = () => { v.textContent = r.value; };
  // "=": absolute — az/el/dist treat a bare +/- as relative
  r.onchange = () => send(name + " =" + r.value);
  box.appendChild(l); box.appendChild(r);
}
for (const id of ["disk", "sky", "particles"]) {
  document.getElementById(id).onchange =
    (e) => send(id + " " + (e.target.checked ? "on" : "off"));
}
document.getElementById("cmd").addEventListener("keydown", (e) => {
  if (e.key === "Enter") { send(e.target.value); e.target.value = ""; }
});
async function send(line) {
  await fetch("/cmd", {method: "POST", body: line});
}
// --- camera navigation on the canvas (renderer.cpp:815-817 analog:
// the reference advertises mouse-look + WASD; here drag orbits,
// wheel zooms, WASD/arrows nudge, Q/E zoom) ---
const nav = {az: 0, el: 20, dist: 35, active: false, wt: 0, kt: 0};
const img = document.getElementById("frame");
img.style.cursor = "grab"; img.draggable = false;
let drag = null, lastSend = 0;
function wrapAz(a) {
  while (a > 180) a -= 360; while (a < -180) a += 360; return a;
}
function sendOrbit(throttle) {
  const now = Date.now();
  if (throttle && now - lastSend < 160) return;
  lastSend = now;
  send("az =" + nav.az.toFixed(1));
  send("el =" + nav.el.toFixed(1));
}
img.addEventListener("pointerdown", (e) => {
  drag = {x: e.clientX, y: e.clientY, az: nav.az, el: nav.el};
  nav.active = true; img.style.cursor = "grabbing";
  img.setPointerCapture(e.pointerId); e.preventDefault();
});
img.addEventListener("pointermove", (e) => {
  if (!drag) return;
  nav.az = wrapAz(drag.az + (e.clientX - drag.x) * 0.4);
  nav.el = Math.max(-89, Math.min(89,
    drag.el + (e.clientY - drag.y) * 0.4));
  sendOrbit(true);
});
img.addEventListener("pointerup", () => {
  if (!drag) return;
  drag = null; img.style.cursor = "grab";
  lastSend = 0; sendOrbit(false);
  setTimeout(() => { nav.active = false; }, 400);
});
img.addEventListener("wheel", (e) => {
  e.preventDefault(); nav.active = true;
  nav.dist = Math.max(8, Math.min(120,
    nav.dist * Math.exp(e.deltaY * 0.001)));
  const now = Date.now();
  if (now - lastSend > 160) {
    lastSend = now; send("dist =" + nav.dist.toFixed(1));
  }
  clearTimeout(nav.wt);
  nav.wt = setTimeout(() => {
    send("dist =" + nav.dist.toFixed(1)); nav.active = false;
  }, 250);
}, {passive: false});
document.addEventListener("keydown", (e) => {
  if (document.activeElement &&
      ["cmd"].includes(document.activeElement.id)) return;
  const k = e.key.toLowerCase();
  const step = e.shiftKey ? 15 : 5;
  let orbit = false, zoom = false;
  if (k === "a" || k === "arrowleft") { nav.az = wrapAz(nav.az - step); orbit = true; }
  else if (k === "d" || k === "arrowright") { nav.az = wrapAz(nav.az + step); orbit = true; }
  else if (k === "w" || k === "arrowup") { nav.el = Math.min(89, nav.el + step); orbit = true; }
  else if (k === "s" || k === "arrowdown") { nav.el = Math.max(-89, nav.el - step); orbit = true; }
  else if (k === "q" || k === "-") { nav.dist = Math.min(120, nav.dist * 1.12); zoom = true; }
  else if (k === "e" || k === "+" || k === "=") { nav.dist = Math.max(8, nav.dist / 1.12); zoom = true; }
  else return;
  e.preventDefault(); nav.active = true;
  if (orbit) { lastSend = 0; sendOrbit(false); }
  if (zoom) send("dist =" + nav.dist.toFixed(1));
  clearTimeout(nav.kt);
  nav.kt = setTimeout(() => { nav.active = false; }, 400);
});
let seq = -1;
async function poll() {
  try {
    const s = await (await fetch("/state")).json();
    if (!nav.active) {
      nav.az = s.azimuth; nav.el = s.elevation; nav.dist = s.distance;
    }
    for (const [name] of SLIDERS) {
      const r = document.getElementById(name);
      if (document.activeElement !== r) {
        r.value = s[KEYMAP[name] || name];
        document.getElementById("v_" + name).textContent =
          Number(r.value).toFixed(2).replace(/\\.?0+$/, "");
      }
    }
    document.getElementById("stats").textContent =
      `shadow ${s.shadow_radius.toFixed(2)} M   isco ${s.isco.toFixed(2)} M\\n` +
      `tier ${s.tier}   ${s.render_ms} ms/frame\\n${s.status}`;
    if (s.seq !== seq) {
      seq = s.seq;
      document.getElementById("frame").src = "/frame.png?seq=" + seq;
    }
  } catch (e) {}
  setTimeout(poll, 150);
}
poll();
</script></body></html>
"""


class _Handler(BaseHTTPRequestHandler):
    server_ref: RenderServer  # set by serve()

    def _send(self, code, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Cache-Control", "no-store")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (stdlib API)
        path = self.path.split("?")[0]
        if path == "/":
            self._send(200, _PAGE.encode(), "text/html; charset=utf-8")
        elif path == "/frame.png":
            png, seq, _ = self.server_ref.frame()
            if not png:
                self._send(503, b"no frame yet", "text/plain")
            else:
                self._send(200, png, "image/png")
        elif path == "/state":
            self._send(
                200, json.dumps(self.server_ref.stats()).encode(),
                "application/json",
            )
        else:
            self._send(404, b"not found", "text/plain")

    def do_POST(self):  # noqa: N802
        if self.path.split("?")[0] != "/cmd":
            self._send(404, b"not found", "text/plain")
            return
        n = int(self.headers.get("Content-Length", 0) or 0)
        line = self.rfile.read(n).decode("utf-8", "replace")
        action = self.server_ref.apply(line)
        self._send(200, json.dumps({"action": action}).encode(),
                   "application/json")

    def log_message(self, *args):  # quiet
        pass


def serve(host: str = "127.0.0.1", port: int = 8000,
          state: ViewerState | None = None, width: int = 480,
          height: int = 270, block: bool = True):
    """Start the render server.  Returns (httpd, render_thread).

    block=False (tests/embedding): the caller drives and joins; the
    render loop runs in its daemon thread.  On the card the first frame
    also waits for the kernels' nvcc build when nothing in the process
    has built them yet (cuda_lib.load); later frames do not."""
    rs = RenderServer(state, width, height)
    handler = type("BoundHandler", (_Handler,), {"server_ref": rs})
    httpd = ThreadingHTTPServer((host, port), handler)
    httpd.render_server = rs
    rt = threading.Thread(target=rs.render_loop, daemon=True)
    rt.start()
    httpd.render_thread = rt
    st = threading.Thread(target=httpd.serve_forever, daemon=True)
    st.start()
    if block:
        print(f"serving on http://{host}:{httpd.server_address[1]}/ "
              f"(ctrl-c to stop)")
        try:
            while True:
                time.sleep(1.0)
        except KeyboardInterrupt:
            pass
        finally:
            rs.stop()
            rt.join(timeout=60)  # let the frame in flight finish
            httpd.shutdown()
    return httpd, rt
