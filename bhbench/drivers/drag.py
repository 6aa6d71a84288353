"""Traffic kind drag: a user orbiting the camera of the served viewer
with the program's own page.

The cell starts the program's render server (viz.server.serve, port 0,
not blocking) at the configuration's size and viewer state, and loads
it over HTTP on 127.0.0.1 as the page that the server serves does
(viz/server.py's _PAGE):

* a drag is pointer motion at the traffic's pointer rate, mapped to the
  camera at deg_per_px; sendOrbit throttles it to one pair of absolute
  commands ("az =<deg>", "el =<deg>") per throttle_s, and the pointer's
  release sends one more pair.  Direction and speed are drawn per drag
  from the seed; the view then rests for rest_s.  The commands are sent
  open loop at their due times;
* a client polls GET /state every poll_s (after the previous poll has
  finished, as the page's setTimeout does) and GETs /frame.png whenever
  the state shows a new seq.

Set-up waits for the ladder's tiers and one accumulation frame (and,
with particles on, the particle pool): every shape of the window is
then built.

The benchmark times the frames itself.  A ViewerState subclass stamps,
under the server's lock, each applied command and each frame's start
(the one camera() call a frame makes, with the state it renders), and a
harness thread watches the published frame (RenderServer.frame()) for
each new seq.  Once the view has converged after the window, the frame
starts must equal the published frames one to one, or the run fails.

End to end: frame_p95_ms, the 95th percentile, over every frame
published in the window, of its start to its publication.  Each command
sent in the window is timed from when it was due to the publication of
the first frame whose render began after the server applied it; a
command with no such frame is a failure.  Those times are printed as
quantiles, not reported as a metric: their 95th percentile spreads too
widely from run to run for a bound.

The check decodes a sample of the published PNGs drawn from the seed
and compares pixels drawn from the seed with the plain reference: the
tier's render at its resolution and step budget, upsampled, or the
accumulated full frame (every Halton sample since the last command,
blended as the server does), read back as uint8.  Every PNG the client
fetched must be byte for byte a published frame no older than the seq
that /state announced.
"""

from __future__ import annotations

import http.client
import json
import random
import sys
import threading
import time

import numpy as np
import torch

from bhbench import arith
from bhbench.harness import Fail
from bhbench.reference import geodesic as G
from bhbench.reference import particles as P
from bhbench.reference import png

SETTLE_S = 30.0  # how long after the window the view may take to converge
WATCH_S = 0.002  # how often the harness reads the published frame
# (a served frame takes 15 ms or more, so no publication is missed)


def _stamped_state(base):
    """A subclass of the program's ViewerState that stamps commands and
    frame starts (see the module's docstring)."""

    class Stamped(base):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.applied = 0
            self.frames = []  # per frame start: (time, snapshot, applied)

        def apply(self, line):
            action = super().apply(line)
            if action == "changed":
                self.applied += 1
            return action

        def camera(self):
            self.frames.append((time.perf_counter(), self.snapshot(),
                                self.applied))
            return super().camera()

        def snapshot(self):
            return {k: getattr(self, k) for k in (
                "mass", "spin", "charge", "fov", "distance", "elevation",
                "azimuth", "steps", "disk", "particles", "sky",
                "n_particles")}

    return Stamped


def _wrap_az(a: float) -> float:
    while a > 180.0:
        a -= 360.0
    while a < -180.0:
        a += 360.0
    return a


def schedule(seed: int, seconds: float, tr: dict, az0: float, el0: float):
    """[(due time from the window's start, command)] of the page's drags
    from the view (az0, el0): every drag that ends inside the window, so
    every seed sends as many commands at nearly the same times.  The
    elevation drifts back toward el0, so every seed orbits the same band
    of views."""
    rng = random.Random(seed)
    period = 1.0 / tr["pointer_hz"]
    moves = int(round(tr["drag_s"] * tr["pointer_hz"]))
    out, t0, az, el = [], 0.0, az0, el0
    while t0 + tr["drag_s"] + tr["release_s"] + tr["jitter_s"] < seconds:
        vx = rng.choice((-1.0, 1.0)) * rng.uniform(*tr["speed_px_s"])
        vy = (1.0 if el < el0 else -1.0) * rng.uniform(*tr["rise_px_s"])
        az_d, el_d, last, t = az, el, None, t0
        for k in range(1, moves + 1):
            t = t0 + k * period + rng.uniform(-tr["jitter_s"],
                                              tr["jitter_s"])
            az = _wrap_az(az_d + vx * k * period * tr["deg_per_px"])
            el = max(-89.0, min(89.0, el_d + vy * k * period
                                * tr["deg_per_px"]))
            if last is None or t - last >= tr["throttle_s"]:
                last = t
                out += [(t, f"az ={az:.1f}"), (t, f"el ={el:.1f}")]
        t += tr["release_s"]  # the release: one pair, not throttled
        out += [(t, f"az ={az:.1f}"), (t, f"el ={el:.1f}")]
        az, el = float(f"{az:.1f}"), float(f"{el:.1f}")
        t0 += tr["drag_s"] + tr["rest_s"]
    return out


def _key(data: bytes):
    """A published PNG's identity: its length and its last 20 bytes (the
    zlib stream's checksum and the IDAT chunk's CRC, before IEND)."""
    return len(data), bytes(data[-20:])


class Cell:
    def __init__(self, r):
        from blackhole_tpu_torch.viz import server, viewer

        self.r = r
        cfg, tr = r.config, r.traffic
        kw = dict(cfg["viewer_state"])
        kw.update(tr.get("viewer_state", {}))
        self.state = _stamped_state(viewer.ViewerState)(
            device=str(r.device), **kw)
        self.w, self.h = cfg["width"], cfg["height"]
        self.httpd, self.thread = server.serve(
            "127.0.0.1", 0, self.state, self.w, self.h, block=False)
        self.rs = self.httpd.render_server
        self.port = self.httpd.server_address[1]
        self._refs = {}
        # Warm-up: the ladder's tiers and one accumulation frame.
        need = len(cfg["ladder"]) + 1
        deadline = time.perf_counter() + 1200.0
        while self.rs.frame()[1] < need:
            if self.rs.error is not None or time.perf_counter() > deadline:
                self.close()
                raise RuntimeError(f"render server failed: {self.rs.error!r}")
            time.sleep(0.01)

    def close(self):
        self.rs.stop()
        self.thread.join(timeout=60)
        self.httpd.shutdown()
        self.httpd.server_close()

    def _request(self, method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=30)
        try:
            conn.request(method, path, body=body)
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                raise RuntimeError(f"{method} {path}: HTTP {resp.status}")
            return data
        finally:
            conn.close()

    def _watch(self, stop, last, t_end, seen, kept):
        """Record (seq, time first seen, tier, key) of each new published
        frame, and keep a sample of check_frames of those published by
        t_end (a reservoir drawn from the seed)."""
        pick, n = random.Random(self.r.seed), 0
        k = self.r.traffic["check_frames"]
        while not stop.is_set():
            data, seq, tier = self.rs.frame()
            if seq != last:
                last, t = seq, time.perf_counter()
                seen.append((seq, t, tier, _key(data)))
                if t <= t_end:
                    if n < k:
                        kept.append((seq, data, tier))
                    else:
                        j = pick.randint(0, n)
                        if j < k:
                            kept[j] = (seq, data, tier)
                    n += 1
            time.sleep(WATCH_S)

    def _browse(self, stop, fetched, errors):
        """The page's poll: GET /state, and GET /frame.png on a new seq."""
        seq = None
        try:
            while not stop.is_set():
                st = json.loads(self._request("GET", "/state"))
                if st["seq"] != seq:
                    seq = st["seq"]
                    fetched.append((seq, _key(self._request(
                        "GET", f"/frame.png?seq={seq}"))))
                stop.wait(self.r.traffic["poll_s"])
        except Exception as exc:  # noqa: BLE001 (reported by the run)
            errors.append(exc)

    def window(self):
        r, tr = self.r, self.r.traffic
        base_seq = self.rs.frame()[1]
        plan = schedule(r.seed, r.seconds, tr, self.state.azimuth,
                        self.state.elevation)
        base_applied = self.state.applied
        seen, kept, fetched, errors = [], [], [], []
        stop = threading.Event()
        r.open_window()
        t0 = time.perf_counter()
        t_end = t0 + r.seconds
        threads = [threading.Thread(target=self._watch, daemon=True,
                                    args=(stop, base_seq, t_end, seen, kept)),
                   threading.Thread(target=self._browse, daemon=True,
                                    args=(stop, fetched, errors))]
        for th in threads:
            th.start()
        r.start_trace()
        sent = []  # (due, sent) on the perf_counter clock
        try:
            for due, line in plan:
                now = time.perf_counter()
                if r.tracing and now - t0 >= tr["trace_seconds"]:
                    r.stop_trace()
                if t0 + due > now:
                    time.sleep(t0 + due - now)
                ts = time.perf_counter()
                with r.span("cmd"):
                    self._request("POST", "/cmd", line.encode())
                sent.append((t0 + due, ts))
            while time.perf_counter() < t_end:
                if r.tracing and time.perf_counter() - t0 >= tr[
                        "trace_seconds"]:
                    r.stop_trace()
                time.sleep(0.005)
            if r.tracing:
                r.stop_trace()
            # The view converges: the last frame of the accumulation,
            # begun after the window's last command.
            done = (f"full+{self.r.config['accum_frames']}",
                    base_applied + len(sent))
            deadline = time.perf_counter() + SETTLE_S
            while not self._converged(seen, done):
                if (self.rs.error is not None
                        or time.perf_counter() > deadline):
                    raise Fail("the viewer did not converge after the "
                               f"window: {self.rs.error!r}")
                time.sleep(0.01)
        finally:
            stop.set()
            for th in threads:
                th.join(timeout=60)
        if errors:
            raise Fail(f"the page's client failed: {errors[0]!r}")
        if r.device.type == "cuda":
            r.memory_peak = torch.cuda.max_memory_allocated()
        self._score(t0, t_end, base_seq, base_applied, sent, seen, kept,
                    fetched)

    def _converged(self, seen, done):
        if not seen or seen[-1][2] != done[0]:
            return False
        return self.state.frames[seen[-1][0] - 1][2] >= done[1]

    def _score(self, t0, t_end, base_seq, base_applied, sent, seen, kept,
               fetched):
        r = self.r
        frames = self.state.frames
        last = self.rs.frame()[1]
        if len(frames) != last or seen[-1][0] != last:
            raise Fail(f"{len(frames)} frame starts against {last} "
                       "published frames: the frames cannot be timed")
        # Publication of each seq after base_seq: when it was first seen,
        # or for a seq that was replaced before the watch saw it, when
        # its successor was.
        pub, skipped, j = {}, 0, 0
        for s in range(base_seq + 1, last + 1):
            while seen[j][0] < s:
                j += 1
            pub[s] = seen[j][1]
            skipped += seen[j][0] != s
            if pub[s] <= frames[s - 1][0]:
                raise Fail(f"frame {s} was seen before it began")
        in_window = [s for s in pub if t0 <= pub[s] <= t_end]
        lat, failed = [], 0
        for j, (due, _) in enumerate(sent):
            need = base_applied + j + 1
            answer = next((i + 1 for i in range(base_seq, last)
                           if frames[i][2] >= need), None)
            if answer is None:
                failed += 1
                lat.append(1e3 * (t_end + SETTLE_S - due))
            else:
                lat.append(1e3 * (pub[answer] - due))
        r.attempted = len(sent)
        r.failed = failed
        if lat:
            r.data["cmd_ms_quantiles"] = [arith.percentile(lat, q)
                                          for q in (50, 90, 95, 99, 100)]
        if in_window:
            r.e2e["frame_p95_ms"] = arith.percentile(
                [1e3 * (pub[s] - frames[s - 1][0]) for s in in_window],
                95.0)
        keep = set(in_window)
        r.data["frame_timings"] = [t for t in self.rs.frame_timings()
                                   if t["seq"] in keep]
        late = [1e3 * (s - d) for d, s in sent]
        if late:
            r.data["sender_late_p95_ms"] = arith.percentile(late, 95.0)
        r.data["watch_skipped"] = skipped
        # Every fetched PNG is a published frame no older than announced.
        keys = {}
        for s, _, _, k in seen:
            keys.setdefault(k, []).append(s)
        r.data["fetched"] = len(fetched)
        r.data["fetched_unmatched"] = sum(
            not any(s >= want for s in keys.get(k, ()))
            for want, k in fetched if want > base_seq)
        self.kept = [(s, data, tier, frames[s - 1][1])
                     for s, data, tier in sorted(kept)]
        self.frames = frames

    # ---- the check -----------------------------------------------------
    def _ref_scene(self, snap, steps):
        """The reference scene of a viewer state at a step budget (the
        ladder's coarser step for a tier, as the program scales it)."""
        cfg = self.r.config["scene"]
        dt = cfg["time_step"]
        if steps != snap["steps"]:
            steps = max(steps, 20)
            scale = max(1.0, snap["steps"] / steps)
            dt = float(torch.tensor(dt, dtype=torch.float32) * scale)
        m = snap["mass"]
        return G.RefScene(
            mass=m, spin=snap["spin"], charge=snap["charge"],
            disk_inner=cfg["disk_inner_per_mass"] * m,
            disk_outer=cfg["disk_outer_per_mass"] * m,
            temperature_scale=1.0, inclination=0.0,
            time_step=dt,
            max_ray_distance=cfg["max_ray_distance_per_distance"]
            * snap["distance"],
            max_steps=int(steps), disk_on=bool(snap["disk"]))

    def reference(self, seq, snap, tier, px, py, dtype):
        """Reference uint8 (N, 3) of frame seq at the published pixels
        (px, py)."""
        key = (seq, dtype)
        if key in self._refs:
            return self._refs[key]
        cfg, dev = self.r.config, self.r.device
        if snap["sky"]:
            raise ValueError("the reference renders no starfield")
        cam = self._camera(snap)
        px_t = torch.as_tensor(px, device=dev)
        py_t = torch.as_tensor(py, device=dev)
        if tier.startswith("1/"):
            div = int(tier[2:])
            steps = dict(cfg["ladder"])[div]
            w, h = max(8, self.w // div), max(8, self.h // div)
            tx, ty = px_t // (self.w // w), py_t // (self.h // h)
            o, d = G.pixel_rays(cam["position"], cam["direction"], cam["up"],
                                cam["fov_deg"], w, h, tx, ty, device=dev,
                                dtype=dtype)
            rgb, _, _ = G.colours(o, d, self._ref_scene(snap, steps))
            colour = rgb.float()
        else:
            # full+k: the Halton samples 0..k-1 since the last tier.
            js = range(int(tier.split("+")[1]))
            rays = [G.pixel_rays(cam["position"], cam["direction"],
                                 cam["up"], cam["fov_deg"], self.w, self.h,
                                 px_t, py_t,
                                 *G.jitter(j, cfg["accum_frames"]),
                                 device=dev, dtype=dtype) for j in js]
            rgb, _, _ = G.colours(torch.cat([o for o, _ in rays]),
                                  torch.cat([d for _, d in rays]),
                                  self._ref_scene(snap, snap["steps"]))
            samples = rgb.float().reshape(len(js), -1, 3)
            colour = samples[0]
            for i in range(1, len(js)):
                alpha = torch.tensor(0.5 if i == 1 else cfg["blend"],
                                     dtype=torch.float32)
                colour = colour * (1.0 - alpha) + samples[i] * alpha
        if snap["particles"]:
            hh, ww = self._shape(tier)
            rows, cols, rgb = self._splat(seq, snap, cam, ww, hh)
            add = torch.zeros((hh, ww, 3), device=dev).index_put(
                (rows, cols), rgb, accumulate=True)
            colour = torch.clamp(colour + add[py_t, px_t], 0.0, 1.0)
        u8 = (colour * 255.0).clamp(0.0, 255.0).to(torch.uint8)
        self._refs[key] = u8.cpu().numpy().astype(np.int16)
        return self._refs[key]

    def _shape(self, tier):
        """(rows, columns) of a published frame: a tier's render is
        upsampled by whole factors and cropped to the window."""
        if not tier.startswith("1/"):
            return self.h, self.w
        div = int(tier[2:])
        h, w = max(8, self.h // div), max(8, self.w // div)
        return min(self.h, h * (self.h // h)), min(self.w, w * (self.w // w))

    def _splat(self, seq, snap, cam, width, height):
        """The reference particles' (rows, cols, colours) on frame seq:
        the pool stepped once a frame since particles were switched on."""
        steps, j = 0, seq - 1
        while j >= 0 and self.frames[j][1]["particles"]:
            steps, j = steps + 1, j - 1
        cfg = self.r.config["scene"]
        m = snap["mass"]
        pos, vel, temp = P.disk_pool(
            snap["n_particles"], m, snap["spin"],
            cfg["disk_inner_per_mass"] * m, cfg["disk_outer_per_mass"] * m,
            cfg["disk_thickness"], 1.0, self.r.device)
        pos, active = P.newton_steps(pos, vel, m, cfg["time_step"], steps)
        return P.splat(pos, temp, active, cam, width, height)

    def _camera(self, snap):
        pos = G.orbit_position(snap["distance"], snap["elevation"],
                               snap["azimuth"])
        return dict(position=pos, direction=tuple(-p for p in pos),
                    up=(0.0, 0.0, 1.0), fov_deg=snap["fov"])

    def readings(self, produced, dtype=torch.float32):
        """Worst over the sampled frames of produced(frame) -> (N, 3)
        uint8 at the sampled pixels against the reference: the share (%)
        of pixels off by more than the traffic's outlier gap in some
        channel, and the mean absolute gap in uint8 levels of the other
        pixels.  A near-critical ray that ends elsewhere on one side
        flips its pixel by some 200 levels; the share counts such flips,
        so that they do not swamp the mean."""
        tr = self.r.traffic
        mean_gap = outliers = 0.0
        rng = random.Random(self.r.seed)
        for seq, data, tier, snap in self.kept:
            try:
                img = png.decode_rgb8(data)
            except ValueError:
                mean_gap, outliers = 255.0, 100.0
                continue
            hh, ww, _ = img.shape
            if (hh, ww) != self._shape(tier):
                mean_gap, outliers = 255.0, 100.0
                continue
            n = tr["check_pixels"]
            px = [rng.randrange(ww) for _ in range(n)]
            py = [rng.randrange(hh) for _ in range(n)]
            if snap["particles"]:
                # Half the pixels where the reference's particles land.
                rows, cols, _ = self._splat(seq, snap, self._camera(snap),
                                            ww, hh)
                hit = list(zip(rows.tolist(), cols.tolist()))
                for i in range(min(n // 2, len(hit))):
                    py[i], px[i] = hit[rng.randrange(len(hit))]
            px, py = np.array(px), np.array(py)
            ref = self.reference(seq, snap, tier, px, py, torch.float32)
            got = produced(seq, data, tier, snap, img, px, py).astype(
                np.int16)
            gap = np.abs(got - ref)
            out = gap.max(axis=1) > tr["outlier_levels"]
            mean_gap = max(mean_gap, float(gap[~out].mean())
                           if (~out).any() else 255.0)
            outliers = max(outliers, 100.0 * float(out.mean()))
        return {"u8_inlier_mean_gap": mean_gap,
                "pixel_outlier_pct": outliers}

    def check(self):
        lim = self.r.traffic["limits"]
        late = self.r.data.get("sender_late_p95_ms")
        if late is not None:
            print(f"drag: commands sent late by {late:.3f} ms at the 95th "
                  "percentile", file=sys.stderr)
        q = self.r.data.get("cmd_ms_quantiles")
        if q:
            print("drag: command latency p50 p90 p95 p99 max (ms): "
                  + " ".join(f"{v:.1f}" for v in q), file=sys.stderr)
        d = self.r.data
        print(f"drag: {d['fetched']} PNGs fetched over HTTP; "
              f"{d['watch_skipped']} publications replaced before the "
              "watch saw them", file=sys.stderr)
        self.r.check("fetched_png_unmatched", d["fetched_unmatched"],
                     d["watch_skipped"])
        if not self.kept:
            self.r.check("frames_checked", 0.0, -1.0)
            return
        got = self.readings(lambda seq, data, tier, snap, img, px, py:
                            img[py, px])
        for name, v in got.items():
            self.r.check(name, v, lim[name])

    def control(self, dtype):
        return self.readings(
            lambda seq, data, tier, snap, img, px, py:
            self.reference(seq, snap, tier, px, py, dtype))


def run(r):
    cell = Cell(r)
    try:
        cell.window()
    finally:
        cell.close()
    r.data["cell"] = cell


def check(r):
    r.data.pop("cell").check()
