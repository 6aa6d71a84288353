"""Traffic kind frame_loop: offline frames, one caller, closed loop.

Each frame is render.image.render_image(scene, camera, width, height)
of the configuration's scene, its camera at the configuration camera's
distance and elevation and at an azimuth drawn from the seed: the
depth-order prepass through K1, then K1 over every pixel in that order,
and the host stages around it.

End to end: rays_per_s, the rays of every frame completed in the window
over the window's seconds.  The check recomputes whole frames drawn from
the seed (a reservoir sample over the window's frames) with the plain
reference and compares every pixel.
"""

from __future__ import annotations

import random

import torch

from bhbench import scenes
from bhbench.reference import geodesic as G

PREPASS_BLOCK = 8  # render_image's prepass: one ray per 8 x 8 pixels


class Cell:
    def __init__(self, r):
        from blackhole_tpu_torch.render import image

        self.r = r
        self.image = image
        cfg = r.config
        self.scene = scenes.port_scene(cfg, r.device)
        self.w, self.h = cfg["width"], cfg["height"]
        self._refs = {}
        self.frame(0.0)  # warm-up at the configuration's camera
        r.sync()

    def frame(self, azimuth):
        cam = self.r.config["camera"]
        camera = scenes.port_camera(cam, self.r.device,
                                    scenes.orbit(cam, azimuth))
        with self.r.span("render_image"):
            return self.image.render_image(self.scene, camera, self.w,
                                           self.h)

    def window(self):
        r, tr = self.r, self.r.traffic
        gen = torch.Generator(device=r.device).manual_seed(r.seed)
        az = (tr["azimuth_deg"][0] + (tr["azimuth_deg"][1]
                                      - tr["azimuth_deg"][0])
              * torch.rand(tr["draws"], generator=gen, device=r.device))
        self.azimuths = az.double().cpu().tolist()
        pick = random.Random(r.seed)
        k = tr["check_frames"]
        kept = []  # (index, frame): a reservoir sample of the frames

        def work(n):
            img = self.frame(self.azimuths[n])
            if n < k:
                kept.append((n, img))
            else:
                j = pick.randint(0, n)
                if j < k:
                    kept[j] = (n, img)

        outs, window = r.closed_loop(work, tr["draws"], tr["trace_seconds"])
        r.e2e["rays_per_s"] = len(outs) * self.w * self.h / window
        self.kept = sorted(kept, key=lambda t: t[0])

    def reference(self, i, dtype):
        """(colours (H*W, 3), ray steps of the frame, ray steps of its
        prepass) of frame i by the plain reference."""
        key = (i, dtype)
        if key in self._refs:
            return self._refs[key]
        cfg, dev = self.r.config, self.r.device
        cam = scenes.ref_camera(cfg["camera"],
                                scenes.orbit(cfg["camera"], self.azimuths[i]))
        o, d = G.image_rays(cam, self.w, self.h, device=dev, dtype=dtype)
        lw, lh = self.w // PREPASS_BLOCK, self.h // PREPASS_BLOCK
        po, pd = G.image_rays(cam, lw, lh, device=dev, dtype=dtype)
        rgb, steps, _ = G.colours(torch.cat([o, po]), torch.cat([d, pd]),
                                  scenes.ref_scene(cfg))
        n = o.shape[0]
        out = (rgb[:n].float(), float(steps[:n].double().sum()),
               float(steps[n:].double().sum()))
        self._refs[key] = out
        return out

    def readings(self, produced, dtype=torch.float32):
        """Worst over the sampled frames of produced(i) -> (H, W, 3)
        against the reference: the mean absolute colour gap, and the
        share (%) of pixels off by more than the traffic's outlier
        colour gap in some channel."""
        mean_gap = outliers = 0.0
        tol = self.r.traffic["outlier_gap"]
        for i, _ in self.kept:
            ref, _, _ = self.reference(i, torch.float32)
            got = produced(i).reshape(-1, 3).float()
            # A colour that is not a number is off by more than any
            # colour can be.
            gap = torch.nan_to_num((got - ref).abs(), nan=10.0, posinf=10.0)
            mean_gap = max(mean_gap, float(gap.double().mean()))
            outliers = max(outliers, 100.0 * float(
                (gap.amax(dim=1) > tol).double().mean()))
        return {"colour_mean_gap": mean_gap, "pixel_outlier_pct": outliers}

    def check(self):
        frames = dict(self.kept)
        lim = self.r.traffic["limits"]
        for name, v in self.readings(lambda i: frames[i]).items():
            self.r.check(name, v, lim[name])
        # Ray steps per frame, for the kernels' least work.
        steps = [self.reference(i, torch.float32)[1:] for i, _ in self.kept]
        if steps:
            self.r.data["ray_steps_per_frame"] = sum(
                a + b for a, b in steps) / len(steps)

    def control(self, dtype):
        return self.readings(lambda i: self.reference(i, dtype)[0])


def run(r):
    cell = Cell(r)
    cell.window()
    r.data["cell"] = cell


def check(r):
    r.data.pop("cell").check()
