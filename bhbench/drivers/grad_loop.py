"""Traffic kind grad_loop: a fitting loop's gradient steps, one caller,
closed loop.

Each step draws (mass, spin) from the seed, uniform in the traffic's
ranges (the parameters a fit visits), predicts that scene's depth order
with render.image.predicted_depth_order (a prepass through K1), and
takes grad.fast_grad.scene_value_and_grad over {mass, spin} of the bench
loss, sum(colour) / 3n, on the configuration's fixed rays: one pass of
the gradient kernel K2 and the host stages with their jvps.

End to end: grad_rays_per_s, the rays of every step completed in the
window over the window's seconds.  The check recomputes the loss and
both gradient components of steps drawn from the seed with the plain
reference (forward mode on Duals, the same tangent clip).
"""

from __future__ import annotations

import math
import random
import statistics

import torch

from bhbench import scenes
from bhbench.reference import geodesic as G

def _finite(gap: float) -> float:
    """A gap that is not a number reads as a huge one, never as 0."""
    return gap if math.isfinite(gap) else 1e30


class Cell:
    def __init__(self, r):
        from blackhole_tpu_torch.grad import fast_grad
        from blackhole_tpu_torch.render import camera as cam_mod
        from blackhole_tpu_torch.render import image

        self.r = r
        cfg, tr, dev = r.config, r.traffic, r.device
        self.image = image
        self.scene = scenes.port_scene(cfg, dev)
        self.camera = scenes.port_camera(cfg["camera"], dev)
        self.w, self.h = cfg["width"], cfg["height"]
        o, d = cam_mod.generate_rays(self.camera, self.w, self.h)
        self.o, self.d = o.reshape(-1, 3), d.reshape(-1, 3)
        self._last_steps = None
        self._refs = {}
        self.vg = fast_grad.scene_value_and_grad(
            self._loss_of_hit, self._scene_fn,
            tangent_clip=tr["tangent_clip"])
        bh = cfg["black_hole"]
        # Warm-up: one step at the configuration's own parameters.
        self.step(torch.tensor(bh["mass"], device=dev),
                  torch.tensor(bh["spin"], device=dev))
        r.sync()

    def _scene_fn(self, p):
        return scenes.with_mass_spin(self.scene, p["mass"], p["spin"])

    def _loss_of_hit(self, hit):
        """The bench loss; in a traced window it also counts the steps
        of the Hit (once a step: the loss sees each Hit per tangent)."""
        if self.r.tracing and hit.steps is not self._last_steps:
            self._last_steps = hit.steps
            self.r.data.setdefault("k2_ray_steps", []).append(
                hit.steps.sum(dtype=torch.float64))
        return hit.color.sum() / hit.color.numel()

    def step(self, mass, spin):
        p = {"mass": mass, "spin": spin}
        with self.r.span("prepass"):
            order = self.image.predicted_depth_order(
                self._scene_fn(p), self.camera, self.w, self.h)
        with self.r.span("value_and_grad"):
            loss, g = self.vg(p, self.o, self.d, order)
        return loss, g["mass"], g["spin"]

    def window(self):
        r, tr = self.r, self.r.traffic
        (m0, m1), (s0, s1) = tr["params"]["mass"], tr["params"]["spin"]
        gen = torch.Generator(device=r.device).manual_seed(r.seed)
        u = torch.rand((tr["draws"], 2), generator=gen, device=r.device)
        masses = m0 + (m1 - m0) * u[:, 0]
        spins = s0 + (s1 - s0) * u[:, 1]
        outs, window = r.closed_loop(
            lambda i: self.step(masses[i], spins[i]), tr["draws"],
            tr["trace_seconds"])
        n = len(outs)
        r.e2e["grad_rays_per_s"] = n * self.o.shape[0] / window
        if "k2_ray_steps" in r.data:
            r.data["k2_ray_steps"] = float(sum(
                s.item() for s in r.data["k2_ray_steps"]))
        self.params = torch.stack([masses[:n], spins[:n]], 1).cpu().tolist()
        self.outs = [tuple(float(x) for x in o) for o in outs]

    def sample(self):
        """The steps the check recomputes: drawn from the seed."""
        k = min(self.r.traffic["check_steps"], len(self.outs))
        return sorted(random.Random(self.r.seed).sample(
            range(len(self.outs)), k))

    def reference(self, i, dtype):
        """(loss, dmass, dspin) of step i by the plain reference."""
        key = (tuple(self.params[i]), dtype)
        if key not in self._refs:
            self._refs[key] = self._reference(i, dtype)
        return self._refs[key]

    def _reference(self, i, dtype):
        cfg = self.r.config
        o, d = G.image_rays(scenes.ref_camera(cfg["camera"]), self.w, self.h,
                            device=self.r.device, dtype=dtype)
        m, s = self.params[i]
        loss, (gm, gs), _ = G.loss_and_grad(
            o, d, lambda M, S: scenes.ref_scene(cfg, M, S), m, s,
            clip=self.r.traffic["tangent_clip"])
        return loss, gm, gs

    def readings(self, produced, dtype=torch.float32):
        """The worst loss gap and gradient gap over the sampled steps of
        produced(i) -> (loss, dmass, dspin) against the reference."""
        loss_gap = grad_gap = 0.0
        for i in self.sample():
            lp, *gp = produced(i)
            lr, *gr = self.reference(i, dtype)
            loss_gap = max(loss_gap, _finite(abs(lp - lr) / abs(lr)))
            scale = max(statistics.median(abs(g) for g in gr), 1e-30)
            for a, b in zip(gp, gr):
                grad_gap = max(grad_gap,
                               _finite(abs(a - b) / max(abs(b), scale)))
        return {"loss_rel_gap": loss_gap, "grad_rel_gap": grad_gap}

    def free(self):
        """Drop the program's state before the reference runs."""
        self.vg = self.o = self.d = None
        if self.r.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        lim = self.r.traffic["limits"]
        for name, v in self.readings(lambda i: self.outs[i]).items():
            self.r.check(name, v, lim[name])

    def control(self, dtype):
        """The readings of the reference computed in dtype in the
        program's place."""
        return self.readings(lambda i: self.reference(i, dtype))


def run(r):
    cell = Cell(r)
    cell.window()
    r.data["cell"] = cell


def check(r):
    cell = r.data.pop("cell")
    cell.free()
    cell.check()
