"""The check on tiny CPU cells: the timed path broken underneath must
make `correct` false, and the control (the plain reference in bfloat16
in the program's place) must fail a limit."""


import pytest
import torch

from bhbench.tests import tiny

torch.set_num_threads(1)


def _grad_fault(monkeypatch, fault):
    from blackhole_tpu_torch.grad import fast_grad

    real = fast_grad.scene_value_and_grad

    def factory(loss_of_hit, scene_fn, **kw):
        vg = real(loss_of_hit, scene_fn, **kw)
        last = []

        def broken(params, o, d, order=None):
            if fault == "half":  # half the rays left out of the mean
                n = o.shape[0] // 2
                return vg(params, o[:n], d[:n], None)
            out = vg(params, o, d, order)
            if fault == "stale":  # the previous step's answer returned
                last.append(out)
                return last[-2] if len(last) > 1 else out
            loss, g = out  # an answer altered where it is produced
            return loss * 1.01, g

        return broken

    monkeypatch.setattr(fast_grad, "scene_value_and_grad", factory)


def _frame_fault(monkeypatch, fault):
    from blackhole_tpu_torch.render import image

    real = image.render_image
    last = []

    def broken(scene, camera, width, height, **kw):
        img = real(scene, camera, width, height, **kw)
        if fault == "stale":  # the previous frame returned
            last.append(img)
            return last[-2] if len(last) > 1 else img
        if fault == "half":  # half the pixels never traced
            img = img.clone()
            img[height // 2:] = 0.0
            return img
        return img + 0.05  # an answer altered where it is produced

    monkeypatch.setattr(image, "render_image", broken)


def _viewer_fault(monkeypatch, fault):
    from blackhole_tpu_torch.viz import animate, viewer

    tier, accum = animate.tier_frame, viewer.accumulation_frame
    first = {}

    def wrap(real):
        def broken(scene, camera, *args):
            if fault == "stale":  # the first camera kept: commands ignored
                camera = first.setdefault("camera", camera)
            img = real(scene, camera, *args)
            if fault == "half":
                img = img.clone()
                img[img.shape[0] // 2:] = 0.0
            elif fault == "altered":
                img = img + 0.05
            return img

        return broken

    monkeypatch.setattr(animate, "tier_frame", wrap(tier))
    monkeypatch.setattr(viewer, "accumulation_frame", wrap(accum))


def _particle_fault(monkeypatch, fault):
    from blackhole_tpu_torch.particles import dynamics
    from blackhole_tpu_torch.viz import effects, viewer

    real = viewer.overlay_particles

    def broken(frame, psystem, scene, camera, n_particles):
        if fault == "half":  # half the particles left out of the splat
            if psystem is None:
                psystem = viewer.seed_particles(n_particles, scene)
            pool = dynamics.update_particles(psystem, scene.blackhole,
                                             scene.config)
            k = pool.position.shape[0] // 2
            return effects.particle_overlay(
                frame, pool.position[:k], pool.temperature[:k],
                pool.active[:k], camera), pool
        out, pool = real(frame, psystem, scene, camera, n_particles)
        if fault == "stale":  # the pool never stepped
            return out, psystem if psystem is not None else pool
        return out * 0.9, pool  # the overlaid frame altered

    monkeypatch.setattr(viewer, "overlay_particles", broken)


FAULTS = {"bench_fwdbwd_rk4": _grad_fault, "bench_fwd_rk4": _frame_fault,
          "viewer_drag": _viewer_fault,
          "viewer_drag_particles": _particle_fault}


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, cell,
                                            fault):
    FAULTS[cell](monkeypatch, fault)
    seconds = 3.0 if cell == "viewer_drag" else 1.0
    rc, res, err = tiny.run(tmp_path, cell, seconds=seconds)
    assert rc == 0
    assert res["correct"] is False, (res["checks"], err)


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_the_control_fails_a_limit(tmp_path, cell):
    c = tiny.cell_after_window(tmp_path, cell,
                               seconds=3.0 if cell.startswith("viewer")
                               else 0.5)
    try:
        if cell.startswith("viewer"):
            assert c.kept
        got = c.control(torch.bfloat16)
    finally:
        if hasattr(c, "close"):
            c.close()
    lim = c.r.traffic["limits"]
    assert any(v > lim[n] for n, v in got.items()), (got, lim)
