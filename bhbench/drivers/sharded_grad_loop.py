"""Traffic kind sharded_grad_loop: grad_loop's fitting steps with the
image's rows sharded over a world of ranks on one host, one caller.

The calling process is rank 0 of a world of the configuration's `ranks`
(the program's parallel.launch.joined_world: ranks 1.. spawned, over
NCCL where every rank has a card of its own, each rank's card its
current device).  Rank 0 draws (mass, spin) per step from the seed,
uniform in the traffic's ranges.  Each step starts with a broadcast from
rank 0 of [go, mass, spin]; then every rank takes the program's
parallel.mesh.scene_value_and_grad_sharded of the bench loss
sum(colour) / 3WH over its own block of rows: its rows' depth-order
prepass through K1, one pass of K2 between the replayed host stages,
and one all_reduce(SUM) of [loss, dmass, dspin].  One broadcast of stop
follows the window, so no rank is left waiting in a collective.

End to end: grad_rays_per_s, the whole image's rays of every step
completed in the window over the window's seconds.  After the window
every rank reports its step timings (mesh.step_timings), collectives,
kernel launches, graph captures and replays, and the forbidden modules
it loaded (a run in which any rank loaded one fails).  The check is
grad_loop's: a step drawn from the seed recomputed with the plain
reference over the whole image on rank 0's card, once the program's
state is freed.
"""

from __future__ import annotations

import json
import sys

import torch
import torch.distributed as dist

from bhbench import harness, scenes
from bhbench.drivers import grad_loop

STOP, GO = 0.0, 1.0
# The world's life and each collective's limit: above a set-up, a window
# and control.py's references between its windows.
TIMEOUT_S = 1800.0


def _program():
    """The program's parallel.launch; a Fail where it has no sharded
    forward-mode gradient or no world for the calling process to join."""
    from blackhole_tpu_torch.parallel import launch, mesh

    if not (hasattr(launch, "joined_world")
            and hasattr(mesh, "scene_value_and_grad_sharded")):
        raise harness.Fail("the program has no sharded forward-mode "
                           "gradient (parallel.mesh.scene_value_and_grad_"
                           "sharded, parallel.launch.joined_world)")
    return launch


def _bcast(t, m):
    """Rank 0's t on every rank of the mesh (through the host where the
    collectives are host-staged)."""
    buf = t.cpu() if m.host_staged else t
    dist.broadcast(buf, 0, group=m.group)
    return buf.to(m.device)


class Shard:
    """One rank's part: the sharded value and gradient of the bench loss
    over the rank's rows.  on_hit(hit), if given, sees every Hit."""

    def __init__(self, m, cfg, tangent_clip, on_hit=None):
        from blackhole_tpu_torch.parallel import mesh

        self.m = m
        self.scene = scenes.port_scene(cfg, m.device)
        camera = scenes.port_camera(cfg["camera"], m.device)
        w, h = cfg["width"], cfg["height"]
        n = 3 * w * h  # the whole image's colour components

        def loss_of_hit(hit):
            if on_hit is not None:
                on_hit(hit)
            return hit.color.sum() / n

        self.vg = mesh.scene_value_and_grad_sharded(
            loss_of_hit, self._scene_fn, camera, w, h, m,
            tangent_clip=tangent_clip)

    def _scene_fn(self, p):
        return scenes.with_mass_spin(self.scene, p["mass"], p["spin"])

    def step(self, msg):
        """(loss, dmass, dspin) over the world of the step msg = [go,
        mass, spin] (0-d tensors on the rank's device)."""
        loss, g = self.vg({"mass": msg[1], "spin": msg[2]})
        return loss, g["mass"], g["spin"]

    def report(self) -> dict:
        from blackhole_tpu_torch.parallel import mesh
        from blackhole_tpu_torch.render import trace_kernel as tk

        return {"rank": self.m.rank, "device": str(self.m.device),
                "backend": dist.get_backend(self.m.group),
                "timings": mesh.step_timings(),
                "collectives": mesh.collectives,
                "collective_bytes": mesh.collective_bytes,
                "k1_launches": tk.launches,
                "k2_launches": tk.fwdgrad_launches,
                "captures": tk.fwdgrad_captures,
                "replays": tk.fwdgrad_replays,
                "forbidden": harness.forbidden_modules()}


def _follow(m, cfg, tangent_clip):
    """Ranks 1..: a step at every go of rank 0 until its stop; returns
    the rank's report."""
    shard = Shard(m, cfg, tangent_clip)
    while True:
        msg = _bcast(torch.empty(3, device=m.device), m)
        if msg[0].item() == STOP:
            return shard.report()
        shard.step(msg)


class Cell(grad_loop.Cell):
    """Rank 0: grad_loop's cell (its sample, reference, readings, check
    and control) over the sharded steps."""

    def __init__(self, r):
        launch = _program()
        self.r = r
        cfg, tr = r.config, r.traffic
        self.w, self.h = cfg["width"], cfg["height"]
        if self.h != cfg["ranks"] * cfg["rows_per_rank"]:
            raise harness.Fail("height is not ranks x rows_per_rank")
        self._last_steps = None
        self._refs = {}
        self.calls = 0  # the sharded calls made, warm-up included
        if r.device.type == "cuda":
            from blackhole_tpu_torch import cuda_lib

            cuda_lib.build()  # once, before the ranks that load it start
        self._world = launch.joined_world(
            _follow, cfg["ranks"], device=r.device.type,
            args=(cfg, tr["tangent_clip"]), timeout_s=TIMEOUT_S)
        self.world = self._world.__enter__()
        try:
            self.shard = Shard(self.world.mesh, cfg, tr["tangent_clip"],
                               self._count_steps)
            bh = cfg["black_hole"]
            # Warm-up: one step at the configuration's own parameters.
            self.step(torch.tensor([GO, bh["mass"], bh["spin"]],
                                   device=self.world.mesh.device))
            r.sync()
        except BaseException:
            self.abandon()
            raise

    def _count_steps(self, hit):
        """In a traced window, the steps of rank 0's Hits (once a step:
        the loss sees each Hit per tangent)."""
        if self.r.tracing and hit.steps is not self._last_steps:
            self._last_steps = hit.steps
            self.r.data.setdefault("k2_ray_steps", []).append(
                hit.steps.sum(dtype=torch.float64))

    def step(self, msg):
        with self.r.span("broadcast"):
            _bcast(msg, self.world.mesh)
        with self.r.span("value_and_grad"):
            out = self.shard.step(msg)
        self.calls += 1
        return out

    def window(self):
        r, tr = self.r, self.r.traffic
        (m0, m1), (s0, s1) = tr["params"]["mass"], tr["params"]["spin"]
        gen = torch.Generator().manual_seed(r.seed)
        u = torch.rand((tr["draws"], 2), generator=gen)
        msgs = torch.stack([torch.full((tr["draws"],), GO),
                            m0 + (m1 - m0) * u[:, 0],
                            s0 + (s1 - s0) * u[:, 1]], 1)
        msgs = msgs.to(self.world.mesh.device)
        r.data["first_call"] = self.calls
        outs, window = r.closed_loop(lambda i: self.step(msgs[i]),
                                     tr["draws"], tr["trace_seconds"])
        n = len(outs)
        r.e2e["grad_rays_per_s"] = n * self.w * self.h / window
        if "k2_ray_steps" in r.data:
            r.data["k2_ray_steps"] = float(sum(
                s.item() for s in r.data["k2_ray_steps"]))
        self.params = msgs[:n, 1:].cpu().tolist()
        self.outs = [tuple(float(x) for x in o) for o in outs]

    def close(self):
        """Send stop and leave the world: every rank's report into
        run.data["ranks"]; a Fail where a rank loaded a forbidden
        module."""
        if self._world is None:
            return
        try:
            _bcast(torch.full((3,), STOP, device=self.world.mesh.device),
                   self.world.mesh)
            mine = self.shard.report()
        except BaseException:
            self.abandon()
            raise
        world, self._world = self._world, None
        world.__exit__(None, None, None)
        ranks = [mine, *self.world.results]
        self.r.data["ranks"] = ranks
        first = self.r.data.get("first_call", 0)
        print("bhbench: ranks " + json.dumps(
            [dict({k: v for k, v in rk.items() if k != "timings"},
                  **_means([t for t in rk["timings"] if t["call"] >= first]))
             for rk in ranks]), file=sys.stderr, flush=True)
        bad = sorted({m for rk in ranks for m in rk["forbidden"]})
        if bad:
            raise harness.Fail(f"a rank loaded {', '.join(bad)}; the "
                               "benchmark measures the PyTorch port alone")

    def abandon(self):
        """Leave the world on an error, which the caller raises (or a
        spawned rank's failure in its place)."""
        world, self._world = self._world, None
        if world is not None:
            world.__exit__(*sys.exc_info())

    def free(self):
        """Drop the program's state before the reference runs."""
        self.shard = None
        if self.r.device.type == "cuda":
            torch.cuda.empty_cache()


def _means(timings) -> dict:
    """Mean ms of each step_timings() stage over the rows given."""
    keys = ("local_ms", "all_reduce_ms")
    if not timings:
        return {}
    return {f"mean_{k}": sum(t[k] for t in timings) / len(timings)
            for k in keys}


def untraced_steps(run) -> list:
    """Per step of the window's untraced part (after the traced one,
    which the profiler slows on rank 0), every rank's mesh.step_timings()
    row in rank order; [] without a traced run."""
    ranks = run.data.get("ranks")
    first = run.data.get("first_call")
    traced = run.data.get("traced_items")
    if run.trace is None or not ranks or first is None or traced is None:
        return []
    by_rank = [{t["call"]: t for t in rk["timings"]} for rk in ranks]
    return [[b[c] for b in by_rank]
            for c in range(first + traced, first + run.attempted)
            if all(c in b for b in by_rank)]


def run(r):
    cell = Cell(r)
    try:
        cell.window()
    except BaseException:
        cell.abandon()
        raise
    cell.close()
    r.data["cell"] = cell


def check(r):
    cell = r.data.pop("cell")
    cell.free()
    cell.check()
