"""The PyTorch port and chip_smoke.py import neither jax nor the JAX
package: every import statement of every module (function-level imports
included), and at run time the XLA engine, reverse mode and fit, the
CLI's tests command, the terminal viewer and the render server, the
sharded render and export.  The
API's context, like the records, is made on the card unless asked for
another device."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "blackhole_tpu")


def _imported(path: Path):
    """(line, top-level module name) of every import in the file."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]


def test_port_modules_and_chip_smoke_import_no_jax():
    files = sorted((ROOT / "blackhole_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [f"{p.relative_to(ROOT)}:{line} imports {name}"
           for p in files for line, name in _imported(p)
           if name in FORBIDDEN]
    assert not bad, bad


def test_reverse_path_runs_without_jax():
    """The XLA engine, grad_over_chunks and one fit step at 4x4 leave
    jax and the JAX package out of sys.modules."""
    code = (
        "import sys, dataclasses, torch\n"
        "from blackhole_tpu_torch.geom.types import "
        "BlackHole, Camera, Disk, Scene, SimConfig\n"
        "from blackhole_tpu_torch.grad import bucketed, inverse\n"
        "from blackhole_tpu_torch.render import camera as cam, image\n"
        "cpu = dict(device='cpu')\n"
        "scene = Scene(BlackHole.create(1.0, 0.9, **cpu), Disk.create(**cpu),\n"
        "              SimConfig.create(max_steps=12, time_step=0.5, **cpu))\n"
        "camera = Camera.create(position=(0.0, -30.0, 8.0),\n"
        "                       direction=(0.0, 30.0, -8.0),\n"
        "                       up=(0.0, 0.0, 1.0), **cpu)\n"
        "img = image.render_image(scene, camera, 4, 4, engine='xla')\n"
        "o, d = cam.generate_rays(camera, 4, 4)\n"
        "def scene_fn(p):\n"
        "    return dataclasses.replace(scene, blackhole=dataclasses.replace(\n"
        "        scene.blackhole, mass=p['mass']))\n"
        "loss, g = bucketed.grad_over_chunks(\n"
        "    scene_fn, {'mass': torch.tensor(1.0)}, o.reshape(-1, 3),\n"
        "    d.reshape(-1, 3), lambda c, i: c.sum(), chunks=2)\n"
        "assert torch.isfinite(g['mass'])\n"
        "inverse.fit(img, scene, camera, 4, 4, steps=1)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'blackhole_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_cli_tests_run_without_jax():
    """python -m blackhole_tpu_torch.cli tests --device cpu (the bh_*
    API, the kernel's plain version, the XLA engine) leaves jax and the
    JAX package out of sys.modules."""
    code = (
        "import sys\n"
        "from blackhole_tpu_torch import cli\n"
        "assert cli.main(['tests', '--device', 'cpu']) == 0\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'blackhole_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "Tests completed."


def test_viewer_and_server_run_without_jax():
    """viewer.run headless (particles on) and one RenderServer frame on
    the CPU (the ladder's first tier through render_loop, PNG encoded)
    leave jax and the JAX package out of sys.modules."""
    code = (
        "import sys\n"
        "from blackhole_tpu_torch.viz import server, viewer\n"
        "stats = viewer.run(viewer.ViewerState(steps=40, particles=True,\n"
        "                                      n_particles=16, device='cpu'),\n"
        "                   width=16, height=8, max_frames=2, commands=[],\n"
        "                   draw=False)\n"
        "assert stats['tiers'] == ['1/32', '1/16'], stats\n"
        "rs = server.RenderServer(viewer.ViewerState(steps=40, device='cpu'),\n"
        "                         width=16, height=8)\n"
        "rs.render_loop(max_frames=1)\n"
        "png, seq, tier = rs.frame()\n"
        "assert png[:8] == b'\\x89PNG\\r\\n\\x1a\\n' and (seq, tier) == (1, '1/32')\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'blackhole_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_parallel_export_and_examples_run_without_jax():
    """The sharded render on a world of one rank, an exported trace
    called after its round trip through bytes, and the imports of the
    scaling harness, the entry points and the examples leave jax and the
    JAX package out of sys.modules."""
    code = (
        "import sys, torch\n"
        "from blackhole_tpu_torch import entry, export\n"
        "from blackhole_tpu_torch.examples import distributed_render, "
        "inverse_fit, lensed_starfield, render_kerr\n"
        "from blackhole_tpu_torch.geom.types import "
        "BlackHole, Camera, Disk, Scene, SimConfig\n"
        "from blackhole_tpu_torch.parallel import launch, mesh, scaling\n"
        "cpu = dict(device='cpu')\n"
        "scene = Scene(BlackHole.create(1.0, 0.9, **cpu), Disk.create(**cpu),\n"
        "              SimConfig.create(max_steps=12, time_step=0.5, **cpu))\n"
        "camera = Camera.create(position=(0.0, -30.0, 8.0),\n"
        "                       direction=(0.0, 30.0, -8.0),\n"
        "                       up=(0.0, 0.0, 1.0), **cpu)\n"
        "m = mesh.make_mesh(device='cpu')\n"
        "assert (m.size, m.group) == (1, None)\n"
        "img = mesh.render_image_sharded(scene, camera, 4, 4, m, engine='auto')\n"
        "ep = export.load(export.export_trace(scene, poly_batch=True))\n"
        "o = camera.position.expand(16, 3)\n"
        "d = torch.nn.functional.normalize(torch.randn(16, 3), dim=-1)\n"
        "assert export.call_trace(ep, scene, o, d).shape == (16, 3)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'blackhole_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_api_context_defaults_to_the_card():
    """bh_initialize() with no device makes its records on cuda: without
    a card it fails through torch's own error."""
    import torch

    from blackhole_tpu_torch import api

    if torch.cuda.is_available():
        context = api.bh_initialize()
        assert context.device == torch.device("cuda")
        for t in (context.blackhole.mass, context.disk.inner_radius,
                  context.config.time_step,
                  api.bh_create_particle_system(context, 4).position):
            assert t.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            api.bh_initialize()
