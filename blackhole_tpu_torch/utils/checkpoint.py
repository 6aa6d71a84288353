"""Checkpoint/resume for inverse-rendering optimisation state.

PyTorch counterpart of blackhole_tpu.utils.checkpoint, where orbax
becomes torch.save / torch.load.  A checkpoint is the directory
<directory>/<step>/ holding state.pt.  It is written into a temporary
directory beside it and moved into place with os.replace (a step saved
again: its state file replaced by one os.replace), so a crash leaves
either the old checkpoint or the new one, never half of one; the
newest max_to_keep are kept, and restore takes the latest by default.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import torch

_FILE = "state.pt"


def _steps(directory: str) -> list[int]:
    """The steps of the complete checkpoints in directory, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(name) for name in os.listdir(directory)
                  if name.isdigit()
                  and os.path.isfile(os.path.join(directory, name, _FILE)))


def save(directory: str, step: int, state: dict, max_to_keep: int = 3
         ) -> None:
    """Save `state` (a dict of tensors, numbers and optimiser state
    dicts) at `step`: atomic, keeping the newest max_to_keep."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, str(step))
    # A new step's directory is written whole and moved into place; a
    # step saved again has its state file replaced.  Each is one rename.
    again = os.path.isdir(final)
    tmp = tempfile.mkdtemp(prefix=f".tmp-{step}-",
                           dir=final if again else directory)
    try:
        torch.save(state, os.path.join(tmp, _FILE))
        if again:
            os.replace(os.path.join(tmp, _FILE), os.path.join(final, _FILE))
        else:
            os.replace(tmp, final)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for old in _steps(directory)[:-max_to_keep]:
        shutil.rmtree(os.path.join(directory, str(old)))


def restore(directory: str, step: int | None = None, map_location="cpu"):
    """Restore the state saved at `step` (default: the latest), its
    tensors on map_location.  Returns (step, state); (None, None) when
    the directory holds no checkpoint."""
    if step is None:
        steps = _steps(directory)
        if not steps:
            return None, None
        step = steps[-1]
    state = torch.load(os.path.join(directory, str(step), _FILE),
                       map_location=map_location, weights_only=True)
    return step, state


def fit_with_checkpointing(
    target,
    init_scene,
    init_camera,
    width: int,
    height: int,
    directory: str,
    steps: int = 100,
    save_every: int = 20,
    learning_rate: float = 3e-2,
    optimize: tuple = ("log_mass", "spin_raw"),
):
    """grad.inverse.fit with a checkpoint every save_every steps (and
    after the last) and resume on restart: if `directory` already holds
    a checkpoint, optimisation continues from it, parameters and Adam
    state bit for bit.  Returns (scene, camera, losses) with the losses
    of the steps this call ran."""
    from blackhole_tpu_torch.grad import inverse

    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in inverse.pack_params(init_scene,
                                              init_camera).items()}
    mask = {k: float(k in optimize) for k in params}
    adam, step_fn = inverse._fit_step(width, height)
    optimizer = adam(params, learning_rate)
    device = params["log_mass"].device
    start = 0
    ck_step, ck = restore(directory, map_location=device)
    if ck is not None:
        with torch.no_grad():
            for k, v in params.items():
                v.copy_(ck["params"][k])
        optimizer.load_state_dict(ck["opt_state"])
        start = ck_step + 1

    target = torch.as_tensor(target, dtype=params["log_mass"].dtype,
                             device=device)
    losses = []
    for i in range(start, steps):
        params, optimizer, loss = step_fn(params, optimizer, target,
                                          init_scene, init_camera, mask)
        losses.append(float(loss))
        if (i + 1) % save_every == 0 or i == steps - 1:
            save(directory, i, {
                "params": {k: v.detach() for k, v in params.items()},
                "opt_state": optimizer.state_dict(),
            })
    scene, camera = inverse.unpack_params(
        {k: v.detach() for k, v in params.items()}, init_scene, init_camera)
    return scene, camera, losses
