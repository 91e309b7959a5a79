"""Checkpoint and resume of a progressive render: the film's sums, the
per-pixel sample counter, the progression index and the guiding grid
with its fitting statistics, as one ``.npz``.

The file format is the JAX package's (its utils/checkpoint.py):
``rgb_weight``, ``width``, ``height``, ``sample_counter``, ``progression``
and ``grid_<field>`` for each field of ``GuidingGrid``, so a file written
by either package loads in the other.  The port's grid keeps ``res0`` and
``n_used`` as host ints: they are written as 0-d int32 arrays, as the JAX
grid holds them.  A field that is ``None`` is left out, and a key the
file lacks loads as ``None``.
"""
from __future__ import annotations

import numpy as np

from mitsuba_path_guiding_torch.guiding.grid import GuidingGrid

_HOST_INTS = ("res0", "n_used")


def grid_arrays(grid: GuidingGrid) -> dict:
    """``grid_<field>`` -> numpy array, in the JAX grid's dtypes."""
    out = {}
    for name in GuidingGrid._fields:
        v = getattr(grid, name)
        if v is None:
            continue
        out[f"grid_{name}"] = (np.asarray(v, dtype=np.int32) if name in _HOST_INTS
                               else v.detach().cpu().numpy())
    return out


def grid_from_arrays(z, device) -> GuidingGrid:
    """The inverse of ``grid_arrays`` on ``device``."""
    from mitsuba_path_guiding_torch.convert import grid_from_numpy

    return grid_from_numpy({name: z[f"grid_{name}"] for name in GuidingGrid._fields
                            if f"grid_{name}" in z}, device=device)


def save_renderer_state(renderer, path: str) -> None:
    data = {
        "rgb_weight": renderer.film.rgb_weight.detach().cpu().numpy(),
        "width": renderer.film.width,
        "height": renderer.film.height,
        "sample_counter": renderer.sample_counter,
        "progression": renderer.progression,
    }
    if renderer.grid is not None:
        data.update(grid_arrays(renderer.grid))
    np.savez_compressed(path, **data)


def load_renderer_state(renderer, path: str) -> None:
    """Restore ``renderer`` from ``path``, on the renderer's device."""
    import torch

    from mitsuba_path_guiding_torch.film.film import Film

    z = np.load(path)
    renderer.film = Film(
        rgb_weight=torch.as_tensor(z["rgb_weight"], dtype=torch.float32, device=renderer.device),
        width=int(z["width"]),
        height=int(z["height"]),
    )
    renderer.sample_counter = int(z["sample_counter"])
    renderer.progression = int(z["progression"])
    if renderer.grid is not None and "grid_mu" in z:
        renderer.grid = grid_from_arrays(z, renderer.device)
