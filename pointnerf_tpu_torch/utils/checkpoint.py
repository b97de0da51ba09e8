"""Weights carried across from the JAX package.

`from_jax_params` turns the JAX aggregator pytree (``{branch: [{"w": [in,
out], "b": [out]}, ...]}``, as numpy) and point arrays into the port's
`Aggregator` module and point-state tensors. `load_net_ray_marching_npz`
reads the ``{step}_net_ray_marching.npz`` every JAX checkpoint writes
(reference key names; torch Linear weights [out, in]) with numpy alone.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

from ..models.aggregator import Aggregator, aggregator_from_layers
from ..models.neural_points import create_point_cloud

_POINT_KEYS = {  # ours -> reference buffer name (neural_points.py:244-288)
    "xyz": "neural_points.xyz",
    "embedding": "neural_points.points_embeding",
    "conf": "neural_points.points_conf",
    "dir": "neural_points.points_dir",
    "color": "neural_points.points_color",
}
_LINEAR = re.compile(r"^aggregator\.(\w+)\.(\d+)\.(weight|bias)$")


def from_jax_params(agg_params: Dict, point_arrays: Dict,
                    act_type: str = "LeakyReLU", device="cpu"
                    ) -> Tuple[Aggregator, Dict[str, torch.Tensor]]:
    """JAX aggregator pytree + point arrays → (Aggregator, point state).

    point_arrays is either a padded JAX point state (with "mask") or the
    unpadded host arrays of an exported checkpoint (xyz [N,3], embedding
    [N,C], color, dir, conf, Rw2c), which are padded by create_point_cloud.
    """
    layers = {name: [(np.asarray(l["w"], np.float32).T, l["b"]) for l in ls]
              for name, ls in agg_params.items()}
    agg = aggregator_from_layers(layers, act_type).to(device)
    pts = {k: (None if v is None else np.array(v))
           for k, v in point_arrays.items()}
    if "mask" in pts:
        state = {k: (None if v is None else torch.as_tensor(v, device=device))
                 for k, v in pts.items()}
    else:
        state = create_point_cloud(pts["xyz"], pts["embedding"],
                                   pts.get("color"), pts.get("dir"),
                                   pts.get("conf"), pts.get("Rw2c"),
                                   device=device)
    return agg, state


def load_net_ray_marching_npz(path: str) -> Tuple[Dict, Dict]:
    """Read a ``{step}_net_ray_marching.npz`` into (agg_params, point_arrays)
    numpy dicts in the JAX layout (w [in,out]; unpadded [N,C] point arrays),
    ready for `from_jax_params`."""
    raw = dict(np.load(path))
    agg: Dict = {}
    for key, arr in raw.items():
        m = _LINEAR.match(key)
        if not m:
            continue
        branch, idx, kind = m.group(1), int(m.group(2)), m.group(3)
        layer = agg.setdefault(branch, {}).setdefault(idx // 2, {})
        if kind == "weight":
            layer["w"] = np.asarray(arr, np.float32).T
        else:
            layer["b"] = np.asarray(arr, np.float32)
    agg = {b: [ls[i] for i in sorted(ls)] for b, ls in agg.items()}
    pts = {}
    for ours, ref in _POINT_KEYS.items():
        if ref in raw:
            arr = np.asarray(raw[ref], np.float32)
            pts[ours] = arr[0] if arr.ndim == 3 else arr
    if "neural_points.Rw2c" in raw:
        pts["Rw2c"] = np.asarray(raw["neural_points.Rw2c"], np.float32)
    return agg, pts
