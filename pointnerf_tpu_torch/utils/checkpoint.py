"""Weights and training state carried across from the JAX package.

`from_jax_params` turns the JAX aggregator pytree (``{branch: [{"w": [in,
out], "b": [out]}, ...]}``, as numpy) and point arrays into the port's
`Aggregator` module and point-state tensors. `from_jax_train_state` carries
a whole JAX `TrainState` across, Adam moments and step included.
`load_net_ray_marching_npz` reads the ``{step}_net_ray_marching.npz`` every
JAX checkpoint writes (reference key names; torch Linear weights [out, in])
with numpy alone.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

from ..models.aggregator import Aggregator, aggregator_from_layers
from ..models.neural_points import create_point_cloud
from ..train import trainer

_POINT_KEYS = {  # ours -> reference buffer name (neural_points.py:244-288)
    "xyz": "neural_points.xyz",
    "embedding": "neural_points.points_embeding",
    "conf": "neural_points.points_conf",
    "dir": "neural_points.points_dir",
    "color": "neural_points.points_color",
}
_LINEAR = re.compile(r"^aggregator\.(\w+)\.(\d+)\.(weight|bias)$")


def from_jax_params(agg_params: Dict, point_arrays: Dict,
                    act_type: str = "LeakyReLU", device="cuda"
                    ) -> Tuple[Aggregator, Dict[str, torch.Tensor]]:
    """JAX aggregator pytree + point arrays → (Aggregator, point state), on
    `device` (the card unless the caller names another).

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


def _net_tensors(tree: Dict) -> Dict[str, np.ndarray]:
    """A JAX aggregator pytree (weights [in, out]) by the port's parameter
    names (``block1.0.weight`` [out, in])."""
    out = {}
    for branch, layers in tree.items():
        for i, layer in enumerate(layers):
            out[f"{branch}.{2 * i}.weight"] = np.asarray(layer["w"]).T
            out[f"{branch}.{2 * i}.bias"] = np.asarray(layer["b"])
    return out


def _adam_of(chain) -> object:
    """The scale_by_adam state (count, mu, nu) inside an optax chain's
    state, as numpy."""
    for s in chain:
        if hasattr(s, "mu") and hasattr(s, "nu"):
            return s
    raise ValueError("no Adam state (mu, nu) in the optimizer state")


def _point_moments(m, template: Dict[str, torch.Tensor]) -> Dict:
    """Point moments in either JAX layout by buffer name: per buffer, or
    packed into one [cap, ΣC] array by sorted key (trainer.py:88-99). The
    packed columns are cut by the template's widths, which must add up to
    the packed width."""
    if isinstance(m, dict):
        return {k: np.asarray(m[k]) for k in template}
    m = np.asarray(m)
    widths = [(k, template[k].shape[1]) for k in sorted(template)]
    if m.ndim != 2 or m.shape[1] != sum(w for _, w in widths) \
            or m.shape[0] != next(iter(template.values())).shape[0]:
        raise ValueError(f"packed point moments of shape {m.shape} do not "
                         f"match the trainable buffers {widths}")
    out, off = {}, 0
    for k, w in widths:
        out[k] = m[:, off:off + w]
        off += w
    return out


def _load_adam(optim: torch.optim.Adam, params: Dict[str, torch.Tensor],
               adam, mu: Dict, nu: Dict) -> None:
    count = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    for k, p in params.items():
        if tuple(mu[k].shape) != tuple(p.shape):
            raise ValueError(f"Adam moment of {k} has shape {mu[k].shape}, "
                             f"the parameter {tuple(p.shape)}")
        optim.state[p] = {
            "step": count.clone(),
            "exp_avg": torch.as_tensor(np.array(mu[k], np.float32),
                                       device=p.device),
            "exp_avg_sq": torch.as_tensor(np.array(nu[k], np.float32),
                                          device=p.device)}


def from_jax_train_state(ts, opt, device="cuda") -> "trainer.TrainState":
    """A JAX `TrainState` (leaves as numpy) → the port's TrainState: the
    aggregator, the point buffers, both optimizers' moments and counts,
    and the step. The point moments may come in either JAX layout (see
    `_point_moments`). The jitter generator is seeded 0 on `device`."""
    points = dict(ts.pt_static)
    points.update(ts.pt_train)
    agg, pts = from_jax_params(ts.agg_params, points, opt.act_type, device)
    state = trainer.make_train_state(
        agg, pts, opt, torch.Generator(device=device).manual_seed(0),
        int(np.asarray(ts.step)))
    if set(state.pt_train) != set(ts.pt_train):
        raise ValueError(f"trainable buffers {sorted(ts.pt_train)} in the "
                         f"JAX state, {sorted(state.pt_train)} by opt")
    adam = _adam_of(ts.opt_state_net)
    named = dict(agg.named_parameters())
    _load_adam(state.opt_net, named, adam, _net_tensors(adam.mu),
               _net_tensors(adam.nu))
    adam = _adam_of(ts.opt_state_pts)
    _load_adam(state.opt_pts, state.pt_train, adam,
               _point_moments(adam.mu, state.pt_train),
               _point_moments(adam.nu, state.pt_train))
    return state


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
