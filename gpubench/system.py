"""The program under test, `pointnerf_tpu_torch`, as the train and render
mixes drive it: its options built from a configuration's file, its point
state and aggregator built around the benchmark's inputs, its two entry
points (`trainer.train_steps_scan` and `run.common.render_image`), and
what it counts (kernel launches, the optimizer's state). A mix of
another kind puts its calls into the program in a module of its own,
gpubench/system_<kind>.py. Only these modules of the benchmark, and
record.py's reading of the trace record, import the program, and only
when called.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np
import torch

from .reference.train import BETAS, POINT_LEAVES


def options(cfg: Dict):
    """The port's Options from the configuration's full option set; a key
    the port does not know, or a value it does not keep, raises."""
    from pointnerf_tpu_torch.config import Options
    opt = Options.from_json(json.dumps(cfg["options"]))
    back = json.loads(opt.to_json())
    for k, v in cfg["options"].items():
        if k not in back or back[k] != v:
            raise ValueError(f"option {k}: the file says {v!r}, the program "
                             f"runs {back.get(k)!r}")
    return opt


def point_state(cloud: Dict[str, torch.Tensor]) -> Dict:
    """The port's padded point buffers around the cloud (a copy): the
    capacity rounded up as `create_point_cloud` rounds it, free slots
    parked at its sentinel with conf 0, one identity Rw2c."""
    from pointnerf_tpu_torch.models.neural_points import (SENTINEL,
                                                          round_capacity)
    n = cloud["xyz"].shape[0]
    cap = round_capacity(n)
    dev = cloud["xyz"].device

    def pad(t, fill):
        out = torch.full((cap,) + tuple(t.shape[1:]), fill, dtype=t.dtype,
                         device=dev)
        out[:n] = t
        return out
    return {"xyz": pad(cloud["xyz"], SENTINEL),
            "embedding": pad(cloud["embedding"], 0.0),
            "mask": torch.arange(cap, device=dev) < n,
            "color": pad(cloud["color"], 0.0), "dir": pad(cloud["dir"], 0.0),
            "conf": pad(cloud["conf"], 0.0),
            "Rw2c": torch.eye(3, device=dev)}


def grid(opt, state: Dict):
    """(spec, grid) as the port builds them for its live points."""
    from pointnerf_tpu_torch.run.common import make_spec_and_grid
    return make_spec_and_grid(opt, state)


def aggregator(opt, W: Dict[str, torch.Tensor], device):
    """The port's aggregator with the benchmark's weights, by name; the
    names and shapes must be the port's own."""
    from pointnerf_tpu_torch.models.aggregator import init_aggregator_params
    agg = init_aggregator_params(opt, generator=torch.Generator(),
                                 device=device)
    named = dict(agg.named_parameters())
    if set(named) != set(W):
        raise ValueError(f"weights {sorted(W)} against the program's "
                         f"{sorted(named)}")
    with torch.no_grad():
        for k, p in named.items():
            if tuple(p.shape) != tuple(W[k].shape):
                raise ValueError(f"{k}: {tuple(W[k].shape)} against the "
                                 f"program's {tuple(p.shape)}")
            p.copy_(W[k])
    return agg


def train_state(opt, agg, state: Dict):
    from pointnerf_tpu_torch.train.trainer import make_train_state
    gen = torch.Generator(device=state["xyz"].device).manual_seed(0)
    return make_train_state(agg, state, opt, gen)


def dispatch(ts, grid_, spec, opt, d: Dict) -> Dict[str, np.ndarray]:
    """One dispatch of the train mix through `train_steps_scan` (its
    batches and its draws u): the items of its steps, read back to the
    host."""
    from pointnerf_tpu_torch.train.trainer import train_steps_scan
    _, items = train_steps_scan(ts, grid_, d["batches"], opt, spec, u=d["u"])
    return {k: v.numpy() for k, v in items.items()}


def serve_state(agg, state: Dict):
    from pointnerf_tpu_torch.train.trainer import ServeState
    return ServeState(agg, state)


def render(ss, grid_, spec, opt, item: Dict, group: int,
           stats: Optional[Dict] = None) -> Dict[str, np.ndarray]:
    """One image through `render_image`: its host maps by key."""
    from pointnerf_tpu_torch.run.common import render_image
    return render_image(ss, grid_, opt, spec, item,
                        keys=("coarse_raycolor", "ray_mask"), group=group,
                        stats=stats)


def leaves(ts) -> Dict[str, torch.Tensor]:
    """The trained tensors by the reference's leaf names."""
    out = dict(ts.aggregator.named_parameters())
    out.update({k: ts.pt_train[k] for k in POINT_LEAVES})
    return out


def first_gradients(ts) -> Dict[str, torch.Tensor]:
    """Each leaf's gradient at the first update, worked out from the
    optimizer's state after it: Adam's first moment is then (1 - β1)·g."""
    out = {}
    for optim, named in ((ts.opt_net, dict(ts.aggregator.named_parameters())),
                         (ts.opt_pts, {k: ts.pt_train[k]
                                       for k in POINT_LEAVES})):
        for k, p in named.items():
            out[k] = optim.state[p]["exp_avg"].detach() / (1 - BETAS[0])
    return out


def launches() -> Dict[str, int]:
    from pointnerf_tpu_torch.ops import kernels
    return {k.name: k.launches for k in kernels.KERNELS}


def build_kernels() -> None:
    """Build (once per checkout) and load the port's CUDA kernels."""
    from pointnerf_tpu_torch.ops import kernels
    kernels.library()
