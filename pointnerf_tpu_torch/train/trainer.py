"""The trainer (port of `pointnerf_tpu/train/trainer.py`): the train step and
the serving side.

Training keeps the JAX package's structure (reference: BaseModel and
mvs_points_volumetric_model.py:47-118): two Adam chains, the aggregator's
weights at `lr` and the trainable point buffers at `plr`, each scaled by
`make_lr_schedule` read at the optimizer's step count before the update,
with `alter_step` alternating them. Adam follows optax's
``scale_by_adam(0.9, 0.999, eps=1e-8)`` then ``-lr(count)``: torch's Adam
with the group's lr set from the schedule before each step is the same
update. The JAX package packs the point moments into one [cap, 42] array
for the TPU's lane tiling; Adam is elementwise, so the port keeps one
moment per buffer. The port updates the state in place (`train_step`
returns the same object). `expand_capacity` grows the point buffers: new
leaf tensors, a rebuilt point optimizer whose moments are padded with
zeros and whose step count carries over. Not ported: the multi-step
`lax.scan` dispatch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..models.aggregator import Aggregator, init_aggregator_params
from ..models.losses import compute_losses
from ..models.networks import make_lr_schedule
from ..models.neural_points import SENTINEL
from ..models.renderer import render_forward, render_query, render_shade
from ..ops.grid import build_grid

POINT_TRAINABLE_FLAGS = {
    "embedding": "feat_grad",
    "conf": "conf_grad",
    "dir": "dir_grad",
    "color": "color_grad",
    "xyz": "xyz_grad",
}
ADAM = dict(betas=(0.9, 0.999), eps=1e-8)
# ray-dependent batch leaves, split by ray_chunk
RAY_KEYS = ("raydir", "gt_image", "pixel_idx", "bg_ray", "gt_mask", "gt_depth")
# outputs that are [B, R, ...]: ray chunks join them along the ray axis
RAY_SHAPED = ("coarse_raycolor", "ray_mask", "conf_coefficient", "weight",
              "coarse_depth", "coarse_is_background")
COMPACT_KEYS = ("conf_compact", "weight_compact", "compact_valid",
                "zero_one_total")


class ServeState(NamedTuple):
    aggregator: Aggregator
    points: Dict[str, torch.Tensor]


def split_point_params(point_state: Dict, opt) -> Tuple[Dict, Dict]:
    """Split point state into (trainable, static) by the *_grad flags
    (reference: neural_points.py:133-229, 269-321)."""
    trainable, static = {}, {}
    for k, v in point_state.items():
        flag = POINT_TRAINABLE_FLAGS.get(k)
        if flag is not None and v is not None and getattr(opt, flag) > 0:
            trainable[k] = v
        else:
            static[k] = v
    return trainable, static


def merge_point_params(trainable: Dict, static: Dict) -> Dict:
    out = dict(static)
    out.update(trainable)
    return out


@dataclass
class TrainState:
    """The aggregator, the point buffers split into trainable leaves (the
    point Adam's parameters) and static ones, both optimizers, the step,
    and the generator of the depth jitter (on the points' device)."""
    aggregator: Aggregator
    pt_train: Dict[str, torch.Tensor]
    pt_static: Dict[str, torch.Tensor]
    opt_net: torch.optim.Adam
    opt_pts: torch.optim.Adam
    step: int
    generator: torch.Generator

    @property
    def points(self) -> Dict[str, torch.Tensor]:
        return merge_point_params(self.pt_train, self.pt_static)


def make_train_state(aggregator: Aggregator, point_state: Dict, opt,
                     generator: torch.Generator, step: int = 0
                     ) -> TrainState:
    """TrainState around existing weights and points, with fresh Adam
    moments; the trainable buffers become leaf tensors that require grad."""
    pt_train, pt_static = split_point_params(point_state, opt)
    pt_train = {k: v.detach().clone().requires_grad_(True)
                for k, v in pt_train.items()}
    return TrainState(
        aggregator=aggregator, pt_train=pt_train, pt_static=pt_static,
        opt_net=torch.optim.Adam(aggregator.parameters(), lr=opt.lr, **ADAM),
        opt_pts=torch.optim.Adam(list(pt_train.values()), lr=opt.plr, **ADAM),
        step=step, generator=generator)


def create_train_state(opt, point_state: Dict, generator: torch.Generator,
                       start_step: int = 0) -> TrainState:
    """Seeded aggregator weights (from `generator`, a CPU generator) and
    fresh optimizers on the points' device; the jitter generator there is
    seeded from `generator` too."""
    dev = point_state["xyz"].device
    agg = init_aggregator_params(opt, generator=generator, device=dev)
    seed = int(torch.randint(2 ** 62, (1,), generator=generator))
    jitter = torch.Generator(device=dev).manual_seed(seed)
    return make_train_state(agg, point_state, opt, jitter, start_step)


def point_state_of(state) -> Dict:
    return state.points


def _adam_count(optim: torch.optim.Adam) -> int:
    """Updates the optimizer has made (its parameters share one count)."""
    for group in optim.param_groups:
        for p in group["params"]:
            if "step" in optim.state.get(p, {}):
                return int(optim.state[p]["step"])
    return 0


def jitter_draws(state: TrainState, batch: Dict, opt) -> torch.Tensor:
    """The depth jitter's uniform draws u [B,R,z_depth_dim] for one step."""
    B, R = batch["raydir"].shape[:2]
    return torch.rand((B, R, opt.z_depth_dim), generator=state.generator,
                      device=batch["raydir"].device)


def _render(state: TrainState, grid, spec, opt, batch: Dict,
            u: torch.Tensor) -> Dict:
    """Query (no gradient, outside any recomputation), then the shade
    phase, rematerialized in the backward pass when opt.remat is set."""
    with torch.no_grad():
        q = render_query(state.points, grid, spec, opt, batch, is_train=True,
                         u=u)
    keys = list(state.pt_train)

    def shade(*train):
        ps = merge_point_params(dict(zip(keys, train)), state.pt_static)
        return render_shade(state.aggregator, ps, spec, opt, batch, q)

    train = [state.pt_train[k] for k in keys]
    if opt.remat > 0:
        return checkpoint(shade, *train, use_reentrant=False)
    return shade(*train)


def _chunked_render(state: TrainState, grid, spec, opt, batch: Dict,
                    u: torch.Tensor) -> Dict:
    """The render over ray_chunk-sized chunks, outputs joined: ray-shaped
    leaves along the ray axis, the compact-form loss leaves stacked on a
    leading chunk axis (compute_losses sums them), counters summed."""
    R = batch["raydir"].shape[1]
    C = int(opt.ray_chunk)
    outs = []
    for i in range(R // C):
        sl = slice(i * C, (i + 1) * C)
        sub = dict(batch, **{k: v[:, sl] for k, v in batch.items()
                             if k in RAY_KEYS and torch.is_tensor(v)})
        outs.append(_render(state, grid, spec, opt, sub, u[:, sl]))
    keys = ["coarse_raycolor", "ray_mask"]
    if opt.depth_loss_items:
        keys.append("coarse_depth")
    if opt.bg_loss_items:
        keys.append("coarse_is_background")
    keys += list(opt.l2_size_loss_items)
    keys += list(COMPACT_KEYS) if "conf_compact" in outs[0] \
        else ["conf_coefficient", "weight"]
    output = {k: (torch.cat([o[k] for o in outs], dim=1) if k in RAY_SHAPED
                  else torch.stack([o[k] for o in outs])) for k in keys}
    for k in ("sr_overflow", "occ_overflow"):
        if k in outs[0]:
            output[k] = sum(o[k] for o in outs)
    return output


def compute_grads(state: TrainState, grid, batch: Dict, opt, spec,
                  u: torch.Tensor):
    """Loss items and the gradients of both parameter groups for one batch
    (forward and backward only). u: the depth jitter's draws
    [B,R,z_depth_dim]. Returns (items, net grads by parameter name, point
    grads by buffer name); items are detached."""
    R = batch["raydir"].shape[1]
    C = int(opt.ray_chunk)
    if C > 0 and R > C and R % C == 0:
        output = _chunked_render(state, grid, spec, opt, batch, u)
    else:
        output = _render(state, grid, spec, opt, batch, u)
    total, items = compute_losses(opt, output, batch["gt_image"],
                                  gt_mask=batch.get("gt_mask"),
                                  gt_depth=batch.get("gt_depth"))
    items["sr_overflow"] = output["sr_overflow"].to(torch.float32)
    if "occ_overflow" in output:
        items["occ_overflow"] = output["occ_overflow"].to(torch.float32)
    named = dict(state.aggregator.named_parameters())
    params = list(named.values()) + list(state.pt_train.values())
    grads = torch.autograd.grad(total, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    g_net = dict(zip(named, grads[:len(named)]))
    g_pts = dict(zip(state.pt_train, grads[len(named):]))
    return ({k: torch.as_tensor(v).detach() for k, v in items.items()},
            g_net, g_pts)


def train_step(state: TrainState, grid, batch: Dict, opt, spec,
               u: Optional[torch.Tensor] = None
               ) -> Tuple[TrainState, Dict]:
    """One optimization step (reference train hot loop, SURVEY.md §3.2),
    in place. u: the jitter draws; None draws them from state.generator.
    With alter_step the idle chain gets zero gradients, so its Adam moments
    still decay, as optax's do."""
    if u is None:
        u = jitter_draws(state, batch, opt)
    items, g_net, g_pts = compute_grads(state, grid, batch, opt, spec, u)
    net_on = pts_on = 1.0
    if opt.alter_step > 0:
        phase = (state.step // opt.alter_step) % 2
        net_on, pts_on = float(phase == 0), float(phase == 1)
    named = dict(state.aggregator.named_parameters())
    with torch.no_grad():
        for k, g in g_net.items():
            named[k].grad = g * net_on
        for k, g in g_pts.items():
            state.pt_train[k].grad = g * pts_on
    for optim, base in ((state.opt_net, opt.lr), (state.opt_pts, opt.plr)):
        lr = make_lr_schedule(opt, base)(_adam_count(optim))
        for group in optim.param_groups:
            group["lr"] = lr
        optim.step()
        optim.zero_grad(set_to_none=True)
    state.step += 1
    return state, items


@torch.inference_mode()
def eval_step(state, grid: Dict, batch: Dict, opt, spec,
              prob: bool = False) -> Dict:
    """No-grad forward for test/render (reference base_model.test); with
    `prob` the uncompacted probe render of point growing."""
    return render_forward(state.aggregator, point_state_of(state), grid, spec,
                          opt, batch, prob=prob)


@torch.inference_mode()
def eval_chunks(state, grid: Dict, stacked: Dict, const_batch: Dict, opt,
                spec, prob: bool = False) -> Dict:
    """Render n ray chunks of one camera one after another.

    stacked: ray-dependent leaves [n, 1, C, ...]; const_batch: per-camera
    leaves. Returns every output stacked on a leading chunk axis."""
    n = next(iter(stacked.values())).shape[0]
    outs = [eval_step(state, grid,
                      dict(const_batch, **{k: v[i] for k, v in stacked.items()}),
                      opt, spec, prob=prob) for i in range(n)]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]
            if k not in COMPACT_KEYS and outs[0][k] is not None}


@torch.inference_mode()
def eval_chunks_stacked(state, grid: Dict, stacked: Dict, const_batch: Dict,
                        opt, spec) -> Dict:
    """Render n ray chunks of one camera as ONE wide eval_step.

    Same contract as eval_chunks ([n, 1, C, ...] in and out). Rays are
    independent, so the wide batch renders each chunk's rays as the chunk
    alone would; the compaction budget pools over the group (auto budgets
    scale with the row space; callers scale explicit ones by n). Only
    per-ray outputs come back; `sr_overflow` (a group total) comes back as
    [n] with the total at slot 0.
    """
    n, _, C = next(iter(stacked.values())).shape[:3]
    wide = {k: v.reshape((1, n * C) + v.shape[3:]) for k, v in stacked.items()}
    out = eval_step(state, grid, dict(const_batch, **wide), opt, spec)
    split: Dict = {}
    for k, v in out.items():
        if k in COMPACT_KEYS:
            continue
        if v.dim() >= 2 and tuple(v.shape[:2]) == (1, n * C):
            split[k] = v.reshape((n, 1, C) + v.shape[2:])
        elif v.dim() == 0:
            split[k] = torch.zeros((n,), dtype=v.dtype, device=v.device)
            split[k][0] = v
    return split


@torch.no_grad()
def rebuild_grid(state, spec) -> Dict:
    """The voxel grid of the state's live points (after a prune or grow)."""
    points = point_state_of(state)
    return build_grid(points["xyz"], points["mask"], spec)


def expand_capacity(state: TrainState, new_cap: int) -> TrainState:
    """Grow the padded point buffers to `new_cap` slots (JAX trainer.py:
    392-438), in place; a no-op unless new_cap exceeds the capacity.

    New slots are inactive: xyz at SENTINEL, mask False, the rest 0. The
    trainable buffers become new leaf tensors, so the point optimizer is
    rebuilt around them with each buffer's moments padded with zeros (what
    Adam's init gives a fresh slot) and its step count carried over, so the
    bias correction does not restart."""
    old_cap = state.pt_static["mask"].shape[0]
    if new_cap <= old_cap:
        return state

    def pad(v, fill):
        if v is None or v.dim() == 0 or v.shape[0] != old_cap:
            return v
        ext = torch.full((new_cap - old_cap,) + tuple(v.shape[1:]), fill,
                         dtype=v.dtype, device=v.device)
        return torch.cat([v.detach(), ext])

    def fill_of(k):
        return SENTINEL if k == "xyz" else (False if k == "mask" else 0.0)

    state.pt_static = {k: pad(v, fill_of(k)) for k, v in
                       state.pt_static.items()}
    old = state.opt_pts
    new_train = {k: pad(p, fill_of(k)).requires_grad_(True)
                 for k, p in state.pt_train.items()}
    opt_pts = torch.optim.Adam(list(new_train.values()),
                               lr=old.param_groups[0]["lr"], **ADAM)
    for k, p in state.pt_train.items():
        st = old.state.get(p)
        if st:
            opt_pts.state[new_train[k]] = {
                "step": st["step"].clone(),
                "exp_avg": pad(st["exp_avg"], 0.0),
                "exp_avg_sq": pad(st["exp_avg_sq"], 0.0)}
    state.pt_train, state.opt_pts = new_train, opt_pts
    return state
