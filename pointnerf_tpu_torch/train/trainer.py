"""The trainer (port of `pointnerf_tpu/train/trainer.py`): the train step and
the serving side.

Training keeps the JAX package's structure (reference: BaseModel and
mvs_points_volumetric_model.py:47-118): two Adam chains, the aggregator's
weights at `lr` and the trainable point buffers at `plr`, each scaled by
`make_lr_schedule` read at the optimizer's step count before the update,
with `alter_step` alternating them. Adam follows optax's
``scale_by_adam(0.9, 0.999, eps=1e-8)`` then ``-lr(count)``: torch's Adam
with the group's lr set from the schedule before each step is the same
update (`Adam`: capturable on the card, its count mirrored on the host).
The JAX package packs the point moments into one [cap, 42] array
for the TPU's lane tiling; Adam is elementwise, so the port keeps one
moment per buffer. The port updates the state in place (`train_step`
returns the same object). `expand_capacity` grows the point buffers: new
leaf tensors, a rebuilt point optimizer whose moments are padded with
zeros and whose step count carries over.

`train_steps_scan` is JAX's multi-step dispatch (`lax.scan` over S
steps): on the card one train step captured in a CUDA graph and replayed
S times (`train.graph`), elsewhere the loop of S `train_step`s; either way
the same function as S `train_step` calls, with the items read back once.
The dispatch is traced (`utils.profiling`): spans ``train.dispatch``,
``train.lead`` (entry to the first step's launch; graphed, it holds
``train.inputs``, the knobs and depths put on the card, and
``train.key``, the graph's key checked), ``train.capture`` and
``train.readback``; the row counts of its steps (`models.renderer`) ride
the items' copy as extra columns and add to the trace record's counters.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..models.aggregator import Aggregator, init_aggregator_params
from ..models.losses import compute_losses, over_shards
from ..models.networks import make_lr_schedule
from ..models.neural_points import SENTINEL
from ..models.renderer import render_forward, render_query, render_shade
from ..ops.frustum import build_frustum_grid, draw_jitter
from ..ops.grid import build_grid
from ..ops.query import Shards
from ..utils import profiling

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


class Adam(torch.optim.Adam):
    """torch's Adam at optax's constants (`ADAM`). On the card it is
    capturable: its update count lives on the device and its lr is a 0-d
    device tensor the update reads, so a train step can be captured in a
    CUDA graph (`train.graph`) and the eager step computes the same update.
    `count` mirrors the update count on the host, so the lr schedule is
    read with no device sync; whoever sets the optimizer's state sets it
    too (`utils.checkpoint._load_adam`, `expand_capacity`)."""

    def __init__(self, params, lr: float):
        params = list(params)
        on_card = any(p.is_cuda for p in params)
        rate = torch.tensor(float(lr), dtype=torch.float32,
                            device=params[0].device) if on_card else lr
        super().__init__(params, lr=rate, capturable=on_card, **ADAM)
        self.count = 0
        # eager steps on the card take the capturable update by design
        self._warned_capturable_if_run_uncaptured = True

    def set_lr(self, lr) -> None:
        """The lr of the next update: a Python float, or a 0-d device
        tensor (a captured step's, copied on the device)."""
        for group in self.param_groups:
            if not torch.is_tensor(group["lr"]):
                group["lr"] = float(lr)
            elif torch.is_tensor(lr):
                group["lr"].copy_(lr)
            else:
                group["lr"].fill_(float(lr))


@dataclass
class TrainState:
    """The aggregator, the point buffers split into trainable leaves (the
    point Adam's parameters) and static ones, both optimizers, the step,
    the generator of the depth jitter (on the points' device), and on the
    card the graphed dispatch of its train step (`graph.Dispatch`, made
    by the first graphed train_steps_scan)."""
    aggregator: Aggregator
    pt_train: Dict[str, torch.Tensor]
    pt_static: Dict[str, torch.Tensor]
    opt_net: torch.optim.Adam
    opt_pts: torch.optim.Adam
    step: int
    generator: torch.Generator
    dispatch: Optional[object] = None

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
        opt_net=Adam(aggregator.parameters(), opt.lr),
        opt_pts=Adam(pt_train.values(), opt.plr), step=step,
        generator=generator)


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
    """Updates a torch Adam has made (its parameters share one count),
    read from its state (`Adam.count` holds it on the host)."""
    for group in optim.param_groups:
        for p in group["params"]:
            if "step" in optim.state.get(p, {}):
                return int(optim.state[p]["step"])
    return 0


def jitter_draws(state, batch: Dict, opt) -> Optional[torch.Tensor]:
    """One train render's draws from state.generator (any state with one):
    the depth jitter's uniform draws u [B,R,z_depth_dim] (world
    coordinates), or the shpnt_jitter draws [B,R,SR] (the frustum,
    `ops.frustum.draw_jitter`; None under passfunc)."""
    B, R = batch["raydir"].shape[:2]
    dev = batch["raydir"].device
    if opt.wcoord_query == 0:
        return draw_jitter(opt.shpnt_jitter, (B, R, opt.SR), state.generator,
                           dev)
    return torch.rand((B, R, opt.z_depth_dim), generator=state.generator,
                      device=dev)


def _render(state: TrainState, grid, spec, opt, batch: Dict,
            u: torch.Tensor, shards: Shards = Shards(), priorities=None) -> Dict:
    """Query (no gradient, outside any recomputation), then the shade
    phase, rematerialized in the backward pass when opt.remat is set."""
    with torch.no_grad():
        q = render_query(state.points, grid, spec, opt, batch, is_train=True,
                         u=u, shards=shards, priorities=priorities)
    keys = list(state.pt_train)

    def shade(*train):
        ps = merge_point_params(dict(zip(keys, train)), state.pt_static)
        return render_shade(state.aggregator, ps, spec, opt, batch, q)

    train = [state.pt_train[k] for k in keys]
    if opt.remat > 0:
        # the shade phase draws no random numbers: no RNG state to keep
        return checkpoint(shade, *train, use_reentrant=False,
                          preserve_rng_state=False)
    return shade(*train)


def _chunked_render(state: TrainState, grid, spec, opt, batch: Dict,
                    u: torch.Tensor, shards: Shards = Shards(), priorities=None) -> Dict:
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
        outs.append(_render(state, grid, spec, opt, sub,
                            None if u is None else u[:, sl], shards,
                            priorities))
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


def frustum_grid(points: Dict, grid, batch: Dict, spec):
    """The frustum path's camera grid (a dict holding xyz_pers) of the
    batch's camera, built from the points unless `grid` is one already:
    once per step, not once per ray chunk."""
    if grid is not None and "xyz_pers" in grid:
        return grid
    with torch.no_grad():
        fgrid, xyz_pers = build_frustum_grid(
            points["xyz"].detach(), points["mask"], batch["camrotc2w"],
            batch["campos"], spec)
    return dict(fgrid, xyz_pers=xyz_pers)


def compute_grads(state: TrainState, grid, batch: Dict, opt, spec,
                  u: Optional[torch.Tensor], shards: Shards = Shards(), reduce=None,
                  priorities: Optional[torch.Tensor] = None):
    """Loss items and the gradients of both parameter groups for one batch
    (forward and backward only). u: the render's draws (`jitter_draws`).
    priorities: the frustum's NN ≤ 0 neighbor priorities
    (`ops.frustum.query_frustum_points`), drawn when None. Returns (items,
    net grads by parameter name, point grads by buffer name); items are
    detached.

    A rank of a ray-sharded step (`parallel.dp`) passes its shard of the
    batch with `shards` (its place in the whole batch, for the compaction
    budget, `ops.query.Shards`) and `reduce` (the sum over the shards of a
    vector: the losses' sums and the counters go through it in one call,
    `losses.over_shards`): the items are then the whole batch's, and the
    gradients this shard's part of the whole batch's."""
    if opt.wcoord_query == 0:
        grid = frustum_grid(state.points, grid, batch, spec)
    R = batch["raydir"].shape[1]
    C = int(opt.ray_chunk)
    if C > 0 and R > C and R % C == 0:
        output = _chunked_render(state, grid, spec, opt, batch, u, shards,
                                 priorities)
    else:
        output = _render(state, grid, spec, opt, batch, u, shards,
                         priorities)

    def losses(red):
        total, items = compute_losses(opt, output, batch["gt_image"],
                                      gt_mask=batch.get("gt_mask"),
                                      gt_depth=batch.get("gt_depth"), red=red)
        for k in ("sr_overflow", "occ_overflow"):
            if k in output:
                items[k] = red(output[k].to(torch.float32))
        return total, items
    total, items = losses(lambda x: x) if reduce is None else \
        over_shards(losses, reduce)
    named = dict(state.aggregator.named_parameters())
    params = list(named.values()) + list(state.pt_train.values())
    with profiling.tally(paused=True):  # remat shades again: counted once
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
    in place. u: the render's draws; None draws them from state.generator
    (`jitter_draws`). With alter_step the idle chain gets zero gradients,
    so its Adam moments still decay, as optax's do."""
    if u is None:
        u = jitter_draws(state, batch, opt)
    items, g_net, g_pts = compute_grads(state, grid, batch, opt, spec, u)
    return apply_grads(state, g_net, g_pts, opt), items


def step_knobs(state: TrainState, opt, s: int = 0
               ) -> Tuple[float, float, float, float]:
    """(net_on, pts_on, lr, plr) of the update s steps after the state's:
    the alter_step gates at step state.step + s and each chain's scheduled
    lr at its count + s, all read on the host."""
    net_on = pts_on = 1.0
    if opt.alter_step > 0:
        phase = ((state.step + s) // opt.alter_step) % 2
        net_on, pts_on = float(phase == 0), float(phase == 1)
    return (net_on, pts_on,
            make_lr_schedule(opt, opt.lr)(state.opt_net.count + s),
            make_lr_schedule(opt, opt.plr)(state.opt_pts.count + s))


def apply_grads(state: TrainState, g_net: Dict, g_pts: Dict, opt,
                knobs=None) -> TrainState:
    """The two Adam updates from the gradients by name, in place (the
    second half of `train_step`), and the step counts. knobs: the step's
    (net_on, pts_on, lr, plr) as 0-d device tensors (a captured step,
    `train.graph`); None reads them on the host (`step_knobs`)."""
    net_on, pts_on, lr, plr = step_knobs(state, opt) if knobs is None \
        else knobs
    named = dict(state.aggregator.named_parameters())
    with torch.no_grad():
        for k, g in g_net.items():
            named[k].grad = g * net_on
        for k, g in g_pts.items():
            state.pt_train[k].grad = g * pts_on
    for optim, rate in ((state.opt_net, lr), (state.opt_pts, plr)):
        optim.set_lr(rate)
        optim.step()
        optim.zero_grad(set_to_none=True)
        optim.count += 1
    state.step += 1
    return state


def item_vector(items: Dict[str, torch.Tensor], names) -> torch.Tensor:
    """The items named `names` as one float32 vector on their device."""
    return torch.stack([items[k].to(torch.float32).reshape(())
                        for k in names])


def step_row(items: Dict[str, torch.Tensor], names, tally, counted
             ) -> torch.Tensor:
    """One step's row of a dispatch's readback: the items named `names`
    (float32) and the tally's device counts named `counted` (int64), as
    one float64 vector, which holds both exactly."""
    row = item_vector(items, names).to(torch.float64)
    if not counted:
        return row
    return torch.cat([row, torch.stack([tally.device[k] for k in counted])
                      .to(torch.float64)])


def read_rows(rows: torch.Tensor, names, counted, host: Dict[str, int]
              ) -> Dict[str, torch.Tensor]:
    """A dispatch's step rows [S, items + counts] (`step_row`) to the host
    in one copy: the items by name as float32 CPU tensors [S]; the counts
    summed over the steps, and the host counts `host`, into the trace
    record's counters."""
    with profiling.span("train.readback"):
        values = rows.cpu()
        out = {k: values[:, i].to(torch.float32)
               for i, k in enumerate(names)}
        sums = values[:, len(names):].sum(dim=0)
        for k, v in zip(counted, sums.tolist()):
            profiling.count(k, int(v))
        for k, n in host.items():
            profiling.count(k, n)
    return out


def stacked_step(batches: Dict, s: int) -> Dict:
    """Step s of stacked batches: tensor leaves [S, ...] and lists of S
    host values (near, far: a dataset may give each view its own) indexed
    at s, other leaves (one near, far for every step) as they are."""
    return {k: (v[s] if torch.is_tensor(v) or isinstance(v, (list, tuple))
                else v) for k, v in batches.items()}


def steps_in_turn(step, state, batches: Dict, u=None,
                  launched=lambda: None):
    """S calls of step(state, batch, u) -> (state, items), one per step of
    stacked batches (`stacked_step`), u[s] or None each; the items of
    every step go to the host in one copy, with the steps' row counts
    (`read_rows`). `launched` is called as the first step starts. Returns
    (state, items by name as float32 CPU tensors [S])."""
    S = next(v for v in batches.values() if torch.is_tensor(v)).shape[0]
    names = counted = None
    rows, host = [], {}
    for s in range(S):
        launched()
        with profiling.tally() as t:
            state, items = step(state, stacked_step(batches, s),
                                None if u is None else u[s])
        names = names or sorted(items)
        counted = t.names() if counted is None else counted
        rows.append(step_row(items, names, t, counted))
        for k, n in t.host.items():
            host[k] = host.get(k, 0) + n
    return state, read_rows(torch.stack(rows), names, counted, host)


def train_steps_scan(state: TrainState, grid, batches: Dict, opt, spec,
                     u: Optional[torch.Tensor] = None
                     ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """S optimization steps in one dispatch (JAX trainer.py:291-309, a
    lax.scan of train_step): the same function as S `train_step` calls,
    in place. batches: tensor leaves stacked [S, ...], near and far a
    float each for every step or a list of S (`stacked_step`); u: the
    steps' draws stacked [S, ...], or None to draw each from
    state.generator in step order, as S train_step calls do. Returns
    (state, items): each loss item as a float32 CPU tensor [S], read back
    from the device in one copy.

    On the card a configuration that `graph.graph_route` sends graphed
    replays one captured step (`graph.graphed_steps`); any other, and the
    CPU, runs the S steps one after another."""
    from . import graph
    S = next(v for v in batches.values() if torch.is_tensor(v)).shape[0]
    graphed = state.pt_static["mask"].is_cuda and \
        graph.graph_route(opt) == "graphed"
    with profiling.span("train.dispatch", steps=S,
                        route="graphed" if graphed else "in_turn"):
        lead = profiling.span("train.lead").open()
        try:
            if graphed:
                return graph.graphed_steps(state, grid, batches, opt, spec,
                                           u, launched=lead.close)
            return steps_in_turn(
                lambda st, b, us: train_step(st, grid, b, opt, spec, us),
                state, batches, u, launched=lead.close)
        finally:
            lead.close()


@torch.inference_mode()
def eval_step(state, grid: Dict, batch: Dict, opt, spec,
              prob: bool = False, shards: Shards = Shards()) -> Dict:
    """No-grad forward for test/render (reference base_model.test); with
    `prob` the uncompacted probe render of point growing; `shards` for a
    rank's piece of a wider batch (`models.renderer.comp_budget`)."""
    return render_forward(state.aggregator, point_state_of(state), grid, spec,
                          opt, batch, prob=prob, shards=shards)


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
                        opt, spec, part=None) -> Dict:
    """Render n ray chunks of one camera as ONE wide eval_step.

    Same contract as eval_chunks ([n, 1, C, ...] in and out). Rays are
    independent, so the wide batch renders each chunk's rays as the chunk
    alone would; the compaction budget pools over the group (auto budgets
    scale with the row space; callers scale explicit ones by n). Only
    per-ray outputs come back; `sr_overflow` (a group total) comes back as
    [n] with the total at slot 0.

    part (`ops.query.Shards` with batch 1): render only the piece
    part.index of part.rays equal contiguous pieces of the wide batch's
    rays (a rank of mesh serving, `run.common.render_image`), with the
    compaction budget and groups of the whole wide batch
    (`models.renderer.comp_budget`; the vox-grid's camera-row budget
    through part.prefix); the per-ray outputs come back as [1, n·C/r, ...]
    and `sr_overflow` as this piece's share of the total.
    """
    n, _, C = next(iter(stacked.values())).shape[:3]
    wide = {k: v.reshape((1, n * C) + v.shape[3:]) for k, v in stacked.items()}
    if part is not None:
        i, w = part.index, n * C // part.rays
        wide = {k: v[:, i * w:(i + 1) * w] for k, v in wide.items()}
        return eval_step(state, grid, dict(const_batch, **wide), opt, spec,
                         shards=part)
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
    opt_pts = Adam(new_train.values(), 0.0)
    opt_pts.set_lr(old.param_groups[0]["lr"])
    opt_pts.count = old.count
    for k, p in state.pt_train.items():
        st = old.state.get(p)
        if st:
            opt_pts.state[new_train[k]] = {
                "step": st["step"].clone(),
                "exp_avg": pad(st["exp_avg"], 0.0),
                "exp_avg_sq": pad(st["exp_avg_sq"], 0.0)}
    state.pt_train, state.opt_pts = new_train, opt_pts
    return state
