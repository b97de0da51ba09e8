"""Generalizable (feed-forward) training and inference driver (port of
`pointnerf_tpu/run/train.py`).

Reference: run/train.py and MvsPointsVolumetricModel's feedforward mode
(models/mvs_points_volumetric_model.py:121-132): every step runs MVS depth
→ points → embeddings → render on a new view bundle; the render MLPs and
the MVS feature nets train together (alternating by `alter_step`), and the
points carry no optimizer state (feedforward 1). MVSNet stays frozen.

`maximum_step 0` runs feed-forward inference instead: each test item's
held-out view rendered from its three input views, no per-scene
optimization (the reference's dev_scripts/dtu_test_inf). The JAX package
regenerates the point cloud, and on the frustum path the camera's grid,
for every ray chunk; the points do not depend on the chunk (with
manual_std_depth 0 nothing is drawn, and no eval path jitters), so the
port generates them once per item and renders the image through
`run/common.render_image`, which builds the frustum grid once per image.
With manual_std_depth > 0 the per-chunk draws would differ, and inference
raises. ProbNet (manual_depth_view −1) takes 3-view bundles and dtu's
hold 4 (3 sources and the target): both packages refuse it here
(ROADMAP §3), though ProbNet joins the MVS chain as in JAX.

Usage: python -m pointnerf_tpu_torch.run.train --preset dtu_inf
--data_root <dir> [--device cpu] [Options flags]
"""

from __future__ import annotations

import glob
import os
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..data import create_dataset
from ..models.aggregator import Aggregator, init_aggregator_params
from ..models.losses import compute_losses
from ..models.mvs import points_model as pm
from ..models.networks import make_lr_schedule
from ..models.neural_points import SENTINEL
from ..models.renderer import render_query, render_shade
from ..ops.frustum import draw_jitter, make_frustum_spec
from ..ops.grid import GridSpec, build_grid, make_grid_spec
from ..train.trainer import ADAM, ServeState, _adam_count
from ..utils.checkpoint import load_gen_npz, save_gen_npz
from ..utils.metrics import psnr as psnr_fn
from ..utils.visualizer import Visualizer
from .common import render_image, run_cli

BATCH_KEYS = ("raydir", "campos", "camrotc2w", "bg_color", "gt_image")


@dataclass
class GenTrainState:
    """The aggregator, the MVS nets (MVSNet frozen; the FPN featurenet,
    the premlp and ProbNet trainable), an Adam over each chain, the step,
    and the generator of the render's draws (on the nets' device)."""
    aggregator: Aggregator
    mvs: pm.MvsPoints
    opt_net: torch.optim.Adam
    opt_mvs: torch.optim.Adam
    step: int
    generator: torch.Generator

    def mvs_params(self) -> Dict[str, torch.nn.Parameter]:
        """The trainable MVS parameters by name (featurenet, premlp,
        probnet)."""
        return {k: p for k, p in self.mvs.named_parameters()
                if not k.startswith("mvsnet.")}


def make_gen_state(aggregator: Aggregator, mvs: pm.MvsPoints, opt,
                   generator: torch.Generator, step: int = 0
                   ) -> GenTrainState:
    """GenTrainState around existing nets, with fresh Adam moments: the
    FPN, the premlp and ProbNet require grad, MVSNet does not (JAX's
    split_mvs_params)."""
    mvs.requires_grad_(False)
    for net in (mvs.featurenet, mvs.premlp, mvs.probnet):
        if net is not None:
            net.requires_grad_(True)
    mvs_lr = opt.mvs_lr if opt.mvs_lr is not None else opt.lr
    state = GenTrainState(aggregator, mvs, None, None, step, generator)
    state.opt_net = torch.optim.Adam(aggregator.parameters(), lr=opt.lr,
                                     **ADAM)
    state.opt_mvs = torch.optim.Adam(list(state.mvs_params().values()),
                                     lr=mvs_lr, **ADAM)
    return state


def create_gen_state(opt, generator: Optional[torch.Generator] = None,
                     device="cuda") -> GenTrainState:
    """Seeded aggregator and MVS nets (from `generator`, a CPU generator;
    opt.seed's if None), MVSNet from opt.pre_d_est when set, on `device`
    (the card unless the caller names another)."""
    from .common import load_pretrained_mvsnet
    gen = generator or torch.Generator().manual_seed(opt.seed)
    dev = torch.device(device)
    agg = init_aggregator_params(opt, generator=gen, device=dev)
    mvs = pm.MvsPoints(opt, gen, device=dev)
    if opt.pre_d_est and opt.manual_depth_view > 0:
        mvs.mvsnet = load_pretrained_mvsnet(opt.pre_d_est, dev)
    seed = int(torch.randint(2 ** 62, (1,), generator=gen))
    draws = torch.Generator(device=dev).manual_seed(seed)
    return make_gen_state(agg, mvs, opt, draws)


def feedforward_point_state(mvs: pm.MvsPoints, opt, sample: Dict,
                            noise=None, generator=None,
                            stats: Optional[Dict] = None,
                            depths: Optional[Dict] = None) -> Dict:
    """gen_points (FPN on batch statistics, JAX's training=True at train
    and at inference) → the point state: rejected rows parked at SENTINEL
    and masked off, no padding (JAX's feedforward_point_state,
    NeuralPoints.set_points(parameter=False))."""
    out = pm.gen_points(mvs, opt, sample, noise=noise, generator=generator,
                        stats=stats, training=True, depths=depths)
    keep = out["keep"]
    dev = keep.device
    return {
        "xyz": torch.where(keep[:, None], out["xyz_w"],
                           torch.full((), SENTINEL, device=dev)),
        "embedding": out["embedding"],
        "color": out["color"],
        "dir": out["dir"][:, :3],
        "conf": out["conf"],
        "mask": keep,
        "Rw2c": torch.eye(3, device=dev),
    }


def make_render_spec(opt, ds, n_pts: int) -> GridSpec:
    """The world grid's spec from opt.ranges, or the frustum spec when
    wcoord_query is 0 (the reference's perspective querier, which the
    dtu_test_inf scripts use)."""
    if opt.wcoord_query == 0:
        return make_frustum_spec(opt, ds.intrinsics[0], opt.img_wh[0],
                                 opt.img_wh[1], float(ds.near_far[0]),
                                 float(ds.near_far[1]))
    return make_grid_spec(opt, max_points=n_pts)


def point_slots(opt) -> int:
    """Point slots a bundle generates: depth views × samples × pixels."""
    return len(str(opt.depth_vid)) * opt.num_each_depth \
        * opt.img_wh[0] * opt.img_wh[1]


def batch_of(item: Dict, dev) -> Dict:
    """A ray item's render batch on `dev`."""
    batch = {k: torch.as_tensor(np.asarray(item[k]), device=dev)
             for k in BATCH_KEYS if k in item}
    batch["near"], batch["far"] = float(item["near"]), float(item["far"])
    return batch


def render_draws(state: GenTrainState, batch: Dict, opt
                 ) -> Optional[torch.Tensor]:
    """One train render's draws from state.generator: the depth jitter's
    uniform draws [B,R,z_depth_dim] (world coordinates), or the
    shpnt_jitter draws [B,R,SR] (frustum)."""
    B, R = batch["raydir"].shape[:2]
    dev = batch["raydir"].device
    if opt.wcoord_query == 0:
        return draw_jitter(opt.shpnt_jitter, (B, R, opt.SR), state.generator,
                           dev)
    return torch.rand((B, R, opt.z_depth_dim), generator=state.generator,
                      device=dev)


def gen_compute_grads(state: GenTrainState, sample: Dict, batch: Dict, opt,
                      spec: GridSpec, u: Optional[torch.Tensor],
                      depths: Optional[Dict] = None):
    """Loss items and the gradients of both chains for one bundle and ray
    batch (JAX's gen_train_step loss_fn): points from the bundle, the world
    grid over them (none on the frustum path: render_query builds the
    camera's), the train render with the draws u (`render_draws`), the
    losses. depths: the frozen MVS half's output (`pm.mvs_depths`),
    computed here when None. Returns (items, net grads by parameter name,
    MVS grads by parameter name); items are detached."""
    ps = feedforward_point_state(state.mvs, opt, sample, depths=depths)
    grid = None
    if opt.wcoord_query != 0:
        with torch.no_grad():
            grid = build_grid(ps["xyz"], ps["mask"], spec)
    with torch.no_grad():
        q = render_query(ps, grid, spec, opt, batch, is_train=True, u=u,
                         generator=state.generator)
    output = render_shade(state.aggregator, ps, spec, opt, batch, q)
    total, items = compute_losses(opt, output, batch["gt_image"],
                                  gt_mask=batch.get("gt_mask"),
                                  gt_depth=batch.get("gt_depth"))
    net = dict(state.aggregator.named_parameters())
    mvs = state.mvs_params()
    params = list(net.values()) + list(mvs.values())
    grads = torch.autograd.grad(total, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    return ({k: torch.as_tensor(v).detach() for k, v in items.items()},
            dict(zip(net, grads[:len(net)])), dict(zip(mvs, grads[len(net):])))


def gen_train_step(state: GenTrainState, sample: Dict, batch: Dict, opt,
                   spec: GridSpec, u: Optional[torch.Tensor] = None):
    """One generalizable step, in place (JAX's gen_train_step): the
    gradients, alter_step's phase masks (the idle chain gets zeros, so its
    moments decay as optax's do), then each chain's Adam at its schedule's
    lr (mvs_lr, else lr, for the MVS chain). u None draws from
    state.generator. Returns (state, items)."""
    if u is None:
        u = render_draws(state, batch, opt)
    items, g_net, g_mvs = gen_compute_grads(state, sample, batch, opt, spec,
                                            u)
    net_on = mvs_on = 1.0
    if opt.alter_step > 0:
        phase = (state.step // opt.alter_step) % 2
        net_on, mvs_on = float(phase == 0), float(phase == 1)
    net, mvs = dict(state.aggregator.named_parameters()), state.mvs_params()
    with torch.no_grad():
        for k, g in g_net.items():
            net[k].grad = g * net_on
        for k, g in g_mvs.items():
            mvs[k].grad = g * mvs_on
    mvs_lr = opt.mvs_lr if opt.mvs_lr is not None else opt.lr
    for optim, base in ((state.opt_net, opt.lr), (state.opt_mvs, mvs_lr)):
        lr = make_lr_schedule(opt, base)(_adam_count(optim))
        for group in optim.param_groups:
            group["lr"] = lr
        optim.step()
        optim.zero_grad(set_to_none=True)
    state.step += 1
    return state, items


def latest_gen_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The newest {steps}_gen.npz in ckpt_dir, or None."""
    cands = sorted(glob.glob(os.path.join(ckpt_dir, "*_gen.npz")),
                   key=lambda p: int(os.path.basename(p).split("_")[0]))
    return cands[-1] if cands else None


@torch.inference_mode()
def infer_item(state: GenTrainState, opt, spec: GridSpec, item: Dict,
               stats: Optional[Dict] = None) -> np.ndarray:
    """One item's held-out view [H,W,3]: points from its bundle, once, then
    the full image through render_image (the frustum grid built once, or
    the world grid over the points). `stats`, if given, receives host
    seconds (points_s: gen_points; render_s: grid and render, each ending
    in a device sync), gen_points' phases and render_image's counters."""
    stats = {} if stats is None else stats
    sample = item["mvs_sample"]
    dev = next(state.mvs.parameters()).device
    t0 = time.perf_counter()
    ps = feedforward_point_state(state.mvs, opt, sample, stats=stats)
    pm.synchronize(dev)
    t1 = time.perf_counter()
    grid = None if opt.wcoord_query == 0 else \
        build_grid(ps["xyz"], ps["mask"], spec)
    maps = render_image(ServeState(state.aggregator, ps), grid, opt, spec,
                        item, stats=stats)
    pm.synchronize(dev)
    stats.update(points_s=t1 - t0, render_s=time.perf_counter() - t1,
                 n_points=int(ps["mask"].sum()))
    return maps["coarse_raycolor"]


def inference(opt, state: Optional[GenTrainState] = None,
              max_images: Optional[int] = None, device="cuda") -> Dict:
    """Feed-forward novel-view synthesis on the test split (reference:
    dev_scripts/dtu_test_inf/*.sh, train.py with maximum_step 0): each
    item's held-out target view, rendered and scored by PSNR. Without a
    state: a seeded one, loaded from the newest {steps}_gen.npz of the
    experiment if there is one. Returns {"psnr": mean, "n", "psnrs"}."""
    if opt.manual_std_depth > 0:
        raise ValueError(
            "feed-forward inference generates each item's points once; with "
            "manual_std_depth > 0 the JAX package draws new depth jitter for "
            "every ray chunk, so set manual_std_depth 0")
    visualizer = Visualizer(opt)
    test_ds = create_dataset(opt, split="test")
    spec = make_render_spec(opt, test_ds, point_slots(opt))
    if state is None:
        state = create_gen_state(opt, device=device)
        path = latest_gen_checkpoint(os.path.join(opt.checkpoints_dir,
                                                  opt.experiment))
        if path:
            state = load_gen_npz(path, opt, device)
            visualizer.print_details(f"loaded {path}")
    n = len(test_ds) if max_images is None else min(max_images, len(test_ds))
    psnrs = []
    for i in range(n):
        item = test_ds.get_item(i, full_img=True)
        img = infer_item(state, opt, spec, item)
        H, W = int(item["h"]), int(item["w"])
        gt = item["gt_image"][0].reshape(H, W, 3)
        psnrs.append(psnr_fn(gt, img))
        visualizer.display_current_results(
            {"coarse_raycolor": img, "gt_image": gt}, i, subdir="inference")
    mean = float(np.mean(psnrs))
    visualizer.print_details(f"feed-forward inference PSNR {mean:.3f} over "
                             f"{n}")
    return {"psnr": mean, "n": n, "psnrs": psnrs}


def main(opt, max_steps: Optional[int] = None, device="cuda") -> Dict:
    """maximum_step 0: inference; otherwise generalizable training on the
    train split, a random item a step, with {steps}_gen.npz checkpoints
    every save_iter_freq steps and at the end."""
    if opt.maximum_step == 0:
        return inference(opt, device=device)
    dev = torch.device(device)
    rng = np.random.RandomState(opt.seed)
    ckpt_dir = os.path.join(opt.checkpoints_dir, opt.experiment)
    os.makedirs(ckpt_dir, exist_ok=True)
    visualizer = Visualizer(opt)
    train_ds = create_dataset(opt, split="train")
    spec = make_render_spec(opt, train_ds, point_slots(opt))
    state = create_gen_state(opt, device=dev)
    total_steps = 0
    stop_at = min(opt.maximum_step, max_steps or opt.maximum_step)
    items: Dict = {}
    t0 = time.time()
    while total_steps < stop_at:
        item = train_ds.get_item(int(rng.randint(len(train_ds))), rng=rng)
        sample = item.pop("mvs_sample")
        state, items = gen_train_step(state, sample, batch_of(item, dev),
                                      opt, spec)
        total_steps += 1
        visualizer.accumulate_losses({k: float(v) for k, v in items.items()})
        if total_steps % opt.print_freq == 0:
            visualizer.print_losses(total_steps)
        if total_steps % opt.save_iter_freq == 0 or total_steps == stop_at:
            save_gen_npz(os.path.join(ckpt_dir, f"{total_steps}_gen.npz"),
                         state)
    visualizer.print_details(
        f"generalizable training done: {total_steps} steps in "
        f"{time.time() - t0:.1f}s")
    return {"total_steps": total_steps, "state": state, "spec": spec,
            "last_items": {k: float(v) for k, v in items.items()}}


def cli(argv=None) -> Dict:
    """The command line: --device (default cuda) and the Options flags."""
    return run_cli(main, argv)


if __name__ == "__main__":
    cli()
