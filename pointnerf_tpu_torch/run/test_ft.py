"""Test driver: load a checkpoint, render the held-out split, score it
(port of `pointnerf_tpu/run/test_ft.py`).

Reference: run/test_ft.py:276-353 — loads the best or latest checkpoint and
runs test() with PSNR/SSIM/LPIPS as run/evaluate.py scores them. The
checkpoint is JAX's `{iter}_full.npz` layout, written by either package;
its point capacity is read from the file (the JAX driver retries through
`expand_capacity` when a grow changed it).

Usage: python -m pointnerf_tpu_torch.run.test_ft --preset tt:Truck \
           --data_root <dir> [--resume_iter N] [--lpips_alex_path F]
           [--lpips_vgg_path F] [--device cpu]
"""

from __future__ import annotations

import os
from typing import Dict

from ..data import create_dataset
from ..parallel.driver import launch, world_size
from ..train import trainer
from ..utils.checkpoint import latest_step, load_checkpoint
from ..utils.visualizer import Visualizer
from .common import make_spec_and_grid, run_cli
from .train_ft import score_test_images, test


def main(opt, device="cuda") -> Dict:
    """Render the test split (opt.test_num images, all if ≤ 0) from the
    checkpoint of opt.resume_iter (the newest for latest, best or "") on
    `device` (the card unless the caller names another) into
    images/test_{step}/, and score it there (scores.txt; LPIPS from
    opt.lpips_alex_path / lpips_vgg_path, skipped where none is given).
    Returns the mean PSNR of the renders, the scores and the step. Options
    that ask for more than one device render by mesh serving on that many
    ranks (`parallel.driver.launch`); rank 0 loads the checkpoint, writes
    the images and scores them."""
    ckpt_dir = opt.resume_dir or os.path.join(opt.checkpoints_dir,
                                              opt.experiment)
    n = world_size(opt, device)
    if n:
        return launch(_test, (opt, ckpt_dir), n, opt.mesh_points, device,
                      ckpt_dir)
    return _test(opt, ckpt_dir, device)


def _test(opt, ckpt_dir: str, device, runner=None) -> Dict:
    main_rank = runner is None or runner.is_main
    visualizer = Visualizer(opt) if runner is None else \
        runner.visualizer(lambda: Visualizer(opt))
    test_ds = create_dataset(opt, split="test")
    step = None if opt.resume_iter in ("", "latest", "best") \
        else int(opt.resume_iter)
    found = latest_step(ckpt_dir) if step is None else step
    if found is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    ts = grid = spec = None
    if main_rank:
        ts, counters = load_checkpoint(ckpt_dir, opt, device=device,
                                       step=found)
        spec, grid = make_spec_and_grid(opt, trainer.point_state_of(ts))
        visualizer.print_details(f"loaded step {found} (best_PSNR "
                                 f"{counters.get('best_PSNR', 0):.3f})")
    if runner is not None:
        visualizer.print_details(runner.describe())
        ts = runner.place_state(ts, opt)
        spec = runner.mesh.broadcast_object(spec)
        grid = runner.place_grid(grid, spec)
    mean_psnr = test(ts, grid, opt, spec, test_ds, visualizer, found,
                     max_images=opt.test_num if opt.test_num > 0 else None,
                     runner=runner)
    scores = None
    if main_rank:
        scores = score_test_images(visualizer, found, opt, device)
        visualizer.print_details(f"scores: {scores}")
    return {"psnr": mean_psnr, "scores": scores, "step": found}


if __name__ == "__main__":
    run_cli(main)
