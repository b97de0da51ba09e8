"""Video driver: render the dataset's render path and assemble a video
(port of `pointnerf_tpu/run/render_vid.py`).

Reference: run/render_vid.py:26-79 — chunked renders over the render
poses, frames saved, then assembled by Visualizer.gen_video (an animated
GIF in the port, `utils/gif.py`; an mp4 in the JAX package).

Usage: python -m pointnerf_tpu_torch.run.render_vid --preset nerf_synth:lego \
           --data_root <dir> [--device cpu] [--flag value ...]
"""

from __future__ import annotations

import os
from typing import Dict

from ..data import create_dataset
from ..parallel.driver import launch, world_size
from ..train import trainer
from ..utils.checkpoint import latest_step, load_checkpoint
from ..utils.visualizer import Visualizer
from .common import make_spec_and_grid, render_image, run_cli


def render_vid(ts, grid, opt, spec, dataset, visualizer, total_steps: int = 0,
               fps: int = 24, runner=None) -> Dict:
    """Render every pose of `dataset`'s render split (full images,
    random_sample no_crop; by mesh serving under a runner) into
    images/vid_{total_steps}/, then the video vids/video_{total_steps}.gif.
    Returns its path (None on a rank other than 0) and the frame count."""
    frames = []
    for i in range(len(dataset)):
        item = dataset.get_dummyrot_item(i)
        maps = render_image(ts, grid, opt.replace(random_sample="no_crop"),
                            spec, item, keys=("coarse_raycolor",),
                            runner=runner)
        visualizer.display_current_results(
            {"coarse_raycolor": maps["coarse_raycolor"]}, i,
            subdir=f"vid_{total_steps}")
        frames.append(i)
    path = visualizer.gen_video(
        f"video_{total_steps}",
        os.path.join(visualizer.image_dir, f"vid_{total_steps}"),
        "step-%04d-coarse_raycolor.png", frames, fps=fps)
    visualizer.print_details(f"video written to {path}")
    return {"video": path, "n_frames": len(frames)}


def main(opt, device="cuda") -> Dict:
    """Load the newest checkpoint of resume_dir (or checkpoints_dir/
    experiment) on `device` (the card unless the caller names another) and
    render the video (`render_vid`). Options that ask for more than one
    device render by mesh serving on that many ranks
    (`parallel.driver.launch`); rank 0 loads the checkpoint and writes the
    frames and the video."""
    ckpt_dir = opt.resume_dir or os.path.join(opt.checkpoints_dir,
                                              opt.experiment)
    n = world_size(opt, device)
    if n:
        return launch(_render, (opt, ckpt_dir), n, opt.mesh_points, device,
                      ckpt_dir)
    return _render(opt, ckpt_dir, device)


def _render(opt, ckpt_dir: str, device, runner=None) -> Dict:
    main_rank = runner is None or runner.is_main
    visualizer = Visualizer(opt) if runner is None else \
        runner.visualizer(lambda: Visualizer(opt))
    render_ds = create_dataset(opt, split="render")
    found = latest_step(ckpt_dir)
    if found is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    ts = grid = spec = None
    if main_rank:
        ts, _ = load_checkpoint(ckpt_dir, opt, device=device, step=found)
        spec, grid = make_spec_and_grid(opt, trainer.point_state_of(ts))
    if runner is not None:
        ts = runner.place_state(ts, opt)
        spec = runner.mesh.broadcast_object(spec)
        grid = runner.place_grid(grid, spec)
    return render_vid(ts, grid, opt, spec, render_ds, visualizer, found,
                      runner=runner)


if __name__ == "__main__":
    run_cli(main)
