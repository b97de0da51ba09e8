"""Scene editing: compose point subsets of several checkpoints, each moved
by a rigid transform, and render the composite (port of
`pointnerf_tpu/run/editing.py`).

Reference: run/editing.py:123-237. Per part: a source checkpoint under
checkpoints_dir/edit_srcs/<name>/, a subset parts_index/<inds>.txt of its
active points (or "all"), a 4x4 transform transforms/<trans>.txt (or
"no"). A moved part carries the per-point Rw2c = Rw2c_old @ Rotᵀ, so its
view directions, distances and point dirs turn with it (editing.py:203);
the first part's aggregator shades the whole composite.

As the JAX driver: the `pnts` point dump, the test split rendered and
scored, the render path's video, and the composite's
`0_net_ray_marching.npz`. Unlike it: the video is skipped only for a
dataset with no render split (with a line in the log) and any other
failure raises (JAX swallows every exception there), and the composite
is saved through `save_checkpoint`, so `0_states.npz` and `0_full.npz`
sit beside the npz and `test_ft` and `render_vid` read it back.

Usage: python -m pointnerf_tpu_torch.run.editing --preset nerf_synth:lego \
           --data_root <dir> --neural_points_names lego lego \
           --parts_index_names all seat --Transformation_names no rot90 \
           [--device cpu] [Options flags]
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..data import create_dataset, find_dataset_class_by_name
from ..models import neural_points as npc
from ..models.aggregator import aggregator_from_layers
from ..train import trainer
from ..utils.checkpoint import (latest_step, load_net_ray_marching_npz,
                                load_reference_torch, save_checkpoint)
from ..utils.visualizer import Visualizer
from .common import make_spec_and_grid, run_cli
from .train_ft import test


def load_part(ckpt_root: str, name: str, inds_name: str, trans_name: str,
              opt) -> Tuple[Dict, Dict, np.ndarray, np.ndarray, np.ndarray]:
    """(agg_params, point_arrays, keep_inds, Rot, Tran) of one part
    (reference load_parts_info, editing.py:123-138): the newest step's
    `_net_ray_marching.npz` of edit_srcs/<name>, else its last
    `*_net_ray_marching.pth`; the subset as np.loadtxt(...).astype(bool)."""
    src = os.path.join(ckpt_root, "edit_srcs", name)
    step = latest_step(src)
    npz_path = os.path.join(src, f"{step}_net_ray_marching.npz") \
        if step is not None else None
    if npz_path and os.path.exists(npz_path):
        agg, pts = load_net_ray_marching_npz(npz_path)
    else:
        cands = sorted(glob.glob(os.path.join(src, "*_net_ray_marching.pth")))
        if not cands:
            raise FileNotFoundError(f"no checkpoint under {src}")
        agg, pts = load_reference_torch(cands[-1], opt)
    n = len(pts["xyz"])
    inds_file = os.path.join(src, "parts_index", inds_name + ".txt")
    inds = np.ones(n, bool) if inds_name.strip() == "all" else \
        np.loadtxt(inds_file).astype(bool)
    trans_file = os.path.join(src, "transforms", trans_name + ".txt")
    M = np.eye(4, dtype=np.float32) if trans_name.strip() == "no" else \
        np.loadtxt(trans_file).astype(np.float32)
    return agg, pts, inds, M[:3, :3], M[:3, 3]


def compose_parts(parts, opt, device="cuda") -> Tuple[Dict, Dict]:
    """The moved parts concatenated into one padded point state on
    `device`, with per-point Rw2c; a missing color is 0.5, a missing conf
    0.5, a missing dir zeros. Returns (the first part's agg_params in the
    JAX layout, the state) (reference: editing.py:179-216)."""
    agg0 = None
    xyz_l, emb_l, col_l, dir_l, conf_l, rw2c_l = [], [], [], [], [], []
    for agg, pts, inds, Rot, Tran in parts:
        if agg0 is None:
            agg0 = agg
        xyz = pts["xyz"][inds]
        xyz = xyz @ Rot.T + Tran
        rw2c_old = pts.get("Rw2c", np.eye(3, dtype=np.float32))
        if rw2c_old.ndim == 2:
            rw2c = rw2c_old @ Rot.T            # (editing.py:203)
            rw2c = np.tile(rw2c[None], (len(xyz), 1, 1))
        else:
            rw2c = rw2c_old[inds] @ Rot.T
        xyz_l.append(xyz)
        emb_l.append(pts["embedding"][inds])
        col_l.append(pts["color"][inds] if pts.get("color") is not None
                     else np.full((len(xyz), 3), 0.5, np.float32))
        dir_l.append(pts["dir"][inds] @ Rot.T if pts.get("dir") is not None
                     else np.zeros((len(xyz), 3), np.float32))
        conf_l.append(pts["conf"][inds] if pts.get("conf") is not None
                      else np.full((len(xyz), 1), 0.5, np.float32))
        rw2c_l.append(rw2c)
    state = npc.create_point_cloud(
        np.concatenate(xyz_l), np.concatenate(emb_l), np.concatenate(col_l),
        np.concatenate(dir_l), np.concatenate(conf_l),
        Rw2c=np.concatenate(rw2c_l), device=device)
    return agg0, state


def parse_parts(argv=None) -> Tuple[argparse.Namespace, List[str]]:
    """The editing flags (--neural_points_names, --parts_index_names,
    --Transformation_names, --render_name) and the rest of argv."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--neural_points_names", nargs="+", required=True)
    p.add_argument("--parts_index_names", nargs="+", required=True)
    p.add_argument("--Transformation_names", nargs="+", required=True)
    p.add_argument("--render_name", type=str, default="edited")
    return p.parse_known_args(argv)


def main(opt, names: List[str], inds_names: List[str],
         trans_names: List[str], device="cuda") -> Dict:
    """Compose the parts, dump the points (points/pnts.txt), render and
    score the test split (opt.test_num images, all if ≤ 0) and the
    render path's video (a dataset with a render split), and save the
    composite as step 0 of checkpoints_dir/experiment, on `device` (the
    card unless the caller names another). Returns n_points, psnr, video, n_frames."""
    visualizer = Visualizer(opt)
    parts = [load_part(opt.checkpoints_dir, n, i, t, opt)
             for n, i, t in zip(names, inds_names, trans_names)]
    agg_params, state = compose_parts(parts, opt, device)
    layers = {name: [(np.asarray(l["w"], np.float32).T, l["b"]) for l in ls]
              for name, ls in agg_params.items()}
    agg = aggregator_from_layers(layers, opt.act_type).to(device)
    ts = trainer.make_train_state(
        agg, state, opt, torch.Generator(device=device).manual_seed(
            opt.seed))
    spec, grid = make_spec_and_grid(opt, trainer.point_state_of(ts))
    visualizer.save_neural_points(
        "pnts", state["xyz"].cpu().numpy(), state["color"].cpu().numpy(),
        mask=state["mask"].cpu().numpy())

    out: Dict = {"n_points": int(npc.num_active(state))}
    test_ds = create_dataset(opt, split="test")
    out["psnr"] = test(ts, grid, opt, spec, test_ds, visualizer, 0,
                       max_images=opt.test_num if opt.test_num > 0 else None)
    if hasattr(find_dataset_class_by_name(opt.dataset_name),
               "get_dummyrot_item"):
        from .render_vid import render_vid
        out.update(render_vid(ts, grid, opt, spec,
                              create_dataset(opt, split="render"),
                              visualizer, 0))
    else:
        visualizer.print_details(f"video skipped: dataset "
                                 f"{opt.dataset_name} has no render split")
    # the composite at step 0 (reference editing.py:232-237)
    save_checkpoint(os.path.join(opt.checkpoints_dir, opt.experiment), 0,
                    ts, opt)
    return out


def cli(argv=None) -> Dict:
    """The command line: the editing flags, --device (default cuda) and
    the Options flags."""
    ns, rest = parse_parts(argv)
    return run_cli(lambda opt, device: main(
        opt, ns.neural_points_names, ns.parts_index_names,
        ns.Transformation_names, device=device), rest)


if __name__ == "__main__":
    cli()
