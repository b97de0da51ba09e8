"""Every input of a run, made from its seed on the device: the point cloud,
the aggregator's weights, the train views and ray draws, the render poses.

The same seed gives the same inputs, so the reference is handed what the
program was handed by making them again. Work does not depend on the seed
beyond the draws themselves: the cloud's size and shape, the views'
sphere and the render path's elevation are fixed by the configuration.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from .reference.model import layer_dims, weight_shapes

LEAKY_GAIN = math.sqrt(2.0 / (1 + 0.1 ** 2))


def generator(seed: int, device, stream: int) -> torch.Generator:
    """An independent stream `stream` of the run's seed on `device`."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % (2 ** 63))


def cloud(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The synthetic scene: an ellipsoid shell at cloud.shell of the
    options' ranges, with the share cloud.fill of the points uniform in
    the ranges instead (the port's `run/workload.py::make_cloud` at fill
    0.5, from a torch generator): xyz, embedding in ±0.5, colour, unit
    direction, conf."""
    o, n = cfg["options"], int(cfg["cloud"]["points"])
    g = generator(seed, device, 1)
    mn = torch.tensor(o["ranges"][:3], dtype=torch.float32, device=device)
    mx = torch.tensor(o["ranges"][3:], dtype=torch.float32, device=device)
    xyz = mn + (mx - mn) * torch.rand((n, 3), generator=g, device=device)
    shell = xyz / (torch.linalg.norm(xyz / (mx - mn), dim=-1, keepdim=True)
                   + 1e-6) * float(cfg["cloud"]["shell"])
    fill = torch.rand((n, 1), generator=g, device=device) \
        < float(cfg["cloud"]["fill"])
    xyz = torch.where(fill, xyz, shell)
    F = o["point_features_dim"]
    attrs = torch.rand((n, F + 3), generator=g, device=device)
    dirs = torch.randn((n, 3), generator=g, device=device)
    return {"xyz": xyz.contiguous(),
            "embedding": (attrs[:, :F] - 0.5).contiguous(),
            "color": attrs[:, F:].contiguous(),
            "dir": dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True),
            "conf": torch.full((n, 1), float(cfg["cloud"]["conf"]),
                               device=device)}


def weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The aggregator's weights by checkpoint name: Xavier-uniform (the
    LeakyReLU gain on layers an activation follows), biases uniform in
    ±cfg weights.bias, the alpha head's output bias raised by weights.
    alpha_bias so that surfaces are opaque, as a fitted scene's are; one
    draw for all of them."""
    o = cfg["options"]
    shapes = weight_shapes(o)
    sizes = [math.prod(s) for s in shapes.values()]
    flat = 2.0 * torch.rand((sum(sizes),), generator=generator(seed, device, 2),
                            device=device) - 1.0
    heads = {n: len(d) - 1 for n, d in layer_dims(o).items()
             if n in ("alpha_branch", "color_branch")}
    out, off = {}, 0
    for (name, shape), size in zip(shapes.items(), sizes):
        part = flat[off:off + size].reshape(shape)
        off += size
        branch, idx = name.split(".")[:2]
        last = branch in heads and int(idx) // 2 == heads[branch] - 1
        if name.endswith("bias"):
            out[name] = part * float(cfg["weights"]["bias"]) + (
                float(cfg["weights"]["alpha_bias"])
                if last and branch == "alpha_branch" else 0.0)
            continue
        gain = 1.0 if last else LEAKY_GAIN
        out[name] = part * (gain * math.sqrt(6.0 / (shape[0] + shape[1])))
    return out


def look_at(campos: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """OpenCV camera-to-world rotations [n,3,3] (x right, y down, z
    forward) of cameras at campos [n,3] looking at target [3], z up."""
    fwd = target - campos
    fwd = fwd / torch.linalg.norm(fwd, dim=-1, keepdim=True)
    up = torch.tensor([0.0, 0.0, 1.0], device=campos.device).expand_as(fwd)
    right = torch.linalg.cross(fwd, up)
    right = right / torch.linalg.norm(right, dim=-1, keepdim=True)
    down = torch.linalg.cross(fwd, right)
    return torch.stack([right, down, fwd], dim=-1)


def camera_positions(cam: Dict, azimuth: torch.Tensor,
                     elevation: torch.Tensor) -> torch.Tensor:
    t = torch.tensor(cam["target"], device=azimuth.device)
    r = float(cam["radius"])
    return t + r * torch.stack([torch.cos(elevation) * torch.cos(azimuth),
                                torch.cos(elevation) * torch.sin(azimuth),
                                torch.sin(elevation)], dim=-1)


def ray_dirs(cam: Dict, rot: torch.Tensor, px: torch.Tensor,
             py: torch.Tensor) -> torch.Tensor:
    """Unnormalised world directions through pixel centres (the datasets'
    dir_norm 0): rot [n,3,3], px/py [n,R] → [n,R,3]."""
    W, H = cam["wh"]
    f = float(cam["focal"])
    d = torch.stack([(px + 0.5 - W / 2) / f, (py + 0.5 - H / 2) / f,
                     torch.ones_like(px)], dim=-1)
    return torch.einsum("nrj,nij->nri", d, rot)


def train_pool(cfg: Dict, traffic: Dict, seed: int, device) -> List[Dict]:
    """The train mix's dispatches: each S steps of R random pixels of a
    view on the configuration's sphere and their gt colours. A dispatch is
    {"batches": leaves stacked [S,1,...] with near and far, "u_seed": the
    seed of its depth draws (`draws`)}."""
    o, cam = cfg["options"], cfg["cameras"]
    S, n = int(traffic["steps_per_dispatch"]), int(traffic["pool_dispatches"])
    R = o["random_sample_size"] ** 2
    g = generator(seed, device, 3)
    views = S * n
    az = 2 * math.pi * torch.rand((views,), generator=g, device=device)
    lo, hi = cam["train_elevation"]
    el = lo + (hi - lo) * torch.rand((views,), generator=g, device=device)
    pos = camera_positions(cam, az, el)
    rot = look_at(pos, torch.tensor(cam["target"], device=device))
    W, H = cam["wh"]
    px = torch.randint(0, W, (views, R), generator=g, device=device).float()
    py = torch.randint(0, H, (views, R), generator=g, device=device).float()
    raydir = ray_dirs(cam, rot, px, py)
    gt = torch.rand((views, R, 3), generator=g, device=device)
    bg = torch.ones((views, 3), device=device)
    pool = []
    for i in range(n):
        s = slice(i * S, (i + 1) * S)
        pool.append({"batches": {
            "raydir": raydir[s, None].contiguous(),
            "campos": pos[s, None].contiguous(),
            "camrotc2w": rot[s, None].contiguous(),
            "bg_color": bg[s, None].contiguous(),
            "gt_image": gt[s, None].contiguous(),
            "near": float(o["near_plane"]), "far": float(o["far_plane"])},
            "u_seed": (int(seed) * 1_000_003 + 1000 + i) % (2 ** 63)})
    return pool


def draws(dispatch: Dict, out: torch.Tensor) -> torch.Tensor:
    """The dispatch's ray-depth draws u [S,1,R,z_depth_dim], uniform in
    [0,1), made from its seed into `out`, a buffer used again for every
    dispatch, as a trainer draws each step's anew."""
    g = torch.Generator(device=out.device).manual_seed(dispatch["u_seed"])
    return torch.rand(out.shape, generator=g, device=out.device, out=out)


def step_of(dispatch: Dict, s: int) -> Dict:
    """Step s of a dispatch as one camera's batch for the reference."""
    b = dispatch["batches"]
    return {"raydir": b["raydir"][s, 0], "campos": b["campos"][s, 0],
            "camrotc2w": b["camrotc2w"][s, 0], "bg_color": b["bg_color"][s],
            "gt_image": b["gt_image"][s, 0], "near": b["near"],
            "far": b["far"]}


def render_path(cfg: Dict, traffic: Dict, seed: int, device) -> List[Dict]:
    """The render mix's poses: `views` cameras evenly spaced in azimuth at
    the configuration's render elevation, in an order drawn from the
    seed: every seed renders the same views, so the same work. Each pose
    is {"view": its azimuth's index, "campos" [3], "camrotc2w" [3,3],
    "raydir" [H·W,3] row-major pixels}."""
    cam = cfg["cameras"]
    n = int(traffic["views"])
    g = generator(seed, device, 4)
    order = torch.argsort(torch.rand((n,), generator=g, device=device))
    az = 2 * math.pi * order.to(torch.float32) / n
    el = torch.full((n,), float(cam["render_elevation"]), device=device)
    pos = camera_positions(cam, az, el)
    rot = look_at(pos, torch.tensor(cam["target"], device=device))
    W, H = cam["wh"]
    py, px = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float32),
                            torch.arange(W, device=device,
                                         dtype=torch.float32), indexing="ij")
    px, py = px.reshape(1, -1), py.reshape(1, -1)
    return [{"view": int(order[i]), "campos": pos[i], "camrotc2w": rot[i],
             "raydir": ray_dirs(cam, rot[i:i + 1], px, py)[0]}
            for i in range(n)]
