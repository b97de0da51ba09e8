"""The render mix: whole images of the given-cloud model through
`run.common.render_image`, one after another, from a seeded path of
poses, cycled (gpubench/mix.py says what the loop reads here)."""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from gpubench.mix import cloud_model, reference_scene, span

FAULTS = ("pixels", "half")
UNIT = "images"


class Render:
    """The render mix: whole images through `render_image`, one after
    another, from a seeded path of poses, cycled."""

    def __init__(self, spec: Dict, seed: int, card,
                 fault: Optional[str]):
        from gpubench import inputs, system
        self.spec, self.seed, self.card, self.fault = spec, seed, card, fault
        cfg, traffic = spec["cfg"], spec["traffic"]
        dev = card.device
        if card.cuda:
            system.build_kernels()
        self.opt = system.options(cfg)
        self.path = inputs.render_path(cfg, traffic, seed, dev)
        self.items = [self._item(p) for p in self.path]
        cloud = inputs.cloud(cfg, seed, dev)
        state = system.point_state(cloud)
        del cloud
        self.grid_spec, self.grid = system.grid(self.opt, state)
        agg = system.aggregator(self.opt, inputs.weights(cfg, seed, dev), dev)
        self.ss = system.serve_state(agg, state)
        self.group = int(traffic["group"])
        W, H = cfg["cameras"]["wh"]
        self.rays = W * H
        self.images: List[np.ndarray] = []
        self.ladder: List[int] = []
        self.seconds: List[float] = []
        # warm-up: the view at azimuth 0 for every seed, so that set-up
        # does the same work whatever the order (views differ in work)
        self.call(self.items[[p["view"] for p in self.path].index(0)])
        self.next = 0

    def _item(self, pose: Dict) -> Dict:
        cam, o = self.spec["cfg"]["cameras"], self.spec["cfg"]["options"]
        W, H = cam["wh"]
        py, px = np.meshgrid(np.arange(H, dtype=np.float32),
                             np.arange(W, dtype=np.float32), indexing="ij")
        return {"h": H, "w": W,
                "pixel_idx": np.stack([px, py], -1).reshape(1, -1, 2),
                "raydir": pose["raydir"].cpu().numpy()[None],
                "campos": pose["campos"].cpu().numpy()[None],
                "camrotc2w": pose["camrotc2w"].cpu().numpy()[None],
                "near": np.float32(o["near_plane"]),
                "far": np.float32(o["far_plane"]),
                "bg_color": np.ones((1, 3), np.float32)}

    def call(self, item: Dict):
        from gpubench import system
        if self.fault == "half":
            n = item["raydir"].shape[1] // 2
            item = dict(item, raydir=item["raydir"][:, :n],
                        pixel_idx=item["pixel_idx"][:, :n])
        stats: Dict = {}
        with span("render_image"):
            maps = system.render(self.ss, self.grid, self.grid_spec,
                                 self.opt, item, self.group, stats)
        img = maps["coarse_raycolor"]
        if self.fault == "pixels":
            img[:60, :60] += 0.05
        return img, stats

    def unit(self) -> tuple:
        """One image of the window: (pose index, images, failed)."""
        i = self.next % len(self.items)
        self.next += 1
        t0 = time.perf_counter()
        img, stats = self.call(self.items[i])
        self.seconds.append(time.perf_counter() - t0)
        self.images.append(img)
        self.ladder.append(int(stats["sr_overflow"]))
        return i, 1, int(not np.all(np.isfinite(img)))

    def notes(self) -> str:
        return f"rows up the budget ladder, by image: {self.ladder}"

    def free(self):
        import torch
        del self.ss, self.grid
        torch.cuda.empty_cache() if self.card.cuda else None

    def reference(self, control: bool = False, sample: List[int] = ()
                  ) -> Dict[str, float]:
        """The reference's render of the sampled images of the window
        (their pose indices in `sample`), against the program's (or, for
        the control, against the reference's own in TF32)."""
        import torch
        from gpubench import check, inputs
        from gpubench.reference import model, tf32
        cfg, dev = self.spec["cfg"], self.card.device
        o = cfg["options"]
        W, H = cfg["cameras"]["wh"]
        cloud, spec, g = reference_scene(self.spec, self.seed, dev)
        Wt = inputs.weights(cfg, self.seed, dev)
        bg = torch.ones((1, 3), device=dev)

        def ref_image(pose):
            return model.render(Wt, o, cloud, g, spec, pose["campos"],
                                pose["camrotc2w"], pose["raydir"], bg
                                ).reshape(H, W, 3).cpu().numpy()
        prog, ref = [], []
        for k, n in sample:
            pose = self.path[n]
            ref.append(ref_image(pose))
            if control:
                with tf32.Emulate():
                    prog.append(ref_image(pose))
            else:
                prog.append(self.images[k])
        return check.render_numbers(prog, ref)

    def rows(self, units: List[int]) -> Dict[int, Dict[str, tuple]]:
        """What each pose in `units` asks of the trunk
        (`model.count_rows`)."""
        from gpubench.reference import model
        o = self.spec["cfg"]["options"]
        _, spec, g = reference_scene(self.spec, self.seed, self.card.device)
        return {i: model.count_rows(o, g, spec, self.path[i]["campos"],
                                    self.path[i]["raydir"], None,
                                    o["near_plane"], o["far_plane"])
                for i in sorted(set(units))}


MIX = Render


def check(mix: Render, window: List[int], seed: int) -> Dict[str, float]:
    """check_images of the window's images, picked from the seed, against
    the reference's renders of their poses."""
    rng = np.random.RandomState(seed % (2 ** 32))
    k = min(int(mix.spec["traffic"]["check_images"]), len(window))
    picks = sorted(rng.choice(len(window), k, replace=False))
    return mix.reference(sample=[(j, window[j]) for j in picks])


def control(spec: Dict, seed: int, card) -> Dict[str, float]:
    """The path's first check_images poses rendered by the reference in
    TF32, without the program."""
    from gpubench import inputs
    mix = Render.__new__(Render)
    mix.spec, mix.seed, mix.card = spec, seed, card
    mix.path = inputs.render_path(spec["cfg"], spec["traffic"], seed,
                                  card.device)
    return mix.reference(control=True, sample=[
        (0, i) for i in range(int(spec["traffic"]["check_images"]))])


def per_entry(mix: Render) -> int:
    return 1


def model(cfg: Dict) -> Dict:
    return cloud_model(cfg, passes=1)
