"""The train mix: dispatches of S graphed train steps of the given-cloud
model through `trainer.train_steps_scan`, from a seeded pool of views,
cycled (gpubench/mix.py says what the loop reads here)."""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from gpubench.mix import cloud_model, reference_scene, span

FAULTS = ("frozen", "half", "loss", "stale", "points")
UNIT = "dispatches"


def _sub(d: Dict, a: int, b: int) -> Dict:
    """Steps a..b-1 of a dispatch."""
    return dict(d, batches={k: (v[a:b] if hasattr(v, "shape") else v)
                            for k, v in d["batches"].items()}, steps=(a, b))


class Train:
    """The train mix: dispatches of S graphed steps through
    `train_steps_scan`, from a seeded pool of views, cycled.

    Set-up drives the check's steps through the window's own call and
    feed (`check_steps`): the first step alone, so that its gradient can
    be read from Adam's state, then two whole dispatches, the first of
    which captures the graph (its first step eager, the rest replays) and
    the second replays it throughout, as every dispatch of the window
    does. The reference follows all of them."""

    def __init__(self, spec: Dict, seed: int, card,
                 fault: Optional[str]):
        import torch
        from gpubench import inputs, system
        self.spec, self.seed, self.card, self.fault = spec, seed, card, fault
        cfg, traffic = spec["cfg"], spec["traffic"]
        dev = card.device
        if card.cuda:
            system.build_kernels()
        self.opt = system.options(cfg)
        self.pool = inputs.train_pool(cfg, traffic, seed, dev)
        self.S = int(traffic["steps_per_dispatch"])
        self.rays = cfg["options"]["random_sample_size"] ** 2
        self.u = torch.empty((self.S, 1, self.rays,
                              cfg["options"]["z_depth_dim"]), device=dev)
        cloud = inputs.cloud(cfg, seed, dev)
        state = system.point_state(cloud)
        del cloud
        self.grid_spec, self.grid = system.grid(self.opt, state)
        agg = system.aggregator(self.opt, inputs.weights(cfg, seed, dev), dev)
        self.ts = system.train_state(self.opt, agg, state)
        calls = self.check_calls()
        items = [self.call(calls[0])]
        self.g1 = {k: v.detach().cpu().clone()
                   for k, v in system.first_gradients(self.ts).items()}
        items += [self.call(d) for d in calls[1:]]
        self.after = {k: v.detach().cpu().clone()
                      for k, v in system.leaves(self.ts).items()}
        self.losses = [float(x) for it in items for x in it["loss_total"]]
        self.overflow: List[float] = []
        self.seconds: List[float] = []
        self.next = len(calls) - 1

    def check_calls(self) -> List[Dict]:
        """The set-up's calls that the reference follows: step 0 of the
        pool's last dispatch, then its first two dispatches whole."""
        return [_sub(self.pool[-1], 0, 1), self.pool[0], self.pool[1]]

    def call(self, d: Dict) -> Dict:
        import torch
        from gpubench import inputs, system
        from gpubench.reference.train import POINT_LEAVES
        a, b = d.get("steps", (0, self.S))
        u = inputs.draws(d, self.u)[a:b]
        if self.fault == "half":
            half = u.shape[2] // 2
            d = {"batches": {k: (v[:, :, :half] if k in ("raydir",
                                                          "gt_image") else v)
                             for k, v in d["batches"].items()}}
            u = u[:, :, :half]
        if self.fault == "stale":
            d = {"batches": {k: (v[:1].expand_as(v).contiguous()
                                 if torch.is_tensor(v) else v)
                             for k, v in d["batches"].items()}}
            u = u[:1].expand_as(u).contiguous()
        if self.fault in ("frozen", "points"):
            before = {k: v.detach().clone()
                      for k, v in system.leaves(self.ts).items()
                      if self.fault == "frozen" or k in POINT_LEAVES}
        with span("dispatch"):
            items = system.dispatch(self.ts, self.grid, self.grid_spec,
                                    self.opt, dict(d, u=u))
        if self.fault in ("frozen", "points"):
            with torch.no_grad():
                for k, v in system.leaves(self.ts).items():
                    if k in before:
                        v.copy_(before[k])
            for optim in ((self.ts.opt_net, self.ts.opt_pts)
                          if self.fault == "frozen" else ()):
                for st in optim.state.values():
                    st["exp_avg"].zero_()
                    st["exp_avg_sq"].zero_()
        if self.fault == "loss":
            items["loss_total"] = items["loss_total"] * 1.01
        return items

    def unit(self) -> tuple:
        """One dispatch of the window: (pool index, steps, failed steps)."""
        i = self.next % len(self.pool)
        self.next += 1
        t0 = time.perf_counter()
        items = self.call(self.pool[i])
        self.seconds.append(time.perf_counter() - t0)
        self.overflow.extend(float(x) for x in items["sr_overflow"])
        return i, self.S, int(np.sum(~np.isfinite(items["loss_total"])))

    def free(self):
        import torch
        del self.ts, self.grid
        torch.cuda.empty_cache() if self.card.cuda else None

    def notes(self) -> str:
        o = self.overflow
        return (f"sr_overflow in the window: largest {max(o, default=0)!r}, "
                f"{sum(x > 0 for x in o)} of {len(o)} steps above 0")

    def check_batches(self):
        """The reference's batches and draws of the check's steps."""
        import torch
        from gpubench import inputs
        batches, u = [], []
        buf = torch.empty_like(self.u)
        for d in self.check_calls():
            inputs.draws(d, buf)
            a, b = d.get("steps", (0, self.S))
            for s in range(a, b):
                batches.append(inputs.step_of(d, s))
                u.append(buf[s, 0].clone())
        return batches, u

    def reference(self, control: bool = False) -> Dict[str, float]:
        """The reference's steps on the same inputs, against the
        program's (or, for the control, against the reference's own in
        TF32)."""
        from gpubench import check, inputs
        from gpubench.reference import tf32, train as rtrain
        from gpubench.reference.train import POINT_LEAVES
        cfg, dev = self.spec["cfg"], self.card.device
        cloud, spec, g = reference_scene(self.spec, self.seed, dev)
        W = inputs.weights(cfg, self.seed, dev)
        batches, draws = self.check_batches()
        start = {**W, **{k: cloud[k] for k in POINT_LEAVES}}

        def follow():
            items, g1, after = rtrain.run_steps(W, cloud, cfg["options"], g,
                                                spec, batches, draws)
            return ([i["loss_total"] for i in items],
                    {k: v.cpu() for k, v in g1.items()},
                    {k: (after[k] - start[k]).cpu() for k in after})
        ref = follow()
        if control:
            with tf32.Emulate():
                prog = follow()
        else:
            n = cloud["xyz"].shape[0]
            cut = lambda k, v: v[:n] if k in POINT_LEAVES else v
            prog = (self.losses,
                    {k: cut(k, v) for k, v in self.g1.items()},
                    {k: cut(k, self.after[k]) - start[k].cpu()
                     for k in self.after})
        return check.train_numbers(prog[0], ref[0], prog[1], ref[1],
                                   prog[2], ref[2])

    def rows(self, units: List[int]) -> Dict[int, Dict[str, tuple]]:
        """What each pool dispatch in `units` asks of the trunk, by the
        reference's count (`model.count_rows`): needed and shaded
        (neighbor rows, shading rows)."""
        import torch
        from gpubench import inputs
        from gpubench.reference import model
        o = self.spec["cfg"]["options"]
        _, spec, g = reference_scene(self.spec, self.seed, self.card.device)
        buf = torch.empty_like(self.u)
        out = {}
        for i in sorted(set(units)):
            d = self.pool[i]
            inputs.draws(d, buf)
            tot = {"needed": (0, 0), "shaded": (0, 0)}
            for s in range(self.S):
                b = inputs.step_of(d, s)
                c = model.count_rows(o, g, spec, b["campos"], b["raydir"],
                                     buf[s, 0], b["near"], b["far"])
                tot = {k: (tot[k][0] + c[k][0], tot[k][1] + c[k][1])
                       for k in tot}
            out[i] = tot
        return out


MIX = Train


def check(mix: Train, window: List[int], seed: int) -> Dict[str, float]:
    """The set-up's steps against the reference's (the window's dispatches
    replay the same graph, so none of them is sampled)."""
    return mix.reference()


def control(spec: Dict, seed: int, card) -> Dict[str, float]:
    """The check's steps made again without the program, the reference in
    TF32 in its place."""
    import torch
    from gpubench import inputs
    mix = Train.__new__(Train)
    mix.spec, mix.seed, mix.card = spec, seed, card
    cfg, traffic = spec["cfg"], spec["traffic"]
    mix.pool = inputs.train_pool(cfg, dict(traffic, pool_dispatches=3),
                                 seed, card.device)
    mix.S = int(traffic["steps_per_dispatch"])
    mix.u = torch.empty((mix.S, 1, cfg["options"]["random_sample_size"]
                         ** 2, cfg["options"]["z_depth_dim"]),
                        device=card.device)
    return mix.reference(control=True)


def per_entry(mix: Train) -> int:
    return mix.S


def model(cfg: Dict) -> Dict:
    return cloud_model(cfg, passes=3)
