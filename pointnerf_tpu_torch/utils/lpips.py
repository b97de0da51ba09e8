"""LPIPS v0.1 as a torch module, loaded from a local weights file (port of
`pointnerf_tpu/utils/lpips_jax.py`).

The reference scores LPIPS with the `lpips` package (alex and vgg
backbones, reference: run/evaluate.py:42-46). Neither machine has that
package or its weights, so the network is written here and loads a torch
state dict in the package's layout:

    import lpips, torch
    m = lpips.LPIPS(net="alex", version="0.1")   # or net="vgg"
    torch.save(m.state_dict(), "lpips_alex_full.pth")

The file carries the scaling layer (``scaling_layer.shift/scale``), the
torchvision backbone at its lpips slices (``net.slice{n}.{i}.weight/bias``,
the global feature index i) and the linear heads
(``lin{i}.model.1.weight``); nothing is fetched. As in the JAX package the
backbone is chosen by its conv count (5 convs: alex, else vgg16).

Forward (lpips/lpips.py): x, y in [-1, 1] → (x − shift) / scale → the
backbone's five relu taps → each tap divided by sqrt(Σ_c x² + 1e-10) →
squared difference → 1×1 head → spatial mean → sum over the taps. The eps
sits under the square root, as the JAX package puts it; the lpips package
divides by sqrt(Σ_c x²) + 1e-10 (ROADMAP §3). It runs in float32 on the
caller's device; the package keeps cuDNN's convolutions out of TF32.
"""

from __future__ import annotations

import pickle
from typing import Dict, List

import numpy as np
import torch
import torch.nn as nn

# (out_channels, kernel, stride, pad) per conv; "M" a max pool (alex k3 s2,
# vgg k2 s2); "TAP" ends an lpips slice after the relu before it
# (lpips/pretrained_networks.py).
ALEX_CFG: List = [(64, 11, 4, 2), "TAP", "M", (192, 5, 1, 2), "TAP", "M",
                  (384, 3, 1, 1), "TAP", (256, 3, 1, 1), "TAP",
                  (256, 3, 1, 1), "TAP"]
VGG_CFG: List = [(64, 3, 1, 1), (64, 3, 1, 1), "TAP", "M",
                 (128, 3, 1, 1), (128, 3, 1, 1), "TAP", "M",
                 (256, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1), "TAP", "M",
                 (512, 3, 1, 1), (512, 3, 1, 1), (512, 3, 1, 1), "TAP", "M",
                 (512, 3, 1, 1), (512, 3, 1, 1), (512, 3, 1, 1), "TAP"]


class _Scaling(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.zeros(1, 3, 1, 1))
        self.register_buffer("scale", torch.ones(1, 3, 1, 1))

    def forward(self, x):
        return (x - self.shift) / self.scale


class _Backbone(nn.Module):
    """slice1..slice5, each an nn.Sequential keyed by torchvision's global
    feature index, so the lpips package's keys load as they are."""

    def __init__(self, cfg: List):
        super().__init__()
        pool_k = 3 if cfg is ALEX_CFG else 2
        idx, cin, n = 0, 3, 1
        cur = nn.Sequential()
        for item in cfg:
            if item == "TAP":
                setattr(self, f"slice{n}", cur)
                cur, n = nn.Sequential(), n + 1
            elif item == "M":
                cur.add_module(str(idx), nn.MaxPool2d(pool_k, 2))
                idx += 1
            else:
                cout, k, s, p = item
                cur.add_module(str(idx), nn.Conv2d(cin, cout, k, s, p))
                cur.add_module(str(idx + 1), nn.ReLU())
                idx, cin = idx + 2, cout

    def forward(self, x) -> List[torch.Tensor]:
        taps = []
        for n in range(1, 6):
            x = getattr(self, f"slice{n}")(x)
            taps.append(x)
        return taps


class _Head(nn.Module):
    """lpips' NetLinLayer: model = (Dropout, 1×1 conv to one channel)."""

    def __init__(self, c: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(c, 1, 1,
                                                           bias=False))


class LPIPS(nn.Module):
    """LPIPS v0.1 (net "alex" or "vgg") in the lpips package's state-dict
    layout; `distance` takes two [H, W, 3] images in [0, 1]."""

    def __init__(self, net: str):
        super().__init__()
        if net not in ("alex", "vgg"):
            raise ValueError(f"LPIPS net {net!r}: alex or vgg")
        cfg = ALEX_CFG if net == "alex" else VGG_CFG
        self.net_name = net
        self.scaling_layer = _Scaling()
        self.net = _Backbone(cfg)
        chns = [c[0] for c, nxt in zip(cfg, cfg[1:] + ["TAP"])
                if isinstance(c, tuple) and nxt == "TAP"]
        for i, c in enumerate(chns):
            setattr(self, f"lin{i}", _Head(c))
        self.eval()

    @torch.no_grad()
    def distance(self, img0, img1) -> torch.Tensor:
        """LPIPS between two [H, W, 3] images in [0, 1] (numpy or tensors),
        on the module's device, as a float32 scalar tensor."""
        dev = self.scaling_layer.shift.device

        def prep(im):
            x = torch.as_tensor(np.asarray(im, np.float32), device=dev)
            x = x * 2.0 - 1.0
            return self.scaling_layer(x.permute(2, 0, 1)[None])

        total = torch.zeros((), dtype=torch.float32, device=dev)
        for i, (t0, t1) in enumerate(zip(self.net(prep(img0)),
                                         self.net(prep(img1)))):
            n0 = t0 / torch.sqrt(torch.sum(t0 * t0, 1, keepdim=True) + 1e-10)
            n1 = t1 / torch.sqrt(torch.sum(t1 * t1, 1, keepdim=True) + 1e-10)
            w = getattr(self, f"lin{i}").model[1].weight.reshape(1, -1, 1, 1)
            total = total + torch.mean(torch.sum(torch.square(n0 - n1) * w,
                                                 dim=1))
        return total


def net_of(sd: Dict[str, torch.Tensor]) -> str:
    """The backbone a state dict holds, by its conv count, as the JAX
    package picks it (lpips_jax.py:59-68): 5 convs alex, else vgg."""
    n_convs = sum(1 for k in sd if k.startswith("net.")
                  and k.endswith(".weight"))
    return "alex" if n_convs == 5 else "vgg"


def load_lpips(path: str, device="cuda") -> LPIPS:
    """The LPIPS module of a weights file, on `device` (the card unless the
    caller names another). A file that does not load, or whose keys or
    shapes are not an lpips state dict, raises: a metric asked for is never
    skipped."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if not isinstance(sd, dict):
            raise ValueError(f"a {type(sd).__name__}, not a state dict")
        # the lpips package also registers its heads as lins.{i}: those
        # keys repeat lin{i}'s tensors
        sd = {k: v for k, v in sd.items() if not k.startswith("lins.")}
        model = LPIPS(net_of(sd))
        model.load_state_dict(sd, strict=True)
    except (pickle.UnpicklingError, EOFError, RuntimeError, ValueError) as e:
        raise ValueError(f"LPIPS weights file {path} does not load: {e}"
                         ) from e
    return model.requires_grad_(False).to(device)
