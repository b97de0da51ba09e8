"""Conv nets of the MVS stack as `nn.Module`s (port of
`pointnerf_tpu/models/mvs/nets.py`).

Architectures (reference):
* official MVSNet FeatureNet and CostRegNet (depth_estimators/mvsnet.py:
  7-71, module.py:6-33): BN + ReLU, stride-4 2D features, a 3D U-Net over
  the cost volume with transposed-conv upsampling;
* MVSNeRF's FPN FeatureNet (mvs/models.py:717-765): InPlaceABN, which is
  BN + LeakyReLU(0.01).

Module and parameter names are the original checkpoints' keys, so an
official state dict loads with `load_state_dict` once its DataParallel
`module.` prefix is gone. BatchNorm runs in eval mode from its running
statistics, as the finetune's point init runs these nets. The FPN's
forward also takes `batch_stats`: BatchNorm then normalises with the
batch's mean and population variance and updates no running statistic, as
the JAX package's `batch_norm(training=True)` does; the feed-forward path
runs it so at train and at inference (`pointnerf_tpu/run/train.py:88-105`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn as nn

# official MVSNet FeatureNet (depth_estimators/mvsnet.py:7-27):
# name, cin, cout, k, stride, pad
OFCL_FEAT_SPEC = [
    ("conv0", 3, 8, 3, 1, 1), ("conv1", 8, 8, 3, 1, 1),
    ("conv2", 8, 16, 5, 2, 2), ("conv3", 16, 16, 3, 1, 1),
    ("conv4", 16, 16, 3, 1, 1), ("conv5", 16, 32, 5, 2, 2),
    ("conv6", 32, 32, 3, 1, 1),
]
# CostRegNet's encoder: name, cin, cout, stride; decoder: name, cin, cout
COSTREG_SPEC = [("conv0", 32, 8, 1), ("conv1", 8, 16, 2), ("conv2", 16, 16, 1),
                ("conv3", 16, 32, 2), ("conv4", 32, 32, 1),
                ("conv5", 32, 64, 2), ("conv6", 64, 64, 1)]
COSTREG_UP = [("conv7", 64, 32), ("conv9", 32, 16), ("conv11", 16, 8)]
# MVSNeRF FPN FeatureNet blocks: (cin, cout, k, stride, pad) per layer
FPN_SPEC = {
    "conv0": [(3, 8, 3, 1, 1), (8, 8, 3, 1, 1)],
    "conv1": [(8, 16, 5, 2, 2), (16, 16, 3, 1, 1), (16, 16, 3, 1, 1)],
    "conv2": [(16, 32, 5, 2, 2), (32, 32, 3, 1, 1), (32, 32, 3, 1, 1)],
}


def _init_conv(conv: nn.Module, fan_in: int, generator) -> None:
    """torch's Conv default init (kaiming_uniform, a = sqrt(5)) as the JAX
    package writes it (`nets.init_conv`), from `generator`."""
    wbound = math.sqrt(2.0 / 6.0) * math.sqrt(3.0 / fan_in)
    with torch.no_grad():
        conv.weight.uniform_(-wbound, wbound, generator=generator)
        if conv.bias is not None:
            b = 1.0 / math.sqrt(fan_in)
            conv.bias.uniform_(-b, b, generator=generator)


def batch_norm_stats(x: torch.Tensor, bn: nn.Module) -> torch.Tensor:
    """BatchNorm on the batch's statistics, in JAX's form: mean and
    population variance over every axis but the channels, (x − mean) /
    sqrt(var + eps) · scale + bias. On flat channels (an image's uniform
    background) its autograd keeps the float32 gradient as near the
    float64 one as JAX's; `F.batch_norm`'s fused backward did not."""
    dims = (0,) + tuple(range(2, x.dim()))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mean = x.mean(dims, keepdim=True)
    var = torch.square(x - mean).mean(dims, keepdim=True)
    xn = (x - mean) / torch.sqrt(var + bn.eps)
    return xn * bn.weight.reshape(shape) + bn.bias.reshape(shape)


class ConvBnAct(nn.Module):
    """Conv (no bias) → BatchNorm → ReLU or LeakyReLU(0.01): the original
    ConvBnReLU / ConvBnReLU3D / InPlaceABN blocks (keys `conv`, `bn`)."""

    def __init__(self, cin, cout, k, stride, pad, dims=2, act="relu",
                 generator=None):
        super().__init__()
        conv = nn.Conv2d if dims == 2 else nn.Conv3d
        bn = nn.BatchNorm2d if dims == 2 else nn.BatchNorm3d
        self.conv = conv(cin, cout, k, stride, pad, bias=False)
        self.bn = bn(cout)
        self.act = nn.ReLU() if act == "relu" else nn.LeakyReLU(0.01)
        _init_conv(self.conv, cin * k ** dims, generator)

    def forward(self, x, batch_stats: bool = False):
        y = self.conv(x)
        if batch_stats:
            return self.act(batch_norm_stats(y, self.bn))
        return self.act(self.bn(y))


class OfclFeatureNet(nn.Module):
    """[N,3,H,W] → [N,32,H/4,W/4] (official MVSNet FeatureNet)."""

    def __init__(self, generator=None):
        super().__init__()
        for name, cin, cout, k, stride, pad in OFCL_FEAT_SPEC:
            self.add_module(name, ConvBnAct(cin, cout, k, stride, pad,
                                            generator=generator))
        self.feature = nn.Conv2d(32, 32, 3, 1, 1)
        _init_conv(self.feature, 32 * 9, generator)

    def forward(self, x):
        for name, *_ in OFCL_FEAT_SPEC:
            x = getattr(self, name)(x)
        return self.feature(x)


class _Up(nn.Sequential):
    """ConvTranspose3d(k 3, stride 2, pad 1, output_padding 1, no bias) →
    BatchNorm3d, as the original `Sequential` (keys `0`, `1`); ReLU after.
    `batch_stats` normalises as `ConvBnAct` does."""

    def __init__(self, cin, cout, generator=None):
        super().__init__(nn.ConvTranspose3d(cin, cout, 3, 2, 1, 1, bias=False),
                         nn.BatchNorm3d(cout))
        # the weight is [cin, cout, 3, 3, 3] (torch's transposed layout),
        # drawn with a [cout, cin] conv's bound, as JAX draws it
        _init_conv(self[0], cin * 27, generator)

    def forward(self, x, batch_stats: bool = False):
        y = self[0](x)
        return torch.relu(batch_norm_stats(y, self[1]) if batch_stats
                          else self[1](y))


class CostRegNet(nn.Module):
    """[N,32,D,H,W] → cost logits [N,1,D,H,W]: the official 3D U-Net. D, H
    and W must be multiples of 8."""

    def __init__(self, generator=None):
        super().__init__()
        for name, cin, cout, stride in COSTREG_SPEC:
            self.add_module(name, ConvBnAct(cin, cout, 3, stride, 1, dims=3,
                                            generator=generator))
        for name, cin, cout in COSTREG_UP:
            self.add_module(name, _Up(cin, cout, generator))
        self.prob = nn.Conv3d(8, 1, 3, 1, 1)
        _init_conv(self.prob, 8 * 27, generator)

    def forward(self, x):
        c0 = self.conv0(x)
        c2 = self.conv2(self.conv1(c0))
        c4 = self.conv4(self.conv3(c2))
        x = self.conv6(self.conv5(c4))
        x = c4 + self.conv7(x)
        del c4
        x = c2 + self.conv9(x)
        del c2
        x = c0 + self.conv11(x)
        del c0
        return self.prob(x)


class FPNFeatureNet(nn.Module):
    """MVSNeRF's FPN FeatureNet, intermediate path: [V,3,H,W] → [imgs,
    x1 [V,8,H,W], x2 [V,16,H/2,W/2], x3 [V,32,H/4,W/4]]
    (mvs/models.py:748-757)."""

    def __init__(self, generator=None):
        super().__init__()
        for bname, layers in FPN_SPEC.items():
            self.add_module(bname, nn.Sequential(*[
                ConvBnAct(cin, cout, k, stride, pad, act="leaky",
                          generator=generator)
                for cin, cout, k, stride, pad in layers]))
        self.toplayer = nn.Conv2d(32, 32, 1, 1, 0)
        _init_conv(self.toplayer, 32, generator)

    def forward(self, imgs, batch_stats: bool = False) -> List[torch.Tensor]:
        outs = [imgs]
        x = imgs
        for bname in FPN_SPEC:
            for layer in getattr(self, bname):
                x = layer(x, batch_stats)
            outs.append(x)
        outs[-1] = self.toplayer(outs[-1])
        return outs


class MVSNet(nn.Module):
    """The official MVSNet's two nets (`feature`, `cost_regularization`);
    the forward is `mvsnet.mvsnet_forward`."""

    def __init__(self, generator=None):
        super().__init__()
        self.feature = OfclFeatureNet(generator)
        self.cost_regularization = CostRegNet(generator)


# -------------------------------------------------------------- torch import
def load_state(module: nn.Module, sd: Dict[str, torch.Tensor]) -> nn.Module:
    """load_state_dict, strict except for BatchNorm's num_batches_tracked
    (unused in eval mode, absent from the JAX trees)."""
    own = module.state_dict()
    full = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    for k, v in own.items():
        if k.endswith("num_batches_tracked"):
            full[k] = v
    module.load_state_dict(full, strict=True)
    return module


def _strip(sd: Dict, prefix: str = "") -> Dict:
    """Drop DataParallel's `module.` and keep the keys under `prefix`,
    without it."""
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.startswith(prefix):
            out[k[len(prefix):]] = torch.as_tensor(v, dtype=torch.float32) \
                if not k.endswith("num_batches_tracked") else v
    return out


def import_official_mvsnet(sd: Dict, net: Optional[MVSNet] = None) -> MVSNet:
    """Official-MVSNet checkpoint → `net` (a new MVSNet on the CPU if None).

    Takes the artifact the reference depends on (`model_000014.ckpt`,
    mvs_points_model.py:66-73): `{'model': state_dict}` with DataParallel
    `module.` prefixes, or a bare state dict. Only the `feature.` and
    `cost_regularization.` keys are read."""
    if "model" in sd and hasattr(sd["model"], "items"):
        sd = sd["model"]
    flat = _strip(sd)
    keep = {k: v for k, v in flat.items()
            if k.startswith(("feature.", "cost_regularization."))}
    if not any(k.startswith("feature.") for k in keep) or \
            not any(k.startswith("cost_regularization.") for k in keep):
        raise ValueError(f"not an MVSNet state dict: {sorted(flat)[:8]}")
    net = MVSNet() if net is None else net
    dev = next(net.parameters()).device
    return load_state(net, {k: v.to(dev) for k, v in keep.items()})


def import_mvsnerf_featurenet(sd: Dict, prefix: str = "",
                              net: Optional[FPNFeatureNet] = None
                              ) -> FPNFeatureNet:
    """MVSNeRF FPN FeatureNet state dict → `net` (a new one on the CPU if
    None). The reference's `{iter}_net_mvs.pth` carries it under
    `FeatureNet.`; InPlaceABN's weight/bias/running_mean/running_var are
    BatchNorm's keys."""
    flat = _strip(sd, prefix)
    if not flat:
        raise ValueError(f"no keys under {prefix!r}: {sorted(sd)[:8]}")
    net = FPNFeatureNet() if net is None else net
    dev = next(net.parameters()).device
    return load_state(net, {k: v.to(dev) for k, v in flat.items()})
