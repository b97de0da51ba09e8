"""Training losses (port of `pointnerf_tpu/models/losses.py`; reference:
models/base_rendering_model.py:533-662).

Every loss is a masked mean over the static ray batch, numerically the
reference's masked_select mean for nonzero mask counts. Each is a ratio of
sums, so a batch split over ray shards (`parallel.dp`) computes it from the
shards' sums: `compute_losses` applies `red` to every numerator and
denominator, and `over_shards` evaluates it with each of them summed over
the shards (forward; the backward passes the cotangent to the shard's own
sum), so the losses are the whole batch's and the gradients, summed over
the shards, are the whole batch's too.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def _keep(x):
    return x


class _Total(torch.autograd.Function):
    """The whole batch's sum in place of this shard's partial sum x:
    forward the total, backward the identity to x."""

    @staticmethod
    def forward(ctx, x, total):
        return total.clone()

    @staticmethod
    def backward(ctx, ct):
        return ct, None


def over_shards(fn, reduce):
    """fn(red) with every red(x) (a scalar partial sum) replaced by its sum
    over the ray shards, in one call of `reduce` (a sum over the shards of
    a vector): a first pass without gradient records the partial sums,
    `reduce` sums them all at once, and a second pass gives each red(x)
    its total with the identity backward to x."""
    parts = []
    with torch.no_grad():
        fn(lambda x: parts.append(x.reshape(()).to(torch.float32)) or x)
    totals = iter(reduce(torch.stack(parts)).unbind(0))
    return fn(lambda x: _Total.apply(x, next(totals).to(x.dtype)))


def _masked_mse(pred, gt, mask, red=_keep):
    """Mean over masked elements of (pred-gt)²; 0 if the mask is empty."""
    m = mask.to(pred.dtype)
    num = red(torch.sum(torch.square(pred - gt) * m[..., None]))
    den = red(torch.sum(m)) * pred.shape[-1]
    return torch.where(den > 0, num / torch.clamp(den, min=1.0),
                       torch.zeros((), dtype=pred.dtype, device=pred.device))


def _count(x):
    """x.numel() as a 0-d tensor of x's type on its device, filled there
    (a tensor made from a host number is a blocking copy to the card)."""
    return torch.full((), float(x.numel()), dtype=x.dtype, device=x.device)


def _mean(x, red=_keep):
    """torch.mean of x over the whole batch."""
    if red is _keep:
        return torch.mean(x)
    return red(torch.sum(x)) / red(_count(x))


def _pair(items, weights):
    """A single weight applies to every item (base_rendering_model.py:
    242-244); any other length mismatch is an error."""
    if len(items) and len(weights) not in (1, len(items)):
        raise ValueError(f"loss items {tuple(items)} against weights "
                         f"{tuple(weights)}")
    if len(weights) == 1 and len(items) > 1:
        weights = tuple(weights) * len(items)
    return zip(items, weights)


def compute_losses(opt, output: Dict, gt_image: torch.Tensor,
                   gt_mask: torch.Tensor = None, gt_depth: torch.Tensor = None,
                   red=_keep) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total training loss and the per-item dict. gt_image [B,R,3];
    gt_mask/gt_depth [B,R] (needed iff depth or bg loss items are set).
    red: applied to every numerator and denominator (`over_shards`); the
    identity for a whole batch."""
    total = 0.0
    items = {}
    ray_mask = output["ray_mask"]

    for name, w in _pair(opt.color_loss_items, opt.color_loss_weights):
        if name.startswith("ray_masked"):
            loss = _masked_mse(output[name[len("ray_masked") + 1:]], gt_image,
                               ray_mask, red)
        elif name.startswith("ray_miss"):
            # the reference scales the miss MSE by the miss count
            # (base_rendering_model.py:560): the sum of per-ray MSEs
            miss = (~ray_mask).to(gt_image.dtype)
            loss = red(torch.sum(torch.square(
                output[name[len("ray_miss") + 1:]] - gt_image)
                * miss[..., None])) / gt_image.shape[-1]
        else:
            loss = _mean(torch.square(output[name] - gt_image), red)
        items["loss_" + name] = loss
        total = total + loss * w + 1e-6

    # depth (reference :610-617): MSE of the masked depths over ALL rays
    for name, w in _pair(opt.depth_loss_items, opt.depth_loss_weights):
        m = gt_mask.to(gt_depth.dtype)
        pred = output[name].reshape(m.shape)
        loss = _mean(torch.square(pred * m - gt_depth * m), red)
        items["loss_" + name] = loss
        total = total + loss * w

    # background (reference :619-627): transmission toward 1 off the mask
    for name, w in _pair(opt.bg_loss_items, opt.bg_loss_weights):
        inv = 1.0 - gt_mask.to(gt_image.dtype)
        pred = output[name].reshape(inv.shape)
        loss = _mean(torch.square(pred * inv - inv), red)
        items["loss_" + name] = loss
        total = total + loss * w

    for name, w in _pair(opt.zero_one_loss_items, opt.zero_one_loss_weights):
        if name == "conf_coefficient" and "conf_compact" in output:
            # compact form: the mean over the full B·R·SR·K element space,
            # where every element the compaction left empty is 0, whose
            # clipped log term is the constant log(eps) + log(1 - eps)
            eps = opt.zero_epsilon
            c = output["conf_compact"]
            as_c = lambda x: torch.full((), x, dtype=c.dtype, device=c.device)
            const = torch.log(as_c(eps)) + torch.log(as_c(1.0 - eps))
            v = torch.clamp(c, eps, 1.0 - eps)
            term = torch.where(output["compact_valid"],
                               torch.log(v) + torch.log(1.0 - v), const)
            n_total = red(torch.sum(output["zero_one_total"]).to(term.dtype))
            n_kept = red(_count(term))
            loss = (red(torch.sum(term)) + (n_total - n_kept) * const) \
                / n_total
        elif output.get(name) is None:
            continue
        else:
            val = torch.clamp(output[name], opt.zero_epsilon,
                              1.0 - opt.zero_epsilon)
            loss = _mean(torch.log(val) + torch.log(1.0 - val), red)
        items["loss_" + name] = loss
        total = total + loss * w

    # l2 regularization (reference :644-651): MSE of the output against 0
    for name, w in _pair(opt.l2_size_loss_items, opt.l2_size_loss_weights):
        loss = _mean(torch.square(output[name]), red)
        items["loss_" + name] = loss
        total = total + loss * w

    if opt.sparse_loss_weight > 0:
        if "weight_compact" in output:
            # exact on the compacted rows: empty rows have weight 0
            w_out, conf = output["weight_compact"], output["conf_compact"]
        else:
            w_out, conf = output["weight"], output["conf_coefficient"]
        loss = red(torch.sum(w_out * torch.abs(1.0 - torch.exp(-2.0 * conf)))) \
            / (red(torch.sum(w_out)) + 1e-6)
        items["loss_sparse"] = loss
        total = total + loss * opt.sparse_loss_weight

    items["loss_total"] = total
    return total, items


def mse2psnr(mse):
    return -10.0 * torch.log10(torch.clamp(torch.as_tensor(mse), min=1e-10))
