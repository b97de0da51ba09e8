"""The control's precision: every matrix product on TF32 operands.

TF32 keeps 10 bits of a float32 mantissa. `Emulate` rounds both operands
of each product that the reference computes (`F.linear`, `matmul`, `mm`,
`bmm`, `addmm`) to the nearest TF32 value and multiplies them in
float32, as the tensor cores do with TF32 switched on, on the CPU and the
card alike. The backward pass multiplies the rounded operands it saved
with the incoming gradient in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

_PRODUCTS = {F.linear: (0, 1), torch.matmul: (0, 1), torch.mm: (0, 1),
             torch.bmm: (0, 1), torch.addmm: (1, 2)}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to 10 mantissa bits, to nearest, ties away; the
    gradient passes through unchanged."""
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - x).detach() if x.requires_grad else r


class Emulate(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        which = _PRODUCTS.get(func)
        if which is not None:
            args = list(args)
            for i in which:
                if i < len(args) and torch.is_tensor(args[i]) \
                        and args[i].dtype == torch.float32:
                    args[i] = round_tf32(args[i])
        return func(*args, **kwargs)
