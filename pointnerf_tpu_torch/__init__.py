"""pointnerf_tpu_torch — the PyTorch + CUDA port of pointnerf_tpu.

The serving path (full-image render of a neural point cloud) runs on an
NVIDIA H100 with hand-written Hopper kernels in place of the JAX package's
Pallas kernels; on CPU tensors every kernel wrapper runs its plain PyTorch
version. The JAX package stays the reference the port is tested against.
"""

import torch

# The port's float32 numerics are held against the JAX package: keep
# matrix products and convolutions out of TF32 on the GPU (cuDNN would
# otherwise use it for float32 convolutions by default).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
