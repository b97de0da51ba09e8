"""Alias of train_ft (port of `pointnerf_tpu/run/train_ft_nonstop.py`).

The reference ships run/train_ft.py, which saves and exits after every
point grow for an outer shell loop to restart, and run/train_ft_nonstop.py,
which rebuilds the model in-process instead (reference diff at
train_ft_nonstop.py:888-910). Here a grow is a masked buffer update in
process, so the two entry points are one program, kept so that reference
scripts translate one to one.

Usage: python -m pointnerf_tpu_torch.run.train_ft_nonstop [--device cpu]
           --preset nerf_synth:lego --data_root <dir> [--flag value ...]
"""

from .common import run_cli
from .train_ft import main

if __name__ == "__main__":
    run_cli(main)
