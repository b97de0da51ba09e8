"""Dataset registry (copy of `pointnerf_tpu/data/__init__.py`, numpy only).

Reference: data/__init__.py:10-50. Items are numpy [1, ...] host arrays per
camera; the port moves them to the device in the driver. Ported: every
dataset the JAX package registers — the NeRF-Synthetic (360 and legacy),
LLFF, Tanks&Temples, DTU and ScanNet finetune datasets and the DTU
multi-view dataset of generalizable training. Other names raise.
"""

from __future__ import annotations

from typing import Dict

_REGISTRY: Dict[str, type] = {}
PORTED = ("nerf_synth360_ft", "nerf_synth_ft", "llff_ft", "tt_ft", "dtu",
          "dtu_ft", "scannet_ft")


def register_dataset(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls
    return deco


def find_dataset_class_by_name(name: str) -> type:
    if name not in PORTED:
        raise NotImplementedError(
            f"dataset {name} is not ported; the port has {list(PORTED)}")
    import importlib
    importlib.import_module(f".{name}", __package__)  # registers itself
    return _REGISTRY[name]


def create_dataset(opt, split: str = None):
    ds = find_dataset_class_by_name(opt.dataset_name)()
    ds.initialize(opt, split=split or opt.split)
    return ds
