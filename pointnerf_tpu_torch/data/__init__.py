"""Dataset registry (copy of `pointnerf_tpu/data/__init__.py`, numpy only).

Reference: data/__init__.py:10-50. Items are numpy [1, ...] host arrays per
camera; the port moves them to the device in the driver. Ported: the
NeRF-Synthetic and Tanks&Temples finetune datasets and the DTU multi-view
dataset of generalizable training; other names raise (ROADMAP §1 item 7).
"""

from __future__ import annotations

from typing import Dict

_REGISTRY: Dict[str, type] = {}
PORTED = ("nerf_synth360_ft", "tt_ft", "dtu")


def register_dataset(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls
    return deco


def find_dataset_class_by_name(name: str) -> type:
    if name not in PORTED:
        raise NotImplementedError(
            f"dataset {name} is not ported (ROADMAP §1 item 7); the port "
            f"has {list(PORTED)}")
    import importlib
    importlib.import_module(f".{name}", __package__)  # registers itself
    return _REGISTRY[name]


def create_dataset(opt, split: str = None):
    ds = find_dataset_class_by_name(opt.dataset_name)()
    ds.initialize(opt, split=split or opt.split)
    return ds
