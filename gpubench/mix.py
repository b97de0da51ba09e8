"""What a traffic mix is to the loop of `run.run_cell`, and what the mixes
of the given-cloud model (train, render) share.

A cell's traffic file names its kind; the loop loads
gpubench/mixes/<kind>.py by path and reads from it:

* `MIX`: the mix's class, built as `MIX(spec, seed, card, fault)` (set-up,
  which ends with the program warm), with `unit()` (one entry of the
  window: input index, units it did, units that failed), `rays` (rays a
  unit does), `free()`, `notes()` (a line for standard error), `seconds`
  (each entry's time), `rows(indices)` (what those inputs ask of the
  trunk, by the reference's count: "needed" and "shaded" (neighbor rows,
  shading rows)) and, where it has one, `ladder` (rows up the budget
  ladder, by entry);
* `FAULTS`: the names of the faults the mix can plant in its timed path;
* `UNIT`: what one entry of the window is, for standard error;
* `check(mix, window, seed)`: the numbers the cell's limits judge, the
  reference against what the window produced (`window`: its entries'
  input indices, in order);
* `control(spec, seed, card)`: the same numbers with the reference, in the
  precision below the configuration's, in the program's place;
* `per_entry(mix)`: units (steps, images) in one entry of the window;
* `model(cfg)`: the context's model arithmetic, read by gpubench/readers.py:
  `trunk_macs`, `head_macs`, `passes`, `point_features`, `trunk_width`.

A mix imports its reference from gpubench/reference/ and calls the program
only through gpubench/system*.py.
"""

from __future__ import annotations

from typing import Dict


def span(name: str):
    """A profiler range of the harness, `gpubench.<name>`."""
    import torch
    return torch.profiler.record_function("gpubench." + name)


def ones(cloud):
    import torch
    return torch.ones(cloud["xyz"].shape[0], dtype=torch.bool,
                      device=cloud["xyz"].device)


def reference_scene(spec: Dict, seed: int, device):
    """The cloud made again from the seed, and the reference's grid of it:
    (cloud, grid spec, grid)."""
    from gpubench import inputs
    from gpubench.reference import grid as rgrid
    cloud = inputs.cloud(spec["cfg"], seed, device)
    gspec = rgrid.make_spec(spec["cfg"]["options"], cloud["xyz"])
    return cloud, gspec, rgrid.build(cloud["xyz"], ones(cloud), gspec)


def cloud_model(cfg: Dict, passes: int) -> Dict:
    """The given-cloud model's arithmetic (`mix.model`): multiply-adds a
    (shading row, neighbor) row and a shading row take forward, the point
    feature and trunk widths, and the forwards a unit's rows run
    (`passes`: a train step's forward and backward count as three)."""
    from gpubench.reference import model
    o = cfg["options"]
    return {"trunk_macs": model.trunk_macs(o), "head_macs": model.head_macs(o),
            "passes": passes, "point_features": o["point_features_dim"],
            "trunk_width": o["shading_feature_num"]}
