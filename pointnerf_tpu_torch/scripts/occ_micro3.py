"""Micro-benchmark of the segment-cached occupancy test against the dense
one, on the card (counterpart of `scripts/occ_micro3.py`).

On bench.py's workload (the lego preset, its 100k-point cloud and grid, its
3,600-ray batch with jittered depths, D = 400 samples a ray), it times:

  dense      the production occupancy test, `mask_raypos_segmented` (K3,
             `csrc/occupancy.cu`), and the plain dense `mask_raypos`
  stages     voxel coordinates → per-sample row id and lane → the rank of
             each sample's row among its ray's distinct rows (a cumsum)
  kernel     stages + K7 (`ops.query.row_select`, `csrc/row_select.cu`)
             over one row set broadcast to every ray (ray stride 0), per
             variant: int8 or bf16 rows, Rt = 8/16/32/120 rays per CTA
  segmented  the whole pipeline: stages, each ray's ≤U distinct rows
             gathered, K7, overflow (rank ≥ U) conservative-valid

and checks the segmented mask against the dense one, which it must equal
on every ray with at most U distinct rows; rays past U are counted.

Run:  python -m pointnerf_tpu_torch.scripts.occ_micro3 [--iters 8] [--U 96]
"""

from __future__ import annotations

import argparse

import torch

VARIANTS = [("bf16", 8), ("bf16", 16), ("bf16", 32), ("int8", 16),
            ("int8", 8), ("int8", 32), ("bf16", 120), ("int8", 120)]
DTYPES = {"int8": torch.int8, "bf16": torch.bfloat16}


def stages(raypos: torch.Tensor, spec, LW: int):
    """raypos [B,R,D,3] → (inb [B,R,D], rid [N,D] row ids, lane [N,D],
    is_start [N,D], rank [N,D]): rank counts the distinct rows a ray has
    entered before each sample (rows are z-coherent along a ray)."""
    from ..ops.grid import linearize, voxel_coords
    coords, inb = voxel_coords(raypos, spec)
    lin = torch.where(inb, linearize(coords, spec), 0)
    D = lin.shape[-1]
    rid = (lin // LW).reshape(-1, D)
    lane = (lin % LW).reshape(-1, D)
    is_start = torch.cat([torch.ones_like(rid[:, :1], dtype=torch.bool),
                          rid[:, 1:] != rid[:, :-1]], dim=1)
    rank = torch.cumsum(is_start.to(torch.int32), dim=1) - 1
    return inb, rid, lane, is_start, rank


def ray_rows(rid, is_start, rank, U: int) -> torch.Tensor:
    """Each ray's first U distinct row ids [N, U] (0 past its count)."""
    N = rid.shape[0]
    slot = torch.where(is_start & (rank < U), rank, U).long()
    c = torch.zeros((N, U + 1), dtype=rid.dtype, device=rid.device)
    return c.scatter_(1, slot, rid)[:, :U]


def segmented_mask(raypos, grid, spec, U: int = 96, dtype=torch.int8,
                   rays_per_cta: int = 16):
    """The segment-cached occupancy test: (valid [B,R,D] bool, overflow
    [N] bool, the rays past U distinct rows, whose samples past the U-th
    row are conservative-valid)."""
    from ..ops.query import row_select
    rows = grid["coor_occ_rows"]
    LW = rows.shape[-1]
    inb, rid, lane, is_start, rank = stages(raypos, spec, LW)
    c = ray_rows(rid, is_start, rank, U)
    rows_g = rows.to(dtype)[c.reshape(-1).long()].reshape(-1, U, LW)
    occ = row_select(rows_g, torch.clamp(rank, max=U - 1), lane,
                     rays_per_cta)
    occ = torch.where(rank >= U, 1.0, occ)
    valid = (occ.reshape(inb.shape) > 0.5) & inb
    return valid, (rank >= U).any(dim=1)


def time_ms(fn, iters: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bench_workload(dev):
    """(opt, grid, spec, raypos [1,3600,400,3], t [1,3600,400]) of
    bench.py's batch with one draw of the train jitter."""
    from ..models import neural_points as npc
    from ..ops import raygen
    from ..ops.query import ray_points
    from ..run.common import make_spec_and_grid
    from ..run.workload import lego_options, make_cloud, make_train_batch
    opt = lego_options()
    xyz, emb, color, dirs, conf = make_cloud(opt)
    state = npc.create_point_cloud(xyz, emb, color, dirs, conf, device=dev)
    spec, grid = make_spec_and_grid(opt, state)
    batch = make_train_batch(opt, dev)
    B, R = batch["raydir"].shape[:2]
    u = torch.rand((B, R, opt.z_depth_dim),
                   generator=torch.Generator(device=dev).manual_seed(7),
                   device=dev)
    _, _, _, t = raygen.near_far_linear_ray_generation(
        batch["campos"], batch["raydir"], opt.z_depth_dim,
        near=batch["near"], far=batch["far"], jitter=0.3, u=u)
    return opt, grid, spec, batch, ray_points(batch["campos"],
                                              batch["raydir"], t), t


def main(argv=None):
    from ..ops.query import mask_raypos, mask_raypos_segmented, row_select
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--U", type=int, default=96)
    args = ap.parse_args(argv)
    U, S = args.U, args.iters
    dev = torch.device("cuda")
    opt, grid, spec, batch, raypos, t = bench_workload(dev)
    rows = grid["coor_occ_rows"]
    LW = rows.shape[-1]
    D = raypos.shape[2]
    print(f"device={torch.cuda.get_device_name(dev)} U={U} D={D} LW={LW} "
          f"rays={raypos.shape[1]} iters={S}")

    def line(label, ms):
        print(f"{label:>34}: {ms:7.3f} ms/iter")
        return ms

    cp, rd = batch["campos"], batch["raydir"]
    t_dense = line("dense mask_raypos_segmented (K3)", time_ms(
        lambda: mask_raypos_segmented(cp, rd, t, grid, spec), S))
    line("dense mask_raypos (plain)",
         time_ms(lambda: mask_raypos(raypos, grid, spec), S))
    line("stages", time_ms(lambda: stages(raypos, spec, LW), S))

    N = raypos.shape[0] * raypos.shape[1]
    results = {}
    for name, Rt in VARIANTS:
        rows_b = rows[:U].to(DTYPES[name])[None].expand(N, U, LW)

        def kernel_only(rows_b=rows_b, Rt=Rt):
            st = stages(raypos, spec, LW)
            return row_select(rows_b, torch.clamp(st[4], max=U - 1), st[2],
                              Rt)
        results[(name, Rt)] = line(f"stages+kernel[{name} Rt={Rt}]",
                                   time_ms(kernel_only, S))
    best = sorted(results, key=results.get)
    for name, Rt in best[:2]:
        ms = line(f"segmented full[{name} Rt={Rt}]", time_ms(
            lambda: segmented_mask(raypos, grid, spec, U, DTYPES[name], Rt),
            S))
        print(f"    -> vs dense: {t_dense / ms:.2f}x")
    name, Rt = best[0]
    dense = mask_raypos(raypos, grid, spec)
    seg, over = segmented_mask(raypos, grid, spec, U, DTYPES[name], Rt)
    keep = ~over.reshape(dense.shape[:2])
    eq = bool(torch.equal(dense[keep], seg[keep]))
    print(f"parity dense==segmented[{name} Rt={Rt}]: {eq} "
          f"({int(over.sum())} of {over.numel()} rays past U={U} rows, "
          f"conservative there)")
    if not eq:
        raise AssertionError("the segmented mask differs from the dense one")
    return results


if __name__ == "__main__":
    main()
