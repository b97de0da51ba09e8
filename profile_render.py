"""Where the time of one lego-preset render or train step goes, on one CUDA GPU.

    python3 profile_render.py [--train | --mvs | --dtu | --tt]
                              [--fused-shade]
                              [--out build/traces/render_trace.json]

Builds chip_smoke.py's main-path workload (the lego preset, bench.py's
100k-point cloud, seeded random weights), in the fused_shade configuration
with --fused-shade (the shade kernels K4 and K5 in place of K1 and K2).
Without --train it renders one
800x800 NeRF-Synthetic view once to warm up, then profiles a second
render_image call; with --train it takes one warm-up train_step on
chip_smoke's 3,600-ray train batch, then profiles a second; with --mvs it
writes chip_smoke's 800x800 plate scene and runs one view triplet of the
MVS point init (gen_points at chip_smoke's MVS options: MVSNet over 128
depth planes, fusion, embeddings) once, then profiles a second; with --dtu
it writes chip_smoke's 640x512 DTU-layout plate scene and runs the
feed-forward inference of one test item (run/train.infer_item at
chip_smoke's dtu_inf options: MVSNet, the FPN points, the frustum grid,
the full image) once, then profiles a second; with --tt it writes
chip_smoke's 1920x1080 Tanks&Temples-layout plate scene and renders one
test view at tt_preset("Truck")'s widths (the scene's points, seeded
random weights: what test_ft renders) once, then profiles a second. The
profile is
torch.profiler's (CPU and CUDA activities). Prints the wall time, the
device busy share (the union of the kernel and copy intervals over the wall
time) and the device time per kernel family, then writes the Chrome trace
to --out. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

# kernel families, by a substring of the kernel's name (first match wins);
# K2's and K5's weight-gradient phase (`wgrad_kernel`, `reduce_splits`,
# `reduce_head`) goes to the backward kernel of the configuration profiled,
# and the trunk kernels' weight splits to a family of their own
WGRAD = ("wgrad_kernel", "reduce_splits", "reduce_head")
FAMILIES = (("K1 trunk_fwd", ("trunk_fwd",)),
            ("K2 trunk_bwd", ("trunk_bwd",) + WGRAD),
            ("TF32 weight splits", ("split_weights",)),
            ("K3 occupancy", ("occupancy",)),
            ("K4 shade_fwd", ("shade_fwd",)),
            ("K5 shade_bwd", ("shade_bwd",)),
            ("K6 scatter_rows", ("scatter_rows",)),
            ("K7 row_select", ("row_select",)),
            ("max_pool3d (grid dilation)", ("max_pool", "pool3d")),
            ("Adam", ("adam", "multi_tensor")),
            ("cuDNN convs", ("fprop", "dgrad", "convolve", "conv_")),
            ("batch norm", ("bn_fw",)),
            ("grid_sample", ("grid_sampler",)),
            ("scatters", ("scatter", "index_put", "indexing_backward")),
            ("gathers", ("gather", "index")),
            ("sorts", ("sort",)),
            ("GEMMs", ("gemm", "xmma", "cutlass")),
            ("scans", ("scan", "cumsum")))


def family(name: str, shade: bool = False) -> str:
    low = name.lower()
    if shade and any(k in low for k in WGRAD):
        return "K5 shade_bwd"
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "rest"


def union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train", action="store_true",
                    help="profile a train step instead of a render")
    ap.add_argument("--mvs", action="store_true",
                    help="profile one triplet of the MVS point init")
    ap.add_argument("--dtu", action="store_true",
                    help="profile one feed-forward DTU image (dtu_inf)")
    ap.add_argument("--tt", action="store_true",
                    help="profile one 1920x1080 T&T test view (test_ft)")
    ap.add_argument("--fused-shade", action="store_true",
                    help="profile the fused_shade configuration")
    ap.add_argument("--out", default=None,
                    help="where to write the Chrome trace (default "
                    "build/traces/{render,train}[_shade]_trace.json)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_render: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chip_smoke import GROUP, build_workload
    from pointnerf_tpu_torch.run.workload import make_train_batch
    from pointnerf_tpu_torch.ops import kernels
    from pointnerf_tpu_torch.run import common
    from pointnerf_tpu_torch.train import trainer
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    kernels.library()
    dev = torch.device("cuda")
    if args.mvs:
        import tempfile
        from chip_smoke import MVS_WH, mvs_options
        from pointnerf_tpu_torch.data import create_dataset
        from pointnerf_tpu_torch.models.mvs import points_model as pm
        from pointnerf_tpu_torch.run.workload import make_plate_scene
        # full fp32 convolutions, as chip_smoke runs the init
        torch.backends.cudnn.allow_tf32 = False
        with tempfile.TemporaryDirectory() as root:
            make_plate_scene(root, wh=(MVS_WH, MVS_WH))
            opt = mvs_options(root)
            sample = create_dataset(opt, "train").get_init_item(0)
        mvs = pm.MvsPoints(opt, torch.Generator().manual_seed(opt.seed),
                           device=dev)
        run = lambda: pm.gen_points(mvs, opt, sample)
        what = (f"MVS init, one triplet at {MVS_WH}x{MVS_WH}, D "
                f"{opt.depth_grid}")
    elif args.dtu:
        import tempfile
        from chip_smoke import DTU_VIEWS, DTU_WH, dtu_inf_options
        from pointnerf_tpu_torch.data import create_dataset
        from pointnerf_tpu_torch.run import train as gen
        from pointnerf_tpu_torch.run.workload import make_dtu_scene
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        tmp = tempfile.TemporaryDirectory()
        make_dtu_scene(tmp.name, n_views=DTU_VIEWS, wh=DTU_WH)
        opt = dtu_inf_options(tmp.name)
        ds = create_dataset(opt, "test")
        spec = gen.make_render_spec(opt, ds, gen.point_slots(opt))
        state = gen.create_gen_state(opt, device=dev)
        item = ds.get_item(0, full_img=True)
        run = lambda: gen.infer_item(state, opt, spec, item)
        what = (f"feed-forward DTU image {DTU_WH[0]}x{DTU_WH[1]} (points, "
                f"frustum grid, render)")
    elif args.tt:
        import tempfile
        from chip_smoke import (TT_HALF, TT_RADIUS, TT_SIDE, TT_VIEWS, TT_WH,
                                tt_options)
        from pointnerf_tpu_torch.data import create_dataset
        from pointnerf_tpu_torch.run.workload import make_tt_scene
        torch.backends.cuda.matmul.allow_tf32 = False
        tmp = tempfile.TemporaryDirectory()
        make_tt_scene(tmp.name, wh=TT_WH, n_train=TT_VIEWS[0],
                      n_test=TT_VIEWS[1], radius=TT_RADIUS, half=TT_HALF,
                      side=TT_SIDE)
        opt = tt_options(tmp.name)
        state = common.init_point_state_from_dataset(
            opt, create_dataset(opt, "train"), device=dev)
        ts = trainer.create_train_state(opt, state,
                                        torch.Generator().manual_seed(0))
        spec, grid = common.make_spec_and_grid(opt, state)
        item = create_dataset(opt, "test").get_item(0, full_img=True)
        run = lambda: common.render_image(ts, grid, opt, spec, item)
        what = (f"T&T test view {TT_WH[0]}x{TT_WH[1]} (tt_preset Truck, "
                f"{int(state['mask'].sum())} points)")
    else:
        opt, state, spec, grid, _, ts, item, _ = build_workload(dev)
        if args.fused_shade:
            opt = opt.replace(fused_shade=1)
        if args.train:
            st = trainer.create_train_state(opt, state,
                                            torch.Generator().manual_seed(0))
            batch = make_train_batch(opt, dev)
            run = lambda: trainer.train_step(st, grid, batch, opt, spec)
            what = f"train step of {batch['raydir'].shape[1]} rays"
            if args.fused_shade:
                what += " (fused_shade)"
        else:
            run = lambda: common.render_image(ts, grid, opt, spec, item,
                                              group=GROUP)
            what = "render 800x800" + (" (fused_shade)" if args.fused_shade
                                       else "")
    out = args.out or "build/traces/{}{}_trace.json".format(
        "mvs" if args.mvs else "dtu" if args.dtu else "tt" if args.tt
        else "train" if args.train else "render",
        "_shade" if args.fused_shade else "")
    run()
    for k in kernels.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)

    # device kernels and copies; the spans of record_function annotations
    # (e.g. Optimizer.step) that the profiler also puts on the device
    # cover kernels already counted, and the gaps between them
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
    if not dev_events:
        raise RuntimeError("the profiler recorded no device activity")
    spans = [(e.time_range.start, e.time_range.end) for e in dev_events]
    busy_ms = union_us(spans) / 1e3
    by_family, launches = {}, {}
    for e in dev_events:
        fam = family(e.name, args.fused_shade)
        by_family[fam] = by_family.get(fam, 0.0) + e.time_range.elapsed_us()
        launches[fam] = launches.get(fam, 0) + 1
    total_ms = sum(by_family.values()) / 1e3
    print(f"{what} under the profiler: wall {wall_ms:.1f} ms, device "
          f"busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}% of wall), "
          f"device time summed over kernels {total_ms:.1f} ms; port launch "
          f"counts {({k.name: k.launches for k in kernels.KERNELS})}")
    print(f"{'family':<14} {'ms':>9} {'share':>7} {'kernels':>8}")
    for fam, us in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"{fam:<14} {us / 1e3:9.3f} {100 * us / 1e3 / total_ms:6.1f}% "
              f"{launches[fam]:8d}")
    names = {}
    for e in dev_events:
        names[e.name] = names.get(e.name, 0.0) + e.time_range.elapsed_us()
    print("top device kernels (ms):")
    for name, us in sorted(names.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {us / 1e3:9.1f}  {name[:110]}")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    prof.export_chrome_trace(out)
    print(f"trace written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
