"""Metrics over folders of rendered images (port of
`pointnerf_tpu/run/evaluate.py`).

The JAX CLI's arguments (-i/-g/-o/-is/-gs/-l/-m and the LPIPS weight
files, reference run/evaluate.py:20-31) over `utils.metrics.report_metrics`,
plus --device (default cuda), where LPIPS runs.

    python -m pointnerf_tpu_torch.run.evaluate -i <ckpt>/images/test_200000 \
        -m psnr ssim rmse lpips --lpips_alex_weights lpips_alex_full.pth
"""

from __future__ import annotations

import argparse

from ..utils.metrics import report_metrics


def main(argv=None):
    p = argparse.ArgumentParser(description="compute scores")
    p.add_argument("-i", "--imgFolder", required=True,
                   help="folder with rendered images")
    p.add_argument("-g", "--gtFolder", default=None,
                   help="folder with gt images (default: imgFolder)")
    p.add_argument("-o", "--outFolder", default=None,
                   help="folder for metric txt outputs (default: imgFolder)")
    p.add_argument("-is", "--imgStr", default="step-%04d-coarse_raycolor.png")
    p.add_argument("-gs", "--gtStr", default="step-%04d-gt_image.png")
    p.add_argument("-l", "--id_list", nargs="+", type=int, default=None)
    p.add_argument("-m", "--metrics", nargs="+",
                   default=["psnr", "ssim", "rmse"])
    p.add_argument("--lpips_alex_weights", default=None,
                   help="local path to LPIPS-alex weights (enables 'lpips')")
    p.add_argument("--lpips_vgg_weights", default=None,
                   help="local path to LPIPS-vgg weights (enables 'vgglpips')")
    p.add_argument("--device", default="cuda", help="where LPIPS runs")
    a = p.parse_args(argv)

    weights = {}
    if a.lpips_alex_weights:
        weights["lpips"] = a.lpips_alex_weights
    if a.lpips_vgg_weights:
        weights["vgglpips"] = a.lpips_vgg_weights

    scores = report_metrics(
        a.gtFolder or a.imgFolder, a.imgFolder, a.outFolder or a.imgFolder,
        metrics=tuple(a.metrics), img_str=a.imgStr, gt_str=a.gtStr,
        id_list=a.id_list, lpips_weights=weights or None, device=a.device)
    for k, v in scores.items():
        print(f"{k}: {v:.6f}")
    return scores


if __name__ == "__main__":
    main()
