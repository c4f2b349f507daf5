"""Metrics CLI: SSIM, PSNR and LPIPS over rendered image dirs, on the card.

Counterpart of the top-level `metrics.py` (reference `metrics.py:36-103`):

    python -m gsplat_tpu_torch.cli.metrics -m MODEL [MODEL ...] [--device cuda]

For each `MODEL/test/<method>/{renders,gt}` it writes `results.json` and
`per_view.json` in the model dir, with the JAX CLI's schema. SSIM and PSNR
are the port's `train/losses.ssim` and `losses.psnr`; LPIPS is
`eval/lpips.py`, with its weights from `GSPLAT_LPIPS_WEIGHTS`. Without
weights LPIPS is null and `LPIPS_status` says "weights_unavailable"; a
variable that names a missing file raises `FileNotFoundError`. `--device`
(default `cuda`) takes the place of the JAX CLI's `--cpu`.
"""

from __future__ import annotations

import json
import os
import sys
from argparse import ArgumentParser

import numpy as np
import torch


def read_images(renders_dir, gt_dir):
    from PIL import Image

    renders, gts, names = [], [], []
    for fname in sorted(os.listdir(renders_dir)):
        with Image.open(os.path.join(renders_dir, fname)) as r:
            renders.append(np.asarray(r.convert("RGB"), np.float32) / 255.0)
        with Image.open(os.path.join(gt_dir, fname)) as g:
            gts.append(np.asarray(g.convert("RGB"), np.float32) / 255.0)
        names.append(fname)
    return renders, gts, names


def evaluate(model_paths, device=None):
    """Write each model's `results.json` and `per_view.json`; metrics run on
    `device` (`None` means `cuda`)."""
    from gsplat_tpu_torch.device import resolve_device
    from gsplat_tpu_torch.eval.lpips import lpips, lpips_available
    from gsplat_tpu_torch.train.losses import psnr, ssim

    dev = resolve_device(device)
    use_lpips = lpips_available()
    if not use_lpips:
        if os.environ.get("GSPLAT_LPIPS_WEIGHTS"):
            # weights asked for but unusable: fail rather than publish a
            # results.json with LPIPS null
            raise FileNotFoundError(
                "GSPLAT_LPIPS_WEIGHTS is set but the file does not exist: "
                f"{os.environ['GSPLAT_LPIPS_WEIGHTS']!r}"
            )
        print("WARNING: LPIPS weights unavailable — reporting LPIPS as null "
              "with LPIPS_status='weights_unavailable' "
              "(set GSPLAT_LPIPS_WEIGHTS; see gsplat_tpu_torch/eval/lpips.py)",
              file=sys.stderr)

    for model_path in model_paths:
        print(f"Scene: {model_path}")
        full, per_view = {}, {}
        test_dir = os.path.join(model_path, "test")
        try:
            methods = sorted(os.listdir(test_dir))
        except FileNotFoundError:
            print(f"  no test renders in {model_path}", file=sys.stderr)
            continue
        for method in methods:
            print(f"  Method: {method}")
            mdir = os.path.join(test_dir, method)
            renders, gts, names = read_images(
                os.path.join(mdir, "renders"), os.path.join(mdir, "gt")
            )
            rows = []
            with torch.no_grad():
                for r, g in zip(renders, gts):
                    rt, gt = torch.from_numpy(r).to(dev), torch.from_numpy(g).to(dev)
                    row = [ssim(rt, gt), psnr(rt, gt)]
                    if use_lpips:
                        row.append(lpips(rt, gt))
                    rows.append(torch.stack(row))
            # device scalars until here: one copy to the host per method
            vals = torch.stack(rows).cpu().numpy().astype(np.float64)
            ssims, psnrs = vals[:, 0].tolist(), vals[:, 1].tolist()
            print(f"    SSIM : {np.mean(ssims):.7f}")
            print(f"    PSNR : {np.mean(psnrs):.7f}")
            if use_lpips:
                lpipss = vals[:, 2].tolist()
                lpips_full = float(np.mean(lpipss))
                lpips_per_view = dict(zip(names, lpipss))
                print(f"    LPIPS: {lpips_full:.7f}")
            else:
                # LPIPS stays numeric-or-null for numeric consumers; the
                # status field says why it is null
                lpips_full = None
                lpips_per_view = {n: None for n in names}
            full[method] = {
                "SSIM": float(np.mean(ssims)),
                "PSNR": float(np.mean(psnrs)),
                "LPIPS": lpips_full,
            }
            if not use_lpips:
                full[method]["LPIPS_status"] = "weights_unavailable"
            per_view[method] = {
                "SSIM": dict(zip(names, ssims)),
                "PSNR": dict(zip(names, psnrs)),
                "LPIPS": lpips_per_view,
            }
        with open(os.path.join(model_path, "results.json"), "w") as f:
            json.dump(full, f, indent=2)
        with open(os.path.join(model_path, "per_view.json"), "w") as f:
            json.dump(per_view, f, indent=2)


def main(argv=None):
    parser = ArgumentParser(description="gsplat_tpu_torch metrics")
    parser.add_argument("--model_paths", "-m", required=True, nargs="+", type=str)
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    evaluate(args.model_paths, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
