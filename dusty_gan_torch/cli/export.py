"""Export a trained generator as a ``torch.export`` serving artifact
(``dusty_gan_tpu/cli/export.py``):

    python -m dusty_gan_torch.cli.export \\
        --model-path <run>/models/checkpoint_0025000000.pth \\
        --config-path <run>/.hydra/config.yaml \\
        --output-dir exports/dusty2_kitti [--dtype bf16] [--batch-size 0] \\
        [--tol 0] [--mask-threshold 0.5] [--no-points] [--no-verify] [--device cuda]

Writes ``generator.pt2`` and ``manifest.json`` (``utils/export.py`` has the
artifact's contract).  Reads a reference-format ``.pth`` or the JAX
package's native ``.ckpt``, like every evaluation CLI.  The program holds
its weights on ``--device`` and runs there; ``cli/serve.py`` serves it.
"""

from __future__ import annotations

import argparse
import os.path as osp

import numpy as np
import torch

from dusty_gan_torch import resolve_device
from dusty_gan_torch.utils.export import (export_generator, load_exported, resolve_dtype,
                                          save_exported)
from dusty_gan_torch.utils.setup import make_eval_generator, setup

# the reload self-test's holds (the JAX CLI's): the DUSty drop mask is a
# hard threshold, so cells near it may flip between two compilations
MASK_AGREEMENT, MAX_DEPTH_DIFF, MEAN_DEPTH_DIFF = 0.98, 0.05, 0.005


def verify(export_dir: str, G, fixed_noise, dtype, in_ch: int, batch: int,
           mask_threshold: float, device) -> dict:
    """Reload the saved artifact and hold its depth against the live
    generator's on a batch of latents from ``np.random.RandomState(0)``:
    mask agreement, and the largest and mean depth difference on the cells
    both kept."""
    call, _ = load_exported(export_dir)
    z = torch.from_numpy(np.random.RandomState(0).randn(batch, in_ch).astype(np.float32))
    z = z.to(device)
    gen = make_eval_generator(G, fixed_noise, dtype)
    with torch.inference_mode():
        got = call(z)["depth"].float().cpu().numpy()
        want = gen(z, threshold=mask_threshold)["depth"].float().cpu().numpy()
    want = np.clip((want + 1.0) / 2.0, 0.0, 1.0)
    mask_got, mask_want = got > 0, want > 0
    agree = float(np.mean(mask_got == mask_want))
    diff = np.abs(got - want)[mask_got & mask_want]
    max_diff = float(diff.max()) if diff.size else 0.0
    mean_diff = float(diff.mean()) if diff.size else 0.0
    if agree < MASK_AGREEMENT or max_diff > MAX_DEPTH_DIFF or mean_diff > MEAN_DEPTH_DIFF:
        raise AssertionError(
            f"artifact against the live generator on batch {batch}: mask agreement "
            f"{agree:.4f} (>= {MASK_AGREEMENT}), depth max|mean diff {max_diff:.4g}|"
            f"{mean_diff:.4g} (<= {MAX_DEPTH_DIFF}|{MEAN_DEPTH_DIFF})")
    return {"batch": batch, "mask_agreement": agree, "max_depth_diff": max_diff,
            "mean_depth_diff": mean_diff}


def main(argv=None) -> str:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", type=str, required=True)
    parser.add_argument("--config-path", type=str, required=True)
    parser.add_argument("--output-dir", type=str, required=True)
    parser.add_argument("--tol", type=float, default=0.0,
                        help="projection tolerance baked into the points output "
                             "(tune_tolerance result; 0 keeps all)")
    parser.add_argument("--mask-threshold", type=float, default=0.5,
                        help="Gumbel keep threshold baked into the artifact (reference: "
                             "0.5; pass a calibrated value from evaluate_synthesis "
                             "--calibrate-drop-rate to serve the drop-rate-matched "
                             "generator)")
    parser.add_argument("--batch-size", type=int, default=0,
                        help="fixed batch size; 0 (default) exports a dynamic batch "
                             "dimension")
    parser.add_argument("--dtype", type=str, default="bf16",
                        help="compute dtype inside the artifact (bf16|f32)")
    parser.add_argument("--no-points", action="store_true",
                        help="omit the Cartesian point-cloud output")
    parser.add_argument("--no-verify", action="store_true",
                        help="skip the reload and numerical self-test")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu: where the program holds its weights "
                             "and runs")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    dtype = resolve_dtype(args.dtype)
    cfg, G, lidar, fixed_noise = setup(args.model_path, args.config_path, device)
    in_ch = int(cfg.model.gen.in_ch)
    program = export_generator(G, fixed_noise, lidar, in_ch=in_ch, compute_dtype=dtype,
                               tol=args.tol, with_points=not args.no_points,
                               batch_size=args.batch_size or None,
                               mask_threshold=args.mask_threshold)
    manifest = {
        "arch": str(cfg.model.gen.arch),
        "dataset": str(cfg.dataset.name),
        "in_ch": in_ch,
        "image_shape": list(cfg.dataset.shape),
        "min_depth": float(cfg.dataset.min_depth),
        "max_depth": float(cfg.dataset.max_depth),
        "compute_dtype": args.dtype,
        "tol": args.tol,
        "mask_threshold": args.mask_threshold,
        "batch": args.batch_size or "dynamic",
        "device": str(device),
        "with_points": not args.no_points,
        "source_checkpoint": osp.abspath(args.model_path),
    }
    path = save_exported(program, args.output_dir, manifest)
    print(f"exported: {path} ({osp.getsize(path) / 1e6:.1f} MB, device={device}, "
          f"batch={manifest['batch']})")
    if not args.no_verify:
        res = verify(args.output_dir, G, fixed_noise, dtype, in_ch, args.batch_size or 2,
                     args.mask_threshold, device)
        print(f"verified: artifact ~= live generator on batch {res['batch']} "
              f"(mask agreement {res['mask_agreement']:.4f}, depth max|mean diff "
              f"{res['max_depth_diff']:.2g}|{res['mean_depth_diff']:.2g})")
    return args.output_dir


if __name__ == "__main__":
    main()
