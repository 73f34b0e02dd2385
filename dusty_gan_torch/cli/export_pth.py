"""Export the JAX package's native ``.ckpt`` as a reference-format ``.pth``
(``dusty_gan_tpu/cli/export_pth.py``), with neither JAX nor flax:

    python -m dusty_gan_torch.cli.export_pth \\
        --model-path <run>/models/checkpoint_0025000000.ckpt \\
        --config-path <run>/.hydra/config.yaml \\
        --output checkpoint_0025000000.pth

The ``.ckpt`` is read by ``utils/jax_checkpoint.py`` and the file written
is the JAX package's own export of it, entry for entry: G, D and G_ema,
both Adam states, the image step and ``pl_ema``.  It needs no GPU.  The
port's evaluation CLIs and ``resume=`` also read the ``.ckpt`` directly.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import torch

from dusty_gan_torch.config import load_config
from dusty_gan_torch.utils.jax_checkpoint import read_jax_checkpoint, reference_checkpoint_from_jax


def main(argv=None) -> str:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", type=str, required=True, help="native JAX .ckpt checkpoint")
    parser.add_argument("--config-path", type=str, required=True)
    parser.add_argument("--output", type=str, required=True, help=".pth path to write")
    args = parser.parse_args(argv)

    if not args.model_path.endswith(".ckpt"):
        raise SystemExit("--model-path must be a native .ckpt checkpoint "
                         "(a .pth is already reference-format)")
    cfg = load_config(args.config_path)
    ckpt = reference_checkpoint_from_jax(read_jax_checkpoint(args.model_path), cfg)
    os.makedirs(osp.dirname(osp.abspath(args.output)), exist_ok=True)
    torch.save(ckpt, args.output)
    print(f"exported reference-format checkpoint: {args.output} (#images {ckpt['step']})")
    return args.output


if __name__ == "__main__":
    main()
