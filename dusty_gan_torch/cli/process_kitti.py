"""KITTI preprocessing (``dusty_gan_tpu/cli/process_kitti.py``):

    python -m dusty_gan_torch.cli.process_kitti --root-dir <kitti_root> [--n-jobs N]

Reads ``<root>/dataset/sequences/NN/velodyne/*.bin`` (and SemanticKITTI
``labels/*.label`` where present); writes (64, 2048, 4) range images to
``<root>/dusty-gan/sequences`` (labels as paletted PNGs) and the train
split's mean angle grid to ``<root>/angles.npy`` and ``<root>/angles.pt``.
Host only: the projection runs the native library (``data/native.py``).
"""

from __future__ import annotations

import argparse

from dusty_gan_torch.data.preprocess import process_kitti_root


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root-dir", type=str, required=True)
    parser.add_argument("--height", type=int, default=64)
    parser.add_argument("--width", type=int, default=2048)
    parser.add_argument("--n-jobs", type=int, default=None,
                        help="worker processes (default: all cores; 1 = inline)")
    args = parser.parse_args(argv)
    return process_kitti_root(args.root_dir, args.height, args.width, n_jobs=args.n_jobs)


if __name__ == "__main__":
    main()
