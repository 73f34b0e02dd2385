"""Export of the evaluation generator for serving (``dusty_gan_tpu/utils/export.py``).

The deterministic generator every evaluation CLI uses
(``utils.setup.make_eval_generator``: EMA weights, the frozen Gumbel
noise, the eval threshold) is traced once by ``torch.export`` into a
program with a dynamic batch dimension, saved with ``torch.export.save``
beside a JSON manifest.  A server loads the program and calls it at any
batch size with no model code and no checkpoint parsing.  The weights, the
fixed Gumbel field, the threshold, the projection tolerance and the LiDAR
angle table are constants of the program, on the device it was exported
on (the manifest's ``device``).  The JAX package's artifact is portable
StableHLO; a ``torch.export`` program is its counterpart.

Artifact contract, the JAX package's:

    z: f32[b, in_ch]  ->  {
        "depth":  f32[b, H, W, 1]   inverse depth in [0, 1], dropped
                                    pixels at 0
        "mask":   f32[b, H, W, 1]   effective binary drop mask (DUSty-II:
                                    pixel * image product; baseline: ones)
        "points": f32[b, H*W, 3]    Cartesian point cloud at the given
                                    projection tolerance (optional)
    }
"""

from __future__ import annotations

import hashlib
import json
import os
import os.path as osp
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from dusty_gan_torch.geometry.lidar import Lidar, tanh_to_sigmoid
from dusty_gan_torch.utils.setup import make_eval_generator

ARTIFACT_NAME = "generator.pt2"
MANIFEST_NAME = "manifest.json"
EXAMPLE_BATCH = 2  # torch.export specialises a dimension traced at size 0 or 1

_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
           "f32": torch.float32, "float32": torch.float32}


class ServingGenerator(nn.Module):
    """latent (B, in_ch) -> the serving output dict (module docstring); the
    counterpart of the JAX package's ``make_serving_fn``.

    ``mask_threshold`` is the Gumbel keep threshold (reference default 0.5;
    a calibrated value from ``utils.calibration`` serves the drop-rate-
    matched generator); ``tol`` the projection tolerance of ``points``
    (the JAX CLI's ``--tol``, default 0: every kept pixel).
    """

    def __init__(self, G: nn.Module, fixed_noise, lidar: Lidar, *,
                 compute_dtype=torch.bfloat16, tol: float = 0.0,
                 with_points: bool = True, mask_threshold: float = 0.5):
        super().__init__()
        self.G = G
        self.lidar = lidar
        self.gen = make_eval_generator(G, fixed_noise, compute_dtype)
        self.tol, self.with_points = float(tol), bool(with_points)
        self.mask_threshold = float(mask_threshold)

    def forward(self, z: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = self.gen(z, threshold=self.mask_threshold)
        inv01 = torch.clamp(tanh_to_sigmoid(out["depth"]), 0.0, 1.0).float()
        mask = out.get("mask")
        if mask is None:  # the baseline generator has no masker head
            mask = torch.ones_like(inv01)
        else:  # DUSty-II concatenates the pixel and image masks on channels
            mask = torch.prod(mask.float(), dim=-1, keepdim=True)
        res = {"depth": inv01, "mask": mask}
        if self.with_points:
            xyz = self.lidar.inv_to_xyz(inv01, self.tol)
            res["points"] = xyz.reshape(xyz.shape[0], -1, 3)
        return res


def export_generator(G: nn.Module, fixed_noise, lidar: Lidar, *, in_ch: int,
                     compute_dtype=torch.bfloat16, tol: float = 0.0,
                     with_points: bool = True, batch_size: Optional[int] = None,
                     mask_threshold: float = 0.5) -> torch.export.ExportedProgram:
    """``torch.export`` of the serving generator on G's device.
    ``batch_size=None`` exports a dynamic batch dimension (one program
    serves every batch size); an int fixes it."""
    module = ServingGenerator(G, fixed_noise, lidar, compute_dtype=compute_dtype, tol=tol,
                              with_points=with_points, mask_threshold=mask_threshold).eval()
    device = next(G.parameters()).device
    b = EXAMPLE_BATCH if batch_size is None else int(batch_size)
    example = torch.zeros((b, in_ch), dtype=torch.float32, device=device)
    dynamic = {"z": {0: torch.export.Dim("b", min=1)}} if batch_size is None else None
    with torch.no_grad():
        return torch.export.export(module, (example,), dynamic_shapes=dynamic)


def save_exported(program: torch.export.ExportedProgram, out_dir: str,
                  manifest: Dict[str, Any]) -> str:
    """Write the program and the manifest (with the artifact's name, sha256
    and size, the torch version and the device) to ``out_dir``; returns the
    artifact's path."""
    os.makedirs(out_dir, exist_ok=True)
    path = osp.join(out_dir, ARTIFACT_NAME)
    torch.export.save(program, path)
    with open(path, "rb") as f:
        blob = f.read()
    manifest = dict(manifest)
    manifest["artifact"] = ARTIFACT_NAME
    manifest["artifact_sha256"] = hashlib.sha256(blob).hexdigest()
    manifest["artifact_bytes"] = len(blob)
    manifest["torch_version"] = torch.__version__
    with open(osp.join(out_dir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    return path


def load_exported(export_dir: str) -> Tuple[Callable, Dict[str, Any]]:
    """(callable, manifest) from an export directory.  The callable maps
    ``z: f32[b, in_ch]`` on the manifest's device to the output dict; the
    artifact's hash is checked against the manifest before it is
    deserialised.  A program exported on a GPU needs one to load."""
    with open(osp.join(export_dir, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    path = osp.join(export_dir, manifest["artifact"])
    with open(path, "rb") as f:
        got = hashlib.sha256(f.read()).hexdigest()
    if got != manifest["artifact_sha256"]:
        raise ValueError(f"artifact hash mismatch under {export_dir}: "
                         f"{got} != manifest {manifest['artifact_sha256']}")
    if torch.device(manifest["device"]).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{export_dir} was exported on {manifest['device']} and holds its weights "
            "there, but torch.cuda.is_available() is False: load it on a machine with "
            "a GPU, or export again with --device cpu")
    return torch.export.load(path).module(), manifest


def resolve_dtype(name: str):
    try:
        return _DTYPES[name]
    except KeyError:
        raise SystemExit(f"unknown dtype {name!r}; choose from {sorted(_DTYPES)}") from None
