"""What the benchmark makes from ``--seed`` and hands to both sides: LiDAR
scans, weights, a train step's random draws and its batch rows.

Everything is drawn on the run's device, from ``torch.Generator``s seeded
from (seed, stream), in a few large calls.  A CPU generator keeps only the
low 32 bits of its seed, so the mixing puts (seed, stream) into those.

The scans stand in for KITTI's and the MPO set's, which a sealed machine
cannot fetch: each column of a scan sees the nearer of a ground plane 1.7 m
below the sensor and up to nine walls (4 to 9 a scan, each 0.1 to 1.0 rad
wide, 3 to 60 m away), with 3% range noise and 12% of the returns dropped,
at the sensor's elevation angles and the configuration's range gate; a
depth is normalised to [0, 1] over the gate, 0 where there is no return.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

WEIGHTS, SCANS, DRAWS, ROWS, LATENTS, EXTRA = range(6)
MAX_WALLS = 9
SENSOR_HEIGHT_M = 1.7
RANGE_NOISE = 0.03
DROP_SHARE = 0.12


def generator(seed: int, stream: int, device) -> torch.Generator:
    mixed = (int(seed) * 0x9E3779B1 + int(stream) * 0x85EBCA77 + 0x2545F491) & 0xFFFFFFFF
    return torch.Generator(device=device).manual_seed((int(seed) % (1 << 31)) << 32 | mixed)


def angles(sensor: dict, shape) -> np.ndarray:
    """(2, H, W) float32 elevation and azimuth (radians) of each pixel: the
    sensor's rows evenly between its top and bottom elevation, azimuths
    from +pi clockwise."""
    h, w = shape
    top, bottom = sensor["elevation_deg"]
    pitch = np.radians(np.linspace(top, bottom, h))[:, None] * np.ones((1, w))
    yaw = np.linspace(np.pi, -np.pi, w, endpoint=False)[None, :] * np.ones((h, 1))
    return np.stack([pitch, yaw]).astype(np.float32)


def scans(n: int, shape, sensor: dict, min_depth: float, max_depth: float,
          gen: torch.Generator, device, chunk: int = 4096) -> torch.Tensor:
    """(n, H, W) float32 normalised depths."""
    h, w = shape
    grid = torch.from_numpy(angles(sensor, shape)).to(device)
    pitch, yaw = grid[0][:, :1], grid[1][0]
    ground = torch.where(pitch < -1e-3, SENSOR_HEIGHT_M / torch.sin(-pitch).clamp_min(1e-6),
                         torch.full_like(pitch, math.inf)).clamp_max(0.8 * max_depth)
    out = torch.empty((n, h, w), dtype=torch.float32, device=device)
    kw = dict(generator=gen, device=device)
    for s in range(0, n, chunk):
        b = min(chunk, n - s)
        walls = torch.randint(4, MAX_WALLS + 1, (b, 1), **kw)
        active = torch.arange(MAX_WALLS, device=device).view(1, -1) < walls
        centre = (torch.rand((b, MAX_WALLS), **kw) * 2 - 1) * math.pi
        half = 0.05 + 0.45 * torch.rand((b, MAX_WALLS), **kw)
        dist = 3.0 + 57.0 * torch.rand((b, MAX_WALLS), **kw)
        off = torch.remainder(yaw.view(1, 1, w) - centre[..., None] + math.pi,
                              2 * math.pi) - math.pi
        hit = (off.abs() < half[..., None]) & active[..., None]  # (b, walls, W)
        wall = torch.where(hit, dist[..., None], torch.full_like(off, math.inf)).amin(1)
        d = torch.minimum(ground.view(1, h, 1), wall.view(b, 1, w))
        d = d * (1 + RANGE_NOISE * (2 * torch.rand((b, h, w), **kw) - 1))
        d = torch.where(torch.rand((b, h, w), **kw) < DROP_SHARE, torch.zeros_like(d), d)
        valid = (d > min_depth) & (d < max_depth)
        out[s:s + b] = torch.where(valid, (d - min_depth) / (max_depth - min_depth),
                                   torch.zeros_like(d))
    return out


def logistic(gen, shape, device, eps: float = 1e-10) -> torch.Tensor:
    """The Gumbel-sigmoid's noise: -log(log(u1 + eps) / log(u2 + eps) + eps)."""
    u1 = torch.rand(shape, generator=gen, device=device)
    u2 = torch.rand(shape, generator=gen, device=device)
    return -torch.log(torch.log(u1 + eps) / torch.log(u2 + eps) + eps)


def augment_draws(policy: Sequence[str], b: int, shape, gen, device) -> List:
    """DiffAugment's draws for a batch of ``b``: colour u ~ U(-1, 1);
    translation shifts uniform in +-round(H/16), +-round(W/16); cutout
    offsets uniform in [0, H + 1 - cut % 2) with cut = round(H/2), and so
    for W."""
    h, w = shape
    kw = dict(generator=gen, device=device)
    out = []
    for name in policy:
        if name in ("brightness", "saturation", "contrast"):
            out.append((name, {"u": torch.rand((b,), **kw) * 2 - 1}))
        elif name == "translation":
            sh, sw = int(h / 16 + 0.5), int(w / 16 + 0.5)
            out.append((name, {"th": torch.randint(-sh, sh + 1, (b,), **kw),
                               "tw": torch.randint(-sw, sw + 1, (b,), **kw)}))
        elif name == "cutout":
            ch, cw = int(h * 0.5 + 0.5), int(w * 0.5 + 0.5)
            out.append((name, {"off_h": torch.randint(0, h + 1 - ch % 2, (b,), **kw),
                               "off_w": torch.randint(0, w + 1 - cw % 2, (b,), **kw)}))
        else:
            raise ValueError(f"unknown augmentation {name!r}")
    return out


def step_draws(model: dict, policy: Sequence[str], b: int, shape, gen, device) -> Dict:
    """One train step's draws: latents, the masker's Gumbel noise, and
    DiffAugment's for D's reals, D's fakes and G's fakes."""
    masker = str(model["gen"]["arch"]).split("/")[0]
    z = torch.randn((b, int(model["gen"]["in_ch"])), generator=gen, device=device)
    pixel = (b, 1) + tuple(shape)
    gumbel = {"dusty1": lambda: logistic(gen, pixel, device),
              "dusty2": lambda: {"pixel": logistic(gen, pixel, device),
                                 "image": logistic(gen, (b, 1, 1, 1), device)},
              "none": lambda: None}[masker]()
    return {"z": z, "gumbel": gumbel,
            "aug_d_real": augment_draws(policy, b, shape, gen, device),
            "aug_d_fake": augment_draws(policy, b, shape, gen, device),
            "aug_g_fake": augment_draws(policy, b, shape, gen, device)}
