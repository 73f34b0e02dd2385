"""The demo on the GPU (``dusty_gan_tpu/cli/demo.py``): synthesis with
latent interpolation, and inversion of a corrupted test scan, single-code
or multi-code mGANprior, writing PNG panels.

    python -m dusty_gan_torch.cli.demo synthesis \\
        --model-path <checkpoint.pth> --config-path <config.yaml> \\
        [--latent-type random|lerp|slerp] [--num-samples 8] [--video] \\
        [--out demo_out/synthesis] [--device cuda]

    python -m dusty_gan_torch.cli.demo inversion \\
        --model-path <checkpoint.pth> --config-path <config.yaml> \\
        [--corruption dropout|closing|...] [--distance l1,l2,chamfer] \\
        [--num-code 1] [--compose-layer 1] [--num-step 1000] [--device cuda]

Synthesis runs the latents through the bf16 eval generator (fixed Gumbel
noise) and writes, per sample, the JAX CLI's panels: ``NN_<panel>.png``
for the inverse depth before and after the drops, the measurability maps,
the mask, the normal map and the bird's-eye view (BEV); ``--video`` writes
``<out>/<latent type>.mp4`` through cv2 or, without cv2,
``<out>/<latent type>.gif`` (``utils/video.py``).

Inversion takes test scan ``--index``, corrupts it (``utils/corruption.py``)
and optimises a latent against the sum of the ``--distance`` terms: the
masked L1 or L2 on the normalised inverse depth, and the Chamfer distance
between the corrupted scan's cloud and the generated one
(``metrics.chamfer.chamfer_distance``: the ``nn_argmin`` kernel both ways,
twice a step, and its analytic backward).  One code runs through
``make_inversion_loop`` on the bf16 eval generator; ``--num-code`` N > 1
blends N codes after stage ``--compose-layer`` of the float32 generator
(``make_multicode_loop``).  It writes the reference and reconstruction
panels and the two BEV renders.

Every random draw comes from a CPU generator seeded by ``--seed`` (``Draws``),
so a run on the card and one on the CPU draw the same numbers; a test
hands in the JAX package's draws through the same methods.  The BEV camera
is top-down unless a ``--view-*`` flag is given (``_camera``).
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import time
import types

import numpy as np
import torch

from dusty_gan_torch import resolve_device, synchronize
from dusty_gan_torch.data.datasets import define_dataset
from dusty_gan_torch.geometry.lidar import tanh_to_sigmoid
from dusty_gan_torch.geometry.normals import euler_angles_to_rotation_matrix, xyz_to_normal
from dusty_gan_torch.geometry.render import render_point_clouds
from dusty_gan_torch.metrics.chamfer import chamfer_distance
from dusty_gan_torch.models.dusty import DUSty1, DUSty2
from dusty_gan_torch.models.losses import masked_loss
from dusty_gan_torch.utils import corruption
from dusty_gan_torch.utils.inversion import (NoiseFn, lerp, make_inversion_loop,
                                             make_multicode_loop, project_sphere, slerp)
from dusty_gan_torch.utils.postprocess import cmap_table, colorize, postprocess
from dusty_gan_torch.utils.setup import make_eval_generator, setup
from dusty_gan_torch.utils.video import save_video, write_png

COLOR_SCALE = 1 / 0.4  # the reference demo's colour scale for inverse depth
BEV_SIZE = 512
DISTANCES = ("l1", "l2", "chamfer")
CORRUPTIONS = ("none", "additive noise", "low resolution", "dropout", "closing", "half",
               "quarter", "vlines", "hlines", "random lines")
# --seed s seeds each draw's CPU generator s + its offset (a CPU generator
# keeps the low 32 bits of a seed, so the offsets differ there)
LATENT_SEED, CORRUPTION_SEED, Z0_SEED, NOISE_SEED = 0, 1 << 20, 2 << 20, 3 << 20


class Draws:
    """The demo's random draws, each from a CPU generator of its own."""

    def __init__(self, seed: int):
        self.seed = int(seed)

    def _generator(self, offset: int) -> torch.Generator:
        return torch.Generator().manual_seed(self.seed + offset)

    def latents(self, n: int, in_ch: int) -> torch.Tensor:
        """(n, in_ch) synthesis latents (the two ends for lerp and slerp)."""
        return torch.randn((n, in_ch), generator=self._generator(LATENT_SEED))

    def corruption(self) -> corruption.Draws:
        return corruption.Draws(self._generator(CORRUPTION_SEED))

    def z0(self, n: int, in_ch: int) -> torch.Tensor:
        """(n, in_ch) initial codes of the inversion."""
        return torch.randn((n, in_ch), generator=self._generator(Z0_SEED))

    def noise(self, device) -> NoiseFn:
        """Single-code inversion's per-step latent noise."""
        g = self._generator(NOISE_SEED)
        return lambda step, shape: torch.randn(tuple(shape), generator=g).to(device)


def _save_png(path: str, img) -> None:
    """(H, W, C) values in [0, 1] -> an 8-bit RGB PNG (C = 1 is grey)."""
    img = np.asarray(np.clip(np.asarray(img), 0, 1) * 255, np.uint8)
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, -1)
    write_png(path, img)


def _camera(zoom, yaw, pitch):
    """The BEV camera of the reference's view sliders: zoom in metres ->
    t = [0.1 z, 0, z] / 120; yaw and pitch in degrees -> R = Rz Ry Rx of
    [0, pitch, -yaw].  (None, [0, 0, 0.5]) when no flag is given."""
    if zoom is None and yaw is None and pitch is None:
        return None, torch.tensor([0.0, 0.0, 0.5])
    zoom = 60.0 if zoom is None else float(zoom)  # the sliders' defaults
    yaw = -45.0 if yaw is None else float(yaw)
    pitch = 60.0 if pitch is None else float(pitch)
    t_z = zoom / 120.0
    t = torch.from_numpy(np.asarray([0.1 * t_z, 0.0, t_z], np.float32))
    angles = np.asarray([0.0, pitch / 180.0 * np.pi, -yaw / 180.0 * np.pi])
    return euler_angles_to_rotation_matrix(angles), t


def _numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def synthesis(args, draws: Draws = None):
    """Returns the panel names, the panels ({name: (n, H, W, 3) array}) and
    the video's path (or None)."""
    device = resolve_device(args.device)
    cfg, G, lidar, fixed_noise = setup(args.model_path, args.config_path, device)
    gen = make_eval_generator(G, fixed_noise)
    draws = Draws(args.seed) if draws is None else draws
    n, in_ch = args.num_samples, int(cfg.model.gen.in_ch)
    cmap = cmap_table(args.cmap)

    if args.latent_type == "random":
        latent = draws.latents(n, in_ch)
    else:
        ends = draws.latents(2, in_ch)
        f = lerp if args.latent_type == "lerp" else slerp
        latent = torch.cat([f(float(w), ends[:1], ends[1:]) for w in np.linspace(0, 1, n)])

    with torch.no_grad():
        out = postprocess(gen(latent.to(device)), lidar)
        panels = []
        if "depth_orig" in out:
            panels.append(("inverse_depth", colorize(out["depth_orig"] * COLOR_SCALE, cmap)))
        if "confidence" in out:
            conf = out["confidence"]
            if conf.shape[-1] == 2:
                panels.append(("measurability_pix", colorize(conf[..., :1], cmap)))
                panels.append(("measurability_img", colorize(conf[..., 1:], cmap)))
            else:
                panels.append(("measurability", colorize(conf, cmap)))
        if "mask" in out:
            panels.append(("mask", out["mask"].prod(-1, keepdim=True).expand(-1, -1, -1, 3)))
        depth_rgb = colorize(out["depth"] * COLOR_SCALE, cmap)
        panels.append(("inverse_depth_with_drops", depth_rgb))
        panels.append(("point_normal", out["normals"]))
        R, t = _camera(args.view_zoom, args.view_yaw, args.view_pitch)
        pts = out["points"].reshape(n, -1, 3)
        bev = render_point_clouds(pts, out["normals"].reshape(n, -1, 3), L=BEV_SIZE, R=R, t=t)
        panels.append(("point_clouds_bev", bev))
    panels = {name: _numpy(p) for name, p in panels}

    os.makedirs(args.out, exist_ok=True)
    for i in range(n):
        for name, p in panels.items():
            _save_png(osp.join(args.out, f"{i:02d}_{name}.png"), p[i])
    print(f"wrote {n * len(panels)} panels to {args.out}")

    path = None
    if args.video:
        # one frame a sample: the 2x-upscaled inverse depth over the BEV
        depth_rgb, bev = panels["inverse_depth_with_drops"], panels["point_clouds_bev"]
        frames = []
        for i in range(n):
            top = np.repeat(np.repeat(depth_rgb[i], 2, 0), 2, 1)
            pad = bev.shape[2] - top.shape[1]
            if pad > 0:
                top = np.pad(top, ((0, 0), (pad // 2, pad - pad // 2), (0, 0)))
            elif pad < 0:  # a depth panel wider than the BEV: its centre
                off = -pad // 2
                top = top[:, off:off + bev.shape[2]]
            frames.append(np.concatenate([top, bev[i]], axis=0))
        path = save_video(frames, osp.join(args.out, f"{args.latent_type}"), fps=args.video_fps)
        print("wrote", path)
    return types.SimpleNamespace(names=list(panels), panels=panels, video=path)


def inversion(args, draws: Draws = None):
    """Returns the start latent (projected onto the sphere), the optimised
    one, the loss function of both, and the loop's seconds."""
    distances = args.distance.split(",")
    unknown = sorted(set(distances) - set(DISTANCES))
    if unknown:
        raise ValueError(f"--distance {args.distance}: unknown {unknown}, "
                         f"choose from {','.join(DISTANCES)}")
    device = resolve_device(args.device)
    cfg, G, lidar, fixed_noise = setup(args.model_path, args.config_path, device)
    gen = make_eval_generator(G, fixed_noise)
    is_dusty = "dusty" in str(cfg.model.gen.arch)
    draws = Draws(args.seed) if draws is None else draws
    in_ch = int(cfg.model.gen.in_ch)

    item = define_dataset(cfg.dataset, phase="test")[args.index]
    dep_ref = torch.from_numpy(item["depth"])[None].to(device)
    mask_ref = torch.from_numpy(item["mask"])[None].to(device)
    inv_ref = lidar.invert_depth(dep_ref) * mask_ref
    dep_c, mask_c = corruption.apply_corruption(draws.corruption(), inv_ref, mask_ref,
                                                args.corruption)
    inv_c = dep_c * mask_c
    pts_ref = lidar.inv_to_xyz(inv_c, 1e-8).reshape(1, -1, 3)

    def apply_composed(z, alpha):
        """The float32 generator blending N codes into one sample."""
        kw = dict(compute_dtype=None, compose_layer=args.compose_layer, compose_alpha=alpha)
        if isinstance(G, (DUSty1, DUSty2)):
            kw.update(train=False, fixed_noise=fixed_noise)
        return {k: v.permute(0, 2, 3, 1) for k, v in G(z, **kw).items()}

    def loss_fn(latent):
        if args.num_code > 1:
            out = apply_composed(latent["z"], latent["alpha"])
        else:
            out = gen(latent)
        inv_gen = tanh_to_sigmoid(out["depth_orig"] if is_dusty else out["depth"])
        loss = 0.0
        if "chamfer" in distances:
            pts_gen = lidar.inv_to_xyz(inv_gen, 1e-8).reshape(1, -1, 3)
            dl, dr = chamfer_distance(pts_ref, pts_gen)
            loss = loss + dl.mean(1) + dr.mean(1)
        if "l1" in distances:
            loss = loss + masked_loss(inv_c, inv_gen, mask_c, "l1")
        if "l2" in distances:
            loss = loss + masked_loss(inv_c, inv_gen, mask_c, "l2")
        return loss

    synchronize(device)
    t0 = time.perf_counter()
    if args.num_code > 1:
        # stage i emits ch(3 - i) channels; alpha is (N, C, 1, 1)
        feature_ch = getattr(G, "backbone", G).ch(3 - args.compose_layer)
        start = {"z": project_sphere(draws.z0(args.num_code, in_ch)).to(device),
                 "alpha": torch.full((args.num_code, feature_ch, 1, 1), 1.0 / args.num_code,
                                     device=device)}
        latent = make_multicode_loop(loss_fn, num_steps=args.num_step)(start)
        synchronize(device)
        t1 = time.perf_counter()
        with torch.no_grad():
            out = apply_composed(latent["z"], latent["alpha"])
    else:
        z0 = draws.z0(1, in_ch).to(device)
        start = project_sphere(z0)
        latent, final_loss = make_inversion_loop(loss_fn, num_steps=args.num_step, lr=0.1)(
            z0, draws.noise(device))
        synchronize(device)
        t1 = time.perf_counter()
        print("final loss:", _numpy(final_loss))
        with torch.no_grad():
            out = gen(latent)

    with torch.no_grad():
        out = postprocess(out, lidar)
        cmap = cmap_table(args.cmap)
        panels = {"ref_inv": colorize(inv_ref * COLOR_SCALE, cmap),
                  "ref_inv_corrupted": colorize((inv_c * mask_c) * COLOR_SCALE, cmap),
                  "gen_inv": colorize(out["depth"] * COLOR_SCALE, cmap)}
        if "depth_orig" in out:
            panels["gen_inv_orig"] = colorize(out["depth_orig"] * COLOR_SCALE, cmap)
        panels["gen_normals"] = out["normals"]
        # BEV renders of the corrupted reference and the reconstruction
        R, t = _camera(args.view_zoom, args.view_yaw, args.view_pitch)
        nrm_ref = xyz_to_normal(lidar.inv_to_xyz(inv_c * mask_c, 1e-8)).reshape(1, -1, 3)
        panels["ref_bev"] = render_point_clouds(pts_ref, nrm_ref, L=BEV_SIZE, R=R, t=t)
        panels["gen_bev"] = render_point_clouds(out["points"].reshape(1, -1, 3),
                                                out["normals"].reshape(1, -1, 3),
                                                L=BEV_SIZE, R=R, t=t)
    os.makedirs(args.out, exist_ok=True)
    for name, p in panels.items():
        _save_png(osp.join(args.out, f"{name}.png"), _numpy(p[0]))
    print("wrote inversion panels to", args.out)
    return types.SimpleNamespace(start=start, latent=latent, loss=loss_fn,
                                 inversion_s=t1 - t0, names=list(panels))


def main(argv=None, draws: Draws = None):
    """Runs the subcommand; returns what it returns.  ``draws`` replaces
    the seeded draws (tests)."""
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="mode", required=True)

    ps = sub.add_parser("synthesis")
    ps.add_argument("--model-path", required=True)
    ps.add_argument("--config-path", required=True)
    ps.add_argument("--num-samples", type=int, default=8)
    ps.add_argument("--latent-type", choices=["random", "lerp", "slerp"], default="random")
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--out", default="demo_out/synthesis")
    ps.add_argument("--video", action="store_true",
                    help="also write an interpolation video (mp4 if cv2 is "
                         "importable, else GIF)")
    ps.add_argument("--video-fps", type=float, default=10.0)
    ps.add_argument("--view-zoom", type=float, default=None,
                    help="BEV camera distance in meters (1-120; reference "
                         "slider default 60). Omitting all three view flags "
                         "keeps the fixed top-down view")
    ps.add_argument("--view-yaw", type=float, default=None,
                    help="BEV camera yaw in degrees (-180..180, default -45)")
    ps.add_argument("--view-pitch", type=float, default=None,
                    help="BEV camera pitch in degrees (0..90, default 60)")
    ps.add_argument("--cmap", default="turbo",
                    help="colour map of the depth and confidence panels: turbo is "
                         "built in, any other matplotlib name needs matplotlib")
    ps.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ps.set_defaults(fn=synthesis)

    pi = sub.add_parser("inversion")
    pi.add_argument("--model-path", required=True)
    pi.add_argument("--config-path", required=True)
    pi.add_argument("--index", type=int, default=0)
    pi.add_argument("--corruption", default="none", choices=list(CORRUPTIONS))
    pi.add_argument("--distance", default="l1", help="comma-separated: l1,l2,chamfer")
    pi.add_argument("--num-code", type=int, default=1)
    pi.add_argument("--compose-layer", type=int, default=1)
    pi.add_argument("--num-step", type=int, default=1000)
    pi.add_argument("--seed", type=int, default=0)
    pi.add_argument("--out", default="demo_out/inversion")
    pi.add_argument("--view-zoom", type=float, default=None)
    pi.add_argument("--view-yaw", type=float, default=None)
    pi.add_argument("--view-pitch", type=float, default=None)
    pi.add_argument("--cmap", default="turbo")
    pi.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    pi.set_defaults(fn=inversion)

    args = parser.parse_args(argv)
    return args.fn(args, draws)


if __name__ == "__main__":
    main()
