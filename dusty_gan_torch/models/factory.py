"""Model factory keyed by the reference config schema
(``dusty_gan_tpu/models/factory.py``): ``cfg.model.gen.arch`` is
``"{masker}/{backbone}"``, masker in {none, dusty1, dusty2}, backbone
``dcgan_eqlr`` or ``stylegan2`` (``models/stylegan2.py``, the port's own:
the JAX package has no StyleGAN2); ``cfg.model.dis.arch`` is
``dcgan_eqlr`` or ``stylegan2``."""

from __future__ import annotations

from typing import Any

from dusty_gan_torch.models import stylegan2
from dusty_gan_torch.models.dcgan_eqlr import Discriminator, Generator
from dusty_gan_torch.models.dusty import DUSty1, DUSty2


def _get(cfg: Any, key: str, default=None):
    if isinstance(cfg, dict):
        return cfg.get(key, default)
    return getattr(cfg, key, default)


def define_G(cfg):
    model = _get(cfg, "model", cfg)
    gen = _get(model, "gen")
    masker_type, backbone_type = _get(gen, "arch").split("/")
    if backbone_type.lower() == "stylegan2":
        backbone = stylegan2.Generator(
            z_dim=int(_get(gen, "in_ch")),
            w_dim=int(_get(gen, "w_dim")),
            mapping_layers=int(_get(gen, "mapping_layers")),
            mapping_lr_mul=float(_get(gen, "mapping_lr_mul")),
            channels=[int(c) for c in _get(gen, "channels")],
            out_ch=dict(_get(gen, "out_ch")),
            shape=tuple(_get(gen, "shape")),
        )
    elif backbone_type.lower() == "dcgan_eqlr":
        backbone = Generator(
            in_ch=int(_get(gen, "in_ch")),
            out_ch=dict(_get(gen, "out_ch")),
            ch_base=int(_get(gen, "ch_base")),
            ch_max=int(_get(gen, "ch_max")),
            shape=tuple(_get(gen, "shape")),
            ring=bool(_get(model, "ring", True)),
        )
    else:
        raise NotImplementedError(backbone_type)
    tau = _get(gen, "tau", 1.0)
    tau = None if tau in (None, "none", "None") else float(tau)
    drop_const = float(_get(gen, "drop_const", -1))
    if masker_type == "dusty1":
        return DUSty1(backbone, tau=tau, drop_const=drop_const)
    if masker_type == "dusty2":
        return DUSty2(backbone, tau=tau, drop_const=drop_const)
    if masker_type == "none":
        return backbone
    raise NotImplementedError(masker_type)


def define_D(cfg):
    model = _get(cfg, "model", cfg)
    dis = _get(model, "dis")
    arch = _get(dis, "arch").lower()
    if arch == "stylegan2":
        return stylegan2.Discriminator(
            in_ch=int(_get(dis, "in_ch")),
            channels=[int(c) for c in _get(dis, "channels")],
            fc_dim=int(_get(dis, "fc_dim")),
            mbstd_group=int(_get(dis, "mbstd_group")),
            mbstd_channels=int(_get(dis, "mbstd_channels")),
            shape=tuple(_get(dis, "shape")),
        )
    if arch != "dcgan_eqlr":
        raise NotImplementedError(_get(dis, "arch"))
    return Discriminator(
        in_ch=int(_get(dis, "in_ch")),
        ch_base=int(_get(dis, "ch_base")),
        ch_max=int(_get(dis, "ch_max")),
        shape=tuple(_get(dis, "shape")),
        ring=bool(_get(model, "ring", True)),
    )
