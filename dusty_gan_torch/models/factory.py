"""Model factory keyed by the reference config schema
(``dusty_gan_tpu/models/factory.py``): ``cfg.model.gen.arch`` is
``"{masker}/{backbone}"``, masker in {none, dusty1, dusty2}, backbone
``dcgan_eqlr``; ``cfg.model.dis.arch`` is ``dcgan_eqlr``."""

from __future__ import annotations

from typing import Any

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
    if backbone_type.lower() != "dcgan_eqlr":
        raise NotImplementedError(backbone_type)
    backbone = Generator(
        in_ch=int(_get(gen, "in_ch")),
        out_ch=dict(_get(gen, "out_ch")),
        ch_base=int(_get(gen, "ch_base")),
        ch_max=int(_get(gen, "ch_max")),
        shape=tuple(_get(gen, "shape")),
        ring=bool(_get(model, "ring", True)),
    )
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
    if _get(dis, "arch").lower() != "dcgan_eqlr":
        raise NotImplementedError(_get(dis, "arch"))
    return Discriminator(
        in_ch=int(_get(dis, "in_ch")),
        ch_base=int(_get(dis, "ch_base")),
        ch_max=int(_get(dis, "ch_max")),
        shape=tuple(_get(dis, "shape")),
        ring=bool(_get(model, "ring", True)),
    )
