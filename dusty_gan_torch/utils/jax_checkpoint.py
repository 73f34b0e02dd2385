"""Read the JAX package's native ``.ckpt`` without JAX.

The counterpart of the reading half of ``dusty_gan_tpu/train/checkpoint.py``
(``restore_checkpoint``) and of ``dusty_gan_tpu/utils/torch_export.py``
(``reference_checkpoint_dict``).  A ``.ckpt`` is
``flax.serialization.msgpack_serialize({"state": TrainState, "key": ...})``:
msgpack of the train state's state dict, with every array in flax's ext
types.  ``unpackb`` is a msgpack decoder of the port's own (JAX, flax and
the ``msgpack`` package stay out of the port); ``read_jax_checkpoint``
returns the tree as stored, with no template, so a run with ``lr`` decay
(whose optimizer state holds a schedule count beside Adam's) reads too;
``reference_checkpoint_from_jax`` turns it into the reference-format
``.pth`` dict the JAX package's ``export_pth`` writes, through the maps of
``utils/weights.py``.

The port's ``.pth`` reader and writer (``utils/weights.py``,
``train/checkpoint.py``) are the counterparts of the JAX package's
``utils/torch_import.py`` and of ``torch_export.py``'s writing half.
"""

from __future__ import annotations

import struct
from typing import Callable, Dict, Optional

import numpy as np
import torch

from dusty_gan_torch.utils.weights import (_f32, adam_state_dict,
                                          discriminator_state_dict,
                                          generator_state_dict)

# flax.serialization._MsgpackExtType
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED_MARKER = "__msgpack_chunked_array__"
STATE_KEYS = ("step", "params_G", "params_D", "params_G_ema", "opt_G", "opt_D", "pl_ema")

_SCALARS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
            0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_WIDTH = (">B", ">H", ">I")  # the length field of the 8/16/32 variants
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, data: bytes, ext_hook: Callable):
        self.buf, self.pos, self.ext_hook = memoryview(data), 0, ext_hook

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends inside an object")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def scalar(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def items(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def mapping(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        if CHUNKED_MARKER in out:
            raise ValueError(f"a chunked array leaf ({CHUNKED_MARKER!r}, flax's form of "
                             "a leaf above 2**30 bytes) is not supported")
        return out

    def ext(self, code: int, n: int):
        return self.ext_hook(code, bytes(self.take(n)))

    def obj(self):
        b = self.scalar(">B")
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if b <= 0x8f:
            return self.mapping(b & 0x0f)
        if b <= 0x9f:
            return self.items(b & 0x0f)
        if b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _SCALARS:
            return self.scalar(_SCALARS[b])
        if 0xc4 <= b <= 0xc6:
            return bytes(self.take(self.scalar(_WIDTH[b - 0xc4])))
        if 0xc7 <= b <= 0xc9:
            n = self.scalar(_WIDTH[b - 0xc7])
            return self.ext(self.scalar(">b"), n)
        if b in _FIXEXT:
            return self.ext(self.scalar(">b"), _FIXEXT[b])
        if 0xd9 <= b <= 0xdb:
            return str(self.take(self.scalar(_WIDTH[b - 0xd9])), "utf-8")
        if b in (0xdc, 0xdd):
            return self.items(self.scalar(_WIDTH[b - 0xdb]))
        if b in (0xde, 0xdf):
            return self.mapping(self.scalar(_WIDTH[b - 0xdd]))
        raise ValueError(f"msgpack type byte 0x{b:02x} at offset {self.pos - 1} is not valid")


def _ndarray(data: bytes) -> np.ndarray:
    """flax's ndarray payload: msgpack ``(shape, dtype name, C-order bytes)``."""
    shape, dtype, buf = unpackb(data, ext_hook=None)
    if dtype == "bfloat16":  # numpy has no bfloat16: widen it exactly
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(dtype)).reshape(shape).copy()


def flax_ext(code: int, data: bytes):
    """flax's ext types (``flax.serialization._msgpack_ext_unpack``)."""
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_NPSCALAR:
        return _ndarray(data)[()]
    if code == EXT_COMPLEX:
        re, im = unpackb(data, ext_hook=None)
        return complex(re, im)
    raise ValueError(f"msgpack ext type {code} is not one flax writes")


def _no_ext(code: int, data: bytes):
    raise ValueError(f"msgpack ext type {code} inside an ext payload")


def unpackb(data: bytes, ext_hook: Optional[Callable] = flax_ext):
    """Decode one msgpack object (``msgpack.unpackb(data, ext_hook=...)`` with
    ``raw=False``): maps to dicts, arrays to lists, str, bin to bytes, nil,
    bool, the int/uint and float32/64 tags, ext (fixext 1-16, ext 8/16/32)
    through ``ext_hook(code, payload)``, flax's ext types by default."""
    r = _Reader(data, ext_hook or _no_ext)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack object")
    return out


def read_jax_checkpoint(path: str) -> Dict:
    """The payload of a JAX ``.ckpt``: ``{"state": {step, params_G, params_D,
    params_G_ema, opt_G, opt_D, pl_ema}, "key": uint32 array or None}``,
    nested dicts of numpy arrays as stored (tuples as ``{"0": ..., "1": ...}``)."""
    with open(path, "rb") as f:
        payload = unpackb(f.read())
    state = payload.get("state") if isinstance(payload, dict) else None
    missing = [k for k in STATE_KEYS if k not in (state or {})]
    if missing:
        raise ValueError(f"{path}: not a JAX train-state checkpoint (no {missing} "
                         "under 'state')")
    return payload


def adam_entry(opt_state: Dict, name: str):
    """(count, mu, nu) of the optax Adam state in a stored optimizer tree:
    the chain's entry with ``count``, ``mu`` and ``nu`` (``"0"``; a schedule's
    count, under ``lr`` decay, sits beside it)."""
    for entry in opt_state.values():
        if isinstance(entry, dict) and {"count", "mu", "nu"} <= set(entry):
            return int(entry["count"]), entry["mu"], entry["nu"]
    raise ValueError(f"{name} has no Adam state {{count, mu, nu}} "
                     f"(entries: {sorted(opt_state)})")


def param_names(model_sd: Dict) -> list:
    """``named_parameters()`` order from a reference state dict: its entries
    without the buffers (DUSty's ``drop_const``, D's blur ``kernel``s), in
    registration order."""
    return [k for k in model_sd if not k.endswith(("drop_const", "kernel"))]


def _optimizer(opt_state: Dict, name: str, model_sd: Dict, to_sd: Callable,
               lr: float, solver_lr) -> Dict:
    count, mu, nu = adam_entry(opt_state, name)
    return adam_state_dict(param_names(model_sd), to_sd(mu), to_sd(nu), count, lr,
                           (float(solver_lr.beta1), float(solver_lr.beta2)))


def reference_checkpoint_from_jax(payload: Dict, cfg) -> Dict:
    """The reference-format checkpoint dict of a JAX ``.ckpt`` payload, as
    ``dusty_gan_tpu.utils.torch_export.reference_checkpoint_dict`` builds it
    and ``save_reference_checkpoint`` saves it: ``{step, G, D, G_ema, optim_G,
    optim_D, pl_ema}`` (``pl_ema`` None when ``solver.loss.pl`` is 0).  The
    JAX root ``key`` has no counterpart in the port's run ``seed``; like the
    JAX package's export, the dict carries none, so a run resumed from it
    takes ``cfg.seed``."""
    st = payload["state"]
    arch, drop_const = str(cfg.model.gen.arch), float(cfg.model.gen.drop_const)
    gen = lambda tree: generator_state_dict(tree, arch, drop_const)  # noqa: E731
    g_sd, d_sd = gen(st["params_G"]), discriminator_state_dict(st["params_D"])
    lr = cfg.solver.lr
    pl_weight = float(cfg.solver.loss.pl) if "loss" in cfg.solver else 0.0
    return {
        "step": int(st["step"]),
        "G": g_sd,
        "D": d_sd,
        "G_ema": gen(st["params_G_ema"]),
        "optim_G": _optimizer(st["opt_G"], "opt_G", g_sd, gen, float(lr.alpha.gen), lr),
        "optim_D": _optimizer(st["opt_D"], "opt_D", d_sd, discriminator_state_dict,
                              float(lr.alpha.dis), lr),
        "pl_ema": _f32(st["pl_ema"]).reshape(()) if pl_weight else None,
    }


def load_checkpoint_dict(path: str, cfg) -> Dict:
    """A reference-format checkpoint dict from a ``.pth`` or a JAX ``.ckpt``."""
    if path.endswith(".ckpt"):
        return reference_checkpoint_from_jax(read_jax_checkpoint(path), cfg)
    return torch.load(path, map_location="cpu", weights_only=True)
