"""Image and video writers that need neither PIL nor cv2
(``dusty_gan_tpu/utils/video.py``, and the demo's PNG panels).

* ``write_png``: an 8-bit RGB PNG, or a paletted one given a palette
  (zlib and struct);
* ``write_gif``: an animated GIF89a over a fixed 256-colour palette, 3 bits
  of red, 3 of green and 2 of blue, each pixel taking the nearest entry.
  The LZW stream holds one literal code a pixel, 9 bits wide, with a clear
  code every ``GIF_CLEAR_EVERY`` codes, before the decoder's table would
  widen the codes;
* ``save_video``: an mp4 through cv2 when cv2 imports, as the JAX package
  writes it, else the GIF.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

GIF_LEVELS = (8, 8, 4)  # palette levels of red, green and blue
GIF_CLEAR_EVERY = 250  # literal codes between clear codes (the table stays below 512)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray, palette=None) -> None:
    """(H, W, 3) uint8 -> an RGB PNG; (H, W) uint8 indices with ``palette``
    (a sequence of RGB triples) -> a paletted PNG."""
    image = np.ascontiguousarray(image, np.uint8)
    h, w = image.shape[:2]
    if palette is None:
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(f"an RGB PNG needs (H, W, 3), got {image.shape}")
        header, extra = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0), b""
    else:
        if image.ndim != 2:
            raise ValueError(f"a paletted PNG needs (H, W) indices, got {image.shape}")
        header = struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0)
        extra = _png_chunk(b"PLTE", bytes(v for rgb in palette for v in rgb))
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, -1)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header) + extra
                + _png_chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + _png_chunk(b"IEND", b""))


def gif_palette() -> np.ndarray:
    """(256, 3) uint8: entry (r * 8 + g) * 4 + b holds the levels r, g, b
    spread evenly over 0..255."""
    r, g, b = np.meshgrid(*(np.arange(n) for n in GIF_LEVELS), indexing="ij")
    levels = [np.round(c * 255.0 / (n - 1)) for c, n in zip((r, g, b), GIF_LEVELS)]
    return np.stack(levels, axis=-1).reshape(-1, 3).astype(np.uint8)


def quantize(frame: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) palette indices of the nearest entries."""
    idx = [np.round(frame[..., c].astype(np.float32) * ((n - 1) / 255.0)).astype(np.int64)
           for c, n in enumerate(GIF_LEVELS)]
    return ((idx[0] * GIF_LEVELS[1] + idx[1]) * GIF_LEVELS[2] + idx[2]).astype(np.uint8)


def _lzw_literals(indices: np.ndarray) -> bytes:
    """A GIF LZW stream (minimum code size 8) of literal 9-bit codes,
    LSB first, in sub-blocks of at most 255 bytes."""
    clear, end = 256, 257
    flat = indices.reshape(-1).astype(np.uint16)
    n = len(flat)
    groups = -(-n // GIF_CLEAR_EVERY)
    codes = np.full(n + groups + 1, clear, np.uint16)
    pos = np.arange(n) + np.arange(n) // GIF_CLEAR_EVERY + 1  # one clear before each group
    codes[pos] = flat
    codes[-1] = end
    bits = ((codes[:, None] >> np.arange(9, dtype=np.uint16)) & 1).astype(np.uint8)
    data = np.packbits(bits.reshape(-1), bitorder="little").tobytes()
    blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                      for i in range(0, len(data), 255))
    return bytes([8]) + blocks + b"\x00"


def write_gif(path: str, frames, fps: float = 10.0) -> None:
    """Frames (H, W, 3) uint8 of one size -> an animated GIF that loops."""
    h, w, _ = frames[0].shape
    delay = max(1, int(round(100.0 / fps)))  # centiseconds
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), gif_palette().tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]
    for f in frames:
        if f.shape != (h, w, 3):
            raise ValueError(f"frame of shape {f.shape}, expected {(h, w, 3)}")
        out += [b"\x21\xf9\x04\x04" + struct.pack("<H", delay) + b"\x00\x00",
                b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0), _lzw_literals(quantize(f))]
    out.append(b"\x3b")
    with open(path, "wb") as fh:
        fh.write(b"".join(out))


def save_video(frames, filename: str, fps: float = 30.0) -> str:
    """frames: (H, W, 3) float [0, 1] or uint8 arrays -> ``filename.mp4``
    through cv2 where cv2 imports, else ``filename.gif``; returns the path."""
    frames8 = [np.asarray(np.clip(f, 0, 1) * 255, np.uint8) if np.asarray(f).dtype != np.uint8
               else np.asarray(f) for f in frames]
    try:
        import cv2
    except ImportError:
        write_gif(filename + ".gif", frames8, fps)
        return filename + ".gif"
    h, w, _ = frames8[0].shape
    writer = cv2.VideoWriter(filename + ".mp4", cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames8:
        writer.write(np.ascontiguousarray(f[..., ::-1]))
    writer.release()
    return filename + ".mp4"
