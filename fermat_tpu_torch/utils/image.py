"""Image I/O: TGA, PFM and Radiance HDR (fermat_tpu/utils/image.py:20-187).

The port's own numpy copy: uncompressed and RLE TGA, PFM, and RGBE .hdr
reading, with the TGA, PFM and .hdr writers. Other formats raise ValueError, as the
JAX package does where imageio is not installed.
"""
from __future__ import annotations

import os
import struct

import numpy as np


def write_tga(path: str, rgb: np.ndarray) -> None:
    """Write a uint8 RGB(A) image as uncompressed BGR(A) TGA, top-left origin;
    a float image is scaled by 255 and rounded."""
    img = np.asarray(rgb)
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    h, w = img.shape[:2]
    ch = img.shape[2] if img.ndim == 3 else 1
    if ch not in (3, 4):
        raise ValueError(f"TGA writer needs RGB(A), got {ch} channels")
    header = struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, w, h, 8 * ch, 0x20)
    bgr = img[..., [2, 1, 0] + ([3] if ch == 4 else [])]
    with open(path, "wb") as f:
        f.write(header)
        f.write(bgr.tobytes())


def read_tga(path: str) -> np.ndarray:
    """Type-2 (uncompressed true-color) and type-10 (RLE) TGA -> uint8 RGB(A)."""
    with open(path, "rb") as f:
        hdr = f.read(18)
        idlen, img_type = hdr[0], hdr[2]
        w, h = struct.unpack("<HH", hdr[12:16])
        bpp, desc = hdr[16], hdr[17]
        f.read(idlen)
        ch = bpp // 8
        if ch not in (3, 4):
            raise ValueError(f"{path}: unsupported TGA bpp {bpp}")
        n = w * h
        if img_type == 2:
            data = np.frombuffer(f.read(n * ch), np.uint8).reshape(h, w, ch).copy()
        elif img_type == 10:
            raw = f.read()
            out = np.empty((n, ch), np.uint8)
            i = o = 0
            while o < n:
                pk = raw[i]
                i += 1
                cnt = (pk & 0x7F) + 1
                if pk & 0x80:  # a run packet: one pixel repeated
                    out[o:o + cnt] = np.frombuffer(raw[i:i + ch], np.uint8)
                    i += ch
                else:  # a raw packet
                    out[o:o + cnt] = np.frombuffer(raw[i:i + cnt * ch], np.uint8).reshape(cnt, ch)
                    i += cnt * ch
                o += cnt
            data = out.reshape(h, w, ch)
        else:
            raise ValueError(f"{path}: unsupported TGA type {img_type}")
    if not desc & 0x20:  # bottom-left origin: flip
        data = data[::-1]
    return data[..., [2, 1, 0] + ([3] if ch == 4 else [])]


def write_pfm(path: str, img: np.ndarray) -> None:
    """Little-endian PFM, bottom-up rows ("PF" for RGB, "Pf" for one channel)."""
    img = np.asarray(img, np.float32)
    color = img.ndim == 3 and img.shape[2] == 3
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")
        f.write(img[::-1].tobytes())


def read_pfm(path: str) -> np.ndarray:
    """PFM -> float32 (H, W, 3) or (H, W), top row first."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic not in (b"PF", b"Pf"):
            raise ValueError(f"{path}: not a PFM")
        color = magic == b"PF"
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline())
        ch = 3 if color else 1
        data = np.frombuffer(f.read(w * h * ch * 4), np.float32)
    if scale > 0:  # big endian
        data = data.byteswap()
    img = data.reshape(h, w, ch) if color else data.reshape(h, w)
    return img[::-1].copy()


def write_hdr(path: str, img: np.ndarray) -> None:
    """Radiance RGBE .hdr: the shared-exponent 8+8+8+8 encoding, flat
    scanlines (image.py:107-125)."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    h, w = img.shape[:2]
    rgb = np.maximum(img[..., :3], 0.0)
    mx = rgb.max(-1)
    nz = mx >= 1e-32
    _m, ev = np.frexp(np.where(nz, mx, 1.0))
    scale = np.where(nz, np.ldexp(1.0, -ev) * 256.0, 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.minimum(rgb * scale[..., None], 255.0).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, ev + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def read_hdr(path: str) -> np.ndarray:
    """Radiance RGBE .hdr (flat and adaptive-RLE scanlines) -> float32 RGB."""
    with open(path, "rb") as f:
        if not f.readline().startswith(b"#?"):
            raise ValueError("not a Radiance HDR file")
        while f.readline() not in (b"\n", b"\r\n", b""):
            pass
        dims = f.readline().split()
        h, w = int(dims[1]), int(dims[3])
        data = f.read()
    rgbe = np.zeros((h, w, 4), np.uint8)
    pos = 0
    for y in range(h):
        if (len(data) - pos >= 4 and data[pos] == 2 and data[pos + 1] == 2
                and (data[pos + 2] << 8 | data[pos + 3]) == w):
            pos += 4  # adaptive RLE scanline: per-component runs
            for c in range(4):
                x = 0
                while x < w:
                    cnt = data[pos]
                    pos += 1
                    if cnt > 128:  # a run
                        rgbe[y, x:x + cnt - 128, c] = data[pos]
                        pos += 1
                        x += cnt - 128
                    else:  # literals
                        rgbe[y, x:x + cnt, c] = np.frombuffer(data, np.uint8, cnt, pos)
                        pos += cnt
                        x += cnt
        else:  # a flat scanline
            rgbe[y] = np.frombuffer(data, np.uint8, w * 4, pos).reshape(w, 4)
            pos += w * 4
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0)
    return (rgbe[..., :3].astype(np.float32) * scale[..., None]).astype(np.float32)


def read_image(path: str) -> np.ndarray:
    """A supported image -> float32 RGB: TGA in [0, 1], PFM and HDR as stored."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".tga":
        return read_tga(path)[..., :3].astype(np.float32) / 255.0
    if ext == ".pfm":
        img = read_pfm(path)
        return img if img.ndim == 3 else np.repeat(img[..., None], 3, -1)
    if ext == ".hdr":
        return read_hdr(path)
    raise ValueError(f"unsupported image format {ext} (TGA, PFM and HDR are read)")
