"""Image IO without OpenCV: a PNG encoder / decoder on zlib, the JET
colormap on NumPy, image files and a PLY writer.

Counterpart of the parts of ``perf_tpu/utils/io.py`` and
``perf_tpu/app/serve.py:35-41`` that serving and training need; the GPU
machine has no ``cv2``. ``png_bytes`` writes 8-bit RGB with filter 0 on every row;
``decode_png`` reads exactly that form. ``colorize_single_channel_image``
reproduces ``cv2.applyColorMap(..., COLORMAP_JET)`` entry for entry.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def png_bytes(img_u8: np.ndarray) -> bytes:
    """Encode [H, W, 3] uint8 RGB as PNG."""
    img = np.ascontiguousarray(img_u8, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got {img.shape}")
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_PNG_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """Decode an 8-bit RGB, non-interlaced PNG whose rows all use filter 0
    (what ``png_bytes`` writes) -> [H, W, 3] uint8."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None or hdr[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"unsupported PNG header {hdr}")
    w, h = hdr[0], hdr[1]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + 3 * w)
    if np.any(raw[:, 0] != 0):
        raise ValueError("only filter type 0 is supported")
    return raw[:, 1:].reshape(h, w, 3).copy()


def _jet_lut() -> np.ndarray:
    """256-entry uint8 RGB LUT of the JET ramps clip(1.5 - |4x - k|, 0, 1)
    (k = 3, 2, 1 for r, g, b; x = i / 255), evaluated in float64, stored as
    float32, scaled by 255 and rounded half to even, as OpenCV's table."""
    x = np.arange(256) / 255.0
    ramps = [np.clip(1.5 - np.abs(4.0 * x - k), 0.0, 1.0) for k in (3, 2, 1)]
    lut = np.stack(ramps, axis=-1).astype(np.float32) * np.float32(255.0)
    lut = np.rint(lut).astype(np.uint8)
    # OpenCV stores blue at 159 a hair below the 1.5 / 255 tie: it rounds down
    lut[159, 2] = 1
    return lut


_JET = None


def colorize_single_channel_image(img) -> np.ndarray:
    """Normalize to [0, 1] and apply the JET colormap -> float RGB [0, 1]."""
    global _JET
    if _JET is None:
        _JET = _jet_lut()
    img = np.asarray(img).squeeze().astype(np.float32)
    lo, hi = float(img.min()), float(img.max())
    img = (img - lo) / max(hi - lo, 1e-9)
    u8 = (img * 255.0).astype(np.uint8)
    return _JET[u8].astype(np.float32) / 255.0


def read_image(path: str) -> np.ndarray:
    """PNG file -> float32 RGB [H, W, 3] in [0, 1] (``read_image``); the
    file must be in the form ``decode_png`` reads."""
    with open(path, "rb") as f:
        return decode_png(f.read()).astype(np.float32) / 255.0


def write_image(path: str, img) -> None:
    """Write [H, W], [H, W, 1] or [H, W, 3] as a PNG (``write_image``):
    float images with max <= 1 are scaled by 255, then clipped and cast
    to uint8."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    if img.dtype != np.uint8:
        if img.max() <= 1.0 + 1e-6:
            img = img * 255.0
        img = np.clip(img, 0, 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png_bytes(img))


def write_ply(path: str, pts: np.ndarray, colors: np.ndarray | None = None):
    """Binary little-endian PLY point cloud (``write_ply``)."""
    pts = np.asarray(pts, np.float32).reshape(-1, 3)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = len(pts)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if colors is not None:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
        colors = np.asarray(colors).reshape(-1, 3)
        if colors.dtype != np.uint8:
            colors = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if colors is not None:
            rec = np.zeros(n, dtype=[("xyz", np.float32, 3),
                                     ("rgb", np.uint8, 3)])
            rec["xyz"] = pts
            rec["rgb"] = colors
            rec.tofile(f)
        else:
            pts.tofile(f)


def write_video(path: str, frames, fps: int = 30) -> bool:
    """mp4 of uint8 RGB frames through ``imageio`` or ``cv2``, whichever
    imports and writes; returns False, writing nothing, when neither can
    (the frames stay as PNGs beside it)."""
    frames = [np.asarray(f) for f in frames]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        import imageio
        with imageio.get_writer(path, fps=fps) as w:
            for f in frames:
                w.append_data(f)
        return True
    except Exception:
        if os.path.exists(path):
            os.remove(path)
    try:
        import cv2
    except ImportError:
        return False
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not vw.isOpened():
        return False
    for f in frames:
        vw.write(np.ascontiguousarray(f[..., ::-1]))
    vw.release()
    return True
