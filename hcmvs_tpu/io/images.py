"""Image loading, grayscale conversion, resizing and pyramids.

Host-side analog of the reference's image layer (ref: frame_main/libs/IO/
Image*.cpp codecs behind CImage, and libs/MVS/Image.cpp ReloadImage /
RecomputeMaxResolution).  PNG (8/16-bit gray, gray+alpha, RGB, RGBA and
8-bit palette, non-interlaced) and ``.npy`` are read and written here with
stdlib ``zlib`` and numpy, so the main path needs no OpenCV; other formats
(JPEG, TIFF, ...) go through OpenCV when it is installed.  Everything after
decode is numpy arrays laid out (H, W[, C]) float32 in [0, 1], the layout
the device kernels use.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Tuple

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# channels per PNG color type: gray, RGB, palette, gray+alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 or uint16 (H, W), (H, W, 3) or (H, W, 4) array
    (channels in RGB[A] order) as a non-interlaced PNG."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG needs uint8 or uint16 data, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    depth = 8 * img.dtype.itemsize
    rows = img.astype(img.dtype.newbyteorder(">")).reshape(h, -1).view(
        np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIG + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters -> (H, stride) uint8."""
    buf = np.frombuffer(data, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = buf[y, 0], buf[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:    # Sub: running sum per channel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint64).astype(np.uint8).reshape(-1)
        elif ftype == 2:    # Up
            cur = line + prev
        elif ftype in (3, 4):   # Average / Paeth: sequential along the row
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                    continue
                c = up[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a non-interlaced PNG to uint8/uint16 (H, W) or (H, W, C),
    channels in file order (gray[+alpha] or RGB[A]; palettes expand to
    RGB[A])."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, palette, trns = 8, [], None, None
    while pos < len(blob):
        n, tag = struct.unpack(">I4s", blob[pos:pos + 8])
        data = blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(
                ">IIBBBBB", data)
        elif tag == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(data, np.uint8)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if depth not in (8, 16) or ctype not in _PNG_CHANNELS:
        raise ValueError(f"{path}: unsupported PNG bit depth {depth} / "
                         f"color type {ctype}")
    c = _PNG_CHANNELS[ctype]
    bpp = c * depth // 8
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 16:
        px = px.view(">u2").astype(np.uint16)
    img = px.reshape(h, w, c)
    if ctype == 3:
        lut = palette
        if trns is not None:
            alpha = np.full(len(palette), 255, np.uint8)
            alpha[:len(trns)] = trns
            lut = np.concatenate([palette, alpha[:, None]], axis=1)
        img = lut[img[..., 0]]
    return img[..., 0] if img.shape[-1] == 1 else img


def _read_with_cv2(path: str) -> np.ndarray:
    """Formats other than PNG/NPY: OpenCV, channels returned RGB[A]."""
    ext = os.path.splitext(path)[1].lower() or "(no extension)"
    try:
        import cv2
    except ImportError:
        raise RuntimeError(
            f"{path}: reading {ext} images needs OpenCV (pip install "
            f"'hcmvs-tpu[io]'); PNG and .npy are read without it") from None
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]   # BGR[A] -> RGB[A]
    return img


def read_image_raw(path: str) -> np.ndarray:
    """Decode any supported image file to its stored dtype/channels."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        return read_png(path)
    if ext == ".npy":
        return np.load(path)
    return _read_with_cv2(path)


def _gray_u8(rgb: np.ndarray) -> np.ndarray:
    """BT.601 luma in libpng's 15-bit fixed point, the conversion behind
    OpenCV's IMREAD_GRAYSCALE for PNG (agrees to within 1/255)."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    return ((r * 9797 + g * 19235 + b * 3736) >> 15).astype(np.uint8)


def load_image(path: str, gray: bool = False) -> np.ndarray:
    """Load an image as float32 in [0, 1]; RGB (H, W, 3) or gray (H, W).

    8-bit gray conversion follows OpenCV's IMREAD_GRAYSCALE; alpha
    channels are dropped.  ``.npy`` files hold float images already in
    [0, 1] (or uint8/uint16 integers)."""
    raw = read_image_raw(path)
    if raw.dtype == np.uint8:
        scale = 255.0
    elif raw.dtype == np.uint16:
        scale = 65535.0
    else:
        scale = 1.0
    if raw.ndim == 3:
        raw = raw[..., :3] if raw.shape[2] >= 3 else raw[..., :1]
    if gray:
        if raw.ndim == 3 and raw.shape[2] == 3:
            raw = (_gray_u8(raw) if raw.dtype == np.uint8
                   else to_gray(raw.astype(np.float32)))
        elif raw.ndim == 3:
            raw = raw[..., 0]
    elif raw.ndim == 2 or raw.shape[2] == 1:
        raw = np.repeat(raw.reshape(raw.shape[:2] + (1,)), 3, axis=2)
    return raw.astype(np.float32) / scale


def to_gray(img: np.ndarray) -> np.ndarray:
    """RGB (H, W, 3) -> gray (H, W) with the BT.601 weights cv2 uses."""
    if img.ndim == 2:
        return img
    return (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2]).astype(img.dtype)


def compute_resolution_scale(width: int, height: int, resolution_level: int,
                             max_resolution: int, min_resolution: int
                             ) -> float:
    """Scale factor for a resolution level, matching the reference rule.

    Ref: frame_main/libs/MVS/Image.cpp RecomputeMaxResolution — halve the
    max dimension `resolution_level` times, clamp into
    [min_resolution, max_resolution], and return the resulting scale.
    """
    max_dim = max(width, height)
    target = max_dim >> resolution_level
    if max_resolution > 0:
        target = min(target, max_resolution)
    if min_resolution > 0:
        target = max(target, min(min_resolution, max_dim))
    return target / max_dim


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) box-overlap weights: output pixel i averages source
    interval [i*r, (i+1)*r), r = n_in / n_out (OpenCV INTER_AREA)."""
    r = n_in / n_out
    lo = np.arange(n_out)[:, None] * r
    src = np.arange(n_in)[None, :]
    overlap = (np.minimum(lo + r, src + 1) - np.maximum(lo, src))
    return np.clip(overlap, 0.0, None) / r


def _linear_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) half-pixel-centred linear weights with edge clamping
    (OpenCV INTER_LINEAR)."""
    x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    x0 = np.floor(x).astype(np.int64)
    t = x - x0
    wts = np.zeros((n_out, n_in))
    rows = np.arange(n_out)
    np.add.at(wts, (rows, np.clip(x0, 0, n_in - 1)), 1.0 - t)
    np.add.at(wts, (rows, np.clip(x0 + 1, 0, n_in - 1)), t)
    return wts


def resize_to(img: np.ndarray, new_h: int, new_w: int,
              area: bool = False) -> np.ndarray:
    """Resize (H, W[, C]) to (new_h, new_w) with separable weight
    matrices: box-area averaging (OpenCV INTER_AREA) or half-pixel linear
    (INTER_LINEAR).  Integer images are rounded back to their dtype."""
    h, w = img.shape[:2]
    weights = _area_weights if area else _linear_weights
    x = np.tensordot(weights(h, new_h), img.astype(np.float64), axes=(1, 0))
    x = np.moveaxis(np.tensordot(weights(w, new_w), x, axes=(1, 1)), 0, 1)
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        x = np.clip(np.round(x), info.min, info.max)
    return x.astype(img.dtype)


def resize_image(img: np.ndarray, scale: float) -> np.ndarray:
    """Resize by ``scale``: area averaging when shrinking, linear when
    enlarging — the reference's OpenCV INTER_AREA / INTER_LINEAR choice."""
    if scale == 1.0:
        return img
    h, w = img.shape[:2]
    return resize_to(img, max(1, round(h * scale)), max(1, round(w * scale)),
                     area=scale < 1.0)


def load_semantic_mask(path: str) -> np.ndarray:
    """Load a semantic-segmentation mask as an (H, W) int32 label map.

    The reference consumes per-image mask files named by Image::maskName
    (ref: frame_main/libs/MVS/Image.h:75-99, used by GenerateDepthPrior
    SceneDensify.cpp:1550-1950; the final hierarchy stage runs
    --use-semantic 1 — data/frame_main/resize1/run.py).  Accepted
    encodings: 8/16-bit single-channel label images, or color-coded masks
    (each distinct color becomes one label).
    """
    raw = read_image_raw(path)
    if raw.ndim == 2:
        return raw.astype(np.int32)
    # color-coded: map distinct colors to dense label ids (deterministic
    # by color value so every view of the same legend agrees; colors are
    # keyed in B, G, R[, A] order)
    raw = raw[..., [2, 1, 0, 3][:raw.shape[2]]] if raw.shape[2] >= 3 \
        else raw
    flat = raw.reshape(-1, raw.shape[2]).astype(np.int64)
    code = flat[:, 0]
    for c in range(1, raw.shape[2]):
        code = code * 256 + flat[:, c]
    _, labels = np.unique(code, return_inverse=True)
    return labels.reshape(raw.shape[:2]).astype(np.int32)


def resize_mask(mask: np.ndarray, shape_hw: Tuple[int, int]) -> np.ndarray:
    """Nearest-neighbor resize for label maps (labels must not blend;
    OpenCV INTER_NEAREST's floor(dst * in / out) source rule)."""
    h, w = shape_hw
    if mask.shape == (h, w):
        return mask
    ys = np.minimum((np.arange(h) * (mask.shape[0] / h)).astype(np.int64),
                    mask.shape[0] - 1)
    xs = np.minimum((np.arange(w) * (mask.shape[1] / w)).astype(np.int64),
                    mask.shape[1] - 1)
    return mask[ys[:, None], xs[None, :]].astype(np.int32)


def pyr_down(img: np.ndarray) -> np.ndarray:
    """Gaussian 5-tap [1 4 6 4 1]/16 blur (reflect-101 borders) then
    decimation by 2 — OpenCV pyrDown."""
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    x = img.astype(np.float64)
    h, w = x.shape[:2]
    extra = [(0, 0)] * (x.ndim - 2)
    xp = np.pad(x, [(2, 2), (0, 0)] + extra, mode="reflect")
    x = sum(k[i] * xp[i:i + h] for i in range(5))
    xp = np.pad(x, [(0, 0), (2, 2)] + extra, mode="reflect")
    x = sum(k[i] * xp[:, i:i + w] for i in range(5))
    return x[::2, ::2].astype(img.dtype)


def build_pyramid(img: np.ndarray, levels: int) -> List[np.ndarray]:
    """Half-resolution pyramid, level 0 = input."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def pad_to_multiple(img: np.ndarray, multiple: int,
                    value: float = 0.0) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Edge-pad H and W up to a multiple.

    Returns the padded image and the original (H, W) so outputs can be
    cropped back.
    """
    h, w = img.shape[:2]
    ph = (-h) % multiple
    pw = (-w) % multiple
    if ph == 0 and pw == 0:
        return img, (h, w)
    pad = [(0, ph), (0, pw)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pad, mode="edge"), (h, w)


def list_images(directory: str) -> List[str]:
    exts = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".ppm"}
    names = sorted(n for n in os.listdir(directory)
                   if os.path.splitext(n)[1].lower() in exts)
    return [os.path.join(directory, n) for n in names]


def jet_colormap(x: np.ndarray) -> np.ndarray:
    """Map values in [0, 1] to the classic jet colormap: (..., 3) uint8
    RGB (ref: the reference's debug exporters write jet-colored depth PNGs,
    DepthMap.cpp:2526 ExportDepthMap)."""
    x = np.clip(np.asarray(x, np.float64), 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def save_depth_png(path: str, depth: np.ndarray,
                   d_min: float = None, d_max: float = None) -> None:
    """Write a jet-colored depth visualization PNG (invalid = black) —
    the verbosity-gated debug artifact the reference dumps per stage."""
    valid = depth > 0
    if d_min is None:
        d_min = float(depth[valid].min()) if valid.any() else 0.0
    if d_max is None:
        d_max = float(depth[valid].max()) if valid.any() else 1.0
    x = (depth - d_min) / max(d_max - d_min, 1e-9)
    rgb = jet_colormap(x)
    rgb[~valid] = 0
    write_png(path, rgb)
