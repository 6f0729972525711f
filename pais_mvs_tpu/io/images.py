"""Input-image decoding for the NVM/MVS loaders.

Binary PGM/PPM (``P5``/``P6``, 8-bit) and ``.npy`` arrays are read with
numpy alone, so a reconstruction needs no imaging package. Other formats
(PNG, JPEG, ...) go through Pillow when it is installed.
"""

from __future__ import annotations

import os

import numpy as np

_PNM_CHANNELS = {b"P5": 1, b"P6": 3}


def _pnm_header(buf: bytes, path: str):
    """Parse the PNM header: (magic, width, height, maxval, data offset)."""
    tokens, pos = [], 0
    while len(tokens) < 4:
        while pos < len(buf) and buf[pos:pos + 1].isspace():
            pos += 1
        if buf[pos:pos + 1] == b"#":                  # comment to end of line
            while pos < len(buf) and buf[pos:pos + 1] not in (b"\n", b"\r"):
                pos += 1
            continue
        start = pos
        while pos < len(buf) and not buf[pos:pos + 1].isspace():
            pos += 1
        if start == pos:
            raise ValueError(f"{path}: truncated PNM header")
        tokens.append(buf[start:pos])
    magic = tokens[0]
    try:
        w, h, maxval = (int(t) for t in tokens[1:])
    except ValueError:
        raise ValueError(f"{path}: malformed PNM header") from None
    return magic, w, h, maxval, pos + 1               # one whitespace byte


def read_pnm(path: str) -> np.ndarray:
    """Binary 8-bit PGM (``P5``) or PPM (``P6``) -> uint8 [H, W] or
    [H, W, 3]."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, w, h, maxval, off = _pnm_header(buf, path)
    if magic not in _PNM_CHANNELS:
        raise ValueError(f"{path}: unsupported PNM type {magic!r} "
                         "(binary P5/P6 only)")
    if not 0 < maxval < 256:
        raise ValueError(f"{path}: maxval {maxval} unsupported (8-bit only)")
    ch = _PNM_CHANNELS[magic]
    n = w * h * ch
    if len(buf) - off < n:
        raise ValueError(f"{path}: PNM data truncated ({len(buf) - off} of "
                         f"{n} bytes)")
    img = np.frombuffer(buf, np.uint8, n, off)
    return img.reshape((h, w, ch) if ch == 3 else (h, w)).copy()


def write_pnm(path: str, img: np.ndarray) -> None:
    """uint8 [H, W] -> PGM, [H, W, 3] -> PPM (binary)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    magic = {2: b"P5", 3: b"P6"}[img.ndim]
    with open(path, "wb") as f:
        f.write(magic + b"\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(img.tobytes())


def read_image(path: str) -> np.ndarray:
    """Decode one input image to uint8 RGB [H, W, 3]."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".pgm", ".ppm", ".pnm"):
        img = read_pnm(path)
    elif ext == ".npy":
        img = np.load(path, allow_pickle=False)
    else:
        try:
            from PIL import Image
        except ImportError:
            raise RuntimeError(
                f"{path}: reading '{ext or 'extensionless'}' images needs "
                "Pillow, which is not installed; convert the images to "
                "binary PGM/PPM or .npy") from None
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or \
            (img.ndim == 3 and img.shape[2] not in (1, 3)):
        raise ValueError(f"{path}: expected uint8 [H, W] or [H, W, 3], got "
                         f"{img.dtype} {img.shape}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    return img
