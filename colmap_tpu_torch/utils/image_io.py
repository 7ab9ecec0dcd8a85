"""Image files without PIL: PNG (zlib + struct), PGM and PPM.

colmap_tpu reads every image through PIL (``Image.open(path).convert("L")``)
and writes its rendered views with it. The port reads and writes PNG, PGM
and PPM itself, so it runs where PIL is not installed:

- ``read_png``: bit depths 1, 2, 4, 8 and 16; gray, gray + alpha, RGB, RGBA
  and palette; the five row filters; Adam7 interlacing. Samples keep PIL's
  8-bit view of the file: 16-bit color and alpha channels keep their high
  byte, 16-bit gray stays 16-bit (PIL's mode "I;16").
- ``to_gray``: PIL's ``convert("L")``, (19595 R + 38470 G + 7471 B +
  0x8000) >> 16 on 8-bit samples; alpha is dropped, a palette is looked up
  first, 16-bit gray is clipped to 255.
- ``write_png``: 8-bit gray, gray + alpha, RGB or RGBA PNG
  (``write_png_gray`` for gray); ``write_pnm``: binary PGM or PPM.
- ``read_image_gray``: any of the above by its signature; another format
  (JPEG, TIFF, BMP) goes through PIL where PIL is importable and raises an
  error naming the file and the format where it is not.
- ``read_image``: the samples of an 8-bit file as ``np.asarray`` of PIL's
  ``Image.open(path)`` gives them: (H, W) gray, (H, W, C) otherwise.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG color type -> samples per pixel
# Adam7 passes: (row start, column start, row step, column step).
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
          (1, 0, 2, 1))


def png_chunks(data: bytes, path: str = "<bytes>"):
    """(type, payload) of every chunk of a PNG file's bytes, IEND excluded."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        if len(payload) != length:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        pos += 12 + length
        if kind == b"IEND":
            return
        yield kind, payload
    raise ValueError(f"{path}: no IEND chunk")


def _paeth_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _average_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF


def _unfilter(raw: bytes, pos: int, height: int, stride: int, bpp: int, path: str):
    """Undo the row filters of ``height`` rows of ``stride`` bytes starting
    at raw[pos]; returns ((height, stride) uint8, the position after)."""
    out = np.zeros((height, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(height):
        if pos + 1 + stride > len(raw):
            raise ValueError(f"{path}: image data ends early")
        kind = raw[pos]
        line = np.frombuffer(raw, dtype=np.uint8, count=stride, offset=pos + 1)
        pos += 1 + stride
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum along each byte lane of the pixel
            lanes = line.reshape(-1, bpp) if stride % bpp == 0 else None
            if lanes is not None:
                cur = (np.cumsum(lanes, axis=0, dtype=np.uint64) & 0xFF).astype(np.uint8).reshape(-1)
            else:
                buf = bytearray(line.tobytes())
                for i in range(bpp, stride):
                    buf[i] = (buf[i] + buf[i - bpp]) & 0xFF
                cur = np.frombuffer(bytes(buf), dtype=np.uint8)
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):  # Average, Paeth: sequential along the row
            buf = bytearray(line.tobytes())
            (_average_row if kind == 3 else _paeth_row)(buf, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), dtype=np.uint8)
        else:
            raise ValueError(f"{path}: unknown PNG row filter {kind}")
        out[y] = cur
        prev = out[y]
    return out, pos


def _samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """(h, stride) unfiltered bytes -> (h, width, channels) samples."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :width * channels].reshape(h, width, channels)
    if depth == 16:
        return rows[:, :width * channels * 2].view(">u2").reshape(h, width, channels).astype(np.uint16)
    bits = np.unpackbits(rows, axis=1)[:, :width * depth].reshape(h, width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[..., None]


def read_png(path: str):
    """Decode a PNG file: (samples (H, W, C), color type, bit depth, palette
    (N, 3) uint8 or None, eXIf payload or None)."""
    with open(path, "rb") as f:
        data = f.read()
    header, palette, exif, idat = None, None, None, []
    for kind, payload in png_chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, dtype=np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"eXIf":
            exif = payload
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"{path}: unsupported PNG color type {color} at bit depth {depth}")
    if color == 3 and palette is None:
        raise ValueError(f"{path}: palette image without PLTE")
    channels = _CHANNELS[color]
    bpp = max(1, channels * depth // 8)
    raw = zlib.decompress(b"".join(idat))
    if interlace == 0:
        rows, _ = _unfilter(raw, 0, height, (width * channels * depth + 7) // 8, bpp, path)
        img = _samples(rows, width, channels, depth)
    elif interlace == 1:
        img = np.zeros((height, width, channels), dtype=np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for y0, x0, dy, dx in _ADAM7:
            h = (height - y0 + dy - 1) // dy if height > y0 else 0
            w = (width - x0 + dx - 1) // dx if width > x0 else 0
            if h == 0 or w == 0:
                continue
            rows, pos = _unfilter(raw, pos, h, (w * channels * depth + 7) // 8, bpp, path)
            img[y0::dy, x0::dx] = _samples(rows, w, channels, depth)
    else:
        raise ValueError(f"{path}: unknown PNG interlace method {interlace}")
    return img, color, depth, palette, exif


def to_gray(img: np.ndarray, color: int, depth: int, palette: Optional[np.ndarray]) -> np.ndarray:
    """PIL's convert("L") of decoded PNG samples: (H, W) uint8."""
    if color == 3:
        idx = img[..., 0].astype(np.int64)
        img = palette[np.minimum(idx, len(palette) - 1)]
        color = 2
    elif depth == 16:
        if color == 0:  # PIL opens 16-bit gray as "I;16"; "L" clips it
            return np.minimum(img[..., 0], 255).astype(np.uint8)
        img = (img >> 8).astype(np.uint8)  # PIL keeps the high byte of 16-bit color
    elif depth < 8 and color == 0:  # 1/2/4-bit gray scales to 0..255
        img = (img.astype(np.uint32) * 255 // ((1 << depth) - 1)).astype(np.uint8)
    if color in (0, 4):
        return np.ascontiguousarray(img[..., 0])
    rgb = img[..., :3].astype(np.uint32)
    return ((19595 * rgb[..., 0] + 38470 * rgb[..., 1] + 7471 * rgb[..., 2] + 0x8000)
            >> 16).astype(np.uint8)


_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # samples per pixel -> PNG color type


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """Write (H, W) uint8 as 8-bit gray, or (H, W, C) uint8 with C = 1, 2,
    3, 4 as gray, gray + alpha, RGB or RGBA PNG (filter None)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"{path}: write_png takes (H, W) or (H, W, 1-4), got {img.shape}")
    h, w, c = img.shape
    raw = np.zeros((h, w * c + 1), dtype=np.uint8)
    raw[:, 1:] = img.reshape(h, w * c)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), level)))
        f.write(chunk(b"IEND", b""))


def write_png_gray(path: str, img: np.ndarray, level: int = 6) -> None:
    """Write an (H, W) uint8 array as an 8-bit gray PNG (filter None)."""
    if np.ndim(img) != 2:
        raise ValueError(f"{path}: write_png_gray takes an (H, W) array, got {np.shape(img)}")
    write_png(path, img, level)


def _pnm_tokens(data: bytes, count: int, path: str) -> Tuple[list, int]:
    """The first ``count`` header tokens of a PNM file and the offset of the
    byte after the whitespace that ends the last one."""
    tokens, pos = [], 0
    while len(tokens) < count:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos] not in b"\r\n":
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        if start == pos:
            raise ValueError(f"{path}: truncated PNM header")
        tokens.append(data[start:pos])
    return tokens, pos + 1


def read_pnm_gray(path: str) -> np.ndarray:
    """Binary PGM (P5) or PPM (P6) -> (H, W) uint8 as PIL's convert("L")."""
    with open(path, "rb") as f:
        data = f.read()
    (magic, w, h, maxval), pos = _pnm_tokens(data, 4, path)
    w, h, maxval = int(w), int(h), int(maxval)
    channels = {b"P5": 1, b"P6": 3}.get(magic)
    if channels is None:
        raise ValueError(f"{path}: PNM type {magic.decode(errors='replace')} is not supported "
                         f"(binary P5 and P6 are)")
    dtype = np.dtype(">u2") if maxval > 255 else np.uint8
    n = w * h * channels
    img = np.frombuffer(data, dtype=dtype, count=n, offset=pos).reshape(h, w, channels)
    if maxval > 255:  # PIL opens 16-bit PGM as "I" and clips it into "L"
        if channels == 3:
            img = (img.astype(np.uint32) * 255 // maxval).astype(np.uint8)
        else:
            return np.minimum(img[..., 0], 255).astype(np.uint8)
    elif maxval != 255:
        img = (img.astype(np.uint32) * 255 // maxval).astype(np.uint8)
    return to_gray(img, 0 if channels == 1 else 2, 8, None)


def write_pnm(path: str, img: np.ndarray) -> None:
    """Write (H, W) uint8 as binary PGM or (H, W, 3) uint8 as binary PPM."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    magic = {2: b"P5", 3: b"P6"}[img.ndim]
    with open(path, "wb") as f:
        f.write(magic + b"\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(img.tobytes())


def image_format(path: str) -> str:
    """"png", "pnm", "jpeg", "tiff", "bmp" or "unknown", from the file's first bytes."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head.startswith(PNG_SIGNATURE):
        return "png"
    if head[:2] in (b"P5", b"P6"):
        return "pnm"
    if head.startswith(b"\xff\xd8"):
        return "jpeg"
    if head[:4] in (b"II*\x00", b"MM\x00*"):
        return "tiff"
    if head.startswith(b"BM"):
        return "bmp"
    return "unknown"


def read_image_gray(path: str) -> np.ndarray:
    """An image file as (H, W) uint8, as PIL's Image.open(path).convert("L")."""
    fmt = image_format(path)
    if fmt == "png":
        img, color, depth, palette, _ = read_png(path)
        return to_gray(img, color, depth, palette)
    if fmt == "pnm":
        return read_pnm_gray(path)
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(
            f"{os.fspath(path)}: {fmt} images need PIL, which is not installed "
            f"(PNG, PGM and PPM are read without it)") from None
    with Image.open(path) as im:
        return np.asarray(im.convert("L"), dtype=np.uint8)


def read_image(path: str) -> np.ndarray:
    """An 8-bit image file as ``np.asarray(PIL.Image.open(path))``: (H, W)
    uint8 gray, (H, W, 2) gray + alpha, (H, W, 3) RGB or (H, W, 4) RGBA.
    PNG (8-bit, not palette), PGM and PPM are read without PIL; other
    formats go through PIL where it is installed."""
    fmt = image_format(path)
    if fmt == "png":
        img, color, depth, _, _ = read_png(path)
        if depth != 8 or color == 3:
            raise ValueError(f"{path}: read_image takes 8-bit non-palette PNG "
                             f"(color type {color}, depth {depth})")
        return img[..., 0].copy() if img.shape[2] == 1 else img
    if fmt == "pnm":
        with open(path, "rb") as f:
            data = f.read()
        (magic, w, h, maxval), pos = _pnm_tokens(data, 4, path)
        channels = {b"P5": 1, b"P6": 3}.get(magic)
        if channels is None or int(maxval) != 255:
            raise ValueError(f"{path}: read_image takes 8-bit binary PGM or PPM")
        img = np.frombuffer(data, dtype=np.uint8, count=int(w) * int(h) * channels,
                            offset=pos).reshape(int(h), int(w), channels)
        return img[..., 0].copy() if channels == 1 else img.copy()
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(
            f"{os.fspath(path)}: {fmt} images need PIL, which is not installed "
            f"(PNG, PGM and PPM are read without it)") from None
    with Image.open(path) as im:
        return np.asarray(im)


def to_rgb(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 of an 8-bit image as ``read_image`` gives it, as PIL's
    ``convert("RGB")``: gray repeated, alpha dropped."""
    img = np.asarray(img, dtype=np.uint8)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    if img.shape[2] in (1, 2):
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def write_image(path: str, img: np.ndarray) -> None:
    """Write a uint8 image by the file's extension: PNG, PGM or PPM by this
    module; another format (JPEG, TIFF, BMP) through PIL, as colmap_tpu's
    ``Image.fromarray(img).save(path)``, where PIL is installed."""
    img = np.asarray(img, dtype=np.uint8)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        write_png(path, img)
    elif ext in (".pgm", ".ppm"):
        write_pnm(path, img)
    else:
        try:
            from PIL import Image
        except ImportError:
            raise ValueError(f"{path}: writing {ext} images needs PIL, which is not installed "
                             "(PNG, PGM and PPM are written without it)") from None
        Image.fromarray(img).save(path)
