"""EXIF metadata without PIL.

reference behavior: sensor/bitmap.cc ExifFocalLength / ExifLatitude / ... —
FocalLength, FocalLengthIn35mmFilm, Make, Model and the GPS tags, for camera
initialization and spatial pair generation. colmap_tpu reads them through
PIL's ``getexif``; this module parses the TIFF structure itself, from a
JPEG's APP1 "Exif" segment or a PNG's eXIf chunk, and returns the same keys.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional

from colmap_tpu_torch.utils.image_io import PNG_SIGNATURE, png_chunks

_TAGS = {
    271: "make",  # Make
    272: "model",  # Model
    37386: "focal_length_mm",  # FocalLength
    41989: "focal_length_35mm",  # FocalLengthIn35mmFilm
}
_EXIF_IFD = 0x8769
_GPS_IFD = 34853
# TIFF field type -> (struct code, bytes per value).
_TYPES = {1: ("B", 1), 2: ("s", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8), 6: ("b", 1),
          7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8), 11: ("f", 4), 12: ("d", 8)}


def _read_ifd(tiff: bytes, offset: int, endian: str) -> Dict[int, object]:
    """Tag -> value of the IFD at ``offset``: a str for ASCII, a float for
    one rational, a tuple for several values, else a number."""
    out = {}
    if offset + 2 > len(tiff):
        return out
    (count,) = struct.unpack(endian + "H", tiff[offset:offset + 2])
    for k in range(count):
        entry = offset + 2 + 12 * k
        if entry + 12 > len(tiff):
            break
        tag, kind, n = struct.unpack(endian + "HHI", tiff[entry:entry + 8])
        if kind not in _TYPES:
            continue
        code, size = _TYPES[kind]
        nbytes = size * n
        if nbytes <= 4:
            raw = tiff[entry + 8:entry + 8 + nbytes]
        else:
            (ptr,) = struct.unpack(endian + "I", tiff[entry + 8:entry + 12])
            raw = tiff[ptr:ptr + nbytes]
        if len(raw) < nbytes:
            continue
        if kind == 2:
            out[tag] = raw.split(b"\x00", 1)[0].decode("latin-1")
            continue
        vals = struct.unpack(endian + code * n if code != "s" else f"{n}s", raw)
        if kind in (5, 10):
            vals = tuple(float("nan") if d == 0 else num / d
                         for num, d in zip(vals[0::2], vals[1::2]))
        out[tag] = vals[0] if len(vals) == 1 else tuple(vals)
    return out


def _parse_tiff(tiff: bytes) -> dict:
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return {}
    endian = "<" if tiff[:2] == b"II" else ">"
    (ifd0,) = struct.unpack(endian + "I", tiff[4:8])
    main = _read_ifd(tiff, ifd0, endian)
    sub = _read_ifd(tiff, main[_EXIF_IFD], endian) if isinstance(main.get(_EXIF_IFD), int) else {}
    gps = _read_ifd(tiff, main[_GPS_IFD], endian) if isinstance(main.get(_GPS_IFD), int) else {}
    out: dict = {}
    for tag, name in _TAGS.items():
        v = main.get(tag, sub.get(tag))
        if v is None:
            continue
        if name in ("make", "model"):
            out[name] = str(v).strip("\x00 ").strip()
        elif isinstance(v, (int, float)) and v:
            out[name] = float(v)

    def dms(values, ref, negative):
        if not isinstance(values, tuple) or len(values) < 3:
            return None
        val = values[0] + values[1] / 60.0 + values[2] / 3600.0
        return -val if ref == negative else val

    lat = dms(gps.get(2), gps.get(1, "N"), "S")
    if lat is not None:
        out["latitude"] = lat
    lon = dms(gps.get(4), gps.get(3, "E"), "W")
    if lon is not None:
        out["longitude"] = lon
    alt = gps.get(6)
    if isinstance(alt, float):
        out["altitude"] = -alt if gps.get(5, 0) == 1 else alt
    return out


def _jpeg_exif(data: bytes) -> Optional[bytes]:
    """The TIFF payload of a JPEG's APP1 Exif segment, or None."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker in (0xD9, 0xDA):  # end of image, start of scan
            return None
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        if marker == 0xE1 and data[pos + 4:pos + 10] == b"Exif\x00\x00":
            return data[pos + 10:pos + 2 + length]
        pos += 2 + length
    return None


def read_exif(path: str) -> dict:
    """Relevant EXIF fields of an image file -> dict (missing keys omitted).

    Keys: make, model, focal_length_mm, focal_length_35mm, latitude,
    longitude, altitude. An unreadable file or one without EXIF gives {}.
    """
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return {}
    tiff = None
    if data.startswith(b"\xff\xd8"):
        tiff = _jpeg_exif(data)
    elif data.startswith(PNG_SIGNATURE):
        try:
            tiff = next((p for kind, p in png_chunks(data, path) if kind == b"eXIf"), None)
        except ValueError:
            return {}
    elif data[:4] in (b"II*\x00", b"MM\x00*"):
        tiff = data
    if not tiff:
        return {}
    try:
        return _parse_tiff(tiff)
    except (struct.error, IndexError, KeyError):
        return {}
