"""Camera sensor-width database for EXIF focal-length estimation.

A copy of colmap_tpu/sensor/specs.py (pure Python), so that the port does
not import the JAX package.

reference behavior: src/colmap/sensor/specs.{h,cc} + sensor/database.* — a
(make, model) -> sensor width (mm) lookup used by the image reader to turn
an EXIF focal length in mm into pixels. The reference table has thousands
of entries; this one carries the most common sensor formats plus exact
entries for popular bodies, with the same normalized-key lookup and
fallback chain:

  1. FocalLengthIn35mmFilm  -> focal_px = f35 / 36.0 * width
  2. FocalLength (mm) + sensor width from (make, model) lookup
  3. FocalLength (mm) + sensor width inferred from the format keyword in
     the model string (e.g. "1/2.3" compacts)
  4. default_focal_length_factor * max(width, height)
"""

from __future__ import annotations

import re
from typing import Optional

# Common sensor formats (diagonal name -> width in mm).
SENSOR_FORMATS = {
    "1/3.2": 4.54,
    "1/3": 4.80,
    "1/2.7": 5.37,
    "1/2.5": 5.76,
    "1/2.3": 6.17,
    "1/2": 6.40,
    "1/1.8": 7.18,
    "1/1.7": 7.60,
    "1/1.6": 8.08,
    "2/3": 8.80,
    "1": 13.20,
    "4/3": 17.30,
    "apsc": 23.60,
    "aps-c": 23.60,
    "apsh": 27.90,
    "full": 36.00,
}

# Camera-body table (reference: the thousands-entry specs.cc DB). Grouped
# as (make, sensor width mm, [normalized models]) because bodies of one
# line share a sensor; expanded into the (make, model) -> width dict the
# lookup uses. Coverage: the popular DSLR/mirrorless/compact/phone/drone
# bodies seen in community photo collections.
_BODY_GROUPS = [
    # --- Canon full frame (36.0 x 24) ---
    ("canon", 36.0, [
        "eos5d", "eos5dmarkii", "eos5dmarkiii", "eos5dmarkiv", "eos5ds",
        "eos5dsr", "eos-1dx", "eos-1dxmarkii", "eos-1dxmarkiii",
        "eos-1dsmarkii", "eos-1dsmarkiii", "eosr", "eosr5", "eosr6",
        "eosr6markii", "eosr8", "eosrp", "eosr3",
    ]),
    ("canon", 35.8, ["eos6d", "eos6dmarkii"]),
    # --- Canon APS-H (28.7/27.9) ---
    ("canon", 27.9, ["eos-1dmarkii", "eos-1dmarkiii", "eos-1dmarkiv"]),
    # --- Canon APS-C (22.3 x 14.9 nominal) ---
    ("canon", 22.3, [
        "eos7d", "eos7dmarkii", "eos80d", "eos90d", "eos50d", "eos40d",
        "eos30d", "eos20d", "eos550d", "eos600d", "eos650d", "eos700d",
        "eos750d", "eos760d", "eos800d", "eos850d", "eos100d", "eos200d",
        "eos250d", "eos1100d", "eos1200d", "eos1300d", "eos2000d",
        "eos4000d", "eosrebelt2i", "eosrebelt3", "eosrebelt3i",
        "eosrebelt4i", "eosrebelt5", "eosrebelt5i", "eosrebelt6",
        "eosrebelt6i", "eosrebelt6s", "eosrebelt7", "eosrebelt7i",
        "eosrebelt8i", "eosrebelsl1", "eosrebelsl2", "eosrebelsl3",
        "eosm", "eosm2", "eosm3", "eosm5", "eosm6", "eosm6markii",
        "eosm10", "eosm50", "eosm50markii", "eosm100", "eosm200",
        "eosr7", "eosr10", "eosr50", "eosr100", "eos60d",
    ]),
    ("canon", 22.5, ["eos70d", "eos450d", "eos500d", "eos1000d",
                     "eosrebelxsi", "eosrebelt1i"]),
    # --- Canon 1" / compacts ---
    ("canon", 13.2, [
        "powershotg7x", "powershotg7xmarkii", "powershotg7xmarkiii",
        "powershotg9x", "powershotg9xmarkii", "powershotg5x",
        "powershotg5xmarkii", "powershotg3x", "powershotg1xmarkiii",
    ]),
    ("canon", 7.60, [
        "powershotg9", "powershotg10", "powershotg11", "powershotg12",
        "powershots90", "powershots95", "powershots100", "powershots110",
        "powershots120",
    ]),
    ("canon", 6.17, [
        "powershotsx260hs", "powershotsx280hs", "powershotsx610hs",
        "powershotsx620hs", "powershotsx700hs", "powershotsx710hs",
        "powershotsx720hs", "powershotsx730hs", "powershotsx740hs",
        "powershota2300", "powershota2500", "powershota3400is",
        "powershotelph110hs", "powershotelph130is", "powershotelph160",
        "powershotelph180", "powershotelph190is", "powershotelph300hs",
        "powershotelph330hs", "powershotd20", "powershotd30",
        "ixus132", "ixus145", "ixus155", "ixus160", "ixus165", "ixus170",
        "ixus175", "ixus180", "ixus185", "ixus190", "ixus285hs",
    ]),
    # --- Nikon full frame (35.9 x 24) ---
    ("nikon", 35.9, [
        "d600", "d610", "d750", "d780", "d800", "d800e", "d810", "d850",
        "d4", "d4s", "d5", "d6", "df", "z5", "z6", "z6ii", "z7", "z7ii",
        "z8", "z9", "zf",
    ]),
    ("nikon", 36.0, ["d3", "d3s", "d3x", "d700"]),
    # --- Nikon APS-C (23.5 x 15.6 nominal) ---
    ("nikon", 23.5, [
        "d7100", "d7200", "d7500", "d5200", "d5300", "d5500", "d5600",
        "d3300", "d3400", "d3500", "d500", "z50", "z30", "zfc",
    ]),
    ("nikon", 23.6, [
        "d90", "d300", "d300s", "d5000", "d5100", "d7000", "d80", "d200",
    ]),
    ("nikon", 23.7, ["d40", "d40x", "d50", "d60", "d70", "d70s", "d100",
                     "d3000", "d3100"]),
    ("nikon", 23.2, ["d3200"]),
    # --- Nikon 1 / compacts ---
    ("nikon", 13.2, ["1j1", "1j2", "1j3", "1j4", "1j5", "1v1", "1v2",
                     "1v3", "1aw1", "1s1", "1s2"]),
    ("nikon", 6.17, [
        "coolpixs9900", "coolpixs9700", "coolpixs9500", "coolpixs7000",
        "coolpixs6900", "coolpixs3700", "coolpixs3300", "coolpixa100",
        "coolpixa300", "coolpixaw100", "coolpixaw120", "coolpixaw130",
        "coolpixb500", "coolpixb600", "coolpixb700", "coolpixl840",
        "coolpixl330", "coolpixl340", "coolpixp510", "coolpixp520",
        "coolpixp530", "coolpixp600", "coolpixp610", "coolpixp900",
        "coolpixp950", "coolpixw100", "coolpixw150", "coolpixw300",
    ]),
    ("nikon", 7.60, ["coolpixp7000", "coolpixp7100", "coolpixp7700",
                     "coolpixp7800", "coolpixp340"]),
    # --- Sony full frame ---
    ("sony", 35.8, ["ilce-7", "ilce-7m2", "ilce-9", "ilce-9m2"]),
    ("sony", 35.6, ["ilce-7m3", "ilce-7m4", "ilce-7c"]),
    ("sony", 35.9, [
        "ilce-7r", "ilce-7rm2", "ilce-7rm3", "ilce-7rm4", "ilce-7rm5",
        "ilce-7s", "ilce-7sm2", "ilce-7sm3", "ilce-1",
        "dsc-rx1", "dsc-rx1r", "dsc-rx1rm2",
    ]),
    # --- Sony APS-C ---
    ("sony", 23.5, [
        "ilce-6000", "ilce-6100", "ilce-6300", "ilce-6400", "ilce-6500",
        "ilce-6600", "ilce-6700", "ilce-5000", "ilce-5100", "ilce-3000",
        "nex-3", "nex-3n", "nex-5", "nex-5n", "nex-5r", "nex-5t",
        "nex-6", "nex-7", "nex-c3", "nex-f3", "zv-e10",
        "slt-a33", "slt-a35", "slt-a37", "slt-a55v", "slt-a57",
        "slt-a58", "slt-a65v", "slt-a77v", "ilca-68", "ilca-77m2",
        "dslr-a580", "dslr-a550", "dslr-a500", "dslr-a450",
        "dslr-a390", "dslr-a380", "dslr-a350", "dslr-a330",
        "dslr-a300", "dslr-a290", "dslr-a230", "dslr-a200",
        "dslr-a100", "dslr-a700",
    ]),
    ("sony", 23.4, ["dslr-a850", "dslr-a900"]),
    # --- Sony 1" ---
    ("sony", 13.2, [
        "dsc-rx100", "dsc-rx100m2", "dsc-rx100m3", "dsc-rx100m4",
        "dsc-rx100m5", "dsc-rx100m5a", "dsc-rx100m6", "dsc-rx100m7",
        "dsc-rx10", "dsc-rx10m2", "dsc-rx10m3", "dsc-rx10m4", "zv-1",
    ]),
    ("sony", 6.17, [
        "dsc-h300", "dsc-h400", "dsc-hx50", "dsc-hx50v", "dsc-hx60",
        "dsc-hx60v", "dsc-hx80", "dsc-hx90", "dsc-hx90v", "dsc-hx99",
        "dsc-hx300", "dsc-hx350", "dsc-hx400", "dsc-hx400v",
        "dsc-wx220", "dsc-wx350", "dsc-wx500", "dsc-w800", "dsc-w810",
        "dsc-w830", "dsc-tx30",
    ]),
    # --- Fujifilm APS-C ---
    ("fujifilm", 23.6, ["x-t1", "x-t2", "x-pro1", "x-pro2", "x-e1",
                        "x-e2", "x-e2s", "x100", "x100s", "x100t",
                        "x-t10", "x-a1", "x-a2", "x-m1"]),
    ("fujifilm", 23.5, [
        "x-t3", "x-t4", "x-t5", "x-t20", "x-t30", "x-t30ii", "x-t100",
        "x-t200", "x-pro3", "x-e3", "x-e4", "x-s10", "x-s20", "x-h1",
        "x-h2", "x-h2s", "x100f", "x100v", "x100vi", "x-a3", "x-a5",
        "x-a7",
    ]),
    ("fujifilm", 43.8, ["gfx50s", "gfx50r", "gfx100", "gfx100s"]),
    ("fujifilm", 6.17, [
        "finepixs4800", "finepixs8600", "finepixs9400w", "finepixxp70",
        "finepixxp80", "finepixxp90", "finepixxp120", "finepixxp130",
        "finepixxp140", "finepixjx500", "finepixjx550",
    ]),
    # --- Olympus / OM System micro four thirds (17.3 x 13) ---
    ("olympus", 17.3, [
        "e-m1", "e-m1markii", "e-m1markiii", "e-m1x", "e-m5",
        "e-m5markii", "e-m5markiii", "e-m10", "e-m10markii",
        "e-m10markiii", "e-m10markiv", "pen-f", "e-pl1", "e-pl2",
        "e-pl3", "e-pl5", "e-pl6", "e-pl7", "e-pl8", "e-pl9", "e-pl10",
        "e-p1", "e-p2", "e-p3", "e-p5", "e-pm1", "e-pm2", "e-620",
        "e-600", "e-520", "e-510", "e-500", "e-450", "e-420", "e-410",
        "e-30", "e-3", "e-5",
    ]),
    ("olympus", 6.17, ["tg-4", "tg-5", "tg-6", "tg-860", "tg-870",
                       "sh-2", "sh-3", "sz-16", "sz-17"]),
    # --- Panasonic micro four thirds ---
    ("panasonic", 17.3, [
        "dmc-gh1", "dmc-gh2", "dmc-gh3", "dmc-gh4", "dc-gh5", "dc-gh5s",
        "dc-gh6", "dmc-g1", "dmc-g2", "dmc-g3", "dmc-g5", "dmc-g6",
        "dmc-g7", "dmc-g80", "dmc-g81", "dmc-g85", "dc-g9", "dc-g90",
        "dc-g91", "dc-g95", "dc-g100", "dmc-gx1", "dmc-gx7", "dmc-gx8",
        "dmc-gx80", "dmc-gx85", "dc-gx9", "dmc-gf1", "dmc-gf2",
        "dmc-gf3", "dmc-gf5", "dmc-gf6", "dmc-gf7", "dmc-gm1",
        "dmc-gm5", "dmc-lx100", "dc-lx100m2",
    ]),
    ("panasonic", 35.6, ["dc-s1", "dc-s1r", "dc-s1h", "dc-s5", "dc-s5m2"]),
    ("panasonic", 13.2, ["dmc-fz1000", "dc-fz1000m2", "dmc-fz2000",
                         "dmc-fz2500", "dmc-zs100", "dmc-tz100",
                         "dc-zs200", "dc-tz200", "dmc-cm1"]),
    ("panasonic", 6.17, [
        "dmc-tz40", "dmc-tz55", "dmc-tz57", "dmc-tz60", "dmc-tz70",
        "dmc-tz80", "dc-tz90", "dc-tz95", "dmc-zs30", "dmc-zs35",
        "dmc-zs40", "dmc-zs45", "dmc-zs50", "dc-zs70", "dmc-fz70",
        "dmc-fz80", "dmc-fz300", "dmc-ft5", "dmc-ft30", "dmc-sz10",
        "dmc-ls5",
    ]),
    ("panasonic", 7.60, ["dmc-lx5", "dmc-lx7"]),
    # --- Pentax / Ricoh ---
    ("pentax", 23.5, ["k-3", "k-3ii", "k-3markiii", "k-5", "k-5ii",
                      "k-5iis", "k-7", "k-70", "k-50", "k-30", "k-s1",
                      "k-s2", "k-r", "k-x", "k-m", "k20d", "k10d",
                      "k100d", "k200d", "kp", "k-500"]),
    ("pentax", 35.9, ["k-1", "k-1markii"]),
    ("ricoh", 23.7, ["gr", "grii", "griii", "griiix"]),
    ("ricoh", 6.17, ["thetas", "thetav", "thetasc", "thetasc2", "wg-4",
                     "wg-5gps", "wg-30", "wg-50", "wg-60", "g900"]),
    ("ricoh", 7.60, ["grdigitaliii", "grdigitaliv"]),
    # --- Leica / Sigma / Hasselblad ---
    ("leica", 36.0, ["q", "q2", "q3", "sl", "sl2", "m10", "m11",
                     "m-e", "m-p"]),
    ("leica", 35.8, ["m8", "m9", "m240", "mmonochrom"]),
    ("leica", 23.6, ["cl", "tl2", "t", "x1", "x2"]),
    ("sigma", 23.5, ["sdquattro", "dp1quattro", "dp2quattro",
                     "dp3quattro", "dp0quattro"]),
    ("hasselblad", 43.8, ["x1d", "x1dii50c", "x2d100c"]),
    # --- Phones: Apple ---
    ("apple", 4.54, ["iphone4", "iphone4s", "iphone5", "iphone5c"]),
    ("apple", 4.89, ["iphone5s", "iphonese"]),
    ("apple", 4.80, ["iphone6", "iphone6plus", "iphone6s",
                     "iphone6splus", "iphone7", "iphone7plus",
                     "iphone8", "iphone8plus", "iphonese2ndgeneration"]),
    ("apple", 5.66, ["iphonex", "iphonexr", "iphonexs", "iphonexsmax",
                     "iphone11", "iphone11pro", "iphone11promax"]),
    ("apple", 5.78, ["iphone12", "iphone12mini", "iphone12pro",
                     "iphonese3rdgeneration"]),
    ("apple", 7.01, ["iphone12promax", "iphone13", "iphone13mini",
                     "iphone13pro", "iphone13promax", "iphone14",
                     "iphone14plus"]),
    ("apple", 7.57, ["iphone14pro", "iphone14promax"]),
    ("apple", 9.80, ["iphone15", "iphone15plus", "iphone15pro",
                     "iphone15promax", "iphone16", "iphone16pro"]),
    ("apple", 4.0, ["ipadair", "ipadair2", "ipadpro", "ipadmini",
                    "ipad"]),
    # --- Phones: Google Pixel ---
    ("google", 6.17, ["pixel", "pixelxl", "pixel2", "pixel2xl"]),
    ("google", 5.50, ["pixel3", "pixel3xl", "pixel3a", "pixel3axl",
                      "pixel4", "pixel4xl", "pixel4a", "pixel5",
                      "pixel5a"]),
    ("google", 6.40, ["pixel6", "pixel6pro", "pixel6a", "pixel7",
                      "pixel7pro", "pixel7a", "pixel8", "pixel8pro"]),
    # --- Phones: Samsung (galaxy s/note flagships) ---
    ("samsung", 5.76, ["sm-g900f", "sm-g920f", "sm-g925f", "sm-g930f",
                       "sm-g935f", "sm-n910f", "sm-n920c"]),
    ("samsung", 6.40, ["sm-g950f", "sm-g955f", "sm-g960f", "sm-g965f",
                       "sm-g970f", "sm-g973f", "sm-g975f", "sm-n950f",
                       "sm-n960f", "sm-n970f", "sm-n975f"]),
    ("samsung", 6.90, ["sm-g980f", "sm-g981b", "sm-g985f", "sm-g986b",
                       "sm-g991b", "sm-g996b", "sm-g998b", "sm-s901b",
                       "sm-s906b", "sm-s908b", "sm-s911b", "sm-s916b",
                       "sm-s918b"]),
    # --- Phones: others (main camera, approximate) ---
    ("huawei", 6.17, ["p20", "p20pro", "p30", "p30pro", "mate20",
                      "mate20pro", "mate30pro"]),
    ("huawei", 7.30, ["p40pro", "mate40pro"]),
    ("xiaomi", 6.17, ["mi8", "mi9", "mi10", "redminote7", "redminote8",
                      "redminote9", "redminote10"]),
    ("oneplus", 6.17, ["oneplus5", "oneplus6", "oneplus6t", "oneplus7",
                       "oneplus7pro", "oneplus8", "oneplus8pro"]),
    ("lg", 5.76, ["g5", "g6", "g7thinq", "v30", "v40thinq"]),
    ("motorola", 5.76, ["motog7", "motog8", "edge20"]),
    ("htc", 5.76, ["one", "onem8", "onem9", "u11"]),
    ("nokia", 5.76, ["lumia920", "lumia1020", "7plus", "8"]),
    # --- Drones: DJI (camera module names in EXIF) ---
    ("dji", 6.17, ["fc300c", "fc300s", "fc300x", "fc300xw", "fc330",
                   "fc220", "fc200", "fc2103", "fc2204", "fc7203",
                   "fc3582", "phantomvisionfc200", "hg310"]),
    ("dji", 6.40, ["fc3170", "fc3411"]),
    ("dji", 13.2, ["fc6310", "fc6310s", "l1d-20c", "fc3511"]),
    ("dji", 17.3, ["fc550", "fc550raw", "fc6520", "zenmusex5",
                   "zenmusex5s"]),
    ("dji", 23.5, ["zenmusex7", "zenmusep1"]),
    ("hasselblad", 13.2, ["l1d-20c", "l2d-20c"]),
    ("parrot", 6.17, ["anafi", "bebop2", "sequoia"]),
    ("autel", 6.40, ["xt701", "xt705"]),
    ("yuneec", 6.17, ["cgo3", "cgo3plus", "e90"]),
    # --- Action cams / 360 ---
    ("gopro", 6.17, [
        "hero3blackedition", "hero3silveredition", "hero3plusblackedition",
        "hero4black", "hero4silver", "hero4session", "hero5black",
        "hero5session", "hero6black", "hero7black", "hero7silver",
        "hero7white", "hero8black", "hero9black", "hero10black",
        "hero11black", "hero12black", "max", "fusion",
    ]),
    ("insta360", 6.40, ["onex", "onex2", "x3", "oner", "on90"]),
    ("garmin", 6.17, ["virb", "virbultra30", "virb360"]),
    # --- Older compacts: Kodak / Casio / generic ---
    ("kodak", 6.17, ["easysharez990", "easysharez5010", "easysharem532",
                     "easysharem583", "pixproaz401", "pixproaz421",
                     "pixproaz521", "pixprofz43", "pixprofz53"]),
    ("casio", 6.17, ["ex-zr400", "ex-zr800", "ex-zr1000", "ex-zr1100",
                     "ex-zs10", "ex-h10", "ex-z80"]),
    ("kodak", 7.85, ["easysharep880"]),
    ("konicaminolta", 23.5, ["maxxum7d", "dynax7d", "alpha-7digital"]),
]

SENSOR_WIDTHS = {}
for _make, _w, _models in _BODY_GROUPS:
    for _m in _models:
        SENSOR_WIDTHS.setdefault((_make, _m), _w)
# Secondary brand names appearing in EXIF Make strings.
for _alias, _canon in [("omdigitalsolutions", "olympus"),
                       ("lumix", "panasonic"),
                       # _normalize strips spaces, so "OM SYSTEM" EXIF
                       # strings resolve to this key.
                       ("omsystem", "olympus")]:
    for (_mk, _md), _w in list(SENSOR_WIDTHS.items()):
        if _mk == _canon:
            SENSOR_WIDTHS.setdefault((_alias, _md), _w)


def _normalize(s: str) -> str:
    return re.sub(r"[^a-z0-9/.\-]", "", s.lower())


def sensor_width_mm(make: str, model: str) -> Optional[float]:
    """Look up sensor width for (make, model); None if unknown."""
    nm_full = _normalize(make or "")
    nd = _normalize(model or "")
    # Makers append suffixes ("NIKON CORPORATION"); also try the first word.
    first = _normalize((make or "").split()[0]) if (make or "").split() else ""
    makes = [m for m in {nm_full, first} if m]
    models = {nd}
    for m in makes:
        if nd.startswith(m):
            models.add(nd[len(m):])
    for m in makes:
        for d in models:
            if (m, d) in SENSOR_WIDTHS:
                return SENSOR_WIDTHS[(m, d)]
    # Format keyword inside the model string (compacts often embed it).
    for fmt, width in SENSOR_FORMATS.items():
        if fmt in nd:
            return width
    return None


def focal_length_px_from_exif(
    exif: dict, width: int, height: int,
    default_focal_length_factor: float = 1.2,
):
    """EXIF -> (focal_px, has_prior) using the reference's fallback chain.

    exif keys (as parsed by utils.exif.read_exif): focal_length_mm,
    focal_length_35mm, make, model.
    """
    f35 = exif.get("focal_length_35mm")
    if f35 and f35 > 0:
        return f35 / 36.0 * max(width, height), True
    fmm = exif.get("focal_length_mm")
    if fmm and fmm > 0:
        sw = sensor_width_mm(exif.get("make", ""), exif.get("model", ""))
        if sw:
            return fmm / sw * max(width, height), True
    return default_focal_length_factor * max(width, height), False
