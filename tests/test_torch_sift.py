"""colmap_tpu_torch's feature extraction slice against colmap_tpu, on the CPU.

Images -> features: the port's PNG/PGM/EXIF readers against PIL (which
colmap_tpu reads through), its renderer against colmap_tpu's, the plain
versions of the SIFT kernels K13-K16 against the JAX functions in float64,
and the whole extractor, pipeline and command against colmap_tpu's in
float32. Inputs come from a numpy seed; options reach the port through
convert_options. Each test states its tolerance and why.

colmap_tpu samples the gradients of octaves of at least 130 px through bf16
hat-function contractions (sift.py:310-375, a TPU workaround the port does
not carry), about 2^-9 relative off exact bilinear sampling even in float64:
the exact comparisons use octaves under 130 px, and the whole extractor is
compared keypoint by keypoint with stated shares.
"""

import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from colmap_tpu.controllers import feature_pipeline as jpipe
from colmap_tpu.feature import keypoints as jkeypoints
from colmap_tpu.feature import sift as J
from colmap_tpu.scene import database as jdb
from colmap_tpu.scene.synthetic import SyntheticDatasetOptions, synthesize_dataset
from colmap_tpu.scene.synthetic_images import render_images as j_render
from colmap_tpu.sensor import specs as jspecs
from colmap_tpu.utils.exif import read_exif as j_read_exif
from colmap_tpu_torch import convert
from colmap_tpu_torch.cli import main as tcli
from colmap_tpu_torch.controllers import feature_pipeline as tpipe
from colmap_tpu_torch.feature import keypoints as tkeypoints
from colmap_tpu_torch.feature import sift as T
from colmap_tpu_torch.kernels import sift as K
from colmap_tpu_torch.kernels import sift_cases as SC
from colmap_tpu_torch.scene import database as tdb
from colmap_tpu_torch.scene.synthetic_images import render_images as t_render
from colmap_tpu_torch.sensor import specs as tspecs
from colmap_tpu_torch.utils import image_io
from colmap_tpu_torch.utils.exif import read_exif as t_read_exif

# The suite runs several worker processes on the CPU's cores: one intra-op
# thread a process keeps the port's many small CPU ops from oversubscribing
# the cores (on one core they run about as fast as on eight). Every worker
# collects, and so imports, every test module, so this one call sets the
# whole worker process, and with it every port test that the worker runs.
torch.set_num_threads(1)


def _T(a):
    return torch.from_numpy(np.array(a))


def _scene(num_frames, width, height, num_points, focal, seed=3):
    opt = SyntheticDatasetOptions(num_rigs=1, num_frames_per_rig=num_frames,
                                  num_points3D=num_points, camera_model_id=1,
                                  camera_params=(focal, focal, width / 2, height / 2),
                                  camera_width=width, camera_height=height)
    return synthesize_dataset(opt, None, rng=np.random.default_rng(seed))


@pytest.fixture(scope="module")
def views(tmp_path_factory):
    """Three rendered 480 x 480 views (300 points, f = 600), by colmap_tpu's
    renderer: (directory, names)."""
    d = str(tmp_path_factory.mktemp("views"))
    names = j_render(_scene(3, 480, 480, 300, 600.0), d, patch_world=0.08)
    return d, names


# ---------------------------------------------------------------------------
# Image files, EXIF, sensor table, keypoint layouts, the renderer.
# ---------------------------------------------------------------------------


def _pil_file(path, kind, rng):
    if kind == "gray":
        Image.fromarray(rng.integers(0, 256, (23, 37), dtype=np.uint8)).save(path)
    elif kind == "rgb":
        a = rng.integers(0, 256, (23, 37, 3), dtype=np.uint8)
        a[:, :15] = np.arange(15, dtype=np.uint8)[None, :, None] * 9  # smooth: Sub/Up/Paeth rows
        Image.fromarray(a).save(path)
    elif kind == "rgba":
        Image.fromarray(rng.integers(0, 256, (23, 37, 4), dtype=np.uint8)).save(path)
    elif kind == "gray_alpha":
        Image.fromarray(rng.integers(0, 256, (23, 37, 2), dtype=np.uint8), "LA").save(path)
    elif kind == "palette":
        im = Image.fromarray(rng.integers(0, 256, (23, 37, 3), dtype=np.uint8))
        im.convert("P", palette=Image.Palette.ADAPTIVE, colors=40).save(path)
    elif kind == "palette_4bit":
        im = Image.fromarray(rng.integers(0, 256, (23, 37, 3), dtype=np.uint8))
        im.convert("P", palette=Image.Palette.ADAPTIVE, colors=12).save(path, bits=4)
    elif kind == "gray16":
        Image.fromarray(rng.integers(0, 400, (23, 37)).astype(np.uint16)).save(path)
    elif kind == "pgm":
        Image.fromarray(rng.integers(0, 256, (23, 37), dtype=np.uint8)).save(path)
    elif kind == "ppm":
        Image.fromarray(rng.integers(0, 256, (23, 37, 3), dtype=np.uint8)).save(path)


@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba", "gray_alpha", "palette", "palette_4bit",
                                  "gray16", "pgm", "ppm"])
def test_image_decoding_matches_pil(tmp_path, kind):
    """Files written by PIL decode to PIL's convert("L"), pixel for pixel."""
    path = str(tmp_path / ("img." + ("pgm" if kind == "pgm" else "ppm" if kind == "ppm"
                                     else "png")))
    _pil_file(path, kind, np.random.default_rng(len(kind)))
    want = np.asarray(Image.open(path).convert("L"))
    got = image_io.read_image_gray(path)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def _png_bytes(rows_by_pass, width, height, color, depth, interlace):
    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", width, height, depth, color, 0, 0, interlace)
    return (image_io.PNG_SIGNATURE + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(b"".join(rows_by_pass))) + chunk(b"IEND", b""))


def _filter_rows(img, bpp, kind):
    """Rows of an (h, w * bpp) uint8 array under PNG filter ``kind``."""
    raw = img.astype(np.int32)
    prev = np.zeros_like(raw)
    prev[1:] = raw[:-1]
    left = np.zeros_like(raw)
    left[:, bpp:] = raw[:, :-bpp]
    upleft = np.zeros_like(raw)
    upleft[1:, bpp:] = raw[:-1, :-bpp]
    if kind == 0:
        pred = np.zeros_like(raw)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = prev
    elif kind == 3:
        pred = (left + prev) // 2
    else:
        p = left + prev - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
    out = ((raw - pred) & 0xFF).astype(np.uint8)
    return [bytes([kind]) + r.tobytes() for r in out]


@pytest.mark.parametrize("interlace", [0, 1], ids=["progressive", "adam7"])
def test_png_filters_and_interlacing(tmp_path, interlace):
    """Every row filter (each pass its own) and Adam7 decode to the pixels
    that were encoded (RGB, so bpp 3; then PIL's gray conversion)."""
    rng = np.random.default_rng(5)
    h, w = 19, 23
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    img[:, :8] = np.arange(8, dtype=np.uint8)[None, :, None] * 30
    rows = []
    passes = image_io._ADAM7 if interlace else ((0, 0, 1, 1),)
    for k, (y0, x0, dy, dx) in enumerate(passes):
        sub = img[y0::dy, x0::dx]
        if sub.size:
            flat = sub.reshape(sub.shape[0], -1)
            per_row = [_filter_rows(flat, 3, f) for f in range(5)]
            rows += [per_row[(r + k) % 5][r] for r in range(flat.shape[0])]
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_png_bytes(rows, w, h, 2, 8, interlace))
    decoded, color, depth, _, _ = image_io.read_png(path)
    assert color == 2 and depth == 8 and np.array_equal(decoded, img)
    want = np.asarray(Image.fromarray(img).convert("L"))
    assert np.array_equal(image_io.read_image_gray(path), want)


def test_port_files_read_back_in_pil(tmp_path):
    """PIL reads the port's gray PNG, PGM and PPM back exactly."""
    rng = np.random.default_rng(1)
    gray = rng.integers(0, 256, (31, 45), dtype=np.uint8)
    rgb = rng.integers(0, 256, (31, 45, 3), dtype=np.uint8)
    image_io.write_png_gray(str(tmp_path / "a.png"), gray)
    image_io.write_pnm(str(tmp_path / "a.pgm"), gray)
    image_io.write_pnm(str(tmp_path / "a.ppm"), rgb)
    assert np.array_equal(np.asarray(Image.open(tmp_path / "a.png")), gray)
    assert np.array_equal(np.asarray(Image.open(tmp_path / "a.pgm")), gray)
    assert np.array_equal(np.asarray(Image.open(tmp_path / "a.ppm")), rgb)
    assert np.array_equal(image_io.read_image_gray(str(tmp_path / "a.png")), gray)


def test_read_exif_matches_colmap_tpu(tmp_path):
    """EXIF of a JPEG (focal length, 35 mm focal length, make, model, GPS in
    the GPS IFD) and of a PNG (eXIf chunk), and of a file without EXIF: the
    same dict as colmap_tpu's PIL-based reader."""
    exif = Image.Exif()
    exif[271] = "Canon"
    exif[272] = "Canon EOS 5D Mark II"
    sub = exif.get_ifd(0x8769)
    sub[37386] = 24.0
    sub[41989] = 35
    gps = exif.get_ifd(34853)
    gps[1], gps[2] = "S", (33.0, 51.0, 35.9)
    gps[3], gps[4] = "E", (151.0, 12.0, 40.2)
    gps[5], gps[6] = 0, 58.5
    img = Image.fromarray(np.full((16, 24, 3), 128, np.uint8))
    img.save(tmp_path / "a.jpg", exif=exif)
    img.save(tmp_path / "a.png", exif=exif)
    img.save(tmp_path / "b.png")
    for name in ("a.jpg", "a.png", "b.png"):
        path = str(tmp_path / name)
        want = j_read_exif(path)
        assert t_read_exif(path) == pytest.approx(want), name
    assert set(t_read_exif(str(tmp_path / "a.jpg"))) == {
        "make", "model", "focal_length_mm", "focal_length_35mm", "latitude", "longitude",
        "altitude"}
    for ex in ({"focal_length_35mm": 28.0}, {"focal_length_mm": 24.0, "make": "Canon",
                                              "model": "Canon EOS 5D Mark II"}, {}):
        assert (tspecs.focal_length_px_from_exif(ex, 640, 480)
                == jspecs.focal_length_px_from_exif(ex, 640, 480))


def test_keypoint_layouts_match_colmap_tpu():
    rng = np.random.default_rng(0)
    for cols in (2, 4, 6):
        kp = rng.standard_normal((9, cols)).astype(np.float32)
        assert np.array_equal(tkeypoints.keypoints_to_xyso(kp), jkeypoints.keypoints_to_xyso(kp))
        assert np.array_equal(tkeypoints.keypoints_to_frames(kp),
                              jkeypoints.keypoints_to_frames(kp))


def test_render_images_matches_colmap_tpu(tmp_path):
    """The same reconstruction and seed give the same pixels (3 frames,
    320 x 240), written by the port without PIL."""
    recon = _scene(3, 320, 240, 200, 400.0)
    names = j_render(recon, str(tmp_path / "j"), patch_world=0.08)
    assert t_render(convert.convert_reconstruction(recon), str(tmp_path / "t"),
                    patch_world=0.08) == names
    for n in names:
        want = np.asarray(Image.open(tmp_path / "j" / n).convert("L"))
        assert np.array_equal(image_io.read_image_gray(str(tmp_path / "t" / n)), want)
        assert want.mean() > 5


def test_options_convert():
    """convert_options carries SiftOptions and ImageReaderOptions across."""
    j = J.SiftOptions(max_num_features=123, upright=True, normalization="L2")
    assert dataclass_dict(convert.convert_options(j)) == dataclass_dict(j)
    r = jpipe.ImageReaderOptions(camera_model="PINHOLE", camera_params="1,2,3,4")
    assert dataclass_dict(convert.convert_options(r)) == dataclass_dict(r)


def dataclass_dict(o):
    import dataclasses

    return dataclasses.asdict(o)


# ---------------------------------------------------------------------------
# K13-K16's plain versions against the JAX functions (float64).
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def octave():
    """A 60 x 80 image of smoothed noise from a seed, upsampled and blurred
    as _detect_all does (float64), and colmap_tpu's octave 0 (120 x 160,
    under 130 px: the exact sampling path)."""
    from scipy.ndimage import gaussian_filter

    img = gaussian_filter(np.random.default_rng(0).uniform(0, 1, (60, 80)), 1.0)
    img = (img - img.min()) / (img.max() - img.min())
    up = np.asarray(J._upsample2(jnp.asarray(img)))
    base = np.asarray(J._blur(jnp.asarray(up), 1.6, jnp.float64))
    gauss, dog = J.build_octave(jnp.asarray(base), J.SiftOptions())
    return img, up, base, np.asarray(gauss), np.asarray(dog)


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max()


def test_pyramid_matches_jax(octave):
    """K13's plain version: upsample2, blur, build_octave, downsample2 to
    1e-10 (float64 sums in another order than HIGHEST matmuls); the base
    blur of _detect_all builds float32 taps even under x64, so float32 to
    1e-6."""
    img, up, base, gauss, dog = octave
    opts = convert.convert_options(J.SiftOptions())
    assert _rel(K.upsample2_plain(_T(img)), up) <= 1e-10
    assert _rel(K.blur_plain(_T(up), 1.6), base) <= 1e-10
    g, d = K.build_octave_plain(_T(base), opts)
    assert _rel(g, gauss) <= 1e-10 and _rel(d, dog) <= 1e-10
    assert np.array_equal(K.downsample2_plain(_T(gauss[3])).numpy(),
                          np.asarray(J._downsample2(jnp.asarray(gauss[3]))))
    up32 = up.astype(np.float32)
    want = np.asarray(J._blur(jnp.asarray(up32), 1.6, jnp.float32))
    assert _rel(K.blur_plain(_T(up32), 1.6), want) <= 1e-6


def test_extrema_refinement_and_selection_match_jax(octave):
    """K14's plain version: on colmap_tpu's DoG the same extrema mask, and
    refinement equal to _refine_candidates to 1e-9; on a DoG of tied values
    (plateaus, equal scores) the same candidates in the same order as
    lax.top_k, for capacities below and above the extremum count."""
    _, _, _, _, dog = octave
    jo = J.SiftOptions()
    opts = convert.convert_options(jo)
    mask = np.asarray(J._find_extrema(jnp.asarray(dog), jo.peak_threshold))
    assert np.array_equal(K.extrema_mask_plain(_T(dog), opts.peak_threshold).numpy(), mask)
    assert mask.sum() > 50
    ext = K.detect_extrema_plain(_T(dog), opts)
    S, H, W = mask.shape
    flat = ext.flat.numpy()
    ss, ys, xs = flat // (H * W), (flat % (H * W)) // W, flat % W
    x, y, s, resp, keep = (np.asarray(a) for a in J._refine_candidates(
        jnp.asarray(dog), jnp.asarray(ys), jnp.asarray(xs), jnp.asarray(ss),
        jnp.ones(len(flat), bool), jo))
    rows = ext.rows.numpy()
    assert np.array_equal(ext.keep.numpy(), keep)
    for j, want in ((0, x), (1, y), (2, s), (4, resp)):
        assert np.abs(rows[:, j] - want).max() <= 1e-9
    lvl = np.clip(np.round(s).astype(np.int32) + 1, 0, 5)
    assert np.array_equal(ext.lvl.numpy(), lvl)

    tied = SC.tied_dog(3, 40, 56, 0, "cpu")
    ext = K.detect_extrema_plain(tied, opts)
    scores = jnp.where(jnp.asarray(K.extrema_mask_plain(tied, opts.peak_threshold).numpy())
                       .reshape(-1), jnp.abs(jnp.asarray(tied.numpy()[1:-1]).reshape(-1)),
                       -jnp.inf)
    n = len(ext.flat)
    assert len(np.unique(ext.score.numpy())) < n / 4  # many equal scores
    for cap in (n // 3, n, 4 * n):
        top = np.asarray(jax.lax.top_k(scores, min(cap, scores.shape[0]))[1])
        top = top[np.asarray(scores)[top] > 0]
        assert np.array_equal(ext.flat[K.top_candidates(ext, cap)].numpy(), top)


@pytest.mark.parametrize("variant", ["default", "upright", "L2", "dsp", "affine"])
def test_orientations_and_descriptors_match_jax_exact_path(octave, variant):
    """K15 and K16's plain versions against _orientations_and_descriptors on
    a 120 x 160 octave (the exact sampling path): the same ok rows, theta,
    frames and float descriptors to 1e-9; the affine variant runs the
    Baumberg shapes (plain version only)."""
    _, _, base, gauss, dog = octave
    fields = {"default": {}, "upright": dict(upright=True), "L2": dict(normalization="L2"),
              "dsp": dict(domain_size_pooling=True), "affine": dict(estimate_affine_shape=True)}
    jo = J.SiftOptions(**fields[variant])
    opts = convert.convert_options(jo)
    ext = K.detect_extrema_plain(_T(dog), opts)
    sel = K.select_candidates(ext, opts.max_candidates_per_octave)
    x, y, lvl, sigma, resp = K.selected_keypoints(ext, sel)
    out = J._orientations_and_descriptors(
        jnp.asarray(gauss), jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
        jnp.asarray(lvl.numpy()), jnp.asarray(sigma.numpy()), jnp.ones(len(sel), bool), jo)
    _, _, _, th_j, frames_j, desc_j, ok_j = (np.asarray(a) for a in out)
    g = _T(gauss)
    shapes = K.affine_shapes_plain(g, x, y, lvl, sigma, opts) if variant == "affine" else None
    theta, ok = K.orientations_plain(g, x, y, lvl, sigma, opts, shapes)
    data, desc, _ = K.descriptors_plain(g, x, y, lvl, sigma, resp, theta, opts, shapes)
    okf = ok.reshape(-1).numpy()
    assert np.array_equal(okf, ok_j) and okf.sum() > 20
    assert np.abs(theta.reshape(-1).numpy()[okf] - th_j[okf]).max() <= 1e-9
    assert np.abs(data[:, 5:].numpy()[okf] - frames_j.reshape(-1, 4)[okf]).max() <= 1e-9
    assert np.abs(desc.numpy()[okf] - desc_j[okf]).max() <= 1e-9


def test_orientations_and_descriptors_against_jax_bf16_path():
    """At a 300 x 400 octave colmap_tpu samples through bf16 windows: the
    port's exact sampling stays within 1e-2 rad and 1e-2 per descriptor
    entry on at least 95% of the rows (measured: all 148 rows, largest
    differences 4.4e-3 rad and 2.4e-3)."""
    img = SC.rendered_views(1, 200, 150, num_points=200)[0].astype(np.float64) / 255.0
    jo = J.SiftOptions()
    opts = convert.convert_options(jo)
    base = K.blur_plain(K.upsample2_plain(_T(img)), 1.6)
    gauss, dog = K.build_octave_plain(base, opts)
    ext = K.detect_extrema_plain(dog, opts)
    sel = K.select_candidates(ext, opts.max_candidates_per_octave)
    x, y, lvl, sigma, resp = K.selected_keypoints(ext, sel)
    out = J._orientations_and_descriptors(
        jnp.asarray(gauss.numpy()), jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
        jnp.asarray(lvl.numpy()), jnp.asarray(sigma.numpy()), jnp.ones(len(sel), bool), jo)
    _, _, _, th_j, _, desc_j, ok_j = (np.asarray(a) for a in out)
    theta, ok = K.orientations_plain(gauss, x, y, lvl, sigma, opts)
    _, desc, _ = K.descriptors_plain(gauss, x, y, lvl, sigma, resp, theta, opts)
    both = ok.reshape(-1).numpy() & ok_j
    dth = np.abs((theta.reshape(-1).numpy() - th_j + np.pi) % (2 * np.pi) - np.pi)[both]
    dd = np.abs(desc.numpy() - desc_j)[both]
    share_theta = float((dth <= 1e-2).mean())
    share_desc = float((dd <= 1e-2).all(axis=1).mean())
    print(f"bf16 path: {both.sum()} rows; theta within 1e-2 rad on {share_theta:.4f} "
          f"(largest {dth.max():.3g}), descriptors within 1e-2 on {share_desc:.4f} "
          f"(largest {dd.max():.3g})")
    assert both.sum() > 100 and share_theta >= 0.95 and share_desc >= 0.95


# ---------------------------------------------------------------------------
# The extractor, the pipeline and the commands.
# ---------------------------------------------------------------------------


def _agrees_with_colmap_tpu(kj, dj, kt, dt):
    """The port's keypoints (kt, dt) against colmap_tpu's (kj, dj): >= 97%
    of JAX's keypoints have a port keypoint within 1e-2 px, 1e-3 relative
    scale and 1e-2 rad; over those pairs >= 95% of descriptor entries are
    equal, >= 99.5% of the pairs differ by at most 2 counts and none by
    more than 3; the counts agree within 3%. The few pairs at 3 counts are
    keypoints whose JAX orientation came from the bf16 path about 4e-3 rad
    off (the rest agree to about 1e-4 rad)."""
    a = SC.match_keypoints(kj, dj, kt, dt)
    assert kt.dtype == np.float32 and dt.dtype == np.uint8 and kt.shape[1] == 4
    assert a.share >= 0.97 and a.equal >= 0.95 and a.within2 >= 0.995 and a.worst <= 3, a
    assert abs(len(kt) - len(kj)) <= 0.03 * len(kj)
    return a


def test_extract_sift_matches_colmap_tpu(views):
    """extract_sift in float32 (the port's plain versions on the CPU)
    against colmap_tpu's on a rendered 480 x 480 view, held as
    _agrees_with_colmap_tpu says (measured: 1303 keypoints each, 0.9992
    matched, 0.9806 of entries equal, 1302 of 1303 pairs within 2 counts,
    one at 3 where JAX's theta is 3.9e-3 rad off)."""
    d, names = views
    img = np.asarray(Image.open(os.path.join(d, names[0])).convert("L"))
    kj, dj = J.extract_sift(img)
    kt, dt = T.extract_sift(img, convert.convert_options(J.SiftOptions()), device="cpu")
    a = _agrees_with_colmap_tpu(kj, dj, kt, dt)
    print(f"extract_sift: {len(kj)} JAX keypoints, {len(kt)} port; {a}")


def test_run_feature_extraction_matches_colmap_tpu(views, tmp_path):
    """run_feature_extraction of both packages on three rendered views, one
    PINHOLE camera from --camera_params: the same cameras, image names and
    ids, keypoints and descriptors as _agrees_with_colmap_tpu holds them."""
    d, names = views
    jr = jpipe.ImageReaderOptions(camera_model="PINHOLE", camera_params="600,600,240,240")
    js = J.SiftOptions(max_num_features=1000)
    jd, td = jdb.Database(str(tmp_path / "j.db")), tdb.Database(str(tmp_path / "t.db"))
    jids = jpipe.run_feature_extraction(jd, d, reader_options=jr, sift_options=js)
    tids = tpipe.run_feature_extraction(td, d, reader_options=convert.convert_options(jr),
                                        sift_options=convert.convert_options(js), device="cpu")
    assert jids == tids and jd.read_images() == td.read_images()
    jc, tc = jd.read_cameras(), td.read_cameras()
    assert list(jc) == list(tc)
    for cid in jc:
        a, b = jc[cid], tc[cid]
        assert (a.model_id, a.width, a.height, a.has_prior_focal_length) == (
            b.model_id, b.width, b.height, b.has_prior_focal_length)
        assert np.array_equal(a.params, b.params)
    for iid in jids:
        _agrees_with_colmap_tpu(jd.read_keypoints(iid), jd.read_descriptors(iid),
                                td.read_keypoints(iid), td.read_descriptors(iid))
    jd.close()
    td.close()


def test_feature_extractor_command(views, tmp_path):
    """feature_extractor on the CPU: masks drop keypoints on zero pixels;
    ALIKED runs; a card that is not there raises."""
    d, names = views
    mask = np.zeros((480, 480), np.uint8)
    mask[:, :240] = 255
    os.makedirs(tmp_path / "masks")
    for n in names:
        image_io.write_png_gray(str(tmp_path / "masks" / (n + ".png")), mask)
    db = str(tmp_path / "db.db")
    ids = tcli.main(["feature_extractor", "--database_path", db, "--image_path", d,
                     "--mask_path", str(tmp_path / "masks"), "--max_num_features", "500",
                     "--device", "cpu"])
    t = tdb.Database(db, must_exist=True)
    for iid in ids:
        kp = t.read_keypoints(iid)
        assert 0 < len(kp) <= 500 and (kp[:, 0] < 240).all()
    t.close()
    # --descriptor_type aliked runs on the CPU (a 96 x 128 crop of a view,
    # random weights): 128-d uint8 descriptors, at most --max_num_features.
    small = str(tmp_path / "small")
    os.makedirs(small)
    image_io.write_png_gray(os.path.join(small, "crop.png"),
                            image_io.read_image_gray(os.path.join(d, names[0]))[200:296, 200:328])
    ids = tcli.main(["feature_extractor", "--database_path", str(tmp_path / "a.db"),
                     "--image_path", small, "--descriptor_type", "aliked",
                     "--max_num_features", "300", "--device", "cpu"])
    t = tdb.Database(str(tmp_path / "a.db"), must_exist=True)
    kp, desc = t.read_keypoints(ids[0]), t.read_descriptors(ids[0])
    assert 0 < len(kp) <= 300 and desc.dtype == np.uint8 and desc.shape == (len(kp), 128)
    t.close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tcli.main(["feature_extractor", "--database_path", str(tmp_path / "b.db"),
                       "--image_path", d])


@pytest.mark.slow
def test_images_to_model_on_cpu(tmp_path):
    """The anchor scene (6 rendered 640 x 480 views of 300 points, PINHOLE
    with the true intrinsics, 2000 features) through feature_extractor,
    exhaustive_matcher and mapper on the CPU: at least 5 of 6 frames within
    2 deg and 0.25 units (tests/test_e2e_images.py's bounds); colmap_tpu
    registered 6/6 within 0.73 deg and 0.027 on this scene, the port 6/6
    within 0.7181 deg and 0.03023 (measured). About 90 s on a CPU (matcher
    30 s, mapper 55 s), so it is marked slow."""
    from colmap_tpu_torch.estimators.alignment import compare_reconstructions
    from colmap_tpu_torch.scene.reconstruction_io import read_model

    gt, _, params = SC.render_scene(str(tmp_path / "images"), 6, 300, 640, 480, 800.0)
    db, out = str(tmp_path / "db.db"), str(tmp_path / "sparse")
    tcli.main(["feature_extractor", "--database_path", db, "--image_path",
               str(tmp_path / "images"), "--camera_model", "PINHOLE", "--camera_params",
               ",".join(str(v) for v in params), "--max_num_features", "2000", "--device", "cpu"])
    assert tcli.main(["exhaustive_matcher", "--database_path", db, "--device", "cpu"]) >= 5
    tcli.main(["mapper", "--database_path", db, "--output_path", out, "--device", "cpu",
               "--quiet"])
    cmp = compare_reconstructions(read_model(os.path.join(out, "0")), gt)
    print(f"images -> model on the CPU: {cmp['num_common_images']}/6 frames, max rotation "
          f"error {cmp['max_rotation_error_deg']:.4f} deg, max center error "
          f"{cmp['max_center_error']:.5f} (colmap_tpu: 6/6, 0.73 deg, 0.027)")
    assert cmp["num_common_images"] >= 5
    assert cmp["max_rotation_error_deg"] < 2.0 and cmp["max_center_error"] < 0.25
