"""SIFT feature extraction: image -> keypoints and uint8 descriptors.

Counterpart of colmap_tpu/feature/sift.py (reference behavior:
src/colmap/feature/sift.{h,cc}, the VLFeat path: first_octave=-1,
num_octaves=4, octave_resolution=3, peak_threshold=0.02/3,
edge_threshold=10, max_num_orientations=2, L1_ROOT, max_num_features=8192).

The host walks the octaves in order; each octave runs four kernels
(kernels/sift.py): K13 builds its Gaussian stack and DoG, K14 finds and
refines the DoG extrema, the ``max_candidates_per_octave`` highest by |DoG|
are selected (``select_candidates``), K15 assigns orientations and K16
describes each (keypoint, orientation) row and quantizes it to uint8. The
octave's surviving rows are scaled to input pixels by 0.5 * 2^octave (with
first_octave -1), and the cut to ``max_num_features`` by |response| is a
stable sort. One octave's pyramid lives on the device at a time.

colmap_tpu's power-of-two keypoint buckets, its two device programs with
packed transfers, ``approx_max_k`` and its bf16 windowed gradient sampling
are TPU workarounds and are not carried over: the port samples gradients
exactly, as colmap_tpu does for octaves under 130 px.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from colmap_tpu_torch.kernels import sift as K
from colmap_tpu_torch.utils.dtypes import resolve_device


@dataclasses.dataclass(frozen=True)
class SiftOptions:
    max_num_features: int = 8192
    first_octave: int = -1  # -1: upsample input 2x first
    num_octaves: int = 4
    octave_resolution: int = 3
    peak_threshold: float = 0.02 / 3
    edge_threshold: float = 10.0
    max_num_orientations: int = 2
    sigma0: float = 1.6  # base scale of each octave
    # Candidate extrema kept per octave, the highest |DoG| first.
    max_candidates_per_octave: int = 4096
    # Fix orientation to 0 for upright features (reference: sift.h upright).
    upright: bool = False
    # Domain-size pooling (DSP-SIFT): average the raw descriptor over
    # dsp_num_scales window sizes in [dsp_min_scale, dsp_max_scale] x sigma
    # before normalization (reference: sift.h:76-84).
    domain_size_pooling: bool = False
    dsp_min_scale: float = 1.0 / 6.0
    dsp_max_scale: float = 3.0
    dsp_num_scales: int = 10
    # Descriptor normalization (reference: sift.h Normalization).
    normalization: str = "L1_ROOT"  # "L1_ROOT" | "L2"
    # Affine-covariant shape adaptation (Baumberg iteration, reference
    # sift.cc:393-395); keypoints then are affine frames (x, y, a11, a12,
    # a21, a22). The plain version only: on a CUDA device it raises.
    estimate_affine_shape: bool = False
    affine_shape_iterations: int = 5


def _num_octaves(shape, options: SiftOptions) -> int:
    """Octave count for an input shape: octaves down to 32 px."""
    h, w = shape
    if options.first_octave < 0:
        h, w = 2 * h, 2 * w
    n = 0
    while n < options.num_octaves and min(h, w) >= 32:
        n += 1
        h, w = -(-h // 2), -(-w // 2)
    return n


class _Ops(NamedTuple):
    """The functions of the device program: the kernel wrappers, or (for a
    check on the card, through ``_extract``) the plain versions."""

    upsample2: Callable
    blur: Callable
    build_octave: Callable
    downsample2: Callable
    detect_extrema: Callable
    orientations: Callable
    descriptors: Callable


KERNELS = _Ops(K.upsample2, K.blur, K.build_octave, K.downsample2, K.detect_extrema,
               K.orientations, K.descriptors)


def _descriptors_plain_u8(gauss, x, y, lvl, sigma, response, theta, ok, options):
    """K16's plain version with the kernel wrapper's signature and outputs."""
    data, _, desc = K.descriptors_plain(gauss, x, y, lvl, sigma, response, theta, options)
    return data, desc


PLAIN = _Ops(K.upsample2_plain, K.blur_plain, K.build_octave_plain, K.downsample2_plain,
             K.detect_extrema_plain, K.orientations_plain, _descriptors_plain_u8)


def _describe_octave(gauss, ext: K.Extrema, sel, options: SiftOptions, ops: _Ops):
    """Orientations and descriptors of the selected candidates ``sel`` of
    one octave: data rows (R, 9) in octave pixels and uint8 descriptors
    (R, 128), only the rows with an orientation, grouped by keypoint."""
    x, y, lvl, sigma, response = K.selected_keypoints(ext, sel)
    if options.estimate_affine_shape:
        shapes = K.affine_shapes(gauss, x, y, lvl, sigma, options)
        theta, ok = K.orientations_plain(gauss, x, y, lvl, sigma, options, shapes)
        data, _, desc = K.descriptors_plain(gauss, x, y, lvl, sigma, response, theta, options,
                                            shapes)
    else:
        theta, ok = ops.orientations(gauss, x, y, lvl, sigma, options)
        data, desc = ops.descriptors(gauss, x, y, lvl, sigma, response, theta, ok, options)
    ok = ok.reshape(-1)
    return data[ok], desc[ok]


def _extract(img: torch.Tensor, options: SiftOptions, n_octaves: int, ops: _Ops = KERNELS):
    """The device program on an (H, W) float tensor: keypoint rows (N, 9)
    [x, y, sigma, theta, response, frame] in input pixels and uint8
    descriptors (N, 128), octave by octave, before the cut to
    max_num_features; None when no octave has a keypoint."""
    base = ops.upsample2(img) if options.first_octave < 0 else img
    base = ops.blur(base, options.sigma0)
    scale0 = 0.5 if options.first_octave < 0 else 1.0
    datas, descs = [], []
    for octave in range(n_octaves):
        gauss, dog = ops.build_octave(base, options)
        ext = ops.detect_extrema(dog, options)
        del dog
        sel = K.select_candidates(ext, options.max_candidates_per_octave)
        if sel.numel():
            data, desc = _describe_octave(gauss, ext, sel, options, ops)
            scale = scale0 * 2.0**octave
            # x, y, sigma and the frame scale to input pixels; theta and the
            # response do not.
            factor = torch.tensor([scale, scale, scale, 1.0, 1.0, scale, scale, scale, scale],
                                  dtype=data.dtype, device=data.device)
            datas.append(data * factor)
            descs.append(desc)
        if octave + 1 < n_octaves:
            base = ops.downsample2(gauss[options.octave_resolution])
    if not datas:
        return None
    return torch.cat(datas), torch.cat(descs)


def cut_to_max_features(kp: np.ndarray, desc: np.ndarray, options: SiftOptions):
    """The host's cut: the max_num_features rows of largest |response|
    (a stable sort), then the (N, 4) or, with estimate_affine_shape,
    (N, 6) keypoint layout."""
    if len(kp) > options.max_num_features:
        order = np.argsort(-np.abs(kp[:, 4]), kind="stable")[: options.max_num_features]
        kp, desc = kp[order], desc[order]
    if options.estimate_affine_shape:
        return np.concatenate([kp[:, :2], kp[:, 5:9]], axis=1).astype(np.float32), desc
    return kp[:, :4].astype(np.float32), desc


def extract_sift(image: np.ndarray, options: SiftOptions = None,
                 device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Full SIFT extraction for a grayscale image on ``device`` (default
    cuda; the CPU runs the plain versions in float32).

    Args:
        image: (H, W) float in [0, 1] or uint8.
    Returns:
        keypoints: (N, 4) float32 [x, y, scale, orientation] in input
            pixels; with estimate_affine_shape, (N, 6) affine frames
            [x, y, a11, a12, a21, a22].
        descriptors: (N, 128) uint8.
    """
    options = options or SiftOptions()
    device = resolve_device(device)
    img = np.asarray(image)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    n_cols = 6 if options.estimate_affine_shape else 4
    n_octaves = _num_octaves(img.shape, options)
    out = None
    if n_octaves:
        img_t = torch.from_numpy(np.ascontiguousarray(img, dtype=np.float32)).to(device)
        out = _extract(img_t, options, n_octaves)
    if out is None:
        return np.zeros((0, n_cols), np.float32), np.zeros((0, 128), np.uint8)
    return cut_to_max_features(out[0].cpu().numpy(), out[1].cpu().numpy(), options)
