"""Line segment detection.

Counterpart of colmap_tpu/image/lines.py (reference behavior:
src/colmap/image/line.{h,cc} DetectLineSegments and
ClassifyLineSegmentOrientations, line.cc:92-112). The gradients and
level-line angles of the image run in K49 (kernels/lines.py) on the image's
device; the region growing is colmap_tpu's: connected components over
quantized level-line orientation bins (scipy.ndimage on the host, two
half-shifted binnings), a weighted PCA line fit per component with the
density and length tests, and the de-duplication of the two binnings.

One change of method, none of result: colmap_tpu collects each component's
pixels with ``np.nonzero(labels == comp)``, a scan of the whole label image
per component. Here the strong pixels of a bin are grouped by label once,
with a stable argsort of their labels: each group keeps row-major order, so
each component's pixels, its weighted averages and the order in which
segments are appended are colmap_tpu's, and so are the segments the
de-duplication keeps. The de-duplication, quadratic in Python in
colmap_tpu (a loop over the kept segments for each segment: ~26 s for a
3072 x 2304 facade view's 4000 segments), holds each segment against all
kept ones in one vectorized test; it keeps the same segments in the same
order.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List

import numpy as np
import torch

from colmap_tpu_torch.kernels import lines as KL
from colmap_tpu_torch.utils.dtypes import resolve_device


class LineSegmentOrientation(enum.IntEnum):
    """reference: image/line.h LineSegmentOrientation."""

    UNDEFINED = 0
    HORIZONTAL = 1
    VERTICAL = -1


@dataclasses.dataclass
class LineSegment:
    """reference: image/line.h LineSegment {start, end}."""

    start: np.ndarray  # (2,) xy
    end: np.ndarray  # (2,) xy

    @property
    def length(self) -> float:
        return float(np.linalg.norm(self.end - self.start))

    def direction(self) -> np.ndarray:
        d = self.end - self.start
        return d / max(np.linalg.norm(d), 1e-12)


@dataclasses.dataclass
class LineDetectionOptions:
    # Gradient magnitude below which pixels are ignored (LSD: rho).
    min_gradient: float = 5.0
    # Number of orientation bins for the level-line quantization (LSD's
    # 22.5 degree tolerance: 8 bins over 180 degrees).
    num_orientation_bins: int = 8
    # Minimum fraction of component pixels within the fitted rectangle width.
    min_density: float = 0.5
    max_width: float = 3.0


def image_gradients(image, device=None):
    """(magnitude, angle) float32 numpy arrays of a grayscale image (K49 on
    ``device``)."""
    img = torch.as_tensor(np.ascontiguousarray(image, dtype=np.float32))
    mag, angle = KL.line_gradients(img.to(resolve_device(device)))
    return mag.cpu().numpy(), angle.cpu().numpy()


def _components(mask):
    """Each 8-connected component of ``mask`` with at least one pixel, as
    (label, flat pixel indices in row-major order), labels ascending."""
    from scipy import ndimage

    labels, n = ndimage.label(mask, structure=np.ones((3, 3)))
    if n == 0:
        return labels, np.zeros(1, dtype=np.int64), None, None
    flat = labels.ravel()
    pix = np.flatnonzero(flat)
    order = np.argsort(flat[pix], kind="stable")
    sizes = np.bincount(flat, minlength=n + 1)
    sizes[0] = 0
    starts = np.concatenate([[0], np.cumsum(sizes[1:])])
    return labels, sizes, pix[order], starts


def detect_line_segments(
    image: np.ndarray,
    min_length: float = 3.0,
    options: LineDetectionOptions = LineDetectionOptions(),
    device=None,
) -> List[LineSegment]:
    """Line segments of length >= min_length in a grayscale image
    (reference behavior: DetectLineSegments, image/line.cc:52): K49's
    gradients on ``device``, then ``segments_from_gradients``."""
    img = np.asarray(image, dtype=np.float32)
    if img.ndim == 3:
        img = img.mean(axis=2)
    mag, angle = image_gradients(img, device)
    return segments_from_gradients(mag, angle, min_length, options)


def segments_from_gradients(mag: np.ndarray, angle: np.ndarray, min_length: float = 3.0,
                            options: LineDetectionOptions = LineDetectionOptions()
                            ) -> List[LineSegment]:
    """The host part of the detector on float32 (magnitude, level-line angle)
    arrays: components of strong pixels in each orientation bin of two
    half-shifted binnings, a weighted PCA line fit with the rectangle tests
    per component, and the de-duplication of the two binnings (colmap_tpu's
    lines.py:85-167)."""
    W = mag.shape[1]

    strong = mag >= options.min_gradient
    nbins = options.num_orientation_bins
    bins = np.minimum((angle / np.pi * nbins).astype(np.int32), nbins - 1)

    segments: List[LineSegment] = []
    min_pixels = max(int(min_length), 3)
    shifted = np.minimum(
        (((angle + np.pi / (2 * nbins)) % np.pi) / np.pi * nbins).astype(np.int32), nbins - 1)
    # Two half-shifted binnings so lines straddling a bin edge are not split.
    for b in (bins, shifted):
        for k in range(nbins):
            mask = strong & (b == k)
            if not mask.any():
                continue
            _, sizes, grouped, starts = _components(mask)
            for comp in np.nonzero(sizes >= min_pixels)[0]:
                if comp == 0:
                    continue
                ys, xs = np.divmod(grouped[starts[comp - 1]:starts[comp]], W)
                w = mag[ys, xs]
                cx, cy = np.average(xs, weights=w), np.average(ys, weights=w)
                dx, dy = xs - cx, ys - cy
                cov = np.array([
                    [np.average(dx * dx, weights=w), np.average(dx * dy, weights=w)],
                    [np.average(dx * dy, weights=w), np.average(dy * dy, weights=w)],
                ])
                evals, evecs = np.linalg.eigh(cov)
                major = evecs[:, 1]
                # Rectangle tests: elongated and dense (LSD's rectangle
                # approximation and density test).
                half_len = 2.0 * np.sqrt(max(evals[1], 0.0))
                half_wid = 2.0 * np.sqrt(max(evals[0], 0.0))
                if 2 * half_len < min_length or half_wid > options.max_width:
                    continue
                t = dx * major[0] + dy * major[1]
                s = -dx * major[1] + dy * major[0]
                inside = np.abs(s) <= max(half_wid, 1.0)
                if inside.mean() < options.min_density:
                    continue
                t0, t1 = t.min(), t.max()
                if t1 - t0 < min_length:
                    continue
                start = np.array([cx + t0 * major[0], cy + t0 * major[1]])
                end = np.array([cx + t1 * major[0], cy + t1 * major[1]])
                segments.append(LineSegment(start=start, end=end))
    return _deduplicate(segments)


def _deduplicate(segments: List[LineSegment]) -> List[LineSegment]:
    """colmap_tpu's de-duplication of the two binnings (lines.py:153-167):
    longest first, a segment is dropped when both its endpoints lie within
    2 px of a kept segment's endpoints, in either order. Each candidate is
    held against all kept segments at once (one vectorized test instead of a
    Python loop over them); the segments kept and their order are
    colmap_tpu's."""
    kept: List[LineSegment] = []
    starts = np.empty((len(segments), 2))
    ends = np.empty((len(segments), 2))

    def near(a, b):
        d = a - b
        return np.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) < 2.0

    for seg in sorted(segments, key=lambda s: -s.length):
        k = len(kept)
        s0, e0 = starts[:k], ends[:k]
        if k and ((near(s0, seg.start) & near(e0, seg.end))
                  | (near(e0, seg.start) & near(s0, seg.end))).any():
            continue
        starts[k], ends[k] = seg.start, seg.end
        kept.append(seg)
    return kept


def classify_line_segment_orientations(
    segments: List[LineSegment], tolerance: float = 0.25
) -> List[LineSegmentOrientation]:
    """reference behavior: ClassifyLineSegmentOrientations (line.cc:92-112)."""
    if tolerance > 0.5:
        raise ValueError("tolerance must be <= 0.5")
    out = []
    for seg in segments:
        d = seg.direction()
        if abs(d[0]) + tolerance > 1:
            out.append(LineSegmentOrientation.HORIZONTAL)
        elif abs(d[1]) + tolerance > 1:
            out.append(LineSegmentOrientation.VERTICAL)
        else:
            out.append(LineSegmentOrientation.UNDEFINED)
    return out
