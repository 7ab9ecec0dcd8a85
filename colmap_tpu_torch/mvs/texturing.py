"""Mesh texture mapping: per-face view selection, atlas packing, OBJ
(colmap_tpu/mvs/texturing.py).

reference behavior: src/colmap/mvs/texture_mapping.{h,cc} — selects a source
view per face (quality = projected gradient magnitude), smooths labels with
a graph cut, packs per-face patches into texture atlases, writes OBJ/MTL.
colmap_tpu keeps the three phases and vectorizes them; the port runs them
as torch ops on the caller's device, in float64 but for the projections
(float32 on the card):

  1. view selection: all faces x all views scored at once (cosine of the
     viewing angle x the square root of the projected area, back faces and
     faces leaving the image culled; the projections through the camera-map
     wrapper, K5 on the card), then a majority relabel over face adjacency
     (the graph-cut analogue) with colmap_tpu's rules;
  2. packing (host numpy): two right-triangle patches per square atlas
     cell, constant patch size, one gutter pixel;
  3. sampling: one bilinear gather over every face's texels from the
     images of their views, all images in one flat buffer.

Outputs a standard OBJ + MTL + PNG bundle.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch

from colmap_tpu_torch.kernels import sfm as camera_map
from colmap_tpu_torch.utils.dtypes import floatx, resolve_device

f64 = torch.float64
PINHOLE = 1


@dataclasses.dataclass
class TextureMappingOptions:
    """reference: mvs/texture_mapping.h:41-58 (subset)."""

    patch_size: int = 16  # texels per triangle patch edge
    max_atlas_size: int = 4096
    smoothing_iterations: int = 2


def _views_tensors(views, dev):
    """Per view: PINHOLE parameters (fx, fy, cx, cy) of its K, R and t."""
    K = np.stack([v["K"] for v in views])
    cam = torch.as_tensor(np.stack([K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2]], 1),
                          dtype=f64, device=dev)
    R = torch.as_tensor(np.stack([v["R"] for v in views]), dtype=f64, device=dev)
    t = torch.as_tensor(np.stack([np.asarray(v["t"]) for v in views]), dtype=f64, device=dev)
    return cam, R, t


def _project(cam, R, t, X):
    """Pixels (..., 2) and depths (...) of points X (..., 3) in the PINHOLE
    cameras cam, R, t broadcast over the leading axes (colmap_tpu's
    ``_project``): the camera frame in float64, the projection by the
    camera-map wrapper (K5 on the card, in float32)."""
    x = torch.einsum("...ij,...j->...i", R, X) + t
    dtype = floatx(x.device)
    cam = torch.broadcast_to(cam, x.shape[:-1] + (4,))
    pix, _ = camera_map.img_from_cam(PINHOLE, cam.to(dtype), x.to(dtype))
    return pix.to(f64), x[..., 2]


def select_views(verts, faces, views, device="cuda"):
    """Score every face against every view.

    views: list of dicts with K, R, t (cam_from_world), width, height.
    Returns (labels (F,) int64 — index into views or -1, quality (F, V)
    float64), tensors on ``device``; a face takes the first view of the
    highest quality.
    """
    dev = resolve_device(device)
    V = torch.as_tensor(np.asarray(verts), dtype=f64, device=dev)
    Fc = torch.as_tensor(np.asarray(faces), dtype=torch.int64, device=dev)
    tri = V[Fc]  # (F, 3, 3)
    centers = tri.mean(dim=1)
    normals = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    normals = normals / torch.clamp(torch.linalg.norm(normals, dim=1, keepdim=True), min=1e-12)

    cam, R, t = _views_tensors(views, dev)
    C = -torch.einsum("vji,vj->vi", R, t)  # (V, 3) projection centres
    view_dir = centers[:, None, :] - C[None]  # (F, V, 3)
    dist = torch.linalg.norm(view_dir, dim=2)
    view_dir = view_dir / torch.clamp(dist[..., None], min=1e-12)
    cosang = -(normals[:, None, :] * view_dir).sum(dim=2)
    width = torch.as_tensor([v["width"] for v in views], dtype=f64, device=dev)
    height = torch.as_tensor([v["height"] for v in views], dtype=f64, device=dev)
    pix, z = _project(cam, R, t, tri[:, :, None, :])
    ok = (cosang > 0.05) & ((z > 1e-6) & (pix[..., 0] >= 0) & (pix[..., 1] >= 0)
                            & (pix[..., 0] < width - 1) & (pix[..., 1] < height - 1)).all(dim=1)
    a = pix[:, 1] - pix[:, 0]
    b = pix[:, 2] - pix[:, 0]
    area = 0.5 * torch.abs(a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0])
    quality = torch.where(ok, cosang * torch.sqrt(torch.clamp(area, min=0)), -torch.inf)
    best, labels = quality.max(dim=1)
    labels = torch.where(best > -torch.inf, labels, -1)
    return labels, quality


def face_adjacency(faces, device="cuda"):
    """(a, b) face pairs, each once a direction, of colmap_tpu's adjacency:
    a face's edge (min, max) seen before pairs the face with the first face
    that had it."""
    dev = resolve_device(device)
    Fc = torch.as_tensor(np.asarray(faces), dtype=torch.int64, device=dev)
    e = torch.stack([Fc[:, [0, 1]], Fc[:, [1, 2]], Fc[:, [2, 0]]], dim=1).reshape(-1, 2)
    lo, hi = e.min(dim=1).values, e.max(dim=1).values
    keys = lo * (int(Fc.max()) + 1 if len(Fc) else 1) + hi
    sk, order = torch.sort(keys, stable=True)
    start = torch.ones_like(sk, dtype=torch.bool)
    start[1:] = sk[1:] != sk[:-1]
    pos = torch.arange(len(sk), device=dev)
    first = torch.cummax(torch.where(start, pos, 0), dim=0).values
    later = ~start
    a = order[later] // 3
    b = order[first[later]] // 3
    return torch.cat([a, b]), torch.cat([b, a])


def smooth_labels(faces, labels, quality, iterations=2, device="cuda"):
    """Majority relabeling over face adjacency (graph-cut analogue), all
    faces at once: a face takes the label most of its labelled neighbours
    carry (ties to the smallest label) where at least two carry it and its
    quality there exceeds 0.7 of its own label's (colmap_tpu reads a label
    of -1 as the last view)."""
    dev = resolve_device(device)
    labels = torch.as_tensor(labels, device=dev)
    if len(faces) == 0 or iterations <= 0:
        return labels
    quality = torch.as_tensor(quality, device=dev)
    F, V = quality.shape
    src, nbr = face_adjacency(faces, dev)
    rows = torch.arange(F, device=dev)
    for _ in range(iterations):
        lab = labels[nbr]
        keep = lab >= 0
        counts = torch.bincount(src[keep] * V + lab[keep], minlength=F * V).reshape(F, V)
        top, maj = counts.max(dim=1)
        change = ((top >= 2) & (maj != labels)
                  & (quality[rows, maj] > 0.7 * quality[rows, labels % V]))
        labels = torch.where(change, maj, labels)
    return labels


def atlas_layout(F, options):
    """colmap_tpu's packing: (patch size s, cell size, grid, atlas size,
    number of faces placed)."""
    s = options.patch_size
    cell = s + 2  # gutter
    cells = (F + 1) // 2
    grid = int(np.ceil(np.sqrt(cells)))
    atlas_size = min(options.max_atlas_size, int(2 ** np.ceil(np.log2(max(grid * cell, 64)))))
    grid = atlas_size // cell
    if grid * grid * 2 < F:
        # Shrink patches to fit.
        while grid * grid * 2 < F and s > 4:
            s -= 2
            cell = s + 2
            grid = atlas_size // cell
    return s, cell, grid, atlas_size, min(F, 2 * grid * grid)


def texture_mesh(verts, faces, views, images: Dict[int, np.ndarray],
                 options: Optional[TextureMappingOptions] = None, device="cuda"):
    """Build a texture atlas for the mesh.

    views: list of dicts {K, R, t, width, height, image_key}; images maps
    image_key -> (H, W, 3) uint8 array.
    Returns (atlas (A, A, 3) uint8, uvs (F, 3, 2) float64 in [0, 1], labels
    (F,) int64), numpy arrays.
    """
    if options is None:
        options = TextureMappingOptions()
    dev = resolve_device(device)
    labels, quality = select_views(verts, faces, views, dev)
    labels = smooth_labels(faces, labels, quality, options.smoothing_iterations, dev)

    F = len(faces)
    s, cell, grid, atlas_size, placed = atlas_layout(F, options)
    fi = np.arange(placed)
    gy, gx = np.divmod(fi // 2, grid)
    y0, x0 = gy * cell + 1, gx * cell + 1
    half = fi % 2
    lo = np.stack([np.stack([x0, y0], 1), np.stack([x0 + s - 1, y0], 1),
                   np.stack([x0, y0 + s - 1], 1)], 1)
    up = np.stack([np.stack([x0 + s - 1, y0 + s - 1], 1), np.stack([x0, y0 + s - 1], 1),
                   np.stack([x0 + s - 1, y0], 1)], 1)
    uvs = np.zeros((F, 3, 2), dtype=np.float64)
    uvs[:placed] = np.where(half[:, None, None] == 0, lo, up)

    atlas = torch.full((atlas_size, atlas_size, 3), 128, dtype=torch.uint8, device=dev)
    keys = [v["image_key"] for v in views]
    have = torch.as_tensor([k in images for k in keys] + [False], device=dev)
    lab = labels[:placed]
    todo = torch.nonzero((lab >= 0) & have[lab]).flatten()
    if len(todo):
        _sample_faces(atlas, verts, faces, views, images, lab, todo, s, cell, grid, dev)

    uvs[:, :, 0] = (uvs[:, :, 0] + 0.5) / atlas_size
    uvs[:, :, 1] = 1.0 - (uvs[:, :, 1] + 0.5) / atlas_size  # OBJ v-flip
    return atlas.cpu().numpy(), uvs, labels.cpu().numpy()


def _sample_faces(atlas, verts, faces, views, images, labels, todo, s, cell, grid, dev):
    """Every texel of the faces ``todo``: its barycentric pixel in the face's
    view, one bilinear gather from a flat buffer of all the views' images,
    written into the atlas."""
    # The views' images, concatenated; per view its offset, width, height.
    flat, offsets, sizes, off = [], [], [], 0
    for v in views:
        img = images.get(v["image_key"])
        h, w = (img.shape[:2] if img is not None else (2, 2))
        offsets.append(off)
        sizes.append((w, h))
        if img is not None:
            flat.append(torch.as_tensor(np.ascontiguousarray(img).reshape(-1, 3), device=dev))
            off += h * w
    buf = torch.cat(flat).to(f64)
    offsets = torch.as_tensor(offsets, dtype=torch.int64, device=dev)
    wh = torch.as_tensor(sizes, dtype=torch.int64, device=dev)

    lab = labels[todo]
    cam, R, t = _views_tensors(views, dev)
    Vt = torch.as_tensor(np.asarray(verts), dtype=f64, device=dev)
    Fc = torch.as_tensor(np.asarray(faces), dtype=torch.int64, device=dev)
    tri = Vt[Fc[todo]]  # (T, 3, 3)
    pix, _ = _project(cam[lab][:, None], R[lab][:, None], t[lab][:, None], tri)  # (T, 3, 2)

    ii, jj = torch.meshgrid(torch.arange(s, device=dev), torch.arange(s, device=dev),
                            indexing="ij")
    lower = ii + jj <= s - 1
    denom = max(s - 1, 1)
    ii, jj = ii.to(f64), jj.to(f64)
    l_b, l_c = jj / denom, ii / denom
    u_b, u_c = (s - 1 - jj) / denom, (s - 1 - ii) / denom
    weights = torch.stack([torch.stack([1.0 - l_b - l_c, l_b, l_c]),
                           torch.stack([1.0 - u_b - u_c, u_b, u_c])])  # (2, 3, s, s)
    half = (todo % 2)
    wa, wb, wc = weights[half].unbind(1)  # each (T, s, s)
    px = wa * pix[:, 0, 0, None, None] + wb * pix[:, 1, 0, None, None] + wc * pix[:, 2, 0, None, None]
    py = wa * pix[:, 0, 1, None, None] + wb * pix[:, 1, 1, None, None] + wc * pix[:, 2, 1, None, None]
    W = wh[lab, 0][:, None, None]
    H = wh[lab, 1][:, None, None]
    xi = torch.minimum(torch.clamp(px, min=0), (W - 2).to(f64))
    yi = torch.minimum(torch.clamp(py, min=0), (H - 2).to(f64))
    x0i, y0i = xi.to(torch.int64), yi.to(torch.int64)
    fx, fy = (xi - x0i)[..., None], (yi - y0i)[..., None]
    base = offsets[lab][:, None, None] + y0i * W + x0i
    c00, c01 = buf[base], buf[base + 1]
    c10, c11 = buf[base + W], buf[base + W + 1]
    col = (c00 * (1 - fx) * (1 - fy) + c01 * fx * (1 - fy) + c10 * (1 - fx) * fy
           + c11 * fx * fy)
    mask = torch.where(half[:, None, None] == 0, lower, ~lower)
    gy, gx = todo // 2 // grid, todo // 2 % grid
    ay = (gy * cell + 1)[:, None, None] + ii.to(torch.int64)
    ax = (gx * cell + 1)[:, None, None] + jj.to(torch.int64)
    atlas[ay[mask], ax[mask]] = torch.clamp(col[mask], 0, 255).to(torch.uint8)


def write_obj(path, verts, faces, uvs, atlas):
    """Write the OBJ + MTL + PNG texture bundle."""
    from colmap_tpu_torch.utils.image_io import write_png

    base = os.path.splitext(path)[0]
    name = os.path.basename(base)
    write_png(base + ".png", np.ascontiguousarray(atlas, dtype=np.uint8))
    with open(base + ".mtl", "w") as f:
        f.write(f"newmtl textured\nKa 1 1 1\nKd 1 1 1\nmap_Kd {name}.png\n")
    lines = [f"mtllib {name}.mtl\nusemtl textured\n"]
    lines += [f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n" for v in np.asarray(verts).tolist()]
    lines += [f"vt {u:.6f} {v:.6f}\n" for u, v in np.asarray(uvs).reshape(-1, 2).tolist()]
    lines += [f"f {a + 1}/{3 * i + 1} {b + 1}/{3 * i + 2} {c + 1}/{3 * i + 3}\n"
              for i, (a, b, c) in enumerate(np.asarray(faces).tolist())]
    with open(path, "w") as f:
        f.write("".join(lines))
