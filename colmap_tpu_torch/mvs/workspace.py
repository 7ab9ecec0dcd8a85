"""Dense-reconstruction workspace: problem setup and batch driving
(colmap_tpu/mvs/workspace.py).

reference behavior: src/colmap/mvs/workspace.h:46-136 and
mvs/patch_match.{h,cc} — the undistorted workspace layout
(images/ + sparse/ + stereo/{depth_maps,normal_maps}), per-reference-image
source-view selection from shared sparse points, depth ranges from the
sparse model, and the photometric (then geometric) PatchMatch pass over all
problems, one reference image at a time on one device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from colmap_tpu_torch.mvs.depth_map import read_map, write_map
from colmap_tpu_torch.mvs.patch_match import PatchMatchOptions, PatchMatchProblem, patch_match
from colmap_tpu_torch.scene.reconstruction import Reconstruction
from colmap_tpu_torch.scene.types import INVALID_POINT3D
from colmap_tpu_torch.sensor import models as camera_models
from colmap_tpu_torch.utils.dtypes import resolve_device


@dataclasses.dataclass
class PatchMatchProblemSpec:
    ref_image_id: int
    src_image_ids: List[int]
    depth_min: float
    depth_max: float


def select_patch_match_problems(
    recon: Reconstruction, max_num_src_images: int = 5
) -> List[PatchMatchProblemSpec]:
    """Per-reference-image source selection + depth ranges.

    reference behavior: PatchMatchController::ReadProblems (__auto__ mode:
    rank source images by number of shared sparse points,
    mvs/patch_match.cc:239); depth range = robust min/max of the sparse
    depths (with margins).
    """
    problems = []
    for ref_id in recon.reg_image_ids():
        ref_img = recon.images[ref_id]
        shared: Dict[int, int] = {}
        depths = []
        pose = recon.cam_from_world(ref_id)
        for pid in ref_img.points2D_p3d:
            if pid == INVALID_POINT3D:
                continue
            point = recon.points3D[int(pid)]
            depths.append(float(pose.apply(point.xyz[None])[0, 2]))
            for el in point.track:
                if el.image_id != ref_id:
                    shared[el.image_id] = shared.get(el.image_id, 0) + 1
        if len(depths) < 5 or not shared:
            continue
        srcs = sorted(shared, key=shared.get, reverse=True)[:max_num_src_images]
        lo, hi = np.percentile(np.array(depths), [1, 99])
        problems.append(PatchMatchProblemSpec(
            ref_image_id=ref_id, src_image_ids=srcs,
            depth_min=float(max(lo * 0.8, 1e-3)), depth_max=float(hi * 1.2)))
    return problems


def _pinhole_K(camera) -> np.ndarray:
    f_idxs = camera_models.focal_length_idxs(camera.model_id)
    pp = camera_models.principal_point_idxs(camera.model_id)
    fx = camera.params[f_idxs[0]]
    fy = camera.params[f_idxs[1]] if len(f_idxs) > 1 else fx
    return np.array(
        [[fx, 0, camera.params[pp[0]]], [0, fy, camera.params[pp[1]]], [0, 0, 1.0]]
    )


def run_patch_match_workspace(
    recon: Reconstruction,
    images,
    output_dir: str,
    options: Optional[PatchMatchOptions] = None,
    max_num_src_images: int = 5,
    problems: Optional[List[PatchMatchProblemSpec]] = None,
    geom_consistency: bool = False,
    write_consistency_graph: bool = False,
    device="cuda",
) -> List[PatchMatchProblemSpec]:
    """Run PatchMatch for every reference image on ``device`` and write
    COLMAP-format depth/normal maps under output_dir/stereo/.

    images: {image_id: (H, W) grayscale float [0,1]} — undistorted
    (PINHOLE) images matching the reconstruction's cameras; all of one
    problem's views must have one size.

    With geom_consistency=True a second pass re-optimizes every image with
    the forward-backward reprojection term against the neighbors'
    first-pass depth maps and writes *.geometric.bin
    (reference: PatchMatchController photometric then geometric pass,
    mvs/patch_match.cc:170-207).
    """
    dev = resolve_device(device)
    stereo = os.path.join(output_dir, "stereo")
    os.makedirs(os.path.join(stereo, "depth_maps"), exist_ok=True)
    os.makedirs(os.path.join(stereo, "normal_maps"), exist_ok=True)
    if write_consistency_graph:
        os.makedirs(os.path.join(stereo, "consistency_graphs"), exist_ok=True)
    if problems is None:
        problems = select_patch_match_problems(recon, max_num_src_images)
    id_to_model_idx = {iid: k for k, iid in enumerate(recon.reg_image_ids())}

    def tensor(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32).to(dev)

    def build_problem(spec, src_depth_lookup=None):
        ref_img = recon.images[spec.ref_image_id]
        ref_pose = recon.cam_from_world(spec.ref_image_id)
        srcs, K_srcs, R_rels, t_rels, s_depths, kept_ids = [], [], [], [], [], []
        for sid in spec.src_image_ids:
            if sid not in images:
                continue
            s_img = recon.images[sid]
            rel = recon.cam_from_world(sid).compose(ref_pose.inverse())
            if src_depth_lookup is not None:
                d = src_depth_lookup(s_img.name)
                if d is None:
                    continue
                s_depths.append(d)
            srcs.append(np.asarray(images[sid]))
            K_srcs.append(_pinhole_K(recon.cameras[s_img.camera_id]))
            R_rels.append(rel.rotmat())
            t_rels.append(rel.t)
            kept_ids.append(sid)
        if not srcs:
            return None, None, None
        ref = np.asarray(images[spec.ref_image_id])
        sizes = {a.shape for a in [ref] + srcs + s_depths}
        if len(sizes) != 1:
            raise ValueError(f"image {ref_img.name}: its views have different sizes {sizes}; "
                             "PatchMatch takes views of one size")
        problem = PatchMatchProblem(
            ref_image=tensor(ref), src_images=tensor(np.stack(srcs)),
            K_ref=tensor(_pinhole_K(recon.cameras[ref_img.camera_id])),
            K_src=tensor(np.stack(K_srcs)), R_rel=tensor(np.stack(R_rels)),
            t_rel=tensor(np.stack(t_rels)),
            src_depths=tensor(np.stack(s_depths)) if src_depth_lookup is not None else None)
        return problem, ref_img.name, kept_ids

    def run_pass(suffix, src_depth_lookup=None):
        for spec in problems:
            problem, name, kept_ids = build_problem(spec, src_depth_lookup)
            if problem is None:
                continue
            opts = dataclasses.replace(options or PatchMatchOptions(),
                                       depth_min=spec.depth_min, depth_max=spec.depth_max)
            # The reference-style consistency filter (viewing angles +
            # selection probability + geometric term when available) zeroes
            # pixels with fewer than filter_min_num_consistent views
            # (patch_match_cuda.cu:1209-1276).
            depth, normal, _, mask = patch_match(problem, opts, return_consistency=True)
            write_map(os.path.join(stereo, "depth_maps", f"{name}.{suffix}.bin"),
                      depth.cpu().numpy())
            write_map(os.path.join(stereo, "normal_maps", f"{name}.{suffix}.bin"),
                      normal.cpu().numpy())
            if write_consistency_graph:
                from colmap_tpu_torch.mvs.consistency_graph import ConsistencyGraph

                # Reference semantics (patch_match_cuda.cu:1377): the graph
                # stores indices into the workspace model's image array
                # (position in RegImageIds() order, mvs/model.cc:65-83), not
                # database image ids.
                src_idxs = [id_to_model_idx[i] for i in kept_ids]
                ConsistencyGraph.from_mask(mask.cpu().numpy(), src_idxs).write(
                    os.path.join(stereo, "consistency_graphs", f"{name}.{suffix}.bin"))

    run_pass("photometric")
    if geom_consistency:
        depth_dir = os.path.join(stereo, "depth_maps")

        def lookup(name):
            p = os.path.join(depth_dir, f"{name}.photometric.bin")
            return read_map(p) if os.path.exists(p) else None

        run_pass("geometric", lookup)
    return problems


def run_fusion_workspace(
    recon: Reconstruction,
    workspace_dir: str,
    output_path: str,
    fusion_options=None,
    device="cuda",
):
    """Fuse the workspace depth maps into a point cloud PLY on ``device``.

    reference behavior: StereoFusion over the workspace (mvs/fusion.cc) +
    fused.ply output.
    """
    from colmap_tpu_torch.mvs.fusion import (
        FusionImage,
        FusionOptions,
        fuse_depth_maps,
        write_fused_vis,
    )
    from colmap_tpu_torch.utils.ply import write_ply

    images = []
    for iid in recon.reg_image_ids():
        img = recon.images[iid]
        # Prefer geometric-consistency maps when present (reference:
        # StereoFusion input_type geometric default).
        dpath = npath = None
        for suffix in ("geometric", "photometric"):
            d = os.path.join(workspace_dir, "stereo", "depth_maps", f"{img.name}.{suffix}.bin")
            n = os.path.join(workspace_dir, "stereo", "normal_maps", f"{img.name}.{suffix}.bin")
            if os.path.exists(d) and os.path.exists(n):
                dpath, npath = d, n
                break
        if dpath is None:
            continue
        pose = recon.cam_from_world(iid)
        images.append(FusionImage(iid, _pinhole_K(recon.cameras[img.camera_id]), pose.rotmat(),
                                  pose.t, read_map(dpath), read_map(npath)))
    pts, normals, vis = fuse_depth_maps(images, fusion_options or FusionOptions(), device=device)
    write_ply(output_path, pts, normals)
    write_fused_vis(output_path + ".vis", vis)
    return pts, normals, vis


class CachedWorkspace:
    """Memory-bounded cached access to the dense workspace's per-image
    files.

    reference behavior: mvs/workspace.h:46-136 — `Workspace` serves
    bitmap/depth/normal pages through a MemoryConstrainedLRUCache sized by
    the `cache_size` (GB) option so arbitrarily large scenes stream through
    bounded host memory. Bitmaps are read by utils/image_io.py as PIL's
    ``convert("L")`` would read them.
    """

    def __init__(self, workspace_path: str, cache_size_gb: float = 32.0):
        from colmap_tpu_torch.utils.cache import MemoryConstrainedLRUCache

        self.workspace_path = workspace_path
        self._cache = MemoryConstrainedLRUCache(int(cache_size_gb * (1 << 30)), self._load)

    # -- path helpers (reference: Workspace::Get*Path) -------------------
    def bitmap_path(self, image_name: str) -> str:
        return os.path.join(self.workspace_path, "images", image_name)

    def depth_map_path(self, image_name: str, suffix: str) -> str:
        return os.path.join(self.workspace_path, "stereo", "depth_maps",
                            f"{image_name}.{suffix}.bin")

    def normal_map_path(self, image_name: str, suffix: str) -> str:
        return os.path.join(self.workspace_path, "stereo", "normal_maps",
                            f"{image_name}.{suffix}.bin")

    # -- cached getters (reference: Workspace::Get{Bitmap,DepthMap,...}) --
    def _load(self, key):
        kind, name, suffix = key
        if kind == "bitmap":
            from colmap_tpu_torch.utils.image_io import read_image_gray

            return read_image_gray(self.bitmap_path(name)).astype(np.float32) / 255.0
        path = (self.depth_map_path(name, suffix) if kind == "depth"
                else self.normal_map_path(name, suffix))
        return read_map(path)

    def get_bitmap(self, image_name: str) -> np.ndarray:
        return self._cache.get(("bitmap", image_name, ""))

    def get_depth_map(self, image_name: str, suffix: str = "photometric"):
        return self._cache.get(("depth", image_name, suffix))

    def get_normal_map(self, image_name: str, suffix: str = "photometric"):
        return self._cache.get(("normal", image_name, suffix))

    def has_bitmap(self, image_name: str) -> bool:
        return os.path.exists(self.bitmap_path(image_name))

    def image_map(self, recon: Reconstruction):
        """Lazy {image_id: grayscale bitmap} mapping for
        run_patch_match_workspace — images page in through the cache."""
        ws = self

        class _Map:
            def __contains__(self, iid):
                img = recon.images.get(iid)
                return img is not None and ws.has_bitmap(img.name)

            def __getitem__(self, iid):
                return ws.get_bitmap(recon.images[iid].name)

        return _Map()
