"""Cases for tools/kernel_ab.py at chip_smoke.py's shapes, through the
port's wrappers, which a parent checkout shares with its change.

descend:ROWS     K30 on the first ROWS rows of the retrieval phases' corpus
                 (retrieval_cases.corpus(1000, 2000, seed=0)) through the
                 branching-8, depth-5 tree that vocab_tree_builder trains on
                 its 200 000-row rng(0) sample (built once, in cache_dir).
spectral:DEPTH   K43 in place on rfftn(randn(N^3)) (torch.Generator seed
                 DEPTH, N = 2^DEPTH) and torch.div(spec, lam) beside it.
patchmatch:MODE  K18, parity 0, on mvs_cases.plane_case(2304, 3072, 5, seed=0):
                 a 3072 x 2304 reference and five sources, as the dense
                 phase's problems, photometric as its first (MODE weights
                 or best_half; weights_geometric and best_half_geometric
                 add the source depth maps), the state, costs (K17) and
                 weights (K19) of the case; made once, in cache_dir.
schur:F:N:MODEL  K3's matvec on synthetic_ba_problem(F, N, min(F, 6),
                 model_id=MODEL, seed=0), packed: its Jacobians (K1),
                 H_pp^-1 (K2) and seeded x; 5:800:4 is the weighing's
                 heaviest class (791 points, capp 6, 5 frames, one camera,
                 P 8), 200:50000:2 the BA headline. The output's last bits
                 vary from run to run (atomics), so no digest.
"""

import os
import pickle

import numpy as np
import torch


def descend(rows, cache_dir):
    from colmap_tpu_torch.kernels import retrieval as KT
    from colmap_tpu_torch.kernels import retrieval_cases as TC
    from colmap_tpu_torch.retrieval.visual_index import build_vocabulary_tree

    corpus = TC.corpus(1000, 2000, seed=0).descriptors.reshape(-1, 128)
    tree_path = os.path.join(cache_dir, "tree_8_5.npy")
    if not os.path.exists(tree_path):
        sample = corpus[np.random.default_rng(0).choice(len(corpus), 200000, replace=False)]
        tree = build_vocabulary_tree(sample, 8, 5, device="cuda")
        np.save(tree_path, tree.concatenated.cpu().numpy())
    flat = torch.as_tensor(np.load(tree_path), device="cuda")
    x = torch.as_tensor(corpus[:int(rows)], dtype=torch.float32, device="cuda")
    call = lambda: KT.descend(x, flat, 8, 5)  # noqa: E731
    return [(f"K30 {rows} rows", call, call, 200 if len(x) < 100000 else 20)]


def spectral(depth, cache_dir):
    from colmap_tpu_torch.kernels import meshing as KM

    N = 1 << int(depth)
    g = torch.Generator().manual_seed(int(depth))
    spec = torch.fft.rfftn(torch.randn(N, N, N, generator=g).cuda())
    work = spec.clone()
    lam = KM.laplacian_eigenvalues(N, "cuda") - np.float32(1e-4)
    return [(f"K43 depth {depth}", lambda: KM.spectral_divide_(work, 1.0),
             lambda: torch.view_as_real(KM.spectral_divide_(spec.clone(), 1.0)), 20),
            (f"torch.div depth {depth}", lambda: torch.div(spec, lam), None, 20)]


def patchmatch(mode, cache_dir):
    from colmap_tpu_torch.kernels import mvs as KV
    from colmap_tpu_torch.kernels import mvs_cases as MC
    from colmap_tpu_torch.mvs.patch_match import PatchMatchOptions

    path = os.path.join(cache_dir, "plane_2304x3072x5.pkl")
    if not os.path.exists(path):
        with open(path, "wb") as f:
            pickle.dump(MC.plane_case(2304, 3072, 5, seed=0), f)
    with open(path, "rb") as f:
        case = pickle.load(f)
    geometric = mode.endswith("_geometric")
    weighted = mode.removesuffix("_geometric") == "weights"
    p, d, n, sel, dr = MC.tensors(case, "cuda", torch.float32, geometric)
    opts = PatchMatchOptions(depth_min=2.0, depth_max=10.0, view_selection=weighted)
    ca = KV.costs(p, d, n, opts)
    w = KV.view_weights(p, d, n, sel, opts) if weighted else None
    cost = KV.aggregate(ca, w)
    call = lambda: KV.iteration(p, d, n, cost, ca, w, dr, 0, 0.5, opts)  # noqa: E731
    return [(f"K18 {mode}", call,
             lambda: torch.cat([t.reshape(-1) for t in call()]), 10)]


def schur(arg, cache_dir):
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.kernels import ba as K
    from colmap_tpu_torch.scene.synthetic_ba import synthetic_ba_problem

    F, N, model_id = (int(v) for v in arg.split(":"))
    problem, _, _ = synthetic_ba_problem(F, N, min(F, 6), model_id=model_id, seed=0,
                                         device="cuda")
    options = ba.BAOptions()
    masks = ba.fix_gauge_two_frames(ba.default_masks(problem, model_id, options), 0, 1)
    p, maps, _ = ba.pack_problem(problem)
    om = ba._obs_masks(masks, options)
    r, Jp, Jc, Jx = K.obs_jacobians(p.quat, p.t, p.cam_params, p.points, p.obs_frame,
                                    p.obs_cam, p.obs_point, p.obs_xy, p.obs_w, om.pose, om.cam,
                                    om.point, model_id, options.loss, options.loss_scale)
    C = p.cam_params.shape[0]
    red = K.lm_reduce(r, Jp, Jc, Jx, maps.frame_pm, maps.cam_pm, F, C,
                      torch.tensor(1e-3, device="cuda"))
    g = torch.Generator(device="cuda").manual_seed(0)
    xp = torch.randn(F, 6, device="cuda", generator=g)
    xc = torch.randn(C, Jc.shape[-1], device="cuda", generator=g) * 1e-3
    call = lambda: K.schur_matvec(Jp, Jc, Jx, maps.frame_pm, maps.cam_pm, red.Hpp_inv,  # noqa: E731
                                  xp, xc)
    return [(f"K3 matvec {F}x{N} model {model_id} (capp {maps.frame_pm.shape[1]})", call, None,
             200 if N < 10000 else 50)]
