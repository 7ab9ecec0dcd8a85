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
pcg_step:F:N:MODEL
                 K34's step on the same problem after its set-up
                 (block-Jacobi, lam 1e-3) and one K3 product, in place as the
                 PCG runs it; its output (a step from that state) digested;
                 and a CUDA graph of 20 PCG iterations (K3 + K34 each), as
                 the LM loop replays them. 8:800:2 (F 8, CP 4), 4:500:2
                 (F 4, CP 4) and 8:800:4 (F 8, CP 8) are the weighing's
                 heaviest classes, 200:50000:2 the BA headline.
homography:PAIRS:ROWS
                 K12's propose-and-score, count and MSAC modes, on
                 matching_cases.two_view_block_case("H", PAIRS, ROWS, 128, 2):
                 PAIRS pairs of ROWS matches (valid counts ROWS down to
                 about ROWS / 2), 128 samples a pair; 64:1024 is the
                 weighing's heaviest propose class.
homography_refit:ROWS
                 K12's refit on one pair, matching_cases.two_view_case("H",
                 ROWS, 128, 2): the best of its 128 samples (the plain
                 propose) refitted on its inliers, count and MSAC modes (the
                 call reads the count back, as the LO step does); 8192 is
                 the weighing's refit class.
reduce:F:N:MODEL K2 on the schur case's Jacobians at lam 1e-3, eager, and a
                 CUDA graph of 20 K2 calls (as the LM loop replays it);
                 1:1000:4 (capp 2, one frame) and 8:1000:4 (capp 6) are the
                 weighing's two heaviest classes, 200:50000:2 the BA
                 headline. The output digested (a K2 summing with float
                 atomics changes its last bits from run to run).
spherical_h:PAIRS[:ROWS]
                 K33's propose-and-score, count and MSAC modes, on
                 spherical_cases.ray_block_case("H", PAIRS, ROWS, 128, 1):
                 PAIRS pairs of ROWS rays (default 8192; valid counts ROWS
                 down to about ROWS / 2), 128 samples a pair; made once, in
                 cache_dir. Few rows leave the samples' solves alone.
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


def _ba_case(arg):
    """(F, model_id, Jacobians (K1), packed maps, K2's reduction at lam
    1e-3, lam) of the schur and pcg_step cases."""
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.kernels import ba as K
    from colmap_tpu_torch.scene.synthetic_ba import synthetic_ba_problem

    F, N, model_id = (int(v) for v in arg.split(":"))
    problem, _, _ = synthetic_ba_problem(F, N, min(F, 6), model_id=model_id, seed=0,
                                         device="cuda")
    options = ba.BAOptions()
    masks = ba.default_masks(problem, model_id, options)
    if F > 1:
        masks = ba.fix_gauge_two_frames(masks, 0, 1)
    p, maps, _ = ba.pack_problem(problem)
    om = ba._obs_masks(masks, options)
    r, Jp, Jc, Jx = K.obs_jacobians(p.quat, p.t, p.cam_params, p.points, p.obs_frame,
                                    p.obs_cam, p.obs_point, p.obs_xy, p.obs_w, om.pose, om.cam,
                                    om.point, model_id, options.loss, options.loss_scale)
    lam = torch.tensor(1e-3, device="cuda")
    red = K.lm_reduce(r, Jp, Jc, Jx, maps.frame_pm, maps.cam_pm, F, p.cam_params.shape[0], lam,
                      **_order(maps))
    return F, model_id, (r, Jp, Jc, Jx), maps, red, lam


def _order(maps):
    """K2's slot order where the checkout's maps carry one (an older
    checkout's K2 takes none)."""
    return {"order": maps.order} if hasattr(maps, "order") else {}


def _graph_of(fn, calls):
    """A replay of a CUDA graph of ``calls`` calls of fn, recorded at its
    first call (after the profiler, if any, has started)."""
    graph = []

    def replay():
        if not graph:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            graph.append(torch.cuda.CUDAGraph())
            with torch.cuda.graph(graph[0]):
                for _ in range(calls):
                    fn()
        graph[0].replay()

    return replay


def schur(arg, cache_dir):
    from colmap_tpu_torch.kernels import ba as K

    F, model_id, (_, Jp, Jc, Jx), maps, red, _ = _ba_case(arg)
    N, C = int(arg.split(":")[1]), red.bc.shape[0]
    g = torch.Generator(device="cuda").manual_seed(0)
    xp = torch.randn(F, 6, device="cuda", generator=g)
    xc = torch.randn(C, Jc.shape[-1], device="cuda", generator=g) * 1e-3
    call = lambda: K.schur_matvec(Jp, Jc, Jx, maps.frame_pm, maps.cam_pm, red.Hpp_inv,  # noqa: E731
                                  xp, xc)
    return [(f"K3 matvec {F}x{N} model {model_id} (capp {maps.frame_pm.shape[1]})", call, None,
             200 if N < 10000 else 50)]


def pcg_step(arg, cache_dir):
    from colmap_tpu_torch.kernels import ba as K
    from colmap_tpu_torch.kernels import solver as KS

    F, _, J, maps, red, lam = _ba_case(arg)
    C, P = red.bc.shape
    st = KS.pcg_setup(red.Hcc_pose, red.diag_pose, red.diag_cam, red.bp, red.bc, lam, True)

    def product(s):
        return K.schur_matvec(*J[1:], maps.frame_pm, maps.cam_pm, red.Hpp_inv,
                              s.p[:6 * F].view(F, 6), s.p[6 * F:].view(C, P))

    Ap = product(st)
    start = (KS.PCGState(*(v.clone() for v in st)), tuple(a.clone() for a in Ap))

    def output():
        s, a = KS.PCGState(*(v.clone() for v in start[0])), tuple(v.clone() for v in start[1])
        KS.pcg_step(s, *a, lam, red.diag_pose, red.diag_cam)
        return torch.cat([*(v.reshape(-1).double() for v in (*s, *a))])

    def iterations():
        for _ in range(20):
            KS.pcg_step(st, *product(st), lam, red.diag_pose, red.diag_cam)

    replay = _graph_of(iterations, 1)
    step = lambda: KS.pcg_step(st, *Ap, lam, red.diag_pose, red.diag_cam)  # noqa: E731
    label = f"{F} frames, CP {C * P}"
    return [(f"K34 step {label}", step, output, 200),
            (f"K3 + K34 graph of 20 PCG iterations {label}", replay, None, 50)]


def spherical_h(arg, cache_dir):
    from colmap_tpu_torch.kernels import spherical as KQ
    from colmap_tpu_torch.kernels import spherical_cases as Q

    pairs, rows = (int(v) for v in (arg.split(":") + ["8192"])[:2])
    path = os.path.join(cache_dir, f"rays_h_{pairs}_{rows}.pkl")
    if not os.path.exists(path):
        with open(path, "wb") as f:
            pickle.dump({k: v.cpu() if torch.is_tensor(v) else v for k, v in
                         Q.ray_block_case("H", pairs, rows, 128, 1, "cpu").items()}, f)
    with open(path, "rb") as f:
        c = {k: v.cuda() if torch.is_tensor(v) else v for k, v in pickle.load(f).items()}
    args = (c["x1"], c["x2"], c["mask"], c["samples"], c["max_sq"])
    out = []
    for msac in (False, True):
        call = lambda m=msac: KQ.spherical_h_propose_score(*args, msac=m)  # noqa: E731
        digest = lambda m=msac: torch.cat([t.reshape(-1).double()  # noqa: E731
                                           for t in KQ.spherical_h_propose_score(*args, msac=m)])
        out.append((f"K33 propose {'MSAC' if msac else 'count'} {pairs} pairs x {rows} x 128",
                    call, digest, 20))
    return out


def reduce(arg, cache_dir):
    from colmap_tpu_torch.kernels import ba as K

    F, model_id, J, maps, red, lam = _ba_case(arg)
    C, N = red.bc.shape[0], maps.frame_pm.shape[0]
    call = lambda: K.lm_reduce(*J, maps.frame_pm, maps.cam_pm, F, C, lam,  # noqa: E731
                               **_order(maps))
    digest = lambda: torch.cat([t.reshape(-1) for t in call()])  # noqa: E731
    label = f"{F}x{N} model {model_id} (capp {maps.frame_pm.shape[1]})"
    return [(f"K2 {label}", call, digest, 200 if N < 10000 else 50),
            (f"K2 graph of 20 calls {label}", _graph_of(call, 20), None, 50)]


def _homography_block(pairs, rows, cache_dir):
    from colmap_tpu_torch.kernels import matching_cases as MC

    path = os.path.join(cache_dir, f"h_block_{pairs}_{rows}.pkl")
    if not os.path.exists(path):
        with open(path, "wb") as f:
            pickle.dump({k: v.cpu() if torch.is_tensor(v) else v for k, v in
                         MC.two_view_block_case("H", pairs, rows, 128, 2, "cpu").items()}, f)
    with open(path, "rb") as f:
        return {k: v.cuda() if torch.is_tensor(v) else v for k, v in pickle.load(f).items()}


def homography(arg, cache_dir):
    from colmap_tpu_torch.kernels import matching as KM

    pairs, rows = (int(v) for v in arg.split(":"))
    c = _homography_block(pairs, rows, cache_dir)
    args = (c["x1"], c["x2"], c["mask"], c["samples"], c["max_sq"])
    out = []
    for msac in (False, True):
        call = lambda m=msac: KM.homography_propose_score(*args, msac=m)  # noqa: E731
        digest = lambda m=msac: torch.cat([t.reshape(-1).double()  # noqa: E731
                                           for t in KM.homography_propose_score(*args, msac=m)])
        out.append((f"K12 propose {'MSAC' if msac else 'count'} {pairs} pairs x {rows} x 128",
                    call, digest, 50))
    return out


def homography_refit(arg, cache_dir):
    from colmap_tpu_torch.kernels import matching as KM
    from colmap_tpu_torch.kernels import matching_cases as MC
    from colmap_tpu_torch.optim.ransac import unpack_best

    rows = int(arg)
    c = {k: v.cuda() if torch.is_tensor(v) else v
         for k, v in MC.two_view_case("H", rows, 128, 2, "cpu").items()}
    x1, x2, mask, max_sq = c["x1"], c["x2"], c["mask"], c["max_sq"]
    models, counts, best, scores = KM.homography_propose_score_plain(
        x1.double(), x2.double(), mask, c["samples"], max_sq, msac=True)
    i = int(unpack_best(int(best[0]))[1])
    model, count = models[i].float().contiguous(), int(counts[i])
    score = float(scores[i])
    out = []
    for msac in (False, True):
        kw = {"score": score} if msac else {}
        call = lambda kw=kw: KM.homography_refit(x1, x2, mask, model, max_sq, count,  # noqa: E731
                                                 **kw)
        digest = lambda call=call: torch.cat([call()[0].reshape(-1).double(),  # noqa: E731
                                              torch.tensor([float(v) for v in call()[1:]],
                                                           dtype=torch.float64, device="cuda")])
        out.append((f"K12 refit {'MSAC' if msac else 'count'} 1 x {rows}", call, digest, 50))
    return out
