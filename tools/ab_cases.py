"""Cases for tools/kernel_ab.py at chip_smoke.py's shapes, through the
port's wrappers, which a parent checkout shares with its change.

descend:ROWS     K30 on the first ROWS rows of the retrieval phases' corpus
                 (retrieval_cases.corpus(1000, 2000, seed=0)) through the
                 branching-8, depth-5 tree that vocab_tree_builder trains on
                 its 200 000-row rng(0) sample (built once, in cache_dir).
spectral:DEPTH   K43 in place on rfftn(randn(N^3)) (torch.Generator seed
                 DEPTH, N = 2^DEPTH) and torch.div(spec, lam) beside it.
"""

import os

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
