"""Hold every finite model of K12's propose-and-score to the float64 count
of the same model, with no filter, on one or more checkouts.

    python3 tools/k12_counts.py TREE [TREE ...] [--pairs 64] [--rows 1024] [--samples 128]
                                [--device cuda]

Each checkout runs in a process of its own with its root first on
sys.path, so that it imports and builds that checkout's colmap_tpu_torch,
on matching_cases.two_view_block_case("H", pairs, rows, samples, 2) on the
card (or on --device cpu, through the plain version), in count and MSAC
modes. A model's count is held to the float64
count of the same float32 model within its border rows (float64 residuals
within 2% of the threshold), as tests/test_torch_cuda.py's _counts_match
holds it. Prints one JSON line a checkout: for each mode the finite
models, those outside their border, the pairs holding any, and for each
such model its count, its float64 count, its border, the pair's best
float64 count and whether it agrees with the plain float64 model of its
sample to 1e-3.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def _worker(tree, B, N, S, device):
    sys.path.insert(0, tree)
    import torch

    from colmap_tpu_torch.estimators.solvers.epipolar import homography_transfer_error
    from colmap_tpu_torch.kernels import matching as KM
    from colmap_tpu_torch.kernels import matching_cases as C

    c = C.two_view_block_case("H", B, N, S, 2, device)
    x1, x2, mask, max_sq = c["x1"].double(), c["x2"].double(), c["mask"], c["max_sq"]
    plain = KM.homography_propose_score_plain(x1, x2, mask, c["samples"], max_sq)
    out = {"tree": tree, "case": [B, N, S]}
    for msac in (False, True):
        models, counts = KM.homography_propose_score(c["x1"], c["x2"], mask, c["samples"],
                                                     max_sq, msac=msac)[:2]
        finite = outside = 0
        worst, pairs = [], set()
        for b in range(B):
            m = models[b].double()
            fin = torch.isfinite(m.flatten(1)).all(1)
            res = homography_transfer_error(m[fin][:, None], x1[b][None], x2[b][None])
            res = torch.where(mask[b], res, torch.inf)
            c64 = (res <= max_sq).sum(-1)
            border = ((res - max_sq).abs() <= 0.02 * max_sq).sum(-1)
            bad = (counts[b][fin] - c64).abs() > border
            assert bool((counts[b][~fin] == 0).all())
            finite += int(fin.sum())
            outside += int(bad.sum())
            ref = plain[0][b][fin]
            sign = torch.sign((m[fin] * ref).sum((-1, -2)))[:, None, None]
            scale = ref.abs().amax((-1, -2)).clamp(min=1e-30)
            agree = (m[fin] * sign - ref).abs().amax((-1, -2)) <= 1e-3 * scale
            for i in torch.nonzero(bad).flatten().tolist():
                pairs.add(b)
                worst.append({"pair": b, "count": int(counts[b][fin][i]), "count64": int(c64[i]),
                              "border": int(border[i]), "best64": int(plain[1][b].max()),
                              "agrees": bool(agree[i])})
        out["msac" if msac else "count"] = {"finite": finite, "outside": outside,
                                            "pairs": len(pairs), "models": worst[:20]}
    print(json.dumps(out))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--pairs", type=int, default=64)
    ap.add_argument("--rows", type=int, default=1024)
    ap.add_argument("--samples", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        _worker(a.trees[0], a.pairs, a.rows, a.samples, a.device)
        return
    rc = 0
    for tree in a.trees:
        p = subprocess.run([sys.executable, __file__, tree, "--worker", "--pairs", str(a.pairs),
                            "--rows", str(a.rows), "--samples", str(a.samples),
                            "--device", a.device],
                           capture_output=True, text=True)
        print(p.stdout.strip() if p.returncode == 0 else
              json.dumps({"tree": tree, "rc": p.returncode, "stderr": p.stderr[-2000:]}))
        rc |= p.returncode
    sys.exit(rc)


if __name__ == "__main__":
    main()
