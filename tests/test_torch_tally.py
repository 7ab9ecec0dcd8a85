"""The launch-shape tally and the weighing (colmap_tpu_torch/kernels/tally.py,
chip_smoke.py's add_launches and shape_work), the graph helper's moving of
shapes to replays, and K18's launch plan: host code, run here on the CPU
with hand-made counts."""

import math
from collections import Counter

import pytest
import torch

from colmap_tpu_torch.kernels import mvs as KV
from colmap_tpu_torch.kernels import tally as T
from colmap_tpu_torch.utils import cuda_graph


@pytest.mark.parametrize("sizes, cls", [((0, 1, 2, 3), (0, 1, 2, 4)), ((5, 8, 9), (8, 8, 16)),
                                        ((3072, 2304, 25), (4096, 4096, 32)), ((True,), (1,))])
def test_shape_class_rounds_sizes_up_to_powers_of_two(sizes, cls):
    assert T.shape_class(sizes) == cls


def test_pair_sizes_of_one_pair_and_of_a_block():
    assert T.pair_sizes(torch.zeros(100, 2), torch.zeros(64, 4)) == (1, 100, 64)
    assert T.pair_sizes(torch.zeros(8, 100, 3), torch.zeros(8, 64, 4)) == (8, 100, 64)
    assert T.pair_sizes(torch.zeros(8, 100, 3)) == (8, 100, 0)


def test_tally_counts_launches_and_keeps_one_call_a_class():
    tally = T.ShapeTally()
    tally.add("k", "a", (100, 3), fn=print, args=(1,))
    assert not tally.samples  # not sampling
    tally.sampling = True
    tally.add("k", "a", (120, 3), fn=len, args=("xy",), launches=2)
    tally.add("k", "a", (128, 4), fn=print, args=(2,))
    assert tally.counts == {("k", "a", 100, 3): 1, ("k", "a", 120, 3): 2, ("k", "a", 128, 4): 1}
    assert tally.samples == {("k", "a", 128, 4): ((120, 3), len, ("xy",), 2)}
    tally.reset()
    assert not tally.counts and tally.samples
    tally.reset_samples()
    assert not tally.samples


def test_weighing_times_the_heavy_classes_and_charges_the_rest_at_the_nearest():
    counts = {("k", "a", 100, 3): 60, ("k", "a", 120, 3): 30, ("k", "a", 5000, 3): 4,
              ("k", "b", 9000, 3): 6, ("j", "x", 7): 4}
    # a's two small shapes share the class (128, 4): 90 launches; b holds 6
    # of 100 (>= 5%), a at 8192 holds 4 (< 5%).
    assert T.classes_to_time(counts, 0.05) == [("j", "x", 8), ("k", "a", 128, 4),
                                               ("k", "b", 16384, 4)]
    timed = {("k", "a", 128, 4): (1.0, 0.25), ("k", "b", 16384, 4): (2.0, 1.5)}
    out = T.weigh(counts, timed, 0.05)
    # 90 (1.0 - 0.25) + 6 (2.0 - 1.5) + 4 at a's timed class (another
    # entry is 64 further): 67.5 + 3.0 + 3.0.
    assert math.isclose(out["k"]["weight_ms"], 73.5)
    assert out["k"]["launches"] == 100
    rows = {(r["entry"], tuple(r["shape"])): r for r in out["k"]["rows"]}
    assert rows[("a", (8192, 4))]["charged_at"] == ["a", 128, 4]
    assert rows[("a", (128, 4))]["charged_at"] is None and rows[("a", (128, 4))]["launches"] == 90
    assert out["j"]["weight_ms"] is None and out["j"]["rows"][0]["ms"] is None


def test_a_kernel_without_a_heavy_class_has_every_class_timed():
    counts = {("k", "a", 64, 1 << i): 1 for i in range(25)}  # 25 classes of 4%
    counts[("j", "x", 5)] = 3
    assert T.classes_to_time(counts, 0.05) == [("j", "x", 8)] + sorted(
        ("k", "a", 64, 1 << i) for i in range(25))


def test_weighing_charges_an_untimed_entry_at_the_nearest_size():
    counts = {("k", "a", 10): 50, ("k", "a", 1000): 50, ("k", "b", 900): 1}
    timed = {("k", "a", 16): (1.0, 0.0), ("k", "a", 1024): (3.0, 1.0)}
    out = T.weigh(counts, timed, 0.05)
    assert math.isclose(out["k"]["weight_ms"], 50 * 1.0 + 50 * 2.0 + 1 * 2.0)
    assert [r["charged_at"] for r in out["k"]["rows"] if r["entry"] == "b"] == [["a", 1024]]


class _Graph:
    def capture_begin(self, capture_error_mode):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


class _Module:
    def __init__(self):
        self.LAUNCHES = {"k": 0}
        self.SHAPES = T.ShapeTally()


def test_a_recorded_step_moves_its_shapes_to_the_replays():
    mod = _Module()
    mod.LAUNCHES["k"] = 1
    mod.SHAPES.add("k", "a", (5,))

    def step():
        mod.LAUNCHES["k"] += 2
        mod.SHAPES.add("k", "a", (5,))
        mod.SHAPES.add("k", "b", (7,))

    replay, _, _ = cuda_graph.record(step, _Graph(), (mod,))
    assert mod.LAUNCHES == {"k": 1}
    assert +mod.SHAPES.counts == Counter({("k", "a", 5): 1})
    replay()
    replay()
    assert mod.LAUNCHES == {"k": 5}
    assert +mod.SHAPES.counts == Counter({("k", "a", 5): 3, ("k", "b", 7): 2})


@pytest.mark.parametrize("views, R, step, plan", [
    (5, 2, 1, KV.IterationPlan(True, 8, 4 * 12 * 68 + 8 * 25 * 256)),
    (1, 2, 1, KV.IterationPlan(True, 8, 4 * 12 * 68 + 8 * 25 * 256)),
    (9, 3, 2, KV.IterationPlan(False, 16, 4 * 14 * 70)),
    (17, 1, 1, KV.IterationPlan(False, 32, 4 * 10 * 66)),
    (32, 2, 2, KV.IterationPlan(False, 32, 4 * 12 * 68))])
def test_iteration_plan_buckets_instantiations_and_tiles(views, R, step, plan):
    assert KV.iteration_plan(views, R, step) == plan


def test_iteration_plan_refuses_what_the_kernel_cannot_hold():
    with pytest.raises(ValueError, match="source views"):
        KV.iteration_plan(33, 2, 1)
    with pytest.raises(ValueError, match="source views"):
        KV.iteration_plan(0, 2, 1)
    with pytest.raises(ValueError, match="tile"):
        KV.iteration_plan(4, 200, 40)


def test_chip_smoke_adds_the_shapes_of_the_kernels_it_adds():
    import chip_smoke as cs

    counts = cs.Counts({"pm_iteration": 2, "ba_pcg": 3, "ba_schur_matvec": 0})
    counts.shapes = Counter({("pm_iteration", "weights", 5, 3072, 2304, 25, 1): 2,
                             ("ba_pcg", "step", 10, 20, 1): 3})
    launches = dict.fromkeys(counts, 0)
    before = Counter(cs.PATH_SHAPES)
    try:
        cs.add_launches(launches, counts.only(lambda k, v: k != "ba_pcg"))
        assert launches == {"pm_iteration": 2, "ba_pcg": 0, "ba_schur_matvec": 0}
        assert cs.PATH_SHAPES - before == Counter(
            {("pm_iteration", "weights", 5, 3072, 2304, 25, 1): 2})
    finally:
        cs.PATH_SHAPES.clear()
        cs.PATH_SHAPES.update(before)


def test_shape_work_is_the_rows_formula():
    import chip_smoke as cs

    # K18's row: 3072 x 2304, five views, 25 taps, weights and the
    # geometric term (PERF.md row 16b: 2.50969 ms by operations).
    b_ms, by = cs.bound(*cs.shape_work("pm_iteration", "weights", (5, 2304, 3072, 25, 1), ()))
    assert by == "operations" and abs(b_ms - 2.50969) < 1e-4
    for kernel, entry, sizes in (("ba_schur_matvec", "matvec", (1000, 6, 10, 1, 3)),
                                 ("ba_lm_reduce", "reduce", (1000, 6, 10, 1, 3)),
                                 ("ba_pcg", "step", (10, 3, 1)),
                                 ("ba_pcg", "setup_diag", (63,)),
                                 ("sift_pyramid", "blur", (64, 48, 4, 1)),
                                 ("sift_pyramid", "upsample2", (64, 48)),
                                 ("global_positioning", "schur_matvec", (1200, 10, 200)),
                                 ("retrieval_assign", "flat", (50, 128, 8)),
                                 ("aliked_conv", "conv", (16, 64, 48, 32, 3, 1)),
                                 ("aliked_conv", "upsample_selu", (16, 32, 24, 64, 48))):
        args = ((torch.zeros(50, 128), torch.zeros(8, 128), None)
                if kernel == "retrieval_assign" else ())
        nb, ops = cs.shape_work(kernel, entry, sizes, args)
        assert nb > 0 and ops >= 0, kernel
    mask = torch.ones(2, 100, dtype=torch.bool)
    mask[0, :40] = False
    args = (torch.zeros(2, 100, 3), torch.zeros(2, 100, 3), mask, torch.zeros(2, 16, 4))
    nb, ops = cs.shape_work("spherical_h_ransac", "propose", (2, 100, 16), args)
    assert ops == 2 * 16 * cs.SPH_H_SAMPLE_OPS + 16 * 160 * cs.SPH_H_ROW_OPS
