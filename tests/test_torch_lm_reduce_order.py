"""K2's host side (colmap_tpu_torch/kernels/ba.py): the slot order by frame
and camera that pack_problem builds once a solve (slot_order_arrays), its
items, the launch plan (lm_reduce_plan), and the weighing's work formulas
of the kernels added to it (chip_smoke.py shape_work)."""

import numpy as np
import pytest
import torch

from colmap_tpu_torch.kernels import ba as K


def _ids(opm, frames, cams, real_share, seed):
    rng = np.random.default_rng(seed)
    frame_pm = rng.integers(0, max(frames, 1), opm).astype(np.int32)
    cam_pm = rng.integers(0, max(cams, 1), opm).astype(np.int32)
    real = rng.random(opm) < real_share
    frame_pm[~real] = 0  # dummy slots: frame and camera 0, as pack_problem leaves them
    cam_pm[~real] = 0
    return frame_pm, cam_pm, real


@pytest.mark.parametrize("opm, frames, cams, chunk", [
    (2000, 1, 1, 1024), (6000, 8, 1, 1024), (5000, 40, 3, 64), (700, 12, 2, 7), (0, 3, 1, 16)],
    ids=["one_frame", "camera_of_six_items", "many_items", "tiny_chunks", "no_slots"])
def test_slot_order_is_a_stable_argsort_by_frame_then_camera(opm, frames, cams, chunk):
    frame_pm, cam_pm, real = _ids(opm, frames, cams, 0.8, opm + frames)
    slots, items, partials, tickets = K.slot_order_arrays(frame_pm, cam_pm, real, frames, cams,
                                                          chunk)
    ids = np.flatnonzero(real)
    M = len(ids)
    assert slots.dtype == np.int32 and items.dtype == np.int32 and len(slots) == 2 * M
    assert np.array_equal(slots[:M], ids[np.argsort(frame_pm[ids], kind="stable")])
    assert np.array_equal(slots[M:], ids[np.argsort(cam_pm[ids], kind="stable")])
    seg_ids = np.concatenate([frame_pm[slots[:M]], frames + cam_pm[slots[M:]]])
    assert items.shape[1] == K.REDUCE_ITEM_FIELDS
    # Items tile each segment's entries in order, chunk at a time, one item
    # for a segment without slots; partial rows, first rows and tickets.
    assert np.array_equal(np.unique(items[:, 0]), np.arange(frames + cams))
    row, ticket = 0, 0
    for seg in range(frames + cams):
        mine = items[items[:, 0] == seg]
        entries = np.flatnonzero(seg_ids == seg)
        lo = entries[0] if len(entries) else mine[0, 1]
        assert mine[0, 1] == lo and mine[-1, 2] == lo + len(entries)
        assert np.array_equal(mine[1:, 1], mine[:-1, 2])
        assert (mine[:, 2] - mine[:, 1] <= chunk).all()
        assert (mine[:, 5] == len(mine)).all()
        if len(mine) == 1:
            assert (mine[0, [3, 4, 6]] == -1).all()
        else:
            assert np.array_equal(mine[:, 3], row + np.arange(len(mine)))
            assert (mine[:, 4] == row).all() and (mine[:, 6] == ticket).all()
            row, ticket = row + len(mine), ticket + 1
    assert (partials, tickets) == (row, ticket)


def test_slot_order_items_sum_each_segment_once():
    """Summing a value a slot item by item, as K2's blocks do, gives each
    frame's and each camera's sum over its real slots."""
    frame_pm, cam_pm, real = _ids(4000, 9, 2, 0.7, 5)
    slots, items, _, _ = K.slot_order_arrays(frame_pm, cam_pm, real, 9, 2, 100)
    vals = np.random.default_rng(6).normal(size=len(real))
    sums = np.zeros(11)
    for seg, begin, end in items[:, :3]:
        sums[seg] += vals[slots[begin:end]].sum()
    ref = np.concatenate([np.bincount(frame_pm[real], vals[real], 9),
                          np.bincount(cam_pm[real], vals[real], 2)])
    assert np.allclose(sums, ref)


def test_pack_problem_builds_the_slot_order_of_colmap_tpus_packing():
    """maps.order of the port's pack_problem is the slot order of the frame
    and camera ids that colmap_tpu's pack_problem lays out, over the slots
    that hold an observation."""
    import jax.numpy as jnp
    from colmap_tpu.estimators import bundle_adjustment as jba
    from colmap_tpu.scene.synthetic_ba import synthetic_ba_problem as j_synthetic

    from colmap_tpu_torch import convert
    from colmap_tpu_torch.estimators import bundle_adjustment as tba

    jp, _, _ = j_synthetic(7, 60, 4, seed=3, dtype=jnp.float32)
    d = {k: np.array(v) for k, v in jp._asdict().items()}
    d["cam_params"] = np.concatenate([d["cam_params"], d["cam_params"] * 1.01])
    d["obs_cam"] = (d["obs_frame"] % 2).astype(np.int32)
    jpk, jmaps, _ = jba.pack_problem(jba.BAProblem(**{k: jnp.asarray(v) for k, v in d.items()}))
    tp = convert.problem_from_numpy(d, "cpu")
    _, maps, _ = tba.pack_problem(tp)
    fpm = np.asarray(jmaps.frame_pm).reshape(-1)
    assert np.array_equal(maps.frame_pm.numpy().reshape(-1), fpm)
    real = np.asarray(jpk.obs_w).reshape(-1) > 0
    slots, items, partials, tickets = K.slot_order_arrays(fpm, np.asarray(jmaps.cam_pm).reshape(-1),
                                                          real, 7, 2)
    o = maps.order
    assert np.array_equal(o.slots.numpy(), slots) and np.array_equal(o.items.numpy(), items)
    assert (o.num_partials, o.num_frames, o.num_cams) == (partials, 7, 2)
    assert (o.num_slots, o.num_real) == (len(fpm), int(real.sum()))
    assert o.tickets.dtype == torch.int32 and not o.tickets.any()
    assert len(o.tickets) == max(1, tickets)


def test_reduce_chunk_by_problem_size():
    assert K.reduce_chunk(2000) == K.REDUCE_CHUNK_SMALL == 256
    assert K.reduce_chunk(K.REDUCE_CHUNK_SWITCH - 1) == 256
    assert K.reduce_chunk(K.REDUCE_CHUNK_SWITCH) == K.REDUCE_CHUNK == 1024
    frame_pm, cam_pm, real = _ids(3000, 2, 1, 1.0, 9)
    items = K.slot_order_arrays(frame_pm, cam_pm, real, 2, 1)[1]
    per_frame = -(-np.bincount(frame_pm[real], minlength=2) // 256)
    assert (items[:, 2] - items[:, 1]).max() == 256
    assert len(items) == per_frame.sum() + -(-int(real.sum()) // 256)


@pytest.mark.parametrize("N, capp, items, plan", [
    (1000, 2, 2, (True, 8, 2, 1)), (1000, 4, 5, (False, 16, 5, 2)),
    (1000, 6, 14, (False, 32, 14, 2)), (2000, 18, 30, (False, 250, 30, 2)),
    (2000, 706, 900, (False, 250, 900, 2)), (0, 2, 3, (True, 0, 3, 1)), (0, 2, 0, (True, 0, 0, 0))],
    ids=["capp2", "capp4", "capp6", "capp18", "long_track", "no_points", "nothing"])
def test_lm_reduce_plan_recomputes_y_up_to_its_capp(N, capp, items, plan):
    assert tuple(K.lm_reduce_plan(N, capp, items)) == plan


def test_lm_reduce_needs_the_order_only_on_the_card():
    """The plain version takes (and ignores) the order; the wrapper runs it
    on CPU tensors with or without one."""
    from colmap_tpu_torch.estimators import bundle_adjustment as tba
    from colmap_tpu_torch.scene.synthetic_ba import synthetic_ba_problem

    p, _, model_id = synthetic_ba_problem(4, 50, 3, seed=1, device="cpu")
    pk, maps, _ = tba.pack_problem(p)
    opts = tba.BAOptions()
    om = tba._obs_masks(tba.default_masks(p, model_id, opts), opts)
    J = K.obs_jacobians(pk.quat, pk.t, pk.cam_params, pk.points, pk.obs_frame, pk.obs_cam,
                        pk.obs_point, pk.obs_xy, pk.obs_w, om.pose, om.cam, om.point, model_id,
                        "trivial", 1.0)
    lam = torch.tensor(1e-3)
    a = K.lm_reduce(*J, maps.frame_pm, maps.cam_pm, 4, 1, lam, maps.order)
    b = K.lm_reduce_plain(*J, maps.frame_pm, maps.cam_pm, 4, 1, lam)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_shape_work_of_the_kernels_the_weighing_adds():
    from types import SimpleNamespace

    import chip_smoke as cs

    # K1's row: nbytes of its inputs, masks and Jacobians; O (40 + 20 (7 + P) + 6 (9 + P)).
    n, N, F, C, P = 6000, 1000, 8, 1, 8
    nb, ops = cs.shape_work("ba_obs_jacobians", "jacobians", (n, N, F, C, P), ())
    assert nb == 4 * (7 * F + C * P + 3 * N) + 24 * n + 4 * (6 * F + C * P + N) + 4 * n * (20 + 2 * P)
    assert ops == n * (40 + (7 + P) * 20 + 6 * (9 + P))
    nb_c, ops_c = cs.shape_work("ba_obs_jacobians", "cost", (n, N, F, C, P), ())
    assert nb_c < nb and 0 < ops_c < ops
    # K39's row: 4 * 8 * n + 16 bytes and 11 n operations of n = 3 * nodes entries.
    assert cs.shape_work("global_cg", "step_rotation", (1000,), ()) == (4 * 8 * 3000 + 16,
                                                                       cs.K39_ENTRY_OPS * 3000)
    assert cs.shape_work("global_cg", "setup_positioning", (10,), ())[1] == cs.K39_ENTRY_OPS * 30
    # K20's row: three planes of Sv x H x W floats, PM_SEL_OPS a view and pixel.
    assert cs.shape_work("pm_view_selection", "along_H", (5, 48, 64), ()) == (
        4 * 3 * 5 * 48 * 64, cs.PM_SEL_OPS * 5 * 48 * 64)
    # K26's row from the call's tensors.
    z = lambda *s: torch.zeros(*s)  # noqa: E731
    jac = SimpleNamespace(Jf=z(30, 2, 6), Js=z(30, 2, 6), Jc=z(30, 2, 4), Jx=z(30, 2, 3))
    obs = tuple(torch.zeros(30, dtype=torch.int32) for _ in range(6))
    layout = tuple(torch.zeros(31, dtype=torch.int32) for _ in range(7))
    args = (0, jac, obs, layout, z(10, 3, 3), z(5, 8), None, z(5, 8))
    nb, ops = cs.shape_work("rig_ba_matvec", "matvec", (30, 10, 5, 8), args)
    assert nb == 4 * (30 * 2 * 19 + 90 + 40 + 40) + 4 * 4 * 30 + 7 * 4 * 31 + 4 * 40
    assert ops == 30 * cs.RIG_K26_OBS_OPS + 10 * cs.RIG_K26_POINT_OPS
    # K11's: three models a sample.
    mask = torch.ones(2, 100, dtype=torch.bool)
    args = (torch.zeros(2, 100, 2), torch.zeros(2, 100, 2), mask, torch.zeros(2, 16, 7))
    nb, ops = cs.shape_work("fundamental_ransac", "propose", (2, 100, 16), args)
    assert ops == 2 * 16 * 4000 + 16 * 3 * 200 * 20
    assert cs.shape_work("fundamental_ransac", "refit", (2, 100, 0), args)[1] == 200 * 20
    assert set(cs.WEIGHED) >= {"ba_obs_jacobians", "rig_ba_matvec", "global_cg",
                               "pm_view_selection", "fundamental_ransac"}
