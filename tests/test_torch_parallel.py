"""colmap_tpu_torch's multi-process plumbing and point-sharded BA against
colmap_tpu's, on the CPU in float64.

The sharded solve runs in real process groups: 2 and 3 ranks over gloo,
each spawned once for this file (``parallel/dist_cases.py`` case ``cpu``),
on tests/test_multihost.py's scene (8 frames x 120 points x 4
observations, seed 3, 4 iterations, PCG 20, function_tolerance 0). The
ranks' solve_sharded_packed (PCG and dense) is held against colmap_tpu's
solve_sharded_packed on a 2-device mesh and against the port's
solve_packed, their solve_sharded against colmap_tpu's solve_sharded on 2
devices and the port's solve, at colmap_tpu's own tolerances
(tests/test_sharded_packed_ba.py:46-57): the same iteration count, cost
rtol 1e-8, quaternions 1e-9, points 1e-7; every rank's camera parameters
are equal to the bit. colmap_tpu's dense path builds its Schur correction
from bfloat16 operands, so the dense parameters are held to it as
test_torch_ba.py's dense case holds solve_packed (1e-6). The same ranks
exchange byte blobs and leaf reconstructions.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from colmap_tpu.estimators import bundle_adjustment as jba
from colmap_tpu.parallel import multihost as jmultihost
from colmap_tpu.parallel import sharded_ba as jsharded
from colmap_tpu.scene.synthetic_ba import synthetic_ba_problem as j_synthetic
from colmap_tpu_torch import convert
from colmap_tpu_torch.estimators import bundle_adjustment as tba
from colmap_tpu_torch.parallel import dist_cases, multihost, sharded_ba

torch.set_num_threads(1)  # one intra-op thread a worker, as the other port test files

WORLDS = [2, 3]
OPTIONS = dict(max_iterations=4, pcg_iterations=20, function_tolerance=0.0)
PCG, DENSE = dict(OPTIONS, solver_type="pcg"), dict(OPTIONS, solver_type="dense_schur")
# name: [the port's sharded solver, options]; each has colmap_tpu's counterpart below.
CASES = {"pcg": ["solve_sharded_packed", PCG], "dense": ["solve_sharded_packed", DENSE],
         "unpacked": ["solve_sharded", PCG]}


def _scene():
    jp, _, model_id = j_synthetic(num_frames=8, num_points=120, obs_per_point=4,
                                  dtype=jnp.float64, pixel_noise=0.3, pose_noise=0.01,
                                  point_noise=0.01, seed=3)
    jm = jba.fix_gauge_two_frames(jba.default_masks(jp, model_id, jba.BAOptions()), 0, 1)
    return jp, jm, model_id


def _np(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def _port(jp, jm):
    return convert.problem_from_numpy(_np(jp), "cpu"), convert.problem_from_numpy(_np(jm), "cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both process groups' results, colmap_tpu's sharded solves on 2
    devices, and the port's single-process solves; the ranks run while the
    references are computed."""
    jp, jm, model_id = _scene()
    groups = {}
    for world in WORLDS:
        out = tmp_path_factory.mktemp(f"world{world}")
        np.savez(out / "problem.npz", model_id=model_id, **_np(jp),
                 **{f"mask_{k}": v for k, v in _np(jm).items()})
        (out / "cases.json").write_text(json.dumps(CASES))
        groups[world] = (out, dist_cases.launch("cpu", world, out, wait=False))
    ref = {}
    mesh = jsharded.make_mesh(jax.devices()[:2], axis_name="d")
    for name in ("pcg", "dense"):
        jout, jsum = jsharded.solve_sharded_packed(jp, model_id, jba.BAOptions(**CASES[name][1]),
                                                   jm, mesh=mesh, axis_name="d")
        ref[f"jax_{name}"] = (_np(jout), jsum)
    jout, jsum = jsharded.solve_sharded(jp, model_id, jba.BAOptions(**PCG), jm,
                                        mesh=jsharded.make_mesh(jax.devices()[:2]))
    ref["jax_unpacked"] = (_np(jout), jsum)
    tp, tm = _port(jp, jm)
    for name, (solver, fields) in CASES.items():
        single = tba.solve if solver == "solve_sharded" else tba.solve_packed
        out, summary = single(tp, model_id, tba.BAOptions(**fields), tm)
        ref[f"port_{name}"] = ({k: v.numpy() for k, v in out._asdict().items()}, summary)
    results = {}
    for world, (out, procs) in groups.items():
        dist_cases.finish(procs, timeout=240)
        results[world] = out
    return results, ref


def _rank_results(out, world, name):
    res = []
    for r in range(world):
        d = dict(np.load(out / f"rank{r}_{name}.npz"))
        res.append((d, json.loads(str(d.pop("summary")))))
    return res


def _hold(got, summary, ref, ref_summary):
    """colmap_tpu's sharded tolerances (tests/test_sharded_packed_ba.py:46-57)."""
    assert summary["num_iterations"] == ref_summary["num_iterations"]
    np.testing.assert_allclose(summary["final_cost"], ref_summary["final_cost"], rtol=1e-8)
    np.testing.assert_allclose(got["quat"], ref["quat"], atol=1e-9)
    np.testing.assert_allclose(got["points"], ref["points"], atol=1e-7)


def _hold_bf16(got, summary, ref, ref_summary):
    """Against colmap_tpu's dense path, whose Schur correction has
    bfloat16 operands (bundle_adjustment.py:1533-1537): the iterations and
    cost as _hold, the parameters as test_torch_ba.py's dense case (atol
    1e-6, camera parameters also rtol 1e-6: the focal length is ~1000 px)."""
    assert summary["num_iterations"] == ref_summary["num_iterations"]
    np.testing.assert_allclose(summary["final_cost"], ref_summary["final_cost"], rtol=1e-8)
    for key in ("quat", "t", "cam_params", "points"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-6 if key == "cam_params" else 0,
                                   atol=1e-6, err_msg=key)


def _bit_equal(ranks):
    """The same steps on every rank, bit for bit."""
    for got, _ in ranks[1:]:
        for key in ("quat", "t", "cam_params", "points"):
            assert np.array_equal(got[key], ranks[0][0][key]), key


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_pcg_solve_matches_colmap_tpu_and_solve_packed(runs, world):
    results, ref = runs
    ranks = _rank_results(results[world], world, "pcg")
    for got, summary in ranks:
        assert summary["num_devices"] == world
        assert summary["final_cost"] < summary["initial_cost"]
        _hold(got, summary, *ref["jax_pcg"])
        _hold(got, summary, *ref["port_pcg"])
    _bit_equal(ranks)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_dense_solve_matches_colmap_tpu_and_solve_packed(runs, world):
    results, ref = runs
    ranks = _rank_results(results[world], world, "dense")
    for got, summary in ranks:
        assert summary["num_devices"] == world
        _hold(got, summary, *ref["port_dense"])
        _hold_bf16(got, summary, *ref["jax_dense"])
    _bit_equal(ranks)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_unpacked_solve_matches_colmap_tpu_and_solve(runs, world):
    """solve_sharded (G2': solve's semantics on the point-sharded shards)
    against colmap_tpu's observation-sharded solve_sharded and the port's
    solve."""
    results, ref = runs
    ranks = _rank_results(results[world], world, "unpacked")
    for got, summary in ranks:
        assert summary["num_devices"] == world
        _hold(got, summary, *ref["jax_unpacked"])
        _hold(got, summary, *ref["port_unpacked"])
    _bit_equal(ranks)


@pytest.mark.parametrize("world", WORLDS)
def test_all_gather_and_leaf_exchange_over_ranks(runs, world):
    """all_gather_bytes, all_gather_host_objects and
    exchange_sub_reconstructions give every rank every rank's items, in
    rank order."""
    results, _ = runs
    want_leaves = json.loads(json.dumps(
        [dist_cases.leaf_summary(dist_cases._leaf(r)) for r in range(world)]))
    for r in range(world):
        got = json.loads((results[world] / f"rank{r}_exchange.json").read_text())
        assert got["blobs"] == [(bytes([q]) * (q + 3)).hex() for q in range(world)]
        assert got["objects"] == [{"rank": q} for q in range(world)]
        assert got["leaves"] == want_leaves


@pytest.mark.parametrize("n", WORLDS)
def test_pack_problem_sharded_matches_colmap_tpu(n):
    jp, _, _ = _scene()
    tp = convert.problem_from_numpy(_np(jp), "cpu")
    jpk, jmaps, jinfo = jsharded.pack_problem_sharded(jp, n)
    tpk, tmaps, tinfo = sharded_ba.pack_problem_sharded(tp, n)
    assert tinfo == jinfo
    assert len(tpk) == len(tmaps) == n
    for d in range(n):
        for key in ("points", "obs_frame", "obs_cam", "obs_point", "obs_xy", "obs_w"):
            assert np.array_equal(getattr(tpk[d], key).numpy(), np.asarray(getattr(jpk, key)[d])), key
        assert np.array_equal(tmaps[d].frame_pm.numpy(), np.asarray(jmaps.frame_pm[d]))
        assert np.array_equal(tmaps[d].cam_pm.numpy(), np.asarray(jmaps.cam_pm[d]))
    one, _, _ = sharded_ba.pack_problem_sharded(tp, n, ranks=[n - 1])
    assert np.array_equal(one[0].obs_xy.numpy(), tpk[n - 1].obs_xy.numpy())


def test_world_size_one_group_matches_the_single_process_solves():
    """A gloo group of one rank in this process: solve_sharded_packed equals
    solve_packed, solve_sharded equals solve, and one sharded_lm_step equals
    lm_step_packed with solve's semantics and colmap_tpu's sharded_lm_step on
    2 devices."""
    jp, jm, model_id = _scene()
    tp, tm = _port(jp, jm)
    opts = tba.BAOptions(**PCG)
    mesh = jsharded.make_mesh(jax.devices()[:2])
    jstep = jsharded.sharded_lm_step(mesh, model_id, jba.BAOptions(**PCG))
    jgot = jstep(jsharded.shard_problem(jsharded.pad_observations(jp, 2), mesh), jm,
                 jnp.asarray(1e-4), jnp.asarray(2.0))
    multihost.initialize(f"tcp://127.0.0.1:{dist_cases.free_port()}", 1, 0, backend="gloo")
    try:
        assert multihost.process_count() == 1 and dist.is_initialized()
        for sharded, single in ((sharded_ba.solve_sharded_packed, tba.solve_packed),
                                (sharded_ba.solve_sharded, tba.solve)):
            out, summary = sharded(tp, model_id, opts, tm)
            ref, ref_summary = single(tp, model_id, opts, tm)
            assert summary["num_devices"] == 1
            _hold({k: v.numpy() for k, v in out._asdict().items()}, summary,
                  {k: v.numpy() for k, v in ref._asdict().items()}, ref_summary)
        (shard,), (maps,), _ = sharded_ba.pack_problem_sharded(tp, 1)
        got = sharded_ba.sharded_lm_step(model_id, opts)(shard, maps, tm, 1e-4, 2.0)
        want = tba.lm_step_packed(shard, maps, model_id, opts, tm, 1e-4, 2.0,
                                  solve_semantics=True)
        assert got[1:] == pytest.approx(want[1:], rel=1e-12)
        np.testing.assert_allclose(got[0].quat.numpy(), want[0].quat.numpy(), atol=1e-12)
        assert got[1:] == pytest.approx([float(x) for x in jgot[1:]], rel=1e-12)
        np.testing.assert_allclose(got[0].quat.numpy(), np.asarray(jgot[0].quat), atol=1e-9)
        np.testing.assert_allclose(got[0].points.numpy(), np.asarray(jgot[0].points), atol=1e-7)
    finally:
        multihost.shutdown()
    assert not dist.is_initialized()


@pytest.mark.parametrize("env", [
    {},
    {"SLURM_JOB_ID": "7"},
    {"COLMAP_TPU_MULTIHOST": "1", "SLURM_JOB_ID": "7"},
    {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1", "WORLD_SIZE": "2", "RANK": "0"},
])
def test_initialize_joins_only_when_opted_in_under_torchrun(monkeypatch, env):
    """No opt-in, a launcher marker alone, or the opt-in without torchrun's
    variables: no group, the single-process answers (colmap_tpu's test)."""
    for k in ("COLMAP_TPU_MULTIHOST", "SLURM_JOB_ID", "MASTER_ADDR", "MASTER_PORT",
              "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    multihost.initialize()
    assert not dist.is_initialized()
    assert multihost.process_count() == jmultihost.process_count() == 1
    assert multihost.process_index() == 0
    assert multihost.all_gather_bytes(b"abc") == [b"abc"]
    assert multihost.all_gather_host_objects({"a": 1}) == [{"a": 1}]


def test_a_requested_group_that_fails_raises():
    with pytest.raises(RuntimeError, match="rendezvous"):
        multihost.initialize("bogus://x", 1, 0, backend="gloo")
    assert not dist.is_initialized()


def test_local_work_slice_as_colmap_tpu():
    items = list(range(10))
    assert multihost.local_work_slice(items) == jmultihost.local_work_slice(items) == items
    parts = [multihost.local_work_slice(items, process_id=p, n_processes=3) for p in range(3)]
    assert parts == [jmultihost.local_work_slice(items, p, 3) for p in range(3)]
    assert sorted(sum(parts, [])) == items and parts[0] == [0, 3, 6, 9]
