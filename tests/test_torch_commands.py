"""The port's spatial_matcher, transitive_matcher and geometric_verifier.

These three commands drive the pair generators and the verification that
the matching slice ported. Each is held against colmap_tpu's pair
generators and GPS conversions (numpy in both packages) on the same
database, and its verified pairs against the synthetic generator's scene
(the verify scene: 8 frames see all 120 points, so every pair verifies).
"""

import shutil

import numpy as np

from colmap_tpu.cli.extra_commands import _prior_positions_enu as j_prior_positions_enu
from colmap_tpu.feature import pairing as jpairing
from colmap_tpu.geometry import gps as jgps
from colmap_tpu.scene import database as jdb
from colmap_tpu_torch.cli import main as tcli
from colmap_tpu_torch.geometry import gps as tgps
from colmap_tpu_torch.scene import database as tdb
from colmap_tpu_torch.scene.synthetic import SyntheticDatasetOptions, synthesize_dataset
from colmap_tpu_torch.utils.types import pair_id_to_image_pair


def _verify_scene(path):
    """The verify scene with its GT projection centres as Cartesian pose
    priors, stripped to keypoints and descriptors."""
    db = tdb.Database(path)
    synthesize_dataset(SyntheticDatasetOptions(
        num_rigs=1, num_frames_per_rig=8, num_points3D=120, camera_has_prior_focal_length=True,
        prior_position=True), db, rng=np.random.default_rng(3))
    db.conn.execute("DELETE FROM matches")
    db.conn.execute("DELETE FROM two_view_geometries")
    db.commit()
    db.close()


def _matched_pairs(path):
    db = tdb.Database(path, must_exist=True)
    pairs = {pair_id_to_image_pair(pid) for pid, m in db.read_all_matches() if len(m)}
    db.close()
    return pairs


def _verified(path):
    db = tdb.Database(path, must_exist=True)
    out = {(a, b): g for a, b, g in db.read_all_two_view_geometries()}
    db.close()
    return out


def test_gps_conversions_match_colmap_tpu(tmp_path):
    """WGS84 <-> ECEF <-> ENU to 1e-9 (m or deg), and the WGS84 priors of a
    database in ENU about the first one, as colmap_tpu's spatial_matcher
    reads them."""
    rng = np.random.default_rng(0)
    lat, lon = rng.uniform(-80, 80, 20), rng.uniform(-180, 180, 20)
    alt = rng.uniform(-100, 3000, 20)
    ecef = tgps.ellipsoid_to_ecef(lat, lon, alt)
    assert np.abs(ecef - jgps.ellipsoid_to_ecef(lat, lon, alt)).max() <= 1e-9
    assert np.abs(tgps.ecef_to_ellipsoid(ecef) - jgps.ecef_to_ellipsoid(ecef)).max() <= 1e-9
    enu = tgps.ellipsoid_to_enu(lat, lon, alt, lat[0], lon[0], alt[0])
    assert np.abs(enu - jgps.ellipsoid_to_enu(lat, lon, alt, lat[0], lon[0], alt[0])).max() <= 1e-9
    back = tgps.enu_to_ellipsoid(enu, lat[0], lon[0], alt[0])
    assert np.abs(back - jgps.enu_to_ellipsoid(enu, lat[0], lon[0], alt[0])).max() <= 1e-9

    path = str(tmp_path / "gps.db")
    db = tdb.Database(path)
    for i in range(5):
        iid = db.write_image(f"{i}.png", 1)
        db.write_pose_prior(iid, position=np.array([47.0 + 1e-4 * i, 8.0 - 2e-4 * i, 400.0 + i]),
                            coordinate_system=0)
    db.commit()
    ids, pos = tcli._prior_positions_enu(db)
    db.close()
    j = jdb.Database(path, must_exist=True)
    j_ids, j_pos = j_prior_positions_enu(j)
    j.close()
    assert ids == j_ids and np.abs(pos - j_pos).max() <= 1e-9 and np.abs(pos).max() > 10


def test_spatial_transitive_and_geometric_verifier_commands(tmp_path):
    """spatial_matcher pairs each image with its 2 nearest priors; the
    pairs equal colmap_tpu's spatial_pairs. transitive_matcher then adds the
    pairs that close A-B, B-C, equal to colmap_tpu's transitive_pairs on
    the same database. geometric_verifier verifies every matched pair
    again. Each verified pair is CALIBRATED with all 120 matches as
    inliers."""
    path = str(tmp_path / "db.db")
    _verify_scene(path)
    j = jdb.Database(path, must_exist=True)
    j_ids, j_pos = j_prior_positions_enu(j)
    j.close()
    want = set(jpairing.spatial_pairs(j_ids, j_pos, jpairing.SpatialPairingOptions(
        max_num_neighbors=2)))
    n = tcli.main(["spatial_matcher", "--database_path", path, "--max_num_neighbors", "2",
                   "--device", "cpu"])
    assert _matched_pairs(path) == {tuple(sorted(p)) for p in want} and n == len(want) >= 8

    shutil.copy(path, str(tmp_path / "before.db"))
    j = jdb.Database(str(tmp_path / "before.db"), must_exist=True)
    closing = {tuple(sorted(p)) for p in jpairing.transitive_pairs(
        j, jpairing.TransitivePairingOptions(num_iterations=1))}
    j.close()
    n = tcli.main(["transitive_matcher", "--database_path", path, "--num_iterations", "1",
                   "--device", "cpu"])
    assert closing and n == len(closing)
    assert _matched_pairs(path) == {tuple(sorted(p)) for p in want} | closing

    db = tdb.Database(path, must_exist=True)
    db.conn.execute("DELETE FROM two_view_geometries")
    db.commit()
    db.close()
    n = tcli.main(["geometric_verifier", "--database_path", path, "--device", "cpu"])
    verified = _verified(path)
    assert n == len(verified) == len(_matched_pairs(path))
    for g in verified.values():
        assert int(g.config) == 2 and len(g.inlier_matches) == 120
