"""COLMAP-schema-compatible SQLite database.

reference behavior: src/colmap/scene/database.h:61 (interface) and
database_sqlite.cc (schema at :1988-2159). The schema, blob layouts, and
pair-id packing are identical so databases interoperate with the reference
tooling:

- keypoints: float32 row-major blobs with 2/4/6 cols (x, y, a11, a12, a21, a22)
- descriptors: uint8 row-major blobs + feature ``type`` column
- matches / two_view_geometries: uint32 row-major (N, 2) blobs; rows are
  stored with columns swapped when image_id1 > image_id2
- two_view_geometries carry config + F/E/H (row-major float64 3x3) and the
  relative pose qvec/tvec
"""

from __future__ import annotations

import os
import sqlite3
from typing import Dict, List, Optional, Tuple

import numpy as np

from colmap_tpu_torch.scene.types import Camera, Frame, Pose, Rig, TwoViewGeometry
from colmap_tpu_torch.utils.types import (
    SensorType,
    image_pair_to_pair_id,
    pair_id_to_image_pair,
    should_swap_image_pair,
)

MAX_NUM_IMAGES_CHECK = 2147483647


class FeatureExtractorType:
    """reference: src/colmap/feature/types.h:43."""

    UNDEFINED = -1
    SIFT = 0
    ALIKED_N16ROT = 1
    ALIKED_N32 = 2


_SCHEMA = """
CREATE TABLE IF NOT EXISTS rigs
   (rig_id               INTEGER  PRIMARY KEY AUTOINCREMENT  NOT NULL,
    ref_sensor_id        INTEGER                             NOT NULL,
    ref_sensor_type      INTEGER                             NOT NULL);
CREATE UNIQUE INDEX IF NOT EXISTS rig_ref_sensor_assignment ON
   rigs(ref_sensor_id, ref_sensor_type);
CREATE TABLE IF NOT EXISTS rig_sensors
   (rig_id               INTEGER                             NOT NULL,
    sensor_id            INTEGER                             NOT NULL,
    sensor_type          INTEGER                             NOT NULL,
    sensor_from_rig      BLOB,
FOREIGN KEY(rig_id) REFERENCES rigs(rig_id) ON DELETE CASCADE);
CREATE UNIQUE INDEX IF NOT EXISTS rig_sensor_assignment ON
   rig_sensors(sensor_id, sensor_type);
CREATE TABLE IF NOT EXISTS cameras
   (camera_id            INTEGER  PRIMARY KEY AUTOINCREMENT  NOT NULL,
    model                INTEGER                             NOT NULL,
    width                INTEGER                             NOT NULL,
    height               INTEGER                             NOT NULL,
    params               BLOB,
    prior_focal_length   INTEGER                             NOT NULL);
CREATE TABLE IF NOT EXISTS frames
   (frame_id             INTEGER  PRIMARY KEY AUTOINCREMENT  NOT NULL,
    rig_id               INTEGER                             NOT NULL,
    FOREIGN KEY(rig_id) REFERENCES rigs(rig_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS frame_data
   (frame_id             INTEGER                             NOT NULL,
    data_id              INTEGER                             NOT NULL,
    sensor_id            INTEGER                             NOT NULL,
    sensor_type          INTEGER                             NOT NULL,
    FOREIGN KEY(frame_id) REFERENCES frames(frame_id) ON DELETE CASCADE);
CREATE UNIQUE INDEX IF NOT EXISTS frame_sensor_assignment ON
   frame_data(data_id, sensor_type);
CREATE TABLE IF NOT EXISTS images
   (image_id   INTEGER  PRIMARY KEY AUTOINCREMENT  NOT NULL,
    name       TEXT                                NOT NULL UNIQUE,
    camera_id  INTEGER                             NOT NULL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < 2147483647),
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id));
CREATE UNIQUE INDEX IF NOT EXISTS index_name ON images(name);
CREATE TABLE IF NOT EXISTS pose_priors
   (pose_prior_id              INTEGER  PRIMARY KEY  NOT NULL,
    corr_data_id               INTEGER               NOT NULL,
    corr_sensor_id             INTEGER               NOT NULL,
    corr_sensor_type           INTEGER               NOT NULL,
    position                   BLOB,
    position_covariance        BLOB,
    gravity                    BLOB,
    coordinate_system          INTEGER               NOT NULL);
CREATE UNIQUE INDEX IF NOT EXISTS pose_prior_data_assignment ON
   pose_priors(corr_data_id, corr_sensor_id, corr_sensor_type);
CREATE TABLE IF NOT EXISTS keypoints
   (image_id  INTEGER  PRIMARY KEY  NOT NULL,
    rows      INTEGER               NOT NULL,
    cols      INTEGER               NOT NULL,
    data      BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS descriptors
   (image_id      INTEGER  PRIMARY KEY  NOT NULL,
    type          INTEGER               NOT NULL,
    rows          INTEGER               NOT NULL,
    cols          INTEGER               NOT NULL,
    data          BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS matches
   (pair_id  INTEGER  PRIMARY KEY  NOT NULL,
    rows     INTEGER               NOT NULL,
    cols     INTEGER               NOT NULL,
    data     BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries
   (pair_id  INTEGER  PRIMARY KEY  NOT NULL,
    rows     INTEGER               NOT NULL,
    cols     INTEGER               NOT NULL,
    data     BLOB,
    config   INTEGER               NOT NULL,
    F        BLOB,
    E        BLOB,
    H        BLOB,
    qvec     BLOB,
    tvec     BLOB,
    camera1  BLOB,
    camera2  BLOB);
"""


def _mat_blob(m) -> Optional[bytes]:
    if m is None:
        return None
    return np.ascontiguousarray(np.asarray(m, dtype=np.float64)).tobytes()


def _blob_mat(b, shape) -> Optional[np.ndarray]:
    if b is None:
        return None
    return np.frombuffer(b, dtype=np.float64).reshape(shape).copy()


class Database:
    """Python counterpart of the reference Database (sqlite backend)."""

    def __init__(self, path: str = ":memory:", must_exist: bool = False):
        if must_exist and path != ":memory:" and not os.path.exists(path):
            raise FileNotFoundError(f"Database does not exist: {path}")
        self.conn = sqlite3.connect(path)
        self.conn.executescript(_SCHEMA)
        self.conn.commit()

    def close(self):
        self.conn.commit()
        self.conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- rigs --------------------------------------------------------------
    def write_rig(self, rig: Rig, use_rig_id: bool = True) -> int:
        cur = self.conn.execute(
            "INSERT INTO rigs(rig_id, ref_sensor_id, ref_sensor_type) VALUES(?,?,?)",
            (rig.rig_id if use_rig_id else None, rig.ref_sensor_id[1], rig.ref_sensor_id[0]),
        )
        rig_id = cur.lastrowid
        for (s_type, s_id), pose in rig.sensors.items():
            blob = None
            if pose is not None:
                blob = np.concatenate([pose.quat, pose.t]).astype(np.float64).tobytes()
            self.conn.execute(
                "INSERT INTO rig_sensors(rig_id, sensor_id, sensor_type, sensor_from_rig)"
                " VALUES(?,?,?,?)",
                (rig_id, s_id, s_type, blob),
            )
        return rig_id

    def read_rigs(self) -> List[Rig]:
        rigs = []
        for rig_id, ref_id, ref_type in self.conn.execute(
            "SELECT rig_id, ref_sensor_id, ref_sensor_type FROM rigs ORDER BY rig_id"
        ):
            rig = Rig(rig_id=rig_id, ref_sensor_id=(ref_type, ref_id))
            for s_id, s_type, blob in self.conn.execute(
                "SELECT sensor_id, sensor_type, sensor_from_rig FROM rig_sensors"
                " WHERE rig_id=?",
                (rig_id,),
            ):
                pose = None
                if blob is not None:
                    v = np.frombuffer(blob, dtype=np.float64)
                    pose = Pose(v[:4].copy(), v[4:].copy())
                rig.sensors[(s_type, s_id)] = pose
            rigs.append(rig)
        return rigs

    # -- cameras -----------------------------------------------------------
    def write_camera(self, camera: Camera, use_camera_id: bool = True) -> int:
        cur = self.conn.execute(
            "INSERT INTO cameras(camera_id, model, width, height, params,"
            " prior_focal_length) VALUES(?,?,?,?,?,?)",
            (
                camera.camera_id if use_camera_id else None,
                int(camera.model_id),
                int(camera.width),
                int(camera.height),
                np.asarray(camera.params, dtype=np.float64).tobytes(),
                int(camera.has_prior_focal_length),
            ),
        )
        return cur.lastrowid

    def read_cameras(self) -> Dict[int, Camera]:
        out = {}
        for cid, model, w, h, params, prior in self.conn.execute(
            "SELECT camera_id, model, width, height, params, prior_focal_length"
            " FROM cameras"
        ):
            out[cid] = Camera(
                camera_id=cid, model_id=model, width=w, height=h,
                params=np.frombuffer(params, dtype=np.float64).copy(),
                has_prior_focal_length=bool(prior),
            )
        return out

    def read_camera(self, camera_id: int) -> Camera:
        return self.read_cameras()[camera_id]

    def update_camera(self, camera: Camera):
        self.conn.execute(
            "UPDATE cameras SET model=?, width=?, height=?, params=?,"
            " prior_focal_length=? WHERE camera_id=?",
            (
                int(camera.model_id), int(camera.width), int(camera.height),
                np.asarray(camera.params, dtype=np.float64).tobytes(),
                int(camera.has_prior_focal_length), camera.camera_id,
            ),
        )

    # -- frames ------------------------------------------------------------
    def write_frame(self, frame: Frame, use_frame_id: bool = True) -> int:
        cur = self.conn.execute(
            "INSERT INTO frames(frame_id, rig_id) VALUES(?,?)",
            (frame.frame_id if use_frame_id else None, frame.rig_id),
        )
        frame_id = cur.lastrowid
        for (s_type, s_id, d_id) in frame.data_ids:
            self.conn.execute(
                "INSERT INTO frame_data(frame_id, data_id, sensor_id, sensor_type)"
                " VALUES(?,?,?,?)",
                (frame_id, d_id, s_id, s_type),
            )
        return frame_id

    def read_frames(self) -> List[Frame]:
        frames = []
        for (frame_id, rig_id) in self.conn.execute(
            "SELECT frame_id, rig_id FROM frames ORDER BY frame_id"
        ):
            frame = Frame(frame_id=frame_id, rig_id=rig_id)
            for d_id, s_id, s_type in self.conn.execute(
                "SELECT data_id, sensor_id, sensor_type FROM frame_data WHERE frame_id=?",
                (frame_id,),
            ):
                frame.data_ids.append((s_type, s_id, d_id))
            frames.append(frame)
        return frames

    # -- images ------------------------------------------------------------
    def write_image(self, name: str, camera_id: int, image_id: Optional[int] = None) -> int:
        cur = self.conn.execute(
            "INSERT INTO images(image_id, name, camera_id) VALUES(?,?,?)",
            (image_id, name, camera_id),
        )
        return cur.lastrowid

    def read_images(self) -> List[Tuple[int, str, int]]:
        return list(
            self.conn.execute("SELECT image_id, name, camera_id FROM images ORDER BY image_id")
        )

    def num_images(self) -> int:
        return self.conn.execute("SELECT COUNT(*) FROM images").fetchone()[0]

    # -- pose priors -------------------------------------------------------
    def write_pose_prior(
        self, image_id: int, position=None, covariance=None, gravity=None,
        coordinate_system: int = -1, sensor_id: Tuple[int, int] = None,
    ):
        if sensor_id is None:
            sensor_id = (int(SensorType.CAMERA), 0)
        self.conn.execute(
            "INSERT INTO pose_priors(pose_prior_id, corr_data_id, corr_sensor_id,"
            " corr_sensor_type, position, position_covariance, gravity,"
            " coordinate_system) VALUES(?,?,?,?,?,?,?,?)",
            (
                image_id, image_id, sensor_id[1], sensor_id[0],
                _mat_blob(position), _mat_blob(covariance), _mat_blob(gravity),
                coordinate_system,
            ),
        )

    def read_pose_priors(self) -> Dict[int, dict]:
        out = {}
        for (pid, did, sid, stype, pos, cov, grav, cs) in self.conn.execute(
            "SELECT pose_prior_id, corr_data_id, corr_sensor_id, corr_sensor_type,"
            " position, position_covariance, gravity, coordinate_system FROM pose_priors"
        ):
            out[pid] = dict(
                data_id=did,
                sensor_id=(stype, sid),
                position=_blob_mat(pos, (3,)),
                covariance=_blob_mat(cov, (3, 3)),
                gravity=_blob_mat(grav, (3,)),
                coordinate_system=cs,
            )
        return out

    # -- keypoints / descriptors -------------------------------------------
    def write_keypoints(self, image_id: int, keypoints: np.ndarray):
        kp = np.ascontiguousarray(np.asarray(keypoints, dtype=np.float32))
        if kp.ndim != 2 or kp.shape[1] not in (2, 4, 6):
            raise ValueError("keypoints must be (N, 2|4|6)")
        self.conn.execute(
            "INSERT OR REPLACE INTO keypoints(image_id, rows, cols, data) VALUES(?,?,?,?)",
            (image_id, kp.shape[0], kp.shape[1], kp.tobytes()),
        )

    def read_keypoints(self, image_id: int) -> np.ndarray:
        row = self.conn.execute(
            "SELECT rows, cols, data FROM keypoints WHERE image_id=?", (image_id,)
        ).fetchone()
        if row is None:
            return np.zeros((0, 2), dtype=np.float32)
        rows, cols, data = row
        if rows == 0:
            return np.zeros((0, cols or 2), dtype=np.float32)
        return np.frombuffer(data, dtype=np.float32).reshape(rows, cols).copy()

    def exists_keypoints(self, image_id: int) -> bool:
        return (
            self.conn.execute(
                "SELECT 1 FROM keypoints WHERE image_id=?", (image_id,)
            ).fetchone()
            is not None
        )

    def write_descriptors(
        self, image_id: int, descriptors: np.ndarray,
        feature_type: int = FeatureExtractorType.SIFT,
    ):
        d = np.ascontiguousarray(np.asarray(descriptors, dtype=np.uint8))
        self.conn.execute(
            "INSERT OR REPLACE INTO descriptors(image_id, type, rows, cols, data)"
            " VALUES(?,?,?,?,?)",
            (image_id, feature_type, d.shape[0], d.shape[1], d.tobytes()),
        )

    def read_descriptors(self, image_id: int) -> np.ndarray:
        row = self.conn.execute(
            "SELECT rows, cols, data FROM descriptors WHERE image_id=?", (image_id,)
        ).fetchone()
        if row is None:
            return np.zeros((0, 128), dtype=np.uint8)
        rows, cols, data = row
        if rows == 0:
            return np.zeros((0, cols or 128), dtype=np.uint8)
        return np.frombuffer(data, dtype=np.uint8).reshape(rows, cols).copy()

    # -- matches -----------------------------------------------------------
    def write_matches(self, image_id1: int, image_id2: int, matches: np.ndarray):
        m = np.ascontiguousarray(np.asarray(matches, dtype=np.uint32)).reshape(-1, 2)
        if should_swap_image_pair(image_id1, image_id2):
            m = m[:, ::-1]
        pair_id = image_pair_to_pair_id(image_id1, image_id2)
        self.conn.execute(
            "INSERT OR REPLACE INTO matches(pair_id, rows, cols, data) VALUES(?,?,?,?)",
            (pair_id, m.shape[0], 2, np.ascontiguousarray(m).tobytes()),
        )

    def read_matches(self, image_id1: int, image_id2: int) -> np.ndarray:
        pair_id = image_pair_to_pair_id(image_id1, image_id2)
        row = self.conn.execute(
            "SELECT rows, data FROM matches WHERE pair_id=?", (pair_id,)
        ).fetchone()
        if row is None or row[0] == 0:
            return np.zeros((0, 2), dtype=np.uint32)
        m = np.frombuffer(row[1], dtype=np.uint32).reshape(row[0], 2).copy()
        if should_swap_image_pair(image_id1, image_id2):
            m = m[:, ::-1]
        return m

    def read_all_matches(self) -> List[Tuple[int, np.ndarray]]:
        out = []
        for pair_id, rows, data in self.conn.execute(
            "SELECT pair_id, rows, data FROM matches"
        ):
            m = (
                np.frombuffer(data, dtype=np.uint32).reshape(rows, 2).copy()
                if rows
                else np.zeros((0, 2), dtype=np.uint32)
            )
            out.append((pair_id, m))
        return out

    def num_matched_pairs(self) -> int:
        return self.conn.execute("SELECT COUNT(*) FROM matches").fetchone()[0]

    # -- two-view geometries -----------------------------------------------
    def write_two_view_geometry(self, image_id1: int, image_id2: int, g: TwoViewGeometry):
        m = np.ascontiguousarray(np.asarray(g.inlier_matches, dtype=np.uint32)).reshape(-1, 2)
        swap = should_swap_image_pair(image_id1, image_id2)
        if swap:
            m = np.ascontiguousarray(m[:, ::-1])
        pair_id = image_pair_to_pair_id(image_id1, image_id2)
        F, E, H = g.F, g.E, g.H
        qvec = tvec = None
        if g.cam2_from_cam1 is not None:
            pose = g.cam2_from_cam1
            if swap:
                pose = pose.inverse()
            qvec, tvec = pose.quat, pose.t
        if swap:
            # Invert the epipolar relations for the swapped storage order.
            F = F.T if F is not None else None
            E = E.T if E is not None else None
            H = np.linalg.inv(H) if H is not None else None
        self.conn.execute(
            "INSERT OR REPLACE INTO two_view_geometries(pair_id, rows, cols, data,"
            " config, F, E, H, qvec, tvec) VALUES(?,?,?,?,?,?,?,?,?,?)",
            (
                pair_id, m.shape[0], 2, m.tobytes(), int(g.config),
                _mat_blob(F), _mat_blob(E), _mat_blob(H),
                _mat_blob(qvec), _mat_blob(tvec),
            ),
        )

    def read_two_view_geometry(self, image_id1: int, image_id2: int) -> Optional[TwoViewGeometry]:
        pair_id = image_pair_to_pair_id(image_id1, image_id2)
        row = self.conn.execute(
            "SELECT rows, data, config, F, E, H, qvec, tvec FROM two_view_geometries"
            " WHERE pair_id=?",
            (pair_id,),
        ).fetchone()
        if row is None:
            return None
        rows, data, config, F, E, H, qvec, tvec = row
        m = (
            np.frombuffer(data, dtype=np.uint32).reshape(rows, 2).copy()
            if rows
            else np.zeros((0, 2), dtype=np.uint32)
        )
        g = TwoViewGeometry(
            config=config,
            F=_blob_mat(F, (3, 3)),
            E=_blob_mat(E, (3, 3)),
            H=_blob_mat(H, (3, 3)),
            inlier_matches=m,
        )
        q = _blob_mat(qvec, (4,))
        t = _blob_mat(tvec, (3,))
        if q is not None and t is not None:
            g.cam2_from_cam1 = Pose(q, t)
        if should_swap_image_pair(image_id1, image_id2):
            g.inlier_matches = g.inlier_matches[:, ::-1].copy()
            g.F = g.F.T if g.F is not None else None
            g.E = g.E.T if g.E is not None else None
            g.H = np.linalg.inv(g.H) if g.H is not None else None
            if g.cam2_from_cam1 is not None:
                g.cam2_from_cam1 = g.cam2_from_cam1.inverse()
        return g

    def read_all_two_view_geometries(self):
        """Yields (image_id1, image_id2, TwoViewGeometry) in stored order."""
        pair_ids = [
            r[0] for r in self.conn.execute("SELECT pair_id FROM two_view_geometries")
        ]
        for pair_id in pair_ids:
            id1, id2 = pair_id_to_image_pair(pair_id)
            yield id1, id2, self.read_two_view_geometry(id1, id2)

    def num_verified_pairs(self) -> int:
        return self.conn.execute(
            "SELECT COUNT(*) FROM two_view_geometries WHERE rows > 0"
        ).fetchone()[0]

    def commit(self):
        self.conn.commit()
