"""COLMAP-compatible sparse model I/O (binary and text).

Counterpart of colmap_tpu/scene/reconstruction_io.py: both write the same
bytes. reference behavior: src/colmap/scene/reconstruction_io_binary.cc and
reconstruction_io_text.cc; format spec in doc/format.rst. Byte-for-byte
compatible so models can be exchanged with the reference for validation.

Files: rigs / cameras / frames / images / points3D with .bin or .txt
extension. Reading a legacy (rig-less) model synthesizes trivial rigs and
frames (reference: ReadImagesBinary legacy path, io_binary.cc:173-250).
"""

from __future__ import annotations

import os
import struct
from typing import BinaryIO

import numpy as np

from colmap_tpu_torch.scene.reconstruction import Reconstruction
from colmap_tpu_torch.scene.types import (
    INVALID_POINT3D,
    Camera,
    Frame,
    Image,
    Point3D,
    Pose,
    Rig,
    TrackElement,
)
from colmap_tpu_torch.sensor import models as camera_models
from colmap_tpu_torch.utils.types import SensorType

_U8 = struct.Struct("<B")
_U32 = struct.Struct("<I")
_I32 = struct.Struct("<i")
_U64 = struct.Struct("<Q")
_D = struct.Struct("<d")


def _read(f: BinaryIO, s: struct.Struct):
    return s.unpack(f.read(s.size))[0]


def _read_pose7(f: BinaryIO) -> Pose:
    vals = struct.unpack("<7d", f.read(56))
    return Pose(np.array(vals[:4]), np.array(vals[4:]))


def _write_pose7(f: BinaryIO, pose: Pose):
    f.write(struct.pack("<7d", *pose.quat, *pose.t))


# --------------------------------------------------------------------------
# Binary readers
# --------------------------------------------------------------------------


def read_rigs_binary(recon: Reconstruction, path: str):
    with open(path, "rb") as f:
        num_rigs = _read(f, _U64)
        for _ in range(num_rigs):
            rig_id = _read(f, _U32)
            num_sensors = _read(f, _U32)
            rig = Rig(rig_id=rig_id)
            if num_sensors > 0:
                ref_type = _read(f, _I32)
                ref_id = _read(f, _U32)
                rig.ref_sensor_id = (ref_type, ref_id)
                for _ in range(num_sensors - 1):
                    s_type = _read(f, _I32)
                    s_id = _read(f, _U32)
                    has_pose = _read(f, _U8)
                    pose = _read_pose7(f) if has_pose else None
                    rig.sensors[(s_type, s_id)] = pose
            recon.add_rig(rig)


def read_cameras_binary(recon: Reconstruction, path: str):
    with open(path, "rb") as f:
        num_cameras = _read(f, _U64)
        for _ in range(num_cameras):
            camera_id = _read(f, _U32)
            model_id = _read(f, _I32)
            width = _read(f, _U64)
            height = _read(f, _U64)
            n = camera_models.model_num_params(model_id)
            params = np.array(struct.unpack(f"<{n}d", f.read(8 * n)))
            recon.add_camera(
                Camera(camera_id=camera_id, model_id=model_id, width=width,
                       height=height, params=params)
            )


def read_frames_binary(recon: Reconstruction, path: str):
    with open(path, "rb") as f:
        num_frames = _read(f, _U64)
        for _ in range(num_frames):
            frame_id = _read(f, _U32)
            rig_id = _read(f, _U32)
            pose = _read_pose7(f)
            num_data = _read(f, _U32)
            data_ids = []
            for _ in range(num_data):
                s_type = _read(f, _I32)
                s_id = _read(f, _U32)
                d_id = _read(f, _U64)
                data_ids.append((s_type, s_id, d_id))
            recon.add_frame(
                Frame(frame_id=frame_id, rig_id=rig_id, rig_from_world=pose,
                      data_ids=data_ids)
            )


def read_images_binary(recon: Reconstruction, path: str, legacy: bool):
    # Map image_id -> frame for the non-legacy path.
    image_to_frame = {}
    for frame in recon.frames.values():
        for (s_type, _s_id, d_id) in frame.data_ids:
            if s_type == int(SensorType.CAMERA):
                image_to_frame[d_id] = frame
    with open(path, "rb") as f:
        num_images = _read(f, _U64)
        for _ in range(num_images):
            image_id = _read(f, _U32)
            cam_from_world = _read_pose7(f)
            camera_id = _read(f, _U32)
            name_bytes = bytearray()
            while True:
                c = f.read(1)
                if c == b"\x00" or c == b"":
                    break
                name_bytes += c
            name = name_bytes.decode("utf-8")
            num_p2d = _read(f, _U64)
            if num_p2d > 0:
                raw = np.frombuffer(f.read(24 * num_p2d), dtype=np.uint8)
                rec = raw.view([("x", "<f8"), ("y", "<f8"), ("p3d", "<u8")])
                xy = np.stack([rec["x"], rec["y"]], axis=-1).astype(np.float64)
                # uint64-max wraps to -1 == INVALID_POINT3D on the int64 cast.
                p3d = rec["p3d"].astype(np.int64)
            else:
                xy = np.zeros((0, 2))
                p3d = np.full(0, INVALID_POINT3D, dtype=np.int64)
            image = Image(image_id=image_id, name=name, camera_id=camera_id)
            image.points2D_xy = xy
            image.points2D_p3d = p3d
            if legacy:
                # Trivial rig/frame per image (backwards compat).
                rig = Rig(rig_id=image_id,
                          ref_sensor_id=(int(SensorType.CAMERA), camera_id))
                if rig.rig_id not in recon.rigs:
                    recon.add_rig(rig)
                frame = Frame(
                    frame_id=image_id, rig_id=rig.rig_id,
                    rig_from_world=cam_from_world,
                    data_ids=[(int(SensorType.CAMERA), camera_id, image_id)],
                )
                recon.add_frame(frame)
                image.frame_id = frame.frame_id
            else:
                image.frame_id = image_to_frame[image_id].frame_id
            recon.add_image(image)
            recon.register_frame(image.frame_id)


def read_points3D_binary(recon: Reconstruction, path: str):
    with open(path, "rb") as f:
        num_points = _read(f, _U64)
        max_id = 0
        for _ in range(num_points):
            point3D_id = _read(f, _U64)
            xyz = np.array(struct.unpack("<3d", f.read(24)))
            color = np.frombuffer(f.read(3), dtype=np.uint8).copy()
            error = _read(f, _D)
            track_len = _read(f, _U64)
            raw = np.frombuffer(f.read(8 * track_len), dtype="<u4").reshape(-1, 2)
            track = [TrackElement(int(a), int(b)) for a, b in raw]
            recon.points3D[point3D_id] = Point3D(
                xyz=xyz, color=color, error=error, track=track
            )
            max_id = max(max_id, point3D_id)
        recon._next_point3D_id = max_id + 1


# --------------------------------------------------------------------------
# Binary writers
# --------------------------------------------------------------------------


def write_rigs_binary(recon: Reconstruction, path: str):
    with open(path, "wb") as f:
        f.write(_U64.pack(recon.num_rigs()))
        for rig_id in sorted(recon.rigs):
            rig = recon.rigs[rig_id]
            f.write(_U32.pack(rig_id))
            f.write(_U32.pack(rig.num_sensors()))
            f.write(_I32.pack(rig.ref_sensor_id[0]))
            f.write(_U32.pack(rig.ref_sensor_id[1]))
            for (s_type, s_id), pose in sorted(rig.sensors.items()):
                f.write(_I32.pack(s_type))
                f.write(_U32.pack(s_id))
                f.write(_U8.pack(1 if pose is not None else 0))
                if pose is not None:
                    _write_pose7(f, pose)


def write_cameras_binary(recon: Reconstruction, path: str):
    with open(path, "wb") as f:
        f.write(_U64.pack(recon.num_cameras()))
        for camera_id in sorted(recon.cameras):
            cam = recon.cameras[camera_id]
            f.write(_U32.pack(camera_id))
            f.write(_I32.pack(int(cam.model_id)))
            f.write(_U64.pack(int(cam.width)))
            f.write(_U64.pack(int(cam.height)))
            f.write(struct.pack(f"<{len(cam.params)}d", *cam.params))


def write_frames_binary(recon: Reconstruction, path: str):
    reg = recon.reg_frame_ids()
    with open(path, "wb") as f:
        f.write(_U64.pack(len(reg)))
        for frame_id in reg:
            frame = recon.frames[frame_id]
            f.write(_U32.pack(frame_id))
            f.write(_U32.pack(frame.rig_id))
            _write_pose7(f, frame.rig_from_world)
            f.write(_U32.pack(len(frame.data_ids)))
            for (s_type, s_id, d_id) in frame.data_ids:
                f.write(_I32.pack(s_type))
                f.write(_U32.pack(s_id))
                f.write(_U64.pack(d_id))


def write_images_binary(recon: Reconstruction, path: str):
    reg_image_ids = recon.reg_image_ids()
    with open(path, "wb") as f:
        f.write(_U64.pack(len(reg_image_ids)))
        for image_id in reg_image_ids:
            image = recon.images[image_id]
            f.write(_U32.pack(image_id))
            _write_pose7(f, recon.cam_from_world(image_id))
            f.write(_U32.pack(image.camera_id))
            f.write(image.name.encode("utf-8") + b"\x00")
            n = image.num_points2D()
            f.write(_U64.pack(n))
            if n:
                rec = np.empty(n, dtype=[("x", "<f8"), ("y", "<f8"), ("p3d", "<u8")])
                rec["x"] = image.points2D_xy[:, 0]
                rec["y"] = image.points2D_xy[:, 1]
                # -1 wraps back to uint64-max (the reference's invalid id).
                rec["p3d"] = image.points2D_p3d.astype(np.int64).astype(np.uint64)
                f.write(rec.tobytes())


def write_points3D_binary(recon: Reconstruction, path: str):
    with open(path, "wb") as f:
        f.write(_U64.pack(recon.num_points3D()))
        for point3D_id in sorted(recon.points3D):
            p = recon.points3D[point3D_id]
            f.write(_U64.pack(point3D_id))
            f.write(struct.pack("<3d", *p.xyz))
            f.write(np.asarray(p.color, dtype=np.uint8).tobytes())
            f.write(_D.pack(p.error))
            f.write(_U64.pack(len(p.track)))
            arr = np.array(
                [(el.image_id, el.point2D_idx) for el in p.track], dtype="<u4"
            )
            f.write(arr.tobytes())


# --------------------------------------------------------------------------
# Text format
# --------------------------------------------------------------------------


def _fmt(x: float) -> str:
    return repr(float(x))


def write_cameras_text(recon: Reconstruction, path: str):
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n")
        f.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        f.write(f"# Number of cameras: {recon.num_cameras()}\n")
        for camera_id in sorted(recon.cameras):
            cam = recon.cameras[camera_id]
            params = " ".join(_fmt(p) for p in cam.params)
            f.write(f"{camera_id} {cam.model_name} {cam.width} {cam.height} {params}\n")


def read_cameras_text(recon: Reconstruction, path: str):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            recon.add_camera(
                Camera(
                    camera_id=int(parts[0]),
                    model_id=int(camera_models.MODEL_NAME_TO_ID[parts[1]]),
                    width=int(parts[2]),
                    height=int(parts[3]),
                    params=np.array([float(p) for p in parts[4:]]),
                )
            )


def write_images_text(recon: Reconstruction, path: str):
    reg = recon.reg_image_ids()
    n_obs = sum(recon.images[i].num_points3D() for i in reg)
    mean_obs = n_obs / max(len(reg), 1)
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n")
        f.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        f.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        f.write(f"# Number of images: {len(reg)}, mean observations per image: {mean_obs}\n")
        for image_id in reg:
            image = recon.images[image_id]
            pose = recon.cam_from_world(image_id)
            vals = " ".join(_fmt(v) for v in list(pose.quat) + list(pose.t))
            f.write(f"{image_id} {vals} {image.camera_id} {image.name}\n")
            elems = []
            for (x, y), p3d in zip(image.points2D_xy, image.points2D_p3d):
                pid = -1 if p3d == INVALID_POINT3D else int(p3d)
                elems.append(f"{_fmt(x)} {_fmt(y)} {pid}")
            f.write(" ".join(elems) + "\n")


def read_images_text(recon: Reconstruction, path: str, legacy: bool = True):
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip() and not l.startswith("#")]
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        image_id = int(parts[0])
        quat = np.array([float(p) for p in parts[1:5]])
        t = np.array([float(p) for p in parts[5:8]])
        camera_id = int(parts[8])
        name = parts[9]
        image = Image(image_id=image_id, name=name, camera_id=camera_id)
        if i + 1 < len(lines):
            pts = lines[i + 1].split()
            n = len(pts) // 3
            xy = np.zeros((n, 2))
            p3d = np.full(n, INVALID_POINT3D, dtype=np.int64)
            for j in range(n):
                xy[j] = [float(pts[3 * j]), float(pts[3 * j + 1])]
                pid = int(pts[3 * j + 2])
                p3d[j] = INVALID_POINT3D if pid == -1 else pid
            image.points2D_xy, image.points2D_p3d = xy, p3d
        cam_from_world = Pose(quat, t)
        if legacy:
            rig = Rig(rig_id=image_id, ref_sensor_id=(int(SensorType.CAMERA), camera_id))
            recon.add_rig(rig)
            frame = Frame(
                frame_id=image_id, rig_id=rig.rig_id, rig_from_world=cam_from_world,
                data_ids=[(int(SensorType.CAMERA), camera_id, image_id)],
            )
            recon.add_frame(frame)
            image.frame_id = frame.frame_id
        recon.add_image(image)
        recon.register_frame(image.frame_id)


def write_points3D_text(recon: Reconstruction, path: str):
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n")
        f.write("#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        f.write(
            f"# Number of points: {recon.num_points3D()}, mean track length: "
            f"{recon.compute_mean_track_length()}\n"
        )
        for pid in sorted(recon.points3D):
            p = recon.points3D[pid]
            track = " ".join(f"{el.image_id} {el.point2D_idx}" for el in p.track)
            f.write(
                f"{pid} {_fmt(p.xyz[0])} {_fmt(p.xyz[1])} {_fmt(p.xyz[2])} "
                f"{int(p.color[0])} {int(p.color[1])} {int(p.color[2])} {_fmt(p.error)} {track}\n"
            )


def read_points3D_text(recon: Reconstruction, path: str):
    max_id = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            pid = int(parts[0])
            xyz = np.array([float(v) for v in parts[1:4]])
            color = np.array([int(v) for v in parts[4:7]], dtype=np.uint8)
            error = float(parts[7])
            track = [
                TrackElement(int(parts[8 + 2 * j]), int(parts[9 + 2 * j]))
                for j in range((len(parts) - 8) // 2)
            ]
            recon.points3D[pid] = Point3D(xyz=xyz, color=color, error=error, track=track)
            max_id = max(max_id, pid)
    recon._next_point3D_id = max_id + 1


# --------------------------------------------------------------------------
# Top-level read/write
# --------------------------------------------------------------------------


def write_model(recon: Reconstruction, path: str, fmt: str = "bin"):
    os.makedirs(path, exist_ok=True)
    if fmt == "bin":
        write_rigs_binary(recon, os.path.join(path, "rigs.bin"))
        write_cameras_binary(recon, os.path.join(path, "cameras.bin"))
        write_frames_binary(recon, os.path.join(path, "frames.bin"))
        write_images_binary(recon, os.path.join(path, "images.bin"))
        write_points3D_binary(recon, os.path.join(path, "points3D.bin"))
    elif fmt == "txt":
        write_cameras_text(recon, os.path.join(path, "cameras.txt"))
        write_images_text(recon, os.path.join(path, "images.txt"))
        write_points3D_text(recon, os.path.join(path, "points3D.txt"))
    else:
        raise ValueError(f"unknown format {fmt}")


def read_model(path: str) -> Reconstruction:
    recon = Reconstruction()
    if os.path.exists(os.path.join(path, "cameras.bin")):
        has_frames = os.path.exists(os.path.join(path, "frames.bin"))
        if os.path.exists(os.path.join(path, "rigs.bin")):
            read_rigs_binary(recon, os.path.join(path, "rigs.bin"))
        read_cameras_binary(recon, os.path.join(path, "cameras.bin"))
        if has_frames:
            read_frames_binary(recon, os.path.join(path, "frames.bin"))
        read_images_binary(recon, os.path.join(path, "images.bin"), legacy=not has_frames)
        read_points3D_binary(recon, os.path.join(path, "points3D.bin"))
    elif os.path.exists(os.path.join(path, "cameras.txt")):
        read_cameras_text(recon, os.path.join(path, "cameras.txt"))
        read_images_text(recon, os.path.join(path, "images.txt"))
        read_points3D_text(recon, os.path.join(path, "points3D.txt"))
    else:
        raise FileNotFoundError(f"no model found in {path}")
    return recon
