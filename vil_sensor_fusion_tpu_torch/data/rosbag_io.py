"""Python bindings for the repository's native rosbag reader
(``csrc/bagreader.cpp`` at the repository root).

Port of ``vil_sensor_fusion_tpu/data/rosbag_io.py`` with the same C
signatures: decode a recorded bag's IMU / odometry / point-cloud / image
topics straight into numpy arrays once; ingestion (``data.ingest``) then
moves them onto the device. The shared library is built with ``g++`` at
first use into ``build/native/`` (``_build.load_host``), apart from the
JAX package's own build of the same source. The reader opens ``libbz2``
and ``liblz4`` with ``dlopen`` when a bag has compressed chunks.
"""

from __future__ import annotations

import ctypes as ct
import os
from pathlib import Path

import numpy as np

from .. import _build

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "bagreader.cpp"
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load_host(SOURCE)
    lib.bag_open.restype = ct.c_void_p
    lib.bag_open.argtypes = [ct.c_char_p]
    lib.bag_close.argtypes = [ct.c_void_p]
    lib.bag_error.restype = ct.c_char_p
    lib.bag_error.argtypes = [ct.c_void_p]
    lib.bag_num_connections.restype = ct.c_int
    lib.bag_num_connections.argtypes = [ct.c_void_p]
    lib.bag_connection_topic.restype = ct.c_char_p
    lib.bag_connection_topic.argtypes = [ct.c_void_p, ct.c_int]
    lib.bag_connection_type.restype = ct.c_char_p
    lib.bag_connection_type.argtypes = [ct.c_void_p, ct.c_int]
    lib.bag_topic_count.restype = ct.c_long
    lib.bag_topic_count.argtypes = [ct.c_void_p, ct.c_char_p]
    d = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    f = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.bag_read_imu.restype = ct.c_long
    lib.bag_read_imu.argtypes = [ct.c_void_p, ct.c_char_p, d, d, d, ct.c_long]
    lib.bag_read_odometry.restype = ct.c_long
    lib.bag_read_odometry.argtypes = [
        ct.c_void_p, ct.c_char_p, d, d, d, d, ct.c_long]
    lib.bag_read_pointcloud.restype = ct.c_long
    lib.bag_read_pointcloud.argtypes = [
        ct.c_void_p, ct.c_char_p, ct.c_long,
        ct.POINTER(ct.c_double), f, ct.c_long]
    lib.bag_image_meta.restype = ct.c_long
    lib.bag_image_meta.argtypes = [
        ct.c_void_p, ct.c_char_p, ct.c_long, ct.POINTER(ct.c_double),
        ct.POINTER(ct.c_long), ct.POINTER(ct.c_long), ct.POINTER(ct.c_long),
        ct.c_char_p, ct.c_long]
    lib.bag_read_image.restype = ct.c_long
    lib.bag_read_image.argtypes = [
        ct.c_void_p, ct.c_char_p, ct.c_long, u8, ct.c_long]
    lib.bag_topic_stamps.restype = ct.c_long
    lib.bag_topic_stamps.argtypes = [ct.c_void_p, ct.c_char_p, d, ct.c_long]
    lib.bag_record_size.restype = ct.c_long
    lib.bag_record_size.argtypes = [ct.c_void_p, ct.c_char_p, ct.c_long]
    lib.bag_read_record.restype = ct.c_long
    lib.bag_read_record.argtypes = [
        ct.c_void_p, ct.c_char_p, ct.c_long, ct.POINTER(ct.c_double),
        u8, ct.c_long]
    _lib = lib
    return lib


class BagReader:
    """Read one rosbag v2.0 file (plain, bz2- or lz4-compressed chunks)."""

    def __init__(self, path: str | os.PathLike):
        lib = _load()
        self._lib = lib
        self._h = lib.bag_open(str(path).encode())
        err = lib.bag_error(self._h).decode()
        if err:
            lib.bag_close(self._h)
            self._h = None
            raise IOError(f"{path}: {err}")

    def close(self):
        if self._h is not None:
            self._lib.bag_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def topics(self) -> dict[str, str]:
        n = self._lib.bag_num_connections(self._h)
        return {
            self._lib.bag_connection_topic(self._h, i).decode():
            self._lib.bag_connection_type(self._h, i).decode()
            for i in range(n)
        }

    def count(self, topic: str) -> int:
        return int(self._lib.bag_topic_count(self._h, topic.encode()))

    def stamps(self, topic: str) -> np.ndarray:
        n = self.count(topic)
        t = np.zeros(n, np.float64)
        m = self._lib.bag_topic_stamps(self._h, topic.encode(), t, n)
        return t[:m]

    def read_imu(self, topic: str):
        """→ (times (N,), accel (N,3), gyro (N,3))."""
        n = self.count(topic)
        t = np.zeros(n, np.float64)
        a = np.zeros((n, 3), np.float64)
        g = np.zeros((n, 3), np.float64)
        m = self._lib.bag_read_imu(self._h, topic.encode(),
                                   t, a.reshape(-1), g.reshape(-1), n)
        return t[:m], a[:m], g[:m]

    def read_odometry(self, topic: str):
        """→ (times, pose7 (N,7) [qw qx qy qz t], pose_cov (N,6,6),
        twist_cov (N,6,6))."""
        n = self.count(topic)
        t = np.zeros(n, np.float64)
        p = np.zeros((n, 7), np.float64)
        pc = np.zeros((n, 36), np.float64)
        tc = np.zeros((n, 36), np.float64)
        m = self._lib.bag_read_odometry(
            self._h, topic.encode(), t, p.reshape(-1), pc.reshape(-1),
            tc.reshape(-1), n)
        return (t[:m], p[:m], pc[:m].reshape(-1, 6, 6),
                tc[:m].reshape(-1, 6, 6))

    def read_pointcloud(self, topic: str, index: int,
                        max_points: int = 1 << 20):
        """→ (stamp, xyz (P,3) float32)."""
        t = ct.c_double()
        xyz = np.zeros((max_points, 3), np.float32)
        n = self._lib.bag_read_pointcloud(
            self._h, topic.encode(), index, ct.byref(t),
            xyz.reshape(-1), max_points)
        if n < 0:
            raise IOError(f"cannot decode PointCloud2 #{index} on {topic}")
        return t.value, xyz[:n]

    def read_record(self, topic: str, index: int) -> tuple[float, bytes]:
        """→ (record_time_s, raw serialized message bytes) — the verbatim
        payload, for passthrough rewriting (fix-time)."""
        size = self._lib.bag_record_size(self._h, topic.encode(), index)
        if size < 0:
            raise IOError(f"no record #{index} on {topic}")
        t = ct.c_double()
        buf = np.zeros(max(size, 1), np.uint8)
        n = self._lib.bag_read_record(self._h, topic.encode(), index,
                                      ct.byref(t), buf, size)
        if n < 0:
            raise IOError(f"record read failed: {topic}#{index}")
        return t.value, buf[:n].tobytes()

    def read_image(self, topic: str, index: int):
        """→ (stamp, array (H, W[, C]) uint8, encoding)."""
        t = ct.c_double()
        h = ct.c_long(); w = ct.c_long(); step = ct.c_long()
        enc = ct.create_string_buffer(64)
        r = self._lib.bag_image_meta(
            self._h, topic.encode(), index, ct.byref(t), ct.byref(h),
            ct.byref(w), ct.byref(step), enc, 64)
        if r != 0:
            raise IOError(f"cannot decode Image #{index} on {topic}")
        buf = np.zeros(h.value * step.value, np.uint8)
        n = self._lib.bag_read_image(self._h, topic.encode(), index,
                                     buf, len(buf))
        if n < 0:
            raise IOError("image payload read failed")
        encoding = enc.value.decode()
        img = buf[:n].reshape(h.value, step.value)
        ch = step.value // max(w.value, 1)
        if ch > 1:
            img = img[:, : w.value * ch].reshape(h.value, w.value, ch)
        else:
            img = img[:, : w.value]
        return t.value, img, encoding
