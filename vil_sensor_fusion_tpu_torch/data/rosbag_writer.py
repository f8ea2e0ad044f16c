"""Minimal pure-Python rosbag v2.0 writer.

Port of ``vil_sensor_fusion_tpu/data/rosbag_writer.py``, byte for byte:
synthesize or convert sensor streams → write a bag → ingest it with the
native reader (``csrc/bagreader.cpp``). It writes standard rosbag v2.0
files (http://wiki.ros.org/Bags/Format/2.0) with optional bz2 chunk
compression (``rosbag compress``'s default codec).

Supported message types — the sensor surface the reference records:
sensor_msgs/Imu, nav_msgs/Odometry, sensor_msgs/PointCloud2 (xyz float32),
sensor_msgs/Image (mono8 / rgb8). Payload arguments are numpy arrays (or
anything ``np.asarray`` reads, such as CPU tensors).
"""

from __future__ import annotations

import bz2
import struct

import numpy as np


def _field(name: str, value: bytes) -> bytes:
    body = name.encode() + b"=" + value
    return struct.pack("<I", len(body)) + body


def _record(fields: dict, data: bytes) -> bytes:
    hdr = b"".join(_field(k, v) for k, v in fields.items())
    return (struct.pack("<I", len(hdr)) + hdr
            + struct.pack("<I", len(data)) + data)


def _rosstr(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<I", len(b)) + b


def _header(stamp: float, frame: str = "sensor") -> bytes:
    sec = int(stamp)
    nsec = int(round((stamp - sec) * 1e9))
    return struct.pack("<III", 0, sec, nsec) + _rosstr(frame)


def imu_msg(stamp: float, gyro, accel, frame: str = "imu") -> bytes:
    """sensor_msgs/Imu payload (orientation identity, zero covariances)."""
    out = _header(stamp, frame)
    out += struct.pack("<4d", 0, 0, 0, 1)          # orientation (x y z w)
    out += struct.pack("<9d", *([0.0] * 9))
    out += struct.pack("<3d", *np.asarray(gyro, float))
    out += struct.pack("<9d", *([0.0] * 9))
    out += struct.pack("<3d", *np.asarray(accel, float))
    out += struct.pack("<9d", *([0.0] * 9))
    return out


def odometry_msg(stamp: float, pose7, pose_cov=None, twist_cov=None,
                 frame: str = "odom", child: str = "base") -> bytes:
    """nav_msgs/Odometry payload from a (qw qx qy qz tx ty tz) pose."""
    pose7 = np.asarray(pose7, float)
    qw, qx, qy, qz, tx, ty, tz = pose7
    pc = (np.zeros(36) if pose_cov is None
          else np.asarray(pose_cov, float).reshape(36))
    tc = (np.zeros(36) if twist_cov is None
          else np.asarray(twist_cov, float).reshape(36))
    out = _header(stamp, frame)
    out += _rosstr(child)
    out += struct.pack("<3d", tx, ty, tz)
    out += struct.pack("<4d", qx, qy, qz, qw)      # ROS order: x y z w
    out += struct.pack("<36d", *pc)
    out += struct.pack("<6d", *([0.0] * 6))        # twist
    out += struct.pack("<36d", *tc)
    return out


def pointcloud_msg(stamp: float, xyz: np.ndarray,
                   frame: str = "lidar") -> bytes:
    """sensor_msgs/PointCloud2 payload: unorganized float32 xyz points."""
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    n = len(xyz)
    out = _header(stamp, frame)
    out += struct.pack("<II", 1, n)                # height=1, width=n
    out += struct.pack("<I", 3)
    for i, name in enumerate(["x", "y", "z"]):
        out += _rosstr(name)
        out += struct.pack("<IBI", 4 * i, 7, 1)    # offset, FLOAT32, count
    out += struct.pack("<B", 0)                    # is_bigendian
    out += struct.pack("<II", 12, 12 * n)          # point_step, row_step
    data = xyz.tobytes()
    out += struct.pack("<I", len(data)) + data
    out += struct.pack("<B", 1)                    # is_dense
    return out


def image_msg(stamp: float, img: np.ndarray, frame: str = "cam") -> bytes:
    """sensor_msgs/Image payload: mono8 (H, W) or rgb8 (H, W, 3) uint8."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    out = _header(stamp, frame)
    out += struct.pack("<II", h, w)
    out += _rosstr("mono8" if ch == 1 else "rgb8")
    out += struct.pack("<B", 0)
    out += struct.pack("<I", w * ch)
    data = img.tobytes()
    out += struct.pack("<I", len(data)) + data
    return out


_ENCODERS = {
    "sensor_msgs/Imu": imu_msg,
    "nav_msgs/Odometry": odometry_msg,
    "sensor_msgs/PointCloud2": pointcloud_msg,
    "sensor_msgs/Image": image_msg,
}


class BagWriter:
    """Write a rosbag v2.0 file.

    ``compression``: "none" (default, rosbag record's default) or "bz2"
    (`rosbag compress`'s codec); chunks are cut at ``chunk_threshold`` bytes.
    """

    def __init__(self, path, compression: str = "none",
                 chunk_threshold: int = 1 << 20):
        if compression not in ("none", "bz2"):
            raise ValueError(f"unsupported compression: {compression}")
        self._path = str(path)
        self._compression = compression
        self._chunk_threshold = chunk_threshold
        self._topics: dict[str, int] = {}
        self._chunks: list[bytes] = []
        self._pending = b""
        self._closed = False

    # -- topics ---------------------------------------------------------------

    def add_topic(self, topic: str, datatype: str) -> int:
        if topic in self._topics:
            return self._topics[topic]
        conn_id = len(self._topics)
        self._topics[topic] = conn_id
        inner = (_field("topic", topic.encode())
                 + _field("type", datatype.encode())
                 + _field("md5sum", b"0" * 32)
                 + _field("message_definition", b""))
        # Connection records go into the chunk stream so readers that walk
        # chunks see them before any of the topic's messages.
        self._pending += _record(
            {"op": b"\x07", "conn": struct.pack("<i", conn_id),
             "topic": topic.encode()},
            inner)
        return conn_id

    # -- messages -------------------------------------------------------------

    def write(self, topic: str, stamp: float, payload: bytes):
        """Write a pre-encoded message payload."""
        if topic not in self._topics:
            raise KeyError(f"unknown topic {topic!r}; call add_topic first")
        t_ns = int(round(stamp * 1e9))
        time_field = struct.pack("<II", t_ns // 10 ** 9, t_ns % 10 ** 9)
        self._pending += _record(
            {"op": b"\x02",
             "conn": struct.pack("<i", self._topics[topic]),
             "time": time_field},
            payload)
        if len(self._pending) >= self._chunk_threshold:
            self._flush_chunk()

    def write_msg(self, topic: str, datatype: str, stamp: float,
                  *args, **kwargs):
        """Encode-and-write convenience for the supported message types."""
        self.add_topic(topic, datatype)
        enc = _ENCODERS.get(datatype)
        if enc is None:
            raise ValueError(f"no encoder for {datatype}")
        self.write(topic, stamp, enc(stamp, *args, **kwargs))

    # -- finalization -----------------------------------------------------------

    def _flush_chunk(self):
        if not self._pending:
            return
        raw = self._pending
        self._pending = b""
        if self._compression == "bz2":
            data = bz2.compress(raw)
            comp = b"bz2"
        else:
            data = raw
            comp = b"none"
        self._chunks.append(_record(
            {"op": b"\x05", "compression": comp,
             "size": struct.pack("<I", len(raw))},
            data))

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._flush_chunk()
        bag_header = _record(
            {"op": b"\x03",
             "index_pos": struct.pack("<Q", 0),
             "conn_count": struct.pack("<I", len(self._topics)),
             "chunk_count": struct.pack("<I", len(self._chunks))},
            b" " * 4096)  # rosbag pads the header record to 4 KiB
        with open(self._path, "wb") as f:
            f.write(b"#ROSBAG V2.0\n")
            f.write(bag_header)
            for c in self._chunks:
                f.write(c)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
