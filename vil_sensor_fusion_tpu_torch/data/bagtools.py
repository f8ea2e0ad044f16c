"""Bag maintenance utilities.

Port of ``vil_sensor_fusion_tpu/data/bagtools.py``. :func:`fix_bag_time`
is the equivalent of the reference's
``carla_tools/scripts/fix_rosbag_time.py:28-47``: externally recorded bags
carry record times in WALL clock while the message headers carry SIM
clock, so replay runs at the wrong rate and cross-topic alignment breaks.
The fix rewrites every record's bag time to its header stamp, passing
payloads through verbatim.
"""

from __future__ import annotations

import struct

from .rosbag_io import BagReader
from .rosbag_writer import BagWriter

# Message types whose serialization begins with std_msgs/Header
# (uint32 seq, uint32 sec, uint32 nsec, string frame_id).
_HEADER_LED = {
    "sensor_msgs/Imu",
    "nav_msgs/Odometry",
    "sensor_msgs/PointCloud2",
    "sensor_msgs/Image",
    "sensor_msgs/CameraInfo",
    "sensor_msgs/NavSatFix",
    "geometry_msgs/PoseStamped",
    "geometry_msgs/TransformStamped",
    "geometry_msgs/TwistStamped",
}


def _header_stamp(payload: bytes, datatype: str) -> float | None:
    """Header stamp (seconds) of a serialized message, or None if the type
    has no leading header (those keep their record time, as the reference
    does for header-less messages — fix_rosbag_time.py:41-42)."""
    if datatype in _HEADER_LED and len(payload) >= 12:
        sec, nsec = struct.unpack_from("<II", payload, 4)
        return sec + nsec * 1e-9
    if datatype == "tf2_msgs/TFMessage" and len(payload) >= 16:
        # uint32 array length, then TransformStamped[0]'s Header; the
        # reference takes transforms[0]'s stamp for the whole message
        # (fix_rosbag_time.py:32-39, "all transforms share the stamp").
        (count,) = struct.unpack_from("<I", payload, 0)
        if count == 0:
            return None
        sec, nsec = struct.unpack_from("<II", payload, 8)
        return sec + nsec * 1e-9
    return None


def fix_bag_time(in_path, out_path,
                 compression: str = "none") -> dict:
    """Rewrite ``in_path``'s record times := header stamps → ``out_path``.

    Returns a report: per-topic message counts and the maximum
    |record − header| skew that was corrected."""
    report: dict = {"topics": {}, "max_skew_s": 0.0, "rewritten": 0,
                    "kept": 0}
    with BagReader(in_path) as bag, \
            BagWriter(out_path, compression=compression) as out:
        for topic, datatype in sorted(bag.topics().items()):
            n = bag.count(topic)
            report["topics"][topic] = {"type": datatype, "count": n}
            for i in range(n):
                rec_t, payload = bag.read_record(topic, i)
                hdr_t = _header_stamp(payload, datatype)
                if hdr_t is not None and hdr_t > 0:
                    report["max_skew_s"] = max(report["max_skew_s"],
                                               abs(rec_t - hdr_t))
                    report["rewritten"] += 1
                    stamp = hdr_t
                else:
                    report["kept"] += 1
                    stamp = rec_t
                out.add_topic(topic, datatype)
                out.write(topic, stamp, payload)
    return report
