"""Frame and IMU synchronizers (copy of okvis_tpu.pipeline.synchronizer).

The reference's FrameSynchronizer (okvis_multisensor_processing
FrameSynchronizer.cpp:54-178: group per-camera images within a timestamp
tolerance into one MultiFrame, ring buffer of 3) and ImuFrameSynchronizer
(ImuFrameSynchronizer.cpp:48-83: condition-variable barrier until IMU data
covers a requested time). Host code only.
"""

from __future__ import annotations

import threading
from typing import List, Optional


class FrameSynchronizer:
    """Groups (timestamp_ns, cam_idx, image) into complete frame sets."""

    def __init__(self, num_cameras: int, tolerance_ns: int = 5_000_000, buffer_size: int = 3):
        self.num_cameras = num_cameras
        self.tolerance_ns = tolerance_ns
        self.buffer: List[dict] = []  # ring of pending groups
        self.buffer_size = buffer_size

    def add_frame(self, timestamp_ns: int, cam_idx: int, image) -> Optional[dict]:
        """Returns {'timestamp_ns', 'images': {cam: img}} when a group
        completes, else None."""
        for g in self.buffer:
            if abs(g["timestamp_ns"] - timestamp_ns) <= self.tolerance_ns:
                if cam_idx in g["images"]:
                    break  # duplicate for this cam: start a new group below
                g["images"][cam_idx] = image
                # midpoint timestamp reconciliation (FrameSynchronizer.cpp:118)
                g["timestamp_ns"] = (g["timestamp_ns"] + timestamp_ns) // 2
                if len(g["images"]) == self.num_cameras:
                    self.buffer.remove(g)
                    return g
                return None
        g = {"timestamp_ns": timestamp_ns, "images": {cam_idx: image}}
        if self.num_cameras == 1:
            return g
        self.buffer.append(g)
        if len(self.buffer) > self.buffer_size:
            self.buffer.pop(0)  # drop oldest incomplete group
        return None


class ImuFrameSynchronizer:
    """Blocks frame processing until IMU data ≥ a requested timestamp exists."""

    def __init__(self):
        self._cond = threading.Condition()
        self._newest_ns = -1
        self._shutdown = False

    def got_imu_data(self, timestamp_ns: int) -> None:
        with self._cond:
            self._newest_ns = max(self._newest_ns, timestamp_ns)
            self._cond.notify_all()

    def wait_for_up_to_date_imu_data(self, timestamp_ns: int, timeout: float = 10.0) -> bool:
        with self._cond:
            while self._newest_ns < timestamp_ns and not self._shutdown:
                if not self._cond.wait(timeout=timeout):
                    return False
            return not self._shutdown

    def shutdown(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()
