"""EuRoC MAV dataset loader, ASL format (port of okvis_tpu.datasets.euroc).

Iterates `mav0/cam*/data/*.png` (file names are nanosecond timestamps) and
`mav0/imu0/data.csv`, and yields the measurements in timestamp order, the
input protocol of the pipeline; reads the ground-truth state CSV for ATE.

The image decoder is explicit (`decoder`):
- "native": the port's libpng loader (okvis_tpu_torch.native), at the
  event's size; it raises when the loader cannot be built or the image has
  another size;
- "python": datasets/png.py (zlib + numpy), any size;
- "auto" (the default): the JAX package's order, native when it builds and
  the image has the event's size, else png.py in the place of PIL.
`EurocDataset.decoder_used` records, for each image loaded, which decoder
read it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .png import read_png_gray

NS = 1_000_000_000
DECODERS = ("auto", "native", "python")


@dataclasses.dataclass
class ImuSample:
    timestamp_ns: int
    gyro: np.ndarray  # (3,)
    acc: np.ndarray  # (3,)


_native_decode = None


def _get_native_decode():
    """The native decoder, or None when it cannot be built; tried once a
    process."""
    global _native_decode
    if _native_decode is None:
        from .. import native

        try:
            native.get_lib()
            _native_decode = native.decode_png_gray
        except native.NativeUnavailable:
            _native_decode = False
    return _native_decode or None


def decode(path: str, height: int, width: int, decoder: str = "auto") -> Tuple[np.ndarray, str]:
    """The (H, W) float32 image at `path` and the name of the decoder that
    read it."""
    if decoder not in DECODERS:
        raise ValueError(f"decoder must be one of {DECODERS}, got {decoder!r}")
    if decoder == "native":
        from .. import native

        return native.decode_png_gray(path, height, width), "native"
    if decoder == "auto":
        dec = _get_native_decode()
        if dec is not None:
            try:
                return dec(path, height, width), "native"
            except IOError:
                pass  # another size: png.py reads any
    return read_png_gray(path), "python"


@dataclasses.dataclass
class ImageEvent:
    timestamp_ns: int
    cam_idx: int
    path: str
    width: int = 752
    height: int = 480
    decoder: str = "auto"
    # path -> decoder name of each image loaded (the dataset's decoder_used)
    log: Optional[Dict[str, str]] = dataclasses.field(default=None, repr=False, compare=False)

    def load(self) -> np.ndarray:
        img, used = decode(self.path, self.height, self.width, self.decoder)
        if self.log is not None:
            self.log[self.path] = used
        return img


class EurocDataset:
    """Lazy iterator over an extracted EuRoC sequence directory (…/mav0)."""

    def __init__(self, mav0_dir: str, num_cameras: int = 2, skip_sec: float = 0.0, decoder: str = "auto"):
        if decoder not in DECODERS:
            raise ValueError(f"decoder must be one of {DECODERS}, got {decoder!r}")
        self.dir = mav0_dir
        self.num_cameras = num_cameras
        self.decoder = decoder
        self.decoder_used: Dict[str, str] = {}
        self.imu: List[ImuSample] = self._load_imu()
        self.images: List[ImageEvent] = self._scan_images()
        if skip_sec > 0 and self.images:
            t0 = self.images[0].timestamp_ns + int(skip_sec * NS)
            self.images = [e for e in self.images if e.timestamp_ns >= t0]

    def _load_imu(self) -> List[ImuSample]:
        path = os.path.join(self.dir, "imu0", "data.csv")
        out = []
        with open(path) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                v = line.strip().split(",")
                out.append(
                    ImuSample(
                        timestamp_ns=int(v[0]),
                        gyro=np.asarray([float(v[1]), float(v[2]), float(v[3])]),
                        acc=np.asarray([float(v[4]), float(v[5]), float(v[6])]),
                    )
                )
        return out

    def _scan_images(self) -> List[ImageEvent]:
        events = []
        for cam in range(self.num_cameras):
            d = os.path.join(self.dir, f"cam{cam}", "data")
            if not os.path.isdir(d):
                continue
            for name in sorted(os.listdir(d)):
                if not name.endswith(".png"):
                    continue
                events.append(ImageEvent(timestamp_ns=int(name[:-4]), cam_idx=cam, path=os.path.join(d, name),
                                         decoder=self.decoder, log=self.decoder_used))
        events.sort(key=lambda e: (e.timestamp_ns, e.cam_idx))
        return events

    def imu_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        ts = np.asarray([s.timestamp_ns for s in self.imu], dtype=np.int64)
        gyro = np.stack([s.gyro for s in self.imu])
        acc = np.stack([s.acc for s in self.imu])
        return ts, gyro, acc

    def ground_truth(self) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """(ts_ns, positions (N,3), quaternions xyzw (N,4)) from
        state_groundtruth_estimate0, or None if absent."""
        path = os.path.join(self.dir, "state_groundtruth_estimate0", "data.csv")
        if not os.path.exists(path):
            return None
        ts, ps, qs = [], [], []
        with open(path) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                v = line.strip().split(",")
                ts.append(int(v[0]))
                ps.append([float(v[1]), float(v[2]), float(v[3])])
                # EuRoC ground-truth quaternions are w,x,y,z -> store xyzw
                qs.append([float(v[5]), float(v[6]), float(v[7]), float(v[4])])
        return np.asarray(ts, np.int64), np.asarray(ps), np.asarray(qs)

    def measurements(self) -> Iterator[object]:
        """All measurements in global timestamp order (the reference app's
        main loop): at equal timestamps the IMU sample comes first."""
        merged: List[object] = list(self.imu) + list(self.images)
        merged.sort(key=lambda m: m.timestamp_ns)
        return iter(merged)
