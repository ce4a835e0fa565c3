"""Native (C++) PNG decoding on the host, loaded with ctypes (port of
okvis_tpu.native).

`dataloader.cpp` is this package's own copy of the JAX package's loader: a
libpng decoder of 8-bit grayscale PNGs to float32 and a prefetching loader
that decodes ahead on worker threads. At first use it is compiled with g++
into the repository's `build/okvis_tpu_torch/`, under a name that carries a
hash of the source and flags (as ops/cuda_lib.py builds the CUDA kernels),
so an edit rebuilds and an unchanged tree loads the earlier build. Nothing
is written anywhere else. Without g++ or libpng, `get_lib` raises
NativeUnavailable; the EuRoC loader's "auto" decoder then reads with
datasets/png.py instead, and says so (EurocDataset.decoder_used).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "dataloader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "okvis_tpu_torch"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
LIBS = ["-lpng", "-lpthread"]


class NativeUnavailable(RuntimeError):
    pass


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libokvis_tpu_torch_dataloader_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    """Compile to a file of this process's own, then move it into place, so
    processes that build at once never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, str(SOURCE), *LIBS, "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=120)
    except (subprocess.CalledProcessError, FileNotFoundError, subprocess.TimeoutExpired) as e:
        tmp.unlink(missing_ok=True)
        detail = getattr(e, "stderr", None) or repr(e)
        raise NativeUnavailable(f"native build failed: {detail}") from e
    os.replace(tmp, path)


_lib: Optional[ctypes.CDLL] = None


def get_lib() -> ctypes.CDLL:
    """Build (if needed) and load the loader library once a process."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        _build(path)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:  # built elsewhere, against a libpng this machine lacks
        raise NativeUnavailable(f"native library does not load: {e}") from e
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.loader_next.restype = ctypes.c_int
    lib.loader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    lib.decode_png_gray.restype = ctypes.c_int
    lib.decode_png_gray.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int
    ]
    _lib = lib
    return lib


def decode_png_gray(path: str, height: int, width: int) -> np.ndarray:
    """Single-image decode (float32 grayscale); IOError when the file does
    not decode to (height, width)."""
    lib = get_lib()
    out = np.empty((height, width), np.float32)
    rc = lib.decode_png_gray(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        height, width,
    )
    if rc != 0:
        raise IOError(f"PNG decode failed ({rc}): {path}")
    return out


class PrefetchingImageLoader:
    """Ordered prefetching decoder over a list of PNG paths.

    Iterate to receive (index, image) in order; decoding runs ahead on
    n_threads worker threads. An image that does not decode is skipped."""

    def __init__(self, paths: List[str], height: int, width: int,
                 n_threads: int = 4, prefetch: int = 8):
        self._lib = get_lib()
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._h, self._w = height, width
        self._n = len(paths)
        self._handle = self._lib.loader_create(
            arr, len(self._paths), n_threads, height, width, prefetch
        )
        self._consumed = 0

    def __iter__(self):
        return self

    def __next__(self):
        while self._consumed < self._n and self._handle is not None:
            out = np.empty((self._h, self._w), np.float32)
            rc = self._lib.loader_next(
                self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            )
            self._consumed += 1
            if rc == -1:
                break
            if rc != -2:  # -2: undecodable image, skipped
                return rc, out
        raise StopIteration

    def close(self):
        if self._handle is not None:
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown: the library may be gone
            pass
