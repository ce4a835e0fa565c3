"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by nvcc for ``sm_90a`` (Hopper), one
nvcc process per source, all started together, and the objects are linked
into one shared library with a plain C interface, loaded with ctypes. The
library's name carries a hash of the sources and flags, so an edit rebuilds
and an unchanged tree loads the earlier build. Nothing is prebuilt or
downloaded; without nvcc, ``load_library`` raises (callers never fall back
to a plain version for CUDA tensors).

Each C entry point enqueues its kernel on the stream it is given and
returns ``cudaGetLastError()``; ``check`` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "okvis_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
DEFAULT_CUDA_HOME = "/usr/local/cuda"  # the toolkit's standard install prefix

_lib = None
build_log = ""  # nvcc's output (ptxas register/smem report) of the build that made the library


def find_nvcc() -> str:
    """nvcc from PATH, else from CUDA_HOME or the toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("okvis_tpu_torch: nvcc not found; the CUDA kernels cannot be built")


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for path in sources:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile csrc/ into the build directory unless this exact build exists."""
    global build_log
    sources = sorted(SRC_DIR.glob("*.cu"))
    digest = _digest(sources)
    lib_path = BUILD_DIR / f"libokvis_tpu_torch_{digest}.so"
    log_path = lib_path.with_suffix(".log")  # the build's nvcc output, kept beside it
    if lib_path.exists():
        build_log = log_path.read_text() if log_path.exists() else ""
        return lib_path
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest}_{os.getpid()}"
    objects = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in sources]
    procs = [
        subprocess.Popen(
            [nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(sources, objects)
    ]
    logs, failed = [], []
    for src, proc in zip(sources, procs):
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    tmp = BUILD_DIR / f"libokvis_tpu_torch_{tag}.so.tmp"
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    for obj in objects:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    log_path.write_text(build_log)
    os.replace(tmp, lib_path)
    return lib_path


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.okvis_hamming_matrix.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
        lib.okvis_hamming_matrix.restype = i32
        lib.okvis_harris_nms.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, ptr, i32, i32, f32, ptr]
        lib.okvis_harris_nms.restype = i32
        lib.okvis_harris_nms_shared_bytes.argtypes = [i32, i32]
        lib.okvis_harris_nms_shared_bytes.restype = i32
        lib.okvis_cuda_error_string.argtypes = [i32]
        lib.okvis_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.okvis_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
