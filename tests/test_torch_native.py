"""The port's native PNG loader (okvis_tpu_torch/native: its own copy of the
JAX package's dataloader.cpp, built with g++ into build/okvis_tpu_torch/),
mirroring tests/test_native.py: the decode equals PIL exactly, the
prefetching loader keeps the order, a wrong size is refused. Building and
using it leaves the JAX package's okvis_tpu/native/build/ as it was. Tests
skip, as the JAX package's do, where g++ or libpng is missing."""

import os
from pathlib import Path

import numpy as np
import pytest

from okvis_tpu_torch import native
from okvis_tpu_torch.native import NativeUnavailable, PrefetchingImageLoader, decode_png_gray

JAX_BUILD = Path(__file__).resolve().parents[1] / "okvis_tpu" / "native" / "build"


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(12):
        img = rng.integers(0, 256, (48, 64), dtype=np.uint8)
        p = str(d / f"{1000 + i}.png")
        Image.fromarray(img).save(p)
        paths.append((p, img))
    return paths


def _lib_or_skip():
    try:
        return native.get_lib()
    except NativeUnavailable as e:
        pytest.skip(f"no native toolchain: {e}")


def test_decode_matches_pil(png_dir):
    _lib_or_skip()
    for path, expected in png_dir[:3]:
        img = decode_png_gray(path, 48, 64)
        assert img.dtype == np.float32
        np.testing.assert_array_equal(img, expected.astype(np.float32))


def test_prefetching_loader_order(png_dir):
    _lib_or_skip()
    paths = [p for p, _ in png_dir]
    loader = PrefetchingImageLoader(paths, 48, 64, n_threads=3, prefetch=4)
    got = list(loader)
    loader.close()
    assert [i for i, _ in got] == list(range(12))
    for (i, img), (_, expected) in zip(got, png_dir):
        np.testing.assert_array_equal(img.astype(np.uint8), expected)


def test_prefetching_loader_skips_an_image_of_another_size(png_dir, tmp_path):
    from PIL import Image

    _lib_or_skip()
    odd = str(tmp_path / "odd.png")
    Image.fromarray(np.zeros((10, 10), np.uint8)).save(odd)
    paths = [png_dir[0][0], odd, png_dir[1][0]]
    loader = PrefetchingImageLoader(paths, 48, 64, n_threads=2, prefetch=2)
    got = list(loader)
    loader.close()
    assert [i for i, _ in got] == [0, 2]


def test_wrong_size_rejected(png_dir):
    _lib_or_skip()
    with pytest.raises(IOError):
        decode_png_gray(png_dir[0][0], 100, 100)


def _listing(root: Path) -> dict:
    if not root.exists():
        return {}
    return {str(p.relative_to(root)): os.stat(p).st_mtime_ns for p in sorted(root.rglob("*"))}


def test_build_writes_only_under_its_own_build_dir(png_dir, monkeypatch, tmp_path):
    """A fresh build (into a temporary build directory) and a decode leave
    okvis_tpu/native/build/ untouched: the same files, the same mtimes."""
    before = _listing(JAX_BUILD)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    try:
        native.get_lib()
    except NativeUnavailable as e:
        pytest.skip(f"no native toolchain: {e}")
    built = _listing(tmp_path / "build")
    assert list(built) == [native.library_path().name]
    assert native.library_path().name.startswith("libokvis_tpu_torch_dataloader_")
    np.testing.assert_array_equal(decode_png_gray(png_dir[0][0], 48, 64), png_dir[0][1].astype(np.float32))
    assert _listing(JAX_BUILD) == before


def test_build_failure_raises_native_unavailable(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++
    with pytest.raises(NativeUnavailable, match="native build failed"):
        native.get_lib()
    assert not list((tmp_path / "build").glob("*"))
