"""The port's PNG reader and writer (okvis_tpu_torch/datasets/png.py, zlib +
numpy) against PIL, which the JAX package reads and writes EuRoC frames
with. Every comparison is exact: grey levels as integers, no tolerance."""

import zlib

import numpy as np
import pytest
from PIL import Image

from okvis_tpu_torch.datasets.png import FILTERS, read_png_gray, write_png_gray


def _images():
    """Random noise, a smooth ramp (PIL picks other filters for it) and a
    one-row and one-column image."""
    rng = np.random.default_rng(0)
    ramp = (np.add.outer(np.arange(48), 3 * np.arange(64)) % 256).astype(np.uint8)
    return dict(noise=rng.integers(0, 256, (48, 64), dtype=np.uint8), ramp=ramp,
                row=rng.integers(0, 256, (1, 17), dtype=np.uint8), column=rng.integers(0, 256, (9, 1), dtype=np.uint8))


def _filters_used(path) -> set:
    """The filter type bytes of a PNG's rows."""
    data = open(path, "rb").read()
    with Image.open(path) as im:
        w, h = im.size
    pos, idat = 8, b""
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    return set(np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)[:, 0].tolist())


@pytest.mark.parametrize("name", sorted(_images()))
def test_reader_equals_pil_on_pil_written_images(tmp_path, name):
    img = _images()[name]
    path = str(tmp_path / f"{name}.png")
    Image.fromarray(img).save(path)
    got = read_png_gray(path)
    assert got.dtype == np.float32 and got.shape == img.shape
    np.testing.assert_array_equal(got, np.asarray(Image.open(path), np.float32))
    np.testing.assert_array_equal(got, img)


def test_pil_writes_several_filter_types(tmp_path):
    """PIL's adaptive filtering gives the reader more than one filter type in
    one file (the ramp), so the PIL cases exercise mixed rows."""
    path = str(tmp_path / "ramp.png")
    Image.fromarray(_images()["ramp"]).save(path)
    assert len(_filters_used(path)) >= 2


@pytest.mark.parametrize("filt", sorted(FILTERS))
@pytest.mark.parametrize("name", ["noise", "ramp"])
def test_writer_round_trip_each_filter(tmp_path, filt, name):
    """The writer's file with every row under one filter: the reader and PIL
    both give the image back exactly."""
    img = _images()[name]
    path = str(tmp_path / f"{name}_{filt}.png")
    write_png_gray(path, img, filter=filt)
    assert _filters_used(path) == {FILTERS[filt]}
    np.testing.assert_array_equal(read_png_gray(path), img)
    with Image.open(path) as im:
        assert im.mode == "L"
        np.testing.assert_array_equal(np.asarray(im), img)


def test_writer_default_is_up_and_edges_round_trip(tmp_path):
    for name in ("row", "column"):
        img = _images()[name]
        path = str(tmp_path / f"{name}.png")
        write_png_gray(path, img)
        assert _filters_used(path) == {FILTERS["up"]}
        np.testing.assert_array_equal(read_png_gray(path), img)


def test_wrong_size_raises(tmp_path):
    path = str(tmp_path / "a.png")
    write_png_gray(path, _images()["noise"])
    assert read_png_gray(path, shape=(48, 64)).shape == (48, 64)
    with pytest.raises(IOError, match="a.png"):
        read_png_gray(path, shape=(480, 752))


@pytest.mark.parametrize("mode", ["RGB", "LA", "I;16", "P", "1"])
def test_other_colour_types_and_depths_raise_naming_the_file(tmp_path, mode):
    path = str(tmp_path / f"other_{mode.replace(';', '')}.png")
    Image.fromarray(_images()["noise"]).convert(mode).save(path)
    with pytest.raises(ValueError, match=path.split("/")[-1]):
        read_png_gray(path)


def test_corrupt_files_raise(tmp_path):
    path = tmp_path / "a.png"
    write_png_gray(str(path), _images()["noise"])
    data = bytearray(path.read_bytes())
    data[40] ^= 0xFF  # inside the IDAT payload: the CRC no longer matches
    bad = tmp_path / "bad.png"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_png_gray(str(bad))
    (tmp_path / "text.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png_gray(str(tmp_path / "text.png"))


def test_writer_refuses_other_arrays(tmp_path):
    with pytest.raises(ValueError):
        write_png_gray(str(tmp_path / "a.png"), np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        write_png_gray(str(tmp_path / "a.png"), np.zeros((4, 4), np.uint8), filter="median")
