"""okvis_tpu_torch BRISK description against the JAX package: the pattern
constants, the Toeplitz blur pyramid, and the packed descriptor bits on
identical keypoints and angles. The blur sums in another order in each
framework, so a smoothed-intensity tie can flip a bit: the bits must agree
on >= 99.5 %, and the flip rate is printed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis_tpu.frontend import brisk as jbrisk
from okvis_tpu.frontend import detection as jdet
from okvis_tpu_torch.frontend import brisk as tbrisk
from okvis_tpu_torch.frontend import detection as tdet

torch.set_num_threads(2)


def _images(seed, C=2, H=240, W=376):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(C):
        img = np.full((H, W), 110.0, np.float32) + rng.normal(0, 1.0, (H, W)).astype(np.float32)
        for _ in range(60):
            y, x = rng.integers(10, H - 22), rng.integers(10, W - 22)
            img[y:y + 12, x:x + 12] += np.kron(rng.uniform(-70, 70, (4, 4)), np.ones((3, 3)))
        out.append(np.clip(img, 0, 255))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("name", [
    "_PATTERN_PTS", "_PATTERN_SIG", "_PAIR_I", "_PAIR_J", "_SIGMAS", "_PT_LEVEL",
    "_LEVEL_ORDER", "_LEVEL_INV", "_LEVEL_COUNTS", "_BLUR_TAPS",
])
def test_pattern_constants_identical(name):
    np.testing.assert_array_equal(getattr(tbrisk, name), getattr(jbrisk, name))
    assert tbrisk._BLUR_RAD == jbrisk._BLUR_RAD
    np.testing.assert_array_equal(tbrisk._blur_toeplitz_bank(37), jbrisk._blur_toeplitz_bank(37))


def test_blur_pyramid_matches_jax():
    imgs = _images(1, H=120, W=160)
    want = np.asarray(jbrisk.blur_pyramid(jnp.asarray(imgs)))
    got = tbrisk.blur_pyramid(torch.from_numpy(imgs)).numpy()
    assert got.shape == want.shape == (2, len(jbrisk._SIGMAS), 120, 160)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def _bit_agreement(d_t, d_j):
    x = d_t.numpy().view(np.uint32) ^ np.asarray(d_j).astype(np.uint32)
    flips = int(np.unpackbits(x.view(np.uint8)).sum())
    return flips, x.size * 32


@pytest.mark.parametrize("scaled", [False, True], ids=["base-size", "octave-sizes"])
def test_descriptors_agree_on_identical_keypoints(scaled):
    imgs = _images(2)
    C = imgs.shape[0]
    kps = [jdet.detect_keypoints(jnp.asarray(im), threshold=15.0, max_keypoints=128) for im in imgs]
    uv = np.stack([np.asarray(k.uv) for k in kps])
    angles = np.asarray([0.3, -1.2], np.float32)
    rng = np.random.default_rng(0)
    sizes = rng.choice([8.0, 16.0, 32.0], uv.shape[:2]).astype(np.float32) if scaled else None

    levels_j = jbrisk.blur_pyramid(jnp.asarray(imgs))
    d_j = jbrisk._describe_from_levels(levels_j, jnp.asarray(uv), jnp.asarray(angles),
                                       None if sizes is None else jnp.asarray(sizes))
    levels_t = tbrisk.blur_pyramid(torch.from_numpy(imgs))
    d_t = tbrisk._describe_from_levels(levels_t, torch.from_numpy(uv), torch.from_numpy(angles),
                                       None if sizes is None else torch.from_numpy(sizes))
    assert d_t.dtype == torch.int32 and d_t.shape == (C, 128, 16)
    flips, bits = _bit_agreement(d_t, d_j)
    print(f"descriptor bit flips vs JAX: {flips} of {bits} ({flips / bits:.2e})")
    assert flips / bits <= 0.005


def test_describe_keypoints_and_batch_match_jax():
    imgs = _images(3)
    angles = np.asarray([0.7, 2.0], np.float32)
    kj, dj = jbrisk.detect_and_describe_batch(jnp.asarray(imgs), jnp.asarray(angles),
                                              threshold=15.0, max_keypoints=128)
    kt, dt = tbrisk.detect_and_describe_batch(torch.from_numpy(imgs), torch.from_numpy(angles),
                                              threshold=15.0, max_keypoints=128)
    np.testing.assert_array_equal(kt.mask.numpy(), np.asarray(kj.mask))
    m = kt.mask.numpy()
    flips, _ = _bit_agreement(dt[torch.from_numpy(m)], np.asarray(dj)[m])
    assert flips / (m.sum() * 512) <= 0.005
    # the single-image entry point describes the same keypoints the same way
    single = tbrisk.describe_keypoints(
        torch.from_numpy(imgs[0]), tdet.Keypoints(*(t[0] for t in kt)), torch.tensor(angles[0]))
    assert torch.equal(single, dt[0])


def test_bit31_packing_matches_jax_uint32():
    """A descriptor whose words have bit 31 set round-trips as uint32."""
    bits = np.zeros((1, 1, 512), bool)
    bits[0, 0, 31::32] = True  # bit 31 of every word
    bits[0, 0, 0:512:7] = True
    packed = tbrisk._pack_bits(torch.from_numpy(bits)).numpy().view(np.uint32)
    words = bits.reshape(1, 1, 16, 32).astype(np.uint64)
    want = (words << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    np.testing.assert_array_equal(packed, want)


def test_gravity_extraction_angle_matches_jax():
    g = np.random.default_rng(4).normal(size=(8, 3))
    want = [float(jbrisk.gravity_extraction_angle(jnp.asarray(x))) for x in g]
    np.testing.assert_allclose(tbrisk.gravity_extraction_angle(torch.from_numpy(g)).numpy(), want,
                               rtol=0, atol=1e-12)
