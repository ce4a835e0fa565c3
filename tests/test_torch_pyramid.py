"""okvis_tpu_torch scale-space and masked detection against the JAX
package, on the CPU: the cases of tests/test_frontend.py at :262 (detection
mask), :278 (pyramid detection), :412 (scale-aware description across
octaves) and :533 (the batched scale-space path against the per-camera
one), each also run through the JAX function on the same numpy input, with
its XLA path (use_pallas=False, the CPU default).

Tolerances: validity masks, keypoint order and sizes exactly; keypoint
coordinates to 1e-3 px and scores to rtol 1e-4, as test_torch_detection.py
holds the single-octave detector (the plain Harris stage sums in another
order than XLA); descriptor bits exactly (0 flips measured; the blur
pyramid sums in another order than JAX, so test_torch_brisk.py allows
0.5 % flips at intensity ties, which these inputs do not have). The port's
batched path equals its per-camera path exactly, as the JAX test holds
JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis_tpu.datasets.synthetic import euroc_stereo_rig as jeuroc_stereo_rig
from okvis_tpu.cameras import NCameraSystem as JRig
from okvis_tpu.frontend import brisk as jbrisk
from okvis_tpu.frontend import detection as jdet
from okvis_tpu.frontend.frontend import Frontend as JFrontend
from okvis_tpu.frontend.frontend import FrontendConfig as JFrontendConfig
from okvis_tpu_torch import convert
from okvis_tpu_torch.frontend import brisk as tbrisk
from okvis_tpu_torch.frontend import detection as tdet
from okvis_tpu_torch.frontend.frontend import Frontend, FrontendConfig
from test_frontend import synth_corner_image

torch.set_num_threads(2)


def _check_keypoints(kt, kj, sizes_t=None, sizes_j=None):
    mt, mj = kt.mask.numpy(), np.asarray(kj.mask)
    np.testing.assert_array_equal(mt, mj)
    assert mt.sum() > 0
    np.testing.assert_allclose(kt.uv.numpy()[mt], np.asarray(kj.uv)[mj], rtol=0, atol=1e-3)
    np.testing.assert_allclose(kt.score.numpy()[mt], np.asarray(kj.score)[mj], rtol=1e-4)
    if sizes_t is not None:
        np.testing.assert_array_equal(np.asarray(sizes_t), np.asarray(sizes_j))


def _bit_flips(d_t, d_j):
    x = np.asarray(d_t).view(np.uint32) ^ np.asarray(d_j).astype(np.uint32)
    return int(np.unpackbits(x.view(np.uint8)).sum()), x.size * 32


def _blob_image(seed):
    img, _ = synth_corner_image(np.random.default_rng(seed))
    yy, xx = np.mgrid[0:120, 0:160]
    return (img + 50.0 * np.exp(-(((yy - 60) / 14.0) ** 2 + ((xx - 80) / 14.0) ** 2))).astype(np.float32)


def test_downsample_equals_jax_bit_for_bit():
    img = np.random.default_rng(1).uniform(0, 255, (121, 161)).astype(np.float32)
    want = np.asarray(jdet._downsample2(jnp.asarray(img)))
    got = tdet._downsample2(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (60, 80)
    np.testing.assert_array_equal(got, want)


def test_detection_mask():
    """tests/test_frontend.py:262: no detection inside the suppressed half."""
    img, _ = synth_corner_image(np.random.default_rng(0))
    H, W = img.shape
    mask = np.ones((H, W), bool)
    mask[:, : W // 2] = False
    kw = dict(threshold=10.0, max_keypoints=64, border=8)
    kj = jdet.detect_keypoints(jnp.asarray(img), mask=jnp.asarray(mask), use_pallas=False, **kw)
    kt = tdet.detect_keypoints(torch.from_numpy(img), mask=torch.from_numpy(mask), **kw)
    _check_keypoints(kt, kj)
    found = kt.uv.numpy()[kt.mask.numpy()]
    assert len(found) > 0 and np.all(found[:, 0] >= W // 2 - 1)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_pyramid_detection(masked):
    """tests/test_frontend.py:278: a blob only a coarser octave sees; sizes
    8 2^o; coordinates in base-image pixels. Masked: the left 24 columns
    and the bottom 16 rows blanked, subsampled per octave."""
    img = _blob_image(0)
    mask = None
    if masked:
        mask = np.ones(img.shape, bool)
        mask[:, :24] = False
        mask[-16:] = False
    kw = dict(threshold=10.0, max_keypoints=96, border=8, octaves=2)
    kj, sj = jdet.detect_keypoints_pyramid(jnp.asarray(img), mask=None if mask is None else jnp.asarray(mask), **kw)
    kt, st = tdet.detect_keypoints_pyramid(torch.from_numpy(img),
                                           mask=None if mask is None else torch.from_numpy(mask), **kw)
    _check_keypoints(kt, kj, st, sj)
    m = kt.mask.numpy()
    assert m.sum() >= 10
    s = st.numpy()[m]
    assert set(np.unique(s)).issubset({8.0, 16.0, 32.0}) and (s > 8.0).any()
    uv = kt.uv.numpy()[m]
    assert uv[:, 0].max() < 160 and uv[:, 1].max() < 120
    if masked:
        assert uv[:, 0].min() >= 23 - 4 and uv[:, 1].max() <= 120 - 16 + 4


def test_scale_aware_description_cross_octave():
    """tests/test_frontend.py:412: a feature described at size 8 matches
    itself described at size 16 in the 2x upscaled image; the port's bits
    equal JAX's on the same images and keypoints."""
    base = np.random.default_rng(3).uniform(0, 255, (40, 40))
    img = np.array(jax.image.resize(jnp.asarray(base, jnp.float32), (160, 160), "cubic"))
    img2 = np.array(jax.image.resize(jnp.asarray(base, jnp.float32), (320, 320), "cubic"))
    K = 4
    uv = np.tile([[80.0, 80.0]], (K, 1)).astype(np.float32)

    def kp_t(u):
        return tdet.Keypoints(uv=torch.from_numpy(u), score=torch.ones(K), mask=torch.ones(K, dtype=torch.bool))

    def kp_j(u):
        return jdet.Keypoints(uv=jnp.asarray(u), score=jnp.ones(K), mask=jnp.ones(K, bool))

    zero = np.float32(0.0)
    d1 = tbrisk.describe_keypoints(torch.from_numpy(img), kp_t(uv), torch.tensor(zero), torch.full((K,), 8.0))
    d2 = tbrisk.describe_keypoints(torch.from_numpy(img2), kp_t(2 * uv + 0.5), torch.tensor(zero),
                                   torch.full((K,), 16.0))
    d2_unscaled = tbrisk.describe_keypoints(torch.from_numpy(img2), kp_t(2 * uv + 0.5), torch.tensor(zero))
    dist = _bit_flips(d1[:1], d2[:1])[0]
    dist_unscaled = _bit_flips(d1[:1], d2_unscaled[:1])[0]
    assert dist < 60, f"cross-scale Hamming {dist}"
    assert dist < dist_unscaled, (dist, dist_unscaled)
    j2 = jbrisk.describe_keypoints(jnp.asarray(img2), kp_j(2 * uv + 0.5), jnp.asarray(0.0), sizes=jnp.full((K,), 16.0))
    j1 = jbrisk.describe_keypoints(jnp.asarray(img), kp_j(uv), jnp.asarray(0.0), sizes=jnp.full((K,), 8.0))
    for got, want in ((d1, j1), (d2, j2)):
        flips, bits = _bit_flips(got, want)
        assert flips == 0, f"descriptor bit flips vs JAX: {flips} of {bits}"


def _rigs():
    specs, T_SC, intr = jeuroc_stereo_rig()
    jrig = JRig(specs=tuple(specs), T_SC=T_SC, intrinsics=intr)
    trig = convert.rig_from_numpy([(s.width, s.height, s.dist_type) for s in specs], np.asarray(T_SC.r),
                                  np.asarray(T_SC.q), [np.asarray(i) for i in intr], device="cpu",
                                  compute_overlaps=False)
    return jrig, trig


@pytest.mark.parametrize("octaves,masked", [(2, False), (2, True), (0, True)],
                         ids=["pyramid", "pyramid-masked", "masked"])
def test_batched_pyramid_multi_matches_per_camera_and_jax(octaves, masked):
    """tests/test_frontend.py:533: detect_and_describe_multi's batched
    scale-space (and masked) path equals the per-camera detect_and_describe
    (keypoints, sizes, descriptors), and both equal the JAX frontend's."""
    rng = np.random.default_rng(11)
    imgs = [rng.uniform(0, 255, (120, 160)).astype(np.float32) for _ in range(2)]
    masks = None
    if masked:
        masks = tuple(np.ones((120, 160), bool) for _ in range(2))
        masks[0][:, :32] = False
        masks[1][-24:] = False
    kw = dict(detection_threshold=8.0, detection_octaves=octaves, max_keypoints=64, detection_masks=masks)
    jrig, trig = _rigs()
    jfe = JFrontend(jrig, JFrontendConfig(**kw))
    tfe = Frontend(trig, FrontendConfig(**kw))

    jb = jfe.detect_and_describe_multi(imgs, T_WS=None)
    tb = tfe.detect_and_describe_multi(imgs, T_WS=None)
    flips = bits = 0
    for c in range(2):
        single = tfe.detect_and_describe(c, imgs[c], None)
        assert torch.equal(tb[c].keypoints.uv, single.keypoints.uv)
        assert torch.equal(tb[c].keypoints.mask, single.keypoints.mask)
        assert torch.equal(tb[c].descriptors, single.descriptors)
        if octaves:
            np.testing.assert_array_equal(tb[c].sizes, single.sizes)
            assert set(np.unique(tb[c].sizes)).issubset({8.0, 16.0, 32.0})
        else:
            assert tb[c].sizes is None and single.sizes is None and jb[c].sizes is None
        _check_keypoints(tb[c].keypoints, jb[c].keypoints, tb[c].sizes, jb[c].sizes)
        np.testing.assert_array_equal(tb[c].mask_np, tb[c].keypoints.mask.numpy())
        m = tb[c].keypoints.mask.numpy()
        f, b = _bit_flips(tb[c].descriptors.numpy()[m], np.asarray(jb[c].descriptors)[m])
        flips, bits = flips + f, bits + b
        if masks is not None:
            uv = tb[c].uv_np[m]
            blank = ~masks[c][np.clip(np.round(uv[:, 1]).astype(int), 0, 119),
                              np.clip(np.round(uv[:, 0]).astype(int), 0, 159)]
            assert not blank.any() or octaves > 0  # a coarse octave's point may sit 1.5 px off its cell
    assert flips == 0, f"descriptor bit flips vs JAX: {flips} of {bits}"
