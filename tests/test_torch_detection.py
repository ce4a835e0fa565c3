"""okvis_tpu_torch Harris+NMS detection against the JAX package: the plain
version of the CUDA kernel against the XLA path and the Pallas kernel in
interpret mode, and detect_keypoints' selected keypoints (pooled top-k and
subpixel step). Float32 images on both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis_tpu.frontend import detection as jdet
from okvis_tpu.ops.detection_pallas import harris_suppressed_pallas
from okvis_tpu_torch.frontend import detection as tdet

torch.set_num_threads(2)
BORDER = 20


def _random_image(seed, H=96, W=128):
    return np.random.default_rng(seed).uniform(0, 255, (H, W)).astype(np.float32)


def _blocky_image(seed, H=240, W=376):
    """Smooth background with blocky textured squares: corners and edges,
    so the Harris response crosses zero as in rendered frames."""
    rng = np.random.default_rng(seed)
    img = np.full((H, W), 110.0, np.float32) + rng.normal(0, 1.0, (H, W)).astype(np.float32)
    for _ in range(40):
        y, x = rng.integers(10, H - 22), rng.integers(10, W - 22)
        img[y:y + 12, x:x + 12] += np.kron(rng.uniform(-70, 70, (4, 4)), np.ones((3, 3)))
    return np.clip(img, 0, 255).astype(np.float32)


def _inb(H, W):
    ys = np.arange(H)[:, None]
    xs = np.arange(W)[None, :]
    return (ys >= BORDER) & (ys < H - BORDER) & (xs >= BORDER) & (xs < W - BORDER)


def _check_harris(raw_t, sup_t, raw_j, sup_j, H, W):
    """The JAX test's tolerances: interior response rtol 1e-4 / atol 1e-3,
    identical finite pattern of the suppressed map, nothing outside inb."""
    sl = (slice(BORDER, H - BORDER), slice(BORDER, W - BORDER))
    np.testing.assert_allclose(raw_t[sl], raw_j[sl], rtol=1e-4, atol=1e-3)
    fin_t, fin_j = np.isfinite(sup_t), np.isfinite(sup_j)
    assert (fin_t == fin_j).all()
    assert fin_t.any()
    assert not fin_t[:BORDER].any() and not fin_t[:, :BORDER].any()
    assert not fin_t[H - BORDER:].any() and not fin_t[:, W - BORDER:].any()


@pytest.mark.parametrize("kind", ["random", "blocky"])
def test_plain_harris_nms_matches_xla_path(kind):
    img = _random_image(42) if kind == "random" else _blocky_image(5, 96, 128)
    H, W = img.shape
    inb = _inb(H, W)
    raw_j = jdet.harris_response(jnp.asarray(img))
    sup_j = jdet.nms(jnp.where(jnp.asarray(inb), raw_j, -jnp.inf), radius=4)
    raw_t, sup_t = tdet.harris_suppressed_plain(torch.from_numpy(img), torch.from_numpy(inb).float())
    _check_harris(raw_t.numpy(), sup_t.numpy(), np.asarray(raw_j), np.asarray(sup_j), H, W)


def test_plain_harris_nms_matches_pallas_interpret():
    img = _random_image(43)
    H, W = img.shape
    inb = _inb(H, W).astype(np.float32)
    raw_p, sup_p = harris_suppressed_pallas(jnp.asarray(img), jnp.asarray(inb), interpret=True)
    raw_t, sup_t = tdet.harris_suppressed(torch.from_numpy(img)[None], torch.from_numpy(inb)[None])
    _check_harris(raw_t[0].numpy(), sup_t[0].numpy(), np.asarray(raw_p), np.asarray(sup_p), H, W)


def test_gaussian_taps_match_pallas_and_xla():
    from okvis_tpu.ops.detection_pallas import _gauss_taps

    taps = tdet.gaussian_kernel(1.5).numpy()
    np.testing.assert_array_equal(taps, np.asarray(_gauss_taps(1.5), np.float32))
    np.testing.assert_allclose(taps, np.asarray(jdet.gaussian_kernel(1.5)), rtol=0, atol=1e-7)


def _valid_sorted(uv, score, mask):
    uv, score = np.asarray(uv)[np.asarray(mask)], np.asarray(score)[np.asarray(mask)]
    order = np.lexsort((uv[:, 1], uv[:, 0], -score))
    return uv[order], score[order]


def _check_same_keypoints(kt, kj):
    mt, mj = kt.mask.numpy(), np.asarray(kj.mask)
    assert mt.sum() == mj.sum() and mt.sum() > 0
    uv_t, s_t = _valid_sorted(kt.uv.numpy(), kt.score.numpy(), mt)
    uv_j, s_j = _valid_sorted(kj.uv, kj.score, mj)
    np.testing.assert_allclose(uv_t, uv_j, atol=1e-3)
    np.testing.assert_allclose(s_t, s_j, rtol=1e-4)


@pytest.mark.parametrize(
    "seed,threshold,max_keypoints,nms_radius",
    [(0, 1.0, 64, 4), (1, 30.0, 128, 4), (2, 1.0, 96, 2)],
    ids=["pooled-64", "pooled-128", "full-topk"],
)
def test_detect_keypoints_matches_jax(seed, threshold, max_keypoints, nms_radius):
    img = _random_image(seed) if seed == 0 else _blocky_image(seed)
    kj = jdet.detect_keypoints(jnp.asarray(img), threshold=threshold, max_keypoints=max_keypoints,
                               nms_radius=nms_radius, use_pallas=False)
    kt = tdet.detect_keypoints(torch.from_numpy(img), threshold=threshold,
                               max_keypoints=max_keypoints, nms_radius=nms_radius)
    _check_same_keypoints(kt, kj)


def test_detect_keypoints_batch_and_mask_match_jax():
    imgs = np.stack([_blocky_image(3), _blocky_image(4)])
    H, W = imgs.shape[1:]
    mask = np.ones((2, H, W), bool)
    mask[0, :, : W // 2] = False
    kt = tdet.detect_keypoints(torch.from_numpy(imgs), threshold=15.0, max_keypoints=128,
                               mask=torch.from_numpy(mask))
    for c in range(2):
        kj = jdet.detect_keypoints(jnp.asarray(imgs[c]), threshold=15.0, max_keypoints=128,
                                   mask=jnp.asarray(mask[c]), use_pallas=False)
        _check_same_keypoints(tdet.Keypoints(*(t[c] for t in kt)), kj)
    assert (kt.uv[0][kt.mask[0]][:, 0] >= W // 2 - 1).all()


def test_no_nan_keypoints_at_border():
    """A detection on the border-mask edge refines on the raw response."""
    img = np.full((100, 140), 100.0, np.float32)
    img[40:, 20:] += 80.0  # strong corner exactly at x=20 == border
    kps = tdet.detect_keypoints(torch.from_numpy(img), threshold=5.0, max_keypoints=16, border=20)
    uv = kps.uv[kps.mask].numpy()
    assert len(uv) > 0 and np.isfinite(uv).all()


def test_harris_routes_cpu_to_plain_and_cuda_wrapper_refuses_cpu():
    from okvis_tpu_torch.ops.detection_cuda import harris_suppressed_cuda

    img = torch.from_numpy(_random_image(9))[None]
    inb = torch.from_numpy(_inb(96, 128)).float()[None]
    raw, sup = tdet.harris_suppressed(img, inb)
    raw_p, sup_p = tdet.harris_suppressed_plain(img, inb)
    assert torch.equal(raw, raw_p) and torch.equal(sup, sup_p)
    before = harris_suppressed_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        harris_suppressed_cuda(img, inb)
    assert harris_suppressed_cuda.launches == before
