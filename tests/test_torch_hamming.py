"""okvis_tpu_torch Hamming matching against the JAX package: both plain
distance forms, the masked matrix (also batched, against jax.vmap) and the
mutual-best assignment, exact on inputs with many ties. The CUDA kernel's own
checks are in tests/test_torch_cuda.py (they need a card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis_tpu.ops import hamming as jham
from okvis_tpu.ops.hamming_pallas import hamming_matrix_pallas
from okvis_tpu_torch.ops import hamming as tham

torch.set_num_threads(2)


def _desc(rng, n):
    return rng.integers(0, 2**32, (n, 16), dtype=np.uint32)


def _t(d_u32):
    """uint32 descriptors -> the port's int32 bit patterns."""
    return torch.from_numpy(np.ascontiguousarray(d_u32).view(np.int32))


def _near_copies(rng, base, n, flips):
    """n descriptors, each a copy of a random row of `base` with `flips`
    random bits flipped — distances are small integers with many ties."""
    rows = base[rng.integers(0, len(base), n)].copy()
    bits = np.unpackbits(rows.view(np.uint8), axis=1, bitorder="little")
    for r in range(n):
        bits[r, rng.choice(512, flips, replace=False)] ^= 1
    return np.packbits(bits, axis=1, bitorder="little").view(np.uint32)


@pytest.mark.parametrize("na,nb", [(128, 256), (400, 400), (37, 301), (1, 129)])
def test_distance_forms_match_jax(na, nb):
    rng = np.random.default_rng(na * 1000 + nb)
    a, b = _desc(rng, na), _desc(rng, nb)
    want = np.asarray(jham.hamming_matrix_xla(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(tham.hamming_matrix_plain(_t(a), _t(b)).numpy(), want)
    np.testing.assert_array_equal(tham.hamming_matrix_mxu(_t(a), _t(b)).numpy(), want)
    np.testing.assert_array_equal(tham.hamming_matrix(_t(a), _t(b)).numpy(), want)
    assert tham.hamming_matrix(_t(a), _t(b)).dtype == torch.int32


def test_plain_matches_pallas_interpret():
    """At the JAX test's shape (128 x 256) the Pallas kernel in interpret
    mode, the XLA form and both port forms give the same integers."""
    rng = np.random.default_rng(42)
    a, b = _desc(rng, 128), _desc(rng, 256)
    want = np.asarray(hamming_matrix_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True))
    np.testing.assert_array_equal(tham.hamming_matrix_plain(_t(a), _t(b)).numpy(), want)
    np.testing.assert_array_equal(tham.hamming_matrix_mxu(_t(a), _t(b)).numpy(), want)


def test_unpack_to_pm1_matches_jax():
    rng = np.random.default_rng(3)
    a = _desc(rng, 9)
    a[0, 0] = 0x80000001  # bit 31 set: the int32 pattern is negative
    want = np.asarray(jham.unpack_to_pm1(jnp.asarray(a), jnp.float32))
    np.testing.assert_array_equal(tham.unpack_to_pm1(_t(a)).numpy(), want)


# (G, NA, NB, B batched, masks): the association's batch (one frame's B
# against 8 sources, broadcast), ragged NA != NB, all-false and all-true masks
@pytest.mark.parametrize("g,na,nb,b_batched,masks", [
    (8, 40, 56, False, "random"), (3, 37, 29, True, "random"), (2, 16, 24, True, "none"),
    (1, 48, 48, False, "all")])
def test_batched_masked_matrix_matches_jax_vmap(g, na, nb, b_batched, masks):
    rng = np.random.default_rng(g * 100 + na)
    a = _desc(rng, g * na).reshape(g, na, 16)
    b = _desc(rng, (g if b_batched else 1) * nb).reshape(-1, nb, 16)
    a[:, 0, 0] = 0x80000001  # bit 31 set: the int32 pattern is negative
    b[:, -1, 5] = 0xFFFFFFFF
    draw = {"random": lambda s: rng.uniform(size=s) > 0.2, "none": lambda s: np.zeros(s, bool),
            "all": lambda s: np.ones(s, bool)}[masks]
    ma, mb = draw((g, na)), draw(b.shape[:2])
    if not b_batched:  # the port takes B and its mask without a batch and broadcasts
        b, mb = b[0], mb[0]
    axes = 0 if b_batched else None
    want = np.asarray(jax.vmap(jham.masked_distance_matrix, in_axes=(0, axes, 0, axes))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(ma), jnp.asarray(mb)))
    got = tham.masked_distance_matrix(_t(a), _t(b), torch.from_numpy(ma), torch.from_numpy(mb))
    assert got.dtype == torch.int32 and got.shape == (g, na, nb)
    np.testing.assert_array_equal(got.numpy(), want)
    want_d = np.asarray(jax.vmap(jham.hamming_matrix_xla, in_axes=(0, axes))(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(tham.hamming_matrix_plain(_t(a), _t(b)).numpy(), want_d)
    if masks == "none":
        assert (got == tham.MAX_DIST).all()


def _tie_case(seed, na=300, nb=280, flips=24):
    rng = np.random.default_rng(seed)
    base = _desc(rng, 60)
    a = _near_copies(rng, base, na, flips)
    b = _near_copies(rng, base, nb, flips)
    mask_a = rng.uniform(size=na) > 0.1
    mask_b = rng.uniform(size=nb) > 0.1
    return a, b, mask_a, mask_b


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("ratio", [0.0, 0.8])
def test_masked_assignment_matches_jax_with_ties(seed, ratio):
    a, b, ma, mb = _tie_case(seed)
    jd = jham.masked_distance_matrix(jnp.asarray(a), jnp.asarray(b), jnp.asarray(ma), jnp.asarray(mb))
    td = tham.masked_distance_matrix(_t(a), _t(b), torch.from_numpy(ma), torch.from_numpy(mb))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    # many exact ties: check the fixture really has them
    row_min = np.asarray(jd).min(axis=1)
    assert (np.asarray(jd) == row_min[:, None]).sum(axis=1).max() > 1
    want = np.asarray(jham.mutual_best_assignment(jd, 60, distance_ratio=ratio))
    got = tham.mutual_best_assignment(td, 60, distance_ratio=ratio).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).sum() > (10 if ratio == 0 else 0)


def test_match_descriptors_matches_jax():
    a, b, ma, mb = _tie_case(7, flips=40)
    want = np.asarray(jham.match_descriptors(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(ma), jnp.asarray(mb), threshold=60, use_mxu=False))
    got = tham.match_descriptors(_t(a), _t(b), torch.from_numpy(ma), torch.from_numpy(mb), threshold=60)
    np.testing.assert_array_equal(got.numpy(), want)


def test_small_integer_distance_matrix_assignment():
    """Assignment on a raw distance matrix of values 0..5 (ties everywhere)."""
    rng = np.random.default_rng(11)
    d = rng.integers(0, 6, (120, 90)).astype(np.int32)
    for rounds in (1, 3, 5):
        want = np.asarray(jham.mutual_best_assignment(jnp.asarray(d), 4, rounds=rounds))
        got = tham.mutual_best_assignment(torch.from_numpy(d), 4, rounds=rounds).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("strided", ["desc_a", "desc_b", "mask_a", "mask_b"])
def test_masked_matrix_refuses_strided_inputs_on_the_cpu(strided):
    """The kernel refuses strided rows; the CPU route refuses them too, so a
    CPU run of a caller meets the rule the card holds it to. A camera's slice
    of a (P, C, K, 16) stack is strided until it is made contiguous."""
    rng = np.random.default_rng(11)
    stack = _t(_desc(rng, 3 * 2 * 40).reshape(3, 2, 40, 16))
    masks = torch.from_numpy(rng.uniform(size=(3, 2, 40)) > 0.2)
    args = dict(desc_a=stack[:, 0].contiguous(), desc_b=stack[:, 1].contiguous(),
                mask_a=masks[:, 0].contiguous(), mask_b=masks[:, 1].contiguous())
    want = tham.masked_distance_matrix(**args)
    args[strided] = (stack if strided.startswith("desc") else masks)[:, 0 if strided.endswith("a") else 1]
    assert not args[strided].is_contiguous()
    with pytest.raises(ValueError, match=f"{strided} must be contiguous"):
        tham.masked_distance_matrix(**args)
    args[strided] = args[strided].contiguous()
    assert torch.equal(tham.masked_distance_matrix(**args), want)
