"""The host side of the port's tensor-core RVQ search (K2), on the CPU: the
residual plane split at edge values, the codebook plane layout, and the
kernel's six-product score restated on the CPU (`quantize_emulated` below)
against the plain version and the JAX package's Pallas kernel in interpret
mode. The kernel itself runs only on a card
(`tests/test_torch_cuda.py`).

The kernel has two launch plans (residual planes resident in shared memory
up to a padded width of 128, streamed from device memory above it); both
run the same products in the same order, so `quantize_emulated` describes
both, and the shipped widths and widths past 128 are held here.

Tolerances: none. The split is exact (for |v| >= 2^-110; below that held to
bf16's smallest subnormal, 2^-133), and on random-init books the indices
of the emulation, the plain version and the JAX kernel are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsc_tpu.ops.pallas import rvq_argmin as JPK
from nsc_tpu_torch.configs import get_config
from nsc_tpu_torch.kernels import rvq as KR
from nsc_tpu_torch.kernels.residual_stack import split_planes


# (residual plane, code plane) of the six products csrc/rvq.cu sums, in its
# order, smallest first; planes 0 = hi, 1 = mid, 2 = lo
PLANE_PRODUCTS = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))


def quantize_emulated(codebooks, z):
    """The quantize kernel's arithmetic restated on the CPU: per book the
    residuals and codewords as bf16 planes, the six plane products of each
    16-dim step multiplied exactly and summed in float32 in the kernel's
    order, padded codes never scored. codebooks (n_q, K, D) f32, z (M, D)
    f32 -> (M, n_q) int32."""
    n_q, k, d = codebooks.shape
    kp, dp = KR.padded_shape(k, d)
    cplanes = KR.codebook_planes(codebooks).float()
    csq = KR.codeword_sq_norms(codebooks)
    r = z.float()
    out = []
    for q in range(n_q):
        rplanes = split_planes(torch.nn.functional.pad(r, (0, dp - d))).float()
        acc = torch.zeros(r.shape[0], kp)
        for ks in range(dp // KR.DIM_ALIGN):
            sl = slice(ks * KR.DIM_ALIGN, (ks + 1) * KR.DIM_ALIGN)
            for a, b in PLANE_PRODUCTS:
                acc = acc + rplanes[a][:, sl] @ cplanes[q, b][:, sl].t()
        scores = csq[q][None, :] - 2.0 * acc[:, :k]  # padded codes are not scored
        idx = torch.argmin(scores, dim=-1)
        out.append(idx)
        if q + 1 < n_q:
            r = r - codebooks[q][idx]
    return torch.stack(out, dim=-1).to(torch.int32)


def _bits(*words):
    return torch.tensor(np.array(words, dtype=np.uint32).view(np.float32))


def _planes_sum(planes):
    p = planes.float()
    return (p[0] + p[1]) + p[2]


def test_residual_split_exact_at_edge_values():
    """Residuals as the kernel meets them: zeros of both signs, differences
    of nearby codewords (every mantissa bit set, tiny), the smallest
    normals, 2^-110, and the largest finite floats."""
    a = torch.tensor([1.0000001, -3.1415927, 100.25, 7.0])
    b = torch.tensor([1.0, -3.1415925, 100.24999, -7.0])
    edges = torch.cat([
        torch.tensor([0.0, -0.0, 1e-20, -1e-20, 1e20, 65504.0, -2.0 ** -100]),
        a - b,
        _bits(0x00800000, 0x80800000, 0x08FFFFFF, 0x88FFFFFF, 0x3F7FFFFF,
              0xC2F7FFFF, 0x7F7FFFFF, 0xFF7FFFFF),
    ])
    planes = split_planes(edges)
    assert planes.dtype == torch.bfloat16 and torch.isfinite(planes.float()).all()
    assert torch.equal(_planes_sum(planes), edges)
    tiny = _bits(0x00800001, 0x00FFFFFF, 0x807FFFFF, 0x0800FFFF)
    assert ((_planes_sum(split_planes(tiny)) - tiny).abs() <= 2.0 ** -133).all()


def test_codebook_planes_layout():
    books = torch.randn(3, 300, 40, generator=torch.Generator().manual_seed(0))
    planes = KR.codebook_planes(books)
    kp, dp = KR.padded_shape(300, 40)
    assert (kp, dp) == (384, 48) and planes.shape == (3, 3, kp, dp)
    assert planes.dtype == torch.bfloat16 and planes.is_contiguous()
    assert torch.equal(_planes_sum(planes.transpose(0, 1))[:, :300, :40], books)
    assert not planes[:, :, 300:].float().any() and not planes[..., 40:].float().any()


def test_plane_products_are_the_six_largest_smallest_first():
    prods = PLANE_PRODUCTS
    assert len(set(prods)) == 6
    # a product of planes a and b is ~2^-8(a+b) of r.c: the dropped three
    # have a + b > 2, and the order never goes from a smaller to a larger one
    assert all(a + b <= 2 for a, b in prods)
    order = [a + b for a, b in prods]
    assert order == sorted(order, reverse=True) and prods[-1] == (0, 0)


@pytest.mark.parametrize("name", ["tiny_test", "small", "small_factorized", "base"])
def test_emulated_score_matches_plain_and_pallas(name):
    cfg = get_config(name)
    n_q, k, d = cfg.num_quantizers, cfg.codebook_size, cfg.codebook_dim
    rs = np.random.RandomState(n_q * k + d)
    books = rs.randn(n_q, k, d).astype(np.float32)  # N(0, 1), as ops.rvq.init_rvq
    z = rs.randn(300, d).astype(np.float32)  # not a multiple of the 128-frame tile
    got = quantize_emulated(torch.from_numpy(books), torch.from_numpy(z)).numpy()
    plain = KR.quantize_plain(torch.from_numpy(books), torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(got, plain)
    pallas = np.asarray(JPK.quantize_pallas(jnp.asarray(books), jnp.asarray(z), interpret=True))
    np.testing.assert_array_equal(got, pallas)


# widths of the streamed plan: the first padded width past 128 (D 129 ->
# 144, a 16-dim last stage), and the two chip_smoke.py times
@pytest.mark.parametrize("n_q,k,d", [(3, 128, 129), (2, 256, 256), (2, 128, 384)])
def test_emulated_score_matches_plain_and_pallas_at_wide_widths(n_q, k, d):
    rs = np.random.RandomState(d)
    books = rs.randn(n_q, k, d).astype(np.float32)
    z = rs.randn(300, d).astype(np.float32)
    assert KR.padded_shape(k, d)[1] > KR.RESIDENT_DIM
    got = quantize_emulated(torch.from_numpy(books), torch.from_numpy(z)).numpy()
    plain = KR.quantize_plain(torch.from_numpy(books), torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(got, plain)
    pallas = np.asarray(JPK.quantize_pallas(jnp.asarray(books), jnp.asarray(z), interpret=True))
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("k", [16, 200])
def test_padded_codes_are_never_chosen(k):
    """Codewords far from the origin and residuals at it: a padded (zero)
    code would score 0 against ||c||^2 > 0 and win if it were scored."""
    rs = np.random.RandomState(k)
    books = rs.randn(2, k, 8).astype(np.float32)
    books += np.sign(books) * 4.0
    z = np.concatenate([np.zeros((5, 8)), rs.randn(60, 8) * 0.01]).astype(np.float32)
    got = quantize_emulated(torch.from_numpy(books), torch.from_numpy(z))
    assert KR.padded_shape(k, 8)[0] > k
    assert int(got.max()) < k
    assert torch.equal(got, KR.quantize_plain(torch.from_numpy(books), torch.from_numpy(z)))


@pytest.mark.parametrize("d", [129, 384, 1024])
def test_quantize_kernel_takes_every_width(d):
    """The wrapper's checks take any width past the resident plan's (and
    every shipped one), and still refuse empty books or frames of another
    width, before any launch."""
    for name in ("tiny_test", "small", "small_factorized", "base", "base_fast", "base_fast_f"):
        cfg = get_config(name)
        KR._check_quantize(torch.zeros(cfg.num_quantizers, cfg.codebook_size, cfg.codebook_dim),
                           torch.zeros(4, cfg.codebook_dim))
    KR._check_quantize(torch.zeros(2, 16, d), torch.zeros(4, d))
    for books, z in ((torch.zeros(1, 16, 0), torch.zeros(4, 0)),
                     (torch.zeros(0, 16, d), torch.zeros(4, d)),
                     (torch.zeros(1, 0, d), torch.zeros(4, d)),
                     (torch.zeros(1, 16, d), torch.zeros(4, d - 1))):
        with pytest.raises(ValueError):
            KR._check_quantize(books, z)


def quantize_smem(dp):
    """A quantize block's shared memory at padded width dp, as csrc/rvq.cu's
    quantize_smem plans it: the resident plan's three bf16 residual planes of
    the tile, two stages of code planes (128 codes x 64 dims x 3 planes) that
    the streamed plan doubles with the tile's residual planes of the same
    dims, and the argmin scratch: per frame 8 lists (4 lanes x 2 warps) of
    two (score, index) candidates, and the chosen index (the card test
    reads the kernel's own)."""
    stage = 3 * KR.CODE_TILE * 64 * 2
    argmin = KR.TILE_M * (8 * 2 * 2 + 1) * 4
    if dp > KR.RESIDENT_DIM:
        return 2 * 2 * stage + argmin
    return KR.TILE_M * dp * 2 * 3 + 2 * stage + argmin


def test_quantize_smem_fits_every_width():
    """Resident planes grow by 768 bytes a dim up to 128; the streamed plan
    holds 213,504 bytes at every width; all within one Hopper block."""
    from nsc_tpu_torch.kernels.residual_stack import MAX_SMEM

    for dp in range(16, 1025, 16):
        assert quantize_smem(dp) <= MAX_SMEM, dp
    assert quantize_smem(128) == quantize_smem(144) == quantize_smem(1024) == 213504
    assert quantize_smem(112) == 213504 - 16 * 768
