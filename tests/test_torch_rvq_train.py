"""The training half of the port's RVQ against the JAX package's
`ops/rvq.py`, on the same numpy latents and codebooks, with JAX's own random
draws (reseed picks, init permutations) passed into the port.

Tolerances: indices bit-equal on random-init books and assignment counts
exact (sums of ones); sums, EMA state, candidates and data-init codebooks at
rtol 1e-5 (float32 sums in another order: the port adds rows with
index_add_, the JAX package takes a one-hot product); quantized outputs and
the commitment loss at rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsc_tpu.ops import rvq as JR
from nsc_tpu_torch import kernels
from nsc_tpu_torch.ops import rvq as R


def _state(n_q, k, d, seed=0):
    rng = np.random.RandomState(seed)
    cb = rng.randn(n_q, k, d).astype(np.float32)
    return {
        "codebooks": cb,
        "ema_count": (rng.rand(n_q, k) * 6).astype(np.float32),
        "ema_sum": (cb * 3 + rng.randn(n_q, k, d) * 0.1).astype(np.float32),
    }


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _z(n, t, d, seed=1):
    return (np.random.RandomState(seed).randn(n, t, d) * 1.5).astype(np.float32)


@pytest.mark.parametrize("with_depth", [False, True])
def test_forward_matches_jax(with_depth):
    st = _state(4, 32, 8)
    z = _z(3, 20, 8)
    depth = np.array([1, 4, 2], np.int32) if with_depth else None
    ref = JR.forward(jax.tree.map(jnp.asarray, st), jnp.asarray(z),
                     depth=None if depth is None else jnp.asarray(depth))
    kernels.reset_launches()
    got = R.forward(_t(st), torch.from_numpy(z),
                    depth=None if depth is None else torch.from_numpy(depth))
    assert kernels.LAUNCHES["rvq_quantize"] == 0  # the CPU runs the plain version
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(ref.counts))
    np.testing.assert_array_equal(got.usage.numpy(), np.asarray(ref.usage))
    np.testing.assert_allclose(got.sums.numpy(), np.asarray(ref.sums), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.quantized.numpy(), np.asarray(ref.quantized), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got.commit_loss.item(), float(ref.commit_loss), rtol=1e-6)


def test_forward_prefix_property_and_depth_mask():
    """Indices of the first books equal a shallower encode's; a depth-1
    sample contributes only book 0 to the output and the stats."""
    st = _t(_state(4, 32, 8, seed=3))
    z = torch.from_numpy(_z(2, 10, 8, seed=4))
    full = R.forward(st, z)
    shallow = R.forward({"codebooks": st["codebooks"][:2]}, z)
    assert torch.equal(full.indices[..., :2], shallow.indices)
    masked = R.forward(st, z, depth=torch.tensor([1, 4]))
    cb = st["codebooks"]
    np.testing.assert_allclose(masked.quantized[0].numpy(),
                               cb[0][full.indices[0, :, 0].long()].numpy(), rtol=1e-6,
                               atol=1e-6)
    assert masked.counts[1:].sum().item() == 3 * 10  # only sample 1 beyond book 0


def test_straight_through_gradient_matches_jax():
    st = _state(3, 16, 6, seed=5)
    z = _z(2, 7, 6, seed=6)
    w = np.random.RandomState(7).randn(2, 7, 6).astype(np.float32)

    def jloss(zz):
        f = JR.forward(jax.tree.map(jnp.asarray, st), zz)
        return jnp.sum(f.quantized * w) + 0.7 * f.commit_loss

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(z)))
    zt = torch.from_numpy(z).requires_grad_(True)
    f = R.forward(_t(st), zt)
    (torch.sum(f.quantized * torch.from_numpy(w)) + 0.7 * f.commit_loss).backward()
    np.testing.assert_allclose(zt.grad.numpy(), ref, rtol=1e-6, atol=1e-7)


def test_ema_update_with_reseed_matches_jax():
    st = _state(3, 32, 8, seed=8)
    z = _z(4, 25, 8, seed=9)
    js = jax.tree.map(jnp.asarray, st)
    f = JR.forward(js, jnp.asarray(z))
    pool = jnp.asarray(z).reshape(-1, 8)
    key = jax.random.PRNGKey(3)
    cand_ref = JR.sample_reseed_candidates(key, pool, 3, 32)
    picks = np.asarray(jax.random.randint(key, (3, 32), 0, pool.shape[0]))
    cand = R.sample_reseed_candidates(torch.from_numpy(np.array(pool)), 3, 32,
                                      picks=torch.from_numpy(picks.copy()))
    np.testing.assert_array_equal(cand.numpy(), np.asarray(cand_ref))
    ref, ref_m = JR.ema_update(js, f.counts, f.sums, decay=0.9, dead_threshold=2.0,
                               reseed_candidates=cand_ref, return_metrics=True)
    got, frac = R.ema_update(_t(st), torch.from_numpy(np.array(f.counts)),
                             torch.from_numpy(np.array(f.sums)), decay=0.9,
                             dead_threshold=2.0, reseed_candidates=cand)
    assert 0 < frac.item() < 1
    np.testing.assert_allclose(frac.item(), float(ref_m["reseed_frac"]), rtol=1e-7)
    for k in ("codebooks", "ema_count", "ema_sum"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-6)


def test_ema_update_on_fewer_books_keeps_the_rest():
    st = _state(4, 16, 4, seed=10)
    counts = np.random.RandomState(0).rand(2, 16).astype(np.float32) * 3
    sums = np.random.RandomState(1).randn(2, 16, 4).astype(np.float32)
    ref = JR.ema_update(jax.tree.map(jnp.asarray, st), jnp.asarray(counts), jnp.asarray(sums))
    got, frac = R.ema_update(_t(st), torch.from_numpy(counts), torch.from_numpy(sums))
    assert frac.item() == 0.0
    for k in ("codebooks", "ema_count", "ema_sum"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got[k][2:].numpy(), st[k][2:])


def _jax_init_picks(key, n_q, k, m):
    """The pool indices `init_codebooks_from_data` draws: per book, split
    the carried key and take a permutation of the pool (wrapping)."""
    picks = []
    for _ in range(n_q):
        key, k_pick = jax.random.split(key)
        picks.append(np.asarray(jax.random.permutation(k_pick, m)[jnp.arange(k) % max(m, 1)]))
    return np.stack(picks)


@pytest.mark.parametrize("m_rows,k", [(200, 16), (12, 16)])
def test_init_codebooks_from_data_matches_jax(m_rows, k):
    """(12, 16): the pool is smaller than K, so picks wrap (duplicate codes)."""
    st = _state(3, k, 6, seed=11)
    z = (np.random.RandomState(12).randn(m_rows, 6) * 2).astype(np.float32)
    key = jax.random.PRNGKey(77)
    ref = JR.init_codebooks_from_data(key, jax.tree.map(jnp.asarray, st), jnp.asarray(z))
    picks = _jax_init_picks(key, 3, k, m_rows)
    got = R.init_codebooks_from_data(_t(st), torch.from_numpy(z), picks=torch.from_numpy(picks))
    np.testing.assert_allclose(got["codebooks"].numpy(), np.asarray(ref["codebooks"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got["ema_count"].numpy(), np.asarray(ref["ema_count"]))
    np.testing.assert_allclose(got["ema_sum"].numpy(), np.asarray(ref["ema_sum"]),
                               rtol=1e-5, atol=1e-5)


def test_init_codebooks_from_generator_is_seeded():
    st = _t(_state(2, 8, 4, seed=13))
    z = torch.from_numpy(_z(2, 30, 4, seed=14))
    a = R.init_codebooks_from_data(st, z, generator=torch.Generator().manual_seed(5))
    b = R.init_codebooks_from_data(st, z, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a["codebooks"], b["codebooks"])
    with pytest.raises(ValueError):
        R.init_codebooks_from_data(st, z)


def test_perplexity_and_train_state_init_match_jax():
    counts = np.random.RandomState(15).randint(0, 5, (3, 20)).astype(np.float32)
    counts[1] = 0
    np.testing.assert_allclose(R.codebook_perplexity(torch.from_numpy(counts)).numpy(),
                               np.asarray(JR.codebook_perplexity(jnp.asarray(counts))),
                               rtol=1e-6)
    cb = np.random.RandomState(16).randn(2, 5, 3).astype(np.float32)
    st = R.init_rvq_train(torch.from_numpy(cb))
    assert torch.equal(st["ema_sum"], st["codebooks"]) and not st["ema_count"].any()
