"""The port's codebook refit (`nsc_tpu_torch.train.refit`) against the JAX
package's (`nsc_tpu.train.refit`), on the CPU.

Tolerances: `pool_report`'s counts (usage, perplexity) exact on random
books, where no score is a near-tie (the port's plain search and XLA's
`_nearest` compute the same float32 scores up to summation order); its
per-depth residual MSE at rtol 1e-5 (float32 means in another order);
`collect_latents` at the codec tests' float32 latent tolerance, rtol 1e-4 /
atol 1e-5 (conv summation order). The k-means draws come from different
generators, so the refit is held to the JAX test's properties, not to
equal books.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsc_tpu.configs import get_config as jget_config
from nsc_tpu.models.codec import NeuralSpeechCodec
from nsc_tpu.train import refit as JR
from nsc_tpu_torch import api as PA
from nsc_tpu_torch import weights as W
from nsc_tpu_torch.configs import get_config
from nsc_tpu_torch.train import refit
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def _clustered_pool(m: int = 2048, d: int = 8, clusters: int = 24, seed: int = 0):
    """tests/unit/test_refit.py::_clustered_pool, as numpy."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(clusters, d).astype(np.float32) * 3.0
    assign = rng.randint(0, clusters, size=m)
    return centers[assign] + 0.1 * rng.randn(m, d).astype(np.float32)


@pytest.mark.parametrize("n_q,k,d,m", [(2, 16, 8, 2048), (4, 64, 16, 3000)])
def test_pool_report_matches_jax(n_q, k, d, m):
    rng = np.random.RandomState(n_q)
    books = rng.randn(n_q, k, d).astype(np.float32)
    pool = (rng.randn(m, d) * 1.5).astype(np.float32)
    counts_j, mse_j = JR._pool_stats({"codebooks": jnp.asarray(books)}, jnp.asarray(pool))
    counts_p, mse_p = refit.pool_stats({"codebooks": torch.from_numpy(books)},
                                       torch.from_numpy(pool))
    np.testing.assert_array_equal(counts_p.numpy(), np.asarray(counts_j))
    np.testing.assert_allclose(mse_p.numpy(), np.asarray(mse_j), rtol=1e-5)
    want = JR.pool_report({"codebooks": jnp.asarray(books)}, jnp.asarray(pool))
    got = refit.pool_report({"codebooks": torch.from_numpy(books)}, torch.from_numpy(pool))
    assert set(got) == set(want)
    for key in ("book_usage", "book_perplexity", "mean_usage"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["residual_mse_per_depth"], want["residual_mse_per_depth"],
                               rtol=1e-5, atol=1e-6)


def test_collect_latents_matches_jax():
    cfg = get_config("small")
    params, rvq = W.init_jax_layout(cfg, 2)
    bundle = PA.bundle_from_jax(cfg, params, rvq, device="cpu")
    jbundle = types.SimpleNamespace(model=NeuralSpeechCodec(jget_config("small")),
                                    params=jax.tree.map(jnp.asarray, params))
    waves = [np.random.RandomState(i).randn(2, 6 * cfg.hop).astype(np.float32) * 0.1
             for i in range(3)]
    got = refit.collect_latents(bundle, iter(waves), 3)
    want = np.asarray(JR.collect_latents(jbundle, iter(waves), 3))
    assert got.dtype == torch.float32 and got.shape == want.shape == (3 * 2 * 6, cfg.codebook_dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_refit_improves_usage_and_residual_mse():
    """Port of tests/unit/test_refit.py::
    test_refit_improves_usage_and_residual_mse."""
    bundle = PA.load_model("tiny_test", seed=0, device="cpu")
    pool = torch.from_numpy(_clustered_pool(d=bundle.cfg.codebook_dim))
    before = refit.pool_report(bundle.rvq, pool)
    rvq2 = refit.refit_codebooks(bundle.rvq, pool, kmeans_iters=6, seed=1)
    after = refit.pool_report(rvq2, pool)
    assert after["mean_usage"] >= before["mean_usage"]
    assert after["mean_usage"] >= 0.9  # every code seeded at a data point
    for b, a in zip(before["residual_mse_per_depth"], after["residual_mse_per_depth"]):
        assert a < b  # strictly better at every depth
    assert set(rvq2) == {"codebooks", "ema_count", "ema_sum"}
    assert rvq2["codebooks"].shape == bundle.rvq["codebooks"].shape
    assert bool(torch.all(rvq2["ema_count"] > 0))
    torch.testing.assert_close(rvq2["ema_sum"], rvq2["codebooks"] * rvq2["ema_count"][..., None],
                               rtol=0, atol=0)


def test_collect_latents_shape_and_pooling():
    """Port of tests/unit/test_refit.py::test_collect_latents_shape_and_pooling."""
    bundle = PA.load_model("tiny_test", seed=0, device="cpu")
    cfg = bundle.cfg
    seg = 8 * cfg.hop
    batches = iter([np.random.RandomState(i).randn(2, seg).astype(np.float32) * 0.1
                    for i in range(3)])
    pool = refit.collect_latents(bundle, batches, 3)
    assert pool.shape == (3 * 2 * 8, cfg.codebook_dim)
    assert pool.dtype == torch.float32 and pool.device == bundle.device
