"""The port's multi-period and multi-scale discriminators against the JAX
package's, from the same (converted) parameters: all 5 periods and 3 scales
at width_mult 1/16 (grouped convs included), logits, every feature map and
the parameter gradients.

Tolerances: float32 convolutions summed in another order: outputs rtol 1e-4,
atol 1e-5 * max|ref| per map; gradients per leaf within 1e-4 * max|g|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsc_tpu.models import discriminators as JD
from nsc_tpu_torch import weights as W
from nsc_tpu_torch.models import discriminators as D

WIDTH = 1 / 16


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, JD.init_discriminators(jax.random.PRNGKey(0), WIDTH))


def _wav(n, t, seed=0):
    return (np.random.RandomState(seed).randn(n, t) * 0.3).astype(np.float32)


def _to_channels_last(f: torch.Tensor) -> np.ndarray:
    """Port NCHW / NCW feature map -> the JAX package's NHWC / NWC."""
    return np.moveaxis(f.detach().numpy(), 1, -1)


@pytest.mark.parametrize("t", [1000, 1001])
def test_outputs_and_features_match_jax(jparams, t):
    """t=1001 reflect-pads every period but 7 and 11 (1001 = 7 * 11 * 13)."""
    wav = _wav(3, t)
    ref = jax.jit(JD.apply_discriminators)(jparams, jnp.asarray(wav))
    got = D.apply_discriminators(W.to_tensors(jparams), torch.from_numpy(wav))
    assert len(got) == len(ref) == len(JD.PERIODS) + JD.MSD_SCALES
    for (lg, fs), (rlg, rfs) in zip(got, ref):
        rlg = np.asarray(rlg)
        assert lg.shape == rlg.shape
        np.testing.assert_allclose(lg.detach().numpy(), rlg, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(rlg).max(), 1e-3))
        assert len(fs) == len(rfs)
        for f, rf in zip(fs, rfs):
            rf = np.asarray(rf)
            got_f = _to_channels_last(f)
            assert got_f.shape == rf.shape
            np.testing.assert_allclose(got_f, rf, rtol=1e-4, atol=1e-5 * max(np.abs(rf).max(), 1e-3))


def test_parameter_gradients_match_jax(jparams):
    wav = _wav(2, 800, seed=1)

    def jloss(p):
        outs = JD.apply_discriminators(p, jnp.asarray(wav))
        return sum(jnp.mean(lg**2) + sum(jnp.mean(jnp.abs(f)) for f in fs) for lg, fs in outs)

    ref = jax.tree.map(np.asarray, jax.jit(jax.grad(jloss))(jparams))
    tree = W.tree_map(lambda x: x.requires_grad_(True), W.to_tensors(jparams))
    outs = D.apply_discriminators(tree, torch.from_numpy(wav))
    loss = sum(torch.mean(lg**2) + sum(torch.mean(torch.abs(f)) for f in fs) for lg, fs in outs)
    loss.backward()
    got = W.tree_map(lambda x: x.grad.numpy(), tree)
    flat_r, _ = jax.tree.flatten(ref)
    flat_g, _ = jax.tree.flatten(got)
    assert len(flat_r) == len(flat_g) == 3 * (5 * 5 + 3 * 6)
    for g, r in zip(flat_g, flat_r):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * np.abs(r).max())


def test_avg_pool_half_matches_jax():
    wav = _wav(2, 999, seed=3)
    np.testing.assert_allclose(
        D.avg_pool_half(torch.from_numpy(wav)).numpy(),
        np.asarray(JD._avg_pool_half(jnp.asarray(wav))), rtol=1e-6, atol=1e-7,
    )


@pytest.mark.parametrize("width", [1.0, 0.25, WIDTH])
def test_seeded_init_has_the_jax_tree_structure(width):
    """Shapes of every leaf equal the JAX init's, and g = ||v|| per output
    channel (so w = v at init, as in the JAX package)."""
    ref = jax.eval_shape(lambda k: JD.init_discriminators(k, width), jax.random.PRNGKey(0))
    got = D.init_discriminators(0, width)
    shapes_r = jax.tree.map(lambda x: tuple(x.shape), ref)
    shapes_g = W.tree_map(lambda x: tuple(x.shape), got)
    assert jax.tree.flatten(shapes_g)[0] == jax.tree.flatten(shapes_r)[0]
    for layers in got["mpd"] + got["msd"]:
        for p in layers:
            v = p["v"]
            norm = torch.sqrt((v * v).sum(dim=tuple(range(v.dim() - 1))))
            torch.testing.assert_close(p["g"], norm)
    assert torch.equal(D.init_discriminators(0, width)["msd"][0][1]["v"],
                       got["msd"][0][1]["v"])
