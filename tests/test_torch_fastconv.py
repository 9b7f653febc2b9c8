"""The port's stacked convolutions (`nsc_tpu_torch/ops/fastconv.py`,
`conv_backend="stacked"`) against nsc_tpu's (`nsc_tpu/ops/fastconv.py`) and
against the port's own `ops.conv`, on the same numpy inputs, float32, CPU:
the parametrisations of `tests/unit/test_fastconv.py`.

Tolerances: rtol 1e-5 / atol 1e-5, as nsc_tpu's own test; each form sums
the same float32 products in another order (~1e-7 relative per sum).
Gradients (weight-norm (v, g), bias and input) rtol 1e-4 / atol 1e-4, as
nsc_tpu's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsc_tpu.ops import conv as JC
from nsc_tpu.ops import fastconv as JF
from nsc_tpu_torch import weights
from nsc_tpu_torch.ops import conv as PC
from nsc_tpu_torch.ops import fastconv as PF
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = dict(rtol=1e-5, atol=1e-5)


def _conv(seed, k, cin, cout):
    """JAX-layout weight-norm conv params, numpy, from a seed."""
    rng = np.random.RandomState(seed)
    v = (rng.uniform(-1, 1, (k, cin, cout)) / np.sqrt(k * cin)).astype(np.float32)
    return {"v": v, "g": np.sqrt((v * v).sum((0, 1))).astype(np.float32) * 1.3,
            "b": (rng.randn(cout) * 0.1).astype(np.float32)}


@pytest.mark.parametrize(
    "k,stride,dilation,stack",
    [(3, 1, 1, 8), (3, 1, 3, 8), (3, 1, 9, 4), (1, 1, 1, 8), (7, 1, 1, 8), (4, 2, 1, 4),
     (8, 4, 1, 2), (10, 5, 1, 2), (16, 8, 1, 2), (3, 1, 1, 5)],
)
def test_stacked_conv_matches_nsc_tpu_and_conv1d(k, stride, dilation, stack):
    cin, cout, t = 6, 10, 720
    p = _conv(k * 10 + stride, k, cin, cout)
    x = np.random.RandomState(1).randn(2, t, cin).astype(np.float32)
    want = np.asarray(JF.stacked_conv1d(jnp.asarray(x), p, stride=stride, dilation=dilation,
                                        stack=stack))
    pp = PC.conv_params(weights.to_tensors(p))
    xt = torch.from_numpy(x).transpose(1, 2)
    got = PF.stacked_conv1d(xt, pp, stride=stride, dilation=dilation, stack=stack)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want, **TOL)
    ref = PC.conv1d(xt, pp, stride=stride, dilation=dilation, padding="causal")
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


@pytest.mark.parametrize("k,stride", [(4, 2), (8, 4), (10, 5), (16, 8), (5, 2), (3, 3)])
def test_polyphase_transpose_matches_nsc_tpu_and_conv_transpose1d(k, stride):
    cin, cout, f = 6, 4, 33
    p = _conv(k + 100 * stride, k, cin, cout)
    x = np.random.RandomState(3).randn(2, f, cin).astype(np.float32)
    want = np.asarray(JF.polyphase_conv_transpose1d(jnp.asarray(x), p, stride=stride))
    pp = PC.conv_transpose_params(weights.to_tensors(p))
    xt = torch.from_numpy(x).transpose(1, 2)
    got = PF.polyphase_conv_transpose1d(xt, pp, stride=stride)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want, **TOL)
    if k >= stride:
        ref = PC.conv_transpose1d(xt, pp, stride=stride, causal=True)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


def test_gradients_match_nsc_tpu_and_conv1d():
    """d/d(v, g, b, x) of sum(y^2) through the dilated stacked conv on a
    length that is not a multiple of the dilation (the right-pad path)."""
    p = _conv(4, 3, 4, 4)
    x = np.random.RandomState(5).randn(1, 70, 4).astype(np.float32)

    def jax_loss(fn, pp, xx):
        return jnp.sum(fn(xx, pp) ** 2)

    g_ref = jax.grad(lambda pp, xx: jax_loss(
        lambda a, q: JF.stacked_conv1d(a, q, dilation=3), pp, xx), argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))

    def port_grads(fn):
        tree = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in p.items()}
        xt = torch.from_numpy(x.copy()).requires_grad_()
        (fn(xt.transpose(1, 2), PC.conv_params(tree)) ** 2).sum().backward()
        return {k: v.grad.numpy() for k, v in tree.items()}, xt.grad.numpy()

    g_fast = port_grads(lambda a, q: PF.stacked_conv1d(a, q, dilation=3))
    g_conv = port_grads(lambda a, q: PC.conv1d(a, q, dilation=3, padding="causal"))
    for key in ("v", "g", "b"):
        np.testing.assert_allclose(g_fast[0][key], np.asarray(g_ref[0][key]), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g_fast[0][key], g_conv[0][key], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g_fast[1], np.asarray(g_ref[1]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g_fast[1], g_conv[1], rtol=1e-4, atol=1e-4)


def test_stacked_backend_serves_as_reference():
    """A float32 tiny_test model with conv_backend "stacked" encodes and
    decodes as the "reference" one (latents within rtol 1e-4 / atol 1e-5,
    the codec tests' float32 bar; equal indices)."""
    from nsc_tpu_torch import api as PA

    ref = PA.load_model("tiny_test", device="cpu")
    cfg = dataclasses.replace(ref.cfg, conv_backend="stacked")
    stk = PA.ModelBundle(PA.NeuralSpeechCodec(cfg), ref.params, ref.rvq)
    wav = (np.random.RandomState(0).randn(2, 64 * cfg.hop) * 0.3).astype(np.float32)
    with torch.inference_mode():
        za = ref.model.latents(ref.params, torch.from_numpy(wav))
        zb = stk.model.latents(stk.params, torch.from_numpy(wav))
    np.testing.assert_allclose(zb.numpy(), za.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(PA.encode(stk, wav), PA.encode(ref, wav))
    idx = PA.encode(ref, wav)
    np.testing.assert_allclose(PA.decode(stk, idx), PA.decode(ref, idx), rtol=1e-3, atol=1e-4)
