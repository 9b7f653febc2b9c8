"""The port's conv and activation ops (nsc_tpu_torch.ops.conv) against the
JAX package's (nsc_tpu.ops.conv) on the same numpy inputs.

Layouts: JAX (N, T, C) with (K, Cin, Cout) weights; the port (N, C, T) with
torch weight layouts, converted by nsc_tpu_torch.weights.

Tolerances: float32 convs differ only in summation order (XLA vs oneDNN),
~1e-7 relative per output, so rtol 1e-5 / atol 1e-6. bfloat16 convs round
the float32 sum to bf16 in both frameworks, and a sum that differs in its
last float32 bits can round to the neighbouring bf16 value: atol is two
bf16 ulps at the output's largest magnitude (2^-6 * max|ref|). The
activations are elementwise: float32 polynomial snake_fast is bit-exact;
exact-sine snake differs by the two libraries' sin (atol 1e-6); bfloat16
allows one ulp of the value (2^-7 * max|ref|), because XLA may keep an
intermediate at float32 where the source casts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsc_tpu.ops import conv as JC
from nsc_tpu_torch import weights as W
from nsc_tpu_torch.ops import conv as PC

_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _conv_params(seed, k, cin, cout):
    rng = np.random.RandomState(seed)
    v = rng.uniform(-1, 1, (k, cin, cout)).astype(np.float32) / np.sqrt(cin * k)
    return {
        "v": v,
        "g": (np.sqrt((v * v).sum((0, 1))) * rng.uniform(0.5, 1.5, cout)).astype(np.float32),
        "b": rng.uniform(-0.3, 0.3, cout).astype(np.float32),
    }


def _x(seed, n, t, c):
    return (np.random.RandomState(seed).randn(n, t, c) * 0.7).astype(np.float32)


def _run_both(jfn, pfn, x_ntc, dtype):
    jdt, tdt = _DT[dtype]
    ref = np.asarray(jfn(jnp.asarray(x_ntc).astype(jdt)).astype(jnp.float32))
    got = pfn(torch.from_numpy(x_ntc).transpose(1, 2).contiguous().to(tdt))
    return ref, got.float().transpose(1, 2).numpy()


def _assert_close(got, ref, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=2**-6 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "padding,stride,dilation,k",
    [("causal", 1, 1, 7), ("causal", 1, 3, 3), ("causal", 4, 1, 8),
     ("same", 1, 9, 3), ("same", 5, 1, 10), ("valid", 2, 1, 3)],
)
def test_conv1d_matches_jax(dtype, padding, stride, dilation, k):
    p = _conv_params(1, k, 6, 10)
    x = _x(2, 2, 203, 6)
    pp = W.conv_from_jax(p)
    ref, got = _run_both(
        lambda a: JC.conv1d(a, {kk: jnp.asarray(v) for kk, v in p.items()},
                            stride=stride, dilation=dilation, padding=padding),
        lambda a: PC.conv1d(a, pp, stride=stride, dilation=dilation, padding=padding),
        x, dtype,
    )
    assert got.shape == ref.shape
    _assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("stride,k", [(2, 4), (5, 10), (3, 3)])
def test_conv_transpose1d_matches_jax(dtype, causal, stride, k):
    p = _conv_params(3, k, 8, 5)
    x = _x(4, 2, 57, 8)
    pp = W.conv_transpose_from_jax(p)
    ref, got = _run_both(
        lambda a: JC.conv_transpose1d(a, {kk: jnp.asarray(v) for kk, v in p.items()},
                                      stride=stride, causal=causal),
        lambda a: PC.conv_transpose1d(a, pp, stride=stride, causal=causal),
        x, dtype,
    )
    assert got.shape == ref.shape == (2, 57 * stride, 5)
    _assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["snake", "snake_fast", "elu"])
def test_activations_match_jax(dtype, name):
    c = 12
    x = _x(5, 2, 300, c) * 6  # several periods of the sine
    alpha = np.random.RandomState(6).uniform(0.5, 2.0, c).astype(np.float32)
    jp = None if name == "elu" else {"alpha": jnp.asarray(alpha)}
    pa = None if name == "elu" else torch.from_numpy(alpha)
    ref, got = _run_both(
        lambda a: JC.activation(name, a, jp),
        lambda a: PC.activation(name, a, pa),
        x, dtype,
    )
    if dtype == "float32":
        if name == "snake_fast":
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=2**-7 * np.abs(ref).max())


def test_materialize_weight_matches_jax():
    p = _conv_params(7, 3, 16, 24)
    ref = np.asarray(JC.materialize_weight({k: jnp.asarray(v) for k, v in p.items()}))
    got = PC.materialize_weight({k: torch.from_numpy(v) for k, v in p.items()}).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
