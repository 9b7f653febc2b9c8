"""The port's float32 `base` and `base_fast` (the trained activation,
snake_fast, in float32) against nsc_tpu at a short length on the CPU.

Both configs share one architecture, so one nsc_tpu init (seed 0, jitted,
cached for the module) gives both their weights. On 2 x 0.5 s of the
synthetic source:

  * indices: equal, or different only at frames whose nsc_tpu argmin margin
    (`nsc_tpu.ops.rvq.argmin_margins`, second-best minus best score) is
    below 1e-3 at the first book that differs, the rule the port's index
    checks use on trained books;
  * waveforms (`decode` of nsc_tpu's indices on both sides): rtol 1e-3,
    atol 1e-4, the tolerance of `tests/parity/test_torch_parity.py`.

A failure names the first layer where the port leaves nsc_tpu
(`tests/torch_layer_parity.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nsc_tpu import api as japi
from nsc_tpu.configs import get_config as jget_config
from nsc_tpu.models.codec import NeuralSpeechCodec, init_codec
from nsc_tpu.ops import rvq as JR
from nsc_tpu_torch import api
from nsc_tpu_torch import weights as W
from nsc_tpu_torch.configs import get_config
from nsc_tpu_torch.train.data import SyntheticSource
from torch_layer_parity import describe, first_divergence
from torch_threads import one_torch_thread  # noqa: F401

NAMES = ("base", "base_fast")
MARGIN = 1e-3


@pytest.fixture(scope="module")
def weights():
    cfg = jget_config("base")
    params, rvq = jax.jit(lambda k: init_codec(k, cfg)[1:])(jax.random.PRNGKey(0))
    return W.tree_map(np.asarray, params), W.tree_map(np.asarray, rvq)


@pytest.fixture(scope="module")
def wav():
    return next(SyntheticSource(16000, 0).batches(2, 8000))


@pytest.fixture(scope="module", params=NAMES)
def pair(request, weights, wav):
    name = request.param
    jcfg = jget_config(name)
    jb = japi.ModelBundle(NeuralSpeechCodec(jcfg), *W.tree_map(jnp.asarray, weights))
    pb = api.bundle_from_jax(get_config(name), *weights, device="cpu")
    jidx = np.asarray(japi.encode(jb, wav))
    z = jax.jit(jb.model.latents)(jb.params, jnp.asarray(wav))
    margins = np.asarray(JR.argmin_margins(jb.rvq, z))[:, : jidx.shape[1]]
    return name, jb, pb, jidx, margins


def _where(jb, pb, wav):
    return describe(first_divergence(jb.params, jb.rvq, jb.cfg, pb, wav, rtol=1e-3, atol=1e-4))


def test_indices_by_the_margin_rule(pair, wav):
    name, jb, pb, jidx, margins = pair
    idx = api.encode(pb, wav)
    assert idx.shape == jidx.shape
    diff = idx != jidx
    frames = np.argwhere(diff.any(-1))
    bad = [(n, f) for n, f in frames
           if margins[n, f, np.argmax(diff[n, f])] >= MARGIN]
    if bad:
        pytest.fail(f"{name}: {len(bad)} frames differ where nsc_tpu's margin is >= {MARGIN} "
                    f"(e.g. {bad[:3]}); {_where(jb, pb, wav)}")
    assert diff.mean() < 0.01, f"{name}: {diff.mean():.4f} of indices differ"


def test_waveform_within_parity_tolerance(pair, wav):
    name, jb, pb, jidx, _ = pair
    want = np.asarray(japi.decode(jb, jidx))
    got = api.decode(pb, jidx)
    if not np.allclose(got, want, rtol=1e-3, atol=1e-4):
        pytest.fail(f"{name}: decode differs by {np.abs(got - want).max():.3g}; "
                    f"{_where(jb, pb, wav)}")
