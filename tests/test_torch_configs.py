"""Every registered configuration in the port, on the CPU.

* `base_noncausal` and `base_fast_f`, the two registered configurations no
  other CPU parity test holds at their own config, against nsc_tpu with
  seed-0 weights (one jitted `init_codec` per config, cached for the
  module) on 2 x 0.5 s of the synthetic source: indices equal or different
  only where nsc_tpu's argmin margin at the first differing book is below
  1e-3 (`tests/test_torch_base_parity.py`'s rule); waveforms (`decode` of
  nsc_tpu's indices on both sides) within rtol 1e-3, atol 1e-4.
* The committed trained `small` export (`exports/small_synthetic_30k`):
  `restore_inference` checks its sha256, its codebooks' fingerprint is the
  one in meta.json, and the first 2 rows x 1 s of each probe re-encode on
  the CPU bit-equal to the first 50 frames of `reference_f32.npz` (nsc_tpu's
  float32 indices of the 8 x 10 s probes; the encoder is causal).
* The serving route of every registered configuration (the stage kernel K1
  for the causal ones, op by op for `base_noncausal`) and
  `chip_smoke.serving_expect`, the launch counts the card's `configs` phase
  holds each serving `reconstruct` to.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from nsc_tpu import api as japi
from nsc_tpu.configs import get_config as jget_config
from nsc_tpu.models.codec import NeuralSpeechCodec, init_codec
from nsc_tpu.ops import rvq as JR
from nsc_tpu_torch import api, canonical, kernels
from nsc_tpu_torch import weights as W
from nsc_tpu_torch.configs import get_config, list_configs
from nsc_tpu_torch.models import seanet
from nsc_tpu_torch.train import checkpoint as ckpt
from nsc_tpu_torch.train.data import SyntheticSource
from torch_layer_parity import describe, first_divergence
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_EXPORT = os.path.join(ROOT, "exports", "small_synthetic_30k")
PARITY = ("base_noncausal", "base_fast_f")
MARGIN = 1e-3


@pytest.fixture(scope="module")
def wav():
    return next(SyntheticSource(16000, 0).batches(2, 8000))


@pytest.fixture(scope="module", params=PARITY)
def pair(request, wav):
    """(name, nsc_tpu bundle, port bundle, nsc_tpu indices, nsc_tpu margins)
    on the same seed-0 weights of nsc_tpu's init."""
    name = request.param
    jcfg = jget_config(name)
    params, rvq = jax.jit(lambda k: init_codec(k, jcfg)[1:])(jax.random.PRNGKey(0))
    trees = W.tree_map(np.asarray, params), W.tree_map(np.asarray, rvq)
    jb = japi.ModelBundle(NeuralSpeechCodec(jcfg), *W.tree_map(jnp.asarray, trees))
    pb = api.bundle_from_jax(get_config(name), *trees, device="cpu")
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
    bad = [(n, f) for n, f in frames if margins[n, f, np.argmax(diff[n, f])] >= MARGIN]
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


def test_factorized_codes_live_in_the_projected_space(pair, wav):
    """The RVQ searches the codebook space: base_fast_f's latents are
    32-dim projections, base_noncausal's the 128-dim latents, on both
    sides."""
    name, jb, pb, _, _ = pair
    cfg = get_config(name)
    import torch

    z = pb.model.latents(pb.params, torch.from_numpy(wav))
    assert z.shape[-1] == cfg.codebook_dim == jb.rvq["codebooks"].shape[-1]
    assert pb.model.factorized == (cfg.codebook_dim != cfg.latent_dim) == ("proj_in" in jb.params)


def test_noncausal_streaming_is_refused(pair, wav):
    """As nsc_tpu's streaming does, the port's refuses a non-causal config
    (and streams a causal one)."""
    name, jb, pb, _, _ = pair
    if get_config(name).causal:
        blob = api.streaming_compress(pb, wav[0], chunk_seconds=0.2)
        assert blob
    else:
        with pytest.raises(ValueError, match="causal"):
            api.streaming_compress(pb, wav[0], chunk_seconds=0.2)


def test_small_export_restores_with_its_sha256(tmp_path):
    meta = ckpt.export_meta(SMALL_EXPORT)
    assert meta["config"] == "small"
    params, rvq = ckpt.restore_inference(SMALL_EXPORT)
    bundle = api.bundle_from_jax(get_config("small"), params, rvq, device="cpu")
    assert api.codebook_fingerprint(bundle.rvq) == meta["fingerprint"]
    # one changed byte of the npz: the loader refuses it
    bad = tmp_path / "small"
    shutil.copytree(SMALL_EXPORT, bad)
    npz = bad / "weights.npz"
    data = bytearray(npz.read_bytes())
    data[len(data) // 2] ^= 0xFF
    npz.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="sha256"):
        ckpt.restore_inference(str(bad))


@pytest.mark.parametrize("probe", ("noise", "speech"))
def test_small_export_reencodes_its_reference_prefix(probe):
    """The first 2 rows x 1 s of the probe through the port's CPU float32
    path: the first 50 frames of nsc_tpu's 10 s reference, bit-equal."""
    bundle = api.load_model("small", checkpoint=SMALL_EXPORT, device="cpu")
    cfg = bundle.cfg
    x = (canonical.probe_input if probe == "noise" else canonical.speech_probe_input)(cfg, 2)
    x = x[:, : cfg.sample_rate]
    with np.load(os.path.join(SMALL_EXPORT, "reference_f32.npz"), allow_pickle=False) as z:
        ref = z[f"indices_{probe}"][:2, : cfg.sample_rate // cfg.hop]
        assert int(z["fingerprint"]) == ckpt.export_meta(SMALL_EXPORT)["fingerprint"]
    np.testing.assert_array_equal(api.encode(bundle, x), ref)


@pytest.mark.parametrize("name", list_configs())
def test_serving_route_of_every_registered_config(name):
    cfg = get_config(name)
    serving = api.serving_config(cfg)
    want = "residual_stack" if cfg.causal else "reference"
    assert seanet.unit_route(serving) == want
    assert serving.compute_dtype == "bfloat16" and serving.rvq_backend == "pallas"
    assert serving.activation == "snake_fast"


def test_base_serves_what_base_fast_serves():
    """`serving_config` turns base's snake into snake_fast: its serving
    config is base_fast's but for the name, so both compute the same."""
    base = api.serving_config(get_config("base"))
    fast = api.serving_config(get_config("base_fast"))
    assert dataclasses.replace(base, name="base_fast") == fast


@pytest.mark.parametrize("name", list_configs())
def test_serving_expect(name):
    """K1 once per stage of the encoder and the decoder for the causal
    configs (8 for the registered four-stage ones), none for base_noncausal;
    K2, its split and K3 once; every other counter 0."""
    cfg = get_config(name)
    expect = chip_smoke.serving_expect(name)
    assert set(expect) == set(kernels.LAUNCHES)
    stages = 2 * len(cfg.strides)
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    want.update({"rvq_quantize": 1, "rvq_split_planes": 1, "rvq_dequantize": 1,
                 "residual_stack": stages if cfg.causal else 0})
    assert expect == want
    if name in chip_smoke.CONFIGS and name != "base_noncausal":
        assert expect["residual_stack"] == 8
