"""The port's reference-layout checkpoint loader
(`nsc_tpu_torch/compat/torch_compat.py`) against the JAX package's.

A state dict of nsc_tpu's PyTorch twin (`TorchCodec`) converted by the port
must give the same parameters, bit for bit, as nsc_tpu's
`convert_torch_checkpoint` followed by `weights.from_jax_params`; the port's
indices from it must equal the twin's own bit for bit (float32 search on
random N(0, 1) books, as `tests/parity/test_torch_parity.py` holds the
JAX package to the twin); a file round trip loads the same weights; a
missing key names the key."""

import numpy as np
import pytest
import torch

from nsc_tpu.compat.torch_compat import convert_torch_checkpoint as jconvert
from nsc_tpu.compat.torch_model import TorchCodec
from nsc_tpu.configs import get_config as jget_config
from nsc_tpu_torch import api, weights
from nsc_tpu_torch.compat import torch_compat as TC
from nsc_tpu_torch.configs import get_config
from nsc_tpu_torch.train.train import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401

CONFIGS = ["tiny_test", "small", "small_factorized"]


def _twin(name):
    torch.manual_seed(0)
    return TorchCodec(jget_config(name)).eval()


def _wav(cfg, seed=1):
    return (np.random.RandomState(seed).randn(2, 16 * cfg.hop) * 0.3).astype(np.float32)


@pytest.mark.parametrize("name", CONFIGS)
def test_same_parameters_as_nsc_tpu_converter(name):
    cfg = get_config(name)
    sd = _twin(name).state_dict()
    got_p, got_q = TC.convert_torch_checkpoint(sd, cfg)
    jp, jq = jconvert(sd, jget_config(name))
    to_np = lambda t: np.asarray(t)  # noqa: E731
    ref_p, ref_q = weights.from_jax_params(weights.tree_map(to_np, jp),
                                           weights.tree_map(to_np, jq), cfg)
    la, lb = tree_leaves(got_p), tree_leaves(ref_p)
    assert len(la) == len(lb) > 0
    for a, b in zip(la, lb):
        assert torch.equal(a, b)
    assert torch.equal(got_q["codebooks"], ref_q["codebooks"])
    # the JAX-layout trees as the JAX package's converter makes them
    lp, lq = TC.to_jax_layout(sd, cfg)
    for a, b in zip(tree_leaves(weights.to_tensors(lp)), tree_leaves(weights.to_tensors(
            weights.tree_map(to_np, jp)))):
        assert torch.equal(a, b)
    for k in ("codebooks", "ema_count", "ema_sum"):
        np.testing.assert_array_equal(lq[k], np.asarray(jq[k]))


@pytest.mark.parametrize("name", CONFIGS)
def test_indices_equal_the_twins(name):
    cfg = get_config(name)
    tm = _twin(name)
    bundle = api.bundle_from_jax(cfg, *TC.to_jax_layout(tm.state_dict(), cfg), device="cpu")
    wav = _wav(cfg)
    with torch.no_grad():
        want = tm.encode(torch.from_numpy(wav)).numpy()
        want1 = tm.encode(torch.from_numpy(wav), n_q=1).numpy()
    np.testing.assert_array_equal(api.encode(bundle, wav), want)
    np.testing.assert_array_equal(api.encode(bundle, wav, n_q=1), want1)


def test_file_round_trip(tmp_path):
    cfg = get_config("tiny_test")
    tm = _twin("tiny_test")
    path = str(tmp_path / "twin.pt")
    torch.save(tm.state_dict(), path)
    wrapped = str(tmp_path / "wrapped.pt")
    torch.save({"state_dict": tm.state_dict()}, wrapped)
    ref_p, ref_q = TC.convert_torch_checkpoint(tm.state_dict(), cfg)
    for p in (path, wrapped):
        got_p, got_q = TC.load_torch_checkpoint_file(p, cfg)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got_p), tree_leaves(ref_p)))
        assert torch.equal(got_q["codebooks"], ref_q["codebooks"])


def test_missing_key_names_the_key():
    cfg = get_config("tiny_test")
    sd = dict(_twin("tiny_test").state_dict())
    sd.pop("encoder.stem.v")
    with pytest.raises(TC.ConversionError, match="encoder.stem"):
        TC.convert_torch_checkpoint(sd, cfg)


def test_key_aliases_hook(monkeypatch):
    cfg = get_config("tiny_test")
    sd = dict(_twin("tiny_test").state_dict())
    sd["legacy.codebooks"] = sd.pop("rvq.codebooks")
    monkeypatch.setitem(TC._TORCH_KEY_ALIASES, "rvq.codebooks", "legacy.codebooks")
    _, q = TC.convert_torch_checkpoint(sd, cfg)
    assert torch.equal(q["codebooks"], sd["legacy.codebooks"].float())
