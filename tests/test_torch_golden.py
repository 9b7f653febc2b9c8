"""The port against nsc_tpu's pinned golden files, and the layer-by-layer
parity helper (`tests/torch_layer_parity.py`) itself.

For `tiny_test` and `small`, the port's float32 bundle is built from
`nsc_tpu.api.load_model(name, seed=0)`'s parameters, as
`tests/unit/test_golden.py` builds nsc_tpu's. `encode` of the golden
waveform must give the pinned indices exactly, and `decode` of the pinned
indices the pinned waveform within the golden test's own tolerance (rtol
1e-5, atol 1e-6). The golden files are read, never written. A failure names
the first layer at which the port leaves nsc_tpu.

The helper must find nothing on the unperturbed port and name the stage
whose weight is moved by 1e-2.
"""

import os

import numpy as np
import pytest

from nsc_tpu import api as japi
from nsc_tpu_torch import api
from nsc_tpu_torch import weights as W
from nsc_tpu_torch.configs import get_config
from torch_layer_parity import describe, first_divergence
from torch_threads import one_torch_thread  # noqa: F401

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
NAMES = ("tiny_test", "small")


@pytest.fixture(scope="module")
def models():
    """name -> (nsc_tpu's bundle, the port's float32 CPU bundle of its weights)."""
    out = {}
    for name in NAMES:
        jb = japi.load_model(name, seed=0)
        out[name] = (jb, api.bundle_from_jax(get_config(name), W.tree_map(np.asarray, jb.params),
                                             W.tree_map(np.asarray, jb.rvq), device="cpu"))
    return out


def _golden(name):
    with np.load(os.path.join(GOLDEN_DIR, f"{name}.npz")) as g:
        return {k: g[k] for k in g.files}


def _where(models, name, wav):
    jb, pb = models[name]
    wav = np.asarray(wav, np.float32).reshape(-1, np.shape(wav)[-1])
    wav = wav[:, : wav.shape[-1] // jb.cfg.hop * jb.cfg.hop]
    return describe(first_divergence(jb.params, jb.rvq, jb.cfg, pb, wav))


@pytest.mark.parametrize("name", NAMES)
def test_golden_indices_exact(models, name):
    g = _golden(name)
    idx = api.encode(models[name][1], g["wav"])
    if not np.array_equal(idx, g["indices"]):
        pytest.fail(f"{name}: {int((idx != g['indices']).sum())} of {idx.size} indices differ "
                    f"from the golden file; {_where(models, name, g['wav'])}")


@pytest.mark.parametrize("name", NAMES)
def test_golden_waveform_tolerance(models, name):
    g = _golden(name)
    recon = api.decode(models[name][1], g["indices"])
    if not np.allclose(recon, g["recon"], rtol=1e-5, atol=1e-6):
        pytest.fail(f"{name}: decode leaves the golden waveform by "
                    f"{np.abs(recon - g['recon']).max():.3g}; {_where(models, name, g['wav'])}")


def test_layer_helper_finds_nothing_on_the_port(models):
    jb, pb = models["tiny_test"]
    wav = _golden("tiny_test")["wav"][None]
    assert first_divergence(jb.params, jb.rvq, jb.cfg, pb, wav) is None


@pytest.mark.parametrize("part,stage", [("encoder", 0), ("encoder", 1), ("decoder", 1)])
def test_layer_helper_names_a_perturbed_stage(models, part, stage):
    jb, _ = models["tiny_test"]
    pb = api.bundle_from_jax(get_config("tiny_test"), W.tree_map(np.asarray, jb.params),
                             W.tree_map(np.asarray, jb.rvq), device="cpu")
    pb.params[part]["stages"][stage]["units"][0]["conv1"]["w"][0, 0, 0] += 1e-2
    wav = _golden("tiny_test")["wav"][None]
    got = first_divergence(jb.params, jb.rvq, jb.cfg, pb, wav)
    assert got is not None and got[0] == f"{part}.stage{stage}.units", describe(got)
