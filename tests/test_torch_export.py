"""The flagship's export for the port (`scripts/export_torch_checkpoint.py`)
and the port's loader of it (`nsc_tpu_torch.train.checkpoint.
restore_inference`, `api.load_model(checkpoint=...)`).

Tolerances: none. A fresh export of the orbax store equals the committed
`weights.npz` leaf for leaf, bit for bit; the port's bundle loaded from the
export equals `bundle_from_jax` of nsc_tpu's own restore, tensor for
tensor, bit for bit. `reference_f32.npz` is checked by re-encoding the
first second of two rows of each probe with nsc_tpu on CPU JAX: the
encoder is causal, so frames 0-49 of the 10 s reference are those indices
exactly.
"""

import fnmatch
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsc_tpu import api as JA
from nsc_tpu import canonical as JCAN
from nsc_tpu.configs import get_config
from nsc_tpu.models.codec import NeuralSpeechCodec
from nsc_tpu.ops import rvq as JR
from nsc_tpu_torch import api as PA
from nsc_tpu_torch import weights as W
from nsc_tpu_torch.train import checkpoint as PCK
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import export_torch_checkpoint as E  # noqa: E402

FLAGSHIP = os.path.join(ROOT, "artifacts", "base_fast_synthetic2_48k_refit")
EXPORT = os.path.join(ROOT, "exports", "base_fast_synthetic2_48k_refit")


@pytest.fixture(scope="module")
def restored():
    """nsc_tpu's restore of the flagship's orbax store: (params, rvq, step)
    as numpy trees."""
    return E.restore(FLAGSHIP, "base_fast")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_fresh_export_equals_committed_weights(restored, tmp_path):
    params, rvq, step = restored
    meta = E.export_weights("base_fast", params, rvq, str(tmp_path), step=step)
    with np.load(tmp_path / E.WEIGHTS) as fresh, np.load(os.path.join(EXPORT, E.WEIGHTS)) as kept:
        assert sorted(fresh.files) == sorted(kept.files)
        for k in fresh.files:
            assert fresh[k].dtype == kept[k].dtype == np.float32, k
            np.testing.assert_array_equal(fresh[k], kept[k], err_msg=k)
    with open(os.path.join(EXPORT, E.META)) as f:
        committed = json.load(f)
    assert committed["config"] == "base_fast" and committed["step"] == step == 48000
    assert committed["fingerprint"] == meta["fingerprint"] == JA.codebook_fingerprint(rvq)
    assert committed["values"] == meta["values"] == 7_503_234 + 2_097_152
    assert committed["weights_sha256"] == E.sha256(os.path.join(EXPORT, E.WEIGHTS))


def test_restore_inference_returns_the_jax_trees(restored):
    params, rvq = PCK.restore_inference(EXPORT)
    jparams, jrvq, _ = restored
    got = dict(_leaves({"params": params, "rvq": rvq}))
    want = dict(_leaves({"params": jparams, "rvq": {"codebooks": jrvq["codebooks"]}}))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v, np.float32), err_msg=k)


@pytest.mark.parametrize("serving", [False, True])
def test_load_model_equals_bundle_from_jax(restored, serving):
    params, rvq, _ = restored
    cfg = PA.get_config("base_fast")
    cfg = PA.serving_config(cfg) if serving else cfg
    want = PA.bundle_from_jax(cfg, params, rvq, device="cpu")
    got = PA.load_model("base_fast", checkpoint=EXPORT, serving=serving, device="cpu")
    assert got.cfg == want.cfg
    a = dict(_leaves({"params": got.params, "rvq": got.rvq}))
    b = dict(_leaves({"params": want.params, "rvq": want.rvq}))
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_orbax_directory_and_wrong_config_raise(tmp_path):
    with pytest.raises(ValueError, match="export_torch_checkpoint.py"):
        PA.load_model("base_fast", checkpoint=FLAGSHIP, device="cpu")
    with pytest.raises(ValueError, match="holds a 'base_fast' model, not 'base'"):
        PA.load_model("base", checkpoint=EXPORT, device="cpu")
    with pytest.raises(FileNotFoundError):
        PA.load_model("base_fast", checkpoint=str(tmp_path), device="cpu")


def test_restore_inference_refuses_altered_exports(tmp_path):
    """A weights file that does not match meta.json's sha256, or whose
    leaves are not the config's tree, is refused."""
    params, rvq = W.init_jax_layout(PA.get_config("tiny_test"), 0)
    E.export_weights("tiny_test", params, rvq, str(tmp_path))
    PCK.restore_inference(str(tmp_path))
    with open(tmp_path / E.WEIGHTS, "r+b") as f:
        f.seek(-1, 2)
        last = f.read(1)
        f.seek(-1, 2)
        f.write(bytes([last[0] ^ 1]))
    with pytest.raises(ValueError, match="sha256"):
        PCK.restore_inference(str(tmp_path))
    del params["encoder"]["stem"]["b"]
    E.export_weights("tiny_test", params, rvq, str(tmp_path))
    with pytest.raises(ValueError, match="no leaf 'params/encoder/stem/b'"):
        PCK.restore_inference(str(tmp_path))


def test_reference_f32_prefix_reencodes(restored):
    params, rvq, _ = restored
    cfg = get_config("base_fast")
    model = NeuralSpeechCodec(cfg)
    with np.load(os.path.join(EXPORT, E.REFERENCE), allow_pickle=False) as z:
        ref = {k: z[k] for k in z.files}
    assert int(ref["fingerprint"]) == JA.codebook_fingerprint(rvq)
    for name, probe in (("noise", JCAN.probe_input), ("speech", JCAN.speech_probe_input)):
        assert ref[f"indices_{name}"].shape == ref[f"margins_{name}"].shape == (8, 500, 16)
        wav = probe(cfg)[:2, : cfg.sample_rate]
        lat = jax.jit(model.latents)(params, jnp.asarray(wav))
        np.testing.assert_array_equal(np.asarray(jax.jit(JR.quantize)(rvq, lat)),
                                      ref[f"indices_{name}"][:2, :50])
        np.testing.assert_array_equal(np.asarray(jax.jit(JR.argmin_margins)(rvq, lat)),
                                      ref[f"margins_{name}"][:2, :50])


def test_reference_int8_prefix_reencodes(restored):
    """reference_int8.npz: nsc_tpu's int8 model with the stored scales (in
    the conv sites' call order) re-encodes the first second of two rows of
    each probe to the stored indices and margins."""
    import dataclasses

    from nsc_tpu.ops import quant as JQ

    params, rvq, _ = restored
    cfg = dataclasses.replace(get_config("base_fast"), quant="int8")
    model = NeuralSpeechCodec(cfg)
    with np.load(os.path.join(EXPORT, E.REFERENCE_INT8), allow_pickle=False) as z:
        ref = {k: z[k] for k in z.files}
    assert int(ref["fingerprint"]) == JA.codebook_fingerprint(rvq)
    scaled = jax.tree.map(lambda x: x, params)
    sites = list(JQ._conv_sites(scaled))
    assert len(sites) == sum(k.startswith("a_s_") for k in ref) == 60
    for i, site in enumerate(sites):
        site["a_s"] = jnp.asarray(ref[f"a_s_{i}"])
    for name, probe in (("noise", JCAN.probe_input), ("speech", JCAN.speech_probe_input)):
        assert ref[f"indices_{name}"].shape == ref[f"margins_{name}"].shape == (8, 500, 16)
        wav = probe(cfg)[:2, : cfg.sample_rate]
        lat = jax.jit(model.latents)(scaled, jnp.asarray(wav))
        np.testing.assert_array_equal(np.asarray(jax.jit(JR.quantize)(rvq, lat)),
                                      ref[f"indices_{name}"][:2, :50])


def test_export_files_reach_every_checkout():
    """The export sits outside artifacts/ and no ignore file at the repo's
    root (.gitignore and the copy tool's own) drops it."""
    names = ("weights.npz", "meta.json", "reference_f32.npz", "reference_int8.npz",
             "canonical_idx_gpu.npz")
    rel = [os.path.join("exports", "base_fast_synthetic2_48k_refit", n) for n in names]
    for path in rel:
        assert os.path.exists(os.path.join(ROOT, path)), path
    ignores = [n for n in os.listdir(ROOT) if n.startswith(".") and n.endswith("ignore")]
    assert ".gitignore" in ignores
    for ignore in ignores:
        with open(os.path.join(ROOT, ignore)) as f:
            patterns = [ln.strip().rstrip("/") for ln in f if ln.strip() and not ln.startswith("#")]
        for path in rel:
            parts = path.split(os.sep)
            prefixes = [os.path.join(*parts[: i + 1]) for i in range(len(parts))]
            hits = [p for p in patterns for pre in prefixes + parts
                    if fnmatch.fnmatch(pre, p)]
            assert not hits, (ignore, path, hits)


def test_export_script_writes_every_file(tmp_path):
    """The exporter end to end on a small orbax store: tiny_test weights
    saved with nsc_tpu's own `save_inference`, exported and loaded by the
    port."""
    from nsc_tpu.models.codec import init_codec
    from nsc_tpu.train import checkpoint as JCK

    cfg = get_config("tiny_test")
    params, rvq = jax.jit(lambda k: init_codec(k, cfg)[1:])(jax.random.PRNGKey(3))
    JCK.save_inference(str(tmp_path / "ckpt"), 7, params, rvq)
    out = tmp_path / "export"
    assert E.main([str(tmp_path / "ckpt"), "--config", "tiny_test", "--out", str(out)]) == 0
    meta = PCK.export_meta(str(out))
    assert meta["step"] == 7 and meta["config"] == "tiny_test"
    with np.load(out / E.REFERENCE) as z:
        assert z["indices_noise"].shape == (8, 40000, 2)
        assert z["margins_speech"].dtype == np.float32
    with np.load(out / E.REFERENCE_INT8) as z:
        assert z["indices_speech"].shape == (8, 40000, 2)
        assert sorted(k for k in z.files if k.startswith("a_s_")) == sorted(
            f"a_s_{i}" for i in range(24))
        assert z["a_s_0"].shape == () and z["a_s_0"] > 0
    b = PA.load_model("tiny_test", checkpoint=str(out), device="cpu")
    assert PA.codebook_fingerprint(b.rvq) == JA.codebook_fingerprint(rvq)
