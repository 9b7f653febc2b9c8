"""weights.from_jax_params on every named config, and on the committed
flagship artifact.

Every config: the parameter tree has nsc_tpu's init_codec structure (taken
with jax.eval_shape, so no weights are computed), filled with numpy values
from a seed. Each converted conv must equal nsc_tpu's materialize_weight of
the same (v, g) in the port's layout (float32 weight-norm, eps 1e-12:
rtol 1e-6 for the norm's summation order), and the residual-unit packs must
exist exactly where the kernel applies.

Flagship: the base_fast refit checkpoint restored with nsc_tpu on CPU JAX,
converted, and encoded by both packages in float32 on 8 rows x 1 s of the
canonical speech probe. Indices must agree, except where nsc_tpu's own
argmin margin is below 1e-3: the two float32 encoders agree to ~1e-6
relative on the latents, which moves a score (~1e1..1e2) by ~1e-4 at most,
so a flip above that margin is a fault, not rounding.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsc_tpu.configs import get_config, list_configs
from nsc_tpu.models.codec import NeuralSpeechCodec, init_codec
from nsc_tpu.ops import conv as JC
from nsc_tpu.ops import rvq as JR
from nsc_tpu_torch import configs as PCFG
from nsc_tpu_torch import weights as W
from nsc_tpu_torch.models import seanet as PS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "artifacts", "base_fast_synthetic2_48k_refit")


def _tree(cfg, seed):
    shapes = jax.eval_shape(lambda k: init_codec(k, cfg)[1:], jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda s: (rng.uniform(0.5, 1.5, s.shape)).astype(s.dtype), shapes
    )


def _convs(jtree, ptree, path=""):
    """Yield (path, jax conv dict, port conv dict) for every conv."""
    if isinstance(jtree, dict) and "b" in jtree and ("v" in jtree or "w" in jtree):
        yield path, jtree, ptree
    elif isinstance(jtree, dict) and isinstance(ptree, dict):
        for k, v in jtree.items():
            if k in ptree:
                yield from _convs(v, ptree[k], f"{path}/{k}")
    elif isinstance(jtree, list):
        for i, (a, b) in enumerate(zip(jtree, ptree)):
            yield from _convs(a, b, f"{path}/{i}")


def test_port_configs_equal_jax_configs():
    assert PCFG.list_configs() == list_configs()
    for name in list_configs():
        j, p = get_config(name), PCFG.get_config(name)
        for field in j.__dataclass_fields__:
            assert getattr(j, field) == getattr(p, field), (name, field)


@pytest.mark.parametrize("name", list_configs())
def test_from_jax_params_every_config(name):
    cfg = PCFG.get_config(name)
    params, rvq = _tree(get_config(name), seed=len(name))
    # the K1 route, so each stage carries its packed units where K1 runs them
    pp, pq = W.from_jax_params(params, rvq, dataclasses.replace(cfg, unit_backend="auto"))
    n = 0
    for path, jc, pc in _convs(params, pp):
        want = np.asarray(JC.materialize_weight({k: jnp.asarray(v) for k, v in jc.items()}))
        if path.endswith("/up"):
            want = want.transpose(1, 2, 0)  # (Cin, Cout, K)
        else:
            want = want.transpose(2, 1, 0)  # (Cout, Cin, K)
        np.testing.assert_allclose(pc["w"].numpy(), want, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(pc["b"].numpy(), jc["b"])
        n += 1
    n_stages = len(cfg.strides)
    assert n == 2 * (2 + n_stages * (1 + 2 * len(cfg.dilations)))
    np.testing.assert_array_equal(pq["codebooks"].numpy(), rvq["codebooks"])
    assert ("proj_in" in pp) == (cfg.codebook_dim != cfg.latent_dim)
    dtype = torch.float32
    for stage, jstage in zip(pp["encoder"]["stages"] + pp["decoder"]["stages"],
                             params["encoder"]["stages"] + params["decoder"]["stages"]):
        assert ("stack" in stage) == PS.stack_supported(cfg, "causal" if cfg.causal else "same")
        np.testing.assert_array_equal(stage["units"][0]["act1"].numpy(), jstage["units"][0]["act1"]["alpha"])
        if "stack" in stage:
            c = stage["units"][0]["conv1"]["w"].shape[0]
            u = len(cfg.dilations)
            assert stage["stack"]["w1"].shape == (u, 3, c, c)
            assert stage["stack"]["w1"].dtype == dtype
            np.testing.assert_array_equal(
                stage["stack"]["w1"][0].numpy(),
                stage["units"][0]["conv1"]["w"].permute(2, 1, 0).numpy(),
            )


def test_flagship_artifact_indices():
    from nsc_tpu import canonical
    from nsc_tpu.train.checkpoint import restore_inference

    cfg = get_config("base_fast")
    shapes = jax.eval_shape(lambda k: init_codec(k, cfg)[1:], jax.random.PRNGKey(0))
    tmpl = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params, rvq = restore_inference(FLAGSHIP, *tmpl)
    wav = canonical.speech_probe_input(cfg, 8)[:, : cfg.sample_rate]
    model = NeuralSpeechCodec(cfg)
    lat = jax.jit(model.latents)(params, jnp.asarray(wav))
    idx_j = np.asarray(jax.jit(JR.quantize)(rvq, lat))
    margins = np.asarray(jax.jit(JR.argmin_margins)(rvq, lat))

    from nsc_tpu_torch import api as PA

    pb = PA.bundle_from_jax(
        PCFG.get_config("base_fast"), jax.tree.map(np.asarray, params),
        jax.tree.map(np.asarray, rvq), device="cpu",
    )
    with torch.inference_mode():
        idx_p = pb.model.encode(pb.params, pb.rvq, torch.from_numpy(wav)).numpy()
    assert idx_p.shape == idx_j.shape == (8, 50, 16)
    diff = idx_p != idx_j
    frames = np.nonzero(diff.any(-1))
    first = diff[frames].argmax(-1)  # later books follow the first flip
    first_margins = margins[frames][np.arange(first.size), first]
    assert (first_margins < 1e-3).all(), first_margins
