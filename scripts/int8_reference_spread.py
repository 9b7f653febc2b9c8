#!/usr/bin/env python3
"""How reproducible nsc_tpu's int8 serving path is, and how the port's
float32 int8 path compares with it, on the trained flagship's canonical
probes, on the CPU.

    python scripts/int8_reference_spread.py [--rows 2] [--seconds 2]

Prints one JSON line per probe:

  * nsc_tpu's int8 model (the scales of reference_int8.npz) on the first
    `--seconds` of row 0, jitted against eager (`jax.disable_jit`): the
    frames whose indices differ and the latents' max relative difference.
    Each conv re-quantizes its input, so a float difference of one ulp
    that lands on a rounding boundary of the int8 grid moves a code by one
    step, and the step spreads through the later convs: the int8 path's
    indices are not stable under a change of float schedule, even within
    nsc_tpu.
  * the port's float32 int8 path (`nsc_tpu_torch`, the same scales) on the
    first `--rows` rows: frames differing from reference_int8.npz, and the
    index agreement of each int8 path with nsc_tpu's float32 reference
    (reference_f32.npz), over all books and over book 0.

Imports JAX and the JAX package; runs where JAX runs, not on the card.
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
EXPORT = os.path.join(ROOT, "exports", "base_fast_synthetic2_48k_refit")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--rows", type=int, default=2)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import torch

    from nsc_tpu import canonical
    from nsc_tpu.configs import get_config
    from nsc_tpu.models.codec import NeuralSpeechCodec
    from nsc_tpu.ops import quant as JQ
    from nsc_tpu.ops import rvq as JR
    from nsc_tpu_torch import api
    from nsc_tpu_torch.models.codec import NeuralSpeechCodec as PortCodec
    from nsc_tpu_torch.ops import quant as Q
    from nsc_tpu_torch.train import checkpoint as ckpt

    with np.load(os.path.join(EXPORT, "reference_int8.npz")) as z:
        ref = {k: z[k] for k in z.files}
    with np.load(os.path.join(EXPORT, "reference_f32.npz")) as z:
        ref_f32 = {k: z[k] for k in z.files}
    params, rvq = ckpt.restore_inference(EXPORT)
    scaled = jax.tree.map(lambda x: x, params)
    n_sites = 0
    for i, site in enumerate(JQ._conv_sites(scaled)):
        site["a_s"] = jnp.asarray(ref[f"a_s_{i}"])
        n_sites += 1
    cfg = dataclasses.replace(get_config("base_fast"), quant="int8")
    model = NeuralSpeechCodec(cfg)
    f32 = api.load_model("base_fast", checkpoint=EXPORT, device="cpu")
    port = api.ModelBundle(
        PortCodec(dataclasses.replace(f32.cfg, quant="int8")),
        Q.with_scales(f32.params, [torch.from_numpy(ref[f"a_s_{i}"]) for i in range(n_sites)]),
        f32.rvq)
    quantize = jax.jit(JR.quantize)
    for name, probe in (("noise", canonical.probe_input), ("speech", canonical.speech_probe_input)):
        x = probe(cfg)
        head = jnp.asarray(x[:1, : int(args.seconds * cfg.sample_rate)])
        z_jit = jax.jit(model.latents)(scaled, head)
        with jax.disable_jit():
            z_eager = model.latents(scaled, head)
        i_jit, i_eager = np.asarray(quantize(rvq, z_jit)), np.asarray(quantize(rvq, z_eager))
        idx = api.encode(port, x[: args.rows])
        r8, rf = ref[f"indices_{name}"][: args.rows], ref_f32[f"indices_{name}"][: args.rows]
        print(json.dumps({
            "probe": name,
            "nsc_tpu_int8_jit_vs_eager": {
                "seconds": args.seconds,
                "frames_differing": int((i_jit != i_eager).any(-1).sum()),
                "frames": int(i_jit.shape[1]),
                "latent_max_rel_diff": float(jnp.abs(z_jit - z_eager).max() / jnp.abs(z_jit).max())},
            "port_float32_int8_vs_reference_int8": {
                "rows": args.rows, "frames_differing": int((idx != r8).any(-1).sum()),
                "frames": int(r8.shape[0] * r8.shape[1]),
                "entries_equal": float((idx == r8).mean()),
                "book0_equal": float((idx[..., 0] == r8[..., 0]).mean())},
            "agreement_with_nsc_tpu_float32": {
                "port_int8": float((idx == rf).mean()), "nsc_tpu_int8": float((r8 == rf).mean()),
                "port_int8_book0": float((idx[..., 0] == rf[..., 0]).mean()),
                "nsc_tpu_int8_book0": float((r8[..., 0] == rf[..., 0]).mean())},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
