"""Export a trained nsc_tpu inference checkpoint for the PyTorch port.

    python scripts/export_torch_checkpoint.py [SRC] [--config base_fast] [--out DIR]
        [--int8-reference-only | --sweep-reference-only]

Restores SRC (an orbax checkpoint directory as `nsc_tpu.load_model` takes
it; default the refit flagship, artifacts/base_fast_synthetic2_48k_refit)
with `nsc_tpu.train.checkpoint.restore_inference` on CPU JAX and writes into
DIR (default exports/<name of SRC>):

  weights.npz        the generator tree and the RVQ codebooks as float32
                     arrays keyed by their tree path ("params/encoder/stem/v",
                     "rvq/codebooks"); the RVQ's EMA statistics are left out,
                     inference does not read them
  meta.json          config name, step, source directory, the codebook
                     fingerprint and the sha256 of weights.npz
  reference_f32.npz  nsc_tpu's CPU float32 indices and argmin margins on the
                     canonical noise and speech probes (8 x 10 s each), the
                     reference the port's float32 path is held to
  reference_int8.npz the same for nsc_tpu's int8 model (`quantize_model` of
                     the float32 bundle, default calibration), and its
                     per-site activation scales ("a_s_<i>", in the conv
                     sites' call order, `ops.quant._conv_sites`): the
                     reference of the port's float32 int8 path, run with
                     those scales
  reference_sweep.json  nsc_tpu's CPU float32 `bitrate_sweep` rows (every
                     depth) on the first SWEEP_ROWS clips of the speech
                     probe, the reference of the port's sweep on the card

--int8-reference-only writes reference_int8.npz alone into an existing
export, --sweep-reference-only reference_sweep.json alone (the weights'
bytes, and so meta.json's sha256, stay as they are).

`nsc_tpu_torch.train.checkpoint.restore_inference` reads the export with
numpy alone. This script is the one part of the port's tooling that imports
JAX; it runs where JAX runs, not on the card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FLAGSHIP = os.path.join(REPO, "artifacts", "base_fast_synthetic2_48k_refit")
WEIGHTS, META, REFERENCE = "weights.npz", "meta.json", "reference_f32.npz"
REFERENCE_INT8 = "reference_int8.npz"
REFERENCE_SWEEP, SWEEP_ROWS = "reference_sweep.json", 2
REFERENCE_ROWS_PER_CALL = 4


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    return jax


def flatten(tree, prefix: str, out: dict) -> dict:
    """Nested dicts/lists of arrays -> {"a/b/0/c": float32 array}; None
    leaves (elu activations) are left out."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            flatten(v, f"{prefix}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flatten(v, f"{prefix}/{i}", out)
    elif tree is not None:
        out[prefix] = np.asarray(tree, np.float32)
    return out


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def export_weights(config: str, params, rvq, out_dir: str, *, step=None,
                   source=None) -> dict:
    """Write weights.npz and meta.json for the JAX trees (params, rvq) of
    config `config`; returns the meta dict."""
    from nsc_tpu import api

    arrays = flatten(params, "params", {})
    arrays["rvq/codebooks"] = np.asarray(rvq["codebooks"], np.float32)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, WEIGHTS)
    np.savez(path, **arrays)
    meta = {
        "config": config,
        "step": step,
        "source": source,
        "fingerprint": api.codebook_fingerprint(rvq),
        "weights_sha256": sha256(path),
        "values": int(sum(a.size for a in arrays.values())),
    }
    with open(os.path.join(out_dir, META), "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")
    return meta


def reference_f32(cfg, params, rvq, rows=None):
    """nsc_tpu's CPU float32 indices and argmin margins on the canonical
    probes: {"indices_noise", "margins_noise", "indices_speech",
    "margins_speech"}, each (rows, frames, n_q); `rows` (default all 8) of
    each probe, REFERENCE_ROWS_PER_CALL rows per jitted call."""
    jax = _jax()
    from nsc_tpu import canonical
    from nsc_tpu.models.codec import NeuralSpeechCodec
    from nsc_tpu.ops import rvq as JR

    model = NeuralSpeechCodec(cfg)
    latents = jax.jit(model.latents)
    quantize = jax.jit(JR.quantize)
    margins = jax.jit(JR.argmin_margins)
    out = {}
    for name, wav in (("noise", canonical.probe_input(cfg)),
                      ("speech", canonical.speech_probe_input(cfg))):
        wav = wav if rows is None else wav[:rows]
        idx, mar = [], []
        for i in range(0, wav.shape[0], REFERENCE_ROWS_PER_CALL):
            z = latents(params, wav[i : i + REFERENCE_ROWS_PER_CALL])
            idx.append(np.asarray(quantize(rvq, z)))
            mar.append(np.asarray(margins(rvq, z)))
        out[f"indices_{name}"] = np.concatenate(idx).astype(np.int32)
        out[f"margins_{name}"] = np.concatenate(mar).astype(np.float32)
    return out


def reference_int8(cfg, params, rvq, rows=None):
    """nsc_tpu's int8 model on the canonical probes: `quantize_model` of the
    float32 bundle with its default calibration, then its CPU indices and
    argmin margins as `reference_f32` gives them, and the per-site scales
    as "a_s_<i>" (float32 scalars in call order)."""
    jax = _jax()
    import nsc_tpu
    from nsc_tpu import api
    from nsc_tpu.models.codec import NeuralSpeechCodec
    from nsc_tpu.ops import quant as JQ

    qb = nsc_tpu.quantize_model(api.ModelBundle(NeuralSpeechCodec(cfg), params, rvq))
    out = reference_f32(qb.cfg, qb.params, rvq, rows)
    for i, site in enumerate(JQ._conv_sites(qb.params)):
        out[f"a_s_{i}"] = np.asarray(jax.device_get(site["a_s"]), np.float32)
    return out


def reference_sweep(cfg, params, rvq, fingerprint: int) -> dict:
    """nsc_tpu's CPU float32 bitrate sweep of the first SWEEP_ROWS clips of
    the speech probe, every depth."""
    _jax()
    from nsc_tpu import api, canonical
    from nsc_tpu.eval.sweep import bitrate_sweep
    from nsc_tpu.models.codec import NeuralSpeechCodec

    wavs = canonical.speech_probe_input(cfg)[:SWEEP_ROWS]
    rows = bitrate_sweep(api.ModelBundle(NeuralSpeechCodec(cfg), params, rvq), wavs)
    return {"config": cfg.name, "fingerprint": int(fingerprint), "probe": "speech",
            "clips": SWEEP_ROWS, "samples": int(wavs.shape[-1]), "rows": rows}


def restore(src: str, config: str):
    """(params, rvq, step) of the orbax checkpoint at `src`, restored on CPU
    JAX into `config`'s init_codec structure."""
    jax = _jax()
    from nsc_tpu.configs import get_config
    from nsc_tpu.models.codec import init_codec
    from nsc_tpu.train import checkpoint as ckpt

    cfg = get_config(config)
    shapes = jax.eval_shape(lambda k: init_codec(k, cfg)[1:], jax.random.PRNGKey(0))
    tmpl = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params, rvq = ckpt.restore_inference(src, *tmpl)
    # the directory restore_inference read: infer_best, infer or src itself
    step = None
    for target in (os.path.join(src, "infer_best"), os.path.join(src, "infer"), src):
        step = ckpt.latest_step(target)
        if step is not None:
            break
    params, rvq = jax.tree.map(np.asarray, (params, rvq))
    return params, rvq, step


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src", nargs="?", default=FLAGSHIP, help="orbax checkpoint directory")
    p.add_argument("--config", default="base_fast")
    p.add_argument("--out", default=None, help="default: exports/<name of SRC>")
    p.add_argument("--int8-reference-only", action="store_true",
                   help="write reference_int8.npz alone into the existing export")
    p.add_argument("--sweep-reference-only", action="store_true",
                   help="write reference_sweep.json alone into the existing export")
    args = p.parse_args(argv)

    from nsc_tpu.configs import get_config

    src = os.path.abspath(args.src)
    out = args.out or os.path.join(REPO, "exports", os.path.basename(src.rstrip("/")))
    params, rvq, step = restore(src, args.config)
    cfg = get_config(args.config)
    meta = None
    if args.int8_reference_only or args.sweep_reference_only:
        with open(os.path.join(out, META)) as f:
            fingerprint = json.load(f)["fingerprint"]
        from nsc_tpu import api

        if fingerprint != api.codebook_fingerprint(rvq):
            raise SystemExit(f"{out} was not exported from {src}")
    else:
        rel = os.path.relpath(src, REPO)
        meta = export_weights(args.config, params, rvq, out, step=step,
                              source=rel if not rel.startswith("..") else src)
        fingerprint = meta["fingerprint"]
        np.savez(os.path.join(out, REFERENCE), **reference_f32(cfg, params, rvq),
                 fingerprint=np.uint32(fingerprint), config=np.array(args.config))
    if not args.sweep_reference_only:
        np.savez(os.path.join(out, REFERENCE_INT8), **reference_int8(cfg, params, rvq),
                 fingerprint=np.uint32(fingerprint), config=np.array(args.config))
    if not args.int8_reference_only:
        with open(os.path.join(out, REFERENCE_SWEEP), "w") as f:
            json.dump(reference_sweep(cfg, params, rvq, fingerprint), f, indent=1)
            f.write("\n")
    size = os.path.getsize(os.path.join(out, WEIGHTS))
    print(json.dumps({"out": out, "weights_bytes": size, **(meta or {"fingerprint": fingerprint})}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
