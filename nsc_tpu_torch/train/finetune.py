"""Decoder finetune of a trained codec with its encoder and codebooks frozen
(counterpart of `nsc_tpu/train/finetune.py`).

After a codebook refit (`train/refit.py`) the decoder still inverts the old
quantizer's output; this finetunes only the decoder, on quantized latents
sampled across RVQ depths (quantizer dropout as in training), against the
reconstruction losses (time L1, mel, multi-resolution STFT; no GAN term),
so the one decoder improves at every bitrate.

  * The frozen half (encoder, RVQ assignment, projection) runs under
    `no_grad`; gradients are taken for the decoder's leaves only, and only
    they and their Adam moments are updated (in place). The encoder,
    projections and codebooks stay bit-identical, which `run_finetune`
    asserts at its end.
  * The step computes in float32 (`float32_numerics`); its RVQ search is one
    launch of the quantize wrapper and its loss STFTs go through the STFT
    kernel wrapper, as in the GAN step.
  * State: {"step", "params_g" (the JAX layout, weight-norm as (v, g)),
    "opt" (Adam over the decoder), "rvq" ({"codebooks"})}. Its inference
    exports are the format `api.load_model` reads.

`run_finetune` keeps the best decoder on a held-out batch: every
`eval_every` steps the decoder is scored on 8 x 2 s drawn fresh (seed
`eval_seed`) from the data spec without its ':pool=' suffix, by the RMS
log-mel error of `eval/quality.mel_distance` (1024/256/80, the plain
`ops.stft.mel_spectrogram`, not the STFT kernel). If the best decoder beats
the final one it is exported to `<workdir>/infer_best/<step>`, which
`restore_inference` prefers over `infer/`; otherwise no `infer_best/`
remains, also none from an earlier call of the same workdir (the JAX
package leaves such a stale copy in place).
"""

from __future__ import annotations

import dataclasses
import math
import os
import shutil
import time
from typing import Any, Dict, Optional, Tuple

import torch

from nsc_tpu_torch import weights
from nsc_tpu_torch.api import resolve_device
from nsc_tpu_torch.configs import TrainConfig, get_config
from nsc_tpu_torch.losses import spectral
from nsc_tpu_torch.models import seanet
from nsc_tpu_torch.ops import rvq as rvq_ops
from nsc_tpu_torch.ops import stft as stft_ops
from nsc_tpu_torch.ops.precision import float32_numerics
from nsc_tpu_torch.train import checkpoint as ckpt
from nsc_tpu_torch.train import data as data_lib
from nsc_tpu_torch.train import loop
from nsc_tpu_torch.train.train import (
    clip_adam_update,
    global_norm,
    init_adam,
    make_lr_schedule,
    model_for,
    sample_depths,
    step_generator,
    tree_leaves,
)

FinetuneState = Dict[str, Any]

HELDOUT_ROWS, HELDOUT_SECONDS = 8, 2.0


def init_finetune_state(params_g, rvq, device, *, step: int = 0, opt=None) -> FinetuneState:
    """A finetune state from (params_g, rvq) trees in the JAX layout (numpy
    or tensors) on `device`: float32 leaves, the decoder's requiring grad;
    zero Adam moments unless `opt` is given (a resumed state's)."""
    params = weights.to_device(weights.to_tensors(params_g), device)
    params["decoder"] = weights.tree_map(lambda x: x.requires_grad_(True), params["decoder"])
    state = {
        "step": step,
        "params_g": params,
        "opt": init_adam(params["decoder"]),
        "rvq": weights.to_device(weights.to_tensors({"codebooks": rvq["codebooks"]}), device),
    }
    if opt is not None:
        state["opt"] = {"count": int(opt["count"]),
                        "mu": weights.tree_map(lambda x: x.to(device, torch.float32), opt["mu"]),
                        "nu": weights.tree_map(lambda x: x.to(device, torch.float32), opt["nu"])}
    return state


def make_finetune_step(model, tcfg: TrainConfig):
    """(state, batch (N, T) float32) -> (state, metrics): one decoder-only
    update. Keyword `depth` (N,) replaces the step's own quantizer-dropout
    draw (from `step_generator(tcfg.seed, step)`)."""
    cfg = model.cfg
    lr = make_lr_schedule(tcfg.lr_g, tcfg)
    mrstft = spectral.MultiResSTFTConfig(fft_sizes=tcfg.stft_fft_sizes)

    def finetune_step(state: FinetuneState, batch: torch.Tensor, *,
                      depth: Optional[torch.Tensor] = None):
        with float32_numerics():
            return _step(state, batch, depth)

    def _step(state, batch, depth):
        step = state["step"]
        params = state["params_g"]
        if depth is None and tcfg.quantizer_dropout > 0:
            depth = sample_depths(step_generator(tcfg.seed, step), batch.shape[0],
                                  cfg.num_quantizers, tcfg.quantizer_dropout)
        with torch.no_grad():
            z = model.train_latents(params, batch)
            fwd = rvq_ops.forward(state["rvq"], z, depth=depth)
            zq = model._project_out(params, fwd.quantized).to(model.compute_dtype)
        dec_leaves = tree_leaves(params["decoder"])
        dec = seanet.materialize_decoder(params["decoder"])
        recon = seanet.apply_decoder(dec, zq.transpose(1, 2), cfg)[:, 0, :].float()
        l_time = spectral.time_l1_loss(recon, batch)
        l_mel = spectral.mel_loss(
            recon, batch, sample_rate=cfg.sample_rate, n_fft=tcfg.mel_fft_size,
            hop=tcfg.mel_fft_size // 4, n_mels=tcfg.mel_bins,
        )
        l_stft = spectral.multi_res_stft_loss(recon, batch, mrstft)
        total = (tcfg.weight_l1_time * l_time + tcfg.weight_mel * l_mel
                 + tcfg.weight_stft * l_stft)
        grads = list(torch.autograd.grad(total, dec_leaves))
        metrics = {"loss/time_l1": l_time, "loss/mel": l_mel, "loss/stft": l_stft,
                   "loss/g_total": total, "grad/g_norm": global_norm(grads),
                   "lr/g": torch.tensor(lr(step))}
        clip_adam_update(params["decoder"], grads, state["opt"], tcfg, lr)
        state["step"] = step + 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return finetune_step


def finetune_config(steps: int = 20_000, *, lr: float = 1e-4, batch_size: int = 64,
                    warmup_steps: int = 200) -> TrainConfig:
    """Finetune hyperparameters: a lower LR than pretraining (the decoder is
    trained already), a short warmup and a cosine decay over the run; no
    GAN; every save is a full one (the state is small)."""
    return dataclasses.replace(
        TrainConfig(), batch_size=batch_size, steps=steps, lr_g=lr,
        warmup_steps=warmup_steps, lr_decay_steps=steps, use_gan=False,
        checkpoint_every=2500, full_state_every=0, log_every=50,
    )


def _frozen(state: FinetuneState) -> list:
    """Copies of everything a finetune must not move: every params_g leaf
    outside the decoder, and the codebooks."""
    rest = {k: v for k, v in state["params_g"].items() if k != "decoder"}
    return [x.detach().clone() for x in tree_leaves(rest) + [state["rvq"]["codebooks"]]]


def run_finetune(
    artifact: str,
    *,
    workdir: str,
    steps: int,
    tcfg: TrainConfig,
    data_spec: Optional[str] = None,
    resume: bool = True,
    eval_every: int = 1000,
    eval_seed: int = 2,
    keep_best: bool = True,
    device=None,
) -> Tuple[Dict[str, float], Dict[str, Any]]:
    """Finetune the decoder of the export `artifact` (an export directory or
    a training workdir) in `workdir`, resuming from its `train/` unless
    resume=False. Data: `data_spec`, else the export's meta.json `data`
    field (a missing spec raises). Writes metrics.jsonl, full states to
    `train/` (the newest 2 kept) and exports to `infer/` every
    `tcfg.checkpoint_every` steps and at the end, and `infer_best/` as the
    module docstring says. device=None means CUDA. Returns (the last
    metrics with the held-out readings, the artifact's meta)."""
    dev = resolve_device(device)
    meta = ckpt.export_meta(artifact)
    data_spec = data_spec or meta.get("data")
    if not data_spec:
        raise ValueError(
            f"{artifact}: its meta.json has no 'data' field (the training data spec); "
            "pass data_spec"
        )
    cfg = get_config(meta["config"])
    model = model_for(cfg)
    params, rvq = ckpt.restore_inference(artifact)
    state = init_finetune_state(params, rvq, dev)
    train_dir = os.path.join(workdir, "train")
    source = data_lib.make_source(data_spec, cfg.sample_rate, tcfg.seed)
    if hasattr(source, "set_cache_dir"):
        source.set_cache_dir(workdir)
    start = 0
    if resume and ckpt.latest_step(train_dir) is not None:
        start, trees, data_state = ckpt.restore(train_dir)
        state = init_finetune_state(trees["params_g"], trees["rvq"], dev, step=start,
                                    opt=trees["opt"])
        if data_state is not None:
            source.set_state(data_state)
        print(f"finetune: resumed from step {start}")
    frozen = _frozen(state)
    step_fn = make_finetune_step(model, tcfg)
    seg = loop.segment_length(cfg, tcfg.segment_seconds)
    batches = data_lib.Prefetcher(data_lib.batches_with_state(source, tcfg.batch_size, seg))
    logger = loop.MetricsLogger(workdir)
    writer = loop.SnapshotWriter(dev)
    export = dict(loop.export_fields(cfg, workdir, data_spec), finetune_of=os.path.abspath(artifact))

    # the held-out batch and its frozen half, computed once
    seg_e = int(HELDOUT_SECONDS * cfg.sample_rate) // cfg.hop * cfg.hop
    heldout = data_lib.make_source(data_lib.strip_pool(data_spec), cfg.sample_rate, eval_seed)
    eval_wavs = torch.from_numpy(next(heldout.batches(HELDOUT_ROWS, seg_e))).to(dev)
    with torch.no_grad(), float32_numerics():
        p = state["params_g"]
        zq_e = model._project_out(p, rvq_ops.forward(state["rvq"], model.train_latents(
            p, eval_wavs)).quantized).to(model.compute_dtype).transpose(1, 2)
        mel_ref = stft_ops.mel_spectrogram(eval_wavs, cfg.sample_rate, 1024, 256, 80)

    @torch.no_grad()
    def heldout_mel(dec_tree) -> float:
        with float32_numerics():
            dec = seanet.materialize_decoder(dec_tree)
            recon = seanet.apply_decoder(dec, zq_e, cfg)[:, 0, : eval_wavs.shape[-1]].float()
            mel = stft_ops.mel_spectrogram(recon, cfg.sample_rate, 1024, 256, 80)
            return float(torch.sqrt(torch.mean((mel - mel_ref) ** 2)))

    def write(host, step1, data_state):
        ckpt.save(train_dir, step1, host, data_state, max_to_keep=2)
        ckpt.save_inference(os.path.join(workdir, "infer"), step1,
                            host["params_g"], host["rvq"], export)

    best_mel, best_step, best_dec, last_hm = math.inf, -1, None, math.nan
    metrics: dict = {}
    t0 = time.time()
    try:
        pending = loop.batch_to_device(next(batches), dev) if start < steps else None
        for step in range(start, steps):
            batch, data_state = pending
            last = step + 1 == steps
            if not last:
                pending = loop.batch_to_device(next(batches), dev)
            state, metrics = step_fn(state, batch)
            if (step + 1) % tcfg.log_every == 0 or last:
                m = {k: float(v) for k, v in metrics.items()}
                m["steps_per_sec"] = tcfg.log_every / max(time.time() - t0, 1e-9)
                t0 = time.time()
                logger.log(step + 1, m)
                print(f"finetune step {step + 1}: g={m['loss/g_total']:.4f} "
                      f"mel={m['loss/mel']:.4f}", flush=True)
            if (step + 1) % eval_every == 0 or last:
                hm = last_hm = heldout_mel(state["params_g"]["decoder"])
                logger.log(step + 1, {"heldout/mel": hm})
                mark = ""
                if hm < best_mel:
                    best_mel, best_step = hm, step + 1
                    best_dec = weights.tree_map(loop._clone, state["params_g"]["decoder"])
                    mark = " (best)"
                print(f"finetune heldout step {step + 1}: mel={hm:.4f}{mark}", flush=True)
            if (step + 1) % tcfg.checkpoint_every == 0 or last:
                writer.submit(state, lambda host, a=(step + 1, data_state): write(host, *a),
                              sync=last)
        writer.join()
    finally:
        writer.wait()
        batches.close()
        logger.close()

    if not all(torch.equal(a, b) for a, b in zip(frozen, _frozen(state))):
        raise AssertionError("finetune moved the encoder, a projection or the codebooks")
    out = {k: float(v) for k, v in metrics.items()}
    if best_step > 0:
        out.update({"heldout/mel_best": best_mel, "heldout/best_step": float(best_step),
                    "heldout/mel_final": last_hm})
    best_dir = os.path.join(workdir, "infer_best")
    shutil.rmtree(best_dir, ignore_errors=True)
    if keep_best and best_dec is not None and best_mel < last_hm:
        best_params = dict(state["params_g"], decoder=best_dec)
        ckpt.save_inference(best_dir, best_step, best_params, state["rvq"], export, max_to_keep=1)
        print(f"finetune keep-best: step {best_step} heldout mel {best_mel:.4f} "
              f"< final {last_hm:.4f} -> infer_best/", flush=True)
    return out, meta
