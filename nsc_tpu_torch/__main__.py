"""CLI: compress/decompress WAV files with the PyTorch port (counterpart of
`python -m nsc_tpu`).

  python -m nsc_tpu_torch compress   in.wav out.nsc [--model base] [--n-q 8]
  python -m nsc_tpu_torch decompress in.nsc out.wav [--model base] [--streaming 1.0]
  python -m nsc_tpu_torch roundtrip  in.wav out.wav [--model base] [--n-q 8]
  python -m nsc_tpu_torch eval       ref.wav [deg.wav] [--model base] [--ceiling] [--json]
  python -m nsc_tpu_torch info       in.nsc
  python -m nsc_tpu_torch models
  python -m nsc_tpu_torch doctor     [--timeout S] [--json] [--device cuda]

Commands that run the model take --checkpoint (an export directory, of a JAX
package checkpoint by `scripts/export_torch_checkpoint.py` or of the port's
trainer, or a training workdir of the port, read from its `infer_best/`,
else its `infer/`), --seed, --serving, --int8 (W8A8 int8 convs with
statically calibrated activation scales, `api.quantize_model`) and
--device (default cuda; there is no move to the CPU unless `--device cpu`
is given). `eval` with one file scores a codec round trip of it; with two
files it scores deg against ref directly.

`doctor` reports versions, CUDA_VISIBLE_DEVICES and the kernel build
directory, then touches the device twice under a deadline (its count and
name, then a tiny op with a host readback): exit 0 when it answered, 97
when it hung (`utils.liveness.EXIT_DEVICE_WEDGED`), 2 when the backend
failed, CUDA being absent included. It never moves to the CPU unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import sys


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nsc_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_model_args(sp):
        sp.add_argument("--model", default="base", help="config name")
        sp.add_argument("--checkpoint", default=None,
                        help="an export directory (weights.npz, meta.json) or a training "
                        "workdir of the port (its newest infer_best/, else infer/ export)")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument(
            "--serving", action="store_true",
            help="the serving path (bf16, the hand-written kernels, the "
            "polynomial snake; indices deviate from the float32 path's at "
            "near-tied codewords)",
        )
        sp.add_argument("--device", default="cuda",
                        help="torch device; raises when CUDA is asked for and absent")
        sp.add_argument(
            "--int8", action="store_true",
            help="W8A8 int8 convs with statically calibrated activation scales "
            "(nsc_tpu_torch.quantize_model)",
        )

    c = sub.add_parser("compress", help="wav -> nsc bitstream")
    c.add_argument("input"), c.add_argument("output")
    c.add_argument("--n-q", type=int, default=None, help="codebooks to use")
    c.add_argument(
        "--streaming", type=float, default=None, metavar="SECONDS",
        help="encode in chunks of this many seconds through the streaming "
        "encoder (bounded memory)",
    )
    c.add_argument(
        "--entropy", action="store_true",
        help="arithmetic-code the index planes (decompress auto-detects)",
    )
    c.add_argument(
        "--queue-chunks", type=int, default=4, metavar="K",
        help="streaming mode: chunks encoded per pass (1 = strict "
        "chunk-at-a-time)",
    )
    add_model_args(c)

    d = sub.add_parser("decompress", help="nsc bitstream -> wav")
    d.add_argument("input"), d.add_argument("output")
    d.add_argument("--n-q", type=int, default=None)
    d.add_argument(
        "--streaming", type=float, default=None, metavar="SECONDS",
        help="decode in chunks of this many seconds through the streaming "
        "decoder (bounded memory for long streams)",
    )
    d.add_argument(
        "--queue-chunks", type=int, default=4, metavar="K",
        help="streaming mode: index blocks decoded per pass (1 = strict "
        "chunk-at-a-time)",
    )
    add_model_args(d)

    r = sub.add_parser("roundtrip", help="wav -> codes -> wav")
    r.add_argument("input"), r.add_argument("output")
    r.add_argument("--n-q", type=int, default=None)
    add_model_args(r)

    e = sub.add_parser("eval", help="quality metrics: ref vs deg, or a codec round trip")
    e.add_argument("reference", help="clean/reference wav")
    e.add_argument(
        "degraded", nargs="?", default=None,
        help="degraded wav; omitted = round-trip `reference` through the model",
    )
    e.add_argument("--n-q", type=int, default=None)
    e.add_argument(
        "--ceiling", action="store_true",
        help="round-trip mode only: also decode the un-quantized latents "
        "(the model's infinite-bitrate bound) and report the quantization gap",
    )
    e.add_argument("--json", action="store_true", help="machine-readable output")
    add_model_args(e)

    i = sub.add_parser("info", help="print bitstream header")
    i.add_argument("input")

    sub.add_parser("models", help="list model configs")

    doc = sub.add_parser(
        "doctor",
        help="environment and device diagnostics, each device touch under a deadline",
    )
    doc.add_argument(
        "--timeout", type=float, default=None,
        help="deadline of each device touch in seconds "
        "(default NSC_DEVICE_CHECK_TIMEOUT or 420)",
    )
    doc.add_argument("--json", action="store_true")
    doc.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def _print_quality(ref, deg, sample_rate, as_json, extra=None) -> int:
    """Score deg against ref with every metric of `eval.quality`."""
    import json

    from nsc_tpu_torch.eval import quality

    m = dict(extra or {})
    m["si_snr_db"] = round(quality.si_snr(ref, deg), 3)
    m["snr_db"] = round(quality.snr(ref, deg), 3)
    m["mel_distance"] = round(quality.mel_distance(ref, deg, sample_rate), 4)
    m["fw_seg_snr_db"] = round(quality.fw_seg_snr(ref, deg, sample_rate), 3)
    m["pesq_proxy"] = round(quality.pesq_proxy(ref, deg, sample_rate), 3)
    m["stoi_proxy"] = round(quality.stoi_proxy(ref, deg, sample_rate), 4)
    m["visqol_nsim"] = round(quality.visqol_nsim(ref, deg, sample_rate), 4)
    try:  # faithful Taal et al. 2011: needs >= 30 active frames at 10 kHz
        m["stoi"] = round(quality.stoi(ref, deg, sample_rate), 4)
    except ValueError as e:
        m["stoi_error"] = str(e)
    if as_json:
        print(json.dumps(m))
    else:
        for k, v in m.items():
            print(f"{k:16s} {v}")
        print(
            "(pesq_proxy: fwSegSNR logistic, NOT ITU-T P.862; stoi: "
            "faithful Taal et al. 2011; stoi_proxy: envelope-correlation "
            "construction; visqol_nsim: gammatone-NSIM core of ViSQOL, "
            "NOT ViSQOL v3 — see nsc_tpu_torch/eval/quality.py)"
        )
    return 0


def _doctor(args) -> int:
    """Environment diagnostics with deadline-guarded device touches (see the
    module doc). Exit 0, 97 (hung) or 2 (backend failed)."""
    import json
    import os

    import numpy as np
    import torch

    import nsc_tpu_torch
    from nsc_tpu_torch.kernels import _build
    from nsc_tpu_torch.utils import liveness

    built = sorted(str(p) for p in _build.BUILD_DIR.glob(f"*/{_build.LIB_NAME}"))
    out: dict = {
        "nsc_tpu_torch": getattr(nsc_tpu_torch, "__version__", "unknown"),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cudnn": torch.backends.cudnn.version(),
        "numpy": np.__version__,
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "kernel_build_dir": str(_build.BUILD_DIR),
        "kernel_library_built": bool(built),
        "kernel_libraries": built,
    }
    timeout = args.timeout if args.timeout is not None else float(
        os.environ.get("NSC_DEVICE_CHECK_TIMEOUT", "420"))
    dev = torch.device(args.device)

    def touch():
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("CUDA is not available (pass --device cpu for the CPU)")
            n = torch.cuda.device_count()
            return {"backend": "cuda", "device_count": n,
                    "devices": [torch.cuda.get_device_name(i) for i in range(n)]}
        return {"backend": dev.type, "device_count": 1, "devices": [str(dev)]}

    # two touches, each under the deadline: the device query, then a tiny op
    # with a host readback (a launch alone can return while the device is
    # hung; the readback cannot)
    rc = 0
    status, value, _ = liveness.run_with_deadline(touch, timeout)
    if status == "ok":
        out.update(value)
        status, value, _ = liveness.run_with_deadline(
            lambda: liveness._default_probe(dev), timeout)
    if status == "timeout":
        out["device_status"] = "wedged"
        out["device_detail"] = f"the device gave no answer in {timeout:.0f}s"
        rc = liveness.EXIT_DEVICE_WEDGED
    elif status == "error":
        out["device_status"] = "error"
        out["device_error"] = str(value)
        rc = 2
    else:
        out["device_status"] = "ok"
    if args.json:
        print(json.dumps(out))
    else:
        for k, v in out.items():
            print(f"{k:26s} {v}")
    return rc


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)

    if args.cmd == "doctor":
        return _doctor(args)

    if args.cmd == "models":
        from nsc_tpu_torch.configs import get_config, list_configs

        for name in list_configs():
            cfg = get_config(name)
            print(
                f"{name:12s} hop={cfg.hop:4d} frame_rate={cfg.frame_rate:6.1f}Hz "
                f"n_q={cfg.num_quantizers:2d} K={cfg.codebook_size:4d} "
                f"max_bitrate={cfg.bitrate()/1000:.2f}kbps"
            )
        return 0

    if args.cmd == "info":
        from nsc_tpu_torch.bitstream import FLAG_FINGERPRINT, BitstreamHeader

        with open(args.input, "rb") as f:
            blob = f.read()
        h, off = BitstreamHeader.from_bytes(blob)
        dur = h.orig_len / h.sample_rate
        bitrate = (len(blob) - off) * 8 / dur if dur else 0.0
        fp = f" codebook_fp={h.fingerprint:#010x}" if h.flags & FLAG_FINGERPRINT else ""
        print(
            f"model={h.model_name} sr={h.sample_rate} hop={h.hop} "
            f"n_q={h.n_q} bits={h.bits} frames={h.num_frames} "
            f"duration={dur:.2f}s payload_bitrate={bitrate/1000:.2f}kbps{fp}"
        )
        return 0

    from nsc_tpu_torch.utils import audio

    if args.cmd == "eval" and args.degraded is not None:
        # two-file scoring needs no model at all
        ref, sr = audio.load_wav(args.reference)
        deg, _ = audio.load_wav(args.degraded, target_sr=sr)
        ref, deg = audio.to_mono(ref), audio.to_mono(deg)
        n = min(len(ref), len(deg))
        return _print_quality(ref[:n], deg[:n], sr, args.json)

    import nsc_tpu_torch as nt

    bundle = nt.load_model(
        args.model, checkpoint=args.checkpoint, seed=args.seed,
        serving=args.serving, device=args.device,
    )
    if args.int8:
        bundle = nt.quantize_model(bundle)
    sr = bundle.cfg.sample_rate

    if args.cmd == "compress":
        wav, _ = audio.load_wav(args.input, target_sr=sr)
        wav = audio.to_mono(wav)
        if args.streaming:
            blob = nt.streaming_compress(
                bundle, wav, chunk_seconds=args.streaming, n_q=args.n_q,
                entropy_coding=args.entropy, queue_chunks=args.queue_chunks,
            )
        else:
            blob = nt.compress(bundle, wav, n_q=args.n_q, entropy_coding=args.entropy)
        with open(args.output, "wb") as f:
            f.write(blob)
        ratio = wav.nbytes / len(blob)
        print(f"wrote {args.output}: {len(blob)} bytes ({ratio:.1f}x vs f32 PCM)")
        return 0

    if args.cmd == "decompress":
        with open(args.input, "rb") as f:
            blob = f.read()
        if args.streaming:
            wav = nt.streaming_decompress(
                bundle, blob, chunk_seconds=args.streaming, n_q=args.n_q,
                queue_chunks=args.queue_chunks,
            )
        else:
            wav = nt.decompress(bundle, blob, n_q=args.n_q)
        audio.save_wav(args.output, wav, sr)
        print(f"wrote {args.output}: {len(wav)} samples")
        return 0

    if args.cmd == "eval":
        wav, _ = audio.load_wav(args.reference, target_sr=sr)
        wav = audio.to_mono(wav)
        blob = nt.compress(bundle, wav, n_q=args.n_q)
        out = nt.decompress(bundle, blob)[: len(wav)]
        dur = len(wav) / sr
        extra = {"bitrate_kbps": round(len(blob) * 8 / dur / 1000, 3)} if dur else {}
        if args.ceiling:
            # the infinite-bitrate bound: decode the un-quantized latents
            rec = _ceiling(bundle, wav)
            from nsc_tpu_torch.eval import quality

            ceil_mel = round(quality.mel_distance(wav, rec, sr), 4)
            extra["ceiling_mel_distance"] = ceil_mel
            extra["ceiling_si_snr_db"] = round(quality.si_snr(wav, rec), 3)
            extra["quant_gap_mel"] = round(quality.mel_distance(wav, out, sr) - ceil_mel, 4)
        return _print_quality(wav, out, sr, args.json, extra=extra)

    if args.cmd == "roundtrip":
        wav, _ = audio.load_wav(args.input, target_sr=sr)
        wav = audio.to_mono(wav)
        blob = nt.compress(bundle, wav, n_q=args.n_q)
        out = nt.decompress(bundle, blob)
        audio.save_wav(args.output, out, sr)
        print(f"wrote {args.output} ({len(blob)} byte stream)")
        return 0

    return 1


def _ceiling(bundle, wav):
    """`wav` through the encoder and the decoder without quantization
    (`NeuralSpeechCodec.decode_latents`), trimmed to its length."""
    import numpy as np
    import torch

    pad = (-len(wav)) % bundle.cfg.hop
    w = torch.tensor(np.pad(wav, (0, pad))[None, :], device=bundle.device)
    with torch.inference_mode():
        z = bundle.model.latents(bundle.params, w)
        rec = bundle.model.decode_latents(bundle.params, z)
    return rec[0, : len(wav)].cpu().numpy()


def _entry() -> int:
    try:
        return main()
    except FileNotFoundError as e:
        print(f"error: file not found: {e.filename or e}", file=sys.stderr)
    except (ValueError, KeyError) as e:
        from nsc_tpu_torch.bitstream import BitstreamError

        kind = "bitstream error" if isinstance(e, BitstreamError) else "error"
        print(f"{kind}: {e}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(_entry())
