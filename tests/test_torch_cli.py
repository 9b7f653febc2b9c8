"""The port's CLI (`python -m nsc_tpu_torch`), in process with `--device
cpu`, on `tiny_test` weights made by nsc_tpu's `init_codec` and exported by
`scripts/export_torch_checkpoint.py`.

Every command and flag: models, info, compress (--n-q, --entropy,
--streaming, --queue-chunks, --serving, --seed), decompress (--streaming),
roundtrip, eval (two files; round trip with --ceiling, --json); the exit
codes of `_entry` on a missing file and a corrupt stream; no move to the
CPU without `--device cpu`. Tolerances: none. The port's stream bytes equal
`nsc_tpu.compress` on the same weights (float32 indices are bit-equal on
this config); decoded WAVs equal the port's in-process decompress sample
for sample.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from nsc_tpu import api as JA
from nsc_tpu.configs import get_config
from nsc_tpu.models.codec import NeuralSpeechCodec, init_codec
from nsc_tpu_torch import api as PA
from nsc_tpu_torch import bitstream
from nsc_tpu_torch.__main__ import _entry, main
from nsc_tpu_torch.utils import audio
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import export_torch_checkpoint as E  # noqa: E402

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    cfg = get_config("tiny_test")
    params, rvq = jax.jit(lambda k: init_codec(k, cfg)[1:])(jax.random.PRNGKey(0))
    params, rvq = jax.tree.map(np.asarray, (params, rvq))
    d = tmp_path_factory.mktemp("cli")
    export = str(d / "export")
    E.export_weights("tiny_test", params, rvq, export)
    wav_path = str(d / "in.wav")
    rng = np.random.RandomState(0)
    audio.save_wav(wav_path, (rng.randn(16000) * 0.2).astype(np.float32), 16000)
    wav, _ = audio.load_wav(wav_path)
    jax_bundle = JA.ModelBundle(NeuralSpeechCodec(cfg), params, rvq)
    model = ["--model", "tiny_test", "--checkpoint", export, *CPU]
    port = PA.load_model("tiny_test", checkpoint=export, device="cpu")
    return {"dir": d, "export": export, "wav_path": wav_path, "wav": wav, "jax": jax_bundle,
            "model": model, "port": port}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_models_lists_every_config(capsys):
    assert main(["models"]) == 0
    out = capsys.readouterr().out
    assert "base_fast" in out and "tiny_test" in out and "hop=   4" in out


@pytest.mark.parametrize("flags,jax_kwargs", [
    ([], {}),
    (["--n-q", "1"], {"n_q": 1}),
    (["--entropy"], {"entropy_coding": True}),
])
def test_compress_bytes_equal_nsc_tpu(env, tmp_path, flags, jax_kwargs):
    out = str(tmp_path / "a.nsc")
    assert main(["compress", env["wav_path"], out, *env["model"], *flags]) == 0
    assert _read(out) == JA.compress(env["jax"], env["wav"], **jax_kwargs)


@pytest.mark.parametrize("queue", ["1", "4"])
def test_streaming_compress_equals_batch(env, tmp_path, queue):
    batch, stream = str(tmp_path / "b.nsc"), str(tmp_path / "s.nsc")
    assert main(["compress", env["wav_path"], batch, *env["model"]]) == 0
    assert main(["compress", env["wav_path"], stream, *env["model"], "--streaming", "0.25",
                 "--queue-chunks", queue]) == 0
    assert _read(stream) == _read(batch)


def test_info_prints_the_header(env, tmp_path, capsys):
    out = str(tmp_path / "a.nsc")
    main(["compress", env["wav_path"], out, *env["model"]])
    capsys.readouterr()
    assert main(["info", out]) == 0
    line = capsys.readouterr().out.strip()
    fp = PA.codebook_fingerprint(env["port"].rvq)
    assert line == (f"model=tiny_test sr=16000 hop=4 n_q=2 bits=4 frames=4000 duration=1.00s "
                    f"payload_bitrate=32.00kbps codebook_fp={fp:#010x}")


@pytest.mark.parametrize("streaming", [[], ["--streaming", "0.3", "--queue-chunks", "2"]])
def test_decompress_writes_the_decoded_wav(env, tmp_path, streaming):
    blob, out = str(tmp_path / "a.nsc"), str(tmp_path / "out.wav")
    main(["compress", env["wav_path"], blob, *env["model"]])
    assert main(["decompress", blob, out, *env["model"], *streaming]) == 0
    got, sr = audio.load_wav(out)
    want = PA.decompress(env["port"], _read(blob))
    assert sr == 16000 and got.shape == want.shape == (16000,)
    np.testing.assert_array_equal(got, audio.load_wav(_saved(tmp_path, want))[0])


def _saved(tmp_path, wav):
    path = str(tmp_path / "want.wav")
    audio.save_wav(path, wav, 16000)
    return path


def test_roundtrip(env, tmp_path, capsys):
    out = str(tmp_path / "rt.wav")
    assert main(["roundtrip", env["wav_path"], out, *env["model"]]) == 0
    assert "byte stream" in capsys.readouterr().out
    want = PA.decompress(env["port"], PA.compress(env["port"], env["wav"]))
    np.testing.assert_array_equal(audio.load_wav(out)[0], audio.load_wav(_saved(tmp_path, want))[0])


def test_eval_two_files_and_round_trip(env, tmp_path, capsys):
    deg = str(tmp_path / "deg.wav")
    audio.save_wav(deg, env["wav"] * 0.9, 16000)
    assert main(["eval", env["wav_path"], deg, "--json"]) == 0
    two = json.loads(capsys.readouterr().out)
    assert set(two) == {"si_snr_db", "snr_db", "mel_distance", "fw_seg_snr_db", "pesq_proxy",
                        "stoi_proxy", "visqol_nsim", "stoi"}
    assert two["si_snr_db"] > 30 and all(np.isfinite(v) for v in two.values())
    assert main(["eval", env["wav_path"], *env["model"], "--ceiling", "--json"]) == 0
    rt = json.loads(capsys.readouterr().out)
    assert {"bitrate_kbps", "ceiling_mel_distance", "ceiling_si_snr_db", "quant_gap_mel"} <= set(rt)
    # each of the three is rounded to 4 decimals on its own
    assert abs(rt["quant_gap_mel"] - (rt["mel_distance"] - rt["ceiling_mel_distance"])) <= 2e-4
    assert main(["eval", env["wav_path"], deg]) == 0
    assert "NOT ITU-T P.862" in capsys.readouterr().out


def test_serving_and_seed_flags(env, tmp_path):
    served = str(tmp_path / "serving.nsc")
    assert main(["compress", env["wav_path"], served, *env["model"], "--serving"]) == 0
    want = PA.compress(PA.load_model("tiny_test", checkpoint=env["export"], serving=True,
                                     device="cpu"), env["wav"])
    assert _read(served) == want
    seeded = str(tmp_path / "seed.nsc")
    assert main(["compress", env["wav_path"], seeded, "--model", "tiny_test", "--seed", "3", *CPU]) == 0
    header, _ = bitstream.deserialize(_read(seeded))
    assert header.fingerprint == PA.codebook_fingerprint(
        PA.load_model("tiny_test", seed=3, device="cpu").rvq)


def test_entry_exit_codes(env, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["nsc_tpu_torch", "info", str(tmp_path / "missing.nsc")])
    assert _entry() == 2
    assert "error: file not found" in capsys.readouterr().err
    corrupt = str(tmp_path / "corrupt.nsc")
    with open(corrupt, "wb") as f:
        f.write(b"not a stream at all")
    monkeypatch.setattr(sys, "argv", ["nsc_tpu_torch", "decompress", corrupt,
                                      str(tmp_path / "x.wav"), *env["model"]])
    assert _entry() == 2
    assert capsys.readouterr().err.startswith("bitstream error:")
    monkeypatch.setattr(sys, "argv", ["nsc_tpu_torch", "compress", env["wav_path"],
                                      str(tmp_path / "y.nsc"), "--model", "base_fast", "--checkpoint",
                                      env["export"], *CPU])
    assert _entry() == 2
    assert "holds a 'tiny_test' model" in capsys.readouterr().err


def test_no_cuda_means_no_run(env, tmp_path, monkeypatch):
    """Without --device the model runs on CUDA; with CUDA absent the
    command raises instead of moving to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["compress", env["wav_path"], str(tmp_path / "a.nsc"), "--model", "tiny_test"])
    assert not os.path.exists(tmp_path / "a.nsc")


def test_doctor_on_the_cpu_reports_and_exits_zero(capsys):
    rc = main(["doctor", "--json", "--device", "cpu", "--timeout", "60"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device_status"] == "ok" and out["backend"] == "cpu" and out["device_count"] == 1
    for key in ("nsc_tpu_torch", "torch", "cuda", "cudnn", "numpy", "cuda_visible_devices",
                "kernel_build_dir", "kernel_library_built"):
        assert key in out
    assert out["torch"] == torch.__version__


def test_doctor_wedged_probe_exits_97(capsys, monkeypatch):
    """A probe that hangs past the deadline (injected, as nsc_tpu's own
    doctor test does) gives 97 and "wedged"."""
    import time

    from nsc_tpu_torch.utils import liveness

    monkeypatch.setattr(liveness, "_default_probe", lambda dev=None: time.sleep(30))
    rc = main(["doctor", "--json", "--device", "cpu", "--timeout", "0.5"])
    assert rc == liveness.EXIT_DEVICE_WEDGED == 97
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["device_status"] == "wedged"


def test_doctor_without_cuda_fails_with_2(capsys, monkeypatch):
    """No --device means CUDA; without it doctor says so and exits 2, and
    runs nothing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = main(["doctor", "--json", "--timeout", "60"])
    assert rc == 2
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device_status"] == "error" and "CUDA is not available" in out["device_error"]
    assert "backend" not in out


@pytest.mark.parametrize("cmd", ["compress", "roundtrip"])
def test_int8_flag_equals_the_api(env, tmp_path, cmd):
    """`--int8` serves `quantize_model(load_model(...))` (its default
    calibration): the stream, and the WAV of a round trip and of a
    decompress, equal the same calls in process."""
    qb = PA.quantize_model(env["port"])
    out = str(tmp_path / ("a.nsc" if cmd == "compress" else "a.wav"))
    assert main([cmd, env["wav_path"], out, *env["model"], "--int8"]) == 0
    blob = PA.compress(qb, env["wav"])
    if cmd == "compress":
        assert _read(out) == blob
        back = str(tmp_path / "b.wav")
        assert main(["decompress", out, back, *env["model"], "--int8"]) == 0
        got, _ = audio.load_wav(back)
        want, _ = _wav_roundtrip(tmp_path, PA.decompress(qb, blob))
    else:
        got, _ = audio.load_wav(out)
        want, _ = _wav_roundtrip(tmp_path, PA.decompress(qb, blob))
    np.testing.assert_array_equal(got, want)


def test_int8_eval_codec_mode(env, capsys):
    assert main(["eval", env["wav_path"], *env["model"], "--int8", "--json"]) == 0
    m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(m["mel_distance"]) and np.isfinite(m["si_snr_db"])


def _wav_roundtrip(tmp_path, wav):
    """`wav` as the CLI writes and reads it (16-bit PCM)."""
    path = str(tmp_path / "ref.wav")
    audio.save_wav(path, wav, 16000)
    return audio.load_wav(path)
