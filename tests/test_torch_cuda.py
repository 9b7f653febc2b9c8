"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked `cuda`: they skip without a card. On a machine with one (and no JAX),
run them without the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

This file imports torch and the port only.
"""

import pytest
import torch

from nsc_tpu_torch.kernels import residual_stack as RS
from nsc_tpu_torch.kernels import rvq as KR
from nsc_tpu_torch.kernels import stft as KS

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _stage(c, units, dtype, dev, bias):
    g = torch.Generator(device=dev).manual_seed(c)
    us = [
        {"conv1": {"w": torch.randn(c, c, 3, device=dev, generator=g) / (3 * c) ** 0.5,
                   "b": bias * torch.randn(c, device=dev, generator=g)},
         "conv2": {"w": torch.randn(c, c, 1, device=dev, generator=g) / c ** 0.5,
                   "b": bias * torch.randn(c, device=dev, generator=g)},
         "act1": 1 + 0.3 * torch.rand(c, device=dev, generator=g),
         "act2": 1 + 0.3 * torch.rand(c, device=dev, generator=g)}
        for _ in range(units)
    ]
    return RS.pack_stage(us, dtype)


# (dtype, max abs err / max|ref|): float32 differs only in summation order;
# bf16 by rounding flips of an ulp (2^-7 relative) that later units carry.
_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("c,t,dil", [(32, 3001, (1, 3, 9)), (12, 77, (1, 3)), (256, 700, (2, 5, 13))])
def test_residual_stack_kernel_matches_plain(dev, dtype, fast, c, t, dil):
    """Ragged T, a non-zero bias (so a stale halo would show in the first
    tile), several widths and dilation sets."""
    p = _stage(c, len(dil), dtype, dev, bias=0.5)
    x = (torch.randn(2, c, t, device=dev) * 0.5).to(dtype)
    got = RS.residual_stack(x, p, dil, fast)
    torch.cuda.synchronize()
    ref = RS.residual_stack_plain(x, p, dil, fast)
    err = (got.float() - ref.float()).abs()
    scale = max(1.0, ref.float().abs().max().item())
    assert err[..., :64].max().item() <= _TOL[dtype] * scale
    assert err.max().item() <= _TOL[dtype] * scale


def test_residual_stack_rejects_bad_inputs(dev):
    p = _stage(32, 3, torch.bfloat16, dev, bias=0.1)
    x = torch.randn(2, 32, 100, device=dev)  # float32 x, bf16 weights
    with pytest.raises(ValueError):
        RS.residual_stack(x, p, (1, 3, 9), True)
    with pytest.raises(ValueError):
        RS.residual_stack(x.to(torch.bfloat16)[..., ::2], p, (1, 3, 9), True)


def test_rvq_kernels_match_plain_with_ties(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    books = torch.randn(4, 300, 40, device=dev, generator=g)
    books[0, 200] = books[0, 7]  # duplicate codeword: the lower index wins
    z = torch.randn(1000, 40, device=dev, generator=g) * 2
    z[0] = books[0, 7]
    idx = KR.quantize(books, z)
    torch.cuda.synchronize()
    assert torch.equal(idx, KR.quantize_plain(books, z))
    assert idx[0, 0].item() == 7
    assert torch.equal(KR.dequantize(books, idx), KR.dequantize_plain(books, idx))


# the training step's STFT launches: five resolutions at hop n_fft/4 (the
# mel STFT is the n_fft 1024 shape), on B=64 x 1 s
@pytest.mark.parametrize("n_fft", [2048, 1024, 512, 256, 128])
def test_stft_kernel_matches_plain_at_slice_shapes(dev, n_fft):
    g = torch.Generator(device=dev).manual_seed(n_fft)
    x = torch.randn(64, 16000, device=dev, generator=g) * 0.3
    got = KS.stft_magnitude(x, n_fft, n_fft // 4)
    torch.cuda.synchronize()
    ref = KS.stft_magnitude_plain(x, n_fft, n_fft // 4)
    assert got.shape == ref.shape == (64, 1 + 16000 // (n_fft // 4), n_fft // 2 + 1)
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def test_stft_function_gradient_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(4, 5000, device=dev, generator=g) * 0.3
    w = torch.rand(4, 1 + 5000 // 128, 257, device=dev, generator=g)
    grads = []
    for fn in (KS.stft_magnitude, KS.stft_magnitude_plain):
        xx = x.clone().requires_grad_(True)
        (fn(xx, 512, 128) * w).sum().backward()
        grads.append(xx.grad)
    assert (grads[0] - grads[1]).abs().max().item() <= 1e-4 * grads[1].abs().max().item()


def test_stft_wrapper_rejects_bad_inputs(dev):
    x = torch.randn(2, 3000, device=dev)
    with pytest.raises(ValueError):
        KS.stft_magnitude(x.double(), 256, 64)
    with pytest.raises(ValueError):
        KS.stft_magnitude(x[:, ::2], 256, 64)
    with pytest.raises(ValueError):
        KS.stft_magnitude(x[:, :100], 256, 64)  # shorter than the reflect pad


def test_full_width_train_step_launches_the_kernels(dev):
    """One base_fast step at the TrainConfig defaults (batch 64 x 1 s, GAN
    with every discriminator): finite metrics, K4 x12 and K2 x1."""
    from nsc_tpu_torch import kernels
    from nsc_tpu_torch.configs import TrainConfig, get_config
    from nsc_tpu_torch.train import train as T

    cfg, tcfg = get_config("base_fast"), TrainConfig()
    model, state = T.init_train_state(cfg, tcfg, dev)
    step = T.make_train_step(model, tcfg)
    batch = torch.randn(64, 16000, device=dev) * 0.1
    kernels.reset_launches()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"residual_stack": 0, "rvq_quantize": 1, "rvq_dequantize": 0,
                                "stft_magnitude": 12}
    assert all(torch.isfinite(v).item() for v in metrics.values())
