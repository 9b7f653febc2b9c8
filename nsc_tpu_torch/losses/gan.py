"""Adversarial and feature-matching losses (counterpart of
`nsc_tpu/losses/gan.py`).

Least-squares GAN:
  D: mean((1 - D(x))^2) + mean(D(x_hat)^2)
  G: mean((1 - D(x_hat))^2)
Feature matching: L1 between real and fake intermediate discriminator
features, each layer divided by the mean magnitude of its real features
(the real features carry no gradient); the logit layer is skipped.

A discriminator output is a list over sub-discriminators of (logits,
[feature maps]).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

DiscOut = List[Tuple[torch.Tensor, List[torch.Tensor]]]


def discriminator_loss(real: DiscOut, fake: DiscOut) -> torch.Tensor:
    loss = real[0][0].new_zeros((), dtype=torch.float32)
    for (lr, _), (lf, _) in zip(real, fake):
        loss = loss + torch.mean(torch.square(1.0 - lr)) + torch.mean(torch.square(lf))
    return loss / len(real)


def generator_adversarial_loss(fake: DiscOut) -> torch.Tensor:
    loss = fake[0][0].new_zeros((), dtype=torch.float32)
    for lf, _ in fake:
        loss = loss + torch.mean(torch.square(1.0 - lf))
    return loss / len(fake)


def feature_matching_loss(real: DiscOut, fake: DiscOut) -> torch.Tensor:
    loss = real[0][0].new_zeros((), dtype=torch.float32)
    n = 0
    for (_, fr), (_, ff) in zip(real, fake):
        for r, f in zip(fr[:-1], ff[:-1]):  # skip the logit layer
            r = r.detach()
            loss = loss + torch.mean(torch.abs(r - f)) / (torch.mean(torch.abs(r)) + 1e-6)
            n += 1
    return loss / max(n, 1)
