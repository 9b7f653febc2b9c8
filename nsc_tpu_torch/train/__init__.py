"""Training: the GAN train step, data, checkpoints and the loop
(`python -m nsc_tpu_torch.train`)."""
