"""Quality metrics (`eval.quality`) and the bitrate sweep (`eval.sweep`,
`python -m nsc_tpu_torch.eval`)."""
