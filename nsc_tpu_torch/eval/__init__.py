"""Quality metrics (`eval.quality`)."""
