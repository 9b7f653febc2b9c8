"""Loading checkpoints of the reference's own PyTorch layout (`torch_compat`)."""
