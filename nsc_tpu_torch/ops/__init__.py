"""Conv, activation and RVQ ops of the port."""
