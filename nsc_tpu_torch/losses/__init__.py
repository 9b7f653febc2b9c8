"""Training losses: spectral reconstruction and adversarial."""
