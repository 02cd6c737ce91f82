"""The plain reference and the controls (float64, plain PyTorch)."""
