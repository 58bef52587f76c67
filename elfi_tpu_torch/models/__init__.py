"""Example models of the PyTorch port (the MA2 slice so far)."""
