"""Plain reference of each configuration, in PyTorch and NumPy: imports
neither JAX nor the JAX package nor the program."""
