"""Example models of the PyTorch port: MA2 and g-and-k (univariate and
bivariate), each model with a CUDA kernel beside its plain graph, and the
Gaussian models of the SMC bench phase."""
