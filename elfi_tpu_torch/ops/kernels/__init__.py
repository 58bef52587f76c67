"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  Sources live in ``elfi_tpu_torch/csrc/`` and are built at first
use (:mod:`._build`), never at import."""
