"""Example model zoo of the PyTorch port (counterpart of
:mod:`elfi_tpu.models`).  Each module exposes ``get_model(...) ->
elfi_tpu_torch.Model``; MA2 and g-and-k also have a CUDA kernel graph
(``ma2_kernel``, ``gnk_kernel``)."""
