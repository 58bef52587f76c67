"""Bayesian synthetic likelihood: the BSL sampler and its estimators
(counterpart of :mod:`elfi_tpu.methods.bsl`)."""

from .method import BSL  # noqa: F401
from .pdf_methods import (gaussian_syn_likelihood,  # noqa: F401
                          gaussian_syn_likelihood_ghurye_olkin,
                          robust_likelihood, semi_param_kernel_estimate,
                          semiparametric_likelihood, standard_likelihood,
                          syn_likelihood_misspec, traceable_likelihood,
                          unbiased_likelihood)
from .pre_sample_methods import (estimate_whitening_matrix,  # noqa: F401
                                 log_SL_stdev, plot_covariance_matrix,
                                 plot_features, select_penalty)
from .slice_samplers import slice_gamma_mean, slice_gamma_variance  # noqa: F401
