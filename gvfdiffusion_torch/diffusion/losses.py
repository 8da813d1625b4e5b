"""Likelihood helpers for the variational-bound terms (port of
gvfdiffusion_tpu/diffusion/losses.py)."""

import math

import torch


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL(N(mean1, exp(logvar1)) || N(mean2, exp(logvar2))), elementwise."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x):
    # sqrt(2 / pi) taken in fp32, as JAX takes it
    c = torch.sqrt(torch.tensor(2.0 / math.pi, dtype=torch.float32))
    return 0.5 * (1.0 + torch.tanh(c.to(x.device) * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of a Gaussian discretized to 1/255 bins, for x in
    [-1, 1]."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(
        inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_cdf_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min,
                                   log_cdf_delta))
