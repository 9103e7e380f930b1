"""Complex AWGN channel.

Replacement for comm.AWGNChannel in SNR mode with unit signal power
(plot_BLER_vs_SNR.m:50,105): total complex noise variance
sigma^2 = 10^(-EsN0_dB/10), split evenly between I and Q.
"""
from __future__ import annotations

import torch


def esn0_to_variance(esn0_db, device="cpu") -> torch.Tensor:
    """Total complex noise variance (0-dim float32) for an Es/N0 in dB
    (plot_BLER_vs_SNR.m:106: Variance = 1/10^(EsN0/10))."""
    x = torch.as_tensor(esn0_db, dtype=torch.float32, device=device)
    return torch.pow(10.0, -x / 10.0)


def complex_noise(
    generator: torch.Generator, shape, noise_var, device
) -> torch.Tensor:
    """Circular complex Gaussian noise of the given total variance.

    Real and imaginary parts are drawn separately from ``generator`` (which
    must live on ``device``) and scaled by sqrt(noise_var / 2) each.
    """
    std = torch.sqrt(
        torch.as_tensor(noise_var, dtype=torch.float32, device=device) / 2.0
    )
    re = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    im = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return torch.complex(std * re, std * im)


def awgn(generator: torch.Generator, tx: torch.Tensor, noise_var) -> torch.Tensor:
    """Add circular complex Gaussian noise with the given total variance."""
    return tx + complex_noise(generator, tx.shape, noise_var, tx.device)
