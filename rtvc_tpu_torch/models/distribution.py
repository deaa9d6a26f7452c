"""Output distributions of the WaveRNN heads (counterpart of
``rtvc_tpu/models/distribution.py``): the discretized mixture of logistics
(loss and sampling, the MOL head) and the two-parameter beta head of the
geneing variant's RAW mode. Draws take a ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

LOG_SCALE_MIN = float(math.log(1e-14))


def log_sum_exp(x: Tensor) -> Tensor:
    """Numerically stable logsumexp over the last axis."""
    m = x.max(dim=-1, keepdim=True).values
    return m[..., 0] + torch.log(torch.exp(x - m).sum(dim=-1))


def discretized_mix_logistic_loss(y_hat: Tensor, y: Tensor, num_classes: int = 65536,
                                  log_scale_min: Optional[float] = None,
                                  reduce: bool = True) -> Tensor:
    """Negative log-likelihood of a discretized logistic mixture.

    y_hat: (B, C, T) raw head output with C = 3·nr_mix, laid out as
    [logit_probs | means | log_scales]; y: (B, T, 1) targets in [-1, 1].
    """
    if log_scale_min is None:
        log_scale_min = LOG_SCALE_MIN
    if y_hat.shape[1] % 3 != 0:
        raise ValueError(f"the head has {y_hat.shape[1]} channels, not a multiple of 3")
    nr_mix = y_hat.shape[1] // 3

    y_hat = y_hat.transpose(1, 2)  # (B, T, C)
    logit_probs = y_hat[:, :, :nr_mix]
    means = y_hat[:, :, nr_mix:2 * nr_mix]
    log_scales = y_hat[:, :, 2 * nr_mix:3 * nr_mix].clamp(min=log_scale_min)

    y = y.expand_as(means)
    centered_y = y - means
    inv_stdv = torch.exp(-log_scales)
    plus_in = inv_stdv * (centered_y + 1.0 / (num_classes - 1))
    cdf_plus = torch.sigmoid(plus_in)
    min_in = inv_stdv * (centered_y - 1.0 / (num_classes - 1))
    cdf_min = torch.sigmoid(min_in)

    log_cdf_plus = plus_in - F.softplus(plus_in)
    log_one_minus_cdf_min = -F.softplus(min_in)
    cdf_delta = cdf_plus - cdf_min

    mid_in = inv_stdv * centered_y
    log_pdf_mid = mid_in - log_scales - 2.0 * F.softplus(mid_in)

    inner_inner = torch.where(cdf_delta > 1e-5, torch.log(cdf_delta.clamp(min=1e-12)),
                              log_pdf_mid - math.log((num_classes - 1) / 2))
    inner = torch.where(y > 0.999, log_one_minus_cdf_min, inner_inner)
    log_probs = torch.where(y < -0.999, log_cdf_plus, inner)

    log_probs = log_probs + F.log_softmax(logit_probs, dim=-1)
    nll = -log_sum_exp(log_probs)
    if reduce:
        return nll.mean()
    return nll[..., None]


def sample_from_discretized_mix_logistic(generator: Optional[torch.Generator], y: Tensor,
                                         log_scale_min: Optional[float] = None,
                                         uniforms: Optional[Tuple[Tensor, Tensor]] = None
                                         ) -> Tensor:
    """Sample in [-1, 1] from a logistic mixture; y is (B, C, T).

    ``uniforms`` injects the two uniform draws, (mixture-select (B, T, nr_mix),
    logistic (B, T)), both already in (1e-5, 1 - 1e-5), so that a test can
    feed this and another implementation the same randomness."""
    if log_scale_min is None:
        log_scale_min = LOG_SCALE_MIN
    if y.shape[1] % 3 != 0:
        raise ValueError(f"the head has {y.shape[1]} channels, not a multiple of 3")
    nr_mix = y.shape[1] // 3
    y = y.transpose(1, 2)  # (B, T, C)
    logit_probs = y[:, :, :nr_mix]

    def uniform(shape):
        u = torch.rand(shape, generator=generator, device=y.device, dtype=y.dtype)
        return 1e-5 + (1.0 - 2e-5) * u

    temp, u = uniforms if uniforms is not None else (uniform(logit_probs.shape), None)
    comp = torch.argmax(logit_probs - torch.log(-torch.log(temp)), dim=-1, keepdim=True)
    means = y[:, :, nr_mix:2 * nr_mix].gather(-1, comp)[..., 0]
    log_scales = y[:, :, 2 * nr_mix:3 * nr_mix].gather(-1, comp)[..., 0].clamp(
        min=log_scale_min)
    if u is None:
        u = uniform(means.shape)
    x = means + torch.exp(log_scales) * (torch.log(u) - torch.log(1.0 - u))
    return x.clamp(-1.0, 1.0)


def marsaglia_tsang_gamma(a: Tensor, u: Tensor) -> Tensor:
    """One Gamma(a, 1) draw per entry of ``a`` from seven uniforms each
    (``u``: a.shape + (7,), in (0, 1)): Box-Muller normals, two unrolled
    tries of the Marsaglia-Tsang squeeze with the fallback ``d`` after a
    double reject, and the a < 1 boost G(a) = G(a + 1)·U^(1/a). The same
    arithmetic as the sample loop's kernel (``csrc/wavernn_generate.cu``)."""
    ab = torch.where(a < 1.0, a + 1.0, a)
    d = ab - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)

    def one_try(un1, un2, uacc):
        x = torch.sqrt(-2.0 * torch.log(un1)) * torch.cos(2.0 * math.pi * un2)
        v = (1.0 + c * x) ** 3
        ok = (v > 0.0) & (torch.log(uacc) < 0.5 * x * x + d - d * v
                          + d * torch.log(v.clamp(min=1e-30)))
        return ok, d * v

    ok1, g1 = one_try(u[..., 0], u[..., 1], u[..., 2])
    ok2, g2 = one_try(u[..., 3], u[..., 4], u[..., 5])
    g = torch.where(ok1, g1, torch.where(ok2, g2, d)).clamp(min=1e-12)
    return torch.where(a < 1.0, g * torch.pow(u[..., 6], 1.0 / a.clamp(min=1e-6)), g)


def sample_from_beta_dist(generator: Optional[torch.Generator], y_hat: Tensor) -> Tensor:
    """Sample in [-1, 1] from a Beta(exp(a), exp(b)) head; y_hat is
    (..., 2) = [log α | log β], each clipped to ±30 before the exponential.
    Beta = Gα / (Gα + Gβ) from two Marsaglia-Tsang gamma draws, 14 uniforms
    in [1e-7, 1 - 1e-7] per sample."""
    alpha = torch.exp(y_hat[..., 0].clamp(-30.0, 30.0))
    beta = torch.exp(y_hat[..., 1].clamp(-30.0, 30.0))
    uniforms = torch.rand(alpha.shape + (14,), generator=generator, device=y_hat.device,
                          dtype=y_hat.dtype).clamp(1e-7, 1.0 - 1e-7)
    ga = marsaglia_tsang_gamma(alpha, uniforms[..., :7])
    gb = marsaglia_tsang_gamma(beta, uniforms[..., 7:])
    return (2.0 * ga / (ga + gb) - 1.0).clamp(-1.0, 1.0)
