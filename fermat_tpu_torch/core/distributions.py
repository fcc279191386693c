"""Random-variable transforms + 2D Gaussian mixtures with EM fitting
(fermat_tpu/core/distributions.py).

Reference analogs:
  * cugar/sampling/distributions.h — uniform/cosine/Pareto/bounded-Pareto/
    bounded-exponential/Cauchy/exponential/Gaussian transforms, each a
    (map, density) pair over a uniform input.
  * cugar/sampling/mixtures.h — Mixture_model of 2D Gaussians.
  * cugar/sampling/em.h — (joint-entropy / stepwise) EM updates of the
    mixture from weighted samples.

Every sampler takes its uniforms explicitly, as JAX's does (draw them with
`torch.rand(..., generator=g)`), so the same uniforms give the same
samples. Everything is elementwise over flat (N,) tensors on their device;
the EM step is one responsibility matrix and weighted moment sums.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

Tensor = torch.Tensor
_SQRT2 = math.sqrt(2.0)
_TWO_PI = 2.0 * math.pi


# ---------------------------------------------------------------------------
# 1D transforms (distributions.h)
# ---------------------------------------------------------------------------

class Uniform:
    """U[0, range)."""

    def __init__(self, r: float = 1.0):
        self.r = r

    def map(self, u):
        return u * self.r

    def density(self, x):
        return torch.where((x >= 0) & (x < self.r), 1.0 / self.r, 0.0)


class Cosine:
    """cos distribution over [-pi/2, pi/2] (distributions.h:124)."""

    def map(self, u):
        return torch.arcsin(torch.clamp(2.0 * u - 1.0, -1.0, 1.0))

    def density(self, x):
        return 0.5 * torch.cos(x)


class Pareto:
    """Pareto with shape a, scale xm (distributions.h:146)."""

    def __init__(self, a: float, xm: float):
        self.a, self.xm = a, xm

    def map(self, u):
        return self.xm / torch.clamp_min(u, 1e-12) ** (1.0 / self.a)

    def density(self, x):
        return torch.where(x >= self.xm, self.a * self.xm ** self.a / x ** (self.a + 1.0), 0.0)


class BoundedPareto:
    """Pareto truncated to [l, h] (distributions.h:182)."""

    def __init__(self, a: float, lo: float, hi: float):
        self.a, self.lo, self.hi = a, lo, hi

    def map(self, u):
        la, ha = self.lo ** self.a, self.hi ** self.a
        return (-(u * ha - u * la - ha) / (ha * la)) ** (-1.0 / self.a)

    def density(self, x):
        la, ha = self.lo ** self.a, self.hi ** self.a
        d = self.a * la * x ** (-self.a - 1.0) / (1.0 - la / ha)
        return torch.where((x >= self.lo) & (x <= self.hi), d, 0.0)


class BoundedExponential:
    """Two-sided bounded exponential over +-[b0, b1] (distributions.h:234)."""

    def __init__(self, b0: float, b1: float):
        self.b0, self.b1 = b0, b1

    def map(self, u):
        s = torch.where(u < 0.5, 1.0, -1.0)
        t = torch.where(u < 0.5, u * 2.0, (u - 0.5) * 2.0)
        ratio = self.b1 / self.b0
        return s * self.b0 * ratio ** t

    def density(self, x):
        a = torch.abs(x)
        ln_r = math.log(self.b1 / self.b0)
        d = 1.0 / (2.0 * a * ln_r)
        return torch.where((a >= self.b0) & (a <= self.b1), d, 0.0)


class Cauchy:
    """Cauchy with scale gamma (distributions.h Cauchy_distribution)."""

    def __init__(self, gamma: float):
        self.gamma = gamma

    def map(self, u):
        return self.gamma * torch.tan(math.pi * (u - 0.5))

    def density(self, x):
        g = self.gamma
        return g / (math.pi * (x * x + g * g))


class Exponential:
    """Exponential with rate lam."""

    def __init__(self, lam: float):
        self.lam = lam

    def map(self, u):
        return -torch.log(torch.clamp_min(1.0 - u, 1e-12)) / self.lam

    def density(self, x):
        return torch.where(x >= 0, self.lam * torch.exp(-self.lam * x), 0.0)


class Gaussian:
    """N(mu, sigma^2) via the inverse-erf transform."""

    def __init__(self, mu: float = 0.0, sigma: float = 1.0):
        self.mu, self.sigma = mu, sigma

    def map(self, u):
        z = torch.erfinv(torch.clamp(2.0 * u - 1.0, -0.999999, 0.999999))
        return self.mu + self.sigma * _SQRT2 * z

    def density(self, x):
        s = self.sigma
        return torch.exp(-0.5 * ((x - self.mu) / s) ** 2) / (s * math.sqrt(_TWO_PI))


# ---------------------------------------------------------------------------
# 2D Gaussian mixture + EM (mixtures.h + em.h)
# ---------------------------------------------------------------------------

class GaussianMixture2D(NamedTuple):
    """K-component 2D Gaussian mixture (Mixture_model analog)."""

    weights: Tensor  # (K,) normalized
    means: Tensor  # (K, 2)
    covs: Tensor  # (K, 2, 2) SPD

    @staticmethod
    def create(k: int, spread: float = 0.25, device="cuda") -> "GaussianMixture2D":
        """Uniformly-spread init over [0,1]^2 (the EM warm start)."""
        g = int(math.ceil(math.sqrt(k)))
        ar = torch.arange(k, device=device)
        xs = ((ar % g).to(torch.float32) + 0.5) / g
        ys = ((ar // g).to(torch.float32) + 0.5) / g
        eye = torch.eye(2, dtype=torch.float32, device=device)
        return GaussianMixture2D(
            weights=torch.full((k,), 1.0 / k, dtype=torch.float32, device=device),
            means=torch.stack([xs, ys], dim=1),
            covs=(eye * spread ** 2).repeat(k, 1, 1),
        )

    @property
    def k(self) -> int:
        return self.weights.shape[0]

    def component_pdf(self, x: Tensor) -> Tensor:
        """(N, K) per-component densities at x (N, 2)."""
        d = x[:, None, :] - self.means[None]  # (N, K, 2)
        inv = torch.linalg.inv(self.covs)  # (K, 2, 2)
        det = torch.clamp_min(torch.linalg.det(self.covs), 1e-20)
        q = torch.einsum("nki,kij,nkj->nk", d, inv, d)
        return torch.exp(-0.5 * q) / (_TWO_PI * torch.sqrt(det))

    def pdf(self, x: Tensor) -> Tensor:
        return torch.sum(self.component_pdf(x) * self.weights[None], dim=1)

    def sample(self, u0: Tensor, u1: Tensor, u2: Tensor) -> Tensor:
        """(N, 2) samples: (u0, u1) a Box-Muller normal pair, u2 the component."""
        cdf = torch.cumsum(self.weights, dim=0)
        k = torch.clamp_max(torch.sum((cdf[None, :] < u2[:, None]).to(torch.int64), dim=1),
                            self.k - 1)
        r = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u0, 1e-12)))
        z = torch.stack([r * torch.cos(_TWO_PI * u1), r * torch.sin(_TWO_PI * u1)], dim=1)
        chol = torch.linalg.cholesky(self.covs)  # (K, 2, 2)
        return self.means[k] + torch.einsum("nij,nj->ni", chol[k], z)


def em_step(mix: GaussianMixture2D, x: Tensor, w: Tensor = None,
            min_var: float = 1e-6) -> GaussianMixture2D:
    """One weighted batch EM update (em.h EM(); the stepwise_E/M pair
    collapses to this in the batch setting). x: (N, 2) samples; w: optional
    (N,) importance weights."""
    n = x.shape[0]
    w = torch.ones(n, dtype=x.dtype, device=x.device) if w is None else w
    resp = mix.component_pdf(x) * mix.weights[None]  # (N, K)
    resp = resp / torch.clamp_min(torch.sum(resp, dim=1, keepdim=True), 1e-20)
    rw = resp * w[:, None]  # (N, K)
    nk = torch.clamp_min(torch.sum(rw, dim=0), 1e-12)  # (K,)
    means = (rw.T @ x) / nk[:, None]  # (K, 2)
    d = x[:, None, :] - means[None]  # (N, K, 2)
    covs = torch.einsum("nk,nki,nkj->kij", rw, d, d) / nk[:, None, None]
    covs = covs + torch.eye(2, dtype=x.dtype, device=x.device) * min_var  # em.h epsilon
    return GaussianMixture2D(weights=nk / torch.sum(nk), means=means, covs=covs)
