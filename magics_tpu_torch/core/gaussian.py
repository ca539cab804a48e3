"""Information-form multivariate Gaussian (counterpart of magics_tpu's
core/gaussian.py; gbp_multivariate_normal parity).

Reference: crates/gbp_multivariate_normal/src/lib.rs:38-210 — a Gaussian
stored as (information vector eta, precision matrix Lambda), constructible
from either parameterisation, with product/division by information
addition/subtraction. The GBP hot path does NOT use this type (it inlines
eta/Lambda fields, like the reference's factorgraph does); it exists as the
user-facing numerics API.

Batched: eta [..., D], lam [..., D, D]; all ops broadcast over leading axes.
Tensors stay on the device they were given; a singular matrix raises
`NotPositiveSemiDefinite`, as the JAX package's non-finite inverse does.
"""

from __future__ import annotations

import dataclasses

import torch


class NotPositiveSemiDefinite(ValueError):
    """Raised when a precision/covariance matrix is not invertible PSD
    (lib.rs error enum)."""


def _inv(m: torch.Tensor) -> torch.Tensor:
    inv, info = torch.linalg.inv_ex(m)
    if bool((info != 0).any()) or not bool(torch.isfinite(inv).all()):
        raise NotPositiveSemiDefinite("matrix is singular")
    return inv


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", m, v)


@dataclasses.dataclass(frozen=True)
class MultivariateNormal:
    """N(mu, Sigma) stored as (eta = Lambda mu, Lambda = Sigma^-1)."""

    eta: torch.Tensor  # [..., D]
    lam: torch.Tensor  # [..., D, D]

    # -- constructors (lib.rs:63-160) -----------------------------------

    @classmethod
    def from_information_and_precision(cls, eta, lam) -> "MultivariateNormal":
        eta = torch.as_tensor(eta)
        lam = torch.as_tensor(lam)
        _inv(lam)  # validate invertibility like the reference constructor
        return cls(eta=eta, lam=lam)

    @classmethod
    def from_mean_and_covariance(cls, mean, cov) -> "MultivariateNormal":
        mean = torch.as_tensor(mean)
        lam = _inv(torch.as_tensor(cov))
        return cls(eta=_mv(lam, mean), lam=lam)

    @classmethod
    def from_mean_and_precision(cls, mean, lam) -> "MultivariateNormal":
        mean = torch.as_tensor(mean)
        lam = torch.as_tensor(lam)
        _inv(lam)
        return cls(eta=_mv(lam, mean), lam=lam)

    # -- accessors (lib.rs:168-210) -------------------------------------

    @property
    def dims(self) -> int:
        return self.eta.shape[-1]

    def mean(self) -> torch.Tensor:
        return _mv(_inv(self.lam), self.eta)

    def covariance(self) -> torch.Tensor:
        return _inv(self.lam)

    def information_vector(self) -> torch.Tensor:
        return self.eta

    def precision_matrix(self) -> torch.Tensor:
        return self.lam

    # -- algebra: product/quotient of Gaussians = info add/subtract ------

    def __mul__(self, other: "MultivariateNormal") -> "MultivariateNormal":
        return MultivariateNormal(self.eta + other.eta, self.lam + other.lam)

    def __truediv__(self, other: "MultivariateNormal") -> "MultivariateNormal":
        return MultivariateNormal(self.eta - other.eta, self.lam - other.lam)

    def add_assign_information(self, eta, lam) -> "MultivariateNormal":
        return MultivariateNormal(self.eta + eta, self.lam + lam)
