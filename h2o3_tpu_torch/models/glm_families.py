"""GLM families and links on tensors — the port of
``h2o3_tpu/models/glm_families.py``.

Each family gives, for tensors on any device: the link (inverse, its
derivative dmu/deta, forward), the variance of mu, the deviance
``(y, mu, w) -> scalar`` and an initial-mu rule, closing over its fixed
hyperparameters (tweedie powers, the negative-binomial theta). The
arithmetic follows the JAX module operation for operation, so the two
agree to float32 rounding; every function is differentiable by
``torch.autograd`` (the L-BFGS objective).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

_EPS = 1e-10


def _clip01(x):
    return torch.clamp(x, _EPS, 1.0 - _EPS)


def _sigmoid(e):
    return 1.0 / (1.0 + torch.exp(-e))


def _nonzero(e):
    return torch.where(torch.abs(e) < _EPS, torch.full_like(e, _EPS), e)


@dataclass(frozen=True)
class Link:
    name: str
    inv: Callable  # eta -> mu
    dinv: Callable  # eta -> dmu/deta
    fwd: Callable  # mu -> eta


LINKS = {
    "identity": Link("identity", lambda e: e, torch.ones_like, lambda m: m),
    "log": Link("log", torch.exp, torch.exp,
                lambda m: torch.log(torch.clamp(m, min=_EPS))),
    "logit": Link(
        "logit",
        lambda e: _clip01(_sigmoid(e)),
        lambda e: torch.clamp(_sigmoid(e) * (1 - _sigmoid(e)), min=_EPS),
        lambda m: torch.log(_clip01(m) / (1 - _clip01(m))),
    ),
    "inverse": Link(
        "inverse",
        lambda e: 1.0 / _nonzero(e),
        lambda e: -1.0 / torch.square(_nonzero(e)),
        lambda m: 1.0 / _nonzero(m),
    ),
}


def tweedie_link(link_power: float) -> Link:
    if link_power == 0:
        return LINKS["log"]
    lp = float(link_power)
    return Link(
        f"tweedie_{lp}",
        lambda e: torch.clamp(e, min=_EPS) ** (1.0 / lp),
        lambda e: (1.0 / lp) * torch.clamp(e, min=_EPS) ** (1.0 / lp - 1.0),
        lambda m: torch.clamp(m, min=_EPS) ** lp,
    )


@dataclass(frozen=True)
class Family:
    name: str
    link: Link
    variance: Callable  # mu -> var
    deviance: Callable  # (y, mu, w) -> scalar
    init_mu: Callable  # (y, w) -> mu0 tensor
    dispersion_fixed: bool  # True => dispersion 1 (binomial/poisson)


def _dev_gaussian(y, mu, w):
    return torch.sum(w * (y - mu) ** 2)


def _dev_binomial(y, mu, w):
    mu = _clip01(mu)
    return -2.0 * torch.sum(w * (y * torch.log(mu)
                                 + (1 - y) * torch.log(1 - mu)))


def _dev_poisson(y, mu, w):
    mu = torch.clamp(mu, min=_EPS)
    t = torch.where(y > 0, y * torch.log(torch.clamp(y, min=_EPS) / mu), 0.0)
    return 2.0 * torch.sum(w * (t - (y - mu)))


def _dev_gamma(y, mu, w):
    mu = torch.clamp(mu, min=_EPS)
    ys = torch.clamp(y, min=_EPS)
    return 2.0 * torch.sum(w * (-torch.log(ys / mu) + (ys - mu) / mu))


def _dev_tweedie(p: float):
    def dev(y, mu, w):
        mu = torch.clamp(mu, min=_EPS)
        ys = torch.clamp(y, min=0.0)
        if p == 1.0:
            return _dev_poisson(y, mu, w)
        if p == 2.0:
            return _dev_gamma(y, mu, w)
        t1 = torch.where(ys > 0, ys ** (2.0 - p) / ((1.0 - p) * (2.0 - p)),
                         0.0)
        t2 = ys * mu ** (1.0 - p) / (1.0 - p)
        t3 = mu ** (2.0 - p) / (2.0 - p)
        return 2.0 * torch.sum(w * (t1 - t2 + t3))

    return dev


def _dev_negbinomial(theta: float):
    def dev(y, mu, w):
        mu = torch.clamp(mu, min=_EPS)
        ys = torch.clamp(y, min=0.0)
        it = 1.0 / theta
        t1 = torch.where(ys > 0,
                         ys * torch.log(torch.clamp(ys, min=_EPS) / mu), 0.0)
        t2 = (ys + it) * torch.log((ys + it) / (mu + it))
        return 2.0 * torch.sum(w * (t1 - t2))

    return dev


def _wmean(y, w):
    return torch.sum(w * y) / torch.clamp(torch.sum(w), min=_EPS)


_DEFAULT_LINK = {
    "gaussian": "identity",
    "binomial": "logit",
    "quasibinomial": "logit",
    "fractionalbinomial": "logit",
    "poisson": "log",
    "gamma": "inverse",
    "tweedie": "tweedie",
    "negativebinomial": "log",
}


def get_family(
    name: str,
    link: str = "family_default",
    tweedie_variance_power: float = 1.5,
    tweedie_link_power: float = 0.0,
    theta: float = 1e-5,
) -> Family:
    name = name.lower()
    lname = (_DEFAULT_LINK[name] if link in ("family_default", None)
             else link.lower())
    if name == "tweedie" or lname == "tweedie":
        lk = tweedie_link(tweedie_link_power)
    else:
        lk = LINKS[lname]

    if name == "gaussian":
        return Family(name, lk, torch.ones_like, _dev_gaussian, _wmean, False)
    if name in ("binomial", "quasibinomial", "fractionalbinomial"):
        return Family(
            name, lk,
            lambda m: torch.clamp(_clip01(m) * (1 - _clip01(m)), min=_EPS),
            _dev_binomial,
            lambda y, w: torch.clamp(_wmean(y, w), 0.01, 0.99)
            * torch.ones_like(y),
            name == "binomial",
        )
    if name == "poisson":
        return Family(
            name, lk, lambda m: torch.clamp(m, min=_EPS), _dev_poisson,
            lambda y, w: torch.clamp(_wmean(y, w), min=0.1)
            * torch.ones_like(y),
            True,
        )
    if name == "gamma":
        return Family(
            name, lk, lambda m: torch.clamp(m, min=_EPS) ** 2, _dev_gamma,
            lambda y, w: torch.clamp(_wmean(y, w), min=_EPS)
            * torch.ones_like(y),
            False,
        )
    if name == "tweedie":
        p = float(tweedie_variance_power)
        return Family(
            name, lk, lambda m: torch.clamp(m, min=_EPS) ** p,
            _dev_tweedie(p),
            lambda y, w: torch.clamp(_wmean(y, w), min=0.1)
            * torch.ones_like(y),
            False,
        )
    if name == "negativebinomial":
        th = float(theta)
        return Family(
            name, lk,
            lambda m: torch.clamp(m, min=_EPS)
            + th * torch.clamp(m, min=_EPS) ** 2,
            _dev_negbinomial(th),
            lambda y, w: torch.clamp(_wmean(y, w), min=0.1)
            * torch.ones_like(y),
            False,
        )
    raise ValueError(f"unknown family {name}")
