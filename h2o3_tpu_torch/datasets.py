"""Seeded synthetic frames for smoke runs and measurements."""

from __future__ import annotations

import numpy as np
import pandas as pd


def higgs_like(n: int, c: int = 28, seed: int = 0) -> pd.DataFrame:
    """The headline frame of ``bench.py``'s ``make_data``: ``c`` standard-
    normal float32 features and a binary label ('s'/'b') drawn from a
    logistic model of the first six, with interactions."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, c)).astype(np.float32)
    eta = (1.5 * X[:, 0] - X[:, 1] + 0.8 * X[:, 2] * X[:, 3]
           + np.sin(2 * X[:, 4]) + 0.5 * X[:, 5] ** 2 - 1.0)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-eta))).astype(np.int32)
    df = pd.DataFrame(X, columns=[f"f{i}" for i in range(c)])
    df["label"] = np.where(y == 1, "s", "b")
    return df


def claims_like(n: int, c: int = 28, seed: int = 0) -> pd.DataFrame:
    """An insurance-claims frame for tweedie GBMs: ``c`` standard-normal
    float32 features (as ``higgs_like``) and a compound Poisson–Gamma claim
    amount ``claim``. The claim count is Poisson with log-rate
    ``log(0.09) + 0.5·f0 - 0.4·f1`` (about 90% of rows claim nothing), each
    claim a Gamma(shape 2) severity with log-mean ``1 + 0.2·f0``, so the
    expected amount rises in ``f0`` and falls in ``f1``."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, c)).astype(np.float32)
    rate = 0.09 * np.exp(0.5 * X[:, 0] - 0.4 * X[:, 1])
    counts = rng.poisson(rate)
    shape = 2.0
    scale = np.exp(1.0 + 0.2 * X[:, 0]) / shape
    amount = rng.gamma(shape * np.maximum(counts, 1), scale)
    df = pd.DataFrame(X, columns=[f"f{i}" for i in range(c)])
    df["claim"] = np.where(counts > 0, amount, 0.0).astype(np.float32)
    return df
