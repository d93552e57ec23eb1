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
