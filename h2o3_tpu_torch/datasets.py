"""Seeded synthetic frames for smoke runs and measurements: a Higgs-like
binomial frame, an insurance-claims frame for tweedie, an ordered-response
frame for ordinal GLM, a frame with the published shape of Covertype for
multinomial, one with the published columns of the airline on-time
data for GLM on categoricals, an MNIST-shaped frame for DeepLearning
made on the frame's device, and one with the published columns of the
Santander Customer Transaction Prediction data for AutoML."""

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


# the ordinal frame's true proportional-odds model: coefficients of the
# first eight features (the other twenty are noise) and the four cuts
ORDINAL_BETA = (1.0, -0.8, 0.6, -0.4, 0.3, -0.2, 0.1, 0.05)
ORDINAL_CUTS = (-2.5, -0.8, 0.8, 2.5)


def ordinal_like(n: int, c: int = 28, seed: int = 0) -> pd.DataFrame:
    """An ordered-response frame for ordinal GLMs: the ``higgs_like``
    features (``c`` standard-normal float32 columns, the same draws for
    the same ``seed``) and a 5-level categorical ``rating`` ("1" < ... <
    "5"), cut at :data:`ORDINAL_CUTS` from the proportional-odds latent
    ``x·beta_true + logistic noise`` with ``beta_true`` =
    :data:`ORDINAL_BETA` on the first eight features and 0 on the rest, so
    that ``P(rating <= j) = sigmoid(cut_j - x·beta_true)``: an
    unstandardized ordinal GLM recovers ``beta_true`` and the cuts."""
    X = higgs_like(n, c, seed).drop(columns="label").to_numpy()
    beta = np.zeros(c)
    beta[: len(ORDINAL_BETA)] = ORDINAL_BETA[:c]
    rng = np.random.default_rng([seed, 1])
    latent = X.astype(np.float64) @ beta + rng.logistic(size=n)
    level = np.searchsorted(np.asarray(ORDINAL_CUTS), latent)
    df = pd.DataFrame(X, columns=[f"f{i}" for i in range(c)])
    df["rating"] = pd.Categorical.from_codes(
        level, categories=[str(k) for k in range(1, len(ORDINAL_CUTS) + 2)])
    return df


# Covertype's published class shares (%), classes 1..7
COVTYPE_SHARES = (36.5, 48.8, 6.2, 0.5, 1.6, 3.0, 3.5)


COVTYPE_ROWS = 581_012


def covtype_like(n: int = COVTYPE_ROWS, seed: int = 0) -> pd.DataFrame:
    """A multiclass frame with the published shape of the UCI Covertype
    data (581,012 rows, 54 integer features, 7 classes): 10 terrain columns
    on Covertype's ranges (elevation 1859-3858 m, aspect 0-360°, slope
    0-66°, the distances to hydrology, roadways and fire points, the three
    hillshades as integers 0-255), 4 wilderness-area and 40 soil-type 0/1
    columns, one-hot within each group, and a categorical ``cover_type``
    ("1".."7"). The label is the argmax of a per-class score: a Gaussian
    bump in elevation around the class's typical height, seeded effects of
    the wilderness area and soil type, a slope and a hydrology term, and
    Gumbel noise; per-class offsets are then fit so the class shares land
    within 0.2 points of Covertype's (36.5, 48.8, 6.2, 0.5, 1.6, 3.0, 3.5
    %). Made with numpy from ``seed``; nothing is downloaded."""
    rng = np.random.default_rng(seed)
    elev = np.clip(rng.normal(2959, 280, n), 1859, 3858)
    aspect = rng.integers(0, 361, n)
    slope = np.clip(rng.gamma(3.0, 4.7, n), 0, 66)
    h_hyd = np.clip(rng.exponential(270, n), 0, 1397)
    v_hyd = np.clip(rng.normal(46, 58, n), -173, 601)
    h_road = np.clip(rng.gamma(1.8, 1300, n), 0, 7117)
    shade9 = np.clip(rng.normal(212, 27, n), 0, 255)
    shade12 = np.clip(rng.normal(223, 20, n), 0, 255)
    shade3 = np.clip(rng.normal(143, 38, n), 0, 255)
    h_fire = np.clip(rng.gamma(1.9, 1040, n), 0, 7173)
    wild = rng.choice(4, n, p=[0.45, 0.05, 0.44, 0.06])
    # soil types follow elevation bands, with spread
    soil = np.clip(((elev - 1859) / 2000 * 40 + rng.normal(0, 5, n))
                   .astype(np.int64), 0, 39)

    mu = np.array([3130, 2920, 2390, 2220, 2790, 2420, 3360], np.float64)
    sd = np.array([150, 170, 180, 90, 110, 170, 110], np.float64)
    score = -0.5 * ((elev[:, None] - mu) / sd) ** 2
    score += rng.normal(0, 0.7, (4, 7))[wild] + rng.normal(0, 0.5, (40, 7))[soil]
    score[:, [2, 5]] += 0.03 * slope[:, None]
    score[:, 3] += 1.5 * (h_hyd < 150)
    score += rng.gumbel(size=(n, 7))
    target = np.asarray(COVTYPE_SHARES) / sum(COVTYPE_SHARES)
    bias = np.zeros(7)
    for _ in range(20):
        share = np.bincount(np.argmax(score + bias, axis=1), minlength=7) / n
        bias += np.log(target / np.maximum(share, 1.0 / n))
    label = np.argmax(score + bias, axis=1)

    cols = {"elevation": elev, "aspect": aspect, "slope": slope,
            "horizontal_distance_to_hydrology": h_hyd,
            "vertical_distance_to_hydrology": v_hyd,
            "horizontal_distance_to_roadways": h_road,
            "hillshade_9am": shade9, "hillshade_noon": shade12,
            "hillshade_3pm": shade3,
            "horizontal_distance_to_fire_points": h_fire}
    df = pd.DataFrame({k: np.rint(v).astype(np.int16) for k, v in cols.items()})
    onehot = {f"wilderness_area{i + 1}": wild == i for i in range(4)}
    onehot.update({f"soil_type{i + 1}": soil == i for i in range(40)})
    df = pd.concat([df, pd.DataFrame({k: v.astype(np.int8)
                                      for k, v in onehot.items()})], axis=1)
    df["cover_type"] = pd.Categorical.from_codes(
        label, categories=[str(k) for k in range(1, 8)])
    return df


# the 29 carrier codes of the ASA Data Expo 2009 airline data (1987-2008)
AIRLINE_CARRIERS = (
    "9E", "AA", "AQ", "AS", "B6", "CO", "DH", "DL", "EA", "EV", "F9", "FL",
    "HA", "HP", "ML", "MQ", "NW", "OH", "OO", "PA (1)", "PI", "PS", "TW",
    "TZ", "UA", "US", "WN", "XE", "YV")


def airlines_like(n: int, seed: int = 0, n_airports: int = 300) -> pd.DataFrame:
    """A frame with the published columns of the ASA Data Expo 2009
    airline on-time data (1987-2008), from which H2O's airlines demo frames
    come: numeric Year, Month, DayofMonth, DayOfWeek, CRSDepTime and
    CRSArrTime (hhmm), Distance (miles); categorical UniqueCarrier (the 29
    carriers), Origin and Dest (``n_airports`` three-letter codes each,
    Zipf-skewed: the busiest airport takes ~16% of flights); and the
    response IsDepDelayed ("NO"/"YES") from a logit of the carrier, the
    departure hour, the distance, the weekend and the two airports'
    effects (about half delayed). About 2% of CRSDepTime is NA. The
    airport codes and every effect come from a fixed seed, so frames of
    any ``n`` and ``seed`` share their domains and their model; the rows
    are drawn from ``seed`` with numpy. Nothing is downloaded."""
    fixed = np.random.default_rng(2009)
    letters = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ"))
    codes = fixed.choice(26 ** 3, n_airports, replace=False)
    airports = sorted("".join(letters[[c // 676, c // 26 % 26, c % 26]])
                      for c in codes)
    carrier_eff = fixed.normal(0.0, 0.35, len(AIRLINE_CARRIERS))
    origin_eff = fixed.normal(0.0, 0.3, n_airports)
    dest_eff = fixed.normal(0.0, 0.2, n_airports)
    zipf = 1.0 / np.arange(1, n_airports + 1)
    zipf /= zipf.sum()
    hub_rank = fixed.permutation(n_airports)  # which code is how busy

    rng = np.random.default_rng(seed)
    year = rng.integers(1987, 2009, n)
    month = rng.integers(1, 13, n)
    mdays = np.array([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31])
    day = (rng.random(n) * mdays[month - 1]).astype(np.int64) + 1
    dow = rng.integers(1, 8, n)
    hour = np.clip(np.rint(rng.normal(13.0, 4.2, n)), 5, 23).astype(np.int64)
    minute = rng.integers(0, 12, n) * 5
    dep = hour * 100 + minute
    dist = np.clip(np.rint(rng.lognormal(6.4, 0.6, n)), 31, 4962)
    dur = (dist / 7.5 + 25.0).astype(np.int64)  # minutes in the air
    arr_min = (hour * 60 + minute + dur) % 1440
    arr = (arr_min // 60) * 100 + arr_min % 60
    carrier = rng.integers(0, len(AIRLINE_CARRIERS), n)
    origin = hub_rank[rng.choice(n_airports, n, p=zipf)]
    dest = hub_rank[rng.choice(n_airports, n, p=zipf)]
    eta = (carrier_eff[carrier] + 0.09 * (hour - 13) + 0.0002 * (dist - 700)
           + 0.25 * (dow >= 6) + origin_eff[origin] + dest_eff[dest]
           + 0.15 * np.isin(month, (6, 7, 12)) - 0.25)
    delayed = rng.random(n) < 1.0 / (1.0 + np.exp(-eta))
    crs_dep = dep.astype(np.float32)
    crs_dep[rng.random(n) < 0.02] = np.nan

    return pd.DataFrame({
        "Year": year.astype(np.int16),
        "Month": month.astype(np.int8),
        "DayofMonth": day.astype(np.int8),
        "DayOfWeek": dow.astype(np.int8),
        "CRSDepTime": crs_dep,
        "CRSArrTime": arr.astype(np.int16),
        "UniqueCarrier": pd.Categorical.from_codes(
            carrier, categories=list(AIRLINE_CARRIERS)),
        "Origin": pd.Categorical.from_codes(origin, categories=airports),
        "Dest": pd.Categorical.from_codes(dest, categories=airports),
        "Distance": dist.astype(np.int16),
        "IsDepDelayed": pd.Categorical.from_codes(
            delayed.astype(np.int8), categories=["NO", "YES"]),
    })


SANTANDER_ROWS, SANTANDER_VARS = 200_000, 200
SANTANDER_POSITIVE = 0.1005  # the published train.csv's share of target 1


def santander_like(n: int = SANTANDER_ROWS, seed: int = 0) -> pd.DataFrame:
    """A frame with the published columns of the Kaggle Santander Customer
    Transaction Prediction ``train.csv`` (2019: 200,000 rows): a string
    ``ID_code`` ("train_0", ...), which no model uses, a categorical
    ``target`` ("0"/"1", as H2O users ``asfactor()`` it) and 200 float32
    columns ``var_0`` .. ``var_199``, each with its own mean and scale
    drawn from ``seed``. The target comes from a logistic model in which
    every column adds a weak term (a linear one and a smaller quadratic
    one of the standardized column), with the intercept set so that about
    10.05% of rows are positive, as in the published file: no single
    column separates the classes, and a GBM's AUC stays well below 1.
    The frame is generated with numpy; it is not the real data, which
    cannot be downloaded here."""
    rng = np.random.default_rng(seed)
    c = SANTANDER_VARS
    mean = rng.normal(5.0, 10.0, c)
    scale = np.clip(rng.lognormal(np.log(3.0), 1.0, c), 0.1, 25.0)
    lin = rng.normal(0.0, 0.12, c)
    quad = rng.normal(0.0, 0.05, c)
    Z = rng.standard_normal((n, c), dtype=np.float32)
    eta = Z @ lin.astype(np.float32) + (Z * Z - 1.0) @ quad.astype(np.float32)
    eta = eta.astype(np.float64)
    lo, hi = -10.0, 10.0  # the intercept for the published positive share
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if np.mean(1.0 / (1.0 + np.exp(-(eta + mid)))) < SANTANDER_POSITIVE:
            lo = mid
        else:
            hi = mid
    p1 = 1.0 / (1.0 + np.exp(-(eta + 0.5 * (lo + hi))))
    y = (rng.random(n) < p1).astype(np.int8)
    X = Z * scale.astype(np.float32) + mean.astype(np.float32)
    df = pd.DataFrame(X, columns=[f"var_{j}" for j in range(c)])
    df.insert(0, "target", pd.Categorical.from_codes(y, categories=["0", "1"]))
    df.insert(0, "ID_code", np.array([f"train_{i}" for i in range(n)],
                                     dtype=object))
    return df


def mnist_like(n: int, d: int = 784, k: int = 10, seed: int = 5,
               device=None):
    """The JAX bench's DeepLearning frame (``bench.py``'s ``_bench_dl``):
    ``n`` rows of ``d`` standard-normal float32 features ``p0..p{d-1}``
    and a categorical ``label`` ("0".."{k-1}"), the argmax of ``X @ W``
    for a standard-normal ``W`` (d, k), in full float32. Made on the
    frame's device (``cuda`` unless given) by a ``torch.Generator`` seeded
    by ``seed``, so nothing crosses from the host; the CPU and the card
    draw different numbers for the same seed. Returns a ``Frame``."""
    import torch

    from h2o3_tpu_torch.device import resolve
    from h2o3_tpu_torch.frame.frame import CAT, NUM, Frame, Vec
    from h2o3_tpu_torch.ops.gram import full_fp32

    dev = resolve(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    Xt = torch.randn((d, n), generator=gen, device=dev)  # a row per column
    W = torch.randn((d, k), generator=gen, device=dev)
    with full_fp32():
        label = torch.argmax(Xt.t() @ W, dim=1).to(torch.int8)
    vecs = [Vec(Xt[j], NUM) for j in range(d)]
    vecs.append(Vec(label, CAT, domain=[str(i) for i in range(k)]))
    return Frame(vecs, [f"p{j}" for j in range(d)] + ["label"])
