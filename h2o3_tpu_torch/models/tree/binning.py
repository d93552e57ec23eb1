"""Quantile feature binning — the port of ``h2o3_tpu/models/tree/binning.py``
(``BinSpec``, ``fit_bins``, ``bin_frame``, the shape-bucket ladder).

Bin layout per column: code 0 = NA, codes 1..nbins = data bins. Numeric
columns bin by quantile edges (right-inclusive, stored for predict-time
rebinning); categorical columns by ``code + 1``, the tail clamped into the
last bin past the ``nbins_cats`` cap.

Edges follow the JAX package's split by device: on the CPU, numpy
quantiles over the host column (a seeded ``rng.choice`` sample past
``sample`` rows); on the GPU, one device program over an evenly strided
row sample (:func:`_device_quantile_edges`) with float32 interpolation,
so only (C, nbins-1) edges come back to the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from h2o3_tpu_torch import config
from h2o3_tpu_torch.frame.frame import Frame, Vec

MAX_BINS = 255  # codes 1..255 fit uint8 with 0 reserved for NA


def bucket_nbins(n_bins: int) -> int:
    """Histogram bin-axis bucket: next power of two (min 8, cap 256)."""
    if not config.get_bool("H2O3_TPU_SHAPE_BUCKETS") or n_bins >= 256:
        return n_bins
    b = 8
    while b < n_bins:
        b <<= 1
    return b


def bucket_cols(n_cols: int) -> int:
    """Feature-axis bucket: next multiple of 4 (min 4)."""
    if not config.get_bool("H2O3_TPU_SHAPE_BUCKETS"):
        return n_cols
    return max(4, -(-n_cols // 4) * 4)


@dataclass
class BinSpec:
    """Fitted binning for one frame's feature set."""

    names: list[str]
    is_cat: np.ndarray  # (C,) bool
    nbins: np.ndarray  # (C,) int, data bins per column (excl. the NA bin)
    edges: np.ndarray  # (C, MAX_BINS-1) float32 right-inclusive edges, +inf padded
    cards: np.ndarray  # (C,) categorical cardinality (0 for numeric)
    domains: list | None = None  # train-time categorical domains

    @property
    def ncols(self) -> int:
        return len(self.names)

    @property
    def max_bins(self) -> int:
        return int(self.nbins.max()) + 1  # +1 for the NA bin 0


def _device_quantile_edges(X: torch.Tensor, nbins: int):
    """Per-column quantile edges of a (ns, Cn) float32 sample, computed where
    ``X`` lives: sort (NaN last), float32 positions ``q·(m-1)`` and linear
    interpolation between the neighbouring order statistics — the arithmetic
    of the JAX program, so both give the same float32 edges."""
    xs = torch.sort(X, dim=0).values  # NaN sorts to the end
    m = (~torch.isnan(X)).sum(dim=0).to(torch.int32)  # (Cn,)
    q = torch.from_numpy(_linspace_f32(nbins + 1)[1:-1]).to(X.device)
    mm1 = torch.clamp(m[:, None] - 1, min=0)
    pos = q[None, :] * mm1.to(torch.float32)  # (Cn, nbins-1)
    lo = torch.floor(pos).to(torch.int64)
    frac = pos - lo.to(torch.float32)
    hi = torch.minimum(lo + 1, mm1.to(torch.int64))
    xt = xs.T
    # XLA fuses ``g(lo)·(1-frac) + g(hi)·frac`` into fma(g(lo), 1-frac,
    # round(g(hi)·frac)); a float32 product is exact in float64, so the
    # float64 sum rounded once to float32 reproduces that fma
    e = (torch.gather(xt, 1, lo).double() * (1 - frac).double()
         + (torch.gather(xt, 1, hi) * frac).double())
    return e.to(torch.float32), m


def _linspace_f32(num: int) -> np.ndarray:
    """``jnp.linspace(0.0, 1.0, num)`` as XLA evaluates it in float32:
    ``i * (1 / (num-1))`` (the division by a constant becomes a product
    with its rounded reciprocal), with the end point exact."""
    i = np.arange(num, dtype=np.float32)
    out = i * (np.float32(1.0) / np.float32(num - 1))
    out[-1] = 1.0
    return out


def fit_bins(frame: Frame, cols: list[str], nbins: int = MAX_BINS,
             sample: int = 200_000, seed: int = 7,
             nbins_cats: int | None = None) -> BinSpec:
    """Per-column quantile edges from (a sample of) the data."""
    nbins = min(nbins, MAX_BINS)
    C = len(cols)
    is_cat = np.zeros(C, bool)
    nb = np.zeros(C, np.int64)
    edges = np.full((C, MAX_BINS - 1), np.inf, np.float32)
    cards = np.zeros(C, np.int64)
    domains: list = [None] * C
    rng = np.random.default_rng(seed)

    numeric: list[int] = []
    for ci, name in enumerate(cols):
        v = frame.vec(name)
        if v.is_categorical():
            is_cat[ci] = True
            cards[ci] = v.cardinality
            cap = MAX_BINS if nbins_cats is None else min(nbins_cats, MAX_BINS)
            nb[ci] = min(v.cardinality, max(cap, 1))
            domains[ci] = v.domain
        else:
            numeric.append(ci)

    if numeric and frame.device.type != "cpu":
        nrow = frame.nrow
        ns = min(nrow, sample)
        idx = torch.from_numpy(
            np.round(np.linspace(0, nrow - 1, ns)).astype(np.int64)
        ).to(frame.device)
        X = torch.stack([frame.vec(cols[ci]).data[idx] for ci in numeric], dim=1)
        e_dev, m = _device_quantile_edges(X, nbins)
        e_dev, m = e_dev.cpu().numpy(), m.cpu().numpy()
        for row, ci in enumerate(numeric):
            if m[row] == 0:
                nb[ci] = 1
                continue
            e = np.unique(e_dev[row].astype(np.float32))
            e = e[np.isfinite(e)]
            nb[ci] = len(e) + 1
            edges[ci, : len(e)] = e
    else:
        for ci in numeric:
            x = frame.vec(cols[ci]).to_numpy()
            x = x[~np.isnan(x)]
            if len(x) == 0:
                nb[ci] = 1
                continue
            if len(x) > sample:
                x = rng.choice(x, sample, replace=False)
            qs = np.quantile(x, np.linspace(0, 1, nbins + 1)[1:-1])
            e = np.unique(qs.astype(np.float32))
            nb[ci] = len(e) + 1
            edges[ci, : len(e)] = e
    return BinSpec(list(cols), is_cat, nb, edges, cards, domains)


def _adapt_codes(v: Vec, train_domain) -> torch.Tensor:
    """Categorical codes remapped onto the training domain; unseen levels
    map to NA (-1)."""
    if v.domain == tuple(train_domain):
        return v.data
    lut = {d: i for i, d in enumerate(train_domain)}
    remap = np.full(len(v.domain or ()) + 1, -1, dtype=np.int64)
    for j, d in enumerate(v.domain or ()):
        remap[j] = lut.get(d, -1)
    remap_dev = torch.from_numpy(remap).to(v.device)
    codes = v.data.long()
    return torch.where(codes >= 0, remap_dev[codes.clamp(min=0)], -1)


def bin_frame(spec: BinSpec, frame: Frame) -> torch.Tensor:
    """All feature columns binned to a (nrow, C) uint8 matrix on the
    frame's device."""
    cols = []
    edges = torch.from_numpy(spec.edges).to(frame.device)
    for ci, name in enumerate(spec.names):
        v = frame.vec(name)
        nbi = int(spec.nbins[ci])
        if spec.is_cat[ci]:
            dom = spec.domains[ci] if spec.domains else v.domain
            d = _adapt_codes(v, dom).long()
            cols.append(torch.clamp(d + 1, 0, nbi).to(torch.uint8))
        else:
            d = v.data
            e = edges[ci, : max(nbi - 1, 0)].contiguous()
            b = torch.searchsorted(e, d, side="left").to(torch.int32) + 1
            b = torch.where(torch.isnan(d), 0, b)
            cols.append(b.to(torch.uint8))
    return torch.stack(cols, dim=1).contiguous()
