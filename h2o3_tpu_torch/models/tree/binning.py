"""Quantile feature binning — the port of ``h2o3_tpu/models/tree/binning.py``
(``BinSpec``, ``fit_bins``, ``bin_frame`` with its u8 code cache, the
shape-bucket ladder, and exclusive feature bundling: ``EFBPlan``,
``fit_efb``, ``bundle_bins``, ``expand_arrays``, ``expand_hist``).

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


def _u8_cache_enabled() -> bool:
    return config.get_bool("H2O3_TPU_TREE_U8CACHE")


def _spec_fingerprint(spec: BinSpec) -> tuple:
    """The content of a BinSpec (JAX's ``_spec_fingerprint``, with the
    device in place of the backend): equal fingerprints bin a frame to the
    same codes."""
    doms = tuple(tuple(d) if d is not None else None
                 for d in (spec.domains or [None] * spec.ncols))
    return (tuple(spec.names), spec.is_cat.tobytes(), spec.nbins.tobytes(),
            spec.edges.tobytes(), doms)


def bin_frame(spec: BinSpec, frame: Frame) -> torch.Tensor:
    """All feature columns binned to a (nrow, C) uint8 matrix on the
    frame's device.

    Under ``H2O3_TPU_TREE_U8CACHE`` (the default) the matrix is memoized on
    the frame, keyed by the spec's fingerprint: a hit returns the same
    tensor. The entry also holds the spec's columns, and a hit needs each
    to be the frame's column of that name still: a column replaced by
    ``Frame.__setitem__`` misses (JAX keys by the spec alone and returns
    the replaced column's codes)."""
    cache = key = None
    if _u8_cache_enabled():
        key = (_spec_fingerprint(spec), str(frame.device))
        cache = frame.__dict__.setdefault("_bin_cache", {})
        hit = cache.get(key)
        if hit is not None:
            vecs, B = hit
            if all(v is frame.vec(n) for v, n in zip(vecs, spec.names)):
                return B
            del cache[key]
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
    B = torch.stack(cols, dim=1).contiguous()
    if cache is not None:
        cache[key] = (tuple(frame.vec(n) for n in spec.names), B)
    return B


# ---------------------------------------------------------------------------
# exclusive feature bundling (JAX's ``H2O3_TPU_TREE_EFB``, arXiv:1706.08359
# section 4): columns that sit at one dominant code almost everywhere and
# whose non-default rows never overlap share one u8 bundle column (their
# non-default codes in disjoint sub-ranges). The plan is a greedy host pass
# over the codes with zero conflicts allowed; kernel B1 accumulates over
# the bundled columns and :func:`expand_hist` maps the histogram back to
# the real columns right after, the default cell rebuilt as the node total
# less the non-default cells (exact on integer stats, within float32
# associativity otherwise).


@dataclass
class EFBPlan:
    """The bundling plan of one BinSpec."""

    n_cols: int          # real feature count C
    n_bins: int          # code space per column (spec.max_bins)
    bundles: list        # real column ids per bundled column
    src_col: np.ndarray  # (C,) int32: the bundled column carrying column f
    offset: np.ndarray   # (C,) int32: column f's code offset in its bundle
    default: np.ndarray  # (C,) int32: dominant code; -1 = passed through
    nbins: np.ndarray    # (C,) int32: non-default code count per column

    @property
    def n_cols_b(self) -> int:
        return len(self.bundles)

    @property
    def key(self) -> tuple:
        """Hashable content fingerprint (the whole-tree plan's key)."""
        return (self.n_cols, self.n_bins, self.src_col.tobytes(),
                self.offset.tobytes(), self.default.tobytes(),
                self.nbins.tobytes())


# fit_efb's calls, their host seconds and the columns they removed
EFB_EVENTS = {"fits": 0, "fit_seconds": 0.0, "plans": 0,
              "cols_bundled": 0}


def fit_efb(spec: BinSpec, bins_u8, nrow: int | None = None):
    """Greedy zero-conflict bundling over the frame's codes, read to the
    host once (JAX's ``fit_efb``). Returns an :class:`EFBPlan` when
    bundling removes a column, else None."""
    import time

    t0 = time.perf_counter()
    B_host = (bins_u8.cpu().numpy() if isinstance(bins_u8, torch.Tensor)
              else np.asarray(bins_u8))
    if nrow is not None:
        B_host = B_host[:nrow]
    try:
        return _fit_efb(spec, B_host)
    finally:
        EFB_EVENTS["fits"] += 1
        EFB_EVENTS["fit_seconds"] += time.perf_counter() - t0


def _fit_efb(spec: BinSpec, B_host: np.ndarray):
    n, C = B_host.shape
    if C != spec.ncols or n == 0:
        return None
    total_codes = spec.max_bins
    # dominant code and non-default rows per column (columns non-default
    # on more than half the rows can hardly bundle and pass through)
    dominant = np.zeros(C, np.int32)
    nz_masks: list = [None] * C
    order: list[int] = []
    for f in range(C):
        codes, counts = np.unique(B_host[:, f], return_counts=True)
        d = int(codes[np.argmax(counts)])
        nnz = n - int(counts.max())
        if nnz > n // 2 or int(spec.nbins[f]) + 1 > total_codes:
            continue
        dominant[f] = d
        nz_masks[f] = B_host[:, f] != d
        order.append(f)
    order.sort(key=lambda f: int(nz_masks[f].sum()))

    src_col = np.zeros(C, np.int32)
    offset = np.zeros(C, np.int32)
    default = np.full(C, -1, np.int32)
    nbins_nd = np.asarray(spec.nbins, np.int32).copy()
    bundles: list[list[int]] = []
    occ: list[np.ndarray] = []   # rows occupied per bundle
    used: list[int] = []         # codes used per bundle
    multi: set[int] = set()      # bundles of more than one column
    for f in order:
        need = int(nbins_nd[f])
        placed = False
        for bi in range(len(bundles)):
            if used[bi] + need > total_codes - 1:
                continue
            if np.any(occ[bi] & nz_masks[f]):
                continue
            src_col[f], offset[f], default[f] = bi, used[bi], dominant[f]
            bundles[bi].append(f)
            occ[bi] |= nz_masks[f]
            used[bi] += need
            multi.add(bi)
            placed = True
            break
        if not placed:
            src_col[f], offset[f], default[f] = len(bundles), 0, dominant[f]
            bundles.append([f])
            occ.append(nz_masks[f].copy())
            used.append(need)
    for f in range(C):  # the dense or wide columns pass through
        if nz_masks[f] is None:
            src_col[f] = len(bundles)
            bundles.append([f])
            occ.append(np.zeros(0, bool))
            used.append(0)
    # a column alone in its bundle is passed through unchanged
    for bi, group in enumerate(bundles):
        if bi not in multi and len(group) == 1:
            default[group[0]] = -1
            offset[group[0]] = 0
    if len(bundles) >= C:
        return None
    EFB_EVENTS["plans"] += 1
    EFB_EVENTS["cols_bundled"] += C - len(bundles)
    return EFBPlan(C, total_codes, bundles, src_col, offset, default,
                   nbins_nd)


def bundle_bins(plan: EFBPlan, bins_u8: torch.Tensor) -> torch.Tensor:
    """The (n, Cb) bundled u8 codes, on ``bins_u8``'s device. Bundle code 0
    is every member at its default; member f's code c != d_f maps to
    ``offset_f + rank_f(c)``, the rank skipping d_f (1..nbins_f). Passed-
    through columns are copied."""
    cols = []
    for group in plan.bundles:
        if len(group) == 1 and plan.default[group[0]] < 0:
            cols.append(bins_u8[:, group[0]])
            continue
        acc = torch.zeros(bins_u8.shape[0], dtype=torch.int32,
                          device=bins_u8.device)
        for f in group:
            c = bins_u8[:, f].to(torch.int32)
            d = int(plan.default[f])
            rank = torch.where(c < d, c + 1, c)
            acc = acc + torch.where(c == d, 0, int(plan.offset[f]) + rank)
        cols.append(acc.to(torch.uint8))
    return torch.stack(cols, dim=1).contiguous()


def expand_arrays(plan: EFBPlan, n_cols_pad: int, n_bins_h: int) -> tuple:
    """The (Cp,) and (Cp, Bh) gather tables :func:`expand_hist` reads, as
    numpy: ``kind`` 0 = a cell that is always zero, 1 = gathered from
    ``src_bin`` of the carrying bundle column, 2 = the default cell (node
    total less the non-default cells). Pad columns (f >= C) hold all of a
    node's mass in bin 0, as all-NA pad columns do."""
    Cp, Bh = n_cols_pad, n_bins_h
    src_col = np.zeros(Cp, np.int64)
    src_bin = np.zeros((Cp, Bh), np.int64)
    kind = np.zeros((Cp, Bh), np.int8)
    for f in range(plan.n_cols):
        src_col[f] = plan.src_col[f]
        ncodes = int(plan.nbins[f]) + 1
        d = int(plan.default[f])
        for b in range(min(ncodes, Bh)):
            if d < 0:
                src_bin[f, b] = b
                kind[f, b] = 1
            elif b == d:
                kind[f, b] = 2
            else:
                src_bin[f, b] = int(plan.offset[f]) + (b + 1 if b < d else b)
                kind[f, b] = 1
    for f in range(plan.n_cols, Cp):
        kind[f, 0] = 2
    return src_col, src_bin, kind


def expand_hist(arrs, hist_b: torch.Tensor) -> torch.Tensor:
    """A bundled histogram (N, Cb, Bh, S) expanded to the real columns
    (N, Cp, Bh, S); ``arrs`` are :func:`expand_arrays`' tables as tensors
    on the histogram's device. The node totals are any bundle column's bin
    sums (every row has one code in every column)."""
    src_col, src_bin, kind = arrs
    g = hist_b.index_select(1, src_col)                     # (N, Cp, Bh, S)
    G = g.gather(2, src_bin[None, :, :, None].expand(g.shape))
    node_tot = hist_b[:, 0].sum(dim=1)                      # (N, S)
    gather = (kind == 1)[None, :, :, None]
    dflt = node_tot[:, None, :] - torch.where(gather, G, 0.0).sum(dim=2)
    return torch.where(gather, G, torch.where(
        (kind == 2)[None, :, :, None], dflt[:, :, None, :], 0.0))
