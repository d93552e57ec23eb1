"""Standalone offline scorer for tree models, GLMs and DeepLearning — the
port's copy of
``h2o3_tpu/genmodel.py`` (the successor of ``h2o-genmodel``'s
``MojoModel`` + ``EasyPredictModelWrapper``).

Pure numpy, no torch, no JAX, no package import: load a ``.zip`` artifact
(the tmojo format, ``model.json`` + ``arrays.npz``) written by
:func:`h2o3_tpu_torch.models.export.export_mojo` or by the JAX package's
``export_mojo``, and score rows in any Python process.
:func:`~h2o3_tpu_torch.models.export.export_pojo` embeds this file's source
in a single-file scorer, so it must stay standalone.

Tree models (gbm, xgboost, drf, xrt), GLMs (single-response,
multinomial and ordinal, with interaction and hashed columns) and
DeepLearning models (supervised and autoencoder) are scored; the k-means
artifact raises ``NotImplementedError`` until k-means is ported. The tree walk is the numpy
level replay (JAX's native C++ walk, which gives the same bits, is not
bound here).

>>> m = MojoModel.load("gbm.zip")
>>> m.predict({"age": 31, "sex": "F"})           # one row (EasyPredict style)
>>> m.predict(pandas_dataframe)                  # batch
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Mapping

import numpy as np


class MojoModel:
    def __init__(self, meta: dict, arrays: Mapping[str, np.ndarray]):
        self.meta = meta
        self.arrays = dict(arrays)

    # -- loading ----------------------------------------------------------
    @staticmethod
    def load(path: str) -> "MojoModel":
        with zipfile.ZipFile(path) as z:
            meta = json.loads(z.read("model.json"))
            npz = np.load(io.BytesIO(z.read("arrays.npz")), allow_pickle=False)
            arrays = {k: npz[k] for k in npz.files}
        algo = meta["algo"]
        if algo == "kmeans":
            raise NotImplementedError(
                "scoring a kmeans artifact is not ported yet (gbm, xgboost, "
                "drf, xrt, glm and deeplearning only)")
        if algo == "glm":
            return _GlmMojo(meta, arrays)
        if algo == "deeplearning":
            return _DeepLearningMojo(meta, arrays)
        if algo not in ("gbm", "xgboost", "drf", "xrt"):
            raise ValueError(f"unknown algo {algo!r}")
        return _TreeMojo(meta, arrays)

    # -- common surface ---------------------------------------------------
    @property
    def algo(self) -> str:
        return self.meta["algo"]

    @property
    def domain(self):
        return self.meta.get("response_domain")

    def _rows_to_table(self, data) -> dict[str, np.ndarray]:
        """dict row / list-of-dicts / DataFrame → column arrays."""
        if hasattr(data, "to_dict") and hasattr(data, "columns"):  # DataFrame
            return {c: data[c].to_numpy() for c in data.columns}
        if isinstance(data, Mapping):
            vals = list(data.values())
            scalars = all(
                np.ndim(v) == 0 or isinstance(v, (str, bytes)) or v is None
                for v in vals
            )
            if scalars:  # one row, EasyPredict style
                return {k: np.asarray([v]) for k, v in data.items()}
            return {k: np.asarray(v) for k, v in data.items()}  # column table
        if isinstance(data, (list, tuple)) and data and isinstance(data[0], Mapping):
            keys = data[0].keys()
            return {k: np.asarray([row.get(k) for row in data]) for k in keys}
        raise TypeError(f"cannot score {type(data).__name__}")

    def predict(self, data) -> dict[str, np.ndarray]:
        """Returns {"predict": labels-or-values, <class>: prob...} — the
        EasyPredictModelWrapper row API, vectorized."""
        table = self._rows_to_table(data)
        raw = self.score_raw(table)
        dom = self.domain
        if dom is None:
            return {"predict": raw if raw.ndim == 1 else raw[:, 0]}
        if len(dom) == 2 and self.meta.get("default_threshold") is not None:
            # H2O labels binary predictions at the max-F1 threshold, not argmax
            idx = (raw[:, 1] >= float(self.meta["default_threshold"])).astype(int)
        else:
            idx = raw.argmax(axis=1)
        labels = np.asarray(dom, dtype=object)[idx]
        out = {"predict": labels}
        for k, d in enumerate(dom):
            out[str(d)] = raw[:, k]
        cal = self._calibration()
        if cal is not None and raw.shape[1] == 2:
            p1 = np.clip(np.asarray(raw[:, 1], np.float64), 1e-12, 1 - 1e-12)
            if cal["method"] == "PlattScaling":
                eta = np.clip(
                    cal["a"] * np.log(p1 / (1 - p1)) + cal["b"], -30.0, 30.0
                )
                cp1 = 1.0 / (1.0 + np.exp(-eta))
            else:
                cp1 = np.clip(
                    np.interp(p1, cal["thresholds_x"], cal["thresholds_y"]),
                    0.0, 1.0,
                )
            out["cal_p0"] = 1.0 - cp1
            out["cal_p1"] = cp1
        return out

    def _calibration(self) -> dict | None:
        method = self.meta.get("calibration_method")
        if method is None:
            return None
        if method == "PlattScaling":
            a, b = self.meta["calibration_platt"]
            return {"method": method, "a": a, "b": b}
        return {"method": method,
                "thresholds_x": self.arrays["cal_thresholds_x"],
                "thresholds_y": self.arrays["cal_thresholds_y"]}

    def score_raw(self, table: dict[str, np.ndarray]) -> np.ndarray:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# shared numeric helpers


def goes_left(b, na_left_n, cat_hit_n, is_cat_n, thr_n):
    """THE split-decision rule, vectorized over rows (bin 0 = NA): NA rows
    follow na_left, categorical rows follow the gathered mask hit, numeric
    rows go left iff bin <= threshold. Single source for every host-side
    tree walk (offline scorer, leaf-node assignment); mirrors the device
    rule in shared_tree._partition_update."""
    return np.where(b == 0, na_left_n, np.where(is_cat_n, cat_hit_n, b <= thr_n))


def _col_numeric(table, name, n) -> np.ndarray:
    if name not in table:
        return np.full(n, np.nan)
    x = table[name]
    if isinstance(x, np.ndarray) and x.dtype.kind in "fiub":
        return x.astype(np.float64)  # what the loop below gives, at once
    out = np.full(len(x), np.nan)
    for i, v in enumerate(x):
        try:
            if v is not None and v == v:  # not NaN
                out[i] = float(v)
        except (TypeError, ValueError):
            pass
    return out


def _col_codes(table, name, domain, n) -> np.ndarray:
    """Categorical → train-domain codes; unseen/missing → -1."""
    if name not in table:
        return np.full(n, -1, np.int64)
    lut = {d: i for i, d in enumerate(domain)}
    x = table[name]
    return np.asarray([lut.get(v if isinstance(v, str) else str(v), -1)
                       if v is not None and v == v else -1 for v in x], np.int64)


def _col_hash_buckets(table, name, n_buckets, n) -> np.ndarray:
    """Hashed categorical → bucket codes (missing → -1): ``crc32(name \\0
    level) % n_buckets`` from the raw level string, the rule of
    ``models.datainfo._hash_lut``; the artifact ships no domain."""
    import zlib

    if name not in table:
        return np.full(n, -1, np.int64)
    prefix = name.encode() + b"\x00"
    return np.asarray(
        [zlib.crc32(prefix + (v if isinstance(v, str) else str(v)).encode())
         % n_buckets if v is not None and v == v else -1
         for v in table[name]], np.int64)


def _n_rows(table: dict) -> int:
    return len(next(iter(table.values())))


def _softmax(z):
    z = z - z.max(axis=1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=1, keepdims=True)


# ---------------------------------------------------------------------------
# tree models


class _TreeMojo(MojoModel):
    """Replays the recorded level arrays — CompressedTree.score0 successor."""

    def _bin_features(self, table) -> np.ndarray:
        names = self.meta["names"]
        n = _n_rows(table)
        is_cat = self.arrays["bin_is_cat"]
        nbins = self.arrays["bin_nbins"]
        edges = self.arrays["bin_edges"]
        doms = self.meta["bin_domains"]
        cols = []
        for ci, name in enumerate(names):
            if is_cat[ci]:
                codes = _col_codes(table, name, doms[ci] or (), n)
                b = np.clip(codes + 1, 0, int(nbins[ci]))
            else:
                # Bin in float32 with float32 edges — bit-identical to the
                # device path (binning.bin_frame searchsorts f32), so bin
                # codes match exactly even for edge-adjacent values.
                x = _col_numeric(table, name, n).astype(np.float32)
                e = edges[ci][: max(int(nbins[ci]) - 1, 0)].astype(np.float32)
                b = np.searchsorted(e, x, side="left") + 1
                b[np.isnan(x)] = 0
            cols.append(b.astype(np.int64))
        return np.stack(cols, axis=1)

    def leaf_node_assignment(self, table, type: str = "Path") -> dict[str, np.ndarray]:
        """Terminal leaf per (row, tree, class) — the EasyPredict
        leafNodeAssignment analog, offline. Returns {column name ->
        array}: decision-path strings (type="Path") or node ids in the
        level-flattened numbering the in-cluster
        ``predict_leaf_node_assignment`` uses (type="Node_ID")."""
        if type not in ("Path", "Node_ID"):
            raise ValueError(f"type must be 'Path' or 'Node_ID', got {type!r}")
        bins = self._bin_features(table)
        n = bins.shape[0]
        K = self.meta["n_tree_classes"]
        rows = np.arange(n)
        a = self.arrays
        out: dict[str, np.ndarray] = {}
        for ti, class_levels in enumerate(self.meta["tree_levels"]):
            for ki in range(K):
                n_levels = class_levels[ki]
                nid = np.zeros(n, np.int64)
                term = np.zeros(n, np.int64)
                steps = np.full((n, max(n_levels, 1)), "", dtype="<U1")
                offset = 0
                for li in range(n_levels):
                    pre = f"t{ti}_k{ki}_l{li}_"
                    split_col = a[pre + "split_col"]
                    leaf_now = a[pre + "leaf_now"]
                    active = nid >= 0
                    node = np.where(active, nid, 0)
                    retired = leaf_now[node] & active
                    term = np.where(retired, offset + node, term)
                    b = bins[rows, split_col[node]]
                    go_left = goes_left(
                        b, a[pre + "na_left"][node],
                        a[pre + "cat_mask"][node, b],
                        a[pre + "is_cat"][node], a[pre + "split_bin"][node],
                    )
                    walking = active & ~retired
                    steps[walking, li] = np.where(go_left[walking], "L", "R")
                    child = a[pre + "child_base"][node] + np.where(go_left, 0, 1)
                    nid = np.where(walking, child, -1)
                    offset += len(split_col)
                name = f"T{ti + 1}.C{ki + 1}"
                if type == "Node_ID":
                    out[name] = term
                else:
                    out[name] = np.array(["".join(r) for r in steps], dtype=object)
        return out

    def _forest_sums(self, bins, n: int, K: int, shapes) -> np.ndarray:
        """(n, K) leaf sums over the forest by numpy level replay: float32
        leaves accumulated into float64, tree by tree in export order."""
        F = np.zeros((n, K), np.float64)
        for ti, class_levels in enumerate(shapes):
            for ki in range(K):
                F[:, ki] += self._walk_tree(bins, ti, ki, class_levels[ki])
        return F

    def _walk_tree(self, bins: np.ndarray, ti: int, ki: int, n_levels: int) -> np.ndarray:
        n = bins.shape[0]
        nid = np.zeros(n, np.int64)
        preds = np.zeros(n, np.float64)
        a = self.arrays
        for li in range(n_levels):
            pre = f"t{ti}_k{ki}_l{li}_"
            split_col = a[pre + "split_col"]
            split_bin = a[pre + "split_bin"]
            is_cat = a[pre + "is_cat"]
            cat_mask = a[pre + "cat_mask"]
            na_left = a[pre + "na_left"]
            leaf_now = a[pre + "leaf_now"]
            leaf_val = a[pre + "leaf_val"].astype(np.float64)
            child_base = a[pre + "child_base"]

            active = nid >= 0
            node = np.where(active, nid, 0)
            col = split_col[node]
            b = bins[np.arange(n), col]
            go_left = goes_left(b, na_left[node], cat_mask[node, b],
                                is_cat[node], split_bin[node])
            child = child_base[node] + np.where(go_left, 0, 1)
            retired = leaf_now[node]
            preds += np.where(active & retired, leaf_val[node], 0.0)
            nid = np.where(active, np.where(retired, -1, child), -1)
        return preds

    def score_raw(self, table) -> np.ndarray:
        bins = self._bin_features(table)
        K = self.meta["n_tree_classes"]
        shapes = self.meta["tree_levels"]
        n = bins.shape[0]
        F = self._forest_sums(bins, n, K, shapes)

        if self.algo in ("drf", "xrt"):
            avg = F / max(self.meta["ntrees_actual"], 1)
            if self.domain is None:
                return avg[:, 0]
            if len(self.domain) == 2:
                p1 = np.clip(avg[:, 0], 0.0, 1.0)
                return np.stack([1 - p1, p1], axis=1)
            P = np.clip(avg, 1e-9, None)
            return P / P.sum(axis=1, keepdims=True)

        # gbm
        dist = self.meta["distribution"]
        init_f = self.meta["init_f"]
        if dist == "multinomial":
            return _softmax(F + np.asarray(init_f)[None, :])
        f = F[:, 0] + (init_f if np.isscalar(init_f) else init_f)
        if dist == "bernoulli":
            mu = 1.0 / (1.0 + np.exp(-f))
            return np.stack([1 - mu, mu], axis=1)
        if dist in ("poisson", "gamma", "tweedie"):
            return np.exp(f)
        return f


# ---------------------------------------------------------------------------
# GLM — a design-matrix model


def _design_matrix(meta_di: dict, table) -> np.ndarray:
    """The DataInfo transform in float64: categoricals one-hot on the
    training domain (unseen and NA levels all-zero), hashed categoricals
    one-hot on their buckets, numerics imputed with the training mean and
    standardized, the interaction columns (cat×cat one-hot on the combined
    code, num×num the standardized product, cat×num the one-hot block
    times the numeric; NAs imputed with the training means), the
    intercept column last."""
    n = _n_rows(table)
    base = 0 if meta_di["use_all_factor_levels"] else 1

    def onehot(codes, width):
        return ((codes - base)[:, None]
                == np.arange(width)[None, :]).astype(np.float64)

    cols = []
    for c in meta_di["columns"]:
        if c.get("pair"):
            a, b = c["pair"]
            if c.get("pair_domains"):  # cat × cat: the combined code
                da, db = c["pair_domains"]
                ca = _col_codes(table, a, da, n)
                cb = _col_codes(table, b, db, n)
                codes = np.where((ca >= 0) & (cb >= 0), ca * len(db) + cb, -1)
                cols.append(onehot(codes, c["width"]))
                continue
            ma, mb = c.get("pair_means") or (0.0, 0.0)
            xb = _col_numeric(table, b, n)
            xb = np.where(np.isnan(xb), mb, xb)
            if c["kind"] == "num":  # num × num: the product
                xa = _col_numeric(table, a, n)
                x = np.where(np.isnan(xa), ma, xa) * xb
                if meta_di["standardize"]:
                    x = (x - c["mean"]) / c["sigma"]
                cols.append(x[:, None])
            else:  # cat × num: the one-hot block times the numeric
                codes = _col_codes(table, a, c["domain"], n)
                cols.append(onehot(codes, c["width"]) * xb[:, None])
        elif c["kind"] == "hash":
            buckets = _col_hash_buckets(table, c["name"],
                                        int(meta_di["hash_buckets"]), n)
            cols.append(onehot(buckets, c["width"]))
        elif c["kind"] == "cat":
            codes = _col_codes(table, c["name"], c["domain"], n)
            cols.append(onehot(codes, c["width"]))
        else:
            x = _col_numeric(table, c["name"], n)
            x = np.where(np.isnan(x), c["mean"], x)
            if meta_di["standardize"]:
                x = (x - c["mean"]) / c["sigma"]
            cols.append(x[:, None])
    if meta_di["add_intercept"]:
        cols.append(np.ones((n, 1)))
    return np.concatenate(cols, axis=1)


class _GlmMojo(MojoModel):
    def score_raw(self, table) -> np.ndarray:
        X = _design_matrix(self.meta["datainfo"], table)
        if "beta_multinomial_std" in self.arrays:  # (P, K)
            B = self.arrays["beta_multinomial_std"].astype(np.float64)
            return _softmax(X @ B)
        if "theta" in self.arrays:  # ordinal: proportional-odds cumulatives
            eta = X @ self.arrays["beta_std"].astype(np.float64)
            theta = self.arrays["theta"].astype(np.float64)
            cum = 1.0 / (1.0 + np.exp(-(theta[None, :] - eta[:, None])))
            lo = np.concatenate([np.zeros((len(eta), 1)), cum], axis=1)
            hi = np.concatenate([cum, np.ones((len(eta), 1))], axis=1)
            return np.clip(hi - lo, 1e-12, 1.0)
        eta = X @ self.arrays["beta_std"].astype(np.float64)
        mu = _link_inverse(self.meta["family"],
                           self.meta.get("link", "family_default"), eta,
                           self.meta.get("tweedie_link_power", 1.0))
        if self.domain is not None:
            return np.stack([1 - mu, mu], axis=1)
        return mu


class _DeepLearningMojo(MojoModel):
    """The MLP on the float64 design: ``W{i}`` (in, out) and ``b{i}`` per
    layer, the activation between layers; softmax for a classifier, the
    first output for a regression, every output (the reconstruction) for
    an autoencoder."""

    def score_raw(self, table) -> np.ndarray:
        h = _design_matrix(self.meta["datainfo"], table)
        tanh = "tanh" in self.meta["activation"].lower()
        L = self.meta["n_layers"]
        for i in range(L):
            h = (h @ self.arrays[f"W{i}"].astype(np.float64)
                 + self.arrays[f"b{i}"].astype(np.float64))
            if i < L - 1:
                h = np.tanh(h) if tanh else np.maximum(h, 0.0)
        if self.meta.get("autoencoder"):
            return h
        if self.domain is not None:
            return _softmax(h)
        return h[:, 0]


def _link_inverse(family: str, link: str, eta, tweedie_link_power: float):
    if link == "family_default":
        link = {"gaussian": "identity", "binomial": "logit",
                "fractionalbinomial": "logit", "quasibinomial": "logit",
                "poisson": "log", "gamma": "inverse", "negativebinomial": "log",
                "tweedie": "tweedie"}.get(family, "identity")
    if link == "identity":
        return eta
    if link == "logit":
        return 1.0 / (1.0 + np.exp(-eta))
    if link == "log":
        return np.exp(eta)
    if link == "inverse":
        return 1.0 / np.where(np.abs(eta) < 1e-12, 1e-12, eta)
    if link == "tweedie":
        p = tweedie_link_power
        return np.power(np.maximum(eta, 1e-12), 1.0 / p) if p != 0 else np.exp(eta)
    raise ValueError(f"unknown link {link!r}")
