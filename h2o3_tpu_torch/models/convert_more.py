"""Models carried across: a K-means, PCA, SVD, GLRM, naive Bayes,
isolation forest, extended isolation forest or decision tree trained by
the JAX package, handed over as numpy, becomes the port's model, which
predicts what the JAX model predicts.

The caller turns the JAX model's ``output`` into plain numpy and Python
values first (this package never imports JAX), keeping its keys; a
``datainfo`` becomes its spec as plain values (the tmojo's ``datainfo``
meta: the flags, ``ncols_expanded``, ``hash_buckets`` and per column its
name, kind, offset, width, mean, sigma and domain), and a decision tree's
``bin_spec`` and trees take the form ``tree.convert.drf_from_numpy``
reads. ``params`` (a dict of builder parameters) sets those fields of the
model's parameters; the rest keep their defaults. Device tensors of the
model (a decision tree's levels, GLRM's ``x_factor``) go to ``device``
(``cuda`` unless given).
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.device import resolve
from h2o3_tpu_torch.models.datainfo import DataInfo
from h2o3_tpu_torch.models.extended_isolation_forest import (
    ExtendedIsolationForestModel,
    ExtendedIsolationForestParams,
)
from h2o3_tpu_torch.models.glrm import GLRMModel, GLRMParams
from h2o3_tpu_torch.models.isolation_forest import (
    IsolationForestModel,
    IsolationForestParams,
)
from h2o3_tpu_torch.models.kmeans import KMeansModel, KMeansParams
from h2o3_tpu_torch.models.naive_bayes import NaiveBayesModel, NaiveBayesParams
from h2o3_tpu_torch.models.pca import PCAModel, PCAParams, SVDModel, SVDParams
from h2o3_tpu_torch.models.tree.convert import _forest
from h2o3_tpu_torch.models.tree.decision_tree import DTModel, DTParams


def _with_di(output: dict) -> dict:
    out = dict(output)
    out["datainfo"] = DataInfo.from_meta(output["datainfo"])
    out["response_domain"] = None
    return out


def kmeans_from_numpy(output: dict, params: dict | None = None
                      ) -> KMeansModel:
    """A port k-means model from a JAX one's ``output`` (``datainfo``,
    ``centers_std``, ``centers``, ``names``, ``k``, ``size``)."""
    out = _with_di(output)
    out["centers_std"] = np.asarray(output["centers_std"], np.float32)
    out["centers"] = np.asarray(output["centers"], np.float32)
    return KMeansModel(None, KMeansParams(**(params or {})), out)


def pca_from_numpy(output: dict, params: dict | None = None) -> PCAModel:
    """A port PCA model from a JAX one's ``output`` (``datainfo``,
    ``eigenvectors``, ``eigenvalues`` and the variance tables)."""
    out = _with_di(output)
    out["eigenvectors"] = np.asarray(output["eigenvectors"], np.float64)
    return PCAModel(None, PCAParams(**(params or {})), out)


def svd_from_numpy(output: dict, params: dict | None = None) -> SVDModel:
    """A port SVD model from a JAX one's ``output`` (``datainfo``, ``v``,
    ``d``)."""
    out = _with_di(output)
    out["v"] = np.asarray(output["v"], np.float64)
    out["d"] = np.asarray(output["d"], np.float64)
    return SVDModel(None, SVDParams(**(params or {})), out)


def glrm_from_numpy(output: dict, device=None, params: dict | None = None
                    ) -> GLRMModel:
    """A port GLRM model from a JAX one's ``output`` (``names``,
    ``archetypes``, ``x_factor``, ``means``, ``sigmas``, ``objective``);
    ``x_factor`` goes to ``device``."""
    out = dict(output, response_domain=None)
    out["archetypes"] = np.asarray(output["archetypes"], np.float32)
    out["x_factor"] = torch.from_numpy(
        np.array(output["x_factor"], np.float32)).to(resolve(device))
    out["means"] = np.asarray(output["means"], np.float64)
    out["sigmas"] = np.asarray(output["sigmas"], np.float64)
    return GLRMModel(None, GLRMParams(**(params or {})), out)


def naive_bayes_from_numpy(output: dict, params: dict | None = None
                           ) -> NaiveBayesModel:
    """A port naive Bayes model from a JAX one's ``output`` (``priors``,
    ``num_stats``, ``cat_stats``, ``names``, ``response_domain``)."""
    f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
    out = {
        "priors": f64(output["priors"]),
        "num_stats": {c: {"mean": f64(s["mean"]), "sdev": f64(s["sdev"])}
                      for c, s in output["num_stats"].items()},
        "cat_stats": {c: {"domain": tuple(s["domain"]),
                          "counts": f64(s["counts"]), "cond": f64(s["cond"])}
                      for c, s in output["cat_stats"].items()},
        "names": list(output["names"]),
        "response_domain": tuple(output["response_domain"]),
    }
    return NaiveBayesModel(None, NaiveBayesParams(**(params or {})), out)


def iforest_from_numpy(output: dict, params: dict | None = None
                       ) -> IsolationForestModel:
    """A port isolation forest from a JAX one's ``output`` (``trees``: per
    tree its (feat, thr, leaf_len) level arrays, ``names``,
    ``feature_domains``); ``params`` should carry its ``sample_size``."""
    out = dict(output, response_domain=None)
    out["trees"] = [(np.asarray(f, np.int32), np.asarray(t, np.float32),
                     np.asarray(ll, np.float32))
                    for f, t, ll in output["trees"]]
    return IsolationForestModel(
        None, IsolationForestParams(**(params or {})), out)


def eif_from_numpy(output: dict, params: dict | None = None
                   ) -> ExtendedIsolationForestModel:
    """A port extended isolation forest from a JAX one's ``output``
    (``stacked_trees``: per tree its levels' (normals, intercepts,
    is_leaf, lens), ``names``, ``col_means``, ``sample_size``)."""
    out = dict(output, response_domain=None)
    out["col_means"] = np.asarray(output["col_means"], np.float64)
    out["stacked_trees"] = [
        [(np.asarray(n, np.float32), np.asarray(d, np.float32),
          np.asarray(lf, bool), np.asarray(ln, np.float32))
         for n, d, lf, ln in levels] for levels in output["stacked_trees"]]
    return ExtendedIsolationForestModel(
        None, ExtendedIsolationForestParams(**(params or {})), out)


def dt_from_numpy(output: dict, device=None, params: dict | None = None
                  ) -> DTModel:
    """A port decision tree from a JAX one's ``output`` in the form of
    ``tree.convert.drf_from_numpy`` (``bin_spec``, ``trees`` of one tree,
    ``names``, ``response_domain``), its levels on ``device``."""
    return DTModel(None, DTParams(**(params or {})),
                   _forest(output, resolve(device)))
