"""Weights carried across: a GBM, XGBoost, DRF or XRT trained by the JAX
package, handed over as numpy, becomes a port model
(:class:`~h2o3_tpu_torch.models.tree.gbm.GBMModel`,
:class:`~h2o3_tpu_torch.models.tree.xgboost.XGBoostModel`,
:class:`~h2o3_tpu_torch.models.tree.drf.DRFModel`) that predicts what the
JAX model predicts. A cross-validated JAX model's ``cv_models`` carry
across one by one, each through the same call.

The caller turns the JAX objects into plain numpy first (this package never
imports JAX), as a dict shaped like the JAX ``GBMModel.output``:

- ``bin_spec``: ``{"names", "is_cat", "nbins", "edges", "cards", "domains"}``
  — the ``BinSpec`` fields as arrays and lists;
- ``trees``: ``trees[iter][class]`` is a list of per-level dicts holding the
  replay fields (``split_col``, ``split_bin``, ``is_cat``, ``cat_mask``,
  ``na_left``, ``leaf_now``, ``leaf_val``, ``child_base``): one class per
  iteration, or K for multinomial;
- ``init_f`` (a float, or the K-vector for multinomial), ``distribution``,
  ``names``, ``response_domain``, and ``n_tree_classes`` (1 if absent);
  DRF and XRT outputs have no ``init_f`` and no ``distribution``;
- optionally ``varimp`` (the (C,) importances), ``calibration`` (the
  fitted calibrator's dict) and, per level, ``node_w`` and ``gain`` (the
  covers TreeSHAP reads).

``params`` (a dict of builder parameters, such as ``offset_column`` or
``response_column``) sets those fields of the model's parameters; the
rest keep their defaults.

:func:`te_from_numpy` makes a port ``TargetEncoder`` from a JAX encoder's
fitted tables, and :func:`isotonic_from_numpy` a port isotonic model from
a JAX one's knots; both hold host numpy only and run on the device of the
frame they are given.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.device import resolve
from h2o3_tpu_torch.models.isotonic import (
    IsotonicRegressionModel,
    IsotonicRegressionParams,
)
from h2o3_tpu_torch.models.target_encoding import TargetEncoder
from h2o3_tpu_torch.models.tree.binning import BinSpec
from h2o3_tpu_torch.models.tree.distributions import DISTRIBUTIONS
from h2o3_tpu_torch.models.tree.drf import DRFModel, DRFParams, XRTModel
from h2o3_tpu_torch.models.tree.gbm import GBMModel, GBMParams
from h2o3_tpu_torch.models.tree.shared_tree import (
    REPLAY_FIELDS,
    Tree,
    TreeLevel,
)
from h2o3_tpu_torch.models.tree.xgboost import XGBoostModel, XGBoostParams


def gbm_from_numpy(output: dict, device=None, algo: str = "gbm",
                   params: dict | None = None) -> GBMModel:
    """A port GBMModel (``algo="xgboost"``: an XGBoostModel) from a numpy
    copy of a JAX GBM's or XGBoost's ``output``, with its trees on
    ``device`` (``cuda`` unless given) and ``params`` set on its
    parameters."""
    cls, params_cls = {"gbm": (GBMModel, GBMParams),
                   "xgboost": (XGBoostModel, XGBoostParams)}[algo]
    if output["distribution"] not in DISTRIBUTIONS:
        raise NotImplementedError(
            f"distribution {output['distribution']!r} is not ported yet")
    out = _forest(output, resolve(device))
    K = out["n_tree_classes"]
    init_f = output["init_f"]
    out.update(distribution=output["distribution"],
               init_f=(np.asarray(init_f, np.float32) if K > 1
                       else float(init_f)))
    return cls(None, params_cls(**(params or {})), out)


def drf_from_numpy(output: dict, device=None, algo: str = "drf",
                   params: dict | None = None) -> DRFModel:
    """A port DRFModel (``algo="xrt"``: an XRT model) from a numpy copy of
    a JAX DRF's or XRT's ``output``, with its trees on ``device`` (``cuda``
    unless given) and ``params`` set on its parameters."""
    cls = {"drf": DRFModel, "xrt": XRTModel}[algo]
    return cls(None, DRFParams(**(params or {})),
               _forest(output, resolve(device)))


def te_from_numpy(stats: dict, prior: float, y: str,
                  params: dict | None = None) -> TargetEncoder:
    """A port TargetEncoder from a JAX encoder's fitted state: ``stats``
    its ``_stats`` (column -> (level counts, level target sums, domain)),
    ``prior`` its ``_prior``, ``y`` its ``_y``, ``params`` its parameters
    as a dict."""
    te = TargetEncoder(**(params or {}))
    te._stats = {c: (np.asarray(cnt, np.float64), np.asarray(ssum, np.float64),
                     tuple(dom)) for c, (cnt, ssum, dom) in stats.items()}
    te._prior = float(prior)
    te._y = y
    return te


def isotonic_from_numpy(output: dict, params: dict | None = None
                        ) -> IsotonicRegressionModel:
    """A port isotonic model from a JAX one's ``output`` (``feature``,
    ``thresholds_x``, ``thresholds_y``) and its parameters as a dict."""
    out = {"feature": output["feature"],
           "thresholds_x": np.asarray(output["thresholds_x"], np.float64),
           "thresholds_y": np.asarray(output["thresholds_y"], np.float64),
           "names": [output["feature"]], "response_domain": None}
    return IsotonicRegressionModel(
        None, IsotonicRegressionParams(**(params or {})), out)


def spec_from_numpy(bs: dict) -> BinSpec:
    """A ``BinSpec`` from its fields as arrays and lists."""
    return BinSpec(
        names=list(bs["names"]),
        is_cat=np.asarray(bs["is_cat"], bool),
        nbins=np.asarray(bs["nbins"], np.int64),
        edges=np.asarray(bs["edges"], np.float32),
        cards=np.asarray(bs["cards"], np.int64),
        domains=[None if d is None else tuple(d) for d in bs["domains"]]
        if bs.get("domains") is not None else None,
    )


def _forest(output: dict, dev) -> dict:
    """The fields tree models share: the bin spec, the trees on ``dev``,
    the names and the response domain."""
    K = int(output.get("n_tree_classes", 1))
    spec = spec_from_numpy(output["bin_spec"])
    trees = []
    for group in output["trees"]:
        if len(group) != K:
            raise ValueError(f"an iteration holds {len(group)} trees, "
                             f"n_tree_classes is {K}")
        trees.append([_tree(levels, dev) for levels in group])
    dom = output.get("response_domain")
    out = {
        "bin_spec": spec,
        "trees": trees,
        "n_tree_classes": K,
        "names": list(output["names"]),
        "varimp": (None if output.get("varimp") is None
                   else np.asarray(output["varimp"], np.float64)),
        "response_domain": None if dom is None else tuple(dom),
        "ntrees_actual": len(trees),
    }
    cal = output.get("calibration")
    if cal is not None:
        out["calibration"] = {k: (np.asarray(v, np.float64)
                                  if k.startswith("thresholds") else v)
                              for k, v in cal.items()}
    return out


def _tree(levels, dev) -> Tree:
    tree = Tree()
    for lv in levels:
        fields = {f: torch.as_tensor(np.ascontiguousarray(lv[f]), device=dev)
                  for f in REPLAY_FIELDS}
        for f in ("gain", "node_w"):  # the covers TreeSHAP reads
            if lv.get(f) is not None:
                fields[f] = torch.as_tensor(
                    np.ascontiguousarray(lv[f], np.float32), device=dev)
        tree.levels.append(TreeLevel(**fields))
    return tree
