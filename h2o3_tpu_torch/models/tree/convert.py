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
  DRF and XRT outputs have no ``init_f`` and no ``distribution``.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.device import resolve
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


def gbm_from_numpy(output: dict, device=None, algo: str = "gbm") -> GBMModel:
    """A port GBMModel (``algo="xgboost"``: an XGBoostModel) from a numpy
    copy of a JAX GBM's or XGBoost's ``output``, with its trees on
    ``device`` (``cuda`` unless given)."""
    cls, params = {"gbm": (GBMModel, GBMParams),
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
    return cls(None, params(), out)


def drf_from_numpy(output: dict, device=None, algo: str = "drf") -> DRFModel:
    """A port DRFModel (``algo="xrt"``: an XRT model) from a numpy copy of
    a JAX DRF's or XRT's ``output``, with its trees on ``device`` (``cuda``
    unless given)."""
    cls = {"drf": DRFModel, "xrt": XRTModel}[algo]
    return cls(None, DRFParams(), _forest(output, resolve(device)))


def _forest(output: dict, dev) -> dict:
    """The fields tree models share: the bin spec, the trees on ``dev``,
    the names and the response domain."""
    K = int(output.get("n_tree_classes", 1))
    bs = output["bin_spec"]
    spec = BinSpec(
        names=list(bs["names"]),
        is_cat=np.asarray(bs["is_cat"], bool),
        nbins=np.asarray(bs["nbins"], np.int64),
        edges=np.asarray(bs["edges"], np.float32),
        cards=np.asarray(bs["cards"], np.int64),
        domains=[None if d is None else tuple(d) for d in bs["domains"]]
        if bs.get("domains") is not None else None,
    )
    trees = []
    for group in output["trees"]:
        if len(group) != K:
            raise ValueError(f"an iteration holds {len(group)} trees, "
                             f"n_tree_classes is {K}")
        trees.append([_tree(levels, dev) for levels in group])
    dom = output.get("response_domain")
    return {
        "bin_spec": spec,
        "trees": trees,
        "n_tree_classes": K,
        "names": list(output["names"]),
        "varimp": None,
        "response_domain": None if dom is None else tuple(dom),
        "ntrees_actual": len(trees),
    }


def _tree(levels, dev) -> Tree:
    tree = Tree()
    for lv in levels:
        tree.levels.append(TreeLevel(**{
            f: torch.as_tensor(np.ascontiguousarray(lv[f]), device=dev)
            for f in REPLAY_FIELDS}))
    return tree
