"""XGBoost's parameter surface on the GBM tree engine — the port of
``h2o3_tpu/models/tree/xgboost.py``.

The xgboost names (``eta``, ``subsample``, ``colsample_bytree``,
``colsample_bylevel``, ``min_child_weight``, ``max_bin``, ``gamma``,
``max_delta_step``, ``n_estimators``) map onto GBM's parameters, with
xgboost's defaults, and train on the same builder (``gbm.py``): on the card
the same whole-tree graphs with kernels B1 and B2 (B3 with
``monotone_constraints``). What XGBoost adds there:

- ``reg_lambda``/``reg_alpha``: the leaf value
  ``sign(Σwy)·max(|Σwy| - α, 0) / (Σwh + λ)``
  (``shared_tree._leaf_decide``), before the monotone clamp and
  ``max_abs_leafnode_pred``; λ and α are device scalars of the graph
  state, so one captured plan serves any of them, and they do not enter
  the split scan (H2O's gain, as in JAX). With both 0 the leaf is GBM's;
- ``scale_pos_weight``: the positive class weighed up in the training
  weights only (bernoulli); the init score and the metrics stay unweighted
  by it.

As in JAX: ``tree_method`` ``exact``/``approx`` run as ``hist`` with a
warning, ``max_bin`` is clamped to 255, ``max_delta_step`` 0 means
unlimited, and non-``gbtree`` boosters, ``grow_policy="lossguide"``, an
unknown ``tree_method`` and ``scale_pos_weight <= 0`` raise.
``min_child_weight`` is H2O's ``min_rows`` (the rows' weight per child,
not their hessian).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any

from h2o3_tpu_torch.models.tree.binning import MAX_BINS
from h2o3_tpu_torch.models.tree.gbm import GBM, GBMModel, GBMParams

# xgboost name -> the GBMParams field it aliases
_ALIASES = {
    "eta": "learn_rate",
    "subsample": "sample_rate",
    "colsample_bytree": "col_sample_rate_per_tree",
    "colsample_bylevel": "col_sample_rate",
    "min_child_weight": "min_rows",
    "max_bin": "nbins",
    "gamma": "min_split_improvement",
    "max_delta_step": "max_abs_leafnode_pred",  # 0 = unlimited, below
    "n_estimators": "ntrees",
}


@dataclass
class XGBoostParams(GBMParams):
    # xgboost's defaults where they differ from H2O GBM's
    ntrees: int = 50
    max_depth: int = 6
    learn_rate: float = 0.3  # eta
    min_rows: float = 1.0  # min_child_weight
    min_split_improvement: float = 0.0  # gamma
    reg_lambda: float = 1.0
    reg_alpha: float = 0.0
    tree_method: str = "auto"  # auto | hist | exact | approx (-> hist)
    grow_policy: str = "depthwise"
    booster: str = "gbtree"
    scale_pos_weight: float = 1.0
    dmatrix_type: str = "auto"  # accepted for surface parity; dense engine


class XGBoostModel(GBMModel):
    algo = "xgboost"


class XGBoost(GBM):
    """``H2OXGBoostEstimator``'s builder on the GBM engine."""

    algo = "xgboost"
    PARAMS_CLS = XGBoostParams
    MODEL_CLS = XGBoostModel
    PARAM_ALIASES = _ALIASES  # the estimator accepts the xgboost names

    def __init__(self, **kwargs: Any):
        if "max_delta_step" in kwargs:
            mds = float(kwargs.pop("max_delta_step"))
            if mds < 0:
                raise ValueError("max_delta_step must be >= 0")
            if mds == 0:  # xgboost's convention: 0 means unconstrained
                pass
            elif "max_abs_leafnode_pred" in kwargs:
                raise ValueError("'max_delta_step' and "
                                 "'max_abs_leafnode_pred' are aliases — "
                                 "pass one")
            else:
                kwargs["max_abs_leafnode_pred"] = mds
        super().__init__(**kwargs)
        p: XGBoostParams = self.params
        if p.booster != "gbtree":
            raise ValueError(
                f"booster={p.booster!r} is not supported (gbtree only; "
                "dart/gblinear have no engine here)")
        if p.grow_policy not in ("depthwise",):
            raise ValueError(
                "grow_policy='lossguide' is not supported (depth-wise "
                "builder)")
        if p.tree_method not in ("auto", "hist", "exact", "approx"):
            raise ValueError(f"unknown tree_method {p.tree_method!r}")
        if p.scale_pos_weight <= 0:
            raise ValueError("scale_pos_weight must be > 0")
        if p.tree_method in ("exact", "approx"):
            warnings.warn(
                f"tree_method={p.tree_method!r} has no exact-split engine; "
                "using hist (static quantile bins)", stacklevel=2)
        if p.nbins > MAX_BINS:
            warnings.warn(f"max_bin={p.nbins} clamped to the engine maximum "
                          f"{MAX_BINS}", stacklevel=2)
            p.nbins = MAX_BINS
