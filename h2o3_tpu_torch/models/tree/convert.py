"""Weights carried across: a GBM trained by the JAX package, handed over as
numpy, becomes a port :class:`~h2o3_tpu_torch.models.tree.gbm.GBMModel` that
predicts what the JAX model predicts.

The caller turns the JAX objects into plain numpy first (this package never
imports JAX), as a dict shaped like the JAX ``GBMModel.output``:

- ``bin_spec``: ``{"names", "is_cat", "nbins", "edges", "cards", "domains"}``
  — the ``BinSpec`` fields as arrays and lists;
- ``trees``: ``trees[iter][class]`` is a list of per-level dicts holding the
  replay fields (``split_col``, ``split_bin``, ``is_cat``, ``cat_mask``,
  ``na_left``, ``leaf_now``, ``leaf_val``, ``child_base``);
- ``init_f``, ``distribution``, ``names``, ``response_domain``.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.device import resolve
from h2o3_tpu_torch.models.tree.binning import BinSpec
from h2o3_tpu_torch.models.tree.gbm import GBMModel, GBMParams
from h2o3_tpu_torch.models.tree.shared_tree import REPLAY_FIELDS, Tree, TreeLevel


def gbm_from_numpy(output: dict, device=None) -> GBMModel:
    """A port GBMModel from a numpy copy of a JAX GBM's ``output``, with its
    trees on ``device`` (``cuda`` unless given)."""
    dev = resolve(device)
    if output.get("n_tree_classes", 1) != 1:
        raise NotImplementedError("multinomial GBMs are not ported yet")
    if output["distribution"] not in ("bernoulli", "gaussian"):
        raise NotImplementedError(
            f"distribution {output['distribution']!r} is not ported yet")
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
        if len(group) != 1:
            raise NotImplementedError("one tree per iteration is ported")
        tree = Tree()
        for lv in group[0]:
            tree.levels.append(TreeLevel(**{
                f: torch.as_tensor(np.ascontiguousarray(lv[f]), device=dev)
                for f in REPLAY_FIELDS}))
        trees.append([tree])
    dom = output.get("response_domain")
    out = {
        "bin_spec": spec,
        "trees": trees,
        "n_tree_classes": 1,
        "distribution": output["distribution"],
        "init_f": float(output["init_f"]),
        "names": list(output["names"]),
        "varimp": None,
        "response_domain": None if dom is None else tuple(dom),
        "ntrees_actual": len(trees),
    }
    return GBMModel(None, GBMParams(), out)
