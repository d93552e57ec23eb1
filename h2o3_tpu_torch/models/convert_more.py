"""Models carried across: a K-means, PCA, SVD, GLRM, naive Bayes,
isolation forest, extended isolation forest, decision tree, aggregator,
GAM, model selection, RuleFit, CoxPH, AdaBoost, ANOVAGLM, HGLM, PSVM,
Word2Vec or Infogram model trained by the JAX package, handed over as
numpy, becomes the port's model, which predicts what the JAX model
predicts.

The caller turns the JAX model's ``output`` into plain numpy and Python
values first (this package never imports JAX), keeping its keys; a
``datainfo`` becomes its spec as plain values (the tmojo's ``datainfo``
meta: the flags, ``ncols_expanded``, ``hash_buckets`` and per column its
name, kind, offset, width, mean, sigma and domain), and a decision tree's
``bin_spec`` and trees take the form ``tree.convert.drf_from_numpy``
reads (an AdaBoost's too); a GLM inside a model (RuleFit's, a binomial
model selection's) takes the form ``glm.glm_from_numpy`` reads, and the
aggregator's frame is a pandas DataFrame. ``params`` (a dict of builder
parameters) sets those fields of the model's parameters; the rest keep
their defaults. Device tensors of the
model (a decision tree's levels, GLRM's ``x_factor``) go to ``device``
(``cuda`` unless given).
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.device import resolve
from h2o3_tpu_torch.models.adaboost import AdaBoostModel, AdaBoostParams
from h2o3_tpu_torch.models.aggregator import AggregatorModel, AggregatorParams
from h2o3_tpu_torch.models.anovaglm import ANOVAGLMModel, ANOVAGLMParams
from h2o3_tpu_torch.models.coxph import CoxPHModel, CoxPHParams
from h2o3_tpu_torch.models.datainfo import DataInfo
from h2o3_tpu_torch.models.extended_isolation_forest import (
    ExtendedIsolationForestModel,
    ExtendedIsolationForestParams,
)
from h2o3_tpu_torch.models.gam import GAMModel, GAMParams
from h2o3_tpu_torch.models.glm import glm_from_numpy
from h2o3_tpu_torch.models.glrm import GLRMModel, GLRMParams
from h2o3_tpu_torch.models.hglm import HGLMModel, HGLMParams
from h2o3_tpu_torch.models.infogram import InfogramModel, InfogramParams
from h2o3_tpu_torch.models.isolation_forest import (
    IsolationForestModel,
    IsolationForestParams,
)
from h2o3_tpu_torch.models.kmeans import KMeansModel, KMeansParams
from h2o3_tpu_torch.models.model_selection import (
    ModelSelectionModel,
    ModelSelectionParams,
)
from h2o3_tpu_torch.models.naive_bayes import NaiveBayesModel, NaiveBayesParams
from h2o3_tpu_torch.models.pca import PCAModel, PCAParams, SVDModel, SVDParams
from h2o3_tpu_torch.models.psvm import PSVMModel, PSVMParams
from h2o3_tpu_torch.models.rulefit import RuleFitModel, RuleFitParams
from h2o3_tpu_torch.models.tree.convert import _forest, spec_from_numpy
from h2o3_tpu_torch.models.tree.decision_tree import DTModel, DTParams
from h2o3_tpu_torch.models.word2vec import Word2VecModel, Word2VecParams


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


def aggregator_from_numpy(output: dict, device=None,
                          params: dict | None = None) -> AggregatorModel:
    """A port aggregator from a JAX one's ``output`` (``aggregated_frame``
    as a pandas DataFrame, ``mapping``, ``num_exemplars``, ``nobs``,
    ``radius``, ``names``); the frame is uploaded to ``device``."""
    from h2o3_tpu_torch.frame.parse import upload_file

    fr = upload_file(output["aggregated_frame"], device=resolve(device))
    out = {
        "aggregated": [(n, fr.vec(n).kind, fr.vec(n).domain, fr.vec(n).data)
                       for n in fr.names],
        "num_exemplars": int(output["num_exemplars"]),
        "nobs": int(output["nobs"]),
        "mapping": np.asarray(output["mapping"], np.int64),
        "radius": float(output["radius"]),
        "names": list(output["names"]),
        "response_domain": None,
    }
    return AggregatorModel(None, AggregatorParams(**(params or {})), out)


def gam_from_numpy(output: dict, params: dict | None = None) -> GAMModel:
    """A port GAM from a JAX one's ``output`` (``beta``, ``coef_names``,
    ``linear_names``, ``linear_info``, ``gam_terms`` with each term's
    ``knots``, ``F``, ``Z``, ``impute`` and ``scale``, ``family``,
    ``intercept``, ``names``, ``response_domain``)."""
    f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
    dom = output.get("response_domain")
    out = {
        "intercept": bool(output.get("intercept", True)),
        "beta": f64(output["beta"]),
        "coef_names": list(output["coef_names"]),
        "linear_names": list(output["linear_names"]),
        "linear_info": {n: {"mean": float(i["mean"]),
                            "sigma": float(i["sigma"])}
                        for n, i in output["linear_info"].items()},
        "gam_terms": [{"name": g["name"], "knots": f64(g["knots"]),
                       "F": f64(g["F"]), "Z": f64(g["Z"]),
                       "impute": float(g["impute"]),
                       "scale": float(g["scale"])}
                      for g in output["gam_terms"]],
        "family": output["family"],
        "deviance": float(output.get("deviance", np.nan)),
        "names": list(output["names"]),
        "response_domain": None if dom is None else tuple(dom),
    }
    return GAMModel(None, GAMParams(**(params or {})), out)


def modelselection_from_numpy(output: dict, device=None,
                              params: dict | None = None
                              ) -> ModelSelectionModel:
    """A port model selection from a JAX one's ``output``
    (``datainfo``, ``beta_std_final``, ``best_predictor_subsets``,
    ``best_r2_values``, ``coef_per_size``, ``family``, ``mode``, ``names``,
    ``response_domain``; a binomial one's ``final_glm`` in
    ``glm_from_numpy``'s form, scoring on ``device``)."""
    dom = output.get("response_domain")
    final = output.get("final_glm")
    prm = dict(params or {})
    out = {
        "beta_std_final": np.asarray(output["beta_std_final"], np.float64),
        "final_glm": None if final is None else glm_from_numpy(
            final, params={k: prm[k] for k in ("response_column",
                                                "weights_column")
                           if k in prm}, device=device),
        "datainfo": DataInfo.from_meta(output["datainfo"]),
        "family": output["family"],
        "best_predictor_subsets": [tuple(s) for s in
                                   output["best_predictor_subsets"]],
        "best_r2_values": [float(v) for v in output["best_r2_values"]],
        "coef_per_size": [dict(c) for c in output["coef_per_size"]],
        "mode": output["mode"],
        "names": list(output["names"]),
        "response_domain": None if dom is None else tuple(dom),
    }
    return ModelSelectionModel(None, ModelSelectionParams(**prm), out)


def rulefit_from_numpy(output: dict, device=None,
                       params: dict | None = None) -> RuleFitModel:
    """A port RuleFit from a JAX one's ``output`` (``bin_spec`` in
    ``tree.convert``'s form, ``rule_cols``, ``rule_masks``,
    ``rule_valid``, ``rule_names``, ``linear_names``, ``rule_importance``,
    ``lambda``, ``names``, ``response_domain``, and ``glm_model`` in
    ``glm_from_numpy``'s form, scoring on ``device``)."""
    dom = output.get("response_domain")
    has_rules = output.get("rule_cols") is not None
    out = {
        "bin_spec": spec_from_numpy(output["bin_spec"]),
        "rule_cols": np.asarray(output["rule_cols"], np.int32)
        if has_rules else None,
        "rule_masks": np.asarray(output["rule_masks"], bool)
        if has_rules else None,
        "rule_valid": np.asarray(output["rule_valid"], bool)
        if has_rules else None,
        "rule_names": list(output["rule_names"]),
        "linear_names": list(output["linear_names"]),
        "glm_model": glm_from_numpy(output["glm_model"], device=device),
        "rule_importance": [dict(d) for d in output["rule_importance"]],
        "lambda": float(output["lambda"]),
        "names": list(output["names"]),
        "response_domain": None if dom is None else tuple(dom),
    }
    return RuleFitModel(None, RuleFitParams(**(params or {})), out)


def coxph_from_numpy(output: dict, params: dict | None = None
                     ) -> CoxPHModel:
    """A port CoxPH from a JAX one's ``output`` (``coefficients``,
    ``x_means``, ``names``, ``loglik``, ``n``, ``n_events``)."""
    out = dict(output, response_domain=None)
    out["coefficients"] = np.asarray(output["coefficients"], np.float64)
    out["x_means"] = np.asarray(output["x_means"], np.float64)
    out["names"] = list(output["names"])
    out["coef_names"] = list(output.get("coef_names", output["names"]))
    return CoxPHModel(None, CoxPHParams(**(params or {})), out)


def adaboost_from_numpy(output: dict, device=None,
                        params: dict | None = None) -> AdaBoostModel:
    """A port AdaBoost from a JAX one's ``output`` in the form of
    ``tree.convert.drf_from_numpy`` (``bin_spec``, ``trees`` of one tree
    an iteration with the alpha-scaled leaves, ``names``,
    ``response_domain``) and its ``alphas``, its levels on ``device``."""
    out = _forest(output, resolve(device))
    out["alphas"] = [float(a) for a in output["alphas"]]
    return AdaBoostModel(None, AdaBoostParams(**(params or {})), out)


def anovaglm_from_numpy(output: dict, params: dict | None = None
                        ) -> ANOVAGLMModel:
    """A port ANOVAGLM from a JAX one's ``output`` (``term_plan``,
    ``beta_full``, ``anova_table``, ``family``, ``names``,
    ``response_domain``)."""
    plan = output["term_plan"]
    out = {
        "term_plan": {"bases": {n: dict(b) for n, b in plan["bases"].items()},
                      "terms": [tuple(t) for t in plan["terms"]]},
        "anova_table": [dict(r) for r in output["anova_table"]],
        "beta_full": np.asarray(output["beta_full"], np.float64),
        "family": output["family"],
        "names": list(output["names"]),
        "response_domain": (None if output.get("response_domain") is None
                            else tuple(output["response_domain"])),
    }
    return ANOVAGLMModel(None, ANOVAGLMParams(**(params or {})), out)


def hglm_from_numpy(output: dict, params: dict | None = None) -> HGLMModel:
    """A port HGLM from a JAX one's ``output`` (``datainfo``, ``beta``,
    ``coef_names``, ``random_effects`` {column: (domain, u)}, ``sigma_e2``,
    ``sigma_u2``, ``em_iterations``, ``names``)."""
    out = _with_di(output)
    out["beta"] = np.asarray(output["beta"], np.float64)
    out["coef_names"] = list(output["coef_names"])
    out["random_effects"] = {
        rc: (list(dom), np.asarray(u, np.float64))
        for rc, (dom, u) in output["random_effects"].items()}
    out["sigma_u2"] = dict(output["sigma_u2"])
    return HGLMModel(None, HGLMParams(**(params or {})), out)


def psvm_from_numpy(output: dict, params: dict | None = None) -> PSVMModel:
    """A port PSVM from a JAX one's ``output`` (``datainfo``,
    ``landmarks``, ``whalf``, ``gamma``, ``w``, ``b``, ``names``,
    ``response_domain``)."""
    out = _with_di(output)
    for k in ("landmarks", "whalf", "w"):
        out[k] = np.asarray(output[k], np.float32)
    out["gamma"] = float(output["gamma"])
    out["b"] = float(output["b"])
    out["response_domain"] = tuple(output["response_domain"])
    return PSVMModel(None, PSVMParams(**(params or {})), out)


def word2vec_from_numpy(output: dict, params: dict | None = None
                        ) -> Word2VecModel:
    """A port Word2Vec from a JAX one's ``output`` (``vocab``, ``words``,
    ``embeddings``, ``names``)."""
    out = {
        "vocab": dict(output["vocab"]),
        "words": list(output["words"]),
        "embeddings": np.asarray(output["embeddings"], np.float32),
        "names": list(output["names"]),
        "response_domain": None,
    }
    return Word2VecModel(None, Word2VecParams(**(params or {})), out)


def infogram_from_numpy(output: dict, params: dict | None = None
                        ) -> InfogramModel:
    """A port Infogram from a JAX one's ``output`` (``score_table``,
    ``admissible_features``, ``x_axis``, ``y_axis``, ``names``)."""
    out = {
        "score_table": [dict(r) for r in output["score_table"]],
        "admissible_features": list(output["admissible_features"]),
        "x_axis": output["x_axis"],
        "y_axis": output["y_axis"],
        "names": list(output["names"]),
        "response_domain": None,
    }
    model = InfogramModel(None, InfogramParams(**(params or {})), out)
    model.training_metrics = model._score_metrics(None)
    return model
