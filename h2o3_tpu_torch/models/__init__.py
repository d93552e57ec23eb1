"""The port's algorithms, imported on first use by name (JAX's
``h2o3_tpu.models`` registry, for the algorithms the port has)."""

_LAZY = {
    "GLM": ("h2o3_tpu_torch.models.glm", "GLM"),
    "GBM": ("h2o3_tpu_torch.models.tree.gbm", "GBM"),
    "XGBoost": ("h2o3_tpu_torch.models.tree.xgboost", "XGBoost"),
    "DRF": ("h2o3_tpu_torch.models.tree.drf", "DRF"),
    "XRT": ("h2o3_tpu_torch.models.tree.drf", "XRT"),
    "DeepLearning": ("h2o3_tpu_torch.models.deeplearning", "DeepLearning"),
    "StackedEnsemble": ("h2o3_tpu_torch.models.ensemble", "StackedEnsemble"),
    "IsotonicRegression": ("h2o3_tpu_torch.models.isotonic",
                           "IsotonicRegression"),
    "TargetEncoder": ("h2o3_tpu_torch.models.target_encoding",
                      "TargetEncoder"),
    "UpliftDRF": ("h2o3_tpu_torch.models.uplift", "UpliftDRF"),
    "KMeans": ("h2o3_tpu_torch.models.kmeans", "KMeans"),
    "PCA": ("h2o3_tpu_torch.models.pca", "PCA"),
    "SVD": ("h2o3_tpu_torch.models.pca", "SVD"),
    "NaiveBayes": ("h2o3_tpu_torch.models.naive_bayes", "NaiveBayes"),
    "IsolationForest": ("h2o3_tpu_torch.models.isolation_forest",
                        "IsolationForest"),
    "ExtendedIsolationForest": (
        "h2o3_tpu_torch.models.extended_isolation_forest",
        "ExtendedIsolationForest"),
    "GLRM": ("h2o3_tpu_torch.models.glrm", "GLRM"),
    "DT": ("h2o3_tpu_torch.models.tree.decision_tree", "DT"),
    "Aggregator": ("h2o3_tpu_torch.models.aggregator", "Aggregator"),
    "GAM": ("h2o3_tpu_torch.models.gam", "GAM"),
    "ModelSelection": ("h2o3_tpu_torch.models.model_selection",
                       "ModelSelection"),
    "RuleFit": ("h2o3_tpu_torch.models.rulefit", "RuleFit"),
    "CoxPH": ("h2o3_tpu_torch.models.coxph", "CoxPH"),
    "AdaBoost": ("h2o3_tpu_torch.models.adaboost", "AdaBoost"),
    "Word2Vec": ("h2o3_tpu_torch.models.word2vec", "Word2Vec"),
    "GenericModel": ("h2o3_tpu_torch.models.generic", "GenericModel"),
    "ANOVAGLM": ("h2o3_tpu_torch.models.anovaglm", "ANOVAGLM"),
    "Infogram": ("h2o3_tpu_torch.models.infogram", "Infogram"),
    "PSVM": ("h2o3_tpu_torch.models.psvm", "PSVM"),
    "HGLM": ("h2o3_tpu_torch.models.hglm", "HGLM"),
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(name)
