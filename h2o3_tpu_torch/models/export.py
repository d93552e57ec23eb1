"""Portable model export — the port of ``h2o3_tpu/models/export.py`` for
tree models (GBM, DRF, XRT and XGBoost), GLM, DeepLearning and k-means (the
MOJO writer side, ``/3/Models/{id}/mojo`` upstream).

Format ("tmojo", .zip), the JAX package's ``FORMAT_VERSION`` "1.0" key for
key and array for array:
- ``model.json`` — algo, version, scoring metadata (domains, distribution,
  init score, tree shapes; a GLM's family, link and DataInfo spec) —
  everything small;
- ``arrays.npz`` — the numeric payload: per tree, class and level the
  replay arrays (``t{tree}_k{class}_l{level}_{field}``), the bin spec and
  a calibrated model's isotonic knots (``cal_thresholds_x``/``_y``; Platt's
  two numbers go in ``model.json``);
  a GLM's standardized coefficients: ``beta_std``, a multinomial model's
  ``beta_multinomial_std`` (P x K), an ordinal model's ``beta_std`` and
  cuts ``theta``; a DeepLearning model's layers ``W{i}`` (flax's (in, out)
  layout, the first without its bucket-padding rows) and ``b{i}``; a
  k-means model's standardized centers ``centers_std`` (its DataInfo spec
  in ``model.json``).

The artifact is scored without torch and without JAX by
:mod:`h2o3_tpu_torch.genmodel` (pure numpy) or by the JAX package's
``h2o3_tpu.genmodel``; parity with ``model.predict`` is the numerical
regression net, H2O's MOJO-parity test strategy. ``Model.download_mojo``
and ``Model.save_mojo`` call :func:`export_mojo`.
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np

from h2o3_tpu_torch.models.model_base import Model

FORMAT_VERSION = "1.0"


def _datainfo_meta(di) -> dict:
    """A DataInfo spec as JAX writes it: the hash bucket count and each
    interaction's source pair, training means and domains are part of the
    scoring spec."""
    return {
        "standardize": di.standardize,
        "use_all_factor_levels": di.use_all_factor_levels,
        "missing_handling": di.missing_handling,
        "add_intercept": di.add_intercept,
        "ncols_expanded": di.ncols_expanded,
        "hash_buckets": di.hash_buckets,
        "columns": [
            {"name": c.name, "kind": c.kind, "mean": float(c.mean),
             "sigma": float(c.sigma), "domain": list(c.domain),
             "offset": c.offset, "width": c.width,
             "pair": list(c.pair) if c.pair else None,
             "pair_means": list(c.pair_means) if c.pair_means else None,
             "pair_domains": [list(d) for d in c.pair_domains]
             if c.pair_domains else None}
            for c in di.columns
        ],
    }


def _export_glm(model, meta, arrays) -> None:
    out = model.output
    meta["family"] = out["family"]
    meta["link"] = out.get("link", "family_default")
    meta["datainfo"] = _datainfo_meta(out["datainfo"])
    meta["coef_names"] = out["coef_names"]
    if out.get("multinomial"):
        arrays["beta_multinomial_std"] = np.asarray(
            out["beta_multinomial_std"])
    elif out.get("ordinal"):
        arrays["beta_std"] = np.asarray(out["beta_std"])
        arrays["theta"] = np.asarray(out["theta"])  # the cuts, std scale
    else:
        arrays["beta_std"] = np.asarray(out["beta_std"])
    meta["tweedie_link_power"] = getattr(model.params, "tweedie_link_power",
                                         1.0)


def _export_deeplearning(model, meta, arrays) -> None:
    out = model.output
    meta["datainfo"] = _datainfo_meta(out["datainfo"])
    meta["activation"] = model.params.activation
    layers = out["net"].dense()
    meta["n_layers"] = len(layers)
    for i, d in enumerate(layers):
        arrays[f"W{i}"] = d.weight.detach().t().cpu().numpy()
        arrays[f"b{i}"] = d.bias.detach().cpu().numpy()
    pad = int(out.get("input_pad") or 0)
    if pad:  # the artifact scores the real design width
        arrays["W0"] = arrays["W0"][:-pad]
    if out.get("autoencoder"):
        meta["autoencoder"] = True


def _export_trees(model, meta, arrays) -> None:
    out = model.output
    spec = out["bin_spec"]
    meta["distribution"] = out.get("distribution")  # None for DRF and XRT
    meta["init_f"] = (np.asarray(out["init_f"]).tolist() if "init_f" in out
                      else None)
    meta["n_tree_classes"] = out.get("n_tree_classes", 1)
    meta["ntrees_actual"] = out["ntrees_actual"]
    meta["names"] = out["names"]
    meta["bin_domains"] = [list(d) if d else None for d in (spec.domains or [])]
    meta["offset_column"] = getattr(model.params, "offset_column", None)
    arrays["bin_is_cat"] = np.asarray(spec.is_cat)
    arrays["bin_nbins"] = np.asarray(spec.nbins)
    arrays["bin_edges"] = np.asarray(spec.edges)
    cal = out.get("calibration")
    if cal is not None:
        meta["calibration_method"] = cal["method"]
        if cal["method"] == "PlattScaling":
            meta["calibration_platt"] = [cal["a"], cal["b"]]
        else:
            arrays["cal_thresholds_x"] = np.asarray(cal["thresholds_x"])
            arrays["cal_thresholds_y"] = np.asarray(cal["thresholds_y"])
    full_b = int(spec.max_bins)
    tree_shapes = []
    for ti, group in enumerate(out["trees"]):
        class_levels = []
        for ki, tree in enumerate(group):
            host = tree.to_host()
            class_levels.append(len(host.levels))
            for li, lv in enumerate(host.levels):
                pre = f"t{ti}_k{ki}_l{li}_"
                arrays[pre + "split_col"] = lv.split_col
                arrays[pre + "split_bin"] = lv.split_bin
                arrays[pre + "is_cat"] = lv.is_cat
                # the tree build records cat_mask at the bucketed bin width;
                # every offline scorer sees the model's width (JAX pads
                # narrower masks to it the same way)
                cm = np.asarray(lv.cat_mask)
                if cm.shape[1] < full_b:
                    cm = np.pad(cm, ((0, 0), (0, full_b - cm.shape[1])))
                arrays[pre + "cat_mask"] = cm
                arrays[pre + "na_left"] = lv.na_left
                arrays[pre + "leaf_now"] = lv.leaf_now
                arrays[pre + "leaf_val"] = lv.leaf_val
                arrays[pre + "child_base"] = lv.child_base
        tree_shapes.append(class_levels)
    meta["tree_levels"] = tree_shapes


def _export_kmeans(model, meta, arrays) -> None:
    out = model.output
    meta["datainfo"] = _datainfo_meta(out["datainfo"])
    arrays["centers_std"] = np.asarray(out["centers_std"])


_EXPORTERS = {"gbm": _export_trees, "xgboost": _export_trees,
              "drf": _export_trees, "xrt": _export_trees, "glm": _export_glm,
              "deeplearning": _export_deeplearning, "kmeans": _export_kmeans}


def _write_mojo(model: Model, dest) -> None:
    """Write the artifact to a path or file-like object."""
    if model.algo not in _EXPORTERS:
        raise ValueError(f"mojo export not supported for {model.algo!r}")
    thr = None
    if model.training_metrics is not None:
        thr = model.training_metrics._v.get("default_threshold")
    meta = {
        "format_version": FORMAT_VERSION,
        "algo": model.algo,
        "model_key": model.key,
        "default_threshold": thr,
        "response_column": model.params.response_column,
        "response_domain": list(model.output["response_domain"])
        if model.output.get("response_domain") else None,
    }
    arrays: dict[str, np.ndarray] = {}
    _EXPORTERS[model.algo](model, meta, arrays)

    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    with zipfile.ZipFile(dest, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("model.json", json.dumps(meta))
        z.writestr("arrays.npz", buf.getvalue())


def export_mojo(model: Model, path: str) -> str:
    """Write the portable artifact; returns the path."""
    _write_mojo(model, path)
    return path


def export_pojo(model: Model, path: str) -> str:
    """The POJO's successor: ONE self-contained .py scoring file that needs
    only numpy — the source of :mod:`h2o3_tpu_torch.genmodel` and the tmojo
    payload in base64.

    Usage of the artifact:  ``python model.py data.csv > preds.csv``  or
    ``import model; model.MODEL.predict({...})``.
    """
    import base64
    import inspect

    from h2o3_tpu_torch import genmodel as _gm

    buf = io.BytesIO()
    _write_mojo(model, buf)
    payload_b64 = base64.b64encode(buf.getvalue()).decode()
    src = inspect.getsource(_gm)
    chunks = [payload_b64[i: i + 100] for i in range(0, len(payload_b64), 100)]
    blob_lines = "\n".join(f'    "{c}"' for c in chunks)
    out = (
        # comments (not a docstring) so the embedded source's own
        # `from __future__` import stays legally placed
        f"# Standalone scorer for model {model.key} (algo={model.algo})\n"
        "# generated by h2o3_tpu_torch.models.export.export_pojo — numpy "
        "only.\n"
        + src
        + "\n\n# --- embedded model payload "
        + "-" * 40 + "\n"
        + "_PAYLOAD_B64 = (\n" + blob_lines + "\n)\n"
        + '''

def _load_embedded() -> "MojoModel":
    import base64 as _b64
    import io as _io

    return MojoModel.load(_io.BytesIO(_b64.b64decode(_PAYLOAD_B64)))


MODEL = _load_embedded()


if __name__ == "__main__":
    import sys as _sys

    if len(_sys.argv) != 2:
        print("usage: python model.py data.csv", file=_sys.stderr)
        raise SystemExit(2)
    import csv as _csv

    with open(_sys.argv[1]) as _f:
        rows = list(_csv.DictReader(_f))
    table = {k: [r[k] for r in rows] for k in rows[0]}
    out = MODEL.predict(table)
    keys = list(out)
    w = _csv.writer(_sys.stdout)
    w.writerow(keys)
    for i in range(len(out[keys[0]])):
        w.writerow([out[k][i] for k in keys])
'''
    )
    with open(path, "w") as f:
        f.write(out)
    return path
