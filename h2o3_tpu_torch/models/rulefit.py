"""RuleFit — the port of ``h2o3_tpu/models/rulefit.py`` (the successor of
``hex.rulefit.RuleFit``): Friedman and Popescu's RuleFit (2008). (1) Grow
one depth-limited forest per rule length on the port's DRF
(``sample_rate`` 0.5) or GBM, (2) turn every root-to-node path into a
conjunction of bin-mask conditions (:func:`extract_rules`, over TreeSHAP's
``_tree_nodes``), de-duplicate and cap at 1,500, (3) fit an L1 GLM over
the rule indicators and (``rules_and_linear``) the raw numeric columns,
its lambda picked on an 80/20 ``split_frame`` holdout from 8 candidates
in a geometric series, or taken from ``lambda_``.

The forests run kernel B1, its compaction and B2 on the card. The rule
matrix is evaluated on the device (:func:`eval_rules`: a gather of each
rule's column codes from the binned frame and a lookup in its bin masks,
512 rules at a time) into an (R, n) float32 tensor that stays there: the
GLM's frame is built from device tensors (each rule's row of the matrix,
the frame's own numeric columns, response and weights), where JAX pulls
the matrix to the host and rebuilds the frame through pandas. Only the
rules' supports (counted in float64) cross to the host.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import CAT, NUM, Frame, Vec
from h2o3_tpu_torch.models.model_base import CommonParams, Model, ModelBuilder
from h2o3_tpu_torch.models.tree.binning import BinSpec, bin_frame

RULE_CHUNK = 512  # rules a device evaluation (JAX's)
ROW_BLOCK = 1 << 17  # rows a gather: bounds the (rows, rules) int64 index
DEFAULT_RULE_CAP = 1500


@dataclass
class RuleFitParams(CommonParams):
    algorithm: str = "AUTO"  # AUTO -> DRF (h2o default)
    min_rule_length: int = 3
    max_rule_length: int = 3
    max_num_rules: int = -1  # -1 -> derived cap (h2o: based on ntrees)
    model_type: str = "rules_and_linear"  # rules_and_linear | rules | linear
    rule_generation_ntrees: int = 50
    distribution: str = "AUTO"
    lambda_: float | None = None  # explicit LASSO lambda (skips holdout pick)
    remove_duplicates: bool = True


class Rule:
    """Conjunction of per-column bin-mask conditions."""

    __slots__ = ("cols", "masks", "support", "name", "text")

    def __init__(self, cols: list[int], masks: list[np.ndarray]):
        self.cols = cols
        self.masks = masks  # each (B,) bool over bin codes
        self.support = 0.0
        self.name = ""
        self.text = ""

    def key(self) -> tuple:
        return tuple(sorted(zip(self.cols,
                                [m.tobytes() for m in self.masks])))


def node_condition_masks(nd, B: int):
    """Left/right bin-code masks of one split node (code 0 = NA)."""
    left = np.zeros(B, bool)
    if nd.is_cat:
        cm = np.asarray(nd.cat_mask).astype(bool)
        left[: min(B, len(cm))] = cm[:B]
        left[0] = nd.na_left
    else:
        left[1: nd.thr_bin + 1] = True
        left[0] = nd.na_left
    return left, ~left


def extract_rules(trees, B: int, max_len: int) -> list[Rule]:
    """Every root-to-node path (depth >= 1) of every tree as a rule;
    conditions on one column along a path AND into one mask."""
    from h2o3_tpu_torch.models.tree.shap import _tree_nodes

    rules: list[Rule] = []
    for tree in trees:
        nodes = _tree_nodes(tree)
        if not nodes:
            continue

        def walk(j: int, conds: dict[int, np.ndarray], depth: int):
            nd = nodes[j]
            if conds:
                cols = sorted(conds)
                rules.append(Rule(cols, [conds[c].copy() for c in cols]))
            if nd.is_leaf or nd.left < 0 or depth >= max_len:
                return
            lmask, rmask = node_condition_masks(nd, B)
            for child, m in ((nd.left, lmask), (nd.right, rmask)):
                nc = dict(conds)
                f = nd.feature
                nc[f] = (nc[f] & m) if f in nc else m
                walk(child, nc, depth + 1)

        walk(0, {}, 0)
    return rules


def eval_rules(bins: torch.Tensor, cols: np.ndarray, masks: np.ndarray,
               valid: np.ndarray) -> torch.Tensor:
    """Rule membership as an (R, n) float32 tensor on ``bins``' device:
    row r is rule r's indicator over the rows. ``bins`` (n, C) uint8
    codes; ``cols`` (R, L) columns, ``masks`` (R, L, B) bin masks and
    ``valid`` (R, L) the conditions in use. Rules go 512 at a time and
    rows in blocks of 131,072: a gather of the rules' column codes and a
    gather from their masks per condition."""
    dev = bins.device
    n = bins.shape[0]
    R, L = cols.shape
    out = torch.empty((R, n), dtype=torch.float32, device=dev)
    for s in range(0, R, RULE_CHUNK):
        e = min(s + RULE_CHUNK, R)
        c = torch.as_tensor(cols[s:e].astype(np.int64), device=dev)
        m = torch.as_tensor(masks[s:e], device=dev)  # (r, L, B)
        v = torch.as_tensor(valid[s:e], device=dev)  # (r, L)
        for r0 in range(0, n, ROW_BLOCK):
            blk = bins[r0: r0 + ROW_BLOCK]
            sat = torch.ones((blk.shape[0], e - s), dtype=torch.bool,
                             device=dev)
            for li in range(L):
                codes = blk.index_select(1, c[:, li]).long()  # (m, r)
                hit = torch.gather(m[:, li, :].T, 0, codes)
                sat &= hit | ~v[:, li]
            out[s:e, r0: r0 + blk.shape[0]] = sat.T
    return out


def rule_text(rule: Rule, spec: BinSpec) -> str:
    parts = []
    for col, mask in zip(rule.cols, rule.masks):
        name = spec.names[col]
        if spec.is_cat[col]:
            dom = spec.domains[col] if spec.domains else None
            lvls = [str(dom[b - 1]) if dom and b - 1 < len(dom) else str(b - 1)
                    for b in range(1, len(mask)) if mask[b]]
            parts.append(f"{name} in {{{', '.join(lvls)}}}")
        else:
            nb = int(spec.nbins[col])
            e = spec.edges[col]
            data_bins = np.where(mask[1: nb + 1])[0] + 1  # codes with mask set
            if len(data_bins) == 0:
                parts.append(f"{name} is NA")
                continue
            lo_b, hi_b = int(data_bins.min()), int(data_bins.max())
            seg = []
            if lo_b > 1:
                seg.append(f"{name} > {e[lo_b - 2]:.6g}")
            if hi_b < nb:
                seg.append(f"{name} <= {e[hi_b - 1]:.6g}")
            if not seg:
                seg.append(f"{name} any")
            parts.append(" & ".join(seg))
    return " & ".join(parts)


def _numeric_vec(v: Vec, name: str) -> Vec:
    return Vec(v.data, v.kind, name=name)


def _glm_frame(linear: list[tuple[str, Vec]], rule_names, Rmat,
               yv: Vec, classification: bool, wv: Vec | None) -> Frame:
    """The GLM's frame from device tensors: the numeric columns as
    ``linear.<name>``, one column per rule (its row of ``Rmat``), ``__y``
    and (with weights) ``__w``."""
    vecs = [_numeric_vec(v, f"linear.{n}") for n, v in linear]
    vecs += [Vec(Rmat[ri], NUM, name=nm) for ri, nm in enumerate(rule_names)]
    vecs.append(Vec(yv.data, CAT, name="__y", domain=yv.domain)
                if classification else _numeric_vec(yv, "__y"))
    if wv is not None:
        vecs.append(_numeric_vec(wv, "__w"))
    return Frame(vecs, [v.name for v in vecs])


class RuleFitModel(Model):
    algo = "rulefit"

    def _rule_frame(self, frame: Frame) -> Frame:
        o = self.output
        linear = [(n, frame.vec(n)) for n in o["linear_names"]]
        vecs = [_numeric_vec(v, f"linear.{n}") for n, v in linear]
        if o["rule_names"]:
            R = eval_rules(bin_frame(o["bin_spec"], frame), o["rule_cols"],
                           o["rule_masks"], o["rule_valid"])
            vecs += [Vec(R[ri], NUM, name=nm)
                     for ri, nm in enumerate(o["rule_names"])]
        return Frame(vecs, [v.name for v in vecs])

    def _predict_raw(self, frame: Frame) -> torch.Tensor:
        return self.output["glm_model"]._predict_raw(self._rule_frame(frame))

    def rule_importance(self) -> list[dict]:
        return self.output["rule_importance"]

    def _distribution_for_metrics(self) -> str:
        return "gaussian"


class RuleFit(ModelBuilder):
    algo = "rulefit"
    PARAMS_CLS = RuleFitParams

    def _build(self, train: Frame, valid: Frame | None) -> Model:
        from h2o3_tpu_torch.models.glm import GLM
        from h2o3_tpu_torch.models.tree.drf import DRF
        from h2o3_tpu_torch.models.tree.gbm import GBM

        p: RuleFitParams = self.params
        if p.min_rule_length > p.max_rule_length:
            raise ValueError("min_rule_length must be <= max_rule_length")
        yv = train.vec(p.response_column)
        classification = yv.is_categorical()
        family = "binomial" if classification and yv.cardinality <= 2 else (
            "multinomial" if classification else "gaussian")
        if family == "multinomial":
            raise ValueError("rulefit supports regression and binomial only")
        dev = train.device
        secs: dict[str, float] = {}

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        t0 = time.perf_counter()
        rules: list[Rule] = []
        forests = []  # the rule generators, one a rule length
        spec = None
        n_extracted = 0
        if p.model_type in ("rules_and_linear", "rules"):
            depths = list(range(p.min_rule_length, p.max_rule_length + 1))
            per_depth = max(1, p.rule_generation_ntrees // len(depths))
            algo = p.algorithm.upper()
            if algo == "AUTO":
                algo = "DRF"
            for di, depth in enumerate(depths):
                cls = DRF if algo == "DRF" else GBM
                kw = dict(ntrees=per_depth, max_depth=depth,
                          seed=(abs(p.seed) or 1) + di,
                          response_column=p.response_column,
                          ignored_columns=p.ignored_columns)
                if cls is DRF:
                    kw["sample_rate"] = 0.5
                ens = cls(**kw).train(y=p.response_column, x=self._x,
                                      training_frame=train)
                forests.append(ens)
                spec = ens.output["bin_spec"]
                for group in ens.output["trees"]:
                    for tree in group:
                        rules.extend(extract_rules([tree], spec.max_bins,
                                                   depth))
            n_extracted = len(rules)
            if p.remove_duplicates:
                seen: dict[tuple, Rule] = {}
                for r in rules:
                    seen.setdefault(r.key(), r)
                rules = list(seen.values())
            cap = p.max_num_rules if p.max_num_rules > 0 else DEFAULT_RULE_CAP
            rules = rules[:cap]
        sync()
        secs["forest"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        linear: list[tuple[str, Vec]] = []
        if p.model_type in ("rules_and_linear", "linear"):
            linear = [(n, train.vec(n)) for n in self._x
                      if train.vec(n).is_numeric()]
        rule_cols = rule_masks = rule_valid = None
        Rmat = None
        if rules:
            L = max(len(r.cols) for r in rules)
            B = spec.max_bins
            Rn = len(rules)
            rule_cols = np.zeros((Rn, L), np.int32)
            rule_masks = np.zeros((Rn, L, B), bool)
            rule_valid = np.zeros((Rn, L), bool)
            for ri, r in enumerate(rules):
                for li, (c, m) in enumerate(zip(r.cols, r.masks)):
                    rule_cols[ri, li] = c
                    rule_masks[ri, li] = m[:B]
                    rule_valid[ri, li] = True
            Rmat = eval_rules(bin_frame(spec, train), rule_cols, rule_masks,
                              rule_valid)
            counts = Rmat.sum(1, dtype=torch.float64).cpu().numpy()
            # numpy's float32 mean of a 0/1 column
            support = (counts.astype(np.float32)
                       / np.float32(train.nrow)).astype(np.float32)
            # drop degenerate rules (all-0 / all-1)
            keep = (support > 1e-6) & (support < 1 - 1e-6)
            rules = [r for r, k in zip(rules, keep) if k]
            keep_t = torch.from_numpy(np.flatnonzero(keep)).to(dev)
            Rmat = Rmat.index_select(0, keep_t)
            rule_cols, rule_masks, rule_valid = (
                rule_cols[keep], rule_masks[keep], rule_valid[keep])
            for ri, (r, sup) in enumerate(zip(rules, support[keep])):
                r.support = float(sup)
                r.name = f"rule_{ri}"
                r.text = rule_text(r, spec)
        rule_names = [r.name for r in rules]
        sync()
        secs["rule_matrix"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        wv = train.vec(p.weights_column) if p.weights_column else None
        glm_frame = _glm_frame(linear, rule_names, Rmat, yv, classification,
                               wv)
        glm_kw = dict(family=family, alpha=1.0, standardize=True,
                      weights_column="__w" if p.weights_column else None)
        feat = [c for c in glm_frame.names if c not in ("__y", "__w")]
        lambdas_tried: list[tuple[float, float]] = []
        glm_loops = {"fits": 0, "iterations": 0, "admm_steps": 0,
                     "host_reads": 0}

        def tally(m):
            st = m.output.get("irls_stats", {})
            glm_loops["fits"] += 1
            glm_loops["iterations"] += st.get("iterations", 0)
            glm_loops["admm_steps"] += int(sum(st.get("admm_steps", [])))
            glm_loops["host_reads"] += st.get("host_reads", 0)
            return m

        if p.lambda_ is not None:
            lam = float(p.lambda_)
        else:
            # pick lambda on an internal 80/20 holdout by deviance
            tr, ho = glm_frame.split_frame([0.8], seed=abs(p.seed) or 99)
            probe = tally(GLM(**glm_kw).train(y="__y", x=feat,
                                              training_frame=tr))
            lmax = probe.output["lambda_max"]
            cand = np.geomspace(lmax, lmax * 1e-3, 8)
            best_lam, best_dev = float(cand[-1]), np.inf
            for lam_c in cand:
                m = tally(GLM(lambda_=float(lam_c), **glm_kw).train(
                    y="__y", x=feat, training_frame=tr, validation_frame=ho))
                dv = m.validation_metrics.value(
                    "logloss" if classification else "mse")
                lambdas_tried.append((float(lam_c), dv))
                if dv < best_dev - 1e-12:
                    best_dev, best_lam = dv, float(lam_c)
            lam = best_lam
            del tr, ho
        glm_model = tally(GLM(lambda_=lam, **glm_kw).train(
            y="__y", x=feat, training_frame=glm_frame))
        sync()
        secs["glm"] = time.perf_counter() - t0

        coefs = glm_model.coef
        imp = []
        for r in rules:
            c = coefs.get(r.name, 0.0)
            if abs(c) > 1e-12:
                imp.append({"variable": r.name, "coefficient": float(c),
                            "support": r.support, "rule": r.text})
        for n, _ in linear:
            c = coefs.get(f"linear.{n}", 0.0)
            if abs(c) > 1e-12:
                imp.append({"variable": f"linear.{n}",
                            "coefficient": float(c), "support": 1.0,
                            "rule": f"linear({n})"})
        imp.sort(key=lambda d: -abs(d["coefficient"]))

        out = {
            "bin_spec": spec,
            "rule_cols": rule_cols,
            "rule_masks": rule_masks,
            "rule_valid": rule_valid,
            "rule_names": rule_names,
            "rules": [{"name": r.name, "text": r.text, "support": r.support}
                      for r in rules],
            "linear_names": [n for n, _ in linear],
            "glm_model": glm_model,
            "forests": forests,
            "rule_importance": imp,
            "lambda": lam,
            "lambdas_tried": lambdas_tried,
            "rulefit_stats": {
                "seconds": secs, "glm_loops": glm_loops,
                "rules_extracted": n_extracted,
                "rules": len(rules),
                "matrix_bytes": 0 if Rmat is None
                else Rmat.numel() * Rmat.element_size()},
            "names": list(self._x),
            "response_domain": tuple(yv.domain) if classification else None,
        }
        del glm_frame, Rmat
        model = RuleFitModel(None, p, out)
        model.training_metrics = model._score_metrics(train)
        if valid is not None:
            model.validation_metrics = model._score_metrics(valid)
        return model
