"""The rules ``chip_smoke.py`` holds two tree models of one training by
(``h2o3_tpu_torch.tools.tree_parity``), on small XGBoost models on the
CPU: equal trainings do not part; a boosted model's first parting
iteration is held to a float near-tie (NEAR_TIE, relative gains), its
later iterations, grown on other scores, are listed but not held, and a
forest (``boosted=False``) holds every tree; the score gap before the first
parting is 0 on equal trees."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu_torch.datasets import higgs_like  # noqa: E402
from h2o3_tpu_torch.estimators import H2OXGBoostEstimator  # noqa: E402
from h2o3_tpu_torch.tools import tree_parity as tp  # noqa: E402

NTREES = 6


def _fit(df):
    est = H2OXGBoostEstimator(ntrees=NTREES, max_depth=4, seed=1)
    est.train(y="label", training_frame=h2o3_tpu_torch.upload_file(
        df, device="cpu"))
    return est


def _with_trees(est, trees):
    """A shallow copy of ``est`` whose model holds ``trees``."""
    import copy

    out = copy.copy(est)
    out.model = copy.copy(est.model)
    out.model.output = {**est.model.output, "trees": list(trees)}
    return out


@pytest.fixture(scope="module")
def models():
    df = higgs_like(3000, 8, seed=1)
    other = df.copy()
    other.iloc[:, 0] = other.iloc[:, 0].to_numpy()[::-1]
    a, b, c = _fit(df), _fit(df), _fit(other)
    ta, tc = a.model.output["trees"], c.model.output["trees"]
    # tree 0 equal, then trees grown on other data
    spliced = _with_trees(c, [ta[0]] + list(tc[1:]))
    y = (df["label"].to_numpy() == "s").astype(np.float64)
    return {"a": a, "b": b, "c": c, "spliced": spliced, "df": df, "y": y}


def test_equal_trainings_do_not_part(models):
    a, b = models["a"], models["b"]
    d = tp.divergences(a, b)
    assert d == {"class_trees_equal": NTREES,
                 "class_trees_parting_at_a_near_tie": 0,
                 "class_trees_parting_on_other_scores": 0, "partings": []}
    fr = h2o3_tpu_torch.upload_file(models["df"], device="cpu")
    assert tp.score_gaps(a, b, fr, range(NTREES + 1)) == {
        str(n): 0.0 for n in range(NTREES + 1)}
    assert tp.auc_path(a, fr, models["y"]) == tp.auc_path(b, fr, models["y"])


@pytest.mark.parametrize("pair,iteration", [("c", 0), ("spliced", 1)])
@pytest.mark.parametrize("boosted", [True, False])
def test_first_parting_must_be_a_near_tie(models, pair, iteration, boosted):
    with pytest.raises(AssertionError, match="no near-tie") as e:
        tp.divergences(models["a"], models[pair], boosted=boosted)
    assert f"'iteration': {iteration}," in str(e.value)


def test_later_iterations_of_a_boosted_model_are_not_held(models,
                                                          monkeypatch):
    # every gain pair passes as a near-tie, so the first parting iteration
    # (1) is held and passes; the rule still marks which partings it held
    monkeypatch.setattr(tp, "NEAR_TIE", 1.0)
    d = tp.divergences(models["a"], models["spliced"])
    its = [p["iteration"] for p in d["partings"]]
    assert its[0] == 1 and len(its) > 1
    assert [p["held"] for p in d["partings"]] == [i == 1 for i in its]
    assert d["class_trees_parting_at_a_near_tie"] == its.count(1)
    assert d["class_trees_parting_on_other_scores"] == len(its) - its.count(1)
    assert d["class_trees_equal"] == NTREES - len(its)
    # a forest's trees share one target: every parting is held
    f = tp.divergences(models["a"], models["spliced"], boosted=False)
    assert all(p["held"] for p in f["partings"])
    assert f["class_trees_parting_on_other_scores"] == 0


def test_score_gap_is_zero_up_to_the_first_parting(models):
    fr = h2o3_tpu_torch.upload_file(models["df"], device="cpu")
    gaps = tp.score_gaps(models["a"], models["spliced"], fr, [0, 1, 2])
    assert gaps["0"] == 0.0 and gaps["1"] == 0.0 and gaps["2"] > 1e-3


def test_tool_runs_on_the_cpu(tmp_path, monkeypatch):
    out = tmp_path / "tp.jsonl"
    monkeypatch.setattr("sys.argv", [
        "tree_parity", "--rows", "2000", "--cols", "8", "--trees", "3",
        "--cpu-only", "--out", str(out)])
    assert tp.main() == 0
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert [x["model"] for x in lines] == ["cpu",
                                           "cpu_weights_one_ulp_under_1"]
    ulp = lines[1]
    assert len(ulp["auc_delta_path"]) == 3
    assert ulp["auc_delta"] == ulp["auc_delta_path"][-1] < 1e-2
