"""Grid search in the port (``h2o3_tpu_torch.models.grid``) against the JAX
package's (``h2o3_tpu/models/grid.py``), on the CPU at test size: the
walkers' sequences, a Cartesian GBM grid, the seeded RandomDiscrete
walker, a failing combination, grid-level early stopping, the sorted
metric table and ``best_model``, a DeepLearning grid, and the refusals.

The frame is JAX's grid test frame (``tests/test_grid_ensemble.py``'s
``_binary_df``: four normal features, a logistic label) with its features
rounded to a 0.1 grid: with continuous features two split candidates'
gains can agree within float32 noise, and the packages' different
summation orders then choose differently (``tests/test_torch_cv.py``).

Tolerances, with their reasons:
- walkers, hyperparameter orders, model counts, failures: equal (the same
  numpy generator and the same loop);
- GBM training metrics: 1e-5 absolute — float32 histogram sums in another
  order (JAX sums across an 8-device mesh), as ``tests/test_torch_cv.py``;
- DeepLearning: final weights and training metrics 1e-5 relative, from
  JAX's initial weights, as ``tests/test_torch_deeplearning.py``.
"""

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from h2o3_tpu.frame.frame import Frame as JFrame  # noqa: E402
from h2o3_tpu.models import deeplearning as jdl  # noqa: E402
from h2o3_tpu.models import grid as jgrid  # noqa: E402
from h2o3_tpu.models.tree.gbm import GBM as JGBM  # noqa: E402

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu_torch.models import deeplearning as pdl  # noqa: E402
from h2o3_tpu_torch.models import grid as pgrid  # noqa: E402
from h2o3_tpu_torch.models.model_base import get_model  # noqa: E402
from h2o3_tpu_torch.models.tree.gbm import GBM as PGBM  # noqa: E402

HYPER = {"max_depth": [2, 3], "learn_rate": [0.1, 0.3]}
METRICS = ("auc", "logloss", "rmse")


def grid_df(n=800, seed=7) -> pd.DataFrame:
    """``_binary_df`` of JAX's grid tests, features on a 0.1 grid."""
    rng = np.random.default_rng(seed)
    X = np.round(rng.normal(size=(n, 4)), 1)
    eta = X[:, 0] * 2 + X[:, 1] ** 2 - X[:, 2] - 1
    y = (rng.random(n) < 1 / (1 + np.exp(-eta))).astype(int)
    df = pd.DataFrame(X.astype(np.float32), columns=list("abcd"))
    df["y"] = np.where(y == 1, "Y", "N")
    return df


@pytest.fixture(scope="module")
def data():
    df = grid_df()
    return df, JFrame.from_pandas(df), h2o3_tpu_torch.upload_file(
        df, device="cpu")


@pytest.fixture(scope="module")
def cartesian(data):
    """The Cartesian GBM grid in both packages."""
    _, jf, pf = data
    kw = dict(ntrees=5, seed=42)
    jg = jgrid.GridSearch(JGBM, HYPER, **kw).train(y="y", training_frame=jf)
    pg = pgrid.GridSearch(PGBM, HYPER, **kw).train(y="y", training_frame=pf)
    return jg, pg


def _walks(hyper, **crit):
    return list(pgrid._walk(hyper, pgrid.SearchCriteria(**crit))), \
        list(jgrid._walk(hyper, jgrid.SearchCriteria(**crit)))


SPACE = {"max_depth": [3, 5, 7, 9], "learn_rate": [0.05, 0.1, 0.3],
         "sample_rate": [0.6, 1.0]}


@pytest.mark.parametrize("seed", [None, 1, 7, 42, 1234])
def test_walk_equals_jax(seed):
    """Cartesian: the product in JAX's order; RandomDiscrete: the whole
    space (24 combinations) in JAX's sequence for each seed."""
    if seed is None:
        got, want = _walks(SPACE)
    else:
        got, want = _walks(SPACE, strategy="RandomDiscrete", seed=seed)
    assert got == want
    assert len(got) == pgrid._space_size(SPACE) == 24
    assert len({tuple(sorted(h.items())) for h in got}) == 24


def test_search_criteria_names():
    c = pgrid.SearchCriteria(strategy="randomdiscrete", max_models=3)
    assert (c.strategy, c.max_models) == ("RandomDiscrete", 3)
    with pytest.raises(ValueError):
        pgrid.SearchCriteria(strategy="bayes")


def test_cartesian_gbm_grid_matches_jax(cartesian):
    """JAX's hyper_values order, and each model's training metrics within
    1e-5 of JAX's model of the same combination."""
    jg, pg = cartesian
    assert pg.hyper_values == jg.hyper_values
    assert pg.hyper_names == jg.hyper_names == list(HYPER)
    assert len(pg.models) == 4 and not pg.failures
    for jm, pm in zip(jg.models, pg.models):
        for name in METRICS:
            assert pm.training_metrics.value(name) == pytest.approx(
                jm.training_metrics.value(name), abs=1e-5), name


@pytest.mark.parametrize("metric", [None, "auc", "logloss"])
def test_sorted_metric_table_and_best_model(cartesian, metric):
    """The ranked table (AUTO = logloss, ascending; AUC descending) in
    JAX's order with the same hyperparameters, and ``best_model`` found
    by key (``get_model``)."""
    jg, pg = cartesian
    jt, pt = jg.sorted_metric_table(metric), pg.sorted_metric_table(metric)
    name = metric or "logloss"
    assert len(pt) == len(jt) == 4
    for p, j in zip(pt, jt):
        assert {k: p[k] for k in HYPER} == {k: j[k] for k in HYPER}
        assert p[name] == pytest.approx(j[name], abs=1e-5)
    vals = [r[name] for r in pt]
    assert vals == sorted(vals, reverse=(name == "auc"))
    best = pg.best_model(metric)
    assert best is get_model(pt[0]["model_id"])
    assert best.key == pt[0]["model_id"] and best in pg.models
    assert pg.model_ids == [m.key for m in pg.models]


def test_random_grid_respects_max_models_and_seed(data):
    """RandomDiscrete with max_models 3: three models, the same
    combinations in two runs and in JAX's walker."""
    _, _, pf = data
    crit = {"strategy": "RandomDiscrete", "max_models": 3, "seed": 99}
    hyper = {"max_depth": [2, 3, 4], "learn_rate": [0.05, 0.1, 0.3]}
    runs = [pgrid.GridSearch(PGBM, hyper, search_criteria=crit, ntrees=3,
                             seed=1).train(y="y", training_frame=pf)
            for _ in range(2)]
    assert len(runs[0].models) == 3
    assert runs[0].hyper_values == runs[1].hyper_values
    walk = jgrid._walk(hyper, jgrid.SearchCriteria(**crit))
    assert runs[0].hyper_values == [next(walk) for _ in range(3)]


def test_grid_keeps_failures_without_dying(data):
    """A failing combination (max_depth -5) is kept with its error and the
    grid goes on, as JAX's."""
    _, _, pf = data
    grid = pgrid.GridSearch(PGBM, {"max_depth": [2, -5, 3]}, ntrees=3,
                            seed=1).train(y="y", training_frame=pf)
    assert [h["max_depth"] for h in grid.hyper_values] == [2, 3]
    assert len(grid.failures) == 1
    hv, msg = grid.failures[0]
    assert hv == {"max_depth": -5} and "max_depth" in msg


@pytest.mark.parametrize("rounds,metric,tol", [(1, "AUTO", 1e-3),
                                               (1, "AUC", 0.5),
                                               (2, "AUTO", 1e-3)])
def test_grid_early_stopping_builds_as_many_as_jax(data, rounds, metric, tol):
    """Grid-level early stopping on the models' metric sequence: as many
    models built as JAX's grid builds on the same space."""
    _, jf, pf = data
    hyper = {"learn_rate": [0.3, 0.1, 0.05, 0.01], "max_depth": [2]}
    crit = dict(stopping_rounds=rounds, stopping_metric=metric,
                stopping_tolerance=tol)
    jg = jgrid.GridSearch(JGBM, hyper, search_criteria=crit, ntrees=5,
                          seed=42).train(y="y", training_frame=jf)
    pg = pgrid.GridSearch(PGBM, hyper, search_criteria=crit, ntrees=5,
                          seed=42).train(y="y", training_frame=pf)
    assert len(pg.models) == len(jg.models)
    assert pg.hyper_values == jg.hyper_values


def test_refusals(data, tmp_path):
    """``parallelism > 1`` raises, naming its ROADMAP item, before any
    model is built; an ``export_checkpoints_dir`` that cannot be written
    (under a regular file) fails every combination, each kept in
    ``grid.failures`` as JAX keeps a failing combination."""
    _, _, pf = data
    with pytest.raises(NotImplementedError, match="Queue A 4"):
        pgrid.GridSearch(PGBM, HYPER, parallelism=2).train(
            y="y", training_frame=pf)
    (tmp_path / "f").write_text("")
    g = pgrid.GridSearch(PGBM, HYPER, search_criteria={"max_models": 2},
                         export_checkpoints_dir=str(tmp_path / "f" / "ck")
                         ).train(y="y", training_frame=pf)
    assert not g.models and g.failures
    assert all("Error" in msg for _, msg in g.failures)


def _np_tree(params) -> dict:
    if hasattr(params, "items"):
        return {k: _np_tree(v) for k, v in params.items()}
    return np.asarray(params)


def test_deeplearning_grid_matches_jax(data, monkeypatch):
    """A DeepLearning grid (hidden [8] and [8, 8], 1 epoch): the port's
    models, each started from the initial weights of JAX's model of the
    same combination (read where JAX's builder hands them to its epoch
    driver), end within 1e-5 of JAX's weights and training metrics."""
    _, jf, pf = data
    monkeypatch.setenv("H2O3_TPU_DL_GRAD_SHARD", "0")
    seen = []
    orig = jdl._run_sync_sgd

    def spy(job, p, mlp, kind, tx, params, *a, **k):
        seen.append(_np_tree(params))
        return orig(job, p, mlp, kind, tx, params, *a, **k)

    monkeypatch.setattr(jdl, "_run_sync_sgd", spy)
    hyper = {"hidden": [[8], [8, 8]]}
    kw = dict(epochs=1, mini_batch_size=32, seed=7)
    jg = jgrid.GridSearch(jdl.DeepLearning, hyper, **kw).train(
        y="y", training_frame=jf)
    inits = iter(seen)

    def initial(self, d_in, d_pad, n_out, device):
        return pdl.mlp_from_numpy(next(inits), self.params.activation, device)

    monkeypatch.setattr(pdl.DeepLearning, "_initial_net", initial)
    pg = pgrid.GridSearch(pdl.DeepLearning, hyper, **kw).train(
        y="y", training_frame=pf)
    assert pg.hyper_values == jg.hyper_values and len(pg.models) == 2
    for jm, pm in zip(jg.models, pg.models):
        tree = _np_tree(jm.output["params"])["params"]
        for i, d in enumerate(pm.output["net"].dense()):
            for got, want in ((d.weight.numpy().T,
                               tree[f"Dense_{i}"]["kernel"]),
                              (d.bias.numpy(), tree[f"Dense_{i}"]["bias"])):
                np.testing.assert_allclose(
                    got, want, rtol=1e-5,
                    atol=1e-5 * max(1e-30, np.abs(want).max()))
        for name in ("logloss", "auc"):
            assert pm.training_metrics.value(name) == pytest.approx(
                jm.training_metrics.value(name), rel=1e-5), name
