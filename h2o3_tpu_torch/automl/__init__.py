"""AutoML — the port of ``h2o3_tpu/automl``: a budgeted plan of modeling
steps over the ported builders, ranked on a leaderboard."""

from h2o3_tpu_torch.automl.automl import AutoML, Leaderboard


def get_leaderboard(aml: AutoML, extra_columns=()):
    """``h2o.automl.get_leaderboard``: the leaderboard's rows, with the
    extra columns asked for ("training_time_ms" or "ALL")."""
    lb = aml.leaderboard
    return lb.as_table(extra_columns=extra_columns) if lb else []


__all__ = ["AutoML", "Leaderboard", "get_leaderboard"]
