"""Where a DeepLearning training's time goes on the card.

    python -m h2o3_tpu_torch.tools.profile_dl [--rows N] [--cols D]
        [--epochs E] [--autoencoder] [--out PATH]

Makes the JAX bench's DeepLearning frame on the card
(``datasets.mnist_like``: 100,000 x 784 float columns, 10 classes by
default) and trains its headline: ``hidden=(128, 128)``, ``epochs=1``,
``mini_batch_size=256``, ``seed=3``, Rectifier, ADADELTA (``bench.py``'s
``_bench_dl``); with ``--autoencoder`` the autoencoder with
``hidden=(128,)`` on the same features. A first training (it captures
the step graphs), then a warm one, timed; then a warm training under
``torch.profiler``: the host seconds of the ``dl.*`` spans (``DataInfo``'s
fit and transform, loading the state, each epoch's graph replays, the
training metrics), the device milliseconds in each, the busiest kernels,
the device-busy seconds and the idle share. Prints one JSON line (and
writes it to ``--out``).
"""

from __future__ import annotations

import argparse
import json

import torch

from h2o3_tpu_torch.tools.profile_glm import timed, traced

DL_KW = dict(hidden=(128, 128), epochs=1.0, mini_batch_size=256, seed=3)
AE_KW = dict(hidden=(128,), epochs=1.0, mini_batch_size=256, seed=3)
LEAVES = ("dl.datainfo", "dl.transform", "dl.load", "dl.epoch",
          "dl.metrics", "dl.predict")


def main() -> int:
    from h2o3_tpu_torch.datasets import mnist_like
    from h2o3_tpu_torch.estimators import (
        H2OAutoEncoderEstimator,
        H2ODeepLearningEstimator,
    )

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--cols", type=int, default=784)
    ap.add_argument("--epochs", type=float, default=1.0)
    ap.add_argument("--autoencoder", action="store_true")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_dl needs a CUDA device")
    fr, make_s = timed(lambda: mnist_like(a.rows, d=a.cols))
    kw = dict(AE_KW if a.autoencoder else DL_KW, epochs=a.epochs)
    x = fr.names[:-1]

    def train():
        if a.autoencoder:
            est = H2OAutoEncoderEstimator(**kw)
            est.train(x=x, training_frame=fr)
        else:
            est = H2ODeepLearningEstimator(**kw)
            est.train(x=x, y="label", training_frame=fr)
        return est

    _, first_s = timed(train)
    est, warm_s = timed(train)
    st = est.model.output["sgd_stats"]
    mm = est.model.training_metrics
    line = {
        "tool": "profile_dl", "rows": a.rows, "cols": a.cols,
        "autoencoder": a.autoencoder,
        **{k: v for k, v in kw.items()},
        "device": torch.cuda.get_device_name(0),
        "make_frame_s": make_s, "first_train_s": first_s,
        "warm_train_s": warm_s,
        "rows_per_s": a.rows * st["epochs"] / warm_s,
        "steps_per_s": st["steps"] / warm_s,
        "sgd_stats": st,
        "metric": mm.mse if a.autoencoder else mm.logloss,
        "warm_traced": traced(train, prefix="dl.", leaves=LEAVES),
    }
    text = json.dumps(line)
    print(text, flush=True)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
