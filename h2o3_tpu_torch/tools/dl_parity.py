"""How far DeepLearning trainings on the card and on the CPU end apart,
beside the float32 trajectory's own sensitivity.

    python -m h2o3_tpu_torch.tools.dl_parity [--rows 10000 20000]
        [--epochs 2] [--out PATH]

For each row count: the first rows of the JAX bench's DeepLearning frame
(``datasets.mnist_like``, made on the card) trained with the DL headline's
network (``hidden=(128, 128)``, batch 256, seed 3, ADADELTA, dropout off)
on the card and on the CPU from the same initial weights; the CPU again
with the card's column statistics (the same design bits); and the CPU
again from the first layer's initial weights one float32 ulp up, and on
every feature one ulp up. Each pair's gap: the final weights (max |a - b|
over the largest weight), the first epoch's loss, each epoch's loss and
the training logloss (relative); and the card against the CPU after one
epoch. Prints one JSON line per row count (and writes them to ``--out``).
"""

from __future__ import annotations

import argparse
import json

import torch

KW = dict(hidden=(128, 128), mini_batch_size=256, seed=3)


def head(fr, rows: int, device):
    """The frame's first ``rows`` rows as a frame on ``device``."""
    from h2o3_tpu_torch.frame.frame import Frame, Vec

    vecs = [fr.vec(n) for n in fr.names]
    return Frame([Vec(v.data[:rows].to(device), v.kind, domain=v.domain)
                  for v in vecs], fr.names)


def fit(fr, epochs: float):
    from h2o3_tpu_torch.estimators import H2ODeepLearningEstimator

    est = H2ODeepLearningEstimator(epochs=epochs, **KW)
    est.train(x=fr.names[:-1], y="label", training_frame=fr)
    return est.model


def gaps(a, b) -> dict:
    """How far two trainings ended apart: the weights (max |a - b| over
    the largest of ``b``), the first epoch's loss, each epoch's loss and
    the training logloss (relative)."""
    la = [h["loss"] for h in a.scoring_history]
    lb = [h["loss"] for h in b.scoring_history]
    ta, tb = a.output["net"].tensors(), b.output["net"].tensors()
    top = max(float(t.abs().max()) for t in tb)
    return {"weights": max(float((x.to(y.device) - y).abs().max())
                           for x, y in zip(ta, tb)) / top,
            "first_epoch_loss": abs(la[0] - lb[0]) / abs(lb[0]),
            "epoch_loss": max(abs(x - y) / abs(y) for x, y in zip(la, lb)),
            "logloss": abs(a.training_metrics.logloss
                           - b.training_metrics.logloss)
            / b.training_metrics.logloss}


def one_ulp_up(t: torch.Tensor) -> torch.Tensor:
    return torch.nextafter(t, torch.full_like(t, float("inf")))


def first_layer_one_ulp_up(init):
    """``init`` (``deeplearning.init_mlp``) with the first layer's
    weights one ulp up."""
    def wrapped(*a, **k):
        net = init(*a, **k)
        net.Dense_0.weight.copy_(one_ulp_up(net.Dense_0.weight))
        return net
    return wrapped


def main() -> int:
    from h2o3_tpu_torch.datasets import mnist_like
    from h2o3_tpu_torch.frame.frame import Frame, Vec
    from h2o3_tpu_torch.models import deeplearning as pdl

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[10_000, 20_000])
    ap.add_argument("--epochs", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("dl_parity needs a CUDA device")
    fr = mnist_like(100_000, seed=5)
    init = pdl.init_mlp
    lines = []
    for rows in a.rows:
        cpu, card = head(fr, rows, "cpu"), head(fr, rows, "cuda")
        g, c = fit(card, a.epochs), fit(cpu, a.epochs)
        same = head(fr, rows, "cpu")
        for n in same.names:
            same.vec(n)._stats = card.vec(n).stats()
        s = fit(same, a.epochs)
        pdl.init_mlp = first_layer_one_ulp_up(init)
        try:
            u = fit(cpu, a.epochs)
        finally:
            pdl.init_mlp = init
        x_up = Frame([Vec(one_ulp_up(v.data) if n != "label" else v.data,
                          v.kind, domain=v.domain)
                      for n, v in ((n, cpu.vec(n)) for n in cpu.names)],
                     cpu.names)
        xu = fit(x_up, a.epochs)
        line = {"tool": "dl_parity", "rows": rows, "epochs": a.epochs, **KW,
                "device": torch.cuda.get_device_name(0),
                "card_vs_cpu": gaps(g, c),
                "card_vs_cpu_same_design": gaps(g, s),
                "cpu_first_layer_one_ulp_up": gaps(u, c),
                "cpu_features_one_ulp_up": gaps(xu, c),
                "card_vs_cpu_one_epoch": gaps(fit(card, 1.0), fit(cpu, 1.0))}
        lines.append(json.dumps(line))
        print(lines[-1], flush=True)
    if a.out:
        with open(a.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
