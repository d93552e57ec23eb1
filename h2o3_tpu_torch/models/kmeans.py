"""K-means — the port of ``h2o3_tpu/models/kmeans.py`` (the successor of
``hex.kmeans.KMeans``: Lloyd iterations after a Furthest, PlusPlus or
Random start).

Each Lloyd iteration is one pass over the design matrix on its device
(:func:`_lloyd_step`): squared distances by one full-float32 product, the
assignment, the centroid sums and within-cluster sums by one-hot products,
the SSE; the host then reads the counts, sums and SSE in one transfer and
updates the centers in float32 numpy, as JAX does.

The start draws what JAX draws from the same numpy generator (the first
center, a dead cluster's reseed, the Furthest/PlusPlus sample of at most
100,000 rows), gathers only those rows on the device and pulls them; the
Furthest/PlusPlus recursion then runs in numpy on the pulled sample,
JAX's code on the same float32 values (numpy's pairwise float32 sums
decide the Furthest argmax at a near-tie, so the recursion stays there).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import INT, Frame, Vec
from h2o3_tpu_torch.models import metrics as MM
from h2o3_tpu_torch.models.datainfo import DataInfo
from h2o3_tpu_torch.models.model_base import (
    CommonParams,
    Model,
    ModelBuilder,
    gather_rows,
)
from h2o3_tpu_torch.ops.gram import full_fp32

SAMPLE_ROWS = 100_000  # the Furthest/PlusPlus start's sample (JAX's)


@dataclass
class KMeansParams(CommonParams):
    k: int = 2
    max_iterations: int = 10
    init: str = "Furthest"  # Furthest | PlusPlus | Random
    standardize: bool = True
    estimate_k: bool = False


def _lloyd_step(X, w, centers):
    """One Lloyd pass: ``(assign, sums, counts, sse, within)`` on ``X``'s
    device, every product in full float32."""
    k = centers.shape[0]
    with full_fp32():
        d2 = ((X * X).sum(1, keepdim=True) - 2.0 * (X @ centers.T)
              + (centers * centers).sum(1)[None, :])
        assign = torch.argmin(d2, dim=1)
        mind2 = torch.clamp(d2.min(dim=1).values, min=0.0)
        oh = (assign[:, None] == torch.arange(k, device=X.device)[None, :]
              ).to(torch.float32) * w[:, None]
        sums = oh.T @ X
        within = oh.T @ mind2
    counts = oh.sum(0)
    sse = (w * mind2).sum()
    return assign, sums, counts, sse, within


class KMeansModel(Model):
    algo = "kmeans"

    def _predict_raw(self, frame: Frame) -> torch.Tensor:
        """Each row's cluster id (int64) on the frame's device."""
        di: DataInfo = self.output["datainfo"]
        X, valid = di.transform(frame)
        centers = torch.from_numpy(np.array(self.output["centers_std"],
                                            np.float32)).to(X.device)
        return _lloyd_step(X, valid, centers)[0]

    def predict(self, frame: Frame) -> Frame:
        assign = self._predict_raw(self._apply_preprocessors(frame))
        return Frame([Vec(assign.to(torch.float32), INT)], ["predict"])

    @property
    def centers(self) -> np.ndarray:
        return self.output["centers"]


class KMeans(ModelBuilder):
    algo = "kmeans"
    PARAMS_CLS = KMeansParams

    def _validate(self, train, valid):
        pass  # unsupervised

    def _build(self, train: Frame, valid: Frame | None) -> Model:
        p: KMeansParams = self.params
        di = DataInfo.fit(train, self._x, standardize=p.standardize)
        X, w = di.transform(train)
        k = int(p.k)
        rng = np.random.default_rng(abs(p.seed) if p.seed and p.seed > 0 else 1)
        rows = torch.nonzero(w > 0).reshape(-1).cpu().numpy()
        centers = self._init_centers(X, rows, k, p.init, rng)
        host_reads = 3  # the row ids, the first center, the start's rows

        sse_prev = np.inf
        iterations = 0
        for _ in range(max(1, p.max_iterations)):
            _, sums, counts, sse, _ = _lloyd_step(
                X, w, torch.from_numpy(centers).to(X.device))
            packed = torch.cat([counts, sums.reshape(-1), sse[None]]).cpu()
            host_reads += 1
            iterations += 1
            counts_n = packed[:k].numpy()
            sums_n = packed[k:-1].numpy().reshape(k, -1)
            new_centers = np.where(
                counts_n[:, None] > 0,
                sums_n / np.maximum(counts_n[:, None], 1e-30), centers)
            # a dead cluster is seeded again (H2O re-initializes it)
            for ki in np.flatnonzero(counts_n == 0):
                new_centers[ki] = gather_rows(X, rng.choice(rows))
                host_reads += 1
            centers = new_centers.astype(np.float32)
            sse_now = float(packed[-1])
            if abs(sse_prev - sse_now) / max(sse_now, 1e-30) < 1e-6:
                break
            sse_prev = sse_now

        _, _, counts, _, within = _lloyd_step(
            X, w, torch.from_numpy(centers).to(X.device))
        counts_n, within_n = (t.cpu().numpy() for t in (counts, within))
        centers_orig = centers.copy()
        for c in di.columns:
            if c.kind == "num":
                centers_orig[:, c.offset] = centers[:, c.offset] * c.sigma + c.mean
        tot_within = float(within_n.sum(dtype=np.float32))
        gm = np.average(centers, axis=0, weights=np.maximum(counts_n, 1e-9))
        between = float(np.sum(counts_n * np.sum((centers - gm) ** 2, axis=1)))
        out = {
            "datainfo": di,
            "centers_std": centers,
            "centers": centers_orig,
            "names": list(self._x),
            "k": k,
            "size": counts_n.tolist(),
            "response_domain": None,
            "iterations": iterations,
            "host_reads": host_reads + 1,
        }
        model = KMeansModel(None, p, out)
        model.training_metrics = MM.ModelMetrics(
            "clustering",
            {
                "tot_withinss": tot_within,
                "betweenss": between,
                "totss": tot_within + between,
                "within_cluster_sum_of_squares": within_n.tolist(),
                "cluster_sizes": counts_n.tolist(),
            },
        )
        return model

    @staticmethod
    def _init_centers(X, rows, k, method, rng) -> np.ndarray:
        """JAX's start on the same draws: the rows it reads are gathered on
        the device and pulled, the recursion runs in numpy."""
        method = (method or "Furthest").lower()
        first = gather_rows(X, rng.choice(rows))
        if method == "random":
            return gather_rows(X, rng.choice(rows, size=k, replace=False))
        centers = [first]
        sample = gather_rows(X, rows if len(rows) <= SAMPLE_ROWS
                          else rng.choice(rows, SAMPLE_ROWS, replace=False))
        d2 = np.sum((sample - first) ** 2, axis=1)
        for _ in range(1, k):
            if method == "plusplus":
                probs = d2 / max(d2.sum(), 1e-30)
                nxt = sample[rng.choice(len(sample), p=probs)]
            else:
                nxt = sample[int(np.argmax(d2))]
            centers.append(nxt)
            d2 = np.minimum(d2, np.sum((sample - nxt) ** 2, axis=1))
        return np.stack(centers)
