"""The GLM Gram and the ADMM step alone on the card, by design variant.

    python -m h2o3_tpu_torch.tools.bench_gram [--rows N] [--out PATH]

For each GLM headline design (``datasets.higgs_like``: 29 columns padded
to 32; ``datasets.airlines_like``: 634 padded to 636) the headline GLM is
trained once (binomial, ``lambda_=1e-4``, ``max_iterations=20``), and at
its fitted beta the weighted Gram is timed (CUDA events) and held against
a float64 Gram of the same inputs (relative Frobenius error) for one
float32 GEMM over all rows and for ``ops.gram.weighted_gram``'s row
chunks of 4,096, 8,192, 16,384 and 65,536 rows (whole chunks as one
batched GEMM, added in float64). Then one ADMM x-update at the training's
Gram: the two triangular solves the solver runs, against a product with
the explicit inverse (``cholesky_inverse``), each as 200 updates in one
CUDA graph, and the relative difference of the two x. Prints one JSON
line per design (and writes them to ``--out``).
"""

from __future__ import annotations

import argparse
import json

import torch

CHUNKS = (0, 1 << 12, 1 << 13, 1 << 14, 1 << 16)  # 0: one GEMM


def _event_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _graph_ms(fn, k: int = 200) -> float:
    """Milliseconds per call of ``fn``, ``k`` calls in one CUDA graph."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(k):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / k


def bench(name: str, df, y: str) -> dict:
    from h2o3_tpu_torch import upload_file
    from h2o3_tpu_torch.estimators import H2OGeneralizedLinearEstimator
    from h2o3_tpu_torch.models import glm as G_
    from h2o3_tpu_torch.ops import gram

    fr = upload_file(df)
    est = H2OGeneralizedLinearEstimator(family="binomial", lambda_=1e-4,
                                        max_iterations=20)
    est.train(y=y, training_frame=fr)
    m = est.model
    di, X, yy, w, off = G_.training_inputs(m.params, fr, m.output["names"], 8)
    n, pp = X.shape
    P = di.ncols_expanded
    beta = torch.zeros(pp, device=X.device)
    beta[:P] = torch.as_tensor(m.output["beta_std"], dtype=torch.float32)
    W, z, _ = G_._irls_weights(m.output["family_obj"], X, yy, w, off, beta)
    X64 = X.double()
    G64 = (X64 * W.double()[:, None]).T @ X64
    del X64
    line = {"tool": "bench_gram", "frame": name, "rows": n, "cols": pp,
            "device": torch.cuda.get_device_name(0), "gram": {}}
    default = gram.GRAM_CHUNK_ROWS
    try:
        for R in CHUNKS:
            gram.GRAM_CHUNK_ROWS = R or n + 1
            ms = _event_ms(lambda: gram.weighted_gram(X, W, z))
            Gm, _, _ = gram.weighted_gram(X, W, z)
            err = torch.linalg.norm(Gm.double() - G64) / torch.linalg.norm(G64)
            line["gram"][str(R or "one_gemm")] = {"ms": ms,
                                                  "rel_fro": float(err)}
    finally:
        gram.GRAM_CHUNK_ROWS = default
    Gm, b, _ = gram.weighted_gram(X, W, z)
    del G64, X, W, z
    rho = float(torch.diagonal(Gm)[:P].mean())
    pad = (torch.arange(pp, device=Gm.device) >= P).to(torch.float32)
    A = Gm + torch.diag(pad) + (50.0 + rho) * torch.eye(pp, device=Gm.device)
    with gram.full_fp32():
        L, _ = torch.linalg.cholesky_ex(A)
        Ainv = torch.cholesky_inverse(L)
        r = b.clone()
        x_tri = gram._cho_solve(L, r)
        x_inv = Ainv @ r
        line["admm_x_update"] = {
            "triangular_solves_ms": _graph_ms(lambda: gram._cho_solve(L, r)),
            "inverse_product_ms": _graph_ms(lambda: Ainv @ r),
            "x_rel_diff": float((x_tri - x_inv).norm() / x_tri.norm()),
        }
    return line


def main() -> int:
    from h2o3_tpu_torch.datasets import airlines_like, higgs_like

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_gram needs a CUDA device")
    lines = []
    for name, make, y in (("higgs", higgs_like, "label"),
                          ("airlines", airlines_like, "IsDepDelayed")):
        lines.append(json.dumps(bench(name, make(a.rows, seed=0), y)))
        print(lines[-1], flush=True)
    if a.out:
        with open(a.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
