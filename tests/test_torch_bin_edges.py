"""The card's bin edges, classified: ``fit_bins`` takes another sample on
the card (an evenly strided one, float32 interpolation:
``_device_quantile_edges``) than on the CPU (a seeded ``rng.choice``
sample, float64 ``np.quantile``), by design, as the JAX package does by
backend. So the card's edges are not compared with the CPU branch's; the
device program is held here, on CPU tensors, against the JAX package's
``_device_quantile_edges`` run on the CPU, on the same strided sample of a
10k-row Higgs-like and claims-like frame: byte-equal. ``chip_smoke.py``'s
``bin_edges`` phase holds the card's edges to the bit against the same
program on CPU tensors at 1M rows.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu.frame.frame import Frame as JFrame  # noqa: E402
from h2o3_tpu.models.tree import binning as jbin  # noqa: E402
from h2o3_tpu_torch import datasets  # noqa: E402
from h2o3_tpu_torch.models.tree import binning as pbin  # noqa: E402

FRAMES = {"higgs_like": (datasets.higgs_like, "label"),
          "claims_like": (datasets.claims_like, None)}


@pytest.mark.parametrize("nbins,sample", [(255, 200_000), (20, 3000)],
                         ids=["all-rows", "strided-3000"])
@pytest.mark.parametrize("name", list(FRAMES))
def test_device_quantile_edges_byte_equal_to_jax(name, nbins, sample):
    make, response = FRAMES[name]
    df = make(10_000, seed=1)
    names = [c for c in df.columns if c != response]
    jf = JFrame.from_pandas(df)
    pf = h2o3_tpu_torch.upload_file(df, device="cpu")
    e, m = jbin._device_quantile_edges(jf, names, nbins, sample)
    ns = min(pf.nrow, sample)
    idx = torch.from_numpy(
        np.round(np.linspace(0, pf.nrow - 1, ns)).astype(np.int64))
    X = torch.stack([pf.vec(c).data[idx] for c in names], dim=1)
    ep, mp = pbin._device_quantile_edges(X, nbins)
    je, jm = np.asarray(e), np.asarray(m)
    assert ep.numpy().dtype == je.dtype and ep.numpy().tobytes() == je.tobytes()
    np.testing.assert_array_equal(mp.numpy(), jm)
