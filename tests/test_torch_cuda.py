"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a GPU. The file imports
neither JAX nor the JAX package, so it also runs where only PyTorch is
installed, without the JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the histogram kernel merges with float atomics, so with float
stats it is held against an exact float64 sum to 1e-5 of the cell's absolute
mass (float32 rounding in any summation order stays far inside that);
integer-valued stats sum exactly in any order, and there the kernels must
match their plain versions bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from h2o3_tpu_torch.ops.hist_cuda import hist_cuda, hist_plain  # noqa: E402
from h2o3_tpu_torch.ops.split_cuda import (  # noqa: E402
    fused_split_scan,
    split_candidates_cuda,
    split_candidates_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(n, C, N, B, seed, integer):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, (n, C)).astype(np.uint8)
    nid = rng.integers(0, N, n).astype(np.int32)
    nid[rng.random(n) < 0.1] = -1
    if integer:
        w = np.ones(n, np.float32)
        t = rng.integers(-3, 4, n).astype(np.float32)
        stats = np.stack([w, t, w], axis=1)
    else:
        w = rng.random(n).astype(np.float32)
        stats = np.stack([w, w * rng.normal(size=n).astype(np.float32),
                          w * rng.random(n).astype(np.float32)], axis=1)
    return bins, nid, stats


@pytest.mark.parametrize("n_nodes,n_bins,C", [(1, 256, 28), (8, 256, 28),
                                              (32, 256, 7), (5, 17, 6)])
@pytest.mark.parametrize("integer", [False, True], ids=["float", "integer"])
def test_hist_kernel_matches_plain(dev, n_nodes, n_bins, C, integer):
    bins, nid, stats = _case(100_003, C, n_nodes, n_bins, seed=n_nodes,
                             integer=integer)
    args = [torch.from_numpy(a).to(dev) for a in (bins, nid, stats)]
    before = hist_cuda.launches
    got = hist_cuda(*args, n_nodes, n_bins)
    assert hist_cuda.launches == before + 1
    if integer:
        assert torch.equal(got, hist_plain(*args, n_nodes, n_bins))
    else:
        b, n_, st = args
        ref64 = hist_plain(b, n_, st.double(), n_nodes, n_bins)
        mass = hist_plain(b, n_, st.double().abs(), n_nodes, n_bins)
        err = ((got.double() - ref64).abs() / mass.clamp(min=1.0)).max().item()
        assert err < 1e-5, err


@pytest.mark.parametrize("n_bins", [256, 16, 3])
def test_split_kernel_bit_equal_on_integer_histograms(dev, n_bins):
    bins, nid, stats = _case(50_000, 13, 8, n_bins, seed=n_bins, integer=True)
    bins[:, 5] = bins[:, 2]  # duplicated columns: exact ties across columns
    h = hist_plain(*(torch.from_numpy(a) for a in (bins, nid, stats)), 8,
                   n_bins)
    tot = h[:, 0].sum(dim=1)
    got = split_candidates_cuda(h.to(dev), tot.to(dev), 10.0)
    for a, b in zip(got, split_candidates_plain(h, tot, 10.0)):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


def test_fused_scan_on_card_equals_cpu(dev):
    """The whole per-node decision (kernel candidates + categorical branch
    + column argmax) on the card equals the CPU one on integer data."""
    bins, nid, stats = _case(50_000, 9, 4, 32, seed=7, integer=True)
    bins[:, 3] = bins[:, 3] % 6  # a categorical column
    h = hist_plain(*(torch.from_numpy(a) for a in (bins, nid, stats)), 4, 32)
    is_cat = torch.zeros(9, dtype=torch.bool)
    is_cat[3] = True
    mask = torch.ones(4, 9)
    cpu = fused_split_scan(h, is_cat, mask, 10.0, 0.0, (3,))
    gpu = fused_split_scan(h.to(dev), is_cat.to(dev), mask.to(dev), 10.0, 0.0,
                           (3,))
    for k, v in cpu.items():
        assert torch.equal(gpu[k].cpu(), v), k
