"""The port's B1 autotuner (``h2o3_tpu_torch/ops/hist_tiles.py``) against the
JAX package's (``h2o3_tpu/ops/hist_pallas.py``): the same shape buckets,
the same parsing of ``H2O3_TPU_PALLAS_TILES``, and the caching contract of
``tests/test_split_pallas.py::test_tile_autotuner_sweeps_once_per_bucket``
with the sweep replaced by a stub (the real sweep needs a card:
``tests/test_torch_cuda.py``)."""

import itertools
import json

import pytest

torch = pytest.importorskip("torch")

from h2o3_tpu.ops import hist_pallas as hp  # noqa: E402
from h2o3_tpu_torch import config  # noqa: E402
from h2o3_tpu_torch.ops import hist_cuda as hc  # noqa: E402
from h2o3_tpu_torch.ops import hist_tiles as ht  # noqa: E402

KNOB = "H2O3_TPU_PALLAS_TILES"


def test_knob_registered_with_the_jax_default():
    from h2o3_tpu import config as jax_config

    assert config._KNOBS[KNOB][0] == jax_config._KNOBS[KNOB][0] == ""


def test_tile_bucket_matches_jax():
    for c, n_nodes, n_bins, ns in itertools.product(
            (1, 4, 7, 8, 9, 28, 33, 100), (1, 2, 3, 8, 16, 17, 64, 2048),
            (2, 8, 9, 17, 64, 255, 256), (1, 3, 4)):
        assert (ht._tile_bucket(c, n_nodes, n_bins, ns)
                == hp._tile_bucket(c, n_nodes, n_bins, ns))


@pytest.mark.parametrize("spec", ["", "  ", "auto", "256,4,32", " 512, 8 ,64",
                                  "1,2", "1,2,3,4", "0,8,64", "-1,8,64",
                                  "a,b,c", "fast"])
def test_knob_parsing_matches_jax(monkeypatch, spec):
    """Explicit triples parse alike, invalid specs raise ValueError in both,
    and where JAX returns its built-in tiles ('' and 'auto') the port
    returns None, its built-in geometry."""
    monkeypatch.setenv(KNOB, spec)
    try:
        want = hp._tiles()
    except ValueError:
        with pytest.raises(ValueError):
            ht._tiles()
        return
    got = ht._tiles()
    if want == (hp.ROW_TILE, hp.COL_TILE, hp.NODE_TILE) and spec.strip() in (
            "", "auto"):
        assert got is None
    else:
        assert got == want


def test_sweep_grid_fits_and_holds_the_builtin():
    """Every candidate fits one block's shared memory and the built-in
    geometry is among them, at the headline buckets."""
    def wave(smem):  # an H100's clusters per wave (two blocks per SM)
        return (132 * min(2, hc.SMEM_PER_SM // (smem + hc.SMEM_RESERVED))
                // hc._CLUSTER)

    for n_nodes in (1, 2, 4, 8, 16):
        grid = ht._sweep_grid(1 << 20, 32, n_nodes, 256, 3, wave)
        assert hc.builtin_tiles(1 << 20, 32, n_nodes, 256, 3, wave) in grid
        assert len(set(grid)) == len(grid) >= 9
        for rows, cols, nodes in grid:
            assert nodes <= n_nodes
            smem = nodes * cols * 256 * 3 * 4
            assert smem <= hc.SMEM_LIMIT
            # one, two or four waves of the card, less what the column
            # groups leave over
            g = hc.launch_geometry(1 << 20, 32, n_nodes, 256, 3, wave,
                                   (rows, cols, nodes))
            used = g["clusters"] * g["colgroups"]
            assert any(k * wave(smem) - g["colgroups"] < used <= k * wave(smem)
                       for k in (1, 2, 4))


def test_tile_autotuner_sweeps_once_per_bucket(tmp_path, monkeypatch):
    """'auto': the first resolve of a bucket runs one sweep, a same-bucket
    resolve adds none, a cold in-process cache with a warm store adds none,
    and explicit triples bypass the tuner."""
    swept = []

    def fake_sweep(n, c, n_nodes, n_bins, ns, device):
        swept.append((n, c, n_nodes, n_bins, ns))
        return (4096, 8, 2), {(4096, 8, 2): 0.1, (2048, 8, 1): 0.2}

    monkeypatch.setattr(ht, "_run_tile_sweep", fake_sweep)
    monkeypatch.setattr(ht, "CACHE_PATH", tmp_path / "hist_tiles.json")
    monkeypatch.setattr(ht, "_TUNED", {})
    monkeypatch.setattr(ht.tiles_for, "sweeps", 0)
    monkeypatch.setenv(KNOB, "auto")
    cpu = torch.device("cpu")
    tiles = ht.tiles_for(1_000_000, 12, 64, 32, 3, cpu)
    assert tiles == (4096, 8, 2) and ht.tiles_for.sweeps == 1
    # the sweep ran at the bucket: 16 columns, 64 nodes, 32 bins, 2**20 rows
    assert swept == [(1 << 20, 16, 64, 32, 3)]
    # same bucket (columns to 16, nodes and bins to powers of two, rows to
    # 2**20): no sweep
    assert ht.tiles_for(600_000, 10, 50, 30, 3, cpu) == tiles
    assert ht.tiles_for.sweeps == 1
    # cold in-process cache, warm store: no sweep
    ht._TUNED.clear()
    assert ht.tiles_for(1_000_000, 12, 64, 32, 3, cpu) == tiles
    assert ht.tiles_for.sweeps == 1
    stored = json.loads((tmp_path / "hist_tiles.json").read_text())
    assert list(stored.values()) == [[4096, 8, 2]]
    # another row bucket is another key: one more sweep
    ht.tiles_for(5_000_000, 12, 64, 32, 3, cpu)
    assert ht.tiles_for.sweeps == 2
    monkeypatch.setenv(KNOB, "256,4,32")
    assert ht.tiles_for(1_000_000, 12, 64, 32, 3, cpu) == (256, 4, 32)
    monkeypatch.setenv(KNOB, "")
    assert ht.tiles_for(1_000_000, 12, 64, 32, 3, cpu) is None
    assert ht.tiles_for.sweeps == 2
