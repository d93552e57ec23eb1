"""Row and column sampling by keyed draws — the port of the masks JAX draws
in ``build_trees_scanned`` and ``_level_core``
(``h2o3_tpu/models/tree/shared_tree.py``: the row bootstrap, the per-tree
columns and the per-split columns).

Every draw is a counter-based hash, never a sequential generator:
``u = hash(seed, purpose, iteration, class, depth, index)``, a float32 in
[0, 1) from the hash's top 24 bits, and a draw keeps what has ``u < rate``
(JAX's ``uniform < rate`` and ``bernoulli(rate)``). So:

- a mask depends only on its key: the whole-tree build (CUDA graphs, which
  replay saturated levels past the one that split nothing) and the eager
  per-level loop (which stops there) draw the same masks for the same
  trees, and a chunk of 2 trees and one of 5 draw the same forest;
- the hash is 32-bit integer arithmetic held in int64 tensors, every
  multiply split into 16-bit halves and masked after each step, so no
  product overflows and the CPU and the card give the same bits;
- the same functions take Python ints or device tensors as key parts: a
  captured graph reads its seed, iteration, class slot and saturated depth
  from device buffers and draws anew on each replay.

Keys, as JAX keys them: the row bootstrap by (seed, iteration), shared by
the K class trees of an iteration; the per-tree columns by (seed,
iteration, class); the per-split columns by (seed, iteration, class,
depth), over node·C + column at the real column count C, so the bucketed
column padding cannot move a draw. A tree or a node that draws no column
keeps them all. torch cannot reproduce ``jax.random``'s streams: the port
draws the same distributions from other bits.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

M32 = 0xFFFFFFFF
# the purpose of a draw, the first part of its key after the seed
ROWS, TREE_COLS, SPLIT_COLS = 1, 2, 3


def _mul32(x, m: int):
    """``x · m mod 2^32`` for ``x`` in [0, 2^32): the multiplier in 16-bit
    halves keeps every product under 2^48."""
    lo, hi = m & 0xFFFF, m >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def mix(x):
    """A bijective 32-bit mixer (lowbias32) of an int or int64 tensor in
    [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def seed_key(seed: int) -> int:
    """The 32-bit key of a training's seed (any Python int)."""
    s = int(seed) & ((1 << 64) - 1)
    return mix(mix((s & M32) ^ 0x9E3779B9) ^ (s >> 32))


def fold(key, *parts):
    """``key`` with ``parts`` folded in, one mix each (ints or int64
    tensors; a tensor part makes a tensor key)."""
    for p in parts:
        key = mix(key ^ p)
    return key


def index_hash(n: int, device) -> torch.Tensor:
    """``mix(0..n-1)``: the per-index half of every draw over ``n`` slots,
    which a whole-tree state computes once."""
    return mix(torch.arange(n, dtype=torch.int64, device=device))


def uniform(key, idx_hash: torch.Tensor) -> torch.Tensor:
    """float32 uniforms in [0, 1), one per index, for ``key`` (an int or a
    (1,) int64 tensor) over the hashed indices ``idx_hash``."""
    u = mix(idx_hash ^ key) >> 8
    return u.to(torch.float32) * (1.0 / (1 << 24))


def _rate(rate, device) -> torch.Tensor:
    """A rate as a float32 tensor: the comparison rounds it as JAX does."""
    return torch.as_tensor(rate, dtype=torch.float32, device=device)


def row_mask(seed, iteration, rate, idx_hash: torch.Tensor) -> torch.Tensor:
    """The row bootstrap of one iteration: (n,) bool, Bernoulli(``rate``)."""
    key = fold(seed, ROWS, iteration)
    return uniform(key, idx_hash) < _rate(rate, idx_hash.device)


def tree_cols(seed, iteration, cls, rate, C: int,
              idx_hash: torch.Tensor) -> torch.Tensor:
    """The columns of one class tree: (C,) bool, all of them when none is
    drawn. ``idx_hash`` is :func:`index_hash` of at least C slots."""
    key = fold(seed, TREE_COLS, iteration, cls)
    keep = uniform(key, idx_hash[:C]) < _rate(rate, idx_hash.device)
    return keep | ~keep.any()


def split_key(seed, iteration, cls):
    """The key of one class tree's per-split draws; :func:`split_cols`
    folds the depth in."""
    return fold(seed, SPLIT_COLS, iteration, cls)


def split_cols(tree_key, depth, rate, n_pad: int, C: int,
               idx_hash: torch.Tensor) -> torch.Tensor:
    """The candidate columns of each node of one level: (n_pad, C) bool,
    drawn over node·C + column; a node that draws none keeps all.
    ``idx_hash`` is :func:`index_hash` of at least n_pad·C slots."""
    u = uniform(fold(tree_key, depth), idx_hash[: n_pad * C])
    keep = (u < _rate(rate, idx_hash.device)).reshape(n_pad, C)
    return keep | ~keep.any(dim=1, keepdim=True)


@dataclass(frozen=True)
class Sampling:
    """One training's sampling: the seed its draws are keyed by and the
    three rates. A rate of 1 draws nothing (every row or column kept)."""

    seed: int = 0
    sample_rate: float = 1.0
    col_sample_rate: float = 1.0
    col_sample_rate_per_tree: float = 1.0

    @property
    def key(self) -> int:
        return seed_key(self.seed)

    @property
    def rates(self) -> tuple[float, float, float]:
        return (self.sample_rate, self.col_sample_rate,
                self.col_sample_rate_per_tree)

    @property
    def draws(self) -> tuple[bool, bool, bool]:
        """Which draws exist: rows, per-split columns, per-tree columns."""
        return tuple(r < 1.0 for r in self.rates)

    def rows(self, iteration: int, w: torch.Tensor) -> torch.Tensor:
        """``w`` times iteration ``iteration``'s bootstrap (``w`` itself
        when rows are not sampled)."""
        if self.sample_rate >= 1.0:
            return w
        keep = row_mask(self.key, iteration, self.sample_rate,
                        index_hash(w.shape[0], w.device))
        return w * keep
