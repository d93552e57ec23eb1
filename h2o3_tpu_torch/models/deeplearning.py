"""DeepLearning — the port of ``h2o3_tpu/models/deeplearning.py``: a
fully connected MLP trained by synchronous minibatch SGD (the JAX
package's replacement for H2O's Hogwild!), and the autoencoder.

The network is JAX's flax ``_MLP`` as an ``nn.Module`` of ``nn.Linear``
layers named ``Dense_i`` as flax names them: input dropout, then for each
hidden layer ``Dense`` → activation → dropout, then a linear head
(``maxout`` is ReLU, as in JAX). Initialization is flax's ``lecun_normal``
(a normal truncated to ±2, times ``sqrt(1/fan_in)/0.8796...``) with zero
biases, drawn from a ``torch.Generator`` seeded by ``seed``: the bits
cannot equal JAX's, so parity with JAX starts from JAX's initial weights
(:func:`mlp_from_numpy`).

One step is written out by hand — forward, the row loss (softmax cross
entropy on the integer label, the squared error of ``out[:, 0]``, or the
row mean of the squared reconstruction error), ``sum(w·l)/max(sum w,
1e-9)`` plus ``l2·½Σq²`` and ``l1·Σ|q|`` over every parameter, the
backward pass, and ADADELTA at learning rate 1 or momentum SGD with
optax's continuous exponential decay, both in optax 0.2.6's operation
order — on fixed buffers, in full float32 (no TF32), with no host read
and no allocation that changes between steps.

The epoch driver is JAX's replicated lane (``_run_sync_sgd``): ``batch =
min(mini_batch_size, npad)``, ``nbatch = max(1, nrow // batch)`` (the rows
past ``nbatch·batch`` are dropped each epoch), the slot mask over padded
permutation slots, one ``numpy`` permutation per epoch from
``default_rng(seed)`` (so the port visits rows in JAX's order, bit for
bit), each epoch's loss the mean of its steps' losses, and epoch-loss
early stopping. On the card an epoch is CUDA-graph replays — a block of
16 steps, then one graph of the ``nbatch mod 16`` steps left — that read
the step from a device counter and gather their rows by ``index_select``
from the epoch's permutation, uploaded once per epoch; the host reads the
epoch's loss once. The buffers and graphs are cached per training shape:
weights, optimizer state, the design, ``w``, ``l1``, ``l2`` and the seed
are loaded state, so a second training of the shape, a cross-validation
fold or another ``l1``/``l2`` replays them with no capture.

Dropout masks are keyed counter hashes of (seed, epoch, step, layer,
index) (``models/tree/sampling.py``): the graph, the eager loop, the CPU
and the card draw the same masks. flax's ``bernoulli`` bits cannot be
matched, so parity with JAX runs with dropout off.

Checkpoints, as in JAX: a trained model keeps its optimizer state
(``output["opt_state"]``: the flat ADADELTA accumulators, or momentum
SGD's trace and step count); ``checkpoint=`` continues a training whose
``hidden``, ``activation``, ``standardize``, ``adaptive_rate`` (and
``autoencoder``) and design width are unchanged, to ``epochs`` above the
prior's: its weights (repadded to this training's input bucket) and, when
the shapes match, its optimizer state are loaded into the plan's buffers,
the permutation stream is advanced past the prior's epochs and the
dropout masks key on the absolute epoch, so the resumed run is the
uninterrupted one (on the card, a cached plan captures nothing). With
``export_checkpoints_dir`` each epoch writes a snapshot.

Not ported yet, refused with ``NotImplementedError``: the streamed lane a
design larger than ``H2O3_TPU_HBM_WINDOW_BYTES`` takes (ROADMAP Queue A
6), and the sharded-gradient and ctl lanes
(``H2O3_TPU_DL_GRAD_SHARD=1|ctl``, Queue A 8), which need more than one
device.
"""

from __future__ import annotations

import itertools
import logging
import math
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from h2o3_tpu_torch import config
from h2o3_tpu_torch.device import resolve
from h2o3_tpu_torch.frame.frame import NUM, Frame, Vec
from h2o3_tpu_torch.models import metrics as MM
from h2o3_tpu_torch.models.datainfo import DataInfo
from h2o3_tpu_torch.models.model_base import (
    CommonParams,
    Model,
    ModelBuilder,
    ScoreKeeper,
    _make_metrics,
    check_checkpoint_compat,
    resolve_checkpoint,
)
from h2o3_tpu_torch.models.tree import sampling
from h2o3_tpu_torch.ops.gram import full_fp32

_LOG = logging.getLogger(__name__)


@dataclass
class DeepLearningParams(CommonParams):
    hidden: Sequence[int] = field(default_factory=lambda: (200, 200))
    epochs: float = 10.0
    activation: str = "Rectifier"
    input_dropout_ratio: float = 0.0
    hidden_dropout_ratios: Sequence[float] | None = None
    l1: float = 0.0
    l2: float = 0.0
    adaptive_rate: bool = True
    rho: float = 0.99
    epsilon: float = 1e-8
    rate: float = 0.005
    rate_decay: float = 1.0
    momentum_start: float = 0.0
    # a documented deviation of the JAX package, kept: H2O's default is 1
    mini_batch_size: int = 32
    standardize: bool = True
    loss: str = "Automatic"
    reproducible: bool = True  # sync SGD is deterministic by construction
    autoencoder: bool = False  # reconstruct inputs; y is ignored
    hash_buckets: int | None = None


_ACTIVATIONS = {"rectifier": "relu", "rectifierwithdropout": "relu",
                "tanh": "tanh", "tanhwithdropout": "tanh",
                "maxout": "relu"}  # maxout approximated, as in JAX


def _resolved_dropout(p, n_hidden: int) -> tuple:
    """The dropout-default rule (``WithDropout`` activations default to
    0.5): one source for the network and the ``model_summary`` table."""
    return tuple(
        p.hidden_dropout_ratios
        or ((0.5,) * n_hidden if "dropout" in p.activation.lower()
            else (0.0,) * n_hidden))


class MLP(nn.Module):
    """JAX's flax ``_MLP``: ``Dense_0 .. Dense_{L-1}`` (the last is the
    linear head). ``forward`` is the scoring pass (no dropout); training
    runs :class:`_SgdState`'s hand-written float32 step, with the
    training's dropout rates, on copies of the weights."""

    def __init__(self, d_in: int, hidden: Sequence[int], n_out: int,
                 activation: str = "Rectifier"):
        super().__init__()
        act = activation.lower()
        if act not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.activation = activation
        self.act = _ACTIVATIONS[act]
        self.hidden = tuple(int(h) for h in hidden)
        widths = (int(d_in), *self.hidden, int(n_out))
        for i in range(len(widths) - 1):
            # zeros, not nn.Linear's own draws from the global generator
            lin = nn.utils.skip_init(nn.Linear, widths[i], widths[i + 1])
            self.add_module(f"Dense_{i}", lin)
        self.requires_grad_(False)
        for t in self.tensors():
            t.zero_()

    def dense(self) -> list[nn.Linear]:
        return [getattr(self, f"Dense_{i}") for i in range(len(self.hidden) + 1)]

    def tensors(self) -> list[torch.Tensor]:
        """[W0, b0, W1, b1, ...]: each weight (out, in), each bias."""
        return [t for d in self.dense() for t in (d.weight, d.bias)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The scoring pass, in float64 (the offline scorer's precision:
        a float32 pass over 784 inputs is ~3e-6 off in a probability),
        returned as float32."""
        layers = self.dense()
        x = x.double()
        for d in layers[:-1]:
            x = _act(torch.addmm(d.bias.double(), x, d.weight.double().t()),
                     self.act)
        return torch.addmm(layers[-1].bias.double(), x,
                           layers[-1].weight.double().t()).float()


def _act(z: torch.Tensor, act: str) -> torch.Tensor:
    return torch.relu(z) if act == "relu" else torch.tanh(z)


def lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's ``lecun_normal``: a standard normal truncated to [-2, 2]
    times ``sqrt(1/fan_in)/0.87962566103423978`` (the truncated normal's
    standard deviation), in place."""
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    w.mul_(math.sqrt(1.0 / fan_in) / 0.87962566103423978)


def init_mlp(p, d_in: int, d_pad: int, n_out: int, device) -> MLP:
    """A fresh network for ``p`` at input width ``d_in``: flax's
    initialization at the exact width (the fan-in never sees the bucket
    padding), drawn on the CPU from ``torch.Generator`` seeded by ``seed``
    (99 when unset), so every device starts from the same bits; the first
    weight's padded input columns (``d_pad - d_in``) are zero."""
    seed = abs(p.seed) if p.seed and p.seed > 0 else 99
    gen = torch.Generator().manual_seed(int(seed))
    net = MLP(d_pad, p.hidden, n_out, p.activation)
    widths = (d_in, *net.hidden)
    for d, fan_in in zip(net.dense(), widths):
        lecun_normal_(d.weight[:, :fan_in], fan_in, gen)
    return net.to(resolve(device))


def mlp_from_numpy(tree: dict, activation: str = "Rectifier",
                   device=None) -> MLP:
    """A port network from a flax parameter tree as numpy arrays: ``tree
    ["params"]["Dense_i"]`` (or ``tree["Dense_i"]``) with ``kernel`` of
    shape (in, out) and ``bias``. The port's weight is the kernel's
    transpose."""
    prm = tree.get("params", tree)
    names = sorted(prm, key=lambda k: int(k.split("_")[-1]))
    kernels = [np.array(prm[k]["kernel"], np.float32) for k in names]
    hidden = [k.shape[1] for k in kernels[:-1]]
    net = MLP(kernels[0].shape[0], hidden, kernels[-1].shape[1], activation)
    for d, k, name in zip(net.dense(), kernels, names):
        d.weight.copy_(torch.from_numpy(k.T.copy()))
        d.bias.copy_(torch.from_numpy(np.array(prm[name]["bias"],
                                               np.float32)))
    return net.to(resolve(device))


def opt_state_from_numpy(state: dict, net: MLP) -> dict:
    """Optimizer state from optax's, as numpy flax-shaped trees: ADADELTA's
    ``{"e_g": tree, "e_x": tree}`` or momentum SGD's ``{"trace": tree or
    None, "count": int}``. Each tree is ``{"Dense_i": {"kernel", "bias"}}``
    (optionally under ``"params"``); kernels are transposed to the port's
    (out, in) layout. Returns the port's ``{name: [tensor per parameter]}``
    (``count``: an int32 scalar tensor)."""
    dev = net.Dense_0.weight.device

    def flat(tree):
        prm = tree.get("params", tree)
        names = sorted(prm, key=lambda k: int(k.split("_")[-1]))
        out = []
        for k in names:
            out.append(torch.from_numpy(np.asarray(
                prm[k]["kernel"], np.float32).T.copy()).to(dev))
            out.append(torch.from_numpy(np.array(
                prm[k]["bias"], np.float32)).to(dev))
        return out

    out = {}
    for name, v in state.items():
        if name == "count":
            out[name] = torch.tensor(int(v), dtype=torch.int32, device=dev)
        elif v is not None:
            out[name] = flat(v)
    return out


def _dl_pad_cols(d: int) -> int:
    """The supervised input width's shape bucket (JAX's ``_dl_pad_cols``):
    a multiple of 4 under ``H2O3_TPU_SHAPE_BUCKETS``. The padded columns
    are zero and so are the first weight's columns that read them; their
    gradients are zero, so the trajectory is the exact-width one."""
    if not config.get_bool("H2O3_TPU_SHAPE_BUCKETS"):
        return d
    return -(-d // 4) * 4


def jax_npad(nrow: int) -> int:
    """The padded row count JAX's batch rule sees on one device
    (``h2o3_tpu.parallel.mesh.pad_to_shards`` with one shard): a multiple
    of 8, bucketed above 65,536 rows under ``H2O3_TPU_SHAPE_BUCKETS``.
    It decides the batch only on frames smaller than a minibatch."""
    n = nrow
    if n > (1 << 16) and config.get_bool("H2O3_TPU_SHAPE_BUCKETS"):
        step = 1 << (n.bit_length() - 5)
        n = -(-n // step) * step
    return max(8, -(-n // 8) * 8)


# -- the step ----------------------------------------------------------------

DROPOUT = 4  # the purpose of a dropout draw (sampling.py's keys use 1-3)
STEPS_PER_GRAPH = 16
# "auto": CUDA graphs on the card, the eager loop on the CPU; "eager": one
# step at a time on any device; "block": the graphs' step blocks run
# eagerly (the control of the graph path on any device)
STEP_MODE = "auto"


@dataclass(frozen=True)
class _Plan:
    """A training's shape and its fixed hyperparameters: everything a
    captured step graph bakes in. Data, weights, optimizer state, ``l1``,
    ``l2`` and the seed are loaded state."""

    widths: tuple  # (d_in, *hidden, n_out)
    act: str
    dropout: tuple  # (input, hidden...)
    kind: str  # ce | mse | recon
    nrow: int
    batch: int
    nbatch: int
    adaptive: bool
    rho: float
    eps: float
    rate: float
    rate_decay: float
    momentum: float

    @property
    def nslots(self) -> int:
        return self.nbatch * self.batch


class _SgdState:
    """One plan's fixed buffers on a device and, on the card, its step
    graphs: :meth:`load` copies a training's inputs in, :meth:`epoch` runs
    one epoch and returns its loss (one host read), :meth:`unload` copies
    the trained weights out."""

    def __init__(self, plan: _Plan, device):
        dev = torch.device(device)
        f32 = dict(dtype=torch.float32, device=dev)
        self.plan, self.device = plan, dev
        w = plan.widths
        # every per-parameter quantity is one flat buffer with a view per
        # parameter (W0, b0, W1, b1, ...): the penalties and the optimizer
        # are a few elementwise kernels over the whole of it
        self.shapes = [s for a, b in zip(w[:-1], w[1:]) for s in ((b, a), (b,))]
        n = sum(math.prod(s) for s in self.shapes)
        self.flat, self.params = self._flat(n, f32)
        self.gflat, self.grads = self._flat(n, f32)
        self.e_g = self.e_x = self.trace = None
        if plan.adaptive:
            self.e_g = torch.zeros(n, **f32)
            self.e_x = torch.zeros(n, **f32)
        elif plan.momentum:
            self.trace = torch.zeros(n, **f32)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.X = torch.zeros((plan.nrow, w[0]), **f32)
        self.y = torch.zeros(plan.nrow, **f32)
        self.w = torch.zeros(plan.nrow, **f32)
        self.perm = torch.zeros(plan.nslots, dtype=torch.int64, device=dev)
        self.slot = (torch.arange(plan.nslots, device=dev)
                     < plan.nrow).to(torch.float32)
        self.ar = torch.arange(plan.batch, device=dev)
        self.step = torch.zeros((), dtype=torch.int64, device=dev)
        self.epoch_t = torch.zeros((), dtype=torch.int64, device=dev)
        self.seed = torch.zeros((), dtype=torch.int64, device=dev)
        self.loss_sum = torch.zeros((), **f32)
        self.l1 = torch.zeros((), **f32)
        self.l2 = torch.zeros((), **f32)
        self.rate_decay = torch.tensor(plan.rate_decay, **f32)
        # the per-index halves of the dropout draws of each masked layer
        self.idx = [sampling.index_hash(plan.batch * width, dev)
                    if rate > 0 else None
                    for rate, width in zip(plan.dropout, w[:-1])]
        self.graphs: tuple | None = None
        self.pool_bytes = 0
        self.replays = 0

    def _flat(self, n: int, f32: dict) -> tuple:
        """A flat buffer of ``n`` and its views, one per parameter."""
        flat = torch.zeros(n, **f32)
        return flat, self._views(flat)

    def _opt(self) -> list:
        return [t for t in (self.e_g, self.e_x, self.trace) if t is not None]

    def retained(self) -> int:
        """Bytes the state keeps on its device: the buffers and the graphs'
        memory pool."""
        ts = ([self.flat, self.gflat] + self._opt()
              + [self.X, self.y, self.w, self.perm, self.slot])
        return sum(t.numel() * t.element_size() for t in ts) + self.pool_bytes

    def _mutable(self) -> list:
        return [self.flat, *self._opt(), self.count, self.step,
                self.loss_sum]

    def _views(self, flat: torch.Tensor) -> list:
        return [flat[a - math.prod(s): a].view(s) for s, a in zip(
            self.shapes, itertools.accumulate(math.prod(s)
                                              for s in self.shapes))]

    def load(self, net: MLP, opt: dict | None, X, y, w, l1: float,
             l2: float, seed: int) -> None:
        """A training's inputs into the buffers: the network's weights,
        the optimizer state (``opt``: :func:`opt_state_from_numpy`'s form,
        or :meth:`opt_state`'s flat buffers; None: zeros), the design,
        response and weights."""
        for t, s in zip(self.params, net.tensors()):
            t.copy_(s)
        opt = opt or {}
        for name in ("e_g", "e_x", "trace"):
            buf = getattr(self, name)
            if buf is None:
                continue
            src = opt.get(name)
            if isinstance(src, torch.Tensor):
                buf.copy_(src)
                continue
            buf.zero_()
            for t, part in zip(self._views(buf), src or ()):
                t.copy_(part)
        if "count" in opt:
            self.count.copy_(opt["count"])
        else:
            self.count.zero_()
        self.X.copy_(X)
        self.y.copy_(y)
        self.w.copy_(w)
        self.l1.fill_(float(l1))
        self.l2.fill_(float(l2))
        self.seed.fill_(sampling.seed_key(seed))

    def _keep(self, key, layer: int, n_rows: int, width: int):
        """The keep mask of one layer's dropout: (n_rows, width) bool,
        Bernoulli(1 - rate), keyed by (key, layer) over row·width + j."""
        rate = self.plan.dropout[layer]
        u = sampling.uniform(sampling.fold(key, layer), self.idx[layer])
        return (u < float(np.float32(1.0 - rate))).view(n_rows, width)

    def _step(self) -> None:
        """One minibatch step on the buffers, in place: the rows of slot
        ``step·batch ..`` of the permutation, forward, loss, backward, the
        optimizer; adds the step's loss to ``loss_sum`` and advances
        ``step``."""
        pl = self.plan
        B = pl.batch
        slots = self.step * B + self.ar
        rows = self.perm.index_select(0, slots)
        xb = self.X.index_select(0, rows)
        wb = self.w.index_select(0, rows) * self.slot.index_select(0, slots)
        drops = any(r > 0 for r in pl.dropout)
        key = (sampling.fold(self.seed, DROPOUT, self.epoch_t, self.step)
               if drops else None)
        Ws, bs = self.params[0::2], self.params[1::2]
        n_hidden = len(Ws) - 1

        # forward: the input of each layer, each hidden pre-activation and
        # activation, and each dropout mask
        a = xb
        keeps = [None] * (n_hidden + 1)
        if pl.dropout[0] > 0:
            keeps[0] = self._keep(key, 0, B, xb.shape[1])
            a = torch.where(keeps[0], a / float(np.float32(1 - pl.dropout[0])),
                            0.0)
        ins, hs = [a], []
        for i in range(n_hidden):
            h = _act(torch.addmm(bs[i], a, Ws[i].t()), pl.act)
            hs.append(h)
            a = h
            if pl.dropout[i + 1] > 0:
                keeps[i + 1] = self._keep(key, i + 1, B, h.shape[1])
                a = torch.where(keeps[i + 1],
                                h / float(np.float32(1 - pl.dropout[i + 1])),
                                0.0)
            ins.append(a)
        out = torch.addmm(bs[-1], a, Ws[-1].t())

        # the row loss and d(loss)/d(out), with the weights' normalizer
        den = torch.clamp(wb.sum(), min=1e-9)
        scale = wb / den
        if pl.kind == "ce":
            K = out.shape[1]
            yb = self.y.index_select(0, rows).long()
            yb = torch.where(yb < 0, yb + K, yb)[:, None]  # NA labels wrap
            lse = torch.logsumexp(out, dim=1, keepdim=True)
            rl = (lse - out.gather(1, yb))[:, 0]
            dout = torch.exp(out - lse).scatter_add_(
                1, yb, torch.full_like(lse, -1.0))
            dout.mul_(scale[:, None])
        elif pl.kind == "mse":
            r = out[:, 0] - self.y.index_select(0, rows)
            rl = r * r
            dout = (2.0 * r * scale)[:, None]
        else:  # recon: the input is the target
            r = out - xb
            rl = (r * r).mean(dim=1)
            dout = r * (2.0 / out.shape[1]) * scale[:, None]
        loss = (wb * rl).sum() / den

        # backward, each gradient written into its view of the flat one
        d = dout
        for i in range(n_hidden, -1, -1):
            torch.mm(d.t(), ins[i], out=self.grads[2 * i])
            torch.sum(d, 0, out=self.grads[2 * i + 1])
            if i == 0:
                break
            da = d @ Ws[i]
            if keeps[i] is not None:
                da = torch.where(keeps[i],
                                 da / float(np.float32(1 - pl.dropout[i])),
                                 0.0)
            h = hs[i - 1]
            d = (da * (h > 0) if pl.act == "relu"
                 else da * (1.0 - h * h))

        # the penalties over every parameter, biases included; d|q|/dq as
        # JAX differentiates abs: +1 where q >= 0 (zero and -0 included)
        q, g = self.flat, self.gflat
        loss = (loss + self.l2 * 0.5 * torch.dot(q, q)
                + self.l1 * q.abs().sum())
        g.add_(q * self.l2)
        g.add_(torch.where(q >= 0, self.l1, -self.l1))
        self._update()
        self.loss_sum.add_(loss)
        self.step.add_(1)

    def _update(self) -> None:
        """The optimizer on the flat parameters from the flat gradient, in
        place, in optax 0.2.6's operation order."""
        pl = self.plan
        g = self.gflat
        if pl.adaptive:
            # e_g = (1-rho) g^2 + rho e_g
            self.e_g.mul_(pl.rho).add_((g * g).mul_(1 - pl.rho))
            # dx = sqrt(e_x + eps) / sqrt(e_g + eps) * g
            dx = (self.e_x + pl.eps).sqrt_().div_(
                (self.e_g + pl.eps).sqrt_()).mul_(g)
            # e_x = (1-rho) dx^2 + rho e_x; p -= dx
            self.e_x.mul_(pl.rho).add_((dx * dx).mul_(1 - pl.rho))
            self.flat.sub_(dx)
            return
        # momentum SGD: trace = g + momentum trace; the step size of
        # optax.exponential_decay(rate, 1000, rate_decay) at the count
        if self.trace is not None:
            g = self.trace.mul_(pl.momentum).add_(g)
        c = self.count.to(torch.float32)
        decayed = pl.rate * torch.pow(self.rate_decay, c / 1000.0)
        lr = torch.where(self.count <= 0, float(np.float32(pl.rate)), decayed)
        self.flat.sub_(g * lr)
        self.count.add_(1)

    def _steps(self, n: int) -> None:
        for _ in range(n):
            self._step()

    def _mode(self) -> str:
        if STEP_MODE != "auto":
            return STEP_MODE
        return "graph" if self.device.type == "cuda" else "eager"

    def _capture(self) -> None:
        """Warm the step blocks up on a side stream (then restore the
        state they moved), and capture them into one memory pool."""
        from h2o3_tpu_torch.ops.cuda_graph import LaunchGraph, warm_up

        pl = self.plan
        S, tail = min(STEPS_PER_GRAPH, pl.nbatch), pl.nbatch % STEPS_PER_GRAPH
        if pl.nbatch < STEPS_PER_GRAPH:
            tail = 0
        saved = [t.clone() for t in self._mutable()]
        warm_up(lambda: self._steps(S), self.device)
        if tail:
            warm_up(lambda: self._steps(tail), self.device)
        for t, s in zip(self._mutable(), saved):
            t.copy_(s)
        before = torch.cuda.memory_reserved(self.device)
        pool = torch.cuda.graph_pool_handle()
        block = LaunchGraph(lambda: self._steps(S), pool)
        rest = LaunchGraph(lambda: self._steps(tail), pool) if tail else None
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - before
        self.graphs = (block, rest, pl.nbatch // S)
        SGD_EVENTS["captures"] += 1
        SGD_EVENTS["capture_seconds"] += block.capture_seconds + (
            rest.capture_seconds if rest else 0.0)

    def epoch(self, perm: np.ndarray, e: int) -> float:
        """One epoch over the permutation's first ``nslots`` slots; its
        loss (``loss_sum / nbatch``, float32), read once."""
        pl = self.plan
        self.perm.copy_(torch.from_numpy(perm))
        self.epoch_t.fill_(e)
        self.step.zero_()
        self.loss_sum.zero_()
        mode = self._mode()
        with full_fp32(), record_function("dl.epoch"):
            if mode == "graph":
                if self.graphs is None:
                    self._capture()
                block, rest, reps = self.graphs
                for _ in range(reps):
                    block.replay()
                if rest is not None:
                    rest.replay()
                self.replays += reps + (rest is not None)
            elif mode == "block":
                S = min(STEPS_PER_GRAPH, pl.nbatch)
                for _ in range(pl.nbatch // S):
                    self._steps(S)
                self._steps(pl.nbatch % S if pl.nbatch >= S else 0)
            else:
                self._steps(pl.nbatch)
            return float((self.loss_sum / pl.nbatch).item())

    def unload(self, net: MLP) -> None:
        for t, s in zip(net.tensors(), self.params):
            t.copy_(s)

    def opt_state(self) -> dict:
        """Copies of the optimizer state: the flat ADADELTA accumulators
        (``e_g``, ``e_x``) or momentum SGD's ``trace``, and the step
        ``count`` (what :meth:`load` takes back)."""
        out = {name: getattr(self, name).clone()
               for name in ("e_g", "e_x", "trace")
               if getattr(self, name) is not None}
        out["count"] = self.count.clone()
        return out


# captures of step graphs, and their seconds: a warm training, or the
# folds of a cross-validation, add none
SGD_EVENTS = {"captures": 0, "capture_seconds": 0.0}
_STATES: "dict[tuple, _SgdState]" = {}
# the cached states of a card keep at most this share of its memory
# (buffers and graph pools), as the tree plans' cache does
_CACHE_SHARE = 1 / 32


def free_graphs() -> None:
    """Drop every cached DeepLearning state and its graphs."""
    _STATES.clear()


def _state_for(plan: _Plan, dev: torch.device) -> _SgdState:
    """The plan's state on ``dev``: cached on the card (the most recently
    used kept while they fit in :data:`_CACHE_SHARE` of its memory; one
    larger alone stays until the next plan), new on the CPU."""
    if dev.type != "cuda":
        return _SgdState(plan, dev)
    key = (plan, str(dev))
    st = _STATES.pop(key, None) or _SgdState(plan, dev)
    _STATES[key] = st  # most recently used last
    budget = torch.cuda.get_device_properties(dev).total_memory * _CACHE_SHARE
    older = [k for k in _STATES if k[1] == str(dev) and k != key]
    while older and st.retained() + sum(
            _STATES[k].retained() for k in older) > budget:
        _STATES.pop(older.pop(0))
    return st


def _run_sync_sgd(builder, p: DeepLearningParams, net: MLP, kind: str, X, y,
                  w, nrow: int, opt: dict | None = None,
                  start_epochs: int = 0, on_epoch=None):
    """JAX's replicated epoch driver: returns (history, epochs done,
    accounting, optimizer state). ``net`` ends holding the trained
    weights. A resumed training starts from ``opt`` at epoch
    ``start_epochs``, the permutation stream advanced past the epochs
    done; ``on_epoch(state, epochs done, history)`` runs after each
    epoch (the interval checkpoint)."""
    npad = jax_npad(nrow)
    batch = min(int(p.mini_batch_size), npad)
    nbatch = max(1, nrow // batch)
    dropout = (float(p.input_dropout_ratio),) + tuple(
        float(d) for d in _resolved_dropout(p, len(p.hidden)))
    plan = _Plan(
        widths=(int(X.shape[1]), *net.hidden, int(net.dense()[-1].out_features)),
        act=net.act, dropout=dropout, kind=kind, nrow=nrow, batch=batch,
        nbatch=nbatch, adaptive=bool(p.adaptive_rate), rho=float(p.rho),
        eps=float(p.epsilon), rate=float(p.rate),
        rate_decay=float(p.rate_decay),
        momentum=float(p.momentum_start or 0.0))
    dev = X.device
    caps = SGD_EVENTS["captures"]
    st = _state_for(plan, dev)
    replays0 = st.replays
    seed = abs(p.seed) if p.seed and p.seed > 0 else 99
    with record_function("dl.load"):
        st.load(net, opt, X, y, w, p.l1, p.l2, seed)
    keeper = ScoreKeeper(p.stopping_rounds, p.stopping_tolerance, False)
    rng = np.random.default_rng(seed)
    for _ in range(start_epochs):  # the uninterrupted run's stream
        rng.permutation(nrow)
    n_epochs = max(1, int(np.ceil(p.epochs)))
    history = []
    perm = np.zeros(plan.nslots, np.int64)
    done = start_epochs
    for e in range(start_epochs, n_epochs):
        order = rng.permutation(nrow)
        k = min(nrow, plan.nslots)
        perm[:k] = order[:k]
        loss = st.epoch(perm, e)
        done = e + 1
        history.append({"epoch": done, "loss": loss})
        keeper.record(loss)
        if on_epoch is not None:
            on_epoch(st, done, history)
        if keeper.should_stop() or builder.stop_requested():
            break
    st.unload(net)
    ran = done - start_epochs
    stats = {"epochs": ran, "steps": ran * nbatch, "batch": batch,
             "nbatch": nbatch, "host_reads": ran,
             "mode": st._mode(),
             "captures": SGD_EVENTS["captures"] - caps,
             "replays": st.replays - replays0}
    return history, done, stats, st.opt_state()


# -- model and builder -------------------------------------------------------


class DeepLearningModel(Model):
    algo = "deeplearning"

    def _design(self, frame: Frame):
        di: DataInfo = self.output["datainfo"]
        pad = int(self.output.get("input_pad") or 0)
        return di.transform(frame, pad_to=di.ncols_expanded + pad)

    def _raw(self, X: torch.Tensor) -> torch.Tensor:
        """The scoring pass on a design: softmax probabilities for a
        classifier, ``out[:, 0]`` for a regression, reconstructions for an
        autoencoder."""
        out = self.output["net"](X)
        if self.output.get("autoencoder"):
            return out
        if self.is_classifier:
            return torch.softmax(out, dim=1)
        return out[:, 0]

    def _predict_raw(self, frame: Frame) -> torch.Tensor:
        with record_function("dl.predict"):
            return self._raw(self._design(frame)[0])

    def predict(self, frame: Frame) -> Frame:
        if not self.output.get("autoencoder"):
            return super().predict(frame)
        # one reconstr_* column per expanded (standardized) input feature
        recon = self._predict_raw(frame)
        names = [f"reconstr_{n}" for n in self.output["expanded_names"]]
        return Frame([Vec(recon[:, j].contiguous(), NUM)
                      for j in range(recon.shape[1])], names)

    def _recon_row_mse(self, frame: Frame, X=None, wmask=None):
        """Per-row reconstruction MSE in the standardized feature space (the
        one formula behind ``anomaly`` and the autoencoder metrics), and
        the rows' validity; pass ``(X, wmask)`` to reuse a transform."""
        if X is None:
            X, wmask = self._design(frame)
        recon = self.output["net"](X)
        return ((recon - X) ** 2).mean(dim=1), wmask > 0

    def _autoencoder_metrics(self, frame: Frame, X=None, wmask=None):
        row_mse, ok = self._recon_row_mse(frame, X, wmask)
        cnt = int(ok.sum())
        mse = (float(torch.where(ok, row_mse, 0.0).sum(dtype=torch.float64))
               / cnt if cnt else float("nan"))
        return MM.ModelMetrics("AutoEncoder",
                               {"mse": mse, "rmse": float(np.sqrt(mse))})

    def model_performance(self, test_data: Frame | None = None):
        if self.output.get("autoencoder"):
            return (self._autoencoder_metrics(test_data)
                    if test_data is not None else self.training_metrics)
        return super().model_performance(test_data)

    def model_summary(self) -> list[dict]:
        """The layer table (JAX's ``model_summary``)."""
        p = self.params
        di: DataInfo = self.output["datainfo"]
        hidden = list(self.output.get("hidden") or p.hidden)
        n_out = (di.ncols_expanded if self.output.get("autoencoder")
                 else (self.nclasses if self.is_classifier else 1))
        dropout = list(_resolved_dropout(p, len(hidden)))
        rows = [{"layer": 1, "units": di.ncols_expanded, "type": "Input",
                 "dropout": p.input_dropout_ratio}]
        for i, h in enumerate(hidden):
            rows.append({"layer": i + 2, "units": int(h),
                         "type": p.activation, "dropout": dropout[i],
                         "l1": p.l1, "l2": p.l2})
        rows.append({"layer": len(hidden) + 2, "units": int(n_out),
                     "type": ("Linear" if (self.output.get("autoencoder")
                              or not self.is_classifier) else "Softmax")})
        return rows

    def anomaly(self, frame: Frame) -> Frame:
        """Per-row reconstruction MSE (``h2o.anomaly``), on the frame's
        device."""
        if not self.output.get("autoencoder"):
            raise ValueError("anomaly() requires an autoencoder model")
        mse, _ = self._recon_row_mse(frame)
        return Frame([Vec(mse, NUM)], ["Reconstruction.MSE"])


class DeepLearning(ModelBuilder):
    """``h2o.deeplearning`` builder."""

    algo = "deeplearning"
    PARAMS_CLS = DeepLearningParams

    def _refuse(self, train: Frame, d_pad: int) -> None:
        p = self.params
        window = int(config.get("H2O3_TPU_HBM_WINDOW_BYTES") or 0)
        if (window > 0 and not p.autoencoder
                and train.nrow * ((d_pad + 2) * 4 + 8) > window):
            raise NotImplementedError(
                "the streamed DeepLearning lane (a design larger than "
                "H2O3_TPU_HBM_WINDOW_BYTES) is not ported yet (ROADMAP "
                "Queue A 6)")
        if config.get("H2O3_TPU_DL_GRAD_SHARD").strip().lower() in ("1",
                                                                   "ctl"):
            raise NotImplementedError(
                "the sharded-gradient and ctl DeepLearning lanes need more "
                "than one device and are not ported yet (ROADMAP Queue A 8)")

    def _validate(self, train: Frame, valid: Frame | None) -> None:
        if self.params.autoencoder:
            if self.params.nfolds and self.params.nfolds > 1:
                raise ValueError(
                    "autoencoder does not support cross-validation")
            return  # unsupervised: no response checks
        super()._validate(train, valid)

    def _initial_net(self, d_in: int, d_pad: int, n_out: int, device) -> MLP:
        """The network a training starts from (:func:`init_mlp`)."""
        return init_mlp(self.params, d_in, d_pad, n_out, device)

    def _resume(self, train: Frame, D: int, d_pad: int, n_out: int):
        """The checkpoint's network (repadded to ``d_pad`` inputs), its
        optimizer state when the shapes match, and its epochs — or
        ``(None, None, 0)`` — checked as JAX checks them."""
        p = self.params
        prior = resolve_checkpoint(p.checkpoint, train.device)
        if prior is None:
            return None, None, 0
        frozen = ("hidden", "activation", "standardize", "adaptive_rate")
        check_checkpoint_compat(
            prior, self, frozen + (("autoencoder",) if p.autoencoder else ()))
        if prior.output["datainfo"].ncols_expanded != D:
            raise ValueError("checkpoint design-matrix width differs")
        start = int(prior.output.get("epochs_trained", 0))
        if p.epochs <= start:
            raise ValueError(
                f"checkpoint continuation needs epochs > {start}")
        src = prior.output["net"]
        net = MLP(d_pad, src.hidden, n_out, p.activation).to(train.device)
        for t, s in zip(net.tensors(), src.tensors()):
            if t.dim() == 2 and t.shape != s.shape:  # another input bucket
                t[:, :D] = s[:, :D].to(t.device)
            else:
                t.copy_(s.to(t.device))
        opt = prior.output.get("opt_state")
        n = sum(t.numel() for t in net.tensors())
        if opt is not None and any(
                isinstance(v, torch.Tensor) and v.dim() == 1
                and v.numel() != n for v in opt.values()):
            _LOG.warning("DeepLearning checkpoint optimizer state has a "
                         "different shape bucket; accumulators "
                         "re-initialized")
            opt = None
        if opt is not None:
            opt = {k: v.to(train.device) for k, v in opt.items()}
        return net, opt, start

    def _epoch_snapshot(self, key, st, done, history, out) -> Model:
        """An interval snapshot (JAX's ``_epoch_snapshot``): the weights
        and optimizer state after ``done`` epochs, everything a resume
        reads."""
        net = MLP(st.plan.widths[0], st.plan.widths[1:-1],
                  st.plan.widths[-1], self.params.activation
                  ).to(st.device)
        st.unload(net)
        m = DeepLearningModel(key, self.params, {
            **out, "net": net, "epochs_trained": done,
            "opt_state": st.opt_state()})
        m.scoring_history = list(history)
        return m

    def _weights(self, train: Frame, wmask):
        w = wmask
        if self.params.weights_column:
            w = w * torch.nan_to_num(train.vec(self.params.weights_column).data)
        return w

    def _build(self, train: Frame, valid: Frame | None) -> Model:
        p: DeepLearningParams = self.params
        with record_function("dl.datainfo"):
            di = DataInfo.fit(train, self._x, standardize=p.standardize,
                              hash_buckets=p.hash_buckets)
        D = di.ncols_expanded
        d_pad = D if p.autoencoder else _dl_pad_cols(D)
        self._refuse(train, d_pad)
        with record_function("dl.transform"):
            X, wmask = di.transform(train, pad_to=d_pad)
        dev = X.device
        if p.autoencoder:
            # not shape-bucketed: the reconstruction target is the input
            kind, n_out, domain = "recon", D, None
            y = torch.zeros(train.nrow, dtype=torch.float32, device=dev)
            w = self._weights(train, wmask)
        else:
            yv = train.vec(p.response_column)
            classification = yv.is_categorical()
            domain = tuple(yv.domain) if classification else None
            n_out = max(yv.cardinality, 1) if classification else 1
            kind = "ce" if classification else "mse"
            yd = yv.data.to(torch.float32)
            ok = (yd >= 0) if classification else ~torch.isnan(yd)
            y = torch.nan_to_num(yd, nan=0.0)
            w = self._weights(train, wmask) * ok.to(torch.float32)
        net, opt, start = self._resume(train, D, d_pad, n_out)
        if net is None:
            net = self._initial_net(D, d_pad, n_out, dev)
        out = {"datainfo": di, "names": list(self._x),
               "hidden": list(p.hidden), "response_domain": domain}
        if p.autoencoder:
            out.update(autoencoder=True, expanded_names=di.coef_names())
        else:
            out["input_pad"] = d_pad - D

        def on_epoch(st, done, history):
            self._export_interval_checkpoint(
                lambda key: self._epoch_snapshot(key, st, done, history, out))

        with record_function("dl.train"):
            history, done, stats, opt = _run_sync_sgd(
                self, p, net, kind, X, y, w, train.nrow, opt, start,
                on_epoch if p.export_checkpoints_dir else None)
        model = DeepLearningModel(None, p, {
            **out, "net": net, "epochs_trained": done, "opt_state": opt,
            "sgd_stats": stats})
        model.scoring_history = history
        with record_function("dl.metrics"):
            if p.autoencoder:
                model.training_metrics = model._autoencoder_metrics(
                    train, X, wmask)
                if valid is not None:
                    model.validation_metrics = model._autoencoder_metrics(
                        valid)
            else:
                yt, wt = model._response_and_weights(train)
                model.training_metrics = _make_metrics(model, model._raw(X),
                                                       yt, wt)
                if valid is not None:
                    model.validation_metrics = model._score_metrics(valid)
        return model


def dl_from_numpy(out: dict, params: dict | None = None,
                  device=None) -> DeepLearningModel:
    """A port ``DeepLearningModel`` from a DeepLearning model's outputs as
    plain numpy / Python values (a JAX model carried across without
    importing JAX): ``params`` (the flax tree, :func:`mlp_from_numpy`),
    ``activation``, ``datainfo`` (:meth:`DataInfo.from_meta`'s dict),
    ``response_domain``, ``names``, ``input_pad`` (the first kernel's
    bucket rows), ``autoencoder`` and ``expanded_names``. ``params`` sets
    DeepLearningParams fields. The model scores on ``device`` (``cuda``
    unless given)."""
    dev = resolve(device)
    prm = DeepLearningParams(**(params or {}))
    prm.activation = out.get("activation", prm.activation)
    net = mlp_from_numpy(out["params"], prm.activation, dev)
    prm.hidden = net.hidden
    di = DataInfo.from_meta(out["datainfo"])
    o = {"datainfo": di, "net": net, "names": list(out.get("names") or []),
         "hidden": list(net.hidden),
         "response_domain": (tuple(out["response_domain"])
                             if out.get("response_domain") else None)}
    if out.get("autoencoder"):
        o.update(autoencoder=True, expanded_names=list(
            out.get("expanded_names") or di.coef_names()))
    else:
        o["input_pad"] = int(out.get("input_pad") or 0)
    return DeepLearningModel(None, prm, o)
