"""Binary model save/load and the persistence SPI — the port of
``h2o3_tpu/persist.py`` (H2O's ``water.persist.Persist`` URI-scheme byte
store and the ``/99/Models.bin`` save/load endpoints).

A model is pickled whole, with three twists:

- every tensor of the model goes to host numpy in ONE batched pull per
  device (the main model's, its fold models', the kept holdout
  predictions, a stacked ensemble's base models and metalearner, a
  DeepLearning network and its optimizer state): the card's tensors are
  packed into one byte buffer and copied once. Tree records are host
  numpy already; each tree's per-device replay cache is dropped;
- process-local state is stripped and rebuilt on load: the GLM family
  object (rebuilt from the model's parameters) and the DeepLearning
  network (kept as its weights and shape, rebuilt as an ``MLP``); the
  builders' CUDA-graph plans, SGD states and ADMM solvers are never
  referenced by a model;
- live frames and models in the parameters collapse to their keys, so a
  snapshot never embeds the training data.

:func:`load_model` puts every tensor on ``device`` (``cuda`` unless the
caller asks for the CPU) and registers the model under its key
(``model_base.get_model``). The port writes its own magic: a port file
holds port classes, and a JAX package file (``H2O3TPU1``) would import
that package to unpickle, so it raises a named ``ValueError``.

Scheme dispatch mirrors the Persist SPI: ``file:`` and bare paths are
implemented; ``s3:``, ``gs:`` and ``hdfs:`` construct their backend on
first use and raise a clean ``ValueError`` when the SDK is missing;
:func:`register_backend` adds any other. Writes are atomic (a same-
directory temp file ``os.replace``d into place on a clean close; object
stores publish on close) and transient IO errors are retried
``H2O3_TPU_PERSIST_RETRIES`` times with exponential backoff and
deterministic jitter, while deterministic errors (collision, bad path,
corrupt file) fail at once.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import importlib
import io
import logging
import os
import pickle
import tempfile
import time
import urllib.parse
import zlib
from typing import BinaryIO, Callable

import numpy as np
import torch
from torch import nn

from h2o3_tpu_torch import config
from h2o3_tpu_torch.device import resolve
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import model_base
from h2o3_tpu_torch.models.model_base import Model

_LOG = logging.getLogger(__name__)

FORMAT_MAGIC = b"H2O3TTH1"
# the JAX package's magic: its files hold its own classes
JAX_FORMAT_MAGIC = b"H2O3TPU1"


# ---------------------------------------------------------------------------
# Persist SPI


class PersistBackend:
    def open_read(self, path: str) -> BinaryIO:
        raise NotImplementedError

    def open_write(self, path: str) -> BinaryIO:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        """Scheme-correct existence probe (collision checks, ``force=False``)."""
        raise NotImplementedError

    def is_dir(self, path: str) -> bool:
        """True when the path is a directory-like container. Object stores
        have no real directories: they return False and rely on the
        trailing-``/`` convention."""
        return False

    def probe(self, path: str) -> tuple | None:
        """Cheap change-detection etag (FS: mtime_ns + size); None when
        the backend cannot probe without reading bytes."""
        return None

    def list_dir(self, path: str) -> list[str]:
        """File names directly inside a directory-like path."""
        raise NotImplementedError(f"{type(self).__name__} cannot list {path}")


class _AtomicFile(io.FileIO):
    """FS write handle that publishes atomically on clean close: bytes land
    in a same-directory temp file, ``os.replace``d onto the target only
    after a clean close; an exception in the ``with`` block deletes the
    temp and leaves no file at the target. ``close`` is idempotent."""

    def __init__(self, fd: int, tmp_path: str, final_path: str):
        super().__init__(fd, "wb")
        self._tmp = tmp_path
        self._final = final_path
        self._aborted = False
        self._published = False

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self._aborted = True
        self.close()

    def close(self) -> None:
        if self.closed:
            return
        if not self._aborted:
            try:
                self.flush()
                os.fsync(self.fileno())
            except OSError:  # fsync is best-effort (some FS reject it)
                pass
        super().close()
        if self._aborted or self._published:
            try:
                os.unlink(self._tmp)
            except OSError:
                pass
            return
        self._published = True
        os.replace(self._tmp, self._final)


class PersistFS(PersistBackend):
    def open_read(self, path: str) -> BinaryIO:
        return open(path, "rb")

    def open_write(self, path: str) -> BinaryIO:
        d = os.path.dirname(path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            dir=d, prefix="." + os.path.basename(path) + ".", suffix=".tmp")
        return _AtomicFile(fd, tmp, path)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def is_dir(self, path: str) -> bool:
        return os.path.isdir(path)

    def probe(self, path: str) -> tuple | None:
        try:
            st = os.stat(path)
        except OSError:
            return None
        return (st.st_mtime_ns, st.st_size)

    def list_dir(self, path: str) -> list[str]:
        with os.scandir(path) as it:
            return sorted(e.name for e in it if e.is_file())


class _UploadOnClose(io.BytesIO):
    """Write buffer that publishes on clean close; a ``with`` block that
    raises publishes nothing."""

    def __init__(self, publish):
        super().__init__()
        self._publish = publish
        self._done = False
        self._aborted = False

    def close(self) -> None:
        if not self._done and not self.closed:
            self._done = True
            if not self._aborted:
                self._publish(self.getvalue())
        super().close()

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self._aborted = True
        self.close()


class PersistS3(PersistBackend):
    """``s3://bucket/key`` through boto3 (imported on first use)."""

    def __init__(self):
        import boto3  # ImportError when the SDK is not installed

        self._s3 = boto3.client("s3")

    def _split(self, uri: str) -> tuple[str, str]:
        p = urllib.parse.urlparse(uri)
        return p.netloc, p.path.lstrip("/")

    def open_read(self, path: str) -> BinaryIO:
        bucket, key = self._split(path)
        body = self._s3.get_object(Bucket=bucket, Key=key)["Body"].read()
        return io.BytesIO(body)

    def open_write(self, path: str) -> BinaryIO:
        bucket, key = self._split(path)
        return _UploadOnClose(
            lambda data: self._s3.put_object(Bucket=bucket, Key=key, Body=data))

    def exists(self, path: str) -> bool:
        bucket, key = self._split(path)
        try:
            self._s3.head_object(Bucket=bucket, Key=key)
            return True
        except Exception:  # the SDK's typed 404
            return False

    def probe(self, path: str) -> tuple | None:
        bucket, key = self._split(path)
        try:
            head = self._s3.head_object(Bucket=bucket, Key=key)
        except Exception:
            return None
        return (head.get("ETag", "").strip('"'),
                int(head.get("ContentLength", 0)))

    def list_dir(self, path: str) -> list[str]:
        bucket, key = self._split(path)
        prefix = key.rstrip("/") + "/" if key else ""
        names: list[str] = []
        token = None
        while True:
            kw = {"Bucket": bucket, "Prefix": prefix, "Delimiter": "/"}
            if token:
                kw["ContinuationToken"] = token
            resp = self._s3.list_objects_v2(**kw)
            for obj in resp.get("Contents", ()):
                name = obj["Key"][len(prefix):]
                if name:
                    names.append(name)
            if not resp.get("IsTruncated"):
                break
            token = resp.get("NextContinuationToken")
        return sorted(names)


class PersistGS(PersistBackend):
    """``gs://bucket/key`` through google-cloud-storage (imported on first
    use)."""

    def __init__(self):
        from google.cloud import storage

        self._client = storage.Client()

    def _blob(self, uri: str):
        p = urllib.parse.urlparse(uri)
        return self._client.bucket(p.netloc).blob(p.path.lstrip("/"))

    def open_read(self, path: str) -> BinaryIO:
        return io.BytesIO(self._blob(path).download_as_bytes())

    def open_write(self, path: str) -> BinaryIO:
        blob = self._blob(path)
        return _UploadOnClose(lambda data: blob.upload_from_string(data))

    def exists(self, path: str) -> bool:
        return bool(self._blob(path).exists())

    def probe(self, path: str) -> tuple | None:
        blob = self._blob(path)
        try:
            blob.reload()
        except Exception:
            return None
        return (blob.etag or "", int(blob.generation or 0),
                int(blob.size or 0))

    def list_dir(self, path: str) -> list[str]:
        p = urllib.parse.urlparse(path)
        prefix = p.path.lstrip("/")
        prefix = prefix.rstrip("/") + "/" if prefix else ""
        it = self._client.list_blobs(p.netloc, prefix=prefix, delimiter="/")
        return sorted(n for n in (b.name[len(prefix):] for b in it) if n)


class PersistHDFS(PersistBackend):
    """``hdfs://namenode/path`` through pyarrow's HadoopFileSystem."""

    def __init__(self):
        from pyarrow import fs

        self._fs_mod = fs
        self._conns: dict[tuple[str, int], object] = {}

    def _fs_path(self, uri: str):
        p = urllib.parse.urlparse(uri)
        host = p.hostname or "default"
        port = p.port or 8020
        conn = self._conns.get((host, port))
        if conn is None:
            conn = self._fs_mod.HadoopFileSystem(host, port)
            self._conns[(host, port)] = conn
        return conn, p.path

    def open_read(self, path: str) -> BinaryIO:
        f, pth = self._fs_path(path)
        return f.open_input_stream(pth)

    def open_write(self, path: str) -> BinaryIO:
        f, pth = self._fs_path(path)
        return f.open_output_stream(pth)

    def _info(self, path: str):
        f, pth = self._fs_path(path)
        return f.get_file_info(pth)

    def exists(self, path: str) -> bool:
        return self._info(path).type != self._fs_mod.FileType.NotFound

    def is_dir(self, path: str) -> bool:
        return self._info(path).type == self._fs_mod.FileType.Directory


_BACKENDS: dict[str, PersistBackend] = {"file": PersistFS(), "": PersistFS()}

# cloud schemes construct on first touch: the SDK import happens then, and
# a missing SDK is a registration error, not an import-time one
_LAZY_BACKENDS: dict[str, type] = {
    "s3": PersistS3,
    "gs": PersistGS,
    "hdfs": PersistHDFS,
}


def register_backend(scheme: str, backend: PersistBackend) -> None:
    _BACKENDS[scheme] = backend


def _backend_for(uri: str) -> tuple[PersistBackend, str]:
    parsed = urllib.parse.urlparse(uri)
    scheme = parsed.scheme if len(parsed.scheme) > 1 else ""  # windows-drive safe
    b = _BACKENDS.get(scheme)
    if b is None and scheme in _LAZY_BACKENDS:
        try:
            b = _LAZY_BACKENDS[scheme]()
        except ImportError as e:
            raise ValueError(
                f"persist scheme {scheme!r} needs its SDK ({e.name}) which is "
                "not installed in this image; register a backend with "
                "h2o3_tpu_torch.persist.register_backend"
            ) from e
        _BACKENDS[scheme] = b
    if b is None:
        raise ValueError(
            f"no persist backend for scheme {scheme!r} "
            f"(registered: {sorted(k for k in _BACKENDS if k)}); "
            "register one with h2o3_tpu_torch.persist.register_backend"
        )
    path = uri[len(scheme) + 1:].lstrip("/") if scheme == "file" else uri
    if scheme == "file":
        path = "/" + path if not path.startswith("/") else path
    return b, path


# ---------------------------------------------------------------------------
# retries with backoff for transient IO


def _is_transient(e: BaseException) -> bool:
    """Transient (retry) against deterministic (fail at once): the path-
    shape ``OSError`` subclasses are deterministic, every other
    ``OSError`` (EIO, connection resets) is worth retrying."""
    if isinstance(e, (FileNotFoundError, FileExistsError, PermissionError,
                      IsADirectoryError, NotADirectoryError)):
        return False
    return isinstance(e, OSError)


def _retry_delays(desc: str) -> list[float]:
    """The backoff schedule of one operation: exponential, with jitter
    keyed on (operation, attempt), so every run computes the same."""
    retries = max(0, config.get_int("H2O3_TPU_PERSIST_RETRIES"))
    base = max(0.0, config.get_float("H2O3_TPU_PERSIST_BACKOFF"))
    out = []
    for attempt in range(retries):
        jitter = (zlib.crc32(f"{desc}:{attempt}".encode()) % 1000) / 2000.0
        out.append(base * (2 ** attempt) * (1.0 + jitter))
    return out


def _with_retries(op: Callable, desc: str):
    """Run ``op``, retrying transient IO errors with backoff; the last
    attempt's error, or any deterministic one, surfaces unchanged. Each
    retry logs a warning."""
    delays = _retry_delays(desc)
    for attempt in range(len(delays) + 1):
        try:
            return op()
        except Exception as e:
            if attempt >= len(delays) or not _is_transient(e):
                raise
            _LOG.warning("persist: transient failure on %s (attempt %d/%d): "
                         "%r, retrying in %.2fs", desc, attempt + 1,
                         len(delays) + 1, e, delays[attempt])
            time.sleep(delays[attempt])


def write_bytes(data: bytes, path: str) -> str:
    """Atomic, retried byte write through the scheme dispatch (models,
    grid and AutoML manifests)."""
    backend, p = _backend_for(path)

    def attempt():
        with backend.open_write(p) as f:
            f.write(data)

    _with_retries(attempt, f"write {p}")
    return p


def read_bytes(path: str) -> bytes:
    """Retried whole-file read through the scheme dispatch."""
    backend, p = _backend_for(path)

    def attempt():
        with backend.open_read(p) as f:
            return f.read()

    return _with_retries(attempt, f"read {p}")


def probe(path: str) -> tuple | None:
    """Change-detection etag through the scheme dispatch (None: the
    backend cannot probe cheaply, or the path does not exist)."""
    backend, p = _backend_for(path)
    return backend.probe(p)


def list_dir(path: str) -> list[str]:
    """File names inside a directory URI through the scheme dispatch."""
    backend, p = _backend_for(path)
    return backend.list_dir(p)


# ---------------------------------------------------------------------------
# the model's tensors to the host in one batched pull per device, and back


@dataclasses.dataclass
class _Slot:
    """A tensor's place in the pickled state, filled by the pull: the
    array, and whether it goes back to a device on load (tree records
    stay host numpy)."""

    index: int
    to_device: bool
    array: np.ndarray | None = None


@dataclasses.dataclass
class _NetOnHost:
    """A DeepLearning network as its shape and weights ([W0, b0, ...],
    each weight (out, in)), rebuilt as an ``MLP`` on load."""

    d_in: int
    hidden: tuple
    n_out: int
    activation: str
    tensors: list


# per-device caches that are rebuilt on demand, never pickled
_DROP_ATTRS = {"_on_device": dict, "_hash_luts": dict}


class _Puller:
    """Walks a model's state, putting a :class:`_Slot` where each tensor
    was; :meth:`pull` then copies every tensor to the host, one transfer
    per device."""

    def __init__(self):
        self.tensors: list[torch.Tensor] = []
        self.slots: list[_Slot] = []

    def walk(self, obj, to_device: bool = True):
        if isinstance(obj, torch.Tensor):
            slot = _Slot(len(self.tensors), to_device)
            self.tensors.append(obj.detach())
            self.slots.append(slot)
            return slot
        if isinstance(obj, Model):
            return _portable_submodel(obj, self)
        if isinstance(obj, Frame):
            return obj.key
        if isinstance(obj, nn.Module):
            from h2o3_tpu_torch.models.deeplearning import MLP

            if not isinstance(obj, MLP):
                raise TypeError(f"cannot save a {type(obj).__name__} module")
            return _NetOnHost(int(obj.Dense_0.in_features), tuple(obj.hidden),
                              int(obj.dense()[-1].out_features),
                              obj.activation,
                              [self.walk(t) for t in obj.tensors()])
        if isinstance(obj, dict):
            return {k: self.walk(v, to_device) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)) and type(obj) in (list, tuple):
            return type(obj)(self.walk(v, to_device) for v in obj)
        if (hasattr(obj, "__dict__") and not isinstance(obj, type)
                and type(obj).__module__.startswith("h2o3_tpu_torch.")):
            from h2o3_tpu_torch.models.tree.shared_tree import Tree, TreeLevel

            host = to_device and not isinstance(obj, (Tree, TreeLevel))
            clone = copy.copy(obj)
            object.__setattr__(clone, "__dict__", {
                k: (_DROP_ATTRS[k]() if k in _DROP_ATTRS
                    else self.walk(v, host))
                for k, v in obj.__dict__.items()})
            return clone
        return obj

    def pull(self) -> None:
        """Fill every slot: the tensors of each accelerator device packed
        as bytes into one buffer, copied to the host once."""
        by_dev: dict[str, list[int]] = {}
        for i, t in enumerate(self.tensors):
            by_dev.setdefault(str(t.device), []).append(i)
        for dev, idx in by_dev.items():
            if dev == "cpu":
                for i in idx:
                    self.slots[i].array = self.tensors[i].numpy().copy()
                continue
            parts = [self.tensors[i].contiguous().reshape(-1).view(torch.uint8)
                     for i in idx]
            packed = torch.cat(parts).cpu().numpy()
            off = 0
            for i, part in zip(idx, parts):
                t = self.tensors[i]
                n = part.numel()
                dt = torch.empty(0, dtype=t.dtype).numpy().dtype
                self.slots[i].array = (packed[off: off + n].copy().view(dt)
                                       .reshape(tuple(t.shape)))
                off += n


def _restore(obj, dev: torch.device):
    """The inverse walk of :class:`_Puller` on an unpickled state: slots
    back to tensors on ``dev`` (host numpy where they came from a tree),
    networks rebuilt, nested models rebuilt."""
    if isinstance(obj, _Slot):
        if not obj.to_device:  # tree records: plain host numpy
            return obj.array
        return torch.from_numpy(obj.array).to(dev)
    if isinstance(obj, _NetOnHost):
        from h2o3_tpu_torch.models.deeplearning import MLP

        net = MLP(obj.d_in, obj.hidden, obj.n_out, obj.activation)
        for t, s in zip(net.tensors(), obj.tensors):
            t.copy_(torch.from_numpy(s.array))
        return net.to(dev)
    if isinstance(obj, dict):
        return {k: _restore(v, dev) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and type(obj) in (list, tuple):
        return type(obj)(_restore(v, dev) for v in obj)
    if (hasattr(obj, "__dict__") and not isinstance(obj, type)
            and type(obj).__module__.startswith("h2o3_tpu_torch.")):
        for k, v in list(obj.__dict__.items()):
            obj.__dict__[k] = _restore(v, dev)
        if isinstance(obj, Model):
            _rebuild(obj)
    return obj


# output entries of process-local objects, stripped on save and rebuilt
# on load from the model's parameters
_STRIP: dict[str, tuple[str, ...]] = {"glm": ("family_obj",)}


def _rebuild_glm(model: Model) -> None:
    from h2o3_tpu_torch.models.glm import _fam_args
    from h2o3_tpu_torch.models.glm_families import get_family

    fam = model.output["family"]
    if fam in ("multinomial", "ordinal"):
        # these carry a binomial family object for the metrics only
        model.output["family_obj"] = get_family("binomial")
        return
    model.output["family_obj"] = get_family(fam, *_fam_args(model.params))


_REBUILDERS: dict[str, Callable[[Model], None]] = {"glm": _rebuild_glm}


def _rebuild(model: Model) -> None:
    rebuild = _REBUILDERS.get(model.algo)
    if rebuild and "family" in model.output:
        rebuild(model)


def _portable_params(params):
    """A pickle-light copy of a params dataclass: live frames and models
    (``training_frame``, ``validation_frame``, ``checkpoint``, a stacked
    ensemble's ``base_models``) collapse to their keys, so a snapshot
    never embeds the training data. Resume passes frames explicitly, as
    H2O does."""
    if params is None or not dataclasses.is_dataclass(params):
        return params
    params = copy.copy(params)

    def key(v):
        if isinstance(v, (Frame, Model)):
            return v.key
        if isinstance(v, (list, tuple)) and any(
                isinstance(x, (Frame, Model)) for x in v):
            return type(v)(key(x) for x in v)
        return v

    for f in dataclasses.fields(params):
        setattr(params, f.name, key(getattr(params, f.name)))
    return params


def _model_state(model: Model, puller: _Puller, nested: bool) -> dict:
    state = dict(model.__dict__)
    out = dict(state.pop("output"))
    for k in _STRIP.get(model.algo, ()):
        out.pop(k, None)
    state["params"] = _portable_params(state.get("params"))
    if nested:
        state["cv_models"] = []  # folds of folds do not exist
    state = {k: puller.walk(v) for k, v in state.items()}
    state["output"] = puller.walk(out)
    return state


def _portable_submodel(m: Model, puller: _Puller) -> Model:
    """A pickle-clean clone of a nested model (a fold model, an ensemble's
    base model or metalearner), without touching the live object."""
    clone = copy.copy(m)
    clone.__dict__ = _model_state(m, puller, nested=True)
    return clone


def serialize_model(model: Model) -> bytes:
    """Model -> the port's file bytes (the device-to-host pulls happen
    here)."""
    puller = _Puller()
    state = _model_state(model, puller, nested=False)
    puller.pull()
    payload = {"cls_module": type(model).__module__,
               "cls_name": type(model).__qualname__,
               "algo": model.algo,
               "state": state}
    buf = io.BytesIO()
    buf.write(FORMAT_MAGIC)
    pickle.dump(payload, buf, protocol=pickle.HIGHEST_PROTOCOL)
    return buf.getvalue()


def model_path_in_dir(dir_uri: str, model_key: str
                      ) -> tuple[PersistBackend, str]:
    """(backend, path) of a model file named after its key inside a
    directory URI (the directory may not exist yet: the FS writer makes
    it)."""
    backend, p = _backend_for(dir_uri)
    if isinstance(backend, PersistFS):
        return backend, os.path.join(p, model_key)
    return backend, p.rstrip("/") + "/" + model_key


def resolve_model_path(path: str, model_key: str, force: bool = True):
    """(backend, final path) of a model save: a directory (an existing one,
    or a path ending in ``/``) gets a file named after the model key;
    ``force=False`` raises ``FileExistsError`` when the target exists."""
    backend, p = _backend_for(path)
    if path.endswith(("/", os.sep)) or backend.is_dir(p):
        if isinstance(backend, PersistFS):
            p = os.path.join(p, model_key)
        else:
            p = p.rstrip("/") + "/" + model_key
    if not force and backend.exists(p):
        raise FileExistsError(p)
    return backend, p


def write_model_bytes(data: bytes, backend, p: str, model_key: str) -> str:
    def attempt():
        with backend.open_write(p) as f:
            f.write(data)

    _with_retries(attempt, f"write model {model_key} -> {p}")
    _LOG.info("saved model %s to %s", model_key, p)
    return p


def save_model(model: Model, path: str, force: bool = True) -> str:
    """``h2o.save_model``: ``path`` is a directory (the file is named after
    the model key) or a file path. Returns the path written."""
    backend, p = resolve_model_path(path, model.key, force)
    return write_model_bytes(serialize_model(model), backend, p, model.key)


def load_model(path: str, device=None) -> Model:
    """``h2o.load_model``: the model on ``device`` (``cuda`` unless the
    caller asks for the CPU), registered under its key. Reads final saves
    and interval snapshots alike: a snapshot loads as a scoreable model
    whose key (or path) can be passed as ``checkpoint=``."""
    dev = resolve(device)
    backend, p = _backend_for(path)

    def attempt():
        with backend.open_read(p) as f:
            return f.read()

    blob = _with_retries(attempt, f"read model {p}")
    head = blob[: len(FORMAT_MAGIC)]
    if head == JAX_FORMAT_MAGIC:
        raise ValueError(
            f"{path}: an h2o3_tpu (JAX package) model file; h2o3_tpu_torch "
            "reads only its own model files (carry a JAX model across "
            "through its outputs: gbm_from_jax, glm_from_numpy, "
            "dl_from_numpy)")
    if head != FORMAT_MAGIC:
        raise ValueError(f"{path}: not an h2o3_tpu_torch model file")
    try:
        payload = pickle.loads(blob[len(FORMAT_MAGIC):])
        cls_module = payload["cls_module"]
        cls_name = payload["cls_name"]
        state = payload["state"]
    except Exception as e:
        # an atomic publish cannot leave a truncated file, but a foreign or
        # damaged one still gets a named error
        raise ValueError(
            f"{path}: corrupt or truncated model file "
            f"({type(e).__name__}: {e})") from e
    cls = functools.reduce(getattr, cls_name.split("."),
                           importlib.import_module(cls_module))
    model = cls.__new__(cls)
    model.__dict__.update(state)
    _restore(model, dev)
    model_base.register_model(model)
    _LOG.info("loaded model %s from %s", model.key, p)
    return model


# ---------------------------------------------------------------------------
# frame export


def export_file(frame, path: str, force: bool = False,
                format: str | None = None) -> str:
    """``h2o.export_file``: a frame to CSV or Parquet through the scheme
    dispatch (Parquet for a ``.parquet``/``.pq`` path or
    ``format="parquet"``)."""
    return export_df(frame.to_pandas(), path, force=force, format=format)


def export_df(df, path: str, force: bool = False,
              format: str | None = None) -> str:
    """Write a pandas frame through the scheme dispatch; ``force=False``
    raises ``FileExistsError`` when the target exists."""
    backend, p = _backend_for(path)
    try:
        if not force and backend.exists(p):
            raise FileExistsError(p)
    except NotImplementedError:  # a custom backend with no probe: overwrite
        pass
    fmt = (format or "").lower() or (
        "parquet" if p.endswith((".parquet", ".pq")) else "csv")

    def attempt():
        with backend.open_write(p) as f:
            if fmt == "parquet":
                df.to_parquet(f, index=False)
            elif fmt == "csv":
                df.to_csv(f, index=False)
            else:
                raise ValueError(f"unsupported export format {fmt!r}")

    _with_retries(attempt, f"export {p}")
    return p
