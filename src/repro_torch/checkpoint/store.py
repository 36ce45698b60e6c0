"""Checkpointing (counterpart of repro.checkpoint.store): versioned,
atomic, async-capable, in the JAX package's on-disk format.

Format (numpy and json only):
  <dir>/step_<n>/manifest.json   leaf shapes and dtypes, step, extra
  <dir>/step_<n>/arrays.npz      raw buffers keyed by flattened path

The format is the JAX package's, leaf for leaf, so a checkpoint written
by either package loads in the other:
  * a tree flattens to '/'-joined paths as jax.tree_util's
    tree_flatten_with_path names them: dict keys in sorted order,
    list and tuple positions by index (an MLP's nested params come out
    as params/w1, params/b1, ...), a dataclass's fields in declaration
    order as '.' + the field's name (JAX's register_dataclass: a
    (params, AdamState) tuple gives 1/.step, 1/.mu/<name>,
    1/.nu/<name>); the npz key spells '/' as '__SL__';
  * a dtype numpy's npz cannot hold (bfloat16, the float8 kinds) is
    written as its raw bits, a uint16 (or uint8) view, with the dtype's
    own name in the manifest; the port reads the bits back into a
    torch tensor of that dtype (`torch.from_numpy(u16).view(
    torch.bfloat16)`), where JAX decodes them through ml_dtypes;
  * a write goes to step_<n>.tmp-<pid>-<thread>, is fsynced and renamed,
    so a crashed writer never leaves a partial step behind.

Tensors are snapshotted to the host (one device-to-host copy a leaf; a
launch.mesh.Sharded leaf is gathered first) before anything is
written; `save_async` writes on a thread after that snapshot. `restore`
and `load_predictor_epoch` put the leaves on a device (None = the
card); `restore(..., shardings=)` places each leaf that has a
NamedSharding onto its mesh instead (launch.mesh.shard: a Sharded,
each block placed once a physical device), the elastic path of the
JAX store: the mesh may differ from the run that saved.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import Sharded, shard

PyTree = Any

_SEP = "/"

# dtypes numpy's npz cannot round-trip: stored as raw bits + manifest dtype
_EXOTIC = {"bfloat16", "float8_e4m3fn", "float8_e5m2", "float8_e4m3",
           "float8_e5m2fnuz", "float8_e4m3fnuz"}


class _Bits:
    """A host leaf of an exotic dtype: its raw bits (uint16 or uint8)
    and the dtype's name, as the manifest records it."""

    __slots__ = ("bits", "dtype")

    def __init__(self, bits: np.ndarray, dtype: str):
        self.bits, self.dtype = bits, dtype

    @property
    def shape(self):
        return self.bits.shape


def _dtype_name(x) -> str:
    """The manifest's name of a leaf's dtype: numpy's spelling for both
    packages ('float32', 'int8', 'bfloat16', ...)."""
    if isinstance(x, _Bits):
        return x.dtype
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def _host_leaf(x):
    """A leaf as host memory the npz can hold: numpy for the usual
    dtypes, _Bits for an exotic one (a bf16 tensor as its uint16 view;
    a numpy array of ml_dtypes' bfloat16 likewise)."""
    if isinstance(x, Sharded):
        x = x.gather("cpu")
    if isinstance(x, torch.Tensor):
        x = x.detach()
        name = _dtype_name(x)
        if name in _EXOTIC:
            view = torch.int8 if x.element_size() == 1 else torch.int16
            bits = x.cpu().contiguous().view(view).numpy()
            return _Bits(bits.view(np.uint8 if view == torch.int8
                                   else np.uint16), name)
        return x.cpu().numpy()
    arr = np.asarray(x)
    if str(arr.dtype) in _EXOTIC:
        return _Bits(arr.view(np.uint8 if arr.dtype.itemsize == 1
                              else np.uint16), str(arr.dtype))
    return arr


def _decode(arr: np.ndarray, dtype_name: str):
    """A stored buffer back as host data: numpy for the usual dtypes, a
    CPU tensor of the manifest's dtype for an exotic one."""
    if dtype_name not in _EXOTIC:
        return arr
    dtype = getattr(torch, dtype_name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"dtype {dtype_name} has no torch counterpart")
    signed = np.int8 if arr.dtype.itemsize == 1 else np.int16
    return torch.from_numpy(np.ascontiguousarray(arr).reshape(
        arr.shape).view(signed)).view(dtype)


def _is_record(node) -> bool:
    """A dataclass instance (AdamState, FactoredState): a tree node
    whose children are its fields. A dataclass that marks itself
    `tree_leaf` (a placed launch.mesh.Sharded, a NamedSharding, a
    configs.registry.ArgSpec) is a leaf."""
    return (dataclasses.is_dataclass(node) and not isinstance(node, type)
            and not getattr(node, "tree_leaf", False))


def _walk(node, prefix: tuple, out: dict) -> None:
    if _is_record(node):
        for f in dataclasses.fields(node):
            _walk(getattr(node, f.name), prefix + ("." + f.name,), out)
    elif isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], prefix + (str(k),), out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _walk(v, prefix + (str(i),), out)
    elif node is not None:
        out[_SEP.join(prefix)] = node


def flatten_with_paths(tree: PyTree) -> dict:
    """{path: leaf} in jax.tree_util's flatten order: dict keys sorted,
    list and tuple items by position, a dataclass's fields in order
    under '.' + name, None an empty subtree; a path joins its keys with
    '/'. The engine's swap checks compare two
    states' structure through it too. (The walks are module functions:
    a recursive closure would make a reference cycle that keeps the
    leaves, gigabytes of a table's gradient, alive until the collector
    runs.)"""
    out = {}
    _walk(tree, (), out)
    return out


def _build(node, prefix: tuple, leaves: dict):
    if _is_record(node):
        return dataclasses.replace(node, **{
            f.name: _build(getattr(node, f.name), prefix + ("." + f.name,),
                           leaves) for f in dataclasses.fields(node)})
    if isinstance(node, dict):
        return {k: _build(node[k], prefix + (str(k),), leaves) for k in node}
    if isinstance(node, (list, tuple)):
        return type(node)(_build(v, prefix + (str(i),), leaves)
                          for i, v in enumerate(node))
    if node is None:
        return None
    return leaves[_SEP.join(prefix)]


def unflatten_like(like: PyTree, leaves: dict) -> PyTree:
    """`like`'s structure with each leaf replaced by leaves[path]."""
    return _build(like, (), leaves)


def _map_tree(fn, tree: PyTree) -> PyTree:
    return unflatten_like(tree, {k: fn(v) for k, v in
                                  flatten_with_paths(tree).items()})


def _key_to_npz(key: str) -> str:
    # npz disallows '/' on some loaders; keep it simple and reversible
    return key.replace(_SEP, "__SL__")


def _npz_to_key(name: str) -> str:
    return name.replace("__SL__", _SEP)


def _like_dtype(ref):
    """The dtype a template leaf asks for, as a torch dtype."""
    dt = ref.dtype
    if isinstance(dt, torch.dtype):
        return dt
    name = str(np.dtype(dt))
    found = getattr(torch, name, None)
    if not isinstance(found, torch.dtype):
        raise ValueError(f"template dtype {name} has no torch counterpart")
    return found


def _to_device(buf, dev: torch.device, dtype=None) -> torch.Tensor:
    """A host buffer (numpy, or a decoded CPU tensor) on `dev`, cast to
    `dtype` when one is given."""
    # np.ascontiguousarray gives a 0-d array one dimension: reshape back
    t = buf if isinstance(buf, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(buf).reshape(buf.shape))
    return t.to(device=dev, dtype=dtype)


def _all_finite(buf) -> bool:
    if isinstance(buf, torch.Tensor):
        return bool(torch.isfinite(buf).all()) \
            if buf.is_floating_point() else True
    if np.issubdtype(buf.dtype, np.floating):
        return bool(np.all(np.isfinite(buf)))
    return True


class CheckpointStore:
    def __init__(self, directory: str, *, keep_last: int = 3):
        self.directory = directory
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- paths --------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_", 1)[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # -- save ----------------------------------------------------------------

    def save(self, step: int, tree: PyTree, *,
             extra: dict | None = None) -> str:
        """Synchronous checkpoint write with atomic rename."""
        return self._write(step, _map_tree(_host_leaf, tree), extra or {})

    def save_async(self, step: int, tree: PyTree, *,
                   extra: dict | None = None) -> None:
        """Device-to-host snapshot now; disk write on a background
        thread. Joins any in-flight write first (at most one
        outstanding)."""
        self.wait()
        host = _map_tree(_host_leaf, tree)
        self._thread = threading.Thread(
            target=self._write, args=(step, host, extra or {}), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_tree: PyTree, extra: dict) -> str:
        flat = flatten_with_paths(host_tree)
        final = self._step_dir(step)
        tmp = f"{final}.tmp-{os.getpid()}-{threading.get_ident()}"
        os.makedirs(tmp, exist_ok=True)
        manifest = {
            "step": step,
            "time": time.time(),
            "extra": extra,
            "leaves": {
                k: {"shape": list(v.shape), "dtype": _dtype_name(v)}
                for k, v in flat.items()
            },
        }
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{_key_to_npz(k): v.bits if isinstance(v, _Bits) else v
                    for k, v in flat.items()})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep_last)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        # orphaned tmp dirs from crashed writers
        for name in os.listdir(self.directory):
            if ".tmp-" in name:
                path = os.path.join(self.directory, name)
                if time.time() - os.path.getmtime(path) > 3600:
                    shutil.rmtree(path, ignore_errors=True)

    # -- per-epoch predictor state (a restarted replica's resume point) ----
    #
    # The refresh lane writes one checkpoint per published predictor
    # generation (save_predictor_epoch after every successful
    # engine.swap_predictor), keyed (tag, epoch) under
    # <dir>/predictors/<tag>/step_<epoch>/ in the same atomic format. A
    # restarted replica restores the newest LOADABLE epoch:
    # load_predictor_epoch validates each candidate (readable
    # manifest/npz, complete leaves, manifest-consistent shapes, finite
    # floats) and refuses a corrupt one in favour of the previous epoch.

    def _predictor_store(self, tag: str) -> "CheckpointStore":
        return CheckpointStore(
            os.path.join(self.directory, "predictors", tag),
            keep_last=self.keep_last)

    def predictor_epochs(self, tag: str) -> list[int]:
        """Epochs checkpointed for `tag`, ascending (after GC only the
        newest keep_last remain)."""
        d = os.path.join(self.directory, "predictors", tag)
        if not os.path.isdir(d):
            return []
        return self._predictor_store(tag).steps()

    def save_predictor_epoch(self, tag: str, epoch: int, state: PyTree,
                             *, extra: dict | None = None) -> str:
        """Checkpoint one predictor generation: `state` is the tag's
        state dict (core.predictors.predictor_state) as published at
        `epoch`. Synchronous: the refresh lane calls it after the swap
        has flipped, off the serving path."""
        host = _map_tree(_host_leaf, state)
        sub = self._predictor_store(tag)
        return sub._write(int(epoch), host,
                          {"tag": tag, "epoch": int(epoch), **(extra or {})})

    def load_predictor_epoch(self, tag: str, *, epoch: int | None = None,
                             like: PyTree | None = None, device=None
                             ) -> tuple[PyTree, int]:
        """Load the newest loadable epoch for `tag` (or exactly
        `epoch`) onto `device` (None = the card), returning (state,
        epoch). A corrupt checkpoint is refused (unreadable manifest or
        npz, leaves missing or extra against the manifest, shapes
        disagreeing with it, non-finite floats, or with `like` a
        structure or shape mismatch) and the previous epoch is tried.
        Raises FileNotFoundError only when no epoch loads at all."""
        dev = resolve_device(device)
        epochs = self.predictor_epochs(tag)
        candidates = ([int(epoch)] if epoch is not None
                      else list(reversed(epochs)))
        if not candidates:
            raise FileNotFoundError(
                f"no predictor checkpoints for tag {tag!r} in "
                f"{self.directory}")
        sub = self._predictor_store(tag)
        errors = []
        for e in candidates:
            try:
                return self._load_predictor_step(sub, e, like, dev), e
            except Exception as err:  # noqa: BLE001 - refuse + fall back
                errors.append(f"epoch {e}: {err}")
        raise FileNotFoundError(
            f"no loadable predictor checkpoint for tag {tag!r}: "
            + "; ".join(errors))

    @staticmethod
    def _load_predictor_step(sub: "CheckpointStore", step: int,
                             like: PyTree | None,
                             dev: torch.device) -> PyTree:
        d = sub._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaf_meta = manifest["leaves"]
        with np.load(os.path.join(d, "arrays.npz")) as data:
            buffers = {}
            for name in data.files:
                key = _npz_to_key(name)
                if key not in leaf_meta:
                    raise ValueError(f"leaf {key} absent from manifest")
                buf = _decode(data[name], leaf_meta[key]["dtype"])
                if list(buf.shape) != leaf_meta[key]["shape"]:
                    raise ValueError(
                        f"leaf {key}: array shape {list(buf.shape)} != "
                        f"manifest {leaf_meta[key]['shape']}")
                if not _all_finite(buf):
                    raise ValueError(f"leaf {key}: non-finite values")
                buffers[key] = buf
        missing = set(leaf_meta) - set(buffers)
        if missing:
            raise ValueError(f"missing leaves: {sorted(missing)[:5]}")
        if like is not None:
            flat_like = flatten_with_paths(like)
            absent = set(flat_like) - set(buffers)
            if absent:
                raise KeyError(f"missing leaves vs template: "
                               f"{sorted(absent)[:5]}")
            leaves = {}
            for key, ref in flat_like.items():
                buf = buffers[key]
                if tuple(buf.shape) != tuple(ref.shape):
                    raise ValueError(
                        f"leaf {key}: shape {tuple(buf.shape)} != template "
                        f"{tuple(ref.shape)}")
                leaves[key] = _to_device(buf, dev, _like_dtype(ref))
            return unflatten_like(like, leaves)
        # no template: rebuild the (possibly nested) state dict from the
        # '/'-joined keys
        out: dict = {}
        for key, buf in buffers.items():
            parts = key.split(_SEP)
            node = out
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = _to_device(buf, dev)
        return out

    # -- restore ------------------------------------------------------------

    def restore(self, like: PyTree, *, step: int | None = None,
                shardings: PyTree | None = None,
                device=None) -> tuple[PyTree, dict]:
        """Restore into the structure of `like` (tensors, numpy arrays,
        or anything with .shape and .dtype) in the template's dtypes.
        A leaf with a sharding in `shardings` (a matching tree of
        distributed.sharding.NamedSharding) comes back placed onto its
        mesh by launch.mesh.shard (its spec relaxed to the leaf's shape
        by drop_nondivisible); every other leaf lies on `device` (None =
        the card). Returns (tree, manifest extra)."""
        from repro_torch.distributed.sharding import drop_nondivisible

        flat_shard = ({} if shardings is None
                      else flatten_with_paths(shardings))
        dev = (resolve_device(device) if len(flat_shard) < len(
            flatten_with_paths(like)) else None)
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaf_meta = manifest["leaves"]
        with np.load(os.path.join(d, "arrays.npz")) as data:
            buffers = {
                _npz_to_key(k): _decode(data[k],
                                        leaf_meta[_npz_to_key(k)]["dtype"])
                for k in data.files}
        flat_like = flatten_with_paths(like)
        missing = set(flat_like) - set(buffers)
        if missing:
            raise KeyError(f"checkpoint step {step} missing leaves: "
                           f"{sorted(missing)[:5]}")
        out = {}
        for key, ref in flat_like.items():
            buf = buffers[key]
            if tuple(buf.shape) != tuple(ref.shape):
                raise ValueError(
                    f"leaf {key}: checkpoint shape {tuple(buf.shape)} != "
                    f"expected {tuple(ref.shape)}")
            sh = flat_shard.get(key)
            if sh is None:
                out[key] = _to_device(buf, dev, _like_dtype(ref))
                continue
            host = _to_device(buf, torch.device("cpu"), _like_dtype(ref))
            out[key] = shard(sh.mesh, host, drop_nondivisible(
                sh.spec, host.shape, sh.mesh))
        return unflatten_like(like, out), manifest.get("extra", {})
