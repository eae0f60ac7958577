"""Fault-tolerant checkpointing: atomic, hashed, async.

The port of the reference's ``repro.checkpoint.ckpt``, with its layout
(one directory per step):

    <dir>/step_00000123/
        manifest.json       # leaf names, codec, shapes, dtypes, per-leaf sha256
        leaf_00000.bin.zst  # zstd-compressed raw tensor bytes
        ...                 # (.bin, uncompressed, when zstandard is absent)
        COMMITTED           # written last: absence means incomplete

A tree is nested dicts of tensors (the train state: ``params``, ``opt``,
``step``); its leaves are stored in the order of their sorted
``/``-joined names (``params/embed``, ``opt/m/embed``, ...), as raw bytes
of the tensor's dtype (bfloat16 included, which numpy lacks).

Guarantees, as the reference's:
  * **Atomicity** — the leaves go to ``step_X.tmp``, then ``COMMITTED``
    (fsynced), then one ``os.replace``; ``latest_step`` skips directories
    without the marker.
  * **Integrity** — each leaf's sha256 is checked on restore; a leaf count,
    name, shape or dtype that differs from the target's is refused.
  * **Async** — ``CheckpointManager(async_save=True)`` copies the tree to
    the host at once and writes it on a background thread.

Restore writes each leaf into the target tree's tensor in place (the
target is the fresh state of the same model on its device) and returns
that tree: a full-width state is never held twice on the card.  Leaves
are hashed and written by a few threads at once (``hashlib`` and file
writes release the interpreter lock).

Sharded trees (DTensor leaves, under the partitioner) are stored whole,
as the reference stores them: on save every rank gathers each leaf
(``full_tensor()``, a collective), rank 0 of the default group writes and
the others wait for it at a barrier.  ``restore_checkpoint(...,
shardings=)`` is the reference's elastic path: each leaf, read whole on
every rank, is placed with the *new* mesh's placements
(``repro_torch.dist.partition.distribute``: each rank keeps its chunk), so
a state saved on one mesh (4 × 1, or none) restores onto another (1 × 4);
a target leaf that already has those placements takes the values in
place, any other leaf of the returned tree is the new DTensor.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import json
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.dist.partition import Sharding, distribute

try:  # optional: fall back to raw (uncompressed) leaves when absent
    import zstandard
except ModuleNotFoundError:
    zstandard = None

_MANIFEST = "manifest.json"
_COMMITTED = "COMMITTED"
_IO_THREADS = 4


def have_zstd() -> bool:
    return zstandard is not None


def flatten(tree, prefix: str = "") -> dict:
    """Nested dicts of tensors → ``{"a/b": tensor}`` in sorted name order."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if not isinstance(tree, dict):
        raise TypeError(f"a checkpoint tree holds dicts and tensors, not {type(tree).__name__}"
                        f" (at {prefix or 'the root'!r})")
    out = {}
    for key in sorted(tree):
        out.update(flatten(tree[key], f"{prefix}/{key}" if prefix else str(key)))
    return out


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _host_bytes(t: torch.Tensor, copy: bool = False) -> np.ndarray:
    """The tensor's bytes, row-major, as a uint8 numpy array on the host
    (for a CPU tensor a view of its memory unless ``copy``; a DTensor
    whole, gathered from its shards)."""
    if isinstance(t, DTensor):
        t, copy = t.full_tensor(), False
    arr = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
    return arr.copy() if copy and t.device.type == "cpu" else arr


def _write_leaf(tmp: str, i: int, name: str, t, codec: str) -> dict:
    raw = t if isinstance(t, np.ndarray) else _host_bytes(t)
    digest = hashlib.sha256(raw).hexdigest()
    fname = f"leaf_{i:05d}.bin.zst" if codec == "zstd" else f"leaf_{i:05d}.bin"
    with open(os.path.join(tmp, fname), "wb") as f:
        f.write(zstandard.ZstdCompressor(level=3).compress(raw) if codec == "zstd" else raw)
    return {"file": fname, "name": name, "sha256": digest}


def _writer() -> bool:
    """Whether this rank writes a sharded tree: rank 0 of the default group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def save_checkpoint(path: str, step: int, tree) -> str:
    """Blocking save of a tree of tensors (or of the host copy an async
    ``CheckpointManager.save`` takes).  Returns the committed directory.
    A sharded tree is gathered by every rank and written by rank 0; every
    rank returns once it is committed."""
    flat = tree if isinstance(tree, _HostTree) else _HostTree.of(tree, copy=False)
    final = os.path.join(path, f"step_{step:08d}")
    if flat.sharded:
        if _writer():
            _write(final, step, flat)
        dist.barrier()
        return final
    return _write(final, step, flat)


def _write(final: str, step: int, flat: "_HostTree") -> str:
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    codec = "zstd" if zstandard is not None else "raw"
    with concurrent.futures.ThreadPoolExecutor(_IO_THREADS) as pool:
        futures = [pool.submit(_write_leaf, tmp, i, name, data, codec)
                   for i, (name, data) in enumerate(flat.leaves.items())]
        written = [f.result() for f in futures]
    manifest = {"step": step, "codec": codec, "leaves": [
        {**w, "shape": list(flat.shapes[w["name"]]), "dtype": flat.dtypes[w["name"]]}
        for w in written]}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, _COMMITTED), "w") as f:
        f.write("ok")
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


class _HostTree:
    """A flattened tree ready to write: per leaf its bytes (a host copy when
    ``copy`` or when the tree is sharded, else the tensor itself, copied as
    it is written), shape and dtype name; ``sharded`` when a leaf is a
    DTensor (gathered here, on every rank)."""

    def __init__(self, leaves: dict, shapes: dict, dtypes: dict, sharded: bool = False):
        self.leaves, self.shapes, self.dtypes = leaves, shapes, dtypes
        self.sharded = sharded

    @classmethod
    def of(cls, tree, copy: bool) -> "_HostTree":
        flat = flatten(tree)
        sharded = any(isinstance(t, DTensor) for t in flat.values())
        return cls({k: _host_bytes(t, copy=True) if copy or sharded else t
                    for k, t in flat.items()},
                   {k: tuple(t.shape) for k, t in flat.items()},
                   {k: _dtype_name(t) for k, t in flat.items()}, sharded)


def latest_step(path: str) -> int | None:
    """Largest committed step under ``path`` (uncommitted dirs skipped)."""
    if not os.path.isdir(path):
        return None
    best = None
    for name in os.listdir(path):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(path, name, _COMMITTED)):
                best = max(best or -1, int(name.split("_")[1]))
    return best


def _read_leaf(d: str, meta: dict, target: torch.Tensor, zstd: bool, sharding=None):
    """Read one leaf and check its hash; into ``target`` in place, or, for a
    placed leaf (``sharding``, or a DTensor target), returned as the whole
    host tensor for the caller to place."""
    fname = os.path.join(d, meta["file"])
    raw = bytearray(os.path.getsize(fname))
    with open(fname, "rb") as f:
        f.readinto(raw)
    if zstd:
        raw = bytearray(zstandard.ZstdDecompressor().decompress(raw))
    if hashlib.sha256(raw).hexdigest() != meta["sha256"]:
        raise IOError(f"checksum mismatch in {meta['file']}")
    host = (torch.frombuffer(raw, dtype=torch.uint8).view(target.dtype).reshape(target.shape)
            if raw else torch.empty(target.shape, dtype=target.dtype))
    if sharding is not None or isinstance(target, DTensor):
        return host
    if raw:
        with torch.no_grad():
            target.copy_(host)
    return None


def _place(host: torch.Tensor, target: torch.Tensor, sharding):
    """A whole leaf placed with ``sharding`` (or the target's own
    placements): into the target's local shard in place when the target
    is so placed already, else as a new DTensor."""
    if sharding is None:
        sharding = Sharding(target.device_mesh, tuple(target.placements))
    mesh, placements = sharding
    new = distribute(host.to(mesh.device_type), sharding)
    if (isinstance(target, DTensor) and target.device_mesh == mesh
            and tuple(target.placements) == tuple(placements)):
        with torch.no_grad():
            target.to_local().copy_(new.to_local())
        return target
    return new


def _replace(tree, flat_new: dict, prefix: str = ""):
    """``tree`` with the leaves named in ``flat_new`` replaced."""
    if isinstance(tree, torch.Tensor):
        return flat_new.get(prefix, tree)
    return {k: _replace(v, flat_new, f"{prefix}/{k}" if prefix else str(k))
            for k, v in tree.items()}


def restore_checkpoint(path: str, step: int, target_tree, shardings=None):
    """Restore the checkpoint of ``step`` into ``target_tree`` (nested dicts
    of tensors of the saved names, shapes and dtypes), leaf by leaf in
    place; returns ``target_tree``.  ``shardings``: a tree of the same
    structure of :class:`~repro_torch.dist.partition.Sharding` — each leaf
    is placed with the new mesh's placements (the elastic path; see the
    module's note) and the tree returned holds the placed leaves.  Raises
    ``ValueError`` on a structure, shape or dtype mismatch and ``IOError``
    on a checksum mismatch."""
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    flat = flatten(target_tree)
    leaves = manifest["leaves"]
    if len(flat) != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, target tree has {len(flat)}")
    names = [m["name"] for m in leaves]
    if names != list(flat):
        bad = next(n for n, m in zip(flat, names) if n != m)
        raise ValueError(f"checkpoint leaves are named otherwise than the target tree's "
                         f"(target {bad!r})")
    for meta in leaves:
        t = flat[meta["name"]]
        if tuple(meta["shape"]) != tuple(t.shape) or meta["dtype"] != _dtype_name(t):
            raise ValueError(f"shape mismatch {meta['dtype']}{tuple(meta['shape'])} vs target "
                             f"{_dtype_name(t)}{tuple(t.shape)} in {meta['file']}")
    codec = manifest.get("codec", "zstd")
    if codec == "zstd" and zstandard is None:
        raise ModuleNotFoundError(
            "checkpoint was written with zstd compression but the "
            "'zstandard' module is not installed"
        )
    flat_sh = flatten_shardings(shardings) if shardings is not None else {}
    with concurrent.futures.ThreadPoolExecutor(_IO_THREADS) as pool:
        futures = [pool.submit(_read_leaf, d, meta, flat[meta["name"]], codec == "zstd",
                               flat_sh.get(meta["name"]))
                   for meta in leaves]
        hosts = {meta["name"]: f.result() for meta, f in zip(leaves, futures)}
    placed = {name: _place(host, flat[name], flat_sh.get(name))
              for name, host in hosts.items() if host is not None}
    if not placed:
        return target_tree
    return _replace(target_tree, placed)


def flatten_shardings(tree, prefix: str = "") -> dict:
    """A tree of ``Sharding`` → ``{"a/b": Sharding}`` (``flatten``'s names)."""
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out.update(flatten_shardings(tree[key], f"{prefix}/{key}" if prefix else str(key)))
        return out
    return {prefix: tree}


class CheckpointManager:
    """Keep-last-k manager with optional async (off-critical-path) saves."""

    def __init__(self, path: str, keep: int = 3, async_save: bool = False):
        self.path = path
        self.keep = keep
        self.async_save = async_save
        self._pool = (
            concurrent.futures.ThreadPoolExecutor(max_workers=1)
            if async_save
            else None
        )
        self._pending: concurrent.futures.Future | None = None
        self._sharded = False  # the pending save is of a sharded tree
        os.makedirs(path, exist_ok=True)

    def save(self, step: int, tree):
        if self._pool is not None:
            self.wait()
            # snapshot to the host now (a sharded tree gathered by every
            # rank), write on the background thread (rank 0 of a sharded
            # tree; the others meet it at the barrier of ``wait``)
            host = _HostTree.of(tree, copy=True)
            self._sharded = host.sharded
            if not host.sharded or _writer():
                self._pending = self._pool.submit(self._write_and_gc, step, host)
        else:
            host = _HostTree.of(tree, copy=False)
            if not host.sharded or _writer():
                self._write_and_gc(step, host)
            if host.sharded:
                dist.barrier()

    def _write_and_gc(self, step: int, host: "_HostTree"):
        _write(os.path.join(self.path, f"step_{step:08d}"), step, host)
        self._gc()

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None
        if self._sharded:
            dist.barrier()
            self._sharded = False

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1])
            for n in os.listdir(self.path)
            if n.startswith("step_") and not n.endswith(".tmp")
            and os.path.exists(os.path.join(self.path, n, _COMMITTED))
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step_{s:08d}"), ignore_errors=True)

    def latest(self) -> int | None:
        return latest_step(self.path)

    def restore(self, target_tree, shardings=None, step: int | None = None):
        step = step if step is not None else self.latest()
        if step is None:
            return None
        return restore_checkpoint(self.path, step, target_tree, shardings)

    def close(self):
        """Wait for a pending save and stop the background thread."""
        self.wait()
        if self._pool is not None:
            self._pool.shutdown()
