"""Checkpoint manager: atomic, async, integrity-checked (the port of
``repro.checkpoint.manager``), in the reference's on-disk format, so that a
checkpoint written by either package restores into the other.

Layout (one directory per step)::

    <dir>/step_000000400/
        MANIFEST.json          # format_version 1, keypaths, shapes, dtypes, crc32s, extra
        leaf_00000.bin         # one file per leaf: raw little-endian bytes
        ...
    <dir>/step_000000400.tmp/  # never visible as a valid checkpoint

* Leaves are a nested dict's, in JAX's flattening order (sorted keys), with
  keypaths as ``jax.tree_util.keystr`` prints them (``['params']['embed']``).
* dtypes are numpy's names. ``bfloat16`` needs no ``ml_dtypes``: its 16 bits
  are written through an int16 view and read back with
  ``torch.frombuffer(..., dtype=torch.bfloat16)``.
* Atomicity: a step is written to ``<step>.tmp`` and renamed into place;
  ``all_steps`` never lists a ``.tmp`` directory.
* Async save: ``save(..., blocking=False)`` copies the tree to host memory,
  then writes on a background thread; ``wait()`` joins it and re-raises its
  error.
* Integrity: every leaf records a crc32 of its bytes; restore verifies it and
  raises on a mismatch.
* Retention: the ``keep`` newest checkpoints survive, older ones are removed
  after a successful save.
* ``extra``: an opaque JSON dict (data cursor, stop reason, ...) saved beside
  the tree.
* Sharded states (a tree of DTensors, the train step on a device mesh):
  ``save_sharded`` stores them unsharded in the same format, as the reference
  stores a sharded state. Every rank takes part in gathering each leaf, one
  slice along its first dim at a time where that dim is not sharded (a layer
  of a stacked leaf), else whole; rank 0 appends each slice to the leaf's
  file from host memory, so no host holds more than one slice. The write is
  synchronous. ``restore_sharded`` restores onto any mesh ("elastic
  restore"): each rank reads only its own shard of each leaf (a memory map
  of the leaf's file) and wraps it with that mesh's placements.
"""

from __future__ import annotations

import contextlib
import json
import math
import shutil
import threading
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.common import map_defs, tree_leaves, tree_unflatten

MANIFEST = "MANIFEST.json"
_FORMAT_VERSION = 1

# numpy's dtype names, as the reference's manifests write them
_NAMES = {
    torch.float64: "float64", torch.float32: "float32", torch.float16: "float16",
    torch.bfloat16: "bfloat16", torch.int64: "int64", torch.int32: "int32",
    torch.int16: "int16", torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
}
_DTYPES = {name: dt for dt, name in _NAMES.items()}


def _raw(t: torch.Tensor) -> bytes:
    """A host tensor's bytes in memory order (little-endian on every host the
    port runs on); bf16 through an int16 view, which numpy can hold."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _from_raw(raw: bytes, dtype_name: str, shape) -> torch.Tensor:
    if dtype_name not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype_name!r} in checkpoint")
    dtype = _DTYPES[dtype_name]
    if not raw:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(bytearray(raw), dtype=dtype).reshape(shape)


def save_tree(path, tree, *, extra: dict | None = None) -> None:
    """Write a nested dict of tensors to ``path`` atomically (``path`` is
    replaced if it exists)."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    records = []
    for i, (keypath, leaf) in enumerate(tree_leaves(tree)):
        t = leaf.detach().cpu()
        if t.dtype not in _NAMES:
            raise ValueError(f"{keypath}: dtype {t.dtype} has no checkpoint name")
        raw = _raw(t)
        fname = f"leaf_{i:05d}.bin"
        (tmp / fname).write_bytes(raw)
        records.append({
            "index": i, "keypath": keypath, "file": fname, "shape": list(t.shape),
            "dtype": _NAMES[t.dtype], "crc32": zlib.crc32(raw),
        })
    manifest = {"format_version": _FORMAT_VERSION, "n_leaves": len(records),
                "leaves": records, "extra": extra or {}}
    (tmp / MANIFEST).write_text(json.dumps(manifest, indent=1))
    if path.exists():
        shutil.rmtree(path)
    tmp.rename(path)  # atomic publish


def restore_tree(path, target_tree, *, device="cpu", verify: bool = True):
    """Load a checkpoint into the structure of ``target_tree`` (a nested dict
    whose leaves have ``.shape``; their values are ignored), each leaf on
    ``device`` in the dtype it was saved in. Returns ``(tree, extra)``."""
    path = Path(path)
    manifest = json.loads((path / MANIFEST).read_text())
    targets = tree_leaves(target_tree)
    if manifest["n_leaves"] != len(targets):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves; target structure has {len(targets)}")
    out = [None] * len(targets)
    for rec in manifest["leaves"]:
        raw = (path / rec["file"]).read_bytes()
        if verify and zlib.crc32(raw) != rec["crc32"]:
            raise IOError(f"checksum mismatch for {rec['keypath']} in {path}")
        t = _from_raw(raw, rec["dtype"], rec["shape"])
        want = tuple(targets[rec["index"]][1].shape)
        if tuple(t.shape) != want:
            raise ValueError(f"{rec['keypath']}: checkpoint shape {tuple(t.shape)} != target {want}")
        out[rec["index"]] = t.to(device)
    return tree_unflatten(target_tree, out), manifest.get("extra", {})


def _host_parts(t):
    """Host copies of a DTensor's whole value, in memory order: a slice along
    dim 0 at a time where dim 0 is not sharded, else the whole leaf. Every
    rank of the mesh calls this together (each part is an all-gather)."""
    if t.ndim >= 2 and not any(p.is_shard(0) for p in t.placements):
        for i in range(t.shape[0]):
            yield t[i].full_tensor().cpu()
    else:
        yield t.full_tensor().cpu()


def save_sharded_tree(path, tree, *, extra: dict | None = None) -> None:
    """:func:`save_tree` of a tree of DTensors, unsharded; every rank calls
    it, rank 0 writes. Returns when the checkpoint is published."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    writer = dist.get_rank() == 0
    if writer:
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
    records = []
    for i, (keypath, leaf) in enumerate(tree_leaves(tree)):
        if leaf.dtype not in _NAMES:
            raise ValueError(f"{keypath}: dtype {leaf.dtype} has no checkpoint name")
        fname, crc = f"leaf_{i:05d}.bin", 0
        with open(tmp / fname, "wb") if writer else contextlib.nullcontext() as f:
            for part in _host_parts(leaf.detach()):
                if writer:
                    raw = _raw(part)
                    crc = zlib.crc32(raw, crc)
                    f.write(raw)
        records.append({"index": i, "keypath": keypath, "file": fname, "shape": list(leaf.shape),
                        "dtype": _NAMES[leaf.dtype], "crc32": crc})
    if writer:
        manifest = {"format_version": _FORMAT_VERSION, "n_leaves": len(records),
                    "leaves": records, "extra": extra or {}}
        (tmp / MANIFEST).write_text(json.dumps(manifest, indent=1))
        if path.exists():
            shutil.rmtree(path)
        tmp.rename(path)  # atomic publish
    dist.barrier()


def _crc_of_file(file: Path) -> int:
    crc = 0
    with open(file, "rb") as f:
        while chunk := f.read(1 << 24):
            crc = zlib.crc32(chunk, crc)
    return crc


def restore_sharded_tree(path, target_tree, placements_tree, mesh, *, device, verify: bool = True):
    """Load a checkpoint onto ``mesh``: each leaf a DTensor with the
    placements of ``placements_tree``, of which this rank reads only its own
    shard from the leaf's file. ``target_tree``'s leaves give the shapes
    (meta tensors will do). Returns ``(tree, extra)``."""
    from repro_torch.parallel.sharding import from_local, local_slices

    path = Path(path)
    manifest = json.loads((path / MANIFEST).read_text())
    targets, placements = tree_leaves(target_tree), [p for _, p in tree_leaves(placements_tree)]
    if manifest["n_leaves"] != len(targets):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves; target structure has {len(targets)}")
    out = [None] * len(targets)
    for rec in manifest["leaves"]:
        file, shape, name = path / rec["file"], tuple(rec["shape"]), rec["dtype"]
        if shape != tuple(targets[rec["index"]][1].shape):
            raise ValueError(f"{rec['keypath']}: checkpoint shape {shape} != target {tuple(targets[rec['index']][1].shape)}")
        if name not in _DTYPES:
            raise ValueError(f"unsupported dtype {name!r} in checkpoint")
        if verify and _crc_of_file(file) != rec["crc32"]:
            raise IOError(f"checksum mismatch for {rec['keypath']} in {path}")
        pl = placements[rec["index"]]
        if not shape or not math.prod(shape):
            local = _from_raw(file.read_bytes(), name, shape)
        else:
            held = np.memmap(file, dtype=np.int16 if name == "bfloat16" else np.dtype(name), mode="r", shape=shape)
            local = torch.from_numpy(np.array(held[local_slices(shape, pl, mesh)], copy=True))
            if name == "bfloat16":
                local = local.view(torch.bfloat16)
        out[rec["index"]] = from_local(local.to(device), mesh, pl, shape)
    return tree_unflatten(target_tree, out), manifest.get("extra", {})


class CheckpointManager:
    """Step-indexed checkpoints with retention and async writes."""

    def __init__(self, directory, *, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = int(keep)
        self._writer: threading.Thread | None = None
        self._writer_error: BaseException | None = None

    # -- paths -----------------------------------------------------------------

    def step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:09d}"

    def all_steps(self) -> list[int]:
        steps = []
        for p in self.dir.glob("step_*"):
            if p.name.endswith(".tmp") or not (p / MANIFEST).exists():
                continue
            try:
                steps.append(int(p.name.split("_")[1]))
            except ValueError:
                continue
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save --------------------------------------------------------------------

    def save(self, step: int, tree, *, extra: dict | None = None, blocking: bool = True) -> Path:
        """Checkpoint ``tree`` at ``step``. A non-blocking save copies the tree
        to host memory first (the caller may then reuse its tensors), then
        writes on a background thread."""
        self.wait()  # one async save in flight at a time
        target = self.step_dir(step)
        host_tree = map_defs(lambda t: t.detach().to("cpu", copy=True), tree)

        def write():
            try:
                save_tree(target, host_tree, extra=extra)
                self._gc()
            except BaseException as e:  # re-raised in wait()
                self._writer_error = e

        if blocking:
            write()
            self._raise_writer_error()
        else:
            self._writer = threading.Thread(target=write, daemon=True, name="ckpt-writer")
            self._writer.start()
        return target

    def save_sharded(self, step: int, tree, *, extra: dict | None = None) -> Path:
        """Checkpoint a tree of DTensors unsharded (:func:`save_sharded_tree`);
        every rank calls it, synchronously."""
        self.wait()
        target = self.step_dir(step)
        save_sharded_tree(target, tree, extra=extra)
        if dist.get_rank() == 0:
            self._gc()
        return target

    def restore_sharded(self, target_tree, placements_tree, mesh, *, step: int | None = None, device="cpu"):
        """Restore ``step`` (default: latest) onto ``mesh``
        (:func:`restore_sharded_tree`). Returns (tree, extra, step)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.dir}")
        tree, extra = restore_sharded_tree(self.step_dir(step), target_tree, placements_tree, mesh, device=device)
        return tree, extra, step

    def wait(self) -> None:
        """Join any in-flight async save (re-raises its error, if any)."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        self._raise_writer_error()

    def _raise_writer_error(self):
        if self._writer_error is not None:
            err, self._writer_error = self._writer_error, None
            raise err

    # -- restore -----------------------------------------------------------------

    def restore(self, target_tree, *, step: int | None = None, device="cpu"):
        """Restore ``step`` (default: latest) onto ``device``. Returns (tree,
        extra, step)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.dir}")
        self.wait()
        tree, extra = restore_tree(self.step_dir(step), target_tree, device=device)
        return tree, extra, step

    # -- retention ------------------------------------------------------------------

    def _gc(self) -> None:
        steps = self.all_steps()
        for step in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.step_dir(step), ignore_errors=True)
        # clear orphaned tmp dirs from crashed saves
        for tmp in self.dir.glob("step_*.tmp"):
            shutil.rmtree(tmp, ignore_errors=True)
