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
"""

from __future__ import annotations

import json
import shutil
import threading
import zlib
from pathlib import Path

import torch

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
