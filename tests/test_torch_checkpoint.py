"""The port's checkpoint manager against the JAX package's, on the CPU.

Both write the same on-disk format (``step_%09d/``, ``MANIFEST.json``
format_version 1, ``leaf_%05d.bin`` raw little-endian bytes, crc32, keypaths
as ``jax.tree_util.keystr`` prints them), so a train state written by either
restores into the other, bf16 and int8 leaves included. The port reads and
writes bf16 without ``ml_dtypes``.
"""

import json

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.checkpoint import restore_tree as jax_restore_tree
from repro.checkpoint import save_tree as jax_save_tree
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models.registry import build_model as jax_build_model
from repro.optim import make_optimizer as jax_make_optimizer
from repro.training.steps import init_train_state as jax_init_train_state
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager, restore_tree, save_tree
from repro_torch.checkpoint.manager import MANIFEST
from repro_torch.models.common import tree_leaves


def jax_state(opt_name, param_dtype="bfloat16"):
    """A reference train state of the nbi-100m smoke model: bf16 params, the
    optimizer's state (int8 moments for adamw8bit), an int32 step."""
    cfg = jax_get_smoke_config("nbi100m").replace(param_dtype=param_dtype)
    model, opt = jax_build_model(cfg), jax_make_optimizer(opt_name)
    state = jax_init_train_state(model, opt, jax.random.PRNGKey(2))
    # moments and count away from their zero init, so every byte is checked
    state = jax.tree_util.tree_map(lambda x: x + np.asarray(1, x.dtype) if x.dtype != np.int8 else x - 3, state)
    return jax.tree_util.tree_map(np.asarray, state)


def same_tree(port_tree, np_tree):
    got, want = tree_leaves(port_tree), tree_leaves(np_tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, t), (_, a) in zip(got, want):
        assert tuple(t.shape) == a.shape, path
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16), err_msg=path)
        else:
            np.testing.assert_array_equal(t.numpy(), a, err_msg=path)


@pytest.mark.parametrize("opt_name", ["adamw", "adamw8bit", "lion"])
def test_jax_written_state_restores_into_the_port(tmp_path, opt_name):
    state = jax_state(opt_name)
    JaxCheckpointManager(tmp_path).save(7, state, extra={"data_cursor": 7})
    target = convert.params_from_jax(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), state), "cpu")
    tree, extra, step = CheckpointManager(tmp_path).restore(target)
    assert step == 7 and extra == {"data_cursor": 7}
    same_tree(tree, state)


@pytest.mark.parametrize("opt_name", ["adamw", "adamw8bit", "lion"])
def test_port_written_state_restores_into_the_reference(tmp_path, opt_name):
    state = jax_state(opt_name)
    CheckpointManager(tmp_path).save(5, convert.params_from_jax(state, "cpu"), extra={"arch": "nbi-100m"})
    tree, extra, step = JaxCheckpointManager(tmp_path).restore(state)
    assert step == 5 and extra == {"arch": "nbi-100m"}
    for (path, a), (_, b) in zip(tree_leaves(jax.tree_util.tree_map(np.asarray, tree)), tree_leaves(state)):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(np.atleast_1d(a).view(np.uint8), np.atleast_1d(b).view(np.uint8), err_msg=path)


def test_both_packages_write_the_same_bytes(tmp_path):
    """One train state saved by each package: identical manifests and leaf
    files, byte for byte."""
    state = jax_state("adamw8bit")
    jax_save_tree(tmp_path / "ref", state, extra={"data_cursor": 3})
    save_tree(tmp_path / "port", convert.params_from_jax(state, "cpu"), extra={"data_cursor": 3})
    ref_manifest = json.loads((tmp_path / "ref" / MANIFEST).read_text())
    assert json.loads((tmp_path / "port" / MANIFEST).read_text()) == ref_manifest
    assert ref_manifest["format_version"] == 1
    assert {r["dtype"] for r in ref_manifest["leaves"]} == {"bfloat16", "float32", "int8", "int32"}
    assert ref_manifest["leaves"][0]["keypath"] == "['opt']['count']"
    for rec in ref_manifest["leaves"]:
        assert (tmp_path / "port" / rec["file"]).read_bytes() == (tmp_path / "ref" / rec["file"]).read_bytes()


def small_tree():
    return {"b": {"x": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
            "a": torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
            "n": torch.tensor(4, dtype=torch.int32), "e": torch.zeros((0, 3))}


def test_roundtrip_keeps_dtypes_shapes_and_values(tmp_path):
    tree = small_tree()
    save_tree(tmp_path / "s", tree, extra={"k": [1, 2]})
    out, extra = restore_tree(tmp_path / "s", tree)
    assert extra == {"k": [1, 2]}
    for (p, a), (_, b) in zip(tree_leaves(out), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    # a target on the meta device gives the structure and shapes only
    out, _ = restore_tree(tmp_path / "s", {k: v for k, v in tree.items()} | {"a": torch.empty(2, device="meta")})
    assert out["a"].dtype == torch.bfloat16 and out["a"].device.type == "cpu"


def test_corrupted_leaf_raises(tmp_path):
    save_tree(tmp_path / "s", small_tree())
    leaf = tmp_path / "s" / "leaf_00001.bin"  # ['b']['x']
    raw = bytearray(leaf.read_bytes())
    raw[0] ^= 0xFF
    leaf.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="checksum mismatch"):
        restore_tree(tmp_path / "s", small_tree())
    restore_tree(tmp_path / "s", small_tree(), verify=False)


def test_structure_and_shape_mismatches_raise(tmp_path):
    save_tree(tmp_path / "s", small_tree())
    with pytest.raises(ValueError, match="leaves"):
        restore_tree(tmp_path / "s", {"a": torch.zeros(2)})
    bad = small_tree()
    bad["b"]["x"] = torch.zeros(3, 2)
    with pytest.raises(ValueError, match="shape"):
        restore_tree(tmp_path / "s", bad)


def test_tmp_directory_is_never_restored(tmp_path):
    manager = CheckpointManager(tmp_path)
    manager.save(1, small_tree())
    # a crashed save: a complete-looking step directory still named .tmp
    save_tree(tmp_path / "step_000000009", small_tree())
    (tmp_path / "step_000000009").rename(tmp_path / "step_000000009.tmp")
    assert manager.all_steps() == [1] and manager.latest_step() == 1
    _, _, step = manager.restore(small_tree())
    assert step == 1
    manager.save(2, small_tree())  # a successful save clears orphaned .tmp directories
    assert not (tmp_path / "step_000000009.tmp").exists()


def test_retention_keeps_three(tmp_path):
    manager = CheckpointManager(tmp_path)
    for step in (1, 2, 3, 4, 5):
        manager.save(step, small_tree(), blocking=step % 2 == 0)
    manager.wait()
    assert manager.all_steps() == [3, 4, 5]
    _, _, step = manager.restore(small_tree(), step=4)
    assert step == 4
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(small_tree())


def test_async_save_snapshots_before_the_caller_moves_on(tmp_path):
    manager = CheckpointManager(tmp_path)
    tree = small_tree()
    manager.save(1, tree, blocking=False)
    tree["b"]["x"].add_(100.0)  # the training loop reuses its tensors at once
    manager.wait()
    out, _, _ = manager.restore(small_tree())
    assert torch.equal(out["b"]["x"], small_tree()["b"]["x"])


def test_async_writer_error_is_raised_by_wait(tmp_path):
    manager = CheckpointManager(tmp_path)
    manager.save(1, {"bad": torch.zeros(2, dtype=torch.complex64)}, blocking=False)
    with pytest.raises(ValueError, match="no checkpoint name"):
        manager.wait()


def test_reference_restores_a_port_state_in_its_own_target(tmp_path):
    """The reference's ``restore_tree`` takes ShapeDtypeStruct targets: a port
    checkpoint of the nbi-100m smoke state gives it the right leaves."""
    state = jax_state("adamw", param_dtype="float32")
    save_tree(tmp_path / "s", convert.params_from_jax(state, "cpu"))
    target = jax.tree_util.tree_map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), state)
    tree, _ = jax_restore_tree(tmp_path / "s", target)
    for (path, a), (_, b) in zip(tree_leaves(jax.tree_util.tree_map(np.asarray, tree)), tree_leaves(state)):
        np.testing.assert_array_equal(a, b, err_msg=path)
