"""The port's data pipeline against the JAX package's, on the CPU: the same
seed, vocab, cursor and host shard give the same batches to the bit, so the
two packages train on one stream and a checkpoint's cursor means the same in
both."""

import threading

import numpy as np
import pytest

from repro.data import SyntheticLMDataset as JaxDataset
from repro.data import make_train_loader as jax_make_train_loader
from repro_torch.data import DataLoader, SyntheticLMDataset, host_shard_for, make_train_loader


def take(loader, n):
    try:
        return [next(loader) for _ in range(n)]
    finally:
        loader.close()


def same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y) == ["labels", "tokens"]
        for k in x:
            assert x[k].dtype == y[k].dtype == np.int32
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("start,host_index,host_count", [(0, 0, 1), (5, 0, 1), (3, 1, 2), (17, 3, 4)])
def test_loader_yields_the_reference_batches(start, host_index, host_count):
    kw = dict(seed=4, host_index=host_index, host_count=host_count, start=start)
    got = take(make_train_loader(32768, 8, 32, **kw), 3)
    want = take(jax_make_train_loader(32768, 8, 32, **kw), 3)
    same_batches(got, want)
    assert got[0]["tokens"].shape == (8 // host_count, 32)


@pytest.mark.parametrize("vocab,seed", [(512, 0), (100, 7)])
def test_dataset_matches_reference_and_shards_tile_the_global_batch(vocab, seed):
    port, ref = SyntheticLMDataset(vocab, seed=seed), JaxDataset(vocab, seed=seed)
    np.testing.assert_array_equal(port.tokens(2, 6, 40), ref.tokens(2, 6, 40))
    full = port.batch(3, 8, 16)
    parts = [port.batch(3, sh.rows, 16, row_offset=sh.row_offset)
             for sh in (host_shard_for(8, h, 4) for h in range(4))]
    np.testing.assert_array_equal(np.concatenate([p["tokens"] for p in parts]), full["tokens"])
    np.testing.assert_array_equal(full["labels"][:, :-1], full["tokens"][:, 1:])
    assert full["tokens"].min() >= 0 and full["tokens"].max() < vocab


def test_cursor_resume_continues_the_reference_stream():
    """A loader restored from another's ``state_dict`` continues where it
    stopped, with the batches the reference gives from that cursor."""
    first = make_train_loader(512, 4, 16, seed=1)
    take_first = [next(first) for _ in range(3)]
    state = first.state_dict()
    first.close()
    assert state == {"cursor": 3}
    second = make_train_loader(512, 4, 16, seed=1)
    second.load_state_dict(state)
    same_batches(take(second, 2), take(jax_make_train_loader(512, 4, 16, seed=1, start=3), 2))
    same_batches(take_first, take(jax_make_train_loader(512, 4, 16, seed=1), 3))


def test_host_shard_rejects_bad_layouts():
    with pytest.raises(ValueError):
        host_shard_for(10, 0, 3)
    with pytest.raises(ValueError):
        host_shard_for(8, 4, 4)


def test_backup_fetch_beats_a_straggler_and_keeps_order():
    """Attempt 0 of batch 2 hangs; the backup (attempt 1) wins, in order."""
    release = threading.Event()

    def hook(idx, attempt):
        if idx == 2 and attempt == 0:
            release.wait(timeout=5)

    loader = DataLoader(lambda i: i, prefetch=1, workers=2, straggler_ms=50, fetch_hook=hook)
    out = [next(loader) for _ in range(4)]
    release.set()
    loader.close()
    assert out == [0, 1, 2, 3]
    assert loader.stats["backups"] >= 1 and loader.stats["backup_wins"] >= 1
