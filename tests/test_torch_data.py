"""The port's synthetic data against the JAX package, on the CPU.

Both make their arrays with the same numpy calls, so the batches must be
EQUAL for equal (seed, step, shard, num_shards), in value and dtype
(int32 tokens and labels, as the JAX package's ``jnp.asarray`` gives
them), and ``entropy_floor`` must be the same float.
"""

import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn
from repro_torch.data import synthetic as tsyn

CFGS = [dict(seed=3, vocab_size=64, seq_len=32, global_batch=8),
        dict(seed=0, vocab_size=512, seq_len=16, global_batch=4),
        dict(seed=7, vocab_size=256000, seq_len=64, global_batch=8),
        dict(seed=1, vocab_size=100, seq_len=8, global_batch=6,
             branch_factor=3)]


def _equal(got: torch.Tensor, want):
    want = np.asarray(want)
    assert got.device.type == "cpu"
    assert got.numpy().dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw", CFGS)
def test_markov_batch_equal(kw):
    jc, tc = jsyn.DataConfig(**kw), tsyn.DataConfig(**kw)
    for step in (0, 1, 7, 1234):
        for shard, n in ((0, 1), (0, 2), (1, 2)):
            want = jsyn.markov_batch(jc, step, shard, n)
            got = tsyn.markov_batch(tc, step, shard, n, device="cpu")
            assert set(got) == set(want)
            for k in want:
                _equal(got[k], want[k])


@pytest.mark.parametrize("kw", CFGS)
def test_entropy_floor_equal(kw):
    want = jsyn.entropy_floor(jsyn.DataConfig(**kw))
    got = tsyn.entropy_floor(tsyn.DataConfig(**kw))
    assert isinstance(got, float) and got == want


@pytest.mark.parametrize("seed,step,batch,size,classes,shard,n", [
    (100, 0, 4, 16, 10, 0, 1), (200, 3, 8, 32, 100, 1, 2),
    (5, 10_000, 6, 8, 7, 2, 3)])
def test_image_batch_equal(seed, step, batch, size, classes, shard, n):
    jx, jy = jsyn.image_batch(seed, step, batch, size, classes, shard, n)
    tx, ty = tsyn.image_batch(seed, step, batch, size, classes, shard, n,
                              device="cpu")
    _equal(tx, jx)
    _equal(ty, jy)
    assert tx.shape == (batch // n, size, size, 3)


def test_uneven_shards_raise():
    cfg = tsyn.DataConfig(global_batch=8)
    with pytest.raises(ValueError, match="shards"):
        tsyn.markov_batch(cfg, 0, 0, 3, device="cpu")
    with pytest.raises(ValueError, match="shards"):
        tsyn.image_batch(0, 0, 8, 8, 10, 0, 3, device="cpu")


def test_default_device_is_the_card(monkeypatch):
    """No device= means the CUDA card: without one it raises, never
    quietly lands on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsyn.markov_batch(tsyn.DataConfig(), 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsyn.image_batch(0, 0, 2, 8, 10)


# ---------------------------------------------------------------------------
# ports of tests/test_training.py::TestData
# ---------------------------------------------------------------------------

CFG = tsyn.DataConfig(seed=3, vocab_size=64, seq_len=32, global_batch=8)


def _batch(step, shard=0, num_shards=1):
    return tsyn.markov_batch(CFG, step, shard, num_shards, device="cpu")


def test_deterministic():
    assert torch.equal(_batch(7)["tokens"], _batch(7)["tokens"])


def test_steps_differ():
    assert not torch.equal(_batch(7)["tokens"], _batch(8)["tokens"])


def test_shards_partition_the_batch():
    full, s0, s1 = _batch(3), _batch(3, 0, 2), _batch(3, 1, 2)
    assert s0["tokens"].shape[0] == s1["tokens"].shape[0] == 4
    assert full["tokens"].shape[0] == 8
    assert not torch.equal(s0["tokens"], s1["tokens"])


def test_labels_are_shifted_tokens():
    b = _batch(0)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert b["tokens"].dtype == b["labels"].dtype == torch.int32


def test_entropy_floor_positive():
    f = tsyn.entropy_floor(CFG)
    assert 0.5 < f < np.log(CFG.vocab_size)
