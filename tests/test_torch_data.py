"""Port vs JAX: the synthetic data pipeline (`repro_torch/data/` against
`repro/data/`).  Both draw numpy `default_rng` streams from the same
seeds, so every batch is held bit for bit."""
import numpy as np
import pytest
import torch

from repro.data import SyntheticLM as JSyn
from repro.data import batch_specs as j_batch_specs
from repro_torch.data import SyntheticLM, batch_specs, make_batch_iterator


@pytest.mark.parametrize("kw", [
    dict(vocab=256, seq_len=64, global_batch=4, seed=0),
    dict(vocab=49152, seq_len=512, global_batch=2, seed=3),
    dict(vocab=100, seq_len=8, global_batch=3, seed=1),        # < a motif
    dict(vocab=300, seq_len=40, global_batch=7, seed=2, n_hosts=3,
         host_id=0),                                             # uneven
    dict(vocab=300, seq_len=40, global_batch=7, seed=2, n_hosts=3,
         host_id=2),
])
def test_batches_match_jax(kw):
    j, t = JSyn(**kw), SyntheticLM(**kw)
    assert t.host_batch == j.host_batch
    for step in (0, 1, 17):
        jb, tb = j.batch(step), t.batch(step)
        assert jb.keys() == tb.keys()
        for k in jb:
            assert tb[k].dtype == jb[k].dtype, k
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    b = t.batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert 0 <= b["tokens"].min() and b["tokens"].max() < kw["vocab"]


def test_batch_specs_match_jax():
    want = j_batch_specs(49152, 2048, 8)
    got = batch_specs(49152, 2048, 8)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == v.shape
        assert str(got[k].dtype).replace("torch.", "") == str(v.dtype)


def test_prefetch_iterator_yields_the_steps_in_order():
    ds = SyntheticLM(vocab=64, seq_len=16, global_batch=2, seed=5)
    it = make_batch_iterator(ds, start_step=3, prefetch=2)
    for step in (3, 4, 5):
        got = next(it)
        np.testing.assert_array_equal(got["tokens"], ds.batch(step)["tokens"])
    it.close()                              # sets the producer's stop flag
    assert isinstance(torch.from_numpy(got["labels"]), torch.Tensor)
