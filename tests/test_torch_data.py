"""The port's data module (a numpy copy) yields exactly the JAX package's test
batches and tiled train batches, in the same order and with the same
normalization."""

import numpy as np

from orbit2_tpu.data.itermodule import IterDataModule as JaxIterDataModule
from orbit2_tpu_torch.data.itermodule import IterDataModule


def _modules(ds, batch_size):
    kw = dict(out_vars=ds["out_vars"], batch_size=batch_size, num_workers=0, div=1,
              overlap=0, seed=0)
    a = JaxIterDataModule("downscaling", ds["low"], ds["high"], ds["in_vars"], **kw)
    b = IterDataModule("downscaling", ds["low"], ds["high"], ds["in_vars"], **kw)
    a.setup("test")
    b.setup("test")
    return a, b


def test_test_batches_match_jax(synth_dataset):
    a, b = _modules(synth_dataset, batch_size=3)  # 16 samples: a ragged tail batch
    assert b.get_data_dims() == a.get_data_dims()
    assert b.get_data_variables() == a.get_data_variables()
    assert b.num_batches("test") == a.num_batches("test") == 6
    got, want = list(b.test_dataloader()), list(a.test_dataloader())
    assert len(got) == len(want)
    for (gx, gy, gin, gout), (wx, wy, win, wout) in zip(got, want):
        assert gin == win and gout == wout
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_normalization_and_climatology_match_jax(synth_dataset):
    a, b = _modules(synth_dataset, batch_size=4)
    assert list(b.get_out_transforms()) == list(a.get_out_transforms())
    for k, t in a.get_out_transforms().items():
        assert repr(b.get_out_transforms()[k]) == repr(t)
    ca, cb = a.get_climatology("test"), b.get_climatology("test")
    assert list(ca) == list(cb)
    for k in ca:
        np.testing.assert_array_equal(cb[k], ca[k])
    for x, y in zip(a.get_lat_lon(), b.get_lat_lon()):
        np.testing.assert_array_equal(x, y)


def test_tiled_train_batches_match_jax(synth_dataset):
    """The train split at div 2 / overlap 2 (the TILES tiles Trainer.fit
    trains on), shuffled and interleaved over two workers: the same tile
    batches as the JAX IterDataModule's, in the same order, over two whole
    epochs."""
    ds = synth_dataset
    kw = dict(out_vars=ds["out_vars"], batch_size=4, buffer_size=8, num_workers=2, div=2,
              overlap=2, seed=3, drop_last=True)
    a = JaxIterDataModule("downscaling", ds["low"], ds["high"], ds["in_vars"], **kw)
    b = IterDataModule("downscaling", ds["low"], ds["high"], ds["in_vars"], **kw)
    a.setup()
    b.setup()
    assert b.get_data_dims() == a.get_data_dims()
    assert b.num_batches("train") == a.num_batches("train") == 16  # 16 fields of 4 tiles
    for _ in range(2):
        got, want = list(b.train_dataloader()), list(a.train_dataloader())
        assert len(got) == len(want) == 16
        for (gx, gy, gin, gout), (wx, wy, win, wout) in zip(got, want):
            assert gin == win and gout == wout
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
