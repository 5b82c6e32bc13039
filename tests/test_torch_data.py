"""The port's data slice against the JAX package's (CPU, numpy inputs).

Every comparison here is exact: the data path is integer and index
arithmetic, so the port must give the JAX package's bytes and orders bit
for bit (tolerance 0).
"""

import numpy as np
import pytest
import torch

from hybrid_diffusion_tpu.data import datasets as jds
from hybrid_diffusion_tpu.data import native as jnative
from hybrid_diffusion_tpu.data import pipeline as jpipe
from hybrid_diffusion_tpu.data import registry as jreg
from hybrid_diffusion_tpu_torch.data import datasets as tds
from hybrid_diffusion_tpu_torch.data import native as tnative
from hybrid_diffusion_tpu_torch.data import pipeline as tpipe
from hybrid_diffusion_tpu_torch.data import registry as treg
from hybrid_diffusion_tpu_torch.train import loop as tloop

from _torch_parity import one_torch_thread  # noqa: F401


def _png_tree(root, names):
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(len(names))
    for name in names:
        img = rng.integers(0, 256, (5 + len(name) % 3, 7, 3), dtype=np.uint8)
        (root / name).write_bytes(treg._png_bytes(img))


def test_split_data_and_dataset_splits_equal_jax(tmp_path):
    """70/10/20 pools and explicit-dir layouts, returned as (train, test,
    val), on a tmp tree of tiny PNGs."""
    paths = [f"p{i:02d}.png" for i in range(23)]
    for shuffle in (False, True):
        assert (treg.split_data(paths, shuffle=shuffle, seed=3)
                == jreg.split_data(paths, shuffle=shuffle, seed=3))
    with pytest.raises(ValueError):
        treg.split_data(paths, 0.5, 0.1, 0.1)
    _png_tree(tmp_path / "UIEB" / "train", [f"u{i}.png" for i in range(11)])
    for split in ("Train/trainA_paired", "Train/trainB_paired", "Test/testA",
                  "Test/testB", "Val/valA", "Val/valB"):
        _png_tree(tmp_path / "HICRD" / split, [f"h{i}.png" for i in range(4)])
    for name in ("UIEB", "HICRD"):
        assert (treg.dataset_splits(name, str(tmp_path))
                == jreg.dataset_splits(name, str(tmp_path)))
    assert (treg.list_images(str(tmp_path))
            == jreg.list_images(str(tmp_path)))
    # Files decode the same way and resize to the same bytes.
    ours = tds.PairedImageDataset("HICRD", "train", str(tmp_path), 8)
    theirs = jds.PairedImageDataset("HICRD", "train", str(tmp_path), 8)
    for i in range(len(theirs)):
        for k in ("input", "gt"):
            np.testing.assert_array_equal(ours[i][k], theirs[i][k])


def test_load_image_names_the_file_it_cannot_decode(tmp_path):
    bad = tmp_path / "not_an_image.png"
    bad.write_bytes(b"definitely not a png")
    with pytest.raises(FileNotFoundError, match="not_an_image.png"):
        treg.load_image(str(bad))


@pytest.mark.parametrize("domain", ["underwater", "atmospheric"])
def test_synthetic_items_bit_equal_to_jax(domain):
    for task in ("train", "val", "test"):
        ours = tds.make_dataset(f"synthetic-{domain}", task, image_size=24,
                                synthetic_length=14)
        theirs = jds.make_dataset(f"synthetic-{domain}", task, image_size=24,
                                  synthetic_length=14)
        assert len(ours) == len(theirs)
        for i in range(len(theirs)):
            a, b = ours[i], theirs[i]
            assert a["name"] == b["name"]
            for k in ("input", "gt"):
                assert a[k].dtype == np.uint8
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("mode", [tnative.BILINEAR, tnative.NEAREST])
def test_native_and_numpy_resize_bit_equal(mode):
    """The library and the port's numpy twin give the same bytes (the twin
    repeats the C++ float32 arithmetic; the JAX package's numpy fallback,
    in float64, can differ by 1), and the port's resize gives the JAX
    package's."""
    if not tnative.native_available():
        pytest.skip("native/libimage_pipe.so could not be built here")
    rng = np.random.default_rng(5)
    for (h, w), (oh, ow) in (((17, 23), (32, 32)), ((40, 31), (16, 9)),
                             ((317, 483), (256, 256)), ((8, 8), (8, 8))):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        native_out = tnative.resize(img, (oh, ow), mode)
        np.testing.assert_array_equal(
            tnative._numpy_resize(img, oh, ow, mode), native_out)
        np.testing.assert_array_equal(
            tnative.batch_resize([img, img], (oh, ow), mode)[1], native_out)
        np.testing.assert_array_equal(
            native_out, jnative.resize(img, (oh, ow), mode))
    img = rng.integers(0, 256, (21, 13, 3), dtype=np.uint8)
    np.testing.assert_array_equal(treg.resize_image(img, 16),
                                  jreg.resize_image(img, 16))
    np.testing.assert_array_equal(treg.resize_image_wh(img, 9, 30),
                                  jreg.resize_image_wh(img, 9, 30))


def _index_stream(loader, epochs=2):
    out = []
    for e in range(epochs):
        loader.set_epoch(e)
        out.append([list(b["name"]) for b in loader])
    return out


@pytest.mark.parametrize("drop_last", [False, True])
def test_batch_loader_interleave_and_replay_orders_equal_jax(drop_last):
    """BatchLoader, interleave and the stage-2 replay schedule yield the
    same items in the same batches as JAX's over 2 epochs."""
    def pair(mod, name, seed):
        ds = mod.make_dataset(name, "train", image_size=8,
                              synthetic_length=11)
        kw = dict(shuffle=True, seed=seed, num_workers=2,
                  drop_last=drop_last)
        return ds, kw

    uw, kw = pair(tds, "synthetic-underwater", 4)
    juw, jkw = pair(jds, "synthetic-underwater", 4)
    at, akw = pair(tds, "synthetic-atmospheric", 4)
    jat, jakw = pair(jds, "synthetic-atmospheric", 4)
    ours = tpipe.BatchLoader(uw, 3, **kw)
    theirs = jpipe.BatchLoader(juw, 3, **jkw)
    assert len(ours) == len(theirs)
    assert _index_stream(ours) == _index_stream(theirs)
    ours_at = tpipe.BatchLoader(at, 3, **akw)
    theirs_at = jpipe.BatchLoader(jat, 3, **jakw)
    for e in range(2):
        for ld in (ours, theirs, ours_at, theirs_at):
            ld.set_epoch(e)
        a = [b["name"] for b in tpipe.interleave(ours, ours_at)]
        b = [b["name"] for b in jpipe.interleave(theirs, theirs_at)]
        assert a == b
        # The replay schedule (train/loop.py:580-593 in the JAX package):
        # every 2nd stage-2 batch is a stage-1-domain batch.
        a = [b["name"] for b in tloop._with_replay(iter(ours), ours_at, 2)]
        rep, expect = iter(theirs_at), []
        for i, bt in enumerate(theirs):
            if (i + 1) % 2 == 0:
                try:
                    expect.append(next(rep)["name"])
                except StopIteration:
                    rep = iter(theirs_at)
                    expect.append(next(rep)["name"])
            else:
                expect.append(bt["name"])
        assert a == expect
    # And the pixels of one batch, not only the names.
    ours.set_epoch(1), theirs.set_epoch(1)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a["input"], b["input"])


def test_shard_for_host_equal_jax():
    idx = np.random.RandomState(0).permutation(17)
    for rank in range(3):
        np.testing.assert_array_equal(
            tpipe.shard_for_host(idx, rank, 3),
            jpipe.shard_for_host(idx, rank, 3))
    np.testing.assert_array_equal(tpipe.shard_for_host(idx), idx)
    with pytest.raises(ValueError):
        tpipe.shard_for_host(idx[:2], 0, 3)


@pytest.mark.parametrize("drop_last", [False, True])
def test_device_batch_loader_equals_batch_loader(drop_last):
    """The corpus resident on a device (here the CPU) gives BatchLoader's
    batches, bytes and names, over 2 epochs; prefetch hands them over as
    tensors."""
    ds = tds.make_dataset("synthetic-underwater", "train", image_size=8,
                          synthetic_length=10)
    dev = tpipe.DeviceBatchLoader(ds, 4, "cpu", shuffle=True, seed=2,
                                  drop_last=drop_last)
    host = tpipe.BatchLoader(ds, 4, shuffle=True, seed=2, num_workers=1,
                             drop_last=drop_last)
    assert len(dev) == len(host)
    for e in range(2):
        dev.set_epoch(e), host.set_epoch(e)
        got = list(dev)
        want = list(tpipe.device_prefetch(iter(host), "cpu"))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a["name"] == b["name"]
            for k in ("input", "gt"):
                assert isinstance(a[k], torch.Tensor) and a[k].dtype == torch.uint8
                assert torch.equal(a[k], b[k])
