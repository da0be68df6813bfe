"""PyTorch port vs JAX package: the per-rank input pipeline in one process.

tests/test_input_pipeline.py's cases on the port: the FOV partition, the
staging-ring prefetcher (order, bytes, backpressure, error relay) and the
upload, whose staging buffer is released only after the copy has landed.
The global batch over four ranks is checked in tests/test_torch_parallel.py
(its gloo group); here it runs on a one-rank group.
"""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from imageanalysis3_tpu.io.dax import split_channels, write_dax
from imageanalysis3_tpu.parallel import shard_fovs as jax_shard_fovs
from imageanalysis3_tpu_torch.parallel import (FovPrefetcher, PrefetchItem,
                                               assemble_global_batch,
                                               make_mesh, prefetch_to_device,
                                               shard_fovs)
from imageanalysis3_tpu_torch.parallel import input_pipeline as tip

CHANNELS = ["750", "647", "561"]
N_Z, BUFFER = 4, 2


def test_shard_fovs_partition_properties():
    fovs = [f"fov_{i:02d}" for i in range(11)]
    shards = [shard_fovs(fovs, pi, 4) for pi in range(4)]
    assert sum(shards, []) == fovs
    sizes = [len(s) for s in shards]
    assert max(sizes) - min(sizes) <= 1 and sizes == [3, 3, 3, 2]
    assert shard_fovs(fovs, 0, 1) == fovs
    assert shard_fovs(fovs[:2], 3, 4) == []
    with pytest.raises(ValueError):
        shard_fovs(fovs, 4, 4)
    # without a process group the defaults are rank 0 of 1
    assert not dist.is_initialized()
    assert shard_fovs(fovs) == fovs
    for n in range(0, 13):
        names = [str(i) for i in range(n)]
        for count in (1, 2, 3, 4, 5, 8):
            for pi in range(count):
                assert shard_fovs(names, pi, count) == \
                    jax_shard_fovs(names, pi, count)


def _write_fovs(tmp_path, n_fov, rng, hw=(16, 16)):
    n_frames = N_Z * len(CHANNELS) + 2 * BUFFER
    paths, movies = [], []
    for k in range(n_fov):
        movie = rng.integers(0, 65535,
                             size=(n_frames,) + hw).astype(np.uint16)
        p = str(tmp_path / f"Conv_zscan_{k:02d}.dax")
        write_dax(p, movie)
        paths.append(p)
        movies.append(movie)
    return paths, movies


def _want(movie):
    return np.stack(split_channels(movie, CHANNELS, CHANNELS, n_z=N_Z,
                                   buffer_frames=BUFFER))


def test_prefetcher_yields_shard_in_order(tmp_path, rng):
    paths, movies = _write_fovs(tmp_path, 5, rng)
    pf = FovPrefetcher(paths, CHANNELS, n_z=N_Z, buffer_frames=BUFFER,
                       depth=2)
    got, bufs = [], set()
    for item in pf:
        np.testing.assert_array_equal(item.array, _want(movies[len(got)]))
        assert item.name == paths[len(got)] and item.staging is None
        bufs.add(item.array.__array_interface__["data"][0])
        got.append(item.array.copy())
    assert len(got) == 5 and len(bufs) == 2       # the ring is reused
    for k, arr in enumerate(got):
        np.testing.assert_array_equal(arr, _want(movies[k]))
    with pytest.raises(RuntimeError, match="single-use"):
        iter(pf).__next__()


def test_prefetcher_backpressure(tmp_path, rng, monkeypatch):
    """With `depth` staging sets the reader blocks once every set is on
    loan and resumes when one is released; a borrowed buffer is never
    overwritten."""
    paths, movies = _write_fovs(tmp_path, 4, rng)
    reads = []
    real = tip.load_dax_channels

    def counted(path, *a, **kw):
        reads.append(path)
        return real(path, *a, **kw)

    monkeypatch.setattr(tip, "load_dax_channels", counted)
    it = iter(FovPrefetcher(paths, CHANNELS, n_z=N_Z, buffer_frames=BUFFER,
                            depth=2))
    first = next(it)
    deadline = time.monotonic() + 10
    while len(reads) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.3)
    assert reads == paths[:2]         # the reader waits for a free set
    np.testing.assert_array_equal(first.array, _want(movies[0]))
    first.release()
    deadline = time.monotonic() + 10
    while len(reads) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert reads == paths[:3]
    rest = [item.array.copy() for item in it]
    for k, arr in enumerate(rest, start=1):
        np.testing.assert_array_equal(arr, _want(movies[k]))


def test_prefetcher_error_relay(tmp_path, rng):
    paths, _ = _write_fovs(tmp_path, 2, rng)
    pf = FovPrefetcher(paths + [str(tmp_path / "missing.dax")],
                       CHANNELS, n_z=N_Z, buffer_frames=BUFFER)
    it = iter(pf)
    next(it).release()
    next(it).release()
    with pytest.raises(RuntimeError, match="prefetcher read failed"):
        next(it)


def test_prefetch_to_device_end_to_end(tmp_path, rng):
    """shard -> prefetch -> upload -> compute matches the direct host
    computation FOV for FOV (tests/test_input_pipeline.py's case)."""
    paths, movies = _write_fovs(tmp_path, 4, rng)
    my = shard_fovs(paths, 0, 1)
    pf = FovPrefetcher(my, CHANNELS, n_z=N_Z, buffer_frames=BUFFER)
    results = {}
    for name, dev in prefetch_to_device(iter(pf), device="cpu"):
        assert dev.dtype == torch.uint16
        results[name] = dev.to(torch.float32).sum(dim=(1, 2, 3))
    assert list(results) == my
    for k, name in enumerate(my):
        want = _want(movies[k]).astype(np.float64).sum(axis=(1, 2, 3))
        np.testing.assert_allclose(results[name].numpy(), want,
                                   rtol=1e-6 * N_Z * 16 * 16)


def test_upload_released_only_after_it_lands():
    """The buffer goes back only after the copy: a release that scribbles
    over the staging buffer (the reader reusing it at once) leaves the
    yielded tensor intact, and each release comes before the next item."""
    src = [np.full((2, 3, 4, 4), k, np.uint16) for k in range(3)]
    log = []

    def items():
        for k, a in enumerate(src):
            def release(a=a, k=k):
                log.append(("release", k))
                a[...] = 65535
            yield PrefetchItem(f"fov{k}", a, _release=release)

    for k, (name, t) in enumerate(prefetch_to_device(items(), device="cpu")):
        log.append(("got", k))
        assert name == f"fov{k}"
        assert (t == k).all()
    assert log == [("release", 0), ("got", 0), ("release", 1), ("got", 1),
                   ("release", 2), ("got", 2)]


def test_prefetch_to_device_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    item = PrefetchItem("a", np.zeros((1, 1, 2, 2), np.uint16))
    with pytest.raises(RuntimeError, match="CUDA"):
        next(prefetch_to_device([item]))


def test_assemble_global_batch_one_rank():
    """A one-rank gloo group made in this process: local == global, the
    placement is Shard(0), and the group is torn down after."""
    from torch.distributed.tensor import Shard
    batch = np.arange(8 * 3 * 4, dtype=np.float32).reshape(8, 3, 4)
    mesh = make_mesh(device_type="cpu", store=dist.HashStore(), rank=0,
                     world_size=1)
    try:
        arr = assemble_global_batch(batch, mesh)
        assert tuple(arr.placements) == (Shard(0),)
        assert arr.shape == (8, 3, 4)
        np.testing.assert_array_equal(arr.full_tensor().numpy(), batch)
        np.testing.assert_array_equal(arr.to_local().numpy(), batch)
        assert shard_fovs(list("abc")) == list("abc")
    finally:
        dist.destroy_process_group()
