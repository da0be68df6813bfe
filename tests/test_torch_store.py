"""The port's per-FOV store (``io.store``): one API over h5py and NumPy
files, held against the JAX package's ``FovStore``.

A store the port writes with h5py must load in the JAX package with every
dataset, dtype, fill value, chunk shape, compression and attribute equal,
and the reverse; the NumPy backend must give the same reads as the h5py
one, exactly.  A ``save_spots`` cut short before its ``flags`` entry
leaves the region pending in either backend."""

import os
import subprocess
import sys
import threading

import h5py
import numpy as np
import pytest
import torch

from imageanalysis3_tpu.io import store as jstore
from imageanalysis3_tpu_torch.io import store as tstore

BACKENDS = ["h5py", "npy"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spots(rng, n):
    return rng.normal(size=(n, 11)).astype(np.float32)


def _fill(s, rng):
    """The same writes on any store (JAX's or the port's, either backend);
    returns what was written."""
    s.set_fov_info(fov_name="Conv_zscan_00.dax", data_folder="/data",
                   n_rounds=3, pixel=np.float32(0.108))
    s.init_data_type("unique", [3, 7, 9], ["750", "647", "750"],
                     spot_capacity=8)
    s.init_data_type("combo", [1], ["561"], spot_capacity=4)
    sp, raw = _spots(rng, 5), _spots(rng, 5)
    s.save_spots("unique", 7, sp, raw, np.array([0.5, -1.25, 2.0]),
                 flag=tstore.FLAG_CORRECTED, drift_flag=1)
    s.save_spots("unique", 9, _spots(rng, 12), None, [1, 2, 3],
                 flag=tstore.FLAG_RAW)
    s.save_spots("combo", 1, np.zeros((0, 11), np.float32), None,
                 np.zeros(3))
    s.save_image("unique", 3, rng.integers(0, 70000, size=(3, 6, 5)))
    s.save_signal("chrom_coords", np.array([[1.0, 2, 3], [4, 5, 6]]),
                  expected_per_nucleus=2, source="unique")
    s.save_signal("chrom_labels", np.array([1, 2], np.int32))
    s.save_segmentation(np.arange(3 * 6 * 5, dtype=np.int32).reshape(
        3, 6, 5) % 3, method="boxes")
    return sp, raw


def _reads(s):
    """Everything the read API returns, as plain values."""
    out = {"info": {k: (v.item() if hasattr(v, "item") else v)
                    for k, v in s.get_fov_info().items()},
           "types": s.data_types()}
    for dt in s.data_types():
        g = s._fh[dt]
        out[dt] = {k: g[k][:] for k in g.keys()}
        out[dt]["pending"] = s.pending_regions(dt)
        out[dt]["drift_flags"] = s.drift_flags(dt)
        out[dt]["all"] = s.load_all_spots(dt)
        out[dt]["rows"] = [s.load_spots(dt, int(r)) for r in g["ids"][:]]
    out["image"] = s.load_image("unique", 3)
    out["has_image"] = [s.has_image("unique", r) for r in (3, 7)]
    out["signal"] = [s.load_signal(n) for n in
                     ("chrom_coords", "chrom_labels", "missing")]
    out["segmentation"] = s.load_segmentation()
    return out


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b and type(a) is type(b), path


@pytest.mark.parametrize("backend", BACKENDS)
def test_store_api(backend, tmp_path):
    path = str(tmp_path / "fov")
    rng = np.random.default_rng(0)
    with tstore.FovStore(path, backend=backend) as s:
        assert s.backend == backend
        sp, raw = _fill(s, rng)
        assert s.data_types() == ["combo", "unique"]
        np.testing.assert_array_equal(s.ids("unique"), [3, 7, 9])
        assert s.ids("unique").dtype == np.int32
        np.testing.assert_array_equal(s.flags("unique"), [0, 2, 1])
        np.testing.assert_array_equal(s.pending_regions("unique"), [3, 9])
        np.testing.assert_array_equal(
            s.pending_regions("unique", required_flag=1), [3])
        np.testing.assert_array_equal(s.drift_flags("unique"), [0, 1, 0])
        np.testing.assert_array_equal(s.drifts("unique")[1],
                                      [0.5, -1.25, 2.0])
        got, drift, flag = s.load_spots("unique", 7)
        np.testing.assert_array_equal(got, sp)
        assert flag == 2 and drift.dtype == np.float32
        np.testing.assert_array_equal(s._fh["unique"]["raw_spots"][1, :5],
                                      raw)
        assert np.isnan(s._fh["unique"]["raw_spots"][2]).all()
        # capped at the capacity
        assert s.load_spots("unique", 9)[0].shape == (8, 11)
        assert sorted(s.load_all_spots("unique")) == [7, 9]
        assert s.load_spots("combo", 1)[0].shape == (0, 11)
        with pytest.raises(KeyError):
            s.region_index("unique", 4)
        # images: clipped to uint16, created on first save
        assert s.has_image("unique", 3) and not s.has_image("unique", 7)
        assert s.load_image("unique", 3).dtype == np.uint16
        assert s.load_image("unique", 3).max() == 65535
        with pytest.raises(KeyError):
            s.load_image("combo", 1)
        # re-init without overwrite keeps the rows; with it, clears them
        s.init_data_type("unique", [3, 7, 9], ["a", "b", "c"], 8)
        assert s.flags("unique")[1] == 2
        s.set_flag("unique", 7, tstore.FLAG_EMPTY)
        np.testing.assert_array_equal(s.pending_regions("unique"), [3, 7, 9])
        s.transfer_data_type("unique", "rna-unique")
        with pytest.raises(KeyError, match="exists"):
            s.transfer_data_type("combo", "rna-unique")
        with pytest.raises(KeyError, match="not in store"):
            s.transfer_data_type("missing", "x")
        s.transfer_data_type("combo", "rna-unique", overwrite=True)
        np.testing.assert_array_equal(s.ids("rna-unique"), [1])
        s.init_data_type("combo", [1, 2], ["561", "561"], 4, overwrite=True)
        np.testing.assert_array_equal(s.flags("combo"), [0, 0])
        s.save_signal("chrom_coords", np.zeros((0, 3)))
        assert s.load_signal("chrom_coords").shape == (0, 3)
        assert list(s._fh["signal"]["chrom_labels"].attrs.keys()) == []
        assert dict(s._fh["segmentation"].attrs.items()) == \
            {"method": "boxes"}
        s.flush()
    with tstore.FovStore(path, "r", backend=backend) as s:
        info = s.get_fov_info()
        assert info["fov_name"] == "Conv_zscan_00.dax"
        assert info["n_rounds"] == 3
        np.testing.assert_allclose(info["pixel"], 0.108, rtol=1e-6)
        assert sorted(s.data_types()) == ["combo", "rna-unique", "unique"]
        assert s.load_segmentation().shape == (3, 6, 5)
        with pytest.raises(OSError):
            s.set_flag("unique", 7, 2)


def _h5_tree(path):
    """name -> (dtype, shape, values, fillvalue, chunks, compression,
    compression_opts, attrs) of every dataset and group in an HDF5 file."""
    out = {}

    def visit(name, obj):
        attrs = {k: obj.attrs[k] for k in obj.attrs}
        if isinstance(obj, h5py.Dataset):
            out[name] = (obj.dtype, obj.shape, obj[()], obj.fillvalue,
                         obj.chunks, obj.compression, obj.compression_opts,
                         attrs)
        else:
            out[name] = attrs

    with h5py.File(path, "r") as fh:
        out["/"] = {k: fh.attrs[k] for k in fh.attrs}
        fh.visititems(visit)
    return out


def _assert_tree_equal(a, b):
    assert set(a) == set(b)
    for name in a:
        x, y = a[name], b[name]
        if isinstance(x, dict):
            _assert_same(x, y, name)
            continue
        assert x[0] == y[0] and x[1] == y[1], name
        np.testing.assert_array_equal(x[2], y[2], err_msg=name)
        np.testing.assert_array_equal(x[3], y[3], err_msg=name)
        assert x[4:7] == y[4:7], name
        _assert_same(x[7], y[7], name)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_h5py_layout_loads_in_the_other_package(writer, tmp_path):
    paths = {k: str(tmp_path / f"{k}.hdf5") for k in ("port", "jax")}
    for k, cls in (("port", tstore.FovStore), ("jax", jstore.FovStore)):
        with cls(paths[k]) as s:
            _fill(s, np.random.default_rng(1))
    _assert_tree_equal(_h5_tree(paths["port"]), _h5_tree(paths["jax"]))
    reader = jstore.FovStore if writer == "port" else tstore.FovStore
    with reader(paths[writer], "r") as s, \
            jstore.FovStore(paths["jax"], "r") as ref:
        _assert_same(_reads(s), _reads(ref))


def test_npy_backend_reads_equal_h5py(tmp_path):
    reads = {}
    for backend in BACKENDS:
        with tstore.FovStore(str(tmp_path / backend), backend=backend) as s:
            _fill(s, np.random.default_rng(2))
        with tstore.FovStore(str(tmp_path / backend), "r",
                             backend=backend) as s:
            reads[backend] = _reads(s)
    _assert_same(reads["npy"], reads["h5py"])
    # an existing directory opens as the NumPy store without being told
    with tstore.FovStore(str(tmp_path / "npy"), "r") as s:
        assert s.backend == "npy"
    files = sorted(os.listdir(tmp_path / "npy" / "unique"))
    assert files == sorted(f"{k}.npy" for k in (
        "channels", "drift_flags", "drifts", "flags", "ids", "ims",
        "n_spots", "raw_spots", "spots"))


@pytest.mark.parametrize("backend", BACKENDS)
def test_interrupted_save_spots_leaves_region_pending(backend, tmp_path,
                                                      monkeypatch):
    path = str(tmp_path / "fov")
    with tstore.FovStore(path, backend=backend) as s:
        s.init_data_type("unique", [1, 2], ["750", "647"], spot_capacity=8)
        cls = type(s._fh["unique"]["flags"])
        real = cls.__setitem__

        def cut(self, key, value):
            if self.name.endswith("/flags"):
                raise KeyboardInterrupt("cut before the flag")
            return real(self, key, value)

        monkeypatch.setattr(cls, "__setitem__", cut)
        with pytest.raises(KeyboardInterrupt):
            s.save_spots("unique", 2, np.ones((3, 11), np.float32), None,
                         [1.0, 2.0, 3.0])
        monkeypatch.undo()
    with tstore.FovStore(path, "r", backend=backend) as s:
        # the row's payload landed, its flag did not: still pending
        np.testing.assert_array_equal(s.pending_regions("unique"), [1, 2])
        assert s._fh["unique"]["n_spots"][1] == 3
        np.testing.assert_array_equal(s.drifts("unique")[1], [1, 2, 3])


@pytest.mark.parametrize("backend", BACKENDS)
def test_async_writer_equals_sync_and_relays_errors(backend, tmp_path):
    rng = np.random.default_rng(4)
    spots = _spots(rng, 5)
    drift = np.array([1.0, -2.0, 0.5], np.float32)
    stores = {}
    for mode in ("sync", "async"):
        path = str(tmp_path / mode)
        with tstore.FovStore(path, backend=backend) as s:
            s.init_data_type("unique", [1, 2], ["750", "647"],
                             spot_capacity=8)
            sink = tstore.AsyncFovWriter(s) if mode == "async" else s
            sink.save_spots("unique", 2, spots, spots, drift,
                            flag=tstore.FLAG_CORRECTED, drift_flag=1)
            sink.save_image("unique", 1, np.full((2, 3, 3), 7.0))
            sink.save_signal("x", np.arange(3), a=1)
            sink.save_segmentation(np.ones((2, 3, 3), np.int32))
            sink.flush()
            if mode == "async":
                sink.barrier()
                got, got_drift, flag = s.load_spots("unique", 2)
                np.testing.assert_array_equal(got, spots)
                assert flag == tstore.FLAG_CORRECTED
                with pytest.raises(TypeError, match="host arrays"):
                    sink.save_spots("unique", 1, torch.zeros(2, 11), None,
                                    drift)
                sink.close()
        with tstore.FovStore(path, "r", backend=backend) as s:
            stores[mode] = _reads_min(s)
    _assert_same(stores["async"], stores["sync"])
    with tstore.FovStore(str(tmp_path / "err"), backend=backend) as s:
        s.init_data_type("unique", [1], ["750"], spot_capacity=8)
        w = tstore.AsyncFovWriter(s)
        w.save_spots("unique", 99, spots, None, drift)   # unknown region
        w.save_spots("unique", 1, spots, None, drift)    # fail-stop: skipped
        with pytest.raises(RuntimeError, match="async checkpoint"):
            w.close()
        assert s.flags("unique")[0] == 0


def test_npy_store_under_concurrent_writers(tmp_path):
    """Sixteen threads write attributes and rows of one NumPy store at
    once (a short switch interval forces interleaving); no update is
    lost."""
    n_threads, n_each = 16, 20
    with tstore.FovStore(str(tmp_path / "fov"), backend="npy") as s:
        s.init_data_type("unique", list(range(n_threads)),
                         ["750"] * n_threads, spot_capacity=4)

        def work(t):
            for k in range(n_each):
                s.set_fov_info(**{f"t{t}_{k}": k})
                s.save_spots("unique", t, np.full((k % 4 + 1, 11), t,
                                                  np.float32), None,
                             [t, k, 0])
                s.flags("unique")

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=work, args=(t,))
                       for t in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in threads)
        finally:
            sys.setswitchinterval(old)
    with tstore.FovStore(str(tmp_path / "fov"), "r") as s:
        assert len(s.get_fov_info()) == n_threads * n_each
        np.testing.assert_array_equal(s.flags("unique"), 2)
        np.testing.assert_array_equal(s.drifts("unique")[:, 1], n_each - 1)
        for t in range(n_threads):
            np.testing.assert_array_equal(s.load_spots("unique", t)[0], t)


def _reads_min(s):
    g = s._fh["unique"]
    return {**{k: g[k][:] for k in g.keys()},
            "signal": s.load_signal("x"), "seg": s.load_segmentation()}


def test_backend_choice(tmp_path, monkeypatch):
    assert tstore.store_backend() == "h5py"
    os.makedirs(tmp_path / "d")
    assert tstore.store_backend(path=str(tmp_path / "d")) == "npy"
    assert tstore.store_backend("npy") == "npy"
    with pytest.raises(ValueError, match="one of"):
        tstore.store_backend("zarr")
    monkeypatch.setattr(tstore, "_h5py", lambda: None)
    assert tstore.store_backend() == "npy"
    with pytest.raises(ImportError, match="h5py"):
        tstore.FovStore(str(tmp_path / "x.hdf5"), backend="h5py")
    with tstore.FovStore(str(tmp_path / "auto")) as s:
        assert s.backend == "npy"
    with pytest.raises(FileNotFoundError):
        tstore.FovStore(str(tmp_path / "absent"), "r")


def test_port_imports_without_h5py_pandas_or_jax():
    """The package imports where h5py and pandas are missing, and never
    imports JAX or the JAX package."""
    code = (
        "import sys\n"
        "sys.modules['h5py'] = None\n"
        "sys.modules['pandas'] = None\n"
        "import imageanalysis3_tpu_torch.pipeline.experiment as e\n"
        "import imageanalysis3_tpu_torch.segmentation\n"
        "import imageanalysis3_tpu_torch.io as io\n"
        "assert io.store_backend() == 'npy'\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'imageanalysis3_tpu.'))"
        " or m == 'imageanalysis3_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
