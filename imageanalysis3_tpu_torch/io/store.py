"""Per-FOV result store: the pipeline's checkpoint, with two file formats.

The counterpart of ``imageanalysis3_tpu/io/store.py``, with one API over two
backends:

* ``"h5py"``: one HDF5 file, in the JAX package's layout exactly (the same
  groups, datasets, dtypes, fill values, chunks and gzip level), so a store
  written by either package loads in the other;
* ``"npy"``: for machines without h5py.  A directory per FOV: one ``.npy``
  file per dataset (``<group>/<name>.npy``), rows written in place through
  ``np.lib.format.open_memmap(mode="r+")`` and flushed, and one JSON index
  (``attrs.json``) holding every attribute, rewritten through a temporary
  file and ``os.replace``.  Nothing is compressed here: the optional
  ``ims`` payload takes its full uint16 size on disk.

``backend=None`` opens an existing directory with ``"npy"``, and otherwise
takes h5py when it imports, else ``"npy"``; ``"h5py"`` or ``"npy"`` forces
one (forcing h5py where it is missing raises ``ImportError``).  h5py is
imported only here, inside the function that opens a file.

Behavior target: the reference's per-FOV `.hdf5` savefile
(classes/field_of_view.py:374-410, 1160-1708; classes/batch_functions.py:
305-493): root attrs carry fov_info; one group per data_type ('unique',
'combo', ...) holding parallel datasets `ids`, `channels`, `flags`,
`drifts`, `spots`, `raw_spots` (and optionally `ims`); plus `segmentation`
and `signal` groups.  Flags: 0 = empty, 1 = spots saved with uncorrected
coords, 2 = fully corrected (reference classes/batch_functions.py:348-355).
Resume = reading `flags`: :meth:`FovStore.save_spots` writes a region's
`flags` entry last, after its spots, drift and counts, so a write cut short
leaves the region pending in either backend.  A single controller owns the
store; :class:`AsyncFovWriter` hands its writes to one thread.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

FLAG_EMPTY = 0
FLAG_RAW = 1
FLAG_CORRECTED = 2

BACKENDS = ("h5py", "npy")
_SPOT_COLS = 11
_ATTRS_FILE = "attrs.json"


def _h5py():
    try:
        import h5py
    except ImportError:
        return None
    return h5py


def store_backend(backend: Optional[str] = None,
                  path: Optional[str] = None) -> str:
    """The backend a store at `path` opens with: `backend` when given
    (``"h5py"`` raises ``ImportError`` where h5py is missing); else
    ``"npy"`` for an existing directory, else h5py when it imports, else
    ``"npy"``."""
    if backend is not None:
        if backend not in BACKENDS:
            raise ValueError(f"store backend must be one of {BACKENDS}, "
                             f"got {backend!r}")
        if backend == "h5py" and _h5py() is None:
            raise ImportError("the h5py store backend needs h5py, which "
                              "is not installed")
        return backend
    if path is not None and os.path.isdir(path):
        return "npy"
    return "h5py" if _h5py() is not None else "npy"


# -- the NumPy backend: the part of h5py's File/Group/Dataset API the store
#    uses, over a directory of .npy files --------------------------------


def _to_json(v):
    if isinstance(v, np.ndarray):
        return {"__ndarray__": v.tolist(), "dtype": v.dtype.str}
    if isinstance(v, np.generic):
        return v.item()
    return v


def _from_json(v):
    if isinstance(v, dict) and "__ndarray__" in v:
        return np.asarray(v["__ndarray__"], np.dtype(v["dtype"]))
    return v


class _NpyAttrs:
    """One node's attributes, kept in the file's JSON index."""

    def __init__(self, root: "_NpyFile", node: str):
        self._root, self._node = root, node

    def _get(self) -> Dict:
        with self._root._lock:
            return dict(self._root._index.get(self._node, {}))

    def __setitem__(self, key, value):
        with self._root._lock:
            self._root._check_writable()
            self._root._index.setdefault(self._node, {})[str(key)] = \
                _to_json(value)
            self._root._write_index()

    def __getitem__(self, key):
        return _from_json(self._get()[key])

    def __contains__(self, key):
        return key in self._get()

    def keys(self):
        return list(self._get())

    def items(self):
        return [(k, _from_json(v)) for k, v in self._get().items()]


class _NpyDataset:
    """A ``.npy`` file: reads copy out, row writes go through a writable
    memory map that is flushed before the call returns."""

    def __init__(self, root: "_NpyFile", node: str):
        self._root, self.name = root, "/" + node
        self._path = root._fs_path(node) + ".npy"
        self.attrs = _NpyAttrs(root, node)

    def _map(self, mode: str):
        return np.load(self._path, mmap_mode=mode, allow_pickle=False)

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._map("r").shape

    def __len__(self):
        return self.shape[0]

    def __getitem__(self, key):
        with self._root._lock:
            return np.array(self._map("r")[key])

    def __setitem__(self, key, value):
        with self._root._lock:
            self._root._check_writable()
            mm = self._map("r+")
            mm[key] = value
            mm.flush()
            del mm


class _NpyGroup:
    """A directory: datasets are ``<name>.npy`` files, groups are
    subdirectories."""

    def __init__(self, root: "_NpyFile", node: str):
        self._root, self._node = root, node
        self.name = "/" + node
        self.attrs = _NpyAttrs(root, node)

    def _child(self, name: str) -> str:
        return f"{self._node}/{name}" if self._node else name

    def keys(self) -> List[str]:
        base = self._root._fs_path(self._node)
        out = []
        for entry in os.listdir(base):
            full = os.path.join(base, entry)
            if os.path.isdir(full):
                out.append(entry)
            elif entry.endswith(".npy"):
                out.append(entry[:-4])
        return sorted(out)

    def __contains__(self, name) -> bool:
        full = self._root._fs_path(self._child(name))
        return os.path.isdir(full) or os.path.isfile(full + ".npy")

    def __getitem__(self, name):
        node = self._child(name)
        full = self._root._fs_path(node)
        if os.path.isdir(full):
            return _NpyGroup(self._root, node)
        if os.path.isfile(full + ".npy"):
            return _NpyDataset(self._root, node)
        raise KeyError(f"{name!r} not in {self.name}")

    def __delitem__(self, name):
        with self._root._lock:
            self._root._check_writable()
            node = self._child(name)
            full = self._root._fs_path(node)
            if os.path.isdir(full):
                shutil.rmtree(full)
            elif os.path.isfile(full + ".npy"):
                os.remove(full + ".npy")
            else:
                raise KeyError(f"{name!r} not in {self.name}")
            self._root._drop_attrs(node)

    def create_group(self, name: str) -> "_NpyGroup":
        with self._root._lock:
            self._root._check_writable()
            os.makedirs(self._root._fs_path(self._child(name)))
        return _NpyGroup(self._root, self._child(name))

    def require_group(self, name: str) -> "_NpyGroup":
        return self[name] if name in self else self.create_group(name)

    def create_dataset(self, name: str, shape=None, dtype=None, data=None,
                       fillvalue=None, **_h5py_only) -> _NpyDataset:
        """A new dataset from `data`, or of `shape` / `dtype` filled with
        `fillvalue` (0 when None, as h5py); chunking and compression
        arguments are h5py's and ignored here.  Written to a temporary
        file and renamed into place."""
        node = self._child(name)
        path = self._root._fs_path(node) + ".npy"
        tmp = path + ".tmp"
        with self._root._lock:
            self._root._check_writable()
            if os.path.exists(path):
                raise ValueError(f"dataset {name!r} exists in {self.name}")
            if data is not None:
                arr = np.asarray(data)
                if dtype is not None:
                    arr = arr.astype(dtype)
                with open(tmp, "wb") as fh:
                    np.save(fh, arr, allow_pickle=False)
            else:
                mm = np.lib.format.open_memmap(tmp, mode="w+",
                                               dtype=np.dtype(dtype),
                                               shape=tuple(shape))
                if fillvalue is not None and fillvalue != 0:
                    mm[...] = fillvalue
                mm.flush()
                del mm
            os.replace(tmp, path)
        return _NpyDataset(self._root, node)

    def copy(self, source: "_NpyGroup", name: str) -> None:
        """Clone the group `source` under `name` (files and attributes)."""
        with self._root._lock:
            self._root._check_writable()
            dst = self._child(name)
            shutil.copytree(self._root._fs_path(source._node),
                            self._root._fs_path(dst))
            src = source._node
            for node in list(self._root._index):
                if node == src or node.startswith(src + "/"):
                    self._root._index[dst + node[len(src):]] = dict(
                        self._root._index[node])
            self._root._write_index()


class _NpyFile(_NpyGroup):
    """The root directory of one FOV's NumPy store."""

    def __init__(self, path: str, mode: str = "a"):
        if mode not in ("r", "r+", "a", "w"):
            raise ValueError(f"invalid store mode {mode!r}")
        exists = os.path.isdir(path)
        if mode in ("r", "r+") and not exists:
            raise FileNotFoundError(f"no store at {path}")
        if mode == "w" and exists:
            shutil.rmtree(path)
            exists = False
        if not exists:
            os.makedirs(path)
        self._dir = path
        self._writable = mode != "r"
        self._lock = threading.RLock()
        index = os.path.join(path, _ATTRS_FILE)
        self._index: Dict[str, Dict] = {}
        if os.path.isfile(index):
            with open(index) as fh:
                self._index = json.load(fh)
        super().__init__(self, "")

    def _fs_path(self, node: str) -> str:
        return os.path.join(self._dir, *node.split("/")) if node \
            else self._dir

    def _check_writable(self):
        if not self._writable:
            raise OSError(f"store {self._dir} is open read-only")

    def _write_index(self):
        path = os.path.join(self._dir, _ATTRS_FILE)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self._index, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)

    def _drop_attrs(self, node: str):
        gone = [n for n in self._index
                if n == node or n.startswith(node + "/")]
        for n in gone:
            del self._index[n]
        if gone:
            self._write_index()

    def flush(self):
        """Every write is flushed as it is made."""

    def close(self):
        """Nothing stays open between calls."""


# -- the store ------------------------------------------------------------


class FovStore:
    """One field of view's persistent results.

    `backend`: ``None`` (an existing directory opens as ``"npy"``, else
    h5py when it imports, else ``"npy"``), ``"h5py"`` or ``"npy"``; the
    choice is kept in :attr:`backend`.
    """

    def __init__(self, path: str, mode: str = "a",
                 backend: Optional[str] = None):
        self.path = path
        self.backend = store_backend(backend, path)
        if self.backend == "h5py":
            self._fh = _h5py().File(path, mode)
        else:
            self._fh = _NpyFile(path, mode)

    # -- lifecycle -------------------------------------------------------

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def flush(self):
        self._fh.flush()

    # -- fov info --------------------------------------------------------

    def set_fov_info(self, **attrs):
        """Set root attributes; one already holding its value is not
        rewritten, so a resumed run leaves the file as it was."""
        for k, v in attrs.items():
            if k not in self._fh.attrs or not np.array_equal(
                    self._fh.attrs[k], v):
                self._fh.attrs[k] = v

    def get_fov_info(self) -> Dict:
        return dict(self._fh.attrs.items())

    # -- data-type groups ------------------------------------------------

    def init_data_type(self, data_type: str, region_ids: Sequence[int],
                       channels: Sequence[str], spot_capacity: int,
                       overwrite: bool = False):
        """Create (or open) a data_type group with per-region rows."""
        n = len(region_ids)
        if data_type in self._fh:
            if not overwrite:
                return
            del self._fh[data_type]
        g = self._fh.create_group(data_type)
        g.create_dataset("ids", data=np.asarray(region_ids, np.int32))
        g.create_dataset("channels", data=np.array(
            [str(c) for c in channels], dtype="S8"))
        g.create_dataset("flags", data=np.zeros(n, np.int32))
        g.create_dataset("drifts", data=np.zeros((n, 3), np.float32))
        # drift quality: 0 = crop consensus, 1 = fallback (suspicious) —
        # the reference's first-class drift outcome
        # (correction_tools/alignment.py:676-693)
        g.create_dataset("drift_flags", data=np.zeros(n, np.int32))
        for name in ("spots", "raw_spots"):
            g.create_dataset(name, shape=(n, spot_capacity, _SPOT_COLS),
                             dtype=np.float32, fillvalue=np.nan,
                             chunks=(1, spot_capacity, _SPOT_COLS))
        g.create_dataset("n_spots", data=np.zeros(n, np.int32))

    def data_types(self) -> List[str]:
        return [k for k in self._fh.keys()
                if k not in ("segmentation", "signal")]

    def ids(self, data_type: str) -> np.ndarray:
        """The data type's region ids, in row order."""
        return self._fh[data_type]["ids"][:]

    def drifts(self, data_type: str) -> np.ndarray:
        """The data type's stored (n, 3) drifts, in row order."""
        return self._fh[data_type]["drifts"][:]

    def region_index(self, data_type: str, region_id: int) -> int:
        idx = np.where(self.ids(data_type) == region_id)[0]
        if len(idx) == 0:
            raise KeyError(f"region {region_id} not in {data_type}")
        return int(idx[0])

    def transfer_data_type(self, data_type: str, target_type: str,
                           overwrite: bool = False) -> None:
        """Clone one data type's full group (ids/spots/flags/drifts/ims)
        under a new name — the store-side analog of the reference's
        attribute-renaming `_transfer_data_type` (classes/__init__.py:
        4329-4443, unique -> rna-unique), so downstream stages can
        re-pick/re-decode the copy without touching the original."""
        if data_type not in self._fh:
            raise KeyError(f"data type {data_type!r} not in store")
        if target_type in self._fh:
            if not overwrite:
                raise KeyError(f"target {target_type!r} exists; pass "
                               "overwrite=True to replace it")
            del self._fh[target_type]
        self._fh.copy(self._fh[data_type], target_type)

    # -- writes ----------------------------------------------------------

    def save_spots(self, data_type: str, region_id: int,
                   spots: np.ndarray, raw_spots: Optional[np.ndarray],
                   drift: np.ndarray, flag: int = FLAG_CORRECTED,
                   drift_flag: int = 0):
        """Write one region's row; its `flags` entry goes last, so a write
        cut short leaves the region pending."""
        g = self._fh[data_type]
        i = self.region_index(data_type, region_id)
        cap = g["spots"].shape[1]
        n = min(len(spots), cap)
        buf = np.full((cap, _SPOT_COLS), np.nan, np.float32)
        buf[:n] = np.asarray(spots[:n], np.float32)
        g["spots"][i] = buf
        if raw_spots is not None:
            rbuf = np.full((cap, _SPOT_COLS), np.nan, np.float32)
            rbuf[:n] = np.asarray(raw_spots[:n], np.float32)
            g["raw_spots"][i] = rbuf
        g["drifts"][i] = np.asarray(drift, np.float32)
        if "drift_flags" in g:
            g["drift_flags"][i] = drift_flag
        g["n_spots"][i] = n
        g["flags"][i] = flag

    # -- reads / resume --------------------------------------------------

    def flags(self, data_type: str) -> np.ndarray:
        return self._fh[data_type]["flags"][:]

    def set_flag(self, data_type: str, region_id: int, flag: int) -> None:
        """Set one region's flag (e.g. back to FLAG_EMPTY, to have the next
        run process it again)."""
        self._fh[data_type]["flags"][
            self.region_index(data_type, region_id)] = flag

    def drift_flags(self, data_type: str) -> np.ndarray:
        g = self._fh[data_type]
        if "drift_flags" in g:
            return g["drift_flags"][:]
        return np.zeros(len(g["ids"]), np.int32)

    def pending_regions(self, data_type: str,
                        required_flag: int = FLAG_CORRECTED) -> np.ndarray:
        """Region ids still needing processing (the resume check the
        reference does per-task, classes/field_of_view.py:1453-1522)."""
        mask = self.flags(data_type) < required_flag
        return self.ids(data_type)[mask]

    def load_spots(self, data_type: str, region_id: int
                   ) -> Tuple[np.ndarray, np.ndarray, int]:
        g = self._fh[data_type]
        i = self.region_index(data_type, region_id)
        n = int(g["n_spots"][i])
        return (g["spots"][i, :n], g["drifts"][i][:], int(g["flags"][i]))

    def load_all_spots(self, data_type: str) -> Dict[int, np.ndarray]:
        g = self._fh[data_type]
        n_spots, flags = g["n_spots"][:], self.flags(data_type)
        out = {}
        for i, rid in enumerate(self.ids(data_type)):
            if int(flags[i]) > FLAG_EMPTY:
                out[int(rid)] = g["spots"][i, :int(n_spots[i])]
        return out

    # -- corrected images (optional heavy payload) -------------------------

    def save_image(self, data_type: str, region_id: int,
                   im: np.ndarray) -> None:
        """Persist one region's corrected image stack (reference
        save_image_to_fov_file `ims` dataset,
        classes/batch_functions.py:305-368).  The dataset is created
        lazily on first save so spot-only runs pay nothing (gzip level 1
        in the h5py backend, uncompressed in the NumPy one)."""
        g = self._fh[data_type]
        i = self.region_index(data_type, region_id)
        if "ims" not in g:
            n = len(g["ids"])
            g.create_dataset("ims", shape=(n,) + im.shape,
                             dtype=np.uint16,
                             chunks=(1,) + im.shape,
                             compression="gzip", compression_opts=1)
        g["ims"][i] = np.clip(np.asarray(im), 0, 65535).astype(np.uint16)

    def load_image(self, data_type: str, region_id: int) -> np.ndarray:
        g = self._fh[data_type]
        if "ims" not in g:
            raise KeyError(f"no images saved for {data_type}")
        return g["ims"][self.region_index(data_type, region_id)]

    def has_image(self, data_type: str, region_id: int) -> bool:
        g = self._fh[data_type]
        return "ims" in g and bool(
            np.any(g["ims"][self.region_index(data_type, region_id)]))

    # -- signal group (chromosome coordinates etc.) ------------------------

    def save_signal(self, name: str, data: np.ndarray, **attrs) -> None:
        """`signal` group datasets (reference chrom_coords / intensity
        thresholds, classes/field_of_view.py:1184-1245)."""
        g = self._fh.require_group("signal")
        if name in g:
            del g[name]
        d = g.create_dataset(name, data=np.asarray(data))
        for k, v in attrs.items():
            d.attrs[k] = v

    def load_signal(self, name: str):
        if "signal" not in self._fh or name not in self._fh["signal"]:
            return None
        return self._fh["signal"][name][:]

    # -- segmentation ----------------------------------------------------

    def save_segmentation(self, label_im: np.ndarray, **attrs):
        if "segmentation" in self._fh:
            del self._fh["segmentation"]
        g = self._fh.create_group("segmentation")
        g.create_dataset("labels", data=np.asarray(label_im),
                         compression="gzip", compression_opts=1)
        for k, v in attrs.items():
            g.attrs[k] = v

    def load_segmentation(self) -> Optional[np.ndarray]:
        if "segmentation" not in self._fh:
            return None
        return self._fh["segmentation"]["labels"][:]


class AsyncFovWriter:
    """Background-thread checkpoint writer over a :class:`FovStore`.

    The single controller hands writes to one writer thread so the
    dispatch loop never blocks on storage (the reference serializes every
    worker's HDF5 access through one RLock, classes/field_of_view.py:
    1014-1020).  Only host data crosses to the thread: :meth:`submit`
    refuses tensors, so no CUDA call runs there; callers move results to
    the host first.  Main-thread reads of rows the writer is not touching
    are safe (h5py serializes its calls; the NumPy backend holds a lock
    around each); :meth:`barrier` gives read-after-write ordering when a
    row might still be queued.

    Write errors are captured and re-raised on the next submit /
    barrier / close — a checkpoint failure is never silent.
    """

    def __init__(self, store: FovStore, max_queue: int = 8):
        self._store = store
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fov-store-writer")
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                fn, args, kwargs = item
                if self._exc is None:       # fail-stop after first error
                    fn(*args, **kwargs)
            except BaseException as e:      # noqa: BLE001 — re-raised later
                self._exc = e
            finally:
                self._q.task_done()

    def _raise_pending(self):
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise RuntimeError("async checkpoint write failed") from exc

    def submit(self, fn, *args, **kwargs) -> None:
        """Enqueue `fn(*args, **kwargs)` on the writer thread."""
        self._raise_pending()
        if any(isinstance(a, torch.Tensor)
               for a in (*args, *kwargs.values())):
            raise TypeError("AsyncFovWriter takes host arrays only; move "
                            "tensors to NumPy before saving")
        self._q.put((fn, args, kwargs))

    # the write surface the driver uses, mirrored 1:1 onto the store
    def save_spots(self, *args, **kwargs) -> None:
        self.submit(self._store.save_spots, *args, **kwargs)

    def save_image(self, *args, **kwargs) -> None:
        self.submit(self._store.save_image, *args, **kwargs)

    def save_signal(self, *args, **kwargs) -> None:
        self.submit(self._store.save_signal, *args, **kwargs)

    def save_segmentation(self, *args, **kwargs) -> None:
        self.submit(self._store.save_segmentation, *args, **kwargs)

    def flush(self) -> None:
        self.submit(self._store.flush)

    def barrier(self) -> None:
        """Block until every queued write has executed."""
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        """Drain the queue and stop the writer thread (store stays open)."""
        self._q.join()
        self._q.put(None)
        self._thread.join()
        self._raise_pending()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
