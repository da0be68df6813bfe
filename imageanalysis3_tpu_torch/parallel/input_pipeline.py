"""Multi-process input pipeline: per-rank .dax loading feeding the cards.

The counterpart of ``imageanalysis3_tpu/parallel/input_pipeline.py``.  The
reference feeds its pipeline with an mp.Pool of workers that each open,
read and de-interleave one hyb's .dax movie from shared storage
(classes/batch_functions.py:60-302; classes/field_of_view.py:1128-1142).
Here every rank of the process group reads only the FOV files whose batch
rows are its own, a background thread hides the read latency behind the
card's work, and the rows join one global ``DTensor`` sharded over the
mesh's data axis.

Pieces (each testable in one process by passing explicit `process_index`
/ `process_count`):

  * `shard_fovs` -- deterministic contiguous partition of the FOV list
    across ranks, balanced to +-1;
  * `FovPrefetcher` -- one reader thread filling a ring of reusable
    staging-buffer sets through ``io.native_loader.load_dax_channels``,
    with free-list backpressure and fail-stop error relay; with
    ``pin_memory`` the ring is page-locked host memory, allocated on the
    caller's thread (the reader thread makes no CUDA call);
  * `assemble_global_batch` -- local ``(B_local, ...)`` rows -> global
    ``(B, ...)`` DTensor sharded ``Shard(0)`` over the mesh;
  * `prefetch_to_device` -- upload of each item on a side stream, the
    staging buffer released once the copy has landed.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import (Callable, Iterable, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..device import resolve_device
from ..io.dax import read_inf
from ..io.native_loader import load_dax_channels
from .mesh import data_sharding, mesh_device


def shard_fovs(fov_names: Sequence[str],
               process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> List[str]:
    """This rank's contiguous slice of the FOV list.

    Contiguous (not strided) so each rank scans one disk region, and
    balanced to +-1: the first ``len % count`` ranks take one extra.  The
    defaults are the process group's rank and world size, or 0 and 1 when
    there is no group, so a single-process run needs no special casing.
    """
    grouped = dist.is_available() and dist.is_initialized()
    pi = process_index if process_index is not None else (
        dist.get_rank() if grouped else 0)
    pc = process_count if process_count is not None else (
        dist.get_world_size() if grouped else 1)
    if not 0 <= pi < pc:
        raise ValueError(f"process_index {pi} not in [0, {pc})")
    n = len(fov_names)
    base, extra = divmod(n, pc)
    start = pi * base + min(pi, extra)
    stop = start + base + (1 if pi < extra else 0)
    return list(fov_names[start:stop])


@dataclass
class PrefetchItem:
    """One prefetched FOV.  `array` is a staging buffer on loan: it is
    valid until `release()` -- which the iterator also calls when the next
    item is pulled, so plain ``for item in prefetcher`` loops are safe as
    long as each item is consumed (e.g. uploaded) before advancing.  Call
    `release()` early to unblock the reader sooner; it is idempotent.
    `staging` is the page-locked tensor `array` views, when the ring is
    pinned."""
    name: str
    array: np.ndarray
    staging: Optional[torch.Tensor] = field(default=None, repr=False)
    _release: Callable[[], None] = field(repr=False, default=lambda: None)
    _released: bool = field(default=False, repr=False)

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._release()


class FovPrefetcher:
    """Background reader for this rank's FOV shard.

    Yields :class:`PrefetchItem`s carrying ``(C, Z, X, Y)`` uint16 arrays
    in shard order.  One reader thread cycles `depth` staging-buffer sets,
    so steady-state reads allocate nothing; a free list of buffer sets
    applies backpressure -- the reader never overwrites a buffer before the
    item borrowing it is released.  Read errors are re-raised at the
    consumer's next pull, never swallowed.  With `pin_memory` the ring is
    page-locked (for a card's asynchronous upload), allocated on the
    iterating thread for the first file's frame shape; a file of another
    shape gets an ordinary ring, made by the reader.
    """

    _DONE = object()

    def __init__(self, paths: Sequence[str], channels: Sequence[str],
                 n_z: int, buffer_frames: int = 10,
                 empty_frames: int = 0, skip_frame0: bool = False,
                 depth: int = 2, pin_memory: bool = False):
        if depth < 2:
            raise ValueError("depth must be >= 2 (double buffering)")
        self._paths = list(paths)
        self._channels = [str(c) for c in channels]
        self._n_z = n_z
        self._buffer_frames = buffer_frames
        self._empty_frames = empty_frames
        self._skip_frame0 = skip_frame0
        self._depth = depth
        self._pin = pin_memory
        self._data_q: "queue.Queue" = queue.Queue()
        self._free_q: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None

    def _block_shape(self, frame_shape) -> Tuple[int, ...]:
        return (len(self._channels), self._n_z) + tuple(frame_shape)

    def _run(self, frame_shape) -> None:
        try:
            for path in self._paths:
                meta = read_inf(path)
                if meta.frame_shape != frame_shape:
                    # (re)build the ring; any still-borrowed old buffers
                    # stay alive with their items and are dropped on
                    # release (shape changes mid-experiment are rare)
                    frame_shape = meta.frame_shape
                    self._free_q = queue.Queue()
                    for _ in range(self._depth):
                        self._free_q.put((np.empty(
                            self._block_shape(frame_shape), np.uint16),
                            None))
                out, staging = self._free_q.get()   # backpressure point
                load_dax_channels(path, self._channels, self._channels,
                                  n_z=self._n_z,
                                  buffer_frames=self._buffer_frames,
                                  empty_frames=self._empty_frames,
                                  skip_frame0=self._skip_frame0,
                                  meta=meta, out=out)
                self._data_q.put((path, out, staging))
            self._data_q.put(self._DONE)
        except BaseException as e:          # noqa: BLE001 -- relayed
            self._data_q.put(e)

    def __iter__(self) -> Iterator[PrefetchItem]:
        if self._thread is not None:
            raise RuntimeError("FovPrefetcher is single-use")
        frame_shape = None
        if self._pin and self._paths:
            frame_shape = read_inf(self._paths[0]).frame_shape
            for _ in range(self._depth):
                t = torch.empty(self._block_shape(frame_shape),
                                dtype=torch.uint16, pin_memory=True)
                self._free_q.put((t.numpy(), t))
        self._thread = threading.Thread(target=self._run,
                                        args=(frame_shape,), daemon=True,
                                        name="fov-prefetcher")
        self._thread.start()
        prev: Optional[PrefetchItem] = None
        while True:
            item = self._data_q.get()
            if item is self._DONE:
                self._thread.join()
                return
            if isinstance(item, BaseException):
                self._thread.join()
                raise RuntimeError("prefetcher read failed") from item
            path, buf, staging = item
            free_q = self._free_q               # bind the current ring
            out = PrefetchItem(path, buf, staging,
                               _release=lambda b=(buf, staging), q=free_q:
                               q.put(b))
            if prev is not None:
                prev.release()
            prev = out
            yield out


def assemble_global_batch(local_batch, mesh: DeviceMesh,
                          axis: str = "data") -> DTensor:
    """Per-rank ``(B_local, ...)`` rows -> global ``(B, ...)`` DTensor
    sharded ``Shard(0)`` over the mesh.

    Each rank passes only the rows it loaded (its `shard_fovs` slice, in
    order); rows concatenate in rank order, which matches `shard_fovs`'s
    contiguous partition, so global row i is FOV i.  The row counts must
    be the layout ``Shard(0)`` implies (``torch.chunk``'s: equal counts
    when the batch divides over the ranks); a one-rank mesh is the
    degenerate case where local == global.
    """
    placements = data_sharding(mesh, axis)
    dev = mesh_device(mesh)
    if not isinstance(local_batch, torch.Tensor):
        local_batch = torch.from_numpy(np.ascontiguousarray(local_batch))
    local = local_batch.to(dev).contiguous()
    size = mesh.size()
    rows = [torch.zeros(1, dtype=torch.int64, device=dev)
            for _ in range(size)]
    dist.all_gather(rows, torch.tensor([local.shape[0]], device=dev),
                    group=mesh.get_group(axis))
    counts = [int(r) for r in rows]
    n = sum(counts)
    step = -(-n // size)
    layout = [max(0, min(step, n - i * step)) for i in range(size)]
    if counts != layout:
        raise ValueError(f"rows per rank {counts} are not the Shard(0) "
                         f"layout {layout} of {n} rows")
    shape = (n,) + tuple(local.shape[1:])
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def prefetch_to_device(items: Iterable[PrefetchItem], device=None
                       ) -> Iterator[Tuple[str, torch.Tensor]]:
    """Upload each prefetched FOV and release its staging buffer once the
    copy has landed.

    The consumer pattern ``for name, x in prefetch_to_device(pf): ...``
    overlaps three stages: the reader thread fills buffer k+1 while this
    generator uploads buffer k and the consumer's previously queued card
    work (k-1) runs -- provided the consumer does not wait on its own
    results inside the loop.  On a card the copy runs on a side stream
    (asynchronous from a pinned ring), an event fences it, the host waits
    for that event before the buffer goes back to the ring, and the
    consumer's stream waits for it too.  On the CPU the array is copied
    first, so the yielded tensor owns its memory.  `device` defaults to
    the CUDA card (raising without one).
    """
    dev = resolve_device(device)
    if dev.type != "cuda":
        for item in items:
            out = torch.from_numpy(item.array.copy()).to(dev)
            item.release()
            yield item.name, out
        return
    side = torch.cuda.Stream(device=dev)
    for item in items:
        src = (item.staging if item.staging is not None
               else torch.from_numpy(item.array))
        landed = torch.cuda.Event()
        with torch.cuda.stream(side):
            out = src.to(dev, non_blocking=True)
            landed.record(side)
        landed.synchronize()
        item.release()
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(landed)
        out.record_stream(consumer)
        yield item.name, out
