"""Batch iteration, including the device-feed path (counterpart of
``ray_tpu/data/iterator.py``).

`iter_torch_batches` is the reference's device feed (reference:
python/ray/data/iterator.py iter_torch_batches, block_batching/) with the
JAX package's two overlap layers (its ``iter_jax_batches``): batches are
prepared on a background thread in pinned host memory and copied to the
card on a side stream, so the host->device transfer overlaps the training
step."""

from __future__ import annotations

import collections
import queue
import threading
from typing import Dict, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import block as block_lib


def _batches_of(bundles, batch_size: Optional[int], batch_format: str,
                drop_last: bool):
    """Re-chunk a stream of blocks into exact-size batches."""
    buffer = []
    buffered_rows = 0
    for ref, meta in bundles:
        block = ray_tpu_torch.get(ref)
        if block.num_rows == 0:
            continue
        if batch_size is None:
            yield block_lib.block_to_batch(block, batch_format)
            continue
        buffer.append(block)
        buffered_rows += block.num_rows
        while buffered_rows >= batch_size:
            merged = block_lib.concat_blocks(buffer)
            out = block_lib.slice_block(merged, 0, batch_size)
            rest = block_lib.slice_block(merged, batch_size,
                                         merged.num_rows)
            yield block_lib.block_to_batch(out, batch_format)
            buffer = [rest] if rest.num_rows else []
            buffered_rows = rest.num_rows
    if buffer and not drop_last and batch_size is not None:
        merged = block_lib.concat_blocks(buffer)
        if merged.num_rows:
            yield block_lib.block_to_batch(merged, batch_format)


def iter_batches(bundles, *, batch_size: Optional[int], batch_format: str,
                 drop_last: bool = False):
    yield from _batches_of(bundles, batch_size, batch_format, drop_last)


def _numpy_dtype(torch_dtype):
    import torch
    return torch.empty((), dtype=torch_dtype).numpy().dtype


def iter_torch_batches(bundles, *, batch_size: int, device="cuda",
                       dtypes=None, drop_last: bool = True,
                       prefetch: int = 2, device_prefetch: int = 2,
                       mesh=None, sharding=None):
    """Yields dict-of-tensor batches on ``device`` (default the card; a
    card that is missing raises, there is no CPU fallback). ``dtypes`` is
    one torch dtype for every column or a dict of column -> dtype. With
    ``mesh``, each batch is a DTensor laid out by ``sharding`` (a
    placements tuple for that mesh), or by the port's
    ``parallel.sharding.batch_sharding`` over the mesh's data axes.

    Two overlap layers feed the card:
    - a prefetch thread does the host work (block fetch, re-chunking,
      dtype casts) into pinned host memory;
    - a depth-``device_prefetch`` queue of batches already copied, each
      copy ``non_blocking`` on a side stream, so the transfer runs while
      the step consumes the previous batch. The consumer's stream waits
      on the copy's event before it reads a batch, and a batch's pinned
      host buffer lives until that event has completed."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"iter_torch_batches(device={device!r}): no CUDA device is "
            "available (pass device='cpu' for host batches)")
    if sharding is not None and mesh is None:
        raise ValueError("sharding= names placements of a mesh: pass mesh=")
    if mesh is not None and sharding is None:
        from ray_tpu_torch.parallel.sharding import batch_sharding
        sharding = batch_sharding(mesh, with_seq=False)
    return _torch_batches(bundles, batch_size, dev, dtypes, drop_last,
                          prefetch, device_prefetch, mesh, sharding)


def _torch_batches(bundles, batch_size, dev, dtypes, drop_last, prefetch,
                   device_prefetch, mesh, sharding):
    import torch

    on_card = dev.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
    SENTINEL = object()
    err: list = []
    stop = threading.Event()

    def cast(name, arr):
        want = dtypes.get(name) if isinstance(dtypes, dict) else dtypes
        return arr if want is None else arr.astype(_numpy_dtype(want),
                                                   copy=False)

    def host(arr):
        if not on_card:
            return block_lib.dense_to_torch({"x": arr})["x"]
        t = torch.empty(arr.shape,
                        dtype=torch.from_numpy(np.empty(0, arr.dtype)).dtype,
                        pin_memory=True)
        t.numpy()[...] = arr
        return t

    def producer():
        try:
            for table in _batches_of(bundles, batch_size, "pyarrow",
                                     drop_last):
                batch = {k: host(cast(k, v)) for k, v in
                         block_lib.block_to_dense(table).items()}
                while not stop.is_set():
                    try:
                        q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        pass
                if stop.is_set():
                    return
        except BaseException as e:      # surfaced to the consumer
            err.append(e)
        finally:
            while not stop.is_set():
                try:
                    q.put(SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    pass

    t = threading.Thread(target=producer, daemon=True,
                         name="iter_torch_batches")
    t.start()

    copy_stream = torch.cuda.Stream(dev) if on_card else None
    in_flight = collections.deque()     # (event, pinned host batch)

    def to_device(item):
        if not on_card:
            return item, None
        with torch.cuda.stream(copy_stream):
            out = {k: v.to(dev, non_blocking=True) for k, v in item.items()}
            ev = torch.cuda.Event()
            ev.record(copy_stream)
        in_flight.append((ev, item))
        return out, ev

    def hand_out(out, ev):
        if ev is not None:
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(ev)
            for v in out.values():
                # allocated on the copy stream, read on the consumer's
                v.record_stream(stream)
        # a pinned buffer is dropped only once its copy has completed
        while in_flight and in_flight[0][0].query():
            in_flight.popleft()
        if mesh is not None:
            from torch.distributed.tensor import distribute_tensor
            out = {k: distribute_tensor(v, mesh, sharding)
                   for k, v in out.items()}
        return out

    pending = collections.deque()
    depth = max(1, device_prefetch)
    try:
        while True:
            item = q.get()
            if item is SENTINEL:
                break
            pending.append(to_device(item))
            if len(pending) >= depth:
                yield hand_out(*pending.popleft())
        while pending:
            yield hand_out(*pending.popleft())
        if err:
            raise err[0]
    finally:
        stop.set()
        for ev, _ in in_flight:
            ev.synchronize()
        in_flight.clear()
