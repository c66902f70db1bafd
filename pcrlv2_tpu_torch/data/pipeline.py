"""Host→device input pipeline of the 3D path (port of
``pcrlv2_tpu/data/pipeline.py``).

Augmentation runs on the device, so the host only reads raw crops
(``load_luna_sample``), batches them on a thread pool (``HostLoader``) and
keeps the next batches in flight while the device computes
(``device_prefetch``).  The native batch reader (``LunaBatchReader``) is
not ported yet (ROADMAP Queue A item 6); the NumPy reader is the path.
"""

from __future__ import annotations

import collections
import concurrent.futures
import os
import queue
import threading
from typing import Callable, Iterator, List, Sequence

import numpy as np
import torch


# ---------------------------------------------------------------------------
# sample reader and batching
# ---------------------------------------------------------------------------


def load_luna_sample(global_path: str, dtype=np.float32) -> dict:
    """One preprocessed crop pair and its local crops (``{uid}_global_{k}.npy``
    → (2, X, Y, Z); ``_local_`` → (V, x, y, z); reference
    ``lunaDataset.py:30-56``).  ``dtype=np.float16`` halves the bytes a batch
    moves to the device; the crops are [0, 1]-normalized, so f16 rounds by
    at most 2⁻¹¹ relative, and the augmentation widens to f32."""
    pair = np.load(global_path)
    local = np.load(global_path.replace("global", "local"))
    return {"pair": np.asarray(pair, dtype), "locals": np.asarray(local, dtype)}


class HostLoader:
    """Batches of ``read_fn(path)`` samples stacked along a new first axis:
    the paths shuffled per epoch by ``np.random.RandomState(seed + epoch)``
    (the JAX package's order), read ``2·num_workers`` samples ahead on a
    thread pool; with ``drop_last`` the ragged tail is left out."""

    def __init__(self, paths: Sequence[str], batch_size: int,
                 read_fn: Callable[[str], dict], *, shuffle: bool = True,
                 seed: int = 0, num_workers: int = 8, drop_last: bool = True):
        if not paths:
            raise ValueError("empty path list")
        self.paths = list(paths)
        self.batch_size = batch_size
        self.read_fn = read_fn
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.paths) // self.batch_size
        if not self.drop_last and len(self.paths) % self.batch_size:
            n += 1
        return n

    def epoch(self, epoch: int) -> Iterator[dict]:
        order = np.arange(len(self.paths))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        paths = [self.paths[i] for i in order]
        with concurrent.futures.ThreadPoolExecutor(self.num_workers) as pool:
            pending: collections.deque = collections.deque()
            ahead = self.num_workers * 2
            idx = 0
            for b in range(len(self)):
                chunk = paths[b * self.batch_size:(b + 1) * self.batch_size]
                while idx < len(paths) and len(pending) < ahead + len(chunk):
                    pending.append(pool.submit(self.read_fn, paths[idx]))
                    idx += 1
                samples = [pending.popleft().result() for _ in range(len(chunk))]
                yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}


# ---------------------------------------------------------------------------
# device prefetch
# ---------------------------------------------------------------------------


#: held by ``device_prefetch``'s worker while it pins, allocates and copies a
#: batch; whoever captures a CUDA graph holds it for the capture, so the
#: worker's CUDA calls never overlap one
CUDA_CALLS = threading.Lock()


def device_prefetch(batches: Iterator[dict], device,
                    buffer_size: int = 2) -> Iterator[dict]:
    """Yield each host batch (a dict of arrays) as tensors on ``device``,
    copied ahead of use (the role of the JAX package's ``device_prefetch``).

    On a CUDA device a worker thread draws the batches, copies each into
    pinned memory and on to the device on a side stream with
    ``non_blocking=True``, and keeps up to ``buffer_size`` of them in
    flight.  Before a batch is handed out, the consumer's current stream
    waits on the event recorded after its copy, and every tensor is
    ``record_stream``-ed to that stream, so the caching allocator cannot
    give its memory out again while the consumer may still read it.  An
    error in the worker is raised in the consumer.  The worker makes its
    CUDA calls holding ``CUDA_CALLS``.  On the CPU the batches pass through
    as tensors that share the arrays' memory."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in batches:
            yield {k: torch.as_tensor(v) for k, v in batch.items()}
        return

    stream = torch.cuda.Stream(device)
    slots: queue.Queue = queue.Queue(maxsize=buffer_size)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                slots.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        last = end
        try:
            with torch.cuda.device(device), torch.cuda.stream(stream):
                for batch in batches:
                    with CUDA_CALLS:
                        moved = {k: torch.as_tensor(v).pin_memory().to(device, non_blocking=True)
                                 for k, v in batch.items()}
                        ready = torch.cuda.Event()
                        ready.record(stream)
                    if not put((moved, ready)):
                        break
        except BaseException as err:  # noqa: BLE001 — raised in the consumer
            last = err
        finally:
            close = getattr(batches, "close", None)
            if close is not None:
                close()
            put(last)

    thread = threading.Thread(target=worker, name="device_prefetch", daemon=True)
    thread.start()
    try:
        while True:
            item = slots.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            moved, ready = item
            current = torch.cuda.current_stream(device)
            current.wait_event(ready)
            for t in moved.values():
                t.record_stream(current)
            yield moved
    finally:
        stop.set()
        thread.join()


# ---------------------------------------------------------------------------
# synthetic data (tests and runs without the LUNA16 download)
# ---------------------------------------------------------------------------


def synthetic_luna_batch(batch_size: int = 32, size=(64, 64, 32),
                         local=(16, 16, 16), n_views: int = 6, seed: int = 0):
    """A raw batch with the shapes ``luna_preprocess.py`` writes: pair
    (B, 2, 64, 64, 32), locals (B, 6, 16, 16, 16), values in [0, 1)."""
    rng = np.random.RandomState(seed)
    return {
        "pair": rng.rand(batch_size, 2, *size).astype(np.float32),
        "locals": rng.rand(batch_size, n_views, *local).astype(np.float32),
    }


def write_synthetic_luna_tree(root: str, n_subsets: int = 10,
                              uids_per_subset: int = 2, pairs_per_uid: int = 2,
                              seed: int = 0) -> List[str]:
    """A processed-LUNA tree of uniform noise in the layout
    ``luna_preprocess.py`` writes (``subset{i}/{uid}_global_{k}.npy``
    (2, 64, 64, 32), ``{uid}_local_{k}.npy`` (6, 16, 16, 16)); the same
    files as the JAX package's for the same arguments.  Returns the UIDs."""
    rng = np.random.RandomState(seed)
    uids = []
    for s in range(n_subsets):
        d = os.path.join(root, f"subset{s}")
        os.makedirs(d, exist_ok=True)
        for u in range(uids_per_subset):
            uid = f"1.2.{s}.{u}"
            uids.append(uid)
            for k in range(pairs_per_uid):
                np.save(os.path.join(d, f"{uid}_global_{k}.npy"),
                        rng.rand(2, 64, 64, 32).astype(np.float32))
                np.save(os.path.join(d, f"{uid}_local_{k}.npy"),
                        rng.rand(6, 16, 16, 16).astype(np.float32))
    return uids
