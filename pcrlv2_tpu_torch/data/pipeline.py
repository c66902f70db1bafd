"""Host→device input pipeline (port of ``pcrlv2_tpu/data/pipeline.py``).

Augmentation runs on the device, so the host only reads raw crops or images
and batches them (``HostLoader``: per sample on a thread pool —
``load_luna_sample``, or ``load_chest_sample`` / ``CachedChestReader`` for
chest X-rays — or, for LUNA, a batch at a time with ``LunaBatchReader``, the
native C++ reader of ``pcrlv2_tpu_torch/native.py``), and keeps the next
batches in flight while the device computes (``device_prefetch``).  3D
finetuning reads a segmentation mask beside each crop pair
(``make_luna_mask_reader``).
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

from pcrlv2_tpu_torch import native


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


def mask_path_for(global_path: str, mask_dir: str, data_root: str) -> str:
    """Where ``--mask_dir`` keeps the mask of a crop pair: the same path
    under ``mask_dir`` as under ``data_root``, ``_global_`` → ``_mask_`` in
    the file name (so ``mask_dir`` = ``data_root`` means masks beside the
    crops)."""
    rel = os.path.relpath(global_path, data_root)
    return os.path.join(mask_dir, rel.replace("_global_", "_mask_"))


def make_luna_mask_reader(data_root: str, mask_dir: str,
                          dtype=np.float32) -> Callable[[str], dict]:
    """``load_luna_sample`` plus ``mask``: the crop's segmentation mask from
    the ``--mask_dir`` tree (``mask_path_for``), (X, Y, Z, 1) float32.  A
    mask file holds (2, X, Y, Z), one mask per crop of the pair, of which
    crop 0's is taken, or (X, Y, Z).  A missing mask raises, naming the path
    it was looked for at."""

    def read(global_path: str) -> dict:
        sample = load_luna_sample(global_path, dtype)
        mpath = mask_path_for(global_path, mask_dir, data_root)
        try:
            mask = np.load(mpath)
        except FileNotFoundError:
            raise FileNotFoundError(
                f"--mask_dir: no mask for {global_path} (expected {mpath}; the mask "
                "tree must mirror the crop tree with _global_ → _mask_)") from None
        if mask.ndim == 4:
            mask = mask[0]
        sample["mask"] = np.asarray(mask, np.float32)[..., None]
        return sample

    return read


def load_chest_sample(image_path: str, canvas: int = 512) -> dict:
    """A chest X-ray decoded to grey (PIL ``convert('L')``, whatever the
    container: NIH mixes L and RGBA PNGs), bilinearly resized to
    ``canvas``² unless it is that size, as uint8 (H, W, 1): the device
    divides by 255 and broadcasts to RGB (reference ``chestDataset.py:33``
    decodes with PIL too).  Pillow is imported here, and only here and in
    the CLI's canvas detection."""
    try:
        from PIL import Image
    except ImportError as err:
        raise ImportError("decoding chest X-rays needs Pillow (PIL), which is not "
                          "installed; a CachedChestReader cache written elsewhere "
                          "is read without it") from err
    with Image.open(image_path) as im:
        im = im.convert("L")
        if im.size != (canvas, canvas):
            im = im.resize((canvas, canvas), Image.BILINEAR)
        arr = np.asarray(im, np.uint8)
    return {"image": arr[..., None]}


class CachedChestReader:
    """``load_chest_sample`` once per image: the first read decodes and writes
    the uint8 array to ``<cache>/<name>.<hash>.c<canvas>.npy`` (tmp +
    rename); every later read is an ``np.load`` (the reference re-decodes
    every PNG every epoch).  The hash is of the source's absolute path, so
    two ``img.png`` in different directories do not meet; an entry of
    another shape (an older layout) or a torn one is decoded again.
    ``decoded`` and ``cached`` count the reads of each kind (the loader's
    threads count under a lock)."""

    def __init__(self, cache_dir: str, canvas: int):
        self.cache_dir = cache_dir
        self.canvas = canvas
        self.decoded = 0
        self.cached = 0
        self._count = threading.Lock()
        os.makedirs(cache_dir, exist_ok=True)

    def cache_path(self, image_path: str) -> str:
        import hashlib

        base = os.path.splitext(os.path.basename(image_path))[0]
        tag = hashlib.blake2s(os.path.abspath(image_path).encode(), digest_size=4).hexdigest()
        return os.path.join(self.cache_dir, f"{base}.{tag}.c{self.canvas}.npy")

    def __call__(self, image_path: str) -> dict:
        cpath = self.cache_path(image_path)
        try:
            arr = np.load(cpath)
            if arr.shape == (self.canvas, self.canvas, 1):
                with self._count:
                    self.cached += 1
                return {"image": arr}
        except (FileNotFoundError, ValueError, EOFError):
            pass
        sample = load_chest_sample(image_path, canvas=self.canvas)
        with self._count:
            self.decoded += 1
        tmp = f"{cpath}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "wb") as f:  # a handle: np.save(str) appends ".npy"
                np.save(f, sample["image"])
            os.replace(tmp, cpath)
        except OSError:  # a read-only or full cache directory: decode each time
            if os.path.exists(tmp):
                os.unlink(tmp)
        return sample


class LunaBatchReader:
    """Whole batches of ``_global_`` / ``_local_`` crop files read by the
    native thread pool (``native.read_batch``) into two float32 buffers
    allocated once; a non-f32 ``dtype`` converts on the way out.  Without
    the native library ``read_batch`` falls back to NumPy; ``batches``
    counts the batches the native library served."""

    def __init__(self, batch_size: int, pair_shape=(2, 64, 64, 32),
                 local_shape=(6, 16, 16, 16), n_threads: int = 8, dtype=np.float32):
        self.n_threads = n_threads
        self.dtype = np.dtype(dtype)
        self._pair = np.empty((batch_size, *pair_shape), np.float32)
        self._local = np.empty((batch_size, *local_shape), np.float32)
        self.batches = 0

    def __call__(self, global_paths: Sequence[str]) -> dict:
        n = len(global_paths)
        local_paths = [p.replace("global", "local") for p in global_paths]
        native.read_batch(global_paths, self._pair[:n], self.n_threads)
        native.read_batch(local_paths, self._local[:n], self.n_threads)
        if native.available():
            self.batches += 1
        # astype copies: the buffers are reused for the next batch while the
        # consumer still holds this one
        return {"pair": self._pair[:n].astype(self.dtype, copy=True),
                "locals": self._local[:n].astype(self.dtype, copy=True)}


class HostLoader:
    """Batches of ``read_fn(path)`` samples stacked along a new first axis:
    the paths shuffled per epoch by ``np.random.RandomState(seed + epoch)``
    (the JAX package's order), read ``2·num_workers`` samples ahead on a
    thread pool; with ``drop_last`` the ragged tail is left out.  With
    ``batch_read_fn`` (a ``LunaBatchReader``) each batch's paths are read
    in one call instead, one batch ahead of the consumer."""

    def __init__(self, paths: Sequence[str], batch_size: int,
                 read_fn: Callable[[str], dict], *, shuffle: bool = True,
                 seed: int = 0, num_workers: int = 8, drop_last: bool = True,
                 batch_read_fn: Callable[[Sequence[str]], dict] | None = None):
        if not paths:
            raise ValueError("empty path list")
        self.paths = list(paths)
        self.batch_size = batch_size
        self.read_fn = read_fn
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.batch_read_fn = batch_read_fn

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
        if self.batch_read_fn is not None:
            yield from self._epoch_batched(paths)
            return
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

    def _epoch_batched(self, paths: List[str]) -> Iterator[dict]:
        chunks = [paths[b * self.batch_size:(b + 1) * self.batch_size]
                  for b in range(len(self))]
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            fut = pool.submit(self.batch_read_fn, chunks[0]) if chunks else None
            for b in range(len(chunks)):
                batch = fut.result()
                if b + 1 < len(chunks):
                    fut = pool.submit(self.batch_read_fn, chunks[b + 1])
                yield batch


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


def synthetic_chest_batch(batch_size: int = 64, canvas: int = 512, seed: int = 0):
    """A raw chest batch: ``image`` (B, canvas, canvas, 3) float32 in [0, 1)
    (the JAX package's ``synthetic_chest_batch``, bit for bit)."""
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(batch_size, canvas, canvas, 3).astype(np.float32)}


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


def _structured_phantom(rng: np.random.RandomState, shape=(80, 80, 48)):
    """One blob/stripe phantom volume and its blob mask, values in [0, 1]:
    a smooth low-frequency background around 0.15; 2-5 Gaussian blobs
    (σ ∈ [3, 7], amplitude ∈ [0.5, 0.8]), the mask being where their sum
    exceeds 0.25; 1-2 bright axis-aligned slabs at blob intensity, not in
    the mask, so that a threshold on intensity cannot segment the blobs."""
    X, Y, Z = shape
    coarse = rng.rand(X // 8, Y // 8, Z // 8).astype(np.float32)
    bg = 0.1 + 0.1 * np.repeat(np.repeat(np.repeat(coarse, 8, 0), 8, 1), 8, 2)
    xs, ys, zs = np.meshgrid(np.arange(X), np.arange(Y), np.arange(Z), indexing="ij")
    blob_field = np.zeros(shape, np.float32)
    for _ in range(rng.randint(2, 6)):
        cx, cy, cz = (rng.uniform(8, X - 8), rng.uniform(8, Y - 8), rng.uniform(6, Z - 6))
        sigma = rng.uniform(3.0, 7.0)
        amp = rng.uniform(0.5, 0.8)
        d2 = (xs - cx) ** 2 + (ys - cy) ** 2 + (zs - cz) ** 2
        blob_field += amp * np.exp(-d2 / (2 * sigma * sigma)).astype(np.float32)
    mask = (blob_field > 0.25).astype(np.float32)
    vol = bg + blob_field
    for _ in range(rng.randint(1, 3)):
        axis = rng.randint(0, 3)
        pos = rng.randint(4, shape[axis] - 4)
        thick = rng.randint(2, 4)
        sl = [slice(None)] * 3
        sl[axis] = slice(pos, pos + thick)
        vol[tuple(sl)] += rng.uniform(0.5, 0.8)
    return np.clip(vol, 0.0, 1.0).astype(np.float32), mask


def write_structured_luna_tree(root: str, n_subsets: int = 10, uids_per_subset: int = 2,
                               pairs_per_uid: int = 2, seed: int = 0, size=(64, 64, 32),
                               local=(16, 16, 16), n_views: int = 6) -> List[str]:
    """A processed-LUNA tree of structured phantoms (``_structured_phantom``)
    with their masks: ``subset{i}/{uid}_global_{k}.npy`` (2, 64, 64, 32),
    two overlapping crops of one phantom; ``{uid}_local_{k}.npy``
    (6, 16, 16, 16), crops of the first; ``{uid}_mask_{k}.npy``, the blob
    mask of each global crop.  A learnable synthetic task: a run's eval loss
    falls.  The same files as the JAX package's for the same arguments.
    Returns the UIDs."""
    rng = np.random.RandomState(seed)
    uids = []
    for s in range(n_subsets):
        d = os.path.join(root, f"subset{s}")
        os.makedirs(d, exist_ok=True)
        for u in range(uids_per_subset):
            uid = f"1.2.{s}.{u}"
            uids.append(uid)
            for k in range(pairs_per_uid):
                vol, mask = _structured_phantom(rng)
                # two overlapping crops of one phantom (the pretask pair)
                crops, mcrops = [], []
                base = [rng.randint(0, vol.shape[i] - size[i] - 8) for i in range(3)]
                for _ in range(2):
                    off = [min(b + rng.randint(0, 9), vol.shape[i] - size[i])
                           for i, b in enumerate(base)]
                    sl = tuple(slice(o, o + size[i]) for i, o in enumerate(off))
                    crops.append(vol[sl])
                    mcrops.append(mask[sl])
                np.save(os.path.join(d, f"{uid}_global_{k}.npy"), np.stack(crops))
                np.save(os.path.join(d, f"{uid}_mask_{k}.npy"), np.stack(mcrops))
                locs = []
                for _ in range(n_views):
                    off = [rng.randint(0, size[i] - local[i]) for i in range(3)]
                    sl = tuple(slice(o, o + local[i]) for i, o in enumerate(off))
                    locs.append(crops[0][sl])
                np.save(os.path.join(d, f"{uid}_local_{k}.npy"), np.stack(locs))
    return uids
