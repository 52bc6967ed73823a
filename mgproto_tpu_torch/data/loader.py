"""Prefetching batch loader with thread- and process-worker backends (the
port's copy of mgproto_tpu/data/loader.py; it yields numpy arrays, exactly
as the JAX package's loader does, and imports no torch).

Decode and host augmentation run on a worker pool overlapped with device
compute, and batches are pre-assembled into numpy arrays ready for the
trainer's `put_batch` (engine/train.py), which copies them to the card.

Two backends (`worker_backend`):
  * "thread" (default): a persistent ThreadPoolExecutor (created on first
    use, reused across epochs, torn down by close()). PIL decode releases
    the GIL, but the numpy-heavy augmentation math (colour jitter, affine)
    does not.
  * "process": a SPAWN-context multiprocessing.Pool, created lazily on
    first use and reused for the loader's lifetime. Spawn, not fork: the
    loader's first iteration typically happens after CUDA is live in the
    parent, and a forked child of a process with CUDA and its threads
    cannot use them safely; spawn children import a fresh interpreter and
    only this module's and the dataset's imports (no torch, no CUDA). The
    dataset is pickled ONCE into each worker (initializer), not per task.

Shared-memory batch assembly: by default the process backend does not
pickle image payloads back to the parent. A small PERSISTENT ring of
`multiprocessing.shared_memory` batch slabs ([B, H, W, C] in the sample
dtype — uint8 with the device-augment wire format, 4x fewer bytes than
f32) is written IN PLACE by chunked worker tasks (one per worker per
batch, so the pool's dispatch/result round trip amortizes over the row
range); only per-row (row, label, id) tuples cross IPC. The parent copies
each finished slab into the yielded batch, patches sentinel rows, and
returns the slab to the ring. The ring survives epochs so shared-page
faults are paid once, and is rebuilt only after an early-terminated epoch
(see _SlabRing) or a spec change; the per-sample pickle protocol remains
as the thread/sync path and the `use_shm=False` path. A sample whose
shape/dtype does not match the slab degrades to the pickle payload for
that row only. `loader_shm_slabs_in_use` gauges ring occupancy.

Self-healing: a failing sample load retries with exponential backoff +
deterministic jitter inside `_load_sample` (retries count into
`resilience_retries_total{scope="loader"}`); a sample that exhausts its
retries is SUBSTITUTED by a sentinel row (zero image, label -1 — counted in
`loader_sentinel_rows_total`, never fatal). A process worker that never
returns (OOM-kill, segfault) does not raise: the pool is RESTARTED once per
incident (`loader_worker_restarts_total`) and the lost sample is recovered
in-parent through the same deterministic `_load_sample` path — under shared
memory the recovered row is written into the slab in-parent — so the batch
content is identical to an incident-free run. The counters live in the
port's metric registry (serving/metrics.py); retries inside spawn workers
count into the worker's own registry, so the parent sees sentinel
substitutions and pool restarts but not worker-side retries.

Determinism: sample i of epoch e is transformed with a generator seeded by
(seed, epoch, sample index) — reproducible regardless of worker scheduling
OR backend (all call the same `_load_sample`). `with_seeds=True`
additionally ships a per-sample uint32 seed (`augment_seeds`, splitmix64
over the same identity) for the device augmentation tail (ops/augment.py).
tests/test_torch_data.py holds sync, thread and process batches, pickle and
shared memory, equal to each other and to the JAX package's loader.
"""

from __future__ import annotations

import multiprocessing
import multiprocessing.context
import os
import queue
import signal
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np

from mgproto_tpu_torch.serving import metrics as _m
from mgproto_tpu_torch.resilience.retry import backoff_delays

# per-sample retry budget: attempts = retries + 1, backoff base * 2^k with
# deterministic jitter (seeded by sample identity, so a run with failing
# loads is bit-reproducible)
_SAMPLE_RETRIES = 3
_RETRY_BASE_DELAY_S = 0.05
_RETRY_MAX_DELAY_S = 2.0

# IPC-safe markers compared by VALUE (a spawn worker's module object differs
# from the parent's, so `is` sentinels would not survive pickling)
_FAILED = "__mgproto_load_failed__"  # sample failed every attempt
_SHM_ROW = "__mgproto_shm_row__"  # sample image is in the shm slab row

# ring occupancy gauge
SHM_SLABS_GAUGE = _m.LOADER_SHM_SLABS

# finished host batches the feeder thread keeps ahead of the consumer (the
# device-side depth is `DataConfig.prefetch_depth`, in `device_prefetch`);
# the shared-memory ring holds two slabs more
_HOST_QUEUE_DEPTH = 2


def _count(name: str, amount: float = 1.0, **labels) -> None:
    _m.counter(name).inc(amount, **labels)


def _gauge(name: str, value: float) -> None:
    _m.gauge(name).set(value)


_SPLITMIX_MASK = np.uint64(0xFFFFFFFFFFFFFFFF)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer (uint64 in/out, wrapping)."""
    with np.errstate(over="ignore"):
        z = (x + np.uint64(0x9E3779B97F4A7C15)) & _SPLITMIX_MASK
        z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & _SPLITMIX_MASK
        z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & _SPLITMIX_MASK
        return z ^ (z >> np.uint64(31))


def augment_seeds(seed: int, epoch: int, indices: np.ndarray) -> np.ndarray:
    """Per-sample uint32 seeds for the device augmentation tail, derived
    from the SAME (seed, epoch, index) identity as the host RNG streams —
    deterministic across backends, worker scheduling and restarts. Pad
    (-1) rows get a seed too; their zero images make it inert."""
    idx = np.asarray(indices, np.int64).astype(np.uint64)
    with np.errstate(over="ignore"):
        h = _splitmix64(np.uint64(int(seed) & 0xFFFFFFFFFFFFFFFF)
                        + np.uint64(0xA076_1D64_78BD_642F))
        h = _splitmix64(h + np.uint64(int(epoch)))
        h = _splitmix64(h + idx)
    return (h >> np.uint64(32)).astype(np.uint32)


def _load_sample(dataset, seed: int, index: int, epoch: int,
                 retries: int = _SAMPLE_RETRIES):
    """The ONE sample-load path both backends share: deterministic per
    (seed, epoch, index), so backends are interchangeable mid-experiment.

    Retries transient load failures with backoff + seeded jitter; returns
    (`_FAILED`, index, repr(err)) after the budget is exhausted — the
    parent substitutes a sentinel row and counts it. The sample's dtype is
    PRESERVED (uint8 stays uint8: the wire format of the device-augment
    pipeline; classic transforms return f32 as before)."""
    if index < 0:  # sentinel pad row (sharded tail alignment)
        return None
    last_err = None
    delays = None  # built lazily: the happy path never pays the jitter rng
    for attempt in range(retries + 1):
        try:
            rng = np.random.default_rng([seed, epoch, int(index)])
            img, label, sid = dataset.load(int(index), rng)
            img = np.asarray(img)
            if img.dtype != np.uint8:
                img = img.astype(np.float32, copy=False)
            return img, label, sid
        except Exception as e:  # decode/IO errors; never KeyboardInterrupt
            last_err = e
            if attempt >= retries:
                break
            _count(_m.LOADER_RETRIES, scope="loader")
            if delays is None:
                delays = backoff_delays(
                    retries, _RETRY_BASE_DELAY_S, _RETRY_MAX_DELAY_S,
                    rng=np.random.default_rng(
                        [seed, epoch, int(index), 0xBACC0FF]
                    ),
                )
            time.sleep(next(delays))
    return (_FAILED, int(index), repr(last_err))


def _is_failed(r) -> bool:
    return (
        isinstance(r, tuple) and len(r) == 3
        and isinstance(r[0], str) and r[0] == _FAILED
    )


# per-worker state for process workers: the initializer receives the
# (pickled-once) dataset when the spawn child starts — never per task
_WORKER_STATE: dict = {}

# ceiling on one sample load (decode + augment is ms-scale; minutes means a
# dead/stuck worker) — Pool replaces a killed worker but never completes the
# lost task's AsyncResult, so an un-timed get() would hang training silently
_RESULT_TIMEOUT_S = 120.0


# A terminal's Ctrl-C, and a scheduler's SIGTERM to the process group, must
# reach the main process only, so it can finish its step and save a preempt
# checkpoint before it ends the pool. A worker leaves the group (a session of
# its own) in `_proc_worker_init`; from its fork until then these signals stay
# blocked: spawn children inherit the mask of the thread that starts them
# (`_ensure_pool`, and the pool's handler thread, which starts replacements).
_GROUP_SIGNALS = (signal.SIGINT, signal.SIGTERM)


def _proc_worker_init(dataset, seed: int) -> None:
    os.setsid()
    signal.signal(signal.SIGINT, signal.SIG_IGN)  # drops a pending Ctrl-C too
    # a SIGTERM that came while blocked was the group's: the pool ends its
    # workers with SIGKILL (_PoolWorker)
    signal.sigtimedwait([signal.SIGTERM], 0)
    signal.pthread_sigmask(signal.SIG_UNBLOCK, _GROUP_SIGNALS)
    _WORKER_STATE["dataset"] = dataset
    _WORKER_STATE["seed"] = seed


class _PoolWorker(multiprocessing.context.SpawnProcess):
    """A pool worker that `terminate` ends with SIGKILL. A worker that has
    started dies of it as of SIGTERM's default action; one still starting
    keeps SIGTERM blocked until its initializer (seconds to minutes on a
    busy host), where SIGKILL does not wait."""

    def terminate(self):
        self.kill()


class _PoolContext(multiprocessing.context.SpawnContext):
    Process = _PoolWorker


def _proc_load_one(args: Tuple[int, int]):
    index, epoch = args
    return _load_sample(
        _WORKER_STATE["dataset"], _WORKER_STATE["seed"], index, epoch
    )


def _worker_slab_view(name: str, shape, dtype) -> np.ndarray:
    """Attach (and cache) a parent-created shm slab inside a spawn worker.

    Lifetime note: spawn pool children inherit the PARENT's resource
    tracker, so the attach-time re-registration CPython performs
    (bpo-39959) is a set-level no-op there and the parent's one
    unlink+unregister at ring teardown stays authoritative — the worker
    must NOT unregister (that would strip the parent's registration from
    the shared tracker and leak the segment on a parent crash)."""
    cache = _WORKER_STATE.setdefault("slabs", {})
    shm = cache.get(name)
    if shm is None:
        from multiprocessing import shared_memory

        if len(cache) >= 32:  # stale rings from earlier epochs
            for old in cache.values():
                try:
                    old.close()
                except OSError:
                    pass
            cache.clear()
        shm = shared_memory.SharedMemory(name=name)
        cache[name] = shm
    return np.ndarray(shape, dtype=np.dtype(dtype), buffer=shm.buf)


def _proc_load_chunk_shm(args):
    """Load a CHUNK of samples, writing each image into its slab row; only
    per-row (marker, label, id) tuples return through IPC. Chunked, not
    per-sample: one pool task per worker per batch amortizes the pool's
    dispatch/result round-trip (ms-scale where syscalls are slow) over
    the whole row range — this is what makes the slab transport outrun the
    legacy per-sample pickle protocol even before the byte savings. A
    shape/dtype mismatch with the slab degrades to the pickle payload for
    that row only."""
    indices, rows, epoch, slab_name, shape, dtype = args
    out = []
    view = None
    for index, row in zip(indices, rows):
        r = _load_sample(
            _WORKER_STATE["dataset"], _WORKER_STATE["seed"], index, epoch
        )
        if r is None or _is_failed(r):
            out.append(r)
            continue
        img, label, sid = r
        if img.shape != tuple(shape[1:]) or img.dtype != np.dtype(dtype):
            out.append((img, label, sid))  # per-row pickle fallback
            continue
        if view is None:
            view = _worker_slab_view(slab_name, shape, dtype)
        view[row] = img
        out.append((_SHM_ROW, label, sid))
    return out


class _SlabRing:
    """A ring of shared-memory batch slabs, PERSISTENT across epochs.

    `acquire` blocks until a slab is free (bounded by the prefetch depth +
    in-flight batches, so the ring never grows); `release` returns it after
    the parent copied the batch out. Occupancy is gauged so telemetry shows
    whether the consumer (release side) or the workers (write side) gate.

    Persistence is load-bearing, not a nicety: segment names stay stable,
    so worker attachments — and the page mappings behind them — survive
    across epochs. The first write to each shared page pays a fault that
    some kernels (user-space kernels such as gVisor) make ~100x a hot write;
    recreating the ring per epoch re-paid that for every slab every epoch
    and measured SLOWER than pickle. The loader recreates the ring only
    after an epoch that ended early (abandoned in-flight writes could race
    a reused slab row) or a shape/dtype change."""

    def __init__(self, n_slabs: int, shape, dtype):
        from multiprocessing import shared_memory

        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        nbytes = max(1, int(np.prod(self.shape)) * self.dtype.itemsize)
        self._shms = [
            shared_memory.SharedMemory(create=True, size=nbytes)
            for _ in range(n_slabs)
        ]
        self._free: "queue.Queue[int]" = queue.Queue()
        for i in range(n_slabs):
            self._free.put(i)
        self.n_slabs = n_slabs

    def reset_free(self) -> None:
        """Return every slab to the free list (epoch boundary: a cleanly
        finished epoch has no in-flight writers)."""
        while True:
            try:
                self._free.get_nowait()
            except queue.Empty:
                break
        for i in range(self.n_slabs):
            self._free.put(i)
        _gauge(SHM_SLABS_GAUGE, 0)

    def acquire(self, stop: threading.Event) -> Optional[int]:
        while not stop.is_set():
            try:
                i = self._free.get(timeout=0.1)
                _gauge(SHM_SLABS_GAUGE, self.n_slabs - self._free.qsize())
                return i
            except queue.Empty:
                continue
        return None

    def release(self, i: int) -> None:
        self._free.put(i)
        _gauge(SHM_SLABS_GAUGE, self.n_slabs - self._free.qsize())

    def name(self, i: int) -> str:
        return self._shms[i].name

    def view(self, i: int) -> np.ndarray:
        return np.ndarray(self.shape, dtype=self.dtype, buffer=self._shms[i].buf)

    def destroy(self) -> None:
        for shm in self._shms:
            try:
                shm.close()
                shm.unlink()
            except OSError:
                pass
        self._shms = []
        _gauge(SHM_SLABS_GAUGE, 0)


class DataLoader:
    """Iterable over (images [B,H,W,3], labels [B] i32, ids [B] i64) — plus
    a [B] u32 augmentation-seed array when `with_seeds=True`. Images are
    f32 for the classic transforms, uint8 for the device-augment wire
    format (whatever the dataset's transform returns).

    Args:
      dataset: object with __len__ and load(index, rng) -> (img, label, id).
      batch_size: PER-PROCESS batch size (the global batch is
        batch_size * shard_count).
      shuffle: reshuffle each epoch (epoch advances on each __iter__).
      drop_last: drop the trailing partial GLOBAL batch (train: True so
        jitted shapes stay static; eval: False, the tail is padded with
        sentinel rows — zero image, label -1, id -1).
      num_workers: decode workers (0 = synchronous, backend ignored).
      worker_backend: "thread" (GIL-sharing pool; PIL decode overlaps) or
        "process" (spawn pool, dataset pickled once per worker;
        augmentation math scales past the GIL).
      seed: base seed for shuffle + augmentation streams.
      shard_index/shard_count: data sharding across processes. Every process
        computes the SAME global order (seeded identically), walks it in
        windows of batch_size*shard_count, and takes its own batch_size
        slice of each window — so the assembled global batch is a disjoint
        partition of the dataset, every process runs the SAME number of
        batches (equal-shape collectives), and shard_count=1 reproduces the
        single-process loader exactly.
      with_seeds: also yield per-sample uint32 seeds (`augment_seeds`) for
        the device augmentation tail.
      use_shm: shared-memory batch assembly for the process backend. None
        (auto) = ON for worker_backend="process"; ignored for thread/sync
        (no IPC to shortcut). Requires a probe-able sample shape; falls
        back to pickle per epoch when the probe fails, and per ROW when a
        sample's shape/dtype mismatches the slab.
      sample_spec: optional ((H, W, C), dtype) hint for slab allocation and
        sentinel rows — skips the probe load (and makes sentinel synthesis
        possible even when sample 0 itself is unreadable).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 8,
        worker_backend: str = "thread",
        seed: int = 0,
        shard_index: int = 0,
        shard_count: int = 1,
        with_seeds: bool = False,
        use_shm: Optional[bool] = None,
        sample_spec: Optional[tuple] = None,
    ):
        if not 0 <= shard_index < shard_count:
            raise ValueError(f"shard_index {shard_index} not in [0, {shard_count})")
        if worker_backend not in ("thread", "process"):
            raise ValueError(
                f"worker_backend must be 'thread' or 'process', "
                f"got {worker_backend!r}"
            )
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.worker_backend = worker_backend
        self.seed = seed
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.with_seeds = with_seeds
        self.use_shm = use_shm
        self.epoch = 0
        # (shape, dtype) of a sample image — for sentinel rows + shm slabs
        self._template = (
            (tuple(sample_spec[0]), np.dtype(sample_spec[1]))
            if sample_spec is not None else None
        )
        self._pool = None  # lazy persistent process pool (backend="process")
        self._pool_gen = 0  # bumped on every restart (stale-future detection)
        self._pool_lock = threading.Lock()
        self._thread_pool = None  # lazy persistent executor (backend="thread")
        self._ring = None  # persistent shm slab ring (see _SlabRing)
        self._ring_clean = True  # last epoch finished with no in-flight work

    def _ensure_pool(self):
        """The process pool, created on first use and reused across epochs
        (spawn startup pickles the dataset into each worker — pay it once,
        not per epoch). Pool workers are daemonic: they die with the parent,
        so an unclosed loader cannot outlive the process."""
        if self._pool is None:
            old = signal.pthread_sigmask(signal.SIG_BLOCK, _GROUP_SIGNALS)
            try:
                self._pool = _PoolContext().Pool(
                    self.num_workers,
                    initializer=_proc_worker_init,
                    initargs=(self.dataset, self.seed),
                )
            finally:
                signal.pthread_sigmask(signal.SIG_SETMASK, old)
        return self._pool

    def _end_pool(self) -> None:
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def _ensure_thread_pool(self) -> ThreadPoolExecutor:
        """The thread executor, persistent across epochs like the process
        pool (rebuilding it every __iter__ paid thread spawn/join per epoch
        for nothing); close() tears it down."""
        if self._thread_pool is None:
            self._thread_pool = ThreadPoolExecutor(
                max_workers=self.num_workers
            )
        return self._thread_pool

    def close(self) -> None:
        """Tear down the worker pools (process and/or thread) and the shm
        slab ring. Idempotent."""
        self._end_pool()
        if self._thread_pool is not None:
            self._thread_pool.shutdown(wait=True, cancel_futures=True)
            self._thread_pool = None
        if self._ring is not None:
            self._ring.destroy()
            self._ring = None

    def _restart_pool(self, gen: int) -> None:
        """Replace a wedged/dead process pool (self-healing path). `gen` is
        the generation the caller observed failing: if another thread
        already restarted past it, do nothing — one incident must trigger
        at most one restart, not one per in-flight batch."""
        with self._pool_lock:
            if self._pool_gen != gen:
                return
            self._end_pool()
            self._pool_gen += 1
            _count(_m.LOADER_WORKER_RESTARTS)
            self._ensure_pool()

    def __len__(self) -> int:
        n = len(self.dataset)
        span = self.batch_size * self.shard_count
        if self.drop_last:
            return n // span
        return (n + span - 1) // span

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng(
                [self.seed, self.epoch]
            ).permutation(n)
        return np.arange(n)

    def _load_one(self, index: int, epoch: int):
        return _load_sample(self.dataset, self.seed, index, epoch)

    def _probe_template(self, epoch: int) -> Optional[tuple]:
        """(shape, dtype) of a sample image, learned by loading sample 0
        through `_load_sample` — the retrying path, NOT a bare
        dataset.load (a rotted sample 0 used to crash the very machinery
        meant to substitute for it). Falls back to the configured
        sample_spec; None when neither is available."""
        if self._template is None:
            r = _load_sample(self.dataset, self.seed, 0, epoch)
            if r is not None and not _is_failed(r):
                self._template = (r[0].shape, r[0].dtype)
        return self._template

    def _sentinel_row(self):
        if self._template is None and self._probe_template(self.epoch) is None:
            raise RuntimeError(
                "cannot synthesize a sentinel row: sample 0 is unreadable "
                "and no sample_spec was configured"
            )
        shape, dtype = self._template
        return np.zeros(shape, dtype), -1, -1

    def _batches_of_indices(self, order: np.ndarray):
        n = len(order)
        b, p, s = self.batch_size, self.shard_index, self.shard_count
        span = b * s
        if self.drop_last:
            stop = (n // span) * span
        else:
            stop = ((n + span - 1) // span) * span
            order = np.concatenate(
                [order, np.full(stop - n, -1, order.dtype)]
            )
        for i in range(0, stop, span):
            yield order[i + p * b : i + (p + 1) * b]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        order = self._order()
        epoch = self.epoch
        self.epoch += 1

        def finish(imgs, labels, ids, idx_batch):
            out = (
                imgs,
                np.asarray(labels, np.int32),
                np.asarray(ids, np.int64),
            )
            if self.with_seeds:
                out = out + (augment_seeds(self.seed, epoch, idx_batch),)
            return out

        def assemble(results, idx_batch):
            failed = sum(1 for r in results if _is_failed(r))
            if failed:
                # exhausted-retry substitutions: counted, never fatal (one
                # rotted file must not kill a run)
                _count(_m.LOADER_SENTINEL_ROWS, failed)
            if self._template is None:
                for r in results:  # learn the sentinel spec from any real
                    if r is not None and not _is_failed(r):  # row (process
                        self._template = (r[0].shape, r[0].dtype)  # workers
                        break  # can't set parent state)
            results = [
                r if r is not None and not _is_failed(r)
                else self._sentinel_row()
                for r in results
            ]
            imgs = np.stack([r[0] for r in results])
            return finish(
                imgs, [r[1] for r in results], [r[2] for r in results],
                idx_batch,
            )

        def assemble_shm(results, idx_batch, ring, slab_id):
            """Slab -> batch: one memcpy of the whole slab, then patch the
            non-shm rows (sentinels, pads, per-row pickle fallbacks)."""
            imgs = np.array(ring.view(slab_id))  # copy before release
            ring.release(slab_id)
            labels = np.empty(len(results), np.int32)
            ids = np.empty(len(results), np.int64)
            failed = 0
            for row, r in enumerate(results):
                if r is None or _is_failed(r):
                    failed += _is_failed(r)
                    imgs[row] = 0
                    labels[row] = -1
                    ids[row] = -1
                elif isinstance(r[0], str) and r[0] == _SHM_ROW:
                    labels[row] = r[1]
                    ids[row] = r[2]
                else:  # pickle fallback row (shape/dtype mismatch)
                    img = np.asarray(r[0])
                    # mirror the worker's check: a dtype mismatch must not
                    # silently numpy-cast (f32 pixels into a u8 batch is
                    # garbage, not data) — zero the row like a bad shape
                    imgs[row] = (
                        img
                        if img.shape == imgs.shape[1:]
                        and img.dtype == imgs.dtype
                        else np.zeros(imgs.shape[1:], imgs.dtype)
                    )
                    labels[row] = r[1]
                    ids[row] = r[2]
            if failed:
                _count(_m.LOADER_SENTINEL_ROWS, failed)
            return finish(imgs, labels, ids, idx_batch)

        if self.num_workers <= 0:
            for idx_batch in self._batches_of_indices(order):
                yield assemble(
                    [self._load_one(i, epoch) for i in idx_batch], idx_batch
                )
            return

        # shared-memory assembly: process backend only (thread workers share
        # the parent's address space — nothing to shortcut)
        shm_active = (
            self.worker_backend == "process"
            and (self.use_shm is None or self.use_shm)
            and self._probe_template(epoch) is not None
        )
        ring = None
        if shm_active:
            shape, dtype = self._template
            slab_shape = (self.batch_size,) + tuple(shape)
            if self._ring is not None and (
                not self._ring_clean
                or self._ring.shape != slab_shape
                or self._ring.dtype != np.dtype(dtype)
            ):
                self._ring.destroy()
                self._ring = None
            if self._ring is None:
                self._ring = _SlabRing(
                    _HOST_QUEUE_DEPTH + 2, slab_shape, dtype
                )
            else:
                self._ring.reset_free()
            ring = self._ring
            self._ring_clean = False  # until this epoch finishes cleanly

        # pipelined: a feeder thread keeps `_HOST_QUEUE_DEPTH` batches in
        # flight; each batch's samples decode in parallel on the pool.
        # An early `break` by the consumer (GeneratorExit) must unblock the
        # feeder (stuck in put on the bounded queue) or the thread leaks.
        batch_q: "queue.Queue" = queue.Queue(maxsize=_HOST_QUEUE_DEPTH)
        sentinel = object()
        stop = threading.Event()

        if self.worker_backend == "process":
            self._ensure_pool()  # persistent across epochs

            def submit(i):
                # (handle, index, generation): the index makes a lost task
                # recoverable in-parent, the generation makes restart
                # decisions idempotent across in-flight batches
                with self._pool_lock:
                    p, gen = self._pool, self._pool_gen
                return p.apply_async(_proc_load_one, ((i, epoch),)), i, gen

            def submit_chunk(indices, rows, slab_id):
                with self._pool_lock:
                    p, gen = self._pool, self._pool_gen
                h = p.apply_async(_proc_load_chunk_shm, ((
                    [int(i) for i in indices], [int(r) for r in rows],
                    epoch, ring.name(slab_id), ring.shape, ring.dtype.str,
                ),))
                return h, indices, rows, gen, slab_id

            def _recover_row(index, slab_id, row):
                """In-parent reload of a sample a dead worker lost; under
                shm the recovered row lands in the slab exactly where the
                worker would have written it."""
                r = self._load_one(index, epoch)
                if (
                    r is not None and not _is_failed(r)
                    and r[0].shape == ring.shape[1:]
                    and r[0].dtype == ring.dtype
                ):
                    ring.view(slab_id)[row] = r[0]
                    return (_SHM_ROW, r[1], r[2])
                return r

            def result_of(item):
                handle, index, gen = item
                try:
                    return handle.get(timeout=_RESULT_TIMEOUT_S)
                except multiprocessing.TimeoutError:
                    # a worker died/hung: Pool will never complete this
                    # AsyncResult. Restart the pool (once per incident) and
                    # recover THIS sample in-parent via the same
                    # deterministic path — identical batch content, no
                    # RuntimeError (the seed behavior this replaces).
                    self._restart_pool(gen)
                    return self._load_one(index, epoch)

            def chunk_result_of(item):
                handle, indices, rows, gen, slab_id = item
                try:
                    return handle.get(timeout=_RESULT_TIMEOUT_S)
                except multiprocessing.TimeoutError:
                    # same self-healing contract as result_of, per chunk:
                    # restart once, then recover every lost row in-parent
                    self._restart_pool(gen)
                    return [
                        _recover_row(int(i), slab_id, int(r))
                        for i, r in zip(indices, rows)
                    ]
        else:
            pool = self._ensure_thread_pool()  # persistent across epochs

            def submit(i):
                return pool.submit(self._load_one, i, epoch), i, 0

            def result_of(item):
                return item[0].result()

        def put_or_stop(item) -> bool:
            while not stop.is_set():
                try:
                    batch_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def feeder():
            try:
                for idx_batch in self._batches_of_indices(order):
                    if ring is not None:
                        slab_id = ring.acquire(stop)
                        if slab_id is None:  # consumer gone
                            return
                        # one chunk task per worker: the pool round
                        # trip amortizes over the row range
                        rows = np.arange(len(idx_batch))
                        futures = [
                            submit_chunk(idx_batch[c], c, slab_id)
                            for c in np.array_split(
                                rows,
                                max(1, min(self.num_workers, len(rows))),
                            )
                            if len(c)
                        ]
                    else:
                        slab_id = None
                        futures = [submit(i) for i in idx_batch]
                    if not put_or_stop((futures, idx_batch, slab_id)):
                        if slab_id is not None:
                            ring.release(slab_id)
                        return
            finally:
                put_or_stop(sentinel)

        t = threading.Thread(target=feeder, daemon=True)
        t.start()
        try:
            while True:
                item = batch_q.get()
                if item is sentinel:
                    # clean finish: every submitted task was consumed,
                    # so the persistent ring may be reused hot next
                    # epoch (no in-flight writers left behind)
                    if ring is not None:
                        self._ring_clean = True
                    break
                futures, idx_batch, slab_id = item
                if slab_id is not None:
                    results = [None] * len(idx_batch)
                    for f in futures:  # (handle, indices, rows, ...)
                        for row, r in zip(f[2], chunk_result_of(f)):
                            results[int(row)] = r
                    yield assemble_shm(results, idx_batch, ring, slab_id)
                else:
                    yield assemble(
                        [result_of(f) for f in futures], idx_batch
                    )
        finally:
            stop.set()
            try:  # drain so the feeder's pending put unblocks
                while True:
                    item = batch_q.get_nowait()
                    if item is not sentinel and item[2] is not None:
                        ring.release(item[2])
            except queue.Empty:
                pass
            t.join(timeout=10)
        # worker pools and the shm ring persist across epochs (close()
        # tears them down); an early break marks the ring unclean so the
        # next epoch rebuilds it instead of racing abandoned in-flight
        # writes; abandoned tasks finish in the workers harmlessly


def device_prefetch(batches, put_fn, depth: int = 2):
    """Overlap host->device transfer with device compute.

    Pulls host batches from `batches`, immediately places each with
    `put_fn` (e.g. Trainer.put_batch — an asynchronous copy on a copy
    stream), and holds up to `depth` placed batches in flight before
    yielding the oldest. While the consumer's step N executes on device,
    batch N+1's H2D copy (and the host loader's decode/augment for N+2)
    proceed concurrently. depth=2 costs one extra batch of device memory
    (12 MB at batch 80 on the 224 px uint8 wire, 48 MB in f32).

    depth <= 0 DISABLES prefetch cleanly: each batch is placed with
    `put_fn` only when the consumer asks for it and yielded immediately —
    no queue, no batch ever held in flight.
    """
    import collections

    if depth <= 0:
        for batch in batches:
            yield put_fn(batch)
        return
    q = collections.deque()
    for batch in batches:
        q.append(put_fn(batch))
        if len(q) >= depth:
            yield q.popleft()
    while q:
        yield q.popleft()
