"""Dataset of scenes + host-side async prefetch loader.

Parity: reference ``ScenesDataSet`` + trivial list collate
(code/datasets/ScenesDataSet.py:5-51) and its DataLoader usage with seeded
workers (code/multiple_scenes_learning.py:48-50, general_utils.py:298-303).

Host pipeline: a background thread pipelines the host-side sampling/
augmentation/graph-padding work with device compute (graph building is cheap
vectorized NumPy); a fork worker pool can take the sampling
(``num_workers``). Determinism comes from an explicit np.random.Generator
per loader.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional

import numpy as np

from gasfm.data.augmentation import apply_rotational_homography_aug
from gasfm.data.sampling import sample_data
from gasfm.data.scene import SceneData


def dataloader_collate_fn(samples: List[SceneData]) -> List[SceneData]:
    """Trivial collate: the batch is a list of SceneData (reference
    ScenesDataSet.py:5-10)."""
    return samples


def prefetch_iter(make_source, depth: int) -> Iterator:
    """Yield items of ``make_source()`` produced on one background thread
    through a bounded queue of ``depth``.

    Abandonment-safe: if the consumer breaks out of the loop (or an
    exception propagates through it, e.g. a device OOM mid-epoch) with the
    queue full, a bare ``q.put`` would block the producer thread forever,
    leaking it plus ``depth`` queued items (which may hold device-resident
    arrays). The stop-Event-gated put plus the finally-drain-join below
    releases it in every exit path. Producer exceptions re-raise in the
    consumer after the join. Shared by SceneLoader.__iter__ and
    train/loop._prepare_batches — keep the shutdown logic in this one place.
    """
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    errs: List[BaseException] = []
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in make_source():
                if not _put(item):
                    return
        except BaseException as e:  # noqa: BLE001 - propagate to consumer
            errs.append(e)
        finally:
            _put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
    finally:
        # Normal exhaustion AND early abandonment (GeneratorExit / exception
        # in the consumer) both land here: release the worker, drain
        # anything queued, and join. The join is BOUNDED: stop only
        # unblocks a producer stuck in _put — one stuck inside
        # make_source() itself (a slow scene, or a deadlocked fork worker,
        # see SceneLoader._get_pool) must not hold up propagation of the
        # consumer's original exception forever. The thread is a daemon, so
        # abandoning it after the timeout is safe at interpreter exit.
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=30.0)
        if t.is_alive():
            print(
                "[prefetch_iter] producer thread did not stop within 30s "
                "(stuck in the source iterator); abandoning it as a daemon."
            )
    if errs:
        raise errs[0]


class ScenesDataSet:
    """Parity: reference ScenesDataSet (ScenesDataSet.py:12-51)."""

    def __init__(
        self,
        data_list: List[SceneData],
        return_all: bool,
        min_num_views_sampled: int = 10,
        max_num_views_sampled: int = 30,
        inplane_rot_aug_max_angle: Optional[float] = None,
        tilt_rot_aug_max_angle: Optional[float] = None,
        rng: Optional[np.random.Generator] = None,
    ):
        self.data_list = data_list
        self.return_all = return_all
        self.min_num_views_sampled = min_num_views_sampled
        self.max_num_views_sampled = max_num_views_sampled
        self.inplane_rot_aug_max_angle = inplane_rot_aug_max_angle
        self.tilt_rot_aug_max_angle = tilt_rot_aug_max_angle
        self.rng = rng if rng is not None else np.random.default_rng()

    def __getitem__(self, item: int) -> SceneData:
        return self.get_with_rng(item, self.rng)

    def get_with_rng(self, item: int, rng: np.random.Generator) -> SceneData:
        """Sample/augment with an explicit generator — the worker-process
        path derives one per (epoch, index) so results are deterministic
        regardless of worker scheduling (the reference's seeded-worker
        analogue, general_utils.py:298-303)."""
        current = self.data_list[item]
        if not self.return_all:
            max_sample = min(self.max_num_views_sampled, current.num_views)
            if self.min_num_views_sampled >= max_sample:
                sample_fraction = max_sample
            else:
                sample_fraction = int(
                    rng.integers(self.min_num_views_sampled, max_sample + 1)
                )
            current = sample_data(current, sample_fraction, rng=rng)
        if self.inplane_rot_aug_max_angle is not None or self.tilt_rot_aug_max_angle is not None:
            current = apply_rotational_homography_aug(
                current,
                inplane_rot_aug_max_angle=self.inplane_rot_aug_max_angle,
                tilt_rot_aug_max_angle=self.tilt_rot_aug_max_angle,
                rng=rng,
            )
        return current

    def __len__(self) -> int:
        return len(self.data_list)


# -- worker-process pool -----------------------------------------------------
# The dataset is inherited by forked workers via this module-global (imap
# tasks ship only (index, seed), never the scene arrays).
_WORKER_DATASET: Optional[ScenesDataSet] = None


def _pool_init(dataset: ScenesDataSet) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _pool_get(task) -> SceneData:
    idx, seed = task
    return _WORKER_DATASET.get_with_rng(int(idx), np.random.default_rng(int(seed)))


class SceneLoader:
    """Batched iterator with optional single-thread prefetch.

    Yields lists of SceneData of length ``batch_size`` (last batch may be
    short), mirroring DataLoader(batch_size, shuffle) semantics.

    RNG streams: per-item seeds are drawn from the loader's ``rng`` in
    iteration order BEFORE dispatch (see :meth:`_batches`), and both the
    in-process and fork-pool paths derive each sample from
    ``default_rng(seed)`` — so a given loader seed produces the SAME
    sampling/augmentation stream for EVERY ``num_workers`` setting,
    independent of worker scheduling. (Stronger than the reference, whose
    per-worker generators make the stream depend on the worker count,
    code/datasets/ScenesDataSet.py + general_utils.py:298-303.)
    """

    def __init__(
        self,
        dataset: ScenesDataSet,
        batch_size: int = 1,
        shuffle: bool = False,
        prefetch: int = 2,
        rng: Optional[np.random.Generator] = None,
        num_workers: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.prefetch = prefetch
        self.rng = rng if rng is not None else np.random.default_rng()
        self.num_workers = num_workers
        self._pool = None

    def __len__(self) -> int:
        n = len(self.dataset)
        return (n + self.batch_size - 1) // self.batch_size

    def _get_pool(self):
        """Persistent fork pool (the reference's DataLoader worker-process
        analogue, multiple_scenes_learning.py:48-50 with
        dataset.dataloader_num_workers).

        CONSTRAINT: fork() after JAX initialization is only safe because the
        workers never touch JAX — they run pure NumPy on inherited arrays
        and ship results over pickle. Python 3.12 warns about forking a
        multi-threaded process; a worker that imported/used jax would
        deadlock. Keep _pool_get NumPy-only, or create loaders (and their
        first batch) before first JAX use. Call close() when training ends —
        __del__ is best-effort only."""
        if self._pool is None:
            import multiprocessing as mp

            ctx = mp.get_context("fork")
            self._pool = ctx.Pool(
                self.num_workers, initializer=_pool_init, initargs=(self.dataset,)
            )
        return self._pool

    def close(self) -> None:
        if self._pool is not None:
            self._pool.terminate()
            self._pool = None

    def __del__(self):  # best-effort worker cleanup
        try:
            self.close()
        except Exception:
            pass

    def _batches(self) -> Iterator[List[SceneData]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        # Per-item seeds drawn from the loader rng BEFORE dispatch. BOTH the
        # in-process and the worker-pool path derive each sample from
        # default_rng(seed), so a given loader seed produces the SAME
        # sampling/augmentation stream for every num_workers setting
        # (deterministic regardless of worker scheduling; pool tasks ship
        # only (index, seed)).
        seeds = self.rng.integers(0, 2**63 - 1, size=len(order))
        if self.num_workers > 0:
            pool = self._get_pool()
            it = pool.imap(_pool_get, list(zip(order.tolist(), seeds.tolist())),
                           chunksize=1)
            batch: List[SceneData] = []
            for sample in it:
                batch.append(sample)
                if len(batch) == self.batch_size:
                    yield dataloader_collate_fn(batch)
                    batch = []
            if batch:
                yield dataloader_collate_fn(batch)
            return
        for i in range(0, len(order), self.batch_size):
            yield dataloader_collate_fn([
                self.dataset.get_with_rng(int(j), np.random.default_rng(int(s)))
                for j, s in zip(order[i : i + self.batch_size],
                                seeds[i : i + self.batch_size])
            ])

    def __iter__(self) -> Iterator[List[SceneData]]:
        if self.prefetch <= 0:
            yield from self._batches()
            return
        yield from prefetch_iter(self._batches, self.prefetch)
