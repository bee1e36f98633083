"""Dataset factory + host-sharded batching loader (a copy of
dmvsnet_tpu.data.loader; the host count and id are plain arguments that
default to one host).

Samples are sharded across hosts round-robin (DistributedSampler
semantics), shuffled per epoch from a seeded permutation (``set_epoch``),
stacked into numpy batches, and prefetched on a background thread so host
IO overlaps device compute.  The epoch order for a given seed equals the
JAX package's.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


def get_dataset(name: str, datapath: str, scans: list[str], nviews: int,
                mode: str, **kwargs):
    """By-name factory over the dataset_name choices."""
    if name == "dtu_yao":
        from dmvsnet_tpu_torch.data.dtu import DTUTrainDataset

        return DTUTrainDataset(datapath, scans, nviews=nviews, mode=mode, **kwargs)
    if name == "blendedmvs":
        from dmvsnet_tpu_torch.data.blendedmvs import BlendedMVSDataset

        return BlendedMVSDataset(datapath, scans, nviews=nviews, mode=mode, **kwargs)
    if name == "general_eval":
        from dmvsnet_tpu_torch.data.general_eval import GeneralEvalDataset

        return GeneralEvalDataset(datapath, scans, nviews=nviews, **kwargs)
    raise ValueError(f"unknown dataset {name!r}")


def _stack(samples: list[dict]) -> dict:
    def stack_key(vals):
        if isinstance(vals[0], dict):
            return {k: stack_key([v[k] for v in vals]) for k in vals[0]}
        if isinstance(vals[0], str):
            return list(vals)
        return np.stack(vals)

    return {k: stack_key([s[k] for s in samples]) for k in samples[0]}


class Loader:
    """Epoch-aware, host-sharded, background-prefetching batch iterator."""

    def __init__(
        self, dataset, batch_size: int, shuffle: bool, seed: int = 0,
        drop_last: bool = True, num_hosts: int = 1, host_id: int = 0,
        prefetch: int = 2, workers: int = 4,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.prefetch = prefetch
        # sample-decode thread pool: PIL/cv2/numpy release the GIL during
        # decode, so threads overlap IO + decode without process overhead
        self.workers = max(1, workers)
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _host_indices(self) -> np.ndarray:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(self.seed + self.epoch).permutation(n)
        if self.num_hosts > 1:
            # pad by wrapping so every host yields the SAME number of
            # samples (torch DistributedSampler semantics: total_size =
            # ceil(n/world)*world): unequal counts would deadlock a
            # collective step
            total = -(-n // self.num_hosts) * self.num_hosts
            order = np.concatenate([order, order[: total - n]])
        # contiguous round-robin shard per host (DistributedSampler-like)
        return order[self.host_id :: self.num_hosts]

    def __len__(self) -> int:
        n = len(self._host_indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        idx = self._host_indices()
        if self.drop_last:
            idx = idx[: len(idx) // self.batch_size * self.batch_size]
        elif len(idx) % self.batch_size:
            # wrap-pad the ragged final batch to full size, so every batch
            # has one shape.  Same duplicate-sample semantics
            # DistributedSampler uses for host padding above; eval metrics
            # weight batch means equally either way.
            pad = self.batch_size - len(idx) % self.batch_size
            idx = np.resize(idx, len(idx) + pad)  # cyclic repeat
        batches = [
            idx[i : i + self.batch_size] for i in range(0, len(idx), self.batch_size)
        ]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def worker():
            try:
                if self.workers > 1 and self.batch_size > 1:
                    from concurrent.futures import ThreadPoolExecutor

                    with ThreadPoolExecutor(self.workers) as ex:
                        for b in batches:
                            q.put(_stack(list(
                                ex.map(lambda i: self.dataset[int(i)], b)
                            )))
                else:
                    for b in batches:
                        q.put(_stack([self.dataset[int(i)] for i in b]))
            except Exception as e:  # surface loader errors on the main thread
                q.put(e)
            finally:
                q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, Exception):
                raise item
            yield item


def make_loader(dataset, batch_size: int, mode: str, seed: int = 0, **kwargs) -> Loader:
    train = mode == "train"
    return Loader(
        dataset, batch_size, shuffle=train, seed=seed, drop_last=train, **kwargs
    )
