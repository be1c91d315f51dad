"""Epochs x splits training schedule with deterministic resume and prefetch.

The shuffle of one (epoch, split) comes from `default_rng([seed, epoch,
split])`, so the batch stream is a pure function of the position: a
checkpoint needs only (epoch, split, batch) to resume exactly. Batches of a
split are assembled on a background thread (`cli/common.prefetch`), and
the next split's shards are warmed into the page cache while the current
one trains. A failure while assembling a batch (a bad shard) is re-raised
in the training loop; it never ends a split early.

Data parallel, as the JAX package feeds its devices: each host takes the
`order[host::hosts]` slice of the shuffled order and cuts it into local
batches of global_batch / hosts rows; of each local batch a rank takes the
rows its data index holds on its host (`rank_slice=(index, count)`): with
one microbatch the contiguous block `index`, with several the block
`index` of each microbatch (parallel/sharded.rank_rows). So an N-card run
on one host trains on the global batches of the JAX N-device run. Ranks
of one model group take the same rows.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Iterator

import numpy as np

from kotoba_whisper_tpu_torch.cli.common import prefetch
from kotoba_whisper_tpu_torch.data.shards import FeatureStore
from kotoba_whisper_tpu_torch.parallel.sharded import rank_rows

DATA_STATE_NAME = "data_state.json"


@dataclasses.dataclass(frozen=True)
class DataPosition:
    """Position of the NEXT batch to consume."""

    epoch: int = 0
    split: int = 0
    batch: int = 0

    def save(self, ckpt_dir: str) -> None:
        with open(os.path.join(ckpt_dir, DATA_STATE_NAME), "w") as f:
            json.dump(dataclasses.asdict(self), f)

    @staticmethod
    def load(ckpt_dir: str) -> "DataPosition | None":
        path = os.path.join(ckpt_dir, DATA_STATE_NAME)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return DataPosition(**json.load(f))


def split_order(seed: int, epoch: int, split: int, n: int,
                process_index: int = 0, process_count: int = 1) -> np.ndarray:
    """Deterministic shuffle for one (epoch, split), sliced for one host."""
    order = np.random.default_rng([seed, epoch, split]).permutation(n)
    if process_count > 1:
        order = order[process_index::process_count]
    return order


class ScheduleLoader:
    """Iterate epochs x splits from any DataPosition."""

    def __init__(self, split_dirs: list[str], *, seed: int, global_batch: int,
                 num_epochs: int, process_index: int = 0, process_count: int = 1,
                 rank_slice: tuple[int, int] = (0, 1), microbatches: int = 1,
                 prefetch: bool = True):
        if not split_dirs:
            raise ValueError("ScheduleLoader needs at least one split")
        if global_batch % process_count:
            raise ValueError(f"global batch {global_batch} does not split over "
                             f"{process_count} hosts")
        self.split_dirs = split_dirs
        self.seed = seed
        self.global_batch = global_batch
        self.local_batch = global_batch // process_count
        self.process_index, self.process_count = process_index, process_count
        # the rank's rows of every local batch
        self.rows = rank_rows(self.local_batch, *rank_slice, microbatches)
        self.num_epochs = num_epochs
        self.prefetch = prefetch
        self._stores: dict[int, FeatureStore] = {}
        self._sizes: dict[int, int] = {}
        self._lock = threading.Lock()

    def store(self, split: int) -> FeatureStore:
        with self._lock:
            s = self._stores.get(split)
            if s is None:
                s = FeatureStore(self.split_dirs[split])
                self._stores[split] = s
                # keep at most two splits open (current + prefetched next)
                for k in list(self._stores):
                    if k not in (split, split + 1):
                        self._stores.pop(k)
            return s

    def split_size(self, split: int) -> int:
        n = self._sizes.get(split)
        if n is None:
            n = self._sizes[split] = len(self.store(split))
        return n

    def batches_in_split(self, split: int) -> int:
        n_local = len(split_order(0, 0, 0, self.split_size(split), self.process_index,
                                  self.process_count))
        return n_local // self.local_batch

    def steps_per_epoch(self) -> int:
        return sum(self.batches_in_split(s) for s in range(len(self.split_dirs)))

    def _warm_next(self, split: int) -> None:
        if split + 1 < len(self.split_dirs):
            threading.Thread(target=lambda: self.store(split + 1).warm(), daemon=True).start()

    def _split_batches(self, epoch: int, split: int, start_batch: int
                       ) -> Iterator[tuple[DataPosition, list[dict], np.ndarray]]:
        store = self.store(split)
        order = split_order(self.seed, epoch, split, len(store), self.process_index,
                            self.process_count)
        n_batches = len(order) // self.local_batch

        def assemble(b: int):
            idx = order[b * self.local_batch:(b + 1) * self.local_batch][self.rows]
            rows = [store.rows[i] for i in idx]
            feats = store.gather(idx) if store.has_features else None
            return DataPosition(epoch, split, b), rows, feats

        items = (assemble(b) for b in range(start_batch, n_batches))
        return prefetch(items) if self.prefetch else items

    def batches(self, start: DataPosition = DataPosition()
                ) -> Iterator[tuple[DataPosition, list[dict], np.ndarray]]:
        """Yield (position, rows, features) from `start` to the end of the
        schedule. `position` names the yielded batch; the position to
        persist for resume is `next_position(position)`."""
        for epoch in range(start.epoch, self.num_epochs):
            split0 = start.split if epoch == start.epoch else 0
            for split in range(split0, len(self.split_dirs)):
                batch0 = start.batch if (epoch, split) == (start.epoch, start.split) else 0
                if self.prefetch:
                    self._warm_next(split)
                yield from self._split_batches(epoch, split, batch0)

    def next_position(self, pos: DataPosition) -> DataPosition:
        """The position right after `pos`, normalised across split and
        epoch boundaries."""
        b = pos.batch + 1
        if b < self.batches_in_split(pos.split):
            return DataPosition(pos.epoch, pos.split, b)
        if pos.split + 1 < len(self.split_dirs):
            return DataPosition(pos.epoch, pos.split + 1, 0)
        return DataPosition(pos.epoch + 1, 0, 0)
