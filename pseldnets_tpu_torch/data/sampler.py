"""Batch samplers.

Parity: reference src/data/components/sampler.py — infinite shuffled sampler
yielding rank-strided slices of a (batch_size x world_size) global batch with
last-batch supplement; identical shuffles on every rank via the shared seed.
The rank and the number of replicas are the process group's
(parallel/mesh.py), else 0 and 1. A copy of the JAX package's data/sampler.py.
"""

import numpy as np

from .. import parallel


class DistributedBatchSampler:
    def __init__(self, clip_num, batch_size=1, seed=2023, data_indices=None,
                 shuffle=True, last_batch_supplement=True, rank=None,
                 num_replicas=None):
        self.rank = parallel.rank() if rank is None else rank
        self.num_replicas = parallel.world() if num_replicas is None else num_replicas
        self.clip_num = clip_num
        self.batch_size = batch_size * self.num_replicas

        self.indices = np.arange(clip_num) if data_indices is None \
            else np.asarray(data_indices)
        self.clip_num = len(self.indices)
        self.pointer = 0
        self.shuffle = shuffle
        if shuffle:
            self.random_state = np.random.RandomState(seed)
            self.random_state.shuffle(self.indices)
        if last_batch_supplement:
            padding = self.batch_size - self.clip_num % self.batch_size
            self.indices = np.append(self.indices, self.indices[:padding])
            self.clip_num += padding

    def __iter__(self):
        while True:
            if self.pointer >= self.clip_num:
                self.pointer = 0
                if self.shuffle:
                    self.random_state.shuffle(self.indices)
            # .copy(): a bare slice is a VIEW into self.indices, which the
            # epoch-wrap reshuffle above mutates in place — a consumer that
            # holds the batch past the epoch boundary would see it change
            yield self.indices[self.pointer + self.rank:
                               self.pointer + self.batch_size:
                               self.num_replicas].copy()
            self.pointer += self.batch_size

    def __len__(self):
        return int(np.ceil(self.clip_num / self.batch_size))
