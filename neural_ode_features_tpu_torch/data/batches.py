"""Host-side batching: in-memory epochs of raw uint8 batches (port of
``neural_ode_features_tpu/data/batches.py``, the same shuffle).

Both datasets fit in host memory, so the pipeline is a shuffled slicer with
no worker processes.  Batches stay raw uint8 numpy arrays; the trainer moves
them to the device, where all float work happens (ops/preprocess.py).
"""

from __future__ import annotations

import numpy as np

__all__ = ["Batches"]


class Batches:
    """Iterate `(images uint8, labels int32)` batches.

    * ``shuffle=True``: new permutation every epoch, deterministic in
      ``seed`` and epoch index.
    * ``drop_remainder=True`` keeps shapes static across steps (one XLA
      compilation); the tail is dropped for training and padded for eval via
      :meth:`padded_batches`.
    """

    def __init__(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = True,
    ):
        assert len(images) == len(labels)
        self.images = images
        self.labels = labels.astype(np.int32)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.epoch = 0

    def __len__(self):
        n = len(self.images)
        return n // self.batch_size if self.drop_remainder else -(-n // self.batch_size)

    def __iter__(self):
        n = len(self.images)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            rng.shuffle(idx)
        self.epoch += 1
        stop = (n // self.batch_size) * self.batch_size if self.drop_remainder else n
        for lo in range(0, stop, self.batch_size):
            sel = idx[lo : lo + self.batch_size]
            yield self.images[sel], self.labels[sel]

    def padded_batches(self):
        """Fixed-shape eval iteration: every batch is exactly ``batch_size``;
        yields ``(images, labels, valid_mask)`` with the tail zero-padded."""
        n = len(self.images)
        bs = self.batch_size
        for lo in range(0, n, bs):
            img = self.images[lo : lo + bs]
            lab = self.labels[lo : lo + bs]
            valid = np.ones(len(img), bool)
            if len(img) < bs:
                pad = bs - len(img)
                img = np.concatenate([img, np.zeros((pad,) + img.shape[1:], img.dtype)])
                lab = np.concatenate([lab, np.zeros(pad, lab.dtype)])
                valid = np.concatenate([valid, np.zeros(pad, bool)])
            yield img, lab, valid
