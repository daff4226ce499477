"""Host-side tiling of the code stream into fixed device batches.

Produces (batch_tiles, tile + k - 1) uint8 arrays where consecutive tiles
overlap by k-1 codes (the halo), so every window of the stream appears in
exactly one tile position.  Fixed shapes mean the device step compiles
once.  This is the device analogue of the reference's chunking + k-1
backseek (reference: include/text_reader.h:206-213).
"""

from __future__ import annotations

import numpy as np


class TileBatcher:
    def __init__(self, k: int, tile: int, batch_tiles: int):
        self.k = k
        self.tile = tile
        self.batch_tiles = batch_tiles
        self._buf = np.empty(0, np.uint8)

    def _tiles(self, batch: np.ndarray, rows: int) -> np.ndarray:
        s = batch.strides[0]
        return np.lib.stride_tricks.as_strided(
            batch, shape=(rows, self.tile + self.k - 1), strides=(self.tile * s, s)
        )

    def add(self, codes: np.ndarray):
        """Yields full (batch_tiles, tile+k-1) batches."""
        if codes.shape[0] == 0:
            return
        self._buf = (
            codes if self._buf.shape[0] == 0 else np.concatenate([self._buf, codes])
        )
        per_batch = self.batch_tiles * self.tile
        while self._buf.shape[0] - (self.k - 1) >= per_batch:
            batch = self._buf[: per_batch + self.k - 1]
            yield self._tiles(batch, self.batch_tiles)
            self._buf = self._buf[per_batch:].copy()

    def finish(self):
        """Yields the final padded batch (same shape), if anything remains."""
        if self._buf.shape[0] > 0:
            per_batch = self.batch_tiles * self.tile
            padded = np.full(per_batch + self.k - 1, 4, np.uint8)
            padded[: self._buf.shape[0]] = self._buf
            yield self._tiles(padded, self.batch_tiles)
        self._buf = np.empty(0, np.uint8)
