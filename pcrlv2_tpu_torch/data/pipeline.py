"""Synthetic LUNA batches (port of ``pcrlv2_tpu/data/pipeline.py:326-334``).

The on-disk LUNA readers, the host loader and device prefetch are not
ported yet (ROADMAP Queue A item 6).
"""

from __future__ import annotations

import numpy as np


def synthetic_luna_batch(batch_size: int = 32, size=(64, 64, 32),
                         local=(16, 16, 16), n_views: int = 6, seed: int = 0):
    """A raw batch with the shapes ``luna_preprocess.py`` writes: pair
    (B, 2, 64, 64, 32), locals (B, 6, 16, 16, 16), values in [0, 1)."""
    rng = np.random.RandomState(seed)
    return {
        "pair": rng.rand(batch_size, 2, *size).astype(np.float32),
        "locals": rng.rand(batch_size, n_views, *local).astype(np.float32),
    }
