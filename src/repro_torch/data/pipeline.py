"""Host-side prefetching data pipeline (port of ``repro.data.pipeline``:
NumPy only, copied; the batches are the reference's arrays).

Training input must never stall the accelerator: ``Prefetcher`` wraps
any batch generator with a bounded queue filled by a daemon thread, so
host-side generation (synthetic rendering, tokenisation, target
rasterisation) overlaps device compute.  ``detector_batches`` and
``lm_batches`` are the concrete generators used by examples/tests.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class Prefetcher:
    def __init__(self, gen: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: BaseException | None = None

        def fill():
            try:
                for item in gen:
                    self._q.put(item)
            except BaseException as e:  # noqa: BLE001
                self._err = e
            finally:
                self._q.put(self._done)

        self._thread = threading.Thread(target=fill, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def lm_batches(vocab: int, batch: int, seq: int, seed: int = 0,
               n_batches: int | None = None):
    """Synthetic LM token batches (markov-ish so loss can decrease)."""
    rng = np.random.default_rng(seed)
    trans = rng.integers(0, vocab, size=(vocab,))
    i = 0
    while n_batches is None or i < n_batches:
        start = rng.integers(0, vocab, size=(batch, 1))
        toks = [start]
        for _ in range(seq):
            nxt = trans[toks[-1]]
            # noise keeps it learnable-but-not-trivial
            flip = rng.random((batch, 1)) < 0.1
            rand = rng.integers(0, vocab, size=(batch, 1))
            toks.append(np.where(flip, rand, nxt))
        seq_arr = np.concatenate(toks, axis=1)
        yield {"tokens": seq_arr[:, :-1].astype(np.int32),
               "targets": seq_arr[:, 1:].astype(np.int32)}
        i += 1


def detector_batches(video, cfg, batch: int, height: int = 128,
                     width: int = 256, seed: int = 0,
                     n_batches: int | None = None):
    """Rendered ERP crops + rasterised detection targets per scale."""
    from repro_torch.data.synthetic import render_erp

    rng = np.random.default_rng(seed)
    size = cfg.input_size
    i = 0
    while n_batches is None or i < n_batches:
        imgs, targets = [], None
        frames = rng.integers(0, video.n_frames, size=batch)
        for f in frames:
            erp = render_erp(video, int(f), height, width)
            # random crop resized to the detector input (keeps it simple)
            y0 = rng.integers(0, max(1, height - size)) if height > size else 0
            x0 = rng.integers(0, max(1, width - size)) if width > size else 0
            crop = erp[y0:y0 + size, x0:x0 + size]
            if crop.shape[0] < size or crop.shape[1] < size:
                crop = np.pad(crop, ((0, size - crop.shape[0]),
                                     (0, size - crop.shape[1]), (0, 0)))
            imgs.append(crop)
        batch_dict = {"images": np.stack(imgs).astype(np.float32)}
        targets = rasterize_targets(cfg, batch)
        batch_dict.update(targets)
        yield batch_dict
        i += 1


def rasterize_targets(cfg, batch: int, seed: int = 1):
    """Random-but-consistent dense targets for the detector loss.

    (The smoke-training example only needs the loss to be well-formed
    and decreasing; semantically meaningful targets come from the
    oracle pipeline in the serving stack.)
    """
    rng = np.random.default_rng(seed)
    out = {}
    size = cfg.input_size
    for i, stride in enumerate(cfg.strides):
        g = size // stride
        t = np.zeros((batch, g, g, 5 + cfg.n_classes), np.float32)
        n_pos = max(1, g // 4)
        for b in range(batch):
            ys = rng.integers(0, g, n_pos)
            xs = rng.integers(0, g, n_pos)
            t[b, ys, xs, 4] = 1.0
            t[b, ys, xs, 0:2] = rng.uniform(0.2, 0.8, (n_pos, 2))
            t[b, ys, xs, 2:4] = rng.uniform(-1, 1, (n_pos, 2))
            cls = rng.integers(0, cfg.n_classes, n_pos)
            t[b, ys, xs, 5 + cls] = 1.0
        out[f"targets_{i}"] = t
    return out
