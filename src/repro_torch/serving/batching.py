"""Shape buckets of the batched dispatches (port of ``ShapeBuckets``
from ``repro.serving.batching``; the variant queues wait for the pod
slice of the port).

  * **batch buckets** — a small fixed ladder of batch sizes.  A drained
    chunk of ``b`` requests is zero-padded up to the smallest bucket
    ``>= b`` and the padded rows are masked out of the decode, so a
    serving lifetime sees at most ``len(batch_sizes)`` batch shapes per
    variant.
  * **resolution buckets** — the set of legal crop resolutions.
  * **NMS buckets** — the padded row lengths of the tick's batched NMS.
"""

from __future__ import annotations

import dataclasses

DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8)
# detection-count ladder for the tick's batched spherical-NMS rows:
# rows pad to the smallest member >= the tick's max row length, so the
# (B, N) device path compiles one program per ladder rung instead of
# one per distinct detection count (ROADMAP: bounded NMS shapes).
DEFAULT_NMS_SIZES = (8, 16, 32, 64, 128)


@dataclasses.dataclass(frozen=True)
class ShapeBuckets:
    """The bounded shape space of batched dispatches.

    ``batch_sizes`` must be strictly increasing; ``resolutions`` is the
    optional set of legal (square) crop sizes (``None`` = unrestricted,
    for oracle backends that never touch pixels).
    """

    batch_sizes: tuple[int, ...] = DEFAULT_BATCH_BUCKETS
    resolutions: tuple[int, ...] | None = None
    nms_sizes: tuple[int, ...] = DEFAULT_NMS_SIZES

    def __post_init__(self):
        for name, sizes in (("batch", self.batch_sizes),
                            ("nms", self.nms_sizes)):
            if not sizes or any(b <= 0 for b in sizes):
                raise ValueError(f"invalid {name} buckets {sizes}")
            if list(sizes) != sorted(set(sizes)):
                raise ValueError(
                    f"{name} buckets must be strictly increasing: {sizes}")

    @property
    def max_batch(self) -> int:
        return self.batch_sizes[-1]

    def pad_batch(self, b: int) -> int:
        """Smallest bucket >= ``b`` (the padded dispatch batch size)."""
        if b <= 0 or b > self.max_batch:
            raise ValueError(f"batch {b} outside buckets {self.batch_sizes}")
        for size in self.batch_sizes:
            if size >= b:
                return size
        raise AssertionError  # unreachable: b <= max_batch

    def split(self, count: int) -> list[int]:
        """Split ``count`` queued requests into chunk sizes <= max_batch.

        Greedy full-bucket chunks followed by one remainder chunk; the
        remainder still pads up to a bucket, never to an ad-hoc shape.
        """
        out, rest = [], count
        while rest > self.max_batch:
            out.append(self.max_batch)
            rest -= self.max_batch
        if rest:
            out.append(rest)
        return out

    def pad_nms_rows(self, n: int) -> int:
        """Smallest NMS bucket >= ``n`` (the padded row length of the
        tick's batched-NMS dispatch).  Beyond the top rung, rows round
        up to a top-rung multiple so pathological ticks stay bounded
        (one extra shape per multiple) instead of erroring."""
        if n <= 0:
            return self.nms_sizes[0]
        for size in self.nms_sizes:
            if size >= n:
                return size
        top = self.nms_sizes[-1]
        return -(-n // top) * top

    def bucket_resolution(self, size: int) -> int:
        """Validate/snap a crop resolution into the bounded set."""
        if self.resolutions is None:
            return size
        if size in self.resolutions:
            return size
        raise ValueError(
            f"crop resolution {size} outside buckets {self.resolutions}")
