"""Shape-bucketed variant batching for the pod serving loop.

At pod scale the dominant serving lever is *variant batching*: PI
requests from many streams that chose the same model variant are
stacked into one accelerator forward.  Unrestricted batch sizes would
give every new stream count a new forward shape (a new cuDNN algorithm
search); this module bounds the shape space instead:

  * **batch buckets** — a small fixed ladder of batch sizes.  A drained
    chunk of ``b`` requests is zero-padded up to the smallest bucket
    ``>= b`` and the padded rows are masked out of the decode, so a
    serving lifetime sees at most ``len(batch_sizes)`` batch shapes per
    variant.
  * **resolution buckets** — the set of legal crop resolutions.  Each
    variant projects its SRoIs at its own fixed input size, so the
    resolution set is exactly the ladder's input sizes; the helper
    validates that no dispatch can introduce an off-ladder shape.

``VariantQueues`` is the tick-level request fabric shared by
``PodServer`` and the baselines: requests accumulate per variant and
drain into bucketed chunks, each chunk becoming one batched detector
forward (``repro.serving.scheduler.*.infer_srois_batched``).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Sequence

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

    @classmethod
    def for_max_batch(cls, max_batch: int,
                      resolutions: tuple[int, ...] | None = None
                      ) -> "ShapeBuckets":
        """Default bucket ladder capped at ``max_batch`` (kept as the
        top bucket so a full drain always lands on an exact bucket)."""
        sizes = tuple(b for b in DEFAULT_BATCH_BUCKETS if b < max_batch)
        return cls(sizes + (max_batch,), resolutions)


@dataclasses.dataclass
class QueuedRequest:
    """One SRoI inference request parked in a variant queue.

    ``deadline`` is the owning stream's latency budget (seconds) —
    the cross-variant ordering key of
    ``repro.serving.runtime.DeadlineOrderPolicy``; ``emitted_s`` is
    the event-clock time the request was emitted (no dispatch may
    launch before it); ``age`` counts whole ticks the request has
    waited in the queue (bumped by every drain that leaves it behind —
    the async carry-over staleness bound).

    ``task`` names the owning analytics task (``repro.serving.tasks``).
    Queues still key on the variant NAME — task ladders own disjoint
    name spaces, so (task, variant) and the name are the same key —
    but the tag rides along for per-task accounting and telemetry.
    """

    request: Any                  # repro.core.omnisense.InferenceRequest
    owner: Any                    # opaque scatter key (the pending frame)
    backend: Any                  # executes the batched forward
    latency_model: Any = None     # prices the dispatch (may be None)
    deadline: float | None = None
    emitted_s: float = 0.0
    age: int = 0
    task: str = "detection"
    # the stream frame index the request was emitted for.  Simulation
    # backends (``set_frame``) sample ground truth by CURRENT frame, so
    # a request carried across ticks must be replayed at its emission
    # frame or it would observe the future (real pixel backends are
    # immune: the pixels travel inside the request).
    frame_idx: int | None = None


class VariantQueues:
    """Per-variant request queues drained into bucketed batched forwards.

    ``put`` parks requests; ``drain`` empties every queue into chunks of
    at most ``buckets.max_batch`` requests, issues one
    ``infer_srois_batched`` call per (chunk, backend) group and returns
    the per-request detections plus per-dispatch accounting records.
    Variants are drained in sorted-name order so a tick's dispatch
    schedule is deterministic.
    """

    def __init__(self, buckets: ShapeBuckets | None = None):
        self.buckets = buckets or ShapeBuckets()
        self._queues: dict[str, collections.deque] = collections.defaultdict(
            collections.deque)

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def put(self, item: QueuedRequest) -> None:
        self._queues[item.request.variant.name].append(item)

    def counts(self) -> dict[str, int]:
        """Live queue depth per variant (zero-depth variants included
        once seen, so drain planners observe a stable key set)."""
        return {name: len(q) for name, q in self._queues.items()}

    def peek(self, name: str) -> tuple[QueuedRequest, ...]:
        """The queue's items in FIFO (pop) order, without popping —
        drain policies read deadlines/ages from here."""
        return tuple(self._queues.get(name, ()))

    def head(self, name: str) -> QueuedRequest | None:
        """The queue's next-to-pop item without the O(n) copy of
        :meth:`peek` (per-chunk pricing only needs the variant and
        latency model, which every item of a queue shares)."""
        q = self._queues.get(name)
        return q[0] if q else None

    def newly_carried(self) -> int:
        """Queued requests that were carried for the FIRST time by the
        drain that just ran (``age == 1``: :meth:`drain_ops` ages every
        left-behind request once per drain).  Summing this per tick
        counts each carried request exactly once, however many ticks it
        ends up waiting — the unique-requests carry counter
        (``ServeStats.carried_requests``)."""
        return sum(1 for q in self._queues.values()
                   for item in q if item.age == 1)

    def full_drain_ops(self) -> list[tuple[str, int]]:
        """The plan covering EVERY queued request: variants in
        sorted-name order, one op per bucket-capped chunk
        (``ShapeBuckets.split``) — the pre-runtime schedule.  The
        single source of the full-drain chunking, shared by
        :meth:`drain`, the sync policy and ``PodServer.flush`` so the
        three can never disagree on it."""
        return [(name, take) for name in sorted(self._queues)
                for take in self.buckets.split(len(self._queues[name]))]

    def drain(self, placement=None
              ) -> tuple[list[tuple[QueuedRequest, list]], list[dict]]:
        """Empty all queues; returns (results, dispatch records) —
        :meth:`drain_ops` over :meth:`full_drain_ops`."""
        return self.drain_ops(self.full_drain_ops(), placement)

    def drain_ops(self, ops, placement=None
                  ) -> tuple[list[tuple[QueuedRequest, list]], list[dict]]:
        """Execute an explicit dispatch plan; returns (results, records).

        ``ops``: ordered ``(variant_name, take)`` pairs (or objects
        with ``.variant``/``.take`` — ``repro.serving.runtime.DrainOp``)
        each popping ``take`` requests FIFO into ONE batched forward.
        Requests not covered by any op stay queued (the async
        carry-over) and age by one tick.

        ``results``: (queued_request, detections) per drained request,
        in dispatch order.  ``dispatches``: one record per batched
        forward with the variant, real batch ``b``, padded bucket size
        and the items it served — the tick schedule the server prices.

        With a ``placement`` (``repro.serving.placement``), each
        chunk's forward routes to its variant's replica group and every
        forward is LAUNCHED before any result is resolved: backends
        exposing the non-blocking ``launch_srois_batched`` entry
        overlap the per-variant forwards across their disjoint device
        groups instead of serialising in plan order.
        """
        resolvers: list[tuple[list[QueuedRequest], Any]] = []
        dispatches: list[dict] = []
        for op in ops:
            name, take = (op.variant, op.take) if hasattr(op, "variant") \
                else op
            q = self._queues[name]
            if not 0 < take <= len(q):
                raise ValueError(
                    f"drain op wants {take} of variant {name!r} but the "
                    f"queue holds {len(q)}")
            if take > self.buckets.max_batch:
                raise ValueError(
                    f"drain op of {take} exceeds the top bucket "
                    f"{self.buckets.max_batch}")
            group = placement.group_for(name) if placement is not None \
                else None
            chunk = [q.popleft() for _ in range(take)]
            resolvers.extend(
                self._launch_chunk(name, chunk, dispatches, group))
        results: list[tuple[QueuedRequest, list]] = []
        for items, resolve in resolvers:
            dets = resolve()
            assert len(dets) == len(items)
            results.extend(zip(items, dets))
        for q in self._queues.values():  # carried requests wait a tick
            for item in q:
                item.age += 1
        return results, dispatches

    def _launch_chunk(self, name: str, chunk: Sequence[QueuedRequest],
                      dispatches: list[dict], group=None):
        """One drained chunk -> one (launched) batched detector forward.

        Streams normally share one backend (the real detector ladder),
        so the whole chunk is a single ``infer_srois_batched`` call;
        per-stream oracle backends sub-group by identity (an execution
        detail of the simulation — the chunk remains ONE dispatch in
        the tick schedule the server prices).  ``set_frame`` backends
        additionally sub-group by the requests' emission frame and are
        replayed at it, so a request carried across ticks still
        samples the ground truth of the frame that emitted it.
        Returns ``(items, resolver)`` pairs; backends without a
        non-blocking entry execute inline and resolve trivially.
        """
        variant = chunk[0].request.variant
        groups: dict[tuple, list[QueuedRequest]] = {}
        for item in chunk:
            frame_key = item.frame_idx \
                if hasattr(item.backend, "set_frame") else None
            groups.setdefault((id(item.backend), frame_key), []).append(item)
        out = []
        # virtual-slot groups price the tick model but cannot host a
        # sharded forward — execution falls back to the plain batched
        # path while the dispatch record keeps the group for pricing
        exec_group = group if group is not None and not group.is_virtual \
            else None
        for (_, frame_key), items in groups.items():
            backend = items[0].backend
            if frame_key is not None:
                backend.set_frame(frame_key)
            pairs = [(it.request.frame, it.request.region) for it in items]
            if hasattr(backend, "launch_srois_batched"):
                out.append((items, backend.launch_srois_batched(
                    pairs, variant, exec_group)))
            else:
                dets = backend.infer_srois_batched(pairs, variant)
                out.append((items, lambda dets=dets: dets))
        # `semantic`: every backend in the chunk declares its batched
        # entry a pure simulation (`semantic_batch = True`, e.g. the
        # oracle), so the chunk models ONE shared-accelerator dispatch
        # and is priced as such.  Otherwise each backend group is a
        # real forward and must be priced individually.
        dispatches.append(dict(
            variant=name,
            b=len(chunk),
            padded=self.buckets.pad_batch(len(chunk)),
            items=list(chunk),
            forwards=len(groups),
            group_sizes=[len(items) for items in groups.values()],
            semantic=all(getattr(it.backend, "semantic_batch", False)
                         for it in chunk),
            group=group,
        ))
        return out
