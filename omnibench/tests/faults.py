"""Faults planted under the timed path of a detection pod, for the test
that sees ``correct`` come out false: each is applied to a built pod
after its warm-up ticks and before the window."""

from __future__ import annotations


def _on_resolve(pod, change) -> None:
    backend = pod.backend
    launch = backend.launch_srois_batched

    def launching(items, variant, group=None):
        resolve = launch(items, variant, group)
        return lambda: change(resolve())

    backend.launch_srois_batched = launching


def answer_altered(pod) -> None:
    """Each chunk's first detection is served with its score raised."""
    def change(rows):
        for dets in rows:
            if dets:
                dets[0].score += 0.05
                break
        return rows
    _on_resolve(pod, change)


def half_batch_dropped(pod) -> None:
    """The second half of every chunk is served no detections."""
    def change(rows):
        keep = (len(rows) + 1) // 2
        return rows[:keep] + [[] for _ in rows[keep:]]
    _on_resolve(pod, change)


class _Frozen(list):
    def append(self, item) -> None:
        pass


def state_unchanged(pod) -> None:
    """Every stream's history stops advancing: each frame is planned from
    the same detections."""
    for loop in pod.loops:
        loop._history = _Frozen(loop._history)

