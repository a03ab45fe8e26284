"""Per-variant replica groups: multi-device placement for pod serving.

Variant batching gives the pod ONE batched forward per variant per
tick, but every variant still serialises on a single accelerator — V
variants pay the SUM of their batched delays.  This module partitions the pod's devices
into per-variant **replica groups** so the V forwards run concurrently,
each sharded over its group's ``data`` axis:

  * ``VariantPlacement.partition`` greedily assigns devices to variants
    by *profiled load* (variant FLOPs-derived ``infer_s`` x observed
    popularity): every variant keeps at least one device, and each
    remaining device goes to the group with the highest load per
    device, so a variant 5x costlier than its peers ends up with ~5x
    the devices.  When there are more variants than devices, variants
    are bin-packed onto shared groups (lightest-bin-first), so the
    device partition is always a disjoint cover.
  * ``observe`` feeds per-tick request counts into a popularity EMA and
    ``maybe_rebalance`` re-partitions when the allocator has shifted
    variant popularity past a threshold.  Every variant maps to a group
    at ALL times (popularity is floored, groups are swapped
    atomically), so a rebalance can never strand a queued request.
  * ``ReplicaGroup.mesh`` describes a group of real devices as a
    one-axis ``("data",)`` mesh; ``TorchDetectorBackend`` serves such a
    group with one replica of the variant a device, each running an
    equal slice of the padded batch (the reference's ``shard_map`` over
    that mesh).

Devices may be real ``torch.device`` objects (CUDA devices) or plain
placeholders (ints) for simulation backends: the oracle pod prices the
device-aware tick model without touching an accelerator, which keeps
placement logic testable on the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class ReplicaGroup:
    """One disjoint device group serving one (or more) variants."""

    index: int
    variants: tuple[str, ...]
    devices: tuple[Any, ...]

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    @property
    def is_virtual(self) -> bool:
        """Placeholder device slots (simulation pricing only): the
        group can model the tick but cannot host a sharded forward."""
        return any(isinstance(d, int) for d in self.devices)

    @property
    def mesh(self):
        """The group's 1-axis ``("data",)`` mesh over its devices (real
        devices only), a ``launch.mesh.MeshSpec``: the replicas run from
        one process, so no process group is needed."""
        from repro_torch.launch.mesh import MeshSpec

        if self.is_virtual:
            raise TypeError(
                f"group {self.index} holds virtual device slots "
                f"{self.devices}; a mesh needs real devices")
        return MeshSpec((self.n_devices,), ("data",), self.devices)

    def shard_batch(self, b: int) -> int:
        """Smallest batch >= ``b`` divisible by the group width (the
        extra rows are masked padding, like batch-bucket padding)."""
        g = self.n_devices
        return int(math.ceil(b / g)) * g


class VariantPlacement:
    """Greedy load-balanced partition of devices into replica groups.

    ``variants`` are ``ModelProfile``s (their FLOPs-derived ``infer_s``
    is the static load term); ``devices`` defaults to the CUDA devices
    (``torch.device("cuda", i)``), and with none present and none given
    the constructor raises: there is no CPU fallback.
    ``popularity_smoothing`` is the EMA step applied by :meth:`observe`;
    ``rebalance_threshold`` is the relative device-count shift that
    makes :meth:`maybe_rebalance` adopt a fresh partition.
    """

    def __init__(self, variants: Sequence, devices: Sequence[Any] | None = None,
                 *, popularity_smoothing: float = 0.5,
                 rebalance_threshold: float = 0.25,
                 min_popularity: float = 0.05,
                 cost_fn=None):
        if devices is None:
            import torch

            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device is available; pass devices= (for "
                    "example VariantPlacement.virtual for a simulated pod)")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        if not variants:
            raise ValueError("placement needs at least one variant")
        if not devices:
            raise ValueError("placement needs at least one device")
        self.devices = tuple(devices)
        # static load term: FLOPs-derived profiled forward seconds by
        # default; pass the latency model's ``_inf`` as ``cost_fn`` to
        # weigh remote variants by their full serving cost (compute +
        # payload delivery), which is the real per-tick bottleneck
        cost_fn = cost_fn or (lambda v: v.infer_s)
        self._flops = {v.name: float(cost_fn(v)) for v in variants}
        self._order = [v.name for v in variants]
        self.smoothing = popularity_smoothing
        self.threshold = rebalance_threshold
        self.min_popularity = min_popularity
        self._popularity = {name: 1.0 for name in self._order}
        self.rebalances = 0
        self._adopt(self.partition(self._weights(), self.devices))

    # -- partition ---------------------------------------------------------

    def _weights(self) -> dict[str, float]:
        return {name: self._flops[name]
                * max(self._popularity[name], self.min_popularity)
                for name in self._order}

    @staticmethod
    def partition(weights: Mapping[str, float],
                  devices: Sequence[Any]) -> list[ReplicaGroup]:
        """Greedy FLOPs-weighted device partition (see module doc).

        Deterministic: variants are processed heaviest-first (name
        tie-break) and devices are sliced contiguously, so equal inputs
        always produce the identical partition.
        """
        names = sorted(weights, key=lambda n: (-weights[n], n))
        n_groups = min(len(names), len(devices))
        # 1) bin-pack variants onto groups (lightest bin first)
        bin_vars: list[list[str]] = [[] for _ in range(n_groups)]
        bin_w = [0.0] * n_groups
        for name in names:
            i = min(range(n_groups), key=lambda k: (bin_w[k], k))
            bin_vars[i].append(name)
            bin_w[i] += weights[name]
        # 2) one device each, then devices chase the highest load/device
        counts = [1] * n_groups
        for _ in range(len(devices) - n_groups):
            i = max(range(n_groups),
                    key=lambda k: (bin_w[k] / counts[k], -k))
            counts[i] += 1
        groups, lo = [], 0
        for i in range(n_groups):
            groups.append(ReplicaGroup(
                index=i, variants=tuple(bin_vars[i]),
                devices=tuple(devices[lo:lo + counts[i]])))
            lo += counts[i]
        return groups

    def _adopt(self, groups: list[ReplicaGroup]) -> None:
        self.groups = groups
        self._by_variant = {name: g for g in groups for name in g.variants}

    # -- queries -----------------------------------------------------------

    def group_for(self, variant_name: str) -> ReplicaGroup:
        return self._by_variant[variant_name]

    @property
    def variant_names(self) -> tuple[str, ...]:
        return tuple(self._order)

    def device_counts(self) -> dict[str, int]:
        return {name: self._by_variant[name].n_devices
                for name in self._order}

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    # -- popularity feedback / rebalance -----------------------------------

    def observe(self, request_counts: Mapping[str, int]) -> None:
        """Fold one tick's per-variant request counts into the EMA."""
        total = sum(request_counts.values())
        if total <= 0:
            return
        s = self.smoothing
        for name in self._order:
            share = request_counts.get(name, 0) / total
            self._popularity[name] = (1 - s) * self._popularity[name] + s * share

    def maybe_rebalance(self) -> bool:
        """Re-partition if the load shift warrants it; returns whether a
        new partition was adopted.  The swap is atomic — every variant
        has a group before AND after — so callers may rebalance with
        requests already queued."""
        fresh = self.partition(self._weights(), self.devices)
        cur = self.device_counts()
        new = {name: g.n_devices for g in fresh for name in g.variants}
        shift = max((abs(new[n] - cur[n]) / max(cur[n], 1)
                     for n in self._order), default=0.0)
        if shift <= self.threshold:
            return False
        self._adopt(fresh)
        self.rebalances += 1
        return True

    @classmethod
    def virtual(cls, variants: Sequence, n_devices: int,
                **kwargs) -> "VariantPlacement":
        """Placement over ``n_devices`` virtual slots — the simulation
        (oracle) pod prices the device-aware tick model without any
        accelerator behind it."""
        return cls(variants, devices=list(range(n_devices)), **kwargs)
