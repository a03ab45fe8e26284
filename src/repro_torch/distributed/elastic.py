"""Elastic scaling, failure handling and straggler mitigation (a copy
of ``repro.distributed.elastic``, which is NumPy-free plain Python; the
port keeps its own so that it never imports the JAX package).

The module implements the *control-plane logic* a many-host deployment
needs and is unit-tested at simulation level:

  * ``HealthTracker`` — heartbeat bookkeeping; hosts that miss
    ``max_missed`` beats are marked failed, hosts whose step time
    exceeds ``straggler_factor`` x the fleet median are stragglers;
  * ``remesh_plan`` — given the original (pod, data, model) mesh and
    the healthy host count, choose the largest feasible mesh that (a)
    preserves the ``model`` axis (TP degree is baked into compiled
    programs and checkpoint layouts), (b) shrinks ``data``/``pod``
    (pure-DP axes shrink freely: batch re-divides, FSDP shards
    re-gather from the full-array checkpoint);
  * ``remesh`` — brings a plan up as a ``torch.distributed`` device
    mesh over the first ``devices_used`` ranks (the port's own: the
    reference makes a ``jax.make_mesh`` of the plan in its scripts);
  * ``StragglerPolicy`` — skip-slowest-microbatch accounting: a
    straggler's microbatch is dropped for the step and the gradient
    rescaled, bounding step time at the p50+margin instead of the max.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class HostState:
    last_beat: float = 0.0
    missed: int = 0
    step_time: float = 0.0
    failed: bool = False


class HealthTracker:
    def __init__(self, n_hosts: int, beat_interval: float = 10.0,
                 max_missed: int = 3, straggler_factor: float = 1.5):
        self.hosts = {i: HostState() for i in range(n_hosts)}
        self.beat_interval = beat_interval
        self.max_missed = max_missed
        self.straggler_factor = straggler_factor

    def heartbeat(self, host: int, now: float, step_time: float) -> None:
        h = self.hosts[host]
        h.last_beat = now
        h.missed = 0
        h.step_time = step_time

    # -- serving hooks (repro_torch.serving.fleet) -------------------------
    # training meshes are fixed at launch, but the serving fleet grows
    # and retires pods mid-run, so its tracker membership is dynamic.

    def ensure_host(self, host: int, now: float = 0.0) -> HostState:
        """Register ``host`` if unseen (a pod added by the elastic
        controller mid-run); idempotent for known hosts."""
        h = self.hosts.get(host)
        if h is None:
            h = self.hosts[host] = HostState(last_beat=now)
        return h

    def remove_host(self, host: int) -> None:
        """Forget a retired pod entirely — unlike a failure, a drained
        retirement must not count against health statistics."""
        self.hosts.pop(host, None)

    def tick(self, now: float) -> None:
        for h in self.hosts.values():
            if h.failed:
                continue
            if now - h.last_beat > self.beat_interval:
                h.missed += 1
                h.last_beat = now
                if h.missed >= self.max_missed:
                    h.failed = True

    def healthy(self) -> list[int]:
        return [i for i, h in self.hosts.items() if not h.failed]

    def stragglers(self) -> list[int]:
        alive = [h.step_time for h in self.hosts.values()
                 if not h.failed and h.step_time > 0]
        if not alive:
            return []
        med = sorted(alive)[len(alive) // 2]
        return [i for i, h in self.hosts.items()
                if not h.failed and h.step_time > self.straggler_factor * med]


def remesh_plan(original_shape: tuple[int, ...],
                original_axes: tuple[str, ...],
                healthy_devices: int) -> dict:
    """Largest feasible mesh on the healthy devices.

    Keeps the ``model`` axis intact, shrinks ``data`` then ``pod`` to
    the largest power-of-two product that fits.  Returns the new shape,
    the resulting global-batch scale factor, and whether a checkpoint
    reload suffices (it always does: checkpoints store full arrays).
    """
    sizes = dict(zip(original_axes, original_shape))
    model = sizes.get("model", 1)
    if healthy_devices < model:
        raise ValueError(
            f"cannot preserve model axis {model} with only "
            f"{healthy_devices} devices — requires re-lowering at a "
            f"smaller TP degree")
    budget = healthy_devices // model
    # data x pod packed into the budget, power-of-two, data-first
    data0, pod0 = sizes.get("data", 1), sizes.get("pod", 1)
    best_data = 1 << int(math.log2(max(1, min(budget, data0))))
    rem = budget // best_data
    best_pod = 1 << int(math.log2(max(1, min(rem, pod0))))
    new_sizes = {"model": model, "data": best_data, "pod": best_pod}
    shape = tuple(new_sizes[a] for a in original_axes)
    used = model * best_data * best_pod
    return {
        "shape": shape,
        "axes": original_axes,
        "devices_used": used,
        "devices_idle": healthy_devices - used,
        "batch_scale": (best_data * best_pod) / (data0 * pod0),
        "checkpoint_compatible": True,
    }


def remesh(plan: dict, device=None):
    """A ``DeviceMesh`` of ``plan`` (:func:`remesh_plan`'s result) over
    the first ``plan["devices_used"]`` ranks of the running process
    group, on ``device``'s type (the card unless the caller names
    another).  Every rank of the group calls it, since the mesh's groups
    are made collectively; the ranks past ``devices_used`` sit out: their
    ``mesh.get_coordinate()`` is None and they take no part in the
    mesh's collectives.  Restore on the new mesh from the full-array
    checkpoint (``checkpoint.restore_local``)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.device import resolve_device

    ranks = torch.arange(plan["devices_used"]).reshape(plan["shape"])
    return DeviceMesh(resolve_device(device).type, ranks,
                      mesh_dim_names=tuple(plan["axes"]))


def serving_scale_plan(total_devices: int, n_pods: int) -> dict:
    """Per-pod device split for an ``n_pods`` serving fleet over a
    fixed ``total_devices`` budget — the fleet tier's consumer of
    :func:`remesh_plan`.

    The pod count plays the ``model`` axis role: it is the dimension
    that must be PRESERVED exactly (the elastic controller chose it,
    and routing state binds streams to pod identities the way TP
    degree is baked into compiled programs), while each pod's device
    width is the free ``data`` axis that shrinks to the largest
    power of two fitting the budget.  Remainder slots idle rather
    than creating unequal pods — unequal pods would make the
    router's least-loaded signal lie.
    """
    if n_pods < 1:
        raise ValueError(f"n_pods must be >= 1, got {n_pods}")
    if total_devices <= 0:
        # virtual single-device pods (the CI regime): nothing to split
        return {"n_pods": n_pods, "per_pod_devices": 0,
                "devices_used": 0, "devices_idle": 0}
    plan = remesh_plan((1, max(1, total_devices // n_pods), n_pods),
                       ("pod", "data", "model"), total_devices)
    per_pod = plan["shape"][plan["axes"].index("data")]
    return {"n_pods": n_pods, "per_pod_devices": per_pod,
            "devices_used": plan["devices_used"],
            "devices_idle": total_devices - plan["devices_used"]}


@dataclasses.dataclass
class StragglerPolicy:
    """Skip-slowest-microbatch: drop straggler contributions, rescale."""

    margin: float = 1.25
    dropped_total: int = 0

    def step(self, microbatch_times: dict[int, float]) -> dict:
        times = sorted(microbatch_times.values())
        med = times[len(times) // 2]
        cutoff = med * self.margin
        keep = {h for h, t in microbatch_times.items() if t <= cutoff}
        drop = set(microbatch_times) - keep
        self.dropped_total += len(drop)
        return {
            "keep": sorted(keep),
            "drop": sorted(drop),
            "grad_scale": len(microbatch_times) / max(len(keep), 1),
            "step_time": cutoff if drop else times[-1],
        }
