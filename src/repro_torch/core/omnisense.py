"""The per-frame OmniSense loop (paper Fig. 5) tying the core together.

    frame -> SRoI predictor -> resource allocator -> inference scheduler
          -> spherical NMS -> results (fed back to the predictor)

This module is substrate-agnostic: the detector, the latency model and
the execution backend are injected, so the same loop drives

  * the CPU prototype used in tests/examples (real small detectors),
  * the reproduction benchmark (paper-regime latency tables), and
  * the pod serving runtime in ``repro.serving.server``.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Protocol, Sequence

import numpy as np

from repro_torch import tracing
from repro_torch.core import accuracy as acc_mod
from repro_torch.core import allocation, discovery, sroi
from repro_torch.core.sphere import sph_nms_batch


class LatencyModel(Protocol):
    """Provides the allocator's delay terms for a frame's SRoIs."""

    def delays(
        self, srois: Sequence[sroi.SRoI], variants: Sequence[acc_mod.ModelProfile]
    ) -> tuple[np.ndarray, np.ndarray]:
        """Return (d_pre, d_inf), each (1 + n_variants, n_srois); row 0
        is the zero-cost "skip" pseudo-model."""
        ...


class InferenceBackend(Protocol):
    """Executes one SRoI with one variant; returns spherical detections."""

    def infer_sroi(
        self, frame: np.ndarray, region: sroi.SRoI, variant: acc_mod.ModelProfile
    ) -> list[sroi.Detection]:
        ...

    def infer_erp(
        self, frame: np.ndarray, variant: acc_mod.ModelProfile
    ) -> list[sroi.Detection]:
        """Full-ERP inference used by the discovery mechanism."""
        ...


@dataclasses.dataclass
class FrameResult:
    detections: list[sroi.Detection]
    srois: list[sroi.SRoI]
    plan: allocation.Plan | None
    planned_latency: float
    overhead_s: float  # SRoI prediction + allocation + post-processing
    discovered: bool


@dataclasses.dataclass
class InferenceRequest:
    """One planned SRoI inference, emitted by :meth:`OmniSenseLoop.begin_frame`.

    The pod server parks these in per-variant queues and drains each
    tick into batched detector forwards; ``slot`` is the request's
    position in the owning frame's request list so the decoded
    detections scatter back in plan order.
    """

    region: sroi.SRoI
    variant: acc_mod.ModelProfile
    slot: int
    special: bool
    frame: np.ndarray | None = None


@dataclasses.dataclass
class FrameContext:
    """The planning inputs of one frame, before any allocator ran.

    Produced by :meth:`OmniSenseLoop.frame_context` (which advances the
    stream's frame/exploration state); consumed by
    :meth:`OmniSenseLoop.emit_pending` together with a plan.  The pod
    server collects every stream's context first and hands the batch to
    the pod-level allocator (``repro.serving.pod_allocation``), which
    couples the per-stream knapsacks through shared batched costs;
    standalone :meth:`OmniSenseLoop.begin_frame` composes the two
    halves with the per-stream ``allocation.allocate`` in between.

    ``acc``/``d_pre``/``d_inf`` are the (1 + M, R) allocator matrices
    (``None`` when the frame predicted no SRoIs); ``budget`` is the
    frame's latency budget net of any reserved exploration cost.
    """

    frame: np.ndarray | None
    srois: list[sroi.SRoI]
    acc: np.ndarray | None
    d_pre: np.ndarray | None
    d_inf: np.ndarray | None
    budget: float
    explore_frame: bool
    explore_idx: int
    explore_cost: float
    t0: float


@dataclasses.dataclass
class PendingFrame:
    """A planned-but-not-executed frame (emission half of the loop).

    Produced by :meth:`OmniSenseLoop.begin_frame`; holds everything
    :meth:`OmniSenseLoop.finish_frame` needs to ingest the batched
    inference results and complete the frame exactly like the inline
    path.
    """

    frame: np.ndarray | None
    srois: list[sroi.SRoI]
    plan: allocation.Plan | None
    planned_latency: float
    overhead_s: float
    explore_frame: bool
    explore_idx: int
    explore_cost: float
    requests: list[InferenceRequest]


class OmniSenseLoop:
    """Stateful per-stream analytics session."""

    def __init__(
        self,
        variants: Sequence[acc_mod.ModelProfile],
        latency_model: LatencyModel,
        backend: InferenceBackend,
        budget_s: float,
        f_deg: float = 60.0,
        gamma: float = 1.1,
        delta: int = 2,
        nms_threshold: float = 0.6,
        n_categories: int = acc_mod.N_CATEGORIES,
        explore_every: int = 6,
        explore_costs: list[float] | None = None,
        on_plan: Callable[[allocation.Plan, list[sroi.SRoI]], None] | None = None,
    ) -> None:
        self.variants = list(variants)
        self.latency_model = latency_model
        self.backend = backend
        self.budget_s = budget_s
        self.f = math.radians(f_deg)
        self.gamma = gamma
        self.delta = delta
        self.nms_threshold = nms_threshold
        self.n_categories = n_categories
        # periodic spherical-object discovery: every `explore_every`
        # frames the loop reserves the full-ERP pass cost from the
        # allocator's budget and spends it on exploration (the paper's
        # discovery mechanism, run on a cadence so moving cameras keep
        # finding regions the history has never seen).
        self.explore_every = explore_every
        # per-variant full-ERP pass cost; exploration picks the largest
        # model affordable within ~60% of the budget, so tight budgets
        # explore with cheap models instead of starving the SRoI plan.
        self.explore_costs = explore_costs or [0.0] * len(self.variants)
        self._frame_idx = 0
        self.on_plan = on_plan
        # detection history: most recent `delta` frames
        self._history: list[list[sroi.Detection]] = []
        self._discovery = discovery.DiscoveryState()
        # the key of this stream's spans (``repro_torch.tracing``);
        # ``PodServer`` sets it to the stream's number
        self.trace_key = None

    # -- helpers ----------------------------------------------------------

    def _flat_history(self) -> list[sroi.Detection]:
        out: list[sroi.Detection] = []
        for frame_dets in self._history[-self.delta :]:
            out.extend(frame_dets)
        return out

    def _weighted_acc_matrix(self, srois: Sequence[sroi.SRoI]) -> np.ndarray:
        """(1 + M, R): row 0 = skip (zero accuracy)."""
        m, r = len(self.variants), len(srois)
        out = np.zeros((1 + m, r), dtype=np.float64)
        for j, s in enumerate(srois):
            for i, var in enumerate(self.variants):
                out[1 + i, j] = acc_mod.weighted_accuracy(var.gav, s.ccv, s.alpha)
        return out

    # -- main entry --------------------------------------------------------

    def frame_context(self, frame: np.ndarray) -> FrameContext:
        """First half of the emission: advance the frame/exploration
        state, predict SRoIs and build the allocator's input matrices —
        WITHOUT choosing a plan.  Callers that allocate per stream go
        through :meth:`begin_frame`; the pod server instead collects
        every stream's context and solves the coupled pod-level
        allocation before handing each plan to :meth:`emit_pending`."""
        with tracing.span("emit.predict", self.trace_key):
            t0 = time.perf_counter()
            self._frame_idx += 1
            explore_frame = (self.explore_every > 0
                             and self._frame_idx % self.explore_every == 0)
            affordable = [i for i, c in enumerate(self.explore_costs)
                          if c <= 0.6 * self.budget_s]
            explore_idx = (max(affordable) if affordable
                           else int(np.argmin(self.explore_costs)))
            explore_cost = self.explore_costs[explore_idx]
            budget = self.budget_s
            if explore_frame:
                budget = max(0.0, budget - explore_cost)
            srois = sroi.predict_srois(
                self._flat_history(),
                f=self.f,
                gamma=self.gamma,
                n_categories=self.n_categories,
            )
            acc = d_pre = d_inf = None
            if srois:
                acc = self._weighted_acc_matrix(srois)
                d_pre, d_inf = self.latency_model.delays(srois, self.variants)
            return FrameContext(
                frame=frame,
                srois=srois,
                acc=acc,
                d_pre=d_pre,
                d_inf=d_inf,
                budget=budget,
                explore_frame=explore_frame,
                explore_idx=explore_idx,
                explore_cost=explore_cost,
                t0=t0,
            )

    def emit_pending(self, ctx: FrameContext,
                     plan: allocation.Plan | None) -> PendingFrame:
        """Second half of the emission: turn a (possibly pod-coupled)
        plan for ``ctx`` into the frame's :class:`InferenceRequest`
        list.  ``plan.models`` must index ``ctx.srois`` column-wise
        exactly like a per-stream ``allocation.allocate`` result."""
        planned_latency = 0.0
        if plan is not None:
            planned_latency = plan.t_done
            if self.on_plan is not None:
                self.on_plan(plan, list(ctx.srois))

        requests: list[InferenceRequest] = []
        if plan is not None:
            for j, model_idx in enumerate(plan.models):
                if model_idx == 0:
                    continue  # skipped SRoI
                requests.append(InferenceRequest(
                    region=ctx.srois[j],
                    variant=self.variants[model_idx - 1],
                    slot=len(requests),
                    special=ctx.srois[j].special,
                    frame=ctx.frame,
                ))
        return PendingFrame(
            frame=ctx.frame,
            srois=ctx.srois,
            plan=plan,
            planned_latency=planned_latency,
            overhead_s=time.perf_counter() - ctx.t0,
            explore_frame=ctx.explore_frame,
            explore_idx=ctx.explore_idx,
            explore_cost=ctx.explore_cost,
            requests=requests,
        )

    def begin_frame(self, frame: np.ndarray) -> PendingFrame:
        """Emission half of the frame: predict SRoIs, allocate models
        and emit one :class:`InferenceRequest` per non-skipped SRoI —
        WITHOUT executing any inference.  The pod server parks the
        requests in per-variant queues and drains them into batched
        detector forwards; standalone use goes through
        :meth:`process_frame`, which executes the requests inline.
        (Composition of :meth:`frame_context` + per-stream
        ``allocation.allocate`` + :meth:`emit_pending`; the pod-level
        allocator replaces only the middle step.)"""
        ctx = self.frame_context(frame)
        plan = None
        if ctx.srois:
            with tracing.span("emit.allocate", self.trace_key):
                plan = allocation.allocate(ctx.acc, ctx.d_pre, ctx.d_inf,
                                           ctx.budget)
        return self.emit_pending(ctx, plan)

    def finish_frame(self, pending: PendingFrame,
                     request_detections: Sequence[list[sroi.Detection]], *,
                     defer_nms: bool = False) -> FrameResult:
        """Ingestion half: take the per-request detection lists (in
        ``pending.requests`` slot order), run the discovery pass, and
        complete the frame exactly like the inline path.  ``defer_nms``
        has the same contract as :meth:`process_frame`."""
        assert len(request_detections) == len(pending.requests)
        detections: list[sroi.Detection] = []
        for req, dets in zip(pending.requests, request_detections):
            # special SRoIs keep only their largest detection
            if req.special and dets:
                dets = [max(dets, key=lambda d: d.noa())]
            detections.extend(dets)

        # ---- spherical object discovery ----
        planned_latency = pending.planned_latency
        self._discovery.observe(len(pending.srois))
        discovered = False
        if pending.explore_frame or self._discovery.should_discover(
                self.budget_s, planned_latency):
            with tracing.span("ingest.discovery", self.trace_key):
                detections.extend(self.backend.infer_erp(
                    pending.frame, self.variants[pending.explore_idx]))
            discovered = True
            planned_latency = min(self.budget_s,
                                  planned_latency + pending.explore_cost)

        result = FrameResult(
            detections=detections,
            srois=pending.srois,
            plan=pending.plan,
            planned_latency=planned_latency,
            overhead_s=pending.overhead_s,
            discovered=discovered,
        )
        if defer_nms:
            return result

        # ---- post-processing: spherical NMS (single-row fast path of
        # the batched subsystem) ----
        t1 = time.perf_counter()
        self.finalize_detections(result, self.nms_keep(detections))
        result.overhead_s += time.perf_counter() - t1
        return result

    def process_frame(self, frame: np.ndarray, *,
                      defer_nms: bool = False) -> FrameResult:
        """Run one frame inline (the per-request execution path):
        emission, per-request backend inference in plan order, then
        ingestion.  With ``defer_nms=True`` the returned result holds
        the RAW (pre-NMS) detections and the history is NOT yet
        updated; the caller owns suppression and must hand the
        keep-mask back via :meth:`finalize_detections` before the next
        frame.  ``PodServer`` instead splits the frame into
        :meth:`begin_frame` / :meth:`finish_frame` so inference batches
        across streams and suppression batches across the tick."""
        pending = self.begin_frame(frame)
        # ---- execute the plan (inference is NOT overhead) ----
        request_detections = [
            self.backend.infer_sroi(frame, req.region, req.variant)
            for req in pending.requests]
        return self.finish_frame(pending, request_detections,
                                 defer_nms=defer_nms)

    def nms_keep(self, detections: list[sroi.Detection]) -> np.ndarray | None:
        """Keep-mask for one frame's detections at this stream's
        threshold — the single-row fast path of ``sph_nms_batch``
        (also used by ``PodServer`` when streams disagree on the
        threshold and cannot share one padded batch)."""
        if not detections:
            return None
        boxes = np.stack([d.box for d in detections])
        scores = np.array([d.score for d in detections])
        return sph_nms_batch(
            boxes[None], scores[None], iou_threshold=self.nms_threshold)[0]

    def finalize_detections(self, result: FrameResult,
                            keep: np.ndarray | None) -> FrameResult:
        """Apply an externally computed NMS keep-mask and commit the
        surviving detections to the SRoI-prediction history.

        ``keep`` is a (n_detections,) bool mask (``None`` means "no
        detections this frame").  Must be called exactly once per
        ``process_frame(..., defer_nms=True)`` result, in frame order,
        so the detection feedback the predictor sees is identical to
        the inline path."""
        if keep is not None:
            result.detections = [
                d for d, k in zip(result.detections, keep) if k]
        self._history.append(result.detections)
        if len(self._history) > self.delta:
            self._history = self._history[-self.delta :]
        return result

    def seed_history(self, detections: list[sroi.Detection]) -> None:
        """Bootstrap the history (e.g. from an initial full-ERP pass)."""
        self._history.append(list(detections))
