"""The comparison that decides ``correct`` for a detection pod.

After the window has closed, the reference (``omnibench.reference``:
plain NumPy and PyTorch, nothing of the program) follows every stream
from its start: its history is seeded from the video's frame 0, as the
program's is, and grows with the detections the program kept, frame by
frame.  That is the one place where it takes the program's state, so the
plan check below also checks it: a program whose history drifted plans
other SRoIs.  For each frame of the sampled ticks it works out again:

* the plan: the predicted SRoIs, the variant of each and the plan's
  latency, exactly (``plan_mismatches``);
* whether the discovery pass ran (``discovery_mismatches``);
* each crop the batched projection made, against the float64 gnomonic
  map sampled from the same frame (``crop_err``);
* each request's detections, stage by stage: the reference runs the
  float32 detector (TF32 off) on the crop that was served, decodes every
  cell, lifts every cell's box to a SphBB in float64, and matches each
  detection the program served to the nearest cell in box and score.  It
  reads the widest SphBB gap (``box_gap_rad``), the widest score gap
  (``score_gap``), how far a served detection's score lies below the
  reference's k-th best, k the number served (``rank_gap``), served
  classes that differ where the reference's best class logit leads its
  second by more than ``CLASS_MARGIN`` (``class_flips``), and counts that
  the reference's scores cannot explain (``count_mismatches``).  The crop
  is the output of the stage before, judged on its own above, as a served
  model's earlier tokens are read to judge its later ones;
* the discovery pass: its resized frame against the float64 resize (in
  ``crop_err``), its detections by the same match;
* the frame's raw detections as ``finish_frame`` composes them (a special
  SRoI keeps its largest detection), exactly (``raw_mismatches``);
* the NMS keep-mask, against float64 greedy suppression of the same raw
  detections, exactly, unless an IoU that decided it lies within
  ``NMS_MARGIN`` of the threshold (``nms_mismatches``).

A crop-cache hit serves the PI of an earlier request of the same frame
and rung whose geometry quantises to the same key (the cache's own
rule); such a request is judged against the best of those regions.
Every request is judged, whatever its field of view.  The reference
maps and lifts each SRoI from its centre and FoV rounded to float32, as
the configuration's precision hands them to the projection: a special
SRoI's FoV clamps at pi, where tan(fov / 2) is infinite in exact
arithmetic and its sign is set by that rounding (float32's pi lies just
above pi).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from omnibench.reference import detector as ref_det
from omnibench.reference import geometry, plan as ref_plan
from omnibench.reference.sroi import Detection

# a served class may differ from the reference's only where the best
# class logit leads the second by less than this (float32 noise is
# ~1e-5 of a logit)
CLASS_MARGIN = 1e-3
# an NMS keep decision may differ only where an IoU that decided it lies
# this close to the threshold (float32 IoUs of small boxes carry ~1e-4)
NMS_MARGIN = 1e-3
COUNTS = ("plan_mismatches", "discovery_mismatches", "raw_mismatches",
          "nms_mismatches", "count_mismatches", "class_flips")
GAPS = ("crop_err", "box_gap_rad", "score_gap", "rank_gap")


@contextlib.contextmanager
def tf32(on: bool):
    """Float32 convolutions and products in TF32 (``on``) or in full
    float32, restored afterwards."""
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    old = (cudnn.allow_tf32, mm.allow_tf32)
    cudnn.allow_tf32 = mm.allow_tf32 = on
    try:
        yield
    finally:
        cudnn.allow_tf32, mm.allow_tf32 = old


def served(c: dict, conf: float, max_det: int) -> list[Detection]:
    """What a detector serves from decoded cells ``c``: the cells scoring
    at least ``conf``, best first (ties: lower index first), at most
    ``max_det``, as SphBB detections."""
    scores = c["scores"]
    order = torch.sort(scores, descending=True, stable=True).indices
    order = order[scores[order] >= conf][:max_det].tolist()
    box = c["sphbb"].cpu().numpy()
    return [Detection(box=box[i], category=int(c["classes"][i]),
                      score=float(scores[i])) for i in order]


def control_reference(judge, frame, region, rung_idx):
    """The control: the reference in the program's place, one step below
    the configuration's float32 with TF32 off: the crop's map and
    sampling in bfloat16, the detector's convolutions in TF32."""
    size = judge.rungs[rung_idx].input_size
    pi = geometry.crop(frame, region[0], region[1], region[2], size,
                       dtype=torch.bfloat16).float()
    with tf32(True):
        c = judge.crop_cells(pi, region, rung_idx)
    return pi, served(c, judge.config["conf"], judge.config["max_det"])


def _ref_det(d) -> Detection:
    return Detection(box=np.asarray(d.box).copy(), category=int(d.category),
                     score=float(d.score))


def _crop_key(ct, cp, fov, size):
    px, py = float(fov[0]) / size, float(fov[1]) / size
    return (size, round(float(ct) / px), round(float(cp) / py),
            round(float(fov[0]) / px), round(float(fov[1]) / py))


class Judge:
    """Holds the numbers; ``produce`` makes what is judged for one
    request (the program's records by default; the control puts the
    reference in a lower precision in their place)."""

    def __init__(self, config: dict, rungs, weights, device):
        self.config = config
        self.rungs = rungs
        self.weights = weights
        self.device = torch.device(device)
        self.numbers = {k: 0 for k in COUNTS}
        self.numbers.update({k: 0.0 for k in GAPS})
        # at_clamp: judged requests at a special SRoI's clamp (a vertical
        # FoV of pi, where the crop's rows lie 90 degrees out, or a
        # horizontal one of 2 pi)
        self.compared = dict(frames=0, requests=0, crops=0, discovery=0,
                             at_clamp=0)
        self.worst_crop = None
        self.worst_box = None

    # -- the reference's cells --------------------------------------------

    @torch.inference_mode()
    def cells(self, image: torch.Tensor, rung_idx: int) -> dict:
        """Every decoded cell of one (S, S, 3) image on the rung."""
        outs = ref_det.forward(self.weights[rung_idx],
                               image.to(torch.float32)[None])
        return ref_det.decode_cells(outs, self.rungs[rung_idx].strides)

    def crop_cells(self, pi, region, rung_idx):
        """The cells of crop ``pi`` of ``region``, lifted to SphBBs."""
        size = self.rungs[rung_idx].input_size
        c = self.cells(pi, rung_idx)
        c["sphbb"] = geometry.pi_boxes_to_sphbb(c["boxes"], region[0],
                                                region[1], region[2], size)
        return c

    def erp_cells(self, image, rung_idx, h: int, w: int):
        """The cells of resized ERP ``image``, lifted to SphBBs."""
        size = self.rungs[rung_idx].input_size
        c = self.cells(image, rung_idx)
        c["sphbb"] = geometry.erp_boxes_to_sphbb(c["boxes"], size, h, w)
        return c

    def crop_gap(self, got, want, what) -> None:
        err = float((got.double() - want).abs().max())
        if err > self.numbers["crop_err"]:
            self.worst_crop = dict(what, err=err)
        self.numbers["crop_err"] = max(self.numbers["crop_err"], err)
        self.compared["crops"] += 1

    # -- judging ---------------------------------------------------------

    def match(self, dets, c) -> dict:
        """The gaps of served detections ``dets`` against cells ``c``."""
        conf, max_det = self.config["conf"], self.config["max_det"]
        tol = self.config["limits"]["score_gap"]
        scores = c["scores"].double()
        n = len(dets)
        hi = int((scores >= conf + tol).sum())
        lo = int((scores >= conf - tol).sum())
        out = dict(count_bad=not (min(max_det, hi) <= n <= min(max_det, lo)),
                   box_gap=0.0, score_gap=0.0, rank_gap=0.0, class_flips=0)
        if n == 0:
            return out
        dev = c["sphbb"].device
        p = torch.tensor(np.stack([np.asarray(d.box, np.float64)
                                   for d in dets]), device=dev)
        ps = torch.tensor([float(d.score) for d in dets], dtype=torch.float64,
                          device=dev)
        diff = (p[:, None, :] - c["sphbb"][None]).abs()
        diff[..., 0] = torch.minimum(diff[..., 0], 2 * math.pi - diff[..., 0])
        dist = diff.amax(-1)
        ds = (ps[:, None] - scores[None]).abs()
        # each served detection is matched to the cell nearest it in box
        # and score together (each against its limit), so that a cell
        # whose box happens to lie nearer cannot stand in for the one
        # that was served
        lim = self.config["limits"]
        j = torch.maximum(dist / lim["box_gap_rad"],
                          ds / lim["score_gap"]).argmin(1)
        rows = torch.arange(n, device=dev)
        kth = torch.topk(scores, min(n, scores.numel())).values[-1]
        cls = torch.tensor([int(d.category) for d in dets], device=dev)
        flips = (cls != c["classes"][j]) & (c["margins"][j] > CLASS_MARGIN)
        out.update(
            count_bad=out["count_bad"] or len(set(j.tolist())) < n,
            box_gap=float(dist[rows, j].max()),
            score_gap=float(ds[rows, j].max()),
            rank_gap=float(torch.clamp(kth - scores[j], min=0).max()),
            class_flips=int(flips.sum()))
        return out

    def fold(self, m: dict, what=None) -> None:
        n = self.numbers
        if m["box_gap"] > n["box_gap_rad"]:
            self.worst_box = dict(what or {}, gap=m["box_gap"])
        n["count_mismatches"] += int(m["count_bad"])
        n["class_flips"] += m["class_flips"]
        for k, name in (("box_gap", "box_gap_rad"), ("score_gap", "score_gap"),
                        ("rank_gap", "rank_gap")):
            n[name] = max(n[name], m[k])

    def rows(self) -> list[tuple[str, float, float]]:
        lim = self.config["limits"]
        return [(k, self.numbers[k], 0) for k in COUNTS] + \
               [(k, self.numbers[k], lim[k]) for k in GAPS]

    def correct(self) -> bool:
        return all(v <= lim for _, v, lim in self.rows())


def _frame_on(pod, stream: int, slot: int, device):
    return torch.from_numpy(pod.pool[stream][slot]).to(device)


def check_pod(pod, sample: list[int], *, produce=None) -> Judge:
    """Judge the recorded run of ``pod`` (a ``DetectPod`` whose program
    state has been released) on the ticks in ``sample``.

    ``produce(judge, frame, region, rung_idx)`` -> (crop or None,
    detections) replaces the program's served crop and detections of a
    request (the control); by default the recorded ones are judged."""
    cfg = pod.config
    judge = Judge(cfg, pod.rungs, pod.weights, pod.device)
    planners, ladders = [], []
    for s, v in enumerate(pod.videos):
        variants, costs = pod.reference_ladder(s)
        ladders.append(variants)
        planners.append(ref_plan.StreamPlanner(
            variants, pod.budgets[s], cfg["n_classes"], v.visible_objects(0),
            explore_costs=costs))
    sample = set(sample)
    with tf32(False):
        _follow(pod, judge, planners, ladders, sample, produce)
    return judge


def _follow(pod, judge, planners, ladders, sample, produce) -> None:
    thr = pod.config["nms_threshold"]
    for tick in sorted(pod.records):
        crops = _crops_by_key(pod.crops.get(tick, []))
        for s, rec in enumerate(pod.records[tick]):
            planner = planners[s]
            if "kept" not in rec:
                continue
            pend = rec["pending"]
            if tick not in sample:
                # follow the program's state: its SRoI count and plan
                planner.frame_idx += 1
                fp = ref_plan.FramePlan(
                    pend.srois, pend.plan, [], pend.explore_frame,
                    ladders[s][pend.explore_idx])
                planner.discovers(fp)
                planner.commit([_ref_det(d) for d in rec["kept"]])
                continue
            judge.compared["frames"] += 1
            fp = planner.plan()
            ok_plan = _same_plan(fp, pend)
            judge.numbers["plan_mismatches"] += int(not ok_plan)
            disc = planner.discovers(fp)
            judge.numbers["discovery_mismatches"] += int(
                disc != rec["discovered"])
            frame = _frame_on(pod, s, rec["slot"], pod.device)
            if ok_plan:
                _judge_requests(judge, pod, s, rec, frame, crops, produce)
            _judge_raw(judge, rec)
            if rec["discovered"] and ok_plan:
                _judge_discovery(judge, pod, tick, s, rec, frame)
            _judge_nms(judge, rec, thr)
            planner.commit([_ref_det(d) for d in rec["kept"]])


def _same_plan(fp, pend) -> bool:
    if len(fp.srois) != len(pend.srois):
        return False
    for a, b in zip(fp.srois, pend.srois):
        if (tuple(a.center) != tuple(b.center) or tuple(a.fov) != tuple(b.fov)
                or bool(a.special) != bool(b.special)):
            return False
    if (fp.plan is None) != (pend.plan is None):
        return False
    if fp.plan is not None and (tuple(fp.plan.models) != tuple(pend.plan.models)
                                or fp.plan.t_done != pend.plan.t_done):
        return False
    slot = {id(r): j for j, r in enumerate(pend.srois)}
    return [(j, v.name) for j, v in fp.requests] == \
        [(slot.get(id(q.region)), q.variant.name) for q in pend.requests]


def _crops_by_key(launches) -> dict:
    out = {}
    for (shape, idx, centers, fovs, size), crops in launches:
        for k in range(len(idx)):
            key = (int(idx[k]), size, *centers[k].tolist(), *fovs[k].tolist())
            out[key] = crops[k]
    return out


def _judge_requests(judge, pod, s, rec, frame, crops, produce) -> None:
    """Each request's crop against the float64 map, and its detections
    against the reference detector run on the crop that was served (the
    program's, or the control's), stage by stage."""
    pend = rec["pending"]
    groups: dict = {}
    for q in pend.requests:
        groups.setdefault(_request_key(pod, q), []).append(q)
    for q, dets in zip(pend.requests, rec["request_dets"]):
        idx = q.variant.index - 1
        size = pod.rungs[idx].input_size
        members = groups[_request_key(pod, q)]
        regions = [_as_projected(r.region) for r in members]
        own = regions[[r is q for r in members].index(True)]
        best = None
        for region in [own] + [r for r in regions if r != own]:
            if produce is not None:
                got_pi, got = produce(judge, frame, region, idx)
            else:
                got = dets
                got_pi = crops.get((s, size, region[0], region[1],
                                    *region[2]))
            if got_pi is None:
                continue  # a crop-cache hit: served another region's crop
            if region == own:
                judge.crop_gap(got_pi, geometry.crop(
                    frame, region[0], region[1], region[2], size),
                    dict(region=region, size=size))
            m = judge.match(got, judge.crop_cells(got_pi, region, idx))
            if best is None or m["box_gap"] < best["box_gap"]:
                best = m
        if best is None:
            judge.numbers["count_mismatches"] += 1  # no crop served it
            continue
        judge.fold(best, dict(region=own, size=size))
        judge.compared["requests"] += 1
        judge.compared["at_clamp"] += int(own[2][1] >= math.pi
                                          or own[2][0] >= 2 * math.pi)


def _judge_discovery(judge, pod, tick, s, rec, frame) -> None:
    """The discovery pass: its resized frame against the float64 resize,
    its detections against the reference detector on the resized frame it
    served."""
    pend = rec["pending"]
    n_req = sum(1 if q.special and d else len(d)
                for q, d in zip(pend.requests, rec["request_dets"]))
    image = pod.resized.get((tick, s))
    if image is None:
        return
    idx = pend.explore_idx
    size = pod.rungs[idx].input_size
    judge.crop_gap(image, geometry.resized(frame, size),
                   dict(region="resized frame", size=size))
    h, w = frame.shape[:2]
    judge.fold(judge.match(rec["raw"][n_req:],
                           judge.erp_cells(image, idx, h, w)))
    judge.compared["discovery"] += 1


def _as_projected(region) -> tuple:
    """(theta, phi, (fov_h, fov_v)) of an SRoI rounded to float32, as the
    projection takes them, as Python floats."""
    c = np.float32(region.center).tolist()
    f = np.float32(region.fov).tolist()
    return (c[0], c[1], (f[0], f[1]))


def _request_key(pod, q):
    size = pod.rungs[q.variant.index - 1].input_size
    return (q.variant.index,) + _crop_key(q.region.center[0],
                                         q.region.center[1], q.region.fov,
                                         size)


def _judge_raw(judge, rec) -> None:
    pend = rec["pending"]
    want = []
    for q, dets in zip(pend.requests, rec["request_dets"]):
        if q.special and dets:
            dets = [max(dets, key=lambda d: d.noa())]
        want.extend(dets)
    got = rec["raw"][:len(want)]
    same = len(got) == len(want) and all(a is b for a, b in zip(got, want))
    if not rec["discovered"]:
        same = same and len(rec["raw"]) == len(want)
    judge.numbers["raw_mismatches"] += int(not same)


def _judge_nms(judge, rec, thr: float) -> None:
    raw = rec["raw"]
    if not raw:
        judge.numbers["nms_mismatches"] += int(bool(rec["kept"]))
        return
    boxes = np.stack([np.asarray(d.box, np.float64) for d in raw])
    scores = np.array([float(d.score) for d in raw])
    keep, margin = geometry.greedy_keep(boxes, scores, thr)
    got = rec["keep"]
    same = got is not None and np.array_equal(np.asarray(got, bool), keep) \
        and [d for d, k in zip(raw, got) if k] == rec["kept"]
    if not same and margin > NMS_MARGIN:
        judge.numbers["nms_mismatches"] += 1


