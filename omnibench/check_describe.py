"""The comparison that decides ``correct`` for a region-description pod.

After the window has closed and the program's state is released, the
reference follows every stream from its start as the detection check
does (``omnibench.check_detect``): its planner's history is seeded from
the video's frame 0 and grows with the results the program kept.  For
each frame of the sampled ticks it works out again:

* the plan, exactly (``plan_mismatches``; the frozen planner with this
  ladder's pricing, ``omnibench.reference.vlm_plan``), and whether the
  discovery pass ran (``discovery_mismatches``);
* each crop the batched projection made, against the float64 gnomonic
  map sampled from the same frame (``crop_err``, as the detection check
  reads it);
* each result's box: the region's centre and the extent of the objects
  the reference predicted it from, exactly (``box_mismatches``);
* the frame's results as ``finish_frame`` composes them, and each
  result's class, score and tokens as its own logits and fed ids give
  them (``raw_mismatches``);
* the NMS keep-mask, against float64 greedy suppression
  (``nms_mismatches``, with the detection check's margin).

Then a seeded sample of the sampled ticks' requests, up to
``PER_RUNG`` a rung, goes through the reference model
(``omnibench.reference.kimi_vl``) in float32 with TF32 off, from the
same bfloat16 weights, layer by layer over every sampled request so that
one layer is upcast at a time: MoonViT on the crop the program served
(judged on its own above), the prompt, and the answer ids as the program
fed them (teacher-forced); each MoE layer takes the program's expert
picks, and ``route_gap`` reads how far they fall short of the
reference's own top k in ``s + b`` (bfloat16 moves a score by about
2^-9, so where two experts lie that close either may be picked).  Only
the choice is taken over: the gates are the reference's own scores at
those picks, so a fault in the program's gates shows in ``logit_gap``
and one in its choice in ``route_gap`` (a router that ignores ``b``
reads ~0.04 there).  At
each of the request's 1 + ``answer_tokens`` answer positions (the
prefill's last one and every decode step) it reads the relative logit
gap ``|l - l_ref|_2 / |l_ref|_2`` (``logit_gap``); a served class that
is not the reference's argmax over the class ids where the reference's
best two lie more than ``CLASS_MARGIN`` apart (``class_flips``), the
served score's distance from the reference's (``score_gap``), and a
greedy id that is not the reference's argmax over the vocabulary where
its best two lie more than ``ID_MARGIN`` apart (``id_flips``).

``produce``, for a control, maps each layer's float32 weights (and the
head's) to the ones the control computes with (``fp8_lm``: every weight
matrix of the LM rounded to float8 e4m3, one step below the
configuration's bfloat16; ``fp8_experts``: the routed experts alone).
The control runs from the program's crops and fed ids and routes by
itself; its logits stand in the program's, and its expert picks are
judged against the reference's top k as the program's are.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from omnibench.check_detect import (_as_projected, _crops_by_key, _frame_on,
                                    _judge_nms, _judge_raw, _ref_det,
                                    _same_plan, tf32)
from omnibench.reference import geometry, kimi_vl as ref, plan as ref_plan
from omnibench.reference.sroi import _merged_extents

# requests a rung taken into the model comparison (the seeded sample)
PER_RUNG = 12
# a served class may differ from the reference's only where its best two
# class logits lie this close; a greedy id likewise over the vocabulary
# (the program's logits sit ~2^-8 of their norm from the reference's)
CLASS_MARGIN = 0.05
ID_MARGIN = 0.05
COUNTS = ("plan_mismatches", "discovery_mismatches", "box_mismatches",
          "raw_mismatches", "nms_mismatches", "class_flips", "id_flips")
GAPS = ("crop_err", "logit_gap", "route_gap", "score_gap")


def _e4m3(w: torch.Tensor) -> torch.Tensor:
    """``w`` rounded to float8 e4m3, each matrix (each expert's, where
    they stack) scaled by its own largest value."""
    dims = tuple(range(w.dim() - 2, w.dim()))
    scale = w.abs().amax(dim=dims, keepdim=True).clamp(min=1e-30) / 448.0
    return (w / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def fp8_experts(lp: dict) -> dict:
    """A control's layer: the routed experts' weights in float8 e4m3."""
    if "moe" not in lp:
        return lp
    moe = dict(lp["moe"])
    for k in ("gate_up", "down"):
        moe[k] = _e4m3(moe[k])
    return dict(lp, moe=moe)


def fp8_lm(tree):
    """A control's layer (or head): every weight matrix of the LM in
    float8 e4m3 (norm scales and the correction bias as they are)."""
    if isinstance(tree, dict):
        return {k: fp8_lm(v) for k, v in tree.items()}
    return _e4m3(tree) if tree.dim() >= 2 else tree


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32(v) for v in tree]
    return tree.to(torch.float32)


class Judge:
    def __init__(self, config: dict):
        self.config = config
        self.numbers = {k: 0 for k in COUNTS}
        self.numbers.update({k: 0.0 for k in GAPS})
        self.compared = dict(frames=0, requests=0, crops=0, modelled=0,
                             by_rung={})
        self.worst_crop = None
        self.worst_box = None  # the widest logit gap's request

    def crop_gap(self, got, want, what) -> None:
        err = float((got.double() - want).abs().max())
        if err > self.numbers["crop_err"]:
            self.worst_crop = dict(what, err=err)
        self.numbers["crop_err"] = max(self.numbers["crop_err"], err)
        self.compared["crops"] += 1

    def rows(self) -> list[tuple[str, float, float]]:
        lim = self.config["limits"]
        return [(k, self.numbers[k], 0) for k in COUNTS] + \
               [(k, self.numbers[k], lim[k]) for k in GAPS]

    def correct(self) -> bool:
        return all(v <= lim for _, v, lim in self.rows())


def region_box(region) -> np.ndarray:
    """The box a description of ``region`` (the reference planner's
    SRoI) carries: its centre and its objects' extent."""
    if region.special:
        fh, fv = region.objects[0].fov
    else:
        fh, fv = _merged_extents(region.objects)[:2]
    return np.array([region.center[0], region.center[1], fh, fv],
                    dtype=np.float64)


def check_pod(pod, sample: list[int], *, produce=None) -> Judge:
    """Judge the recorded run of ``pod`` (a ``DescribePod`` whose program
    state has been released) on the ticks in ``sample``."""
    cfg = pod.config
    judge = Judge(cfg)
    planners = []
    for s, v in enumerate(pod.videos):
        variants, costs = pod.reference_ladder(s)
        planners.append((ref_plan.StreamPlanner(
            variants, pod.budgets[s], cfg["n_classes"], v.visible_objects(0),
            explore_costs=costs), variants))
    with tf32(False):
        served = _follow(pod, judge, planners, set(sample))
        _judge_model(pod, judge, _pick(pod, served), produce)
    return judge


def _follow(pod, judge, planners, sample) -> list[dict]:
    """The plan, crop, box, composition and NMS checks, frame by frame;
    returns the sampled ticks' requests for the model comparison."""
    thr = pod.config["nms_threshold"]
    served = []
    for tick in sorted(pod.records):
        crops = _crops_by_key(pod.crops.get(tick, []))
        rows = _decoded_rows(pod, tick) if tick in sample else {}
        for s, rec in enumerate(pod.records[tick]):
            planner, ladder = planners[s]
            if "kept" not in rec:
                continue
            pend = rec["pending"]
            if tick not in sample:
                planner.frame_idx += 1
                fp = ref_plan.FramePlan(pend.srois, pend.plan, [],
                                        pend.explore_frame,
                                        ladder[pend.explore_idx])
                planner.discovers(fp)
                planner.commit([_ref_det(d) for d in rec["kept"]])
                continue
            judge.compared["frames"] += 1
            fp = planner.plan()
            ok = _same_plan(fp, pend)
            judge.numbers["plan_mismatches"] += int(not ok)
            judge.numbers["discovery_mismatches"] += int(
                planner.discovers(fp) != rec["discovered"])
            frame = _frame_on(pod, s, rec["slot"], pod.device)
            for j, (q, dets) in enumerate(zip(pend.requests,
                                              rec["request_dets"])):
                size = q.variant.input_size
                region = _as_projected(q.region)
                crop = crops.get((s, size, region[0], region[1], *region[2]))
                if crop is not None:
                    judge.crop_gap(crop, geometry.crop(
                        frame, region[0], region[1], region[2], size),
                        dict(region=region, size=size))
                row = rows.get(id(q.region))
                bad = crop is None or row is None or len(dets) != 1
                if ok and not bad:
                    want = region_box(fp.srois[fp.requests[j][0]])
                    judge.numbers["box_mismatches"] += int(
                        not np.array_equal(dets[0].box, want))
                if bad:
                    judge.numbers["raw_mismatches"] += 1
                    continue
                judge.compared["requests"] += 1
                served.append(dict(det=dets[0], crop=crop, size=size,
                                   **row))
            _judge_raw(judge, rec)
            _judge_nms(judge, rec, thr)
            planner.commit([_ref_det(d) for d in rec["kept"]])
    return served


def _decoded_rows(pod, tick) -> dict:
    """id(region) -> where its request sits in the tick's decodes: the
    decode, its row there, its chunk and its row in the chunk."""
    out = {}
    for d, dec in enumerate(pod.decoded.get(tick, [])):
        r = 0
        for c, (_, items) in enumerate(dec["items"]):
            for k, (_, region) in enumerate(items):
                out[id(region)] = dict(tick=tick, decode=d, row=r, chunk=c,
                                       in_chunk=k)
                r += 1
    return out


def _pick(pod, served: list[dict]) -> list[dict]:
    """A seeded sample of at most ``PER_RUNG`` requests a rung."""
    rng = np.random.default_rng([pod.seed, 11])
    out = []
    for size in sorted({r["size"] for r in served}):
        members = [r for r in served if r["size"] == size]
        k = min(PER_RUNG, len(members))
        out += [members[i] for i in sorted(rng.choice(len(members), k,
                                                      replace=False))]
    return out


def _routes(pod, req, t: int, n_layers: int) -> list:
    """The program's expert picks for the request's ``t`` prompt
    positions and its decode steps, one (t + steps, k) tensor an MoE
    layer (None for a dense layer)."""
    rt = pod.routes[req["tick"]]
    pre = rt["prefill"][_chunk_index(pod, req)]
    dec = rt["decode"]
    lo = req["in_chunk"] * t
    n_dense = n_layers - len(pre)
    out = [None] * n_dense
    for m in range(len(pre)):
        out.append(torch.cat([pre[m][lo:lo + t]]
                             + [step[m][req["row"]:req["row"] + 1]
                                for step in dec]))
    return out


def _chunk_index(pod, req) -> int:
    """The request's chunk among every chunk the tick prefilled (its
    decodes' chunks in order)."""
    decs = pod.decoded[req["tick"]]
    return sum(len(d["items"]) for d in decs[:req["decode"]]) + req["chunk"]


def _judge_model(pod, judge, chosen: list[dict], produce) -> None:
    if not chosen:
        return
    cfg = pod.config
    w = pod.weights
    pre = torch.tensor(pod.pre_ids, device=pod.device)
    post = torch.tensor(pod.post_ids, device=pod.device)
    class_ids = torch.tensor(pod.class_ids, device=pod.device)
    n_layers = cfg["num_hidden_layers"]
    vis = dict(vision=_f32(w["vision"]), projector=_f32(w["projector"]),
               lm=dict(embed=w["lm"]["embed"]))
    xs, ts, routes, progs, feds = [], [], [], [], []
    with ref.full_float32():
        for req in chosen:
            dec = pod.decoded[req["tick"]][req["decode"]]
            fed = dec["fed"][:, req["row"]]
            x = ref.embeds(vis, req["crop"], pre, post, fed, cfg)
            t = x.shape[0] - fed.shape[0]
            xs.append(x)
            ts.append(t)
            feds.append(fed)
            routes.append(_routes(pod, req, t, n_layers))
            progs.append(torch.stack(
                [dec["first"][req["row"]]]
                + [s[req["row"]] for s in dec["logits"]]).to(torch.float32))
        del vis
        ctl = list(xs) if produce is not None else None
        route = ref.route
        for i, lp in enumerate(w["lm"]["layers"]):
            lp32 = _f32(lp)
            picks = [None] * len(xs)
            if ctl is not None:
                # the control routes itself; its picks are judged below
                alt = produce(lp32)
                for j in range(len(ctl)):
                    with _tap_route() as seen:
                        ctl[j], _ = ref.lm_layer(alt, ctl[j], cfg)
                    picks[j] = seen[0][2] if seen else None
            for j in range(len(xs)):
                with _tap_route() as seen:
                    xs[j], gap = ref.lm_layer(lp32, xs[j], cfg, routes[j][i])
                if picks[j] is not None:
                    p, y, _ = seen[0]
                    gap = route(p, y, cfg, picks[j])[2]
                judge.numbers["route_gap"] = max(judge.numbers["route_gap"],
                                                 gap)
            del lp32
        head = dict(final_norm=_f32(w["lm"]["final_norm"]),
                    head=_f32(w["lm"]["head"]))
        ctl_head = produce(head) if ctl is not None else head
        for j, req in enumerate(chosen):
            want = ref.lm_head(head, xs[j][ts[j] - 1:], cfg)
            got = progs[j] if ctl is None else \
                ref.lm_head(ctl_head, ctl[j][ts[j] - 1:], cfg)
            _judge_logits(judge, req, got, want, feds[j], class_ids,
                          from_program=ctl is None)
            by = judge.compared["by_rung"]
            by[req["size"]] = by.get(req["size"], 0) + 1
            judge.compared["modelled"] += 1


@contextlib.contextmanager
def _tap_route():
    """Record each routing call of the reference (its weights, its
    input and the picks it took) for the block's length."""
    seen = []
    route = ref.route

    def tapped(p, x, cfg, forced=None):
        out = route(p, x, cfg, forced)
        seen.append((p, x, out[0]))
        return out

    ref.route = tapped
    try:
        yield seen
    finally:
        ref.route = route


def _margin(row: torch.Tensor) -> tuple[int, float]:
    top = torch.topk(row, 2)
    return int(top.indices[0]), float(top.values[0] - top.values[1])


def _judge_logits(judge, req, got, want, fed, class_ids,
                  from_program) -> None:
    """One request's answer positions, program (or control) ``got``
    against the reference ``want`` (each (1 + steps, V))."""
    n = judge.numbers
    gap = float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())
    if gap > n["logit_gap"]:
        judge.worst_box = dict(size=req["size"], tick=req["tick"],
                               row=req["row"], gap=gap)
    n["logit_gap"] = max(n["logit_gap"], gap)
    cls_got, cls_want = got[0, class_ids], want[0, class_ids]
    best, margin = _margin(cls_want)
    det = req["det"]
    category = det.category if from_program else int(cls_got.argmax())
    score = det.score if from_program else \
        float(torch.softmax(cls_got, -1).max())
    n["class_flips"] += int(category != best and margin > CLASS_MARGIN)
    n["score_gap"] = max(n["score_gap"], abs(
        score - float(torch.softmax(cls_want, -1)[category])))
    ids = got.argmax(-1)
    for p in range(want.shape[0]):
        best, margin = _margin(want[p])
        n["id_flips"] += int(int(ids[p]) != best and margin > ID_MARGIN)
    # the program's own ids: it fed its greedy id of each position and
    # kept the decode steps' ones
    if from_program and (tuple(ids[1:].tolist()) != det.tokens
                         or not torch.equal(ids[:-1], fed)):
        n["raw_mismatches"] += 1
