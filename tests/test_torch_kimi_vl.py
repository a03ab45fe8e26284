"""Kimi-VL-A3B in the port (``models/kimi_vl.py``, MoonViT in
``models/vision.py``) against its plain float32 reference
(``models/kimi_vl_ref.py``) on seeded random weights at a tiny size: 1
dense and 2 MoE layers, 8 experts with top-2 and one shared expert,
small MLA ranks and a 2-block MoonViT.

* Prefill of two chunks at two crop sizes, then greedy decode of both
  together through the latent cache, against the reference's full
  forward of each request's whole sequence with the fed ids, compared on
  logits (float32 weights: atol 1e-4 of logits of order 1, the two
  sides summing in other orders; bfloat16 weights: the reference takes
  the program's expert picks, which fall short of its own top k by less
  than 2^-6 in score, and the relative gap of each logit row is under
  2^-5, bf16 rounding a product to 2^-9 and 3 layers of residual stream
  compounding it).
* The router: the correction bias chooses and the unbiased scores
  weight; ties take the lower index.
* No token dropped when every token picks the same experts.
* The position table's bicubic interpolation against an independent
  cubic-convolution resampler; the 2 x 2 merger's order.
* A tiny ``region_description`` pod through ``PodServer.step``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import kimi_vl_a3b
from repro_torch.models import kimi_vl as K
from repro_torch.models import kimi_vl_ref as R
from repro_torch.models import vision as V

PRE = torch.tensor([1, 5, 7])
POST = torch.tensor([9, 2])


def _setup(dtype=torch.float32, seed=0):
    cfg = dataclasses.replace(kimi_vl_a3b.tiny_config(), dtype=dtype)
    params = K.init_params(torch.Generator().manual_seed(seed), cfg,
                           dtype=dtype)
    return cfg, params


def _crops(sizes, seed=1):
    g = torch.Generator().manual_seed(seed)
    return [torch.rand((b, s, s, 3), generator=g) for s, b in sizes]


def _program(cfg, params, crops, steps, monkeypatch):
    """Prefill each chunk, decode all together; returns the fed ids, the
    logits of every answer position ((B, V) a position) and each
    request's expert picks (one (T + steps, k) tensor an MoE layer)."""
    calls = []
    route = K.route

    def tapped(p, x, cfg_lm):
        out = route(p, x, cfg_lm)
        calls.append(out[0])
        return out

    monkeypatch.setattr(K, "route", tapped)
    chunks, pre_routes = [], []
    for c in crops:
        img = K.image_tokens(params, c.to(cfg.dtype), cfg)
        emb = K.prompt_embeds(params, PRE, img, POST)
        calls.clear()
        last, lat = K.prefill(params["lm"], emb, cfg.lm)
        t = emb.shape[1]
        pre_routes += [[ids[j * t:(j + 1) * t] for ids in calls]
                       for j in range(len(c))]
        chunks.append((last.argmax(-1), lat, last))
    calls.clear()
    fed, logits, cache = K.generate(params, [(g, lat) for g, lat, _ in
                                             chunks], cfg, steps)
    n_moe = len(pre_routes[0])
    routes = [[None] + [torch.cat([pre_routes[r][m]]
                                  + [calls[s * n_moe + m][r:r + 1]
                                     for s in range(steps)])
                        for m in range(n_moe)]
              for r in range(len(pre_routes))]
    first = torch.cat([last for _, _, last in chunks])
    return fed, [first] + logits, cache, routes


def _reference(params, crops, fed, routes=None):
    d = kimi_vl_a3b.tiny_dict()
    rows = [c for chunk in crops for c in chunk]
    out, gaps = [], []
    for r, crop in enumerate(rows):
        full, gap = R.forward(params, crop, PRE, POST, fed[:, r], d,
                              None if routes is None else routes[r])
        out.append(full[-fed.shape[0] - 1:])
        gaps.append(gap)
    return out, gaps  # per request: (steps + 1, V)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_then_decode_matches_the_reference(dtype, monkeypatch):
    cfg, params = _setup(dtype)
    crops = _crops([(16, 2), (24, 1)])
    steps = 4
    fed, logits, cache, routes = _program(cfg, params, crops, steps,
                                          monkeypatch)
    assert cache.shape == (3, 3, 3 + 9 + 2 + steps,
                           cfg.lm.kv_lora_rank + cfg.lm.qk_rope_head_dim)
    if dtype == torch.float32:
        want, _ = _reference(params, crops, fed)
    else:
        # bfloat16 moves a score by ~2^-9: where two experts lie that
        # close the program may pick either, so the reference takes its
        # picks and reads how far they fall short of its own top k
        want, gaps = _reference(params, crops, fed, routes)
        assert max(gaps) < 2 ** -6
    for r in range(3):
        got = torch.stack([step[r] for step in logits])
        ref = want[r]
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)
        else:
            gap = (got - ref).norm(dim=-1) / ref.norm(dim=-1)
            assert float(gap.max()) < 2 ** -5


def test_a_forced_routing_that_is_no_top_k_shows_a_gap():
    cfg, params = _setup()
    p = params["lm"]["layers"][1]["moe"]
    x = torch.randn(6, cfg.lm.d_model, generator=torch.Generator()
                    .manual_seed(2))
    d = kimi_vl_a3b.tiny_dict()
    idx, w, gap = R.route(p, x, d)
    assert gap == 0.0
    _, _, same = R.route(p, x, d, forced=idx.flip(-1))
    assert same == 0.0
    worst = torch.sort(torch.sigmoid(x @ p["router"]) + p["bias"], -1
                       ).indices[:, :2]
    _, _, bad = R.route(p, x, d, forced=worst)
    assert bad > 0.01


def test_decode_cache_holds_only_the_latent():
    cfg, params = _setup()
    crops = _crops([(16, 1)])
    img = K.image_tokens(params, crops[0], cfg)
    last, lat = K.prefill(params["lm"],
                          K.prompt_embeds(params, PRE, img, POST), cfg.lm)
    # per token and layer: the normed c and the roped k_pe, nothing else
    assert lat.shape[-1] == cfg.lm.kv_lora_rank + cfg.lm.qk_rope_head_dim
    lp = params["lm"]["layers"][0]
    emb = K.prompt_embeds(params, PRE, img, POST)
    y = K._rms_norm(lp["attn_norm"], emb, cfg.lm.rms_eps)
    c = K._rms_norm(lp["kv_norm"], (y @ lp["wkva"])[..., :16],
                    cfg.lm.rms_eps)
    torch.testing.assert_close(lat[0, ..., :16], c)


def test_router_bias_chooses_and_scores_weight():
    cfg = kimi_vl_a3b.tiny_config().lm
    x = torch.eye(8)[:3]
    router = torch.zeros(8, 8)
    router[0, 0], router[0, 1], router[0, 2] = 3.0, 2.0, 1.0
    bias = torch.zeros(8)
    bias[2] = 0.2  # expert 2 overtakes expert 1 for token 0, not expert 0
    p = {"router": router, "bias": bias}
    idx, w = K.route(p, x, cfg)
    assert idx[0].tolist() == [0, 2]
    s = torch.sigmoid(torch.tensor([3.0, 1.0]))
    torch.testing.assert_close(w[0], s / s.sum() * 2.446)
    # tokens 1 and 2 score every expert alike: the bias takes expert 2,
    # and among the tied rest the lower index comes first
    assert idx[1].tolist() == [2, 0] and idx[2].tolist() == [2, 0]
    ridx, rw, _ = R.route(p, x, kimi_vl_a3b.tiny_dict())
    assert torch.equal(ridx, idx)
    torch.testing.assert_close(rw, w)


def test_no_token_is_dropped_under_skewed_routing():
    cfg, params = _setup()
    p = dict(params["lm"]["layers"][1]["moe"])
    p["bias"] = torch.zeros(8)
    p["bias"][3] = p["bias"][5] = 10.0  # every token picks experts 3 and 5
    x = torch.randn(40, cfg.lm.d_model, generator=torch.Generator()
                    .manual_seed(3))
    idx, w = K.route(p, x, cfg.lm)
    assert set(idx.flatten().tolist()) == {3, 5}
    got = K.routed_experts(p, x, idx, w) + K.swiglu(
        p["shared_gate_up"], p["shared_down"], x)
    want, _ = R.moe(p, x, kimi_vl_a3b.tiny_dict())
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def _cubic_resample(table: np.ndarray, out: int) -> np.ndarray:
    """Bicubic resampling (Keys' kernel, a = -0.75, half-pixel centres,
    edge samples repeated) of a (G, G, d) table to (out, out, d)."""
    a = -0.75

    def w(t):
        t = abs(t)
        if t <= 1:
            return (a + 2) * t ** 3 - (a + 3) * t ** 2 + 1
        if t < 2:
            return a * t ** 3 - 5 * a * t ** 2 + 8 * a * t - 4 * a
        return 0.0

    g = table.shape[0]
    m = np.zeros((out, g))
    for i in range(out):
        x = (i + 0.5) * g / out - 0.5
        f = math.floor(x)
        for k in range(f - 1, f + 3):
            m[i, min(max(k, 0), g - 1)] += w(x - k)
    return np.einsum("ih,jw,hwd->ijd", m, m, table)


def test_position_table_interpolation():
    table = torch.randn(6, 6, 5, generator=torch.Generator().manual_seed(0))
    same = V.moonvit_pos(table, 6, 6).view(6, 6, 5)
    assert torch.equal(same, table)
    for out in (4, 9):
        got = V.moonvit_pos(table, out, out).view(out, out, 5)
        want = _cubic_resample(table.double().numpy(), out)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_merger_order():
    cfg = V.MoonViTConfig(patch=1, d_model=4, n_layers=0, n_heads=1, d_ff=4,
                          pos_grid=4, merge=2)
    # the final LayerNorm keeps (1, -1, 1, -1) and its negation (nearly):
    # patch (r, c) carries its own sign through it
    table = torch.zeros(4, 4, 4)
    for r in range(4):
        for c in range(4):
            table[r, c] = torch.tensor([1.0, -1.0, 1.0, -1.0]) \
                * (1 if (r * 4 + c) % 3 else -1) * (1 + r + 4 * c) / 16
    table = table / table.std(-1, correction=0, keepdim=True)
    params = {"patch": {"w": torch.zeros(4, 3, 1, 1), "b": torch.zeros(4)},
              "pos": table, "blocks": [],
              "final_ln": {"scale": torch.ones(4), "bias": torch.zeros(4)}}
    out = V.moonvit_apply(params, torch.zeros(1, 4, 4, 3), cfg,
                          torch.float32)
    assert out.shape == (1, 4, 16)
    for br in range(2):
        for bc in range(2):
            row = out[0, br * 2 + bc].view(4, 4)
            cells = [(2 * br + dr) * 4 + 2 * bc + dc
                     for dr in range(2) for dc in range(2)]
            want = torch.stack([table[c // 4, c % 4] for c in cells])
            torch.testing.assert_close(row, want, atol=1e-3, rtol=0)


def test_a_tiny_region_description_pod_tick(monkeypatch):
    """Two streams of the registry's ``region_description`` task on the
    tiny model behind ``PodServer.step``: one decode for the tick, every
    request's logits (prefill's last position and each decode step)
    against the reference's full forward of its crop with the fed ids,
    and each result on its region's own box with the class, score and
    tokens its logits give."""
    from repro_torch.core.sroi import Detection
    from repro_torch.data.synthetic import make_video, render_erp
    from repro_torch.kernels.gnomonic.ops import project_srois_batched
    from repro_torch.serving import tasks
    from repro_torch.serving.batching import ShapeBuckets
    from repro_torch.serving.server import PodServer

    cfg, params = _setup()
    task = tasks.get_task("region_description")
    sizes = (16, 24, 32, 40)
    ladder = [dataclasses.replace(v, input_size=s)
              for v, s in zip(task.make_ladder(), sizes)]
    lat = task.make_latency_model()
    videos = [make_video(n_frames=8, n_objects=10, seed=s) for s in (3, 4)]
    frames = [[render_erp(v, f, height=64, width=128) for f in range(3)]
              for v in videos]
    buckets = ShapeBuckets.for_max_batch(4, sizes)
    class_ids = list(range(16, 96))
    backend = tasks.TorchVlmBackend(cfg, params, pre_ids=PRE, post_ids=POST,
                                    class_ids=class_ids, answer_len=3,
                                    buckets=buckets, device="cpu")
    prefilled, seen = [], []
    prefill, generate = backend._prefill, K.generate

    def keep(*args):
        prefilled.append(prefill(*args))
        return prefilled[-1]

    def decode(*args):
        out = generate(*args)
        seen.append((prefilled[:], torch.cat([c.last for c in prefilled]),
                     out[0], out[1]))
        return out
    backend._prefill = keep
    monkeypatch.setattr(K, "generate", decode)
    loops = []
    for v in videos:
        loop = task.make_loop(ladder, lat, backend, 6.0)
        loop.seed_history([Detection(box=d.box.copy(), category=d.category,
                                     score=d.score)
                           for d in v.visible_objects(0)])
        loops.append(loop)
    server = PodServer(loops, [backend] * 2, max_batch=4, buckets=buckets,
                       frame_source=lambda s, f: frames[s][f])
    server.step(1)
    assert len(seen) == 1
    chunks, first, fed, logits = seen[0]
    assert sum(len(c.items) for c in chunks) >= 2
    assert len({c.size for c in chunks}) >= 1
    d = kimi_vl_a3b.tiny_dict()
    r = 0
    for c in chunks:
        for frame, region in c.items:
            crop = project_srois_batched(
                torch.from_numpy(frame)[None], [0], [region.center],
                [region.fov], (c.size, c.size))[0]
            ref, _ = R.forward(params, crop, PRE, POST, fed[:, r], d)
            got = torch.stack([first[r]] + [s[r] for s in logits])
            torch.testing.assert_close(got, ref[-4:], atol=1e-4, rtol=0)
            r += 1
    assert r == len(first)
    r = 0
    for c in chunks:
        for (_, region), dets in zip(c.items, c.out):
            [det] = dets
            np.testing.assert_array_equal(det.box, tasks.region_box(region))
            p = torch.softmax(first[r, class_ids], -1)
            assert det.category == int(p.argmax())
            assert det.score == pytest.approx(float(p.max()))
            assert det.tokens == tuple(int(s[r].argmax()) for s in logits)
            r += 1
    assert all(loop._history[-1] for loop in loops)


def test_region_description_streams_from_the_registry():
    """``build_task_streams`` makes ``region_description`` streams with
    the task's oracle: a mixed pod with detection serves both, and each
    description sits on its region's own box."""
    from repro_torch.data.synthetic import make_video
    from repro_torch.serving import tasks
    from repro_torch.serving.server import PodServer

    videos = [make_video(n_frames=8, n_objects=12, seed=s) for s in (5, 6)]
    variants, loops, backends, cost_fn = tasks.build_task_streams(
        ["detection", "region_description"], videos, [6.0, 6.0])
    assert [v.name for v in variants][-4:] == [n for n, _ in tasks.VLM_LADDER]
    assert loops[1].task == "region_description"
    for loop, v in zip(loops, videos):
        loop.seed_history(v.visible_objects(0))
    server = PodServer(loops, backends)
    for f in range(1, 4):
        server.step(f)
    assert server.stats.frames_by_task["region_description"] == 3
    last = loops[1]._history[-1]
    assert last and all(isinstance(d, tasks.DescribedRegion) for d in last)
