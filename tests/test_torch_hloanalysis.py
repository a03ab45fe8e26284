"""The dispatch-level counter (``repro_torch.launch.hloanalysis``) and the
dry run (``repro_torch.launch.dryrun``) against the reference's HLO
analyser.

The twins of ``tests/test_hloanalysis.py`` come first: a loop against
the same loop unrolled, trip-count scaling, a convolution's FLOPs,
bytes and collectives.  Then, per family, the port's step on a smoke
config counted on fake tensors against the reference's
``analyze(jax.jit(step).lower(...).compile().as_text())["flops"]`` on
the same cell.  The forward kinds (serve, prefill, decode, denoise)
count the same FLOPs to 1e-9 relative, except where the reference's
count is pinned below to a hand count:

* ResNet-50 serving at 64 px reads 1.0244 (port / reference).  The
  port counts every convolution as ``2 * out * k^2 * cin``, padding
  taps included, which is the hand count of the smoke config's convs
  (:func:`_resnet_conv_flops`).  XLA's CPU compiler rewrites the one 3x3
  "SAME" convolution over a 2x2 map (stage 3's second block) as a 2x2
  window over the map with the kernel as its input, so the reference
  counts that conv's 4 live taps of 9: 1310720 FLOPs fewer.  The port
  is right by the convention every other conv on both sides follows.
* The train kinds count the backward too.  With remat on, both
  packages recompute alike and the LMs and flux count the same FLOPs.
  The LM smoke configs have ``remat=False``: the port then saves the
  attention and CE chunks' scores, while the reference rematerialises
  its attention chunk and its CE chunk whatever ``remat`` says
  (``repro/models/transformer.py:240`` and ``:594``), one recomputed
  product a chunk (the scores, the logits): 0.948 for smollm and 0.963
  for mixtral, pinned to those products exactly
  (:func:`_lm_chunk_recompute`).  ResNet-50's train step reads 0.795 at
  128 px: XLA computes a stride-2 conv's input gradient as a conv over
  the output gradient dilated by 2, and the reference counts the
  dilation's zeros, 4 taps for each live one, so each stride-2 conv
  costs 3 forward passes more there (:func:`_strided_conv_flops`); the
  port counts the input gradient as one forward pass, the usual
  convention.

``hbm_bytes`` follow another model on each side (every eager op's I/O
against XLA's fusions' I/O), so they are checked on their own terms.
"""

from __future__ import annotations

import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import base as jbase
from repro.launch import cells as jcells
from repro.launch.hloanalysis import analyze as janalyze
from repro_torch.configs import base as tbase
from repro_torch.kernels import _build
from repro_torch.launch import cells as tcells
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.hloanalysis import analyze


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    """Two intra-op threads, restored after (xdist's processes share the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- twins of tests/test_hloanalysis.py ---------------------------------------


def _scan_fn(xs, w):
    c = xs[0]
    for x in xs.unbind(0):
        c = torch.relu(c @ w) + x
    return torch.sum(c)


def _unrolled_fn(xs, w):
    c = xs[0]
    for i in range(xs.shape[0]):
        c = torch.relu(c @ w) + xs[i]
    return torch.sum(c)


def _jscan_fn(xs, w):
    def body(c, x):
        return jax.nn.relu(c @ w) + x, None
    c, _ = jax.lax.scan(body, xs[0], xs)
    return jnp.sum(c)


N_STEPS = 6


def test_loop_matches_unrolled_and_the_reference_scan():
    """The loop counts 6 products of 64^3 MACs, as its unrolled form and
    as the reference's trip-count-aware count of its scan."""
    fake = FakeTensorMode()
    with fake:
        xs, w = torch.empty(N_STEPS, 64, 64), torch.empty(64, 64)
        a_loop = analyze(_scan_fn, xs, w)
        a_unr = analyze(_unrolled_fn, xs, w)
    exact = N_STEPS * 2 * 64 ** 3
    assert a_loop["flops"] == a_unr["flops"] == exact
    ref = janalyze(jax.jit(_jscan_fn).lower(
        jax.ShapeDtypeStruct((N_STEPS, 64, 64), jnp.float32),
        jax.ShapeDtypeStruct((64, 64), jnp.float32)).compile().as_text())
    assert ref["flops"] == exact


def test_trip_count_scaling():
    fake = FakeTensorMode()
    with fake:
        w = torch.empty(64, 64)
        f2 = analyze(_scan_fn, torch.empty(2, 64, 64), w)
        f8 = analyze(_scan_fn, torch.empty(8, 64, 64), w)
    assert f8["flops"] / f2["flops"] == 4.0


def test_conv_flops():
    def f(x, k):
        return F.conv2d(x, k, padding=1)

    want = 2 * 2 * 16 * 16 * 32 * 3 * 3 * 8  # 2*out_numel*k_spatial*cin
    fake = FakeTensorMode()
    with fake:
        a = analyze(f, torch.empty(2, 8, 16, 16), torch.empty(32, 8, 3, 3))
    assert a["flops"] == want

    def jf(x, k):
        return jax.lax.conv_general_dilated(
            x, k, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    ref = janalyze(jax.jit(jf).lower(
        jax.ShapeDtypeStruct((2, 16, 16, 8), jnp.float32),
        jax.ShapeDtypeStruct((3, 3, 8, 32), jnp.float32)).compile().as_text())
    assert ref["flops"] == want


def test_single_mm_bytes_and_no_collectives():
    """One ``mm`` reads both operands once and writes its result once."""
    m, k, n = 48, 96, 80
    a = analyze(torch.mm, torch.ones(m, k), torch.ones(k, n))
    assert a["flops"] == 2 * m * k * n
    assert a["hbm_bytes"] == 4 * (m * k + k * n + m * n)
    assert a["n_ops"] == 1
    assert a["collective_bytes"] == 0
    assert all(v == {"bytes": 0.0, "count": 0.0}
               for v in a["collectives"].values())


def test_views_count_zero():
    def views(x):
        y = x.t().reshape(8, 4).unsqueeze(0).expand(3, 8, 4)
        return y[..., :2].permute(2, 0, 1).detach()

    fake = FakeTensorMode()
    with fake:
        x = torch.empty(4, 8)
        a = analyze(views, x)
        # a copy is not a view: the transposed reshape materialises
        b = analyze(lambda t: t.t().contiguous(), x)
        # a broadcast operand is read once: add of (4, 8) and a (1, 8) row
        c = analyze(lambda t: t + t[:1].expand(4, 8), x)
    assert (a["hbm_bytes"], a["n_ops"], a["flops"]) == (0, 0, 0)
    assert (b["hbm_bytes"], b["n_ops"]) == (2 * 4 * 32, 1)
    assert c["hbm_bytes"] == 4 * (32 + 8 + 32)


def test_float32_output_products():
    """The float32-output overloads (``bmm.dtype``: the MoE experts' bf16
    products on the card; a meta kernel here) count as their plain
    forms, their output written in float32."""
    fake = FakeTensorMode()
    with fake:
        a = torch.empty(3, 16, 32, dtype=torch.bfloat16)
        w = torch.empty(3, 32, 8, dtype=torch.bfloat16)
        got = analyze(lambda x, y: torch.bmm(x, y, out_dtype=torch.float32),
                      a, w)
        plain = analyze(torch.bmm, a, w)
    assert got["flops"] == plain["flops"] == 2 * 3 * 16 * 32 * 8
    assert got["hbm_bytes"] == plain["hbm_bytes"] + 3 * 16 * 8 * 2


def test_flops_split_by_operand_dtype():
    """``flops_by_dtype`` prices each product by its operands' dtype: a
    bf16 product (also its float32-output overload) under ``bfloat16``,
    a float32 convolution under ``float32``; the parts sum to ``flops``."""
    fake = FakeTensorMode()
    with fake:
        a = torch.empty(3, 16, 32, dtype=torch.bfloat16)
        w = torch.empty(3, 32, 8, dtype=torch.bfloat16)
        x, k = torch.empty(2, 3, 8, 8), torch.empty(5, 3, 3, 3)
        got = analyze(lambda: (torch.bmm(a, w, out_dtype=torch.float32),
                               torch.nn.functional.conv2d(x, k)))
    bf16, f32 = 2 * 3 * 16 * 32 * 8, 2 * (2 * 5 * 6 * 6) * (3 * 3 * 3)
    assert got["flops_by_dtype"] == {"bfloat16": bf16, "float32": f32}
    assert got["flops"] == bf16 + f32


def test_fake_and_real_tensors_count_alike():
    def f(x, w):
        return torch.softmax(torch.relu(x @ w) * 2.0, dim=-1).sum(0)

    xr, wr = torch.randn(16, 32), torch.randn(32, 24)
    real = analyze(f, xr, wr, detail=True)
    fake = FakeTensorMode()
    with fake:
        fk = analyze(f, torch.empty(16, 32), torch.empty(32, 24), detail=True)
    for key in ("flops", "flops_by_dtype", "hbm_bytes", "n_ops", "top_flops",
                "top_bytes"):
        assert real[key] == fk[key], key
    assert real["top_flops"] == [(2 * 16 * 32 * 24, "aten.mm")]


def test_collectives_by_kind(tmp_path):
    """The functional collectives' operand bytes, by the reference's
    kinds (a one-rank gloo group, on the CPU)."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fcoll

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        x = torch.ones(4, 8)

        def f(t):
            y = fcoll.all_reduce(t, "sum", dist.group.WORLD)
            z = fcoll.all_gather_tensor(t, 0, dist.group.WORLD)
            return y + 0, z + 0

        a = analyze(f, x)
    finally:
        dist.destroy_process_group()
    assert a["collectives"]["all-reduce"] == {"bytes": 128.0, "count": 1.0}
    assert a["collectives"]["all-gather"] == {"bytes": 128.0, "count": 1.0}
    assert a["collective_bytes"] == 256.0


def test_refuses_a_kernel_launch():
    """A ctypes launch is invisible to the dispatcher: a call whose
    kernel launch count moves raises."""
    def launches(x):
        _build.count("flash_attention")
        return x * 2

    before = _build.launch_counts()
    try:
        with pytest.raises(RuntimeError, match="flash_attention"):
            analyze(launches, torch.ones(3))
    finally:
        _build.reset_launch_counts()
        for k, v in before.items():
            for _ in range(v):
                _build.count(k)


# -- smoke cells against the reference's HLO count -----------------------------

_FAMILY = {"lm": "_lm_cell", "vision": "_vision_cell",
           "diffusion": "_diffusion_cell"}


def _cells(arch_id: str, shape: tbase.ShapeSpec, **cfg_kw):
    """The port's and the reference's cell of ``arch_id``'s smoke config
    at ``shape`` (``cfg_kw`` replaced in both configs)."""
    out = []
    for base, mod, spec in ((tbase, tcells, shape),
                            (jbase, jcells,
                             jbase.ShapeSpec(**dataclasses.asdict(shape)))):
        arch = base.get_arch(arch_id)
        cfg = dataclasses.replace(arch.smoke, **cfg_kw)
        arch = dataclasses.replace(arch, config=cfg)
        out.append(getattr(mod, _FAMILY[arch.family])(arch, spec))
    return out


def _counts(arch_id, shape, **cfg_kw):
    tcell, jcell = _cells(arch_id, shape, **cfg_kw)
    got = dryrun.count_cell(tcell, "cpu")["flops"]
    ref = janalyze(jax.jit(jcell.step).lower(
        *jcell.abstract_args).compile().as_text())["flops"]
    return got, ref, tcell


def _lm(kind, s=64, b=2):
    return tbase.ShapeSpec("smoke", kind, seq_len=s, global_batch=b)


def _img(kind, res, b=2):
    return tbase.ShapeSpec("smoke", kind, img_res=res, batch=b)


FORWARD = [
    ("smollm_135m", _lm("prefill")),
    ("smollm_135m", _lm("decode")),
    ("mixtral_8x22b", _lm("prefill")),
    ("vit_b16", _img("serve", 32)),
    ("convnext_b", _img("serve", 64)),
    ("flux_dev", _img("generate", 64)),
    ("unet_sdxl", _img("generate", 128)),
]


@pytest.mark.parametrize("arch_id,shape", FORWARD,
                         ids=[f"{a}-{s.kind}" for a, s in FORWARD])
def test_forward_flops_match_reference(arch_id, shape):
    got, ref, _ = _counts(arch_id, shape)
    assert got > 0
    assert abs(got - ref) <= 1e-9 * ref


def _resnet_conv_flops(cfg, res: int, b: int) -> int:
    """The smoke ResNet's serve FLOPs by hand: 2 * out * k^2 * cin a
    conv (v1.5: the stride on the 3x3 conv and the projection), plus the
    head."""
    w = cfg.width
    f = 2 * b * (res // 2) ** 2 * 49 * 3 * w  # 7x7 stem, stride 2
    r, c_in = res // 4, w  # after the 3x3 max pool, stride 2
    for i, depth in enumerate(cfg.depths):
        mid, r_out = w * 2 ** i, (r if i == 0 else r // 2)
        out = 4 * mid
        f += 2 * b * r * r * c_in * mid  # conv1 at the input's size
        f += 2 * b * r_out ** 2 * (9 * mid * mid + mid * out + c_in * out)
        f += (depth - 1) * 2 * b * r_out ** 2 * (2 * out * mid + 9 * mid * mid)
        r, c_in = r_out, out
    return f + 2 * b * c_in * cfg.n_classes


def test_resnet_forward_flops_pinned():
    """1.0244: the port's count is the hand count; the reference's
    misses the padding taps of the one conv XLA rewrites (module doc)."""
    res, b = 64, 2
    got, ref, cell = _counts("resnet_50", _img("serve", res, b))
    cfg = tbase.get_arch("resnet_50").smoke
    assert got == _resnet_conv_flops(cfg, res, b)
    mid = cfg.width * 8  # stage 3, its 2x2 map at 64 px
    assert res // 32 == 2
    assert ref == got - 2 * b * 2 * 2 * mid * (9 - 4) * mid
    assert round(got / ref, 4) == 1.0244


def _lm_chunk_recompute(cfg, s: int, b: int) -> int:
    """The products the reference recomputes in the backward whatever
    ``remat`` says: each attention chunk's scores and each CE chunk's
    logits."""
    n_attn = -(-s // cfg.attn_chunk)
    n_ce = -(-s // cfg.ce_chunk)
    scores = 2 * b * cfg.n_heads * s * cfg.attn_chunk * cfg.d_head
    logits = 2 * b * cfg.ce_chunk * cfg.d_model * cfg.vocab_size
    return cfg.n_layers * n_attn * scores + n_ce * logits


@pytest.mark.parametrize("arch_id,ratio", [("smollm_135m", 0.9482),
                                           ("mixtral_8x22b", 0.9629)])
def test_lm_train_flops(arch_id, ratio):
    """Without remat the reference still recomputes its attention and CE
    chunks' products (the gap, exactly); with remat both count alike."""
    s, b = 64, 2
    got, ref, cell = _counts(arch_id, _lm("train", s, b))
    cfg = tbase.get_arch(arch_id).smoke
    assert not cfg.remat
    assert ref == got + _lm_chunk_recompute(cfg, s, b)
    assert round(got / ref, 4) == ratio
    got_r, ref_r, _ = _counts(arch_id, _lm("train", s, b), remat=True)
    assert got_r > got and abs(got_r - ref_r) <= 1e-9 * ref_r


def _strided_conv_flops(cfg, res: int, b: int) -> int:
    """Forward FLOPs of the smoke ResNet's stride-2 convs that take an
    input gradient: each later stage's first 3x3 conv and projection
    (the stem's input, the images, takes none)."""
    w, f = cfg.width, 0
    r = res // 4
    for i in range(1, len(cfg.depths)):
        mid, r = w * 2 ** i, r // 2
        f += 2 * b * r * r * (9 * mid * mid + (2 * mid) * (4 * mid))
    return f


def test_resnet_train_flops_pinned():
    """0.795: the reference counts a stride-2 conv's input gradient over
    the dilated output gradient, 4x its taps (module doc)."""
    res, b = 128, 2
    got, ref, _ = _counts("resnet_50", _img("train", res, b))
    cfg = tbase.get_arch("resnet_50").smoke
    assert ref == got + 3 * _strided_conv_flops(cfg, res, b)
    assert round(got / ref, 3) == 0.795


def test_flux_train_flops_match_reference():
    got, ref, _ = _counts("flux_dev", _img("train", 64))
    assert abs(got - ref) <= 1e-9 * ref


# -- the dry run ---------------------------------------------------------------


def test_dryrun_cli_one_cell(capsys, monkeypatch, tmp_path):
    """``--device cpu`` on ViT-B/16 ``serve_b1`` at its published size:
    the ``[OK]`` line, the record's keys, the unknown fields ``null``
    with their ``why``; again ``[CACHED]``, a skipped cell ``[SKIP]``,
    an unknown shape ``[FAIL]`` and a non-zero exit."""
    out = str(tmp_path)
    argv = ["--arch", "vit_b16", "--shape", "serve_b1", "--device", "cpu",
            "--out", out]
    dryrun.main(argv)
    line = capsys.readouterr().out.strip()
    assert re.fullmatch(r"\[OK\] vit_b16__serve_b1__singlepod: count=\S+s "
                        r"flops=\S+ bytes=\S+B args=\S+B/device "
                        r"dominant=memory_s frac=\S+", line), line
    rec = json.loads((tmp_path / "vit_b16__serve_b1__singlepod.json"
                      ).read_text())
    assert {"arch", "shape", "kind", "mesh", "mesh_axes", "devices",
            "count_s", "memory", "hlo_flops", "hlo_bytes",
            "collective_bytes", "collectives_per_device", "model_flops",
            "comment", "why", "roofline"} <= set(rec)
    assert rec["mesh"] == [16, 16] and rec["devices"] == 256
    assert rec["hlo_flops"] == dryrun.count_cell(
        tcells.build_cell("vit_b16", "serve_b1"))["flops"]
    nulls = {"collective_bytes": rec["collective_bytes"],
             "memory.temp_size_in_bytes": rec["memory"]["temp_size_in_bytes"],
             "memory.output_size_in_bytes":
                 rec["memory"]["output_size_in_bytes"]}
    assert all(v is None for v in nulls.values())
    assert set(nulls) <= set(rec["why"]) and all(rec["why"].values())
    assert rec["memory"]["argument_size_in_bytes"] == tcells.build_cell(
        "vit_b16", "serve_b1").argument_bytes_per_device(
            tmesh.make_production_mesh())
    r = rec["roofline"]
    assert "collective_s" not in r
    assert r["compute_s"] == rec["hlo_flops"] / (256 * 989e12)
    assert r["memory_s"] == rec["hlo_bytes"] / (256 * 3.35e12)
    assert r["useful_flops_ratio"] == rec["model_flops"] / rec["hlo_flops"]

    # --all over a cached cell and a skipped one
    monkeypatch.setattr(tcells, "iter_cells", lambda: iter([
        ("vit_b16", "serve_b1", None),
        ("smollm_135m", "long_500k", "SKIP(full-attention): ...")]))
    dryrun.main(["--all", "--device", "cpu", "--out", out])
    assert capsys.readouterr().out.splitlines() == [
        "[CACHED] vit_b16__serve_b1__singlepod",
        "[SKIP] smollm_135m__long_500k__singlepod: SKIP(full-attention): ..."]
    with pytest.raises(SystemExit, match="1 cells failed"):
        dryrun.main(["--arch", "vit_b16", "--shape", "nope", "--device",
                     "cpu", "--out", out])
    assert "[FAIL] vit_b16__nope__singlepod" in capsys.readouterr().out
