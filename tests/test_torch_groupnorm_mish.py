"""The detector's norm-activation tail, ``kernels/groupnorm``:
``[residual +] mish(groupnorm(x))`` as one CUDA kernel beside the plain
composition ``L.mish(L.groupnorm(...))`` it replaces.

On the CPU (tier 1): the wrapper is the plain composition bit for bit,
autograd and bfloat16 included; on fake CUDA tensors it sends float32
without gradients to the kernel and refuses bfloat16 and autograd; it
refuses what it does not take; the detector takes the tail its
``norm_act_impl`` names and counts one ``norm_act.calls`` a conv block.

On the card (marked ``cuda``; this file imports no JAX):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_groupnorm_mish.py

Tolerance of the kernel against the plain composition on the card, from
float32 rounding.  Both compute a slab's mean and variance as float32
sums of its n elements in another order: a sum reordered into a tree of
depth h is within h·u·Σ|x| of the exact one (u = 2^-24), so the two
moments are within ~h·u·(|μ| + σ) and ~2h·u·σ² of the exact ones.  The
plain side's tree is at most ceil(n / 256) + 16 deep (a Welford loop a
thread, then the warps' and the block's trees), the kernel's ceil(n /
2048) + 15, and a Welford step rounds up to four times; so with h =
2·(ceil(n / 256) + 16), the normalised value z = (x - μ) / σ of the two
differs by at most 8·h·u·κ·(1 + |z|), κ = 1 + |μ| / σ.  The affine
scales that by |γ|, Mish's slope is below 1.1, and the libm calls and
the residual add round once more each: tol = 1.1·|γ|·8·h·u·κ·(1 + |z|)
+ 4·u·|ref|, element by element, with μ, σ and z in float64.  A slab of
equal values has σ = 0 and both sides the exact mean, so there only the
affine's roundings differ: 1.1·4·u·(|a·x| + |β|) + 4·u·|ref|.
"""

from __future__ import annotations

import dataclasses
import math

import pytest
import torch

from repro_torch import tracing
from repro_torch.kernels import _build
from repro_torch.kernels.groupnorm import ops
from repro_torch.kernels.groupnorm.ref import groupnorm_mish_ref
from repro_torch.models import detector as det_mod
from repro_torch.models import layers as L

U = 2.0 ** -24


def _inputs(shape, seed, *, device="cpu", spread=1.0):
    """Conv-output-like x (a per-channel offset on unit noise), the group
    norm's scale and bias, and a residual of x's shape."""
    g = torch.Generator().manual_seed(seed)
    n, c, h, w = shape
    x = (torch.randn(shape, generator=g)
         + spread * (torch.rand((1, c, 1, 1), generator=g) * 2 - 1))
    scale = torch.rand(c, generator=g) + 0.5
    bias = torch.rand(c, generator=g) - 0.5
    res = torch.randn(shape, generator=g)
    return [t.to(device) for t in (x, scale, bias, res)]


# -- CPU ---------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 16, 6, 6), (1, 48, 5, 7),
                                   (3, 5, 4, 4)])
@pytest.mark.parametrize("with_res", [False, True])
def test_wrapper_on_cpu_is_the_plain_composition(shape, with_res):
    x, scale, bias, res = _inputs(shape, 1)
    want = L.mish(L.groupnorm({"scale": scale, "bias": bias}, x))
    if with_res:
        want = res + want
    got = ops.groupnorm_mish(x, scale, bias,
                             residual=res if with_res else None)
    assert torch.equal(got, want)


def test_dispatch_sends_autograd_and_bf16_to_the_plain_path(monkeypatch):
    """On the CPU autograd and bfloat16 take the plain composition; on
    the card (fake CUDA tensors here) float32 without gradients takes the
    kernel and the wrapper refuses the rest, which a caller sends to the
    plain tail through ``norm_act_impl="plain"``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    class Launched(Exception):
        pass

    def bind(*_):
        raise Launched
    plain = []

    def ref(x, *args, **kwargs):  # records the call, computes nothing
        plain.append(x.dtype)
        return x
    monkeypatch.setattr(_build, "bind", bind)
    with FakeTensorMode():
        x = torch.empty(2, 8, 4, 4, device="cuda")
        scale = torch.ones(8, device="cuda")
        bias = torch.zeros(8, device="cuda")
        with pytest.raises(Launched):  # float32, no gradient: the kernel
            ops.groupnorm_mish(x, scale, bias, residual=x.clone())
        with pytest.raises(TypeError, match="norm_act_impl='plain'"):
            ops.groupnorm_mish(x.bfloat16(), scale, bias)
        with pytest.raises(TypeError, match="float32"):
            ops.groupnorm_mish(x, scale, bias, residual=x.bfloat16())
        xg = x.clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            ops.groupnorm_mish(xg, scale, bias)
        sg = scale.clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            ops.groupnorm_mish(x, sg, bias)
        with torch.no_grad(), pytest.raises(Launched):
            ops.groupnorm_mish(xg, scale, bias)
    # on the CPU every dtype and autograd take the plain path
    monkeypatch.setattr(ops, "groupnorm_mish_ref", ref)
    x, scale, bias, _ = _inputs((1, 8, 3, 3), 2)
    ops.groupnorm_mish(x.clone().requires_grad_(True), scale, bias)
    ops.groupnorm_mish(x.bfloat16(), scale, bias)
    assert plain == [torch.float32, torch.bfloat16]
    monkeypatch.undo()
    xg = x.clone().requires_grad_(True)
    ops.groupnorm_mish(xg, scale, bias).sum().backward()
    assert xg.grad is not None and torch.isfinite(xg.grad).all()


def test_wrapper_refuses_what_it_does_not_take():
    x, scale, bias, res = _inputs((2, 8, 4, 4), 3)
    with pytest.raises(ValueError, match="NCHW"):
        ops.groupnorm_mish(x[0], scale, bias)
    with pytest.raises(ValueError, match="scale and bias"):
        ops.groupnorm_mish(x, scale[:4], bias)
    with pytest.raises(ValueError, match="residual"):
        ops.groupnorm_mish(x, scale, bias, residual=res[:1])


@pytest.mark.parametrize("impl", ["fused", "plain"])
def test_detector_takes_the_tail_its_config_names(impl, monkeypatch):
    """``norm_act_impl`` picks the wrapper or the plain composition for
    every conv block, on any device; both count ``norm_act.calls`` and
    give the same heads on the CPU, where the wrapper is the plain
    composition."""
    cfg = det_mod.DetectorConfig("t", 32, width_mult=0.25, depth_mult=0.34,
                                 n_classes=2, norm_act_impl=impl)
    params = det_mod.init_params(torch.Generator().manual_seed(6), cfg)
    images = torch.rand(1, 32, 32, 3,
                        generator=torch.Generator().manual_seed(7))
    wrapped = []
    orig = ops.groupnorm_mish

    def spy(x, *args, **kwargs):
        wrapped.append(x.shape)
        return orig(x, *args, **kwargs)
    monkeypatch.setattr(ops, "groupnorm_mish", spy)
    tracing.reset()
    try:
        tracing.begin_tick(0)
        outs = det_mod.apply(params, images, cfg)
        tracing.end_tick()
        calls = tracing.tick_counters(0)["norm_act.calls"]
    finally:
        tracing.reset()
    assert len(wrapped) == (calls if impl == "fused" else 0) and calls > 0
    plain = det_mod.apply(params, images, dataclasses.replace(
        cfg, norm_act_impl="plain"))
    assert all(torch.equal(a, b) for a, b in zip(outs, plain))


def test_detector_refuses_an_unknown_tail():
    cfg = det_mod.DetectorConfig("t", 32, width_mult=0.25, n_classes=2,
                                 norm_act_impl="pallas")
    params = det_mod.init_params(torch.Generator().manual_seed(8), cfg)
    with pytest.raises(ValueError, match="norm_act_impl"):
        det_mod.apply(params, torch.rand(1, 32, 32, 3), cfg)


def _block_shapes(cfg) -> list[tuple[int, int, int]]:
    """Every distinct (C, H, W) that ``cfg``'s conv blocks normalise, in
    the order of a forward: ``apply`` on the meta device."""
    seen: dict = {}
    orig = ops.groupnorm_mish

    def spy(x, *args, **kwargs):
        seen.setdefault(tuple(x.shape[1:]), None)
        return orig(x, *args, **kwargs)
    params = det_mod.init_params(torch.Generator().manual_seed(0), cfg,
                                 device="meta")
    images = torch.empty(1, cfg.input_size, cfg.input_size, 3, device="meta")
    ops.groupnorm_mish = spy
    try:
        det_mod.apply(params, images, cfg)
    finally:
        ops.groupnorm_mish = orig
    return list(seen)


def test_detector_counts_one_call_a_conv_block_and_passes_the_residual():
    cfg = det_mod.DetectorConfig("t", 64, width_mult=0.25, depth_mult=0.34,
                                 n_classes=3)
    params = det_mod.init_params(torch.Generator().manual_seed(4), cfg)
    images = torch.rand(1, 64, 64, 3,
                        generator=torch.Generator().manual_seed(5))
    calls = []
    orig = ops.groupnorm_mish

    def spy(x, *args, residual=None, **kwargs):
        calls.append(residual is not None)
        return orig(x, *args, residual=residual, **kwargs)
    tracing.reset()
    try:
        ops.groupnorm_mish = spy
        tracing.begin_tick(0)
        det_mod.apply(params, images, cfg)
        tracing.end_tick()
        counters = tracing.tick_counters(0)
    finally:
        ops.groupnorm_mish = orig
        tracing.reset()
    # stem, stem2; per stage down + split1, split2, fuse + 2 a bottleneck;
    # per FPN level lateral + a CSP block of one bottleneck; a head conv a
    # scale
    depth = cfg.depth
    want = (2 + 3 * (1 + 3 + 2 * depth) + 2 * (1 + 3 + 2 * max(1, depth // 2))
            + 3)
    assert counters["norm_act.calls"] == len(calls) == want
    assert sum(calls) == 3 * depth + 2 * max(1, depth // 2)
    assert "launch.groupnorm_mish" not in counters  # the CPU: plain path
    # the p6 rung's shapes: the stem's 819,200-element slabs among them
    assert (64, 640, 640) in _block_shapes(det_mod.PAPER_LADDER[-1])


# -- the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _build.build_all()
    return torch.device("cuda")


def _tolerance(x, scale, bias, ref, groups):
    """The element-wise bound of the module docstring, in float64."""
    n, c, h, w = x.shape
    xd = x.double().reshape(n, groups, -1)
    size = xd.shape[-1]
    mu = xd.mean(-1, keepdim=True)
    sigma = xd.var(-1, keepdim=True, correction=0).sqrt()
    depth = 2 * (math.ceil(size / 256) + 16)
    gamma = scale.double().abs().repeat_interleave(h * w).reshape(1, groups,
                                                                   -1)
    beta = bias.double().abs().repeat_interleave(h * w).reshape(1, groups, -1)
    flat = sigma == 0
    safe = torch.where(flat, torch.ones_like(sigma), sigma)
    kappa = 1 + mu.abs() / safe
    z = (xd - mu) / safe
    spread = 1.1 * gamma * 8 * depth * U * kappa * (1 + z.abs())
    rstd = 1 / math.sqrt(1e-5)
    affine = 1.1 * 4 * U * (xd.abs() * rstd * gamma + beta)
    tol = torch.where(flat, affine, spread)
    return tol.reshape(x.shape) + 4 * U * ref.double().abs()


def _exact_tail(x, scale, bias, *, residual=None, eps=1e-5):
    """The plain composition in the inputs' precision throughout, float64
    here (``L.groupnorm`` normalises in float32)."""
    y = torch.nn.functional.group_norm(x, L.num_groups(x.shape[1]), scale,
                                       bias, eps)
    m = y * torch.tanh(torch.nn.functional.softplus(y))
    return m if residual is None else residual + m


def _check(x, scale, bias, res=None, what=""):
    """The kernel against the plain composition within the bound of the
    module docstring, and both against the tail in float64: the kernel
    at most twice as far from it as the plain composition (+ 1e-6), which
    statistics in a narrower precision than float32 would not be."""
    got = ops.groupnorm_mish(x, scale, bias, residual=res)
    want = groupnorm_mish_ref(x, scale, bias, residual=res)
    g = L.num_groups(x.shape[1])
    tol = _tolerance(x, scale, bias, want, g)
    err = (got.double() - want.double()).abs()
    over = err > tol
    assert not over.any(), (
        f"{what} {tuple(x.shape)}: {int(over.sum())} elements beyond the "
        f"bound, worst |err| {float(err.max()):.3g}")
    assert torch.isfinite(got).all() == torch.isfinite(want).all()
    del err, over, tol
    exact = _exact_tail(x.double(), scale.double(), bias.double(),
                        residual=None if res is None else res.double())
    err_k = float((got.double() - exact).abs().max())
    err_p = float((want.double() - exact).abs().max())
    assert err_k <= 2 * err_p + 1e-6, (
        f"{what} {tuple(x.shape)}: {err_k} from float64, the plain "
        f"composition {err_p}")


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("with_res", [False, True])
def test_cuda_groupnorm_mish_at_every_ladder_shape(cuda, batch, with_res):
    shapes = {}
    for cfg in det_mod.PAPER_LADDER:
        for s in _block_shapes(cfg):
            shapes.setdefault(s, cfg.name)
    before = _build.launch_counts().get("groupnorm_mish", 0)
    for i, ((c, h, w), name) in enumerate(shapes.items()):
        x, scale, bias, res = _inputs((batch, c, h, w), 10 + i, device=cuda)
        _check(x, scale, bias, res if with_res else None,
               f"{name} B={batch}")
        del x, res
    launched = _build.launch_counts().get("groupnorm_mish", 0) - before
    assert launched == len(shapes)


@pytest.mark.cuda
def test_cuda_groupnorm_mish_edge_cases(cuda):
    # the p6 stem's 819,200-element slabs (a cluster of 8 CTAs a slab)
    x, scale, bias, res = _inputs((8, 64, 640, 640), 30, device=cuda)
    _check(x, scale, bias, res, "p6 stem")
    del x, res
    # tiny-416's 1-channel groups, at 208² and at a 13² grid (169 floats a
    # slab: the one-float-at-a-time path)
    for shape in ((8, 16, 208, 208), (8, 16, 13, 13), (2, 128, 13, 13)):
        x, scale, bias, res = _inputs(shape, 31, device=cuda)
        _check(x, scale, bias, res, "1-channel groups")
    # a view one float into its storage: not 16-byte aligned
    x, scale, bias, res = _inputs((2, 32, 20, 20), 32, device=cuda)
    buf = torch.empty(x.numel() + 1, device=cuda)
    xv = buf[1:].view(x.shape)
    xv.copy_(x)
    _check(xv, scale, bias, res, "unaligned")
    # slabs of one value (variance 0), one constant a group
    x = torch.arange(8 * 32, dtype=torch.float32, device=cuda)
    x = (x.reshape(8, 32, 1, 1) * 0.37 - 40).repeat_interleave(2, 1)
    x = x.expand(8, 64, 40, 40).contiguous()
    _check(x, scale.repeat(2), bias.repeat(2), None, "constant slabs")
    # the affine past softplus's threshold (20) and past expf's underflow
    x, scale, bias, res = _inputs((4, 64, 40, 40), 33, device=cuda)
    scale = scale * 40
    y = L.groupnorm({"scale": scale, "bias": bias}, x)
    assert bool((y > 20).any()) and bool((y < -88).any())
    _check(x, scale, bias, res, "large affine")


@pytest.mark.cuda
def test_cuda_detector_p6_against_the_plain_path(cuda, monkeypatch):
    """yolo-p6-1280 at batch 8 through the kernel and through the plain
    path, each held to the same forward in float64: the kernel's heads
    may be at most twice as far from it as the plain path's (+ 1e-6).
    So the two paths' heads differ by at most tol = err_kernel +
    err_plain, and every cell whose best two class logits lie more than
    2 tol apart on the plain path keeps its class.  ``decode``'s top 16:
    with d the largest difference of a cell's score between the paths, a
    sort moves no value by more than d, and a rank whose score lies more
    than 2 d from its neighbours' holds the same cell on both paths, so
    its class agrees."""
    cfg = det_mod.PAPER_LADDER[-1]
    params = det_mod.init_params(torch.Generator(device=cuda).manual_seed(7),
                                 cfg, device=cuda)
    images = torch.rand(8, 1280, 1280, 3, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(8))
    cfg_plain = dataclasses.replace(cfg, norm_act_impl="plain")
    cfg64 = dataclasses.replace(cfg_plain, param_dtype=torch.float64,
                                compute_dtype=torch.float64)
    with torch.inference_mode():
        before = _build.launch_counts().get("groupnorm_mish", 0)
        fused = det_mod.apply(params, images, cfg)
        assert _build.launch_counts()["groupnorm_mish"] - before == 64
        plain = det_mod.apply(params, images, cfg_plain)
        assert _build.launch_counts()["groupnorm_mish"] - before == 64
        monkeypatch.setattr(det_mod, "groupnorm_mish_ref", _exact_tail)
        exact = det_mod.apply(_to_double(params), images.double(), cfg64)
    tol = 0.0
    for i, (f, p, e) in enumerate(zip(fused, plain, exact)):
        err_f = float((f.double() - e.double()).abs().max())
        err_p = float((p.double() - e.double()).abs().max())
        assert err_f <= 2 * err_p + 1e-6, (i, err_f, err_p)
        tol = max(tol, err_f + err_p)
    for i, (f, p) in enumerate(zip(fused, plain)):
        top2 = p[..., 5:].topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > 2 * tol
        assert bool(clear.any()), i
        same = f[..., 5:].argmax(-1) == p[..., 5:].argmax(-1)
        assert bool(same[clear].all()), i
    d = float((_cell_scores(fused) - _cell_scores(plain)).abs().max())
    _, sf, cf = det_mod.decode(fused, cfg, conf_threshold=0.0, max_det=16)
    _, sp, cp = det_mod.decode(plain, cfg, conf_threshold=0.0, max_det=16)
    assert float((sf - sp).abs().max()) <= d
    gap = torch.full_like(sp, math.inf)
    gap[:, 1:] = sp[:, :-1] - sp[:, 1:]
    gap[:, :-1] = torch.minimum(gap[:, :-1], sp[:, :-1] - sp[:, 1:])
    alone = gap > 2 * d
    assert bool(alone.any()), d
    assert bool((cf == cp)[alone].all())


def _cell_scores(outs):
    """Every cell's score as ``decode`` computes it, (B, cells)."""
    return torch.cat([(torch.sigmoid(o[..., 4])
                       * torch.softmax(o[..., 5:], dim=-1).amax(-1))
                      .reshape(o.shape[0], -1) for o in outs], 1)


def _to_double(tree):
    if isinstance(tree, dict):
        return {k: _to_double(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_double(v) for v in tree]
    return tree.double()
