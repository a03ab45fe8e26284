"""Cells: (architecture x input shape) -> countable step (port of
``repro.launch.cells``).

A *cell* bundles everything the dry run and the roofline need:

  * ``step``          — the port's step (train / prefill / decode /
                        denoise / serve), from ``training/steps.py``
  * ``abstract_args`` — :class:`TensorSpec` trees for every argument (no
                        allocation, ever); the host scalars a step reads
                        (diffusion's ``"seed"``, a train state's
                        ``"step"``) stay Python ints
  * ``in_specs``      — :class:`~repro_torch.distributed.sharding.P`
                        trees matching ``abstract_args``
                        (mesh-independent; ``in_shardings(mesh)`` adapts
                        them)
  * ``model_flops``   — analytic "useful" FLOPs (6ND-style) for the
                        MODEL_FLOPS / counted FLOPs ratio
  * ``comment``       — human-readable notes (e.g. sampler-loop factor)

``input_specs(arch, shape)`` returns only the abstract inputs.
:func:`materialize` turns a cell's arguments into fake tensors (to count
the step at its published size, :mod:`repro_torch.launch.hloanalysis`)
or into real seeded ones on a device (to run it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import pytree
from repro_torch.configs import base as cfgbase
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import P
from repro_torch.models import diffusion as diff_mod
from repro_torch.models import transformer as lm_mod
from repro_torch.models import vision as vis_mod
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import steps as steps_mod


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape and dtype (the role of ``jax.ShapeDtypeStruct``);
    an integer one's values lie in ``[0, high)`` when it is drawn."""
    shape: tuple[int, ...]
    dtype: torch.dtype
    high: int = 1

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize


def _is_spec(x) -> bool:
    return isinstance(x, TensorSpec)


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    kind: str
    step: Callable
    abstract_args: tuple
    in_specs: tuple  # P trees (mesh-independent description)
    model_flops: float
    comment: str = ""
    # init_params(gen, device) -> the step's parameters (for materialize)
    init_params: Callable | None = None

    def in_shardings(self, mesh) -> tuple:
        """The specs adapted to ``mesh`` (a ``MeshSpec``): axes absent
        from the mesh (e.g. 'pod' on single-pod) or not dividing the
        dimension evenly (e.g. batch=1 long-context cells) are dropped
        per leaf, as the reference adapts its ``NamedSharding``s."""
        shd.set_mesh_axis_sizes(mesh)
        sizes = dict(zip(mesh.axis_names, mesh.shape))

        def fix(abstract, spec):
            shape = abstract.shape if _is_spec(abstract) else ()
            axes = []
            for dim, ax in enumerate(spec):
                ax = shd._filter_axes(ax)
                if ax is None:
                    axes.append(None)
                    continue
                names = ax if isinstance(ax, tuple) else (ax,)
                size = math.prod(sizes[a] for a in names)
                ok = dim < len(shape) and shape[dim] % size == 0
                axes.append(ax if ok else None)
            while axes and axes[-1] is None:
                axes.pop()
            return P(*axes)

        flat, treedef = pytree.flatten(self.abstract_args, _is_spec)
        specs = treedef.flatten_up_to(self.in_specs)
        return treedef.unflatten([fix(a, s) for a, s in zip(flat, specs)])

    def argument_bytes_per_device(self, mesh) -> int:
        """Bytes of the arguments one device of ``mesh`` holds under
        :meth:`in_shardings` (a host int counts as an int32 scalar)."""
        sizes = dict(zip(mesh.axis_names, mesh.shape))
        flat, treedef = pytree.flatten(self.abstract_args, _is_spec)
        total = 0
        for a, spec in zip(flat, treedef.flatten_up_to(
                self.in_shardings(mesh))):
            nbytes = a.nbytes if _is_spec(a) else 4
            split = math.prod(
                sizes[n] for ax in spec if ax is not None
                for n in (ax if isinstance(ax, tuple) else (ax,)))
            total += nbytes // split
        return total


def _abstract(tree):
    return pytree.tree_map(lambda x: TensorSpec(tuple(x.shape), x.dtype),
                           tree)


def _eval_params(init_fn) -> Any:
    """The parameters' specs, initialised on fake tensors."""
    with FakeTensorMode():
        return _abstract(init_fn(torch.Generator(), "cpu"))


def _opt_abstract(params_abs) -> dict:
    """AdamW state: f32 moments mirroring params + i32 step."""
    def moments():
        return pytree.tree_map(lambda s: TensorSpec(s.shape, torch.float32),
                               params_abs)
    return {"mu": moments(), "nu": moments(),
            "step": TensorSpec((), torch.int32)}


def _state_abstract(params_abs) -> dict:
    return {"params": params_abs, "opt": _opt_abstract(params_abs),
            "step": 0}


def _state_specs(param_specs) -> dict:
    return {"params": param_specs,
            "opt": shd.opt_state_specs(param_specs),
            "step": P()}


_OPT = opt_mod.adamw(lr=1e-4)


# --------------------------------------------------------------------------
# LM cells
# --------------------------------------------------------------------------


def _lm_cell(arch: cfgbase.ArchSpec, shape: cfgbase.ShapeSpec) -> Cell:
    cfg: lm_mod.TransformerConfig = arch.config
    b, s = shape.global_batch, shape.seq_len

    def init(gen, device):
        return lm_mod.init_params(gen, cfg, device)

    params_abs = _eval_params(init)
    param_specs = shd.spec_tree(
        params_abs,
        shd.lm_param_rules(n_experts=cfg.n_experts if cfg.moe else 0))
    tokens_active = b * s
    vocab = cfg.vocab_size

    if shape.kind == "train":
        step = steps_mod.lm_train_step(cfg, _OPT)
        batch_abs = {"tokens": TensorSpec((b, s), torch.int32, vocab),
                     "targets": TensorSpec((b, s), torch.int32, vocab)}
        args = (_state_abstract(params_abs), batch_abs)
        specs = (_state_specs(param_specs), shd.lm_batch_specs("train"))
        flops = 6.0 * cfg.n_active_params * tokens_active
        comment = f"6*N_active*D with N_active={cfg.n_active_params:.3e}"
    elif shape.kind == "prefill":
        step = steps_mod.lm_prefill_step(cfg, max_len=s)
        batch_abs = {"tokens": TensorSpec((b, s), torch.int32, vocab)}
        args = (params_abs, batch_abs)
        specs = (param_specs, shd.lm_batch_specs("prefill"))
        flops = 2.0 * cfg.n_active_params * tokens_active
        comment = "forward-only 2*N_active*D"
    else:  # decode
        step = steps_mod.lm_decode_step(cfg)
        s_cache = lm_mod.cache_length(cfg, s)
        cache_shape = (cfg.n_layers, b, s_cache, cfg.n_kv_heads, cfg.d_head)
        batch_abs = {
            "token": TensorSpec((b,), torch.int32, vocab),
            "cache_k": TensorSpec(cache_shape, cfg.compute_dtype),
            "cache_v": TensorSpec(cache_shape, cfg.compute_dtype),
            "cache_len": TensorSpec((), torch.int32),
        }
        args = (params_abs, batch_abs)
        specs = (param_specs, shd.lm_batch_specs("decode"))
        # one token per stream + KV-cache attention reads
        flops = 2.0 * cfg.n_active_params * b \
            + 4.0 * cfg.n_layers * b * s_cache * cfg.n_heads * cfg.d_head
        comment = (f"decode: 2*N_active*B + attention over cache "
                   f"(S_cache={s_cache})")
    return Cell(arch.arch_id, shape.name, shape.kind, step, args, specs,
                flops, comment, init)


# --------------------------------------------------------------------------
# vision cells
# --------------------------------------------------------------------------


def _vision_flops_per_image(cfg, res: int) -> float:
    """Analytic 2*MAC forward-FLOPs per image."""
    if isinstance(cfg, vis_mod.ViTConfig):
        n_tok = (res // cfg.patch) ** 2 + 1
        d, f = cfg.d_model, cfg.d_ff
        per_layer = 2 * n_tok * (4 * d * d + 2 * d * f) + 4 * n_tok * n_tok * d
        stem = 2 * n_tok * cfg.patch ** 2 * 3 * d
        return cfg.n_layers * per_layer + stem
    if isinstance(cfg, vis_mod.ConvNeXtConfig):
        total, res_c = 0.0, res // 4
        total += 2 * (res // 4) ** 2 * 4 * 4 * 3 * cfg.dims[0]
        prev = cfg.dims[0]
        for depth, dim in zip(cfg.depths, cfg.dims):
            if dim != prev:
                res_c //= 2
                total += 2 * res_c ** 2 * 2 * 2 * prev * dim
            total += depth * 2 * res_c ** 2 * (7 * 7 * dim + 8 * dim * dim)
            prev = dim
        return total
    # ResNet bottlenecks
    total = 2 * (res // 2) ** 2 * 7 * 7 * 3 * cfg.width
    res_c = res // 4
    c_in = cfg.width
    for i, depth in enumerate(cfg.depths):
        mid = cfg.width * 2 ** i
        out = mid * 4
        if i > 0:
            res_c //= 2
        total += 2 * res_c ** 2 * (c_in * mid + 9 * mid * mid + mid * out + c_in * out)
        total += (depth - 1) * 2 * res_c ** 2 * (out * mid + 9 * mid * mid + mid * out)
        c_in = out
    return total


def _vision_cell(arch: cfgbase.ArchSpec, shape: cfgbase.ShapeSpec) -> Cell:
    cfg = arch.config
    res, b = shape.img_res, shape.batch
    if getattr(cfg, "img_res", res) != res:
        cfg = dataclasses.replace(cfg, img_res=res)

    def init(gen, device):
        return vis_mod.init_params(gen, cfg, device)

    params_abs = _eval_params(init)
    param_specs = shd.conv_layout(
        shd.spec_tree(params_abs, shd.vision_param_rules()), params_abs,
        vis_mod.CONV_KEYS)
    fwd = _vision_flops_per_image(cfg, res) * b
    images = TensorSpec((b, res, res, 3), cfg.compute_dtype)

    if shape.kind == "train":
        step = steps_mod.vision_train_step(cfg, _OPT)
        batch_abs = {"images": images,
                     "labels": TensorSpec((b,), torch.int32, cfg.n_classes)}
        args = (_state_abstract(params_abs), batch_abs)
        specs = (_state_specs(param_specs), shd.vision_batch_specs())
        flops, comment = 3.0 * fwd, "3x analytic forward MACs (fwd+bwd)"
    else:
        step = steps_mod.vision_serve_step(cfg)
        batch_abs = {"images": images}
        args = (params_abs, batch_abs)
        specs = (param_specs, {"images": shd.vision_batch_specs()["images"]})
        flops, comment = fwd, "analytic forward MACs"
    return Cell(arch.arch_id, shape.name, shape.kind, step, args, specs,
                flops, comment, init)


# --------------------------------------------------------------------------
# diffusion cells
# --------------------------------------------------------------------------


def _diffusion_flops(cfg, res_latent: int, b: int) -> float:
    if isinstance(cfg, diff_mod.MMDiTConfig):
        n_img = (res_latent // cfg.patch) ** 2
        n_tok = n_img + cfg.n_ctx_tokens
        d, f = cfg.d_model, cfg.d_model * cfg.mlp_ratio
        # double block: per-stream qkv+o and mlp on its own tokens
        dbl = 2 * (n_img + cfg.n_ctx_tokens) * (4 * d * d + 2 * d * f) \
            + 4 * n_tok * n_tok * d
        sgl = 2 * n_tok * (4 * d * d + 2 * d * f) + 4 * n_tok * n_tok * d
        return b * (cfg.n_double_blocks * dbl + cfg.n_single_blocks * sgl)
    # UNet analytic: res blocks (convs) + spatial transformers
    # (self-attention is quadratic in tokens and dominates at high res).
    def xformer_flops(tokens: int, d: int, depth: int) -> float:
        per_tok = (4 * d * d          # self qkv + out
                   + 2 * d * d + 2 * d * cfg.ctx_dim  # cross q/out + kv
                   + 12 * d * d)      # GEGLU ff (d->8d, 4d->d)
        quad = 4 * tokens * tokens * d + 4 * tokens * cfg.n_ctx_tokens * d
        return depth * (2 * tokens * per_tok + quad)

    total = 0.0
    res_c = res_latent
    chans = [cfg.ch * m for m in cfg.ch_mult]
    c_prev = cfg.ch
    for li, c in enumerate(chans):
        for _ in range(cfg.n_res_blocks):
            total += 2 * res_c ** 2 * 9 * (c_prev * c + c * c)
            if li > 0:
                total += xformer_flops(res_c ** 2, c, cfg.transformer_depth[li])
            c_prev = c
        if li < len(chans) - 1:
            total += 2 * (res_c // 2) ** 2 * 9 * c * c
            res_c //= 2
    # mid: 2 res blocks + the last level's transformer depth
    total += 2 * 2 * res_c ** 2 * 9 * c_prev * c_prev
    total += xformer_flops(res_c ** 2, c_prev, cfg.transformer_depth[-1])
    # up path mirrors down with one extra res block per level and skip
    # concat inputs (~2x the down-path conv cost)
    return b * total * 2.4


def _diffusion_cell(arch: cfgbase.ArchSpec, shape: cfgbase.ShapeSpec) -> Cell:
    cfg = arch.config
    vae = 8
    lat = shape.img_res // vae
    b = shape.batch
    if cfg.latent_res != lat:
        cfg = dataclasses.replace(cfg, latent_res=lat)
    is_flux = isinstance(cfg, diff_mod.MMDiTConfig)

    def init(gen, device):
        return diff_mod.init_params(gen, cfg, device)

    params_abs = _eval_params(init)
    param_specs = shd.conv_layout(
        shd.spec_tree(params_abs, shd.diffusion_param_rules()), params_abs,
        diff_mod.CONV_KEYS)
    fwd = _diffusion_flops(cfg, lat, b)
    ch, cdt, f32 = cfg.latent_ch, cfg.compute_dtype, torch.float32

    common = {"latents": TensorSpec((b, lat, lat, ch), cdt),
              "ctx": TensorSpec((b, cfg.n_ctx_tokens,
                                 cfg.d_ctx if is_flux else cfg.ctx_dim), cdt)}
    if is_flux:
        extras = {"pooled": TensorSpec((b, cfg.d_pooled), cdt),
                  "guidance": TensorSpec((b,), f32)}
    else:
        extras = {"add_emb": TensorSpec((b, cfg.d_add), cdt)}

    batch_spec = shd.diffusion_batch_specs(cfg)
    if shape.kind == "train":
        step = steps_mod.diffusion_train_step(cfg, _OPT)
        batch_abs = {**common, **extras, "seed": 0}
        spec = {k: batch_spec[k] for k in common | extras} | {"seed": P()}
        args = (_state_abstract(params_abs), batch_abs)
        specs = (_state_specs(param_specs), spec)
        flops = 3.0 * fwd
        comment = "3x analytic forward (fwd+bwd); one denoise step"
    else:
        step = steps_mod.diffusion_denoise_step(cfg)
        t_extra = ({"t": TensorSpec((b,), f32), "dt": TensorSpec((b,), f32)}
                   if is_flux else
                   {"t": TensorSpec((b,), f32),
                    "t_prev": TensorSpec((b,), f32)})
        batch_abs = {**common, **extras, **t_extra}
        spec = {k: batch_spec[k] for k in batch_abs}
        args = (params_abs, batch_abs)
        specs = (param_specs, spec)
        flops = fwd
        comment = (f"ONE denoise step; full sample = {shape.steps} steps "
                   f"(sampler loop in benchmarks)")
    return Cell(arch.arch_id, shape.name, shape.kind, step, args, specs,
                flops, comment, init)


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------


def build_cell(arch_id: str, shape_name: str) -> Cell:
    arch = cfgbase.get_arch(arch_id)
    if shape_name in arch.skip:
        raise ValueError(f"{arch_id}/{shape_name}: {arch.skip[shape_name]}")
    shape = arch.shapes[shape_name]
    if arch.family == "lm":
        return _lm_cell(arch, shape)
    if arch.family == "vision":
        return _vision_cell(arch, shape)
    if arch.family == "diffusion":
        return _diffusion_cell(arch, shape)
    raise ValueError(arch.family)


def input_specs(arch_id: str, shape_name: str):
    """TensorSpec stand-ins for every input of the cell's step."""
    return build_cell(arch_id, shape_name).abstract_args


def iter_cells(include_skipped: bool = True):
    """Yield (arch_id, shape_name, skip_reason|None) for all 40 cells."""
    for arch_id in cfgbase.list_archs():
        arch = cfgbase.get_arch(arch_id)
        for shape_name in arch.shapes:
            yield arch_id, shape_name, arch.skip.get(shape_name)


def materialize(cell: Cell, fake_mode: FakeTensorMode | None = None,
                device: str | torch.device = "cpu", seed: int = 0) -> tuple:
    """``cell.abstract_args`` as tensors on ``device``: fake ones made in
    ``fake_mode`` (no memory, any size), or else real ones drawn from
    ``seed``: the parameters from the model's init, the optimizer's
    moments zero, an integer input in ``[0, high)``, a float input
    uniform in [0, 1), drawn in its own dtype (a decode cell's cache
    takes no float32 copy).  Host ints stay as they are."""
    device = torch.device(device)
    if fake_mode is not None:
        with fake_mode:
            return pytree.tree_map(
                lambda a: torch.empty(a.shape, dtype=a.dtype, device=device)
                if _is_spec(a) else a, cell.abstract_args)

    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(a):
        if not _is_spec(a):
            return a
        if a.dtype.is_floating_point:
            return torch.empty(a.shape, dtype=a.dtype, device=device
                               ).uniform_(generator=gen)
        return torch.randint(0, a.high, a.shape, generator=gen,
                             device=device, dtype=a.dtype)

    params = cell.init_params(gen, device)
    first, batch = cell.abstract_args
    if cell.kind == "train":
        zeros = pytree.tree_map(lambda a: torch.zeros(
            a.shape, dtype=a.dtype, device=device), first["opt"])
        first = {"params": params, "opt": zeros, "step": first["step"]}
    else:
        first = params
    return first, pytree.tree_map(draw, batch)
