"""Sharding rules: path-pattern -> PartitionSpec, per model family (port
of ``repro.distributed.sharding``).

The reference's strategy, kept as it is:

  * mesh axes ``(data, model)`` single-pod, ``(pod, data, model)``
    multi-pod.  The ``pod`` axis is pure data parallelism: batch
    dimensions shard over ``("pod", "data")`` when present, and
    parameters/optimizer state FSDP-shard over ``data`` only.
  * LM params: Megatron TP over ``model`` (attention heads, FFN
    columns) + FSDP over ``data`` on the other matrix axis.
  * MoE: experts sharded over ``model`` (expert parallelism) when the
    expert count divides the axis, else TP inside each expert.
  * KV caches: batch over ``data``, head dim over ``model``.
  * vision/diffusion/detector: DP everywhere; TP over ``model`` for
    the widest matmuls (d_ff / channel axes).

Rules are (regex, :class:`P`) lists matched against ``path/like/this``
param paths; the first match wins.  ``spec_tree`` builds the full spec
tree for any param tree.  PyTorch has no ``PartitionSpec`` and no
``NamedSharding``: :class:`P` holds a spec as JAX's does (per dimension
``None``, an axis name or a tuple of names), and :func:`named` pairs it
with a :class:`~repro_torch.launch.mesh.MeshSpec`.  The cost analysis
(``launch/cells.py``) reads these rules and their spec trees.

The multi-device path runs one process a rank over ``torch.distributed``
(:mod:`repro_torch.distributed.collectives`): :func:`shard_map` runs a
function on each rank's shards, and :func:`use_mesh` makes a
``DeviceMesh`` the active one (the reference's ``with mesh:``), which
:func:`current_mesh` and :func:`mesh_axis_size` read.  The axis sizes
that :func:`set_mesh_axis_sizes` records for the cost analysis are a
separate record: neither one reads the other.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from contextvars import ContextVar
from typing import Any, Sequence

import torch

from repro_torch import pytree


class P:
    """A PartitionSpec: per tensor dimension ``None`` (replicated), a
    mesh axis name or a tuple of names.  Iterates, indexes and compares
    (also with a tuple) as the tuple of its entries; a pytree leaf."""

    __slots__ = ("_parts",)

    def __init__(self, *parts):
        self._parts = tuple(parts)

    def __iter__(self):
        return iter(self._parts)

    def __len__(self) -> int:
        return len(self._parts)

    def __getitem__(self, i):
        return self._parts[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, P):
            return self._parts == other._parts
        if isinstance(other, tuple):
            return self._parts == other
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self._parts)

    def __repr__(self) -> str:
        return f"P{self._parts!r}" if len(self._parts) != 1 \
            else f"P({self._parts[0]!r})"


Rules = Sequence[tuple[str, P]]


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def spec_tree(params: Any, rules: Rules, default: P = P()) -> Any:
    """Map every leaf to the spec of the first matching rule."""

    def pick(path, leaf):
        del leaf
        ps = _path_str(path)
        for pat, spec in rules:
            if re.search(pat, ps):
                return spec
        return default

    return pytree.tree_map_with_path(pick, params)


def _filter_axes(ax):
    """Drop mesh axes that don't exist on the active mesh."""
    if ax is None:
        return None
    if isinstance(ax, tuple):
        kept = tuple(a for a in ax if a in _MESH_SIZES)
        if not kept:
            return None
        return kept if len(kept) > 1 else kept[0]
    return ax if ax in _MESH_SIZES else None


def adapt_spec(spec: P) -> P:
    """Adapt a hand-written spec to the active mesh (drops unknown axis
    names, e.g. 'pod' on single-pod meshes)."""
    out = [_filter_axes(ax) for ax in spec]
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def adapt_tree(tree):
    return pytree.tree_map(adapt_spec, tree)


# the axis sizes of the mesh set last (the reference keeps the same
# module-level record, read by _filter_axes and _axis_size)
_MESH_SIZES: dict[str, int] = {}


def set_mesh_axis_sizes(mesh) -> None:
    """Record axis sizes so spec_tree can check divisibility."""
    global _MESH_SIZES
    _MESH_SIZES = dict(zip(mesh.axis_names, mesh.shape))


def _axis_size(ax) -> int:
    if isinstance(ax, tuple):
        return math.prod(_MESH_SIZES.get(a, 1) for a in ax)
    return _MESH_SIZES.get(ax, 1)


# --------------------------------------------------------------------------
# per-family rules (the reference's, verbatim)
# --------------------------------------------------------------------------

# batch axes: ("pod", "data") when the pod axis exists; absent from the
# mesh, "pod" is dropped by _filter_axes
BATCH = ("pod", "data")


def lm_param_rules(fsdp: bool = True, n_experts: int = 0,
                   model_axis: int = 16) -> Rules:
    """Megatron TP + optional FSDP for the LM family.

    Layer params are stacked (L, din, dout): dim 0 = layer (never
    sharded), dim 1/2 = matrix.  TP shards the 'parallel' matrix axis
    over `model`; FSDP shards the other one over `data`.

    MoE placement is adaptive: when the expert count divides the model
    axis (qwen3: 128 % 16 == 0) experts shard over `model` (EP);
    otherwise (mixtral: 8 experts on a 16-wide axis) the expert FFN
    width shards over `model` (TP-within-expert) so the big matrices
    never replicate.
    """
    d = "data" if fsdp else None
    ep = n_experts > 0 and n_experts % model_axis == 0
    rules = [
        # attention: column-parallel qkv, row-parallel out
        (r"layers/attn/wq$|layers/attn/wk$|layers/attn/wv$", P(None, d, "model")),
        (r"layers/attn/wo$", P(None, "model", d)),
        # dense mlp: column-parallel gate/up, row-parallel down
        (r"layers/mlp/w_gate$|layers/mlp/w_up$", P(None, d, "model")),
        (r"layers/mlp/w_down$", P(None, "model", d)),
        (r"layers/moe/router$", P(None, d, None)),
    ]
    if ep:
        rules += [
            (r"layers/moe/w_gate$|layers/moe/w_up$", P(None, "model", d, None)),
            (r"layers/moe/w_down$", P(None, "model", d, None)),
        ]
    else:
        rules += [
            (r"layers/moe/w_gate$|layers/moe/w_up$", P(None, None, d, "model")),
            (r"layers/moe/w_down$", P(None, None, "model", d)),
        ]
    rules += [
        # norms replicated
        (r"ln", P()),
        # embeddings: vocab over model (keeps 152k-vocab logits sharded)
        (r"embed/emb$", P("model", d)),
        (r"unembed/w$", P(d, "model")),
    ]
    return rules


def lm_batch_specs(kind: str) -> dict[str, P]:
    if kind == "train":
        return {"tokens": P(BATCH, None), "targets": P(BATCH, None)}
    if kind == "prefill":
        return {"tokens": P(BATCH, None)}
    if kind == "decode":
        # cache (L, B, S, KVH, Dh): batch over data, head dim over model
        return {
            "token": P(BATCH),
            "cache_k": P(None, BATCH, None, None, "model"),
            "cache_v": P(None, BATCH, None, None, "model"),
            "cache_len": P(),
        }
    raise ValueError(kind)


def vision_param_rules() -> Rules:
    return [
        # ViT stacked layer matrices: (L, din, dout) — TP on dout, FSDP din
        (r"layers/wqkv$|layers/w1$", P(None, "data", "model")),
        (r"layers/wo$|layers/w2$", P(None, "model", "data")),
        # ConvNeXt pointwise convs (stacked): (L, din, dout)
        (r"stages/\d+/pw1/w$", P(None, "data", "model")),
        (r"stages/\d+/pw2/w$", P(None, "model", "data")),
        # classifier head
        (r"head/w$", P(None, "model")),
        # conv kernels (HWIO in the reference): output channels over model
        (r"conv|stem|dw|proj|down|lateral", P(None, None, None, "model")),
        (r".*", P()),
    ]


def vision_batch_specs() -> dict[str, P]:
    return {"images": P(BATCH, None, None, None), "labels": P(BATCH)}


def diffusion_param_rules() -> Rules:
    return [
        # MMDiT stacked stream matrices
        (r"double/(img|txt)/wqkv$|double/(img|txt)/w1$", P(None, "data", "model")),
        (r"double/(img|txt)/wo$|double/(img|txt)/w2$", P(None, "model", "data")),
        (r"single/wqkv$|single/w1$", P(None, "data", "model")),
        (r"single/wo2$", P(None, "model", "data")),
        (r"double/(img|txt)/mod/w$|single/mod/w$", P(None, None, "model")),
        # UNet transformer blocks (stacked under blocks/)
        (r"blocks/(wq1|wkv1|wq2|wkv2|ff1)/w$", P(None, None, "model")),
        (r"blocks/(wo1|wo2|ff2)/w$", P(None, "model", None)),
        # big convs: out-channels over model
        (r"conv|skip|proj", P(None, None, None, "model")),
        (r".*", P()),
    ]


def diffusion_batch_specs(cfg) -> dict[str, P]:
    from repro_torch.models.diffusion import MMDiTConfig

    base = {"latents": P(BATCH, None, None, None), "ctx": P(BATCH, None, None)}
    if isinstance(cfg, MMDiTConfig):
        base.update({"pooled": P(BATCH, None), "guidance": P(BATCH),
                     "t": P(BATCH), "dt": P(BATCH)})
    else:
        base.update({"add_emb": P(BATCH, None), "t": P(BATCH),
                     "t_prev": P(BATCH)})
    return base


def detector_param_rules() -> Rules:
    return [
        (r"conv/w$", P(None, None, None, "model")),
        (r".*", P()),
    ]


def detector_batch_specs() -> dict[str, P]:
    return {"images": P(BATCH, None, None, None)}


# --------------------------------------------------------------------------
# the active mesh, shard_map, activation constraints
# --------------------------------------------------------------------------

# the DeviceMesh of the running program (the reference reads JAX's
# thread resources, which ``with mesh:`` sets)
_ACTIVE_MESH: ContextVar = ContextVar("repro_torch_active_mesh",
                                      default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``) the active mesh inside the block:
    the twin of the reference's ``with mesh:``."""
    token = _ACTIVE_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.reset(token)


def current_mesh():
    """The active ``DeviceMesh`` (:func:`use_mesh`), or None."""
    return _ACTIVE_MESH.get()


def mesh_axis_size(name: str) -> int:
    """Size of an axis of the active mesh (1 if absent or no mesh)."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    return dict(zip(mesh.mesh_dim_names, mesh.shape)).get(name, 1)


def map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over the tensors of ``tree``: ``specs`` is one
    :class:`P` for every leaf or a tree of them matching ``tree``."""
    if isinstance(specs, P):
        return pytree.tree_map(
            lambda x: fn(x, specs) if isinstance(x, torch.Tensor) else x,
            tree)
    spec_leaves = pytree.flatten(specs, lambda s: isinstance(s, P))[0]
    leaves, treedef = pytree.flatten(tree)
    return treedef.unflatten([fn(x, s) for x, s in zip(leaves, spec_leaves)])


def shard_map(f, *, mesh, in_specs, out_specs):
    """The reference's ``shard_map`` as SPMD over ``torch.distributed``:
    every rank of ``mesh`` calls the returned function on the same global
    inputs.  Each input becomes the rank's block by its spec
    (``collectives.local_shard``), ``f`` runs on the blocks with ``mesh``
    active (its collectives name the mesh's axes), and each output is
    assembled from every rank's block by its spec
    (``collectives.gather``); a ``P()`` output comes back as the rank
    computed it.  ``in_specs`` holds one entry an argument, ``out_specs``
    one an output (a single one for a single output); an entry is a
    :class:`P` or a tree of them.

    Autograd stops at the assembly, so the returned function refuses
    inputs that require grad: differentiate ``f`` itself on each rank's
    blocks (``collectives``' convention)."""
    from repro_torch.distributed import collectives as C

    def wrapped(*args):
        if torch.is_grad_enabled() and any(
                isinstance(x, torch.Tensor) and x.requires_grad
                for x in pytree.leaves(args)):
            raise RuntimeError(
                "shard_map's assembly is not differentiable; differentiate "
                "the per-rank function on its blocks")
        local = [map_specs(lambda x, s: C.local_shard(x, mesh, s), a, s)
                 for a, s in zip(args, in_specs)]
        with use_mesh(mesh):
            out = f(*local)
        single = not isinstance(out_specs, tuple)
        outs = (out,) if single else out
        specs = (out_specs,) if single else out_specs
        full = tuple(map_specs(lambda x, s: C.gather(x, mesh, s)
                                if len(s) else x, o, s)
                     for o, s in zip(outs, specs))
        return full[0] if single else full

    return wrapped


@contextlib.contextmanager
def no_activation_constraints():
    """The reference disables its in-model layout hints inside a block;
    the port's :func:`constrain` is the identity, so this does nothing."""
    yield


def constrain(x, *spec):
    """The reference's ``with_sharding_constraint``, a layout hint that
    never changes a value: the identity.  The port runs SPMD, one process
    a rank, so a tensor's layout is what each rank holds and there is no
    partitioner to hint."""
    del spec
    return x


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NamedSpec:
    """A spec on a mesh (the role of JAX's ``NamedSharding``)."""
    mesh: Any
    spec: P


def named(mesh, spec: P) -> NamedSpec:
    return NamedSpec(mesh, spec)


def tree_shardings(mesh, spec_pytree) -> Any:
    return pytree.tree_map(lambda s: NamedSpec(mesh, s), spec_pytree)


def conv_layout(specs, params, conv_keys) -> Any:
    """``specs`` (from the rules above, which name the dimensions of the
    reference's conv kernels: HWIO, stacked ``(L, kh, kw, I, O)``) with
    the spec of each of the port's conv kernels moved to its OIHW layout
    (stacked ``(L, O, I, kh, kw)``), so that it shards the same
    dimension as the reference's.  A conv kernel is a ``"w"`` leaf whose
    nearest dict key above it is in ``conv_keys`` (the model module's
    ``CONV_KEYS``, as its ``from_jax_params`` reads them)."""
    spec_leaves, treedef = pytree.flatten(specs, lambda s: isinstance(s, P))
    out = []
    for (path, leaf), spec in zip(pytree.flatten_with_path(params)[0],
                                  spec_leaves):
        parent = next((k for k in reversed(path[:-1]) if isinstance(k, str)),
                      None)
        if path[-1] == "w" and parent in conv_keys:
            nd = len(leaf.shape)
            parts = list(spec) + [None] * (nd - len(spec))
            lead = list(range(nd - 4))
            perm = lead + [nd - 1, nd - 2, nd - 4, nd - 3]
            parts = [parts[i] for i in perm]
            while parts and parts[-1] is None:
                parts.pop()
            spec = P(*parts)
        out.append(spec)
    return treedef.unflatten(out)


def opt_state_specs(param_specs) -> dict:
    """AdamW moments mirror param sharding; step is replicated."""
    return {
        "mu": param_specs,
        "nu": param_specs,
        "step": P(),
    }
