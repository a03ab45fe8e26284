"""Cost analysis of a PyTorch program by the ops it dispatches (the role
of ``repro.launch.hloanalysis``).

The reference parses XLA's optimised HLO and multiplies each while
body's costs by its trip count.  PyTorch has no HLO: the port's steps
are eager Python, so their loops (a layer stack, a remat recompute, a
sampler's blocks) run op by op, and every op they run passes through
the dispatcher once.  :func:`analyze` runs the function under a
:class:`~torch.utils._python_dispatch.TorchDispatchMode` stacked with
:class:`torch.utils.flop_counter.FlopCounterMode` and counts each op it
sees.  On fake tensors (``FakeTensorMode``, the counterpart of
``jax.eval_shape``) it allocates nothing, so a cell counts at its
published size on any host; on real tensors it counts the same ops.

Model, with the reference's keys:
  * ``flops`` — FlopCounterMode's count: matrix products (``mm``,
    ``addmm``, ``bmm``, ``baddbmm``, attention; their float32-output
    overloads too) and convolutions, their backward included, 2 per
    multiply-add, as the reference counts ``dot`` and ``convolution``.
    Elementwise ops count 0 in both.
  * ``flops_by_dtype`` — ``flops`` split by the dtype of each product's
    first operand (``"bfloat16"``, ``"float32"``, ...), for pricing each
    part at its own peak (the card runs float32 products outside the
    tensor cores: TF32 is off).
  * ``hbm_bytes`` — for every dispatched op, its tensor operands' bytes
    plus its results' bytes (each tensor's distinct elements: a
    broadcast dimension, stride 0, counts once).  An op whose results
    share storage with an operand and write nothing (a view, ``t``,
    ``expand``, ``reshape`` of a contiguous tensor, ``detach``) counts
    0, and so does an allocation that writes nothing (``empty``).  This
    is an eager model: every op the port dispatches is its own kernel,
    which reads its operands from HBM and writes its results there.  The
    reference's fusion-IO model charges each XLA fusion its I/O once, so
    a chain of elementwise ops that XLA fuses counts once there and once
    an op here; the matrix products' I/O count alike.
  * ``collectives`` / ``collective_bytes`` — operand bytes of the
    ``c10d`` and ``_c10d_functional`` ops by the reference's kinds, as
    one rank sends them: a per-rank function (``moe_block_a2a``) counts
    its exchanges when it runs on a (fake) process group; 0 on one
    device.
  * ``n_ops`` — the ops charged (in place of ``n_computations``).
  * with ``detail``: ``top_flops`` and ``top_bytes``, (count, op) pairs
    by op, largest first.

A kernel the port launches through ``ctypes`` is invisible to the
dispatcher, so its FLOPs and bytes would be missing: :func:`analyze`
raises on a call that launches one (``repro_torch.kernels._build``'s
launch counts moved).  No cell of the launch layer launches one.
"""

from __future__ import annotations

from collections import defaultdict

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# the c10d op names' stems -> the reference's collective kinds
_COLLECTIVE_STEMS = (
    ("all_gather", "all-gather"), ("allgather", "all-gather"),
    ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
    ("reduce_scatter", "reduce-scatter"), ("all_to_all", "all-to-all"),
    ("alltoall", "all-to-all"), ("send", "collective-permute"),
    ("recv", "collective-permute"))
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")

# allocations that write nothing
_NO_TRAFFIC = ("empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided")


def _bmm_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    # also the float32-output overload (``bmm.dtype``, the MoE experts'
    # bf16 products on the card), whose ``out_dtype`` arrives as a third
    # positional argument that FlopCounterMode's own formula refuses
    return flop_counter.bmm_flop(a_shape, b_shape)


def _addmm_flop(self_shape, a_shape, b_shape, *args, out_shape=None,
                **kwargs) -> int:
    return flop_counter.addmm_flop(self_shape, a_shape, b_shape)


def _baddbmm_flop(self_shape, a_shape, b_shape, *args, out_shape=None,
                  **kwargs) -> int:
    return flop_counter.baddbmm_flop(self_shape, a_shape, b_shape)


_aten = torch.ops.aten
_PRODUCT_FLOPS = {_aten.bmm: _bmm_flop, _aten.addmm: _addmm_flop,
                  _aten.baddbmm: _baddbmm_flop}


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s distinct elements (a stride-0 dimension once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _collective_kind(func) -> str | None:
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return None
    name = func._schema.name.split("::")[-1]
    return next((kind for stem, kind in _COLLECTIVE_STEMS if stem in name),
                None)


class _ByteCounter(TorchDispatchMode):
    """Operand plus result bytes of every dispatched op (see module)."""

    def __init__(self):
        super().__init__()
        self.hbm_bytes = 0
        self.n_ops = 0
        self.by_op: dict[str, int] = defaultdict(int)
        self.collectives = {k: {"bytes": 0.0, "count": 0.0}
                            for k in COLLECTIVE_KINDS}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "prim":  # metadata queries (device, ...)
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        name = func._schema.name.split("::")[-1]
        if name in _NO_TRAFFIC:
            return out
        if not func._schema.is_mutable:
            in_storages = {t.untyped_storage()._cdata for t in ins}
            if func.is_view or (outs and all(
                    t.untyped_storage()._cdata in in_storages
                    for t in outs)):
                return out
        b = sum(map(tensor_bytes, ins)) + sum(map(tensor_bytes, outs))
        kind = _collective_kind(func)
        if kind is not None:
            self.collectives[kind]["bytes"] += sum(map(tensor_bytes, ins))
            self.collectives[kind]["count"] += 1
        self.hbm_bytes += b
        self.n_ops += 1
        self.by_op[str(func.overloadpacket)] += b
        return out


class _FlopsByDtype(FlopCounterMode):
    """FlopCounterMode that also splits its count by operand dtype."""

    def __init__(self):
        super().__init__(display=False, custom_mapping=_PRODUCT_FLOPS)
        self.by_dtype: dict[str, int] = defaultdict(int)

    def _count_flops(self, func_packet, out, args, kwargs):
        if func_packet in self.flop_registry:
            ins = _tensors((args, kwargs))
            n = self.flop_registry[func_packet](*args, **kwargs, out_val=out)
            if n:
                self.by_dtype[str(ins[0].dtype).removeprefix("torch.")] += n
        return super()._count_flops(func_packet, out, args, kwargs)


def _top(counts: dict, n: int = 25) -> list:
    return sorted(((v, k) for k, v in counts.items() if v), reverse=True)[:n]


def analyze(fn, *args, detail: bool = False, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and count its FLOPs, bytes and
    collectives (see the module docstring).  Give it fake tensors to
    count without allocating; raises ``RuntimeError`` if the call
    launched one of the port's ``ctypes`` kernels."""
    from repro_torch.kernels import _build

    before = _build.launch_counts()
    flop_mode = _FlopsByDtype()
    bytes_mode = _ByteCounter()
    with flop_mode, bytes_mode:
        fn(*args, **kwargs)
    launched = {k: v - before.get(k, 0)
                for k, v in _build.launch_counts().items()
                if v != before.get(k, 0)}
    if launched:
        raise RuntimeError(
            f"analyze: the call launched {launched}; a ctypes kernel's "
            f"FLOPs and bytes are invisible to the dispatcher")
    coll = bytes_mode.collectives
    out = {
        "flops": float(flop_mode.get_total_flops()),
        "flops_by_dtype": {k: float(v) for k, v in flop_mode.by_dtype.items()},
        "hbm_bytes": float(bytes_mode.hbm_bytes),
        "collectives": coll,
        "collective_bytes": sum(v["bytes"] for v in coll.values()),
        "n_ops": bytes_mode.n_ops,
    }
    if detail:
        flops_by_op = {str(op): v for op, v in
                       flop_mode.get_flop_counts().get("Global", {}).items()}
        out["top_flops"] = _top(flops_by_op)
        out["top_bytes"] = _top(bytes_mode.by_op)
    return out
