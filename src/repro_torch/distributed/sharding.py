"""Logical-axis sharding rules with divisibility-aware fallback (the
reference's `repro/distributed/sharding.py`, function for function).

Every parameter leaf is matched *by its tree path* to a right-aligned
tuple of logical axes; logical axes resolve to mesh axes; a rule only
applies if the dimension divides the mesh-axis size (else that dim
replicates).  The rule tables, `set_dp_over_model`, `_dp_axes`,
`_resolve`, `_match` and `_spec_for_leaf` are the reference's, pure
functions of a path, a shape and ``mesh.shape`` (a mapping of axis name
to size: a `DeviceMesh` is read through `_axes`, a duck-typed mesh with
a ``shape`` dict is taken as it is).

Logical axes:
  tp    — tensor parallel        -> ("model",)
  fsdp  — weight sharding        -> ("data",)   (only when cfg.fsdp_params)
  dp    — batch                  -> ("pod", "data") when the pod axis exists
  sp    — sequence parallel      -> ("data",)   (decode with unshardable batch)

The port's trees hold one dict per layer (``blocks/3/wq``, the xLSTM's
``blocks/2/mlstm/1/wq``) where the reference stacks layers on leading
axes; the rules are right-aligned, so an unstacked leaf gets the
reference's spec with the stacking dims dropped.  One rule reads dim 0:
ZeRO-1 in `opt_state_shardings` shards dim 0 of the port's leaf, where
the reference's dim 0 of a stacked leaf is the layer axis.

A sharding is `NamedSharding` (mesh, spec), the spec a `PartitionSpec`:
a tuple of None, an axis name, or a tuple of names.  It gives DTensor
placements and a rank's local shape.  `device_put` places a tree: on a
mesh of one rank each leaf stays a plain tensor on the mesh's device
(the kernels read ``data_ptr()``; a DTensor would route every op
through DTensor dispatch); on a larger mesh each leaf becomes a
`DTensor` (`distribute_tensor`).  The reference's active mesh (``with
mesh:``) is `use_mesh` / `active_mesh`, a context this module owns.

The partitioned train step is the one-rank step run under DTensor
dispatch on those leaves (the port's twin of GSPMD): `place_batch` and
`batch_rows` place a batch and its microbatches, `placed_like`,
`replicate` and `unsplit_dim` join plain tensors, partial sums and
head views to the DTensor ops, `on_local_heads` hands a kernel (or
the CPU's plain attention) each rank's local batch rows and heads
(`head_sharding`) through `local_map`, `on_local_groups` hands the
MoE's integer routing each rank's own token groups the same way, and
`on_local_blocks` hands a recurrent scan (the mLSTM's, the sLSTM's,
Mamba's) each rank's blocks by logical specs, the whole loop over time
in one call.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import re
from typing import Any, Iterator, Optional, Tuple

import numpy as np
import torch

# --- rule table: path pattern -> right-aligned logical axes ----------------
# ("fsdp","tp") on (..., D_in, D_out): column-parallel weight
# ("tp","fsdp") on (..., D_in, D_out): row-parallel weight (contracting in)
_PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"(^|/)embed$", ("tp", None)),
    (r"(^|/)(wq|wk|wv|wz|wi|wf|w_gate|w_up|in_proj|w_dt|x_wq|x_wk|x_wv|"
     r"proj_w1|proj_w2|frontend|ri|rf|rz|ro|wo_gate)$", ("fsdp", "tp")),
    (r"(^|/)(wo|w_down|out_proj|x_wo|w_bcdt)$", ("tp", "fsdp")),
    (r"(^|/)(we_gate|we_up)$", ("tp", "fsdp", None)),  # E -> model (EP), D -> data
    (r"(^|/)we_down$", ("tp", None, "fsdp")),          # E -> model, D -> data
    (r"(^|/)router$", (None, None)),
    (r"(^|/)conv_w$", (None, "tp")),
    (r"(^|/)a_log$", ("tp", None)),
    (r"(^|/)(d_skip|dt_bias|conv_b)$", ("tp",)),
    (r"(^|/)out_ln$", ("tp",)),
    (r"(^|/)(ln\d?|ln|x_ln|final_norm|enc_norm|proj_b1|proj_b2)$", (None,)),
)

# cache leaves, matched on full dotted path; B/S resolved dynamically
_CACHE_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"(^|/)(k|v|xk|xv)$", ("dp", "kvh", "sp_if_b1", None)),  # (B,H,S,hd)
    (r"mamba/h$", ("dp", "tp", None)),       # (B, di, ds)
    (r"mamba/conv$", ("dp", None, "tp")),    # (B, conv-1, di)
    (r"(^|/)m/c$", ("dp", None, None, "tp")),  # mlstm (B, H, dk, dv)
    (r"(^|/)m/n$", ("dp", None, None)),
    (r"(^|/)m/m$", ("dp", None)),
    (r"(^|/)s/(c|n|m|h)$", ("dp", None)),
    (r"(^|/)len$", ()),
)


class PartitionSpec(tuple):
    """The reference's ``PartitionSpec``: one entry a tensor dim, each
    None (replicated), an axis name, or a tuple of names."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class _Axes:
    """A `DeviceMesh` seen as the rules see a mesh: ``shape`` maps each
    dim's name to its size."""

    def __init__(self, mesh):
        self.shape = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _axes(mesh):
    return mesh if isinstance(getattr(mesh, "shape", None), dict) else _Axes(mesh)


def axis_sizes(mesh) -> dict:
    """Each mesh dim's name and size, of a `DeviceMesh` or of a
    duck-typed mesh with a ``shape`` dict."""
    return dict(_axes(mesh).shape)


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name]


# --- global sharding policy switch (set per-arch by the launcher) ----------
# dp_over_model=True: the model axis joins data parallelism; weights stop
# being Megatron-TP and become FSDP-sharded over the model axis instead.
# The right layout for small-d_model archs where TP=16 activation
# all-reduces dwarf compute (yi-6b).
_DP_OVER_MODEL = False


def set_dp_over_model(flag: bool) -> None:
    global _DP_OVER_MODEL
    _DP_OVER_MODEL = bool(flag)


def _dp_axes(mesh) -> Tuple[str, ...]:
    axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    if _DP_OVER_MODEL and "model" in mesh.shape:
        axes = axes + ("model",)
    return axes


def _resolve(
    logical: Optional[str], dim: int, mesh, *, fsdp: bool, batch_shardable: bool
):
    """One logical axis + concrete dim -> mesh axes or None."""
    if logical is None:
        return None
    if logical == "tp":
        if _DP_OVER_MODEL:
            # weights are FSDP-sharded over the model axis instead of TP:
            # the 'tp' (output/expert) dim carries the shard
            return "model" if dim % _axis_size(mesh, "model") == 0 else None
        return "model" if dim % _axis_size(mesh, "model") == 0 else None
    if logical == "fsdp":
        if _DP_OVER_MODEL:
            return None  # the tp dim already shards over model
        if not fsdp or "data" not in mesh.shape:
            return None
        return "data" if dim % _axis_size(mesh, "data") == 0 else None
    if logical == "dp":
        axes = _dp_axes(mesh)
        if not axes:
            return None
        total = int(np.prod([_axis_size(mesh, a) for a in axes]))
        if dim % total == 0:
            return axes if len(axes) > 1 else axes[0]
        if dim % _axis_size(mesh, axes[0]) == 0:
            return axes[0]
        return None
    if logical == "kvh":
        return "model" if dim % _axis_size(mesh, "model") == 0 else None
    if logical == "sp_if_b1":
        # sequence parallel only when the batch could not shard
        if batch_shardable:
            return None
        if "data" in mesh.shape and dim % _axis_size(mesh, "data") == 0:
            return "data"
        return None
    raise ValueError(f"unknown logical axis {logical}")


def _match(rules, path: str):
    for pat, spec in rules:
        if re.search(pat, path):
            return spec
    return None


def _spec_for_leaf(
    path: str, shape: Tuple[int, ...], mesh, rules, *, fsdp: bool,
    batch_shardable: bool = True,
) -> P:
    logical = _match(rules, path)
    if logical is None:
        return P()
    nd = len(shape)
    la = len(logical)
    out = [None] * nd
    # right-aligned application; leading (stacking) dims replicate
    for i, ax in enumerate(logical):
        pos = nd - la + i
        if pos < 0:
            continue
        out[pos] = _resolve(
            ax, shape[pos], mesh, fsdp=fsdp, batch_shardable=batch_shardable
        )
    return P(*out)


# --- shardings and placement ------------------------------------------------

class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = P(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec!r})"

    def _dims_of(self, name: str) -> Optional[int]:
        for i, part in enumerate(self.spec):
            if part == name or (isinstance(part, tuple) and name in part):
                return i
        return None

    def placements(self) -> tuple:
        """One DTensor placement a mesh dim: ``Shard(i)`` where tensor dim
        i names it, else ``Replicate()``; a dim named by a tuple of axes
        is split major to minor in mesh order, as the reference's is.  A
        mesh dim of size 1 holds the whole tensor either way and gets
        ``Replicate()`` (DTensor's view rules refuse to squeeze a dim
        of size 1 sharded over it, as a one-row microbatch's)."""
        from torch.distributed.tensor import Replicate, Shard
        sizes = _axes(self.mesh).shape
        return tuple(Replicate() if (i := self._dims_of(name)) is None or sizes[name] == 1
                     else Shard(i) for name in self.mesh.mesh_dim_names)

    def local_shape(self, shape) -> Tuple[int, ...]:
        """A rank's shape of a leaf of global ``shape`` (the rules shard
        only dims their axes divide)."""
        sizes = _axes(self.mesh).shape
        out = list(shape)
        for i, part in enumerate(self.spec):
            if part is not None:
                out[i] //= math.prod(sizes[n] for n in (part if isinstance(part, tuple)
                                                        else (part,)))
        return tuple(out)


def _is_leaf(x) -> bool:
    return (isinstance(x, (torch.Tensor, torch.Size, int, float, NamedSharding))
            or hasattr(x, "shape"))


def _shape_of(leaf) -> Tuple[int, ...]:
    if isinstance(leaf, torch.Size):
        return tuple(leaf)
    if isinstance(leaf, (int, float)):
        return ()
    return tuple(leaf.shape)


def tree_map_with_path(fn, tree, *rest, path: str = ""):
    """``fn(path, leaf, *other leaves)`` over a tree of dicts, lists and
    tuples, the path's parts joined by "/" (dict keys, list indices); a
    leaf is a tensor (or fake tensor), a ``torch.Size``, a number, a
    `NamedSharding` or anything with a ``shape``."""
    if _is_leaf(tree):
        return fn(path, tree, *rest)
    join = (lambda k: f"{path}/{k}") if path else str
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest), path=join(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map_with_path(fn, v, *(r[i] for r in rest), path=join(i))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    raise TypeError(f"unsupported tree node {type(tree).__name__} at {path!r}")


def tree_leaves_with_path(tree) -> list:
    """[(path, leaf)] in `tree_map_with_path`'s order."""
    out = []
    tree_map_with_path(lambda p, x: out.append((p, x)), tree)
    return out


def param_shardings(abstract_params, cfg, mesh):
    """Tree of `NamedSharding` matching ``abstract_params``."""
    axes = _axes(mesh)

    def one(path, leaf):
        spec = _spec_for_leaf(path, _shape_of(leaf), axes, _PARAM_RULES,
                              fsdp=cfg.fsdp_params)
        return NamedSharding(mesh, spec)

    return tree_map_with_path(one, abstract_params)


def _used_axes(parts) -> set:
    used = set()
    for p in parts:
        if p is None:
            continue
        if isinstance(p, (tuple, list)):
            used.update(p)
        else:
            used.add(p)
    return used


def opt_state_shardings(abstract_opt, cfg, mesh):
    """ZeRO-1: optimizer moments/master follow the param spec; if a leaf
    leaves dim 0 unsharded and dim 0 divides the data axis, shard it
    there (elementwise update => any sharding is valid)."""
    axes = _axes(mesh)
    dsize = axes.shape.get("data", 1)

    def one(path, leaf):
        shape = _shape_of(leaf)
        spec = _spec_for_leaf(path, shape, axes, _PARAM_RULES, fsdp=cfg.fsdp_params)
        parts = list(spec) + [None] * (len(shape) - len(spec))
        if (
            len(shape) >= 1
            and parts
            and parts[0] is None
            and "data" not in _used_axes(parts)
            and shape[0] % dsize == 0
            and math.prod(shape) > 1024
        ):
            parts[0] = "data"
        return NamedSharding(mesh, P(*parts))

    return tree_map_with_path(one, abstract_opt)


def batch_shardings(abstract_batch, mesh):
    """Inputs: batch dim over all dp axes (with divisibility fallback)."""
    axes = _axes(mesh)

    def one(path, leaf):
        shape = _shape_of(leaf)
        if len(shape) == 0:
            return NamedSharding(mesh, P())
        ax = _resolve("dp", shape[0], axes, fsdp=False, batch_shardable=True)
        return NamedSharding(mesh, P(ax, *([None] * (len(shape) - 1))))

    return tree_map_with_path(one, abstract_batch)


def cache_shardings(abstract_cache, cfg, mesh, *, batch_size: int):
    """KV caches / recurrent state.  If the batch shards over dp we use
    it; otherwise (long_500k: B=1) the sequence dim of KV shards over
    `data` (sequence parallelism)."""
    axes = _axes(mesh)
    dp = _dp_axes(axes)
    total = int(np.prod([axes.shape[a] for a in dp])) if dp else 1
    batch_shardable = bool(dp) and batch_size % total == 0

    def one(path, leaf):
        return NamedSharding(
            mesh,
            _spec_for_leaf(path, _shape_of(leaf), axes, _CACHE_RULES,
                           fsdp=False, batch_shardable=batch_shardable),
        )

    return tree_map_with_path(one, abstract_cache)


def device_put(tree, shardings, *, src_data_rank: Optional[int] = 0):
    """``tree`` placed by ``shardings`` (the reference's
    ``jax.device_put(tree, shardings)``): on a mesh of one rank each
    tensor leaf a plain tensor on the mesh's device (itself if it is
    there already); on a larger mesh a `DTensor` per leaf, scattered from
    rank ``src_data_rank`` (None: each rank builds its own shard, as for
    fake tensors).  Numbers pass through."""
    from torch.distributed.tensor import distribute_tensor

    def one(path, leaf, sh):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        mesh = sh.mesh
        if mesh.size() == 1:
            return leaf.to(mesh.device_type)
        return distribute_tensor(leaf, mesh, sh.placements(), src_data_rank=src_data_rank)

    return tree_map_with_path(one, tree, shardings)


# --- the active mesh (the reference's ``with mesh:``) ------------------------

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("repro_torch_active_mesh",
                                                         default=None)


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[Any]:
    """Make ``mesh`` the active mesh inside the block."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def active_mesh():
    """The mesh of the innermost `use_mesh` block, or None."""
    return _ACTIVE.get()


def _constrain_spec(shape, axes: dict, spec) -> P:
    """`maybe_constrain`'s spec: 'dp' expands to the present data axes,
    'tp' to 'model', and a dim that its axes do not divide replicates."""
    parts = []
    for s in spec:
        if s == "dp":
            dp = tuple(a for a in ("pod", "data") if a in axes)
            parts.append(dp if len(dp) > 1 else (dp[0] if dp else None))
        elif s == "tp":
            parts.append("model" if "model" in axes else None)
        else:
            parts.append(s)
    for i, p in enumerate(parts):
        if p is None:
            continue
        names = p if isinstance(p, tuple) else (p,)
        total = 1
        for n in names:
            total *= axes.get(n, 1)
        if shape[i] % total != 0:
            parts[i] = None
    return P(*parts)


def maybe_constrain(x, *spec):
    """The reference's ``with_sharding_constraint`` iff a mesh is active:
    a `DTensor` is redistributed to the divisibility-pruned spec; a plain
    tensor (every tensor on a mesh of one rank) is returned unchanged."""
    mesh = active_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    target = NamedSharding(mesh, _constrain_spec(x.shape, _axes(mesh).shape, spec))
    return x.redistribute(mesh, target.placements())


# --- the partitioned step: DTensor leaves meet plain tensors and kernels ----

def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def replicate(x):
    """A `DTensor` redistributed to `Replicate` on every mesh dim (a
    partial sum reduced, shards gathered); a plain tensor unchanged."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, (Replicate(),) * x.device_mesh.ndim)


def placed_like(x, like):
    """``x`` redistributed to ``like``'s placements when both are
    DTensors, a partial sum there taken as replicated (nothing is
    redistributed to a partial sum); a plain tensor ``x`` beside a
    DTensor ``like`` becomes a DTensor replicated on its mesh (a
    constant such as RoPE's angles); otherwise ``x`` unchanged."""
    if not is_dtensor(like):
        return x
    from torch.distributed.tensor import DTensor, Replicate
    mesh = like.device_mesh
    if not is_dtensor(x):
        return DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim, run_check=False)
    placements = tuple(Replicate() if p.is_partial() else p for p in like.placements)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def place_batch(batch, mesh):
    """A batch of global arrays placed by `batch_shardings`: on a larger
    mesh every rank keeps its own rows of the global batch it built (no
    rank reads another's); on a mesh of one plain tensors on its device."""
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    return device_put(batch, batch_shardings(batch, mesh), src_data_rank=None)


def batch_rows(x, lo: int, hi: int):
    """Global rows ``[lo, hi)`` of a batch leaf: a plain slice, or for a
    `DTensor` the rows gathered and then placed by `batch_shardings` of
    their own shape (the reference's microbatch split: microbatch i holds
    global rows, not rows of each rank's local block)."""
    if not is_dtensor(x):
        return x[lo:hi]
    rows = replicate(x)[lo:hi]
    sh = batch_shardings(rows, x.device_mesh)
    return rows.redistribute(x.device_mesh, sh.placements())


def head_sharding(mesh, shape) -> NamedSharding:
    """The sharding of a (B, H, S, D) activation where it meets a
    kernel: batch over the dp axes (with `_resolve`'s divisibility
    fallback), heads over ``model`` when they divide it and the batch
    leaves it free, else replicated there (the reference's ``kvh``
    fallback)."""
    axes = _axes(mesh)
    b = _resolve("dp", shape[0], axes, fsdp=False, batch_shardable=True)
    heads = None
    if "model" in axes.shape and "model" not in _used_axes([b]):
        heads = _resolve("kvh", shape[1], axes, fsdp=False, batch_shardable=True)
    return NamedSharding(mesh, P(b, heads, None, None))


def unsplit_dim(x, dim: int, heads: int = 1):
    """``x`` whose dim ``dim`` (H·D) is ready to be viewed as (H, D): a
    `DTensor` whose ``dim`` a mesh dim splits inside a head (H does not
    divide that mesh dim's size) is replicated there; otherwise ``x``.
    With ``heads`` 1 the dim ends whole on every rank."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    mesh, dim = x.device_mesh, dim % x.ndim
    placements = [Replicate() if isinstance(p, Shard) and p.dim % x.ndim == dim
                  and heads % mesh.size(i) else p for i, p in enumerate(x.placements)]
    if placements == list(x.placements):
        return x
    return x.redistribute(mesh, placements)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, its gradient made contiguous: DTensor's view rules
    read a local block by the global tensor's layout, so a gradient that
    leaves `local_map` as a strided block (a transposed product's, as the
    cross-attention's keys get on the host) must be laid out whole."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def with_contiguous_grads(fn):
    """``fn`` whose inputs' gradients come back contiguous: the host's
    plain attention under `on_local_heads` (the kernels' backward
    returns contiguous gradients already)."""
    return lambda *xs: fn(*(_ContiguousGrad.apply(x) for x in xs))


def on_local_heads(fn, q, k, v):
    """``fn(q, k, v)`` on each rank's local blocks of DTensors ``q`` (B,
    Hq, Sq, D) and ``k``, ``v`` (B, Hkv, Sk, D), through `local_map`:
    the inputs are redistributed to `head_sharding` (batch over the dp
    axes, heads over ``model``), and where Hq divides the model axis but
    Hkv does not, k and v are replicated there and each kv head repeated
    for its group of query heads before they are sharded as q, so every
    rank holds the kv heads of its own query heads.  The output is a
    DTensor placed as q; its gradient flows back the same way.  Any
    other input raises."""
    from torch.distributed.tensor.experimental import local_map
    if not all(is_dtensor(t) for t in (q, k, v)) or q.ndim != 4 or k.ndim != 4:
        raise ValueError("on_local_heads takes 4-D DTensors q, k and v")
    mesh = q.device_mesh
    if k.device_mesh != mesh or v.device_mesh != mesh:
        raise ValueError("q, k and v must lie on one mesh")
    b, hq, _, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qs = head_sharding(mesh, q.shape)
    ks = head_sharding(mesh, k.shape)
    q = q.redistribute(mesh, qs.placements())
    k = k.redistribute(mesh, ks.placements())
    v = v.redistribute(mesh, ks.placements())
    if qs.spec[1] is not None and ks.spec[1] is None and hkv != hq:
        group = hq // hkv
        k, v = (t[:, :, None].expand(b, hkv, group, sk, d).reshape(b, hq, sk, d)
                .redistribute(mesh, qs.placements()) for t in (k, v))
        ks = qs
    # lists: local_map reads a tuple of placements as one entry an output
    qp, kp = list(qs.placements()), list(ks.placements())
    return local_map(fn, out_placements=qp, in_placements=(qp, kp, kp),
                     device_mesh=mesh)(q, k, v)


def on_local_groups(fn, *xs, outputs: int = 1):
    """``fn(*xs)`` on each rank's local groups: ``xs`` are DTensors of
    one group count G on one mesh, each placed as `maybe_constrain(x,
    "dp", None, ...)` places it (G over the dp axes, replicated where G
    does not divide them and over ``model``), and ``fn`` returns
    ``outputs`` tensors whose dim 0 is the same local groups, wrapped as
    DTensors placed alike.  Every model rank of a data shard computes
    the same blocks, so ``fn`` must be deterministic; the gradients flow
    back to the inputs in their own placements.  Plain tensors call
    ``fn`` directly; any other input raises."""
    if not any(is_dtensor(x) for x in xs):
        return fn(*xs)
    from torch.distributed.tensor.experimental import local_map
    mesh = xs[0].device_mesh if is_dtensor(xs[0]) else None
    want = None if mesh is None else NamedSharding(mesh, _constrain_spec(
        xs[0].shape, _axes(mesh).shape, ("dp",) + (None,) * (xs[0].ndim - 1))).placements()
    for x in xs:
        if not (is_dtensor(x) and x.device_mesh == mesh and x.shape[0] == xs[0].shape[0]
                and tuple(x.placements) == want):
            raise ValueError("on_local_groups takes DTensors of one group count on one mesh, "
                             "the groups over the dp axes")
    # lists: local_map reads a tuple of placements as one entry an output
    out = list(want) if outputs == 1 else tuple(list(want) for _ in range(outputs))
    return local_map(fn, out_placements=out, in_placements=tuple(list(want) for _ in xs),
                     device_mesh=mesh)(*xs)


def on_local_blocks(fn, xs, in_specs, out_specs, grad_specs=None):
    """``fn(*xs)`` on each rank's local blocks, through `local_map`: input
    i is redistributed to ``in_specs[i]``, a logical spec in
    `maybe_constrain`'s vocabulary (``"dp"``, ``"tp"`` or None a dim,
    pruned by divisibility), and ``fn`` returns a tuple of tensors,
    output j wrapped as ``out_specs[j]`` says.  Each logical name
    resolves once a call, from the inputs that carry it (two inputs that
    resolve it differently raise), and an output dim so named takes the
    same mesh axes.  ``grad_specs[i]`` (a tuple of logical names, or
    None) declares input i's gradient a partial sum over the mesh axes
    those names resolved to: an input replicated there whose local
    gradient differs by rank, because each rank contracts it with its
    own blocks of another input (a parameter beside batch rows sharded
    over the dp axes; rows beside channels sharded over ``model``).  A
    name that resolved to no axis adds nothing: every rank then computes
    the same.  Plain tensors call ``fn`` directly; a plain tensor beside
    a DTensor raises."""
    if not any(is_dtensor(x) for x in xs):
        return fn(*xs)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = next(x for x in xs if is_dtensor(x)).device_mesh
    if not all(is_dtensor(x) and x.device_mesh == mesh for x in xs):
        raise ValueError("on_local_blocks takes DTensors on one mesh")
    sizes = _axes(mesh).shape
    resolved, placed, in_pl = {}, [], []
    for x, spec in zip(xs, in_specs):
        part = _constrain_spec(x.shape, sizes, spec)
        for name, axes in zip(spec, part):
            if name is not None and resolved.setdefault(name, axes) != axes:
                raise ValueError(f"on_local_blocks: {name!r} resolves to {axes!r} and "
                                 f"{resolved[name]!r} in one call")
        pl = NamedSharding(mesh, part).placements()
        # an input already in place is passed as it is: a redistribution
        # to the same placements would still reduce a partial gradient
        placed.append(x if tuple(x.placements) == pl else x.redistribute(mesh, pl))
        in_pl.append(list(pl))

    def placements(spec):
        return list(NamedSharding(mesh, P(*(resolved[s] if s is not None else None
                                            for s in spec))).placements())

    def partial_over(pl, names):
        axes = _used_axes(resolved[n] for n in names)
        out = list(pl)
        for i, dim in enumerate(mesh.mesh_dim_names):
            if dim in axes and sizes[dim] > 1:
                if pl[i] != Replicate():
                    raise ValueError(f"on_local_blocks: a gradient partial over {dim!r} "
                                     f"of an input sharded there")
                out[i] = Partial()
        return out

    grads = None
    if grad_specs is not None:
        grads = tuple(pl if names is None else partial_over(pl, names)
                      for pl, names in zip(in_pl, grad_specs))
    # lists: local_map reads a tuple of placements as one entry an output
    return local_map(fn, out_placements=tuple(placements(s) for s in out_specs),
                     in_placements=tuple(in_pl), in_grad_placements=grads,
                     device_mesh=mesh)(*placed)


# --- learned-index shard placement -----------------------------------------
# The sharded index service stacks per-shard (snapshot, delta) arrays on
# a leading "shard" axis; where the process group holds several ranks
# the stacked rows place shard-per-rank for the plain (non-kernel)
# strategies.  Kept separate from the model rules above: index shards
# are data placement, not parameter sharding.

def index_shard_mesh(num_shards: int, device_type: str = "cuda"):
    """1-D ("shard",) mesh for a stacked per-shard index, or None when
    the process group has one rank (one card: no group, or a world of
    one) or no rank count divides num_shards."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    ranks = dist.get_world_size() if dist.is_initialized() else 1
    if ranks < 2 or num_shards < 2:
        return None
    use = min(ranks, num_shards)
    while use > 1 and num_shards % use != 0:
        use -= 1  # divisibility fallback, same rule as _resolve
    if use < 2:
        return None
    return DeviceMesh(device_type, list(range(use)), mesh_dim_names=("shard",))


def place_index_shards(arrays, mesh):
    """Every stacked leaf with its leading axis over the shard mesh
    (leaves whose leading dim doesn't divide replicate)."""
    size = mesh.size()

    def one(path, leaf):
        if len(_shape_of(leaf)) == 0 or leaf.shape[0] % size != 0:
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, P("shard", *([None] * (leaf.ndim - 1))))

    return device_put(arrays, tree_map_with_path(one, arrays))
