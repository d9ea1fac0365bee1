"""Name-based sharding rules, and sharded parameters on the port's ranks.

The port of the JAX package's ``distributed/sharding.py``.  Mesh axes:
  pod    — data parallelism across pods
  data   — FSDP + DP within a pod
  model  — flattened head*head_dim, d_ff, vocab, experts

The rule tables and the functions that read them are the reference's,
verbatim, on the reference's tree paths (``blocks/scan/0/attn/wq/w``);
:func:`ref_path` reads a port parameter name (``blocks.3.attn.wq.w``) as
such a path.  The port keeps one tensor per layer where the reference
stacks a pattern position's layers for ``lax.scan``, so a port leaf's spec
is the reference's with the scan's leading ``None`` dropped.  :class:`P`
stands in for ``PartitionSpec``: one entry per dimension, an axis name,
a tuple of names or None (replicated).

Placement (what GSPMD does for the reference, done by hand):
  - :func:`shard_params` stores each parameter as this rank's block only,
    split as the config's ``sharding`` says, the same strategy the steps
    split the batch by (``torch.nn.utils.parametrize``: the model code
    that reads ``p.wq.w`` gets the whole tensor, gathered at that read and
    freed after its use; a ``torch.utils.checkpoint`` recompute gathers
    again).  The backward
    of the gather leaves each block's gradient complete: the gradient of
    the whole weight restricted to the block, summed over the batch axes
    and over no other (``comm.gather_blocks``).
  - Activations are this rank's rows of the batch, ``fit_batch_axes``'s
    split (:class:`MeshHints`); under "2d" the ranks of one ``model``
    line compute the same rows, under "fsdp" the batch is split over
    ``model`` too.  Global means (the loss, the MoE terms) go through
    ``comm.batch_mean``.
  - :func:`shard_state` gives AdamW's moments their parameter's blocks;
    AdamW is elementwise, so it runs on the blocks in place.
  - Under "2d" the ranks of a ``model`` line split heads, the FFN's and
    the RG-LRU's width and the vocabulary (:class:`MeshHints`); a decode
    state is
    stored as STATE_RULES' blocks (:func:`init_decode_state`,
    :func:`decode_state`).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn
from torch.nn.utils import parametrize

from repro_torch.distributed import comm
from repro_torch.models.layers import Hints


class P(tuple):
    """A partition spec: per dimension an axis name, a tuple of axis
    names (split over their product, the first most significant) or None."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):  # pickle: the parts, not one tuple of them
        return tuple(self)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def batch_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def fit_batch_axes(mesh, batch_size: int, strategy: str = "2d"):
    """Largest prefix-product of batch axes that divides ``batch_size``
    (e.g. global_batch=1 -> no batch sharding; 128 on (pod,data)=32 -> both).

    strategy='fsdp' also spreads batch over 'model' (pure ZeRO DP: there is
    no tensor-parallel compute, so 'model' is free for data)."""
    base = batch_axes(mesh)
    if strategy == "fsdp" and "model" in mesh.axis_names:
        base = base + ("model",)
    axes = []
    prod = 1
    for a in base:
        size = mesh.shape[a]
        if batch_size % (prod * size) == 0:
            axes.append(a)
            prod *= size
    return tuple(axes)


def fit_batch_spec(mesh, batch_size: int, strategy: str = "2d"):
    axes = fit_batch_axes(mesh, batch_size, strategy)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


# (regex on 'path', spec) — first match wins.  Paths look like
# 'blocks/scan/0/attn/wq/w' (group index stripped of integers).
PARAM_RULES = [
    (r"embed/", P("model", "data")),                      # (V, d)
    (r"head/.*b$", P(None)),
    (r"head/", P("data", "model")),                       # (d, V)
    (r"(qnorm|knorm|norm1|norm2|final_norm|ln_x)", P(None)),
    (r"attn/w[qkv]/w$", P("data", "model")),              # (d, H*D)
    (r"attn/wo/w$", P("model", "data")),                  # (H*D, d)
    (r"(ffn|mlp)/(up|gate)/w$", P("data", "model")),      # (d, dff)
    (r"(ffn|mlp)/down/w$", P("model", "data")),           # (dff, d)
    (r"moe/router/w$", P("data", None)),                  # (d, E)
    (r"moe/(up|gate)$", P("model", "data", None)),        # (E, d, f)
    (r"moe/down$", P("model", None, "data")),             # (E, f, d)
    (r"rec/(in_x|in_gate)/w$", P("data", "model")),       # (d, w)
    (r"rec/gate_[ai]/w$", P("model", None)),              # (w, w)
    (r"rec/out/w$", P("model", "data")),                  # (w, d)
    (r"rec/conv_w$", P(None, "model")),                   # (K, w)
    (r"rec/lambda$", P("model")),                         # (w,)
    (r"tm/w[rkvg]/w$", P("data", "model")),               # rwkv (d, d)
    (r"tm/wo/w$", P("model", "data")),
    (r"tm/decay_a/w$", P("data", None)),
    (r"tm/decay_b/w$", P(None, "model")),
    (r"tm/u$", P("model", None)),                         # (H, hd)
    (r"tm/w0$", P("model")),
    (r"tm/(mu|cm_mu)$", P(None, "model")),
    (r"tm/cm_k/w$", P("data", "model")),
    (r"tm/cm_v/w$", P("model", "data")),
    (r"tm/cm_r/w$", P("data", "model")),
    (r"/b$", P(None)),                                    # biases replicated
]

STATE_RULES = [
    (r"/k$|/v$", lambda b: P(b, "model", None, None)),    # KV cache (B,S,KV,D)
    (r"/h$", lambda b: P(b, "model")),                    # RG-LRU state (B, w)
    (r"/conv$", lambda b: P(b, None, "model")),
    (r"/s$", lambda b: P(b, "model", None, None)),        # RWKV state
    (r"(tm_last|cm_last)$", lambda b: P(b, None)),
    (r"pos$", lambda b: P()),
]


def _match(rules, path: str):
    for pat, spec in rules:
        if re.search(pat, path):
            return spec
    return None


def _maybe_scan_prefix(path: str, spec: P) -> P:
    if re.search(r"(^|/)scan(/|$)", path):
        return P(*((None,) + tuple(spec)))
    return spec


def param_pspec(path: str, ndim: int, zero_over_pod: bool = False) -> P:
    spec = _match(PARAM_RULES, path)
    if spec is None:
        spec = P(*([None] * ndim))
    spec = _maybe_scan_prefix(path, spec)
    if zero_over_pod:
        parts = list(spec) + [None] * (ndim - len(tuple(spec)))
        for i, ax in enumerate(parts):
            if ax == "data":
                parts[i] = ("pod", "data")
                break
        spec = P(*parts)
    # pad to ndim
    parts = list(tuple(spec))
    if len(parts) < ndim:
        parts = parts + [None] * (ndim - len(parts))
    return P(*parts)


def param_pspec_fsdp(path: str, shape, mesh_sizes=(("data", 16), ("model", 16))
                     ) -> P:
    """Pure-ZeRO rule: shard ONE dimension of every tensor over as many mesh
    axes as divide it (largest sharding first); no tensor parallelism.

    The compute gathers weights per layer (FSDP) and keeps activations
    batch-sharded over all axes — no per-layer activation all-reduce."""
    ndim = len(shape)
    scan = bool(re.search(r"(^|/)scan(/|$)", path))
    dims = list(range(1 if scan else 0, ndim))  # never shard the scan dim
    # candidate axis groups, widest first
    groups = [tuple(a for a, _ in mesh_sizes),
              (mesh_sizes[0][0],), (mesh_sizes[1][0],)]
    sizes = {g: 1 for g in groups}
    for g in groups:
        n = 1
        for a, s in mesh_sizes:
            if a in g:
                n *= s
        sizes[g] = n
    parts = [None] * ndim
    # prefer the largest dim for sharding (weight matrices get full spread)
    for g in groups:
        ok = [d for d in dims if shape[d] % sizes[g] == 0]
        if ok:
            d = max(ok, key=lambda i: shape[i])
            parts[d] = g if len(g) > 1 else g[0]
            break
    return P(*parts)


# ---------------------------------------------------------------------------
# The port's names as reference paths, and the spec trees
# ---------------------------------------------------------------------------

def ref_path(name: str) -> str:
    """A port parameter name as the reference's tree path, for the rules:
    ``embed`` -> ``embed/tokens``, ``embed.0`` -> ``embed/cb0``,
    ``head.0.w`` -> ``head/cb0/w``, ``blocks.3.rec.lam`` ->
    ``blocks/3/rec/lambda`` (no ``scan``: the port's layers are unstacked)."""
    parts = name.split(".")
    if parts[0] in ("embed", "head") and len(parts) > 1 \
            and parts[1].isdigit():
        parts[1] = f"cb{parts[1]}"
    if parts == ["embed"]:
        parts = ["embed", "tokens"]
    return "/".join("lambda" if p == "lam" else p for p in parts)


def _shapes(params) -> Dict[str, tuple]:
    """{name: whole shape} of a model (sharded or not) or a mapping of
    tensors (or anything with ``.shape``)."""
    if isinstance(params, nn.Module):
        return {k: full_shape(params, k) for k in stored(params)}
    return {k: tuple(v.shape) for k, v in params.items()}


def _fsdp_sizes(mesh) -> tuple:
    names = tuple(a for a in ("data", "model")
                  if mesh is None or a in mesh.axis_names)
    return tuple((a, (mesh.shape[a] if mesh is not None else 16))
                 for a in names)


def param_pspecs(params_tree, zero_over_pod: bool = False,
                 strategy: str = "2d", mesh=None) -> Dict[str, P]:
    """{name: P} of a model's parameters (or a name -> tensor mapping:
    AdamW's moments take their parameter's names)."""
    shapes = _shapes(params_tree)
    if strategy == "fsdp":
        msizes = _fsdp_sizes(mesh)
        return {k: param_pspec_fsdp(ref_path(k), s, msizes)
                for k, s in shapes.items()}
    return {k: param_pspec(ref_path(k), len(s), zero_over_pod)
            for k, s in shapes.items()}


_STATE_FIELDS = {"k", "v", "h", "conv", "s", "tm_last", "cm_last"}


def state_pspecs(state_tree, mesh):
    """The spec tree of a decode state (``init_decode_state``'s layout:
    ``{"layers": [AttnState | RGLRUState | RWKVState], "pos": int}``),
    each NamedTuple field replaced by its P."""
    def spec(field, leaf):
        nd = len(leaf.shape)
        rule = _match(STATE_RULES, "/" + field)
        if rule is None or nd == 0:
            return P(*([None] * nd))
        parts = list(rule(fit_batch_spec(mesh, leaf.shape[0])))
        return P(*(parts + [None] * (nd - len(parts)))[:nd])

    layers = [type(st)(*(spec(f, getattr(st, f)) for f in st._fields))
              for st in state_tree["layers"]]
    return {"layers": layers, "pos": P()}


def batch_pspecs(batch_tree, mesh):
    out = {}
    for k, leaf in batch_tree.items():
        nd = len(leaf.shape)
        out[k] = P() if nd == 0 else P(
            *([fit_batch_spec(mesh, leaf.shape[0])] + [None] * (nd - 1)))
    return out


# ---------------------------------------------------------------------------
# Placement: parameters stored as this rank's blocks
# ---------------------------------------------------------------------------

def split_dims(spec) -> tuple:
    """((dim, axes), ...) of the dimensions ``spec`` splits."""
    return tuple((d, ax if isinstance(ax, tuple) else (ax,))
                 for d, ax in enumerate(spec) if ax is not None)


class ShardPlan:
    """A sharded model's mesh, strategy (its config's ``sharding``) and the
    batch axes of the step in flight (the gathers' backward sums over
    them; set by the step)."""

    def __init__(self, mesh, strategy: str = "2d"):
        if mesh.rank is None:
            raise ValueError(f"{mesh} has no ranks: place parameters on a "
                             "live mesh (launch.mesh.make_host_mesh)")
        self.mesh, self.strategy = mesh, strategy
        self.batch_axes: tuple = ()

    def spec(self, name: str, shape) -> P:
        if self.strategy == "fsdp":
            return param_pspec_fsdp(ref_path(name), shape,
                                    _fsdp_sizes(self.mesh))
        return param_pspec(ref_path(name), len(shape))

    def block(self, full: torch.Tensor, spec) -> torch.Tensor:
        """This rank's block of ``full`` (a fresh contiguous tensor)."""
        t = full
        for dim, axes in split_dims(spec):
            t = comm.own_block(t, dim, self.mesh, axes)
        return t.clone(memory_format=torch.contiguous_format)


class Placed(nn.Module):
    """The parametrization of a parameter stored as its block: reading the
    parameter gathers the whole tensor (``comm.gather_blocks``)."""

    def __init__(self, plan: ShardPlan, name: str, shape, spec: P):
        super().__init__()
        self.plan, self.name = plan, name
        self.shape, self.spec = tuple(shape), spec

    def forward(self, block):
        return self.gather(block)

    def gather(self, block, keep=()):
        """The tensor gathered along every split axis but ``keep``."""
        dims = tuple((d, axes) for d, axes in split_dims(self.spec)
                     if not set(axes) & set(keep))
        return comm.gather_blocks(block, self.plan.mesh, dims,
                                  self.plan.batch_axes)


def placed(owner: nn.Module, attr: str) -> Optional[Placed]:
    """The :class:`Placed` of ``owner.attr``, or None (not sharded)."""
    if parametrize.is_parametrized(owner, attr):
        return owner.parametrizations[attr][0]
    return None


def stored_tensor(owner: nn.Module, attr: str) -> torch.Tensor:
    """What ``owner`` stores for ``attr``: the block of a sharded
    parameter (nothing gathered), else the parameter."""
    if parametrize.is_parametrized(owner, attr):
        return owner.parametrizations[attr].original
    return getattr(owner, attr)


def _owners(model: nn.Module):
    """(name, owner module, attribute) of every parameter, in order."""
    for mname, mod in model.named_modules():
        if isinstance(mod, parametrize.ParametrizationList):
            continue
        attrs = list(mod._parameters)
        if parametrize.is_parametrized(mod):
            attrs += list(mod.parametrizations.keys())
        for attr in attrs:
            if mod._parameters.get(attr) is None and not \
                    parametrize.is_parametrized(mod, attr):
                continue
            yield (f"{mname}.{attr}" if mname else attr), mod, attr


def stored(model: nn.Module) -> Dict[str, torch.Tensor]:
    """{parameter name: stored tensor}, named as an unsharded model's
    ``named_parameters`` names them (sharded or not)."""
    return {name: stored_tensor(mod, attr)
            for name, mod, attr in _owners(model)}


def full_shape(model: nn.Module, name: str) -> tuple:
    """The whole shape of parameter ``name`` (a block's or not)."""
    mod, attr = _resolve(model, name)
    pl = placed(mod, attr)
    return pl.shape if pl is not None else tuple(getattr(mod, attr).shape)


def _resolve(model: nn.Module, name: str):
    owner, _, attr = name.rpartition(".")
    return (model.get_submodule(owner) if owner else model), attr


def specs_of(model: nn.Module) -> Dict[str, P]:
    """{name: P} of a sharded model's stored blocks (all-None where a
    parameter is not sharded)."""
    out = {}
    for name, mod, attr in _owners(model):
        pl = placed(mod, attr)
        out[name] = pl.spec if pl is not None else P(
            *([None] * getattr(mod, attr).dim()))
    return out


def shard_module(module: nn.Module, prefix: str, plan: ShardPlan) -> None:
    """Store every parameter of ``module`` not yet placed as its block
    (``prefix``: the module's name in the model)."""
    for name, mod, attr in list(_owners(module)):
        if placed(mod, attr) is not None:
            continue
        full = getattr(mod, attr)
        full_name = f"{prefix}.{name}" if prefix else name
        shape = tuple(full.shape)
        spec = plan.spec(full_name, shape)
        mod._parameters[attr] = nn.Parameter(
            plan.block(full.detach(), spec), requires_grad=full.requires_grad)
        del full
        parametrize.register_parametrization(
            mod, attr, Placed(plan, full_name, shape, spec), unsafe=True)


def shard_params(model: nn.Module, cfg, mesh) -> nn.Module:
    """``model`` with every parameter stored as this rank's block under
    ``cfg.sharding`` (in place; parameters already placed are kept).
    ``model.shard_plan`` holds the mesh and the step's batch axes."""
    plan = getattr(model, "shard_plan", None)
    if plan is None:
        plan = ShardPlan(mesh, cfg.sharding)
        model.shard_plan = plan
    shard_module(model, "", plan)
    return model


def init_sharded_params(cfg, mesh, generator: Optional[torch.Generator] = None,
                        device="cuda"):
    """``init_params``'s model (the same draws from ``generator``), each
    layer placed right after it is drawn, so no rank holds more than one
    whole layer (and the embeddings) at a time."""
    from repro_torch.models.transformer import init_params
    plan = ShardPlan(mesh, cfg.sharding)
    model = init_params(cfg, generator, device,
                        place=lambda name, m: shard_module(m, name, plan))
    model.shard_plan = plan
    return shard_params(model, cfg, mesh)


def shard_state(state: dict, cfg, mesh) -> dict:
    """A train state (``launch.train.build_state``'s layout) with the
    parameters and AdamW's moments stored as this rank's blocks, the
    moments in their parameter's spec."""
    model = shard_params(state["params"], cfg, mesh)
    plan = model.shard_plan
    specs = specs_of(model)
    opt = {k: {n: plan.block(t, specs[n]) for n, t in tree.items()}
           for k, tree in state["opt"].items()}
    return dict(state, params=model, opt=opt)


def is_sharded(model: nn.Module) -> bool:
    return getattr(model, "shard_plan", None) is not None


# ---------------------------------------------------------------------------
# Whole tensors (checkpoints) and the gradient norm
# ---------------------------------------------------------------------------

@torch.no_grad()
def whole(model: nn.Module, tree: Mapping[str, torch.Tensor]
          ) -> Dict[str, torch.Tensor]:
    """The whole tensors of a tree of blocks named like ``model``'s
    parameters (the parameters, or AdamW's m or v): a collective on every
    rank of the mesh."""
    plan = model.shard_plan
    specs = specs_of(model)
    return {k: comm.gather_blocks(t, plan.mesh, split_dims(specs[k]), ())
            for k, t in tree.items()}


@torch.no_grad()
def blocks_of(model: nn.Module, tree: Mapping[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
    """This rank's blocks of a tree of whole tensors named like
    ``model``'s parameters."""
    plan = model.shard_plan
    specs = specs_of(model)
    return {k: plan.block(t, specs[k]) for k, t in tree.items()}


def global_norm(grads: Mapping[str, torch.Tensor], model: nn.Module
                ) -> torch.Tensor:
    """sqrt of the sum of squares of the whole gradient, each element
    counted once: a block enters the sum on the first of the ranks that
    hold it (coordinate 0 on every axis its spec does not split), then
    one sum over all ranks."""
    plan = model.shard_plan
    mesh = plan.mesh
    specs = specs_of(model)
    total = None
    for k, g in grads.items():
        split = {a for _, axes in split_dims(specs[k]) for a in axes}
        if any(mesh.coords[a] for a in mesh.axis_names if a not in split):
            continue
        ss = torch.sum(torch.square(g.float()))
        total = ss if total is None else total + ss
    dev = next(iter(grads.values())).device
    if total is None:
        total = torch.zeros((), dtype=torch.float32, device=dev)
    return torch.sqrt(comm.sum_over(total, mesh, mesh.axis_names))


def shard_batch(batch: Mapping[str, torch.Tensor], mesh, axes) -> dict:
    """This rank's rows of every tensor of a global batch."""
    return {k: comm.own_block(v, 0, mesh, axes) for k, v in batch.items()}


MODEL = ("model",)


class MeshHints(Hints):
    """The hints of a model sharded on ``mesh``: its ``mesh`` routes the
    MoE (``moe_impl="ep"`` takes ``models.moe_ep``), :meth:`bind` sets the
    batch split of a step, and the activations are this rank's rows.

    Under "2d" the ranks of a ``model`` line split the compute (``tp``
    ranks, the reference's ``MeshHints.heads`` / ``kv_heads`` / ``logits``
    and the FFN's specs): query heads when H divides (KV heads too when KV
    divides, else k and v whole), else the rows of q (sequence-parallel
    attention); the FFN's and the RG-LRU's hidden width; the vocabulary
    of the embedding and the logits.  Each rank reads
    its block of a weight split over ``model`` (:meth:`block`: nothing
    gathered over ``model``), ``copy_in`` / ``sum_out`` enter and leave
    a split region (``comm.copy_over`` / ``comm.sum_over``), and
    :meth:`logits` gathers the vocabulary.  Under "fsdp" nothing is
    split but the batch.  A decode state is stored as STATE_RULES' blocks
    under either strategy: its model dimension (the KV cache's sequence,
    the recurrent states' width) over ``model``."""

    def __init__(self, mesh, strategy: str = "2d"):
        self.mesh = mesh
        self.strategy = strategy
        self.batch_axes: tuple = ()
        self.rows: Optional[int] = None
        m = mesh.shape.get("model", 1)
        self.state_split = m
        self.model_index = mesh.index(MODEL) if m > 1 else 0
        self.tp = m if strategy == "2d" else 1

    def bind(self, batch_size: int, strategy: Optional[str] = None) -> tuple:
        """Split a global batch of ``batch_size`` rows
        (:func:`fit_batch_axes` under ``strategy``, default the
        model's); returns the batch axes."""
        self.batch_axes = fit_batch_axes(self.mesh, batch_size,
                                         strategy or self.strategy)
        self.rows = batch_size // self.mesh.count(self.batch_axes)
        return self.batch_axes

    def activation(self, x):
        """Checks that ``x`` holds this rank's rows of the batch."""
        if self.rows is not None and x.shape[0] != self.rows:
            raise ValueError(f"activation of {x.shape[0]} rows where this "
                             f"rank holds {self.rows} ({self.batch_axes})")
        return x

    def heads(self, H: int, S: int) -> Optional[str]:
        """How the ranks of a model line split attention over (B, S, H, D):
        "heads" when H divides, else "seq" (q's rows) when S divides,
        else None (every rank computes all of it)."""
        if self.tp == 1:
            return None
        if H % self.tp == 0:
            return "heads"
        return "seq" if S % self.tp == 0 else None

    def kv_heads(self, KV: int) -> bool:
        """True when k and v split by head as q does (KV divides)."""
        return self.tp > 1 and KV % self.tp == 0

    def block(self, owner, attr: str, dim: int):
        """``owner.attr`` with ``dim`` as this rank's block over ``model``:
        gathered over the other axes only where the spec puts ``dim`` on
        ``model``; else the whole tensor (its gradient summed over
        ``model``) cut."""
        if self.tp == 1:
            return getattr(owner, attr)
        pl = placed(owner, attr)
        if pl is not None and dict(split_dims(pl.spec)).get(dim) == MODEL:
            return pl.gather(stored_tensor(owner, attr), keep=MODEL)
        return comm.own_block(self.copy_in(getattr(owner, attr)), dim,
                              self.mesh, MODEL)

    def copy_in(self, t):
        return comm.copy_over(t, self.mesh, MODEL) if self.tp > 1 else t

    def sum_out(self, t):
        return comm.sum_over(t, self.mesh, MODEL) if self.tp > 1 else t

    def logits(self, x):
        """The whole last dimension from this rank's block of it (the
        vocabulary's columns); the backward keeps the block's gradient."""
        if self.tp == 1:
            return x
        return comm.gather_blocks(x.contiguous(), self.mesh,
                                  ((x.dim() - 1, MODEL),), ())

    def own_cols(self, x):
        return comm.own_part(x, x.dim() - 1, self.mesh, MODEL) \
            if self.tp > 1 else x

    def whole_seq(self, x):
        """Dim 1 gathered from every rank's block of it."""
        return comm.gather_blocks(x.contiguous(), self.mesh, ((1, MODEL),),
                                  ())

    def model_gather(self, x, dim: int):
        """Every model rank's ``x`` along ``dim`` (no gradient)."""
        if self.state_split == 1:
            return x
        return comm.all_gather(x.contiguous(), dim, self.mesh.group(MODEL),
                               self.state_split)

    def whole_state(self, st):
        """A recurrent layer's state with its model dimension gathered."""
        return type(st)(*(
            t if d is None else self.model_gather(t, d)
            for t, d in zip(st, state_model_dims(st))))

    def state_block(self, st):
        """A recurrent layer's whole state as this rank's blocks."""
        return model_blocks(st, self.mesh)

    def batch_mean(self, value, weight):
        return comm.batch_mean(value, weight, self.mesh, self.batch_axes)

    def all_rows(self, x):
        return comm.gather_blocks(x, self.mesh, ((0, self.batch_axes),),
                                  self.batch_axes)

    def own_rows(self, x):
        return comm.own_block(x, 0, self.mesh, self.batch_axes)


# ---------------------------------------------------------------------------
# Decode states as this rank's blocks (STATE_RULES)
# ---------------------------------------------------------------------------

def state_model_dims(st) -> tuple:
    """The dimension STATE_RULES puts on ``model`` for each field of a
    layer's state (None: not split)."""
    out = []
    for f in st._fields:
        rule = _match(STATE_RULES, "/" + f)
        spec = tuple(rule(None)) if rule is not None else ()
        out.append(spec.index("model") if "model" in spec else None)
    return tuple(out)


def model_blocks(st, mesh):
    """This rank's blocks over ``model`` of a layer's state whose rows are
    already this rank's (fresh contiguous tensors)."""
    def cut(t, d):
        if d is None or mesh.shape.get("model", 1) == 1:
            return t
        return comm.own_block(t, d, mesh, MODEL).clone(
            memory_format=torch.contiguous_format)
    return type(st)(*(cut(t, d) for t, d in zip(st, state_model_dims(st))))


def init_decode_state(cfg, mesh, batch: int, cache_len: int, device="cuda"):
    """``init_decode_state``'s zero state as this rank's blocks
    (STATE_RULES: the rows of the "2d" batch split, the model dimension
    over ``model``); only the blocks are allocated."""
    from repro_torch.models.transformer import init_decode_state as whole
    rows = batch // mesh.count(fit_batch_axes(mesh, batch))
    m = mesh.shape.get("model", 1)
    layers = []
    for st in whole(cfg, rows, cache_len, device=torch.device("meta"))[
            "layers"]:
        parts = []
        for t, d in zip(st, state_model_dims(st)):
            shape = list(t.shape)
            if d is not None:
                if shape[d] % m:
                    raise ValueError(f"{tuple(t.shape)}: dim {d} does not "
                                     f"split over model={m}")
                shape[d] //= m
            parts.append(torch.zeros(shape, dtype=t.dtype, device=device))
        layers.append(type(st)(*parts))
    return {"layers": layers, "pos": 0}


def decode_state(cfg, state, mesh, batch: int, cache_len: int):
    """This rank's blocks of the decode state that goes on from a sharded
    prefill's ``state`` (of a global batch of ``batch`` rows), with KV
    caches of ``cache_len`` positions (``attention.decode_cache``: a ring
    of ``window`` slots for a local layer when the cache reaches it).
    Where the prefill split k and v by head, the heads are gathered over
    ``model`` before each rank keeps its block of the sequence; where it
    split the batch over ``model`` ("fsdp"), the rows are gathered to
    STATE_RULES' rows."""
    from repro_torch.configs.base import ATTN_LOCAL
    from repro_torch.models.attention import AttnState, decode_cache
    act = fit_batch_axes(mesh, batch, cfg.sharding)
    extra = tuple(a for a in act if a not in fit_batch_axes(mesh, batch))
    pos = state["pos"]

    def rows(t):
        if mesh.count(extra) == 1:
            return t
        return comm.all_gather(t.contiguous(), 0, mesh.group(extra),
                               mesh.count(extra))

    layers = []
    for kind, st in zip(cfg.layer_kinds(), state["layers"]):
        st = type(st)(*(rows(t) for t in st))
        if isinstance(st, AttnState):
            window = cfg.window if kind == ATTN_LOCAL else 0

            def whole(t):
                if t.shape[2] < cfg.num_kv_heads:      # split by KV head
                    t = comm.all_gather(t.contiguous(), 2,
                                        mesh.group(MODEL),
                                        mesh.shape["model"])
                return decode_cache(t, pos, cache_len, window)
            st = AttnState(k=whole(st.k), v=whole(st.v))
        layers.append(model_blocks(st, mesh))
    return {"layers": layers, "pos": pos}


def share_bytes(model: nn.Module, *trees) -> int:
    """The bytes this rank's share of ``model``'s parameters and of each
    tree named like them (AdamW's m and v) come to: each whole tensor's
    bytes over the number of blocks its spec splits it into."""
    total = 0
    for k, spec in specs_of(model).items():
        n = 1
        for s in full_shape(model, k):
            n *= s
        split = {a for _, axes in split_dims(spec) for a in axes}
        blocks = 1
        for a in split:
            blocks *= model.shard_plan.mesh.shape[a]
        size = stored(model)[k].element_size() + sum(
            t[k].element_size() for t in trees)
        total += n * size // blocks
    return total


def tree_bytes(tree: Any) -> int:
    """Bytes of the tensors of a nested dict/list (or a model's stored
    tensors)."""
    if isinstance(tree, nn.Module):
        tree = stored(tree)
    if isinstance(tree, Mapping):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0
