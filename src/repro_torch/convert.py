"""Carry operators and options across from the JAX reference package.

Works on plain numpy arrays and names, so it needs nothing of the
reference at run time: ``dia_from_numpy(A.offsets, np.asarray(A.bands))``
rebuilds a reference ``DiaMatrix`` here with the same ``fingerprint()``,
``bsr_from_numpy(np.asarray(A.indices), np.asarray(A.blocks))`` a
reference ``BsrMatrix``, and ``lm_params_from_numpy(cfg, tree)`` the LM of
a reference ``init_params`` tree (``jax.tree.map(np.asarray, params)``; any
tree shaped like it, gradients too), ``train_state_from_numpy`` a
reference train state (``sharded_params_from_numpy`` /
``sharded_train_state_from_numpy``: this rank's blocks of them on a
mesh), ``decode_state_from_numpy`` a reference decode state
(``sharded_decode_state_from_numpy``: this rank's blocks), and
``model_from_fields(name,
dataclasses.asdict(obj))`` the port's ``Hardware``, ``SolverPhaseModel``
or ``RunModel`` of a reference one.
"""
from __future__ import annotations

from typing import Any, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.krylov.operator import BsrMatrix
from repro_torch.core.krylov.operators import DiaMatrix
from repro_torch.core.krylov.options import PrecisionPolicy
from repro_torch.configs.base import ATTN, ATTN_LOCAL, RECURRENT, RWKV
from repro_torch.models.attention import Attention
from repro_torch.models.layers import MLP, Linear, RMSNorm
from repro_torch.models.moe import MoE
from repro_torch.models.recurrent import RGLRU
from repro_torch.models.recurrent import RWKV as RWKVParams
from repro_torch.models.transformer import LM, Block


def dia_from_numpy(offsets: Sequence[int], bands: np.ndarray,
                   grid_shape: Optional[Tuple[int, int]] = None,
                   device="cuda") -> DiaMatrix:
    """A ``DiaMatrix`` over a copy of ``bands`` (dtype and bytes kept)."""
    arr = np.ascontiguousarray(bands)
    return DiaMatrix(offsets=tuple(int(o) for o in offsets),
                     bands=torch.from_numpy(arr.copy()).to(device),
                     grid_shape=None if grid_shape is None
                     else (int(grid_shape[0]), int(grid_shape[1])))


def bsr_from_numpy(indices: np.ndarray, blocks: np.ndarray,
                   device="cuda") -> BsrMatrix:
    """A ``BsrMatrix`` over copies of ``indices`` (as int32) and ``blocks``
    (dtype and bytes kept)."""
    ind = np.ascontiguousarray(indices, dtype=np.int32)
    blk = np.ascontiguousarray(blocks)
    return BsrMatrix(indices=torch.from_numpy(ind.copy()).to(device),
                     blocks=torch.from_numpy(blk.copy()).to(device))


def policy_from_name(name: str) -> PrecisionPolicy:
    """The port's ``PrecisionPolicy`` for a reference preset name."""
    return PrecisionPolicy.from_name(name)


def model_from_fields(name: str, fields: Mapping[str, Any]):
    """The port's ``Hardware``, ``SolverPhaseModel`` or ``RunModel`` (by
    ``name``) over a reference instance's fields, as plain numbers.

    ``fields`` is ``dataclasses.asdict`` of the reference object, so a
    phase model's ``hw`` arrives as a dict of its own.  Nothing keeps the
    reference's defaults: every field is carried across.
    """
    from repro_torch.core.noise.simulator import Hardware, SolverPhaseModel
    from repro_torch.core.noise.traces import RunModel

    def hardware(f):
        return Hardware(**{k: float(v) for k, v in f.items()})

    if name == "Hardware":
        return hardware(fields)
    if name == "RunModel":
        return RunModel(base=float(fields["base"]),
                        scale=float(fields["scale"]))
    if name == "SolverPhaseModel":
        kw = dict(fields)
        kw["hw"] = hardware(kw["hw"])
        for key in ("storage_words", "wire_words"):
            kw[key] = float(kw[key])
        for key in ("grid", "grid_points"):
            kw[key] = tuple(int(v) for v in kw[key])
        return SolverPhaseModel(**kw)
    raise ValueError(f"no port counterpart for {name!r}; expected "
                     "Hardware, SolverPhaseModel or RunModel")


def layers_in_order(cfg, tree) -> List[Any]:
    """Per-layer entries of a reference ``{"scan": .., "rem": ..}`` tree
    in layer order.

    ``scan`` holds one subtree per pattern position whose leaves carry a
    leading group axis (the reference's ``vmap`` / ``lax.scan`` stacking):
    layer ``g * len(pattern) + i`` is leaf ``[g]`` of position ``i``.  The
    ``rem`` layers follow them.  Works for parameters and decode states.
    """
    pat = cfg.block_pattern
    n_groups = cfg.num_layers // len(pat)

    def take(t, g):
        if isinstance(t, dict):
            return {k: take(v, g) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):  # NamedTuple
            return type(t)(*(take(v, g) for v in t))
        return t[g]

    layers = [take(tree["scan"][i], g)
              for g in range(n_groups) for i in range(len(pat))]
    return layers + list(tree["rem"])


def _tensor(a, device) -> torch.Tensor:
    """A tensor copy of a numpy array; a bfloat16 array (numpy's extension
    dtype, as ``np.asarray`` of a JAX bf16 array gives it) keeps its bits."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def lm_params_from_numpy(cfg, tree, device="cuda") -> LM:
    """The port's model over copies of a reference ``init_params`` tree
    whose leaves are numpy arrays (dtypes kept): attention, MoE (``moe``),
    RG-LRU (``rec``) and RWKV (``tm``) layers, and the ``cb{i}``
    embeddings and heads of codebook configs."""

    def t(a):
        return _tensor(a, device)

    def lin(p):
        return Linear(t(p["w"]), t(p["b"]) if "b" in p else None)

    def norm(p):
        return RMSNorm(t(p["scale"]))

    def mixer(kind, p):
        if kind == RECURRENT:
            r = p["rec"]
            return {"rec": RGLRU(lin(r["in_x"]), lin(r["in_gate"]),
                                 t(r["conv_w"]), lin(r["gate_a"]),
                                 lin(r["gate_i"]), t(r["lambda"]),
                                 lin(r["out"]))}
        if kind == RWKV:
            m = p["tm"]
            return {"tm": RWKVParams(
                **{k: t(m[k]) for k in ("mu", "w0", "u", "ln_x", "cm_mu")},
                **{k: lin(m[k]) for k in ("wr", "wk", "wv", "wg", "wo",
                                          "decay_a", "decay_b", "cm_k",
                                          "cm_v", "cm_r")})}
        a = p["attn"]
        return {"attn": Attention(lin(a["wq"]), lin(a["wk"]), lin(a["wv"]),
                                  lin(a["wo"]),
                                  norm(a["qnorm"]) if "qnorm" in a else None,
                                  norm(a["knorm"]) if "knorm" in a else None)}

    def block(kind, p):
        kw = mixer(kind, p)
        if "ffn" in p:
            f = p["ffn"]
            kw["ffn"] = MLP(lin(f["up"]), lin(f["down"]),
                            lin(f["gate"]) if "gate" in f else None)
        if "moe" in p:
            m = p["moe"]
            kw["moe"] = MoE(lin(m["router"]), t(m["up"]), t(m["down"]),
                            t(m["gate"]) if "gate" in m else None)
        return Block(kind, norm(p["norm1"]), norm(p["norm2"]), **kw)

    blocks = [block(kind, p) for kind, p in
              zip(cfg.layer_kinds(), layers_in_order(cfg, tree["blocks"]))]
    ncb = cfg.num_codebooks
    if ncb > 1:
        embed = [t(tree["embed"][f"cb{i}"]) for i in range(ncb)]
        head = ([lin(tree["head"][f"cb{i}"]) for i in range(ncb)]
                if "head" in tree else None)
    else:
        embed = t(tree["embed"]["tokens"])
        head = lin(tree["head"]) if "head" in tree else None
    return LM(cfg, embed, blocks, norm(tree["final_norm"]), head)


def train_state_from_numpy(cfg, state, device="cuda") -> dict:
    """The port's train state (``launch/train.py::build_state``'s layout)
    over copies of a reference train state whose leaves are numpy arrays:
    ``params`` (the LM, switched to ``requires_grad``), AdamW's ``m`` and
    ``v`` by parameter name (dtypes kept, bf16 included), ``step`` (int32)
    and ``prev_gnorm`` (float32)."""
    params = lm_params_from_numpy(cfg, state["params"], device)
    params.requires_grad_(True)

    def by_name(tree):
        return {k: p.detach() for k, p in
                lm_params_from_numpy(cfg, tree, device).named_parameters()}

    return {"params": params,
            "opt": {"m": by_name(state["opt"]["m"]),
                    "v": by_name(state["opt"]["v"])},
            "step": torch.as_tensor(np.asarray(state["step"]),
                                    dtype=torch.int32, device=device),
            "prev_gnorm": torch.as_tensor(np.asarray(state["prev_gnorm"]),
                                          dtype=torch.float32,
                                          device=device)}


def sharded_params_from_numpy(cfg, tree, mesh, device="cuda") -> LM:
    """:func:`lm_params_from_numpy`'s model with every parameter stored as
    this rank's block on ``mesh`` (split as ``cfg.sharding`` says)."""
    from repro_torch.distributed import sharding
    return sharding.shard_params(lm_params_from_numpy(cfg, tree, device),
                                 cfg, mesh)


def sharded_train_state_from_numpy(cfg, state, mesh, device="cuda") -> dict:
    """:func:`train_state_from_numpy`'s state with the parameters and
    AdamW's moments stored as this rank's blocks on ``mesh``."""
    from repro_torch.distributed import sharding
    return sharding.shard_state(train_state_from_numpy(cfg, state, device),
                                cfg, mesh)


def decode_state_from_numpy(cfg, state, device="cuda") -> dict:
    """The port's decode state (``{"layers": [...], "pos": int}``) over
    copies of a reference decode state (``init_decode_state`` or
    ``prefill``'s, ``{"scan", "rem", "pos"}``) whose leaves are numpy
    arrays: an ``AttnState``, ``RGLRUState`` or ``RWKVState`` a layer."""
    from repro_torch.models.attention import AttnState
    from repro_torch.models.recurrent import RGLRUState, RWKVState
    kinds = {ATTN: AttnState, ATTN_LOCAL: AttnState, RECURRENT: RGLRUState,
             RWKV: RWKVState}
    layers = [kinds[kind](*(_tensor(a, device) for a in st))
              for kind, st in zip(cfg.layer_kinds(),
                                  layers_in_order(cfg, state))]
    return {"layers": layers, "pos": int(np.asarray(state["pos"]))}


def sharded_decode_state_from_numpy(cfg, state, mesh, device="cuda") -> dict:
    """:func:`decode_state_from_numpy`'s state as this rank's blocks on
    ``mesh`` (STATE_RULES: rows of the "2d" batch split, the model
    dimension over ``model``; the mesh needs coordinates, not groups)."""
    from repro_torch.distributed import comm, sharding
    whole = decode_state_from_numpy(cfg, state, device)
    B = whole["layers"][0][0].shape[0]
    axes = sharding.fit_batch_axes(mesh, B)
    layers = [sharding.model_blocks(type(st)(*(
        comm.own_block(t, 0, mesh, axes) for t in st)), mesh)
        for st in whole["layers"]]
    return {"layers": layers, "pos": whole["pos"]}
