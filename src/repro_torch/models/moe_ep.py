"""Expert-parallel MoE dispatch on the ranks of a mesh.

The port of the JAX package's ``models/moe_ep.py`` (its ``shard_map``
body ``_ep_local``).  Activations are replicated over ``model`` and the
experts are split over it: each rank holds and runs only its ``E / model``
experts (their blocks are gathered over the other axes, never over
``model``), gathers ITS experts' tokens from its own rows with no
dispatch communication, and one all-reduce over ``model`` merges the
expert rows.

Under "fsdp" the batch is split over ``model`` too: :func:`moe_ffn_ep`
gathers a data shard's rows over ``model`` at entry and keeps this
rank's at exit.

As in the reference, capacity is enforced PER DATA SHARD (``C_local =
capacity(m, T_local)``, the standard EP approximation) and ``moe_aux`` /
``moe_z`` are averaged over the batch axes: with a capacity that drops
nothing the output equals ``moe_ffn``'s, the loss terms are the mean of
the per-shard terms.  The combine gathers each token's k rows in k order
(``models/moe.py``: no float atomics), then the sum over ``model``.

The backward of a rank's share: the tokens and gate weights that enter
the local dispatch sum their gradient over ``model`` (each rank's
experts used them), the merged rows pass theirs on unchanged (every rank
of a ``model`` line uses the same merged output).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import comm
from repro_torch.distributed.sharding import placed, stored_tensor
from repro_torch.models.moe import MoE, capacity

MODEL = ("model",)


def local_experts(p: MoE, name: str, mesh, E_l: int):
    """This rank's ``E_l`` experts of ``p.<name>`` (E, ., .), whole along
    their other dimensions: gathered over the other axes where the
    experts are split over ``model`` alone (the "2d" rules), else cut from
    the whole tensor (the "fsdp" rules split another dimension)."""
    pl = placed(p, name)
    if pl is not None and pl.spec[0] in (MODEL[0], MODEL):
        return pl.gather(stored_tensor(p, name), keep=MODEL)
    lo = mesh.index(MODEL) * E_l
    return getattr(p, name)[lo:lo + E_l]


def moe_ffn_ep(p: MoE, cfg, x: torch.Tensor, dtype, mesh,
               batch_axes=("data",)):
    """x (B_local, S, d), this rank's rows -> (B_local, S, d) and the aux
    dict: ``moe_aux`` and ``moe_z`` (means over the data shards) and
    ``moe_dropped``, the assignments of this data shard dropped at
    capacity.

    With the batch split over ``model`` too ("fsdp": ``model`` among
    ``batch_axes``), each rank routes its own rows, the routes and rows
    of its data shard are gathered over ``model`` at entry, and each rank
    keeps its own rows of the merged output at exit: the reference's
    ``shard_map`` reshards them so.  The data shard's ``moe_aux`` /
    ``moe_z`` then take its routing statistics as the mean of the model
    ranks' (equal row counts)."""
    over_model = "model" in batch_axes and mesh.count(MODEL) > 1
    data_axes = tuple(a for a in batch_axes if a != "model")
    m = cfg.moe
    B_l, S, d = x.shape
    E, K = m.num_experts, m.top_k
    n_model = mesh.count(MODEL)
    if E % n_model:
        raise ValueError(f"{E} experts do not split over model={n_model}")
    E_l = E // n_model
    lo = mesh.index(MODEL) * E_l
    dev = x.device
    xf = x.reshape(B_l * S, d)

    # router (fp32) on this rank's rows: under "2d" a model line's ranks
    # hold the same rows and compute the same routes
    logits = xf.float() @ p.router.w.float()
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx = torch.topk(probs, K, dim=-1)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)

    me = probs.mean(dim=0)
    ce = F.one_hot(gate_idx, E).float().sum(1).mean(dim=0)
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    if over_model:
        me, ce, z = (comm.sum_over(t, mesh, MODEL) / n_model
                     for t in (me, ce, z))
    aux_loss = comm.batch_mean(E * torch.sum(me * ce) / K, 1.0, mesh,
                               data_axes)
    z_loss = comm.batch_mean(z, 1.0, mesh, data_axes)

    flat_e = gate_idx.reshape(-1)
    flat_w = gate_w.reshape(-1).to(dtype)
    if over_model:
        # the data shard's routes and rows; the backward sums the model
        # ranks' parts and keeps this rank's rows
        flat_e = comm.all_gather(flat_e, 0, mesh.group(MODEL), n_model)
        flat_w, xm = (comm.gather_blocks(t, mesh, ((0, MODEL),), MODEL)
                      for t in (flat_w, xf))
    else:
        flat_w = comm.copy_over(flat_w, mesh, MODEL)
        xm = comm.copy_over(xf, mesh, MODEL)
    T = xm.shape[0]

    # --- dispatch restricted to MY experts (zero communication) -----------
    local_e = flat_e - lo
    mine = (local_e >= 0) & (local_e < E_l)
    local_e = torch.where(mine, local_e, E_l)            # E_l = drop bucket
    C = capacity(m, T)
    sort_idx = torch.argsort(local_e, stable=True)
    sorted_e = local_e[sort_idx]
    seg_start = torch.searchsorted(sorted_e, torch.arange(E_l, device=dev),
                                   side="left")
    pos = torch.arange(T * K, device=dev) \
        - seg_start[torch.clamp(sorted_e, max=E_l - 1)]
    keep = (sorted_e < E_l) & (pos < C)
    slot = torch.where(keep, sorted_e * C + pos, E_l * C)
    table = torch.full((E_l * C + 1,), T * K, dtype=torch.long, device=dev)
    table[slot] = sort_idx
    table = table[:E_l * C].reshape(E_l, C)
    slot_of = torch.empty_like(slot)
    slot_of[sort_idx] = slot

    tok_of = table // K                                  # sentinel -> T
    w_of = torch.cat([flat_w, flat_w.new_zeros(1)])[table]
    xpad = torch.cat([xm.to(dtype), xm.new_zeros((1, d), dtype=dtype)])
    gx = xpad[tok_of]                                    # (E_l, C, d) LOCAL

    up = torch.bmm(gx, local_experts(p, "up", mesh, E_l).to(dtype))
    if cfg.gated_mlp:
        gate = local_experts(p, "gate", mesh, E_l)
        up = F.silu(torch.bmm(gx, gate.to(dtype))) * up
    else:
        up = F.gelu(up, approximate="tanh")
    out_e = torch.bmm(up, local_experts(p, "down", mesh, E_l).to(dtype))

    rows = torch.cat([(out_e * w_of[..., None]).reshape(E_l * C, d),
                      out_e.new_zeros((1, d))])
    slot_tk = slot_of.reshape(T, K)
    out = torch.zeros((T, d), dtype=dtype, device=dev)
    for k in range(K):
        out = out + rows[slot_tk[:, k]]
    # merge expert contributions across the model axis (the ONLY collective)
    out = comm.sum_over(out, mesh, MODEL)
    if over_model:
        out = comm.own_part(out, 0, mesh, MODEL)
    dropped = comm.sum_over(torch.count_nonzero((sorted_e < E_l) & ~keep),
                            mesh, MODEL)
    return out.reshape(B_l, S, d), {"moe_aux": aux_loss, "moe_z": z_loss,
                                    "moe_dropped": dropped}
