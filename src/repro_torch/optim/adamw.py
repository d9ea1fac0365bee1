"""Functional AdamW with optional reduced-precision states.

The port of the JAX package's ``optim/adamw.py``: the same arithmetic,
step for step (fp32 moments, bias correction from the 1-based step, the
decoupled weight decay), on a dict (or list) of parameter tensors.  States
can be kept in bf16 (``state_dtype="bfloat16"``): m and v are rounded on
store, as the reference's ``astype`` does.  Master params stay in their
own dtype.

``update`` writes the new parameters and moments in place, one leaf at a
time, and returns them: a full-width model holds no second copy of its
parameters and moments during the step.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple, Union

import torch

Tree = Union[Mapping[str, torch.Tensor], Sequence[torch.Tensor]]


def _items(tree: Tree):
    return tree.items() if isinstance(tree, Mapping) else enumerate(tree)


def _zeros_like(tree: Tree, dtype):
    if isinstance(tree, Mapping):
        return {k: torch.zeros(p.shape, dtype=dtype, device=p.device)
                for k, p in tree.items()}
    return [torch.zeros(p.shape, dtype=dtype, device=p.device) for p in tree]


def init(params: Tree, state_dtype: str = "float32") -> Dict[str, Tree]:
    dt = getattr(torch, state_dtype)
    return {"m": _zeros_like(params, dt), "v": _zeros_like(params, dt)}


@torch.no_grad()
def update(grads: Tree, opt_state: Dict[str, Tree], params: Tree, *, lr,
           b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, step=None
           ) -> Tuple[Tree, Dict[str, Tree]]:
    """Returns (params, opt_state), both updated in place.  Bias correction
    uses ``step`` (1-based); ``lr`` a float or 0-d tensor."""
    m_, v_ = opt_state["m"], opt_state["v"]
    items = list(_items(params))
    if not items:
        return params, opt_state
    dev = items[0][1].device

    def f32(x):
        return torch.as_tensor(x).to(device=dev, dtype=torch.float32)

    step, lr = f32(step), f32(lr)
    c1 = 1.0 - torch.pow(f32(b1), step)
    c2 = 1.0 - torch.pow(f32(b2), step)
    for k, p in items:
        g, m, v = grads[k], m_[k], v_[k]
        gf = g.float()
        m_new = b1 * m.float() + (1 - b1) * gf
        v_new = b2 * v.float() + (1 - b2) * torch.square(gf)
        delta = (m_new / c1) / (torch.sqrt(v_new / c2) + eps) \
            + weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        m.copy_(m_new.to(m.dtype))
        v.copy_(v_new.to(v.dtype))
    return params, opt_state
