"""Krylov-Newton: matrix-free damped Newton steps solved with PIPECG.

The port of the JAX package's ``optim/krylov_newton.py``.  The paper's
SpMV <-> reduction overlap maps onto second-order optimization: the
Hessian-vector product plays SpMV (local compute, big), the CG dot
products are the global reductions.  Using ``pipecg`` for the inner solve
gives the inner loop ONE overlapped reduction per iteration instead of
CG's two synchronization points.

Curvature operator: the exact HVP of the scalar loss, forward-over-reverse
(``torch.func.jvp`` of ``torch.func.grad``, the reference's ``jax.jvp`` of
``jax.grad``), plus Tikhonov damping -> SPD, which CG/PIPECG require.
Parameters are a dict of tensors; :func:`module_loss` makes a module's
loss a function of such a dict (``torch.func.functional_call``).  The
flat vectors are float32, in the dict's order, as the reference's
``_tree_to_vec`` makes them; the solvers run the inline path
(``engine=None``, the reference's default).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch import nn

from repro_torch.core.krylov.base import local_dot
from repro_torch.core.krylov.cg import cg, pipecg

Params = Dict[str, torch.Tensor]


def _tree_to_vec(tree: Params) -> torch.Tensor:
    return torch.cat([t.reshape(-1).float() for t in tree.values()])


def _vec_to_tree(vec: torch.Tensor, template: Params) -> Params:
    out, ofs = {}, 0
    for k, t in template.items():
        n = t.numel()
        out[k] = vec[ofs:ofs + n].reshape(t.shape).to(t.dtype)
        ofs += n
    return out


class _Apply(nn.Module):
    def __init__(self, module: nn.Module, fn: Callable):
        super().__init__()
        self.m = module
        self.fn = fn

    def forward(self):
        return self.fn(self.m)


def module_loss(module: nn.Module, fn: Callable[[nn.Module], torch.Tensor]
                ) -> Callable[[Params], torch.Tensor]:
    """``fn(module)`` (a scalar) as a function of a {name: tensor} dict
    over ``module.named_parameters()``'s names."""
    app = _Apply(module, fn)

    def loss(params: Params) -> torch.Tensor:
        return torch.func.functional_call(
            app, {f"m.{k}": v for k, v in params.items()}, ())

    return loss


def hvp_operator(loss_fn: Callable[[Params], torch.Tensor], params: Params,
                 damping: float = 1e-3) -> Callable[[torch.Tensor],
                                                    torch.Tensor]:
    """v -> (H + damping I) v as a flat-vector operator (matrix-free)."""
    grad_fn = torch.func.grad(loss_fn)

    def hvp(v_flat: torch.Tensor) -> torch.Tensor:
        v_tree = _vec_to_tree(v_flat, params)
        _, hv = torch.func.jvp(grad_fn, (params,), (v_tree,))
        return _tree_to_vec(hv) + damping * v_flat

    return hvp


def krylov_newton_step(loss_fn: Callable[[Params], torch.Tensor],
                       params: Params, *, cg_iters: int = 10,
                       damping: float = 1e-2, lr: float = 1.0,
                       pipelined: bool = True, dot=local_dot
                       ) -> Tuple[Params, Dict[str, torch.Tensor]]:
    """One damped-Newton step: solve (H + lam I) d = -g with (PIPE)CG.

    ``pipelined=True`` uses PIPECG (the paper's solver); False uses
    classical CG, the ablation pair.  Returns the new parameters (a new
    dict) and ``loss``, ``gnorm``, ``cg_res``, ``cg_iters``.
    """
    params = {k: p.detach() for k, p in params.items()}
    g_tree, loss = torch.func.grad_and_value(loss_fn)(params)
    g = _tree_to_vec(g_tree)
    A = hvp_operator(loss_fn, params, damping)
    solver = pipecg if pipelined else cg
    res = solver(A, -g, maxiter=cg_iters, dot=dot)
    d = _vec_to_tree(res.x, params)
    new_params = {k: (p.float() + lr * d[k].float()).to(p.dtype)
                  for k, p in params.items()}
    metrics = {"loss": loss.detach(),
               "gnorm": torch.sqrt(torch.clamp(dot(g, g), min=0.0)),
               "cg_res": res.res_norm, "cg_iters": res.iters}
    return new_params, metrics
