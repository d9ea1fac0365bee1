#!/usr/bin/env python3
"""Where a training step of qwen3-1.7b spends its time.

    python3 torch_train_breakdown.py

Run from the root of a checkout on one NVIDIA GPU (exits with 2 without
one).  Builds chip_smoke.py's first ``[train]`` cell (qwen3-1.7b at full
width, fp32 masters, bf16 compute, remat "full", pipelined clipping, batch
4 x 2048 of ``SyntheticTokens`` seed 0), takes two warm-up steps, and
reports

* the host-clock time of one synchronised step, and of its phases run
  one after another with a synchronise between them: the loss and its
  gradients (``loss_fn`` + ``torch.autograd.grad``), clipping, and the
  schedule with AdamW, the functions ``launch/steps.py::make_train_step``
  calls;
* from ``torch.profiler``'s device events over one more step, the device
  time by group: cuBLAS products, casts and copies (the fp32 weights cast
  to bf16 at each use, index gathers and their backward), softmax and
  reductions, other elementwise ops; and the device's idle share of the
  profiled wall time.

Prints one JSON object as its last line.  Where the profiler's averages
show no device time, the groups read "not measured".
"""
from __future__ import annotations

import json
import sys
import time

import chip_smoke as smoke
from torch_serve_breakdown import _device_groups


def main() -> int:
    why = smoke.prepare()
    if why:
        print(f"torch_train_breakdown: {why}", file=sys.stderr)
        return 2
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import build_state
    from repro_torch.models import loss_fn
    from repro_torch.optim import adamw, clipping, schedules

    _, card = smoke.card()
    dev = torch.device("cuda")
    arch, cut, batch, seq, steps, pipelined = smoke.TRAIN_CELLS[0]
    cfg = get_config(arch)
    tcfg = TrainConfig(model=cfg.name, steps=steps, warmup_steps=2,
                       pipelined_clipping=pipelined)
    state = build_state(cfg, tcfg, device=dev)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, seq, batch), device=dev)
    step_fn = make_train_step(cfg, tcfg)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    for i in range(2):
        state, _ = step_fn(state, data.batch(i))
    b = data.batch(2)
    wall, (state, _) = timed(lambda: step_fn(state, b))

    named = dict(state["params"].named_parameters())
    t_grad, grads = timed(lambda: dict(zip(named, torch.autograd.grad(
        loss_fn(state["params"], cfg, b, remat=tcfg.remat)[0],
        list(named.values()), materialize_grads=True))))
    t_clip, (grads, _) = timed(lambda: clipping.clip_by_delayed_norm(
        grads, state["prev_gnorm"], tcfg.grad_clip))

    def opt():
        lr = schedules.linear_warmup_cosine(
            state["step"] + 1, base_lr=tcfg.learning_rate,
            warmup_steps=tcfg.warmup_steps, total_steps=tcfg.steps)
        return adamw.update(grads, state["opt"], named, lr=lr,
                            weight_decay=tcfg.weight_decay,
                            step=state["step"] + 1)
    t_opt, _ = timed(opt)
    del grads

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof, (state, _) = timed(lambda: step_fn(state, data.batch(3)))
    groups, top = _device_groups(prof, torch)
    busy_ms = sum(groups.values()) / 1e3
    result = {
        "card": card, "arch": cfg.name, "batch": batch, "seq": seq,
        "remat": tcfg.remat, "step_ms": wall * 1e3,
        "phases_ms": {"loss_and_grads": t_grad * 1e3, "clipping": t_clip * 1e3,
                      "schedule_and_adamw": t_opt * 1e3},
        "wall_ms_profiled": wall_prof * 1e3,
        "device_ms": ({g: us / 1e3 for g, us in sorted(groups.items())}
                      if busy_ms else "not measured"),
        "device_busy_ms": busy_ms if busy_ms else "not measured",
        "device_idle_share": (1.0 - busy_ms / (wall_prof * 1e3))
        if busy_ms else "not measured",
        "top_kernels_us_and_launches": top,
    }
    print(f"[train] step {wall * 1e3:.3f} ms: loss and grads "
          f"{t_grad * 1e3:.3f}, clipping {t_clip * 1e3:.3f}, schedule and "
          f"AdamW {t_opt * 1e3:.3f} (profiled step {wall_prof * 1e3:.3f}, "
          f"device busy {busy_ms:.3f} ms)", flush=True)
    for g, us in sorted(groups.items()):
        print(f"  {g:28s} {us / 1e3:10.4f} ms", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
