#!/usr/bin/env python3
"""Where LM serving of qwen3-1.7b spends its time, prefill and decode.

    python3 torch_serve_breakdown.py

Run from the root of a checkout on one NVIDIA GPU (exits with 2 without
one).  Builds chip_smoke.py's ``[serve]`` model (qwen3-1.7b at full
width, random weights from seed 0, ``attn_kernel=True``), prefills its
prompt (batch 4, 2048 tokens) and decodes 8 greedy steps, first without
and then with ``torch.profiler`` attached, and reports for each stage

* the host-clock time of the synchronised stage (prefill; decode per
  step), unprofiled and profiled;
* from the profiler's device events, the device time by group: the flash
  kernel, cuBLAS products, dtype casts and copies (the fp32 weights cast
  to bf16 at each use, the cache upcasts), softmax and reductions, other
  elementwise ops; and the device's idle share of the profiled wall time.

Prints one JSON object as its last line.  Where the profiler's averages
show no device time, the groups read "not measured".
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time

import chip_smoke as smoke

DECODE_STEPS = 8
GROUPS = (
    ("flash kernel", ("flash_fwd_kernel", "flash_tc_kernel")),
    ("cuBLAS products", ("gemm", "gemv", "cublas", "cutlass", "xmma",
                         "nvjet", "sm90_")),
    ("casts and copies", ("copy", "cat", "index")),
    ("softmax and reductions", ("softmax", "reduce")),
)


def _group(name: str) -> str:
    low = name.lower()
    for label, keys in GROUPS:
        if any(k in low for k in keys):
            return label
    return "other elementwise ops"


def _device_groups(prof, torch):
    groups, kernels = {}, {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us and ev.device_type == torch.autograd.DeviceType.CUDA:
            g = _group(ev.key)
            groups[g] = groups.get(g, 0.0) + us
            kernels[ev.key[:90]] = (us, ev.count)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    return groups, top


def main() -> int:
    why = smoke.prepare()
    if why:
        print(f"torch_serve_breakdown: {why}", file=sys.stderr)
        return 2
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import prefill_to_decode_state, prompt_tokens
    from repro_torch.models import decode_step, init_params, prefill

    _, card = smoke.card()
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), attn_kernel=True)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    prompt = prompt_tokens(cfg, smoke.SERVE_BATCH, smoke.SERVE_PROMPT, dev)
    cache_len = smoke.SERVE_PROMPT + DECODE_STEPS + 1

    @torch.inference_mode()
    def run_prefill():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, st = prefill(params, cfg, {"tokens": prompt})
        st = prefill_to_decode_state(cfg, st, cache_len)
        tok = torch.argmax(logits[:, -1], -1)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, st, tok

    @torch.inference_mode()
    def run_decode(st, tok):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DECODE_STEPS):
            st, lg = decode_step(params, cfg, st, tok)
            tok = torch.argmax(lg[:, -1], -1)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / DECODE_STEPS

    _, st, tok = run_prefill()  # warm up: build, cuBLAS plans
    run_decode(st, tok)
    t_pre, st, tok = run_prefill()
    t_dec = run_decode(st, tok)
    result = {"card": card, "arch": cfg.name, "batch": smoke.SERVE_BATCH,
              "prompt_len": smoke.SERVE_PROMPT,
              "decode_steps": DECODE_STEPS}
    for stage in ("prefill", "decode"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if stage == "prefill":
                wall_prof, _, _ = run_prefill()
                wall = t_pre
            else:  # the caches' slots past the prompt are written again
                wall_prof = run_decode(st, tok)
                wall = t_dec
        groups, top = _device_groups(prof, torch)
        per = 1 if stage == "prefill" else DECODE_STEPS
        busy_ms = sum(groups.values()) / per / 1e3
        result[stage] = {
            "wall_ms": wall * 1e3, "wall_ms_profiled": wall_prof * 1e3,
            "device_ms": ({g: us / per / 1e3 for g, us in
                           sorted(groups.items())} if busy_ms
                          else "not measured"),
            "device_busy_ms": busy_ms if busy_ms else "not measured",
            "device_idle_share": (1.0 - busy_ms / (wall_prof * 1e3))
            if busy_ms else "not measured",
            "top_kernels_us_and_launches": top,
        }
        print(f"[{stage}] wall {wall * 1e3:.3f} ms (profiled "
              f"{wall_prof * 1e3:.3f}), device busy {busy_ms:.3f} ms",
              flush=True)
        for g, us in sorted(groups.items()):
            print(f"  {g:28s} {us / per / 1e3:10.4f} ms", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
