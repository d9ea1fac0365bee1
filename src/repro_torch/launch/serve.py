"""Batched serving: prefill + greedy decode with per-layer state.

The port of the JAX package's ``launch/serve.py``, for every family: the
per-layer state is a KV cache (attention) or a recurrent state (RG-LRU,
RWKV); frontend configs get a zero (B, F, d) bf16 stub in front of the
prompt, codebook configs a (B, S, ncb) prompt and one greedy token per
codebook a step.  On the card:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --prompt-len 2048 --decode-steps 32 --batch 4 \
        --overrides attn_kernel=True

(``--smoke`` for the reduced config, ``--device cpu`` to run the plain
versions on the host.)
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, parse_overrides
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.kernels import ops
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import init_params
from repro_torch.models.attention import AttnState
from repro_torch.serve.metrics import LatencyStats


def prefill_to_decode_state(cfg: ModelConfig, prefill_state, cache_len: int):
    """Convert prefill output states to a decode cache of ``cache_len``.

    Attention caches (layout (B, S, KV, D)) are zero-padded along S;
    recurrent states pass through unchanged.  Local-attn caches become
    full-length caches with the window enforced by masking (the decode
    path supports both ring and masked-window layouts)."""
    def pad(x):
        extra = cache_len - x.shape[-3]
        return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, extra)) \
            if extra > 0 else x

    layers = [AttnState(k=pad(st.k), v=pad(st.v))
              if isinstance(st, AttnState) else st
              for st in prefill_state["layers"]]
    return {"layers": layers, "pos": prefill_state["pos"]}


def prompt_tokens(cfg: ModelConfig, batch: int, prompt_len: int,
                  device="cuda", seed: int = 1) -> torch.Tensor:
    """``serve``'s random prompt: (batch, prompt_len) token ids, or
    (batch, prompt_len, ncb) with codebooks."""
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (batch, prompt_len) + ((cfg.num_codebooks,)
                                   if cfg.num_codebooks > 1 else ())
    return torch.randint(0, cfg.vocab_size, shape, generator=g,
                         device=device)


def serve_batch(cfg: ModelConfig, batch: int, prompt_len: int,
                device="cuda") -> dict:
    """The prefill batch ``serve`` runs: the prompt and, for a frontend
    config, its precomputed embeddings as the reference's ``serve`` makes
    them: zeros (batch, F, d_model) in bf16."""
    b = {"tokens": prompt_tokens(cfg, batch, prompt_len, device)}
    if cfg.frontend is not None:
        b["frontend"] = torch.zeros(
            (batch, cfg.frontend.num_positions, cfg.d_model),
            dtype=torch.bfloat16, device=device)
    return b


def greedy(logits) -> torch.Tensor:
    """The last position's argmax: (B,), or (B, ncb) for a tuple of
    codebook logits."""
    if isinstance(logits, tuple):
        return torch.stack([torch.argmax(lg[:, -1, :], dim=-1)
                            for lg in logits], dim=-1)
    return torch.argmax(logits[:, -1, :], dim=-1)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _delta(before, after):
    return {k: after[k] - before[k] for k in after}


@torch.inference_mode()
def serve(cfg: ModelConfig, *, batch: int = 4, prompt_len: int = 16,
          decode_steps: int = 32, progress=print, device="cuda",
          params=None) -> dict:
    """Prefill a random prompt, then decode greedily.

    ``params`` defaults to ``init_params`` from seed 0 on ``device``.
    Returns the tokens (batch, decode_steps[, ncb]), the prefill's
    last-position logits (a tuple with codebooks), the prefill and decode
    seconds, the per-step latency summary
    (decode_steps - 1 steps, each timed to a device synchronize) and the
    kernel launches of each stage.
    """
    if params is None:
        params = init_params(cfg, torch.Generator(device=device)
                             .manual_seed(0), device)
    F = cfg.frontend.num_positions if cfg.frontend is not None else 0
    cache_len = prompt_len + decode_steps + F
    b = serve_batch(cfg, batch, prompt_len, device)

    prefill_fn = make_prefill_step(cfg)
    decode_fn = make_decode_step(cfg)

    _sync(device)
    counts0 = ops.launch_counts()
    t0 = time.perf_counter()
    logits, pstate = prefill_fn(params, b)
    state = prefill_to_decode_state(cfg, pstate, cache_len)
    tok = greedy(logits)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    counts1 = ops.launch_counts()

    generated = [tok]
    step_s = []
    t0 = time.perf_counter()
    for _ in range(decode_steps - 1):
        ts = time.perf_counter()
        state, lg = decode_fn(params, state, tok)
        tok = greedy(lg)
        _sync(device)
        step_s.append(time.perf_counter() - ts)
        generated.append(tok)
    t_decode = time.perf_counter() - t0
    toks = torch.stack(generated, dim=1)
    lat = LatencyStats.from_samples(step_s or [t_decode])
    progress(f"[serve] prefill {prompt_len} toks x{batch} in "
             f"{t_prefill * 1e3:.1f} ms; decode {decode_steps} steps in "
             f"{t_decode * 1e3:.1f} ms (p50 {lat.p50 * 1e3:.2f} / "
             f"p99 {lat.p99 * 1e3:.2f} ms/tok)")
    return {"tokens": toks, "logits": logits, "t_prefill": t_prefill,
            "t_decode": t_decode, "step_latency": lat.as_dict(),
            "launches": {"prefill": _delta(counts0, counts1),
                         "decode": _delta(counts1, ops.launch_counts())}}


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--decode-steps", type=int, default=32)
    ap.add_argument("--overrides", default="",
                    help="config fields, e.g. attn_kernel=True (the flash "
                         "kernel in prefill)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, **parse_overrides(args.overrides))
    return serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                 decode_steps=args.decode_steps, device=args.device)


if __name__ == "__main__":
    main()
