"""End-to-end LM training on the PyTorch port (the twin of train_lm.py).

Default: a ~27M-parameter qwen3-family model for 300 steps on the card
(the full stack: data pipeline, AdamW, pipelined clipping,
checkpoint/restart).  ``--hundred-m`` switches to a ~100M config (same code
path); ``--device cpu`` runs it on the host.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] [--hundred-m]

Checkpoints go to ``build/train_lm_torch/`` of the checkout unless
``--checkpoint-dir`` names another directory.
"""
import argparse
from pathlib import Path

from repro_torch.configs.base import ATTN, ModelConfig, TrainConfig
from repro_torch.launch.train import train


def small_config(hundred_m: bool) -> ModelConfig:
    if hundred_m:
        return ModelConfig(
            name="qwen3-100m", family="dense", num_layers=12, d_model=768,
            num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2048,
            vocab_size=32_768, block_pattern=(ATTN,), qk_norm=True,
            gated_mlp=True, tie_embeddings=True)
    return ModelConfig(
        name="qwen3-27m", family="dense", num_layers=8, d_model=384,
        num_heads=6, num_kv_heads=2, head_dim=64, d_ff=1024,
        vocab_size=32_768, block_pattern=(ATTN,), qk_norm=True,
        gated_mlp=True, tie_embeddings=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--hundred-m", action="store_true")
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--checkpoint-dir", default=str(
        Path(__file__).resolve().parents[1] / "build" / "train_lm_torch"))
    ap.add_argument("--pipelined-clipping", action="store_true", default=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = small_config(args.hundred_m)
    n_params = cfg.param_counts()["total"]
    print(f"[train_lm] {cfg.name}: {n_params/1e6:.1f}M params, "
          f"{args.steps} steps, seq {args.seq_len}, batch {args.batch}, "
          f"on {args.device}")
    tcfg = TrainConfig(model=cfg.name, steps=args.steps, learning_rate=6e-4,
                       warmup_steps=30,
                       pipelined_clipping=args.pipelined_clipping,
                       checkpoint_dir=args.checkpoint_dir,
                       checkpoint_every=100)
    out = train(cfg, tcfg, seq_len=args.seq_len, batch=args.batch,
                log_every=25, device=args.device)
    if out["losses"]:
        print(f"[train_lm] {out['steps']} steps in {out['seconds']:.1f}s; "
              f"loss {out['losses'][0]:.3f} -> {out['final_loss']:.3f}")
    return out


if __name__ == "__main__":
    main()
