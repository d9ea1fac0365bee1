"""Batched serving on the PyTorch port (the twin of serve_lm.py): prefill
+ greedy decode across architectures, including the hybrid (RG-LRU),
attention-free (RWKV-6) and codebook (MusicGen) decode paths, on the
reduced configs.

    PYTHONPATH=src python examples/serve_lm_torch.py [--arch qwen3-1.7b]

``--device cpu`` runs it on the host.
"""
import argparse

from repro_torch.configs.registry import smoke_config
from repro_torch.launch.serve import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="one registry arch (default: a representative trio)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--decode-steps", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else [
        "qwen3-1.7b", "recurrentgemma-2b", "musicgen-medium"]
    outs = {}
    for arch in archs:
        cfg = smoke_config(arch)
        print(f"[serve_lm] {arch} (reduced config) on {args.device}")
        out = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                    decode_steps=args.decode_steps, device=args.device)
        lat = out["step_latency"]
        print(f"[serve_lm] {arch} decode-step latency: "
              f"p50 {lat['p50']*1e3:.2f} ms  p99 {lat['p99']*1e3:.2f} ms "
              f"(n={lat['n']})")
        outs[arch] = out
    return outs


if __name__ == "__main__":
    main()
