"""Generate tokens from a checkpoint of the PyTorch port's Llama trainer.

The inference half of the flagship path on the PyTorch port, the
counterpart of ``examples/generate_llama.py``: restores the newest params
written by ``python -m k8s_distributed_deeplearning_torch.train`` (read
through a memory map, the optimizer moments never touched) and runs the
KV-cache decode loop (``models/generate.py``). Runs on the GPU unless
``--device cpu`` is given.

  python examples/generate_llama_torch.py --preset tiny \
      --checkpoint-dir ./checkpoints --max-new-tokens 64 --temperature 0.7
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from k8s_distributed_deeplearning_torch.models import generate as gen_lib
from k8s_distributed_deeplearning_torch.models import llama
from k8s_distributed_deeplearning_torch.train.checkpoint import Checkpointer
from k8s_distributed_deeplearning_torch.train.cli import PRESETS, build_config
from k8s_distributed_deeplearning_torch.utils.device import resolve_device


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preset", choices=sorted(PRESETS), default="tiny")
    ap.add_argument("--checkpoint-dir", default="./checkpoints")
    ap.add_argument("--prompt", type=str, default="",
                    help="prompt bytes (byte-level vocab); empty -> BOS-less "
                         "single zero token")
    ap.add_argument("--max-new-tokens", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=None,
                    help="sample only from the k most likely tokens")
    ap.add_argument("--top-p", type=float, default=None,
                    help="nucleus sampling: smallest set reaching this "
                         "probability mass")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--remat", action="store_true",
                    help="accepted for the JAX script's command lines; "
                         "decode keeps no activations, so it has no "
                         "effect here")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    # Decode reads the KV cache through the einsum attention; the
    # training-time attention choice and remat (--remat parses, as in the
    # JAX script) do not apply here.
    args.attention = "xla"
    args.remat = False
    device = resolve_device(args.device)

    cfg = build_config(args)
    model = llama.LlamaLM(cfg, device=device, seed=args.seed)
    restored = Checkpointer(args.checkpoint_dir).restore_params(
        device=device)
    if restored is None:
        raise FileNotFoundError(
            f"no checkpoint under {args.checkpoint_dir!r} — run "
            "python -m k8s_distributed_deeplearning_torch.train first")
    params, step = restored
    want = set(dict(model.named_parameters()))
    if set(params) != want:
        raise ValueError(
            f"checkpoint params do not match --preset {args.preset}: "
            f"missing {sorted(want - set(params))[:4]}, unexpected "
            f"{sorted(set(params) - want)[:4]}")
    model.load_state_dict(params, strict=False)

    if args.prompt:
        prompt = torch.tensor([[b % cfg.vocab_size
                                for b in args.prompt.encode()]],
                              dtype=torch.int32)
    else:
        prompt = torch.zeros((1, 1), dtype=torch.int32)
    generator = torch.Generator(device=device)
    generator.manual_seed(args.seed)
    out = gen_lib.generate(model, prompt,
                           max_new_tokens=args.max_new_tokens,
                           temperature=args.temperature,
                           top_k=args.top_k, top_p=args.top_p,
                           generator=generator)
    toks = out[0].cpu().tolist()
    text = bytes(t % 256 for t in toks).decode("utf-8", errors="replace")
    print({"checkpoint_step": step, "tokens": toks, "text": text})
    return {"step": step, "tokens": toks}


if __name__ == "__main__":
    main(sys.argv[1:])
