"""Batched serving: prefill a batch of prompts, then decode.

The port's counterpart of the reference's `launch/serve.py`: the serving
path (prefill -> caches -> decode loop) with greedy sampling, for the
language models the port runs (the dense phi4-mini, nemotron, gemma2 and
h2o-danube, and the recurrent hybrid recurrentgemma).  Weights and prompt
tokens come from a `torch.Generator` seeded with --seed, on the device.

--impl kernel (the default) runs the prefill's attention and RG-LRU scan
through the hand-written CUDA kernels on the card and through their plain
versions on the CPU; --impl einsum runs the einsum attention and the
associative scan, which is what the reference serve CLI runs (its steps
default to impl="xla").  --device defaults to
cuda and fails without a card; pass --device cpu to run on the host.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \
      --smoke --device cpu --batch 4 --prompt-len 64 --gen 32
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .. import configs
from ..device import resolve
from ..models import attention, transformer
from ..models.common import ModelConfig
from ..runtime import steps as rsteps


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor          # (B, gen) greedy tokens, on the device
    prefill_logits: torch.Tensor  # (B, 1, Vp) the prefill's last-token logits
    caches: list                  # one cache a layer, after the last step
    prefill_s: float              # host wall of the prefill, synchronised
    decode_s: float               # host wall of the gen - 1 decode steps


def build(cfg: ModelConfig, batch: int, prompt_len: int, seed: int,
          device: torch.device):
    """The model and the prompt tokens, both drawn from one generator
    seeded with `seed` on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    model = transformer.Transformer(cfg, generator=gen, device=device)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                         generator=gen, device=device)
    return model, toks


def generate(model: transformer.Transformer, toks: torch.Tensor, gen: int,
             *, impl: str) -> Generation:
    """Prefill `toks`, then decode greedily (argmax over the padded
    vocabulary; the first maximum wins) to `gen` tokens in all."""
    cfg, device = model.cfg, toks.device
    P = toks.shape[1]
    prefill = rsteps.make_prefill_step(cfg, impl=impl, max_len=P + gen)
    decode = rsteps.make_decode_step(cfg, impl=impl)

    _sync(device)
    t0 = time.perf_counter()
    logits, caches = prefill(model, {"tokens": toks})
    _sync(device)
    t_prefill = time.perf_counter() - t0
    prefill_logits = logits

    out_tokens = [torch.argmax(logits[:, -1], dim=-1)]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, caches = decode(model, caches, out_tokens[-1][:, None], P + i)
        out_tokens.append(torch.argmax(logits[:, -1], dim=-1))
    _sync(device)
    t_decode = time.perf_counter() - t0
    return Generation(torch.stack(out_tokens, dim=1), prefill_logits, caches,
                      t_prefill, t_decode)


def main(argv=None) -> np.ndarray:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--impl", default="kernel", choices=attention.IMPLS)
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch, smoke=args.smoke)
    device = resolve(args.device)
    B, P = args.batch, args.prompt_len
    model, toks = build(cfg, B, P, args.seed, device)
    g = generate(model, toks, args.gen, impl=args.impl)

    gen_tokens = g.tokens.cpu().numpy()
    print(f"arch={cfg.name} batch={B} prompt={P} gen={args.gen} "
          f"device={device} impl={args.impl}")
    print(f"prefill: {g.prefill_s*1e3:.1f} ms "
          f"({B*P/g.prefill_s:.0f} tok/s)")
    print(f"decode:  {g.decode_s*1e3:.1f} ms total, "
          f"{B*(args.gen-1)/max(g.decode_s,1e-9):.0f} tok/s")
    print("sample generations (token ids):")
    for b in range(min(B, 2)):
        print(f"  [{b}] {gen_tokens[b][:16].tolist()}")
    return gen_tokens


if __name__ == "__main__":
    main()
