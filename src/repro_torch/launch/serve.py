"""Batched serving: prefill a batch of prompts, then decode.

The port's counterpart of the reference's `launch/serve.py`: the serving
path (prefill -> caches -> decode loop) with greedy sampling, for every
architecture of the zoo: the dense phi4-mini, nemotron, gemma2 and
h2o-danube, the MoE granite-moe and qwen2-moe, the recurrent hybrid
recurrentgemma, xlstm, the encoder-decoder seamless-m4t and the VLM
internvl2.  Weights, prompt tokens and the stub frontends' inputs come
from one `torch.Generator` seeded with --seed, on the device, in that
order: an encoder-decoder model draws frame embeddings (B, 32, d), whose
encoding (the memory) is computed once and fed to every decode step; a
VLM draws image embeddings (B, n_img_tokens, d), and its caches and
decode positions count those tokens before the prompt's.

--impl kernel (the default) runs the prefill's causal self-attention and
RG-LRU scan through the hand-written CUDA kernels on the card and
through their plain versions on the CPU; --impl einsum runs the einsum
attention and the associative scan, which is what the reference serve
CLI runs (its steps default to impl="xla").  --device defaults to cuda
and fails without a card; pass --device cpu to run on the host.

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

# an encoder-decoder model's stub audio frontend: frames a prompt
ENC_FRAMES = 32


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
    """The model and a prefill batch ({"tokens"}, plus "enc_embeds" for an
    encoder-decoder model, "img_embeds" for a VLM), all drawn from one
    generator seeded with `seed` on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    model = transformer.Transformer(cfg, generator=gen, device=device)
    inputs = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                      generator=gen, device=device)}
    if cfg.family == "encdec":
        inputs["enc_embeds"] = torch.randn((batch, ENC_FRAMES, cfg.d_model),
                                           generator=gen, device=device)
    if cfg.family == "vlm":
        inputs["img_embeds"] = torch.randn(
            (batch, cfg.n_img_tokens, cfg.d_model), generator=gen,
            device=device)
    return model, inputs


def prefix_len(cfg: ModelConfig) -> int:
    """Positions before the prompt's: a VLM's image tokens."""
    return cfg.n_img_tokens if cfg.family == "vlm" else 0


def generate(model: transformer.Transformer, inputs: dict, gen: int,
             *, impl: str) -> Generation:
    """Prefill `inputs` (build's batch), then decode greedily (argmax over
    the padded vocabulary; the first maximum wins) to `gen` tokens in
    all."""
    cfg = model.cfg
    toks = inputs["tokens"]
    device = toks.device
    P = toks.shape[1]
    pos0 = P + prefix_len(cfg)
    prefill = rsteps.make_prefill_step(cfg, impl=impl, max_len=pos0 + gen)
    decode = rsteps.make_decode_step(cfg, impl=impl)
    memory = None
    if cfg.family == "encdec":
        with torch.no_grad():
            memory = transformer.encode(model, inputs["enc_embeds"])

    _sync(device)
    t0 = time.perf_counter()
    logits, caches = prefill(model, inputs)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    prefill_logits = logits

    out_tokens = [torch.argmax(logits[:, -1], dim=-1)]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, caches = decode(model, caches, out_tokens[-1][:, None],
                                pos0 + i, memory)
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
    # bf16 products summed in fp32 and rounded once, as the reference's
    # bf16 dots are (models/common.py::matmul): no bf16 split-K sums
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    B, P = args.batch, args.prompt_len
    model, inputs = build(cfg, B, P, args.seed, device)
    g = generate(model, inputs, args.gen, impl=args.impl)

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
