"""End-to-end training launcher: the port's counterpart of the reference's
`launch/train.py`, with its command line and log lines.

Runs any --arch (full or --smoke config) on one device: weights drawn
from a `torch.Generator` seeded with --seed on the device, the
deterministic synthetic data stream (`data.pipeline`), the co-flow plan
of the gradient buckets logged (`core.fabric` over the modelled
`v5e_fabric()` of a TPU pod: its "comm makespan" is a modelled figure,
not a measurement), the remat train step (`runtime.steps`), checkpoints
of {"params": the model's state dict, "opt": the AdamW state} every
--ckpt-every steps and at the end (a step saved already is not written
twice) with --resume from the newest, and the straggler monitor.  An
encoder-decoder model trains on zero frame embeddings (32 frames) and a
VLM on zero image embeddings, as in the reference.  `main` returns the
list of losses.

On the card the run is bitwise repeatable: deterministic algorithms on
(the backward of the embedding gather sums its rows in a fixed order),
cuBLAS's workspace fixed through CUBLAS_WORKSPACE_CONFIG, and bf16
products summed in fp32 (no bf16 split-K reduction), as the serve CLI
sets it.  --device defaults to cuda and fails without a card; pass
--device cpu to run on the host.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
      --smoke --device cpu --steps 5
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os

import torch

from .. import configs
from ..core import fabric
from ..data import DataConfig, synthetic_stream
from ..device import resolve
from ..ft import CheckpointManager, HeartbeatMonitor
from ..models import transformer
from ..runtime import steps as rsteps
from ..train import optimizer as ropt
from .serve import ENC_FRAMES


def scale_config(cfg, d_model=None, n_layers=None):
    upd = {}
    if d_model:
        upd["d_model"] = d_model
    if n_layers:
        upd["n_layers"] = n_layers
    return dataclasses.replace(cfg, **upd) if upd else cfg


def group_bytes(model: transformer.Transformer) -> list[tuple[str, float]]:
    """The fp32 bytes of each block-pattern slot's stacked layers, as the
    reference's `params["groups"]` holds them (the layers left over
    after the last whole group are not in a group)."""
    cfg = model.cfg
    P = len(cfg.block_pattern)
    stacked = cfg.n_layers // P * P
    return [(f"group{i}", float(sum(
        p.numel() * p.element_size()
        for block in model.blocks[i:stacked:P] for p in block.parameters())))
        for i in range(P)]


def _run(args) -> list[float]:
    cfg = configs.get(args.arch, smoke=args.smoke)
    cfg = scale_config(cfg, args.d_model or None, args.n_layers or None)
    device = resolve(args.device)
    print(f"arch={cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"device={device}")

    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = transformer.Transformer(cfg, generator=gen, device=device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"params: {n_params/1e6:.1f}M")

    ocfg = ropt.AdamWConfig(lr=args.lr, total_steps=args.steps,
                            warmup_steps=max(args.steps // 20, 5))
    opt_state = ropt.adamw_init(dict(model.named_parameters()))

    # co-flow plan for the gradient buckets (logged; the reference's
    # runtime analogue runs inside shard_map on multi-device meshes)
    spec = fabric.v5e_fabric()
    buckets = fabric.grad_buckets_for(group_bytes(model), bucket_bytes=16e6,
                                      data_axes=(0, 1))
    plan = fabric.plan_collectives(spec, buckets, n_slots=8, device=device)
    print(f"coflow plan: {len(buckets)} buckets, "
          f"comm makespan {plan.completion_s*1e3:.2f} ms/step "
          f"(energy model {plan.energy_j:.3f} J)")

    train_step = rsteps.make_train_step(cfg, ocfg, remat=True)
    data = DataConfig(vocab_size=cfg.vocab_size, batch=args.batch,
                      seq=args.seq, seed=args.seed)
    start = 0
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and args.resume and ckpt.latest_step() is not None:
        tmpl = {"params": model.state_dict(), "opt": opt_state}
        tree, manifest = ckpt.restore(tmpl, device=device)
        model.load_state_dict(tree["params"])
        opt_state = tree["opt"]
        start = manifest["step"]
        del tree
        print(f"resumed from step {start}")

    mon = HeartbeatMonitor()
    stream = synthetic_stream(data, start_step=start)
    losses = []
    saved = None
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in next(stream).items()}
        if cfg.family == "encdec":
            batch["enc_embeds"] = torch.zeros(
                (args.batch, ENC_FRAMES, cfg.d_model), dtype=torch.bfloat16,
                device=device)
        if cfg.family == "vlm":
            batch["img_embeds"] = torch.zeros(
                (args.batch, cfg.n_img_tokens, cfg.d_model),
                dtype=torch.bfloat16, device=device)
        mon.step_start()
        model, opt_state, metrics = train_step(model, opt_state, batch)
        loss = float(metrics["loss"])
        ev = mon.step_end(step)
        losses.append(loss)
        if ev:
            print(f"[straggler] step {step}: {ev.wall_s:.2f}s "
                  f"({ev.severity:.1f}x median)")
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f}")
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, {"params": model.state_dict(),
                                 "opt": opt_state}, extra={"loss": loss})
            saved = step + 1
    if not losses:
        print(f"nothing to train: the checkpoint is at step {start}")
        return losses
    if ckpt and saved != args.steps:
        ckpt.save(args.steps, {"params": model.state_dict(),
                               "opt": opt_state}, extra={"loss": losses[-1]})
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


def main(argv=None) -> list[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--n-layers", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    with reproducible(torch.device(args.device)):
        return _run(args)


@contextlib.contextmanager
def reproducible(device: torch.device):
    """On a CUDA device: deterministic algorithms on and bf16 products
    summed in fp32, restored afterwards; CUBLAS_WORKSPACE_CONFIG set if
    unset (it must be set before the process's first cuBLAS call to take
    effect there).  Nothing on the CPU."""
    if device.type != "cuda":
        yield
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    deterministic = torch.are_deterministic_algorithms_enabled()
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(deterministic)
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            reduced


if __name__ == "__main__":
    main()
