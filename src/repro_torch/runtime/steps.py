"""Step factories: the port's counterpart of the reference's
`runtime/steps.py` (`make_train_step`, `make_prefill_step`,
`make_decode_step` and `synthetic_batch_shapes`).

Each factory returns a function of the model (the reference's params).
The train step computes the loss CE + AUX_WEIGHT * aux under autograd,
its gradients into the parameters' `.grad` (`compute_grads`), and an
AdamW update in place; it trains on impl="einsum", the counterpart of
the reference's "xla": no kernel has a backward, in the reference or
here, so impl="kernel" raises.  The serving steps run without autograd;
`impl` is "kernel" (the counterpart of the reference's "pallas": the
prefill's causal self-attention and RG-LRU scan go through the CUDA
kernels) or "einsum".  A batch is {"tokens"} (and "labels" to train)
plus "enc_embeds" for an encoder-decoder model and "img_embeds" for a
VLM; a decode step takes the encoder's memory as its fifth argument, as
the reference's does.

With a sharding `strategy` (a `runtime.sharding.Strategy`) a step runs
on the ranks of its mesh, one process a rank, each calling it with the
same arguments: the model's parameters DTensors (`Strategy.distribute`;
the AdamW state made from them by `adamw_init`), the batch (and a decode step's caches
and memory) whole on every rank or already DTensors.  At step entry the
batch is laid out by `batch_spec` and the caches by `cache_spec`, the
parameters are gathered to their `compute_spec` (the reference's ZeRO-3
gather; its backward reduce-scatters the gradients), the activation
sharder is installed, and every op runs on DTensors, plain tensors made
inside the model (positions, masks) read as replicated.  The logits and
caches a serving step returns are DTensors; a train step's metrics are
plain tensors, the same on every rank, the grad norm taken over every
shard.  Microbatches then slice each rank's rows of the batch.
"""
from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from ..models import attention, transformer
from ..models import common as mcommon
from ..models.common import ModelConfig, cross_entropy
from ..train import optimizer as opt
from . import sharding

AUX_WEIGHT = 0.01     # MoE load-balance loss weight


def _check(cfg: ModelConfig, impl: str, strategy) -> None:
    if strategy is not None and not isinstance(strategy, sharding.Strategy):
        raise TypeError(f"strategy must be a runtime.sharding.Strategy or "
                        f"None, got {type(strategy).__name__}")
    if impl not in attention.IMPLS:
        raise ValueError(f"impl must be one of {attention.IMPLS}, got "
                         f"{impl!r}")
    transformer.check_supported(cfg)


def _same_config(cfg: ModelConfig, model: transformer.Transformer) -> None:
    if model.cfg != cfg:
        raise ValueError(f"step built for {cfg.name}, model is "
                         f"{model.cfg.name}")


def _check_train(impl: str) -> None:
    if impl != "einsum":
        raise ValueError(f"training runs impl='einsum'; impl={impl!r} has "
                         f"no backward (no kernel has one, in the reference "
                         f"or the port)")


def _slice(batch: dict, i: int, n: int) -> dict:
    """Microbatch i of n: contiguous rows of every batch tensor; of a
    DTensor, contiguous rows of each rank's shard, laid out as before."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, DTensor):
            local = v.to_local()
            if local.shape[0] % n:
                raise ValueError(f"{k}: {local.shape[0]} rows a rank do "
                                 f"not split into {n} microbatches")
            mb = local.shape[0] // n
            rows = v.shape[0] // n
            # a slice of one row in all stays whole (Strategy.placements)
            pl = tuple(Replicate() if rows == 1 and p.is_shard(0) else p
                       for p in v.placements)
            out[k] = DTensor.from_local(local[i * mb:(i + 1) * mb],
                                        v.device_mesh, pl, run_check=False)
            continue
        mb = v.shape[0] // n
        out[k] = v[i * mb:(i + 1) * mb]
    return out


def _check_distributed(model: transformer.Transformer) -> None:
    plain = [n for n, p in model.named_parameters()
             if not isinstance(p, DTensor)]
    if plain:
        raise ValueError(f"a step with a strategy takes a model whose "
                         f"parameters are DTensors (Strategy.distribute); "
                         f"{plain[0]} and {len(plain) - 1} more are not")


@contextlib.contextmanager
def _sharded(strategy):
    """The strategy's activation sharder installed, and plain tensors
    read as replicated, for the span of a step (nothing without a
    strategy)."""
    if strategy is None:
        yield
        return
    previous = mcommon._SHARDER
    sharding.install_sharder(strategy)
    try:
        with implicit_replication():
            yield
    finally:
        mcommon.set_sharder(previous)


@contextlib.contextmanager
def _gathered(strategy, model: torch.nn.Module):
    """Inside the block the model's parameters read as their copies
    gathered to compute_spec, in the autograd graph of the parameters
    they came from (the model's own outside a strategy).  A CastWeights
    module keys its cached casts on the parameters themselves."""
    if strategy is None:
        yield
        return
    saved = []
    try:
        for name, t in strategy.gather_for_compute(model).items():
            mod_name, _, leaf = name.rpartition(".")
            mod = model.get_submodule(mod_name) if mod_name else model
            saved.append((mod, leaf, mod._parameters[leaf]))
            if isinstance(mod, mcommon.CastWeights):
                mod._sources[leaf] = mod._parameters[leaf]
            mod._parameters[leaf] = t
        yield
    finally:
        for mod, leaf, p in reversed(saved):
            mod._parameters[leaf] = p
            if isinstance(mod, mcommon.CastWeights):
                mod._sources.pop(leaf, None)


def _plain(t):
    """A DTensor metric as a plain tensor, the same on every rank."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def compute_grads(cfg: ModelConfig, model: transformer.Transformer,
                  batch: dict, *, impl: str = "einsum", remat: bool = True,
                  microbatches: int = 1, strategy=None):
    """The gradient of CE + AUX_WEIGHT * aux into each parameter's `.grad`
    (fp32, replacing what was there; the parameters are made to require
    grad).  With microbatches > 1 the batch's rows are cut into that many
    contiguous slices, each slice's gradient summed into `.grad` in fp32
    and the sum divided by the count, as the reference's scan does.
    Returns (CE, aux), each averaged over the microbatches.  Under a
    `strategy` (see the module's docstring) each microbatch gathers the
    parameters anew, as the reference's loss function does."""
    _same_config(cfg, model)
    _check_train(impl)
    _check(cfg, impl, strategy)
    if strategy is not None:
        _check_distributed(model)
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(True)
        p.grad = None
    loss_sum = aux_sum = None
    with torch.enable_grad(), _sharded(strategy):
        if strategy is not None:
            batch = strategy.shard_batch(batch)
        for i in range(microbatches):
            mb = batch if microbatches == 1 else _slice(batch, i,
                                                        microbatches)
            with _gathered(strategy, model):
                logits, aux = transformer.train_logits(model, mb, impl=impl,
                                                       remat=remat)
                loss = cross_entropy(logits, mb["labels"],
                                     n_real_vocab=cfg.vocab_size)
                del logits
                aux = torch.as_tensor(aux, dtype=torch.float32,
                                      device=loss.device)
                (loss + AUX_WEIGHT * aux).backward()
            loss, aux = loss.detach(), aux.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            aux_sum = aux if aux_sum is None else aux_sum + aux
        for p in params:
            if p.grad is None:       # a weight the batch does not reach
                p.grad = torch.zeros_like(p)
        if microbatches > 1:
            n = torch.full((), microbatches, dtype=torch.float32,
                           device=params[0].device)
            for p in params:
                p.grad.div_(n)
            loss_sum, aux_sum = loss_sum / n, aux_sum / n
    return _plain(loss_sum), _plain(aux_sum)


def make_train_step(cfg: ModelConfig, ocfg: opt.AdamWConfig, *,
                    impl: str = "einsum", remat: bool = True,
                    strategy=None, microbatches: int = 1):
    """Train-step factory: train_step(model, opt_state, batch) -> (model,
    opt_state, metrics), the model's parameters and the optimizer state
    updated in place.  metrics: "loss" (the CE alone), "aux_loss",
    "grad_norm" and "step", 0-dim tensors on the device.  `remat`
    recomputes each layer in the backward (memory, not numbers);
    microbatches > 1 accumulates the gradient over batch slices; a
    `strategy` runs the step on its mesh's ranks (module docstring)."""
    _check(cfg, impl, strategy)
    _check_train(impl)
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")

    def train_step(model, opt_state, batch):
        loss, aux = compute_grads(cfg, model, batch, impl=impl, remat=remat,
                                  microbatches=microbatches,
                                  strategy=strategy)
        params = dict(model.named_parameters())
        grads = {k: p.grad for k, p in params.items()}
        with _sharded(strategy):
            _, opt_state, gnorm = opt.adamw_update(ocfg, params, grads,
                                                   opt_state)
        for p in params.values():
            p.grad = None
        metrics = {"loss": loss, "aux_loss": aux, "grad_norm": _plain(gnorm),
                   "step": opt_state["step"]}
        return model, opt_state, metrics
    return train_step


def make_prefill_step(cfg: ModelConfig, *, impl: str = "einsum",
                      max_len: int = 0, strategy=None):
    _check(cfg, impl, strategy)

    @torch.no_grad()
    def prefill_step(model, batch):
        _same_config(cfg, model)
        if strategy is None:
            return transformer.prefill(model, batch, impl=impl,
                                       max_len=max_len)
        _check_distributed(model)
        with _sharded(strategy), _gathered(strategy, model):
            return transformer.prefill(model, strategy.shard_batch(batch),
                                       impl=impl, max_len=max_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, impl: str = "einsum",
                     strategy=None):
    _check(cfg, impl, strategy)

    @torch.no_grad()
    def decode_step(model, caches, tokens, position, memory=None):
        _same_config(cfg, model)
        if strategy is None:
            return transformer.decode_step(model, caches, tokens, position,
                                           memory=memory, impl=impl)
        _check_distributed(model)
        with _sharded(strategy), _gathered(strategy, model):
            placed = strategy.shard_batch(
                {"tokens": tokens} if memory is None
                else {"tokens": tokens, "memory": memory})
            return transformer.decode_step(
                model, strategy.shard_caches(caches), placed["tokens"],
                position, memory=placed.get("memory"), impl=impl)
    return decode_step


def synthetic_batch_shapes(cfg: ModelConfig, batch: int, seq: int, *,
                           mode: str = "train", enc_len: int = 4096) -> dict:
    """Stand-ins for every model input on the "meta" device (shapes and
    dtypes, no storage), as the reference's ShapeDtypeStructs."""
    def sd(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    if mode not in ("train", "prefill"):
        raise ValueError(mode)
    text = seq - (cfg.n_img_tokens if cfg.family == "vlm" else 0)
    b = {"tokens": sd((batch, text), torch.int32)}
    if mode == "train":
        b["labels"] = sd((batch, text), torch.int32)
    if cfg.family == "encdec":
        b["enc_embeds"] = sd((batch, min(enc_len, seq), cfg.d_model),
                             torch.bfloat16)
    if cfg.family == "vlm":
        b["img_embeds"] = sd((batch, cfg.n_img_tokens, cfg.d_model),
                             torch.bfloat16)
    return b
