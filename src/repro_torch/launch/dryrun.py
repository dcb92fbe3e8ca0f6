"""Dry run of a sharded step at full size, on no device: per-rank flops,
bytes, collectives and memory for each (architecture x shape) cell.

The port's counterpart of `repro.launch.dryrun`, with its CLI, `SHAPES`,
`CellResult` schema and cell logic (`input_specs`, `count_params`,
`pick_strategy_kind`, `auto_microbatches`, `run_cell`).  The reference
lowers and compiles the jitted step on 512 placeholder host devices and
reads XLA's cost and memory analyses.  Here one process stands up a
torch.distributed world of 256 ranks (512 with --multi-pod) on the
"fake" backend, whose collectives move nothing, builds the model, the
optimizer state and the inputs on the "meta" device (shapes and dtypes,
no storage: nothing is allocated on any device), lays them out with the
cell's `runtime.sharding.Strategy` as rank 0's shards, and runs the
step of `runtime.steps` once, counting:

  flops_per_device  the flops of the ops rank 0 runs on its local
                    shards (torch's flop formulas for products and
                    attention), not of the global DTensor ops
                    (run_cell's `by_op` and --by-op split them by op
                    and local operand shapes);
  bytes_per_device  the bytes each such op reads and writes, summed op
                    by op: an unfused count (no op's output is taken to
                    stay on chip for the next), not XLA's "bytes
                    accessed" of fused kernels;
  collectives       by kind ("all-gather", "reduce-scatter",
                    "all-reduce", "all-to-all"): the per-rank bytes of
                    each collective's result, and under "_counts" the
                    number of each: the functional collectives that
                    torch's CommDebugMode counts, counted here (its
                    per-module tracker fails in an MoE train step's
                    recomputed forward);
  memory            argument_size_in_bytes and output_size_in_bytes: a
                    rank's shards of the step's inputs (parameters,
                    optimizer state, batch or caches) and outputs.

The ops DTensor's sharding propagation runs on global shapes to learn
an op's output are not counted.  Meta tensors, not FakeTensorMode's fake
ones: fake CUDA tensors cannot run autograd where torch has no CUDA, and
fake CPU tensors would take the CPU's products (bf16 taken in fp32);
meta tensors run the card's code paths anywhere.  As in the reference the
parameters are bf16 (the AdamW moments fp32) and training recomputes
each layer in the backward (remat).  Microbatches split each rank's rows
(runtime.steps), so a train cell's factor is cut to a divisor of a
rank's rows: at 16 x 16 under fsdp each rank holds one train_4k
sequence, and the step runs whole.

Writes one JSON a cell to results/dryrun_torch/ (the reference's
results/dryrun/ is its own).  Run:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi4_mini_3_8b \\
      --shape train_4k
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .. import configs
from ..models import transformer
from ..models.common import ModelConfig
from ..runtime import steps as rsteps
from ..runtime.sharding import Strategy
from ..train import optimizer as ropt
from . import mesh as lmesh

RESULTS = (pathlib.Path(__file__).resolve().parents[3] / "results"
           / "dryrun_torch")

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, mode="train"),
    "prefill_32k": dict(seq=32768, batch=32, mode="prefill"),
    "decode_32k": dict(seq=32768, batch=128, mode="decode"),
    "long_500k": dict(seq=524288, batch=1, mode="decode"),
}

# the device of every tensor of a cell: shapes and dtypes, no storage.
# Not the CPU, whose bf16 products the port takes in fp32: the card's
# code paths run (products in bf16), and no card is needed
_NOWHERE = torch.device("meta")

# functional collective -> the reference's (XLA's) kind name
_KINDS = {"all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
          "all_to_all_single": "all-to-all",
          "shard_dim_alltoall": "all-to-all", "broadcast": "broadcast"}


def _fake_internals():
    """torch's fake process-group store and DTensor's global-shape
    propagation, the two internal APIs the dry run stands on."""
    try:
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            f"the dry run needs torch's internal fake process group "
            f"(torch.testing._internal.distributed.fake_pg) and DTensor's "
            f"ShardingPropagator, which this torch ({torch.__version__}) "
            f"does not have: {e}") from e
    if not hasattr(ShardingPropagator, "_propagate_tensor_meta_non_cached"):
        raise RuntimeError(
            f"the dry run pauses its counts while DTensor propagates "
            f"global shapes (ShardingPropagator."
            f"_propagate_tensor_meta_non_cached), which this torch "
            f"({torch.__version__}) does not have")
    return FakeStore, ShardingPropagator


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _local_bytes(tree) -> int:
    """Bytes of a rank's shards of the tensors in a nested dict/list."""
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, DTensor):
        return _nbytes(tree.to_local())
    if isinstance(tree, torch.Tensor):
        return _nbytes(tree)
    return 0


class RankCounter(TorchDispatchMode):
    """Flops, bytes and collective result bytes of the ops one rank runs
    on its local tensors.  A DTensor op is passed on (NotImplemented), so
    DTensor runs it as local ops, which come back here; `paused` > 0
    skips ops (DTensor's global-shape propagation)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.flops_by_op: dict[str, int] = {}
        self.bytes = 0
        self.collective_bytes: dict[str, int] = {}
        self.collective_counts: dict[str, int] = {}
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.paused:
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += n
            key = f"{packet} " + " ".join(
                str(list(a.shape)) for a in args
                if isinstance(a, torch.Tensor))
            self.flops_by_op[key] = self.flops_by_op.get(key, 0) + n
        kind = _KINDS.get(func.name().split("::")[-1])
        if kind is not None and func.namespace in ("_c10d_functional",
                                                   "c10d_functional",
                                                   "_dtensor"):
            self.collective_bytes[kind] = (self.collective_bytes.get(kind, 0)
                                           + _local_bytes(out))
            self.collective_counts[kind] = (
                self.collective_counts.get(kind, 0) + 1)
        elif not func.is_view:
            flat = [a for a in list(args) + list(kwargs.values())]
            self.bytes += _local_bytes(flat) + _local_bytes(out)
        return out


@contextlib.contextmanager
def counting():
    """A RankCounter over the block, paused while DTensor propagates
    global shapes."""
    _, propagator = _fake_internals()
    counter = RankCounter()
    original = propagator._propagate_tensor_meta_non_cached

    def paused(self, *a, **kw):
        counter.paused += 1
        try:
            return original(self, *a, **kw)
        finally:
            counter.paused -= 1

    propagator._propagate_tensor_meta_non_cached = paused
    try:
        with counter:
            yield counter
    finally:
        propagator._propagate_tensor_meta_non_cached = original


@contextlib.contextmanager
def _fake_world(n: int):
    """A torch.distributed world of `n` ranks on the "fake" backend, this
    process rank 0; destroyed on exit."""
    if dist.is_initialized():
        raise RuntimeError("the dry run stands up its own fake world; "
                           "torch.distributed is already initialized")
    fake_store, _ = _fake_internals()
    dist.init_process_group("fake", store=fake_store(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def count_params(model: torch.nn.Module, cfg: ModelConfig
                 ) -> tuple[float, float]:
    """(total, active) parameter counts; active discounts MoE experts to
    the routed share (top_k/E) plus shared experts."""
    total = active = 0.0
    moe = cfg.moe
    for name, p in model.named_parameters():
        n = float(math.prod(p.shape))
        total += n
        parts = name.split(".")
        if moe and "ffn" in parts and parts[-1] in ("w_gate", "w_up",
                                                    "w_down"):
            active += n * moe.top_k / max(p.shape[0], 1)
        else:
            active += n
    return total, active


def input_specs(arch: str, shape: str, *, multi_pod: bool = False) -> dict:
    """Stand-ins on the "meta" device for every input of (arch, shape):
    shapes and dtypes, no storage."""
    cfg = configs.get(arch)
    sp = SHAPES[shape]
    mode = sp["mode"]
    if mode in ("train", "prefill"):
        return rsteps.synthetic_batch_shapes(cfg, sp["batch"], sp["seq"],
                                             mode=mode)
    batch = {"tokens": torch.empty((sp["batch"], 1), dtype=torch.int32,
                                   device="meta"),
             "position": torch.empty((), dtype=torch.int32, device="meta")}
    if cfg.family == "encdec":
        batch["memory"] = torch.empty((sp["batch"], 4096, cfg.d_model),
                                      dtype=torch.bfloat16, device="meta")
    return batch


@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    ok: bool
    seconds: float
    error: str = ""
    flops_per_device: float = 0.0
    bytes_per_device: float = 0.0
    collectives: dict | None = None
    memory: dict | None = None
    params_total: float = 0.0
    params_active: float = 0.0
    tokens: int = 0


def pick_strategy_kind(cfg, mode: str) -> str:
    """Measured-best sharding per (arch family x step kind), the
    reference's choice: dense train with ZeRO-3/fsdp, MoE train and all
    serving with 2-D TP."""
    if mode == "train" and cfg.moe is None and cfg.sharding == "2d":
        return "fsdp"
    return cfg.sharding


def auto_microbatches(mode: str, multi_pod: bool, unroll: bool) -> int:
    """The reference's gradient-accumulation factor for a train cell (8,
    or 32 on two pods; 1 when unrolled)."""
    if mode != "train" or unroll:
        return 1
    return 32 if multi_pod else 8


def _stand_in(t: torch.Tensor) -> torch.Tensor:
    """An input of `input_specs` on the dry run's storage-less device."""
    return torch.zeros(t.shape, dtype=t.dtype, device=_NOWHERE)


def _to_bf16(model: torch.nn.Module) -> None:
    """Every parameter of `model` replaced by its bf16 cast, as the
    reference's dry run draws bf16 parameters."""
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        mod.register_parameter(leaf, torch.nn.Parameter(
            p.detach().to(torch.bfloat16), requires_grad=False))


def run_cell(arch: str, shape: str, *, multi_pod: bool, sp: bool = False,
             impl: str = "einsum", unroll: bool = False,
             strategy_kind: str = "auto", microbatches: int = 0,
             by_op: dict | None = None) -> CellResult:
    """One cell's counts (module docstring).  `unroll` is accepted for
    the reference's CLI and changes nothing but the microbatch factor:
    the port's layers already run one by one.  A `by_op` dict gets the
    flops a rank by op and local operand shapes, largest first."""
    cfg = configs.get(arch)
    t0 = time.time()
    mesh_name = "2x16x16" if multi_pod else "16x16"

    if shape == "long_500k" and not cfg.subquadratic:
        return CellResult(arch, shape, mesh_name, ok=False, seconds=0.0,
                          error="skip: full-attention arch at 512k context "
                                "(see DESIGN.md §5)")

    dims = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    try:
        with _fake_world(math.prod(dims)):
            skind = (pick_strategy_kind(cfg, SHAPES[shape]["mode"])
                     if strategy_kind == "auto" else strategy_kind)
            strategy = Strategy(lmesh.make_host_mesh(dims, axes), skind,
                                multi_pod,
                                sp=sp and SHAPES[shape]["mode"] == "train")
            res = _count_step(cfg, arch, shape, strategy, unroll=unroll,
                              impl=impl, microbatches=microbatches)
            ops = res.pop("flops_by_op")
            if by_op is not None:
                by_op.update(ops)
    except Exception as e:
        return CellResult(arch, shape, mesh_name, ok=False,
                          seconds=time.time() - t0,
                          error=f"{type(e).__name__}: {e}\n"
                                f"{traceback.format_exc()[-2000:]}")
    return CellResult(arch, shape, mesh_name, ok=True,
                      seconds=time.time() - t0, **res)


def _count_step(cfg, arch: str, shape: str, strategy: Strategy, *,
                unroll: bool, impl: str, microbatches: int) -> dict:
    """The model, its inputs and the step of cell (arch, shape) under
    `strategy`, storage-less, and the step run once under a counter:
    CellResult's counted fields."""
    spc = SHAPES[shape]
    mode = spc["mode"]
    model = transformer.Transformer(cfg, generator=torch.Generator(),
                                    device=_NOWHERE, tp=strategy.tp)
    _to_bf16(model)
    n_total, n_active = count_params(model, cfg)
    strategy.distribute(model)
    inputs = {k: _stand_in(v) for k, v in
              input_specs(arch, shape, multi_pod=strategy.multi_pod).items()}
    if mode == "train":
        state = ropt.adamw_init(dict(model.named_parameters()))
        batch = strategy.shard_batch(inputs)
        rows = batch["tokens"].to_local().shape[0]
        mb = math.gcd(microbatches or auto_microbatches(
            mode, strategy.multi_pod, unroll), rows)
        fn = rsteps.make_train_step(cfg, ropt.AdamWConfig(), impl=impl,
                                    remat=True, strategy=strategy,
                                    microbatches=mb)
        args = (model, state, batch)
        tokens = spc["batch"] * spc["seq"]
    elif mode == "prefill":
        fn = rsteps.make_prefill_step(cfg, impl=impl,
                                      max_len=spc["seq"] + 128,
                                      strategy=strategy)
        args = (model, strategy.shard_batch(inputs))
        tokens = spc["batch"] * spc["seq"]
    else:
        caches = strategy.shard_caches(transformer.init_cache(
            cfg, spc["batch"], spc["seq"], device=_NOWHERE, tp=strategy.tp))
        placed = strategy.shard_batch(
            {k: v for k, v in inputs.items() if k != "position"})
        decode = rsteps.make_decode_step(cfg, impl=impl, strategy=strategy)

        def fn(model, caches, tokens, memory):
            return decode(model, caches, tokens, spc["seq"] - 1, memory)
        args = (model, caches, placed["tokens"], placed.get("memory"))
        tokens = spc["batch"]
    params = dict(model.named_parameters())
    arg_bytes = _local_bytes(params) + _local_bytes(list(args[1:]))
    with counting() as counter:
        out = fn(*args)
    # a train step updates the parameters and the state in place
    out_bytes = (_local_bytes(params) + _local_bytes(list(out[1:]))
                 if mode == "train" else _local_bytes(list(out)))
    return dict(flops_per_device=float(counter.flops),
                flops_by_op=dict(sorted(counter.flops_by_op.items(),
                                        key=lambda kv: -kv[1])),
                bytes_per_device=float(counter.bytes),
                collectives={**counter.collective_bytes,
                             "_counts": counter.collective_counts},
                memory={"argument_size_in_bytes": arg_bytes,
                        "output_size_in_bytes": out_bytes},
                params_total=n_total, params_active=n_active, tokens=tokens)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--sp", action="store_true")
    ap.add_argument("--strategy", default="auto",
                    choices=["auto", "2d", "fsdp"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--unroll", action="store_true",
                    help="the reference's roofline measurement mode: here "
                         "it only sets the microbatch factor to 1")
    ap.add_argument("--out", default=str(RESULTS),
                    help="directory of the cells' JSON files")
    ap.add_argument("--by-op", type=int, default=0, metavar="N",
                    help="print each cell's N largest ops by flops a rank")
    args = ap.parse_args(argv)

    archs = configs.all_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}_{shape}_{'2x16x16' if mp else '16x16'}"
                if args.unroll:
                    tag += "_unrolled"
                out = out_dir / f"{tag}.json"
                if out.exists() and not args.force:
                    prev = json.loads(out.read_text())
                    print(f"[cached] {tag}: ok={prev['ok']}")
                    continue
                by_op: dict = {}
                res = run_cell(arch, shape, multi_pod=mp, sp=args.sp,
                               unroll=args.unroll,
                               strategy_kind=args.strategy, by_op=by_op)
                out.write_text(json.dumps(dataclasses.asdict(res), indent=1))
                status = "OK" if res.ok else ("SKIP" if res.error.startswith(
                    "skip") else "FAIL")
                print(f"[{status}] {tag}: {res.seconds:.1f}s "
                      f"flops/dev={res.flops_per_device:.3g} "
                      f"{res.error.splitlines()[0] if res.error else ''}")
                for op, flops in list(by_op.items())[:args.by_op]:
                    print(f"  {flops:.6g} flops/dev {op}")


if __name__ == "__main__":
    main()
