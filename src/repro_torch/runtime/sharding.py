"""Sharding strategies: map a model's parameters, activations, batches
and caches onto a device mesh; and the process group of the row-sharded
PDHG solve.

The port's counterpart of `repro.runtime.sharding`.  Two strategies
(ModelConfig.sharding):

  "2d"   : FSDP x TP -- weights shard TP dims (heads / d_ff / vocab /
           experts) on "model" and d_model on "data" (FSDP); activations
           shard batch on "data" (x "pod") and, with `sp`, the residual
           stream's sequence dim on "model" between layers (SP).
  "fsdp" : ZeRO-3 -- every weight shards its largest divisible dim across
           as many mesh axes as possible; activations shard batch across
           ("data", "model") jointly.  Used by xLSTM.

A spec is a tuple with one entry a tensor dim: None (replicated), a mesh
axis name, or a tuple of names (the dim split over all of them); it
means what the reference's PartitionSpec means.  Parameter specs are
derived from the parameter's name, whose last part names its layout as
the reference's tree paths do.  The port's layers are a ModuleList, so a
spec is the reference's spec without its leading None for the stacked
group dim.

On a torch DeviceMesh a spec becomes DTensor placements (`placements`):
Shard(d) on each mesh dim the spec names at tensor dim d, Replicate()
elsewhere.  A dim named with several mesh axes is split over them in the
mesh's order (`_fsdp_spec` may list "pod" last on a ("pod", "data",
"model") mesh: the shards are the same size, held by other ranks).
`distribute` turns every parameter into a DTensor, `gather_for_compute`
redistributes them to what the compute consumes at step entry (the
reference's ZeRO-3 gather), and `install_sharder` hooks
`models.common.shard` to redistribute DTensor activations to their
logical spec, as the reference's `with_sharding_constraint` does.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
from torch._prims_common import make_contiguous_strides_for
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from ..models import common as mcommon

KINDS = ("2d", "fsdp")

# parameter name -> logical dim layout.  d = d_model-like (FSDP), m = TP
# dim ("model"), v = vocab, e = experts, . = replicated.
_LAYOUTS_2D = {
    "embed": "vd",      # vocab on model, d on data
    "unembed": "dv",
    "wq": "dm.", "wk": "dm.", "wv": "dm.", "wo": "m.d",
    "w_up": "dm", "w_gate": "dm", "w_down": "md",
    "router": "dm",
    # MoE expert stacks (E, D, F) / (E, F, D)
    "moe_gate": "ed.", "moe_up": "ed.", "moe_down": "e.d",
    "shared_gate": "dm", "shared_up": "dm", "shared_down": "md",
    "shared_mix": "d.",
    # rglru
    "w_x": "dm", "w_y": "dm", "w_a": ".m", "w_i": ".m", "w_out": "md",
    "conv_w": ".m", "conv_b": "m", "b_a": "m", "b_i": "m", "lam": "m",
    # xlstm (only reached under "2d" if configured; default fsdp)
    "w_q": "dm.", "w_k": "dm.", "w_v": "dm.",
    "w_f": "d.", "b_f": ".", "gn": "m",
    "w_z": "dm", "r_z": "...", "b_z": "m",
    "w_o": "dm", "r_o": "...", "b_o": "m",
    "w_ff1": "dm", "w_ff1g": "dm", "w_ff2": "md",
    "img_proj": "dd:",  # (D, D): shard second on model
}

_CHAR_TO_AXIS_2D = {"d": "data", "m": "model", "v": "model", "e": "model",
                    ".": None}


def _entry(axes: tuple):
    """A spec entry from the mesh axes a dim is split over."""
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def _names(entry) -> tuple:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _leaf_name(name: str) -> str:
    """The layout name of a dotted parameter (or cache) name: its last
    part that is not a layer index."""
    for part in reversed(name.split(".")):
        if not part.isdigit():
            return part
    return ""


@dataclasses.dataclass
class Strategy:
    mesh: DeviceMesh
    kind: str                       # "2d" | "fsdp"
    multi_pod: bool
    # sequence parallelism: shard the residual stream's seq dim on "model"
    # between blocks
    sp: bool = False

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"strategy kind must be one of {KINDS}, got "
                             f"{self.kind!r}")
        names = self.mesh.mesh_dim_names
        if not names:
            raise ValueError("a Strategy's mesh must name its dims "
                             "(mesh_dim_names)")
        self.axes = dict(zip(names, self.mesh.shape))

    @property
    def batch_axes(self) -> tuple:
        if self.kind == "fsdp":
            return (("pod", "data", "model") if self.multi_pod
                    else ("data", "model"))
        return ("pod", "data") if self.multi_pod else ("data",)

    @property
    def tp(self) -> int:
        return (self.axes["model"] if self.kind == "2d"
                and "model" in self.axes else 1)

    def axis_size(self, name: str) -> int:
        return self.axes.get(name, 1)

    def _divisible(self, dim: int, axes) -> bool:
        return dim % math.prod(self.axis_size(a) for a in _names(axes)) == 0

    def _batch_entry(self, dim: int):
        """The batch axes that divide `dim`, trailing ones dropped."""
        ax = self.batch_axes
        while ax and not self._divisible(dim, ax):
            ax = ax[:-1]
        return _entry(ax)

    # ------------------------------------------------------------------
    def logical_to_spec(self, axes: tuple, shape) -> tuple:
        """The spec of an activation with logical axes `axes` (the names
        models pass to `shard`)."""
        out = []
        for a, dim in zip(axes, shape):
            if a == "batch":
                out.append(self._batch_entry(dim))
            elif a == "seq":
                out.append("model" if self.sp and self.kind == "2d"
                           and dim % self.axis_size("model") == 0 else None)
            elif a in ("heads", "kv_heads", "mlp", "vocab", "experts"):
                out.append("model" if self.kind == "2d"
                           and dim % self.axis_size("model") == 0 else None)
            else:
                out.append(None)
        return _dedupe(out)

    # ------------------------------------------------------------------
    def param_spec(self, name: str, shape) -> tuple:
        """The spec of parameter `name` (a dotted name of
        `model.named_parameters()`) of shape `shape`."""
        leaf = _leaf_name(name)
        core = tuple(shape)
        if self.kind == "fsdp":
            return self._fsdp_spec(core)
        layout = _LAYOUTS_2D.get(leaf)
        if leaf in ("w_gate", "w_up", "w_down") and len(core) == 3:
            layout = {"w_gate": "ed.", "w_up": "ed.",
                      "w_down": "e.d"}[leaf]
        if leaf == "img_proj":
            layout = "d."
        if layout is None or len(layout.replace(":", "")) != len(core):
            return self._fsdp_spec(core)            # fallback: best-effort
        out = []
        for ch, dim in zip(layout.replace(":", ""), core):
            ax = _CHAR_TO_AXIS_2D[ch]
            if ax is not None and dim % self.axis_size(ax) != 0:
                ax = None
            out.append(ax)
        return _dedupe(out)

    def _fsdp_spec(self, core) -> tuple:
        """Shard the largest dim across as many axes as divide it."""
        if not core:
            return ()
        order = sorted(range(len(core)), key=lambda i: -core[i])
        axes_avail = [a for a in ("data", "model", "pod") if a in self.axes]
        out: list = [None] * len(core)
        used: set = set()
        for i in order:
            best: tuple = ()
            n = 1
            for a in axes_avail:
                if a in used:
                    continue
                if core[i] % (n * self.axis_size(a)) == 0:
                    best = best + (a,)
                    n *= self.axis_size(a)
            if best:
                out[i] = _entry(best)
                used.update(best)
        return tuple(out)

    def compute_spec(self, name: str, shape) -> tuple:
        """The spec of a parameter as the compute consumes it: its TP
        ("model") entries kept, its FSDP ("data"/"pod") entries dropped,
        so each weight is all-gathered once at step entry (ZeRO-3) and
        its gradient reduce-scattered back."""
        def keep(entry):
            return _entry(tuple(a for a in _names(entry)
                                if a not in ("data", "pod")))
        return tuple(keep(e) for e in self.param_spec(name, shape))

    # ------------------------------------------------------------------
    def specs_for(self, model: torch.nn.Module) -> dict:
        """param_spec of every parameter, keyed by name."""
        return {name: self.param_spec(name, p.shape)
                for name, p in model.named_parameters()}

    def batch_spec(self, batch: dict) -> dict:
        """Each batch tensor's spec: its leading dim on the batch axes
        that divide it."""
        def spec(t):
            if t.dim() == 0:
                return ()
            return (self._batch_entry(t.shape[0]),) + (None,) * (t.dim() - 1)
        return {k: spec(v) for k, v in batch.items()}

    def cache_spec(self, caches: list) -> list:
        """Each decode cache tensor's spec (the port's caches are one
        dict a layer; an attention cache's "len" is a Python int and has
        none): batch on the batch axes; under "2d" the kv-head dim of k
        and v, and a recurrent state's feature dim, on "model" when
        divisible."""
        def spec(name, shape):
            out: list = [None] * len(shape)
            if not shape:
                return ()
            out[0] = self._batch_entry(shape[0])
            model = self.axis_size("model")
            if self.kind == "2d" and name in ("k", "v") and len(shape) == 4:
                if shape[2] % model == 0:
                    out[2] = "model"
            elif self.kind == "2d" and name in ("S", "n", "h", "c", "m",
                                                "conv") and len(shape) >= 2:
                if shape[-1] % model == 0:
                    out[-1] = "model"
            return tuple(out)
        return [{k: spec(k, tuple(v.shape)) for k, v in layer.items()
                 if isinstance(v, torch.Tensor)} for layer in caches]

    # ------------------------------------------------------------------
    def placements(self, spec: tuple, shape=None) -> tuple:
        """DTensor placements of `spec` on this mesh: Shard(d) on each
        mesh dim that the spec names at tensor dim d, Replicate()
        elsewhere.  Given the tensor's `shape`, a dim of size 1 stays
        whole: a spec can split it only over mesh dims of one rank,
        where Shard and Replicate are the same layout, and DTensor
        refuses to reshape a sharded dim of size 1."""
        out = []
        for name in self.mesh.mesh_dim_names:
            dims = [d for d, e in enumerate(spec) if name in _names(e)
                    and (shape is None or shape[d] != 1)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def place(self, t: torch.Tensor, spec: tuple) -> DTensor:
        """`t` laid out by `spec`: a DTensor redistributed to it, or a
        plain tensor (the whole of it, the same on every rank) cut into
        this rank's shard without communication."""
        pl = self.placements(spec, t.shape)
        if isinstance(t, DTensor):
            if tuple(t.placements) == pl:
                return t
            return t.redistribute(self.mesh, pl)
        return distribute_tensor(t, self.mesh, pl, src_data_rank=None)

    def distribute(self, model: torch.nn.Module) -> torch.nn.Module:
        """Every parameter of `model` replaced in place by a DTensor
        parameter laid out by param_spec.  Every rank must hold the same
        full parameters (made from one seed, or converted from one
        tree); each keeps its shard.  Returns the model."""
        for name, p in list(model.named_parameters()):
            mod_name, _, leaf = name.rpartition(".")
            mod = model.get_submodule(mod_name) if mod_name else model
            local = p.detach()
            d = self.place(local, self.param_spec(name, p.shape))
            mod.register_parameter(
                leaf, torch.nn.Parameter(d, requires_grad=p.requires_grad))
        for mod in model.modules():
            if isinstance(mod, mcommon.CastWeights):
                mod._casts.clear()
        return model

    def gather_for_compute(self, model: torch.nn.Module) -> dict:
        """Each parameter redistributed to its compute_spec, keyed by
        name: the fp32 master is gathered and cast by the reader after,
        as the reference gathers before its casts.  Under autograd the
        gather's backward reduce-scatters the gradient to the
        parameter's own layout."""
        return {name: p.redistribute(self.mesh, self.placements(
                    self.compute_spec(name, p.shape), p.shape))
                for name, p in model.named_parameters()}

    def shard_batch(self, batch: dict) -> dict:
        """Every tensor of `batch` placed by batch_spec."""
        specs = self.batch_spec(batch)
        return {k: self.place(v, specs[k]) for k, v in batch.items()}

    def shard_caches(self, caches: list) -> list:
        """Every cache tensor placed by cache_spec (the "len" ints
        kept)."""
        specs = self.cache_spec(caches)
        return [{k: self.place(v, spec[k]) if k in spec else v
                 for k, v in layer.items()}
                for layer, spec in zip(caches, specs)]


def _dedupe(out: list) -> tuple:
    """A mesh axis may appear at most once per spec: the first dim that
    names it keeps it."""
    seen: set = set()
    for i, ax in enumerate(out):
        axs = _names(ax)
        if any(a in seen for a in axs):
            out[i] = None
        else:
            seen.update(axs)
    return tuple(out)


class _Pinned(torch.autograd.Function):
    """x redistributed to `placements`; in the backward the gradient is
    redistributed to the same placements and handed to x as it is (a
    gradient may lie in any layout of x's global shape).  DTensor's own
    redistribute hands it back in x's layout instead, and a Partial x
    then gets a Replicate gradient, which the products before take
    whole.  The gradient's shard is handed on contiguous: torch 2.11's
    DTensor can hand one laid out in another order than the DTensor's
    strides say (attention's einsum backward, under "2d"), and a view of
    it then fails on the shard."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        return x.redistribute(mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.redistribute(ctx.mesh, ctx.placements)
        local = grad.to_local()
        if not local.is_contiguous():
            grad = DTensor.from_local(
                local.contiguous(), ctx.mesh, ctx.placements,
                run_check=False, shape=grad.shape,
                stride=make_contiguous_strides_for(grad.shape))
        return grad, None, None


def install_sharder(strategy: Strategy | None) -> None:
    """Hook models.common.shard to redistribute a DTensor activation, and
    its gradient in the backward, to its logical spec (`None` removes the
    hook).  A plain tensor passes through: the hook lays out what is
    already distributed."""
    if strategy is None:
        mcommon.set_sharder(None)
        return

    def sharder(x, axes):
        if not isinstance(x, DTensor):
            return x
        return _Pinned.apply(x, strategy.mesh, strategy.placements(
            strategy.logical_to_spec(axes, x.shape), x.shape))
    mcommon.set_sharder(sharder)


def solver_group(n_shards: int):
    """The process group of the `n_shards` ranks of a row-sharded PDHG
    solve: torch.distributed's default group, which must be initialized
    with a world of exactly `n_shards` ranks (rank r owns row block r).
    Raises ValueError for n_shards < 1, and naming how to launch when
    torch.distributed is not initialized or its world has another size.

    The reference builds a 1-D jax Mesh over the devices one controller
    sees (runtime.sharding.solver_mesh).  PyTorch has no single
    controller: a sharded solve is SPMD, one process a shard, each
    calling the solver with the same LP (core.solver shards=N), as
    `torchrun` runs them."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    how = (f"run one process a shard: launch with torchrun "
           f"--nproc-per-node {n_shards}, or call torch.distributed."
           f"init_process_group(world_size={n_shards}, rank=...) in each "
           f"of {n_shards} processes first")
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(f"solver_group({n_shards}) needs torch.distributed "
                         f"initialized with {n_shards} ranks, and it is not "
                         f"initialized; {how}")
    world = dist.get_world_size()
    if world != n_shards:
        raise ValueError(f"solver_group({n_shards}) needs a world of "
                         f"{n_shards} ranks but torch.distributed has "
                         f"{world}; {how}")
    return dist.group.WORLD
