"""Public wrappers around the hand-written CUDA kernels.

A wrapper checks device, dtype, contiguity and lengths, then launches
its kernel when the tensors lie on a CUDA device, or runs the kernel's
plain PyTorch version when they lie on the CPU.  There is no fallback:
a CUDA tensor goes to the kernel or the call raises.  Each wrapper keeps
a plain integer count of its kernel launches, so a run can show that
its path went through the kernel.

`flash_attention` and `rglru` also take DTensors (a sharding strategy's
activations) split only over dims the kernel treats independently
(batch, and heads or features): the kernel runs on each rank's shard
and the result carries the operands' placements, as the reference's
`shard_map` would run it.  Any other placement raises and names it; a
wrapper never gathers, and never drops to the plain version.
"""
from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from . import build
from . import flash_attention as fa
from . import pdhg_coo as pc
from . import pdhg_spmv as ps
from . import rglru_scan as rs

# launches of the fused burst on the card, either storage type: one
# cooperative CUDA launch a burst (every step, the bf16 conversions and
# the residual inside it)
PDHG_BURST_LAUNCHES = 0
# calls of the bf16-storage burst on the card (counted in both)
PDHG_BURST_BF16_LAUNCHES = 0
# calls of the adaptive driver on the card (each runs one burst a chunk)
PDHG_ADAPTIVE_CALLS = 0
# launches of the split step (pdhg_burst.cu's pdhg_split_step_*) on the
# card, either storage type, those inside CUDA-graph replays included: a
# burst without a collective is one launch; with one, a begin launch, one
# a step, and a finish launch
PDHG_SPLIT_LAUNCHES = 0
# of which with bf16-stored iterates
PDHG_SPLIT_BF16_LAUNCHES = 0
# replays of a burst plan's captured two-iteration graph (over NCCL; each
# replay is two step launches and two all_gathers)
PDHG_SPLIT_GRAPH_REPLAYS = 0
# calls of the row-sharded burst on the card
PDHG_SHARDED_CALLS = 0
# launches of the COO burst on the card (kernels/csrc/pdhg_coo.cu: one
# cooperative launch a burst) and of its residual entry (one a burst)
PDHG_COO_LAUNCHES = 0
PDHG_COO_RESIDUAL_LAUNCHES = 0
# launches of the flash-attention kernel on the card (one a call)
FLASH_ATTENTION_LAUNCHES = 0
# launches of the RG-LRU scan kernel on the card (one a call)
RGLRU_SCAN_LAUNCHES = 0

_F32 = torch.float32
_META_CACHE: dict = {}
_META_CACHE_MAX = 64


def _no_backward(name: str, **tensors) -> None:
    """Raise where autograd would need the kernel's gradient: the kernels
    (and the ctypes launch) have no backward, so their outputs would
    carry none and training would silently get zero gradient through
    them.  Train on impl="einsum", as the reference trains on "xla"."""
    if torch.is_grad_enabled():
        need = [n for n, t in tensors.items()
                if t is not None and t.requires_grad]
        if need:
            raise RuntimeError(
                f"{name}: {', '.join(need)} require grad, but the kernel "
                f"has no backward; train with impl='einsum' or call it "
                f"under torch.no_grad()")


def _shard_layout(name: str, operands: dict, dims: dict):
    """The mesh and placements of DTensor operands (None when every
    operand is a plain tensor).  operands: name -> tensor or None;
    dims: name -> {role: tensor dim}, the dims each operand may be split
    over by role ("batch", "heads"), which must be split alike in all of
    them.  Raises ValueError for a mix of DTensors and plain tensors,
    for operands on other meshes or laid out unlike each other, and for
    any placement but Replicate or a Shard of an allowed dim.  On a
    mesh dim of one rank a Shard is the whole tensor, read as Replicate."""
    given = {n: t for n, t in operands.items() if t is not None}
    kinds = {isinstance(t, DTensor) for t in given.values()}
    if kinds == {False}:
        return None
    if kinds != {True}:
        raise ValueError(f"{name}: {', '.join(given)} must all be DTensors "
                         f"or all plain tensors")
    first = next(iter(given))
    mesh = given[first].device_mesh
    roles = None
    for n, t in given.items():
        if t.device_mesh != mesh:
            raise ValueError(f"{name}: {n} lies on another mesh than "
                             f"{first}")
        by_dim = {d: r for r, d in dims[n].items()}
        layout = []
        for i, p in enumerate(t.placements):
            if p.is_replicate() or mesh.size(i) == 1:
                layout.append(None)
            elif isinstance(p, Shard) and p.dim in by_dim:
                layout.append(by_dim[p.dim])
            else:
                raise ValueError(
                    f"{name}: {n} has placements {tuple(t.placements)}; "
                    f"the kernel runs on shards split only over "
                    f"{' and '.join(f'{r} (dim {d})' for r, d in dims[n].items())}"
                    f", replicated elsewhere (lay the operands out so "
                    f"first: the wrapper does not gather)")
        if roles is None:
            roles = layout
        elif layout != roles:
            raise ValueError(f"{name}: {n} has placements "
                             f"{tuple(t.placements)}, split unlike {first}'s "
                             f"{tuple(given[first].placements)}")
    return mesh, roles


def _as_placed(t: torch.Tensor, mesh, roles, dims: dict) -> DTensor:
    """A rank's result shard as a DTensor split by `roles` (mesh dim ->
    role or None) over the result's dims `dims` (role -> dim)."""
    pl = tuple(Replicate() if r is None else Shard(dims[r]) for r in roles)
    return DTensor.from_local(t, mesh, pl, run_check=False)


# the burst's iterate storage types and their entry points in pdhg_burst.cu
_BURST_ENTRY = {"fp32": "pdhg_burst_f32", "bf16": "pdhg_burst_bf16"}


def _burst_lib() -> ctypes.CDLL:
    lib = build.load("pdhg_burst.cu")
    if lib.pdhg_burst_max_blocks.argtypes is None:
        for name in _BURST_ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p] * 31
            fn.restype = ctypes.c_int
        lib.pdhg_burst_max_blocks.argtypes = [ctypes.c_int] * 2
        lib.pdhg_burst_max_blocks.restype = ctypes.c_int
    return lib


def burst_max_blocks(precision: str = "fp32", device=None) -> int:
    """Blocks of the burst kernel that fit on the card at once: the grid
    of one burst launch by default."""
    device = torch.device("cuda") if device is None else torch.device(device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return int(_burst_lib().pdhg_burst_max_blocks(int(precision == "bf16"),
                                                  index))


def _meta_tensors(meta: tuple, device: torch.device):
    """(offsets int64, widths int32) of one blocked-ELL direction on
    `device`, cached by layout — the device form of EllBlocks.meta."""
    key = (meta, device)
    hit = _META_CACHE.get(key)
    if hit is None:
        offsets, widths = meta[0], meta[1]
        hit = (torch.tensor(offsets, dtype=torch.int64, device=device),
               torch.tensor(widths, dtype=torch.int32, device=device))
        if len(_META_CACHE) >= _META_CACHE_MAX:
            _META_CACHE.pop(next(iter(_META_CACHE)))
        _META_CACHE[key] = hit
    return hit


def _check_work(name: str, work, meta: tuple, device: torch.device):
    """A direction's work list: (lengths, order, items) int32 tensors on
    `device` of lengths (n_rows_pad,), (n_rows_pad,) and (n_items, 2)."""
    rows = meta[3]
    ok = (isinstance(work, tuple) and len(work) == 3
          and all(isinstance(t, torch.Tensor) and t.dtype == torch.int32
                  and t.device == device and t.is_contiguous()
                  for t in work)
          and tuple(work[0].shape) == (rows,)
          and tuple(work[1].shape) == (rows,)
          and work[2].dim() == 2 and work[2].shape[1] == 2)
    if not ok:
        raise ValueError(f"pdhg_burst: {name} must be the (lengths, order, "
                         f"items) int32 tensors of kernels.pdhg_spmv."
                         f"burst_work on {device}")


def _check_burst_args(named: dict, row_meta: tuple, col_meta: tuple,
                      iters: int) -> torch.device:
    """Validate a burst's operands; returns their common device."""
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    devices = {t.device for t in named.values()}
    if len(devices) != 1:
        raise ValueError(f"pdhg_burst operands span devices {devices}")
    n_pad, m_pad = col_meta[3], row_meta[3]

    def table_len(meta):
        offsets, widths, bm, _ = meta
        return offsets[-1] + bm * widths[-1]

    want = {
        "c": (_F32, n_pad), "tau": (_F32, n_pad), "xmax": (_F32, n_pad),
        "keep_n": (torch.bool, n_pad), "x0": (_F32, n_pad),
        "q": (_F32, m_pad), "sig": (_F32, m_pad), "ub": (torch.bool, m_pad),
        "keep_m": (torch.bool, m_pad), "y0": (_F32, m_pad),
        "row_idx": (torch.int32, table_len(row_meta)),
        "row_val": (_F32, table_len(row_meta)),
        "col_idx": (torch.int32, table_len(col_meta)),
        "col_val": (_F32, table_len(col_meta)),
    }
    for name, (dtype, length) in want.items():
        if name not in named:       # a burst plan checks x0, y0 per burst
            continue
        t = named[name]
        if t.dtype != dtype or t.dim() != 1 or t.shape[0] != length:
            raise ValueError(f"pdhg_burst: {name} must be a 1-D {dtype} "
                             f"tensor of length {length}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"pdhg_burst: {name} must be contiguous")
    return devices.pop()


def pdhg_burst(c, tau, xmax, q, sig, ub, keep_n, keep_m,
               row_idx, row_val, col_idx, col_val, x0, y0, *,
               row_meta: tuple, col_meta: tuple, iters: int,
               precision: str = "fp32", row_work=None, col_work=None,
               _blocks: int = 0):
    """One fused `iters`-iteration PDHG burst over a blocked-ELL operator.

    Arrays are storage-padded (x side n_pad, y side m_pad, see
    kernels.pdhg_spmv.ell_pack; padded slots carry c=tau=xmax=0 and
    sig=q=0 with ub=True, so they stay at zero); `keep_n`/`keep_m`
    freeze coordinates (True = hold).  `precision="bf16"` stores the
    iterates in bfloat16 between iterations (fp32 arithmetic; see
    pdhg_spmv.pdhg_update_burst); inputs and outputs are float32 either
    way.  Returns (x, y, worst), `worst` the terminal per-row residual
    vector.  `row_work` / `col_work` are the kernel's work lists, as
    kernels.pdhg_spmv.burst_work gives them: required on the card, and
    checked wherever they are given (the plain version passes them on).
    On CUDA tensors this is the kernel of
    kernels/csrc/pdhg_burst.cu, its pdhg_burst_f32 or pdhg_burst_bf16
    entry, one cooperative launch a burst on as many blocks as fit
    (`_blocks` > 0 asks for that many instead; a launch the card refuses
    raises); on CPU tensors the plain version,
    kernels.pdhg_spmv.pdhg_update_burst."""
    global PDHG_BURST_LAUNCHES, PDHG_BURST_BF16_LAUNCHES
    if precision not in _BURST_ENTRY:
        raise ValueError(f"unknown precision {precision!r}; "
                         f"have {tuple(_BURST_ENTRY)}")
    named = dict(c=c, tau=tau, xmax=xmax, q=q, sig=sig, ub=ub,
                 keep_n=keep_n, keep_m=keep_m, row_idx=row_idx,
                 row_val=row_val, col_idx=col_idx, col_val=col_val,
                 x0=x0, y0=y0)
    device = _check_burst_args(named, row_meta, col_meta, iters)
    for name, work, meta in (("row_work", row_work, row_meta),
                             ("col_work", col_work, col_meta)):
        if work is not None or device.type == "cuda":
            _check_work(name, work, meta, device)
    if device.type == "cpu":
        return ps.pdhg_update_burst(
            x0, y0, c, tau, xmax, q, sig, ub, keep_n, keep_m,
            row_idx, row_val, col_idx, col_val,
            row_meta=row_meta, col_meta=col_meta, iters=iters,
            precision=precision, row_work=row_work, col_work=col_work)
    if device.type != "cuda":
        raise ValueError(f"pdhg_burst runs on cuda or cpu tensors, got "
                         f"{device}")
    fn = getattr(_burst_lib(), _BURST_ENTRY[precision])
    n_pad, m_pad = col_meta[3], row_meta[3]
    row_off, row_w = _meta_tensors(row_meta, device)
    col_off, col_w = _meta_tensors(col_meta, device)
    row_len, row_order, row_items = row_work
    col_len, col_order, col_items = col_work
    n_row_items, n_col_items = row_items.shape[0], col_items.shape[0]
    x_out, x_bar = (torch.empty(n_pad, dtype=_F32, device=device)
                    for _ in range(2))
    y_out, worst = (torch.empty(m_pad, dtype=_F32, device=device)
                    for _ in range(2))
    if precision == "bf16":
        # the two ping-pong buffers of each side, in one tensor
        x_tmp = torch.empty(2 * n_pad, dtype=torch.bfloat16, device=device)
        y_tmp = torch.empty(2 * m_pad, dtype=torch.bfloat16, device=device)
    else:
        x_tmp = torch.empty(n_pad, dtype=_F32, device=device)
        y_tmp = torch.empty(m_pad, dtype=_F32, device=device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(n_pad, m_pad, int(iters), int(_blocks), index,
                 int(row_meta[2]), n_row_items, int(col_meta[2]),
                 n_col_items,
                 *(t.data_ptr() for t in (
                     c, tau, xmax, q, sig, ub, keep_n, keep_m,
                     row_off, row_w, row_idx, row_val, row_len, row_order,
                     row_items, col_off, col_w, col_idx, col_val, col_len,
                     col_order, col_items, x0, y0,
                     x_out, y_out, worst, x_tmp, y_tmp, x_bar)),
                 stream)
    if err != 0:
        raise RuntimeError(f"pdhg_burst ({precision}) cooperative launch "
                           f"failed: CUDA error {err}")
    PDHG_BURST_LAUNCHES += 1
    if precision == "bf16":
        PDHG_BURST_BF16_LAUNCHES += 1
    return x_out, y_out, worst


class _Direction(ctypes.Structure):
    """pdhg_burst.cu's Direction: one shard's ELL direction and its work
    list, as the split step reads it from a table on the card."""
    _fields_ = [("bm", ctypes.c_int), ("n_items", ctypes.c_int)] + [
        (name, ctypes.c_void_p)
        for name in ("off", "width", "idx", "val", "len", "order", "items")]


# local shards a process may hold on the card (pdhg_burst.cu's kMaxLocal:
# their directions ride in the split step's parameter block)
SPLIT_MAX_LOCAL = 4


class _SplitArgs(ctypes.Structure):
    """pdhg_burst.cu's SplitArgs: the operands of a split burst."""
    _fields_ = ([(name, ctypes.c_int)
                 for name in ("n_pad", "m_loc", "k", "shards")]
                + [("rows", _Direction * SPLIT_MAX_LOCAL),
                   ("cols", _Direction * SPLIT_MAX_LOCAL)]
                + [(name, ctypes.c_void_p) for name in (
                    "c", "tau", "xmax", "keep_n", "q", "sig", "ub", "keep_m",
                    "x0", "y0", "gathered", "parts")]
                + [("xs", ctypes.c_void_p * 2), ("ys", ctypes.c_void_p * 2)]
                + [(name, ctypes.c_void_p)
                   for name in ("x_bar", "x_out", "y_out", "worst")])


def _split_lib() -> ctypes.CDLL:
    lib = _burst_lib()
    if lib.pdhg_split_max_blocks.argtypes is None:
        for sfx in ("f32", "bf16"):
            fn = getattr(lib, f"pdhg_split_step_{sfx}")
            fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 6 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.pdhg_split_layout.argtypes = [ctypes.c_void_p]
        lib.pdhg_split_layout.restype = None
        out = (ctypes.c_longlong * 7)()
        lib.pdhg_split_layout(out)
        want = (ctypes.sizeof(_Direction), _Direction.items.offset,
                ctypes.sizeof(_SplitArgs), _SplitArgs.cols.offset,
                _SplitArgs.xs.offset, _SplitArgs.worst.offset,
                SPLIT_MAX_LOCAL)
        if tuple(out) != want:
            raise RuntimeError(f"pdhg_burst.cu lays out Direction and "
                               f"SplitArgs as {tuple(out)}, the host's "
                               f"mirrors as {want}")
        lib.pdhg_split_max_blocks.argtypes = [ctypes.c_int] * 2
        lib.pdhg_split_max_blocks.restype = ctypes.c_int
    return lib


def split_max_blocks(precision: str = "fp32", device=None) -> int:
    """Blocks of the split step that fit on the card at once: the grid of
    a split launch by default."""
    device = torch.device("cuda") if device is None else torch.device(device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return int(_split_lib().pdhg_split_max_blocks(int(precision == "bf16"),
                                                  index))


def split_schedule(iters: int) -> tuple[int, int]:
    """(pairs, tail): a burst of `iters` iterations as `pairs` replays of
    the two-iteration graph and `tail` (0 or 1) eager iterations after
    them."""
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    return iters // 2, iters % 2


class ShardGather:
    """The row-sharded burst's collective: every rank's (k, L) block of a
    tensor, stacked in rank order into (world * k, L) on its device, on
    every rank, into buffers kept across calls.  An all_gather, so each
    rank then sums the same partials in the same order
    (pdhg_spmv.ordered_sum); an all_reduce would leave the order to the
    backend.  Over NCCL it gathers straight into the kept buffer
    (all_gather_into_tensor), ordered with the current stream and so
    capturable in a CUDA graph.  gloo takes CUDA tensors as they are,
    but a gather through pinned host memory of our own is faster
    (PERF.md, phase 30): a copy to the host (which waits for the stream),
    the gather there, and a copy back on the current stream.  The next
    call's copy to the host waits for that one, so the buffers are
    reused safely."""

    def __init__(self, group, shape, dtype, device):
        self.group = group
        world = dist.get_world_size(group)
        n = shape[0] * (shape[1] if len(shape) > 1 else 1)
        self.shape = (world * shape[0], *shape[1:])
        self.out = torch.empty((world, n), dtype=dtype, device=device)
        self.nccl = dist.get_backend(group) == "nccl"
        self.stage = device.type == "cuda" and not self.nccl
        if self.stage:
            self.host_in = torch.empty(n, dtype=dtype, pin_memory=True)
            self.host_out = torch.empty((world, n), dtype=dtype,
                                        pin_memory=True)
            self.rows = list(self.host_out.unbind(0))
        else:
            self.rows = list(self.out.unbind(0))

    def __call__(self, t):
        if self.nccl:
            dist.all_gather_into_tensor(self.out, t.reshape(-1),
                                        group=self.group)
        elif self.stage:
            self.host_in.copy_(t.reshape(-1))
            dist.all_gather(self.rows, self.host_in, group=self.group)
            self.out.copy_(self.host_out, non_blocking=True)
        else:
            dist.all_gather(self.rows, t.reshape(-1), group=self.group)
        return self.out.view(self.shape)


def gather_shards(t, group):
    """ShardGather once: `t`'s (k, L) blocks of every rank in rank order,
    (world * k, L); `group` None is a world of this process alone."""
    if group is None:
        return t
    return ShardGather(group, tuple(t.shape), t.dtype, t.device)(t)


class ShardedBurst:
    """A row-sharded PDHG burst plan: the operands of one LP's k local
    shards and every buffer a burst needs, made once and reused by every
    burst (a restart ladder's rungs), run by every rank of `group` (a
    torch.distributed process group, see runtime.sharding.solver_group;
    None: this process holds every shard).

    The layout is kernels.pdhg_spmv.ell_pack_sharded's.  Each rank
    passes the replicated x side (c, tau, xmax, keep_n; n_pad) and its
    own k consecutive shards: the y side (q, sig, ub, keep_m; k * m_loc)
    and their tables (k shards' tables, shard-major), with each shard's
    work lists (`row_work` / `col_work`, k triples each, as
    pdhg_spmv.sharded_work gives them; required on the card).
    `plan(x0, y0, iters)` runs one burst from x0 (n_pad) and the local
    y0 (k * m_loc).  The one collective an iteration gathers the S =
    world * k partials of K^T y (ShardGather) and sums them in shard
    order, so x is bitwise the same on every rank and equal to one
    process stepping all S shards.  Returns (x, y, worst), y and worst
    gathered to the global layout (S * m_loc) on every rank; x is the
    plan's own buffer, overwritten by its next burst.

    On CUDA tensors a burst is pdhg_burst.cu's split step, a cooperative
    launch on `_blocks` blocks (0: as many as fit) on the current stream:
    without a group one launch of the whole burst; with one, a begin
    launch, then for each iteration the all_gather and one step launch,
    then a finish launch.  Over NCCL the iterations run as a CUDA graph of
    two (all_gather, step, all_gather, step), captured at the plan's first
    burst of two or more iterations and replayed iters // 2 times, an odd
    iteration after it eagerly (`capture`; the communicator is warmed by
    one gather first, since NCCL cannot set up under capture).  gloo's
    gather stages through pinned host memory and waits on the host, which
    a graph cannot hold, so over gloo every iteration is launched
    eagerly.  A launch the card refuses raises.  On CPU tensors a burst
    is the plain body, kernels.pdhg_spmv.pdhg_update_burst_sharded."""

    def __init__(self, group, c, tau, xmax, q, sig, ub, keep_n, keep_m,
                 row_idx, row_val, col_idx, col_val, *, row_meta: tuple,
                 col_meta: tuple, precision: str = "fp32", row_work=None,
                 col_work=None, _blocks: int = 0):
        if precision not in _BURST_ENTRY:
            raise ValueError(f"unknown precision {precision!r}; "
                             f"have {tuple(_BURST_ENTRY)}")
        m_loc = row_meta[3]
        k = max(q.shape[0] // m_loc, 1)
        # the shard checks of pdhg_burst on a k-shard layout
        shard_meta = tuple(row_meta[:3]) + (k * m_loc,)
        rsize, csize = ps.table_len(row_meta), ps.table_len(col_meta)
        named = dict(c=c, tau=tau, xmax=xmax, q=q, sig=sig, ub=ub,
                     keep_n=keep_n, keep_m=keep_m)
        device = _check_burst_args(
            dict(named, row_idx=row_idx[:rsize], row_val=row_val[:rsize],
                 col_idx=col_idx[:csize], col_val=col_val[:csize]),
            shard_meta, col_meta, 0)
        for name, t, size in (("row_idx", row_idx, rsize),
                              ("row_val", row_val, rsize),
                              ("col_idx", col_idx, csize),
                              ("col_val", col_val, csize)):
            if t.shape[0] != k * size or t.device != device:
                raise ValueError(f"pdhg_burst_sharded: {name} must hold {k} "
                                 f"shards' tables ({k * size} slots on "
                                 f"{device}), got {tuple(t.shape)} on "
                                 f"{t.device}")
        for name, work, meta in (("row_work", row_work, row_meta),
                                 ("col_work", col_work, col_meta)):
            if work is not None or device.type == "cuda":
                if not isinstance(work, (list, tuple)) or len(work) != k:
                    raise ValueError(f"pdhg_burst_sharded: {name} must list "
                                     f"the work lists of the {k} local "
                                     f"shards")
                for w in work:
                    _check_work(name, w, meta, device)
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"pdhg_burst_sharded runs on cuda or cpu "
                             f"tensors, got {device}")
        self.group, self.device, self.precision = group, device, precision
        self.row_meta, self.col_meta = row_meta, col_meta
        self.k, self.m_loc, self.n_pad = k, m_loc, col_meta[3]
        self.shard_meta = shard_meta
        self.operands = (c, tau, xmax, q, sig, ub, keep_n, keep_m, row_idx,
                         row_val, col_idx, col_val)
        self.work = dict(row_work=row_work, col_work=col_work)
        self.capture = False
        if device.type == "cuda":
            self._setup(int(_blocks))

    def _setup(self, blocks: int) -> None:
        """The card's side of the plan: its buffers, the kernel's operands
        and the gather."""
        dev, k, m_loc, n_pad = self.device, self.k, self.m_loc, self.n_pad
        if k > SPLIT_MAX_LOCAL:
            raise ValueError(f"pdhg_burst_sharded: a process holds at most "
                             f"{SPLIT_MAX_LOCAL} shards on the card, got "
                             f"{k}")
        (c, tau, xmax, q, sig, ub, keep_n, keep_m, row_idx, row_val,
         col_idx, col_val) = self.operands
        lib = _split_lib()
        bf16 = self.precision == "bf16"
        self.fn = getattr(lib, f"pdhg_split_step_{'bf16' if bf16 else 'f32'}")
        self.index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        self.blocks = blocks or split_max_blocks(self.precision, dev)
        store = torch.bfloat16 if bf16 else _F32

        def empty(n, dtype=_F32):
            return torch.empty(n, dtype=dtype, device=dev)

        self.xs = [empty(n_pad, store) for _ in range(2)]
        self.ys = [empty(k * m_loc, store) for _ in range(2)]
        self.x_in, self.x_bar, self.x_out = (empty(n_pad) for _ in range(3))
        self.y_in, self.y_out, self.worst = (empty(k * m_loc)
                                             for _ in range(3))
        self.parts = torch.empty((k, n_pad), dtype=_F32, device=dev)
        self.gather = (None if self.group is None
                       else ShardGather(self.group, (k, n_pad), _F32, dev))
        gathered = self.parts if self.gather is None else self.gather.out
        shards = (1 if self.group is None
                  else dist.get_world_size(self.group)) * k

        def directions(meta, idx, val, work):
            off, width = _meta_tensors(meta, dev)
            size = ps.table_len(meta)
            # the plan keeps every tensor the kernel reads a pointer of
            # (_meta_tensors' cache may drop these)
            self.keep += (off, width)
            return (_Direction * SPLIT_MAX_LOCAL)(*(
                _Direction(int(meta[2]), work[s][2].shape[0],
                           off.data_ptr(), width.data_ptr(),
                           idx[s * size:].data_ptr(),
                           val[s * size:].data_ptr(),
                           *(t.data_ptr() for t in work[s]))
                for s in range(k)))

        self.keep = ()
        self.args = _SplitArgs(
            n_pad, m_loc, k, shards,
            directions(self.row_meta, row_idx, row_val,
                       self.work["row_work"]),
            directions(self.col_meta, col_idx, col_val,
                       self.work["col_work"]),
            *(t.data_ptr() for t in (c, tau, xmax, keep_n, q, sig, ub, keep_m,
                                     self.x_in, self.y_in, gathered,
                                     self.parts)),
            (ctypes.c_void_p * 2)(*(t.data_ptr() for t in self.xs)),
            (ctypes.c_void_p * 2)(*(t.data_ptr() for t in self.ys)),
            *(t.data_ptr() for t in (self.x_bar, self.x_out, self.y_out,
                                     self.worst)))
        self.graph = None
        # over NCCL the iterations replay as a CUDA graph; over gloo the
        # gather stages through host memory and waits on the host, which a
        # graph cannot capture, so its iterations are launched eagerly
        self.capture = self.gather is not None and self.gather.nccl
        if self.capture:
            with torch.cuda.device(dev):
                self.gather(self.parts)       # NCCL sets up outside capture

    def _count(self, launches: int) -> None:
        global PDHG_SPLIT_LAUNCHES, PDHG_SPLIT_BF16_LAUNCHES
        PDHG_SPLIT_LAUNCHES += launches
        if self.precision == "bf16":
            PDHG_SPLIT_BF16_LAUNCHES += launches

    def _launch(self, steps: int, begin: int, finish: int, parity: int,
                count: bool = True) -> None:
        """One launch of the split step on the current stream (under
        capture, the capture's: read here, never before)."""
        err = self.fn(ctypes.byref(self.args), steps, begin, finish, parity,
                      self.blocks, self.index,
                      torch.cuda.current_stream(self.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"pdhg_burst_sharded ({self.precision}): "
                               f"the split step's cooperative launch "
                               f"failed: CUDA error {err}")
        if count:
            self._count(1)

    def _step(self, parity: int, count: bool = True) -> None:
        """One iteration with a group: the gather of the partials, then a
        step launch from buffer `parity`."""
        self.gather(self.parts)
        self._launch(1, 0, 0, parity, count)

    def _captured(self) -> torch.cuda.CUDAGraph:
        """The two-iteration graph (gather, step from buffer 0, gather,
        step from buffer 1), captured on a side stream at first use."""
        if self.graph is None:
            graph = torch.cuda.CUDAGraph()
            here = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(here)
            with torch.cuda.stream(side):
                # thread_local: the NCCL watchdog's event queries from its
                # own thread must not invalidate the capture
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self._step(0, count=False)
                    self._step(1, count=False)
                finally:
                    graph.capture_end()
            here.wait_stream(side)
            self.graph = graph
        return self.graph

    def __call__(self, x0, y0, iters: int):
        global PDHG_SPLIT_GRAPH_REPLAYS, PDHG_SHARDED_CALLS
        k, m_loc, group = self.k, self.m_loc, self.group
        device = _check_burst_args(dict(x0=x0, y0=y0), self.shard_meta,
                                   self.col_meta, iters)
        if device != self.device:
            raise ValueError(f"pdhg_burst_sharded: x0 and y0 lie on "
                             f"{device}, the plan on {self.device}")

        def gather_rows(t):
            return gather_shards(t.view(k, -1), group).reshape(-1)

        if device.type == "cpu":
            reduce = None if group is None else (
                lambda parts: ps.ordered_sum(
                    list(gather_shards(torch.stack(parts), group)
                         .unbind(0))))
            x, y, worst = ps.pdhg_update_burst_sharded(
                x0, y0, *self.operands, row_meta=self.row_meta,
                col_meta=self.col_meta, iters=iters, reduce=reduce,
                precision=self.precision, **self.work)
            return x, gather_rows(y), gather_rows(worst)
        with torch.cuda.device(device):
            self.x_in.copy_(x0)
            self.y_in.copy_(y0)
            if group is None:
                self._launch(iters, 1, 1, 0)
            else:
                self._launch(0, 1, 0, 0)
                pairs, tail = (split_schedule(iters) if self.capture
                               else (0, iters))
                for _ in range(pairs):
                    self._captured().replay()
                    PDHG_SPLIT_GRAPH_REPLAYS += 1
                    self._count(2)
                for it in range(tail):
                    self._step(it & 1)
                self._launch(0, 0, 1, iters & 1)
        PDHG_SHARDED_CALLS += 1
        return self.x_out, gather_rows(self.y_out), gather_rows(self.worst)


def pdhg_burst_sharded(group, c, tau, xmax, q, sig, ub, keep_n, keep_m,
                       row_idx, row_val, col_idx, col_val, x0, y0, *,
                       row_meta: tuple, col_meta: tuple, iters: int,
                       precision: str = "fp32", row_work=None,
                       col_work=None, _blocks: int = 0):
    """One `iters`-iteration PDHG burst over a row-block-sharded operator,
    run by every rank of `group` (a torch.distributed process group, see
    runtime.sharding.solver_group; None: this process holds every shard):
    a ShardedBurst over these operands, made and run once.  x0 is the
    replicated start (n_pad), y0 this rank's k shards' rows (k * m_loc);
    the other operands, the layout, the result (x, y, worst) and what
    runs where are ShardedBurst's.  `_blocks` > 0 asks the card for that
    many blocks a launch."""
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    plan = ShardedBurst(group, c, tau, xmax, q, sig, ub, keep_n, keep_m,
                        row_idx, row_val, col_idx, col_val,
                        row_meta=row_meta, col_meta=col_meta,
                        precision=precision, row_work=row_work,
                        col_work=col_work, _blocks=_blocks)
    return plan(x0, y0, iters)

def _segment_max(values, segments, num_segments: int):
    """out[s] = max of values[segments == s], -inf for an empty segment
    (jax.ops.segment_max's convention).  Runs where the tensors lie, as
    `scatter_reduce_(..., "amax")`: on the card its atomic maxima land in
    no fixed order, but a maximum is exact, so the result does not
    depend on the order."""
    out = torch.full((num_segments,), float("-inf"), dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce_(0, segments, values, reduce="amax",
                               include_self=True)


def pdhg_adaptive(c, tau, xmax, q, sig, ub, row_idx, row_val, col_idx,
                  col_val, x0, y0, tols, inst_n, inst_m, *,
                  num_inst: int, row_meta: tuple, col_meta: tuple,
                  chunk: int, max_chunks: int, precision: str = "fp32",
                  row_work=None, col_work=None):
    """Adaptive PDHG over a block-stacked instance batch: the reference's
    kernels.ops.pdhg_adaptive, a host loop of `chunk`-iteration bursts.

    Before each burst, instance i's coordinates are frozen (held) once
    it has converged; padded slots map to the dump segment `num_inst`
    (`inst_n`/`inst_m` give each storage coordinate's instance id),
    which is always frozen.  After each burst each instance's residual
    is the segment max of the burst's `worst` over `inst_m`, compared
    with `tols` in float32 (the reference runs with x64 off); an
    instance whose residual meets its tolerance freezes, and `used`
    records the chunks it ran.  The loop ends after `max_chunks` bursts
    or when every instance is frozen (one host sync a chunk).

    Every burst is `pdhg_burst` (the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors; `row_work`/`col_work` pass to it as
    they are); the masks and segment maxima are
    plain torch on the same device.  Returns (x, y, per-instance
    residuals, per-instance chunks used), the last two on the device."""
    global PDHG_ADAPTIVE_CALLS
    dev = x0.device
    inst_n = torch.as_tensor(inst_n, device=dev).long()
    inst_m = torch.as_tensor(inst_m, device=dev).long()
    tols = torch.as_tensor(tols, device=dev).to(_F32)
    if tols.shape != (num_inst,):
        raise ValueError(f"pdhg_adaptive: tols must have shape "
                         f"({num_inst},), got {tuple(tols.shape)}")
    always = torch.ones(1, dtype=torch.bool, device=dev)

    def residuals(worst):
        return _segment_max(worst, inst_m, num_inst + 1)[:num_inst]

    x, y = x0, y0
    worst = torch.zeros(y0.shape[0], dtype=_F32, device=dev)
    frozen = torch.zeros(num_inst, dtype=torch.bool, device=dev)
    used = torch.zeros(num_inst, dtype=torch.int32, device=dev)
    k = 0
    while k < max_chunks and not bool(frozen.all()):
        frozen_ext = torch.cat([frozen, always])
        x, y, worst = pdhg_burst(
            c, tau, xmax, q, sig, ub, frozen_ext[inst_n], frozen_ext[inst_m],
            row_idx, row_val, col_idx, col_val, x, y, row_meta=row_meta,
            col_meta=col_meta, iters=chunk, precision=precision,
            row_work=row_work, col_work=col_work)
        used = torch.where(frozen, used, k + 1)
        frozen = frozen | (residuals(worst) <= tols)
        k += 1
    if dev.type == "cuda":
        PDHG_ADAPTIVE_CALLS += 1
    return x, y, residuals(worst), used


# ---------------------------------------------------------------------------
# the COO burst (the reference's backend="xla" lowering, core.solver)
# ---------------------------------------------------------------------------

def _coo_lib() -> ctypes.CDLL:
    lib = build.load("pdhg_coo.cu")
    if lib.pdhg_coo_max_blocks.argtypes is None:
        lib.pdhg_coo_burst_f32.argtypes = ([ctypes.c_int] * 11
                                           + [ctypes.c_void_p] * 26)
        lib.pdhg_coo_burst_f32.restype = ctypes.c_int
        lib.pdhg_coo_residual_f32.argtypes = ([ctypes.c_int] * 3
                                              + [ctypes.c_void_p] * 10)
        lib.pdhg_coo_residual_f32.restype = ctypes.c_int
        lib.pdhg_coo_add_chain.argtypes = ([ctypes.c_int]
                                           + [ctypes.c_void_p] * 3)
        lib.pdhg_coo_add_chain.restype = ctypes.c_int
        lib.pdhg_coo_max_blocks.argtypes = [ctypes.c_int]
        lib.pdhg_coo_max_blocks.restype = ctypes.c_int
        staged = lib.pdhg_coo_chunk_entries()
        if staged != pc.CHUNK_ENTRIES:
            raise RuntimeError(f"pdhg_coo.cu stages {staged} entries a warp, "
                               f"the plan's chunks up to "
                               f"{pc.CHUNK_ENTRIES}")
    return lib


def coo_add_chain(n: int, ab: torch.Tensor) -> torch.Tensor:
    """n dependent fp32 adds (a multiple of 8) in one thread on the card,
    adding ab[0] and ab[1] (a CUDA float32 tensor) in turn: the chain
    an output's sum is, timed for the COO burst's order bound.  Returns
    the sum, a 1-element tensor."""
    if n % 8 or ab.device.type != "cuda" or ab.dtype != _F32 \
            or ab.numel() < 2:
        raise ValueError("coo_add_chain takes n a multiple of 8 and a "
                         "CUDA float32 tensor of two addends")
    out = torch.empty(1, dtype=_F32, device=ab.device)
    with torch.cuda.device(ab.device):
        err = _coo_lib().pdhg_coo_add_chain(
            int(n), ab.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(ab.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"coo_add_chain launch failed: CUDA error {err}")
    return out


def coo_max_blocks(device=None) -> int:
    """Blocks of the COO burst kernel that fit on the card at once: the
    grid of one burst launch by default."""
    device = torch.device("cuda") if device is None else torch.device(device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return int(_coo_lib().pdhg_coo_max_blocks(index))


def _check_coo_args(named: dict, cols, rows) -> torch.device:
    """Validate a COO burst's operands (`named`: its vectors by name);
    returns their common device."""
    n, m = cols.n_out, rows.n_out
    lengths = {"c": n, "tau": n, "xmax": n, "keep_n": n, "x0": n, "q": m,
               "sig": m, "ub": m, "keep_m": m, "y0": m}
    want = {k: (torch.bool if k in ("ub", "keep_n", "keep_m") else _F32,
                lengths[k]) for k in named}
    nnz = cols.idx.shape[0]
    for side, d in (("cols", cols), ("rows", rows)):
        for field, dtype, length in (
                ("off", torch.int32, d.n_out + 1), ("idx", torch.int32, nnz),
                ("val", _F32, nnz), ("out", torch.int64, nnz),
                ("order", torch.int32, d.n_out),
                ("chunk", torch.int32, None)):
            named[f"{side}.{field}"] = getattr(d, field)
            want[f"{side}.{field}"] = (dtype, length)
        if not 0 <= d.n_block <= d.n_long <= d.n_out \
                or d.chunk.shape[0] < 1:
            raise ValueError(f"pdhg_coo_burst: the {side}' work order "
                             f"needs 0 <= n_block <= n_long <= {d.n_out} "
                             f"and a chunk list, got n_block {d.n_block}, "
                             f"n_long {d.n_long} and {d.chunk.shape[0]} "
                             f"chunk starts")
    devices = {t.device for t in named.values()}
    if len(devices) != 1:
        raise ValueError(f"pdhg_coo_burst operands span devices {devices}")
    for key, (dtype, length) in want.items():
        t = named[key]
        if (t.dtype != dtype or t.dim() != 1
                or (length is not None and t.shape[0] != length)):
            size = "" if length is None else f" of length {length}"
            raise ValueError(f"pdhg_coo_burst: {key} must be a 1-D {dtype} "
                             f"tensor{size}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"pdhg_coo_burst: {key} must be contiguous")
    return devices.pop()


def _coo_direction_args(d) -> tuple:
    return tuple(t.data_ptr() for t in (d.order, d.off, d.idx, d.val,
                                        d.chunk))


def pdhg_coo_burst(c, tau, xmax, q, sig, ub, keep_n, keep_m, cols, rows,
                   x0, y0, *, iters: int, _blocks: int = 0):
    """`iters` PDHG steps over a COO operator in the reference's COO order
    (kernels.pdhg_coo: g = c + K^T y and K xbar summed one entry at a
    time in COO entry order, x - tau g and y + sig r each rounded once),
    then the terminal residual.  `cols`/`rows` are the operator's two
    directions (pdhg_coo.coo_directions), `keep_n`/`keep_m` freeze
    coordinates (True = hold).  Returns (x, y, worst), float32.

    On CUDA tensors this is kernels/csrc/pdhg_coo.cu: one cooperative
    launch of pdhg_coo_burst_f32 on as many blocks as fit (`_blocks` > 0
    asks for that many; a launch the card refuses raises), then one
    launch of its residual entry; bitwise the plain version.  The
    kernel trusts the directions' work order (pdhg_coo.coo_plan: every
    chunk within CHUNK_OUTPUTS outputs and CHUNK_ENTRIES entries).  On CPU
    tensors it is the plain version, kernels.pdhg_coo.coo_update_burst.
    Raises under autograd: the kernel has no backward."""
    global PDHG_COO_LAUNCHES, PDHG_COO_RESIDUAL_LAUNCHES
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    _no_backward("pdhg_coo_burst", c=c, x0=x0, y0=y0)
    named = dict(c=c, tau=tau, xmax=xmax, q=q, sig=sig, ub=ub,
                 keep_n=keep_n, keep_m=keep_m, x0=x0, y0=y0)
    device = _check_coo_args(named, cols, rows)
    if device.type == "cpu":
        return pc.coo_update_burst(x0, y0, c, tau, xmax, q, sig, ub, keep_n,
                                   keep_m, cols, rows, iters=iters)
    if device.type != "cuda":
        raise ValueError(f"pdhg_coo_burst runs on cuda or cpu tensors, got "
                         f"{device}")
    lib = _coo_lib()
    n, m = cols.n_out, rows.n_out
    x_out, x_tmp, x_bar = (torch.empty(n, dtype=_F32, device=device)
                           for _ in range(3))
    y_out, y_tmp, worst = (torch.empty(m, dtype=_F32, device=device)
                           for _ in range(3))
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.pdhg_coo_burst_f32(
            n, m, int(iters), int(_blocks), index, cols.n_block,
            cols.n_long, cols.n_chunks, rows.n_block, rows.n_long,
            rows.n_chunks,
            *(t.data_ptr() for t in (c, tau, xmax, q, sig, ub, keep_n,
                                     keep_m)),
            *_coo_direction_args(cols), *_coo_direction_args(rows),
            *(t.data_ptr() for t in (x0, y0, x_out, y_out, x_tmp, y_tmp,
                                     x_bar)),
            stream)
        if err != 0:
            raise RuntimeError(f"pdhg_coo_burst cooperative launch failed: "
                               f"CUDA error {err}")
        PDHG_COO_LAUNCHES += 1
        err = lib.pdhg_coo_residual_f32(
            rows.n_block, rows.n_long, rows.n_chunks,
            *_coo_direction_args(rows), x_out.data_ptr(), q.data_ptr(),
            ub.data_ptr(), worst.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"pdhg_coo_burst: the residual launch "
                               f"failed: CUDA error {err}")
        PDHG_COO_RESIDUAL_LAUNCHES += 1
    return x_out, y_out, worst


def pdhg_coo_adaptive(c, tau, xmax, q, sig, ub, cols, rows, x0, y0, tols,
                      inst_n, inst_m, *, num_inst: int, chunk: int,
                      max_chunks: int):
    """Adaptive PDHG over a block-stacked COO batch: the reference's
    core.solver._pdhg_run_adaptive, a host loop of `chunk`-iteration
    bursts (pdhg_coo_burst: the kernel on CUDA tensors, the plain
    version on CPU tensors).  Before each burst the coordinates of every
    converged instance are frozen, and those of the dump segment
    `num_inst` (padded slots; `inst_n`/`inst_m` give each coordinate's
    instance id) always are; after it each instance's residual is the
    segment max of the burst's `worst` over `inst_m`, compared with
    `tols` in float32.  The loop ends after `max_chunks` bursts or when
    every instance is frozen (one host sync a chunk).  Returns (x, y,
    per-instance residuals, per-instance chunks used), the last two on
    the device; the segment maxima and masks are plain torch."""
    dev = x0.device
    inst_n = torch.as_tensor(inst_n, device=dev).long()
    inst_m = torch.as_tensor(inst_m, device=dev).long()
    tols = torch.as_tensor(tols, device=dev).to(_F32)
    if tols.shape != (num_inst,):
        raise ValueError(f"pdhg_coo_adaptive: tols must have shape "
                         f"({num_inst},), got {tuple(tols.shape)}")
    always = torch.ones(1, dtype=torch.bool, device=dev)

    def residuals(worst):
        return _segment_max(worst, inst_m, num_inst + 1)[:num_inst]

    x, y, worst = x0, y0, None
    frozen = torch.zeros(num_inst, dtype=torch.bool, device=dev)
    used = torch.zeros(num_inst, dtype=torch.int32, device=dev)
    k = 0
    while k < max_chunks and not bool(frozen.all()):
        frozen_ext = torch.cat([frozen, always])
        x, y, worst = pdhg_coo_burst(c, tau, xmax, q, sig, ub,
                                     frozen_ext[inst_n], frozen_ext[inst_m],
                                     cols, rows, x, y, iters=chunk)
        used = torch.where(frozen, used, k + 1)
        frozen = frozen | (residuals(worst) <= tols)
        k += 1
    if worst is None:          # no chunk ran: the residual of the start
        hold = torch.ones(x0.shape[0] + y0.shape[0], dtype=torch.bool,
                          device=dev)
        x, y, worst = pdhg_coo_burst(c, tau, xmax, q, sig, ub,
                                     hold[:x0.shape[0]], hold[x0.shape[0]:],
                                     cols, rows, x0, y0, iters=0)
    return x, y, residuals(worst), used


# ---------------------------------------------------------------------------
# flash attention (the prefill's attention, models.attention impl="kernel")
# ---------------------------------------------------------------------------

_FA_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _flash_fn():
    lib = build.load("flash_attention.cu")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 9 + [ctypes.c_float] * 2
                       + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5)
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    softcap: float = 0.0) -> torch.Tensor:
    """Forward attention.  q: (B,S,H,hd); k, v: (B,T,Hkv,hd) with
    H % Hkv == 0, all contiguous, one dtype (float32 or bfloat16), hd up
    to 256.  Returns (B,S,H,hd) in q's dtype.

    `window` None or 0 means no sliding window; the softmax scale is
    1/sqrt(hd).  A head dim that is not a multiple of 8 is zero-padded to
    the next one and the output sliced back, the scale kept from the real
    hd, as the reference's wrapper pads to 128 lanes (zero columns add
    nothing to q.k and give zero output columns).  On CUDA tensors this
    is the kernel of kernels/csrc/flash_attention.cu, chosen by dtype:
    bfloat16 runs the wgmma / TMA kernel on the tiles of
    kernels.flash_attention.tile_plan, float32 the SIMT kernel on those
    of ::simt_plan; an operand that does not start on a 16-byte boundary
    (a contiguous view into a larger tensor) is copied first.  On CPU
    tensors it is the plain version,
    kernels.flash_attention.flash_attention_plain.
    Raises RuntimeError under autograd: there is no backward.

    DTensor q, k, v split alike over batch (dim 0) and heads (dim 2)
    only run the kernel on each rank's shard (GQA maps a rank's query
    heads to its own kv heads when both head counts split evenly); the
    result is laid out as q."""
    _no_backward("flash_attention", q=q, k=k, v=v)
    heads = {"batch": 0, "heads": 2}
    placed = _shard_layout("flash_attention", dict(q=q, k=k, v=v),
                           dict(q=heads, k=heads, v=heads))
    if placed is not None:
        out = flash_attention(q.to_local(), k.to_local(), v.to_local(),
                              causal=causal, window=window, softcap=softcap)
        return _as_placed(out, *placed, heads)
    named = dict(q=q, k=k, v=v)
    for name, t in named.items():
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D, got "
                             f"shape {tuple(t.shape)}")
        if t.dtype not in _FA_DTYPES:
            raise ValueError(f"flash_attention: {name} must be float32 or "
                             f"bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    if len({t.dtype for t in named.values()}) != 1:
        raise ValueError("flash_attention: q, k and v must share one dtype")
    devices = {t.device for t in named.values()}
    if len(devices) != 1:
        raise ValueError(f"flash_attention operands span devices {devices}")
    B, _, H, hd = q.shape
    Hkv = k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or v.shape != k.shape:
        raise ValueError(f"flash_attention: k and v must be ({B}, T, Hkv, "
                         f"{hd}), got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention: {H} query heads do not divide "
                         f"into {Hkv} kv heads")
    if not 0 < hd <= 256:
        raise ValueError(f"flash_attention: head dim {hd} must be from 1 "
                         f"up to 256")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got "
                         f"{device}")
    window = int(window or 0)
    scale = 1.0 / hd ** 0.5
    if hd % 8 == 0:
        return _attend(q, k, v, causal, window, softcap, scale)
    pad = (0, 8 - hd % 8)
    out = _attend(*(torch.nn.functional.pad(t, pad) for t in (q, k, v)),
                  causal, window, softcap, scale)
    return out[..., :hd].contiguous()


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """`t` itself when its data starts on a 16-byte boundary, else a
    fresh contiguous copy of it (a new allocation: the caching
    allocator's blocks start on 512-byte boundaries).  The attention
    kernel's TMA maps and 16-byte copies need such a start; a contiguous
    view into a larger tensor may lack it."""
    return t if t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format)


def _attend(q, k, v, causal, window, softcap, scale):
    """flash_attention on checked operands whose head dim is a multiple
    of 8: the plain version on the CPU, the kernel on the card (an
    operand off a 16-byte boundary copied first, _aligned16)."""
    global FLASH_ATTENTION_LAUNCHES
    if q.device.type == "cpu":
        return fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, softcap=softcap,
                                        scale=scale)
    q, k, v = (_aligned16(t) for t in (q, k, v))
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise RuntimeError("flash_attention: an operand is off a 16-byte "
                           "boundary after its copy (an internal error)")
    B, S, H, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    p = (fa.tile_plan if q.dtype == torch.bfloat16 else fa.simt_plan)(hd)
    plan = (p.hdp, p.bq, p.bkv, p.stages, p.smem)
    fn = _flash_fn()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_FA_DTYPES[q.dtype], B, S, T, H, Hkv, hd, int(causal),
                 window, float(softcap), scale, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), stream, *plan)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    FLASH_ATTENTION_LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# RG-LRU scan (the recurrent layer's prefill, models.rglru impl="kernel")
# ---------------------------------------------------------------------------

# the scan kernel's ring (kernels/csrc/rglru_scan.cu): a group of
# SCAN_GROUP features a block, SCAN_STAGES slots of `steps` time steps of
# a and b in shared memory, SCAN_STAGES - 1 of them in flight
SCAN_GROUP = 32
SCAN_STAGES = 4
# bytes of a and b in flight over the card that the stage length aims at:
# about the card's memory rate times its latency under load (3.35 TB/s x
# ~1.2 us); more only queues (chip_smoke.py phase 18 times the neighbours)
SCAN_IN_FLIGHT = 4 << 20
# the most blocks an SM holds at once on Hopper
_SM_BLOCKS = 32
# device index -> (SMs, shared bytes an SM, bytes a block may ask for,
# bytes reserved a block)
_SCAN_LIMITS: dict = {}


def _scan_lib() -> ctypes.CDLL:
    lib = build.load("rglru_scan.cu")
    if lib.rglru_scan_f32.argtypes is None:
        lib.rglru_scan_f32.argtypes = ([ctypes.c_int] * 4
                                       + [ctypes.c_void_p] * 6)
        lib.rglru_scan_f32.restype = ctypes.c_int
        lib.rglru_scan_limits.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.rglru_scan_limits.restype = ctypes.c_int
        lib.rglru_scan_occupancy.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.rglru_scan_occupancy.restype = ctypes.c_int
    return lib


def scan_ring_bytes(steps: int) -> int:
    """Shared memory a block of the scan kernel asks for at stage length
    `steps`: SCAN_STAGES slots of a and b, SCAN_GROUP floats a step."""
    return SCAN_STAGES * 2 * steps * SCAN_GROUP * 4


def scan_steps(B: int, S: int, R: int, sms: int, smem_sm: int,
               smem_block: int, reserved: int) -> int:
    """T, the time steps of a stage of the scan kernel's ring, for a launch
    on (B, S, R) on a card of `sms` SMs with `smem_sm` bytes of shared
    memory an SM, `smem_block` a block may ask for and `reserved` bytes it
    reserves a block: a multiple of 8, at least 8, that puts about
    SCAN_IN_FLIGHT bytes in flight over the launch's groups, keeps every
    group resident at once (ceil(groups / sms) blocks an SM, at most 32)
    and is no longer than S rounded up to 8.  T changes no bit of the
    result."""
    groups = B * -(-R // SCAN_GROUP)
    per_sm = min(_SM_BLOCKS, max(1, -(-groups // sms)))
    fit = min(smem_block, smem_sm // per_sm - reserved) // scan_ring_bytes(1)
    step_bytes = 2 * SCAN_GROUP * 4                 # a_t and b_t of a group
    want = SCAN_IN_FLIGHT // (groups * (SCAN_STAGES - 1) * step_bytes)
    return max(8, min(fit, want, -(-max(S, 1) // 8) * 8) // 8 * 8)


def _scan_limits(device: torch.device) -> tuple:
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    if index not in _SCAN_LIMITS:
        out = (ctypes.c_int * 4)()
        err = _scan_lib().rglru_scan_limits(index, out)
        if err != 0:
            raise RuntimeError(f"rglru: reading the card's limits failed: "
                               f"CUDA error {err}")
        _SCAN_LIMITS[index] = tuple(out)
    return _SCAN_LIMITS[index]


def rglru_launch_config(B: int, S: int, R: int, device=None) -> dict:
    """What the scan kernel's launch on (B, S, R) uses on the card: its
    groups (blocks), stage length, shared memory a block, registers and
    local (spill) bytes a thread, and the blocks that fit on an SM, for
    the 16-byte copy kernel (the one the model's fresh a and b take)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    steps = scan_steps(B, S, R, *_scan_limits(device))
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        err = _scan_lib().rglru_scan_occupancy(steps, out)
    if err != 0:
        raise RuntimeError(f"rglru: occupancy query failed: CUDA error {err}")
    return {"groups": B * -(-R // SCAN_GROUP), "steps": steps,
            "stages": SCAN_STAGES, "smem_bytes": out[1],
            "registers": out[0], "blocks_per_sm": out[2],
            "local_bytes": out[3]}


def rglru(a, b, h0=None):
    """The linear recurrence h_t = a_t * h_{t-1} + b_t over axis 1.
    a, b: (B, S, R) float32, contiguous; h0: (B, R) float32, contiguous,
    or None (zeros).  Returns (h (B, S, R), h_last (B, R)).

    On CUDA tensors this is the kernel of kernels/csrc/rglru_scan.cu; on
    CPU tensors its plain version, kernels.rglru_scan.rglru_scan_plain.
    The two agree bitwise.  Raises RuntimeError under autograd: there is
    no backward.

    DTensor a, b (and h0) split alike over batch and features (dims 0
    and 2 of a and b, 0 and 1 of h0) only run the kernel on each rank's
    shard; h and h_last are laid out as a and h0."""
    _no_backward("rglru", a=a, b=b, h0=h0)
    seq, state = {"batch": 0, "features": 2}, {"batch": 0, "features": 1}
    placed = _shard_layout("rglru", dict(a=a, b=b, h0=h0),
                           dict(a=seq, b=seq, h0=state))
    if placed is not None:
        h, h_last = rglru(a.to_local(), b.to_local(),
                          None if h0 is None else h0.to_local())
        return _as_placed(h, *placed, seq), _as_placed(h_last, *placed,
                                                       state)
    named = dict(a=a, b=b) if h0 is None else dict(a=a, b=b, h0=h0)
    for name, t in named.items():
        if t.dtype != _F32:
            raise ValueError(f"rglru: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"rglru: {name} must be contiguous")
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"rglru: a and b must share one (B, S, R) shape, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    B, S, R = a.shape
    if h0 is not None and h0.shape != (B, R):
        raise ValueError(f"rglru: h0 must have shape ({B}, {R}), got "
                         f"{tuple(h0.shape)}")
    devices = {t.device for t in named.values()}
    if len(devices) != 1:
        raise ValueError(f"rglru operands span devices {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return rs.rglru_scan_plain(a, b, h0)
    if device.type != "cuda":
        raise ValueError(f"rglru runs on cuda or cpu tensors, got {device}")
    return _rglru_kernel(a, b, h0, scan_steps(B, S, R, *_scan_limits(device)))


def _rglru_kernel(a, b, h0, steps: int):
    """One launch of the scan kernel on checked CUDA operands, its ring's
    stages `steps` long; raises on a non-zero CUDA error (a shared-memory
    request the card refuses among them)."""
    global RGLRU_SCAN_LAUNCHES
    B, S, R = a.shape
    h = torch.empty_like(a)
    h_last = torch.empty((B, R), dtype=_F32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _scan_lib().rglru_scan_f32(
            B, S, R, steps, a.data_ptr(), b.data_ptr(),
            None if h0 is None else h0.data_ptr(), h.data_ptr(),
            h_last.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"rglru kernel launch failed: CUDA error {err}")
    RGLRU_SCAN_LAUNCHES += 1
    return h, h_last
