"""The cost walk of a cell's program (counterpart of
repro.launch.hlo_cost): the port has no HLO, so the walk runs the
program's `fn` on fake tensors (torch's FakeTensorMode: shapes and
dtypes, no storage) on a fake card, under use_mesh_rules(mesh,
program.rules), and logs every aten op a counting TorchDispatchMode
sees. Loops execute rather than unroll into a graph, so a 300-iteration
solve or a 61-layer stack is counted as often as it runs; autograd's
backward ops pass through the same mode. Nothing is allocated and no
card is needed: the card's route, kernels included, traces on a machine
without one.

Conventions kept from hlo_cost, carried over to aten ops:
  flops   the matmul class only (mm, addmm, bmm, baddbmm, _int_mm,
          convolution, the SDPA ops), by torch.utils.flop_counter's
          formulas (2 x result elements x contracted size), per dtype
          bucket of roofline.PEAK_FLOPS; elementwise work and
          transcendentals are left out, as JAX leaves them out.
  bytes   a view costs nothing (and is not logged: it shares its
          input's storage); an allocation (empty) nothing; an
          elementwise op (torch's pointwise tag, casts, fills, cat,
          pad) its result only, as XLA fuses it into its producer;
          index / index_select / embedding / gather the rows they
          touch, 2 x result + indices, not the table; index_put /
          index_copy / scatter / index_add 2 x the update; copy_ its
          source and destination; every other op its operands plus its
          result.
  kernels each of the nine CUDA kernels' wrappers (kernels/fused_rank.py,
          knn_topk.py, embedding_bag.py) is swapped, for the trace only,
          for a twin that checks the inputs as the wrapper does
          (the card's shape limits included), allocates the kernel's
          outputs and records one kernel op with its work formula's
          bytes, fp32 operations and dot operations
          (launch/roofline.py). Outside a trace the wrappers are
          untouched: the served path gains no host work. During a trace
          `kernels.build.launch` raises on the tracing thread, so a
          wrapper the swap missed cannot launch on fake pointers. The
          swaps and the fake card are the tracing thread's alone: any
          other thread calls the real wrappers meanwhile.
  reads   which argument leaves feed the outputs (or are written in
          place, or read on the host): a reverse pass over the log from the outputs, as
          make_fx and dead-code elimination would find them; JAX's
          jit (keep_unused=False) drops every other leaf.
  data    a shape-only tensor has no values: a boolean mask keeps every
          element (the MoE's kept assignments: all of them), a host
          read (.item()) reads zero (decode's cache position, whose cost
          does not depend on it), bincount gives its minlength bins.
  live    each storage the program makes is live from the op that
          makes it to its last use; the peak of their sum is the
          walk's temp bytes.

Per device. A program that runs shard bodies (distributed.topk's
map_shards and each_block: the paper cells, moe_apply_shmap,
compressed_psum, the partitioned GNN step and dense LM programs) is
costed as one body (the
largest mesh position's) plus the merge (gather_merge_top_k, on the
merging device) plus the rest of the program over the device count; the
bytes each body hands to the merging device, and the bytes each of the
mesh collectives (distributed.topk's all_gather_rows,
reduce_scatter_rows, psum) moves into a shard, are counted by mesh
position, since a virtual mesh has one device. A body's backward is the
body's: each autograd node a body makes is tagged with its region, and
the ops autograd runs for a node (a checkpoint's recomputation
included) are costed in that region. A global program (the recsys
builds and the MoE LMs) is costed as the whole walk over the mesh's
device count, JAX's own fallback
(roofline.py's docstring), and says "partitioned": false.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import math
import sys
import threading
from dataclasses import dataclass, field

import torch
from torch.fx.experimental import _config as fx_config
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.launch import roofline

FAKE_CARD = torch.device("meta")

KERNELS = ("rank_audited", "knn_rank_audited", "linear_rank_audited",
           "knn_lambda", "knn_lambda_quant", "knn_rank_audited_quant",
           "fused_rank", "knn_topk", "embedding_bag")

# ops that make no new data (a host read's value is no device data)
_VIEWLIKE = {"_unsafe_view", "alias", "detach", "lift_fresh", "set_",
             "_local_scalar_dense"}
_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided", "resize_"}
# ops that take a tensor only for its shape, dtype and device
_SHAPE_ONLY = {"empty_like", "zeros_like", "ones_like", "full_like",
               "rand_like", "randn_like", "new_empty", "new_zeros",
               "new_ones", "new_full", "new_empty_strided",
               "randint_like"}
_ELEMENTWISE = {"_to_copy", "cat", "constant_pad_nd", "zeros", "ones",
                "full", "fill", "fill_", "zero_", "arange", "scalar_tensor",
                "where", "masked_fill", "masked_fill_", "flip", "repeat",
                "tril", "triu", "expand_copy", "zeros_like", "ones_like",
                "full_like", "new_zeros", "new_ones", "new_full", "rand",
                "randn", "rand_like", "randn_like", "uniform_", "normal_",
                "bernoulli", "bernoulli_", "randint", "randint_like",
                "randperm", "linspace", "stack", "pad", "roll", "exponential_"}
_GATHER = {"index", "index_select", "embedding", "gather", "take",
           "_unsafe_index"}
_SCATTER = {"index_put", "index_put_", "_index_put_impl_", "index_copy",
            "index_copy_", "scatter", "scatter_", "scatter_add",
            "scatter_add_", "scatter_reduce", "scatter_reduce_",
            "index_add", "index_add_", "_unsafe_index_put",
            "masked_scatter", "masked_scatter_", "index_fill",
            "index_fill_", "select_scatter", "slice_scatter",
            "diagonal_scatter", "embedding_dense_backward"}
_SORT = {"sort", "topk", "argsort", "kthvalue", "msort", "median",
         "mode", "unique", "_unique2", "searchsorted", "cumsum", "cumprod"}
_COPY = {"copy_", "clone", "contiguous"}
_MATMUL = {"mm", "addmm", "bmm", "baddbmm", "_int_mm", "convolution",
           "_convolution", "convolution_backward", "_scaled_mm",
           "_scaled_dot_product_flash_attention",
           "_scaled_dot_product_efficient_attention",
           "_scaled_dot_product_cudnn_attention",
           "_scaled_dot_product_flash_attention_backward",
           "_scaled_dot_product_efficient_attention_backward",
           "_scaled_dot_product_cudnn_attention_backward",
           "_flash_attention_forward", "_flash_attention_backward",
           "_efficient_attention_forward", "_efficient_attention_backward"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass(slots=True)
class Op:
    """One logged op: its census category and name, the storages it
    reads and writes (ids), its bytes and flops, and where it ran (None:
    the program's global part; ("body", pos); ("merge",))."""
    cat: str
    name: str
    ins: tuple
    outs: tuple
    nbytes: float
    flops: dict | None = None
    region: tuple | None = None
    handed: float = 0.0        # bytes a shard body hands to the merge,
    axes: tuple = ()           # or a collective moves over these axes

    @property
    def weight(self) -> int:
        """The mesh positions whose bodies ran this op: 1, or under a
        one-body walk the blocks its body stood for."""
        r = self.region
        return r[2] if r is not None and len(r) > 2 else 1


@dataclass
class Walk:
    """The log of one traced run of a program, and what the analyses
    need beside it."""
    ops: list = field(default_factory=list)
    storage_bytes: list = field(default_factory=list)
    made_at: dict = field(default_factory=dict)     # sid -> op index
    arg_sids: dict = field(default_factory=dict)    # (i, path) -> sid
    arg_specs: dict = field(default_factory=dict)   # (i, path) -> ArgSpec
    out_sids: tuple = ()
    written: set = field(default_factory=set)       # sids written by ops
    host_read: set = field(default_factory=set)     # sids read on the host
    # byte ranges of the argument storages read and written, and the
    # bytes gathers touch of them
    arg_reads: dict = field(default_factory=dict)
    arg_writes: dict = field(default_factory=dict)
    arg_partial: dict = field(default_factory=dict)
    devices: int = 1
    mesh_shape: dict = field(default_factory=dict)
    _read: frozenset | None = None

    @property
    def partitioned(self) -> bool:
        return any(op.region and op.region[0] == "body" for op in self.ops)

    def read_leaves(self) -> set:
        """(arg index, path) of every argument leaf that feeds an output
        or is written in place: the reverse pass over the log."""
        if self._read is None:
            self._read = frozenset(self._reverse_pass())
        return self._read

    def _reverse_pass(self):
        arg_of = {}
        for key, sid in self.arg_sids.items():
            arg_of.setdefault(sid, []).append(key)
        needed = set(self.out_sids) | self.host_read | (
            self.written & set(arg_of))
        for op in reversed(self.ops):
            if any(o in needed for o in op.outs):
                needed.update(op.ins)
        return {k for sid in needed for k in arg_of.get(sid, ())}

    def read_bytes(self) -> dict:
        """Per read argument leaf, the bytes its program's ops touch of
        it at least once (global): the union of the byte ranges its
        non-view ops read, plus the rows its gathers (and the kernels'
        partial reads) touch, at most the leaf."""
        return {k: min(self.storage_bytes[self.arg_sids[k]],
                       _union(self.arg_reads.get(self.arg_sids[k], ()))
                       + self.arg_partial.get(self.arg_sids[k], 0))
                for k in self.read_leaves()}

    def written_bytes(self) -> int:
        """Bytes of the outputs written at least once: an output the
        program made, whole; an argument it updated in place, the union
        of the ranges its ops wrote."""
        args = set(self.arg_sids.values())
        return sum(_union(self.arg_writes.get(s, ())) if s in args
                   else self.storage_bytes[s] for s in set(self.out_sids))

    def min_bytes(self) -> int:
        """The bytes the program must move at least (global): every
        argument byte it reads, read once, and every output byte,
        written once."""
        return sum(self.read_bytes().values()) + self.written_bytes()

    def min_block_bytes(self) -> int:
        """The bytes a partitioned program's first position must move at
        least: the blocks of the argument leaves it reads (each read
        once) and the outputs its bodies or the global part make (each
        written once); an argument written in place adds nothing to
        its read block."""
        args = set(self.arg_sids.values())
        return sum(block_bytes(self.arg_specs[k])
                   for k in self.read_leaves()) + sum(
            self.storage_bytes[s] for s in set(self.out_sids)
            if s not in args and not _made_elsewhere(self, s))

    def peak_live_bytes(self, *, per_position: bool = False) -> int:
        """The peak, over the log, of the storages the program made
        (neither arguments nor outputs) that are live: from the op that
        makes one to its last use. With `per_position`, each storage
        belongs to the mesh position whose body made it (the global
        part's and the merge's to the first position), its last use is
        its own position's (another body's read of it is that body's
        collective, which a virtual mesh runs later), and the peak is
        the largest position's."""
        internal = set(self.made_at) - set(self.arg_sids.values()) \
            - set(self.out_sids)

        def owner_of(r):
            if not per_position:
                return None
            return r[1] if r and r[0] == "body" and any(r[1]) else None
        owner = {s: owner_of(self.ops[self.made_at[s]].region)
                 if self.made_at[s] < len(self.ops) else None
                 for s in internal}
        last = {}
        for i, op in enumerate(self.ops):
            here = owner_of(op.region)
            for s in op.ins + op.outs:
                if s in internal and owner[s] == here:
                    last[s] = i
        events: dict = {}
        for s in internal:
            at = self.made_at[s]
            ev = events.setdefault(owner[s], [])
            ev.append((at, self.storage_bytes[s]))
            ev.append((last.get(s, at) + 1, -self.storage_bytes[s]))
        peak = 0
        for ev in events.values():
            live = 0
            for _, d in sorted(ev, key=lambda x: (x[0], x[1])):
                live += d
                peak = max(peak, live)
        return peak


def block_bytes(spec) -> int:
    """One device's block of an ArgSpec: its shape over the mesh axes of
    its sharding (none: the whole leaf)."""
    from repro_torch.launch.mesh import axis_size, spec_entries

    item = spec.dtype.itemsize
    sh = spec.sharding
    if sh is None:
        return math.prod(spec.shape) * item
    entries = spec_entries(sh.spec, len(spec.shape))
    return math.prod(-(-n // axis_size(sh.mesh, axes))
                     for n, axes in zip(spec.shape, entries)) * item


def _made_elsewhere(walk: Walk, sid: int) -> bool:
    """Whether a storage was made in the body of a mesh position other
    than the first (a block of a partitioned output that another device
    holds)."""
    at = walk.made_at.get(sid)
    if at is None or at >= len(walk.ops):
        return False
    r = walk.ops[at].region
    return bool(r and r[0] == "body" and any(r[1]))


class _CostMode(TorchDispatchMode):
    """Logs each aten op into a Walk: storages by id, bytes and flops by
    the conventions of the module's docstring."""

    def __init__(self, walk: Walk):
        super().__init__()
        self.walk = walk
        self._ids: dict = {}
        self.args: set = set()          # the argument storages' ids
        self.results: dict = {}         # _shapes_of's kept result shapes
        self.region = None
        self.lock = threading.Lock()

    def sid(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = st._cdata
        hit = self._ids.get(key)
        if hit is not None and not hit[1].expired():
            return hit[0]
        sid = len(self.walk.storage_bytes)
        self._ids[key] = (sid, StorageWeakRef(st))
        self.walk.storage_bytes.append(st.nbytes())
        self.walk.made_at[sid] = len(self.walk.ops)
        return sid

    def log(self, cat, name, ins, outs, nbytes, flops=None, touched=None):
        walk = self.walk
        region = self.region if self.region is not None else _node_region()
        with self.lock:
            in_ids = [self.sid(t) for t in ins]
            out_ids = [self.sid(t) for t in outs]
            if cat != "view" and self.args & (set(in_ids) | set(out_ids)):
                self._arg_ranges(name, ins, in_ids, outs, out_ids, touched)
            in_ids = tuple(dict.fromkeys(in_ids))
            out_ids = tuple(dict.fromkeys(out_ids))
            walk.written.update(s for s in out_ids if s in in_ids
                                and cat != "view")
            walk.ops.append(Op(cat, name, in_ids, out_ids, float(nbytes),
                               flops, region))

    def _arg_ranges(self, name, ins, in_ids, outs, out_ids, touched):
        """Note the byte ranges an op reads and writes of argument
        storages (a pure write's destination is not read)."""
        walk = self.walk
        part = {id(t): b for t, b in touched or ()}
        for j, (t, s) in enumerate(zip(ins, in_ids)):
            if s not in self.args or (j == 0 and name in _WRITE_ONLY):
                continue
            if id(t) in part:
                walk.arg_partial[s] = walk.arg_partial.get(s, 0) + part[id(t)]
            else:
                walk.arg_reads.setdefault(s, []).append(_span(t))
        for t, s in zip(outs, out_ids):
            if s in self.args:
                walk.arg_writes.setdefault(s, []).append(_span(t))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.is_view:
            return func(*args, **kwargs)    # the same storage: no cost
        name = func.__name__.split(".")[0]
        ins = _flat_tensors(args) + (_flat_tensors(kwargs.values())
                                     if kwargs else [])
        if not all(t.is_meta for t in ins):
            out = func(*args, **kwargs)     # real values: a host constant
        elif name in _META_TWINS:
            out = _META_TWINS[name](*args, **kwargs)
        else:
            out = _shapes_of(func, args, kwargs, self.results)
        outs = _flat_tensors(out)
        cat, nbytes, flops, touched = _cost(func, name, args, kwargs, ins,
                                            outs, out)
        if name in _SHAPE_ONLY:
            ins = []
        self.log(cat, name, ins, outs, nbytes, flops, touched)
        if name == "_local_scalar_dense":
            # the value steers the host: whatever follows depends on it
            self.walk.host_read.update(self.sid(t) for t in ins)
        return out


def _node_region():
    """The region of the autograd node whose backward is running (None
    outside a backward, or for a node no shard body made)."""
    node = torch._C._current_autograd_node()
    return None if node is None else node.metadata.get("region")


def _next_sequence_nr() -> int:
    """The sequence number autograd gives the next node made on this
    thread (nodes are numbered in the order they are made)."""
    return torch._C._autograd._get_sequence_nr()


def _tag_nodes(out, region, made: range):
    """Tag with `region` the autograd nodes that made `out` and whose
    sequence numbers lie in `made`: the nodes a body made, reached back
    from its outputs. The walk stops at a node made before the body
    (global work, another body, a collective, a leaf's
    AccumulateGrad), whose backward is not the body's."""
    todo = [t.grad_fn for t in _tensors(out) if t.grad_fn is not None]
    while todo:
        node = todo.pop()
        if (node is None or "region" in node.metadata
                or node._sequence_nr() not in made):
            continue
        node.metadata["region"] = region
        todo.extend(fn for fn, _ in node.next_functions)


def _flat_tensors(obj) -> list:
    """The tensors of an op's arguments or results: a tensor, or an
    iterable of tensors, other values and lists or tuples of them."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    out = []
    if not isinstance(obj, (list, tuple, type({}.values()))):
        return out                  # a host value (.item()'s number)
    for x in obj:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(_flat_tensors(x))
    return out


# A functional op's results on shape-only tensors depend on their
# shapes, strides, dtypes and devices and its other arguments alone: the
# shapes of the results of one such call are kept (for one trace), and a
# repeat (a loop's next trip) makes fresh results of them without
# running the meta kernel again (several of which are Python and cost a
# fraction of a millisecond).
_FUNCTIONAL: dict = {}


def _functional(func) -> bool:
    hit = _FUNCTIONAL.get(func)
    if hit is None:
        sch = func._schema
        hit = _FUNCTIONAL[func] = (
            not func.is_view and not sch.is_mutable
            and all(r.alias_info is None for r in sch.returns)
            and all(str(r.type) == "Tensor" for r in sch.returns)
            and len(sch.returns) > 0)
    return hit


def _key_of(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype, x.device)
    if isinstance(x, (list, tuple)):
        return tuple(_key_of(v) for v in x)
    return x


def _shapes_of(func, args, kwargs, results: dict):
    """func(*args, **kwargs) on shape-only tensors, by the kept shapes
    where a functional op was called on the same shapes before."""
    if not _functional(func):
        return func(*args, **kwargs)
    try:
        key = (func, _key_of(args), tuple(sorted(
            (k, _key_of(v)) for k, v in kwargs.items())))
        hash(key)
    except TypeError:
        return func(*args, **kwargs)
    shapes = results.get(key)
    if shapes is None:
        out = func(*args, **kwargs)
        res = out if isinstance(out, tuple) else (out,)
        results[key] = (isinstance(out, tuple), tuple(
            (tuple(t.shape), t.stride(), t.dtype, t.device) for t in res))
        return out
    multi, specs = shapes
    res = tuple(torch.empty_strided(sh, st, dtype=dt, device=dev)
                for sh, st, dt, dev in specs)
    return res if multi else res[0]


_WRITE_ONLY = {"copy_", "fill_", "zero_", "index_put_", "index_copy_",
               "scatter_", "_index_put_impl_", "masked_fill_", "normal_",
               "uniform_"}


def _span(t: torch.Tensor) -> tuple:
    """(lo, hi, bytes, key) of a tensor (view): the byte range [lo, hi)
    of its storage it spans, the bytes it holds and what identifies the
    view (the same view read twice counts once)."""
    item = t.element_size()
    lo = t.storage_offset()
    n = t.numel()
    hi = lo + sum((d - 1) * abs(st) for d, st in zip(t.shape, t.stride())) \
        + 1 if n else lo
    return (lo * item, hi * item, n * item,
            (lo, tuple(t.shape), t.stride(), item))


def _union(spans) -> int:
    """Bytes a set of views covers: spans that overlap form a group,
    which counts the lesser of its extent and the bytes of its distinct
    views (a strided view holds fewer bytes than it spans)."""
    total, group = 0, None
    for lo, hi, nb, key in sorted(set(spans)):
        if group is None or lo >= group[1]:
            if group:
                total += min(group[1] - group[0], group[2])
            group = [lo, hi, nb]
        else:
            group[1] = max(group[1], hi)
            group[2] += nb
    if group:
        total += min(group[1] - group[0], group[2])
    return total


def _item(t):
    """A host read of a shape-only value reads zero: the one the programs
    make is decode's cache position, whose cost does not depend on it."""
    return False if t.dtype == torch.bool else (
        0.0 if t.dtype.is_floating_point else 0)


def _bincount(x, weights=None, minlength=0):
    """bincount's shape on the meta device, which has no kernel for it:
    minlength bins (the MoE counts expert ids below it)."""
    dtype = torch.int64 if weights is None else weights.dtype
    return torch.zeros((max(int(minlength), 1),), dtype=dtype,
                       device=x.device)


_META_TWINS = {"_local_scalar_dense": _item, "bincount": _bincount}


def _cost(func, name, args, kwargs, ins, outs, out):
    """(category, bytes, {dtype: flops} or None, [(tensor, bytes
    touched)] or None) of one aten op."""
    res = sum(_nbytes(t) for t in outs)
    if func.is_view or name in _VIEWLIKE:
        return "view", 0, None, None
    if name in _ALLOC:
        return "alloc", 0, None, None
    if name in _MATMUL:
        flops = 0.0
        if func.overloadpacket in flop_registry:
            flops = flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out)
        elif name == "_int_mm":
            (m, k), n = args[0].shape, args[1].shape[1]
            flops = 2 * m * n * k
        key = roofline.dtype_key(ins[0].dtype if ins else outs[0].dtype)
        return ("matmul", res + sum(_nbytes(t) for t in ins),
                {key: float(flops)}, None)
    if name in _GATHER:
        idx = sum(_nbytes(t) for t in ins[1:])
        return "index", 2 * res + idx, None, [(ins[0], res)]
    if name in _SCATTER:
        return "scatter", 2 * _update_bytes(name, args, ins), None, None
    if name in _COPY:
        src = ins[-1] if name == "copy_" else ins[0]
        return "copy", _nbytes(src) + res, None, None
    if name in _SORT:
        return "sort", res + sum(_nbytes(t) for t in ins), None, None
    if name in _ELEMENTWISE or torch.Tag.pointwise in func.tags:
        return "elementwise", res, None, None
    return "other", res + sum(_nbytes(t) for t in ins), None, None


def _update_bytes(name, args, ins) -> int:
    """Bytes an indexed write updates: the values / source / src
    operand, or for an index_put with a broadcast value the indexed
    region's."""
    dst = ins[0]
    if name.startswith(("index_put", "_index_put", "_unsafe_index_put")):
        idx = [t for t in args[1] if t is not None]
        vals = args[2]
        n_idx = math.prod(torch.broadcast_shapes(*(t.shape for t in idx))) \
            if idx else 1
        rest = math.prod(dst.shape[len(args[1]):])
        region = n_idx * rest * dst.element_size()
        return max(region, _nbytes(vals)) if isinstance(
            vals, torch.Tensor) else region
    if name.startswith(("index_copy", "index_add")):
        return _nbytes(args[3])
    if name.startswith("scatter"):
        src = args[3] if len(args) > 3 else None
        if isinstance(src, torch.Tensor):
            return _nbytes(src)
        return args[2].numel() * dst.element_size()
    if name == "embedding_dense_backward":
        return _nbytes(args[0])
    return ins[-1].numel() * dst.element_size() if len(ins) > 1 else 0


# -- the kernels under a trace ----------------------------------------------

def _kernel_op(cm, name, ins, outs, work, mode=None, touched=None):
    """Record one kernel op in cm's walk: work = (bytes, fp32 ops[, dot
    ops]) by the kernel's formula."""
    flops = {"fp32": float(work[1])}
    if len(work) > 2:
        flops[mode] = flops.get(mode, 0.0) + float(work[2])
    cm.log(name, name, [t for t in ins if t is not None], outs, work[0],
           flops, touched)


def _fake_rank(cm, name):
    from repro_torch.kernels.fused_rank import (
        check_rank_args,
        check_rank_kernel,
    )

    def fused_rank_cuda(u, a, lam, *, m2, eps=1e-4, device=None):
        dev = FAKE_CARD
        n, m1, K = check_rank_args(u, a, None, lam, None, m2, dev)
        check_rank_kernel(K, m2)
        outs = (torch.empty((n, m2), device=dev),
                torch.empty((n, m2), dtype=torch.int32, device=dev))
        _kernel_op(cm, name, (u, a, lam), outs,
                   roofline.fused_work(n, m1, K, m2))
        return outs

    def rank_audited_cuda(u, a, b, lam, gamma, *, m2, eps=1e-4, tol=None,
                          device=None):
        dev = FAKE_CARD
        n, m1, K = check_rank_args(u, a, b, lam, gamma, m2, dev)
        check_rank_kernel(K, m2)
        outs = _rank_outs(n, K, m2, dev)
        _kernel_op(cm, name, (u, a, b, lam, gamma), outs,
                   roofline.rank_work(n, m1, K, m2))
        return outs

    def linear_rank_audited_cuda(u, a, b, X, W, c, gamma, *, m2, eps=1e-4,
                                 tol=None, relu=True, device=None):
        dev = FAKE_CARD
        n, m1, K = check_rank_args(u, a, b, None, gamma, m2, dev)
        check_rank_kernel(K, m2)
        outs = _rank_outs(n, K, m2, dev) + (
            torch.empty((n, K), device=dev),)
        _kernel_op(cm, name, (u, a, b, X, W, c, gamma), outs,
                   roofline.linear_work(n, m1, K, m2, X.shape[1]))
        return outs

    return {"fused_rank": fused_rank_cuda, "rank_audited": rank_audited_cuda,
            "linear_rank_audited": linear_rank_audited_cuda}[name]


def _rank_outs(n, K, m2, dev):
    f32, i32 = torch.float32, torch.int32
    return (torch.empty((n, m2), dtype=f32, device=dev),
            torch.empty((n, m2), dtype=i32, device=dev),
            torch.empty((n,), dtype=f32, device=dev),
            torch.empty((n, K), dtype=f32, device=dev),
            torch.empty((n,), dtype=torch.bool, device=dev))


def _fake_knn(cm, name):
    from repro_torch.core.predictors import check_pack
    from repro_torch.kernels.common import QUANT_EXTRA
    from repro_torch.kernels.fused_rank import (
        check_rank_args,
        check_rank_kernel,
    )
    from repro_torch.kernels.knn_topk import (
        quant_sweep_geometry,
        sweep_geometry,
    )

    f32, i32 = torch.float32, torch.int32

    def lam_rows(lam_db, B, k):
        return [(lam_db, 4 * B * k * lam_db.shape[1])]

    def knn_topk_cuda(xq, xdb, *, k=10, device=None):
        dev = FAKE_CARD
        (B, D), N = xq.shape, xdb.shape[0]
        sweep_geometry(B, N, D, k)
        outs = (torch.empty((B, k), dtype=f32, device=dev),
                torch.empty((B, k), dtype=i32, device=dev))
        _kernel_op(cm, name, (xq, xdb), outs, roofline.topk_work(B, N, D, k))
        return outs

    def knn_lambda_cuda(xq, xdb, lam_db, *, k=10, device=None):
        dev = FAKE_CARD
        (B, D), N, kp = xq.shape, xdb.shape[0], lam_db.shape[1]
        sweep_geometry(B, N, D, k)
        out = torch.empty((B, kp), dtype=f32, device=dev)
        _kernel_op(cm, name, (xq, xdb, lam_db), (out,),
                   roofline.sweep_work(B, N, D, k, kp),
                   touched=lam_rows(lam_db, B, k))
        return out

    def knn_rank_audited_cuda(xq, xdb, lam_db, u, a, b, gamma, *, k=10, m2,
                              eps=1e-4, tol=None, device=None):
        dev = FAKE_CARD
        B, m1, K = check_rank_args(u, a, b, None, gamma, m2, dev)
        N, D = xdb.shape
        kp = lam_db.shape[1]
        sweep_geometry(B, N, D, k)
        check_rank_kernel(K, m2)
        outs = _rank_outs(B, K, m2, dev) + (
            torch.empty((B, K), dtype=f32, device=dev),)
        _kernel_op(cm, name, (xq, xdb, lam_db, u, a, b, gamma), outs,
                   roofline.knn_work(B, N, m1, K, m2, D, k, kp),
                   touched=lam_rows(lam_db, B, k))
        return outs

    def quant(xq, X_q, q_scale, y2_q, lam_db, k, k_extra, mode):
        slab = check_pack(X_q, q_scale, y2_q, mode, n_train=lam_db.shape[0])
        (B, D), n_pad = xq.shape, X_q.shape[0]
        quant_sweep_geometry(B, n_pad, D, k, k_extra, mode)
        return B, D, n_pad, slab, lam_db.shape[1]

    def knn_lambda_quant_cuda(xq, X_q, q_scale, y2_q, lam_db, *, k=10,
                              k_extra=QUANT_EXTRA, mode, device=None):
        dev = FAKE_CARD
        B, D, n_pad, slab, kp = quant(xq, X_q, q_scale, y2_q, lam_db, k,
                                      k_extra, mode)
        outs = (torch.empty((B, kp), dtype=f32, device=dev),
                torch.empty((B, 1), dtype=i32, device=dev))
        _kernel_op(cm, name, (xq, X_q, q_scale, y2_q, lam_db), outs,
                   roofline.quant_sweep_work(B, n_pad, mode, D, k, kp, slab),
                   mode, touched=lam_rows(lam_db, B, k))
        return outs

    def knn_rank_audited_quant_cuda(xq, X_q, q_scale, y2_q, lam_db, u, a, b,
                                    gamma, *, k=10, k_extra=QUANT_EXTRA,
                                    mode, m2, eps=1e-4, tol=None,
                                    device=None):
        dev = FAKE_CARD
        B, m1, K = check_rank_args(u, a, b, None, gamma, m2, dev)
        _, D, n_pad, slab, kp = quant(xq, X_q, q_scale, y2_q, lam_db, k,
                                      k_extra, mode)
        check_rank_kernel(K, m2)
        outs = _rank_outs(B, K, m2, dev) + (
            torch.empty((B, K), dtype=f32, device=dev),
            torch.empty((B, 1), dtype=i32, device=dev))
        _kernel_op(cm, name, (xq, X_q, q_scale, y2_q, lam_db, u, a, b, gamma),
                   outs, roofline.quant_knn_work(B, n_pad, m1, K, m2, mode,
                                                 D, k, kp, slab),
                   mode, touched=lam_rows(lam_db, B, k))
        return outs

    return {"knn_topk": knn_topk_cuda, "knn_lambda": knn_lambda_cuda,
            "knn_rank_audited": knn_rank_audited_cuda,
            "knn_lambda_quant": knn_lambda_quant_cuda,
            "knn_rank_audited_quant": knn_rank_audited_quant_cuda}[name]


def _fake_bag(cm, name):

    def embedding_bag_cuda(table, indices, weights=None, *, device=None):
        dev = FAKE_CARD
        (V, D), (n_bags, bag) = table.shape, indices.shape
        if V == 0 and indices.numel():
            raise ValueError("the table has no rows to gather")
        out = torch.empty((n_bags, D), dtype=table.dtype, device=dev)
        work = roofline.bag_shape_work(n_bags, bag, D, table.element_size(),
                                       weights is not None)
        _kernel_op(cm, name, (table, indices, weights), (out,), work,
                   touched=[(table, min(_nbytes(table), n_bags * bag * D
                                        * table.element_size()))])
        return out

    return embedding_bag_cuda


def _fakes(cm) -> dict:
    """{wrapper function: its trace twin, logging into cm} for the nine
    kernels."""
    # the kernels package exports functions of these names: take the
    # modules themselves
    fused_rank, knn_topk, embedding_bag = (importlib.import_module(
        f"repro_torch.kernels.{m}") for m in ("fused_rank", "knn_topk",
                                              "embedding_bag"))
    out = {}
    for name in KERNELS:
        mod = (fused_rank if name in ("fused_rank", "rank_audited",
                                      "linear_rank_audited")
               else embedding_bag if name == "embedding_bag" else knn_topk)
        make = (_fake_rank if mod is fused_rank else
                _fake_bag if mod is embedding_bag else _fake_knn)
        out[getattr(mod, f"{name}_cuda")] = make(cm, name)
    return out


def _no_launch(*_args, **_kw):
    raise RuntimeError("a kernel launch under a cost trace: a wrapper was "
                       "not swapped for its trace twin")


def _this_thread(real, twin):
    """A function that calls `twin` on the thread that made it and
    `real` on every other."""
    owner = threading.get_ident()

    def call(*args, **kw):
        return (twin if threading.get_ident() == owner else real)(*args,
                                                                  **kw)
    return call


@contextlib.contextmanager
def _swapped(pairs: dict):
    """Every repro_torch module attribute that holds a key of `pairs`
    calls its value within the block, on this thread; other threads
    still call the key."""
    undo = []
    for mod in [m for n, m in list(sys.modules.items())
                if n.startswith("repro_torch") and m is not None]:
        for attr, val in list(vars(mod).items()):
            if callable(val) and val in pairs:
                setattr(mod, attr, _this_thread(val, pairs[val]))
                undo.append((mod, attr, val))
    try:
        yield
    finally:
        for mod, attr, val in undo:
            setattr(mod, attr, val)


def _region_twins(cm: _CostMode) -> dict:
    """Trace twins of distributed.topk's shard plumbing: shard_device
    notes the body's mesh position, run_on_shard runs the body in that
    region, tags the autograd nodes it made with it and counts what it
    hands to the merging device, note_exchange counts a collective's
    bytes in the region it runs in, gather_merge_top_k runs in the
    merge region, and place leaves a shape-only tensor on the fake card
    whatever device the mesh names (a program built over a mesh of real
    devices is traced on the fake card)."""
    from repro_torch.distributed import topk
    from repro_torch.launch import mesh

    real_dev, real_run, real_merge, real_note, real_place = (
        topk.shard_device, topk.run_on_shard, topk.gather_merge_top_k,
        topk.note_exchange, mesh.place)
    pending = []

    def place(x, device):
        return x if x.is_meta else real_place(x, device)

    def shard_device(mesh, coords):
        pending.append(tuple(int(coords.get(a, 0))
                             for a in mesh.axis_names))
        return real_dev(mesh, coords)

    def run_on_shard(device, merge_device, body):
        pos = pending.pop() if pending else (-1,)
        copies = topk.body_copies()
        region = ("body", pos) if copies == 1 else ("body", pos, copies)
        prev, cm.region = cm.region, region
        try:
            first = _next_sequence_nr()
            out = real_run(device, merge_device, body)
            _tag_nodes(out, region, range(first, _next_sequence_nr()))
        finally:
            cm.region = prev
        if any(pos) and merge_device is not None:
            handed = sum(_nbytes(t) for t in _tensors(out))
            cm.walk.ops.append(Op("collective", "shard_gather", (), (),
                                  0.0, None, ("body", pos), handed))
        return out

    def note_exchange(kind, nbytes, axes=()):
        cm.walk.ops.append(Op("collective", kind, (), (), 0.0, None,
                              cm.region, float(nbytes), tuple(axes)))

    def gather_merge_top_k(*args, **kw):
        prev, cm.region = cm.region, ("merge",)
        try:
            return real_merge(*args, **kw)
        finally:
            cm.region = prev

    return {real_dev: shard_device, real_run: run_on_shard,
            real_merge: gather_merge_top_k, real_note: note_exchange,
            real_place: place}


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def fake_args(program):
    """The program's argument trees with each ArgSpec a shape-only
    tensor of its shape and dtype on the fake card (any other leaf, an
    int say, as it is)."""
    from repro_torch.configs.registry import ArgSpec
    from repro_torch.distributed.sharding import tree_map
    return tuple(tree_map(lambda s: torch.empty(
        s.shape, dtype=s.dtype, device=FAKE_CARD) if isinstance(s, ArgSpec)
        else s, a) for a in program.args)


def trace_program(program, mesh, *, one_body: bool = True) -> Walk:
    """Run `program.fn` once on fake tensors on the fake card under
    use_mesh_rules(mesh, program.rules) and return its Walk. The trace
    is this thread's: the kernel wrappers' twins, the shard plumbing's
    and the fake card are seen by this thread alone, and any other
    thread (an engine's pipeline worker, a fleet replica, a refresh
    lane) that calls a wrapper meanwhile launches the real kernel.

    With `one_body` (distributed.topk.one_body) a partitioned program's
    each_block runs its first block's body alone and counts each of its
    ops once a block (Op.weight): its bodies run the same ops on the
    same shapes (a program's inputs split evenly), so the walk's record
    is the all-bodies walk's (tests/test_torch_dryrun.py holds them
    equal), in about the time of one body, where a 256-position LM
    program's bodies would take hours."""
    from repro_torch.checkpoint.store import flatten_with_paths
    from repro_torch.distributed import topk
    from repro_torch.distributed.sharding import use_mesh_rules
    from repro_torch.kernels import build

    walk = Walk(devices=int(mesh.devices.size), mesh_shape=dict(mesh.shape))
    cm = _CostMode(walk)
    twins = {**_fakes(cm), **_region_twins(cm), build.launch: _no_launch}
    with _swapped(twins), fake_card(), \
            fx_config.patch(meta_nonzero_assume_all_nonzero=True):
        args = fake_args(program)
        for i, a in enumerate(program.args):
            specs = flatten_with_paths(a)
            for path, t in flatten_with_paths(args[i]).items():
                if isinstance(t, torch.Tensor):
                    walk.arg_sids[(i, path)] = cm.sid(t)
                    walk.arg_specs[(i, path)] = specs[path]
        cm.args = set(walk.arg_sids.values())
        mode = topk.one_body() if one_body else contextlib.nullcontext()
        with cm, use_mesh_rules(mesh, program.rules), mode:
            out = program.fn(*args)
        walk.out_sids = tuple(dict.fromkeys(cm.sid(t)
                                            for t in _tensors(out)))
    return walk


@contextlib.contextmanager
def fake_card():
    """Within the block resolve_device, on this thread alone, takes the
    fake card (the meta device) as the card: a trace runs in one, and a
    dry run builds its virtual meshes over the fake card in one."""
    from repro_torch.device import FAKE_CARD_TRACES as traces
    traces.n = getattr(traces, "n", 0) + 1
    try:
        yield
    finally:
        traces.n -= 1


def _sum_flops(dst: dict, src: dict | None, scale: float = 1.0):
    for k, v in (src or {}).items():
        dst[k] = dst.get(k, 0.0) + v * scale


def graph_cost(walk: Walk) -> dict:
    """Per-device, per-step cost of the traced program: flops by dtype
    (all of them, the kernels' fp32 and dot operations included, and
    the matmul class's), bytes by the conventions above, the bytes it
    must move at least (min_bytes), the global counts, and whether the
    program ran shard bodies."""
    n = walk.devices
    glob = {"flops": {}, "mm": {}, "bytes": 0.0}
    merge = {"flops": {}, "mm": {}, "bytes": 0.0}
    bodies: dict = {}
    for op in walk.ops:
        if op.region is None:
            acc = glob
        elif op.region[0] == "merge":
            acc = merge
        else:
            acc = bodies.setdefault(op.region[1],
                                    {"flops": {}, "mm": {}, "bytes": 0.0})
        acc["bytes"] += op.nbytes
        _sum_flops(acc["flops"], op.flops)
        if op.cat == "matmul":
            _sum_flops(acc["mm"], op.flops)
    body = max(bodies.values(), default={"flops": {}, "mm": {}, "bytes": 0.0},
               key=lambda b: (roofline.compute_seconds(b["flops"])
                              + b["bytes"] / roofline.HBM_BW))
    flops, mm = {}, {}
    for part, scale in ((glob, 1.0 / n), (merge, 1.0), (body, 1.0)):
        _sum_flops(flops, part["flops"], scale)
        _sum_flops(mm, part["mm"], scale)
    nbytes = glob["bytes"] / n + merge["bytes"] + body["bytes"]
    return {
        "flops": sum(flops.values()),
        "flops_by_dtype": flops,
        "matmul_flops_by_dtype": mm,
        "bytes": nbytes,
        "min_bytes": (walk.min_block_bytes() if walk.partitioned
                      else walk.min_bytes() / n),
        "global_flops": sum(glob["flops"].values()),
        "global_bytes": glob["bytes"],
        "partitioned": walk.partitioned,
        "n_ops": sum(op.weight for op in walk.ops),
        "n_kernel_ops": sum(op.weight for op in walk.ops
                            if op.cat in KERNELS),
        "devices": n,
    }
