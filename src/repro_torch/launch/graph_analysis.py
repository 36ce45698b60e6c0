"""The dry run's post-mortem (counterpart of repro.launch.hlo_analysis):
an op census, the memory analysis and the collective bytes of a traced
program (launch/graph_cost.py's Walk), and a reader that groups a
torch.profiler trace's device time into the census's categories.

Memory, per device:
  argument  the ArgSpecs' blocks (each leaf's shape over its sharding's
            mesh axes), over the leaves the program reads, as JAX's
            argument_size_in_bytes counts them after jit's
            keep_unused=False drops the rest;
  output    an output that is an argument's storage at that argument's
            block, every other output over the device count (where the
            program runs shard bodies, the outputs the first position's
            bodies or the global part made);
  alias     the outputs that are arguments updated in place;
  temp      the walk's peak of live bytes, over the device count where
            the program is global; where it runs shard bodies, the
            largest mesh position's peak of the storages its bodies
            made (the global part's go to the first position).
Where the program is global (the recsys builds and the MoE LMs: the
port partitions the GNN's, the dense LMs' and the paper cells') the
output and temp bytes
are estimates of a partitioned program's, and the record lists them
under "estimated".

Collectives, per device, each part marked:
  counted   the bytes each shard body hands to the merging device
            (map_shards: the dist-topk paper cells, the shmap MoE's
            exchanges, the compressed psum), by mesh position; and the
            bytes the mesh collectives (distributed.topk's
            all_gather_rows, reduce_scatter_rows, psum: the partitioned
            GNN step; all_gather_dim, all_to_all_dim and the other
            collectives over a position's group) move into the busiest
            position: (S - 1) / S of the gathered rows for an
            all-gather, a reduce-scatter or an all-to-all, twice the
            leaf for a psum;
  modeled   for train cells that count no collective of their own, from
            the argument specs (ZeRO-3 / FSDP as GSPMD partitions it):
            a parameter leaf sharded over batch axes ('pod', 'data') is
            all-gathered over them once forward and once backward
            (remat) and its gradient reduce-scattered; a leaf replicated
            over the batch axes has its gradient all-reduced over them;
            each part at its axes' link rate (roofline.link_rate);
  tp_activations  the exchanges over 'model' (tensor parallelism's:
            the partitioned LM's row-parallel sums, its vocab-parallel
            loss, decode's merge over the cache's blocks, the gathers of
            weights its heads need; in the paper cells, whose 'model'
            axis splits the items and the KNN database, offline_dual's
            all-to-all and the serve cells' candidate all-gathers),
            counted by kind under "kinds" and
            left out of the parts above; "absent" where the mesh has a
            'model' axis and nothing counts them (a global program).
Bytes modeled are result-buffer bytes, JAX's convention: an
all-gather's gathered leaf, a reduce-scatter's shard, an all-reduce's
whole block.
"""

from __future__ import annotations

import math
from collections import defaultdict

from repro_torch.launch import roofline
from repro_torch.launch.graph_cost import (  # noqa: F401 (block_bytes)
    KERNELS,
    Walk,
    _made_elsewhere,
    block_bytes,
)

CENSUS = ("matmul",) + KERNELS + ("index", "scatter", "sort", "topk",
                                  "copy", "collective")
BATCH_AXES = ("pod", "data")
EXCHANGES = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all")


def op_census(walk: Walk) -> dict:
    """How many matmuls, launches of each kernel, index and scatter
    ops, sorts and topks, copies and collectives the program ran."""
    census: dict = defaultdict(int)
    for op in walk.ops:
        cat = "topk" if op.name == "topk" else op.cat
        if cat in CENSUS:
            census[cat] += op.weight
    return dict(census)


def memory_analysis(walk: Walk) -> dict:
    """The port's memory_analysis: per-device argument, output, alias
    and temp bytes (see the module's docstring)."""
    n = 1 if walk.partitioned else walk.devices
    arg_of = {}
    for key, sid in walk.arg_sids.items():
        arg_of.setdefault(sid, key)
    out = alias = 0
    for sid in set(walk.out_sids):
        if walk.partitioned and _made_elsewhere(walk, sid):
            continue
        if sid in arg_of:
            b = block_bytes(walk.arg_specs[arg_of[sid]])
            out += b
            if sid in walk.written:
                alias += b
        else:
            out += -(-walk.storage_bytes[sid] // n)
    rec = {
        "argument_size_in_bytes": sum(block_bytes(walk.arg_specs[k])
                                      for k in walk.read_leaves()),
        "output_size_in_bytes": int(out),
        "temp_size_in_bytes": int(walk.peak_live_bytes(per_position=True)
                                  if walk.partitioned else
                                  -(-walk.peak_live_bytes() // n)),
        "alias_size_in_bytes": int(alias),
        "generated_code_size_in_bytes": 0,
    }
    if not walk.partitioned:
        rec["estimated"] = ["output_size_in_bytes", "temp_size_in_bytes"]
    return rec


def collective_bytes(walk: Walk, cell_kind: str) -> dict:
    """The collectives a device takes part in for one step, each part
    counted, modeled or absent (the module's docstring), with the
    seconds they take at their axes' link rates."""
    shape = walk.mesh_shape
    batch = tuple(a for a in BATCH_AXES if shape.get(a, 1) > 1)
    parts = {}
    handed = sum(op.handed for op in walk.ops if op.name == "shard_gather")
    if handed:
        parts["shard_gather"] = {"how": "counted", "bytes": handed,
                                 "axes": list(shape)}
    moved: dict = defaultdict(lambda: defaultdict(float))
    axes_of: dict = defaultdict(set)
    for op in walk.ops:
        if op.name in EXCHANGES and op.region:
            # an exchange over 'model' is tensor parallelism's
            key = ("tp", op.name) if "model" in op.axes else op.name
            moved[op.region[1]][key] += op.handed
            axes_of[key] |= set(op.axes)
    if moved:
        busiest = max(moved, key=lambda pos: sum(moved[pos].values()))
        for kind in EXCHANGES:
            if moved[busiest].get(kind):
                parts[kind] = {"how": "counted",
                               "bytes": moved[busiest][kind],
                               "axes": sorted(axes_of[kind],
                                              key=list(shape).index)}
        tp = {kind: moved[busiest][("tp", kind)] for kind in EXCHANGES
              if moved[busiest].get(("tp", kind))}
        if tp:
            axes = set().union(*(axes_of[("tp", k)] for k in tp))
            parts["tp_activations"] = {
                "how": "counted", "bytes": sum(tp.values()),
                "axes": sorted(axes, key=list(shape).index), "kinds": tp}
    if cell_kind.startswith("train") and not moved:
        ag = rs = ar = 0
        ag_axes, ar_axes = set(), set()
        read = walk.read_leaves()
        for (i, path), spec in walk.arg_specs.items():
            if i != 0 or (i, path) not in read:
                continue
            blk = block_bytes(spec)
            axes = _sharded_axes(spec) & set(batch)
            if axes:
                g = math.prod(shape[a] for a in axes)
                ag += 2 * blk * g
                rs += blk
                ag_axes |= axes
            elif batch:
                ar += blk
                ar_axes |= set(batch)
        for name, b, axes in (("param_all_gather", ag, ag_axes),
                              ("grad_reduce_scatter", rs, ag_axes),
                              ("grad_all_reduce", ar, ar_axes)):
            if b:
                parts[name] = {"how": "modeled", "bytes": b,
                               "axes": sorted(axes, key=list(shape).index)}
    if shape.get("model", 1) > 1 and "tp_activations" not in parts:
        parts["tp_activations"] = {"how": "absent", "bytes": None,
                                   "axes": ["model"]}
    total = sum(p["bytes"] or 0 for p in parts.values())
    seconds = sum((p["bytes"] or 0) / roofline.link_rate(shape, p["axes"])
                  for p in parts.values() if p["bytes"])
    kinds = {"shard_gather": "all-gather", "param_all_gather": "all-gather",
             "grad_reduce_scatter": "reduce-scatter",
             "grad_all_reduce": "all-reduce", **{k: k for k in EXCHANGES}}
    out: dict = defaultdict(float)
    for name, p in parts.items():
        for kind, b in (p.get("kinds") or {kinds.get(name): p["bytes"]}
                        ).items():
            if b:
                out[kind] += b
    return {**out, "total": total, "seconds": seconds, "parts": parts}


def _sharded_axes(spec) -> set:
    from repro_torch.launch.mesh import spec_entries
    if spec.sharding is None:
        return set()
    return {a for axes in spec_entries(spec.sharding.spec, len(spec.shape))
            for a in axes}


# -- the card's profiler -----------------------------------------------------

# kernel-name fragments, most specific first: the port's kernels by their
# __global__ names (the KNN sweeps are shared, so they count apart)
_DEVICE_NAMES = (
    ("knn_rank_audited_quant_kernel", "knn_rank_audited_quant"),
    ("knn_lambda_quant_kernel", "knn_lambda_quant"),
    ("knn_rank_audited_kernel", "knn_rank_audited"),
    ("linear_rank_audited_kernel", "linear_rank_audited"),
    ("rank_audited_kernel", "rank_audited"),
    ("knn_lambda_kernel", "knn_lambda"),
    ("knn_topk_merge_kernel", "knn_topk"),
    ("fused_rank_kernel", "fused_rank"),
    ("embedding_bag_kernel", "embedding_bag"),
    ("quant_chunk_topk_kernel", "knn_quant_sweep"),
    ("chunk_topk_kernel", "knn_sweep"),
    ("nccl", "collective"),
    ("gemm", "matmul"), ("cutlass", "matmul"), ("xmma", "matmul"),
    ("cublas", "matmul"), ("fmha", "matmul"), ("flash", "matmul"),
    ("attention", "matmul"), ("conv", "matmul"),
    ("index_put", "scatter"), ("scatter", "scatter"),
    ("indexing_backward", "scatter"), ("index_add", "scatter"),
    ("index", "index"), ("gather", "index"), ("embedding", "index"),
    ("topk", "topk"), ("sort", "sort"), ("radix", "sort"),
    ("bitonic", "sort"),
    ("memcpy", "copy"), ("copy", "copy"),
    ("elementwise", "elementwise"), ("vectorized", "elementwise"),
    ("cat", "elementwise"),
)


def device_category(name: str) -> str:
    """The census category of a device kernel's name."""
    low = name.lower()
    for frag, cat in _DEVICE_NAMES:
        if frag in low:
            return cat
    return "other"


def device_time_by_category(prof) -> dict:
    """A torch.profiler.profile's device time (ms, summed over every
    event of the trace) grouped into the census's categories (the
    port's KNN sweeps apart, as 'knn_sweep' and 'knn_quant_sweep'), and
    'other'."""
    out: dict = defaultdict(float)
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue            # a host op: its kernels are events too
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0.0)
        if t > 0:
            out[device_category(ev.key)] += t / 1e3
    return dict(out)
