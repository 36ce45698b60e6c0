"""Roofline terms of the port's dry run on an H100 (counterpart of
repro.launch.roofline, whose constants are a TPU v5e's).

  compute    = sum over dtypes of flops[dtype] / PEAK_FLOPS[dtype]
  memory     = bytes / HBM_BW
  collective = sum over mesh axes of collective_bytes[axis] / link(axis)

Every number is per device and per step: the port's record carries the
cost walk's counts already divided over the mesh (launch/graph_cost.py:
a global program's walk over the device count, JAX's own fallback for
XLA's pre-partition cost analysis; one shard body plus the merge where
the program runs shard bodies). A JAX record (hlo_cost's per-device
counts, every flop an MXU bf16 flop) is read with the same peaks, so its
terms are JAX's rescaled by the ratio of the two cards' rates.

The card's published peaks (NVIDIA H100 SXM5 data sheet, dense, at its
700 W power limit; a card set lower runs slower under load):
  bf16 / fp16 tensor cores   989e12 FLOP/s
  fp32 (CUDA cores)           67e12 FLOP/s: the port's f32 products
                              run with TF32 off, so they get this rate
  int8 tensor cores         1979e12 OP/s
  HBM3                       3.35e12 B/s, 80 GB a card

Links (NVIDIA DGX H100 system): NVLink 4 moves 450e9 B/s a direction
a GPU (900 GB/s both ways) inside one 8-GPU node; across nodes each GPU
has one 400 Gb/s ConnectX-7 NIC, 50e9 B/s. The rule for a mesh axis:
the mesh lays devices out row-major (the last axis fastest) over nodes
of GPUS_PER_NODE; an axis stays inside a node, and gets NVLink, when it
and every axis after it multiply to at most GPUS_PER_NODE; any other
axis crosses nodes and gets the NIC's rate. A collective over several
axes moves at its slowest axis's rate.

MODEL_FLOPS = 6 N D (dense) or 6 N_active D (MoE), as JAX's; the
useful fraction model_flops / flops flags remat and redundancy.

The kernels' work formulas (each kernel's bytes, fp32 operations and
quantized dot operations at its shapes, inputs read once and outputs
written once) live here too: chip_smoke.py's kernel table takes its
bounds from them, and the cost walk records a kernel op with them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "fp32": 67e12,
              "int8": 1979e12}
HBM_BW = 3.35e12            # bytes/s a card
HBM_BYTES = 80e9            # bytes of HBM a card
NVLINK_BW = 450e9           # bytes/s a direction a GPU, inside a node
NIC_BW = 50e9               # bytes/s a GPU across nodes
GPUS_PER_NODE = 8


def axis_link(mesh_shape: dict, axis: str) -> float:
    """The link rate (bytes/s) of one mesh axis: NVLink when the axis
    and every axis after it fit one node, the NIC's rate otherwise."""
    names = list(mesh_shape)
    inner = math.prod(mesh_shape[a] for a in names[names.index(axis):])
    return NVLINK_BW if inner <= GPUS_PER_NODE else NIC_BW


def link_rate(mesh_shape: dict, axes) -> float:
    """The rate of a collective over `axes` (a name or a tuple of
    names): its slowest axis's; an empty set of axes moves nothing."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return min((axis_link(mesh_shape, a) for a in axes), default=NVLINK_BW)


def dtype_key(dtype) -> str:
    """A torch dtype's peak bucket: bf16, fp16, int8 (any 8-bit type)
    or fp32 (every other type, fp64 included: the fp32 rate is the
    least the card promises for it)."""
    name = str(dtype).replace("torch.", "")
    if name == "bfloat16":
        return "bf16"
    if name in ("float16", "half"):
        return "fp16"
    if name in ("int8", "uint8") or name.startswith("float8"):
        return "int8"
    return "fp32"


@dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes_accessed: float
    collective_bytes: float
    chips: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def compute_fraction(self) -> float:
        """Fraction of the step spent at peak-FLOPs usefulness if the
        dominant term were perfectly overlapped with the others."""
        return self.compute_s / self.bound_s if self.bound_s else 0.0

    def as_dict(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "bound_s": self.bound_s,
            "compute_fraction": self.compute_fraction,
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "collective_bytes": self.collective_bytes,
            "chips": self.chips,
        }


def compute_seconds(flops_by_dtype: dict) -> float:
    """Flops of each dtype over that dtype's peak, summed."""
    return sum(f / PEAK_FLOPS[k] for k, f in flops_by_dtype.items())


def terms_from_artifact(artifact: dict) -> RooflineTerms:
    """artifact: one dry-run record, the port's (launch/dryrun.py:
    graph_cost's per-device flops by dtype and bytes, collective_bytes'
    seconds by axis) or JAX's (hlo_cost's per-device counts, all flops
    bf16, its collectives at the slowest link of its mesh; or, without
    hlo_cost, XLA's global cost analysis over the chips)."""
    chips = int(artifact["mesh_devices"])
    shape = dict(zip(_axis_names(artifact), artifact.get("mesh_shape", ())))
    slowest = min((axis_link(shape, a) for a in shape), default=NIC_BW)
    gc = artifact.get("graph_cost")
    if gc:
        by = {k: float(v) for k, v in gc["flops_by_dtype"].items()}
        cb = artifact.get("collective_bytes", {})
        coll = float(cb.get("total", 0.0))
        coll_s = float(cb.get("seconds", coll / slowest))
        return RooflineTerms(compute_s=compute_seconds(by),
                             memory_s=float(gc["bytes"]) / HBM_BW,
                             collective_s=coll_s, flops=sum(by.values()),
                             bytes_accessed=float(gc["bytes"]),
                             collective_bytes=coll, chips=chips)
    hc = artifact.get("hlo_cost")
    if hc:
        flops, nbytes = float(hc["flops"]), float(hc["bytes"])
        coll = float(hc["collectives"].get("total", 0.0))
        scale = 1.0
    else:
        ca = artifact.get("xla_cost_analysis_raw",
                          artifact.get("cost_analysis", {}))
        flops = float(ca.get("flops", 0.0))
        nbytes = float(ca.get("bytes accessed", 0.0))
        coll = float(artifact.get("collective_bytes", {}).get("total", 0.0))
        scale = chips
    return RooflineTerms(
        compute_s=flops / (scale * PEAK_FLOPS["bf16"]),
        memory_s=nbytes / (scale * HBM_BW),
        collective_s=coll / slowest,
        flops=flops, bytes_accessed=nbytes, collective_bytes=coll,
        chips=chips)


def _axis_names(artifact: dict) -> tuple:
    n = len(artifact.get("mesh_shape", ()))
    return ("pod", "data", "model")[3 - n:] if n <= 3 else tuple(
        f"axis{i}" for i in range(n))


def model_flops(arch_name: str, cfg, cell) -> float | None:
    """6*N(_active)*D for LM train cells; None where the 6ND convention
    does not define a number (inference steps use 2ND per token)."""
    if not hasattr(cfg, "active_params_per_token"):
        return None
    tokens = cell["seq_len"] * cell["global_batch"]
    n_active = cfg.active_params_per_token
    if cell.kind == "train":
        return 6.0 * n_active * tokens
    if cell.kind == "prefill":
        return 2.0 * n_active * tokens
    if cell.kind == "decode":
        return 2.0 * n_active * cell["global_batch"]
    return None


# -- the kernels' work -------------------------------------------------------
# Each returns (bytes, fp32 operations) or, for the quantized sweeps,
# (bytes, fp32 operations, dot operations): every input read once, every
# output written once.

def rank_work(B, m1, K, m2):
    """(bytes, fp32 flops) of rank+audit: inputs read once, outputs
    written once; the score axpy and the audit sums."""
    read = 4 * (B * m1 + B * K * m1 + 2 * B * K + B * m2)
    write = 4 * (2 * B * m2 + B + B * K + B)
    return read + write, 2 * B * K * m1 + 2 * B * (K + 1) * m2


def fused_work(B, m1, K, m2):
    """(bytes, fp32 flops) of the top-m2 alone: u, a and lambda read
    once, vals and idx written once; the score axpy."""
    return 4 * (B * m1 + B * K * m1 + B * K) + 8 * B * m2, 2 * B * K * m1


def topk_work(B, n_db, d, k):
    """(bytes, fp32 flops) of the KNN top-k: the db and the queries read
    once, (d2, idx) written; distances B * n_db * (2d+3) plus |x|^2 per
    db row."""
    return (4 * (n_db * d + B * d) + 8 * B * k,
            B * n_db * (2 * d + 3) + 2 * n_db * d)


def linear_work(B, m1, K, m2, d):
    """rank+audit, with X (B, d), W (K, d) and c read in place of
    lambda, lambda-hat written, and the prologue's 2 B K d flops."""
    rb, rf = rank_work(B, m1, K, m2)
    return rb + 4 * (B * d + K * d + K), rf + 2 * B * K * d


def sweep_work(B, n_db, d, k, k_pred):
    """(bytes, fp32 flops) of the KNN predictor: the db and queries read
    once, the k winners' lambda rows, lambda-hat (B, k_pred) written;
    distances B * n_db * (2d+3) plus |x|^2 per db row."""
    nbytes = 4 * (n_db * d + B * d + B * k * k_pred + B * k_pred)
    return nbytes, B * n_db * (2 * d + 3) + 2 * n_db * d


def knn_work(B, n_db, m1, K, m2, d, k, k_pred):
    """The KNN stage: the sweep, then rank+audit (lambda-hat written at
    the problem's K)."""
    rb, rf = rank_work(B, m1, K, m2)
    sb, sf = sweep_work(B, n_db, d, k, k_pred)
    return rb + sb + 4 * B * (K - k_pred), rf + sf


def quant_sweep_work(B, n_db, mode, d, k, k_pred, slab=512):
    """(bytes, fp32 flops, dot ops) of the quantized KNN predictor: the
    pack (1 or 2 bytes a coordinate, 4 for each row's y2, 4 for each
    slab's scale) and the queries read once, the k winners' lambda rows
    read, lambda-hat and the guard written; the dot's 2d operations a
    (query, row) pair, and its fp32 epilogue, 5 operations a pair in
    int8 (scale product, scaling, subtract, add, clamp) and 4 in bf16."""
    n_pad = -(-n_db // slab) * slab
    width = 1 if mode == "int8" else 2
    nbytes = (n_pad * d * width + 4 * n_pad + 4 * (n_pad // slab)
              + 4 * (B * d + B * k * k_pred + B * k_pred + B))
    return (nbytes, B * n_pad * (5 if mode == "int8" else 4),
            2 * B * n_pad * d)


def quant_knn_work(B, n_db, m1, K, m2, mode, d, k, k_pred, slab=512):
    """The quantized KNN stage: the quantized sweep, then rank+audit."""
    rb, rf = rank_work(B, m1, K, m2)
    sb, sf, dot = quant_sweep_work(B, n_db, mode, d, k, k_pred, slab)
    return rb + sb + 4 * B * (K - k_pred), rf + sf, dot


def bag_shape_work(n_bags, bag, D, itemsize, weighted):
    """(bytes, fp32 flops) of the embedding bag from its shapes alone,
    every slot taken as valid: a row a slot read, the indices and
    weights (where there are any) read, the output written; a product
    and a sum per slot and column."""
    slots = n_bags * bag
    return (slots * D * itemsize + (8 if weighted else 4) * slots
            + n_bags * D * itemsize, 2 * slots * D)


def bound(nbytes, flops, dot_ops=0, mode="int8"):
    """The least time in ms for the work and what bounds it: bytes at the
    memory rate against operations, fp32 flops at the fp32 rate plus
    `dot_ops` of a quantized dot at the tensor-core peak of `mode`."""
    t_b = nbytes / HBM_BW
    t_f = flops / PEAK_FLOPS["fp32"] + dot_ops / PEAK_FLOPS[mode]
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"
