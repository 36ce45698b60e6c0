"""The port's dry run (launch/dryrun.py, graph_analysis.py, roofline.py)
held against JAX's: the argument bytes of every committed JAX dry-run
record (experiments/dryrun/{single,multi}, 86 of them), model_flops on
every LM arch x cell, the roofline terms of a JAX record, the matmul
flops of three SMOKE programs against repro.launch.hlo_cost on a
one-device CPU compile of JAX's program (built in a subprocess, as
tests/test_torch_distributed.py builds its side), run_cell on one cell
of each family, a one-body walk against the all-bodies walk, the
committed partitioned GNN and dense LM records against JAX's flops,
and the kernels' bounds at PERF.md's table shapes.

Tolerances: argument bytes, flops and the kernels' (bytes, flops)
exactly; the roofline terms of a JAX record rtol 1e-12 (a ratio of two
peaks).

The argument bytes: JAX's argument_size_in_bytes counts, per device, the
blocks of the arguments jit keeps (keep_unused=False drops the leaves
the program never reads). The port's are the FULL build's ArgSpec
blocks over the leaves its program reads. Tracing every FULL cell takes
minutes (the LM cells loop over attention chunks), so the read leaves
come from the SMOKE program's walk where its leaves are the FULL
build's (the same paths); where they differ (DeepFM's deep tower has
more layers at FULL) the FULL program is traced, which takes well under
a second for those cells.
"""

import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.checkpoint.store import flatten_with_paths
from repro_torch.configs import get_arch
from repro_torch.launch import roofline
from repro_torch.launch.dryrun import (
    _smoke_cell,
    production_mesh,
    run_cell,
    smoke_mesh,
)
from repro_torch.launch.graph_analysis import block_bytes
from repro_torch.launch.graph_cost import (
    FAKE_CARD,
    fake_card,
    graph_cost,
    trace_program,
)
from repro_torch.launch.mesh import make_smoke_mesh, virtual_mesh

REPO = Path(__file__).resolve().parent.parent
RECORDS = sorted((REPO / "experiments" / "dryrun").glob("*/*.json"))
LM_ARCHS = ("kimi-k2-1t-a32b", "llama3.2-1b", "llama4-scout-17b-a16e",
            "mistral-nemo-12b", "phi3-medium-14b")
LM_CELLS = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
FLOP_CELLS = ("llama3.2-1b:train_4k", "sasrec:serve_p99",
              "meshgraphnet:full_graph_sm")


def test_every_committed_jax_record_is_here():
    assert len(RECORDS) == 86
    assert {p.parent.name for p in RECORDS} == {"single", "multi"}


@pytest.fixture(scope="module")
def meshes():
    return {"single": production_mesh(), "multi":
            production_mesh(multi_pod=True), "smoke": smoke_mesh()}


_READ: dict = {}


def _read_leaves(arch, cell, full_prog, mesh, smoke):
    """The leaves (arg index, path) the cell's program reads."""
    key = (arch, cell)
    if key not in _READ:
        spec = get_arch(arch)
        prog = spec.build(spec.make_config(False), _smoke_cell(spec, cell),
                          smoke)
        paths = {(i, p) for i, a in enumerate(prog.args)
                 for p in flatten_with_paths(a)}
        full = {(i, p) for i, a in enumerate(full_prog.args)
                for p in flatten_with_paths(a)}
        _READ[key] = (trace_program(prog, smoke) if paths == full
                      else trace_program(full_prog, mesh)).read_leaves()
    return _READ[key]


@pytest.mark.parametrize("path", RECORDS,
                         ids=[f"{p.parent.name}-{p.stem}" for p in RECORDS])
def test_argument_bytes_over_read_leaves_equal_jax(meshes, path):
    rec = json.loads(path.read_text())
    spec = get_arch(rec["arch"])
    mesh = meshes[path.parent.name]
    assert list(mesh.devices.shape) == rec["mesh_shape"]
    prog = spec.build(spec.make_config(True), spec.cell(rec["cell"]), mesh)
    read = _read_leaves(rec["arch"], rec["cell"], prog, mesh,
                        meshes["smoke"])
    got = sum(block_bytes(a) for i, arg in enumerate(prog.args)
              for p, a in flatten_with_paths(arg).items() if (i, p) in read)
    assert got == rec["memory_analysis"]["argument_size_in_bytes"]


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("cell", LM_CELLS)
def test_model_flops_equal_jax(arch, cell):
    from repro.configs import get_arch as jax_arch
    from repro.launch.roofline import model_flops as jax_model_flops
    jspec, spec = jax_arch(arch), get_arch(arch)
    want = jax_model_flops(arch, jspec.make_config(True), jspec.cell(cell))
    got = roofline.model_flops(arch, spec.make_config(True), spec.cell(cell))
    assert got == want and got is not None


@pytest.mark.parametrize("mesh_tag", ["single", "multi"])
def test_terms_of_a_jax_record_rescale_by_the_peaks(mesh_tag):
    from repro.launch import roofline as jax_roofline
    for path in RECORDS:
        if path.parent.name != mesh_tag:
            continue
        rec = json.loads(path.read_text())
        want = jax_roofline.terms_from_artifact(rec)
        got = roofline.terms_from_artifact(rec)
        assert math.isclose(got.compute_s, want.compute_s
                            * jax_roofline.PEAK_FLOPS
                            / roofline.PEAK_FLOPS["bf16"], rel_tol=1e-12)
        assert math.isclose(got.memory_s, want.memory_s
                            * jax_roofline.HBM_BW / roofline.HBM_BW,
                            rel_tol=1e-12)
        # every axis of a 256-chip mesh crosses nodes: the NIC's 50 GB/s,
        # the rate JAX's terms take for a link
        assert math.isclose(got.collective_s, want.collective_s
                            * jax_roofline.LINK_BW / roofline.NIC_BW,
                            rel_tol=1e-12, abs_tol=1e-300)
        assert (got.flops, got.bytes_accessed, got.chips) == (
            want.flops, want.bytes_accessed, want.chips)


def test_link_rates_follow_the_node_rule():
    assert roofline.link_rate({"data": 2, "model": 4}, "model") == \
        roofline.NVLINK_BW
    assert roofline.link_rate({"data": 2, "model": 4}, ("data", "model")) \
        == roofline.NVLINK_BW
    assert roofline.link_rate({"data": 4, "model": 4}, "data") == \
        roofline.NIC_BW
    assert roofline.link_rate({"data": 16, "model": 16}, "model") == \
        roofline.NIC_BW


@pytest.mark.parametrize("arch,cell", [
    ("llama3.2-1b", "decode_32k"), ("sasrec", "retrieval_cand"),
    ("meshgraphnet", "molecule"), ("paper-ranking", "serve_online"),
    ("paper-ranking", "offline_dual")])
def test_run_cell_on_a_smoke_mesh(arch, cell):
    mesh = make_smoke_mesh(device="cpu")
    rec = run_cell(arch, cell, mesh, "smoke_single", smoke=True)
    assert rec["status"] == "ok" and rec["fits"] and rec["fits_arguments"]
    assert rec["trace_s"] >= 0 and rec["mesh_devices"] == 8
    gc, ma = rec["graph_cost"], rec["memory_analysis"]
    assert gc["devices"] == 8
    if arch in ("meshgraphnet", "llama3.2-1b", "paper-ranking"):
        # build_gnn's step runs as shard bodies over the 2 'data'
        # blocks, build_lm's decode and build_paper's programs one a
        # mesh position: the temp is a body's own, no estimate
        assert gc["partitioned"] and "estimated" not in rec
        kind = {"offline_dual": "all-to-all", "serve_online": "all-gather"
                }.get(cell, "all-reduce")
        assert rec["collective_bytes"][kind] > 0
    else:
        # a global program's temp is an estimate, and so is its fit
        assert not gc["partitioned"]
        assert rec["estimated"] == ["per_device_bytes", "fits"]
    assert ma["argument_size_in_bytes"] > 0
    assert rec["per_device_bytes"] == (
        ma["argument_size_in_bytes"] + ma["temp_size_in_bytes"]
        + ma["output_size_in_bytes"] - ma["alias_size_in_bytes"])
    assert rec["roofline"]["chips"] == 8
    json.dumps(rec)
    if cell in ("retrieval_cand", "serve_online"):
        assert gc["n_kernel_ops"] >= 2


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,cell", [("llama3.2-1b", "train_4k"),
                                       ("meshgraphnet", "minibatch_lg"),
                                       ("paper-ranking", "offline_dual"),
                                       ("paper-ranking", "serve_online")])
def test_one_body_walk_equals_the_all_bodies_walk(arch, cell, multi_pod):
    """A partitioned SMOKE program on the (2, 4) or (2, 2, 2) mesh traced
    one body for all (each op counted for the blocks its body stands
    for) gives the record of the walk that runs every body, field for
    field but the walk's seconds."""
    mesh = smoke_mesh(multi_pod=multi_pod)
    one = run_cell(arch, cell, mesh, "smoke_single", smoke=True)
    every = run_cell(arch, cell, mesh, "smoke_single", smoke=True,
                     one_body=False)
    assert one.pop("trace_s") >= 0 and every.pop("trace_s") >= 0
    assert one["graph_cost"]["partitioned"]
    assert one == every


# -- the partitioned GNN step ------------------------------------------------

GNN_CELLS = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
GNN_RECORDS = sorted((REPO / "experiments" / "dryrun_torch").glob(
    "*/meshgraphnet__*.json"))


@pytest.mark.parametrize("cell", GNN_CELLS)
def test_partitioned_gnn_flops_are_a_block_of_the_global_walk(cell):
    """A SMOKE GNN cell's per-device flops on the (2, 4) mesh, whose
    step runs one body a 'data' block, are the global walk's (the same
    program on a one-device mesh) over the 2 blocks, within 5%: a
    body's backward and recomputation are counted as the body's."""
    spec = get_arch("meshgraphnet")
    with fake_card():
        one = virtual_mesh((1, 1), ("data", "model"), FAKE_CARD)
    mesh = smoke_mesh()
    c = _smoke_cell(spec, cell)
    glob = graph_cost(trace_program(spec.build(spec.make_config(False), c,
                                               one), one))
    part = graph_cost(trace_program(spec.build(spec.make_config(False), c,
                                               mesh), mesh))
    assert part["partitioned"] and not glob["partitioned"]
    assert part["flops"] == pytest.approx(glob["flops"] / 2, rel=0.05)
    assert part["global_flops"] < 0.05 * part["flops"]


def test_the_committed_gnn_records_are_partitioned():
    assert len(GNN_RECORDS) == 8
    assert {p.parent.name for p in GNN_RECORDS} == {"single", "multi"}


@pytest.mark.parametrize("path", GNN_RECORDS,
                         ids=[f"{p.parent.name}-{p.stem}"
                              for p in GNN_RECORDS])
def test_partitioned_gnn_records_match_jax_flops(path):
    """Each committed meshgraphnet record says "partitioned": true, its
    per-device flops are within [0.95, 1.05] of JAX's hlo_cost flops for
    the same cell and mesh, and it counts the collectives it runs."""
    rec = json.loads(path.read_text())
    want = json.loads((REPO / "experiments" / "dryrun" / path.parent.name
                       / path.name).read_text())
    gc = rec["graph_cost"]
    assert rec["status"] == "ok" and gc["partitioned"]
    assert 0.95 <= gc["flops"] / want["hlo_cost"]["flops"] <= 1.05
    parts = rec["collective_bytes"]["parts"]
    assert parts["all-reduce"]["how"] == "counted"
    assert rec["collective_bytes"]["total"] > 0
    assert all(p["bytes"] > 0 for k, p in parts.items()
               if p["how"] == "counted")
    if rec["cell"] != "molecule":       # whole graphs a block: no exchange
        assert parts["all-gather"]["bytes"] > 0
        assert parts["reduce-scatter"]["bytes"] > 0


# -- the partitioned dense LM programs -----------------------------------------

DENSE_LMS = ("llama3.2-1b", "mistral-nemo-12b", "phi3-medium-14b")
LM_RECORDS = sorted(p for p in (REPO / "experiments" / "dryrun_torch").glob(
    "*/*.json") if p.stem.split("__")[0] in DENSE_LMS)


def test_the_committed_dense_lm_records_are_here():
    assert len(LM_RECORDS) == 24
    assert {p.parent.name for p in LM_RECORDS} == {"single", "multi"}


@pytest.mark.parametrize("path", LM_RECORDS,
                         ids=[f"{p.parent.name}-{p.stem}"
                              for p in LM_RECORDS])
def test_partitioned_lm_records_count_their_collectives(path):
    """Each committed dense LM record says "partitioned": true with no
    estimate, counts its FSDP all-gathers and its exchanges over 'model'
    (tp_activations), and its per-device flops are within [0.5, 3] of
    JAX's hlo_cost flops for the same cell and mesh (PERF.md §6 names
    the cause of each ratio away from 1)."""
    rec = json.loads(path.read_text())
    want = json.loads((REPO / "experiments" / "dryrun" / path.parent.name
                       / path.name).read_text())
    gc, parts = rec["graph_cost"], rec["collective_bytes"]["parts"]
    assert rec["status"] == "ok" and gc["partitioned"]
    assert "estimated" not in rec and "estimated" not in \
        rec["memory_analysis"]
    assert parts["tp_activations"]["how"] == "counted"
    assert parts["tp_activations"]["bytes"] > 0
    assert parts["all-gather"]["how"] == "counted"
    assert parts["all-gather"]["bytes"] > 0
    assert 0.5 <= gc["flops"] / want["hlo_cost"]["flops"] <= 3.0


# -- the partitioned paper cells ----------------------------------------------

PAPER_RECORDS = sorted((REPO / "experiments" / "dryrun_torch").glob(
    "*/paper-ranking__*.json"))


def test_the_committed_paper_records_are_here():
    """The default variant's six records and the dist-topk variant's
    six, under <mesh>@dist-topk."""
    assert len(PAPER_RECORDS) == 12
    assert {p.parent.name for p in PAPER_RECORDS} == {
        "single", "multi", "single@dist-topk", "multi@dist-topk"}


@pytest.mark.parametrize("path", PAPER_RECORDS,
                         ids=[f"{p.parent.name}-{p.stem}"
                              for p in PAPER_RECORDS])
def test_partitioned_paper_records_count_their_collectives(path):
    """Each committed paper record says "partitioned": true with no
    estimate and counts its collectives: offline_dual its one all-to-all
    over 'model' (under 10 MB a device, against JAX's 12.0-12.5 GB), the
    default's serve cells their candidates' all-gathers over 'model',
    the dist-topk variant's its shard gathers. The walk counts matmul
    and kernel flops only, so a serve cell's flops (the kernels') are
    within [0.9, 1.2] of JAX's hlo_cost flops and offline_dual's are 0
    (its solve is elementwise work and sorts)."""
    rec = json.loads(path.read_text())
    mesh = path.parent.name.split("@")[0]
    want = json.loads((REPO / "experiments" / "dryrun" / mesh
                       / path.name).read_text())
    gc, coll = rec["graph_cost"], rec["collective_bytes"]
    assert rec["status"] == "ok" and gc["partitioned"]
    assert "estimated" not in rec
    assert rec["variant"] == ("dist-topk" if "@" in path.parent.name
                              else None)
    if rec["cell"] == "offline_dual":
        assert 0 < coll["all-to-all"] == coll["total"] < 10e6
        assert gc["flops"] == 0
        return
    assert 0.9 <= gc["flops"] / want["hlo_cost"]["flops"] <= 1.2
    if rec["variant"] is None:
        assert coll["parts"]["tp_activations"]["kinds"]["all-gather"] > 0
    else:
        assert coll["parts"]["shard_gather"]["bytes"] > 0


# -- matmul flops against JAX's hlo_cost ------------------------------------

_JAX_FLOPS = textwrap.dedent("""
    import json, sys
    import jax
    import numpy as np
    from repro.configs import get_arch
    from repro.configs.gnn_family import GNN_SMOKE_CELLS
    from repro.configs.lm_family import LM_SMOKE_CELLS
    from repro.configs.recsys_family import RECSYS_SMOKE_CELLS
    from repro.distributed.sharding import use_mesh_rules
    from repro.launch.hlo_cost import hlo_cost

    cells = {"lm": LM_SMOKE_CELLS, "gnn": GNN_SMOKE_CELLS,
             "recsys": RECSYS_SMOKE_CELLS}
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    out = {}
    for case in sys.argv[1:]:
        arch, name = case.split(":")
        spec = get_arch(arch)
        cell = next(c for c in cells[spec.family] if c.name == name)
        low = spec.build(spec.make_config(False), cell, mesh)
        with use_mesh_rules(mesh, low.rules):
            compiled = jax.jit(low.fn).lower(*low.args).compile()
        out[case] = hlo_cost(compiled.as_text())["flops"]
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_flops():
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _JAX_FLOPS, *FLOP_CELLS],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=300)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", FLOP_CELLS)
def test_matmul_flops_equal_jax_hlo_cost(jax_flops, case):
    arch, name = case.split(":")
    spec = get_arch(arch)
    with fake_card():
        mesh = virtual_mesh((1, 1), ("data", "model"), FAKE_CARD)
    prog = spec.build(spec.make_config(False), _smoke_cell(spec, name), mesh)
    gc = graph_cost(trace_program(prog, mesh))
    assert sum(gc["matmul_flops_by_dtype"].values()) == jax_flops[case]
    assert jax_flops[case] > 0


# -- the kernels' bounds at PERF.md's table shapes ----------------------------

N_DB, D, KNN_K, K_PRED = 1_048_576, 20, 10, 5
# (work formula, its arguments) -> (bytes, fp32 flops[, dot ops]) and the
# bound in ms, as chip_smoke.py computed them before the formulas moved
BOUNDS = [
    ("fused_work", (32, 1024, 8, 64), (1197056, 524288), 0.000357),
    ("fused_work", (64, 100_000, 5, 50), (153626880, 64000000), 0.045859),
    ("rank_work", (32, 1024, 8, 64), (1207552, 561152), 0.000360),
    ("rank_work", (256, 1_048_576, 5, 50), (6442621952, 2684508160),
     1.923171),
    ("linear_work", (32, 1024, 8, 64, D), (1210784, 571392), 0.000361),
    ("topk_work", (32, N_DB, D, KNN_K), (83891200, 1484783616), 0.025042),
    ("sweep_work", (32, N_DB, D, KNN_K, K_PRED), (83895680, 1484783616),
     0.025043),
    ("knn_work", (32, N_DB, 1024, 8, 64, D, KNN_K, K_PRED),
     (85103616, 1485344768), 0.025404),
    ("knn_work", (256, 65536, 1_048_576, 5, 50, D, KNN_K, K_PRED),
     (6447941632, 3408549888), 1.924759),
    ("quant_sweep_work", (32, N_DB, "int8", D, KNN_K, K_PRED),
     (25183744, 167772160, 1342177280), 0.007518),
    ("quant_sweep_work", (32, N_DB, "bf16", D, KNN_K, K_PRED),
     (46155264, 134217728, 1342177280), 0.013778),
    ("quant_knn_work", (32, N_DB, 1024, 8, 64, "int8", D, KNN_K, K_PRED),
     (26391680, 168333312, 1342177280), 0.007878),
    ("quant_knn_work", (32, N_DB, 1024, 8, 64, "bf16", D, KNN_K, K_PRED),
     (47363200, 134778880, 1342177280), 0.014138),
]


@pytest.mark.parametrize("name,args,work,ms", BOUNDS,
                         ids=[f"{b[0]}-{i}" for i, b in enumerate(BOUNDS)])
def test_bounds_at_the_kernel_table_shapes_are_unchanged(name, args, work,
                                                         ms):
    got = getattr(roofline, name)(*args)
    assert got == work
    mode = "bf16" if "bf16" in args else "int8"
    bms, by = roofline.bound(*got, mode=mode)
    assert round(bms, 6) == ms and by == "bytes"
