"""Multi-pod dry run of the port (counterpart of repro.launch.dryrun):
trace every (arch x cell x mesh) program and cost it for one H100 of
the mesh.

Per cell:
  program = spec.build(cfg, cell, mesh)          # ArgSpec trees, rules
  walk = graph_cost.trace_program(program, mesh)  # shape-only run
  memory_analysis / graph_cost / collective bytes / op census

The meshes are JAX's production shapes, (16, 16) ('data', 'model') and
(2, 16, 16) ('pod', 'data', 'model'), as launch.mesh.virtual_mesh over
one fake card (the meta device): no card and no 512 devices are needed,
and the whole run goes on a CPU. A record lands in
experiments/dryrun_torch/<mesh>/<arch>__<cell>.json. It keeps JAX's keys
where they mean the same thing, with `trace_s` (the walk's seconds)
where JAX has lower_s / compile_s, `graph_cost` where JAX has hlo_cost,
`fits` (per_device_bytes within the card's 80 GB) and `fits_arguments`
(the arguments' blocks alone within it). A partitioned program (the
GNN's, the dense LMs' and the paper cells' builds: shard bodies, one a
block or a mesh position; the paper's offline_dual reshards its users
and items once by an all-to-all over 'model', its serve cells gather
each shard's candidates over 'model', and the dist-topk variant's serve
cells hand them to the merging device) is traced one body for all
(graph_cost.trace_program's one_body) and costed per device. A global
program (the recsys builds and the MoE LMs: the port has no SPMD
partitioner) is costed as its
whole walk over the device count and says "partitioned": false; its
temp bytes, and so per_device_bytes and `fits`, are estimates, which
the record lists under "estimated". `fits_arguments` is exact: a cell
whose arguments do not fit cannot fit, whatever its temp.
Failures are recorded (and are bugs to fix), counted, and make the run
exit 1.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --cell train_4k --mesh multi [--smoke] [--force] [--variant opt]
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import time
import traceback

from repro_torch.configs import all_archs, get_arch
from repro_torch.launch.graph_analysis import (
    collective_bytes,
    memory_analysis,
    op_census,
)
from repro_torch.launch.graph_cost import (
    FAKE_CARD,
    fake_card,
    graph_cost,
    trace_program,
)
from repro_torch.launch.mesh import make_smoke_mesh, virtual_mesh
from repro_torch.launch.roofline import (
    HBM_BYTES,
    model_flops,
    terms_from_artifact,
)

DEFAULT_OUT = "experiments/dryrun_torch"


def production_mesh(*, multi_pod: bool = False):
    """JAX's production mesh shape, virtual over the fake card."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    with fake_card():
        return virtual_mesh(shape, axes, FAKE_CARD)


def smoke_mesh(*, multi_pod: bool = False):
    """make_smoke_mesh's (2, 4) or (2, 2, 2), virtual over the fake
    card."""
    with fake_card():
        return make_smoke_mesh(multi_pod=multi_pod, device=FAKE_CARD)


def _smoke_cell(spec, cell_name):
    from repro_torch.configs.gnn_family import GNN_SMOKE_CELLS
    from repro_torch.configs.lm_family import LM_SMOKE_CELLS
    from repro_torch.configs.paper import PAPER_SMOKE_CELLS
    from repro_torch.configs.recsys_family import RECSYS_SMOKE_CELLS
    table = {"lm": LM_SMOKE_CELLS, "gnn": GNN_SMOKE_CELLS,
             "recsys": RECSYS_SMOKE_CELLS, "paper": PAPER_SMOKE_CELLS}
    return next(c for c in table[spec.family] if c.name == cell_name)


def run_cell(arch_name: str, cell_name: str, mesh, mesh_tag: str,
             *, smoke: bool = False, variant: str | None = None,
             one_body: bool = True) -> dict:
    """The cell's record; `one_body` as trace_program's (a partitioned
    program's first body stands for every body's: the same record in
    about one body's time)."""
    spec = get_arch(arch_name)
    cell = _smoke_cell(spec, cell_name) if smoke else spec.cell(cell_name)
    cfg = spec.variants[variant]() if variant else spec.make_config(
        not smoke)
    record = {
        "arch": arch_name, "cell": cell_name, "kind": cell.kind,
        "mesh": mesh_tag, "mesh_shape": list(mesh.devices.shape),
        "mesh_devices": int(mesh.devices.size), "smoke": smoke,
        "variant": variant,
        "cell_params": {k: (list(v) if isinstance(v, tuple) else v)
                        for k, v in cell.params.items()},
        "status": "error",
    }
    program = spec.build(cfg, cell, mesh)
    t0 = time.perf_counter()
    walk = trace_program(program, mesh, one_body=one_body)
    record["trace_s"] = round(time.perf_counter() - t0, 2)

    record["memory_analysis"] = ma = memory_analysis(walk)
    record["graph_cost"] = graph_cost(walk)
    record["collective_bytes"] = collective_bytes(walk, cell.kind)
    record["op_census"] = op_census(walk)
    record["unread_leaves"] = sorted(
        f"{i}/{path}" for (i, path) in walk.arg_specs
        if (i, path) not in walk.read_leaves())
    record["per_device_bytes"] = int(
        ma["argument_size_in_bytes"] + ma["temp_size_in_bytes"]
        + ma["output_size_in_bytes"] - ma["alias_size_in_bytes"])
    record["fits"] = record["per_device_bytes"] <= HBM_BYTES
    # the arguments' blocks are exact: a hard bound beside the estimate
    record["fits_arguments"] = ma["argument_size_in_bytes"] <= HBM_BYTES
    if "estimated" in ma:
        record["estimated"] = ["per_device_bytes", "fits"]
    mf = model_flops(arch_name, cfg, cell)
    if mf is not None:
        record["model_flops"] = mf
    record["roofline"] = terms_from_artifact(record).as_dict()
    record["status"] = "ok"
    return record


def save_record(record: dict, out_dir: str):
    d = os.path.join(out_dir, record["mesh"])
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{record['arch']}__{record['cell']}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--cell", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs + 8-device meshes (plumbing test)")
    ap.add_argument("--force", action="store_true",
                    help="recompute cells that already have records")
    ap.add_argument("--variant", default=None,
                    help="named optimized config variant (§Perf hillclimb)")
    args = ap.parse_args()

    archs = all_archs() if args.arch == "all" else args.arch.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    n_ok = n_fail = n_skip = 0
    t_run = time.perf_counter()
    for multi in meshes:
        mesh_tag = ("smoke_" if args.smoke else "") + (
            "multi" if multi else "single")
        if args.variant:
            mesh_tag = f"{mesh_tag}@{args.variant}"
        mesh = (smoke_mesh(multi_pod=multi) if args.smoke
                else production_mesh(multi_pod=multi))
        for arch in archs:
            spec = get_arch(arch)
            cells = ([c.name for c in spec.cells] if args.cell == "all"
                     else args.cell.split(","))
            for cell in cells:
                if cell not in [c.name for c in spec.cells]:
                    continue
                if args.variant and args.variant not in spec.variants:
                    continue
                path = os.path.join(args.out, mesh_tag, f"{arch}__{cell}.json")
                if os.path.exists(path) and not args.force:
                    with open(path) as f:
                        if json.load(f).get("status") == "ok":
                            n_skip += 1
                            continue
                try:
                    rec = run_cell(arch, cell, mesh, mesh_tag,
                                   smoke=args.smoke, variant=args.variant)
                    n_ok += 1
                except Exception as e:
                    rec = {
                        "arch": arch, "cell": cell, "mesh": mesh_tag,
                        "mesh_devices": int(mesh.devices.size),
                        "smoke": args.smoke, "status": "error",
                        "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-3000:],
                    }
                    n_fail += 1
                save_record(rec, args.out)
                gc.collect()        # the walk's log goes with its cell
                if rec["status"] == "ok":
                    r = rec["roofline"]
                    print(f"[{mesh_tag}] {arch}/{cell}: OK "
                          f"trace {rec['trace_s']}s "
                          f"| compute {r['compute_s']:.3e}s "
                          f"memory {r['memory_s']:.3e}s "
                          f"coll {r['collective_s']:.3e}s "
                          f"-> {r['dominant']} | "
                          f"{rec['per_device_bytes'] / 1e9:.2f} GB a card"
                          f"{' (estimated)' if 'estimated' in rec else ''}"
                          f"{'' if rec['fits'] else ', does not fit'}",
                          flush=True)
                else:
                    print(f"[{mesh_tag}] {arch}/{cell}: FAIL {rec['error']}",
                          flush=True)
    print(f"dry-run done: {n_ok} ok, {n_fail} failed, {n_skip} cached in "
          f"{time.perf_counter() - t_run:.1f} s")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
