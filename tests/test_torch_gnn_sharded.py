"""The partitioned GNN step (models.gnn's shard bodies over the
('pod', 'data') blocks of GNN_RULES, the mesh collectives of
distributed.topk between them) held against the port's global step
and against JAX's build_gnn program partitioned by GSPMD, on the CPU at
SMOKE, for the four GNN_SMOKE_CELLS on virtual (2, 4) and (2, 2, 2)
meshes.

JAX's side runs once a module, in a subprocess a mesh (side by side)
with 8 forced host devices (the meshes' axes of type Auto, as
tests/test_torch_cell_programs.py builds them): each cell's `low.fn`
under jit on JAX's init(key(0)) and on a graph drawn here with numpy
from a seed. The port runs build_gnn's program on the same arrays on
virtual meshes over the CPU. No JAX is imported here: the `cuda` test
runs with --noconftest on a machine with cards.

Tolerances, those of tests/test_torch_cell_programs.py: the loss and
grad_norm rtol 1e-5; the new parameters rtol 1e-5, atol lr * 1e-3
where the gradient |g| is above 3e-6 (below it Adam's first step,
lr * g / (|g| + 1e-8), turns a gradient's rounding into a step that
differs by more) and within the step's bound, 2 * lr, elsewhere; Adam's
first moments rtol 1e-4, atol 1e-7, its second rtol 2e-4, atol 1e-12;
the step counter exactly. The aggregate's partitioned max exactly (-inf
on a node that receives nothing included), its sum and mean rtol 1e-6,
atol 1e-6, their gradients rtol 1e-6, atol 1e-7. The collectives'
backwards pass torch.autograd.gradcheck in float64. Two calls of the
partitioned step give the same bits.
"""

import os
import subprocess
import sys
import tempfile
import textwrap
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.store import flatten_with_paths
from repro_torch.configs import get_arch
from repro_torch.configs.gnn_family import (
    GNN_SMOKE_CELLS,
    build_gnn,
    cell_config,
    graph_sizes,
    pad_graph,
)
from repro_torch.configs.registry import args_from_numpy, pad_up
from repro_torch.distributed.sharding import GNN_RULES, use_mesh_rules
from repro_torch.distributed.topk import (
    all_gather_rows,
    psum,
    reduce_scatter_rows,
)
from repro_torch.launch.mesh import make_mesh, make_smoke_mesh, virtual_mesh
from repro_torch.models import gnn

REPO = Path(__file__).resolve().parent.parent
MESHES = ("2x4", "2x2x2")
LR = 1e-3
LOSS_TOL = dict(rtol=1e-5, atol=0)
MU_TOL = dict(rtol=1e-4, atol=1e-7)
NU_TOL = dict(rtol=2e-4, atol=1e-12)
SURE_GRAD = 3e-6
AGG_TOL = dict(rtol=1e-6, atol=1e-6)
AGG_GRAD_TOL = dict(rtol=1e-6, atol=1e-7)
CELLS = [c.name for c in GNN_SMOKE_CELLS]

_PROG = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import numpy as np

    from repro.checkpoint.store import _flatten_with_paths
    from repro.configs import get_arch
    from repro.configs.gnn_family import GNN_SMOKE_CELLS, cell_config
    from repro.distributed.sharding import use_mesh_rules
    from repro.models.gnn import MeshGraphNet
    from repro.optim import adam_init

    src, dst, only = sys.argv[1], sys.argv[2], sys.argv[3]
    x = dict(np.load(src))
    out = {}

    def auto_mesh(shape, axes):
        return jax.make_mesh(shape, axes, axis_types=(
            jax.sharding.AxisType.Auto,) * len(axes))

    meshes = {"2x4": auto_mesh((2, 4), ("data", "model")),
              "2x2x2": auto_mesh((2, 2, 2), ("pod", "data", "model"))}
    spec = get_arch("meshgraphnet")
    cfg = spec.make_config(False)
    for mname, mesh in meshes.items():
        if mname != only:
            continue
        for cell in GNN_SMOKE_CELLS:
            low = spec.build(cfg, cell, mesh)
            params = MeshGraphNet(cell_config(cfg, cell)).init(
                jax.random.key(0))
            graph = {k[len(cell.name) + 1:]: v for k, v in x.items()
                     if k.startswith(cell.name + "|")}
            flat, _ = _flatten_with_paths(params)
            for p, v in flat.items():
                out["|".join((cell.name, "init", p))] = np.asarray(v)
            with use_mesh_rules(mesh, low.rules):
                res = jax.jit(low.fn)(params, adam_init(params), graph)
            flat, _ = _flatten_with_paths(res)
            for p, v in flat.items():
                out["|".join((mname, cell.name, p))] = np.asarray(v)
    np.savez(dst, **out)
    print("done")
""")


def _mesh(name, device="cpu"):
    return make_smoke_mesh(multi_pod=name == "2x2x2", device=device)


def _cell(name):
    return next(c for c in GNN_SMOKE_CELLS if c.name == name)


def _graph(cell, seed=0):
    """The cell's padded graph (or batch of graphs) as numpy arrays:
    real nodes and edges drawn from a seed, then pad_graph's padding."""
    rng = np.random.default_rng(seed)
    n, e = graph_sizes(cell)
    lead = (cell["batch"],) if cell.kind == "train_batched" else ()
    g = {"nodes": rng.normal(size=lead + (n, cell["d_feat"])),
         "edges": rng.normal(size=lead + (e, 8)),
         "senders": rng.integers(0, n, lead + (e,)),
         "receivers": rng.integers(0, n, lead + (e,)),
         "targets": rng.normal(size=lead + (n, cell["d_out"]))}
    if cell.kind == "train_sampled":
        mask = np.zeros(n)
        mask[:cell["batch_nodes"]] = 1.0
        g["node_mask"] = mask
    g = {k: torch.from_numpy(np.asarray(
        v, np.int32 if k in ("senders", "receivers") else np.float32))
        for k, v in g.items()}
    return {k: v.numpy() for k, v in pad_graph(g, pad_up(n),
                                                pad_up(e)).items()}


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's initial parameters and its partitioned step's outputs for
    every cell on both meshes, from a subprocess a mesh."""
    graphs = {c: _graph(_cell(c)) for c in CELLS}
    x = {f"{c}|{k}": v for c, g in graphs.items() for k, v in g.items()}
    out = {}
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "in.npz")
        np.savez(src, **x)
        env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
        runs = []
        for name in MESHES:
            dst = os.path.join(d, f"{name}.npz")
            runs.append((dst, subprocess.Popen(
                [sys.executable, "-c", _PROG, src, dst, name],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env, cwd=REPO)))
        for dst, proc in runs:
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, stdout + "\n" + stderr
            out.update(np.load(dst))
    return graphs, out


def _program(name, cell_name, want, graphs):
    """build_gnn's program on a virtual CPU mesh and its arguments:
    JAX's initial parameters, Adam's zero state, the seeded graph."""
    cfg = get_arch("meshgraphnet").make_config(False)
    cell = _cell(cell_name)
    prog = build_gnn(cfg, cell, _mesh(name))
    params = args_from_numpy(prog.args[0], {
        p: want[f"{cell_name}|init|{p}"]
        for p in flatten_with_paths(prog.args[0])}, device="cpu")
    graph = args_from_numpy(prog.args[2], graphs[cell_name], device="cpu")
    return prog, cell_config(cfg, cell), params, graph


def _check_step(got, ref, msg, lr=LR):
    """A train step's outputs (params, opt, metrics) against another's
    (params, opt, metrics), numpy trees or tensors, at the module's
    tolerances; the gradient is ref's first moment over 0.1."""
    def np_(t):
        return {k: np.asarray(torch.as_tensor(v).detach().float())
                for k, v in flatten_with_paths(t).items()}

    gp, rp = np_(got[0]), np_(ref[0])
    gmu, rmu = np_(got[1].mu), np_(ref[1].mu)
    gnu, rnu = np_(got[1].nu), np_(ref[1].nu)
    for k in rp:
        sure = np.abs(rmu[k]) / 0.1 > SURE_GRAD
        np.testing.assert_allclose(gp[k][sure], rp[k][sure], rtol=1e-5,
                                   atol=lr * 1e-3, err_msg=f"{msg} {k}")
        assert np.all(np.abs(gp[k] - rp[k]) <= 2 * lr), (msg, k)
        np.testing.assert_allclose(gmu[k], rmu[k], **MU_TOL,
                                   err_msg=f"{msg} mu {k}")
        np.testing.assert_allclose(gnu[k], rnu[k], **NU_TOL,
                                   err_msg=f"{msg} nu {k}")
    assert int(got[1].step) == int(ref[1].step) == 1
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got[2][name]), float(ref[2][name]),
                                   **LOSS_TOL, err_msg=f"{msg} {name}")


class _JaxStep:
    """JAX's outputs of one cell on one mesh as the (params, opt,
    metrics) a port step returns."""

    def __init__(self, want, name, cell, like):
        pre = f"{name}|{cell}|"
        at = {k[len(pre):]: v for k, v in want.items() if k.startswith(pre)}
        keys = flatten_with_paths(like)
        self.params = {p: at[f"0/{p}"] for p in keys}
        self.opt = type("Opt", (), {
            "mu": {p: at[f"1/.mu/{p}"] for p in keys},
            "nu": {p: at[f"1/.nu/{p}"] for p in keys},
            "step": at["1/.step"]})()
        self.metrics = {m: at[f"2/{m}"] for m in ("loss", "grad_norm")}

    def __iter__(self):
        return iter((self.params, self.opt, self.metrics))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("name", MESHES)
def test_partitioned_step_matches_global_and_jax(jax_ref, name, cell):
    """build_gnn's program on the mesh runs shard bodies (an all-gather
    a processor step, or for molecule none) and gives the global step's
    loss, grad_norm, parameters and moments, and JAX's partitioned
    program's."""
    graphs, want = jax_ref
    prog, ccfg, params, graph = _program(name, cell, want, graphs)
    opt = gnn.gnn_adam_init(params)
    with use_mesh_rules(_mesh(name), prog.rules):
        plan = gnn.graph_plan(graph)
    assert plan is not None and plan.n == (2 if name == "2x4" else 4)
    assert plan.batched == (cell == "molecule")
    got = prog.fn(params, opt, graph)
    glob = gnn.gnn_train_step(params, opt, graph, ccfg)
    _check_step(got, glob, f"{name} {cell} vs global")
    _check_step(got, tuple(_JaxStep(want, name, cell, params)),
                f"{name} {cell} vs JAX")


@pytest.fixture
def deterministic():
    """torch's deterministic algorithms for the test's length (the CPU's
    index_put(accumulate=True) adds on several threads otherwise)."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("name", MESHES)
def test_partitioned_step_is_bitwise_run_to_run(jax_ref, deterministic, name,
                                                cell):
    graphs, want = jax_ref
    prog, _, params, graph = _program(name, cell, want, graphs)
    opt = gnn.gnn_adam_init(params)
    a, b = (prog.fn(params, opt, graph) for _ in range(2))
    for x, y in ((a[0], b[0]), (a[1].mu, b[1].mu), (a[1].nu, b[1].nu),
                 (a[2], b[2])):
        fx, fy = flatten_with_paths(x), flatten_with_paths(y)
        for k in fx:
            assert torch.equal(fx[k], fy[k]), (name, cell, k)


# -- the aggregators, with a node that receives nothing -----------------------

N_AGG, E_AGG, D_AGG = 16, 48, 5
EMPTY = 3          # the node no edge reaches


def _agg_graph(seed, mode):
    """A graph of N_AGG nodes and E_AGG edges. For sum and mean node
    EMPTY receives nothing; for max every node receives (a node that
    receives nothing makes the network's output -inf there, NaN after
    its MLP), and edges k and k + E_AGG / 2 are one edge twice, so their
    messages tie in two different blocks."""
    rng = np.random.default_rng(seed)
    nodes = np.arange(N_AGG)
    if mode == "max":
        recv = np.concatenate([nodes, rng.integers(0, N_AGG,
                                                   E_AGG // 2 - N_AGG)])
        send = rng.integers(0, N_AGG, E_AGG // 2)
        recv, send = np.tile(recv, 2), np.tile(send, 2)
        edges = np.tile(rng.normal(size=(E_AGG // 2, 4)), (2, 1))
    else:
        recv = rng.choice(nodes[nodes != EMPTY], E_AGG)
        send = rng.integers(0, N_AGG, E_AGG)
        edges = rng.normal(size=(E_AGG, 4))
    return {"nodes": torch.from_numpy(rng.normal(size=(N_AGG, 6))).float(),
            "edges": torch.from_numpy(edges).float(),
            "senders": torch.from_numpy(send).int(),
            "receivers": torch.from_numpy(recv).int(),
            "targets": torch.from_numpy(rng.normal(size=(N_AGG, 3))).float()}


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("name", MESHES)
def test_aggregators_partitioned_equal_global(name, mode):
    """The partials of each block's edges reduce-scattered to the node
    blocks give aggregate's values (max exactly, -inf on the node that
    receives nothing) and gradients, ties across blocks splitting
    evenly; the partitioned train step at each aggregator gives the
    global one's."""
    mesh = _mesh(name)
    S = 2 if name == "2x4" else 4
    plan = gnn.GraphPlan(mesh, ("data",) if S == 2 else ("pod", "data"),
                         S, False)
    rng = np.random.default_rng(5)
    recv = torch.from_numpy(rng.choice(
        np.delete(np.arange(N_AGG), EMPTY), E_AGG)).long()
    msgs = torch.from_numpy(rng.normal(size=(E_AGG, D_AGG)))
    msgs[E_AGG // 2:] = msgs[:E_AGG // 2]            # ties across blocks
    recv[E_AGG // 2:] = recv[:E_AGG // 2]
    msgs[1], recv[1] = msgs[0], recv[0]               # and within one
    w = torch.from_numpy(rng.normal(size=(N_AGG, D_AGG)))
    rows = E_AGG // S

    def grads(fn):
        x = msgs.clone().requires_grad_(True)
        out = fn(x)
        keep = torch.isfinite(out)
        torch.sum(torch.where(keep, out, 0.0) * w).backward()
        return out.detach(), x.grad

    want, want_g = grads(lambda x: gnn.aggregate(x, recv, N_AGG, mode))
    got, got_g = grads(lambda x: torch.cat(gnn._reduced(
        [gnn._partial(x[i * rows:(i + 1) * rows],
                      recv[i * rows:(i + 1) * rows], N_AGG, mode)
         for i in range(S)], mode, plan)))
    if mode == "max":
        assert torch.equal(got, want)
        assert bool(torch.all(got[EMPTY] == -torch.inf))
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), **AGG_TOL)
    np.testing.assert_allclose(got_g.numpy(), want_g.numpy(),
                               **AGG_GRAD_TOL)

    base = get_arch("meshgraphnet").make_config(False)
    cfg = replace(base, aggregator=mode, d_node_in=6, d_edge_in=4, d_out=3)
    params = gnn.gnn_init(torch.Generator().manual_seed(1), cfg,
                          device="cpu")
    opt = gnn.gnn_adam_init(params)
    graph = _agg_graph(2, mode)
    glob = gnn.gnn_train_step(params, opt, graph, cfg)
    with use_mesh_rules(mesh, GNN_RULES):
        assert gnn.graph_plan(graph) is not None
        got = gnn.gnn_train_step(params, opt, graph, cfg)
    assert np.isfinite(float(got[2]["loss"]))
    _check_step(got, glob, f"{name} {mode}")


def test_no_context_or_one_block_runs_the_global_step():
    """Without a context, on a one-block mesh, or where the blocks do
    not divide the nodes, graph_plan is None and the global step runs."""
    graph = _agg_graph(0, "sum")
    assert gnn.graph_plan(graph) is None
    one = virtual_mesh((1, 8), ("data", "model"), "cpu")
    with use_mesh_rules(one, GNN_RULES):
        assert gnn.graph_plan(graph) is None
    odd = dict(graph, nodes=graph["nodes"][:15])
    with use_mesh_rules(_mesh("2x2x2"), GNN_RULES):
        assert gnn.graph_plan(odd) is None
        assert gnn.graph_plan(graph).axes == ("pod", "data")


# -- the collectives against their definitions ----------------------------------

def _blocks(S, rows=4, cols=3, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(rows, cols))).requires_grad_(
        True) for _ in range(S)]


@pytest.mark.parametrize("op", ["all_gather", "reduce_scatter", "max",
                                "psum"])
@pytest.mark.parametrize("name", MESHES)
def test_collectives_pass_gradcheck_and_their_definition(name, op):
    mesh = _mesh(name)
    axes = ("data",) if name == "2x4" else ("pod", "data")
    S = 2 if name == "2x4" else 4
    if op == "all_gather":
        xs = _blocks(S)
        fn = lambda *b: tuple(all_gather_rows(mesh, axes, b))   # noqa: E731
        want = [torch.cat(xs)] * S
    elif op == "reduce_scatter":
        xs = _blocks(S, rows=4 * S)
        fn = lambda *p: tuple(reduce_scatter_rows(mesh, axes, p))  # noqa
        want = list(torch.chunk(sum(xs), S))
    elif op == "max":
        xs = _blocks(S, rows=4 * S)
        counts = [torch.ones_like(x) for x in xs]
        fn = lambda *p: tuple(reduce_scatter_rows(  # noqa: E731
            mesh, axes, p, "max", counts=counts))
        want = list(torch.chunk(torch.stack(xs).amax(0), S))
    else:
        xs = _blocks(S, rows=2)
        fn = lambda *x: tuple(psum(mesh, axes, x))   # noqa: E731
        want = [sum(xs)] * S
    got = fn(*xs)
    assert len(got) == S
    for g, w in zip(got, want):
        assert torch.equal(g, w.detach())
    assert torch.autograd.gradcheck(fn, tuple(xs))


# -- a mesh across cards --------------------------------------------------------

@pytest.mark.cuda
def test_a_mesh_across_cards_equals_a_virtual_one_for_the_gnn_step():
    """With two or more cards, the partitioned step on an (n, 1) mesh
    across cards (each shard body on its own card) gives the bits of
    the same step on a virtual (n, 1) mesh over one card. Skips on one
    card and without one."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    n = torch.cuda.device_count()
    card = torch.device("cuda", 0)
    cell = _cell("ogb_products")
    cfg = cell_config(get_arch("meshgraphnet").make_config(False), cell)
    params = gnn.gnn_init(torch.Generator(device=card).manual_seed(3), cfg,
                          device=card)
    opt = gnn.gnn_adam_init(params)
    graph = {k: torch.from_numpy(v).to(card) for k, v in _graph(cell).items()}
    outs = {}
    axes = ("data", "model")
    for label, mesh in (("cards", make_mesh((n, 1), axes)),
                        ("virtual", virtual_mesh((n, 1), axes, card))):
        with use_mesh_rules(mesh, GNN_RULES):
            assert gnn.graph_plan(graph).n == n
            outs[label] = gnn.gnn_train_step(params, opt, graph, cfg)
    for x, y in zip(outs["cards"], outs["virtual"]):
        fx, fy = flatten_with_paths(x), flatten_with_paths(y)
        for k in fy:
            assert fx[k].device == card and torch.equal(fx[k], fy[k]), k
