"""The port's GNN half of the zoo (models.gnn, the graph makers of
data.batches, configs.gnn_family / configs.meshgraphnet) held against
the JAX package's at the SMOKE config's widths (3 layers, d_hidden 32),
on JAX's init(key(0)) carried across with load_numpy and on JAX's own
graphs and draws. JAX's side is built once for the module.

Tolerances: aggregate's max exactly (-inf on an empty segment
included), its sum and mean rtol=1e-6, atol=1e-6 (index_put adds in
another order than XLA's scatter), the gradient of max on ties
exactly; the forward and the loss rtol=1e-5, atol=1e-5 (the MLPs'
LayerNorm is jnp.var then rsqrt, and XLA's CPU rsqrt need not round as
torch's does); every gradient leaf rtol=1e-4, atol=1e-6; one train step
(clip, then Adam) as test_torch_recsys.py holds the recsys backbones:
the parameters rtol=1e-5, atol=1e-7 against JAX's clip and Adam on the
port's own gradients and grad_norm rtol=1e-6; against JAX's whole step (JAX's
gradients) rtol=1e-5, atol=lr*1e-3 wherever JAX's gradient is at least
1e-7. Below that a gradient is rounding noise: Adam's first step moves
a weight by lr*g/(|g|+1e-8), and this graph has gradients of 1e-10 to
3e-9 (nearly dead ReLU units) that the two evaluation orders round
20-30% apart, which moves those weights up to lr*0.04 apart; there the
step is only held within its bound, 2*lr. The sampler's body on JAX's
uniforms, the CSR graph from JAX's seed and the edge features of a
graph from JAX's draws are exact; remat on and off are bitwise equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_arch as jax_get_arch
from repro.configs.gnn_family import D_EDGE as JAX_D_EDGE
from repro.configs.gnn_family import GNN_CELLS as JAX_CELLS
from repro.configs.gnn_family import GNN_SMOKE_CELLS as JAX_SMOKE_CELLS
from repro.configs.gnn_family import cell_config as jax_cell_config
from repro.core.constraints import dcg_discount as jax_dcg_discount
from repro.core.dual_solver import serve_rank as jax_serve_rank
from repro.data.batches import make_csr_graph as jax_make_csr_graph
from repro.data.batches import make_molecule_batch as jax_molecule
from repro.data.batches import make_random_graph as jax_random_graph
from repro.models.gnn import MeshGraphNet as JaxMGN
from repro.models.gnn import aggregate as jax_aggregate
from repro.models.gnn import block_graph_from_sample as jax_block_graph
from repro.models.gnn import neighbor_sample as jax_neighbor_sample
from repro.models.gnn import sampled_sizes as jax_sampled_sizes
from repro.optim import adam_init as jax_adam_init
from repro.optim import adam_update as jax_adam_update
from repro.optim.clip import clip_by_global_norm as jax_clip
from repro_torch.checkpoint.store import flatten_with_paths
from repro_torch.configs import get_arch
from repro_torch.configs.gnn_family import (
    D_EDGE,
    GNN_CELLS,
    GNN_SMOKE_CELLS,
    build_gnn,
    cell_config,
)
from repro_torch.core.constraints import dcg_discount
from repro_torch.core.dual_solver import serve_rank
from repro_torch.data.batches import (
    csr_from_seed,
    make_csr_graph,
    make_molecule_batch,
    make_random_graph,
    random_graph_from_draws,
)
from repro_torch.models.gnn import (
    MeshGraphNet,
    aggregate,
    block_graph_from_sample,
    gnn_grads,
    neighbor_sample,
    sample_from_uniforms,
    sampled_sizes,
)

CPU = "cpu"
AGG_TOL = dict(rtol=1e-6, atol=1e-6)
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
STEP_TOL = dict(rtol=1e-5, atol=1e-7)
LR = 3e-3
E2E_STEP_TOL = dict(rtol=1e-5, atol=LR * 1e-3)
NOISE_GRAD = 1e-7
GNORM_RTOL = 1e-6
N_NODES, N_EDGES, D_NODE, D_EDGE_IN, D_OUT = 30, 80, 8, 4, 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _smoke_cfgs(**kw):
    """(the port's, JAX's) SMOKE config at the test graph's widths."""
    widths = dict(d_node_in=D_NODE, d_edge_in=D_EDGE_IN, d_out=D_OUT, **kw)
    cfg = get_arch("meshgraphnet").make_config(full=False)
    jcfg = jax_get_arch("meshgraphnet").make_config(full=False)
    return (dataclasses.replace(cfg, **widths),
            dataclasses.replace(jcfg, **widths))


def _jax_clip_adam(grads, params):
    """JAX's clip at global norm 1, then one Adam step from zeros."""
    clipped, gnorm = jax_clip(grads, 1.0)
    stepped, _ = jax_adam_update(clipped, jax_adam_init(params), params,
                                 lr=LR)
    return stepped, gnorm


@pytest.fixture(scope="module")
def jax_side():
    """JAX's model, init(key(0)), a random graph and what its forward,
    loss and gradients give, and JAX's whole train step (value_and_grad,
    clip, Adam: the body of MeshGraphNet.train_step) from them, once."""
    _, jcfg = _smoke_cfgs()
    jmodel = JaxMGN(jcfg)
    params = jmodel.init(jax.random.key(0))
    g = jax_random_graph(jax.random.key(1), n_nodes=N_NODES,
                         n_edges=N_EDGES, d_node=D_NODE, d_edge=D_EDGE_IN,
                         d_out=D_OUT)

    def loss_and_forward(p):
        loss, _ = jmodel.loss(p, g)
        return loss, jmodel.forward(p, g)

    (loss, fwd), grads = jax.jit(jax.value_and_grad(
        loss_and_forward, has_aux=True))(params)
    stepped, gnorm = jax.jit(_jax_clip_adam)(grads, params)
    return {"model": jmodel, "params": params, "graph": g,
            "forward": np.asarray(fwd), "loss": np.asarray(loss),
            "grads": _np(grads), "grad_norm": np.asarray(gnorm),
            "stepped": _np(stepped)}


def _port_model(jax_side, **kw):
    cfg, _ = _smoke_cfgs(**kw)
    return MeshGraphNet(cfg, device=CPU).load_numpy(_np(jax_side["params"]))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).detach()),
                               np.asarray(want), **tol)


# --------------------------------------------------------------------------
# Configs
# --------------------------------------------------------------------------

def _cells(cells):
    return [(c.name, c.kind, dict(c.params)) for c in cells]


def test_config_and_cells_match_jax():
    spec, jspec = get_arch("meshgraphnet"), jax_get_arch("meshgraphnet")
    assert spec.family == jspec.family == "gnn"
    assert spec.build is build_gnn and spec.notes == jspec.notes
    assert _cells(spec.cells) == _cells(jspec.cells) == _cells(GNN_CELLS)
    assert _cells(GNN_CELLS) == _cells(JAX_CELLS)
    assert _cells(GNN_SMOKE_CELLS) == _cells(JAX_SMOKE_CELLS)
    assert D_EDGE == JAX_D_EDGE
    fields = [f.name for f in dataclasses.fields(spec.make_config(True))
              if f.name not in ("dtype", "param_dtype")]
    for full in (True, False):
        cfg, jcfg = spec.make_config(full), jspec.make_config(full)
        for f in fields:
            assert getattr(cfg, f) == getattr(jcfg, f), (full, f)
        assert cfg.dtype == cfg.param_dtype == torch.float32
        assert cfg.n_params == jcfg.n_params
        for cell, jcell in zip(GNN_CELLS + GNN_SMOKE_CELLS,
                               JAX_CELLS + JAX_SMOKE_CELLS):
            c, jc = cell_config(cfg, cell), jax_cell_config(jcfg, jcell)
            assert (c.d_node_in, c.d_edge_in, c.d_out) == \
                (jc.d_node_in, jc.d_edge_in, jc.d_out)
            assert c.n_params == jc.n_params
    full = spec.make_config(True)
    assert (full.n_layers, full.d_hidden, full.mlp_layers, full.aggregator,
            full.remat) == (15, 128, 2, "sum", True)


# --------------------------------------------------------------------------
# aggregate
# --------------------------------------------------------------------------

AGG_NODES, AGG_EDGES = 12, 40


@settings(max_examples=25, deadline=None)
@given(recv=st.lists(st.integers(0, AGG_NODES - 1), min_size=AGG_EDGES,
                     max_size=AGG_EDGES).filter(
                         lambda r: len(set(r)) < AGG_NODES),
       seed=st.integers(0, 2**31 - 1))
def test_aggregate_matches_jax(recv, seed):
    """Hypothesis-drawn receivers: repeats, and empty segments (fewer
    distinct receivers than nodes). One shape, so JAX compiles once."""
    n_nodes = AGG_NODES
    msgs = np.random.default_rng(seed).normal(
        size=(AGG_EDGES, 5)).astype(np.float32)
    recv = np.asarray(recv, np.int32)
    for mode in ("sum", "mean", "max"):
        got = aggregate(torch.from_numpy(msgs), torch.from_numpy(recv),
                        n_nodes, mode).numpy()
        want = np.asarray(jax_aggregate(jnp.asarray(msgs), jnp.asarray(recv),
                                        n_nodes, mode))
        if mode == "max":
            np.testing.assert_array_equal(got, want)
            empty = np.setdiff1d(np.arange(n_nodes), recv)
            assert np.all(got[empty] == -np.inf)
        else:
            np.testing.assert_allclose(got, want, **AGG_TOL)


def test_aggregate_max_gradient_splits_ties_as_jax():
    msgs = np.array([[3., 5.], [3., 5.], [3., 2.], [0., 0.], [7., 7.]],
                    np.float32)
    recv = np.array([0, 0, 0, 2, 2], np.int32)
    w = np.array([[1., 2.], [3., 4.], [5., 6.]], np.float32)

    def jax_f(x):
        return jnp.sum(jax_aggregate(x, jnp.asarray(recv), 3, "max")[
            jnp.array([0, 2])] * w[[0, 2]])

    want = np.asarray(jax.grad(jax_f)(jnp.asarray(msgs)))
    x = torch.from_numpy(msgs).requires_grad_(True)
    out = aggregate(x, torch.from_numpy(recv), 3, "max")
    (out[[0, 2]] * torch.from_numpy(w[[0, 2]])).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), want)
    assert want[0, 0] == pytest.approx(1 / 3)


# --------------------------------------------------------------------------
# The network on JAX's parameters
# --------------------------------------------------------------------------

def test_params_carry_across_and_back(jax_side):
    model = _port_model(jax_side)
    flat_j = flatten_with_paths(_np(jax_side["params"]))
    flat_t = flatten_with_paths(model.state_numpy())
    assert list(flat_t) == list(flat_j)          # JAX's leaf order
    for k in flat_j:
        np.testing.assert_array_equal(flat_t[k], flat_j[k])
    names = {n for n, _ in model.named_parameters()}
    assert names == {k.replace("/", ".") for k in flat_j}
    assert {"node_encoder.w0", "edge_encoder.ln_scale",
            "processor.edge_mlp.w0", "processor.node_mlp.b2",
            "decoder.w2"} <= names
    assert model.params()["processor"]["edge_mlp"]["w0"].shape == \
        (3, 3 * 32, 32)                          # stacked on L


def test_forward_loss_and_gradients_match_jax(jax_side):
    model = _port_model(jax_side)
    g = _np(jax_side["graph"])
    out = model(g)
    assert out.shape == (N_NODES, D_OUT)
    _close(out, jax_side["forward"], **FWD_TOL)
    loss, metrics, grads = model.grads(g)
    _close(loss, jax_side["loss"], **FWD_TOL)
    assert metrics["loss"] is loss
    jg = flatten_with_paths(jax_side["grads"])
    tg = flatten_with_paths(grads)
    assert list(tg) == list(jg)
    for k in jg:
        _close(tg[k], jg[k], **GRAD_TOL)


def test_one_train_step_matches_jax(jax_side):
    params, g = jax_side["params"], jax_side["graph"]
    model = _port_model(jax_side)
    _, _, own = model.grads(_np(g))
    own = jax.tree.map(lambda t: jnp.asarray(t.numpy()), own)
    j_own, own_norm = jax.jit(_jax_clip_adam)(own, params)
    opt, metrics = model.train_step(model.init_opt(), _np(g), lr=LR)
    assert int(opt.step) == 1
    _close(metrics["loss"], jax_side["loss"], **FWD_TOL)
    _close(metrics["grad_norm"], jax_side["grad_norm"], rtol=GNORM_RTOL)
    _close(metrics["grad_norm"], own_norm, rtol=GNORM_RTOL)
    got = flatten_with_paths(model.state_numpy())
    want = flatten_with_paths(jax_side["stepped"])
    want_own = flatten_with_paths(_np(j_own))
    jg = flatten_with_paths(jax_side["grads"])
    for k in want:
        np.testing.assert_allclose(got[k], want_own[k], **STEP_TOL)
        sure = np.abs(jg[k]) >= NOISE_GRAD
        np.testing.assert_allclose(got[k][sure], want[k][sure],
                                   **E2E_STEP_TOL)
        assert np.all(np.abs(got[k] - want[k]) <= 2 * LR), k


@pytest.fixture
def deterministic():
    """torch's deterministic algorithms for the test's length: on the
    CPU, index_put(accumulate=True) (aggregate's sum and the gathers'
    backward) may add on several threads in no fixed order."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def test_remat_on_equals_off_bitwise(jax_side, deterministic):
    g = _np(jax_side["graph"])
    outs = {}
    for remat in (False, True):
        model = _port_model(jax_side, remat=remat)
        loss, _, grads = gnn_grads(model.params(), g, model.cfg)
        outs[remat] = (loss, flatten_with_paths(grads), model(g))
    assert torch.equal(outs[True][0], outs[False][0])
    assert torch.equal(outs[True][2], outs[False][2])
    for k, v in outs[False][1].items():
        assert torch.equal(outs[True][1][k], v), k


def test_forward_batched_and_masked_loss_match_jax(jax_side):
    jmodel, params = jax_side["model"], jax_side["params"]
    model = _port_model(jax_side)
    gb = jax_molecule(jax.random.key(2), batch=3, n_nodes=6, n_edges=10,
                      d_node=D_NODE, d_edge=D_EDGE_IN, d_out=D_OUT)
    g = dict(jax_side["graph"])
    masks = {"some": (jnp.arange(N_NODES) < 7).astype(jnp.float32),
             "none": jnp.zeros((N_NODES,), jnp.float32)}

    @jax.jit
    def jax_outputs(params, gb, g, masks):
        return (jmodel.forward_batched(params, gb),
                jmodel.loss(params, gb)[0],
                {k: jmodel.loss(params, dict(g, node_mask=m))[0]
                 for k, m in masks.items()})

    j_out, j_loss, j_masked = jax_outputs(params, gb, g, masks)
    out = model.forward_batched(_np(gb))
    assert out.shape == (3, 6, D_OUT)
    _close(out, j_out, **FWD_TOL)
    _close(model.loss(_np(gb))[0], j_loss, **FWD_TOL)
    # the sampled cell's loss: only the masked-in nodes count
    for k, m in masks.items():
        got = model.loss(_np(dict(g, node_mask=m)))[0]
        _close(got, j_masked[k], **FWD_TOL)
    assert model.loss(_np(dict(g, node_mask=masks["none"])))[0].item() == \
        float(j_masked["none"]) == 0.0
    with torch.no_grad():
        per_graph = torch.stack([model({k: v[b] for k, v in _np(gb).items()})
                                 for b in range(3)])
    _close(out, per_graph.numpy(), rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# The sampler
# --------------------------------------------------------------------------

def _jax_uniforms(key, n_seeds, fanouts):
    """The uniforms jax neighbor_sample draws: one split a layer."""
    out, F = [], n_seeds
    for f in fanouts:
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(sub, (F, f))))
        F *= f
    return out


@pytest.mark.parametrize("fanouts,n_seeds", [((5, 3), 16), ((4, 2), 8),
                                             ((3,), 5), ((2, 2, 2), 4)])
def test_neighbor_sample_body_exact_on_jax_uniforms(fanouts, n_seeds):
    indptr, indices = jax_make_csr_graph(jax.random.key(3), n_nodes=500,
                                         avg_degree=6)
    seeds = jnp.arange(n_seeds) * 7
    key = jax.random.key(4)
    want = jax_neighbor_sample(key, indptr, indices, seeds, fanouts=fanouts)
    got = sample_from_uniforms(np.asarray(indptr), np.asarray(indices),
                               np.asarray(seeds),
                               _jax_uniforms(key, n_seeds, fanouts))
    for k in ("node_ids", "senders", "receivers"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["senders"].dtype == torch.int32 == got["receivers"].dtype
    assert got["n_seeds"] == want["n_seeds"] == n_seeds
    N, E = sampled_sizes(n_seeds, fanouts)
    assert (N, E) == jax_sampled_sizes(n_seeds, fanouts)
    assert got["node_ids"].shape == (N,) and got["senders"].shape == (E,)


def test_sampled_sizes_of_the_cells():
    for cell in GNN_CELLS + GNN_SMOKE_CELLS:
        if cell.kind == "train_sampled":
            args = (cell["batch_nodes"], tuple(cell["fanouts"]))
            assert sampled_sizes(*args) == jax_sampled_sizes(*args)
    assert sampled_sizes(1024, (15, 10)) == (169_984, 168_960)


def test_zero_degree_seed_self_loops_as_jax():
    # node 1 and node 3 have no neighbours
    indptr = np.array([0, 2, 2, 5, 5, 6], np.int32)
    indices = np.array([1, 2, 0, 3, 4, 0], np.int32)
    seeds = np.array([1, 3, 0, 2], np.int32)
    key = jax.random.key(9)
    want = jax_neighbor_sample(key, jnp.asarray(indptr), jnp.asarray(indices),
                               jnp.asarray(seeds), fanouts=(3, 2))
    got = sample_from_uniforms(indptr, indices, seeds,
                               _jax_uniforms(key, 4, (3, 2)))
    for k in ("node_ids", "senders", "receivers"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    ids = got["node_ids"].numpy()
    assert np.all(ids[4:7] == 1) and np.all(ids[7:10] == 3)


@pytest.mark.parametrize("indptr,indices,seeds,want_ids", [
    # node 2, the last row, has no neighbours: its index runs past the
    # CSR's columns, which XLA's gather clamps
    ([0, 2, 3, 3], [1, 2, 0], [2, 0], [2, 0, 2, 2, 2, 1]),
    # the same CSR with the zero-degree row in the middle
    ([0, 2, 2, 3], [1, 2, 0], [1, 0], None),
], ids=["last-row", "middle-row"])
def test_zero_degree_row_of_the_csr_self_loops_as_jax(indptr, indices,
                                                      seeds, want_ids):
    indptr, indices, seeds = (np.array(a, np.int32)
                              for a in (indptr, indices, seeds))
    key = jax.random.key(0)
    want = jax_neighbor_sample(key, jnp.asarray(indptr), jnp.asarray(indices),
                               jnp.asarray(seeds), fanouts=(2,))
    got = sample_from_uniforms(indptr, indices, seeds,
                               _jax_uniforms(key, 2, (2,)))
    for k in ("node_ids", "senders", "receivers"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    if want_ids is not None:
        np.testing.assert_array_equal(got["node_ids"].numpy(), want_ids)
    # the zero-degree seed's children are itself
    assert np.all(got["node_ids"].numpy()[2:4] == seeds[0])


def test_neighbor_sample_static_shapes():
    """Twin of JAX's sampler test on the port's own draws."""
    gen = torch.Generator()
    gen.manual_seed(3)
    indptr, indices = make_csr_graph(gen, n_nodes=500, avg_degree=6,
                                     device=CPU)
    seeds = torch.arange(16)
    s = neighbor_sample(gen, indptr, indices, seeds, fanouts=(5, 3))
    N, E = sampled_sizes(16, (5, 3))
    assert s["node_ids"].shape == (N,)
    assert s["senders"].shape == (E,) == s["receivers"].shape
    assert bool(torch.all(s["receivers"] < s["senders"]))
    assert bool(torch.all((s["node_ids"] >= 0) & (s["node_ids"] < 500)))
    # every sampled child is a CSR neighbour of its parent
    ids = s["node_ids"].long()
    ip, ix = indptr.long(), indices.long()
    for c, p in zip(s["senders"].long().tolist(),
                    s["receivers"].long().tolist()):
        assert ids[c] in ix[ip[ids[p]]:ip[ids[p] + 1]]


def test_block_graph_matches_jax(jax_side):
    indptr, indices = jax_make_csr_graph(jax.random.key(5), n_nodes=300,
                                         avg_degree=5)
    s = jax_neighbor_sample(jax.random.key(6), indptr, indices,
                            jnp.arange(8), fanouts=(4, 2))
    feats = jax.random.normal(jax.random.key(7), (s["node_ids"].shape[0], 8))
    want = jax_block_graph(s, feats, 4)
    got = block_graph_from_sample(
        {k: np.asarray(v) for k, v in s.items() if k != "n_seeds"},
        torch.from_numpy(np.array(feats)), 4)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    with torch.no_grad():
        out = _port_model(jax_side)(got)
    assert out.shape == (s["node_ids"].shape[0], D_OUT)
    assert bool(torch.isfinite(out).all())


# --------------------------------------------------------------------------
# The graph makers
# --------------------------------------------------------------------------

def _layout(batch):
    return {k: (tuple(np.shape(v)), str(np.asarray(v).dtype))
            for k, v in batch.items()}


def test_graph_makers_layouts_match_jax():
    gen = torch.Generator()
    gen.manual_seed(1)
    kw = dict(n_nodes=20, n_edges=50, d_node=6, d_edge=3, d_out=2)
    got = make_random_graph(gen, device=CPU, **kw)
    want = jax_random_graph(jax.random.key(1), **kw)
    assert _layout({k: v.numpy() for k, v in got.items()}) == _layout(want)
    assert bool(torch.all((got["senders"] >= 0) & (got["senders"] < 20)))
    mol = make_molecule_batch(gen, batch=3, n_nodes=6, n_edges=10, d_node=8,
                              d_edge=4, d_out=2, device=CPU)
    jmol = jax_molecule(jax.random.key(2), batch=3, n_nodes=6, n_edges=10,
                        d_node=8, d_edge=4, d_out=2)
    assert _layout({k: v.numpy() for k, v in mol.items()}) == _layout(jmol)
    indptr, indices = make_csr_graph(gen, n_nodes=50, avg_degree=4,
                                     device=CPU)
    assert indptr.dtype == indices.dtype == torch.int32
    assert indptr.shape == (51,) and int(indptr[-1]) == indices.shape[0]
    assert bool(torch.all(indptr[1:] > indptr[:-1]))       # degree >= 1


def test_graph_makers_deterministic_parts_match_jax():
    kw = dict(d_edge=3, d_out=2)
    want = jax_random_graph(jax.random.key(4), n_nodes=20, n_edges=50,
                            d_node=6, **kw)
    got = random_graph_from_draws(np.asarray(want["nodes"]),
                                  np.asarray(want["senders"]),
                                  np.asarray(want["receivers"]), **kw)
    for k in ("nodes", "edges", "senders", "receivers"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    _close(got["targets"], want["targets"], **AGG_TOL)
    jmol = jax_molecule(jax.random.key(2), batch=3, n_nodes=6, n_edges=10,
                        d_node=8, d_edge=4, d_out=2)
    for b in range(3):
        one = random_graph_from_draws(np.asarray(jmol["nodes"][b]),
                                      np.asarray(jmol["senders"][b]),
                                      np.asarray(jmol["receivers"][b]),
                                      d_edge=4, d_out=2)
        np.testing.assert_array_equal(one["edges"].numpy(),
                                      np.asarray(jmol["edges"][b]))
        _close(one["targets"], jmol["targets"][b], **AGG_TOL)
    key = jax.random.key(8)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    j_indptr, j_indices = jax_make_csr_graph(key, n_nodes=300,
                                             avg_degree=5)
    indptr, indices = csr_from_seed(seed, n_nodes=300, avg_degree=5)
    np.testing.assert_array_equal(indptr, np.asarray(j_indptr))
    np.testing.assert_array_equal(indices, np.asarray(j_indices))


# --------------------------------------------------------------------------
# Twins of JAX's model tests
# --------------------------------------------------------------------------

def test_permutation_equivariance(jax_side):
    """Relabeling nodes permutes outputs identically."""
    model = _port_model(jax_side)
    g = {k: torch.from_numpy(np.array(v))
         for k, v in jax_side["graph"].items()}
    perm = torch.from_numpy(np.array(
        jax.random.permutation(jax.random.key(7), N_NODES))).long()
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(N_NODES)
    g2 = {"nodes": g["nodes"][perm], "edges": g["edges"],
          "senders": inv[g["senders"].long()],
          "receivers": inv[g["receivers"].long()]}
    with torch.no_grad():
        _close(model(g)[perm], model(g2).numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("aggregator", ["sum", "mean", "max"])
def test_isolated_nodes(jax_side, aggregator):
    """Two nodes, one edge 0 -> 1: node 0 receives nothing. Sum and mean
    give finite outputs; max gives what JAX's gives, its empty segment
    being -inf."""
    model = _port_model(jax_side, aggregator=aggregator)
    g = {"nodes": np.ones((2, D_NODE), np.float32),
         "edges": np.ones((1, D_EDGE_IN), np.float32),
         "senders": np.array([0], np.int32),
         "receivers": np.array([1], np.int32)}
    with torch.no_grad():
        out = model(g).numpy()
    assert out.shape == (2, D_OUT)
    if aggregator != "max":
        assert np.all(np.isfinite(out))
        return
    _, jcfg = _smoke_cfgs(aggregator=aggregator)
    want = np.asarray(jax.jit(JaxMGN(jcfg).forward)(jax_side["params"], g))
    np.testing.assert_allclose(out, want, equal_nan=True, **FWD_TOL)


def test_train_loss_decreases(jax_side):
    model = _port_model(jax_side)
    g = _np(jax_side["graph"])
    opt, losses = model.init_opt(), []
    for _ in range(25):
        opt, m = model.train_step(opt, g, lr=3e-3)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.7, losses[::8]


def test_node_scores_feed_serve_rank_as_jax(jax_side):
    """The constrained-ranking head consumes the node scores."""
    model = _port_model(jax_side)
    g = jax_side["graph"]
    u = model.node_scores(_np(g))
    assert u.shape == (N_NODES,) and not u.requires_grad
    ju = jnp.asarray(jax_side["forward"][:, 0])   # JAX's node_scores
    _close(u, ju, **FWD_TOL)
    a = (jax.random.uniform(jax.random.key(8), (2, N_NODES)) < 0.5).astype(
        jnp.float32)
    lam = jnp.asarray([0.1, 0.2])
    j_perm, j_util = jax_serve_rank(ju, a, lam, jax_dcg_discount(5), m2=5)
    perm, util = serve_rank(torch.from_numpy(np.array(ju)),
                            torch.from_numpy(np.array(a)),
                            torch.from_numpy(np.array(lam)),
                            dcg_discount(5), m2=5)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(j_perm))
    _close(util, j_util, rtol=1e-6)
    perm, _ = serve_rank(u, torch.from_numpy(np.array(a)),
                         torch.from_numpy(np.array(lam)), dcg_discount(5),
                         m2=5)
    assert perm.shape == (5,)
