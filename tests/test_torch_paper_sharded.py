"""The paper's three cells partitioned over the mesh (configs.paper's
default variant: core.dual_solver.solve_dual_partitioned and
core.serving_dist.serve_partitioned, one shard body a mesh position)
held against the port's global programs and its dist-topk programs, on
the CPU at SMOKE, the three PAPER_SMOKE_CELLS on virtual (2, 4) and
(2, 2, 2) meshes; and distributed.topk.all_to_all_dim against its
definition. JAX's GSPMD outputs for the same programs are held in
tests/test_torch_distributed.py::test_build_paper_matches_jax.

Tolerances: offline_dual every field bitwise the global solve (each
user's row takes the global program's ops); the serve cells bitwise the
dist-topk program on the same arrays (the shared `a` expanded), perm and
compliant equal to the global program's, lambda-hat rtol 1e-5, atol
1e-6, utility rtol 1e-5, exposure rtol 1e-5, atol 1e-6 against it
(tests/test_torch_distributed.py's LAM_TOL, UTIL_TOL, EXPO_TOL: the
global program's lambda-hat is the knn_lambda route's, its ranking
rank_audited's). No JAX is imported here: the `cuda` test runs with
--noconftest on a machine with cards.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.paper import (
    PAPER_SMOKE_CELLS,
    PaperConfig,
    build_paper,
)
from repro_torch.core import serving_dist
from repro_torch.core.constraints import dcg_discount
from repro_torch.core.dual_solver import solve_dual_batch
from repro_torch.distributed import topk
from repro_torch.distributed.topk import all_to_all_dim, positions
from repro_torch.launch.mesh import (
    Sharded,
    block_of,
    make_mesh,
    make_smoke_mesh,
    spec_entries,
    virtual_mesh,
)

MESHES = ("2x4", "2x2x2")
CELLS = [c.name for c in PAPER_SMOKE_CELLS]
SERVE = [c for c in CELLS if c != "offline_dual"]
LAM_TOL = dict(rtol=1e-5, atol=1e-6)
UTIL_TOL = dict(rtol=1e-5)
EXPO_TOL = dict(rtol=1e-5, atol=1e-6)
OFFLINE = ("lam", "dual_value", "primal_value", "exposure", "compliant",
           "gap")
RANKED = ("perm", "utility", "exposure", "compliant", "lam")


def _mesh(name, device="cpu"):
    return make_smoke_mesh(multi_pod=name == "2x2x2", device=device)


def _cell(name, **over):
    cell = next(c for c in PAPER_SMOKE_CELLS if c.name == name)
    return type(cell)(cell.name, cell.kind, {**cell.params, **over})


def _args(cell, seed=7):
    """The cell's arguments from a seed, as tensors: the default
    variant's (a per-request a) and the dist-topk variant's (the shared
    a it broadcasts) on the same arrays."""
    rng = np.random.default_rng(seed)
    B, m1, K = cell["batch"], cell["m1"], cell["K"]
    u = torch.as_tensor(rng.uniform(1.0, 5.0, (B, m1)).astype(np.float32))
    a = torch.as_tensor((rng.uniform(size=(K, m1)) < 0.15).astype(
        np.float32))
    b = torch.full((K,), 0.05)
    a_b = a.expand(B, K, m1).contiguous()
    if cell.kind == "offline":
        return (u, a_b, b), None
    d, n = cell["d_cov"], cell["n_db"]
    X, X_db = (torch.as_tensor(rng.normal(size=s).astype(np.float32))
               for s in ((B, d), (n, d)))
    lam_db = torch.as_tensor(np.abs(rng.normal(size=(n, K))).astype(
        np.float32))
    return (X, u, a_b, b, X_db, lam_db), (X, u, a, b, X_db, lam_db)


def _whole(x):
    return x.gather() if isinstance(x, Sharded) else x


def _fields(out, names):
    return {f: _whole(getattr(out, f)) for f in names}


def _global(cell, args, device="cpu"):
    one = virtual_mesh((1, 1), ("data", "model"), device)
    return build_paper(PaperConfig(), cell, one).fn(*args)


# -- the all-to-all ---------------------------------------------------------------

def _group(mesh, axes, p):
    """The positions that share p's coordinates off `axes`, by their
    block index over `axes` (the first axis slowest), and p's index."""
    names = mesh.axis_names
    same = [q for q in positions(mesh)
            if all(q[j] == p[j] for j, a in enumerate(names) if a not in axes)]
    order = sorted(same, key=lambda q: block_of(mesh, (axes,), q)[0])
    return order, order.index(p)


@pytest.mark.parametrize("split,cat", [(0, 1), (1, 2), (2, 0)])
@pytest.mark.parametrize("axes", ["model", ("data", "model")])
@pytest.mark.parametrize("name", MESHES)
def test_all_to_all_equals_its_definition(name, axes, split, cat):
    """Every position's result is its group's tensors gathered whole
    along cat_dim in block order, then its own block of split_dim."""
    mesh = _mesh(name)
    axes = (axes,) if isinstance(axes, str) else axes
    pos = positions(mesh)
    gen = torch.Generator().manual_seed(3)
    xs = [torch.randn((8, 8, 8), generator=gen) for _ in pos]
    got = all_to_all_dim(mesh, axes, xs, split_dim=split, cat_dim=cat)
    for i, p in enumerate(pos):
        members, r = _group(mesh, axes, p)
        size = 8 // len(members)
        whole = torch.cat([xs[pos.index(q)] for q in members], cat)
        assert torch.equal(got[i], whole.narrow(split, r * size, size)), p


def test_all_to_all_over_one_block_is_the_identity():
    mesh = virtual_mesh((2, 1), ("data", "model"), "cpu")
    xs = [torch.randn(4, 6), torch.randn(4, 6)]
    out = all_to_all_dim(mesh, "model", xs, split_dim=0, cat_dim=1)
    assert all(o is x for o, x in zip(out, xs))


# -- offline_dual -------------------------------------------------------------

@pytest.mark.parametrize("name", MESHES)
def test_offline_dual_partitioned_is_the_global_solve_bitwise(name):
    cell = _cell("offline_dual")
    (u, a, b), _ = _args(cell)
    out = build_paper(PaperConfig(), cell, _mesh(name)).fn(u, a, b)
    want = solve_dual_batch(u, a, b, dcg_discount(cell["m2"]), m2=cell["m2"],
                            num_iters=cell["iters"])
    users = ("data", "model") if name == "2x4" else ("pod", "data", "model")
    for f in OFFLINE:
        sh = getattr(out, f)
        assert isinstance(sh, Sharded)
        assert spec_entries(sh.spec, 1)[0] == users
        assert torch.equal(sh.gather(), getattr(want, f)), f
    assert out.iters == cell["iters"]


# -- the serve cells ----------------------------------------------------------

@pytest.mark.parametrize("cell", SERVE)
@pytest.mark.parametrize("name", MESHES)
def test_serve_cell_partitioned_matches_dist_topk_and_global(name, cell):
    cell = _cell(cell)
    mesh = _mesh(name)
    args, dist_args = _args(cell)
    out = build_paper(PaperConfig(), cell, mesh).fn(*args)
    dist = build_paper(PaperConfig(distributed=True), cell, mesh).fn(
        *dist_args)
    glob = _global(cell, args)
    got = _fields(out, RANKED)
    bat = ("data",) if name == "2x4" else ("pod", "data")
    for f in RANKED:
        assert spec_entries(getattr(out, f).spec, 1)[0] == bat
        assert torch.equal(got[f], getattr(dist, f)), f
    assert got["perm"].dtype == torch.int32
    assert torch.equal(got["perm"], glob.perm)
    assert torch.equal(got["compliant"], glob.compliant)
    np.testing.assert_allclose(got["lam"], glob.lam, **LAM_TOL)
    np.testing.assert_allclose(got["utility"], glob.utility, **UTIL_TOL)
    np.testing.assert_allclose(got["exposure"], glob.exposure, **EXPO_TOL)


# -- relaxed specs, repeat calls, one device, replicas -------------------------

@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("name", MESHES)
def test_a_batch_of_6_relaxes_and_matches_the_global_program(name, cell):
    """6 users do not divide the 8 positions: offline_dual keeps them
    over the axes that divide (('data',) on (2, 4), where the items are
    all-gathered; ('model',) on (2, 2, 2), where ('pod', 'data') does
    not divide 6) and pads no user in; the serve cells keep the users
    over ('data',) or replicate them."""
    cell = _cell(cell, batch=6)
    args, _ = _args(cell)
    out = build_paper(PaperConfig(), cell, _mesh(name)).fn(*args)
    want = _global(cell, args)
    users = {("2x4", True): ("data",), ("2x2x2", True): ("model",),
             ("2x4", False): ("data",), ("2x2x2", False): ()}[
        name, cell.kind == "offline"]
    names = OFFLINE if cell.kind == "offline" else RANKED
    for f in names:
        sh = getattr(out, f)
        assert spec_entries(sh.spec, 1)[0] == users
        if cell.kind == "offline" or f in ("perm", "compliant"):
            assert torch.equal(sh.gather(), getattr(want, f)), f
    if cell.kind != "offline":
        got = _fields(out, RANKED)
        np.testing.assert_allclose(got["lam"], want.lam, **LAM_TOL)
        np.testing.assert_allclose(got["utility"], want.utility, **UTIL_TOL)
        np.testing.assert_allclose(got["exposure"], want.exposure,
                                   **EXPO_TOL)


@pytest.mark.parametrize("cell", CELLS)
def test_two_calls_give_the_same_bits(cell):
    cell = _cell(cell)
    prog = build_paper(PaperConfig(), cell, _mesh("2x2x2"))
    args, _ = _args(cell)
    names = OFFLINE if cell.kind == "offline" else RANKED
    a, b = _fields(prog.fn(*args), names), _fields(prog.fn(*args), names)
    assert all(torch.equal(a[f], b[f]) for f in names)


@pytest.mark.parametrize("cell", CELLS)
def test_a_one_device_mesh_runs_the_global_program(cell):
    """On a one-device mesh nothing splits: the program returns tensors,
    bitwise the unpartitioned call (solve_dual_batch; knn_lambda's
    route, then rank_audited's)."""
    from repro_torch.kernels import ops
    cell = _cell(cell)
    args, _ = _args(cell)
    out = _global(cell, args)
    m2 = cell["m2"]
    gamma = dcg_discount(m2)
    if cell.kind == "offline":
        want = solve_dual_batch(*args, gamma, m2=m2, num_iters=cell["iters"])
        names = OFFLINE
    else:
        X, u, a, b, X_db, lam_db = args
        cfg = PaperConfig()
        lam = ops.knn_lambda(X, X_db, lam_db, k=cfg.knn_k, device="cpu")
        want = ops.rank_audited(u, a, b, lam, gamma, m2=m2, eps=cfg.eps,
                                device="cpu")
        names = RANKED
    for f in names:
        got = getattr(out, f)
        assert isinstance(got, torch.Tensor)
        assert torch.equal(got, getattr(want, f)), f


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("name", MESHES)
def test_every_replica_of_an_output_block_holds_the_same_bits(
        name, cell, monkeypatch):
    """Each position's own block of each output (before the Sharded
    keeps one copy a device) equals every other position's copy of that
    block: a 'model' group merges the same candidates in block order."""
    seen = []
    real = topk.assemble

    def recording(mesh, xs, spec, shape):
        seen.append((mesh, list(xs), spec, shape))
        return real(mesh, xs, spec, shape)
    monkeypatch.setattr(topk, "assemble", recording)
    monkeypatch.setattr(serving_dist, "assemble", recording)
    cell = _cell(cell)
    args, _ = _args(cell)
    build_paper(PaperConfig(), cell, _mesh(name)).fn(*args)
    assert len(seen) == (6 if cell.kind == "offline" else 5)
    for mesh, xs, spec, shape in seen:
        entries = spec_entries(spec, len(shape))
        first = {}
        for i, p in enumerate(positions(mesh)):
            blk = block_of(mesh, entries, p)
            assert torch.equal(first.setdefault(blk, xs[i]), xs[i])
        if cell.kind != "offline":      # replicated over 'model'
            assert len(first) < len(xs)


def test_a_sharded_argument_must_be_laid_by_the_relaxed_spec():
    from repro_torch.launch.mesh import shard
    cell = _cell("offline_dual")
    mesh = _mesh("2x4")
    (u, a, b), _ = _args(cell)
    prog = build_paper(PaperConfig(), cell, mesh)
    laid = prog.fn(shard(mesh, u, (("data",), "model")), a, b)
    assert torch.equal(laid.lam.gather(), prog.fn(u, a, b).lam.gather())
    with pytest.raises(ValueError, match="laid by"):
        prog.fn(shard(mesh, u, ("data", None)), a, b)


# -- a mesh across cards --------------------------------------------------------

@pytest.mark.cuda
def test_a_mesh_across_cards_equals_a_virtual_one_for_the_paper_cells():
    """On a (2, 2) mesh over 4 cards (each shard body on its own card),
    the three SMOKE cells' partitioned programs give the bits of the
    same programs on a virtual (2, 2) mesh over one card. Skips with
    fewer than 4 cards."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    card = torch.device("cuda", 0)
    axes = ("data", "model")
    for name in CELLS:
        cell = _cell(name)
        args, _ = _args(cell)
        args = tuple(x.to(card) for x in args)
        names = OFFLINE if cell.kind == "offline" else RANKED
        outs = {}
        for label, mesh in (("cards", make_mesh((2, 2), axes)),
                            ("virtual", virtual_mesh((2, 2), axes, card))):
            out = build_paper(PaperConfig(), cell, mesh).fn(*args)
            outs[label] = {f: getattr(out, f).gather(card) for f in names}
        for f in names:
            assert torch.equal(outs["cards"][f], outs["virtual"][f]), (name, f)
