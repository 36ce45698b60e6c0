"""The zoo's cell programs (configs.lm_family.build_lm,
recsys_family.build_recsys, gnn_family.build_gnn, paper.build_paper)
and the sharding of their arguments, held against JAX's builds.

JAX's side runs once a module, in subprocesses with 8 forced host
devices on the (2, 4) and (2, 2, 2) smoke meshes (as
tests/test_torch_distributed.py runs it, four parts side by side;
their axes of type Auto, the
GSPMD semantics the JAX package's annotations are written for): every
arch x cell at FULL through jax.eval_shape (nothing materialised),
param_shardings and
drop_nondivisible on every arch's FULL logical_axes, and at SMOKE each
program's `low.fn` under use_mesh_rules on the (2, 4) mesh, on JAX's
init(key(0)) and on inputs drawn here with numpy from a seed. The port
builds the same cells on virtual meshes over the CPU (its FULL shapes
from the meta device) and runs its SMOKE programs on the parameters
carried across.

Tolerances: shapes, dtypes and specs (each spec normalised to a tuple of
mesh axes a dim) exactly; retrieval_cand's idx exactly, its values
rtol 1e-5, atol 1e-5 (the port's fused_rank forms the axpy score where
JAX's program forms lambda-hat @ a) and lambda-hat rtol 1e-5, atol 1e-6;
serve scores, LM logits and caches rtol 1e-5, atol 1e-5; a train
step's losses rtol 1e-5, grad_norm rtol 1e-5; the new parameters
rtol 1e-5, atol lr * 1e-3 wherever the gradients' own bound in the
models' tests (rtol 1e-4, atol 1e-6) bounds Adam's first step within
lr * 1e-3 (it moves a weight by lr * g / (|g| + 1e-8), whose slope
1e-8 / (|g| + 1e-8)^2 turns that bound on g into under lr * 1e-3 only
for |g| above about 3e-6), and within the step's bound, 2 * lr,
elsewhere, as tests/test_torch_gnn.py holds a step against JAX's (JAX's
program sums its gradients sharded over the mesh, in another order
again); the first moments rtol 1e-4,
atol 1e-7 and the second rtol 2e-4, atol 1e-12 (the moments of the
gradients, which agree to rtol 1e-4, atol 1e-6 in the models' own
tests); the step counter exactly.
"""

import json
import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.store import flatten_with_paths
from repro_torch.configs import all_archs, get_arch
from repro_torch.configs.gnn_family import (
    GNN_SMOKE_CELLS,
    build_gnn,
    graph_sizes,
    pad_graph,
)
from repro_torch.configs.lm_family import LM_SMOKE_CELLS, build_lm
from repro_torch.configs.paper import build_paper
from repro_torch.configs.recsys_family import (
    KNN_DB,
    RECSYS_SMOKE_CELLS,
    build_recsys,
    pad_up,
)
from repro_torch.configs.registry import ArgSpec, args_from_numpy
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import Sharded, make_smoke_mesh, spec_entries
from repro_torch.models.gnn import gnn_logical_axes
from repro_torch.models.recsys import RECSYS_REGISTRY, recsys_logical_axes
from repro_torch.models.transformer import lm_init, lm_logical_axes

REPO = Path(__file__).resolve().parent.parent
MESHES = ("2x4", "2x2x2")
RECSYS = ("deepfm", "sasrec", "bert4rec", "mind")
LMS = ("llama3.2-1b", "kimi-k2-1t-a32b")       # a dense and an MoE arch
SMOKE_CELLS = {"lm": LM_SMOKE_CELLS, "recsys": RECSYS_SMOKE_CELLS,
               "gnn": GNN_SMOKE_CELLS}
SMOKE_ARCHS = RECSYS + LMS + ("meshgraphnet",)
LR = {"lm": 3e-4, "recsys": 1e-3, "gnn": 1e-3}
TOL = dict(rtol=1e-5, atol=1e-5)
LAM_TOL = dict(rtol=1e-5, atol=1e-6)
MU_TOL = dict(rtol=1e-4, atol=1e-7)
NU_TOL = dict(rtol=2e-4, atol=1e-12)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)    # the models' own tests' bound
ADAM_EPS = 1e-8

_PROG = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    import numpy as np

    from repro.checkpoint.store import _flatten_with_paths
    from repro.configs import all_archs, get_arch
    from repro.configs.gnn_family import GNN_SMOKE_CELLS, cell_config
    from repro.configs.lm_family import LM_SMOKE_CELLS
    from repro.configs.recsys_family import RECSYS_SMOKE_CELLS
    from repro.distributed.sharding import (
        RULES_BY_FAMILY, drop_nondivisible, param_shardings,
        use_mesh_rules)
    from repro.models.gnn import MeshGraphNet
    from repro.models.recsys import RECSYS_REGISTRY
    from repro.models.transformer import lm_init, lm_logical_axes

    src, dst, part = sys.argv[1], sys.argv[2], sys.argv[3]
    x = dict(np.load(src))
    out, specs = {}, {}

    def key(*parts):
        return "|".join(parts).replace("/", "__SL__")

    def spec_list(spec):
        return [None if e is None else ([e] if isinstance(e, str)
                                        else list(e)) for e in spec]

    def spec_of(s):
        sh = getattr(s, "sharding", None)
        return None if sh is None else spec_list(sh.spec)

    def auto_mesh(shape, axes):
        # GSPMD's Auto axes, the semantics the JAX package's annotations
        # are written for (on Explicit axes with_sharding_constraint
        # asserts the input's placement instead of setting it)
        return jax.make_mesh(shape, axes, axis_types=(
            jax.sharding.AxisType.Auto,) * len(axes))

    meshes = {"2x4": auto_mesh((2, 4), ("data", "model")),
              "2x2x2": auto_mesh((2, 2, 2), ("pod", "data", "model"))}
    for mname, mesh in (meshes.items() if part == "specs" else ()):
        for arch in all_archs():
            spec = get_arch(arch)
            cfg = spec.make_config(True)
            for cell in spec.cells:
                low = spec.build(cfg, cell, mesh)
                for i, arg in enumerate(low.args):
                    flat, _ = _flatten_with_paths(arg)
                    for path, s in flat.items():
                        specs["|".join((mname, arch, cell.name, str(i),
                                        path))] = [
                            list(s.shape), str(s.dtype), spec_of(s)]
            # param_shardings and drop_nondivisible on FULL logical axes
            rules = RULES_BY_FAMILY[spec.family]
            if spec.family == "lm":
                axes = lm_logical_axes(cfg)
                shapes = jax.eval_shape(lambda k: lm_init(k, cfg),
                                        jax.random.key(0))
            elif spec.family == "recsys":
                model = RECSYS_REGISTRY[cfg.kind](cfg)
                axes = model.logical_axes()
                shapes = jax.eval_shape(model.init, jax.random.key(0))
            elif spec.family == "gnn":
                model = MeshGraphNet(cell_config(cfg, spec.cells[0]))
                axes = model.logical_axes()
                shapes = jax.eval_shape(model.init, jax.random.key(0))
            else:
                continue
            shards, _ = _flatten_with_paths(param_shardings(axes, mesh,
                                                            rules))
            flat_shapes, _ = _flatten_with_paths(shapes)
            for path, sh in shards.items():
                relaxed = drop_nondivisible(sh.spec, flat_shapes[path].shape,
                                            mesh)
                specs["|".join(("axes", mname, arch, path))] = [
                    spec_list(sh.spec), spec_list(relaxed)]

    mesh = meshes["2x4"]
    cells = {"lm": LM_SMOKE_CELLS, "recsys": RECSYS_SMOKE_CELLS,
             "gnn": GNN_SMOKE_CELLS}
    for arch in (part.split(",") if part != "specs" else ()):
        spec = get_arch(arch)
        cfg = spec.make_config(False)
        for cell in cells[spec.family]:
            low = spec.build(cfg, cell, mesh)
            if spec.family == "lm":
                params = lm_init(jax.random.key(0), cfg)
            elif spec.family == "recsys":
                params = RECSYS_REGISTRY[cfg.kind](cfg).init(
                    jax.random.key(0))
            else:
                params = MeshGraphNet(cell_config(cfg, cell)).init(
                    jax.random.key(0))
            args = [params]
            for i, arg in enumerate(low.args[1:], 1):
                flat, treedef = _flatten_with_paths(arg)
                args.append(jax.tree_util.tree_unflatten(treedef, [
                    x[key(arch, cell.name, str(i), p)] for p in flat]))
            flat, _ = _flatten_with_paths(params)
            for p, v in flat.items():
                out[key(arch, cell.name, "params", p)] = np.asarray(
                    v, np.float32)
            with use_mesh_rules(mesh, low.rules):
                res = jax.jit(low.fn)(*args)
            flat, _ = _flatten_with_paths(res)
            for p, v in flat.items():
                out[key(arch, cell.name, "out", p)] = np.asarray(v)
    np.savez(dst, **out)
    with open(dst + ".json", "w") as f:
        json.dump(specs, f)
    print("done")
""")


def _key(*parts):
    return "|".join(parts).replace("/", "__SL__")


def _mesh(name):
    return make_smoke_mesh(multi_pod=name == "2x2x2", device="cpu")


def _smoke_cell(arch, name):
    spec = get_arch(arch)
    return next(c for c in SMOKE_CELLS[spec.family] if c.name == name)


def _ids(rng, hi, shape, pad=0.0):
    """Ids in [0, hi) of `shape`, a share `pad` of them -1 (padding)."""
    out = rng.integers(0, hi, shape).astype(np.int32)
    if pad:
        out[rng.uniform(size=shape) < pad] = -1
    return out


def _graph(rng, cell):
    """One (or a batch of) padded graph(s) of the cell, float32 and
    int32 arrays: real nodes and edges drawn, then pad_graph's padding."""
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


def _inputs(arch, cell, prog, seed=0):
    """The arguments after the parameters, as {arg index: {path:
    array}} from a seed: integer leaves in their ranges, float leaves
    normal (a constraint matrix 0/1, lambda rows >= 0), Adam's state
    zero."""
    spec = get_arch(arch)
    cfg = spec.make_config(False)
    rng = np.random.default_rng(seed)
    out = {}
    for i, arg in enumerate(prog.args[1:], 1):
        flat = flatten_with_paths(arg)
        vals = {}
        if spec.family == "gnn" and i == 2:
            vals = _graph(rng, cell)
        for path, a in flat.items():
            if path in vals:
                continue
            name = path.split("/")[-1]
            shape, dt = a.shape, a.dtype
            if path.startswith("."):                  # Adam's state
                vals[path] = np.zeros(shape, np.int32 if dt == torch.int32
                                      else np.float32)
            elif spec.family == "lm":
                if i == 1 and cell.kind == "decode":   # the cache
                    vals[path] = rng.normal(size=shape).astype(np.float32)
                elif cell.kind == "decode" and i == 3:
                    vals[path] = np.asarray(cell["seq_len"] // 2, np.int32)
                else:
                    vals[path] = _ids(rng, cfg.vocab, shape)
            elif cell.kind == "retrieval":
                vals[path] = _retrieval_arg(rng, cfg, i, shape)
            elif cfg.kind == "deepfm" and name in ("ids", ""):
                field = np.arange(cfg.n_sparse) * cfg.field_vocab
                vals[path] = (_ids(rng, cfg.field_vocab, shape)
                              + field).astype(np.int32)
            elif name == "labels":
                vals[path] = _ids(rng, 2, shape)
            elif name == "mask_pos":
                vals[path] = _ids(rng, cfg.seq_len, shape)
            elif name == "seq" or (cell.kind == "serve" and i == 1):
                vals[path] = _ids(rng, cfg.n_items, shape,
                                  pad=0.1 if cfg.kind != "bert4rec" else 0)
            else:
                vals[path] = _ids(rng, cfg.n_items, shape)
        out[i] = vals
    return out


def _retrieval_arg(rng, cfg, i, shape):
    if i == 1:                                     # the user's input
        if cfg.kind == "deepfm":
            field = np.arange(1, cfg.n_sparse) * cfg.field_vocab
            return (_ids(rng, cfg.field_vocab, shape) + field).astype(
                np.int32)
        return _ids(rng, cfg.n_items, shape, pad=0.1)
    if i == 2:                                     # the candidates
        return _ids(rng, cfg.field_vocab if cfg.kind == "deepfm"
                    else cfg.n_items, shape)
    if i == 3:
        return (rng.uniform(size=shape) < 0.15).astype(np.float32)
    x = rng.normal(size=shape).astype(np.float32)
    return np.abs(x) if i == 5 else x


def _smoke_programs():
    """{(arch, cell name): (program, inputs)} at SMOKE on the (2, 4)
    mesh."""
    mesh = _mesh("2x4")
    out = {}
    for arch in SMOKE_ARCHS:
        spec = get_arch(arch)
        cfg = spec.make_config(False)
        for cell in SMOKE_CELLS[spec.family]:
            prog = spec.build(cfg, cell, mesh)
            out[arch, cell.name] = (prog, _inputs(arch, cell, prog))
    return out


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's specs (a dict from the JSON) and SMOKE outputs (the npz),
    from one subprocess with 8 host devices; plus the port's SMOKE
    programs and the inputs they both read."""
    progs = _smoke_programs()
    x = {_key(arch, cell, str(i), path): v
         for (arch, cell), (_, inputs) in progs.items()
         for i, flat in inputs.items() for path, v in flat.items()}
    # four parts side by side: the FULL specs, and the SMOKE programs
    # in three groups (each group's time is mostly XLA compiling)
    parts = ("specs", ",".join(RECSYS), ",".join(LMS), "meshgraphnet")
    specs, out = {}, {}
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "in.npz")
        np.savez(src, **x)
        env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
        runs = []
        for i, part in enumerate(parts):
            dst = os.path.join(d, f"out{i}.npz")
            runs.append((dst, subprocess.Popen(
                [sys.executable, "-c", _PROG, src, dst, part],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env, cwd=REPO)))
        for dst, proc in runs:
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, stdout + "\n" + stderr
            with open(dst + ".json") as f:
                specs.update(json.load(f))
            out.update(np.load(dst))
    return specs, out, progs


def _norm(spec):
    """A spec as JAX's side writes it: a list per dim (None replicated)."""
    if spec is None:
        return None
    return [list(e) if e else None for e in spec_entries(
        spec, len(spec))]


def _port_specs(arg):
    return {path: [list(a.shape), str(a.dtype).removeprefix("torch."),
                   None if a.sharding is None else _norm(a.sharding.spec)]
            for path, a in flatten_with_paths(arg).items()}


# -- every arch x cell at FULL ----------------------------------------------

def test_every_arch_has_a_build():
    for arch in all_archs():
        assert get_arch(arch).build is not None, arch
    assert get_arch("meshgraphnet").build is build_gnn
    assert get_arch("paper-ranking").build is build_paper
    for arch in RECSYS:
        assert get_arch(arch).build is build_recsys
    for arch in LMS:
        assert get_arch(arch).build is build_lm


@pytest.mark.parametrize("arch", all_archs())
@pytest.mark.parametrize("name", MESHES)
def test_full_cell_args_match_jax(jax_ref, name, arch):
    """Each cell's arguments at FULL: every leaf's path, shape, dtype and
    spec are those of JAX's Lowerable.args (the port's AdamState keeps
    its moments over the flattened tree, whose paths are JAX's)."""
    specs = jax_ref[0]
    spec = get_arch(arch)
    cfg = spec.make_config(True)
    mesh = _mesh(name)
    for cell in spec.cells:
        prog = spec.build(cfg, cell, mesh)
        assert prog.rules is not None
        prefix = "|".join((name, arch, cell.name)) + "|"
        want = {k[len(prefix):]: v for k, v in specs.items()
                if k.startswith(prefix)}
        got = {}
        for i, arg in enumerate(prog.args):
            for path, v in _port_specs(arg).items():
                got[f"{i}|{path}"] = v
        assert sorted(got) == sorted(want), (cell.name, sorted(
            set(got) ^ set(want))[:5])
        for k in want:
            assert got[k] == want[k], (cell.name, k, got[k], want[k])
        for leaf in flatten_with_paths(prog.args).values():
            assert isinstance(leaf, ArgSpec)


def _full_axes(arch):
    spec = get_arch(arch)
    cfg = spec.make_config(True)
    if spec.family == "lm":
        return lm_logical_axes(cfg), lm_init(None, cfg, device="meta")
    if spec.family == "recsys":
        return recsys_logical_axes(cfg), RECSYS_REGISTRY[cfg.kind](
            cfg, device="meta").params()
    from repro_torch.configs.gnn_family import cell_config
    from repro_torch.models.gnn import gnn_init
    ccfg = cell_config(cfg, spec.cells[0])
    return gnn_logical_axes(ccfg), gnn_init(None, ccfg, device="meta")


@pytest.mark.parametrize("arch", [a for a in all_archs()
                                  if a != "paper-ranking"])
@pytest.mark.parametrize("name", MESHES)
def test_param_shardings_and_relaxation_match_jax(jax_ref, name, arch):
    """param_shardings on the arch's FULL logical_axes and
    drop_nondivisible on its FULL shapes equal JAX's, leaf by leaf."""
    specs = jax_ref[0]
    mesh = _mesh(name)
    family = get_arch(arch).family
    axes, shapes = _full_axes(arch)
    shards = flatten_with_paths(sharding.param_shardings(
        axes, mesh, sharding.RULES_BY_FAMILY[family]))
    flat_shapes = flatten_with_paths(shapes)
    prefix = "|".join(("axes", name, arch)) + "|"
    want = {k[len(prefix):]: v for k, v in specs.items()
            if k.startswith(prefix)}
    assert sorted(shards) == sorted(want)
    for path, sh in shards.items():
        assert isinstance(sh, sharding.NamedSharding) and sh.mesh is mesh
        relaxed = sharding.drop_nondivisible(
            sh.spec, flat_shapes[path].shape, mesh)
        assert len(relaxed) == len(flat_shapes[path].shape)
        assert [_norm(sh.spec), _norm(relaxed)] == want[path], path


# -- the SMOKE programs against JAX's low.fn ----------------------------------

def _tensor(a):
    return torch.from_numpy(np.array(a))


def _port_args(arch, cell, prog, inputs, want):
    """The program's arguments as tensors (args_from_numpy): the
    parameters JAX drew, the rest from the seeded inputs."""
    params = args_from_numpy(prog.args[0], {
        p: want[_key(arch, cell, "params", p)]
        for p in flatten_with_paths(prog.args[0])}, device="cpu")
    return [params] + [args_from_numpy(arg, inputs[i], device="cpu")
                       for i, arg in enumerate(prog.args[1:], 1)]


def _whole(tree):
    """A program's outputs with each Sharded leaf (a partitioned LM
    program's parameters, moments, cache and logits) gathered whole."""
    return sharding.tree_map(
        lambda v: v.gather() if isinstance(v, Sharded) else v, tree)


def _close(got, want, tol, msg):
    np.testing.assert_allclose(np.asarray(got.detach().to(torch.float32)),
                               np.asarray(want, np.float32), **tol,
                               err_msg=msg)


def _check_train(out, want, family, prefix, arch):
    params, opt, metrics = out
    lr = LR[family]
    def at(path):
        return want[prefix + _key(path)]

    for p, v in flatten_with_paths(params).items():
        got, jp = v.detach().to(torch.float32).numpy(), at(f"0/{p}")
        # JAX's clipped gradient (its first moment after one step / 0.1)
        # where GRAD_TOL on it bounds Adam's step within lr * 1e-3
        g = np.abs(at(f"1/.mu/{p}")) / 0.1
        dg = GRAD_TOL["atol"] + GRAD_TOL["rtol"] * g
        sure = ADAM_EPS * dg / (g + ADAM_EPS) ** 2 <= 1e-3
        np.testing.assert_allclose(got[sure], jp[sure], rtol=1e-5,
                                   atol=lr * 1e-3, err_msg=f"{arch} {p}")
        assert np.all(np.abs(got - jp) <= 2 * lr), (arch, p)
    assert int(opt.step) == int(at("1/.step")) == 1
    for p, v in opt.mu.items():
        _close(v, at(f"1/.mu/{p}"), MU_TOL, f"{arch} mu {p}")
        _close(opt.nu[p], at(f"1/.nu/{p}"), NU_TOL, f"{arch} nu {p}")
    for name, v in metrics.items():
        _close(v, at(f"2/{name}"), dict(rtol=1e-5, atol=0),
               f"{arch} {name}")


@pytest.mark.parametrize("arch,cell", [
    (a, c.name) for a in SMOKE_ARCHS
    for c in SMOKE_CELLS[get_arch(a).family]])
def test_smoke_program_matches_jax(jax_ref, arch, cell):
    _, want, progs = jax_ref
    prog, inputs = progs[arch, cell]
    c = _smoke_cell(arch, cell)
    family = get_arch(arch).family
    args = _port_args(arch, cell, prog, inputs, want)
    with sharding.use_mesh_rules(_mesh("2x4"), prog.rules):
        out = _whole(prog.fn(*args))
    prefix = _key(arch, cell, "out") + "|"
    keys = {k[len(prefix):] for k in want if k.startswith(prefix)}
    if c.kind.startswith("train"):
        _check_train(out, want, family, prefix, arch)
        return
    if c.kind == "retrieval":
        vals, idx, lam = out
        np.testing.assert_array_equal(idx.numpy(), want[prefix + "1"])
        _close(vals, want[prefix + "0"], TOL, f"{arch} vals")
        _close(lam, want[prefix + "2"], LAM_TOL, f"{arch} lambda-hat")
        assert vals.shape == (c["batch"], 50)
        return
    flat = flatten_with_paths(out)
    assert {_key(p) for p in flat} == keys, (sorted(flat), sorted(keys))
    for p, v in flat.items():
        _close(v, want[prefix + _key(p)], TOL, f"{arch} {cell} {p}")


def test_retrieval_program_reaches_the_kernel_entry_points(monkeypatch):
    """retrieval_cand's program runs lambda-hat through ops.knn_lambda
    and the adjusted top-m2 through ops.fused_rank (the kernels on the
    card, their plain versions here), and DeepFM's context through
    ops.embedding_bag: each wrapper once a call."""
    from repro_torch.kernels import ops

    calls = []
    for name in ("knn_lambda_cuda", "fused_rank_cuda",
                 "embedding_bag_cuda"):
        orig = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _o=orig, _n=name, **k: (
            calls.append(_n), _o(*a, **k))[1])
    cfg = get_arch("deepfm").make_config(False)
    cell = _smoke_cell("deepfm", "retrieval_cand")
    prog = build_recsys(cfg, cell, _mesh("2x4"))
    model = RECSYS_REGISTRY["deepfm"](cfg, device="cpu")
    inputs = _inputs("deepfm", cell, prog)
    args = [model.params()] + [_tensor(inputs[i][""]) for i in range(1, 6)]
    vals, idx, lam = prog.fn(*args)
    assert sorted(calls) == ["embedding_bag_cuda", "fused_rank_cuda",
                             "knn_lambda_cuda"]
    assert args[4].shape == (KNN_DB, cfg.embed_dim)
    assert idx.dtype == torch.int32 and torch.isfinite(vals).all()
    assert (lam >= 0).all()


def test_pad_graph_self_loops_onto_zero_padding_nodes():
    """Padding edges loop on padding nodes, whose features, targets and
    mask are zero; a real node's aggregate is untouched."""
    from repro_torch.models.gnn import aggregate

    rng = np.random.default_rng(3)
    g = {"nodes": torch.from_numpy(rng.normal(size=(5, 3)).astype(
             np.float32)),
         "edges": torch.ones(7, 2), "targets": torch.ones(5, 1),
         "senders": torch.tensor([0, 1, 2, 3, 4, 0, 1], dtype=torch.int32),
         "receivers": torch.tensor([1, 2, 3, 4, 0, 2, 3],
                                   dtype=torch.int32),
         "node_mask": torch.ones(5)}
    p = pad_graph(g, 8, 12)
    assert p["nodes"].shape == (8, 3) and p["edges"].shape == (12, 2)
    assert torch.equal(p["senders"][7:], p["receivers"][7:])
    assert ((p["senders"][7:] >= 5) & (p["senders"][7:] < 8)).all()
    assert not p["nodes"][5:].any() and not p["targets"][5:].any()
    assert not p["node_mask"][5:].any() and not p["edges"][7:].any()
    msgs = torch.ones(12, 1)
    agg = aggregate(msgs, p["receivers"], 8, "sum")
    assert torch.equal(agg[:5], aggregate(msgs[:7], g["receivers"], 5,
                                          "sum"))
    with pytest.raises(ValueError, match="padding node"):
        pad_graph(g, 5, 9)


def test_args_from_numpy_carries_a_tree_and_checks_it():
    """args_from_numpy takes a nested tree or a flat {path: array} dict
    of a program's argument, casts each leaf to its ArgSpec's dtype and
    refuses another path or shape."""
    cfg = get_arch("llama3.2-1b").make_config(False)
    prog = build_lm(cfg, LM_SMOKE_CELLS[1], _mesh("2x4"))
    params = lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    tree = {k: v.numpy().astype(np.float64)
            for k, v in flatten_with_paths(params).items()}
    got = args_from_numpy(prog.args[0], tree, device="cpu")
    for p, v in flatten_with_paths(got).items():
        assert v.dtype == cfg.param_dtype and torch.equal(
            v, flatten_with_paths(params)[p])
    tokens = args_from_numpy(prog.args[1], {"": np.zeros((2, 32))},
                             device="cpu")
    assert tokens.dtype == torch.int32 and tokens.shape == (2, 32)
    with pytest.raises(ValueError, match="differ"):
        args_from_numpy(prog.args[0], {"embed": tree["embed"]},
                        device="cpu")
    with pytest.raises(ValueError, match=r"\(2, 31\)"):
        args_from_numpy(prog.args[1], {"": np.zeros((2, 31))}, device="cpu")
