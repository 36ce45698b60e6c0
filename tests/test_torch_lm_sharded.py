"""The partitioned dense LM programs (models.transformer's shard bodies,
one a mesh position: the batch over ('pod', 'data'), FSDP over 'data',
tensor parallelism over 'model', the KV cache over its sequence blocks;
the collectives of distributed.topk between them) held against the
port's global programs and against JAX's build_lm programs partitioned
by GSPMD, on the CPU at SMOKE, for llama3.2-1b, mistral-nemo-12b and
phi3-medium-14b x the four LM_SMOKE_CELLS on virtual (2, 4) and
(2, 2, 2) meshes.

JAX's side runs once a module, in a subprocess a mesh (side by side)
with 8 forced host devices and axes of type Auto, as
tests/test_torch_gnn_sharded.py runs it: each cell's `low.fn` under jit
on JAX's lm_init(key(0)) and on inputs drawn here with numpy from a
seed. The port runs build_lm's program on the same arrays on virtual
meshes over the CPU. No JAX is imported here: the `cuda` test runs with
--noconftest on a machine with cards.

Tolerances, those of tests/test_torch_cell_programs.py: logits and
caches rtol 1e-5, atol 1e-5; the loss and grad_norm rtol 1e-5; the new
parameters rtol 1e-5, atol lr * 1e-3 where the gradient |g| is above
3e-6 and within Adam's first step's bound, 2 * lr, elsewhere; Adam's
first moments rtol 1e-4, atol 1e-7, its second rtol 2e-4, atol 1e-12;
the step counter exactly. The partitioned log-sum-exp takes its shift
with no gradient (the shift's gradient is zero but for rounding, about
1e-7 of a logit's here), within these. The collectives equal their
definitions exactly; those whose backward is their forward's gradient
pass torch.autograd.gradcheck in float64. Two calls of a partitioned
program give the same bits.
"""

import dataclasses
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
from repro_torch.configs import get_arch
from repro_torch.configs.lm_family import LM_SMOKE_CELLS, build_lm
from repro_torch.configs.registry import args_from_numpy
from repro_torch.distributed.sharding import LM_RULES, use_mesh_rules
from repro_torch.distributed.topk import (
    all_gather_dim,
    copy_to_shards,
    max_over_shards,
    reduce_from_shards,
    reduce_scatter_dim,
)
from repro_torch.launch.mesh import (
    Sharded,
    make_mesh,
    make_smoke_mesh,
    virtual_mesh,
)
from repro_torch.models import transformer as tt

REPO = Path(__file__).resolve().parent.parent
MESHES = ("2x4", "2x2x2")
ARCHS = ("llama3.2-1b", "mistral-nemo-12b", "phi3-medium-14b")
CELLS = [c.name for c in LM_SMOKE_CELLS]
LR = 3e-4
TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=0)
MU_TOL = dict(rtol=1e-4, atol=1e-7)
NU_TOL = dict(rtol=2e-4, atol=1e-12)
SURE_GRAD = 3e-6

_PROG = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import numpy as np

    from repro.checkpoint.store import _flatten_with_paths
    from repro.configs import get_arch
    from repro.configs.lm_family import LM_SMOKE_CELLS
    from repro.distributed.sharding import use_mesh_rules
    from repro.models.transformer import lm_init
    from repro.optim import adam_init

    src, dst, only, archs = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4]
    x = dict(np.load(src))
    out = {}

    def auto_mesh(shape, axes):
        return jax.make_mesh(shape, axes, axis_types=(
            jax.sharding.AxisType.Auto,) * len(axes))

    meshes = {"2x4": auto_mesh((2, 4), ("data", "model")),
              "2x2x2": auto_mesh((2, 2, 2), ("pod", "data", "model"))}
    mesh = meshes[only]
    for arch in archs.split(","):
        spec = get_arch(arch)
        cfg = spec.make_config(False)
        params = lm_init(jax.random.key(0), cfg)
        flat, _ = _flatten_with_paths(params)
        for p, v in flat.items():
            out["|".join((arch, "init", p))] = np.asarray(v, np.float32)
        for cell in LM_SMOKE_CELLS:
            low = spec.build(cfg, cell, mesh)
            pre = f"{arch}|{cell.name}|"
            inp = {k[len(pre):]: v for k, v in x.items()
                   if k.startswith(pre)}
            if cell.kind == "train":
                args = (params, adam_init(params, moment_dtype=cfg.moment_dtype),
                        {"tokens": inp["tokens"], "labels": inp["labels"]})
            elif cell.kind == "prefill":
                args = (params, inp["tokens"])
            else:
                args = (params, {"k": inp["k"], "v": inp["v"]},
                        inp["token"], inp["pos"])
            with use_mesh_rules(mesh, low.rules):
                res = jax.jit(low.fn)(*args)
            flat, _ = _flatten_with_paths(res)
            for p, v in flat.items():
                out["|".join((only, arch, cell.name, p))] = np.asarray(
                    v, np.float32)
    np.savez(dst, **out)
    print("done")
""")


def _mesh(name, device="cpu"):
    return make_smoke_mesh(multi_pod=name == "2x2x2", device=device)


def _cell(name):
    return next(c for c in LM_SMOKE_CELLS if c.name == name)


def _inputs(arch, cell, seed=0):
    """The cell's inputs after the parameters, as numpy arrays from a
    seed: token ids in the vocab, a normal cache, the decode position
    at half the cache (its later blocks wholly past it)."""
    cfg = get_arch(arch).make_config(False)
    rng = np.random.default_rng(seed)
    B, S = cell["global_batch"], cell["seq_len"]
    if cell.kind == "train":
        return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
                "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cell.kind == "prefill":
        return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.d_head)
    return {"k": rng.normal(size=shape).astype(np.float32),
            "v": rng.normal(size=shape).astype(np.float32),
            "token": rng.integers(0, cfg.vocab, (B,)).astype(np.int32),
            "pos": np.asarray(S // 2, np.int32)}


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's initial parameters and its partitioned programs' outputs for
    every arch and cell on both meshes, from a subprocess a mesh."""
    inputs = {(a, c): _inputs(a, _cell(c)) for a in ARCHS for c in CELLS}
    x = {f"{a}|{c}|{k}": v for (a, c), d in inputs.items()
         for k, v in d.items()}
    out = {}
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "in.npz")
        np.savez(src, **x)
        env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
        runs = []
        for name in MESHES:
            dst = os.path.join(d, f"{name}.npz")
            runs.append((dst, subprocess.Popen(
                [sys.executable, "-c", _PROG, src, dst, name,
                 ",".join(ARCHS)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env, cwd=REPO)))
        for dst, proc in runs:
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, stdout + "\n" + stderr
            out.update(np.load(dst))
    return inputs, out


def _tensors(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _program(name, arch, cell_name, want):
    """build_lm's program on a virtual CPU mesh, JAX's initial parameters
    and the cell's config."""
    cfg = get_arch(arch).make_config(False)
    prog = build_lm(cfg, _cell(cell_name), _mesh(name))
    params = args_from_numpy(prog.args[0], {
        p: want[f"{arch}|init|{p}"]
        for p in flatten_with_paths(prog.args[0])}, device="cpu")
    return prog, cfg, params


def _args(cell_name, cfg, params, inp):
    """The program's arguments (fresh tensors, so an in-place decode
    leaves the caller's alone)."""
    t = _tensors(inp)
    kind = _cell(cell_name).kind
    if kind == "train":
        return (params, tt.lm_adam_init(params, cfg),
                {"tokens": t["tokens"], "labels": t["labels"]})
    if kind == "prefill":
        return (params, t["tokens"])
    return (params, {"k": t["k"], "v": t["v"]}, t["token"], int(t["pos"]))


def _global(cell_name, cfg, args):
    kind = _cell(cell_name).kind
    if kind == "train":
        return tt.lm_train_step(*args, cfg)
    if kind == "prefill":
        return tt.lm_prefill(*args, cfg)
    return tt.lm_decode_step(*args, cfg)


def _np(tree):
    """A tree's leaves as float32 numpy, each Sharded gathered."""
    return {k: np.asarray((v.gather() if isinstance(v, Sharded) else
                           torch.as_tensor(v)).detach().float().cpu())
            for k, v in flatten_with_paths(tree).items()}


def _check_step(got, ref, msg):
    """A train step's (params, opt, metrics) against another's: numpy
    trees or tensors; the gradient is ref's first moment over 0.1."""
    gp, rp = _np(got[0]), _np(ref[0])
    gmu, rmu = _np(got[1].mu), _np(ref[1].mu)
    gnu, rnu = _np(got[1].nu), _np(ref[1].nu)
    assert sorted(gp) == sorted(rp)
    for k in rp:
        sure = np.abs(rmu[k]) / 0.1 > SURE_GRAD
        np.testing.assert_allclose(gp[k][sure], rp[k][sure], rtol=1e-5,
                                   atol=LR * 1e-3, err_msg=f"{msg} {k}")
        assert np.all(np.abs(gp[k] - rp[k]) <= 2 * LR), (msg, k)
        np.testing.assert_allclose(gmu[k], rmu[k], **MU_TOL,
                                   err_msg=f"{msg} mu {k}")
        np.testing.assert_allclose(gnu[k], rnu[k], **NU_TOL,
                                   err_msg=f"{msg} nu {k}")
    assert int(got[1].step) == int(ref[1].step) == 1
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got[2][name]), float(ref[2][name]),
                                   **LOSS_TOL, err_msg=f"{msg} {name}")


def _check_outputs(got, ref, msg):
    g, r = _np(got), _np(ref)
    assert sorted(g) == sorted(r), (sorted(g), sorted(r))
    for k in r:
        np.testing.assert_allclose(g[k], r[k], **TOL, err_msg=f"{msg} {k}")


class _JaxStep:
    """JAX's outputs of one train cell as the (params, opt, metrics) a
    port step returns."""

    def __init__(self, at, like):
        keys = flatten_with_paths(like)
        self.params = {p: at[f"0/{p}"] for p in keys}
        self.opt = type("Opt", (), {
            "mu": {p: at[f"1/.mu/{p}"] for p in keys},
            "nu": {p: at[f"1/.nu/{p}"] for p in keys},
            "step": at["1/.step"]})()
        self.metrics = {m: at[f"2/{m}"] for m in ("loss", "grad_norm")}

    def __iter__(self):
        return iter((self.params, self.opt, self.metrics))


def _jax_out(want, name, arch, cell):
    pre = f"{name}|{arch}|{cell}|"
    return {k[len(pre):]: v for k, v in want.items() if k.startswith(pre)}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", MESHES)
def test_partitioned_program_matches_global_and_jax(jax_ref, name, arch,
                                                    cell):
    """build_lm's program on the mesh runs one body a position (lm_plan)
    and gives the global program's outputs and JAX's GSPMD program's;
    a train step's new parameters and moments come back Sharded by
    their specs."""
    inputs, want = jax_ref
    prog, cfg, params = _program(name, arch, cell, want)
    c = _cell(cell)
    with use_mesh_rules(_mesh(name), prog.rules):
        plan = tt.lm_plan(cfg, c["global_batch"])
    assert plan is not None and plan.n == 8
    got = prog.fn(*_args(cell, cfg, params, inputs[arch, cell]))
    glob = _global(cell, cfg, _args(cell, cfg, params, inputs[arch, cell]))
    at = _jax_out(want, name, arch, cell)
    if c.kind == "train":
        assert all(isinstance(v, Sharded)
                   for v in flatten_with_paths(got[0]).values())
        _check_step(got, glob, f"{name} {arch} {cell} vs global")
        _check_step(got, tuple(_JaxStep(at, params)),
                    f"{name} {arch} {cell} vs JAX")
        return
    if c.kind == "prefill":
        jax_out = ({"k": at["0/k"], "v": at["0/v"]}, at["1"])
    else:
        jax_out = (at["0"], {"k": at["1/k"], "v": at["1/v"]})
    _check_outputs(got, glob, f"{name} {arch} {cell} vs global")
    _check_outputs(got, jax_out, f"{name} {arch} {cell} vs JAX")


@pytest.fixture
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", MESHES)
def test_partitioned_program_is_bitwise_run_to_run(jax_ref, deterministic,
                                                   name, arch, cell):
    inputs, want = jax_ref
    prog, cfg, params = _program(name, arch, cell, want)
    a, b = (_np(prog.fn(*_args(cell, cfg, params, inputs[arch, cell])))
            for _ in range(2))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{cell} {k}")


def test_replicated_batch_gives_jax_gradients_not_twice(jax_ref):
    """On (2, 2, 2) the train batch of 2 does not divide ('pod', 'data')
    = 4 and is replicated: every position takes the whole batch, and an
    FSDP gather's backward takes one copy's gradient, where a sum over
    'data' would count it twice."""
    inputs, want = jax_ref
    arch, cell = "llama3.2-1b", "train_4k"
    prog, cfg, params = _program("2x2x2", arch, cell, want)
    with use_mesh_rules(_mesh("2x2x2"), prog.rules):
        plan = tt.lm_plan(cfg, 2)
    assert plan.batch == ()
    got = prog.fn(*_args(cell, cfg, params, inputs[arch, cell]))
    at = _jax_out(want, "2x2x2", arch, cell)
    for k, mu in _np(got[1].mu).items():
        jmu = at[f"1/.mu/{k}"]
        np.testing.assert_allclose(mu, jmu, **MU_TOL, err_msg=k)
        if np.abs(jmu).max() > 1e-6:
            assert not np.allclose(mu, 2 * jmu, **MU_TOL), k


@pytest.mark.parametrize("cell,pos", [("decode_32k", 3), ("decode_32k", 31),
                                      ("long_500k", 5), ("long_500k", 0)])
@pytest.mark.parametrize("name", MESHES)
def test_decode_where_whole_cache_blocks_lie_past_pos(name, cell, pos):
    """A decode step at a pos that leaves cache blocks wholly past it
    (every logit masked, each such block's local sum of exp its length)
    weighs those blocks 0 in the merge: the global step's logits and
    cache, all finite."""
    c = _cell(cell)
    cfg = get_arch("llama3.2-1b").make_config(False)
    params = tt.lm_init(torch.Generator().manual_seed(2), cfg, device="cpu")
    inp = dict(_inputs("llama3.2-1b", c, seed=3), pos=np.asarray(pos))
    prog = build_lm(cfg, c, _mesh(name))
    got = prog.fn(*_args(cell, cfg, params, inp))
    ref = _global(cell, cfg, _args(cell, cfg, params, inp))
    assert np.isfinite(_np(got)["0"]).all()
    _check_outputs(got, ref, f"{name} {cell} pos {pos}")


def test_no_context_or_one_position_runs_the_global_code():
    """Without a context, or on a (1, 1) mesh, lm_plan is None and each
    entry point's outputs are the unpartitioned call's bits."""
    cfg = get_arch("llama3.2-1b").make_config(False)
    params = tt.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    inp = {c: _inputs("llama3.2-1b", _cell(c), seed=1) for c in CELLS}
    assert tt.lm_plan(cfg, 2) is None
    one = virtual_mesh((1, 1), ("data", "model"), "cpu")
    for cell in CELLS:
        ref = _np(_global(cell, cfg, _args(cell, cfg, params, inp[cell])))
        with use_mesh_rules(one, LM_RULES):
            assert tt.lm_plan(cfg, 2) is None
            got = _np(_global(cell, cfg,
                              _args(cell, cfg, params, inp[cell])))
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_an_moe_config_keeps_the_global_path():
    cfg = get_arch("kimi-k2-1t-a32b").make_config(False)
    params = tt.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 16)))
    ref = tt.lm_forward(params, tok, cfg)[0]
    with use_mesh_rules(_mesh("2x4"), LM_RULES):
        assert tt.lm_plan(cfg, 2) is None
        got = tt.lm_forward(params, tok, cfg)[0]
    assert torch.equal(got, ref)


ATTN_CASES = {
    # 6 heads on 'model' 4: the dense path's query rows over 'model'
    "seq": dict(n_heads=6, n_kv_heads=2),
    # the chunked path at 32 tokens: the attention on every shard
    "replicated": dict(n_heads=6, n_kv_heads=2, dense_attn_threshold=16,
                       attn_chunk_q=16, attn_chunk_kv=16),
    # 24 heads in groups of 4 on 'model' 4: 6 heads a shard straddle
    # their KV heads' groups, so each takes its own KV head
    "heads_straddle": dict(n_heads=24, n_kv_heads=6, d_head=8),
    # 12 heads, 4 KV heads: 3 a shard, one KV head each, local
    "heads_local": dict(n_heads=12, n_kv_heads=4, d_head=8),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_modes_match_the_global_program(case):
    """The attention's partitions where the heads do not divide 'model'
    (the dense path's query rows, the chunked path replicated) and where
    a shard's heads straddle their KV heads' groups: the gradients,
    prefill and a decode step against the global program's."""
    cfg = dataclasses.replace(get_arch("llama3.2-1b").make_config(False),
                              **ATTN_CASES[case])
    mode = {"seq": "seq", "replicated": "replicated"}.get(case, "heads")
    params = tt.lm_init(torch.Generator().manual_seed(4), cfg, device="cpu")
    rng = np.random.default_rng(4)
    B, S = 2, 32
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))}
    mesh = _mesh("2x4")
    cache = {n: torch.from_numpy(rng.normal(size=(
        cfg.n_layers, B, S, cfg.n_kv_heads, cfg.d_head)).astype(np.float32))
        for n in ("k", "v")}
    ref_g = tt.lm_grads(params, batch, cfg)
    ref_p = tt.lm_prefill(params, batch["tokens"], cfg)
    ref_d = tt.lm_decode_step(params, {n: v.clone() for n, v in
                                       cache.items()},
                              batch["tokens"][:, 0], 9, cfg)
    with use_mesh_rules(mesh, LM_RULES):
        assert tt._attn_mode(tt.lm_plan(cfg, B), cfg, S) == mode
        got_g = tt.lm_grads(params, batch, cfg)
        got_p = tt.lm_prefill(params, batch["tokens"], cfg)
        got_d = tt.lm_decode_step(params, {n: v.clone() for n, v in
                                           cache.items()},
                                  batch["tokens"][:, 0], 9, cfg)
    np.testing.assert_allclose(float(got_g[0]), float(ref_g[0]), **LOSS_TOL)
    g, r = _np(got_g[2]), _np(ref_g[2])
    for k in r:
        np.testing.assert_allclose(g[k], r[k], rtol=1e-4, atol=1e-6,
                                   err_msg=f"{case} grad {k}")
    _check_outputs(got_p, ref_p, f"{case} prefill")
    _check_outputs(got_d, ref_d, f"{case} decode")


# -- the collectives against their definitions ----------------------------------

def _pos_list(n, shape, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape)).requires_grad_(True)
            for _ in range(n)]


def _group_of(mesh, axes, i):
    """Position i's group over `axes`, in block order."""
    from repro_torch.distributed.topk import _groups
    return _groups(mesh, tuple(axes))[i]


@pytest.mark.parametrize("op", ["gather0_sum", "gather1_sum", "gather1_own",
                                "scatter0", "scatter1", "reduce", "copy",
                                "max"])
@pytest.mark.parametrize("axes", [("model",), ("data",), ("data", "model")])
@pytest.mark.parametrize("name", MESHES)
def test_collectives_pass_gradcheck_and_their_definition(name, axes, op):
    """Each collective over every position's group equals its definition
    exactly (the group's blocks joined, or stacked in block order and
    summed by one reduction, or their max). The all-gather with grad="sum" and the reduce-scatter,
    each the other's backward, pass gradcheck in f64. Megatron's pair
    and the all-gather with grad="own" are not the gradients of their
    forwards taken alone (every copy of the replicated work seeds its
    own backward; the model tests hold the composition against the
    global program's gradients): their backwards equal their
    definitions exactly, the pair each the other's forward, the "own"
    gather each position's own slice of its own gradient."""
    mesh = _mesh(name)
    n = mesh.devices.size
    size = int(np.prod([mesh.shape[a] for a in axes]))
    dim = 1 if "1" in op else 0
    if op.startswith("scatter"):
        xs = _pos_list(n, (2, size) if dim else (size, 2))
    else:
        xs = _pos_list(n, (2, 3))
    if op.startswith("gather"):
        grad = op.split("_")[1]
        fn = lambda *x: tuple(all_gather_dim(mesh, axes, x, dim, grad))  # noqa
    elif op.startswith("scatter"):
        fn = lambda *x: tuple(reduce_scatter_dim(mesh, axes, x, dim))  # noqa
    elif op == "reduce":
        fn = lambda *x: tuple(reduce_from_shards(mesh, axes, x))  # noqa
    elif op == "copy":
        fn = lambda *x: tuple(copy_to_shards(mesh, axes, x))  # noqa
    else:
        fn = lambda *x: tuple(max_over_shards(mesh, axes, x))  # noqa

    def summed(blocks):
        return torch.stack(blocks).sum(0)
    got = fn(*xs)
    assert len(got) == n
    for i, g in enumerate(got):
        members, r = _group_of(mesh, axes, i)
        blocks = [xs[q].detach() for q in members]
        want = {"gather": lambda: torch.cat(blocks, dim),
                "scatter": lambda: summed([torch.chunk(b, size, dim)[r]
                                           for b in blocks]),
                "reduce": lambda: summed(blocks),
                "copy": lambda: xs[i].detach(),
                "max": lambda: torch.stack(blocks).amax(0)}[
            op.split("_")[0].rstrip("01")]()
        assert torch.equal(g.detach(), want), (op, i)
    if op in ("gather0_sum", "gather1_sum", "scatter0", "scatter1"):
        assert torch.autograd.gradcheck(fn, tuple(xs))
    elif op != "max":
        gs = _pos_list(n, tuple(got[0].shape), seed=1)
        back = torch.autograd.grad(got, xs, [g.detach() for g in gs])
        for i, b in enumerate(back):
            members, r = _group_of(mesh, axes, i)
            if op == "reduce":
                want = gs[i].detach()
            elif op == "copy":
                want = summed([gs[q].detach() for q in members])
            else:
                want = torch.chunk(gs[i].detach(), size, dim)[r]
            assert torch.equal(b, want), (op, i)


# -- a mesh across cards --------------------------------------------------------

@pytest.mark.cuda
def test_a_mesh_across_cards_equals_a_virtual_one_for_the_lm_step():
    """On a (2, 2) mesh over 4 cards (each shard body on its own card),
    llama3.2-1b's SMOKE train step and a decode step give the bits of
    the same programs on a virtual (2, 2) mesh over one card. Skips
    with fewer than 4 cards."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    card = torch.device("cuda", 0)
    cfg = get_arch("llama3.2-1b").make_config(False)
    params = tt.lm_init(torch.Generator(device=card).manual_seed(3), cfg,
                        device=card)
    train = _tensors(_inputs("llama3.2-1b", _cell("train_4k")))
    dec = _tensors(_inputs("llama3.2-1b", _cell("decode_32k")))
    axes = ("data", "model")
    outs = {}
    for label, mesh in (("cards", make_mesh((2, 2), axes)),
                        ("virtual", virtual_mesh((2, 2), axes, card))):
        with use_mesh_rules(mesh, LM_RULES):
            assert tt.lm_plan(cfg, 2).n == 4
            step = tt.lm_train_step(
                params, tt.lm_adam_init(params, cfg),
                {k: v.to(card) for k, v in train.items()}, cfg)
            decode = tt.lm_decode_step(
                params, {n: dec[n].to(card) for n in ("k", "v")},
                dec["token"].to(card), int(dec["pos"]), cfg)
        outs[label] = (step, decode)
    a, b = _np(outs["cards"]), _np(outs["virtual"])
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
