"""The mesh-context half of distributed.sharding, launch.mesh's
placement by a spec (shard / Sharded), CheckpointStore.restore onto a
mesh and the runner's replay through it, held against the JAX package.

JAX's context needs a mesh of devices, so its side runs once, in one
module-scoped subprocess with 8 forced host devices on the (2, 4)
('data', 'model') and (2, 2, 2) ('pod', 'data', 'model') smoke meshes
(their axes of type Auto): for each family's rule table, the filtered
rules, logical_spec and named_sharding of every logical name under
use_mesh_rules; eval_shape_with_sharding over llama3.2-1b's SMOKE
init; and jax.device_put of a tensor by several specs, each device's
block. drop_nondivisible runs against JAX's here (it reads only the
mesh's axis sizes). The port runs on virtual meshes over the CPU.
Every comparison is exact; restored blocks and the replayed run's state
are bitwise.
"""

import os
import subprocess
import sys
import tempfile
import textwrap
import threading
from itertools import product
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.distributed import sharding as jsharding
from repro_torch.checkpoint import CheckpointStore
from repro_torch.checkpoint.store import flatten_with_paths, unflatten_like
from repro_torch.configs import get_arch
from repro_torch.distributed import sharding
from repro_torch.distributed.runner import FaultTolerantRunner
from repro_torch.launch.mesh import (
    Sharded,
    block_of,
    make_smoke_mesh,
    shard,
    spec_entries,
)
from repro_torch.models.transformer import lm_init, lm_logical_axes
from repro_torch.optim import adam_init

REPO = Path(__file__).resolve().parent.parent
MESHES = ("2x4", "2x2x2")
FAMILIES = ("lm", "recsys", "gnn", "paper")
PLACE_SPECS = {"2x4": [("data", "model"), (("data", "model"),),
                       (None, ("model", "data")), ("model",), ()],
               "2x2x2": [(("pod", "data"), "model"), ("model", "pod"),
                         (None, ("data", "model", "pod")), ()]}
PLACE_SHAPE = (8, 16)

_PROG = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.checkpoint.store import _flatten_with_paths
    from repro.configs import get_arch
    from repro.distributed.sharding import (
        LM_RULES, RULES_BY_FAMILY, current_mesh, current_rules,
        eval_shape_with_sharding, logical_spec, named_sharding,
        use_mesh_rules)
    from repro.models.transformer import lm_init, lm_logical_axes

    dst, specs_json = sys.argv[1], sys.argv[2]
    place_specs = json.loads(specs_json)
    out, arrays = {}, {}

    def norm(spec):
        return [None if e is None else ([e] if isinstance(e, str)
                                        else list(e)) for e in spec]

    def auto_mesh(shape, axes):
        return jax.make_mesh(shape, axes, axis_types=(
            jax.sharding.AxisType.Auto,) * len(axes))

    meshes = {"2x4": auto_mesh((2, 4), ("data", "model")),
              "2x2x2": auto_mesh((2, 2, 2), ("pod", "data", "model"))}
    x = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    for mname, mesh in meshes.items():
        for family, rules in RULES_BY_FAMILY.items():
            names = sorted(rules.rules) + ["unknown"]
            with use_mesh_rules(mesh, rules):
                assert current_mesh() is mesh
                out[f"{mname}|{family}|rules"] = {
                    k: (None if v is None else
                        ([v] if isinstance(v, str) else list(v)))
                    for k, v in current_rules().rules.items()}
                for n in names:
                    out[f"{mname}|{family}|spec|{n}"] = norm(
                        logical_spec(n, None))
                    out[f"{mname}|{family}|named|{n}"] = norm(
                        named_sharding(None, n).spec)
        cfg = get_arch("llama3.2-1b").make_config(False)
        got = eval_shape_with_sharding(
            lambda k: lm_init(k, cfg), lambda: lm_logical_axes(cfg), mesh,
            LM_RULES, jax.random.key(0))
        flat, _ = _flatten_with_paths(got)
        out[f"{mname}|eval_shape"] = {
            p: [list(s.shape), str(s.dtype), norm(s.sharding.spec)]
            for p, s in flat.items()}
        for i, spec in enumerate(place_specs[mname]):
            spec = [tuple(e) if isinstance(e, list) else e for e in spec]
            arr = jax.device_put(x, NamedSharding(mesh, P(*spec)))
            for pos in np.ndindex(*mesh.devices.shape):
                dev = mesh.devices[pos]
                blk = next(s for s in arr.addressable_shards
                           if s.device == dev)
                arrays[f"{mname}|{i}|" + "_".join(map(str, pos))] = (
                    np.asarray(blk.data))
    out["no_context"] = [current_mesh() is None, current_rules() is None,
                         norm(logical_spec("batch")),
                         named_sharding("batch") is None]
    with open(dst + ".json", "w") as f:
        json.dump(out, f)
    np.savez(dst, **arrays)
    print("done")
""")


@pytest.fixture(scope="module")
def jax_ref():
    import json
    with tempfile.TemporaryDirectory() as d:
        dst = os.path.join(d, "out.npz")
        env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
        specs = {m: [[list(e) if isinstance(e, tuple) else e for e in s]
                     for s in v] for m, v in PLACE_SPECS.items()}
        r = subprocess.run([sys.executable, "-c", _PROG, dst,
                            json.dumps(specs)],
                           capture_output=True, text=True, env=env,
                           cwd=REPO, timeout=300)
        assert r.returncode == 0, r.stdout + "\n" + r.stderr
        with open(dst + ".json") as f:
            out = json.load(f)
        arrays = dict(np.load(dst))
    return out, arrays


def _mesh(name):
    return make_smoke_mesh(multi_pod=name == "2x2x2", device="cpu")


def _norm(spec):
    return [list(e) if e else None for e in spec_entries(spec, len(spec))]


# -- the context ---------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("name", MESHES)
def test_context_resolves_as_jax(jax_ref, name, family):
    want = jax_ref[0]
    mesh = _mesh(name)
    rules = sharding.RULES_BY_FAMILY[family]
    with sharding.use_mesh_rules(mesh, rules):
        assert sharding.current_mesh() is mesh
        got = {k: (None if v is None else
                   ([v] if isinstance(v, str) else list(v)))
               for k, v in sharding.current_rules().rules.items()}
        assert got == want[f"{name}|{family}|rules"]
        for n in sorted(rules.rules) + ["unknown"]:
            assert _norm(sharding.logical_spec(n, None)) == \
                want[f"{name}|{family}|spec|{n}"], n
            sh = sharding.named_sharding(None, n)
            assert sh.mesh is mesh
            assert _norm(sh.spec) == want[f"{name}|{family}|named|{n}"], n
    assert sharding.current_mesh() is None


def test_no_context_is_the_identity(jax_ref):
    want = jax_ref[0]["no_context"]
    got = [sharding.current_mesh() is None,
           sharding.current_rules() is None,
           _norm(sharding.logical_spec("batch")),
           sharding.named_sharding("batch") is None]
    assert got == want == [True, True, [], True]
    x = torch.ones(3, 4)
    assert sharding.logical_shard(x, "batch", "embed") is x


def test_logical_shard_returns_x_under_a_context():
    """Under a context logical_shard resolves and relaxes the spec and
    hands x back, as with_sharding_constraint leaves its values; the
    gradient flows through it unchanged."""
    x = torch.randn(6, 5, requires_grad=True)
    with sharding.use_mesh_rules(_mesh("2x4"), sharding.LM_RULES):
        y = sharding.logical_shard(x, "batch", "heads", "embed")
        assert y is x
        (y * 2).sum().backward()
    assert torch.equal(x.grad, torch.full((6, 5), 2.0))


def test_context_nests_and_is_thread_local():
    outer, inner = _mesh("2x4"), _mesh("2x2x2")
    seen = []
    with sharding.use_mesh_rules(outer, sharding.LM_RULES):
        t = threading.Thread(target=lambda: seen.append(
            sharding.current_mesh()))
        t.start()
        t.join()
        with sharding.use_mesh_rules(inner, sharding.GNN_RULES):
            assert sharding.current_mesh() is inner
            assert "nodes" in sharding.current_rules().rules
        assert sharding.current_mesh() is outer
        with sharding.use_mesh_rules(outer, None):
            assert sharding.current_mesh() is None
    assert seen == [None] and sharding.current_mesh() is None


def _cases():
    entries = (None, "data", "model", "pod", ("data", "model"),
               ("pod", "data"), ("model", "data"))
    for spec in product(entries, repeat=2):
        for shape in ((8, 6), (4, 8), (2, 3), (16,), (6, 4, 5)):
            yield spec, shape
    yield ("data",), (8, 8, 8)
    yield ("model", "model", "data"), (4, 4, 2)


@pytest.mark.parametrize("name", MESHES)
def test_drop_nondivisible_matches_jax(name):
    from jax.sharding import PartitionSpec as P

    mesh = _mesh(name)
    fake = SimpleNamespace(shape=mesh.shape)
    for spec, shape in _cases():
        if any(a not in mesh.axis_names for e in spec if e
               for a in ((e,) if isinstance(e, str) else e)):
            continue
        got = sharding.drop_nondivisible(spec, shape, mesh)
        want = jsharding.drop_nondivisible(P(*spec), shape, fake)
        assert len(got) == len(shape)
        assert _norm(got) == _norm(tuple(want)), (spec, shape)


@pytest.mark.parametrize("name", MESHES)
def test_eval_shape_with_sharding_matches_jax(jax_ref, name):
    want = jax_ref[0][f"{name}|eval_shape"]
    cfg = get_arch("llama3.2-1b").make_config(False)
    mesh = _mesh(name)
    got = sharding.eval_shape_with_sharding(
        lambda: lm_init(None, cfg, device="meta"),
        lambda: lm_logical_axes(cfg), mesh, sharding.LM_RULES)
    flat = flatten_with_paths(got)
    assert sorted(flat) == sorted(want)
    for p, s in flat.items():
        assert s.sharding.mesh is mesh
        assert [list(s.shape), str(s.dtype).removeprefix("torch."),
                _norm(s.sharding.spec)] == want[p], p


# -- placement ---------------------------------------------------------------

@pytest.mark.parametrize("name", MESHES)
def test_shard_lays_blocks_as_jax_device_put(jax_ref, name):
    """Each mesh position holds the block jax.device_put gives that
    device under the same spec; on a virtual mesh every block is a view
    of the tensor, and gather puts them back bitwise."""
    arrays = jax_ref[1]
    mesh = _mesh(name)
    x = torch.arange(8 * 16, dtype=torch.float32).reshape(PLACE_SHAPE)
    for i, spec in enumerate(PLACE_SPECS[name]):
        placed = shard(mesh, x, spec)
        assert isinstance(placed, Sharded) and placed.shape == PLACE_SHAPE
        for pos in np.ndindex(*mesh.devices.shape):
            blk = placed.at(pos)
            want = arrays[f"{name}|{i}|" + "_".join(map(str, pos))]
            np.testing.assert_array_equal(blk.numpy(), want)
            assert blk.untyped_storage().data_ptr() == \
                x.untyped_storage().data_ptr()
        assert torch.equal(placed.gather("cpu"), x)


def test_shard_refuses_what_named_sharding_refuses():
    mesh = _mesh("2x4")
    with pytest.raises(ValueError, match="not divisible"):
        shard(mesh, torch.zeros(3, 4), ("data",))
    with pytest.raises(ValueError, match="twice"):
        shard(mesh, torch.zeros(4, 4), ("data", "data"))
    with pytest.raises(ValueError, match="more entries"):
        shard(mesh, torch.zeros(4), ("data", None))


# -- restore onto a mesh, and the runner's replay through it ------------------

def _lm_state():
    cfg = get_arch("llama3.2-1b").make_config(False)
    gen = torch.Generator().manual_seed(0)
    params = lm_init(gen, cfg, device="cpu")
    flat = flatten_with_paths(params)
    opt = adam_init({k: v + 0.5 for k, v in flat.items()}, device="cpu")
    return cfg, params, opt


@pytest.mark.parametrize("name", MESHES)
def test_restore_onto_a_mesh_gives_bitwise_blocks(name, tmp_path):
    """restore(shardings=param_shardings(...)) places each parameter by
    its relaxed spec: every block at every position is bitwise the
    saved leaf's slice; leaves without a sharding (Adam's state) come
    back on the device; the mesh's blocks are saved back as the whole
    leaf."""
    cfg, params, opt = _lm_state()
    mesh = _mesh(name)
    store = CheckpointStore(str(tmp_path), keep_last=2)
    store.save(3, (params, opt), extra={"next_step": 3})
    shardings = sharding.param_shardings(lm_logical_axes(cfg), mesh,
                                         sharding.LM_RULES)
    (got, gopt), extra = store.restore((params, opt),
                                       shardings=(shardings, None),
                                       device="cpu")
    assert extra == {"next_step": 3}
    flat_s = flatten_with_paths(shardings)
    for path, want in flatten_with_paths(params).items():
        leaf = flatten_with_paths(got)[path]
        assert isinstance(leaf, Sharded)
        spec = sharding.drop_nondivisible(flat_s[path].spec, want.shape,
                                          mesh)
        assert tuple(leaf.spec) == spec
        bs = leaf.block_shape()
        for pos in np.ndindex(*mesh.devices.shape):
            blk = leaf.at(pos)
            idx = block_of(mesh, spec_entries(spec, want.dim()), pos)
            sl = tuple(slice(i * b, (i + 1) * b) for i, b in zip(idx, bs))
            assert blk.dtype == want.dtype
            assert torch.equal(blk, want[sl]), (path, pos)
    for k, v in gopt.mu.items():
        assert isinstance(v, torch.Tensor) and torch.equal(v, opt.mu[k])
    store.save(4, (got, gopt), extra={"next_step": 4})
    (again, _), _ = store.restore((params, opt), step=4, device="cpu")
    for p, v in flatten_with_paths(params).items():
        assert torch.equal(flatten_with_paths(again)[p], v)


def test_runner_replays_bitwise_with_shardings(tmp_path):
    """The runner passes shardings= through to restore: a run with a
    failure injected replays from a checkpoint restored onto the mesh
    and ends bitwise where the uninterrupted run ends."""
    torch.manual_seed(0)
    mesh = _mesh("2x4")
    w0 = torch.randn(8, 4)
    shardings = {"w": sharding.NamedSharding(mesh, ("data", "model")),
                 "step": None}

    def whole(x):
        return x.gather("cpu") if isinstance(x, Sharded) else x

    def step_fn(state, batch):
        w = whole(state["w"])
        w = w - 0.1 * torch.tanh(w * batch)
        return {"w": w, "step": whole(state["step"]) + 1}, {
            "loss": float(w.square().sum())}

    def batch_fn(s):
        return torch.full((8, 4), 0.01 * (s + 1))

    init = {"w": w0, "step": torch.zeros((), dtype=torch.int32)}
    runs = {}
    for label, fail in (("clean", None), ("failure", {5})):
        store = CheckpointStore(str(tmp_path / label), keep_last=2)
        runner = FaultTolerantRunner(store, step_fn, batch_fn, ckpt_every=3,
                                     async_ckpt=False)
        state, rep = runner.run(
            init, 8, shardings=shardings, device="cpu",
            fail_at=None if fail is None else (
                lambda s: s in fail and not fail.discard(s)))
        runs[label] = (state, rep)
    assert runs["failure"][1].restarts == 1 and runs["clean"][1].restarts == 0
    a, b = runs["failure"][0], runs["clean"][0]
    assert torch.equal(whole(a["w"]), whole(b["w"]))
    assert int(a["step"]) == int(b["step"]) == 8
    # the replay restored the checkpoint onto the mesh
    store = CheckpointStore(str(tmp_path / "failure"), keep_last=2)
    restored, _ = store.restore(init, shardings=shardings, device="cpu")
    assert isinstance(restored["w"], Sharded)
    assert isinstance(unflatten_like(restored, flatten_with_paths(
        restored))["step"], torch.Tensor)
