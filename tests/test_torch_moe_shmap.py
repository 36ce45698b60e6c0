"""The shard_map expert-parallel MoE (models.layers.moe_apply_shmap) and
the transformer's 'shmap' dispatch rule, held against JAX's.

JAX's moe_apply_shmap needs a mesh of devices, so it runs once, in one
module-scoped subprocess with 8 forced host devices on the (2, 4)
('data', 'model') and (2, 2, 2) ('pod', 'data', 'model') smoke meshes
(their axes of type Auto), at kimi-k2's and llama4-scout's SMOKE
configs, at the default capacity factor and at 0.25 (where assignments
drop), on JAX's moe_init(key(0)) and inputs drawn here with numpy from
a seed. JAX's drops are counted there from its own routing (top_k of the
router's softmax, _positions_by_expert, moe_capacity of a batch block's
tokens). The port runs the same inputs on virtual meshes over the CPU.

Tolerances: the drops exactly; y rtol 1e-5, atol 1e-5; aux rtol 1e-5
(the pmean's sum over batch blocks comes in another order); lm_forward
with the 'shmap' variant under use_mesh_rules, logits and aux, rtol 1e-5,
atol 1e-5.
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

from repro_torch.checkpoint.store import flatten_with_paths, unflatten_like
from repro_torch.configs import get_arch
from repro_torch.distributed.sharding import LM_RULES, use_mesh_rules
from repro_torch.launch.mesh import make_smoke_mesh, virtual_mesh
from repro_torch.models import layers
from repro_torch.models import transformer as tt

REPO = Path(__file__).resolve().parent.parent
MESHES = ("2x4", "2x2x2")
ARCHS = ("kimi-k2-1t-a32b", "llama4-scout-17b-a16e")
CFS = (1.25, 0.25)                # the default capacity factor, and drops
B, S = 4, 32
TOL = dict(rtol=1e-5, atol=1e-5)

_PROG = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    from dataclasses import replace
    import jax, jax.numpy as jnp
    import numpy as np

    from repro.checkpoint.store import _flatten_with_paths
    from repro.configs import get_arch
    from repro.distributed.sharding import LM_RULES, use_mesh_rules
    from repro.models.layers import (
        _positions_by_expert, moe_apply_shmap, moe_capacity, moe_init)
    from repro.models.transformer import lm_forward, lm_init

    src, dst = sys.argv[1], sys.argv[2]
    x = dict(np.load(src))
    out = {}

    def auto_mesh(shape, axes):
        return jax.make_mesh(shape, axes, axis_types=(
            jax.sharding.AxisType.Auto,) * len(axes))

    meshes = {"2x4": auto_mesh((2, 4), ("data", "model")),
              "2x2x2": auto_mesh((2, 2, 2), ("pod", "data", "model"))}
    for arch in ("kimi-k2-1t-a32b", "llama4-scout-17b-a16e"):
        base = get_arch(arch).make_config(False)
        params = moe_init(jax.random.key(0), base)
        flat, _ = _flatten_with_paths(params)
        for p, v in flat.items():
            out[f"{arch}|params|{p}"] = np.asarray(v)
        xin = jnp.asarray(x[f"{arch}|x"])
        for cf in ("1.25", "0.25"):
            cfg = replace(base, capacity_factor=float(cf),
                          moe_dispatch="shmap")
            for name, mesh in meshes.items():
                y, aux = jax.jit(lambda p, v: moe_apply_shmap(
                    p, v, cfg, mesh))(params, xin)
                out[f"{arch}|{cf}|{name}|y"] = np.asarray(y)
                out[f"{arch}|{cf}|{name}|aux"] = np.asarray(aux)
                nb = 2 if name == "2x4" else 4
                Bb, S, D = xin.shape
                c_l = moe_capacity(Bb * S // nb, cfg)
                drops = 0
                for blk in np.split(np.asarray(xin), nb):
                    xt = jnp.asarray(blk).reshape(-1, D)
                    probs = jax.nn.softmax(
                        xt.astype(jnp.float32) @ params["router"], axis=-1)
                    _, ids = jax.lax.top_k(probs, cfg.top_k)
                    pos = _positions_by_expert(ids.reshape(-1),
                                               cfg.n_experts)
                    drops += int(jnp.sum(pos >= c_l))
                out[f"{arch}|{cf}|{name}|drops"] = np.asarray(drops)
        # the transformer's 'shmap' dispatch under the mesh context
        cfg = replace(base, moe_dispatch="shmap")
        lm = lm_init(jax.random.key(1), cfg)
        flat, _ = _flatten_with_paths(lm)
        for p, v in flat.items():
            out[f"{arch}|lm|{p}"] = np.asarray(v)
        mesh = meshes["2x4"]
        with use_mesh_rules(mesh, LM_RULES):
            logits, aux = jax.jit(lambda p, t: lm_forward(p, t, cfg))(
                lm, jnp.asarray(x[f"{arch}|tokens"]))
        out[f"{arch}|lm_logits"] = np.asarray(logits)
        out[f"{arch}|lm_aux"] = np.asarray(aux)
    np.savez(dst, **out)
    print("done")
""")


def _cfg(arch, **kw):
    return replace(get_arch(arch).make_config(False), **kw)


def _inputs():
    rng = np.random.default_rng(0)
    x = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        x[f"{arch}|x"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
        x[f"{arch}|tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(
            np.int32)
    return x


@pytest.fixture(scope="module")
def jax_ref():
    x = _inputs()
    with tempfile.TemporaryDirectory() as d:
        src, dst = os.path.join(d, "in.npz"), os.path.join(d, "out.npz")
        np.savez(src, **x)
        env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
        r = subprocess.run([sys.executable, "-c", _PROG, src, dst],
                           capture_output=True, text=True, env=env,
                           cwd=REPO, timeout=300)
        assert r.returncode == 0, r.stdout + "\n" + r.stderr
        out = dict(np.load(dst))
    return x, out


def _mesh(name):
    return make_smoke_mesh(multi_pod=name == "2x2x2", device="cpu")


def _tree(out, prefix, like):
    return unflatten_like(like, {
        p: torch.from_numpy(np.array(out[f"{prefix}|{p}"]))
        for p in flatten_with_paths(like)})


def _moe_params(out, arch):
    cfg = _cfg(arch)
    like = layers.moe_init(None, cfg, device="meta")
    return _tree(out, f"{arch}|params", like)


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol,
                               err_msg=msg)


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", MESHES)
def test_moe_apply_shmap_matches_jax(jax_ref, name, arch, cf):
    x, want = jax_ref
    cfg = _cfg(arch, capacity_factor=cf, moe_dispatch="shmap")
    params = _moe_params(want, arch)
    y, aux, drops = layers.moe_apply_shmap_with_drops(
        params, torch.from_numpy(x[f"{arch}|x"]), cfg, _mesh(name))
    key = f"{arch}|{cf}|{name}"
    assert int(drops) == int(want[f"{key}|drops"])
    _close(y, want[f"{key}|y"], msg=key)
    _close(aux, want[f"{key}|aux"], dict(rtol=1e-5, atol=0), key)
    y2, aux2 = layers.moe_apply_shmap(
        params, torch.from_numpy(x[f"{arch}|x"]), cfg, _mesh(name))
    assert torch.equal(y2, y) and torch.equal(aux2, aux)


def test_drops_occur_at_the_small_capacity(jax_ref):
    """The 0.25 capacity factor drops assignments on every mesh (so the
    drop path is exercised), the default one drops fewer."""
    _, want = jax_ref
    for arch in ARCHS:
        for name in MESHES:
            low = int(want[f"{arch}|0.25|{name}|drops"])
            high = int(want[f"{arch}|1.25|{name}|drops"])
            assert low > 0 and high < low, (arch, name, low, high)


@pytest.mark.parametrize("arch", ARCHS)
def test_shmap_equals_the_global_dispatch_where_nothing_drops(jax_ref, arch):
    """With a capacity no block reaches, the expert-parallel MoE and the
    global moe_apply compute the same function (to rounding: the EP
    combine adds the model shards' partial sums)."""
    x, want = jax_ref
    cfg = _cfg(arch, capacity_factor=8.0, moe_dispatch="shmap")
    params = _moe_params(want, arch)
    xin = torch.from_numpy(x[f"{arch}|x"])
    for name in MESHES:
        y, aux, drops = layers.moe_apply_shmap_with_drops(
            params, xin, cfg, _mesh(name))
        yg, auxg, dg = layers.moe_apply_with_drops(params, xin, cfg)
        assert int(drops) == int(dg) == 0
        _close(y, yg.numpy(), TOL, name)
        _close(aux, auxg.numpy(), dict(rtol=1e-5, atol=0), name)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_with_the_shmap_variant_matches_jax(jax_ref, arch):
    """lm_forward with moe_dispatch='shmap' under use_mesh_rules(mesh,
    LM_RULES) takes moe_apply_shmap and matches JAX's."""
    x, want = jax_ref
    cfg = _cfg(arch, moe_dispatch="shmap")
    params = _tree(want, f"{arch}|lm", tt.lm_init(None, cfg, device="meta"))
    tokens = torch.from_numpy(x[f"{arch}|tokens"])
    calls = []
    orig = tt.moe_apply_shmap_with_drops

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    tt.moe_apply_shmap_with_drops = counting
    try:
        with use_mesh_rules(_mesh("2x4"), LM_RULES):
            logits, aux = tt.lm_forward(params, tokens, cfg)
    finally:
        tt.moe_apply_shmap_with_drops = orig
    assert len(calls) == cfg.n_layers
    _close(logits, want[f"{arch}|lm_logits"], TOL, arch)
    _close(aux, want[f"{arch}|lm_aux"], dict(rtol=1e-5, atol=0), arch)


def test_shmap_dispatch_needs_a_mesh_whose_model_axis_divides_experts():
    """Without a mesh, or under one whose 'model' axis does not divide
    n_experts, the 'shmap' dispatch takes the global moe_apply (bitwise
    the 'onehot' dispatch's); moe_apply_shmap itself refuses that mesh,
    as shard_map refuses the split."""
    cfg = _cfg("llama4-scout-17b-a16e", moe_dispatch="shmap")   # 4 experts
    params = tt.lm_init(None, cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 8),
                           generator=torch.Generator().manual_seed(0))
    want = tt.lm_forward(params, tokens, replace(cfg, moe_dispatch="onehot"))
    three = virtual_mesh((2, 3), ("data", "model"), "cpu")
    for ctx in (use_mesh_rules(None, None), use_mesh_rules(three, LM_RULES)):
        with ctx:
            got = tt.lm_forward(params, tokens, cfg)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="do not split"):
        layers.moe_apply_shmap(tt._layer(params, 0)["moe"],
                               torch.zeros(2, 8, cfg.d_model), cfg, three)
