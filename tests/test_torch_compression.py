"""The int8 compressed psum with error feedback (optim.compression)
held bitwise against the JAX package's.

compress_int8 and decompress_int8 run here against JAX's on one device.
compressed_psum and psum_with_error_feedback are shard bodies over a
mesh axis: JAX's run once, in one module-scoped subprocess with 8 forced
host devices, inside shard_map over 'data' on the (2, 4) ('data',
'model') smoke mesh and over ('pod', 'data') on the (2, 2, 2) one; the
port's over the same axes of virtual meshes over the CPU, one block a
shard. JAX's run op by op, not under jax.jit: XLA's fusion rewrites
amax / 127 into a multiply by the rounded reciprocal and contracts
x - q * scale into a fused multiply-add, which round otherwise. Every
output is held bitwise (elementwise IEEE arithmetic and an exact int32
sum), every shard's result too. The inputs, from a numpy
seed, are a small tree of f32 leaves whose shards differ in scale, a
leaf of zeros, and a leaf whose quotients by the scale fall on halves
(half to even, as jnp.round).
"""

import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as jcomp
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.optim import compression

REPO = Path(__file__).resolve().parent.parent
CASES = {"2x4": ("data",), "2x2x2": ("pod", "data")}
LEAVES = ("w", "b", "zero", "halves")

_PROG = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from repro.distributed.compat import shard_map
    from repro.optim.compression import (
        compressed_psum, psum_with_error_feedback)

    src, dst = sys.argv[1], sys.argv[2]
    x = dict(np.load(src))
    out = {}
    cases = {"2x4": (((2, 4), ("data", "model")), ("data",)),
             "2x2x2": (((2, 2, 2), ("pod", "data", "model")),
                       ("pod", "data"))}
    for name, ((shape, names), axes) in cases.items():
        mesh = jax.make_mesh(shape, names, axis_types=(
            jax.sharding.AxisType.Auto,) * len(names))
        spec = P(axes)
        for leaf in ("w", "b", "zero", "halves"):
            g = x[f"{name}|{leaf}|x"]
            r = x[f"{name}|{leaf}|r"]
            s = shard_map(lambda v: compressed_psum(v, axes),
                          mesh=mesh, in_specs=spec, out_specs=spec,
                          check_vma=False)(g)
            m, nr = (shard_map(
                lambda v, e: psum_with_error_feedback(v, e, axes),
                mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec),
                check_vma=False))(g, r)
            out[f"{name}|{leaf}|psum"] = np.asarray(s)
            out[f"{name}|{leaf}|mean"] = np.asarray(m)
            out[f"{name}|{leaf}|res"] = np.asarray(nr)
    np.savez(dst, **out)
    print("done")
""")


def _n(name):
    return 2 if name == "2x4" else 4


def _inputs():
    """Per mesh and leaf: the shards' blocks stacked on a leading axis
    (n x the block's shape), and residuals."""
    rng = np.random.default_rng(0)
    x = {}
    for name in CASES:
        n = _n(name)
        scale = np.geomspace(0.5, 3.0, n).reshape((n, 1, 1))
        halves = np.zeros((n, 6, 10))
        # shard 0's largest entry makes the shared scale 1.0, so the
        # quotients are exactly these halves
        halves[:, 0, :6] = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])
        halves[1:] *= 0.5
        # one block shape for every leaf: JAX's un-jitted shard_map then
        # compiles each of its operations once
        blocks = {
            "w": rng.normal(size=(n, 6, 10)) * scale,
            "b": rng.normal(size=(n, 6, 10)) * scale[::-1] * 1e-3,
            "zero": np.zeros((n, 6, 10)),
            "halves": halves,
        }
        for leaf, v in blocks.items():
            x[f"{name}|{leaf}|x"] = v.reshape((-1,) + v.shape[2:]).astype(
                np.float32)
            x[f"{name}|{leaf}|r"] = (rng.normal(size=v.shape) * 1e-3).reshape(
                (-1,) + v.shape[2:]).astype(np.float32)
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


def _blocks(a, n):
    return list(torch.from_numpy(a).chunk(n))


def _stacked(parts):
    return torch.cat(parts).numpy()


def test_compress_and_decompress_match_jax_bitwise():
    rng = np.random.default_rng(1)
    for x in (rng.normal(size=(33, 17)) * 5.0, np.zeros((4,)),
              np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5])):
        x = x.astype(np.float32)
        q, s = compression.compress_int8(torch.from_numpy(x))
        jq, js = jcomp.compress_int8(jnp.asarray(x))
        assert q.dtype == torch.int8 and s.shape == ()
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert s.numpy().tobytes() == np.asarray(js).tobytes()
        d = compression.decompress_int8(q, s)
        jd = jcomp.decompress_int8(jq, js)
        assert d.numpy().tobytes() == np.asarray(jd).tobytes()


@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("name", CASES)
def test_compressed_psum_matches_jax_bitwise(jax_ref, name, leaf):
    x, want = jax_ref
    n, axes = _n(name), CASES[name]
    key = f"{name}|{leaf}"
    got = compression.compressed_psum(_blocks(x[f"{key}|x"], n), axes,
                                      _mesh(name))
    assert len(got) == n
    assert _stacked(got).tobytes() == want[f"{key}|psum"].tobytes()
    for g in got[1:]:
        assert torch.equal(g, got[0])
    # the int8 bound: at most n x scale_max / 2 from the exact sum
    scale = max(float(compression.compress_int8(b)[1])
                for b in _blocks(x[f"{key}|x"], n))
    exact = x[f"{key}|x"].reshape((n, -1) + x[f"{key}|x"].shape[1:]).sum(0)
    assert np.all(np.abs(got[0].numpy() - exact) <= n * scale / 2 * (
        1 + 1e-6))


@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("name", CASES)
def test_psum_with_error_feedback_matches_jax_bitwise(jax_ref, name, leaf):
    x, want = jax_ref
    n, axes = _n(name), CASES[name]
    key = f"{name}|{leaf}"
    mean, res = compression.psum_with_error_feedback(
        _blocks(x[f"{key}|x"], n), _blocks(x[f"{key}|r"], n), axes,
        _mesh(name))
    assert _stacked(mean).tobytes() == want[f"{key}|mean"].tobytes()
    assert _stacked(res).tobytes() == want[f"{key}|res"].tobytes()


def test_halves_round_to_even():
    q, s = compression.compress_int8(torch.tensor(
        [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]))
    assert float(s) == 1.0
    assert q.tolist() == [127, 0, 2, 2, 0, -2]


def test_collectives_refuse_a_wrong_block_count_or_axis():
    mesh = _mesh("2x4")
    with pytest.raises(ValueError, match="blocks"):
        compression.compressed_psum([torch.zeros(2)] * 3, "data", mesh)
    with pytest.raises(ValueError, match="no axis"):
        compression.compressed_psum([torch.zeros(2)] * 2, "pod", mesh)
