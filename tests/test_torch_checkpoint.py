"""The port's checkpoint store (repro_torch.checkpoint.CheckpointStore):
round trips with their dtypes (bf16 included), keep_last, async saves,
atomic writes, per-epoch predictor checkpoints with refuse-and-fall-back,
and the on-disk interchange with repro.checkpoint: a predictor epoch
written by either package loads in the other bitwise (KNN over its int8
and bf16 packs, the MLP's nested params, linear and mean). A restored
engine (swap_predictor(tag, state, epoch=e)) serves epoch e bitwise
what the engine that published it served.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FrozenClock
from repro.checkpoint import CheckpointStore as JaxStore
from repro.core import predictors as jpred
from repro.data.synthetic import DriftSpec
from repro.serving import make_drift_stream
from repro_torch.checkpoint import CheckpointStore
from repro_torch.core.predictors import from_numpy, predictor_state
from repro_torch.serving import RankRequest, RefreshLane, ServingEngine

CPU = "cpu"
TAG = "arch"
D, K, N_DB = 6, 3, 64


@pytest.fixture
def store(tmp_path):
    return CheckpointStore(str(tmp_path / "ckpt"), keep_last=2)


def _tree():
    return {
        "w": torch.arange(12.0).reshape(3, 4),
        "nested": {"b16": torch.full((2, 2), 1.5, dtype=torch.bfloat16),
                   "i": torch.tensor([1, 2, 3], dtype=torch.int32),
                   "q": torch.tensor([-127, 0, 5], dtype=torch.int8)},
        "lst": [torch.zeros(2), torch.full((3,), 7.0)],
    }


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes (a bf16 tensor or ml_dtypes array alike)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


def _dtype(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def _assert_bitwise(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert list(got) == list(want)
    for key in got:
        assert _dtype(got[key]) == _dtype(want[key]), key
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        np.testing.assert_array_equal(_bits(got[key]), _bits(want[key]))


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_roundtrip_preserves_values_and_dtypes(store, mode):
    tree = _tree()
    if mode == "sync":
        store.save(5, tree, extra={"next_step": 5})
    else:
        store.save_async(5, tree, extra={"next_step": 5})
        store.wait()
    like = {"w": torch.empty(3, 4), "nested": {
        "b16": torch.empty(2, 2, dtype=torch.bfloat16),
        "i": torch.empty(3, dtype=torch.int32),
        "q": torch.empty(3, dtype=torch.int8)},
        "lst": [torch.empty(2), torch.empty(3)]}
    out, extra = store.restore(like, device=CPU)
    assert extra == {"next_step": 5}
    assert isinstance(out["lst"], list)
    _assert_bitwise(out, tree)
    with open(os.path.join(store._step_dir(5), "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    assert leaves["nested/b16"] == {"shape": [2, 2], "dtype": "bfloat16"}
    assert sorted(leaves) == ["lst/0", "lst/1", "nested/b16", "nested/i",
                              "nested/q", "w"]


def test_gc_keeps_last_n_and_leaves_no_partial_dirs(store):
    for s in (1, 2, 3, 4):
        store.save_async(s, {"x": torch.full((1,), float(s))})
    store.wait()
    assert store.steps() == [3, 4] and store.latest_step() == 4
    assert not [n for n in os.listdir(store.directory) if ".tmp" in n]
    out, _ = store.restore({"x": torch.empty(1)}, device=CPU)
    assert out["x"].item() == 4.0
    with pytest.raises(ValueError, match="shape"):
        store.restore({"x": torch.empty(2)}, device=CPU)
    with pytest.raises(KeyError, match="missing leaves"):
        store.restore({"y": torch.empty(1)}, device=CPU)


def test_corrupt_newest_epoch_falls_back_to_the_previous(store):
    state1 = {"lam": torch.ones((3, K))}
    store.save_predictor_epoch(TAG, 1, state1)
    path2 = store.save_predictor_epoch(TAG, 2, {"lam": torch.full((3, K),
                                                                  2.0)})
    with open(os.path.join(path2, "arrays.npz"), "wb") as f:
        f.write(b"not an npz")                  # a torn write
    loaded, epoch = store.load_predictor_epoch(TAG, device=CPU)
    assert epoch == 1
    assert torch.equal(loaded["lam"], state1["lam"])
    with pytest.raises(FileNotFoundError, match="epoch 2"):
        store.load_predictor_epoch(TAG, epoch=2, device=CPU)


def test_nonfinite_epoch_is_refused(store):
    store.save_predictor_epoch(TAG, 1, {"w": torch.ones(4)})
    store.save_predictor_epoch(TAG, 2, {"w": torch.full(
        (4,), float("nan"), dtype=torch.bfloat16)})
    loaded, epoch = store.load_predictor_epoch(TAG, device=CPU)
    assert epoch == 1 and torch.equal(loaded["w"], torch.ones(4))


def test_no_loadable_epoch_raises(store):
    with pytest.raises(FileNotFoundError, match="no predictor checkpoints"):
        store.load_predictor_epoch("nope", device=CPU)
    path = store.save_predictor_epoch(TAG, 1, {"w": torch.ones(2)})
    os.remove(os.path.join(path, "manifest.json"))
    with pytest.raises(FileNotFoundError, match="no loadable"):
        store.load_predictor_epoch(TAG, device=CPU)


def test_epoch_checkpoints_respect_keep_last(store):
    for e in (1, 2, 3, 4):
        store.save_predictor_epoch(TAG, e, {"w": torch.full((2,), float(e))})
    assert store.predictor_epochs(TAG) == [3, 4]
    _, epoch = store.load_predictor_epoch(TAG, device=CPU)
    assert epoch == 4


# ---------------------------------------------------------------------------
# Interchange with the JAX package's store
# ---------------------------------------------------------------------------


def _jax_state(family, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N_DB, D)).astype(np.float32)
    lam = np.abs(rng.normal(size=(N_DB, K))).astype(np.float32)
    if family.startswith("knn"):
        p = jpred.KNNLambdaPredictor.fit(X, lam, k=5)
        if family != "knn":
            p = p.quantized(mode=family[4:], slab=16)
    elif family == "linear":
        p = jpred.LinearLambdaPredictor.fit(jnp.asarray(X), jnp.asarray(lam))
    elif family == "mean":
        p = jpred.MeanLambdaPredictor.fit(X, lam)
    else:
        p = jpred.MLPLambdaPredictor.fit(X, lam, d_hidden=8, num_steps=5)
    return jpred.predictor_state(p)


def _port_state(jstate):
    """The same arrays as the port's tensors (a bf16 pack as bf16)."""
    def conv(x):
        x = np.asarray(x)
        if str(x.dtype) == "bfloat16":
            return torch.from_numpy(x.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(x.copy())
    return {k: ({kk: conv(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else conv(v))
            for k, v in jstate.items()}


@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
@pytest.mark.parametrize("family", ["knn", "knn_int8", "knn_bf16", "mlp",
                                    "linear", "mean"])
def test_predictor_epochs_interchange_bitwise(tmp_path, family, direction):
    jstate = _jax_state(family)
    pstate = _port_state(jstate)
    _assert_bitwise(pstate, jstate)             # the same arrays
    directory = str(tmp_path / "ckpt")
    if direction == "jax->port":
        JaxStore(directory).save_predictor_epoch(TAG, 3, jstate)
        for like in (None, pstate):
            got, epoch = CheckpointStore(directory).load_predictor_epoch(
                TAG, like=like, device=CPU)
            assert epoch == 3
            _assert_bitwise(got, pstate)
    else:
        CheckpointStore(directory).save_predictor_epoch(TAG, 3, pstate)
        for like in (None, jstate):
            got, epoch = JaxStore(directory).load_predictor_epoch(
                TAG, like=like)
            assert epoch == 3
            _assert_bitwise(got, jstate)


# ---------------------------------------------------------------------------
# A restored engine serves its epoch bitwise
# ---------------------------------------------------------------------------


def _port_predictor(family):
    jstate = _jax_state(family, seed=1)
    state = _port_state(jstate)
    if family == "knn_bf16":
        return from_numpy({k: (np.asarray(v, np.float32) if k == "X_q"
                               else np.asarray(v)) for k, v in
                           jstate.items()}, k=5, quant="bf16", device=CPU)
    if family == "mlp":
        return from_numpy({"params": {k: v.numpy() for k, v in
                                      state["params"].items()}}, device=CPU)
    return from_numpy({k: v.numpy() for k, v in state.items()},
                      k=5 if family.startswith("knn") else None, device=CPU)


def _engine(pred):
    eng = ServingEngine(max_batch=8, max_wait_ms=1e9, pipeline_depth=1,
                        clock=FrozenClock(), device=CPU)
    eng.register_predictor(TAG, pred, d_cov=D)
    return eng


@pytest.mark.parametrize("family", ["knn", "knn_int8", "knn_bf16", "linear",
                                    "mean", "mlp"])
def test_restored_engine_serves_the_epoch_bitwise(family, store):
    reqs = [RankRequest(**{f: getattr(r, f) for f in (
        "rid", "u", "a", "b", "m2", "lam", "X", "tag", "gamma")})
        for r in make_drift_stream(
            DriftSpec(kind="none"), tag=TAG, n_requests=32, m1=128, m2=16,
            K=K, d_cov=D, b_frac=0.25, seed=2)]
    hot = _engine(_port_predictor(family))
    lane = RefreshLane(hot, eta=0.5, min_samples=4, mlp_steps=5,
                       checkpoint=store)
    hot.warmup(reqs)
    hot.serve_stream(reqs[:16], warmup=False)
    rep = lane.refresh(TAG)[TAG]
    assert rep["swapped"] and rep["checkpointed"] and rep["epoch"] == 1
    assert set(rep["ms"]) == {"drain_update", "swap", "checkpoint"}
    assert store.predictor_epochs(TAG) == [1]
    hot_out = hot.serve_stream(reqs[16:], warmup=False)
    assert all(r.epoch == 1 for r in hot_out)
    hot.close()

    cold = _engine(_port_predictor(family))     # the same generation 0
    state, epoch = store.load_predictor_epoch(
        TAG, like=predictor_state(cold.predictor_template(TAG)), device=CPU)
    assert epoch == 1
    assert cold.swap_predictor(TAG, state, epoch=epoch) == 1
    cold.warmup(reqs)
    cold_out = {r.rid: r for r in cold.serve_stream(reqs[16:],
                                                    warmup=False)}
    assert len(cold_out) == len(hot_out)
    for r in hot_out:
        c = cold_out[r.rid]
        np.testing.assert_array_equal(c.perm, r.perm)
        np.testing.assert_array_equal(c.exposure, r.exposure)
        assert (c.utility, c.compliant, c.epoch) == (r.utility, r.compliant,
                                                     r.epoch)
    cold.close()
