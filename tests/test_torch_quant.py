"""The port's quantized KNN database (int8 and bf16 packs, the quantized
sweep with its exact f32 survivor re-score and margin guard) held
against the JAX package on the CPU: repro.core.predictors.pack_knn_db,
knn_quant_scan and knn_predict_quant, repro.kernels.ref's quantized
oracles, and the XLA oracle ref.predict_rank_audited_ref under jax.jit
for the whole route, never the Pallas interpret path.

Tolerances:
  * X_q and q_scale bitwise; y2_q within rtol=1e-6 (the port sums
    |x~|^2 coordinate by coordinate, XLA in its own order);
  * neighbour idx and guard exact; d2 within rtol=1e-5 (the bf16 cross
    term and |q|^2 are summed in another order than XLA's);
  * lambda-hat: rtol=1e-5, atol=1e-6;
  * perm and compliant exact; utility and exposure: rtol=atol=1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import predictors as jax_pred
from repro.kernels import ref as jax_ref
from repro_torch.core import predictors as pred
from repro_torch.kernels import ops, ref
from repro_torch.kernels.common import PAD_Y2, QUANT_SLAB
from repro_torch.kernels.knn_topk import (
    knn_lambda_quant_cuda,
    knn_rank_audited_quant_cuda,
)

N_TRAIN, D, K, KNN_K = 600, 12, 4, 5
D2_RTOL = 1e-5
LAM_RTOL, LAM_ATOL = 1e-5, 1e-6
RTOL, ATOL = 1e-5, 1e-5
CPU = "cpu"
MODES = ("int8", "bf16")
FIELDS = ("perm", "utility", "exposure", "compliant")


def _db(seed, n=N_TRAIN, d=D, scale=1.0):
    rng = np.random.default_rng(seed)
    X_db = (rng.normal(size=(n, d)) * scale).astype(np.float32)
    lam_db = np.abs(rng.normal(size=(n, K))).astype(np.float32)
    return X_db, lam_db, rng


def _np(x):
    """A JAX or torch array as numpy, bf16 widened to float32."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _jax_pack(X_db, mode, slab):
    return jax_pred.pack_knn_db(jnp.asarray(X_db), mode=mode, slab=slab)


def _port_pack(jpack, mode):
    """The JAX pack carried across as from_numpy carries it."""
    X_q, q_scale, y2_q = (torch.tensor(_np(x)) for x in jpack)
    if mode == "bf16":
        X_q = X_q.to(torch.bfloat16)
    return X_q, q_scale, y2_q


def _ported(jknn, mode=None):
    """The JAX predictor carried across with from_numpy; a bf16 pack as
    float32 values, as numpy without bfloat16 would hand it over."""
    state = {f: _np(v) for f, v in jax_pred.predictor_state(jknn).items()}
    return pred.from_numpy(state, k=jknn.k, device=CPU, quant=mode)


@pytest.mark.parametrize("slab", [200, 512])     # divides / pads N_TRAIN
@pytest.mark.parametrize("mode", MODES)
def test_pack_matches_jax_and_repack_matches_a_full_pack(mode, slab):
    X_db, _, rng = _db(1)
    want = _jax_pack(X_db, mode, slab)
    got = pred.pack_knn_db(X_db, mode=mode, slab=slab, device=CPU)
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))
    np.testing.assert_allclose(got[2].numpy(), _np(want[2]), rtol=1e-6)
    assert got[0].dtype == {"int8": torch.int8, "bf16": torch.bfloat16}[mode]
    assert (got[2][N_TRAIN:] == PAD_Y2).all()
    rows = [3, 401, N_TRAIN - 1]                 # a write to three rows
    X_new = X_db.copy()
    X_new[rows] = rng.normal(size=(3, D)).astype(np.float32) * 3.0
    part = pred.repack_knn_slabs(X_new, *got, rows, mode=mode, slab=slab)
    full = pred.pack_knn_db(X_new, mode=mode, slab=slab, device=CPU)
    for p, f in zip(part, full):
        assert torch.equal(p, f)
    assert not torch.equal(part[0], got[0])
    if mode == "int8":                           # a fresh scale is served
        assert not torch.equal(part[1], got[1])


@pytest.mark.parametrize("slab", [200, 512])
@pytest.mark.parametrize("mode", MODES)
def test_selection_matches_jax(mode, slab):
    X_db, _, rng = _db(2)
    Xq = rng.normal(size=(16, D)).astype(np.float32)
    jpack = _jax_pack(X_db, mode, slab)
    pack = _port_pack(jpack, mode)
    want_scan = jax_pred.knn_quant_scan(*jpack, jnp.asarray(Xq), k=KNN_K,
                                        mode=mode)
    want_ref = jax_ref.knn_quant_select_ref(jnp.asarray(Xq), *jpack, KNN_K,
                                            mode=mode)
    got_scan = pred.knn_quant_scan(*pack, torch.tensor(Xq), k=KNN_K,
                                   mode=mode, chunk=128, device=CPU)
    got_ref = ref.knn_quant_select_ref(torch.tensor(Xq), *pack, KNN_K,
                                       mode=mode)
    for got, want in ((got_scan, want_scan), (got_ref, want_ref)):
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=D2_RTOL)
    for a, b in zip(got_scan, got_ref):          # scan == whole matrix
        assert torch.equal(a, b)


@pytest.mark.parametrize("slab", [200, 512])
@pytest.mark.parametrize("mode", MODES)
def test_lambda_matches_jax(mode, slab):
    X_db, lam_db, rng = _db(3)
    Xq = rng.normal(size=(16, D)).astype(np.float32)
    Xq[2] = X_db[7]                              # a query on a db row
    jknn = jax_pred.KNNLambdaPredictor.fit(jnp.asarray(X_db),
                                           jnp.asarray(lam_db), k=KNN_K)
    jq = jknn.quantized(mode=mode, slab=slab)
    want_lam, want_guard = jax_ref.knn_quant_lambda_ref(
        jnp.asarray(Xq), jq.X_q, jq.q_scale, jq.y2_q, jq.lam_db, KNN_K,
        mode=mode)
    knn = _ported(jq, mode)
    t = torch.tensor(Xq)
    lam, guard = ref.knn_lambda_quant_ref(t, knn.X_q, knn.q_scale, knn.y2_q,
                                          knn.lam_db, KNN_K, mode=mode)
    np.testing.assert_allclose(lam.numpy(), np.asarray(want_lam),
                               rtol=LAM_RTOL, atol=LAM_ATOL)
    np.testing.assert_array_equal(guard.numpy(), np.asarray(want_guard))
    lam_o, guard_o = ref.knn_quant_lambda_ref(
        t, knn.X_q, knn.q_scale, knn.y2_q, knn.lam_db, KNN_K, mode=mode)
    assert torch.equal(lam_o, lam) and torch.equal(guard_o, guard)
    want_pred = np.asarray(jax_pred.knn_predict_quant(
        jq.X_q, jq.q_scale, jq.y2_q, jq.lam_db, jnp.asarray(Xq), k=KNN_K,
        mode=mode))
    for got in (knn.predict(Xq), ops.knn_lambda(
            Xq, knn.X_db, knn.lam_db, k=KNN_K, quant=mode, X_q=knn.X_q,
            q_scale=knn.q_scale, y2_q=knn.y2_q, device=CPU)):
        np.testing.assert_allclose(got.numpy(), want_pred, rtol=LAM_RTOL,
                                   atol=LAM_ATOL)
    np.testing.assert_allclose(knn.predict(Xq[0]).numpy(), want_pred[0],
                               rtol=LAM_RTOL, atol=LAM_ATOL)


def _rank_problem(rng, n, m1, K_rows, m2):
    u = rng.uniform(1.0, 5.0, (n, m1)).astype(np.float32)
    a = (rng.random((n, K_rows, m1)) < 0.15).astype(np.float32)
    b = (0.1 * np.abs(rng.normal(size=(n, K_rows)))).astype(np.float32)
    gamma = np.abs(rng.normal(size=(n, m2))).astype(np.float32)
    return u, a, b, gamma


def _jax_route(jq, X, u, a, b, gamma, m2):
    out = jax.jit(lambda *t: jax_ref.predict_rank_audited_ref(
        t[0], jq, *t[1:], m2))(*(jnp.asarray(x) for x in (X, u, a, b, gamma)))
    return dict(zip(("vals", "perm", "utility", "exposure", "compliant",
                     "lam"), (np.asarray(x) for x in out)))


@pytest.mark.parametrize("n,m1,K_rows,m2", [(16, 96, 4, 8),
                                            (5, 300, 6, 20)])
@pytest.mark.parametrize("mode", MODES)
def test_route_matches_the_xla_oracle_fused_and_chain(mode, n, m1, K_rows,
                                                      m2):
    """ops.predict_rank_audited on a quantized predictor, fused and as
    the chain, against the JAX XLA oracle; a K_rows beyond the
    predictor's 4 prices the bucket-padded constraints 0."""
    X_db, lam_db, rng = _db(4 + m1)
    jknn = jax_pred.KNNLambdaPredictor.fit(jnp.asarray(X_db),
                                           jnp.asarray(lam_db), k=KNN_K)
    jq = jknn.quantized(mode=mode, slab=200)
    X = rng.normal(size=(n, D)).astype(np.float32)
    u, a, b, gamma = _rank_problem(rng, n, m1, K_rows, m2)
    want = _jax_route(jq, X, u, a, b, gamma, m2)
    knn = _ported(jq, mode)
    fused = ops.predict_rank_audited(X, knn, u, a, b, gamma, m2=m2,
                                     device=CPU)
    chain = ops.predict_rank_audited(X, knn, u, a, b, gamma, m2=m2,
                                     knn_chain=True, device=CPU)
    for got in (fused, chain):
        np.testing.assert_array_equal(got.perm.numpy(), want["perm"])
        np.testing.assert_array_equal(got.compliant.numpy(),
                                      want["compliant"])
        for f in ("utility", "exposure"):
            np.testing.assert_allclose(getattr(got, f).numpy(), want[f],
                                       rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got.lam.numpy(), want["lam"],
                                   rtol=LAM_RTOL, atol=LAM_ATOL)
    assert torch.equal(fused.lam, chain.lam)
    assert not fused.lam[:, K:].any()


@pytest.mark.parametrize("chain", [False, True])
def test_lossless_grid_int8_equals_f32_bitwise(chain):
    """Values on the 0.5 grid with 63.5 planted in every slab make each
    slab's scale exactly 0.5: the int8 pack holds the db bitwise, so the
    int8 RankingOutput, lambda-hat included, equals the f32 one."""
    rng = np.random.default_rng(5)
    X_ll = np.clip(np.round(rng.uniform(-63.0, 63.0, (N_TRAIN, D)) * 2.0)
                   / 2.0, -63.5, 63.5).astype(np.float32)
    X_ll[::200] = 63.5
    lam_db = np.abs(rng.normal(size=(N_TRAIN, K))).astype(np.float32)
    base = pred.KNNLambdaPredictor.fit(X_ll, lam_db, k=KNN_K, device=CPU)
    quant = base.quantized("int8", slab=200, device=CPU)
    assert (quant.q_scale == 0.5).all()
    assert torch.equal(quant.X_q.float() * 0.5, base.X_db)
    n, m1, m2 = 16, 96, 8
    X = np.round(rng.uniform(-10, 10, (n, D)) * 2.0).astype(np.float32) / 2.0
    X[1] = X_ll[33]                              # an exact match
    u, a, b, gamma = _rank_problem(rng, n, m1, K, m2)
    o32 = ops.predict_rank_audited(X, base, u, a, b, gamma, m2=m2,
                                   knn_chain=chain, device=CPU)
    oq = ops.predict_rank_audited(X, quant, u, a, b, gamma, m2=m2,
                                  knn_chain=chain, device=CPU)
    for f in FIELDS + ("lam",):
        assert torch.equal(getattr(o32, f), getattr(oq, f)), f
    assert torch.equal(oq.lam[1], torch.tensor(lam_db[33]))


@pytest.mark.parametrize("mode", MODES)
def test_planted_near_tie_fires_the_guard(mode):
    """Rows 0..7 sit on a shell around the query, closer together than
    the int8 query's rounding error: the int8 guard fires, bf16 (which
    rounds only the db) flags none; both match JAX's guard and idx."""
    rng = np.random.default_rng(11)
    X_db = rng.normal(size=(N_TRAIN, D)).astype(np.float32) * 40.0
    q = rng.normal(size=(D,)).astype(np.float32) * 40.0
    for i in range(8):
        v = rng.normal(size=(D,)).astype(np.float32)
        X_db[i] = q + v / np.linalg.norm(v) * (1.0 + 1e-4 * i)
    Xq = np.repeat(q[None, :], 16, axis=0)
    jpack = _jax_pack(X_db, mode, 200)
    _, want_idx, want_guard = jax_pred.knn_quant_scan(
        *jpack, jnp.asarray(Xq), k=KNN_K, mode=mode)
    _, idx, guard = pred.knn_quant_scan(*_port_pack(jpack, mode),
                                        torch.tensor(Xq), k=KNN_K,
                                        mode=mode, device=CPU)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(guard.numpy(), np.asarray(want_guard))
    assert bool(guard.all()) == (mode == "int8")


@pytest.mark.parametrize("mode", MODES)
def test_all_identical_rows_select_the_lowest_indices(mode):
    """Every distance ties: the selection is [0..k-1], and the guard
    fires everywhere (a zero gap is within any error)."""
    X_db = np.full((N_TRAIN, D), 3.0, np.float32)
    Xq = np.random.default_rng(9).normal(size=(16, D)).astype(np.float32)
    jpack = _jax_pack(X_db, mode, 200)
    want = jax_ref.knn_quant_select_ref(jnp.asarray(Xq), *jpack, KNN_K,
                                        mode=mode)
    got = pred.knn_quant_scan(*_port_pack(jpack, mode), torch.tensor(Xq),
                              k=KNN_K, mode=mode, device=CPU)
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.broadcast_to(np.arange(KNN_K), (16, 5)))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=D2_RTOL)
    assert int(got[2].sum()) == 16


def test_an_exact_quantized_tie_goes_to_the_lowest_index():
    """The smallest input found on which the port and the JAX package
    part (ROADMAP Queue 3): rows 0 and 1 pack to int8 rows whose exact
    distances to q are equal (the same sum of m^2 and the same q . m),
    so the tie rule picks row 0. The port's f32 re-score gives both rows
    the same value and picks row 0; XLA rounds row 1's an ulp lower and
    picks row 1. Both agree within the d2 tolerance."""
    q = np.array([[-15, 0, -15, 60, -15, -15, -15, 0, 15, 45]], np.float32)
    X_db = np.array([[15, 0, 0, 45, 15, -15, -15, 45, 0, 30],
                     [15, 45, 0, 30, -15, 0, -15, 15, 0, 45],
                     [-30, -15, -60, -15, 0, 15, -105, 0, 15, 15]],
                    np.float32)
    pack = pred.pack_knn_db(X_db, mode="int8", slab=100, device=CPU)
    m = pack[0][:2].to(torch.int64)
    assert torch.equal((m * m).sum(1), torch.tensor([8424, 8424]))
    assert torch.equal((torch.tensor(q, dtype=torch.float64).to(torch.int64)
                        * m).sum(1), torch.tensor([4860, 4860]))
    d2, idx, _ = pred.knn_quant_scan(*pack, torch.tensor(q), k=2,
                                     mode="int8", device=CPU)
    assert idx.tolist() == [[0, 1]] and d2[0, 0] == d2[0, 1]
    want_d2, want_idx, _ = jax_pred.knn_quant_scan(
        *_jax_pack(X_db, "int8", 100), jnp.asarray(q), k=2, mode="int8")
    assert sorted(np.asarray(want_idx)[0].tolist()) == [0, 1]
    np.testing.assert_allclose(d2.numpy(), np.asarray(want_d2), rtol=D2_RTOL)


@pytest.mark.parametrize("mode", MODES)
def test_state_round_trips_and_the_f32_state_stays_two_keys(mode):
    X_db, lam_db, rng = _db(6)
    jknn = jax_pred.KNNLambdaPredictor.fit(jnp.asarray(X_db),
                                           jnp.asarray(lam_db), k=KNN_K)
    jq = jknn.quantized(mode=mode)
    knn = _ported(jq, mode)
    assert knn.quant == mode and knn.device == torch.device(CPU)
    assert pred.state_fields(knn) == ("X_db", "lam_db", "X_q", "q_scale",
                                      "y2_q")
    assert set(pred.state_fields(knn)) == set(jax_pred.state_fields(jq))
    assert pred.state_fields(_ported(jknn)) == ("X_db", "lam_db")
    for f in ("X_q", "q_scale", "y2_q"):
        np.testing.assert_array_equal(_np(getattr(knn, f)),
                                      _np(getattr(jq, f)))
    back = pred.with_state(knn, pred.predictor_state(knn))
    X = rng.normal(size=(8, D)).astype(np.float32)
    assert torch.equal(back.predict(X), knn.predict(X))
    # the port's own pack at the storage slab is the one carried across
    own = pred.KNNLambdaPredictor.fit(X_db, lam_db, k=KNN_K,
                                      device=CPU).quantized(mode, device=CPU)
    assert own.X_q.shape[0] == -(-N_TRAIN // QUANT_SLAB) * QUANT_SLAB
    for f in ("X_q", "q_scale", "y2_q"):
        assert torch.equal(getattr(own, f), getattr(knn, f)) or f == "y2_q"
    np.testing.assert_allclose(own.predict(X).numpy(),
                               knn.predict(X).numpy(), rtol=LAM_RTOL,
                               atol=LAM_ATOL)


def test_from_numpy_refuses_a_pack_it_cannot_carry():
    X_db, lam_db, _ = _db(7)
    jq = jax_pred.KNNLambdaPredictor.fit(
        jnp.asarray(X_db), jnp.asarray(lam_db), k=KNN_K).quantized("bf16")
    state = {f: _np(v) for f, v in jax_pred.predictor_state(jq).items()}
    with pytest.raises(ValueError, match="quant='bf16'"):
        pred.from_numpy(state, k=KNN_K, device=CPU)
    state["X_q"] = state["X_q"] + np.float32(1e-3)   # not bf16 values
    with pytest.raises(ValueError, match="bfloat16 cannot represent"):
        pred.from_numpy(state, k=KNN_K, device=CPU, quant="bf16")
    int8 = {f: _np(v) for f, v in jax_pred.predictor_state(
        jq.__class__.fit(jq.X_db, jq.lam_db, k=KNN_K).quantized(
            "int8")).items()}
    with pytest.raises(ValueError, match="int8 pack"):
        pred.from_numpy(int8, k=KNN_K, device=CPU, quant="bf16")
    int8["y2_q"] = int8["y2_q"][:-1]              # not one pack
    with pytest.raises(ValueError, match="not one pack"):
        pred.from_numpy(int8, k=KNN_K, device=CPU)


@pytest.mark.parametrize("mode", MODES)
def test_wrappers_cpu_path_is_the_plain_version(mode):
    X_db, lam_db, rng = _db(8)
    knn = pred.KNNLambdaPredictor.fit(X_db, lam_db, k=KNN_K,
                                      device=CPU).quantized(mode, slab=128,
                                                            device=CPU)
    pack = (knn.X_q, knn.q_scale, knn.y2_q)
    X = torch.tensor(rng.normal(size=(6, D)), dtype=torch.float32)
    u, a, b, gamma = (torch.tensor(x) for x in _rank_problem(rng, 6, 64, 5,
                                                             8))
    got = knn_rank_audited_quant_cuda(X, *pack, knn.lam_db, u, a, b, gamma,
                                      k=KNN_K, mode=mode, m2=8, device=CPU)
    want = ref.knn_rank_audited_quant_ref(X, *pack, knn.lam_db, u, a, b,
                                          gamma, k=KNN_K, mode=mode, m2=8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    lam, guard = knn_lambda_quant_cuda(X, *pack, knn.lam_db, k=KNN_K,
                                       mode=mode, device=CPU)
    assert torch.equal(lam, got[5][:, :K]) and torch.equal(guard, got[6])
    # a caller without a pack: ops packs X_db at the storage slab
    out, g2 = ops.knn_rank_audited(X, knn.X_db, knn.lam_db, u, a, b, gamma,
                                   k=KNN_K, m2=8, quant=mode,
                                   return_guard=True, device=CPU)
    own = knn.X_db, knn.lam_db, *pred.pack_knn_db(knn.X_db, mode=mode,
                                                  device=CPU)
    want = ref.knn_rank_audited_quant_ref(X, *own[2:], own[1], u, a, b,
                                          gamma, k=KNN_K, mode=mode, m2=8)
    assert torch.equal(out.perm, want[1]) and torch.equal(g2, want[6])
    with pytest.raises(ValueError, match="k_extra >= 1"):
        knn_lambda_quant_cuda(X, *pack, knn.lam_db, k=KNN_K, k_extra=0,
                              mode=mode, device=CPU)
    with pytest.raises(ValueError, match="dtype"):
        knn_lambda_quant_cuda(X, *pack, knn.lam_db, k=KNN_K,
                              mode={"int8": "bf16", "bf16": "int8"}[mode],
                              device=CPU)
