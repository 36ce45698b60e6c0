"""The KNN sweeps' card-side geometry (kernels/knn_topk.py's
sweep_geometry and quant_sweep_geometry, pure functions of the shapes)
and the plain versions at the shapes the card now takes, held against
the JAX package's XLA routes (core.predictors.knn_quant_scan,
knn_predict and the quantized predictor's predict, kernels.ref's
knn_topk_ref), never the Pallas interpret path.

Tolerances:
  * indices and guards match exactly (random data, no planted ties);
  * squared distances: rtol=1e-5 (the distance dot summed in another
    order than XLA's), atol=1e-3 (an exact match's d2 is 0 up to the
    rounding of |q|^2 + |x|^2, about 1000 at d = 512);
  * lambda-hat: rtol=1e-5, atol=1e-6 (the distance dot and the weights
    summed in another order than XLA's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import predictors as jax_pred
from repro.kernels import ref as jax_ref
from repro_torch.core import predictors as pred
from repro_torch.kernels import ref
from repro_torch.kernels.common import (
    KNN_MAX_K,
    KNN_QTILE,
    KNN_QUANT_MAX_KEEP,
    KNN_SMEM_BYTES,
)
from repro_torch.kernels.knn_topk import (
    H100_SMS,
    quant_merge_floats,
    quant_sweep_geometry,
    sweep_geometry,
)

D2_RTOL, D2_ATOL = 1e-5, 1e-3
LAM_RTOL, LAM_ATOL = 1e-5, 1e-6
CPU = "cpu"
LIMIT = "Queue 2 item 7"
N_DB = 1_048_576


def _sweep_smem(d, k, tile, piece):
    """csrc/knn_sweep.cuh's sweep_smem: the 32 queries, their |q|^2 and
    a stage of L pairs each, and two ring slots of `tile` rows at the
    odd stride piece | 1."""
    L = 32 * (1 if k <= 32 else 2 if k <= 64 else 4 if k <= 128 else 8)
    return 4 * (KNN_QTILE * (d + 1 + 2 * L) + 2 * tile * (piece | 1))


@pytest.mark.parametrize("d", [1, 13, 20, 128, 256, 300, 512, 1024, 1407])
def test_f32_geometry_fits_and_holds_k(d):
    for k in (1, 10, 32, 33, 64, 65, 100, 128, 129, 256):
        for B in (1, 32, 33, 1024):
            for n in (k, 5001, N_DB):
                try:
                    g = sweep_geometry(B, n, d, k)
                except ValueError as e:  # only 256-long lists at d = 1407
                    assert LIMIT in str(e) and k > 128 and d == 1407
                    continue
                assert g.smem_bytes == _sweep_smem(d, k, g.tile, g.piece)
                assert g.smem_bytes <= KNN_SMEM_BYTES
                assert g.tile % 32 == 0 and 32 <= g.tile <= 256
                # whole rows, or 32-row tiles of pieces of >= 32 coordinates
                assert g.piece == d or (g.tile == 32 and 32 <= g.piece < d)
                assert g.list_len in (32, 64, 128, 256) and g.list_len >= k
                assert g.list_len == 32 or g.list_len // 2 < k
                assert g.chunk % g.tile == 0
                assert g.n_chunks * g.chunk >= n > (g.n_chunks - 1) * g.chunk
                q_tiles = -(-B // KNN_QTILE)
                blocks = q_tiles * g.n_chunks
                assert blocks <= max(q_tiles, 4 * H100_SMS)
                if n >= H100_SMS * g.tile:
                    assert blocks >= H100_SMS


def test_f32_geometry_keeps_the_bucket_tile():
    """The bucket (B = 32 over 1M rows, d = 20, k = 10): 256-row tiles of
    whole rows, 512 chunks of 2048 (512 blocks on 132 SMs), lists of 32;
    B = 1024: 16 chunks of 65,536, so the merge folds 16 lists a query."""
    g = sweep_geometry(32, N_DB, 20, 10)
    assert (g.tile, g.chunk, g.n_chunks, g.list_len, g.piece) == (
        256, 2048, 512, 32, 20)
    g = sweep_geometry(1024, N_DB, 20, 10)
    assert (g.tile, g.chunk, g.n_chunks, g.list_len) == (256, 65536, 16, 32)


@pytest.mark.parametrize("k,d", [(KNN_MAX_K + 1, 20), (10, 1630),
                                 (0, 20), (256, 1182)])
def test_f32_geometry_raises_just_past_its_limits(k, d):
    with pytest.raises(ValueError, match=LIMIT):
        sweep_geometry(32, 5001, d, k)
    sweep_geometry(32, 5001, d - 1 if d > 20 else d, max(1, k - 1))


@pytest.mark.parametrize("k,d,tile,piece", [
    (65, 20, 256, 20), (100, 20, 256, 20), (256, 20, 256, 20),
    (10, 1407, 32, 143), (10, 1629, 32, 33), (64, 735, 32, 447),
    (256, 1181, 32, 33)])
def test_f32_geometry_serves_the_lifted_limits(k, d, tile, piece):
    """k = 65 to 256 (lists of 128 and 256), every d the old sweep took
    (1407 at k <= 16, 735 at k = 64) and more: a row wider than the ring
    holds is scored in pieces of d, 32 rows a tile."""
    g = sweep_geometry(32, 5001, d, k)
    assert (g.tile, g.piece) == (tile, piece)
    assert g.list_len == (32 if k <= 32 else 64 if k <= 64 else 128
                          if k <= 128 else 256)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("d", [1, 13, 20, 128, 300, 512, 600])
def test_quant_geometry_fits_and_fills_the_card(mode, d):
    for k, k_extra in ((1, 1), (10, 8), (24, 8), (33, 8), (56, 8), (64, 8),
                       (120, 8), (200, 56)):
        kk = k + k_extra
        for B in (1, 32, 33, 1024):
            for n in (kk, 384, 70_000, N_DB):
                g = quant_sweep_geometry(B, n, d, k, k_extra, mode)
                assert g.smem_bytes <= KNN_SMEM_BYTES
                assert 4 * (2 * k + quant_merge_floats(d, k, kk)) \
                    <= KNN_SMEM_BYTES
                assert g.tile % 32 == 0 and 32 <= g.tile <= 256
                assert g.chunk % g.tile == 0
                assert g.list_len in (32, 64, 128, 256)
                assert kk <= g.list_len and (g.list_len == 32
                                             or g.list_len // 2 < kk)
                assert g.n_chunks * g.chunk >= n > (g.n_chunks - 1) * g.chunk
                assert g.n_chunks <= 65535
                q_tiles = -(-B // KNN_QTILE)
                blocks = q_tiles * g.n_chunks
                # no more than 4 blocks an SM, and the card filled
                # unless the pack runs out of tiles first
                assert blocks <= max(q_tiles, 4 * H100_SMS)
                if n >= H100_SMS * g.tile:
                    assert blocks >= H100_SMS


def test_quant_geometry_at_the_bucket_and_a_large_batch():
    """B = 32 over 1M rows: 512 chunks of 2048 (one query tile, 512
    blocks on 132 SMs); B = 1024: 16 chunks of 65,536 (32 query tiles,
    512 blocks): fewer, longer chunks cut the workspace and the merge."""
    for mode in ("int8", "bf16"):
        g = quant_sweep_geometry(32, N_DB, 20, 10, 8, mode)
        assert (g.tile, g.chunk, g.n_chunks, g.list_len) == (256, 2048, 512,
                                                             32)
        g = quant_sweep_geometry(1024, N_DB, 20, 10, 8, mode)
        assert (g.chunk, g.n_chunks) == (65536, 16)


@pytest.mark.parametrize("mode,k,k_extra,d", [
    ("int8", 10, KNN_QUANT_MAX_KEEP - 9, 20), ("bf16", 200, 57, 20),
    ("int8", 10, 8, 2256), ("bf16", 10, 8, 848)])
def test_quant_geometry_raises_just_past_its_limits(mode, k, k_extra, d):
    with pytest.raises(ValueError, match=LIMIT):
        quant_sweep_geometry(32, 5120, d, k, k_extra, mode)
    inside = (k, k_extra - 1, d) if d == 20 else (k, k_extra, d - 4)
    g = quant_sweep_geometry(32, 5120, inside[2], inside[0], inside[1], mode)
    assert g.tile >= 32


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _np(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("k,d,n_db", [(64, 20, 3000), (10, 512, 700)])
def test_quant_plain_versions_match_jax_at_the_new_limits(mode, k, d, n_db):
    """k = 64 keeps 72 survivors; d = 512 is four times the old pack
    limit: the plain versions the card is held to agree with the JAX
    XLA routes, indices and guard exactly. No query sits on a db row: on
    the dequantized db its d2 would be a small difference of two large
    sums, and lambda-hat's weight 1/sqrt(d2) would amplify the two
    sides' summation orders past the tolerance."""
    rng = np.random.default_rng(k + d)
    X_db = rng.normal(size=(n_db, d)).astype(np.float32)
    lam_db = np.abs(rng.normal(size=(n_db, 4))).astype(np.float32)
    Xq = rng.normal(size=(9, d)).astype(np.float32)
    jq = jax_pred.KNNLambdaPredictor.fit(*_j(X_db, lam_db), k=k).quantized(
        mode)
    jpack = (jq.X_q, jq.q_scale, jq.y2_q)
    X_q = torch.tensor(_np(jq.X_q))
    if mode == "bf16":
        X_q = X_q.to(torch.bfloat16)
    pack = (X_q, torch.tensor(_np(jq.q_scale)), torch.tensor(_np(jq.y2_q)))
    want = jax_pred.knn_quant_scan(*jpack, jnp.asarray(Xq), k=k, mode=mode)
    got = pred.knn_quant_scan(*pack, torch.tensor(Xq), k=k, mode=mode,
                              device=CPU)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=D2_RTOL, atol=D2_ATOL)
    lam, guard = ref.knn_lambda_quant_ref(torch.tensor(Xq), *pack,
                                          torch.tensor(lam_db), k, mode=mode)
    np.testing.assert_array_equal(guard.numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(lam.numpy(), np.asarray(jq.predict(
        jnp.asarray(Xq))), rtol=LAM_RTOL, atol=LAM_ATOL)


@pytest.mark.parametrize("k,d,n_db", [(64, 20, 3000), (10, 512, 700),
                                      (64, 512, 700), (256, 20, 3000),
                                      (10, 1407, 700)])
def test_f32_plain_versions_match_jax_at_the_new_limits(k, d, n_db):
    rng = np.random.default_rng(k * d)
    X_db = rng.normal(size=(n_db, d)).astype(np.float32)
    lam_db = np.abs(rng.normal(size=(n_db, 4))).astype(np.float32)
    Xq = rng.normal(size=(9, d)).astype(np.float32)
    Xq[3] = X_db[n_db - 1]
    d2, idx = ref.knn_topk_ref(torch.tensor(Xq), torch.tensor(X_db), k)
    w_d2, w_idx = jax_ref.knn_topk_ref(*_j(Xq, X_db), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(w_idx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(w_d2), rtol=D2_RTOL,
                               atol=D2_ATOL)
    lam = ref.knn_lambda_ref(torch.tensor(Xq), torch.tensor(X_db),
                             torch.tensor(lam_db), k)
    np.testing.assert_allclose(
        lam.numpy(), np.asarray(jax_pred.knn_predict(*_j(X_db, lam_db, Xq),
                                                      k=k)),
        rtol=LAM_RTOL, atol=LAM_ATOL)
    np.testing.assert_array_equal(lam[3].numpy(), lam_db[n_db - 1])
