"""The port's recsys backbones (models.recsys), their batches
(data.batches), clip (optim.clip) and rms_norm held against the JAX
package's, at each arch's SMOKE config, on JAX's init(key(0)) carried
across with load_numpy and on JAX's own batches.

Tolerances: the loss rtol=1e-5; every gradient leaf rtol=1e-4,
atol=1e-6; one train_step (clip, then Adam): the parameters rtol=1e-5,
atol=1e-7 against JAX's clip and Adam applied to the port's own
gradients, and grad_norm rtol=1e-6. Against JAX's whole step (JAX's
gradients) the parameters hold to rtol=1e-5, atol=lr*1e-3: Adam's first
step moves each weight by lr*g/(|g|+1e-8), which turns a gradient's
rounding into up to ~1e-3 of a step where |g| nears 1e-8 (SASRec's
blocks/1/w1 has one at 1.25e-8); user_covariates and retrieval_scores
rtol=1e-5, atol=1e-6 (DeepFM's context sum runs through
ops.embedding_bag, which sums in slot order); rms_norm rtol=1e-6,
atol=1e-6 (XLA's CPU rsqrt need not round as torch's does). The
batches match JAX's in layout, dtype and range (torch cannot reproduce
jax.random's values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_archs as jax_all_archs
from repro.configs import get_arch as jax_get_arch
from repro.data.batches import make_deepfm_batch as jax_deepfm_batch
from repro.data.batches import make_seqrec_batch as jax_seqrec_batch
from repro.models.layers import rms_norm as jax_rms_norm
from repro.models.recsys import RECSYS_REGISTRY as JAX_REGISTRY
from repro.models.recsys import embedding_bag as jax_embedding_bag
from repro.optim import adam_init as jax_adam_init
from repro.optim import adam_update as jax_adam_update
from repro.optim.clip import clip_by_global_norm as jax_clip
from repro.optim.clip import global_norm as jax_global_norm
from repro_torch.checkpoint.store import flatten_with_paths
from repro_torch.configs import all_archs, get_arch
from repro_torch.configs.recsys_family import _covariate_dim, build_recsys
from repro_torch.data.batches import make_deepfm_batch, make_seqrec_batch
from repro_torch.kernels import ops
from repro_torch.models.layers import rms_norm
from repro_torch.models.recsys import RECSYS_REGISTRY, embedding_bag
from repro_torch.optim import clip_by_global_norm, global_norm

CPU = "cpu"
ARCHS = ("deepfm", "sasrec", "bert4rec", "mind")
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
STEP_TOL = dict(rtol=1e-5, atol=1e-7)
LR = 3e-3
E2E_STEP_TOL = dict(rtol=1e-5, atol=LR * 1e-3)
GNORM_RTOL = 1e-6
SCORE_TOL = dict(rtol=1e-5, atol=1e-6)


def _jax_batch(cfg, seed: int, B: int = 8, n_neg: int = 15):
    k = jax.random.key(seed)
    if cfg.kind == "deepfm":
        return make_jax(jax_deepfm_batch(k, batch=B, n_sparse=cfg.n_sparse,
                                         field_vocab=cfg.field_vocab))
    return make_jax(jax_seqrec_batch(k, batch=B, seq_len=cfg.seq_len,
                                     n_items=cfg.n_items, n_neg=n_neg,
                                     kind=cfg.kind))


def make_jax(batch):
    return {k: np.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def carried(request):
    """(arch, JAX model, its params, the port's model on them, a JAX
    batch as numpy)."""
    arch = request.param
    jcfg = jax_get_arch(arch).make_config(full=False)
    jmodel = JAX_REGISTRY[jcfg.kind](jcfg)
    params = jmodel.init(jax.random.key(0))
    cfg = get_arch(arch).make_config(full=False)
    model = RECSYS_REGISTRY[cfg.kind](cfg, device=CPU)
    model.load_numpy(jax.tree.map(np.asarray, params))
    return arch, jmodel, params, model, _jax_batch(cfg, seed=3)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **tol)


def test_configs_match_jax():
    """The port registers every arch JAX does (meshgraphnet, the GNN
    half of the zoo, included), and meshgraphnet's family and cells are
    JAX's; the recsys archs' configs are JAX's field for field."""
    assert all_archs() == jax_all_archs()
    gnn, jgnn = get_arch("meshgraphnet"), jax_get_arch("meshgraphnet")
    assert gnn.family == jgnn.family == "gnn"
    assert [(c.name, c.kind, dict(c.params)) for c in gnn.cells] == \
        [(c.name, c.kind, dict(c.params)) for c in jgnn.cells]
    for arch in ARCHS:
        spec, jspec = get_arch(arch), jax_get_arch(arch)
        assert spec.family == jspec.family == "recsys"
        assert spec.build is build_recsys
        assert [(c.name, c.kind, dict(c.params)) for c in spec.cells] == \
            [(c.name, c.kind, dict(c.params)) for c in jspec.cells]
        assert sorted(spec.variants) == sorted(jspec.variants)
        for full in (True, False):
            cfg, jcfg = spec.make_config(full), jspec.make_config(full)
            for f in ("name", "kind", "n_sparse", "field_vocab", "embed_dim",
                      "mlp_dims", "n_items", "seq_len", "n_blocks",
                      "n_heads", "n_interests", "capsule_iters", "n_neg",
                      "replicate_tables"):
                assert getattr(cfg, f) == getattr(jcfg, f), (arch, full, f)
            assert cfg.n_params == jcfg.n_params
            assert _covariate_dim(cfg) == (
                cfg.n_interests * cfg.embed_dim if arch == "mind"
                else cfg.embed_dim)
        for name, make in spec.variants.items():
            assert make() == dataclass_like(jspec.variants[name](), make())


def dataclass_like(jcfg, cfg):
    """The port's config with jcfg's fields (dtypes are the port's)."""
    import dataclasses
    return dataclasses.replace(cfg, **{
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cfg)
        if f.name not in ("dtype", "param_dtype")})


def test_params_carry_across_and_back(carried):
    arch, _, params, model, _ = carried
    flat_j = flatten_with_paths(jax.tree.map(np.asarray, params))
    flat_t = flatten_with_paths(model.state_numpy())
    assert list(flat_t) == list(flat_j)          # JAX's leaf order
    for k in flat_j:
        np.testing.assert_array_equal(flat_t[k], flat_j[k])
    names = {n for n, _ in model.named_parameters()}
    assert names == {k.replace("/", ".") for k in flat_j}
    if arch == "deepfm":
        assert {"table", "mlp.w0", "mlp.b0", "mlp.w_out"} <= names
    else:
        assert {"items", "blocks.0.wqkv", "blocks.1.ln2", "final_ln"} <= names
    if arch == "mind":
        assert "bilinear" in names


def test_loss_and_gradients_match_jax(carried):
    _, jmodel, params, model, batch = carried
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jb), has_aux=True))(params)
    loss, metrics, grads = model.grads(batch)
    assert metrics["loss"] is loss
    _close(loss, j_loss, rtol=LOSS_RTOL)
    jg = flatten_with_paths(jax.tree.map(np.asarray, j_grads))
    tg = flatten_with_paths(grads)
    assert list(tg) == list(jg)
    for k in jg:
        _close(tg[k], jg[k], **GRAD_TOL)


def test_one_train_step_matches_jax(carried):
    arch, jmodel, params, _, batch = carried
    cfg = get_arch(arch).make_config(full=False)
    model = RECSYS_REGISTRY[cfg.kind](cfg, device=CPU)
    model.load_numpy(jax.tree.map(np.asarray, params))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j_new, _, j_metrics = jax.jit(lambda p, o, b: jmodel.train_step(
        p, o, b, lr=LR))(params, jax_adam_init(params), jb)
    _, _, own = model.grads(batch)
    own = jax.tree.map(lambda g: jnp.asarray(g.numpy()), own)
    clipped, own_norm = jax_clip(own, 1.0)
    j_own, _ = jax_adam_update(clipped, jax_adam_init(params), params, lr=LR)
    opt, metrics = model.train_step(model.init_opt(), batch, lr=LR)
    assert int(opt.step) == 1
    _close(metrics["loss"], j_metrics["loss"], rtol=LOSS_RTOL)
    _close(metrics["grad_norm"], j_metrics["grad_norm"], rtol=GNORM_RTOL)
    _close(metrics["grad_norm"], own_norm, rtol=GNORM_RTOL)
    got = flatten_with_paths(model.state_numpy())
    want = flatten_with_paths(jax.tree.map(np.asarray, j_new))
    want_own = flatten_with_paths(jax.tree.map(np.asarray, j_own))
    for k in want:
        np.testing.assert_allclose(got[k], want_own[k], **STEP_TOL)
        np.testing.assert_allclose(got[k], want[k], **E2E_STEP_TOL)


def test_covariates_and_retrieval_scores_match_jax(carried):
    arch, jmodel, params, model, _ = carried
    cfg = model.cfg
    serve_in = _jax_batch(cfg, seed=11, B=6, n_neg=1)
    req = serve_in["ids" if arch == "deepfm" else "seq"]
    user_in = req[:, 1:] if arch == "deepfm" else req
    cand = np.arange(min(64, cfg.n_items))
    _close(model.user_covariates(req),
           jmodel.user_covariates(params, jnp.asarray(req)), **SCORE_TOL)
    _close(model.retrieval_scores(user_in, cand),
           jmodel.retrieval_scores(params, jnp.asarray(user_in),
                                   jnp.asarray(cand)), **SCORE_TOL)
    X = model.user_covariates(req)
    assert X.shape == (6, _covariate_dim(cfg))
    if arch == "deepfm":
        _close(model.serve(req), jmodel.serve(params, jnp.asarray(req)),
               **SCORE_TOL)
    else:
        target = serve_in["seq"][:, -1]
        _close(model.serve(req, target),
               jmodel.serve(params, jnp.asarray(req), jnp.asarray(target)),
               **SCORE_TOL)


def test_deepfm_context_sum_through_the_bag(monkeypatch):
    """DeepFM's retrieval context is one sum-mode bag a user through
    ops.embedding_bag (the kernel's plain version on the CPU), within
    the stated tolerance of JAX's take + sum and of JAX's own
    embedding_bag."""
    cfg = get_arch("deepfm").make_config(full=False)
    jcfg = jax_get_arch("deepfm").make_config(full=False)
    jmodel = JAX_REGISTRY["deepfm"](jcfg)
    params = jmodel.init(jax.random.key(0))
    model = RECSYS_REGISTRY["deepfm"](cfg, device=CPU)
    model.load_numpy(jax.tree.map(np.asarray, params))
    calls = []
    real = ops.embedding_bag

    def counting(*a, **kw):
        calls.append(a[1].shape)
        return real(*a, **kw)

    monkeypatch.setattr(ops, "embedding_bag", counting)
    ids = _jax_batch(cfg, seed=5, B=7)["ids"][:, 1:]
    ctx = model.context_sum(ids)
    assert calls == [(7, cfg.n_sparse - 1)]
    table = np.asarray(params["table"])
    want = table[ids.reshape(-1)].reshape(7, -1, cfg.embed_dim).sum(axis=1)
    _close(ctx, want, **SCORE_TOL)
    _close(ctx, jax_embedding_bag(params["table"], jnp.asarray(ids)),
           **SCORE_TOL)
    idx = np.where(ids % 3 == 0, -1, ids)            # padding slots
    _close(embedding_bag(model.table, idx, device=CPU),
           jax_embedding_bag(params["table"], jnp.asarray(idx)),
           **SCORE_TOL)


@pytest.mark.parametrize("kind", ARCHS)
def test_batches_match_jax_layout(kind):
    cfg = get_arch(kind).make_config(full=False)
    gen = torch.Generator()
    gen.manual_seed(1)
    if kind == "deepfm":
        got = make_deepfm_batch(gen, batch=9, n_sparse=cfg.n_sparse,
                                field_vocab=cfg.field_vocab, device=CPU)
    else:
        got = make_seqrec_batch(gen, batch=9, seq_len=cfg.seq_len,
                                n_items=cfg.n_items, n_neg=15, kind=kind,
                                device=CPU)
    want = _jax_batch(cfg, seed=1, B=9, n_neg=15)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert got[k].dtype == torch.int32 and v.dtype == np.int32
    if kind == "deepfm":
        field = got["ids"].numpy() // cfg.field_vocab
        assert (field == np.arange(cfg.n_sparse)).all()
        assert set(np.unique(got["labels"].numpy())) <= {0, 1}
        return
    n = cfg.n_items
    seq = got["seq"].numpy()
    assert seq.min() >= 0 and seq.max() < n and got["neg"].max() < n
    if kind == "sasrec":
        assert (got["pos"].numpy() == (seq + 1) % n).all()
    elif kind == "mind":
        assert (got["pos"].numpy() == (seq[:, -1] + 1) % n).all()
    else:
        pos = got["mask_pos"].numpy()
        assert pos.shape == (9, 8) and pos.max() < cfg.seq_len
        assert (np.take_along_axis(seq, pos, 1) == 0).all()  # mask token
        # the walk's steps lie in [-3, 3] away from the masked slots
    if kind != "bert4rec":
        steps = (np.diff(seq, axis=1) + 3) % n
        assert steps.max() <= 6


def test_deepfm_labels_follow_parity():
    gen = torch.Generator()
    gen.manual_seed(0)
    b = make_deepfm_batch(gen, batch=4000, n_sparse=6, field_vocab=500,
                          device=CPU)
    local = b["ids"].numpy() % 500
    p = 0.2 + 0.6 * (local % 2).mean(axis=1)
    assert abs(b["labels"].numpy().mean() - p.mean()) < 0.03


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32) * 3
    w = rng.normal(size=16).astype(np.float32) * 0.1
    got = rms_norm(torch.tensor(x), torch.tensor(w))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_rms_norm(x, w)),
                               rtol=1e-6, atol=1e-6)


def test_clip_sums_in_jax_leaf_order():
    """global_norm over a tree whose dict insertion order is not its
    sorted order, against JAX's; clip_by_global_norm scales every leaf
    and keeps the structure."""
    rng = np.random.default_rng(3)
    tree = {"mlp": {"w0": rng.normal(size=(40, 30)),
                    "b0": rng.normal(size=30) * 1e3},
            "blocks": [{"w1": rng.normal(size=(8, 8)),
                        "ln1": rng.normal(size=8) * 1e-3}],
            "bias": np.float32(2.0)}
    tree = jax.tree.map(lambda v: np.asarray(v, np.float32), tree)
    ttree = jax.tree.map(torch.tensor, tree)
    gn = global_norm(ttree)
    np.testing.assert_allclose(float(gn), float(jax_global_norm(tree)),
                               rtol=GNORM_RTOL)
    clipped, gn2 = clip_by_global_norm(ttree, 1.0)
    jclipped, jgn = jax_clip(tree, 1.0)
    assert float(gn2) == float(gn)
    assert list(clipped) == list(ttree)               # structure kept
    got = flatten_with_paths(clipped)
    want = flatten_with_paths(jax.tree.map(np.asarray, jclipped))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6,
                                   atol=1e-9)
    small, _ = clip_by_global_norm(ttree, 1e9)       # below the bound
    for k, v in flatten_with_paths(small).items():
        assert torch.equal(v, flatten_with_paths(ttree)[k])


def test_training_lowers_the_loss():
    """Thirty steps of the port's own draws lower SASRec's loss."""
    cfg = get_arch("sasrec").make_config(full=False)
    gen = torch.Generator()
    gen.manual_seed(0)
    model = RECSYS_REGISTRY["sasrec"](cfg, gen=gen, device=CPU)
    opt = model.init_opt()
    losses = []
    for step in range(30):
        g = torch.Generator()
        g.manual_seed(step % 4)
        batch = make_seqrec_batch(g, batch=16, seq_len=cfg.seq_len,
                                  n_items=cfg.n_items, n_neg=15,
                                  device=CPU)
        opt, m = model.train_step(opt, batch, lr=3e-3)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < np.mean(losses[:4])


def test_a_train_step_leaves_no_tensor_in_a_reference_cycle():
    """A train step's trees (gradients, clipped gradients, Adam's
    inputs) are freed when the step returns, not when the collector
    next runs: the tree helpers make no reference cycle. With a cycle,
    DeepFM's 1.6 GB of tables leaked two copies a step on the card."""
    import gc

    cfg = get_arch("deepfm").make_config(full=False)
    model = RECSYS_REGISTRY["deepfm"](cfg, device=CPU)
    opt = model.init_opt()
    batch = _jax_batch(cfg, seed=3)
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        for _ in range(2):
            opt, _ = model.train_step(opt, batch, lr=LR)
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        cyclic = [o for o in gc.garbage if torch.is_tensor(o)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        if enabled:
            gc.enable()
    assert cyclic == []
