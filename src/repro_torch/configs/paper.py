"""paper-ranking — the paper's own pipeline as an arch (counterpart of
repro.configs.paper).

Three cells:

  offline_dual     batched dual solve: 8 192 users x (m1=1024, K=5) per
                   step — Algorithm 1's offline stage as one program.
  serve_online     the < 50 ms online stage at fleet batch: KNN shadow
                   prices over a 1M-user database + adjusted-score
                   ranking, 8 192 users/step, m1=1024 -> top-50.
  serve_retrieval  the large-m1 regime: 2^20 candidates per user,
                   batch 256 -> constrained top-50.

The default variant's programs run partitioned over the mesh wherever
PAPER_RULES' specs, relaxed as drop_nondivisible relaxes them, split
something over more than one block (JAX's jit partitions the annotated
programs by GSPMD), one shard body a mesh position with explicit
collectives:
  offline_dual   u and a resharded once by an all-to-all over 'model',
                 from (users over ('pod', 'data')) x (items over
                 'model') to (users over ('pod', 'data', 'model')) x
                 (all items); then solve_dual_batch on each position's
                 users, no collective in its loops
                 (core.dual_solver.solve_dual_partitioned);
  serve cells    the KNN database's rows and lam_db over 'model', the
                 items over 'model', the users over ('pod', 'data'): a
                 knn_topk and a fused_rank shard body a position, each
                 followed by an all-gather of its candidates over
                 'model' and the same merge at every position of the
                 group (core.serving_dist.serve_partitioned).
Their outputs are launch.mesh.Sharded over the users. On a one-device
mesh (or where nothing splits) the programs are global: solve_dual_batch,
and lambda-hat by `ops.knn_lambda` (the dense knn_predict over 8192 x
1,048,576 would build a 34 GB distance matrix), then `ops.rank_audited`.

The `dist-topk` variant (distributed=True) serves the two serve cells
over a mesh by JAX's shard_map bodies: the KNN database split by rows
and the candidate axis by items, k (or m2) candidates a shard merged on
the queries' device (core.serving_dist, the same shard bodies and
merge). Its offline program is the default's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.registry import (
    ArchSpec,
    Cell,
    Program,
    register,
    sds,
)
from repro_torch.core.constraints import dcg_discount
from repro_torch.core.dual_solver import (
    solve_dual_batch,
    solve_dual_partitioned,
)
from repro_torch.core.serving_dist import (
    knn_predict_distributed,
    rank_distributed,
    serve_partitioned,
)
from repro_torch.distributed.sharding import (
    PAPER_RULES,
    NamedSharding,
    drop_nondivisible,
    filter_rules,
)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import axis_size, spec_entries

PAPER_CELLS = (
    # m1 = 1024: the paper's 1000-object scenario, padded to the mesh
    Cell("offline_dual", "offline",
         {"batch": 8192, "m1": 1024, "K": 5, "m2": 50, "iters": 300}),
    Cell("serve_online", "serve",
         {"batch": 8192, "m1": 1024, "K": 5, "m2": 50, "d_cov": 20,
          "n_db": 1_048_576}),
    Cell("serve_retrieval", "serve_retrieval",
         {"batch": 256, "m1": 1_048_576, "K": 5, "m2": 50, "d_cov": 20,
          "n_db": 65536}),
)

PAPER_SMOKE_CELLS = (
    Cell("offline_dual", "offline",
         {"batch": 8, "m1": 64, "K": 3, "m2": 16, "iters": 50}),
    Cell("serve_online", "serve",
         {"batch": 8, "m1": 64, "K": 3, "m2": 16, "d_cov": 10, "n_db": 128}),
    Cell("serve_retrieval", "serve_retrieval",
         {"batch": 4, "m1": 1024, "K": 3, "m2": 16, "d_cov": 10,
          "n_db": 128}),
)


@dataclass(frozen=True)
class PaperConfig:
    name: str = "paper-ranking"
    knn_k: int = 10
    eps: float = 1e-4
    dual_iters: int = 300
    # §Perf variant: distributed KNN + top-k (k per shard crosses the
    # interconnect instead of the full distance matrix)
    distributed: bool = False


def _axis(rules, logical: str) -> str | tuple:
    entry = rules.resolve(logical)[0]
    if entry is None:
        raise ValueError(f"the mesh has no axis for {logical!r}")
    return entry


def _splits(mesh, rules, cell: Cell) -> bool:
    """Whether the cell's relaxed specs split its users, items or (a
    serve cell's) database rows over more than one block."""
    dims = [("batch", cell["batch"]), ("items", cell["m1"])]
    if cell.kind != "offline":
        dims.append(("users_db", cell["n_db"]))
    return any(axis_size(mesh, spec_entries(drop_nondivisible(
        rules.resolve(name), (n,), mesh), 1)[0]) > 1 for name, n in dims)


def build_paper(cfg: PaperConfig, cell: Cell, mesh) -> Program:
    """The cell's program: offline_dual (u, a, b) -> DualSolution; a
    serve cell (X, u, a, b, X_db, lam_db) -> RankingOutput. The default
    variant (a per-request (B, K, m1) `a`) runs partitioned over `mesh`
    where its relaxed specs split something (outputs Sharded, arguments
    tensors or Sharded laid by those specs) and global otherwise; the
    dist-topk variant's serve programs take a shared (K, m1) `a` and X_db
    a tensor or rows placed by launch.mesh.shard_rows."""
    rules = filter_rules(PAPER_RULES, mesh)
    B, m1, K, m2 = cell["batch"], cell["m1"], cell["K"], cell["m2"]
    f32 = torch.float32
    split = _splits(mesh, rules, cell)

    def sh(*logical):
        return NamedSharding(mesh, rules.resolve(*logical))

    u = sds((B, m1), f32, sh("batch", "items"))
    a = sds((B, K, m1), f32, sh("batch", None, "items"))
    b = sds((K,), f32, NamedSharding(mesh, ()))

    if cell.kind == "offline":
        iters = cell["iters"]

        def fn(u, a, b):
            if split:
                return solve_dual_partitioned(mesh, rules, u, a, b,
                                              dcg_discount(m2), m2=m2,
                                              num_iters=iters)
            return solve_dual_batch(u, a, b, dcg_discount(m2).to(u.device),
                                    m2=m2, num_iters=iters)

        return Program(fn=fn, args=(u, a, b), rules=rules)

    d_cov, n_db = cell["d_cov"], cell["n_db"]
    X = sds((B, d_cov), f32, sh("batch", None))
    X_db = sds((n_db, d_cov), f32, sh("users_db", None))
    eps, k = cfg.eps, cfg.knn_k

    if cfg.distributed and mesh.devices.size > 1:
        batch_axes = rules.resolve("batch")[0] or ()
        batch_axes = (batch_axes,) if isinstance(batch_axes, str) \
            else batch_axes
        db_axis, item_axis = _axis(rules, "users_db"), _axis(rules, "items")

        def fn(X, u, a, b, X_db, lam_db):
            lam_hat = knn_predict_distributed(mesh, X_db, lam_db, X, k=k,
                                              db_axis=db_axis,
                                              batch_axes=batch_axes)
            return rank_distributed(mesh, u, a, b, lam_hat,
                                    dcg_discount(m2).to(u.device), m2=m2,
                                    eps=eps, item_axis=item_axis,
                                    batch_axes=batch_axes)

        return Program(fn=fn, args=(
            X, u, sds((K, m1), f32, sh(None, "items")), b, X_db,
            sds((n_db, K), f32, NamedSharding(mesh, ()))), rules=rules)

    def fn(X, u, a, b, X_db, lam_db):
        if split:
            return serve_partitioned(mesh, rules, X, u, a, b, X_db, lam_db,
                                     dcg_discount(m2), k=k, m2=m2, eps=eps)
        lam_hat = ops.knn_lambda(X, X_db, lam_db, k=k, device=u.device)
        return ops.rank_audited(u, a, b, lam_hat,
                                dcg_discount(m2).to(u.device), m2=m2,
                                eps=eps, device=u.device)

    return Program(fn=fn, args=(X, u, a, b, X_db,
                                sds((n_db, K), f32, sh("users_db", None))),
                   rules=rules)


SPEC = register(ArchSpec(
    name="paper-ranking", family="paper",
    cells=PAPER_CELLS,
    make_config=lambda full=True: PaperConfig(),
    build=build_paper,
    notes="the paper's technique as its own arch (extra cells beyond "
          "the assigned 40).",
    variants={"dist-topk": lambda: PaperConfig(distributed=True)},
))
