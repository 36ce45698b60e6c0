"""The port's cost walk (launch/graph_cost.py), the counterpart of
tests/test_hlo_cost.py: toy torch programs with their counts worked by
hand, the nine kernels' trace twins against their work formulas, and
the walk's read leaves against make_fx plus dead-code elimination on
three SMOKE programs. Every count is exact. No card is needed: the walk
runs on the meta device (the fake card)."""

import math

import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch.checkpoint.store import flatten_with_paths
from repro_torch.configs import get_arch
from repro_torch.configs.registry import ArgSpec, Program
from repro_torch.launch import roofline
from repro_torch.launch.dryrun import _smoke_cell, smoke_mesh
from repro_torch.launch.graph_analysis import (
    device_category,
    memory_analysis,
    op_census,
)
from repro_torch.launch.graph_cost import (
    FAKE_CARD,
    KERNELS,
    _tensors,
    fake_card,
    graph_cost,
    trace_program,
)
from repro_torch.launch.mesh import virtual_mesh

F32, BF16, I32, I64 = torch.float32, torch.bfloat16, torch.int32, torch.int64


@pytest.fixture(scope="module")
def mesh1():
    with fake_card():
        return virtual_mesh((1, 1), ("data", "model"), FAKE_CARD)


def _walk(fn, mesh, *specs):
    return trace_program(Program(fn=fn, args=tuple(
        ArgSpec(tuple(s), dt) for s, dt in specs)), mesh)


def _loop(x, w):
    for _ in range(7):
        x = x @ w
    return x


def test_a_loop_counts_every_trip(mesh1):
    walk = _walk(_loop, mesh1, ((8, 128), F32), ((128, 128), F32))
    gc = graph_cost(walk)
    assert gc["flops_by_dtype"] == {"fp32": 7 * 2 * 8 * 128 * 128}
    assert gc["matmul_flops_by_dtype"] == gc["flops_by_dtype"]
    # each product reads x and w and writes its result
    assert gc["bytes"] == 7 * 4 * (8 * 128 + 128 * 128 + 8 * 128)
    assert op_census(walk) == {"matmul": 7}


def test_a_bf16_product_lands_in_the_bf16_bucket(mesh1):
    gc = graph_cost(_walk(_loop, mesh1, ((8, 128), BF16),
                          ((128, 128), BF16)))
    assert gc["flops_by_dtype"] == {"bf16": 7 * 2 * 8 * 128 * 128}
    assert roofline.compute_seconds(gc["flops_by_dtype"]) == \
        gc["flops"] / roofline.PEAK_FLOPS["bf16"]


@pytest.mark.parametrize("op", ["embedding", "index_select", "index"])
def test_gathers_count_the_rows_they_touch(mesh1, op):
    def fn(table, idx):
        if op == "embedding":
            return torch.nn.functional.embedding(idx, table)
        if op == "index_select":
            return torch.index_select(table, 0, idx)
        return table[idx]

    walk = _walk(fn, mesh1, ((100_000, 64), F32), ((32,), I64))
    res, idx = 32 * 64 * 4, 32 * 8
    assert graph_cost(walk)["bytes"] == 2 * res + idx
    assert op_census(walk) == {"index": 1}
    # the table is read only where the gather touches it
    assert walk.read_bytes()[(0, "")] == res


def test_index_put_counts_twice_the_update(mesh1):
    def fn(buf, idx, vals):
        return buf.index_put((idx,), vals)

    walk = _walk(fn, mesh1, ((1000, 16), F32), ((40,), I64),
                 ((40, 16), F32))
    assert graph_cost(walk)["bytes"] == 2 * 40 * 16 * 4
    assert op_census(walk) == {"scatter": 1}


def test_elementwise_counts_results_and_views_nothing(mesh1):
    def fn(x):
        y = torch.exp(x * 2.0 + 1.0)
        return y.reshape(64, 32).t()[:, :8]

    walk = _walk(fn, mesh1, ((32, 64), F32))
    assert graph_cost(walk)["bytes"] == 3 * 32 * 64 * 4
    # the three elementwise ops; the views share storage and go unlogged
    assert [op.cat for op in walk.ops] == ["elementwise"] * 3


def test_read_leaves_and_memory_of_a_toy(mesh1):
    def fn(x, unused, w):
        return torch.relu(x @ w)

    walk = _walk(fn, mesh1, ((4, 8), F32), ((1000,), F32), ((8, 16), F32))
    assert walk.read_leaves() == {(0, ""), (2, "")}
    ma = memory_analysis(walk)
    assert ma["argument_size_in_bytes"] == 4 * (4 * 8 + 8 * 16)
    assert ma["output_size_in_bytes"] == 4 * 4 * 16
    assert ma["temp_size_in_bytes"] == 4 * 4 * 16    # x @ w before relu
    assert ma["alias_size_in_bytes"] == 0
    # read once, written once: x and w, then the output
    assert walk.min_bytes() == 4 * (4 * 8 + 8 * 16) + 4 * 4 * 16


def test_an_in_place_update_of_an_argument_aliases(mesh1):
    def fn(cache, row):
        cache[:, 3:4] = row
        return cache

    walk = _walk(fn, mesh1, ((2, 16, 8), F32), ((2, 1, 8), F32))
    ma = memory_analysis(walk)
    assert ma["alias_size_in_bytes"] == ma["output_size_in_bytes"] == \
        2 * 16 * 8 * 4
    assert walk.read_leaves() == {(0, ""), (1, "")}
    # the row is read, and only its slice of the cache written
    assert walk.read_bytes() == {(0, ""): 0, (1, ""): 2 * 8 * 4}
    assert walk.min_bytes() == 2 * (2 * 8 * 4)


def test_layer_slices_of_a_stacked_leaf_count_once(mesh1):
    def fn(stack, x):
        for i in range(3):              # layers 0..2 of 4, layer 1 twice
            x = x @ stack[i] @ stack[1]
        return x

    walk = _walk(fn, mesh1, ((4, 16, 16), F32), ((2, 16), F32))
    assert walk.read_bytes()[(0, "")] == 3 * 16 * 16 * 4


# -- the nine kernels under the trace ----------------------------------------

B, M1, K, M2, D, KNN, KP, N, KX = 16, 256, 5, 8, 20, 10, 5, 4096, 8


def _rank(b=B):
    return [((b, M1), F32), ((b, K, M1), F32), ((b, K), F32)]


def _pack(mode):
    return [((N, D), torch.int8 if mode == "int8" else BF16),
            ((N // 512, 1), F32), ((N, 1), F32), ((N, KP), F32)]


def _kernel_case(name):
    """(fn over the kernels' wrappers, arg specs, work tuple)."""
    import importlib
    fr = importlib.import_module("repro_torch.kernels.fused_rank")
    kt = importlib.import_module("repro_torch.kernels.knn_topk")
    eb = importlib.import_module("repro_torch.kernels.embedding_bag")
    g = [((B, M2), F32)]
    knn = [((B, D), F32), ((N, D), F32), ((N, KP), F32)]
    if name == "fused_rank":
        return (lambda u, a, lam: fr.fused_rank_cuda(u, a, lam, m2=M2),
                _rank(), roofline.fused_work(B, M1, K, M2))
    if name == "rank_audited":
        return (lambda u, a, b, lam, gam: fr.rank_audited_cuda(
            u, a, b, lam, gam, m2=M2), _rank() + [((B, K), F32)] + g,
            roofline.rank_work(B, M1, K, M2))
    if name == "linear_rank_audited":
        return (lambda u, a, b, X, W, c, gam: fr.linear_rank_audited_cuda(
            u, a, b, X, W, c, gam, m2=M2),
            _rank() + [((B, D), F32), ((K, D), F32), ((K,), F32)] + g,
            roofline.linear_work(B, M1, K, M2, D))
    if name == "knn_topk":
        return (lambda q, db: kt.knn_topk_cuda(q, db, k=KNN), knn[:2],
                roofline.topk_work(B, N, D, KNN))
    if name == "knn_lambda":
        return (lambda q, db, lam: kt.knn_lambda_cuda(q, db, lam, k=KNN),
                knn, roofline.sweep_work(B, N, D, KNN, KP))
    if name == "knn_rank_audited":
        return (lambda q, db, lam, u, a, b, gam: kt.knn_rank_audited_cuda(
            q, db, lam, u, a, b, gam, k=KNN, m2=M2), knn + _rank() + g,
            roofline.knn_work(B, N, M1, K, M2, D, KNN, KP))
    if name == "knn_lambda_quant":
        return (lambda q, xq, s, y2, lam: kt.knn_lambda_quant_cuda(
            q, xq, s, y2, lam, k=KNN, k_extra=KX, mode="int8"),
            knn[:1] + _pack("int8"),
            roofline.quant_sweep_work(B, N, "int8", D, KNN, KP))
    if name == "knn_rank_audited_quant":
        return (lambda q, xq, s, y2, lam, u, a, b, gam:
                kt.knn_rank_audited_quant_cuda(
                    q, xq, s, y2, lam, u, a, b, gam, k=KNN, k_extra=KX,
                    mode="bf16", m2=M2),
                knn[:1] + _pack("bf16") + _rank() + g,
                roofline.quant_knn_work(B, N, M1, K, M2, "bf16", D, KNN, KP))
    return (lambda t, i, w: eb.embedding_bag_cuda(t, i, w),
            [((100_000, 64), BF16), ((512, 8), I32), ((512, 8), F32)],
            roofline.bag_shape_work(512, 8, 64, 2, True))


@pytest.mark.parametrize("name", KERNELS)
def test_a_kernel_op_costs_its_work_formula(mesh1, name):
    fn, specs, work = _kernel_case(name)
    walk = _walk(fn, mesh1, *specs)
    kops = [op for op in walk.ops if op.cat in KERNELS]
    assert [op.name for op in kops] == [name]
    gc = graph_cost(walk)
    assert gc["bytes"] == work[0]
    want = {"fp32": float(work[1])}
    if len(work) > 2:
        want[{"knn_lambda_quant": "int8"}.get(name, "bf16")] = \
            float(work[2])
    assert gc["flops_by_dtype"] == want
    assert gc["matmul_flops_by_dtype"] == {}
    assert op_census(walk) == {name: 1}
    assert device_category(f"void {name}_kernel<4>(float const*)") == \
        name or name == "knn_topk"


def test_device_time_groups_a_profile_into_the_census_categories():
    from types import SimpleNamespace

    from repro_torch.launch.graph_analysis import device_time_by_category

    def ev(key, us, dev="DeviceType.CUDA"):
        return SimpleNamespace(key=key, device_time_total=us,
                               device_type=dev)

    prof = SimpleNamespace(key_averages=lambda: [
        ev("sm90_xmma_gemm_bf16bf16_bf16f32", 2000.0),
        ev("void knn_sweep::chunk_topk_kernel<1>(float const*)", 500.0),
        ev("void knn_lambda_kernel<4>(float const*)", 100.0),
        ev("void at::native::index_elementwise_kernel<128, 4>", 50.0),
        ev("void at::native::vectorized_elementwise_kernel<4>", 25.0),
        ev("Memcpy DtoD (Device -> Device)", 10.0),
        ev("aten::mm", 2000.0, "DeviceType.CPU")])
    assert device_time_by_category(prof) == {
        "matmul": 2.0, "knn_sweep": 0.5, "knn_lambda": 0.1, "index": 0.05,
        "elementwise": 0.025, "copy": 0.01}


def test_the_served_path_keeps_its_wrappers():
    import importlib
    fr = importlib.import_module("repro_torch.kernels.fused_rank")
    from repro_torch.kernels import build, ops
    before = (ops.fused_rank_cuda, fr.fused_rank_cuda, build.launch)
    with fake_card():
        mesh = virtual_mesh((1, 1), ("data", "model"), FAKE_CARD)
    _walk(lambda u, a, lam: ops.fused_rank(u, a, lam, m2=M2,
                                           device=u.device),
          mesh, *_rank())
    assert (ops.fused_rank_cuda, fr.fused_rank_cuda, build.launch) == before
    with pytest.raises(ValueError):          # meta is no card outside
        from repro_torch.device import resolve_device
        resolve_device("meta")


def test_a_trace_is_its_threads_alone(mesh1):
    """While a trace runs, another thread (a pipeline worker, say) calls
    the real wrapper and is refused the meta device."""
    import importlib
    import threading

    from repro_torch.device import resolve_device
    from repro_torch.kernels.ref import fused_rank_ref
    fr = importlib.import_module("repro_torch.kernels.fused_rank")
    gen = torch.Generator().manual_seed(0)
    u, a, lam = (torch.rand(s, generator=gen) for s, _ in _rank())
    seen = {}

    def other():
        seen["out"] = fr.fused_rank_cuda(u, a, lam, m2=M2, device="cpu")
        try:
            resolve_device("meta")
        except ValueError:
            seen["meta_refused"] = True

    def fn(u_, a_, lam_):
        t = threading.Thread(target=other)
        t.start()
        t.join()
        seen["here"] = resolve_device("meta")
        return fr.fused_rank_cuda(u_, a_, lam_, m2=M2, device=u_.device)

    walk = _walk(fn, mesh1, *_rank())
    assert op_census(walk) == {"fused_rank": 1}
    assert seen["here"] == FAKE_CARD and seen["meta_refused"]
    want = fused_rank_ref(u, a, lam, M2)
    assert all(torch.equal(g, w) for g, w in zip(seen["out"], want))


# -- read leaves against make_fx + dead-code elimination --------------------

def _fx_read_leaves(prog):
    """make_fx of the program on CPU tensors of its SMOKE shapes, dead
    code eliminated: the placeholders left with users, as (arg index,
    path)."""
    from repro_torch.checkpoint.store import unflatten_like
    from repro_torch.distributed.sharding import use_mesh_rules

    flat = [(i, p, s) for i, a in enumerate(prog.args)
            for p, s in flatten_with_paths(a).items()]
    leaves = [torch.zeros(s.shape, dtype=s.dtype) for _, _, s in flat]

    def fn(*xs):
        by: dict = {}
        for (i, p, _), x in zip(flat, xs):
            by.setdefault(i, {})[p] = x
        # the outputs' tensors, a partitioned program's Sharded blocks
        # among them
        return list(_tensors(prog.fn(*(unflatten_like(a, by.get(i, {}))
                                       for i, a in enumerate(prog.args)))))

    with use_mesh_rules(None, None):
        gm = make_fx(fn)(*leaves)
    gm.graph.eliminate_dead_code()
    ph = [n for n in gm.graph.nodes if n.op == "placeholder"]
    return {(i, p) for (i, p, _), n in zip(flat, ph) if n.users}


@pytest.mark.parametrize("arch,cell", [
    ("mind", "serve_p99"), ("deepfm", "retrieval_cand"),
    ("llama3.2-1b", "train_4k")])
def test_read_leaves_equal_make_fx_dead_code_elimination(arch, cell,
                                                          monkeypatch):
    # make_fx loses a tensor that a new nn.Parameter wraps: the recsys
    # models, which bind their parameter tree as parameters, bind it as
    # buffers for make_fx (the same tensors, tracked)
    from repro_torch.models import recsys

    def register(module, tree):
        module._tree_keys = list(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                module.add_module(k, recsys._Node(v))
            elif isinstance(v, list):
                module.add_module(k, torch.nn.ModuleList(
                    [recsys._Node(x) for x in v]))
            else:
                module.register_buffer(k, v)

    spec = get_arch(arch)
    cfg, c = spec.make_config(False), _smoke_cell(spec, cell)
    mesh = smoke_mesh()
    walk = trace_program(spec.build(cfg, c, mesh), mesh)
    cpu_mesh = virtual_mesh((2, 4), ("data", "model"), "cpu")
    monkeypatch.setattr(recsys, "_register", register)
    monkeypatch.setattr(recsys._RecsysModel, "device", property(
        lambda self: next(self.buffers()).device))
    want = _fx_read_leaves(spec.build(cfg, c, cpu_mesh))
    assert walk.read_leaves() == want
    if arch == "mind":
        assert len(want) < len(walk.arg_specs)


def test_block_bytes_divide_a_sharded_leaf():
    from repro_torch.distributed.sharding import NamedSharding
    from repro_torch.launch.graph_analysis import block_bytes
    with fake_card():
        mesh = virtual_mesh((2, 16, 16), ("pod", "data", "model"),
                            FAKE_CARD)
    spec = ArgSpec((4096, 2048), BF16,
                   NamedSharding(mesh, (("pod", "data"), "model")))
    assert block_bytes(spec) == 4096 * 2048 * 2 // (32 * 16)
    assert block_bytes(ArgSpec((7, 3), F32)) == 84
    assert math.isclose(roofline.link_rate(mesh.shape, "model"),
                        roofline.NIC_BW)


# -- per device: shard bodies and collectives ----------------------------------

@pytest.fixture(scope="module")
def mesh24():
    with fake_card():
        return virtual_mesh((2, 4), ("data", "model"), FAKE_CARD)


def test_shard_bodies_are_costed_one_body_and_their_handoff_counted(mesh24):
    from repro_torch.distributed.topk import sharded_score_topk
    from repro_torch.launch.graph_analysis import collective_bytes

    walk = _walk(lambda s: sharded_score_topk(mesh24, s, 4), mesh24,
                 ((8, 64), F32))
    assert walk.partitioned
    bodies = {op.region for op in walk.ops if op.region
              and op.region[0] == "body"}
    assert {r[1] for r in bodies} == {(i, j) for i in range(2)
                                      for j in range(4)}
    # every body but the merging device's hands 4 rows of 4 (value f32,
    # index int64) to the merge
    cb = collective_bytes(walk, "serve")
    assert cb["parts"]["shard_gather"] == {
        "how": "counted", "bytes": 7 * 4 * 4 * (4 + 8),
        "axes": ["data", "model"]}
    assert cb["parts"]["tp_activations"]["how"] == "absent"
    # one body's sort over its 4 x 16 block, not eight of them
    gc = graph_cost(walk)
    one = sum(op.nbytes for op in walk.ops if op.region == ("body", (1, 3)))
    merge = sum(op.nbytes for op in walk.ops if op.region == ("merge",))
    rest = sum(op.nbytes for op in walk.ops if op.region is None)
    assert gc["bytes"] == one + merge + rest / 8


def test_a_body_after_global_work_costs_its_own_backward_alone(mesh24):
    """A train step whose map_shards bodies read a global layer's
    output: the global layer's backward stays in the global part (over
    the 8 devices), and a body's region holds its own product and the
    two of its backward, not the work before it."""
    from repro_torch.distributed.topk import map_shards

    def fn(w1, w2, x):
        w1, w2 = (w.detach().requires_grad_(True) for w in (w1, w2))
        with torch.enable_grad():
            h = x @ w1
            out = map_shards(mesh24, "model", ("data",), 8,
                             lambda rows, si, dev: h[rows] @ w2[
                                 :, 4 * si:4 * (si + 1)], x.device)
            loss = sum(torch.sum(p) for _, parts in out for p in parts)
            return torch.autograd.grad(loss, (w1, w2))

    walk = _walk(fn, mesh24, ((16, 16), F32), ((16, 16), F32),
                 ((8, 16), F32))
    assert walk.partitioned
    mm = graph_cost(walk)["matmul_flops_by_dtype"]
    # global: x @ w1 and x^T @ dh (x takes no gradient) over 8 devices;
    # one body: (4, 16) @ (16, 4), and do @ w2^T and h^T @ do
    assert sum(mm.values()) == 2 * (2 * 8 * 16 * 16) / 8 + 3 * (2 * 4 * 16 * 4)


def test_train_collectives_are_modeled_from_the_specs(mesh24):
    from repro_torch.distributed.sharding import NamedSharding
    from repro_torch.launch.graph_analysis import collective_bytes

    def fn(params, x):
        return torch.relu(x @ params["w"] + params["b"])

    spec = (ArgSpec((8, 16), F32, NamedSharding(mesh24, ("data", "model"))),
            ArgSpec((16,), F32, NamedSharding(mesh24, ())))
    walk = trace_program(Program(fn=fn, args=(
        {"w": spec[0], "b": spec[1]}, ArgSpec((4, 8), F32))), mesh24)
    cb = collective_bytes(walk, "train")
    blk = 4 * 4 * 4                      # w's (4, 4) block a device
    assert {k: (p["how"], p["bytes"], p["axes"])
            for k, p in cb["parts"].items()} == {
        "param_all_gather": ("modeled", 2 * blk * 2, ["data"]),
        "grad_reduce_scatter": ("modeled", blk, ["data"]),
        "grad_all_reduce": ("modeled", 16 * 4, ["data"]),
        "tp_activations": ("absent", None, ["model"])}
    assert cb["total"] == 2 * blk * 2 + blk + 64
    # 'data' and 'model' fit one 8-GPU node: NVLink
    assert math.isclose(cb["seconds"], cb["total"] / roofline.NVLINK_BW)
