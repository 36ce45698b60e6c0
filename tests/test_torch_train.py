"""The port's training driver on the CPU: the fault-tolerant runner
(distributed.runner, twins of tests/test_checkpoint.py's runner tests
plus async checkpoints and a failure before the first checkpoint), a
(params, AdamState) checkpoint read bitwise by the other package both
ways with JAX's paths (1/.step, 1/.mu/<name>, 1/.nu/<name>), the
launcher (launch.train) for an LM, a recsys backbone and the GNN at
--smoke, whose run with an injected failure equals, bitwise, the run
without one, with the JSON report's keys those src/repro/launch/train.py
prints, read from its source, and examples/train_lm_torch.py."""

import ast
import contextlib
import importlib.util
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointStore as JaxStore
from repro.configs import get_arch as jax_get_arch
from repro.models.gnn import MeshGraphNet as JaxMGN
from repro.optim import adam_init as jax_adam_init
from repro.optim import adam_update as jax_adam_update
from repro_torch.checkpoint import CheckpointStore
from repro_torch.checkpoint.store import flatten_with_paths
from repro_torch.configs import get_arch
from repro_torch.data.batches import (
    make_csr_graph,
    make_molecule_batch,
    make_random_graph,
)
from repro_torch.distributed import FaultTolerantRunner, RunnerReport
from repro_torch.launch import train as launch
from repro_torch.models.gnn import MeshGraphNet, gnn_from_numpy, gnn_init
from repro_torch.optim import AdamState

REPO = Path(__file__).resolve().parent.parent
CPU = "cpu"
ARCHS = ("meshgraphnet", "llama3.2-1b", "sasrec")


@pytest.fixture
def store(tmp_path):
    return CheckpointStore(str(tmp_path / "ckpt"), keep_last=3)


# --------------------------------------------------------------------------
# The runner
# --------------------------------------------------------------------------

def _adder(store, **kw):
    def step_fn(state, batch):
        return {"w": state["w"] + batch}, {"w0": state["w"][0]}

    def batch_fn(step):
        return torch.full((2,), float(step))

    return FaultTolerantRunner(store, step_fn, batch_fn, **kw)


def _once(*steps):
    fails = set(steps)
    return lambda s: s in fails and not fails.discard(s)


def test_runner_recovers_from_failures(store):
    runner = _adder(store, ckpt_every=4, max_restarts=4, async_ckpt=False)
    state, report = runner.run({"w": torch.zeros(2)}, 16,
                               fail_at=_once(6, 11), device=CPU)
    assert report.restarts == 2
    # deterministic replay: the result of a failure-free run
    assert torch.equal(state["w"], torch.full((2,), float(sum(range(16)))))
    # metrics come back as host numbers
    assert all(isinstance(m["w0"], float) for m in report.metrics_history)


def test_runner_gives_up_after_max_restarts(store):
    def step_fn(state, batch):
        raise RuntimeError("dead device")

    runner = FaultTolerantRunner(store, step_fn, lambda s: None,
                                 max_restarts=2, async_ckpt=False)
    with pytest.raises(RuntimeError, match="dead device"):
        runner.run({"w": torch.zeros(1)}, 5, device=CPU)


def test_runner_resumes_from_checkpoint(store):
    def step_fn(state, batch):
        return {"w": state["w"] + 1.0}, {}

    runner = FaultTolerantRunner(store, step_fn, lambda s: None,
                                 ckpt_every=5, async_ckpt=False)
    state, _ = runner.run({"w": torch.zeros(1)}, 10, device=CPU)
    assert float(state["w"][0]) == 10
    # new run, same store: resumes at step 10, runs 5 more
    state2, report2 = runner.run({"w": torch.zeros(1)}, 15, device=CPU)
    assert float(state2["w"][0]) == 15
    assert report2.steps_run == 5


def test_runner_recovers_with_async_checkpoints(store):
    runner = _adder(store, ckpt_every=3, max_restarts=3)
    state, report = runner.run({"w": torch.zeros(2)}, 14,
                               fail_at=_once(4, 10), device=CPU)
    # saves at 3, 6, 9, 12 and 14; each failure restores the newest
    # checkpoint (3, then 9) and replays the step before it failed
    assert report.restarts == 2 and report.checkpoints == 5
    assert torch.equal(state["w"], torch.full((2,), float(sum(range(14)))))
    assert report.steps_run == 14 + 1 + 1
    assert store.latest_step() == 14 and isinstance(report, RunnerReport)


def test_runner_restarts_from_the_initial_state_before_a_checkpoint(store):
    runner = _adder(store, ckpt_every=10, async_ckpt=False)
    state, report = runner.run({"w": torch.zeros(2)}, 6, fail_at=_once(4),
                               device=CPU)
    assert report.restarts == 1 and report.steps_run == 6 + 4
    assert torch.equal(state["w"], torch.full((2,), float(sum(range(6)))))


# --------------------------------------------------------------------------
# (params, AdamState) across packages
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_opt_state():
    """JAX's (params, AdamState) after one Adam step of the SMOKE GNN."""
    jcfg = jax_get_arch("meshgraphnet").make_config(full=False)

    @jax.jit
    def one_step(key):
        params = JaxMGN(jcfg).init(key)
        grads = jax.tree.map(lambda p: 0.5 * p + 0.01, params)
        return jax_adam_update(grads, jax_adam_init(params), params,
                               lr=1e-3)

    return one_step(jax.random.key(0))


def _port_state(new, opt):
    cfg = get_arch("meshgraphnet").make_config(full=False)

    def flat(tree):
        return {k: torch.from_numpy(np.array(v))
                for k, v in flatten_with_paths(
                    jax.tree.map(np.asarray, tree)).items()}

    return (gnn_from_numpy(jax.tree.map(np.asarray, new), cfg, device=CPU),
            AdamState(step=torch.tensor(int(opt.step), dtype=torch.int32),
                      mu=flat(opt.mu), nu=flat(opt.nu)))


def _same(port_state, jax_state):
    got = flatten_with_paths(port_state)
    want = {k: np.asarray(v) for k, v in flatten_with_paths(
        jax.tree.map(np.asarray, jax_state)).items()}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else \
            np.asarray(got[k])
        assert g.dtype == v.dtype and g.shape == v.shape, k
        np.testing.assert_array_equal(g, v, err_msg=k)


def test_adam_state_paths_are_jax_paths(jax_opt_state):
    port = _port_state(*jax_opt_state)
    paths = list(flatten_with_paths(port))
    assert "1/.step" in paths
    assert "1/.mu/processor/edge_mlp/w0" in paths
    assert "1/.nu/decoder/ln_bias" in paths
    assert "0/node_encoder/w0" in paths
    assert len(paths) == 3 * len(flatten_with_paths(port[0])) + 1


def test_adam_checkpoint_from_the_port_restores_bitwise_in_jax(
        tmp_path, jax_opt_state):
    new, opt = jax_opt_state
    CheckpointStore(str(tmp_path)).save(3, _port_state(new, opt),
                                        extra={"next_step": 3})
    manifest = json.loads((tmp_path / "step_0000000003" /
                           "manifest.json").read_text())
    assert "1/.mu/processor/node_mlp/b1" in manifest["leaves"]
    like = jax.tree.map(jnp.zeros_like, (new, opt))
    restored, extra = JaxStore(str(tmp_path)).restore(like)
    assert extra == {"next_step": 3}
    assert int(restored[1].step) == 1
    _same(_port_state(*restored), (new, opt))


def test_adam_checkpoint_from_jax_restores_bitwise_in_the_port(
        tmp_path, jax_opt_state):
    new, opt = jax_opt_state
    JaxStore(str(tmp_path)).save(5, (new, opt), extra={"next_step": 5})
    cfg = get_arch("meshgraphnet").make_config(full=False)
    params = gnn_init(None, cfg, device=CPU)
    like = (params, AdamState(
        step=torch.zeros((), dtype=torch.int32),
        mu={k: torch.zeros_like(v) for k, v in
            flatten_with_paths(params).items()},
        nu={k: torch.zeros_like(v) for k, v in
            flatten_with_paths(params).items()}))
    restored, extra = CheckpointStore(str(tmp_path)).restore(like,
                                                             device=CPU)
    assert extra == {"next_step": 5}
    assert isinstance(restored[1], AdamState)
    assert restored[1].step.dtype == torch.int32
    _same(restored, (new, opt))


# --------------------------------------------------------------------------
# The launcher
# --------------------------------------------------------------------------

def _jax_report_keys() -> list:
    """The keys of the report repro.launch.train prints: build_training's
    describe dict, then json.dumps' literal after its **desc."""
    tree = ast.parse((REPO / "src/repro/launch/train.py").read_text())
    desc, report = None, None
    for node in ast.walk(tree):
        if isinstance(node, ast.Return) and isinstance(node.value,
                                                       ast.Tuple):
            last = node.value.elts[-1]
            if isinstance(last, ast.Dict):
                desc = [k.value for k in last.keys]
        if isinstance(node, ast.Call) and ast.unparse(node.func) == \
                "json.dumps":
            report = node.args[0].keys
    assert report[0] is None               # the **desc unpacking
    return desc + [k.value for k in report[1:]]


JAX_KEYS = _jax_report_keys()


def _args(arch, ckpt, *extra):
    # --batch and --seq cut the LM's and SASRec's batches (the GNN's
    # graph is the launcher's own smoke size)
    return launch.build_parser().parse_args(
        ["--arch", arch, "--smoke", "--steps", "4", "--ckpt-every", "2",
         "--batch", "2", "--seq", "16", "--ckpt-dir", str(ckpt),
         "--device", CPU, *extra])


@pytest.fixture
def deterministic():
    """torch's deterministic algorithms for the test's length. On the
    CPU, index_put(accumulate=True), the backward of every gather of the
    port's models, adds on several threads in no fixed order (SASRec's
    item-table gradient differs run to run in its last bits); the
    deterministic setting makes it add in index order. On the card the
    op sorts its indices and is deterministic either way."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_replay_is_bitwise(tmp_path, arch, deterministic):
    """A run with a failure at step 3 (restored from step 2's
    checkpoint) ends in the state of an uninterrupted run, bit for bit:
    parameters and the whole Adam state."""
    ref_state, ref_rep, ref_out = launch.run(_args(arch, tmp_path / "a"))
    state, rep, out = launch.run(_args(arch, tmp_path / "b", "--fail-at",
                                       "3"))
    assert list(out) == list(ref_out) == JAX_KEYS
    assert out["family"] == get_arch(arch).family
    assert (ref_out["restarts"], out["restarts"]) == (0, 1)
    assert (ref_out["steps"], out["steps"]) == (4, 5)
    assert ref_out["checkpoints"] == 2 and out["checkpoints"] == 2
    assert isinstance(state[1], AdamState) and int(state[1].step) == 4
    got, want = flatten_with_paths(state), flatten_with_paths(ref_state)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])
    # the replayed steps' losses are the uninterrupted run's
    losses = [m["loss"] for m in rep.metrics_history]
    assert losses[:3] + losses[4:] == [m["loss"] for m in
                                       ref_rep.metrics_history]
    assert losses[3] == losses[2]          # step 2 replayed


def test_launcher_main_prints_jax_report(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = launch.main(["--arch", "meshgraphnet", "--smoke", "--steps",
                           "3", "--ckpt-dir", str(tmp_path), "--device",
                           CPU])
    assert json.loads(buf.getvalue()) == out
    assert list(out) == JAX_KEYS and out["steps"] == 3


def test_launcher_refuses_other_families():
    with pytest.raises(ValueError, match="lm/recsys/gnn"):
        launch.build_training("paper-ranking", smoke=True, batch=None,
                              seq=None, device=CPU)


def _example_main(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def test_train_lm_example_recovers_and_learns():
    report = _example_main("train_lm_torch")(
        ["--device", CPU, "--steps", "20", "--d-model", "32", "--layers",
         "1", "--batch", "4", "--seq", "32"])
    assert report.restarts == 1
    losses = [m["loss"] for m in report.metrics_history]
    assert losses[-1] < losses[0]


# --------------------------------------------------------------------------
# The card by default
# --------------------------------------------------------------------------

def _default_device_calls(tmp):
    cfg = get_arch("meshgraphnet").make_config(full=False)
    gen = torch.Generator()
    graph = dict(n_nodes=4, n_edges=6, d_node=3, d_edge=2, d_out=1)
    saved = CheckpointStore(str(tmp / "saved"))
    saved.save(1, {"w": torch.zeros(1)}, extra={"next_step": 1})
    calls = {
        "MeshGraphNet": lambda: MeshGraphNet(cfg),
        "gnn_init": lambda: gnn_init(None, cfg),
        "make_random_graph": lambda: make_random_graph(gen, **graph),
        "make_molecule_batch": lambda: make_molecule_batch(gen, batch=2,
                                                           **graph),
        "make_csr_graph": lambda: make_csr_graph(gen, n_nodes=5,
                                                 avg_degree=2),
        "FaultTolerantRunner.run(restore)": lambda: FaultTolerantRunner(
            saved, lambda s, b: (s, {}), lambda s: None).run(
                {"w": torch.zeros(1)}, 3),
        "launch.train.main": lambda: launch.main(
            ["--arch", "meshgraphnet", "--smoke", "--steps", "1",
             "--ckpt-dir", str(tmp / "main")]),
        "train_lm_torch.main": lambda: _example_main("train_lm_torch")(
            ["--steps", "1"]),
    }
    for arch in ARCHS:
        calls[f"build_training({arch})"] = (
            lambda a=arch: launch.build_training(a, smoke=True, batch=None,
                                                 seq=None))
    return calls


DEFAULT_DEVICE_CALLS = (
    "MeshGraphNet", "gnn_init", "make_random_graph", "make_molecule_batch",
    "make_csr_graph", "FaultTolerantRunner.run(restore)",
    "launch.train.main", "train_lm_torch.main") + tuple(
        f"build_training({a})" for a in ARCHS)


@pytest.mark.parametrize("name", DEFAULT_DEVICE_CALLS)
def test_default_device_raises_without_cuda(tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    calls = _default_device_calls(tmp_path)
    assert sorted(calls) == sorted(DEFAULT_DEVICE_CALLS)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[name]()
