"""The port's serving driver (repro_torch.launch.serve) and the example
twins on the CPU at tiny sizes (--train-steps 2, --requests 48,
--offline-users 32): every request served once, no ring allocated on the
dispatch path after warmup (compiles_post_warmup 0), and the JSON
report's keys those src/repro/launch/serve.py writes, read from its
source for each of its two paths (one engine, a FleetRouter), with
--admission, with --replicas 3 and with --executor fused and xla (the
report carries the flag's value, as JAX's does)."""

import ast
import contextlib
import importlib.util
import io
import json
from pathlib import Path

import pytest

from repro_torch.configs import get_arch
from repro_torch.launch import serve as launch
from repro_torch.serving import RankResult

REPO = Path(__file__).resolve().parent.parent
ARCHS = ("deepfm", "sasrec", "bert4rec", "mind")
TINY = ["--train-steps", "2", "--requests", "48", "--offline-users", "32",
        "--device", "cpu"]


def _jax_report_keys() -> dict:
    """{"engine": keys, "fleet": keys} of the report repro.launch.serve
    prints: the dict literal assigned to `report`, then each path's
    report.update({...})."""
    tree = ast.parse((REPO / "src/repro/launch/serve.py").read_text())
    base, paths = None, {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "report"
                for t in node.targets):
            base = [k.value for k in node.value.keys]
        if isinstance(node, ast.If) and "replicas" in ast.unparse(node.test):
            for name, body in (("fleet", node.body),
                               ("engine", node.orelse)):
                for stmt in body:
                    for sub in ast.walk(stmt):
                        if isinstance(sub, ast.Call) and \
                                ast.unparse(sub.func) == "report.update":
                            paths[name] = [k.value for k in
                                           sub.args[0].keys]
    return {name: base + keys for name, keys in paths.items()}


JAX_KEYS = _jax_report_keys()


def _served_once(dep, n):
    results = dep.served["results"]
    rids = sorted(r.rid for r in results)
    assert rids == list(range(n))
    assert all(isinstance(r, RankResult) for r in results)
    for r in results:
        assert len(set(r.perm.tolist())) == len(r.perm)


def _run(arch, *extra):
    args = launch.build_parser().parse_args(["--arch", arch, *TINY, *extra])
    cfg = get_arch(arch).make_config(full=False)
    dep = launch.deploy(cfg, args, device=args.device)
    reqs = launch.request_stream(dep, args)
    report = launch.serve(dep, reqs, args)
    return dep, report


def test_jax_report_keys_were_read():
    assert set(JAX_KEYS) == {"engine", "fleet"}
    assert JAX_KEYS["engine"][:2] == ["arch", "n_candidates"]
    assert "fleet" in JAX_KEYS["fleet"] and "pipeline" in JAX_KEYS["engine"]


@pytest.mark.parametrize("arch,executor", [
    pytest.param(a, "fused", id=a) for a in ARCHS] + [
    pytest.param(a, "xla", id=f"{a}-xla") for a in ARCHS])
def test_launcher_serves_every_arch(arch, executor):
    """Every arch through the default executor (fused) and through
    --executor xla. The report carries the flag's value."""
    dep, report = _run(arch, *(() if executor == "fused"
                               else ("--executor", executor)))
    assert list(report) == JAX_KEYS["engine"]
    assert report["requests"] == report["served"] == 48
    assert report["shed"] == 0 and report["compiles_post_warmup"] == 0
    assert report["executor"] == executor
    assert dep.served["engines"][0].executor == executor
    cfg = get_arch(arch).make_config(full=False)
    assert dep.d_cov == (cfg.n_interests * cfg.embed_dim if arch == "mind"
                         else cfg.embed_dim)
    assert dep.X_off.shape[0] == 32
    _served_once(dep, 48)


def test_launcher_with_admission():
    dep, report = _run("sasrec", "--admission")
    assert list(report) == JAX_KEYS["engine"]
    assert report["admission"] is True
    assert report["requests"] == 48 and report["compiles_post_warmup"] == 0
    eng = dep.served["engines"][0]
    assert "sasrec_mean" in eng.predictor_tags()     # the ladder's rung
    assert any(b.startswith("sasrec_mean/") for b in report["buckets"])
    assert report["served"] + report["shed"] == 48


def test_launcher_with_replicas():
    dep, report = _run("mind", "--replicas", "3")
    assert list(report) == JAX_KEYS["fleet"]
    assert report["requests"] == report["served"] == 48
    assert report["compiles_post_warmup"] == 0
    assert sorted(report["buckets"]) == ["r0", "r1", "r2"]
    assert report["fleet"]["lost"] == 0
    assert report["fleet"]["orphaned_futures"] == 0
    assert len(dep.served["engines"]) == 3
    _served_once(dep, 48)


def test_main_prints_the_report():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        report = launch.main(["--arch", "deepfm", *TINY])
    assert json.loads(out.getvalue()) == json.loads(json.dumps(report))
    assert report["served"] == 48 and report["executor"] == "fused"
    for executor in ("fused", "xla"):
        with contextlib.redirect_stdout(io.StringIO()):
            report = launch.main(["--arch", "deepfm", "--executor",
                                  executor, *TINY])
        assert report["executor"] == executor and report["served"] == 48
    with pytest.raises(SystemExit), \
            contextlib.redirect_stderr(io.StringIO()):
        launch.main(["--arch", "deepfm", "--executor", "dist", *TINY])


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,argv", [
    ("quickstart_torch", []),
    ("constrained_feed_torch", []),
    ("serve_recsys_torch", ["--requests", "48"]),
])
def test_example_twins_run(name, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = _example(name).main([*argv, "--device", "cpu"])
    text = out.getvalue()
    if name == "quickstart_torch":
        assert "optimal" in text and "served ranking" in text
    elif name == "constrained_feed_torch":
        assert "environment" in text and "compliance" in text
    else:
        assert got["results"] == 48 and got["compiles_post_warmup"] == 0
        assert "served 48/48 requests" in text
