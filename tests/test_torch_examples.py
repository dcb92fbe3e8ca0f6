"""The port's examples (examples_torch/) against the reference's.

The reference's scripts (examples/) run at import and take no
arguments, so each case calls the reference functions its script calls,
at the sizes the case passes to the port's `run(device="cpu", ...)`:

- quickstart, pattern_sweep, failure_sweep and online_arrivals print the
  same numbers: within 1e-4 relative of the reference's under
  backend="pallas" (1e-9 absolute about 0), and bitwise under backend="xla" where
  tests/test_torch_coo.py's probe shows that this host's XLA orders the
  reference's scatters as the COO kernel's plain version does (those
  cases skip with the probe's reason elsewhere); every schedule the port
  returns is certified;
- serve_batch's tokens as tests/test_torch_model.py holds the serve CLI
  (two runs equal, the shape asked for, in the smoke vocabulary);
- train_lm for 2 steps from the reference launcher's weights, against
  that launcher compiled without excess precision as
  tests/test_torch_train.py compiles the reference: both losses, the
  first gradient's norm, and the first step's moments and parameters
  within that file's bounds, and the first update within half its size
  of the reference's (a model that does not move is a whole update
  off).  The case runs at the smoke width and 2 layers: at the example's
  own 8 layers the gradient is dominated by rounding (its norm is of the
  order of 1e6, and the reference's own compiles with and without
  excess precision disagree on it by tens of per cent), so no two
  implementations agree there beyond the first loss;
- coflow_schedule.py of both packages run whole in subprocesses, their
  printed numbers equal to the last printed place (the port's plan runs
  its own default lowering, the reference's its COO one);
- every example's main() without --device raises on a host without
  CUDA, and imports nothing but repro_torch, numpy and the standard
  library.
"""
import ast
import importlib.util
import json
import math
import os
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.core import arrivals as r_arrivals
from repro.core import failures as r_failures
from repro.core import oracle as r_oracle
from repro.core import solver as r_solver
from repro.core import timeslot as r_timeslot
from repro.core import topology as r_topology
from repro.core import traffic as r_traffic
from repro.ft import CheckpointManager as RCheckpointManager
from repro.launch import train as r_train
from repro.models import transformer as r_transformer
from repro.train import optimizer as r_opt
from repro_torch import configs, convert
from repro_torch.core import verify
from repro_torch.ft import CheckpointManager
from repro_torch.launch import train
from repro_torch.models import transformer
from repro_torch.train import optimizer as opt
from test_torch_coo import _xla_order_probe

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "pattern_sweep", "failure_sweep",
            "online_arrivals", "serve_batch", "coflow_schedule", "train_lm")
RTOL = 1e-4
BACKENDS = ("pallas", "xla")
# train_lm: its case's sizes, and tests/test_torch_train.py's bounds
TRAIN_ARGS = dict(d_model=64, n_layers=2, batch=8, seq=512, lr=1e-3)
LOSS_TOL = 2e-2
NORM_RTOL = 2e-2
GRAD_TOL = 5e-2
# the first update against the reference's, over the reference's size: a
# model that does not move is 1 off, one that moves the wrong way 2
UPDATE_RTOL = 0.5


@pytest.fixture(autouse=True)
def one_thread():
    """The port's CPU runs on one thread: its plain bursts are many small
    ops, which torch's intra-op threads slow down on a loaded host (the
    suite runs six workers), and no case here hangs on the thread
    count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _module(name: str, path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# chip_smoke.py's phase 34 runs the same examples and compares them the
# same way: one copy of each
chip_smoke = _module("chip_smoke", ROOT / "chip_smoke.py")
example = chip_smoke.load_example
# where two runs' numbers differ: floats by more than rtol of the larger
# and 1e-9 (a value of 0 beside float noise: a drained backlog), bitwise
# at rtol 0, anything else unequal
agree = chip_smoke.numbers_differ


def numbers(out: dict) -> dict:
    """An example's printed numbers: its run's output less "results"."""
    return {k: v for k, v in out.items() if k != "results"}


def hold(backend: str, got: dict, want: dict) -> None:
    if backend == "xla":
        reason = _xla_order_probe()
        if reason is not None:
            pytest.skip(reason)
    off = agree(numbers(got), want, 0.0 if backend == "xla" else RTOL)
    assert not off, off[:10]


def certified(out: dict) -> None:
    for p, r in out["results"]:
        verify.check_schedule(p, r.schedule).assert_ok("example")


# -- the reference's scripts, as functions of their sizes ------------------

def ref_quickstart(backend, topos, total_gbits=8.0, n_map=4, n_reduce=3,
                   seed=1, n_slots=6, rho=8.0, iters=4000, time_limit=120):
    out = {}
    for name in topos:
        topo = r_topology.build(name)
        coflow = r_traffic.shuffle_traffic(topo, total_gbits, n_map=n_map,
                                           n_reduce=n_reduce, seed=seed)
        prob = r_timeslot.ScheduleProblem(topo, coflow, n_slots=n_slots,
                                          rho=rho)
        for objective in ("time", "energy"):
            em = r_oracle.solve_lexico(prob, objective,
                                       time_limit=time_limit).metrics
            fm = r_solver.solve_fast(prob, objective, iters=iters,
                                     backend=backend).metrics
            out[name, objective] = {
                "oracle_completion_s": em.completion_s,
                "oracle_energy_j": em.energy_j,
                "completion_s": fm.completion_s, "energy_j": fm.energy_j,
                "feasible": fm.feasible}
    return out


def _ref_problems(topo, pat_name, seeds, n_map, n_reduce, total_gbits):
    pat = r_traffic.pattern(pat_name, n_map=n_map, n_reduce=n_reduce,
                            total_gbits=total_gbits)
    return [r_timeslot.ScheduleProblem(
                topo, cf, n_slots=r_timeslot.suggest_n_slots(topo, cf),
                path_slack=2)
            for cf in r_traffic.generate_batch(topo, pat, seeds)]


def ref_pattern_sweep(backend, topo, n_seeds, patterns, n_map=4,
                      n_reduce=3, total_gbits=6.0, iters=2000):
    topo = r_topology.build(topo)
    out = {}
    for pat_name in patterns:
        probs = _ref_problems(topo, pat_name, range(n_seeds), n_map,
                              n_reduce, total_gbits)
        results = r_solver.solve_fast_batch(probs, "energy", iters=iters,
                                            backend=backend)
        out[pat_name] = {
            "energy_j": [r.metrics.energy_j for r in results],
            "completion_s": [r.metrics.completion_s for r in results],
            "feasible": all(r.metrics.feasible for r in results)}
    return out


def ref_failure_sweep(backend, topos, presets, n_seeds, n_map=4, n_reduce=3,
                      total_gbits=6.0, iters=2000):
    out = {}
    for topo_name in topos:
        topo = r_topology.build(topo_name)
        probs = _ref_problems(topo, "uniform", range(n_seeds), n_map,
                              n_reduce, total_gbits)
        healthy = r_solver.solve_fast_batch(probs, "energy", iters=iters,
                                            backend=backend)
        offered = np.array([p.coflow.total_gbits for p in probs])
        out[topo_name, "healthy"] = {"energy_j": np.mean(
            [r.metrics.energy_j for r in healthy])}
        for preset in presets:
            dprobs = [r_failures.degrade_problem(
                          p, r_failures.sample(topo, preset, s))
                      for s, p in enumerate(probs)]
            results = r_solver.solve_fast_ensemble(
                dprobs, "energy", warm=healthy, iters=iters, backend=backend)
            out[topo_name, preset] = {
                "survivability": (np.array([r.metrics.served.sum()
                                            for r in results])
                                  / offered).tolist(),
                "energy_j": [r.metrics.energy_j for r in results],
                "capacity_lost": float(np.mean(
                    [r_failures.degradation_ratio(topo, dp.topo)
                     for dp in dprobs]))}
    return out


def ref_online_arrivals(backend, n_coflows, topo="spine-leaf", n_map=4,
                        n_reduce=3, total_gbits=48.0,
                        mean_interarrival_s=2.0, seed=0, epoch_s=1.0,
                        iters=3000):
    topo = r_topology.build(topo)
    pat = r_traffic.pattern("uniform", n_map=n_map, n_reduce=n_reduce,
                            total_gbits=total_gbits)
    spec = r_arrivals.ArrivalSpec(family="poisson", n_coflows=n_coflows,
                                  mean_interarrival_s=mean_interarrival_s)
    trace = r_arrivals.generate_trace(topo, pat, spec, seed=seed)
    out = {"arrivals": [a.t_arrive for a in trace]}
    for warm in (False, True):
        r = r_arrivals.run_online(topo, trace, "energy", warm=warm,
                                  epoch_s=epoch_s, iters=iters,
                                  backend=backend)
        out["warm" if warm else "cold"] = {
            "epochs": [(e.index, e.t_start, e.n_admitted, e.n_flows,
                        e.backlog_gbits, e.iterations, e.warm)
                       for e in r.epochs],
            "total_iterations": r.total_iterations,
            "total_energy_j": r.total_energy_j,
            "mean_response_s": r.mean_response_s,
            "makespan_s": r.makespan_s}
    return out


# -- the cases ---------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_quickstart_matches_the_reference(backend):
    got = example("quickstart").run("cpu", backend, topos=("pon3",))
    certified(got)
    hold(backend, got, ref_quickstart(backend, ("pon3",)))


@pytest.mark.parametrize("backend", BACKENDS)
def test_pattern_sweep_matches_the_reference(backend):
    kw = dict(n_seeds=2, patterns=("uniform", "local"))
    got = example("pattern_sweep").run("cpu", backend, topo="pon3", **kw)
    certified(got)
    hold(backend, got, ref_pattern_sweep(backend, "pon3", **kw))


@pytest.mark.parametrize("backend", BACKENDS)
def test_failure_sweep_matches_the_reference(backend):
    kw = dict(topos=("pon3",), presets=("link1", "switch"), n_seeds=2)
    got = example("failure_sweep").run("cpu", backend, **kw)
    certified(got)
    hold(backend, got, ref_failure_sweep(backend, **kw))


@pytest.mark.parametrize("backend", BACKENDS)
def test_online_arrivals_matches_the_reference(backend):
    got = example("online_arrivals").run("cpu", backend, n_coflows=3)
    for r in got["results"]:
        assert all(e.feasible for e in r.epochs)
    hold(backend, got, ref_online_arrivals(backend, n_coflows=3))


def test_serve_batch_repeats_its_tokens(capsys):
    kw = dict(batch=2, prompt_len=16, gen=4)
    mod = example("serve_batch")
    first, second = mod.run("cpu", **kw), mod.run("cpu", **kw)
    assert list(first) == ["recurrentgemma-2b", "gemma2-27b"]
    for arch, toks in first.items():
        assert toks.shape == (2, 4)
        assert ((toks >= 0) & (toks < 256)).all()
        np.testing.assert_array_equal(toks, second[arch])
    out = capsys.readouterr().out
    assert "=== recurrentgemma-2b (smoke config) ===" in out
    assert "arch=gemma2-smoke" in out


def _gnorms(out: str) -> list[float]:
    return [float(g) for g in re.findall(r"gnorm (\S+)", out)]


def _leaf_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over want's largest |value|."""
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


def test_train_lm_losses_match_the_reference(tmp_path, capsys):
    """Module docstring.  The reference launcher runs in a subprocess
    whose XLA_FLAGS turn excess precision off (its rounding of bf16
    intermediates then matches the port's; with it on, the first step's
    moments are up to a tenth of their leaf apart)."""
    argv = ["--arch", "phi4-mini-3.8b", "--smoke",
            "--d-model", str(TRAIN_ARGS["d_model"]),
            "--n-layers", str(TRAIN_ARGS["n_layers"]), "--steps", "2",
            "--batch", str(TRAIN_ARGS["batch"]),
            "--seq", str(TRAIN_ARGS["seq"]), "--lr", str(TRAIN_ARGS["lr"]),
            "--ckpt-every", "1", "--log-every", "1"]
    rcfg = r_train.scale_config(r_configs.get("phi4-mini-3.8b", smoke=True),
                                TRAIN_ARGS["d_model"], TRAIN_ARGS["n_layers"])
    cfg = train.scale_config(configs.get("phi4-mini-3.8b", smoke=True),
                             TRAIN_ARGS["d_model"], TRAIN_ARGS["n_layers"])
    rparams = r_transformer.init_params(rcfg, jax.random.PRNGKey(0), tp=1)
    model = transformer.Transformer(cfg, generator=torch.Generator(),
                                    device=torch.device("cpu"))
    start = convert.params_from_numpy(cfg,
                                      jax.tree.map(np.asarray, rparams))
    model.load_state_dict(start)
    tree = {"params": model.state_dict(),
            "opt": opt.adamw_init(dict(model.named_parameters()))}
    CheckpointManager(tmp_path / "port").save(0, tree)

    got = example("train_lm").run("cpu", steps=2, ckpt_dir=tmp_path / "port",
                                  resume=True, ckpt_every=1, log_every=1,
                                  **TRAIN_ARGS)
    out = capsys.readouterr().out
    assert "resumed from step 0" in out
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    r = subprocess.run(
        [sys.executable, "-c", "import json, sys; "
         "from repro.launch import train; "
         "print(json.dumps(train.main(sys.argv[1:])))", *argv,
         "--ckpt-dir", str(tmp_path / "ref")],
        capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    want = json.loads(r.stdout.splitlines()[-1])

    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert abs(a - b) < LOSS_TOL, (got, want)
    norm, rnorm = _gnorms(out)[0], _gnorms(r.stdout)[0]
    assert abs(norm - rnorm) <= NORM_RTOL * rnorm, (norm, rnorm)

    # the first step from the same weights: moments and parameters
    port, _ = CheckpointManager(tmp_path / "port").restore(tree, step=1)
    ref, _ = RCheckpointManager(tmp_path / "ref").restore(
        {"params": rparams, "opt": r_opt.adamw_init(rparams)}, step=1)
    ref = jax.tree.map(np.asarray, ref)
    rp = convert.params_from_numpy(cfg, ref["params"])
    ro = convert.opt_state_from_numpy(cfg, ref["opt"])
    lr = float(opt.schedule(opt.AdamWConfig(lr=TRAIN_ARGS["lr"],
                                            total_steps=2, warmup_steps=5),
                            torch.tensor(1)))
    off = sq = 0.0
    for k, p0 in start.items():
        p = port["params"][k]
        np.testing.assert_allclose(p.numpy(), rp[k].numpy(), atol=2.5 * lr,
                                   rtol=0, err_msg=k)
        assert _leaf_err(port["opt"]["m"][k], ro["m"][k]) <= GRAD_TOL, k
        assert _leaf_err(port["opt"]["v"][k], ro["v"][k]) <= 2 * GRAD_TOL, k
        off += float((p - rp[k]).double().square().sum())
        sq += float((rp[k] - p0).double().square().sum())
    assert math.sqrt(off / sq) <= UPDATE_RTOL, math.sqrt(off / sq)


def _printed(script: str, *args: str) -> list[tuple[float, int]]:
    """The numbers a script prints, each with its printed decimals."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(ROOT / script), *args],
                       capture_output=True, text=True, env=env,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return [(float(m), len(m.partition(".")[2]))
            for m in re.findall(r"-?\d+(?:\.\d+)?", r.stdout)]


def test_coflow_schedule_prints_the_references_numbers():
    got = _printed("examples_torch/coflow_schedule.py", "--device", "cpu")
    want = _printed("examples/coflow_schedule.py")
    assert len(got) == len(want) > 10
    for (a, places), (b, _) in zip(got, want):
        assert abs(a - b) <= 10.0 ** -places, (got, want)


@pytest.mark.parametrize("name", EXAMPLES)
def test_main_without_a_card_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device runs")
    with pytest.raises(RuntimeError, match="is_available"):
        example(name).main([])


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_only_the_port_numpy_and_the_stdlib(name):
    path = ROOT / "examples_torch" / f"{name}.py"
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            tops = [(node.module or "").split(".")[0]]
        else:
            continue
        for top in tops:
            assert top in ("repro_torch", "numpy") or \
                top in sys.stdlib_module_names, (name, top)
