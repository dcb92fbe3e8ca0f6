"""The command: without a card it fails and prints no result, and
nothing it loads is JAX or the JAX package."""
import json
import subprocess
import sys

from portbench import harness

# imports the command's whole module graph (the harness, every driver,
# metric and builder, the reference, the program), then runs the
# command; prints the forbidden modules it found and the exit code
PROBE = r"""
import json, pathlib, sys
sys.argv = ["run.py"] + sys.argv[1:]
root = pathlib.Path.cwd()
sys.path[:0] = [str(root / "src"), str(root)]
import runpy
mod = runpy.run_path("portbench/run.py", run_name="portbench_run")
from portbench import harness
harness.program()
import portbench.reference.model
for sub in ("drivers", "metrics", "topologies"):
    for f in sorted((root / "portbench" / sub).glob("*.py")):
        harness.load_file(f)
rc = mod["main"](sys.argv[1:])
print(json.dumps({"rc": rc, "bad": harness.forbidden_modules()}))
"""


def test_no_card_fails_and_nothing_loads_jax():
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(
        [sys.executable, "-c", PROBE, "--workload", "ft16-plan-energy",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=240,
        env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"rc": 3, "bad": []}
    assert "no CUDA card" in proc.stderr


def test_forbidden_modules_compare_whole_top_level_names():
    mods = {"repro_torch": 1, "repro_torch.core": 1, "reprox": 1,
            "jaxtyping": 1}
    assert harness.forbidden_modules(mods) == []
    for bad in ("repro", "repro.core.solver", "jax", "jax.numpy",
                "jaxlib.xla", "flax.linen"):
        assert harness.forbidden_modules(dict(mods, **{bad: 1})) == [bad]
