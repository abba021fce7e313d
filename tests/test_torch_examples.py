"""Every walkthrough in sparkucx_tpu_torch/examples/ must run green on the
CPU, as a real subprocess, without loading JAX or the JAX package — the
port's twin of tests/test_examples.py.  Each script checks its own oracle
and prints ``OK`` per checkpoint; its README lists every script, and each
script defaults to the card and refuses to run without one."""

import importlib.util
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES_DIR = ROOT / "sparkucx_tpu_torch" / "examples"
SCRIPTS = sorted(p.name for p in EXAMPLES_DIR.glob("*.py"))

# run the script as ``__main__`` with ``--device cpu``, then report the
# JAX modules it loaded
_RUNNER = (
    "import runpy, sys; sys.argv = [sys.argv[1], '--device', 'cpu']; "
    "runpy.run_path(sys.argv[0], run_name='__main__'); "
    "print('LOADED', sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'sparkucx_tpu')))"
)


def test_examples_dir_has_the_six_walkthroughs():
    jax_scripts = sorted(p.name for p in (ROOT / "examples").glob("*.py"))
    assert SCRIPTS == jax_scripts and len(SCRIPTS) == 6


def test_readme_lists_every_script():
    readme = (EXAMPLES_DIR / "README.md").read_text()
    for script in SCRIPTS:
        assert script in readme, f"sparkucx_tpu_torch/examples/README.md does not mention {script}"


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_runs_on_the_cpu_without_jax(script):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + env.get("PYTHONPATH", "").split(os.pathsep)).rstrip(os.pathsep)
    r = subprocess.run(
        [sys.executable, "-c", _RUNNER, str(EXAMPLES_DIR / script)],
        capture_output=True, text=True, timeout=240, env=env, cwd=str(ROOT),
    )
    assert r.returncode == 0, f"{script} failed:\n{r.stdout}\n{r.stderr}"
    assert "OK" in r.stdout, f"{script} printed no OK checkpoint:\n{r.stdout}"
    assert "LOADED []" in r.stdout, f"{script} loaded JAX:\n{r.stdout}"


def _load(script):
    spec = importlib.util.spec_from_file_location(f"walkthrough_{script[:2]}", EXAMPLES_DIR / script)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_defaults_to_the_card(script, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = _load(script).main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([])
