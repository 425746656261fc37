"""The check against JAX in the process: whole top-level names only."""
import os
import subprocess
import sys

from portbench import manifest, run


def test_refuses_jax_and_the_jax_package():
    assert run.forbidden_modules(["jax"]) == ["jax"]
    assert run.forbidden_modules(["jax._src.core", "os"]) == ["jax"]
    assert run.forbidden_modules(["jaxlib.xla_client"]) == ["jaxlib"]
    assert run.forbidden_modules(["flax.linen"]) == ["flax"]
    assert run.forbidden_modules(
        ["cpu_raytracing_experiments_tpu.render.renderer"]) == [
            "cpu_raytracing_experiments_tpu"]


def test_accepts_the_port():
    assert run.forbidden_modules([
        "cpu_raytracing_experiments_tpu_torch",
        "cpu_raytracing_experiments_tpu_torch.render.renderer",
        "jaxtyping", "jax_free", "portbench.run", "torch"]) == []


def test_a_run_loads_no_jax():
    """A process that imports the harness, the port and the reference, and
    runs a tiny cell, has loaded neither JAX nor the JAX package."""
    code = ("import sys; from portbench import run; "
            "run.run_cell('hero.final-1080p', 3, 0.0, True, device='cpu', "
            "frame=(8, 8), max_updates=1); "
            "print(run.forbidden_modules(sys.modules))")
    env = dict(os.environ, PYTHONPATH=str(manifest.ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_there_is_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "hero.final-1080p", "--seed", "1",
                   "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
