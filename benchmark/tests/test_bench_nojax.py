"""The check that no JAX was loaded: whole top-level names, so the port
(`metamorph_tpu_torch`) is not taken for the JAX package
(`metamorph_tpu`); and a run's imports load neither."""

import subprocess
import sys

from benchmark import runtime
from benchmark.tests.conftest import ROOT


def test_whole_top_level_names(monkeypatch):
    mods = dict(sys.modules)
    for name in ("metamorph_tpu_torch", "metamorph_tpu_torch.models",
                 "jaxtyping", "jax_like", "flaxen"):
        mods.setdefault(name, sys)
    monkeypatch.setattr(sys, "modules", mods)
    assert runtime.forbidden_modules() == []
    for name, top in (("metamorph_tpu.config", "metamorph_tpu"),
                      ("jax.numpy", "jax"), ("jaxlib", "jaxlib"),
                      ("flax.linen", "flax")):
        monkeypatch.setitem(sys.modules, name, sys)
        assert top in runtime.forbidden_modules()
        monkeypatch.delitem(sys.modules, name)


def test_a_run_imports_no_jax():
    code = (
        "import sys\n"
        "import benchmark.run, benchmark.calibrate\n"
        "from benchmark import spec\n"
        "for n in ('serve_open_loop', 'train_steps'):\n"
        "    spec.driver(n)\n"
        "import benchmark.reference.train, benchmark.reference.serve\n"
        "import metamorph_tpu_torch.inference.serve\n"
        "import metamorph_tpu_torch.train.train_step\n"
        "import metamorph_tpu_torch.train.data\n"
        "import metamorph_tpu_torch.models.metamorph\n"
        "from benchmark.runtime import forbidden_modules\n"
        "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_references_import_nothing_of_the_program():
    code = (
        "import sys\n"
        "import benchmark.reference.train, benchmark.reference.serve\n"
        "import benchmark.reference.decoder, benchmark.reference.vision\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0].startswith('metamorph')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_tree_of_the_benchmark_alone_fails_without_a_result(tmp_path):
    import shutil

    shutil.copytree(ROOT + "/benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT + "/BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "nemo12b-chat",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
