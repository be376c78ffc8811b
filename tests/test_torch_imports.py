"""The port stands alone: importing every module of ``perceiver_io_tpu_torch``
and ``chip_smoke.py`` loads neither JAX, Flax, HF ``datasets`` nor the JAX
package; and ``chip_smoke.py`` refuses to run (non-zero exit, no result
line) without a CUDA device."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, importlib.util, pkgutil, sys
import perceiver_io_tpu_torch
names = [m.name for m in pkgutil.walk_packages(perceiver_io_tpu_torch.__path__, "perceiver_io_tpu_torch.")
         if not m.name.endswith("layernorm_triton")]  # imports triton, which only the card's machine has
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
# HF datasets is imported where a dataset loads, never at import: the card's machine has none
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "datasets") or m.split(".")[0] == "perceiver_io_tpu")
print(len(names), bad)
print(" ".join(names))
"""


def _python(args, cwd, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_port_imports_no_jax_and_no_jax_package():
    proc = _python(["-c", _IMPORT_ALL], ROOT)
    assert proc.returncode == 0, proc.stderr
    counts, names = proc.stdout.splitlines()
    n_modules, bad = counts.split(maxsplit=1)
    assert int(n_modules) >= 50  # the serving, training, image classifier, trainer and admission slices' modules
    assert bad.strip() == "[]"
    for name in ("parallel.dist", "obs.events", "obs.trace", "obs.mfu", "obs.recompile", "utils.flops",
                 "data.loader", "data.text.tokenizer", "data.text.collators", "data.text.datamodule",
                 "training.metrics", "training.faults", "training.checkpoint", "training.trainer",
                 # the admission tier (ROADMAP A6)
                 "obs.metrics", "obs.loadgen", "serving.breaker", "serving.faultinject", "serving.frontend",
                 "serving.engine",
                 # prefix sharing, eviction and journal recovery (ROADMAP A7 + A8)
                 "serving.prefix", "serving.journal",
                 # the telemetry (ROADMAP A11.2 + A11.3)
                 "obs.probes", "obs.slo", "obs.flightrec", "obs.server", "obs.profiler", "utils.profiling",
                 # the Perceiver IO task models (ROADMAP A13, part 1)
                 "models.base", "models.text.common", "models.text.mlm", "models.text.classifier",
                 "models.vision.optical_flow", "models.timeseries", "hf.mask_filler", "data.vision.optical_flow",
                 "data.vision.preprocessor", "data.timeseries",
                 # the symbolic audio model, the inference tier, MNIST and the CLI (ROADMAP A13, part 2)
                 "models.audio", "models.audio.symbolic", "data.audio.midi", "data.audio.symbolic",
                 "data.vision.mnist", "hf", "hf.auto", "hf.convert", "hf.lightning_ckpt", "hf.pipelines",
                 "scripts", "scripts.cli", "scripts.audio.symbolic", "scripts.audio.preproc",
                 "scripts.vision.image_classifier", "scripts.timeseries",
                 # text data on HF datasets and streaming C4, the text CLIs, the fleet router, the
                 # simulator and the scaling-law fit (ROADMAP A13, part 3)
                 "data.text.preprocessor", "data.text.streaming", "data.text.c4", "scripts.text",
                 "scripts.text.common", "scripts.text.clm", "scripts.text.mlm", "scripts.text.classifier",
                 "scripts.text.preproc", "serving.router", "serving.sim", "utils.laws",
                 # training across processes (ROADMAP A12, part 1)
                 "ops.online_softmax", "parallel.mesh", "parallel.ring_attention", "parallel.long_context"):
        assert "perceiver_io_tpu_torch." + name in names.split(), name


def _no_cuda_env():
    return dict(os.environ, CUDA_VISIBLE_DEVICES="")


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_a_card(tmp_path, where):
    cwd = ROOT
    if where == "alone":  # a directory that holds chip_smoke.py and nothing else of the repo
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    proc = _python(["chip_smoke.py"], cwd, env=_no_cuda_env())
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
