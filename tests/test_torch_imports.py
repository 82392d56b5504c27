"""PyTorch port: the package and chip_smoke.py import nothing of JAX or of
the JAX package, and chip_smoke.py refuses to run without a card.

Each check runs in a fresh interpreter whose `sys.meta_path` starts with a
finder that raises on `jax`, `jaxlib` and `incubator_mxnet_tpu` (but not
`incubator_mxnet_tpu_torch`), so an import anywhere in the chain fails the
subprocess.
"""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKER = r"""
import importlib.abc, sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "incubator_mxnet_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, _Block())
"""

_IMPORT_ALL = _BLOCKER + r"""
import pkgutil
import incubator_mxnet_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    __import__(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "incubator_mxnet_tpu"))
assert not bad, bad
print("MODULES", " ".join(names))
print("IMPORTED", len(names))
"""

_IMPORT_SMOKE = _BLOCKER + r"""
import importlib.util
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
assert callable(mod.main)
print("SMOKE_IMPORTED")
"""


def _run(code, args=()):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *args, "-c", code] if code
                          else [sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_modules_import_without_jax():
    r = _run(_IMPORT_ALL)
    assert r.returncode == 0, r.stderr
    n = int(r.stdout.split("IMPORTED")[1])
    assert n >= 10      # base, device, ops.{fused,kernels}, serve.{...}
    names = set(r.stdout.split("MODULES")[1].split("IMPORTED")[0].split())
    pkg = "incubator_mxnet_tpu_torch"
    assert {f"{pkg}.autograd", f"{pkg}.lr_scheduler",
            f"{pkg}.gluon.parameter", f"{pkg}.gluon.trainer",
            f"{pkg}.ops.contrib", f"{pkg}.gluon.model_zoo.detection",
            f"{pkg}.gluon.model_zoo.vision",
            f"{pkg}.gluon.contrib.fused", f"{pkg}.ndarray", f"{pkg}.numpy",
            f"{pkg}.numpy.linalg", f"{pkg}.numpy.random",
            f"{pkg}.numpy_extension", f"{pkg}.ops.registry",
            f"{pkg}.context", f"{pkg}.engine", f"{pkg}.recordio",
            f"{pkg}.native", f"{pkg}.io", f"{pkg}.io.device_feed",
            f"{pkg}.io.imagerec_pool", f"{pkg}.gluon.data",
            f"{pkg}.gluon.data.dataloader",
            f"{pkg}.gluon.data.vision.transforms", f"{pkg}.deploy",
            f"{pkg}.serve.batcher", f"{pkg}.serve.metrics",
            f"{pkg}.serve.replica", f"{pkg}.serve.fleet",
            f"{pkg}.tune", f"{pkg}.tune.space", f"{pkg}.tune.profile",
            f"{pkg}.tune.search", f"{pkg}.tune.measure",
            f"{pkg}.sanitize"} <= names


def test_chip_smoke_imports_without_jax():
    r = _run(_IMPORT_SMOKE)
    assert r.returncode == 0, r.stderr
    assert "SMOKE_IMPORTED" in r.stdout


def test_chip_smoke_without_a_card_fails_and_prints_no_result():
    r = _run(None, args=("chip_smoke.py",))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"kernels"' not in r.stdout
    assert "cuda" in r.stderr.lower()


_STANDALONE = r"""
import importlib.abc, importlib.util, sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("torch", "jax", "jaxlib",
                                  "incubator_mxnet_tpu",
                                  "incubator_mxnet_tpu_torch"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, _Block())
root = "incubator_mxnet_tpu_torch/"
for name, path in (("common", root + "io/_imagerec_common.py"),
                   ("worker", root + "io/_shm_worker.py"),
                   ("native", root + "native/__init__.py")):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
assert "torch" not in sys.modules
print("STANDALONE_OK")
"""


def test_decode_worker_modules_load_without_torch():
    """The shm decode worker runs as a bare subprocess: it, the augment
    spec and the native loaders it loads by path import no torch (nor
    anything of either package), so a worker never starts a CUDA
    runtime."""
    r = _run(_STANDALONE)
    assert r.returncode == 0, r.stderr
    assert "STANDALONE_OK" in r.stdout


_IMPORT_RESILIENCE = _BLOCKER + r"""
import importlib.util
import incubator_mxnet_tpu_torch.fault
import incubator_mxnet_tpu_torch.checkpoint
import incubator_mxnet_tpu_torch.models.transformer
spec = importlib.util.spec_from_file_location("torch_crashtest",
                                              "tools/torch_crashtest.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
mod._lm_config(mod.main.__globals__["argparse"].Namespace(
    lm_vocab=8, lm_layers=1, lm_d=4, lm_heads=2, lm_ff=8, lm_seq=4,
    lm_dtype="float32"))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "incubator_mxnet_tpu"))
assert not bad, bad
print("RESILIENCE_IMPORTED")
"""


def test_resilience_modules_and_the_crash_tool_import_without_jax():
    r = _run(_IMPORT_RESILIENCE)
    assert r.returncode == 0, r.stderr
    assert "RESILIENCE_IMPORTED" in r.stdout


_REPLICA_MAIN = _BLOCKER + r"""
import runpy, sys
sys.argv = ["serve.replica", "--help"]
try:
    runpy.run_module("incubator_mxnet_tpu_torch.serve.replica",
                     run_name="__main__", alter_sys=True)
except SystemExit as e:
    assert e.code == 0, e.code
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "incubator_mxnet_tpu"))
assert not bad, bad
assert "incubator_mxnet_tpu_torch.serve.fleet" in sys.modules
print("REPLICA_MAIN_OK")
"""


def test_replica_entry_point_runs_without_jax():
    """`python -m incubator_mxnet_tpu_torch.serve.replica`, the process a
    serve.Fleet spawns, runs its entry point importing no jax and nothing
    of the JAX package."""
    r = _run(_REPLICA_MAIN)
    assert r.returncode == 0, r.stderr
    assert "REPLICA_MAIN_OK" in r.stdout


_TUNE_ENTRY_POINTS = _BLOCKER + r"""
import importlib.util, runpy, sys
spec = importlib.util.spec_from_file_location("torch_mxtune",
                                              "tools/torch_mxtune.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
assert mod.main(["--phases", "dispatch,serve_decode", "--budget", "2",
                 "--dry-run"]) == 0
sys.argv = ["mx.tune.measure", "--help"]
try:
    runpy.run_module("incubator_mxnet_tpu_torch.tune.measure",
                     run_name="__main__", alter_sys=True)
except SystemExit as e:
    assert e.code == 0, e.code
import incubator_mxnet_tpu_torch as mx
assert mx.tune.HAND_TUNED and mx.sanitize.modes() == frozenset()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "incubator_mxnet_tpu"))
assert not bad, bad
print("TUNE_ENTRY_POINTS_OK")
"""


def test_tune_cli_and_trial_child_run_without_jax():
    """`tools/torch_mxtune.py` and the trial child `python -m
    incubator_mxnet_tpu_torch.tune.measure` import nothing of JAX or of
    the JAX package, nor do `mx.tune` and `mx.sanitize` loaded lazily."""
    r = _run(_TUNE_ENTRY_POINTS)
    assert r.returncode == 0, r.stderr
    assert "TUNE_ENTRY_POINTS_OK" in r.stdout
    assert "phase dispatch: 2 trials" in r.stdout


_LAZY_TUNE = r"""
import sys
import incubator_mxnet_tpu_torch
from incubator_mxnet_tpu_torch.telemetry import REGISTRY
assert "incubator_mxnet_tpu_torch.tune" not in sys.modules
assert not any(n.startswith("tune.") for n in REGISTRY.names())
print("LAZY_OK")
"""


def test_importing_the_port_does_not_register_the_tune_counters():
    """`mx.tune` loads at first use, as the JAX package's does, so its
    counter family registers at the same moment in both packages."""
    r = _run(_LAZY_TUNE)
    assert r.returncode == 0, r.stderr
    assert "LAZY_OK" in r.stdout
