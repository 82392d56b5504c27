"""PyTorch port: mx.tune (the knob catalog, deployment profiles, the sweep)
held against the JAX package's `tune`.

Contracts under test (the JAX package's `tests/test_tune.py`, on the
port, plus the cross-package ones):
  * the catalog literals (`KNOBS` help aside, `NON_TUNABLE_ENV`,
    `HAND_TUNED`) are the JAX package's, the knob names are the
    `docs/TUNING.md` "Knob catalog" table's in both directions, and every
    `MXNET_*` read in a port module some knob's `wire` names is a declared
    knob env or exempt;
  * fingerprints agree across the packages (model metas; the CPU's
    hardware fingerprint under JAX_PLATFORMS=cpu), and a profile written
    by either package is byte-equal to the other's and activates in it;
  * profiles fall back loudly on a mismatch, a disable, a stale knob or a
    corrupt file, and the MXNET_TUNE_PROFILE autoload does not deadlock;
  * explicit > profile > env > default at each of the seven knob sites;
  * a cold replica boots tuned (in this process and in a fresh one);
  * sweeps visit the JAX package's trials in its order with its scores
    and winners, contain a `tune.trial` fault, and run real scrubbed
    subprocess trials on the CPU (one measured, one killed at its
    timeout); `tools/torch_mxtune.py` runs;
  * the port's fleet flags divergent profile hashes and its EDF gate
    grants the tightest deadline first.

Every test runs inside `process_state_kept()` (a leaked profile would beat
the env at every later knob site on the worker) and
`crash_hooks_restored()` (an engine's start arms the OOM excepthook),
with MXNET_TUNE_* and MXNET_SANITIZE put back and the fault registries of
both packages cleared.
"""
import ast
import contextlib
import io
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import tune as jtune
from incubator_mxnet_tpu.tune import profile as jprofile
from incubator_mxnet_tpu_torch import fault as tfault
from incubator_mxnet_tpu_torch import tune
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.serve import fleet as fleet_mod
from incubator_mxnet_tpu_torch.serve import replica as replica_mod
from incubator_mxnet_tpu_torch.tune import profile as profile_mod

from torch_port_utils import (crash_hooks_restored, port_faults_cleared,
                              process_state_kept)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "incubator_mxnet_tpu_torch")
TINY = dict(vocab=32, embed=16, layers=1, heads=2, head_dim=8, max_len=32)


@contextlib.contextmanager
def _tune_env_restored():
    """MXNET_TUNE_* and MXNET_SANITIZE unset inside, put back on exit."""
    names = [k for k in os.environ
             if k.startswith("MXNET_TUNE_") or k == "MXNET_SANITIZE"]
    saved = {k: os.environ.pop(k) for k in names}
    try:
        yield
    finally:
        for k in [k for k in os.environ
                  if k.startswith("MXNET_TUNE_") or k == "MXNET_SANITIZE"]:
            os.environ.pop(k)
        os.environ.update(saved)


@pytest.fixture(autouse=True)
def _clean_state():
    with process_state_kept(), crash_hooks_restored(), \
            port_faults_cleared(), _tune_env_restored():
        tune.deactivate()
        jtune.deactivate()
        yield
        tune.deactivate()
        jtune.deactivate()


def _tiny_profile(knobs, model_fp="m" * 12, hw_fp=None):
    return tune.DeploymentProfile(
        knobs, model_fp,
        hw_fp if hw_fp is not None else tune.hardware_fingerprint()["fp"])


def _no_help(knobs):
    return {n: {k: v for k, v in spec.items() if k != "help"}
            for n, spec in knobs.items()}


# ---------------------------------------------------------------------------
# the catalog: the JAX package's literals, typed and closed
# ---------------------------------------------------------------------------
def test_catalog_is_typed_and_closed():
    cat = tune.catalog()
    assert len(cat) >= 10
    for name, k in cat.items():
        assert k.kind in ("categorical", "int", "pow2", "bool")
        assert any(k.default == c for c in k.choices)
        if k.kind == "pow2":
            for c in k.choices:
                if c is not None:
                    assert c > 0 and (c & (c - 1)) == 0
    assert set(tune.HAND_TUNED) <= set(tune.phases())
    with pytest.raises(MXNetError):
        tune.knob("serve.nope")
    with pytest.raises(MXNetError):
        tune.validate_assignment({"serve.decode_steps": 3})
    with pytest.raises(MXNetError):
        tune.validate_assignment({"made.up": 1})
    assert tune.validate_assignment({"serve.decode_steps": 8}) == \
        {"serve.decode_steps": 8}


def test_catalog_literals_are_the_jax_packages():
    assert _no_help(tune.KNOBS) == _no_help(jtune.KNOBS)
    assert tune.NON_TUNABLE_ENV == jtune.NON_TUNABLE_ENV
    assert tune.HAND_TUNED == jtune.HAND_TUNED
    assert tune.phases() == jtune.phases()
    assert tune.knob_env_vars() == jtune.knob_env_vars()
    assert tune.default_assignment() == jtune.default_assignment()
    for name, k in tune.catalog().items():
        assert k.to_row() | {"help": None} == \
            jtune.knob(name).to_row() | {"help": None}, name
    assert sorted(tune.__all__) == sorted(jtune.__all__)


def _tuning_md_knobs():
    """Knob names of the "Knob catalog" table of docs/TUNING.md."""
    rows, inside = [], False
    with open(os.path.join(REPO, "docs", "TUNING.md")) as f:
        for line in f:
            if line.startswith("## "):
                inside = line.strip() == "## Knob catalog"
                continue
            if inside and line.startswith("| `"):
                rows.append(line.split("`")[1])
    return set(rows)


def test_knob_names_are_the_tuning_md_table_both_ways():
    assert set(tune.KNOBS) == _tuning_md_knobs()


def _env_reads(path):
    """MXNET_* names read in one module: `get_env` / `getenv` /
    `_register_env` / `environ.get` calls and `environ[...]` subscripts
    with a literal name (the JAX package's registry-consistency rule)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        name = None
        if isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant):
            fn = node.func
            last = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", "")
            full = ast.unparse(fn)
            if last in ("get_env", "getenv", "_register_env") \
                    or full.endswith("environ.get"):
                name = node.args[0].value
        elif isinstance(node, ast.Subscript) and isinstance(
                node.value, ast.Attribute) and node.value.attr == "environ" \
                and isinstance(node.slice, ast.Constant):
            name = node.slice.value
        if isinstance(name, str) and name.startswith("MXNET_"):
            out.add(name)
    return out


def test_wired_port_modules_read_only_declared_env():
    wires = sorted({k["wire"] for k in tune.KNOBS.values() if k["wire"]})
    declared = set(tune.knob_env_vars()) | tune.NON_TUNABLE_ENV
    for wire in wires:
        path = os.path.join(PKG, wire)
        assert os.path.exists(path), wire
        undeclared = _env_reads(path) - declared
        assert not undeclared, (wire, sorted(undeclared))


def test_tune_trial_is_a_registered_fault_point():
    assert "tune.trial" in tfault.POINTS


def test_scrubbed_env_removes_knob_surface_only():
    base = {"MXNET_SERVE_DECODE_STEPS": "8", "MXNET_IO_WORKERS": "4",
            "MXNET_ENGINE_BULK_SIZE": "512", "MXNET_TUNE_PROFILE": "/p",
            "CUDA_VISIBLE_DEVICES": "0", "MXNET_FAULT_SPEC": "p:1:error",
            "MXNET_COMPILE_CACHE_DIR": "/cc", "PATH": "/bin"}
    env = tune.scrubbed_env(base=base)
    for var in tune.knob_env_vars():
        assert var not in env
    assert "MXNET_TUNE_PROFILE" not in env
    assert env["CUDA_VISIBLE_DEVICES"] == "0"
    assert env["MXNET_FAULT_SPEC"] == "p:1:error"
    assert env["MXNET_COMPILE_CACHE_DIR"] == "/cc"
    assert env["PATH"] == "/bin"
    env2 = tune.scrubbed_env(
        overrides={"MXNET_IO_WORKERS": 2, "PATH": None}, base=base)
    assert env2["MXNET_IO_WORKERS"] == "2"
    assert "PATH" not in env2
    assert env == jtune.scrubbed_env(base=base)


# ---------------------------------------------------------------------------
# fingerprints and profile files across the packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("meta", [
    {}, {"vocab": 32}, dict(TINY), dict(TINY, dtype="bfloat16"),
    {"nested": {"b": [1, 2], "a": None}, "name": "resnet50_v1"}],
    ids=["empty", "vocab", "tiny", "bf16", "nested"])
def test_model_fingerprint_equals_the_jax_packages(meta):
    assert tune.model_fingerprint(meta) == jtune.model_fingerprint(meta)


def test_model_fingerprint_of_a_config_object_equals_the_jax_packages():
    from incubator_mxnet_tpu.serve import DecoderConfig as JCfg
    from incubator_mxnet_tpu_torch.serve import DecoderConfig as TCfg
    assert tune.model_fingerprint(TCfg(**TINY)) == \
        jtune.model_fingerprint(JCfg(**TINY))


_JAX_CPU_FP = """
import json
from incubator_mxnet_tpu import tune
print(json.dumps(tune.hardware_fingerprint()))
"""


def test_cpu_hardware_fingerprint_equals_the_jax_packages():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _JAX_CPU_FP], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr
    jhw = json.loads(r.stdout.strip().splitlines()[-1])
    thw = tune.hardware_fingerprint(device="cpu")
    assert thw == jhw
    assert jhw["platform"] == "cpu" and jhw["n_devices"] == 1
    if not torch.cuda.is_available():
        assert tune.hardware_fingerprint() == thw


def _profile_pair(cls_t, cls_j, hw_fp):
    kw = dict(knobs={"serve.decode_steps": 8, "io.workers": 2,
                     "serve.batch_buckets": [8, 16, 32],
                     "train.remat": "dots"},
              model_fp=tune.model_fingerprint(TINY), hw_fp=hw_fp,
              model_meta=dict(TINY),
              hw_meta={"platform": "cpu", "device_kind": "cpu"},
              phases={"serve_decode": {"baseline_score": 1.5,
                                       "best_score": 2.0}},
              meta={"seed": 0, "budget": 4})
    return cls_t(**kw), cls_j(**kw)


def test_profile_files_are_byte_equal_and_cross_both_ways(tmp_path):
    hw = tune.hardware_fingerprint()["fp"]
    tprof, jprof = _profile_pair(tune.DeploymentProfile,
                                 jtune.DeploymentProfile, hw)
    assert tprof.profile_hash == jprof.profile_hash
    tpath = tprof.save(directory=str(tmp_path / "port"))
    jpath = jprof.save(directory=str(tmp_path / "jax"))
    assert os.path.basename(tpath) == os.path.basename(jpath)
    with open(tpath, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    # the JAX package's file activates in the port, and the port's in it
    back = tune.DeploymentProfile.load(jpath)
    assert back.profile_hash == tprof.profile_hash
    assert back.apply(model_fp=tprof.model_fp) is True
    assert tune.resolve("serve.decode_steps") == 8
    assert tune.resolve("serve.batch_buckets") == [8, 16, 32]
    jback = jtune.DeploymentProfile.load(tpath)
    assert jback.apply(model_fp=jprof.model_fp, hw_fp=hw) is True
    assert jtune.resolve("train.remat") == "dots"
    assert tune.lookup(tprof.model_fp, directory=str(tmp_path / "jax")) \
        .profile_hash == jprof.profile_hash


def test_profile_roundtrip_and_hash(tmp_path):
    prof = _tiny_profile({"serve.decode_steps": 8, "io.workers": 2})
    path = prof.save(directory=str(tmp_path))
    assert os.path.basename(path) == \
        f"profile-{prof.model_fp}-{prof.hw_fp}.json"
    back = tune.DeploymentProfile.load(path)
    assert back.knobs == prof.knobs
    assert back.profile_hash == prof.profile_hash
    blob = json.loads(open(path).read())
    blob["schema"] = 99
    with pytest.raises(MXNetError):
        tune.DeploymentProfile.from_dict(blob)


def test_profile_fingerprint_mismatch_falls_back_loudly():
    prof = _tiny_profile({"serve.decode_steps": 8})
    before = tune.tune_stats()
    assert prof.apply(model_fp="x" * 12) is False
    bad_hw = _tiny_profile({"serve.decode_steps": 8}, hw_fp="h" * 12)
    assert bad_hw.apply() is False
    after = tune.tune_stats()
    assert after["profile_mismatch"] == before["profile_mismatch"] + 2
    assert after["profile_applied"] == before["profile_applied"]
    assert tune.active() is None
    assert tune.resolve("serve.decode_steps", 4) == 4


def test_a_card_profile_falls_back_on_the_cpu():
    """A profile swept on a card does not apply on a host whose hardware
    fingerprint differs (here: the CPU's)."""
    card = dict(tune.hardware_fingerprint(device="cpu"), platform="gpu",
                device_kind="NVIDIA H100 80GB HBM3")
    card_fp = profile_mod._canon_hash(
        {"hw": {k: card[k] for k in sorted(card) if k != "fp"}})
    prof = _tiny_profile({"serve.decode_steps": 8}, hw_fp=card_fp)
    before = tune.tune_stats()["profile_mismatch"]
    assert prof.apply(hw_fp=tune.hardware_fingerprint("cpu")["fp"]) \
        is False
    assert tune.tune_stats()["profile_mismatch"] == before + 1
    assert tune.resolve("serve.decode_steps", 4) == 4


def test_profile_disable_kills_the_tier(monkeypatch):
    prof = _tiny_profile({"serve.decode_steps": 8})
    assert prof.apply() is True
    assert tune.resolve("serve.decode_steps") == 8
    monkeypatch.setenv("MXNET_TUNE_DISABLE", "1")
    assert tune.resolve("serve.decode_steps", 4) == 4
    assert tune.active() is None
    assert prof.apply() is False


def test_profile_stale_knob_resolves_to_default():
    prof = _tiny_profile({"serve.decode_steps": 8})
    prof.knobs["serve.decode_steps"] = 7      # post-validation corruption
    assert prof.apply() is True
    assert tune.resolve("serve.decode_steps", 4) == 4


def test_lookup_missing_and_corrupt(tmp_path):
    assert tune.lookup("m" * 12, hw_fp="h" * 12,
                       directory=str(tmp_path)) is None
    prof = _tiny_profile({"io.workers": 2})
    path = prof.save(directory=str(tmp_path))
    with open(path, "w") as f:
        f.write("{not json")
    assert tune.lookup(prof.model_fp, hw_fp=prof.hw_fp,
                       directory=str(tmp_path)) is None


def test_profile_dir_follows_the_jax_packages(monkeypatch, tmp_path):
    monkeypatch.delenv("MXNET_TUNE_PROFILE_DIR", raising=False)
    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", str(tmp_path / "cc"))
    assert tune.profile_dir() == jtune.profile_dir()
    assert tune.profile_dir().endswith("cc-tune-profiles")
    monkeypatch.setenv("MXNET_TUNE_PROFILE_DIR", str(tmp_path / "p"))
    assert tune.profile_dir() == str(tmp_path / "p")


def test_env_autoload_path_does_not_deadlock(tmp_path, monkeypatch):
    prof = _tiny_profile({"serve.decode_steps": 8})
    path = prof.save(directory=str(tmp_path))
    monkeypatch.setenv("MXNET_TUNE_PROFILE", path)
    monkeypatch.setattr(profile_mod, "_AUTOLOADED", [False])
    got = []
    t = threading.Thread(
        target=lambda: got.append(tune.resolve("serve.decode_steps", 4)),
        daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "env-autoload resolve() deadlocked"
    assert got == [8]
    assert tune.active() is not None


def test_env_autoload_of_a_corrupt_file_boots_on_defaults(tmp_path,
                                                          monkeypatch):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    monkeypatch.setenv("MXNET_TUNE_PROFILE", str(bad))
    monkeypatch.setattr(profile_mod, "_AUTOLOADED", [False])
    assert tune.resolve("serve.decode_steps", 4) == 4
    assert tune.active() is None


# ---------------------------------------------------------------------------
# explicit > profile > env > default at each of the seven knob sites
# ---------------------------------------------------------------------------
def _tiny_engine(**kw):
    from incubator_mxnet_tpu_torch.serve import (CachedDecoder,
                                                 ContinuousEngine,
                                                 DecoderConfig)
    return ContinuousEngine(
        CachedDecoder(DecoderConfig(**TINY), seed=0, device="cpu"), **kw)


def _site_continuous(monkeypatch, tmp_path):
    prof = _tiny_profile({"serve.decode_steps": 8, "serve.prefill_lanes": 2,
                          "serve.max_slots": 4, "serve.draft_tokens": 2,
                          "serve.kv_dtype": "int8",
                          "serve.prefix_block": 8,
                          "serve.prefix_cache_slots": 2,
                          "serve.prefix_cache_insert": False})
    assert prof.apply() is True
    monkeypatch.setenv("MXNET_SERVE_DECODE_STEPS", "6")
    monkeypatch.setenv("MXNET_SERVE_MAX_SLOTS", "16")
    monkeypatch.setenv("MXNET_SERVE_PREFIX_BLOCK", "32")
    eng = _tiny_engine()
    assert (eng.decode_steps, eng.prefill_lanes, eng.max_slots,
            eng.draft_tokens, eng.kv_dtype, eng.prefix_block,
            eng.prefix_cache_slots, eng.prefix_cache_insert) == \
        (8, 2, 4, 2, "int8", 8, 2, False)
    eng = _tiny_engine(decode_steps=2, max_slots=8, prefix_block=4)
    assert (eng.decode_steps, eng.max_slots, eng.prefix_block) == (2, 8, 4)
    tune.deactivate()
    eng = _tiny_engine()
    assert (eng.decode_steps, eng.max_slots, eng.prefix_block,
            eng.kv_dtype) == (6, 16, 32, None)
    for var in ("MXNET_SERVE_DECODE_STEPS", "MXNET_SERVE_MAX_SLOTS",
                "MXNET_SERVE_PREFIX_BLOCK"):
        monkeypatch.delenv(var)
    eng = _tiny_engine()
    assert (eng.decode_steps, eng.max_slots, eng.prefix_block) == (4, 8, 16)


def _site_batcher(monkeypatch, tmp_path):
    from incubator_mxnet_tpu_torch.serve import CallableModel
    spec = [((4,), "float32")]
    assert _tiny_profile({"serve.batch_buckets": [2, 8, 32]}).apply()
    assert CallableModel(torch.tanh, None, spec,
                         device="cpu").batch_sizes == [2, 8, 32]
    assert CallableModel(torch.tanh, [1, 4], spec,
                         device="cpu").batch_sizes == [1, 4]
    tune.deactivate()
    assert CallableModel(torch.tanh, None, spec,
                         device="cpu").batch_sizes == [1, 2, 4, 8, 16, 32]


def _site_replica(monkeypatch, tmp_path):
    meta = dict(TINY)
    fp = tune.model_fingerprint(meta)
    hw = tune.hardware_fingerprint()["fp"]
    looked = tune.DeploymentProfile({"serve.decode_steps": 2}, fp, hw)
    looked.save(directory=str(tmp_path / "dir"))
    by_env = tune.DeploymentProfile({"serve.decode_steps": 6}, fp, hw)
    env_path = by_env.save(directory=str(tmp_path / "env"))
    by_spec = tune.DeploymentProfile({"serve.decode_steps": 8}, fp, hw)
    spec_path = by_spec.save(directory=str(tmp_path / "spec"))
    monkeypatch.setenv("MXNET_TUNE_PROFILE_DIR", str(tmp_path / "dir"))
    monkeypatch.setenv("MXNET_TUNE_PROFILE", env_path)
    assert replica_mod._resolve_profile(
        {"config": meta, "profile": spec_path}) == by_spec.profile_hash
    assert tune.resolve("serve.decode_steps") == 8
    tune.deactivate()
    assert replica_mod._resolve_profile({"config": meta}) == \
        by_env.profile_hash
    tune.deactivate()
    monkeypatch.delenv("MXNET_TUNE_PROFILE")
    assert replica_mod._resolve_profile({"config": meta}) == \
        looked.profile_hash
    assert tune.resolve("serve.decode_steps") == 2
    tune.deactivate()
    # another model's profile: a loud fallback, the replica boots anyway
    assert replica_mod._resolve_profile(
        {"config": meta, "profile": tune.DeploymentProfile(
            {"serve.decode_steps": 8}, "x" * 12, hw).save(
                directory=str(tmp_path / "other"))}) is None
    assert tune.active() is None


def _site_engine(monkeypatch, tmp_path):
    from incubator_mxnet_tpu_torch import engine
    assert _tiny_profile({"dispatch.bulk_size": 512}).apply()
    monkeypatch.setenv("MXNET_ENGINE_BULK_SIZE", "2048")
    prev = engine.set_bulk_size(8192)
    try:
        assert engine.current_bulk_size() == 8192
    finally:
        engine.set_bulk_size(prev)
        engine._bulk_size[0] = None
    assert engine.current_bulk_size() == 512
    tune.deactivate()
    assert engine.current_bulk_size() == 2048
    monkeypatch.delenv("MXNET_ENGINE_BULK_SIZE")
    assert engine.current_bulk_size() == 4096


def _tiny_rec(path):
    from PIL import Image
    from incubator_mxnet_tpu_torch import recordio
    w = recordio.MXRecordIO(str(path), "w")
    for i in range(2):
        buf = io.BytesIO()
        Image.fromarray(np.full((8, 8, 3), 40 * i, np.uint8)).save(
            buf, format="JPEG")
        w.write(recordio.pack(recordio.IRHeader(0, float(i), i, 0),
                              buf.getvalue()))
    w.close()
    return str(path)


def _site_io(monkeypatch, tmp_path):
    from incubator_mxnet_tpu_torch import io as tio
    # the resolution is the constructor's; no decode pool is started
    monkeypatch.setattr(tio.ImageRecordIter, "_make_pool", lambda self: None)
    rec = _tiny_rec(tmp_path / "t.rec")

    def it(**kw):
        return tio.ImageRecordIter(rec, (8, 8, 3), 2, device="cpu", **kw)
    assert _tiny_profile({"io.workers": 0, "io.lookahead": 4}).apply()
    monkeypatch.setenv("MXNET_IO_WORKERS", "2")
    monkeypatch.setenv("MXNET_IMAGEREC_LOOKAHEAD", "1")
    got = it()
    assert (got._workers, got._ahead) == (0, 4)
    got = it(workers=8, lookahead=2)
    assert (got._workers, got._ahead) == (8, 2)
    tune.deactivate()
    got = it()
    assert (got._workers, got._ahead) == (2, 1)
    monkeypatch.delenv("MXNET_IO_WORKERS")
    monkeypatch.delenv("MXNET_IMAGEREC_LOOKAHEAD")
    got = it()
    assert (got._workers, got._ahead) == (0, 2)


def _site_imagerec_pool(monkeypatch, tmp_path):
    from incubator_mxnet_tpu_torch.io.imagerec_pool import DecodePool

    def resolved(shm_mb):
        """The shm budget `_start_proc_mode` resolves: a ring of two
        384 MiB slots fits none of the choices, and the refusal names the
        budget before any segment or worker exists."""
        pool = object.__new__(DecodePool)
        pool._cap, pool._h, pool._w = 16, 1024, 2048
        pool._itemsize, pool._label_width, pool._out_u8 = 4, 1, False
        pool._n_slots = 3
        with pytest.raises(MXNetError) as e:
            pool._start_proc_mode(1, shm_mb)
        return int(str(e.value).split("MXNET_IO_SHM_MB=")[1].split()[0])
    assert _tiny_profile({"io.shm_mb": 64}).apply()
    monkeypatch.setenv("MXNET_IO_SHM_MB", "128")
    assert resolved(None) == 64
    assert resolved(512) == 512
    tune.deactivate()
    assert resolved(None) == 128
    monkeypatch.delenv("MXNET_IO_SHM_MB")
    assert resolved(None) == 256


def _site_fused(monkeypatch, tmp_path):
    from incubator_mxnet_tpu_torch import gluon
    from incubator_mxnet_tpu_torch.gluon.contrib import FusedTrainStep
    net = gluon.nn.Dense(2, in_units=3)
    net.initialize(device="cpu")

    def step(**kw):
        return FusedTrainStep(net, lambda n, x: n(x).sum(), "sgd", **kw)
    assert _tiny_profile({"train.remat": "full",
                          "train.donate": False}).apply()
    s = step()
    assert (s._remat, s._donate) == ("full", False)
    s = step(remat=None, donate=True)            # None is a real policy
    assert (s._remat, s._donate) == (None, True)
    tune.deactivate()
    s = step()
    assert (s._remat, s._donate) == (None, True)


SITES = {"serve/continuous.py": _site_continuous,
         "serve/batcher.py": _site_batcher,
         "serve/replica.py": _site_replica,
         "engine.py": _site_engine,
         "io/__init__.py": _site_io,
         "io/imagerec_pool.py": _site_imagerec_pool,
         "gluon/contrib/fused.py": _site_fused}


@pytest.mark.parametrize("site", sorted(SITES))
def test_precedence_explicit_over_profile_over_env_over_default(
        site, monkeypatch, tmp_path):
    SITES[site](monkeypatch, tmp_path)


def test_every_wired_module_has_a_precedence_case():
    wires = {k["wire"] for k in tune.KNOBS.values() if k["wire"]}
    assert wires - {"serve/kv_pool.py"} <= set(SITES)


# ---------------------------------------------------------------------------
# the replica boots tuned
# ---------------------------------------------------------------------------
def test_cold_replica_with_profile_boots_tuned(tmp_path, monkeypatch):
    prof = tune.DeploymentProfile(
        {"serve.decode_steps": 8, "serve.prefill_lanes": 2},
        tune.model_fingerprint(dict(TINY)),
        tune.hardware_fingerprint()["fp"])
    prof.save(directory=str(tmp_path))
    monkeypatch.setenv("MXNET_TUNE_PROFILE_DIR", str(tmp_path))
    assert replica_mod._resolve_profile({"config": dict(TINY)}) == \
        prof.profile_hash
    tuned = _tiny_engine()
    tune.deactivate()
    explicit = _tiny_engine(decode_steps=8, prefill_lanes=2)
    assert (tuned.decode_steps, tuned.prefill_lanes, tuned.draft_tokens,
            tuned.max_slots) == \
        (explicit.decode_steps, explicit.prefill_lanes,
         explicit.draft_tokens, explicit.max_slots)


def test_replica_stub_profile_hash_passthrough():
    assert replica_mod._resolve_profile(
        {"stub": True, "profile_hash": "abc123"}) == "abc123"
    assert replica_mod._resolve_profile({"stub": True}) is None


_FRESH_REPLICA = """
import json
from incubator_mxnet_tpu_torch import tune
from incubator_mxnet_tpu_torch.serve import replica
h = replica._resolve_profile({"config": {"vocab": 32}})
print(json.dumps({"hash": h, "steps": tune.resolve("serve.decode_steps", 4),
                  "applied": tune.tune_stats()["profile_applied"]}))
"""


def test_profile_activates_in_a_fresh_process(tmp_path):
    prof = tune.DeploymentProfile(
        {"serve.decode_steps": 8}, tune.model_fingerprint({"vocab": 32}),
        tune.hardware_fingerprint()["fp"])
    prof.save(directory=str(tmp_path))
    env = dict(os.environ, MXNET_TUNE_PROFILE_DIR=str(tmp_path),
               PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _FRESH_REPLICA], env=env,
                         cwd=REPO, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"hash": prof.profile_hash, "steps": 8, "applied": 1}


# ---------------------------------------------------------------------------
# sweeps: the JAX package's schedule, crash-contained
# ---------------------------------------------------------------------------
def _planted_runner(phase, assignment, scale):
    """Deterministic synthetic objective with a planted optimum at
    decode_steps=8 (the hand-tuned baseline is 4)."""
    score = 100.0
    score += 10.0 * (assignment.get("serve.decode_steps") == 8)
    score -= 5.0 * (assignment.get("serve.draft_tokens") or 0)
    score += 1.0 * (assignment.get("dispatch.bulk_size") == 8192)
    return {"ok": True, "score": score, "unit": "tok/s"}


def _sig(res):
    return {p: [(t["knobs"], t["score"], t["ok"], t["unit"])
                for t in d["trials"]]
            for p, d in res["phases"].items()}


@pytest.mark.parametrize("budget", [3, 12, 40])
def test_sweep_visits_the_jax_packages_trials(budget):
    phases = ["dispatch", "serve_decode"]
    a = tune.sweep(phases=phases, budget=budget, runner=_planted_runner)
    b = jtune.sweep(phases=phases, budget=budget, runner=_planted_runner)
    assert _sig(a) == _sig(b)
    assert a["knobs"] == b["knobs"]
    for p in phases:
        assert a["phases"][p]["best_knobs"] == b["phases"][p]["best_knobs"]
        assert a["phases"][p]["speedup_vs_hand"] == \
            b["phases"][p]["speedup_vs_hand"]
    assert (a["trials"], a["trials_failed"], a["budget"]) == \
        (b["trials"], b["trials_failed"], b["budget"])


def test_sweep_finds_planted_optimum_and_beats_hand():
    res = tune.sweep(phases=["serve_decode"], budget=12,
                     runner=_planted_runner)
    ph = res["phases"]["serve_decode"]
    assert ph["trials"][0]["knobs"] == tune.plan("serve_decode")[0]
    assert ph["trials"][0]["knobs"]["serve.decode_steps"] == 4
    assert ph["best_knobs"]["serve.decode_steps"] == 8
    assert ph["speedup_vs_hand"] >= 1.0
    assert res["trials_failed"] == 0
    prof = tune.build_profile(res, model_meta={"m": 1})
    assert prof.knobs["serve.decode_steps"] == 8
    assert prof.phases["serve_decode"]["speedup_vs_hand"] >= 1.0
    jprof = jtune.build_profile(res, model_meta={"m": 1},
                                hw_meta=tune.hardware_fingerprint())
    assert prof.to_dict() == jprof.to_dict()


@pytest.mark.parametrize("phase", sorted(tune.HAND_TUNED))
def test_plan_is_the_jax_packages(phase):
    for budget in (None, 1, 2, 5):
        assert tune.plan(phase, budget=budget) == \
            jtune.plan(phase, budget=budget)
    start = {"serve.max_slots": 8, "io.workers": 2}
    assert tune.plan(phase, start=start) == jtune.plan(phase, start=start)


def test_sweep_contains_crashing_trial():
    before = tune.tune_stats()
    with tfault.scope("tune.trial:2:error"):
        res = tune.sweep(phases=["serve_decode"], budget=6,
                         runner=_planted_runner)
    ph = res["phases"]["serve_decode"]
    assert res["trials_failed"] == 1
    failed = [t for t in ph["trials"] if not t["ok"]]
    assert len(failed) == 1 and failed[0]["error"]
    assert "InjectedFault" in failed[0]["error"]
    assert len(ph["trials"]) >= 3
    assert ph["best"] is not None and ph["best"]["ok"]
    after = tune.tune_stats()
    assert after["trials"] == before["trials"] + len(ph["trials"])
    assert after["trials_failed"] == before["trials_failed"] + 1
    assert after["trial_ms"] > before["trial_ms"]
    assert after["profile_applied"] == before["profile_applied"]


def test_build_profile_refuses_empty_sweep():
    with pytest.raises(MXNetError):
        tune.build_profile({"phases": {}, "knobs": {}})


def test_a_subprocess_trial_measures_on_the_cpu():
    res = tune.sweep(phases=["dispatch"], budget=1, scale="quick",
                     device="cpu")
    trial = res["phases"]["dispatch"]["trials"][0]
    assert trial["ok"], trial["error"]
    assert trial["unit"] == "ops_per_sec" and trial["score"] > 0
    assert trial["knobs"] == tune.HAND_TUNED["dispatch"]
    assert trial["detail"]["device"] == "cpu"
    assert trial["detail"]["launches"] == {}     # no kernel on the CPU
    prof = tune.build_profile(res, model_meta={},
                              hw_meta=tune.hardware_fingerprint("cpu"))
    assert prof.knobs == {"dispatch.bulk_size": 4096}


def test_a_hung_trial_is_killed_and_recorded_as_failed():
    before = tune.tune_stats()["trials_failed"]
    res = tune.sweep(phases=["dispatch"], budget=1, device="cpu",
                     timeout_s=0.2)
    trial = res["phases"]["dispatch"]["trials"][0]
    assert not trial["ok"] and trial["error"].startswith("timeout after")
    assert res["trials_failed"] == 1
    assert tune.tune_stats()["trials_failed"] == before + 1
    with pytest.raises(MXNetError):
        tune.build_profile(res)


def test_measure_phase_in_process_on_the_cpu():
    from incubator_mxnet_tpu_torch.tune import measure
    res = measure.run_phase("serve_decode", {"serve.max_slots": 4},
                            device="cpu")
    assert res["unit"] == "tokens_per_sec" and res["score"] > 0
    assert res["retraces"] == 0 and res["tokens"] > 0
    with pytest.raises(ValueError):
        measure.run_phase("nope", device="cpu")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def _mxtune(*args):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch_mxtune.py"),
         *args], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)


def test_mxtune_dry_run_prints_the_schedule():
    r = _mxtune("--phases", "serve_decode,dispatch", "--budget", "3",
                "--dry-run")
    assert r.returncode == 0, r.stderr
    assert "phase serve_decode: 3 trials" in r.stdout
    assert "hand-tuned baseline" in r.stdout
    first = json.loads(r.stdout.split("[  0] ")[1].split(" hand")[0])
    assert first == tune.plan("serve_decode")[0]


def test_mxtune_sweeps_on_the_cpu():
    r = _mxtune("--device", "cpu", "--phases", "dispatch", "--budget", "1",
                "--scale", "quick", "--json", "-")
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["trials"] == 1 and out["trials_failed"] == 0
    assert out["profile"]["knobs"] == {"dispatch.bulk_size": 4096}
    assert out["profile"]["hw_fp"] == \
        tune.hardware_fingerprint("cpu")["fp"]


# ---------------------------------------------------------------------------
# the fleet: divergence detection, EDF dispatch
# ---------------------------------------------------------------------------
def _stub_fleet(tmp_path, hashes):
    fl = fleet_mod.Fleet({"stub": True}, replicas=len(hashes),
                         workdir=str(tmp_path))
    for h, ph in zip(fl._replicas, hashes):
        h.state = "serving"
        h.hello = {"profile_hash": ph} if ph else {}
    return fl


def test_fleet_profile_divergence_detection(tmp_path):
    before = fleet_mod.fleet_stats()["profile_divergence"]
    assert _stub_fleet(tmp_path / "a",
                       ["p1", "p1", None])._check_profile_divergence() \
        is False
    assert _stub_fleet(tmp_path / "b",
                       ["p1", "p2"])._check_profile_divergence() is True
    assert fleet_mod.fleet_stats()["profile_divergence"] == before + 1


def _req(deadline_at, t_submit):
    r = fleet_mod._FleetRequest(0, [1], 1, deadline_at, None)
    r.t_submit = t_submit
    return r


def test_edf_gate_beats_fifo():
    gate = fleet_mod._EDFGate()
    first = _req(None, t_submit=1.0)
    tight = _req(5.0, t_submit=2.0)
    loose = _req(9.0, t_submit=3.0)
    for r in (first, tight, loose):
        gate.enter(r)
    assert gate.wait_turn(tight, timeout=0.001) is True
    assert gate.wait_turn(first, timeout=0.001) is False
    assert gate.wait_turn(loose, timeout=0.001) is False
    gate.leave(tight)
    assert gate.wait_turn(loose, timeout=0.001) is True
    gate.leave(loose)
    assert gate.wait_turn(first, timeout=0.001) is True
    gate.leave(first)
    assert gate.wait_turn(first, timeout=0.001) is True


def test_edf_gate_orders_concurrent_claims():
    gate = fleet_mod._EDFGate()
    reqs = [_req(float(10 - i), t_submit=float(i)) for i in range(4)]
    for r in reqs:
        gate.enter(r)
    order, lock = [], threading.Lock()

    def claim(r):
        while not gate.wait_turn(r, timeout=0.01):
            pass
        with lock:
            order.append(r.deadline_at)
        gate.leave(r)

    threads = [threading.Thread(target=claim, args=(r,)) for r in reqs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert order == sorted(order)


def test_jax_profile_module_untouched_by_the_port():
    """The two profile tiers are separate process-global states."""
    assert _tiny_profile({"serve.decode_steps": 8}).apply() is True
    assert jprofile._ACTIVE[0] is None
    assert jtune.resolve("serve.decode_steps", 4) == 4
