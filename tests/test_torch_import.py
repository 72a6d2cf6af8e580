"""The port stands alone: importing every module of `repro_torch` pulls in
neither JAX nor any module of the reference package (and starts no
process group: the dry run's fake group lives only in its own process),
and its entry points refuse to run without a card unless the caller
asks for the CPU.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import RMIConfig, compile_lookup, make_keyset  # noqa: E402
from repro_torch.core.rmi import build_rmi  # noqa: E402
from repro_torch.index_service import (  # noqa: E402
    IndexService,
    IndexSnapshot,
    ServiceConfig,
    ShardedIndexService,
    build_snapshot,
)
from repro_torch.kernels import bloom_probe, hash_probe, nvcc, ops  # noqa: E402
from repro_torch.kernels import rmi_lookup, rmi_scan  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import torch.distributed as dist
assert not dist.is_initialized(), "a module started a process group at import"
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "repro"
             or k.startswith("repro."))
print(len(names), bad, *names)
"""


def test_port_imports_no_jax_and_no_reference():
    # a fresh interpreter: the test workers already hold JAX
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        env=env, check=True, timeout=120,
    ).stdout.split()
    assert int(out[0]) >= 20, "walked too few modules"
    assert out[1] == "[]"
    for name in ("repro_torch.index_service.scan", "repro_torch.kernels.rmi_scan",
                 "repro_torch.kernels.nvcc", "repro_torch.index_service.router",
                 "repro_torch.index_service.sharded", "repro_torch.core.bloom",
                 "repro_torch.core.learned_hash", "repro_torch.kernels.hash_probe",
                 "repro_torch.kernels.bloom_probe", "repro_torch.distributed",
                 "repro_torch.distributed.fault_tolerance", "repro_torch.obs.export",
                 "repro_torch.serve.frontend", "repro_torch.models.moe",
                 "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
                 "repro_torch.distributed.sharding", "repro_torch.distributed.collectives"):
        assert name in out[2:], name


_SCRIPT_PROBE = r"""
import sys
sys.argv = [sys.argv[0]]
import {name}
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "repro"
             or k.startswith("repro."))
print(bad)
"""


@pytest.mark.parametrize("script,argv", [
    ("chip_smoke", []), ("scan_pair", ["--parent", "."]), ("lookup_pair", ["--parent", "."]),
    ("attention_pair", ["--parent", "."]), ("bloom_pair", ["--parent", "."]),
])
def test_card_scripts_import_no_jax_and_refuse_without_a_card(script, argv):
    """The scripts run on the card import neither JAX nor the reference
    package, and without a card exit non-zero before printing a
    result."""
    root = SRC.parent
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _SCRIPT_PROBE.format(name=script)],
                         capture_output=True, text=True, env=env, cwd=root, check=True,
                         timeout=120).stdout.split()
    assert out == ["[]"]
    run = subprocess.run([sys.executable, f"{script}.py", *argv], capture_output=True,
                         text=True, env=env, cwd=root, timeout=120)
    assert run.returncode != 0 and '"ok": true' not in run.stdout


def _keys(n=300):
    return np.unique(np.random.default_rng(0).uniform(0.0, 1e6, n))


@pytest.mark.parametrize("entry", [
    "service", "build_snapshot", "build_rmi", "compile_lookup", "load",
])
def test_entry_points_refuse_without_a_card(entry, monkeypatch, tmp_path):
    keys = _keys()
    snap, _ = build_snapshot(keys, device="cpu")
    path = snap.save(str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ks = make_keyset(keys)
    calls = {
        "service": lambda: IndexService(keys),
        "build_snapshot": lambda: build_snapshot(keys),
        "build_rmi": lambda: build_rmi(ks, RMIConfig(num_leaves=8, stage0_hidden=())),
        "compile_lookup": lambda: compile_lookup(snap.index, ks),
        "load": lambda: IndexSnapshot.load(path),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
    # the same entry points run on the host when asked by name
    svc = IndexService(keys, ServiceConfig(strategy="cuda_fused"), device="cpu")
    assert svc.device.type == "cpu"


def test_cpu_tensors_take_the_plain_version_without_building():
    """A wrapper given CPU tensors runs its plain version: no build, no
    launch counted."""
    rmi_lookup.reset_launch_counts()
    rmi_scan.reset_launch_counts()
    svc = IndexService(_keys(), ServiceConfig(strategy="cuda_fused"), device="cpu")
    svc.lookup_batch(_keys()[:50])
    svc.scan_batch(100.0, 9e5, 16)
    snap = svc._mgr.current()
    snap.scan_page_fn("cuda_fused", 16)(
        np.arange(3, dtype=np.int32), np.full(64, np.inf, np.float32),
        np.zeros(64, np.int32), np.full(64, snap.n, np.int32), snap.n)
    assert rmi_lookup.LAUNCHES == {"rmi_lookup_cuda": 0, "rmi_merged_lookup_cuda": 0,
                                   "rmi_sharded_merged_lookup_cuda": 0}
    assert rmi_scan.LAUNCHES == {"rmi_scan_range_cuda": 0, "rmi_scan_page_cuda": 0,
                                 "rmi_sharded_scan_page_cuda": 0}
    assert nvcc._LIBS == {}


def test_cpu_probes_and_the_screen_build_nothing():
    """The §4/§5 probes and a Bloom-screened service on the CPU run the
    plain twins: no build, no launch counted."""
    from repro_torch.core import build_bloom, build_model_hashmap
    hash_probe.reset_launch_counts()
    bloom_probe.reset_launch_counts()
    keys = _keys(2_000)
    hm, idx, ks = build_model_hashmap(keys, keys.size, device="cpu")
    assert ops.hash_probe_op(hm, idx, ks, keys, device="cpu").all()
    ops.bloom_probe_op(build_bloom(keys, fpr=0.01), np.arange(64, dtype=np.uint32),
                       device="cpu")
    svc = IndexService(keys, ServiceConfig(bloom_fpr=0.01), device="cpu")
    assert svc.contains(keys[::3]).all()
    assert svc.stats_summary()["contains"]["bloom_screened"] == 0
    assert hash_probe.LAUNCHES == {"hash_probe_cuda": 0}
    assert bloom_probe.LAUNCHES == {"bloom_probe_cuda": 0}
    assert nvcc._LIBS == {}


def test_cpu_sharded_reads_build_nothing():
    """The sharded service and the snapshot's sharded_fused strategy on
    the CPU run the plain twins: no build, no launch counted."""
    rmi_lookup.reset_launch_counts()
    rmi_scan.reset_launch_counts()
    keys = np.unique(np.random.default_rng(1).uniform(0.0, 1e6, 3000))
    svc = ShardedIndexService(keys, ServiceConfig(num_shards=3, strategy="sharded_fused"),
                              device="cpu")
    svc.insert(keys[:5] + 0.5)
    svc.get(keys[::7])
    svc.contains(keys[::11])
    svc.lookup_batch(keys[::13])
    svc.scan_batch(1e5, 9e5, 64)
    svc.shards[0].lookup_batch(keys[:40])
    assert not any(rmi_lookup.LAUNCHES.values()) and not any(rmi_scan.LAUNCHES.values())
    assert nvcc._LIBS == {}


def test_kernel_build_targets_hopper_with_separate_roundings():
    flags = " ".join(nvcc.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-fmad=false" in flags
    assert rmi_lookup.library_path().parent == nvcc.build_dir()
    src = rmi_lookup.SOURCE.read_text()
    assert "template <bool WITH_DELTA>" in src
    assert "rmi_merged_lookup_pallas" in src and "rmi_lookup_pallas" in src
    assert "rmi_sharded_merged_lookup_pallas" in src
    scan_src = rmi_scan.SOURCE.read_text()
    assert "rmi_scan_range_pallas" in scan_src and "rmi_scan_page_pallas" in scan_src
    assert "rmi_sharded_scan_page_pallas" in scan_src
    probe_src = hash_probe.SOURCE.read_text()
    assert "hash_probe_pallas" in probe_src and "bloom_probe_pallas" in probe_src
    assert bloom_probe.SOURCE == hash_probe.SOURCE
    # each library is named by its own source
    assert rmi_lookup.library_path() != nvcc.library_path(rmi_scan.SOURCE)
    assert nvcc.library_path(hash_probe.SOURCE).name.startswith("probe-")
    assert nvcc.library_path(rmi_scan.SOURCE).name.startswith("rmi_scan-")


def test_launch_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(4)
    arrs = [torch.zeros(2), torch.zeros(8), torch.zeros(8), torch.zeros(8),
            torch.zeros(8), torch.zeros(16)]
    with pytest.raises(ValueError, match="hidden"):
        rmi_lookup._launch(q, *arrs, None, None, hidden=(65,), n=16,
                           num_leaves=8, max_window=4)
    with pytest.raises(ValueError, match="n < 2\\*\\*30"):
        rmi_lookup._launch(q, *arrs, None, None, hidden=(), n=2**30,
                           num_leaves=8, max_window=4)


def test_lm_modules_import_without_jax():
    """The LM slice's modules are among those the fresh interpreter
    imports with neither JAX nor the reference loaded."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        env=env, check=True, timeout=120,
    ).stdout.split()
    assert out[1] == "[]"
    for name in ("repro_torch.configs", "repro_torch.configs.yi_6b",
                 "repro_torch.models.layers", "repro_torch.models.attention",
                 "repro_torch.models.transformer", "repro_torch.models.registry",
                 "repro_torch.kernels.flash_attention", "repro_torch.serve.kvcache",
                 "repro_torch.serve.engine", "repro_torch.launch.serve",
                 "repro_torch.train", "repro_torch.train.optimizer",
                 "repro_torch.train.train_step", "repro_torch.launch.train",
                 "repro_torch.models.mamba", "repro_torch.models.hybrid",
                 "repro_torch.models.xlstm", "repro_torch.models.xlstm_model"):
        assert name in out[2:], name


def test_serve_refuses_without_a_card_unless_asked_for_the_cpu(monkeypatch, capsys):
    from repro_torch.launch import serve
    from repro_torch.models import get_model
    from repro_torch.configs import REDUCED
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--arch", "yi-6b", "--reduced", "--requests", "2", "--max-new", "3"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(argv)
    for arch in ("yi-6b", "jamba-1.5-large-398b", "xlstm-1.3b"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            get_model(REDUCED[arch])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(argv + ["--prefix-bloom"])
    out = serve.main(argv + ["--device", "cpu"])
    assert out["completed"] == 2 and out["tokens"] == 6 and out["kv_pages_in_use"] == 0
    assert '"completed": 2' in capsys.readouterr().out


def test_train_refuses_without_a_card_unless_asked_for_the_cpu(monkeypatch):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--arch", "yi-6b", "--reduced", "--steps", "1", "--global-batch", "2",
            "--seq", "16"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(argv)
    out = train.main(argv + ["--device", "cpu"])
    assert out["first_loss"] == out["last_loss"] and np.isfinite(out["first_loss"])
