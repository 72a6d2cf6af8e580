"""The port stands alone: importing every module of `repro_torch` pulls in
neither JAX nor any module of the reference package, and its entry
points refuse to run without a card unless the caller asks for the CPU.
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
    build_snapshot,
)
from repro_torch.kernels import rmi_lookup  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "repro"
             or k.startswith("repro."))
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_reference():
    # a fresh interpreter: the test workers already hold JAX
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        env=env, check=True, timeout=120,
    ).stdout.split(maxsplit=1)
    assert int(out[0]) >= 20, "walked too few modules"
    assert out[1].strip() == "[]"


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


def test_bloom_screen_refused_until_ported():
    with pytest.raises(NotImplementedError):
        IndexService(_keys(), ServiceConfig(bloom_fpr=0.01), device="cpu")


def test_cpu_tensors_take_the_plain_version_without_building():
    """A wrapper given CPU tensors runs its plain version: no build, no
    launch counted."""
    rmi_lookup.reset_launch_counts()
    svc = IndexService(_keys(), ServiceConfig(strategy="cuda_fused"), device="cpu")
    svc.lookup_batch(_keys()[:50])
    assert rmi_lookup.LAUNCHES == {"rmi_lookup_cuda": 0, "rmi_merged_lookup_cuda": 0}
    assert rmi_lookup._LIB is None


def test_kernel_build_targets_hopper_with_separate_roundings():
    flags = " ".join(rmi_lookup.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-fmad=false" in flags
    assert rmi_lookup.library_path().parent == rmi_lookup.build_dir()
    src = rmi_lookup.SOURCE.read_text()
    assert "template <bool WITH_DELTA>" in src
    assert "rmi_merged_lookup_pallas" in src and "rmi_lookup_pallas" in src


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
