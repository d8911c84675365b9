"""The port's C interface (spllt_tpu_torch.capi and native/capi.cpp),
mirroring tests/test_capi.py: the Python glue driven as the embedding
library drives it (raw pointers as integers), on the CPU through
SPLLT_CAPI_DEVICE=cpu.  The native build and the C example run only under
SPLLT_SLOW_TESTS=1."""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from spllt_tpu import capi as capi_j
from spllt_tpu_torch import capi
from spllt_tpu_torch.sparse.generators import poisson2d

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = (16, 8, "natural", "scan", "highest", 2)


def pattern(a):
    colptr = np.ascontiguousarray(a.colptr, dtype=np.int64)
    rowind = np.ascontiguousarray(a.rowind, dtype=np.int64)
    return colptr, rowind


def analyse(a, *args):
    colptr, rowind = pattern(a)
    return capi.analyse_c(a.n, a.n + 1, colptr.ctypes.data,
                          rowind.ctypes.data, *args)


@pytest.mark.parametrize("schedule", ["scan", "mega"])
def test_capi_glue_roundtrip(monkeypatch, schedule):
    """analyse → factor → in-place column-major solve → free, with the
    reference glue's inform numbers."""
    monkeypatch.setenv("SPLLT_CAPI_DEVICE", "cpu")
    a = poisson2d(8)
    n = a.n
    args = (16, 8, "natural", schedule, "highest", 2)
    h, nnzl, flops, nodes = analyse(a, *args)
    colptr, rowind = pattern(a)
    hj, *inform_j = capi_j.analyse_c(n, n + 1, colptr.ctypes.data,
                                     rowind.ctypes.data, *args)
    capi_j.free_c(hj)
    assert h > 0 and [nnzl, flops, nodes] == inform_j
    vals = np.ascontiguousarray(a.values, dtype=np.float64)
    assert capi.factor_c(h, vals.ctypes.data) == 0
    assert isinstance(capi._registry[h]["num"].pool, torch.Tensor)
    xt = np.random.default_rng(3).standard_normal((n, 2))
    b = a.matvec(xt)
    x = np.asfortranarray(b)            # column-major in/out buffer
    assert capi.solve_c(h, 2, x.ctypes.data, 0) == 0
    bwd = np.linalg.norm(a.matvec(np.ascontiguousarray(x)) - b) \
        / np.linalg.norm(b)
    assert bwd < 1e-12
    assert capi.free_c(h) == 0 and h not in capi._registry


def test_capi_return_codes(monkeypatch):
    """-2 for a solve before the factor, -1 for a matrix that is not
    positive definite."""
    monkeypatch.setenv("SPLLT_CAPI_DEVICE", "cpu")
    a = poisson2d(6)
    h, *_ = analyse(a, *ARGS[:-1], 0)
    x = np.zeros(a.n)
    assert capi.solve_c(h, 1, x.ctypes.data, 0) == -2
    vals = -np.ascontiguousarray(a.values, dtype=np.float64)
    assert capi.factor_c(h, vals.ctypes.data) == -1
    capi.free_c(h)


def test_capi_default_device_is_the_card(monkeypatch):
    """Without SPLLT_CAPI_DEVICE the factor asks for CUDA: here it raises
    (the C wrapper returns -3) instead of running on the CPU."""
    monkeypatch.delenv("SPLLT_CAPI_DEVICE", raising=False)
    assert capi.device() == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    a = poisson2d(6)
    h, *_ = analyse(a, *ARGS)
    vals = np.ascontiguousarray(a.values, dtype=np.float64)
    with pytest.raises(RuntimeError, match="is_available"):
        capi.factor_c(h, vals.ctypes.data)
    assert capi._registry[h]["num"] is None
    capi.free_c(h)


@pytest.mark.skipif(
    os.environ.get("SPLLT_SLOW_TESTS", "") == "" or not shutil.which("gcc"),
    reason="the native round trip builds the embedding library "
           "(set SPLLT_SLOW_TESTS=1)")
def test_capi_native_example(tmp_path):
    """examples/c/simple.c linked against the port's library: exit 0 and
    'ok' on the CPU shards; without a card and without SPLLT_CAPI_DEVICE
    the factor fails with -3 and the program exits 1."""
    from spllt_tpu_torch.numeric._build import build_c_program, embedded_env

    exe = build_c_program(os.path.join(REPO, "examples", "c", "simple.c"),
                          str(tmp_path / "simple"))
    r = subprocess.run([exe], env=embedded_env(SPLLT_CAPI_DEVICE="cpu"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "ok" in r.stdout and "max |x - 1|" in r.stdout
    if not torch.cuda.is_available():
        env = embedded_env()
        env.pop("SPLLT_CAPI_DEVICE", None)
        r = subprocess.run([exe], env=env, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode == 1 and "factor failed" in r.stderr
