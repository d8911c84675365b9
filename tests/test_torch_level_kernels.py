"""The level path's potrf (K1) and left solve (K5) at the edges of their
panels and chunks: potrf held to the JAX package's XLA reference, the left
solve to a dense NumPy solve.

The CUDA bodies work in panels of 16 (potrf) and 32 (left solve) columns
and in chunks of 64 right-hand-side columns, so the shapes here sit on
either side of those edges: kv 0, 1, 16, 17, 32, 33 and nb (nb = 48), nrhs
1, 64 and 65, float32 and float64.  On the CPU each wrapper takes its plain
PyTorch version, which ``chip_smoke.py`` holds the kernels to on the card
at the same shapes.  potrf is held to the XLA reference
``spllt_tpu.numeric.factor._potrf_batch``; the left solve to a dense NumPy
solve of ``m = tile + I`` on the rows >= kv, the system the reference's
solve executor hands to ``triangular_solve``.  Tolerances: float32 rtol
1e-5 / atol 1e-6 of max|ref| (other summation order), float64 1e-12.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spllt_tpu.numeric.factor import _potrf_batch
from spllt_tpu_torch.numeric.hopper_potrf import potrf
from spllt_tpu_torch.numeric.hopper_solve import left_solve

NB = 48
KVS = (0, 1, 16, 17, 32, 33, NB)
DTYPES = [np.float32, np.float64]


def close(got, ref, dtype):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    if dtype == np.float32:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * scale)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12 * scale)


def bordered(seed, dtype, kvs):
    """SPD leading kv x kv blocks, random rows below, junk above the
    diagonal (it must be ignored)."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((len(kvs), NB, NB))
    t = g @ g.transpose(0, 2, 1) / NB + 2.0 * np.eye(NB)
    for i, k in enumerate(kvs):
        t[i, k:, :] = rng.standard_normal((NB - k, NB))
        t[i] += np.triu(rng.standard_normal((NB, NB)), 1)
    return t.astype(dtype), np.asarray(kvs, np.int32)


def tt(a):
    return torch.as_tensor(np.ascontiguousarray(a))


BATCH = 8      # every reference call has this batch, so XLA compiles once


def xla_potrf(tiles, kvec):
    """The XLA reference on a batch padded to BATCH tiles (kv = 0)."""
    k = len(kvec)
    pt = np.zeros((BATCH, NB, NB), tiles.dtype)
    pk = np.zeros(BATCH, np.int32)
    pt[:k], pk[:k] = tiles, kvec
    return np.asarray(_potrf_batch(jnp.asarray(pt), jnp.asarray(pk), NB))[:k]


@pytest.fixture(scope="module", autouse=True)
def compiled_reference():
    """Compile the reference once per dtype before the cases run."""
    for dtype in DTYPES:
        xla_potrf(np.zeros((1, NB, NB), dtype), np.zeros(1, np.int32))


@pytest.mark.parametrize("kv", KVS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_potrf_at_panel_edges_vs_xla_reference(dtype, kv):
    tiles, kvec = bordered(100 + kv, dtype, [kv])
    ref = xla_potrf(tiles, kvec)
    got = potrf(tt(tiles), tt(kvec))
    close(got, ref, dtype)
    assert not got[0, :, kv:].any()                   # columns >= kv zero


@pytest.mark.parametrize("col", [0, 17])
@pytest.mark.parametrize("dtype", DTYPES)
def test_potrf_failed_pivot_makes_the_whole_tile_nan(dtype, col):
    """A pivot failing at column 0 or 17 (inside the second 16-column
    panel): the whole tile is NaN, as the kernel leaves it; the reference
    is NaN where the executor's guard looks, element [0, 0]."""
    tiles, kvec = bordered(7, dtype, [NB])
    tiles[0, col, col] = -100.0
    got = potrf(tt(tiles), tt(kvec))
    assert bool(torch.isnan(got).all())
    assert np.isnan(xla_potrf(tiles, kvec)[0, 0, 0])


@pytest.mark.parametrize("nrhs", [1, 64, 65])
@pytest.mark.parametrize("transpose", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_left_solve_at_panel_and_chunk_edges_vs_dense(dtype, transpose,
                                                      nrhs):
    tiles, kvec = bordered(200 + nrhs, dtype, KVS)
    lt = potrf(tt(tiles), tt(kvec)).numpy()
    z = np.random.default_rng(nrhs).standard_normal(
        (len(KVS), NB, nrhs)).astype(dtype)
    got = left_solve(tt(lt), tt(z), tt(kvec), transpose)
    assert got.dtype == tt(z).dtype and got.is_contiguous()
    for i, k in enumerate(KVS):
        m = lt[i].astype(np.float64)
        m[np.arange(k, NB), np.arange(k, NB)] += 1.0
        ref = np.linalg.solve(m.T if transpose else m,
                              z[i].astype(np.float64))
        close(got[i], ref, dtype)
