"""The update kernel's packed task tables (K3) and the trsm kernel's row
bands (K2), on the CPU.

K3 multiplies only each task's live rows and columns, which
``hopper_update.tasks_to_device`` packs once per pattern as int32 entries
``i << 16 | rel`` (``eptr``/``enr``/``ent``).  Here the packed entries are
unpacked and held equal to the JAX package's own micro-task maps
(``spllt_tpu.numeric.pallas_update.build_micro_tasks``: ``relr``, ``relc``
masked by ``blkn``), entry for entry and in order, on real plans
(poisson2d(16), poisson3d(8); nb 8 and 16) and on the hand-made edge
tables, with the flag that chains a task to the next one with the same
live rows and columns and the level's launch choice (one block an SM for
long near-dense chains only); and the update evaluated from the packed entries
alone with plain torch in float64 is held to ``apply_updates_plain``
within 1e-12 of the size of the update (other summation order).  K2 cuts each pair into row
bands (``trsm_bands``); every row of every pair must be in exactly one
band, and the band rule must be the factor stream kernel's TRSM split.
"""

import functools

import numpy as np
import pytest
import torch

import spllt_tpu as sj
from spllt_tpu.api import _plans as plans_j
from spllt_tpu.numeric.pallas_update import build_micro_tasks as bmt_j
from spllt_tpu_torch.numeric import megakernel as mk
from spllt_tpu_torch.numeric.hopper_trsm import trsm_band_rows, trsm_bands
from spllt_tpu_torch.numeric.hopper_update import (CHAIN, apply_updates_plain,
                                                   compact_edge_tasks,
                                                   dense_edge_tasks,
                                                   edge_case_tasks,
                                                   tasks_to_device)


def level_tables(problem, nb):
    """The micro-task tables of every level of a real plan, by the JAX
    package's builder, with the port's ``srcn`` (all of the source width)
    and the pool rows."""
    a = sj.poisson2d(16) if problem == "p2d16" else sj.poisson3d(8)
    symb = sj.analyse(a, sj.Options(ordering="nd", nb=nb, nemin=4))
    _, fp, _ = plans_j(symb, symb.options)
    rows = (fp.nblocks + 1) * nb
    tabs = []
    for lvl in range(1, fp.nlevels + 1):
        mt = bmt_j(fp, lvl, lvl, nb, rows)
        if len(mt["dst"]):
            tabs.append(dict(mt, srcn=np.full(len(mt["dst"]), nb, np.int32)))
    return tabs, rows


CASES = [f"{p}_nb{nb}" for p in ("p2d16", "p3d8") for nb in (8, 16)] + \
    [f"{kind}_nb{nb}" for nb in (48, 128)
     for kind in ("edge", "compact", "dense")]


@functools.lru_cache(maxsize=None)
def case(name):
    """(nb, pool rows, tables) of one case, built on first use."""
    kind, nb = name.rsplit("_nb", 1)
    nb = int(nb)
    if kind == "edge":
        return nb, 12 * nb, [edge_case_tasks(nb, 12 * nb, nb)]
    if kind in ("compact", "dense"):
        make = compact_edge_tasks if kind == "compact" else dense_edge_tasks
        t, rows = make(nb, nb)
        return nb, rows, [t]
    tabs, rows = level_tables(kind, nb)
    return nb, rows, tabs


def unpack(dev, nb):
    """The packed entries back as [K, nb] maps (-1: not live), each task's
    position in the list, and whether each entry is a row."""
    eptr, enr = dev["eptr"].numpy(), dev["enr"].numpy() % CHAIN
    ent = dev["ent"].numpy()
    k = len(eptr) - 1
    task = np.repeat(np.arange(k), np.diff(eptr))
    is_row = np.arange(len(ent)) - eptr[task] < enr[task]
    i, rel = ent >> 16, ent & 0xffff
    r = np.full((k, nb), -1, np.int64)
    c = np.full((k, nb), -1, np.int64)
    r[task[is_row], i[is_row]] = rel[is_row]
    c[task[~is_row], i[~is_row]] = rel[~is_row]
    return r, c, task, is_row, i


@pytest.mark.parametrize("name", CASES)
def test_packed_entries_reproduce_maps(name):
    """Every live row and live column once, in ascending order, none
    extra, with its source row: exactly the JAX-format maps."""
    nb, rows, tabs = case(name)
    for mt in tabs:
        dev = tasks_to_device(mt, nb, rows, "cpu")
        relr, relc = np.asarray(mt["relr"]), np.asarray(mt["relc"])
        live_c = (relc >= 0) & (np.arange(nb)[None, :]
                                < np.asarray(mt["blkn"])[:, None])
        r, c, task, is_row, i = unpack(dev, nb)
        assert np.array_equal(r, np.where(relr >= 0, relr, -1))
        assert np.array_equal(c, np.where(live_c, relc, -1))
        assert int(is_row.sum()) == int((relr >= 0).sum())
        assert int((~is_row).sum()) == int(live_c.sum())
        same = (task[1:] == task[:-1]) & (is_row[1:] == is_row[:-1])
        assert (np.diff(i)[same] > 0).all()       # ascending, no repeats
        # the rows of a task come before its columns
        assert not ((task[1:] == task[:-1]) & ~is_row[:-1]
                    & is_row[1:]).any()
        assert np.array_equal(dev["relr"].numpy(), relr)
        assert np.array_equal(dev["relc"].numpy(), relc)
        # the chain flag: the next task has this dst and these live sets
        dst = np.asarray(mt["dst"])
        chain = dev["enr"].numpy() >= CHAIN
        want = np.zeros_like(chain)
        want[:-1] = ((dst[1:] == dst[:-1])
                     & ((r[1:] >= 0) == (r[:-1] >= 0)).all(1)
                     & ((c[1:] >= 0) == (c[:-1] >= 0)).all(1))
        assert np.array_equal(chain, want)


def packed_update(poolf, dev, nb):
    """The update from the packed entries alone, task after task: gather
    the live source rows up to srcn, multiply, subtract at the live
    cells."""
    eptr, enr = dev["eptr"].tolist(), (dev["enr"] % CHAIN).tolist()
    ent, tiles = dev["ent"], poolf.view(-1, nb, nb)
    for t in range(len(enr)):
        e = ent[eptr[t]:eptr[t + 1]].to(torch.int64)
        er, ec = e[:enr[t]], e[enr[t]:]
        kn = int(dev["srcn"][t])
        a = poolf[int(dev["lor"][t]) + (er & 0xffff), :kn]
        b = poolf[int(dev["loc"][t]) + (ec & 0xffff), :kn]
        d = tiles[int(dev["dst"][t])]
        d[(er >> 16)[:, None], (ec >> 16)[None, :]] -= a @ b.T
    return poolf


@pytest.mark.parametrize("name", CASES)
def test_packed_decomposition_equals_plain(name):
    """float64, random pool (columns past srcn not zero, so the trim
    counts): 1e-12 of the size of the update."""
    nb, rows, tabs = case(name)
    rng = np.random.default_rng(nb)
    for mt in tabs:
        dev = tasks_to_device(mt, nb, rows, "cpu")
        pool = torch.as_tensor(rng.standard_normal((rows, nb)))
        ref = apply_updates_plain(pool.clone(), dev)
        got = packed_update(pool.clone(), dev, nb)
        scale = float((ref - pool).abs().max())
        assert float((got - ref).abs().max()) <= 1e-12 * scale


@pytest.mark.parametrize("name", CASES)
def test_dense_launch_choice(name):
    """One block an SM only for the level of long near-dense chains: the
    dense edge table, no real level of these small plans, no other edge
    table."""
    nb, rows, tabs = case(name)
    for mt in tabs:
        assert tasks_to_device(mt, nb, rows, "cpu")["dense"] == \
            name.startswith("dense")


@pytest.mark.parametrize("nb", [8, 48, 128, 256])
def test_trsm_bands_cover_each_row_once(nb):
    """Every (pair, row) in exactly one band, no band wider than the rule's
    rows, narrower bands only while the launch stays within 264 blocks, and
    the rule is the factor stream kernel's TRSM split."""
    for npairs in (1, 16, 17, 33, 34, 66, 67, 132, 133, 300):
        rows = trsm_band_rows(npairs, nb)
        bands = trsm_bands(npairs, nb)
        cover = np.zeros((npairs, nb), np.int64)
        for p, r0, nr in bands:
            assert 0 < nr <= rows and r0 % rows == 0
            cover[p, r0:r0 + nr] += 1
        assert (cover == 1).all(), npairs
        assert len(bands) == npairs * -(-nb // rows)
        if rows < 64 and rows < nb:
            assert len(bands) <= mk.BLOCKS
        assert rows == min(nb, mk.TRSM_ROWS // mk.trsm_split(npairs, nb))
