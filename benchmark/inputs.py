"""The one generator of traffic: what a mix file asks for, made from the seed.

A mix file (``traffic/<name>.json``) gives parameters only:

- ``refactor_each_step``: each step factors a new value set (true), or the
  factor is made once in set-up and each step only solves (false);
- ``value_sets``: how many value sets are made; step i uses set i mod V;
- ``offdiag_scale`` s: each off-diagonal entry is scaled by (1 + s·u), u
  uniform on [0, 1);
- ``dominance_margin`` t: the diagonal is reset to the row's original margin
  (its diagonal less the sum of its off-diagonal magnitudes) plus (1 + t)
  times the new off-diagonal sum, so each set is strictly diagonally
  dominant and so SPD, and keeps the conditioning of the matrix it came from;
- ``nrhs``, ``rhs_sets``: right-hand sides, standard normal float64, [n] at
  nrhs 1 and [n, nrhs] above; step i uses set i mod R;
- ``check_sample``: how many steps of the window the check compares, drawn
  from the seed (a uniform sample of all the window's steps).

Every seed gets the same sizes and the same number of sets: only the numbers
in them differ.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Inputs:
    value_sets: list      # float64 [nnz] lower-CSC values, one per set
    rhs_sets: list        # float64 [n] or [n, nrhs], one per set


def seed_sequence(seed: int, salt: int) -> np.random.SeedSequence:
    """The numbers of one stream: any whole ``seed``, negative ones too."""
    return np.random.SeedSequence([seed % 2 ** 64, salt])


def value_set(n: int, colptr: np.ndarray, rowind: np.ndarray,
              values: np.ndarray, rng: np.random.Generator, scale: float,
              margin: float) -> np.ndarray:
    """One strictly diagonally dominant value set on the pattern."""
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(colptr))
    off = rowind != cols
    diag = ~off

    def offdiag_sum(v):
        s = np.bincount(rowind[off], weights=np.abs(v[off]), minlength=n)
        return s + np.bincount(cols[off], weights=np.abs(v[off]),
                               minlength=n)

    old_margin = values[diag] - offdiag_sum(values)
    out = values.copy()
    out[off] *= 1.0 + scale * rng.random(int(off.sum()))
    out[diag] = old_margin + (1.0 + margin) * offdiag_sum(out)
    return out


def make_inputs(matrix: tuple, traffic: dict, seed: int) -> Inputs:
    """The value sets and right-hand sides of ``traffic`` on ``matrix``
    (n, colptr, rowind, values), from ``seed``."""
    n, colptr, rowind, values = matrix
    rng = np.random.default_rng(seed_sequence(seed, 1))
    vsets = [value_set(n, colptr, rowind, values, rng,
                       float(traffic["offdiag_scale"]),
                       float(traffic["dominance_margin"]))
             for _ in range(int(traffic["value_sets"]))]
    nrhs = int(traffic["nrhs"])
    shape = (n,) if nrhs == 1 else (n, nrhs)
    rng = np.random.default_rng(seed_sequence(seed, 2))
    rhs = [rng.standard_normal(shape) for _ in range(int(traffic["rhs_sets"]))]
    return Inputs(value_sets=vsets, rhs_sets=rhs)
