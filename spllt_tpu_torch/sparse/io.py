"""Matrix readers: MatrixMarket and Rutherford-Boeing.

The reference reads Rutherford-Boeing (``spllt_read_mat`` via SPRAL
rb_read) and MatrixMarket (``--mm``) inputs
(SpLLT:src/spllt_mod.F90:426-495).  Both readers return the
lower-triangle CscMatrix; pattern-only files get random values with forced
diagonal dominance (SPRAL ``random_real``-style,
SpLLT:src/spllt_mod.F90:481-486).

A copy of ``spllt_tpu.sparse.io``: the same readers and writers, byte for
byte the same files, so a matrix written by either package reads in both.
"""

from __future__ import annotations

import gzip

import numpy as np

from .csc import CscMatrix

__all__ = ["read_matrix_market", "read_rutherford_boeing", "read_matrix",
           "write_matrix_market", "write_rutherford_boeing"]


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path)


def _parse_floats(text: str) -> np.ndarray:
    """Whitespace-separated numeric text → float64 array (vectorized)."""
    return np.array(text.split(), dtype=np.float64)


def read_matrix_market(path: str, force_posdef: bool = True) -> CscMatrix:
    """Read a symmetric MatrixMarket .mtx file (coordinate format)."""
    with _open(path) as f:
        header = f.readline().strip().lower()
        if not header.startswith("%%matrixmarket"):
            raise ValueError("not a MatrixMarket file")
        parts = header.split()
        pattern_only = "pattern" in parts
        symmetric = "symmetric" in parts
        if not symmetric:
            raise ValueError("spllt_tpu requires a symmetric matrix")
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        m, n, nnz = (int(x) for x in line.split())
        if m != n:
            raise ValueError("matrix must be square")
        # bulk-parse the coordinate block (multi-million-nnz files):
        # one fromstring pass instead of a per-line python loop
        ncols_file = 2 if pattern_only else 3
        data = _parse_floats(f.read())
        if data.size < nnz * ncols_file:
            raise ValueError("truncated MatrixMarket coordinate data")
        data = data[: nnz * ncols_file].reshape(nnz, ncols_file)
        rows = data[:, 0].astype(np.int64) - 1
        cols = data[:, 1].astype(np.int64) - 1
        vals = None if pattern_only else np.ascontiguousarray(data[:, 2])
    if vals is None:
        a = CscMatrix.from_coo(n, rows, cols,
                               np.zeros(len(rows)))
        _fill_random_posdef(a)
        return a
    a = CscMatrix.from_coo(n, rows, cols, vals)
    if force_posdef:
        _force_diag_dominant(a)
    return a


def _parse_fortran_format(fmt: str):
    """Field width of a Fortran edit descriptor like ``(26I3)``,
    ``(8I10)``, ``(3E25.16)``, ``(1P,5D16.9)``.  Returns the width w (or
    None when the descriptor is unrecognized — caller falls back to
    whitespace splitting)."""
    import re

    m = re.search(r"(\d*)\s*([IEFDG])\s*(\d+)(?:\.\d+)?",
                  fmt.upper().replace(" ", ""))
    if not m:
        return None
    return int(m.group(3))


def _parse_fixed(cards: str, width: int | None, count: int) -> np.ndarray:
    """Parse ``count`` numbers from card images by the DECLARED field
    width (the reference reads via SPRAL's Fortran formatted reads, so
    abutting fields — large indices under (8I10), no-blank negative
    exponents — must parse; whitespace splitting breaks there)."""
    if width is None:
        return _parse_floats(cards)[:count]
    toks: list[str] = []
    for line in cards.split("\n"):
        line = line.rstrip("\r\n")
        for s0 in range(0, len(line), width):
            tok = line[s0:s0 + width].strip()
            if tok:
                toks.append(tok)
    toks = toks[:count]
    # Fortran allows D exponents and omitted E ("1.234-05")
    import re

    def fix(t):
        t = t.replace("D", "E").replace("d", "e")
        t = re.sub(r"(?<=[0-9.])([+-]\d+)$",
                   lambda m: "e" + m.group(1), t) \
            if "e" not in t and "E" not in t else t
        return t

    return np.asarray([float(fix(t)) for t in toks])


def read_rutherford_boeing(path: str,
                           force_posdef: bool = True) -> CscMatrix:
    """Read a Rutherford-Boeing .rb / .rsa file (real symmetric
    assembled).  Format: 4-5 header lines then column pointers, row
    indices, and (optionally) values in fixed-width Fortran fields,
    sliced by the DECLARED formats (line 4), not whitespace."""
    with _open(path) as f:
        f.readline()  # title
        l2 = f.readline().split()
        # totcrd ptrcrd indcrd valcrd
        ptrcrd, indcrd = int(l2[1]), int(l2[2])
        valcrd = int(l2[3]) if len(l2) > 3 else 0
        l3 = f.readline().split()
        mxtype = l3[0].lower()
        nrow, ncol, nnz = int(l3[1]), int(l3[2]), int(l3[3])
        fmts = f.readline()  # formats line: ptrfmt indfmt valfmt
        import re

        fmt_fields = re.findall(r"\([^)]*\)", fmts)
        wptr = _parse_fortran_format(fmt_fields[0]) \
            if len(fmt_fields) > 0 else None
        wind = _parse_fortran_format(fmt_fields[1]) \
            if len(fmt_fields) > 1 else None
        wval = _parse_fortran_format(fmt_fields[-1]) \
            if len(fmt_fields) > 2 else None
        if mxtype[1] not in ("s", "u"):
            raise ValueError(f"unsupported RB matrix type {mxtype}")

        def read_cards(ncards):
            return "\n".join(f.readline() for _ in range(ncards))

        colptr = _parse_fixed(read_cards(ptrcrd), wptr, ncol + 1) \
            .astype(np.int64) - 1
        rowind = _parse_fixed(read_cards(indcrd), wind, nnz) \
            .astype(np.int64) - 1
        vals = None
        if valcrd > 0 and mxtype[0] in ("r", "i"):
            vals = _parse_fixed(read_cards(valcrd), wval, nnz)
    cols = np.repeat(np.arange(ncol, dtype=np.int64), np.diff(colptr))
    if vals is None:
        a = CscMatrix.from_coo(ncol, rowind, cols, np.zeros(nnz))
        _fill_random_posdef(a)
        return a
    a = CscMatrix.from_coo(ncol, rowind, cols, vals)
    if force_posdef:
        _force_diag_dominant(a)
    return a


def read_matrix(path: str, fmt: str | None = None) -> CscMatrix:
    if fmt == "mm" or (fmt is None and (".mtx" in path)):
        return read_matrix_market(path)
    return read_rutherford_boeing(path)


def _fill_random_posdef(a: CscMatrix, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    a.values = rng.uniform(-1.0, 1.0, size=a.nnz)
    _force_diag_dominant(a)


def _force_diag_dominant(a: CscMatrix) -> None:
    """Overwrite the diagonal to make A symmetric diagonally dominant
    (the reference forces ``rb_options%values=3``,
    SpLLT:test/test_solve_phasis.F90:89)."""
    n = a.n
    cols = np.repeat(np.arange(n), np.diff(a.colptr))
    off = a.rowind != cols
    absv = np.abs(a.values)
    dom = np.zeros(n)
    np.add.at(dom, a.rowind[off], absv[off])
    np.add.at(dom, cols[off], absv[off])
    a.values[a.colptr[:-1]] = dom + 1.0


def write_matrix_market(path: str, a: CscMatrix) -> None:
    """Write the lower-triangle CSC as a symmetric coordinate .mtx file
    (interchange parity with the reference's ``--mm`` path,
    SpLLT:src/spllt_mod.F90:426-495; the Poisson sweep scripts
    generate exactly this format, aux/run_tests_poisson3d.sh)."""
    n = a.n
    nnz = int(a.colptr[-1])
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(a.colptr))
    body = np.column_stack([a.rowind + 1, cols + 1, a.values])
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real symmetric\n")
        f.write(f"{n} {n} {nnz}\n")
        np.savetxt(f, body, fmt="%d %d %.18e")


def write_rutherford_boeing(path: str, a: CscMatrix,
                            title: str = "spllt_tpu matrix") -> None:
    """Write the lower-triangle CSC as a Rutherford-Boeing ``rsa`` file
    (real symmetric assembled) — interchange parity with the reference's
    RB I/O (SPRAL rb_read/rb_write, spllt_mod.F90:426-495)."""
    n = a.n
    nnz = int(a.colptr[-1])
    per_int, per_val = 8, 3
    ptrcrd = -(-(n + 1) // per_int)
    indcrd = -(-nnz // per_int)
    valcrd = -(-nnz // per_val)

    def cards(arr, per, fmt):
        lines = []
        for i in range(0, len(arr), per):
            lines.append("".join(fmt % v for v in arr[i:i + per]))
        return lines

    with open(path, "w") as f:
        f.write(f"{title[:72]:<72s}{'spllttpu':<8s}\n")
        f.write(f"{ptrcrd + indcrd + valcrd:14d}{ptrcrd:14d}"
                f"{indcrd:14d}{valcrd:14d}\n")
        f.write(f"{'rsa':<14s}{n:14d}{n:14d}{nnz:14d}{0:14d}\n")
        f.write(f"{'(8I10)':<16s}{'(8I10)':<16s}{'(3E26.18)':<20s}\n")
        for ln in cards(np.asarray(a.colptr) + 1, per_int, "%10d"):
            f.write(ln + "\n")
        for ln in cards(np.asarray(a.rowind) + 1, per_int, "%10d"):
            f.write(ln + "\n")
        vals = (a.values if a.values is not None
                else np.zeros(nnz))
        for ln in cards(np.asarray(vals, dtype=np.float64), per_val,
                        "%26.18E"):
            f.write(ln + "\n")
