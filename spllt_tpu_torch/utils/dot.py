"""Assembly-tree DOT dump (``spllt_print_atree`` analogue,
SpLLT:src/spllt_mod.F90:190-250); a copy of ``spllt_tpu.utils.dot``."""

from __future__ import annotations

__all__ = ["atree_dot"]


def atree_dot(symb, path: str | None = None, max_nodes: int = 2000) -> str:
    """Render the supernode assembly tree as a DOT digraph.  Nodes are
    labeled with column range, row count and subtree flops; coarsened/
    pruned subtrees (small marks) are shaded."""
    f = symb.forest
    n = min(f.nnodes, max_nodes)
    lines = ["digraph atree {", "  node [shape=box, fontsize=9];"]
    for nd in range(n):
        m = int(f.rptr[nd + 1] - f.rptr[nd])
        w = f.ncols(nd)
        style = ""
        if symb.small is not None and len(symb.small) > nd:
            if symb.small[nd] == 1:
                style = ', style=filled, fillcolor="lightblue"'
            elif symb.small[nd] == -1:
                style = ', style=filled, fillcolor="lightgray"'
        lines.append(
            f'  n{nd} [label="{nd}\\ncols {f.sa[nd]}:{f.en[nd]} '
            f'({w})\\nm={m}\\nflops {symb.weight[nd]:.2e}"{style}];')
    for nd in range(n):
        p = f.sparent[nd]
        if p != -1 and p < n:
            lines.append(f"  n{nd} -> n{p};")
    if f.nnodes > n:
        lines.append(f'  trunc [label="... {f.nnodes - n} more nodes"];')
    lines.append("}")
    text = "\n".join(lines)
    if path:
        with open(path, "w") as fh:
            fh.write(text)
    return text
