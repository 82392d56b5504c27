"""mx.visualization of the PyTorch port: `print_summary` and
`plot_network`, the JAX package's text renderings of a block tree (the
graphviz dot source is returned or saved, never rendered)."""
from __future__ import annotations

from .gluon.block import Block

__all__ = ["print_summary", "plot_network"]


def print_summary(block, *inputs):
    """The per-layer table of `block.summary(*inputs)`."""
    return block.summary(*inputs)


def plot_network(block, title="network", save_path=None):
    """Graphviz dot source of the block tree: a node per block (its type,
    and the count of its own parameters where it has some), an edge from
    each block to each child, in the children's order. Written to
    `save_path` when given; returned."""
    lines = [f'digraph "{title}" {{', "  rankdir=TB;",
             '  node [shape=box, style="rounded,filled", '
             'fillcolor="#e8f0fe"];']
    counter = [0]

    def walk(blk, parent=None):
        nid = f"n{counter[0]}"
        counter[0] += 1
        label = type(blk).__name__
        params = len(blk._reg_params)
        if params:
            label += f"\\n({params} params)"
        lines.append(f'  {nid} [label="{label}"];')
        if parent is not None:
            lines.append(f"  {parent} -> {nid};")
        for child in blk._modules.values():
            if isinstance(child, Block):
                walk(child, nid)

    walk(block)
    lines.append("}")
    dot = "\n".join(lines)
    if save_path:
        with open(save_path, "w") as f:
            f.write(dot)
    return dot
