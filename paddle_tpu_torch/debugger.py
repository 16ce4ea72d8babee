"""Program visualization / debugging helpers (counterpart of
paddle_tpu/debugger.py; reference: python/paddle/fluid/debugger.py
pprint_program_codes + draw_block_graphviz and net_drawer.py/graphviz.py
— human-readable program dumps and a graphviz DOT rendering of the
op/var graph)."""

from __future__ import annotations

from typing import Optional

from .core import dtype_utils
from .core.program import Program, default_main_program


def pprint_program_codes(program: Optional[Program] = None,
                         annotate: bool = False) -> str:
    """Pseudo-code dump of every block (reference:
    debugger.py pprint_program_codes).

    ``annotate=True`` interleaves the static analyzer's findings: each
    global-block op line gains a ``# live: N tensors, X bytes`` comment
    from the liveness engine, ops with diagnostics get them printed
    inline, and the dump ends with the full diagnostic listing —
    a program dump and its verification report in one artifact."""
    program = program or default_main_program()
    per_op_note = {}
    per_op_diags = {}
    tail = []
    if annotate:
        from . import analysis

        report = analysis.check_program(program, with_memory=True)
        mem = report.memory
        for i in range(len(mem.per_op_bytes)):
            per_op_note[(0, i)] = (f"live: {mem.per_op_live[i]} tensors, "
                                   f"{mem.per_op_bytes[i]} bytes")
        for d in report.diagnostics:
            if d.op_idx is not None:
                per_op_diags.setdefault((d.block_idx, d.op_idx),
                                        []).append(d)
        tail = ["", *("# " + line for line in str(report).splitlines())]
    lines = []
    for blk in program.blocks:
        lines.append(f"# block {blk.idx} (parent {blk.parent_idx})")
        for name, v in blk.vars.items():
            kind = "param" if getattr(v, "trainable", None) is not None \
                else ("data" if v.is_data else "var")
            persist = " persistable" if v.persistable else ""
            lines.append(
                f"  {kind} {name}: shape={v.shape} "
                f"dtype={dtype_utils.name(v.dtype)}{persist}")
        for i, op in enumerate(blk.ops):
            outs = ", ".join(op.output_arg_names)
            ins = ", ".join(op.input_arg_names)
            note = per_op_note.get((blk.idx, i))
            lines.append(f"  {outs} = {op.type}({ins})"
                         + (f"  # {note}" if note else ""))
            for d in per_op_diags.get((blk.idx, i), ()):
                lines.append(f"    # ^ {d}")
    lines.extend(tail)
    return "\n".join(lines)


def draw_block_graphviz(block=None, path: Optional[str] = None,
                        highlights=None, program=None) -> str:
    """DOT source of a block's op/var dataflow graph (reference:
    debugger.py draw_block_graphviz / net_drawer.py). Render with any
    graphviz install; returns (and optionally writes) the DOT text."""
    if block is None:
        block = (program or default_main_program()).global_block()
    highlights = set(highlights or [])
    lines = ["digraph program {", "  rankdir=TB;",
             '  node [fontsize=10];']
    emitted = set()

    def var_node(n):
        if n in emitted:
            return
        emitted.add(n)
        v = block._find_var_recursive(n)
        shape = getattr(v, "shape", None) if v is not None else None
        color = "red" if n in highlights else (
            "lightblue" if v is not None and v.persistable else "gray90")
        lines.append(
            f'  "{n}" [shape=ellipse style=filled fillcolor={color} '
            f'label="{n}\\n{shape}"];')

    for i, op in enumerate(block.ops):
        op_id = f"op{i}_{op.type}"
        lines.append(
            f'  "{op_id}" [shape=box style=filled fillcolor=khaki '
            f'label="{op.type}"];')
        for n in op.input_arg_names:
            var_node(n)
            lines.append(f'  "{n}" -> "{op_id}";')
        for n in op.output_arg_names:
            var_node(n)
            lines.append(f'  "{op_id}" -> "{n}";')
    lines.append("}")
    dot = "\n".join(lines)
    if path:
        with open(path, "w") as f:
            f.write(dot)
    return dot
