"""Graph inspection: text description + DOT export.

Extends the reference's GetAllNodes debug walk (AudioContextBase.cs:191-218)
with the compiled schedule view (stages, batching, channel counts) — the
information a performance engineer needs to see how the graph mapped to
device kernels.
"""

from __future__ import annotations


def describe_graph(context) -> str:
    """Human-readable dump: nodes, connections, compiled stage schedule."""
    context._ensure_compiled()
    cg = context._compiled
    lines = [
        f"AudioContext @ {context.sample_rate} Hz, superblock={context.superblock} "
        f"({context.superblock * 128} frames/step)",
        f"nodes: {len(cg.topo)}   stages: {len(cg.stages)}",
        "",
        "schedule:",
    ]
    for si, (kind, nodes, _gkey) in enumerate(cg.stages):
        rep = nodes[0]
        if kind == "group":
            real, padded = cg.stage_pad[si]
            pad = f" pad->{padded}" if padded != real else ""
            shard = " sharded" if si in getattr(cg, "sharded_stages", ()) else ""
            lines.append(
                f"  [group x{len(nodes)}{pad}{shard}] {type(rep).__name__} "
                f"(vmapped, key={rep.group_key([cg.input_channels.get((rep.node_id, i.index)) for i in rep.inputs])})"
            )
        elif kind == "dest":
            c = cg.input_channels.get((rep.node_id, 0))
            lines.append(f"  [sink] {rep.name} ({c} ch)")
        else:
            lines.append(f"  [single] {rep.name} (id={rep.node_id})")
    lines.append("")
    lines.append("connections:")
    for node in cg.topo:
        for out in node.outputs:
            for inp in out.connections:
                lines.append(
                    f"  {node.name}#{node.node_id}[{out.index}] -> "
                    f"{inp.owner.name}#{inp.owner.node_id}[{inp.index}]"
                )
            for p in out.param_connections:
                lines.append(
                    f"  {node.name}#{node.node_id}[{out.index}] ~> "
                    f"{p._owner.name}#{p._owner.node_id}.{p.name}"
                )
    return "\n".join(lines)


def graph_to_dot(context) -> str:
    """GraphViz DOT export of the node graph."""
    context._ensure_compiled()
    cg = context._compiled
    lines = ["digraph audiograph {", "  rankdir=LR;", "  node [shape=box];"]
    for node in cg.topo:
        label = f"{node.name}\\n#{node.node_id}"
        shape = "doubleoctagon" if node is context.destination else "box"
        lines.append(f'  n{node.node_id} [label="{label}", shape={shape}];')
    for node in cg.topo:
        for out in node.outputs:
            for inp in out.connections:
                lines.append(f"  n{node.node_id} -> n{inp.owner.node_id};")
            for p in out.param_connections:
                lines.append(
                    f'  n{node.node_id} -> n{p._owner.node_id} '
                    f'[style=dashed, label="{p.name}"];'
                )
    lines.append("}")
    return "\n".join(lines)
