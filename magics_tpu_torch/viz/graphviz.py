"""Factor-graph DOT export (counterpart of magics_tpu's viz/graphviz.py;
crates/magics/src/factorgraph/graphviz.rs parity).

Emits one graphviz digraph with a cluster per robot: variable nodes along the
chain, dynamic/obstacle/tracking factor nodes on their edges, and inter-robot
factor edges across clusters (from the neighbour slot tables). The reference
exports this from the egui UI / `[graphviz] export-location` config. The
four fields read are copied off the state's device once.
"""

from __future__ import annotations

from pathlib import Path


_FACTOR_STYLE = {
    "dynamic": ("box", "#8aadf4"),
    "obstacle": ("box", "#ee99a0"),
    "tracking": ("box", "#f5a97f"),
    "interrobot": ("diamond", "#a6da95"),
}


def factorgraph_dot(state, params, robots: list[int] | None = None) -> str:
    """Render the current dense state's factor graphs as DOT."""
    R, V = state.prior_mean.shape[:2]
    active, nbr_idx, nbr_mask, means = (
        x.detach().cpu().numpy()
        for x in (state.active, state.nbr_idx, state.nbr_mask, state.belief_mean))
    if robots is None:
        robots = [r for r in range(R) if active[r]]
    chosen = set(robots)

    lines = [
        "graph factorgraphs {",
        "  graph [layout=neato, overlap=false, splines=true];",
        '  node [fontname="monospace", fontsize=9];',
    ]

    def vid(r, v):
        return f"r{r}v{v}"

    for r in robots:
        lines.append(f"  subgraph cluster_r{r} {{")
        lines.append(f'    label="robot {r}";')
        for v in range(V):
            x, y = means[r, v, 0], means[r, v, 1]
            lines.append(
                f'    {vid(r, v)} [shape=circle, label="x{v}", '
                f'pos="{x:.1f},{y:.1f}"];'
            )
        for v in range(V - 1):
            shape, color = _FACTOR_STYLE["dynamic"]
            fid = f"r{r}d{v}"
            lines.append(
                f'    {fid} [shape={shape}, color="{color}", label="f_d"];'
            )
            lines.append(f"    {vid(r, v)} -- {fid} -- {vid(r, v + 1)};")
        for kind in ("obstacle", "tracking"):
            enabled = (
                params.obstacle_enabled if kind == "obstacle" else params.tracking_enabled
            )
            if not enabled or V <= 2:
                continue
            shape, color = _FACTOR_STYLE[kind]
            tag = kind[0]
            for v in range(1, V - 1):
                fid = f"r{r}{tag}{v}"
                lines.append(
                    f'    {fid} [shape={shape}, color="{color}", label="f_{tag}"];'
                )
                lines.append(f"    {vid(r, v)} -- {fid};")
        lines.append("  }")

    # inter-robot factors: factor owned by (r, k) links r's var i+1 with
    # neighbour's var i+1 (state.py module doc)
    shape, color = _FACTOR_STYLE["interrobot"]
    seen = set()
    for r in robots:
        for k in range(nbr_idx.shape[1]):
            if not nbr_mask[r, k]:
                continue
            j = int(nbr_idx[r, k])
            if j not in chosen:
                continue
            for v in range(1, V):
                key = (min(r, j), max(r, j), v, r)  # factor owned by r
                if key in seen:
                    continue
                seen.add(key)
                fid = f"ir{r}_{j}_{v}"
                lines.append(
                    f'  {fid} [shape={shape}, color="{color}", label="f_ir"];'
                )
                lines.append(f"  {vid(r, v)} -- {fid} -- {vid(j, v)};")

    lines.append("}")
    return "\n".join(lines)


def export_dot(state, params, path: str | Path, robots: list[int] | None = None) -> None:
    Path(path).write_text(factorgraph_dot(state, params, robots))
