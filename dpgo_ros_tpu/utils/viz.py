"""Self-contained HTML/SVG visualization of fleet solutions.

The framework's replacement for the reference's rviz configuration
(``rviz/default.rviz``: 8 Path + 8 Marker displays; trajectory publishing at
``src/PGOAgentROS.cpp:629-660``, loop-closure markers colored by GNC weight —
green=accepted, red=rejected, blue=undecided — at ``:756-843``). Produces a
single HTML file with three orthographic projections (XY, XZ, YZ), per-robot
colored trajectories, and loop-closure segments colored by their final
weight. No external dependencies — viewable in any browser.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from dpgo_ros_tpu.types import EdgeType, MeasurementBatch

_ROBOT_COLORS = [
    "#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
    "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf",
]


def _svg_panel(T, num_poses, measurements, weights, ax0, ax1, label, size=420):
    pts = T[:, :, T.shape[2] - 1]
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    span = np.maximum(hi - lo, 1e-9)
    pad = 0.05

    def sx(v):
        return (pad + (1 - 2 * pad) * (v - lo[ax0]) / span[ax0]) * size

    def sy(v):
        return (1 - pad - (1 - 2 * pad) * (v - lo[ax1]) / span[ax1]) * size

    out = [
        f'<svg width="{size}" height="{size}" '
        f'style="background:#fff;border:1px solid #ccc">',
        f'<text x="8" y="16" font-size="13" fill="#333">{label}</text>',
    ]
    # loop closures under trajectories
    if measurements is not None:
        offsets = np.zeros(len(num_poses), np.int64)
        np.cumsum(np.asarray(num_poses)[:-1], out=offsets[1:])
        m = measurements
        for k in range(len(m)):
            if m.edge_type[k] == EdgeType.ODOMETRY:
                continue
            a = offsets[m.src_robot[k]] + m.src_frame[k]
            b = offsets[m.dst_robot[k]] + m.dst_frame[k]
            if a >= len(pts) or b >= len(pts):
                continue
            w = 1.0 if weights is None else float(weights[k])
            color = (
                "#2ca02c" if w >= 1 - 1e-6
                else "#d62728" if w <= 1e-6
                else "#1f77b4"
            )
            out.append(
                f'<line x1="{sx(pts[a, ax0]):.1f}" y1="{sy(pts[a, ax1]):.1f}" '
                f'x2="{sx(pts[b, ax0]):.1f}" y2="{sy(pts[b, ax1]):.1f}" '
                f'stroke="{color}" stroke-width="0.6" opacity="0.5"/>'
            )
    # per-robot trajectories
    o = 0
    for rid, nk in enumerate(np.asarray(num_poses)):
        seg = pts[o : o + int(nk)]
        o += int(nk)
        path = " ".join(
            f"{'M' if i == 0 else 'L'}{sx(p[ax0]):.1f},{sy(p[ax1]):.1f}"
            for i, p in enumerate(seg)
        )
        c = _ROBOT_COLORS[rid % len(_ROBOT_COLORS)]
        out.append(
            f'<path d="{path}" fill="none" stroke="{c}" stroke-width="1.5"/>'
        )
    out.append("</svg>")
    return "".join(out)


def write_html(
    path: str,
    trajectory: np.ndarray,
    num_poses: Sequence[int],
    measurements: Optional[MeasurementBatch] = None,
    weights: Optional[np.ndarray] = None,
    title: str = "dpgo_ros_tpu solution",
) -> None:
    """Write an HTML visualization of a fleet trajectory (n, d, d+1)."""
    T = np.asarray(trajectory)
    d = T.shape[1]
    panels = [_svg_panel(T, num_poses, measurements, weights, 0, 1, "XY")]
    if d == 3:
        panels.append(_svg_panel(T, num_poses, measurements, weights, 0, 2, "XZ"))
        panels.append(_svg_panel(T, num_poses, measurements, weights, 1, 2, "YZ"))
    legend_robots = "".join(
        f'<span style="color:{_ROBOT_COLORS[r % len(_ROBOT_COLORS)]}">'
        f"&#9632; robot{r}</span>&nbsp;&nbsp;"
        for r in range(len(num_poses))
    )
    html = (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{title}</title></head><body style='font-family:sans-serif'>"
        f"<h3>{title}</h3>"
        f"<p>{legend_robots}<br>"
        "<span style='color:#2ca02c'>&#9632; accepted</span> "
        "<span style='color:#d62728'>&#9632; rejected</span> "
        "<span style='color:#1f77b4'>&#9632; undecided</span> loop closures</p>"
        + "".join(panels)
        + "</body></html>"
    )
    with open(path, "w") as f:
        f.write(html)
