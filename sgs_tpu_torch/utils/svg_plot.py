"""Histograms and curves as plain SVG files, for `analyze_model` (the card's
machine has no matplotlib).

Each file carries the data it plots as JSON in its `<metadata>` element,
so the data, not the picture, can be checked (`read_plot_data`).
"""

from __future__ import annotations

import json
from typing import Sequence
from xml.sax.saxutils import escape

import numpy as np

W, H, MARGIN = 640, 480, 60


def _frame(title: str, xlabel: str, ylabel: str, data: dict, body: str, x_range, y_range) -> str:
    (x0, x1), (y0, y1) = x_range, y_range
    ticks = (
        f'<text x="{MARGIN}" y="{H - MARGIN + 18}" font-size="11">{x0:.4g}</text>'
        f'<text x="{W - MARGIN}" y="{H - MARGIN + 18}" font-size="11" text-anchor="end">{x1:.4g}</text>'
        f'<text x="{MARGIN - 6}" y="{H - MARGIN}" font-size="11" text-anchor="end">{y0:.4g}</text>'
        f'<text x="{MARGIN - 6}" y="{MARGIN + 4}" font-size="11" text-anchor="end">{y1:.4g}</text>')
    return (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{W}" height="{H}" viewBox="0 0 {W} {H}">\n'
        f"<metadata>{escape(json.dumps(data))}</metadata>\n"
        f'<rect width="{W}" height="{H}" fill="white"/>\n'
        f'<text x="{W / 2}" y="{MARGIN / 2}" font-size="14" text-anchor="middle">{escape(title)}</text>\n'
        f'<text x="{W / 2}" y="{H - 15}" font-size="12" text-anchor="middle">{escape(xlabel)}</text>\n'
        f'<text x="15" y="{H / 2}" font-size="12" text-anchor="middle" '
        f'transform="rotate(-90 15 {H / 2})">{escape(ylabel)}</text>\n'
        f'<path d="M{MARGIN} {MARGIN} V{H - MARGIN} H{W - MARGIN}" stroke="black" fill="none"/>\n'
        f"{ticks}\n{body}</svg>\n"
    )


def _scale(v, lo, hi, a, b):
    return a + (np.asarray(v, np.float64) - lo) / ((hi - lo) or 1.0) * (b - a)


def histogram_svg(path: str, values: np.ndarray, bins: int = 20, cumulative: bool = False,
                  xlabel: str = "", ylabel: str = "", title: str = "") -> dict:
    """`np.histogram(values, bins)` (cumulated if `cumulative`, as
    matplotlib's `hist(cumulative=True)`) drawn as bars; returns the data."""
    counts, edges = np.histogram(np.asarray(values), bins=bins)
    if cumulative:
        counts = np.cumsum(counts)
    data = {"kind": "histogram", "counts": counts.tolist(), "edges": edges.tolist()}
    top = float(counts.max()) if counts.size else 1.0
    xs = _scale(edges, edges[0], edges[-1], MARGIN, W - MARGIN)
    hs = _scale(counts, 0.0, top, 0.0, H - 2 * MARGIN)
    body = "".join(f'<rect x="{xs[i]:.2f}" y="{H - MARGIN - hs[i]:.2f}" width="{xs[i + 1] - xs[i]:.2f}" '
                   f'height="{hs[i]:.2f}" fill="#1f77b4" stroke="white"/>\n' for i in range(len(counts)))
    with open(path, "w") as f:
        f.write(_frame(title, xlabel, ylabel, data, body, (edges[0], edges[-1]), (0.0, top)))
    return data


def curve_svg(path: str, xs: Sequence[float], ys: Sequence[float], title: str = "", xlabel: str = "",
              ylabel: str = "") -> dict:
    """A line with a marker at each point; returns the data."""
    xs, ys = np.asarray(xs, np.float64), np.asarray(ys, np.float64)
    data = {"kind": "curve", "x": xs.tolist(), "y": ys.tolist()}
    xr = (float(xs.min()), float(xs.max()))
    yr = (min(0.0, float(ys.min())), float(ys.max()))
    px = _scale(xs, *xr, MARGIN, W - MARGIN)
    py = _scale(ys, *yr, H - MARGIN, MARGIN)
    points = " ".join(f"{a:.2f},{b:.2f}" for a, b in zip(px, py))
    body = (f'<polyline points="{points}" fill="none" stroke="#1f77b4"/>\n'
            + "".join(f'<circle cx="{a:.2f}" cy="{b:.2f}" r="2" fill="#1f77b4"/>\n' for a, b in zip(px, py)))
    with open(path, "w") as f:
        f.write(_frame(title, xlabel, ylabel, data, body, xr, yr))
    return data


def read_plot_data(path: str) -> dict:
    """The data a plot of this module carries."""
    from xml.sax.saxutils import unescape

    text = open(path).read()
    start = text.index("<metadata>") + len("<metadata>")
    return json.loads(unescape(text[start:text.index("</metadata>")]))
