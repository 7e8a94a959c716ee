"""Report rendering: a logical report tree rendered to HTML or text.

A host-Python copy of ``photon_ml_tpu/diagnostics/reporting.py`` (numpy).

Reference analog: photon-diagnostics reporting/ (~35 files: LogicalReport ->
LogicalToPhysicalReportTransformer -> HTML (xml literals) and text
renderers, with chapters/sections/simple text/bulleted+numbered lists and
a NumberingContext). Collapsed here to one module: the report IS the
logical tree (Document > Chapter > Section > items), and render_html /
render_text walk it with hierarchical numbering. Plots are rendered as
inline SVG line charts (the "light-plot" PlotUtils analog) — no image
dependencies.
"""

from __future__ import annotations

import dataclasses
import html as _html
from typing import Sequence, Union

Item = Union["Section", "Text", "BulletedList", "NumberedList", "Table", "LinePlot"]


@dataclasses.dataclass
class Text:
    text: str


@dataclasses.dataclass
class BulletedList:
    items: Sequence[str]


@dataclasses.dataclass
class NumberedList:
    items: Sequence[str]


@dataclasses.dataclass
class Table:
    header: Sequence[str]
    rows: Sequence[Sequence[object]]
    caption: str = ""


@dataclasses.dataclass
class LinePlot:
    """Simple multi-series line plot (PlotUtils/PlotPhysicalReport analog)."""

    x: Sequence[float]
    series: dict[str, Sequence[float]]  # name -> y values
    title: str = ""
    x_label: str = ""
    y_label: str = ""


@dataclasses.dataclass
class Section:
    title: str
    items: Sequence[Item] = ()


@dataclasses.dataclass
class Chapter:
    title: str
    sections: Sequence[Section] = ()


@dataclasses.dataclass
class Document:
    title: str
    chapters: Sequence[Chapter] = ()


# ---------------------------------------------------------------------------
# text renderer (reporting/text analog)
# ---------------------------------------------------------------------------


def render_text(doc: Document) -> str:
    out: list[str] = [doc.title, "=" * len(doc.title), ""]
    for ci, ch in enumerate(doc.chapters, 1):
        out.append(f"{ci}. {ch.title}")
        out.append("-" * (len(ch.title) + 4))
        for si, sec in enumerate(ch.sections, 1):
            out.append(f"{ci}.{si} {sec.title}")
            for item in sec.items:
                out.extend(_text_item(item))
            out.append("")
    return "\n".join(out)


def _text_item(item: Item) -> list[str]:
    if isinstance(item, Text):
        return [item.text]
    if isinstance(item, BulletedList):
        return [f"  * {x}" for x in item.items]
    if isinstance(item, NumberedList):
        return [f"  {i}. {x}" for i, x in enumerate(item.items, 1)]
    if isinstance(item, Table):
        widths = [
            max(len(str(h)), *(len(str(r[j])) for r in item.rows)) if item.rows
            else len(str(h))
            for j, h in enumerate(item.header)
        ]
        fmt = "  ".join(f"{{:<{w}}}" for w in widths)
        lines = []
        if item.caption:
            lines.append(item.caption)
        lines.append(fmt.format(*[str(h) for h in item.header]))
        lines.extend(fmt.format(*[str(c) for c in r]) for r in item.rows)
        return lines
    if isinstance(item, LinePlot):
        lines = [f"[plot] {item.title} ({item.x_label} vs {item.y_label})"]
        for name, ys in item.series.items():
            pts = ", ".join(f"({x:.3g}, {y:.4g})" for x, y in zip(item.x, ys))
            lines.append(f"  {name}: {pts}")
        return lines
    if isinstance(item, Section):
        return [item.title] + [l for it in item.items for l in _text_item(it)]
    raise TypeError(f"unknown report item {type(item).__name__}")


# ---------------------------------------------------------------------------
# HTML renderer (reporting/html analog)
# ---------------------------------------------------------------------------


def render_html(doc: Document) -> str:
    body: list[str] = [f"<h1>{_html.escape(doc.title)}</h1>"]
    for ci, ch in enumerate(doc.chapters, 1):
        body.append(f"<h2>{ci}. {_html.escape(ch.title)}</h2>")
        for si, sec in enumerate(ch.sections, 1):
            body.append(f"<h3>{ci}.{si} {_html.escape(sec.title)}</h3>")
            for item in sec.items:
                body.append(_html_item(item))
    return (
        "<!DOCTYPE html><html><head><meta charset='utf-8'>"
        f"<title>{_html.escape(doc.title)}</title>"
        "<style>body{font-family:sans-serif;margin:2em}"
        "table{border-collapse:collapse}td,th{border:1px solid #999;"
        "padding:4px 8px}</style></head><body>"
        + "".join(body)
        + "</body></html>"
    )


def _html_item(item: Item) -> str:
    if isinstance(item, Text):
        return f"<p>{_html.escape(item.text)}</p>"
    if isinstance(item, BulletedList):
        lis = "".join(f"<li>{_html.escape(str(x))}</li>" for x in item.items)
        return f"<ul>{lis}</ul>"
    if isinstance(item, NumberedList):
        lis = "".join(f"<li>{_html.escape(str(x))}</li>" for x in item.items)
        return f"<ol>{lis}</ol>"
    if isinstance(item, Table):
        head = "".join(f"<th>{_html.escape(str(h))}</th>" for h in item.header)
        rows = "".join(
            "<tr>" + "".join(f"<td>{_html.escape(str(c))}</td>" for c in r) + "</tr>"
            for r in item.rows
        )
        cap = f"<caption>{_html.escape(item.caption)}</caption>" if item.caption else ""
        return f"<table>{cap}<tr>{head}</tr>{rows}</table>"
    if isinstance(item, LinePlot):
        return _svg_line_plot(item)
    if isinstance(item, Section):
        inner = "".join(_html_item(it) for it in item.items)
        return f"<h4>{_html.escape(item.title)}</h4>{inner}"
    raise TypeError(f"unknown report item {type(item).__name__}")


_PALETTE = ["#1f77b4", "#d62728", "#2ca02c", "#9467bd", "#ff7f0e", "#8c564b"]


def _svg_line_plot(p: LinePlot, width: int = 480, height: int = 300) -> str:
    xs = list(map(float, p.x))
    all_y = [float(y) for ys in p.series.values() for y in ys]
    if not xs or not all_y:
        return f"<p>[empty plot {_html.escape(p.title)}]</p>"
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(all_y), max(all_y)
    xr = (x1 - x0) or 1.0
    yr = (y1 - y0) or 1.0
    m = 40  # margin

    def sx(x):
        return m + (x - x0) / xr * (width - 2 * m)

    def sy(y):
        return height - m - (y - y0) / yr * (height - 2 * m)

    parts = [
        f"<svg width='{width}' height='{height}' "
        "xmlns='http://www.w3.org/2000/svg'>",
        f"<text x='{width // 2}' y='16' text-anchor='middle' "
        f"font-size='13'>{_html.escape(p.title)}</text>",
        f"<line x1='{m}' y1='{height - m}' x2='{width - m}' "
        f"y2='{height - m}' stroke='#333'/>",
        f"<line x1='{m}' y1='{m}' x2='{m}' y2='{height - m}' stroke='#333'/>",
        f"<text x='{width // 2}' y='{height - 8}' text-anchor='middle' "
        f"font-size='11'>{_html.escape(p.x_label)}</text>",
        f"<text x='12' y='{height // 2}' font-size='11' "
        f"transform='rotate(-90 12 {height // 2})' "
        f"text-anchor='middle'>{_html.escape(p.y_label)}</text>",
        f"<text x='{m}' y='{height - m + 14}' font-size='10'>{x0:.3g}</text>",
        f"<text x='{width - m}' y='{height - m + 14}' font-size='10' "
        f"text-anchor='end'>{x1:.3g}</text>",
        f"<text x='{m - 4}' y='{height - m}' font-size='10' "
        f"text-anchor='end'>{y0:.3g}</text>",
        f"<text x='{m - 4}' y='{m + 4}' font-size='10' text-anchor='end'>"
        f"{y1:.3g}</text>",
    ]
    for i, (name, ys) in enumerate(p.series.items()):
        color = _PALETTE[i % len(_PALETTE)]
        pts = " ".join(f"{sx(x):.1f},{sy(float(y)):.1f}" for x, y in zip(xs, ys))
        parts.append(
            f"<polyline points='{pts}' fill='none' stroke='{color}' "
            "stroke-width='1.5'/>"
        )
        parts.append(
            f"<text x='{width - m + 4}' y='{m + 14 * i}' font-size='10' "
            f"fill='{color}'>{_html.escape(name)}</text>"
        )
    parts.append("</svg>")
    return "".join(parts)
