"""Standalone chart/component DSL + static page renderer.

Capability parity with the reference's `deeplearning4j-ui-components`
module (components/chart/ChartLine.java:37, ChartScatter.java:36,
ChartHistogram.java:36, ChartHorizontalBar.java:31, ChartStackedArea.java:38,
ChartTimeline.java:26, text/ComponentText.java, table/ComponentTable.java,
component/ComponentDiv.java, standalone/StaticPageUtil.java:40-110).

Reference components serialize to JSON and render through FreeMarker +
d3.js templates; here each component serializes to the same
``{"componentType": ..., fields...}`` shape and renders to self-contained
inline SVG/HTML (air-gap friendly, no JS) — the same design the dashboard
(`ui/server.py`) uses. ``render_html``/``save_html`` mirror
StaticPageUtil.renderHTML/saveHTMLFile.
"""

from __future__ import annotations

import html as _html
import json
from typing import Dict, List, Optional, Sequence, Type

_PALETTE = ["#1976d2", "#e53935", "#43a047", "#fb8c00", "#8e24aa",
            "#00897b", "#6d4c41", "#3949ab"]

_REGISTRY: Dict[str, Type["Component"]] = {}


class Component:
    """Base: every component has a ``component_type``, JSON serde, and an
    HTML fragment renderer."""

    component_type = "Component"

    def to_dict(self) -> dict:
        d = {"componentType": self.component_type}
        d.update({k: v for k, v in self.__dict__.items() if v is not None})
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @staticmethod
    def from_dict(d: dict) -> "Component":
        t = d.get("componentType")
        cls = _REGISTRY.get(t)
        if cls is None:
            raise ValueError(f"Unknown componentType {t!r}")
        obj = cls.__new__(cls)
        obj.__dict__.update({k: v for k, v in d.items() if k != "componentType"})
        return obj

    @staticmethod
    def from_json(s: str) -> "Component":
        return Component.from_dict(json.loads(s))

    def render(self) -> str:  # pragma: no cover - abstract
        raise NotImplementedError

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        # abstract intermediates (e.g. _SeriesChart) define no
        # component_type of their own — keep them out of the serde registry
        if "component_type" in cls.__dict__:
            _REGISTRY[cls.component_type] = cls

    def __eq__(self, other):
        return (type(self) is type(other)
                and self.to_dict() == other.to_dict())

    def __hash__(self):
        # value hash over the serialized state: equal components hash equal.
        # Caveat: components are mutable builders — finish building (all
        # add_series/add_bin calls) BEFORE using one as a set/dict key.
        return hash(self.to_json())

    def __repr__(self):
        return f"{type(self).__name__}({self.to_dict()})"


def _axes(xs, ys, w, h, pad):
    x0, x1 = (min(xs), max(xs)) if len(xs) else (0.0, 1.0)
    y0, y1 = (min(ys), max(ys)) if len(ys) else (0.0, 1.0)
    sx = lambda x: pad + (x - x0) / ((x1 - x0) or 1.0) * (w - 2 * pad)
    sy = lambda y: h - pad - (y - y0) / ((y1 - y0) or 1.0) * (h - 2 * pad)
    labels = (
        f'<text x="{pad}" y="{h - 6}" class="ax">{x0:.4g}</text>'
        f'<text x="{w - pad}" y="{h - 6}" class="ax" text-anchor="end">{x1:.4g}</text>'
        f'<text x="4" y="{h - pad}" class="ax">{y0:.4g}</text>'
        f'<text x="4" y="{pad}" class="ax">{y1:.4g}</text>')
    return sx, sy, labels


def _svg(title: str, w: int, h: int, body: str, legend: str = "") -> str:
    return (
        f'<div class="card"><h3>{_html.escape(title or "")}</h3>'
        f'<svg viewBox="0 0 {w} {h}" width="{w}" height="{h}">'
        f'<rect width="{w}" height="{h}" fill="#fafafa" stroke="#ddd"/>'
        f"{body}"
        + (f'<text x="40" y="14" class="ax">{legend}</text>' if legend else "")
        + "</svg></div>")


class _SeriesChart(Component):
    """Shared builder surface for multi-series x/y charts
    (Chart.Builder.addSeries in the reference)."""

    def __init__(self, title: str = ""):
        self.title = title
        self.x: List[List[float]] = []
        self.y: List[List[float]] = []
        self.seriesNames: List[str] = []

    def add_series(self, name: str, x_values: Sequence[float],
                   y_values: Sequence[float]) -> "_SeriesChart":
        if len(x_values) != len(y_values):
            raise ValueError(
                f"series {name!r}: {len(x_values)} x vs {len(y_values)} y values")
        self.x.append([float(v) for v in x_values])
        self.y.append([float(v) for v in y_values])
        self.seriesNames.append(name)
        return self

    def _legend(self) -> str:
        return "".join(
            f'<tspan fill="{_PALETTE[i % len(_PALETTE)]}">&#9632; '
            f"{_html.escape(n)}</tspan> "
            for i, n in enumerate(self.seriesNames))


class ChartLine(_SeriesChart):
    component_type = "ChartLine"

    def render(self, w: int = 640, h: int = 220, pad: int = 42) -> str:
        all_x = [v for s in self.x for v in s]
        all_y = [v for s in self.y for v in s]
        sx, sy, labels = _axes(all_x, all_y, w, h, pad)
        body = []
        for i, (xs, ys) in enumerate(zip(self.x, self.y)):
            pts = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in zip(xs, ys))
            body.append(f'<polyline fill="none" stroke="{_PALETTE[i % len(_PALETTE)]}" '
                        f'stroke-width="1.6" points="{pts}"/>')
        return _svg(self.title, w, h, "".join(body) + labels, self._legend())


class ChartScatter(_SeriesChart):
    component_type = "ChartScatter"

    def render(self, w: int = 640, h: int = 220, pad: int = 42) -> str:
        all_x = [v for s in self.x for v in s]
        all_y = [v for s in self.y for v in s]
        sx, sy, labels = _axes(all_x, all_y, w, h, pad)
        body = []
        for i, (xs, ys) in enumerate(zip(self.x, self.y)):
            c = _PALETTE[i % len(_PALETTE)]
            body.extend(f'<circle cx="{sx(x):.1f}" cy="{sy(y):.1f}" r="2.4" '
                        f'fill="{c}"/>' for x, y in zip(xs, ys))
        return _svg(self.title, w, h, "".join(body) + labels, self._legend())


class ChartStackedArea(_SeriesChart):
    component_type = "ChartStackedArea"

    def add_series(self, name, x_values, y_values):
        # stacking requires one shared x grid across all series
        if self.x and list(x_values) != list(self.x[0]):
            raise ValueError(
                f"stacked series {name!r} must share the first series' x "
                f"grid ({len(self.x[0])} points)")
        return super().add_series(name, x_values, y_values)

    def render(self, w: int = 640, h: int = 220, pad: int = 42) -> str:
        if not self.x:
            return _svg(self.title, w, h, "")
        xs = self.x[0]
        cum = [0.0] * len(xs)
        stacks = []
        for ys in self.y:
            cum = [a + b for a, b in zip(cum, ys)]
            stacks.append(list(cum))
        sx, sy, labels = _axes(xs, [0.0] + stacks[-1], w, h, pad)
        body = []
        prev = [0.0] * len(xs)
        for i, top in enumerate(stacks):
            up = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in zip(xs, top))
            dn = " ".join(f"{sx(x):.1f},{sy(y):.1f}"
                          for x, y in reversed(list(zip(xs, prev))))
            body.append(f'<polygon fill="{_PALETTE[i % len(_PALETTE)]}" '
                        f'fill-opacity="0.65" points="{up} {dn}"/>')
            prev = top
        return _svg(self.title, w, h, "".join(body) + labels, self._legend())


class ChartTimeline(Component):
    """Lanes of [start, end, label] entries (ChartTimeline.java)."""

    component_type = "ChartTimeline"

    def __init__(self, title: str = ""):
        self.title = title
        self.laneNames: List[str] = []
        self.laneData: List[List[dict]] = []

    def add_lane(self, name: str, entries: Sequence[dict]) -> "ChartTimeline":
        """entries: [{"start": t0, "end": t1, "label": ...}, ...]"""
        self.laneNames.append(name)
        self.laneData.append([dict(e) for e in entries])
        return self

    def render(self, w: int = 640, h: Optional[int] = None, pad: int = 42) -> str:
        lanes = len(self.laneData) or 1
        h = h or (40 + 26 * lanes)
        ts = [e[k] for lane in self.laneData for e in lane for k in ("start", "end")]
        t0, t1 = (min(ts), max(ts)) if ts else (0.0, 1.0)
        sx = lambda t: pad + (t - t0) / ((t1 - t0) or 1.0) * (w - 2 * pad)
        body = []
        for li, lane in enumerate(self.laneData):
            y = 24 + 26 * li
            body.append(f'<text x="4" y="{y + 13}" class="ax">'
                        f"{_html.escape(self.laneNames[li])}</text>")
            for ei, e in enumerate(lane):
                x0, x1 = sx(e["start"]), sx(e["end"])
                c = _PALETTE[ei % len(_PALETTE)]
                body.append(f'<rect x="{x0:.1f}" y="{y}" width="{max(x1 - x0, 1):.1f}" '
                            f'height="18" fill="{c}" fill-opacity="0.8"/>')
                if e.get("label"):
                    body.append(f'<text x="{x0 + 2:.1f}" y="{y + 13}" class="ax">'
                                f'{_html.escape(str(e["label"]))}</text>')
        return _svg(self.title, w, h, "".join(body))


class ChartHistogram(Component):
    """Explicit-bin histogram: add_bin(lower, upper, y) (ChartHistogram.java)."""

    component_type = "ChartHistogram"

    def __init__(self, title: str = ""):
        self.title = title
        self.lowerBounds: List[float] = []
        self.upperBounds: List[float] = []
        self.yValues: List[float] = []

    def add_bin(self, lower: float, upper: float, y: float) -> "ChartHistogram":
        self.lowerBounds.append(float(lower))
        self.upperBounds.append(float(upper))
        self.yValues.append(float(y))
        return self

    def render(self, w: int = 640, h: int = 220, pad: int = 42) -> str:
        if not self.yValues:
            return _svg(self.title, w, h, "")
        x0, x1 = min(self.lowerBounds), max(self.upperBounds)
        ymax = max(self.yValues) or 1.0
        sx = lambda x: pad + (x - x0) / ((x1 - x0) or 1.0) * (w - 2 * pad)
        body = []
        for lo, hi, y in zip(self.lowerBounds, self.upperBounds, self.yValues):
            bh = (h - 2 * pad) * y / ymax
            body.append(f'<rect x="{sx(lo):.1f}" y="{h - pad - bh:.1f}" '
                        f'width="{max(sx(hi) - sx(lo) - 1, 1):.1f}" '
                        f'height="{bh:.1f}" fill="#1976d2"/>')
        labels = (f'<text x="{pad}" y="{h - 6}" class="ax">{x0:.4g}</text>'
                  f'<text x="{w - pad}" y="{h - 6}" class="ax" '
                  f'text-anchor="end">{x1:.4g}</text>')
        return _svg(self.title, w, h, "".join(body) + labels)


class ChartHorizontalBar(Component):
    component_type = "ChartHorizontalBar"

    def __init__(self, title: str = ""):
        self.title = title
        self.labels: List[str] = []
        self.values: List[float] = []

    def add_value(self, label: str, value: float) -> "ChartHorizontalBar":
        self.labels.append(label)
        self.values.append(float(value))
        return self

    def render(self, w: int = 640, h: Optional[int] = None, pad: int = 90) -> str:
        n = len(self.values) or 1
        h = h or (30 + 24 * n)
        vmax = max([abs(v) for v in self.values] or [1.0]) or 1.0
        body = []
        for i, (lab, v) in enumerate(zip(self.labels, self.values)):
            y = 18 + 24 * i
            bw = (w - pad - 20) * abs(v) / vmax
            body.append(f'<text x="4" y="{y + 12}" class="ax">'
                        f"{_html.escape(lab)}</text>")
            body.append(f'<rect x="{pad}" y="{y}" width="{bw:.1f}" height="16" '
                        f'fill="{_PALETTE[i % len(_PALETTE)]}"/>')
            body.append(f'<text x="{pad + bw + 4:.1f}" y="{y + 12}" class="ax">'
                        f"{v:.4g}</text>")
        return _svg(self.title, w, h, "".join(body))


class ComponentText(Component):
    component_type = "ComponentText"

    def __init__(self, text: str = ""):
        self.text = text

    def render(self) -> str:
        return f"<p>{_html.escape(self.text)}</p>"


class ComponentTable(Component):
    component_type = "ComponentTable"

    def __init__(self, header: Optional[Sequence[str]] = None,
                 content: Optional[Sequence[Sequence[str]]] = None):
        self.header = list(header) if header else []
        self.content = [list(r) for r in content] if content else []

    def render(self) -> str:
        head = "".join(f"<th>{_html.escape(str(c))}</th>" for c in self.header)
        rows = "".join(
            "<tr>" + "".join(f"<td>{_html.escape(str(c))}</td>" for c in r) + "</tr>"
            for r in self.content)
        return f"<table><tr>{head}</tr>{rows}</table>"


class ComponentDiv(Component):
    """Container grouping child components (ComponentDiv.java)."""

    component_type = "ComponentDiv"

    def __init__(self, *children: Component):
        self.components = [c.to_dict() for c in children]

    def children(self) -> List[Component]:
        return [Component.from_dict(d) for d in self.components]

    def render(self) -> str:
        return ("<div>" + "".join(c.render() for c in self.children())
                + "</div>")


_CSS = """
body { font-family: system-ui, sans-serif; margin: 20px; color: #222; }
h3 { font-size: 13px; margin: 6px 0; }
.card { display: inline-block; margin: 8px; vertical-align: top; }
.ax { font-size: 9px; fill: #666; }
table { border-collapse: collapse; font-size: 12px; margin: 8px; }
td, th { border: 1px solid #ccc; padding: 3px 8px; }
p { max-width: 640px; }
"""


def render_html(*components: Component, title: str = "deeplearning4j_tpu") -> str:
    """StaticPageUtil.renderHTML parity: one self-contained HTML page."""
    if len(components) == 1 and isinstance(components[0], (list, tuple)):
        components = tuple(components[0])
    body = "\n".join(c.render() for c in components)
    return (f"<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{_html.escape(title)}</title><style>{_CSS}</style></head>"
            f"<body>{body}</body></html>")


def save_html(path: str, *components: Component,
              title: str = "deeplearning4j_tpu") -> None:
    """StaticPageUtil.saveHTMLFile parity."""
    with open(path, "w", encoding="utf-8") as f:
        f.write(render_html(*components, title=title))


def reliability_chart(calibration, cls: int = 0) -> ChartLine:
    """Reliability diagram as a ChartLine (the reference UI's calibration
    page capability, rendered through this module's DSL): predicted
    probability vs observed frequency for one class, plus the y=x ideal."""
    mean_pred, frac_pos = calibration.reliability_diagram(cls)
    counts = calibration.rel_count[cls]
    chart = ChartLine(f"Reliability (class {cls})")
    chart.add_series("ideal", [0.0, 1.0], [0.0, 1.0])
    # empty bins report (0, 0) — plotting them would zigzag the polyline
    # back to the origin mid-curve
    chart.add_series("observed",
                     [float(p) for p, c in zip(mean_pred, counts) if c > 0],
                     [float(f) for f, c in zip(frac_pos, counts) if c > 0])
    return chart
