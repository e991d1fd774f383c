"""Circuit layout rendering (halo2 `dev::CircuitLayout` equivalent).

The reference's 6 `print_*` tests render region/row/column occupancy to
`prints/*.png` via plotters (e.g. src/circuits/inclusion_check.rs:123-148,
merkle_sum_tree.rs:362-383).  This renders the same spatial profile — column
kinds on the x axis (fixed | advice | instance, halo2's ordering), rows on
the y axis, one shaded labelled rectangle per region bounding box, darker
marks for individually assigned cells and enabled selectors, and the usable-
rows boundary — as a deterministic standalone SVG, which doubles as a golden
artifact (byte-stable across runs, diffable in review).
"""

from __future__ import annotations

from ..plonkish.assignment import run_synthesis
from ..plonkish.column import Column, Selector

# halo2's CircuitLayout palette (approximate): regions blue, advice red-ish,
# fixed dark-blue, instance white/grey, selectors green.
_KIND_FILL = {"fixed": "#d0d8ef", "advice": "#f7dcdc", "instance": "#e8e8e8"}
_CELL_FILL = {"fixed": "#3555b5", "advice": "#c23b3b", "instance": "#777777"}
_SELECTOR_FILL = "#2e8b57"
_REGION_FILL = "#3b6fc9"


class CircuitLayout:
    """Render a circuit's floor plan to SVG.

    Mirrors `halo2_proofs::dev::CircuitLayout::default().render(k, circuit,
    root)`; `show_labels` matches halo2's default of labelling regions.
    """

    def __init__(self, show_labels: bool = True, cell: int = 10):
        self.show_labels = show_labels
        self.cell = cell

    def render(self, k: int, circuit, path: str, F=None, title: str | None = None) -> str:
        cs, _cfg, assignment = run_synthesis(circuit, k, [], witness=False, field=F)
        # placement only — halo2's renderer draws circuits that overflow the
        # requested k (rows past n are simply drawn below the usable line)
        region_starts, _cc, _cp = assignment.place()
        usable = cs.usable_rows(1 << k)
        n = 1 << k
        max_row = max(
            (s + d.rows for s, d in zip(region_starts, assignment.regions)),
            default=0,
        )
        n = max(n, max_row)
        c = self.cell

        # halo2 column order: fixed, advice, instance; selectors are drawn as
        # extra fixed-kind columns on the right of the fixed block.
        col_x: dict = {}
        order = []
        x = 0
        for i in range(cs.num_fixed):
            col_x[("fixed", i)] = x
            order.append(("fixed", i))
            x += 1
        for i in range(cs.num_selectors):
            col_x[("selector", i)] = x
            order.append(("selector", i))
            x += 1
        for i in range(cs.num_advice):
            col_x[("advice", i)] = x
            order.append(("advice", i))
            x += 1
        for i in range(cs.num_instance):
            col_x[("instance", i)] = x
            order.append(("instance", i))
            x += 1
        ncols = x

        left, top = 40, 30 if title else 10
        width = left + ncols * c + 10
        height = top + n * c + 20

        out = []
        out.append(
            f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
            f'height="{height}" font-family="sans-serif">'
        )
        out.append(f'<rect width="{width}" height="{height}" fill="white"/>')
        if title:
            out.append(
                f'<text x="{width // 2}" y="20" text-anchor="middle" '
                f'font-size="14">{_esc(title)}</text>'
            )

        # column background stripes by kind
        for kind, i in order:
            fill = _KIND_FILL["fixed" if kind == "selector" else kind]
            cx = left + col_x[(kind, i)] * c
            out.append(
                f'<rect x="{cx}" y="{top}" width="{c}" height="{n * c}" '
                f'fill="{fill}" stroke="#bbbbbb" stroke-width="0.5"/>'
            )

        # region bounding boxes
        for data, start in zip(assignment.regions, region_starts):
            xs = []
            for col in data.columns:
                key = _col_key(col)
                if key in col_x:
                    xs.append(col_x[key])
            if not xs or data.rows == 0:
                continue
            rx = left + min(xs) * c
            rw = (max(xs) - min(xs) + 1) * c
            ry = top + start * c
            rh = data.rows * c
            out.append(
                f'<rect x="{rx}" y="{ry}" width="{rw}" height="{rh}" '
                f'fill="{_REGION_FILL}" fill-opacity="0.25" '
                f'stroke="{_REGION_FILL}" stroke-width="1"/>'
            )
            if self.show_labels:
                out.append(
                    f'<text x="{rx + 2}" y="{ry + 9}" font-size="7" '
                    f'fill="#1a2f63">{_esc(data.name)}</text>'
                )

        # individually assigned cells + enabled selectors
        for data, start in zip(assignment.regions, region_starts):
            for (col, off) in sorted(
                data.cells, key=lambda t: (t[0].kind.value, t[0].index, t[1])
            ):
                key = _col_key(col)
                cx = left + col_x[key] * c
                cy = top + (start + off) * c
                out.append(
                    f'<rect x="{cx + 1}" y="{cy + 1}" width="{c - 2}" '
                    f'height="{c - 2}" fill="{_CELL_FILL[col.kind.value]}" '
                    f'fill-opacity="0.8"/>'
                )
            for sel, off in data.enabled_selectors:
                cx = left + col_x[("selector", sel.index)] * c
                cy = top + (start + off) * c
                out.append(
                    f'<rect x="{cx + 1}" y="{cy + 1}" width="{c - 2}" '
                    f'height="{c - 2}" fill="{_SELECTOR_FILL}" '
                    f'fill-opacity="0.8"/>'
                )

        # usable-rows boundary (l_last; blinding rows below)
        uy = top + usable * c
        out.append(
            f'<line x1="{left}" y1="{uy}" x2="{left + ncols * c}" y2="{uy}" '
            f'stroke="#cc0000" stroke-width="1" stroke-dasharray="4,2"/>'
        )

        # row-index ticks every 2^max(0,k-4) rows
        step = max(1, n // 16)
        for r in range(0, n + 1, step):
            out.append(
                f'<text x="{left - 4}" y="{top + r * c + 7}" font-size="7" '
                f'text-anchor="end" fill="#444444">{r}</text>'
            )
        out.append("</svg>")
        svg = "\n".join(out) + "\n"
        if path:
            with open(path, "w") as f:
                f.write(svg)
        return svg


def _col_key(col):
    if isinstance(col, Selector):
        return ("selector", col.index)
    assert isinstance(col, Column)
    return (col.kind.value, col.index)


def _esc(s: str) -> str:
    return s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
