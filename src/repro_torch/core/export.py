"""SNN2SDF-style export (the paper's companion tool, ref [58]): dump a
(hardware-aware) SDFG to Graphviz dot / JSON for inspection.  Host only;
the text is the reference's ``repro.core.export`` character for
character."""

from __future__ import annotations

import json

from .sdfg import SDFG


def to_dot(g: SDFG, *, max_actors: int = 200) -> str:
    """Graphviz dot of the SDFG (port rates + initial tokens annotated)."""
    lines = [f'digraph "{g.name}" {{', "  rankdir=LR;", "  node [shape=circle];"]
    n = min(g.n_actors, max_actors)
    for i in range(n):
        lines.append(
            f'  a{i} [label="actor_{i}\\nt={g.exec_time[i]:.2f}"];'
        )
    for ch in g.channels:
        if ch.src >= n or ch.dst >= n or ch.kind == "self":
            continue
        style = {
            "data": "solid",
            "buffer": "dashed",
            "order": "dotted",
        }.get(ch.kind, "solid")
        label = f"{ch.rate:.0f}"
        if ch.tokens:
            label += f" / {ch.tokens}t"
        lines.append(
            f'  a{ch.src} -> a{ch.dst} [label="{label}", style={style}];'
        )
    lines.append("}")
    return "\n".join(lines)


def to_json(g: SDFG) -> str:
    """Machine-readable SDFG (round-trips through from_json)."""
    return json.dumps(
        {
            "name": g.name,
            "n_actors": g.n_actors,
            "exec_time": [float(t) for t in g.exec_time],
            "channels": [
                {
                    "src": c.src, "dst": c.dst, "tokens": c.tokens,
                    "rate": c.rate, "delay": c.delay, "kind": c.kind,
                }
                for c in g.channels
            ],
        }
    )


def from_json(text: str) -> SDFG:
    import numpy as np

    from .sdfg import Channel

    d = json.loads(text)
    g = SDFG(
        n_actors=d["n_actors"],
        exec_time=np.asarray(d["exec_time"]),
        channels=[Channel(**c) for c in d["channels"]],
        name=d["name"],
    )
    g.validate()
    return g
