"""Hierarchical span timing — the tracing-forest equivalent.

The reference nests `tracing` spans and prints a timed tree
(bin/src/main.rs:20-27, bench.log:18-70; SURVEY.md §5.1).  This is a
lightweight host-side collector with the same shape: nested spans with wall
time, percent-of-parent, and free-form fields.  Device work is attributed to
the enclosing span only where the spanned code waits for it (the prover's
phases end in host reads of roots and opened values); for kernel-level
detail use torch.profiler alongside.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field


@dataclass
class Span:
    name: str
    fields: dict
    start: float = 0.0
    elapsed: float = 0.0
    children: list = field(default_factory=list)


class _SpanState(threading.local):
    def __init__(self):
        self.stack = []
        self.roots = []
        self.enabled = True


_state = _SpanState()


@contextlib.contextmanager
def span(name: str, **fields):
    s = Span(name=name, fields=fields, start=time.perf_counter())
    parent = _state.stack[-1] if _state.stack else None
    if parent is not None:
        parent.children.append(s)
    else:
        _state.roots.append(s)
    _state.stack.append(s)
    try:
        yield s
    finally:
        s.elapsed = time.perf_counter() - s.start
        _state.stack.pop()


def reset() -> None:
    _state.stack = []
    _state.roots = []


def report(out=None) -> str:
    """Render the collected span forest, tracing-forest style."""
    lines = []

    def fmt_time(t: float) -> str:
        if t >= 1.0:
            return f"{t:.2f}s"
        if t >= 1e-3:
            return f"{t * 1e3:.1f}ms"
        return f"{t * 1e6:.0f}µs"

    def walk(s: Span, prefix: str, parent_elapsed: float | None):
        pct = (
            f" [{100 * s.elapsed / parent_elapsed:5.1f}%]"
            if parent_elapsed
            else ""
        )
        fs = (
            " | " + " ".join(f"{k}: {v}" for k, v in s.fields.items())
            if s.fields
            else ""
        )
        lines.append(f"{prefix}{s.name} [ {fmt_time(s.elapsed)}{pct} ]{fs}")
        for c in s.children:
            walk(c, prefix + "  ", s.elapsed)

    for root in _state.roots:
        walk(root, "", None)
    text = "\n".join(lines)
    if out is not None:
        print(text, file=out)
    return text
