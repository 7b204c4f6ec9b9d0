"""Misc plotting format helpers (ref ``qgs/diagnostics/misc.py:12-60``)."""

from __future__ import annotations

import numpy as np


def _order(n):
    """Order of magnitude of n."""
    if n == 0:
        return 0
    return int(np.floor(np.log10(abs(n))))


def fmt(x, pos=None):
    """Scientific-notation tick formatter (use with
    ``matplotlib.ticker.FuncFormatter``)."""
    a, b = f"{x:.2e}".split("e")
    return rf"${a} \times 10^{{{int(b)}}}$"


def tick_fmt(tl):
    """Format a list of tick labels to a common power of ten."""
    if len(tl) == 0:
        return tl, 0
    mx = max(abs(t) for t in tl)
    if mx == 0:
        return tl, 0
    o = _order(mx)
    return [t / 10 ** o for t in tl], o
