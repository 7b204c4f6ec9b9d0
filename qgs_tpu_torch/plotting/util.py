"""Plotting utilities (ref ``qgs/plotting/util.py:12-43``)."""

from __future__ import annotations

import numpy as np
import torch


def to_host(x):
    """A tensor (on any device) or an array as a NumPy array, for
    matplotlib."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def std_plot(x, mean, std, ax=None, **kwargs):
    """Plot a mean curve with a +/- 1 std shaded band; ``x``, ``mean`` and
    ``std`` may be arrays or tensors on any device (copied to the host for
    matplotlib)."""
    import matplotlib.pyplot as plt

    x, mean, std = to_host(x), to_host(mean), to_host(std)
    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(1, 1, 1)
    line, = ax.plot(x, mean, **kwargs)
    color = line.get_color()
    ax.fill_between(x, mean - std, mean + std, color=color, alpha=0.2)
    return ax
