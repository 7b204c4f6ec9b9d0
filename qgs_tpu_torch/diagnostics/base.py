"""
Diagnostics base classes
========================

Post-processing of model trajectories into physical fields and scalar
series (ref ``qgs/diagnostics/base.py:42-720``), on a torch device.

The central operation, reconstructing a field from spectral coefficients,
is one product ``field[t] = sum_i coeff[i, t] * mode_i(x, y)`` over all
time records: a ``torch.matmul`` of the (n_records, nmodes) coefficients by
the (nmodes, ny * nx) mode grids.  The grids are evaluated once on the host
(SymPy, :func:`~qgs_tpu_torch.diagnostics.util.create_grid_basis`) and
uploaded once, in float64, to the diagnostic's device.

Protocol: ``diag(time, data)`` or ``diag.set_data(time, data)`` followed by
``diag.diagnostic``; ``data`` has shape (ndim, n_records) (one trajectory
of the integrators' ``get_trajectories`` output), as a NumPy array or a
tensor on any device.  It is moved to the diagnostic's device in float64,
and the diagnostic is a tensor there: ``device="cuda"`` unless another
device is asked for (``device="cpu"`` for the CPU; without a card the
default raises).  The plots copy to the host only the frames they draw.
"""

from __future__ import annotations

import warnings
from abc import ABC, abstractmethod

import numpy as np
import torch

from qgs_tpu_torch.diagnostics.util import create_grid_basis
from qgs_tpu_torch.plotting.util import to_host


def resolve_device(device):
    """``device`` as a :class:`torch.device` with its index; raises where
    it does not exist (``"cuda"`` without a card)."""
    return torch.empty(0, device=device).device


def nan_extrema(x):
    """``(np.nanmin(x), np.nanmax(x))`` of a tensor, reduced on its
    device."""
    lo, hi = torch.aminmax(x)
    if torch.isnan(lo) or torch.isnan(hi):
        x = x[~torch.isnan(x)]
        if x.numel() == 0:
            return float("nan"), float("nan")
        lo, hi = torch.aminmax(x)
    return float(lo), float(hi)


class Diagnostic(ABC):
    """Base class: holds the model parameters, the trajectory data and a
    cache of the computed diagnostic."""

    _default_points = 100

    def __init__(self, model_params, dimensional=True, device="cuda"):
        self._model_params = model_params
        self.dimensional = dimensional
        self.device = resolve_device(device)
        self._time = None
        self._data = None
        self._diagnostic_data = None
        self._diagnostic_data_dimensional = False
        self._plot_title = ""
        self._plot_units = ""
        self._default_plot_kwargs = {}

    # -- data protocol -----------------------------------------------------

    def _as_data(self, data):
        """``data`` as a float64 tensor on the diagnostic's device, with a
        records axis."""
        data = torch.as_tensor(data).to(device=self.device,
                                        dtype=torch.float64)
        if data.ndim == 1:
            data = data[:, None]
        return data

    def _set_time(self, time):
        self._time = np.atleast_1d(to_host(time))

    def set_data(self, time, data):
        """Provide a trajectory: time (n_records,), data (ndim, n_records)."""
        self._set_time(time)
        self._data = self._as_data(data)
        self._diagnostic_data = None

    def __call__(self, time, data):
        self.set_data(time, data)
        return self.diagnostic

    def set_params(self, model_params, kwargs=None):
        """Attach the diagnostic to a (new) model-parameters object,
        invalidating cached results; ``kwargs`` (same keywords as the
        constructor) reconfigure the instance, on its device unless they
        name another (ref ``qgs/diagnostics/base.py:108-127``)."""
        if kwargs is not None:
            self.__init__(model_params, **{"device": self.device, **kwargs})
        else:
            self._model_params = model_params
        self._diagnostic_data = None

    @property
    def diagnostic(self):
        """The computed diagnostic (cached), a tensor on the device."""
        if self._data is None:
            warnings.warn("no data provided — call set_data first")
            return None
        if (self._diagnostic_data is None
                or self._diagnostic_data_dimensional != self.dimensional):
            self._get_diagnostic(self.dimensional)
        return self._diagnostic_data

    @abstractmethod
    def _get_diagnostic(self, dimensional):
        """Compute and store the diagnostic."""

    @property
    def time(self):
        if self._time is None:
            return None
        if self.dimensional:
            return self._time * self._model_params.dimensional_time
        return self._time

    @property
    def _offset(self):
        return 1 if self._model_params.dynamic_T else 0

    def _to_device(self, array):
        """A host array as a float64 tensor on the diagnostic's device."""
        return torch.as_tensor(np.asarray(array, dtype=np.float64),
                               device=self.device)

    def _reconstruct(self, coeffs, grid_basis):
        """field[t, ...] = sum_i coeffs[i, t] * grid_basis[i, ...]."""
        nt = coeffs.shape[-1]
        gb = grid_basis.reshape(grid_basis.shape[0], -1)
        out = torch.matmul(coeffs.T, gb)
        return out.reshape((nt,) + tuple(grid_basis.shape[1:]))

    @property
    def plot_title(self):
        return self._plot_title

    @property
    def plot_units(self):
        return self._plot_units


class FieldDiagnostic(Diagnostic):
    """Base class for 2-D gridded field diagnostics, with plotting, movie
    and interactive-animation support.  The grid ``X, Y`` stays on the
    host; the mode grids are on the device."""

    def __init__(self, model_params, dimensional=True, device="cuda"):
        Diagnostic.__init__(self, model_params, dimensional, device)
        self._X = None
        self._Y = None
        self._grid_basis = None
        self._orography = None
        self._color_bar_format = True

    def _compute_grid(self, delta_x=None, delta_y=None):
        n = float(self._model_params.scale_params.n)
        Lx, Ly = 2 * np.pi / n, np.pi
        if delta_x is None:
            n_x = self._default_points
        else:
            n_x = int(np.ceil(Lx / delta_x) + 1)
        if delta_y is None:
            n_y = self._default_points
        else:
            n_y = int(np.ceil(Ly / delta_y) + 1)
        x = np.linspace(0., Lx, n_x)
        y = np.linspace(0., Ly, n_y)
        self._X, self._Y = np.meshgrid(x, y)

    def _configure_grid_basis(self, basis, delta_x=None, delta_y=None):
        """Evaluate ``basis`` on the grid and upload it; returns the host
        array."""
        self._compute_grid(delta_x, delta_y)
        grid_basis = create_grid_basis(basis, self._X, self._Y)
        self._grid_basis = self._to_device(grid_basis)
        return grid_basis

    def _set_orography(self, grid_basis):
        """The orography contour, a host array, from the host mode grids."""
        gp = self._model_params.ground_params
        if gp is not None and gp.hk is not None:
            hk = gp.hk.values
            self._orography = np.einsum('i,i...->...', hk,
                                        grid_basis[self._offset:][:len(hk)])

    @property
    def grid(self):
        return self._X, self._Y

    @property
    def grid_shape(self):
        """Shape of the grid covering the model's domain
        (ref ``qgs/diagnostics/base.py:243-247``)."""
        if self._Y is not None:
            return self._Y.shape
        return None

    def __len__(self):
        d = self.diagnostic
        return 0 if d is None else d.shape[0]

    def plot_grid_point(self, i, j, ax=None, figsize=(16, 9), plot_kwargs=None):
        """Plot the time series of the field at grid point (i = x-index,
        j = y-index) (ref ``qgs/diagnostics/base.py:363-410``)."""
        import matplotlib.pyplot as plt

        field = self.diagnostic
        if field is None:
            warnings.warn("No diagnostic data available. Showing nothing.")
            return None
        if ax is None:
            fig = plt.figure(figsize=figsize)
            ax = fig.add_subplot(1, 1, 1)
        t = self.time if self.time is not None else np.arange(field.shape[0])
        ax.plot(t, to_host(field[:, j, i]), **(plot_kwargs or {}))
        ax.set_title(self._plot_title + f" at grid point ({i}, {j})"
                     + self._plot_units, pad=20)
        unit = self._model_params.time_unit if self.dimensional else "timeunits"
        ax.set_xlabel(f"time ({unit})")
        return ax

    # -- plotting ----------------------------------------------------------

    def plot(self, time_index=0, style="image", ax=None, figsize=(16, 9),
             contour_labels=True, color_bar=True, show_time=True,
             plot_kwargs=None, oro_kwargs=None):
        """Plot the field at a given time index.

        ``style``: 'image' (pcolormesh) or 'contour'."""
        import matplotlib.pyplot as plt

        field = self.diagnostic
        if field is None:
            return None
        if ax is None:
            fig = plt.figure(figsize=figsize)
            ax = fig.add_subplot(1, 1, 1)

        pk = dict(self._default_plot_kwargs)
        if plot_kwargs:
            pk.update(plot_kwargs)

        frame = to_host(field[time_index])
        if style == "contour":
            im = ax.contour(self._X, self._Y, frame, **pk)
            if contour_labels:
                ax.clabel(im, fontsize=10)
        else:
            im = ax.pcolormesh(self._X, self._Y, frame, shading='gouraud', **pk)
            if color_bar:
                ax.figure.colorbar(im, ax=ax)

        if self._orography is not None and oro_kwargs is not False:
            ok = {'levels': 6, 'colors': 'k', 'linewidths': 0.8}
            if isinstance(oro_kwargs, dict):
                ok.update(oro_kwargs)
            ax.contour(self._X, self._Y, self._orography, **ok)

        title = self._plot_title
        if show_time and self.time is not None:
            t = self.time[time_index]
            unit = self._model_params.time_unit if self.dimensional else "timeunits"
            title += f" at {t:.2f} {unit}"
        ax.set_title(title + self._plot_units, pad=20)
        ax.set_xlabel("$x$")
        ax.set_ylabel("$y$")
        return ax

    def movie(self, output='html', filename='', writer='ffmpeg', fps=15,
              figsize=(16, 9), plot_kwargs=None, anim_kwargs=None):
        """Render the field evolution as a matplotlib animation.

        ``output``: 'animate' (return the FuncAnimation), 'html'
        (HTML5 video string) or 'save' (write to ``filename``).  The colour
        range is reduced on the device; each frame is copied to the host
        when it is drawn."""
        import matplotlib.pyplot as plt
        from matplotlib.animation import FuncAnimation

        field = self.diagnostic
        fig = plt.figure(figsize=figsize)
        ax = fig.add_subplot(1, 1, 1)
        vmin, vmax = nan_extrema(field)
        pk = dict(self._default_plot_kwargs)
        pk.update({'vmin': vmin, 'vmax': vmax})
        if plot_kwargs:
            pk.update(plot_kwargs)

        im = ax.pcolormesh(self._X, self._Y, to_host(field[0]),
                           shading='gouraud', **pk)
        fig.colorbar(im, ax=ax)
        ax.set_xlabel("$x$")
        ax.set_ylabel("$y$")

        def update(frame):
            im.set_array(to_host(field[frame]).ravel())
            t = self.time[frame] if self.time is not None else frame
            ax.set_title(self._plot_title + f" at {t:.2f}", pad=20)
            return (im,)

        ak = anim_kwargs or {}
        anim = FuncAnimation(fig, update, frames=field.shape[0], blit=False, **ak)
        if output == 'animate':
            return anim
        if output == 'html':
            html = anim.to_html5_video()
            plt.close(fig)
            return html
        if output == 'save':
            anim.save(filename, writer=writer, fps=fps)
            plt.close(fig)
            return filename
        return anim

    def animate(self, output='animate', **kwargs):
        """Interactive animation (ipywidgets if available, else the movie)."""
        try:
            import ipywidgets as widgets
            from IPython.display import display
        except ImportError:
            return self.movie(output='html', **kwargs)

        field = self.diagnostic

        def show(frame):
            self.plot(time_index=frame)

        slider = widgets.IntSlider(min=0, max=field.shape[0] - 1, step=1, value=0)
        return widgets.interactive(show, frame=slider)


class ProfileDiagnostic(Diagnostic):
    """Base class for 1-D profile diagnostics (e.g. zonally averaged)."""

    def __init__(self, model_params, dimensional=True, device="cuda"):
        Diagnostic.__init__(self, model_params, dimensional, device)
        self._points = None
        self._axis_label = ""

    def plot(self, time_index=0, ax=None, figsize=(10, 6), plot_kwargs=None):
        import matplotlib.pyplot as plt

        prof = self.diagnostic
        if ax is None:
            fig = plt.figure(figsize=figsize)
            ax = fig.add_subplot(1, 1, 1)
        ax.plot(self._points, to_host(prof[time_index]), **(plot_kwargs or {}))
        ax.set_title(self._plot_title + self._plot_units)
        ax.set_xlabel(self._axis_label)
        return ax

    def __len__(self):
        d = self.diagnostic
        return 0 if d is None else d.shape[0]

    def movie(self, output='html', filename='', writer='ffmpeg', fps=15,
              figsize=(10, 6), plot_kwargs=None, anim_kwargs=None):
        """Animate the profile over time
        (ref ``qgs/diagnostics/base.py:782-850``)."""
        import matplotlib.pyplot as plt
        from matplotlib.animation import FuncAnimation

        prof = self.diagnostic
        fig = plt.figure(figsize=figsize)
        ax = fig.add_subplot(1, 1, 1)
        line, = ax.plot(self._points, to_host(prof[0]), **(plot_kwargs or {}))
        ax.set_ylim(*nan_extrema(prof))
        ax.set_title(self._plot_title + self._plot_units)
        ax.set_xlabel(self._axis_label)

        def update(frame):
            line.set_ydata(to_host(prof[frame]))
            return (line,)

        anim = FuncAnimation(fig, update, frames=prof.shape[0], blit=False,
                             **(anim_kwargs or {}))
        if output == 'html':
            html = anim.to_html5_video()
            plt.close(fig)
            return html
        if output == 'save':
            anim.save(filename, writer=writer, fps=fps)
            plt.close(fig)
            return filename
        return anim

    def animate(self, output='animate', **kwargs):
        """Interactive animation (ipywidgets if available, else the movie)."""
        try:
            import ipywidgets as widgets
        except ImportError:
            return self.movie(output='html', **kwargs)

        prof = self.diagnostic

        def show(frame):
            self.plot(time_index=frame)

        slider = widgets.IntSlider(min=0, max=prof.shape[0] - 1, step=1, value=0)
        return widgets.interactive(show, frame=slider)


class FieldPointDiagnostic(Diagnostic):
    """Scalar time series of a field value at a grid point: the grid point
    nearest to ``(x, y)`` on the field's host grid."""

    def __init__(self, model_params, x, y, field_diagnostic, dimensional=True,
                 device="cuda"):
        Diagnostic.__init__(self, model_params, dimensional, device)
        self._field = field_diagnostic
        self._x, self._y = x, y

    def set_point_coordinates(self, x, y):
        """Move the probed point; invalidates the cached series
        (ref ``qgs/diagnostics/base.py:185-195``)."""
        self._x, self._y = x, y
        self._diagnostic_data = None

    @property
    def point_coordinates(self):
        """(x, y) coordinates of the probed point."""
        return self._x, self._y

    def _get_diagnostic(self, dimensional):
        self._field.dimensional = dimensional
        self._field.set_data(self._time, self._data)
        field = self._field.diagnostic
        X, Y = self._field.grid
        ix = int(np.abs(X[0, :] - self._x).argmin())
        iy = int(np.abs(Y[:, 0] - self._y).argmin())
        # a copy: the series must not write through to the field's cache
        self._diagnostic_data = field[:, iy, ix].to(self.device, copy=True)
        self._diagnostic_data_dimensional = dimensional
        return self._diagnostic_data
