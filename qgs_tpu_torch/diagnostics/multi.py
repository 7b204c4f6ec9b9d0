"""
Multi-diagnostics
=================

Grid-composited dashboards of several diagnostics sharing one dataset, with
joint plot / movie (ref ``qgs/diagnostics/multi.py:19-1003``), and a
broadcasting list wrapper.  The diagnostics' outputs stay tensors on
their devices; the plots copy the frames they draw to the host.
"""

from __future__ import annotations

from qgs_tpu_torch.diagnostics.base import FieldDiagnostic, ProfileDiagnostic


class MultiDiagnostic:
    """Hold several diagnostics on an (nrows x ncols) figure grid with
    shared trajectory data."""

    def __init__(self, nrows, ncols):
        self._nrows = nrows
        self._ncols = ncols
        self._diagnostics = []
        self._positions = []
        self._plot_kwargs = []
        self._time = None
        self._data = None

    def add_diagnostic(self, diagnostic, position=None, diagnostic_kwargs=None,
                       plot_kwargs=None):
        """Register a diagnostic at a (row, col) grid position."""
        if position is None:
            position = divmod(len(self._diagnostics), self._ncols)
        self._diagnostics.append(diagnostic)
        self._positions.append(position)
        self._plot_kwargs.append(plot_kwargs or {})
        if self._data is not None:
            diagnostic.set_data(self._time, self._data)

    @property
    def diagnostics(self):
        return self._diagnostics

    # -- reference-parity accessors (ref ``qgs/diagnostics/multi.py:67-116``)

    @property
    def nrows(self):
        """int: number of rows of the plotting grid."""
        return self._nrows

    @property
    def ncols(self):
        """int: number of columns of the plotting grid."""
        return self._ncols

    @property
    def diagnostic(self):
        """list: the output of every stored diagnostic."""
        return [d.diagnostic for d in self._diagnostics]

    @property
    def diagnostics_list(self):
        """list: the stored diagnostics."""
        return self._diagnostics

    @property
    def diagnostic_positions(self):
        """list(tuple): grid position occupied by each diagnostic."""
        return self._positions

    def __len__(self):
        return self._nrows * self._ncols

    def set_data(self, time, data):
        self._time = time
        self._data = data
        for d in self._diagnostics:
            d.set_data(time, data)

    def __call__(self, time, data):
        self.set_data(time, data)
        return [d.diagnostic for d in self._diagnostics]

    def plot(self, time_index=0, figsize=(16, 9)):
        """Plot every diagnostic on its grid cell."""
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=figsize)
        axes = []
        for diag, pos, pk in zip(self._diagnostics, self._positions,
                                 self._plot_kwargs):
            ax = fig.add_subplot(self._nrows, self._ncols,
                                 pos[0] * self._ncols + pos[1] + 1)
            if isinstance(diag, FieldDiagnostic):
                diag.plot(time_index=time_index, ax=ax, plot_kwargs=pk)
            elif isinstance(diag, ProfileDiagnostic):
                diag.plot(time_index=time_index, ax=ax, plot_kwargs=pk)
            else:
                diag.plot(ax=ax, plot_kwargs=pk)
            axes.append(ax)
        fig.tight_layout()
        return fig, axes

    def movie(self, output='html', filename='', writer='ffmpeg', fps=15,
              figsize=(16, 9)):
        """Joint animation of all field diagnostics."""
        import matplotlib.pyplot as plt
        from matplotlib.animation import FuncAnimation

        fields = [d for d in self._diagnostics if isinstance(d, FieldDiagnostic)]
        n_frames = min(d.diagnostic.shape[0] for d in fields) if fields else 0

        fig, axes = self.plot(time_index=0, figsize=figsize)

        def update(frame):
            for ax in axes:
                ax.clear()
            for diag, ax, pk in zip(self._diagnostics, axes, self._plot_kwargs):
                if isinstance(diag, FieldDiagnostic):
                    diag.plot(time_index=frame, ax=ax, color_bar=False,
                              plot_kwargs=pk)
            return axes

        anim = FuncAnimation(fig, update, frames=n_frames, blit=False)
        if output == 'html':
            html = anim.to_html5_video()
            plt.close(fig)
            return html
        if output == 'save':
            anim.save(filename, writer=writer, fps=fps)
            plt.close(fig)
            return filename
        return anim

    def animate(self, **kwargs):
        try:
            import ipywidgets as widgets
        except ImportError:
            return self.movie(**kwargs)

        fields = [d for d in self._diagnostics if isinstance(d, FieldDiagnostic)]
        n_frames = min(d.diagnostic.shape[0] for d in fields) if fields else 1

        def show(frame):
            self.plot(time_index=frame)

        return widgets.interactive(show, frame=widgets.IntSlider(
            min=0, max=n_frames - 1, step=1, value=0))


class FieldsDiagnosticsList:
    """Plot several diagnostics on a single axes, each possibly fed its own
    dataset (ref ``qgs/diagnostics/multi.py:506-965``).  ``set_data`` with
    ``index=None`` broadcasts to all diagnostics."""

    def __init__(self, diagnostics=None, diagnostics_list=None):
        diagnostics = diagnostics if diagnostics is not None else diagnostics_list
        self._diagnostics = list(diagnostics) if diagnostics else []

    def append(self, diagnostic):
        self._diagnostics.append(diagnostic)

    def append_diagnostic(self, diagnostic):
        """Add a diagnostic to the list (reference-parity alias)."""
        self.append(diagnostic)

    @property
    def diagnostics_list(self):
        return self._diagnostics

    def __getitem__(self, i):
        return self._diagnostics[i]

    def __len__(self):
        """Smallest number of records across the stored diagnostics
        (ref ``multi.py:536-544``)."""
        lengths = [len(d) for d in self._diagnostics]
        return min(lengths) if lengths else 0

    def set_data(self, time, data, index=None):
        """Feed data to the ``index``-th diagnostic, or to all when
        ``index`` is None."""
        if index is None:
            for d in self._diagnostics:
                d.set_data(time, data)
        else:
            self._diagnostics[index].set_data(time, data)

    def __call__(self, time, data, index=None):
        self.set_data(time, data, index)
        return [d.diagnostic for d in self._diagnostics]

    @staticmethod
    def _broadcast(value, n):
        if isinstance(value, (list, tuple)):
            return list(value)
        return n * [value]

    def plot(self, time_index=0, style="image", ax=None, figsize=(16, 9),
             contour_labels=True, color_bar=True, show_time=True,
             plot_kwargs=None, oro_kwargs=None):
        """Plot every diagnostic on a single axes; per-diagnostic options may
        be given as lists (ref ``multi.py:569-640``)."""
        import matplotlib.pyplot as plt

        n = len(self._diagnostics)
        time_index = self._broadcast(time_index, n)
        style = self._broadcast(style, n)
        contour_labels = self._broadcast(contour_labels, n)
        color_bar = self._broadcast(color_bar, n)
        show_time = self._broadcast(show_time, n)
        plot_kwargs = self._broadcast(plot_kwargs, n)
        oro_kwargs = self._broadcast(oro_kwargs, n)

        if ax is None:
            fig = plt.figure(figsize=figsize)
            ax = fig.add_subplot(1, 1, 1)

        for j, diag in enumerate(self._diagnostics):
            diag.plot(time_index=time_index[j], style=style[j], ax=ax,
                      contour_labels=contour_labels[j], color_bar=color_bar[j],
                      show_time=show_time[j], plot_kwargs=plot_kwargs[j],
                      oro_kwargs=oro_kwargs[j])
        return ax

    def movie(self, output='html', filename='', writer='ffmpeg', fps=15,
              style="image", figsize=(16, 9), plot_kwargs=None,
              oro_kwargs=None, anim_kwargs=None):
        """Joint animation of the diagnostics on one axes
        (ref ``multi.py:642-729``)."""
        import matplotlib.pyplot as plt
        from matplotlib.animation import FuncAnimation

        n_frames = min(len(d) for d in self._diagnostics)
        fig = plt.figure(figsize=figsize)
        ax = fig.add_subplot(1, 1, 1)

        def update(frame):
            ax.clear()
            self.plot(time_index=frame, style=style, ax=ax, color_bar=False,
                      plot_kwargs=plot_kwargs, oro_kwargs=oro_kwargs)
            return (ax,)

        anim = FuncAnimation(fig, update, frames=n_frames, blit=False,
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

        n_frames = min(len(d) for d in self._diagnostics)

        def show(frame):
            self.plot(time_index=frame)

        slider = widgets.IntSlider(min=0, max=max(n_frames - 1, 0), step=1,
                                   value=0)
        return widgets.interactive(show, frame=slider)
