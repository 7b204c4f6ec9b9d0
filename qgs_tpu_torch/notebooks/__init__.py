"""
Notebooks
=========

The port's notebook catalog: one notebook for each module of
:mod:`qgs_tpu_torch.examples`, under the JAX package's notebook names, and
an introduction to what differs in the port
(``introduction_qgs_tpu_torch.ipynb``), all in this directory.

* ``python -m qgs_tpu_torch.notebooks.make [--force]`` writes them from
  the examples (:mod:`qgs_tpu_torch.notebooks.make`); it refuses to
  overwrite an executed notebook unless ``--force`` is given.
* ``python -m qgs_tpu_torch.notebooks.run [--device cpu|cuda] [--full]
  [names]`` sets each notebook's parameters cell and executes it in place
  (:mod:`qgs_tpu_torch.notebooks.run`, through ``nbclient``); the device
  is ``cuda`` unless told otherwise, the lengths short unless ``--full``.

The committed notebooks were executed on the CPU with ``short=True``;
each says so in the markdown cell above its parameters cell.  ``nbformat``
and ``nbclient`` are imported inside the functions that need them, so this
package imports where they are not installed.
"""

import os

DPI = 72                 # figures embedded in a notebook: dots an inch,
MAX_SIDE = 720           # and pixels of the longer side at most


def show(plt, outdir, name, dpi=DPI):
    """A notebook's counterpart of :func:`qgs_tpu_torch.examples.savefig`:
    save the current figure as ``outdir/name`` at ``min(dpi, DPI)`` dots
    an inch, fewer where its longer side would pass :data:`MAX_SIDE`
    pixels, close every figure and display the saved image."""
    from IPython.display import Image, display

    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, name)
    longer = max(plt.gcf().get_size_inches())
    plt.savefig(path, dpi=min(dpi, DPI, MAX_SIDE / longer))
    plt.close("all")
    display(Image(filename=path))
