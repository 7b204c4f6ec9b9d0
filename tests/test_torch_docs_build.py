"""The port's documentation site must build (the counterpart of
``tests/test_docs_build.py``): the guide, with its sections, and an API
page for every public module of ``qgs_tpu_torch``, signatures included,
and no page of the JAX package's."""

import pathlib
import pkgutil
import subprocess
import sys

import pytest

import qgs_tpu_torch

REPO = pathlib.Path(__file__).resolve().parents[1]

pytest.importorskip("markdown")

SECTIONS = ("1. Devices: <code>device=</code>",
            "2. Random states: <code>rng=</code>", "3. Precision tiers",
            "4. Which path runs what", "The shared-memory rule",
            "5. Notebooks and this site", "6. TPU workarounds not carried",
            "7. Faults found in the reference")


@pytest.fixture(scope="module")
def site(tmp_path_factory):
    out = tmp_path_factory.mktemp("site")
    proc = subprocess.run(
        [sys.executable, "-m", "qgs_tpu_torch.docs.build", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin:/usr/local/bin", "HOME": str(out),
             "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    return out


def test_guide_page_has_its_sections(site):
    page = (site / "index.html").read_text()
    for section in SECTIONS:
        assert section in page, section
    assert "<table>" in page and "232,448" in page


def test_api_page_for_every_public_module(site):
    names = ["qgs_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(qgs_tpu_torch.__path__,
                                              "qgs_tpu_torch.")
        if not any(p.startswith("_") for p in m.name.split("."))]
    assert len(names) >= 82
    pages = {p.name for p in site.glob("api_*.html")}
    assert pages == {f"api_{n}.html" for n in names}
    assert not [p for p in pages if p.startswith("api_qgs_tpu.")]


def test_integrators_signatures(site):
    page = (site / "api_qgs_tpu_torch.integrators.integrator.html"
            ).read_text()
    assert ("<b>RungeKuttaIntegrator</b>(num_threads=None, b=None, c=None, "
            "a=None, number_of_dimensions=None, precision=&#x27;float64&#x27;"
            ", device=None, mesh=None)") in page
    tgls = page[page.index("<b>RungeKuttaTglsIntegrator</b>("):]
    assert "<b>set_func</b>(self, f, fjac=None, ic_init=True)" in tgls
    assert "<b>integrate</b>(self, t0, t, dt, ic=None, tg_ic=None" in tgls
    rk = (site / "api_qgs_tpu_torch.integrators.rk.html").read_text()
    assert "<b>fused_route</b>(f, y, tableau)" in rk
