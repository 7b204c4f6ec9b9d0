"""
Documentation
=============

The port's guide (``port_guide.md``) and the script that builds its HTML
site, :mod:`qgs_tpu_torch.docs.build` (``python -m
qgs_tpu_torch.docs.build OUTDIR``): the guide and an API page for every
public module of :mod:`qgs_tpu_torch`.
"""
