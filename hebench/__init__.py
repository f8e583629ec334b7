"""The benchmark of ``lattigo_tpu_torch`` on one NVIDIA card: its cells,
their traffic, the plain NumPy reference that decides ``correct``, and the
readers of its metrics. See ``hebench/run.py`` for how a run goes."""
