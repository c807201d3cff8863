"""Microbenchmarks of the port (ports of ``tools/probe_lanegather.py`` and
``tools/microbench_gather.py``) and the gather functions they time."""
