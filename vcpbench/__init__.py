"""The benchmark of ``vcp_tpu_torch`` on one H100: 1080p encode fps and
quality per bit through the consumer's encode and verify steps.

``run.py`` runs one cell (``BENCHMARK.json``); ``rehearse.py`` drives a
cell on the CPU at a small size; ``readings.py`` reads the comparison's
numbers of the program and its control on many seeds. What a cell is
made of is found by name (``spec.py``): ``configs/``, ``traffic/``,
``limits/`` and ``metrics/``. ``h264ref/`` is the plain reference
decoder that ``check.py`` judges the outputs with.
"""
