"""The benchmark's yardstick: what it measures the port with, kept apart
from the port so that a change to the port cannot change the measure.

- ``spec``: ``BENCHMARK.json`` and the files it names (configurations,
  traffic mixes, limits, metric readers), found by name;
- ``weights``, ``traffic``: the weights and the inputs, drawn from the seed;
- ``counts``: operations and bytes from shapes, and the card's peaks;
- ``trace``: a ``torch.profiler`` trace reduced to device time, busy time,
  spans and gaps;
- ``reference``: the plain float32 reference and its lower-precision
  control;
- ``compare``: the numbers that decide ``correct``;
- ``record``: what a driver hands the metric readers;
- ``drivers``: one module per kind of traffic (set-up, window, check);
- ``cli``: one run of one cell, and its last line.

``bench/calibrate.py`` takes the readings the limits were set from.
"""
