"""Generators of traffic whose shape generate.py's model does not make.
A traffic file names one with ``"generator": "<name>"``; the file
``<name>.py`` here then defines ``make(traffic, seed, stream, device)``,
which returns one generate.Reads per mate (the same reads for the same
seed and stream, the same amount of work for every seed) and reads its
parameters from the traffic's own keys."""
