"""The benchmark of ``flooder_tpu_torch``: a stream of distinct clouds.

Modules:
    layout: finds BENCHMARK.json, a cell's configuration, traffic mix and
        per-layer metric readers by name.
    generators: the clouds, made on the device from (seed, cloud index).
    reference: the plain reference (FPS, Delaunay, flood values,
        persistence) that decides ``correct``; imports nothing of the
        program.
    compare: the program's outputs against the reference, number by
        number, each with its limit.
    control: the reference in bfloat16, the control the limits are set
        against.
    counts: the peaks of one H100 and the work counts behind the rooflines.
    trace: the profiler's trace and the program's stage lines, reduced to
        the per-layer readings.
    cell: one run of one cell (set-up, window, trace, check).
    guard: the check that neither JAX nor the JAX package is loaded.
"""
