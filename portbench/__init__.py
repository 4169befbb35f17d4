"""portbench: the benchmark of take_tpu_torch, the PyTorch and CUDA path tracer.

`python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json on the card and prints its result as the
last line of standard output. Everything that belongs to one configuration,
traffic mix, per-layer metric, kernel or cell sits in a file of its own,
found by its name in BENCHMARK.json:

  configs/<config>.json   the render job: scene file, resolution, spp, depth
  traffic/<traffic>.json  the mix: parameters of the closed loop in loop.py
  readers/<metric>.py     a per-layer metric, read from counters, spans or the trace
  kernels/<kernel>.json   a kernel's name in the trace and its counted bytes
  limits/<cell>.json      the comparison with the reference: sample size and limits
  reference/              the plain path tracer that decides `correct`

Nothing here imports JAX or the JAX package.
"""
