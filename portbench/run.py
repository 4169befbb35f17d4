"""Run one cell of BENCHMARK.json on the card and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the scene's load and upload, the kernels' libraries, the
cell's warm image or steps, which capture its graph keys) runs from the
process's start to the first timed unit; then units run back to back for
`--seconds`, and the window ends with the last unit started in it. With
`--trace 0` the result carries the cell's end-to-end metrics; with
`--trace 1` its per-layer metrics: the window runs with the readers'
spans, and after it a few more units run under torch.profiler. Then the
program's state is freed and what the window produced is compared with the
plain reference (portbench/reference); each number compared is printed
beside its limit, as the last lines of standard error and under `checks`,
the last key of the result. Exits 2 without a result when the run lacks
the card it needs, and 3 when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

import torch  # noqa: E402

from portbench import checks, loops, spec, traceread  # noqa: E402
from portbench.reference import scene as ref_scene  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "take_tpu")  # compared with each module's top-level name, whole


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def read_metric(metric, ctx):
    path = spec.reader_path(metric)
    mod_spec = importlib.util.spec_from_file_location(f"portbench.readers.{path.stem}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read(ctx, metric)


def run(name, seed, seconds, trace, device="cuda", t_start=T_START, cell=None):
    """One run of cell `name` (or of `cell`, its entries as spec.cell gives
    them): (result dict, [(number, value, limit)])."""
    from take_tpu_torch import _graph, grad

    render = loops.program_module("render")
    from take_tpu_torch.geometry import _launch

    cuda = torch.device(device).type == "cuda"
    cell = cell or spec.cell(name)
    loop = loops.LOOPS[cell["traffic_data"]["kind"]](cell, seed, device)

    def passes():
        return {k: render.PASSES[k] + grad.PASSES[k] for k in ("graph", "eager")}

    def peak():  # what the process holds on the card: the graphs' pools and the allocator's cache
        return torch.cuda.max_memory_reserved(device) if cuda else 0

    loops.sync(device)
    setup_peak = peak()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    graphs0, passes0 = {id(g) for g in _graph.captured()}, passes()
    unit_s = []
    t_open = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        out = loop.unit(spans=bool(trace))
        t1 = time.perf_counter()
        unit_s.append(t1 - t0)
        loop.keep(out)
        if t1 - t_open >= seconds:
            break
    window = {"seconds": t1 - t_open, "unit_s": unit_s, "peak_bytes": peak(),
              "graphs_new": len({id(g) for g in _graph.captured()} - graphs0),
              "passes_eager": passes()["eager"] - passes0["eager"], "loss_grad_s": list(loop.loss_grad_s)}
    attempted, failed = len(unit_s), loop.failed
    result_trace = counts = segment = None
    if trace:
        launches0, passes1 = dict(_launch.LAUNCHES), passes()

        def segment_units():
            n, t0 = 0, time.perf_counter()
            while n == 0 or time.perf_counter() - t0 < loops.TRACED_SECONDS:
                loop.unit()
                n += 1
            return n

        n, result_trace = traceread.traced(segment_units)
        segment = {"units": n, "paths": n * loop.paths_per_unit,
                   "passes": sum(passes().values()) - sum(passes1.values()),
                   "launches": {k: v - launches0.get(k, 0) for k, v in _launch.LAUNCHES.items()}}
        counts = loop.query_counts()
    memory_peak = max(setup_peak, peak())
    loop.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    numbers = loop.numbers()
    q = statistics.quantiles(unit_s, n=4) if len(unit_s) > 1 else unit_s * 3
    print(f"portbench: set-up {t_open - t_start:.3f} s, window {window['seconds']:.3f} s ({len(unit_s)} "
          f"{loop.unit_name}; s each: min {min(unit_s):.4f}, quartiles {q[0]:.4f} {q[1]:.4f} {q[2]:.4f}, "
          f"max {max(unit_s):.4f}), reference {time.perf_counter() - t_ref:.3f} s"
          + (f", trace reduced in {result_trace['reduce_s']:.3f} s" if trace else ""), file=sys.stderr)
    correct, rows = checks.judge(numbers, cell["limits"]["limits"])
    correct = correct and failed == 0
    ctx = types.SimpleNamespace(cell=cell, window=window, trace=result_trace, segment=segment, counts=counts,
                                n_tri=ref_scene.load(spec.ROOT / cell["config_data"]["scene"]).n_tri
                                if trace else None)
    if trace:
        chosen = cell["per_layer"]
        values = {m["name"]: read_metric(m["name"], ctx) for m in chosen}
    else:
        chosen = cell["end_to_end"]
        values = {**loop.end_to_end(window), "setup_s": t_open - t_start}
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in chosen
               if values.get(m["name"]) is not None}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": memory_peak}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev.update(busy_s=result_trace["busy_s"], window_s=result_trace["window_s"])
        result["breakdown"] = traceread.breakdown(result_trace)
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result, rows


def main(argv=None):
    ap = argparse.ArgumentParser(prog="portbench.run", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    need = spec.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: the cell needs {need} CUDA device(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, rows = run(args.workload, args.seed, args.seconds, args.trace)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded modules of JAX or the JAX package: {', '.join(found)}", file=sys.stderr)
        return 3
    for k, v, lim in rows:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
