"""The port's tracing: host spans, and phase marks inside the card's graphs.

Off by default. `TAKE_TPU_TRACE=1` in the environment turns it on when the
module is imported; `enable()` and `disable()` switch it at run time.

Spans. `with span("take.render.pass"):` times a block of host code. Off,
`span` returns one shared no-op context. On, each span opens
torch.profiler.record_function(name), so that it lands in any active
profiler trace on the clock of the card's activity, and adds to a table by
name: count, total seconds, self seconds (total less the time its child
spans cover) and the name of the span it was first opened in. `totals()`
returns a copy of the table, `reset()` clears it. Nothing is written during
a run: export a trace with utils.metrics.profiler_trace, or read `totals()`.
`spanned(name)` wraps a function in a span, `staged(name)` in a stage.

Marks. A pass body splits its device work into phases (PHASES): `mark(p)`
starts phase `p` of the current stage (STAGES: "forward", or the stage of
the innermost `with stage(...)`), and a phase runs to the next mark. On,
and while the current CUDA stream is capturing a graph, a mark launches a
one-thread kernel that does nothing, `take_mark_<stage>_<phase>`
(csrc/mark.cu): a node of the graph, so that each replay puts a named
boundary on the card's timeline between the phases' kernels. Elsewhere (on
the CPU, in passes run op by op) a mark launches nothing. On, every mark is
recorded as (stage, phase) in the order the body emits it (`marks()`).
`with phase(p):` marks p for a block inside another phase and then marks
the interrupted phase again, so that the other phases keep their meaning:
`disney` (the Disney lobes inside the BSDF dispatch), `envmap` (the
environment map's sampling, lookups and pdf) and `glossy` (the Phong,
Blinn-Phong and Blinn-Phong microfacet lobes inside the BSDF dispatch) are
such phases.
A graph captured with tracing on holds mark nodes and one captured with it
off holds none, so `enabled()` is part of every graph key
(render.pass_key, grad.grad_key).
"""

import collections
import contextlib
import ctypes
import functools
import os
import threading
import time

import torch

from take_tpu_torch.geometry._launch import declare, raise_on

STAGES = ("forward", "backward")
PHASES = ("camera", "shade", "light", "occlusion", "bsdf", "intersect", "hit", "step", "loss", "vjp", "end",
          "disney", "envmap", "glossy")
MAX_MARKS = 1 << 16  # marks kept for marks(), the latest

_ON = [os.environ.get("TAKE_TPU_TRACE", "") == "1"]
_NULL = contextlib.nullcontext()
_LOCK = threading.Lock()
_TABLE = {}  # span name -> {"count", "total_s", "self_s", "parent"}
_OPEN = threading.local()  # .spans: this thread's open spans, innermost last
_STAGE = ["forward"]  # the stage stack; shared, since autograd runs a backward on a thread of its own
_MARKS = collections.deque(maxlen=MAX_MARKS)
_LATEST = {}  # stage -> its latest phase, the one a `phase` block resumes


def enabled() -> bool:
    return _ON[0]


def enable():
    _ON[0] = True


def disable():
    _ON[0] = False


class _Span:
    __slots__ = ("name", "parent", "child_s", "t0", "rf")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        spans = _open_spans()
        self.parent = spans[-1].name if spans else None
        spans.append(self)
        self.child_s = 0.0
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        spans = _open_spans()
        spans.pop()
        if spans:
            spans[-1].child_s += dt
        with _LOCK:
            row = _TABLE.setdefault(self.name, {"count": 0, "total_s": 0.0, "self_s": 0.0, "parent": self.parent})
            row["count"] += 1
            row["total_s"] += dt
            row["self_s"] += dt - self.child_s
        self.rf.__exit__(*exc)
        return False


def _open_spans():
    spans = getattr(_OPEN, "spans", None)
    if spans is None:
        spans = _OPEN.spans = []
    return spans


def span(name: str):
    """A context that times its block as span `name` (no-op when off)."""
    return _Span(name) if _ON[0] else _NULL


def spanned(name: str):
    """A decorator: every call of the function runs inside span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def staged(name: str):
    """A decorator: every call of the function runs in stage `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with stage(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def totals() -> dict:
    """{span name: {"count", "total_s", "self_s", "parent"}}, a copy."""
    with _LOCK:
        return {k: dict(v) for k, v in _TABLE.items()}


def marks() -> list:
    """The (stage, phase) of every mark since the last reset(), in order (the latest MAX_MARKS)."""
    return list(_MARKS)


def reset():
    """Clear the span table and the recorded marks."""
    with _LOCK:
        _TABLE.clear()
    _MARKS.clear()
    _LATEST.clear()


@contextlib.contextmanager
def _stage_of(name):
    _STAGE.append(name)
    try:
        yield
    finally:
        _STAGE.pop()


def stage(name: str):
    """A context whose marks belong to stage `name` (no-op when off)."""
    if name not in STAGES:
        raise ValueError(f"unknown stage {name!r}")
    return _stage_of(name) if _ON[0] else _NULL


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def mark(phase: str):
    """Start phase `phase` of the current stage (see the module's note)."""
    if not _ON[0]:
        return
    if phase not in PHASES:
        raise ValueError(f"unknown phase {phase!r}")
    s = _STAGE[-1]
    _MARKS.append((s, phase))
    _LATEST[s] = phase
    if _capturing():
        _launch(STAGES.index(s), PHASES.index(phase))


@contextlib.contextmanager
def _phase_of(name):
    back = _LATEST.get(_STAGE[-1], "end")
    mark(name)
    try:
        yield
    finally:
        mark(back)


def phase(name: str):
    """A context whose device work is phase `name` of the current stage,
    after which the phase it interrupted resumes ("end", so unmarked, where
    none had begun); no-op when off."""
    return _phase_of(name) if _ON[0] else _NULL


def _launch(s, p):
    raise_on(_lib(), _lib().tt_mark(s, p, torch.cuda.current_stream().cuda_stream), "mark kernel")


def _warm():
    """Each mark kernel once, when tracing is on (a graph captured with it
    off holds no mark)."""
    if _ON[0]:
        for s in range(len(STAGES)):
            for p in range(len(PHASES)):
                _launch(s, p)


_lib = declare("mark", {"tt_mark": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}, warm=_warm)
