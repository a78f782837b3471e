"""The port's spans and counters: one registry.

Counters are families of named counts, plain dicts that the code adds to in
place and that are always on: `kernels.LAUNCHES` (family
"kernels.launches"), `kernels.BUILDS` ("kernels.builds"), `qwalk.STATS`
("qwalk.queries"), `intersect.ALPHA_STATS` ("intersect.alpha"),
`pallas_pt.PLANS` ("fused.plans": fused launches that built their launch
plan, and that reused one), `launch_graph.GRAPHS` ("engine.graphs": launches
captured as a CUDA graph, and replayed).
`counters(family, keys)` makes a family, `reset_counters(family)` zeroes
one, and `COUNTERS` holds them all by family name.

Spans time the host's work at the port's layer boundaries. Each records its
name, a tag (the `LAUNCHES` key of the kernel a `kernels.launch` span
starts), its start and end on `time.perf_counter_ns`, the id of its parent
span (-1 at the top) and the number of the launch it serves: `launch(name)`
opens the root span of a launch (`engine.render_accumulate`) and numbers
launches from 0, and a span opened between launches, such as the camera's
or the film reset's, takes the next launch's number. Spans are off by
default: `span` and `launch` then return one shared no-op context manager,
after one test of the module flag, with no clock call and no allocation.
`enable()` turns them on; the spans go into a buffer of CAPACITY entries
made at import, and `drain()` hands them to the caller and empties it. The
port writes no file and exports nothing.

The profiler's clock (Kineto stamps its events on CLOCK_REALTIME, the
clock of `time.time_ns`) reads `perf_counter_ns + clock_offset_ns()`.
"""
from __future__ import annotations

import array
import itertools
import threading
import time
from typing import NamedTuple

# Spans held between two drains: a traced window of the benchmark records
# about 10 a launch.
CAPACITY = 1 << 17

ENABLED = False
COUNTERS: dict = {}


def counters(family: str, keys) -> dict:
    """The counter family `family`: one dict, made on the first call with
    each key at 0; later calls add their new keys at 0."""
    d = COUNTERS.setdefault(family, {})
    for k in keys:
        d.setdefault(k, 0)
    return d


def reset_counters(family: str):
    """Zero every count of the family, in place."""
    d = COUNTERS[family]
    for k in d:
        d[k] = 0


class Span(NamedTuple):
    id: int
    name: str
    tag: object
    start: int        # perf_counter_ns
    end: int          # perf_counter_ns; -1 while open
    parent: int       # id of the enclosing span, -1 for none
    launch: int       # number of the launch the span serves

    @property
    def duration(self) -> int:
        return self.end - self.start


_names = [None] * CAPACITY
_tags = [None] * CAPACITY
_start = array.array("q", bytes(8 * CAPACITY))
_end = array.array("q", bytes(8 * CAPACITY))
_parent = array.array("q", bytes(8 * CAPACITY))
_launch_of = array.array("q", bytes(8 * CAPACITY))
_next = itertools.count()
_launch = 0
_local = threading.local()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


class _Close:
    """Closes the innermost open span of the calling thread; with
    `counts_launch`, a launch's root, it also moves to the next launch
    number."""
    __slots__ = ("counts_launch",)

    def __init__(self, counts_launch: bool):
        self.counts_launch = counts_launch

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        t = time.perf_counter_ns()
        i = _local.stack.pop()
        if i < CAPACITY:
            _end[i] = t
        if self.counts_launch:
            global _launch
            _launch += 1
        return False


_NOOP = _Noop()
_CLOSE = _Close(False)
_CLOSE_LAUNCH = _Close(True)


def _open(name: str, tag, closer: _Close) -> _Close:
    i = next(_next)
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    if i < CAPACITY:
        _names[i] = name
        _tags[i] = tag
        _parent[i] = stack[-1] if stack else -1
        _launch_of[i] = _launch
        _end[i] = -1
        _start[i] = time.perf_counter_ns()
    stack.append(i)
    return closer


def span(name: str, tag=None):
    """`with span(name):` records the block as a span when spans are on."""
    if not ENABLED:
        return _NOOP
    return _open(name, tag, _CLOSE)


def launch(name: str):
    """`with launch(name):` records the block as the root span of one
    launch; the launch number moves on when it closes."""
    if not ENABLED:
        return _NOOP
    return _open(name, None, _CLOSE_LAUNCH)


def enable():
    global ENABLED
    ENABLED = True


def disable():
    global ENABLED
    ENABLED = False


def drain() -> list:
    """The spans recorded since the last drain, in the order they opened,
    and an empty buffer. Call it between launches, with no span open in
    this thread. Raises OverflowError when more than CAPACITY spans opened
    since the last drain (the ones past it were not kept)."""
    global _next
    if getattr(_local, "stack", None):
        raise RuntimeError("drain() inside an open span")
    n = next(_next)
    _next = itertools.count()
    if n > CAPACITY:
        raise OverflowError(f"{n} spans opened since the last drain, "
                            f"past the buffer's {CAPACITY}")
    return [Span(i, _names[i], _tags[i], _start[i], _end[i], _parent[i],
                 _launch_of[i]) for i in range(n)]


def reset_spans():
    """Empty the buffer, forget this thread's open spans and number
    launches from 0 again."""
    global _next, _launch
    _next = itertools.count()
    _local.stack = []
    _launch = 0


def clock_offset_ns(samples: int = 16) -> int:
    """`time.time_ns() - time.perf_counter_ns()`, from the tightest of
    `samples` reads of the real-time clock between two perf_counter reads:
    a span's stamp plus it is a stamp on the profiler's clock."""
    best = None
    for _ in range(samples):
        a = time.perf_counter_ns()
        r = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, r - (a + b) // 2)
    return best[1]
