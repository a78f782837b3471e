"""App loop: median host time from the call into `render_accumulate` until
it returns, before the benchmark's synchronize, over the launches before the
trace (the profiler's runtime callbacks slow the host). Host work and hidden
syncs inside the call show here."""
import statistics


def read(ctx):
    return statistics.median(ctx["enqueue_ms"]) if ctx["enqueue_ms"] else None
