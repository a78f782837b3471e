"""Engine paths: the cluster path's queries (closest-hit and any-hit) per
cluster launch over the whole run, from the program's always-on counter
family `clusters.queries`, read in the process after the window; None where
the program has no such family or ran no cluster launch. The family counts
from shapes alone, so reading it costs the run nothing."""
import sys


def read(ctx):
    telemetry = sys.modules.get("optix_raytracer_tpu_torch.telemetry")
    counts = getattr(telemetry, "COUNTERS", {}).get("clusters.queries")
    if not counts or not counts.get("launches"):
        return None
    return (counts["closest"] + counts["any"]) / counts["launches"]
