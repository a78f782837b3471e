"""Entry point of the port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The caches of everything the run compiles stay
at fixed paths inside the checkout: the port's kernel library in
`optix_raytracer_tpu_torch/_build/`; Triton's, torch extensions' and CUDA's
JIT caches under `benchmark/.cache/`.
"""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "benchmark" / ".cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main())
