"""The benchmark of `nsc_tpu_torch` on NVIDIA GPUs: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (`BENCHMARK.json`'s `workloads`)
names a configuration file, a traffic file and a limits file under
`benchmark/`; the run makes weights and inputs from the seed on the card,
warms up the cell's shapes (set-up), drives the port for `--seconds` (or,
with `--trace 1`, a traced window of the traffic's "trace_*" units), reads
the peak device memory, frees the program, checks what the window produced
against the plain reference in `benchmark/reference/`, and prints one JSON
object as the last line of standard output. Each compared number and its
limit are the last lines of standard error and the last key of that object.

Exits without a result (code 2) where no CUDA card is there or fewer than
the cell asks for, and (code 3) where `jax`, `jaxlib`, `flax` or
`nsc_tpu` is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "nsc_tpu")


def _environment() -> None:
    """Caches inside the checkout, at fixed paths; no JAX from any library."""
    cache = ROOT / "benchmark" / "_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def loaded_forbidden() -> list:
    """Modules whose top-level name is one of FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    if not (ROOT / "nsc_tpu_torch" / "__init__.py").is_file():
        print("the port nsc_tpu_torch is not in this checkout", file=sys.stderr)
        return 4

    import torch

    from benchmark.harness import runner, spec

    cell = spec.find_cell(spec.load_benchmark(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {cell.chips} CUDA card(s), found {have}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    res = runner.run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T0)
    found = loaded_forbidden()
    if found:
        print(f"modules loaded that the benchmark forbids: {found}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": res.pop("memory_peak_bytes"),
              "power_limit_w": power_limit_w(), **res.pop("device", {})}
    checks = res.pop("checks")
    out = {**res, "device": device, "checks": checks}
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
