"""The control of each cell's comparison, on the card, at a size a test run
holds: the reference in the precision below the configuration's, put in
the program's place, has to fail at least one of the cell's limits, while
the program passes them on the same inputs. Run on the card:

    python -m pytest -m cuda benchmark/tests/test_bench_control_cuda.py

(`benchmark/calibrate.py` reads the same at the cells' own sizes.)
"""

import pytest
import torch

from benchmark.harness import runner, spec

pytestmark = pytest.mark.cuda

SMALLER = {
    "offline": {"batch": 8, "pool_batches": 1, "kept_batches": 1, "warm_batches": 1},
    "live": {"streams": 8, "check_streams": 2, "warm_rounds": 1},
    "train": {},
}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _cells():
    return [w["name"] for w in spec.load_benchmark()["workloads"]]


def _failed(values: dict, limits: dict) -> list:
    return [k for k, v in values.items() if not v <= limits[k]["limit"]]


@pytest.mark.parametrize("workload", _cells())
@pytest.mark.parametrize("seed", [101, 102, 103])
def test_control_fails_a_limit(workload, seed, card):
    cell = spec.find_cell(spec.load_benchmark(), workload)
    cell.traffic.update(SMALLER[cell.traffic["kind"]])
    drv = runner.kind_for(cell, seed, card)
    drv.setup()
    drv.window(0.0, max_units=3 if cell.traffic["kind"] == "live" else 1)
    drv.release()
    assert not _failed(drv.check(), cell.limits)
    assert _failed(drv.control(), cell.limits)
