"""On the card, at each cell's own size and load: the lower-precision
controls fail the limit that sound runs of the program pass.

``python -m pytest -m cuda bench/tests/test_bench_control.py`` on the
machine with the card; skips without one.
"""

import pytest

from bench import harness

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)
#: The stream cells (a train cell's control and faults are held in
#: ``test_bench_train.py``).
CELLS = [w["name"] for w in harness.load_spec()["workloads"]
         if harness.find_cell(w["name"]).mix["kind"] != "train"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_controls_fail_where_the_program_passes(cell, card):
    import torch

    chips = harness.find_cell(cell).entry["chips"]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} cards")
    for seed in SEEDS:
        out = harness.run_cell(cell, seed, 3.0, False, control=True,
                               log=lambda m: None)
        check = out["result"]["checks"]["max_abs_gap"]
        assert out["result"]["correct"], check
        for mode in harness.CONTROLS + harness.FAULTS:
            assert out["info"][f"control_{mode}_max_abs_gap"] > \
                check["limit"], (seed, mode)
