"""On the card: every cell's run at a small size is correct and launches
its kernels. Skips without a card (decided inside the test)."""
import json

import pytest

import portbench_common  # noqa: F401
from portbench import harness, cells

SMALL = dict(reps=64, n_tasks=120, warmup_steps=8, trace_steps=32,
             check_per_rate=2)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      cells.load_bench()["workloads"]])
def test_cell_on_the_card(workload, capsys):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.map_fused import ops as map_ops
    from repro_torch.kernels.phase1_map import ops as p1_ops

    before = dict(map_ops.LAUNCHES, **p1_ops.LAUNCHES)
    rc = harness.run(["--workload", workload, "--seed", "2147483701",
                      "--seconds", "0", "--trace", "1"], mix_overrides=SMALL)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    after = dict(map_ops.LAUNCHES, **p1_ops.LAUNCHES)
    mix = cells.Cell(workload).mix
    used = (("map_decide",) if mix["use_fused_map"] else ()) + (
        ("phase1_map",) if mix["use_fused_phase1"] else ())
    for k in used:
        assert after[k] > before[k], k
