"""The control: the reference computed in bfloat16, put in the program's
place, has to come out as not correct against the float32 reference."""
import numpy as np

from portbench_common import CONFIGS, row, system, tiny_stack
from portbench import compare
from portbench.reference import sim


def _readings(config, policy, dispatcher, rates, n):
    cfg = CONFIGS[config]
    sysm = system(cfg)
    traces = tiny_stack(cfg, rates, 2, n)
    out = []
    for r in range(len(rates)):
        for k in range(2):
            tr = row(traces, r, k)
            ref = sim.simulate(tr, sysm, policy, dispatcher)
            low = sim.simulate(tr, sysm, policy, dispatcher,
                               precision="bfloat16")
            out.append(compare.gaps(low, ref))
    return compare.summarize(out)


def test_control_fails_the_flat_cells():
    for policy in ("FELARE", "ELARE"):
        values = _readings("paper-hec-4x4", policy, "sticky", (4.0, 8.0), 200)
        ok, _ = compare.verdict(values, compare.LIMITS)
        assert not ok, values
        assert values["counter_mismatch"] > 0


def test_control_fails_the_federated_cells():
    for dispatcher in ("fair_spill", "sticky"):
        values = _readings("paper-x8", "FELARE", dispatcher, (32.0, 64.0),
                           240)
        ok, _ = compare.verdict(values, compare.LIMITS)
        assert not ok, values


def test_bf16_rounding():
    x = np.asarray([1.0, 1.00390625, 1.0078125, 3.14159, 1e30], np.float32)
    got = sim.bf16(x)
    assert got[0] == 1.0 and got[1] == 1.0          # a tie goes to even
    assert got[2] == np.float32(1.0078125)
    assert abs(got[3] - 3.140625) < 1e-6
    assert (got.view(np.uint32) & 0xFFFF == 0).all()
