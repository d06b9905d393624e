"""Policy-level parity: the port's MapAction equals the JAX lax policy's.

For all 8 registered heuristics and their ``with_fairness`` variants, on
random mapping events with adversarial draws (full queues, stale tasks,
empty machines, tied EET columns), the port's batched ``select`` — plain
and through ``with_fused_map`` — gives the same assign / drop /
queue_drop as the reference's ``select`` on each event, in the style of
``tests/test_map_fused.py``.
"""
import numpy as np
import pytest
import torch

from repro.core import policy as jpolicy
from repro_torch.core import policy as tpolicy
from repro_torch.core.policy.fused import FusedMapPolicy
from test_torch_common import (
    HEURISTICS,
    jax_context,
    port_context,
    random_context_arrays,
)

torch.set_num_threads(1)

DIMS = [(50, 4, 4, 2), (130, 9, 5, 3), (64, 37, 4, 2)]  # (N, M, S, Q)
B = 4


def _pair(name, fair):
    jp, tp = jpolicy.get(name), tpolicy.get(name)
    if fair and not jpolicy.describe(jp).fairness:
        jp, tp = jpolicy.with_fairness(jp), tpolicy.with_fairness(tp)
    return jp, tp


@pytest.mark.parametrize("fair", [False, True], ids=["base", "fair"])
@pytest.mark.parametrize("name", HEURISTICS)
def test_select_matches_reference(name, fair):
    jp, tp = _pair(name, fair)
    fused = tpolicy.with_fused_map(tp)
    assert isinstance(fused, FusedMapPolicy)
    for d_i, (N, M, S, Q) in enumerate(DIMS):
        a = random_context_arrays(B, N, M, S, Q, seed=100 * d_i + len(name))
        ctx = port_context(a)
        outs = {"plain": tp.select(ctx), "fused": fused.select(ctx)}
        for b in range(B):
            ref = jp.select(jax_context(a, b))
            for path, act in outs.items():
                for field in ("assign", "drop", "queue_drop"):
                    np.testing.assert_array_equal(
                        getattr(act, field)[b].numpy(),
                        np.asarray(getattr(ref, field)),
                        err_msg=f"{name} fair={fair} {path} {field} "
                                f"dims={(N, M, S, Q)} replicate {b}")


@pytest.mark.parametrize("name", ["ELARE", "FELARE"])
def test_fused_phase1_matches_reference(name):
    """``with_fused_phase1`` (the phase1_map hook) changes no decision."""
    jp = jpolicy.get(name)
    tp = tpolicy.with_fused_phase1(name)
    assert tp.supports_phase1_impl and tp != tpolicy.get(name)
    a = random_context_arrays(B, 70, 4, 4, 2, seed=9)
    act = tp.select(port_context(a))
    for b in range(B):
        ref = jp.select(jax_context(a, b))
        for field in ("assign", "drop", "queue_drop"):
            np.testing.assert_array_equal(getattr(act, field)[b].numpy(),
                                          np.asarray(getattr(ref, field)))


def test_registry_and_describe():
    assert tpolicy.list_policies() == jpolicy.list_policies()
    for name in HEURISTICS:
        assert tuple(tpolicy.describe(name)) == \
            tuple(jpolicy.describe(name))
    with pytest.raises(KeyError, match="unknown policy"):
        tpolicy.get("BOGUS")


def test_assign_never_dropped():
    """finalize's invariant: a task assigned this event is never dropped."""
    a = random_context_arrays(B, 80, 4, 4, 2, seed=3)
    ctx = port_context(a)
    for name in HEURISTICS:
        act = tpolicy.get(name).select(ctx)
        for b in range(B):
            assigned = act.assign[b][act.assign[b] >= 0]
            assert not act.drop[b][assigned].any(), name
