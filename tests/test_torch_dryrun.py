"""The dry run at CI scale (counterpart of ``tests/test_dryrun_small.py``):
``lower_cell`` on a fake (2, 2, 2) (pod, data, model) group of 8 ranks in
this process, with smoke configs, through the same code path as the
256- and 512-rank production meshes: the three step kinds, the
``long_500k`` skip, and rank 0's share of the work.
"""
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import init_fake_group, make_mesh

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh():
    init_fake_group(8)
    try:
        yield make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,shape", [
    ("qwen1.5-0.5b", "train_4k"),
    ("qwen1.5-0.5b", "decode_32k"),
    ("internlm2-1.8b", "prefill_32k"),
    ("zamba2-2.7b", "long_500k"),
])
def test_lower_cell_all_kinds_small_mesh(mesh, arch, shape):
    rec = dryrun.lower_cell(arch, shape, mesh, "ci", accum=2,
                            cfg=registry.get_smoke_config(arch))
    assert rec["status"] == "ok", rec
    ro = rec["roofline"]
    assert ro["t_comp_s"] > 0 and ro["t_mem_s"] > 0
    assert rec["chips"] == 8 and rec["findings"] == []
    mem = rec["memory"]
    assert 0 < mem["argument_bytes"] < mem["peak_live_bytes"]
    # every rank gathers the parameters it computes with (FSDP-style)
    assert rec["collective_bytes"]["all-gather"] > 0
    if shape == "train_4k":      # the gradients summed over (pod, data)
        assert rec["collective_bytes"]["all-reduce"] > 0
    else:                        # serving runs the kernels' rules on meta
        assert rec["by_kernel"]


def test_long_500k_skips_full_attention(mesh):
    rec = dryrun.lower_cell("qwen1.5-0.5b", "long_500k", mesh, "ci",
                            cfg=registry.get_smoke_config("qwen1.5-0.5b"))
    assert rec["status"] == "skip" and "SKIP" in rec["reason"]


def test_rank0_work_is_the_data_parallel_share(mesh):
    """Ranks along ``model`` compute the same rows (ROADMAP B9): rank 0's
    matmul FLOPs times pod x data equal the world-size-1 count, which is
    ``flops_global_over_chips`` times the 8 chips."""
    rec = dryrun.lower_cell("qwen1.5-0.5b", "train_4k", mesh, "ci",
                            accum=2,
                            cfg=registry.get_smoke_config("qwen1.5-0.5b"))
    world1 = rec["flops_global_over_chips"]["matmul_flops"] * rec["chips"]
    assert rec["cost"]["matmul_flops"] * 4 == world1
