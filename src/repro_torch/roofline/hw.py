"""The H100's constants, the target of the port's rooflines
(counterpart of ``repro/roofline/hw.py``, which holds a TPU v5e's).

Every rate is the published peak of one **NVIDIA H100 80GB HBM3** (the
SXM part) at its full power limit of **700 W**, dense (no sparsity),
from NVIDIA's H100 Tensor Core GPU data sheet. A card set below 700 W
(``nvidia-smi --query-gpu=power.limit``) runs slower under load, so a
roofline share is stated with the card's limit beside it.
"""

#: Dense bf16 (and fp16) on the tensor cores, FLOP/s.
PEAK_FLOPS_BF16 = 989e12
#: Dense TF32 on the tensor cores, FLOP/s.
PEAK_FLOPS_TF32 = 495e12
#: float32 outside the tensor cores (the CUDA cores' FMA), FLOP/s.
PEAK_FLOPS_F32 = 67e12
#: HBM3, bytes/s.
HBM_BW = 3.35e12
#: Device memory as the card reports it: torch 2.11's
#: ``torch.cuda.get_device_properties(0).total_memory`` on an NVIDIA H100
#: 80GB HBM3 ("80 GB" on the data sheet).
HBM_BYTES = 85_017_493_504
#: NVLink 4 between the cards of one node: 900 GB/s per card in both
#: directions together (18 links of 25 GB/s each way), so 450e9 B/s each
#: way. ``t_coll`` takes it as every rank's rate. A mesh of 256 or 512
#: ranks spans 32 or 64 eight-card nodes, whose links between nodes
#: (InfiniBand NDR, 50 GB/s per card each way) are 9 x slower: for such a
#: mesh ``t_coll`` is a lower bound.
LINK_BW = 450e9
#: Cards of one NVLink node.
CHIPS_PER_NODE = 8
