"""Model configuration: the port's copy of ``repro/configs/base.py``.

The fields and properties are the reference's. Dtypes are named by
string, as there, and read as ``torch.dtype`` through :attr:`act_dtype`
and :attr:`p_dtype`. ``attn_impl`` and ``ssm_impl`` take the port's
values:

  * ``"kernel"`` (the default): the kernel wrappers, which launch the
    hand-written CUDA kernels on CUDA tensors and run their plain
    versions on CPU tensors;
  * ``"plain"``: the plain PyTorch path, the counterpart of the
    reference's ``sdpa_xla`` and ``ssd_chunked``;
  * ``"plain_chunked"`` (``attn_impl`` only): the plain attention taken
    1024 query rows at a time, the counterpart of the reference's
    ``"xla_chunked"``.

The kernels have no backward pass, so training takes the plain paths
(``repro_torch.train.TRAIN_IMPLS``), as the reference trains on XLA's.
"""
from __future__ import annotations

import dataclasses

import torch

ATTN_IMPLS = ("kernel", "plain", "plain_chunked")
SSM_IMPLS = ("kernel", "plain")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    pad_vocab_to: int = 1       # pad embedding rows to a multiple
    head_dim: int = 0           # 0 -> d_model // n_heads
    qkv_bias: bool = False
    mlp: str = "swiglu"         # swiglu | gelu
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    moe_group: int = 4096
    # SSM (Mamba2) / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    attn_every: int = 0         # zamba2: shared attn block period (layers)
    # xLSTM
    slstm_every: int = 0
    # encoder-decoder (whisper backbone)
    encoder_layers: int = 0
    # vlm
    n_patches: int = 0
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    # kernel selection: kernel | plain | plain_chunked (attention only)
    attn_impl: str = "kernel"
    ssm_impl: str = "kernel"
    # training: recompute each block's activations in the backward pass
    remat: bool = True

    def __post_init__(self):
        for field, impls in (("attn_impl", ATTN_IMPLS),
                             ("ssm_impl", SSM_IMPLS)):
            if getattr(self, field) not in impls:
                raise ValueError(f"{field} must be one of {impls}, got "
                                 f"{getattr(self, field)!r}")

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_to
        return -(-self.vocab_size // m) * m

    @property
    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def p_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def scaled(self, **kw) -> "ModelConfig":
        """A sibling config (smoke tests, another dtype or impl): same
        family and topology."""
        return dataclasses.replace(self, **kw)

    def n_params(self) -> int:
        """Analytic parameter count, as the reference counts it."""
        d, ff, hd = self.d_model, self.d_ff, self.hd
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        attn = q + kv + o
        mlp = 3 * d * ff if self.mlp == "swiglu" else 2 * d * ff
        if self.family in ("dense", "vlm"):
            body = self.n_layers * (attn + mlp + 2 * d)
        elif self.family == "moe":
            router = d * self.n_experts
            emlp = self.n_experts * (3 * d * ff)
            body = self.n_layers * (attn + emlp + router + 2 * d)
        elif self.family == "ssm":  # xLSTM
            di = self.d_model
            per = 4 * d * di + di * d + 3 * d
            mlp_x = 2 * d * int(2.67 * d)
            body = self.n_layers * (per + mlp_x)
        elif self.family == "hybrid":  # zamba2
            din, ds, nh = self.d_inner, self.ssm_state, self.ssm_heads
            in_proj = d * (2 * din + 2 * ds + nh)
            out_proj = din * d
            mamba = in_proj + out_proj + self.ssm_conv * (din + 2 * ds) + 2 * nh
            n_attn = self.n_layers // max(self.attn_every, 1)
            shared = attn + mlp
            body = self.n_layers * (mamba + 2 * d) + shared + n_attn * 2 * d
        elif self.family == "audio":
            body = (self.n_layers + self.encoder_layers) * (attn + mlp + 2 * d)
            body += self.n_layers * (attn + d)
        else:
            raise ValueError(self.family)
        emb = self.vocab_size * d
        if not self.tie_embeddings:
            emb *= 2
        return body + emb

    def active_params(self) -> int:
        """Activated parameters per token (MoE: only routed experts)."""
        if self.family != "moe":
            return self.n_params()
        d, ff = self.d_model, self.d_ff
        unused = self.n_layers * (
            (self.n_experts - self.experts_per_token) * 3 * d * ff)
        return self.n_params() - unused
