"""Config system: model architecture, DiLoCo and training hyper-parameters.

The port's own copy of ``repro.configs.base`` (the port imports nothing of
the JAX package). Field names and defaults are the JAX package's, with one
exception: ``kernel_mode`` defaults to ``"auto"``, which launches the
port's CUDA kernels on CUDA tensors and runs their plain PyTorch versions
on CPU tensors. Fields of features this slice does not port are kept so
that a config reads the same in both packages; the code that would act on
them rejects any value but the default (see ``core/diloco.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | encdec | vlm | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads

    # --- attention ---
    pos_emb: str = "rope"       # rope | learned | sincos | none
    rope_theta: float = 10_000.0
    rope_pct: float = 1.0       # fraction of head_dim rotated
    qk_norm: bool = False
    attn_bias: bool = False
    mlp_bias: bool = False
    parallel_block: bool = False
    window: int = 0             # >0: sliding-window attention
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    act: str = "silu"           # silu | gelu
    mlp_gated: bool = True
    tie_embeddings: bool = False
    max_position: int = 1 << 20

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- MLA ---
    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    v_head_dim: int = 0

    # --- encoder-decoder ---
    n_enc_layers: int = 0
    n_frames: int = 1500

    # --- VLM ---
    cross_attn_every: int = 0
    n_patches: int = 0
    vision_dim: int = 0

    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv: int = 4
    shared_attn_every: int = 0
    slstm_every: int = 0

    # --- numerics / execution ---
    act_batch_axes: tuple = ("data",)
    act_model_shard: bool = True
    act_seq_shard: bool = False
    decode_kv_shard: str = ""
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    attn_chunk: int = 1024      # kv-chunk size of online-softmax attention
    remat: bool = True          # torch.utils.checkpoint per layer
    logit_softcap: float = 0.0
    init_scale: float = 0.02
    use_pallas: bool = False    # flash-attention kernels (hd, S % 128 == 0)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_v_head_dim(self) -> int:
        return self.v_head_dim or self.resolved_head_dim


@dataclass(frozen=True)
class DiLoCoConfig:
    """Algorithm 1 hyper-parameters (paper defaults in comments)."""
    k: int = 8                  # number of replicas / islands
    H: int = 500                # inner steps per outer step
    outer_opt: str = "nesterov"  # nesterov | sgd | sgdm | adam
    outer_lr: float = 0.7       # paper: 0.7 for Nesterov
    outer_momentum: float = 0.9
    outer_adam_b2: float = 0.95
    outer_adam_eps: float = 0.1
    drop_prob: float = 0.0      # async-communication dropout (Fig 8)
    prune_frac: float = 0.0     # sign-pruning of outer grads (Tab 6)
    weighted_avg: bool = False  # weight outer grads by shard size
    sync_inner_state: bool = False
    # auto | kernel | ref (see kernels/ops.py)
    kernel_mode: str = "auto"
    # --- streaming outer sync (core/streaming.py) ---
    streaming_fragments: int = 0
    stream_alpha: float = 1.0
    stream_tau: int = 0
    outer_grad_dtype: str = "float32"
    stream_overrides: tuple = ()
    error_feedback: bool = False
    # simulated | sharded | async | gossip; "simulated" runs the rounds of
    # core/diloco.py and core/streaming.py, "sharded" the streaming round
    # on a process group of pods (core/pod_collectives.py), "async" the
    # barrier-free engine of core/async_diloco.py, "gossip" the pairwise
    # partial averaging of core/gossip.py
    transport: str = "simulated"
    staleness_lambda: float = 1.0
    gossip_pairing: str = "butterfly"
    gossip_mix: float = 0.5
    pack_wire: bool = True
    # --- outer-gradient anomaly guard ---
    guard_outer: bool = False
    guard_clip: float = 0.0
    # --- replica-state precision policy (optim/precision.py) ---
    param_dtype: str = "float32"
    master_dtype: str = "float32"


@dataclass(frozen=True)
class TrainConfig:
    inner_lr: float = 4e-4      # paper Table 5
    warmup_steps: int = 1_000
    total_steps: int = 88_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    batch_size: int = 512       # per-replica batch (paper)
    seq_len: int = 1_024
    pretrain_steps: int = 24_000
    seed: int = 0
    kernel_mode: str = "auto"   # inner AdamW backend (see DiLoCoConfig)
    param_dtype: str = "float32"
    master_dtype: str = "float32"
