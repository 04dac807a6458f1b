"""Composable model configuration covering all assigned architecture families.

One ``ModelConfig`` describes any of the six families (dense / moe / ssm /
hybrid / vlm / audio).  Per-layer heterogeneity (sliding-window patterns,
cross-attention layers, hybrid blocks) is expressed through a repeating
*pattern unit*: the layer stack is ``num_layers == repeats * len(pattern)``
copies of the unit, which lets the model assembly ``lax.scan`` over repeats
with the unit unrolled inside (compile size independent of depth).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

# Layer kinds appearing in pattern units.
ATTN = "attn"          # global self-attention
SWA = "swa"            # sliding-window self-attention
CROSS = "cross"        # cross-attention to frontend embeddings (VLM)
SSM = "ssm"            # Mamba2 SSD mixer
HYBRID = "hybrid"      # parallel attention + SSD heads (Hymba)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    shared_expert: bool = False       # llama4-style always-on shared expert
    d_ff_shared: int = 0
    router_aux_coef: float = 0.01     # load-balance loss coefficient
    capacity_factor: float = 1.25     # used by the "capacity" (GShard) impl
    impl: str = "capacity"            # "capacity" (TPU expert-parallel, may drop
                                      # tokens) | "dense" (dropless, exact; used by
                                      # reduced configs and correctness tests)
                                      # | "dropless" (port only: the held experts'
                                      # assignments grouped on the device)
    # Port only: this device's share of an expert-parallel layer, experts
    # ``first_expert .. first_expert + experts_held - 1`` of the router's
    # ``num_experts`` (0: every expert).  The router keeps its width and
    # top-k; the layer computes the held experts' part of the result.
    experts_held: int = 0
    first_expert: int = 0

    @property
    def held(self) -> int:
        """Experts whose weights this device holds."""
        return self.experts_held or self.num_experts


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2                   # d_inner = expand * d_model
    d_conv: int = 4
    chunk: int = 64                   # SSD chunk length
    conv_bias: bool = False           # port only: a bias in the causal conv
    # number of heads derived: expand * d_model // head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    pattern: Tuple[str, ...] = (ATTN,)
    sliding_window: int = 4096        # window for SWA layers
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # VLM / audio frontend stub: number of frontend tokens cross-attended to.
    frontend_tokens: int = 0
    frontend_dim: int = 0             # 0 -> d_model
    tie_embeddings: bool = False
    embed_scale: bool = False         # gemma-style sqrt(d_model) embed scaling
    vocab_pad_to: int = 256           # pad vocab so the sharded dim divides the mesh
    source: str = ""                  # citation for the config
    # Port only, named as granite-4.0-h's config.json names them; the
    # defaults are neutral and add no operation to the forward.
    position_embedding_type: str = "rope"   # "rope" | "nope" (no RoPE)
    attention_multiplier: float = 0.0       # softmax scale; 0 -> hd^-0.5
    embedding_multiplier: float = 1.0       # embedding rows times this
    residual_multiplier: float = 1.0        # each sublayer's output times this
    logits_scaling: float = 1.0             # logits divided by this
    # families with no MLP block (pure mamba2): d_ff == 0

    def __post_init__(self):
        if self.num_layers % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not a multiple of "
                f"pattern unit {len(self.pattern)}")

    # ---- derived quantities -------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def rope(self) -> bool:
        return self.position_embedding_type != "nope"

    @property
    def attn_scale(self) -> Optional[float]:
        """The attention softmax scale, None for the default hd^-0.5."""
        return self.attention_multiplier or None

    @property
    def repeats(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab_size + p - 1) // p) * p

    @property
    def ssm_heads(self) -> int:
        if self.ssm is None:
            return 0
        return (self.ssm.expand * self.d_model) // self.ssm.head_dim

    @property
    def d_inner(self) -> int:
        if self.ssm is None:
            return 0
        return self.ssm.expand * self.d_model

    @property
    def fdim(self) -> int:
        return self.frontend_dim or self.d_model

    def layer_kinds(self) -> Tuple[str, ...]:
        """Kind of every layer, unrolled."""
        return tuple(self.pattern[i % len(self.pattern)] for i in range(self.num_layers))

    @property
    def has_attention(self) -> bool:
        return any(k in (ATTN, SWA, CROSS, HYBRID) for k in self.pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True when no layer needs an unbounded full-attention KV cache."""
        return all(k in (SSM, SWA) or (k == HYBRID and self.sliding_window > 0)
                   for k in self.pattern)

    # ---- analytic size model (used by core.memory and the roofline) ---------
    def param_count(self) -> int:
        """Exact parameter count of the unpadded model (embedding included)."""
        total = self.vocab_size * self.d_model           # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model      # lm head
        for kind in self.layer_kinds():
            total += self._layer_params(kind)
        total += self.d_model                            # final norm
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k + shared experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        dense_like = dataclasses.replace(self, moe=None, d_ff=0)
        total = dense_like.param_count()
        per_expert = 3 * self.d_model * m.d_ff_expert
        total += self.num_layers * (
            m.top_k * per_expert
            + self.d_model * m.num_experts                 # router
            + (3 * self.d_model * m.d_ff_shared if m.shared_expert else 0))
        return total

    def _layer_params(self, kind: str) -> int:
        d, hd = self.d_model, self.hd
        n = 0
        if kind in (ATTN, SWA, CROSS, HYBRID):
            n += d * self.num_heads * hd                  # q
            kv_src = self.fdim if kind == CROSS else d
            n += 2 * kv_src * self.num_kv_heads * hd      # k, v
            n += self.num_heads * hd * d                  # o
            if self.qk_norm:
                n += 2 * hd
            n += d                                        # pre-norm
        if kind in (SSM, HYBRID):
            di, s = self.d_inner, self.ssm
            n += d * (2 * di + 2 * s.d_state + self.ssm_heads)   # in_proj (x,z,B,C,dt)
            n += s.d_conv * (di + 2 * s.d_state)                 # conv
            n += 3 * self.ssm_heads                              # A_log, D, dt_bias
            n += (di + 2 * s.d_state) if s.conv_bias else 0      # conv bias
            n += di                                              # gated norm
            n += di * d                                          # out_proj
            n += d if kind == SSM else 0                         # pre-norm (hybrid shares attn norm)
        # MLP / MoE after the mixer
        if kind != SSM or self.d_ff > 0:
            if self.moe is not None:
                m = self.moe
                n += self.d_model * m.num_experts                      # router
                n += m.held * 3 * self.d_model * m.d_ff_expert         # experts
                if m.shared_expert:
                    n += 3 * self.d_model * m.d_ff_shared
                n += self.d_model                                      # pre-norm
            elif self.d_ff > 0:
                n += 3 * self.d_model * self.d_ff                      # swiglu
                n += self.d_model                                      # pre-norm
        return n

    def kv_cache_bytes(self, batch: int, seq: int, dtype_bytes: int = 2) -> int:
        """KV + SSM state bytes for a decode cache of length ``seq``."""
        total = 0
        for kind in self.layer_kinds():
            if kind in (ATTN, CROSS):
                length = self.frontend_tokens if kind == CROSS else seq
                total += 2 * batch * length * self.num_kv_heads * self.hd * dtype_bytes
            elif kind == SWA:
                total += 2 * batch * min(seq, self.sliding_window) * \
                    self.num_kv_heads * self.hd * dtype_bytes
            elif kind == HYBRID:
                win = min(seq, self.sliding_window) if self.sliding_window else seq
                total += 2 * batch * win * self.num_kv_heads * self.hd * dtype_bytes
            if kind in (SSM, HYBRID):
                s = self.ssm
                total += batch * self.ssm_heads * s.head_dim * s.d_state * 4
                total += batch * (self.d_inner + 2 * s.d_state) * (s.d_conv - 1) * dtype_bytes
        return total

    def flops_per_token(self, seq: int = 1) -> float:
        """~2*N_active forward (x3 for train); attention/SSM mixer terms added."""
        n = self.active_param_count()
        mixer = 0
        win = min(seq, self.sliding_window) if self.sliding_window else seq
        for kind in self.layer_kinds():
            if kind == ATTN:
                mixer += 2 * 2 * seq * self.num_heads * self.hd
            elif kind == CROSS:
                mixer += 2 * 2 * self.frontend_tokens * self.num_heads * self.hd
            elif kind in (SWA, HYBRID):
                mixer += 2 * 2 * win * self.num_heads * self.hd
            if kind in (SSM, HYBRID) and self.ssm is not None:
                s = self.ssm
                # SSD dual form: intra-chunk (chunk-local attention over
                # d_inner) + B/C state contractions per token
                mixer += 2 * 2 * s.chunk * self.d_inner
                mixer += 2 * 2 * self.d_inner * s.d_state
        return 2 * n + mixer

    def reduced(self, layers: int = 0, d_model: int = 256, max_experts: int = 4,
                vocab: int = 512) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests / serving benches."""
        unit = len(self.pattern)
        layers = layers or (2 * unit if unit <= 3 else unit)
        layers = max(unit, (layers // unit) * unit)
        heads = max(2, min(4, self.num_heads))
        kv = 1 if self.num_kv_heads == 1 else 2
        hd = min(64, max(32, d_model // heads))
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, num_experts=min(max_experts, self.moe.num_experts),
                top_k=min(self.moe.top_k, 2), d_ff_expert=d_model,
                d_ff_shared=d_model if self.moe.shared_expert else 0,
                impl="dense", experts_held=0, first_expert=0)
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm, d_state=16, head_dim=32, chunk=16)
        return dataclasses.replace(
            self, name=self.name + "-reduced", num_layers=layers, d_model=d_model,
            num_heads=heads, num_kv_heads=kv, head_dim=hd,
            d_ff=0 if self.d_ff == 0 else d_model * 2,
            vocab_size=vocab, sliding_window=min(self.sliding_window, 64) or 64,
            moe=moe, ssm=ssm,
            frontend_tokens=16 if self.frontend_tokens else 0,
            frontend_dim=d_model if self.frontend_dim else 0,
            vocab_pad_to=8)
