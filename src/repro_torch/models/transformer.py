"""Decoder assembly (PyTorch port).

Parameters keep the JAX package's pytree layout: nested dicts and lists of
tensors, every layer leaf with a leading ``repeats`` dim (the JAX stack is a
``lax.scan`` over it).  The forward indexes ``layers[i][name][r]`` in a
Python loop over repeats.  A parameter leaf may be wrapped by
``kernels.quant.quantize_params``; :func:`kernels.quant.leaf` then
dequantizes one layer's matrices just before that layer runs, so a quantized
member keeps only its narrow tree on the device.

Every layer kind of the JAX package is served: ``ATTN``, ``SWA``,
``CROSS`` (cross-attention to frontend embeddings ``(B, F, fdim)``, which
``forward``, ``hidden`` and ``prefill`` take as ``frontend``), ``SSM``
(Mamba2 mixer, no MLP when ``d_ff == 0``) and ``HYBRID`` (attention and the
SSM mixer in parallel, averaged), each followed by a dense SwiGLU MLP or a
MoE layer (``models.moe``), for the full-sequence forward and for generation
(``prefill`` then ``decode_step``).

Public API:
    param_shapes(cfg)                                    -> tree of shapes
    init_params(cfg, seed, device="cuda")                -> parameter tree
    forward(params, cfg, tokens, frontend, use_kernel=, remat=)
                                                         -> (logits, aux_loss)
    hidden(params, cfg, tokens, frontend, use_kernel=)   -> last hidden states
    logits_from_hidden(params, cfg, x)                   -> logits
    prefill(params, cfg, tokens, max_len, frontend, ...) -> (logits, cache)
    decode_step(params, cfg, cache, token, pos)          -> (logits, cache)
    Model(cfg, use_kernel)                 -> init / __call__ / forward_fn
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import runtime_flags
from repro_torch.configs.base import ATTN, CROSS, HYBRID, SSM, SWA, ModelConfig
from repro_torch.kernels.quant import (dequantize, dequantize_kv, leaf,
                                       quantize_kv)
from repro_torch.launch.mesh import axis_sizes, batch_axes
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.cache import init_cache
from repro_torch.models.layers import apply_rope, embed, rms_norm, swiglu, unembed
from repro_torch.models.moe import moe_ffn
from repro_torch.parallel.collectives import einsum, is_dtensor
from repro_torch.parallel.sharding import P, constrain


# --------------------------------------------------------------------------
# Parameter construction
# --------------------------------------------------------------------------
def _layer_param_shapes(cfg: ModelConfig, kind: str) -> Dict[str, Tuple[int, ...]]:
    d, hd, h, kv = cfg.d_model, cfg.hd, cfg.num_heads, cfg.num_kv_heads
    shapes: Dict[str, Tuple[int, ...]] = {"pre_norm": (d,)}
    if kind in (ATTN, SWA, CROSS, HYBRID):
        kv_src = cfg.fdim if kind == CROSS else d
        shapes.update(wq=(d, h, hd), wk=(kv_src, kv, hd), wv=(kv_src, kv, hd),
                      wo=(h, hd, d))
        if cfg.qk_norm:
            shapes.update(q_norm=(hd,), k_norm=(hd,))
    if kind in (SSM, HYBRID):
        s, di, nh = cfg.ssm, cfg.d_inner, cfg.ssm_heads
        shapes.update(in_proj=(d, 2 * di + 2 * s.d_state + nh),
                      conv_w=(s.d_conv, di + 2 * s.d_state),
                      dt_bias=(nh,), A_log=(nh,), D=(nh,),
                      norm=(di,), out_proj=(di, d))
        if s.conv_bias:
            shapes.update(conv_b=(di + 2 * s.d_state,))
    if cfg.moe is not None:
        m = cfg.moe
        shapes.update(mlp_norm=(d,), router=(d, m.num_experts),
                      w_gate=(m.held, d, m.d_ff_expert),
                      w_up=(m.held, d, m.d_ff_expert),
                      w_down=(m.held, m.d_ff_expert, d))
        if m.shared_expert:
            shapes.update(ws_gate=(d, m.d_ff_shared), ws_up=(d, m.d_ff_shared),
                          ws_down=(m.d_ff_shared, d))
    elif cfg.d_ff > 0:
        shapes.update(mlp_norm=(d,), w_gate=(d, cfg.d_ff), w_up=(d, cfg.d_ff),
                      w_down=(cfg.d_ff, d))
    return shapes


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """Full parameter tree of shapes."""
    vp, d = cfg.padded_vocab, cfg.d_model
    tree: Dict[str, Any] = {"embed": (vp, d), "final_norm": (d,)}
    if not cfg.tie_embeddings:
        tree["head"] = (d, vp)
    tree["layers"] = [
        {k: (cfg.repeats,) + v for k, v in _layer_param_shapes(cfg, kind).items()}
        for kind in cfg.pattern
    ]
    return tree


_INIT_SCALE = 0.02
_ZERO_INIT = ("pre_norm", "mlp_norm", "q_norm", "k_norm", "final_norm", "norm")


def init_params(cfg: ModelConfig, seed: int, device="cuda",
                dtype=torch.float32):
    """Materialize parameters from ``seed`` with a ``torch.Generator`` on
    ``device`` (normal·0.02 for matrices, zeros for norm gains).  Runs on the
    card unless the caller passes ``device="cpu"``; raises when asked for a
    CUDA device that is not there.  The values differ from the JAX
    package's for the same seed; tests bridge JAX's parameters instead
    (``models.bridge``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_params: no CUDA device is available "
                           "(pass device='cpu' to build on the host)")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def make(path: str, shape):
        name = path.split("/")[-1]
        if name in _ZERO_INIT:
            return torch.zeros(shape, dtype=dtype, device=device)
        if name == "dt_bias":
            # softplus(dt_bias) spans [1e-3, 1e-1] (mamba2 default)
            u = torch.rand(shape, generator=gen, device=device)
            dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
            return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
        if name == "A_log":
            u = torch.rand(shape, generator=gen, device=device)
            return torch.log(1.0 + 15.0 * u).to(dtype)
        if name == "D":
            return torch.ones(shape, dtype=dtype, device=device)
        return (torch.randn(shape, generator=gen, device=device)
                * _INIT_SCALE).to(dtype)

    def build(prefix, node):
        if isinstance(node, dict):
            return {k: build(f"{prefix}/{k}", v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(f"{prefix}/{i}", v) for i, v in enumerate(node)]
        return make(prefix, node)

    return build("", param_shapes(cfg))


# --------------------------------------------------------------------------
# Full-sequence forward (serving)
# --------------------------------------------------------------------------
def _embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    node = params["embed"]
    if isinstance(node, dict) and "q" in node:
        # quantized table: gather the rows' codes and scales, then
        # dequantize only those rows (elementwise the same values as
        # dequantizing the whole table first)
        idx = tokens.long()
        x = dequantize(node["q"][idx], node["s"][idx])
        if cfg.embed_scale:
            x = x * math.sqrt(node["q"].shape[1])
        return _embed_multiplier(cfg, x)
    return _embed_multiplier(cfg, embed(tokens, leaf(node), cfg.embed_scale))


def _embed_multiplier(cfg: ModelConfig, x):
    m = cfg.embedding_multiplier
    return x if m == 1.0 else x * m


def _residual(cfg: ModelConfig, x, out):
    """``x`` plus a sublayer's output ``out``, scaled by the residual
    multiplier where the config sets one."""
    m = cfg.residual_multiplier
    return x + out if m == 1.0 else x + out * m


def _frontend(cfg: ModelConfig, frontend):
    if frontend is None:
        raise ValueError(f"{cfg.name}: a cross-attention layer needs a "
                         f"frontend (B, {cfg.frontend_tokens}, {cfg.fdim})")
    return frontend


def _seq_constraint(x):
    """Variant "seq_par": keep full-sequence activations sequence-sharded
    over the "model" axis between layers (Megatron-SP): a DTensor ``x`` is
    redistributed to (batch axes, "model", None) when the variant's mesh is
    set and S divides the axis; otherwise ``x`` as it is."""
    mesh = runtime_flags.SHARDING_OPTS.get("seq_parallel")
    if mesh is None or x.ndim != 3 or \
            x.shape[1] % axis_sizes(mesh)["model"] != 0:
        return x
    bax = batch_axes(mesh)
    bax = bax if len(bax) > 1 else (bax[0] if bax else None)
    return constrain(x, P(bax, "model", None), mesh)


def _apply_layer(cfg: ModelConfig, kind: str, lp, x, positions, frontend,
                 use_kernel: bool):
    """One layer of the full forward -> (x, aux loss of its MoE or 0)."""
    x = _seq_constraint(x)
    h = rms_norm(x, lp["pre_norm"], cfg.norm_eps)
    if kind in (ATTN, SWA):
        window = 0 if kind == ATTN else cfg.sliding_window
        x = _residual(cfg, x, attn_mod.self_attention(
            cfg, lp, h, positions, window=window, use_kernel=use_kernel))
    elif kind == CROSS:
        x = _residual(cfg, x, attn_mod.cross_attention(
            cfg, lp, h, _frontend(cfg, frontend)))
    elif kind == SSM:
        x = _residual(cfg, x, ssm_mod.ssm_mixer(cfg, lp, h,
                                                use_kernel=use_kernel))
    elif kind == HYBRID:
        a = attn_mod.self_attention(cfg, lp, h, positions,
                                    window=cfg.sliding_window,
                                    use_kernel=use_kernel)
        m = ssm_mod.ssm_mixer(cfg, lp, h, use_kernel=use_kernel)
        x = _residual(cfg, x, 0.5 * (a + m))
    else:
        raise ValueError(kind)
    return _apply_mlp(cfg, lp, x, use_kernel)


def _apply_mlp(cfg: ModelConfig, lp, x, use_kernel: bool = False):
    """The layer's MLP or MoE after its mixer -> (x, aux loss or 0)."""
    if cfg.moe is not None:
        h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        out, aux = moe_ffn(cfg, lp, h, use_kernel=use_kernel)
        return _residual(cfg, x, out), aux
    if cfg.d_ff > 0:
        h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        x = _residual(cfg, x, swiglu(h, lp["w_gate"], lp["w_up"],
                                     lp["w_down"]))
    return x, 0.0


def _layer_params(params, i: int, r: int):
    """Layer ``i`` of the pattern unit, repeat ``r``, as f32-compute tensors
    (a wrapped leaf is dequantized here)."""
    return {name: leaf(node, r) for name, node in params["layers"][i].items()}


def _unit(params, cfg: ModelConfig, r: int, x, aux, positions, frontend,
          use_kernel: bool):
    """Repeat ``r`` of the pattern unit (``cfg.pattern``'s layers) -> (x,
    aux plus the unit's aux losses), the JAX package's scan body."""
    for i, kind in enumerate(cfg.pattern):
        x, a = _apply_layer(cfg, kind, _layer_params(params, i, r), x,
                            positions, frontend, use_kernel)
        aux = aux + a
    return x, aux


_MATMULS = ("aten.mm", "aten.addmm", "aten.bmm", "aten.baddbmm")


def _dots_policy(ctx, op, *args, **kwargs):
    """The ``"dots"`` remat policy (``jax.checkpoint_policies.
    dots_with_no_batch_dims_saveable``): save the output of every product
    with no batch dims, recompute the rest.  ``torch.einsum`` lowers a
    product to ``mm`` or to ``bmm``, and lowers one with no batch letter to
    a ``bmm`` whose batch is 1; so the rule is: ``mm``/``addmm`` (2-D
    operands), and ``bmm``/``baddbmm`` (3-D operands) whose leading dim is
    1, are saved; a ``bmm`` over a real batch (attention's scores and
    values, batch x heads) is recomputed, as is every other op."""
    from torch.utils.checkpoint import CheckpointPolicy
    name = str(op._overloadpacket) if hasattr(op, "_overloadpacket") else ""
    if name in _MATMULS:
        a = args[1] if name in ("aten.addmm", "aten.baddbmm") else args[0]
        if a.ndim == 2 or a.shape[0] == 1:
            return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpoint_kwargs():
    """Extra ``checkpoint`` arguments for the variant's remat policy:
    none for full remat, the selective ``"dots"`` context otherwise."""
    if runtime_flags.SHARDING_OPTS.get("remat_policy") != "dots":
        return {}
    import functools
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _dots_policy)}


def _layers(params, cfg: ModelConfig, tokens: torch.Tensor, frontend,
            use_kernel: bool, remat: bool = False):
    """(hidden states after the last layer, the summed aux loss).  With
    ``remat`` each unit is checkpointed, as the JAX package's
    ``jax.checkpoint(unit_body)`` does: only the units' inputs are saved for
    the backward, which runs each unit's forward again -- or, under the
    variant's ``remat_policy="dots"``, only the ops :func:`_dots_policy`
    does not save."""
    x = _embed(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    ckpt = _checkpoint_kwargs() if remat else {}
    for r in range(cfg.repeats):
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                _unit, params, cfg, r, x, aux, positions, frontend,
                use_kernel, use_reentrant=False, **ckpt)
        else:
            x, aux = _unit(params, cfg, r, x, aux, positions, frontend,
                           use_kernel)
    return x, aux


def hidden(params, cfg: ModelConfig, tokens: torch.Tensor,
           frontend: Optional[torch.Tensor] = None, *,
           use_kernel: bool = False) -> torch.Tensor:
    """tokens (B,S) int -> hidden states after the last layer (B,S,D),
    before the final norm.  ``frontend`` (B,F,fdim) feeds the
    cross-attention layers."""
    return _layers(params, cfg, tokens, frontend, use_kernel)[0]


def logits_from_hidden(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm and head: (..., D) -> (..., Vpad)."""
    x = rms_norm(x, leaf(params["final_norm"]), cfg.norm_eps)
    table = leaf(params["embed"] if cfg.tie_embeddings else params["head"])
    out = unembed(x, table, cfg.tie_embeddings)
    return out if cfg.logits_scaling == 1.0 else out / cfg.logits_scaling


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            frontend: Optional[torch.Tensor] = None, *,
            use_kernel: bool = False,
            remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B,S) int -> (logits (B,S,Vpad), aux_loss), the aux loss the
    sum of the MoE layers' load-balance losses (0 without MoE layers).
    ``remat`` recomputes each pattern unit in the backward (training)."""
    x, aux = _layers(params, cfg, tokens, frontend, use_kernel, remat)
    return logits_from_hidden(params, cfg, x), aux


# --------------------------------------------------------------------------
# Generation: prefill, then one token at a time against the cache
# --------------------------------------------------------------------------
def _ring_fill(dst: torch.Tensor, k: torch.Tensor) -> None:
    """Write the last min(S, L) timesteps of k (B,S,...) into their slots
    ``p % L`` of the L-slot ring ``dst`` (B,L,...).  A DTensor ring takes
    the two runs of consecutive slots as two slice copies: torch 2.11's
    DTensor has no sharding for the indexed copy."""
    s, L = k.shape[1], dst.shape[1]
    take = min(s, L)
    if is_dtensor(dst):
        first, n = (s - take) % L, min(take, L - (s - take) % L)
        dst[:, first:first + n] = k[:, s - take:s - take + n]
        if n < take:
            dst[:, :take - n] = k[:, s - take + n:]
        return
    slots = (torch.arange(take, device=k.device) + (s - take)) % L
    dst[:, slots] = k[:, s - take:]


def _add_mixers(cfg: ModelConfig, kind: str, x, a_out, m_out):
    """The residual plus the layer's mixer: attention, the SSM, or for a
    hybrid layer the mean of both."""
    if kind == HYBRID:
        return _residual(cfg, x, 0.5 * (a_out + m_out))
    return _residual(cfg, x, m_out if kind == SSM else a_out)


def _prefill_layer(cfg: ModelConfig, kind: str, lp, x, positions, frontend,
                   entry, use_kernel: bool):
    """Run one layer over the prompt and fill its cache ``entry`` (views
    of the cache tensors at this repeat) in place.  Attention always takes
    the plain dense or chunked path here, as in the JAX package."""
    h = rms_norm(x, lp["pre_norm"], cfg.norm_eps)
    a_out = m_out = None
    if kind in (ATTN, SWA, HYBRID):
        window = 0 if kind == ATTN else cfg.sliding_window
        q, k, v = attn_mod.project_qkv(cfg, lp, h)
        if cfg.rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        if x.shape[1] <= attn_mod._DENSE_MAX:
            out = attn_mod.dense_attention(q, k, v, positions, positions,
                                           causal=True, window=window,
                                           scale=cfg.attn_scale)
        else:
            out = attn_mod.chunked_attention(q, k, v, positions, positions,
                                             causal=True, window=window,
                                             scale=cfg.attn_scale)
        a_out = einsum("bshk,hkd->bsd", out, lp["wo"])
        for name, t in (("k", k), ("v", v)):
            if "k_scale" in entry:
                # the JAX package quantizes the whole zero-filled buffer,
                # so an empty slot's scale is the 1e-8 floor
                buf = torch.zeros(entry[name].shape, dtype=t.dtype,
                                  device=t.device)
            else:
                buf = entry[name]
            if kind == ATTN:
                buf[:, :t.shape[1]] = t
            else:
                _ring_fill(buf, t)
            if "k_scale" in entry:
                entry[name][...], entry[name + "_scale"][...] = quantize_kv(buf)
    if kind == CROSS:
        # the frontend's keys and values are the layer's whole cache
        q, k, v = attn_mod.project_qkv(cfg, lp, h,
                                       kv_src=_frontend(cfg, frontend))
        a_out = einsum("bshk,hkd->bsd", attn_mod.attend_all(q, k, v),
                       lp["wo"])
        if k.shape[1] != entry["k"].shape[1]:
            raise ValueError(f"prefill: a frontend of {k.shape[1]} tokens, "
                             f"the config's is {entry['k'].shape[1]}")
        for name, t in (("k", k), ("v", v)):
            if "k_scale" in entry:
                entry[name][...], entry[name + "_scale"][...] = quantize_kv(t)
            else:
                entry[name].copy_(t)
    if kind in (SSM, HYBRID):
        m_out, h_state, conv_tail = ssm_mod.ssm_mixer(
            cfg, lp, h, use_kernel=use_kernel, return_state=True)
        entry["h"].copy_(h_state)
        entry["conv"].copy_(conv_tail)
    return _apply_mlp(cfg, lp, _add_mixers(cfg, kind, x, a_out, m_out),
                      use_kernel)[0]


def _at(cache, i: int, r: int):
    """Views of layer ``i``'s cache tensors at repeat ``r``."""
    return {name: t[r] for name, t in cache["layers"][i].items()}


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, max_len: int,
            frontend: Optional[torch.Tensor] = None, *,
            use_kernel: bool = False, quantize_cache: bool = False,
            cache=None) -> Tuple[torch.Tensor, Any]:
    """Run the prompt tokens (B,S) and return (last-token logits (B,Vpad),
    cache) with room for ``max_len`` positions.  ``quantize_cache`` stores
    K/V as int8 with per-slot, per-head scales; decode then dequantizes on
    read.  ``use_kernel`` runs the SSM scans on the ``ssd_scan`` kernel, and
    their projections through ``kernels.ops.dense``.  A
    cross-attention layer caches the keys and values of ``frontend``
    (B,F,fdim), which decode reads at every step.  ``cache`` is a
    zero-filled tree of ``init_cache``'s layout to fill in place (a sharded
    step passes one placed as ``parallel.sharding.cache_specs`` says),
    default a new one on the tokens' device."""
    b, s = tokens.shape
    if s > max_len and ATTN in cfg.pattern:
        raise ValueError(f"prefill: a prompt of {s} tokens does not fit a "
                         f"{max_len}-slot cache")
    x = _embed(params, cfg, tokens)
    positions = torch.arange(s, device=tokens.device)
    if cache is None:
        cache = init_cache(cfg, b, max_len, x.dtype,
                           quantized=quantize_cache, device=tokens.device)
    for r in range(cfg.repeats):
        for i, kind in enumerate(cfg.pattern):
            x = _prefill_layer(cfg, kind, _layer_params(params, i, r), x,
                               positions, frontend, _at(cache, i, r),
                               use_kernel)
    return logits_from_hidden(params, cfg, x[:, -1]), cache


def _decode_layer(cfg: ModelConfig, kind: str, lp, entry, x, pos: int,
                  use_kernel: bool):
    h = rms_norm(x, lp["pre_norm"], cfg.norm_eps)
    a_out = m_out = None
    if kind in (ATTN, SWA, HYBRID):
        a_out = attn_mod.decode_attention(
            cfg, lp, h, entry["k"], entry["v"], pos,
            window=0 if kind == ATTN else cfg.sliding_window,
            use_kernel=use_kernel, k_scale=entry.get("k_scale"),
            v_scale=entry.get("v_scale"))
    if kind == CROSS:
        # q only; every frontend slot of the cache, dense, as in the JAX
        # package
        q = einsum("bsd,dhk->bshk", h, lp["wq"])
        if cfg.qk_norm:
            q = rms_norm(q, lp["q_norm"], cfg.norm_eps)
        kc, vc = entry["k"], entry["v"]
        if "k_scale" in entry:
            kc = dequantize_kv(kc, entry["k_scale"], h.dtype)
            vc = dequantize_kv(vc, entry["v_scale"], h.dtype)
        out = attn_mod.dense_attention(
            q, kc, vc, torch.arange(1, device=h.device),
            torch.arange(kc.shape[1], device=h.device), causal=False)
        a_out = einsum("bshk,hkd->bsd", out, lp["wo"])
    if kind in (SSM, HYBRID):
        m_out = ssm_mod.ssm_decode_step(cfg, lp, h, entry["h"], entry["conv"])
    return _apply_mlp(cfg, lp, _add_mixers(cfg, kind, x, a_out, m_out),
                      use_kernel)[0]


def decode_step(params, cfg: ModelConfig, cache, token: torch.Tensor, pos,
                *, use_kernel: bool = False) -> Tuple[torch.Tensor, Any]:
    """token: (B,1) int at absolute position ``pos`` -> (logits (B,Vpad),
    cache).  Unlike the JAX package, which returns a new cache, the port
    writes the new K/V slot and SSM states into ``cache`` **in place** and
    returns the same tree: a copy per step would cost more than the step.
    ``use_kernel`` runs attention on the decode-attention kernel (not for
    an int8 cache).  An ATTN layer has no slot past its end: ``pos >=
    max_len`` raises ``ValueError`` before any state changes."""
    pos = int(pos)
    for i, kind in enumerate(cfg.pattern):
        L = cache["layers"][i]["k"].shape[2] if kind == ATTN else None
        if pos < 0 or (L is not None and pos >= L):
            raise ValueError(f"decode_step: position {pos} is outside the "
                             f"{L}-slot cache")
    x = _embed(params, cfg, token)
    for r in range(cfg.repeats):
        for i, kind in enumerate(cfg.pattern):
            x = _decode_layer(cfg, kind, _layer_params(params, i, r),
                              _at(cache, i, r), x, pos, use_kernel)
    return logits_from_hidden(params, cfg, x[:, 0]), cache


# --------------------------------------------------------------------------
# Convenience object used by serving / examples
# --------------------------------------------------------------------------
class Model:
    """Thin functional wrapper binding a config to the apply functions."""

    def __init__(self, cfg: ModelConfig, use_kernel: bool = False):
        self.cfg = cfg
        self.use_kernel = use_kernel

    def init(self, seed: int, device="cuda", dtype=torch.float32):
        return init_params(self.cfg, seed, device, dtype)

    def __call__(self, params, tokens, frontend=None):
        return forward(params, self.cfg, tokens, frontend,
                       use_kernel=self.use_kernel)

    def forward_fn(self):
        return functools.partial(forward, cfg=self.cfg,
                                 use_kernel=self.use_kernel)
