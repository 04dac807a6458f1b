"""Mamba2 mixer: full-sequence forward, prefill state handoff and the
one-token decode step (PyTorch port).

Single B/C group, as in the JAX package (arXiv:2405.21060): in_proj ->
[z, x, B, C, dt], a short causal depthwise conv over [x, B, C], softplus dt,
a scalar A per head, the chunked dual form of the scan (intra-chunk
attention-like term plus the inter-chunk state recurrence), gated RMSNorm,
out_proj.

``ssd_chunked`` here is also the plain version of the ``ssd_scan`` kernel
(``kernels.ref.ssd_scan_ref`` calls it).  After a prefill,
``ssd_final_state`` is a second plain pass over the prompt for the state
handed to decode, even when the scan ran on the kernel, as in the JAX
package; ``ssm_decode_step`` advances that state one token in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.parallel.collectives import einsum, gather_dims, is_dtensor


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, n, h = cfg.d_inner, cfg.ssm.d_state, cfg.ssm_heads
    return torch.split(zxbcdt, [di, di, n, n, h], dim=-1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  xbc: (B,S,C), w: (K,C).  The K shifted
    products are summed in the JAX package's order (not ``F.conv1d``)."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + s, :] * w[i] for i in range(k))
    return F.silu(out)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) at every x.  ``F.softplus`` returns
    x itself above its threshold of 20."""
    return torch.logaddexp(x, torch.zeros_like(x))


def segsum_exp(dA_cs: torch.Tensor) -> torch.Tensor:
    """L[..., i, j] = exp(cs_i - cs_j) for i >= j else 0.  dA_cs: (..., cl).
    The exponent is taken only on the lower triangle (-inf elsewhere), so no
    overflow is ever formed."""
    cl = dA_cs.shape[-1]
    diff = dA_cs[..., :, None] - dA_cs[..., None, :]
    mask = torch.tril(torch.ones((cl, cl), dtype=torch.bool,
                                 device=dA_cs.device))
    return torch.exp(diff.masked_fill(~mask, float("-inf")))


def _zero_state(states, b, h, p, n, x):
    """The zero state (B,H,P,N) entering the first chunk, in ``x``'s dtype;
    for DTensor ``states`` (B,nc,H,P,N) placed as a chunk's states are, so
    that each rank holds its part (a zeros of the global shape would be
    whole on every rank)."""
    if is_dtensor(states):
        return torch.zeros_like(states[:, 0], dtype=x.dtype)
    return torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)


def ssd_chunked(x, dt, A, bmat, cmat, chunk: int) -> torch.Tensor:
    """The SSD dual-form scan.  x: (B,S,H,P) f32, dt: (B,S,H) post-softplus,
    A: (H,) negative, bmat/cmat: (B,S,N).  Returns y: (B,S,H,P).

    ``dt·x`` is formed before the contractions, so no (b, c, h, i, j, p)
    intermediate is built; the inter-chunk recurrence is a Python loop over
    chunks."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    nc = x.shape[1] // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    bc = bmat.reshape(b, nc, chunk, n)
    cc = cmat.reshape(b, nc, chunk, n)

    cs = torch.cumsum(dtc * A, dim=2)                   # (b,nc,cl,h)
    xdt = xc * dtc[..., None]                           # (b,nc,cl,h,p)
    # intra-chunk (attention-like) term
    L = segsum_exp(cs.transpose(2, 3))                  # (b,nc,h,cl,cl)
    scores = einsum("bcin,bcjn->bcij", cc, bc)          # (b,nc,cl,cl)
    gated = scores[:, :, None] * L                      # (b,nc,h,cl,cl)
    y_intra = einsum("bchij,bcjhp->bcihp", gated, xdt)
    # per-chunk final states
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)     # (b,nc,cl,h)
    states = einsum("bcjn,bcjhp->bchpn", bc,
                    xdt * decay_to_end[..., None])      # (b,nc,h,p,n)
    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(cs[:, :, -1, :])            # (b,nc,h)
    hstate = _zero_state(states, b, h, p, n, x)
    hprevs = []
    for c in range(nc):
        hprevs.append(hstate)
        hstate = hstate * chunk_decay[:, c, :, None, None] + states[:, c]
    hprevs = torch.stack(hprevs, dim=1)                 # (b,nc,h,p,n)
    y_inter = einsum("bcin,bchpn->bcihp", cc, hprevs) * \
        torch.exp(cs)[..., None]
    y = (y_intra + y_inter).reshape(b, nc * chunk, h, p)
    return y[:, :s]


def ssd_final_state(x, dt, A, bmat, chunk: int) -> torch.Tensor:
    """The SSM state after the whole sequence, (B,H,P,N): the per-chunk
    states of :func:`ssd_chunked` carried through the chunk recurrence."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
    nc = x.shape[1] // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    bc = bmat.reshape(b, nc, chunk, n)
    cs = torch.cumsum(dtc * A, dim=2)
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)
    states = einsum("bcjn,bcjhp->bchpn", bc,
                    xc * (dtc * decay_to_end)[..., None])
    chunk_decay = torch.exp(cs[:, :, -1, :])
    hstate = _zero_state(states, b, h, p, n, x)
    for c in range(nc):
        hstate = hstate * chunk_decay[:, c, :, None, None] + states[:, c]
    return hstate


def _gated_norm(y, z, w, eps):
    """RMS norm over all of d_inner of ``y·silu(z)``, with a (1 + w) gain."""
    return rms_norm(y * F.silu(z), w, eps)


def ssm_mixer(cfg: ModelConfig, p, xin: torch.Tensor, *,
              use_kernel: bool = False, return_state: bool = False):
    """Full-sequence Mamba2 mixer.  xin: (B,S,D) -> (B,S,D), and with
    ``return_state`` also the final SSM state (B,H,P,N) f32 and the conv
    state: the last d_conv-1 rows of the pre-conv [x, B, C], left-padded
    with zeros when S is shorter.  ``use_kernel`` runs the scan through
    ``kernels.ops.ssd_scan`` (the Hopper kernel for CUDA tensors, its plain
    version for CPU tensors)."""
    s = cfg.ssm
    zxbcdt = einsum("bsd,de->bse", xin, p["in_proj"])
    z, x, bmat, cmat, dt = _split_proj(cfg, zxbcdt)
    xbc_pre = torch.cat([x, bmat, cmat], -1)
    xbc = _causal_conv(xbc_pre, p["conv_w"])
    di, n = cfg.d_inner, s.d_state
    x, bmat, cmat = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    bsz, slen = xin.shape[0], xin.shape[1]
    x = x.reshape(bsz, slen, cfg.ssm_heads, s.head_dim).float()
    dt = softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    if use_kernel:
        from repro_torch.kernels import ops as kops
        y = kops.ssd_scan(x, dt, A, bmat.float(), cmat.float(), chunk=s.chunk)
    else:
        y = ssd_chunked(x, dt, A, bmat.float(), cmat.float(), s.chunk)
    y = gather_dims(y + x * p["D"][None, None, :, None], (3,))
    y = y.reshape(bsz, slen, di).to(xin.dtype)
    y = _gated_norm(y, z, p["norm"], cfg.norm_eps)
    out = einsum("bse,ed->bsd", y, p["out_proj"])
    if not return_state:
        return out
    hfinal = ssd_final_state(x, dt, A, bmat.float(), s.chunk)
    tail = xbc_pre[:, -(s.d_conv - 1):]
    tail = F.pad(tail, (0, 0, s.d_conv - 1 - tail.shape[1], 0))
    return out, hfinal, tail


def ssm_decode_step(cfg: ModelConfig, p, xin: torch.Tensor,
                    h_state: torch.Tensor, conv_state: torch.Tensor
                    ) -> torch.Tensor:
    """One-token SSM step: xin (B,1,D) -> out (B,1,D).  ``h_state``
    (B,H,P,N) f32 and ``conv_state`` (B, d_conv-1, C) are advanced by one
    token **in place**."""
    s = cfg.ssm
    zxbcdt = einsum("bsd,de->bse", xin, p["in_proj"])
    z, x, bmat, cmat, dt = _split_proj(cfg, zxbcdt)
    xbc_new = torch.cat([x, bmat, cmat], -1)                   # (B,1,C)
    window = torch.cat([conv_state, xbc_new], dim=1)           # (B,K,C)
    conv_out = F.silu((window * p["conv_w"][None]).sum(dim=1))  # (B,C)
    conv_state.copy_(window[:, 1:])
    di, n = cfg.d_inner, s.d_state
    xt = conv_out[:, :di].reshape(-1, cfg.ssm_heads, s.head_dim).float()
    bt = conv_out[:, di:di + n].float()                         # (B,N)
    ct = conv_out[:, di + n:].float()
    dtt = softplus(dt[:, 0].float() + p["dt_bias"])             # (B,H)
    A = -torch.exp(p["A_log"].float())
    decay = torch.exp(dtt * A)                                  # (B,H)
    h_state.mul_(decay[..., None, None]).add_(
        einsum("bh,bn,bhp->bhpn", dtt, bt, xt))
    y = einsum("bn,bhpn->bhp", ct, h_state)
    y = gather_dims(y + xt * p["D"][None, :, None], (2,))
    y = y.reshape(xin.shape[0], 1, di).to(xin.dtype)
    y = _gated_norm(y, z, p["norm"], cfg.norm_eps)
    return einsum("bse,ed->bsd", y, p["out_proj"])
