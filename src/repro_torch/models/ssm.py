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

On DTensors whose ``in_proj`` columns are sharded over a mesh dim ("model")
that the SSM heads divide, the full-sequence mixer keeps the heads sharded
from the projection to ``out_proj``, as GSPMD places them
(:func:`_project_parts`): z, x and dt sharded on their channels, B and C
whole, the conv per part, the scan and the gated norm on the rank's heads.
Elsewhere (plain tensors, or an ``in_proj`` whole over every mesh dim, as
hymba's 6482 columns over 16) it runs as one projection and one conv.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import rms_norm
from repro_torch.parallel.collectives import (einsum, gather_dims,
                                              is_dtensor, pad)


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, n, h = cfg.d_inner, cfg.ssm.d_state, cfg.ssm_heads
    return torch.split(zxbcdt, [di, di, n, n, h], dim=-1)


def _column_shards(w) -> list:
    """The mesh dims that shard the columns (last dim) of a DTensor ``w``;
    [] for a plain tensor."""
    if not is_dtensor(w):
        return []
    from torch.distributed.tensor import Shard
    return [m for m, q in enumerate(w.placements)
            if isinstance(q, Shard) and q.dim == w.ndim - 1]


def _project_parts(cfg: ModelConfig, xin, w):
    """z, x, B, C, dt of a DTensor ``in_proj`` ``w`` whose columns are
    sharded: each part projected with its own columns of ``w``, placed
    ``Shard`` on its channel dim over each mesh dim of ``w``'s columns that
    its heads (B and C: its N) divide.  The column blocks of one sharded
    product do not line up with the parts, and DTensor's split of it would
    gather the whole (B,S,E) projection.  Here only ``w`` is gathered, and
    each rank runs the columns it would have run: B and C are gathered
    after their product, (B,S,N) each."""
    from torch.distributed.tensor import Shard
    di, n, h = cfg.d_inner, cfg.ssm.d_state, cfg.ssm_heads
    mesh, cols = w.device_mesh, _column_shards(w)
    whole = gather_dims(w, (-1,))
    parts, lo = [], 0
    for width, units in ((di, h), (di, h), (n, n), (n, n), (h, h)):
        pl, ways = list(whole.placements), 1
        for m in cols:
            if units % (ways * mesh.size(m)) == 0:
                ways *= mesh.size(m)
                pl[m] = Shard(1)
        wp = whole[:, lo:lo + width].redistribute(mesh, pl)
        parts.append(einsum("bsd,de->bse", xin, wp))
        lo += width
    z, x, bmat, cmat, dt = parts
    return z, x, gather_dims(bmat, (2,)), gather_dims(cmat, (2,)), dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b=None) -> torch.Tensor:
    """Depthwise causal conv, then SiLU.  xbc: (B,S,C), w: (K,C), the bias
    b: (C,) or None.  The K shifted products are summed in the JAX
    package's order (not ``F.conv1d``)."""
    k, s = w.shape[0], xbc.shape[1]
    xp = pad(xbc, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + s, :] * w[i] for i in range(k))
    return F.silu(out if b is None else out + b)


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
    extra = (-s) % chunk
    if extra:
        x = pad(x, (0, 0, 0, 0, 0, extra))
        dt = pad(dt, (0, 0, 0, extra))
        bmat = pad(bmat, (0, 0, 0, extra))
        cmat = pad(cmat, (0, 0, 0, extra))
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
    extra = (-s) % chunk
    if extra:
        x = pad(x, (0, 0, 0, 0, 0, extra))
        dt = pad(dt, (0, 0, 0, extra))
        bmat = pad(bmat, (0, 0, 0, extra))
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
    version for CPU tensors), and the two projections through
    ``kernels.ops.dense``, which takes the 3xTF32 GEMM kernel where its rule
    holds (plain CUDA f32 operands of a large enough product) and the
    einsum otherwise (always on the CPU)."""
    s = cfg.ssm
    di, n = cfg.d_inner, s.d_state
    if _column_shards(p["in_proj"]):
        # heads sharded: a projection and a depthwise conv per part (the
        # conv of a concatenation is the concatenation of the convs)
        z, *pre, dt = _project_parts(cfg, xin, p["in_proj"])
        w, cb = p["conv_w"], p.get("conv_b")
        x, bmat, cmat = (_causal_conv(t, w[:, lo:hi],
                                      None if cb is None else cb[lo:hi])
                         for t, lo, hi in zip(pre, (0, di, di + n),
                                              (di, di + n, di + 2 * n)))
    else:
        zxbcdt = kops.dense(xin, p["in_proj"], "bsd,de->bse",
                            use_kernel=use_kernel)
        z, x, bmat, cmat, dt = _split_proj(cfg, zxbcdt)
        pre = [torch.cat([x, bmat, cmat], -1)]
        xbc = _causal_conv(pre[0], p["conv_w"], p.get("conv_b"))
        x, bmat, cmat = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    bsz, slen = xin.shape[0], xin.shape[1]
    x = x.reshape(bsz, slen, cfg.ssm_heads, s.head_dim).float()
    dt = softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    if use_kernel:
        y = kops.ssd_scan(x, dt, A, bmat.float(), cmat.float(), chunk=s.chunk)
    else:
        y = ssd_chunked(x, dt, A, bmat.float(), cmat.float(), s.chunk)
    y = gather_dims(y + x * p["D"][None, None, :, None], (3,))
    y = y.reshape(bsz, slen, di).to(xin.dtype)
    y = _gated_norm(y, z, p["norm"], cfg.norm_eps)
    out = kops.dense(y, p["out_proj"], "bse,ed->bsd", use_kernel=use_kernel)
    if not return_state:
        return out
    hfinal = ssd_final_state(x, dt, A, bmat.float(), s.chunk)
    tails = [gather_dims(t[:, -(s.d_conv - 1):], (2,)) for t in pre]
    tail = tails[0] if len(tails) == 1 else torch.cat(tails, -1)
    tail = pad(tail, (0, 0, s.d_conv - 1 - tail.shape[1], 0))
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
    conv_out = (window * p["conv_w"][None]).sum(dim=1)          # (B,C)
    if "conv_b" in p:
        conv_out = conv_out + p["conv_b"]
    conv_out = F.silu(conv_out)
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
