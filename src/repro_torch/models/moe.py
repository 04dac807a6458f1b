"""Mixture-of-Experts layer: top-k router and GShard-style capacity dispatch
(PyTorch port of the JAX package's ``models/moe.py``).

Two implementations, chosen by ``cfg.moe.impl`` as in the JAX package:

* ``"dense"``: dropless and exact, every expert computed for every token and
  combined by the top-k router weights (the reduced configs use it);
* ``"capacity"``: tokens in groups of ``GROUP``, each expert taking at most
  ``cap`` (token, k) assignments a group, ranked k-major (every token's first
  choice before any token's second), the rest dropped.

and a third of the port's own, ``"dropless"`` (:func:`moe_ffn_dropless`):
one device's share of an expert-parallel layer (``MoEConfig.experts_held``
from ``first_expert``).  The router runs over every expert; the
assignments to the held experts are grouped by expert on the device, run
through their SwiGLU on ``kernels.ops.grouped_dense`` and scattered back,
weighted, onto the shared expert's output.  Its shapes are static and the
host never waits on the device in it, so a forward runs ahead of the card
(and can be captured in a CUDA graph).

The JAX package dispatches and combines with one-hot einsums so that expert
sharding becomes an all-to-all; here the same functions are a scatter of
token rows into the ``(groups, E, cap, D)`` buffer and a gather back out.
Each capacity slot holds at most one (token, k) assignment, so the dispatch
is the same function and the combine the same sum in another order.
Plain tensors scatter only the kept assignments (a boolean index, so the
host waits for the count); DTensors, whose shapes may not follow the
data (the dry-run traces fake ones), scatter every assignment, the
dropped ones into a spare row, each rank its own groups (``local_map``,
as DTensor has no sharding for the indexed copy).  The expert products stay
einsums, as the JAX package computes them outside any kernel.  Under the
variant ``moe_ep`` (``runtime_flags``) the layer's tensors are constrained
as the JAX package's ``_c`` constrains them -- groups over the batch axes,
experts over "model" -- by redistributing DTensors (:func:`_c`); plain
tensors pass as they are.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch import runtime_flags
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import axis_sizes, batch_axes
from repro_torch.models.layers import swiglu
from repro_torch.parallel import collectives
from repro_torch.parallel.collectives import einsum, gather_dims, is_dtensor
from repro_torch.parallel.sharding import P, constrain, to_placements

GROUP = 512


def _router(x: torch.Tensor, w_router: torch.Tensor, top_k: int):
    """x: (T,D) -> (weights (T,k), idx (T,k), probs (T,E)).  Ties go to the
    lower expert index, as ``lax.top_k`` gives them: a stable descending
    sort, where ``torch.topk`` promises no order."""
    logits = einsum("td,de->te", x, w_router).float()
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = weights[:, :top_k], idx[:, :top_k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return weights.to(x.dtype), idx, probs


def load_balance_loss(probs: torch.Tensor, idx: torch.Tensor,
                      num_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * p_e."""
    f = F.one_hot(idx, num_experts).float().sum(-2).mean(0)
    p = probs.mean(0)
    return num_experts * torch.sum(f * p)


def _shared_expert(cfg: ModelConfig, p, x, out):
    if cfg.moe.shared_expert:
        sh = einsum("bsd,df->bsf", x, p["ws_gate"])
        su = einsum("bsd,df->bsf", x, p["ws_up"])
        out = out + einsum("bsf,fd->bsd", F.silu(sh) * su, p["ws_down"])
    return out


# ------------------------------------------------------------------ dropless
class MoETally:
    """Device counters of one forward function's dropless MoE layers: the
    layer calls, the assignments computed on this device, and the sum over
    calls of the largest held expert's rows.  The layers add into a device
    tensor (no host wait); :meth:`read` copies it home once."""

    NAMES = ("moe_calls", "moe_assignments", "moe_max_rows")
    _current = threading.local()

    def __init__(self):
        self.t = None

    @contextlib.contextmanager
    def active(self, device):
        """Context in which this thread's dropless layers add into this
        tally (made on ``device`` at first use)."""
        if self.t is None:
            self.t = torch.zeros(len(self.NAMES), dtype=torch.int64,
                                 device=device)
        MoETally._current.t = self.t
        try:
            yield
        finally:
            MoETally._current.t = None

    def read(self) -> Dict[str, float]:
        if self.t is None:
            return {}
        return dict(zip(self.NAMES, map(float, self.t.tolist())))


def _tally(counts: torch.Tensor) -> None:
    """Add one call with held-expert rows ``counts`` to the thread's tally."""
    t = getattr(MoETally._current, "t", None)
    if t is not None:
        t.add_(torch.stack((torch.ones_like(counts[0]), counts.sum(),
                            counts.max())))


def held_assignments(cfg: ModelConfig, idx: torch.Tensor,
                     weights: torch.Tensor):
    """The assignments of ``idx`` (T, k) to the held experts, grouped by
    expert in static shapes: (offsets (held+1,) int32, rows (A,) int32,
    scale (A,), counts (held,) int64).  Grouped row i, for i <
    offsets[held], is an assignment to held expert e where offsets[e] <= i <
    offsets[e+1], of token rows[i] at router weight scale[i], tokens in
    order within an expert; rows past offsets[held] are other experts'.
    A = T * min(k, held), the most a batch can route here."""
    m = cfg.moe
    t, k = idx.shape
    h = m.held
    local = idx - m.first_expert
    key = torch.where((local >= 0) & (local < h), local, h).reshape(-1)
    order = torch.argsort(key, stable=True)[:t * min(k, h)]
    counts = torch.zeros(h + 1, dtype=torch.int64, device=idx.device
                         ).scatter_add_(0, key, torch.ones_like(key))[:h]
    offsets = torch.cat((counts.new_zeros(1), torch.cumsum(counts, 0)))
    rows = torch.div(order, k, rounding_mode="floor")
    return (offsets.to(torch.int32), rows.to(torch.int32),
            weights.reshape(-1)[order], counts)


def moe_ffn_dropless(cfg: ModelConfig, p, x: torch.Tensor, *,
                     use_kernel: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This device's share of the layer: x (B,S,D) -> (the held experts'
    part of the routed sum plus the shared expert (B,S,D), 0).  Routing
    is over all ``num_experts``; each token's top-k by the stable sort,
    renormalized over the k.  Serving only: no load-balance loss."""
    from repro_torch.kernels import ops as kops
    with record_function("moe.dropless"):
        b, s, d = x.shape
        xt = x.reshape(-1, d)
        weights, idx, _ = _router(xt, p["router"], cfg.moe.top_k)
        offsets, rows, scale, counts = held_assignments(cfg, idx, weights)
        g = kops.grouped_dense(xt, p["w_gate"], offsets, rows=rows,
                               use_kernel=use_kernel)
        u = kops.grouped_dense(xt, p["w_up"], offsets, rows=rows,
                               use_kernel=use_kernel)
        out = swiglu(xt, p["ws_gate"], p["ws_up"], p["ws_down"]) \
            if cfg.moe.shared_expert else torch.zeros_like(xt)
        out = kops.grouped_dense(F.silu(g) * u, p["w_down"], offsets,
                                 out=out, scatter=rows, scale=scale,
                                 use_kernel=use_kernel)
        _tally(counts)
    return out.reshape(b, s, d), torch.zeros((), dtype=torch.float32,
                                             device=x.device)


def moe_ffn_dense(cfg: ModelConfig, p, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropless exact MoE: every expert for every token, combined by the
    top-k router weights.  O(E) compute."""
    m = cfg.moe
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    weights, idx, probs = _router(xt, p["router"], m.top_k)
    aux = load_balance_loss(probs, idx, m.num_experts) * m.router_aux_coef
    if is_dtensor(idx):
        # each token's router weight at each of its k (distinct) experts,
        # zero elsewhere (an elementwise one-hot: DTensor has no
        # scatter_add_)
        chosen = idx[..., None] == torch.arange(m.num_experts,
                                                device=x.device)
        wfull = torch.where(chosen, weights[..., None],
                            torch.zeros((), dtype=x.dtype, device=x.device)
                            ).sum(1)
    else:
        wfull = torch.zeros((xt.shape[0], m.num_experts), dtype=x.dtype,
                            device=x.device).scatter_add_(1, idx, weights)
    h = einsum("td,edf->tef", xt, p["w_gate"])
    u = einsum("td,edf->tef", xt, p["w_up"])
    eo = einsum("tef,efd->ted", F.silu(h) * u, p["w_down"])
    out = einsum("te,ted->td", wfull, eo).reshape(b, s, d)
    return _shared_expert(cfg, p, x, out), aux


def capacity_plan(cfg: ModelConfig, tokens: int) -> Tuple[int, int, int]:
    """(group size g, groups ng, capacity cap) of the capacity dispatch
    for ``tokens`` tokens: the last group padded to g with zero-weight
    tokens, ``cap = min(g, max(1, int(capacity_factor * top_k * g / E)))``."""
    m = cfg.moe
    g = min(GROUP, tokens)
    ng = -(-tokens // g)
    cap = max(1, int(m.capacity_factor * m.top_k * g / m.num_experts))
    return g, ng, min(cap, g)


def dispatch_slots(idx: torch.Tensor, num_experts: int, cap: int):
    """idx (ng, g, k) expert choices -> (pos (ng, g, k), keep (ng, g, k)):
    each (token, k)'s rank among the group's assignments to its expert,
    counted k-major so that a higher-priority k wins slots, and whether it
    falls within the capacity."""
    ng, g, k = idx.shape
    onehot = F.one_hot(idx, num_experts)                       # (ng,g,k,E)
    flat = onehot.transpose(1, 2).reshape(ng, k * g, num_experts)
    ranks = torch.cumsum(flat, dim=1) - flat                   # (ng,k*g,E)
    pos = (ranks * flat).sum(-1).reshape(ng, k, g).transpose(1, 2)
    return pos, pos < cap


def _dispatch_kept(xg: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
                   rows: int):
    """xg (ng,g,D) tokens, slot (ng,g,k) each assignment's row in its
    group's buffer, keep (ng,g,k) -> (ng, rows, D) buffers holding each
    kept assignment's token at its row, zeros elsewhere."""
    ng, g, d = xg.shape
    base = (torch.arange(ng, device=xg.device) * rows)[:, None, None]
    dest = (base + slot)[keep]
    src = torch.arange(ng * g, device=xg.device).reshape(ng, g, 1).expand(
        ng, g, slot.shape[-1])[keep]
    ex = torch.zeros((ng * rows, d), dtype=xg.dtype, device=xg.device)
    ex[dest] = xg.reshape(-1, d)[src]
    return ex.reshape(ng, rows, d)


def _dispatch(xg: torch.Tensor, dest: torch.Tensor, rows: int):
    """:func:`_dispatch_kept` in static shapes: dest (ng,g,k) each
    assignment's row, ``rows`` where it was dropped.  The dropped
    assignments all land in one spare row after the last group's, so the
    buffers are a contiguous view."""
    ng, g, d = xg.shape
    k = dest.shape[-1]
    base = (torch.arange(ng, device=xg.device) * rows)[:, None, None]
    flat = torch.where(dest < rows, base + dest, ng * rows)
    buf = torch.zeros((ng * rows + 1, d), dtype=xg.dtype, device=xg.device)
    buf[flat.reshape(-1)] = xg[:, :, None].expand(ng, g, k, d).reshape(-1, d)
    return buf[:ng * rows].view(ng, rows, d)


def _gather(eo: torch.Tensor, rows: torch.Tensor):
    """eo (ng,R,D) expert outputs, rows (ng,g,k) -> (ng,g,k,D) the rows."""
    ng, r, d = eo.shape
    base = (torch.arange(ng, device=eo.device) * r)[:, None, None]
    return eo.reshape(-1, d)[base + rows]


def _per_group(fn, out_ndim: int, data, index, *rest):
    """``fn(data, index, *rest)``, whose output has ``out_ndim`` dims; for
    DTensors, on each rank's groups (``local_map``: the group dim over the
    batch axes where it divides them, every other dim whole), since DTensor
    has no sharding for the indexed copy.  Plain tensors go straight to
    ``fn``."""
    if not is_dtensor(data):
        return fn(data, index, *rest)
    from torch.distributed.tensor.experimental import local_map
    mesh = data.device_mesh
    bax = batch_axes(mesh)
    size = 1
    for a in bax:
        size *= axis_sizes(mesh)[a]
    g = (bax if len(bax) > 1 else bax[0]) \
        if bax and data.shape[0] % size == 0 else None
    pl = lambda n: to_placements(P(g, *([None] * (n - 1))), mesh)
    return local_map(fn, out_placements=pl(out_ndim),
                     in_placements=(pl(data.ndim), pl(index.ndim))
                     + (None,) * len(rest),
                     device_mesh=mesh, redistribute_inputs=True)(
        data, index, *rest)


def _c(t, *spec):
    """Variant ``moe_ep``: ``t`` placed per ``spec`` on the variant's mesh,
    "B" standing for the batch axes and an axis dropped where the dim does
    not divide it (the JAX package's ``_c``); else ``t`` as it is."""
    mesh = runtime_flags.SHARDING_OPTS.get("moe_constraints")
    if mesh is None:
        return t
    sizes = axis_sizes(mesh)
    bax = batch_axes(mesh)
    bax = bax if len(bax) > 1 else (bax[0] if bax else None)
    full = []
    for dim, s in enumerate(spec):
        s = bax if s == "B" else s
        size = 1
        for a in ((s,) if isinstance(s, str) else (s or ())):
            size *= sizes[a]
        full.append(s if s and t.shape[dim] % size == 0 else None)
    return constrain(t, P(*full), mesh)


def moe_ffn(cfg: ModelConfig, p, x: torch.Tensor, *,
            use_kernel: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,D) -> (out (B,S,D), aux_loss scalar).  ``use_kernel``
    runs the dropless layer's expert products on the grouped GEMM kernel."""
    m = cfg.moe
    if m.impl == "dropless":
        return moe_ffn_dropless(cfg, p, x, use_kernel=use_kernel)
    if m.held != m.num_experts:
        raise ValueError(f"{cfg.name}: a share of {m.held} of "
                         f"{m.num_experts} experts needs impl='dropless'")
    if m.impl == "dense":
        return moe_ffn_dense(cfg, p, x)
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    weights, idx, probs = _router(xt, p["router"], m.top_k)
    aux = load_balance_loss(probs, idx, m.num_experts) * m.router_aux_coef

    g, ng, cap = capacity_plan(cfg, t)
    pad = ng * g - t
    if pad:           # padded tokens: expert 0 at zero combine weight
        xt = collectives.pad(xt, (0, 0, 0, pad))
        weights = collectives.pad(weights, (0, 0, 0, pad))
        idx = collectives.pad(idx, (0, 0, 0, pad))
    xg = _c(xt.reshape(ng, g, d), "B", None, None)
    wg = weights.reshape(ng, g, m.top_k)
    # a group's slots are ranked over all of its tokens: a DTensor whose
    # tokens are sharded inside a group is gathered first
    ig = gather_dims(idx.reshape(ng, g, m.top_k), (1, 2))
    pos, keep = dispatch_slots(ig, m.num_experts, cap)

    # dispatch: row (group n, expert e, slot c) of the buffer is the token
    # whose kept assignment landed there, zeros where none did
    rows = m.num_experts * cap
    slot = ig * cap + pos                                      # (ng,g,k)
    if is_dtensor(xg):
        ex = _per_group(_dispatch, 3, xg, torch.where(keep, slot, rows),
                        rows)
    else:
        ex = _dispatch_kept(xg, slot, keep, rows)
    ex = _c(ex.reshape(ng, m.num_experts, cap, d),        # tokens -> experts
            "B", "model", None, None)
    h = einsum("necd,edf->necf", ex, p["w_gate"])
    u = einsum("necd,edf->necf", ex, p["w_up"])
    eo = _c(einsum("necf,efd->necd", F.silu(h) * u, p["w_down"]),
            "B", "model", None, None)

    # combine: each token's kept assignments, weighted and summed over k
    got = _per_group(_gather, 4, eo.reshape(ng, rows, d),
                     torch.where(keep, slot, 0))               # (ng,g,k,d)
    w = torch.where(keep, wg, torch.zeros((), dtype=wg.dtype,
                                           device=wg.device))
    out = _c(einsum("ngk,ngkd->ngd", w, got), "B", None, None)
    out = out.reshape(-1, d)[:t].reshape(b, s, d)
    return _shared_expert(cfg, p, x, out), aux
