"""Explicit collective patterns that DTensor's op-by-op sharding propagation
cannot find by itself.

``einsum``: a two-operand ``torch.einsum`` over DTensors, sharded as GSPMD
shards a dot: per mesh dim, the letter one operand is sharded on is sharded
in the other operand too (a local slice), the output keeps it when it is an
output letter and is ``Partial`` (a pending sum) when it was contracted; two
operands sharded on different letters of one mesh dim keep the larger
operand's and gather the smaller.  Then the local einsum runs on the local
shards.  DTensor alone would run ``torch.einsum``'s decomposition into
``view``/``bmm``, and a view that flattens a sharded dim under an unsharded
one (``hkd`` of an attention projection sharded on head_dim) has no
sharding.  The model's products call :func:`einsum`, which is
``torch.einsum`` itself for plain tensors.

``flash_decode``: one-token attention against a sequence-sharded KV cache.
Each rank owns an L/n slice of the cache (n = the "model" axis): the cache
update touches only the owning rank, attention reads are local, and the
online softmax combines with (B,H)-sized ``all_reduce``s of the max, the
sum and the (B,1,H,hd) accumulator over the "model" group, in place of a
gather of the cache.

``vocab_parallel_nll``: the next-token cross-entropy of logits sharded on
the vocabulary, as GSPMD lowers it: each rank's max, sum of exponentials
and label logit over its own columns, each reduced over the mesh dims that
shard the vocabulary ((B,S)-sized ``all_reduce``s), and a local backward.
DTensor's ``log_softmax`` replicates its softmax dim, so each rank would
hold (B,S,V) over the whole vocabulary.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.launch.mesh import axis_names, batch_axes

NEG_INF = -1e30


_DTENSOR = []     # the class, imported on first use


def is_dtensor(t) -> bool:
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor
        _DTENSOR.append(DTensor)
    return isinstance(t, _DTENSOR[0])


def _einsum_placements(eq: str, a, b):
    """Target placements of ``a`` and ``b`` and the output's (see the module
    docstring)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    lhs, out = eq.replace(" ", "").split("->")
    ia, ib = lhs.split(",")
    ta, tb, to = [], [], []
    for pa, pb in zip(a.placements, b.placements):
        la = ia[pa.dim] if isinstance(pa, Shard) else None
        lb = ib[pb.dim] if isinstance(pb, Shard) else None
        if la and lb and la != lb:
            if a.numel() >= b.numel():
                lb = None
            else:
                la = None
        letter = la or lb
        if letter is None:
            ta.append(Replicate())
            tb.append(Replicate())
            to.append(Replicate())
            continue
        ta.append(Shard(ia.index(letter)) if letter in ia else Replicate())
        tb.append(Shard(ib.index(letter)) if letter in ib else Replicate())
        to.append(Shard(out.index(letter)) if letter in out else Partial())
    return ta, tb, to


def _grad_pl(operand, out):
    """Placements of an operand's local gradient: where the operand is
    whole on a mesh dim that shards a letter it does not have (``out``
    sharded or pending there), each rank's gradient is its part of a
    sum."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    return [p if isinstance(p, Shard) else
            (Replicate() if isinstance(o, Replicate) else Partial())
            for p, o in zip(operand, out)]


def settle(t):
    """A DTensor's pending sums (``Partial`` placements) reduced to
    ``Replicate``; anything else as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Partial, Replicate
    if not any(isinstance(p, Partial) for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if isinstance(p, Partial) else p for p in t.placements])


def gather_dims(t, dims: Sequence[int]):
    """A DTensor with its shards of ``dims`` gathered (``Replicate`` on
    those mesh dims); anything else as it is.  Used before a reshape that
    would flatten a sharded dim under an unsharded one, which DTensor can
    only express as a strided shard that its ops then refuse."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    dims = {d % t.ndim for d in dims}
    pl = [Replicate() if isinstance(p, Shard) and p.dim in dims else p
          for p in t.placements]
    return t if pl == list(t.placements) else t.redistribute(t.device_mesh,
                                                             pl)


def pad(t, widths: Sequence[int], value: float = 0.0):
    """``F.pad(t, widths, value=value)``; a DTensor is padded rank by rank,
    each its own part, pending sums settled first.  A mesh dim that shards
    a padded dim moves its shard (an all-to-all) to the first dim that is
    not padded and that it divides, with the mesh dims already sharding
    that dim, else is gathered: the placement DTensor's ``constant_pad_nd``
    strategy picks in torch 2.13.  Torch 2.11's strategy returns a spec
    of one placement on a two-dim mesh, which the next op refuses."""
    import torch.nn.functional as F
    if not is_dtensor(t):
        return F.pad(t, widths, value=value)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    shape = list(t.shape)
    for i in range(len(widths) // 2):
        shape[t.ndim - 1 - i] += widths[2 * i] + widths[2 * i + 1]
    padded = {d for d in range(t.ndim) if shape[d] != t.shape[d]}
    mesh, pl = t.device_mesh, list(t.placements)

    def ways(d):       # the ranks that split dim d under pl
        return math.prod(mesh.size(m) for m, o in enumerate(pl)
                         if isinstance(o, Shard) and o.dim == d)

    for m, q in enumerate(pl):
        if isinstance(q, Shard) and q.dim in padded:
            pl[m] = Replicate()
            to = [d for d in range(t.ndim) if d not in padded
                  and t.shape[d] % (ways(d) * mesh.size(m)) == 0]
            pl[m] = Shard(to[0]) if to else Replicate()
    t = settle(t)
    if pl != list(t.placements):
        t = t.redistribute(mesh, pl)
    return DTensor.from_local(F.pad(t.to_local(), widths, value=value),
                              mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_strides(shape))


def embedding(tokens, table):
    """``table[tokens]``; with a DTensor table, each rank looks
    up the rows it holds (the others masked to zero) and a row-sharded mesh
    dim sums the ranks' parts, as GSPMD lowers a gather from a sharded
    table.  (DTensor's own ``MaskPartial`` lookup has no backward into a
    gradient that arrives as a plain pending sum.)  A mesh dim on which both
    the tokens and the table are sharded gathers the table first (FSDP)."""
    import torch.nn.functional as F
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    tokens = settle(tokens)
    tab_pl, out_pl = [], []
    for pt, pw in zip(tokens.placements, table.placements):
        if isinstance(pt, Shard) and isinstance(pw, Shard):
            pw = Replicate()
        tab_pl.append(pw)
        if isinstance(pw, Shard):
            out_pl.append(Partial() if pw.dim == 0 else Shard(tokens.ndim))
        else:
            out_pl.append(pt)
    table = table.redistribute(mesh, tab_pl)
    # a rank's table gradient covers its own tokens: a part of a sum where
    # the tokens are sharded
    local_tab = table.to_local(grad_placements=[
        Partial() if isinstance(pt, Shard) else pw
        for pt, pw in zip(tokens.placements, tab_pl)])
    from repro_torch.parallel.sharding import local_slices
    rows = local_slices(table.shape, mesh, tab_pl)[0]
    lo, hi = rows.start, rows.stop
    tok = tokens.to_local()
    mine = (tok >= lo) & (tok < hi)
    local = F.embedding(torch.where(mine, tok - lo, torch.zeros_like(tok)),
                        local_tab) * mine[..., None].to(local_tab.dtype)
    shape = torch.Size(tuple(tokens.shape) + (table.shape[1],))
    return settle(DTensor.from_local(local, mesh, out_pl, run_check=False,
                                     shape=shape,
                                     stride=contiguous_strides(shape)))


def einsum(eq: str, *ops):
    """``torch.einsum(eq, *ops)``; with a DTensor operand, sharded as the
    module docstring says (a plain operand beside it taken as replicated),
    returning a DTensor.  More than two operands contract left to right."""
    if not any(is_dtensor(t) for t in ops):
        return torch.einsum(eq, *ops)
    lhs, out = eq.replace(" ", "").split("->")
    ins = lhs.split(",")
    if len(ins) > 2:
        rest = "".join(ins[2:]) + out
        mid = "".join(dict.fromkeys(c for c in ins[0] + ins[1] if c in rest))
        first = einsum(f"{ins[0]},{ins[1]}->{mid}", ops[0], ops[1])
        return einsum(",".join([mid] + ins[2:]) + "->" + out, first, *ops[2:])
    from torch.distributed.tensor import DTensor, Replicate
    a, b = ops
    mesh = (a if is_dtensor(a) else b).device_mesh
    a, b = (t if is_dtensor(t) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False) for t in (a, b))
    a, b = settle(a), settle(b)   # a pending sum is settled first
    ta, tb, to = _einsum_placements(eq, a, b)
    local = torch.einsum(
        eq, a.redistribute(mesh, ta).to_local(grad_placements=_grad_pl(ta, to)),
        b.redistribute(mesh, tb).to_local(grad_placements=_grad_pl(tb, to))
    ).contiguous()
    sizes = dict(zip(ins[0], a.shape))
    sizes.update(zip(ins[1], b.shape))
    shape = torch.Size(sizes[c] for c in out)
    return DTensor.from_local(local, mesh, to, run_check=False, shape=shape,
                              stride=contiguous_strides(shape))


def contiguous_strides(shape: Sequence[int]) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    out, acc = [], 1
    for s in reversed(shape):
        out.append(acc)
        acc *= s
    return tuple(reversed(out))


def _bspec(mesh):
    bax = batch_axes(mesh)
    return bax if len(bax) > 1 else (bax[0] if bax else None)


def flash_decode(mesh, q, k_cache, v_cache, k_new, v_new, pos: int, *,
                 window: int = 0):
    """q: (B,1,H,hd); k_cache/v_cache: (B,L,KV,hd) DTensors placed as
    ``cache_specs`` places them under ``cache_seqshard`` (batch over the
    batch axes, L over "model"); k_new/v_new: (B,1,KV,hd); pos: the new
    token's absolute position.

    Writes the new key and value into slot ``pos`` (``pos % L`` for a SWA
    ring, ``window`` > 0) of the rank that owns it, in place, and returns
    out (B,1,H,hd) as a DTensor, batch-sharded and replicated over "model".
    RoPE/qk-norm must already be applied.  The masks are the single-device
    path's, on absolute positions.  A cache placed otherwise raises
    ``ValueError``, as the JAX package's ``shard_map`` in_specs refuse
    it: at batch 1 (long_500k) ``cache_specs`` puts L over ("data",
    "model") and the batch on no axis."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.parallel.sharding import P, to_placements
    names = axis_names(mesh)
    model_dim = names.index("model")
    n = mesh.size(model_dim)
    L = k_cache.shape[1]
    l_local = L // n
    bspec = _bspec(mesh)
    cache_pl = to_placements(P(bspec, "model", None, None), mesh)
    rep_pl = to_placements(P(bspec, None, None, None), mesh)
    for c in (k_cache, v_cache):
        if not isinstance(c, DTensor) or list(c.placements) != cache_pl:
            raise ValueError(f"flash_decode: the cache must be a DTensor "
                             f"placed {cache_pl}")

    def local(t):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, rep_pl).to_local()

    ql, kn, vn = local(q), local(k_new), local(v_new)
    kc, vc = k_cache.to_local(), v_cache.to_local()
    lo = mesh.get_local_rank(model_dim) * l_local
    slot = (pos % L if window > 0 else pos) - lo
    if 0 <= slot < l_local:                    # this rank owns the slot
        kc[:, slot] = kn[:, 0].to(kc.dtype)
        vc[:, slot] = vn[:, 0].to(vc.dtype)
    gidx = lo + torch.arange(l_local, device=kc.device)
    k_pos = pos - ((pos - gidx) % L) if window > 0 else gidx
    valid = (k_pos <= pos) & (k_pos >= 0)
    if window > 0:
        valid &= k_pos > pos - window
    h, kv = ql.shape[2], kc.shape[2]
    kx = kc if kv == h else kc.repeat_interleave(h // kv, dim=2)
    vx = vc if kv == h else vc.repeat_interleave(h // kv, dim=2)
    logits = torch.einsum("bqhk,bshk->bhqs", ql.float(), kx.float()) \
        * (ql.shape[-1] ** -0.5)
    logits = torch.where(valid[None, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    group = (mesh, model_dim)
    m = funcol.all_reduce(logits.amax(dim=-1), "max", group)      # (B,H,1)
    p = torch.exp(logits - m[..., None])
    p = torch.where(valid[None, None, None, :], p, torch.zeros_like(p))
    l_tot = funcol.all_reduce(p.sum(dim=-1), "sum", group)        # (B,H,1)
    acc = funcol.all_reduce(torch.einsum("bhqs,bshk->bqhk", p, vx.float()),
                            "sum", group)
    out = acc / torch.clamp(l_tot, min=1e-30).transpose(1, 2)[..., None]
    out = out.to(ql.dtype)
    return DTensor.from_local(out, mesh, rep_pl, run_check=False,
                              shape=q.shape,
                              stride=contiguous_strides(q.shape))


class _VocabParallelNLL(torch.autograd.Function):
    """-log softmax(logits)[label] on one rank's vocabulary columns
    ``[lo, lo + V_local)``; columns at or past ``vocab`` (the padding) take
    -1e30, as the plain path's bias gives them.  ``groups``: the
    ``(mesh, dim)`` groups whose ranks hold the other columns."""

    @staticmethod
    def forward(ctx, logits, labels, lo: int, vocab: int, groups):
        from torch.distributed import _functional_collectives as funcol
        vl = logits.shape[-1]
        mine = (labels >= lo) & (labels < lo + vl)
        idx = torch.where(mine, labels - lo, torch.zeros_like(labels))
        if lo + vl > vocab:        # the shard that holds the padding
            cols = lo + torch.arange(vl, device=logits.device)
            logits = logits.masked_fill(cols >= vocab, NEG_INF)
        m = logits.amax(dim=-1)
        picked = torch.where(mine, logits.gather(-1, idx[..., None])[..., 0],
                             torch.zeros((), device=logits.device))
        for g in groups:
            m = funcol.all_reduce(m, "max", g)
            picked = funcol.all_reduce(picked, "sum", g)
        e = (logits - m[..., None]).exp_()
        total = e.sum(dim=-1)
        for g in groups:
            total = funcol.all_reduce(total, "sum", g)
        ctx.save_for_backward(e, total, idx, mine)
        return torch.log(total) + m - picked

    @staticmethod
    def backward(ctx, g):
        # (softmax - onehot) * g on this rank's columns: no collective
        e, total, idx, mine = ctx.saved_tensors
        grad = e.mul_((g / total)[..., None])
        grad.scatter_add_(-1, idx[..., None],
                          torch.where(mine, -g, torch.zeros_like(g))[..., None])
        return grad, None, None, None, None


def vocab_parallel_nll(logits, labels, vocab: int):
    """Per-position -log softmax(logits)[labels] (B,S) of DTensor logits
    (B,S,V_pad) (f32), columns at or past ``vocab`` masked; ``labels``
    (B,S) are vocabulary ids (>= 0), a tensor or a DTensor.  Each rank
    works on its own columns (see the module docstring); the result is
    placed as the logits' batch and sequence dims, replicated over the mesh
    dims that shard the vocabulary."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.parallel.sharding import local_slices
    logits = settle(logits)
    mesh = logits.device_mesh
    vdim = logits.ndim - 1
    groups = [(mesh, i) for i, p in enumerate(logits.placements)
              if isinstance(p, Shard) and p.dim == vdim and mesh.size(i) > 1]
    out_pl = [p if isinstance(p, Shard) and p.dim != vdim else Replicate()
              for p in logits.placements]
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    lab = settle(labels).redistribute(mesh, out_pl).to_local()
    lo = local_slices(logits.shape, mesh, logits.placements)[vdim].start
    nll = _VocabParallelNLL.apply(
        logits.to_local(grad_placements=logits.placements), lab, lo,
        vocab, groups)
    shape = labels.shape
    return DTensor.from_local(nll, mesh, out_pl, run_check=False, shape=shape,
                              stride=contiguous_strides(shape))
