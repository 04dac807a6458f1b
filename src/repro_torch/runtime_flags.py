"""Process-wide sharding flags (the JAX package's ``runtime_flags``).

``SHARDING_OPTS`` holds the sharding-variant knobs that ``set_variant``
sets by name from ``VARIANTS``; ``parallel/sharding.py``, the MoE layer,
the transformer's seq-parallel constraint, its remat policy and
``attention.decode_attention`` read them.  Where the JAX package puts a
``jax.sharding.Mesh`` (``moe_constraints``, ``seq_parallel``,
``decode_cache_seq``), the port puts a ``DeviceMesh`` or the abstract
``launch.mesh.Mesh``.

The JAX package's ``UNROLL_SCANS`` / ``scan_unroll`` / ``set_unroll`` are not
ported: they exist because XLA's cost analysis counts a ``lax.scan`` body
once, and the port has no ``lax.scan`` -- its layer stack is a Python loop,
so a traced torch step already sees every layer.
"""

# Sharding-variant knobs (read at trace time by the modules named above):
#   moe_constraints: mesh | None -- expert-parallel placements inside the MoE
#       dispatch and combine.
#   attn_replicate_small_heads: replicate the attention projections when the
#       head count doesn't divide the model axis (instead of head_dim
#       sharding).
#   decode_cache_seq: mesh | False -- shard decode KV caches along the
#       sequence and decode through parallel.collectives.flash_decode.
SHARDING_OPTS = {
    "moe_constraints": None,
    "attn_replicate_small_heads": False,
    "decode_cache_seq": False,
    "seq_parallel": None,          # mesh -> shard activations' seq dim over
                                   # "model" between layers (Megatron-SP)
    "remat_policy": None,          # None = full remat; "dots" = save the
                                   # outputs of the products with no batch
                                   # dims (transformer._dots_policy)
    "fsdp_params": False,          # ZeRO-3: shard params + opt state over
                                   # "data" too (see sharding._add_fsdp)
    "kv_quant": False,             # int8 KV cache (decode shapes)
}

VARIANTS = {
    "baseline": {},
    "moe_ep": {"moe_constraints": "mesh"},          # mesh filled at set time
    "attn_repl": {"attn_replicate_small_heads": True},
    "cache_seqshard": {"decode_cache_seq": "mesh"},
    "seq_par": {"seq_parallel": "mesh"},
    "attn_repl+seq_par": {"attn_replicate_small_heads": True,
                          "seq_parallel": "mesh"},
    "attn_repl+moe_ep": {"attn_replicate_small_heads": True,
                         "moe_constraints": "mesh"},
    "attn_repl+remat_dots": {"attn_replicate_small_heads": True,
                             "remat_policy": "dots"},
    "fsdp": {"fsdp_params": True},
    "kv_int8": {"kv_quant": True},
    "kv_int8+combined": {"kv_quant": True,
                         "attn_replicate_small_heads": True},
    "attn_repl+fsdp": {"attn_replicate_small_heads": True,
                       "fsdp_params": True},
    "attn_repl+fsdp+remat_dots": {"attn_replicate_small_heads": True,
                                  "fsdp_params": True,
                                  "remat_policy": "dots"},
    "combined": {"moe_constraints": "mesh",
                 "attn_replicate_small_heads": True,
                 "decode_cache_seq": "mesh"},
}


def set_variant(name: str, mesh=None) -> None:
    """Set ``SHARDING_OPTS`` to variant ``name``; a knob whose value is
    ``"mesh"`` gets ``mesh``."""
    opts = dict(VARIANTS[name])
    for k in ("moe_constraints", "seq_parallel", "decode_cache_seq"):
        if opts.get(k) == "mesh":
            opts[k] = mesh
    base = {"moe_constraints": None, "attn_replicate_small_heads": False,
            "decode_cache_seq": False, "seq_parallel": None,
            "remat_policy": None, "fsdp_params": False, "kv_quant": False}
    base.update(opts)
    SHARDING_OPTS.clear()
    SHARDING_OPTS.update(base)
