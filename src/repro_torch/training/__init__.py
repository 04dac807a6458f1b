"""Training: AdamW on trees of tensors, the train step and loop, and
checkpoints in the JAX package's npz + manifest layout."""
